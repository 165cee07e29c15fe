"""Checkpoints that survive a stop and a torn write, and training that
survives preemption.

Counterpart of ``mx_rcnn_tpu/ft/``: ``snapshot.py`` writes checkpoints
on a background thread (the step's thread pays the host copy),
``integrity.py`` finds the newest checkpoint that verifies against its
manifest and thins old epoch checkpoints, ``faults.py`` injects kills and
disk faults into a training run, ``elastic.py`` turns topology
directives into resizes, and ``supervisor.py`` holds ``RestartPolicy``
(also the serving fleet's relaunch pacing), the crash loop, the snapshot
overhead measurement and the elastic storm.  The CLIs: ``tools/
crashloop.py [--elastic]`` and ``tools/train.py --fault_plan/--elastic``.
"""

from mx_rcnn_tpu_torch.ft.elastic import (ElasticController,  # noqa: F401
                                          Topology, read_topology, respec,
                                          run_elastic, write_topology)
from mx_rcnn_tpu_torch.ft.faults import (Fault, FaultInjector,  # noqa: F401
                                         parse_plan)
from mx_rcnn_tpu_torch.ft.integrity import (CheckpointRef,  # noqa: F401
                                            gc_checkpoints,
                                            latest_valid_checkpoint,
                                            retention_keep_set,
                                            scan_candidates,
                                            verify_checkpoint)
from mx_rcnn_tpu_torch.ft.snapshot import (AsyncSnapshotter,  # noqa: F401
                                           SnapshotError, SyncSnapshotter,
                                           fetch_owned, make_snapshotter)
from mx_rcnn_tpu_torch.ft.supervisor import (RestartPolicy,  # noqa: F401
                                             run_crashloop,
                                             run_elastic_storm)
