"""Checkpoints that survive a stop and a torn write.

Counterpart of ``mx_rcnn_tpu/ft/`` without its elastic controller,
training supervisor and fault plans: ``snapshot.py`` writes checkpoints
on a background thread (the step's thread pays the host copy),
``integrity.py`` finds the newest checkpoint that verifies against its
manifest and thins old epoch checkpoints, and ``supervisor.py`` holds
``RestartPolicy``, the relaunch pacing of the serving fleet.
"""

from mx_rcnn_tpu_torch.ft.integrity import (CheckpointRef,  # noqa: F401
                                            gc_checkpoints,
                                            latest_valid_checkpoint,
                                            retention_keep_set,
                                            scan_candidates,
                                            verify_checkpoint)
from mx_rcnn_tpu_torch.ft.snapshot import (AsyncSnapshotter,  # noqa: F401
                                           SnapshotError, SyncSnapshotter,
                                           fetch_owned, make_snapshotter)
