#!/usr/bin/env python3
"""Drive the PyTorch port's detection forward, training step, checkpoints,
evaluation, the alternate schedule, the serving engine, the
real-dataset input plane, the long training run, data parallelism, the
device-resident training epoch, quantized inference, the observability
plane, bulk scoring over an export-warmed engine, the serving fleet, the
cross-host serving tier, the rollout plane, fault-tolerant and elastic
training, the durability plane and the train-step store, the
accuracy gauntlet, and the network surface's linter and fuzzer on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device; it needs
one card and exits non-zero on any failure (there is no CPU mode).  It
imports the port, ``mx_rcnn_tpu_torch``, and nothing of JAX.  Phases:

1. device: the card's name and power limit (``nvidia-smi``), then one
   ``nvcc`` per kernel source, all started together;
2. K1, the NMS sweep (``csrc/nms_sweep.cu``), against its plain version on
   the card at thresholds 0.3, 0.5 and 0.7: at the serving proposal shape
   (B=2, K=6144), the postprocess shape (B=2*21, K=512), the training
   proposal shape (B=2, K=12032) on random boxes (most kept) and on dense
   clusters (almost all suppressed), at K = 1, 63, 65 and 130, with an
   all-dead image, and on integer boxes whose IoUs sit exactly on the
   threshold: keep masks must be equal.  Then K1's time at each main shape
   and on the clusters, with each pass's own time from a profiler trace;
3. K2, the ROIAlign forward (``csrc/roi_align_fwd.cu``), against its plain
   version in fp32 and bf16 over a 38x64x1024 map: at 2x300 rois (serving)
   and 2x128 rois (training), random and small (16-64 px), then on rois
   covering the whole map, rois wholly outside it, R = 1, C = 1021 and a
   features tensor whose base pointer is off 16 B (the last two on its
   one-channel-per-thread path).  Then K2's time at the four timed sets,
   with its own time from a profiler trace and the time of a plain write
   of its output's bytes;
4. K3, the ROIAlign backward (``csrc/roi_align_bwd.cu``), against its plain
   version in fp32 and bf16, two launches bit-equal in each: at the
   training shape (2x128 rois, 14x14, 38x64x1024) on random and small
   (16-64 px) rois, then on rois covering the whole map, rois wholly
   outside it, R = 1, C = 1021 and a g whose base pointer is off 16 B (the
   last two on its one-channel-per-thread path), and at sr 1 and 4.  Then
   K3's time on the random and small rois, with its device time and its
   tables pass's from a profiler trace;
5. the whole ResNet-101 forward at 608x1024 in fp32 (TF32 off), once
   through the kernels and once through the plain versions: rois and
   ``roi_valid`` equal, ``cls_prob`` and deltas close;
6. the ResNet-101 train step at 608x1024, batch 2, in fp32 (TF32 off),
   from one set of weights and draws, once through the kernels and once
   through the plain versions: sampled rois and labels equal, losses and
   gradients close;
7. serving: ``tools/demo.py``'s path in bf16 on 4 seeded synthetic images
   at batch 1 and 2 -- the first main path -- then images/s, per-stage
   times, the device busy share and K1's and K2's time per forward
   (profiler);
8. training: ``tools/train.py``'s path in bf16 on 8 seeded synthetic
   375x500 images and their flipped copies at batch 1 and 2 -- the second
   main path -- then ms/step, images/s, per-stage CUDA-event times, the
   device busy share, K1's two passes, K2 and K3 on the step's own inputs
   (profiler) and peak memory of the step at each batch size;
9. checkpoints and eval, the third main path: a ResNet-101 train state
   (random bf16 trace, count 3) through ``save_checkpoint``, then
   ``load_param`` and ``restore_state`` into another, every tensor
   bit-equal (file size, write and read times); ``pred_eval`` in fp32
   (TF32 off) from that checkpoint over 8 synthetic 375x500 images at
   batch 2, through K1/K2 and through their plain versions: equal counts
   per (class, image), boxes and scores close, equal APs; then in bf16
   through the command lines, ``tools/train.py --prefix .. --end_epoch 1``
   (4 images and their flips, 4 steps) and ``tools/test.py --prefix ..
   --epoch 1 --synthetic 16`` (K1 2 and K2 1 launches per eval batch, K3
   none), the eval's images/s, device time per image and K1's and K2's
   time per eval batch (profiler); last, ``--resume`` for a second epoch,
   whose checkpoint must equal, byte for byte, that of two epochs without
   a break;
10. VGG16 and the alternate schedule, the fourth main path: K1 at the
   proposal dumps' 20000 boxes, K2 at 2x128 and 2x300 rois and K3 at
   2x128 on a 38x64x512 map with 7x7 bins against their plain versions
   (fp32 and bf16, K3 bit-equal twice) and timed; in fp32, the VGG16 forward, the ``rpn`` and ``rcnn`` steps and
   ``test_rcnn_stage`` through the kernels and the plain versions; then
   ``tools/train_alternate.py`` in bf16 on 8 synthetic 375x500 images and
   their flips at batch 2, one epoch a stage (train_rpn → proposals →
   train_rcnn → train_rpn, shared convs frozen → proposals → train_rcnn,
   shared convs frozen → combine), each stage's ms/step, device time per
   step, busy share, peak memory and K1/K2/K3 launches, the five
   checkpoints' sizes and write times (the four stage checkpoints
   through the background writer: the step thread's copy, the writer's
   time to the commit and the wait at the stage's end), the shared
   convs bit-identical
   across stages 3 and 4; ``tools/test.py`` on the combined model and
   ``tools/test_rcnn.py`` on rcnn2 with rpn2's proposals (launches, then
   images/s and device time per image); last, 6 end-to-end VGG16 steps
   through ``tools/train.py --network vgg``;
11. the serving engine, the fifth main path, ResNet-101 in bf16 at the
   ``ServeConfig`` defaults (batch 4, both buckets): K1 at the engine's
   shapes (proposals B=4, K=6144; postprocess B=84, K=512) and K2 at 4x300
   rois against their plain versions on both buckets' canvases (K2 on the
   38x64 and the 64x38 map) and timed; the host's CPU model, cores and
   load at the phase's start and end; a seeded checkpoint
   served cold by ``tools/serve.py`` in a process of its own (time to the
   first ``/healthz`` 200, 8 concurrent ``/detect`` of 375x500 and 500x375
   images, ``/metrics``, exit 0 on SIGINT); ``engine.detect`` bit-equal
   to the offline path on the same batch in bf16 and fp32;
   ``tools/loadgen.py`` in-process, a closed loop at concurrency 8 for 8
   s, then open loops for 6 s at 0.5x its served rate and at 1.5x the
   higher of that rate and the offline rate (nothing lost or failed; the
   1.5x loop sheds or expires); one engine batch's
   device time, K1 and K2 (profiler), the busy share of a 2 s closed loop
   and its launches, K1 2, K2 1 and K3 0 per batch;
12. the real-dataset input plane, the sixth main path: a VOCdevkit (16
   trainval and 16 test JPEGs, 375x500 and 500x375, XML with
   ``difficult`` flags) and a COCO tree (16 train2017 and 16 val2017
   480x640 JPEGs, 80 categories, crowds) generated in the real layouts;
   ``tools/train.py --dataset PascalVOC --root_path .. --dataset_path ..``
   in bf16 at batch 2 with 2 decode workers, the cache, streaming and
   staging (16 steps: ms/step, images/s, the data-wait share, images
   decoded, peak memory, K1/K2/K3 1/1/1 per step); ``tools/test.py``
   through ``PascalVOC`` (images/s, APs, the 20 comp4 files) and, from a
   seeded 81-class checkpoint, through ``COCODataset`` (its numbers, K1
   at B=162, K=512 checked and timed); staged batches bit-equal to
   unstaged ones; the fp32 eval of the devkit equal through K1/K2 and
   their plain versions; K2 and K3 at the training shape on the 64x38
   map of the 1024x608 bucket, which the devkit's portrait images train
   on, against their plain versions and timed; ``--resume`` for a second
   epoch byte-equal to two straight epochs on the streaming plan
   (cuDNN's deterministic algorithms up to here); last, steady training
   with cuDNN's default algorithms, a three-epoch run over the devkit
   then one over 16 synthetic images of the devkit's two orientations,
   each run's second epoch timed and its third traced (device time,
   copies, busy share);
13. the long training run, the seventh main path: a seeded ResNet-101
   ``.params`` file with the MXNet zoo's full name set grafted by
   ``tools/train.py --pretrained`` (4 steps at batch 2 in bf16 on 8
   synthetic images and their flips; every backbone and head tensor on
   the card held against the file's array before the first step; K1/K2/K3
   1/1/1 per step), a seeded torchvision VGG16 ``.pth`` through
   ``tools/train_rpn.py --pretrained`` (2 steps), a file missing one
   backbone array refused; one ResNet-101 state saved with background
   and inline snapshots in turns (the step thread's time, the time to
   the commit, the files byte-equal, also when the weights change as soon
   as ``save_epoch`` returns) and phase 10's schedule read for its
   checkpoint time; ``tools/train.py`` over a generated VOCdevkit in
   processes of their own (deterministic cuDNN; they run beside the
   ImageNet start and the accumulation parity): two
   epochs straight beside a run stopped by SIGTERM in epoch 1 (exit 0,
   an interrupt checkpoint with its data cursor), ``--resume auto`` to
   the end byte-equal to the straight run, beside it a copy of the
   straight run's files past its corrupted newest epoch file, and a
   resume at batch 1 refused; in fp32, one ``grad_accum=2`` step at batch 1
   through the kernels and the plain versions (sampled rois and labels
   equal, metrics and gradients close) and ``remat_backbone`` on and off
   (gradients bit-equal); in bf16, ms per optimizer step, peak memory and
   launches per step of batch 2, batch 1 x accum 2 and batch 2 with
   remat;
14. data parallelism, the eighth main path (``parallel/``; one process
   per card, its row shard of the global plan, one gradient all-reduce
   per optimizer step), on a generated COCO tree (12 train2017 and 15
   val2017 480x640 JPEGs) under ``_chip/dp``, with deterministic cuDNN:
   in fp32, a two-rank world over gloo on cuda:0 twice (a test rig: NCCL
   refuses two ranks on one card; it says so on each line) against the
   world of one on the same 2 images and draws, through the kernels and
   the plain versions (sampled rois and labels equal, averaged gradients
   and metrics within a relative 1e-4, the ranks' states bit-equal after
   3 steps); ``tools/train.py --num_devices 1`` (NCCL at world size 1)
   streamed and with ``--device_cache`` (its shard staged on the card),
   both in one process of their own, restored, byte-equal to
   ``train_net`` here on the same config without the world (ms per step
   through ``fit`` for all three, the ranks' launches); ResNet-101 with 81 classes, 2 images a rank, bf16, on the
   two-rank rig at grad_accum 1 then 2 in one world, the step alone
   without ``fit`` (ms per optimizer step, the all-reduce's own ms and
   bytes, peak memory and launches, K1 = K2 = K3 = grad_accum per step
   on each rank); the rig through ``tools/train.py``'s rank
   launcher and ``fit`` for two epochs (ms per optimizer step with the
   collective stop and rank 0's snapshots inside, each rank's launches);
   that run's checkpoint resumed in a world of one at 2 images x
   grad_accum 2 and refused at grad_accum 1; SIGTERM to the rig's
   launcher mid-epoch (exit 0, both ranks at the same step, one
   interrupt checkpoint with ``topology.devices = 2``) and ``--resume
   auto`` byte-equal to the unbroken run; ``tools/test.py``'s eval split
   over cuda:0 twice equal to one device's (the pad row's slice
   included); where the machine has several cards, the rig over NCCL on
   2 and up to 4 of them, ``tools/train.py --num_devices`` on up to 4
   through ``fit`` (ms per step, launches per rank) and ``tools/test.py
   --num_devices`` equal to one card's eval (else one line says why
   not); ``tools/multihost_demo.py``'s launcher (in a process of its
   own, its workers in theirs) on the cards (NCCL; a world of one on one
   card) and its refusal of more workers than cards (here);
   ``dryrun_multichip(2)`` on the rig, in a process of its own.  The legs
   in processes of their own (the NCCL worlds of one, the unbroken run,
   the SIGTERM run and its resume, the demo, the dry run) start with the
   phase and run beside the parity and the two-rank rig, so the times of
   all of these are taken beside other processes on the card;
15. the device-resident epoch, the ninth main path (``tools/train.py
   --device_cache`` → ``core/fit.py`` → ``data/device_cache.py``), on a
   generated COCO tree (12 train2017 480x640 JPEGs and their flips: 24
   records, one 608x1024 bucket) under ``_chip/cache``, ResNet-101, 81
   classes, batch 2, bf16 with fp32 masters, deterministic cuDNN: (a)
   the epoch staged on the card (its bytes, the memory it takes) and two
   epochs of the shuffled gather, each taking every staged image once and
   regrouping them; (b) one epoch at ``shuffle=False`` from the cache
   byte-equal to the streamed epoch, K1/K2/K3 once a step; (d) three-epoch
   runs at ``shuffle=True``, cached then streamed: the second epoch timed
   (ms/step, images/s, the data-wait share), the third's steps 5-8
   traced (device time and busy share, host-to-device copies and bytes a
   step: a cached step copies none of a batch), K1/K2/K3 once a step;
   (c) two epochs of the shuffled gather here, then ``tools/train.py
   --device_cache`` for two epochs in a process of its own, stopped by
   SIGTERM in the middle of the second, and its ``--resume auto``
   through ``main`` here, restored, byte-equal to the run here (two
   cached runs byte-equal); (e) the phase 14 rig (two ranks over gloo on
   cuda:0, beside (c)) cached against streamed at ``shuffle=False``
   (byte-equal), each rank's shuffled epochs its own shard once (the
   cached NCCL world of one is phase 14's); (f) ``tools/train.py --dataset synthetic_hard
   --device_cache --dataset_kw "{'num_images': 16}"`` (its ``main``
   here), 4 steps, exit 0;
   (g) ``tools/data_bench.py --smoke --check`` on the card, exit 0;
16. quantized inference, the tenth main path (``tools/test.py --set
   quant__enabled=true`` → ``core/tester.py — quant_predictor``: the
   calibration sweep, then the quantized ResNet-101): K4, the activation
   quantizer (``csrc/quantize.cu``), bytes equal to its plain version in
   int8 at weight_bits 8 and 4 and in fp8, on bf16 and fp32 input with
   exact .5 ties and values past +-qmax; then with the frozen BN and
   ReLU before it at each of the 16 distinct shapes the forward gives it
   (conv0's fp32 3-channel image, each unit's three BNs, two outputs for
   a projection unit's bn1), int8 and fp8, bytes equal to the torch ops
   of ``FrozenBatchNorm``, ``F.relu`` and the plain quantizer (ties,
   -0.0, NaN, values past +-qmax), each timed (also in a CUDA graph)
   beside its bound, and their sum over a batch's 100 launches; K5, the
   int8 convolution
   (``csrc/qconv.cu``), bit-equal to its plain version (a float64
   contraction, exact) in bf16 and fp32 output, and K6, the e4m3 one,
   within its bound, at conv0 7x7/2 (C_in 3) on 608x1024, a stage-1 1x1
   and 3x3, a stage-3 3x3/2 (pads (0, 1)), stage 3's two 1x1 shapes and
   its 1x1/2 projection, the per-ROI stage-4 1x1 and 3x3/2 on
   600x14x14 and VGG16's fc6 as a dense layer, each timed (also in a
   CUDA graph, without host time) beside its bound and, for the 1x1 and
   dense cases, ``torch._int_mm`` or ``torch._scaled_mm``; the built
   K5 / K6 libraries' wgmma (GMMA) instructions counted in the SASS and
   no ptxas serialization of them; sim against native int8 bit-equal with
   cuDNN's TF32 on; the percentile on 19.9 M elements against numpy's;
   then ``tools/test.py`` on 16 synthetic images at batch 2 from a
   seeded ResNet-101 (every conv3 drawn non-zero) in bf16, int8 native,
   fp8 native and int8 sim: exit 0, mAP and the fingerprint printed, and
   every launch count (K1, K2, K4 100 and K5 or K6 104 a batch, K3 not);
   each arm's steady images/s, device time, K4, K5/K6 and the rest a
   batch and device ops a forward, in turns; the int8 serving engine
   (``tools/serve.py``'s ``ServingEngine``) on one image per bucket,
   equal to the quantized offline batch with the same launches; last
   ``tools/quant_smoke.py --check`` on the card (its ``main``; with the
   int8 store's round trip, an 8-image burst after the join with no
   build, and the store's refusals of an fp config and of another
   estimator);
17. the observability plane, the eleventh main path (``obs/``, the lock
    sanitizer; ResNet-101, 21 classes, the 608x1024 bucket, bf16,
    seeded weights): ``python -m mx_rcnn_tpu_torch.tools.train`` on 8
    synthetic images and their flips with every obs piece on, the
    profiler window over global steps 4-5 and
    ``MXRCNN_THREAD_SANITIZER=strict``: a mid-run ``/metrics`` scrape
    with ``train.*``, ``loader.*``, ``snapshot.*``; ``events.jsonl``
    parsed; ``summary.json`` with ``train_samples_per_sec`` and no obs
    failure; the rollup's K1 passes, K2 and K3 with device ms and one
    launch each a profiled step (as ``launch_counts`` says); each of
    their device events inside its step's ``train.dispatch`` to
    ``train.sync`` window of the merged chrome trace; a SIGTERM after
    step 12 leaves the flight dump and the step-exact interrupt
    checkpoint; ``LOCKSAN_REPORT`` clean.  Then ``tools/serve.py``'s
    session in process over a seeded checkpoint: a concurrency-8 HTTP
    burst, half of it with ``X-MXR-Trace`` headers, an OK verdict on
    ``/healthz``, ``registry`` and ``timeseries`` on ``/metrics``, one
    ``terminal.*`` span per traced request, K1 2 and K2 1 a batch; each
    image served alone with the plane on and off, bit-equal with equal
    launches.  Last, obs-on against obs-off: training ms/step, and
    served images/s in turns (recorded, not gated);
18. bulk scoring over an export-warmed engine, the twelfth main path
    (``serve/export.py`` → ``ServingEngine.warm_from_export`` →
    ``StreamTestLoader`` → ``BulkRunner`` → ``BulkSink``; ResNet-101, 81
    classes, bf16, engine batch 4) on a COCO tree of 20 val2017 images,
    480x640 and 640x480 in turns, under ``_chip/bulk``: the store with
    its weights and the K1/K2 libraries (each program's bits twice);
    its refusals of another ``serve.score_thresh`` and of an int8
    engine; two processes beside each other, each over a copy of the
    package whose ``_build/`` is empty, each joining with 0 builds: one
    SIGKILLed right after shard 2 commits, one running the control
    (every image once, K1 2 and K2 1 launches per engine batch), then,
    once the first has exited, the killed sink's resume (shards
    byte-equal to the control's), a closed loop of 8 clients (bulk
    images/s beside it) and a rate pass over the corpus 16 times over
    (320 images, 16 plan batches a shard); meanwhile ``tools/demo.py
    --prefix --epoch --image --out`` on the card here (a PNG of the
    image's size); each control line byte-equal to the offline batch
    here;
19. the serving fleet, the thirteenth main path (``serve/fleet.py``:
    ``RestartPolicy`` → ``ReplicaManager`` → ``FleetRouter``, each
    replica a ``ServingEngine`` joined from the store; phase 18's
    configuration) under ``_chip/fleet``: each request image's detections
    byte-equal at every row of a batch; the store by ``tools/fleet.py
    export`` (K1/K2 libraries); a 2-replica fleet (replica k on card k
    where there are two, else both on card 0) joining with 0 builds; a
    closed loop of 8 s through ``FleetRouter.detect`` (lost 0, K1 2 and K2
    1 launches per engine batch summed over the replicas, each on its
    replica's card), 8 requests alone in their batches bit-equal to the
    offline batch; 1 against 2 replicas; a replica killed mid-burst (lost
    0, ejected, a scrape reading it down, ``fleet-degraded`` CRITICAL
    then OK, relaunched from the store with 0 builds); the card's memory
    back within 64 MiB after each fleet closes; then processes over a
    copy of the package whose ``_build/`` is empty: ``tools/bulk.py
    --protocol kill_resume --replicas 2 --check`` over 48 train2017
    images (the union byte-equal to the control) and ``tools/fleet.py
    join_bench`` by warm-up (builds K1 and K2) and from the store
    (builds none), both started with the HTTP service beside the
    protocol's killed child; last ``tools/fleet.py serve --replicas 2`` (4 ``/detect``,
    ``/healthz``, ``/metrics``, SIGINT);
20. the cross-host serving tier, the fourteenth main path
    (``serve/remote.py — RemoteEngine`` over the binary wire →
    ``tools/agent.py`` processes: ``serve/agent.py — ReplicaAgent`` →
    ``FleetRouter`` → ``ServingEngine``; ``serve/scheduler.py``) under
    ``_chip/crosshost``, at phase 19's configuration: phase 19's store
    (exported here when the phase runs alone) served by
    ``make_store_server``; two agent processes (agent k on card k mod
    the card count), started beside phase 19's killed bulk child, each
    over a copy of the package whose ``_build/`` is empty, pulling it
    (each file shipped once an agent) and joining with 0 kernel builds;
    through
    ``build_crosshost_router`` (the backlog feed on), every request image
    as a v1 fp32 frame, a v2 u8 source frame and in envelopes, each
    response byte-equal to the offline batch, the agents' K1 2 and K2 1
    launches per engine batch (from their ``/healthz``), v2 at most 0.30
    of v1's bytes an image; one sampled request's tree merged by
    ``tools/trace.py`` across the processes (the wire span before the
    agent's); closed loops of 1 and 2 agents at concurrency 16 (lost 0;
    scaling judged only on two cards); one agent SIGKILLed mid-burst
    under the live ``FleetScheduler`` (lost 0, no failure or expiry, the
    survivor grown from its store with 0 builds) and the cards' free
    memory back after the agents are gone;
21. the rollout plane, the fifteenth main path (``serve/rollout.py —
    RolloutController`` → ``AgentRolloutPort`` → each agent's ``POST
    /rollout``: the pull, the canary lane, the shadow pairs, the swap and
    the rollback through ``FleetRouter`` and ``ServingEngine``), driven
    by ``tools/rollout.py``'s legs over phase 20's agents before its kill
    leg, at phase 19's configuration: stores v2 (the boot weights, a
    child of the boot store), v2d (``tools/rollout.py``'s damage of every
    matrix at scale 10; its outputs must be finite) and an unrooted v1;
    the lineage truth
    table; v1 → v2 mid-burst (lost 0, each v2 file shipped once an
    agent, second pulls ``already``, 0 kernel builds in the burst after
    the swap, both hosts all-v2, every shadow pair's base score above 0
    and its delta exactly 0.0); v2d (it passes lineage, the gate refuses
    it on finite deltas, judged worse: mean delta below 0 and the CI
    wholly below −budget; the controller rolls back by itself, both hosts base-only, lost 0, a
    second rollback through ``FleetScheduler.rollback`` a recorded
    no-op); the agents' K1 2 and K2 1 per engine batch plus, per
    replica joined from a store, K1 once a bucket plus once and K2 once
    a bucket;
22. fault-tolerant and elastic training, the sixteenth main path
    (``ft/faults.py``, ``ft/elastic.py``, ``ft/supervisor.py``,
    ``tools/crashloop.py``, ``tools/profile_step.py``), ResNet-101 in
    bf16 on the 608x1024 bucket: ``tools/profile_step.py --check`` at
    bench.py's configuration (batch 2, 81 classes, pre/post-NMS
    6000/2000) in this process, its stage table with K1, K2 and K3 once
    a chained iteration in their stages and no kernel built in a timed
    pass, then ``--nms_mode per_image --quant`` (K1 once an image, K4/K5
    in the int8 forward); ``tools/crashloop.py --smoke --check`` (a
    control, a SIGTERM mid-epoch, a torn write and a SIGKILL past a
    boundary, each child a ``tools/train.py`` process on 16 generated
    images, pre/post-NMS 1024/300 as the JAX supervisor's recipe sets)
    beside ``--elastic --smoke --check`` (a two-process world of one rank
    each, gloo on ``cuda:0`` on one card, through a SIGTERM, a shrink to
    one rank with grad_accum 2, a grow back and completion), beside the
    lanes: the survivor byte-equal to the control, K1/K2/K3
    1/1/1 a step in every child, every restore bit-identical, the steps
    per epoch unchanged, steps left when the grow lands; then
    ``measure_snapshot_overhead(network='resnet101')`` alone, its async
    stall under the tool's 5% ceiling;
23. the durability plane and the train-step store, the seventeenth main
    path (``analysis/crashsim.py``, ``tools/crashsim.py``,
    ``serve/export.py — export_train_step`` / ``load_train_step``), in
    processes of their own beside the lanes:
    ``tools/train.py --export_train_step`` at bench.py's configuration
    (ResNet-101, bf16, batch 2, 608x1024, pre/post-NMS 6000/2000), the
    live and the loaded step bit-equal under the pinned algorithms, K1,
    K2 and K3 once a step in each and bundled with the sha of the
    library this checkout builds; a second process over a package copy
    with an empty ``_build/`` installs the store's libraries, builds
    nothing and passes ``require_digest`` on the same start state and
    batch; ``tools/crashsim.py --smoke --check --device cuda
    --max_states 32``: every real arm 0 violations over at least 10
    states, both planted arms
    flagged, K1 and K2 launched by the export arm's recoveries;
24. the accuracy gauntlet, the eighteenth main path
    (``tools/gauntlet.py`` → ``train_net`` → ``test_rcnn`` on the
    generated ``synthetic_hard`` set, under the tool's deterministic
    pins), in processes of their own beside the lanes, each through
    ``GT_CHILD``, which counts every
    ``train_net`` and ``test_rcnn`` call's launches: (a) the paired
    red-team gate at the JAX slow test's recipe (tiny, seeds 0 1, 4
    epochs, lr 3e-3, step 3), its four cells a process each, then
    ``--compare e2e redteam`` over their records: exit 1, every delta
    below -budget, the mean delta below -0.05, the redteam records
    damaged ``test__nms=0.9``, the e2e and redteam checkpoints of each
    seed byte-equal; (b) beside the cells, ResNet-101 in bf16, seed 0,
    one epoch of the set cut to 16 train and 8 test images (the
    script's budget): one record with a finite mAP in [0, 1]; in both
    K1, K2 and K3 once a training step, K1 twice and K2 once an eval
    batch;
25. the network surface's linter and fuzzer, the nineteenth main path
    (``analysis/netlint.py``, ``analysis/wirefuzz.py``,
    ``tools/wirefuzz.py``): (a) in processes of their own beside the
    lanes, ``python -m mx_rcnn_tpu_torch.analysis.netlint`` over the
    port (exit 0, no unwaived finding) and ``python -m
    mx_rcnn_tpu_torch.tools.wirefuzz --seed 16`` in full (its stand-in
    agents on the host): ok, 0 violations, the three planted arms
    flagged, 572 cases as the JAX record counts; (b) inside phase 20,
    over its two ResNet-101 agent processes before phase 21 (both
    serving the boot weights): the agent leg aimed at agent 0 (every
    mutated v1, v2 and traced frame and envelope 4xx, a multi-GB
    ``Content-Length`` 413, a missing one 411, a mid-frame disconnect,
    garbage pipelined behind a valid frame; the slow trickle stays in
    (a), as these agents hold a 30 s body deadline), then ``/healthz``
    200, agent 0's engine batches grown only by the good frames'
    batches with K1 2 and K2 1 launches a batch, no kernel build after
    the warm, each request image's detections byte-equal to the offline
    batch through agent 0; then the proxy leg, a second router reaching
    agent 0 through the ``FaultProxy`` (truncate, reset, delay, split,
    black-hole) and agent 1 directly: every frame (the request images'
    canvases) served once, byte-equal to the offline batch, 0 lost, K1
    2 and K2 1 a batch over both agents.

The phases run in this order: 1-4, phase 16's kernels (K4-K6 against
their plain versions and timed) and 5-9, with the card to themselves;
then two lanes beside each other and beside phases 22-24's legs and
phase 25 (a) (each leg in processes of its own): lane A, phases 10, 12, the rest of 16 and
17 in this process, and lane B, phases 13, 14 and 15 in a process of
this script of its own (``chip_smoke.py --lane``, which dies with this
one); when both lanes and the legs have ended, phases 11 and 18-24 with
the card to themselves again (phase 11's open loops are set from rates
measured just before them, and phase 20's memory check needs no other
process on the card).  So the kernels line's times are taken alone, and
the times of phases 10 and 12-17 beside other processes.  Each lane has
its own launch counts and cuDNN settings.

Each main path is driven with every launch count set to 0 just before it
and read just after; each of its kernels must have launched.  The lines
before the last are the card's name and power limit and one
``{"kernels": [...]}`` JSON object (K1-K3: launches from the training
path, times at the training shapes; K4-K6: launches from the quantized
eval, times at the per-ROI stage-4 bn1 and 1x1; ``launches_phase22``,
where phase 23 launches the kernel ``launches_phase23``, for K1-K3
``launches_phase24``, and for K1 and K2 ``launches_phase25``); the last line is ``{"ok": true, "device":
{...}}``.  Longer records (build logs, the full results, the CLIs'
output) go to ``chiprun_out/chip_smoke/``; phases 9–12 write their
checkpoints (and phase 12 its datasets) under the ignored ``_chip/``
directory and remove them at their end, and phases 13–18 their
weight files, checkpoints and datasets likewise, and phases 19–24
too.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"
WORK_DIR = REPO / "_chip" / "chip_smoke"      # phase 9's checkpoints

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the tensor
# cores.  Both kernels do fp32 arithmetic on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# fp32 operations per IoU test as the kernel and the reference do it:
# 2 min, 2 max, 2 sub, 2 add, 2 clamp, 1 mul, add+sub, 1 compare, 1 max,
# 1 div, 1 compare
IOU_OPS = 17
# fp32 operations per ROIAlign sample: 4 taps, one multiply-add each
ROI_SAMPLE_OPS = 8

VOC_CLASSES = 21
BUCKET = (608, 1024)
TRAIN_ROIS = 128           # train__batch_rois: sampled rois per image
TRAIN_STEPS = 6            # steps of the training CLI run
THRESHOLDS = (0.3, 0.5, 0.7)   # every K1 check runs at each


# K4-K6 run only on the quantized path (phase 16): the fp phases read the
# three kernels they drive and hold the quantized ones at zero launches
QUANT_KERNELS = ("quantize_act", "qconv_s8", "qconv_e4m3")


def fp_only(counts: dict) -> dict:
    stray = {k: counts[k] for k in QUANT_KERNELS if counts.get(k)}
    if stray:
        raise AssertionError(f"an fp path launched quantized kernels: "
                             f"{stray}")
    return {k: v for k, v in counts.items() if k not in QUANT_KERNELS}


def fp_launches() -> dict:
    """Every kernel's launch count but K4-K6's, which must be zero."""
    from mx_rcnn_tpu_torch import kernels

    return fp_only(kernels.launch_counts())


def log(msg: str) -> None:
    # past any ``redirect_stdout`` of the main thread, so that a leg run
    # by :func:`in_background` meanwhile logs to the script's output
    print(msg, file=sys.__stdout__, flush=True)


def in_background(fn, *args):
    """``fn(*args)`` in a thread started now; the returned function joins
    it and gives its result, or raises what it raised.  Only for legs
    whose work runs in processes of their own: the launch counts and
    cuDNN's settings are this process's, so such a leg touches neither
    the card nor them here."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised by the join
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_info(dev=None) -> dict:
    """The host: its CPU model as ``/proc/cpuinfo`` names it, its core
    count, the cores this process may use, the 1/5/15-minute load
    averages, and two timings of its speed, best of 5: a fixed
    pure-Python loop (``py_loop_ms``, what a GIL-bound dispatcher runs
    at) and, given a CUDA ``dev``, the host time per issued tiny CUDA
    operation (``issue_us_per_op``, 2000 in-place adds then one
    synchronise).  Host-bound rates are read beside them: two calls may
    land on two hosts, and a host's cores are shared."""
    model = "not reported"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), model)
    except OSError:
        pass
    loop = []
    for _ in range(5):
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        loop.append((time.perf_counter() - t0) * 1e3)
    out = dict(cpu_model=model,
               cpu_count=os.cpu_count(),
               usable_cpus=len(os.sched_getaffinity(0)),
               loadavg=[round(v, 2) for v in os.getloadavg()],
               py_loop_ms=min(loop))
    if dev is not None:
        import torch

        x = torch.zeros(1, device=dev)
        issue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                x.add_(1)
            torch.cuda.synchronize()
            issue.append((time.perf_counter() - t0) / 2000 * 1e6)
        out["issue_us_per_op"] = min(issue)
    return out


def host_text(h: dict) -> str:
    text = (f"{h['cpu_model']}, {h['cpu_count']} cores ({h['usable_cpus']} "
            f"usable), load average {h['loadavg']}, a fixed Python loop "
            f"{h['py_loop_ms']:.2f} ms")
    if "issue_us_per_op" in h:
        text += f", {h['issue_us_per_op']:.2f} us of host time per CUDA op"
    return text


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` with no host time between calls:
    ``iters`` calls captured in one CUDA graph, replayed once."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 2: K1 -----------------------------------------------------------

def nms_inputs(batch: int, k: int, seed: int, dev, bucket=BUCKET):
    """Score-sorted, padded boxes as the proposal stage hands them to K1:
    random proposals on the (h, w) ``bucket`` canvas with planted exact
    duplicates, near-duplicates and tied scores, some slots invalid."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.ops.nms import _mask_pad_sort

    rng = np.random.RandomState(seed)
    h, w = bucket
    xy = rng.uniform(0, [w - 16, h - 16], (batch, k, 2))
    wh = rng.uniform(16, 400, (batch, k, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1)
    scores = rng.uniform(size=(batch, k))
    dup = rng.randint(0, k, (batch, k // 20))
    for b in range(batch):
        src = rng.randint(0, k, dup.shape[1])
        boxes[b, dup[b]] = boxes[b, src]                 # exact duplicates
        scores[b, dup[b][::2]] = scores[b, src[::2]]     # and tied scores
        near = rng.randint(0, k, k // 20)
        boxes[b, near] = boxes[b, rng.randint(0, k, near.size)] + \
            rng.uniform(-2, 2, (near.size, 4))
    scores = np.round(scores * 512) / 512                # many score ties
    valid = rng.uniform(size=(batch, k)) > 0.05
    return _mask_pad_sort(
        torch.tensor(boxes, dtype=torch.float32, device=dev),
        torch.tensor(scores, dtype=torch.float32, device=dev),
        torch.tensor(valid, device=dev), 256)


def boundary_inputs(batch: int, k: int, seed: int, dev):
    """Integer boxes on a small canvas with quantised scores: many IoUs
    are simple fractions that land exactly on a threshold (7/10 rounds to
    the same fp32 as 0.7), so only an identical IoU rounding keeps the
    ``iou > thr`` decisions equal."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.ops.nms import _mask_pad_sort

    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 48, (batch, k, 2))
    wh = rng.randint(0, 24, (batch, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.randint(0, 8, (batch, k)) / 8.0
    return _mask_pad_sort(
        torch.tensor(boxes, dtype=torch.float32, device=dev),
        torch.tensor(scores, dtype=torch.float32, device=dev), None, 256)


def cluster_inputs(batch: int, k: int, seed: int, dev):
    """Score-sorted boxes in tight clusters of jittered copies, ~40 per
    cluster, as an RPN proposes around few objects: almost every box is
    suppressed."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.ops.nms import _mask_pad_sort

    rng = np.random.RandomState(seed)
    h, w = BUCKET
    m = max(k // 40, 1)
    wh = rng.uniform(32, 300, (batch, m, 2))
    xy = rng.uniform(0, [w - 300, h - 300], (batch, m, 2))
    pick = rng.randint(0, m, (batch, k))
    lo = np.take_along_axis(xy, pick[..., None], 1)
    size = np.take_along_axis(wh, pick[..., None], 1)
    boxes = np.concatenate([lo, lo + size], -1) + rng.uniform(
        -4, 4, (batch, k, 4))
    return _mask_pad_sort(
        torch.tensor(boxes, dtype=torch.float32, device=dev),
        torch.tensor(rng.uniform(size=(batch, k)), dtype=torch.float32,
                     device=dev), None, 256)


def greedy_pairs(keep, alive) -> int:
    """IoU tests greedy NMS needs on this data: each kept box against
    every live box after it."""
    import torch

    after = alive.flip(-1).cumsum(-1).flip(-1) - alive.to(torch.int64)
    return int((after * keep).sum())


def check_k1(label: str, boxes, alive, t: int) -> None:
    """K1 against the plain sweep on one input at each of THRESHOLDS: the
    keep masks must be equal."""
    import torch

    from mx_rcnn_tpu_torch.ops.nms import (suppression_sweep_cuda,
                                           suppression_sweep_plain)

    b, k = alive.shape
    for thr in THRESHOLDS:
        keep = suppression_sweep_cuda(boxes, alive, thr)
        torch.cuda.synchronize()
        diff = int((keep != suppression_sweep_plain(boxes, alive, thr,
                                                    t)).sum())
        log(f"K1 {label}: B={b} K={k} thr={thr} kept {int(keep.sum())}/"
            f"{int(alive.sum())} mismatches={diff}")
        if diff:
            raise AssertionError(f"K1 keep mask differs from the plain sweep "
                                 f"on {label} at {thr} ({diff})")


def time_k1(label: str, boxes, alive, t: int, thr: float) -> dict:
    """K1's time (CUDA events over 50 launches), each pass's time (from a
    profiler trace, by kernel name), the plain version's time and the
    bound, at one threshold."""
    from mx_rcnn_tpu_torch.ops.nms import (suppression_sweep_cuda,
                                           suppression_sweep_plain)

    keep = suppression_sweep_cuda(boxes, alive, thr)
    ms = time_ms(lambda: suppression_sweep_cuda(boxes, alive, thr), 50)
    passes = device_profile(lambda: suppression_sweep_cuda(boxes, alive, thr),
                            20)["kernel_ms_per_iter"]
    plain_ms = time_ms(
        lambda: suppression_sweep_plain(boxes, alive, thr, t), 3, 1)
    nbytes = boxes.numel() * 4 + alive.numel() + keep.numel()
    bound_ms, bound_by = bound(nbytes, IOU_OPS * greedy_pairs(keep, alive))
    kept, live = int(keep.sum()), int(alive.sum())
    log(f"K1 {label}: {ms:.4f} ms (mask pass {passes['k1_mask']:.4f} ms, "
        f"reduction {passes['k1_reduce']:.4f} ms in the profiler), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); kept "
        f"{kept} of {live}")
    return dict(shape=list(alive.shape), thr=thr, ms=ms,
                mask_pass_ms=passes["k1_mask"], reduce_ms=passes["k1_reduce"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                kept=kept, alive=live, max_abs_err=0.0)


def phase_k1(dev) -> dict:
    from mx_rcnn_tpu_torch.kernels import NMS_SWEEP

    shapes = {"proposal": (2, 6000, 0.7),
              "postprocess": (2 * VOC_CLASSES, 300, 0.3),
              "train_proposal": (2, 12000, 0.7)}
    res = {}
    for i, (name, (b, k, thr)) in enumerate(shapes.items()):
        boxes, _, alive, _, t = nms_inputs(b, k, seed=10 + i, dev=dev)
        check_k1(name, boxes, alive, t)
        res[name] = time_k1(name, boxes, alive, t, thr)
    # the training shape again, on clusters where almost every box is
    # suppressed: the reduction's time must not follow the kept count
    boxes, _, alive, _, t = cluster_inputs(2, 12000, seed=13, dev=dev)
    check_k1("train_proposal clusters", boxes, alive, t)
    res["train_proposal_clusters"] = time_k1("train_proposal clusters",
                                             boxes, alive, t, 0.7)
    # any K: under one block, ragged, and a few blocks
    for k in (1, 63, 65, 130):
        boxes, _, alive, _, t = nms_inputs(3, k, seed=k, dev=dev)
        check_k1(f"edge K={k}", boxes, alive, t)
    boxes, _, alive, _, t = nms_inputs(3, 700, seed=7, dev=dev)
    alive[1] = False
    check_k1("an all-dead image", boxes, alive, t)
    for seed in (3, 5, 7):
        boxes, _, alive, _, t = boundary_inputs(8, 1000, seed=seed, dev=dev)
        check_k1(f"integer boxes (seed {seed})", boxes, alive, t)
    if NMS_SWEEP.launches == 0:
        raise AssertionError("K1 never launched")
    return res


# ---- phase 3: K2 -----------------------------------------------------------

def roi_inputs(n: int, r: int, seed: int, dev, wh=(0, 500), c: int = 1024,
               bucket=BUCKET):
    """The stride-16 map of the (h, w) ``bucket`` canvas (38x64xC for
    608x1024, 64x38xC for 1024x608) and (n, r) random rois on that
    canvas, sides uniform in ``wh`` px."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    fh, fw = bucket[0] // 16, bucket[1] // 16
    feat = torch.tensor(rng.standard_normal((n, fh, fw, c)),
                        dtype=torch.float32, device=dev)
    xy = rng.uniform(-8, [bucket[1], bucket[0]], (n, r, 2))
    sides = rng.uniform(wh[0], wh[1], (n, r, 2))
    rois = torch.tensor(np.concatenate([xy, xy + sides], -1),
                        dtype=torch.float32, device=dev)
    return feat, rois


def placed_rois(n: int, r: int, seed: int, dev, where: str, bucket=BUCKET):
    """(n, r) rois that cover the whole (h, w) ``bucket`` canvas (jittered
    past its borders) or lie wholly outside it."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    h, w = bucket
    if where == "whole map":
        lo = rng.uniform(-24, 8, (n, r, 2))
        hi = np.array([w, h]) + rng.uniform(-8, 24, (n, r, 2))
        lo[:, 0], hi[:, 0] = 0, [w - 1, h - 1]
    else:
        side = rng.randint(0, 2, (n, r, 1))      # left/above or right/below
        lo = np.where(side, np.array([w, h]) + rng.uniform(16, 400, (n, r, 2)),
                      -rng.uniform(100, 600, (n, r, 2)))
        hi = lo + rng.uniform(16, 90, (n, r, 2))
    return torch.tensor(np.concatenate([lo, hi], -1), dtype=torch.float32,
                        device=dev)


def misaligned(t):
    """A copy of t whose data starts one element past a 16-byte boundary:
    K2 must take its one-channel-per-thread path."""
    import torch

    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned view is aligned")
    return view


def check_k2(label: str, feat, rois, feat16=None, size=(14, 14), sr=2):
    """K2 against its plain version in fp32 (atol 1e-4) and in bf16 (half
    a bf16 ulp of the fp32 plain version on the same bf16 inputs, plus
    1e-4); returns the two max errors."""
    import torch

    from mx_rcnn_tpu_torch.ops.roi_pool import roi_align_cuda, roi_align_plain

    got = roi_align_cuda(feat, rois, size, 1 / 16, sr)
    torch.cuda.synchronize()
    want = roi_align_plain(feat, rois, size, 1 / 16, sr)
    err32 = float((got - want).abs().max())
    log(f"K2 {label} fp32: N={feat.shape[0]} R={rois.shape[1]} "
        f"{tuple(feat.shape[1:])} max|err|={err32:.3e} (atol 1e-4)")
    if not err32 <= 1e-4:
        raise AssertionError(f"K2 {label} fp32 max error {err32} > 1e-4")
    # bf16: the kernel accumulates the bf16 taps in fp32 and rounds once,
    # so against the fp32 plain version on the same bf16 inputs it is off
    # by the final rounding alone: half a bf16 ulp, |err| <= 2^-8 |ref| (8
    # significant bits), plus the fp32 check's 1e-4 for the order of
    # summation, which differs between the gather and the einsum pair
    feat16 = feat.to(torch.bfloat16) if feat16 is None else feat16
    got16 = roi_align_cuda(feat16, rois, size, 1 / 16, sr)
    torch.cuda.synchronize()
    ref16 = roi_align_plain(feat16.float(), rois, size, 1 / 16, sr)
    excess = float(((got16.float() - ref16).abs()
                    - (2.0 ** -8 * ref16.abs() + 1e-4)).max())
    err16 = float((got16.float() - ref16).abs().max())
    log(f"K2 {label} bf16: max|err|={err16:.3e}, worst excess over "
        f"2^-8|ref|+1e-4 = {excess:.3e}")
    if excess > 0:
        raise AssertionError(f"K2 {label} bf16 beyond half a bf16 ulp of the "
                             f"fp32 plain version")
    return err32, err16


def time_k2(label: str, f, rois, err: float, size=(14, 14), sr=2) -> dict:
    """K2's time (CUDA events over 50 launches; its own device time from a
    profiler trace, by kernel name), the time of a PyTorch fill of a tensor
    of the output's size (the card writing those bytes alone), the plain
    version's time and the bound."""
    import torch

    from mx_rcnn_tpu_torch.ops.roi_pool import roi_align_cuda, roi_align_plain

    n, r = rois.shape[:2]
    ms = time_ms(lambda: roi_align_cuda(f, rois, size, 1 / 16, sr), 50)
    device_ms = device_profile(
        lambda: roi_align_cuda(f, rois, size, 1 / 16, sr),
        20)["kernel_ms_per_iter"]["k2"]
    out = torch.empty((n, r) + tuple(size) + (f.shape[-1],), dtype=f.dtype,
                      device=f.device)
    write_ms = time_ms(lambda: out.fill_(1.0), 50)
    plain_ms = time_ms(lambda: roi_align_plain(f, rois, size, 1 / 16, sr), 5)
    out_elems = out.numel()
    nbytes = (f.numel() + out_elems) * f.element_size() + rois.numel() * 4
    bound_ms, bound_by = bound(nbytes, out_elems * sr * sr * ROI_SAMPLE_OPS)
    log(f"K2 {label} {'bf16' if f.dtype == torch.bfloat16 else 'fp32'}: "
        f"{ms:.4f} ms ({device_ms:.4f} ms in the profiler), output write "
        f"alone {write_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(shape=[n, r] + list(f.shape[1:]), ms=ms, device_ms=device_ms,
                write_ms=write_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


def phase_k2(dev) -> dict:
    import torch

    res = {}
    # the two main shapes on random rois (0-500 px a side, many crossing
    # a border), then the same shapes on small rois (16-64 px), timed
    for name, n, r, seed, wh in (("serving", 2, 300, 20, (0, 500)),
                                 ("train", 2, TRAIN_ROIS, 21, (0, 500)),
                                 ("serving_small", 2, 300, 22, (16, 64)),
                                 ("train_small", 2, TRAIN_ROIS, 23, (16, 64))):
        feat, rois = roi_inputs(n, r, seed, dev, wh)
        err32, err16 = check_k2(name, feat, rois)
        res[name] = {tag: time_k2(name, f, rois, err)
                     for tag, f, err in (("bf16", feat.to(torch.bfloat16),
                                          err16), ("fp32", feat, err32))}
    # edge cases, checked only
    feat, _ = roi_inputs(2, 1, 24, dev)
    for label, where in (("rois covering the whole map", "whole map"),
                         ("rois wholly outside the map", "outside")):
        check_k2(label, feat, placed_rois(2, 16, 25, dev, where))
    check_k2("R=1", *roi_inputs(2, 1, 26, dev))
    check_k2("C=1021 (one channel per thread)",
             *roi_inputs(2, 64, 27, dev, c=1021))
    feat, rois = roi_inputs(2, 64, 28, dev)
    check_k2("a base pointer off 16 B (one channel per thread)",
             misaligned(feat), rois, misaligned(feat.to(torch.bfloat16)))
    return res


# ---- phase 4: K3 -----------------------------------------------------------

def k3_grad(n: int, r: int, seed: int, dev, c: int = 1024, size=(14, 14)):
    """A standard-normal pooled gradient (n, r, ph, pw, c), fp32, drawn on
    the card from a seed."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, r) + tuple(size) + (c,), generator=gen,
                       device=dev)


def check_k3(label: str, g, rois, hw, g16=None, sr: int = 2):
    """K3 against its plain version in fp32 and in bf16, two launches
    bit-equal in each; returns the two max errors."""
    import torch

    from mx_rcnn_tpu_torch.ops.roi_pool import (roi_align_bwd_cuda,
                                                roi_align_bwd_plain)

    n, r = rois.shape[:2]
    got = roi_align_bwd_cuda(g, rois, hw, 1 / 16, sr)
    torch.cuda.synchronize()
    want = roi_align_bwd_plain(g, rois, hw, 1 / 16, sr)
    # fp32: both sum the same products in fp32 in other orders; |err| <=
    # 1e-4 + 1e-5 |ref| (dfeat sums up to a few thousand terms)
    excess32 = float(((got - want).abs() - (1e-4 + 1e-5 * want.abs())).max())
    err32 = float((got - want).abs().max())
    same32 = torch.equal(got, roi_align_bwd_cuda(g, rois, hw, 1 / 16, sr))
    log(f"K3 {label} fp32: N={n} R={r} {hw} C={g.shape[-1]} sr={sr} "
        f"max|err|={err32:.3e} (max|ref| {float(want.abs().max()):.3g}; "
        f"tolerance 1e-4 + 1e-5|ref|, worst excess {excess32:.3e}); two "
        f"launches bit-equal: {same32}")
    if excess32 > 0 or not same32:
        raise AssertionError(f"K3 {label} fp32 differs from the plain "
                             f"version or between two launches")
    # bf16 g: the kernel reads bf16, sums in fp32 and rounds once, so it is
    # within half a bf16 ulp of the fp32 sum of the same bf16 values, plus
    # the fp32 tolerance for the order of summation
    g16 = g.to(torch.bfloat16) if g16 is None else g16
    got16 = roi_align_bwd_cuda(g16, rois, hw, 1 / 16, sr)
    torch.cuda.synchronize()
    ref16 = roi_align_bwd_plain(g16.float(), rois, hw, 1 / 16, sr)
    excess16 = float(((got16.float() - ref16).abs()
                      - (2.0 ** -8 * ref16.abs() + 1e-4 + 1e-5 * ref16.abs()))
                     .max())
    err16 = float((got16.float() - ref16).abs().max())
    same16 = torch.equal(got16, roi_align_bwd_cuda(g16, rois, hw, 1 / 16, sr))
    log(f"K3 {label} bf16: max|err|={err16:.3e}, worst excess over "
        f"2^-8|ref| + 1e-4 + 1e-5|ref| = {excess16:.3e}; two launches "
        f"bit-equal: {same16}")
    if excess16 > 0 or not same16:
        raise AssertionError(f"K3 {label} bf16 beyond half a bf16 ulp of the "
                             f"fp32 plain version, or not deterministic")
    return err32, err16


def time_k3(label: str, g, rois, hw, err: float, sr: int = 2) -> dict:
    """K3's time (CUDA events over 50 launches; its device time, tables
    pass included, and the tables pass alone from a profiler trace), the
    plain version's time and the bound."""
    import torch

    from mx_rcnn_tpu_torch.ops.roi_pool import (roi_align_bwd_cuda,
                                                roi_align_bwd_plain)

    n = g.shape[0]
    ms = time_ms(lambda: roi_align_bwd_cuda(g, rois, hw, 1 / 16, sr), 50)
    device = device_profile(lambda: roi_align_bwd_cuda(g, rois, hw, 1 / 16,
                                                       sr),
                            20)["kernel_ms_per_iter"]
    plain_ms = time_ms(lambda: roi_align_bwd_plain(g, rois, hw, 1 / 16, sr),
                       5)
    nbytes = ((g.numel() + n * hw[0] * hw[1] * g.shape[-1])
              * g.element_size() + rois.numel() * 4)
    bound_ms, bound_by = bound(nbytes, g.numel() * sr * sr * ROI_SAMPLE_OPS)
    log(f"K3 {label} {'bf16' if g.dtype == torch.bfloat16 else 'fp32'}: "
        f"{ms:.4f} ms ({device['k3']:.4f} ms in the profiler, tables pass "
        f"{device['k3_tables']:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(shape=list(g.shape), ms=ms, device_ms=device["k3"],
                tables_ms=device["k3_tables"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


def phase_k3(dev) -> dict:
    import torch

    from mx_rcnn_tpu_torch.kernels import ROI_ALIGN_BWD

    hw = (BUCKET[0] // 16, BUCKET[1] // 16)
    res = {}
    # the training shape on random rois (0-500 px a side) and small ones
    # (16-64 px), timed
    for name, seed, wh in (("train", 30, (0, 500)),
                           ("train_small", 23, (16, 64))):
        _, rois = roi_inputs(2, TRAIN_ROIS, seed, dev, wh)
        g = k3_grad(2, TRAIN_ROIS, seed + 1, dev)
        err32, err16 = check_k3(name, g, rois, hw)
        res[name] = {tag: time_k3(name, gg, rois, hw, err)
                     for tag, gg, err in (("bf16", g.to(torch.bfloat16),
                                           err16), ("fp32", g, err32))}
    # edge cases, checked only
    for label, where in (("rois covering the whole map", "whole map"),
                         ("rois wholly outside the map", "outside")):
        check_k3(label, k3_grad(2, 16, 35, dev),
                 placed_rois(2, 16, 36, dev, where), hw)
    check_k3("R=1", k3_grad(2, 1, 37, dev), roi_inputs(2, 1, 26, dev)[1], hw)
    check_k3("C=1021 (one channel per thread)", k3_grad(2, 64, 38, dev, 1021),
             roi_inputs(2, 64, 27, dev)[1], hw)
    g = k3_grad(2, 64, 39, dev)
    check_k3("a base pointer off 16 B (one channel per thread)", misaligned(g),
             roi_inputs(2, 64, 28, dev)[1], hw,
             misaligned(g.to(torch.bfloat16)))
    for sr in (1, 4):
        check_k3(f"sr {sr}", k3_grad(2, TRAIN_ROIS, 40 + sr, dev),
                 roi_inputs(2, TRAIN_ROIS, 30, dev)[1], hw, sr=sr)
    if ROI_ALIGN_BWD.launches == 0:
        raise AssertionError("K3 never launched")
    return res


# ---- phase 5: whole forward, kernels against plain versions ----------------

@contextlib.contextmanager
def plain_versions():
    """Route the forward through the plain versions on the card, for the
    comparison only (the port itself never does)."""
    import mx_rcnn_tpu_torch.core.train as train
    import mx_rcnn_tpu_torch.models.faster_rcnn as frcnn
    import mx_rcnn_tpu_torch.ops.nms as nms
    from mx_rcnn_tpu_torch.ops.roi_pool import roi_align_plain

    saved = nms.suppression_sweep, frcnn.roi_align, train.roi_align_batched
    nms.suppression_sweep = nms.suppression_sweep_plain
    # roi_align_plain is the einsum pair, differentiable by autograd
    frcnn.roi_align = train.roi_align_batched = roi_align_plain
    try:
        yield
    finally:
        (nms.suppression_sweep, frcnn.roi_align,
         train.roi_align_batched) = saved


def phase_forward_parity(dev, network: str = "resnet101") -> dict:
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.data.image import prepare_image
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.tools import demo

    torch.backends.cudnn.deterministic = True
    cfg = generate_config(network, "PascalVOC",
                          network__compute_dtype="float32")
    predictor = Predictor(build_model(cfg, dev, seed=1), cfg, dev)
    canvases, info = [], []
    for img in demo.synthetic_images(2, seed=5):
        canvas, im_info, _ = prepare_image(img, cfg)
        canvases.append(canvas)
        info.append(im_info)
    images, im_info = np.stack(canvases), np.stack(info)
    got = [t.float().cpu() for t in predictor.raw(images, im_info)]
    with plain_versions():
        want = [t.float().cpu() for t in predictor.raw(images, im_info)]
    names = ("rois", "roi_valid", "cls_prob", "bbox_deltas")
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(names, got,
                                                             want)}
    log(f"forward {network} fp32 608x1024 batch 2: kernels vs plain "
        f"max|diff| {errs}")
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("rois / roi_valid differ between the kernel "
                             "and plain paths")
    if errs["cls_prob"] > 1e-4 or errs["bbox_deltas"] > 1e-3:
        raise AssertionError(f"head outputs differ: {errs}")
    torch.backends.cudnn.deterministic = False
    return errs


# ---- phase 7: serving, the first main path -------------------------------

def stage_times(predictor, images, im_info, iters: int, warmup: int = 2
                ) -> dict:
    """Per-stage times of one forward + postprocess, from CUDA events
    recorded as each stage ends (the device timeline, gaps included)."""
    import torch

    from mx_rcnn_tpu_torch.models.faster_rcnn import to_device_batch
    from mx_rcnn_tpu_torch.tools import demo

    imgs, info = to_device_batch(images, im_info, predictor.device)
    order = ("backbone", "proposal", "roi_align", "head", "postprocess")
    sums = dict.fromkeys(order, 0.0)
    for it in range(warmup + iters):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        with torch.inference_mode():
            out = predictor.model(imgs, info, stage_hook=mark)
        demo.postprocess(predictor, out, info, predictor.cfg.test.score_thresh)
        mark("postprocess")
        torch.cuda.synchronize()
        if it >= warmup:
            for name, a, b in zip(order, events, events[1:]):
                sums[name] += a.elapsed_time(b)
    return {k: v / iters for k, v in sums.items()}


def device_profile(run, iters: int, cpu: bool = True) -> dict:
    """Device time per call of ``run()`` from a ``torch.profiler`` trace
    (sum of kernel and copy times), the top kernels by time, and the time
    of each kernel of KERNEL_NAMES (K1's two passes apart).  ``cpu=False``
    traces the device alone, which slows the host far less."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return trace_summary(prof, iters)


def trace_summary(prof, iters: int) -> dict:
    """:func:`device_profile`'s numbers from a finished ``torch.profiler``
    trace of ``iters`` calls; ``copy_ms_per_iter`` is the copies' share
    of the device time, ``elementwise_ms_per_iter`` that of PyTorch's
    elementwise kernels (the kernel names and both classes are
    ``obs/profiler.py``'s, which the obs rollup reads too)."""
    from torch.autograd import DeviceType

    from mx_rcnn_tpu_torch.obs.profiler import (KERNEL_NAMES, is_copy,
                                                is_elementwise)

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    ours = {p: sum(t for k, t, _ in rows if name in k) / 1e3 / iters
            for p, name in KERNEL_NAMES.items()}
    return dict(device_ms_per_iter=total_us / 1e3 / iters,
                copy_ms_per_iter=sum(t for k, t, _ in rows
                                     if is_copy(k)) / 1e3 / iters,
                elementwise_ms_per_iter=sum(
                    t for k, t, _ in rows if is_elementwise(k))
                / 1e3 / iters,
                top=[dict(name=k[:90], ms_per_iter=t / 1e3 / iters,
                          calls_per_iter=c / iters) for k, t, c in rows[:20]],
                kernels_per_iter=sum(r[2] for r in rows) / iters,
                kernel_ms_per_iter=ours)


def busy_share(profiled: dict, wall_ms: float):
    """Device busy share of a profiled call; a trace with no device events
    measures nothing, so it says so."""
    t = profiled["device_ms_per_iter"]
    return t / wall_ms if t > 0 else None


def phase_serving(dev, card: str) -> dict:
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.data.image import prepare_image
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.tools import demo

    cfg = generate_config("resnet101", "PascalVOC")     # bf16 by default
    if cfg.network.compute_dtype != "bfloat16":
        raise AssertionError("the flagship preset must serve in bf16")
    predictor = Predictor(build_model(cfg, dev, seed=0), cfg, dev)
    images = demo.synthetic_images(4, seed=0)
    thresh = cfg.test.score_thresh
    demo.detect(predictor, images, 2, thresh)            # warm-up
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    # the demo's own command line first (its detections go to a file),
    # then its path timed per batch
    with open(OUT_DIR / "demo.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        demo.main(["--synthetic", "4", "--batch", "2", "--seed", "0"])
    log("demo: " + (OUT_DIR / "demo.txt").read_text().splitlines()[0])
    forwards, runs = 2, {}
    for batch in (1, 2):
        t0 = time.perf_counter()
        dets = demo.detect(predictor, images, batch, thresh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards += len(images) // batch
        ndet = sum(len(v) for d in dets for v in d.values())
        finite = all(np.isfinite(v).all() for d in dets for v in d.values())
        if not finite or ndet == 0:
            raise AssertionError(f"batch {batch}: {ndet} detections, "
                                 f"finite={finite}")
        runs[batch] = dict(images_per_s=len(images) / wall,
                           wall_s=wall, detections=ndet)
    launches = fp_launches()
    log(f"serving launches over {forwards} forwards: {launches}; per "
        f"forward: " + ", ".join(f"{k} {v / forwards:g}"
                                 for k, v in launches.items()))
    # the forward runs K1 and K2; the backward kernel K3 has no place in it
    if not (launches["nms_sweep"] > 0 and launches["roi_align_fwd"] > 0
            and launches["roi_align_bwd"] == 0):
        raise AssertionError(f"the serving path's launches are wrong: "
                             f"{launches}")

    prepared = [prepare_image(img, cfg) for img in images]
    for batch in (1, 2):
        canv = np.stack([p[0] for p in prepared[:batch]])
        info = np.stack([p[1] for p in prepared[:batch]])
        raw = predictor.raw(canv, info)
        if not all(bool(torch.isfinite(t.float()).all()) for t in raw):
            raise AssertionError("non-finite forward output")
        # the proposals' mean width and height, which set K2's loads
        sides = (raw[0][..., 2:4] - raw[0][..., 0:2]).float()[raw[1].bool()]
        runs[batch]["roi_side_px"] = [float(v) for v in sides.mean(0)]
        runs[batch]["stage_ms"] = stage_times(predictor, canv, info, 10)
        # steady state: forward + postprocess back to back, host clock
        iters = 10
        for it in range(iters + 2):
            if it == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = predictor.raw(canv, info)
            demo.postprocess(predictor, out, out[0].new_tensor(info), thresh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        runs[batch]["steady_images_per_s"] = batch / wall
        info_t = torch.from_numpy(info).to(dev)
        busy = device_profile(lambda: demo.postprocess(
            predictor, predictor.raw(canv, info), info_t, thresh), 5)
        busy["busy_share"] = busy_share(busy, wall * 1e3)
        runs[batch]["device"] = busy
        ours = busy["kernel_ms_per_iter"]
        width, height = runs[batch]["roi_side_px"]
        log(f"serving bf16 batch {batch}: device busy "
            f"{busy['device_ms_per_iter']:.3f} ms of {wall * 1e3:.3f} ms per "
            f"forward+postprocess ({busy['kernels_per_iter']:.0f} device "
            f"ops), busy share {busy['busy_share'] or 'not measured'}; "
            f"per forward: K1 mask pass {ours['k1_mask']:.4f} ms, reduction "
            f"{ours['k1_reduce']:.4f} ms, K2 {ours['k2']:.4f} ms on "
            f"{sides.shape[0]} rois of mean width x height {width:.0f} x "
            f"{height:.0f} px")
        log(f"serving bf16 batch {batch} on {card}: demo path "
            f"{runs[batch]['images_per_s']:.2f} img/s, steady "
            f"{runs[batch]['steady_images_per_s']:.2f} img/s, stages (ms) "
            + json.dumps({k: round(v, 3) for k, v in
                          runs[batch]["stage_ms"].items()}))
    return dict(launches=launches, forwards=forwards, runs=runs,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


# ---- phase 6: fp32 train step, kernels against plain versions -------------

@contextlib.contextmanager
def captured_targets(into: list, name: str = "proposal_target"):
    """Record every result of the train step's ``name`` (its
    ``anchor_target`` or ``proposal_target``)."""
    import mx_rcnn_tpu_torch.core.train as train

    original = getattr(train, name)

    def record(*args, **kw):
        out = original(*args, **kw)
        into.append(out)
        return out

    setattr(train, name, record)
    try:
        yield
    finally:
        setattr(train, name, original)


DRAW_SITES = ("anchor_fg", "anchor_bg", "proposal_fg", "proposal_bg",
              "dropout_fc6", "dropout_fc7")


def fixed_draws(site: str, image: int, shape, dev):
    """Uniforms that depend only on (site, image): both passes of a
    parity phase sample from the same draws."""
    import torch

    gen = torch.Generator().manual_seed(1000 * image + DRAW_SITES.index(site))
    return torch.rand(shape, generator=gen).to(dev)


def synthetic_train_batches(cfg, batch: int, count: int, proposals=None):
    """The training CLI's data: seeded synthetic 375x500 images through
    the loader (``proposals``: through ROIIter), as numpy batches."""
    from mx_rcnn_tpu_torch.data.loader import AnchorLoader, ROIIter
    from mx_rcnn_tpu_torch.data.synthetic import (VOC_IMAGE_SIZE,
                                                  SyntheticDataset)

    ds = SyntheticDataset(cfg.dataset.image_set, batch * count,
                          cfg.num_classes, VOC_IMAGE_SIZE)
    if proposals is None:
        return list(AnchorLoader(ds.gt_roidb(), cfg, ds.load_image,
                                 batch_images=batch, seed=0))
    roidb = ds.gt_roidb()
    return list(ROIIter(roidb, cfg, ds.load_image, proposals(roidb),
                        batch_images=batch, seed=0))


def step_parity(label: str, model, loss_fn, batch, cfg, dev,
                target: str) -> dict:
    """One fp32 loss and backward of ``loss_fn`` from one set of weights
    and draws, once through the kernels and once through the plain
    versions: the sampled labels (and rois) of ``target`` equal, losses
    within a relative 1e-4, each gradient's L2 difference within 1e-3 of
    its norm."""
    import torch

    draws = lambda site, image, shape: fixed_draws(site, image, shape, dev)

    def run():
        targets = []
        model.zero_grad(set_to_none=True)
        with captured_targets(targets, target):
            total, metrics = loss_fn(model, batch, cfg, draws)
        total.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return (targets[0], {k: float(v.detach()) for k, v in metrics.items()},
                grads)

    torch.backends.cudnn.deterministic = True
    t_k, m_k, g_k = run()
    with plain_versions():
        t_p, m_p, g_p = run()
    torch.backends.cudnn.deterministic = False
    same = torch.equal(t_k.labels, t_p.labels) and (
        not hasattr(t_k, "rois") or torch.equal(t_k.rois, t_p.rois))
    # losses: the two ROIAligns sum in other orders (~1e-6 relative), which
    # the head carries to the RCNN losses; the RPN losses do not depend on
    # them.  Gradients: per tensor, the L2 norm of the difference against
    # the plain path's norm
    loss_err = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                for k in m_p}
    grad_err = {n: float((g_k[n] - g_p[n]).norm()
                         / g_p[n].norm().clamp_min(1e-30)) for n in g_p}
    worst = max(grad_err, key=grad_err.get)
    fg = int((t_k.labels > 0).sum())
    log(f"{label}: {len(g_p)} tensors with a gradient, sampled labels "
        f"equal: {same} ({fg} fg); loss {m_k['loss']:.6f} vs "
        f"{m_p['loss']:.6f}; worst relative loss diff "
        f"{max(loss_err.values()):.2e} (rtol 1e-4); worst gradient rel. L2 "
        f"{grad_err[worst]:.2e} at {worst} (tol 1e-3)")
    if not same:
        raise AssertionError(f"{label}: sampled labels differ between the "
                             f"kernel and plain paths")
    if g_k.keys() != g_p.keys() or max(loss_err.values()) > 1e-4 or \
            grad_err[worst] > 1e-3:
        raise AssertionError(f"{label}: losses or gradients differ between "
                             f"the kernel and plain paths")
    return dict(metrics_kernels=m_k, metrics_plain=m_p,
                loss_rel_err=loss_err, worst_grad_rel_l2=grad_err[worst],
                worst_grad_tensor=worst, num_fg=fg)


def phase_train_parity(dev) -> dict:
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train

    cfg = generate_config("resnet101", "PascalVOC",
                          network__compute_dtype="float32")
    state = train.setup_training(cfg, dev, seed=1)
    batch = train.to_device(synthetic_train_batches(cfg, 2, 1)[0], dev)
    return step_parity("train step fp32 608x1024 batch 2", state.model,
                       train.loss_and_metrics, batch, cfg, dev,
                       "proposal_target")


# ---- phase 8: training, the second main path -------------------------------

def train_stage_times(state, step, batch, iters: int, warmup: int = 1
                      ) -> dict:
    """Per-stage times of one train step from CUDA events recorded as each
    stage ends (the device timeline, gaps included)."""
    import torch

    from mx_rcnn_tpu_torch.core.train import STAGES

    sums = dict.fromkeys(STAGES, 0.0)
    for it in range(warmup + iters):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        step(state, batch, stage_hook=mark)
        torch.cuda.synchronize()
        if it >= warmup:
            for name, a, b in zip(STAGES, events, events[1:]):
                sums[name] += a.elapsed_time(b)
    return {k: v / iters for k, v in sums.items()}


def phase_training(dev, card: str) -> dict:
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.tools import train as train_cli

    cfg = generate_config("resnet101", "PascalVOC")     # bf16 by default
    if cfg.network.compute_dtype != "bfloat16":
        raise AssertionError("the flagship preset must train in bf16")
    argv = ["--network", "resnet101", "--dataset", "PascalVOC",
            "--synthetic", "8", "--steps", str(TRAIN_STEPS), "--frequent",
            "1", "--seed", "0"]
    runs = {}
    for batch in (1, 2):
        out = OUT_DIR / f"train_b{batch}.txt"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            final = train_cli.main(argv + ["--batch_images", str(batch)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fp_launches()
        if not all(n > 0 for n in launches.values()) or \
                not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"training batch {batch}: launches "
                                 f"{launches}, final metrics {final}")
        log(f"train CLI batch {batch}: {TRAIN_STEPS} steps in {wall:.2f} s "
            f"(model build and data included), launches {launches}, "
            f"final loss {final['loss']:.4f}")
        runs[batch] = dict(cli_wall_s=wall, launches=launches,
                           launches_per_step={k: v / TRAIN_STEPS for k, v in
                                              launches.items()},
                           final_metrics=final)

    for batch in (1, 2):
        torch.cuda.reset_peak_memory_stats()
        state = train.setup_training(cfg, dev, seed=0)
        step = train.make_train_step(cfg)
        batches = [train.to_device(b, dev)
                   for b in synthetic_train_batches(cfg, batch, 4)]
        for b in batches[:2]:                               # warm-up
            step(state, b)
        torch.cuda.synchronize()
        iters, losses = 8, []
        t0 = time.perf_counter()
        for i in range(iters):
            losses.append(step(state, batches[i % len(batches)])["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        losses = [float(v) for v in losses]
        stage = train_stage_times(state, step, batches[0], 5)
        busy = device_profile(lambda: step(state, batches[0]), 3)
        busy["busy_share"] = busy_share(busy, ms)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"training batch {batch}: losses {losses}")
        runs[batch].update(ms_per_step=ms, images_per_s=batch * 1e3 / ms,
                           stage_ms=stage, device=busy, peak_mem_gib=peak,
                           losses=losses)
        log(f"training bf16 batch {batch} on {card}: {ms:.2f} ms/step, "
            f"{batch * 1e3 / ms:.2f} img/s, device busy "
            f"{busy['device_ms_per_iter']:.3f} ms/step (share "
            f"{busy['busy_share'] or 'not measured'}, "
            f"{busy['kernels_per_iter']:.0f} device ops), peak "
            f"{peak:.2f} GiB, losses " + ", ".join(f"{v:.4g}" for v in losses))
        log(f"training bf16 batch {batch} stages (ms) "
            + json.dumps({k: round(v, 3) for k, v in stage.items()}))
        ours = busy["kernel_ms_per_iter"]
        log(f"training bf16 batch {batch}, per step: K1 on the step's "
            f"proposals, mask pass {ours['k1_mask']:.4f} ms, reduction "
            f"{ours['k1_reduce']:.4f} ms; K2 {ours['k2']:.4f} ms; K3 "
            f"{ours['k3']:.4f} ms (tables pass {ours['k3_tables']:.4f} ms)")
    return runs


# ---- phase 9: checkpoints and eval, the third main path --------------------

def _same_bits(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def checkpoint_round_trip(dev, work: Path) -> dict:
    """A ResNet-101 train state with a random bf16 trace and count 3
    through save_checkpoint, load_param and restore_state into a state
    built from another seed: every tensor bit-equal."""
    import importlib.util
    import os

    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.utils.bridge import to_flax
    from mx_rcnn_tpu_torch.utils.checkpoint import (config_fingerprint,
                                                    load_param,
                                                    restore_state,
                                                    save_checkpoint)

    # importlib only looks: the port never imports msgpack
    has_msgpack = importlib.util.find_spec("msgpack") is not None
    cfg = generate_config("resnet101", "PascalVOC")
    state = train.setup_training(cfg, dev, seed=7)
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        for t in state.optimizer.trace.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    state.optimizer.count = 3
    prefix = str(work / "roundtrip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(prefix, 1, state, steps_per_epoch=4,
                           config_fp=config_fingerprint(cfg))
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    params, stats = load_param(prefix, 1)
    other = train.setup_training(cfg, dev, seed=9)
    t1 = time.perf_counter()
    restore_state(other, prefix, 1)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t1
    load_param_s = t1 - t0
    want, got = state.model.state_dict(), other.model.state_dict()
    bad = [k for k in want if not _same_bits(want[k], got[k])]
    bad += [f"trace {k}" for k, t in state.optimizer.trace.items()
            if not _same_bits(t, other.optimizer.trace[k])]
    flat = to_flax(want)
    bad += [k for k in ("params", "batch_stats")
            if sorted(_flax_paths(flat[k])) != sorted(_flax_paths(
                params if k == "params" else stats))]
    if other.step != 3 or other.optimizer.count != 3:
        bad.append(f"step {other.step}")
    log(f"checkpoint round trip, ResNet-101 with a bf16 trace: {size} "
        f"bytes, write {write_s:.3f} s (save_checkpoint: device to host, "
        f"msgpack, fsync, manifest), read {read_s:.3f} s (restore_state: "
        f"sha256, msgpack, host to device), load_param {load_param_s:.3f} s "
        f"(with a model build); {len(want)} tensors and "
        f"{len(state.optimizer.trace)} traces, mismatches {len(bad)}; the "
        f"msgpack package is {'present' if has_msgpack else 'absent'} on "
        f"this machine (the port's own codec is used either way)")
    if bad:
        raise AssertionError(f"checkpoint round trip differs: {bad[:5]}")
    return dict(bytes=size, write_s=write_s, read_s=read_s,
                load_param_s=load_param_s, tensors=len(want),
                traces=len(state.optimizer.trace), msgpack_present=has_msgpack,
                prefix=prefix)


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,))


def compare_dets(work: Path):
    """The saved detections of the ``kernels`` and ``plain`` runs:
    (class, image) cells whose counts differ, max |box diff|, max |score
    diff| and the number of detections."""
    import pickle

    import numpy as np

    dets = {}
    for tag in ("kernels", "plain"):
        with open(work / f"{tag}.pkl", "rb") as f:
            dets[tag] = pickle.load(f)["all_boxes"]
    count_diff, box_err, score_err, total = 0, 0.0, 0.0, 0
    for ck, cp in zip(dets["kernels"], dets["plain"]):
        for a, b in zip(ck, cp):
            if a.shape != b.shape:
                count_diff += 1
                continue
            total += len(a)
            if len(a):
                box_err = max(box_err, float(np.abs(a[:, :4] - b[:, :4]).max()))
                score_err = max(score_err, float(np.abs(a[:, 4] - b[:, 4]).max()))
    return count_diff, box_err, score_err, total


def eval_parity(dev, prefix: str, work: Path) -> dict:
    """pred_eval in fp32 (TF32 off) from the round-trip checkpoint over 8
    synthetic 375x500 images at batch 2, through K1/K2 and through their
    plain versions: equal counts per (class, image), boxes within 1e-2
    px and scores within 1e-4 (K2 and the einsum pair sum in other
    orders: phase 5's cls_prob tolerance), equal APs."""
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader
    from mx_rcnn_tpu_torch.utils.checkpoint import load_model

    cfg = generate_config("resnet101", "PascalVOC",
                          network__compute_dtype="float32",
                          test__batch_images=2)
    predictor = Predictor(load_model(cfg, prefix, 1, dev), cfg, dev)
    imdb, roidb = load_gt_roidb(cfg, training=False, synthetic=8)

    def run(tag):
        return pred_eval(predictor, TestLoader(roidb, cfg, imdb.load_image),
                         imdb, cfg, verbose=False,
                         save_dets=str(work / f"{tag}.pkl"))

    kernels.reset_launch_counts()
    res_k = run("kernels")
    launches = fp_launches()
    with plain_versions():
        res_p = run("plain")
    count_diff, box_err, score_err, total = compare_dets(work)
    log(f"eval fp32 608x1024, 8 images at batch 2: {total} detections; "
        f"(class, image) count mismatches {count_diff}, max|box diff| "
        f"{box_err:.3e} px (tol 1e-2), max|score diff| {score_err:.3e} "
        f"(tol 1e-4); mAP kernels {res_k['mAP']:.6f} plain "
        f"{res_p['mAP']:.6f}; launches through the kernels {launches}")
    if count_diff or box_err > 1e-2 or score_err > 1e-4 or res_k != res_p \
            or total == 0:
        raise AssertionError("the fp32 eval differs between the kernel and "
                             "plain paths")
    if launches != {"nms_sweep": 8, "roi_align_fwd": 4, "roi_align_bwd": 0}:
        raise AssertionError(f"fp32 eval launches {launches}, expected K1 2 "
                             f"and K2 1 per batch of the 4")
    return dict(detections=total, count_mismatches=count_diff,
                max_box_diff_px=box_err, max_score_diff=score_err,
                map_kernels=res_k["mAP"], map_plain=res_p["mAP"],
                aps_kernels=res_k, launches=launches)


def steady_eval(run, images: int, batches: int, label: str,
                k1_launches: int) -> dict:
    """An eval loop ``run()`` timed warm: once to warm up, once under the
    host clock, once under the profiler (device time per image, busy
    share, K1's and K2's time per eval batch)."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = device_profile(run, 1)
    ours = prof["kernel_ms_per_iter"]
    busy = busy_share(prof, wall * 1e3)
    hand = sum(ours[k] for k in ("k1_mask", "k1_reduce", "k2", "k3", "k4",
                                 "k5_k6"))
    steady = dict(images_per_s=images / wall,
                  wall_ms_per_image=wall * 1e3 / images,
                  device_ms_per_image=prof["device_ms_per_iter"] / images,
                  busy_share=busy,
                  k1_mask_ms_per_batch=ours["k1_mask"] / batches,
                  k1_reduce_ms_per_batch=ours["k1_reduce"] / batches,
                  k2_ms_per_batch=ours["k2"] / batches,
                  k4_ms_per_batch=ours["k4"] / batches,
                  k5_k6_ms_per_batch=ours["k5_k6"] / batches,
                  # everything but K1-K6: cuDNN, the elementwise work,
                  # copies; and the elementwise work alone
                  other_ms_per_batch=(prof["device_ms_per_iter"] - hand)
                  / batches,
                  elementwise_ms_per_batch=prof["elementwise_ms_per_iter"]
                  / batches,
                  device_ops_per_image=prof["kernels_per_iter"] / images,
                  device_ops_per_batch=prof["kernels_per_iter"] / batches,
                  top=prof["top"][:8])
    log(f"{label}, {images} images at batch {images // batches}, steady: "
        f"{steady['images_per_s']:.2f} images/s (host rendering and resize "
        f"included), device {steady['device_ms_per_image']:.3f} ms per "
        f"image (profiler, busy share {busy or 'not measured'}); per eval "
        f"batch K1 {steady['k1_mask_ms_per_batch']:.4f} + "
        f"{steady['k1_reduce_ms_per_batch']:.4f} ms (mask pass + "
        f"reduction, {k1_launches} launches), K2 "
        f"{steady['k2_ms_per_batch']:.4f} ms")
    return steady


def _train_cli(argv, out: Path):
    from mx_rcnn_tpu_torch.tools import train as train_cli

    with open(out, "w") as f, contextlib.redirect_stdout(f):
        return train_cli.main(argv)


def _sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def eval_cli(dev, work: Path, card: str) -> dict:
    """The bf16 loop through the command lines: train one epoch with a
    checkpoint, score it with tools/test.py (launch counts zeroed just
    before, read just after), then time the eval path in-process."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader
    from mx_rcnn_tpu_torch.tools import test as test_cli
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    load_model,
                                                    read_manifest)

    prefix = str(work / "e2e")
    # 4 images and their flipped copies: 4 steps an epoch at batch 2
    base = ["--network", "resnet101", "--dataset", "PascalVOC", "--synthetic",
            "4", "--batch_images", "2", "--seed", "0", "--frequent", "1"]
    t0 = time.perf_counter()
    final = _train_cli(base + ["--prefix", prefix, "--end_epoch", "1"],
                       OUT_DIR / "eval_train.txt")
    train_s = time.perf_counter() - t0
    manifest = read_manifest(checkpoint_path(prefix, 1))
    if manifest is None or manifest["step"] != 4 or \
            not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"train CLI: manifest {manifest}, final {final}")
    log(f"train CLI, 1 epoch of 4 steps at batch 2 with a checkpoint: "
        f"{train_s:.2f} s, final loss {final['loss']:.4f}, wrote "
        f"{checkpoint_path(prefix, 1)} (step {manifest['step']})")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with open(OUT_DIR / "eval_test.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        results = test_cli.main([
            "--network", "resnet101", "--dataset", "PascalVOC", "--prefix",
            prefix, "--epoch", "1", "--synthetic", "16",
            "--set", "test__batch_images=2"])
    torch.cuda.synchronize()
    launches = fp_launches()
    text = (OUT_DIR / "eval_test.txt").read_text()
    rate = re.search(r"pred_eval: 16 images in ([0-9.]+) s, ([0-9.]+) "
                     r"images/s", text)
    batches = 8
    log(f"test CLI, 16 images at batch 2 ({batches} batches): mAP "
        f"{results['mAP']:.4f} (random weights: printed, not gated), "
        f"pred_eval {rate.group(2) if rate else '?'} images/s (first call, "
        f"host rendering and resize included); launches {launches}")
    if launches != {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
                    "roi_align_bwd": 0}:
        raise AssertionError(f"the eval path's launches are wrong: "
                             f"{launches}")

    # the same path timed in-process
    cfg = generate_config("resnet101", "PascalVOC", test__batch_images=2)
    predictor = Predictor(load_model(cfg, prefix, 1, dev), cfg, dev)
    imdb, roidb = load_gt_roidb(cfg, training=False, synthetic=16)
    steady = steady_eval(
        lambda: pred_eval(predictor, TestLoader(roidb, cfg, imdb.load_image),
                          imdb, cfg, verbose=False),
        16, batches, f"eval bf16 on {card}", k1_launches=2)
    return dict(prefix=prefix, base=base, train_s=train_s,
                final_metrics=final, results=results, launches=launches,
                cli_images_per_s=float(rate.group(2)) if rate else None,
                steady=steady)


def resume_check(prefix: str, base, tag: str = "eval") -> dict:
    """One more epoch with --resume after --end_epoch 1 against two
    epochs without a break: the epoch-2 checkpoints must be equal byte
    for byte (weights, trace, count; the epoch-1 files too, which says
    whether the card repeats a run at all)."""
    from mx_rcnn_tpu_torch.utils.checkpoint import checkpoint_path

    t0 = time.perf_counter()
    _train_cli(base + ["--prefix", prefix, "--end_epoch", "2", "--resume"],
               OUT_DIR / f"{tag}_resume.txt")
    straight = prefix + "_straight"
    _train_cli(base + ["--prefix", straight, "--end_epoch", "2"],
               OUT_DIR / f"{tag}_straight.txt")
    wall = time.perf_counter() - t0
    digests = {f"{kind} epoch {e}": _sha256(checkpoint_path(p, e))
               for kind, p in (("resumed", prefix), ("straight", straight))
               for e in (1, 2)}
    same1 = digests["resumed epoch 1"] == digests["straight epoch 1"]
    same2 = digests["resumed epoch 2"] == digests["straight epoch 2"]
    log(f"resume ({tag}): epoch 2 after --resume equals two epochs "
        f"straight: {same2} (epoch 1 files equal: {same1}); {wall:.1f} s "
        f"for both runs")
    if not (same1 and same2):
        raise AssertionError(f"resume is not bit-exact: {digests}")
    return dict(equal_epoch1=same1, equal_epoch2=same2, wall_s=wall,
                digests=digests)


def phase_eval(dev, card: str) -> dict:
    """Phase 9, with cuDNN's deterministic algorithms so that two runs of
    one training give equal bits."""
    import torch

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    WORK_DIR.mkdir(parents=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        rt = checkpoint_round_trip(dev, WORK_DIR)
        parity = eval_parity(dev, rt.pop("prefix"), WORK_DIR)
        loop = eval_cli(dev, WORK_DIR, card)
        resume = resume_check(loop["prefix"], loop["base"])
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    return dict(round_trip=rt, fp32_parity=parity, loop=loop, resume=resume)


# ---- phase 10: VGG16 and the alternate schedule, the fourth main path -----

VGG_BINS = (7, 7)          # the vgg preset's rcnn_pooled_size
VGG_C = 512                # conv5_3's channels
SCHEDULE_IMAGES = 8        # synthetic 375x500 images: 16 records with flips
DUMP_PRE_NMS = 20000       # test__proposal_pre_nms_top_n
DUMP_POST_NMS = 2000       # test__proposal_post_nms_top_n
MIN_PROPOSALS = 100        # a dump's least mean proposals per image
# the schedule's stage learning rate: from a seeded init, without
# ImageNet weights, the reference's 0.001 makes the RCNN stages diverge
# (losses to ~1e7 in 8 steps, rpn2 left with one proposal per image)
SCHEDULE_LR = "1e-4"
ALT_DIR = REPO / "_chip" / "alternate"   # the schedule's checkpoints


def phase_vgg_kernels(dev) -> dict:
    """K1 at the proposal dumps' shape (pre-NMS 20000, B=1 as the dumps
    run and B=2 as ``test_rpn`` at batch 2 runs), against the plain sweep
    and timed; K2 and K3 at VGG16's shapes (38x64x512 features, 7x7
    bins): K2 at 2x128 rois (the RCNN stages' sampled rois), 2x300 (the
    combined model's eval) and 2x2000 (``test_rcnn``: ROITestLoader pads
    to test__proposal_post_nms_top_n slots), K3 at 2x128, each against
    its plain version in fp32 and bf16 (K3 bit-equal over two launches),
    then timed."""
    import torch

    hw = (BUCKET[0] // 16, BUCKET[1] // 16)
    res = {}
    for b, seed in ((1, 64), (2, 65)):
        label = f"proposal dump B={b}"
        boxes, _, alive, _, t = nms_inputs(b, DUMP_PRE_NMS, seed, dev)
        check_k1(label, boxes, alive, t)
        res[f"k1_dump_b{b}"] = time_k1(label, boxes, alive, t, 0.7)
    for name, r, seed in (("rcnn", TRAIN_ROIS, 60), ("eval", 300, 61),
                          ("test_rcnn", DUMP_POST_NMS, 66)):
        label = f"VGG {name}"
        feat, rois = roi_inputs(2, r, seed, dev, c=VGG_C)
        err32, err16 = check_k2(label, feat, rois, size=VGG_BINS)
        res[f"k2_{name}"] = {
            tag: time_k2(label, f, rois, err, size=VGG_BINS)
            for tag, f, err in (("bf16", feat.to(torch.bfloat16), err16),
                                ("fp32", feat, err32))}
    _, rois = roi_inputs(2, TRAIN_ROIS, 62, dev, c=VGG_C)
    g = k3_grad(2, TRAIN_ROIS, 63, dev, c=VGG_C, size=VGG_BINS)
    err32, err16 = check_k3("VGG rcnn", g, rois, hw)
    res["k3_rcnn"] = {tag: time_k3("VGG rcnn", gg, rois, hw, err)
                      for tag, gg, err in (("bf16", g.to(torch.bfloat16),
                                            err16), ("fp32", g, err32))}
    return res


def jittered_proposals(roidb, seed: int, k: int = 300):
    """Score-sorted raw-coordinate (k, 5) proposals per record: 8
    jittered copies of each gt box (foreground for the sampler) and
    random boxes of 16-300 px a side, clipped to the image."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for rec in roidb:
        gt = (rec["boxes"][None] + rng.uniform(-8, 8, (8,) + rec["boxes"]
                                               .shape)).reshape(-1, 4)
        m = k - len(gt)
        xy = rng.uniform(0, [rec["width"] - 16, rec["height"] - 16], (m, 2))
        boxes = np.concatenate(
            [gt, np.concatenate([xy, xy + rng.uniform(16, 300, (m, 2))], 1)])
        boxes = np.clip(boxes, 0, [rec["width"] - 1, rec["height"] - 1] * 2)
        scores = np.sort(rng.uniform(size=k))[::-1, None]
        out.append(np.hstack([boxes, scores]).astype(np.float32))
    return out


def phase_vgg_parity(dev, work: Path) -> dict:
    """fp32 (TF32 off) through the kernels and through the plain versions,
    from one set of weights and draws: the VGG16 test forward, the ``rpn``
    and ``rcnn`` steps (dropout uniforms included), and
    ``test_rcnn_stage`` over 8 synthetic images at batch 2."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.tools.test_rcnn import test_rcnn_stage
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    forward = phase_forward_parity(dev, "vgg")
    cfg = generate_config("vgg", "PascalVOC",
                          network__compute_dtype="float32",
                          test__batch_images=2)
    model = train.setup_training(cfg, dev, seed=1).model
    rpn = step_parity(
        "VGG rpn step fp32 608x1024 batch 2", model,
        train.loss_and_metrics_rpn,
        train.to_device(synthetic_train_batches(cfg, 2, 1)[0], dev), cfg,
        dev, "anchor_target")
    rcnn_batch = synthetic_train_batches(
        cfg, 2, 1, proposals=lambda roidb: jittered_proposals(roidb, 7))[0]
    rcnn = step_parity(
        "VGG rcnn step fp32 608x1024 batch 2, 2000 proposal slots", model,
        train.loss_and_metrics_rcnn, train.to_device(rcnn_batch, dev), cfg,
        dev, "proposal_target")

    prefix = str(work / "vgg_fp32")
    save_params(prefix, 1, model.state_dict())
    _, roidb = load_gt_roidb(cfg, training=False, synthetic=8)
    props = jittered_proposals(roidb, 8)

    def run(tag):
        with open(OUT_DIR / f"vgg_test_rcnn_{tag}.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            return test_rcnn_stage(cfg, prefix=prefix, epoch=1,
                                   proposals=props, verbose=False,
                                   synthetic=8, device=dev,
                                   save_dets=str(work / f"{tag}.pkl"))

    torch.backends.cudnn.deterministic = True
    kernels.reset_launch_counts()
    res_k = run("kernels")
    launches = fp_launches()
    with plain_versions():
        res_p = run("plain")
    torch.backends.cudnn.deterministic = False
    count_diff, box_err, score_err, total = compare_dets(work)
    log(f"test_rcnn_stage fp32 VGG16, 8 images at batch 2 on 300 "
        f"proposals each: {total} detections; (class, image) count "
        f"mismatches {count_diff}, max|box diff| {box_err:.3e} px (tol "
        f"1e-2), max|score diff| {score_err:.3e} (tol 1e-4); mAP kernels "
        f"{res_k['mAP']:.6f} plain {res_p['mAP']:.6f}; launches through "
        f"the kernels {launches}")
    if count_diff or box_err > 1e-2 or score_err > 1e-4 or res_k != res_p \
            or total == 0:
        raise AssertionError("test_rcnn_stage differs between the kernel and "
                             "plain paths")
    # no RPN: K1 only in the postprocess, K2 once per batch
    if launches != {"nms_sweep": 4, "roi_align_fwd": 4, "roi_align_bwd": 0}:
        raise AssertionError(f"test_rcnn_stage launches {launches}, "
                             f"expected K1 1 and K2 1 per batch of the 4")
    return dict(forward=forward, rpn_step=rpn, rcnn_step=rcnn,
                test_rcnn_stage=dict(
                    detections=total, count_mismatches=count_diff,
                    max_box_diff_px=box_err, max_score_diff=score_err,
                    map_kernels=res_k["mAP"], map_plain=res_p["mAP"],
                    launches=launches))


@contextlib.contextmanager
def instrumented_stages(stages: list, writes: list):
    """Record, for each ``train_net`` and proposal dump that the
    alternate schedule (or the training CLI) runs: its wall time, peak
    device memory and launches of each kernel; for a training stage also
    each step's wall time (synchronised) and the device time of its
    second step (profiler); and each checkpoint's size and write time."""
    import os

    import torch

    import mx_rcnn_tpu_torch.core.fit as fit_mod
    import mx_rcnn_tpu_torch.ft.snapshot as snapshot_mod
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import train as train_cli
    from mx_rcnn_tpu_torch.tools import train_alternate
    from mx_rcnn_tpu_torch.utils.checkpoint import checkpoint_path

    saved = dict(train_net=train_cli.train_net,
                 make_train_step=train_cli.make_train_step,
                 make_snapshotter=fit_mod.make_snapshotter,
                 write_job=snapshot_mod._write_job,
                 save_params=train_alternate.save_params,
                 dump_proposals=train_alternate.dump_proposals)

    def stage(kind, fn, name_of):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = dict(kind=kind, name=os.path.basename(name_of(args, kw)),
                       mode=kw.get("mode"), step_ms=[])
            stages.append(rec)
            before = fp_launches()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec.update(wall_s=time.perf_counter() - t0,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       launches={k: v - before[k] for k, v in
                                 fp_launches().items()})
            if kind == "train":
                rec["final_metrics"] = out[1]
            else:
                rec["mean_proposals"] = mean_proposals(out)
            return out
        return wrapper

    def timed_make_train_step(cfg, mode="e2e", grad_accum=1, world=None):
        step = saved["make_train_step"](cfg, mode, grad_accum, world)
        rec = stages[-1]

        def timed(state, batch, draws=None, stage_hook=None):
            torch.cuda.synchronize()
            if len(rec["step_ms"]) == 1 and "device_ms" not in rec:
                out = []
                prof = device_profile(
                    lambda: out.append(step(state, batch, draws, stage_hook)),
                    1)
                rec.update(device_ms=prof["device_ms_per_iter"],
                           device_ops=prof["kernels_per_iter"],
                           kernel_ms=prof["kernel_ms_per_iter"],
                           top=prof["top"][:8])
                return out[0]
            t0 = time.perf_counter()
            out = step(state, batch, draws, stage_hook)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def timed_write(fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = fn(*args, **kw)
            writes.append(dict(file=os.path.basename(path),
                               bytes=os.path.getsize(path),
                               write_s=time.perf_counter() - t0))
            return path
        return wrapper

    # an epoch checkpoint through fit's snapshotter: the step thread's
    # stall (host copy and handoff), the writer's time from the handoff
    # to the manifest commit, and the wait for it when fit closes
    def timed_write_job(job, prefix):
        path = saved["write_job"](job, prefix)
        rec = next((w for w in writes if "_t0" in w
                    and w["file"] == os.path.basename(path)), None)
        if rec is not None:
            rec.update(bytes=os.path.getsize(path),
                       write_s=time.perf_counter() - rec.pop("_t0"))
        return path

    def timed_snapshotter(*args, **kw):
        snap = saved["make_snapshotter"](*args, **kw)
        save_epoch, close = snap.save_epoch, snap.close

        def timed_save(epoch, state):
            torch.cuda.synchronize()
            rec = dict(file=os.path.basename(
                checkpoint_path(snap.prefix, epoch)), _t0=time.perf_counter())
            writes.append(rec)
            path = save_epoch(epoch, state)
            rec["stall_s"] = time.perf_counter() - rec["_t0"]
            return path

        def timed_close():
            t0 = time.perf_counter()
            close()
            if writes:
                writes[-1]["close_wait_s"] = time.perf_counter() - t0

        snap.save_epoch, snap.close = timed_save, timed_close
        return snap

    train_cli.train_net = stage("train", saved["train_net"],
                                lambda a, kw: kw.get("prefix") or "steps")
    train_alternate.train_net = train_cli.train_net
    train_alternate.dump_proposals = stage(
        "dump", saved["dump_proposals"], lambda a, kw: a[5])
    train_cli.make_train_step = timed_make_train_step
    fit_mod.make_snapshotter = timed_snapshotter
    snapshot_mod._write_job = timed_write_job
    train_alternate.save_params = timed_write(saved["save_params"])
    try:
        yield
    finally:
        train_cli.train_net = saved["train_net"]
        train_alternate.train_net = saved["train_net"]
        train_alternate.dump_proposals = saved["dump_proposals"]
        train_cli.make_train_step = saved["make_train_step"]
        fit_mod.make_snapshotter = saved["make_snapshotter"]
        snapshot_mod._write_job = saved["write_job"]
        train_alternate.save_params = saved["save_params"]


def mean_proposals(props) -> float:
    """A proposal dump's mean proposals per image."""
    return sum(len(p) for p in props) / len(props)


def check_dump(label: str, mean: float) -> None:
    """A dump's mean proposals per image must reach MIN_PROPOSALS: fewer
    means the RPN that made it has collapsed."""
    if not mean >= MIN_PROPOSALS:
        raise AssertionError(f"{label}: {mean:.1f} proposals per image, "
                             f"fewer than {MIN_PROPOSALS}")


def summarise_stage(rec: dict) -> dict:
    """A stage record's steady ms/step (its steps after the first, the
    profiled second apart), device time per step and busy share."""
    steady = rec["step_ms"][1:] or rec["step_ms"]
    if steady:
        rec["ms_per_step"] = sum(steady) / len(steady)
        rec["steps"] = len(rec["step_ms"]) + ("device_ms" in rec)
    if "device_ms" in rec and steady:
        rec["busy_share"] = (rec["device_ms"] / rec["ms_per_step"]
                             if rec["device_ms"] > 0 else None)
    return rec


def stage_line(rec: dict, card: str) -> str:
    text = (f"{rec['kind']} {rec['name']} ({rec['mode'] or 'proposals'}) on "
            f"{card}: {rec['wall_s']:.2f} s, peak {rec['peak_mem_gib']:.2f} "
            f"GiB, launches {rec['launches']}")
    if "mean_proposals" in rec:
        text += f", {rec['mean_proposals']:.1f} proposals per image"
    if "ms_per_step" in rec:
        text += (f"; {rec['steps']} steps, {rec['ms_per_step']:.2f} ms/step "
                 f"(synchronised, after the first)")
    if "device_ms" in rec:
        text += (f", device {rec['device_ms']:.3f} ms/step (profiler, "
                 f"{rec['device_ops']:.0f} device ops), busy share "
                 f"{rec.get('busy_share') or 'not measured'}")
    return text


def run_schedule(dev, card: str) -> dict:
    """``tools/train_alternate.py``'s main in bf16 at full width on
    SCHEDULE_IMAGES images and their flips, batch 2, one epoch a stage,
    with every launch count zeroed just before and read just after; each
    stage's and dump's record, the checkpoints' sizes and write times,
    and the frozen-shared-conv invariants."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import train_alternate
    from mx_rcnn_tpu_torch.utils.checkpoint import load_state_dict

    prefix = str(ALT_DIR / "alt")
    argv = ["--network", "vgg", "--dataset", "PascalVOC", "--synthetic",
            str(SCHEDULE_IMAGES), "--batch_images", "2", "--rpn_epoch", "1",
            "--rcnn_epoch", "1", "--rpn_lr", SCHEDULE_LR, "--rcnn_lr",
            SCHEDULE_LR, "--frequent", "1", "--seed", "0", "--prefix", prefix]
    stages, writes = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with instrumented_stages(stages, writes), \
            open(OUT_DIR / "alternate.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        final = train_alternate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fp_launches()
    log(f"alternate schedule, VGG16 bf16 608x1024, {SCHEDULE_IMAGES} images "
        f"and their flips at batch 2, one epoch a stage: {wall:.1f} s, "
        f"launches {launches}")
    for rec in stages:
        log("  " + stage_line(summarise_stage(rec), card))
    for w in writes:
        log(f"  checkpoint {w['file']}: {w['bytes']} bytes, written in "
            f"{w['write_s']:.3f} s" + (
                f" on the writer thread; the step thread stalled "
                f"{w['stall_s']:.3f} s and waited {w['close_wait_s']:.3f} s "
                f"at the stage's end" if "stall_s" in w else ""))
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the schedule never launched: "
                             f"{launches}")
    steps = 2 * SCHEDULE_IMAGES // 2
    zero = {"nms_sweep": 0, "roi_align_fwd": 0, "roi_align_bwd": 0}
    # stage 2 trains conv3-5, so the features need K3; in stage 4 every
    # conv is frozen and autograd never asks for the features' gradient
    want = [zero, dict(zero, nms_sweep=2 * SCHEDULE_IMAGES),
            dict(zero, roi_align_fwd=steps, roi_align_bwd=steps), zero,
            dict(zero, nms_sweep=2 * SCHEDULE_IMAGES),
            dict(zero, roi_align_fwd=steps)]
    got = [rec["launches"] for rec in stages]
    if got != want:
        raise AssertionError(f"per-stage launches {got}, expected {want}")
    losses = [rec["final_metrics"]["loss"] for rec in stages
              if rec["kind"] == "train"]
    if len(writes) != 5 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"checkpoints written {writes}, final losses "
                             f"{losses}")
    for rec in stages:
        if rec["kind"] == "dump":
            check_dump(rec["name"], rec["mean_proposals"])

    rcnn1, rpn2, rcnn2 = (load_state_dict(f"{prefix}-{s}", 1)
                          for s in ("rcnn1", "rpn2", "rcnn2"))
    backbone = [k for k in rcnn1 if k.startswith("backbone.")]
    frozen = all(torch.equal(rcnn1[k], rpn2[k]) and torch.equal(rpn2[k],
                                                                rcnn2[k])
                 for k in backbone)
    rpn_moved = any(not torch.equal(rcnn1[k], rpn2[k]) for k in rcnn1
                    if k.startswith("rpn."))
    head_moved = any(not torch.equal(rpn2[k], rcnn2[k]) for k in rpn2
                     if k.startswith("head."))
    log(f"  shared convs ({len(backbone)} tensors) bit-identical across "
        f"stages 3 and 4: {frozen}; stage 3 moved the RPN: {rpn_moved}; "
        f"stage 4 moved the head: {head_moved}")
    if not (frozen and rpn_moved and head_moved):
        raise AssertionError("the frozen-shared-conv invariants fail")
    return dict(final=final, wall_s=wall, launches=launches, stages=stages,
                checkpoints=writes, shared_convs_bit_identical=frozen)


def schedule_evals(dev, final: str, card: str) -> dict:
    """Both evals of the schedule's models in bf16 over 16 synthetic
    images at batch 2, launches zeroed just before each command line and
    read just after, then each path timed warm: the combined model
    through ``tools/test.py`` (K1 twice and K2 once a batch), and rcnn2
    on rpn2's proposals over the test roidb through ``tools/test_rpn.py
    --eval_set`` and ``tools/test_rcnn.py`` (K2 once and K1 once, in the
    postprocess, a batch)."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import ROITestLoader, TestLoader
    from mx_rcnn_tpu_torch.tools import test as test_cli
    from mx_rcnn_tpu_torch.tools import test_rcnn, test_rpn
    from mx_rcnn_tpu_torch.utils.checkpoint import load_model

    images, batches = 16, 8
    common = ["--network", "vgg", "--dataset", "PascalVOC", "--synthetic",
              str(images), "--set", "test__batch_images=2"]
    stage_prefix = final[:-len("-final")]
    eval_pkl = str(ALT_DIR / "rpn2-test-proposals.pkl")
    res = {}

    def cli(name, main, argv, want):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with open(OUT_DIR / f"alternate_{name}.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            out = main(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fp_launches()
        log(f"{name} CLI, VGG16 bf16, {images} images at batch 2: "
            f"{wall:.2f} s (first call), launches {launches}")
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        res[name] = dict(wall_s=wall, launches=launches)
        return out

    results = cli("test", test_cli.main, ["--prefix", final, "--epoch", "1"],
                  {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
                   "roi_align_bwd": 0})
    eval_props = cli("test_rpn", test_rpn.main,
                     ["--prefix", f"{stage_prefix}-rpn2", "--epoch", "1",
                      "--out", eval_pkl, "--eval_set"],
                     {"nms_sweep": batches, "roi_align_fwd": 0,
                      "roi_align_bwd": 0})
    res["test_rpn"]["mean_proposals"] = mean_proposals(eval_props)
    check_dump("test_rpn --eval_set", res["test_rpn"]["mean_proposals"])
    stage_results = cli("test_rcnn", test_rcnn.main,
                        ["--prefix", f"{stage_prefix}-rcnn2", "--epoch", "1",
                         "--proposals", eval_pkl],
                        {"nms_sweep": batches, "roi_align_fwd": batches,
                         "roi_align_bwd": 0})
    res["test"]["results"] = results
    res["test_rcnn"]["results"] = stage_results

    cfg = generate_config("vgg", "PascalVOC", test__batch_images=2)
    imdb, roidb = load_gt_roidb(cfg, training=False, synthetic=images)
    combined = Predictor(load_model(cfg, final, 1, dev), cfg, dev)
    res["test"]["steady"] = steady_eval(
        lambda: pred_eval(combined, TestLoader(roidb, cfg, imdb.load_image),
                          imdb, cfg, verbose=False),
        images, batches, f"eval of the combined VGG16 bf16 on {card}",
        k1_launches=2)
    rcnn2 = Predictor(load_model(cfg, f"{stage_prefix}-rcnn2", 1, dev), cfg,
                      dev)
    res["test_rcnn"]["steady"] = steady_eval(
        lambda: pred_eval(rcnn2, ROITestLoader(roidb, cfg, imdb.load_image,
                                               eval_props),
                          imdb, cfg, verbose=False),
        images, batches, f"test_rcnn_stage of rcnn2 VGG16 bf16 on {card} "
        f"(K2 at 2x{DUMP_POST_NMS} slots, "
        f"{res['test_rpn']['mean_proposals']:.1f} proposals per image)",
        k1_launches=1)
    return res


def vgg_e2e_cli(card: str) -> dict:
    """A few end-to-end VGG16 steps in bf16 through ``tools/train.py
    --network vgg`` (the reference's config 1), with K1, K2 and K3 each
    launched once a step."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels

    steps, stages, writes = 6, [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with instrumented_stages(stages, writes):
        final = _train_cli(["--network", "vgg", "--dataset", "PascalVOC",
                            "--synthetic", "8", "--batch_images", "2",
                            "--steps", str(steps), "--frequent", "1",
                            "--seed", "0"], OUT_DIR / "vgg_e2e.txt")
    torch.cuda.synchronize()
    launches = fp_launches()
    rec = summarise_stage(stages[0])
    log(stage_line(rec, card) + f"; final loss {final['loss']:.4f}")
    if launches != dict.fromkeys(launches, steps) or \
            not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"VGG16 e2e: launches {launches}, final "
                             f"{final}")
    return rec


def phase_alternate(dev, card: str) -> dict:
    """Phase 10: VGG16's kernels, its fp32 parity, the bf16 schedule and
    its evals, then a few e2e VGG16 steps; checkpoints under the ignored
    ``_chip/``, removed at the end."""
    import torch

    shutil.rmtree(ALT_DIR, ignore_errors=True)
    ALT_DIR.mkdir(parents=True)
    try:
        kern = phase_vgg_kernels(dev)
        parity = phase_vgg_parity(dev, ALT_DIR)
        schedule = run_schedule(dev, card)
        evals = schedule_evals(dev, schedule["final"], card)
        e2e = vgg_e2e_cli(card)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(ALT_DIR, ignore_errors=True)
    return dict(kernels=kern, fp32_parity=parity, schedule=schedule,
                evals=evals, e2e=e2e)


# ---- phase 11: the serving engine, the fifth main path ----------------------

SERVE_DIR = REPO / "_chip" / "serve"
ENGINE_BATCH = 4           # serve.batch_size
CLI_REQUESTS = 8
# From a seeded init, ResNet-101's pooled ROI features share one large
# component, so the classifier's logits spread ~300 over the classes and
# one class, background for seed 0, wins every ROI at p ~ 1: nothing
# clears serve.score_thresh 0.05 (measured on the CPU at a 192x256
# canvas).  The served checkpoint draws the classifier at a hundredth of
# the reference's std (Normal(1e-4)): logits spread ~3, and every image
# gets detections to compare.
SERVE_CLS_SCALE = 0.01


def phase_engine_kernels(dev) -> dict:
    """K1 at the engine's batch-4 shapes (proposals B=4, K=6144;
    postprocess B=4*21, K=512) and K2 at 4x300 rois, against their plain
    versions on each bucket's canvas (K2 on the 38x64 map of 608x1024
    and the 64x38 map of 1024x608), then timed; K1 is timed on the first
    bucket only, its work does not depend on the canvas."""
    import torch

    portrait = BUCKET[::-1]
    res = {}
    for j, bucket in enumerate((BUCKET, portrait)):
        tag = "" if bucket == BUCKET else f" {bucket[0]}x{bucket[1]}"
        for i, (name, b, k, thr) in enumerate((
                ("proposal", ENGINE_BATCH, 6000, 0.7),
                ("postprocess", ENGINE_BATCH * VOC_CLASSES, 300, 0.3))):
            label = f"engine {name}{tag}"
            boxes, _, alive, _, t = nms_inputs(b, k, seed=110 + 10 * j + i,
                                               dev=dev, bucket=bucket)
            check_k1(label, boxes, alive, t)
            if bucket == BUCKET:
                res[f"k1_{name}"] = time_k1(label, boxes, alive, t, thr)
        feat, rois = roi_inputs(ENGINE_BATCH, 300, 120 + j, dev,
                                bucket=bucket)
        _, err16 = check_k2(f"engine{tag}", feat, rois)
        res["k2" if bucket == BUCKET else "k2_portrait"] = time_k2(
            f"engine{tag}", feat.to(torch.bfloat16), rois, err16)
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, payload=None, timeout: float = 60.0, headers=None):
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def request_images():
    """The served images: seeded 375x500 and 500x375, half each, so both
    buckets serve."""
    from mx_rcnn_tpu_torch.tools import demo

    half = CLI_REQUESTS // 2
    return (demo.synthetic_images(half, seed=30)
            + demo.synthetic_images(half, seed=31, size=(500, 375)))


def serve_cli(prefix: str, card: str) -> dict:
    """``tools/serve.py`` cold in a process of its own: time from its
    start to the first ``/healthz`` 200 (model build, checkpoint read and
    the warm-up of both buckets), 8 concurrent ``/detect`` requests, the
    ``/metrics`` counts, then SIGINT: exit 0 within 10 s."""
    import base64
    import math
    import signal
    from concurrent.futures import ThreadPoolExecutor

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = OUT_DIR / "serve_cli.txt"
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.serve",
             "--prefix", prefix, "--epoch", "1", "--port", str(port)],
            cwd=REPO, stdout=logf, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(
                        f"tools/serve.py exited {proc.returncode} before "
                        f"serving: {log_path.read_text()[-2000:]}")
                if time.perf_counter() - t0 > 180:
                    raise AssertionError("tools/serve.py not serving after "
                                         "180 s")
                try:
                    status, health = _http(url + "/healthz", timeout=2.0)
                    if status == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.1)
            time_to_serve = time.perf_counter() - t0
            images = request_images()

            def post(img):
                return _http(url + "/detect", {
                    "pixels_b64": base64.b64encode(img.tobytes()).decode(),
                    "shape": list(img.shape)})

            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(images)) as pool:
                replies = list(pool.map(post, images))
            burst_s = time.perf_counter() - t1
            counts = []
            for i, (status, body) in enumerate(replies):
                dets = body.get("detections") or []
                finite = all(math.isfinite(v) for d in dets
                             for v in d["box"] + [d["score"]])
                if status != 200 or not dets or not finite:
                    raise AssertionError(f"request {i}: status {status}, "
                                         f"{len(dets)} detections, finite "
                                         f"{finite}: {str(body)[:300]}")
                counts.append(len(dets))
            status, snap = _http(url + "/metrics")
            c = snap["counters"]
            if status != 200 or c["served"] != len(images) or c["failed"]:
                raise AssertionError(f"/metrics after the burst: {c}")
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
            t2 = time.perf_counter()
            try:
                rc = proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise AssertionError("tools/serve.py still running 10 s "
                                     "after SIGINT")
    exit_s = time.perf_counter() - t2
    if rc != 0:
        raise AssertionError(f"tools/serve.py exited {rc} on SIGINT")
    log(f"serve CLI on {card}: first /healthz 200 after {time_to_serve:.2f} "
        f"s (build, checkpoint read, warm-up of {health['buckets']}); "
        f"{len(images)} concurrent /detect in {burst_s:.3f} s, all 200, "
        f"detections {counts}; /metrics served {c['served']} failed "
        f"{c['failed']} batches {c['batches']}; SIGINT → exit {rc} in "
        f"{exit_s:.2f} s")
    return dict(time_to_serve_s=time_to_serve, burst_s=burst_s,
                detections=counts, metrics=snap, exit_s=exit_s,
                healthz=health)


def offline_detections(engine, img):
    """``img`` through the offline path: its canvas in row 0 of a batch
    composed by hand, ``Predictor.raw``, ``_postprocess_batch`` and
    ``detections_from_keep``."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.core.tester import (_postprocess_batch,
                                               detections_from_keep)

    p, cfg = engine.predictor, engine.cfg
    canvas, info, (bh, bw) = engine.preprocess(img)
    n = cfg.serve.batch_size
    images = np.zeros((n, bh, bw, 3), np.float32)
    im_info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
    images[0], im_info[0] = canvas, info
    outs = p.raw(images, im_info)
    info_t = torch.from_numpy(im_info).to(p.device)
    with torch.inference_mode():
        post = _postprocess_batch(*outs, info_t, info_t[:, 2], engine._stds,
                                  engine._means, nms_thresh=cfg.test.nms,
                                  score_thresh=cfg.serve.score_thresh)
    return detections_from_keep(*(t.cpu().numpy() for t in post), 0)


def engine_bit_equal(prefix: str, dev, dtype: str) -> dict:
    """For one image per bucket, ``engine.detect`` equals the offline path
    on the same batch bit for bit."""
    import numpy as np

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    cfg = generate_config("resnet101", "PascalVOC",
                          network__compute_dtype=dtype)
    engine = ServingEngine(init_predictor(cfg, prefix, 1, device=dev), cfg)
    images = request_images()
    counts = {}
    try:
        engine.warmup()
        for img in (images[0], images[-1]):
            got = engine.detect(img)
            want = offline_detections(engine, img)
            bucket = engine.preprocess(img)[2]
            same = sorted(got) == sorted(want) and all(
                np.array_equal(got[c], want[c]) for c in want)
            n = sum(len(v) for v in want.values())
            if not same or n == 0:
                raise AssertionError(f"engine {dtype} bucket {bucket}: "
                                     f"{n} detections, bit-equal {same}")
            counts[f"{bucket[0]}x{bucket[1]}"] = n
    finally:
        engine.close()
    log(f"engine {dtype}: detect bit-equal to the offline path, "
        f"detections per bucket {counts}")
    return counts


def _loadgen(argv, out: Path) -> dict:
    from mx_rcnn_tpu_torch.tools import loadgen

    with open(out.with_suffix(".txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = loadgen.main(argv + ["--out", str(out)])
    rec = json.loads(out.read_text())
    if rc != 0 or rec["lost"] or rec["failed"]:
        raise AssertionError(f"loadgen rc {rc}: lost {rec['lost']}, failed "
                             f"{rec['failed']}")
    return rec


def engine_traffic(prefix: str, card: str) -> dict:
    """``tools/loadgen.py`` in-process: a closed loop at concurrency 8
    for 8 s, then open loops for 6 s with 2 s deadlines, at 0.5x its
    served rate and at 1.5x the engine's ceiling; nothing lost or failed,
    and the 1.5x loop sheds or expires.

    The ceiling is the closed loop's served rate, or the offline rate of
    the same batches where that is higher: 8 clients with one request
    each serve concurrency / latency (Little's law), which on a slow host
    stays under what the engine can take (on an H100 80GB HBM3 machine
    with a slower host, 88.49 images/s offline against 115.17 on
    another: 36.45 closed at 2.32 rows a batch, and 1.5x of the closed
    rate neither shed nor expired)."""
    base = ["--network", "resnet101", "--dataset", "PascalVOC", "--prefix",
            prefix, "--epoch", "1"]
    runs = {"closed": _loadgen(base + ["--duration", "6", "--concurrency",
                                       str(2 * ENGINE_BATCH)],
                               OUT_DIR / "loadgen_closed.json")}
    closed = runs["closed"]
    rates = {0.5: closed["value"],
             1.5: max(closed["value"], closed["offline_imgs_per_sec"])}
    log(f"loadgen closed loop {closed['value']} images/s, offline "
        f"{closed['offline_imgs_per_sec']}: open loops at 0.5 x "
        f"{rates[0.5]} and 1.5 x {rates[1.5]} arrivals/s")
    for k, rate in rates.items():
        runs[f"open_{k}x"] = _loadgen(
            base + ["--mode", "open", "--duration", "5", "--qps",
                    f"{k * rate:.3f}", "--timeout_ms", "2000"],
            OUT_DIR / f"loadgen_open_{k}x.json")
    for name, r in runs.items():
        log(f"loadgen {name} on {card}: {r['value']} images/s served "
            f"(target {r['qps_target']}), p50/p90/p99 {r['p50_ms']}/"
            f"{r['p90_ms']}/{r['p99_ms']} ms, queue wait p99 "
            f"{r['queue_wait_p99_ms']} ms, model p50 {r['model_ms_p50']} "
            f"ms, occupancy {r['batch_occupancy_mean']}, preprocess p50 "
            f"{r['preprocess_ms_p50']} ms ({r['resize_backend']}), shed "
            f"{r['shed_rate']} expired {r['expired_rate']} of "
            f"{r['submitted']}, offline {r['offline_imgs_per_sec']} "
            f"images/s, ratio {r['ratio_vs_offline']}")
    over = runs["open_1.5x"]
    if over["shed"] + over["expired"] == 0:
        raise AssertionError("the 1.5x open loop neither shed nor expired")
    return runs


def engine_profile(prefix: str, dev, card: str) -> dict:
    """Device time of one engine batch of 4 (profiler), the busy share
    over a 2 s closed loop (device time of a device-only trace over wall
    time) and the launches of that loop: K1 2, K2 1 and K3 0 per batch."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools.loadgen import (init_predictor,
                                                 run_closed_loop,
                                                 synthetic_images)

    cfg = generate_config("resnet101", "PascalVOC")
    engine = ServingEngine(init_predictor(cfg, prefix, 1, device=dev), cfg)
    try:
        engine.warmup()
        pre = [engine.preprocess(img) for img in request_images()[:4]]
        images = np.stack([p[0] for p in pre])
        im_info = np.stack([p[1] for p in pre])
        batch = device_profile(lambda: engine._run(images, im_info), 5)
        traffic = synthetic_images(cfg, 16, seed=0)
        torch.cuda.synchronize()
        engine.metrics.reset()
        kernels.reset_launch_counts()
        run = {}
        loop = device_profile(lambda: run.update(run_closed_loop(
            engine, traffic, 2.0, 2 * ENGINE_BATCH, 2000.0)), 1, cpu=False)
        wall_ms = run["wall_s"] * 1e3
        launches = fp_launches()
        snap = engine.metrics.snapshot()
    finally:
        engine.close()
    batches = snap["counters"]["batches"]
    loop["busy_share"] = busy_share(loop, wall_ms)
    ours = batch["kernel_ms_per_iter"]
    log(f"engine batch of 4 on {card}: {batch['device_ms_per_iter']:.3f} ms "
        f"of device time, {batch['kernels_per_iter']:.0f} device ops; K1 "
        f"mask pass {ours['k1_mask']:.4f} + reduction {ours['k1_reduce']:.4f}"
        f" ms, K2 {ours['k2']:.4f} ms per batch")
    log(f"engine closed loop, 2 s at concurrency 8 under a device-only "
        f"trace: {batches} batches, {snap['counters']['served']} served "
        f"({snap['counters']['served'] / wall_ms * 1e3:.2f} images/s), device "
        f"{loop['device_ms_per_iter']:.1f} ms of {wall_ms:.1f} ms wall (busy "
        f"share {loop['busy_share'] or 'not measured'}); launches {launches}")
    want = {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
            "roi_align_bwd": 0}
    if batches == 0 or launches != want:
        raise AssertionError(f"the engine's launches {launches} over "
                             f"{batches} batches; want {want}")
    loop["wall_ms"] = wall_ms
    return dict(batch=batch, loop=loop, launches=launches, batches=batches,
                snapshot=snap)


def preprocess_alone(cfg) -> dict:
    """A request's resize and pad alone on one thread (``prepare_image``,
    the engine's ``preprocess``): ms per image, mean of 10, for a 375x500
    request image and a 608x1024 loadgen image."""
    from mx_rcnn_tpu_torch.data.image import prepare_image
    from mx_rcnn_tpu_torch.tools.loadgen import synthetic_images

    out = {}
    for name, img in (("375x500", request_images()[0]),
                      ("608x1024", synthetic_images(cfg, 1)[0])):
        prepare_image(img, cfg)
        t0 = time.perf_counter()
        for _ in range(10):
            prepare_image(img, cfg)
        out[name] = (time.perf_counter() - t0) / 10 * 1e3
    return out


def phase_engine(dev, card: str) -> dict:
    """Phase 11: the engine's kernel shapes, ``tools/serve.py`` cold, the
    bit-equality of bf16 and fp32 answers, the loadgen traffic and the
    profile, from one seeded ResNet-101 checkpoint under the ignored
    ``_chip/``, removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.data.image import RESIZE_BACKEND
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    t0 = time.perf_counter()
    host = {"start": host_info(dev)}
    log(f"phase 11 host: {host_text(host['start'])}")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    try:
        kern = phase_engine_kernels(dev)
        prefix = str(SERVE_DIR / "m")
        cfg = generate_config("resnet101", "PascalVOC")
        # fp32 weights from a seed (each dtype's model casts them), the
        # classifier's scaled by SERVE_CLS_SCALE
        model = build_model(cfg, dev, seed=0, train=True)
        with torch.no_grad():
            model.cls_score.weight.mul_(SERVE_CLS_SCALE)
        save_params(prefix, 1, model.state_dict())
        del model
        alone = preprocess_alone(cfg)
        log(f"phase 11: resize backend {RESIZE_BACKEND}; a request's "
            f"resize and pad alone: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in alone.items()))
        cli = serve_cli(prefix, card)
        bit_equal = {dt: engine_bit_equal(prefix, dev, dt)
                     for dt in ("bfloat16", "float32")}
        traffic = engine_traffic(prefix, card)
        prof = engine_profile(prefix, dev, card)
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    host["end"] = host_info(dev)
    log(f"phase 11 took {wall:.1f} s; host at its end: "
        f"{host_text(host['end'])}")
    return dict(kernels=kern, cli=cli, bit_equal=bit_equal, traffic=traffic,
                profile=prof, resize_backend=RESIZE_BACKEND,
                preprocess_alone_ms=alone, wall_s=wall, host=host)


# ---- phase 12: the real-dataset input plane, the sixth main path ----------

REAL_DIR = REPO / "_chip" / "real"       # datasets, checkpoints, detections
REAL_IMAGES = 16           # per image set: 16 trainval and 16 test images
VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
             "cat", "chair", "cow", "diningtable", "dog", "horse",
             "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
             "tvmonitor")
# COCO 2017's 80 category ids, 1..90 less the ten it does not use
COCO_IDS = tuple(i for i in range(1, 91)
                 if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
COCO_CLASSES = 81


def _scene(rng, h: int, w: int, n_classes: int):
    """Noise with 1..4 rectangles, each filled with its class's colour:
    (RGB uint8 image, [(class 0..n-1, (x1, y1, x2, y2))], 0-based)."""
    import numpy as np

    img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
    objs = []
    for _ in range(rng.randint(1, 5)):
        bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        c = int(rng.randint(n_classes))
        img[y1:y1 + bh, x1:x1 + bw] = np.random.RandomState(1000 + c) \
            .randint(60, 255, 3)
        objs.append((c, (x1, y1, x1 + bw - 1, y1 + bh - 1)))
    return img, objs


def write_voc_devkit(root: Path, seed: int = 0) -> Path:
    """A VOCdevkit in the real layout: VOC2007/JPEGImages (375x500 and
    500x375 in turn, so both buckets), Annotations (1-based boxes of the 20
    classes, every fifth object ``difficult`` unless it is its image's
    first, so no image is left without gt) and ImageSets/Main trainval.txt
    and test.txt, 16 images each."""
    import cv2
    import numpy as np

    voc = root / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (voc / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    k = 0
    for i in range(2 * REAL_IMAGES):
        h, w = (375, 500) if i % 2 == 0 else (500, 375)
        img, objs = _scene(rng, h, w, len(VOC_NAMES))
        cv2.imwrite(str(voc / "JPEGImages" / f"{i:06d}.jpg"),
                    img[:, :, ::-1])
        xml = []
        for j, (c, b) in enumerate(objs):
            xml.append(f"<object><name>{VOC_NAMES[c]}</name><difficult>"
                       f"{int(k % 5 == 4 and j > 0)}</difficult><bndbox><xmin>"
                       f"{b[0] + 1}</xmin><ymin>{b[1] + 1}</ymin><xmax>"
                       f"{b[2] + 1}</xmax><ymax>{b[3] + 1}</ymax></bndbox>"
                       f"</object>")
            k += 1
        (voc / "Annotations" / f"{i:06d}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height>"
            f"<depth>3</depth></size>{''.join(xml)}</annotation>")
    for name, ids in (("trainval", range(REAL_IMAGES)),
                      ("test", range(REAL_IMAGES, 2 * REAL_IMAGES))):
        (voc / "ImageSets" / "Main" / f"{name}.txt").write_text(
            "".join(f"{i:06d}\n" for i in ids))
    return root / "VOCdevkit"


def write_coco_tree(root: Path, seed: int = 1,
                    counts=(REAL_IMAGES, REAL_IMAGES),
                    portrait_every: int = 0) -> Path:
    """A COCO tree in the real layout: train2017/ and val2017/ of
    ``counts`` (16 and 16 by default) 480x640 JPEGs (every
    ``portrait_every``-th one 640x480 when given, for the second bucket)
    and annotations/instances_<set>.json over COCO's 80 category ids,
    every sixth annotation a crowd."""
    import cv2
    import numpy as np

    ds = root / "coco"
    (ds / "annotations").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    cats = [{"id": cid, "name": f"category{cid}"} for cid in COCO_IDS]
    for sset, count in zip(("train2017", "val2017"), counts):
        (ds / sset).mkdir(exist_ok=True)
        images, anns = [], []
        for i in range(count):
            h, w = ((640, 480) if portrait_every
                    and i % portrait_every == portrait_every - 1
                    else (480, 640))
            img, objs = _scene(rng, h, w, len(COCO_IDS))
            name = f"{i:012d}.jpg"
            cv2.imwrite(str(ds / sset / name), img[:, :, ::-1])
            images.append({"id": i + 1, "file_name": name, "height": h,
                           "width": w})
            for c, (x1, y1, x2, y2) in objs:
                w, h = x2 - x1 + 1, y2 - y1 + 1
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": COCO_IDS[c],
                             "bbox": [x1, y1, w, h], "area": w * h,
                             "iscrowd": int(len(anns) % 6 == 5)})
        (ds / "annotations" / f"instances_{sset}.json").write_text(
            json.dumps({"images": images, "annotations": anns,
                        "categories": cats}))
    return ds


def _parse(pattern: str, text: str, what: str):
    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"no {what} in the CLI's output")
    return m


def real_train(dev, voc_args, prefix: str, card: str):
    """``tools/train.py`` over the devkit: ResNet-101 in bf16 at batch 2,
    2 decode workers, the cache on, streaming and staging at their
    defaults; one epoch of 16 images and their flips (16 steps) with a
    checkpoint.  Launch counts zeroed just before, read just after; peak
    memory over the run."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    read_manifest)

    base = voc_args + ["--image_set", "2007_trainval", "--batch_images", "2",
                       "--seed", "0", "--frequent", "8",
                       "--set", "default__decode_procs=2"]
    out = OUT_DIR / "real_train.txt"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    final = _train_cli(base + ["--prefix", prefix, "--end_epoch", "1"], out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fp_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    text = out.read_text()
    steps = 2 * REAL_IMAGES // 2
    epoch = _parse(r"Epoch\[0\] (\d+) steps in ([0-9.]+) s, data wait "
                   r"([0-9.]+) s \(([0-9.]+)%\)", text, "epoch line")
    decoded = int(_parse(r"images decoded: (\d+)", text, "decode count")
                  .group(1))
    epoch_s = float(epoch.group(2))
    manifest = read_manifest(checkpoint_path(prefix, 1))
    res = dict(steps=int(epoch.group(1)), epoch_s=epoch_s,
               ms_per_step=epoch_s * 1e3 / steps,
               images_per_s=2 * steps / epoch_s,
               data_wait_s=float(epoch.group(3)),
               data_wait_share=float(epoch.group(4)) / 100,
               images_decoded=decoded, launches=launches,
               peak_gib=peak / 2 ** 30, cli_wall_s=wall,
               final_metrics=final, base=base)
    log(f"real-data training on {card}: ResNet-101 bf16, batch 2, "
        f"{steps} steps over the VOCdevkit's 16 trainval JPEGs and their "
        f"flips, 2 decode workers, cache, streaming, staging: "
        f"{res['ms_per_step']:.2f} ms/step, {res['images_per_s']:.2f} "
        f"images/s over the epoch (its first steps included), data wait "
        f"{res['data_wait_s']:.3f} s = {100 * res['data_wait_share']:.1f}% "
        f"of the epoch, {decoded} images decoded, peak "
        f"{res['peak_gib']:.2f} GiB, launches {launches}; the CLI "
        f"{wall:.2f} s with the pool's start, model build and checkpoint; "
        f"final loss {final['loss']:.4f}")
    if res["steps"] != steps or decoded != 2 * steps or \
            manifest["step"] != steps or \
            not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"real-data training: {res}, {manifest}")
    if launches != {"nms_sweep": steps, "roi_align_fwd": steps,
                    "roi_align_bwd": steps}:
        raise AssertionError(f"real-data training launches {launches}, "
                             f"expected K1/K2/K3 1/1/1 per step")
    return res


def epoch_line(text: str, epoch: int, label: str) -> dict:
    """ms/step, images/s and the data-wait share from ``fit``'s line of
    ``epoch`` in a training log (batch 2)."""
    m = _parse(rf"Epoch\[{epoch}\] (\d+) steps in ([0-9.]+) s, data wait "
               r"([0-9.]+) s \(([0-9.]+)%\)", text,
               f"{label} epoch-{epoch + 1} line")
    steps, wall = int(m.group(1)), float(m.group(2))
    return dict(steps=steps, epoch_s=wall, ms_per_step=wall * 1e3 / steps,
                images_per_s=2 * steps / wall,
                data_wait_share=float(m.group(4)) / 100)


def synthetic_both_buckets(n: int, num_classes: int):
    """The stand-in for the devkit's training roidb: ``n`` synthetic
    images, 375x500 and 500x375 in turns as the devkit's are, then their
    flipped copies, with the ``load_image`` that renders each in memory."""
    from mx_rcnn_tpu_torch.data import IMDB, SyntheticDataset

    sets = [SyntheticDataset(f"trainval_{h}x{w}", num_images=n // 2,
                             num_classes=num_classes, image_size=(h, w))
            for h, w in ((375, 500), (500, 375))]
    roidb = [rec for pair in zip(*(d.gt_roidb() for d in sets))
             for rec in pair]

    def load_image(rec):
        return sets[rec["height"] > rec["width"]].load_image(rec)

    return IMDB.append_flipped_images(roidb), load_image


def warm_run(cfg, dev, source: dict, out: Path, label: str) -> dict:
    """``train_net`` for three epochs over ``source`` (the devkit's roidb
    by default, or a ``roidb`` and its ``load_image``): the second epoch
    timed as it runs, the third under a device-only profiler trace
    (started and stopped at ``fit``'s epoch lines, the trace synchronised
    first): its device time and copy time per step and its busy share,
    the device time over the epoch's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mx_rcnn_tpu_torch.tools.train import train_net

    lines = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def collect(line):
        lines.append(line)
        if re.match(r"Epoch\[1\] \d+ steps in", line):
            prof.start()
        elif re.match(r"Epoch\[2\] \d+ steps in", line):
            torch.cuda.synchronize()
            prof.stop()

    train_net(cfg, end_epoch=3, frequent=8, seed=0, device=dev, log=collect,
              **source)
    text = "\n".join(lines)
    out.write_text(text + "\n")
    warm = epoch_line(text, 1, label)
    traced = epoch_line(text, 2, label)
    trace = trace_summary(prof, traced["steps"])
    res = dict(warm, traced_ms_per_step=traced["ms_per_step"],
               traced_data_wait_share=traced["data_wait_share"],
               device_ms_per_step=trace["device_ms_per_iter"],
               copy_ms_per_step=trace["copy_ms_per_iter"],
               busy_share=busy_share(trace, traced["ms_per_step"]),
               kernels_per_step=trace["kernels_per_iter"], top=trace["top"])
    busy = res["busy_share"]
    busy_text = "not measured (no device events)" if busy is None else \
        f"{busy:.3f}"
    log(f"{label}, second epoch: {res['ms_per_step']:.2f} ms/step, "
        f"{res['images_per_s']:.2f} images/s, data wait "
        f"{100 * res['data_wait_share']:.1f}%; third epoch traced: "
        f"{res['traced_ms_per_step']:.2f} ms/step, data wait "
        f"{100 * res['traced_data_wait_share']:.1f}%, "
        f"{res['device_ms_per_step']:.3f} ms of device time a step "
        f"({res['copy_ms_per_step']:.3f} of it copies, "
        f"{res['kernels_per_step']:.0f} device operations), busy share "
        f"{busy_text}")
    return res


def warm_pairs(dev, voc_over: dict, card: str) -> dict:
    """Steady training with cuDNN's default algorithms, as phase 8 runs:
    three-epoch ``train_net`` runs of one config over the devkit (2
    decode workers, cache, streaming, staging) and over 16 synthetic
    images in memory, 375x500 and 500x375 in turns like the devkit's (no
    files, so no pool and no cache), real then synthetic; each run's
    second epoch, when the process, the cache and the workers are warm,
    timed, and its third traced (:func:`warm_run`)."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config

    torch.backends.cudnn.deterministic = False
    cfg = generate_config("resnet101", "PascalVOC", train__batch_images=2,
                          dataset__image_set="2007_trainval",
                          default__decode_procs=2, **voc_over)
    roidb, load_image = synthetic_both_buckets(REAL_IMAGES,
                                               cfg.dataset.num_classes)
    sources = {"real": {},
               "synthetic": dict(roidb=roidb, load_image=load_image)}
    runs = {"real": [], "synthetic": []}
    for i, kind in enumerate(("real", "synthetic")):
        runs[kind].append(warm_run(
            cfg, dev, sources[kind], OUT_DIR / f"real_warm_{i}_{kind}.txt",
            f"{kind} run {i} on {card}"))
    return runs


def portrait_kernels(dev) -> dict:
    """K2 and K3 at the training shape (2x128 rois, 14x14x1024) on the
    64x38 map of the 1024x608 bucket, which the devkit's 500x375 images
    train on: each against its plain version in fp32 and bf16 (K3
    bit-equal twice) on random and on small rois, then timed; K3 on rois
    covering that map and wholly outside it.  Its 38 columns leave K3's
    last band of feature columns half full, which 64 never do."""
    import torch

    portrait = BUCKET[::-1]
    hw = (portrait[0] // 16, portrait[1] // 16)
    tag = f"{portrait[0]}x{portrait[1]}"
    res = {}
    for name, seed, wh in (("train", 150, (0, 500)),
                           ("train_small", 152, (16, 64))):
        feat, rois = roi_inputs(2, TRAIN_ROIS, seed, dev, wh,
                                bucket=portrait)
        label = f"{name} {tag}"
        _, k2_16 = check_k2(label, feat, rois)
        g = k3_grad(2, TRAIN_ROIS, seed + 1, dev)
        k3_32, k3_16 = check_k3(label, g, rois, hw)
        if name == "train":
            res["k2"] = time_k2(label, feat.to(torch.bfloat16), rois, k2_16)
            res["k3"] = {t: time_k3(label, gg, rois, hw, err)
                         for t, gg, err in (("bf16", g.to(torch.bfloat16),
                                             k3_16), ("fp32", g, k3_32))}
    for label, where in (("rois covering the whole map", "whole map"),
                         ("rois wholly outside the map", "outside")):
        check_k3(f"{label} {tag}", k3_grad(2, 16, 155, dev),
                 placed_rois(2, 16, 156, dev, where, portrait), hw)
    return res


def real_test(args, label: str, out_name: str, n_images: int, card: str):
    """``tools/test.py`` over an on-disk test set at batch 2 in bf16:
    launches (K1 2 and K2 1 per batch, K3 none), images/s, the numbers."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import test as test_cli

    out = OUT_DIR / out_name
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with open(out, "w") as f, contextlib.redirect_stdout(f):
        results = test_cli.main(args + ["--set", "test__batch_images=2"])
    torch.cuda.synchronize()
    launches = fp_launches()
    rate = _parse(rf"pred_eval: {n_images} images in ([0-9.]+) s, "
                  r"([0-9.]+) images/s", out.read_text(), "eval rate")
    batches = n_images // 2
    log(f"{label} on {card}: {n_images} images at batch 2, "
        f"{float(rate.group(2)):.2f} images/s (first call: JPEG decode, "
        f"resize and the model's first batches included); launches "
        f"{launches}; " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    results.items()))
    if launches != {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
                    "roi_align_bwd": 0}:
        raise AssertionError(f"{label}: launches {launches}")
    return dict(results=results, launches=launches,
                images_per_s=float(rate.group(2)))


def staged_equals_unstaged(dev, cfg) -> dict:
    """The training plan's batches through DeviceStager on the card
    against the same plan copied without it: every tensor bit-equal, in
    the same order."""
    import torch

    from mx_rcnn_tpu_torch.core.train import to_device
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import StreamLoader, cache_from_config
    from mx_rcnn_tpu_torch.data.staging import DeviceStager

    imdb, roidb = load_gt_roidb(cfg, training=True)
    cache = cache_from_config(cfg)

    def loader():
        return StreamLoader(roidb, cfg, imdb.load_image, batch_images=2,
                            seed=0, cache=cache)

    plain = [to_device(b, dev) for b in loader()]
    stager = DeviceStager(loader(), dev, cfg.data.stage_depth)
    t0 = time.perf_counter()
    staged = list(stager)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stager.close()
    same = len(staged) == len(plain) and all(
        torch.equal(a, b) and a.device == b.device
        for s, p in zip(staged, plain) for a, b in zip(s, p))
    log(f"staging: {len(staged)} batches through DeviceStager (side stream, "
        f"pinned copies) equal the unstaged batches bit for bit: {same} "
        f"({wall:.3f} s from the cache)")
    if not same:
        raise AssertionError("staged batches differ from unstaged ones")
    return dict(batches=len(staged), equal=same, wall_s=wall)


def real_eval_parity(dev, prefix: str, over: dict, work: Path) -> dict:
    """pred_eval in fp32 (TF32 off) over the devkit's 16 test images at
    batch 2, through K1/K2 and through their plain versions: equal counts
    per (class, image), boxes within 1e-2 px and scores within 1e-4
    (phase 9's tolerances), equal APs."""
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader
    from mx_rcnn_tpu_torch.utils.checkpoint import load_model

    cfg = generate_config("resnet101", "PascalVOC",
                          network__compute_dtype="float32",
                          test__batch_images=2, **over)
    predictor = Predictor(load_model(cfg, prefix, 1, dev), cfg, dev)
    imdb, roidb = load_gt_roidb(cfg, training=False)

    def run(tag):
        return pred_eval(predictor, TestLoader(roidb, cfg, imdb.load_image),
                         imdb, cfg, verbose=False,
                         save_dets=str(work / f"{tag}.pkl"))

    kernels.reset_launch_counts()
    res_k = run("kernels")
    launches = fp_launches()
    with plain_versions():
        res_p = run("plain")
    count_diff, box_err, score_err, total = compare_dets(work)
    log(f"real-data eval fp32, VOCdevkit test set ({len(roidb)} images at "
        f"batch 2): {total} detections; (class, image) count mismatches "
        f"{count_diff}, max|box diff| {box_err:.3e} px (tol 1e-2), "
        f"max|score diff| {score_err:.3e} (tol 1e-4); mAP kernels "
        f"{res_k['mAP']:.6f} plain {res_p['mAP']:.6f}; launches {launches}")
    if count_diff or box_err > 1e-2 or score_err > 1e-4 or res_k != res_p \
            or total == 0:
        raise AssertionError("the fp32 real-data eval differs between the "
                             "kernel and plain paths")
    if launches != {"nms_sweep": 16, "roi_align_fwd": 8, "roi_align_bwd": 0}:
        raise AssertionError(f"fp32 real-data eval launches {launches}")
    return dict(detections=total, count_mismatches=count_diff,
                max_box_diff_px=box_err, max_score_diff=score_err,
                aps_kernels=res_k, launches=launches)


def coco_k1(dev) -> dict:
    """K1 at the COCO postprocess's shape (B=2*81, K=300 rois padded to
    512) against its plain version, then timed at 0.3."""
    boxes, _, alive, _, t = nms_inputs(2 * COCO_CLASSES, 300, seed=140,
                                       dev=dev)
    check_k1("coco postprocess", boxes, alive, t)
    return time_k1("coco postprocess", boxes, alive, t, 0.3)


def phase_real_data(dev, card: str) -> dict:
    """Phase 12: a VOCdevkit and a COCO tree generated in the real layouts
    under the ignored ``_chip/``, ResNet-101 trained on the devkit through
    the input plane, then scored through ``PascalVOC`` and, from a seeded
    81-class checkpoint, through ``COCODataset``; staged batches, the fp32
    eval and resume held against themselves, K2 and K3 on the portrait
    bucket's map against their plain versions
    (:func:`portrait_kernels`), with cuDNN's deterministic algorithms
    (resume must repeat bits); then the steady epochs of
    :func:`warm_pairs`.  Everything under ``_chip/real`` is removed at
    the end."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.utils.checkpoint import (load_state_dict,
                                                    save_params)

    t0 = time.perf_counter()
    parts = {}                  # each part's wall time, s

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(REAL_DIR, ignore_errors=True)
    REAL_DIR.mkdir(parents=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        devkit = write_voc_devkit(REAL_DIR)
        coco = write_coco_tree(REAL_DIR)
        done("generate")
        root = str(REAL_DIR)
        voc_over = dict(dataset__root_path=root,
                        dataset__dataset_path=str(devkit))
        voc_args = ["--network", "resnet101", "--dataset", "PascalVOC",
                    "--root_path", root, "--dataset_path", str(devkit)]
        log(f"phase 12: generated a VOCdevkit (16 trainval + 16 test JPEGs, "
            f"375x500 and 500x375) and a COCO tree (16 train2017 + 16 "
            f"val2017, 480x640, 80 categories) in {parts['generate']:.2f} s")
        prefix = str(REAL_DIR / "voc")
        train = real_train(dev, voc_args, prefix, card)
        done("train")
        voc_test = real_test(
            voc_args + ["--image_set", "2007_test", "--prefix", prefix,
                        "--epoch", "1", "--out_dir", str(REAL_DIR / "dets")],
            "test CLI, PascalVOC", "real_test_voc.txt", REAL_IMAGES, card)
        files = sorted((REAL_DIR / "dets").iterdir())
        lines = sum(len(f.read_text().splitlines()) for f in files)
        log(f"VOC detection files: {len(files)} comp4_det_test_*.txt, "
            f"{lines} detections written")
        if len(files) != 20:
            raise AssertionError(f"{len(files)} VOC detection files")
        done("VOC test")
        staged = staged_equals_unstaged(dev, generate_config(
            "resnet101", "PascalVOC", **voc_over))
        # the trained weights with the classifier scaled (SERVE_CLS_SCALE's
        # reason): a random ResNet-101 scores background on every ROI
        state = load_state_dict(prefix, 1)
        state["cls_score.weight"] = state["cls_score.weight"] * \
            SERVE_CLS_SCALE
        save_params(prefix + "-scaled", 1, state)
        (REAL_DIR / "parity").mkdir()
        parity = real_eval_parity(dev, prefix + "-scaled", voc_over,
                                  REAL_DIR / "parity")
        done("staging and fp32 eval")
        k1 = coco_k1(dev)
        portrait = portrait_kernels(dev)
        done("kernels")
        cfg81 = generate_config("resnet101", "coco")
        model = build_model(cfg81, dev, seed=0, train=True)
        with torch.no_grad():
            model.cls_score.weight.mul_(SERVE_CLS_SCALE)
        save_params(str(REAL_DIR / "coco"), 1, model.state_dict())
        del model
        coco_test = real_test(
            ["--network", "resnet101", "--dataset", "coco", "--root_path",
             root, "--dataset_path", str(coco), "--prefix",
             str(REAL_DIR / "coco"), "--epoch", "1", "--out_dir",
             str(REAL_DIR / "coco_dets")],
            "test CLI, COCODataset (81 classes)", "real_test_coco.txt",
            REAL_IMAGES, card)
        if not (REAL_DIR / "coco_dets" / "detections_results.json").exists():
            raise AssertionError("no COCO results json")
        done("COCO test")
        resume = resume_check(prefix, train["base"], tag="real")
        done("resume")
        warm = warm_pairs(dev, voc_over, card)
        done("warm runs")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(REAL_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 12 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(train=train, voc_test=voc_test, voc_files=len(files),
                voc_lines=lines, staged=staged, fp32_parity=parity,
                coco_k1=k1, portrait_kernels=portrait, coco_test=coco_test,
                resume=resume, warm=warm, parts_s=parts, wall_s=wall)


# ---- phase 13: the long training run ----------------------------------------

LONG_DIR = REPO / "_chip" / "long"   # weight files, checkpoints, the devkit
LONG_STEPS = 4             # steps of the ImageNet-start run
SIGTERM_AFTER = 7          # the SIGTERM run's last logged step of epoch 1
# a training CLI in a process of its own, with the algorithms this script
# runs under: deterministic cuDNN and no TF32
TRAIN_PROCESS = ("import sys, torch; "
                 "torch.backends.cudnn.deterministic = True; "
                 "torch.backends.cudnn.benchmark = False; "
                 "torch.backends.cudnn.allow_tf32 = False; "
                 "torch.backends.cuda.matmul.allow_tf32 = False; "
                 "from mx_rcnn_tpu_torch.tools.train import main; "
                 "main(sys.argv[1:])")
# two tools/train.py runs in one process, their arguments split by
# "--then" and their logs by a line "--then"
TRAIN_TWICE_PROCESS = TRAIN_PROCESS.replace(
    "main(sys.argv[1:])",
    "i = sys.argv.index('--then'); main(sys.argv[1:i]); "
    "print('--then', flush=True); main(sys.argv[i + 1:])")


def write_mxnet_params(path: Path, named: dict) -> None:
    """MXNet's NDArray container of ``named``: V2 headers, float32."""
    import struct

    import numpy as np

    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, len(named)))
        for arr in named.values():
            arr = np.ascontiguousarray(arr, "<f4")
            f.write(struct.pack("<IiI", 0xF993FAC9, -1, arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            f.write(struct.pack("<iii", 1, 0, 0))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(named)))
        for name in named:
            f.write(struct.pack("<Q", len(name)) + name.encode())


def _randn(gen, shape, std: float):
    import torch

    return (torch.randn(shape, generator=gen) * std).numpy()


def zoo_resnet101(seed: int) -> dict:
    """A ResNet-101 v2 file with the MXNet zoo's full name set (the
    ImageNet classifier ``fc1`` included), seeded, at scales that train:
    BN statistics and affine near 1 and 0 (``bn_data`` scales the input
    by 0.02), convs of variance 1/fan_in, each unit's conv3 a tenth."""
    import numpy as np
    import torch

    gen = torch.Generator().manual_seed(seed)
    named = {}

    def bn(scope, c):
        g = 0.02 if scope == "bn_data" else 1.0
        named[f"arg:{scope}_gamma"] = g * (1 + _randn(gen, (c,), 0.05))
        named[f"arg:{scope}_beta"] = _randn(gen, (c,), 0.05)
        named[f"aux:{scope}_moving_mean"] = _randn(gen, (c,), 0.05)
        named[f"aux:{scope}_moving_var"] = 1 + np.abs(_randn(gen, (c,), 0.1))

    def conv(name, shape, gain=1.0):
        fan_in = shape[1] * shape[2] * shape[3]
        named[f"arg:{name}_weight"] = _randn(gen, shape,
                                             gain / np.sqrt(fan_in))

    bn("bn_data", 3)
    conv("conv0", (64, 3, 7, 7))
    bn("bn0", 64)
    cin = 64
    for si, (units, f) in enumerate(zip((3, 4, 23, 3),
                                        (256, 512, 1024, 2048)), start=1):
        m = f // 4
        for u in range(1, units + 1):
            s = f"stage{si}_unit{u}"
            bn(f"{s}_bn1", cin)
            conv(f"{s}_conv1", (m, cin, 1, 1))
            bn(f"{s}_bn2", m)
            conv(f"{s}_conv2", (m, m, 3, 3))
            bn(f"{s}_bn3", m)
            conv(f"{s}_conv3", (f, m, 1, 1), 0.1)
            if u == 1:
                conv(f"{s}_sc", (f, cin, 1, 1))
            cin = f
    bn("bn1", 2048)
    named["arg:fc1_weight"] = _randn(gen, (1000, 2048), 0.01)
    named["arg:fc1_bias"] = np.zeros(1000, np.float32)
    return named


def torchvision_vgg16(seed: int) -> dict:
    """A torchvision VGG16 state_dict at full size (``classifier.6``,
    ImageNet's fc8, included), seeded, weights of variance 1/fan_in."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd, cin, idx = {}, 3, 0
    for n_convs, cout in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        for _ in range(n_convs):
            sd[f"features.{idx}.weight"] = torch.randn(
                (cout, cin, 3, 3), generator=gen) / (9 * cin) ** 0.5
            sd[f"features.{idx}.bias"] = torch.zeros(cout)
            cin, idx = cout, idx + 2
        idx += 1                                   # the max-pool
    for i, (cout, cin) in ((0, (4096, 512 * 7 * 7)), (3, (4096, 4096)),
                           (6, (1000, 4096))):
        sd[f"classifier.{i}.weight"] = torch.randn(
            (cout, cin), generator=gen) / cin ** 0.5
        sd[f"classifier.{i}.bias"] = torch.zeros(cout)
    return sd


def expected_graft(named: dict, network: str) -> dict:
    """The port's state_dict entries a weight file must set, by the
    layout rules written out here apart from ``utils/pretrained.py``:
    MXNet and torch keep conv kernels OIHW, so they land unchanged;
    ``stage4_*`` and the closing ``bn1`` are the per-ROI head's; fc6's
    inputs go from torchvision's CHW flatten to the NHWC one."""
    import torch

    out = {}
    if network == "vgg":
        convs = [f"conv{b}_{j}" for b, n in ((1, 2), (2, 2), (3, 3), (4, 3),
                                             (5, 3)) for j in range(1, n + 1)]
        feats = sorted({int(k.split(".")[1]) for k in named
                        if k.startswith("features.")})
        for idx, conv in zip(feats, convs):
            for leaf in ("weight", "bias"):
                out[f"backbone.{conv}.{leaf}"] = named[
                    f"features.{idx}.{leaf}"]
        w6 = named["classifier.0.weight"]
        out["head.fc6.weight"] = w6.reshape(4096, 512, 7, 7).permute(
            0, 2, 3, 1).reshape(4096, -1)
        out["head.fc6.bias"] = named["classifier.0.bias"]
        out["head.fc7.weight"] = named["classifier.3.weight"]
        out["head.fc7.bias"] = named["classifier.3.bias"]
        return out
    leaves = (("_moving_mean", "running_mean"), ("_moving_var", "running_var"),
              ("_gamma", "weight"), ("_beta", "bias"), ("_weight", "weight"))
    for key, arr in named.items():
        name = key.split(":", 1)[1]
        if name.startswith("fc1_"):
            continue
        suffix, leaf = next((s, t) for s, t in leaves if name.endswith(s))
        base = name[:-len(suffix)]
        if base.startswith("stage"):
            parts = base.split("_")
            base = "_".join(parts[:2]) + "." + "_".join(parts[2:])
        module = "head" if name.startswith(("stage4_", "bn1_")) else \
            "backbone"
        out[f"{module}.{base}.{leaf}"] = torch.from_numpy(arr)
    return out


@contextlib.contextmanager
def graft_checked(named: dict, network: str, into: dict):
    """Before ``train_net``'s loop starts, hold every ``backbone`` and
    ``head`` tensor of the state on the card against the file's array
    (``expected_graft``): all must be equal, and all must be covered."""
    import torch

    from mx_rcnn_tpu_torch.tools import train as train_cli

    real_fit = train_cli.fit
    want = expected_graft(named, network)

    def fit(state, *args, **kw):
        sd = state.model.state_dict()
        trunk = [k for k in sd if k.split(".")[0] in ("backbone", "head")]
        bad = [k for k, v in want.items()
               if not torch.equal(sd[k].cpu(), v.to(torch.float32))]
        into.update(checked=len(want), trunk=len(trunk), unequal=bad,
                    device=str(sd[trunk[0]].device))
        if bad or sorted(want) != sorted(trunk) or \
                sd[trunk[0]].device.type != "cuda":
            raise AssertionError(f"{network} graft: {len(bad)} tensors "
                                 f"differ from the file ({bad[:3]}), "
                                 f"{len(want)} of {len(trunk)} covered")
        return real_fit(state, *args, **kw)

    train_cli.fit = fit
    try:
        yield
    finally:
        train_cli.fit = real_fit


def imagenet_start(dev, card: str) -> dict:
    """``tools/train.py --network resnet101 --pretrained`` on a seeded
    zoo file, launches zeroed just before and read just after (the
    phase's main path), the graft held against the file on the card;
    ``tools/train_rpn.py --network vgg --pretrained`` on a seeded
    torchvision ``.pth``; a file missing one backbone array refused."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import train_rpn

    t0 = time.perf_counter()
    named = zoo_resnet101(seed=3)
    write_mxnet_params(LONG_DIR / "resnet-101-0000.params", named)
    make_s = time.perf_counter() - t0
    argv = ["--network", "resnet101", "--dataset", "PascalVOC",
            "--synthetic", "8", "--batch_images", "2", "--steps",
            str(LONG_STEPS), "--frequent", "1", "--seed", "0",
            "--pretrained", str(LONG_DIR / "resnet-101"),
            "--pretrained_epoch", "0"]
    graft = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with graft_checked(named, "resnet101", graft):
        final = _train_cli(argv, OUT_DIR / "long_pretrained.txt")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fp_launches()
    text = (OUT_DIR / "long_pretrained.txt").read_text()
    log(f"ImageNet start on {card}: tools/train.py --network resnet101 "
        f"--pretrained (a seeded {len(named)}-array zoo file, "
        f"{(LONG_DIR / 'resnet-101-0000.params').stat().st_size} bytes, "
        f"made in {make_s:.1f} s): {graft['checked']} of {graft['trunk']} "
        f"backbone and head tensors on {graft['device']} equal the file's "
        f"arrays before the first step; {LONG_STEPS} steps at batch 2 in "
        f"{wall:.2f} s, launches {launches}, final loss {final['loss']:.4f}")
    want = dict.fromkeys(("nms_sweep", "roi_align_fwd", "roi_align_bwd"),
                         LONG_STEPS)
    if launches != want or "grafted pretrained backbone" not in text or \
            not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"ImageNet start: launches {launches}, final "
                             f"{final}")
    resnet = dict(arrays=len(named), graft=graft, wall_s=wall,
                  launches=launches, final_metrics=final)

    sd = torchvision_vgg16(seed=4)
    pth = LONG_DIR / "vgg16.pth"
    torch.save(sd, pth)
    vgg_graft = {}
    out = OUT_DIR / "long_vgg_rpn.txt"
    t0 = time.perf_counter()
    with graft_checked(sd, "vgg", vgg_graft), open(out, "w") as f, \
            contextlib.redirect_stdout(f):
        vgg_final = train_rpn.main([
            "--network", "vgg", "--dataset", "PascalVOC", "--synthetic", "2",
            "--batch_images", "2", "--end_epoch", "1", "--lr", "1e-4",
            "--frequent", "1", "--seed", "0", "--prefix",
            str(LONG_DIR / "rpn"), "--pretrained", str(pth)])
    vgg_wall = time.perf_counter() - t0
    log(f"ImageNet start, VGG16: tools/train_rpn.py --pretrained (a seeded "
        f"torchvision .pth, {pth.stat().st_size} bytes): "
        f"{vgg_graft['checked']} of {vgg_graft['trunk']} tensors equal the "
        f"file's through the layout rules; 2 RPN steps in {vgg_wall:.2f} s, "
        f"final loss {vgg_final['loss']:.4f}")
    if not all(math.isfinite(v) for v in vgg_final.values()):
        raise AssertionError(f"VGG16 from the .pth: {vgg_final}")
    del sd

    partial = dict(named)
    partial.pop("arg:stage2_unit1_bn1_gamma")
    write_mxnet_params(LONG_DIR / "partial-0000.params", partial)
    try:
        _train_cli(argv[:-4] + ["--pretrained", str(LONG_DIR / "partial")],
                   OUT_DIR / "long_partial.txt")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a file missing a backbone array was grafted")
    if "backbone leaves" not in refused:
        raise AssertionError(f"the partial file failed otherwise: {refused}")
    log(f"a zoo file without stage2_unit1_bn1_gamma is refused: {refused}")
    return dict(resnet101=resnet, vgg16=dict(
        bytes=pth.stat().st_size, graft=vgg_graft, wall_s=vgg_wall,
        final_metrics=vgg_final), partial_refused=refused)


def snapshot_costs(dev, card: str) -> dict:
    """One ResNet-101 train state (random bf16 trace) saved through
    ``make_snapshotter`` with ``ft.async_snapshots`` on and off in turns:
    the step thread's time per snapshot (host copy and handoff) and the
    time to the manifest commit; every file byte-equal, also when the
    last (background) one sees the weights change as soon as
    ``save_epoch`` returns."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.ft.snapshot import make_snapshotter
    from mx_rcnn_tpu_torch.utils.checkpoint import make_topology

    cfg = generate_config("resnet101", "PascalVOC")
    state = train.setup_training(cfg, dev, seed=0, steps_per_epoch=8)
    gen = torch.Generator(device=dev).manual_seed(0)
    for t in state.optimizer.trace.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    state.optimizer.count = 8
    runs = []
    for i, mode in enumerate(("async", "sync", "sync", "async")):
        c = cfg.replace_in("ft", async_snapshots=mode == "async")
        snap = make_snapshotter(str(LONG_DIR / f"snap{i}" / "m"), c, 8,
                                make_topology(1, batch_images=2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = snap.save_epoch(1, state)
        stall = time.perf_counter() - t0
        if i == 3:       # the next step's in-place update, as early as it can
            with torch.no_grad():
                torch._foreach_add_(list(state.model.parameters()), 1.0)
        snap.flush()
        commit = time.perf_counter() - t0
        snap.close()
        runs.append(dict(mode=mode, stall_s=stall, commit_s=commit,
                         bytes=os.path.getsize(path), sha256=_sha256(path)))
        shutil.rmtree(LONG_DIR / f"snap{i}")
        log(f"snapshot {i + 1} ({mode}) of a ResNet-101 state on {card}: the "
            f"step thread {stall:.3f} s, the manifest committed after "
            f"{commit:.3f} s, {runs[-1]['bytes']} bytes")
    if len({r["sha256"] for r in runs}) != 1:
        raise AssertionError(f"snapshot bytes differ: {runs}")
    del state
    torch.cuda.empty_cache()
    return dict(runs=runs)


def schedule_checkpoints(schedule: dict) -> dict:
    """Phase 10's schedule, run with the default (background) snapshots,
    read for its checkpoint share (phase 13's record)."""
    ckpts = [w for w in schedule["checkpoints"] if "stall_s" in w]
    on_step = sum(w["stall_s"] + w.get("close_wait_s", 0.0) for w in ckpts)
    combine = sum(w["write_s"] for w in schedule["checkpoints"]
                  if "stall_s" not in w)
    writer = sum(w["write_s"] for w in ckpts)
    sched = dict(wall_s=schedule["wall_s"], stage_checkpoints=len(ckpts),
                 step_thread_stall_s=sum(w["stall_s"] for w in ckpts),
                 close_wait_s=sum(w.get("close_wait_s", 0.0) for w in ckpts),
                 writer_s=writer, combine_write_s=combine,
                 checkpoint_s_on_the_path=on_step + combine)
    log(f"phase 10's schedule with background snapshots: "
        f"{sched['wall_s']:.1f} s; its {len(ckpts)} stage checkpoints cost "
        f"the step thread {sched['step_thread_stall_s']:.3f} s of copies "
        f"and {sched['close_wait_s']:.3f} s of waiting at the stages' ends "
        f"(the writer {writer:.3f} s), the combined model's write "
        f"{combine:.3f} s: {sched['checkpoint_s_on_the_path']:.1f} s of "
        f"checkpoint time on the path")
    return sched


def _train_process(args, out: Path, timeout: int = 600):
    """``tools/train.py`` in a process of its own (TRAIN_PROCESS); its
    stdout and stderr go to ``out`` and ``out``.err."""
    res = subprocess.run([sys.executable, "-c", TRAIN_PROCESS, *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    out.write_text(res.stdout)
    out.with_suffix(".err").write_text(res.stderr)
    if res.returncode:
        raise AssertionError(f"{out.name}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    return res


def _start_process(cmd, out: Path, timeout: int = 600):
    """``cmd`` in a process of its own, started now, its stdout to ``out``
    and its stderr to ``out``.err; the returned function waits for it
    (killed past ``timeout`` s from its start) and gives its
    ``CompletedProcess`` and its seconds from its start to its exit."""
    t0 = time.perf_counter()
    fo, fe = open(out, "w"), open(out.with_suffix(".err"), "w")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=fo, stderr=fe, text=True)
    ended = []
    watcher = threading.Thread(
        target=lambda: ended.append((proc.wait(), time.perf_counter())),
        daemon=True)
    watcher.start()

    def wait():
        watcher.join(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        if not ended:
            proc.kill()
            watcher.join()
        fo.close()
        fe.close()
        return (subprocess.CompletedProcess(
            cmd, proc.returncode, out.read_text(),
            out.with_suffix(".err").read_text()), ended[0][1] - t0)

    return wait


def long_args(devkit) -> list:
    """The SIGTERM runs' ``tools/train.py`` arguments: ResNet-101 in bf16
    at batch 2 over the generated VOCdevkit, two epochs."""
    return ["--network", "resnet101", "--dataset", "PascalVOC",
            "--root_path", str(LONG_DIR), "--dataset_path", str(devkit),
            "--image_set", "2007_trainval", "--batch_images", "2", "--seed",
            "0", "--frequent", "1", "--end_epoch", "2"]


def sigterm_resume(card: str, devkit) -> dict:
    """ResNet-101 in bf16 at batch 2 over a generated VOCdevkit (16
    images, both buckets, and their flips: 16 steps an epoch), two epochs,
    each run in a process of its own: straight, and beside it one
    stopped by SIGTERM in the middle of epoch 1 (exit 0, an interrupt
    checkpoint with its data cursor); continued with ``--resume auto`` to
    the end, byte-equal to the straight run; beside that resume, a copy
    of the straight run's files with its newest epoch file corrupted,
    ``--resume auto`` on it, falling back to epoch 1 with a warning and
    ending byte-equal.  Its work is in those processes, so it runs
    :func:`in_background`; the devkit's roidb cache is written before
    (the two first runs would race to write it)."""
    import signal

    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    interrupt_path,
                                                    read_manifest)

    base = long_args(devkit)
    straight, prefix = str(LONG_DIR / "straight"), str(LONG_DIR / "run")
    wait_straight = _start_process(
        [sys.executable, "-c", TRAIN_PROCESS, *base, "--prefix", straight],
        OUT_DIR / "long_straight.txt")

    t0 = time.perf_counter()
    err_path = OUT_DIR / "long_sigterm.err"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, "-c", TRAIN_PROCESS, *base,
                                 "--prefix", prefix], cwd=REPO,
                                stdout=subprocess.PIPE, stderr=err_file,
                                text=True)
        lines, sent = [], None
        try:
            for line in proc.stdout:
                lines.append(line)
                if sent is None and line.startswith(
                        f"Epoch[1] Batch [{SIGTERM_AFTER}]"):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter()
            rc = proc.wait(timeout=300)
        finally:
            proc.kill()
            proc.wait()
    stop_s = time.perf_counter() - (sent or t0)
    err = err_path.read_text()
    (OUT_DIR / "long_sigterm.txt").write_text("".join(lines))
    manifest = read_manifest(interrupt_path(prefix)) or {}
    log(f"SIGTERM after step {16 + SIGTERM_AFTER + 1} (epoch 1, batch "
        f"{SIGTERM_AFTER}): exit {rc}, {stop_s:.2f} s from the signal to the "
        f"exit; interrupt manifest kind {manifest.get('kind')}, step "
        f"{manifest.get('step')}, cursor {manifest.get('data_cursor')}")
    if rc != 0 or sent is None or manifest.get("kind") != "interrupt" or \
            not 16 < manifest.get("step", 0) < 32 or \
            "data_cursor" not in manifest or \
            os.path.exists(checkpoint_path(prefix, 2)):
        raise AssertionError(f"the SIGTERM run: exit {rc}, manifest "
                             f"{manifest}\n{err[-3000:]}")

    def finished(wait, what: str):
        res, wall = wait()
        if res.returncode:
            raise AssertionError(f"{what}: exit {res.returncode}\n"
                                 f"{res.stderr[-3000:]}")
        return res, wall

    wait_resume = _start_process(
        [sys.executable, "-c", TRAIN_PROCESS, *base, "--prefix", prefix,
         "--resume", "auto"], OUT_DIR / "long_resume.txt")
    _, straight_s = finished(wait_straight, "the straight run")
    want = _sha256(checkpoint_path(straight, 2))
    # the fallback runs on a copy of the straight run's files (the same
    # names, so their manifests hold), beside the resume
    fb_dir = LONG_DIR / "fallback"
    fb_dir.mkdir()
    for f in glob.glob(f"{straight}-*"):
        shutil.copy(f, fb_dir)
    fb_prefix = str(fb_dir / Path(straight).name)
    path = checkpoint_path(fb_prefix, 2)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))
    wait_fallback = _start_process(
        [sys.executable, "-c", TRAIN_PROCESS, *base, "--prefix", fb_prefix,
         "--resume", "auto"], OUT_DIR / "long_fallback.txt")

    res, resume_s = finished(wait_resume, "the resumed run")
    got = _sha256(checkpoint_path(prefix, 2))
    log(f"--resume auto from the interrupt: {resume_s:.1f} s, epoch 2 "
        f"byte-equal to the straight run: {got == want}; interrupt file "
        f"removed: {not os.path.exists(interrupt_path(prefix))}")
    if got != want or "resumed mid-epoch from verified" not in res.stdout \
            or os.path.exists(interrupt_path(prefix)):
        raise AssertionError("the resumed run differs from the straight one")

    res, fallback_s = finished(wait_fallback, "the fallback run")
    again = _sha256(path)
    warned = "SKIPPING" in res.stderr and path in res.stderr
    log(f"epoch 2's file corrupted by one byte: --resume auto warned "
        f"{warned}, fell back to epoch 1 and ended byte-equal: "
        f"{again == want} ({fallback_s:.1f} s)")
    if not warned or again != want or \
            "resumed from verified" not in res.stdout:
        raise AssertionError("the fallback past a corrupt file failed")
    return dict(straight_s=straight_s, sigterm_exit=rc,
                signal_to_exit_s=stop_s, interrupt_manifest=manifest,
                resume_s=resume_s, fallback_s=fallback_s,
                byte_equal=True)


def resize_refused(devkit) -> str:
    """After :func:`sigterm_resume`: a resume of its run at batch 1 is
    refused (``tools/train.py``'s ``main`` here)."""
    args = long_args(devkit)[:-2] + [
        "--end_epoch", "3", "--batch_images", "1", "--prefix",
        str(LONG_DIR / "run"), "--resume", "auto"]
    try:
        _train_cli(args, OUT_DIR / "long_resize.txt")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a resume at batch 1 was admitted")
    if "effective global batch" not in refused:
        raise AssertionError(f"the resize failed otherwise: {refused}")
    log(f"a resume at batch 1 is refused: {refused[:160]}...")
    return refused


def accum_parity(dev) -> dict:
    """fp32 (TF32 off): one step of ``make_train_step(grad_accum=2)`` at
    batch 1 through the kernels and through the plain versions from the
    same weights and draws: each microbatch's sampled rois and labels
    equal, metrics within a relative 1e-4, each accumulated gradient's
    L2 difference within 1e-3 of its norm; then ``remat_backbone`` on
    and off: the gradients bit-equal."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train

    cfg = generate_config("resnet101", "PascalVOC",
                          network__compute_dtype="float32")
    mbs = [train.to_device(b, dev)
           for b in synthetic_train_batches(cfg, 1, 2)]
    draws = [lambda site, image, shape, i=i: fixed_draws(
        site, image + 10 * i, shape, dev) for i in range(2)]
    runs = {}
    for plain in (False, True):
        state = train.setup_training(cfg, dev, seed=1)
        step = train.make_train_step(cfg, grad_accum=2)
        targets = []
        with captured_targets(targets), (plain_versions() if plain
                                         else contextlib.nullcontext()):
            metrics = step(state, mbs, draws=draws)
        torch.cuda.synchronize()
        runs[plain] = (targets, {k: float(v) for k, v in metrics.items()},
                       {n: p.grad.clone() for n, p in
                        state.model.named_parameters() if p.grad is not None})
        del state
    (t_k, m_k, g_k), (t_p, m_p, g_p) = runs[False], runs[True]
    same = len(t_k) == len(t_p) == 2 and all(
        torch.equal(a.labels, b.labels) and torch.equal(a.rois, b.rois)
        for a, b in zip(t_k, t_p))
    loss_err = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                   for k in m_p)
    grad_err = {n: float((g_k[n] - g_p[n]).norm()
                         / g_p[n].norm().clamp_min(1e-30)) for n in g_p}
    worst = max(grad_err, key=grad_err.get)
    log(f"grad_accum 2 at batch 1, fp32: sampled rois and labels equal "
        f"through the kernels and the plain versions: {same}; worst "
        f"relative metric diff {loss_err:.2e} (rtol 1e-4); worst gradient "
        f"rel. L2 {grad_err[worst]:.2e} at {worst} (tol 1e-3)")
    if not same or g_k.keys() != g_p.keys() or loss_err > 1e-4 or \
            grad_err[worst] > 1e-3:
        raise AssertionError("the accumulating step differs between the "
                             "kernel and plain paths")
    del runs, g_k, g_p

    batch = train.to_device(synthetic_train_batches(cfg, 2, 1)[0], dev)
    grads = {}
    for remat in (False, True):
        c = cfg.replace_in("train", remat_backbone=remat)
        state = train.setup_training(c, dev, seed=1)
        total, _ = train.loss_and_metrics(
            state.model, batch, c,
            lambda site, image, shape: fixed_draws(site, image, shape, dev))
        total.backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        state.model.named_parameters() if p.grad is not None}
        del state, total
    diff = max(float((grads[False][n] - grads[True][n]).abs().max())
               for n in grads[False])
    equal = grads[False].keys() == grads[True].keys() and all(
        torch.equal(g, grads[True][n]) for n, g in grads[False].items())
    log(f"remat_backbone on and off, fp32 at batch 2: {len(grads[False])} "
        f"gradients bit-equal: {equal} (max abs diff {diff:.3e})")
    if not equal:
        raise AssertionError("remat changes the gradients")
    del grads
    torch.cuda.empty_cache()
    return dict(rois_and_labels_equal=same, worst_metric_rel_err=loss_err,
                worst_grad_rel_l2=grad_err[worst], worst_grad_tensor=worst,
                remat_grads_bit_equal=equal)


def accum_costs(dev, card: str) -> dict:
    """bf16: ms per optimizer step, peak memory and launches per step of
    batch 2 x accum 1, batch 1 x accum 2 and batch 2 with remat (8 timed
    steps after 2 of warm-up; the peak over the timed steps, and above
    what was allocated before them)."""
    import math

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core import train

    res = {}
    for label, batch, accum, remat in (("batch 2 x accum 1", 2, 1, False),
                                       ("batch 1 x accum 2", 1, 2, False),
                                       ("batch 2, remat", 2, 1, True)):
        cfg = generate_config("resnet101", "PascalVOC",
                              train__remat_backbone=remat)
        state = train.setup_training(cfg, dev, seed=0)
        step = train.make_train_step(cfg, grad_accum=accum)
        loaded = [train.to_device(b, dev)
                  for b in synthetic_train_batches(cfg, batch, 4)]
        inputs = (loaded if accum == 1 else
                  [loaded[i:i + accum] for i in range(0, len(loaded), accum)])
        for x in inputs[:2]:
            step(state, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        iters, losses = 8, []
        t0 = time.perf_counter()
        for i in range(iters):
            losses.append(step(state, inputs[i % len(inputs)])["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        launches = {k: v / iters for k, v in fp_launches().items()}
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [float(v) for v in losses]
        res[label] = dict(batch_images=batch, grad_accum=accum, remat=remat,
                          ms_per_step=ms, peak_gib=peak / 2 ** 30,
                          above_resident_gib=(peak - before) / 2 ** 30,
                          launches_per_step=launches, losses=losses)
        log(f"{label}, bf16 on {card}: {ms:.2f} ms per optimizer step, peak "
            f"{peak / 2 ** 30:.3f} GiB ({(peak - before) / 2 ** 30:.3f} above "
            f"the resident state), launches per step {launches}")
        if launches != dict.fromkeys(launches, float(accum)) or \
                len(launches) != 3 or \
                not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: launches {launches}, losses "
                                 f"{losses}")
        del state, step, loaded, inputs
        torch.cuda.empty_cache()
    return res


def long_run_checks(dev, card: str) -> dict:
    """Phase 13's legs that time nothing (see the module docstring): the
    SIGTERM runs' processes beside the ImageNet start and the
    accumulation parity; files under ``_chip/``, removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.tools.train import config_from_args, parse_args

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(LONG_DIR, ignore_errors=True)
    LONG_DIR.mkdir(parents=True)
    try:
        devkit = write_voc_devkit(LONG_DIR)
        load_gt_roidb(config_from_args(parse_args(long_args(devkit))),
                      training=True)
        runs = in_background(sigterm_resume, card, devkit)
        imagenet = imagenet_start(dev, card)
        done("ImageNet start")
        torch.backends.cudnn.deterministic = True
        parity = accum_parity(dev)
        torch.backends.cudnn.deterministic = False
        done("accumulation and remat parity")
        resume = runs()
        resume["resize_refused"] = resize_refused(devkit)
        done("SIGTERM and resume (the rest)")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(LONG_DIR, ignore_errors=True)
    return dict(imagenet=imagenet, resume=resume, accum_parity=parity,
                parts_s=parts)


def phase_long_run(dev, card: str, checks: dict) -> dict:
    """Phase 13 (see the module docstring): its timed legs, after
    :func:`long_run_checks` gave ``checks``; files under ``_chip/``,
    removed at the end.  Phase 10's schedule is read for its checkpoint
    share by :func:`schedule_checkpoints` where both lanes have ended."""
    t0 = time.perf_counter()
    parts = dict(checks["parts_s"])
    shutil.rmtree(LONG_DIR, ignore_errors=True)
    LONG_DIR.mkdir(parents=True)
    try:
        snapshots = snapshot_costs(dev, card)
        parts["snapshots"] = time.perf_counter() - t0
        costs = accum_costs(dev, card)
        parts["accumulation and remat costs"] = \
            time.perf_counter() - t0 - parts["snapshots"]
    finally:
        shutil.rmtree(LONG_DIR, ignore_errors=True)
    wall = sum(parts.values())
    log(f"phase 13 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(imagenet=checks["imagenet"], snapshots=snapshots,
                resume=checks["resume"], accum_parity=checks["accum_parity"],
                accum_costs=costs, parts_s=parts, wall_s=wall)


# ---- phase 14: data parallelism ----------------------------------------------

DP_DIR = REPO / "_chip" / "dp"       # the COCO tree, checkpoints, references
DP_TRAIN_IMAGES = 12       # train2017 images (and their flips)
DP_VAL_IMAGES = 15         # val2017 images: odd, so a split batch pads a row
DP_STEPS = 6               # timed optimizer steps of the two-rank rig
DP_SIGTERM_AT = 1          # the SIGTERM run's signal after Epoch[1] Batch [1]
DP_NETWORK = "resnet101"   # BASELINE.json's data-parallel config's model
DP_RIG = ("cuda:0", "cuda:0")  # the test rig's two ranks: one card twice
# tools/train.py's flags through its rank launcher (the path of
# train_net(num_devices=N)) over ranks named by the caller, in a process
# of its own with this script's algorithms (the test rig: two ranks on
# one card over gloo)
RIG_PROCESS = """
import sys, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from mx_rcnn_tpu_torch.tools import train as t
args = t.parse_args(sys.argv[2:])
with t.sigterm_stop_flag() as stop:
    t._launch_ranks(t.config_from_args(args), args.num_devices,
                    devices=sys.argv[1].split(","), backend="gloo",
                    prefix=args.prefix, end_epoch=args.end_epoch,
                    resume=args.resume, frequent=args.frequent,
                    seed=args.seed, grad_accum=args.grad_accum,
                    stop_flag=stop,
                    log=lambda line: print(line, flush=True))
"""
PATH_KERNELS = ("nms_sweep", "roi_align_fwd", "roi_align_bwd")


def fit_numbers(text: str, epoch: int, images: int) -> dict:
    """From a ``tools/train.py`` run's stdout at ``--frequent 1``: ms per
    optimizer step through ``fit`` (the stager, the collective stop and
    rank 0's snapshots inside), the median of ``images`` / samples per
    second over the Speedometer lines, one step each, of epochs
    ``epoch`` on, but each epoch's first (its loader's start and the
    previous epoch's end), host clock; and each rank's kernel launches
    over the whole run from the rank launcher's last line (None for a run
    without ranks)."""
    import ast
    import statistics

    speeds = [float(v) for e, b, v in re.findall(
        r"^Epoch\[(\d+)\] Batch \[(\d+)\] Speed: ([0-9.]+) samples/sec",
        text, re.M) if int(e) >= epoch and int(b) > 0]
    if not speeds:
        raise AssertionError(f"no Speedometer line past epoch {epoch}'s "
                             f"first")
    m = re.search(r"kernel launches (\[.*\])$", text, re.M)
    return dict(ms_per_step=statistics.median(images / v * 1e3
                                              for v in speeds),
                steps_timed=len(speeds),
                launches=[fp_only(d) for d in ast.literal_eval(m.group(1))]
                if m else None)


def check_launches(what: str, launches, ranks: int, steps: int) -> None:
    """Every rank launched K1, K2 and K3 once per step of the run."""
    want = [dict.fromkeys(PATH_KERNELS, steps)] * ranks
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")


def dp_config(**over):
    """ResNet-101, 81 COCO classes, 2 images per rank, bf16 (the preset),
    over the phase's COCO tree: BASELINE.json's data-parallel config at
    its widths."""
    from mx_rcnn_tpu_torch.config import generate_config

    return generate_config(DP_NETWORK, "coco", dataset__root_path=str(DP_DIR),
                           dataset__dataset_path=str(DP_DIR / "coco"),
                           train__batch_images=2, **over)


def dp_parity_rank(world, cfg, ref_path: str) -> dict:
    """Phase 14 step 1 on one rank of the two-rank rig: for the kernels
    and the plain versions, one fp32 step on this rank's image with the
    draws of its image in the world of one, held against that run's
    sampled rois and labels, metrics and gradients (``ref_path``); then
    two steps with the default draws and a SHA-256 of the state."""
    import torch

    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.parallel.dp import replicate

    dev = world.device
    ref = torch.load(ref_path)
    rows = train.to_device(train.Batch(*(
        x[world.rank:world.rank + 1].numpy() for x in ref["batch"])), dev)
    draws = lambda site, image, shape: fixed_draws(site, world.rank + image,
                                                   shape, dev)
    out = {}
    for plain in (False, True):
        state = train.setup_training(cfg, dev, seed=1)
        replicate(state.model, state.optimizer, world)
        step = train.make_train_step(cfg, world=world)
        targets = []
        with captured_targets(targets), (plain_versions() if plain
                                         else contextlib.nullcontext()):
            metrics = step(state, rows, draws=draws)
            torch.cuda.synchronize()
            want = ref["plain" if plain else "kernels"]
            same = (torch.equal(targets[0].labels.cpu(),
                                want["labels"][world.rank:world.rank + 1])
                    and torch.equal(targets[0].rois.cpu(),
                                    want["rois"][world.rank:world.rank + 1]))
            grad_err = {n: float((p.grad.cpu() - want["grads"][n]).norm()
                                 / want["grads"][n].norm().clamp_min(1e-30))
                        for n, p in state.optimizer.params}
            # num_fg is a sum over the batch: the world's mean of the
            # ranks' sums (the JAX pmean's) is the batch's sum / ranks
            scale = {"num_fg": world.size}
            metric_err = {k: abs(float(v) * scale.get(k, 1)
                                 - want["metrics"][k])
                          / max(abs(want["metrics"][k]), 1e-12)
                          for k, v in metrics.items()}
            for _ in range(2):
                step(state, rows)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        sd = state.model.state_dict()
        for k in sorted(sd):
            h.update(sd[k].detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        worst = max(grad_err, key=grad_err.get)
        out["plain" if plain else "kernels"] = dict(
            rois_and_labels_equal=same, worst_grad_rel_l2=grad_err[worst],
            worst_grad_tensor=worst,
            worst_metric_rel_err=max(metric_err.values()),
            state_sha256=h.hexdigest())
        del state, step
        torch.cuda.empty_cache()
    return out


def dp_parity(dev, card: str) -> dict:
    """Step 1 (fp32, TF32 off, deterministic cuDNN): the world of one
    steps 2 images here; the two-rank gloo rig on cuda:0 twice steps one
    image each with the same draws; through the kernels and the plain
    versions.  Rois and labels equal, averaged gradients within a
    relative L2 of 1e-4 of the world of one's per tensor, metrics within
    a relative 1e-4; both ranks' states bit-equal after 3 steps."""
    import torch

    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.parallel.dp import launch

    cfg = dp_config(network__compute_dtype="float32")
    batch = synthetic_train_batches(cfg, 2, 1)[0]
    ref = {"batch": [torch.from_numpy(x) for x in batch]}
    for plain in (False, True):
        state = train.setup_training(cfg, dev, seed=1)
        step = train.make_train_step(cfg)
        targets = []
        with captured_targets(targets), (plain_versions() if plain
                                         else contextlib.nullcontext()):
            metrics = step(state, train.to_device(batch, dev),
                           draws=lambda site, image, shape: fixed_draws(
                               site, image, shape, dev))
        torch.cuda.synchronize()
        ref["plain" if plain else "kernels"] = dict(
            labels=targets[0].labels.cpu(), rois=targets[0].rois.cpu(),
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.cpu() for n, p in state.optimizer.params})
        del state, step
    path = DP_DIR / "parity_ref.pt"
    torch.save(ref, path)
    del ref
    torch.cuda.empty_cache()
    ranks = launch(dp_parity_rank, 2, DP_RIG, "gloo",
                   args=(cfg, str(path)), timeout_s=600)
    path.unlink()
    for tag in ("kernels", "plain"):
        r0, r1 = (r[tag] for r in ranks)
        worst = max(r0["worst_grad_rel_l2"], r1["worst_grad_rel_l2"])
        metric = max(r0["worst_metric_rel_err"], r1["worst_metric_rel_err"])
        same = r0["rois_and_labels_equal"] and r1["rois_and_labels_equal"]
        bit_equal = r0["state_sha256"] == r1["state_sha256"]
        log(f"two ranks (gloo, cuda:0 twice; a test rig, not NCCL) against "
            f"the world of one, fp32, through the {tag}: sampled rois and "
            f"labels equal {same}; worst averaged-gradient rel. L2 "
            f"{worst:.2e} (tol 1e-4); worst metric rel. diff {metric:.2e} "
            f"(tol 1e-4); states bit-equal after 3 steps {bit_equal}")
        if not (same and bit_equal) or worst > 1e-4 or metric > 1e-4:
            raise AssertionError(f"two-rank parity through the {tag}: {r0} "
                                 f"{r1}")
    return dict(ranks=ranks)


def dp_rig_rank(world, cfg, roidb, load_image, accums, steps: int) -> list:
    """Step 3 on one rank, for each grad_accum in ``accums`` in turn on
    one state: the loader's row shard of the global plan, 2 warm-up and
    ``steps`` timed optimizer steps in bf16 (ms per step by the host
    clock around synchronised steps), the launches and peak memory over
    the timed steps, then the all-reduce alone on this step's gradients
    (ms by the host clock, 5 synchronised calls)."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.data.loader import StreamLoader
    from mx_rcnn_tpu_torch.parallel.dp import all_reduce_mean_, replicate

    dev = world.device
    state = train.setup_training(cfg, dev, seed=0, steps_per_epoch=1000)
    replicate(state.model, state.optimizer, world)
    loader = StreamLoader(roidb, cfg, load_image,
                          batch_images=world.size * cfg.train.batch_images,
                          seed=0, shard=(world.rank, world.size))
    out = []
    epoch = 0
    for grad_accum in accums:
        step = train.make_train_step(cfg, grad_accum=grad_accum, world=world)
        batches = []
        while len(batches) < (steps + 2) * grad_accum:
            loader.set_epoch(epoch)
            batches += [train.to_device(b, dev) for b in loader]
            epoch += 1
        groups = [batches[i * grad_accum:(i + 1) * grad_accum]
                  for i in range(steps + 2)]
        inputs = groups if grad_accum > 1 else [g[0] for g in groups]
        for x in inputs[:2]:
            step(state, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(state, x)["loss"] for x in inputs[2:]]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        launches = fp_launches()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        metrics = {"loss": losses[-1]}
        reduce_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            all_reduce_mean_(state.optimizer.params, metrics, world)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(dict(
            rank=world.rank, backend=world.backend, device=str(dev),
            grad_accum=grad_accum, ms_per_step=ms,
            all_reduce_ms=min(reduce_ms),
            # each trained gradient and the one metric, in fp32
            all_reduce_bytes=4 * (sum(p.numel() for _, p in
                                      state.optimizer.params) + 1),
            peak_gib=peak,
            launches_per_step={k: v / steps for k, v in launches.items()},
            losses=[float(v) for v in losses]))
    return out


def dp_rig(roidb, load_image, devices, backend: str, card: str,
           what: str) -> dict:
    """Step 3 (and 7): the rig of :func:`dp_rig_rank` at grad_accum 1
    then 2 in one world over ``devices``: K1 = K2 = K3 = grad_accum
    launches per optimizer step on every rank."""
    from mx_rcnn_tpu_torch.parallel.dp import launch

    accums = (1, 2)
    runs = launch(dp_rig_rank, len(devices), devices, backend,
                  args=(dp_config(), roidb, load_image, accums, DP_STEPS),
                  timeout_s=600)
    out = {}
    for i, accum in enumerate(accums):
        ranks = [r[i] for r in runs]
        for r in ranks:
            log(f"{what}: rank {r['rank']} of {len(devices)} on "
                f"{r['device']} ({card}), backend {r['backend']}, 2 images a "
                f"rank, grad_accum {accum}, bf16: {r['ms_per_step']:.2f} ms "
                f"per optimizer step; the all-reduce alone "
                f"{r['all_reduce_ms']:.2f} ms for {r['all_reduce_bytes']} "
                f"bytes; peak {r['peak_gib']:.3f} GiB; launches per step "
                f"{r['launches_per_step']}")
            if r["launches_per_step"] != dict.fromkeys(
                    PATH_KERNELS, float(accum)) or not all(
                        math.isfinite(v) for v in r["losses"]):
                raise AssertionError(f"{what}: rank {r}")
        out[f"grad_accum_{accum}"] = ranks
    return out


def dp_cli_argv() -> list:
    """Step 2's ``tools/train.py`` arguments, less the prefix."""
    return ["--network", DP_NETWORK, "--dataset", "coco", "--root_path",
            str(DP_DIR), "--dataset_path", str(DP_DIR / "coco"),
            "--batch_images", "2", "--no_flip", "--no_shuffle", "--seed",
            "0", "--frequent", "1", "--end_epoch", "1", "--num_devices", "1"]


def dp_cli_runs() -> dict:
    argv = dp_cli_argv()
    return {"nccl": argv + ["--prefix", str(DP_DIR / "nccl")],
            "nccl_cached": argv + ["--prefix", str(DP_DIR / "nccl_cached"),
                                   "--device_cache"]}


def dp_cli_start():
    """Step 2's process (:func:`dp_cli_world_of_one`), started now; the
    returned function waits for it."""
    runs = dp_cli_runs()
    return _start_process([sys.executable, "-c", TRAIN_TWICE_PROCESS,
                           *runs["nccl"], "--then", *runs["nccl_cached"]],
                          OUT_DIR / "dp_cli_nccl.txt")


def dp_cli_world_of_one(dev, card: str, started) -> dict:
    """Step 2: ``tools/train.py --num_devices 1`` streamed, then with
    ``--device_cache`` (one spawned rank each, NCCL at world size 1; the
    cached rank's row shard staged on the card), both in one process of
    their own (:data:`TRAIN_TWICE_PROCESS`, ``started`` by
    :func:`dp_cli_start`) over the COCO tree (no flips, no shuffle: one
    epoch at batch 2), and ``train_net`` here on the CLI's own config
    without the world, streamed and cached: each checkpoint, restored,
    byte-equal to its kind's end state (NCCL at world size 1, streamed
    and from the device cache)."""
    from mx_rcnn_tpu_torch.tools.train import (config_from_args, parse_args,
                                               train_net)
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    read_manifest)

    runs = dp_cli_runs()
    prefixes = {k: v[v.index("--prefix") + 1] for k, v in runs.items()}
    argv = dp_cli_argv()
    out = {}
    res, out["nccl_s"] = started()
    if res.returncode:
        raise AssertionError(f"the NCCL worlds of one: exit "
                             f"{res.returncode}\n{res.stderr[-3000:]}")
    texts = dict(zip(runs, res.stdout.split("\n--then\n")))
    cfg = config_from_args(parse_args(argv))
    want, plain = {}, {}
    t0 = time.perf_counter()
    for k in runs:   # each held against its own kind without the world
        lines = []
        state, _ = train_net(cfg, end_epoch=1, seed=0, device=dev,
                             frequent=1, device_cache=k == "nccl_cached",
                             log=lines.append)
        want[k], plain[k] = state_sha256(state), "\n".join(lines)
        del state
    out["plain_s"] = time.perf_counter() - t0
    equal = {k: checkpoint_state_sha256(cfg, p, 1, dev) == want[k]
             for k, p in prefixes.items()}
    (OUT_DIR / "dp_plain.txt").write_text("\n".join(plain.values()) + "\n")
    manifest = read_manifest(checkpoint_path(prefixes["nccl"], 1))
    fits = {**{f"plain_{k}": fit_numbers(plain[k], 0, 2) for k in runs},
            **{k: fit_numbers(texts.get(k, ""), 0, 2) for k in runs}}
    out.update(byte_equal=equal, steps=manifest["step"],
               topology=manifest["topology"], fit=fits)
    log(f"tools/train.py --num_devices 1 (NCCL, world of one, {card}), "
        f"streamed then --device_cache: {out['nccl_s']:.1f} s in a process "
        f"of their own (beside the phase's other processes), against "
        f"train_net here streamed and cached "
        f"{out['plain_s']:.1f} s, "
        f"{manifest['step']} steps; through fit "
        f"{fits['nccl']['ms_per_step']:.2f} streamed and "
        f"{fits['nccl_cached']['ms_per_step']:.2f} cached against "
        f"{fits['plain_nccl']['ms_per_step']:.2f} and "
        f"{fits['plain_nccl_cached']['ms_per_step']:.2f} ms per optimizer "
        f"step (median "
        f"of {fits['nccl']['steps_timed']}, the first step left out); "
        f"the ranks' launches {fits['nccl']['launches']} and "
        f"{fits['nccl_cached']['launches']}; end states byte-equal "
        f"{equal}; topology {manifest['topology']}")
    if not all(equal.values()) or \
            any("backend nccl" not in texts.get(k, "") for k in runs) or \
            "device cache:" not in texts["nccl_cached"] or \
            "device cache:" in texts["nccl"]:
        raise AssertionError(f"the NCCL worlds of one differ: "
                             f"{res.stdout[-3000:]}")
    for k in runs:
        check_launches(f"the NCCL world of one ({k})", fits[k]["launches"],
                       1, manifest["step"])
    return out


def checkpoint_state_sha256(cfg, prefix: str, epoch: int, dev) -> str:
    """:func:`state_sha256` of a checkpoint restored into a train state
    built from another seed."""
    from mx_rcnn_tpu_torch.core import train
    from mx_rcnn_tpu_torch.utils.checkpoint import restore_state

    state = train.setup_training(cfg, dev, seed=1)
    restore_state(state, prefix, epoch)
    sha = state_sha256(state)
    del state
    return sha


def dp_rig_args() -> list:
    """:data:`RIG_PROCESS`'s arguments for two ranks on cuda:0 over the
    COCO tree, two epochs at 2 images a rank."""
    return [",".join(DP_RIG), "--network", DP_NETWORK, "--dataset", "coco",
            "--root_path", str(DP_DIR), "--dataset_path",
            str(DP_DIR / "coco"), "--batch_images", "2", "--seed", "0",
            "--frequent", "1", "--end_epoch", "2", "--num_devices", "2"]


def dp_unbroken(prefix_u: str, card: str) -> dict:
    """The rig through ``tools/train.py``'s launcher and ``fit`` for two
    epochs (6 steps each at 4 images a step): ms per optimizer step over
    epoch 2, each rank's launches (K1 = K2 = K3 = steps); the reference of
    the resize and the SIGTERM resume."""
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    read_manifest)

    res = subprocess.run([sys.executable, "-c", RIG_PROCESS, *dp_rig_args(),
                          "--prefix", prefix_u], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    (OUT_DIR / "dp_unbroken.txt").write_text(res.stdout + res.stderr)
    if res.returncode:
        raise AssertionError(f"the unbroken two-rank run: "
                             f"{res.stderr[-3000:]}")
    steps = read_manifest(checkpoint_path(prefix_u, 2))["step"]
    fit = fit_numbers(res.stdout, 1, 4)
    log(f"two ranks through tools/train.py's launcher and fit (gloo, "
        f"cuda:0 twice; a test rig, its times are not NCCL's; beside the "
        f"phase's other processes; {card}), 2 "
        f"images a rank, bf16: {fit['ms_per_step']:.2f} ms per optimizer "
        f"step (median of epoch 2's {fit['steps_timed']} past its first); "
        f"launches per "
        f"rank over {steps} steps {fit['launches']}")
    check_launches("the unbroken two-rank run", fit["launches"], 2, steps)
    return dict(steps=steps, **fit)


def dp_sigterm(card: str) -> dict:
    """Step 5: the two-rank rig's launcher in a process of its own over
    the COCO tree, SIGTERM after ``Epoch[1] Batch [DP_SIGTERM_AT]``: exit
    0, both ranks ended at the same step, one interrupt checkpoint with
    ``topology.devices = 2``; then ``--resume auto`` in the same world to
    the end of epoch 2, held by :func:`dp_sigterm_equal` against the
    unbroken run.  Its work is in those processes: it runs
    :func:`in_background`."""
    import signal

    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    interrupt_path,
                                                    read_manifest)

    base = dp_rig_args()
    prefix = str(DP_DIR / "sig")
    err_path = OUT_DIR / "dp_sigterm.err"
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, "-c", RIG_PROCESS, *base,
                                 "--prefix", prefix], cwd=REPO,
                                stdout=subprocess.PIPE, stderr=err_file,
                                text=True)
        lines, sent = [], None
        try:
            for line in proc.stdout:
                lines.append(line)
                if sent is None and line.startswith(
                        f"Epoch[1] Batch [{DP_SIGTERM_AT}]"):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter()
            rc = proc.wait(timeout=300)
        finally:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    (OUT_DIR / "dp_sigterm.txt").write_text(text)
    manifest = read_manifest(interrupt_path(prefix)) or {}
    ended = _parse(r"ended at steps \[(\d+), (\d+)\]", text, "ranks' steps")
    steps = (int(ended.group(1)), int(ended.group(2)))
    stop_s = time.perf_counter() - (sent or t0)
    log(f"SIGTERM to the two-rank launcher (gloo, cuda:0 twice, {card}): "
        f"exit {rc}, {stop_s:.2f} s from the signal to the exit; ranks "
        f"ended at steps {steps}; interrupt manifest step "
        f"{manifest.get('step')}, topology {manifest.get('topology')}")
    if rc != 0 or sent is None or steps[0] != steps[1] or \
            manifest.get("step") != steps[0] or \
            (manifest.get("topology") or {}).get("devices") != 2 or \
            text.count("saved interrupt checkpoint") != 1:
        raise AssertionError(f"the SIGTERM run: exit {rc}\n{text[-2000:]}\n"
                             f"{err_path.read_text()[-2000:]}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", RIG_PROCESS, *base,
                          "--prefix", prefix, "--resume", "auto"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    (OUT_DIR / "dp_resume.txt").write_text(res.stdout + res.stderr)
    resume_s = time.perf_counter() - t0
    if res.returncode or \
            "resumed mid-epoch from verified" not in res.stdout:
        raise AssertionError(f"the resumed two-rank run:\n"
                             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return dict(exit=rc, signal_to_exit_s=stop_s, ranks_ended_at=steps,
                interrupt_manifest=manifest, resume_s=resume_s,
                prefix=prefix)


def dp_sigterm_equal(sig: dict, prefix_u: str) -> dict:
    """:func:`dp_sigterm`'s resumed epoch 2 byte-equal to the unbroken
    run ``prefix_u``'s."""
    from mx_rcnn_tpu_torch.utils.checkpoint import checkpoint_path

    got = _sha256(checkpoint_path(sig["prefix"], 2))
    want = _sha256(checkpoint_path(prefix_u, 2))
    log(f"--resume auto in the same world: {sig['resume_s']:.1f} s, epoch "
        f"2 byte-equal to the unbroken run {got == want}")
    if got != want:
        raise AssertionError("the resumed two-rank run differs from the "
                             "unbroken one")
    return dict(sig, byte_equal=True)


def dp_resize(dev, prefix_u: str) -> dict:
    """Step 4: epoch 1 of the two-rank run (global batch 4) resumed in a
    world of one at 2 images x grad_accum 2 (accepted, to the end of
    epoch 2), and at grad_accum 1 (refused)."""
    from mx_rcnn_tpu_torch.tools.train import train_net
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    manifest_path)

    # the same file names in a directory of their own (a manifest names
    # its file)
    (DP_DIR / "resize").mkdir()
    prefix = str(DP_DIR / "resize" / Path(prefix_u).name)
    src = checkpoint_path(prefix_u, 1)
    for path in (src, manifest_path(src)):
        shutil.copy(path, DP_DIR / "resize")
    lines = []
    t0 = time.perf_counter()
    state, metrics = train_net(dp_config(), prefix=prefix, resume="auto",
                               grad_accum=2, end_epoch=2, seed=0, device=dev,
                               log=lines.append)
    wall = time.perf_counter() - t0
    steps = state.step
    del state
    try:
        train_net(dp_config(), prefix=prefix, resume="auto", end_epoch=3,
                  device=dev, log=lines.append)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a resume at a global batch of 2 was admitted")
    log(f"epoch 1 of the two-rank run (global batch 4) resumed in a world "
        f"of one at 2 images x grad_accum 2: finished epoch 2 at step "
        f"{steps} in {wall:.1f} s, loss {metrics.get('loss', float('nan')):.4f}"
        f"; at grad_accum 1 refused: {refused[:120]}...")
    if "effective global batch 4" not in refused or \
            not math.isfinite(metrics.get("loss", float("nan"))):
        raise AssertionError(f"the resize: {refused}")
    return dict(steps=steps, wall_s=wall, refused=refused)


def rig_eval(cfg, prefix: str, dev, devices, dets: str) -> dict:
    """``tools/test.py — test_rcnn``'s steps (epoch 1 of ``prefix``) with
    its ``Predictor`` over ``devices`` as named: the rig names cuda:0
    twice, which ``--num_devices`` never does."""
    from mx_rcnn_tpu_torch.core.tester import Predictor, pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader
    from mx_rcnn_tpu_torch.utils.checkpoint import load_model

    imdb, roidb = load_gt_roidb(cfg, training=False)
    loader = TestLoader(roidb, cfg, imdb.load_image,
                        batch_images=cfg.test.batch_images * len(devices))
    predictor = Predictor(load_model(cfg, prefix, 1, dev), cfg, dev,
                          devices=devices)
    return pred_eval(predictor, loader, imdb, cfg, verbose=False,
                     save_dets=dets)


def dp_eval(dev, prefix: str, card: str) -> dict:
    """Step 6: ``tools/test.py``'s ``test_rcnn`` over the odd val2017 set
    at one image a device, split over cuda:0 twice and on one device: the
    detections and the COCO numbers equal; launches (K1 2 and K2 1 per
    slice, the pad slice's postprocess skipped)."""
    import pickle

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools.test import test_rcnn

    cfg = dp_config(test__batch_images=1)
    runs = {}
    for tag, devices in (("single", None), ("split", DP_RIG)):
        dets = str(DP_DIR / f"dets_{tag}.pkl")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with open(OUT_DIR / f"dp_eval_{tag}.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            results = (rig_eval(cfg, prefix, dev, devices, dets) if devices
                       else test_rcnn(cfg, prefix=prefix, epoch=1,
                                      device=dev, save_dets=dets))
        torch.cuda.synchronize()
        with open(dets, "rb") as f:
            boxes = pickle.load(f)["all_boxes"]
        runs[tag] = dict(results=results, launches=fp_launches(),
                         wall_s=time.perf_counter() - t0, boxes=boxes)
    # equal numbers, NaN (an area with no object) equal to NaN
    same = json.dumps(runs["single"]["results"], sort_keys=True) == \
        json.dumps(runs["split"]["results"], sort_keys=True) and all(
        a.tobytes() == b.tobytes()
        for ca, cb in zip(runs["single"]["boxes"], runs["split"]["boxes"])
        for a, b in zip(ca, cb))
    n = sum(len(a) for c in runs["split"]["boxes"][1:] for a in c)
    slices = 2 * -(-DP_VAL_IMAGES // 2)
    want = {"split": {"nms_sweep": slices + DP_VAL_IMAGES,
                      "roi_align_fwd": slices, "roi_align_bwd": 0},
            "single": {"nms_sweep": 2 * DP_VAL_IMAGES,
                       "roi_align_fwd": DP_VAL_IMAGES, "roi_align_bwd": 0}}
    log(f"tools/test.py's test_rcnn on {DP_VAL_IMAGES} COCO images, one a "
        f"device, split over cuda:0 twice ({card}) and on one device: "
        f"{n} detections and the COCO numbers equal {same}; launches split "
        f"{runs['split']['launches']}, single {runs['single']['launches']}; "
        f"AP {runs['split']['results'].get('AP', float('nan')):.4f}")
    if not same or n == 0 or any(runs[t]["launches"] != want[t]
                                 for t in want):
        raise AssertionError(f"the split eval: {runs['split']['results']} "
                             f"vs {runs['single']['results']}, launches "
                             f"{[runs[t]['launches'] for t in want]}")
    return {t: dict(results=r["results"], launches=r["launches"],
                    wall_s=r["wall_s"]) for t, r in runs.items()}


def dp_cards(roidb, load_image, card: str, eval_prefix: str,
             single_eval: dict):
    """Step 7, where the machine has two cards or more: the rig of step 3
    over NCCL on 2 cards and on min(count, 4); ``tools/train.py
    --num_devices N`` (N = min(count, 4)) for four epochs in a process
    of its own, its manifest recording N devices, ms per optimizer step
    through ``fit`` over epochs 2-4 (each epoch's first step left out)
    and each rank's launches (K1 = K2 = K3 = steps); and ``tools/test.py``'s ``test_rcnn --num_devices N`` over
    the odd val2017 set, equal to the one-device eval ``single_eval`` of
    step 6, with both walls.  On one card, one line says why it is not
    run."""
    import pickle

    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools.test import test_rcnn
    from mx_rcnn_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                    read_manifest)

    count = torch.cuda.device_count()
    if count < 2:
        log(f"NCCL across cards: not run — this machine has {count} card; "
            f"NCCL refuses two ranks on one card")
        return None
    n = min(count, 4)
    out = {}
    for k in sorted({2, n}):
        cards = [f"cuda:{i}" for i in range(k)]
        out[f"nccl_{k}"] = dp_rig(roidb, load_image, cards, "nccl", card,
                                  f"{k} ranks (NCCL, {k} cards)")
    prefix = str(DP_DIR / "cards")
    t0 = time.perf_counter()
    _train_process(["--network", DP_NETWORK, "--dataset", "coco",
                    "--root_path", str(DP_DIR), "--dataset_path",
                    str(DP_DIR / "coco"), "--batch_images", "2", "--seed",
                    "0", "--frequent", "1", "--end_epoch", "4",
                    "--num_devices", str(n), "--prefix", prefix],
                   OUT_DIR / "dp_cards_cli.txt")
    wall = time.perf_counter() - t0
    manifest = read_manifest(checkpoint_path(prefix, 4))
    text = (OUT_DIR / "dp_cards_cli.txt").read_text()
    fit = fit_numbers(text, 1, 2 * n)
    log(f"tools/train.py --num_devices {n} (NCCL, {n} cards, {card}): four "
        f"epochs, {manifest['step']} steps, in {wall:.1f} s; through fit "
        f"{fit['ms_per_step']:.2f} ms per optimizer step (median of "
        f"{fit['steps_timed']} past epoch 1, each epoch's first left out); "
        f"launches per rank {fit['launches']}; "
        f"topology {manifest['topology']}")
    if manifest["topology"]["devices"] != n or "backend nccl" not in text:
        raise AssertionError(f"the {n}-card CLI run: {text[-2000:]}")
    check_launches(f"the {n}-card CLI run", fit["launches"], n,
                   manifest["step"])
    out["cli"] = dict(cards=n, wall_s=wall, steps=manifest["step"],
                      topology=manifest["topology"], **fit)
    dets = str(DP_DIR / "dets_cards.pkl")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with open(OUT_DIR / "dp_eval_cards.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        results = test_rcnn(dp_config(test__batch_images=1),
                            prefix=eval_prefix, epoch=1,
                            device=torch.device("cuda", 0), num_devices=n,
                            save_dets=dets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fp_launches()
    with open(dets, "rb") as f:
        boxes = pickle.load(f)["all_boxes"]
    with open(DP_DIR / "dets_single.pkl", "rb") as f:
        want = pickle.load(f)["all_boxes"]
    same = json.dumps(results, sort_keys=True) == json.dumps(
        single_eval["results"], sort_keys=True) and all(
        a.tobytes() == b.tobytes()
        for ca, cb in zip(boxes, want) for a, b in zip(ca, cb))
    log(f"tools/test.py's test_rcnn --num_devices {n} (one image a card, "
        f"{n} cards, {card}) on {DP_VAL_IMAGES} COCO images: "
        f"{wall:.2f} s against {single_eval['wall_s']:.2f} s on one card; "
        f"detections and COCO numbers equal to one card's {same}; launches "
        f"{launches}")
    if not same:
        raise AssertionError(f"the {n}-card eval: {results} vs "
                             f"{single_eval['results']}")
    out["eval"] = dict(cards=n, wall_s=wall, single_wall_s=single_eval[
        "wall_s"], launches=launches, equal=same)
    return out


def dp_demo_start():
    """:func:`dp_demo`'s launcher run, ``tools/multihost_demo.py --launch
    N`` in a process of its own (the workers in theirs), started now."""
    import torch

    n = min(torch.cuda.device_count(), 4)
    return n, _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.multihost_demo",
         "--launch", str(n), "--steps", "2"], OUT_DIR / "dp_demo_run.txt")


def dp_demo(card: str, started) -> dict:
    """``tools/multihost_demo.py --launch N`` (``started`` by
    :func:`dp_demo_start`) on the cards (its default device; N = min(count,
    4), a world of one over NCCL on a machine of one card): exit 0, every
    worker's loss equal at each step, NCCL named; then one worker more
    than the machine has cards, refused before any worker starts (its
    ``main`` here)."""
    import torch

    from mx_rcnn_tpu_torch.tools import multihost_demo

    n, wait = started
    res, wall = wait()
    text = res.stdout
    run = dict(workers=n, exit=res.returncode, wall_s=wall)
    more = torch.cuda.device_count() + 1
    refused = ""
    try:
        multihost_demo.main(["--launch", str(more), "--steps", "2"])
    except RuntimeError as e:
        refused = str(e)
    log(f"tools/multihost_demo.py --launch {n} on the card(s) (NCCL, "
        f"{card}): exit {run['exit']} in {run['wall_s']:.1f} s, "
        f"{text.count('AGREE')} steps agreed (beside the phase's other "
        f"processes); --launch {more}: refused "
        f"({refused[:80]})")
    if run["exit"] or "MULTIHOST DEMO: OK" not in text or \
            "backend nccl" not in text or \
            "CUDA devices wanted" not in refused:
        raise AssertionError(f"the demo: {text[-3000:]} refused: {refused}")
    return dict(run=run, refused=dict(workers=more, error=refused))


DRYRUN_PROCESS = """
import json, sys, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from mx_rcnn_tpu_torch.parallel.dryrun import dryrun_multichip
res = dryrun_multichip(2, devices=sys.argv[1].split(","), backend="gloo")
print("DRYRUN " + json.dumps(res), flush=True)
"""


def dp_dryrun_start():
    """``dryrun_multichip(2)`` on the rig in a process of its own (its step
    of a world of one and its eval touch the card), started now."""
    return _start_process([sys.executable, "-c", DRYRUN_PROCESS,
                           ",".join(DP_RIG)], OUT_DIR / "dp_dryrun.txt")


def dp_dryrun(started) -> dict:
    """:func:`dp_dryrun_start`'s process: exit 0, its three OK lines."""
    res, wall = started()
    oks = [ln for ln in res.stdout.splitlines()
           if ln.startswith("dryrun_multichip(2): OK")]
    for ln in oks:
        log(ln)
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in res.stdout.splitlines()
            if ln.startswith("DRYRUN ")]
    log(f"dryrun_multichip(2) in a process of its own (beside the phase's "
        f"other processes): exit {res.returncode} in {wall:.1f} s")
    if res.returncode or len(oks) != 3 or not recs:
        raise AssertionError(f"dryrun_multichip(2): exit {res.returncode}\n"
                             f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return dict(recs[0], wall_s=wall)


def phase_data_parallel(dev, card: str) -> dict:
    """Phase 14 (see the module docstring), its files under ``_chip/dp``,
    removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.utils.checkpoint import load_state_dict, save_params

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        write_coco_tree(DP_DIR, seed=3, counts=(DP_TRAIN_IMAGES,
                                                DP_VAL_IMAGES))
        imdb, roidb = load_gt_roidb(dp_config(), training=True)
        log(f"phase 14: a COCO tree of {DP_TRAIN_IMAGES} train2017 and "
            f"{DP_VAL_IMAGES} val2017 480x640 JPEGs, {len(roidb)} training "
            f"records with flips; {torch.cuda.device_count()} card(s)")
        done("generate")
        # the legs whose work is in processes of their own start now and
        # run beside the parity and the rig (the roidb cache is written)
        prefix_u = str(DP_DIR / "unbroken")
        cli_started = dp_cli_start()
        unbroken_bg = in_background(dp_unbroken, prefix_u, card)
        sigterm_bg = in_background(dp_sigterm, card)
        demo_started = dp_demo_start()
        dry_started = dp_dryrun_start()
        parity = dp_parity(dev, card)
        done("parity")
        rig = dp_rig(roidb, imdb.load_image, DP_RIG, "gloo",
                     card, "two ranks (gloo, cuda:0 twice; a test rig, its "
                     "times are not NCCL's; beside the phase's other "
                     "processes)")
        done("two-rank rig")
        cli = dp_cli_world_of_one(dev, card, cli_started)
        done("NCCL world of one (the rest)")
        unbroken = unbroken_bg()
        done("unbroken two-rank run (the rest)")
        resize = dp_resize(dev, prefix_u)
        done("resize")
        sigterm = dp_sigterm_equal(sigterm_bg(), prefix_u)
        done("SIGTERM and resume (the rest)")
        state = load_state_dict(prefix_u, 2)
        state["cls_score.weight"] = state["cls_score.weight"] * \
            SERVE_CLS_SCALE
        save_params(str(DP_DIR / "scaled"), 1, state)
        del state
        evaluation = dp_eval(dev, str(DP_DIR / "scaled"), card)
        done("split eval")
        more = dp_cards(roidb, imdb.load_image, card,
                        str(DP_DIR / "scaled"), evaluation["single"])
        done("NCCL across cards")
        demo = dp_demo(card, demo_started)
        done("multihost demo (the rest)")
        dry = dp_dryrun(dry_started)
        done("dryrun_multichip (the rest)")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(DP_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 14 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(parity=parity, nccl_world_of_one=cli, gloo_rig=rig,
                unbroken=unbroken, resize=resize, sigterm=sigterm,
                split_eval=evaluation, nccl_cards=more, demo=demo,
                dryrun=dry, parts_s=parts, wall_s=wall)


CACHE_DIR = REPO / "_chip" / "cache"  # trees, the hard set, checkpoints
CACHE_TRAIN_IMAGES = 12    # train2017 480x640 JPEGs: 24 records, one bucket
CACHE_SIGTERM_AT = 5       # the SIGTERM run's signal after Epoch[1] Batch [5]
CACHE_TRACE_STEPS = 4      # step (d)'s traced steps: the third epoch's 5-8
# the rig's two ranks over gloo, in a process of their own: no argument
# of a spawned rank may be a closure, so the config travels as overrides
CACHE_OVER = dict(train__batch_images=2)


def cache_config(**over):
    """ResNet-101, 81 COCO classes, batch 2, bf16 with fp32 masters (the
    preset), over the phase's COCO tree."""
    from mx_rcnn_tpu_torch.config import generate_config

    return generate_config("resnet101", "coco",
                           dataset__root_path=str(CACHE_DIR),
                           dataset__dataset_path=str(CACHE_DIR / "coco"),
                           **{**CACHE_OVER, **over})


def state_sha256(state) -> str:
    """SHA-256 over every weight, buffer and momentum trace, in name
    order, and the step."""
    import torch

    h = hashlib.sha256()
    sd = state.model.state_dict()
    tensors = [sd[k] for k in sorted(sd)] + [
        state.optimizer.trace[k] for k in sorted(state.optimizer.trace)]
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    h.update(str(state.step).encode())
    return h.hexdigest()


def stage_epoch(dev, cfg, roidb, load_image) -> tuple:
    """Step (a): the training plan's epoch 0 staged on the card by
    ``build_caches``: its bytes, the memory it takes, the time."""
    import torch

    from mx_rcnn_tpu_torch.data.device_cache import build_caches
    from mx_rcnn_tpu_torch.data.loader import StreamLoader

    loader = StreamLoader(roidb, cfg, load_image, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    caches = build_caches(loader, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(caches) != 1:
        raise AssertionError(f"{len(caches)} buckets staged, want 1")
    cache = caches[0]
    images = cache.num_images * BUCKET[0] * BUCKET[1] * 3
    res = dict(batches=cache.num_batches, images=cache.num_images,
               nbytes=cache.nbytes, image_bytes=images,
               resident_bytes=torch.cuda.memory_allocated(dev) - before,
               peak_bytes=torch.cuda.max_memory_allocated(dev) - before,
               stage_s=wall)
    log(f"device cache: {cache.num_batches} batches of "
        f"{cache.batch_images} images staged on {dev} in {wall:.2f} s "
        f"(decode included): nbytes {cache.nbytes} ({images} of them "
        f"uint8 images), {res['resident_bytes']} bytes resident, peak "
        f"{res['peak_bytes']} above the start")
    if cache.num_batches != len(roidb) // 2 or \
            cache.data.images.dtype != torch.uint8 or \
            res["resident_bytes"] < cache.nbytes:
        raise AssertionError(f"the staged epoch: {res}")
    return cache, res


def flat_positions(cache, images) -> list:
    """The staged positions of ``images`` (a gathered batch's), each
    found by its bytes."""
    import torch

    flat = cache.data.images.flatten(0, 1)
    return [next(j for j in range(len(flat)) if torch.equal(flat[j], img))
            for img in images]


def cache_regroups(cache, make_step, epochs: int = 2) -> list:
    """Step (c), the gather: ``epochs`` epochs of the cached step at
    ``shuffle=True`` (seed 0) over ``cache`` with a step that records the
    staged positions of the images it is given.  Each epoch must take
    every staged image once; the batches' composition must change
    between epochs."""

    class Stub:
        step, seed = 0, 0

    seen = []

    def spy(stub, batch):
        seen.extend(flat_positions(cache, batch.images))
        stub.step += 1

    step = make_step(spy, cache)
    stub = Stub()
    for _ in range(epochs * cache.num_batches):
        step(stub, cache)
    n, bi = cache.num_images, cache.batch_images
    order = [seen[e * n:(e + 1) * n] for e in range(epochs)]
    comps = [{frozenset(o[i:i + bi]) for i in range(0, n, bi)}
             for o in order]
    if any(sorted(o) != list(range(n)) for o in order) or \
            len({frozenset(c) for c in comps}) != epochs:
        raise AssertionError(f"the shuffled gather: {order}")
    return order


def cache_train(cfg, dev, roidb, load_image, device_cache: bool,
                out: Path, epochs: int = 1):
    """``epochs`` epochs of ``train_net`` from seed 0 over ``roidb``,
    every launch count set to 0 just before: (final state's SHA-256,
    launches, log text)."""
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools.train import train_net

    lines = []
    kernels.reset_launch_counts()
    state, _ = train_net(cfg, roidb=roidb, load_image=load_image,
                         end_epoch=epochs, seed=0, device=dev, frequent=1,
                         device_cache=device_cache, log=lines.append)
    launches = fp_launches()
    sha = state_sha256(state)
    text = "\n".join(lines)
    out.write_text(text + "\n")
    return sha, launches, text


def cache_equals_streaming(dev, roidb, load_image, card: str) -> dict:
    """Step (b): one epoch at ``shuffle=False`` streamed and from the
    device cache, from one state and seed: the end states byte-equal,
    K1/K2/K3 once a cached step."""
    cfg = cache_config(train__shuffle=False)
    steps = len(roidb) // 2
    runs = {}
    for cached in (False, True):
        runs[cached] = cache_train(cfg, dev, roidb, load_image, cached,
                                   OUT_DIR / f"cache_b_{cached}.txt")
    equal = runs[True][0] == runs[False][0]
    log(f"one epoch of {steps} steps at shuffle=False ({card}), ResNet-101 "
        f"bf16, batch 2: cached end state byte-equal to streamed {equal} "
        f"(SHA-256 {runs[True][0][:16]}); cached launches {runs[True][1]}")
    if not equal:
        raise AssertionError("the cached epoch differs from the streamed one")
    check_launches("the cached epoch", [runs[True][1]], 1, steps)
    return dict(steps=steps, byte_equal=equal, sha256=runs[True][0],
                launches=runs[True][1])


def cache_sigterm(dev, roidb, load_image, card: str) -> dict:
    """Step (c), the runs: two epochs at ``shuffle=True`` from the cache,
    ``train_net`` here, then through ``tools/train.py`` in a process of
    its own, stopped by SIGTERM after ``Epoch[1] Batch
    [CACHE_SIGTERM_AT]`` (exit 0, an interrupt checkpoint), and its
    ``--resume auto`` to the end through ``main`` here: the checkpoint,
    restored, byte-equal to the end state here on the same config, so
    two cached runs of the shuffled gather end byte-equal too."""
    import signal

    from mx_rcnn_tpu_torch.tools.train import config_from_args, parse_args
    from mx_rcnn_tpu_torch.utils.checkpoint import (interrupt_path,
                                                    read_manifest)

    prefix = str(CACHE_DIR / "sig")
    base = ["--network", "resnet101", "--dataset", "coco", "--root_path",
            str(CACHE_DIR), "--dataset_path", str(CACHE_DIR / "coco"),
            "--batch_images", "2", "--seed", "0", "--frequent", "1",
            "--end_epoch", "2", "--device_cache", "--prefix", prefix]
    cfg = config_from_args(parse_args(base))
    if repr(cfg) != repr(cache_config()):
        raise AssertionError("the CLI's config is not the phase's")
    cached_sha, _, _ = cache_train(cfg, dev, roidb, load_image, True,
                                   OUT_DIR / "cache_c_here.txt", epochs=2)
    err_path = OUT_DIR / "cache_sigterm.err"
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen([sys.executable, "-c", TRAIN_PROCESS, *base],
                                cwd=REPO, stdout=subprocess.PIPE,
                                stderr=err_file, text=True)
        lines, sent = [], None
        try:
            for line in proc.stdout:
                lines.append(line)
                if sent is None and line.startswith(
                        f"Epoch[1] Batch [{CACHE_SIGTERM_AT}]"):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter()
            rc = proc.wait(timeout=300)
        finally:
            proc.kill()
            proc.wait()
    stop_s = time.perf_counter() - (sent or t0)
    (OUT_DIR / "cache_sigterm.txt").write_text("".join(lines))
    manifest = read_manifest(interrupt_path(prefix)) or {}
    if rc != 0 or sent is None or manifest.get("kind") != "interrupt" or \
            not 12 + CACHE_SIGTERM_AT < manifest.get("step", 0) < 24:
        raise AssertionError(f"the SIGTERM run: exit {rc}, manifest "
                             f"{manifest}\n{err_path.read_text()[-3000:]}")
    from mx_rcnn_tpu_torch.tools import train as train_tool

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_tool.main(base + ["--resume", "auto"])
    resume_s = time.perf_counter() - t0
    text = buf.getvalue()
    (OUT_DIR / "cache_resume.txt").write_text(text)
    got = checkpoint_state_sha256(cfg, prefix, 2, dev)
    log(f"SIGTERM to the cached run at shuffle=True ({card}) after "
        f"Epoch[1] Batch [{CACHE_SIGTERM_AT}]: exit {rc}, {stop_s:.2f} s "
        f"to the exit, interrupt at step {manifest['step']}; --resume auto "
        f"({resume_s:.1f} s): the end state byte-equal to the run here "
        f"{got == cached_sha}")
    if got != cached_sha or "resumed mid-epoch from verified" not in text \
            or "skipping" not in text:
        raise AssertionError("the resumed cached run differs from the "
                             "run here")
    return dict(sigterm_exit=rc, signal_to_exit_s=stop_s,
                interrupt_step=manifest["step"], resume_s=resume_s,
                byte_equal=True)


def h2d_copies(prof, iters: int) -> dict:
    """Host-to-device copies per step in a finished device trace: their
    count and their bytes (None where the trace gives none), from the
    exported Chrome trace."""
    path = CACHE_DIR / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    sizes = [e.get("args", {}).get("bytes") for e in events
             if "HtoD" in str(e.get("name", "")) and e.get("ph") == "X"
             and "memcpy" in str(e.get("cat", "")).lower()]
    nbytes = (sum(sizes) / iters
              if sizes and all(s is not None for s in sizes) else None)
    return dict(h2d_copies_per_step=len(sizes) / iters,
                h2d_bytes_per_step=nbytes,
                h2d_sizes=sorted(set(s for s in sizes if s is not None)))


def cache_run(cfg, dev, roidb, load_image, cached: bool, out: Path,
              label: str) -> dict:
    """Step (d), one run: three epochs of ``train_net`` over the COCO
    tree, cached or streamed, every launch count set to 0 just before;
    the second epoch timed as it runs (ms/step, images/s, data-wait
    share), the third's second Speedometer window (CACHE_TRACE_STEPS
    steps, the loader's start behind them) under a device-only profiler
    trace (device time, busy share, host-to-device copies per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools.train import train_net

    lines = []
    prof = profile(activities=[ProfilerActivity.CUDA])
    # the Speedometer restarts its clock after each line: the trace's
    # start is outside the window it opens
    opens = f"Epoch[2] Batch [{CACHE_TRACE_STEPS - 1}] "
    window = f"Epoch[2] Batch [{2 * CACHE_TRACE_STEPS - 1}] "

    def collect(line):
        lines.append(line)
        if line.startswith(opens):
            prof.start()
        elif line.startswith(window):
            # the window's metrics were read: its steps have ended
            torch.cuda.synchronize()
            prof.stop()

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    state, _ = train_net(cfg, roidb=roidb, load_image=load_image,
                         end_epoch=3, frequent=CACHE_TRACE_STEPS, seed=0,
                         device=dev, device_cache=cached, log=collect)
    launches = fp_launches()
    sha = state_sha256(state)
    del state
    train_s = time.perf_counter() - t0
    text = "\n".join(lines)
    out.write_text(text + "\n")
    warm = epoch_line(text, 1, label)
    m = _parse(re.escape(window) + r"Speed: ([0-9.]+) samples/sec, data "
               r"wait ([0-9.]+)%", text, f"{label} traced window")
    traced = dict(steps=CACHE_TRACE_STEPS,
                  ms_per_step=2e3 / float(m.group(1)),
                  data_wait_share=float(m.group(2)) / 100)
    trace = trace_summary(prof, traced["steps"])
    summary_s = time.perf_counter() - t0 - train_s
    copies = h2d_copies(prof, traced["steps"])
    copies_s = time.perf_counter() - t0 - train_s - summary_s
    res = dict(warm, traced_ms_per_step=traced["ms_per_step"],
               traced_data_wait_share=traced["data_wait_share"],
               device_ms_per_step=trace["device_ms_per_iter"],
               copy_ms_per_step=trace["copy_ms_per_iter"],
               busy_share=busy_share(trace, traced["ms_per_step"]),
               kernels_per_step=trace["kernels_per_iter"],
               launches=launches, sha256=sha, train_s=train_s,
               summary_s=summary_s, copies_s=copies_s, **copies)
    log(f"{label}: epoch 2 {res['ms_per_step']:.2f} ms/step, "
        f"{res['images_per_s']:.2f} images/s, data wait "
        f"{100 * res['data_wait_share']:.2f}%; {CACHE_TRACE_STEPS} steps "
        f"of epoch 3 traced: "
        f"{res['traced_ms_per_step']:.2f} ms/step, "
        f"{res['device_ms_per_step']:.3f} ms of device time a step, busy "
        f"share {res['busy_share']}, host-to-device copies a step "
        f"{res['h2d_copies_per_step']:.2f} ({res['h2d_bytes_per_step']} "
        f"bytes; sizes {res['h2d_sizes'][:8]}); launches {launches}; "
        f"{train_s:.1f} s training, {summary_s:.1f} s the trace's summary, "
        f"{copies_s:.1f} s its copies")
    return res


def cache_turns(dev, roidb, load_image, card: str) -> dict:
    """Step (d): a cached then a streamed run at ``shuffle=True``, with
    this phase's deterministic cuDNN: each run launches K1/K2/K3 once a
    step, and a cached step copies none of a batch's bytes from the host
    (the copies left are the step's own small constants, as in the
    streamed step).  That two cached runs end byte-equal is held by step
    (c)."""
    cfg = cache_config()
    steps = 3 * (len(roidb) // 2)
    g = cfg.train.max_gt_boxes
    # a batch's five tensors: images, im_info, gt boxes, classes, valid
    fields = {2 * BUCKET[0] * BUCKET[1] * 3, 2 * 3 * 4, 2 * g * 4 * 4,
              2 * g * 4, 2 * g}
    batch_bytes = sum(fields)
    runs = {}
    for i, cached in enumerate((True, False)):
        kind = "cached" if cached else "streamed"
        runs[kind] = cache_run(
            cfg, dev, roidb, load_image, cached,
            OUT_DIR / f"cache_turn_{i}_{kind}.txt",
            f"{kind} run {i} ({card}), ResNet-101 bf16 batch 2")
        check_launches(f"the {kind} run", [runs[kind]["launches"]], 1,
                       steps)
    c, s = runs["cached"], runs["streamed"]
    # the trace sees a streamed step's data copies, and a cached step
    # copies none of a batch's tensors: what it copies is the step's own
    # few constants (small tensors made from Python numbers), in both
    cached_n, streamed_n = c["h2d_copies_per_step"], s["h2d_copies_per_step"]
    cached_b = c["h2d_bytes_per_step"] or 0
    streamed_b = s["h2d_bytes_per_step"] or 0
    cached_sizes = set(c["h2d_sizes"])
    if not fields <= set(s["h2d_sizes"]) or \
            cached_sizes & fields or cached_b >= 1024:
        raise AssertionError(f"a cached step copies from the host: "
                             f"{cached_n} copies, {cached_b} bytes a step, "
                             f"sizes {sorted(cached_sizes)} (streamed "
                             f"{streamed_n}, {streamed_b}; a batch's "
                             f"tensors {sorted(fields)})")
    out = dict(runs=runs, batch_bytes=batch_bytes,
               cached_h2d_sizes=sorted(cached_sizes),
               cached_ms_per_step=c["ms_per_step"],
               streamed_ms_per_step=s["ms_per_step"],
               cached_data_wait=c["data_wait_share"],
               streamed_data_wait=s["data_wait_share"],
               cached_h2d_bytes_per_step=cached_b,
               streamed_h2d_bytes_per_step=streamed_b,
               cached_h2d_copies_per_step=cached_n,
               streamed_h2d_copies_per_step=streamed_n)
    log(f"cached against streamed ({card}): {out['cached_ms_per_step']:.2f} "
        f"against {out['streamed_ms_per_step']:.2f} ms/step, data wait "
        f"{100 * out['cached_data_wait']:.2f}% against "
        f"{100 * out['streamed_data_wait']:.2f}%, host-to-device copies a "
        f"step {cached_n:.2f} against {streamed_n:.2f}, bytes {cached_b} "
        f"against {streamed_b} (a batch: {batch_bytes})")
    return out


def cache_rig_rank(world, over: dict, roidb, load_image) -> dict:
    """Step (e) on one rank: ``train_net`` in this world for one epoch at
    ``shuffle=False``, streamed and cached (the final states' SHA-256 and
    the cached run's launches), then this rank's row shard staged at
    ``shuffle=True`` and two epochs of ``make_dp_cached_step`` over it
    with a recording step (the staged (index, flipped) identities each
    epoch took)."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.data.device_cache import build_caches
    from mx_rcnn_tpu_torch.data.loader import StreamLoader
    from mx_rcnn_tpu_torch.parallel.dp import make_dp_cached_step
    from mx_rcnn_tpu_torch.tools.train import train_net

    cfg = cache_config(**over)
    out = {"rank": world.rank, "device": str(world.device),
           "backend": world.backend}
    for cached in ((False, True) if world.size > 1 else (True,)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, _ = train_net(cfg.replace_in("train", shuffle=False),
                             world=world, roidb=roidb, load_image=load_image,
                             end_epoch=1, seed=0, device=world.device,
                             device_cache=cached, log=lambda line: None)
        out[f"cached_{cached}"] = dict(
            sha256=state_sha256(state), steps=state.step,
            launches=fp_launches(), wall_s=time.perf_counter() - t0)
        del state
    if world.size == 1:
        return out
    loader = StreamLoader(roidb, cfg, load_image,
                          batch_images=world.size * cfg.train.batch_images,
                          seed=0, shard=(world.rank, world.size))
    loader.record_decodes()
    (cache,) = build_caches(loader, device=world.device)
    order = cache_regroups(
        cache, lambda spy, c: make_dp_cached_step(spy, world, c, True))
    out["staged"] = list(loader.decoded_ids)
    out["epochs"] = [[out["staged"][j] for j in o] for o in order]
    return out


def cache_worlds(roidb, load_image, card: str) -> dict:
    """Step (e): the phase 14 rig (two ranks over gloo on cuda:0 twice)
    cached against streamed at ``shuffle=False`` (byte-equal states),
    each rank's ``shuffle=True`` epochs its own shard exactly once.  The
    NCCL world of one's cached run is held in phase 14
    (``dp_cli_world_of_one``).  The ranks are processes of their own and
    this process does no work on the card here, so it runs
    :func:`in_background`."""
    from mx_rcnn_tpu_torch.data.loader import StreamLoader
    from mx_rcnn_tpu_torch.parallel.dp import launch

    t0 = time.perf_counter()
    ranks = launch(cache_rig_rank, 2, DP_RIG, "gloo",
                   args=(CACHE_OVER, roidb, load_image), timeout_s=600)
    rig_s = time.perf_counter() - t0
    shas = {r[f"cached_{c}"]["sha256"] for r in ranks for c in (False, True)}
    steps = ranks[0]["cached_True"]["steps"]
    staged = [r["staged"] for r in ranks]
    own_once = all(sorted(e) == sorted(r["staged"])
                   for r in ranks for e in r["epochs"])
    # the union of the shards is epoch 0's global plan
    plan = StreamLoader(roidb, cache_config(), load_image, batch_images=4,
                        seed=0)._plan(0, 4)
    split = sorted(staged[0] + staged[1]) == sorted(
        (int(roidb[i]["index"]), bool(roidb[i]["flipped"]))
        for _, idx in plan for i in idx)
    launches = [r["cached_True"]["launches"] for r in ranks]
    log(f"two ranks over gloo on cuda:0 twice (a test rig; {card}), 2 "
        f"images a rank, {steps} steps at shuffle=False: cached world "
        f"byte-equal to the streamed world {len(shas) == 1}; at "
        f"shuffle=True each rank's epochs take its own {len(staged[0])} "
        f"staged images once {own_once}, the shards split the epoch "
        f"{split}; launches per rank {launches} ({rig_s:.1f} s)")
    if len(shas) != 1 or not own_once or not split:
        raise AssertionError(f"the cached rig: {ranks}")
    check_launches("the cached rig", launches, 2, steps)
    return dict(rig=ranks, rig_s=rig_s)


def cache_hard_cli(card: str) -> dict:
    """Step (f): ``tools/train.py --dataset synthetic_hard --device_cache
    --dataset_kw "{'num_images': 16}"``, its ``main`` in this process: 4
    ResNet-101 steps from the staged 240x320 bucket at phase 10's lr
    1e-4 (random weights), exit 0."""
    from mx_rcnn_tpu_torch.tools import train as train_tool

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_tool.main(
            ["--network", "resnet101", "--dataset", "synthetic_hard",
             "--root_path", str(CACHE_DIR), "--dataset_path",
             str(CACHE_DIR / "synthetic_hard"), "--dataset_kw",
             "{'num_images': 16}", "--device_cache", "--batch_images", "2",
             "--steps", "4", "--frequent", "1", "--lr", SCHEDULE_LR])
    text = buf.getvalue()
    (OUT_DIR / "cache_hard_cli.txt").write_text(text)
    wall = time.perf_counter() - t0
    staged = _parse(r"device cache: (\d+) batches of (\d+) images", text,
                    "device cache line")
    final = _parse(r"^final .*loss=([-0-9.naif]+)$", text.strip()
                   .splitlines()[-1], "final line")
    speeds = text.count(" Speed: ")
    log(f"tools/train.py --dataset synthetic_hard --device_cache ({card}): "
        f"{staged.group(1)} batches of {staged.group(2)} staged, {speeds} "
        f"steps, final loss {final.group(1)}, exit 0 in {wall:.1f} s")
    if staged.group(1) != "16" or speeds != 4 or \
            not math.isfinite(float(final.group(1))):
        raise AssertionError(f"the hard-set CLI run:\n{text[-2000:]}")
    return dict(wall_s=wall, batches=int(staged.group(1)), steps=speeds,
                final_loss=float(final.group(1)))


def cache_data_bench(card: str) -> dict:
    """Step (g): ``tools/data_bench.py --smoke --check`` on the card, in a
    process of its own; its record goes to the results."""
    t0 = time.perf_counter()
    record = OUT_DIR / "data_bench.json"
    res = subprocess.run(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.data_bench",
         "--smoke", "--check", "--root_path", str(CACHE_DIR), "--out",
         str(record)], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    (OUT_DIR / "data_bench.txt").write_text(res.stdout + res.stderr)
    if res.returncode:
        raise AssertionError(f"data_bench --smoke --check: exit "
                             f"{res.returncode}\n{res.stderr[-3000:]}")
    rec = json.loads(record.read_text())
    se = rec["stream_epoch"]
    log(f"tools/data_bench.py --smoke --check on {se['device']} ({card}): "
        f"exit 0 in {wall:.1f} s; streaming epoch {se['images']} images at "
        f"{se['imgs_per_sec']:.1f} images/s, stager hits "
        f"{se['stage']['hits']} / misses {se['stage']['misses']}, peak RSS "
        f"{se['peak_rss_mb']:.0f} MiB; control data wait p50 "
        f"{rec['control']['data_wait_frac_p50']}; checks {rec['checks']}")
    return dict(wall_s=wall, record=rec)


def phase_device_cache(dev, card: str) -> dict:
    """Phase 15 (see the module docstring), its files under
    ``_chip/cache``, removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.device_cache import make_cached_step

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    CACHE_DIR.mkdir(parents=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # seed 7: every image has a gt box, so 24 records, 12 steps
        write_coco_tree(CACHE_DIR, seed=7, counts=(CACHE_TRAIN_IMAGES, 1))
        imdb, roidb = load_gt_roidb(cache_config(), training=True)
        load_image = imdb.load_image
        cache, staged = stage_epoch(dev, cache_config(), roidb, load_image)
        order = cache_regroups(cache, lambda spy, c: make_cached_step(
            spy, c.num_batches, True))
        del cache
        torch.cuda.empty_cache()
        done("generate, stage, gather")
        plain = cache_equals_streaming(dev, roidb, load_image, card)
        done("cached = streamed")
        turns = cache_turns(dev, roidb, load_image, card)
        done("cached and streamed in turns")
        # the rig's ranks are processes of their own: beside the SIGTERM
        # leg, which times nothing
        worlds_bg = in_background(cache_worlds, roidb, load_image, card)
        sigterm = cache_sigterm(dev, roidb, load_image, card)
        done("SIGTERM and resume")
        worlds = worlds_bg()
        done("rig (the rest)")
        hard = cache_hard_cli(card)
        done("hard-set CLI")
        bench = cache_data_bench(card)
        done("data_bench")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(CACHE_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 15 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(staged=staged, shuffled_orders=order, cached_equals=plain,
                turns=turns, sigterm=sigterm, worlds=worlds, hard_cli=hard,
                data_bench=bench, parts_s=parts, wall_s=wall)


# ---- phase 16: quantized inference, the tenth main path -------------------

QUANT_DIR = REPO / "_chip" / "quant"     # the seeded checkpoint
QUANT_IMAGES = 16          # synthetic 375x500 images in the 608x1024 bucket
QUANT_BATCHES = 8          # eval batches of 2
QUANT_LAYERS_R101 = 104    # quantized convolutions per ResNet-101 forward
# K4 passes per ResNet-101 forward: one per frozen BN that feeds quantized
# convolutions (bn_data, and each of the 33 units' bn1, bn2, bn3), since
# K4 takes in the BN and ReLU; a projection unit's bn1 writes conv1's and
# the shortcut's inputs in one pass, so 100 passes serve 104 convolutions
K4_PASSES_R101 = 100
CALIB_BATCHES = 2          # quant__calibration_batches
# dense int8 and fp8 tensor-core rate of an H100 SXM (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12
# the shapes K5/K6 meet on the 608x1024 batch-2 ResNet-101 path, and
# VGG16's fc6 as a dense layer: (label, (n, h, w, cin), cout, kernel,
# stride, with bias)
QCONV_SHAPES = (
    ("conv0 7x7/2", (2, 608, 1024, 3), 64, 7, 2, False),
    ("stage1 1x1", (2, 152, 256, 256), 64, 1, 1, False),
    ("stage1 3x3", (2, 152, 256, 64), 64, 3, 1, False),
    ("stage3 3x3/2", (2, 76, 128, 256), 256, 3, 2, False),
    # stage 3's 23 units run these 1x1 layers 23 times a batch each, and
    # its first unit the 1x1/2 projection
    ("stage3 1x1 1024->256", (2, 38, 64, 1024), 256, 1, 1, False),
    ("stage3 1x1 256->1024", (2, 38, 64, 256), 1024, 1, 1, False),
    ("stage3 1x1/2 512->1024", (2, 76, 128, 512), 1024, 1, 2, False),
    ("stage4 roi 1x1", (600, 14, 14, 1024), 512, 1, 1, False),
    ("stage4 roi 3x3/2", (600, 14, 14, 512), 512, 3, 2, False),
    ("vgg fc6 dense", (600, 1, 1, 25088), 4096, 1, 1, True),
)
# the shape the kernels line reports K5 and K6 at (a library call exists)
QCONV_LINE_SHAPE = "stage4 roi 1x1"
# K4's shape without a BN: a stage-1 activation (2 x 256 x 152 x 256, bf16)
K4_SHAPE = (2, 152, 256, 256)
# the shape the kernels line reports K4 at: the per-ROI stage-4 unit 1's
# bn1, which writes conv1's and the shortcut's int8 inputs
K4_LINE_SHAPE = "stage4 bn1 600x1024x14x14 out2"


def quant_bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_inputs(dev, qmax: float, seed: int):
    """bf16 activations whose quotients by the unit hit exact .5 ties,
    land past +-qmax and spread at random, with the unit a power of two
    (the estimate is qmax * 2^-3), so every quotient is exact; a few
    are -0.0, NaN and -NaN."""
    import torch

    unit = 2.0 ** -3
    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(K4_SHAPE)
    x = torch.randn(n, generator=g, device=dev) * (qmax * unit * 0.6)
    ties = (torch.arange(-int(qmax) - 8, int(qmax) + 8, device=dev) + 0.5)
    x[:ties.numel()] = ties * unit
    x[ties.numel():ties.numel() + 64] = torch.linspace(
        -3 * qmax * unit, 3 * qmax * unit, 64, device=dev)
    x[-3:] = torch.tensor([-0.0, float("nan"), -float("nan")], device=dev)
    x = x.to(torch.bfloat16).view(K4_SHAPE[0], K4_SHAPE[3], K4_SHAPE[1],
                                  K4_SHAPE[2])
    # NCHW view of channels-last memory, as the backbone hands it over
    x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return x, torch.tensor(qmax * unit, device=dev)


def k4_launches(batch: int = 2, rois: int = 600, pooled: int = 14) -> dict:
    """Each distinct K4 launch of the quantized ResNet-101 forward at the
    608x1024 bucket (eval batch 2, 300 rois an image), as (label, NCHW
    shape, fp32 input, relu, outputs) -> launches a batch: conv0's
    bn_data on the fp32 image, then each unit's bn1 (two outputs in a
    projection unit), bn2 and bn3, the stride on conv2; stage 4 per ROI."""
    from mx_rcnn_tpu_torch.models.resnet import STAGE_UNITS

    seen = {((batch, 3) + BUCKET, True, False, 1): ["conv0 bn_data", 1]}
    h, w = BUCKET[0] // 4, BUCKET[1] // 4      # conv0 /2, max-pool /2
    cin = 64
    for s, (filters, stride, units) in enumerate(zip(
            (256, 512, 1024, 2048), (1, 2, 2, 2), STAGE_UNITS[101])):
        n = batch
        if s == 3:
            n, h, w = rois, pooled, pooled
        mid = filters // 4
        for u in range(units):
            st = stride if u == 0 else 1
            ho, wo = -(-h // st), -(-w // st)
            for label, shape, outs in (
                    ("bn1", (n, cin if u == 0 else filters, h, w),
                     2 if u == 0 else 1),
                    ("bn2", (n, mid, h, w), 1),
                    ("bn3", (n, mid, ho, wo), 1)):
                rec = seen.setdefault((shape, False, True, outs),
                                      [f"stage{s + 1}", 0])
                rec[0] += "" if label in rec[0] else f" {label}"
                rec[1] += 1
            h, w = ho, wo
        cin = filters
    out = {(name,) + key: count for key, (name, count) in seen.items()}
    if sum(out.values()) != K4_PASSES_R101:
        raise AssertionError(f"K4 table: {sum(out.values())} launches")
    return out


def k4_fused_case(dev, shape, fp32_in: bool, spec, seed: int,
                  specials: bool = True):
    """One fused K4 case on the card: a frozen BN with random statistics
    (shift -0.0 on every fourth channel), channels-last input (fp32 for
    conv0, else bf16), with ``specials`` NaN, -0.0 and values far past
    +-qmax at fixed strides, and two estimates: qmax * 2^-3 (a
    power-of-two unit: exact quotients, so the bf16 values give .5 ties)
    and one that is not.  Without ``specials`` (the timed inputs, as a
    calibrated model sees them) both estimates are of the second kind."""
    import torch

    from mx_rcnn_tpu_torch.models.layers import FrozenBatchNorm

    n, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    bn = FrozenBatchNorm(c, torch.bfloat16).to(dev)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 2.0, generator=g)
        bn.bias.uniform_(-1.0, 1.0, generator=g)
        bn.running_mean.uniform_(-1.0, 1.0, generator=g)
        bn.running_var.uniform_(0.2, 3.0, generator=g)
        bn.bias[1::4] = -0.0
        bn.running_mean[1::4] = 0.0
    x = torch.randn((n, h, w, c), generator=g, device=dev) * 4.0
    ests = (torch.tensor(spec.qmax * 0.0529, device=dev),
            torch.tensor(spec.qmax * 0.0371, device=dev))
    if specials:
        flat = x.view(-1)
        flat[::997] = float("nan")
        flat[1::89] = -0.0
        flat[2::101] = 3 * spec.qmax
        flat[3::103] = -3 * spec.qmax
        ests = (torch.tensor(spec.qmax * 2.0 ** -3, device=dev), ests[1])
    x = x.to(torch.float32 if fp32_in else torch.bfloat16).permute(0, 3, 1, 2)
    return bn, x, ests


def check_k4_fused(dev) -> dict:
    """K4 with the BN and ReLU before it, at each k4_launches shape, int8
    and fp8: bytes equal, each output, to the torch ops of the unfused
    forward (``FrozenBatchNorm`` on ``x.to(bf16)``, ``F.relu``,
    ``quantize_act_plain``), on inputs with the special values; then, on
    inputs without them (K4's division route is for the values near a
    rounding boundary, which those crowd), its time by CUDA events and in
    a CUDA graph beside its bound (bf16 or fp32 in, a byte out per
    output), and the plain version's; the per-batch sums weight each
    shape by its launches."""
    import torch
    import torch.nn.functional as F

    from mx_rcnn_tpu_torch.ops.quant import (QuantSpec, _unit,
                                             quantize_act_fused_cuda,
                                             quantize_act_plain)

    out = {}
    for dtype in ("int8", "fp8"):
        spec = QuantSpec(dtype=dtype)
        batch = dict(ms=0.0, graph_ms=0.0, bound_ms=0.0)
        for i, ((label, shape, fp32_in, relu, outs), count) in enumerate(
                k4_launches().items()):
            def fused():
                return quantize_act_fused_cuda(
                    x, units, spec, affine=bn.folded(),
                    dtype=torch.bfloat16, relu=relu)

            def plain():
                y = bn(x.to(torch.bfloat16))
                if relu:
                    y = F.relu(y)
                return [quantize_act_plain(y.permute(0, 2, 3, 1), e,
                                           spec)[0] for e in ests]

            bn, x, ests = k4_fused_case(dev, shape, fp32_in, spec, 200 + i)
            ests = ests[:outs] if outs == 2 else ests[i % 2:i % 2 + 1]
            units = [_unit(e, spec.qmax) for e in ests]
            with torch.no_grad():
                got, want = fused(), plain()
                torch.cuda.synchronize()
                for o, (a, b) in enumerate(zip(got, want)):
                    a = a.permute(0, 2, 3, 1).view(torch.uint8)
                    b = b.view(torch.uint8)
                    if not torch.equal(a, b):
                        bad = (a != b).nonzero()[:4].tolist()
                        raise AssertionError(
                            f"K4 {dtype} {label} {shape} output {o}: "
                            f"{int((a != b).sum())} bytes differ, first at "
                            f"{bad}: {a[tuple(zip(*bad))].tolist()} against "
                            f"{b[tuple(zip(*bad))].tolist()}")
                del got, want
                bn, x, ests = k4_fused_case(dev, shape, fp32_in, spec,
                                            300 + i, specials=False)
                ests = ests[:outs]
                units = [_unit(e, spec.qmax) for e in ests]
                elems = x.numel()
                ms = time_ms(fused, 10)
                dev_ms = graph_ms(fused, 10)
                plain_ms = time_ms(plain, 2, warmup=1)
            b_ms, b_by = quant_bound(elems * ((4 if fp32_in else 2) + outs), 0)
            key = f"{label} {'x'.join(map(str, shape))} out{outs}"
            out.setdefault(dtype, {})[key] = dict(
                shape=list(shape), outputs=outs, relu=relu,
                launches_per_batch=count, ms=ms, graph_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0.0)
            for k, v in (("ms", ms), ("graph_ms", dev_ms), ("bound_ms", b_ms)):
                batch[k] += count * v
            log(f"K4 fused {dtype} {key} x{count}: bytes equal to the unfused "
                f"torch ops (ties, -0.0, NaN, past +-qmax); {ms:.4f} ms, "
                f"{dev_ms:.4f} in a graph (plain "
                f"{plain_ms:.3f}, bound {b_ms:.4f} ms by {b_by})")
            del x, bn
        out.setdefault(dtype, {})["batch"] = batch
        log(f"K4 fused {dtype}: {K4_PASSES_R101} launches a batch sum to "
            f"{batch['ms']:.3f} ms by events, {batch['graph_ms']:.3f} in "
            f"graphs, bound {batch['bound_ms']:.3f} ms")
    return out


def check_k4(dev) -> dict:
    """K4 against its plain version, bytes equal: int8 at weight_bits 8
    and 4 and fp8, on bf16 and fp32 input, without a BN (VGG16's and the
    dense layers' path); then its time at the stage-1 activation; then
    :func:`check_k4_fused`."""
    import torch

    from mx_rcnn_tpu_torch.ops.quant import (QuantSpec, quantize_act_cuda,
                                             quantize_act_plain)

    out = {}
    for label, spec in (("int8 b8", QuantSpec()),
                        ("int8 b4", QuantSpec(weight_bits=4)),
                        ("fp8", QuantSpec(dtype="fp8"))):
        x, est = k4_inputs(dev, spec.qmax, seed=len(out))
        for dtype in (torch.bfloat16, torch.float32):
            xi = x.to(dtype)
            got, _ = quantize_act_cuda(xi, est, spec)
            want, _ = quantize_act_plain(xi, est, spec)
            torch.cuda.synchronize()
            if not xi.is_contiguous(memory_format=torch.channels_last) or \
                    not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError("K4 lost the channels-last layout")
            if not torch.equal(got.view(torch.uint8),
                               want.contiguous(
                                   memory_format=torch.channels_last)
                               .view(torch.uint8)):
                raise AssertionError(f"K4 {label} {dtype}: bytes differ")
        n = x.numel()
        ms = time_ms(lambda: quantize_act_cuda(x, est, spec), 20)
        plain_ms = time_ms(lambda: quantize_act_plain(x, est, spec), 5)
        b_ms, b_by = quant_bound(n * (2 + 1), 0)
        out[label] = dict(shape=list(K4_SHAPE), ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
        log(f"K4 {label}: bytes equal to the plain version on bf16 and "
            f"fp32 (ties, clipping); {n} bf16 elements in {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, bound {b_ms:.4f} ms by {b_by})")
    out["fused"] = check_k4_fused(dev)
    return out


def qconv_case(dev, spec, shape, cout: int, k: int, stride: int,
               bias: bool, seed: int):
    """Quantized operands of one QCONV_SHAPES case: bf16 activations
    through K4 against their absmax, fp32 weights with a per-channel
    spread through the plain weight quantizer, packed."""
    import torch

    from mx_rcnn_tpu_torch.ops.quant import (pack_weight, quantize_act,
                                             quantize_weight)

    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2).to(torch.bfloat16)
    wt = torch.randn((cout, c, k, k), generator=g, device=dev) * \
        torch.linspace(0.5, 2.0, cout, device=dev)[:, None, None, None]
    b = (torch.randn(cout, generator=g, device=dev) if bias else None)
    qx, x_unit = quantize_act(x, x.float().abs().max(), spec)
    qw, w_unit = quantize_weight(wt, spec)
    return qx, qw, pack_weight(qw), x_unit, w_unit, b


def qconv_pads(shape, k: int, stride: int):
    from mx_rcnn_tpu_torch.models.layers import same_pads

    return (same_pads(shape[1], k, stride), same_pads(shape[2], k, stride))


def qconv_sass(build_logs: dict) -> dict:
    """The wgmma instructions in the built K5 and K6 libraries (SASS
    GMMA lines, by cuobjdump) and any ptxas note that it serialized them;
    a library with none, or serialized, fails."""
    from mx_rcnn_tpu_torch import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    out = {}
    for kern in (kernels.QCONV_S8, kernels.QCONV_E4M3):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(kern.library_path())], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        gmma = [ln.split()[1] for ln in sass.splitlines() if "GMMA" in ln]
        serial = [ln.strip() for ln in build_logs[kern.name].splitlines()
                  if "serialized" in ln]
        kinds = sorted(set(g.split(".")[0] + "." + g.split(".")[1]
                           for g in gmma))
        log(f"{kern.name}: {len(gmma)} GMMA instructions in the SASS "
            f"({', '.join(kinds)}); ptxas serialization warnings: "
            + ("; ".join(serial) if serial else "none"))
        if not gmma or serial:
            raise AssertionError(f"{kern.name}: no wgmma in the SASS, or "
                                 f"ptxas serialized it")
        out[kern.name] = dict(gmma=len(gmma), kinds=kinds,
                              serialized=serial)
    return out


def check_qconv(dev, dtype: str) -> dict:
    """K5 (int8) or K6 (fp8) against the plain version at every
    QCONV_SHAPES case: K5 bit-equal in bf16 and fp32 output; K6 in fp32
    output within its bound, and its bf16 output bit-equal to its fp32
    output cast once (the epilogue's one rounding).  The bound: the plain
    version sums the e4m3 products exactly and rounds once; K6 sums 32 at
    a time on the tensor cores and adds those partial sums in fp32, so
    each accumulator may differ by K * 2^-24 of the sum of the |products|
    (K = kh*kw*cin), scaled by the units, and the rescale may round once
    more (2^-23 of the output).  Then each case's time, the plain
    version's, the bound and, for the 1x1 and dense cases, one library
    call's (torch._int_mm; torch._scaled_mm at unit scales); the kernel's
    and the library call's times also with no host time between calls
    (``graph_ms``: at the small shapes the host's launch path, not the
    card, sets ``time_ms``'s pace)."""
    import torch

    from mx_rcnn_tpu_torch.ops.quant import (QuantSpec, _accum_plain,
                                             _conv_nhwc, _epilogue,
                                             qconv_cuda)

    spec = QuantSpec(dtype=dtype)
    name = "K5" if dtype == "int8" else "K6"
    out = {}
    for i, (label, shape, cout, k, stride, bias) in enumerate(QCONV_SHAPES):
        qx, qw, packed, x_unit, w_unit, b = qconv_case(
            dev, spec, shape, cout, k, stride, bias, seed=100 + i)
        pads = qconv_pads(shape, k, stride)
        conv = ((stride, stride), pads)
        kdepth = k * k * shape[3]

        def run(out_dtype):
            return qconv_cuda(qx, packed, x_unit, w_unit, b, out_dtype,
                              (k, k), (stride, stride), pads)

        acc = _accum_plain(qx, qw, spec, conv)
        got32, got16 = run(torch.float32), run(torch.bfloat16)
        want32 = _epilogue(acc, x_unit, w_unit, b, torch.float32)
        torch.cuda.synchronize()
        err = (got32 - want32).abs()
        ratio = 0.0
        if dtype == "int8":
            want16 = _epilogue(acc, x_unit, w_unit, b, torch.bfloat16)
            if not (torch.equal(got32, want32) and
                    torch.equal(got16, want16)):
                raise AssertionError(
                    f"K5 {label}: not bit-equal, max |diff| fp32 "
                    f"{float(err.max())}, bf16 "
                    f"{float((got16.float() - want16.float()).abs().max())}")
        else:
            with torch.no_grad():
                abs_sum = _conv_nhwc(qx.to(torch.float64).abs(),
                                     qw.to(torch.float64).abs(), *conv)
                allow = (kdepth * 2.0 ** -24 * abs_sum
                         * (x_unit * w_unit).abs().double()
                         + 2.0 ** -23 * want32.double().abs() + 1e-30)
                ratio = float((err.double() / allow).max())
            if ratio > 1.0 or not torch.equal(got16, got32.to(torch.bfloat16)):
                raise AssertionError(
                    f"K6 {label}: fp32 error {float(err.max())} against its "
                    f"bound (worst ratio {ratio:.3f}), or bf16 output not "
                    f"the fp32 output cast once")
        del acc, got16
        n, h, w, c = shape
        m = got32.shape[0] * got32.shape[1] * got32.shape[2]
        ms = time_ms(lambda: run(torch.bfloat16), 10)
        plain_ms = time_ms(lambda: _epilogue(
            _accum_plain(qx, qw, spec, conv), x_unit, w_unit, b,
            torch.bfloat16), 2, warmup=1)
        b_ms, b_by = quant_bound(qx.numel() + packed.numel() + m * cout * 2,
                                 2.0 * m * cout * kdepth)
        dev_ms = graph_ms(lambda: run(torch.bfloat16), 10)
        lib_ms = lib_dev_ms = None
        if k == 1 and stride == 1:
            a2 = qx.reshape(m, c)
            bt = packed[:, :kdepth].contiguous().t()
            if dtype == "int8":
                def lib():
                    return torch._int_mm(a2, bt)
            else:
                one = torch.ones((), device=dev)

                def lib():
                    return torch._scaled_mm(a2, bt, scale_a=one, scale_b=one,
                                            out_dtype=torch.bfloat16)
            lib_ms = time_ms(lib, 10)
            lib_dev_ms = graph_ms(lib, 10)
        out[label] = dict(shape=list(shape), cout=cout, kernel=k,
                          stride=stride, pads=[list(p) for p in pads],
                          m=m, k=kdepth, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          graph_ms=dev_ms, library_graph_ms=lib_dev_ms,
                          max_abs_err=float(err.max()),
                          worst_bound_ratio=ratio)
        log(f"{name} {label} ({m}x{cout}x{kdepth}): "
            + ("bit-equal to the plain version in bf16 and fp32"
               if dtype == "int8" else
               f"fp32 max |err| {float(err.max()):.3g}, worst err/bound "
               f"{ratio:.3f}, bf16 = fp32 cast once")
            + f"; {ms:.4f} ms, {dev_ms:.4f} in a graph (plain "
              f"{plain_ms:.2f}, bound {b_ms:.4f} ms by {b_by}, library "
              + ("none" if lib_ms is None else
                 f"{lib_ms:.4f} ms, {lib_dev_ms:.4f} in a graph") + ")")
    return out


def check_sim_and_percentile(dev) -> dict:
    """The sim path (K4, then an fp32 convolution with TF32 off, whatever
    the global flag) bit-equal to native int8 (K4, K5) at a tile-level
    size, where every integer sum is exact in fp32 (3*3*8 * 127^2 < 2^24),
    with cuDNN's TF32 switched on around it; the dense pair likewise at
    K = 64.  Then the percentile estimator on a 19.9 M-element tensor
    against numpy's float64 percentile of the same values."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.ops.quant import QuantSpec, percentile, qconv, qdot

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 10, 12, 8), generator=g, device=dev) * 2
    w = torch.randn((16, 8, 3, 3), generator=g, device=dev)
    est = x.abs().max()
    xd = torch.randn((5, 64), generator=g, device=dev) * 3
    wd = torch.randn((7, 64), generator=g, device=dev)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        sim = qconv(x, w, est, QuantSpec(mode="sim"), (1, 1), "SAME")
        nat = qconv(x, w, est, QuantSpec(mode="native"), (1, 1), "SAME")
        sim_d = qdot(xd, wd, xd.abs().max(), QuantSpec(mode="sim"))
        nat_d = qdot(xd, wd, xd.abs().max(), QuantSpec(mode="native"))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = was
    if not (torch.equal(sim, nat) and torch.equal(sim_d, nat_d)):
        raise AssertionError(
            f"sim differs from native int8: conv max |diff| "
            f"{float((sim - nat).abs().max())}, dense "
            f"{float((sim_d - nat_d).abs().max())}")
    ax = torch.randn(math.prod(K4_SHAPE), generator=g, device=dev).abs()
    t0 = time.perf_counter()
    ours = float(percentile(ax, 99.9))
    pct_ms = (time.perf_counter() - t0) * 1e3
    ref = float(np.percentile(ax.cpu().numpy().astype(np.float64), 99.9))
    rel = abs(ours - ref) / ref
    # the fp32 index arithmetic (jnp.percentile's) against numpy's float64
    # one may pick neighbours one rank apart: ~1e-5 of the value here
    if not rel <= 5e-5:
        raise AssertionError(f"percentile {ours} against numpy {ref}")
    log(f"sim == native int8 bit for bit at 2x10x12x8 3x3 and 5x64 dense "
        f"with cuDNN TF32 on; percentile 99.9 over {ax.numel()} elements "
        f"{ours:.7f} against numpy float64 {ref:.7f} (relative "
        f"{rel:.2e}) in {pct_ms:.1f} ms")
    return dict(sim_equals_native=True, percentile=ours,
                percentile_numpy=ref, percentile_rel_err=rel,
                percentile_ms=pct_ms, elements=ax.numel())


def quant_checkpoint(dev, prefix: str) -> None:
    """A seeded ResNet-101 checkpoint whose every quantized layer has a
    non-zero kernel: the zero-initialised conv3 of each unit gets a
    normal draw (std 0.5 / sqrt(fan-in), keeping activations O(10)), and
    the classifier is scaled by SERVE_CLS_SCALE as in phase 11."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    cfg = generate_config("resnet101", "PascalVOC")
    model = build_model(cfg, dev, seed=0, train=True)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv3.weight"):
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        * (0.5 / math.sqrt(p.shape[1])))
        model.cls_score.weight.mul_(SERVE_CLS_SCALE)
    save_params(prefix, 1, model.state_dict())


def quant_eval_cli(prefix: str, tag: str, sets: list) -> dict:
    """``tools/test.py`` over QUANT_IMAGES synthetic images at batch 2
    with ``sets``, in-process, counts zeroed just before and read just
    after; its output to ``quant_<tag>.txt``."""
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import test as test_cli

    argv = ["--network", "resnet101", "--dataset", "PascalVOC", "--prefix",
            prefix, "--epoch", "1", "--synthetic", str(QUANT_IMAGES),
            "--set", "test__batch_images=2"]
    for s in sets:
        argv += ["--set", s]
    out = OUT_DIR / f"quant_{tag}.txt"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with open(out, "w") as f, contextlib.redirect_stdout(f):
        results = test_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    text = out.read_text()
    rate = re.search(r"pred_eval: \d+ images in ([0-9.]+) s, ([0-9.]+) "
                     r"images/s", text)
    fp = re.search(r"^quant calibration fingerprint: ([0-9a-f]{16})$", text,
                   re.M)
    if not re.search(r"^mAP = [0-9.]+$", text, re.M) or rate is None or \
            not math.isfinite(results["mAP"]):
        raise AssertionError(f"{tag}: no mAP or rate in {out}")
    return dict(argv=argv, results=results, wall_s=wall, launches=launches,
                fingerprint=fp.group(1) if fp else None,
                cli_images_per_s=float(rate.group(2)))


def quant_predictor_for(prefix: str, dev, sets: dict):
    """The eval path's predictor, built as tools/test.py builds it."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor, quant_predictor
    from mx_rcnn_tpu_torch.utils.checkpoint import load_model, load_state_dict

    cfg = generate_config("resnet101", "PascalVOC", test__batch_images=2,
                          **sets)
    if cfg.quant.enabled:
        return cfg, quant_predictor(cfg, load_state_dict(prefix, 1), dev,
                                    synthetic=QUANT_IMAGES)
    return cfg, Predictor(load_model(cfg, prefix, 1, dev), cfg, dev)


QUANT_ARMS = {
    "fp_bf16": {},
    "int8_native": {"quant__enabled": True},
    "fp8_native": {"quant__enabled": True, "quant__dtype": "fp8"},
    "int8_sim": {"quant__enabled": True, "quant__mode": "sim"},
}


def quant_want(arm: str) -> dict:
    """Each arm's launches over the eval CLI run: K1 twice and K2 once an
    eval batch, plus K1 and K2 once per calibration batch (the proposal
    forward; the calibration phase runs fp); K4 K4_PASSES_R101 times a
    batch (once per BN feeding quantized convolutions); K5 (int8 native)
    or K6 (fp8) once per quantized layer and batch; the sim arm's
    contraction is the fp32 one; K3 never."""
    calib = CALIB_BATCHES if arm != "fp_bf16" else 0
    per = QUANT_LAYERS_R101 * QUANT_BATCHES
    want = {"nms_sweep": 2 * QUANT_BATCHES + calib,
            "roi_align_fwd": QUANT_BATCHES + calib, "roi_align_bwd": 0,
            "quantize_act": (K4_PASSES_R101 * QUANT_BATCHES
                             if arm != "fp_bf16" else 0),
            "qconv_s8": per if arm == "int8_native" else 0,
            "qconv_e4m3": per if arm == "fp8_native" else 0}
    return want


def phase_quant_kernels(dev) -> dict:
    """Phase 16's kernels, run with the card to itself before the lanes
    start (main): K4-K6 against their plain versions at the path's shapes
    and timed, sim against native, the percentile."""
    t0 = time.perf_counter()
    out = dict(k4=check_k4(dev), k5=check_qconv(dev, "int8"),
               k6=check_qconv(dev, "fp8"), sim=check_sim_and_percentile(dev))
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_quant(dev, card: str, kern: dict) -> dict:
    """Phase 16: ``kern``, :func:`phase_quant_kernels`' record; then the
    quantized eval of a seeded ResNet-101 through tools/test.py (int8
    native, fp8 native, int8 sim, beside the fp bf16 eval), its launches,
    and each arm's steady images/s and device time in turns; then
    tools/quant_smoke.py --check on the card."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import pred_eval
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import TestLoader

    t0 = time.perf_counter()
    parts = {}
    k4, k5, k6, sim = kern["k4"], kern["k5"], kern["k6"], kern["sim"]
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    QUANT_DIR.mkdir(parents=True)
    try:
        prefix = str(QUANT_DIR / "m")
        quant_checkpoint(dev, prefix)
        runs = {}
        for arm, over in QUANT_ARMS.items():
            sets = [f"{k}={v}" for k, v in over.items()]
            run = quant_eval_cli(prefix, arm, sets)
            want = quant_want(arm)
            if run["launches"] != want:
                raise AssertionError(f"{arm}: launches {run['launches']}, "
                                     f"want {want}")
            if arm != "fp_bf16" and run["fingerprint"] is None:
                raise AssertionError(f"{arm}: no fingerprint line")
            runs[arm] = run
            log(f"tools/test.py {arm}: mAP {run['results']['mAP']:.4f} "
                f"(seeded weights: printed, not gated), fingerprint "
                f"{run['fingerprint']}, {run['cli_images_per_s']:.2f} "
                f"images/s (first call), launches {run['launches']}")
        parts["cli"] = time.perf_counter() - t0 - sum(parts.values())
        # steady eval in turns: fp, int8, fp8, sim
        imdb, roidb = load_gt_roidb(
            generate_config("resnet101", "PascalVOC"), training=False,
            synthetic=QUANT_IMAGES)
        steady = {arm: [] for arm in QUANT_ARMS}
        order = list(QUANT_ARMS)
        preds = {arm: quant_predictor_for(prefix, dev, over)
                 for arm, over in QUANT_ARMS.items()}
        for arm in order:
            cfg, pred = preds[arm]
            steady[arm].append(steady_eval(
                lambda: pred_eval(pred, TestLoader(roidb, cfg,
                                                   imdb.load_image),
                                  imdb, cfg, verbose=False),
                QUANT_IMAGES, QUANT_BATCHES, f"eval {arm} on {card}",
                k1_launches=2))
        del preds
        parts["steady"] = time.perf_counter() - t0 - sum(parts.values())
        engine = quant_engine(prefix, dev)
        parts["engine"] = time.perf_counter() - t0 - sum(parts.values())
        smoke = quant_smoke_on_card()
        parts["quant_smoke"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        shutil.rmtree(QUANT_DIR, ignore_errors=True)
    parts = {"kernels": kern["wall_s"], **parts}
    wall = time.perf_counter() - t0 + kern["wall_s"]
    for arm, recs in steady.items():
        log(f"phase 16 {arm} on {card}: images/s "
            f"{[round(r['images_per_s'], 3) for r in recs]}, device ms per "
            f"image {[round(r['device_ms_per_image'], 3) for r in recs]}, "
            f"K4 ms per batch {[round(r['k4_ms_per_batch'], 3) for r in recs]}"
            f", K5/K6 ms per batch "
            f"{[round(r['k5_k6_ms_per_batch'], 3) for r in recs]}, the rest "
            f"{[round(r['other_ms_per_batch'], 3) for r in recs]} ms (of it "
            f"elementwise "
            f"{[round(r['elementwise_ms_per_batch'], 3) for r in recs]}), device "
            f"ops a forward "
            f"{[round(r['device_ops_per_batch'], 1) for r in recs]}")
    log(f"phase 16 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(k4=k4, k5=k5, k6=k6, sim=sim, runs=runs, steady=steady,
                engine=engine, quant_smoke=smoke, parts_s=parts, wall_s=wall)


def quant_engine(prefix: str, dev) -> dict:
    """The int8 serving engine (``tools/serve.py``'s ``ServingEngine``
    on the quantized predictor, calibrated as phase 16's eval is) on one
    image per bucket: ``engine.detect`` equal bit for bit to the
    quantized offline batch on the same canvas, each with the same
    launches, K4 K4_PASSES_R101 and K5 QUANT_LAYERS_R101 for its one
    batch."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import quant_predictor
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.utils.checkpoint import load_state_dict

    cfg = generate_config("resnet101", "PascalVOC", quant__enabled=True)
    pred = quant_predictor(cfg, load_state_dict(prefix, 1), dev,
                           synthetic=QUANT_IMAGES)
    engine = ServingEngine(pred, cfg)
    images = request_images()
    rec = {}

    def counted(fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launch_counts()

    try:
        engine.warmup()
        for img in (images[0], images[-1]):
            got, served = counted(lambda: engine.detect(img))
            want, offline = counted(lambda: offline_detections(engine, img))
            bucket = "x".join(map(str, engine.preprocess(img)[2]))
            same = sorted(got) == sorted(want) and all(
                np.array_equal(got[c], want[c]) for c in want)
            n = sum(len(v) for v in want.values())
            if not same or served != offline or \
                    served["quantize_act"] != K4_PASSES_R101 or \
                    served["qconv_s8"] != QUANT_LAYERS_R101:
                raise AssertionError(
                    f"int8 engine bucket {bucket}: {n} detections, equal to "
                    f"the offline batch {same}; launches served {served}, "
                    f"offline {offline}")
            rec[bucket] = dict(detections=n, launches=served)
    finally:
        engine.close()
    log(f"int8 engine (quantized predictor, fingerprint "
        f"{pred.quant_fingerprint}): detect bit-equal to the quantized "
        f"offline batch on both buckets, "
        + ", ".join(f"{b}: {r['detections']} detections" for b, r in
                    rec.items())
        + f"; launches a batch equal, K4 {K4_PASSES_R101}, K5 "
          f"{QUANT_LAYERS_R101}")
    return rec


def quant_smoke_on_card() -> dict:
    """``tools/quant_smoke.py --check`` on the card (tiny network), its
    ``main`` in this process: exit 0, the export round trip and the
    store's admission refusals among its checks."""
    from mx_rcnn_tpu_torch.tools import quant_smoke

    out = OUT_DIR / "quant_smoke.txt"
    t0 = time.perf_counter()
    with open(out, "w") as f, contextlib.redirect_stdout(f):
        rc = quant_smoke.main(["--check", "--workdir",
                               str(QUANT_DIR / "smoke")])
    wall = time.perf_counter() - t0
    text = out.read_text()
    if rc != 0:
        raise AssertionError(f"quant_smoke --check exit {rc}: "
                             f"{text[-2000:]}")
    rec = json.loads(next(ln for ln in text.splitlines()
                          if ln.startswith('{"metric": "quant_smoke"')))
    log(f"tools/quant_smoke.py --check on the card: exit 0 in {wall:.1f} s; "
        f"mAP fp {rec['mAP_fp']}, int8 {rec['mAP_int8']}, red team "
        f"{rec['mAP_redteam_2bit']} (budget {rec['budget']}); the int8 "
        f"store bit-equal {rec['export_bit_equal']}, joined in "
        f"{rec['join']['total_s']} s, {rec['burst_served']} of 8 served "
        f"after it with {rec['post_join_builds']} builds; refuses an fp "
        f"config {rec['refuses_fp_config']} and another estimator "
        f"{rec['refuses_estimator_mismatch']}")
    return dict(wall_s=wall, record=rec)


# ---- phase 17: the observability plane, the eleventh main path ------------

OBS_DIR = REPO / "_chip" / "obs"     # run records, checkpoints
OBS_IMAGES = 8             # synthetic 375x500 images: 16 records, 8 steps
OBS_PROFILE_AT = 3         # the window opens after global step 3 ...
OBS_PROFILE_STEPS = 2      # ... and covers steps 4 and 5
OBS_SCRAPE_AFTER = "Epoch[1] Batch [1]"   # step 10: a snapshot committed
OBS_SIGTERM_AFTER = "Epoch[1] Batch [3]"  # after step 12: the interrupt
OBS_KERNEL_CLASSES = ("K1 nms_mask_kernel", "K1 nms_reduce_kernel",
                      "K2 roi_align_fwd_kernel",
                      "K3 roi_align_bwd_tables_kernel",
                      "K3 roi_align_bwd_kernel")
OBS_TURNS = 2              # obs-off/obs-on turns of the serving arms
OBS_STALL_S = 150          # the training run's longest silence


def _one(pattern: str, what: str) -> Path:
    found = sorted(Path(p) for p in glob.glob(pattern))
    if len(found) != 1:
        raise AssertionError(f"{what}: expected one match of {pattern}, "
                             f"got {found}")
    return found[0]


def step_windows(events: list, pid: int) -> list:
    """Each step's [train.dispatch start, train.sync end] in the merged
    trace's host spans of process ``pid`` (the fit loop logs every step,
    so each dispatch has its sync)."""
    host = sorted((e for e in events if e.get("pid") == pid
                   and e.get("ph") == "X"
                   and e.get("name") in ("train.dispatch", "train.sync")),
                  key=lambda e: e["ts"])
    windows, start = [], None
    for e in host:
        if e["name"] == "train.dispatch":
            start = e["ts"]
        elif start is not None:
            windows.append((start, e["ts"] + e["dur"]))
            start = None
    return windows


def device_events_in_steps(events: list, pid: int) -> dict:
    """Where each K1-K3 device event of the merged trace falls among the
    step windows: the windows holding any, the events in each class a
    window, and the events outside every window (with the distance to
    the nearest, in µs)."""
    from mx_rcnn_tpu_torch.obs.profiler import op_class

    windows = step_windows(events, pid)
    per_window: dict = {}
    outside = []
    for e in events:
        if not str(e.get("pid", "")).startswith("device:cuda"):
            continue
        cls = op_class(e.get("name", ""))
        if cls not in OBS_KERNEL_CLASSES:
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        hit = [i for i, (a, b) in enumerate(windows) if a <= t0 and t1 <= b]
        if hit:
            per_window.setdefault(hit[0], {}).setdefault(cls, 0)
            per_window[hit[0]][cls] += 1
        else:
            gap = min((max(a - t0, t1 - b, 0.0) for a, b in windows),
                      default=None)
            outside.append({"class": cls, "ts": t0, "gap_us": gap})
    return {"windows": len(windows), "per_window": per_window,
            "outside": outside}


def obs_training(card: str) -> dict:
    """``tools/train.py`` in a process of its own with the whole plane on
    and the strict lock sanitizer; scraped mid-run, stopped by
    SIGTERM."""
    import queue
    import signal
    import threading

    from mx_rcnn_tpu_torch.utils.checkpoint import (interrupt_path,
                                                    read_manifest)

    port = _free_port()
    runs = OBS_DIR / "runs"
    prefix = str(OBS_DIR / "train" / "e2e")
    argv = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train",
            "--network", "resnet101", "--dataset", "PascalVOC",
            "--synthetic", str(OBS_IMAGES), "--batch_images", "2",
            "--frequent", "1", "--end_epoch", "2", "--seed", "0",
            "--prefix", prefix,
            "--set", "obs__enabled=true", "--set", "obs__trace=true",
            "--set", "obs__timeseries=true", "--set", "obs__health=true",
            "--set", "obs__flight=true",
            "--set", f"obs__profile_at_step={OBS_PROFILE_AT}",
            "--set", f"obs__profile_steps={OBS_PROFILE_STEPS}",
            "--set", f"obs__metrics_port={port}",
            "--set", "obs__sample_interval_s=0.25",
            "--set", f"obs__run_dir={runs}"]
    # a stalled run dumps every thread's stack into its .err (SIGABRT
    # under the fault handler) and fails the phase, rather than the call
    env = dict(os.environ, MXRCNN_THREAD_SANITIZER="strict",
               PYTHONFAULTHANDLER="1")
    err_path = OUT_DIR / "obs_train.err"
    out_path = OUT_DIR / "obs_train.txt"
    scrape, sent, lines, rc = None, None, [], None
    t0 = time.perf_counter()
    with open(err_path, "w") as err_file, open(out_path, "w") as out_file:
        proc = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err_file)
        feed: "queue.Queue" = queue.Queue()

        def pump():
            for out_line in proc.stdout:
                feed.put(out_line)
            feed.put(None)

        threading.Thread(target=pump, daemon=True).start()
        try:
            while True:
                try:
                    line = feed.get(timeout=OBS_STALL_S)
                except queue.Empty:
                    proc.send_signal(signal.SIGABRT)
                    proc.wait(timeout=60)
                    raise AssertionError(
                        f"the observed training run printed nothing for "
                        f"{OBS_STALL_S} s after {len(lines)} lines "
                        f"({lines[-1:]}); its stacks:\n"
                        f"{err_path.read_text()[-6000:]}")
                if line is None:
                    break
                lines.append(line)
                out_file.write(line)
                out_file.flush()
                if scrape is None and line.startswith(OBS_SCRAPE_AFTER):
                    status, scrape = _http(
                        f"http://127.0.0.1:{port}/metrics", timeout=30)
                    if status != 200:
                        raise AssertionError(f"/metrics answered {status}")
                if sent is None and line.startswith(OBS_SIGTERM_AFTER):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter()
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    err = err_path.read_text()
    if rc != 0 or scrape is None or sent is None:
        raise AssertionError(f"the observed training run: exit {rc}, "
                             f"scraped {scrape is not None}, SIGTERM sent "
                             f"{sent is not None}\n{err[-3000:]}")
    # the mid-run scrape
    names = (set(scrape["counters"]) | set(scrape["gauges"])
             | set(scrape["hists"]))
    # (the epoch checkpoint's stall is the step thread's; its commit
    # may still be on the writer, so the summary's registry holds it)
    want = ("train.steps", "train.step_ms", "train.data_wait_ms",
            "train.samples_per_sec", "train.loss_ema", "loader.decode_ms",
            "loader.assemble_ms", "loader.queue_depth", "loader.stage_hits",
            "snapshot.stall_ms", "health.verdict")
    missing = [n for n in want if n not in names]
    if missing or "timeseries" not in scrape:
        raise AssertionError(f"mid-run /metrics lacks {missing} (time "
                             f"series {'timeseries' in scrape})")
    run = _one(str(runs / "train-*"), "the training run record")
    events = [json.loads(ln) for ln in
              (run / "events.jsonl").read_text().splitlines()]
    kinds = {e["event"] for e in events}
    if not {"run_start", "epoch_start", "log", "epoch_end", "snapshot",
            "interrupt", "run_finish"} <= kinds or not all(
                isinstance(e["ts"], float) for e in events):
        raise AssertionError(f"events.jsonl kinds {sorted(kinds)}")
    summary = json.loads((run / "summary.json").read_text())
    launches = summary["kernel_launches"]
    steps = summary["steps"]
    commits = summary["metrics"]["counters"].get("snapshot.commits")
    if summary["metric"] != "train_samples_per_sec" or \
            not summary["value"] or summary["obs_failures"] or \
            not 12 <= steps < 16 or commits != 2 or \
            fp_only(launches) != {k: steps for k in PATH_KERNELS}:
        raise AssertionError(f"summary.json: {summary['metric']} "
                             f"{summary['value']}, steps {summary['steps']}"
                             f", failures {summary['obs_failures']}, "
                             f"snapshot commits {commits}, launches "
                             f"{launches}")
    # the profiler window
    roll = json.loads((run / "profile" / "rollup.json").read_text())
    calls, ms = roll["op_class_calls"], roll["by_op_class"]
    bad = {c: (calls.get(c), ms.get(c)) for c in OBS_KERNEL_CLASSES
           if calls.get(c) != OBS_PROFILE_STEPS or not ms.get(c, 0) > 0}
    window = {k: v for k, v in roll["launch_counts"].items() if v}
    if bad or window != {k: OBS_PROFILE_STEPS for k in PATH_KERNELS}:
        raise AssertionError(f"rollup: kernel classes {bad}, launches in "
                             f"the window {window}")
    # host spans and device events on one clock
    merged = json.loads((run / "trace.json").read_text())["traceEvents"]
    pid = int(run.name.rsplit("-", 1)[1])
    placed = device_events_in_steps(merged, pid)
    counts = list(placed["per_window"].values())
    if placed["outside"] or len(counts) != OBS_PROFILE_STEPS or any(
            c != {k: 1 for k in OBS_KERNEL_CLASSES} for c in counts):
        raise AssertionError(f"device events against the step windows: "
                             f"{counts}, outside {placed['outside'][:5]} "
                             f"of {placed['windows']} windows")
    # SIGTERM: the flight dump and the step-exact interrupt checkpoint
    flight = json.loads(_one(str(run / "flight" / "*-sigterm" /
                                 "flight.json"), "the SIGTERM dump")
                        .read_text())
    manifest = read_manifest(interrupt_path(prefix)) or {}
    if flight["reason"] != "sigterm" or not flight["samples"] or \
            "train" not in flight["context"] or \
            manifest.get("kind") != "interrupt" or \
            manifest.get("step") != steps:
        raise AssertionError(f"flight dump {flight['reason']} with "
                             f"{len(flight['samples'])} samples, context "
                             f"{sorted(flight['context'])}; interrupt "
                             f"manifest {manifest}")
    report = [ln for ln in lines if ln.startswith("LOCKSAN_REPORT ")]
    locksan = json.loads(report[-1].split(" ", 1)[1]) if report else {}
    if not locksan.get("armed") or not locksan.get("strict") or \
            locksan.get("inversions") or locksan.get("watchdog_trips") or \
            not locksan.get("locks_wrapped"):
        raise AssertionError(f"LOCKSAN_REPORT {locksan}")
    k1 = ms["K1 nms_mask_kernel"] + ms["K1 nms_reduce_kernel"]
    k3 = ms["K3 roi_align_bwd_tables_kernel"] + ms["K3 roi_align_bwd_kernel"]
    w = OBS_PROFILE_STEPS
    log(f"obs training on {card}: {steps} steps, interrupt checkpoint at "
        f"step {steps}, exit {rc} {time.perf_counter() - sent:.2f} s after "
        f"SIGTERM ({wall:.1f} s in all); summary {summary['value']:.2f} "
        f"images/s; the window's device {roll['device_ms'] / w:.3f} ms a "
        f"step: K1 {k1 / w:.4f}, K2 "
        f"{ms['K2 roi_align_fwd_kernel'] / w:.4f}, K3 {k3 / w:.4f}, "
        + ", ".join(f"{c} {v / w:.3f}" for c, v in ms.items()
                    if not c.startswith("K")) + " ms; by scope "
        + ", ".join(f"{c} {v / w:.3f}"
                    for c, v in roll["by_scope"].items())
        + f"; every K1-K3 event inside its step's window; the strict lock "
        f"sanitizer: {locksan['locks_wrapped']} locks wrapped, no "
        f"inversion")
    return dict(wall_s=wall, sigterm_to_exit_s=time.perf_counter() - sent,
                summary={k: v for k, v in summary.items() if k != "metrics"},
                rollup=roll, placement=placed, locksan=locksan,
                flight={"reason": flight["reason"],
                        "samples": len(flight["samples"]),
                        "events": len(flight["events"])},
                interrupt_step=manifest.get("step"),
                scrape_names=sorted(names))


def obs_checkpoint(dev) -> str:
    """A seeded ResNet-101 checkpoint, its classifier scaled as phase
    11's (a seeded model otherwise answers background everywhere)."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    prefix = str(OBS_DIR / "serve" / "m")
    model = build_model(generate_config("resnet101", "PascalVOC"), dev,
                        seed=0, train=True)
    with torch.no_grad():
        model.cls_score.weight.mul_(SERVE_CLS_SCALE)
    save_params(prefix, 1, model.state_dict())
    return prefix


def sequential_detections(engine, images) -> tuple:
    """Each image alone in its batch; the detections and the launches."""
    from mx_rcnn_tpu_torch import kernels

    kernels.reset_launch_counts()
    dets = [engine.detect(img) for img in images]
    return dets, fp_launches()


def obs_serving(dev, prefix: str, card: str) -> dict:
    """``tools/serve.py``'s session in process, a traced concurrency-8
    HTTP burst, then each image served alone with the plane on and
    off."""
    import base64
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.obs import trace as obs_trace
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.server import make_server
    from mx_rcnn_tpu_torch.tools import serve as serve_tool
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    cfg = generate_config(
        "resnet101", "PascalVOC", obs__enabled=True, obs__trace=True,
        obs__timeseries=True, obs__health=True, obs__flight=True,
        obs__sample_interval_s=0.25, obs__trace_slow_pct=0.0,
        obs__run_dir=str(OBS_DIR / "runs"))
    images = request_images()
    predictor = init_predictor(cfg, prefix, 1, device=dev)
    obs_sess, metrics = serve_tool.open_obs(cfg)
    engine = ServingEngine(predictor, cfg, metrics=metrics)
    srv = None
    try:
        engine.warmup()
        serve_tool.watch_engine(obs_sess, engine)
        srv = make_server(engine, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        requests = [(i, images[i % len(images)]) for i in range(16)]

        def post(item):
            i, img = item
            headers = ({"X-MXR-Trace": f"v1;id=17.{i};parent=0;hop=0;s=1"}
                       if i % 2 == 0 else None)
            return _http(url + "/detect", {
                "pixels_b64": base64.b64encode(img.tobytes()).decode(),
                "shape": list(img.shape)}, headers=headers)

        engine.metrics.reset()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(post, requests))
        burst_s = time.perf_counter() - t0
        burst_launches = fp_launches()
        batches = engine.metrics.counters["batches"]
        failed = [i for i, (st, body) in enumerate(replies)
                  if st != 200 or not body.get("detections")]
        if failed or burst_launches != {"nms_sweep": 2 * batches,
                                        "roi_align_fwd": batches,
                                        "roi_align_bwd": 0}:
            raise AssertionError(f"burst: requests {failed} failed; "
                                 f"launches {burst_launches} in {batches} "
                                 f"batches")
        time.sleep(2 * cfg.obs.sample_interval_s)  # a sample past the burst
        status, health = _http(url + "/healthz")
        verdict = (health.get("health") or {}).get("verdict")
        status_m, snap = _http(url + "/metrics")
        if status != 200 or verdict != "OK" or status_m != 200 or \
                "registry" not in snap or \
                snap.get("timeseries", {}).get("samples", 0) < 2:
            raise AssertionError(f"/healthz {status} verdict {verdict}; "
                                 f"/metrics {status_m} keys {sorted(snap)}")
        trees = {t["trace"]: t for t in obs_trace.kept_trees()}
        audit = {}
        for i, _ in requests[::2]:
            spans = trees.get(f"17.{i}", {}).get("spans", [])
            names = [s["name"] for s in spans]
            audit[f"17.{i}"] = names
            if sum(n.startswith("terminal.") for n in names) != 1 or \
                    "terminal.served" not in names or \
                    "serve.request" not in names:
                raise AssertionError(f"trace 17.{i}: spans {names}")
        dets_on, launches_on = sequential_detections(engine, images)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        engine.close()
        serve_tool.close_obs(obs_sess, engine)
    summary = json.loads((Path(obs_sess.record.dir) / "summary.json")
                         .read_text())
    if summary["obs_failures"] or summary["value"] != \
            engine.metrics.counters["served"]:
        raise AssertionError(f"serve summary {summary['value']}, failures "
                             f"{summary['obs_failures']}")
    off_cfg = generate_config("resnet101", "PascalVOC")
    off = ServingEngine(predictor, off_cfg)
    try:
        off.warmup()
        dets_off, launches_off = sequential_detections(off, images)
    finally:
        off.close()
    same = all(sorted(a) == sorted(b) and all(
        np.array_equal(a[c], b[c]) for c in a)
        for a, b in zip(dets_on, dets_off))
    n = [sum(len(v) for v in d.values()) for d in dets_on]
    if not same or launches_on != launches_off or not all(n):
        raise AssertionError(f"plane on against off: bit-equal {same}, "
                             f"launches {launches_on} / {launches_off}, "
                             f"detections {n}")
    log(f"obs serving on {card}: 16 requests at concurrency 8 in "
        f"{burst_s:.3f} s, {batches} batches, launches {burst_launches}; "
        f"/healthz verdict {verdict}; 8 traced requests, one terminal span "
        f"each; alone with the plane on and off: bit-equal, launches "
        f"{launches_on}, detections {n}")
    return dict(burst_s=burst_s, batches=batches, launches=burst_launches,
                verdict=verdict, timeseries=snap["timeseries"],
                traced=audit, alone_launches=launches_on, detections=n)


def obs_overhead(dev, prefix: str, card: str) -> dict:
    """Obs-on against obs-off: training ms/step (a ``train_net`` run of 8
    steps at batch 2, the first 2 left out; off then on) and served
    images/s (a closed loop at concurrency 8 for 2 s on one engine an
    arm, in turns off, on, off, on).  On: spans, the registry, the
    sampler and the health rules (``tools/obs_smoke.py — ObsPlane``)."""
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.obs.metrics import ServeMetrics, registry
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.tools.loadgen import (init_predictor,
                                                 run_closed_loop)
    from mx_rcnn_tpu_torch.tools.obs_smoke import (ObsPlane, overhead_turns,
                                                   step_ms_of)

    def config(enabled: bool):
        return generate_config(
            "resnet101", "PascalVOC", obs__enabled=enabled,
            obs__trace=enabled, obs__timeseries=enabled,
            obs__health=enabled, obs__sample_interval_s=0.25,
            train__batch_images=2)

    def train_arm(enabled: bool):
        cfg = config(enabled)
        with ObsPlane(cfg, enabled):
            return step_ms_of(cfg, dev, skip=2, synthetic=4, end_epoch=2)

    train = overhead_turns(train_arm, 1)
    images = request_images()
    predictor = init_predictor(config(False), prefix, 1, device=dev)

    gc_log = []

    def serve_arm(enabled: bool):
        cfg = config(enabled)
        with ObsPlane(cfg, enabled):
            engine = ServingEngine(predictor, cfg, metrics=(
                ServeMetrics(registry=registry()) if enabled else None))
            try:
                engine.warmup()
                with gc_time() as spent:
                    run = run_closed_loop(engine, images, 2.0, 8, 0.0)
            finally:
                engine.close()
        served = max(run["client"]["ok"], 1)
        gc_log.append(dict(enabled=enabled, served=served, **spent))
        # ms an image, so that overhead_turns' sign is the slowdown's
        return [run["wall_s"] * 1e3 / served]

    serve = overhead_turns(serve_arm, OBS_TURNS)
    log(f"obs overhead on {card}, in turns: training ms/step off "
        f"{train['disabled_turns_ms_p50']} on "
        f"{train['enabled_turns_ms_p50']} (median "
        f"{train['disabled_ms_p50']:.3f} → {train['enabled_ms_p50']:.3f}, "
        f"{train['overhead_pct']:+.2f}%); "
        f"served images/s off "
        f"{[round(1e3 / v, 2) for v in serve['disabled_turns_ms_p50']]} on "
        f"{[round(1e3 / v, 2) for v in serve['enabled_turns_ms_p50']]}; "
        f"the loops' garbage collections: " + ", ".join(
            f"{'on' if g['enabled'] else 'off'} {g['ms']:.1f} ms in "
            f"{g['collections']}" for g in gc_log))
    return dict(train=train, serve=serve, serve_gc=gc_log,
                served_imgs_per_s={
                    "off": [1e3 / v for v in serve["disabled_turns_ms_p50"]],
                    "on": [1e3 / v for v in serve["enabled_turns_ms_p50"]]})


@contextlib.contextmanager
def gc_time():
    """The garbage collector's passes and ms while the block runs."""
    import gc

    spent = {"ms": 0.0, "collections": 0}
    t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            spent["ms"] += (time.perf_counter() - t0[0]) * 1e3
            spent["collections"] += 1

    gc.callbacks.append(on_gc)
    try:
        yield spent
    finally:
        gc.callbacks.remove(on_gc)


def phase_obs(dev, card: str) -> dict:
    """Phase 17: the plane on the training CLI, the serving session and
    the overhead turns, under the ignored ``_chip/obs/``, removed at the
    end."""
    t0 = time.perf_counter()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    try:
        training = obs_training(card)
        prefix = obs_checkpoint(dev)
        serving = obs_serving(dev, prefix, card)
        overhead = obs_overhead(dev, prefix, card)
    finally:
        shutil.rmtree(OBS_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 17 took {wall:.1f} s")
    return dict(training=training, serving=serving, overhead=overhead,
                wall_s=wall)


# ---- phase 18: bulk scoring over an export-warmed engine ---------------------

BULK_DIR = REPO / "_chip" / "bulk"   # the tree, checkpoint, store, sinks
BULK_IMAGES = 20           # val2017 JPEGs, 480x640 and 640x480 in turns
BULK_KILL_AT = 2           # the killed run's SIGKILL after shard 2 commits
# the rate pass: the corpus listed this many times over (320 entries),
# bulk.shard_batches at its default, so the steady state outweighs the
# loader's start and the tail batches
BULK_RATE_REPEAT = 16
BULK_KILLED = BULK_DIR / "killed.exited"   # the killed run's process ended
BULK_MODEL = "bulk@1"      # the sinks' weights identity
# seeded weights spread a ROI's scores over 81 classes (phase 11's scaled
# classifier): a floor under serve.score_thresh's 0.05 keeps detections
# on every image to compare
BULK_SCORE_THRESH = 0.01
# a child of phase 18: the package from the first path (a copy whose
# _build/ starts empty), chip_smoke from the second
BULK_CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; "
              "import chip_smoke; sys.exit(chip_smoke.bulk_child(sys.argv[3]))")


def bulk_config(**over):
    """ResNet-101, 81 COCO classes, bf16, the serving defaults (batch 4)
    but a score floor of BULK_SCORE_THRESH, one plan batch a shard, over
    phase 18's tree."""
    from mx_rcnn_tpu_torch.config import generate_config

    return generate_config(
        "resnet101", "coco", dataset__root_path=str(BULK_DIR),
        dataset__dataset_path=str(BULK_DIR / "coco"),
        **{"serve__score_thresh": BULK_SCORE_THRESH,
           "bulk__shard_batches": 1, **over})


def bulk_child(mode: str) -> int:
    """One process of phase 18 over a copy of the package: the predictor
    from the store's weights, ``warm_from_export`` into an empty
    ``_build/`` (its join record printed at once), then ``kill``: the
    corpus into the killed sink, SIGKILLed after shard BULK_KILL_AT
    commits; or ``full``: the control run (every launch count set to 0
    just before, read just after, with the engine's batches), the killed
    sink's resume, a closed loop of 8 clients over the same engine (4 s)
    and the rate pass (the corpus BULK_RATE_REPEAT times over, 16 plan
    batches a shard): one BULK_RESULT line.  The full run starts beside
    the killed one and resumes its sink once BULK_KILLED exists."""
    import signal

    import numpy as np
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
    from mx_rcnn_tpu_torch.obs.metrics import Registry
    from mx_rcnn_tpu_torch.serve.bulk import (BulkRunner, BulkSink,
                                              make_sink_manifest)
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                predictor_from_variables)
    from mx_rcnn_tpu_torch.tools.loadgen import run_closed_loop

    if Path(kernels.__file__).resolve().parents[1] == REPO:
        raise AssertionError("the child imported the repo's package, not "
                             "the copy")
    cfg = bulk_config()
    store = ExportStore(str(BULK_DIR / "store"))
    t0 = time.perf_counter()
    pred = predictor_from_variables(store.load_variables(), cfg, "cuda")
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    engine = ServingEngine(pred, cfg)
    join = engine.warm_from_export(store)
    join["weights_s"] = weights_s
    print("BULK_JOIN " + json.dumps(join), flush=True)
    imdb, roidb = load_gt_roidb(cfg, training=False)

    def run(sink, fault=None, reg=None, records=roidb, run_cfg=cfg):
        loader = StreamTestLoader(records, run_cfg, imdb.load_image,
                                  batch_images=ENGINE_BATCH,
                                  raw_images=False)
        return BulkRunner(engine, loader, BulkSink(
            str(BULK_DIR / sink), make_sink_manifest(
                run_cfg, records, 0, ENGINE_BATCH, model=BULK_MODEL)),
            run_cfg, registry=reg, fault=fault).run()

    if mode == "kill":
        def fault(k):
            if k == BULK_KILL_AT:
                os.kill(os.getpid(), signal.SIGKILL)

        run("killed", fault=fault)
        raise AssertionError("the killed run outlived its SIGKILL")
    reg = Registry()
    batches0 = engine.metrics.snapshot()["counters"].get("batches", 0)
    kernels.reset_launch_counts()
    control = run("control", reg=reg)
    launches = kernels.launch_counts()
    batches = engine.metrics.snapshot()["counters"]["batches"] - batches0
    # the killed run started beside this one: resume its sink once its
    # process has exited
    deadline = time.monotonic() + 300
    while not BULK_KILLED.exists():
        if time.monotonic() > deadline:
            raise AssertionError("the killed run did not exit in 300 s")
        time.sleep(0.1)
    resumed = run("killed")
    images = [np.ascontiguousarray(imdb.load_image(r)) for r in roidb[:8]]
    closed = run_closed_loop(engine, images, 4.0, 8, 0)
    rate_reg = Registry()
    rate = run("rate", reg=rate_reg, records=roidb * BULK_RATE_REPEAT,
               run_cfg=bulk_config(bulk__shard_batches=16))
    rate["sink_commit_ms"] = rate_reg.snapshot()["hists"].get(
        "bulk.sink_commit_ms")
    engine.close()
    print("BULK_RESULT " + json.dumps(dict(
        join=join, control=control, resumed=resumed, rate=rate,
        launches=launches,
        batches=batches, sink_commit_ms=reg.snapshot()["hists"].get(
            "bulk.sink_commit_ms"), closed_loop=closed,
        closed_images_per_s=closed["client"]["ok"] / closed["wall_s"],
        load_events=kernels.load_events())), flush=True)
    return 0


def bulk_process(mode: str, copy_root: Path):
    """:func:`bulk_child` in a process of its own over ``copy_root``, its
    copy's _build/ emptied first, started now: (the process, a function
    that waits for it and gives its exit code, JSON lines by tag and wall
    s)."""
    build = copy_root / "mx_rcnn_tpu_torch" / "_build"
    shutil.rmtree(build, ignore_errors=True)
    build.mkdir()
    out = OUT_DIR / f"bulk_{mode}.txt"
    t0 = time.perf_counter()
    with open(out, "w") as fo, open(out.with_suffix(".err"), "w") as fe:
        proc = subprocess.Popen([sys.executable, "-c", BULK_CHILD,
                                 str(copy_root), str(REPO), mode],
                                cwd=BULK_DIR, stdout=fo, stderr=fe, text=True)

    def wait() -> dict:
        try:
            proc.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        wall = time.perf_counter() - t0
        lines = {}
        for line in out.read_text().splitlines():
            tag, _, body = line.partition(" ")
            if tag in ("BULK_JOIN", "BULK_RESULT"):
                lines[tag] = json.loads(body)
        if "BULK_JOIN" not in lines:
            raise AssertionError(
                f"bulk {mode}: exit {proc.returncode}, no join\n"
                f"{out.with_suffix('.err').read_text()[-3000:]}")
        return dict(exit=proc.returncode, wall_s=wall, **lines)

    return proc, wait


def bulk_offline_equal(pred, cfg) -> dict:
    """Each line of the control sink against the offline path: the plan
    batch of its image, composed as the engine composes a batch (zero pad
    rows with im_info (bh, bw, 1)), ``Predictor.raw`` and
    ``_postprocess_batch`` at the engine's batch, ``detections_from_keep``
    and ``detections_line``: byte-equal, line by line."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.core.tester import (_postprocess_batch,
                                               detections_from_keep,
                                               tiled_bbox_stats)
    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.data.loader import StreamTestLoader
    from mx_rcnn_tpu_torch.serve.bulk import BulkSink, detections_line

    imdb, roidb = load_gt_roidb(cfg, training=False)
    sink = BulkSink(str(BULK_DIR / "control"))
    got = {}
    for k in range(sink.committed_shards()):
        for line in sink.read_lines(k):
            got[json.loads(line)["i"]] = line
    stds, means = tiled_bbox_stats(cfg, cfg.num_classes, pred.device)
    loader = StreamTestLoader(roidb, cfg, imdb.load_image,
                              batch_images=ENGINE_BATCH, raw_images=False)
    loader.set_epoch(0)
    n = ENGINE_BATCH
    equal = dets = 0
    for batch, indices, _ in loader:
        bh, bw = batch.images.shape[1:3]
        images = np.zeros((n, bh, bw, 3), np.float32)
        im_info = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
        images[:len(indices)] = batch.images
        im_info[:len(indices)] = batch.im_info
        outs = pred.raw(images, im_info)
        info = torch.from_numpy(im_info).to(pred.device)
        with torch.inference_mode():
            post = _postprocess_batch(*outs, info, info[:, 2], stds, means,
                                      nms_thresh=cfg.test.nms,
                                      score_thresh=cfg.serve.score_thresh)
        host = [t.cpu().numpy() for t in post]
        for j, i in enumerate(indices):
            d = detections_from_keep(*host, j)
            dets += sum(len(v) for v in d.values())
            equal += detections_line(i, d) == got.get(i)
    return dict(lines=len(got), equal=equal, detections=dets)


def bulk_refusals(cfg, store_root: str, dev) -> dict:
    """The store refuses a changed ``serve.score_thresh`` and an int8
    engine (a calibration sweep over the tree's train2017, then
    ``warm_from_export``)."""
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.export import ExportMismatch, ExportStore
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor

    store = ExportStore(store_root)
    out = {}
    try:
        store.check(cfg.replace_in("serve", score_thresh=0.2), device=dev)
    except ExportMismatch as e:
        out["score_thresh"] = str(e)[-160:]
    qcfg = cfg.replace_in("quant", enabled=True)
    engine = ServingEngine(init_predictor(qcfg, str(BULK_DIR / "m"), 1,
                                          device=dev), qcfg, start=False)
    try:
        engine.warm_from_export(store)
    except ExportMismatch as e:
        out["int8_engine"] = str(e)[-160:]
    if set(out) != {"score_thresh", "int8_engine"}:
        raise AssertionError(f"the store admitted a mismatch: {out}")
    return out


def bulk_demo(prefix: str, card: str) -> dict:
    """``tools/demo.py --prefix --epoch --image --out`` on the card over a
    portrait val2017 image: a PNG of the image's size."""
    from PIL import Image

    from mx_rcnn_tpu_torch.tools import demo

    image = BULK_DIR / "coco" / "val2017" / f"{1:012d}.jpg"
    out = BULK_DIR / "demo.png"
    t0 = time.perf_counter()
    with open(OUT_DIR / "bulk_demo.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        (dets,) = demo.main(["--network", "resnet101", "--dataset", "coco",
                             "--prefix", prefix, "--epoch", "1", "--image",
                             str(image), "--out", str(out), "--vis_thresh",
                             str(BULK_SCORE_THRESH)])
    wall = time.perf_counter() - t0
    with Image.open(image) as a, Image.open(out) as b:
        sizes = (a.size, b.size)
    n = sum(len(v) for v in dets.values())
    log(f"tools/demo.py --prefix --epoch 1 --image (640x480) --out on the "
        f"card ({card}): {n} detections drawn, PNG {sizes[1]} for an image "
        f"of {sizes[0]}, {wall:.1f} s")
    if sizes[0] != sizes[1]:
        raise AssertionError(f"the demo's PNG is {sizes[1]}, its image "
                             f"{sizes[0]}")
    return dict(detections=n, size=list(sizes[1]), wall_s=wall)


def phase_bulk(dev, card: str) -> dict:
    """Phase 18: a COCO tree under ``_chip/bulk`` (BULK_IMAGES val2017
    images on both buckets, 4 train2017 for calibration) and a seeded
    81-class ResNet-101 bf16 checkpoint (phase 11's scaled classifier):
    (a) the store with its weights; (b) in processes of their own over a
    copy of the package whose ``_build/`` is empty, ``warm_from_export``
    with 0 kernel builds; (c) ``StreamTestLoader`` → ``BulkRunner`` over
    that engine → ``BulkSink``, every image once, each line byte-equal to
    the offline batch; (d) a run SIGKILLed after shard BULK_KILL_AT and
    its resume byte-equal to the control; (e) the store's refusals; (f)
    K1 2 and K2 1 launches per engine batch; (g) bulk images/s beside the
    engine's closed loop, and over the corpus BULK_RATE_REPEAT times over
    (the rate pass); (i) the checkpoint demo on the card.  Its files
    are removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.data import load_gt_roidb
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.serve.export import export_serve_programs
    from mx_rcnn_tpu_torch.tools.loadgen import init_predictor
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(BULK_DIR, ignore_errors=True)
    BULK_DIR.mkdir(parents=True)
    children = {}
    try:
        write_coco_tree(BULK_DIR, seed=5, counts=(4, BULK_IMAGES),
                        portrait_every=2)
        cfg = bulk_config()
        prefix = str(BULK_DIR / "m")
        model = build_model(cfg, dev, seed=0, train=True)
        with torch.no_grad():
            model.cls_score.weight.mul_(SERVE_CLS_SCALE)
        save_params(prefix, 1, model.state_dict())
        del model
        pred = init_predictor(cfg, prefix, 1, device=dev)
        done("tree and checkpoint")
        t1 = time.perf_counter()
        report = export_serve_programs(pred, cfg, str(BULK_DIR / "store"),
                                       bundle_variables=True)
        export_s = time.perf_counter() - t1
        log(f"phase 18: store written in {export_s:.2f} s, programs "
            f"{[p['name'] for p in report['programs']]} bit-equal "
            f"{report['bit_equal']}, kernel libraries {report['kernels']}, "
            f"{report['bytes']} bytes bundled")
        if report["kernels"] != ["nms_sweep", "roi_align_fwd"]:
            raise AssertionError(f"the store bundles {report['kernels']}")
        done("store")
        refusals = bulk_refusals(cfg, str(BULK_DIR / "store"), dev)
        log(f"the store refuses serve.score_thresh 0.2 and an int8 engine: "
            f"{sorted(refusals)}")
        done("refusals")
        # the killed and the full run beside each other, each over a copy
        # of its own (each joins into an empty _build/), the demo here
        # meanwhile; the full run resumes the killed sink once the killed
        # process has exited.  The roidb's pickle cache is written here
        # first, so that neither child reads the other's half-written one
        load_gt_roidb(cfg, training=False)
        for mode in ("kill", "full"):
            copy_root = BULK_DIR / f"pkg_{mode}"
            shutil.copytree(REPO / "mx_rcnn_tpu_torch",
                            copy_root / "mx_rcnn_tpu_torch",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            children[mode] = bulk_process(mode, copy_root)
        demo = bulk_demo(prefix, card)
        done("demo")
        killed = children["kill"][1]()
        BULK_KILLED.touch()
        full = children["full"][1]()
        done("processes")
        offline = bulk_offline_equal(pred, cfg)
        done("offline")
        from mx_rcnn_tpu_torch.serve.bulk import BulkSink

        shards = {}
        for tag in ("control", "killed"):
            sink = BulkSink(str(BULK_DIR / tag))
            shards[tag] = [Path(sink.shard_path(k)).read_bytes()
                           for k in range(sink.committed_shards())]
    finally:
        for proc, _ in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(BULK_DIR, ignore_errors=True)
    res = full.get("BULK_RESULT") or {}
    ctrl, resumed = res.get("control", {}), res.get("resumed", {})
    joins = {m: p["BULK_JOIN"] for m, p in (("kill", killed),
                                            ("full", full))}
    launches, batches = res.get("launches", {}), res.get("batches", 0)
    commit = res.get("sink_commit_ms") or {}
    wall = time.perf_counter() - t0
    for m, j in joins.items():
        log(f"bulk {m} process: joined from the store in {j['total_s']} s "
            f"(weights {j['weights_s']:.2f} s before it; libraries placed "
            f"{j['kernels_placed']}), load events {j['load_events_before']}"
            f" -> {j['load_events_after']}")
    log(f"bulk over the export-warmed engine ({card}): "
        f"{ctrl.get('accounted_images')} of {ctrl.get('planned_images')} "
        f"images in {ctrl.get('shards')} shards, lost {ctrl.get('lost')}, "
        f"{ctrl.get('imgs_per_sec')} images/s against the engine's closed "
        f"loop at concurrency 8 {res.get('closed_images_per_s', 0):.2f} "
        f"images/s in the same process; sink commit ms p50 "
        f"{commit.get('p50')} mean {commit.get('mean')}; launches "
        f"{launches} over {batches} engine batches")
    rate = res.get("rate", {})
    rate_commit = rate.get("sink_commit_ms") or {}
    log(f"bulk rate pass ({card}): {rate.get('accounted_images')} of "
        f"{rate.get('planned_images')} images (the corpus "
        f"{BULK_RATE_REPEAT} times over) in {rate.get('shards')} shards of "
        f"16 plan batches, lost {rate.get('lost')}, {rate.get('wall_s')} s, "
        f"{rate.get('imgs_per_sec')} images/s; sink commit ms p50 "
        f"{rate_commit.get('p50')} mean {rate_commit.get('mean')}")
    log(f"the SIGKILLed run: exit {killed['exit']}, resumed "
        f"{resumed.get('resumed_shards')} shards, scored "
        f"{resumed.get('scored_images')}; its shards byte-equal to the "
        f"control's {shards['killed'] == shards['control']}; offline "
        f"batch equal on {offline['equal']} of {offline['lines']} lines "
        f"({offline['detections']} detections)")
    want = {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
            "roi_align_bwd": 0, "quantize_act": 0, "qconv_s8": 0,
            "qconv_e4m3": 0}
    if (full["exit"] or killed["exit"] != -9
            or any(j["load_events_after"]["builds"] for j in joins.values())
            or any(j["kernels_placed"] != ["nms_sweep", "roi_align_fwd"]
                   for j in joins.values())
            or ctrl.get("lost") != 0 or ctrl.get("accounted_images")
            != BULK_IMAGES or resumed.get("accounted_images") != BULK_IMAGES
            or resumed.get("resumed_shards") != BULK_KILL_AT + 1
            or rate.get("lost") != 0 or rate.get("accounted_images")
            != BULK_IMAGES * BULK_RATE_REPEAT
            or shards["killed"] != shards["control"]
            or len(shards["control"]) != ctrl.get("shards")
            or offline["equal"] != BULK_IMAGES
            or offline["lines"] != BULK_IMAGES
            or offline["detections"] == 0 or not batches
            or launches != want
            or res.get("load_events", {}).get("builds")):
        raise AssertionError(f"phase 18: {json.dumps(res)[:3000]} killed "
                             f"{killed} offline {offline}")
    log(f"phase 18 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(store=report, export_s=export_s, refusals=refusals,
                joins=joins, control=ctrl, resumed=resumed,
                rate=rate, launches=launches, batches=batches,
                sink_commit_ms=commit,
                closed_loop=res.get("closed_loop"),
                closed_images_per_s=res.get("closed_images_per_s"),
                offline=offline, killed_exit=killed["exit"],
                process_s={"kill": killed["wall_s"],
                           "full": full["wall_s"]},
                demo=demo, parts_s=parts, wall_s=wall)


# ---- phase 19: the serving fleet, the thirteenth main path ---------------

FLEET_DIR = REPO / "_chip" / "fleet"   # the tree, checkpoint, store, sinks
FLEET_REPLICAS = 2
FLEET_BULK_IMAGES = 48     # train2017 JPEGs, 480x640 and 640x480 in turns
FLEET_LOOP_S = 6.0         # the 2-replica closed loop through detect
FLEET_ONE_S = 3.0          # 1 and 2 replicas at one concurrency
FLEET_KILL_S = 5.0         # the kill-mid-burst leg's burst
FLEET_MEM_SLACK = 64 << 20  # bytes a closed fleet may leave on the card


def fleet_overrides() -> dict:
    """Phase 18's configuration over phase 19's tree."""
    return {"dataset__root_path": str(FLEET_DIR),
            "dataset__dataset_path": str(FLEET_DIR / "coco"),
            "serve__score_thresh": BULK_SCORE_THRESH}


def fleet_sets() -> list:
    return [a for k, v in fleet_overrides().items()
            for a in ("--set", f"{k}={v!r}" if isinstance(v, str)
                      else f"{k}={v}")]


def fleet_model_args(prefix: str) -> list:
    return ["--network", "resnet101", "--dataset", "coco", "--prefix",
            prefix, "--epoch", "1"]


def fleet_memory(devices) -> tuple:
    """Bytes allocated on the fleet's cards after a collection: as read,
    and with PyTorch's cached cuBLAS workspaces released (one a thread's
    handle, kept after the thread exits: a dispatcher thread's matmul
    leaves one behind, which is no replica's state; PyTorch's own memory
    leak check releases them the same way)."""
    import gc

    import torch

    gc.collect()
    for d in devices:
        torch.cuda.synchronize(d)
    raw = sum(torch.cuda.memory_allocated(d) for d in set(devices))
    torch._C._cuda_clearCublasWorkspaces()
    return raw, sum(torch.cuda.memory_allocated(d) for d in set(devices))


def fleet_loop(router, images, seconds: float, concurrency: int) -> dict:
    """A closed loop through ``router.detect``; its served rate, lost
    count, and each replica's engine batches over the loop."""
    from mx_rcnn_tpu_torch.tools.loadgen import _drain, run_closed_loop

    b0 = [r.engine.metrics.counters["batches"]
          for r in router.manager.replicas]
    router.metrics.reset()
    run = run_closed_loop(router, images, seconds, concurrency, 20_000.0)
    _drain(router)
    snap = router.metrics.snapshot()
    c = snap["counters"]
    batches = [r.engine.metrics.counters["batches"] - b
               for r, b in zip(router.manager.replicas, b0)]
    return dict(served=c["served"], failed=c["failed"], shed=c["shed"],
                expired=c["expired"], lost=c["submitted"] - snap["terminated"],
                images_per_s=c["served"] / run["wall_s"],
                wall_s=run["wall_s"], p50_ms=snap["total_ms"]["p50"],
                p99_ms=snap["total_ms"]["p99"], batches=batches,
                rows_per_batch=c["served"] / max(sum(batches), 1),
                concurrency=concurrency)


def fleet_rows(engine) -> dict:
    """Each bucket's four request images in one batch, in four
    rotations: each image's detections byte-equal at every row, so a
    bulk run's shards do not depend on the replica or row that scored an
    image (``models/rpn.py``).  Returns each bucket's images that
    differed (none) and how many detections were compared."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch.core.tester import (_postprocess_batch,
                                               detections_from_keep)

    p, cfg, n = engine.predictor, engine.cfg, ENGINE_BATCH
    imgs = request_images()
    out = {}
    for group in (imgs[:n], imgs[n:]):
        canv = [engine.preprocess(img) for img in group]
        seen, dets = [set() for _ in canv], 0
        for shift in range(n):
            order = [(j + shift) % n for j in range(n)]
            images = np.stack([canv[i][0] for i in order])
            info = np.stack([canv[i][1] for i in order]).astype(np.float32)
            outs = p.raw(images, info)
            info_t = torch.from_numpy(info).to(p.device)
            with torch.inference_mode():
                post = [t.cpu().numpy() for t in _postprocess_batch(
                    *outs, info_t, info_t[:, 2], engine._stds, engine._means,
                    nms_thresh=cfg.test.nms,
                    score_thresh=cfg.serve.score_thresh)]
            for row, i in enumerate(order):
                d = detections_from_keep(*post, row)
                dets += sum(len(v) for v in d.values())
                seen[i].add(tuple(sorted((c, v.tobytes())
                                         for c, v in d.items())))
        bh, bw = canv[0][2]
        out[f"{bh}x{bw}"] = dict(differed=[i for i, s in enumerate(seen)
                                           if len(s) != 1], detections=dets)
    return out


def fleet_health_watch(cfg):
    """``watch`` of ``tools/loadgen.py — _kill_mid_burst_leg``: at the
    kill, wait for the eject, then scrape the fleet
    (``collector_for_fleet``) and judge ``default_rules`` on it; after
    the rejoin, the same."""
    from mx_rcnn_tpu_torch.obs import health as obs_health
    from mx_rcnn_tpu_torch.obs.collect import (collector_for_fleet,
                                               view_to_snapshot)
    from mx_rcnn_tpu_torch.obs.metrics import Registry
    from mx_rcnn_tpu_torch.obs.timeseries import TimeSeriesStore
    from mx_rcnn_tpu_torch.serve.fleet import R_READY

    store = TimeSeriesStore(64)
    engine = obs_health.HealthEngine(obs_health.default_rules(cfg), store,
                                     registry=Registry())

    def watch(router, phase):
        victim = router.manager.replicas[0]
        if phase == "killed":
            deadline = time.monotonic() + 10.0
            while victim.state == R_READY and time.monotonic() < deadline:
                time.sleep(0.01)
        router.manager.export_gauges()
        view = collector_for_fleet(router).collect()
        store.append_snapshot(view_to_snapshot(view))
        doc = engine.evaluate()
        return dict(state=victim.state,
                    up={k: v["up"] for k, v in view["sources"].items()},
                    ready_gauge=view_to_snapshot(view)["gauges"].get(
                        "fleet.replicas_ready"),
                    verdict=doc["verdict"], firing=doc["firing"])

    return watch


def fleet_package(root: Path) -> Path:
    """A copy of the package under ``root`` whose ``_build/`` is empty."""
    from mx_rcnn_tpu_torch.tools.loadgen import fresh_package

    return fresh_package(str(root))


def fleet_bulk(prefix: str, store: str, at_kill=None) -> dict:
    """``tools/bulk.py --protocol kill_resume --replicas 2 --check`` in a
    process over a copy of the package whose ``_build/`` is empty (its
    three children import the copy too).  ``at_kill()`` runs when the
    protocol starts its killed child, whose run nothing measures (after
    the control's serve baseline and rate)."""
    copy = fleet_package(FLEET_DIR / "bulk_pkg")
    cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.bulk",
           "--protocol", "kill_resume", "--replicas", str(FLEET_REPLICAS),
           "--num_images", str(FLEET_BULK_IMAGES), "--batch_images",
           str(ENGINE_BATCH), "--root_path", str(FLEET_DIR),
           "--dataset_path", str(FLEET_DIR / "coco"), "--export_dir",
           store, "--workdir", str(FLEET_DIR / "bulk"), "--baseline_s", "2",
           "--min_ratio_vs_serve", "0.4", "--check",
           "--set", f"serve__score_thresh={BULK_SCORE_THRESH}",
           "--set", "bulk__shard_batches=2",
           "--set", "data__ram_ceiling_mb=16384"] + fleet_model_args(prefix)
    env = dict(os.environ, PYTHONPATH=str(copy))
    out_path, err_path = OUT_DIR / "fleet_bulk.txt", OUT_DIR / "fleet_bulk.err"
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=str(copy), env=env, stdout=out,
                                stderr=err)
        try:
            while proc.poll() is None:
                if at_kill is not None and "KILL run" in err_path.read_text():
                    at_kill()
                    at_kill = None
                if time.perf_counter() - t0 > 420:
                    raise AssertionError("tools/bulk.py kill_resume ran "
                                         "past 420 s")
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    stdout, stderr = out_path.read_text(), err_path.read_text()
    recs = [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]
    if proc.returncode != 0 or not recs:
        raise AssertionError(f"tools/bulk.py kill_resume exited "
                             f"{proc.returncode}:\n{stderr[-3000:]}")
    rec = recs[-1]
    for run in ("control", "resume"):
        if not rec[run]["package"].startswith(str(copy)):
            raise AssertionError(f"the bulk {run} imported "
                                 f"{rec[run]['package']}")
    return dict(rec, wall_s=wall,
                built=sorted(p.name for p in (copy / "mx_rcnn_tpu_torch"
                                              / "_build").iterdir()))


def fleet_join(mode: str, store: str) -> dict:
    """``tools/fleet.py join_bench --mode trace`` (by warm-up) or
    ``export`` (from the store) in a process over a fresh copy of the
    package."""
    from mx_rcnn_tpu_torch.tools.loadgen import _run_join_bench

    t0 = time.perf_counter()
    rec = _run_join_bench(
        mode, "resnet101", "coco", fleet_overrides(),
        export_dir=store if mode == "export" else None, timeout_s=300,
        device="cuda", workdir=str(FLEET_DIR / "join"))
    return dict(rec, process_s=time.perf_counter() - t0)


def fleet_http_start(prefix: str, store: str) -> tuple:
    """Start ``tools/fleet.py serve --replicas 2`` in a process of its
    own; it builds and joins beside the bulk protocol's killed child
    (once up it idles until :func:`fleet_http` asks it)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    err = open(OUT_DIR / "fleet_serve.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.fleet", "serve",
         "--replicas", str(FLEET_REPLICAS), "--export_dir", store, "--port",
         str(port)] + fleet_model_args(prefix) + fleet_sets(),
        cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=err)
    return proc, port, err, time.perf_counter()


def fleet_http(started: tuple, card: str) -> dict:
    """The started service: its ``/healthz`` with 2 ready replicas, 4
    ``/detect`` (200), ``/metrics`` with the ``fleet.*`` counters,
    SIGINT: exit 0 within 10 s."""
    import base64
    import signal
    import urllib.request

    import numpy as np

    proc, port, err, t0 = started
    url = f"http://127.0.0.1:{port}"

    def get(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url + path, data=data), timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    try:
        health = None
        deadline = time.monotonic() + 180
        while health is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"tools/fleet.py serve exited "
                                     f"{proc.returncode} before serving")
            try:
                health = get("/healthz")[1]
            except OSError:
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        statuses, dets = [], []
        for img in request_images()[2:6]:
            img = np.ascontiguousarray(img)
            status, body = get("/detect", {
                "pixels_b64": base64.b64encode(img.tobytes()).decode(),
                "shape": list(img.shape)})
            statuses.append(status)
            dets.append(len(body["detections"]))
        _, metrics = get("/metrics")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed after 10 s"
        err.close()
    reg = metrics.get("registry", {}).get("counters", {})
    log(f"tools/fleet.py serve --replicas 2 on {card}: /healthz with "
        f"{health['ready']} ready replicas {up_s:.1f} s after its start "
        f"(beside the bulk protocol's killed child); /detect "
        f"{statuses}, detections {dets}; /metrics fleet.served "
        f"{reg.get('fleet.served')}; SIGINT -> exit {rc}")
    if (health["ready"] != FLEET_REPLICAS or statuses != [200] * 4
            or reg.get("fleet.served") != 4 or rc != 0
            or not any(k.startswith("fleet.") for k in reg)):
        raise AssertionError(f"fleet serve: healthz {health} statuses "
                             f"{statuses} metrics {reg} exit {rc}")
    return dict(up_s=up_s, statuses=statuses, detections=dets,
                healthz=health, fleet_counters=reg, exit=rc)


def phase_fleet(dev, card: str) -> dict:
    """Phase 19: the serving fleet (module docstring), its files under
    ``_chip/fleet``, removed at the end."""
    import numpy as np
    import torch

    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.obs.metrics import registry
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.export import predictor_variables
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet
    from mx_rcnn_tpu_torch.tools import fleet as fleet_tool
    from mx_rcnn_tpu_torch.tools.loadgen import (_kill_mid_burst_leg,
                                                 init_predictor,
                                                 synthetic_images)
    from mx_rcnn_tpu_torch.utils.checkpoint import save_params

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    http_proc = None
    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", k)
               for k in range(min(n_cards, FLEET_REPLICAS))]
    try:
        write_coco_tree(FLEET_DIR, seed=6, counts=(FLEET_BULK_IMAGES, 0),
                        portrait_every=2)
        cfg = generate_config("resnet101", "coco", **fleet_overrides())
        fcfg = cfg.replace_in("fleet", replicas=FLEET_REPLICAS,
                              health_interval_s=0.2)
        prefix = str(FLEET_DIR / "m")
        model = build_model(cfg, dev, seed=0, train=True)
        with torch.no_grad():
            model.cls_score.weight.mul_(SERVE_CLS_SCALE)
        save_params(prefix, 1, model.state_dict())
        del model
        pred = init_predictor(cfg, prefix, 1, device=dev)
        variables = predictor_variables(pred)
        offline = ServingEngine(pred, cfg, start=False)
        rows = fleet_rows(offline)
        log(f"each request image at every row of a batch of "
            f"{ENGINE_BATCH} on {card}: images whose detections differed "
            f"between rows, per bucket: "
            + "; ".join(f"{k}: {v['differed']} ({v['detections']} "
                        f"detections)" for k, v in rows.items()))
        if any(v["differed"] or not v["detections"] for v in rows.values()):
            raise AssertionError(f"detections follow the batch row: {rows}")
        done("tree and checkpoint")

        # (a) the store through the CLI's main
        store = str(FLEET_DIR / "store")
        with open(OUT_DIR / "fleet_export.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            fleet_tool.main(["export", "--out", store]
                            + fleet_model_args(prefix) + fleet_sets())
        report = json.loads((OUT_DIR / "fleet_export.txt").read_text()
                            .strip().splitlines()[-1])
        log(f"phase 19: tools/fleet.py export in {report['export_s']} s, "
            f"bit-equal {report['bit_equal']}, kernel libraries "
            f"{report['kernels']}, {report['bytes']} bytes")
        if report["kernels"] != ["nms_sweep", "roi_align_fwd"] \
                or not report["bit_equal"]:
            raise AssertionError(f"the fleet store: {report}")
        done("store")

        # (b) + (c) the 2-replica fleet, its loop and the bit-equality
        mem0 = fleet_memory(devices)
        t1 = time.perf_counter()
        router = build_fleet(fcfg, variables, export_root=store,
                             devices=devices)
        build_s = time.perf_counter() - t1
        try:
            joins = [r.joins[-1] for r in router.manager.replicas]
            placed = [str(r.engine.predictor.device)
                      for r in router.manager.replicas]
            builds = [j["load_events_after"]["builds"]
                      - j["load_events_before"]["builds"] for j in joins]
            log(f"fleet of {FLEET_REPLICAS} on {n_cards} card(s): replicas "
                f"on {placed}, joins {[j['join_s'] for j in joins]} s "
                f"(warm {[j['warm_s'] for j in joins]}), kernel builds "
                f"{builds}, {build_s:.2f} s for the fleet")
            want_dev = [str(devices[k % len(devices)])
                        for k in range(FLEET_REPLICAS)]
            if builds != [0] * FLEET_REPLICAS or placed != want_dev \
                    or any(j["export_root"] != store for j in joins):
                raise AssertionError(f"the fleet's joins: {joins} on "
                                     f"{placed}")
            images = synthetic_images(cfg, 16, seed=0)
            kernels.reset_launch_counts()
            two = fleet_loop(router, images, FLEET_LOOP_S,
                             4 * ENGINE_BATCH * FLEET_REPLICAS)
            launches = fp_launches()
            by_dev = kernels.launch_counts_by_device()
            batches = sum(two["batches"])
            want = {"nms_sweep": 2 * batches, "roi_align_fwd": batches,
                    "roi_align_bwd": 0}
            per_card = {str(devices[k % len(devices)]): (
                by_dev["nms_sweep"].get(devices[k % len(devices)].index, 0),
                by_dev["roi_align_fwd"].get(devices[k % len(devices)].index,
                                            0)) for k in range(FLEET_REPLICAS)}
            log(f"fleet closed loop {FLEET_LOOP_S:.0f} s at concurrency "
                f"{two['concurrency']} on {card}: {two['served']} served, "
                f"{two['images_per_s']:.2f} images/s, p50/p99 "
                f"{two['p50_ms']}/{two['p99_ms']} ms, lost {two['lost']}, "
                f"engine batches per replica {two['batches']}; launches "
                f"{launches}; K1/K2 per card {per_card}")
            if two["lost"] or two["failed"] or not two["served"] \
                    or launches != want or not all(two["batches"]):
                raise AssertionError(f"the fleet loop: {two} launches "
                                     f"{launches}, want {want}")
            if len(devices) > 1:
                for k in range(FLEET_REPLICAS):
                    d = devices[k].index
                    if (by_dev["nms_sweep"].get(d), by_dev["roi_align_fwd"]
                            .get(d)) != (2 * two["batches"][k],
                                         two["batches"][k]):
                        raise AssertionError(f"replica {k}'s launches are "
                                             f"not on card {d}: {by_dev}")
            equal, seen, dets = 0, set(), 0
            for img in request_images():
                freq = router.submit(img, timeout_ms=0)
                got = freq.wait(timeout=120.0)
                want_d = offline_detections(offline, img)
                seen.add(freq.replica_id)
                dets += sum(len(v) for v in want_d.values())
                equal += sorted(got) == sorted(want_d) and all(
                    np.array_equal(got[c], want_d[c]) for c in want_d)
            log(f"fleet detect alone in its batch: {equal} of "
                f"{len(request_images())} bit-equal to the offline batch "
                f"({dets} detections, replicas {sorted(seen)})")
            if equal != len(request_images()) or not dets \
                    or seen != set(range(FLEET_REPLICAS)):
                raise AssertionError(f"fleet bit-equality {equal}, replicas "
                                     f"{seen}, detections {dets}")
            # the same fleet at the 1-replica leg's concurrency
            two_16 = fleet_loop(router, images, FLEET_ONE_S,
                                4 * ENGINE_BATCH)
        finally:
            router.close()
        del router
        mem_two = [a - b for a, b in zip(fleet_memory(devices), mem0)]
        done("two replicas")

        # (d) one replica, the same traffic
        router = build_fleet(fcfg.replace_in("fleet", replicas=1), variables,
                             export_root=store, devices=devices)
        try:
            one = fleet_loop(router, images, FLEET_ONE_S, 4 * ENGINE_BATCH)
        finally:
            router.close()
        del router
        log(f"1 against 2 replicas on {n_cards} card(s) ({card}): "
            f"{one['images_per_s']:.2f} against {two_16['images_per_s']:.2f} "
            f"images/s served at concurrency {one['concurrency']} (p50 "
            f"{one['p50_ms']} / {two_16['p50_ms']} ms, rows a batch "
            f"{one['rows_per_batch']:.2f} / {two_16['rows_per_batch']:.2f}; "
            f"2 replicas at concurrency {two['concurrency']}: "
            f"{two['rows_per_batch']:.2f}), lost {one['lost']} and "
            f"{two_16['lost']}"
            + (" (one card: the router's overhead, not scaling)"
               if n_cards == 1 else ""))
        if one["lost"] or not one["served"] or two_16["lost"] \
                or not two_16["served"]:
            raise AssertionError(f"the 1-replica loop: {one}; 2 at its "
                                 f"concurrency {two_16}")
        done("one replica")

        # (e) kill mid-burst, watched
        registry().reset("fleet.")
        kill = _kill_mid_burst_leg(cfg, variables, store, FLEET_KILL_S,
                                   20_000.0, images, device=dev,
                                   watch=fleet_health_watch(fcfg))
        mem_kill = [a - b for a, b in zip(fleet_memory(devices), mem0)]
        w = kill["watch"]
        rejoin = kill["rejoin"] or {}
        rejoin_builds = (rejoin.get("load_events_after", {}).get("builds", 1)
                         - rejoin.get("load_events_before", {}).get(
                             "builds", 0))
        log(f"kill mid-burst on {card}: {kill['served']} served, "
            f"{kill['served_after_kill']} after the kill, lost "
            f"{kill['lost']}, rerouted {kill['rerouted']}, ejects "
            f"{kill['ejects']}, relaunched {kill['relaunched']} (rejoin "
            f"{kill['rejoin_s']} s, join {rejoin.get('join_s')} s, builds "
            f"{rejoin_builds}); at the kill: {w['killed']['state']}, "
            f"scrape up {w['killed']['up']}, ready gauge "
            f"{w['killed']['ready_gauge']}, verdict {w['killed']['verdict']} "
            f"{w['killed']['firing']}; after the rejoin: verdict "
            f"{w['rejoined']['verdict']} {w['rejoined']['firing']}")
        log(f"the card's memory after each fleet closed, against before, "
            f"as read / with the cached cuBLAS workspaces released: "
            f"{mem_two[0] / 2 ** 20:+.1f} / {mem_two[1] / 2 ** 20:+.1f} MiB "
            f"(2 replicas), {mem_kill[0] / 2 ** 20:+.1f} / "
            f"{mem_kill[1] / 2 ** 20:+.1f} MiB (the kill leg)")
        if (kill["lost"] or kill["ejects"] != 1 or not kill["relaunched"]
                or kill["served_after_kill"] <= 0 or rejoin_builds != 0
                or rejoin.get("export_root") != store
                or w["killed"]["up"].get("replica-0")
                or w["killed"]["verdict"] != "CRITICAL"
                or "fleet-degraded" not in w["killed"]["firing"]
                or w["rejoined"]["verdict"] != "OK"
                or abs(mem_two[1]) > FLEET_MEM_SLACK
                or abs(mem_kill[1]) > FLEET_MEM_SLACK):
            raise AssertionError(f"the kill leg: {kill}; memory "
                                 f"{mem_two} {mem_kill}")
        done("kill")
        del offline, pred, variables

        # (f) processes over a copy of the package with an empty _build/;
        # (g)'s service and both join_bench runs start beside the killed
        # child
        join_runs = {"trace": {}, "export": {}}

        def run_join(mode):
            try:
                join_runs[mode].update(fleet_join(mode, store))
            except BaseException as e:  # noqa: BLE001 — raised below
                join_runs[mode]["error"] = e

        join_threads = [threading.Thread(target=run_join, args=(m,),
                                         daemon=True) for m in join_runs]

        def at_kill():
            nonlocal http_proc
            http_proc = fleet_http_start(prefix, store)
            for t in join_threads:
                t.start()
            # phase 20's agents boot here too, beside the killed child
            _CROSS.update(cross_start(store))

        # phase 20's reference: the agents' cards with this phase's
        # fleets closed and no process of this phase or the next on them
        _CROSS["free_ref"] = cross_free(cross_devices())
        bulk = fleet_bulk(prefix, store, at_kill=at_kill)
        if http_proc is None:
            at_kill()
        ctrl, resume = bulk["control"], bulk["resume"]
        log(f"tools/bulk.py kill_resume ({card}): {bulk['wall_s']:.1f} s, "
            f"{ctrl['bulk']['accounted_images']} of {FLEET_BULK_IMAGES} "
            f"images in {bulk['shards']} shards, lost {ctrl['bulk']['lost']}"
            f", {ctrl['bulk']['imgs_per_sec']} images/s against a serve "
            f"baseline of {ctrl['serve_baseline']['imgs_per_sec']} "
            f"(ratio {ctrl.get('ratio_vs_serve_baseline')}); killed after "
            f"shard {bulk['kill_after_shard']}, resumed "
            f"{resume['bulk']['resumed_shards']}; union byte-equal "
            f"{bulk['union_bit_identical']}; join builds "
            f"{ctrl['join_kernel_builds']}, {resume['join_kernel_builds']}; "
            f"peak RSS {ctrl['peak_rss_mb']} MiB; the copy's _build/ "
            f"{bulk['built']}")
        if not bulk["union_bit_identical"] or not all(
                bulk["checks"].values()) or ctrl["join_kernel_builds"] \
                or resume["join_kernel_builds"]:
            raise AssertionError(f"fleet bulk: {json.dumps(bulk)[:3000]}")
        done("bulk")
        for t, (mode, rec) in zip(join_threads, join_runs.items()):
            t.join(timeout=300)
            if "error" in rec or t.is_alive():
                raise AssertionError(f"join_bench --mode {mode}: "
                                     f"{rec.get('error', 'past 300 s')}")
        tr, ex = join_runs["trace"], join_runs["export"]
        joins_bench = dict(trace=tr, export=ex,
                           ratio=ex["overhead_s"] / tr["overhead_s"])
        log(f"join_bench ({card}; each process beside the bulk protocol's "
            f"killed and resumed children and the other): by warm-up "
            f"overhead "
            f"{tr['overhead_s']} s (first {tr['first_s']}, second "
            f"{tr['second_s']}), builds {tr['kernel_builds']}, process "
            f"{tr['process_s']:.1f} s; from "
            f"the store overhead {ex['overhead_s']} s (load {ex['load_s']}, "
            f"first {ex['first_s']}, second {ex['second_s']}), builds "
            f"{ex['kernel_builds']}, placed {ex['kernels_placed']}, process "
            f"{ex['process_s']:.1f} s; ratio {joins_bench['ratio']:.4f}")
        if tr["kernel_builds"] != 2 or ex["kernel_builds"] != 0:
            raise AssertionError(f"join_bench builds: {joins_bench}")
        done("join_bench")

        # (g) the HTTP service
        http = fleet_http(http_proc, card)
        done("http")
    except BaseException:
        cross_stop()
        raise
    finally:
        if http_proc is not None and http_proc[0].poll() is None:
            http_proc[0].kill()
            http_proc[0].wait()
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 19 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(store=report, joins=joins, placed=placed, two=two, one=one,
                two_at_one_concurrency=two_16, rows=rows,
                launches=launches, launches_by_device=by_dev,
                kill=kill, memory_after_close={"two": mem_two,
                                               "kill": mem_kill},
                bulk=bulk, join_bench=joins_bench, http=http, parts_s=parts,
                wall_s=wall, cards=n_cards)


# ---- phase 20: the cross-host serving tier, the fourteenth main path -------

CROSS_DIR = REPO / "_chip" / "crosshost"   # store, agents' stores, packages
CROSS_EXPORT = REPO / "_chip" / "crosshost_export"   # the store, run alone
CROSS_AGENTS = 2
CROSS_LOOP_S = 3.0          # each closed loop of (c)
CROSS_KILL_S = 6.0          # the kill leg's burst
CROSS_CONCURRENCY = 16
CROSS_MAX_BYTES_RATIO = 0.30    # tools/loadgen.py --max_wire_bytes_ratio
CROSS_MIN_SCALING = 1.5     # 2 agents against 1, judged on 2 cards only
CROSS_MEM_SLACK = 64 << 20  # bytes the dead agents may leave on the card


def cross_overrides() -> dict:
    """Phase 19's configuration, the agents' span rings keeping every
    tree (part (e) merges one sampled request's)."""
    return dict(fleet_overrides(), obs__trace_ring=256,
                obs__trace_slow_pct=0.0)


def cross_source(img, cfg):
    """``img`` as a v2 source frame carries it: resized but not
    normalized (uint8), its im_info and its bucket, as the engine's
    preprocess resolves them."""
    import numpy as np

    from mx_rcnn_tpu_torch.data.image import (choose_bucket, fit_to_bucket,
                                              resize_keep_ratio)

    resized, s = resize_keep_ratio(np.asarray(img), cfg.bucket.scale,
                                   cfg.bucket.max_size)
    bucket = choose_bucket(*resized.shape[:2],
                           tuple(tuple(b) for b in cfg.bucket.shapes))
    resized, s = fit_to_bucket(resized, s, bucket)
    h, w = img.shape[:2]
    info = np.array([round(h * s), round(w * s), s], np.float32)
    return np.ascontiguousarray(resized), info, tuple(bucket)


def _submit_source(target, item, timeout_ms: float):
    img, info, bucket = item
    return target.submit_source(img, info, bucket, timeout_ms=timeout_ms)


def cross_wire_counts(router) -> dict:
    """The head's wire counters summed over its remote engines."""
    out = {"tx": 0, "frames": 0, "envelopes": 0}
    for r in router.manager.replicas:
        eng = r.engine
        if eng is None:
            continue
        reg = eng.metrics.registry
        out["tx"] += reg.counter("serve.wire_tx_bytes")
        out["frames"] += reg.counter("serve.wire_frames")
        out["envelopes"] += reg.counter("serve.envelopes")
    return out


def cross_free(devices) -> int:
    """Free bytes on the agents' cards as CUDA reports them, plus
    what this process's allocator holds: constant while no other process
    holds memory there."""
    import torch

    for d in devices:
        torch.cuda.synchronize(d)
    return sum(torch.cuda.mem_get_info(d)[0] + torch.cuda.memory_reserved(d)
               for d in devices)


def cross_cards() -> list:
    """Agent k's device: card k mod the card count."""
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(CROSS_AGENTS)]


def cross_devices() -> list:
    import torch

    return sorted({torch.device(c) for c in cross_cards()}, key=str)


# phase 20's store server and agents, started beside phase 19's killed
# bulk child (work that nothing times) and taken over by phase 20
_CROSS: dict = {}


def cross_start(store_src: str) -> dict:
    """Link ``store_src`` into ``CROSS_DIR/store``, serve it from
    ``make_store_server`` in this process and start the agents (each over
    a package copy with an empty ``_build/``, pulling the store): their
    boot runs beside whatever this process does next."""
    from mx_rcnn_tpu_torch.serve.agent import make_store_server
    from mx_rcnn_tpu_torch.tools import crosshost

    shutil.rmtree(CROSS_DIR, ignore_errors=True)
    CROSS_DIR.mkdir(parents=True)
    store = CROSS_DIR / "store"
    shutil.copytree(store_src, store, copy_function=os.link)
    srv = make_store_server(str(store))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    t0 = time.perf_counter()
    agents = [crosshost.AgentProc(
        str(OUT_DIR), f"cross_agent{i}", cross_overrides(),
        network="resnet101", dataset="coco", device=card, store_url=url,
        export_dir=str(CROSS_DIR / f"agent{i}_store"),
        package_root=str(fleet_package(CROSS_DIR / f"pkg{i}")))
        for i, card in enumerate(cross_cards())]
    return dict(store=str(store), srv=srv, agents=agents, t0=t0)


def cross_stop() -> None:
    """Kill phase 20's agents and stop its store server, if started."""
    for a in _CROSS.pop("agents", []):
        if a.proc.poll() is None:
            a.kill()
    srv = _CROSS.pop("srv", None)
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def cross_same(got, want) -> bool:
    return sorted(got) == sorted(want) and all(
        got[c].dtype == want[c].dtype and got[c].tobytes() == want[c].tobytes()
        for c in want)


def phase_crosshost(dev, card: str) -> dict:
    """Phase 20: the cross-host tier (module docstring), its files under
    ``_chip/crosshost`` (phase 19 links its store there and starts the
    agents), removed at the end."""
    import torch

    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.data.image import pad_normalize
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.obs import trace as obs_trace
    from mx_rcnn_tpu_torch.serve.engine import ServingEngine
    from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                export_serve_programs,
                                                predictor_from_variables)
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.tools import crosshost
    from mx_rcnn_tpu_torch.tools.loadgen import _drain, _fleet_leg_record
    from mx_rcnn_tpu_torch.tools.trace import _merge_now

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    n_cards = torch.cuda.device_count()
    cards, devices = cross_cards(), cross_devices()
    host = host_info()
    log(f"phase 20 host: {host_text(host)}")
    try:
        cfg = generate_config("resnet101", "coco", **cross_overrides())
        beside = "agents" in _CROSS
        if not beside:
            # run alone: no phase 19 started the agents; export a store of
            # the same seeded model and start them here.  The cards'
            # reference is read after the export, once this process's first
            # forward has set up what it keeps outside its allocator
            store = str(CROSS_EXPORT)
            shutil.rmtree(store, ignore_errors=True)
            model = build_model(cfg, dev, seed=0)
            with torch.no_grad():
                model.cls_score.weight.mul_(SERVE_CLS_SCALE)
            export_serve_programs(Predictor(model, cfg, dev), cfg, store,
                                  bundle_variables=True)
            del model
            _CROSS["free_ref"] = cross_free(devices)
            _CROSS.update(cross_start(store))
        agents, store_srv = _CROSS["agents"], _CROSS["srv"]
        st = ExportStore(_CROSS["store"])
        report = st.manifest()
        if sorted(report.get("kernels", {})) != ["nms_sweep",
                                                 "roi_align_fwd"]:
            raise AssertionError(f"the cross-host store: {report}")
        pred = predictor_from_variables(st.load_variables(), cfg, dev)
        done("store")

        # (a) the agents, started beside phase 19's killed bulk child (or
        # above, run alone); the offline batch meanwhile
        offline = ServingEngine(pred, cfg, start=False)
        imgs = request_images()
        want = [offline_detections(offline, img) for img in imgs]
        canvases = [offline.preprocess(img) for img in imgs]
        sources = [cross_source(img, cfg) for img in imgs]
        for (src, info, b), (canvas, cinfo, cb) in zip(sources, canvases):
            if (b != tuple(cb) or info.tobytes() != cinfo.tobytes()
                    or pad_normalize(src, cfg.network.pixel_means,
                                     b).tobytes() != canvas.tobytes()):
                raise AssertionError("a source frame's canvas differs from "
                                     "the engine's preprocess")
        waited = time.perf_counter()
        ready = [a.wait_ready(300) for a in agents]
        boot_s = time.perf_counter() - _CROSS["t0"]
        waited = time.perf_counter() - waited
        urls = [a.url for a in agents]
        health = [crosshost._healthz(u) for u in urls]
        with store_srv.stats_lock:
            reqs = list(store_srv.requests)
        shipped = {rel: sum(1 for r in reqs if r["rel"] == rel)
                   for rel in store_srv.index}
        loads = [h["kernel_load_events"] for h in health]
        log(f"phase 20: {CROSS_AGENTS} agents (tools/agent.py) on {cards} "
            f"({card}) ready {boot_s:.1f} s after their start"
            + (" beside phase 19's killed bulk child and its join_bench and "
               "HTTP service" if beside else "")
            + f" ({waited:.1f} s waited here): pulls "
            + "; ".join(f"{r['store_pull']['files']} files "
                        f"{r['store_pull']['bytes']} bytes in "
                        f"{r['store_pull']['transfer_s']} s, warm "
                        f"{r['warm_s']} s" for r in ready)
            + f"; each store file shipped {sorted(set(shipped.values()))} "
            f"time(s); kernel builds after the warm "
            f"{[h['kernel_builds_after_warm'] for h in health]}, library "
            f"events {loads}")
        if (set(shipped.values()) != {CROSS_AGENTS}
                or any(r["start"] for r in reqs)
                or any(h["kernel_builds_after_warm"] for h in health)
                or any(e["builds"] or e["loads"] != 2 for e in loads)
                or any(h["ready"] != 1 for h in health)):
            raise AssertionError(f"the agents' joins: shipped {shipped}, "
                                 f"health {health}")
        free_up = cross_free(devices)
        free0 = _CROSS["free_ref"]
        done("agents")

        # (b) the wire, bit for bit, through the router of this process
        # four connections of up to four frames: an agent sees up to 16
        # requests at once, four engine batches
        ccfg = cfg.replace_in("crosshost", connections=4, pipeline_depth=8,
                              frames_per_send=4, scrape_interval_s=0.2,
                              io_timeout_s=60.0)
        router, feed = build_crosshost_router(ccfg, urls)
        try:
            got = {"v1": [], "v2": [], "envelope": []}
            c0 = cross_wire_counts(router)
            for canvas, info, b in canvases:
                got["v1"].append(router.submit_prepared(
                    canvas, info, b, timeout_ms=0).wait(120.0))
            c1 = cross_wire_counts(router)
            for item in sources:
                got["v2"].append(_submit_source(router, item, 0).wait(120.0))
            c2 = cross_wire_counts(router)
            handles = [_submit_source(router, item, 0) for item in sources]
            got["envelope"] = [h.wait(120.0) for h in handles]
            c3 = cross_wire_counts(router)
            _drain(router)
            feed.tick()
            lanes_seen = sorted({k for r in router.manager.replicas
                                 for k in r.engine._scraped_lanes})
        finally:
            feed.close()
            router.close()
        after = [crosshost._healthz(u) for u in urls]
        batches = sum(a["engine_batches"] - h["engine_batches"]
                      for a, h in zip(after, health))
        launches = {k: sum(a["kernel_launches"][k] - h["kernel_launches"][k]
                           for a, h in zip(after, health))
                    for k in health[0]["kernel_launches"]}
        equal = {m: sum(cross_same(g, w) for g, w in zip(v, want))
                 for m, v in got.items()}
        per_v1 = (c1["tx"] - c0["tx"]) / max(c1["frames"] - c0["frames"], 1)
        per_v2 = (c2["tx"] - c1["tx"]) / max(c2["frames"] - c1["frames"], 1)
        ratio = per_v2 / per_v1
        dets = sum(len(v) for w in want for v in w.values())
        log(f"the wire on {card}: detections byte-equal to the offline "
            f"batch, of {len(imgs)}: v1 {equal['v1']}, v2 {equal['v2']}, "
            f"envelopes {equal['envelope']} "
            f"({c3['envelopes'] - c2['envelopes']} envelopes, {dets} "
            f"detections an image set); bytes an image "
            f"v1 {per_v1:.0f}, v2 {per_v2:.0f}, ratio {ratio:.4f}; agents' "
            f"engine batches {batches}, launches {launches}; scraped lanes "
            f"{lanes_seen}")
        want_l = {"nms_sweep": 2 * batches, "roi_align_fwd": batches}
        if (any(n != len(imgs) for n in equal.values()) or not dets
                or c3["envelopes"] <= c2["envelopes"]
                or ratio > CROSS_MAX_BYTES_RATIO or not batches
                or {k: launches[k] for k in want_l} != want_l
                or any(v for k, v in launches.items() if k not in want_l)):
            raise AssertionError(f"the wire: equal {equal}, ratio {ratio}, "
                                 f"launches {launches} for {batches} "
                                 f"batches, counts {c0} {c1} {c2} {c3}")
        done("wire")

        # (e) one sampled request traced through the real agents
        obs_trace.reset_distributed()
        obs_trace.configure_distributed(host="head")
        tcfg = ccfg.replace_in("obs", trace_sample=1.0, trace_ring=64,
                               trace_slow_pct=0.0)
        trouter, tfeed = build_crosshost_router(tcfg, urls)
        try:
            traced = _submit_source(trouter, sources[0], 0).wait(120.0)
            time.sleep(0.25)    # the worker closes the trace after the wait
            merged = _merge_now(urls, path=str(OUT_DIR / "cross_trace.json"))
            trees = obs_trace.kept_trees()
        finally:
            tfeed.close()
            trouter.close()
            obs_trace.reset_distributed()
        spans = merged["traces"].get(trees[-1]["trace"], []) if trees else []
        hosts = sorted({s.get("host") for s in spans})
        wire = [s for s in spans if s["name"] == "remote.wire"]
        hop = [s for s in spans if s["name"] == "agent.request"]
        ordered = bool(wire and hop) and wire[0]["ts"] <= hop[0]["ts"]
        log(f"one traced request: {len(spans)} spans on hosts {hosts} "
            f"({sorted({s['name'] for s in spans})}), complete "
            f"{obs_trace.tree_complete(spans)}, monotonic "
            f"{obs_trace.tree_monotonic(spans)}, the wire span before the "
            f"agent's {ordered}, skew offsets "
            f"{merged['metadata']['offsets_ms']} ms")
        if (len(hosts) < 2 or not ordered or not cross_same(traced, want[0])
                or not obs_trace.tree_complete(spans)
                or not obs_trace.tree_monotonic(spans)):
            raise AssertionError(f"the traced request's tree: {spans}")
        done("trace")

        # (c) 1 agent, then 2, at one concurrency
        def loop(us):
            r, f = build_crosshost_router(ccfg, us)
            try:
                run = crosshost._run_prepared_closed(
                    r, sources, CROSS_LOOP_S, CROSS_CONCURRENCY, 20_000.0,
                    submit=_submit_source)
                _drain(r)
                return _fleet_leg_record(run, r.metrics.snapshot())
            finally:
                f.close()
                r.close()

        one = loop(urls[:1])
        two = loop(urls)
        scaling = two["imgs_per_sec"] / max(one["imgs_per_sec"], 1e-9)
        log(f"closed loop {CROSS_LOOP_S:.0f} s at concurrency "
            f"{CROSS_CONCURRENCY} on {n_cards} card(s) ({card}): 1 agent "
            f"{one['imgs_per_sec']} images/s (p50/p99 {one['p50_ms']}/"
            f"{one['p99_ms']} ms, lost {one['lost']}), 2 agents "
            f"{two['imgs_per_sec']} (p50/p99 {two['p50_ms']}/"
            f"{two['p99_ms']} ms, lost {two['lost']}); scaling "
            f"{scaling:.3f}"
            + (" (one card: two contexts time-slice its SMs; not judged)"
               if n_cards < 2 else ""))
        if (one["lost"] or two["lost"] or not one["served"]
                or not two["served"]
                or (n_cards >= 2 and scaling < CROSS_MIN_SCALING)):
            raise AssertionError(f"the closed loops: {one} {two}")
        done("loops")

        # phase 25 (b), the wire fuzzer at these agents, while they serve
        # the boot weights, which the offline batch holds
        net = net_live(cfg, urls, canvases, want, card)
        done("net")

        # phase 21, the rollout plane, over these agents before the kill
        rollout = phase_rollout(dev, card, cfg, pred, agents, canvases,
                                _CROSS["store"])
        done("rollout")

        # (d) SIGKILL one agent mid-burst under the live scheduler
        problems = []
        kill = crosshost.host_kill_leg(
            ccfg, {}, agents, sources, CROSS_KILL_S, CROSS_CONCURRENCY,
            20_000.0, problems, submit=_submit_source,
            restore_timeout_s=60.0, sched_over={"cooldown_s": 20.0})
        deadline = time.monotonic() + 20.0
        free_end = cross_free(devices)
        while (abs(free_end - free0) > CROSS_MEM_SLACK
               and time.monotonic() < deadline):
            time.sleep(0.5)
            free_end = cross_free(devices)
        log(f"kill mid-burst with the live scheduler ({card}): "
            f"{kill['served']} served, {kill['served_after_kill']} after the "
            f"kill (reaped {kill['kill_reap_s']} s after the signal), lost "
            f"{kill['lost']}, client {kill['client']}, rerouted "
            f"{kill['rerouted']}, ejects {kill['ejects']}; the survivor "
            f"grown in {kill['capacity_restore_s']} s (joins "
            f"{kill['survivor_joins']} s, builds "
            f"{kill['survivor_builds_after_warm']}), actions "
            f"{kill['scheduler_actions']}; the agents' cards' free memory "
            f"with both up {(free_up - free0) / 2 ** 20:+.1f} MiB, after "
            f"the agents are gone {(free_end - free0) / 2 ** 20:+.1f} MiB")
        reqs = kill["requests"]
        slow = sorted(reqs, key=lambda r: r["end"] - r["t"])[-3:]
        log(f"the kill leg's {len(reqs)} requests (SIGKILL at "
            f"{kill['kill_at_s']} s; seconds from the burst's start): "
            f"{sum(len(r['dispatches']) > 1 for r in reqs)} dispatched more "
            f"than once, outcomes "
            f"{dict(collections.Counter(r['outcome'] for r in reqs))}; the "
            f"slowest " + "; ".join(
                f"{r['t']}-{r['end']} {r['outcome']} {r['dispatches']}"
                for r in slow))
        if problems or abs(free_end - free0) > CROSS_MEM_SLACK:
            raise AssertionError(f"the kill leg: {problems}; {kill}; free "
                                 f"{free0} {free_end}")
        done("kill")
        del offline, pred
    finally:
        cross_stop()
        _CROSS.clear()
        shutil.rmtree(CROSS_DIR, ignore_errors=True)
        shutil.rmtree(CROSS_EXPORT, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 20 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(store=sorted(report.get("kernels", {})), ready=ready, boot_s=boot_s, shipped=shipped,
                health=health, equal=equal, bytes_v1=per_v1,
                bytes_v2=per_v2, bytes_ratio=ratio, batches=batches,
                launches=launches, trace_hosts=hosts, one=one, two=two,
                scaling=scaling, kill=kill,
                free_mib={"up": (free_up - free0) / 2 ** 20,
                          "end": (free_end - free0) / 2 ** 20},
                parts_s=parts, wall_s=wall, cards=n_cards, rollout=rollout,
                net=net, host=host)


# ---- phase 21: the rollout plane, the fifteenth main path -------------------

ROLLOUT_BURST_S = 8.0       # each leg's burst (the swap runs under it)
ROLLOUT_POST_S = 3.0        # the mixed-bucket burst after the swap
ROLLOUT_DAMAGE = 10.0       # tools/rollout.py's red-team noise scale


def rollout_finite(pred, cfg) -> bool:
    """Whether ``pred``'s raw outputs on each bucket's dummy batch are all
    finite (judged on the host: no kernel this process has not run)."""
    import numpy as np

    from mx_rcnn_tpu_torch.serve.export import _dummy_batch

    for b in cfg.bucket.shapes:
        out = pred.raw(*_dummy_batch(tuple(b), cfg.serve.batch_size))
        if not all(np.isfinite(t.float().cpu().numpy()).all() for t in out
                   if t.is_floating_point()):
            return False
    return True


def rollout_damaged(pred, cfg, dev):
    """The red-team arm's predictor: ``tools/rollout.py``'s damage of
    every matrix at ROLLOUT_DAMAGE.  Its outputs must be finite through
    the full depth: a refusal of non-finite scores would be for the wrong
    reason."""
    from mx_rcnn_tpu_torch.serve.export import (predictor_from_variables,
                                                predictor_variables)
    from mx_rcnn_tpu_torch.tools.rollout import _damaged_variables

    damaged = predictor_from_variables(
        _damaged_variables(predictor_variables(pred), ROLLOUT_DAMAGE), cfg,
        dev)
    if not rollout_finite(damaged, cfg):
        raise AssertionError("the damaged weights give non-finite outputs")
    return damaged


def phase_rollout(dev, card: str, cfg, pred, agents, prepared,
                  boot_store: str) -> dict:
    """Phase 21: the rollout plane (module docstring) over phase 20's
    agents, before its kill leg; its stores under ``CROSS_DIR/rollout``.
    ``pred`` holds the boot store's weights, ``prepared`` phase 20's
    request canvases."""
    import gc

    import torch

    from mx_rcnn_tpu_torch.serve.agent import make_store_server
    from mx_rcnn_tpu_torch.serve.export import (ExportStore,
                                                export_serve_programs,
                                                manifest_sha)
    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.serve.rollout import AgentRolloutPort
    from mx_rcnn_tpu_torch.serve.scheduler import AgentAdmin
    from mx_rcnn_tpu_torch.tools import crosshost
    from mx_rcnn_tpu_torch.tools import rollout as rollout_tool

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    work = CROSS_DIR / "rollout"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    roots = {v: str(work / f"store_{v}") for v in ("v2", "v2d", "v1")}
    servers = []
    try:
        # the stores: v2 the boot weights, a child of the boot store; v2d
        # damaged, the same parent; v1 a versioned store without a parent
        # (the truth table's unrooted case; no weights bundled)
        export_serve_programs(pred, cfg, roots["v2"], version="v2",
                              parent=boot_store, bundle_variables=True)
        damaged = rollout_damaged(pred, cfg, dev)
        export_serve_programs(damaged, cfg, roots["v2d"], version="v2d",
                              parent=boot_store, bundle_variables=True)
        del damaged
        gc.collect()
        torch.cuda.empty_cache()
        export_serve_programs(pred, cfg, roots["v1"], version="v1")
        problems = []
        lineage = rollout_tool._lineage_leg(
            cfg, pred, str(work), boot_store, roots["v2"], problems,
            unrooted_root=roots["v1"], legacy_root=boot_store)
        v2d_lineage = ExportStore(roots["v2d"]).check_lineage(
            known_parents={manifest_sha(boot_store)})
        log(f"phase 21: stores v2, v2d (damage x{ROLLOUT_DAMAGE:g} on every "
            f"matrix, finite outputs), v1 exported on {card}; the lineage "
            f"table "
            + ", ".join(f"{k} {'refused' if v['refused'] else 'admitted'}"
                        for k, v in lineage["cases"].items())
            + f"; v2d's lineage {v2d_lineage}")
        if problems or v2d_lineage.get("legacy"):
            raise AssertionError(f"the lineage table: {problems} {lineage}")
        done("stores")

        urls = {}
        for v in ("v2", "v2d"):
            srv = make_store_server(roots[v])
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
            urls[v] = f"http://127.0.0.1:{srv.server_address[1]}"
        agent_urls = [a.url for a in agents]
        rcfg = rollout_tool.rollout_config(cfg)
        admin = AgentAdmin.from_config(agent_urls, rcfg)
        port = AgentRolloutPort(admin)
        before = [crosshost._healthz(u) for u in agent_urls]
        router, feed = build_crosshost_router(rcfg, agent_urls)
        try:
            swap = rollout_tool.live_swap_leg(
                router, port, admin, agents, rcfg, prepared, urls["v2"],
                ROLLOUT_BURST_S, ROLLOUT_POST_S, 20_000.0, problems)
            mid = [crosshost._healthz(u) for u in agent_urls]
            done("swap")
            red = rollout_tool.redteam_leg(
                router, port, admin, rcfg, prepared, urls["v2d"],
                ROLLOUT_BURST_S, 20_000.0, problems)
            done("redteam")
        finally:
            feed.close()
            router.close()
        after = [crosshost._healthz(u) for u in agent_urls]
        with servers[0].stats_lock:
            v2_reqs = [r["rel"] for r in servers[0].requests]
        shipped = {rel: v2_reqs.count(rel) for rel in servers[0].index}
        swap_deltas, red_deltas = swap["shadow_deltas"], red["shadow_deltas"]

        def delta(key, a, b):
            return sum(y[key] - x[key] for x, y in zip(a, b))

        batches = delta("engine_batches", before, after)
        warms = delta("replica_warms", before, after)
        launches = {k: sum(y["kernel_launches"][k] - x["kernel_launches"][k]
                           for x, y in zip(before, after))
                    for k in before[0]["kernel_launches"]}
        # a replica's join from its store runs each bucket's forward and
        # the postprocess once: K1 once a bucket plus once, K2 once a
        # bucket; every engine batch launches K1 twice and K2 once
        n_b = len(cfg.bucket.shapes)
        want = {"nms_sweep": 2 * batches + (n_b + 1) * warms,
                "roi_align_fwd": batches + n_b * warms}
        builds = [h["kernel_builds_after_warm"] for h in after]
        log(f"phase 21 live swap v1 -> v2 mid-burst on {card}: "
            f"{swap['phase']}, {swap['served']} served of "
            f"{swap['submitted']}, lost {swap['lost']}, events "
            f"{swap['events']}; hosts {swap['hosts']}; each v2 file shipped "
            f"{sorted(set(shipped.values()))} time(s), second pulls "
            f"already {swap['repull_already']}; kernel builds in the "
            f"post-swap burst {swap['builds_during_post_swap_burst']}; "
            f"the gate {swap['gate']}; shadow pairs (base, canary) "
            f"{swap['shadow_pairs']}")
        log(f"phase 21 red team (v2d) on {card}: {red['phase']} "
            f"({red['rollback_reason']}, rollback {red['rollback_s']} s), "
            f"{red['served']} served of {red['submitted']}, lost "
            f"{red['lost']}, events {red['events']}; hosts {red['hosts']}; "
            f"the gate {red['gate']}; shadow pairs (base, canary) "
            f"{red['shadow_pairs']}; the "
            f"scheduler's second rollback {red['rollback_noop']}")
        log(f"phase 21 launches over both legs, summed over the agents: "
            f"{launches} for {batches} engine batches and {warms} replica "
            f"joins from a store (want K1 {want['nms_sweep']}, K2 "
            f"{want['roi_align_fwd']}); kernel builds after the warm "
            f"{builds}")
        if (problems or set(shipped.values()) != {len(agents)}
                or any(d != 0.0 for d in swap_deltas) or not swap_deltas
                or not red_deltas
                or not all(math.isfinite(d) for d in red_deltas)
                or any(builds) or not batches
                or {k: launches[k] for k in want} != want
                or any(v for k, v in launches.items() if k not in want)):
            raise AssertionError(
                f"phase 21: {problems}; shipped {shipped}; deltas "
                f"{swap_deltas} {red_deltas}; launches {launches} want "
                f"{want}; builds {builds}")
        done("checks")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 21 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(lineage=lineage, swap=swap, redteam=red,
                shipped=shipped, batches=batches,
                warms=warms, launches=launches, want=want, mid=[
                    {k: h[k] for k in ("engine_batches", "replica_warms",
                                       "kernel_launches")} for h in mid],
                parts_s=parts, wall_s=wall)


FT_DIR = REPO / "_chip" / "ft"       # the crash loop's and storm's trees
FT_CRASH_IMAGES = 16       # synthetic 608x1024 images: 16 steps an epoch
FT_STORM_IMAGES = 8        # on 2 ranks 4 steps an epoch (accum 2 on 1)
# the crash loop's cadence on the card: a snapshot every 16 steps
FT_OVERHEAD = dict(steps=32, snapshot_every=16, warmup=3)
# bench.py's configuration (bench.py:30-34): ResNet-101 e2e, 81 classes,
# batch 2 on the 608x1024 bucket, bf16, pre/post-NMS 6000/2000
FT_PROFILE = ["--network", "resnet101", "--dataset", "coco",
              "--batch_images", "2", "--shape", "608x1024", "--prenms",
              "6000", "--check"]


def ft_profile(args: list, out: Path) -> dict:
    """``tools/profile_step.py`` in this process (its lines to ``out``):
    the record, and the whole run's kernel launches."""
    from mx_rcnn_tpu_torch import kernels
    from mx_rcnn_tpu_torch.tools import profile_step

    kernels.reset_launch_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec = profile_step.main(args)
    finally:
        out.write_text(buf.getvalue())
    rec["run_launches"] = fp_launches() if "--quant" not in args else \
        kernels.launch_counts()
    return rec


def ft_leg(args: list, name: str) -> dict:
    """``tools/crashloop.py`` in a process of its own; its JSON record."""
    rec_path = OUT_DIR / f"{name}.json"
    res, wall = _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.crashloop",
         "--network", "resnet101", "--image_size", "608x1024", "--smoke",
         "--check", "--out", str(rec_path), *args], OUT_DIR / f"{name}.txt",
        timeout=600)()
    if res.returncode:
        raise AssertionError(f"phase 22: {name} exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    rec = json.loads(rec_path.read_text())
    rec["leg_s"] = wall
    return rec


def ft_legs():
    """Phase 22's (b) and (c), ``tools/crashloop.py --smoke --check`` and
    ``--elastic --smoke --check``, run beside each other, each in
    processes of its own: (crash loop record, storm record)."""
    shutil.rmtree(FT_DIR, ignore_errors=True)
    FT_DIR.mkdir(parents=True)
    crash_bg = in_background(ft_leg, [
        "--num_images", str(FT_CRASH_IMAGES), "--skip_overhead",
        "--workdir", str(FT_DIR / "crash")], "crashloop")
    storm_bg = in_background(ft_leg, [
        "--elastic", "--num_images", str(FT_STORM_IMAGES), "--workdir",
        str(FT_DIR / "storm")], "storm")
    return crash_bg(), storm_bg()


def phase_ft(dev, card: str, legs) -> dict:
    """Phase 22: fault-tolerant and elastic training, ResNet-101 in bf16
    on the 608x1024 bucket.  (a) ``tools/profile_step.py --check`` at
    bench.py's configuration: the stage table, K1, K2 and K3 once a
    chained iteration in their stages, no kernel built in a timed pass;
    then ``--nms_mode per_image --quant``: K1 once an image in the
    proposal stage, K4/K5 in the int8 forward.  (b) ``tools/crashloop.py
    --smoke --check`` (control, TERM mid-epoch, a torn write and a KILL
    at the boundary): the survivor byte-equal to the control, K1/K2/K3
    1/1/1 a step in every child.  (c) ``--elastic --smoke --check``: TERM
    a rank's host, shrink 2 ranks to 1 with grad_accum 2, grow back,
    complete; every restore bit-identical, steps per epoch unchanged.
    (b) and (c) are ``legs``, the records of :func:`ft_legs` (main runs
    it beside the lanes); then
    ``measure_snapshot_overhead(network='resnet101')`` alone against the
    tool's 5% ceiling."""
    from mx_rcnn_tpu_torch.ft.supervisor import measure_snapshot_overhead
    from mx_rcnn_tpu_torch.tools.crashloop import MAX_OVERHEAD_PCT

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    try:
        # (a) the step profiler
        prof = ft_profile(FT_PROFILE + ["--iters", "8"],
                          OUT_DIR / "profile_step.txt")
        stages, launches = prof["stage_ms"], prof["launches"]
        for label, ms in stages.items():
            per = launches.get(label, {})
            log(f"  profile_step {label:<34s} {ms:9.3f} ms  K1 "
                f"{per.get('nms_sweep', 0):g} K2 "
                f"{per.get('roi_align_fwd', 0):g} K3 "
                f"{per.get('roi_align_bwd', 0):g}")
        full = "FULL train step (donated)"
        want = {"proposal (decode+topk+NMS)": (1, 0, 0),
                "roi_align": (0, 1, 0),
                "full loss fwd (no bwd)": (1, 1, 0),
                "full loss fwd+bwd (no update)": (1, 1, 1), full: (1, 1, 1)}
        got = {k: tuple(launches[k][n] for n in PATH_KERNELS) for k in want}
        sum_ratio = stages["sum of pieces (approx)"] / stages[full]
        log(f"phase 22 (a): stages' sum {stages['sum of pieces (approx)']:.3f}"
            f" ms against the full step {stages[full]:.3f} ms (ratio "
            f"{sum_ratio:.3f}); builds in timed passes "
            f"{sum(prof['builds'].values())}; the run's launches "
            f"{prof['run_launches']}; {card}")
        if got != want or any(prof["builds"].values()) or \
                not all(prof["run_launches"][k] for k in PATH_KERNELS):
            raise AssertionError(f"phase 22 (a): launches {got} want {want}, "
                                 f"builds {prof['builds']}")
        done("profile")
        per_image = ft_profile(FT_PROFILE + ["--iters", "2", "--nms_mode",
                                             "per_image", "--quant"],
                               OUT_DIR / "profile_step_per_image.txt")
        pl = per_image["launches"]
        prop = pl["proposal (decode+topk+NMS)"]
        quant = pl["inference fwd (int8/native)"]
        log(f"phase 22 (a): per_image proposal "
            f"{per_image['stage_ms']['proposal (decode+topk+NMS)']:.3f} ms "
            f"(batched {stages['proposal (decode+topk+NMS)']:.3f}), K1 "
            f"{prop['nms_sweep']:g} an iteration; int8 forward "
            f"{per_image['stage_ms']['inference fwd (int8/native)']:.3f} ms "
            f"against fp {per_image['stage_ms']['inference fwd (fp)']:.3f},"
            f" K4 {quant['quantize_act']:g} K5 {quant['qconv_s8']:g} an "
            f"iteration")
        if prop["nms_sweep"] != 2 or not quant["quantize_act"] or \
                not quant["qconv_s8"] or any(per_image["builds"].values()):
            raise AssertionError(f"phase 22 (a) per_image: {pl}")
        done("profile_per_image")

        # (b) and (c), run beside each other and the lanes
        crash, storm = legs
        children = [("control", crash["control"])] + [
            (f"attempt {a['attempt']}", a) for a in crash["attempts"]]
        for label, c in children:
            per = c["launches_per_step"]
            if not c["steps_run"] or any(per[k] != 1 for k in PATH_KERNELS) \
                    or any(per[k] for k in QUANT_KERNELS):
                raise AssertionError(f"phase 22 (b) {label}: {c}")
        log(f"phase 22 (b): survivor byte-equal {crash['files_identical']}, "
            f"kills {crash['kills_survived']}/{crash['kills_planned']}, "
            f"fallbacks {crash['fallback_events']}; control "
            f"{crash['control_wall_s']} s to step {crash['total_steps']}; "
            + "; ".join(f"attempt {a['attempt']} plan {a['plan']} resumed at "
                        f"{a['resume_step']} exit {a['exit']} to step "
                        f"{a['progress_step']}, first step "
                        f"{a['first_step_s']} s after start, {a['wall_s']} s"
                        for a in crash["attempts"])
            + f"; K1/K2/K3 1/1/1 a step in all {len(children)} children (K1 "
            f"at the JAX supervisor's pre/post-NMS 1024/300); "
            f"{crash['leg_s']:.1f} s beside the storm and the lanes; "
            f"{card}")
        log(f"phase 22 (c): {storm['rig']}; restores {storm['restores']} "
            f"bit-identical {storm['restores_bit_identical']}, grad_accum "
            f"{storm['grad_accums']}, steps per epoch "
            f"{storm['manifest_steps_per_epoch']} (recipe "
            f"{storm['steps_per_epoch']}), final step "
            f"{storm['final_step']}/{storm['total_steps']}, "
            f"{storm['steps_left_at_grow']} steps left at the grow; "
            f"recovery ms {storm['recovery_ms']['by_kind']}; worlds "
            f"{storm['worlds_launched']}; {storm['leg_s']:.1f} s beside the "
            f"crash loop and the lanes; {card}")

        # the snapshot stall, alone on the card
        ov = measure_snapshot_overhead(network="resnet101", **FT_OVERHEAD)
        log(f"phase 22 (b): snapshot overhead {ov}; ceiling "
            f"{MAX_OVERHEAD_PCT}%; {card}")
        if ov["async_stall_overhead_pct"] > MAX_OVERHEAD_PCT:
            raise AssertionError(
                f"phase 22 (b): async snapshot stall "
                f"{ov['async_stall_overhead_pct']}% > {MAX_OVERHEAD_PCT}%")
        done("overhead")
    finally:
        shutil.rmtree(FT_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 22 took {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return dict(profile=prof, per_image=per_image, crashloop=crash,
                storm={k: v for k, v in storm.items() if k != "timeline"},
                overhead=ov, sum_ratio=sum_ratio, parts_s=parts,
                wall_s=wall)


TS_DIR = REPO / "_chip" / "train_step"   # phase 23's stores and copies
# crash states a crash point (the tool's --smoke default 128): the planted
# no-fsync arm's 3408 states took 62.9 s of a core on the card host
TS_MAX_STATES = 32
# bench.py's configuration (bench.py:30-34) through tools/train.py's flags:
# ResNet-101 e2e, 81 classes, batch 2, the 608x1024 bucket (the synthetic
# stand-in images' only one), bf16, pre/post-NMS 6000/2000
TS_ARGS = ["--network", "resnet101", "--dataset", "coco", "--batch_images",
           "2", "--set", "train__rpn_pre_nms_top_n=6000"]
# the join: argv[1] the package copy's root, argv[2] the store, the rest
# tools/train.py's flags; the store's libraries installed into the copy's
# empty _build/, the step from the same start state and batch held to the
# store's digest
TS_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import json, time
t0 = time.perf_counter()
import mx_rcnn_tpu_torch
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.serve.export import (
    TRAIN_STEP, ExportStore, load_train_step, pinned_algorithms,
    train_step_inputs, train_step_outputs)
from mx_rcnn_tpu_torch.tools import train
args = train.parse_args(sys.argv[3:])
cfg = train.config_from_args(args)
store = ExportStore(sys.argv[2])
with pinned_algorithms():
    step = load_train_step(store, cfg, "cuda")
    state, batch = train_step_inputs(cfg, args.seed, "cuda")
    kernels.reset_launch_counts()
    state, metrics = step(state, batch)
    store.require_digest(TRAIN_STEP, train_step_outputs(state, metrics))
print(json.dumps({"package": mx_rcnn_tpu_torch.__path__[0],
                  "load_events": kernels.load_events(),
                  "launches": kernels.launch_counts(),
                  "join_s": time.perf_counter() - t0}))
"""


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def ts_export_leg() -> dict:
    """Phase 23 (a): ``tools/train.py --export_train_step`` at bench.py's
    configuration in a process of its own, then the join in a second
    process over a copy of the package whose ``_build/`` is empty (as
    ``join_bench --mode trace`` runs); (report, join record)."""
    from mx_rcnn_tpu_torch.tools.loadgen import fresh_package

    store = TS_DIR / "store"
    res, wall = _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.train", *TS_ARGS,
         "--export_train_step", str(store)],
        OUT_DIR / "train_step_export.txt", timeout=600)()
    if res.returncode:
        raise AssertionError(f"phase 23 (a): export exit {res.returncode}"
                             f"\n{res.stderr[-3000:]}")
    report = _last_json(res.stdout)
    report["leg_s"] = wall
    root = fresh_package(str(TS_DIR / "join"))
    res, wall = _start_process(
        [sys.executable, "-c", TS_CHILD, str(root), str(store), *TS_ARGS],
        OUT_DIR / "train_step_join.txt", timeout=600)()
    if res.returncode:
        raise AssertionError(f"phase 23 (a): join exit {res.returncode}"
                             f"\n{res.stderr[-3000:]}")
    join = _last_json(res.stdout)
    join["leg_s"] = wall
    join["copy"] = str(root / "mx_rcnn_tpu_torch")
    return report, join


def ts_crashsim_leg() -> dict:
    """Phase 23 (b): ``tools/crashsim.py --smoke --check --device cuda
    --max_states TS_MAX_STATES`` in a process of its own; its record."""
    rec_path = OUT_DIR / "crashsim.json"
    res, wall = _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.crashsim", "--smoke",
         "--check", "--device", "cuda", "--max_states", str(TS_MAX_STATES),
         "--workdir", str(TS_DIR / "crash"), "--out", str(rec_path)],
        OUT_DIR / "crashsim.txt", timeout=600)()
    if res.returncode:
        raise AssertionError(f"phase 23 (b): crashsim exit {res.returncode}"
                             f"\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    rec = json.loads(rec_path.read_text())
    rec["leg_s"] = wall
    return rec


def ts_legs():
    """Phase 23's legs, (a) and (b) beside each other, each in processes
    of their own: (export report, join record, crashsim record)."""
    shutil.rmtree(TS_DIR, ignore_errors=True)
    TS_DIR.mkdir(parents=True)
    crash_bg = in_background(ts_crashsim_leg)
    report, join = ts_export_leg()
    return report, join, crash_bg()


def phase_train_step(card: str, legs) -> dict:
    """Phase 23: the durability plane and the train-step store.  (a)
    ``tools/train.py --export_train_step`` at bench.py's configuration:
    the live and the loaded step bit-equal under the pinned algorithms,
    K1, K2 and K3 once a step in each and bundled with the sha of the
    library this checkout builds; a second process over a package copy
    with an empty ``_build/`` installs the store's libraries, passes
    ``require_digest`` on the same start state and batch and builds no
    kernel.  (b) ``tools/crashsim.py --smoke --check --device cuda``:
    every real arm 0 violations over at least 10 states, both planted
    arms flagged, K1 and K2 launched by the export arm's recoveries.
    ``legs`` are :func:`ts_legs`' records (main runs it beside phase
    13's legs that time nothing); this times nothing on the card."""
    from mx_rcnn_tpu_torch import kernels

    t0 = time.perf_counter()
    try:
        report, join, crash = legs
        one = {k: 1 for k in PATH_KERNELS}
        steps = {k: fp_only(v) for k, v in report["launches"].items()}
        built = {k: hashlib.sha256(
            kernels.BY_NAME[k].library_path().read_bytes()).hexdigest()
            for k in PATH_KERNELS}
        log(f"phase 23 (a): export {report['export_s']} s "
            f"({report['leg_s']:.1f} s with the process), bit_equal {report['bit_equal']} under "
            f"{report['algorithms']}, launches a step {steps}, bundled "
            f"{ {k: v[:12] for k, v in report['kernels'].items()} } "
            f"({report['bytes']} bytes), outputs sha256 "
            f"{report['outputs_sha256'][:16]}, metrics {report['metrics']}; "
            f"{card}")
        if report["bit_equal"] is not True or \
                any({k: v for k, v in s.items() if v} != one
                    for s in steps.values()) or \
                sorted(steps) != ["live", "loaded"] or \
                report["kernels"] != built:
            raise AssertionError(f"phase 23 (a): {report}")
        jl = fp_only(join["launches"])
        log(f"phase 23 (a): join over {join['copy']}: load events "
            f"{join['load_events']}, launches {jl}, digest equal, "
            f"{join['join_s']:.1f} s in the process ({join['leg_s']:.1f} s "
            f"with its start); {card}")
        if join["load_events"]["builds"] or \
                {k: v for k, v in jl.items() if v} != one or \
                Path(join["package"]).resolve() != \
                Path(join["copy"]).resolve():
            raise AssertionError(f"phase 23 (a) join: {join}")
        for name, rep in list(crash["workloads"].items()) + \
                list(crash["planted"].items()):
            launched = {k: v for k, v in rep["kernel_launches"].items() if v}
            log(f"phase 23 (b): crashsim {name}: ops {rep['ops']}, states "
                f"{rep['states_total']} (unique {rep['states_unique']}), "
                f"recovered {rep['recovered']}, refused {rep['refused']}, "
                f"violations {rep['violations']}, launches {launched}, "
                f"{rep['elapsed_s']} s; {card}")
        exp = crash["workloads"]["export"]["kernel_launches"]
        if not crash["check"]["ok"] or \
                any(r["violations"] or r["states_total"] < 10
                    for r in crash["workloads"].values()) or \
                not all(r["violations"] for r in crash["planted"].values()) \
                or not (exp["nms_sweep"] and exp["roi_align_fwd"]):
            raise AssertionError(f"phase 23 (b): {crash['check']}")
        log(f"phase 23 (b): crashsim {crash['leg_s']:.1f} s with the "
            f"process; {card}")
        launches = dict(join["launches"])
        for s in report["launches"].values():
            for k, v in s.items():
                launches[k] = launches.get(k, 0) + v
        for rep in list(crash["workloads"].values()) + \
                list(crash["planted"].values()):
            for k, v in rep["kernel_launches"].items():
                launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(TS_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    return dict(export=report, join=join, crashsim=crash,
                launches=launches, wall_s=wall)


GT_DIR = REPO / "_chip" / "gauntlet"   # phase 24's sets, checkpoints, records
# (a) the JAX slow test's red-team recipe
# (tests/test_gauntlet.py — test_paired_gate_fires_on_damaged_arm): each
# of its cells (mode, seed) a process, then the gate over their records
GT_RECIPE = ["--network", "tiny", "--epochs", "4", "--lr", "3e-3",
             "--lr_step", "3"]
GT_CELLS = (("e2e", 0), ("redteam", 0), ("e2e", 1), ("redteam", 1))
GT_GATE = GT_RECIPE + ["--seeds", "0", "1", "--compare", "e2e", "redteam"]
# (b) the flagship width: ResNet-101 in bf16 (its default compute dtype),
# one seed, one epoch of the set cut to GT_FLAGSHIP_IMAGES (train, test)
GT_FLAGSHIP = ["--network", "resnet101", "--seeds", "0", "--epochs", "1",
               "--mode", "e2e"]
GT_FLAGSHIP_IMAGES = "16,8"
# each leg's intra-op threads: the legs share the host with both lanes
# and phases 22's and 23's legs, and their work is on the card
GT_THREADS = 1
# tools/gauntlet.py's main with its train_net and test_rcnn counted: each
# call's kernel launches, a training run's steps and its ms a step (between
# the first and the last step's callback); one GAUNTLET_RUNS line, then the
# tool's own exit code.  argv[1]: the generated set's (train, test) image
# counts ('-': the tool's 400 and 100), argv[2]: the intra-op threads, the
# rest the tool's flags
GT_CHILD = """
import json, os, sys, time
os.environ["OMP_NUM_THREADS"] = sys.argv[2]
import torch
from mx_rcnn_tpu_torch import kernels
from mx_rcnn_tpu_torch.data import synthetic
from mx_rcnn_tpu_torch.tools import gauntlet, test, train
runs = []
net, evaluate = train.train_net, test.test_rcnn
torch.set_num_threads(int(sys.argv[2]))
if sys.argv[1] != "-":
    n_train, n_test = map(int, sys.argv[1].split(","))
    init = synthetic.HardSyntheticDataset.__init__

    def cut(self, image_set="train", num_images=None, *args, **kw):
        if num_images is None:
            num_images = n_train if "train" in image_set else n_test
        init(self, image_set, num_images, *args, **kw)

    synthetic.HardSyntheticDataset.__init__ = cut


def since(before):
    return {k: v - before.get(k, 0) for k, v in kernels.launch_counts().items()}


def counted_train(cfg, **kw):
    marks = []
    kw["step_callback"] = lambda step: marks.append(time.perf_counter())
    before = kernels.launch_counts()
    out = net(cfg, **kw)
    torch.cuda.synchronize()
    runs.append(dict(kind="train", prefix=kw["prefix"], steps=len(marks),
                     ms_step=(marks[-1] - marks[0]) / (len(marks) - 1) * 1e3,
                     launches=since(before)))
    return out


def counted_eval(cfg, **kw):
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    out = evaluate(cfg, **kw)
    torch.cuda.synchronize()
    runs.append(dict(kind="eval", prefix=kw["prefix"],
                     s=time.perf_counter() - t0, launches=since(before)))
    return out


train.train_net, test.test_rcnn = counted_train, counted_eval
rc = gauntlet.main(sys.argv[3:])
print("GAUNTLET_RUNS " + json.dumps(runs), flush=True)
sys.exit(rc)
"""


def gt_leg(name: str, args: list, images: str = "-") -> dict:
    """``tools/gauntlet.py`` through :data:`GT_CHILD` in a process of its
    own, over its own generated set under :data:`GT_DIR`: its exit code,
    counted runs, JSON lines and records."""
    root = GT_DIR / name
    out = root / "results.json"
    res, wall = _start_process(
        [sys.executable, "-c", GT_CHILD, images, str(GT_THREADS), *args,
         "--root", str(root),
         "--workdir", str(root / "work"), "--out", str(out)],
        OUT_DIR / f"gauntlet_{name}.txt", timeout=900)()
    tagged = [ln for ln in res.stdout.splitlines()
              if ln.startswith("GAUNTLET_RUNS ")]
    if not tagged or not out.exists():
        raise AssertionError(f"phase 24 {name}: exit {res.returncode}, no "
                             f"record\n{res.stderr[-3000:]}")
    return dict(rc=res.returncode, wall_s=wall,
                runs=json.loads(tagged[-1].split(" ", 1)[1]),
                lines=[json.loads(ln) for ln in res.stdout.splitlines()
                       if ln.startswith("{")],
                records=json.loads(out.read_text()), work=root / "work")


def gt_legs():
    """Phase 24's gauntlet runs, each in a process of its own: the four
    red-team cells and the flagship beside each other, then the gate,
    ``--compare e2e redteam`` over the cells' records (reused, no
    training): (cells, gate, flagship)."""
    shutil.rmtree(GT_DIR, ignore_errors=True)
    GT_DIR.mkdir(parents=True)
    cell_bgs = [in_background(gt_leg, f"{mode}-s{seed}", GT_RECIPE + [
        "--mode", mode, "--seeds", str(seed)]) for mode, seed in GT_CELLS]
    flagship = gt_leg("flagship", GT_FLAGSHIP, GT_FLAGSHIP_IMAGES)
    cells = [bg() for bg in cell_bgs]
    (GT_DIR / "gate").mkdir()
    (GT_DIR / "gate" / "results.json").write_text(json.dumps(
        [r for c in cells for r in c["records"]], indent=1))
    return cells, gt_leg("gate", GT_GATE), flagship


def gt_check_runs(name: str, leg: dict) -> dict:
    """Every training run launched K1, K2 and K3 once a step and no
    quantized kernel; every eval K1 twice and K2 once a batch, K3 never.
    The summed launches of the leg."""
    total: dict = {}
    for run in leg["runs"]:
        got = run["launches"]
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        if run["kind"] == "train":
            ok = run["steps"] > 0 and all(
                got.get(k) == run["steps"] for k in PATH_KERNELS)
        else:
            ok = got.get("roi_align_fwd", 0) > 0 and \
                got.get("nms_sweep") == 2 * got["roi_align_fwd"] and \
                not got.get("roi_align_bwd")
        if not ok or any(got.get(k) for k in QUANT_KERNELS):
            raise AssertionError(f"phase 24 {name}: launches {run}")
    return total


def phase_gauntlet(card: str, legs) -> dict:
    """Phase 24: the accuracy gauntlet, ``tools/gauntlet.py``, in
    processes of their own beside the lanes.
    (a) the paired red-team gate at the JAX slow test's recipe (tiny,
    seeds 0 1, 4 epochs, lr 3e-3, step 3): each of its four cells
    (:data:`GT_CELLS`) a process, then ``--compare e2e redteam``
    over their records, which trains nothing: exit 1, every delta below
    -budget, the mean delta below -0.05, ``within_budget`` false, every
    redteam record damaged ``test__nms=0.9``, and at each seed the e2e and
    redteam checkpoints byte-equal though two processes wrote them (the
    shared training bits under the tool's pins).  (b) the flagship width:
    ResNet-101 in bf16, seed 0, one epoch of :data:`GT_FLAGSHIP_IMAGES`,
    ``--mode e2e``, beside the cells: one record with a finite mAP in
    [0, 1] (recorded, not judged).  In both, K1, K2 and K3 once a
    training step, K1 twice and K2 once an eval batch.  ``legs`` are :func:`gt_legs`' records (main runs it
    beside the lanes); this times nothing on the card."""
    t0 = time.perf_counter()
    try:
        cells, gate, flag = legs
        for name, leg in [("(a)", c) for c in cells] + [("(b)", flag)]:
            for run in leg["runs"]:
                what = (f"{run['steps']} steps, {run['ms_step']:.2f} ms a "
                        f"step" if run["kind"] == "train"
                        else f"eval {run['s']:.1f} s")
                log(f"phase 24 {name}: {Path(run['prefix']).name} {what}, "
                    f"launches {fp_only(run['launches'])}")
        cmp = [ln for ln in gate["lines"] if "compare" in ln]
        log(f"phase 24 (a): cells {[round(c['wall_s'], 1) for c in cells]} "
            f"s with their processes, exits {[c['rc'] for c in cells]}; the "
            f"gate exit {gate['rc']}, {cmp[-1] if cmp else None}, "
            f"{gate['wall_s']:.1f} s; {card}")
        if any(c["rc"] for c in cells) or gate["runs"]:
            raise AssertionError(f"phase 24 (a): cells exit "
                                 f"{[c['rc'] for c in cells]}, the gate "
                                 f"trained {gate['runs']}")
        if gate["rc"] != 1 or not cmp:
            raise AssertionError(f"phase 24 (a): exit {gate['rc']}: the gate "
                                 f"did not fire; {gate['lines']}")
        cmp = cmp[-1]
        if cmp["compare"] != "redteam-vs-e2e" or \
                not all(d < -cmp["budget"] for d in cmp["deltas"]) or \
                not cmp["mean_delta"] < -0.05 or \
                cmp["within_budget"] is not False or \
                cmp["seeds"] != [0, 1]:
            raise AssertionError(f"phase 24 (a): {cmp}")
        records = gate["records"]
        if sorted((r["mode"], r["seed"]) for r in records) != [
                ("e2e", 0), ("e2e", 1), ("redteam", 0), ("redteam", 1)] or \
                any(r["damage"] != "test__nms=0.9" for r in records
                    if r["mode"] == "redteam"):
            raise AssertionError(f"phase 24 (a): records {records}")
        same = {}
        for seed in (0, 1):
            a, b = (GT_DIR / f"{m}-s{seed}" / "work" /
                    f"{m}-tiny-s{seed}-0004.ckpt" for m in ("e2e", "redteam"))
            same[seed] = a.read_bytes() == b.read_bytes()
        log(f"phase 24 (a): e2e and redteam checkpoints byte-equal {same}; "
            f"mAPs {[(r['mode'], r['seed'], r['mAP']) for r in records]}")
        if not all(same.values()):
            raise AssertionError(f"phase 24 (a): training bits differ {same}")
        launches: dict = {}
        for c in cells + [flag]:
            for k, v in gt_check_runs(c["work"].parent.name, c).items():
                launches[k] = launches.get(k, 0) + v
        recs = flag["records"]
        log(f"phase 24 (b): exit {flag['rc']}, records "
            f"{[(r['mode'], r['network'], r['seed'], r['mAP']) for r in recs]}"
            f", {flag['wall_s']:.1f} s with the process; {card}")
        if flag["rc"] != 0 or len(recs) != 1 or \
                recs[0]["network"] != "resnet101" or \
                not math.isfinite(recs[0]["mAP"]) or \
                not 0.0 <= recs[0]["mAP"] <= 1.0:
            raise AssertionError(f"phase 24 (b): {flag['rc']} {recs}")
        keep = [{k: v for k, v in leg.items() if k != "work"}
                for leg in cells + [gate, flag]]
        (OUT_DIR / "gauntlet.json").write_text(json.dumps(keep, indent=1))
    finally:
        shutil.rmtree(GT_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    return dict(redteam=dict(compare=cmp, records=records,
                             cells=[dict(runs=c["runs"], wall_s=c["wall_s"])
                                    for c in cells],
                             gate_s=gate["wall_s"], checkpoints_equal=same),
                flagship=dict(records=recs, runs=flag["runs"],
                              wall_s=flag["wall_s"]),
                launches=launches, wall_s=wall)


# ---- the lanes --------------------------------------------------------------

# after the kernels line's timed comparisons (phases 2-4 and phase 16's
# kernels) and phases 5-9, which run with the card to themselves, phases
# 10, 12, the rest of 16 and 17 run here (lane A) while lane B runs the
# phases of LANES in a process of its own (this script with LANE_FLAG),
# and phases 22-24's legs in theirs, all beside each other; phases 11
# and 18-22 run after them, alone
# ---- phase 25: the network surface's linter and fuzzer --------------------

NET_SEED = 16               # tools/wirefuzz.py's default seed
NET_CASES = 572             # the JAX record's corpus_cases at that seed
# the agent leg's cases that send good frames, and their frames (the
# envelope carries two): the only ones that may reach an engine
NET_GOOD = {"http:pipelined-garbage": 1, "http:tr:good-traced-frame": 1,
            "http:v2:good-source-frame": 1, "http:env:good-envelope": 2,
            "aftermath:good-frame": 1}
NET_MODES = {"pass", "truncate", "reset", "split", "delay", "blackhole"}


def net_host_legs() -> dict:
    """Phase 25 (a): ``python -m mx_rcnn_tpu_torch.analysis.netlint`` over
    the port and the full ``tools/wirefuzz.py --seed 16`` (its stand-in
    agents on the host), each in a process of its own, beside each
    other: their exit codes, records and seconds."""
    fuzz_path = OUT_DIR / "wirefuzz.json"
    fuzz_path.unlink(missing_ok=True)
    lint = _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.analysis.netlint",
         "--json", "--show-waived"], OUT_DIR / "netlint.txt", timeout=300)
    fuzz = _start_process(
        [sys.executable, "-m", "mx_rcnn_tpu_torch.tools.wirefuzz", "--seed",
         str(NET_SEED), "--out", str(fuzz_path)], OUT_DIR / "wirefuzz.txt",
        timeout=300)
    (lres, lint_s), (fres, fuzz_s) = lint(), fuzz()
    findings = [json.loads(ln) for ln in lres.stdout.splitlines()
                if ln.startswith("{")]
    return dict(netlint_rc=lres.returncode, netlint_s=lint_s,
                netlint_summary=lres.stderr.strip().splitlines()[-1:],
                waived=[f"{f['path']}:{f['line']} {f['code']}"
                        for f in findings if f["waived"] is not None],
                unwaived=[f for f in findings if f["waived"] is None],
                wirefuzz_rc=fres.returncode, wirefuzz_s=fuzz_s,
                wirefuzz=(json.loads(fuzz_path.read_text())
                          if fuzz_path.exists() else None),
                wirefuzz_err=fres.stderr[-3000:])


def check_net_host(rec: dict, card: str) -> dict:
    """Phase 25 (a)'s checks and line; the record without the leg
    records' bulk."""
    doc = rec["wirefuzz"] or {}
    legs = doc.get("legs", {})
    log(f"phase 25 (a): netlint on the port exit {rec['netlint_rc']} "
        f"({rec['netlint_summary']}, {rec['netlint_s']:.1f} s; waived "
        f"{rec['waived']}); tools/wirefuzz.py --seed {NET_SEED} exit "
        f"{rec['wirefuzz_rc']} in {rec['wirefuzz_s']:.1f} s ({card}'s "
        f"host): ok {doc.get('ok')}, {doc.get('corpus_cases')} cases, "
        f"violations {doc.get('value')}, "
        + ", ".join(f"{k} {v['cases']} {v['outcomes']}"
                    for k, v in legs.items())
        + f"; planted ok {doc.get('planted', {}).get('ok')}")
    if (rec["netlint_rc"] or rec["unwaived"] or rec["wirefuzz_rc"]
            or not doc.get("ok") or doc.get("value")
            or not doc.get("planted", {}).get("ok")
            or doc.get("corpus_cases") != NET_CASES
            or sorted(legs) != ["agent", "codec", "httpsource", "proxy"]
            or any(v["violations"] for v in legs.values())):
        raise AssertionError(f"phase 25 (a): {json.dumps(rec)[:3000]}")
    return dict(rec, wirefuzz={k: doc[k] for k in (
        "ok", "value", "corpus_cases", "elapsed_s")} | dict(
        legs={k: {"cases": v["cases"], "outcomes": v["outcomes"]}
              for k, v in legs.items()}, planted=doc["planted"]))


def net_live(cfg, urls: list, canvases: list, want: list, card: str) -> dict:
    """Phase 25 (b): ``tools/wirefuzz.py``'s agent leg aimed at phase
    20's agent 0 (ResNet-101 on the card, before phase 21, both buckets)
    and its proxy leg over both agents, agent 0 behind the
    ``FaultProxy``.  ``canvases`` are the request images' (canvas,
    im_info, bucket) triples and ``want`` their offline detections."""
    from urllib.parse import urlsplit

    from mx_rcnn_tpu_torch.serve.remote import build_crosshost_router
    from mx_rcnn_tpu_torch.tools import crosshost
    from mx_rcnn_tpu_torch.tools import wirefuzz

    t0 = time.perf_counter()
    parts = {}

    def done(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    def delta(a, b, key):
        return b[key] - a[key]

    def launches(a, b):
        return {k: b["kernel_launches"][k] - a["kernel_launches"][k]
                for k in a["kernel_launches"]}

    first = urlsplit(urls[0])
    before = [crosshost._healthz(u) for u in urls]
    agent = wirefuzz.leg_agent(NET_SEED, target=(first.hostname,
                                                 first.port, cfg))
    mid = [crosshost._healthz(u) for u in urls]
    done("agent leg")
    batches = delta(before[0], mid[0], "engine_batches")
    got_l = launches(before[0], mid[0])
    frames = sum(NET_GOOD.values())
    log(f"phase 25 (b): the agent leg at agent 0 ({card}): {agent['cases']} "
        f"cases, {agent['outcomes']}, violations {len(agent['violations'])};"
        f" agent 0's engine batches +{batches} for the {frames} good "
        f"frames in {len(NET_GOOD)} requests, launches {got_l}; agent 1's "
        f"batches +{delta(before[1], mid[1], 'engine_batches')}; kernel "
        f"builds after the warm {[h['kernel_builds_after_warm'] for h in mid]}"
        f"; /healthz ok {[h['ok'] for h in mid]}")
    want_l = {"nms_sweep": 2 * batches, "roi_align_fwd": batches}
    if (agent["violations"] or agent["cases"] < 100
            or agent["outcomes"].get("accepted_valid") != len(NET_GOOD) + 1
            or not len(NET_GOOD) <= batches <= frames
            or delta(before[1], mid[1], "engine_batches")
            or {k: got_l[k] for k in want_l} != want_l
            or any(v for k, v in got_l.items() if k not in want_l)
            or any(h["kernel_builds_after_warm"] for h in mid)
            or not all(h["ok"] for h in mid)):
        raise AssertionError(f"phase 25 (b) agent leg: {agent}; batches "
                             f"{batches}, launches {got_l}; {mid}")

    # after the attacks: a good frame of each request image, through a
    # router to agent 0 alone, byte-equal to the offline batch
    router, feed = build_crosshost_router(cfg, urls[:1])
    try:
        served = [router.submit_prepared(c, i, b, timeout_ms=0).wait(120.0)
                  for c, i, b in canvases]
    finally:
        feed.close()
        router.close()
    equal = sum(cross_same(g, w) for g, w in zip(served, want))
    done("good frames")

    proxy = wirefuzz.leg_proxy(NET_SEED, cfg=cfg, urls=urls,
                               frames=canvases, want=want)
    after = [crosshost._healthz(u) for u in urls]
    done("proxy leg")
    all_b = sum(delta(a, b, "engine_batches") for a, b in zip(before, after))
    all_l = {k: sum(launches(a, b)[k] for a, b in zip(before, after))
             for k in before[0]["kernel_launches"]}
    term = proxy["terminal"]
    log(f"phase 25 (b): after the attacks {equal} of {len(canvases)} "
        f"request images served by agent 0 byte-equal to the offline batch;"
        f" the proxy leg (agent 0 behind the FaultProxy, agent 1 direct, "
        f"{card}): {proxy['cases']} frames, {proxy['outcomes']}, terminal "
        f"{term}, violations {len(proxy['violations'])}, faults "
        f"{proxy['faults_applied']}; both agents' engine batches in (b) "
        f"{all_b}, launches {all_l}; kernel builds after the warm "
        f"{[h['kernel_builds_after_warm'] for h in after]}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    want_all = {"nms_sweep": 2 * all_b, "roi_align_fwd": all_b}
    if (equal != len(canvases) or proxy["violations"]
            or term["served"] != 14 or sum(term.values()) != 14
            or set(proxy["faults_applied"]) != NET_MODES
            or {k: all_l[k] for k in want_all} != want_all
            or any(v for k, v in all_l.items() if k not in want_all)
            or any(h["kernel_builds_after_warm"] for h in after)
            or not all(h["ok"] for h in after)):
        raise AssertionError(f"phase 25 (b): equal {equal}, proxy {proxy}, "
                             f"batches {all_b}, launches {all_l}; {after}")
    return dict(agent=agent, agent_batches=batches, agent_launches=got_l,
                equal=equal, proxy=proxy, batches=all_b, launches=all_l,
                parts_s=parts, wall_s=time.perf_counter() - t0)


LANE_FLAG = "--lane"
LANE_TIMEOUT_S = 900
LANES = {"B": (13, 14, 15)}


def _phase13(dev, card: str) -> dict:
    return phase_long_run(dev, card, long_run_checks(dev, card))


# each lane phase's key in the results and its function
LANE_PHASES = {13: ("long_run", _phase13),
               14: ("data_parallel", phase_data_parallel),
               15: ("device_cache", phase_device_cache)}


def lane_phases(name: str, dev, card: str) -> dict:
    """Lane ``name``'s phases in turn, each with its own launch counts
    and cuDNN settings (this process's); their records by key, their
    seconds and the lane's."""
    t0 = time.perf_counter()
    rec, phase_s = {}, {}
    for n in LANES[name]:
        t = time.perf_counter()
        key, fn = LANE_PHASES[n]
        rec[key] = fn(dev, card)
        phase_s[n] = time.perf_counter() - t
    return dict(rec, phase_s=phase_s, wall_s=time.perf_counter() - t0)


def lane_main(name: str, out: Path, card: str, parent: int) -> int:
    """A lane's process: killed when ``parent`` (this script's main
    process) ends, the kernels it built loaded, TF32 off as in
    :func:`main`, :func:`lane_phases`' record written to ``out``."""
    import ctypes
    import signal

    # Linux's PR_SET_PDEATHSIG: SIGKILL this process when its parent's
    # starting thread (the main thread) ends; exit now if it has
    ctypes.CDLL(None).prctl(1, int(signal.SIGKILL), 0, 0, 0)
    if os.getppid() != parent:
        return 1
    import torch

    sys.path.insert(0, str(REPO))
    from mx_rcnn_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    rec = lane_phases(name, torch.device("cuda", 0), card)
    out.write_text(json.dumps(rec))
    return 0


def start_lane(name: str, card: str):
    """Lane ``name`` (:data:`LANES`) in a process of its own (this script
    with :data:`LANE_FLAG`), started now from the main thread, in a
    process group of its own and killed if this process ends first; its
    output relayed line by line to this one's.  Returns (join, stop):
    ``join`` waits for it and gives its record, or raises; ``stop`` kills
    its process group."""
    import signal

    out = OUT_DIR / f"lane_{name}.json"
    out.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), LANE_FLAG, name,
         str(out), card, str(os.getpid())], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)

    def relay(src, dst):
        for line in src:
            print(line, end="", file=dst, flush=True)

    pumps = [threading.Thread(target=relay, args=(proc.stdout, sys.__stdout__),
                              daemon=True),
             threading.Thread(target=relay, args=(proc.stderr, sys.__stderr__),
                              daemon=True)]
    for t in pumps:
        t.start()

    def stop():
        # the group too: whatever the lane left running when it ended
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()

    def join():
        try:
            rc = proc.wait(timeout=LANE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            stop()
            raise AssertionError(f"lane {name} (phases {LANES[name]}) "
                                 f"still running after {LANE_TIMEOUT_S} "
                                 f"s") from None
        for t in pumps:
            t.join()
        if rc:
            raise AssertionError(f"lane {name} (phases {LANES[name]}): "
                                 f"exit {rc}")
        rec = json.loads(out.read_text())
        rec["phase_s"] = {int(k): v for k, v in rec["phase_s"].items()}
        return rec

    return join, stop


def kernel_line(kern, res: dict, launches: int) -> dict:
    return dict(name=kern.name, route="cuda",
                source=str(kern.source.relative_to(REPO)),
                replaces=kern.replaces, launches=launches,
                max_abs_err=res["max_abs_err"], ms=res["ms"],
                plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                bound_by=res["bound_by"], library_ms=res.get("library_ms"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    if not (REPO / "mx_rcnn_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(mx_rcnn_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mx_rcnn_tpu_torch import kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    # fp32 comparisons run in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    script_t0 = time.perf_counter()
    card = card_line()
    host = host_info(torch.device("cuda", 0))
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"host: {host_text(host)}")

    t0 = time.perf_counter()
    build_logs = kernels.build_all()
    build_s = time.perf_counter() - t0
    (OUT_DIR / "build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in build_logs.items()))
    log(f"built {len(build_logs)} kernels in {build_s:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            spills = "spill" in line and " 0 bytes spill stores" not in line
            if "Used" in line or spills:
                log(f"  {name}: {line.strip()}")
    sass = qconv_sass(build_logs)

    phase_s = {1: build_s}

    def timed(n: int, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        phase_s[n] = time.perf_counter() - t
        return res

    k1 = timed(2, phase_k1, dev)
    k2 = timed(3, phase_k2, dev)
    k3 = timed(4, phase_k3, dev)
    quant_kernels = phase_quant_kernels(dev)
    parity = timed(5, phase_forward_parity, dev)
    train_parity = timed(6, phase_train_parity, dev)
    serving = timed(7, phase_serving, dev, card)
    training = timed(8, phase_training, dev, card)
    evaluation = timed(9, phase_eval, dev, card)
    # the lanes: B in a process of its own, phases 22-24's legs in
    # theirs, all beside lane A's phases here
    lanes = {name: start_lane(name, card) for name in LANES}
    try:
        ft_bg = in_background(ft_legs)
        ts_bg = in_background(ts_legs)
        gt_bg = in_background(gt_legs)
        net_bg = in_background(net_host_legs)
        t0 = time.perf_counter()
        alternate = timed(10, phase_alternate, dev, card)
        real_data = timed(12, phase_real_data, dev, card)
        quant = timed(16, phase_quant, dev, card, quant_kernels)
        phase_s[16] += quant_kernels["wall_s"]
        obs = timed(17, phase_obs, dev, card)
        lane_s = {"A": time.perf_counter() - t0}
        recs, waits = {}, {}
        for name, (join, _) in lanes.items():
            t0 = time.perf_counter()
            recs[name] = join()
            waits[name] = time.perf_counter() - t0
            lane_s[name] = recs[name]["wall_s"]
            phase_s.update(recs[name].pop("phase_s"))
    finally:
        for _, stop in lanes.values():
            stop()
    got = {k: v for r in recs.values() for k, v in r.items()}
    long_run, data_parallel, device_cache = (
        got["long_run"], got["data_parallel"], got["device_cache"])
    long_run["snapshots"]["schedule"] = schedule_checkpoints(
        alternate["schedule"])
    # each leg's wait past the lanes counts as its phase's
    t0 = time.perf_counter()
    ft_runs = ft_bg()
    ft_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts_runs = ts_bg()
    ts_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_runs = gt_bg()
    gt_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    net_host = check_net_host(net_bg(), card)
    net_wait = time.perf_counter() - t0
    log("the lanes beside each other and phases 22-25's legs: "
        + ", ".join(f"{k} (phases {LANES.get(k, (10, 12, 16, 17))})"
                    f" {v:.1f} s" for k, v in lane_s.items())
        + "; waited " + ", ".join(f"{v:.1f} s for {k}"
                                  for k, v in waits.items())
        + f", then {ft_wait:.1f}, {ts_wait:.1f}, {gt_wait:.1f} and "
        f"{net_wait:.1f} s for the legs of phases 22, 23, 24 and 25")
    engine = timed(11, phase_engine, dev, card)
    bulk = timed(18, phase_bulk, dev, card)
    fleet = timed(19, phase_fleet, dev, card)
    cross = timed(20, phase_crosshost, dev, card)
    # phases 21 and 25 (b) run inside phase 20, over its agents before its
    # kill leg
    rollout = cross.pop("rollout")
    phase_s[21] = rollout["wall_s"]
    net = dict(cross.pop("net"), host_legs=net_host)
    phase_s[25] = net["wall_s"] + net_wait
    phase_s[20] -= phase_s[21] + net["wall_s"]
    ft = timed(22, phase_ft, dev, card, ft_runs)
    phase_s[22] += ft_wait
    train_step = timed(23, phase_train_step, card, ts_runs)
    phase_s[23] += ts_wait
    gauntlet = timed(24, phase_gauntlet, card, gt_runs)
    phase_s[24] += gt_wait
    script_s = time.perf_counter() - script_t0
    log("seconds a phase (phase 1 the build; 10 and 12-17 in the lanes"
        "): " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(phase_s.items()))
        + f"; the script {script_s:.1f} s from its start")

    # no single PyTorch call computes any of K1-K3 (the repo's bilinear
    # rules are not torchvision's, which is absent), so library_ms is
    # null; their launches are the batch-2 training CLI run's.  K4 and K5
    # count the int8 quantized eval's launches, K6 the fp8 one's; K5 and
    # K6 are timed at QCONV_LINE_SHAPE beside torch._int_mm and
    # torch._scaled_mm, K4 at the per-ROI stage-4 bn1 (no library call)
    launches = training[2]["launches"]
    qrun = quant["runs"]
    # phase 22's: the bench-configuration profile run's (K1-K3) and the
    # per-image int8 one's (K4, K5; K6 is not on it)
    ft_runs = {**ft["profile"]["run_launches"],
               **{k: ft["per_image"]["run_launches"][k]
                  for k in QUANT_KERNELS}}
    lines = [kernel_line(kernels.NMS_SWEEP, k1["train_proposal"],
                         launches["nms_sweep"]),
             kernel_line(kernels.ROI_ALIGN_FWD, k2["train"]["bf16"],
                         launches["roi_align_fwd"]),
             kernel_line(kernels.ROI_ALIGN_BWD, k3["train"]["bf16"],
                         launches["roi_align_bwd"]),
             kernel_line(kernels.QUANTIZE_ACT,
                         quant["k4"]["fused"]["int8"][K4_LINE_SHAPE],
                         qrun["int8_native"]["launches"]["quantize_act"]),
             kernel_line(kernels.QCONV_S8, quant["k5"][QCONV_LINE_SHAPE],
                         qrun["int8_native"]["launches"]["qconv_s8"]),
             kernel_line(kernels.QCONV_E4M3, quant["k6"][QCONV_LINE_SHAPE],
                         qrun["fp8_native"]["launches"]["qconv_e4m3"])]
    for line in lines:
        line["launches_phase22"] = ft_runs[line["name"]]
        if train_step["launches"].get(line["name"]):
            line["launches_phase23"] = train_step["launches"][line["name"]]
        if line["name"] in PATH_KERNELS:
            line["launches_phase24"] = gauntlet["launches"][line["name"]]
        if net["launches"].get(line["name"]):
            line["launches_phase25"] = net["launches"][line["name"]]
    (OUT_DIR / "results.json").write_text(json.dumps(dict(
        card=card, host=host, build_s=build_s, qconv_sass=sass, k1=k1,
        k2=k2, k3=k3,
        forward_parity=parity, train_parity=train_parity, serving=serving,
        training=training, evaluation=evaluation, alternate=alternate,
        engine=engine, real_data=real_data, long_run=long_run,
        data_parallel=data_parallel, device_cache=device_cache,
        quant=quant, obs=obs, bulk=bulk, fleet=fleet, crosshost=cross,
        rollout=rollout, ft=ft, train_step=train_step, gauntlet=gauntlet,
        net=net,
        phase_s={str(k): v for k, v in phase_s.items()},
        lanes=dict(seconds=lane_s, waits=waits),
        script_s=script_s), indent=1))
    print(card)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [LANE_FLAG]:
        sys.exit(lane_main(sys.argv[2], Path(sys.argv[3]), sys.argv[4],
                           int(sys.argv[5])))
    sys.exit(main())
