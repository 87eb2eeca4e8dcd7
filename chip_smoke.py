#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: MinkUNet34 inference
and training, point-cloud classification with MinkowskiFCNN and a ResNet18
classifier, shape completion with CompletionNet and a sparse VAE,
classification with MinkowskiSplatFCNN and an SE-ResNet18, the data
loader's path from raw room-scan points and the layer extras, then the bf16
compute path (MinkUNet34 and MinkowskiFCNN training in bf16),
MinkowskiSyncBatchNorm on a one-rank NCCL group, training on fresh geometry,
and the parallel package: the per-device-geometry DDP step on a one-rank
NCCL group, then two processes sharing the card over gloo for a DDP step,
the halo-exchange spatial conv and column-parallel convs; then the ported
examples, indoor.py's MinkUNet34C segmentation chain at full width first;
a 7-D sparse U-Net (multi-word coordinate keys) and a 16-D conv; the
multi-process examples on one NCCL rank and on two gloo ranks sharing the
card; the dense bbox grid: the row-grid probe against the key search;
the bf16 bodies of both kernels timed on the device alone; CompletionNet
and the VAE in bf16, each held to its own keep masks; K1's float32 bodies
on MinkUNet34's and CompletionNet's step maps; K1 and K2 on every conv
call of a Point Transformer V3 step and its attention; the kernel maps'
grid-probe kernel against its plain version; and last, one Mask3D
training step against float64 on its own decisions.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the loaded CUDA runtime's version and the card's free memory
   (the port's ``cudart_version``/``get_gpu_memory_info``); TF32 off, so
   every comparison below is full float32.
2. build: compile the CUDA kernels (``minkowskiengine_tpu_torch/csrc``) with
   nvcc for sm_90a and load them; print each instance's ptxas report
   (registers, shared memory, spills).
3. kernel check, synthetic maps: ``gather_gemm`` against its plain PyTorch
   version at every shape MinkUNet34's sparse convs give it (rows of each
   level of a 26k-voxel room scan, about 30% of indices -1).
4. kernel check, real maps: the same comparison on the 55 conv calls of one
   MinkUNet34 forward, captured with forward hooks; both timed per call.
5. inference slice: ``MinkUNet34(3, 20, D=3)`` (weights from
   torch.Generator seed 0, eval mode, no_grad) answers 3 room-scan requests
   of ~26k voxels, each with a fresh coordinate manager; wall time per
   request and points/s.  The kernel's launch count must rise by >= 55 per
   request.
6. parity: request 0 again on the CPU plain path with the same weights; the
   logits must agree with the card's.
7. backward kernels, synthetic maps: at every shape of phase 3, on the row
   counts of a batch of two scans, ``gather_gemm`` as the input gradient
   (output gradient, W[k]ᵀ, the inverse of an injective map) and
   ``conv_dw`` (the weight gradient) against their plain versions; per
   call each kernel's split S and its useful TFLOP/s
   (2 · pairs · Cin · Cout / time) and bound (below).  The same at the
   distinct shapes of MinkowskiFCNN's convs and ResNet18's k = 1, stride-2
   downsamples, on the rows of a 32-shape classification batch.
8. backward kernels, real maps: the 55 conv calls of one training step
   (inputs, kernel maps and output gradients captured with hooks); forward,
   input gradient and weight gradient against their plain versions, per
   call and summed over the step, with the bound.
9. training slice: 4 SGD steps of ``MinkUNet34(3, 20, D=3)`` in train mode,
   each on a new batch of 2 room scans (seeds 0-7) collated by
   ``sparse_collate`` into a fresh coordinate manager, cross-entropy against
   seeded labels; wall time per step and points/s.  ``gather_gemm`` must
   launch >= 109 times per step (55 forward + 54 input gradients; the stem's
   input needs none) and ``conv_dw`` 55 times.
10. gradient parity: step 0 again on the CPU plain path with the same
   weights; loss, every parameter gradient and the BN running statistics
   must agree with the card's, and its train-mode logits with the CPU
   float32 run's, as phase 14c holds logits.
11. classification inference: ``MinkowskiFCNN(3, 40, embedding_channel=1024,
   channels=(32, 48, 64, 96, 128), D=3)`` (the reference ModelNet40
   example's widths; weights from torch.Generator seed 0, eval mode)
   classifies 3 batches of 32 synthetic shapes x 2048 points (seeds 0-2,
   ``modelnet_batch`` at 2.5 cm voxels, ~48k voxels), each a TensorField
   with a fresh coordinate manager; wall time per batch and points/s.
   Logits (32, 40), finite; ``gather_gemm`` launches >= 7 per batch (its
   seven sparse convs), ``conv_dw`` none.
12. kernels on the FCNN's real maps: the 7 conv calls of one training step
   (train mode, dropout off), forward, input gradient and weight gradient
   against their plain versions, per call and summed, with the bound.
13. classification training: 4 steps of SGD (lr 0.1, momentum 0.9, weight
   decay 1e-4) on batches of seeds 0-3 with ``CoordinateTransformation``,
   cross-entropy, dropout on; wall time per step, points/s, peak memory.
   ``gather_gemm`` >= 14 launches per step (7 forward + 7 input
   gradients), ``conv_dw`` exactly 7.
14. classification parity: (a) phase 11's batch-0 logits against the CPU
   plain path; (b) phase 12's step (loss and every parameter gradient,
   dropout off) against CPU runs in float32 and float64, as phase 10;
   (c) ``ResNet18(3, 40, D=3)`` logits on batch 0 (``TensorField.sparse()``)
   on the card against the CPU; its ``gather_gemm`` launches must equal its
   sparse-conv count.

15. generative kernels, synthetic maps: ``gather_gemm`` (forward and input
   gradient) and ``conv_dw`` against their plain versions at every distinct
   sparse conv of CompletionNet and the VAE, on kernel maps built from the
   coordinates of one stand-in batch (``completion_batch``: 16 shapes at
   128^3, seed 0; each decoder level generated from the full shapes at the
   coarser stride), random features; per call S, useful TFLOP/s, the bound
   and the share of -1 slots.
16. completion inference: ``CompletionNet`` at the reference widths
   (channels 16-1024, weights from torch.Generator seed 0; batch norms
   calibrated on batch 0, see ``calibrate``) in eval mode completes 3
   batches (seeds 0-2), each in a fresh coordinate manager; wall time,
   input voxels/s, rows per decoder level, completed voxels.
   ``gather_gemm`` >= 25 launches per batch.
17. kernels on the real maps of one completion training step: its 25 conv
   calls captured with hooks, forward, input gradient and weight gradient
   against their plain versions, per call (with the -1 share) and summed.
18. completion training: 4 SGD steps (lr 0.01, momentum 0.9, weight decay
   1e-4) on seeds 0-3, loss the mean over levels of the sigmoid BCE against
   the target masks; wall time, voxels/s, rows per level, peak memory.
   ``gather_gemm`` >= 49 launches per step (25 + 24 input gradients),
   ``conv_dw`` exactly 25.
19. the VAE at the reference widths: per batch (seeds 0-1, the full
   shapes) a training step (BCE + 0.1 KL) and a generation in eval mode;
   times, rows per level, launches (per step ``gather_gemm`` >= 51,
   ``conv_dw`` 26), peak memory; batch 0's 26 conv calls against the plain
   versions, as phase 17.
20. parity on a batch of 2 shapes at 64^3 (the CPU's plain path cannot take
   full size) with the full-width weights: CompletionNet in train mode,
   per level the keep mask, coordinates and logits, and step 0's loss and
   every gradient as phase 10 judges them; the VAE's mean, log-variance and
   per-level decoder logits with the same seeded noise.  Train-mode batch
   norm over the few rows of the deepest levels puts ~1e-4 of relative
   float32 rounding on every logit, so among the ~10^5 rows of the finer
   levels a few lie that close to 0 and flip the keep mask (seed 0: one
   row of 1,800 at level 2): the CPU runs then follow the card's mask on
   those rows, printed with their margin (``ForcedPruning``), so every
   level is compared on one map.

21. kernels on the splat maps: ``MinkowskiSplatFCNN(3, 40)`` at phase 11's
   widths (weights from torch.Generator seed 0; train mode, dropout off)
   takes one training step on phase 13's first batch; its 7 conv calls,
   captured with hooks, forward, input gradient and weight gradient
   against their plain versions, per call (with the -1 share) and summed,
   with the bound.  The splat map's rows at stride 1 are printed beside
   the ``sparse()`` rows of the same batch.
22. SplatFCNN inference: phase 11's 3 batches in eval mode, each in a fresh
   coordinate manager; wall time, points/s; ``gather_gemm`` >= 7 launches
   per batch, ``conv_dw`` none.
23. SplatFCNN training: 4 SGD steps as phase 13 on its batches; wall time
   per step, points/s, peak memory; per step ``gather_gemm`` >= 14 and
   ``conv_dw`` exactly 7.
24. SplatFCNN parity: (a) phase 22's batch-0 logits against the CPU plain
   path; (b) phase 21's step (loss, every parameter gradient) against CPU
   runs in float32 and float64, as phase 14b; (c) the splatted features of
   batch 0, and ``SparseTensor.interpolate`` of the card's conv1 output at
   the field's points, on the card against the CPU.
25. SE-ResNet18 (``ResNet18``'s widths with ``SEBasicBlock``, weights from
   torch.Generator seed 0): batch-0 logits (``TensorField.sparse()``) on the
   card against the CPU, as phase 14c, with ``gather_gemm`` launches equal
   to its sparse-conv count; then 4 SGD steps on phase 13's batches, dropout
   seeded: step 0 warms up, steps 1-3 are timed, each with ``conv_dw``
   launches equal to the sparse-conv count.

26. the data loader's path, as reference users write it: two room scans of
   400,000 raw float points (``make_room_scan`` seeds 0 and 1, the room of
   phase 5's scans), colors a function of the point, labels
   ``floor(z / 0.125) mod 20``, voxelized by ``MT.utils.sparse_quantize``
   at 5 cm with ``ignore_label=-100`` on the native host engine (host time
   per scan, voxels, share of voxels labelled -100; maps and labels
   bit-equal to the numpy version), collated and put on the card;
   ``MinkUNet34(3, 20, D=3)`` (weights from torch.Generator seed 0) takes 4
   SGD steps (lr 0.01, cross-entropy with ``ignore_index=-100``, labels in
   the manager's row order), each in a fresh coordinate manager: wall time,
   voxels/s and points/s, and per step ``gather_gemm`` >= 109 and
   ``conv_dw`` exactly 55 launches.  Then in eval mode
   ``MinkowskiFunctional.softmax`` of the batch's logits and a class for
   each of the 800,000 points through the inverse maps; scan 0's logits
   against the CPU plain path, as phase 6.
27. the layer extras on phase 26's batch: (a) ``MinkowskiConvolutionFunction``
   on the stem's map (k = 5, 3 -> 32) and
   ``MinkowskiConvolutionTransposeFunction`` on the k = 2, s = 2 map of
   ``convtr7p2s2``, each bit-equal to the module's output and gradients on
   the same map and weights, 1 + 1 ``gather_gemm`` and 1 ``conv_dw`` launch
   each; both maps' kernels against their plain versions; (b)
   ``MinkowskiChannelwiseConvolution(32, 3, D=3)`` at stride 1 and 2 on the
   stem's output: forward, input gradient and weight gradient on the card
   against the CPU, ms per call; (c) ``spmm`` and ``spmm_average`` over the
   stride-1 -> stride-2 stride map as COO, card against CPU.

28. the bf16 compute path (``MT.set_compute_dtype(torch.bfloat16)``; bf16
   reduced-precision reductions off): the bf16 instances of ``gather_gemm``
   and ``conv_dw`` on the real maps of one MinkUNet34 training step (55
   conv calls, phase 9's batch 0) and one MinkowskiFCNN step (7 calls,
   phase 13's first batch), each against its bf16 plain version (K1 within
   one bf16 ulp, 2^-7 of max|ref|; K2 within DW_RTOL), with the float32
   instances' time on the same maps and the bf16 bound (below).
29. bf16 inference of MinkUNet34 on request 0: latency, bf16 launches only;
   the bf16 logits against the CPU plain path in bf16 and the card's
   float32 answer, each within twice the CPU's bf16-to-float32 distance
   (at least 2^-7), the bf16 path's own rounding cost.
30. bf16 training: a warm-up step on phase 9's batch 0, three timed steps on
   its batches 1-3 (SGD lr 0.01, logits cast to float32 before the
   cross-entropy); exactly 109 + 55 launches per step, all bf16 instances;
   peak memory beside phase 9's; step 0's loss, gradients and running
   statistics against the CPU plain path's bf16 step, each held to the
   float64 run of phase 10 within GRAD_FACTOR times the CPU bf16 run's
   distance from it.
31. a MinkowskiFCNN bf16 training step (dropout off) on phase 13's first
   batch: global max and average pooling and the final linear give bf16;
   14 + 7 bf16 launches; judged as phase 30 against phase 14b's float64 run.
32. ``MinkowskiSyncBatchNorm``: MinkUNet34 through
   ``convert_sync_batchnorm`` takes one bf16 step on batch 0 outside any
   process group, then inside a one-rank NCCL group (``file://`` store in
   a temporary directory, destroyed before the phase ends): loss,
   gradients and running statistics bit-equal, 2 NCCL all-reduces per
   batch norm counted; then against the plain batch norm's step, both held
   to the float64 run as phase 30.
33. fresh-geometry replay: the oplog of ``MinkUNet34(3, 20, D=3)`` recorded
   on phase 9's batch 0; a ``GeometryReplayer`` warmed on two batches;
   then, on six fresh two-scan batches, the eager manager (a forward),
   the sync replay, the deferred replay and ``CompiledReplayer.run`` (one
   CUDA graph): maps, kernel maps and stride maps bit-equal to the eager
   manager's, index for index; per mode the host ms of the coordinate
   phase and its host syncs (torch's sync debug mode), the compiled one
   exactly one per batch; the graphs captured, and no recovery.
34. fresh-geometry training: 4 SGD steps (lr 0.01) on phase 9's batches
   through ``CompiledReplayer.run`` -> ``from_geometry`` -> ``SparseTensor``
   -> forward, cross-entropy, backward, beside the same steps in phase 9's
   form from the same weights: losses and every parameter gradient
   bit-equal, 109 + 55 launches per step, wall time per step of both and
   their peak memory.
35. floor violation: one strided level's floor lowered below its count at
   the same bucket: ``ok`` comes back false, ``recover`` ratchets the
   floor, bumps the version and the next run recaptures; its geometry
   equals the eager manager's.
36. DDP on fresh geometry, one NCCL rank: ``make_per_device_geometry_step``
   trains ``MinkUNet34(3, 20, D=3)`` on phase 9's batches through
   ``CompiledReplayer.run`` -> ``stack_geometries`` -> ``shard_batch`` ->
   ``from_geometry`` (a ``file://`` store in a temporary directory,
   destroyed before the phase ends): loss and all 188 gradients bit-equal
   to phase 34's steps, 109 + 55 launches and one all-reduce per step, the
   step's ms beside phase 34's.
37. two ranks on cuda:0 over gloo (NCCL refuses two ranks on one device;
   spawned processes, joined before the phase ends), each printing the
   transport, its collectives and bytes, and its K1 and K2 launches:
   (a) DDP: each rank a fresh two-scan batch of phase 33; the averaged
   gradients against the mean of two single-process steps on the same
   batches within 1e-5 of max|g|; (b) spatial: phase 5's first scan split
   over the ranks, MinkUNet34 in eval mode, forward and the backward of
   sum(out^2) under ``spatial_execution``: the all-gathered output against
   the single-process run within 1e-4; the gradients against CPU float32
   and float64 runs held to the card's ReLU masks (an element may take the
   card's side of 0 only within KERNEL_RTOL of its call's largest): the
   single process's median and worst leaf within GRAD_FACTOR times the CPU
   float32 run's, each rank's every leaf within GRAD_FACTOR times the single
   process's distance (the sharded against the single process's printed);
   dropped 0, the halo per map and the maps that fell back to all-gather, and the K1
   rows each rank computed, which must be its blocks' and not the whole
   maps'; (c) column-parallel: MinkUNet34 cut by Cout over the two ranks,
   forward and one SGD step on phase 9's batch 0 against the unsharded
   step within 1e-4.  Beside them, per-rank K1 and K2 ms (rank 0's windows
   and Cout slices) against the unsharded calls', summed over a step's 55
   convs, timed in this process.

38. the examples (``examples_torch/``), as a user runs them: (a)
   ``indoor.py``'s chain at full width: its synthetic room (200,000
   points, 163,022 voxels at 2 cm) through a TensorField with
   UNWEIGHTED_AVERAGE, ``sparse()``, ``MinkUNet34C(3, 20, D=3)`` (weights
   from torch.Generator seed 0, batch norms calibrated on the scan, eval
   mode) and ``slice()``; every K1 call of one forward against its plain
   version (captured as phase 4, with the bound); 3 requests, each with a
   fresh manager: wall ms from field to per-point logits on the host,
   points/s, K1 launches; the class histogram and the PLY, written to a
   temporary directory and read back; the logits against the CPU plain
   path with the same weights (a float64 run judges where float32 does
   not agree); a conv with ``convolution_mode=COPY_GEMM`` launches K1/K2
   as DEFAULT does, bit-equal, each call of both modes held against its
   plain version.  (b) every other script through its ``main`` on the
   card at small step counts: K1 launches where its model has a sparse
   conv (K2 where it trains one), each launch held against its plain
   version as it runs (``every_call_held``: the 2-D maps, the scripts' own
   widths, the replayed maps), a finite last loss where it trains, none
   raising.

39. the coordinate engine above D = 6 (multi-word keys): a 7-D cloud is
   four frames of the room of phase 5 (100,000 points each, its own seed,
   moved a few voxels), each point lifted to (x, y, z in 5 cm voxels, its
   three colors times 8, t): ~118k voxels.  ``HighDimUNet(3, 20, D=7)``
   (conv k = 2, a cube of 128 offsets, 3 -> 32; conv k = 2 s = 2 32 -> 64;
   a HYPER_CROSS k = 3 conv, 15 offsets, 64 -> 64; a transposed conv k = 2
   s = 2 64 -> 32; each with batch norm and ReLU; ``cat`` with the first
   level; a k = 1 conv with bias 64 -> 20), weights from torch.Generator
   seed 0.  (a) 3 requests from the raw points: ``TensorField`` ->
   ``sparse()`` -> the net (eval) -> ``slice()`` to per-point logits on the
   host, wall ms, 4 K1 launches each, each map's rows, K and share of -1
   slots, the logits against the CPU plain path as phase 6 judges them;
   (b) the K1 and K2 calls of one training step on a two-cloud batch
   (~236k rows, voxelized by ``sparse_quantize`` over 7-wide rows) against
   their plain versions, with the bound; then 4 SGD steps (lr 0.01), every
   K1 and K2 call held against its plain version as it runs, exactly 7 K1
   and 4 K2 launches per step, peak memory; step 0 judged as phase 10;
   (c) the coordinate phase recorded on batch 0, a ``GeometryReplayer``
   warmed on two batches, then two fresh batches: deferred and
   ``CompiledReplayer.run`` (one CUDA graph) bit-equal to the eager
   manager, host ms and syncs of each (compiled: one), and a step through
   the compiled geometry bit-equal to the eager step; (d) D = 16: a
   HYPER_CROSS k = 3 conv (33 offsets) 3 -> 32 forward and backward on
   ~52k rows (phase 5's first scan twice, each row given 13 coordinates in
   {0, 1}), its K1 and K2 calls held.

40. the multi-process examples (``examples_torch/multigpu.py``,
   ``multigpu_ddp.py``, ``spatial_sharding.py``, ``tensor_parallel.py``)
   through their own launcher (``common.py::run_world``), every K1 and K2
   call held against its plain version as it runs: (a) ``multigpu.py``
   (``MinkUNet14A(3, 10)`` with sync batch norm, 5 steps on the shared
   600-point cloud) and ``multigpu_ddp.py`` (``MinkUNet14A(3, 4)``, 4
   steps, each rank a fresh 2000-point cloud through the replayer) through
   their ``main`` on one NCCL rank in this process: ms per step, each
   step's launches equal to one single-process ``MinkUNet14A`` step's,
   one all-reduce of the gradients per step beside sync batch norm's,
   finite losses; (b) one spawned gloo world of two ranks sharing cuda:0
   runs the four scripts' rank functions in turn at their own sizes: each
   rank prints its transport, collectives, bytes and launches; both ranks'
   parameters bit-equal after every step of the two data-parallel
   scripts; ``spatial_sharding.py`` on its 150,000-point scan drops no
   pair, its halo is this process's measure of the map, and its loss,
   weight gradient and input gradient agree with the single-process conv
   on the card within 1e-4 of max|ref|; ``tensor_parallel.py`` within
   1e-4 of max|single|.

41. the dense bbox grid, on MinkUNet34's maps of phase 9's batch 0 (two
   surface-26k scans): the probe.  Each map's grid (shape, cells, bytes,
   the row grid's build), every kernel map of an eager forward built
   again through the row grids and through the key search, bit-equal to
   each other and to the manager's, both timed (CUDA events); the stride
   maps between the levels and an interpolation map on each level, the
   same way; the eager coordinate phase (host ms and syncs, as phase 33
   counts them) on three fresh batches with the grid on and off (off: the
   manager's cell cap patched to 0), equal maps, no more syncs with the
   grid; the compiled replay with grids on those batches: one graph, one
   sync, maps bit-equal to eager, plans at the grid floors.

42. the bf16 bodies on the device alone: every K1 and K2 call of one bf16
   MinkUNet34 training step and one bf16 MinkowskiFCNN step (phase 28's
   maps), forward, input gradient and weight gradient: the body, Cout
   tile, ring depth and split the plan chose, and, timed by
   ``device_ms`` (the launches enqueued behind a spin kernel that outlasts
   the host's enqueue, so the events bracket device work only), the new
   bodies' ms beside PR 8's bodies (``mma.sync``, or the SIMT stems, run
   through the wrappers' ``body=``), the float32 instance's and the plain
   version's, with the bound and the wrapper's host µs per call; each
   call held to its plain version (K1 within K1_BF16_RTOL, K2 within
   DW_RTOL), two launches bit-equal, and every call whose kernel sees
   Cin > 4 on the ``wgmma`` body.

43. the generative jobs in bf16 (``set_compute_dtype(torch.bfloat16)``), at
   the reference widths on phase 18's batches: (a) CompletionNet: a
   warm-up step and three timed steps (seeds 0-3), logits cast to float32
   before the BCE, exactly 49 + 25 launches per step, all on the bf16
   instances (the Cin = 1 stem on the SIMT K1 body and K2's ``stem_mma``,
   every other call on ``wgmma``); rows per level, step ms and peak memory
   beside phase 18's; then a float32 forward on the card from the same
   weights, held to step 0's bf16 keep masks (``ForcedPruning``): per
   level the rows whose mask it would have changed, each logit within the
   level's bf16-to-float32 distance of 0.  (b) parity on phase 20's batch:
   the card's bf16 step, and the CPU plain path's bf16 and float64 steps
   held to the card's masks; per level the coordinates and logits, the
   loss, every gradient and the running statistics, the card within
   GRAD_FACTOR times the CPU bf16 run's distance from the float64 run, as
   phase 30.  (c) the VAE: per batch (seeds 0-1) a training step (BCE +
   0.1 KL, the KL taken in float32; exactly 51 + 26 bf16 launches, by body
   as (a)) and a generation in eval mode after calibration; the flips of
   a float32 run on step 0's masks; parity on phase 20's batch as (b), the
   mean and log-variance too.  (d) every K1 and K2 call of one bf16
   training step of each net (batch seed 0, seed-0 weights), as phase 42
   without the ``mma.sync`` bodies: body, tile, ring and split, the device-only ms
   beside the float32 instance's and the plain version's, the bound and
   the host µs, each call held to its plain version.

44. K1's float32 bodies on the device alone: every sparse conv call of one
   float32 training step of MinkUNet34 (phase 9's weights) on phase 9's
   first batch (two scans at 5 cm) and on two rooms at 2 cm (``ROOM2CM``)
   and of CompletionNet on phase 18's first batch, forward and input
   gradient: the body, tile, ring and split the plan chose
   (``wgmma_3xtf32`` wherever Cin > 4), each held to its plain version
   within KERNEL_RTOL, two launches bit-equal, and, timed by
   ``device_ms``, its ms beside the ``mma.sync`` body's (``body="mma"``),
   the plain version's and the bound, with the wrapper's host µs; per net
   the step's sums and a table by distinct conv (phase 42's ``redesign``).

45. K1 and K2 on Point Transformer V3's maps: one float32 training step of
   ``PointTransformerV3`` at the published widths (seed-0 weights) on
   three rooms at 2 cm (``ROOM2CM``, seeds 0-2), each cropped to the
   ``PTV3_CROP`` voxels nearest a drawn voxel and moved to a non-negative
   grid, as the benchmark's ``ptv3.train.room2cm`` cell feeds it: 307,200
   rows.  The step launches exactly 45 K1 (23 forward, 22 input gradients,
   the 6 -> 32 stem's forward on the ``mma.sync`` body, the rest on
   ``wgmma_3xtf32``) and 23 float32 K2 (all ``mma.sync``).  Every call's
   forward, input gradient and weight gradient, each held to its plain
   version (K1 within KERNEL_RTOL, K2 within DW_RTOL), two launches
   bit-equal, timed on the device alone beside the ``mma.sync`` body
   (``body="mma"``; K2's float32 body is that body), the plain version and
   the bound, with the wrapper's host µs; the step's sums and a table by
   distinct conv (``redesign``).

46. Serialized attention on Point Transformer V3's windows: the same step's
   22 attention calls (14 encoder and 8 decoder blocks), captured with
   their q, k, v rows, window plans and output gradients; the step runs
   exactly 22 forward and 22 backward launches of the port's kernel
   (``csrc/serialized_attention.cu``).  Each call's forward and backward
   (the backward call's zeroing and summing into the rows included) held
   to the plain version in float64 within ATTN_RTOL (max |Δ| / max |ref|
   of the output and the q, k, v gradients), timed on the device alone
   beside the plain version, PyTorch's memory-efficient attention on the
   same windows (``library_ms``: the yardstick, which the port does not
   call) and the bound, 4 L² d (forward) and 10 L² d (backward)
   operations a window of L rows and head over 495 TFLOP/s; the step's
   sums.

47. The grid-probe kernel (``csrc/grid_probe.cu``) against its plain
   version, ``_build_in_idx_grid``'s ATen ops on the card, on the 10
   kernel maps of one MinkUNet34 step (an eager forward) on phase 9's first
   batch (two scans at 5 cm) and on two rooms at 2 cm (``ROOM2CM``).  The
   forward must build its 10 maps in 10 launches of the kernel, its 20
   halves all on the kernel route (``build_kernel_map.route_builds``);
   each map it built, and the map built again through the kernel (one
   launch, both halves), equal the plain version index for index (the
   largest |kernel - plain| is the kernels line's ``max_abs_err``); per
   map and per step the device-only ms of each (``device_ms``), the
   device operations each launches (profiler), and the bytes bound: the
   2 · K · N int32 it writes and the D + 1 int32 coordinates of each row
   it reads, over 3.35 TB/s.

48. Mask3D (``models/mask3d.py``): one float32 training step at the
   published widths on the benchmark cell's first step (five 2 cm rooms,
   ``portbench/traffic/mask3d_train.py``, about 815k voxels), against the
   plain reference (``portbench/reference/mask3d.py``) in float64 and in
   float32 held to the step's decisions (the FPS rows, key samples,
   attention masks and assignments): the FPS rows equal the reference's
   own, the loss, the final class and mask logits and every gradient leaf
   (median and worst leaf's |Δ| over its largest |ref|) within
   GRAD_FACTOR times the float32 reference's distance from float64 (and
   1e-5 of it for the loss and logits); the step's time, peak memory,
   launches and ``sync.*`` reads (13 ``sync.match.costs``).

Bound of a kernel call: the larger of its useful operations (2 · pairs ·
Cin · Cout) over the H100's 495 TFLOP/s dense TF32 tensor peak and its
bytes (each input read once, the output written once) over 3.35 TB/s.  The
kernels keep float32 accuracy with 3xTF32 (three tensor passes), so they
cannot pass a third of that peak.  The bf16 instances' bound takes the
989 TFLOP/s dense bf16 peak and 2 bytes per feature and weight element,
4 per index and per float32 dW element.

Then a JSON line describing each kernel and, last, the device line.  The
float32 entries' times are the per-step sums of phases 8, 12, 17, 19, 21
and 39b (``cuda_ms``: events around the calls' enqueue and run); the bf16
entries' are the device-only sums of phases 42 and 43 (one bf16 training
step each of MinkUNet34, MinkowskiFCNN, CompletionNet and the VAE).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch import parallel
import minkowskiengine_tpu_torch.coords.manager as TM
from minkowskiengine_tpu_torch.coords.grid import build_row_grid
from minkowskiengine_tpu_torch.coords.kernel_map import (
    _build_in_idx_grid, _invert_matching, build_kernel_map, build_stride_map,
)
from minkowskiengine_tpu_torch.coords.manager import region_offsets_for
from minkowskiengine_tpu_torch.kernels import attention as attn
from minkowskiengine_tpu_torch.kernels import build
from minkowskiengine_tpu_torch.kernels import grid_probe as GP
from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw, conv_dw_reference
from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm, gather_gemm_reference
from minkowskiengine_tpu_torch.models import (
    VAE, CompletionNet, MinkowskiFCNN, MinkowskiSplatFCNN, MinkUNet14A, MinkUNet34, MinkUNet34C,
    PointTransformerV3, ResNet18, ResNetBase,
)
from minkowskiengine_tpu_torch.modules import SEBasicBlock
from minkowskiengine_tpu_torch.nn.conv import MinkowskiConvolutionBase, _conv_out_key
from minkowskiengine_tpu_torch.nn.nonlinearity import MinkowskiDropout, MinkowskiReLU
from minkowskiengine_tpu_torch.nn import serialized
from minkowskiengine_tpu_torch.nn.norm import MinkowskiBatchNorm, MinkowskiSyncBatchNorm
from minkowskiengine_tpu_torch.ops import functional as conv_ops
from minkowskiengine_tpu_torch.parallel import comm, spatial
from minkowskiengine_tpu_torch.utils import hostengine, profiling
from minkowskiengine_tpu_torch.utils.collation import sparse_collate
from minkowskiengine_tpu_torch.utils.quantization import quantize_label_reference
from minkowskiengine_tpu_torch.utils.datasets import (
    COMPLETION_POINTS,
    CoordinateTransformation,
    completion_batch,
    make_room_scan,
    modelnet_batch,
    room_scan_voxels,
)

# f32 sums of up to 65,536 products (K*Cin of CompletionNet's k = 4
# generative conv, 1024 -> 512) taken in another order.  Relative to the
# output's largest value the differences measured at most 1.2e-6 on every
# shape; 1e-5 leaves a factor of eight.
KERNEL_RTOL = 1e-5
# dW sums over each offset's paired output rows: up to ~3M at the stride-1
# level of a CompletionNet training step (4.7M rows, 36% of the slots -1),
# where a random walk of f32 roundings would reach sqrt(3M) * 2^-24 =
# 1.0e-4 of the output scale; K2 sums 32-row tiles in fragments and splits
# the rows over blocks, and the differences measured at most 1.8e-6 on
# every shape and call, up to 4.7M rows.
DW_RTOL = 1e-4
# logits after 55 conv layers and 33 batch norms, CUDA kernel vs CPU plain path
LOGIT_RTOL = 1e-4
# parameter gradients, max|d|/max|ref| per tensor against a float64 run of
# the plain path: at random weights in train mode the gradients are badly
# conditioned (batch-norm backward subtracts batch means; channels of small
# variance amplify), so the CPU's own float32 run is off float64 by up to
# ~3e-2 on some tensors (median ~4e-3).  The card's float32 run rounds in
# another order (K2 sums up to ~10k rows in series per thread) and is held
# to ten times the CPU float32 error of the same tensor, or of the median
# tensor where that tensor happens to round better than the median.
GRAD_FACTOR = 10.0
LOSS_RTOL = 1e-5
MIN_LAUNCHES = 55  # K > 1 sparse convs per forward: 1 stem + 4 down + 46 block + 4 up
MIN_DX_LAUNCHES = MIN_LAUNCHES - 1  # every sparse conv but the stem
TRAIN_STEPS, BATCH, LR = 4, 2, 0.01
# the H100 SXM's published dense TF32 tensor rate and memory rate
TF32_PEAK, HBM_RATE = 495e12, 3.35e12
# MinkowskiFCNN as the reference ModelNet40 example builds and trains it
FCNN_WIDTHS = dict(embedding_channel=1024, channels=(32, 48, 64, 96, 128), D=3)
CLASSES, SHAPES, POINTS, VOXEL = 40, 32, 2048, 0.025
FCNN_CONVS = 7  # conv1-4 and conv5's three
FCNN_LR, FCNN_MOMENTUM, FCNN_WD = 0.1, 0.9, 1e-4
# CompletionNet and the VAE at the reference examples' widths, on batches
# of 16 stand-in shapes at 128^3 (``completion_batch``); SGD as the
# reference completion example trains
GEN_CHANNELS = (16, 32, 64, 128, 256, 512, 1024)
GEN_RES, GEN_SHAPES = 128, 16
GEN_WIDTHS = dict(resolution=GEN_RES, in_nchannel=1, enc_channels=GEN_CHANNELS,
                  dec_channels=GEN_CHANNELS)
VAE_WIDTHS = dict(channels=GEN_CHANNELS, in_nchannel=1, resolution=GEN_RES)
GEN_LR, GEN_MOMENTUM, GEN_WD = 0.01, 0.9, 1e-4
COMPLETION_CONVS = 25  # enc_first, 6 x 2 encoder and 6 x 2 decoder convs
VAE_CONVS = 26  # 7 x 2 encoder and 6 x 2 decoder convs
# phase 20's batch: small enough for the CPU's plain path at full width
PARITY_SEED, PARITY_SHAPES, PARITY_RES = 0, 2, 64
# splatting and interpolation on the card against the CPU: sums of at most
# a few dozen weighted rows, whose order CUDA's index_add atomics change
SPLAT_RTOL = 1e-6
# phase 26: raw room scans as a data loader gets them, voxelized at 5 cm
ROOM_POINTS, ROOM_VOXEL, IGNORE = 400_000, 0.05, -100
# phase 44's rooms at 2 cm: 200,000 points each on a 4 x 5 x 2.5 m room with
# six boxes, ~163k voxels a room, the size upstream's indoor example serves
ROOM2CM = dict(voxel_size=0.02, n_points=200_000, extent=(4.0, 5.0, 2.5), n_objects=6)
# phase 45: PTv3's batch, three such rooms each cropped to its 102,400
# voxels nearest a drawn voxel (Pointcept's SphereCrop); a 5^3 stem and 22
# 3^3 CPE convs; float32 K1 launches by body and K2 launches of one step
PTV3_ROOMS, PTV3_CROP, PTV3_CONVS = 3, 102_400, 23
PTV3_K1_BODIES = {"wgmma_3xtf32": 2 * PTV3_CONVS - 2, "mma": 1}
# phase 46: PTv3's attention calls a step (one a block), and the kernel's
# bound against float64: 3xTF32 products leave ~1e-6 of max |ref|
PTV3_BLOCKS, ATTN_RTOL = 22, 5e-6
# phase 47: the kernel maps of a MinkUNet34 step (the k = 5 stem, four
# k = 2 strided maps, a k = 3 map a level; the transposed ones are swaps);
# the H100's published HBM bandwidth, in bytes a millisecond
UNET_MAPS, HBM_BYTES_PER_MS = 10, 3.35e9
# phase 27: channelwise conv and SPMM, card against CPU: sums of at most 27
# products per row forward; the input gradient's and SPMM's sums run
# through CUDA's index_add atomics (at most 27 and 8 terms per row, summed
# in any order, ~1e-7 of max|ref| of rounding each); the weight gradient
# sums ~51k rows in another order (~1e-7 relative for a pairwise sum)
EXTRA_RTOL = 1e-6
# bf16 (phases 28-32): K1's bf16 instance and its plain version both sum
# exact bf16 x bf16 products in float32, in another order, and round once,
# so a sum next to a rounding boundary may land one bf16 ulp apart: 2^-7 of
# the output's largest value at most.  K2's bf16 instance sums the same
# float32 products as its plain version, in another order: DW_RTOL.
K1_BF16_RTOL = 2.0**-7
BF16_PEAK = 989e12  # the H100 SXM's published dense bf16 tensor rate
KERNELS = {
    "gather_gemm": ("minkowskiengine_tpu_torch/csrc/gather_gemm.cu",
                    "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1105"),
    "conv_dw": ("minkowskiengine_tpu_torch/csrc/conv_dw.cu",
                "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1391"),
    # the same Pallas kernels on bf16 features (phases 28-32)
    "gather_gemm_bf16": ("minkowskiengine_tpu_torch/csrc/gather_gemm.cu",
                         "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1105"),
    "conv_dw_bf16": ("minkowskiengine_tpu_torch/csrc/conv_dw.cu",
                     "minkowskiengine_tpu/ops/pallas/conv_kernel.py:1391"),
}

# (name, K, Cin, Cout, tensor stride of the input rows, of the output rows)
SLICE_SHAPES = [("stem", 125, 3, 32, 1, 1)]
SLICE_SHAPES += [
    (f"down{i}", 8, c, c, 2**i, 2 ** (i + 1)) for i, c in enumerate((32, 32, 64, 128))
]
SLICE_SHAPES += [
    (f"block{b}", 27, ci, co, ts, ts)
    for b, ci, co, ts in [
        (1, 32, 32, 2), (2, 32, 64, 4), (2, 64, 64, 4), (3, 64, 128, 8),
        (3, 128, 128, 8), (4, 128, 256, 16), (4, 256, 256, 16), (5, 384, 256, 8),
        (5, 256, 256, 8), (6, 192, 128, 4), (6, 128, 128, 4), (7, 128, 96, 2),
        (7, 96, 96, 2), (8, 128, 96, 1), (8, 96, 96, 1),
    ]
]
SLICE_SHAPES += [
    (f"up{i}", 8, ci, co, ts, ts // 2)
    for i, (ci, co, ts) in enumerate([(256, 256, 16), (256, 128, 8), (128, 96, 4), (96, 96, 2)])
]
# MinkowskiFCNN's seven sparse convs (Cin 48 and 336 leave a ragged 32-wide
# chunk; Cout 48 pads to a 64-wide tile; Cout 1024 is sixteen K1 tiles),
# and ResNet18's k = 1, stride-2 downsamples, on a classification batch
CLASSIFICATION_SHAPES = [
    ("fcnn.c1", 27, 32, 48, 1, 1), ("fcnn.c2", 27, 48, 64, 2, 4),
    ("fcnn.c3", 27, 64, 96, 8, 16), ("fcnn.c4", 27, 96, 128, 32, 64),
    ("fcnn.c5a", 27, 336, 256, 1, 2), ("fcnn.c5b", 27, 256, 512, 2, 4),
    ("fcnn.c5c", 27, 512, 1024, 4, 8),
    ("rn.down1", 1, 64, 64, 4, 8), ("rn.down2", 1, 64, 128, 8, 16),
    ("rn.down3", 1, 128, 256, 16, 32), ("rn.down4", 1, 256, 512, 32, 64),
]


def scan(seed):
    """~26k voxels at 5 cm: the room scan bench.py calls surface-26k."""
    return room_scan_voxels(
        voxel_size=0.05, n_points=120_000, extent=(2.0, 2.0, 2.2), n_objects=4, seed=seed
    )


def cuda_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SPIN_CYCLES_PER_MS = []


def device_ms(fn, warmup=2, iters=10, graph=False):
    """Device-only time of ``fn``'s launches: (ms per call, the host's µs
    per call).  ``cuda_ms`` brackets the host's enqueue too, which is all
    it measures where a kernel's device time is below its wrapper's host
    cost.  Here the timed calls are enqueued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts their enqueue, so the device
    runs them back to back between the two events.  The host µs are the
    enqueue of the same calls by a host clock, with no sync.  A spin that
    the enqueue outlasted is doubled and the calls timed again.  With
    ``graph`` (the plain versions: a few launches per offset, enough to
    fill the launch queue behind a spin, so that the host waits on the
    device) the calls are captured in one CUDA graph and its replay is
    timed; the host µs are then None."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        calls = torch.cuda.CUDAGraph()
        with torch.cuda.graph(calls):
            for _ in range(iters):
                fn()
        calls.replay()
        start.record()
        calls.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, None
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(4_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(4_000_000 / start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cover_ms = 2 * iters * (time.perf_counter() - t0) * 1e3 + 0.2
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(cover_ms * _SPIN_CYCLES_PER_MS[0]))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < 0.8 * cover_ms:
            return start.elapsed_time(end) / iters, host_ms * 1e3 / iters
        cover_ms = 2 * host_ms
    raise AssertionError(f"the host's enqueue outlasted a {cover_ms:.1f} ms spin four times")


def held(got, want, rtol, label):
    """A kernel's output against its plain version's on the same CUDA
    inputs: (max abs err, max rel err); fails beyond ``rtol`` of
    max|plain|."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    abs_err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    rel = abs_err / scale if scale > 0 else abs_err
    if not (torch.isfinite(got).all() and rel <= rtol):
        raise AssertionError(f"{label} disagrees, max rel err {rel:.3e}")
    return abs_err, rel


def agree(kernel, plain, args, rtol, label):
    """``kernel`` against ``plain`` on the same CUDA inputs, as ``held``."""
    return held(kernel(*args), plain(*args), rtol, f"{label}: {kernel.__name__}")


def check(kernel, plain, args, rtol, label):
    """``agree``, and both times."""
    abs_err, rel = agree(kernel, plain, args, rtol, label)
    return dict(
        max_abs_err=abs_err, max_rel_err=rel,
        ms=cuda_ms(lambda: kernel(*args)), plain_ms=cuda_ms(lambda: plain(*args)),
    )


def compare(x, w, idx, label):
    """Phases 3-4: gather_gemm against its plain version; returns a row."""
    row = dict(
        label=label, K=w.shape[0], cin=w.shape[1], cout=w.shape[2], n_in=x.shape[0],
        n_out=idx.shape[1], pairs=int((idx >= 0).sum()),
        **check(gather_gemm, gather_gemm_reference, (x, w, idx), KERNEL_RTOL, label),
    )
    print(
        f"  {label:>9} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<3} "
        f"rows {row['n_in']:>5}->{row['n_out']:<5} pairs {row['pairs']:>8}  "
        f"rel err {row['max_rel_err']:.1e}  kernel {row['ms']:.4f} ms  "
        f"plain {row['plain_ms']:.4f} ms"
    )
    return row


def answer(model, coords, feats, device):
    """One request: voxels in, logits out; a fresh coordinate manager."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = MT.SparseTensor(
        torch.from_numpy(feats).to(device), torch.from_numpy(coords).to(device)
    )
    with torch.no_grad():
        logits = model(x).F.cpu()
    return logits, time.perf_counter() - t0


def collate(scans):
    """A batch of room scans: batch index in column 0 of the coordinates."""
    return sparse_collate([c[:, 1:] for c, _ in scans], [f for _, f in scans])


def labels_for(step, n):
    """Seeded 20-class labels, drawn the way bench.py draws them."""
    return torch.randint(0, 20, (n,), generator=torch.Generator().manual_seed(step))


def train_step(model, opt, coords, feats, labels, device):
    """One SGD step on a fresh coordinate manager; returns (loss, output)."""
    x = MT.SparseTensor(feats.to(device), coords.to(device))
    out = model(x)
    loss = torch.nn.functional.cross_entropy(out.F.float(), labels.to(device))
    if opt is not None:
        opt.zero_grad()
    loss.backward()
    return loss, out


def shapes(seed, transform=None):
    """A classification batch: 32 synthetic shapes x 2048 points at 2.5 cm
    voxels; (float coordinates with the batch index, features, labels)."""
    return modelnet_batch(SHAPES, n_points=POINTS, seed=seed, transform=transform, voxel_size=VOXEL)


def field(coords, feats, device):
    """The batch as a TensorField on ``device``, with a fresh coordinate manager."""
    return MT.TensorField(
        torch.as_tensor(feats).to(device), torch.as_tensor(coords).to(device), device=device
    )


def classify(model, coords, feats, device):
    """One classification batch: points in, logits out."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(field(coords, feats, device)).cpu()
    return logits, time.perf_counter() - t0


def fcnn_step(model, coords, feats, labels, device):
    """Forward, cross-entropy and backward of one classification batch."""
    logits = model(field(coords, feats, device))
    loss = torch.nn.functional.cross_entropy(
        logits.float(), torch.as_tensor(labels).long().to(device)
    )
    loss.backward()
    return loss, logits


def pyramid(mgr, key, strides):
    """Rows of the map at ``key`` and of its stride-2 descendants."""
    rows = {strides[0]: mgr.size(key)}
    for ts in strides[1:]:
        key = mgr.stride(key, 2)
        rows[ts] = mgr.size(key)
    return rows


def sparse_convs(model):
    return [m for m in model.modules() if isinstance(m, MinkowskiConvolutionBase) and not m.use_mm]


def capture_step(convs, run):
    """Run one forward and backward with hooks on ``convs``: every call's
    (module, input, output), and the gradient of each call's output."""
    calls, grads = [], {}

    def capture(m, a, o):
        i = len(calls)
        calls.append((m, a[0], o))
        o.F.register_hook(lambda g: grads.__setitem__(i, g))

    hooks = [m.register_forward_hook(capture) for m in convs]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    return calls, grads, result


def bound(flop, nbytes):
    """(ms, what sets it): the least time the card could take for the work."""
    ops_ms, bytes_ms = flop / TF32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def injective_map(K, n_in, n_out, gen, dev):
    """(K, n_out) matching, each input row used at most once per offset,
    about 30% of the slots -1."""
    m = min(n_in, n_out)
    idx = torch.full((K, n_out), -1, dtype=torch.int32, device=dev)
    for k in range(K):
        dst = torch.randperm(n_out, generator=gen, device=dev)[:m]
        idx[k, dst] = torch.randperm(n_in, generator=gen, device=dev)[:m].int()
    idx[torch.rand(K, n_out, device=dev, generator=gen) < 0.3] = -1
    return idx


def pairs(idx, n_in):
    return int(((idx >= 0) & (idx < n_in)).sum())


def backward_rows(x, w, g, in_idx, out_idx_t, label, with_dx=True):
    """Phases 7-8: forward, input gradient and weight gradient of one conv,
    each against its plain version, with the kernel's split S and its
    useful TFLOP/s (2 * pairs * Cin * Cout / time)."""
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    row = dict(label=label, K=K, cin=cin, cout=cout, n_in=n_in, n_out=n_out)
    flop = 2 * pairs(in_idx, n_in) * cin * cout
    # the map's slots that hold -1: K1 computes them all, K2 skips them
    row["empty"] = 1 - pairs(in_idx, n_in) / max(1, K * n_out)
    nbytes = {  # each input read once (the map too), the output written once
        "fwd": 4 * (n_in * cin + K * cin * cout + K * n_out + n_out * cout),
        "dx": 4 * (n_out * cout + K * cin * cout + K * n_in + n_in * cin),
        "dw": 4 * (n_in * cin + n_out * cout + K * n_out + K * cin * cout),
    }
    row["fwd"] = check(gather_gemm, gather_gemm_reference, (x, w, in_idx), KERNEL_RTOL, label)
    row["fwd"]["splits"] = gather_gemm.last_plan.splits
    if with_dx:
        args = (g, w.transpose(1, 2).contiguous(), out_idx_t)
        row["dx"] = check(gather_gemm, gather_gemm_reference, args, KERNEL_RTOL, label + " dX")
        row["dx"]["splits"] = gather_gemm.last_plan.splits
        row["dx"]["flop"] = 2 * pairs(out_idx_t, g.shape[0]) * w.shape[1] * w.shape[2]
    row["dw"] = check(conv_dw, conv_dw_reference, (x, g, in_idx), DW_RTOL, label + " dW")
    row["dw"]["splits"] = conv_dw.last_plan.splits
    for p in ("fwd", "dx", "dw"):
        if p in row:
            f = row[p].setdefault("flop", flop)
            row[p]["tflops"] = f / (row[p]["ms"] * 1e-3) / 1e12
            row[p]["bound_ms"], row[p]["bound_by"] = bound(f, nbytes[p])
    parts = "  ".join(
        f"{p} {row[p]['ms']:.4f}/{row[p]['plain_ms']:.4f} ms ({row[p]['max_rel_err']:.1e}, "
        f"S={row[p]['splits']}, {row[p]['tflops']:.2f} TFLOP/s, bound {row[p]['bound_ms']:.4f} ms "
        f"by {row[p]['bound_by']})"
        for p in ("fwd", "dx", "dw") if p in row
    )
    print(
        f"  {label:>9} K={row['K']:<3} {row['cin']:>3}->{row['cout']:<3} "
        f"rows {row['n_in']:>5}->{row['n_out']:<5}  -1 slots {row['empty']:.1%}  kernel/plain {parts}"
    )
    return row


def step_sums(rows):
    """Per-part sums over a step's calls: (kernel ms, plain ms, bound ms,
    bound ms of the calls whose operations set the bound)."""
    sums = {}
    for p in ("fwd", "dx", "dw"):
        parts = [r[p] for r in rows if p in r]
        sums[p] = (
            sum(q["ms"] for q in parts), sum(q["plain_ms"] for q in parts),
            sum(q["bound_ms"] for q in parts),
            sum(q["bound_ms"] for q in parts if q["bound_by"] == "operations"),
        )
    return sums


def print_sums(sums):
    for p, name in (("fwd", "K1 forward"), ("dx", "K1 input gradient"), ("dw", "K2 weight gradient")):
        ms, plain, bnd, ops = sums[p]
        print(
            f"  sum over one step, {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {bnd:.4f} ms ({ops:.4f} ms of it in operations-bound calls)"
        )


def median(values: dict) -> float:
    return sorted(values.values())[len(values) // 2]


def rel_diff(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale > 0 else (got - want).abs().max().item()


def zero_counts():
    """Every kernel instance's launch count to 0, just before a main-path
    phase."""
    gather_gemm.launches = gather_gemm.bf16_launches = 0
    conv_dw.launches = conv_dw.bf16_launches = 0
    for counts in (gather_gemm.bf16_body_launches, conv_dw.bf16_body_launches):
        counts.update(dict.fromkeys(counts, 0))


def counts_now():
    """Every kernel instance's launch count."""
    return {"gather_gemm": gather_gemm.launches, "conv_dw": conv_dw.launches,
            "gather_gemm_bf16": gather_gemm.bf16_launches, "conv_dw_bf16": conv_dw.bf16_launches}


def take_launches(total):
    """Read the launch counts after a main-path phase (they were set to 0
    just before it), add them to ``total`` and return them."""
    got = counts_now()
    for k, v in got.items():
        total[k] += v
    return got


def unet_from(init, dev, train):
    """MinkUNet34(3, 20, D=3) with the weights ``init`` on ``dev``."""
    net = MinkUNet34(3, 20, D=3, device=dev)
    net.load_state_dict(init)
    return net.train(train)


def set_dropout(model, on):
    for m in model.modules():
        if isinstance(m, MinkowskiDropout):
            m.train(on)


def cpu_steps(run, tag, unit):
    """A training step on the CPU plain path in float32 and float64:
    ``run(dtype)`` returns (loss, model, rows).  Returns {dtype: (loss,
    float64 gradients, float64 running statistics)}."""
    cpu = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        loss, net, n = run(dtype)
        print(f"[{tag}] CPU plain-path step, {dtype}, {n} {unit}: {time.perf_counter() - t0:.1f} s")
        cpu[dtype] = (
            loss.item(),
            {k: p.grad.double() for k, p in net.named_parameters()},
            {k: v.double() for k, v in net.state_dict().items() if "running" in k},
        )
    return cpu


def judge_grads(tag, grads0, cpu):
    """Every gradient of a card run against the CPU float64 run of the same
    work, each within GRAD_FACTOR times the CPU float32 run's distance from
    float64 (or the median leaf's, where that is larger); ``cpu`` as
    ``cpu_steps`` returns it.  Prints the judgement; returns whether every
    gradient holds."""
    grads32, grads64 = cpu[torch.float32][1], cpu[torch.float64][1]
    if set(grads32) != set(grads0):
        raise AssertionError(f"{tag}: the card's and the CPU's parameters differ")
    card_vs_cpu = {k: rel_diff(grads0[k].double(), grads32[k]) for k in grads0}
    card_err = {k: rel_diff(grads0[k].double(), grads64[k]) for k in grads0}
    cpu_err = {k: rel_diff(grads32[k], grads64[k]) for k in grads0}
    bound = {k: GRAD_FACTOR * max(cpu_err[k], median(cpu_err)) for k in grads0}
    worst = max(card_vs_cpu, key=card_vs_cpu.get)
    worst64 = max(card_err, key=card_err.get)
    tightest = max(card_err, key=lambda k: card_err[k] / bound[k])
    print(
        f"  {len(grads0)} gradients, card vs CPU float32: worst {worst} {card_vs_cpu[worst]:.2e}, "
        f"median {median(card_vs_cpu):.2e}\n"
        f"  against float64: card median {median(card_err):.2e}, worst {worst64} "
        f"{card_err[worst64]:.2e}; CPU float32 median {median(cpu_err):.2e}, worst "
        f"{max(cpu_err.values()):.2e}\n"
        f"  closest to its bound: {tightest} card {card_err[tightest]:.2e}, CPU float32 "
        f"{cpu_err[tightest]:.2e}, bound {bound[tightest]:.2e}"
    )
    return card_err[tightest] <= bound[tightest]


def judge_step(tag, loss0, grads0, stats0, cpu):
    """The card's step (loss, every parameter gradient, the batch norms'
    running statistics) against the CPU float32 run, each gradient judged
    against the float64 run (``judge_grads``)."""
    loss32, _, stats32 = cpu[torch.float32]
    loss_rel = abs(loss32 - loss0) / abs(loss32)
    print(f"  loss {loss0:.7f} (card) vs {loss32:.7f} (CPU): rel {loss_rel:.2e}")
    grads_ok = judge_grads(tag, grads0, cpu)
    stat_rel = {k: rel_diff(v.double(), stats32[k]) for k, v in stats0.items()}
    worst_stat = max(stat_rel, key=stat_rel.get)
    print(f"  {len(stat_rel)} running stats, worst {worst_stat} {stat_rel[worst_stat]:.2e}")
    if not (loss_rel <= LOSS_RTOL and grads_ok and stat_rel[worst_stat] <= LOGIT_RTOL):
        raise AssertionError(f"{tag}: training step disagrees with the CPU plain path")


def segmentation_and_classification(dev, launches):
    """Phases 3-14: MinkUNet34 inference and training, MinkowskiFCNN and
    ResNet18 classification.  Adds the main-path launches to ``launches``;
    returns the kernel rows of phases 3-4, 7, 8 and 12."""
    coords0, feats0 = scan(0)
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(torch.from_numpy(coords0))
    level_rows = pyramid(mgr, key, (1, 2, 4, 8, 16))

    # 3. kernel check, synthetic maps
    print(f"[3 kernel check, synthetic maps] level rows {level_rows}")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, K, cin, cout, ts_in, ts_out in SLICE_SHAPES:
        n_in, n_out = level_rows[ts_in], level_rows[ts_out]
        x = torch.randn(n_in, cin, device=dev, generator=gen)
        w = torch.randn(K, cin, cout, device=dev, generator=gen) / (K * cin) ** 0.5
        idx = torch.randint(0, n_in, (K, n_out), device=dev, generator=gen, dtype=torch.int32)
        idx[torch.rand(K, n_out, device=dev, generator=gen) < 0.3] = -1
        rows.append(compare(x, w, idx, name))

    # 4. kernel check on the real maps of one forward
    model = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    calls = []
    convs = sparse_convs(model)
    hooks = [m.register_forward_hook(lambda m, a, o: calls.append((m, a[0], o))) for m in convs]
    answer(model, coords0, feats0, dev)  # warm-up request
    for h in hooks:
        h.remove()
    if len(calls) != MIN_LAUNCHES:
        raise AssertionError(f"captured {len(calls)} sparse conv calls, expected {MIN_LAUNCHES}")
    print(f"[4 kernel check, room-scan maps] {len(calls)} conv calls of one forward")
    real = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        real.append(compare(inp.F, m.kernel.detach(), kmap.in_idx, f"call{i}"))
    del calls
    kernel_ms = sum(r["ms"] for r in real)
    plain_ms = sum(r["plain_ms"] for r in real)
    print(f"  sum over one forward: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")

    # 5. the inference slice: three requests, counted
    requests = [(s, *scan(s)) for s in (0, 1, 2)]
    answers = []
    zero_counts()
    for seed, coords, feats in requests:
        before = gather_gemm.launches
        logits, secs = answer(model, coords, feats, dev)
        launched = gather_gemm.launches - before
        answers.append(logits)
        print(
            f"[5 slice] request seed {seed}: {len(coords)} voxels, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, {launched} gather_gemm launches"
        )
        if launched < MIN_LAUNCHES:
            raise AssertionError(f"only {launched} kernel launches in the request")
        if logits.shape != (len(coords), 20) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    if conv_dw.launches:
        raise AssertionError(f"inference launched conv_dw {conv_dw.launches} times")
    take_launches(launches)

    # 6. parity with the CPU plain path
    cpu_model = MinkUNet34(
        3, 20, D=3, generator=torch.Generator().manual_seed(0), device="cpu"
    ).eval()
    for (k, a), b in zip(model.state_dict().items(), cpu_model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"CPU model weights differ at {k}")
    with torch.no_grad():
        ref = cpu_model(
            MT.SparseTensor(torch.from_numpy(requests[0][2]), torch.from_numpy(requests[0][1]))
        ).F
    rel = ((answers[0] - ref).abs().max() / ref.abs().max()).item()
    print(f"[6 parity] CUDA vs CPU plain-path logits: max|d|/max|ref| = {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    del cpu_model, requests, answers

    # the training data: 2 scans per step, seeds 0-7
    raw = [[scan(BATCH * s + b) for b in range(BATCH)] for s in range(TRAIN_STEPS)]
    batches = [collate(r) for r in raw]
    labels = [labels_for(s, len(c)) for s, (c, _) in enumerate(batches)]

    # 7. backward kernels, synthetic maps at the training batch's row counts
    mgr = MT.CoordinateManager(D=3, device=dev)
    key, _ = mgr.insert_and_map(batches[0][0])
    train_rows = pyramid(mgr, key, (1, 2, 4, 8, 16))
    shape_batch = shapes(0, CoordinateTransformation())  # phase 13's first batch
    x0 = field(shape_batch[0], shape_batch[1], dev).sparse()
    class_rows = pyramid(x0.coordinate_manager, x0.coordinate_map_key, (1, 2, 4, 8, 16, 32, 64))
    del x0
    print(
        f"[7 backward kernels, synthetic maps] level rows {train_rows}; classification batch "
        f"{class_rows}; bound: max(2 * pairs * Cin * Cout / {TF32_PEAK / 1e12:.0f} TFLOP/s TF32, "
        f"bytes / {HBM_RATE / 1e12:.2f} TB/s); 3xTF32 runs at most a third of that peak"
    )
    synth_bwd = []
    for name, K, cin, cout, ts_in, ts_out, rows_at in [
        (*shape, train_rows) for shape in SLICE_SHAPES
    ] + [(*shape, class_rows) for shape in CLASSIFICATION_SHAPES]:
        n_in, n_out = rows_at[ts_in], rows_at[ts_out]
        in_idx = injective_map(K, n_in, n_out, gen, dev)
        x = torch.randn(n_in, cin, device=dev, generator=gen)
        w = torch.randn(K, cin, cout, device=dev, generator=gen) / (K * cin) ** 0.5
        g = torch.randn(n_out, cout, device=dev, generator=gen)
        synth_bwd.append(backward_rows(x, w, g, in_idx, _invert_matching(in_idx, n_in), name))

    # 8. backward kernels on the real maps of one training step
    model.train()
    calls, grads, _ = capture_step(convs, lambda: train_step(model, None, *batches[0], labels[0], dev))
    if len(calls) != MIN_LAUNCHES or len(grads) != MIN_LAUNCHES:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    print(f"[8 backward kernels, training-step maps] {len(calls)} conv calls")
    real_bwd = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        real_bwd.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, f"call{i}", with_dx=inp.F.requires_grad,
        ))
    del calls, grads
    model.zero_grad(set_to_none=True)
    print_sums(step_sums(real_bwd))

    # 9. the training slice: four steps, counted
    net = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for step, (scans, lab) in enumerate(zip(raw, labels)):
        fwd_dx, dw = gather_gemm.launches, conv_dw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coords, feats = collate(scans)
        loss, out = train_step(net, opt, coords, feats, lab, dev)
        if step == 0:
            loss0 = loss.item()
            grads0 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
            logits0 = out.F.detach().double().cpu()
        opt.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_fwd_dx, n_dw = gather_gemm.launches - fwd_dx, conv_dw.launches - dw
        print(
            f"[9 train] step {step}: {len(coords)} voxels, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, loss {loss.item():.6f}, "
            f"{n_fwd_dx} gather_gemm and {n_dw} conv_dw launches"
        )
        if n_fwd_dx < MIN_LAUNCHES + MIN_DX_LAUNCHES or n_dw != MIN_LAUNCHES:
            raise AssertionError(f"step {step}: {n_fwd_dx} gather_gemm, {n_dw} conv_dw launches")
        if out.F.shape != (len(coords), 20) or not torch.isfinite(loss):
            raise AssertionError(f"step {step}: logits {tuple(out.F.shape)}, loss {loss.item()}")
        if step == 0:
            stats0 = {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k}
        del loss, out
    take_launches(launches)
    unet_peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {unet_peak / 2**30:.2f} GiB")

    # 10. gradient parity with the CPU plain path: step 0 again in float32,
    # and in float64 as the yardstick of float32 rounding
    cpu_logits = {}

    def cpu_unet_step(dtype):
        cpu_net = MinkUNet34(3, 20, D=3, device="cpu").train()
        cpu_net.load_state_dict(init)
        cpu_net.to(dtype)
        coords, feats = batches[0]
        loss, out = train_step(cpu_net, None, coords, feats.to(dtype), labels[0], "cpu")
        cpu_logits[dtype] = out.F.detach().double()
        return loss, cpu_net, len(coords)

    unet_cpu = cpu_steps(cpu_unet_step, "10 parity", "voxels")
    judge_step("10 parity", loss0, grads0, stats0, unet_cpu)
    # the train-mode logits, held as phase 14c holds logits
    vs32 = rel_diff(logits0, cpu_logits[torch.float32])
    card64 = rel_diff(logits0, cpu_logits[torch.float64])
    cpu64 = rel_diff(cpu_logits[torch.float32], cpu_logits[torch.float64])
    print(f"  logits {tuple(logits0.shape)} against the CPU float32 run {vs32:.2e}; against "
          f"float64: card {card64:.2e}, CPU float32 {cpu64:.2e}")
    if not (vs32 <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
        raise AssertionError(f"10 parity: logits disagree with the CPU plain path, {vs32:.3e}")
    del cpu_logits, logits0

    # 11. classification inference: three batches of 32 shapes, counted
    fcnn = MinkowskiFCNN(
        3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev, **FCNN_WIDTHS
    ).eval()
    fcnn_init = {k: v.detach().cpu().clone() for k, v in fcnn.state_dict().items()}
    fcnn_convs = sparse_convs(fcnn)
    if len(fcnn_convs) != FCNN_CONVS:
        raise AssertionError(f"MinkowskiFCNN has {len(fcnn_convs)} sparse convs")
    batches11 = [shapes(s) for s in (0, 1, 2)]
    classify(fcnn, *batches11[0][:2], dev)  # warm-up: allocator, cuBLAS
    logits11 = []
    zero_counts()
    for seed, (coords, feats, _) in enumerate(batches11):
        before = gather_gemm.launches
        logits, secs = classify(fcnn, coords, feats, dev)
        launched = gather_gemm.launches - before
        logits11.append(logits)
        print(
            f"[11 classify] batch seed {seed}: {len(coords)} points, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, {launched} gather_gemm launches"
        )
        if launched < FCNN_CONVS:
            raise AssertionError(f"only {launched} kernel launches in the batch")
        if logits.shape != (SHAPES, CLASSES) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    if conv_dw.launches:
        raise AssertionError(f"inference launched conv_dw {conv_dw.launches} times")
    take_launches(launches)

    # 12. kernels on the real maps of one FCNN training step, dropout off
    fcnn.train()
    set_dropout(fcnn, False)
    fcnn.zero_grad(set_to_none=True)
    calls, grads, (loss, _) = capture_step(
        fcnn_convs, lambda: fcnn_step(fcnn, *shape_batch, dev)
    )
    if len(calls) != FCNN_CONVS or len(grads) != FCNN_CONVS:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    fcnn_loss0 = loss.item()
    fcnn_grads0 = {k: p.grad.detach().cpu().clone() for k, p in fcnn.named_parameters()}
    fcnn_stats0 = {k: v.cpu().clone() for k, v in fcnn.state_dict().items() if "running" in k}
    print(f"[12 kernels, FCNN training-step maps] {len(calls)} conv calls")
    fcnn_bwd = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        fcnn_bwd.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, f"fcnn{i}", with_dx=inp.F.requires_grad,
        ))
    del calls, grads, loss, fcnn
    print_sums(step_sums(fcnn_bwd))

    # 13. classification training: four SGD steps, counted
    net = MinkowskiFCNN(
        3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev, **FCNN_WIDTHS
    ).train()
    for m in net.modules():
        if isinstance(m, MinkowskiDropout):
            m.generator = torch.Generator(device=dev).manual_seed(0)
    opt = torch.optim.SGD(
        net.parameters(), lr=FCNN_LR, momentum=FCNN_MOMENTUM, weight_decay=FCNN_WD
    )
    batches13 = [shape_batch] + [shapes(s, CoordinateTransformation()) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for step, (coords, feats, lab) in enumerate(batches13):
        fwd_dx, dw = gather_gemm.launches, conv_dw.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, logits = fcnn_step(net, coords, feats, lab, dev)
        opt.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_fwd_dx, n_dw = gather_gemm.launches - fwd_dx, conv_dw.launches - dw
        print(
            f"[13 train classifier] step {step}: {len(coords)} points, {secs * 1e3:.2f} ms, "
            f"{len(coords) / secs:.0f} points/s, loss {loss.item():.6f}, "
            f"{n_fwd_dx} gather_gemm and {n_dw} conv_dw launches"
        )
        if n_fwd_dx < 2 * FCNN_CONVS or n_dw != FCNN_CONVS:
            raise AssertionError(f"step {step}: {n_fwd_dx} gather_gemm, {n_dw} conv_dw launches")
        if logits.shape != (SHAPES, CLASSES) or not torch.isfinite(loss):
            raise AssertionError(f"step {step}: logits {tuple(logits.shape)}, loss {loss.item()}")
        del loss, logits
    take_launches(launches)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del net, opt

    # 14. classification parity with the CPU plain path
    # (a) batch 0's logits in eval mode
    cpu_fcnn = MinkowskiFCNN(3, CLASSES, device="cpu", **FCNN_WIDTHS).eval()
    cpu_fcnn.load_state_dict(fcnn_init)
    with torch.no_grad():
        ref = cpu_fcnn(field(*batches11[0][:2], "cpu"))
    rel = rel_diff(logits11[0], ref)
    print(f"[14a parity] FCNN logits, CUDA vs CPU plain path: max|d|/max|ref| = {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"FCNN logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    del cpu_fcnn

    # (b) phase 12's step, dropout off, in float32 and float64 on the CPU
    def cpu_fcnn_step(dtype):
        cpu_net = MinkowskiFCNN(3, CLASSES, device="cpu", **FCNN_WIDTHS).train()
        cpu_net.load_state_dict(fcnn_init)
        cpu_net.to(dtype)
        set_dropout(cpu_net, False)
        coords, feats, lab = shape_batch
        loss, _ = fcnn_step(cpu_net, coords, torch.from_numpy(feats).to(dtype), lab, "cpu")
        return loss, cpu_net, len(coords)

    fcnn_cpu = cpu_steps(cpu_fcnn_step, "14b parity", "points")
    judge_step("14b parity", fcnn_loss0, fcnn_grads0, fcnn_stats0, fcnn_cpu)

    # (c) ResNet18 on batch 0, voxelized by the TensorField
    rn = ResNet18(3, CLASSES, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    rn_convs = len(sparse_convs(rn))
    coords, feats, _ = batches11[0]
    zero_counts()
    with torch.no_grad():
        rn_logits = rn(field(coords, feats, dev).sparse())
    rn_launched = take_launches(launches)
    rn_logits = rn_logits.F.cpu()
    if rn_launched["gather_gemm"] != rn_convs or rn_launched["conv_dw"]:
        raise AssertionError(f"ResNet18: {rn_launched} launches for {rn_convs} sparse convs")
    if rn_logits.shape != (SHAPES, CLASSES) or not torch.isfinite(rn_logits).all():
        raise AssertionError(f"ResNet18: bad logits, shape {tuple(rn_logits.shape)}")
    rn_init = {k: v.cpu() for k, v in rn.state_dict().items()}
    del rn
    rn_cpu = {}
    for dtype in (torch.float32, torch.float64):
        cpu_rn = ResNet18(3, CLASSES, D=3, device="cpu").eval()
        cpu_rn.load_state_dict(rn_init)
        cpu_rn.to(dtype)
        with torch.no_grad():
            rn_cpu[dtype] = cpu_rn(field(coords, torch.from_numpy(feats).to(dtype), "cpu").sparse()).F
    del cpu_rn
    rel = rel_diff(rn_logits.double(), rn_cpu[torch.float32].double())
    card64 = rel_diff(rn_logits.double(), rn_cpu[torch.float64])
    cpu64 = rel_diff(rn_cpu[torch.float32].double(), rn_cpu[torch.float64])
    print(
        f"[14c parity] ResNet18, {rn_convs} sparse convs, {rn_launched['gather_gemm']} gather_gemm "
        f"launches; logits CUDA vs CPU float32 {rel:.2e}; against float64: card {card64:.2e}, "
        f"CPU float32 {cpu64:.2e}"
    )
    # instance norm over the few rows each shape keeps at strides 64-192
    # can amplify float32 rounding past LOGIT_RTOL; then the card is held,
    # as in phase 10, to GRAD_FACTOR times the CPU float32 run's error
    if not (rel <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
        raise AssertionError(f"ResNet18 logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    # what the bf16 phases (28-32) reuse: the same weights, batches and labels,
    # and the CPU float32 and float64 runs of the same steps
    reuse = dict(unet_init=init, raw=raw, labels=labels, unet_cpu=unet_cpu, unet_peak=unet_peak,
                 fcnn_init=fcnn_init, shape_batch=shape_batch, fcnn_cpu=fcnn_cpu,
                 request=(coords0, feats0))
    return rows, real, synth_bwd, real_bwd, fcnn_bwd, reuse

def gen_batch(seed, shapes=GEN_SHAPES, res=GEN_RES):
    """A stand-in completion batch: (partial coordinates, their ones
    features, full coordinates), numpy."""
    return completion_batch(shapes, res, seed=seed)


def completion_input(batch, device):
    """The partial shapes as a SparseTensor and the full shapes' key, in a
    fresh coordinate manager."""
    partial, feats, full = batch
    mgr = MT.CoordinateManager(D=3, device=device)
    x = MT.SparseTensor(
        torch.from_numpy(feats).to(device), torch.from_numpy(partial).to(device),
        coordinate_manager=mgr,
    )
    target_key, _ = mgr.insert_and_map(torch.from_numpy(full).to(device), 1)
    return x, target_key


def vae_input(batch, device):
    """The full shapes as the VAE's input (ones features) and its target."""
    _, _, full = batch
    return completion_input((full, np.ones((len(full), 1), np.float32), full), device)


def float32_if_bf16(x):
    """``x``, or ``x`` in float32 where it is bf16: losses take float32."""
    return x.float() if x.dtype == torch.bfloat16 else x


def bce(out_cls, targets):
    """The mean over levels of each level's sigmoid BCE (the reference
    examples' loss), bf16 logits cast to float32 first."""
    logits = [float32_if_bf16(c.F[:, 0]) for c in out_cls]
    return sum(
        torch.nn.functional.binary_cross_entropy_with_logits(x, t.to(x.dtype))
        for x, t in zip(logits, targets)
    ) / len(out_cls)


def vae_loss(out_cls, targets, mean, log_var):
    """BCE + 0.1 KL, the KL of bf16 mean and log-variance taken in float32."""
    m, lv = float32_if_bf16(mean.F), float32_if_bf16(log_var.F)
    kl = -0.5 * torch.mean(1 + lv - m**2 - torch.exp(lv))
    return bce(out_cls, targets) + 0.1 * kl


def counted(launches, fn):
    """Run one main-path piece with the launch counts set to 0 just before
    it; add them to ``launches`` and return (result, this piece's counts)."""
    zero_counts()
    result = fn()
    return result, take_launches(launches)


def calibrate(model, run):
    """Running statistics for eval mode: every batch norm takes the batch
    statistics of one train-mode forward (momentum 1), as a trained model
    carries them.  At their initial values (0, 1) the random-weight logits
    all take one sign and no level prunes."""
    bns = [m.bn for m in model.modules() if isinstance(m, MinkowskiBatchNorm)]
    model.train()
    for bn in bns:
        bn.momentum = 1.0
    with torch.no_grad():
        run()
    for bn in bns:
        bn.momentum = 0.1
    model.eval()


def gen_sgd(net):
    return torch.optim.SGD(net.parameters(), lr=GEN_LR, momentum=GEN_MOMENTUM, weight_decay=GEN_WD)


def generative_shapes(dev, batch):
    """Phase 15's convs: every sparse conv of CompletionNet and the VAE, on
    kernel maps of a stand-in batch's own coordinates.  Encoder convs use
    the partial shapes' (CompletionNet) or full shapes' (VAE) maps at each
    stride; each decoder level generates its map from the full shapes' map
    at the coarser stride, as if pruning kept exactly the targets.
    Returns [(name, K, Cin, Cout, KernelMap)], one per distinct shape."""
    ch = GEN_CHANNELS
    x_c, _ = completion_input(batch, dev)
    x_v, _ = vae_input(batch, dev)
    calls = []

    def conv(name, cls, x, cin, cout, k, stride):
        m = cls(cin, cout, kernel_size=k, stride=stride, dimension=3, device=dev)
        out_key = _conv_out_key(x.coordinate_manager, x.coordinate_map_key, m.kernel_generator,
                                m.is_transpose, m.expand_coordinates)
        calls.append((name, k**3, cin, cout, m._kernel_map(x, out_key)))
        return MT.SparseTensor(
            torch.zeros(x.coordinate_manager.size(out_key), 1, device=dev),
            coordinate_map_key=out_key, coordinate_manager=x.coordinate_manager,
        )

    C, G = MT.MinkowskiConvolution, MT.MinkowskiGenerativeConvolutionTranspose
    y = conv("c.enc_first", C, x_c, 1, ch[0], 3, 1)
    full_c = [x_c.coordinate_manager.stride(x_c.coordinate_manager.insert_and_map(
        torch.from_numpy(batch[2]).to(dev), 1, "full")[0], 2**i) for i in range(7)]
    for i in range(6):
        y = conv(f"c.enc{i}.down", C, y, ch[i], ch[i + 1], 2, 2)
        conv(f"c.enc{i}.conv", C, y, ch[i + 1], ch[i + 1], 3, 1)
    mgr = x_c.coordinate_manager
    for i in range(6):  # output strides 32 .. 1
        src = MT.SparseTensor(torch.zeros(mgr.size(full_c[6 - i]), 1, device=dev),
                              coordinate_map_key=full_c[6 - i], coordinate_manager=mgr)
        y = conv(f"c.dec{i}.gen", G, src, ch[6 - i], ch[5 - i], 4 if i == 0 else 2, 2)
        conv(f"c.dec{i}.conv", C, y, ch[5 - i], ch[5 - i], 3, 1)
    y = x_v
    vch = (1,) + ch
    for i in range(7):
        y = conv(f"v.enc{i}.down", C, y, vch[i], vch[i + 1], 3, 2)
        conv(f"v.enc{i}.conv", C, y, vch[i + 1], vch[i + 1], 3, 1)
    mgr = x_v.coordinate_manager
    for i in range(6):  # output strides 64 .. 2, from the full shapes' maps at 128 .. 4
        src_key = mgr.stride(x_v.coordinate_map_key, 2 ** (7 - i))
        src = MT.SparseTensor(torch.zeros(mgr.size(src_key), 1, device=dev),
                              coordinate_map_key=src_key, coordinate_manager=mgr)
        y = conv(f"v.dec{i}.gen", G, src, ch[6 - i], ch[5 - i], 2, 2)
        conv(f"v.dec{i}.conv", C, y, ch[5 - i], ch[5 - i], 3, 1)
    distinct = {}
    for name, K, cin, cout, kmap in calls:
        distinct.setdefault((K, cin, cout, kmap.n_in, kmap.n_out), (name, K, cin, cout, kmap))
    return list(distinct.values())


def check_calls(calls, grads, tag):
    """Phases 17 and 19: each captured conv call's forward, input gradient
    and weight gradient against their plain versions, on its real map."""
    rows = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        rows.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, f"{tag}{i}", with_dx=inp.F.requires_grad,
        ))
    print_sums(step_sums(rows))
    return rows


def keep_masks(out_cls, targets):
    return [((c.F[:, 0] > 0) | t).cpu() for c, t in zip(out_cls, targets)]


class RecordedPruning(MT.MinkowskiPruning):
    """The card's pruning, keeping each level's keep mask on the host."""

    def __init__(self):
        super().__init__()
        self.masks = []

    def forward(self, input, mask):
        self.masks.append(mask.cpu())
        return super().forward(input, mask)


class ForcedPruning(MT.MinkowskiPruning):
    """A run's pruning (on the CPU, or on the card in another dtype), held to
    the card's keep masks so that every level of both runs has the same
    map.  The masks may differ only on rows whose card and own logits lie
    on either side of 0, each within the level's distance between the two
    runs' logits of 0 (which ``judge_levels`` holds to the logit
    tolerance); such a row follows the card, and the level, the rows and
    the margin are printed and kept in ``flips`` as (level, rows that
    differ, rows).  Any other difference fails."""

    def __init__(self, model, card, tag):
        super().__init__()
        self.card_logits = [c.F.detach()[:, 0].cpu().double() for c in card[0]]
        self.card_masks, self.tag, self.logits, self.flips = card[1], tag, [], []
        for head in model.cls_heads:
            head.register_forward_hook(lambda m, a, o: self.logits.append(o.F.detach()[:, 0]))

    def forward(self, input, mask):
        level = len(self.logits) - 1
        card = self.card_masks[level]
        differ = mask.cpu() != card
        self.flips.append((level, int(differ.sum()), differ.numel()))
        if differ.any():
            logit, card_logit = self.logits[level].cpu().double(), self.card_logits[level]
            margin = (logit[differ].abs().max() / logit.abs().max()).item()
            apart = rel_diff(card_logit, logit)
            print(f"  {self.tag} level {level}: keep mask differs on {int(differ.sum())} rows, "
                  f"logit within {margin:.2e} of 0 (relative; the level's logits {apart:.2e} "
                  f"apart); the run follows the card")
            if not margin <= apart:
                raise AssertionError(f"{self.tag}: level {level} keep masks disagree")
        return super().forward(input, card.to(mask.device))


def judge_levels(tag, card, cpu32, cpu64):
    """Per level of a generative decoder in train mode, the card's
    coordinates and logits against the CPU's float32 run (the keep masks are
    held by ``ForcedPruning``).  ``card``, ``cpu32``, ``cpu64``: per-level
    logits tensors.  The logits agree within LOGIT_RTOL or, as in phase 14c,
    the card is held to GRAD_FACTOR times the CPU float32 run's distance
    from the float64 run (batch norm over the few rows of the deepest
    levels amplifies float32 rounding)."""
    for level, (c, p, q) in enumerate(zip(card, cpu32, cpu64)):
        if not (torch.equal(c.C.cpu(), p.C) and torch.equal(q.C, p.C)):
            raise AssertionError(f"{tag}: level {level} coordinates differ")
        got = c.F.detach().cpu().double()
        rel = rel_diff(got, p.F.detach().double())
        card64 = rel_diff(got, q.F.detach())
        cpu64 = rel_diff(p.F.detach().double(), q.F.detach())
        print(f"  {tag} level {level}: {c.size} rows at stride {c.tensor_stride[0]}, logits rel "
              f"{rel:.2e}; against float64: card {card64:.2e}, CPU float32 {cpu64:.2e}")
        if not (rel <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
            raise AssertionError(f"{tag}: level {level} logits disagree: {rel:.3e}")


def generative(dev, launches, reuse):
    """Phases 15-20: CompletionNet and the VAE at the reference widths on
    stand-in completion batches.  Adds the main-path launches to
    ``launches``; returns the kernel rows of phases 15, 17 and 19.  Keeps
    the batches, and phase 18's and 19's rows per level, times and peak memory, in
    ``reuse`` (phase 43 sets its bf16 steps beside them)."""
    t0 = time.perf_counter()
    batches = reuse["gen_batches"] = {s: gen_batch(s) for s in range(4)}
    float32 = reuse["gen_float32"] = {"completion": [], "vae": []}
    print(f"[15 generative kernels, synthetic maps] {GEN_SHAPES} shapes at {GEN_RES}^3, "
          f"{COMPLETION_POINTS} points each: batches made in {time.perf_counter() - t0:.1f} s")
    for s, (partial, _, full) in batches.items():
        print(f"  batch seed {s}: {len(partial)} partial voxels, {len(full)} full voxels")
    gen_rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for name, K, cin, cout, kmap in generative_shapes(dev, batches[0]):
        x = torch.randn(kmap.n_in, cin, device=dev, generator=g)
        w = torch.randn(K, cin, cout, device=dev, generator=g) / (K * cin) ** 0.5
        gout = torch.randn(kmap.n_out, cout, device=dev, generator=g)
        gen_rows.append(backward_rows(x, w, gout, kmap.in_idx, kmap.out_idx_t, name))
    torch.cuda.empty_cache()

    # 16. completion inference: three batches in eval mode, counted
    net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **GEN_WIDTHS)
    calibrate(net, lambda: net(*completion_input(batches[0], dev)))
    completion_convs = sparse_convs(net)
    if len(completion_convs) != COMPLETION_CONVS:
        raise AssertionError(f"CompletionNet has {len(completion_convs)} sparse convs")

    def complete(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out_cls, _, out = net(*completion_input(batch, dev))
            n_out = out.size
        torch.cuda.synchronize()
        return [c.size for c in out_cls], n_out, time.perf_counter() - t0

    for seed in range(3):
        (rows, n_out, secs), n = counted(launches, lambda: complete(batches[seed]))
        n_in = len(batches[seed][0])
        print(f"[16 complete] batch seed {seed}: {n_in} voxels in, {secs * 1e3:.2f} ms, "
              f"{n_in / secs:.0f} voxels/s, rows per decoder level {rows}, {n_out} completed "
              f"voxels, {n['gather_gemm']} gather_gemm launches")
        if n["gather_gemm"] < COMPLETION_CONVS or n["conv_dw"] or n_out == 0:
            raise AssertionError(f"completion batch {seed}: {n} launches, {n_out} voxels")
    del net
    torch.cuda.empty_cache()

    # 17. kernels on the real maps of one completion training step
    net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **GEN_WIDTHS)

    def completion_step(model, batch, device):
        out_cls, targets, _ = model(*completion_input(batch, device))
        loss = bce(out_cls, targets)
        loss.backward()
        return loss, out_cls, targets

    calls, grads, _ = capture_step(sparse_convs(net), lambda: completion_step(net, batches[0], dev))
    if len(calls) != COMPLETION_CONVS or len(grads) != COMPLETION_CONVS:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    print(f"[17 kernels, completion training-step maps] {len(calls)} conv calls")
    completion_bwd = check_calls(calls, grads, "comp")
    del calls, grads, net
    torch.cuda.empty_cache()

    # 18. completion training: four SGD steps, counted
    net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **GEN_WIDTHS).train()
    opt = gen_sgd(net)
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss, out_cls, _ = completion_step(net, batches[step], dev)
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), [c.size for c in out_cls], time.perf_counter() - t0

        (loss, rows, secs), n = counted(launches, one_step)
        float32["completion"].append((rows, secs))
        n_in = len(batches[step][0])
        print(f"[18 train completion] step {step}: {n_in} voxels in, {secs * 1e3:.2f} ms, "
              f"{n_in / secs:.0f} voxels/s, loss {loss:.6f}, rows per decoder level {rows}, "
              f"{n['gather_gemm']} gather_gemm and {n['conv_dw']} conv_dw launches")
        if n["gather_gemm"] < 2 * COMPLETION_CONVS - 1 or n["conv_dw"] != COMPLETION_CONVS:
            raise AssertionError(f"step {step}: {n} launches")
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
    float32["completion_peak"] = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {float32['completion_peak'] / 2**30:.2f} GiB")
    del net, opt
    torch.cuda.empty_cache()

    # 19. the VAE: a training step and a generation per batch, counted
    vae = VAE(generator=torch.Generator().manual_seed(0), device=dev, **VAE_WIDTHS).train()
    vae_convs = sparse_convs(vae)
    if len(vae_convs) != VAE_CONVS:
        raise AssertionError(f"the VAE has {len(vae_convs)} sparse convs")
    opt = gen_sgd(vae)
    noise = torch.Generator(device=dev).manual_seed(0)
    vae_bwd = []

    def seeded(b):  # the same noise for a batch's calibration and its generation
        return torch.Generator(device=dev).manual_seed(100 + b)

    for b in range(2):
        torch.cuda.reset_peak_memory_stats()

        def vae_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vae.train()
            opt.zero_grad()
            out_cls, targets, _, mean, log_var = vae(*vae_input(batches[b], dev), generator=noise)
            loss = vae_loss(out_cls, targets, mean, log_var)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), [c.size for c in out_cls], time.perf_counter() - t0

        if b == 0:  # its conv calls are held against the plain versions below
            calls, grads, ((loss, rows, secs), n) = capture_step(vae_convs, lambda: counted(launches, vae_step))
        else:
            (loss, rows, secs), n = counted(launches, vae_step)
        float32["vae"].append((rows, secs, torch.cuda.max_memory_allocated()))
        n_in = len(batches[b][2])
        print(f"[19 VAE] batch seed {b}: training step {n_in} voxels, {secs * 1e3:.2f} ms, "
              f"{n_in / secs:.0f} voxels/s, loss {loss:.6f}, rows per decoder level {rows}, "
              f"{n['gather_gemm']} gather_gemm and {n['conv_dw']} conv_dw launches, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if n["gather_gemm"] < 2 * VAE_CONVS - 1 or n["conv_dw"] != VAE_CONVS or not np.isfinite(loss):
            raise AssertionError(f"VAE step {b}: {n} launches, loss {loss}")
        if b == 0:
            if len(calls) != VAE_CONVS or len(grads) != VAE_CONVS:
                raise AssertionError(f"captured {len(calls)} VAE calls and {len(grads)} gradients")
            vae_bwd = check_calls(calls, grads, "vae")
            del calls, grads
        calibrate(vae, lambda: vae(*vae_input(batches[b], dev), generator=seeded(b)))

        def generate():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out_cls, _, out, _, _ = vae(*vae_input(batches[b], dev), generator=seeded(b))
                n_out = out.size
            torch.cuda.synchronize()
            return [c.size for c in out_cls], n_out, out.tensor_stride, time.perf_counter() - t0

        (rows, n_out, ts, secs), n = counted(launches, generate)
        print(f"[19 VAE] batch seed {b}: generation {secs * 1e3:.2f} ms, rows per decoder level "
              f"{rows}, {n_out} voxels at stride {ts[0]}, {n['gather_gemm']} gather_gemm launches")
        if n["gather_gemm"] < VAE_CONVS or n["conv_dw"] or n_out == 0:
            raise AssertionError(f"VAE generation {b}: {n} launches, {n_out} voxels")
    del vae, opt
    torch.cuda.empty_cache()

    # 20. parity with the CPU plain path, on a small batch at full width
    small = gen_batch(PARITY_SEED, PARITY_SHAPES, PARITY_RES)
    print(f"[20 parity] batch seed {PARITY_SEED}: {PARITY_SHAPES} shapes at {PARITY_RES}^3, "
          f"{len(small[0])} partial and {len(small[2])} full voxels")
    widths = dict(GEN_WIDTHS, resolution=PARITY_RES)
    net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **widths).train()
    net.pruning = RecordedPruning()
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    loss, card, _ = completion_step(net, small, dev)
    loss0 = loss.item()
    grads0 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
    stats0 = {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k}
    card_masks = net.pruning.masks
    del net, loss
    cpu_levels = {}

    def cpu_completion_step(dtype):
        cpu_net = CompletionNet(device="cpu", **widths).train()
        cpu_net.load_state_dict(init)
        cpu_net.to(dtype)
        cpu_net.pruning = ForcedPruning(cpu_net, (card, card_masks), f"20 CompletionNet {dtype}")
        partial, feats, full = small
        feats = feats if dtype == torch.float32 else feats.astype(np.float64)
        loss, cpu_levels[dtype], _ = completion_step(cpu_net, (partial, feats, full), "cpu")
        return loss, cpu_net, len(partial)

    cpu = cpu_steps(cpu_completion_step, "20 parity", "voxels")
    judge_levels("20 CompletionNet", card, cpu_levels[torch.float32], cpu_levels[torch.float64])
    judge_step("20 parity", loss0, grads0, stats0, cpu)
    del card, cpu_levels

    vae_widths = dict(VAE_WIDTHS, resolution=PARITY_RES)

    def vae_run(model, device, dtype):
        x, target = vae_input(small, device)
        with torch.no_grad():  # the same noise from a seeded CPU generator
            out_cls, _, _, mean, log_var = model(
                MT.SparseTensor(x.F.to(dtype), coordinate_map_key=x.coordinate_map_key,
                                coordinate_manager=x.coordinate_manager),
                target, generator=torch.Generator().manual_seed(1),
            )
        return out_cls, mean, log_var

    vae = VAE(generator=torch.Generator().manual_seed(0), device=dev, **vae_widths).train()
    vae.decoder.pruning = RecordedPruning()
    vae_init = {k: v.cpu().clone() for k, v in vae.state_dict().items()}
    runs = [vae_run(vae, dev, torch.float32)]
    for dtype in (torch.float32, torch.float64):
        cpu_vae = VAE(device="cpu", **vae_widths).train()
        cpu_vae.load_state_dict(vae_init)
        cpu_vae.to(dtype)
        cpu_vae.decoder.pruning = ForcedPruning(
            cpu_vae.decoder, (runs[0][0], vae.decoder.pruning.masks), f"20 VAE decoder {dtype}"
        )
        runs.append(vae_run(cpu_vae, "cpu", dtype))
    del vae, cpu_vae
    for name, i in (("mean", 1), ("log-variance", 2)):
        got = runs[0][i].F.cpu().double()
        rel = rel_diff(got, runs[1][i].F.double())
        card64, cpu64 = rel_diff(got, runs[2][i].F), rel_diff(runs[1][i].F.double(), runs[2][i].F)
        print(f"  20 VAE encoder {name}: card vs CPU {rel:.2e}; against float64: card "
              f"{card64:.2e}, CPU float32 {cpu64:.2e}")
        if not (rel <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
            raise AssertionError(f"VAE {name} disagrees: {rel:.3e}")
    judge_levels("20 VAE decoder", runs[0][0], runs[1][0], runs[2][0])
    return gen_rows, completion_bwd, vae_bwd


class SEResNet18(ResNetBase):
    """ResNet18 with squeeze-and-excitation basic blocks."""

    BLOCK = SEBasicBlock
    LAYERS = (2, 2, 2, 2)


def splat_fcnn(device, generator=None):
    return MinkowskiSplatFCNN(3, CLASSES, generator=generator, device=device, **FCNN_WIDTHS)


def splat_and_se(dev, launches):
    """Phases 21-25: MinkowskiSplatFCNN inference, training and parity, and
    an SE-ResNet18 classifier.  Adds the main-path launches to ``launches``;
    returns the kernel rows of phase 21."""
    shape_batch = shapes(0, CoordinateTransformation())
    batches = [shapes(s) for s in (0, 1, 2)]

    # 21. kernels on the real maps of one SplatFCNN training step, dropout off
    net = splat_fcnn(dev, torch.Generator().manual_seed(0)).train()
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    convs = sparse_convs(net)
    if len(convs) != FCNN_CONVS:
        raise AssertionError(f"MinkowskiSplatFCNN has {len(convs)} sparse convs")
    set_dropout(net, False)
    calls, grads, (loss, _) = capture_step(convs, lambda: fcnn_step(net, *shape_batch, dev))
    if len(calls) != FCNN_CONVS or len(grads) != FCNN_CONVS:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    loss0 = loss.item()
    grads0 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
    stats0 = {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k}
    tf = field(*shape_batch[:2], dev)
    splat_rows, sparse_rows = tf.splat().size, tf.sparse().size
    print(f"[21 kernels, SplatFCNN training-step maps] {len(calls)} conv calls; "
          f"{len(shape_batch[0])} points: {splat_rows} splat rows at stride 1 against "
          f"{sparse_rows} sparse() rows ({splat_rows / sparse_rows:.2f}x)")
    splat_bwd = check_calls(calls, grads, "splat")
    del calls, grads, loss, net, tf

    # 22. SplatFCNN inference: three batches, counted
    net = splat_fcnn(dev).eval()
    net.load_state_dict(init)
    classify(net, *batches[0][:2], dev)  # warm-up
    logits22 = []
    for seed, (coords, feats, _) in enumerate(batches):
        (logits, secs), n = counted(launches, lambda: classify(net, coords, feats, dev))
        logits22.append(logits)
        print(f"[22 SplatFCNN classify] batch seed {seed}: {len(coords)} points, {secs * 1e3:.2f} ms, "
              f"{len(coords) / secs:.0f} points/s, {n['gather_gemm']} gather_gemm launches")
        if n["gather_gemm"] < FCNN_CONVS or n["conv_dw"]:
            raise AssertionError(f"SplatFCNN batch {seed}: {n} launches")
        if logits.shape != (SHAPES, CLASSES) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    del net

    # 23. SplatFCNN training: four SGD steps on phase 13's batches, counted
    net = splat_fcnn(dev, torch.Generator().manual_seed(0)).train()
    for m in net.modules():
        if isinstance(m, MinkowskiDropout):
            m.generator = torch.Generator(device=dev).manual_seed(0)
    opt = torch.optim.SGD(net.parameters(), lr=FCNN_LR, momentum=FCNN_MOMENTUM, weight_decay=FCNN_WD)
    torch.cuda.reset_peak_memory_stats()
    for step, s in enumerate((0, 1, 2, 3)):
        coords, feats, lab = shape_batch if s == 0 else shapes(s, CoordinateTransformation())

        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss, logits = fcnn_step(net, coords, feats, lab, dev)
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), logits.shape, time.perf_counter() - t0

        (loss, shape, secs), n = counted(launches, one_step)
        print(f"[23 train SplatFCNN] step {step}: {len(coords)} points, {secs * 1e3:.2f} ms, "
              f"{len(coords) / secs:.0f} points/s, loss {loss:.6f}, {n['gather_gemm']} gather_gemm "
              f"and {n['conv_dw']} conv_dw launches")
        if n["gather_gemm"] < 2 * FCNN_CONVS or n["conv_dw"] != FCNN_CONVS:
            raise AssertionError(f"step {step}: {n} launches")
        if shape != (SHAPES, CLASSES) or not np.isfinite(loss):
            raise AssertionError(f"step {step}: logits {tuple(shape)}, loss {loss}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del net, opt

    # 24. parity with the CPU plain path
    # (a) batch 0's logits in eval mode
    cpu_net = splat_fcnn("cpu").eval()
    cpu_net.load_state_dict(init)
    with torch.no_grad():
        ref = cpu_net(field(*batches[0][:2], "cpu"))
    rel = rel_diff(logits22[0], ref)
    print(f"[24a parity] SplatFCNN logits, CUDA vs CPU plain path: max|d|/max|ref| = {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"SplatFCNN logits disagree: {rel:.3e} > {LOGIT_RTOL}")

    # (b) phase 21's step, dropout off, in float32 and float64 on the CPU
    def cpu_splat_step(dtype):
        net = splat_fcnn("cpu").train()
        net.load_state_dict(init)
        net.to(dtype)
        set_dropout(net, False)
        coords, feats, lab = shape_batch
        loss, _ = fcnn_step(net, coords, torch.from_numpy(feats).to(dtype), lab, "cpu")
        return loss, net, len(coords)

    judge_step("24b parity", loss0, grads0, stats0, cpu_steps(cpu_splat_step, "24b parity", "points"))

    # (c) the splat of batch 0's mlp1 output, and interpolation of the card's
    # conv1 output at the field's points, each on the card and on the CPU
    # from the same inputs
    coords, feats, _ = batches[0]
    net = splat_fcnn(dev).eval()
    net.load_state_dict(init)
    with torch.no_grad():
        x = net.mlp1(field(coords, feats, dev))
        card, host = x.splat(), field(coords, x.F.cpu(), "cpu").splat()
        if not torch.equal(card.C.cpu(), host.C):
            raise AssertionError("splat coordinates differ between the card and the CPU")
        splat_rel = rel_diff(card.F.cpu(), host.F)
        y = net.conv1(card)
        host_y = MT.SparseTensor(y.F.cpu(), coordinate_map_key=host.coordinate_map_key,
                                 coordinate_manager=host.coordinate_manager)
        interp_rel = rel_diff(y.interpolate(x).cpu(), host_y.interpolate(field(coords, x.F.cpu(), "cpu")))
    print(f"[24c parity] splat of batch 0: {card.size} rows, coordinates equal, features card vs "
          f"CPU {splat_rel:.2e}; interpolation of conv1's output at {len(coords)} points {interp_rel:.2e}")
    if not (splat_rel <= SPLAT_RTOL and interp_rel <= SPLAT_RTOL):
        raise AssertionError(f"splat {splat_rel:.3e} or interpolation {interp_rel:.3e} > {SPLAT_RTOL}")
    del net, x, y, card, host, host_y

    # 25. SE-ResNet18 on batch 0: logits against the CPU, then a training step
    rn = SEResNet18(3, CLASSES, D=3, generator=torch.Generator().manual_seed(0), device=dev).eval()
    rn_convs = len(sparse_convs(rn))
    rn_init = {k: v.cpu().clone() for k, v in rn.state_dict().items()}
    with torch.no_grad():
        rn_logits, n = counted(launches, lambda: rn(field(coords, feats, dev).sparse()).F.cpu())
    if n["gather_gemm"] != rn_convs or n["conv_dw"]:
        raise AssertionError(f"SE-ResNet18: {n} launches for {rn_convs} sparse convs")
    if rn_logits.shape != (SHAPES, CLASSES) or not torch.isfinite(rn_logits).all():
        raise AssertionError(f"SE-ResNet18: bad logits, shape {tuple(rn_logits.shape)}")
    rn_cpu = {}
    for dtype in (torch.float32, torch.float64):
        cpu_rn = SEResNet18(3, CLASSES, D=3, device="cpu").eval()
        cpu_rn.load_state_dict(rn_init)
        cpu_rn.to(dtype)
        with torch.no_grad():
            rn_cpu[dtype] = cpu_rn(field(coords, torch.from_numpy(feats).to(dtype), "cpu").sparse()).F
    rel = rel_diff(rn_logits.double(), rn_cpu[torch.float32].double())
    card64 = rel_diff(rn_logits.double(), rn_cpu[torch.float64])
    cpu64 = rel_diff(rn_cpu[torch.float32].double(), rn_cpu[torch.float64])
    print(f"[25 SE-ResNet18] {rn_convs} sparse convs, {n['gather_gemm']} gather_gemm launches; "
          f"logits CUDA vs CPU float32 {rel:.2e}; against float64: card {card64:.2e}, CPU float32 "
          f"{cpu64:.2e}")
    if not (rel <= LOGIT_RTOL or card64 <= GRAD_FACTOR * cpu64):
        raise AssertionError(f"SE-ResNet18 logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    rn.train()
    for m in rn.modules():
        if isinstance(m, MinkowskiDropout):
            m.generator = torch.Generator(device=dev).manual_seed(0)
    opt = torch.optim.SGD(rn.parameters(), lr=FCNN_LR, momentum=FCNN_MOMENTUM, weight_decay=FCNN_WD)
    step_secs = []
    for step, s in enumerate((0, 1, 2, 3)):  # step 0 warms up; steps 1-3 are timed
        coords, feats, lab = shape_batch if s == 0 else shapes(s, CoordinateTransformation())

        def rn_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            out = rn(field(coords, feats, dev).sparse()).F
            loss = torch.nn.functional.cross_entropy(out, torch.as_tensor(lab).long().to(dev))
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), time.perf_counter() - t0

        (loss, secs), n = counted(launches, rn_step)
        if step:
            step_secs.append(secs)
        print(f"  training step {step}{' (warm-up)' if step == 0 else ''}: {len(coords)} points, "
              f"{secs * 1e3:.2f} ms, loss {loss:.6f}, {n['gather_gemm']} gather_gemm and "
              f"{n['conv_dw']} conv_dw launches")
        if n["gather_gemm"] < 2 * rn_convs - 1 or n["conv_dw"] != rn_convs or not np.isfinite(loss):
            raise AssertionError(f"SE-ResNet18 step {step}: {n} launches, loss {loss}")
    print(f"  steps 1-3: mean {np.mean(step_secs) * 1e3:.2f} ms, "
          f"{len(shape_batch[0]) / np.mean(step_secs):.0f} points/s")
    return splat_bwd


def room_points(seed):
    """A raw room scan: (400,000 x 3 float32 points, colors, labels).  The
    room of ``scan``; colors a function of the point, as
    examples/indoor.py makes them (height, sines of x and y, centred at 0);
    labels the height band ``floor(z / 0.125) mod 20``, so voxels across a
    band edge get points of two labels."""
    pts = make_room_scan(n_points=ROOM_POINTS, extent=(2.0, 2.0, 2.2), n_objects=4, seed=seed)
    colors = np.stack(
        [pts[:, 2] / 2.5, 0.5 + 0.5 * np.sin(pts[:, 0] * 2.1), 0.5 + 0.5 * np.cos(pts[:, 1] * 1.7)],
        axis=1,
    ).astype(np.float32) - 0.5
    labels = np.floor(pts[:, 2] / 0.125).astype(np.int64) % 20
    return pts, colors, labels


def shim_rows(conv, shim, x, tag, launches):
    """Phase 27a: ``shim.apply`` against ``conv`` on the same input map and
    weights, forward and both gradients bit-equal, both runs counted into
    ``launches``; returns the kernels' rows on that map."""
    gen = torch.Generator(device=x.device).manual_seed(1)
    feats = x.F.detach().clone().requires_grad_()
    conv.kernel.grad = None

    def module_run():
        y = conv(MT.SparseTensor(feats, coordinate_map_key=x.coordinate_map_key,
                                 coordinate_manager=x.coordinate_manager))
        g = torch.randn(y.F.shape, device=x.device, generator=gen)
        y.F.backward(g)
        return y, g

    (y, g), n_module = counted(launches, module_run)
    want = (y.F.detach(), feats.grad.clone(), conv.kernel.grad.clone())
    feats.grad = None
    conv.kernel.grad = None

    def shim_run():
        out = shim.apply(feats, conv.kernel, conv.kernel_generator, MT.ConvolutionMode.DEFAULT,
                         x.coordinate_map_key, y.coordinate_map_key, x.coordinate_manager)
        out.backward(g)
        return out.detach()

    out, n_shim = counted(launches, shim_run)
    got = (out, feats.grad, conv.kernel.grad)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  {tag}: {shim.__name__} on {x.size} -> {y.size} rows, output, input and weight "
          f"gradients bit-equal to the module: {equal}; launches module {n_module}, shim {n_shim}")
    if not equal or n_shim != n_module or n_shim != {"gather_gemm": 2, "conv_dw": 1,
                                                     "gather_gemm_bf16": 0, "conv_dw_bf16": 0}:
        raise AssertionError(f"{tag}: the shim differs from the module")
    kmap = conv._kernel_map(x, y.coordinate_map_key)
    row = backward_rows(x.F.detach(), conv.kernel.detach(), g, kmap.in_idx, kmap.out_idx_t, tag)
    conv.kernel.grad = None
    return row


def card_vs_cpu(tag, fn, card_args, cpu_args):
    """Phase 27b-c: ``fn`` on the card and on the CPU; each output and
    gradient within EXTRA_RTOL of max|ref|, and the card's ms per call."""
    got, want = fn(*card_args), fn(*cpu_args)
    rels = {k: rel_diff(got[k].cpu(), want[k]) for k in want}
    with torch.no_grad():
        ms = cuda_ms(lambda: fn(*card_args, grads=False))
    print(f"  {tag}: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f" of max|ref|; {ms:.4f} ms per call on the card")
    if not all(v <= EXTRA_RTOL for v in rels.values()):
        raise AssertionError(f"{tag}: the card and the CPU disagree beyond {EXTRA_RTOL}")
    return ms


def data_loader_path(dev, launches):
    """Phases 26-27: raw room-scan points through ``sparse_quantize`` into
    MinkUNet34 training and inference, then the layer extras.  Adds the
    main-path launches to ``launches``; returns the kernel rows of phase
    27a."""
    # 26. the data loader's path
    start = time.perf_counter()
    if hostengine.load() is None:
        raise AssertionError("the native host engine did not build or load")
    print(f"[26 data loader] host engine {hostengine.library_path().name}, built and loaded in "
          f"{time.perf_counter() - start:.1f} s")
    scans, quantized = [room_points(s) for s in (0, 1)], []
    for seed, (pts, colors, labels) in enumerate(scans):
        t0 = time.perf_counter()
        q = MT.utils.sparse_quantize(
            pts, colors, labels, quantization_size=ROOM_VOXEL, ignore_label=IGNORE,
            return_index=True, return_inverse=True,
        )
        secs = time.perf_counter() - t0
        coords, feats, labs, idx, inv = q
        t0 = time.perf_counter()
        discrete = np.floor(pts / np.full(3, ROOM_VOXEL)).astype(np.int32)
        ref = quantize_label_reference(discrete, labels, IGNORE)
        ref_secs = time.perf_counter() - t0
        same = all(np.array_equal(a, b) for a, b in zip((idx, inv, labs), ref))
        print(f"  scan {seed}: {len(pts)} points -> {len(coords)} voxels in {secs * 1e3:.2f} ms on "
              f"the host engine (numpy version {ref_secs * 1e3:.2f} ms); {np.mean(labs == IGNORE):.2%} "
              f"of the voxels labelled {IGNORE}; maps and labels bit-equal to numpy: {same}")
        if not (same and np.array_equal(coords, discrete[idx]) and np.array_equal(coords[inv], discrete)):
            raise AssertionError(f"scan {seed}: the host engine's quantization differs from numpy's")
        quantized.append(q)
    n_points = sum(len(p) for p, _, _ in scans)

    def batch():
        """The two scans collated and on the card, in a fresh manager; the
        labels in the manager's row order."""
        coords, feats, labels = sparse_collate(
            [q[0] for q in quantized], [q[1] for q in quantized], [q[2] for q in quantized],
            device=dev,
        )
        x = MT.SparseTensor(feats, coords)
        return x, labels.long()[x.unique_index]

    net = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev).train()
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    for step in range(TRAIN_STEPS):
        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, labels = batch()
            opt.zero_grad()
            out = net(x)
            loss = torch.nn.functional.cross_entropy(out.F, labels, ignore_index=IGNORE)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), tuple(out.F.shape), x.size, time.perf_counter() - t0

        (loss, shape, n_vox, secs), n = counted(launches, one_step)
        print(f"[26 train] step {step}: {n_vox} voxels of {n_points} points, {secs * 1e3:.2f} ms, "
              f"{n_vox / secs:.0f} voxels/s, {n_points / secs:.0f} points/s, loss {loss:.6f}, "
              f"{n['gather_gemm']} gather_gemm and {n['conv_dw']} conv_dw launches")
        if n["gather_gemm"] < MIN_LAUNCHES + MIN_DX_LAUNCHES or n["conv_dw"] != MIN_LAUNCHES:
            raise AssertionError(f"step {step}: {n} launches")
        if shape != (n_vox, 20) or not np.isfinite(loss):
            raise AssertionError(f"step {step}: logits {shape}, loss {loss}")

    # the answer: per-voxel class probabilities, then a class per point
    net.eval()

    def answer_points():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _ = batch()
        with torch.no_grad():
            probs = MT.MinkowskiFunctional.softmax(net(x), dim=1)
            voxel_class = probs.F.argmax(1)
            offset, classes = 0, []
            for q in quantized:
                rows = x.inverse_mapping[offset + torch.from_numpy(q[4]).to(dev)]
                classes.append(voxel_class[rows].cpu())
                offset += len(q[0])
        return probs.F, classes, time.perf_counter() - t0

    (probs, classes, secs), n = counted(launches, answer_points)
    print(f"[26 answer] eval: {len(probs)} voxels, softmax and a class per point for "
          f"{[len(c) for c in classes]} points in {secs * 1e3:.2f} ms, {n['gather_gemm']} gather_gemm "
          f"launches; class counts of scan 0: {torch.bincount(classes[0], minlength=20).tolist()}")
    if [len(c) for c in classes] != [len(p) for p, _, _ in scans] or n["gather_gemm"] < MIN_LAUNCHES:
        raise AssertionError(f"the answer covers {[len(c) for c in classes]} points, {n} launches")
    if not (torch.isfinite(probs).all() and (probs.sum(1) - 1).abs().max() < 1e-5):
        raise AssertionError("the class probabilities are not finite rows that sum to 1")
    coords0, feats0, _ = sparse_collate([quantized[0][0]], [quantized[0][1]], [quantized[0][2]])
    with torch.no_grad():
        card = net(MT.SparseTensor(feats0.to(dev), coords0.to(dev))).F.cpu()
        cpu_net = MinkUNet34(3, 20, D=3, device="cpu").eval()
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        ref = cpu_net(MT.SparseTensor(feats0, coords0)).F
    rel = rel_diff(card, ref)
    print(f"[26 parity] scan 0 eval logits after training, CUDA vs CPU plain path: {rel:.2e}")
    if not rel <= LOGIT_RTOL:
        raise AssertionError(f"scan 0 logits disagree: {rel:.3e} > {LOGIT_RTOL}")
    del cpu_net, card, ref, probs

    # 27. the layer extras on the same batch
    x, _ = batch()
    stem = net.conv0p1s1
    print("[27a Function shims]")
    stem_row = shim_rows(stem, MT.MinkowskiConvolutionFunction, x, "stem", launches)
    up = net.convtr7p2s2
    key2 = x.coordinate_manager.stride(x.coordinate_map_key, 2)
    n2 = x.coordinate_manager.size(key2)
    x2 = MT.SparseTensor(
        torch.randn(n2, up.in_channels, device=dev, generator=torch.Generator(device=dev).manual_seed(2)),
        coordinate_map_key=key2, coordinate_manager=x.coordinate_manager,
    )
    up_row = shim_rows(up, MT.MinkowskiConvolutionTransposeFunction, x2, "convtr7p2s2", launches)
    with torch.no_grad():
        y = stem(x)
    y_cpu = MT.SparseTensor(y.F.cpu(), y.C.cpu(), device="cpu")
    if not torch.equal(y_cpu.C, y.C.cpu()):
        raise AssertionError("the CPU manager ordered the stem's rows otherwise")

    print(f"[27b channelwise conv] on the stem's output, {y.size} rows x {y.F.shape[1]}")
    for stride in (1, 2):
        cw = MT.MinkowskiChannelwiseConvolution(32, kernel_size=3, stride=stride, bias=True, dimension=3,
                                                generator=torch.Generator().manual_seed(stride),
                                                device=dev)
        cw_cpu = MT.MinkowskiChannelwiseConvolution(32, kernel_size=3, stride=stride, bias=True,
                                                    dimension=3, device="cpu")
        cw_cpu.load_state_dict({k: v.cpu() for k, v in cw.state_dict().items()})

        def channelwise(module, t, g, grads=True):
            feats = t.F.detach().clone().requires_grad_(grads)
            out = module(MT.SparseTensor(feats, coordinate_map_key=t.coordinate_map_key,
                                         coordinate_manager=t.coordinate_manager))
            if not grads:
                return out.F
            module.zero_grad(set_to_none=True)
            out.F.backward(g[: out.F.shape[0]])
            return {"forward": out.F.detach(), "input gradient": feats.grad,
                    "weight gradient": module.kernel.grad, "bias gradient": module.bias.grad}

        g = torch.randn(y.size, 32, generator=torch.Generator().manual_seed(3))
        card_vs_cpu(f"stride {stride}", channelwise, (cw, y, g.to(dev)), (cw_cpu, y_cpu, g))

    print("[27c spmm] the stride-1 -> stride-2 stride map as COO")
    mgr = x.coordinate_manager
    key2 = mgr.stride(y.coordinate_map_key, 2)
    rows = mgr.stride_map(y.coordinate_map_key, key2)
    size = (mgr.size(key2), y.size)
    vals = torch.rand(y.size, generator=torch.Generator().manual_seed(4))

    def products(r, v, mat, grads=True):
        cols = torch.arange(len(r), device=r.device)
        out = MT.spmm(r, cols, v, size, mat)
        if not grads:
            return out
        avg, count = MT.spmm_average(r, cols, size, mat)
        if not torch.equal(count.cpu(), torch.bincount(r.long().cpu(), minlength=size[0])):
            raise AssertionError("spmm_average's row counts are not the stride map's")
        return {"spmm": out, "spmm_average": avg}

    card_vs_cpu(f"{size[1]} -> {size[0]} rows", products, (rows, vals.to(dev), y.F), (rows.cpu(), vals, y_cpu.F))
    print(f"[26-27] {time.perf_counter() - start:.1f} s")
    return [stem_row, up_row]


def bf16_step_calls(dev, reuse):
    """Every sparse conv call of one bf16 training step of MinkUNet34 (phase
    9's batch 0) and of MinkowskiFCNN (phase 13's first batch, dropout off),
    captured with hooks under ``set_compute_dtype(torch.bfloat16)``:
    {net: [(x, w, g, in_idx, out_idx_t, label, with_dx)]}: the conv's input
    features x as the module took them (the first conv's in float32,
    ``kernel_parts`` casts), the float32 weight w, the output gradient g in
    bf16.  Leaves the compute dtype as it found it."""
    before = MT.config.compute_dtype()
    MT.set_compute_dtype(torch.bfloat16)
    try:
        unet = unet_from(reuse["unet_init"], dev, True)
        coords, feats = collate(reuse["raw"][0])
        fcnn = MinkowskiFCNN(3, CLASSES, device=dev, **FCNN_WIDTHS).train()
        fcnn.load_state_dict(reuse["fcnn_init"])
        set_dropout(fcnn, False)
        steps = {}
        for name, model, run, n, prefix in (
            ("MinkUNet34", unet, lambda: train_step(unet, None, coords, feats, reuse["labels"][0], dev),
             MIN_LAUNCHES, "call"),
            ("MinkowskiFCNN", fcnn, lambda: fcnn_step(fcnn, *reuse["shape_batch"], dev),
             FCNN_CONVS, "fcnn"),
        ):
            steps[name] = step_calls(name, model, run, n, prefix)
    finally:
        MT.set_compute_dtype(before)
    return steps


def step_calls(name, model, run, n, prefix):
    """The ``n`` sparse conv calls of ``model`` in ``run`` (one training
    step), captured with hooks: [(x, w, g, in_idx, out_idx_t, label,
    with_dx)] for ``kernel_parts``."""
    calls, grads, _ = capture_step(sparse_convs(model), run)
    if len(calls) != n or len(grads) != n:
        raise AssertionError(f"{name}: captured {len(calls)} calls and {len(grads)} "
                             "output gradients")
    out = []
    for i, (m, inp, o) in enumerate(calls):
        kmap = m._kernel_map(inp, o.coordinate_map_key)
        out.append((inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
                    kmap.out_idx_t, f"{prefix}{i}", inp.F.requires_grad))
    return out


def kernel_parts(x, w, g, in_idx, out_idx_t, with_dx=True, bf16=True, with_dw=None):
    """One conv call's kernel calls: {part: (kernel, plain version,
    arguments, float32 arguments, tolerance, bound ms, what sets it)} for
    the forward, the input gradient (``with_dx``) and, in bf16, the weight
    gradient (``with_dw``, by default in bf16 alone).  bf16: the arguments
    cast, the bound 2 * pairs * Cin * Cout over the dense bf16 rate, or 2
    bytes per feature and weight element, 4 per index and per float32 dW
    element, over HBM_RATE.  float32: the arguments as they are,
    KERNEL_RTOL (K2: DW_RTOL), the bound as ``bound`` sets it (4 bytes an
    element)."""
    with_dw = bf16 if with_dw is None else with_dw
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    x, w, g = x.float(), w.float(), g.float()
    xb, wb, gb = (x.bfloat16(), w.bfloat16(), g.bfloat16()) if bf16 else (x, w, g)
    size, rate, k1_rtol = (2, BF16_PEAK, K1_BF16_RTOL) if bf16 else (4, TF32_PEAK, KERNEL_RTOL)
    flop = 2 * pairs(in_idx, n_in) * cin * cout
    work = {
        "fwd": (gather_gemm, gather_gemm_reference, (xb, wb, in_idx), (x, w, in_idx),
                k1_rtol, flop, size * (n_in * cin + K * cin * cout + n_out * cout) + 4 * K * n_out),
    }
    if with_dw:
        work["dw"] = (conv_dw, conv_dw_reference, (xb, gb, in_idx), (x, g, in_idx), DW_RTOL, flop,
                      size * (n_in * cin + n_out * cout) + 4 * K * n_out + 4 * K * cin * cout)
    if with_dx:
        work["dx"] = (gather_gemm, gather_gemm_reference,
                      (gb, wb.transpose(1, 2).contiguous(), out_idx_t),
                      (g, w.transpose(1, 2).contiguous(), out_idx_t), k1_rtol,
                      2 * pairs(out_idx_t, n_out) * cin * cout,
                      size * (n_out * cout + K * cin * cout + n_in * cin) + 4 * K * n_in)
    parts = {}
    for p in ("fwd", "dx", "dw"):
        if p in work:
            kernel, plain, args, args32, rtol, f, nbytes = work[p]
            ops_ms, bytes_ms = f / rate * 1e3, nbytes / HBM_RATE * 1e3
            parts[p] = (kernel, plain, args, args32, rtol,
                        *((ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")))
    return parts


def bf16_rows(x, w, g, in_idx, out_idx_t, label, with_dx=True):
    """Phase 28: one conv call's bf16 instances against their bf16 plain
    versions (forward, input gradient, weight gradient), with the float32
    instances' time on the same map and the bf16 bound (``kernel_parts``)."""
    K, cin, cout = w.shape
    n_in, n_out = x.shape[0], g.shape[0]
    row = dict(label=label, K=K, cin=cin, cout=cout, n_in=n_in, n_out=n_out)
    for p, (kernel, plain, args, args32, rtol, bound_ms, bound_by) in kernel_parts(
            x, w, g, in_idx, out_idx_t, with_dx).items():
        row[p] = check(kernel, plain, args, rtol, label + {"fwd": "", "dx": " dX", "dw": " dW"}[p])
        row[p].update(f32_ms=cuda_ms(lambda: kernel(*args32)), bound_ms=bound_ms,
                      bound_by=bound_by)
    parts = "  ".join(
        f"{p} {row[p]['ms']:.4f}/{row[p]['plain_ms']:.4f}/{row[p]['f32_ms']:.4f} ms "
        f"({row[p]['max_rel_err']:.1e}, bound {row[p]['bound_ms']:.4f} by {row[p]['bound_by']})"
        for p in ("fwd", "dx", "dw") if p in row
    )
    print(f"  {label:>9} K={K:<3} {cin:>3}->{cout:<3} rows {n_in:>5}->{n_out:<5}  "
          f"bf16/plain/f32 {parts}")
    return row


def bf16_sums(rows, tag):
    """Phase 28's per-part sums over one step: bf16 kernel, plain, float32
    kernel and bound ms."""
    for p, name in (("fwd", "K1 forward"), ("dx", "K1 input gradient"), ("dw", "K2 weight gradient")):
        parts = [r[p] for r in rows if p in r]
        print(f"  {tag}, sum over one step, {name}: bf16 {sum(q['ms'] for q in parts):.3f} ms, "
              f"plain {sum(q['plain_ms'] for q in parts):.3f} ms, float32 instance "
              f"{sum(q['f32_ms'] for q in parts):.3f} ms, bf16 bound "
              f"{sum(q['bound_ms'] for q in parts):.4f} ms")


def bf16_step_record(loss, net):
    """(loss, float64 gradients, float64 running statistics) of a step, on the host."""
    return (
        loss.item(),
        {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()},
        {k: v.double().cpu() for k, v in net.state_dict().items() if "running" in k},
    )


def judge_bf16(tag, card, cpu16, cpu64):
    """A bf16 step on the card against the float64 run of the same step,
    held to GRAD_FACTOR times what bf16 costs the CPU plain path's bf16 run
    of it (per tensor, or the median tensor where that one rounds better);
    the loss to GRAD_FACTOR times the CPU bf16 loss's distance, or 1e-4."""
    def rels(a, b):
        return {k: rel_diff(a[k], b[k]) for k in b}

    loss_ref = abs(cpu64[0])
    card_loss, cpu_loss = abs(card[0] - cpu64[0]) / loss_ref, abs(cpu16[0] - cpu64[0]) / loss_ref
    ok = card_loss <= GRAD_FACTOR * max(cpu_loss, 1e-4)
    print(f"  loss {card[0]:.6f} (card bf16) vs {cpu16[0]:.6f} (CPU bf16), {cpu64[0]:.6f} "
          f"(CPU float64): rel {card_loss:.2e} (card), {cpu_loss:.2e} (CPU bf16)")
    for what, i in (("gradients", 1), ("running stats", 2)):
        card_err, cpu_err = rels(card[i], cpu64[i]), rels(cpu16[i], cpu64[i])
        vs_cpu = rels(card[i], cpu16[i])
        med = median(cpu_err)
        tight = max(card_err, key=lambda k: card_err[k] / max(cpu_err[k], med))
        bnd = GRAD_FACTOR * max(cpu_err[tight], med)
        print(f"  {len(card_err)} {what} against float64: card median {median(card_err):.2e}, "
              f"CPU bf16 median {med:.2e}; card vs CPU bf16 median {median(vs_cpu):.2e}; closest "
              f"to its bound: {tight} card {card_err[tight]:.2e}, bound {bnd:.2e}")
        ok = ok and card_err[tight] <= bnd
    if not ok:
        raise AssertionError(f"{tag}: the bf16 step disagrees with the CPU plain path")


def bf16_path(dev, launches, reuse):
    """Phases 28-32: the bf16 compute path (``set_compute_dtype``): the bf16
    instances of K1 and K2 on the real maps of a MinkUNet34 and a
    MinkowskiFCNN training step, MinkUNet34 inference and training, an FCNN
    training step, and ``MinkowskiSyncBatchNorm`` on a one-rank NCCL group.
    Returns phase 28's rows."""
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    MT.set_compute_dtype(torch.bfloat16)
    init, raw, labels = reuse["unet_init"], reuse["raw"], reuse["labels"]

    def unet(device, train=True):
        net = MinkUNet34(3, 20, D=3, device=device)
        net.load_state_dict(init)
        return net.train(train)

    # 28. the bf16 instances on the real maps of one training step of each net
    steps = bf16_step_calls(dev, reuse)
    print(f"[28 bf16 kernels, MinkUNet34 training-step maps] {len(steps['MinkUNet34'])} conv calls; "
          f"bf16 / plain / float32-instance ms, bound max(2 * pairs * Cin * Cout / "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16, bytes / {HBM_RATE / 1e12:.2f} TB/s)")
    unet_rows = [bf16_rows(*call) for call in steps["MinkUNet34"]]
    bf16_sums(unet_rows, "MinkUNet34")
    print(f"[28 bf16 kernels, MinkowskiFCNN training-step maps] {len(steps['MinkowskiFCNN'])} "
          "conv calls")
    fcnn_rows = [bf16_rows(*call) for call in steps["MinkowskiFCNN"]]
    bf16_sums(fcnn_rows, "MinkowskiFCNN")
    del steps

    # 29. inference on one scan in bf16, against the CPU plain path in bf16
    # and the card's float32 answer
    coords0, feats0 = reuse["request"]
    net = unet(dev, train=False)
    answer(net, coords0, feats0, dev)  # warm-up
    (logits, secs), n = counted(launches, lambda: answer(net, coords0, feats0, dev))
    if (logits.dtype != torch.bfloat16 or logits.shape != (len(coords0), 20)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bf16 logits: {logits.dtype}, {tuple(logits.shape)}")
    if n["gather_gemm_bf16"] < MIN_LAUNCHES or n["gather_gemm"] or n["conv_dw"] or n["conv_dw_bf16"]:
        raise AssertionError(f"bf16 inference launched {n}")
    MT.set_compute_dtype(None)
    card32, _ = answer(net, coords0, feats0, dev)
    cpu_net = unet("cpu", train=False)
    x_cpu = MT.SparseTensor(torch.from_numpy(feats0), torch.from_numpy(coords0))
    with torch.no_grad():
        cpu32 = cpu_net(x_cpu).F
        MT.set_compute_dtype(torch.bfloat16)
        cpu16 = cpu_net(MT.SparseTensor(torch.from_numpy(feats0), torch.from_numpy(coords0))).F
    del cpu_net, net
    # the bf16 path's own rounding cost on the CPU sets the scale: the card
    # rounds the same sums in another order
    tol = 2 * max(rel_diff(cpu16.double(), cpu32.double()), K1_BF16_RTOL)
    vs_cpu = rel_diff(logits.double(), cpu16.double())
    vs_f32 = rel_diff(logits.double(), card32.double())
    print(f"[29 bf16 inference] {len(coords0)} voxels, {secs * 1e3:.2f} ms, "
          f"{len(coords0) / secs:.0f} points/s, {n['gather_gemm_bf16']} bf16 gather_gemm launches; "
          f"logits vs CPU bf16 {vs_cpu:.2e}, vs card float32 {vs_f32:.2e}; CPU bf16 vs CPU "
          f"float32 {rel_diff(cpu16.double(), cpu32.double()):.2e}; tolerance {tol:.2e}")
    if not (vs_cpu <= tol and vs_f32 <= tol):
        raise AssertionError(f"bf16 logits disagree: {vs_cpu:.3e}, {vs_f32:.3e} > {tol:.3e}")

    # 30. training in bf16: a warm-up step on phase 9's batch 0, then three
    # timed steps on its batches 1-3
    net = unet(dev)
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    torch.cuda.reset_peak_memory_stats()
    for step, (scans, lab) in enumerate(zip(raw, labels)):
        def one_step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coords, feats = collate(scans)
            loss, out = train_step(net, opt, coords, feats, lab, dev)
            record = bf16_step_record(loss, net) if step == 0 else None
            opt.step()
            torch.cuda.synchronize()
            return loss.item(), out.F.dtype, len(coords), record, time.perf_counter() - t0

        (loss, dtype, n_vox, record, secs), n = counted(launches, one_step)
        bodies = (dict(gather_gemm.bf16_body_launches), dict(conv_dw.bf16_body_launches))
        if step == 0:
            card0 = record
        print(f"[30 bf16 train] step {step}{' (warm-up)' if step == 0 else ''}: {n_vox} voxels, "
              f"{secs * 1e3:.2f} ms, {n_vox / secs:.0f} points/s, loss {loss:.6f}, "
              f"{n['gather_gemm_bf16']} bf16 gather_gemm and {n['conv_dw_bf16']} bf16 conv_dw "
              f"launches, float32 instances {n['gather_gemm']} and {n['conv_dw']}; by body "
              f"{bodies[0]} and {bodies[1]}")
        if (n["gather_gemm_bf16"], n["conv_dw_bf16"], n["gather_gemm"], n["conv_dw"]) != (
                MIN_LAUNCHES + MIN_DX_LAUNCHES, MIN_LAUNCHES, 0, 0):
            raise AssertionError(f"step {step}: {n} launches")
        # every call but the stem's (Cin = 3) on the wgmma bodies
        if (bodies[0]["wgmma"], bodies[0]["simt"], bodies[1]["wgmma"], bodies[1]["stem_mma"]) != (
                MIN_LAUNCHES - 1 + MIN_DX_LAUNCHES, 1, MIN_LAUNCHES - 1, 1):
            raise AssertionError(f"step {step}: launches by body {bodies}")
        if dtype != torch.bfloat16 or not np.isfinite(loss):
            raise AssertionError(f"step {step}: logits {dtype}, loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.2f} GiB (bf16) against "
          f"{reuse['unet_peak'] / 2**30:.2f} GiB (float32, phase 9)")
    del net, opt
    cpu_net = unet("cpu")
    c0, f0 = collate(raw[0])
    t0 = time.perf_counter()
    loss, _ = train_step(cpu_net, None, c0, f0, labels[0], "cpu")
    cpu16 = bf16_step_record(loss, cpu_net)
    print(f"[30 parity] CPU plain-path bf16 step, {len(c0)} voxels: {time.perf_counter() - t0:.1f} s")
    del cpu_net
    judge_bf16("30 parity", card0, cpu16, reuse["unet_cpu"][torch.float64])
    unet_cpu16 = reuse["unet_cpu16"] = cpu16

    # 31. MinkowskiFCNN: one bf16 training step on phase 13's first batch,
    # dropout off; its global pools and linears run in bf16
    def fcnn_bf16(device):
        net = MinkowskiFCNN(3, CLASSES, device=device, **FCNN_WIDTHS).train()
        net.load_state_dict(reuse["fcnn_init"])
        set_dropout(net, False)
        return net

    net = fcnn_bf16(dev)
    pooled = []
    hooks = [m.register_forward_hook(lambda m, a, o: pooled.append(o.F.dtype))
             for m in (net.global_max_pool, net.global_avg_pool, net.final[3])]
    fcnn_step(net, *reuse["shape_batch"], dev)  # warm-up; then the initial state again
    net.load_state_dict(reuse["fcnn_init"])
    net.zero_grad(set_to_none=True)
    pooled.clear()

    def step31():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, logits = fcnn_step(net, *reuse["shape_batch"], dev)
        record = bf16_step_record(loss, net)
        torch.cuda.synchronize()
        return record, logits.dtype, time.perf_counter() - t0

    (card, dtype, secs), n = counted(launches, step31)
    for h in hooks:
        h.remove()
    n_points = len(reuse["shape_batch"][0])
    print(f"[31 bf16 FCNN step] {n_points} points, {secs * 1e3:.2f} ms, {n_points / secs:.0f} "
          f"points/s, loss {card[0]:.6f}; global max, global average and final linear outputs "
          f"{sorted({str(d) for d in pooled})}; {n['gather_gemm_bf16']} bf16 gather_gemm and "
          f"{n['conv_dw_bf16']} bf16 conv_dw launches")
    if dtype != torch.bfloat16 or set(pooled) != {torch.bfloat16}:
        raise AssertionError(f"FCNN bf16: logits {dtype}, pools and linear {pooled}")
    if (n["gather_gemm_bf16"] < 2 * FCNN_CONVS or n["conv_dw_bf16"] != FCNN_CONVS
            or n["gather_gemm"] or n["conv_dw"]):
        raise AssertionError(f"FCNN bf16 step: {n} launches")
    bodies = (dict(gather_gemm.bf16_body_launches), dict(conv_dw.bf16_body_launches))
    print(f"  launches by body {bodies[0]} and {bodies[1]}")
    if (bodies[0]["wgmma"], bodies[1]["wgmma"]) != (n["gather_gemm_bf16"], FCNN_CONVS):
        raise AssertionError(f"FCNN bf16 step: launches by body {bodies}")  # Cin >= 32 throughout
    del net
    cpu_net = fcnn_bf16("cpu")
    coords, feats, lab = reuse["shape_batch"]
    loss, _ = fcnn_step(cpu_net, coords, torch.from_numpy(feats), lab, "cpu")
    judge_bf16("31 parity", card, bf16_step_record(loss, cpu_net),
               reuse["fcnn_cpu"][torch.float64])
    del cpu_net

    # 32. MinkowskiSyncBatchNorm on a one-rank NCCL group: MinkUNet34 through
    # convert_sync_batchnorm, one bf16 step on batch 0, in the group and
    # outside any group
    def sync_step():
        net = unet(dev)
        MinkowskiSyncBatchNorm.convert_sync_batchnorm(net)
        coords, feats = collate(raw[0])
        loss, _ = train_step(net, None, coords, feats, labels[0], dev)
        return bf16_step_record(loss, net), sum(
            isinstance(m, MinkowskiSyncBatchNorm) for m in net.modules())

    (alone, n_sync), n_alone = counted(launches, sync_step)
    store = tempfile.mkdtemp()
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
        device_id=torch.device(dev),
    )
    try:
        before = MinkowskiSyncBatchNorm.all_reduces
        (grouped, _), n_group = counted(launches, sync_step)
        torch.cuda.synchronize()
        all_reduces = MinkowskiSyncBatchNorm.all_reduces - before
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    same = grouped[0] == alone[0] and all(
        torch.equal(grouped[i][k], alone[i][k]) for i in (1, 2) for k in alone[i])
    print(f"[32 sync batch norm] {n_sync} sync batch norms, {all_reduces} NCCL all-reduces in the "
          f"one-rank group's step (forward and backward), launches {n_group}; loss "
          f"{grouped[0]:.6f} in the group, {alone[0]:.6f} outside: loss, {len(alone[1])} gradients "
          f"and {len(alone[2])} running stats bit-equal: {same}")
    if not same or all_reduces != 2 * n_sync:
        raise AssertionError(f"sync batch norm: bit-equal {same}, {all_reduces} all-reduces")
    if (n_group["gather_gemm_bf16"], n_group["conv_dw_bf16"]) != (
            MIN_LAUNCHES + MIN_DX_LAUNCHES, MIN_LAUNCHES) or n_group != n_alone:
        raise AssertionError(f"sync batch norm step launches: {n_group}, {n_alone}")
    print("  against the plain batch norm's bf16 step (phase 30), card vs card: loss "
          f"{abs(grouped[0] - card0[0]) / abs(card0[0]):.2e}, gradients median "
          f"{median({k: rel_diff(grouped[1][k], card0[1][k]) for k in card0[1]}):.2e}; both held "
          "to the float64 run:")
    judge_bf16("32 sync vs plain", grouped, unet_cpu16, reuse["unet_cpu"][torch.float64])
    MT.set_compute_dtype(None)
    print(f"[28-32] {time.perf_counter() - start:.1f} s")
    return unet_rows + fcnn_rows


# the coordinate manager's building calls, timed in an eager forward
COORDINATE_CALLS = (
    "insert_and_map", "stride", "stride_region", "origin", "origin_map", "kernel_map",
    "stride_map", "merge", "dense_plan",
)
# phase 33's batches: two to warm the replayer, six fresh ones
WARM_SEEDS, FRESH_SEEDS = (100, 102), (104, 106, 108, 110, 112, 114)


class SyncCount:
    """Host syncs inside the block, by torch's sync debug mode ("warn")."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.n = sum("synchronizing" in str(w.message) for w in self._caught)


class CoordinateClock:
    """Host ms and host syncs inside the manager's building calls during an
    eager forward: each outermost call starts on an idle card and ends
    with a synchronize, so its time is the coordinate work alone."""

    def __init__(self):
        self.ms, self.syncs, self._depth = 0.0, 0, 0

    def __enter__(self):
        self._saved = {n: getattr(MT.CoordinateManager, n) for n in COORDINATE_CALLS}
        for name, fn in self._saved.items():
            setattr(MT.CoordinateManager, name, self._timed(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(MT.CoordinateManager, name, fn)

    def _timed(self, fn):
        def call(*args, **kw):
            if self._depth:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            self._depth += 1
            t0 = time.perf_counter()
            try:
                with SyncCount() as count:
                    out = fn(*args, **kw)
                torch.cuda.synchronize()
                return out
            finally:
                self._depth -= 1
                self.ms += (time.perf_counter() - t0) * 1e3
                self.syncs += count.n
        return call


def host_phase(fn):
    """(fn's result, host ms from an idle card to the end of its device
    work, host syncs it made)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SyncCount() as count:
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, count.n


def same_geometry(tag, got, want):
    """A Geometry against an eager manager: the same keys, and coordinates,
    packed keys, kernel maps and stride maps bit-equal, index for index."""
    bad = []
    if list(got.maps) != list(want._maps) or set(got.kernel_maps) != set(want._kernel_maps):
        bad.append("keys")
    else:
        bad += [k for k, m in want._maps.items() if not (
            torch.equal(got.maps[k].coordinates, m.coordinates)
            and torch.equal(got.maps[k].keys, m.keys))]
        bad += [k[:2] for k, km in want._kernel_maps.items() if not (
            torch.equal(got.kernel_maps[k].in_idx, km.in_idx)
            and torch.equal(got.kernel_maps[k].out_idx_t, km.out_idx_t))]
        bad += [k for k, sm in want._stride_maps.items()
                if not torch.equal(got.stride_maps[k], sm)]
    if bad:
        raise AssertionError(f"{tag}: geometry differs from the eager manager's at {bad}")


def fresh_geometry(dev, launches, reuse):
    """Phases 33-35: geometry replay and training on fresh geometry."""
    start = time.perf_counter()
    init, raw, labels = reuse["unet_init"], reuse["raw"], reuse["labels"]

    def unet(train):
        return unet_from(init, dev, train)

    def on_card(scans):
        coords, feats = collate(scans)
        return coords.to(dev), feats.to(dev)

    # 33. record, warm, then six fresh batches in every mode
    recorder = unet(False)
    coords, feats = on_card(raw[0])
    x = MT.SparseTensor(feats, coords)
    with torch.no_grad():
        recorder(x)
    log = x.coordinate_manager.oplog()
    kinds = {k: [e[0] for e in log].count(k) for k in dict.fromkeys(e[0] for e in log)}
    replayer = MT.GeometryReplayer(x.coordinate_manager)
    for s in WARM_SEEDS:
        replayer(on_card([scan(s), scan(s + 1)])[0])
    compiled = MT.CompiledReplayer(x.coordinate_manager).adopt(replayer)
    print(f"[33 fresh-geometry replay] oplog of {len(log)} entries {kinds} on {len(coords)} "
          f"voxels; floors after {len(WARM_SEEDS)} warm batches: "
          f"{ {k[0][0]: v for k, v in replayer.cap_floors.items() if k[0] != 'kmax'} }")
    batch = on_card([scan(WARM_SEEDS[0]), scan(WARM_SEEDS[0] + 1)])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    geo, _, _ = compiled.run(*batch)  # the capture
    del geo, batch
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - held) / 2**20
    modes = {m: ([], []) for m in ("eager", "sync", "deferred", "compiled")}
    fresh = [on_card([scan(s), scan(s + 1)]) for s in FRESH_SEEDS]
    for i, (c, f) in enumerate(fresh):
        clock = CoordinateClock()
        with clock:
            x = MT.SparseTensor(f, c)
            with torch.no_grad():
                recorder(x)
        eager = x.coordinate_manager
        modes["eager"][0].append(clock.ms)
        modes["eager"][1].append(clock.syncs)
        runs = {
            "sync": lambda: MT.CoordinateManager.replay(log, c, deferred=False).export_geometry(),
            "deferred": lambda: replayer(c).export_geometry(),
            "compiled": lambda: compiled.run(c, f),
        }
        for mode, fn in runs.items():
            out, ms, syncs = host_phase(fn)
            if mode == "compiled":
                geo, fp, ok = out
                if not ok or fp.shape != (len(c), 3):
                    raise AssertionError(f"batch {i}: compiled replay ok {ok}")
            else:
                geo = out
            same_geometry(f"33 batch {i} {mode}", geo, eager)
            modes[mode][0].append(ms)
            modes[mode][1].append(syncs)
        print(f"  batch {i}: {len(c)} voxels; host ms / syncs: " + ", ".join(
            f"{m} {v[0][-1]:.2f} / {v[1][-1]}" for m, v in modes.items()))
        del x, eager
    graph = next(iter(compiled._graphs.values())).graph
    print("  median host ms of the coordinate phase: " + ", ".join(
        f"{m} {median(dict(enumerate(v[0]))):.2f}" for m, v in modes.items())
        + f"; graphs captured {compiled.captures}, recoveries {compiled.recoveries}; the "
        f"graph's replay alone {cuda_ms(graph.replay):.3f} ms (CUDA events); the graph and its "
        f"static inputs hold {held:.1f} MiB")
    if modes["compiled"][1] != [1] * len(fresh) or compiled.recoveries or compiled.captures != 1:
        raise AssertionError(f"compiled replay: syncs {modes['compiled'][1]}, captures "
                             f"{compiled.captures}, recoveries {compiled.recoveries}")
    del recorder

    # 34. four SGD steps on phase 9's batches, eager and through the graph;
    # the gradients are compared on the host, so neither peak holds them
    def host_grads(net):
        return {k: p.grad.detach().cpu() for k, p in net.named_parameters()}

    def eager_steps():
        net = unet(True)
        opt = torch.optim.SGD(net.parameters(), lr=LR)
        out = []
        for scans, lab in zip(raw, labels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coords, feats = collate(scans)
            loss, _ = train_step(net, opt, coords, feats, lab, dev)
            opt.step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            out.append((loss.item(), host_grads(net), secs * 1e3))
        return out

    def compiled_steps():
        net = unet(True)
        opt = torch.optim.SGD(net.parameters(), lr=LR)
        out = []
        for scans, lab in zip(raw, labels):
            fwd_dx, dw = gather_gemm.launches, conv_dw.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coords, feats = collate(scans)
            coords, feats = coords.to(dev), feats.to(dev)
            t1 = time.perf_counter()
            geo, fp, ok = compiled.run(coords, feats)
            if not ok:
                geo, fp = compiled.recover(coords, feats)
            t2 = time.perf_counter()
            view = MT.CoordinateManager.from_geometry(geo)
            out_t = net(MT.SparseTensor(fp, coordinate_map_key=geo.entry_key,
                                        coordinate_manager=view))
            loss = torch.nn.functional.cross_entropy(out_t.F.float(), lab.to(dev))
            opt.zero_grad()
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = (gather_gemm.launches - fwd_dx, conv_dw.launches - dw)
            if out_t.F.shape != (len(coords), 20) or len(view._maps) != len(geo.maps):
                raise AssertionError(f"compiled step: logits {tuple(out_t.F.shape)}")
            out.append((loss.item(), host_grads(net), secs * 1e3, (t2 - t1) * 1e3, n))
        return out

    torch.cuda.reset_peak_memory_stats()
    eager = eager_steps()
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    steps = compiled_steps()
    take_launches(launches)
    peak = torch.cuda.max_memory_allocated()
    for i, ((loss_e, grads_e, ms_e), (loss_c, grads_c, ms_c, coord_ms, n)) in enumerate(
            zip(eager, steps)):
        same = loss_e == loss_c and all(torch.equal(grads_c[k], g) for k, g in grads_e.items())
        print(f"[34 fresh-geometry training] step {i}: loss {loss_c:.6f} (eager {loss_e:.6f}), "
              f"{len(grads_e)} gradients bit-equal: {same}; {ms_c:.2f} ms (replay {coord_ms:.2f} "
              f"ms of it) vs eager {ms_e:.2f} ms; {n[0]} gather_gemm and {n[1]} conv_dw launches")
        if not same or n != (MIN_LAUNCHES + MIN_DX_LAUNCHES, MIN_LAUNCHES):
            raise AssertionError(f"fresh-geometry step {i}: bit-equal {same}, launches {n}")
    print(f"  peak device memory: compiled steps {peak / 2**30:.2f} GiB, eager steps "
          f"{eager_peak / 2**30:.2f} GiB; graphs captured {compiled.captures}, recoveries "
          f"{compiled.recoveries}")
    if compiled.recoveries:
        raise AssertionError(f"{compiled.recoveries} recoveries after warm-up")
    del eager

    # 35. a strided level's floor below its count, at the same bucket
    c, f = fresh[0]
    level = ((8, 8, 8), "")
    want = MT.CoordinateManager.replay(log, c, deferred=False)
    rows = want.size(MT.CoordinateMapKey(*level))
    low = MT.GeometryReplayer(want)
    low.cap_floors = dict(replayer.cap_floors)
    low.cap_floors[level] = rows // 2
    compiled.adopt(low)
    version, captures = compiled._version, compiled.captures
    _, _, ok = compiled.run(c, f)
    geo, _ = compiled.recover(c, f)
    ratcheted = compiled.cap_floors[level]
    geo2, _, ok2 = compiled.run(c, f)
    print(f"[35 floor violation] level {level[0]}: {rows} rows, floor lowered to {rows // 2}: ok "
          f"{ok}; recover ratchets it to {ratcheted}, version {version} -> {compiled._version}, "
          f"graphs captured {captures} -> {compiled.captures}; rerun ok {ok2}")
    if ok or not ok2 or ratcheted < rows or compiled._version <= version or (
            compiled.captures != captures + 2):
        raise AssertionError("floor violation: no recovery")
    same_geometry("35 recover", geo, want)
    same_geometry("35 rerun", geo2, want)
    print(f"[33-35] {time.perf_counter() - start:.1f} s")
    return dict(compiled=compiled, steps=steps, fresh=fresh[:PARALLEL_WORLD])


# phases 36-37: the parallel package.  Two ranks share the one card over
# gloo (NCCL refuses two ranks on one device); 1e-5 of max|g| for the
# data-parallel gradients (the mean of the same two float32 sums, taken by
# gloo), 1e-4 for the spatial run's output and the column-parallel logits.
# The spatial run's gradients (eval mode: K2's dW and batch norm's affine
# gradients split over the ranks and added again, another order) are not
# held to the single process's: a pre-activation within ~1e-7 of 0 takes
# either side of its ReLU's kink with the order of a sum, and the one
# element's gradient then moves a leaf by 1e-4-1e-2 of itself (on some
# scans the card's own runs and the CPU's float32 run each do).  The single
# process's and each rank's are judged against CPU float64 runs that take
# the same side of every kink (``relu_masks``, ``eval_grads_judged``).  The
# column-parallel step is in train mode, where the input gradient's sum,
# split by Cout and all-reduced, changes order inside batch norm's
# ill-conditioned backward: its parameters after the step are held within
# 1e-4 of the model's largest parameter, as JAX's tensor-parallel test
# holds them absolutely, which alone would pass a gradient error under
# ~1e-2 at LR; what decides its gradients is judge_step, each against the
# CPU's float64 run, as phase 10 holds the unsharded step's
PARALLEL_WORLD = 2
DDP_RTOL, SHARDED_RTOL = 1e-5, 1e-4
TRANSPORT = ("gloo over TCP on localhost, two processes on cuda:0; gloo takes the CUDA "
             "tensors and copies them through host memory itself")


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def counts_since(before):
    return {k: v - before[k] for k, v in counts_now().items()}


def worst(errors):
    k = max(errors, key=errors.get)
    return k, errors[k]


def sum_of_squares(net, x):
    """Forward, then the backward of sum(out^2); returns the output."""
    y = net(x)
    (y.F.double() ** 2).sum().backward()
    return y


@contextlib.contextmanager
def relu_masks(held=None):
    """Every ``MinkowskiReLU`` call inside, in call order: without ``held``,
    record each call's mask (input > 0); with ``held``, apply the given
    masks in place of the call's own (x * mask: the gradient passes where
    the mask is 1), so that a run takes another run's side of each ReLU's
    kink.  Yields the masks; with ``held``, its ``flips`` attribute lists
    per call the elements whose own sign differs from the held mask and
    their largest |x| over the call's largest."""
    masks, real = HeldMasks(), MinkowskiReLU._fn

    def fn(self, x):
        own = x > 0
        if held is None:
            masks.append(own)
            return real(self, x)
        m = held[len(masks)].to(x.device)
        differ = own != m
        masks.append(m)
        masks.flips.append((int(differ.sum()), (x.abs()[differ].max() / x.abs().max()).item()
                            if differ.any() else 0.0))
        return x * m.to(x.dtype)

    MinkowskiReLU._fn = fn
    try:
        yield masks
    finally:
        MinkowskiReLU._fn = real


class HeldMasks(list):
    """``relu_masks``' masks, with the held run's flips."""

    def __init__(self):
        super().__init__()
        self.flips = []


def eval_grads_judged(tag, grads, cpu, ref=None):
    """Phase 37b: an eval-mode run's gradients against the CPU float64 run
    held to the same ReLU masks (``relu_masks``; ``cpu`` as ``cpu_steps``
    returns it).  Without ``ref``: the run's median and worst leaf within
    GRAD_FACTOR times the CPU float32 run's median and worst.  (The card's
    3xTF32 products round to ~2^-21 against float32's 2^-24: on this step
    it lies ~5x the CPU's distance at the median leaf and up to ~15x on a
    leaf the CPU happens to round well, the `mma.sync` bodies alike, so
    ``judge_grads``' leaf-by-leaf bound suits a train-mode step, where
    batch norm's statistics set both runs' distance.)  With ``ref``, the
    single process's distances on the same card: every leaf within
    GRAD_FACTOR times ref's (or ref's median): sharding adds no more than
    the rounding.  Prints; returns (passed, the run's distances)."""
    grads32, grads64 = cpu[torch.float32][1], cpu[torch.float64][1]
    card = {k: rel_diff(v.double(), grads64[k]) for k, v in grads.items()}
    cpu32 = {k: rel_diff(grads32[k], grads64[k]) for k in card}
    worst = max(card, key=card.get)
    print(f"  {tag}: {len(card)} gradients against float64, median {median(card):.2e}, worst "
          f"{worst} {card[worst]:.2e}; CPU float32 median {median(cpu32):.2e}, worst "
          f"{max(cpu32.values()):.2e}")
    if ref is None:
        return (median(card) <= GRAD_FACTOR * median(cpu32)
                and card[worst] <= GRAD_FACTOR * max(cpu32.values())), card
    bound = {k: GRAD_FACTOR * max(ref[k], median(ref)) for k in card}
    tight = max(card, key=lambda k: card[k] / bound[k])
    print(f"    against the single process's: closest to its bound {tight} {card[tight]:.2e}, "
          f"single process {ref[tight]:.2e}, bound {bound[tight]:.2e}")
    return card[tight] <= bound[tight], card


def rank_windows(km, xf, g, r):
    """What rank r of the spatial conv hands K1 and K2 on map ``km``, from
    the whole input rows ``xf`` and output gradient ``g``, as
    ``_SpatialConv`` builds it from the bands the other ranks send: the
    input window and the block's re-based ``in_idx``, the gradient's window
    and the block's re-based ``out_idx_t``, and the block of ``g``."""
    n = PARALLEL_WORLD
    halo_f, halo_b = spatial.required_halo(km, n)
    gather_all = halo_f > km.n_in // n or halo_b > km.n_out // n

    def window(full, n_rows, halo):
        if gather_all:  # the fallback's window: every row
            return full, 0
        lo, hi = spatial.block_bounds(n_rows, n, r)
        pad = full.new_zeros((halo, full.shape[1]))
        return torch.cat([pad, full, pad])[lo:hi + 2 * halo], lo - halo

    o_lo, o_hi = spatial.block_bounds(km.n_out, n, r)
    i_lo, i_hi = spatial.block_bounds(km.n_in, n, r)
    win, base = window(xf, km.n_in, halo_f)
    idx, _ = spatial._rebase(km.in_idx[:, o_lo:o_hi], base, win.shape[0])
    g_win, g_base = window(g, km.n_out, halo_b)
    idx_t, _ = spatial._rebase(km.out_idx_t[:, i_lo:i_hi], g_base, g_win.shape[0])
    return win, idx, g_win, idx_t, g[o_lo:o_hi].contiguous()


def rank_ddp(rank, dev, tmp):
    """Phase 37a on one rank: a data-parallel step on this rank's own batch."""
    ref = torch.load(f"{tmp}/ddp.pt")
    mesh = parallel.make_mesh(device=dev)
    net = unet_from(torch.load(f"{tmp}/init.pt"), dev, True)
    opt = torch.optim.SGD(net.parameters(), lr=LR)

    def loss_fn(model, coords, feats, lab):
        out = model(MT.SparseTensor(feats, coords))
        return torch.nn.functional.cross_entropy(out.F.float(), lab)

    step = parallel.make_data_parallel_step(net, opt, loss_fn, mesh)
    coords, feats, lab = (t.to(dev) for t in ref["batches"][rank])
    comm.reset_counts()
    before = counts_now()
    sync(dev)
    t0 = time.perf_counter()
    loss = step(net, opt, coords, feats, lab).item()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    n = counts_since(before)
    errors = {k: rel_diff(p.grad.double().cpu(), ref["grads"][k].double())
              for k, p in net.named_parameters()}
    return dict(ms=ms, loss=loss, want_loss=ref["loss"], worst=worst(errors), launches=n,
                comm=dict(comm.counts), rows=len(coords))


def rank_spatial(rank, dev, tmp):
    """Phase 37b on one rank: its row block of one scan through MinkUNet34
    in eval mode under spatial execution, forward and the backward of
    sum(out^2); writes its gradients and its ReLU masks (its block's rows)
    for the spawning process's judge."""
    ref = torch.load(f"{tmp}/spatial.pt")
    mesh = parallel.make_spatial_mesh(device=dev)
    net = unet_from(torch.load(f"{tmp}/init.pt"), dev, False)
    coords, feats = (t.to(dev) for t in ref["scan"])
    x = MT.SparseTensor(feats, coords)
    xs = parallel.shard_sparse_tensor(x, mesh)
    k1_rows, out_rows, dropped = [], [], []
    real_k1, real_conv = spatial.gather_gemm, spatial.spatial_conv_apply

    def k1(xw, w, idx):  # the rows each K1 call of this rank computes
        k1_rows.append(idx.shape[1])
        return real_k1(xw, w, idx)

    def conv(feats, kernel, kmap, **kw):  # each call's output map, and its dropped pairs
        out, d = real_conv(feats, kernel, kmap, **kw)
        out_rows.append(kmap.n_out)
        dropped.append(d)
        return out, d

    spatial.gather_gemm, spatial.spatial_conv_apply = k1, conv
    try:
        comm.reset_counts()
        before = counts_now()
        sync(dev)
        t0 = time.perf_counter()
        with relu_masks() as masks, MT.spatial_execution(mesh):
            y = sum_of_squares(net, xs)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        spatial.gather_gemm, spatial.spatial_conv_apply = real_k1, real_conv
    n = counts_since(before)
    collectives = dict(comm.counts)
    out = spatial.gather_rows(y.F.detach(), x.size, mesh)
    grads = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
    torch.save(dict(grads=grads, masks=[m.cpu() for m in masks]), f"{tmp}/spatial_grads{rank}.pt")
    errors = {k: rel_diff(g.double(), ref["grads"][k].double()) for k, g in grads.items()}
    mgr = x.coordinate_manager
    halos = {}
    for key, km in mgr._kernel_maps.items():
        hf, hb = spatial.required_halo(km, PARALLEL_WORLD)
        fell_back = hf > km.n_in // PARALLEL_WORLD or hb > km.n_out // PARALLEL_WORLD
        name = f"{key[0][0][0]}->{key[1][0][0]} k{km.kernel_volume}{' T' if key[6] else ''}"
        halos[name] = (hf, hb, km.n_in, km.n_out, fell_back)
    # this rank's block of every forward call's output map, and the whole maps
    blocks = sum(hi - lo for lo, hi in (spatial.block_bounds(n, PARALLEL_WORLD, rank)
                                        for n in out_rows))
    fwd_calls = len(out_rows)
    return dict(ms=ms, rel_out=rel_diff(out.double().cpu(), ref["out"].double()),
                worst=worst(errors), dropped=int(sum(int(d) for d in dropped)),
                k1_fwd_rows=sum(k1_rows[:fwd_calls]), block_rows=blocks, whole_rows=sum(out_rows),
                fwd_calls=fwd_calls, launches=n, comm=collectives, halos=halos,
                rows=len(coords))


def rank_tensor_parallel(rank, dev, tmp):
    """Phase 37c on one rank: MinkUNet34 column-parallel over the two ranks,
    forward and one SGD step on phase 9's batch 0."""
    from minkowskiengine_tpu_torch.utils.torch_import import export_reference_state_dict

    ref = torch.load(f"{tmp}/tp.pt")
    mesh = parallel.make_tp_mesh(PARALLEL_WORLD, device=dev)
    net = unet_from(torch.load(f"{tmp}/init.pt"), dev, True)
    parallel.apply_tensor_parallelism(net, mesh)
    cut = sum(hasattr(m, "column_parallel") for m in net.modules()
              if isinstance(m, MinkowskiConvolutionBase))
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    coords, feats, lab = (t.to(dev) for t in ref["batch"])
    comm.reset_counts()
    before = counts_now()
    sync(dev)
    t0 = time.perf_counter()
    out = net(MT.SparseTensor(feats, coords))
    loss = torch.nn.functional.cross_entropy(out.F.float(), lab)
    opt.zero_grad()
    loss.backward()
    opt.step()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    n = counts_since(before)
    collectives = dict(comm.counts)
    after = export_reference_state_dict(net)
    scale = max(v.abs().max().item() for v in ref["after"].values())
    moved = {k: (torch.from_numpy(v).double() - ref["after"][k].double()).abs().max().item()
             for k, v in after.items()}
    # every cut gradient gathered whole, for phase 10's judge
    grads = {k: p.grad.detach() for k, p in net.named_parameters()}
    for name, m in net.named_modules():
        cp = getattr(m, "column_parallel", None)
        for path, dim in (cp.sharded if cp is not None else ()):
            grads[f"{name}.{path}"] = cp.whole(grads[f"{name}.{path}"], dim)
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    first = flat.clone()
    torch.distributed.broadcast(first, src=0)
    if rank == 0:
        torch.save(dict(loss=loss.item(), grads={k: g.cpu() for k, g in grads.items()},
                        stats={k: v.detach().double().cpu() for k, v in net.state_dict().items()
                               if "running" in k}), f"{tmp}/tp_step.pt")
    return dict(ms=ms, loss=loss.item(), want_loss=ref["loss"],
                rel_out=rel_diff(out.F.detach().double().cpu(), ref["out"].double()),
                moved=worst(moved), scale=scale, same_grads=bool(torch.equal(flat, first)),
                launches=n, comm=collectives, cut=cut, rows=len(coords))


def rank_main(rank, world, tmp, dev):
    """One rank of phase 37: the three parallel runs on the shared card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                         world_size=world)
    try:
        probe = torch.full((4,), float(rank + 1), device=dev)
        gathered = [torch.empty_like(probe) for _ in range(world)]
        torch.distributed.all_gather(gathered, probe)
        torch.distributed.all_reduce(probe)
        ok = probe.device.type == torch.device(dev).type and float(probe[0]) == world * (world + 1) / 2
        res = dict(probe=ok and all(g.device == probe.device for g in gathered))
        for name, fn in (("ddp", rank_ddp), ("spatial", rank_spatial),
                         ("tensor_parallel", rank_tensor_parallel)):
            res[name] = fn(rank, dev, tmp)
        torch.save(res, f"{tmp}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def parallel_path(dev, launches, reuse, fresh):
    """Phases 36-37: the parallel package on the card."""
    start = time.perf_counter()
    init, raw, labels = reuse["unet_init"], reuse["raw"], reuse["labels"]
    compiled, steps34 = fresh["compiled"], fresh["steps"]

    # 36. the per-device-geometry step on a one-rank NCCL group, against phase 34
    store = tempfile.mkdtemp()
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
        device_id=torch.device(dev),
    )
    try:
        mesh = parallel.make_mesh(device=dev)
        net = unet_from(init, dev, True)
        opt = torch.optim.SGD(net.parameters(), lr=LR)

        def loss_fn(model, geo, feats, lab):
            view = MT.CoordinateManager.from_geometry(geo)
            out = model(MT.SparseTensor(feats, coordinate_map_key=geo.entry_key,
                                        coordinate_manager=view))
            return torch.nn.functional.cross_entropy(out.F.float(), lab)

        step = parallel.make_per_device_geometry_step(net, opt, loss_fn, mesh)
        record = dict(phase=36, backend="nccl", world=1, step_ms=[], phase34_step_ms=[],
                      collectives_per_step=[], bit_equal=[])
        zero_counts()
        for i, (scans, lab) in enumerate(zip(raw, labels)):
            fwd_dx, dw = gather_gemm.launches, conv_dw.launches
            comm.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coords, feats = collate(scans)
            coords, feats = coords.to(dev), feats.to(dev)
            geo, fp, ok = compiled.run(coords, feats)
            if not ok:
                geo, fp = compiled.recover(coords, feats)
            geo = parallel.shard_batch(MT.stack_geometries([geo]), mesh)
            loss = step(net, opt, geo, fp, lab.to(dev)).item()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = (gather_gemm.launches - fwd_dx, conv_dw.launches - dw)
            loss34, grads34, ms34 = steps34[i][:3]
            same = loss == loss34 and all(
                torch.equal(p.grad.detach().cpu(), grads34[k]) for k, p in net.named_parameters())
            print(f"[36 DDP on fresh geometry, one NCCL rank] step {i}: loss {loss:.6f}, "
                  f"{len(grads34)} gradients and the loss bit-equal to phase 34's: {same}; "
                  f"{ms:.2f} ms against {ms34:.2f} ms in phase 34 (no wrapper); "
                  f"{comm.counts['all_reduce']} all-reduce of {comm.counts['bytes']:,} bytes "
                  f"(every gradient and the loss); {n[0]} gather_gemm and {n[1]} conv_dw launches")
            if not same or n != (MIN_LAUNCHES + MIN_DX_LAUNCHES, MIN_LAUNCHES) or (
                    comm.counts["all_reduce"] != 1):
                raise AssertionError(f"one-rank DDP step {i}: bit-equal {same}, launches {n}")
            record["step_ms"].append(ms)
            record["phase34_step_ms"].append(ms34)
            record["collectives_per_step"].append(dict(comm.counts))
            record["bit_equal"].append(same)
        record["launches"] = take_launches(launches)
        print(json.dumps(record))
        del net, opt, step
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # 37. references on this process, then two ranks on the card over gloo;
    # every K1/K2 call of the ranks' windows and Cout slices, at this
    # process's shapes, held against its plain version: (abs, rel) errors
    par_errs = dict(gather_gemm=[], conv_dw=[])
    tmp = tempfile.mkdtemp()
    try:
        torch.save(init, f"{tmp}/init.pt")
        ddp_batches, ddp_grads, ddp_losses = [], [], []
        for r, (c, f) in enumerate(fresh["fresh"]):
            lab = labels_for(100 + r, len(c))
            net = unet_from(init, dev, True)
            loss, _ = train_step(net, None, c, f, lab, dev)
            ddp_losses.append(loss.item())
            ddp_grads.append({k: p.grad.detach() for k, p in net.named_parameters()})
            ddp_batches.append((c.cpu(), f.cpu(), lab))
        mean = {k: ((ddp_grads[0][k] + ddp_grads[1][k]) / 2).cpu() for k in ddp_grads[0]}
        torch.save(dict(batches=ddp_batches, grads=mean,
                        loss=sum(ddp_losses) / PARALLEL_WORLD), f"{tmp}/ddp.pt")
        del ddp_grads, mean

        # the spatial reference: one scan, eval mode, sum(out^2); per-rank K1
        # and K2 times on rank 0's windows against the whole maps' calls
        coords0, feats0 = reuse["request"]
        net = unet_from(init, dev, False)
        x = MT.SparseTensor(torch.from_numpy(feats0).to(dev), torch.from_numpy(coords0).to(dev))
        with relu_masks() as sp_masks:
            calls, grads, y = capture_step(sparse_convs(net), lambda: sum_of_squares(net, x))
        sp_masks = [m.cpu() for m in sp_masks]
        sp_grads = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
        torch.save(dict(scan=(x.C.cpu(), x.F.cpu()), out=y.F.detach().cpu(), grads=sp_grads),
                   f"{tmp}/spatial.pt")
        sp_flips = []

        def cpu_spatial(masks, tag):
            """The same on the CPU plain path in float32 and float64, each
            ReLU on the side of its kink that ``masks`` took."""
            def run(dtype):
                cpu_net = unet_from(init, "cpu", False).to(dtype)
                with relu_masks(masks) as held:
                    y = sum_of_squares(cpu_net, MT.SparseTensor(
                        torch.from_numpy(feats0).to(dtype), torch.from_numpy(coords0)))
                sp_flips.append((f"{tag}, CPU {dtype}", held.flips))
                return (y.F.double() ** 2).sum(), cpu_net, len(coords0)
            return cpu_steps(run, f"37b, the single process's ReLU masks" if tag == "single"
                             else "37b, the ranks' ReLU masks", "voxels")

        sp_cpu = cpu_spatial(sp_masks, "single")
        sp_ms = dict(k1=0.0, k1_rank=0.0, k2=0.0, k2_rank=0.0)
        for i, (m, inp, o) in enumerate(calls):
            km = m._kernel_map(inp, o.coordinate_map_key)
            w = m.kernel.detach()
            xf, g = inp.F.detach(), grads[i].contiguous()
            for r in range(PARALLEL_WORLD):
                win, idx, g_win, idx_t, g_blk = rank_windows(km, xf, g, r)
                tag = f"37b call {i} rank {r}"
                par_errs["gather_gemm"].append(agree(gather_gemm, gather_gemm_reference,
                                                    (win, w, idx), KERNEL_RTOL, tag))
                par_errs["gather_gemm"].append(agree(
                    gather_gemm, gather_gemm_reference,
                    (g_win, w.transpose(1, 2).contiguous(), idx_t), KERNEL_RTOL, tag + " dX"))
                par_errs["conv_dw"].append(agree(conv_dw, conv_dw_reference, (win, g_blk, idx),
                                                DW_RTOL, tag + " dW"))
                if r == 0:
                    sp_ms["k1_rank"] += cuda_ms(lambda: gather_gemm(win, w, idx))
                    sp_ms["k2_rank"] += cuda_ms(lambda: conv_dw(win, g_blk, idx))
            sp_ms["k1"] += cuda_ms(lambda: gather_gemm(xf, w, km.in_idx))
            sp_ms["k2"] += cuda_ms(lambda: conv_dw(xf, g, km.in_idx))
        del calls, grads, net, y, x

        # the column-parallel reference: phase 9's batch 0, one SGD step;
        # per-rank K1 and K2 times on rank 0's Cout slice
        from minkowskiengine_tpu_torch.utils.torch_import import export_reference_state_dict

        coords, feats = collate(raw[0])
        net = unet_from(init, dev, True)
        opt = torch.optim.SGD(net.parameters(), lr=LR)
        calls, grads, (loss, out) = capture_step(
            sparse_convs(net), lambda: train_step(net, opt, coords, feats, labels[0], dev))
        opt.step()
        torch.save(dict(batch=(coords, feats, labels[0]), loss=loss.item(), out=out.F.detach().cpu(),
                        after={k: torch.from_numpy(v) for k, v in
                               export_reference_state_dict(net).items()}), f"{tmp}/tp.pt")
        tp_ms = dict(k1=0.0, k1_rank=0.0, k2=0.0, k2_rank=0.0)
        for i, (m, inp, o) in enumerate(calls):
            km = m._kernel_map(inp, o.coordinate_map_key)
            w, xf, g = m.kernel.detach(), inp.F.detach(), grads[i].contiguous()
            width = w.shape[2] // PARALLEL_WORLD
            if w.shape[2] % PARALLEL_WORLD:  # stays whole: not column-parallel
                continue
            for r in range(PARALLEL_WORLD):  # each rank's Cout slice
                w_s = w[:, :, r * width:(r + 1) * width].contiguous()
                g_s = g[:, r * width:(r + 1) * width].contiguous()
                tag = f"37c call {i} rank {r}"
                par_errs["gather_gemm"].append(agree(gather_gemm, gather_gemm_reference,
                                                    (xf, w_s, km.in_idx), KERNEL_RTOL, tag))
                par_errs["gather_gemm"].append(agree(
                    gather_gemm, gather_gemm_reference,
                    (g_s, w_s.transpose(1, 2).contiguous(), km.out_idx_t), KERNEL_RTOL,
                    tag + " dX"))
                par_errs["conv_dw"].append(agree(conv_dw, conv_dw_reference, (xf, g_s, km.in_idx),
                                                DW_RTOL, tag + " dW"))
                if r == 0:
                    tp_ms["k1_rank"] += cuda_ms(lambda: gather_gemm(xf, w_s, km.in_idx))
                    tp_ms["k2_rank"] += cuda_ms(lambda: conv_dw(xf, g_s, km.in_idx))
            tp_ms["k1"] += cuda_ms(lambda: gather_gemm(xf, w, km.in_idx))
            tp_ms["k2"] += cuda_ms(lambda: conv_dw(xf, g, km.in_idx))
        n_calls = len(calls)
        del calls, grads, net, opt, out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        mp.start_processes(rank_main, args=(PARALLEL_WORLD, tmp, str(dev)),
                           nprocs=PARALLEL_WORLD, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(PARALLEL_WORLD)]
        sp_ranks = [torch.load(f"{tmp}/spatial_grads{r}.pt") for r in range(PARALLEL_WORLD)]
        tp_step = torch.load(f"{tmp}/tp_step.pt")
        # each call's mask over the whole map: the ranks' blocks in row order
        rank_masks = [torch.cat(ms) for ms in zip(*(q["masks"] for q in sp_ranks))]
        if [m.shape for m in rank_masks] != [m.shape for m in sp_masks]:
            raise AssertionError("37b: the ranks' ReLU calls and the single process's differ")
        same_masks = all(torch.equal(a, b) for a, b in zip(rank_masks, sp_masks))
        rank_cpu = sp_cpu if same_masks else cpu_spatial(rank_masks, "ranks")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 37b's gradients against the CPU's float64 run on the same side of every
    # ReLU kink: the single process's, then each rank's against it
    flips = [f for _, fl in sp_flips for f in fl]
    margin = max(f[1] for f in flips)
    print(f"  37b ReLU kinks: the ranks' masks {'equal' if same_masks else 'differ from'} the single "
          f"process's; the CPU runs took the card's side of 0 on " + ", ".join(
              f"{sum(f[0] for f in fl)} elements ({tag})" for tag, fl in sp_flips)
          + f", each within {margin:.2e} of its call's largest |x| (limit {KERNEL_RTOL})")
    sp_judged = {"single process": eval_grads_judged("37b single process", sp_grads, sp_cpu)}
    for r, q in enumerate(sp_ranks):
        sp_judged[f"rank {r}"] = eval_grads_judged(f"37b rank {r}", q["grads"], rank_cpu,
                                                   sp_judged["single process"][1])
    sp_judged = {k: v[0] and margin <= KERNEL_RTOL for k, v in sp_judged.items()}
    del sp_grads, sp_ranks, sp_cpu, rank_cpu
    for r, res in enumerate(ranks):
        for part in ("ddp", "spatial", "tensor_parallel"):
            for k, v in res[part]["launches"].items():
                launches[k] += v
        a, b, c = res["ddp"], res["spatial"], res["tensor_parallel"]
        print(f"[37a DDP, rank {r} of 2] transport: {TRANSPORT} (CUDA tensors taken: "
              f"{res['probe']}); its own batch of {a['rows']} voxels; loss {a['loss']:.6f} "
              f"(mean over ranks, want {a['want_loss']:.6f}); averaged gradients against the "
              f"mean of two single-process steps: worst {a['worst'][0]} {a['worst'][1]:.2e}; "
              f"step {a['ms']:.2f} ms; collectives {a['comm']}; launches {a['launches']}")
        print(f"[37b spatial, rank {r} of 2] one scan of {b['rows']} voxels, eval mode, forward "
              f"and backward of sum(out^2) in {b['ms']:.2f} ms: output against the single "
              f"process {b['rel_out']:.2e}, gradients against its worst {b['worst'][0]} "
              f"{b['worst'][1]:.2e} (judged above against float64: {sp_judged[f'rank {r}']}); "
              f"dropped {b['dropped']}; K1 computed {b['k1_fwd_rows']:,} output rows in the "
              f"{b['fwd_calls']} forward calls: its blocks hold {b['block_rows']:,}, the whole "
              f"maps {b['whole_rows']:,}; collectives {b['comm']}; launches {b['launches']}")
        print(f"[37c column-parallel, rank {r} of 2] {c['cut']} convs cut by Cout; batch of "
              f"{c['rows']} voxels; logits against the unsharded step {c['rel_out']:.2e}, loss "
              f"{c['loss']:.6f} (unsharded {c['want_loss']:.6f}); parameters after one SGD step: "
              f"largest change from the unsharded step's {c['moved'][1]:.2e} ({c['moved'][0]}), "
              f"{c['moved'][1] / c['scale']:.2e} of the largest parameter; gradients the same on "
              f"both ranks: {c['same_grads']}; step {c['ms']:.2f} ms; collectives {c['comm']}; "
              f"launches {c['launches']}")
        if not (res["probe"] and a["worst"][1] <= DDP_RTOL
                and abs(a["loss"] - a["want_loss"]) <= LOSS_RTOL * abs(a["want_loss"])
                and b["rel_out"] <= SHARDED_RTOL and sp_judged["single process"]
                and sp_judged[f"rank {r}"]
                and b["dropped"] == 0 and b["k1_fwd_rows"] == b["block_rows"] < b["whole_rows"]
                and c["rel_out"] <= SHARDED_RTOL and c["moved"][1] <= SHARDED_RTOL * c["scale"]
                and c["same_grads"]
                and abs(c["loss"] - c["want_loss"]) <= LOSS_RTOL * abs(c["want_loss"])):
            raise AssertionError(f"phase 37, rank {r}: the parallel runs disagree")
        for part in (a, b, c):
            if part["launches"]["gather_gemm"] == 0 or part["launches"]["conv_dw"] == 0:
                raise AssertionError(f"phase 37, rank {r}: K1 or K2 not launched")
    print("  37c's step judged as phase 10 judges the unsharded one (every gradient against the "
          "CPU's float64 run, within GRAD_FACTOR times the CPU float32 run's distance):")
    judge_step("37c column-parallel", tp_step["loss"], tp_step["grads"], tp_step["stats"],
               reuse["unet_cpu"])
    halos = ranks[0]["spatial"]["halos"]
    print("  halo per map (forward, input gradient; rows in, out; all-gather fallback): "
          + "; ".join(f"{k} {v[0]}, {v[1]} ({v[2]}, {v[3]}){' fallback' if v[4] else ''}"
                      for k, v in halos.items()))
    print(f"  the ranks' K1/K2 calls (windows re-based, Cout slices; forward, input "
          f"gradient, weight gradient) against their plain versions: "
          f"{len(par_errs['gather_gemm'])} K1 calls, worst rel err "
          f"{max(e[1] for e in par_errs['gather_gemm']):.2e} (limit {KERNEL_RTOL}); "
          f"{len(par_errs['conv_dw'])} K2 calls, worst {max(e[1] for e in par_errs['conv_dw']):.2e} "
          f"(limit {DW_RTOL})")
    print(f"  per-rank K1/K2 ms against the unsharded calls', summed over one step's "
          f"{n_calls} convs (this process, CUDA events): spatial rank 0's windows K1 "
          f"{sp_ms['k1_rank']:.3f} against {sp_ms['k1']:.3f}, K2 {sp_ms['k2_rank']:.3f} against "
          f"{sp_ms['k2']:.3f}; column-parallel rank 0's Cout slice K1 {tp_ms['k1_rank']:.3f} "
          f"against {tp_ms['k1']:.3f}, K2 {tp_ms['k2_rank']:.3f} against {tp_ms['k2']:.3f}")
    print(json.dumps(dict(
        phase=37, backend="gloo", world=PARALLEL_WORLD, transport=TRANSPORT,
        cuda_tensors_taken=all(res["probe"] for res in ranks),
        ranks=[{part: {k: res[part][k] for k in ("ms", "comm", "launches")}
                for part in ("ddp", "spatial", "tensor_parallel")} for res in ranks],
        halos={k: dict(forward=v[0], input_gradient=v[1], fallback=v[4])
               for k, v in halos.items()},
        per_rank_kernel_ms=dict(spatial=sp_ms, tensor_parallel=tp_ms))))
    print(f"[36-37] {time.perf_counter() - start:.1f} s (the two ranks {spawn_s:.1f} s)")
    return {k: [e[0] for e in v] for k, v in par_errs.items()}


# phase 38: the ported examples (examples_torch/), as a user runs them
EXAMPLES = Path(__file__).resolve().parent / "examples_torch"
INDOOR_POINTS, INDOOR_VOXEL, INDOOR_VOXELS, INDOOR_REQUESTS = 200_000, 0.02, 163_022, 3
# (script, arguments, its model has a sparse conv: K1 must launch, it
# trains one: K2 must launch too, it trains: its last loss must be finite)
EXAMPLE_RUNS = [
    ("example", ["--steps", "2"], True, True, True),
    ("sparse_tensor_basic", [], False, False, False),
    ("convolution", [], True, False, False),
    ("unet", ["--steps", "2"], True, True, True),
    ("stack_unet", [], True, False, False),
    ("minkunet", ["--steps", "2"], True, True, True),
    ("resnet", [], True, False, False),
    # PointNet's convs are volume 1: a product, no sparse conv
    ("pointnet", ["--steps", "2", "--eval_batches", "1"], False, False, True),
    *[(f"classification_modelnet40:{n}", ["--network", n, "--steps", "2", "--eval_batches", "1"],
       n != "minkpointnet", n != "minkpointnet", True)
      for n in ("minkfcnn", "minksplatfcnn", "minkpointnet")],
    ("completion", ["--steps", "1"], True, True, True),
    ("vae", ["--steps", "1"], True, True, True),
    ("reconstruction", ["--steps", "1"], True, True, True),
    ("training", ["--steps", "2"], True, True, True),
    ("fresh_geometry_training", ["--steps", "3"], True, True, True),
]


@contextlib.contextmanager
def every_call_held(errors, tag):
    """Inside the block, every K1 and K2 launch the sparse conv makes
    (forward, input gradient and weight gradient, through
    ``ops.functional``, and the spatial conv's on its windows, through
    ``parallel.spatial``) is held against its plain version on the same
    inputs as it runs, within KERNEL_RTOL (K1_BF16_RTOL for bf16) and
    DW_RTOL: the (abs, rel) errors go to ``errors["gather_gemm"]`` and
    ``errors["conv_dw"]`` (``"gather_gemm_bf16"``, ``"conv_dw_bf16"``).  The
    launches are the main path's own, counted once; the plain versions
    launch neither kernel."""
    real_k1, real_k2 = conv_ops.gather_gemm, conv_ops.conv_dw
    if (spatial.gather_gemm, spatial.conv_dw) != (real_k1, real_k2):
        raise AssertionError("ops.functional and parallel.spatial bind other kernels")

    def k1(x, w, idx):
        out = real_k1(x, w, idx)
        bf16 = x.dtype == torch.bfloat16
        name = "gather_gemm_bf16" if bf16 else "gather_gemm"
        errs = errors.setdefault(name, [])
        errs.append(held(out, gather_gemm_reference(x, w, idx), K1_BF16_RTOL if bf16 else KERNEL_RTOL,
                         f"{tag} K1 call {len(errs)}"))
        return out

    def k2(x, g, idx):
        out = real_k2(x, g, idx)
        errs = errors.setdefault("conv_dw_bf16" if x.dtype == torch.bfloat16 else "conv_dw", [])
        errs.append(held(out, conv_dw_reference(x, g, idx), DW_RTOL, f"{tag} K2 call {len(errs)}"))
        return out

    conv_ops.gather_gemm, conv_ops.conv_dw = spatial.gather_gemm, spatial.conv_dw = k1, k2
    try:
        yield
    finally:
        conv_ops.gather_gemm, conv_ops.conv_dw = spatial.gather_gemm, spatial.conv_dw = (
            real_k1, real_k2)


def example(name):
    """A script of examples_torch/ by its path, under a module name of its own."""
    spec = importlib.util.spec_from_file_location(f"chip_smoke_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(dev, launches):
    """Phase 38: indoor.py's chain at full width, then every other ported
    script through its ``main``.  Adds the main-path launches to
    ``launches``; returns every K1 and K2 call's abs error against its
    plain version, by kernel."""
    start = time.perf_counter()
    indoor = example("indoor")

    # 38a. the synthetic room through field -> sparse -> MinkUNet34C -> slice
    points, colors = indoor.synthetic_room(n_points=INDOOR_POINTS)
    model = MinkUNet34C(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev)
    indoor.calibrate(model, points, colors, INDOOR_VOXEL, dev)
    convs = sparse_convs(model)
    calls = []
    hooks = [m.register_forward_hook(lambda m, a, o: calls.append((m, a[0], o))) for m in convs]
    with torch.no_grad():
        _, voxels = indoor.segment(points, colors, model, INDOOR_VOXEL, dev)  # warm-up
    for h in hooks:
        h.remove()
    print(f"[38a indoor] synthetic room: {len(points)} points, {voxels} voxels at "
          f"{INDOOR_VOXEL * 100:g} cm; MinkUNet34C(3, 20, D=3), batch norms calibrated on the "
          f"scan; {len(calls)} sparse conv calls of one forward")
    if voxels != INDOOR_VOXELS or len(calls) != len(convs):
        raise AssertionError(f"indoor: {voxels} voxels, {len(calls)} conv calls")
    rows, bounds = [], []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        row = compare(inp.F, m.kernel.detach(), kmap.in_idx, f"in{i}")
        idx = kmap.in_idx
        bounds.append(bound(2.0 * row["pairs"] * row["cin"] * row["cout"],
                            4 * (inp.F.numel() + m.kernel.numel() + idx.numel()
                                 + idx.shape[1] * row["cout"]))[0])
        rows.append(row)
    del calls
    print(f"  K1 over one forward's {len(rows)} calls: {sum(r['ms'] for r in rows):.3f} ms, plain "
          f"{sum(r['plain_ms'] for r in rows):.3f} ms, bound {sum(bounds):.3f} ms; worst rel err "
          f"{max(r['max_rel_err'] for r in rows):.2e}")

    answers = []
    zero_counts()
    for i in range(INDOOR_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = indoor.segment(points, colors, model, INDOOR_VOXEL, dev)[0].cpu()
        secs = time.perf_counter() - t0
        answers.append(logits)
        print(f"[38a indoor] request {i}: {secs * 1e3:.2f} ms field to per-point logits on the "
              f"host, {len(points) / secs:.0f} points/s, {voxels / secs:.0f} voxels/s")
        if logits.shape != (len(points), 20) or not torch.isfinite(logits).all():
            raise AssertionError(f"indoor logits: {tuple(logits.shape)}")
    got = take_launches(launches)
    print(f"  launches over {INDOOR_REQUESTS} requests: {got}")
    if got["gather_gemm"] != INDOOR_REQUESTS * len(convs) or got["conv_dw"]:
        raise AssertionError(f"indoor launches {got}")
    pred = answers[-1].argmax(1).numpy()
    counts = np.bincount(pred, minlength=20)
    top = ", ".join(f"{indoor.CLASS_LABELS[c]} {counts[c]}" for c in np.argsort(counts)[::-1][:5])
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/prediction.ply"
        indoor.write_ply(path, points, indoor.CLASS_COLORS[pred])
        back, _ = indoor.read_ply(path)
    print(f"  class histogram (top 5): {top}; PLY of {len(back)} points written and read back")
    if len(back) != len(points):
        raise AssertionError("indoor: the PLY did not round-trip")

    # the logits against the CPU plain path with the same weights and statistics
    cpu_model = MinkUNet34C(3, 20, D=3, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = indoor.segment(points, colors, cpu_model.eval(), INDOOR_VOXEL, "cpu")[0]
    rel = rel_diff(answers[0], ref)
    print(f"[38a indoor] card vs CPU plain-path per-point logits: max|d|/max|ref| = {rel:.2e} "
          f"(CPU {time.perf_counter() - t0:.1f} s)")
    if not rel <= LOGIT_RTOL:
        # ill-conditioned in float32: both runs against a float64 one
        with torch.no_grad():
            ref64 = indoor.segment(points, colors, cpu_model.double(), INDOOR_VOXEL, "cpu")[0]
        card64, cpu64 = rel_diff(answers[0].double(), ref64), rel_diff(ref.double(), ref64)
        print(f"  against float64: card {card64:.2e}, CPU float32 {cpu64:.2e}")
        if not card64 <= GRAD_FACTOR * cpu64:
            raise AssertionError(f"indoor logits disagree: {rel:.3e}")
    del cpu_model, ref, answers

    # COPY_GEMM selects nothing: the same K1/K2 calls as DEFAULT
    x = MT.TensorField(
        torch.from_numpy(indoor.normalize_color(colors)).to(dev),
        MT.utils.batched_coordinates([points / INDOOR_VOXEL], dtype=torch.float32).to(dev),
    ).sparse()
    outs, mode_errs = {}, dict(gather_gemm=[], conv_dw=[])
    for mode in (MT.ConvolutionMode.DEFAULT, MT.ConvolutionMode.COPY_GEMM):
        conv = MT.MinkowskiConvolution(3, 32, kernel_size=3, dimension=3, convolution_mode=mode,
                                       generator=torch.Generator().manual_seed(0), device=dev)
        feats = x.F.detach().clone().requires_grad_()

        def run():
            y = conv(MT.SparseTensor(feats, coordinate_map_key=x.coordinate_map_key,
                                     coordinate_manager=x.coordinate_manager))
            y.F.square().sum().backward()
            return y.F.detach()

        with every_call_held(mode_errs, f"38a {mode.name}"):
            out, n = counted(launches, run)
        outs[mode.name] = (out, feats.grad, conv.kernel.grad, n)
    same = all(torch.equal(a, b) for a, b in zip(outs["DEFAULT"][:3], outs["COPY_GEMM"][:3]))
    print(f"[38a convolution_mode] COPY_GEMM: {outs['COPY_GEMM'][3]}, DEFAULT: "
          f"{outs['DEFAULT'][3]}; output and gradients bit-equal: {same}; each mode's K1 and K2 "
          f"calls against their plain versions: worst rel err K1 "
          f"{max(e[1] for e in mode_errs['gather_gemm']):.2e}, K2 "
          f"{max(e[1] for e in mode_errs['conv_dw']):.2e}")
    if not same or outs["COPY_GEMM"][3] != outs["DEFAULT"][3] or (
            outs["COPY_GEMM"][3]["gather_gemm"], outs["COPY_GEMM"][3]["conv_dw"]) != (2, 1):
        raise AssertionError("COPY_GEMM left K1/K2")
    del x, outs, model
    torch.cuda.empty_cache()

    # 38b. every other script, as a user runs it, on the card, each of its
    # K1 and K2 calls held against its plain version as it runs
    script_errs = dict(gather_gemm=[], conv_dw=[])
    with tempfile.TemporaryDirectory() as tmp:
        for case, argv, sparse, trains_conv, trains in EXAMPLE_RUNS:
            name = case.split(":")[0]
            argv = argv + (["--ckpt", f"{tmp}/checkpoint.pt"] if name == "training" else [])
            printed = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            errs = dict(gather_gemm=[], conv_dw=[])
            with contextlib.redirect_stdout(printed), every_call_held(errs, f"38b {case}"):
                result, n = counted(launches, lambda: example(name).main(argv))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            last = printed.getvalue().strip().splitlines()[-1]
            loss = result.get("losses", [None])[-1] if trains else None
            worst_rel = {k: max((e[1] for e in v), default=0.0) for k, v in errs.items()}
            print(f"[38b {case}] {secs:.2f} s with the holds, gather_gemm {n['gather_gemm']}, "
                  f"conv_dw {n['conv_dw']}, each held: worst rel err K1 "
                  f"{worst_rel['gather_gemm']:.2e}, K2 {worst_rel['conv_dw']:.2e}; last loss "
                  f"{loss}; \"{last}\"")
            if (sparse and not n["gather_gemm"]) or (trains_conv and not n["conv_dw"]) or (
                    not sparse and n["gather_gemm"]) or (trains and not math.isfinite(loss)):
                raise AssertionError(f"{case}: launches {n}, last loss {loss}")
            if (len(errs["gather_gemm"]), len(errs["conv_dw"])) != (n["gather_gemm"], n["conv_dw"]):
                raise AssertionError(f"{case}: {n} launches, {len(errs['gather_gemm'])} K1 and "
                                     f"{len(errs['conv_dw'])} K2 calls held")
            for k in script_errs:
                script_errs[k] += errs[k]
    print(f"  38b's {len(script_errs['gather_gemm'])} K1 and {len(script_errs['conv_dw'])} K2 calls "
          f"against their plain versions: worst rel err K1 "
          f"{max(e[1] for e in script_errs['gather_gemm']):.2e} (limit {KERNEL_RTOL}), K2 "
          f"{max(e[1] for e in script_errs['conv_dw']):.2e} (limit {DW_RTOL})")
    print(f"[38] {time.perf_counter() - start:.1f} s")
    errors = {k: [e[0] for e in mode_errs[k] + script_errs[k]] for k in mode_errs}
    errors["gather_gemm"] += [r["max_abs_err"] for r in rows]
    return errors


# phase 39: the coordinate engine above D = 6.  A cloud is HIGH_D_FRAMES
# frames of the room of ``scan`` (each its own seed, moved a few voxels),
# each point lifted to (x, y, z in 5 cm voxels, its colors in [0, 8), t):
# ~100k 7-D rows, inside the ±1024 budget of D = 7
HIGH_D_FRAMES, HIGH_D_POINTS, HIGH_D_VOXEL, HIGH_D_REQUESTS = 4, 100_000, 0.05, 3
# two clouds per batch: four training batches, two to warm the replayer,
# two fresh ones
HIGH_D_TRAIN = ((0, 1), (2, 3), (4, 5), (6, 7))
HIGH_D_WARM, HIGH_D_FRESH = ((8, 9), (10, 11)), ((12, 13), (14, 15))
HIGH_D_CONVS = 4  # K > 1 sparse convs: conv1, conv2, conv3, up
# per step: K1 forward on all four, input gradient on all but conv1; K2 on all
HIGH_D_STEP_LAUNCHES = (2 * HIGH_D_CONVS - 1, HIGH_D_CONVS)
# the D = 16 cloud: the voxels of two room scans, each row given 13 more
# coordinates in {0, 1}
HIGH_D16, HIGH_D16_SEED = 16, 0


class HighDimUNet(torch.nn.Module):
    """A small sparse U-Net for any D, from the port's public modules, at
    MinkUNet's first two widths: conv k = 2 (2^D offsets), conv k = 2 s = 2,
    a HYPER_CROSS k = 3 conv (2D + 1 offsets), a transposed conv k = 2 s = 2,
    each followed by batch norm and ReLU; ``cat`` with the first level and
    a k = 1 conv with bias."""

    def __init__(self, cin, cout, D, generator=None, device=None):
        super().__init__()
        kw = dict(dimension=D, generator=generator, device=device)
        cross = MT.KernelGenerator(kernel_size=3, region_type=MT.RegionType.HYPER_CROSS,
                                   dimension=D)
        self.conv1 = MT.MinkowskiConvolution(cin, 32, kernel_size=2, **kw)
        self.bn1 = MT.MinkowskiBatchNorm(32, device=device)
        self.conv2 = MT.MinkowskiConvolution(32, 64, kernel_size=2, stride=2, **kw)
        self.bn2 = MT.MinkowskiBatchNorm(64, device=device)
        self.conv3 = MT.MinkowskiConvolution(64, 64, kernel_size=3, kernel_generator=cross, **kw)
        self.bn3 = MT.MinkowskiBatchNorm(64, device=device)
        self.up = MT.MinkowskiConvolutionTranspose(64, 32, kernel_size=2, stride=2, **kw)
        self.bn4 = MT.MinkowskiBatchNorm(32, device=device)
        self.final = MT.MinkowskiConvolution(64, cout, kernel_size=1, bias=True, **kw)
        self.relu = MT.MinkowskiReLU()

    def forward(self, x):
        a = self.relu(self.bn1(self.conv1(x)))
        b = self.relu(self.bn2(self.conv2(a)))
        b = self.relu(self.bn3(self.conv3(b)))
        u = self.relu(self.bn4(self.up(b)))
        return self.final(MT.cat(u, a))


def lifted_points(seed):
    """One 7-D cloud as raw points: (float coordinates (N, 8): batch 0, x,
    y, z in voxels, the three colors times 8, t; colors (N, 3), centred at
    0).  The colors are a function of the point, as ``room_points`` makes
    them."""
    coords, colors = [], []
    for t in range(HIGH_D_FRAMES):
        s = HIGH_D_FRAMES * seed + t
        pts = make_room_scan(n_points=HIGH_D_POINTS, extent=(2.0, 2.0, 2.2), n_objects=4, seed=s)
        col = np.stack([pts[:, 2] / 2.5, 0.5 + 0.5 * np.sin(pts[:, 0] * 2.1),
                        0.5 + 0.5 * np.cos(pts[:, 1] * 1.7)], 1).clip(0, 0.999)
        moved = pts / HIGH_D_VOXEL + np.random.RandomState(s).randint(-3, 4, 3)
        coords.append(np.concatenate(
            [np.zeros((len(pts), 1)), moved, 8 * col, np.full((len(pts), 1), t)], 1))
        colors.append(col - 0.5)
    return np.concatenate(coords).astype(np.float32), np.concatenate(colors).astype(np.float32)


def lifted_voxels(seed):
    """The cloud voxelized on the host (``sparse_quantize`` over 7-wide
    rows): (int32 coordinates (N, 7), colors of each voxel's first point)."""
    pts, colors = lifted_points(seed)
    return MT.utils.sparse_quantize(pts[:, 1:], colors)


def cloud16(seed):
    """(coordinates (N, 17) with batch 0, features (N, 3)): the voxels of
    ``scan(seed)`` twice, each copy's rows given 13 more coordinates in
    {0, 1}, unique rows."""
    coords, feats = scan(seed)
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.concatenate(
        [coords, rng.randint(0, 2, (len(coords), HIGH_D16 - 3))], 1) for _ in range(2)])
    rows, first = np.unique(rows.astype(np.int32), axis=0, return_index=True)
    return rows, np.concatenate([feats, feats])[first]


def empty_share(km):
    return 1 - (km.in_idx >= 0).sum().item() / max(1, km.in_idx.numel())


def high_dimensional(dev, launches):
    """Phase 39: the 7-D U-Net from raw lifted points to per-point logits,
    its training, its coordinate phase replayed, and a D = 16 conv.  Adds
    the main-path launches to ``launches``; returns (every K1 and K2
    call's abs error against its plain version, by kernel; the kernel rows
    of one 7-D training step)."""
    start = time.perf_counter()
    net = HighDimUNet(3, 20, 7, generator=torch.Generator().manual_seed(0), device=dev)
    init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    errors = dict(gather_gemm=[], conv_dw=[])

    # 39a. requests: raw 7-D points -> TensorField -> sparse() -> net -> slice()
    points, colors = lifted_points(0)

    def request(model, d):
        with torch.no_grad():
            field = MT.TensorField(torch.from_numpy(colors).to(d), torch.from_numpy(points).to(d),
                                   device=d)
            x = field.sparse()
            return model(x).slice(field).F.cpu(), x

    net.eval()
    request(net, dev)  # warm-up: allocator, cuBLAS
    answers = []
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for i in range(HIGH_D_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, x = request(net, dev)
        secs = time.perf_counter() - t0
        answers.append(logits)
        print(f"[39a 7-D request] {i}: {len(points)} points, {x.size} voxels, {secs * 1e3:.2f} ms "
              f"from raw points to per-point logits on the host, {len(points) / secs:.0f} points/s")
        if logits.shape != (len(points), 20) or not torch.isfinite(logits).all():
            raise AssertionError(f"7-D logits {tuple(logits.shape)}")
    got = take_launches(launches)
    if (got["gather_gemm"], got["conv_dw"]) != (HIGH_D_REQUESTS * HIGH_D_CONVS, 0):
        raise AssertionError(f"7-D requests launched {got}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    mgr = x.coordinate_manager
    for km_key, km in mgr._kernel_maps.items():
        print(f"  map {km_key[0][0][0]}->{km_key[1][0][0]} K={km.kernel_volume}: rows "
              f"{km.n_in}->{km.n_out}, -1 slots {empty_share(km):.2%}")
    cpu_net = HighDimUNet(3, 20, 7, device="cpu")
    cpu_net.load_state_dict(net.state_dict())
    t0 = time.perf_counter()
    ref, _ = request(cpu_net.eval(), "cpu")
    rel = rel_diff(answers[0], ref)
    print(f"  launches {got}; card vs CPU plain-path per-point logits {rel:.2e} "
          f"(CPU {time.perf_counter() - t0:.1f} s)")
    if not rel <= LOGIT_RTOL:
        ref64, _ = request(cpu_net.double(), "cpu")
        card64, cpu64 = rel_diff(answers[0].double(), ref64), rel_diff(ref.double(), ref64)
        print(f"  against float64: card {card64:.2e}, CPU float32 {cpu64:.2e}")
        if not card64 <= GRAD_FACTOR * cpu64:
            raise AssertionError(f"7-D logits disagree: {rel:.3e}")
    del answers, ref, cpu_net, x, mgr

    # 39b. training: the kernels on one step's maps, then four steps, each
    # K1 and K2 call held against its plain version as it runs
    t0 = time.perf_counter()
    clouds = {s: lifted_voxels(s) for b in HIGH_D_TRAIN + HIGH_D_WARM + HIGH_D_FRESH for s in b}
    batches = [sparse_collate([clouds[a][0], clouds[b][0]], [clouds[a][1], clouds[b][1]])
               for a, b in HIGH_D_TRAIN + HIGH_D_WARM + HIGH_D_FRESH]
    print(f"[39b 7-D training] {len(clouds)} clouds voxelized on the host in "
          f"{time.perf_counter() - t0:.1f} s; batches of {[len(c) for c, _ in batches]} rows")
    labels = [labels_for(i, len(c)) for i, (c, _) in enumerate(batches)]
    net.load_state_dict({k: v.to(dev) for k, v in init.items()})
    net.train().zero_grad(set_to_none=True)
    convs = sparse_convs(net)
    calls, grads, (loss, _) = capture_step(
        convs, lambda: train_step(net, None, *batches[0], labels[0], dev))
    if len(calls) != HIGH_D_CONVS or len(grads) != HIGH_D_CONVS:
        raise AssertionError(f"captured {len(calls)} calls and {len(grads)} output gradients")
    rows = []
    for i, (m, inp, out) in enumerate(calls):
        kmap = m._kernel_map(inp, out.coordinate_map_key)
        rows.append(backward_rows(
            inp.F.detach(), m.kernel.detach(), grads[i].contiguous(), kmap.in_idx,
            kmap.out_idx_t, ("conv1", "conv2", "conv3", "up")[i], with_dx=inp.F.requires_grad))
    print_sums(step_sums(rows))
    del calls, grads, loss

    net.load_state_dict({k: v.to(dev) for k, v in init.items()})
    net.zero_grad(set_to_none=True)
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with every_call_held(errors, "39b"):
        for step in range(len(HIGH_D_TRAIN)):
            before = counts_now()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, out = train_step(net, opt, *batches[step], labels[step], dev)
            if step == 0:
                loss0 = loss.item()
                grads0 = {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}
            opt.step()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = tuple(counts_now()[k] - before[k] for k in ("gather_gemm", "conv_dw"))
            print(f"[39b 7-D training] step {step}: {len(batches[step][0])} rows, "
                  f"{secs * 1e3:.2f} ms, loss {loss.item():.6f}, {n[0]} gather_gemm and "
                  f"{n[1]} conv_dw launches")
            if n != HIGH_D_STEP_LAUNCHES or not torch.isfinite(loss):
                raise AssertionError(f"7-D step {step}: launches {n}, loss {loss.item()}")
            if step == 0:
                stats0 = {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k}
            del loss, out
    got = take_launches(launches)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{len(errors['gather_gemm'])} K1 and {len(errors['conv_dw'])} K2 calls held, worst rel "
          f"err K1 {max(e[1] for e in errors['gather_gemm']):.2e}, K2 "
          f"{max(e[1] for e in errors['conv_dw']):.2e}")
    if (len(errors["gather_gemm"]), len(errors["conv_dw"])) != (got["gather_gemm"], got["conv_dw"]):
        raise AssertionError(f"7-D steps: {got} launches, {len(errors['gather_gemm'])} K1 and "
                             f"{len(errors['conv_dw'])} K2 calls held")

    def cpu_step(dtype):
        cpu_net = HighDimUNet(3, 20, 7, device="cpu").train()
        cpu_net.load_state_dict(init)
        cpu_net.to(dtype)
        coords, feats = batches[0]
        loss, _ = train_step(cpu_net, None, coords, feats.to(dtype), labels[0], "cpu")
        return loss, cpu_net, len(coords)

    judge_step("39b parity", loss0, grads0, stats0, cpu_steps(cpu_step, "39b parity", "rows"))

    # 39c. the coordinate phase recorded on batch 0 and replayed on fresh
    # batches: maps bit-equal to eager, one host sync compiled, and a step
    # through the graph's geometry bit-equal to the eager step
    def on_card(batch):
        return batch[0].to(dev), batch[1].to(dev)

    recorder = HighDimUNet(3, 20, 7, device=dev).eval()
    c, f = on_card(batches[0])
    x = MT.SparseTensor(f, c)
    with torch.no_grad():
        recorder(x)
    log = x.coordinate_manager.oplog()
    replayer = MT.GeometryReplayer(x.coordinate_manager)
    for batch in batches[len(HIGH_D_TRAIN):len(HIGH_D_TRAIN) + len(HIGH_D_WARM)]:
        replayer(on_card(batch)[0])
    compiled = MT.CompiledReplayer(x.coordinate_manager).adopt(replayer)
    compiled.run(*on_card(batches[0]))  # the capture
    print(f"[39c 7-D replay] oplog of {len(log)} entries; floors "
          f"{ {k[0][0]: v for k, v in replayer.cap_floors.items() if k[0] != 'kmax'} }")
    for i, batch in enumerate(batches[-len(HIGH_D_FRESH):]):
        c, f = on_card(batch)
        clock = CoordinateClock()
        with clock:
            x = MT.SparseTensor(f, c)
            with torch.no_grad():
                recorder(x)
        eager = x.coordinate_manager
        deferred, d_ms, d_syncs = host_phase(lambda: replayer(c).export_geometry())
        (geo, fp, ok), c_ms, c_syncs = host_phase(lambda: compiled.run(c, f))
        if not ok:
            raise AssertionError(f"7-D batch {i}: compiled replay ok {ok}")
        same_geometry(f"39c batch {i} deferred", deferred, eager)
        same_geometry(f"39c batch {i} compiled", geo, eager)
        print(f"  fresh batch {i}: {len(c)} rows; host ms / syncs of the coordinate phase: eager "
              f"{clock.ms:.2f} / {clock.syncs}, deferred {d_ms:.2f} / {d_syncs}, compiled "
              f"{c_ms:.2f} / {c_syncs}; graphs captured {compiled.captures}, recoveries "
              f"{compiled.recoveries}")
        if c_syncs != 1 or compiled.recoveries:
            raise AssertionError(f"7-D compiled replay: {c_syncs} syncs, "
                                 f"{compiled.recoveries} recoveries")
    del recorder, x, eager, deferred

    def step_on(geo_step):
        net.load_state_dict({k: v.to(dev) for k, v in init.items()})
        net.zero_grad(set_to_none=True)
        loss = geo_step()
        loss.backward()
        return loss.item(), {k: p.grad.detach().cpu().clone() for k, p in net.named_parameters()}

    c, f = on_card(batches[-1])
    lab = labels[-1].to(dev)
    eager_step = step_on(lambda: torch.nn.functional.cross_entropy(net(MT.SparseTensor(f, c)).F, lab))

    def compiled_step():
        geo, fp, ok = compiled.run(c, f)
        view = MT.CoordinateManager.from_geometry(geo)
        out = net(MT.SparseTensor(fp, coordinate_map_key=geo.entry_key, coordinate_manager=view))
        return torch.nn.functional.cross_entropy(out.F, lab)

    graph_step = step_on(compiled_step)
    same = eager_step[0] == graph_step[0] and all(
        torch.equal(graph_step[1][k], g) for k, g in eager_step[1].items())
    print(f"  a step through the compiled geometry: loss {graph_step[0]:.6f} (eager "
          f"{eager_step[0]:.6f}), {len(eager_step[1])} gradients bit-equal: {same}")
    if not same:
        raise AssertionError("7-D step through the compiled geometry differs from eager")
    del compiled, clouds, batches
    torch.cuda.empty_cache()

    # 39d. D = 16: a HYPER_CROSS k = 3 conv (33 offsets), forward and backward
    coords16, feats16 = cloud16(HIGH_D16_SEED)
    conv16 = MT.MinkowskiConvolution(
        3, 32, kernel_size=3, dimension=HIGH_D16, generator=torch.Generator().manual_seed(0),
        kernel_generator=MT.KernelGenerator(kernel_size=3, region_type=MT.RegionType.HYPER_CROSS,
                                            dimension=HIGH_D16), device=dev)

    def conv16_step():
        x = MT.SparseTensor(torch.from_numpy(feats16).to(dev).requires_grad_(),
                            torch.from_numpy(coords16).to(dev))
        y = conv16(x)
        y.F.square().sum().backward()
        torch.cuda.synchronize()
        return x, y

    errs16 = dict(gather_gemm=[], conv_dw=[])
    with every_call_held(errs16, "39d"):
        (x, y), n = counted(launches, conv16_step)
    km = x.coordinate_manager.kernel_map(x.coordinate_map_key, y.coordinate_map_key,
                                         kernel_size=3, region_type=MT.RegionType.HYPER_CROSS)
    print(f"[39d D = 16] {x.size} rows, key words "
          f"{tuple(x.coordinate_manager.get_coordinate_map(x.coordinate_map_key).keys.shape)}, "
          f"K={km.kernel_volume}, -1 slots {empty_share(km):.2%}; launches {n}; K1 and K2 held: "
          f"worst rel err {max(e[1] for e in errs16['gather_gemm']):.2e}, "
          f"{max(e[1] for e in errs16['conv_dw']):.2e}")
    if (n["gather_gemm"], n["conv_dw"]) != (2, 1) or km.kernel_volume != 2 * HIGH_D16 + 1:
        raise AssertionError(f"D = 16 conv: launches {n}, K {km.kernel_volume}")
    for k in errors:
        errors[k] += errs16[k]
    print(f"[39] {time.perf_counter() - start:.1f} s")
    return {k: [e[0] for e in v] for k, v in errors.items()}, rows



# phase 40: the multi-process examples (examples_torch/), through their
# own launcher (common.py's run_world): 40a one NCCL rank in this process,
# 40b one spawned gloo world of two ranks sharing the card
MULTI_EXAMPLES = ("multigpu", "multigpu_ddp", "spatial_sharding", "tensor_parallel")


def held_worst(errs):
    return {k: max((e[1] for e in v), default=0.0) for k, v in errs.items()}


def rank_examples(rank, world, args):
    """Phase 40b on one rank: the four scripts' rank functions in turn, at
    their own sizes, every K1 and K2 call of this rank held against its
    plain version as it runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    probe = torch.ones(1, device=dev)
    torch.distributed.all_reduce(probe)
    out = dict(probe=probe.device == dev and float(probe) == world)
    for name in MULTI_EXAMPLES:
        mod = example(name)
        errs = dict(gather_gemm=[], conv_dw=[])
        printed = io.StringIO()
        sync(dev)
        t0, before = time.perf_counter(), counts_now()
        with contextlib.redirect_stdout(printed), every_call_held(errs, f"40b {name} rank {rank}"):
            res = mod.run_rank(rank, world, mod.arguments(["--backend", "gloo"] + args.argv))
        sync(dev)
        res.update(secs=time.perf_counter() - t0, total=counts_since(before),
                   held={k: [e[0] for e in v] for k, v in errs.items()},
                   held_worst=held_worst(errs), printed=printed.getvalue())
        out[name] = res
    return out


def multi_process_examples(dev, launches):
    """Phase 40: the four multi-process examples on the card.  Adds the
    main-path launches (this process's and the spawned ranks') to
    ``launches``; returns every K1 and K2 call's abs error against its
    plain version, by kernel."""
    start = time.perf_counter()
    common = example("common")
    errors = dict(gather_gemm=[], conv_dw=[])
    cpu = torch.device(dev).type == "cpu"  # a CPU rehearsal: gloo, and the scripts' --cpu
    argv = ["--cpu"] if cpu else []

    # the launches of one single-process MinkUNet14A step on the same cloud
    coords, feats, _ = common.random_cloud(**example("multigpu").CLOUD)
    net = MinkUNet14A(3, 10, D=3, generator=torch.Generator().manual_seed(0), device=dev)
    x = MT.SparseTensor(torch.from_numpy(feats).to(dev), torch.from_numpy(coords).to(dev))
    before = counts_now()
    torch.nn.functional.cross_entropy(net(x).F, torch.zeros(x.size, dtype=torch.long, device=dev)
                                      ).backward()
    sync(dev)
    single = {k: v for k, v in counts_since(before).items() if k in ("gather_gemm", "conv_dw")}
    del net, x

    # 40a. multigpu.py and multigpu_ddp.py through their main, one NCCL rank here
    for name in ("multigpu", "multigpu_ddp"):
        errs = dict(gather_gemm=[], conv_dw=[])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), every_call_held(errs, f"40a {name}"):
            res, n = counted(launches, lambda: example(name).main(
                ["--world", "1", "--backend", "gloo" if cpu else "nccl"] + argv))
        worst_rel = held_worst(errs)
        grads_reduces = [c["all_reduce"] - bn for c, bn in zip(res["collectives"],
                                                              res["bn_all_reduces"])]
        print(f"[40a {name}, one NCCL rank] {len(res['losses'])} steps: ms per step "
              + ", ".join(f"{v:.2f}" for v in res["ms"]) + f"; losses "
              + ", ".join(f"{v:.4f}" for v in res["losses"]) + f"; launches per step "
              f"{res['launches']} (one single-process MinkUNet14A step: {single}); all-reduces per "
              f"step: gradients {grads_reduces}, sync batch norm {res['bn_all_reduces']}; bytes "
              f"per step {res['collectives'][0]['bytes']:,}; every K1/K2 call held: {n}, worst "
              f"rel err K1 {worst_rel['gather_gemm']:.2e}, K2 {worst_rel['conv_dw']:.2e}")
        if not (all(step == single for step in res["launches"])
                and all(g == 1 for g in grads_reduces)
                and all(math.isfinite(v) for v in res["losses"])
                and (len(errs["gather_gemm"]), len(errs["conv_dw"])) == (n["gather_gemm"],
                                                                         n["conv_dw"])
                and sum(s["gather_gemm"] for s in res["launches"]) <= n["gather_gemm"]):
            raise AssertionError(f"40a {name}: launches {res['launches']} against {single}, "
                                 f"all-reduces {grads_reduces}, losses {res['losses']}, held {n}")
        for k in errors:
            errors[k] += [e[0] for e in errs[k]]

    # 40b. one gloo world of two ranks on cuda:0 runs the four scripts in turn
    t0 = time.perf_counter()
    ranks = common.run_world(Path(__file__), "rank_examples", argparse.Namespace(
        cpu=cpu, world=PARALLEL_WORLD, backend="gloo", argv=argv))
    spawn_s = time.perf_counter() - t0

    # the single-process conv of spatial_sharding.py on the card
    sp = example("spatial_sharding")
    sp_args = sp.arguments(argv)
    c, f = room_scan_voxels(voxel_size=sp_args.voxel_size, n_points=sp_args.n_points, seed=0)
    x = MT.SparseTensor(torch.from_numpy(f).to(dev), torch.from_numpy(c).to(dev))
    mgr, key = x.coordinate_manager, x.coordinate_map_key
    km = mgr.kernel_map(key, mgr.stride(key, 1), kernel_size=3, stride=1)
    fx = x.F.clone().requires_grad_()
    w = sp.weight(dev).requires_grad_()
    out = conv_ops.sparse_conv_kmap(fx, w, km)
    loss = (out * out).sum()
    loss.backward()
    ref = dict(loss=loss.item(), d_weight=w.grad.cpu(), d_feats=fx.grad.cpu(), rows=x.size,
               halo=spatial.required_halo(km, PARALLEL_WORLD))
    del x, mgr, km, fx, w, out

    for r, res in enumerate(ranks):
        for name in MULTI_EXAMPLES:
            part = res[name]
            for k in launches:  # every launch of the script's run on this rank, the bf16 ones none
                launches[k] += part["total"][k]
            for k in errors:
                errors[k] += part["held"][k]
            if part["total"]["gather_gemm_bf16"] or part["total"]["conv_dw_bf16"] or any(
                    part["total"][k] != len(part["held"][k]) for k in errors):
                raise AssertionError(f"40b {name} rank {r}: launches {part['total']}, held "
                                     f"{len(part['held']['gather_gemm'])} + "
                                     f"{len(part['held']['conv_dw'])}")
        a, b, s, t = (res[n] for n in MULTI_EXAMPLES)
        for name, part in (("multigpu", a), ("multigpu_ddp", b)):
            same = all(q[name]["digests"] == part["digests"] for q in ranks)
            print(f"[40b {name}, rank {r} of {PARALLEL_WORLD}] transport: {TRANSPORT} (CUDA tensors "
                  f"taken: {res['probe']}); {len(part['losses'])} steps in {part['secs']:.1f} s with "
                  f"the holds, ms per step " + ", ".join(f"{v:.1f}" for v in part["ms"])
                  + f"; averaged losses " + ", ".join(f"{v:.4f}" for v in part["losses"])
                  + f"; parameters bit-equal on both ranks after every step: {same}; collectives "
                  f"per step {part['collectives'][0]}; launches per step {part['launches'][0]}; "
                  f"K1/K2 held: worst rel err {part['held_worst']['gather_gemm']:.2e}, "
                  f"{part['held_worst']['conv_dw']:.2e}")
            if not (same and all(math.isfinite(v) for v in part["losses"])
                    and all(step == single for step in part["launches"])):
                raise AssertionError(f"40b {name} rank {r}: ranks differ or launches "
                                     f"{part['launches']} against {single}")
        rel = dict(loss=abs(s["loss"] - ref["loss"]) / abs(ref["loss"]),
                   d_weight=rel_diff(s["d_weight"], ref["d_weight"]))
        if r == 0:
            rel["d_feats"] = rel_diff(s["d_feats"], ref["d_feats"])
        print(f"[40b spatial_sharding, rank {r}] one scan of {s['rows']} voxels, rows "
              f"{s['block'][0]}..{s['block'][1]} here; halo (forward, input gradient) {s['halo']} "
              f"(this process on the whole map: {ref['halo']}); dropped {s['dropped']}; forward "
              f"and backward {s['ms']:.1f} ms; against the single-process conv on the card: "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f"; collectives "
              f"{s['collectives']}; launches {s['launches']}; K1/K2 held: worst rel err "
              f"{s['held_worst']['gather_gemm']:.2e}, {s['held_worst']['conv_dw']:.2e}")
        print(f"[40b tensor_parallel, rank {r}] {t['cut']} layers cut by Cout; {t['rows']} "
              f"voxels; max|tp - single| {t['err']:.2e} = {t['err'] / t['scale']:.2e} of "
              f"max|single| (limit {SHARDED_RTOL}); forward {t['ms']:.1f} ms; collectives "
              f"{t['collectives']}; launches {t['launches']}; K1 held: worst rel err "
              f"{t['held_worst']['gather_gemm']:.2e}")
        if not (res["probe"] and s["dropped"] == 0 and s["rows"] == ref["rows"]
                and tuple(s["halo"]) == tuple(ref["halo"])
                and all(v <= SHARDED_RTOL for v in rel.values())
                and t["err"] <= SHARDED_RTOL * t["scale"]
                and s["launches"]["gather_gemm"] and s["launches"]["conv_dw"]
                and t["launches"]["gather_gemm"]):
            raise AssertionError(f"phase 40b, rank {r}: the examples disagree")
    print(json.dumps(dict(
        phase=40, single_step_launches=single, spawn_s=spawn_s,
        ranks=[{n: {k: res[n][k] for k in ("ms", "collectives", "launches")}
                for n in MULTI_EXAMPLES} for res in ranks])))
    print(f"  phase 40's K1/K2 calls against their plain versions: {len(errors['gather_gemm'])} K1, "
          f"{len(errors['conv_dw'])} K2; the two ranks {spawn_s:.1f} s")
    print(f"[40] {time.perf_counter() - start:.1f} s")
    return errors

# phase 41: the dense bbox grid; the scans of its eager coordinate phases,
# grid on and off
GRID_SEEDS = FRESH_SEEDS[:3]


def rebuild_kernel_map(mgr, cache_key, probe):
    """A cached kernel map built again from its two maps, through the row
    grids (``probe``) or the key search."""
    in_k, out_k, ks, _, dil, rtype, is_t, _, _ = cache_key
    a, b = (out_k, in_k) if is_t else (in_k, out_k)  # the probed map first
    am, bm = mgr._maps[a], mgr._maps[b]
    offs = region_offsets_for(rtype, ks, dil, am.tensor_stride, None)
    pa = mgr._probe_grid_for(MT.CoordinateMapKey(*a)) if probe else None
    pb = mgr._probe_grid_for(MT.CoordinateMapKey(*b)) if probe else None
    km = build_kernel_map(am, bm, offs, probe=pa, probe_out=pb)
    return km.swap() if is_t else km


def same_map(a, b):
    return torch.equal(a.in_idx, b.in_idx) and torch.equal(a.out_idx_t, b.out_idx_t)


def probe_tables(mgr):
    """Phase 41's per-map tables: each map's grid (cells, bytes, row grid
    built in ms), each kernel map, stride map and interpolation map built
    through the grids and through the search, bit-equal, both timed."""
    print("  coordinate maps: rows, grid shape, cells, int32 row grid, its build (CUDA events)")
    levels = {}
    for key_t, m in mgr._maps.items():
        key = MT.CoordinateMapKey(*key_t)
        plan = mgr.dense_plan(key)
        if plan is None:
            continue
        levels[key_t] = key
        ms = cuda_ms(lambda: build_row_grid(plan.flat_idx, plan.cells))
        print(f"    {str(key_t):>18} {m.size:>6} rows, grid {plan.grid_shape} = {plan.cells:,} "
              f"cells, {4 * (plan.cells + 1) / 2**20:.2f} MiB, built in {ms:.4f} ms")
    print("  kernel maps: K, rows out, grid build ms / search build ms, bit-equal")
    for ck, km in mgr._kernel_maps.items():
        grid, search = rebuild_kernel_map(mgr, ck, True), rebuild_kernel_map(mgr, ck, False)
        if not (same_map(grid, search) and same_map(grid, km)):
            raise AssertionError(f"41: kernel map {ck[:4]} differs between the grid and the search")
        g_ms = cuda_ms(lambda: rebuild_kernel_map(mgr, ck, True))
        s_ms = cuda_ms(lambda: rebuild_kernel_map(mgr, ck, False))
        print(f"    {str(ck[0][0]) + '->' + str(ck[1][0]):>22} k={ck[2][0]} s={ck[3][0]}"
              f"{' T' if ck[6] else '  '} K={km.kernel_volume:<3} rows {km.n_out:>6}: "
              f"{g_ms:.4f} / {s_ms:.4f} ms")
    print("  stride maps between levels and interpolation maps on each level: grid / search ms")
    keys = [k for k in levels if k[1] == ""]
    for fine, coarse in zip(keys, keys[1:]):
        fm, cm = mgr._maps[fine], mgr._maps[coarse]
        pg = mgr._probe_grid_for(levels[coarse])
        grid = build_stride_map(fm, cm, cm.tensor_stride, probe=pg)
        search = build_stride_map(fm, cm, cm.tensor_stride)
        if not torch.equal(grid, search):
            raise AssertionError(f"41: stride map {fine[0]}->{coarse[0]} differs")
        g_ms = cuda_ms(lambda: build_stride_map(fm, cm, cm.tensor_stride, probe=pg))
        s_ms = cuda_ms(lambda: build_stride_map(fm, cm, cm.tensor_stride))
        samples = fm.coordinates.float() + 0.5 * fm.tensor_stride[0]
        samples[:, 0] = fm.coordinates[:, 0].float()
        interp = lambda: mgr.interpolation_map_weight(levels[coarse], samples)  # noqa: E731
        ig = interp()
        cap, TM._MAX_GRID_CELLS = TM._MAX_GRID_CELLS, 0
        try:  # the interpolation map through the search
            isearch = interp()
            i_s_ms = cuda_ms(interp)
        finally:
            TM._MAX_GRID_CELLS = cap
        if not all(torch.equal(a, b) for a, b in zip(ig, isearch)):
            raise AssertionError(f"41: interpolation map on {coarse[0]} differs")
        i_g_ms = cuda_ms(interp)
        print(f"    stride {fine[0]}->{coarse[0]} ({fm.size} rows): {g_ms:.4f} / {s_ms:.4f} ms; "
              f"interpolation on {coarse[0]} ({len(samples)} samples x 8 corners): "
              f"{i_g_ms:.4f} / {i_s_ms:.4f} ms")


def dense_grid(dev, reuse):
    """Phase 41: the dense bbox grid on MinkUNet34's maps: the probe against
    the search, map by map, then the eager coordinate phase with the grid on
    and off, and the compiled replay at the grid floors."""
    start = time.perf_counter()
    init, raw, smi = reuse["unet_init"], reuse["raw"], reuse["smi"]
    coords, feats = collate(raw[0])
    recorder = unet_from(init, dev, False)
    x = MT.SparseTensor(feats.to(dev), coords.to(dev))
    with torch.no_grad():
        recorder(x)
    mgr = x.coordinate_manager

    print(f"[41 grid probe] phase 9's batch 0, {len(coords)} voxels; {smi}")
    probe_tables(mgr)

    def eager_phase(c, f):
        clock = CoordinateClock()
        with clock:
            xe = MT.SparseTensor(f, c)
            with torch.no_grad():
                recorder(xe)
        return xe.coordinate_manager, clock

    def grid_off(fn, *args):
        cap, TM._MAX_GRID_CELLS = TM._MAX_GRID_CELLS, 0
        try:
            return fn(*args)
        finally:
            TM._MAX_GRID_CELLS = cap

    fresh = [[scan(s), scan(s + 1)] for s in GRID_SEEDS]
    eager = []
    for i, scans in enumerate(fresh):
        c, f = (t.to(dev) for t in collate(scans))
        if i == 0:  # each mode's first use (its device constants) out of the count
            eager_phase(c, f)
            grid_off(eager_phase, c, f)
        on, clock_on = eager_phase(c, f)
        off, clock_off = grid_off(eager_phase, c, f)
        same_geometry(f"41 batch {i} grid off", off.export_geometry(), on)
        eager.append((c, f, on))
        print(f"  batch {i}: {len(c)} voxels; eager coordinate phase host ms / syncs: grid on "
              f"{clock_on.ms:.2f} / {clock_on.syncs}, grid off {clock_off.ms:.2f} / "
              f"{clock_off.syncs}; {len(on._row_grids)} row grids, "
              f"{sum(g.numel() for g in on._row_grids.values()) * 4 / 2**20:.1f} MiB")
        if clock_on.syncs > clock_off.syncs:
            raise AssertionError(f"41: the grid added host syncs ({clock_on.syncs} > {clock_off.syncs})")
    replayer = MT.GeometryReplayer(mgr)
    for s in WARM_SEEDS:
        replayer(collate([scan(s), scan(s + 1)])[0].to(dev))
    compiled = MT.CompiledReplayer(mgr).adopt(replayer)
    for i, (c, f, want) in enumerate(eager):
        (geo, fp, ok), ms, syncs = host_phase(lambda: compiled.run(c, f))
        if not ok or syncs != 1 or compiled.captures != 1:
            raise AssertionError(f"41 compiled replay: ok {ok}, syncs {syncs}, "
                                 f"captures {compiled.captures}")
        same_geometry(f"41 compiled batch {i}", geo, want)
        if any(p.grid_shape != compiled.grid_floors[k] for k, p in geo.dense_plans.items()):
            raise AssertionError("41: the compiled plans are not at the grid floors")
        print(f"  compiled replay with grids, batch {i}: {ms:.2f} ms host, {syncs} sync, one "
              f"graph, maps bit-equal to eager, {len(geo.dense_plans)} plans at the grid floors")
    del compiled, replayer, eager, mgr, recorder, x
    print(f"[41] {time.perf_counter() - start:.1f} s")


def step_inputs(dev):
    """What phase 42 (and ``tools/bf16_step_times.py``) needs of phases 9
    and 13, made from the same seeds: MinkUNet34's and MinkowskiFCNN's
    initial weights, phase 9's first batch of two scans with its labels,
    phase 13's first classification batch."""
    unet = MinkUNet34(3, 20, D=3, generator=torch.Generator().manual_seed(0), device=dev)
    fcnn = MinkowskiFCNN(3, CLASSES, generator=torch.Generator().manual_seed(0), device=dev,
                         **FCNN_WIDTHS)
    raw = [[scan(b) for b in range(BATCH)]]
    return dict(
        unet_init={k: v.detach().cpu().clone() for k, v in unet.state_dict().items()},
        fcnn_init={k: v.detach().cpu().clone() for k, v in fcnn.state_dict().items()},
        raw=raw, labels=[labels_for(0, len(collate(raw[0])[0]))],
        shape_batch=shapes(0, CoordinateTransformation()),
    )


PARTS = (("fwd", "K1 forward"), ("dx", "K1 input gradient"), ("dw", "K2 weight gradient"))


def redesign_table(rows):
    """Phase 42's and 44's rows as a markdown table, one line per distinct
    conv (K, Cin, Cout, rows in and out), each part's device ms the mean
    over its calls: new body / the ``mma.sync`` body, the bound, the new
    body's plan."""
    groups = {}
    for r in rows:
        groups.setdefault((r["K"], r["cin"], r["cout"], r["n_in"], r["n_out"]), []).append(r)
    lines = ["| conv (calls) | K1 fwd ms, new / mma.sync | K1 dX ms | K2 dW ms | bound ms, fwd / dX / dW"
             " | host µs | body tile ring S, fwd; dX; dW |",
             "| --- | --- | --- | --- | --- | --- | --- |"]
    for (K, cin, cout, n_in, n_out), rs in groups.items():
        def mean(p, key):
            return sum(r[p][key] for r in rs) / len(rs)
        parts = [p for p in ("fwd", "dx", "dw") if p in rs[0]]
        cell = {p: f"{mean(p, 'ms'):.4f} / {mean(p, 'mma_ms'):.4f}" if p in parts else "—"
                for p in ("fwd", "dx", "dw")}
        first = rs[0]
        lines.append(
            f"| K={K} {cin}→{cout}, {n_in}→{n_out} ({len(rs)}) | {cell['fwd']} | {cell['dx']} | "
            f"{cell['dw']} | " + " / ".join(f"{mean(p, 'bound_ms'):.4f}" for p in parts)
            + f" | {sum(mean(p, 'host_us') for p in parts) / len(parts):.0f} | "
            + "; ".join(f"{first[p]['body']} {first[p]['tile']} {first[p]['stages']} "
                        f"{first[p]['splits']}" for p in parts) + " |")
    return "\n".join(lines)


def expected_body(kernel, k_cin, k_cout, bf16):
    """The body the plan should choose for a call whose kernel sees Cin
    ``k_cin`` and Cout ``k_cout``: bf16 ``wgmma`` wherever Cin > 4 (K1's
    stem ``simt``, K2's ``stem_mma``); float32 K1 ``wgmma_3xtf32`` where
    both are multiples of 8, ``mma`` at other Cin > 4, ``simt`` below;
    float32 K2 ``mma`` at Cin > 4, ``simt`` below."""
    if k_cin <= 4:
        return "simt" if kernel is gather_gemm or not bf16 else "stem_mma"
    if bf16:
        return "wgmma"
    if kernel is conv_dw:
        return "mma"
    return "wgmma_3xtf32" if k_cin % 8 == 0 and k_cout % 8 == 0 else "mma"


def device_row(phase, net, call, bf16=True, parent=True, with_dw=None):
    """Phases 42-45: one conv call's parts (``kernel_parts``: bf16 forward,
    input gradient and weight gradient, or float32 K1's forward and input
    gradient, with ``with_dw`` K2's weight gradient too), each held to its
    plain version, two launches bit-equal, the body the plan chose
    (``expected_body``) with its tile, ring and split, and on the device
    alone (``device_ms``) its ms beside the plain version's (bf16: and the
    float32 instance's), with the bound and the wrapper's host µs; with
    ``parent`` the earlier bodies' ms too (``body=``: the ``mma.sync`` body,
    or the SIMT stem, at their own plans)."""
    x, w, g, in_idx, out_idx_t, label, with_dx = call
    K, cin, cout = w.shape
    row = dict(net=net, label=label, K=K, cin=cin, cout=cout, n_in=x.shape[0], n_out=g.shape[0])
    for p, (kernel, plain, args, args32, rtol, bound_ms, bound_by) in kernel_parts(
            x, w, g, in_idx, out_idx_t, with_dx, bf16, with_dw).items():
        tag = f"{phase} {net} {label} {p}"
        got = kernel(*args)
        plan = kernel.last_plan
        k_cin = args[1].shape[1] if kernel is gather_gemm else args[0].shape[1]
        k_cout = args[1].shape[2] if kernel is gather_gemm else args[1].shape[1]
        if plan.body != expected_body(kernel, k_cin, k_cout, bf16):
            raise AssertionError(f"{tag}: Cin {k_cin}, Cout {k_cout} took the {plan.body} body")
        if not torch.equal(got, kernel(*args)):
            raise AssertionError(f"{tag}: two launches differ")
        abs_err, rel = held(got, plain(*args), rtol, tag)
        del got
        ms, host_us = device_ms(lambda: kernel(*args))
        # K1: output rows x Cout per block; K2: Cin x Cout
        tile = ((plan.row_tile, plan.tile) if kernel is gather_gemm
                else (plan.cin_tile, plan.cout_tile))
        row[p] = dict(
            body=plan.body, tile=f"{tile[0]}x{tile[1]}", stages=plan.stages,
            splits=plan.splits,
            max_abs_err=abs_err, max_rel_err=rel, ms=ms, host_us=host_us,
            plain_ms=device_ms(lambda: plain(*args), graph=True)[0],
            bound_ms=bound_ms, bound_by=bound_by,
        )
        if bf16:
            row[p]["f32_ms"] = device_ms(lambda: kernel(*args32))[0]
        if parent:
            row[p]["mma_ms"] = device_ms(
                lambda: kernel(*args, body="simt" if k_cin <= 4 else "mma"))[0]
    parts = "  ".join(
        f"{p} {r['body']} {r['tile']} ring {r['stages']} S={r['splits']} "
        + "/".join(f"{r[k]:.4f}" for k in ("ms", "mma_ms", "f32_ms", "plain_ms") if k in r)
        + f" ms, bound {r['bound_ms']:.4f} ({r['bound_by']}), host {r['host_us']:.1f} us, "
        f"err {r['max_rel_err']:.1e}"
        for p in ("fwd", "dx", "dw") if p in row for r in (row[p],)
    )
    print(f"  {label:>9} K={K:<3} {cin:>4}->{cout:<4} rows {row['n_in']:>7}->"
          f"{row['n_out']:<7}  {parts}")
    return row


def redesign(phase, steps, bf16, with_dw=None):
    """Phases 42, 44 and 45: ``device_row`` on every call of each net's step
    in ``steps``, the table by distinct conv and each part's sums over the
    step.  Returns the rows."""
    start = time.perf_counter()
    columns = "new body / mma.sync body" + (" / float32 instance" if bf16 else "") + " / plain"
    rows = []
    for net, calls in steps.items():
        kind = "bf16" if bf16 else "float32 K1 and K2" if with_dw else "float32 K1"
        print(f"[{phase} {kind} bodies, {net} training-step maps] "
              f"{len(calls)} conv calls; device-only ms ({columns}), bound, the wrapper's host µs "
              "per call; the body, its tile (K1: rows x Cout, K2: Cin x Cout), ring and split S")
        net_rows = [device_row(phase, net, call, bf16, with_dw=with_dw) for call in calls]
        print(redesign_table(net_rows))
        for p, name in PARTS:
            got = [r[p] for r in net_rows if p in r]
            if got:
                print(f"  {net}, sum over one step, {name}: new body "
                      f"{sum(q['ms'] for q in got):.3f} ms, mma.sync body "
                      f"{sum(q['mma_ms'] for q in got):.3f} ms, "
                      + (f"float32 instance {sum(q['f32_ms'] for q in got):.3f} ms, " if bf16
                         else "")
                      + f"plain {sum(q['plain_ms'] for q in got):.3f} ms, bound "
                      f"{sum(q['bound_ms'] for q in got):.4f} ms; host "
                      f"{sum(q['host_us'] for q in got) / 1e3:.3f} ms")
        rows += net_rows
        calls.clear()
    print(f"[{phase}] {time.perf_counter() - start:.1f} s")
    return rows


def bf16_redesign(dev, reuse):
    """Phase 42: the bf16 bodies on every call of one bf16 MinkUNet34 and one
    MinkowskiFCNN training step, timed on the device alone beside the
    ``mma.sync`` bodies, the float32 instances and the plain versions
    (``redesign``).  Returns the rows."""
    return redesign(42, bf16_step_calls(dev, reuse), bf16=True)


def gen_bf16_launches(tag, n, convs):
    """Phase 43: a bf16 training step of a generative net with ``convs``
    sparse convs launches exactly 2 * convs - 1 K1 (every forward, every
    input gradient but the stem's) and ``convs`` K2, all bf16: the Cin = 1
    stem on the SIMT K1 body and K2's ``stem_mma``, every other call on
    ``wgmma``.  Returns the launches by body."""
    bodies = tuple({k: v for k, v in counts.items() if v}
                   for counts in (gather_gemm.bf16_body_launches, conv_dw.bf16_body_launches))
    want = ({"wgmma": 2 * convs - 2, "simt": 1}, {"wgmma": convs - 1, "stem_mma": 1})
    if (n["gather_gemm_bf16"], n["conv_dw_bf16"], n["gather_gemm"], n["conv_dw"]) != (
            2 * convs - 1, convs, 0, 0) or bodies != want:
        raise AssertionError(f"{tag}: launches {n}, by body {bodies}")
    return bodies


def flip_shares(tag, flips):
    """Phase 43: per level, the share of rows whose keep mask a float32 run
    held to the bf16 run's masks would have changed."""
    print(f"  {tag}: keep masks of a float32 run on the card held to the bf16 run's, rows that "
          "differ per level: " + ", ".join(
              f"level {level} {d}/{n} ({d / max(n, 1):.3%})" for level, d, n in flips))


def judge_bf16_levels(tag, card, cpu16, cpu64):
    """Per level of a generative decoder, the card's bf16 logits against the
    CPU float64 run on the same masks (``ForcedPruning``): coordinates
    equal, and the card within GRAD_FACTOR times the CPU plain path's bf16
    run's distance from the float64 run (at least one bf16 ulp, 2^-7), as
    phase 30 judges a bf16 step."""
    for level, (c, p, q) in enumerate(zip(card, cpu16, cpu64)):
        if not (torch.equal(c.C.cpu(), q.C) and torch.equal(p.C, q.C)):
            raise AssertionError(f"{tag}: level {level} coordinates differ")
        ref = q.F.detach().double()
        card64 = rel_diff(c.F.detach().cpu().double(), ref)
        cpu_d = rel_diff(p.F.detach().double(), ref)
        bnd = GRAD_FACTOR * max(cpu_d, K1_BF16_RTOL)
        print(f"  {tag} level {level}: {c.size} rows at stride {c.tensor_stride[0]}; logits "
              f"against float64: card bf16 {card64:.2e}, CPU bf16 {cpu_d:.2e}, bound {bnd:.2e}")
        if not card64 <= bnd:
            raise AssertionError(f"{tag}: level {level} logits disagree: {card64:.3e}")


def gen_bf16_calls(dev, batch, nets=("CompletionNet", "VAE")):
    """Phase 43d: every sparse conv call of one bf16 CompletionNet and one
    bf16 VAE training step on ``batch`` at the reference widths, from the
    seed-0 weights, captured with hooks as ``bf16_step_calls`` captures
    MinkUNet34's, in the compute dtype set (phase 43d sets bf16; phase 44
    takes CompletionNet's alone in float32)."""
    steps = {}
    for name, cls, widths, n, inputs, prefix in (
            ("CompletionNet", CompletionNet, GEN_WIDTHS, COMPLETION_CONVS, completion_input, "comp"),
            ("VAE", VAE, VAE_WIDTHS, VAE_CONVS, vae_input, "vae")):
        if name not in nets:
            continue
        model = cls(generator=torch.Generator().manual_seed(0), device=dev, **widths).train()

        def run():
            x, target = inputs(batch, dev)
            extra = dict(generator=torch.Generator(device=dev).manual_seed(0)) if cls is VAE else {}
            out = model(x, target, **extra)
            loss = vae_loss(out[0], out[1], out[3], out[4]) if cls is VAE else bce(out[0], out[1])
            loss.backward()

        steps[name] = step_calls(f"43d {name}", model, run, n, prefix)
        del model
    return steps


def generative_bf16(dev, launches, reuse):
    """Phase 43: CompletionNet and the VAE in bf16 at the reference widths.
    (a) bf16 CompletionNet training on phase 18's batches, counted, with the
    keep-mask flips of a float32 run held to the bf16 run's masks; (b) its
    parity on phase 20's small batch, the card and the CPU's bf16 and
    float64 runs held to the card's masks; (c) the VAE: training steps and
    generations on phase 19's batches, counted, its flips and its parity;
    (d) every K1 and K2 call of one bf16 step of each net on the device
    alone.  Returns (d)'s rows."""
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    batches, float32 = reuse["gen_batches"], reuse["gen_float32"]
    MT.set_compute_dtype(torch.bfloat16)
    try:
        # 43a. CompletionNet: a warm-up step and three timed steps
        net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev,
                            **GEN_WIDTHS).train()
        init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        opt = gen_sgd(net)
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            net.pruning = RecordedPruning()

            def one_step():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt.zero_grad()
                out_cls, targets, _ = net(*completion_input(batches[step], dev))
                loss = bce(out_cls, targets)
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
                return loss.item(), out_cls, time.perf_counter() - t0

            (loss, out_cls, secs), n = counted(launches, one_step)
            bodies = gen_bf16_launches(f"43a step {step}", n, COMPLETION_CONVS)
            rows, n_in = [c.size for c in out_cls], len(batches[step][0])
            print(f"[43a bf16 train completion] step {step}{' (warm-up)' if step == 0 else ''}: "
                  f"{n_in} voxels in, {secs * 1e3:.2f} ms (float32, phase 18: "
                  f"{float32['completion'][step][1] * 1e3:.2f}), {n_in / secs:.0f} voxels/s, loss "
                  f"{loss:.6f}, rows per decoder level {rows} (phase 18: "
                  f"{float32['completion'][step][0]}), bf16 launches {n['gather_gemm_bf16']} + "
                  f"{n['conv_dw_bf16']}, by body {bodies[0]} and {bodies[1]}")
            if {c.F.dtype for c in out_cls} != {torch.bfloat16} or not np.isfinite(loss):
                raise AssertionError(f"43a step {step}: logits {out_cls[0].F.dtype}, loss {loss}")
            if step == 0:
                first, masks = out_cls, net.pruning.masks
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {peak / 2**30:.2f} GiB (bf16) against "
              f"{float32['completion_peak'] / 2**30:.2f} GiB (float32, phase 18)")
        del net, opt, out_cls
        ref = CompletionNet(device=dev, **GEN_WIDTHS).train()
        ref.load_state_dict(init)
        ref.pruning = ForcedPruning(ref, (first, masks), "43a float32 on the bf16 masks")
        MT.set_compute_dtype(None)
        with torch.no_grad():
            ref(*completion_input(batches[0], dev))
        MT.set_compute_dtype(torch.bfloat16)
        flip_shares("43a CompletionNet, step 0", ref.pruning.flips)
        del ref, init, first
        torch.cuda.empty_cache()

        # 43b. CompletionNet parity on phase 20's batch, on the card's masks
        small = gen_batch(PARITY_SEED, PARITY_SHAPES, PARITY_RES)
        widths = dict(GEN_WIDTHS, resolution=PARITY_RES)

        def completion_run(model, device, dtype):
            partial, feats, full = small
            out_cls, targets, _ = model(*completion_input(
                (partial, feats.astype(np.float64) if dtype == torch.float64 else feats, full), device))
            loss = bce(out_cls, targets)
            loss.backward()
            return bf16_step_record(loss, model), out_cls

        net = CompletionNet(generator=torch.Generator().manual_seed(0), device=dev, **widths).train()
        net.pruning = RecordedPruning()
        small_init = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        card, card_cls = completion_run(net, dev, torch.bfloat16)
        card_masks = net.pruning.masks
        del net
        cpu = {}
        for dtype in (torch.bfloat16, torch.float64):
            t0 = time.perf_counter()
            MT.set_compute_dtype(torch.bfloat16 if dtype == torch.bfloat16 else None)
            cpu_net = CompletionNet(device="cpu", **widths).train()
            cpu_net.load_state_dict(small_init)
            if dtype == torch.float64:
                cpu_net.to(dtype)
            cpu_net.pruning = ForcedPruning(cpu_net, (card_cls, card_masks),
                                            f"43b CompletionNet CPU {dtype}")
            cpu[dtype] = completion_run(cpu_net, "cpu", dtype)
            print(f"[43b parity] CPU plain-path CompletionNet step, {dtype}, "
                  f"{len(small[0])} voxels: {time.perf_counter() - t0:.1f} s")
            del cpu_net
        MT.set_compute_dtype(torch.bfloat16)
        judge_bf16_levels("43b CompletionNet", card_cls, cpu[torch.bfloat16][1],
                          cpu[torch.float64][1])
        judge_bf16("43b CompletionNet parity", card, cpu[torch.bfloat16][0], cpu[torch.float64][0])
        del card_cls, cpu

        # 43c. the VAE: a training step and a generation per batch, counted
        vae = VAE(generator=torch.Generator().manual_seed(0), device=dev, **VAE_WIDTHS).train()
        vae_init = {k: v.detach().cpu().clone() for k, v in vae.state_dict().items()}
        opt = gen_sgd(vae)
        noise = torch.Generator(device=dev).manual_seed(0)

        def seeded(b):  # the same noise for a batch's calibration and its generation
            return torch.Generator(device=dev).manual_seed(100 + b)

        for b in range(2):
            torch.cuda.reset_peak_memory_stats()
            vae.decoder.pruning = RecordedPruning()

            def vae_step():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vae.train()
                opt.zero_grad()
                out_cls, targets, _, mean, log_var = vae(*vae_input(batches[b], dev),
                                                         generator=noise)
                loss = vae_loss(out_cls, targets, mean, log_var)
                loss.backward()
                opt.step()
                torch.cuda.synchronize()
                return loss.item(), out_cls, time.perf_counter() - t0

            (loss, out_cls, secs), n = counted(launches, vae_step)
            bodies = gen_bf16_launches(f"43c VAE step {b}", n, VAE_CONVS)
            rows, n_in = [c.size for c in out_cls], len(batches[b][2])
            f32_rows, f32_secs, f32_peak = float32["vae"][b]
            print(f"[43c bf16 VAE] batch seed {b}: training step {n_in} voxels, {secs * 1e3:.2f} ms "
                  f"(float32, phase 19: {f32_secs * 1e3:.2f}), loss {loss:.6f}, rows per decoder "
                  f"level {rows} (phase 19: {f32_rows}), bf16 launches {n['gather_gemm_bf16']} + "
                  f"{n['conv_dw_bf16']}, by body {bodies[0]} and {bodies[1]}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (phase 19: "
                  f"{f32_peak / 2**30:.2f})")
            if {c.F.dtype for c in out_cls} != {torch.bfloat16} or not np.isfinite(loss):
                raise AssertionError(f"43c VAE step {b}: logits {out_cls[0].F.dtype}, loss {loss}")
            if b == 0:
                first, masks = out_cls, vae.decoder.pruning.masks
            del out_cls
            calibrate(vae, lambda: vae(*vae_input(batches[b], dev), generator=seeded(b)))

            def generate():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    out_cls, _, out, _, _ = vae(*vae_input(batches[b], dev), generator=seeded(b))
                torch.cuda.synchronize()
                return ([c.size for c in out_cls], out.size, out.F.dtype, out.tensor_stride,
                        time.perf_counter() - t0)

            (rows, n_out, dtype, ts, secs), n = counted(launches, generate)
            print(f"[43c bf16 VAE] batch seed {b}: generation {secs * 1e3:.2f} ms, rows per decoder "
                  f"level {rows}, {n_out} voxels at stride {ts[0]}, {n['gather_gemm_bf16']} bf16 "
                  "gather_gemm launches")
            if (n["gather_gemm_bf16"] < VAE_CONVS or n["conv_dw_bf16"] or n["gather_gemm"]
                    or n["conv_dw"] or n_out == 0 or dtype != torch.bfloat16):
                raise AssertionError(f"43c VAE generation {b}: {n} launches, {n_out} voxels, {dtype}")
        del vae, opt
        ref = VAE(device=dev, **VAE_WIDTHS).train()
        ref.load_state_dict(vae_init)
        ref.decoder.pruning = ForcedPruning(ref.decoder, (first, masks), "43c float32 on the bf16 masks")
        MT.set_compute_dtype(None)
        with torch.no_grad():  # step 0's noise: the first draw of a generator seeded 0
            ref(*vae_input(batches[0], dev), generator=torch.Generator(device=dev).manual_seed(0))
        MT.set_compute_dtype(torch.bfloat16)
        flip_shares("43c VAE, step 0", ref.decoder.pruning.flips)
        del ref, vae_init, first
        torch.cuda.empty_cache()

        # the VAE's parity on phase 20's batch: a training step, the same
        # seeded noise, on the card's masks
        vae_widths = dict(VAE_WIDTHS, resolution=PARITY_RES)

        def vae_run(model, device, dtype):
            x, target = vae_input(small, device)
            out_cls, targets, _, mean, log_var = model(
                MT.SparseTensor(x.F.to(dtype), coordinate_map_key=x.coordinate_map_key,
                                coordinate_manager=x.coordinate_manager),
                target, generator=torch.Generator().manual_seed(1))
            loss = vae_loss(out_cls, targets, mean, log_var)
            loss.backward()
            return bf16_step_record(loss, model), out_cls, mean, log_var

        vae = VAE(generator=torch.Generator().manual_seed(0), device=dev, **vae_widths).train()
        vae.decoder.pruning = RecordedPruning()
        small_init = {k: v.detach().cpu().clone() for k, v in vae.state_dict().items()}
        card = vae_run(vae, dev, torch.float32)
        card_masks = vae.decoder.pruning.masks
        del vae
        cpu = {}
        for dtype in (torch.bfloat16, torch.float64):
            MT.set_compute_dtype(torch.bfloat16 if dtype == torch.bfloat16 else None)
            cpu_vae = VAE(device="cpu", **vae_widths).train()
            cpu_vae.load_state_dict(small_init)
            if dtype == torch.float64:
                cpu_vae.to(dtype)
            cpu_vae.decoder.pruning = ForcedPruning(cpu_vae.decoder, (card[1], card_masks),
                                                    f"43c VAE decoder CPU {dtype}")
            cpu[dtype] = vae_run(cpu_vae, "cpu", torch.float32 if dtype == torch.bfloat16 else dtype)
            del cpu_vae
        MT.set_compute_dtype(torch.bfloat16)
        for name, i in (("mean", 2), ("log-variance", 3)):
            ref64 = cpu[torch.float64][i].F.detach().double()
            card64 = rel_diff(card[i].F.detach().cpu().double(), ref64)
            cpu_d = rel_diff(cpu[torch.bfloat16][i].F.detach().double(), ref64)
            bnd = GRAD_FACTOR * max(cpu_d, K1_BF16_RTOL)
            print(f"  43c VAE encoder {name} against float64: card bf16 {card64:.2e}, CPU bf16 "
                  f"{cpu_d:.2e}, bound {bnd:.2e}")
            if not card64 <= bnd:
                raise AssertionError(f"43c VAE {name} disagrees: {card64:.3e}")
        judge_bf16_levels("43c VAE decoder", card[1], cpu[torch.bfloat16][1], cpu[torch.float64][1])
        judge_bf16("43c VAE parity", card[0], cpu[torch.bfloat16][0], cpu[torch.float64][0])
        del card, cpu
        torch.cuda.empty_cache()

        # 43d. every K1 and K2 call of one bf16 step of each net, device only
        steps = gen_bf16_calls(dev, batches[0])
        rows = []
        for net, calls in steps.items():
            print(f"[43d bf16 kernels, {net} training-step maps] {len(calls)} conv calls; "
                  "device-only ms (bf16 / float32 instance / plain), bound, the wrapper's host µs "
                  "per call; the body, its tile (K1: rows x Cout, K2: Cin x Cout), ring and split S")
            net_rows = [device_row(43, net, call, parent=False) for call in calls]
            for p, name in PARTS:
                got = [r[p] for r in net_rows if p in r]
                print(f"  {net}, sum over one bf16 step, {name}: bf16 "
                      f"{sum(q['ms'] for q in got):.3f} ms, float32 instance "
                      f"{sum(q['f32_ms'] for q in got):.3f} ms, plain "
                      f"{sum(q['plain_ms'] for q in got):.3f} ms, bound "
                      f"{sum(q['bound_ms'] for q in got):.4f} ms; host "
                      f"{sum(q['host_us'] for q in got) / 1e3:.3f} ms")
            rows += net_rows
            calls.clear()
        del steps
        torch.cuda.empty_cache()
    finally:
        MT.set_compute_dtype(None)
    print(f"[43] {time.perf_counter() - start:.1f} s")
    return rows


def f32_step_calls(dev, reuse):
    """Phase 44's calls: {net: [(x, w, g, in_idx, out_idx_t, label,
    with_dx)]} of one float32 training step of MinkUNet34 (phase 9's
    weights) on phase 9's first batch (two scans at 5 cm) and on two rooms
    at 2 cm (``ROOM2CM``, ~326k voxels), and of CompletionNet on phase 18's
    first batch (``gen_bf16_calls``)."""
    rooms = [room_scan_voxels(seed=s, **ROOM2CM) for s in range(2)]
    steps = {}
    for name, scans, labels in (("scan 5 cm", reuse["raw"][0], reuse["labels"][0]),
                                ("room 2 cm", rooms, None)):
        coords, feats = collate(scans)
        labels = labels_for(0, len(coords)) if labels is None else labels
        unet = unet_from(reuse["unet_init"], dev, True)
        steps[f"MinkUNet34 {name}"] = step_calls(
            f"44 MinkUNet34 {name}", unet,
            lambda: train_step(unet, None, coords, feats, labels, dev), MIN_LAUNCHES,
            name.split()[0])
        del unet
    steps.update(gen_bf16_calls(dev, gen_batch(0), nets=("CompletionNet",)))
    return steps


def f32_redesign(dev, reuse):
    """Phase 44: K1's float32 wgmma body on every call of one float32
    MinkUNet34 training step at 5 and 2 cm and one CompletionNet step, on
    the device alone beside the ``mma.sync`` body, the plain version and
    the bound (``redesign``).  Returns the rows."""
    rows = redesign(44, f32_step_calls(dev, reuse), bf16=False)
    torch.cuda.empty_cache()
    return rows


def ptv3_batch(seed=0):
    """Phase 45's batch: ``PTV3_ROOMS`` rooms at 2 cm (``ROOM2CM``, seeds
    0-2), each cropped to its ``PTV3_CROP`` voxels nearest a voxel drawn
    from ``seed`` (squared grid distance) and moved to a grid from 0, with
    6 normal feature channels and seeded labels: (coordinates with the
    batch index, features, labels)."""
    draw = np.random.RandomState(seed)
    coords = []
    for b in range(PTV3_ROOMS):
        vox = room_scan_voxels(seed=b, **ROOM2CM)[0][:, 1:]
        d = ((vox - vox[draw.randint(len(vox))]) ** 2).sum(1)
        keep = np.sort(np.argsort(d, kind="stable")[:PTV3_CROP])
        kept = vox[keep] - vox[keep].min(0)
        coords.append(np.concatenate([np.full((len(kept), 1), b, np.int32), kept], 1))
    coords = torch.from_numpy(np.concatenate(coords))
    feats = torch.randn(len(coords), 6, generator=torch.Generator().manual_seed(seed))
    return coords, feats, labels_for(seed, len(coords))


def ptv3_step_calls(dev, batch=None, **widths):
    """Phase 45's calls: {"PTv3": [(x, w, g, in_idx, out_idx_t, label,
    with_dx)]} of one float32 training step of ``PointTransformerV3``
    (seed-0 weights, published widths unless ``widths`` names others) on
    ``batch`` (``ptv3_batch()``), the order lists fixed, and the step's K1
    launches by body and K2 launches, which must be ``PTV3_K1_BODIES`` and
    ``PTV3_CONVS`` on the card."""
    coords, feats, labels = ptv3_batch() if batch is None else batch
    model = PointTransformerV3(generator=torch.Generator().manual_seed(0), device=dev,
                               **widths).train()
    orders = [[(s + i) % 4 for i in range(4)] for s in range(len(model.enc))]

    def run():
        x = MT.SparseTensor(feats.to(dev), coords.to(dev))
        loss = torch.nn.functional.cross_entropy(model(x, orders).F, labels.to(dev))
        loss.backward()

    zero_counts()
    gather_gemm.float32_body_launches.update(dict.fromkeys(gather_gemm.float32_body_launches, 0))
    calls = step_calls("45 PTv3", model, run, PTV3_CONVS, "ptv3")
    k1 = {k: v for k, v in gather_gemm.float32_body_launches.items() if v}
    if dev.type == "cuda" and (k1 != PTV3_K1_BODIES or conv_dw.launches != PTV3_CONVS):
        raise AssertionError(f"45 PTv3: K1 launches by body {k1}, K2 launches {conv_dw.launches}")
    print(f"[45 PTv3] {len(coords)} rows; one step launches K1 {k1} and K2 {conv_dw.launches}")
    del model
    return {"PTv3": calls}


def ptv3_redesign(dev):
    """Phase 45: K1 and K2 on every conv call of one float32 PTv3 training
    step on the benchmark cell's cropped 2 cm rooms, on the device alone
    beside the ``mma.sync`` body, the plain version and the bound
    (``redesign``).  Returns the rows."""
    rows = redesign(45, ptv3_step_calls(dev), bf16=False, with_dw=True)
    torch.cuda.empty_cache()
    return rows


def ptv3_attention_calls(dev, batch=None, **widths):
    """Phase 46's calls: [(label, qkv, plan, heads, scale, dout)] of each
    serialized attention call of one float32 training step of
    ``PointTransformerV3`` (seed-0 weights, published widths unless
    ``widths`` names others) on ``batch`` (``ptv3_batch()``), the order
    lists fixed; on the card the step must launch ``PTV3_BLOCKS`` forward
    and backward kernels."""
    coords, feats, labels = ptv3_batch() if batch is None else batch
    model = PointTransformerV3(generator=torch.Generator().manual_seed(0), device=dev,
                               **widths).train()
    orders = [[(s + i) % 4 for i in range(4)] for s in range(len(model.enc))]
    calls, original = [], serialized.attention

    def recording(qkv, plan, heads, scale):
        out = original(qkv, plan, heads, scale)
        c = qkv.shape[1] // 3
        call = [f"{len(calls):>2} {heads:>2}x{c // heads} {qkv.shape[0]:>6} rows "
                f"{plan.n_full}+{len(plan.short)} windows", qkv.detach().clone(), plan, heads,
                scale, None]
        calls.append(call)
        out.register_hook(lambda g: call.__setitem__(5, g.detach().clone()))
        return out

    serialized.attention = recording
    try:
        launched = (attn.attention.fwd_launches, attn.attention.bwd_launches)
        x = MT.SparseTensor(feats.to(dev), coords.to(dev))
        torch.nn.functional.cross_entropy(model(x, orders).F, labels.to(dev)).backward()
        launched = (attn.attention.fwd_launches - launched[0],
                    attn.attention.bwd_launches - launched[1])
    finally:
        serialized.attention = original
    if dev.type == "cuda" and launched != (PTV3_BLOCKS, PTV3_BLOCKS):
        raise AssertionError(f"46 PTv3: attention launches {launched}")
    print(f"[46 PTv3] {len(coords)} rows; one step launches the attention kernel {launched[0]} "
          f"times forward and {launched[1]} backward")
    del model
    return calls


def sdpa_ms(qkv, plan, heads, scale):
    """PyTorch's memory-efficient attention on the call's windows (the
    yardstick: the port does not call it): device-only ms of the forward and
    of the backward, the full windows in one call and each short one in its
    own, as the port called it before its kernel."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fn = torch.nn.functional.scaled_dot_product_attention
    packed = qkv.index_select(0, plan.rows)
    c = qkv.shape[1] // 3
    parts = []
    for first, windows, n in attn._segments(plan):
        t = packed[first:first + windows * n].view(windows, n, 3, heads, c // heads)
        parts.append([x.contiguous().requires_grad_(True) for x in t.permute(2, 0, 3, 1, 4)])
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        outs = [fn(q, k, v, scale=scale) for q, k, v in parts]
        grads = [torch.randn_like(o) for o in outs]
        fwd = device_ms(lambda: [fn(q, k, v, scale=scale) for q, k, v in parts])[0]
        bwd = device_ms(lambda: [torch.autograd.grad(o, qkv_, g, retain_graph=True)
                                 for qkv_, o, g in zip(parts, outs, grads)])[0]
    return fwd, bwd


def attention_row(label, qkv, plan, heads, scale, dout):
    """Phase 46: one attention call, forward and backward, held to the plain
    version in float64 and timed on the device alone beside the plain
    version, SDPA and the bound."""
    c = qkv.shape[1] // 3
    out, lse = attn._launch_forward(qkv, plan, heads, scale)
    grad = attn._launch_backward(qkv, out, lse, dout, plan, heads, scale)
    o64, l64 = attn.attention_forward_reference(qkv.double(), plan, heads, scale)
    g64 = attn.attention_backward_reference(qkv.double(), o64, l64, dout.double(), plan, heads,
                                            scale)
    errs = [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip((out, *grad.split(c, 1)), (o64, *g64.split(c, 1)))]
    del o64, l64, g64
    if max(errs) > ATTN_RTOL:
        raise AssertionError(f"46 {label}: output, dq, dk, dv off float64 by {errs}")
    squares = plan.n_full * plan.patch_size ** 2 + sum(n * n for n in plan.short)
    row = dict(label=label, err=max(errs), bound_ms=4 * squares * c / 495e12 * 1e3,
               ms=device_ms(lambda: attn._launch_forward(qkv, plan, heads, scale))[0],
               bwd_ms=device_ms(lambda: attn._launch_backward(qkv, out, lse, dout, plan, heads,
                                                               scale))[0],
               plain_ms=device_ms(lambda: attn.attention_forward_reference(qkv, plan, heads,
                                                                           scale), graph=True)[0],
               plain_bwd_ms=device_ms(lambda: attn.attention_backward_reference(
                   qkv, out, lse, dout, plan, heads, scale), graph=True)[0])
    row["library_ms"], row["library_bwd_ms"] = sdpa_ms(qkv, plan, heads, scale)
    print(f"  {label}: kernel {row['ms']:.3f} + {row['bwd_ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} + {row['plain_bwd_ms']:.3f}, SDPA {row['library_ms']:.3f} + "
          f"{row['library_bwd_ms']:.3f}, bound {row['bound_ms']:.4f} + {2.5 * row['bound_ms']:.4f}; "
          f"worst error {row['err']:.1e}")
    return row


def ptv3_attention(dev):
    """Phase 46: the 22 serialized attention calls of one float32 PTv3
    training step on the benchmark cell's cropped 2 cm rooms, each held to
    float64 and timed on the device alone (``attention_row``).  Returns the
    step's sums."""
    start = time.perf_counter()
    calls = ptv3_attention_calls(dev)
    print(f"[46 attention, PTv3 training-step windows] {len(calls)} calls; device-only ms, forward "
          "+ backward: the kernel, plain, PyTorch's memory-efficient attention, the bound")
    rows = []
    while calls:
        rows.append(attention_row(*calls.pop(0)))
        torch.cuda.empty_cache()
    sums = {k: sum(r[k] for r in rows) for k in
            ("ms", "bwd_ms", "plain_ms", "plain_bwd_ms", "library_ms", "library_bwd_ms", "bound_ms")}
    sums["err"] = max(r["err"] for r in rows)
    print(f"  PTv3, sum over one step: kernel {sums['ms']:.3f} + {sums['bwd_ms']:.3f} ms, plain "
          f"{sums['plain_ms']:.3f} + {sums['plain_bwd_ms']:.3f}, SDPA {sums['library_ms']:.3f} + "
          f"{sums['library_bwd_ms']:.3f}, bound {sums['bound_ms']:.4f} + "
          f"{2.5 * sums['bound_ms']:.4f} ms; worst error {sums['err']:.1e}")
    print(f"[46] {time.perf_counter() - start:.1f} s")
    return sums


def count_device_operations(fn):
    """The device operations (kernels, copies, memsets) that ``fn``
    launches, counted in a profiler trace."""
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    return len(profiling.device_operations(events))


def probe_routes(mgr, cache_key):
    """(kernel, plain, bound ms) of a cached forward kernel map: the kernel
    and the plain builds each return (in_idx, out_idx_t)."""
    in_k, out_k, ks, _, dil, rtype, _, _, _ = cache_key
    am, bm = mgr._maps[in_k], mgr._maps[out_k]
    offs = region_offsets_for(rtype, ks, dil, am.tensor_stride, None)
    offs = np.concatenate([np.zeros((len(offs), 1), np.int64), offs], 1)
    pa, pb = (mgr._probe_grid_for(MT.CoordinateMapKey(*k)) for k in (in_k, out_k))
    if pa is None or pb is None:
        raise AssertionError(f"47: kernel map {cache_key[:4]} has a map without a grid")

    def kernel():
        km = build_kernel_map(am, bm, offs, probe=pa, probe_out=pb)
        return km.in_idx, km.out_idx_t

    def plain():
        return (_build_in_idx_grid(pa, bm.coordinates, offs),
                _build_in_idx_grid(pb, am.coordinates, -offs))

    rows = am.size + bm.size
    bound_ms = (4 * len(offs) * rows + 4 * (am.dimension + 1) * rows) / HBM_BYTES_PER_MS
    return kernel, plain, bound_ms


def grid_probe_maps(dev, reuse):
    """Phase 47: the grid-probe kernel against its plain version on the
    kernel maps of one MinkUNet34 step at 5 cm and at 2 cm.  The step's own
    forward must build its 10 maps in 10 launches of the kernel (20 halves,
    none in plain ops or by the search); each map it built, and a rebuild
    through the kernel, are compared with the plain version.  Returns the
    2 cm step's sums."""
    start = time.perf_counter()
    rooms = [room_scan_voxels(seed=s, **ROOM2CM) for s in range(2)]
    print("[47 grid probe] the kernel maps a MinkUNet34 forward built, against the plain version "
          "(ATen ops); each map built again through the kernel (one launch) and the plain version: "
          "device-only ms, device operations, the bytes bound")
    sums = {}
    count_device_operations(lambda: torch.zeros(1, device=dev))  # the profiler's first session
    for name, scans in (("scan 5 cm", reuse["raw"][0]), ("room 2 cm", rooms)):
        coords, feats = collate(scans)
        net = unet_from(reuse["unet_init"], dev, False)
        x = MT.SparseTensor(feats.to(dev), coords.to(dev))
        routes, launches = dict(build_kernel_map.route_builds), GP.grid_probe.launches
        with torch.no_grad():
            net(x)
        launches = GP.grid_probe.launches - launches
        routes = {k: v - routes[k] for k, v in build_kernel_map.route_builds.items()}
        if launches != UNET_MAPS or routes != {"kernel": 2 * UNET_MAPS, "ops": 0, "search": 0}:
            raise AssertionError(f"47: the forward built its maps in {launches} kernel launches, "
                                 f"halves by route {routes}; want {UNET_MAPS} launches, "
                                 f"{2 * UNET_MAPS} kernel halves")
        mgr = x.coordinate_manager
        print(f"  MinkUNet34 {name}: {len(coords)} voxels; the forward: {launches} kernel launches, "
              f"halves by route {routes}; map (K, rows out): kernel ms / plain ms, operations "
              f"kernel / plain, bound ms")
        step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0, plain_ops=0, maps=0, err=0,
                    launches=launches)
        for ck in mgr._kernel_maps:
            if ck[6]:
                continue  # a transposed map: the swap of a forward map timed here
            km = mgr._kernel_maps[ck]
            kernel, plain, bound_ms = probe_routes(mgr, ck)
            want = plain()
            for got in ((km.in_idx, km.out_idx_t), kernel()):
                for g, w in zip(got, want):
                    if g.shape != w.shape:
                        raise AssertionError(f"47: kernel map {ck[:4]}: {tuple(g.shape)} against "
                                             f"the plain {tuple(w.shape)}")
                    if g.numel():
                        step["err"] = max(step["err"], int((g.long() - w.long()).abs().max()))
            ms, _ = device_ms(kernel)
            p_ms, _ = device_ms(plain)
            ops, p_ops = count_device_operations(kernel), count_device_operations(plain)
            print(f"    {str(ck[0][0]) + '->' + str(ck[1][0]):>22} k={ck[2][0]} "
                  f"(K={km.kernel_volume:<3}, {km.n_out:>6} rows): {ms:.4f} / {p_ms:.4f} ms, "
                  f"{ops} / {p_ops}, {bound_ms:.4f}")
            for k, v in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", bound_ms), ("ops", ops),
                         ("plain_ops", p_ops), ("maps", 1)):
                step[k] += v
        if step["maps"] != UNET_MAPS:
            raise AssertionError(f"47: {step['maps']} maps built, not {UNET_MAPS}")
        if step["err"]:
            raise AssertionError(f"47: a map differs from the plain version by {step['err']} rows")
        print(f"  MinkUNet34 {name}, a step's {step['maps']} maps: kernel {step['ms']:.4f} ms, "
              f"plain {step['plain_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms "
              f"({100 * step['bound_ms'] / step['ms']:.1f}% of the kernel's time); device "
              f"operations {step['ops']} against {step['plain_ops']}; largest |kernel - plain| "
              f"{step['err']}")
        sums = step
        del net, x, mgr
        torch.cuda.empty_cache()
    print(f"[47] {time.perf_counter() - start:.1f} s")
    return sums


def mask3d_step(dev):
    """Phase 48: one float32 Mask3D training step on the benchmark cell's
    first five rooms against the plain reference in float64 and float32,
    both held to the step's decisions."""
    from portbench import harness, tracing
    from portbench.reference import mask3d as R

    start = time.perf_counter()
    cell = harness.load_cell("mask3d.train.room2cm")
    cfg = cell["config"]
    traffic = harness.traffic_class(cell["kind"])(cell, 0, dev, tracing.Tracer(False))
    weights = harness.make_weights(R.parameter_spec(cfg), 0, dev)
    coords, feats, raw, inst, labels, scenes = (
        torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in traffic.inputs(0))
    model = MT.models.Mask3D(
        cfg["in_channels"], cfg["num_targets"], D=3, out_channels=cfg["out_channels"],
        sample_sizes=[cfg["sample_sizes"][h] for h in cfg["hlevels"]], device=dev).train()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
        model.decoder.pos_enc.gauss_B.copy_(traffic.gauss)
    crit = MT.models.SetCriterion(cfg["num_targets"], cfg["eos_coef"], device=dev)
    MT.utils.profiling.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = MT.SparseTensor(feats, coords, device=dev)
    rows = x.unique_index.to(dev).long()
    out = model(x, raw.index_select(0, rows), traffic.generator(0))
    loss, assign = crit(out, MT.models.InstanceTargets(inst.index_select(0, rows), labels, scenes))
    loss.backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = {k[5:]: v["count"] for k, v in MT.utils.profiling.counters().items()
             if k.startswith("sync.")}
    if syncs.get("match.costs") != 13:
        raise AssertionError(f"[48] {syncs.get('match.costs')} cost reads, not 13")
    port = {"loss": float(loss.detach()), "classes": out["pred_logits"].detach().double(),
            "masks": out["pred_masks"].detach().double(),
            "grads": {n: p.grad.double() for n, p in model.named_parameters()
                      if p.grad is not None}}
    held = {"fps": out["fps"], "attn": out["attn_masks"], "samples": out["samples"]}
    del model, crit, out, loss, x
    torch.cuda.empty_cache()

    def reference(dtype):
        p = {n: t.detach().to(dtype).clone().requires_grad_(True) for n, t in weights.items()}
        state = dict(p, **{n: t.to(dtype) for n, t in R.buffers(cfg, dev).items()})
        state["decoder.pos_enc.gauss_B"] = traffic.gauss.to(dev, dtype)
        rec = R.forward(cfg, state, coords, feats.to(dtype), raw.to(dtype), held)
        ref_loss, _, margin = R.criterion(cfg, rec, inst, labels, scenes, assign)
        ref_loss.backward()
        classes, masks = rec["predictions"][-1]
        got = {"loss": float(ref_loss.detach()), "classes": classes.detach().double(),
               "masks": masks.detach().double(), "fps_mismatch": rec["fps_mismatch"],
               "grads": {n: t.grad.double() for n, t in p.items() if t.grad is not None}}
        del rec, ref_loss, state, p
        torch.cuda.empty_cache()
        return got

    ref64, ref32 = reference(torch.float64), reference(torch.float32)

    def distance(a, b):
        rel = lambda x, y: float((x - y).abs().max() / y.abs().max().clamp_min(1e-300))  # noqa: E731
        leaves = sorted(rel(a["grads"][n], g) for n, g in b["grads"].items())
        return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                "logits": max(rel(a["classes"], b["classes"]), rel(a["masks"], b["masks"])),
                "grad_median": leaves[len(leaves) // 2], "grad_worst": leaves[-1]}

    ours, yard = distance(port, ref64), distance(ref32, ref64)
    print(f"[48 Mask3D, one training step on five 2 cm rooms] {len(coords):,} voxels, "
          f"{step_s * 1e3:.1f} ms (one eager step, host clock), peak {peak:.2f} GiB; "
          f"syncs {syncs}; FPS rows unequal to the reference's {ref64['fps_mismatch']}")
    print(f"  from float64: port {ours}; plain float32 {yard}")
    if ref64["fps_mismatch"]:
        raise AssertionError("[48] the port's FPS rows differ from the reference's")
    for k in ("loss", "logits"):
        if ours[k] > max(GRAD_FACTOR * yard[k], 1e-5):
            raise AssertionError(f"[48] {k} {ours[k]:.2e} from float64, float32 plain {yard[k]:.2e}")
    for k in ("grad_median", "grad_worst"):
        if ours[k] > GRAD_FACTOR * max(yard[k], 1e-6):
            raise AssertionError(f"[48] {k} {ours[k]:.2e} from float64, float32 plain {yard[k]:.2e}")
    print(f"[48] {time.perf_counter() - start:.1f} s")
    return {"ms": step_s * 1e3, "peak_gib": peak, **ours}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"[1 device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}"
    )
    cudart = MT.cudart_version()
    free, total = MT.get_gpu_memory_info()
    if not (cudart > 0 and 0 < free <= total and MT.diagnostics.get_device_memory_info()[1] == total):
        raise AssertionError(f"diagnostics: cudart_version {cudart}, memory free {free} of {total}")
    print(f"[1 device] cudart {cudart}, memory free {free:,} of {total:,} bytes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    path = build.library_path()
    build.library()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())

    launches = dict.fromkeys(KERNELS, 0)
    rows, real, synth_bwd, real_bwd, fcnn_bwd, reuse = segmentation_and_classification(dev, launches)
    gen_rows, completion_bwd, vae_bwd = generative(dev, launches, reuse)
    splat_bwd = splat_and_se(dev, launches)
    shim_bwd = data_loader_path(dev, launches)
    bf16_bwd = bf16_path(dev, launches, reuse)
    fresh = fresh_geometry(dev, launches, reuse)
    par_errs = parallel_path(dev, launches, reuse, fresh)
    example_errs = examples_path(dev, launches)
    high_errs, high_rows = high_dimensional(dev, launches)
    multi_errs = multi_process_examples(dev, launches)
    reuse["smi"] = smi
    dense_grid(dev, reuse)
    redesign = bf16_redesign(dev, reuse)
    gen16 = generative_bf16(dev, launches, reuse)
    f32_rows = f32_redesign(dev, reuse)
    ptv3_rows = ptv3_redesign(dev)
    attn_sums = ptv3_attention(dev)
    probe_sums = grid_probe_maps(dev, reuse)
    mask3d_step(dev)

    bwd = (synth_bwd + real_bwd + fcnn_bwd + gen_rows + completion_bwd + vae_bwd + splat_bwd
           + shim_bwd + high_rows)
    errors = {
        "gather_gemm": [r["max_abs_err"] for r in rows + real]
        + [r[p]["max_abs_err"] for r in bwd + f32_rows + ptv3_rows for p in ("fwd", "dx") if p in r]
        + par_errs["gather_gemm"] + example_errs["gather_gemm"] + high_errs["gather_gemm"]
        + multi_errs["gather_gemm"],
        "conv_dw": [r["dw"]["max_abs_err"] for r in bwd + ptv3_rows] + par_errs["conv_dw"]
        + example_errs["conv_dw"] + high_errs["conv_dw"] + multi_errs["conv_dw"],
        "gather_gemm_bf16": [r[p]["max_abs_err"] for r in bf16_bwd + redesign + gen16
                             for p in ("fwd", "dx") if p in r],
        "conv_dw_bf16": [r["dw"]["max_abs_err"] for r in bf16_bwd + redesign + gen16],
    }
    # per training step of MinkUNet34, MinkowskiFCNN, CompletionNet, the VAE,
    # MinkowskiSplatFCNN and the 7-D U-Net, on their real maps
    sums = step_sums(real_bwd + fcnn_bwd + completion_bwd + vae_bwd + splat_bwd + high_rows)
    # and per bf16 training step of MinkUNet34 and MinkowskiFCNN (phase 42)
    # and CompletionNet and the VAE (phase 43), on the device alone
    sums16 = step_sums(redesign + gen16)
    print("kernels line: the float32 entries' ms, plain_ms and bound_ms sum one training step each "
          "of MinkUNet34, MinkowskiFCNN, CompletionNet, the VAE, MinkowskiSplatFCNN and the 7-D "
          "U-Net (CUDA events); the bf16 entries' one bf16 training step each of MinkUNet34, "
          "MinkowskiFCNN (phase 42), CompletionNet and the VAE (phase 43), on the device alone")
    timing = {
        "gather_gemm": [a + b for a, b in zip(sums["fwd"], sums["dx"])],
        "conv_dw": sums["dw"],
        "gather_gemm_bf16": [a + b for a, b in zip(sums16["fwd"], sums16["dx"])],
        "conv_dw_bf16": sums16["dw"],
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max(errors[name]),
        "ms": timing[name][0],
        "plain_ms": timing[name][1],
        "bound_ms": timing[name][2],
        "bound_by": "operations" if 2 * timing[name][3] >= timing[name][2] else "bytes",
        "library_ms": None,  # no one PyTorch call gathers rows by a map and multiplies
    } for name, (source, replaces) in KERNELS.items()] + [{
        "name": "serialized_attention",
        "route": "cuda",
        "source": "minkowskiengine_tpu_torch/csrc/serialized_attention.cu",
        "replaces": None,  # the JAX package has no attention
        "launches": 2 * PTV3_BLOCKS,
        "max_rel_err": attn_sums["err"],
        "ms": attn_sums["ms"] + attn_sums["bwd_ms"],
        "plain_ms": attn_sums["plain_ms"] + attn_sums["plain_bwd_ms"],
        "bound_ms": 3.5 * attn_sums["bound_ms"],
        "bound_by": "operations",
        "library_ms": attn_sums["library_ms"] + attn_sums["library_bwd_ms"],
    }, {
        "name": "grid_probe",
        "route": "cuda",
        "source": "minkowskiengine_tpu_torch/csrc/grid_probe.cu",
        "replaces": None,  # the JAX package builds kernel maps in XLA ops
        "launches": probe_sums["launches"],
        "max_abs_err": probe_sums["err"],
        "ms": probe_sums["ms"],
        "plain_ms": probe_sums["plain_ms"],
        "bound_ms": probe_sums["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
