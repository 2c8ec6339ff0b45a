#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It imports torch and the port, never jax nor ``mxnet_tpu``, and:

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds every kernel of ``mxnet_tpu_torch/csrc`` with nvcc, one process
   per source, all at once (timed);
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at edge cases: flash decode (K5) and its
   fp8 instance (K5-fp8, on pools quantized by ``quant.rowwise_quantize``,
   f32 and bf16 queries; the fp8 read also against the f32 read, and the
   card's e4m3 cast against the CPU's, byte for byte), each in its
   "hopper" and "warp" forms, the row softmax (K1) in its "warp" and
   "block" forms, and flash attention forward (K3) and backward (K4)
   within stated tolerances (K3/K4 in f32 and bf16 at the LM's shape and at the hopper
   form's edges: D 128, ragged and cross lengths, external and internal
   delta; each case checks the form that ran: hopper, mma.sync for
   misaligned operands and D 100, fma for f32 and D 256; and the mma.sync
   form forced at the LM's shape), the fused optimizer update (K2)
   bitwise against the unfused per-parameter update and its plain
   version, in its "bucket" form and its "hopper" form (over one bucket,
   over the bucket's parameters as separate gradients at misaligned
   offsets and pointers, and over 300 of them: two pointer tables); the
   runtime-kernel
   API (K6,
   ``rtc.CudaKernel``) builds the user kernels of this script with nvcc
   (the first build and a cached reload timed) and holds them against
   their plain versions: (a) ``x * y + 1`` in f32 (also on a slice view)
   and bf16, (b) ``2x`` through the functional form and its cache, (c)
   the reference's rtc test (grid 1, block 10, shared memory), (d) the
   row softmax and its cross-entropy backward; a broken source raises
   with nvcc's message, a wrong signature before any build;
4. serves the transformer-LM at full width (6 layers, d_model 512, 8
   heads, 32k vocab, random weights from seed 0) through ``Engine``:
   warmup, then 16 requests; checks every request finished, that two of
   them served again alone give the same streams, that every greedy token
   is the argmax of a teacher-forced forward over the same tokens, that
   the pool drains, and that the kernel launched ``num_layers`` times per
   decode step, every launch in the hopper form; prints tokens/s, p50
   TTFT and the median decode-step time;
5. serves the same model and requests in ``bench.py``'s round-12
   configuration, chunked prefill (chunks of 64 tokens), twice: with f32
   pools (greedy tokens pass the teacher-forced check, the chunk count is
   the sum of ceil(prompt / 64), K5 launches ``num_layers`` times per
   decode step) and with ``kv_quant="fp8"`` (every request finishes, the
   pool drains, K5-fp8 launches ``num_layers`` times per decode step and
   K5 never, all in the hopper form, a greedy and a sampled request
   served again alone repeat
   their streams); prints tokens/s, p50 TTFT, the median decode-step
   time and the pools' bytes for both, five profiled decode steps of a
   full batch (device time by layer, idle share; phase 4 too), and how
   many greedy tokens of the fp8 run equal the f32 run's;
6. serves 8 requests sharing a 256-token prefix (32-token suffixes, 32
   new tokens, greedy, chunks of 64, fp8 pools) with the prefix cache and
   without: streams equal, at least 7 prefix hits, fewer chunks by the
   shared prefix; a cached run with ``defrag()`` halfway moves blocks,
   keeps the streams and passes ``check_tables()``; every K5-fp8 launch
   in the hopper form; prints both p50 TTFTs;
7. trains ResNet-50 at full width (depth 50, 3x224x224, 1000 classes,
   batch 64, f32; parameters drawn with numpy from seed 0 by the default
   initializer rule) through ``ShardedTrainer`` with SGD (lr 0.1,
   momentum 0.9, wd 1e-4), the guard and clip 5.0: one warm-up and 5
   timed steps on one fixed batch, then a step on a batch with a NaN;
   checks finite falling losses, a bitwise no-op on the NaN step, one K1
   launch (warp form) and one K2 launch per step, in the hopper form (its
   chunk plan: one table, every chunk on the 16-byte grid), and a
   bitwise fused-vs-unfused update from the same gradients that calls
   no ``torch.cat``; prints the median step time and images/s;
8. times each kernel with CUDA events (median, L2 flushed between
   launches) beside its plain version, a library yardstick and the
   card's bound for the same work, after the launch floor (an empty
   kernel); K5 and K5-fp8 at the served decode shape, the hopper and warp
   forms in turns and per call, beside a gather (and dequantization) plus
   ``F.scaled_dot_product_attention``; K1 in its warp and block forms
   and ``torch.softmax`` in turns, the block form at [8, 16384]; the
   decode sweep: contexts of 512-32768 positions (B 8) on f32, bf16 and
   fp8 pools, both forms in turns, GB/s and the share of the bytes
   bound, the yardstick up to 8192; K3 and K4 at the LM's shapes in
   f32 and bf16 (the hopper and the mma.sync forms in turns; the hopper
   form must be at least twice as fast) beside
   ``F.scaled_dot_product_attention`` (forward, and its backward alone),
   then bf16 causal at lengths 512-8192 with 16384 tokens (both forms,
   SDPA, bounds); K6 (d) at the MLP's [100, 10] beside
   ``torch.softmax`` and (a) at 64 M f32 elements beside
   ``torch.addcmul``; K2's hopper and bucket forms (the gather plus one
   launch a bucket) in turns beside ``torch.optim``'s fused SGD/Adam over
   the same tensors, at one bucket and at both training paths' updates
   (ResNet-50's 161 tensors, the LM's 101), each beside its bytes bound;
9. trains the transformer-LM at ``bench.py``'s LM-row settings (6
   layers, d_model 512, 8 heads, 32k vocab, batch 8, seq 2048, loss
   head, Adam lr 1e-3, ``compute_dtype="bfloat16"``; parameters drawn
   with numpy from seed 0) through ``ShardedTrainer``: one warm-up and 5
   timed steps on one fixed batch of numpy tokens (labels are the next
   tokens); checks a finite falling loss, K3 and K4 launched once per
   layer per step, all in the hopper form, the dense and blockwise
   attention paths never run,
   one K2 launch per step in the hopper form, and a bitwise
   fused-vs-unfused Adam update from the same gradients that calls no
   ``torch.cat``; prints the median step,
   tokens/s, the peak memory and one profiled step by layer;
10. runs the imperative API on the card (arithmetic and in-place ops with
    the version bump, a slice view written through to its parent,
    ``nd.dot``, a reduction, ``nd.save``/``nd.load`` byte for byte, seeded
    ``random.uniform`` replays), then trains ``models.mnist.mlp``'s body
    (784 -> 128 -> 64 -> 10, relu) with an ``NDArrayOp`` softmax loss head
    whose forward and backward push K6 (d), through ``simple_bind`` and
    ``optimizer.get_updater`` (SGD lr 0.1, momentum 0.9, rescale 1/100),
    batch 100, 2 epochs of 6,000 synthetic samples (10 class centres plus
    noise, numpy seed 0); checks the first batch against the same net
    with ``SoftmaxOutput`` (K1) within 1e-5, a finite falling loss,
    training accuracy > 0.9 and exactly one K6 forward and one K6
    backward launch per step; prints the median step and samples/s;
11. serves the same model with speculative decoding in ``bench.py``'s
    round-15 configuration (16 requests of 224 new tokens, prompts of
    4-32 tokens by its ``serve_request_set`` recipe, k 8, chunks of 16,
    256 blocks): (a) a greedy non-speculative baseline (K5, hopper form),
    (b) greedy n-gram speculation (no flash-decode launch, no decode step,
    the allocator audited after every step, every token within 1e-5 of
    the teacher-forced argmax, streams equal (a)'s but for counted true
    near-ties: both tokens within 1e-5 of the row's maximum logit; one
    request served again alone), (c) temperature 0.9, top-k 40 (every
    request finishes, one served again alone repeats its stream; the
    accept rate is printed, not gated), (d) greedy on fp8 pools against a
    non-speculative fp8 run (K5-fp8; the teacher-forced forward reads K
    and V through the same e4m3 quantization), (e) the model drafter with
    the target's own weights over a 256-token window (streams as in (b),
    accept rate >= 0.9, a compatible ``swap_draft_weights`` counted and a
    replay unchanged), (f) request 0 stopped after 40 tokens and adopted
    by a new engine (its stream equals (b)'s); prints tokens/s, p50 TTFT,
    the median step, tokens per step, the accept rate, the ratio to the
    baseline's tokens/s and five profiled steps of a full batch by layer;
12. runs the serving control plane on the same model at ``bench.py``'s
    control-plane geometry (256 blocks of 16, 4 slots, ``max_seq_len``
    128): (a) two replicas serve ``serve_request_set(16, 32, vocab)``
    clean, then with replica 0 crashing at step 16 (every request
    finishes, 0 tokens lost, the streams equal the clean fleet's, at least
    one failover, the allocators drain; median and maximum recovery ms)
    and five profiled router steps of two full replicas; (b) replica 1
    hangs at step 8 on a virtual clock (1 s a router step, heartbeat
    timeout 5 s) and is declared dead by the heartbeat, its requests'
    streams equal (a)'s; a lone engine poisons step 3: its victims finish
    ``error``, the pools hold no NaN, and the next requests reusing the
    scrubbed blocks decode as on a clean engine; (c) a hot
    ``rolling_swap`` of fresh copies of the weights after 16 steps (mode
    ``hot``, two swaps, streams unchanged; ``swap_ms`` and tokens/s
    against the clean run), a forbidden rebuild that raises and leaves
    the fleet as it was, and a rebuild (a changed key set) behind each
    replica's drain; (d) the canonical 10-minute diurnal gameday trace
    (seed 0) from one replica, autoscaling 1-3, clean, then with
    ``{0: crash@260, 1: hang@120, 2: poison@40}``, then its replay:
    scale-ups and scale-downs in both, failovers in the gameday, no KV
    leak, the gameday's streams equal the clean run's, and the replay's
    streams, scale schedule, shed set and failovers equal the gameday's
    (SLO figures printed beside ``bench.py``'s bars); (e) two speculating
    replicas with the model drafter (phase 11's geometry, 8 requests of 64
    new tokens): a crash at step 6 and a mid-stream draft swap of the
    same weights leave the streams the clean speculating fleet's, and
    equal to the non-speculative fleet's but for counted true near-ties.
    In every fleet the deaths are exactly the planted chaos points, by
    replica and cause: a planted crash dies of the injected
    ``ChaosError``, a planted hang through the heartbeat, each point is
    counted once in ``serve.chaos_injected``, and a fleet with nothing
    planted has no death and no failover (the router contains any
    exception a step raises, so a fault on the card fails here instead of
    passing for a crash).  Every flash-decode launch of the phase ran the
    hopper form on every replica, and no kernel was built after warmup;
13. runs the training loop, ``ShardedTrainer.fit``: (a) ResNet-50 through
    ``examples/train_model.py``'s flow at phase 7's width (``Xavier``,
    SGD momentum 0.9, wd 1e-4, ``FactorScheduler(4, 0.5)``, the guard and
    clip 5.0; 2 epochs of 8 batches of seeded images from an
    ``NDArrayIter``, 2 eval batches, ``Speedometer(64, 4)``,
    ``do_checkpoint``) under deterministic cuDNN: every step's placed
    batch has the host batch's exact bit sums, before and after the step
    (the check for a prefetch race), every step used the schedule's rate,
    the state (weights, momentum, moving statistics, guard counters)
    equals a bare ``step()`` loop's over the same batches bit for bit,
    the fused accuracy equals a host recount, fit's second epoch makes no
    more synchronizing calls outside its drains than 8 bare steps and
    none on its prefetch worker, the checkpoints reload bitwise, K1 launches once a training and an eval
    forward (warp form) and K2 once a step (hopper form); (b) the same
    for one epoch with ``MXNET_TPU_CHAOS`` planting a NaN batch and a
    pipeline crash: one skipped step, one prefetch retry, no batch lost,
    the state a bare loop's over the same wrapped batches; (c) the LM at
    phase 9's width, Adam under a warmup into a cosine decay, one epoch
    of 6 batches with a metric on the buffered path: exact bit sums, the
    metric equal to the host mean of fit's heads, the state bitwise a
    bare loop's, K3, K4 and K2 in the hopper form; no kernel is built;
    prints fit's ms a batch beside the bare loops' (both between events
    recorded after each batch) and phases 7 and 9's (host wall time,
    synced each step), the sync counts and the idle share of a profiled fit epoch;
14. runs the image-classification zoo and the legacy training API: (a)
    ``examples/train_imagenet.py``'s trainer (``ShardedTrainer``, SGD
    momentum 0.9, wd 1e-4, lr 0.01, ``compute_dtype="bfloat16"``,
    ``Xavier``, the guard) on alexnet, VGG-16, googlenet and inception-bn
    at phase 7's batch and image, 1000 classes, 8 steps each on one seeded
    batch under deterministic cuDNN: finite falling losses, a second
    trainer from the same seed bitwise equal (weights, momentum, moving
    statistics; Dropout's masks included), each Dropout mask of the first
    forward keeping 0.5 of its positions within 0.01, K1 once a forward
    (warp form) and K2 once a step per pointer table (hopper form), no
    synchronizing call in steps 2-8; prints each net's median ms a step
    (CUDA events), images/s and peak memory, and Inception-BN's profiled
    step by layer, its idle share and BatchNorm's share (the busy time
    that goes when BatchNorm's forward is an identity); (b)
    ``examples/train_cifar10.py --synthetic``'s flow
    (``train_model.fit``'s one-device branch, ``FeedForward.fit``) on
    inception-bn-28-small, batch 128, SGD lr 0.1 momentum 0.9 wd 1e-4,
    ``Speedometer(128, 4)``, 2 epochs of 8 batches of ``synthetic_cifar``
    images, 2 eval batches, ``do_checkpoint``, and ``Module.fit`` from
    the same parameters: both bitwise equal to a bare loop of executor
    ``forward``/``backward`` and ``get_updater``, the checkpoint reloads
    bitwise, K1 once a forward; prints the ms a batch of the three and the
    synchronizing calls a step (the LegacyGuard's one fetch); (c)
    ``BucketingModule`` over ``examples/lstm_bucketing.py``'s LSTM at its
    defaults, buckets 8 and 16 alternating over 6 batches: one array per
    parameter in both buckets, the state bitwise a bare loop's, a finite
    falling loss; (d) Deconvolution (groups, bias, a target needing an
    adjustment of the stride), bilinear UpSampling (the bound weight and
    the resize), LRN, L2Normalization, Crop, LeakyReLU and the
    regression heads on the card against the CPU, forward and backward,
    within ``TOL["float32"]``; no kernel is built;
16. runs long training on the card (after phase 14, before 15): (a)
    phase 9's LM with fp8 linears (``quant="fp8"``: cuBLAS's fp8 GEMM
    through ``quant.block_dot``), a recompute scope a block
    (``remat=True``), 2 microbatches a step (``grad_accum``) and dynamic
    loss scaling (fp8's default), 8 steps on one batch: a finite falling
    loss, each step K3 launched 24 times (6 layers, 2 microbatches,
    forward and recompute), K4 12, K2 once, all in the hopper form, the
    fp8 GEMMs the shapes call for and no upcast product; a batch poisoned
    through ``MXNET_TPU_CHAOS`` (overflow) is a bitwise no-op that halves
    the scale and counts one overflow; two steps make no synchronizing
    call; the first loss within 0.25 of the
    same net's without fp8 (the JAX package's bound); a step's peak
    memory lower with the scopes than without; ``block_quantize`` on the
    card byte for byte the CPU's and ``block_dot`` against its plain
    version at the LM's shapes, a ragged one and the e5m2 x e5m2 pair
    (the upcast route); ``grad_accum`` 2 against 1 in f32 within the JAX
    package's bound; one profiled step by layer; (b) ``fit`` over 2
    epochs of 4 batches with a ``CheckpointManager`` (keep 2) saving each
    epoch in the background: launches as in (a), a new trainer resumed
    from epoch 1 by ``restore_or_initialize`` bitwise equal to the
    uninterrupted run (weights, Adam moments, loss scale and good streak,
    counters, update count), a save making one synchronizing call
    (its snapshot) and retention keeping two steps, a forced sentinel
    rollback restoring the checkpoint bitwise, a SIGTERM mid-epoch that
    saves and stops ``fit`` and a resume that finishes the epoch bitwise,
    and a flipped byte caught by its checksum with the shard's name;
    (c) the trained weights published with ``save_model`` and served by
    ``Engine.from_checkpoint`` (phase 4's configuration): greedy streams
    equal an engine's from the parameter dict, K5 in the hopper form; a
    2-replica ``Router.rolling_swap`` from the path is hot and keeps the
    streams; (d) ``OnlineLoop`` over 2 rounds at phase 12's geometry:
    rollouts, selection, trainer steps, a publish and a hot swap a round,
    the fleet serving the trainer's weights after; no kernel is built;
    prints the median step ms, tokens/s, peak memory, the snapshot, write
    and restore ms and the checkpoint's bytes;
17. runs the program layer (after phase 16, before 15): (a) phase 4's
    model through an eager engine and a captured one (``warmup``: every
    bucket a captured CUDA graph, a second ``warmup`` all memory hits):
    phase 4's requests give the same greedy streams, every step of the
    captured engine replays a program and none is captured after
    warmup, K5 launches ``num_layers`` times a decode step in the hopper
    form, and a ``profiler.trace`` around two replayed decode steps
    (after one traced and discarded) lists K5's kernel ``num_layers``
    times a step; a hot swap keeps the
    programs and gives an engine's streams built from the new weights; a
    poisoned step runs eagerly and is caught; then phase 5's fp8 pools
    and phase 11's n-gram speculation the same way; (b) phase 9's LM and
    phase 7's ResNet-50 (deterministic cuDNN), each an eager and a
    compiled trainer: ``compile()`` leaves the state bitwise, 8 (4)
    replayed steps equal the eager ones bit for bit with equal launch
    counts, step 1's heads survive, ``profile_step`` of both; ``fit``
    over 4 batches replays fit's accuracy step each batch; a Dropout
    net's program runs eagerly with its reason; (c) ``Module.compile()``
    on inception-bn-28-small and ``BucketingModule.compile([8, 16])``
    over phase 14's LSTM, bitwise their eager twins; (a)-(c) build no
    kernel; (d) two processes with one fresh ``MXNET_TPU_CACHE_DIR``:
    the first builds the two kernels its FC trainer runs (K1, K2), the
    second builds none and lists the first one's program key;
18. runs data parallelism in one process (after phase 17, before 15),
    under deterministic cuDNN: (a) phase 7's ResNet-50 (batch 64,
    224x224, f32, SGD momentum 0.9, wd 1e-4, the guard, clip 5.0)
    through ``ShardedTrainer(mesh=data_parallel_mesh())`` for 4 steps,
    bitwise phase 7's plain trainer over the same batches (weights,
    momentum, moving statistics, guard state), K2 once a step in the
    hopper form; (b) the same net with ``grad_compression="int8"``
    (error feedback on by default): the fused update runs K2's bucket
    form over the reduced buckets (one launch a bucket a step) and the
    state (residuals included) is bitwise the same run's unfused; (c)
    ``shard_optimizer=True`` (ZeRO), bitwise (a); steps 2-4 of (a)-(c)
    make no synchronizing call; prints each run's ms a step (CUDA
    events); (d) phase 14's CIFAR net through ``FeedForward`` and
    ``Module`` over ``[gpu(0), gpu(0)]`` with the ``device`` kvstore,
    each bitwise a bare loop of two executors whose gradients are summed
    by hand and stepped by the same updater (each executor keeps its own
    BatchNorm statistics; fit averages them at the epoch's end); (e)
    ResNet-50's 161 gradients pushed and pulled over two members on the
    card with each compression (161 co-resident reductions a flush,
    exact) and ``psum_compressed`` over the two: exact on integer-valued
    data for None and bf16, within the analytic bound for int8 and fp8;
    (f) where two cards exist, (a) and (b) over ``data_parallel_mesh(2)``
    (NCCL between the cards) against the one-card run; with one card it
    prints that (f) did not run and why; no kernel is built;
19. runs input records, the deployment predictor and the last three ops
    (after phase 18, before 15), under deterministic cuDNN; it first
    prints whether cv2 imports (without it the ``.jpg`` runs are left
    out and it says so): (a) packs 512 seeded 256x256 images with an
    ``.idx`` as ``.raw`` and ``.jpg`` and at 224x224 as ``.raw``,
    through the native record engine (``csrc/recordio.cc``, built with
    g++; a failed build fails the phase with the compiler's output),
    writes the same records again and reads every file back through both
    engines, in turns (the files byte for byte equal, the records
    equal), and prints both engines' write and read seconds with the
    card's name and power limit; times
    ``ImageRecordIter`` alone (shuffle, random crop, mirror, 8 decode
    threads) over each 256 form; runs phase 7's ResNet-50 trainer's
    ``fit`` over the 224 ``.raw`` records (8 batches through
    ``DevicePrefetchIter``), bitwise a twin's ``fit`` over an
    ``NDArrayIter`` of the same arrays (weights, momentum, moving
    statistics, guard), then over the ``.jpg`` records with
    augmentation; steps 2-8 make no more synchronizing calls outside
    fit's drains than bare steps, none on the prefetch worker; K1 and K2
    once a step (warp, hopper); prints ms a batch, images/s and the
    share of each epoch spent waiting on the prefetcher; (b) saves the
    weights as a legacy prefix and a ``CheckpointManager`` directory:
    ``predictor.create`` from each gives outputs bitwise an executor's
    forward, one K1 launch (warp) a forward, replayed from a captured
    program with no kernel built; prints the median forward ms of the
    Predictor and the executor; ``export_model`` of the same net is
    served on the card by a process that imports torch and not the port,
    within 1e-4 (relative), 1e-5 of the Predictor (K1's plain version
    against K1); prints the artifact's bytes and its forward ms; (c) trains
    ``examples/lstm_ocr.py``'s net at its sizes (20 columns of 16, 4
    labels, 11 classes, 64 hidden, batch 32, Adam) for 20 steps on the
    card and on the CPU from the same weights and batches (losses within
    1e-6 relative), holds WarpCTC's forward and gradient on the card to
    the CPU's, and times the recursion beside ``F.ctc_loss`` (a
    yardstick); (d) runs ``examples/rcnn_detection.py``'s detector
    (RPN, ``Proposal``, ``ROIPooling``, head; batch 8) forward and
    backward on the card against the CPU, and ``Proposal`` alone: the
    CPU's selection on the same inputs, with no synchronizing call; and
    ``ROIPooling`` at a Fast R-CNN head's size (256 rois x 512 channels x
    7x7 bins over 38x63), forward and backward within 12 GiB, its first
    rois against the CPU;
20. runs tensor and model parallelism in one process (after phase 19,
    before 15): (a) phase 9's LM (f32) bound through ``simple_bind``
    with ``group2ctx``, the embedding on the host (``cpu(0)``) and the
    blocks and head on the card, one forward and backward a step against
    the same executor wholly on the card (outputs within 1e-5, gradients
    within 1e-5 of the step's largest gradient magnitude: the
    embedding's scatter-add sums on the host), one crossing forward and
    one back a step; prints ms a step beside the one-device executor's;
    (b) phase 9's trainer (bf16, Adam, unfused) over a ``{"data": 1,
    "model": 1}`` mesh with ``megatron_rules()``: the recorded plan is
    split for every Megatron parameter, K3 and K4 launch once a layer a
    step in the hopper form, and 2 steps' heads and parameters are
    bitwise those of the trainer without rules (deterministic
    algorithms); (c) where two cards exist, the split plan over
    ``{"data": 1, "model": 2}`` (4 heads a member) against one card's
    first heads and update, and ``MakeLoss(sum(...))`` over
    ``data_parallel_mesh(2)`` against one card; with one card it prints
    that (c) did not run and why; no kernel is built;
21. runs mixture of experts and ring attention (after phase 20, before
    15): (a) ``MoEFFN`` (8 experts of hidden 2048, top-2 at capacity
    factor 1.5, the aux head) over ``[2, 2048, 512]`` (4096 tokens at
    the LM's width) with a ``LinearRegressionOutput`` head, 3 SGD steps
    in f32 (TF32 off) through ``ShardedTrainer`` on the card and on the
    host from the same weights and batches: every token's experts equal
    (a flip prints its margin), heads within 1e-4 of their largest
    magnitude, each parameter's update within 5e-2 of its largest
    magnitude and at most 1 % of its elements beyond 1e-4 of it (a
    pre-activation at ReLU's kink may fall on the other side); then
    top-1 (Switch); prints ms a step and
    the peak memory; (b) ``ring_self_attention`` over a ``{"seq": 1}``
    mesh of the card at the LM's attention shape (B 8, H 8, L 2048, d
    64, bf16), causal and not: the forward bitwise the same K3 call of
    ``flash_attention_stats`` (one ring step merges with an empty
    carry), held against ``flash_attention`` (prints whether bitwise),
    gradients within 1e-2 of their largest magnitude of
    ``flash_attention``'s, K3 and K4 one launch a call each in the
    hopper form (K4 with the ring's ``delta``), no dense attention;
    prints forward-and-backward ms beside ``flash_attention``'s; (c)
    where two cards exist, phase 9's LM trainer over ``{"seq": 2}`` and
    (a)'s MoE over ``{"expert": 2}`` against one card; with one card it
    prints that (c) did not run and why; no kernel is built;
22. runs pipelines (after phase 21, before 15), under deterministic
    algorithms: (a) phase 9's LM through ``PipelineTrainer(num_stages=4,
    devices=[card] * 4)`` (the automatic balance, Adam unfused, bf16),
    2 steps from the same weights and batches as ``ShardedTrainer`` on
    the card: at one microbatch heads and parameters bitwise the
    trainer's; at 4 heads within 5e-2 and the first update within 2.5 lr;
    each stage holds at most ``4 - s`` live microbatches (1F1B); K3
    launches 2 M 6 times a step (forward and remat) and K4 M 6 times,
    all in the hopper form, K2 never; prints ms a step and the step's
    peak memory beside the trainer's; (b) ``dryrun_multichip``'s MLP
    (24/16/12 -> 10, batch 8) through ``PipelineTrainer`` over 4 stages
    on the card within 2e-5 of ``ShardedTrainer`` (K1 2 M times a step,
    from the last stage's forward and remat), ``SpmdPipelineTrainer`` at
    one pipe member (one member run a step, bitwise ``PipelineTrainer``)
    and ``pipeline_apply`` over ``{"pipe": 1}`` (bitwise the stage); (c)
    where two cards exist, the LM through ``PipelineTrainer`` over both,
    ``SpmdPipelineTrainer`` and ``pipeline_apply`` over ``{"pipe": 2}``,
    each against one card; with one card it prints that (c) did not run
    and why; (d) where four cards exist, phase 9's LM trainer over
    ``{"model": 2, "seq": 2}`` with ``megatron_rules()`` (the split plan,
    each model coordinate's seq group running the ring over its 4 heads)
    for 3 steps from the same weights and batches as one card: the first
    heads within 5e-2 and the first update within 2.5 lr, as phase 20
    (c) holds two cards, K3 and K4 launched; prints each step's heads'
    distance and ms; with fewer cards it prints that (d) did not run
    and why; no kernel is built;
23. runs the multi-process tier (after phase 22, before 15), each child
    a fresh interpreter (``python3 chip_smoke.py --dist-worker JOB
    DIR``: torch, numpy and the port only, ``PYTHONPATH`` set to this
    script's directory, its output in a log in ``DIR`` that the phase
    prints on a failure; every child under a time limit, past which all
    of them are killed and the phase fails naming the role): (a)
    ``launch_local`` starts 1 scheduler, 2 servers and 2 workers on the
    card; the workers push integer values (a 3x3 key and a 2 MiB key,
    above ``BIGARRAY_BOUND``, striped over both servers) through the
    ``test`` optimizer on the servers and pull the closed form bitwise,
    over ``dist_sync`` and then in a second cluster over ``dist_async``
    (the closed form counts each push applied once); (b) in (a)'s sync
    cluster, phase 7's ResNet-50 through ``FeedForward.fit`` (SGD on
    the servers, 3 batches of 32 a worker, each worker its contiguous
    half of one seeded data set, deterministic cuDNN): both workers'
    parameters bitwise equal, and within 1e-5 (bitwise so far) of this
    process's sum of the two halves' gradients under the same host SGD;
    K1 once a batch a worker; prints ms a batch, the host share (the
    training thread inside push and pull), bytes pushed and pulled a
    batch; (c) phase 9's LM through ``ShardedTrainer`` over a data mesh
    of 2 processes, one member each on the card, over gloo (asserted),
    3 Adam steps on each process's rows of the global batch: the ranks'
    parameters bitwise equal; each rank's loss within 2e-4 of this
    process's one-card run on the global batch, at most 5 % of the
    parameters beyond 1e-4; K3 and K4 6 times a step and K2 once a step
    a rank, all hopper; then, in the same processes, a BatchNorm net
    (f32, 64 x 1024 -> 1024 -> BatchNorm -> 1000, a softmax head and a
    global sum head, 3 SGD steps; the first process's rows shifted):
    the ranks' parameters and moving statistics bitwise equal, each
    within 1e-3 of its one-card move from the one-card run, the heads
    within 1e-4 relative, K1 and K2 once a step a rank (the limits sit
    between the sound readings and planted faults',
    ``tools/torch_collective_faults.py``); prints ms a step
    beside the one-process step and the bytes reduced a step; where two
    cards exist, again with one process on each card over NCCL; with
    one it says so; the children's launches count in the kernel line;
24. runs the multi-process tier, part two (after phase 23, before 15),
    children as in phase 23, under deterministic algorithms: (a) three
    ranks over gloo on the card, each ``init_distributed(watchdog=...)``
    with ``MXTPU_WATCHDOG`` at a probed port, a beat every 0.5 s and 2.5
    s of silence to a verdict, the default ``on_failure``: a hung rank
    (phase 9's LM over a data mesh of the three processes, batch 6;
    rank 2 freezes itself with SIGSTOP after 2 steps and the others
    block in step 3's all-reduce), a dead rank (rank 2 exits while the
    ranks idle) and a dead monitor (rank 0 exits): every survivor exits
    70 within 2.5 + 4 s of the fault, its log naming the dead rank (its
    ``on_death`` line too, but for the monitor's death), the monitor's
    flight dump names it; prints each case's seconds from the fault to
    each survivor's exit; (b) ``tools/torch_launch.py -n 4 -s 0
    --launcher local`` starts a membership cluster: worker 0 binds
    ``ElasticTrainer`` (ZeRO) on the card and takes 8 steps of phase 9's
    LM; worker 1 kills itself at step 3 (``MXNET_TPU_CHAOS=
    worker_kill:3``) and the trainer waits for that in the view: the
    epoch bumps, every update completes, the mesh stays at one member
    (generation 1, no resize), the heads and final parameters are
    bitwise a plain ``ShardedTrainer`` (ZeRO) on the same weights and
    batches, and no kernel library is built after step 1; prints ms a
    step beside the plain trainer's; (c) a child with
    ``install_preemption_hook(et.save_now, exit_after=True)`` gets
    SIGTERM inside update 4 (the point it reports): the save lands at
    the step's end, the child exits 143, and a fresh ``ShardedTrainer``
    here restored from it takes 2 steps bitwise the uninterrupted
    run's; (d) where two cards exist, the LM with ZeRO through
    ``ElasticTrainer`` over both, resized 2 -> 1 -> 2, 2 steps a
    segment, each segment bitwise a fresh trainer restored from the
    resize's snapshot, no step lost, no kernel built, with drain,
    restore and pause ms; with one card it prints why (d) did not run;
    the children's launches count in the kernel line;
25. runs the analysis tooling on the card (after phase 24, before 15):
    (a) phase 9's LM at full width and batch, cut to 2 layers, compiled
    (its step a captured CUDA graph, captured inside the window) and
    stepped 4 times from a ``DevicePrefetchIter``, an async
    ``CheckpointManager`` saving its CUDA parameters after every step and
    the flight recorder recording, all under
    ``analysis.audit_threads(instrument_framework=True)``: the report is
    clean with events and at least 2 threads, every checkpoint restores
    byte-identical to the tensors at its ``save()`` (the next step's K2
    writes them in place), K2, K3 and K4 launched; (b)
    ``analysis.run_schedules(device="cuda")`` over the six scenarios, 2
    seeds each: the routers capture their programs and replay decode
    steps with K5, every stream byte-identical to the single-threaded
    reference on the card, no failure; prints runs, preemptions and
    seconds a scenario; (c) ``tools/torch_staticcheck.py gate --json`` as
    a child process: exit 0, ``ok``; prints the K2-K5 launches it adds;
26. runs the program auditor on the card (after phase 25, before 15):
    (a) phase 9's LM at full width (Adam, bf16 compute) compiled under
    ``analysis.audit_on_compile()``: both captured programs (``train``,
    ``train_acc``) audit with no error, every fused bucket at 1 read and
    1 write, the K2-K4 notes of each recorded (captured) iteration equal
    to the launches its capture counted, backward ops and K4 notes in the
    trace (the recorder reaches autograd's thread); then
    ``analysis.audit_trainer``: no error, 1 read / 1 write, its notes
    equal to the launches of its eager runs; 2 replayed steps bitwise an
    unaudited twin's heads and state (deterministic algorithms on); (b)
    phase 7's ResNet-50 step (batch 64, SGD with momentum, guard, clip)
    the same, with one K1 and one K2 note; (c) the serving engine
    (``ENGINE_KW``) on fp8 and on plain pools warmed up under the
    observers: every program clean, each decode program's KV reads 1
    byte (fp8) or 4 (plain) an element, audited at
    ``expect_kv_itemsize=1`` clean on fp8 and firing
    ``program.hbm-bytes`` on plain pools (the positive control), K5 and
    K5-fp8 notes equal to the captures' launches; the compressed wire
    audit needs two distinct cards and is logged as not run; (d)
    ``tools/torch_staticcheck.py audit --json`` on the card and ``gate
    --json`` on the host as child processes: exit 0, 1 read / 1 write;
    ``compile_cache.observer_errors`` stays 0 and no observer stays
    registered; prints each part's seconds and the launches it adds;
27. runs the tuned conv backward, the C predict API and the last tools
    (after phase 26, before 15): (a) ``ops.conv_backward._conv2d_bwd``
    under ``MXNET_TPU_CONV_BWD=tuned`` against cuDNN's backward on one
    ResNet-50 shape of each family (stem 7x7 s2, 1x1 s1, 1x1 s2, 3x3 s2,
    3x3 s1) at batch 64 in bf16 and f32, within
    ``tools/torch_conv_probe.py``'s bounds, and the probe's times of those
    shapes; (b) phase 7's ResNet-50, one step under tuned and one under
    the default from the same weights and batch (cuDNN deterministic):
    parameters and moving statistics within rtol 1e-4, atol 1e-6, the
    tuned backward run by exactly the restructured convolutions, one K1
    and one K2 launch a step, then three timed steps of each; (c) the C
    predict API built with g++ (``_build.build_c_predict``) and its pure-C
    driver serving phase 19 (b)'s ResNet-50 artifact on the card (the
    default device), within ``EXPORT_TOL`` of the Predictor, its forward
    median beside phase 19's Python-served one; (d)
    ``tools/torch_im2rec.py`` (list, then two workers) packs a folder of
    24 PNGs that ``ImageRecordIter`` reads back (labels and pixel sums),
    and ``tools/torch_ckpt_inspect.py`` shows, verifies and diffs a
    checkpoint written from CUDA tensors; no kernel is built in the phase;
28. runs ``ShardedTrainer`` over meshes that span processes (after phase
    27, before 15): two ranks on the card over gloo (two processes are
    distinct members even on one card), children as in phase 23: (a)
    phase 9's LM (bf16, Adam, unfused) under ``megatron_rules()`` over
    ``{"model": 2}`` across the ranks for 2 steps: the split plan for
    every Megatron parameter, 4 heads a member, K3 and K4 once a layer a
    step on each rank in the hopper form, the ranks' replicated
    parameters bitwise equal, the first heads within 5e-2 and the first
    update within 2.5 lr of the one-card run (phase 20 (c)'s limits);
    ms a step beside one card's and the bytes that cross processes a
    step by axis; (b) the LM with ZeRO over ``{"data": 2}`` across the
    ranks for 2 steps, then ``save_state`` (each rank its slices, rank 0
    the manifest), restored here into a one-card ZeRO trainer bitwise
    (parameters, Adam moments, update count, seed), verified by
    ``tools/torch_ckpt_inspect.py``; the write ms;
15. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
    "device": {...}}`` line.

It exits non-zero, printing no result, when CUDA is not available or the
port is not beside it, and on any failed check.  ``--dist-worker JOB
DIR`` is the child program of phases 23, 24 and 28 (``kv-sync``,
``kv-async`` in every role of a ``launch_local`` cluster, ``lm`` as a
rank of a process group; ``wd-hung``, ``wd-dead``, ``wd-monitor`` as a
rank with the watchdog on, ``el-chaos`` in every role of a
``tools/torch_launch.py`` cluster, ``el-sigterm`` alone) and of phase 28
(``pm`` as a rank of a process group), which reads the sizes the parent
wrote to ``DIR/plan.json``.

``python3 chip_smoke.py --serve-ab PARENT`` measures what a change to the
port costs the serving loop: it runs phases 4 and 11 alone (after the
build) over the port in ``PARENT``, a checkout of an earlier commit, and
over this checkout's, in the turns parent, change, change, parent, and
prints each turn's tokens/s and median step times as a JSON line between
two card lines.  (``--serve-only ROOT`` is one such turn.)
``python3 chip_smoke.py --telemetry-cost`` runs the same two phases once
with every call into the telemetry plane timed, and prints the host
seconds inside those calls against the seconds inside ``Engine.step``.
"""
import atexit
import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

# ---------------------------------------------------------------------------
# Card constants (NVIDIA H100 SXM data sheet, dense, at the 700 W limit)
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # bf16 on the tensor cores
FP8_FLOP_PER_S = 1979e12        # fp8 on the tensor cores

TOL = {"float32": 2e-5,         # summation order only
       "bfloat16": 1e-2}        # summation order + one bf16 rounding of out
# K1 against its plain version: the online rescale of the running sum
# changes only the last bits of an f32 probability
K1_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# K1's warp form takes rows of up to 1024 columns (one warp a row)
K1_WARP_COLS = 1024
# the two forms of flash decode (K5, K5-fp8), the main path's first
DECODE_FORMS = ("hopper", "warp")

# serving configuration: bench.py's transformer-LM default at full width
VOCAB, LAYERS, D_MODEL, HEADS = 32000, 6, 512, 8
ENGINE_KW = dict(heads=HEADS, block_size=16, num_blocks=520, max_batch=8,
                 max_prompt_len=512, max_seq_len=1024)
N_REQUESTS, NEW_TOKENS = 16, 64
SAMPLED = {3: 0.8, 7: 1.0, 11: 0.7}      # request index -> temperature
# bench.py's round-12 serve row (prefill_chunk=16 at prompts of at most
# 64): chunks of 64 keep a prompt of at most 512 to 8 chunks
R12_CHUNK = 64
# the fp8 read against the f32 read at the engine's decode shape
FP8_READ_TOL = 0.05
# prefix-cache phase: 8 requests share one prefix
PREFIX_LEN, SUFFIX_LEN, PREFIX_REQUESTS, PREFIX_NEW = 256, 32, 8, 32
# speculative decoding (phase 11): bench.py's round-15 speculate row
# (bench.py:1439-1445) at the serving model's full width: 16 requests of
# 224 new tokens, prompts drawn by bench.py's serve_request_set recipe
# (RandomState(1), lengths randint(4, 33), tokens randint(1, vocab)); a
# 32-token prompt plus 224 new tokens fills max_seq_len 256 exactly
SPEC_KW = dict(heads=HEADS, block_size=16, num_blocks=256, max_batch=8,
               max_prompt_len=64, max_seq_len=256, prompt_bucket_min=16,
               prefill_chunk=16)
SPEC_K, SPEC_REQUESTS, SPEC_NEW = 8, 16, 224
SPEC_TEMP, SPEC_TOPK = 0.9, 40
# a greedy divergence between two engines is a true near-tie when both
# tokens lie within this of the row's maximum teacher-forced logit
SPEC_TIE = 1e-5
# the model drafter: the target's own weights over the whole context
SPEC_WINDOW, SPEC_MIN_ACCEPT = 256, 0.9
# request 0 is stopped after this many tokens and adopted by a new engine
SPEC_ADOPT_AT = 40

# the serving control plane (phase 12): bench.py's control-plane rows
# (failover bench.py:1291-1347, hot swap :1351-1420) on phase 4's model:
# 2 replicas, serve_request_set(16, 32, vocab) with seed=i per request
CP_KW = dict(heads=HEADS, block_size=16, num_blocks=256, max_batch=4,
             max_queue=64, max_prompt_len=64, max_seq_len=128,
             prompt_bucket_min=16)
CP_REQUESTS, CP_NEW = 16, 32
CP_CRASH_STEP = max(4, CP_NEW // 2)     # mid-decode, streams in flight
CP_SWAP_STEPS = max(4, CP_NEW // 2)
# (b): replica 1 hangs at this step, declared dead on a virtual clock
# advanced 1 s a router step; a lone engine poisons one step
CP_HANG_STEP, CP_HEARTBEAT_MS, CP_POISON_STEP = 8, 5000.0, 3
# (d) the canonical 10-minute diurnal gameday (bench.py:903-1060): its
# trace (:934-939) at vocab 32,000 and seed 0, one replica to start,
# autoscaling 1-3 with :962-965's policy, 1.5 virtual s a router step,
# chaos mid-ramp by engine step (:1003-1005)
GAMEDAY_TRACE = dict(seed=0, duration_s=600.0, base_rate=0.3,
                     diurnal_period_s=600.0, burst_hazard_per_s=1.0 / 240.0,
                     burst_duration_s=45.0, burst_multiplier=2.0,
                     vocab=VOCAB, sys_prompt_min=12, sys_prompt_max=20,
                     max_turns=3, prompt_min=4, prompt_max=24, output_min=6,
                     output_max=16, context_budget=60, think_min_s=2.0,
                     think_max_s=20.0)
GAMEDAY_POLICY = dict(min_replicas=1, max_replicas=3, interval_s=15.0,
                      high_queue=3.0, low_queue=0.5, breach_polls=2,
                      cooldown_up_s=45.0, cooldown_down_s=120.0)
GAMEDAY_CHAOS = {0: {"serve_crash": {260}}, 1: {"serve_hang": {120}},
                 2: {"serve_poison_logits": {40}}}
GAMEDAY_STEP_S, GAMEDAY_SHED_QUEUE, GAMEDAY_HEARTBEAT_MS = 1.5, 20, 30e3
# bench.py's SLO bars for the gameday rows (set on a CPU host): printed
# beside the card's figures, not gated on
GAMEDAY_BARS = {"clean": (4000.0, 150.0, 0.10),
                "gameday": (6000.0, 200.0, 0.25)}
# (e) speculation under the router: phase 11's geometry, 8 of its
# requests with 64 new tokens, the model drafter with the target's own
# weights, replica 0 crashing at this step
CP_SPEC_REQUESTS, CP_SPEC_NEW, CP_SPEC_CRASH = 8, 64, 6

# training configuration: __graft_entry__.entry's ResNet-50
DEPTH, CLASSES, IMAGE, BATCH = 50, 1000, (3, 224, 224), 64
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CLIP, TIMED_STEPS, N_BUCKETS = 5.0, 5, 25
K1_SHAPES = [(64, 1000), (8, 10), (3, 16384), (37, 1001)]
K2_LEN = 1003 + 3 * 1048576               # three full buckets' worth + odd

# LM training configuration: bench.py's LM row (bench_lm, batch 8, seq
# 2048, loss head, Adam lr 1e-3, bf16 compute) at full width and depth
LM_BATCH, LM_SEQ = 8, 2048
LM_OPT = {"learning_rate": 1e-3}

# the training loop (phase 13): examples/train_model.py's fit over phase
# 7's model and batch: 8 train and 2 eval batches an epoch, 2 epochs, the
# rate halving every 4 updates, Speedometer(64, 4); chaos plants a NaN
# batch and a pipeline crash; the LM fits one epoch of 6 batches with a
# 2-update warmup into a 6-update cosine decay
LOOP_BATCHES, LOOP_EVAL_BATCHES, LOOP_EPOCHS = 8, 2, 2
LOOP_SCHEDULE = dict(step=4, factor=0.5)
LOOP_FREQUENT = 4
LOOP_CHAOS = "nan:2|crash:5"
LM_LOOP_BATCHES, LM_LOOP_WARMUP, LM_LOOP_COSINE = 6, 2, 6
# K3/K4 against their plain versions: f32 as tests/test_flash_attention.py
# (forward and lse 2e-5, gradients 2e-4: summation order); bf16 within
# 2e-2 of 1 + |plain| (p and ds are rounded to bf16 inside, and a value on
# a rounding boundary may round either way after an f32 summation-order
# difference: up to two bf16 units in the last place of the result)
K34_TOL = {"fwd": 2e-5, "bwd": 2e-4, "bf16_rel": 2e-2}
# K3/K4 cases of phase 3, each run in f32 (always the "fma" form) and
# bf16, where ``form`` is the form kernel_form must pick (or, with
# ``force``, the one passed as ``form=``).  The hopper form's edges: D
# 128, lengths that are not a multiple of its 128-row and 64-row tiles,
# non-causal cross lengths, an external and the internal delta (every
# case without ``ext``); misaligned operands and D 100 stay "mma"
K34_CASES = [dict(name=n, layout=lay, B=b, H=h, Lq=lq, Lk=lk, D=d,
                  causal=c, form=f, **kw)
             for n, lay, b, h, lq, lk, d, c, f, kw in [
    ("LM shape", "blhd", 8, 8, 2048, 2048, 64, True, "hopper", {}),
    ("LM shape, mma.sync form", "blhd", 8, 8, 2048, 2048, 64, True, "mma",
     dict(force=True)),
    ("non-causal", "bhld", 2, 4, 512, 512, 64, False, "hopper", {}),
    ("cross Lq 256 Lk 768", "blhd", 2, 4, 256, 768, 64, False, "hopper", {}),
    ("D 128", "blhd", 2, 4, 512, 512, 128, True, "hopper", {}),
    ("D 256", "blhd", 2, 2, 512, 512, 256, True, "fma", {}),
    ("D 100", "bhld", 1, 3, 256, 256, 100, False, "mma", {}),
    ("external delta", "bhld", 2, 4, 512, 512, 64, True, "hopper",
     dict(ext=True)),
    ("ragged L 192", "blhd", 2, 4, 192, 192, 64, True, "hopper", {}),
    ("ragged cross Lq 200 Lk 328", "bhld", 2, 4, 200, 328, 64, False,
     "hopper", {}),
    ("D 128 ragged cross Lq 320 Lk 200, external delta", "blhd", 1, 4, 320,
     200, 128, False, "hopper", dict(ext=True)),
    ("misaligned", "blhd", 1, 2, 256, 256, 64, True, "mma",
     dict(misaligned=True)),
]]
# the zoo and the legacy API (phase 14): examples/train_imagenet.py's
# trainer on the four ImageNet nets at phase 7's batch and image (bf16
# compute, SGD momentum 0.9, wd 1e-4, the guard) for 8 steps at lr 0.01;
# examples/train_cifar10.py --synthetic's FeedForward flow on
# inception-bn-28-small (batch 128, 2 epochs of 8 batches, 2 eval
# batches); examples/lstm_bucketing.py's BucketingModule at its defaults
# over 6 batches alternating its buckets
ZOO_NETS = ("alexnet", "vgg", "googlenet", "inception-bn")
ZOO_STEPS = 8
ZOO_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
ZOO_DROPOUT_TOL = 0.01           # a Dropout mask's kept share against 0.5
CIFAR_IMAGE, CIFAR_BATCH = (3, 28, 28), 128
CIFAR_BATCHES, CIFAR_EVAL_BATCHES, CIFAR_EPOCHS = 8, 2, 2
CIFAR_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CIFAR_FREQUENT = 4
LSTM = dict(num_hidden=64, num_embed=32, vocab=16, batch=16)
LSTM_BUCKETS, LSTM_BATCHES = (8, 16), 6
LSTM_OPT = {"learning_rate": 0.5, "momentum": 0.9}
# (d): the new ops on CUDA tensors against the same ops on CPU tensors;
# the Deconvolution's target (34, 34) from 16x16 needs an adjustment of
# 2, the stride
ZOO_OP_CASES = [
    ("Deconvolution", dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                           num_filter=8, num_group=2, no_bias=False,
                           target_shape=(34, 34)), {"data": (4, 6, 16, 16)}),
    ("UpSampling", dict(scale=2, sample_type="bilinear", num_args=2,
                        num_filter=6), {"data": (4, 6, 16, 16)}),
    ("UpSampling", dict(scale=3, sample_type="bilinear"),
     {"data": (4, 6, 16, 16)}),
    ("LRN", dict(nsize=5, alpha=1e-4, beta=0.75, knorm=1),
     {"data": (8, 96, 27, 27)}),
    ("L2Normalization", dict(mode="channel"), {"data": (4, 8, 12, 12)}),
    ("Crop", dict(offset=(2, 3), h_w=(9, 10)), {"data": (4, 6, 16, 16)}),
    ("LeakyReLU", dict(act_type="prelu"), {"data": (4, 6, 16, 16)}),
    ("LeakyReLU", dict(act_type="elu", slope=0.3), {"data": (4, 6, 16, 16)}),
    ("LinearRegressionOutput", {}, {"data": (32, 10), "label": (32, 10)}),
    ("LogisticRegressionOutput", {}, {"data": (32, 10), "label": (32, 10)}),
    ("MAERegressionOutput", dict(grad_scale=2.0),
     {"data": (32, 10), "label": (32, 10)}),
]
# long training runs (phase 16): phase 9's LM with fp8 linears, a
# recompute scope a block and 2 microbatches a step (dynamic loss scaling
# is fp8's default), 8 steps on one batch; the JAX package holds its fp8
# LM's mean loss within 0.25 of the f32 one's (tests/test_quant.py:214)
LONG_ACCUM, LONG_STEPS, LONG_OVERFLOW_AT = 2, 8, 4
FP8_LOSS_TOL = 0.25
# block_dot's fp8 GEMM against its plain version on the same payloads:
# each product of two fp8 values is exact in f32, but Hopper's tensor
# cores sum fp8 products in an accumulator that keeps about 14 bits
# (DeepSeek-V3's report, section 3.3.2; measured on an H100: up to
# 9.95e-05, 1.6 x 2^-14, of the terms' magnitude with
# use_fast_accum=False): 4 x 2^-14 of the magnitude, the sum over the
# block's terms of |a| |b| times the scales; the blocks add in f32
FP8_DOT_TOL = 2.0 ** -12
FP8_DOT_CASES = [  # name, a [M, K], b [N, K], formats
    ("q/k/v/proj forward", (8192, 512), (512, 512), ("e4m3", "e4m3")),
    ("ffn1 forward", (8192, 512), (2048, 512), ("e4m3", "e4m3")),
    ("ffn2 forward", (8192, 2048), (512, 2048), ("e4m3", "e4m3")),
    ("ffn1 dx", (8192, 2048), (512, 2048), ("e5m2", "e4m3")),
    ("ffn1 dw", (2048, 8192), (512, 8192), ("e5m2", "e4m3")),
    ("ragged M 100 N 72 K 300", (100, 300), (72, 300), ("e4m3", "e5m2")),
    ("backward-only e5m2 x e5m2", (256, 512), (384, 512), ("e5m2", "e5m2")),
]
# (b): fit over 2 epochs of 4 batches, a save each epoch, 2 kept; (d):
# the online loop at phase 12's geometry, 2 rounds of 8 rollouts
LONG_EPOCHS, LONG_BATCHES, LONG_KEEP = 2, 4, 2
ONLINE_ROUNDS, ONLINE_ROLLOUTS, ONLINE_NEW, ONLINE_SEQ = 2, 8, 16, 64
ONLINE_STEPS = 2
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def decode_inputs(torch, np, *, seed, B, H, hd, BS, nblk, npool, lengths,
                  dtype, q_dtype=None, trash_rows=()):
    """Paged decode operands on the card: random pools, distinct random
    blocks per row, rows in ``trash_rows`` padded as the engine pads them
    (table of trash slots, length 1)."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(npool, BS, H, hd).astype(np.float32))
    tables = np.zeros((B, nblk), np.int32)
    lens = np.asarray(lengths, np.int32).copy()
    for b in range(B):
        if b in trash_rows:
            lens[b] = 1
            continue
        used = -(-int(lens[b]) // BS)
        tables[b, :used] = rng.choice(np.arange(1, npool), used,
                                      replace=False)
    dev = torch.device(DEVICE)
    return (q.to(dev, q_dtype or dtype), kp.to(dev, dtype),
            vp.to(dev, dtype), torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev))


def kernel_cases(torch, np):
    rng = np.random.RandomState(7)
    eng = dict(B=8, H=8, hd=64, BS=16, nblk=64, npool=520)
    ragged = rng.randint(1, 64 * 16 + 1, size=8)
    spec = dict(eng, nblk=SPEC_KW["max_seq_len"] // SPEC_KW["block_size"],
                npool=SPEC_KW["num_blocks"])
    spec_lens = rng.randint(4, SPEC_KW["max_seq_len"] + 1, size=8)
    spec_lens[0] = SPEC_KW["max_seq_len"]          # a full table
    return [
        ("engine shapes, 8 splits", dict(eng, lengths=ragged),
         torch.float32, None),
        ("split 1", dict(eng, lengths=ragged), torch.float32, 1),
        ("3 splits over 20 columns", dict(eng, nblk=20,
                                          lengths=rng.randint(1, 321, 8)),
         torch.float32, 3),
        ("length-1 trash rows", dict(eng, lengths=ragged,
                                     trash_rows=(5, 6, 7)),
         torch.float32, None),
        ("bf16 q and pool", dict(eng, lengths=ragged), torch.bfloat16, None),
        ("f32 q, bf16 pool", dict(eng, lengths=ragged, q_dtype=torch.float32),
         torch.bfloat16, None),
        # phase 11's geometry: max_seq_len 256 of 16-position blocks, a
        # 256-block pool, lengths 4-256, the automatic plan
        ("phase 11 shapes", dict(spec, lengths=spec_lens), torch.float32,
         None),
        ("phase 11 shapes, length-1 trash rows",
         dict(spec, lengths=spec_lens, trash_rows=(6, 7)), torch.float32,
         None),
    ]


def phase_kernel_vs_plain(torch, np, fd):
    """K5 against its plain version on every case in both forms (every
    case's operands are aligned, so kernel_form picks the hopper form)."""
    errs = {}
    for i, (name, kw, dtype, split_k) in enumerate(kernel_cases(torch, np)):
        args = decode_inputs(torch, np, seed=100 + i, dtype=dtype, **kw)
        check(fd.kernel_form(args[1], args[2]) == "hopper",
              f"{name}: kernel_form picked {fd.kernel_form(*args[1:3])}")
        ref = fd.flash_decode_attention_ref(*args, split_k=split_k)
        for form in DECODE_FORMS:
            out = fd.flash_decode_attention(*args, split_k=split_k,
                                            form=form)
            torch.cuda.synchronize()
            label = f"{name}, {form}"
            check(out.dtype == ref.dtype and out.shape == ref.shape,
                  f"{label}: kernel gave {out.dtype}{tuple(out.shape)}, "
                  f"plain {ref.dtype}{tuple(ref.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{label}: non-finite kernel output")
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(out.dtype).replace("torch.", "")]
            log(f"  kernel vs plain [{label}]: max_abs_err {err:.3e} "
                f"(tol {tol:g})")
            check(err <= tol, f"{label}: kernel disagrees with its plain "
                  f"version: max_abs_err {err} > {tol}")
            errs[(name, form)] = err
    return errs


def quantize_pool(quant, kv, pool):
    """One fp8 ``QuantPool`` layer of a [NB, BS, H, hd] pool: an e4m3 row
    and an f32 scale per cached position, as the engine writes them."""
    nb, bs = pool.shape[:2]
    pay, sc = quant.rowwise_quantize(
        pool.reshape((nb * bs,) + tuple(pool.shape[2:])), "e4m3")
    return kv.QuantPool(pay.reshape(pool.shape), sc.reshape(nb, bs))


def phase_fp8_vs_plain(torch, np, fd, quant, kv):
    """K5-fp8 against its plain version on K5's cases with the pools
    quantized (f32 and bf16 ``q``, tolerance by ``q``'s type), in both
    forms; the fp8
    read against the f32 read on the same pools at the engine's shapes
    (64 columns, lengths up to 1024: a short read averages the rounding
    of few positions, a length-1 row is one position's rounding); the
    card's e4m3 cast against the CPU's, byte for byte."""
    errs, read_err = {}, 0.0
    cases = [c for c in kernel_cases(torch, np) if c[2] == torch.float32]
    for i, (name, kw, _, split_k) in enumerate(cases):
        q, kp, vp, tables, lens = decode_inputs(
            torch, np, seed=100 + i, dtype=torch.float32, **kw)
        kq, vq = quantize_pool(quant, kv, kp), quantize_pool(quant, kv, vp)
        check(fd.kernel_form(kq, vq) == "hopper",
              f"K5-fp8 {name}: kernel_form picked {fd.kernel_form(kq, vq)}")
        outs = {}
        for q_dtype, form in [(d, f) for d in (torch.float32, torch.bfloat16)
                              for f in DECODE_FORMS]:
            qx = q.to(q_dtype)
            out = fd.flash_decode_attention(qx, kq, vq, tables, lens,
                                            split_k=split_k, form=form)
            ref = fd.flash_decode_attention_ref(qx, kq, vq, tables, lens,
                                                split_k=split_k)
            torch.cuda.synchronize()
            label = (f"{name}, {str(q_dtype).replace('torch.', '')} q, "
                     f"{form}")
            check(out.dtype == q_dtype and out.shape == ref.shape,
                  f"K5-fp8 {label}: kernel gave {out.dtype}"
                  f"{tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"K5-fp8 {label}: non-finite kernel output")
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[str(q_dtype).replace("torch.", "")]
            log(f"  K5-fp8 vs plain [{label}]: max_abs_err {err:.3e} "
                f"(tol {tol:g})")
            check(err <= tol, f"K5-fp8 {label}: kernel disagrees with its "
                  f"plain version: max_abs_err {err} > {tol}")
            errs[label] = err
            outs[q_dtype, form] = out
        if kw["nblk"] == 64 and "trash_rows" not in kw:   # engine shapes
            f32_read = fd.flash_decode_attention_ref(q, kp, vp, tables, lens,
                                                     split_k=split_k)
            e = (outs[torch.float32, "hopper"] - f32_read).abs().max().item()
            read_err = max(read_err, e)
            log(f"  fp8 read vs f32 read [{name}]: max_abs_err {e:.3e} "
                f"(tol {FP8_READ_TOL:g})")
            check(e <= FP8_READ_TOL, f"{name}: the fp8 read is {e} from the "
                  f"f32 read (> {FP8_READ_TOL})")
    rng = np.random.RandomState(8)
    x = (rng.randn(4096, HEADS, D_MODEL // HEADS)
         * rng.choice([0.01, 1.0, 30.0], (4096, 1, 1))).astype(np.float32)
    qc, sc = quant.rowwise_quantize(torch.from_numpy(x), "e4m3")
    qg, sg = quant.rowwise_quantize(torch.from_numpy(x).to(DEVICE), "e4m3")
    check(torch.equal(qg.view(torch.uint8).cpu(), qc.view(torch.uint8))
          and torch.equal(sg.cpu().view(torch.int32), sc.view(torch.int32)),
          "the card's e4m3 quantization differs from the CPU's")
    log("  e4m3 rowwise quantization of 4096 rows [8, 64]: payload and "
        "scales bitwise equal to the CPU's")
    return errs, read_err


def phase_k1_vs_plain(torch, np, nn_ops):
    """K1 against its plain version, f32 and bf16, at the training shape
    and at edges (few columns, the column limit, a ragged row length),
    in the warp form (rows up to 1024 columns) and the block form; the
    last case has -inf logits, which must give probability 0."""
    errs = {}
    rng = np.random.RandomState(21)
    for shape in K1_SHAPES + [(5, 300)]:
        x = (4.0 * rng.randn(*shape)).astype(np.float32)
        if shape == (5, 300):
            x[:, ::7] = -np.inf
        forms = ("warp", "block") if shape[1] <= K1_WARP_COLS else ("block",)
        for dtype, form in [(d, f) for d in (torch.float32, torch.bfloat16)
                            for f in forms]:
            t = torch.from_numpy(x).to(DEVICE, dtype)
            out = nn_ops.softmax_rows(t, form=form)
            ref = nn_ops.softmax_rows_ref(t)
            torch.cuda.synchronize()
            dname = str(dtype).replace("torch.", "")
            name = f"{'x'.join(map(str, shape))} {dname} {form}"
            check(out.dtype == dtype and out.shape == t.shape,
                  f"K1 {name}: kernel gave {out.dtype}{tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"K1 {name}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"  K1 vs plain [{name}]: max_abs_err {err:.3e} "
                f"(tol {K1_TOL[dname]:g})")
            check(err <= K1_TOL[dname], f"K1 {name}: kernel disagrees with "
                  f"its plain version: max_abs_err {err}")
            errs[name] = err
    return errs


# (kind, scalars (lr or lr_t, adamw's second), wd vector, mult, ok, clip)
K2_CASES = [
    ("sgd", False, False, None, None),
    ("sgd_momentum", True, True, True, 0.05),
    ("sgd_momentum", False, False, None, None),
    ("sgd_momentum", True, True, False, 0.05),
    ("adam", False, True, True, 0.05),
    ("adamw", False, False, None, None),
    ("adamw", True, True, True, 0.05),
    ("adamw", True, False, False, None),
]


def k2_cuts(np, n, segments, seed):
    """``segments`` random ``(start, stop)`` bounds tiling ``[0, n)``."""
    rng = np.random.RandomState(seed)
    cuts = sorted(rng.choice(np.arange(1, n), segments - 1,
                             replace=False).tolist())
    return list(zip([0] + cuts, cuts + [n]))


def k2_segments(torch, g, bounds, layout):
    """The gradient ``g`` cut at ``bounds`` into a list of tensors, as the
    hopper form takes them: ``"views"`` slices of ``g`` (each pointer on
    the 16-byte grid exactly when its flat offset is), ``"clones"``
    separate allocations (pointers on the grid, offsets anywhere: a
    misaligned offset takes the scalar path), ``"shifted"`` each copied one
    element into a buffer of its own (pointers off the grid)."""
    out = []
    for a, b in bounds:
        seg = g[a:b]
        if layout == "clones":
            seg = seg.clone()
        elif layout == "shifted":
            seg = torch.empty(b - a + 1, dtype=g.dtype,
                              device=g.device)[1:].copy_(seg)
        out.append(seg)
    return out


def k2_operands(torch, np, kind, n, seed):
    """A random bucket: grads, weights, state, and a wd vector made of
    segments (the parameters of the bucket), each with its own wd."""
    rng = np.random.RandomState(seed)
    dev = torch.device(DEVICE)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    nst = {"sgd": 0, "sgd_momentum": 1, "adam": 2, "adamw": 2}[kind]
    state = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
             for _ in range(nst)]
    if nst == 2:
        state[1] = state[1].abs()
    bounds = k2_cuts(np, n, 7, seed)
    seg_wd = [float(v) for v in rng.choice([0.0, 1e-4, 5e-3], len(bounds))]
    return g, w, state, bounds, seg_wd


def k2_unfused(torch, optimizer, kind, g, w, state, bounds, seg_wd, lr, t,
               mult, ok, clip, use_wdvec, base_wd, rescale):
    """The trainer's unfused update over the bucket's segments: per
    segment, ``g * mult``, ``_functional_step`` and ``where(ok, ...)``;
    returns the concatenated ``(new_w, *new_state)``."""
    kw = dict(rescale_grad=rescale, clip_gradient=clip, learning_rate=0.0)
    if kind == "sgd":
        opt = optimizer.SGD(**kw)
    elif kind == "sgd_momentum":
        opt = optimizer.SGD(momentum=0.9, **kw)
    else:
        opt = (optimizer.Adam if kind == "adam" else optimizer.AdamW)(**kw)
    hyper = opt._hyper()
    step = type(opt)._functional_step
    outs = [[] for _ in range(1 + len(state))]
    for (a, b), wdseg in zip(bounds, seg_wd):
        gs, ws = g[a:b], w[a:b]
        ss = [s[a:b] for s in state]
        st = (None if kind == "sgd" else ss[0] if kind == "sgd_momentum"
              else tuple(ss))
        if mult is not None:
            gs = gs * mult
        w2, s2 = step(hyper, ws, gs, st, lr, wdseg if use_wdvec else base_wd,
                      t, None)
        s2 = () if s2 is None else (s2,) if kind == "sgd_momentum" else s2
        if ok is not None:
            w2 = torch.where(ok, w2, ws)
            s2 = tuple(torch.where(ok, x, y) for x, y in zip(s2, ss))
        for lst, v in zip(outs, (w2,) + tuple(s2)):
            lst.append(v)
    return tuple(torch.cat(lst) for lst in outs)


def k2_kernel_args(torch, optimizer, kind, lr, t, use_wdvec, base_wd):
    """The kind's scalar chain, as the trainer forms it."""
    if kind in ("sgd", "sgd_momentum"):
        return (lr,)
    lr_t = optimizer.adam_lr_t(lr, 0.9, 0.999, t)
    if kind == "adam":
        return (lr_t,)
    return (lr_t, lr if use_wdvec else lr * base_wd)


def k2_bitwise(torch, got, ref):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, ref))


def phase_k2_vs_unfused(torch, np, fu, optimizer):
    """K2 on a bucket whose length is not a multiple of any block, for
    every kind and the wd-vector, clip, mult and ok=False variants: the
    bucket API in both forms, and the hopper form over the bucket's 7
    parameters as separate gradients (views, clones, shifted pointers:
    the vector and the scalar paths) and over 300 (two pointer tables,
    two launches); each bitwise equal to the unfused per-parameter update
    and to the plain version; ok=False leaves w and the state bitwise
    unchanged."""
    dev = torch.device(DEVICE)
    f32 = dict(dtype=torch.float32, device=dev)
    rescale, base_wd = 1.0 / 64, 1e-4
    for i, (kind, use_wdvec, use_mult, ok_v, clip) in enumerate(K2_CASES):
        g, w, state, bounds, seg_wd = k2_operands(torch, np, kind, K2_LEN,
                                                  seed=300 + i)
        lr = torch.full((), 0.1 if kind.startswith("sgd") else 1e-3, **f32)
        t = torch.full((), 3.0, **f32)
        mult = torch.full((), 0.37, **f32) if use_mult else None
        ok = None if ok_v is None else torch.tensor(ok_v, device=dev)
        wdvec = None
        if use_wdvec:
            wdvec = torch.empty(K2_LEN, **f32)
            for (a, b), v in zip(bounds, seg_wd):
                wdvec[a:b] = v
        want = k2_unfused(torch, optimizer, kind, g, w, state, bounds,
                          seg_wd, lr, t, mult, ok, clip, use_wdvec, base_wd,
                          rescale)
        scalars = k2_kernel_args(torch, optimizer, kind, lr, t, use_wdvec,
                                 base_wd)
        hyper = dict(momentum=0.9, beta1=0.9, beta2=0.999, epsilon=1e-8,
                     wd=0.0 if use_wdvec else base_wd, rescale_grad=rescale,
                     clip_gradient=clip, kind=kind, mult=mult, ok=ok,
                     wd_vec=wdvec)
        plain = fu.reference_update(g, w, tuple(state), scalars, **hyper)
        many = k2_cuts(np, K2_LEN, 300, seed=400 + i)
        runs = [(f"bucket API, {form} form", form, 1,
                 lambda kw_, ks_, form=form: fu.fused_update(
                     g, kw_, tuple(ks_), scalars, form=form, **hyper))
                for form in fu.KERNEL_FORMS]
        runs += [(f"{len(cut)} {layout}", "hopper", -(-len(cut) //
                                                     fu.TABLE_TENSORS),
                  lambda kw_, ks_, cut=cut, layout=layout:
                  fu.fused_update_params(
                      k2_segments(torch, g, cut, layout), kw_, tuple(ks_),
                      [a for a, _ in cut], scalars, **hyper))
                 for cut, layout in ((bounds, "views"), (bounds, "clones"),
                                     (bounds, "shifted"), (many, "clones"))]
        name = (f"{kind}{' wd_vec' if use_wdvec else ''}"
                f"{' mult' if use_mult else ''}"
                f"{'' if ok_v is None else ' ok' if ok_v else ' ok=False'}"
                f"{' clip' if clip else ''}")
        for label, form, launches, run in runs:
            kw_, ks_ = w.clone(), [s.clone() for s in state]
            before = dict(fu.fused_update.launches_by_form)
            run(kw_, ks_)
            torch.cuda.synchronize()
            got = [kw_] + ks_
            delta = {f: n - before[f]
                     for f, n in fu.fused_update.launches_by_form.items()}
            check(delta == {f: launches if f == form else 0
                            for f in fu.KERNEL_FORMS},
                  f"K2 {name} [{label}]: launches by form {delta}")
            for ref_label, ref in (("unfused", want), ("plain", plain)):
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, ref))
                check(k2_bitwise(torch, got, ref),
                      f"K2 {name} [{label}]: not bitwise equal to the "
                      f"{ref_label} update (max_abs_err {err:.3e})")
            if ok_v is False:
                check(k2_bitwise(torch, got, [w] + state),
                      f"K2 {name} [{label}]: ok=False changed the bucket")
        log(f"  K2 vs unfused and plain [{name}], n={K2_LEN}: bitwise "
            f"equal in {len(runs)} runs ({', '.join(r[0] for r in runs)})")
    return 0.0


def attn_operands(torch, np, seed, layout, B, H, Lq, Lk, D, dtype,
                  misaligned=False):
    """q, k, v and an output gradient on the card in ``layout``; with
    ``misaligned`` each starts one element into a buffer, so its address
    is not 16-byte aligned (still contiguous)."""
    rng = np.random.RandomState(seed)
    qs = (B, Lq, H, D) if layout == "blhd" else (B, H, Lq, D)
    ks = (B, Lk, H, D) if layout == "blhd" else (B, H, Lk, D)
    out = []
    for s in (qs, ks, ks, qs):
        t = torch.from_numpy(rng.randn(*s).astype(np.float32)).to(DEVICE,
                                                                  dtype)
        if misaligned:
            buf = torch.empty(t.numel() + 1, dtype=dtype, device=DEVICE)
            t = buf[1:].view(s).copy_(t)
        out.append(t)
    return out


def attn_err(torch, got, want, dtype):
    """f32: max abs error; bf16: max of |got - want| / (1 + |want|)."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff / (1.0 + want.float().abs())
    return diff.max().item()


def phase_k34_vs_plain(torch, np, fa):
    """K3 and K4 against their plain versions, f32 and bf16, at the LM's
    shape and at edges: K3's (out, lse) against ``flash_fwd_ref``; K4's
    (dq, dk, dv) against ``flash_bwd_ref`` from the same out and lse.
    Each case checks the form that ran.  Returns ``{label: (fwd error,
    bwd error, fwd max abs error, bwd max abs error, form)}``."""
    errs = {}
    for i, case in enumerate(K34_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "bf16" if dtype == torch.bfloat16 else "f32"
            form = case["form"] if dname == "bf16" else "fma"
            q, k, v, do = attn_operands(
                torch, np, 400 + i, case["layout"], case["B"], case["H"],
                case["Lq"], case["Lk"], case["D"], dtype,
                misaligned=case.get("misaligned", False))
            kw = dict(causal=case["causal"], scale=1.0 / case["D"] ** 0.5,
                      layout=case["layout"])
            run_kw = dict(kw, form=form) if case.get("force") else kw
            delta = None
            if case.get("ext"):
                delta = torch.from_numpy(np.random.RandomState(500 + i).randn(
                    case["B"], case["H"], case["Lq"]).astype(
                        np.float32)).to(DEVICE)
            before = (dict(fa.flash_fwd.launches_by_form),
                      dict(fa.flash_bwd.launches_by_form))
            out, lse = fa.flash_fwd(q, k, v, **run_kw)
            grads = fa.flash_bwd(q, k, v, out, lse, do, delta=delta,
                                 **run_kw)
            ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, **kw)
            ref_grads = fa.flash_bwd_ref(q, k, v, out, lse, do, delta=delta,
                                         **kw)
            torch.cuda.synchronize()
            label = f"{case['name']} {case['layout']} {dname}"
            for fn, old in zip((fa.flash_fwd, fa.flash_bwd), before):
                ran = {f: n - old[f] for f, n in fn.launches_by_form.items()
                       if n != old[f]}
                check(ran == {form: 1}, f"K3/K4 {label}: {fn.__name__} ran "
                      f"{ran}, expected one {form!r} launch")
            for what, got, want in (("out", out, ref_out),
                                    ("dq", grads[0], ref_grads[0]),
                                    ("dk", grads[1], ref_grads[1]),
                                    ("dv", grads[2], ref_grads[2])):
                check(got.dtype == dtype and got.shape == want.shape,
                      f"K3/K4 {label} {what}: {got.dtype}"
                      f"{tuple(got.shape)}")
                check(bool(torch.isfinite(got.float()).all()),
                      f"K3/K4 {label} {what}: non-finite")
            e_fwd = max(attn_err(torch, out, ref_out, dtype),
                        (lse - ref_lse).abs().max().item())
            e_bwd = max(attn_err(torch, g, r, dtype)
                        for g, r in zip(grads, ref_grads))
            a_fwd = max(attn_err(torch, out, ref_out, torch.float32),
                        (lse - ref_lse).abs().max().item())
            a_bwd = max(attn_err(torch, g, r, torch.float32)
                        for g, r in zip(grads, ref_grads))
            tol_f = K34_TOL["fwd" if dname == "f32" else "bf16_rel"]
            tol_b = K34_TOL["bwd" if dname == "f32" else "bf16_rel"]
            log(f"  K3 vs plain [{label}, {form}]: {e_fwd:.3e} (tol "
                f"{tol_f:g}); K4 vs plain: {e_bwd:.3e} (tol {tol_b:g})")
            check(e_fwd <= tol_f, f"K3 {label}: kernel disagrees with its "
                  f"plain version: {e_fwd}")
            check(e_bwd <= tol_b, f"K4 {label}: kernel disagrees with its "
                  f"plain version: {e_bwd}")
            errs[label] = (e_fwd, e_bwd, a_fwd, a_bwd, form)
    return errs


# ---------------------------------------------------------------------------
# Phases 4-6: serving at full width (whole prompts; r12; prefix cache)
# ---------------------------------------------------------------------------

def request_set(np):
    rng = np.random.RandomState(1)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.randint(32, 513))
        prompt = rng.randint(0, VOCAB, size=plen).tolist()
        kw = dict(max_new_tokens=NEW_TOKENS)
        if i in SAMPLED:
            kw.update(temperature=SAMPLED[i], top_k=50, seed=1000 + i)
        reqs.append((prompt, kw))
    return reqs


def teacher_forced_rows(torch, eng, seq, transformer):
    """Logits [len(seq), V] of a cache-free causal forward over ``seq``
    with ``eng``'s weights (no kernel): the dense forward for f32 pools;
    for fp8 pools each position's K and V first pass through the pools'
    rowwise e4m3 quantization, as a chunked-prefill fp8 engine reads
    them."""
    from mxnet_tpu_torch import quant
    from mxnet_tpu_torch.serve import kvcache
    tokens = torch.tensor([seq], dtype=torch.int32, device=eng.device)

    def fp8(x):          # [1, L, H, hd] -> quantized, then dequantized
        q, scale = quant.rowwise_quantize(x[0], kvcache.KV_FP8_FORMAT)
        return (q.float() * scale[:, None, None])[None]

    def attend(i, q, k, v):
        k, v = fp8(k), fp8(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(q.shape[-1]) ** 0.5
        n = s.shape[-1]
        causal = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    with torch.no_grad():
        if eng.kv_quant is None:
            logits, _, _ = transformer.transformer_lm_prefill(
                eng._params, tokens, heads=eng.heads)
        else:
            logits = transformer.transformer_lm_prefill_chunk(
                eng._params, tokens, heads=eng.heads, attend=attend)
    return logits[0].float()


def teacher_forced_check(torch, eng, prompt, tokens, transformer):
    """Every greedy token must be the argmax, within 1e-5, of a cache-free
    causal forward over prompt + generated tokens
    (:func:`teacher_forced_rows`)."""
    rows = teacher_forced_rows(torch, eng, prompt + tokens[:-1],
                               transformer)[len(prompt) - 1:]
    chosen = rows[torch.arange(len(tokens), device=rows.device),
                  torch.tensor(tokens, device=rows.device)]
    gap = (rows.max(dim=-1).values - chosen).max().item()
    check(gap <= 1e-5, f"served token is not the teacher-forced argmax "
          f"(logit gap {gap})")
    return gap


def phase_serve(torch, np, fd):
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    from mxnet_tpu_torch.serve.scheduler import FINISHED

    t0 = time.perf_counter()
    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    eng = Engine(params, EngineConfig(**ENGINE_KW), device=DEVICE)
    check(eng.attn_impl == ("flash" if DEVICE == "cuda" else "dense"),
          f"engine resolved {eng.attn_impl}")
    log(f"  engine built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    infos = eng.warmup()
    torch.cuda.synchronize()
    log(f"  warmup {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{i['kind']}@{i['bucket']} {i['source']} "
        f"{i['seconds'] * 1e3:.1f} ms" for i in infos))

    reqs = request_set(np)
    # the main path's run: every count starts at 0 inside serve_run
    done, wall, decode_ms, (launches, launches_fp8), counters = serve_run(
        torch, np, eng, reqs, fd)
    check(all(r.state == FINISHED and len(r.tokens) == NEW_TOKENS
              for r in done), "not every request finished with "
          f"{NEW_TOKENS} tokens: {[(r.state, len(r.tokens)) for r in done]}")
    check(eng.alloc.num_used == 0,
          f"{eng.alloc.num_used} KV blocks still held after drain")
    check(launches > 0, "the flash-decode kernel never launched")
    check(launches == LAYERS * counters["decode_steps"]
          == counters["kernel_launches"] and launches_fp8 == 0,
          f"kernel launches {launches} != {LAYERS} x decode steps "
          f"{counters['decode_steps']} (engine counted "
          f"{counters['kernel_launches']}; fp8 {launches_fp8})")
    stats = serve_stats(np, done, wall, decode_ms, counters)
    log("  serve: " + json.dumps(stats))

    # correctness: greedy tokens against a cache-free dense forward
    greedy = [i for i in range(N_REQUESTS) if i not in SAMPLED]
    for i in (greedy[0], greedy[-1]):
        gap = teacher_forced_check(torch, eng, reqs[i][0], done[i].tokens,
                                   transformer)
        log(f"  teacher-forced check, request {i}: max logit gap {gap:.2e}")
    # replay: one greedy and one sampled request served again, alone
    for i in (greedy[1], sorted(SAMPLED)[0]):
        again = eng.result(eng.submit(reqs[i][0], **reqs[i][1]))
        check(again == done[i].tokens,
              f"request {i} served alone differs from its batched stream")
        log(f"  request {i} served alone: identical stream")
    check(eng.alloc.num_used == 0, "KV blocks leaked by the replays")
    stats["profile"] = profile_decode(torch, eng, reqs)
    return launches, stats


def serve_run(torch, np, eng, reqs, fd):
    """Drive ``eng`` through ``reqs`` from counts of 0; every step ends in
    a synchronise; a plain engine's flash-decode launches must all have
    run the hopper form; a speculating engine's allocator and tables are
    audited after every step.  Returns the requests, the wall time, the
    host times of steps that ran no prefill work, the flash-decode
    launches (plain, fp8) and the engine's counters."""
    reset_decode_counts(fd)
    eng.counters.clear()
    t_start = time.perf_counter()
    ids = [eng.submit(p, **kw) for p, kw in reqs]
    decode_ms = []
    while not eng.sched.idle():
        work = eng.counters["prefills"] + eng.counters["prefill_chunks"]
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if eng.counters["prefills"] + eng.counters["prefill_chunks"] == work:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        if eng.spec is not None:
            eng.check_tables()
    wall = time.perf_counter() - t_start
    launches = (fd.flash_decode_attention.launches,
                fd.flash_decode_attention.launches_fp8)
    if eng.spec is None:
        check_hopper_launches(fd, "served path")
    return ([eng.requests[i] for i in ids], wall, decode_ms, launches,
            dict(eng.counters))


def reset_decode_counts(fd):
    """Every flash-decode count to 0 (plain, fp8, by form)."""
    f = fd.flash_decode_attention
    f.launches = f.launches_fp8 = 0
    f.launches_by_form = dict.fromkeys(f.launches_by_form, 0)


def check_hopper_launches(fd, what):
    """Every K5 and K5-fp8 launch since the reset ran the hopper form."""
    f = fd.flash_decode_attention
    total = f.launches + f.launches_fp8
    check(total > 0 and f.launches_by_form == dict(
        dict.fromkeys(f.launches_by_form, 0), hopper=total),
          f"{what}: flash-decode launches by form {f.launches_by_form}, "
          f"expected all {total} in the hopper form")
    log(f"  {what}: all {total} flash-decode launches in the hopper form")


def serve_stats(np, done, wall, decode_ms, counters):
    n_tok = sum(len(r.tokens) for r in done)
    ttft = sorted((r.first_token_t - r.submit_t) * 1e3 for r in done)
    return {"requests": len(done), "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "wall_s": wall,
            "p50_ttft_ms": float(np.median(ttft)),
            "decode_steps": counters.get("decode_steps", 0),
            "median_decode_step_ms": float(np.median(decode_ms)),
            "prefills": counters.get("prefills", 0),
            "prefill_chunks": counters.get("prefill_chunks", 0),
            "preemptions": counters.get("preemptions", 0)}


def profile_decode(torch, eng, reqs, steps=5, drain=True):
    """``steps`` decode steps (verify steps, when ``eng`` speculates) of a
    full batch under ``torch.profiler``: the first ``max_batch`` requests
    of ``reqs`` are admitted and prefilled first, then the profiled steps
    run no prefill work; afterwards the requests run to their end, or
    with ``drain=False`` are cancelled.  Per step: wall and device-busy
    ms, idle share, device ms by layer."""
    from mxnet_tpu_torch.serve.scheduler import CANCELLED, FINISHED
    ids = [eng.submit(p, **kw) for p, kw in reqs[:eng.config.max_batch]]
    while any(r.prefilled < r.prefill_target or not r.tokens
              for r in eng.sched.running) or eng.sched.queue:
        eng.step()
    kind = "decode" if eng.spec is None else "verify"
    out = profile_step(torch, lambda: [eng.step() for _ in range(steps)],
                       (_SERVE_KERNEL_GROUPS if eng.spec is None
                        else _VERIFY_KERNEL_GROUPS),
                       label=f"profiled {steps} {kind} steps")
    per_step = {"wall_ms": out["wall_ms"] / steps,
                "device_busy_ms": out["device_busy_ms"] / steps,
                "idle_share": out["idle_share"],
                "by_layer_ms": {k: v / steps
                                for k, v in out["by_layer_ms"].items()}}
    if not drain:
        for i in ids:
            eng.cancel(i)
    eng.run()
    check(all(eng.requests[i].state == (FINISHED if drain else CANCELLED)
              for i in ids) and eng.alloc.num_used == 0,
          "the profiled requests did not drain")
    return per_step


def phase_serve_r12(torch, np, fd, kv):
    """The round-12 configuration: chunked prefill, f32 pools then fp8
    pools, the same model and requests as phase 4."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    from mxnet_tpu_torch.serve.scheduler import FINISHED

    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    reqs = request_set(np)
    greedy = [i for i in range(N_REQUESTS) if i not in SAMPLED]
    n_chunks = sum(-(-len(p) // R12_CHUNK) for p, _ in reqs)
    out = {}
    for kv_quant in (None, "fp8"):
        name = kv_quant or "f32"
        eng = Engine(params, EngineConfig(**ENGINE_KW,
                                          prefill_chunk=R12_CHUNK,
                                          kv_quant=kv_quant), device=DEVICE)
        infos = eng.warmup()
        torch.cuda.synchronize()
        log(f"  [{name} pools] warmup: " + ", ".join(
            f"{i['kind']}@{i['bucket']} {i['source']} "
            f"{i['seconds'] * 1e3:.1f} ms" for i in infos))
        # the main path's run: every count starts at 0 inside serve_run
        done, wall, decode_ms, (k5, k5_fp8), counters = serve_run(
            torch, np, eng, reqs, fd)
        check(all(r.state == FINISHED and len(r.tokens) == NEW_TOKENS
                  for r in done), f"[{name}] not every request finished: "
              f"{[(r.state, len(r.tokens)) for r in done]}")
        check(eng.alloc.num_used == 0,
              f"[{name}] {eng.alloc.num_used} KV blocks held after drain")
        check(counters["prefill_chunks"] == n_chunks,
              f"[{name}] {counters['prefill_chunks']} chunks, expected "
              f"{n_chunks}")
        steps = counters["decode_steps"]
        want = (LAYERS * steps, 0) if kv_quant is None else (0, LAYERS * steps)
        check(steps > 0 and (k5, k5_fp8) == want
              and counters["kernel_launches"] == LAYERS * steps,
              f"[{name}] launches K5 {k5}, K5-fp8 {k5_fp8}, expected {want} "
              f"({LAYERS} x {steps} decode steps)")
        stats = dict(serve_stats(np, done, wall, decode_ms, counters),
                     kv_quant=name,
                     pool_nbytes=kv.pool_nbytes(eng.kpool, eng.vpool),
                     kv_bytes_per_token=eng.kv_bytes_per_token,
                     launches_k5=k5, launches_k5_fp8=k5_fp8)
        log(f"  serve r12 [{name} pools]: " + json.dumps(stats))
        if kv_quant is None:
            for i in greedy:
                teacher_forced_check(torch, eng, reqs[i][0], done[i].tokens,
                                     transformer)
            log(f"  teacher-forced check of the {len(greedy)} greedy "
                "requests: every token within 1e-5 of the argmax")
        else:
            for i in (greedy[1], sorted(SAMPLED)[0]):
                again = eng.result(eng.submit(reqs[i][0], **reqs[i][1]))
                check(again == done[i].tokens, f"[fp8] request {i} served "
                      "alone differs from its batched stream")
                log(f"  [fp8] request {i} served alone: identical stream")
            check(eng.alloc.num_used == 0, "KV blocks leaked by the replays")
        stats["profile"] = profile_decode(torch, eng, reqs)
        out[name] = (stats, [r.tokens for r in done], k5_fp8)
    same = sum(a == b for i in greedy
               for a, b in zip(out["f32"][1][i], out["fp8"][1][i]))
    first = [next((j for j, (a, b) in enumerate(zip(out["f32"][1][i],
                                                     out["fp8"][1][i]))
                   if a != b), None) for i in greedy]
    log(f"  fp8 greedy tokens equal to the f32 run: {same} of "
        f"{len(greedy) * NEW_TOKENS} ({same / (len(greedy) * NEW_TOKENS):.3f})"
        f"; first divergence by request: {first}")
    return out["fp8"][2], {k: v[0] for k, v in out.items()}


def phase_prefix_cache(torch, np, fd):
    """8 requests over one shared prefix, fp8 pools, chunked prefill: the
    prefix cache against a cache-cold engine, and a cached run with a
    defrag halfway."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import Engine, EngineConfig

    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, VOCAB, PREFIX_LEN).tolist()
    reqs = [(prefix + rng.randint(0, VOCAB, SUFFIX_LEN).tolist(),
             dict(max_new_tokens=PREFIX_NEW)) for _ in range(PREFIX_REQUESTS)]

    def run(prefix_cache, defrag_at=None):
        eng = Engine(params, EngineConfig(**ENGINE_KW,
                                          prefill_chunk=R12_CHUNK,
                                          kv_quant="fp8",
                                          prefix_cache=prefix_cache),
                     device=DEVICE)
        eng.warmup()
        torch.cuda.synchronize()
        eng.counters.clear()
        reset_decode_counts(fd)
        ids = [eng.submit(p, **kw) for p, kw in reqs]
        steps, moved = 0, 0
        while not eng.sched.idle():
            eng.step()
            torch.cuda.synchronize()
            steps += 1
            if steps == defrag_at:
                moved = eng.defrag()
                eng.check_tables()
        done = [eng.requests[i] for i in ids]
        ttft = float(np.median([(r.first_token_t - r.submit_t) * 1e3
                                for r in done]))
        check(eng.alloc.num_used == 0, "KV blocks held after drain")
        eng.check_tables()
        f = fd.flash_decode_attention
        check(f.launches == 0 and f.launches_fp8
              == eng.counters["kernel_launches"]
              == LAYERS * eng.counters["decode_steps"],
              f"prefix-cache run: K5 {f.launches}, K5-fp8 {f.launches_fp8} "
              f"launches, {eng.counters['decode_steps']} decode steps")
        check_hopper_launches(fd, f"prefix-cache run (cache "
                              f"{'on' if prefix_cache else 'off'})")
        return eng, [r.tokens for r in done], ttft, steps, moved

    cold, cold_toks, cold_ttft, _, _ = run(False)
    warm, warm_toks, warm_ttft, steps, _ = run(True)
    hits = warm.stats()["prefix"]["hits"]
    saved = cold.counters["prefill_chunks"] - warm.counters["prefill_chunks"]
    check(warm_toks == cold_toks, "prefix-cache streams differ from the "
          "cache-cold engine's")
    check(hits >= PREFIX_REQUESTS - 1, f"{hits} prefix hits, expected "
          f">= {PREFIX_REQUESTS - 1}")
    check(saved == (PREFIX_REQUESTS - 1) * (PREFIX_LEN // R12_CHUNK),
          f"the cache saved {saved} chunks, expected "
          f"{(PREFIX_REQUESTS - 1) * (PREFIX_LEN // R12_CHUNK)}")
    dfg, dfg_toks, _, _, moved = run(True, defrag_at=steps // 2)
    check(moved > 0, "defrag halfway moved no block")
    check(dfg_toks == cold_toks, "defrag changed the streams")
    stats = {"requests": PREFIX_REQUESTS, "prefix_tokens": PREFIX_LEN,
             "hits": hits, "hit_tokens": warm.stats()["prefix"]["hit_tokens"],
             "chunks_cached": warm.counters["prefill_chunks"],
             "chunks_cold": cold.counters["prefill_chunks"],
             "p50_ttft_cached_ms": warm_ttft, "p50_ttft_cold_ms": cold_ttft,
             "defrag_moved_blocks": moved, "steps": steps}
    log("  prefix cache: streams equal the cache-cold engine's; defrag "
        "halfway kept them; " + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# Phase 11: speculative decoding at full width
# ---------------------------------------------------------------------------

def spec_prompts(np):
    """bench.py's serve_request_set recipe (seed 1, lengths 4-32)."""
    rng = np.random.RandomState(1)
    out = []
    for _ in range(SPEC_REQUESTS):
        n = int(rng.randint(4, 33))
        out.append([int(t) for t in rng.randint(1, VOCAB, n)])
    return out


def spec_divergence(torch, eng, prompt, got, want, transformer):
    """0 when the greedy streams ``got`` and ``want`` are equal, 1 when
    they first differ at a true near-tie: both tokens within ``SPEC_TIE``
    of the maximum teacher-forced logit of that row.  Any other
    divergence fails."""
    check(len(got) == len(want), f"stream lengths {len(got)} != {len(want)}")
    if got == want:
        return 0
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    row = teacher_forced_rows(torch, eng, prompt + got[:j], transformer)[-1]
    top = row.max().item()
    gaps = (top - row[got[j]].item(), top - row[want[j]].item())
    check(max(gaps) <= SPEC_TIE, f"greedy streams diverge at token {j}: "
          f"logit gaps {gaps} to the row maximum, not a near-tie "
          f"(<= {SPEC_TIE})")
    log(f"  near-tie at token {j}: {got[j]} against {want[j]}, logit gaps "
        f"{gaps[0]:.2e} and {gaps[1]:.2e}")
    return 1


def spec_stats(np, eng, done, wall, step_ms, counters):
    """serve_stats plus the speculative step's figures: tokens per step of
    the batch (tokens after each request's first, over decode or verify
    steps), the engine's tokens per row per step (EWMA) and the accept
    rate."""
    st = serve_stats(np, done, wall, step_ms, counters)
    st["median_step_ms"] = st.pop("median_decode_step_ms")
    steps = counters.get("verify_steps", 0) or counters.get("decode_steps",
                                                            0)
    st["steps"] = steps
    st["tokens_per_step"] = (st["tokens"] - len(done)) / steps
    if eng.spec is not None:
        drafted = counters.get("spec_drafted", 0)
        st.update(drafted=drafted, accepted=counters.get("spec_accepted", 0),
                  accept_rate=counters.get("spec_accepted", 0) / drafted,
                  tokens_per_row_step=eng.stats()["speculate"][
                      "tokens_per_step"])
    return st


def phase_speculate(torch, np, fd):
    """Speculative decoding on the served model: (a) the greedy
    non-speculative baseline (K5), (b) greedy n-gram speculation, (c)
    temperature 0.9, top-k 40, (d) greedy on fp8 pools against an fp8
    baseline (K5-fp8), (e) the model drafter with the target's own
    weights, (f) adoption of a stopped request by a new engine.  Returns
    the K5 and K5-fp8 launches of the baselines and the stats."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    from mxnet_tpu_torch.serve.scheduler import FINISHED

    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    prompts = spec_prompts(np)
    greedy = [(p, dict(max_new_tokens=SPEC_NEW, seed=i))
              for i, p in enumerate(prompts)]
    sampled = [(p, dict(max_new_tokens=SPEC_NEW, temperature=SPEC_TEMP,
                        top_k=SPEC_TOPK, seed=i))
               for i, p in enumerate(prompts)]

    def engine(label, speculate, **over):
        cfg = dict(SPEC_KW, speculate=speculate, spec_k=SPEC_K, **over)
        extra = (dict(draft_params=params)
                 if over.get("spec_draft") == "model" else {})
        eng = Engine(params, EngineConfig(**cfg), device=DEVICE, **extra)
        infos = eng.warmup()
        torch.cuda.synchronize()
        log(f"  [{label}] warmup: " + ", ".join(
            f"{i['kind']}@{i['bucket']} {i['source']} "
            f"{i['seconds'] * 1e3:.1f} ms" for i in infos))
        return eng

    def run(label, eng, reqs):
        # the main path's run: every count starts at 0 inside serve_run
        spec = eng.spec is not None
        done, wall, step_ms, launches, counters = serve_run(
            torch, np, eng, reqs, fd)
        check(all(r.state == FINISHED and len(r.tokens) == SPEC_NEW
                  for r in done), f"[{label}] not every request finished "
              f"with {SPEC_NEW} tokens: "
              f"{[(r.state, len(r.tokens)) for r in done]}")
        check(eng.alloc.num_used == 0,
              f"[{label}] {eng.alloc.num_used} KV blocks held after drain")
        if spec:
            check(launches == (0, 0) and counters.get("decode_steps", 0)
                  == counters.get("kernel_launches", 0) == 0
                  and counters["verify_steps"] > 0,
                  f"[{label}] flash-decode launches {launches}, counters "
                  f"{counters}: a verify step must replace every decode "
                  "step")
        else:
            steps = counters["decode_steps"]
            want = ((LAYERS * steps, 0) if eng.kv_quant is None
                    else (0, LAYERS * steps))
            check(steps > 0 and launches == want
                  and counters["kernel_launches"] == LAYERS * steps,
                  f"[{label}] launches {launches}, expected {want}")
        stats = spec_stats(np, eng, done, wall, step_ms, counters)
        log(f"  [{label}] " + json.dumps(stats))
        return done, stats, launches

    def replay(label, eng, reqs, done, i):
        again = eng.result(eng.submit(reqs[i][0], **reqs[i][1]))
        check(again == done[i].tokens, f"[{label}] request {i} served alone "
              "differs from its batched stream")
        check(eng.alloc.num_used == 0, f"[{label}] blocks leaked by replay")
        log(f"  [{label}] request {i} served alone: identical stream")

    def streams_match(label, eng, done, ref):
        ties = 0
        for i, r in enumerate(done):
            teacher_forced_check(torch, eng, prompts[i], r.tokens,
                                 transformer)
            ties += spec_divergence(torch, eng, prompts[i], r.tokens,
                                    ref[i].tokens, transformer)
        log(f"  [{label}] every greedy token within {SPEC_TIE} of the "
            f"teacher-forced argmax; streams equal the baseline's but for "
            f"{ties} near-tie(s)")
        return ties

    out = {}
    # (a) the greedy non-speculative baseline: K5
    eng = engine("a", False)
    a_done, out["a"], (a_k5, _) = run("a: greedy, non-speculative, f32",
                                      eng, greedy)
    for i, r in enumerate(a_done):
        teacher_forced_check(torch, eng, prompts[i], r.tokens, transformer)
    out["a"]["profile"] = profile_decode(torch, eng, greedy, drain=False)
    base_tps = out["a"]["tokens_per_s"]

    # (b) greedy n-gram speculation
    eng = engine("b", True)
    b_done, out["b"], _ = run("b: greedy, speculative (n-gram)", eng, greedy)
    out["b"]["near_ties"] = streams_match("b", eng, b_done, a_done)
    replay("b", eng, greedy, b_done, 1)
    out["b"]["profile"] = profile_decode(torch, eng, greedy, drain=False)

    # (c) temperature 0.9, top-k 40: acceptance is about 1/V by design
    eng = engine("c", True)
    c_done, out["c"], _ = run(f"c: temperature {SPEC_TEMP}, top-k "
                              f"{SPEC_TOPK}, speculative", eng, sampled)
    replay("c", eng, sampled, c_done, 3)
    out["c"]["profile"] = profile_decode(torch, eng, sampled, drain=False)

    # (d) fp8 pools: speculation against the fp8 baseline (K5-fp8)
    eng = engine("d base", False, kv_quant="fp8")
    d0_done, out["d_base"], (_, d_k5_fp8) = run(
        "d: greedy, non-speculative, fp8", eng, greedy)
    for i, r in enumerate(d0_done):
        teacher_forced_check(torch, eng, prompts[i], r.tokens, transformer)
    eng = engine("d", True, kv_quant="fp8")
    d_done, out["d"], _ = run("d: greedy, speculative, fp8", eng, greedy)
    out["d"]["near_ties"] = streams_match("d", eng, d_done, d0_done)
    replay("d", eng, greedy, d_done, 1)

    # (e) the model drafter, the target's own weights over the whole
    # context: every draft is the target's own argmax
    eng = engine("e", True, spec_draft="model", spec_window=SPEC_WINDOW)
    e_done, out["e"], _ = run("e: greedy, speculative (model drafter)",
                              eng, greedy)
    out["e"]["near_ties"] = streams_match("e", eng, e_done, a_done)
    check(out["e"]["accept_rate"] >= SPEC_MIN_ACCEPT,
          f"[e] accept rate {out['e']['accept_rate']} < {SPEC_MIN_ACCEPT} "
          "with the target's own weights as the draft")
    report = eng.swap_draft_weights(params)
    check(report["compatible"]
          and eng.stats()["speculate"]["draft_swaps"] == 1,
          f"[e] compatible draft swap: {report}, counters {eng.counters}")
    replay("e, after the draft swap", eng, greedy, e_done, 2)
    out["e"]["profile"] = profile_decode(torch, eng, greedy, drain=False)

    # (f) adoption: request 0 stopped after SPEC_ADOPT_AT tokens on one
    # speculative engine, continued by a new one
    first = engine("f, first", True)
    rid = first.submit(prompts[0], **greedy[0][1])
    while len(first.request(rid).tokens) < SPEC_ADOPT_AT:
        first.step()
    part = first.request(rid).tokens[:SPEC_ADOPT_AT]
    first.cancel(rid)
    first.step()
    check(first.alloc.num_used == 0, "[f] the stopped request kept blocks")
    second = engine("f, second", True)
    got = second.result(second.adopt(prompts[0], part, **greedy[0][1]))
    check(got[:SPEC_ADOPT_AT] == part, "[f] adoption changed the tokens "
          "it was given")
    ties = spec_divergence(torch, second, prompts[0], got, b_done[0].tokens,
                           transformer)
    check(second.alloc.num_used == 0, "[f] blocks held after adoption")
    log(f"  [f] request 0 stopped after {SPEC_ADOPT_AT} tokens and adopted: "
        f"its stream equals (b)'s but for {ties} near-tie(s)")
    out["f_near_ties"] = ties

    for key in ("b", "c", "e"):
        out[key]["tokens_per_s_vs_a"] = out[key]["tokens_per_s"] / base_tps
    out["d"]["tokens_per_s_vs_d_base"] = (out["d"]["tokens_per_s"]
                                          / out["d_base"]["tokens_per_s"])
    summary = {k: {m: v[m] for m in ("tokens_per_s", "p50_ttft_ms",
                                     "median_step_ms", "tokens_per_step")
                   + (("accept_rate", "tokens_per_row_step")
                      if "accept_rate" in v else ())
                   + tuple(x for x in v if x.startswith("tokens_per_s_vs")
                           or x == "near_ties")}
               for k, v in out.items() if isinstance(v, dict)}
    log("  speculative decoding: " + json.dumps(summary))
    return a_k5, d_k5_fp8, out


# ---------------------------------------------------------------------------
# Phase 12: the serving control plane at full width
# ---------------------------------------------------------------------------

def cp_router(torch, params, n=2, chaos=None, ecfg=None, rcfg=None,
              **router_kw):
    """A warmed fleet of ``n`` replicas on the card, with a fresh telemetry
    registry (so the fleet's checks read its own series).  ``rcfg``
    overrides ``RouterConfig``; ``router_kw`` goes to ``Router`` (a clock,
    a drafter's weights)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.chaos import ChaosSpec
    from mxnet_tpu_torch.serve import EngineConfig, Router, RouterConfig
    telemetry.reset_for_tests()
    router = Router(params, ecfg or EngineConfig(**CP_KW),
                    RouterConfig(replicas=n, **(rcfg or {})),
                    chaos={i: ChaosSpec(c) for i, c in (chaos or {}).items()},
                    device=DEVICE, **router_kw)
    router.warmup()
    torch.cuda.synchronize()
    return router


def cp_run(torch, router, reqs, steps_before=0, between=None):
    """Submit ``reqs``, step ``steps_before`` times, call ``between``, run
    the fleet to its end.  Returns the requests' tokens and the wall s."""
    t0 = time.perf_counter()
    ids = [router.submit(p, **kw) for p, kw in reqs]
    for _ in range(steps_before):
        router.step()
    out = between() if between is not None else None
    router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [list(router.request(i).tokens) for i in ids], wall, out


# each serve chaos kind: the death it causes and its serve.chaos_injected
# label
CP_KINDS = {"serve_crash": ("crash", "crash"),
            "serve_hang": ("heartbeat", "hang"),
            "serve_poison_logits": (None, "poison")}


def cp_check_deaths(router, label, chaos=None):
    """The fleet's deaths are exactly its planted chaos points: each
    planted crash killed its replica with the injected ChaosError, each
    planted hang through the heartbeat, every planted point fired, and no
    other replica died or failed a request over.  The router contains any
    exception a replica's step raises, so without this a fault on the
    card would pass for a crash."""
    from collections import Counter
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve.router import DEAD
    want, fired = {}, Counter()
    for idx, points in (chaos or {}).items():
        for kind, steps in points.items():
            cause, tag = CP_KINDS[kind]
            fired[tag] += len(steps)
            if cause is not None:
                want[idx] = cause
    dead = {rep.idx: (rep.death_cause, rep.death_error)
            for rep in router.replicas if rep.state == DEAD}
    check(dead == {i: (c, "ChaosError" if c == "crash" else None)
                   for i, c in want.items()},
          f"[{label}] deaths {dead}, planted {want}")
    flat = telemetry.snapshot_flat()

    def series(name):
        return {k: v for k, v in flat.items()
                if k == name or k.startswith(name + "{")}

    deaths = series("serve.router.deaths")
    check(deaths == {f"serve.router.deaths{{cause={c}}}": n
                     for c, n in Counter(want.values()).items()},
          f"[{label}] serve.router.deaths {deaths}, planted {want}")
    injected = series("serve.chaos_injected")
    check(injected == {f"serve.chaos_injected{{kind={t}}}": n
                       for t, n in fired.items()},
          f"[{label}] serve.chaos_injected {injected}, planted {dict(fired)}")
    if not want:
        check(router.stats()["failovers"] == 0
              and not series("serve.router.failovers"),
              f"[{label}] failovers in a fleet where nothing died: "
              f"{router.stats()['failovers']}")


def cp_check_fleet(router, ids_tokens, ref, label, chaos=None):
    """Every request finished with the clean fleet's stream, no token
    lost, every live replica's allocator drained, and the deaths are the
    planted ``chaos`` points' and nothing else's."""
    from mxnet_tpu_torch.serve.scheduler import FINISHED
    states = [rr.state for rr in router._requests.values()]
    check(all(st == FINISHED for st in states),
          f"[{label}] not every request finished: {states}")
    lost = sum(max(0, len(a) - len(b)) for a, b in zip(ref, ids_tokens))
    check(lost == 0 and ids_tokens == ref,
          f"[{label}] streams differ from the clean fleet's ({lost} tokens "
          "lost)")
    held = [rep.engine.alloc.num_used for rep in router.replicas
            if rep.state != "dead"]
    check(not any(held), f"[{label}] KV blocks held after the run: {held}")
    cp_check_deaths(router, label, chaos)


def cp_check_forms(fd, routers, label):
    """Every flash-decode launch since the last reset ran the hopper form,
    on every replica that decoded (each replica's own count of its decode
    steps' launches, and its pools' form)."""
    from mxnet_tpu_torch.serve import kvcache
    check_hopper_launches(fd, label)
    for router in routers:
        for rep in router.replicas:
            eng = rep.engine
            form = fd.kernel_form(kvcache.layer_view(eng.kpool, 0),
                                  kvcache.layer_view(eng.vpool, 0))
            check(form == "hopper",
                  f"[{label}] replica {rep.idx}'s pools allow {form}")
            if eng.counters["decode_steps"]:
                check(eng.counters["kernel_launches"]
                      == LAYERS * eng.counters["decode_steps"],
                      f"[{label}] replica {rep.idx}: K5 launches "
                      f"{eng.counters['kernel_launches']} != {LAYERS} x "
                      f"{eng.counters['decode_steps']} decode steps")


def phase_control_plane(torch, np, fd, _build):
    """The serving control plane on the card: (a) crash failover, (b) a
    hung replica on a virtual clock and a poisoned step, (c) hot, rebuild
    and forbidden rolling swaps, (d) the diurnal gameday with
    autoscaling and chaos, and its replay, (e) failover and a draft swap
    under speculation.  Returns the flash-decode launches of the phase
    (all hopper form) and the stats."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.chaos import ChaosSpec
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import (Engine, EngineConfig, TraceConfig,
                                       generate_trace)
    from mxnet_tpu_torch.serve.router import HEALTHY
    from mxnet_tpu_torch.serve.scheduler import FAILED
    from mxnet_tpu_torch.serve.traffic import VirtualClock

    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    prompts = spec_prompts(np)[:CP_REQUESTS]       # serve_request_set
    reqs = [(p, dict(max_new_tokens=CP_NEW, seed=i))
            for i, p in enumerate(prompts)]
    out = {}
    # no kernel is built after warmup: every library was loaded by the
    # earlier phases, so any nvcc run from here on is a failure
    loaded = set(_build._loaded)
    built = []
    compile_ = _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    # the phase's own run: every flash-decode count starts at 0 here
    reset_decode_counts(fd)
    try:
        # (a) failover: bench.py's chaos row
        clean = cp_router(torch, params)
        ref, clean_wall, _ = cp_run(torch, clean, reqs)
        cp_check_fleet(clean, ref, ref, "a, clean")
        chaos = {0: {"serve_crash": {CP_CRASH_STEP}}}
        crash = cp_router(torch, params, chaos=chaos)
        got, wall, _ = cp_run(torch, crash, reqs)
        cp_check_fleet(crash, got, ref, "a, crash", chaos)
        st = crash.stats()
        check(st["failovers"] >= 1 and crash.recoveries_ms,
              f"[a] no failover: {st}")
        rec = crash.recoveries_ms
        out["a"] = {"failovers": st["failovers"],
                    "recovery_ms_median": float(np.median(rec)),
                    "recovery_ms_max": float(max(rec)), "wall_s": wall,
                    "clean_wall_s": clean_wall,
                    "tokens_per_s": sum(map(len, got)) / wall,
                    "clean_tokens_per_s": sum(map(len, ref)) / clean_wall}
        log("  (a) crash failover: " + json.dumps(out["a"]))
        out["a"]["profile"] = cp_profile(torch, params, reqs)
        cp_check_forms(fd, (clean, crash), "(a)")
        del clean, crash

        # (b) a hung replica on the virtual clock, then a poisoned step
        clock = VirtualClock()
        chaos = {1: {"serve_hang": {CP_HANG_STEP}}}
        hang = cp_router(torch, params, chaos=chaos, clock=clock,
                         rcfg=dict(heartbeat_timeout_ms=CP_HEARTBEAT_MS))
        ids = [hang.submit(p, **kw) for p, kw in reqs]
        steps = 0
        while not all(hang.request(i).done() for i in ids):
            hang.step()
            clock.advance(1.0)
            steps += 1
            check(steps < 10000, "[b] the hung fleet never finished")
        torch.cuda.synchronize()
        got = [list(hang.request(i).tokens) for i in ids]
        cp_check_fleet(hang, got, ref, "b, hang", chaos)
        check(hang.stats()["failovers"] >= 1,
              f"[b] no failover: {hang.stats()['failovers']}")
        out["b"] = {"router_steps": steps,
                    "failovers": hang.stats()["failovers"],
                    "recovery_virtual_ms": list(hang.recoveries_ms)}
        del hang
        cfg = EngineConfig(**CP_KW)
        telemetry.reset_for_tests()
        cleng = Engine(params, cfg, device=DEVICE,
                       chaos=ChaosSpec({}))
        poison = Engine(params, cfg, device=DEVICE,
                        chaos=ChaosSpec({"serve_poison_logits":
                                         {CP_POISON_STEP}}))
        first, second = reqs[:CP_KW["max_batch"]], reqs[4:8]
        vids = [poison.submit(p, **kw) for p, kw in first]
        poison.run()
        victims = [(poison.request(i).state, poison.request(i).finish_reason)
                   for i in vids]
        check(victims == [(FAILED, "error")] * len(vids)
              and poison.counters["nan_logits"] == len(vids)
              and poison.alloc.num_used == 0,
              f"[b] poison victims {victims}, nan_logits "
              f"{poison.counters['nan_logits']}")
        check(all(bool(torch.isfinite(t).all())
                  for t in (poison.kpool, poison.vpool)),
              "[b] NaN left in the pools after the scrub")
        want = [cleng.result(cleng.submit(p, **kw)) for p, kw in second]
        again = [poison.result(poison.submit(p, **kw)) for p, kw in second]
        check(again == want, "[b] requests reusing the scrubbed blocks "
              "differ from a clean engine's")
        injected = {k: v for k, v in telemetry.snapshot_flat().items()
                    if k.startswith("serve.chaos_injected")}
        check(injected == {"serve.chaos_injected{kind=poison}": 1},
              f"[b] poison injections {injected}")
        out["b"]["poison_victims"] = len(vids)
        log("  (b) hang + poison: " + json.dumps(out["b"]))
        cp_check_forms(fd, (), "(b)")
        del cleng, poison

        # (c) rolling swaps: bench.py's hotswap row (a null update)
        hot = cp_router(torch, params)
        fresh = {k: np.array(v, copy=True) for k, v in params.items()}
        got, wall, summary = cp_run(
            torch, hot, reqs, steps_before=CP_SWAP_STEPS,
            between=lambda: hot.rolling_swap(fresh))
        cp_check_fleet(hot, got, ref, "c, hot")
        check(summary["mode"] == "hot" and len(summary["swap_ms"]) == 2
              and [r.engine.swap_count for r in hot.replicas] == [1, 1],
              f"[c] hot swap: {summary['mode']}, {summary['swap_ms']}")
        out["c"] = {"mode": summary["mode"], "swap_ms": summary["swap_ms"],
                    "tokens_per_s": sum(map(len, got)) / wall,
                    "throughput_frac": (sum(map(len, got)) / wall)
                    / out["a"]["clean_tokens_per_s"]}
        # an incompatible signature (one more tensor: the key set
        # changed) rebuilds each replica behind its drain
        changed = dict(fresh, extra_unused_weight=np.zeros(4, np.float32))
        engines = [r.engine for r in hot.replicas]
        try:
            hot.rolling_swap(changed, allow_rebuild=False)
            check(False, "[c] an incompatible swap with rebuild "
                  "forbidden did not raise")
        except SmokeFailure:
            raise
        except Exception as exc:   # noqa: BLE001 — the refusal under test
            check("rebuild is disabled" in str(exc),
                  f"[c] forbidden rebuild raised {exc!r}")
        check([r.engine for r in hot.replicas] == engines
              and all(r.state == HEALTHY and r.engine.swap_count == 1
                      for r in hot.replicas),
              "[c] the forbidden rebuild touched the fleet")
        telemetry.reset_for_tests()
        got, wall, summary = cp_run(
            torch, hot, reqs, steps_before=CP_SWAP_STEPS,
            between=lambda: hot.rolling_swap(changed, allow_rebuild=True))
        cp_check_fleet(hot, got, ref, "c, rebuild")
        check(summary["mode"] == "rebuild"
              and not summary["report"]["compatible"]
              and all(r.engine is not e
                      for r, e in zip(hot.replicas, engines))
              and telemetry.snapshot_flat().get("online.rebuilds") == 2,
              f"[c] rebuild: {summary['mode']}, {summary['report']}")
        out["c"]["rebuild_swap_ms"] = summary["swap_ms"]
        out["c"]["rebuild_tokens_per_s"] = sum(map(len, got)) / wall
        log("  (c) rolling swaps: " + json.dumps(out["c"]))
        cp_check_forms(fd, (hot,), "(c)")
        del hot

        # (d) the gameday: clean, chaos, replay
        t0 = time.perf_counter()
        trace = generate_trace(TraceConfig(**GAMEDAY_TRACE))
        runs = {label: cp_gameday(torch, params, trace, chaos)
                for label, chaos in (("clean", {}),
                                     ("gameday", GAMEDAY_CHAOS),
                                     ("replay", GAMEDAY_CHAOS))}
        game, clean_r, replay = (runs[k] for k in ("gameday", "clean",
                                                   "replay"))
        for label in ("clean", "gameday"):
            r = runs[label]
            check(r["scale"]["scale_ups"] >= 1
                  and r["scale"]["scale_downs"] >= 1,
                  f"[d {label}] scale events {r['scale_sched']}")
            check(r["kv_leak"] == 0, f"[d {label}] KV leak {r['kv_leak']}")
        check(game["failovers"] >= 1, "[d] the gameday had no failover")
        common = sorted(set(clean_r["stream_keys"])
                        & set(game["stream_keys"]))
        check(common and all(clean_r["stream_keys"][k]
                             == game["stream_keys"][k] for k in common),
              "[d] the gameday's streams differ from the clean run's")
        for key in ("stream_keys", "scale_sched", "shed_set", "failovers"):
            check(replay[key] == game[key],
                  f"[d] the replay's {key} differs from the gameday's")
        out["d"] = {label: {k: runs[label][k] for k in (
            "requests", "completed", "shed", "failed", "shed_rate",
            "failovers", "tok_per_s", "p50_ttft_ms", "p99_ttft_ms",
            "p50_itl_ms", "p99_itl_ms", "router_steps", "wall_s",
            "scale_sched", "replica_states", "bench_bars")}
            for label in ("clean", "gameday", "replay")}
        out["d"]["shared_stream_keys"] = len(common)
        out["d"]["seconds"] = time.perf_counter() - t0
        log("  (d) gameday: " + json.dumps(out["d"]))
        cp_check_forms(fd, (), "(d)")

        # (e) speculation under the router
        out["e"] = cp_speculate(torch, np, params, fd)
        launches = (fd.flash_decode_attention.launches,
                    fd.flash_decode_attention.launches_fp8)
    finally:
        _build._compile = compile_
    check(launches[0] > 0 and launches[1] == 0,
          f"phase 12 flash-decode launches {launches}")
    check(built == [] and set(_build._loaded) == loaded,
          f"kernels built after warmup: {built}, "
          f"{sorted(set(_build._loaded) - loaded)}")
    log(f"  phase 12: {launches[0]} K5 launches, all in the hopper form; "
        "no kernel built")
    return launches[0], out


def cp_profile(torch, params, reqs, steps=5):
    """Five router steps of two full replicas under ``torch.profiler``:
    wall and device-busy ms a router step, host ms a replica step, idle
    share, device ms by layer."""
    router = cp_router(torch, params)
    ids = [router.submit(p, **kw)
           for p, kw in reqs[:2 * CP_KW["max_batch"]]]
    while any(not rr.tokens for rr in router._requests.values()):
        router.step()
    prof = profile_step(torch, lambda: [router.step()
                                        for _ in range(steps)],
                        _SERVE_KERNEL_GROUPS,
                        label=f"profiled {steps} router steps")
    stepped = 2 * steps
    out = {"router_step_ms": prof["wall_ms"] / steps,
           "host_ms_per_replica_step": (prof["wall_ms"]
                                        - prof["device_busy_ms"]) / stepped,
           "device_busy_ms": prof["device_busy_ms"] / steps,
           "idle_share": prof["idle_share"],
           "by_layer_ms": {k: v / steps
                           for k, v in prof["by_layer_ms"].items()}}
    router.run()
    check(all(router.request(i).done() for i in ids),
          "the profiled requests did not finish")
    cp_check_deaths(router, "a, profile")
    return out


def cp_gameday(torch, params, trace, chaos):
    """One run of the gameday trace (bench.py's ``_trace_gameday``)."""
    from mxnet_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                       EngineConfig, LoadGen)
    from mxnet_tpu_torch.serve.traffic import VirtualClock
    clock = VirtualClock()
    router = cp_router(torch, params, n=1, chaos=chaos, clock=clock,
                       ecfg=EngineConfig(**CP_KW, prefill_chunk=16),
                       rcfg=dict(heartbeat_timeout_ms=GAMEDAY_HEARTBEAT_MS,
                                 shed_queue_depth=GAMEDAY_SHED_QUEUE))
    asc = Autoscaler(router, AutoscaleConfig(**GAMEDAY_POLICY), clock=clock)
    res = LoadGen(router, trace, clock, step_virtual_s=GAMEDAY_STEP_S,
                  autoscaler=asc).run()
    for _ in range(3):
        router.step()                   # retire finished drains
    torch.cuda.synchronize()
    cp_check_deaths(router, "d " + ("gameday" if chaos else "clean"), chaos)
    res["kv_leak"] = sum(rep.engine.alloc.num_used
                         for rep in router.replicas if rep.state != "dead")
    res["scale"] = asc.summary()
    res["scale_sched"] = [(e["direction"], round(e["t"], 3), e["target"])
                          for e in asc.events]
    res["shed_set"] = sorted((r["sid"], r["turn"]) for r in res["records"]
                             if r["finish_reason"] == "shed")
    res["replica_states"] = [(r.state, r.death_cause)
                             for r in router.replicas]
    label = "gameday" if chaos else "clean"
    ttft_bar, itl_bar, shed_bar = GAMEDAY_BARS[label]
    res["bench_bars"] = {
        f"p99_ttft_ms <= {ttft_bar}": (res["p99_ttft_ms"] is not None
                                       and res["p99_ttft_ms"] <= ttft_bar),
        f"p99_itl_ms <= {itl_bar}": (res["p99_itl_ms"] is not None
                                     and res["p99_itl_ms"] <= itl_bar),
        f"shed_rate <= {shed_bar}": res["shed_rate"] <= shed_bar}
    return res


def cp_speculate(torch, np, params, fd):
    """(e): two speculating replicas with the model drafter (the target's
    own weights), phase 11's geometry; replica 0 crashes mid-stream, and
    a draft swap of the same weights lands mid-stream.  Streams equal the
    clean speculating fleet's and the non-speculative fleet's, but for
    counted true near-ties."""
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve import EngineConfig
    prompts = spec_prompts(np)[:CP_SPEC_REQUESTS]
    reqs = [(p, dict(max_new_tokens=CP_SPEC_NEW, seed=i))
            for i, p in enumerate(prompts)]
    plain_cfg = EngineConfig(**SPEC_KW)
    spec_cfg = EngineConfig(**SPEC_KW, speculate=True, spec_k=SPEC_K,
                            spec_draft="model", spec_window=SPEC_WINDOW)

    def fleet(chaos=None):
        return cp_router(torch, params, chaos=chaos, ecfg=spec_cfg,
                         draft_params=params, draft_heads=HEADS)

    plain = cp_router(torch, params, ecfg=plain_cfg)
    base, _, _ = cp_run(torch, plain, reqs)
    cp_check_deaths(plain, "e, non-speculative")
    cp_check_forms(fd, (plain,), "(e) non-speculative fleet")
    clean = fleet()
    ref, clean_wall, _ = cp_run(torch, clean, reqs)
    cp_check_fleet(clean, ref, ref, "e, clean")
    chaos = {0: {"serve_crash": {CP_SPEC_CRASH}}}
    crash = fleet(chaos)
    got, wall, _ = cp_run(torch, crash, reqs)
    cp_check_fleet(crash, got, ref, "e, crash", chaos)
    check(crash.stats()["failovers"] >= 1,
          f"[e] no failover under speculation: {crash.stats()['failovers']}")
    eng = crash.replicas[1].engine
    ties = sum(spec_divergence(torch, eng, p, a, b, transformer)
               for p, a, b in zip(prompts, got, base))
    swap = fleet()
    got_swap, _, res = cp_run(
        torch, swap, reqs, steps_before=2,
        between=lambda: swap.rolling_swap(
            {k: np.array(v, copy=True) for k, v in params.items()},
            target="draft"))
    cp_check_fleet(swap, got_swap, ref, "e, draft swap")
    check(res["mode"] == "draft"
          and [r.engine.counters["draft_swaps"] for r in swap.replicas]
          == [1, 1], f"[e] draft swaps: {res}")
    out = {"failovers": crash.stats()["failovers"],
           "near_ties_vs_non_speculative": ties,
           "draft_swap_ms": res["swap_ms"],
           "tokens_per_s": sum(map(len, got)) / wall,
           "clean_tokens_per_s": sum(map(len, ref)) / clean_wall}
    log("  (e) speculation under the router: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The serving A/B: phases 4 and 11 over two checkouts of the port, in turns
# ---------------------------------------------------------------------------

def serve_only(torch, np, fd):
    """Phases 4 and 11 alone; returns their host-bound figures."""
    t0 = time.perf_counter()
    _, p4 = phase_serve(torch, np, fd)
    p4_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, p11 = phase_speculate(torch, np, fd)
    return {"p4": {k: p4[k] for k in ("tokens_per_s", "median_decode_step_ms",
                                      "p50_ttft_ms")},
            "p4_s": p4_s,
            "p11": {k: {m: v[m] for m in ("tokens_per_s", "median_step_ms")}
                    for k, v in p11.items() if isinstance(v, dict)},
            "p11_s": time.perf_counter() - t0}


def timed_calls(tally, owner, name, restore):
    """Replace ``owner.name`` by a wrapper that adds each call and the
    host seconds inside it to ``tally``; ``restore`` collects the undo."""
    fn = getattr(owner, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            tally["s"] += time.perf_counter() - t0
            tally["calls"] += 1

    restore.append((owner, name, fn))
    setattr(owner, name, call)


def telemetry_cost(torch, np, fd):
    """``--telemetry-cost``: phases 4 and 11 with every call the port makes
    into its telemetry plane timed (metric lookups and updates, spans,
    flight records), beside the time inside ``Engine.step``: the share of
    the serving loop's steps that telemetry costs, measured in place."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import Engine
    from mxnet_tpu_torch.telemetry import flight, metrics
    out = {}
    for label, run in (("p4", phase_serve), ("p11", phase_speculate)):
        tel, steps, restore = ({"calls": 0, "s": 0.0},
                               {"calls": 0, "s": 0.0}, [])
        for name in ("counter", "gauge", "histogram", "span",
                     "flight_recorder"):
            timed_calls(tel, telemetry, name, restore)
        for name in ("inc", "set", "observe"):
            timed_calls(tel, metrics.Metric, name, restore)
        timed_calls(tel, flight.FlightRecorder, "record", restore)
        timed_calls(steps, Engine, "step", restore)
        try:
            run(torch, np, fd)
        finally:
            for owner, name, fn in restore:
                setattr(owner, name, fn)
        out[label] = {"telemetry_calls": tel["calls"],
                      "telemetry_s": tel["s"], "steps": steps["calls"],
                      "step_s": steps["s"],
                      "share_of_step_time": tel["s"] / steps["s"]}
    return out


def serve_ab(parent):
    """``--serve-ab PARENT``: phases 4 and 11 over the port at ``PARENT`` (a
    checkout of an earlier commit) and over this checkout's, in the turns
    parent, change, change, parent, each turn a process of its own on the
    same card.  Phases 4 and 11 must be the same code in both checkouts:
    this script drives both, so only the package differs."""
    roots = {"parent": os.path.abspath(parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    log(card_line())
    rows = []
    for turn in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--serve-only",
             roots[turn]], cwd=roots[turn], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
            log(f"chip_smoke: the {turn} turn failed ({proc.returncode})")
            return 1
        rows.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                         turn=turn))
        log(json.dumps(rows[-1]))
    log(card_line())
    return 0


# ---------------------------------------------------------------------------
# Phase 7: ResNet-50 training at full width
# ---------------------------------------------------------------------------

def init_numpy(np, sym, shapes, aux_shapes, seed=0):
    """Parameters and aux states drawn with numpy by the default
    initializer rule: Uniform(0.07) weights, gamma 1, beta and bias 0,
    moving mean 0, moving var 1."""
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("weight"):
            args[n] = rng.uniform(-0.07, 0.07, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = np.ones(s, np.float32)
        else:
            args[n] = np.zeros(s, np.float32)
    aux = {n: (np.ones if n.endswith("var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def cross_entropy(torch, prob, label):
    picked = prob[torch.arange(prob.shape[0], device=prob.device),
                  label.long()]
    return float(-torch.log(picked).mean())


def bits(torch, t):
    return t.detach().contiguous().view(torch.int32)


def k2_plan_check(tr):
    """The trainer takes K2's hopper route with one pointer table and
    every chunk's flat offset on the 16-byte grid (the vector path)."""
    plan = tr._chunk_plan
    check(tr._fused_route == "hopper",
          f"the trainer's fused route is {tr._fused_route}, not hopper")
    check(len(plan.tables) == 1 and bool(plan.chunks[:, 3].all()),
          f"K2's chunk plan: {len(plan.tables)} tables, "
          f"{int((plan.chunks[:, 3] == 0).sum())} chunks off the grid")
    log(f"  K2 chunk plan: {len(plan.sizes)} tensors, {len(plan.chunks)} "
        "chunks, one table, all on the 16-byte grid")


def k2_update_runs_no_cat(torch, run):
    """``run()`` (a fused update) with ``torch.cat`` counted: the hopper
    route reads the gradients in place, so it gathers nothing."""
    real, calls = torch.cat, []

    def counting_cat(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    torch.cat = counting_cat
    try:
        run()
    finally:
        torch.cat = real
    check(not calls, f"the fused update called torch.cat {len(calls)} "
          "times")


def phase_train(torch, np, nn_ops, fu):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer

    t0 = time.perf_counter()
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    n_params = sum(int(v.size) for v in args.values())

    def trainer(fused, arg_params, aux_params):
        tr = ShardedTrainer(sym, optimizer="sgd",
                            optimizer_params=dict(TRAIN_OPT), guard=True,
                            clip_global_norm=CLIP, fused_update=fused,
                            device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=arg_params, aux_params=aux_params)

    tr = trainer(True, args, aux)
    check(tr._fused and tr._flat_wd is not None,
          "the trainer did not take the fused path with a wd vector")
    n_buckets = len(tr._fused_plan.buckets)
    check(n_buckets == N_BUCKETS or DEVICE != "cuda",
          f"{n_buckets} buckets, expected {N_BUCKETS}")
    k2_plan_check(tr)
    rng = np.random.RandomState(2)
    batch = tr.place_batch({
        "data": rng.rand(*shapes["data"]).astype(np.float32),
        "softmax_label": rng.randint(0, CLASSES, BATCH).astype(np.float32)})
    label = batch["softmax_label"]
    torch.cuda.synchronize()
    log(f"  ResNet-{DEPTH}: {n_params} parameters in {n_buckets} buckets, "
        f"bound in {time.perf_counter() - t0:.2f} s")

    # the main path's run: every count starts at 0 here
    nn_ops.softmax_rows.launches = 0
    nn_ops.softmax_rows.launches_by_form = dict.fromkeys(
        nn_ops.softmax_rows.launches_by_form, 0)
    fu.fused_update.launches = 0
    fu.fused_update.launches_by_form = dict.fromkeys(
        fu.fused_update.launches_by_form, 0)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        heads = tr.step(batch)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(cross_entropy(torch, heads[0], label))
    check(int(tr._guard_state["skipped"]) == 0, "a clean step was skipped")
    # one step on a batch with a NaN: a bitwise no-op on the whole state
    bad = dict(batch)
    bad["data"] = batch["data"].clone()
    bad["data"][0, 0, 0, 0] = float("nan")
    before = [bits(torch, t).clone() for t in
              [tr._flat_w] + tr._flat_state + list(tr._aux.values())]
    heads = tr.step(bad)
    torch.cuda.synchronize()
    after = [bits(torch, t) for t in
             [tr._flat_w] + tr._flat_state + list(tr._aux.values())]
    k1 = nn_ops.softmax_rows.launches
    k1_forms = dict(nn_ops.softmax_rows.launches_by_form)
    k2 = fu.fused_update.launches
    k2_forms = dict(fu.fused_update.launches_by_form)
    steps = 2 + TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    log(f"  losses {['%.4f' % v for v in losses]}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(int(tr._guard_state["skipped"]) == 1,
          "the NaN step was not skipped")
    check(all(torch.equal(a, b) for a, b in zip(before, after)),
          "the NaN step changed parameters, optimizer state or moving "
          "statistics")
    check(k1 == steps, f"softmax_rows launched {k1} times in {steps} steps")
    check(k1_forms == {"warp": k1, "block": 0},
          f"softmax_rows launches by form {k1_forms}, expected all warp")
    check(k2 == steps and k2_forms == {"hopper": steps, "bucket": 0},
          f"fused_update launched {k2} times in {steps} steps, by form "
          f"{k2_forms}: expected one hopper launch a step")
    log(f"  NaN step: skipped, state bitwise unchanged; launches K1 {k1} "
        f"(all in the warp form), K2 {k2} over {steps} steps (all in the "
        "hopper form)")
    profile = profile_step(torch, lambda: tr.step(batch))

    # fused vs unfused from the same gradients, bitwise: cuDNN's backward
    # is not deterministic, so both updates consume one set of gradients
    arg_now, aux_now = tr.get_params()
    ref = trainer(False, arg_now, aux_now)
    with torch.no_grad():
        for n, st in tr.opt_state_by_param().items():
            ref._opt_state[n].copy_(st[0])
    ref._num_update = tr._num_update
    _, grads, auxu, _, _ = tr._forward_backward(batch)
    # the step's rate and count into their 0-d tensors, as a step fills
    # them before its device work
    tr._num_update += 1
    tr._fill_step_scalars()
    k2_update_runs_no_cat(torch, lambda: tr._apply_update(grads, auxu))
    ref._num_update += 1
    ref._fill_step_scalars()
    ref._apply_update(grads, auxu)
    torch.cuda.synchronize()
    fused_state = tr.opt_state_by_param()
    for n in tr._param_names:
        check(torch.equal(bits(torch, tr._params[n]),
                          bits(torch, ref._params[n])),
              f"fused and unfused updates differ on {n}")
        check(torch.equal(bits(torch, fused_state[n][0]),
                          bits(torch, ref._opt_state[n])),
              f"fused and unfused momentum differ on {n}")
    for n in tr._aux:
        check(torch.equal(bits(torch, tr._aux[n]), bits(torch, ref._aux[n])),
              f"fused and unfused aux states differ on {n}")
    log("  fused vs unfused update from the same gradients: bitwise equal")

    med = float(np.median(step_ms))
    stats = {"params": n_params, "buckets": n_buckets, "batch": BATCH,
             "median_step_ms": med, "step_ms": step_ms,
             "images_per_s": BATCH / med * 1e3,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_gib": peak_gb, "profile": profile}
    log("  train: " + json.dumps(stats))
    return {"softmax_rows": k1, "fused_update": k2}, stats


# kernel-name fragments -> the layer whose work the kernel does
_KERNEL_GROUPS = (
    ("K1 softmax_rows", ("softmax_rows_",)),
    ("K2 fused_update", ("fused_update_kernel",
                         "fused_update_params_kernel")),
    ("convolution/matmul (cuDNN, cuBLAS)",
     ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
      "fprop", "winograd", "cutlass", "fft")),
    ("pooling", ("pool",)),
    ("reductions (BatchNorm statistics, grad norm)", ("reduce",)),
    ("gradient bucket cat", ("CatArray", "cat_")),
    ("elementwise (BatchNorm, ReLU, add, guard)", ("elementwise",)),
)


# kernel-name fragments of the LM step -> the layer whose work it does
_LM_KERNEL_GROUPS = (
    ("K3 flash attention forward", ("flash_fwd_",)),
    ("K4 flash attention backward", ("flash_bwd_",)),
    ("K2 fused update", ("fused_update_kernel",
                         "fused_update_params_kernel")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                         "nvjet")),
    ("gradient bucket cat", ("CatArray", "cat_")),
    ("reductions (LayerNorm, logsumexp, softmax, grad norm)",
     ("reduce", "softmax", "Softmax", "SoftMax", "norm")),
    ("embedding gather/scatter", ("index", "embedding", "gather",
                                  "scatter", "sort", "radix")),
    ("elementwise (casts, LayerNorm, ReLU, residual, loss head)",
     ("elementwise",)),
)
# CPU ops whose kernels are the loss head's (inclusive device time)
_LOSS_HEAD_OPS = ("aten::logsumexp", "aten::gather",
                  "_SoftmaxOutputFnBackward")


# kernel-name fragments of a serving decode step -> the layer
_SERVE_KERNEL_GROUPS = (
    ("K5 / K5-fp8 flash decode", ("decode_hopper_kernel",
                                  "decode_partial_kernel",
                                  "combine_kernel")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                         "nvjet")),
    ("KV writes and gathers (index_put, index)", ("index", "scatter",
                                                  "gather")),
    ("reductions (LayerNorm, argmax, row absmax)", ("reduce", "norm")),
    ("elementwise (LayerNorm, ReLU, residual, casts, quantize)",
     ("elementwise",)),
)
# kernel-name fragments of a speculative verify step (and a model
# drafter's unroll) -> the layer
_VERIFY_KERNEL_GROUPS = (
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                         "nvjet")),
    ("KV writes, gathers and scrubs (index_put, index)",
     ("index", "scatter", "gather")),
    ("sampling (top-k, random draws)", ("topk", "sort", "radix", "philox",
                                        "distribution", "bitonic")),
    ("reductions (LayerNorm, softmax, argmax, row absmax, scans)",
     ("reduce", "norm", "softmax", "scan")),
    ("elementwise (LayerNorm, ReLU, residual, masks, casts, quantize)",
     ("elementwise",)),
)


def profile_step(torch, run, groups_spec=_KERNEL_GROUPS, loss_ops=(),
                 label="profiled step", named_ops=()):
    """``run()`` (a training step, or a few serving steps) under
    ``torch.profiler``: device time by layer, the busiest kernels, and
    the share of the wall time in which the card ran no kernel.
    ``loss_ops`` names CPU ops whose inclusive device time is reported as
    ``loss_head_ms`` (those kernels also sit in the groups);
    ``named_ops`` others, each reported alone in ``named_ops_ms``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels, other, loss_us, named_us = {}, [], [], {}, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            for op in named_ops:
                if op == ev.key:
                    named_us[op] = max(named_us.get(op, 0.0),
                                       ev.device_time_total)
            for op in loss_ops:
                # the autograd wrapper event and the node share a name:
                # keep the largest, so nothing counts twice
                if op in ev.key:
                    loss_us[op] = max(loss_us.get(op, 0.0),
                                      ev.device_time_total)
            continue
        if ev.key in named_ops:
            # a marked range's span on the card, not a kernel
            continue
        us = ev.self_device_time_total
        kernels.append((us, ev.key, ev.count))
        group = next((g for g, frags in groups_spec
                      if any(f in ev.key for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        if group == "other":
            other.append((us, ev.key))
    busy_ms = sum(groups.values())
    kernels.sort(reverse=True)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "by_layer_ms": dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1])),
           "top_kernels": [{"name": k[:80], "ms": us / 1e3, "count": c}
                           for us, k, c in kernels[:10]],
           "top_other": [{"name": k[:80], "ms": us / 1e3}
                         for us, k in sorted(other, reverse=True)[:4]]}
    if named_ops:
        out["named_ops_ms"] = {k: v / 1e3 for k, v in named_us.items()}
    if loss_ops:
        out["loss_head_ms"] = sum(loss_us.values()) / 1e3
        out["loss_head_ops_ms"] = {k: v / 1e3 for k, v in loss_us.items()}
    log(f"  {label}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 8: kernel timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=50, hide_host=True, sleep=1 << 20):
    """Median per-call device time with CUDA events, L2 flushed before
    each call.  With ``hide_host`` a sleep kernel (``sleep`` cycles,
    about 0.5 ms by default) runs between the flush and the start event,
    so the host has enqueued all of ``fn``'s launches before the card
    reaches them: the events then time the device work alone, not the
    Python launch overhead.  Without it the time is per call as a caller
    sees it (host gaps included)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(sleep)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_row(torch, kernel, plain, library):
    """Device times of the kernel, its plain version and the library
    call, plus the kernel's per-call time with host overhead."""
    return {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "call_ms": time_ms(torch, kernel, hide_host=False)}


def turns(torch, fns, reps=50, sleep=1 << 20):
    """Device ms of each callable of ``{name: fn}``, timed in turns (in
    the order given, then reversed; the mean of the two)."""
    got = {n: [] for n in fns}
    for n in list(fns) + list(reversed(list(fns))):
        got[n].append(time_ms(torch, fns[n], reps, sleep=sleep))
    return {n: sum(t) / len(t) for n, t in got.items()}


def decode_yardstick(torch, kv, q, k_pool, v_pool, tables, lens):
    """One gather (dequantizing fp8 pools, widening to ``q``'s type) and
    ``F.scaled_dot_product_attention`` over K5's inputs: the library
    yardstick of K5 and K5-fp8, never used by the port."""
    import torch.nn.functional as F
    B, nblk = tables.shape

    def dense(pool, idx):
        if kv.is_quantized(pool):
            pay = pool.payload.view(torch.uint8)[idx].view(pool.payload.dtype)
            x = pay.float() * pool.scale[idx][..., None, None]
        else:
            x = pool[idx].to(q.dtype)
        bs, h, hd = x.shape[2:]
        return x.reshape(B, nblk * bs, h, hd).transpose(1, 2)

    def library():
        idx = tables.long()
        k, v = dense(k_pool, idx), dense(v_pool, idx)
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                              attn_mask=mask)[:, :, 0]

    return library


def decode_work(B, H, hd, BS, lengths, esize, quantized, q_esize=4):
    """The least bytes and operations of one decode call: each valid K/V
    position read once (for fp8 with its two f32 scales), each used table
    entry, q and lengths read once, the output written once; q.k and p.v
    (multiply + add), and for fp8 one dequantizing multiply per K and V
    element."""
    valid = int(sum(int(n) for n in lengths))
    used_cols = int(sum(-(-int(n) // BS) for n in lengths))
    nbytes = (2 * valid * H * hd * esize + (2 * valid * 4 if quantized
                                            else 0)
              + used_cols * 4 + B * 4 + 2 * B * H * hd * q_esize)
    return nbytes, (6 if quantized else 4) * valid * H * hd


def phase_timing_decode(torch, np, fd, quant, kv, quantized):
    """K5 (f32 pools) or K5-fp8 (the same pools quantized by
    ``rowwise_quantize``) at the served decode shape (B 8, H 8, hd 64, BS
    16, 64 columns, decode-time lengths of the served mix, f32 ``q``):
    the hopper and warp forms in turns and per call, beside the plain
    version and a gather (+ dequantization) + SDPA yardstick."""
    B, H, hd, BS, nblk = 8, 8, 64, 16, 64
    rng = np.random.RandomState(11)
    # decode-time lengths of the served mix: prompts 32-512 + 64 new
    lengths = rng.randint(32 + 1, 512 + NEW_TOKENS + 1, size=B)
    q, kp, vp, tables, lens = decode_inputs(
        torch, np, seed=12, B=B, H=H, hd=hd, BS=BS, nblk=nblk, npool=520,
        lengths=lengths, dtype=torch.float32)
    if quantized:
        kp, vp = quantize_pool(quant, kv, kp), quantize_pool(quant, kv, vp)
    what = "K5-fp8" if quantized else "K5"

    def run(form=None):
        return fd.flash_decode_attention(q, kp, vp, tables, lens, form=form)

    library = decode_yardstick(torch, kv, q, kp, vp, tables, lens)
    check(fd.kernel_form(kp, vp) == "hopper",
          f"{what}: kernel_form did not pick the hopper form")
    lib_err = (library() - run()).abs().max().item()
    torch.cuda.synchronize()
    check(lib_err <= 1e-4, f"{what} library yardstick disagrees: {lib_err}")
    t = turns(torch, {f: (lambda f=f: run(f)) for f in DECODE_FORMS})
    nbytes, flops = decode_work(B, H, hd, BS, lengths, 1 if quantized else 4,
                                quantized)
    row = dict(bound(nbytes, flops), ms=t["hopper"], warp_ms=t["warp"],
               plain_ms=time_ms(torch, lambda: fd.flash_decode_attention_ref(
                   q, kp, vp, tables, lens)),
               library_ms=time_ms(torch, library),
               call_ms=time_ms(torch, run, hide_host=False),
               warp_call_ms=time_ms(torch, lambda: run("warp"),
                                    hide_host=False),
               form="hopper", library_max_abs_err=lib_err)
    row["hopper_speedup"] = row["warp_ms"] / row["ms"]
    log(f"  timing {what}: " + json.dumps(row))
    return row


# phase 8's decode sweep: B 8, H 8, hd 64, BS 16, f32 q, every request
# at the full context; the yardstick's gather materialises the whole
# context (about 1 GiB a pool at 32768), so it stops at 8192
DECODE_SWEEP = (512, 2048, 8192, 32768)
DECODE_SWEEP_LIBRARY_MAX = 8192


def sweep_inputs(torch, seed, B, H, hd, BS, ctx):
    """``B`` requests of ``ctx`` positions each over distinct random
    blocks, made on the card from ``seed``: f32 q, K and V pools of
    ``B * ctx / BS + 1`` blocks, tables and lengths."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    cols = ctx // BS
    npool = B * cols + 1
    f32 = dict(device=DEVICE, generator=g)
    q = torch.randn(B, H, hd, **f32)
    kp = torch.randn(npool, BS, H, hd, **f32)
    vp = torch.randn(npool, BS, H, hd, **f32)
    tables = (torch.randperm(npool - 1, **f32)[:B * cols] + 1).int()
    lens = torch.full((B,), ctx, dtype=torch.int32, device=DEVICE)
    return q, kp, vp, tables.view(B, cols), lens


def phase_decode_sweep(torch, np, fd, quant, kv):
    """K5 and K5-fp8 at contexts of ``DECODE_SWEEP`` positions with f32,
    bf16 and fp8 pools: both forms in turns (checked against each other,
    and up to 8192 against the plain version), ms, GB/s and the share of
    the bytes bound, hopper over warp, fp8 over f32; the yardstick up to
    ``DECODE_SWEEP_LIBRARY_MAX``."""
    B, H, hd, BS = 8, HEADS, D_MODEL // HEADS, 16
    rows = []
    for ctx in DECODE_SWEEP:
        q, k32, v32, tables, lens = sweep_inputs(torch, 900 + ctx, B, H, hd,
                                                 BS, ctx)
        f32_ms = None
        for pool in ("float32", "bfloat16", "fp8"):
            if pool == "fp8":
                kp = quantize_pool(quant, kv, k32)
                vp = quantize_pool(quant, kv, v32)
            else:
                kp = k32.to(getattr(torch, pool))
                vp = v32.to(getattr(torch, pool))
            check(fd.kernel_form(kp, vp) == "hopper",
                  f"sweep {ctx} {pool}: kernel_form did not pick hopper")

            def run(form, kp=kp, vp=vp):
                return fd.flash_decode_attention(q, kp, vp, tables, lens,
                                                 form=form)

            outs = {f: run(f) for f in DECODE_FORMS}
            torch.cuda.synchronize()
            err = (outs["hopper"] - outs["warp"]).abs().max().item()
            if ctx <= DECODE_SWEEP_LIBRARY_MAX:
                ref = fd.flash_decode_attention_ref(q, kp, vp, tables, lens)
                err = max(err, (outs["hopper"] - ref).abs().max().item())
                del ref
            check(err <= TOL["float32"], f"sweep {ctx} {pool}: the forms "
                  f"disagree by {err} (tol {TOL['float32']})")
            t = turns(torch, {f: (lambda f=f: run(f)) for f in DECODE_FORMS},
                      reps=20)
            esize = 1 if pool == "fp8" else kp.element_size()
            nbytes, flops = decode_work(B, H, hd, BS, [ctx] * B, esize,
                                        pool == "fp8")
            b = bound(nbytes, flops)
            row = {"context": ctx, "pool": pool, "max_abs_err": err,
                   "bytes": nbytes, "bound_ms": b["bound_ms"]}
            for f in DECODE_FORMS:
                row[f + "_ms"] = t[f]
                row[f + "_gb_per_s"] = nbytes / t[f] / 1e6
                row[f + "_bound_share"] = b["bound_ms"] / t[f]
            row["hopper_speedup"] = t["warp"] / t["hopper"]
            if ctx <= DECODE_SWEEP_LIBRARY_MAX:
                row["library_ms"] = time_ms(torch, decode_yardstick(
                    torch, kv, q, kp, vp, tables, lens), 20)
            if pool == "float32":
                f32_ms = t["hopper"]
            else:
                row["f32_over_this"] = f32_ms / t["hopper"]
            rows.append(row)
            log("  decode sweep: " + json.dumps(row))
            del kp, vp, outs
        del k32, v32
        torch.cuda.empty_cache()
    return rows


def phase_launch_floor(torch):
    """The floor of one event-timed launch: an empty kernel
    (``torch.cuda._sleep(0)``) timed as every kernel here is."""
    floor = time_ms(torch, lambda: torch.cuda._sleep(0))
    log(f"  launch floor (empty kernel, events): {floor:.6f} ms")
    return floor


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the rate for their type (f32 by default), whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def phase_timing_k1(torch, np, nn_ops):
    """K1 at the training shape [64, 1000] f32: the warp and block forms
    and ``torch.softmax`` in turns, beside the plain version; the block
    form at [8, 16384] beside ``torch.softmax``."""
    n, c = BATCH, CLASSES
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(DEVICE)
    lib_err = (torch.softmax(x, -1) - nn_ops.softmax_rows(x)).abs().max()
    check(lib_err.item() <= K1_TOL["float32"],
          f"library yardstick disagrees: {lib_err.item()}")
    check(nn_ops.softmax_rows_form(c) == "warp",
          f"K1 at {c} columns picks {nn_ops.softmax_rows_form(c)}")
    t = turns(torch, {
        "warp": lambda: nn_ops.softmax_rows(x, form="warp"),
        "block": lambda: nn_ops.softmax_rows(x, form="block"),
        "library": lambda: torch.softmax(x, -1)})
    # each element read once and written once; max, subtract, exp, add and
    # divide per element
    row = dict(bound(2 * n * c * 4, 5 * n * c), ms=t["warp"],
               block_ms=t["block"],
               plain_ms=time_ms(torch, lambda: nn_ops.softmax_rows_ref(x)),
               library_ms=t["library"],
               call_ms=time_ms(torch, lambda: nn_ops.softmax_rows(x),
                               hide_host=False),
               form="warp", library_max_abs_err=lib_err.item())
    wide = torch.from_numpy(rng.randn(8, 16384).astype(np.float32)).to(
        DEVICE)
    tw = turns(torch, {"block": lambda: nn_ops.softmax_rows(wide),
                       "library": lambda: torch.softmax(wide, -1)})
    row["block_8x16384"] = dict(bound(2 * wide.numel() * 4,
                                      5 * wide.numel()),
                                ms=tw["block"], library_ms=tw["library"])
    log("  timing K1: " + json.dumps(row))
    return row


# K2's bytes per element: sgd with momentum and a wd vector reads g, w,
# mom and wd and writes w and mom; adam with a scalar wd reads g, w, m and
# v and writes w, m and v
K2_BYTES = {"sgd_momentum": 6 * 4, "adam": 7 * 4}
# operations per element (the rounded ops of the chain, mult to the store)
K2_FLOPS = {"sgd_momentum": 8, "adam": 15}
# the sleep before a timed step-shape update: long enough (about 4 ms)
# for the host to enqueue the gather and 50 bucket launches
K2_STEP_SLEEP = 1 << 23


def k2_step_shapes(np, fu):
    """``{label: (kind, sizes in plan order, bucket sizes)}`` of the two
    training paths' updates: ResNet-50 (161 tensors, sgd with momentum,
    wd vector, mult, ok) and the LM (101 tensors, adam, scalar wd 0),
    from the symbols' ``infer_shape`` and the trainer's 4 MiB plan."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel.collectives import DEFAULT_BUCKET_BYTES
    out = {}
    for label, kind, sym, shapes in (
            ("resnet50_step", "sgd_momentum",
             models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH),
             dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))),
            ("lm_step", "adam",
             models.get_symbol("transformer-lm", vocab_size=VOCAB,
                               num_layers=LAYERS, d_model=D_MODEL,
                               heads=HEADS, batch_size=LM_BATCH,
                               seq_len=LM_SEQ, loss_head=True),
             dict(data=(LM_BATCH, LM_SEQ),
                  softmax_label=(LM_BATCH, LM_SEQ)))):
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        shape_of = dict(zip(sym.list_arguments(), arg_shapes))
        names = [n for n in sym.list_arguments() if n not in shapes]
        plan = fu.build_plan(names, shape_of, DEFAULT_BUCKET_BYTES)
        out[label] = (kind, [int(np.prod(plan.shapes[n]))
                             for n in plan.order], plan.bucket_sizes)
    return out


def k2_timing_case(torch, np, fu, kind, sizes, bucket_sizes, seed):
    """K2 over one update of ``sizes`` gradients (separate allocations,
    as autograd leaves them) into flat buffers: the hopper form (one
    launch a table), the bucket form (the trainer's gather into one flat
    gradient, none for a single gradient, then one launch per bucket of
    ``bucket_sizes``) and
    ``torch.optim``'s fused ``SGD``/``Adam`` over the same tensors (a
    multi-tensor kernel: the yardstick of the same design, never used by
    the port; its formula has a scalar weight decay and no mult or ok), in
    turns; the plain version (the gather and ``reference_update``); the
    bytes bound; both forms per call."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = sum(sizes)
    f32 = dict(dtype=torch.float32, device=dev)
    g_all = torch.randn(n, generator=gen, **f32)
    offsets = np.cumsum([0] + list(sizes[:-1])).tolist()
    grads = [g_all[o:o + k].clone() for o, k in zip(offsets, sizes)]
    del g_all
    w = torch.randn(n, generator=gen, **f32)
    lr = torch.full((), 0.1 if kind == "sgd_momentum" else 1e-3, **f32)
    if kind == "sgd_momentum":
        state = (torch.zeros(n, **f32),)
        wdvec = torch.zeros(n, **f32)
        for o, k in zip(offsets, sizes):
            # weight decay on the large (weight) tensors, none on the
            # small ones (biases, norm parameters), as ResNet-50's wd
            # vector has it
            if k > 4096:
                wdvec[o:o + k] = 1e-4
        hyper = dict(kind=kind, momentum=0.9, rescale_grad=1.0 / BATCH,
                     mult=torch.full((), 0.5, **f32),
                     ok=torch.tensor(True, device=dev), wd_vec=wdvec)
        scalars = (lr,)
    else:
        state = (torch.zeros(n, **f32), torch.zeros(n, **f32))
        hyper = dict(kind=kind, beta1=0.9, beta2=0.999, epsilon=1e-8)
        scalars = (lr,)
    plan = fu.plan_chunks(offsets, sizes)
    bounds = np.cumsum([0] + list(bucket_sizes)).tolist()

    def hopper():
        fu.fused_update_params(grads, w, state, plan, scalars, **hyper)

    def gather():
        # one gradient already is the flat bucket
        return torch.cat(grads) if len(grads) > 1 else grads[0]

    def bucket():
        g_flat = gather()
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            fu.fused_update(g_flat[b0:b1], w[b0:b1],
                            tuple(s[b0:b1] for s in state), scalars,
                            form="bucket",
                            **dict(hyper, wd_vec=None if "wd_vec" not in
                                   hyper else hyper["wd_vec"][b0:b1]))

    def plain():
        fu.reference_update(gather(), w, state, scalars, **hyper)

    params = [torch.nn.Parameter(w[o:o + k].clone())
              for o, k in zip(offsets, sizes)]
    for p, g in zip(params, grads):
        p.grad = g
    if kind == "sgd_momentum":
        lib = torch.optim.SGD(params, lr=0.1, momentum=0.9,
                              weight_decay=1e-4, fused=True)
    else:
        lib = torch.optim.Adam(params, lr=1e-3, fused=True)
    lib.step()
    before = fu.fused_update.launches_by_form["hopper"]
    hopper()
    torch.cuda.synchronize()
    check(fu.fused_update.launches_by_form["hopper"] - before
          == len(plan.tables), "K2 timing: hopper launches per call")
    sleep = K2_STEP_SLEEP if len(sizes) > 1 else 1 << 20
    t = turns(torch, {"hopper": hopper, "bucket": bucket,
                      "library": lib.step}, sleep=sleep)
    row = dict(bound(K2_BYTES[kind] * n, K2_FLOPS[kind] * n),
               ms=t["hopper"], bucket_ms=t["bucket"],
               plain_ms=time_ms(torch, plain, sleep=sleep),
               library_ms=t["library"],
               call_ms=time_ms(torch, hopper, hide_host=False),
               bucket_call_ms=time_ms(torch, bucket, hide_host=False),
               form="hopper", kind=kind, tensors=len(sizes), elements=n,
               buckets=len(bucket_sizes), chunks=len(plan.chunks))
    row["of_bound"] = row["bound_ms"] / row["ms"]
    row["bucket_of_bound"] = row["bound_ms"] / row["bucket_ms"]
    del params, lib, grads, w, state
    torch.cuda.empty_cache()
    return row


# K2's extra keys in the kernels line: the bucket form in the same turns
# and the other two shapes
K2_LINE_KEYS = ("bucket_ms", "of_bound", "lm_step", "bucket_shape")


def phase_timing_k2(torch, np, fu):
    """K2 in both forms, in turns: over one full bucket (1,048,576
    elements, sgd with momentum, a wd vector, mult and ok) and over the
    two training paths' whole updates (ResNet-50's 161 tensors, the LM's
    101).  The ResNet-50 update, the first main path's, is the row of
    the kernels line; the other two ride in it."""
    rows = {}
    for label, (kind, sizes, buckets) in k2_step_shapes(np, fu).items():
        rows[label] = k2_timing_case(torch, np, fu, kind, sizes, buckets,
                                     seed=14)
    rows["bucket_shape"] = k2_timing_case(
        torch, np, fu, "sgd_momentum", [1 << 20], [1 << 20], seed=15)
    for label, r in rows.items():
        log(f"  timing K2 {label}: " + json.dumps(r))
    row = dict(rows["resnet50_step"])
    row["lm_step"] = rows["lm_step"]
    row["bucket_shape"] = rows["bucket_shape"]
    return row


# the length sweep of phase 8: bf16 causal, B * L = 16384 tokens, D 64,
# H 8
K34_SWEEP = (512, 1024, 2048, 4096, 8192)


def k34_bounds(B, H, L, D, esize, rate):
    """The card's least time for K3 and K4 on causal [B, L, H, D]
    operands: K3 reads q, k, v and writes out and lse once and does two
    products over half the L x L scores; K4 reads q, k, v, out, do and
    lse and writes dq, dk, dv once and does five (s, do v^T, ds k, ds^T q,
    p^T do)."""
    n = B * H * L * D
    mm = 2 * B * H * D * L * L // 2
    return (bound(4 * n * esize + B * H * L * 4, 2 * mm, rate),
            bound(8 * n * esize + B * H * L * 4, 5 * mm, rate))


def k34_times(torch, fa, q, k, v, out, lse, do, kw, forms, reps=50):
    """Device ms of K3 and K4 in each form of ``forms``, timed in turns
    (``turns``)."""
    fns = {}
    for f in forms:
        fns[f, "fwd"] = lambda f=f: fa.flash_fwd(q, k, v, form=f, **kw)
        fns[f, "bwd"] = lambda f=f: fa.flash_bwd(q, k, v, out, lse, do,
                                                 form=f, **kw)
    t = turns(torch, fns, reps)
    return {f: {d: t[f, d] for d in ("fwd", "bwd")} for f in forms}


def sdpa_fns(torch, q, k, v, do):
    """``F.scaled_dot_product_attention`` on the same inputs in [B, H, L,
    D]: its causal output, its forward, and its backward alone (from a
    retained graph)."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

    return lib_out.transpose(1, 2), lib_fwd, lib_bwd


def phase_timing_k34(torch, np, fa):
    """K3 and K4 at the LM's shape (B 8, H 8, L 2048, D 64, causal,
    blhd): bf16 in the hopper form and the mma.sync form in turns, f32 in
    its (fma) form, beside their plain versions and
    ``F.scaled_dot_product_attention`` (its forward for K3, its backward
    alone for K4).  K4's times include its delta kernel.  Then the length
    sweep: bf16 causal at ``K34_SWEEP`` with 16384 tokens, both tensor-core
    forms beside SDPA and the bounds."""
    B, H, L, D = LM_BATCH, HEADS, LM_SEQ, D_MODEL // HEADS
    kw = dict(causal=True, scale=1.0 / D ** 0.5, layout="blhd")
    rows = {}
    for dtype, rate, dname, forms in (
            (torch.float32, F32_FLOP_PER_S, "f32", ("fma",)),
            (torch.bfloat16, BF16_FLOP_PER_S, "bf16", ("hopper", "mma"))):
        q, k, v, do = attn_operands(torch, np, 600, "blhd", B, H, L, L, D,
                                    dtype)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        lib_out, lib_fwd, lib_bwd = sdpa_fns(torch, q, k, v, do)
        # the yardstick computes the same function (its own rounding)
        lib_err = attn_err(torch, lib_out, out, torch.bfloat16)
        torch.cuda.synchronize()
        check(lib_err <= K34_TOL["bf16_rel"],
              f"SDPA yardstick disagrees with K3 ({dname}): {lib_err}")
        times = k34_times(torch, fa, q, k, v, out, lse, do, kw, forms)
        b_fwd, b_bwd = k34_bounds(B, H, L, D, q.element_size(), rate)
        fwd = dict(b_fwd, ms=times[forms[0]]["fwd"],
                   plain_ms=time_ms(torch, lambda: fa.flash_fwd_ref(
                       q, k, v, **kw)),
                   library_ms=time_ms(torch, lib_fwd),
                   call_ms=time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw),
                                   hide_host=False),
                   form=forms[0], library_max_rel_err=lib_err)
        bwd = dict(b_bwd, ms=times[forms[0]]["bwd"],
                   plain_ms=time_ms(torch, lambda: fa.flash_bwd_ref(
                       q, k, v, out, lse, do, **kw)),
                   library_ms=time_ms(torch, lib_bwd),
                   call_ms=time_ms(torch, lambda: fa.flash_bwd(
                       q, k, v, out, lse, do, **kw), hide_host=False),
                   form=forms[0])
        for f in forms[1:]:
            fwd[f + "_ms"] = times[f]["fwd"]
            bwd[f + "_ms"] = times[f]["bwd"]
        for r in (fwd, bwd):
            r["tflops"] = r["flops"] / r["ms"] / 1e9
            r["vs_library"] = r["ms"] / r["library_ms"]
        rows[dname] = {"flash_attn_fwd": fwd, "flash_attn_bwd": bwd}
        log(f"  timing K3 {dname}: " + json.dumps(fwd))
        log(f"  timing K4 {dname}: " + json.dumps(bwd))
    hop = rows["bf16"]
    for name, what in (("flash_attn_fwd", "K3"), ("flash_attn_bwd", "K4")):
        speedup = hop[name]["mma_ms"] / hop[name]["ms"]
        log(f"  {what} bf16: hopper form {speedup:.2f}x as fast as the "
            f"mma.sync form, {hop[name]['vs_library']:.2f}x SDPA's time")
        check(speedup >= 2.0, f"{what}'s hopper form is only "
              f"{speedup:.2f}x as fast as its mma.sync form")

    sweep = []
    for L in K34_SWEEP:
        B = 16384 // L
        q, k, v, do = attn_operands(torch, np, 700 + L, "blhd", B, H, L, L,
                                    D, torch.bfloat16)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        _, lib_fwd, lib_bwd = sdpa_fns(torch, q, k, v, do)
        times = k34_times(torch, fa, q, k, v, out, lse, do, kw,
                          ("hopper", "mma"), reps=20)
        b_fwd, b_bwd = k34_bounds(B, H, L, D, 2, BF16_FLOP_PER_S)
        row = {"L": L, "B": B,
               "fwd": {"hopper_ms": times["hopper"]["fwd"],
                       "mma_ms": times["mma"]["fwd"],
                       "library_ms": time_ms(torch, lib_fwd, 20),
                       "bound_ms": b_fwd["bound_ms"]},
               "bwd": {"hopper_ms": times["hopper"]["bwd"],
                       "mma_ms": times["mma"]["bwd"],
                       "library_ms": time_ms(torch, lib_bwd, 20),
                       "bound_ms": b_bwd["bound_ms"]}}
        sweep.append(row)
        log("  K3/K4 sweep: " + json.dumps(row))
    rows["sweep"] = sweep
    return rows


# ---------------------------------------------------------------------------
# Phase 9: transformer-LM training at full width and depth
# ---------------------------------------------------------------------------

def lm_batch(np, seed=0):
    """One fixed batch of numpy tokens; the labels are the next tokens."""
    toks = np.random.RandomState(seed).randint(0, VOCAB,
                                               (LM_BATCH, LM_SEQ + 1))
    return {"data": toks[:, :-1].astype(np.float32),
            "softmax_label": toks[:, 1:].astype(np.float32)}


def phase_train_lm(torch, np, fa, fu):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer
    # parallel.ring_attention is the function; the module is imported
    ra = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")

    t0 = time.perf_counter()
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    n_params = sum(int(v.size) for v in args.values())

    def trainer(fused, arg_params):
        tr = ShardedTrainer(sym, optimizer="adam",
                            optimizer_params=dict(LM_OPT),
                            compute_dtype="bfloat16", fused_update=fused,
                            device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=arg_params)

    tr = trainer(True, args)
    check(tr._fused and tr._fused_kind == "adam",
          "the LM trainer did not take the fused Adam path")
    n_buckets = len(tr._fused_plan.buckets)
    k2_plan_check(tr)
    batch = tr.place_batch(lm_batch(np))
    torch.cuda.synchronize()
    log(f"  LM: {n_params} parameters in {n_buckets} buckets, bound in "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path's run: every count starts at 0 here
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    fa.flash_fwd.launches_by_form = dict.fromkeys(fa.flash_fwd.launches_by_form,
                                                  0)
    fa.flash_bwd.launches_by_form = dict.fromkeys(fa.flash_bwd.launches_by_form,
                                                  0)
    fu.fused_update.launches = 0
    fu.fused_update.launches_by_form = dict.fromkeys(
        fu.fused_update.launches_by_form, 0)
    ra.local_attention.dense_calls = 0
    ra.blockwise_attention.calls = 0
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        heads = tr.step(batch)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(heads[0].float().mean()))
    k3, k4 = fa.flash_fwd.launches, fa.flash_bwd.launches
    k3_forms = dict(fa.flash_fwd.launches_by_form)
    k4_forms = dict(fa.flash_bwd.launches_by_form)
    k2 = fu.fused_update.launches
    k2_forms = dict(fu.fused_update.launches_by_form)
    dense, blockwise = ra.local_attention.dense_calls, \
        ra.blockwise_attention.calls
    steps = 1 + TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    log(f"  losses {['%.4f' % v for v in losses]}")
    check(heads[0].shape == (LM_BATCH * LM_SEQ,)
          and heads[0].dtype == torch.float32,
          f"loss head gave {heads[0].dtype}{tuple(heads[0].shape)}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(k3 == LAYERS * steps, f"K3 launched {k3} times in {steps} steps "
          f"of {LAYERS} layers")
    check(k4 == LAYERS * steps, f"K4 launched {k4} times in {steps} steps "
          f"of {LAYERS} layers")
    for what, forms, n in (("K3", k3_forms, k3), ("K4", k4_forms, k4)):
        check(forms["hopper"] == n, f"{what} launched {forms} by form: not "
              "all in the hopper form")
    check(dense == 0 and blockwise == 0, f"attention left the flash path: "
          f"dense {dense}, blockwise {blockwise} calls")
    check(k2 == steps and k2_forms == {"hopper": steps, "bucket": 0},
          f"fused_update launched {k2} times in {steps} steps, by form "
          f"{k2_forms}: expected one hopper launch a step")
    log(f"  launches over {steps} steps: K3 {k3}, K4 {k4}, K2 {k2} (all in "
        "the hopper form); dense and blockwise attention 0")
    profile = profile_step(torch, lambda: tr.step(batch), _LM_KERNEL_GROUPS,
                           _LOSS_HEAD_OPS)

    # fused vs unfused Adam from the same gradients, bitwise (the
    # embedding's scatter-add on the card need not be deterministic, so
    # both updates consume one set of gradients)
    arg_now, _ = tr.get_params()
    ref = trainer(False, arg_now)
    with torch.no_grad():
        for n, st in tr.opt_state_by_param().items():
            for dst, src in zip(ref._opt_state[n], st):
                dst.copy_(src)
    ref._num_update = tr._num_update
    _, grads, auxu, _, _ = tr._forward_backward(batch)
    # the step's rate and count into their 0-d tensors, as a step fills
    # them before its device work
    tr._num_update += 1
    tr._fill_step_scalars()
    k2_update_runs_no_cat(torch, lambda: tr._apply_update(grads, auxu))
    ref._num_update += 1
    ref._fill_step_scalars()
    ref._apply_update(grads, auxu)
    torch.cuda.synchronize()
    fused_state = tr.opt_state_by_param()
    for n in tr._param_names:
        check(torch.equal(bits(torch, tr._params[n]),
                          bits(torch, ref._params[n])),
              f"fused and unfused Adam updates differ on {n}")
        for a, b in zip(fused_state[n], ref._opt_state[n]):
            check(torch.equal(bits(torch, a), bits(torch, b)),
                  f"fused and unfused Adam moments differ on {n}")
    log("  fused vs unfused Adam update from the same gradients: bitwise "
        "equal")

    med = float(np.median(step_ms))
    stats = {"params": n_params, "buckets": n_buckets, "batch": LM_BATCH,
             "seq": LM_SEQ, "median_step_ms": med, "step_ms": step_ms,
             "tokens_per_s": LM_BATCH * LM_SEQ / med * 1e3,
             "loss_first": losses[0], "loss_last": losses[-1],
             "peak_gib": peak_gb, "profile": profile}
    log("  train LM: " + json.dumps(stats))
    return {"flash_attn_fwd": k3, "flash_attn_bwd": k4,
            "fused_update": k2}, stats


# ---------------------------------------------------------------------------
# Phase 13: the training loop, ShardedTrainer.fit at full width
# ---------------------------------------------------------------------------

def loop_images(np, n, seed):
    """``n`` seeded synthetic images (float32, drawn a batch at a time)
    and their labels."""
    rng = np.random.RandomState(seed)
    x = np.empty((n,) + IMAGE, np.float32)
    for i in range(0, n, BATCH):
        x[i:i + BATCH] = rng.rand(min(BATCH, n - i), *IMAGE)
    return x, rng.randint(0, CLASSES, n).astype(np.float32)


def host_sums(np, *arrays):
    """The exact int64 sum of each float32 array's bits."""
    return [int(np.ascontiguousarray(a, np.float32).view(np.int32)
                .astype(np.int64).sum()) for a in arrays]


def watch_batches(torch, tr, record):
    """Wrap ``tr.step`` and ``tr._step_acc`` as ``fit`` calls them: each
    records, on the consumer stream and with no sync, the int64 sums of
    the placed batch's data and label bits before and after the step, and
    the learning rate the step used (``_lr_dev``)."""
    names = tr._input_names

    def sums(b):
        return torch.stack([b[n].contiguous().view(torch.int32)
                            .sum(dtype=torch.int64) for n in names])

    def watched(real):
        def run(batch, *args):
            before = sums(batch)
            out = real(batch, *args)
            record.append((before, sums(batch), tr._lr_dev.clone()))
            return out
        return run

    tr.step, tr._step_acc = watched(tr.step), watched(tr._step_acc)


def read_watch(torch, record):
    """``([[data, label] sums before, after] a step, lrs)`` of the watched
    steps, in one copy to the host each."""
    sums = torch.stack([torch.stack([b, a]) for b, a, _ in record])
    return (sums.cpu().tolist(),
            torch.stack([lr for _, _, lr in record]).cpu().tolist())


def check_sums(sums, want, what):
    check(len(sums) == len(want),
          f"{what}: {len(sums)} steps, {len(want)} host batches")
    for i, ((before, after), host) in enumerate(zip(sums, want)):
        check(before == host and after == host,
              f"{what}, step {i}: the placed batch's bit sums {before} "
              f"(after the step {after}) are not the host batch's {host}")


def record_event(torch):
    """A timing event recorded on the current stream (no sync)."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def event_ms(torch, events, per_epoch):
    """Milliseconds between consecutive events within each epoch of
    ``per_epoch`` events."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b)
            for i, (a, b) in enumerate(zip(events, events[1:]))
            if (i + 1) % per_epoch]


class SyncCounter:
    """Counts synchronizing CUDA calls: under
    ``torch.cuda.set_sync_debug_mode("warn")`` each one warns, and the
    warnings are counted by where they were made: on the main thread
    inside a drain (a method of ``drains``, wrapped while counting, or a
    block under :meth:`drain`), on the main thread outside one, or on
    any other thread (``fit``'s prefetch worker).  The drain depth is the
    thread's own, so a worker's sync never hides in a main-thread
    drain."""

    def __init__(self, torch, drains=()):
        self.torch, self.drains = torch, list(drains)
        self.counts = {"outside": 0, "drains": 0, "other threads": 0}
        self.sites = {}             # bucket -> {site: count}
        self._local = threading.local()
        self._saved, self._warn = [], None

    def drain(self, fn, *args):
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        try:
            return fn(*args)
        finally:
            self._local.depth = depth

    def _wrap(self, owner, name):
        real = getattr(owner, name)
        had, old = name in vars(owner), vars(owner).get(name)

        def drained(*args, **kwargs):
            return self.drain(lambda: real(*args, **kwargs))

        setattr(owner, name, drained)
        self._saved.append((owner, name, had, old))

    def start(self):
        import traceback
        import warnings
        self.counts = dict.fromkeys(self.counts, 0)
        for owner, name in self.drains:
            self._wrap(owner, name)

        def show(message, *args, **kwargs):
            if "synchroniz" not in str(message):
                return
            thread = threading.current_thread()
            if thread is not threading.main_thread():
                where = "other threads"
            elif getattr(self._local, "depth", 0):
                where = "drains"
            else:
                where = "outside"
            self.counts[where] += 1
            # the thread and the three innermost Python frames that made
            # the call
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")][-3:]
            site = f"[{thread.name}] " + " < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(frames))
            by = self.sites.setdefault(where, {})
            by[site] = by.get(site, 0) + 1

        self.sites = {}
        # the mode switch first: it is not one of the calls counted
        self.torch.cuda.set_sync_debug_mode("warn")
        self._warn = (warnings.showwarning, list(warnings.filters))
        warnings.simplefilter("always")
        warnings.showwarning = show

    def stop(self):
        import warnings
        if self._warn is not None:
            warnings.showwarning, warnings.filters[:] = self._warn
            self._warn = None
            self.torch.cuda.set_sync_debug_mode("default")
        for owner, name, had, old in reversed(self._saved):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._saved = []
        return dict(self.counts)


def state_diff(torch, a, b):
    """The parts of two fused trainers' state that are not bitwise equal:
    weights, optimizer state, moving statistics, guard counters."""
    pairs = [("weights", a._flat_w, b._flat_w)]
    pairs += [(f"optimizer state {i}", u, v)
              for i, (u, v) in enumerate(zip(a._flat_state, b._flat_state))]
    pairs += [(n, a._aux[n], b._aux[n]) for n in a._aux]
    pairs += [(f"guard {k}", a._guard_state[k], b._guard_state[k])
              for k in a._guard_state or ()]
    return [n for n, u, v in pairs
            if not torch.equal(u.detach().reshape(-1).view(torch.uint8),
                               v.detach().reshape(-1).view(torch.uint8))]


def reset_train_counts(*kernels):
    for k in kernels:
        k.launches = 0
        k.launches_by_form = dict.fromkeys(k.launches_by_form, 0)


def phase_train_loop(torch, np, nn_ops, fu, fa, _build, r50_step_ms,
                     lm_step_ms):
    """Phase 13: ``fit`` on ResNet-50 through ``examples/train_model.py``'s
    flow, again under chaos, then on the LM; returns the launches of its
    fits and its numbers."""
    import logging
    import tempfile

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    t_phase = time.perf_counter()
    root = logging.getLogger()
    handler, old_level = Lines(logging.INFO), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    # every kernel was built in phase 2: an nvcc run here is a failure
    _build._compile = counting
    launches = dict.fromkeys(("softmax_rows", "fused_update",
                              "flash_attn_fwd", "flash_attn_bwd"), 0)
    out = {}
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (a) and (b) hold fit to a bare step loop bit for bit, and
            # cuDNN's default backward is not deterministic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            try:
                out["r50"] = loop_resnet(torch, np, nn_ops, fu, launches,
                                         tmp, lines, r50_step_ms)
            finally:
                (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark) = det
        out["lm"] = loop_lm(torch, np, fu, fa, launches, lm_step_ms)
    finally:
        _build._compile = compile_
        root.removeHandler(handler)
        root.setLevel(old_level)
        for line in lines:
            if line.startswith(("Epoch[", "Resilience", "chaos:",
                                "prefetch")):
                log("  | " + line)
    check(not built, f"kernels built during the training loop: {built}")
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log("  train loop: " + json.dumps(out))
    return launches, out


def loop_resnet(torch, np, nn_ops, fu, launches, tmp, lines, r50_step_ms):
    """(a) ResNet-50's fit held to a bare step loop, (b) the same under
    chaos; returns the numbers of both."""
    from mxnet_tpu_torch import callback, chaos, io, lr_scheduler, model
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.parallel.trainer import _AsyncMetric

    t0 = time.perf_counter()
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    n = LOOP_BATCHES * BATCH
    x, y = loop_images(np, n, seed=3)
    xe, ye = loop_images(np, LOOP_EVAL_BATCHES * BATCH, seed=4)
    shapes = ({"data": (BATCH,) + IMAGE}, {"softmax_label": (BATCH,)})

    def host_batch(i):
        return {"data": x[i * BATCH:(i + 1) * BATCH],
                "softmax_label": y[i * BATCH:(i + 1) * BATCH]}

    def trainer(arg_params=None, aux_params=None):
        opt = dict(TRAIN_OPT, lr_scheduler=lr_scheduler.FactorScheduler(
            **LOOP_SCHEDULE))
        tr = ShardedTrainer(sym, optimizer="sgd", optimizer_params=opt,
                            initializer=Xavier(), guard=True,
                            clip_global_norm=CLIP, device=DEVICE, seed=0)
        return tr.bind(*shapes, arg_params=arg_params, aux_params=aux_params)

    tr = trainer()
    check(tr._fused and tr._fused_route == "hopper",
          "the fit trainer did not take K2's hopper route")
    arg0, aux0 = tr.get_params()        # Xavier's draw, for every twin
    ref = trainer(arg0, aux0)
    train_iter = io.NDArrayIter(x, y, batch_size=BATCH,
                                last_batch_handle="pad")
    eval_iter = io.NDArrayIter(xe, ye, batch_size=BATCH)
    log(f"  (a) two ResNet-{DEPTH} trainers bound (Xavier), {n} train and "
        f"{len(xe)} eval images ({x.nbytes} bytes) in "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) fit, examples/train_model.py's call
    record, events, accs, seen = [], [], [], {}
    watch_batches(torch, tr, record)
    speed = callback.Speedometer(BATCH, LOOP_FREQUENT)
    checkpoint = callback.do_checkpoint(os.path.join(tmp, "r50"))
    counter = SyncCounter(torch, [
        (_AsyncMetric, "_drain"), (tr, "resilience_stats"),
        (tr, "get_params"), (tr, "score"), (tr, "_sentinel_poll")])

    def batch_end(param):
        speed(param)
        events.append(record_event(torch))
        seen["prefetch"] = param.locals["prefetch"]
        if param.nbatch == LOOP_BATCHES:        # the meter drained it
            inner = param.eval_metric.inner
            accs.append((inner.sum_metric, inner.num_inst))

    def epoch_end(epoch, symbol, arg, aux):
        counter.drain(checkpoint, epoch, symbol, arg, aux)
        if epoch == 0:
            counter.start()             # count over fit's second epoch

    reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
    t0 = time.perf_counter()
    try:
        tr.fit(train_iter, eval_data=eval_iter, eval_metric="acc",
               num_epoch=LOOP_EPOCHS, batch_end_callback=batch_end,
               epoch_end_callback=epoch_end)
    finally:
        fit_syncs = counter.stop()
    fit_ms = event_ms(torch, events, LOOP_BATCHES)
    fit_s = time.perf_counter() - t0
    k1, k1_forms = (nn_ops.softmax_rows.launches,
                    dict(nn_ops.softmax_rows.launches_by_form))
    k2, k2_forms = (fu.fused_update.launches,
                    dict(fu.fused_update.launches_by_form))
    launches["softmax_rows"] += k1
    launches["fused_update"] += k2
    steps = LOOP_EPOCHS * LOOP_BATCHES
    evals = LOOP_EPOCHS * LOOP_EVAL_BATCHES
    check(k1 == steps + evals and k1_forms["warp"] == k1,
          f"K1 launched {k1} times ({k1_forms}) over {steps} training and "
          f"{evals} eval forwards")
    check(k2 == steps and k2_forms == {"hopper": steps, "bucket": 0},
          f"K2 launched {k2} times ({k2_forms}) in {steps} steps: expected "
          "one hopper launch a step")
    # every step read the batch the host gave it, in order, at the
    # schedule's rate
    sums, lrs = read_watch(torch, record)
    check_sums(sums, [host_sums(np, *host_batch(i).values())
                      for _ in range(LOOP_EPOCHS)
                      for i in range(LOOP_BATCHES)], "(a)")
    sched = lr_scheduler.FactorScheduler(**LOOP_SCHEDULE)
    sched.base_lr = TRAIN_OPT["learning_rate"]
    want_lr = [float(np.float32(sched(k))) for k in range(1, steps + 1)]
    check(lrs == want_lr, f"learning rates {lrs}, the schedule's {want_lr}")
    prefetch = seen["prefetch"]
    check(prefetch.retry_count == 0, "the clean fit retried a batch")

    # the bare step loop over the same batches, from host batches
    ref_events, ref_heads = [], []
    for _ in range(LOOP_EPOCHS):
        for i in range(LOOP_BATCHES):
            ref_heads.append(ref.step(host_batch(i))[0])
            ref_events.append(record_event(torch))
    bare_ms = event_ms(torch, ref_events, LOOP_BATCHES)
    diff = state_diff(torch, tr, ref)
    check(not diff, f"fit and the bare step loop differ in {diff}")
    check(tr._num_update == ref._num_update == steps,
          f"update counts {tr._num_update}, {ref._num_update}")
    # the fused accuracy against a host recount of the bare loop's heads
    check(len(accs) == LOOP_EPOCHS, f"accuracy read in {len(accs)} epochs")
    for e, (got, num) in enumerate(accs):
        heads = torch.stack(ref_heads[e * LOOP_BATCHES:
                                      (e + 1) * LOOP_BATCHES]).cpu().numpy()
        hits = int((heads.argmax(-1).reshape(-1).astype(np.int32)
                    == y.astype(np.int32)).sum())
        check((got, num) == (hits, n), f"epoch {e}: fit's accuracy "
              f"{got}/{num}, a host recount {hits}/{n}")
        line = "Epoch[%d] Mesh-Train-accuracy=%f" % (e, hits / n)
        check(line in lines, f"no log line {line!r}")
    for f in ("r50-symbol.json", "r50-0001.params", "r50-0002.params"):
        check(os.path.exists(os.path.join(tmp, f)), f"{f} was not written")
    with cpu():
        _, ck_arg, ck_aux = model.load_checkpoint(os.path.join(tmp, "r50"),
                                                  LOOP_EPOCHS)
    now_arg, now_aux = tr.get_params()
    for name, v in list(now_arg.items()) + list(now_aux.items()):
        got = (ck_arg if name in now_arg else ck_aux)[name].asnumpy()
        check(got.tobytes() == v.asnumpy().tobytes(),
              f"checkpoint {name} differs from get_params()")
    log(f"  (a) fit: {steps} steps and {evals} eval forwards; batch bit "
        "sums and learning rates exact, state bitwise the bare loop's, "
        f"accuracy {[a for a, _ in accs]} of {n} exact, checkpoints reload "
        f"bitwise; K1 {k1} (warp), K2 {k2} (hopper)")

    # synchronizing calls: fit's second epoch against 8 bare steps on
    # pre-placed batches
    placed = [ref.place_batch(host_batch(i)) for i in range(LOOP_BATCHES)]
    torch.cuda.synchronize()
    bare_counter = SyncCounter(torch)
    bare_counter.start()
    try:
        for b in placed:
            ref.step(b)
    finally:
        bare_syncs = bare_counter.stop()
    check(fit_syncs["outside"] <= bare_syncs["outside"],
          f"fit's second epoch made {fit_syncs['outside']} synchronizing "
          f"calls outside its drains ({counter.sites.get('outside')}), "
          f"{LOOP_BATCHES} bare steps {bare_syncs['outside']} "
          f"({bare_counter.sites.get('outside')})")
    # the prefetch worker's copies must never wait for the card
    check(fit_syncs["other threads"] == 0,
          f"fit's prefetch worker made {fit_syncs['other threads']} "
          f"synchronizing calls ({counter.sites.get('other threads')})")
    log(f"  (a) synchronizing calls: fit's second epoch "
        f"{fit_syncs['outside']} outside its drains, "
        f"{fit_syncs['drains']} in them (Speedometer reads, epoch end, "
        f"eval) and {fit_syncs['other threads']} on the prefetch worker; "
        f"{LOOP_BATCHES} bare steps on placed batches "
        f"{bare_syncs['outside']}; where: fit {counter.sites}, bare steps "
        f"{bare_counter.sites}")
    del placed
    profile = profile_step(
        torch, lambda: ref.fit(train_iter, eval_metric="acc", num_epoch=1),
        label="profiled fit epoch")
    med_fit, med_bare = float(np.median(fit_ms)), float(np.median(bare_ms))
    # fit and the bare loop: the gaps between events recorded after each
    # batch (device time once the host runs ahead); phase 7: host wall
    # time of a step with a sync after each
    stats = {"fit_median_ms": med_fit, "fit_ms": fit_ms,
             "bare_host_batches_median_ms": med_bare, "bare_ms": bare_ms,
             "phase7_placed_synced_wall_median_ms": r50_step_ms,
             "images_per_s": BATCH / med_fit * 1e3, "fit_s": fit_s,
             "retry_count": prefetch.retry_count,
             "syncs_fit_epoch2": fit_syncs, "syncs_bare8": bare_syncs,
             "accuracy": [list(a) for a in accs],
             "fit_epoch_idle_share": profile["idle_share"],
             "fit_epoch_profile": profile}
    del tr, ref, ref_heads

    # (b) chaos through the same loop: a NaN batch and a pipeline crash
    seq = []
    wrapped = chaos.ChaosIter(io.NDArrayIter(x, y, batch_size=BATCH),
                              chaos.ChaosSpec.parse(LOOP_CHAOS))
    while True:
        try:
            seq.append(wrapped.next())
        except chaos.ChaosError:
            continue
        except StopIteration:
            break
    tb, ref_b = trainer(arg0, aux0), trainer(arg0, aux0)
    record, seen = [], {}
    watch_batches(torch, tb, record)
    old_env = os.environ.get("MXNET_TPU_CHAOS")
    os.environ["MXNET_TPU_CHAOS"] = LOOP_CHAOS
    reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
    try:
        tb.fit(io.NDArrayIter(x, y, batch_size=BATCH), eval_metric="acc",
               num_epoch=1, batch_end_callback=lambda p: seen.update(
                   prefetch=p.locals["prefetch"]))
    finally:
        if old_env is None:
            os.environ.pop("MXNET_TPU_CHAOS", None)
        else:
            os.environ["MXNET_TPU_CHAOS"] = old_env
    k1, k2 = nn_ops.softmax_rows.launches, fu.fused_update.launches
    launches["softmax_rows"] += k1
    launches["fused_update"] += k2
    check(k1 == LOOP_BATCHES and k2 == LOOP_BATCHES
          and fu.fused_update.launches_by_form["hopper"] == LOOP_BATCHES,
          f"under chaos K1 launched {k1} and K2 {k2} times "
          f"({fu.fused_update.launches_by_form}) in {LOOP_BATCHES} steps")
    for b in seq:
        ref_b.step(b)
    prefetch = seen["prefetch"]
    injected = prefetch.data_iter.injected
    check(isinstance(prefetch.data_iter, chaos.ChaosIter),
          "fit did not wrap its iterator in a ChaosIter")
    check(injected == {"nan": 1, "overflow": 0, "crash": 1},
          f"chaos injected {injected}")
    check(prefetch.retry_count == 1,
          f"{prefetch.retry_count} prefetch retries, expected 1")
    for who, t in (("fit", tb), ("the bare loop", ref_b)):
        skipped = t.resilience_stats()["skipped_steps"]
        check(skipped == 1, f"{who} under chaos skipped {skipped} steps")
    sums, _ = read_watch(torch, record)
    check_sums(sums, [host_sums(np, b.data[0].asnumpy(),
                                b.label[0].asnumpy()) for b in seq], "(b)")
    diff = state_diff(torch, tb, ref_b)
    check(not diff, f"fit under chaos and its bare loop differ in {diff}")
    log(f"  (b) chaos {LOOP_CHAOS}: 1 skipped step, 1 retry, injected "
        f"{injected}, no batch lost, bit sums exact, state bitwise the "
        "bare loop's")
    stats["chaos"] = {"skipped_steps": 1,
                      "retry_count": prefetch.retry_count,
                      "injected": dict(injected)}
    return stats


def loop_lm(torch, np, fu, fa, launches, lm_step_ms):
    """(c) the LM's fit at phase 9's width, with a metric that takes the
    buffered path, held to a bare step loop bit for bit."""
    from mxnet_tpu_torch import io, lr_scheduler, metric, models
    from mxnet_tpu_torch.parallel import ShardedTrainer

    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)

    def schedule():
        return lr_scheduler.WarmupScheduler(
            LM_LOOP_WARMUP,
            after=lr_scheduler.CosineScheduler(LM_LOOP_COSINE))

    def trainer():
        tr = ShardedTrainer(sym, optimizer="adam",
                            optimizer_params=dict(LM_OPT,
                                                  lr_scheduler=schedule()),
                            compute_dtype="bfloat16", device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=args)

    toks = np.random.RandomState(5).randint(
        0, VOCAB, (LM_LOOP_BATCHES * LM_BATCH, LM_SEQ + 1))
    data = toks[:, :-1].astype(np.float32)
    label = toks[:, 1:].astype(np.float32)
    tr, ref = trainer(), trainer()
    record, heads, events = [], [], []
    watch_batches(torch, tr, record)

    def loss_mean(lbl, pred):
        return pred.mean()

    m = metric.CustomMetric(loss_mean, name="loss")

    def batch_end(param):
        heads.append(param.locals["outs"][0])   # references: no sync
        events.append(record_event(torch))

    reset_train_counts(fu.fused_update, fa.flash_fwd, fa.flash_bwd)
    tr.fit(io.NDArrayIter(data, label, batch_size=LM_BATCH), eval_metric=m,
           num_epoch=1, batch_end_callback=batch_end)
    fit_ms = event_ms(torch, events, LM_LOOP_BATCHES)
    k3, k4, k2 = (fa.flash_fwd.launches, fa.flash_bwd.launches,
                  fu.fused_update.launches)
    forms = {"K3": dict(fa.flash_fwd.launches_by_form),
             "K4": dict(fa.flash_bwd.launches_by_form),
             "K2": dict(fu.fused_update.launches_by_form)}
    launches["flash_attn_fwd"] += k3
    launches["flash_attn_bwd"] += k4
    launches["fused_update"] += k2
    steps = LM_LOOP_BATCHES
    check(k3 == k4 == LAYERS * steps and k2 == steps,
          f"LM fit launched K3 {k3}, K4 {k4}, K2 {k2} times in {steps} steps "
          f"of {LAYERS} layers")
    for what, f in forms.items():
        check(f["hopper"] == sum(f.values()),
              f"{what} launches by form {f}: not all in the hopper form")
    sums, lrs = read_watch(torch, record)
    check_sums(sums, [host_sums(np, data[i * LM_BATCH:(i + 1) * LM_BATCH],
                                label[i * LM_BATCH:(i + 1) * LM_BATCH])
                      for i in range(steps)], "(c)")
    losses = [h.double().mean().item() for h in heads]
    check(all(np.isfinite(losses)), f"non-finite LM loss: {losses}")
    got = float(m.sum_metric) / m.num_inst
    want = float(np.mean(losses))
    check(m.num_inst == steps and abs(got - want) <= 1e-6 * abs(want),
          f"the buffered metric {got} over {m.num_inst} batches, the host "
          f"mean of fit's heads {want}")
    # the bare step loop over the same host batches, timed as fit was
    ref_events = []
    for i in range(steps):
        ref.step({"data": data[i * LM_BATCH:(i + 1) * LM_BATCH],
                  "softmax_label": label[i * LM_BATCH:(i + 1) * LM_BATCH]})
        ref_events.append(record_event(torch))
    bare_ms = event_ms(torch, ref_events, steps)
    # every run so far measured no gap (the embedding's scatter-add is
    # index_put with accumulate, which sorts its indices on the card), so
    # the state is held to the bare loop's bit for bit, as in (a)
    diff = state_diff(torch, tr, ref)
    check(not diff, f"the LM's fit and its bare loop differ in {diff}")
    med, med_bare = float(np.median(fit_ms)), float(np.median(bare_ms))
    log(f"  (c) LM fit: {steps} steps, losses {['%.4f' % v for v in losses]}, "
        f"bit sums exact, the buffered metric {got:.6f} = the host mean; "
        f"state bitwise the bare loop's; K3 {k3}, K4 {k4}, K2 {k2} "
        f"(hopper); between batch-end events {med:.2f} ms a batch in fit "
        f"and {med_bare:.2f} ms a step in the bare loop (phase 9: "
        f"{lm_step_ms:.2f} ms a step in host wall time, synced each step)")
    return {"fit_median_ms": med, "fit_ms": fit_ms,
            "bare_host_batches_median_ms": med_bare, "bare_ms": bare_ms,
            "phase9_synced_wall_median_ms": lm_step_ms, "losses": losses,
            "metric": got, "lrs": lrs,
            "tokens_per_s": LM_BATCH * LM_SEQ / med * 1e3}


# ---------------------------------------------------------------------------
# Phase 10: imperative + executor + rtc (K6)
# ---------------------------------------------------------------------------

# User kernels compiled at run time by ``mxnet_tpu_torch.rtc.CudaKernel``.
# (a) and (b) are the JAX package's tests/test_rtc.py kernels, (c) the
# reference's GPU rtc test, (d) the MLP's softmax loss head.
RTC_AXPB = r"""
extern "C" __global__ void axpb(const float* x, const float* y, float* o,
                                long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * y[i] + 1.0f;
}
"""
RTC_AXPB_BF16 = r"""
#include <cuda_bf16.h>
extern "C" __global__ void axpb_bf16(const __nv_bfloat16* x,
                                     const __nv_bfloat16* y,
                                     __nv_bfloat16* o, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n)
    o[i] = __float2bfloat16(__bfloat162float(x[i]) * __bfloat162float(y[i])
                            + 1.0f);
}
"""
RTC_DBL = r"""
extern "C" __global__ void dbl(const float* x, float* o, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}
"""
RTC_REF_EXP = r"""
extern "C" __global__ void ref_exp(const float* x, float* y, long long n) {
  __shared__ float s_rec[10];
  s_rec[threadIdx.x] = x[threadIdx.x];
  y[threadIdx.x] = expf(s_rec[threadIdx.x] * 5.0f);
}
"""
# (d) one block per row (gridDim.x rows of n / gridDim.x columns); the
# row max and the row sum reduce through warp shuffles and a shared array
# of one value per warp.  blockDim.x must be a multiple of 32.
RTC_SOFTMAX_FWD = r"""
__device__ __forceinline__ float rtc_block_reduce(float v, bool is_max,
                                                  float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : (is_max ? __int_as_float(0xff800000) : 0.0f);
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  return v;
}

extern "C" __global__ void rtc_softmax_fwd(const float* x, float* y,
                                           long long n) {
  __shared__ float red[32];
  const long long cols = n / gridDim.x;
  const float* xr = x + blockIdx.x * cols;
  float* yr = y + blockIdx.x * cols;
  float m = __int_as_float(0xff800000);
  for (long long j = threadIdx.x; j < cols; j += blockDim.x)
    m = fmaxf(m, xr[j]);
  m = rtc_block_reduce(m, true, red);
  float s = 0.0f;
  for (long long j = threadIdx.x; j < cols; j += blockDim.x)
    s += expf(xr[j] - m);
  s = rtc_block_reduce(s, false, red);
  for (long long j = threadIdx.x; j < cols; j += blockDim.x)
    yr[j] = expf(xr[j] - m) / s;
}
"""
# (d) backward of the softmax cross-entropy: dx = p - onehot(label)
RTC_SOFTMAX_BWD = r"""
extern "C" __global__ void rtc_softmax_ce_bwd(const float* p,
                                              const float* label, float* dx,
                                              long long n) {
  const long long cols = n / gridDim.x;
  const long long row = blockIdx.x;
  const long long lab = (long long)label[row];
  for (long long j = threadIdx.x; j < cols; j += blockDim.x)
    dx[row * cols + j] = p[row * cols + j] - (j == lab ? 1.0f : 0.0f);
}
"""
RTC_ROW_BLOCK = 128
# K6 against its plain versions: f32 elementwise cases within 1e-6 of
# max(1, |plain|) (the card may contract x * y + 1 into one FMA, the plain
# version rounds twice; expf is within 2 ulp); the softmax within 1e-6
# absolute (summation order); bf16 within 1e-2 absolute (inputs in
# [-1, 1]: values below 2, where a bf16 unit in the last place is 2^-7)
RTC_TOL = {"float32": 1e-6, "softmax": 1e-6, "bfloat16": 1e-2}
# the MLP of models.mnist at its published widths, batch 100 as in the
# reference's example/numpy-ops/custom_softmax.py; SGD as its README
MLP_CLASSES, MLP_IN, MLP_BATCH = 10, 784, 100
MLP_SAMPLES, MLP_EPOCHS = 6000, 2
MLP_OPT = {"learning_rate": 0.1, "momentum": 0.9,
           "rescale_grad": 1.0 / MLP_BATCH}
RTC_AXPB_ELEMS = 64 << 20


def softmax_plain(torch, x):
    """(d)'s plain version: max, exp, sum, divide."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True),)


def softmax_ce_bwd_plain(torch, p, label):
    """(d)'s backward plain version: ``p - onehot(label)``."""
    classes = torch.arange(p.shape[1], device=p.device)
    return (p - (label.long()[:, None] == classes).to(p.dtype),)


def rtc_kernels(torch, rtc):
    """The K6 kernels of the smoke test, each with its plain version."""
    return {
        "axpb": rtc.CudaKernel("axpb", RTC_AXPB,
                               reference=lambda x, y: (x * y + 1.0,)),
        "axpb_bf16": rtc.CudaKernel(
            "axpb_bf16", RTC_AXPB_BF16,
            reference=lambda x, y: ((x.float() * y.float() + 1.0).to(
                torch.bfloat16),)),
        "dbl": rtc.CudaKernel("dbl", RTC_DBL, reference=lambda x: (x * 2.0,)),
        "ref_exp": rtc.CudaKernel("ref_exp", RTC_REF_EXP, grid=(1, 1, 1),
                                  block=(10, 1, 1),
                                  reference=lambda x: (torch.exp(x * 5.0),)),
        "softmax_fwd": rtc.CudaKernel(
            "rtc_softmax_fwd", RTC_SOFTMAX_FWD,
            reference=lambda x: softmax_plain(torch, x)),
        "softmax_bwd": rtc.CudaKernel(
            "rtc_softmax_ce_bwd", RTC_SOFTMAX_BWD,
            reference=lambda p, lab: softmax_ce_bwd_plain(torch, p, lab)),
    }


def rtc_softmax_op(operator, fwd, bwd):
    """``tests/test_custom_op.py``'s ``NumpySoftmax`` as an ``NDArrayOp``
    whose bodies push K6 kernels: the forward ``fwd`` (row softmax), the
    backward ``bwd`` (``p - onehot(label)``), one block per row."""

    class RtcSoftmax(operator.NDArrayOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]]

        def forward(self, in_data, out_data):
            fwd.push([in_data[0]], [out_data[0]],
                     grid_dims=(in_data[0].shape[0],),
                     block_dims=(RTC_ROW_BLOCK,))

        def backward(self, out_grad, in_data, out_data, in_grad):
            bwd.push([out_data[0], in_data[1]], [in_grad[0]],
                     grid_dims=(out_data[0].shape[0],),
                     block_dims=(RTC_ROW_BLOCK,))

    return RtcSoftmax()


def rtc_err(torch, got, want, kind):
    """Max error of a K6 result: absolute for the softmax and bf16,
    relative to max(1, |plain|) for f32."""
    d = (got.float() - want.float()).abs()
    if kind == "float32":
        d = d / want.float().abs().clamp_min(1.0)
    return d.max().item()


def phase_rtc_vs_plain(torch, np, rtc, kern):
    """K6 cases (a)-(d) and (a) in bf16 against their plain versions on
    the card; the build times; a broken source and a wrong signature
    raise."""
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.context import as_context
    ctx = as_context(DEVICE)
    info = rtc.build([kern["axpb"]])["axpb"]
    first = info["seconds"] + info["load_seconds"]
    again = rtc.CudaKernel("axpb", RTC_AXPB)
    again._load()
    check(again.build_info["cached"], "the cached build was rebuilt")
    builds = {"first_build_s": first,
              "cached_reload_s": again.build_info["load_seconds"]}
    t0 = time.perf_counter()
    rtc.build(list(kern.values()))
    builds["rest_parallel_s"] = time.perf_counter() - t0
    log(f"  K6 builds: first user kernel {first:.2f} s (nvcc + load), "
        f"cached reload {builds['cached_reload_s'] * 1e3:.2f} ms, the other "
        f"{len(kern) - 1} in parallel {builds['rest_parallel_s']:.2f} s")
    rng = np.random.RandomState(31)
    errs = {}

    def held(name, got, want, kind):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"K6 {name}: kernel gave {got.dtype}{tuple(got.shape)}, plain "
              f"{want.dtype}{tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"K6 {name}: non-finite output")
        err = rtc_err(torch, got, want, kind)
        log(f"  K6 vs plain [{name}]: max err {err:.3e} "
            f"(tol {RTC_TOL[kind]:g})")
        check(err <= RTC_TOL[kind], f"K6 {name}: kernel disagrees with its "
              f"plain version: {err} > {RTC_TOL[kind]}")
        errs[name] = err

    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    x, y = u(8, 128), u(8, 128)
    xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    out = nd.zeros((8, 128), ctx=ctx)
    kern["axpb"].push([xs, ys], [out])
    held("(a) axpb push [8, 128] f32", out.data,
         kern["axpb"].reference(xs.data, ys.data)[0], "float32")
    big = nd.array(u(64, 96), ctx=ctx)
    view = big.slice(5, 37)                       # offset storage pointer
    out = nd.zeros(view.shape, ctx=ctx)
    kern["axpb"].push([view, view], [out])
    held("(a) axpb on a slice view", out.data,
         kern["axpb"].reference(view.data, view.data)[0], "float32")
    xb = torch.from_numpy(u(1000, 333)).to(DEVICE, torch.bfloat16)
    yb = torch.from_numpy(u(1000, 333)).to(DEVICE, torch.bfloat16)
    (ob,) = kern["axpb_bf16"](xb, yb)
    held("(a) axpb [1000, 333] bf16", ob,
         kern["axpb_bf16"].reference(xb, yb)[0], "bfloat16")
    xd = torch.from_numpy(np.arange(256, dtype=np.float32).reshape(
        2, 128)).to(DEVICE)
    n_before = len(kern["dbl"]._compiled)
    (o1,) = kern["dbl"](xd)
    (o2,) = kern["dbl"](xd)
    check(len(kern["dbl"]._compiled) == n_before + 1,
          "K6 dbl: the second call did not hit the cache")
    check(torch.equal(o1, o2), "K6 dbl: two calls differ")
    held("(b) dbl functional [2, 128]", o1, xd * 2.0, "float32")
    xe = nd.array(u(10), ctx=ctx)
    ye = nd.zeros((10,), ctx=ctx)
    kern["ref_exp"].push([xe], [ye])
    held("(c) reference test, grid 1, block 10, shared", ye.data,
         torch.exp(xe.data * 5.0), "float32")
    for shape in ((MLP_BATCH, MLP_CLASSES), (7, 1000), (3, 5)):
        xs = torch.from_numpy((4.0 * rng.randn(*shape)).astype(
            np.float32)).to(DEVICE)
        (p,) = kern["softmax_fwd"](xs, grid=(shape[0],),
                                   block=(RTC_ROW_BLOCK,))
        held(f"(d) softmax fwd {list(shape)}", p,
             softmax_plain(torch, xs)[0], "softmax")
        lab = torch.from_numpy(rng.randint(0, shape[1], shape[0]).astype(
            np.float32)).to(DEVICE)
        (dx,) = kern["softmax_bwd"](p, lab, grid=(shape[0],),
                                    block=(RTC_ROW_BLOCK,))
        held(f"(d) softmax ce bwd {list(shape)}", dx,
             softmax_ce_bwd_plain(torch, p, lab)[0], "softmax")
    broken = rtc.CudaKernel(
        "broken", 'extern "C" __global__ void broken(const float* x, '
        'float* o, long long n) { o[0] = undefined_name; }')
    try:
        broken(torch.zeros(4, device=DEVICE))
    except MXNetError as e:
        check("undefined_name" in str(e) and "nvcc" in str(e),
              f"the nvcc error lacks nvcc's message: {e}")
        log("  broken source: MXNetError carrying nvcc's message")
    else:
        raise SmokeFailure("a broken source built and launched")
    wrong = rtc.CudaKernel("wrongsig", RTC_AXPB.replace("axpb", "wrongsig"))
    try:
        wrong(torch.zeros(4, device=DEVICE))
    except MXNetError as e:
        check(wrong.build_info is None and "pointer parameters" in str(e),
              f"the signature mismatch was not caught before a build: {e}")
        log("  wrong parameter count: MXNetError before any build")
    else:
        raise SmokeFailure("a kernel with a wrong signature launched")
    return errs, builds


def phase_imperative(torch, np):
    """NDArray arithmetic, in-place ops, views, dot, reductions, save/load
    and seeded draws on the card, each against numpy."""
    import tempfile
    from mxnet_tpu_torch import ndarray as nd, random as mxrandom
    from mxnet_tpu_torch.context import as_context
    ctx = as_context(DEVICE)
    on_card = lambda arr: arr.data.device.type == ctx.torch_device.type  # noqa: E731
    rng = np.random.RandomState(32)
    x = rng.rand(4, 5).astype(np.float32) + 0.5
    y = rng.rand(4, 5).astype(np.float32) + 0.5
    a, b = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    check(on_card(a) and a.context == ctx, "nd.array is not on the card")
    for name, got, want in (("a + b", a + b, x + y), ("a - 2", a - 2, x - 2),
                            ("a * b", a * b, x * y), ("a / b", a / b, x / y),
                            ("2 ** a", 2 ** a, 2 ** x),
                            ("exp", nd.exp(a), np.exp(x))):
        check(on_card(got), f"{name} left the card")
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6,
                                   err_msg=name)
    v = a.version
    a += b
    a *= 2
    check(a.version == v + 2, f"in-place ops bumped the version "
          f"{a.version - v} times")
    np.testing.assert_allclose(a.asnumpy(), (x + y) * 2, rtol=1e-6)
    z = nd.zeros((4, 3), ctx=ctx)
    s = z.slice(1, 3)
    s[:] = 7.0
    want = np.zeros((4, 3), np.float32)
    want[1:3] = 7.0
    check(np.array_equal(z.asnumpy(), want), "a slice view's write did not "
          "reach its parent")
    m = rng.rand(5, 6).astype(np.float32)
    d = nd.dot(nd.array(x, ctx=ctx), nd.array(m, ctx=ctx))
    np.testing.assert_allclose(d.asnumpy(), x @ m, rtol=1e-5)
    np.testing.assert_allclose(nd.sum_axis(b, axis=(1,)).asnumpy(),
                               y.sum(axis=1), rtol=1e-6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.nd")
        nd.save(path, {"x": nd.array(x, ctx=ctx), "z": z})
        back = nd.load(path, ctx=ctx)
    check(sorted(back) == ["x", "z"] and on_card(back["x"]),
          "nd.load lost names or the card")
    check(back["x"].asnumpy().tobytes() == x.tobytes()
          and back["z"].asnumpy().tobytes() == want.tobytes(),
          "nd.save/load changed bytes")
    draws = []
    for _ in range(2):
        mxrandom.seed(0)
        draws.append(mxrandom.uniform(0, 1, (1000,), ctx=ctx).asnumpy())
    check(np.array_equal(draws[0], draws[1]) and 0 <= draws[0].min()
          and draws[0].max() < 1, "random.seed(0) did not replay uniform")
    log("  imperative on the card: arithmetic, in-place (version +2), "
        "slice write-through, dot, sum_axis, save/load byte-equal, seeded "
        "uniform replay: all equal numpy")


def mlp_data(np):
    """Separable synthetic MNIST-shaped data (no dataset is downloaded):
    10 class centres in 784-d plus unit noise, numpy seed 0."""
    rng = np.random.RandomState(0)
    centres = (0.2 * rng.randn(MLP_CLASSES, MLP_IN)).astype(np.float32)
    labels = rng.randint(0, MLP_CLASSES, MLP_SAMPLES)
    X = (centres[labels] + rng.randn(MLP_SAMPLES, MLP_IN)).astype(np.float32)
    return X, labels.astype(np.float32)


def mlp_params(np, ex):
    """Weights uniform in +-1/sqrt(fan_in) from numpy seed 1, biases 0."""
    rng = np.random.RandomState(1)
    params = {}
    for name in sorted(ex.arg_dict):
        if name in ("data", "softmax_label"):
            continue
        shape = ex.arg_dict[name].shape
        if name.endswith("_weight"):
            lim = 1.0 / np.sqrt(shape[1])
            params[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        else:
            params[name] = np.zeros(shape, np.float32)
    return params


def rtc_mlp(mx, head_op):
    """``models.mnist.mlp``'s body (784 -> 128 -> 64 -> 10, relu) with
    ``head_op`` (a PythonOp) as its loss head, under the JAX package's
    layer names."""
    with mx.name.NameManager():
        body = mx.models.mlp(MLP_CLASSES).get_internals()["fc3_output"]
        return head_op.get_symbol(body, mx.symbol.Variable("softmax_label"),
                                  name="softmax")


def phase_rtc_mlp(torch, np, mx, kern, nn_ops):
    """The MLP trains on the card with the K6 softmax head through
    ``simple_bind`` and ``get_updater``; its first batch against the same
    net with ``SoftmaxOutput`` (K1)."""
    ctx = mx.context.as_context(DEVICE)
    fwd, bwd = kern["softmax_fwd"], kern["softmax_bwd"]
    net = rtc_mlp(mx, rtc_softmax_op(mx.operator, fwd, bwd))
    shapes = dict(data=(MLP_BATCH, MLP_IN), softmax_label=(MLP_BATCH,))
    ex = net.simple_bind(ctx, **shapes)
    params = mlp_params(np, ex)
    ex.copy_params_from(params)
    X, Y = mlp_data(np)
    # the first batch against the built-in head (K1), same parameters
    with mx.name.NameManager():
        ref = mx.models.mlp(MLP_CLASSES).simple_bind(ctx, **shapes)
    ref.copy_params_from(params)
    batch = {"data": X[:MLP_BATCH], "softmax_label": Y[:MLP_BATCH]}
    p6 = ex.forward(is_train=True, **batch)[0].asnumpy()
    ex.backward()
    p1 = ref.forward(is_train=True, **batch)[0].asnumpy()
    ref.backward()
    agree = {"probabilities": float(np.abs(p6 - p1).max() / np.abs(p1).max())}
    for name in params:
        g6, g1 = ex.grad_dict[name].asnumpy(), ref.grad_dict[name].asnumpy()
        agree[name] = float(np.abs(g6 - g1).max()
                            / max(np.abs(g1).max(), 1e-30))
    worst = max(agree.values())
    log(f"  first batch, K6 head vs SoftmaxOutput (K1): max error relative "
        f"to the largest value {worst:.3e} (tol 1e-5)")
    check(worst <= 1e-5, f"the K6 head disagrees with SoftmaxOutput: {agree}")
    # the main path's run: the counts start at 0 here
    updater = mx.optimizer.get_updater(
        mx.optimizer.SGD(**MLP_OPT))
    names = sorted(params)
    fwd.launches = bwd.launches = 0
    k1_before = nn_ops.softmax_rows.launches
    losses, correct, times = [], [], []
    steps = 0
    for epoch in range(MLP_EPOCHS):
        for i in range(0, MLP_SAMPLES, MLP_BATCH):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ex.forward(is_train=True, data=X[i:i + MLP_BATCH],
                             softmax_label=Y[i:i + MLP_BATCH])[0]
            ex.backward()
            for k, n in enumerate(names):
                updater(k, ex.grad_dict[n], ex.arg_dict[n])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            steps += 1
            p = out.asnumpy()
            lab = Y[i:i + MLP_BATCH].astype(int)
            losses.append(float(-np.log(np.maximum(
                p[np.arange(MLP_BATCH), lab], 1e-30)).mean()))
            if epoch == MLP_EPOCHS - 1:
                correct.append(float((p.argmax(1) == lab).mean()))
    launches = {"rtc_softmax_fwd": fwd.launches,
                "rtc_softmax_bwd": bwd.launches}
    check(all(np.isfinite(losses)), "non-finite MLP loss")
    head, tail = np.mean(losses[:10]), np.mean(losses[-10:])
    check(tail < head, f"the MLP loss did not fall: {head} -> {tail}")
    acc = float(np.mean(correct))
    check(acc > 0.9, f"training accuracy {acc} <= 0.9")
    check(launches == {"rtc_softmax_fwd": steps, "rtc_softmax_bwd": steps},
          f"K6 launches {launches} != 1 forward + 1 backward per step "
          f"({steps} steps)")
    check(nn_ops.softmax_rows.launches == k1_before,
          "K1 ran on the K6-head path")
    step_ms = float(np.median(times) * 1e3)
    stats = {"steps": steps, "loss_first10": head, "loss_last10": tail,
             "train_accuracy": acc, "median_step_ms": step_ms,
             "samples_per_s": MLP_BATCH / (step_ms / 1e3),
             "first_batch_agreement": worst}
    log("  MLP 784-128-64-10 with the K6 head: " + json.dumps(stats))
    return launches, stats


def phase_timing_rtc(torch, np, kern):
    """K6 (d) at the MLP's [100, 10] beside ``torch.softmax`` (forward)
    and (a) at 64 M f32 elements beside ``torch.addcmul``."""
    rng = np.random.RandomState(14)
    x = torch.from_numpy((4.0 * rng.randn(MLP_BATCH, MLP_CLASSES)).astype(
        np.float32)).to(DEVICE)
    lab = torch.from_numpy(rng.randint(0, MLP_CLASSES, MLP_BATCH).astype(
        np.float32)).to(DEVICE)
    fwd, bwd = kern["softmax_fwd"], kern["softmax_bwd"]
    geo = dict(grid=(MLP_BATCH,), block=(RTC_ROW_BLOCK,))
    nc = MLP_BATCH * MLP_CLASSES
    p = softmax_plain(torch, x)[0]
    rows = {}
    # each element read once and written once; max, subtract, exp, add and
    # divide per element
    rows["rtc_softmax_fwd"] = dict(
        bound(2 * nc * 4, 5 * nc),
        **time_row(torch, lambda: fwd(x, **geo),
                   lambda: softmax_plain(torch, x),
                   lambda: torch.softmax(x, -1)))
    # p and the labels read once, dx written once; one subtract per element
    rows["rtc_softmax_bwd"] = dict(
        bound(2 * nc * 4 + MLP_BATCH * 4, nc),
        ms=time_ms(torch, lambda: bwd(p, lab, **geo)),
        plain_ms=time_ms(torch, lambda: softmax_ce_bwd_plain(torch, p, lab)),
        library_ms=None,
        call_ms=time_ms(torch, lambda: bwd(p, lab, **geo), hide_host=False))
    n = RTC_AXPB_ELEMS
    xa = torch.rand(n, device=DEVICE)
    ya = torch.rand(n, device=DEVICE)
    one = torch.ones(1, device=DEVICE)
    # x and y read once, o written once; a multiply and an add per element
    rows["axpb_64M"] = dict(
        bound(3 * n * 4, 2 * n),
        **time_row(torch, lambda: kern["axpb"](xa, ya),
                   lambda: kern["axpb"].reference(xa, ya),
                   lambda: torch.addcmul(one, xa, ya)))
    for name, r in rows.items():
        log(f"  timing K6 {name}: " + json.dumps(r))
    return rows


# ---------------------------------------------------------------------------
# Phase 14: the zoo and the legacy API
# ---------------------------------------------------------------------------

def phase_zoo_legacy(torch, np, nn_ops, fu, _build):
    """Phase 14: (a) the ImageNet nets through ShardedTrainer, (b)
    FeedForward and Module on the CIFAR net against a bare executor loop,
    (c) BucketingModule over the LSTM, (d) the new ops on the card against
    the CPU; returns the launches of (a)-(c) and the phase's numbers."""
    import tempfile
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    # every kernel was built in phase 2: an nvcc run here is a failure
    _build._compile = counting
    launches = {"softmax_rows": 0, "fused_update": 0}
    out = {}
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        # the replays and the bare loops are held bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        out["imagenet"] = zoo_imagenet(torch, np, nn_ops, fu, launches)
        with tempfile.TemporaryDirectory() as tmp:
            out["cifar"] = zoo_cifar(torch, np, nn_ops, launches, tmp)
        out["bucketing"] = zoo_bucketing(torch, np, nn_ops, launches)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
        _build._compile = compile_
    out["ops"] = zoo_ops_vs_cpu(torch, np)
    check(not built, f"kernels built during phase 14: {built}")
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log("  zoo and legacy API: " + json.dumps(out))
    return launches, out


def zoo_imagenet(torch, np, nn_ops, fu, launches):
    """(a) each ImageNet net: 8 steps, a replay from the same seed held
    bit for bit, Dropout's kept share, K1/K2 launches, no sync in steps
    2-8, no build; Inception-BN's profiled step and BatchNorm's share."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.parallel import ShardedTrainer

    rng = np.random.RandomState(5)
    host = {"data": rng.rand(BATCH, *IMAGE).astype(np.float32),
            "softmax_label": rng.randint(0, CLASSES, BATCH)
            .astype(np.float32)}
    stats = {}
    for name in ZOO_NETS:
        t0 = time.perf_counter()
        sym = models.get_symbol(name, num_classes=CLASSES)
        n_dropout = sum(1 for node in sym._topo() if not node.is_variable
                        and node.op.name == "Dropout")

        def trainer():
            tr = ShardedTrainer(sym, optimizer="sgd",
                                optimizer_params=dict(ZOO_OPT),
                                initializer=Xavier(),
                                compute_dtype="bfloat16", guard=True,
                                device=DEVICE, seed=0)
            return tr.bind({"data": (BATCH,) + IMAGE},
                           {"softmax_label": (BATCH,)})

        torch.cuda.reset_peak_memory_stats()
        tr = trainer()
        check(tr._fused and tr._fused_route == "hopper",
              f"{name}: the trainer did not take K2's hopper route")
        tables = len(tr._chunk_plan.tables)
        batch = tr.place_batch(host)
        torch.cuda.synchronize()
        bind_s = time.perf_counter() - t0

        def run(t, record_masks=False, counter=None):
            real, shares = nn_ops.dropout_mask, []

            def recording(x, keep, g):
                m = real(x, keep, g)
                shares.append(m.float().mean())
                return m

            heads, events = [], []
            try:
                for i in range(ZOO_STEPS):
                    nn_ops.dropout_mask = (recording if record_masks
                                           and i == 0 else real)
                    if counter is not None and i == 1:
                        counter.start()
                    heads.append(t.step(batch)[0])
                    events.append(record_event(torch))
            finally:
                nn_ops.dropout_mask = real
                syncs = counter.stop() if counter is not None else None
            return heads, events, shares, syncs

        reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
        counter = SyncCounter(torch)
        heads, events, shares, syncs = run(tr, True, counter)
        step_ms = event_ms(torch, events, ZOO_STEPS)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        label = batch["softmax_label"]
        losses = [cross_entropy(torch, h.float(), label) for h in heads]
        shares = [float(v) for v in shares]
        twin = trainer()
        run(twin)
        torch.cuda.synchronize()
        diff = state_diff(torch, tr, twin)
        k1, k1_forms = (nn_ops.softmax_rows.launches,
                        dict(nn_ops.softmax_rows.launches_by_form))
        k2, k2_forms = (fu.fused_update.launches,
                        dict(fu.fused_update.launches_by_form))
        steps = 2 * ZOO_STEPS
        log(f"  (a) {name}: losses {['%.4f' % v for v in losses]}")
        check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        check(not diff, f"{name}: a second trainer from the same seed "
              f"differs in {diff}")
        check(len(shares) == n_dropout, f"{name}: {len(shares)} Dropout "
              f"masks recorded, {n_dropout} Dropout nodes")
        check(all(abs(v - 0.5) <= ZOO_DROPOUT_TOL for v in shares),
              f"{name}: Dropout kept shares {shares}")
        check(k1 == steps and k1_forms["warp"] == k1,
              f"{name}: K1 launched {k1} times ({k1_forms}) in {steps} "
              "training forwards")
        check(k2 == steps * tables
              and k2_forms == {"hopper": k2, "bucket": 0},
              f"{name}: K2 launched {k2} times ({k2_forms}) in {steps} "
              f"steps over {tables} pointer table(s)")
        check(syncs["outside"] == 0 and syncs["other threads"] == 0,
              f"{name}: synchronizing calls in steps 2-{ZOO_STEPS}: "
              f"{syncs}")
        med = float(np.median(step_ms))
        row = {"median_step_ms": med, "step_ms": step_ms,
               "images_per_s": BATCH / med * 1e3, "peak_gib": peak_gib,
               "loss_first": losses[0], "loss_last": losses[-1],
               "dropout_kept": shares, "k2_tables": tables,
               "bind_s": bind_s, "syncs_steps_2_8": syncs}
        if name == "inception-bn":
            # BatchNorm's device time: the step's busy time less a step's
            # with BatchNorm's forward an identity
            prof = profile_step(torch, lambda: tr.step(batch),
                                label=f"{name} profiled step")
            bn = get_op("BatchNorm")
            real_fwd = bn.forward
            bn.forward = lambda ctx, params, data, gamma, beta: data
            try:
                prof_id = profile_step(
                    torch, lambda: tr.step(batch),
                    label=f"{name} step, BatchNorm an identity")
            finally:
                bn.forward = real_fwd
            bn_ms = prof["device_busy_ms"] - prof_id["device_busy_ms"]
            row.update(profile=prof, batchnorm_ms=bn_ms,
                       batchnorm_share=bn_ms / prof["device_busy_ms"],
                       idle_share=prof["idle_share"])
        launches["softmax_rows"] += nn_ops.softmax_rows.launches
        launches["fused_update"] += fu.fused_update.launches
        log(f"  (a) {name}: {med:.3f} ms a step, "
            f"{row['images_per_s']:.1f} images/s, peak {peak_gib:.2f} GiB; "
            f"replay bitwise; Dropout kept {shares}; K1 {k1} (warp), K2 "
            f"{k2} (hopper, {tables} table(s)); 0 syncs in steps 2-"
            f"{ZOO_STEPS}")
        stats[name] = row
        del tr, twin, heads, batch
        torch.cuda.empty_cache()
    return stats


def synthetic_cifar(np, n, seed=0):
    """examples/train_cifar10.py's ``synthetic_cifar``: fixed class
    prototypes plus seeded noise."""
    protos = np.random.RandomState(0).rand(10, *CIFAR_IMAGE) \
        .astype(np.float32)
    rng = np.random.RandomState(seed + 100)
    y = rng.randint(0, 10, n)
    x = protos[y] + 0.2 * rng.randn(n, *CIFAR_IMAGE).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def legacy_bitwise(torch, got, want, what):
    """Two {name: NDArray} dicts bit for bit."""
    for n, v in want.items():
        check(got[n].data.detach().reshape(-1).view(torch.uint8).equal(
            v.data.detach().reshape(-1).view(torch.uint8).to(
                got[n].data.device)), f"{what}: {n} differs")


def zoo_cifar(torch, np, nn_ops, launches, tmp):
    """(b) examples/train_cifar10.py --synthetic's FeedForward.fit, and
    Module.fit, each held bit for bit to a bare executor loop."""
    from mxnet_tpu_torch import (callback, initializer, io, metric, model,
                                 models, ndarray, optimizer)
    from mxnet_tpu_torch import module as mod_api
    from mxnet_tpu_torch.context import cpu, gpu

    sym = models.get_symbol("inception-bn-28-small")
    n = CIFAR_BATCHES * CIFAR_BATCH
    x, y = synthetic_cifar(np, n)
    xe, ye = synthetic_cifar(np, CIFAR_EVAL_BATCHES * CIFAR_BATCH, seed=1)
    inputs = {"data": (CIFAR_BATCH,) + CIFAR_IMAGE,
              "softmax_label": (CIFAR_BATCH,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**inputs)
    names = [a for a in sym.list_arguments() if a not in inputs]
    gen = torch.Generator().manual_seed(0)
    with cpu():
        args0, aux0 = {}, {}
        for a, shape in zip(sym.list_arguments(), arg_shapes):
            if a in names:
                args0[a] = ndarray.zeros(shape)
                initializer.Xavier()(a, args0[a], generator=gen)
        for a, shape in zip(sym.list_auxiliary_states(), aux_shapes):
            aux0[a] = ndarray.zeros(shape)
            initializer.Xavier()(a, aux0[a])
    ctx = gpu(0) if DEVICE == "cuda" else cpu()
    opt_kw = dict(CIFAR_OPT, skip_nonfinite=True)

    def iters():
        return (io.NDArrayIter(x, y, batch_size=CIFAR_BATCH),
                io.NDArrayIter(xe, ye, batch_size=CIFAR_BATCH))

    def timed(events):
        speed = callback.Speedometer(CIFAR_BATCH, CIFAR_FREQUENT)
        return [speed, lambda p: events.append(record_event(torch))]

    res = {}
    # FeedForward, as examples/train_model.py drives it on one device
    reset_train_counts(nn_ops.softmax_rows)
    ff_events, prefix = [], os.path.join(tmp, "cifar")
    train, val = iters()
    ff = model.FeedForward(sym, ctx=ctx, num_epoch=CIFAR_EPOCHS,
                           optimizer="sgd",
                           initializer=initializer.Xavier(),
                           arg_params=args0, aux_params=aux0, **opt_kw)
    # drains: copying the parameters in, the eval forwards, the metric's
    # reads and the checkpoint; the steps should make one synchronizing
    # call each, the LegacyGuard's fetch
    counter = SyncCounter(torch, [
        (model.FeedForward, "_init_params"), (model._TrainLoop, "_evaluate"),
        (metric.AsyncMetric, "_drain")])
    checkpoint = callback.do_checkpoint(prefix)
    counter.start()
    try:
        ff.fit(X=train, eval_data=val, kvstore=None,
               batch_end_callback=timed(ff_events),
               epoch_end_callback=lambda *a: counter.drain(checkpoint, *a))
    finally:
        ff_syncs = counter.stop()
    ff_sites = counter.sites
    ff_k1 = nn_ops.softmax_rows.launches
    res["feedforward_ms"] = event_ms(torch, ff_events, CIFAR_BATCHES)
    res["feedforward_syncs"] = ff_syncs
    res["feedforward_sync_sites"] = ff_sites

    # Module.fit from the same parameters
    reset_train_counts(nn_ops.softmax_rows)
    mod_events = []
    train, val = iters()
    m = mod_api.Module(sym, context=ctx)
    counter = SyncCounter(torch, [
        (mod_api.Module, "init_params"), (mod_api.BaseModule, "score"),
        (metric.AsyncMetric, "_drain")])
    counter.start()
    try:
        m.fit(train, eval_data=val, eval_metric="acc",
              num_epoch=CIFAR_EPOCHS, optimizer="sgd",
              optimizer_params=opt_kw, arg_params=args0, aux_params=aux0,
              batch_end_callback=timed(mod_events))
    finally:
        mod_syncs = counter.stop()
    mod_k1 = nn_ops.softmax_rows.launches
    res["module_ms"] = event_ms(torch, mod_events, CIFAR_BATCHES)
    res["module_syncs"] = mod_syncs
    res["module_sync_sites"] = counter.sites

    # the bare loop: executor forward/backward and get_updater
    reset_train_counts(nn_ops.softmax_rows)
    ex = sym.simple_bind(ctx, grad_req={a: "write" for a in names},
                         **inputs)
    ex.copy_params_from(args0, aux0)
    opt = optimizer.create("sgd", rescale_grad=1.0 / CIFAR_BATCH, sym=sym,
                           param_idx2name=dict(enumerate(names)), **opt_kw)
    updater = optimizer.get_updater(opt)
    bare_events, losses = [], []
    for _ in range(CIFAR_EPOCHS):
        for i in range(CIFAR_BATCHES):
            sl = slice(i * CIFAR_BATCH, (i + 1) * CIFAR_BATCH)
            prob = ex.forward(is_train=True, data=x[sl],
                              softmax_label=y[sl])[0]
            losses.append(prob.data)
            ex.backward()
            for k, a in enumerate(names):
                updater(k, ex.grad_dict[a], ex.arg_dict[a])
            bare_events.append(record_event(torch))
    bare_k1 = nn_ops.softmax_rows.launches
    res["bare_ms"] = event_ms(torch, bare_events, CIFAR_BATCHES)
    labels = torch.as_tensor(y).to(losses[0].device)
    per_batch = [cross_entropy(torch, p, labels[(j % CIFAR_BATCHES)
                                                * CIFAR_BATCH:
                                                (j % CIFAR_BATCHES + 1)
                                                * CIFAR_BATCH])
                 for j, p in enumerate(losses)]
    check(all(np.isfinite(per_batch)), f"bare loop losses {per_batch}")
    check(per_batch[-1] < per_batch[0], f"loss did not fall: {per_batch}")

    bare = {a: ex.arg_dict[a] for a in names}
    legacy_bitwise(torch, ff.arg_params, bare, "FeedForward against the "
                   "bare loop")
    legacy_bitwise(torch, ff.aux_params, ex.aux_dict, "FeedForward against "
                   "the bare loop (aux)")
    m_arg, m_aux = m.get_params()
    legacy_bitwise(torch, m_arg, bare, "Module against the bare loop")
    legacy_bitwise(torch, m_aux, ex.aux_dict, "Module against the bare "
                   "loop (aux)")
    with cpu():
        _, ck_arg, ck_aux = model.load_checkpoint(prefix, CIFAR_EPOCHS)
    legacy_bitwise(torch, ck_arg, ff.arg_params, "the checkpoint")
    legacy_bitwise(torch, ck_aux, ff.aux_params, "the checkpoint (aux)")
    steps = CIFAR_EPOCHS * CIFAR_BATCHES
    evals = CIFAR_EPOCHS * CIFAR_EVAL_BATCHES
    for who, k1, fwd in (("FeedForward", ff_k1, steps + evals),
                         ("Module", mod_k1, steps + evals),
                         ("the bare loop", bare_k1, steps)):
        check(k1 == fwd, f"{who}: K1 launched {k1} times in {fwd} "
              "forwards")
        launches["softmax_rows"] += k1
    med = {k: float(np.median(res[k]))
           for k in ("feedforward_ms", "module_ms", "bare_ms")}
    res.update({f"{k}_median": v for k, v in med.items()})
    for who, syncs, sites in (("FeedForward", ff_syncs, ff_sites),
                              ("Module", mod_syncs,
                               res["module_sync_sites"])):
        check(syncs["outside"] == steps or DEVICE != "cuda",
              f"{who} made {syncs['outside']} synchronizing calls outside "
              f"its drains in {steps} steps, expected the LegacyGuard's "
              f"one a step: {sites.get('outside')}")
    res["syncs_per_step"] = {
        "feedforward": ff_syncs["outside"] / steps,
        "feedforward_worker": ff_syncs["other threads"] / steps,
        "module": mod_syncs["outside"] / steps,
        "module_worker": mod_syncs["other threads"] / steps}
    res["loss_first"], res["loss_last"] = per_batch[0], per_batch[-1]
    log(f"  (b) inception-bn-28-small: FeedForward "
        f"{med['feedforward_ms']:.3f} ms a batch, Module "
        f"{med['module_ms']:.3f}, the bare loop {med['bare_ms']:.3f}; both "
        "bitwise the bare loop's, the checkpoint reloads bitwise; K1 "
        f"{ff_k1} + {mod_k1} + {bare_k1}; synchronizing calls a step "
        f"{res['syncs_per_step']}")
    return res


def lstm_unroll(S, num_hidden, seq_len, vocab, num_embed):
    """examples/lstm_bucketing.py's unrolled LSTM symbol."""
    weights = {k: S.Variable(k) for k in (
        "embed_weight", "l0_i2h_weight", "l0_i2h_bias", "l0_h2h_weight",
        "l0_h2h_bias", "cls_weight", "cls_bias")}
    c, h = S.Variable("l0_init_c"), S.Variable("l0_init_h")
    embed = S.Embedding(data=S.Variable("data"), input_dim=vocab,
                        output_dim=num_embed,
                        weight=weights["embed_weight"], name="embed")
    steps = S.SliceChannel(data=embed, num_outputs=seq_len, axis=1,
                           squeeze_axis=True, name="step_slice")
    outs = []
    for t in range(seq_len):
        i2h = S.FullyConnected(data=steps[t], num_hidden=num_hidden * 4,
                               weight=weights["l0_i2h_weight"],
                               bias=weights["l0_i2h_bias"], name=f"t{t}_i2h")
        h2h = S.FullyConnected(data=h, num_hidden=num_hidden * 4,
                               weight=weights["l0_h2h_weight"],
                               bias=weights["l0_h2h_bias"], name=f"t{t}_h2h")
        gates = S.SliceChannel(data=i2h + h2h, num_outputs=4,
                               name=f"t{t}_slice")
        in_gate = S.Activation(data=gates[0], act_type="sigmoid")
        in_trans = S.Activation(data=gates[1], act_type="tanh")
        forget = S.Activation(data=gates[2], act_type="sigmoid")
        out_gate = S.Activation(data=gates[3], act_type="sigmoid")
        c = (forget * c) + (in_gate * in_trans)
        h = out_gate * S.Activation(data=c, act_type="tanh")
        fc = S.FullyConnected(data=h, num_hidden=vocab,
                              weight=weights["cls_weight"],
                              bias=weights["cls_bias"], name=f"t{t}_cls")
        outs.append(S.expand_dims(fc, axis=1))
    logits = S.Reshape(data=S.Concat(*outs, dim=1, name="concat"),
                       shape=(-1, vocab))
    label = S.Reshape(data=S.Variable("softmax_label"), shape=(-1,))
    return S.SoftmaxOutput(data=logits, label=label, name="softmax")


def zoo_bucketing(torch, np, nn_ops, launches):
    """(c) BucketingModule over the LSTM, the buckets alternating: one
    parameter array in both buckets, the state a bare loop's bit for bit,
    a finite falling loss."""
    from mxnet_tpu_torch import io, ndarray, optimizer
    from mxnet_tpu_torch import module as mod_api
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import cpu, gpu

    hid, vocab, bsz = LSTM["num_hidden"], LSTM["vocab"], LSTM["batch"]
    data_names = ("data", "l0_init_c", "l0_init_h")

    def sym_gen(key):
        return (lstm_unroll(S, hid, key, vocab, LSTM["num_embed"]),
                data_names, ("softmax_label",))

    rng = np.random.RandomState(0)
    batches = []
    for i in range(LSTM_BATCHES):
        key = LSTM_BUCKETS[i % 2]
        seq = (rng.randint(0, vocab, (bsz, 1)) + np.arange(key + 1)) % vocab
        batches.append((key, seq[:, :-1].astype(np.float32),
                        seq[:, 1:].astype(np.float32)))
    zeros = np.zeros((bsz, hid), np.float32)

    def shapes(key):
        return ([("data", (bsz, key)), ("l0_init_c", (bsz, hid)),
                 ("l0_init_h", (bsz, hid))], [("softmax_label", (bsz, key))])

    default = max(LSTM_BUCKETS)
    net16 = sym_gen(default)[0]
    arg_shapes, _, _ = net16.infer_shape(**dict(sum(shapes(default), [])))
    names = [a for a, _ in zip(net16.list_arguments(), arg_shapes)
             if a not in data_names and a != "softmax_label"]
    prng = np.random.RandomState(1)
    params = {a: prng.uniform(-0.1, 0.1, s).astype(np.float32)
              for a, s in zip(net16.list_arguments(), arg_shapes)
              if a in names}
    ctx = gpu(0) if DEVICE == "cuda" else cpu()

    def batch_of(key, xb, yb):
        return io.DataBatch(
            data=[ndarray.array(xb, ctx=cpu()), ndarray.array(zeros,
                                                              ctx=cpu()),
                  ndarray.array(zeros, ctx=cpu())],
            label=[ndarray.array(yb, ctx=cpu())], bucket_key=key,
            provide_data=shapes(key)[0], provide_label=shapes(key)[1])

    def loss(prob, yb):
        return cross_entropy(torch, prob, torch.as_tensor(
            yb.reshape(-1)).to(prob.device))

    reset_train_counts(nn_ops.softmax_rows)
    mod = mod_api.BucketingModule(sym_gen, default_bucket_key=default,
                                  context=ctx)
    mod.bind(*shapes(default))
    with cpu():
        mod.init_params(arg_params={a: ndarray.array(v)
                                    for a, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(LSTM_OPT))
    losses = []
    for key, xb, yb in batches:
        mod.forward(batch_of(key, xb, yb), is_train=True)
        losses.append(loss(mod.get_outputs()[0].data, yb))
        mod.backward()
        mod.update()
    key0, x0, y0 = batches[0]
    mod.forward(batch_of(key0, x0, y0), is_train=False)
    after = loss(mod.get_outputs()[0].data, y0)
    mod_k1 = nn_ops.softmax_rows.launches

    # the bare loop: one executor a bucket, the second sharing the
    # first's arrays, and the updater
    reset_train_counts(nn_ops.softmax_rows)
    req = {a: "write" for a in names}
    ex = {default: net16.simple_bind(ctx, grad_req=req,
                                     **dict(sum(shapes(default), [])))}
    for k in LSTM_BUCKETS:
        if k != default:
            ex[k] = sym_gen(k)[0].simple_bind(
                ctx, grad_req=req, shared_exec=ex[default],
                **dict(sum(shapes(k), [])))
    ex[default].copy_params_from(params)
    opt = optimizer.create("sgd", rescale_grad=1.0 / bsz,
                           param_idx2name=dict(enumerate(names)),
                           **LSTM_OPT)
    updater = optimizer.get_updater(opt)
    for key, xb, yb in batches:
        e = ex[key]
        e.forward(is_train=True, data=xb, l0_init_c=zeros, l0_init_h=zeros,
                  softmax_label=yb)
        e.backward()
        for k, a in enumerate(names):
            updater(k, e.grad_dict[a], e.arg_dict[a])
    bare_k1 = nn_ops.softmax_rows.launches
    shared = {a: {id(b._exec_group.execs[0].arg_dict[a])
                  for b in mod._buckets.values()} for a in names}
    check(sorted(mod._buckets) == sorted(LSTM_BUCKETS),
          f"buckets bound: {sorted(mod._buckets)}")
    check(all(len(v) == 1 for v in shared.values()),
          f"parameters not shared between the buckets: {shared}")
    got = mod.get_params()[0]
    legacy_bitwise(torch, got, {a: ex[default].arg_dict[a] for a in names},
                   "BucketingModule against the bare loop")
    check(all(np.isfinite(losses)) and np.isfinite(after),
          f"losses {losses}, {after}")
    check(after < losses[0], f"batch 0's loss {losses[0]} -> {after}")
    check(mod_k1 == LSTM_BATCHES + 1 and bare_k1 == LSTM_BATCHES,
          f"K1 launched {mod_k1} and {bare_k1} times")
    launches["softmax_rows"] += mod_k1 + bare_k1
    log(f"  (c) BucketingModule, buckets {LSTM_BUCKETS}: losses "
        f"{['%.4f' % v for v in losses]}, batch 0 after {after:.4f}; one "
        "array per parameter in both buckets, state bitwise the bare "
        f"loop's; K1 {mod_k1} + {bare_k1}")
    return {"losses": losses, "batch0_after": after,
            "switches": mod.cache_report()}


def zoo_ops_vs_cpu(torch, np):
    """(d) each new op on CUDA tensors against the same op on CPU tensors,
    forward and backward, within ``TOL["float32"]`` of 1 + |CPU value|."""
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import cpu, gpu

    errs = {}
    for i, (op, params, inputs) in enumerate(ZOO_OP_CASES):
        net = getattr(S, op)(name="op", **{k: S.Variable(k) for k in inputs},
                             **params)
        arg_shapes, _, _ = net.infer_shape(**inputs)
        rng = np.random.RandomState(i)
        vals = {a: rng.uniform(-1, 1, s).astype(np.float32)
                for a, s in zip(net.list_arguments(), arg_shapes)}
        res = []
        for ctx in (cpu(), gpu(0) if DEVICE == "cuda" else cpu()):
            ex = net.simple_bind(ctx, **inputs)
            outs = ex.forward(is_train=True, **vals)
            heads = [np.random.RandomState(100 + i).uniform(
                -1, 1, o.shape).astype(np.float32) for o in outs]
            ex.backward(heads)
            res.append([o.asnumpy() for o in outs]
                       + [ex.grad_dict[a].asnumpy() for a in sorted(vals)])
        err = max(float(np.max(np.abs(g - w) / (1.0 + np.abs(w))))
                  for g, w in zip(*res))
        key = f"{op} {params}"
        errs[key] = err
        check(err <= TOL["float32"], f"(d) {key}: card against CPU {err}")
    log(f"  (d) {len(errs)} op cases, card against CPU, forward and "
        f"backward: max error {max(errs.values()):.3g} (tolerance "
        f"{TOL['float32']})")
    return errs


# ---------------------------------------------------------------------------
# Phase 16: long training runs -- fp8 linears, recompute scopes, loss
# scaling and gradient accumulation; checkpoints with resume, preemption
# and rollback; serving and post-training from a checkpoint
# ---------------------------------------------------------------------------

# kernel-name fragments of a step of the fp8 LM -> the layer
_LONG_KERNEL_GROUPS = (
    ("K3 flash attention forward", ("flash_fwd_",)),
    ("K4 flash attention backward", ("flash_bwd_",)),
    ("K2 fused update", ("fused_update_kernel",
                         "fused_update_params_kernel")),
    # cuBLAS names its fp8 GEMMs nvjet_q* (e4m3 A) and nvjet_r* (e5m2 A)
    ("fp8 GEMMs (cuBLAS)", ("nvjet_q", "nvjet_r", "e4m3", "e5m2", "f8")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "cublas",
                         "nvjet")),
    ("reductions (block absmax, LayerNorm, logsumexp, grad norm)",
     ("reduce", "softmax", "Softmax", "SoftMax", "norm")),
    ("embedding gather/scatter", ("index", "embedding", "gather",
                                  "scatter", "sort", "radix")),
    ("elementwise (quantize, rescale, casts, residual, loss head)",
     ("elementwise",)),
)
# CPU ops of the fp8 product whose kernels' device time is reported
# inclusive: the quantize passes, the block products with their rescale
_FP8_OPS = ("quant.block_quantize", "quant.block_dot")


def fp8_gemms_per_step(tokens, d, layers, accum, block, remat):
    """The block products (cuBLAS fp8 GEMMs) of one step of the fp8 LM:
    per layer and microbatch, the forward's (q, k, v, proj and ffn1
    contract d, ffn2 4d; again in the recompute), dx's (each linear's
    output: d for q, k, v, proj and ffn2, 4d for ffn1) and dw's (the
    microbatch's tokens, for all six)."""
    def nb(k):
        return -(-k // block)
    fwd = 5 * nb(d) + nb(4 * d)
    dx = 5 * nb(d) + nb(4 * d)
    dw = 6 * nb(tokens)
    return layers * accum * ((2 if remat else 1) * fwd + dx + dw)


def long_counts(fa, fu, quant):
    """The launch counts phase 16 checks, as one dict."""
    return {"K3": fa.flash_fwd.launches,
            "K3 hopper": fa.flash_fwd.launches_by_form["hopper"],
            "K4": fa.flash_bwd.launches,
            "K4 hopper": fa.flash_bwd.launches_by_form["hopper"],
            "K2": fu.fused_update.launches,
            "K2 hopper": fu.fused_update.launches_by_form["hopper"],
            "fp8": quant.block_dot.launches_by_route["fp8"],
            "upcast": quant.block_dot.launches_by_route["upcast"]}


def long_reset(fa, fu, quant):
    reset_train_counts(fa.flash_fwd, fa.flash_bwd, fu.fused_update)
    quant.block_dot.launches_by_route = dict.fromkeys(
        quant.block_dot.launches_by_route, 0)


def long_step_counts(expect_fp8, steps):
    """The counts ``steps`` steps of the fp8 LM make: K3 twice a layer
    and microbatch (forward and recompute), K4 once, K2 once a step, all
    in the hopper form; the fp8 GEMMs by shape and no upcast product."""
    k3 = 2 * LAYERS * LONG_ACCUM * steps
    k4 = LAYERS * LONG_ACCUM * steps
    return {"K3": k3, "K3 hopper": k3, "K4": k4, "K4 hopper": k4,
            "K2": steps, "K2 hopper": steps, "fp8": expect_fp8 * steps,
            "upcast": 0}


def long_lm_symbol(quant_spec, remat, batch=None):
    from mxnet_tpu_torch import models
    return models.get_symbol(
        "transformer-lm", vocab_size=VOCAB, num_layers=LAYERS,
        d_model=D_MODEL, heads=HEADS,
        batch_size=batch or LM_BATCH // LONG_ACCUM, seq_len=LM_SEQ,
        loss_head=True, quant=quant_spec, remat=remat)


def long_trainer(sym, args, accum=LONG_ACCUM, **kw):
    from mxnet_tpu_torch.parallel import ShardedTrainer
    kw.setdefault("optimizer", "adam")
    kw.setdefault("optimizer_params", dict(LM_OPT))
    kw.setdefault("compute_dtype", "bfloat16")
    tr = ShardedTrainer(sym, grad_accum=accum, device=DEVICE, **kw)
    return tr.bind({"data": (LM_BATCH, LM_SEQ)},
                   {"softmax_label": (LM_BATCH, LM_SEQ)}, arg_params=args)


def long_state(torch, tr):
    """A trainer's state for a bitwise comparison: weights, Adam moments
    and aux states by name, the update count, and the guard's loss scale
    and good streak (0-d tensors on the card) with its cumulative
    counters."""
    out = {f"param:{n}": p.detach().clone() for n, p in tr._params.items()}
    for n, st in tr.opt_state_by_param().items():
        for i, t in enumerate(st):
            out[f"opt:{n}:{i}"] = t.detach().clone()
    out.update({f"aux:{n}": v.clone() for n, v in tr._aux.items()})
    for k in ("scale", "good"):
        out[f"guard {k}"] = tr._guard_state[k].clone()
    rs = tr.resilience_stats()
    counters = {k: rs[k] for k in ("skipped_steps", "overflow_steps",
                                   "norm_steps", "num_update")}
    return out, counters, rs["norm_sum"]


def long_same(torch, a, b, what):
    """Two :func:`long_state` results agree: every tensor bit for bit,
    the integer counters exactly, and the summed gradient norm to 1e-6
    relative (the uninterrupted run sums it in one float32 window, the
    resumed one adds its window to the saved float64 total)."""
    (ta, ca, na), (tb, cb, nb_) = a, b
    diff = [n for n in ta if not torch.equal(
        ta[n].reshape(-1).view(torch.uint8),
        tb[n].reshape(-1).view(torch.uint8))]
    check(sorted(ta) == sorted(tb) and not diff,
          f"{what}: not bitwise equal in {diff[:6]}")
    check(ca == cb, f"{what}: guard counters {ca} against {cb}")
    check(abs(na - nb_) <= 1e-6 * max(abs(na), 1e-30),
          f"{what}: summed gradient norm {na} against {nb_}")


def sigterm_inside_update(tr, update, after_weights):
    """Patch trainer ``tr`` to raise SIGTERM inside update ``update``:
    just after the fused kernel has written the weights and moments in
    place (the guard state and aux have not moved yet), or before the
    update starts (the count has moved, nothing else has).  A save the
    signal asks for there must wait for the step's end."""
    import signal
    name = "_fused_apply" if after_weights else "_apply_update"
    orig = getattr(tr, name)

    def patched(*args):
        if not after_weights and tr._num_update == update:
            signal.raise_signal(signal.SIGTERM)
        out = orig(*args)
        if after_weights and tr._num_update == update:
            signal.raise_signal(signal.SIGTERM)
        return out

    setattr(tr, name, patched)
    return lambda: delattr(tr, name)


def long_fp8_dot(torch, np, quant):
    """block_quantize on the card byte for byte the CPU's; block_dot's
    route on the card against its plain version on the same payloads,
    with the route each case must take and one count a block; the
    per-call times at the LM's largest forward and weight-gradient
    shapes."""
    rng = np.random.RandomState(16)
    out, block = {}, quant.default_block_size()
    for name, (m, k), (n, _), (fmt_a, fmt_b) in FP8_DOT_CASES:
        host = [(rng.randn(*shape) * rng.choice(
            [0.01, 1.0, 30.0], (shape[0], 1))).astype(np.float32)
                for shape in ((m, k), (n, k))]
        q = []
        for x, fmt in zip(host, (fmt_a, fmt_b)):
            qc, sc = quant.block_quantize(torch.from_numpy(x), fmt, block)
            qg, sg = quant.block_quantize(torch.from_numpy(x).to(DEVICE),
                                          fmt, block)
            check(torch.equal(qg.view(torch.uint8).cpu(),
                              qc.view(torch.uint8))
                  and torch.equal(sg.cpu().view(torch.int32),
                                  sc.view(torch.int32)),
                  f"block_quantize {name} {fmt}: the card's bytes differ "
                  "from the CPU's")
            q.append((qg, sg))
        (qa, sa), (qb, sb) = q
        route = quant.block_dot_route(qa, qb)
        want_route = ("upcast" if (fmt_a, fmt_b) == ("e5m2", "e5m2")
                      else "fp8")
        check(route == want_route, f"{name}: route {route}, expected "
              f"{want_route}")
        before = dict(quant.block_dot.launches_by_route)
        got = quant.block_dot(qa, sa, qb, sb)
        torch.cuda.synchronize()
        moved = {r: quant.block_dot.launches_by_route[r] - before[r]
                 for r in before}
        check(moved == dict(dict.fromkeys(before, 0),
                            **{route: qa.shape[0]}),
              f"{name}: route counts moved by {moved}, expected "
              f"{qa.shape[0]} {route}")
        ref = quant.block_dot_ref(qa, sa, qb, sb)
        mag = sum(torch.matmul(qa[i].float().abs(), qb[i].float().abs().t())
                  * sa[i] * sb[i].t() for i in range(qa.shape[0]))
        err = (got - ref).abs()
        worst = float((err / mag.clamp_min(1e-30)).max())
        check(got.shape == (m, n) and bool((err <= FP8_DOT_TOL * mag).all()),
              f"{name}: block_dot against its plain version: worst error "
              f"{worst:.3g} of the terms' magnitude > {FP8_DOT_TOL}")
        out[name] = {"route": route, "blocks": qa.shape[0],
                     "max_abs_err": float(err.max()),
                     "worst_rel_to_magnitude": worst}
        log(f"  block_dot {name}: {route} route, {qa.shape[0]} blocks, "
            f"max abs err {float(err.max()):.3g} ({worst:.3g} of the "
            "terms' magnitude)")
        if name in ("ffn1 forward", "ffn1 dw"):
            a16 = torch.from_numpy(host[0]).to(DEVICE, torch.bfloat16)
            b16 = torch.from_numpy(host[1]).to(DEVICE, torch.bfloat16)
            flops = 2.0 * m * n * k
            nbytes = qa.numel() + qb.numel() + 4 * (sa.numel() + sb.numel()
                                                    + m * n)
            # host launches of a multi-block call: a longer sleep hides
            # them; "per_call_ms" keeps them
            hide = dict(reps=20, sleep=1 << 23)
            t = {"ms": time_ms(torch, lambda: quant.block_dot(qa, sa, qb,
                                                              sb), **hide),
                 "per_call_ms": time_ms(torch, lambda: quant.block_dot(
                     qa, sa, qb, sb), reps=20, hide_host=False),
                 "plain_ms": time_ms(torch, lambda: quant.block_dot_ref(
                     qa, sa, qb, sb), **hide),
                 "quantize_a_ms": time_ms(torch, lambda: quant.block_quantize(
                     a16, fmt_a, block), **hide),
                 "bf16_matmul_ms": time_ms(torch, lambda: torch.matmul(
                     a16, b16.t()), **hide)}
            t.update(bound(nbytes, flops, FP8_FLOP_PER_S))
            out[name].update(t)
            log(f"  block_dot {name} per call: " + json.dumps(t))
    return out


def long_profile(torch, quant, run):
    """One step under the profiler, the fp8 product's quantize passes and
    block products marked as CPU ops (their kernels' inclusive device
    time reported by name)."""
    real_q, real_d = quant.block_quantize, quant.block_dot

    def marked(name, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        # block_dot counts through its module name: the same dict
        wrapper.__dict__.update(fn.__dict__)
        return wrapper

    quant.block_quantize = marked(_FP8_OPS[0], real_q)
    quant.block_dot = marked(_FP8_OPS[1], real_d)
    try:
        return profile_step(torch, run, _LONG_KERNEL_GROUPS,
                            _LOSS_HEAD_OPS, label="profiled fp8 LM step",
                            named_ops=_FP8_OPS)
    finally:
        quant.block_quantize, quant.block_dot = real_q, real_d


def long_lm(torch, np, fa, fu, quant, launches):
    """(a) the fp8 LM: 8 steps on one batch with every count checked a
    step, a planted overflow through ``MXNET_TPU_CHAOS``, no synchronizing
    call in a step, the first loss against the same net without fp8, the
    peak memory of a step with and without recompute scopes, one
    profiled step."""
    from mxnet_tpu_torch import chaos, io
    t0 = time.perf_counter()
    sym = long_lm_symbol("fp8", True)
    micro = dict(data=(LM_BATCH // LONG_ACCUM, LM_SEQ),
                 softmax_label=(LM_BATCH // LONG_ACCUM, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**micro)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    tr = long_trainer(sym, args)
    check(tr._fused and tr._fused_route == "hopper",
          "the fp8 LM did not take the fused update's hopper route")
    check(tr._resil is not None and tr._resil.dynamic,
          "fp8 linears did not turn dynamic loss scaling on")
    host = lm_batch(np)
    batch = tr.place_batch(host)
    torch.cuda.synchronize()
    expect_fp8 = fp8_gemms_per_step(LM_BATCH // LONG_ACCUM * LM_SEQ,
                                    D_MODEL, LAYERS, LONG_ACCUM,
                                    quant.default_block_size(), True)
    log(f"  fp8 LM bound in {time.perf_counter() - t0:.2f} s; "
        f"{expect_fp8} fp8 GEMMs a step by its shapes")

    # the main path's run: every count starts at 0 here
    long_reset(fa, fu, quant)
    losses, step_ms, scales = [], [], []
    for i in range(LONG_STEPS):
        before = long_counts(fa, fu, quant)
        t1 = time.perf_counter()
        heads = tr.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(heads[0].float().mean()))
        now = long_counts(fa, fu, quant)
        moved = {k: now[k] - before[k] for k in now}
        check(moved == long_step_counts(expect_fp8, 1),
              f"step {i}: launches {moved}, expected "
              f"{long_step_counts(expect_fp8, 1)}")
    counts = long_counts(fa, fu, quant)
    for key, name in (("K3", "flash_attn_fwd"), ("K4", "flash_attn_bwd"),
                      ("K2", "fused_update")):
        launches[name] += counts[key]
    log(f"  losses {['%.4f' % v for v in losses]}")
    check(heads[0].shape == (LM_BATCH * LM_SEQ,),
          f"loss head gave {tuple(heads[0].shape)}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the fp8 LM's loss is not finite and falling: {losses}")
    log(f"  launches a step: K3 {2 * LAYERS * LONG_ACCUM}, K4 "
        f"{LAYERS * LONG_ACCUM}, K2 1 (all hopper), fp8 GEMMs {expect_fp8}, "
        "upcast products 0")

    # a planted overflow: the data of a batch through MXNET_TPU_CHAOS
    # (NaN ids are token 0 in both packages, as XLA converts them; 1e30
    # is out of range, so its embedding rows are NaN)
    os.environ["MXNET_TPU_CHAOS"] = "overflow:0"
    try:
        it = chaos.maybe_wrap(io.NDArrayIter(
            host["data"], host["softmax_label"], batch_size=LM_BATCH))
    finally:
        del os.environ["MXNET_TPU_CHAOS"]
    poisoned = tr.place_batch(next(iter(it)))
    check(bool((poisoned["data"] == 1e30).all()),
          "the chaos iterator did not poison the batch")
    st0 = tr.resilience_stats()
    saved = [t.clone() for t in [tr._flat_w] + list(tr._flat_state)]
    tr.step(poisoned)
    torch.cuda.synchronize()
    st1 = tr.resilience_stats()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(saved, [tr._flat_w] + list(tr._flat_state)))
    check(same, "the overflow step changed the weights or Adam moments")
    check(st1["loss_scale"] == st0["loss_scale"] * 0.5
          and st1["overflow_steps"] == st0["overflow_steps"] + 1
          and st1["skipped_steps"] == st0["skipped_steps"] + 1
          and st1["good_steps"] == 0,
          f"the overflow step: guard {st0} -> {st1}")
    log(f"  planted overflow: a bitwise no-op, loss scale "
        f"{st0['loss_scale']:g} -> {st1['loss_scale']:g}, one overflow")

    # a step waits for nothing: no synchronizing call in two steps
    counter = SyncCounter(torch)
    counter.start()
    try:
        for _ in range(2):
            tr.step(batch)
    finally:
        syncs = counter.stop()
    torch.cuda.synchronize()
    check(syncs == {"outside": 0, "drains": 0, "other threads": 0},
          f"two steps of the fp8 LM made synchronizing calls {syncs} "
          f"({counter.sites})")
    log("  two fp8 LM steps: no synchronizing call")

    # the first loss against the same net without fp8 (same weights)
    f32 = long_trainer(long_lm_symbol(None, True), args)
    first = float(f32.step(batch)[0].float().mean())
    del f32
    check(abs(losses[0] - first) < FP8_LOSS_TOL,
          f"first loss {losses[0]:.4f} with fp8, {first:.4f} without: more "
          f"than {FP8_LOSS_TOL} apart")
    log(f"  first loss {losses[0]:.4f} with fp8 linears, {first:.4f} "
        f"without (tolerance {FP8_LOSS_TOL})")

    # peak memory of one step, net of what is allocated before it
    def step_peak(trainer):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer.step(batch)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    peak_remat = step_peak(tr)
    plain = long_trainer(long_lm_symbol("fp8", False), args)
    peak_plain = step_peak(plain)
    del plain
    torch.cuda.empty_cache()
    check(peak_remat < peak_plain, f"a step's peak memory with recompute "
          f"scopes {peak_remat:.3f} GiB, without {peak_plain:.3f} GiB")
    profile = long_profile(torch, quant, lambda: tr.step(batch))
    med = float(np.median(step_ms))
    stats = {"median_step_ms": med, "step_ms": step_ms,
             "tokens_per_s": LM_BATCH * LM_SEQ / med * 1e3,
             "loss_first": losses[0], "loss_last": losses[-1],
             "loss_first_without_fp8": first,
             "fp8_gemms_per_step": expect_fp8,
             "step_peak_gib_remat": peak_remat,
             "step_peak_gib_no_remat": peak_plain,
             "loss_scale": tr.resilience_stats()["loss_scale"],
             "profile": profile}
    log("  fp8 LM: " + json.dumps({k: v for k, v in stats.items()
                                   if k != "profile"}))
    del tr
    torch.cuda.empty_cache()
    return stats, args


def long_accum(torch, np):
    """grad_accum 2 against 1 on the LM in float32, SGD with momentum, one
    step: heads and parameters within the JAX package's own bound
    (tests/test_parallel.py: heads rtol 2e-5 atol 2e-6, parameters rtol
    5e-5 atol 5e-6; summation order), and the inference forward mapped
    over the microbatches."""
    sym = long_lm_symbol(None, False)
    micro = dict(data=(LM_BATCH // 2, LM_SEQ),
                 softmax_label=(LM_BATCH // 2, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**micro)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=1)
    opt = dict(optimizer="sgd", compute_dtype=None,
               optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
    batch = lm_batch(np, seed=3)
    heads, params = [], []
    for accum in (1, 2):
        tr = long_trainer(sym, args, accum=accum, **opt)
        heads.append(tr.step(batch)[0])
        heads.append(tr.forward(batch)[0])
        params.append({n: p.detach().clone() for n, p in tr._params.items()})
        del tr
    torch.cuda.synchronize()
    for i, what in enumerate(("training heads", "inference heads")):
        a, b = heads[i], heads[2 + i]
        err = float((a - b).abs().max())
        check(bool(((a - b).abs() <= 2e-6 + 2e-5 * b.abs()).all()),
              f"grad_accum 2 against 1: {what} differ by {err}")
    worst = 0.0
    for n in params[0]:
        a, b = params[0][n], params[1][n]
        worst = max(worst, float((a - b).abs().max()))
        check(bool(((a - b).abs() <= 5e-6 + 5e-5 * a.abs()).all()),
              f"grad_accum 2 against 1: {n} differs")
    log(f"  grad_accum 2 against 1 (f32): parameters within {worst:.3g}")
    torch.cuda.empty_cache()
    return {"max_param_diff": worst}


def long_precision(torch, np):
    """What each ``matmul_precision`` name gives a float32 product on the
    card: the full float32 product, the TF32 one, or neither (then its
    largest error against the full product, relative to the terms'
    magnitude)."""
    from mxnet_tpu_torch.parallel.trainer import (_MATMUL_PRECISION,
                                                  matmul_precision_scope)
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(1024, 512).astype(np.float32)).to(DEVICE)
    b = torch.from_numpy(rng.randn(512, 1024).astype(np.float32)).to(DEVICE)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    full = a @ b
    torch.set_float32_matmul_precision("high")
    tf32 = a @ b
    torch.set_float32_matmul_precision(prev)
    mag = a.abs() @ b.abs()
    out = {}
    for name in sorted(_MATMUL_PRECISION):
        with matmul_precision_scope(name):
            got = a @ b
        check(torch.get_float32_matmul_precision() == prev,
              f"matmul_precision {name}: the global setting was not "
              "restored")
        out[name] = ("float32" if torch.equal(got, full) else "tf32"
                     if torch.equal(got, tf32) else
                     "other, %.3g of the magnitude" % float(
                         ((got - full).abs() / mag).max()))
    log("  matmul_precision on the card: " + json.dumps(out))
    return out


def long_durability(torch, np, fa, fu, quant, args, launches, tmp):
    """(b) fit over 2 epochs of 4 batches with a CheckpointManager saving
    each epoch in the background; a new trainer resumed from epoch 1 by
    ``restore_or_initialize`` ends bitwise equal to the uninterrupted
    run; a SIGTERM inside a step (after the fused kernel wrote the
    weights) saves the whole step at fit's batch boundary, stops fit and
    resumes bitwise, and one inside a bare ``step`` loop saves when that
    step ends; a flipped byte is caught with the file's name; retention
    keeps two steps; a forced rollback restores the checkpoint bitwise; a
    save makes one synchronizing call, alone and inside a ``fit`` epoch
    with the fused accuracy carry.  Returns the numbers and the trained
    parameters."""
    import shutil
    from mxnet_tpu_torch import io, metric
    from mxnet_tpu_torch.checkpoint import (CheckpointManager,
                                            verify_checkpoint, writer)
    from mxnet_tpu_torch.parallel.trainer import _AsyncMetric
    sym = long_lm_symbol("fp8", True)
    toks = np.random.RandomState(6).randint(
        0, VOCAB, (LONG_BATCHES * LM_BATCH, LM_SEQ + 1))
    data = toks[:, :-1].astype(np.float32)
    label = toks[:, 1:].astype(np.float32)

    def batches():
        return io.NDArrayIter(data, label, batch_size=LM_BATCH)

    def loss_metric():
        return metric.CustomMetric(lambda lbl, pred: pred.mean(),
                                   name="loss")

    write_ms, real_write = [], writer.write_checkpoint

    def timed_write(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_write(*a, **kw)
        finally:
            write_ms.append((time.perf_counter() - t0) * 1e3)

    writer.write_checkpoint = timed_write
    try:
        # the uninterrupted run: a save at the end of each epoch, written
        # while the next epoch trains
        root_a = os.path.join(tmp, "run")
        mgr = CheckpointManager(root_a, keep_last=LONG_KEEP,
                                save_interval_steps=LONG_BATCHES)
        tra = long_trainer(sym, args)
        long_reset(fa, fu, quant)
        t0 = time.perf_counter()
        tra.fit(batches(), eval_metric=loss_metric(),
                num_epoch=LONG_EPOCHS, checkpoint_manager=mgr)
        mgr.wait_until_finished()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        steps = LONG_EPOCHS * LONG_BATCHES
        counts = long_counts(fa, fu, quant)
        for key, name in (("K3", "flash_attn_fwd"),
                          ("K4", "flash_attn_bwd"), ("K2", "fused_update")):
            launches[name] += counts[key]
        per_step = fp8_gemms_per_step(LM_BATCH // LONG_ACCUM * LM_SEQ,
                                      D_MODEL, LAYERS, LONG_ACCUM,
                                      quant.default_block_size(), True)
        check(counts == long_step_counts(per_step, steps),
              f"fit's launches {counts}, expected "
              f"{long_step_counts(per_step, steps)}")
        check(mgr.all_steps() == [LONG_BATCHES, steps],
              f"fit saved steps {mgr.all_steps()}, expected "
              f"{[LONG_BATCHES, steps]}")
        ref = long_state(torch, tra)
        nbytes = verify_checkpoint(mgr.step_path(steps))["bytes"]

        # the run killed after epoch 1: its directory holds that step
        # alone (hard links of the saved files)
        root_b = os.path.join(tmp, "resumed")
        os.makedirs(root_b)
        name = os.path.basename(mgr.step_path(LONG_BATCHES))
        shutil.copytree(mgr.step_path(LONG_BATCHES),
                        os.path.join(root_b, name), copy_function=os.link)
        mgr_b = CheckpointManager(root_b, keep_last=LONG_KEEP,
                                  save_interval_steps=LONG_BATCHES)
        trb = long_trainer(sym, args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = trb.restore_or_initialize(mgr_b)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(got == LONG_BATCHES, f"restore_or_initialize gave {got}")
        trb.fit(batches(), eval_metric=loss_metric(), begin_epoch=1,
                num_epoch=LONG_EPOCHS, checkpoint_manager=mgr_b)
        mgr_b.close()
        long_same(torch, ref, long_state(torch, trb),
                  "resumed from epoch 1 against the uninterrupted run")
        log(f"  resumed from epoch 1: bitwise the uninterrupted run "
            f"(update {trb._num_update}, loss scale "
            f"{trb.resilience_stats()['loss_scale']:g})")
        del trb

        # one synchronizing call a save: the snapshot's
        counter = SyncCounter(torch)
        counter.start()
        try:
            t0 = time.perf_counter()
            tra.save_state(mgr, step=steps + 1)
            snapshot_ms = (time.perf_counter() - t0) * 1e3
        finally:
            syncs = counter.stop()
        mgr.wait_until_finished()
        check(syncs == {"outside": 1, "drains": 0, "other threads": 0},
              f"a save made synchronizing calls {syncs} "
              f"({counter.sites}), expected the snapshot's one")
        check(mgr.all_steps() == [steps, steps + 1],
              f"retention kept {mgr.all_steps()}, expected the last "
              f"{LONG_KEEP}")
        log(f"  a save: one synchronizing call, snapshot "
            f"{snapshot_ms:.1f} ms; retention keeps {mgr.all_steps()}")

        # a forced rollback restores the newest checkpoint bitwise
        saved = long_state(torch, tra)
        tra.step(tra.place_batch({"data": data[:LM_BATCH],
                                  "softmax_label": label[:LM_BATCH]}))
        hooked = []
        tra._rollback_hook = lambda: hooked.append(True)
        tra._sentinel_poll(mgr)                # the first drain baselines

        class Forced:
            def observe(self, *args):
                return "rollback"

        tra._sentinel = Forced()
        tra._num_update += 1                   # a window to judge
        action = tra._sentinel_poll(mgr)
        check(action == "rollback" and hooked and tra._rollbacks == 1,
              f"forced rollback: action {action}, hook {hooked}")
        long_same(torch, saved, long_state(torch, tra),
                  "rolled back against the checkpoint")
        log("  forced rollback: the checkpoint's state, bitwise")
        mgr.close()
        params = {n: p.detach().float().cpu().numpy()
                  for n, p in tra._params.items()}

        # a save inside fit adds one synchronizing call: a fit epoch with
        # the fused accuracy carry, without a manager and with one whose
        # policy fires once in the epoch's 4 consecutive updates
        def fit_epoch_syncs(manager):
            counter = SyncCounter(torch, [
                (_AsyncMetric, "_drain"), (tra, "resilience_stats"),
                (tra, "_sentinel_poll"), (tra, "get_params"),
                (tra, "score")])
            torch.cuda.synchronize()
            counter.start()
            try:
                tra.fit(batches(), eval_metric="acc", num_epoch=1,
                        checkpoint_manager=manager)
            finally:
                syncs = counter.stop()
            return syncs, counter.sites

        tra._sentinel = None            # the forced one above is done
        plain_syncs, _ = fit_epoch_syncs(None)
        mgr_s = CheckpointManager(os.path.join(tmp, "syncs"),
                                  save_interval_steps=LONG_BATCHES)
        save_syncs, sites = fit_epoch_syncs(mgr_s)
        _, smeta, _ = mgr_s.restore()
        mgr_s.close()
        check(len(mgr_s.all_steps()) == 1 and "metric_sum" in smeta,
              f"the saving fit epoch saved {mgr_s.all_steps()} "
              f"(meta keys {sorted(smeta)})")
        check(save_syncs["outside"] == plain_syncs["outside"] + 1
              and save_syncs["other threads"] == 0
              and plain_syncs["other threads"] == 0,
              f"a fit epoch made synchronizing calls {plain_syncs} without "
              f"a save and {save_syncs} with one ({sites}): expected the "
              "snapshot's one more")
        log(f"  a save inside fit (acc carry): one synchronizing call more "
            f"than the epoch without it ({plain_syncs['outside']} -> "
            f"{save_syncs['outside']})")
        del tra

        # SIGTERM inside a step, after the fused kernel wrote the weights:
        # the hook's save waits, fit saves the whole step at its batch
        # boundary and stops, a new trainer resumes bitwise
        root_c = os.path.join(tmp, "preempted")
        mgr_c = CheckpointManager(root_c, keep_last=LONG_KEEP,
                                  save_interval_steps=LONG_BATCHES)
        trc = long_trainer(sym, args)
        mgr_c.install_preemption_hook(
            lambda: trc.save_state(mgr_c, blocking=True))
        at = LONG_BATCHES // 2
        unpatch = sigterm_inside_update(trc, at, after_weights=True)
        try:
            trc.fit(batches(), eval_metric=loss_metric(),
                    num_epoch=LONG_EPOCHS, checkpoint_manager=mgr_c)
        finally:
            unpatch()
        check(mgr_c.preempted and trc._num_update == at
              and mgr_c.all_steps() == [at],
              f"SIGTERM: preempted {mgr_c.preempted}, stopped at update "
              f"{trc._num_update}, saved {mgr_c.all_steps()}")
        stopped = long_state(torch, trc)
        mgr_c.close()
        del trc
        trd = long_trainer(sym, args)
        mgr_d = CheckpointManager(root_c)
        check(trd.restore_or_initialize(mgr_d) == at,
              "the preempted run did not resume from its save")
        long_same(torch, stopped, long_state(torch, trd),
                  "resumed after SIGTERM against the stopped run")
        # the rest of the epoch in a bare step loop, with a SIGTERM before
        # the last update: its save lands when that step ends
        mgr_e = CheckpointManager(os.path.join(tmp, "preempted-loop"))
        mgr_e.install_preemption_hook(
            lambda: trd.save_state(mgr_e, blocking=True))
        unpatch = sigterm_inside_update(trd, LONG_BATCHES,
                                        after_weights=False)
        try:
            for i in range(at, LONG_BATCHES):
                trd.step({"data": data[i * LM_BATCH:(i + 1) * LM_BATCH],
                          "softmax_label":
                              label[i * LM_BATCH:(i + 1) * LM_BATCH]})
        finally:
            unpatch()
            mgr_e.uninstall_preemption_hook()
        check(mgr_e.preempted and mgr_e.all_steps() == [LONG_BATCHES],
              f"SIGTERM in a step loop: saved {mgr_e.all_steps()}")
        chk = CheckpointManager(root_b)
        want = long_trainer(sym, args)
        want.restore_state(chk, step=LONG_BATCHES)
        long_same(torch, long_state(torch, want), long_state(torch, trd),
                  "the preempted run finished its epoch against epoch 1's "
                  "checkpoint")
        want.restore_state(mgr_e)
        long_same(torch, long_state(torch, want), long_state(torch, trd),
                  "the save a SIGTERM asked for inside the last step "
                  "against the finished step")
        log(f"  SIGTERM inside update {at} (weights written, guard not): "
            "fit saved the whole step, stopped, resumed and finished the "
            f"epoch bitwise; SIGTERM inside update {LONG_BATCHES} of a "
            "step loop: saved at the step's end, bitwise")
        mgr_e.close()
        del trd, want

        # a flipped byte: the checksum names the file
        path = mgr_d.step_path(at)
        shard = sorted(f for f in os.listdir(path) if f.endswith(".bin"))[0]
        with open(os.path.join(path, shard), "r+b") as f:
            f.seek(7)
            byte = f.read(1)
            f.seek(7)
            f.write(bytes([byte[0] ^ 0x40]))
        try:
            verify_checkpoint(path)
            caught = None
        except Exception as exc:        # the check below names it
            caught = str(exc)
        check(caught is not None and shard in caught
              and "checksum" in caught,
              f"a flipped byte in {shard}: {caught}")
        log(f"  a flipped byte in {shard}: {caught[:100]}")
        mgr_d.close()
        chk.close()
    finally:
        writer.write_checkpoint = real_write
    torch.cuda.empty_cache()
    return {"fit_s": fit_s, "snapshot_ms": snapshot_ms,
            "write_ms": write_ms, "restore_ms": restore_ms,
            "checkpoint_bytes": nbytes}, params


def long_serve(torch, np, fd, params, step, launches, tmp):
    """(c) the trained weights published with ``save_model`` (as the
    online loop publishes) and served from the checkpoint directory: the
    greedy streams of ``Engine.from_checkpoint`` equal an engine's built
    from the parameter dict, every K5 launch in the hopper form; a
    2-replica ``Router.rolling_swap`` from the same path is hot and
    leaves the streams as they were."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    root = os.path.join(tmp, "publish")
    pub = CheckpointManager(root)
    pub.save_model(step, None, params, {}, blocking=True)
    pub.close()
    reqs = [r for i, r in enumerate(request_set(np)) if i not in SAMPLED][:8]
    ecfg = EngineConfig(**ENGINE_KW)
    streams = {}
    for what, make in (
            ("from_checkpoint",
             lambda: Engine.from_checkpoint(root, ecfg, device=DEVICE)),
            ("params dict", lambda: Engine(params, ecfg, device=DEVICE))):
        eng = make()
        eng.warmup()
        done, wall, _, (k5, k5_fp8), counters = serve_run(
            torch, np, eng, reqs, fd)
        check(k5 == LAYERS * counters["decode_steps"] and k5_fp8 == 0,
              f"{what}: K5 launched {k5} times in "
              f"{counters['decode_steps']} decode steps")
        launches["flash_decode"] += k5
        streams[what] = [list(r.tokens) for r in done]
        streams[what + " params"] = eng._params
        del eng
    check(all(torch.equal(streams["from_checkpoint params"][n], v)
              for n, v in streams["params dict params"].items()),
          "the engine's weights from the checkpoint differ from the dict")
    check(streams["from_checkpoint"] == streams["params dict"],
          "greedy streams from the checkpoint differ from the dict's")
    log(f"  Engine.from_checkpoint: {len(reqs)} greedy streams equal to "
        "the params dict's")
    router = cp_router(torch, params, ecfg=ecfg)
    reset_decode_counts(fd)
    before, _, _ = cp_run(torch, router, reqs)
    swap = router.rolling_swap(root)
    after, _, _ = cp_run(torch, router, reqs)
    check_hopper_launches(fd, "the router around the swap")
    launches["flash_decode"] += fd.flash_decode_attention.launches
    check(swap["mode"] == "hot" and len(swap["swap_ms"]) == 2
          and all(r.engine.swap_count == 1 for r in router.replicas),
          f"rolling_swap from the checkpoint: {swap}")
    check(before == after == streams["params dict"],
          "the router's streams changed across the hot swap")
    log(f"  Router.rolling_swap from the checkpoint: hot, swap_ms "
        f"{[round(v, 3) for v in swap['swap_ms']]}, streams unchanged")
    del router
    torch.cuda.empty_cache()
    return {"swap_ms": swap["swap_ms"]}


def long_online(torch, np, fd, launches, tmp):
    """(d) ``OnlineLoop`` over 2 rounds at phase 12's geometry: rollouts
    through a 2-replica router, a rejection-sampling batch, trainer
    steps, a ``save_model`` publish with its compat stamp and a hot
    rolling swap from the checkpoint path each round; the fleet then
    serves exactly the trainer's weights."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager, read_manifest
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.online import (OnlineConfig, OnlineLoop,
                                        make_rollout_trainer)
    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    router = cp_router(torch, params)
    trainer = make_rollout_trainer(params, heads=HEADS,
                                   batch=ONLINE_ROLLOUTS,
                                   seq_len=ONLINE_SEQ, device=DEVICE)
    mgr = CheckpointManager(os.path.join(tmp, "online"), keep_last=2)

    def prompts(round_idx, n):
        rng = np.random.RandomState(100 + round_idx)
        return [rng.randint(1, VOCAB, size=int(rng.randint(8, 25))).tolist()
                for _ in range(n)]

    loop = OnlineLoop(router, trainer, mgr, prompt_fn=prompts,
                      reward_fn=lambda p, toks: float(sum(
                          t % 2 == 0 for t in toks)),
                      config=OnlineConfig(
                          rounds=ONLINE_ROUNDS, rollouts=ONLINE_ROLLOUTS,
                          max_new_tokens=ONLINE_NEW,
                          train_steps=ONLINE_STEPS),
                      base_seed=0)
    reset_decode_counts(fd)
    t0 = time.perf_counter()
    rounds = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_hopper_launches(fd, "the online loop's rollouts")
    launches["flash_decode"] += fd.flash_decode_attention.launches
    check(len(rounds) == ONLINE_ROUNDS
          and all(r["swap"]["mode"] == "hot" for r in rounds)
          and [r["step"] for r in rounds] == [
              ONLINE_STEPS * (i + 1) for i in range(ONLINE_ROUNDS)],
          f"online rounds: {[(r['step'], r['swap']['mode']) for r in rounds]}")
    check(all(rep.engine.swap_count == ONLINE_ROUNDS
              for rep in router.replicas),
          f"swaps by replica {[r.engine.swap_count for r in router.replicas]}")
    check(all(sum(r["kept"]) == ONLINE_ROLLOUTS // 2 for r in rounds),
          f"kept rollouts {[sum(r['kept']) for r in rounds]}")
    stamp = read_manifest(mgr.step_path(rounds[-1]["step"]))["meta"][
        "compat"]
    check(stamp["arch"] == {"vocab": VOCAB, "num_layers": LAYERS,
                            "d_model": D_MODEL, "heads": HEADS},
          f"compat stamp {stamp}")
    served = router.replicas[0].engine._params
    check(all(torch.equal(served[n], p.detach().float())
              for n, p in trainer._params.items()),
          "the fleet does not serve the trainer's weights")
    mgr.close()
    log(f"  OnlineLoop: {ONLINE_ROUNDS} rounds in {wall:.2f} s, "
        f"{sum(r['rollout_tokens'] for r in rounds)} rollout tokens, "
        f"{sum(rep.engine.swap_count for rep in router.replicas)} hot swaps, "
        "the fleet serves the trainer's weights")
    del router, trainer
    torch.cuda.empty_cache()
    return {"wall_s": wall,
            "rollout_tokens": [r["rollout_tokens"] for r in rounds],
            "swap_ms": [r["swap"]["swap_ms"] for r in rounds]}


def phase_long_runs(torch, np, fa, fu, fd, quant, _build):
    """Phase 16: (a) the fp8 LM with recompute scopes, 2 microbatches and
    dynamic loss scaling, with the fp8 product against its plain version;
    (b) checkpoints: fit with saves, resume, SIGTERM, corruption,
    retention, rollback; (c) serving from the checkpoint; (d) the online
    loop.  Returns the launches of K2, K3, K4 and K5 and the numbers."""
    import tempfile
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    # every kernel was built in phase 2: an nvcc run here is a failure
    _build._compile = counting
    launches = dict.fromkeys(("fused_update", "flash_attn_fwd",
                              "flash_attn_bwd", "flash_decode"), 0)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["fp8_dot"] = long_fp8_dot(torch, np, quant)
            out["lm"], args = long_lm(torch, np, fa, fu, quant, launches)
            out["accum"] = long_accum(torch, np)
            out["matmul_precision"] = long_precision(torch, np)
            out["durability"], params = long_durability(
                torch, np, fa, fu, quant, args, launches, tmp)
            out["serve"] = long_serve(torch, np, fd, params,
                                      LONG_EPOCHS * LONG_BATCHES, launches,
                                      tmp)
            out["online"] = long_online(torch, np, fd, launches, tmp)
    finally:
        _build._compile = compile_
    check(not built, f"kernels built during phase 16: {built}")
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log("  long runs: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 17: programs (captured CUDA graphs) and the profiler on the card
# ---------------------------------------------------------------------------

# (a) phase 4's model and requests, then phase 5's fp8 pools and phase
# 11's n-gram speculation with fewer requests; a hot swap and a poisoned
# step; (b) phase 9's LM for 8 steps and phase 7's ResNet-50 for 4, fit
# over 4 batches; (c) Module over inception-bn-28-small for 3 batches,
# BucketingModule over phase 14's LSTM; (d) two processes sharing a fresh
# MXNET_TPU_CACHE_DIR
P17_FP8_REQUESTS, P17_SPEC_REQUESTS, P17_SPEC_NEW = 6, 4, 64
P17_SWAP_REQUESTS, P17_POISON_STEP = 4, 3
P17_LM_STEPS, P17_RESNET_STEPS, P17_FIT_BATCHES = 8, 4, 4
P17_MODULE_BATCHES, P17_TRACE_STEPS, P17_PROFILE = 3, 2, dict(steps=3,
                                                               repeats=2)
# K5's kernel symbol (both pools)
P17_DECODE_KERNEL = "decode_hopper_kernel"
P17_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from mxnet_tpu_torch import _build, compile_cache as cc, symbol as S
from mxnet_tpu_torch.parallel import ShardedTrainer
built = _build.build_all(["softmax_rows", "fused_update"])
net = S.FullyConnected(data=S.Variable("data"), num_hidden=64, name="fc1")
sym = S.SoftmaxOutput(data=net, name="softmax")
tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1}, device="cuda")
tr.bind({"data": (32, 16)}, {"softmax_label": (32,)})
info = tr.compile()[0]
heads = tr.step({"data": np.ones((32, 16), np.float32),
                 "softmax_label": np.zeros(32, np.float32)})
finite = bool(torch.isfinite(heads[0]).all())
print(json.dumps({
    "built": sorted(n for n, i in built.items() if not i["cached"]),
    "cached": sorted(n for n, i in built.items() if i["cached"]),
    "source": info["source"], "digest": info["digest"], "finite": finite,
    "hits": tr.aot_stats["hits"], "build_dir": str(_build.build_dir()),
    "disk_hits": cc.get_cache().stats["disk_hits"],
    "seen": sorted(e["digest"] for e in cc.get_cache().entries())}))
"""


def p17_misses():
    """Programs built (captured or eager) so far in this process."""
    from mxnet_tpu_torch import compile_cache
    return compile_cache.get_cache().stats["misses"]


def p17_take(counts, fd):
    """Add the flash-decode launches since the last reset to ``counts``
    and reset them (``serve_run`` resets them as it starts)."""
    f = fd.flash_decode_attention
    counts["flash_decode"] += f.launches
    counts["flash_decode_fp8"] += f.launches_fp8
    reset_decode_counts(fd)


def p17_trace_kernels(torch, run, tmp, fragment):
    """``run()`` under ``profiler.trace``: the kernel events of the
    written Chrome trace whose name holds ``fragment``, and all kernel
    events."""
    import glob
    import tempfile
    from mxnet_tpu_torch import profiler
    d = tempfile.mkdtemp(dir=tmp)
    torch.cuda.synchronize()
    with profiler.trace(d):
        run()
        torch.cuda.synchronize()
    (path,) = glob.glob(os.path.join(d, "trace.*.json"))
    with open(path) as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    return sum(fragment in k for k in kernels), len(kernels)


def p17_engines(torch, params, kw, **extra):
    """An eager engine and a captured one (``warmup``: every program a
    capture; a second ``warmup`` all memory hits)."""
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    eager = Engine(params, EngineConfig(**kw), device=DEVICE, **extra)
    eng = Engine(params, EngineConfig(**kw), device=DEVICE, **extra)
    t0 = time.perf_counter()
    infos = eng.warmup()
    seconds = time.perf_counter() - t0
    check(infos and all(i["source"] == "capture" for i in infos),
          "warmup: " + str([(i["kind"], i["bucket"], i["source"])
                            for i in infos]))
    again = eng.warmup()
    check(all(i["source"] == "memory" for i in again),
          f"second warmup: {[i['source'] for i in again]}")
    return eager, eng, {"programs": len(infos), "warmup_s": seconds,
                        "capture_s": sum(p.capture_seconds
                                         for p in eng._programs.values()),
                        "pool_bytes": sum(p.pool_bytes
                                          for p in eng._programs.values())}


def p17_serve(torch, np, fd, label, eager, eng, reqs, counts, fp8=False):
    """Serve ``reqs`` on both engines: greedy streams equal, every step
    of the captured engine a replay, no capture after warmup, the
    captured run's flash-decode launches the eager run's, ``num_layers``
    a decode step.  Returns both runs' stats."""
    p17_take(counts, fd)
    e_done, e_wall, e_ms, e_l, e_c = serve_run(torch, np, eager, reqs, fd)
    p17_take(counts, fd)
    misses, replays = p17_misses(), eng.aot_stats["replays"]
    c_done, c_wall, c_ms, c_l, c_c = serve_run(torch, np, eng, reqs, fd)
    p17_take(counts, fd)
    greedy = [i for i, (_, kw) in enumerate(reqs)
              if not kw.get("temperature")]
    check(all(c_done[i].tokens == e_done[i].tokens for i in greedy),
          f"{label}: captured greedy streams differ from eager: "
          f"{[i for i in greedy if c_done[i].tokens != e_done[i].tokens]}")
    check(eng.aot_stats["eager_steps"] == 0 and p17_misses() == misses,
          f"{label}: {eng.aot_stats['eager_steps']} eager steps, "
          f"{p17_misses() - misses} programs built after warmup")
    steps = c_c.get("decode_steps", 0) + c_c.get("verify_steps", 0)
    work = steps + c_c.get("prefill_chunks", 0) + (
        0 if eng.prefill_chunk else c_c.get("prefills", 0))
    check(eng.aot_stats["replays"] - replays == work,
          f"{label}: {eng.aot_stats['replays'] - replays} replays for "
          f"{work} steps of device work")
    if eng.spec is None:
        k5 = c_l[1] if fp8 else c_l[0]
        check(c_l == e_l and k5 == LAYERS * c_c["decode_steps"]
              == c_c["kernel_launches"],
              f"{label}: K5 launches {c_l} captured, {e_l} eager, "
              f"{c_c['decode_steps']} decode steps")
    same = sum(c_done[i].tokens == e_done[i].tokens
               for i in range(len(reqs)) if i not in greedy)
    out = {"captured": serve_stats(np, c_done, c_wall, c_ms, c_c),
           "eager": serve_stats(np, e_done, e_wall, e_ms, e_c),
           "sampled_streams_equal": f"{same}/{len(reqs) - len(greedy)}"}
    log(f"  (a) {label}: greedy streams equal, {work} steps replayed, "
        f"none captured after warmup: " + json.dumps(out))
    return out


def p17_trace_decode(torch, eng, reqs, tmp):
    """A full batch admitted and prefilled, one replayed decode step
    traced under ``profiler.trace`` and its trace discarded (a tracer's
    first session has dropped records: K5 listed 11 times of 12), then
    ``P17_TRACE_STEPS`` replayed decode steps under
    ``profiler.trace``: K5's kernel appears ``num_layers`` times a
    step."""
    ids = [eng.submit(p, **kw) for p, kw in reqs[:eng.config.max_batch]]
    while any(r.prefilled < r.prefill_target or not r.tokens
              for r in eng.sched.running) or eng.sched.queue:
        eng.step()
    p17_trace_kernels(torch, eng.step, tmp, P17_DECODE_KERNEL)
    before = eng.counters["decode_steps"]
    n, total = p17_trace_kernels(
        torch, lambda: [eng.step() for _ in range(P17_TRACE_STEPS)], tmp,
        P17_DECODE_KERNEL)
    steps = eng.counters["decode_steps"] - before
    check(steps == P17_TRACE_STEPS and n == LAYERS * steps,
          f"the trace of {steps} replayed decode steps lists "
          f"{P17_DECODE_KERNEL} {n} times ({total} kernels)")
    for i in ids:
        eng.cancel(i)
    eng.run()
    log(f"  (a) profiler.trace of {steps} replayed decode steps: "
        f"{P17_DECODE_KERNEL} {n} times, {total} kernels")
    return {"k5_in_trace": n, "kernels_in_trace": total}


def p17_serving(torch, np, fd, tmp, counts):
    from mxnet_tpu_torch import chaos as chaos_mod
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.serve.engine import EngineConfig

    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    reqs = request_set(np)
    res = {}
    eager, eng, res["programs"] = p17_engines(torch, params, ENGINE_KW)
    res["phase4"] = p17_serve(torch, np, fd, "phase 4's requests", eager,
                              eng, reqs, counts)
    res["phase4"].update(p17_trace_decode(torch, eng, reqs, tmp))
    res["phase4"]["profile_captured"] = profile_decode(torch, eng, reqs)
    res["phase4"]["profile_eager"] = profile_decode(torch, eager, reqs)
    p17_take(counts, fd)

    # a hot swap between steps: new weights copied into the captured
    # storage; the streams are an engine's built from them
    new = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=1)
    misses = p17_misses()
    eng.swap_weights(new)
    fresh = type(eng)(new, EngineConfig(**ENGINE_KW), device=DEVICE)
    few = [(p, dict(max_new_tokens=16)) for p, _ in
           reqs[:P17_SWAP_REQUESTS]]
    got = [eng.result(eng.submit(p, **kw)) for p, kw in few]
    want = [fresh.result(fresh.submit(p, **kw)) for p, kw in few]
    check(got == want and p17_misses() == misses
          and eng.aot_stats["eager_steps"] == 0,
          "after swap_weights the captured engine's streams differ from "
          "an engine built from the new weights, or it captured again")
    log(f"  (a) swap_weights: {len(few)} streams equal an engine's built "
        "from the new weights, no capture")
    del fresh, eager

    # a serve_poison_logits point: that step runs eagerly on NaN copies
    # and the finite check fails its requests; the other steps replay
    spec = chaos_mod.ChaosSpec({"serve_poison_logits": {P17_POISON_STEP}})
    _, peng, _ = p17_engines(torch, params, ENGINE_KW, chaos=spec)
    uncaptured = telemetry.registry().get_value("compile_cache.uncaptured") \
        or 0
    ids = [peng.submit(p, **kw) for p, kw in few]
    peng.run()
    failed = [i for i in ids if peng.requests[i].state != "finished"]
    eager_steps = peng.aot_stats["eager_steps"]
    check(peng.counters["nan_logits"] > 0 and failed and eager_steps >= 1
          and peng.aot_stats["replays"] > 0
          and (telemetry.registry().get_value("compile_cache.uncaptured")
               or 0) == uncaptured + eager_steps,
          f"poisoned step: nan_logits {peng.counters['nan_logits']}, "
          f"failed {failed}, aot {dict(peng.aot_stats)}")
    res["poison_eager_steps"] = eager_steps
    log(f"  (a) serve_poison_logits at step {P17_POISON_STEP}: caught "
        f"({peng.counters['nan_logits']} rows, {len(failed)} requests "
        f"failed), its {eager_steps} device runs eager, the other "
        f"{peng.aot_stats['replays']} replayed")
    del peng
    p17_take(counts, fd)

    # phase 5's fp8 pools, then phase 11's n-gram speculation
    kw5 = dict(ENGINE_KW, prefill_chunk=R12_CHUNK, kv_quant="fp8")
    eager, eng, progs = p17_engines(torch, params, kw5)
    res["fp8"] = p17_serve(torch, np, fd, "fp8 pools, chunks of "
                           f"{R12_CHUNK}", eager, eng,
                           reqs[:P17_FP8_REQUESTS], counts, fp8=True)
    res["fp8"]["programs"] = progs
    del eager, eng
    kw11 = dict(SPEC_KW, speculate=True, spec_k=SPEC_K, spec_draft="ngram")
    sreqs = [(p, dict(max_new_tokens=P17_SPEC_NEW))
             for p in spec_prompts(np)[:P17_SPEC_REQUESTS]]
    eager, eng, progs = p17_engines(torch, params, kw11)
    res["speculate"] = p17_serve(torch, np, fd, "n-gram speculation", eager,
                                 eng, sreqs, counts)
    res["speculate"]["programs"] = progs
    p17_take(counts, fd)
    return res


def p17_state(torch, tr):
    """A copy of a trainer's whole state and its update count."""
    return ([t.detach().clone() for t in tr._state_tensors()],
            tr._num_update)


def p17_same(torch, a, b):
    return a[1] == b[1] and all(
        torch.equal(u.reshape(-1).view(torch.uint8),
                    v.reshape(-1).view(torch.uint8))
        for u, v in zip(a[0], b[0]))


def p17_counts(kernels):
    return {k.__name__: (k.launches, dict(k.launches_by_form))
            for k in kernels}


def p17_train_pair(torch, np, label, trainer, batches, kernels, host_feeds,
                   groups):
    """An eager and a compiled trainer from the same state: ``compile()``
    changes nothing, the replayed steps equal the eager ones bit for bit
    (state, update count), the launch counts are equal, the heads of step
    1 survive the later steps; the step-phase profiles and a profiled
    step of each.  Returns the stats and the launches of both runs."""
    from mxnet_tpu_torch import profiler
    eager, comp = trainer(), trainer()
    before = p17_state(torch, comp)
    info = comp.compile(programs=("train",))[0]
    prog = comp._aot["train"][0]
    check(info["source"] == "capture",
          f"{label}: compile() resolved {info}")
    check(p17_same(torch, p17_state(torch, comp), before),
          f"{label}: compile() changed the trainer's state")
    placed = [comp.place_batch(b) for b in batches]
    reset_train_counts(*kernels)
    for b in placed:
        eager.step(b)
    torch.cuda.synchronize()
    eager_counts = p17_counts(kernels)
    reset_train_counts(*kernels)
    first = kept = None
    for i, b in enumerate(placed):
        heads = comp.step(b)
        if i == 0:
            first, kept = heads, [h.clone() for h in heads]
    torch.cuda.synchronize()
    comp_counts = p17_counts(kernels)
    check(comp_counts == eager_counts,
          f"{label}: launches {comp_counts} replayed, {eager_counts} eager")
    diff = state_diff(torch, eager, comp)
    check(not diff and eager._num_update == comp._num_update,
          f"{label}: replayed steps differ from eager in {diff}")
    check(all(torch.equal(a, b) for a, b in zip(first, kept)),
          f"{label}: the heads of step 1 changed under later replays")
    check(comp.aot_stats == {"hits": len(batches), "fallbacks": 0},
          f"{label}: {comp.aot_stats}")
    profiles = {}
    for name, tr in (("eager", eager), ("compiled", comp)):
        prof = profiler.profile_step(tr, host_feeds, **P17_PROFILE)
        log("  " + profiler.format_step_profile(
            prof, f"{label}, {name}").replace("\n", "\n  "))
        prof["profiled_step"] = profile_step(
            torch, lambda: tr.step(placed[0]), groups,
            label=f"{label}, {name}, profiled step")
        profiles[name] = prof
    out = {"capture_s": prog.capture_seconds, "pool_bytes": prog.pool_bytes,
           "launches_per_run": {k: v[0] for k, v in comp_counts.items()},
           "profiles": profiles}
    log(f"  (b) {label}: compile() left the state bitwise, "
        f"{len(batches)} replayed steps equal eager bit for bit (weights, "
        "optimizer state, aux, guard, update count), launches equal, "
        f"step 1's heads intact; capture {prog.capture_seconds:.3f} s, "
        f"graph pool {prog.pool_bytes} bytes")
    return out, comp, comp_counts, eager_counts


def p17_add(counts, *runs):
    for run in runs:
        for name, (n, _) in run.items():
            key = {"flash_fwd": "flash_attn_fwd",
                   "flash_bwd": "flash_attn_bwd"}.get(name, name)
            counts[key] += n


def p17_training(torch, np, nn_ops, fu, fa, counts):
    from mxnet_tpu_torch import io, models, symbol as S
    from mxnet_tpu_torch.parallel import ShardedTrainer
    res = {}

    # phase 9's LM (K3, K4, K2), with the guard and a clip
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)

    def lm_trainer():
        tr = ShardedTrainer(sym, optimizer="adam",
                            optimizer_params=dict(LM_OPT),
                            compute_dtype="bfloat16", guard=True,
                            clip_global_norm=CLIP, device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=args)

    feeds = [lm_batch(np, seed=i) for i in range(2)]
    res["lm"], _, c, e = p17_train_pair(
        torch, np, "the LM", lm_trainer,
        [lm_batch(np, seed=i) for i in range(P17_LM_STEPS)],
        (fa.flash_fwd, fa.flash_bwd, fu.fused_update), feeds,
        _LM_KERNEL_GROUPS)
    p17_add(counts, c, e)

    # phase 7's ResNet-50 (K1, K2) under deterministic cuDNN
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
        shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
        arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)

        def r50_trainer():
            tr = ShardedTrainer(sym, optimizer="sgd",
                                optimizer_params=dict(TRAIN_OPT),
                                guard=True, clip_global_norm=CLIP,
                                device=DEVICE)
            return tr.bind({"data": shapes["data"]},
                           {"softmax_label": shapes["softmax_label"]},
                           arg_params=args, aux_params=aux)

        x, y = loop_images(np, max(P17_RESNET_STEPS, P17_FIT_BATCHES)
                           * BATCH, seed=5)
        batches = [{"data": x[i * BATCH:(i + 1) * BATCH],
                    "softmax_label": y[i * BATCH:(i + 1) * BATCH]}
                   for i in range(P17_RESNET_STEPS)]
        res["resnet50"], comp, c, e = p17_train_pair(
            torch, np, "ResNet-50", r50_trainer, batches,
            (nn_ops.softmax_rows, fu.fused_update), batches[:2],
            _KERNEL_GROUPS)
        p17_add(counts, c, e)

        # fit over one epoch: fit's accuracy step replayed each batch
        info = comp.compile(programs=("train_acc",))[0]
        check(info["source"] == "capture", f"train_acc: {info}")
        hits = comp.aot_stats["hits"]
        reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
        comp.fit(io.NDArrayIter(x[:P17_FIT_BATCHES * BATCH],
                                y[:P17_FIT_BATCHES * BATCH],
                                batch_size=BATCH), eval_metric="acc",
                 num_epoch=1)
        torch.cuda.synchronize()
        p17_add(counts, p17_counts((nn_ops.softmax_rows, fu.fused_update)))
        check(comp.aot_stats["hits"] - hits == P17_FIT_BATCHES,
              f"fit: {comp.aot_stats['hits'] - hits} program hits over "
              f"{P17_FIT_BATCHES} batches")
        log(f"  (b) fit over {P17_FIT_BATCHES} batches: aot_hits "
            f"{comp.aot_stats['hits'] - hits}, one replay a batch")
        del comp
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn

    # a Dropout net: its masks come from generators seeded per step on
    # the host, so its program runs eagerly and says why
    with_dropout = S.SoftmaxOutput(data=S.FullyConnected(
        data=S.Dropout(data=S.FullyConnected(
            data=S.Variable("data"), num_hidden=256, name="d_fc1"), p=0.5),
        num_hidden=10, name="d_fc2"), name="softmax")
    tr = ShardedTrainer(with_dropout, "sgd", {"learning_rate": 0.1},
                        device=DEVICE)
    tr.bind({"data": (BATCH, 784)}, {"softmax_label": (BATCH,)})
    info = tr.compile()[0]
    check(info["source"] == "eager" and "Dropout" in info.get("reason", ""),
          f"the Dropout net's program: {info}")
    reset_train_counts(fu.fused_update)
    tr.step({"data": np.ones((BATCH, 784), np.float32),
             "softmax_label": np.zeros(BATCH, np.float32)})
    p17_add(counts, p17_counts((fu.fused_update,)))
    res["dropout"] = {"source": info["source"], "reason": info["reason"]}
    log(f"  (b) a Dropout net's program runs eagerly: {info['reason']}")
    return res


def p17_legacy(torch, np, nn_ops, counts):
    from mxnet_tpu_torch import initializer, io, models, ndarray
    from mxnet_tpu_torch import module as mod_api
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.context import cpu, gpu
    res = {}
    ctx = gpu(0) if DEVICE == "cuda" else cpu()
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # Module over inception-bn-28-small: compiled against eager
        sym = models.get_symbol("inception-bn-28-small")
        inputs = {"data": (CIFAR_BATCH,) + CIFAR_IMAGE,
                  "softmax_label": (CIFAR_BATCH,)}
        arg_shapes, _, aux_shapes = sym.infer_shape(**inputs)
        gen = torch.Generator().manual_seed(0)
        with cpu():
            args0 = {}
            for a, shape in zip(sym.list_arguments(), arg_shapes):
                if a not in inputs:
                    args0[a] = ndarray.zeros(shape)
                    initializer.Xavier()(a, args0[a], generator=gen)
            aux0 = {}
            for a, shape in zip(sym.list_auxiliary_states(), aux_shapes):
                aux0[a] = ndarray.zeros(shape)
                initializer.Xavier()(a, aux0[a])
        x, y = synthetic_cifar(np, P17_MODULE_BATCHES * CIFAR_BATCH)

        def module():
            m = mod_api.Module(sym, context=ctx)
            m.bind(data_shapes=[("data", inputs["data"])],
                   label_shapes=[("softmax_label", inputs["softmax_label"])])
            m.init_params(arg_params=args0, aux_params=aux0)
            m.init_optimizer(optimizer="sgd",
                             optimizer_params=dict(CIFAR_OPT))
            return m

        mods = {"eager": module(), "compiled": module()}
        infos = mods["compiled"].compile()
        check([i["source"] for i in infos] == ["capture"] * 3,
              f"Module.compile(): {[(i['kind'], i['source']) for i in infos]}")
        k1 = {}
        for name, m in mods.items():
            reset_train_counts(nn_ops.softmax_rows)
            for it in io.NDArrayIter(x, y, batch_size=CIFAR_BATCH):
                m.forward(it, is_train=True)
                m.backward()
                m.update()
            torch.cuda.synchronize()
            k1[name] = nn_ops.softmax_rows.launches
            counts["softmax_rows"] += k1[name]
        legacy_bitwise(torch, mods["compiled"].get_params()[0],
                       mods["eager"].get_params()[0],
                       "Module.compile() against the eager Module")
        legacy_bitwise(torch, mods["compiled"].get_params()[1],
                       mods["eager"].get_params()[1],
                       "Module.compile() against the eager Module (aux)")
        res["module"] = {"programs": len(infos), "k1": k1,
                         "capture_s": [i["seconds"] for i in infos]}
        log(f"  (c) Module.compile() on inception-bn-28-small: "
            f"{P17_MODULE_BATCHES} batches bitwise the eager Module's; K1 "
            f"{k1} (fb recomputes the forward, as the JAX program does)")
        del mods

        # BucketingModule over the LSTM: compile([8, 16]) against eager
        hid, vocab, bsz = LSTM["num_hidden"], LSTM["vocab"], LSTM["batch"]
        data_names = ("data", "l0_init_c", "l0_init_h")

        def sym_gen(key):
            return (lstm_unroll(S, hid, key, vocab, LSTM["num_embed"]),
                    data_names, ("softmax_label",))

        def shapes(key):
            return ([("data", (bsz, key)), ("l0_init_c", (bsz, hid)),
                     ("l0_init_h", (bsz, hid))],
                    [("softmax_label", (bsz, key))])

        default = max(LSTM_BUCKETS)
        net = sym_gen(default)[0]
        arg_shapes, _, _ = net.infer_shape(**dict(sum(shapes(default), [])))
        prng = np.random.RandomState(1)
        params = {a: prng.uniform(-0.1, 0.1, s).astype(np.float32)
                  for a, s in zip(net.list_arguments(), arg_shapes)
                  if a not in data_names and a != "softmax_label"}
        rng = np.random.RandomState(0)
        zeros = np.zeros((bsz, hid), np.float32)
        batches = []
        for i in range(LSTM_BATCHES):
            key = LSTM_BUCKETS[i % 2]
            seq = (rng.randint(0, vocab, (bsz, 1))
                   + np.arange(key + 1)) % vocab
            batches.append(io.DataBatch(
                data=[ndarray.array(seq[:, :-1].astype(np.float32),
                                    ctx=cpu()),
                      ndarray.array(zeros, ctx=cpu()),
                      ndarray.array(zeros, ctx=cpu())],
                label=[ndarray.array(seq[:, 1:].astype(np.float32),
                                     ctx=cpu())], bucket_key=key,
                provide_data=shapes(key)[0], provide_label=shapes(key)[1]))

        def bucketing():
            m = mod_api.BucketingModule(sym_gen, default_bucket_key=default,
                                        context=ctx)
            m.bind(*shapes(default))
            with cpu():
                m.init_params(arg_params={a: ndarray.array(v)
                                          for a, v in params.items()})
            m.init_optimizer(optimizer="sgd",
                             optimizer_params=dict(LSTM_OPT))
            return m

        mods = {"eager": bucketing(), "compiled": bucketing()}
        infos = mods["compiled"].compile(list(LSTM_BUCKETS))
        check({i["source"] for i in infos} == {"capture"},
              f"BucketingModule.compile: {[i['source'] for i in infos]}")
        for name, m in mods.items():
            reset_train_counts(nn_ops.softmax_rows)
            for b in batches:
                m.forward(b, is_train=True)
                m.backward()
                m.update()
            torch.cuda.synchronize()
            counts["softmax_rows"] += nn_ops.softmax_rows.launches
        legacy_bitwise(torch, mods["compiled"].get_params()[0],
                       mods["eager"].get_params()[0],
                       "BucketingModule.compile() against eager")
        report = mods["compiled"].cache_report()
        check(report["programs"] == 3 * len(LSTM_BUCKETS)
              and mods["eager"].cache_report()["programs"] == 0,
              f"cache_report: {report}")
        res["bucketing"] = report
        log(f"  (c) BucketingModule.compile({list(LSTM_BUCKETS)}): "
            f"cache_report {report}; {LSTM_BATCHES} batches bitwise the "
            "eager module's")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = cudnn
    return res


def p17_persistent(tmp):
    """(d) two processes with one fresh ``MXNET_TPU_CACHE_DIR``: the first
    builds the kernels its FC trainer runs (K1, K2), the second builds
    none (its libraries come from the directory) and lists the first
    one's program sidecars."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MXNET_TPU_CACHE_DIR=tempfile.mkdtemp(dir=tmp))

    def child():
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", P17_CHILD, root],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        check(out.returncode == 0,
              f"persistent-cache child failed: {out.stderr[-2000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        got["wall_s"] = time.perf_counter() - t0
        return got

    cold, warm = child(), child()
    names = sorted(cold["built"])
    check(names and not cold["cached"] and cold["source"] == "capture"
          and cold["finite"] and cold["hits"] == 1
          and cold["build_dir"].endswith("/cuda"),
          f"first process: {cold}")
    check(not warm["built"] and warm["cached"] == names
          and warm["disk_hits"] == len(names)
          and cold["digest"] in warm["seen"] and warm["source"] == "capture",
          f"second process: {warm}")
    log(f"  (d) MXNET_TPU_CACHE_DIR: the first process built {names} "
        f"({cold['wall_s']:.1f} s), the second none ({warm['wall_s']:.1f} s, "
        f"{warm['disk_hits']} libraries from disk) and lists the first "
        "one's program key")
    return {"cold_s": cold["wall_s"], "warm_s": warm["wall_s"],
            "disk_hits": warm["disk_hits"]}


def phase_programs(torch, np, nn_ops, fu, fa, fd, _build):
    """Phase 17: (a)-(c) build no kernel; every program of the main paths
    is captured (none eager but the Dropout net's and the poisoned
    step)."""
    import tempfile
    from mxnet_tpu_torch import telemetry
    counts = dict.fromkeys(("flash_decode", "flash_decode_fp8",
                            "softmax_rows", "fused_update", "flash_attn_fwd",
                            "flash_attn_bwd"), 0)
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    tmp = tempfile.mkdtemp(prefix="p17")
    res = {}

    def uncaptured():
        return telemetry.registry().get_value(
            "compile_cache.uncaptured") or 0

    before = uncaptured()
    try:
        t0 = time.perf_counter()
        res["serving"] = p17_serving(torch, np, fd, tmp, counts)
        res["serving_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["training"] = p17_training(torch, np, nn_ops, fu, fa, counts)
        res["training_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["legacy"] = p17_legacy(torch, np, nn_ops, counts)
        res["legacy_s"] = time.perf_counter() - t0
    finally:
        _build._compile = compile_
    check(not built, f"phase 17 built kernels: {built}")
    # eager: the Dropout net's program and the poisoned step's runs only
    eager = uncaptured() - before
    check(eager == 1 + res["serving"]["poison_eager_steps"],
          f"{eager} programs or steps ran eagerly in phase 17")
    log(f"  eager in phase 17: {eager} (the Dropout net's program and the "
        "poisoned step's runs); every other program captured")
    t0 = time.perf_counter()
    res["persistent"] = p17_persistent(tmp)
    res["persistent_s"] = time.perf_counter() - t0
    res["launches"] = counts
    log("  phase 17: " + json.dumps(res))
    return counts, res


# ---------------------------------------------------------------------------
# Phase 18: data parallelism in one process
# ---------------------------------------------------------------------------

DP_STEPS = 4
DP_LEGACY_BATCHES = 4


def dp_mesh(torch):
    """The data mesh over every local device of the platform: one member
    on a one-card machine.  With more cards (a)-(c) keep to the first
    (their checks are bitwise against one card); (f) spans two."""
    from mxnet_tpu_torch.parallel import data_parallel_mesh
    several = DEVICE == "cuda" and torch.cuda.device_count() > 1
    return data_parallel_mesh(1 if several else None,
                              device_type="gpu" if DEVICE == "cuda"
                              else "cpu")


def dp_state(torch, tr):
    """A trainer's whole state as {name: int32 bits}: weights, optimizer
    state by parameter, aux states, guard state, residuals."""
    out = {f"param:{n}": bits(torch, p) for n, p in tr._params.items()}
    for n, st in tr.opt_state_by_param().items():
        out.update({f"opt:{n}:{i}": bits(torch, t) for i, t in
                    enumerate(st)})
    out.update({f"aux:{n}": bits(torch, v) for n, v in tr._aux.items()})
    out.update({f"guard:{n}": v.detach().reshape(-1).view(torch.uint8)
                for n, v in (tr._guard_state or {}).items()})
    for i, res in enumerate(tr._ef_res):
        out.update({f"efres:{i}:{b}": bits(torch, r)
                    for b, r in enumerate(res)})
    return out


def dp_same(torch, a, b, what, keys=None):
    keys = sorted(a) if keys is None else keys
    for k in keys:
        check(torch.equal(a[k], b[k].to(a[k].device)),
              f"{what}: {k} differs")


def dp_params(torch, tr):
    """A copy of a trainer's parameters, float32 on the host."""
    return {n: p.detach().to("cpu", torch.float32, copy=True)
            for n, p in tr._params.items()}


def dp_max_diff(a, b):
    """The largest elementwise distance between two parameter sets."""
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def dp_run(torch, tr, batches, label, counts, no_sync=True):
    """``DP_STEPS`` steps over pre-placed batches; steps 2.. are counted
    for synchronizing calls (none allowed with ``no_sync``) and timed by
    CUDA events.  Returns the ms a step, the launches of K1/K2 (by form)
    in the run, the first step's heads and the parameters after it."""
    from mxnet_tpu_torch.ops import fused_update as fu
    from mxnet_tpu_torch.ops import nn_ops
    placed = [tr.place_batch(b) for b in batches]
    torch.cuda.synchronize()
    reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
    first = tr.step(placed[0])[0]
    # read before the counted steps (a copy to the host waits)
    state1 = dp_params(torch, tr)
    counter = SyncCounter(torch)
    events = [record_event(torch)]
    counter.start()
    try:
        for b in placed[1:]:
            tr.step(b)
            events.append(record_event(torch))
    finally:
        syncs = counter.stop()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    check(syncs["outside"] == 0 and syncs["other threads"] == 0
          or DEVICE != "cuda" or not no_sync,
          f"{label}: synchronizing calls in steps 2-{DP_STEPS}: {syncs} "
          f"{counter.sites}")
    run = {"k1": nn_ops.softmax_rows.launches,
           "k2": fu.fused_update.launches,
           "k2_forms": dict(fu.fused_update.launches_by_form),
           "median_step_ms": float(sorted(ms)[len(ms) // 2]) if ms
           else None,
           "syncs": syncs, "first_heads": first, "state1": state1}
    counts["softmax_rows"] += run["k1"]
    counts["fused_update"] += run["k2"]
    # one forward a member a step
    check(run["k1"] == DP_STEPS * tr.mesh.size,
          f"{label}: K1 launched {run['k1']} times in {DP_STEPS} steps over "
          f"{tr.mesh.size} member(s)")
    return run


def dp_trainers(torch, np, counts):
    """(a) the default data mesh against the trainer placed by ``device``,
    with the summation-order witness; (b) int8 with error feedback fused
    against unfused, and captured as a CUDA graph; (c) ZeRO against (a),
    and captured: ResNet-50 at phase 7's width, ``DP_STEPS`` steps each on
    the same batches, bitwise."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    rng = np.random.RandomState(18)
    batches = [{"data": rng.rand(*shapes["data"]).astype(np.float32),
                "softmax_label": rng.randint(0, CLASSES, BATCH)
                .astype(np.float32)} for _ in range(DP_STEPS)]
    mesh = dp_mesh(torch)

    def trainer(**kw):
        tr = ShardedTrainer(sym, optimizer="sgd",
                            optimizer_params=dict(TRAIN_OPT), guard=True,
                            clip_global_norm=CLIP, **kw)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=args, aux_params=aux)

    res = {"members": [str(m) for m in mesh.members]}
    states1 = {}

    def run(tr, label, data=batches):
        out = dp_run(torch, tr, data, label, counts)
        heads = out.pop("first_heads")
        states1[label] = out.pop("state1")
        return out, heads

    def captured(label, want, **kw):
        """The trainer of ``kw`` with its step captured as a CUDA graph
        (one member: the one step path, whatever the mode), its replays
        bitwise the eager run's state ``want``."""
        tr = trainer(mesh=mesh, **kw)
        info = tr.compile(programs=("train",))[0]
        check(info["source"] == ("capture" if DEVICE == "cuda" else "eager"),
              f"{label}: the step was not captured: {info}")
        out, _ = run(tr, label)
        dp_same(torch, dp_state(torch, tr), want, f"{label} against eager")
        check(tr.aot_stats["hits"] == DP_STEPS,
              f"{label}: {tr.aot_stats} replays")
        return out

    check(mesh.size == 1, f"(a)-(c)'s mesh has {mesh.size} members")
    # (a) the trainer placed by device (phase 7's; "cuda" alone would be
    # a mesh over every card of a machine with several) and the default
    # data mesh: one member, both through the one step path
    plain = trainer(device=("cuda:0" if DEVICE == "cuda" else DEVICE))
    res["plain"], heads_a = run(plain, "(a) plain")
    want = dp_state(torch, plain)
    want_params = dp_params(torch, plain)
    del plain
    tr = trainer(mesh=mesh)
    check(tr._fused and tr._fused_route == "hopper" or DEVICE != "cuda",
          "(a): the mesh trainer did not take K2's hopper form")
    res["implicit"], _ = run(tr, "(a) mesh")
    a_state = dp_state(torch, tr)
    dp_same(torch, a_state, want, "(a) the default mesh against device=")
    check(res["implicit"]["k2_forms"]["hopper"] == DP_STEPS,
          f"(a): K2 launches {res['implicit']['k2_forms']}")
    del tr
    # the witness of float32 summation order: each batch with its two
    # halves swapped (the same function of the rows, summed in another
    # order, as two cards sum it)
    half = BATCH // 2
    swapped = [{k: np.concatenate([v[half:], v[:half]]) for k, v in b.items()}
               for b in batches]
    tr = trainer(mesh=mesh)
    res["swapped"], heads_s = run(tr, "(a) halves swapped", swapped)
    heads_s = torch.cat([heads_s[half:], heads_s[:half]])
    res["order_witness"] = {
        "first_heads_max_diff": float((heads_s - heads_a).abs().max()),
        "step1_max_param_diff": dp_max_diff(states1["(a) halves swapped"],
                                            states1["(a) plain"]),
        "max_param_diff": dp_max_diff(dp_params(torch, tr), want_params)}
    check(all(np.isfinite(v) for v in res["order_witness"].values()),
          f"(a): the witness is not finite: {res['order_witness']}")
    del tr
    log(f"  (a) the default mesh {res['members']}: bitwise the trainer "
        f"placed by device= after {DP_STEPS} steps (one member: both take "
        f"the one step path); {res['implicit']['median_step_ms']:.3f} ms a "
        f"step against {res['plain']['median_step_ms']:.3f}; the batch's "
        "halves swapped (summation order only): "
        + json.dumps(res["order_witness"]))
    # (b) int8 with error feedback: the fused update (K2's bucket form
    # over the reduced buckets) against the unfused one
    tr = trainer(mesh=mesh, grad_compression="int8")
    check(tr.error_feedback and tr._fused,
          "(b): error feedback or the fused update is off")
    n_buckets = len(tr._fused_plan.buckets)
    res["int8_fused"], _ = run(tr, "(b) int8 fused")
    check(res["int8_fused"]["k2_forms"] == {"hopper": 0,
                                            "bucket": DP_STEPS * n_buckets},
          f"(b): K2 launches {res['int8_fused']['k2_forms']}, expected "
          f"{n_buckets} bucket-form launches a step")
    fused_state = dp_state(torch, tr)
    check(any(bool(r.any()) for r in tr._ef_res[0]),
          "(b): the error-feedback residuals stayed zero")
    del tr
    tr = trainer(mesh=mesh, grad_compression="int8", fused_update=False)
    res["int8_unfused"], _ = run(tr, "(b) int8 unfused")
    dp_same(torch, fused_state, dp_state(torch, tr),
            "(b) int8 fused against unfused")
    del tr
    res["int8_captured"] = captured("(b) int8 captured", fused_state,
                                    grad_compression="int8")
    log(f"  (b) int8 + error feedback: fused bitwise unfused, and captured "
        f"bitwise eager; K2 {res['int8_fused']['k2']} bucket-form launches "
        f"({n_buckets} a step); {res['int8_fused']['median_step_ms']:.3f} "
        f"ms a step fused, {res['int8_unfused']['median_step_ms']:.3f} "
        f"unfused, {res['int8_captured']['median_step_ms']:.3f} captured, "
        f"against (a)'s {res['implicit']['median_step_ms']:.3f}")
    # (c) ZeRO against (a)
    tr = trainer(mesh=mesh, shard_optimizer=True)
    check(not tr._fused, "(c): ZeRO took the fused update")
    res["zero"], _ = run(tr, "(c) ZeRO")
    dp_same(torch, dp_state(torch, tr), a_state, "(c) ZeRO against (a)")
    del tr
    res["zero_captured"] = captured("(c) ZeRO captured", a_state,
                                    shard_optimizer=True)
    log(f"  (c) ZeRO: bitwise (a), and captured bitwise (a); "
        f"{res['zero']['median_step_ms']:.3f} ms a step, "
        f"{res['zero_captured']['median_step_ms']:.3f} captured")
    return res


def dp_legacy(torch, np, counts):
    """(d) phase 14's CIFAR net through FeedForward and Module over
    ``[gpu(0), gpu(0)]`` with the ``device`` kvstore (the update on the
    kvstore), each bitwise a bare loop of two executors whose gradients
    are summed by hand and stepped by the same updater."""
    from mxnet_tpu_torch import initializer, io, model, models, ndarray
    from mxnet_tpu_torch import module as mod_api
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.context import cpu, gpu
    from mxnet_tpu_torch.ops import nn_ops
    sym = models.get_symbol("inception-bn-28-small")
    n = DP_LEGACY_BATCHES * CIFAR_BATCH
    x, y = synthetic_cifar(np, n, seed=18)
    half = CIFAR_BATCH // 2
    inputs = {"data": (CIFAR_BATCH,) + CIFAR_IMAGE,
              "softmax_label": (CIFAR_BATCH,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**inputs)
    names = [a for a in sym.list_arguments() if a not in inputs]
    gen = torch.Generator().manual_seed(0)
    with cpu():
        args0, aux0 = {}, {}
        for a, shape in zip(sym.list_arguments(), arg_shapes):
            if a in names:
                args0[a] = ndarray.zeros(shape)
                initializer.Xavier()(a, args0[a], generator=gen)
        for a, shape in zip(sym.list_auxiliary_states(), aux_shapes):
            aux0[a] = ndarray.zeros(shape)
            initializer.Xavier()(a, aux0[a])
    dev = gpu(0) if DEVICE == "cuda" else cpu()
    ctxs = [dev, dev]
    opt_kw = dict(CIFAR_OPT)
    reset_train_counts(nn_ops.softmax_rows)
    ff = model.FeedForward(sym, ctx=ctxs, num_epoch=1, optimizer="sgd",
                           initializer=initializer.Xavier(),
                           arg_params=args0, aux_params=aux0, **opt_kw)
    ff.fit(X=io.NDArrayIter(x, y, batch_size=CIFAR_BATCH), kvstore="device")
    m = mod_api.Module(sym, context=ctxs)
    m.fit(io.NDArrayIter(x, y, batch_size=CIFAR_BATCH), num_epoch=1,
          optimizer="sgd", optimizer_params=opt_kw, kvstore="device",
          arg_params=args0, aux_params=aux0)
    check(m._update_on_kvstore and m._kvstore.type == "device",
          "(d): Module did not update on the device kvstore")
    legacy_k1 = nn_ops.softmax_rows.launches
    # the bare loop: two executors, gradients summed by hand, the
    # updater FeedForward's kvstore runs, keyed by parameter index
    execs = []
    for _ in ctxs:
        ex = sym.simple_bind(dev, grad_req={a: "write" for a in names},
                             data=(half,) + CIFAR_IMAGE,
                             softmax_label=(half,))
        ex.copy_params_from(args0, aux0)
        execs.append(ex)
    opt = optimizer.create("sgd", rescale_grad=1.0 / CIFAR_BATCH, sym=sym,
                           param_idx2name=dict(enumerate(names)), **opt_kw)
    updater = optimizer.get_updater(opt)
    with dev:
        store = {k: ndarray.array(args0[a].asnumpy())
                 for k, a in enumerate(names)}
    for i in range(DP_LEGACY_BATCHES):
        for j, ex in enumerate(execs):
            sl = slice(i * CIFAR_BATCH + j * half,
                       i * CIFAR_BATCH + (j + 1) * half)
            ex.forward(is_train=True, data=x[sl], softmax_label=y[sl])
            ex.backward()
        for k, a in enumerate(names):
            g = (execs[0].grad_dict[a].data
                 + execs[1].grad_dict[a].data)
            updater(k, ndarray.NDArray(g, ctx=dev), store[k])
            for ex in execs:
                ex.arg_dict[a][:] = store[k]
    bare_k1 = nn_ops.softmax_rows.launches - legacy_k1
    bare = {a: execs[0].arg_dict[a] for a in names}
    with dev:
        bare_aux = {a: ndarray.NDArray((execs[0].aux_dict[a].data
                                        + execs[1].aux_dict[a].data) / 2,
                                       ctx=dev)
                    for a in execs[0].aux_dict}
    legacy_bitwise(torch, ff.arg_params, bare, "(d) FeedForward against "
                   "the two-executor bare loop")
    legacy_bitwise(torch, ff.aux_params, bare_aux, "(d) FeedForward "
                   "against the bare loop (aux, the mean of the two)")
    m_arg, m_aux = m.get_params()
    legacy_bitwise(torch, m_arg, bare, "(d) Module against the bare loop")
    legacy_bitwise(torch, m_aux, bare_aux, "(d) Module against the bare "
                   "loop (aux)")
    # the executors kept their own statistics (fit averages them at the
    # epoch's end, as MXNet does), and the trained copies match the mean
    check(any(not execs[0].aux_dict[a].data.equal(execs[1].aux_dict[a].data)
              for a in execs[0].aux_dict),
          "(d): the two executors' BatchNorm statistics are the same")
    forwards = 2 * DP_LEGACY_BATCHES
    check(legacy_k1 == 2 * forwards and bare_k1 == forwards,
          f"(d): K1 launched {legacy_k1} + {bare_k1} times")
    counts["softmax_rows"] += legacy_k1 + bare_k1
    log(f"  (d) FeedForward and Module over [{dev}, {dev}] with the device "
        "kvstore: bitwise a bare loop of two executors (gradients summed "
        "by hand, the same updater); each executor keeps its own "
        f"BatchNorm statistics; K1 {legacy_k1} + {bare_k1}")
    return {"k1": legacy_k1 + bare_k1}


def dp_kvstore(torch, np, ctxs=(0, 0)):
    """(e) ResNet-50's 161 gradients pushed and pulled over two members
    with each compression, and ``psum_compressed`` over the two: exact on
    integer-valued data (None, bf16), within the analytic bound (int8:
    n * absmax / 127 / 2; fp8: n * absmax * 2^-4).  Two members on one
    card (``ctxs`` (0, 0)) reduce by the co-resident tree sum, one
    reduction a gradient; on two cards ((0, 1), (f)) by buckets through
    NCCL, compressed."""
    from mxnet_tpu_torch import kvstore, models, ndarray
    from mxnet_tpu_torch.context import cpu, gpu
    from mxnet_tpu_torch.parallel.collectives import (count_collectives,
                                                      psum_compressed)
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes, _, _ = sym.infer_shape(data=(BATCH,) + IMAGE,
                                   softmax_label=(BATCH,))
    grads = [s for n, s in zip(sym.list_arguments(), shapes)
             if n not in ("data", "softmax_label")]
    check(len(grads) == 161, f"ResNet-50 has {len(grads)} parameters")
    make = gpu if DEVICE == "cuda" else cpu
    devs = [make(c) for c in ctxs]
    distinct = devs[0] != devs[1]
    gens = [torch.Generator(device=d.torch_device).manual_seed(18 + j)
            for j, d in enumerate(devs)]
    res = {}
    for comp in (None, "bf16", "int8", "fp8"):
        integer = comp in (None, "bf16")
        vals = [[(torch.randint(-8, 9, s, generator=g,
                                device=d.torch_device).float()
                  if integer else
                  torch.randn(s, generator=g, device=d.torch_device))
                 for g, d in zip(gens, devs)] for s in grads]
        flat = [torch.cat([p[j].reshape(-1) for p in vals])
                for j in range(2)]
        exact = flat[0] + flat[1].to(flat[0].device)
        absmax = float(torch.maximum(flat[0].abs().max(),
                                     flat[1].abs().max().to(
                                         flat[0].device)))
        bound = {None: 0.0, "bf16": 0.0, "int8": 2 * absmax / 127 / 2,
                 "fp8": 2 * absmax * 2 ** -4}[comp]
        kv = kvstore.create("device", compression=comp)
        with devs[0]:
            for k, s in enumerate(grads):
                kv.init(k, ndarray.zeros(s))
            outs = [ndarray.zeros(s) for s in grads]
        with count_collectives() as stats:
            for k, pair in enumerate(vals):
                kv.push(k, [ndarray.NDArray(v, ctx=d)
                            for v, d in zip(pair, devs)], priority=-k)
            for k in range(len(grads)):
                kv.pull(k, out=outs[k], priority=-k)
        kinds = {r["kind"] for r in stats.records}
        total = sum(int(np.prod(s)) for s in grads) * 4
        # distinct members: fused buckets, each pushed 4 MiB flushing
        # what is pending; co-resident: one tree sum a gradient
        want = ({"bucket"} if distinct else {"tree"})
        check(kinds == want and stats.total_bytes == total
              and (distinct or stats.count == len(grads)),
              f"(e) {comp}: {stats.count} reductions of kinds {kinds} over "
              f"{stats.total_bytes} bytes")
        pulled = torch.cat([o.data.reshape(-1) for o in outs])
        kv_err = float((pulled - exact).abs().max())
        # co-resident members reduce uncompressed: exact
        check(kv_err <= (bound if distinct else 0.0) + 1e-6,
              f"(e) {comp}: the pulled sums are {kv_err} from the sums")
        red = psum_compressed(flat, comp)
        err = float((red[0] - exact).abs().max())
        check(err <= bound + 1e-6,
              f"(e) psum_compressed {comp}: max error {err} over the bound "
              f"{bound}")
        check(torch.equal(red[0], red[1].to(red[0].device)),
              f"(e) psum_compressed {comp}: the members' sums differ")
        res[str(comp)] = {"reductions": stats.count, "kinds": sorted(kinds),
                          "kvstore_max_err": kv_err, "psum_max_err": err,
                          "bound": bound, "bytes": stats.total_bytes,
                          "wire_bytes": stats.total_wire_bytes}
        del vals, flat, red, exact, outs, kv, pulled
    how = ("in fused buckets" if distinct
           else "in 161 co-resident (tree) reductions, exact for every "
           "compression")
    log(f"  (e) the device kvstore over {devs}: 161 gradients a flush "
        f"{how}; psum_compressed over the two within its bound: "
        + json.dumps({k: v["psum_max_err"] for k, v in res.items()}))
    return res


# (f)'s limit on the parameters after one update, two cards against one
# in the implicit mode: float32 summation order only, as (a)'s witness
# (each batch's halves swapped on one card), ten times the witness's
# reading on an H100 (3.09e-4, PERF.md, PR 15's run D); at this random
# init the backward through 53 BatchNorms moves the first convolution's
# gradient ~1 % with the summation order
DP_STEP1_LIMIT = 3e-3


def dp_reduction(torch, np, tr, batch, label):
    """The trainer's reduction of one step's gradients over its members
    (:meth:`_forward_backward`, before any update: zero residuals) against
    the members' own gradients, recomputed (deterministic cuDNN) and
    summed in float64 on the lead's card.  Implicit mode: bitwise their
    float32 sum (two members: one addition, NCCL's ring too).  int8: within
    the JAX test's bound n * absmax / 127 / 2 (each member's rounding to
    its block's shared scale), plus the dequantize multiply's rounding.
    A member left out or a wrong scale breaks either.  Returns the
    largest error and its bound."""
    from mxnet_tpu_torch.random import mix
    placed = tr.place_batch(batch)
    n = len(tr._devices)
    explicit = tr.grad_compression is not None
    _, grads, _, _, _ = tr._forward_backward(placed)
    auxs = [dict(tr._member_aux(i)) for i in range(n)]
    _, _, member = tr._run_members(placed.shards, auxs,
                                   mix(tr._seed, tr._num_update), None,
                                   local=explicit)
    lead = tr.device
    if explicit and tr._bucket_out():
        flat = torch.cat(list(grads))
        plan = tr._fused_plan
        grads = {nm: flat[plan.offsets[nm]:plan.offsets[nm]
                          + int(np.prod(plan.shapes[nm]))]
                 .view(plan.shapes[nm]) for nm in plan.order}
    worst = bound = 0.0
    absmax = max(float(g[nm].abs().max()) for g in member for nm in g)
    for nm, got in grads.items():
        parts = [g[nm].to(lead) for g in member]
        if not explicit:
            check(torch.equal(got, parts[0] + parts[1]),
                  f"{label}: the reduced gradient of {nm} is not the sum "
                  "of the members'")
            continue
        exact = sum(p.double() for p in parts)
        err = float((got.double() - exact).abs().max())
        lim = (n * absmax / 127 / 2
               + float(exact.abs().max()) * 2.0 ** -23)
        check(err <= lim, f"{label}: {nm}'s reduced gradient is {err} from "
              f"the members' sum, over the int8 bound {lim}")
        worst, bound = max(worst, err), max(bound, lim)
    return {"max_err": worst, "bound": bound, "absmax": absmax}


def dp_distinct_cards(torch, np, counts, a_res):
    """(f) where two cards exist: (a) and (b) over ``data_parallel_mesh(2)``
    (NCCL between the cards).  The reductions of one step against the
    members' gradients (:func:`dp_reduction`); the implicit mode's first
    heads and first update against the one-card trainer's (its later
    drift is recorded beside (a)'s witness); int8 fused bitwise unfused
    on two cards."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel_mesh
    if DEVICE == "cuda" and torch.cuda.device_count() < 2:
        log(f"  (f) not run: {torch.cuda.device_count()} CUDA device(s); "
            "the distinct-card branch (NCCL between two cards) needs two")
        return {"run": False, "devices": torch.cuda.device_count()}
    kind = "gpu" if DEVICE == "cuda" else "cpu"      # cpu: a rehearsal
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    rng = np.random.RandomState(18)
    batches = [{"data": rng.rand(*shapes["data"]).astype(np.float32),
                "softmax_label": rng.randint(0, CLASSES, BATCH)
                .astype(np.float32)} for _ in range(DP_STEPS)]
    out = {"run": True}
    states, states1, heads, int8_bits = {}, {}, {}, {}
    one = data_parallel_mesh(1, device_type=kind)
    two = data_parallel_mesh(2, device_type=kind)
    for label, kw in (("one card", {"mesh": one}),
                      ("two cards", {"mesh": two}),
                      ("two cards int8", {"mesh": two,
                                          "grad_compression": "int8"}),
                      ("two cards int8 unfused", {
                          "mesh": two, "grad_compression": "int8",
                          "fused_update": False})):
        tr = ShardedTrainer(sym, optimizer="sgd",
                            optimizer_params=dict(TRAIN_OPT), guard=True,
                            clip_global_norm=CLIP, **kw)
        tr.bind({"data": shapes["data"]},
                {"softmax_label": shapes["softmax_label"]},
                arg_params=args, aux_params=aux)
        if label in ("two cards", "two cards int8"):
            out[label + " reduction"] = dp_reduction(
                torch, np, tr, batches[0], f"(f) {label}")
        out[label] = dp_run(torch, tr, batches, f"(f) {label}", counts,
                            no_sync=False)
        heads[label] = out[label].pop("first_heads").float().cpu()
        states1[label] = out[label].pop("state1")
        states[label] = dp_params(torch, tr)
        if "int8" in label:
            int8_bits[label] = dp_state(torch, tr)
        del tr
    dp_same(torch, int8_bits["two cards int8"],
            int8_bits["two cards int8 unfused"],
            "(f) two cards int8 fused against unfused")
    del int8_bits
    out["kvstore"] = dp_kvstore(torch, np, ctxs=(0, 1))
    # the first step's heads: global BatchNorm statistics over the two
    # cards give the one card's forward to float32 summation order
    # (the explicit mode's are per card)
    diff = float((heads["two cards"] - heads["one card"]).abs().max())
    out["two cards"]["first_heads_max_diff"] = diff
    check(diff <= 1e-3, f"(f) two cards: the first step's heads are {diff} "
          "from the one card's")
    step1 = dp_max_diff(states1["two cards"], states1["one card"])
    out["two cards"]["step1_max_param_diff"] = step1
    check(step1 <= DP_STEP1_LIMIT, f"(f) two cards: the first update is "
          f"{step1} from the one card's, over {DP_STEP1_LIMIT}")
    # after the first update: recorded beside (a)'s witness (the explicit
    # mode's per-card BatchNorm is another function of the batch)
    out["two cards int8"]["step1_max_param_diff"] = dp_max_diff(
        states1["two cards int8"], states1["one card"])
    for label in ("two cards", "two cards int8"):
        worst = dp_max_diff(states[label], states["one card"])
        out[label]["max_param_diff"] = worst
        check(np.isfinite(worst), f"(f) {label}: non-finite parameters")
    out["order_witness"] = a_res.get("order_witness")
    log("  (f) distinct cards: " + json.dumps(out))
    return out


def phase_data_parallel(torch, np, _build):
    """Phase 18: (a)-(c) the trainer's modes over a one-card mesh on
    ResNet-50 (the default mesh's placement, int8 with error feedback,
    ZeRO; the last two also captured) and the summation-order witness,
    (d) the legacy API over two contexts of one card, (e) the kvstore over
    CUDA members, (f) distinct cards where there are two; builds no
    kernel."""
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    counts = {"softmax_rows": 0, "fused_update": 0}
    out = {}
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        # two trainers' runs are held bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        out["trainers"] = dp_trainers(torch, np, counts)
        out["legacy"] = dp_legacy(torch, np, counts)
        out["kvstore"] = dp_kvstore(torch, np)
        out["distinct_cards"] = dp_distinct_cards(torch, np, counts,
                                                  out["trainers"])
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
        _build._compile = compile_
    check(not built, f"phase 18 built kernels: {built}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log("  data parallelism: " + json.dumps(out))
    return counts, out


# ---------------------------------------------------------------------------
# Phase 19: input records into fit, the deployment predictor, WarpCTC and
# the detector (after phase 18, before the result)
# ---------------------------------------------------------------------------

# (a) 512 synthetic images (32x32 noise blown up 8x, so a JPEG codec has
# structure to keep), packed at 256x256 as .raw and .jpg and at 224x224 as
# .raw; phase 7's trainer; pixels scaled by 1/256 (a power of two: the
# iterator's f32 multiply and the host's are the same bits)
REC_IMAGES, REC_PACKED, REC_THREADS = 512, 256, 8
REC_SCALE = 1.0 / 256
# (c) examples/lstm_ocr.py's sizes and optimizer (Adam, lr 0.01)
OCR_SEQ, OCR_HEIGHT, OCR_LABELS, OCR_CLASSES = 20, 16, 4, 11
OCR_HIDDEN, OCR_BATCH, OCR_STEPS = 64, 32, 20
OCR_OPT = {"learning_rate": 0.01}
# the card's and the CPU's losses a step: 8.79e-08 to 1.69e-07 apart on
# an H100 (f32 summation order through 20 Adam steps), while the card's
# Adam with epsilon doubled or beta2 0.9991 moves them by 2.9e-04 and
# 2.9e-05 (PERF.md)
OCR_LOSS_RTOL = 1e-6
# (d) examples/rcnn_detection.py's sizes
DET_IMG, DET_STRIDE, DET_FEAT, DET_K, DET_BATCH = 64, 4, 16, 8, 8
DET_SCALES, DET_RATIOS = (3.0, 5.0), (1.0,)
# the card against the CPU: corners carry the convolutions' summation
# order through exp (up to 63 px); pooled features and heads within 1e-4
DET_TOL = {"rois": (1e-4, 1e-3), "values": (1e-4, 1e-5)}
# (d) ROIPooling at a Fast R-CNN head's size: VGG-16's conv5 map of a
# 600x1000 image (512 x 38 x 63, stride 16), 256 rois, 7x7 bins; the
# one-pass windows alone would be 62 GB
ROI_HEAD = dict(channels=512, height=38, width=63, stride=16, rois=256,
                pooled=7)
ROI_HEAD_PEAK_GIB = 12      # forward and backward, inputs excluded
ROI_HEAD_CHECKED = 4        # rois held against the CPU
# the exported program (K1's plain version, another process's cuDNN
# choices) against the Predictor's K1 path
EXPORT_TOL = (1e-4, 1e-5)


def p19_images(np):
    """``(images [n, 256, 256, 3] uint8, labels)`` from seed 19."""
    rng = np.random.RandomState(19)
    side = REC_PACKED // 8
    small = rng.randint(0, 256, (REC_IMAGES, side, side, 3)).astype(np.uint8)
    imgs = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)
    return imgs, rng.randint(0, CLASSES, REC_IMAGES).astype(np.float32)


def p19_pack(np, recordio, root, imgs, labels, forms):
    """Pack ``imgs`` with an ``.idx`` in each form of ``{name: (fmt,
    crop)}``; returns ``{name: (rec, idx, seconds, bytes)}``."""
    out = {}
    for name, (fmt, crop) in forms.items():
        rec, idx = (os.path.join(root, f"{name}.rec"),
                    os.path.join(root, f"{name}.idx"))
        t0 = time.perf_counter()
        w = recordio.MXIndexedRecordIO(idx, rec, "w")
        for i, img in enumerate(imgs):
            if crop:
                img = img[crop:crop + IMAGE[1], crop:crop + IMAGE[2]]
            w.write_idx(i, recordio.pack_img((0, float(labels[i]), i, 0),
                                             img, quality=90, img_fmt=fmt))
        w.close()
        out[name] = (rec, idx, time.perf_counter() - t0,
                     os.path.getsize(rec))
    return out


def p19_engines(recordio, root, packed):
    """(a)'s record engines on the records packed above (through the
    native engine): each engine writes every file's records again (the
    files must be byte for byte equal to the packed ones) and reads every
    file back (the same records), in turns, twice; returns the faster
    turn's seconds of each (a record of the engines' cost, not a claim:
    the phase's time is decoding)."""
    saved = recordio._native
    out = {"write_s": {}, "read_s": {}, "records": 0,
           "bytes": sum(v[3] for v in packed.values())}
    records = {}
    for name, (rec, _, _, _) in packed.items():
        r = recordio.MXRecordIO(rec, "r")
        records[name] = []
        while True:
            item = r.read()
            if item is None:
                break
            records[name].append(item)
        r.close()
    out["records"] = sum(len(v) for v in records.values())
    for _ in range(2):
        for engine in ("native", "python"):
            try:
                if engine == "python":
                    recordio._native = False
                t0 = time.perf_counter()
                for name, items in records.items():
                    w = recordio.MXRecordIO(
                        os.path.join(root, f"{name}.{engine}.rec"), "w")
                    check(w.engine == engine, f"(a) {w.engine} engine "
                          f"opened a file ({engine} asked)")
                    for item in items:
                        w.write(item)
                    w.close()
                wrote = time.perf_counter() - t0
                t0 = time.perf_counter()
                for name, (rec, _, _, _) in packed.items():
                    r = recordio.MXRecordIO(rec, "r")
                    got = []
                    while True:
                        item = r.read()
                        if item is None:
                            break
                        got.append(item)
                    r.close()
                    check(got == records[name], f"(a) the {engine} engine "
                          f"read other records from {name}")
                read = time.perf_counter() - t0
            finally:
                recordio._native = saved
            out["write_s"][engine] = min(out["write_s"].get(engine, wrote),
                                         wrote)
            out["read_s"][engine] = min(out["read_s"].get(engine, read),
                                        read)
            for name, (rec, _, _, _) in packed.items():
                again = os.path.join(root, f"{name}.{engine}.rec")
                with open(rec, "rb") as a, open(again, "rb") as b:
                    check(a.read() == b.read(), f"(a) the {engine} engine "
                          f"wrote {name} otherwise than the packing")
                os.unlink(again)
    return out


def p19_native_engine(recordio, _build, root):
    """The native record engine, or the phase fails with the compiler's
    output; with the seconds of one more g++ build of its source and
    flags (the engine itself was built at its first use, maybe earlier
    in the run)."""
    if recordio.engine() != "native":
        info = _build.build_recordio()    # raises with g++'s output
        check(False, f"the native record engine built ({info['lib']}) "
              "but did not load")
    info = _build.build_recordio()
    t0 = time.perf_counter()
    subprocess.run(["g++", *_build.RECORDIO_FLAGS, "-o",
                    os.path.join(root, "librecordio.so"),
                    str(_build.CSRC_DIR / "recordio.cc")],
                   check=True, capture_output=True, timeout=300)
    return dict(info, gxx_s=time.perf_counter() - t0)


def p19_iter_rate(image_io, rec, idx):
    """Images/s of ``ImageRecordIter`` alone over one epoch: shuffle, a
    random 224 crop, mirror, ``REC_THREADS`` decode threads."""
    it = image_io.ImageRecordIter(
        rec, IMAGE, BATCH, path_imgidx=idx, shuffle=True, rand_crop=True,
        rand_mirror=True, scale=REC_SCALE, preprocess_threads=REC_THREADS)
    t0 = time.perf_counter()
    n = sum(b.data[0].shape[0] - b.pad for b in it)
    check(n == REC_IMAGES, f"the iterator yielded {n} images")
    return n / (time.perf_counter() - t0)


class PrefetchWaits:
    """Times every ``DevicePrefetchIter.next`` (the host's wait for the
    next placed batch) while installed."""

    def __init__(self, io):
        self.io, self.waits, self._real = io, [], None

    def __enter__(self):
        real = self._real = self.io.DevicePrefetchIter.next
        waits = self.waits

        def timed(it):
            t0 = time.perf_counter()
            try:
                return real(it)
            finally:
                waits.append(time.perf_counter() - t0)

        self.io.DevicePrefetchIter.next = timed
        return self

    def __exit__(self, *exc):
        self.io.DevicePrefetchIter.next = self._real


def p19_fit(torch, np, io, tr, data_iter, label, counter=None):
    """One epoch of ``tr.fit`` over ``data_iter``: ms a batch (CUDA events
    after each batch), images/s, the share of the epoch the host waited on
    the prefetcher (all batches, and from the second on); with
    ``counter`` the synchronizing calls of the steps after the first."""
    events = []

    def batch_end(param):
        events.append(record_event(torch))
        if counter is not None and param.nbatch == 1:
            counter.start()

    with PrefetchWaits(io) as pw:
        t0 = time.perf_counter()
        try:
            tr.fit(data_iter, num_epoch=1, batch_end_callback=batch_end)
        finally:
            syncs = counter.stop() if counter is not None else None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = event_ms(torch, events, len(events) + 1)
    med = float(np.median(ms)) if ms else float("nan")
    waits = pw.waits[:len(events)]
    return {"label": label, "batches": len(events), "ms": ms,
            "median_ms": med, "images_per_s": BATCH / med * 1e3,
            "epoch_s": wall, "epoch_images_per_s": len(events) * BATCH / wall,
            "prefetch_wait_share": sum(waits) / wall,
            "prefetch_wait_share_after_first": sum(waits[1:]) / wall,
            "first_wait_s": waits[0] if waits else None,
            "syncs": syncs, "sync_sites": (counter.sites if counter
                                           else None)}


def p19_records(torch, np, nn_ops, fu, tmp, cv2_ok, launches):
    """(a) records into ResNet-50's fit; returns the trainer, its symbol
    and the numbers."""
    from mxnet_tpu_torch import image_io, io, models, recordio
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.parallel.trainer import _AsyncMetric

    from mxnet_tpu_torch import _build
    out = {"cv2": cv2_ok}
    imgs, labels = p19_images(np)
    forms = {"raw": (".raw", 0), "raw224": (".raw", 16)}
    if cv2_ok:
        forms["jpg"] = (".jpg", 0)
    built = p19_native_engine(recordio, _build, tmp)
    packed = p19_pack(np, recordio, tmp, imgs, labels, forms)
    out["packed"] = {k: {"seconds": v[2], "bytes": v[3]}
                     for k, v in packed.items()}
    out["engines"] = p19_engines(recordio, tmp, packed)
    out["engines"].update(engine=recordio.engine(), library=str(
        built["lib"]), build_s=built["seconds"], cached=built["cached"],
        gxx_s=built["gxx_s"])
    eng = out["engines"]
    log(f"  (a) record engines on {card_line()}: packed through the "
        f"{eng['engine']} engine ({eng['library']}, "
        + ("built at its first use before this phase"
           if eng["cached"] else f"built in {eng['build_s']:.2f} s")
        + f"; g++ on its source {eng['gxx_s']:.2f} s); "
        f"{eng['records']} records, {eng['bytes']} bytes (page cache "
        f"warm): write native {eng['write_s']['native']:.4f} s / python "
        f"{eng['write_s']['python']:.4f} s, read native "
        f"{eng['read_s']['native']:.4f} s / python "
        f"{eng['read_s']['python']:.4f} s")
    out["iterator_images_per_s"] = {
        k: p19_iter_rate(image_io, *packed[k][:2])
        for k in ("raw", "jpg") if k in packed}
    log(f"  (a) packed {REC_IMAGES} images: "
        + ", ".join(f"{k} {v['bytes']} bytes in {v['seconds']:.2f} s"
                    for k, v in out["packed"].items())
        + "; the iterator alone (shuffle, crop, mirror, "
        f"{REC_THREADS} threads): "
        + ", ".join(f"{k} {v:.1f} images/s"
                    for k, v in out["iterator_images_per_s"].items()))

    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=19)

    def trainer():
        tr = ShardedTrainer(sym, optimizer="sgd",
                            optimizer_params=dict(TRAIN_OPT), guard=True,
                            clip_global_norm=CLIP, device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=args, aux_params=aux)

    tr_rec, tr_nd = trainer(), trainer()
    check(tr_rec._fused_route == "hopper", "the trainer did not take K2's "
          f"hopper route ({tr_rec._fused_route})")
    # the same images as host arrays, as the iterator makes them (NCHW in
    # memory: a channels-last array would take other convolution kernels)
    x = np.ascontiguousarray(imgs[:, 16:16 + IMAGE[1], 16:16 + IMAGE[2]]
                             .transpose(0, 3, 1, 2), np.float32)
    x *= REC_SCALE
    counter = SyncCounter(torch, [
        (_AsyncMetric, "_drain"), (tr_rec, "resilience_stats"),
        (tr_rec, "get_params"), (tr_rec, "score"),
        (tr_rec, "_sentinel_poll")])
    reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
    raw_iter = image_io.ImageRecordIter(
        packed["raw224"][0], IMAGE, BATCH, path_imgidx=packed["raw224"][1],
        scale=REC_SCALE, preprocess_threads=REC_THREADS)
    runs = [p19_fit(torch, np, io, tr_rec, raw_iter, "raw records",
                    counter)]
    runs.append(p19_fit(torch, np, io, tr_nd, io.NDArrayIter(
        x, labels, batch_size=BATCH), "NDArrayIter"))
    diff = state_diff(torch, tr_rec, tr_nd)
    check(not diff, f"fit over raw records and over an NDArrayIter of the "
          f"same arrays differ in {diff}")
    check(runs[0]["syncs"]["other threads"] == 0,
          f"the prefetch worker made {runs[0]['syncs']['other threads']} "
          f"synchronizing calls ({counter.sites.get('other threads')})")
    # steps 2-8 against 7 bare steps on placed batches, as phase 13
    placed = [tr_nd.place_batch({"data": x[i * BATCH:(i + 1) * BATCH],
                                 "softmax_label": labels[i * BATCH:
                                                         (i + 1) * BATCH]})
              for i in range(1, REC_IMAGES // BATCH)]
    torch.cuda.synchronize()
    bare = SyncCounter(torch)
    # the bare steps are not the main path's: their launches leave the
    # counts
    saved = [(k, k.launches, dict(k.launches_by_form))
             for k in (nn_ops.softmax_rows, fu.fused_update)]
    bare.start()
    try:
        for b in placed:
            tr_nd.step(b)
    finally:
        bare_syncs = bare.stop()
    for k, n, forms in saved:
        k.launches, k.launches_by_form = n, forms
    del placed
    check(runs[0]["syncs"]["outside"] <= bare_syncs["outside"],
          f"steps 2-8 of the record fit made {runs[0]['syncs']['outside']} "
          f"synchronizing calls outside fit's drains "
          f"({counter.sites.get('outside')}); bare steps "
          f"{bare_syncs['outside']}")
    out["bare_syncs"] = bare_syncs
    del tr_nd
    if cv2_ok:
        jpg_iter = image_io.ImageRecordIter(
            packed["jpg"][0], IMAGE, BATCH, path_imgidx=packed["jpg"][1],
            shuffle=True, rand_crop=True, rand_mirror=True, scale=REC_SCALE,
            preprocess_threads=REC_THREADS)
        runs.append(p19_fit(torch, np, io, tr_rec, jpg_iter,
                            "jpg records, augmented"))
    else:
        log("  (a) cv2 does not import here: the .jpg iterator and its fit "
            "did not run (.raw records only)")
    steps = sum(r["batches"] for r in runs)
    k1, k1_forms = (nn_ops.softmax_rows.launches,
                    dict(nn_ops.softmax_rows.launches_by_form))
    k2, k2_forms = (fu.fused_update.launches,
                    dict(fu.fused_update.launches_by_form))
    check(k1 == steps and k1_forms["warp"] == k1,
          f"K1 launched {k1} times ({k1_forms}) in {steps} steps")
    check(k2 == steps and k2_forms["hopper"] == k2,
          f"K2 launched {k2} times ({k2_forms}) in {steps} steps")
    launches["softmax_rows"] += k1
    launches["fused_update"] += k2
    for r in runs:
        log(f"  (a) fit over {r['label']}: {r['median_ms']:.2f} ms a batch, "
            f"{r['images_per_s']:.1f} images/s (events), "
            f"{r['epoch_images_per_s']:.1f} images/s over the epoch "
            f"({r['epoch_s']:.2f} s), prefetch wait "
            f"{100 * r['prefetch_wait_share']:.1f} % of the epoch "
            f"({100 * r['prefetch_wait_share_after_first']:.1f} % after the "
            "first batch)")
    log(f"  (a) raw-record fit bitwise the NDArrayIter fit (weights, "
        f"momentum, moving statistics, guard); K1 {k1} (warp), K2 {k2} "
        f"(hopper); steps 2-8 synchronizing calls {runs[0]['syncs']} "
        f"(bare steps {bare_syncs})")
    out["fits"] = runs
    out["launches"] = {"softmax_rows": k1, "fused_update": k2}
    return tr_rec, sym, x, out


def p19_predictor(torch, np, nn_ops, _build, tr, sym, x, tmp, launches):
    """(b) the trained weights through ``predictor.create`` (legacy prefix
    and manifest directory), an executor, and an exported artifact served
    by a process without the port."""
    import tempfile

    from mxnet_tpu_torch import checkpoint, model, predictor
    from mxnet_tpu_torch.context import cpu, gpu

    out = {}
    ctx = gpu(0) if DEVICE == "cuda" else cpu()
    # create's default context is the card
    where = {} if DEVICE == "cuda" else {"ctx": ctx}
    arg, aux = tr.get_params()
    prefix = os.path.join(tmp, "r50")
    model.save_checkpoint(prefix, 1, sym, arg, aux)
    mgr = checkpoint.CheckpointManager(os.path.join(tmp, "r50-manager"))
    mgr.save_model(1, sym, arg, aux)
    mgr.close()
    shapes = {"data": (BATCH,) + IMAGE}
    batch = x[:BATCH]
    ex = sym.simple_bind(ctx, grad_req="null", **shapes,
                         softmax_label=(BATCH,))
    ex.copy_params_from(arg, aux)
    reset_train_counts(nn_ops.softmax_rows)
    ref = ex.forward(is_train=False, data=batch)[0].asnumpy()
    check(nn_ops.softmax_rows.launches == 1,
          f"the executor's forward launched K1 "
          f"{nn_ops.softmax_rows.launches} times")
    launches["softmax_rows"] += 1
    preds = {"legacy": predictor.create(prefix, 1, shapes, **where),
             "manifest": predictor.create(os.path.join(tmp, "r50-manager"),
                                          None, shapes, **where)}
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    try:
        for kind, p in preds.items():
            check([i["source"] for i in p.aot_info] == ["capture"],
                  f"{kind} predictor's warmup: {p.aot_info}")
            reset_train_counts(nn_ops.softmax_rows)
            got = p.predict(data=batch)[0]
            k1 = dict(nn_ops.softmax_rows.launches_by_form)
            check(nn_ops.softmax_rows.launches == 1 and k1["warp"] == 1,
                  f"{kind} predictor's forward launched K1 {k1}")
            check(got.tobytes() == ref.tobytes(),
                  f"the {kind} predictor's outputs are not bitwise the "
                  f"executor's (max abs diff {np.abs(got - ref).max()})")
            launches["softmax_rows"] += 1
        pred = preds["legacy"]

        def fwd_ms(run, reps=10):
            ms = []
            for _ in range(reps):
                a = record_event(torch)
                run()
                b = record_event(torch)
                b.synchronize()
                ms.append(a.elapsed_time(b))
            return float(np.median(ms)), ms

        reset_train_counts(nn_ops.softmax_rows)
        out["predictor_forward_ms"], out["predictor_ms"] = fwd_ms(
            pred.forward)
        out["executor_forward_ms"], out["executor_ms"] = fwd_ms(
            lambda: ex.forward(is_train=False))
        check(nn_ops.softmax_rows.launches == 20,
              f"20 timed forwards launched K1 "
              f"{nn_ops.softmax_rows.launches} times")
        launches["softmax_rows"] += 20
    finally:
        _build._compile = compile_
    check(not built, f"the predictors built kernels after warmup: {built}")
    log(f"  (b) create from a legacy prefix and a manifest directory: "
        "outputs bitwise the executor's, one K1 launch (warp) a forward, "
        "captured programs; forward median "
        f"{out['predictor_forward_ms']:.3f} ms (Predictor, replayed) and "
        f"{out['executor_forward_ms']:.3f} ms (executor, eager)")

    # the exported artifact, served by a process that cannot import the
    # port; it, its input and the Predictor's output stay for phase 27's
    # C process (P19_EXPORT)
    keep = tempfile.mkdtemp(prefix="p19-export-")
    atexit.register(shutil.rmtree, keep, True)
    art = os.path.join(keep, "r50.mxtpt")
    t0 = time.perf_counter()
    predictor.export_model(sym, arg, aux, shapes, art)
    out["export_s"] = time.perf_counter() - t0
    out["artifact_bytes"] = os.path.getsize(art)
    xp, yp, mp = (os.path.join(tmp, f) for f in ("x.npy", "y.npy",
                                                  "ms.json"))
    np.save(xp, batch)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", P19_SERVE.format(
        art=art, x=xp, y=yp, ms=mp)], capture_output=True, text=True,
        timeout=300, cwd=tmp, env=env)
    check(proc.returncode == 0,
          f"serving the artifact without the port failed: {proc.stderr}")
    served = np.load(yp)
    with open(mp) as f:
        out["exported"] = json.load(f)
    err = float(np.abs(served - ref).max())
    check(np.allclose(served, ref, rtol=EXPORT_TOL[0], atol=EXPORT_TOL[1]),
          f"the exported program's outputs differ from the Predictor's by "
          f"{err}")
    out["exported_max_abs_err"] = err
    batch.tofile(os.path.join(keep, "x.bin"))
    P19_EXPORT.update(artifact=art, x=os.path.join(keep, "x.bin"), ref=ref,
                      python_ms=out["exported"]["median_ms"])
    log(f"  (b) export_model: {out['artifact_bytes']} bytes in "
        f"{out['export_s']:.2f} s (traced on the CPU); served by a process "
        f"without the port on {out['exported']['device']}: forward median "
        f"{out['exported']['median_ms']:.3f} ms, max abs diff {err:.3g} "
        f"from the Predictor; tensors held {out['exported']['tensor_bytes']}")
    return out


# phase 19 (b)'s exported ResNet-50 for phase 27 (c): the artifact's and
# the input's paths (float32 bytes), the Predictor's output and the
# Python-served median forward ms
P19_EXPORT = {}

# a process that imports torch and not the port serves the artifact on
# the card, with the script's numerics settings (no TF32, deterministic
# cuDNN)
P19_SERVE = """
import sys
sys.modules["mxnet_tpu_torch"] = None
import io, json, struct
import numpy as np
import torch
from torch.export.passes import move_to_device_pass
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
with open({art!r}, "rb") as f:
    assert f.read(9) == b"MXTPTEXP1"
    (hlen,) = struct.unpack("<i", f.read(4))
    meta = json.loads(f.read(hlen).decode())
    program = torch.export.load(io.BytesIO(f.read()))
held = {{kind: sum(t.numel() * t.element_size() for t in table.values())
        for kind, table in (("state_dict", program.state_dict),
                            ("constants", program.constants))}}
module = move_to_device_pass(program, "cuda").module()
x = torch.from_numpy(np.load({x!r})).cuda()
ms = []
with torch.no_grad():
    for _ in range(11):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        (y,) = module(x)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
np.save({y!r}, y.cpu().numpy())
with open({ms!r}, "w") as f:
    json.dump({{"device": torch.cuda.get_device_name(0), "ms": ms,
               "median_ms": sorted(ms[1:])[5], "meta": meta,
               "tensor_bytes": held}}, f)
"""


def ocr_net(S):
    """``examples/lstm_ocr.py``'s ``lstm_ctc_unroll``."""
    i2h_w, i2h_b = S.Variable("i2h_weight"), S.Variable("i2h_bias")
    h2h_w, h2h_b = S.Variable("h2h_weight"), S.Variable("h2h_bias")
    cls_w, cls_b = S.Variable("cls_weight"), S.Variable("cls_bias")
    c, h = S.Variable("init_c"), S.Variable("init_h")
    cols = S.SliceChannel(data=S.Variable("data"), num_outputs=OCR_SEQ,
                          axis=1, squeeze_axis=True, name="cols")
    outs = []
    for t in range(OCR_SEQ):
        i2h = S.FullyConnected(data=cols[t], num_hidden=OCR_HIDDEN * 4,
                               weight=i2h_w, bias=i2h_b, name=f"t{t}_i2h")
        h2h = S.FullyConnected(data=h, num_hidden=OCR_HIDDEN * 4,
                               weight=h2h_w, bias=h2h_b, name=f"t{t}_h2h")
        gates = S.SliceChannel(data=i2h + h2h, num_outputs=4,
                               name=f"t{t}_gates")
        in_g = S.Activation(data=gates[0], act_type="sigmoid")
        in_t = S.Activation(data=gates[1], act_type="tanh")
        f_g = S.Activation(data=gates[2], act_type="sigmoid")
        o_g = S.Activation(data=gates[3], act_type="sigmoid")
        c = (f_g * c) + (in_g * in_t)
        h = o_g * S.Activation(data=c, act_type="tanh")
        fc = S.FullyConnected(data=h, num_hidden=OCR_CLASSES, weight=cls_w,
                              bias=cls_b, name=f"t{t}_cls")
        outs.append(S.expand_dims(fc, axis=0))
    logits = S.Reshape(data=S.Concat(*outs, dim=0, name="tconcat"),
                       shape=(-1, OCR_CLASSES))
    return S.WarpCTC(data=logits, label=S.Variable("label"),
                     input_length=OCR_SEQ, label_length=OCR_LABELS,
                     name="ctc")


def ocr_batches(np, n):
    """``examples/lstm_ocr.py``'s ``gen_captcha`` batches from seed 0."""
    glyphs = np.zeros((10, OCR_HEIGHT, 4), np.float32)
    for d in range(10):
        glyphs[d, d:d + 3, :] = 1.0
        glyphs[d, (3 * d + 1) % OCR_HEIGHT, 1:3] = 1.0
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        digits = rng.randint(0, 10, (OCR_BATCH, OCR_LABELS))
        img = np.zeros((OCR_BATCH, OCR_SEQ, OCR_HEIGHT), np.float32)
        for b in range(OCR_BATCH):
            for i, d in enumerate(digits[b]):
                img[b, 1 + i * 5:5 + i * 5] += glyphs[d].T
        img += rng.rand(OCR_BATCH, OCR_SEQ, OCR_HEIGHT).astype(
            np.float32) * 0.2
        out.append((img, (digits + 1).astype(np.float32)))
    return out


def p19_ctc(torch, np, fu, launches):
    """(c) the OCR net trained on the card and on the CPU from the same
    weights and batches; the op's gradient on the card against the CPU;
    ``F.ctc_loss`` timed beside the recursion."""
    from mxnet_tpu_torch import name as name_mod, symbol as S
    from mxnet_tpu_torch.ops import ctc, registry
    from mxnet_tpu_torch.parallel import ShardedTrainer

    with name_mod.NameManager():
        net = ocr_net(S)
    data_shapes = {"data": (OCR_BATCH, OCR_SEQ, OCR_HEIGHT),
                   "init_c": (OCR_BATCH, OCR_HIDDEN),
                   "init_h": (OCR_BATCH, OCR_HIDDEN)}
    label_shapes = {"label": (OCR_BATCH * OCR_LABELS,)}
    shapes, _, aux_shapes = net.infer_shape(**data_shapes, **label_shapes)
    args = {n: v for n, v in init_numpy(np, net, shapes, aux_shapes,
                                        seed=0)[0].items()
            if n not in data_shapes and n not in label_shapes}
    trainers = {}
    for dev in (DEVICE, "cpu"):
        tr = ShardedTrainer(net, optimizer="adam",
                            optimizer_params=dict(OCR_OPT), device=dev)
        trainers[dev] = tr.bind(data_shapes=data_shapes,
                                label_shapes=label_shapes, arg_params=args)
    zeros = np.zeros((OCR_BATCH, OCR_HIDDEN), np.float32)
    losses = {dev: [] for dev in trainers}
    reset_train_counts(fu.fused_update)
    t0 = time.perf_counter()
    for img, lab in ocr_batches(np, OCR_STEPS):
        batch = {"data": img, "init_c": zeros, "init_h": zeros,
                 "label": lab.reshape(-1)}
        labels = torch.from_numpy(lab).long()
        for dev, tr in trainers.items():
            prob = tr.step(batch)[0].detach().float().cpu()
            logp = torch.log(prob).reshape(OCR_SEQ, OCR_BATCH, OCR_CLASSES)
            losses[dev].append(float(ctc.ctc_loss(logp, labels).mean()))
    seconds = time.perf_counter() - t0
    k2 = fu.fused_update.launches
    check(k2 == OCR_STEPS, f"K2 launched {k2} times in {OCR_STEPS} OCR steps")
    launches["fused_update"] += k2
    card, host = np.asarray(losses[DEVICE]), np.asarray(losses["cpu"])
    rel = float(np.max(np.abs(card - host) / np.abs(host)))
    check(rel <= OCR_LOSS_RTOL, f"OCR losses on the card {card.tolist()} "
          f"and on the CPU {host.tolist()} differ by {rel} (relative)")
    check(card[-1] < card[0], f"the OCR loss did not fall: {card.tolist()}")

    # the op's forward and gradient at the net's shapes, card against CPU
    rng = np.random.RandomState(1)
    tb = OCR_SEQ * OCR_BATCH
    data = torch.from_numpy(rng.randn(tb, OCR_CLASSES).astype(np.float32))
    label = torch.from_numpy(ocr_batches(np, 1)[0][1].reshape(-1))
    op = registry.get_op("WarpCTC")
    params = op.parse_params({"input_length": OCR_SEQ,
                              "label_length": OCR_LABELS})
    got = []
    for dev in ("cpu", DEVICE):
        d = data.to(dev, copy=True).requires_grad_()
        out = op.forward(registry.OpContext(), params, d, label.to(dev))
        out.backward(torch.ones_like(out))
        got.append((out.detach().cpu(), d.grad.cpu()))
    grad_err = float((got[1][1] - got[0][1]).abs().max())
    prob_err = float((got[1][0] - got[0][0]).abs().max())
    check(grad_err <= 1e-5 * float(got[0][1].abs().max())
          and prob_err <= TOL["float32"],
          f"WarpCTC on the card: softmax off by {prob_err}, gradient by "
          f"{grad_err} from the CPU")

    # the recursion (forward and backward) beside F.ctc_loss: a yardstick
    logits = torch.from_numpy(rng.randn(OCR_SEQ, OCR_BATCH, OCR_CLASSES)
                              .astype(np.float32)).to(DEVICE)
    lab = label.reshape(OCR_BATCH, OCR_LABELS).to(DEVICE).long()
    lens_in = torch.full((OCR_BATCH,), OCR_SEQ, dtype=torch.long,
                         device=DEVICE)
    lens_lab = (lab != 0).sum(1)

    def recursion():
        lg = logits.detach().requires_grad_()
        ctc.ctc_loss(lg, lab).sum().backward()

    def library():
        lg = logits.detach().requires_grad_()
        torch.nn.functional.ctc_loss(
            torch.log_softmax(lg, -1), lab, lens_in, lens_lab,
            reduction="sum", zero_infinity=False).backward()

    times = {"recursion_ms": time_ms(torch, recursion, reps=20,
                                     hide_host=False),
             "f_ctc_loss_ms": time_ms(torch, library, reps=20,
                                      hide_host=False)}
    log(f"  (c) OCR net ({OCR_SEQ} columns of {OCR_HEIGHT}, {OCR_LABELS} "
        f"labels, {OCR_CLASSES} classes, {OCR_HIDDEN} hidden, batch "
        f"{OCR_BATCH}): {OCR_STEPS} Adam steps on the card and the CPU in "
        f"{seconds:.1f} s, losses {card[0]:.4f} -> {card[-1]:.4f}, max "
        f"relative difference {rel:.3g}; WarpCTC's softmax {prob_err:.3g} "
        f"and gradient {grad_err:.3g} from the CPU; K2 {k2}; loss and "
        f"gradient {times['recursion_ms']:.3f} ms (recursion) against "
        f"{times['f_ctc_loss_ms']:.3f} ms (F.ctc_loss, a yardstick)")
    return {"losses_card": card.tolist(), "losses_cpu": host.tolist(),
            "loss_max_rel_diff": rel, "softmax_err": prob_err,
            "grad_err": grad_err, "seconds": seconds, **times}


def detector_net(S, b):
    """``examples/rcnn_detection.py``'s ``build_detector`` (its pooled
    features added to the outputs)."""
    a = len(DET_SCALES) * len(DET_RATIOS)
    f = S.Variable("data")
    for name, nf, k, s, p in (("c1", 16, 3, 2, 1), ("c2", 32, 3, 2, 1),
                              ("c3", 32, 3, 1, 1)):
        f = S.Activation(data=S.Convolution(
            data=f, num_filter=nf, kernel=(k, k), stride=(s, s),
            pad=(p, p), name=name), act_type="relu")
    feat = f
    r = S.Activation(data=S.Convolution(
        data=feat, num_filter=32, kernel=(5, 5), stride=(1, 1), pad=(2, 2),
        name="rpn_conv"), act_type="relu")
    cls = S.Convolution(data=r, num_filter=2 * a, kernel=(1, 1),
                        name="rpn_cls")
    bbox = S.Convolution(data=r, num_filter=4 * a, kernel=(1, 1),
                         name="rpn_bbox")
    cls_prob = S.Reshape(
        data=S.SoftmaxActivation(data=S.Reshape(
            data=cls, shape=(b, 2, a * DET_FEAT * DET_FEAT)),
            mode="channel"),
        shape=(b, 2 * a, DET_FEAT, DET_FEAT))
    rois = S.Proposal(cls_prob=cls_prob, bbox_pred=bbox,
                      im_info=S.Variable("im_info"),
                      feature_stride=DET_STRIDE, scales=DET_SCALES,
                      ratios=DET_RATIOS, rpn_pre_nms_top_n=128,
                      rpn_post_nms_top_n=DET_K, threshold=0.7,
                      rpn_min_size=4, name="proposal")
    pooled = S.ROIPooling(data=feat, rois=rois, pooled_size=(4, 4),
                          spatial_scale=1.0 / DET_STRIDE, name="roi_pool")
    fc = S.Activation(data=S.FullyConnected(
        data=S.Flatten(data=pooled), num_hidden=32, name="rcls_fc"),
        act_type="relu")
    head = S.FullyConnected(data=fc, num_hidden=2, name="rcls")
    out = S.SoftmaxOutput(data=head, label=S.Variable("roi_label"),
                          name="rcnn_cls")
    return S.Group([out, rois, pooled])


def p19_detection(torch, np, nn_ops, launches):
    """(d) the detector's forward and backward on the card against the
    CPU, and ``Proposal`` alone: the CPU's selection, no synchronizing
    call."""
    from mxnet_tpu_torch import name as name_mod, symbol as S
    from mxnet_tpu_torch.context import cpu, gpu
    from mxnet_tpu_torch.ops import registry

    with name_mod.NameManager():
        net = detector_net(S, DET_BATCH)
    shapes = {"data": (DET_BATCH, 1, DET_IMG, DET_IMG),
              "im_info": (DET_BATCH, 3), "roi_label": (DET_BATCH * DET_K,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(4)
    args = {n: (0.2 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes}
    x = rng.rand(*shapes["data"]).astype(np.float32)
    info = np.array([[DET_IMG, DET_IMG, 1.0]] * DET_BATCH, np.float32)
    roi_label = (np.arange(DET_BATCH * DET_K) % 2).astype(np.float32)
    res = {}
    reset_train_counts(nn_ops.softmax_rows)
    for dev, ctx in ((DEVICE, gpu(0) if DEVICE == "cuda" else cpu()),
                     ("cpu", cpu())):
        ex = net.simple_bind(ctx, grad_req="write", **shapes)
        ex.copy_params_from(args)
        ex.forward(is_train=True, data=x, im_info=info, roi_label=roi_label)
        ex.backward()
        res[dev] = [o.asnumpy() for o in ex.outputs] + [
            ex.grad_dict[n].asnumpy() for n in ("rcls_fc_weight",
                                                "c3_weight")]
    k1 = nn_ops.softmax_rows.launches
    check(k1 == 1, f"the detector's forward launched K1 {k1} times")
    launches["softmax_rows"] += k1
    names = ("head", "rois", "pooled", "rcls_fc grad", "c3 grad")
    errs = {}
    for name, card, host in zip(names, res[DEVICE], res["cpu"]):
        rtol, atol = DET_TOL["rois" if name == "rois" else "values"]
        if name.endswith("grad"):
            atol = atol * float(np.abs(host).max())
        errs[name] = float(np.abs(card - host).max())
        check(np.allclose(card, host, rtol=rtol, atol=atol),
              f"detector {name} on the card differs from the CPU by "
              f"{errs[name]}")
    check(np.abs(res[DEVICE][4]).max() > 0, "no gradient reached the "
          "backbone through ROIPooling")

    # Proposal alone on the card's RPN output: the CPU's selection on the
    # same inputs, and no synchronizing call once its anchors are placed
    a = len(DET_SCALES) * len(DET_RATIOS)
    cls_prob = torch.softmax(torch.from_numpy(rng.randn(
        DET_BATCH, 2, a * DET_FEAT * DET_FEAT).astype(np.float32)), 1)
    inputs = [cls_prob.reshape(DET_BATCH, 2 * a, DET_FEAT, DET_FEAT),
              torch.from_numpy((0.5 * rng.randn(
                  DET_BATCH, 4 * a, DET_FEAT, DET_FEAT)).astype(np.float32)),
              torch.from_numpy(info)]
    op = registry.get_op("Proposal")
    params = op.parse_params(dict(
        feature_stride=DET_STRIDE, scales=DET_SCALES, ratios=DET_RATIOS,
        rpn_pre_nms_top_n=128, rpn_post_nms_top_n=DET_K, threshold=0.7,
        rpn_min_size=4, output_score=True))
    want = op.forward(registry.OpContext(), params, *inputs)
    on_card = [t.to(DEVICE) for t in inputs]
    op.forward(registry.OpContext(), params, *on_card)
    torch.cuda.synchronize()
    counter = SyncCounter(torch)
    counter.start()
    try:
        got = op.forward(registry.OpContext(), params, *on_card)
    finally:
        syncs = counter.stop()
    check(sum(syncs.values()) == 0,
          f"Proposal made synchronizing calls: {counter.sites}")
    check(torch.equal(got[1].cpu(), want[1]),
          "Proposal's scores on the card are not the CPU's selection")
    box_err = float((got[0].cpu() - want[0]).abs().max())
    check(box_err <= 1e-5 * max(1.0, float(want[0].abs().max())),
          f"Proposal's boxes on the card differ from the CPU's by {box_err}")
    log(f"  (d) detector ({DET_IMG}x{DET_IMG}, stride {DET_STRIDE}, "
        f"{DET_K} proposals an image, batch {DET_BATCH}) on the card "
        f"against the CPU, max abs diff: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; K1 {k1}; Proposal alone: the CPU's selection, boxes within "
        f"{box_err:.3g}, no synchronizing call")
    return {"max_abs_diff": errs, "proposal_box_err": box_err}


def p19_roi_head(torch, np):
    """(d) ``ROIPooling`` forward and backward on the card at a Fast R-CNN
    head's size: the peak memory above the inputs, ms, and the first rois'
    values and gradient against the CPU."""
    from mxnet_tpu_torch.ops import nn_ops, registry

    c, h, w = ROI_HEAD["channels"], ROI_HEAD["height"], ROI_HEAD["width"]
    n, ph, st = ROI_HEAD["rois"], ROI_HEAD["pooled"], ROI_HEAD["stride"]
    rng = np.random.RandomState(16)
    data = rng.rand(1, c, h, w).astype(np.float32)
    # proposals anywhere in the image, 16 to 400 pixels a side
    lo = rng.uniform(0, 1, (n, 2)) * [w * st, h * st]
    hi = np.minimum(lo + rng.uniform(16, 400, (n, 2)),
                    [w * st - 1, h * st - 1])
    rois = np.concatenate([np.zeros((n, 1)), lo, hi], 1).astype(np.float32)
    g = rng.rand(n, c, ph, ph).astype(np.float32)
    op = registry.get_op("ROIPooling")
    params = op.parse_params({"pooled_size": (ph, ph),
                              "spatial_scale": 1.0 / st})
    ctx = registry.OpContext()
    d = torch.from_numpy(data).to(DEVICE).requires_grad_()
    r, gd = torch.from_numpy(rois).to(DEVICE), torch.from_numpy(g).to(DEVICE)

    def forward():
        with torch.no_grad():
            return op.forward(ctx, params, d, r)

    def forward_backward():
        d.grad = None
        op.forward(ctx, params, d, r).backward(gd)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    forward_backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(peak <= ROI_HEAD_PEAK_GIB,
          f"ROIPooling at the head's size took {peak:.2f} GiB on the card")
    got = forward().cpu()
    k = ROI_HEAD_CHECKED
    dc = torch.from_numpy(data).requires_grad_()
    want = op.forward(ctx, params, dc, torch.from_numpy(rois[:k]))
    want.backward(torch.from_numpy(g[:k]))
    check(torch.equal(got[:k], want.detach()),
          f"ROIPooling's first {k} rois on the card are not the CPU's")
    dk = d.detach().clone().requires_grad_()
    op.forward(ctx, params, dk, r[:k]).backward(gd[:k])
    # the card adds overlapping rois' shares by atomics, in another order
    grad_err = float((dk.grad.cpu() - dc.grad).abs().max())
    check(grad_err <= 1e-6 * float(dc.grad.abs().max()),
          f"ROIPooling's gradient over {k} rois on the card is "
          f"{grad_err} from the CPU's")
    one_pass = n * c * ph * ph * h * w * 4
    step = max(1, nn_ops.ROI_POOL_CHUNK_ELEMS // (c * ph * ph * h * w))
    out = {"peak_gib": peak, "one_pass_window_bytes": one_pass,
           "rois_a_chunk": step, "grad_err": grad_err,
           "forward_ms": time_ms(torch, forward, reps=5, hide_host=False),
           "forward_backward_ms": time_ms(torch, forward_backward, reps=5,
                                          hide_host=False)}
    log(f"  (d) ROIPooling at a Fast R-CNN head ({n} rois x {c} channels "
        f"x {ph}x{ph} bins over {h}x{w}; one-pass windows {one_pass} "
        f"bytes): {step} rois a chunk, peak {peak:.2f} GiB above the "
        f"inputs, forward {out['forward_ms']:.3f} ms, forward and backward "
        f"{out['forward_backward_ms']:.3f} ms; the first {k} rois the CPU's "
        f"bits, gradient within {grad_err:.3g}; {card_line()}")
    return out


def phase_records_predictor(torch, np, nn_ops, fu, _build):
    """Phase 19: (a) records into ResNet-50's fit, (b) the predictor and
    the exported artifact, (c) WarpCTC at the OCR example's sizes, (d) the
    detector; returns the K1 and K2 launches of the phase and its
    numbers."""
    import tempfile
    t_phase = time.perf_counter()
    try:
        import cv2  # noqa: F401
        cv2_ok = True
    except ImportError:
        cv2_ok = False
    log(f"  cv2 {'imports' if cv2_ok else 'does not import'} here")
    launches = {"softmax_rows": 0, "fused_update": 0}
    out = {}
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        # two fits are held bit for bit, and cuDNN's default backward is
        # not deterministic
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            tr, sym, x, out["records"] = p19_records(
                torch, np, nn_ops, fu, tmp, cv2_ok, launches)
            out["records"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["predictor"] = p19_predictor(torch, np, nn_ops, _build, tr,
                                             sym, x, tmp, launches)
            out["predictor"]["seconds"] = time.perf_counter() - t0
            del tr, x
        out["ctc"] = p19_ctc(torch, np, fu, launches)
        t0 = time.perf_counter()
        out["detection"] = p19_detection(torch, np, nn_ops, launches)
        out["detection"]["roi_head"] = p19_roi_head(torch, np)
        out["detection"]["seconds"] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log("  records, predictor, ctc, detection: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 20: tensor and model parallelism in one process (after phase 19,
# before the result)
# ---------------------------------------------------------------------------

# (a) group2ctx: outputs within float32 summation order (the blocks and
# head run the same kernels on the same inputs), gradients within this
# share of each gradient's largest magnitude (the embedding's scatter-add
# sums on the host in another order than on the card)
P20_OUT_TOL = 1e-5
P20_GRAD_TOL = 1e-5
P20_STEPS = 3
# (c) two cards: the LM's first heads (bf16 products cut over two cards
# sum their partials in another order) and its first Adam update (a step
# moves a weight by about lr; a gradient near zero whose sign flips moves
# it by 2 lr); the MakeLoss(sum) net's heads and parameters (f32)
P20_TP_HEAD_TOL = 5e-2
P20_TP_STEP1_LIMIT = 2.5 * LM_OPT["learning_rate"]
P20_SUM_TOL = (1e-4, 1e-5)


def p20_sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def p20_kernel_counts(fa):
    return {"flash_attn_fwd": fa.flash_fwd.launches,
            "flash_attn_bwd": fa.flash_bwd.launches}


def p20_add(launches, fa, before):
    for k, v in p20_kernel_counts(fa).items():
        launches[k] += v - before[k]


def p20_lm_groups(mx):
    """Phase 9's LM (``transformer_lm``'s nodes and names, the loss head)
    with the embedding in the ``embed`` group and the blocks and head in
    ``blocks``."""
    from mxnet_tpu_torch.models.transformer import transformer_block
    S = mx.symbol
    with mx.AttrScope(ctx_group="embed"):
        net = S.Embedding(data=S.Variable("data"), input_dim=VOCAB,
                          output_dim=D_MODEL, name="embed")
    with mx.AttrScope(ctx_group="blocks"):
        for i in range(LAYERS):
            net = transformer_block(net, LM_BATCH, LM_SEQ, D_MODEL, HEADS,
                                    f"layer{i}")
        net = S.LayerNorm(data=net, name="final_ln")
        net = S.Reshape(data=net, shape=(-1, D_MODEL))
        net = S.FullyConnected(data=net, num_hidden=VOCAB, name="lm_head")
        label = S.Reshape(data=S.Variable("softmax_label"), shape=(-1,))
        return S.SoftmaxOutput(data=net, label=label, name="softmax",
                               out_mode="loss")


def p20_group2ctx(torch, np, mx, fa, nn_ops, launches):
    """(a) The LM through ``simple_bind`` with the embedding on the host
    and the blocks and head on the card, against the same executor wholly
    on the card: outputs, gradients, crossings, ms a step."""
    sym = p20_lm_groups(mx)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    batch = lm_batch(np, seed=20)
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    host = mx.cpu(0) if DEVICE == "cuda" else mx.cpu(1)
    out = {}
    results = {}
    for label, g2c in (("group2ctx", {"embed": host, "blocks": card}),
                       ("one device", None)):
        ex = sym.simple_bind(ctx=card, group2ctx=g2c, **shapes)
        ex.copy_params_from(args)
        if g2c is not None:
            check(ex.arg_dict["embed_weight"].context == host
                  and ex.grad_dict["embed_weight"].context == host
                  and ex.arg_dict["lm_head_weight"].context == card,
                  "(a) the weights are not on their groups' contexts")
        c0 = nn_ops.cross_device_copy.crossings
        g0 = nn_ops.cross_device_copy.grad_crossings
        times = []
        for step in range(1 + P20_STEPS):
            before = p20_kernel_counts(fa)
            t0 = time.perf_counter()
            ex.forward(is_train=True, **batch)
            ex.backward()
            p20_sync(torch)
            if step:
                times.append((time.perf_counter() - t0) * 1e3)
            if step == 0 and g2c is not None:
                # the main path's run: this executor's first step
                p20_add(launches, fa, before)
        steps = 1 + P20_STEPS
        out[label] = {
            "ms_per_step": float(np.median(times)),
            "crossings_per_step": (nn_ops.cross_device_copy.crossings
                                   - c0) / steps,
            "grad_crossings_per_step": (nn_ops.cross_device_copy
                                        .grad_crossings - g0) / steps}
        results[label] = (ex.outputs[0].data.float().cpu(),
                          {n: g.data.float().cpu()
                           for n, g in ex.grad_dict.items()
                           if n not in ("data", "softmax_label")})
        del ex
    check(out["group2ctx"]["crossings_per_step"] == 1
          and out["group2ctx"]["grad_crossings_per_step"] == 1,
          f"(a) crossings {out['group2ctx']}: expected the embedding's "
          "output once forward and its gradient once back")
    (ho, hg), (ro, rg) = results["group2ctx"], results["one device"]
    check(ho.shape == (LM_BATCH * LM_SEQ,) and torch.isfinite(ho).all(),
          f"(a) heads {tuple(ho.shape)}, finite {bool(torch.isfinite(ho).all())}")
    out_err = float((ho - ro).abs().max())
    scale = max(float(g.abs().max()) for g in rg.values())
    grad_err = max(float((hg[n] - rg[n]).abs().max()) for n in rg) / scale
    out["max_abs_err_outputs"] = out_err
    out["max_err_grads_of_largest"] = grad_err
    check(out_err <= P20_OUT_TOL, f"(a) outputs {out_err} from the one-"
          f"device executor's, over {P20_OUT_TOL}")
    check(grad_err <= P20_GRAD_TOL, f"(a) gradients {grad_err} of the "
          f"step's largest gradient from the one-device executor's, over "
          f"{P20_GRAD_TOL}")
    log(f"  (a) group2ctx: {json.dumps(out)}")
    return out


def p20_trainer(torch, np, sym, args, mesh, rules=None):
    """Phase 9's trainer (bf16, Adam), unfused, over ``mesh``."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    tr = ShardedTrainer(sym, optimizer="adam", optimizer_params=dict(LM_OPT),
                        compute_dtype="bfloat16", fused_update=False,
                        rules=rules, mesh=mesh)
    return tr.bind({"data": (LM_BATCH, LM_SEQ)},
                   {"softmax_label": (LM_BATCH, LM_SEQ)}, arg_params=args)


def p20_split_tp1(torch, np, mx, fa, launches):
    """(b) Phase 9's trainer over a ``{"data": 1, "model": 1}`` mesh with
    ``megatron_rules()``: the split plan for every Megatron parameter,
    and 2 steps bitwise those of the trainer without rules."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import make_mesh, megatron_rules
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    rules = megatron_rules()
    tp = p20_trainer(torch, np, sym, args,
                     make_mesh({"data": 1, "model": 1}, [card]), rules)
    # one card, as the trainer with rules (the default mesh spans every
    # card)
    plain = p20_trainer(torch, np, sym, args, make_mesh({"data": 1}, [card]))
    want = sorted(n for n in tp._param_names
                  if any(ax is not None for ax in rules.spec_for(n)))
    info = [i for i in tp.compile_info if i["kind"] == "tensor_parallel"][-1]
    check(info["plan"] == "split" and sorted(info["params"]) == want
          and set(info["params"].values()) == {"split"},
          f"(b) plan {info['plan']} for {len(info['params'])} params "
          f"({info['reason']}), expected split for {len(want)}")
    check(not tp._fused and not plain._fused, "(b) a trainer fused")
    out = {"split_params": len(want)}
    det = torch.are_deterministic_algorithms_enabled()
    try:
        # the embedding's scatter-add on the card is deterministic only
        # in this mode, and the two trainers are held bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        for step in range(2):
            batch = lm_batch(np, seed=200 + step)
            before = p20_kernel_counts(fa)
            forms = (dict(fa.flash_fwd.launches_by_form),
                     dict(fa.flash_bwd.launches_by_form))
            h_tp = tp.step(batch)[0]
            p20_sync(torch)
            p20_add(launches, fa, before)
            n3 = fa.flash_fwd.launches - before["flash_attn_fwd"]
            n4 = fa.flash_bwd.launches - before["flash_attn_bwd"]
            check(n3 == LAYERS and n4 == LAYERS, f"(b) step {step}: K3 "
                  f"{n3}, K4 {n4} launches, expected {LAYERS} each")
            if DEVICE == "cuda":
                h3 = (fa.flash_fwd.launches_by_form["hopper"]
                      - forms[0]["hopper"])
                h4 = (fa.flash_bwd.launches_by_form["hopper"]
                      - forms[1]["hopper"])
                check(h3 == n3 and h4 == n4, f"(b) K3/K4 forms: {h3}/{n3} "
                      f"and {h4}/{n4} hopper")
            h_plain = plain.step(batch)[0]
            p20_sync(torch)
            check(torch.equal(bits(torch, h_tp), bits(torch, h_plain)),
                  f"(b) step {step}: the heads differ from the trainer "
                  "without rules")
    finally:
        torch.use_deterministic_algorithms(det)
    pa, pb = tp.get_params()[0], plain.get_params()[0]
    for n in pb:
        check(np.array_equal(pa[n].asnumpy().view(np.int32),
                             pb[n].asnumpy().view(np.int32)),
              f"(b) {n} differs from the trainer without rules")
    out["bitwise_steps"] = 2
    log(f"  (b) split at tp 1: {json.dumps(out)}")
    return out


def p20_sum_net(mx):
    S = mx.symbol
    with mx.name.NameManager():
        x = S.FullyConnected(data=S.Variable("data"), num_hidden=1024,
                             name="fc1")
        x = S.Activation(data=x, act_type="tanh")
        return S.MakeLoss(data=S.sum(x), name="loss")


def p20_two_cards(torch, np, mx, fa, launches):
    """(c) where two cards exist: the split plan over ``{"data": 1,
    "model": 2}`` (4 heads a member) against the one-card trainer's first
    heads and update, and item 13's ``MakeLoss(sum(...))`` net over
    ``data_parallel_mesh(2)`` against one card."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import (ShardedTrainer, data_parallel_mesh,
                                          make_mesh, megatron_rules)
    if DEVICE == "cuda" and torch.cuda.device_count() < 2:
        log(f"  (c) not run: {torch.cuda.device_count()} CUDA device(s); "
            "tensor parallelism over distinct cards needs two")
        return {"run": False, "devices": torch.cuda.device_count()}
    kind = "gpu" if DEVICE == "cuda" else "cpu"
    ctx = mx.gpu if kind == "gpu" else mx.cpu
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    out = {"run": True}
    batch = lm_batch(np, seed=300)
    one = p20_trainer(torch, np, sym, args,
                      make_mesh({"data": 1}, [ctx(0)]))
    h1 = one.step(batch)[0].float().cpu()
    p1 = one.get_params()[0]
    del one
    two = p20_trainer(torch, np, sym, args,
                      make_mesh({"data": 1, "model": 2}, [ctx(0), ctx(1)]),
                      megatron_rules())
    check(two._tp_plan.plan == "split", f"(c) plan {two._tp_plan.plan}: "
          f"{two._tp_plan.reason}")
    before = p20_kernel_counts(fa)
    h2 = two.step(batch)[0].float().cpu()
    p20_sync(torch)
    p20_add(launches, fa, before)
    p2 = two.get_params()[0]
    head_diff = float((h2 - h1).abs().max())
    step1 = max(float(np.abs(p2[n].asnumpy() - p1[n].asnumpy()).max())
                for n in p1)
    out["tp"] = {"first_heads_max_diff": head_diff,
                 "step1_max_param_diff": step1,
                 "heads_per_member": HEADS // 2}
    check(head_diff <= P20_TP_HEAD_TOL, f"(c) TP heads {head_diff} from "
          f"one card's, over {P20_TP_HEAD_TOL}")
    check(step1 <= P20_TP_STEP1_LIMIT, f"(c) TP first update {step1} from "
          f"one card's, over {P20_TP_STEP1_LIMIT}")
    del two
    sym = p20_sum_net(mx)
    rng = np.random.RandomState(21)
    x = [rng.randn(256, 512).astype(np.float32) for _ in range(2)]
    res = {}
    for label, mesh in (("one card", data_parallel_mesh(1, device_type=kind)),
                        ("two cards", data_parallel_mesh(2,
                                                         device_type=kind))):
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 1e-3}, mesh=mesh,
                            seed=3)
        tr.bind({"data": (256, 512)})
        heads = [tr.step({"data": xi})[0].cpu() for xi in x]
        res[label] = (heads, tr.get_params()[0])
    (ha, pa), (hb, pb) = res["two cards"], res["one card"]
    rtol, atol = P20_SUM_TOL
    for a, b in zip(ha, hb):
        check(torch.allclose(a, b, rtol=rtol, atol=atol), f"(c) sum heads "
              f"{a.tolist()} against one card's {b.tolist()}")
    worst = max(float(np.abs(pa[n].asnumpy() - pb[n].asnumpy()).max())
                for n in pb)
    check(worst <= atol + rtol * max(float(np.abs(pb[n].asnumpy()).max())
                                     for n in pb),
          f"(c) sum net parameters {worst} from one card's")
    out["sum"] = {"heads": [float(h[0]) for h in ha],
                  "max_param_diff": worst}
    log(f"  (c) two cards: {json.dumps(out)}")
    return out


def phase_tensor_model_parallel(torch, np, mx, fa, nn_ops, _build):
    """Phase 20: (a) group2ctx across the host and the card at full
    width, (b) the split rewrite at a model-axis size of 1, (c) tensor
    parallelism and the implicit mode's reductions over two cards where
    there are two; builds no kernel.  Returns the K3/K4 launches of its
    main runs and its numbers."""
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0}
    out = {"card": card_line()}
    try:
        t0 = time.perf_counter()
        out["group2ctx"] = p20_group2ctx(torch, np, mx, fa, nn_ops, launches)
        out["group2ctx"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["split_tp1"] = p20_split_tp1(torch, np, mx, fa, launches)
        out["split_tp1"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["two_cards"] = p20_two_cards(torch, np, mx, fa, launches)
        out["two_cards"]["seconds"] = time.perf_counter() - t0
    finally:
        _build._compile = compile_
    check(not built, f"phase 20 built kernels: {built}")
    check(launches["flash_attn_fwd"] > 0 and launches["flash_attn_bwd"] > 0,
          f"phase 20 launched no flash attention: {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("  tensor and model parallelism: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 21: mixture of experts and ring attention
# ---------------------------------------------------------------------------

# (a) MoEFFN at the LM's width: 8 experts of hidden 2048, top-2 at
# capacity factor 1.5 with the aux head, over [2, 2048, 512] (4096
# tokens); then top-1 (Switch).  SGD in f32 with TF32 off, on the card
# and on the host from the same weights and batches.
P21_MOE = dict(num_experts=8, hidden_size=2048, capacity_factor=1.5,
               aux_loss=True)
P21_TOKENS = (2, 2048, D_MODEL)
P21_STEPS = 3
# a rate at which 3 steps move the router by ~8 % and the biases from 0
# to ~1e-3 (LinearRegressionOutput's gradient is small at this width)
P21_OPT = {"learning_rate": 1.0}
# against the host's: heads as a share of their largest magnitude (f32
# products summed in another order by cuBLAS than by the host's BLAS);
# each parameter's 3-step update as a share of the update's largest
# magnitude.  ~25 of the 25 M expert pre-activations lie within 1e-6 of
# ReLU's kink; one that falls on the other side on the card moves its
# slot's whole term of the gradient, for expert1's weight a column of
# 512 (measured on the card: 1.22e-2 of expert1's weight update, 6.6e-4
# of its bias's, 2.7e-5 of expert2's weight's).  So every update is held
# within 5e-2, and at most 1 % of each update's elements may lie
# farther than 1e-4 from the host's
P21_HEAD_TOL = 1e-4
P21_UPDATE_TOL = 5e-2
P21_UPDATE_NEAR = 1e-4
P21_UPDATE_OFF_SHARE = 1e-2
# (b) the ring's gradients against flash_attention's: the ring takes
# delta = rowsum(do * out) in f32 on its own, K4 in flash_attention's
# backward writes its own (another summation order), and every
# gradient is rounded to bf16; as a share of each gradient's largest
# magnitude
P21_RING_GRAD_TOL = 1e-2


def p21_record_routes(moe):
    """Record the routing decisions of the MoE programs (each call's
    router probabilities and chosen experts); returns the record and the
    function that restores the programs."""
    seen = []
    topk, top1 = moe._topk, moe._top1

    def rec_topk(probs, k):
        v, i = topk(probs, k)
        seen.append((probs.detach().float().cpu(), i.detach().cpu()))
        return v, i

    def rec_top1(probs):
        g, i = top1(probs)
        seen.append((probs.detach().float().cpu(), i.detach().cpu()))
        return g, i

    moe._topk, moe._top1 = rec_topk, rec_top1

    def restore():
        moe._topk, moe._top1 = topk, top1
    return seen, restore


def p21_margin(torch, probs, k):
    """Each token's margin between its k-th and its next probability,
    and between its chosen ones (the order decides rank-major slots)."""
    top = torch.sort(probs, dim=-1, descending=True)[0]
    gaps = top[:, :k] - top[:, 1:k + 1]
    return gaps.min(dim=-1)[0]


def p21_moe_symbol(mx, top_k, cf=None):
    S = mx.symbol
    kw = dict(P21_MOE, top_k=top_k)
    if cf is not None:
        kw["capacity_factor"] = cf
    moe = S.MoEFFN(data=S.Variable("data"), name="moe", **kw)
    return S.Group([S.LinearRegressionOutput(data=moe[0], name="lro"),
                    moe[1]])


def p21_moe_args(np, sym, seed=0):
    """Uniform(0.07) weights, zero biases; the batches from a seed."""
    shapes = {"data": P21_TOKENS, "lro_label": P21_TOKENS}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: (rng.uniform(-0.07, 0.07, s) if n.endswith("weight")
                else np.zeros(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    batches = [{"data": rng.randn(*P21_TOKENS).astype(np.float32),
                "lro_label": rng.randn(*P21_TOKENS).astype(np.float32)}
               for _ in range(P21_STEPS)]
    return args, batches


def p21_moe_run(torch, np, sym, args, batches, mesh=None, device=None):
    """``P21_STEPS`` SGD steps (the fused update, K2 on the card) over
    ``mesh`` or on ``device`` alone; returns the heads of each step on
    the host, the parameters after, the routes each step took and the
    host-clock ms of each step (synchronized)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer, moe
    tr = ShardedTrainer(sym, "sgd", dict(P21_OPT), mesh=mesh, device=device)
    tr.bind({"data": P21_TOKENS}, {"lro_label": P21_TOKENS},
            arg_params=args)
    routes, restore = p21_record_routes(moe)
    heads, ms = [], []
    try:
        for b in batches:
            placed = tr.place_batch(b)
            p20_sync(torch)
            t0 = time.perf_counter()
            out = tr.step(placed)
            p20_sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
            heads.append([h.detach().float().cpu() for h in out])
    finally:
        restore()
    params = {n: torch.from_numpy(v.asnumpy())
              for n, v in tr.get_params()[0].items()}
    return heads, params, routes, ms


def p21_compare(torch, a, b, init, label, top_k, routes=True):
    """Routes token for token (a flip prints its margin; ``routes``
    False when ``a`` routed each member's block in a thread of its own),
    heads and each parameter's update from ``init`` within the stated
    shares of their largest magnitude."""
    (ha, pa, ra, _), (hb, pb, rb, _) = a, b
    if not routes:
        ra = rb = []
    else:
        check(len(ra) == len(rb) == P21_STEPS, f"{label}: {len(ra)} and "
              f"{len(rb)} routing calls in {P21_STEPS} steps")
    margin = float("inf")
    for step, ((probs, ia), (_, ib)) in enumerate(zip(ra, rb)):
        m = p21_margin(torch, probs, top_k)
        margin = min(margin, float(m.min()))
        bad = (ia != ib).any(dim=-1)
        if bool(bad.any()):
            raise SmokeFailure(
                f"{label}: step {step + 1}: {int(bad.sum())} tokens routed "
                f"otherwise than on the host; their margins "
                f"{m[bad][:8].tolist()} (a near tie flipped)")
    worst_head = 0.0
    for sa, sb in zip(ha, hb):
        for x, y in zip(sa, sb):
            scale = max(float(y.abs().max()), 1e-30)
            worst_head = max(worst_head, float((x - y).abs().max()) / scale)
    updates, off = {}, {}
    for n in pb:
        base = torch.from_numpy(init[n])
        ub = pb[n] - base
        scale = max(float(ub.abs().max()), 1e-30)
        diff = ((pa[n] - base) - ub).abs()
        updates[n] = float(diff.max()) / scale
        off[n] = float((diff > P21_UPDATE_NEAR * scale).float().mean())
    check(worst_head <= P21_HEAD_TOL, f"{label}: heads {worst_head} of "
          f"their largest magnitude from the host's, over {P21_HEAD_TOL}")
    check(max(updates.values()) <= P21_UPDATE_TOL
          and max(off.values()) <= P21_UPDATE_OFF_SHARE,
          f"{label}: parameter updates {updates} of their largest "
          f"magnitude from the host's (over {P21_UPDATE_TOL}?), shares of "
          f"elements beyond {P21_UPDATE_NEAR} of it {off} (over "
          f"{P21_UPDATE_OFF_SHARE}?)")
    return {"routes_equal": routes or None,
            "min_margin": margin if routes else None,
            "head_rel_diff": worst_head, "update_rel_diff": updates,
            "update_off_share": off}


def p21_moe(torch, np, mx, fu, launches):
    """(a) MoEFFN top-2 then top-1 through ShardedTrainer on the card
    against the host; adds the card's K2 launches to ``launches``."""
    out = {}
    card_ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    for top_k in (2, 1):
        with mx.name.NameManager():
            sym = p21_moe_symbol(mx, top_k)
        args, batches = p21_moe_args(np, sym)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        k2 = fu.fused_update.launches
        card = p21_moe_run(torch, np, sym, args, batches, device=card_ctx)
        launches["fused_update"] += fu.fused_update.launches - k2
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if DEVICE == "cuda" else None)
        host = p21_moe_run(torch, np, sym, args, batches, device="cpu")
        label = f"(a) top-{top_k}"
        res = p21_compare(torch, card, host, args, label, top_k)
        aux = [float(h[1]) for h in card[0]]
        check(all(np.isfinite(aux)) and all(
            bool(torch.isfinite(h[0]).all()) for h in card[0]),
            f"{label}: non-finite heads")
        res.update({"step_ms": card[3], "host_step_ms": host[3],
                    "peak_gib": peak, "aux_loss": aux,
                    "tokens": int(np.prod(P21_TOKENS[:-1]))})
        log(f"  {label}: " + json.dumps(res))
        out[f"top{top_k}"] = res
    return out


def p21_ring(torch, np, mx, fa, ra):
    """(b) ring_self_attention over a ``{"seq": 1}`` mesh of the card at
    the LM's attention shape, causal and not: the forward bitwise the K3
    call of ``flash_attention_stats``, held against ``flash_attention``;
    gradients against ``flash_attention``'s; K3 and K4 one launch a call
    each in the hopper form, K4 with the ring's ``delta``; no dense
    attention."""
    from mxnet_tpu_torch.parallel import make_mesh, ring_self_attention
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    mesh = make_mesh({"seq": 1}, [ctx])
    B, H, L, D = LM_BATCH, HEADS, LM_SEQ, D_MODEL // HEADS
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    q, k, v, do = (torch.randn(B, H, L, D, device=DEVICE, generator=gen,
                               dtype=torch.float32).to(torch.bfloat16)
                   for _ in range(4))
    out, launches = {}, {"flash_attn_fwd": 0, "flash_attn_bwd": 0}
    # the ring's backward reaches K4 through flash_attention_block_bwd;
    # the kernel wrappers count through their module names, so the
    # record wraps the caller
    block_bwd = fa.flash_attention_block_bwd
    for causal in (False, True):
        deltas = []

        def recording_bwd(*a, **kw):
            deltas.append(kw.get("delta") is not None)
            return block_bwd(*a, **kw)

        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        dense0 = (ra.local_attention.dense_calls,
                  ra.blockwise_attention.calls)
        before = p20_kernel_counts(fa)
        forms0 = (dict(fa.flash_fwd.launches_by_form),
                  dict(fa.flash_bwd.launches_by_form))
        fa.flash_attention_block_bwd = recording_bwd
        try:
            ring = ring_self_attention(qs, ks, vs, mesh, causal=causal)
            grads = torch.autograd.grad(ring, (qs, ks, vs), do)
            p20_sync(torch)
        finally:
            fa.flash_attention_block_bwd = block_bwd
        after = p20_kernel_counts(fa)
        p20_add(launches, fa, before)
        fwd_forms = {f: fa.flash_fwd.launches_by_form[f] - forms0[0][f]
                     for f in forms0[0]}
        bwd_forms = {f: fa.flash_bwd.launches_by_form[f] - forms0[1][f]
                     for f in forms0[1]}
        label = f"(b) {'causal' if causal else 'full'}"
        n3 = after["flash_attn_fwd"] - before["flash_attn_fwd"]
        n4 = after["flash_attn_bwd"] - before["flash_attn_bwd"]
        if DEVICE == "cuda":
            check(n3 == 1 and n4 == 1, f"{label}: K3 {n3}, K4 {n4} launches "
                  "(one each)")
            check(fwd_forms["hopper"] == 1 and bwd_forms["hopper"] == 1,
                  f"{label}: forms {fwd_forms}, {bwd_forms}: not hopper")
        check(deltas == [True], f"{label}: K4 calls with an external delta: "
              f"{deltas}")
        check((ra.local_attention.dense_calls,
               ra.blockwise_attention.calls) == dense0,
              f"{label}: the ring left the flash path")
        stats_out, _ = fa.flash_attention_stats(q, k, v, causal=causal)
        check(torch.equal(ring.detach(), stats_out),
              f"{label}: the ring's forward is not bitwise "
              "flash_attention_stats's")
        qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
        flash = fa.flash_attention(qf, kf, vf, causal=causal)
        fgrads = torch.autograd.grad(flash, (qf, kf, vf), do)
        worst = max(float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for a, b in zip(grads, fgrads))
        check(worst <= P21_RING_GRAD_TOL, f"{label}: gradients {worst} of "
              f"their largest magnitude from flash_attention's, over "
              f"{P21_RING_GRAD_TOL}")
        res = {"forward_bitwise_stats": True,
               "forward_bitwise_flash_attention": bool(torch.equal(
                   ring.detach(), flash.detach())),
               "max_abs_err_vs_flash_attention": float(
                   (ring.detach().float() - flash.detach().float()).abs()
                   .max()),
               "grad_rel_diff": worst, "k3": n3, "k4": n4,
               "k4_external_delta": True}
        if DEVICE == "cuda":
            def ring_step():
                o = ring_self_attention(qs, ks, vs, mesh, causal=causal)
                torch.autograd.grad(o, (qs, ks, vs), do)

            def flash_step():
                o = fa.flash_attention(qf, kf, vf, causal=causal)
                torch.autograd.grad(o, (qf, kf, vf), do)
            # a sleep of ~4 ms ahead of each call: the ring's host work
            # (a member thread, the merge's PyTorch ops) is enqueued
            # before the card reaches it, so the events time the device
            times = turns(torch, {"ring": ring_step, "flash": flash_step},
                          reps=20, sleep=1 << 23)
            calls = {n: time_ms(torch, f, reps=20, hide_host=False)
                     for n, f in (("ring", ring_step),
                                  ("flash", flash_step))}
            res.update({"ring_fwd_bwd_ms": times["ring"],
                        "flash_fwd_bwd_ms": times["flash"],
                        "ring_per_call_ms": calls["ring"],
                        "flash_per_call_ms": calls["flash"]})
        log(f"  {label}: " + json.dumps(res))
        out["causal" if causal else "full"] = res
    return out, launches


def p21_two_cards(torch, np, mx, fa, launches):
    """(c) where two cards exist: phase 9's LM trainer over ``{"seq":
    2}`` against one card (first heads and update), and (a)'s MoE over
    ``{"expert": 2}`` at a capacity factor that drops nothing (a member
    routes its own tokens) against one card."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import make_mesh
    if DEVICE == "cuda" and torch.cuda.device_count() < 2:
        log(f"  (c) not run: {torch.cuda.device_count()} CUDA device(s); "
            "sequence and expert parallelism over distinct cards need two")
        return {"run": False, "devices": torch.cuda.device_count()}
    ctx = mx.gpu if DEVICE == "cuda" else mx.cpu
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    batch = lm_batch(np, seed=301)
    one = p20_trainer(torch, np, sym, args, make_mesh({"data": 1}, [ctx(0)]))
    h1 = one.step(batch)[0].float().cpu()
    p1 = one.get_params()[0]
    del one
    two = p20_trainer(torch, np, sym, args,
                      make_mesh({"seq": 2}, [ctx(0), ctx(1)]))
    before = p20_kernel_counts(fa)
    h2 = two.step(batch)[0].float().cpu()
    p20_sync(torch)
    p20_add(launches, fa, before)
    p2 = two.get_params()[0]
    del two
    head_diff = float((h2 - h1).abs().max())
    step1 = max(float(np.abs(p2[n].asnumpy() - p1[n].asnumpy()).max())
                for n in p1)
    check(head_diff <= P20_TP_HEAD_TOL, f"(c) seq heads {head_diff} from "
          f"one card's, over {P20_TP_HEAD_TOL}")
    check(step1 <= P20_TP_STEP1_LIMIT, f"(c) seq first update {step1} from "
          f"one card's, over {P20_TP_STEP1_LIMIT}")
    out = {"run": True, "seq": {"first_heads_max_diff": head_diff,
                                "step1_max_param_diff": step1}}
    # capacity factor E / k: a member's capacity is its token count
    with mx.name.NameManager():
        msym = p21_moe_symbol(mx, 2, cf=P21_MOE["num_experts"] / 2)
    margs, batches = p21_moe_args(np, msym, seed=1)
    a = p21_moe_run(torch, np, msym, margs, batches,
                    mesh=make_mesh({"data": 1}, [ctx(0)]))
    b = p21_moe_run(torch, np, msym, margs, batches,
                    mesh=make_mesh({"expert": 2}, [ctx(0), ctx(1)]))
    res = p21_compare(torch, b, a, margs, "(c) expert mesh", 2,
                      routes=False)
    out["expert"] = dict(res, step_ms=b[3], one_card_step_ms=a[3])
    log(f"  (c) two cards: {json.dumps(out)}")
    return out


def phase_moe_ring(torch, np, mx, fa, fu, _build):
    """Phase 21: (a) MoEFFN through ShardedTrainer on the card against
    the host, (b) ring attention over a one-member seq mesh of the card
    (K3/K4 as the ring's steps), (c) the seq and expert meshes over two
    cards where there are two; builds no kernel.  Returns the K3/K4
    launches of (b) and (c), K2's of (a), and the phase's numbers."""
    ra = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    out = {"card": card_line()}
    try:
        t0 = time.perf_counter()
        k2 = {"fused_update": 0}
        out["moe"] = p21_moe(torch, np, mx, fu, k2)
        out["moe"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ring"], launches = p21_ring(torch, np, mx, fa, ra)
        launches.update(k2)
        out["ring"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["two_cards"] = p21_two_cards(torch, np, mx, fa, launches)
        out["two_cards"]["seconds"] = time.perf_counter() - t0
    finally:
        _build._compile = compile_
    check(not built, f"phase 21 built kernels: {built}")
    if DEVICE == "cuda":
        check(launches["flash_attn_fwd"] >= 2
              and launches["flash_attn_bwd"] >= 2,
              f"phase 21's ring launched K3/K4 {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("  mixture of experts and ring attention: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 22: pipelines
# ---------------------------------------------------------------------------

# (a) phase 9's LM through PipelineTrainer: 4 stages on the card by the
# automatic balance, Adam unfused, bf16 compute, deterministic algorithms
P22_STAGES = 4
P22_STEPS = 2               # compared against ShardedTrainer
P22_TIMED = 3               # then timed
# M = 4 against ShardedTrainer: each microbatch's bf16 products run at a
# quarter of the rows (cuBLAS may pick another kernel) and the gradients
# sum over microbatches in f32: heads within 5e-2 (per-token losses near
# ln 32000 = 10.4), each parameter's first Adam update within 2.5 lr of
# the trainer's (a gradient near zero whose sign flips moves a weight by
# 2 lr), as phase 20 (c) holds its two cards
P22_HEAD_TOL = 5e-2
P22_UPDATE_LIMIT = 2.5 * LM_OPT["learning_rate"]
# (b) dryrun_multichip's phase 4 MLP: widths 24/16/12 -> 10, tanh, batch 8
# of 12 features, SGD at 0.1, 4 microbatches, against ShardedTrainer
# within the dryrun's bound
P22_MLP_WIDTHS = (24, 16, 12, 10)
P22_MLP_BATCH, P22_MLP_IN, P22_MLP_MICRO = 8, 12, 4
P22_MLP_OPT = {"learning_rate": 0.1}
P22_MLP_TOL = 2e-5
# (d) phase 9's LM over {"model": 2, "seq": 2} (four cards) against one
# card: bf16 products cut over two cards and the ring's shards sum in
# another order, so the first step is held as phase 20 (c) holds two
# cards (heads within P20_TP_HEAD_TOL, the first Adam update within
# P20_TP_STEP1_LIMIT); the later steps are timed and their heads'
# distance recorded (Adam turns a flipped near-zero gradient into a 2 lr
# step, which the next heads carry)
P22_COMBINED_STEPS = 3


def p22_reset(fa, nn_ops, fu):
    """Every launch count phase 22 reads, set to 0."""
    for k in (fa.flash_fwd, fa.flash_bwd, nn_ops.softmax_rows,
              fu.fused_update):
        k.launches = 0
        k.launches_by_form = dict.fromkeys(k.launches_by_form, 0)


def p22_read(fa, nn_ops, fu):
    return {"flash_attn_fwd": fa.flash_fwd.launches,
            "flash_attn_bwd": fa.flash_bwd.launches,
            "softmax_rows": nn_ops.softmax_rows.launches,
            "fused_update": fu.fused_update.launches,
            "k3_hopper": fa.flash_fwd.launches_by_form["hopper"],
            "k4_hopper": fa.flash_bwd.launches_by_form["hopper"],
            "k1_warp": nn_ops.softmax_rows.launches_by_form["warp"]}


def p22_cap(pp):
    """Wrap the trainer's per-stage forward and backward callables to
    record each stage's peak of live microbatch environments."""
    S = pp.num_stages
    live, peak = [0] * S, [0] * S

    def fwd(fn, s):
        def run(*a):
            live[s] += 1
            peak[s] = max(peak[s], live[s])
            return fn(*a)
        return run

    def bwd(fn, s):
        def run(*a):
            live[s] -= 1
            return fn(*a)
        return run

    pp._fwd = [fwd(f, s) for s, f in enumerate(pp._fwd)]
    pp._bwd = [bwd(f, s) for s, f in enumerate(pp._bwd)]
    return peak


def p22_host(torch, tr):
    """The trainer's parameters as host numpy arrays."""
    return {n: v.asnumpy() for n, v in tr.get_params()[0].items()}


def p22_steps(torch, tr, batches):
    """Step ``tr`` over ``batches``: the heads on the host, each step's
    synced host ms, and the peak memory above what was resident."""
    heads, ms = [], []
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for b in batches:
        t0 = time.perf_counter()
        h = tr.step(b)[0]
        p20_sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
        heads.append(h.float().cpu())
    peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
            if DEVICE == "cuda" else None)
    return heads, ms, peak


def p22_lm(torch, np, mx, fa, nn_ops, fu, launches):
    """(a) phase 9's LM through ``PipelineTrainer(num_stages=4,
    devices=[card] * 4)`` at M 1 and 4 against ``ShardedTrainer`` on the
    card from the same weights and batches."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import PipelineTrainer, make_mesh
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    batches = [lm_batch(np, seed=220 + i)
               for i in range(P22_STEPS + P22_TIMED)]
    out = {}
    det = torch.are_deterministic_algorithms_enabled()
    try:
        # the embedding's scatter-add on the card is deterministic only in
        # this mode, and M = 1 is held bit for bit
        torch.use_deterministic_algorithms(True, warn_only=True)
        ref = p20_trainer(torch, np, sym, args,
                          make_mesh({"data": 1}, [card]))
        ref_heads, ms, _ = p22_steps(torch, ref, batches[:1])
        ref_p1 = p22_host(torch, ref)
        h, ms2, _ = p22_steps(torch, ref, batches[1:P22_STEPS])
        ref_heads += h
        ref_p2 = p22_host(torch, ref)
        _, ref_ms, ref_peak = p22_steps(torch, ref, batches[P22_STEPS:])
        del ref
        out["sharded_trainer"] = {"step_ms": ms + ms2 + ref_ms,
                                  "timed_median_ms": float(np.median(ref_ms)),
                                  "step_peak_gib": ref_peak}
        for M in (1, 4):
            pp = PipelineTrainer(sym, num_stages=P22_STAGES,
                                 devices=[card] * P22_STAGES,
                                 num_microbatches=M, optimizer="adam",
                                 optimizer_params=dict(LM_OPT),
                                 compute_dtype="bfloat16")
            pp.bind({"data": shapes["data"]},
                    {"softmax_label": shapes["softmax_label"]},
                    arg_params=args)
            stage_params = [len(p) for p in pp._params]
            peak_live = p22_cap(pp)
            p20_sync(torch)
            # the main path's run: every count starts at 0 here
            p22_reset(fa, nn_ops, fu)
            heads, ms, _ = p22_steps(torch, pp, batches[:1])
            p1 = p22_host(torch, pp)
            h, ms2, _ = p22_steps(torch, pp, batches[1:P22_STEPS])
            heads += h
            p2 = p22_host(torch, pp)
            _, pp_ms, pp_peak = p22_steps(torch, pp, batches[P22_STEPS:])
            got = p22_read(fa, nn_ops, fu)
            for k in ("flash_attn_fwd", "flash_attn_bwd", "softmax_rows"):
                launches[k] += got[k]
            del pp
            steps = P22_STEPS + P22_TIMED
            label = f"(a) M={M}"
            for s, p in enumerate(peak_live):
                check(p <= P22_STAGES - s, f"{label}: stage {s} held {p} "
                      f"live microbatches, over the 1F1B cap "
                      f"{P22_STAGES - s}")
            if DEVICE == "cuda":
                check(got["flash_attn_fwd"] == 2 * M * LAYERS * steps
                      and got["k3_hopper"] == got["flash_attn_fwd"],
                      f"{label}: K3 launched {got} in {steps} steps "
                      f"(expected {2 * M * LAYERS} a step, hopper)")
                check(got["flash_attn_bwd"] == M * LAYERS * steps
                      and got["k4_hopper"] == got["flash_attn_bwd"],
                      f"{label}: K4 launched {got} in {steps} steps "
                      f"(expected {M * LAYERS} a step, hopper)")
            check(got["fused_update"] == 0, f"{label}: K2 launched "
                  f"{got['fused_update']} times")
            for hd in heads:
                check(tuple(hd.shape) == (LM_BATCH * LM_SEQ,)
                      and bool(torch.isfinite(hd).all()),
                      f"{label}: heads {tuple(hd.shape)}, not finite")
            head_diff = max(float((a - b).abs().max())
                            for a, b in zip(heads, ref_heads))
            res = {"microbatches": M, "stage_params": stage_params,
                   "peak_live": peak_live, "launches": got,
                   "step_ms": ms + ms2 + pp_ms,
                   "timed_median_ms": float(np.median(pp_ms)),
                   "step_peak_gib": pp_peak,
                   "heads_max_diff": head_diff}
            if M == 1:
                same = all(torch.equal(bits(torch, a), bits(torch, b))
                           for a, b in zip(heads, ref_heads)) and all(
                    np.array_equal(p2[n].view(np.int32),
                                   ref_p2[n].view(np.int32)) for n in p2)
                res["bitwise"] = same
                if not same:
                    worst = max((float(np.abs(p2[n] - ref_p2[n]).max()), n)
                                for n in p2)
                    res["params_max_diff"] = worst
                check(same, f"{label}: heads or parameters differ from "
                      f"ShardedTrainer's (heads {head_diff}, "
                      f"{res.get('params_max_diff')})")
            else:
                step1 = max(float(np.abs((p1[n] - args[n])
                                         - (ref_p1[n] - args[n])).max())
                            for n in p1)
                res["step1_max_update_diff"] = step1
                check(head_diff <= P22_HEAD_TOL, f"{label}: heads {head_diff}"
                      f" from ShardedTrainer's, over {P22_HEAD_TOL}")
                check(step1 <= P22_UPDATE_LIMIT, f"{label}: first update "
                      f"{step1} from ShardedTrainer's, over "
                      f"{P22_UPDATE_LIMIT}")
            log(f"  {label}: " + json.dumps(res))
            out[f"m{M}"] = res
    finally:
        torch.use_deterministic_algorithms(det)
    return out


def p22_mlp_net(mx):
    S = mx.symbol
    with mx.name.NameManager():
        net = S.Variable("data")
        for i, w in enumerate(P22_MLP_WIDTHS[:-1]):
            net = S.FullyConnected(data=net, num_hidden=w, name=f"pfc{i}")
            net = S.Activation(data=net, act_type="tanh")
        net = S.FullyConnected(data=net, num_hidden=P22_MLP_WIDTHS[-1],
                               name="pfc_out")
        return S.SoftmaxOutput(data=net, name="softmax")


def p22_mlp_data(np, net):
    shapes = {"data": (P22_MLP_BATCH, P22_MLP_IN),
              "softmax_label": (P22_MLP_BATCH,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(22)
    args = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes}
    batches = [{"data": rng.rand(*shapes["data"]).astype(np.float32),
                "softmax_label": rng.randint(0, P22_MLP_WIDTHS[-1],
                                             shapes["softmax_label"])
                .astype(np.float32)} for _ in range(P22_STEPS)]
    return shapes, args, batches


def p22_bind(tr, shapes, args):
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    return tr


def p22_stage_fn(torch):
    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    return stage_fn


def p22_stacked(torch, np, S, seed=23):
    rng = np.random.RandomState(seed)
    return ({"w": torch.tensor(rng.randn(S, 8, 8).astype(np.float32) * 0.3,
                               device=DEVICE),
             "b": torch.tensor(rng.randn(S, 8).astype(np.float32) * 0.1,
                               device=DEVICE)},
            torch.tensor(rng.randn(8, 8).astype(np.float32), device=DEVICE))


def p22_mlp(torch, np, mx, fa, nn_ops, fu, launches):
    """(b) the dryrun's MLP through PipelineTrainer over 4 stages on the
    card against ShardedTrainer; SpmdPipelineTrainer and pipeline_apply
    at one pipe member, bitwise PipelineTrainer and the sequential
    stage."""
    from mxnet_tpu_torch.parallel import (PipelineTrainer, ShardedTrainer,
                                          SpmdPipelineTrainer, make_mesh,
                                          pipeline_apply)
    net = p22_mlp_net(mx)
    shapes, args, batches = p22_mlp_data(np, net)
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu(0)
    kw = dict(num_microbatches=P22_MLP_MICRO, optimizer="sgd",
              optimizer_params=dict(P22_MLP_OPT))
    ref = p22_bind(ShardedTrainer(net, "sgd", dict(P22_MLP_OPT),
                                  mesh=make_mesh({"data": 1}, [card])),
                   shapes, args)
    ref_heads, _, _ = p22_steps(torch, ref, batches)
    ref_p = p22_host(torch, ref)
    pp = p22_bind(PipelineTrainer(net, num_stages=P22_STAGES,
                                  devices=[card] * P22_STAGES, **kw),
                  shapes, args)
    p20_sync(torch)
    p22_reset(fa, nn_ops, fu)
    heads, ms, _ = p22_steps(torch, pp, batches)
    got = p22_read(fa, nn_ops, fu)
    launches["softmax_rows"] += got["softmax_rows"]
    pp_p = p22_host(torch, pp)
    head_diff = max(float((a - b).abs().max())
                    for a, b in zip(heads, ref_heads))
    param_diff = max(float(np.abs(pp_p[n] - ref_p[n]).max()) for n in ref_p)
    check(head_diff <= P22_MLP_TOL and param_diff <= P22_MLP_TOL,
          f"(b) pipeline heads {head_diff}, parameters {param_diff} from "
          f"ShardedTrainer's, over {P22_MLP_TOL}")
    want_k1 = 2 * P22_MLP_MICRO * P22_STEPS
    if DEVICE == "cuda":
        check(got["softmax_rows"] == want_k1
              and got["k1_warp"] == want_k1,
              f"(b) K1 launched {got} in {P22_STEPS} steps (expected "
              f"{2 * P22_MLP_MICRO} a step from the last stage, warp)")
    check(got["fused_update"] == 0, f"(b) K2 launched {got['fused_update']}")
    out = {"pipeline": {"heads_max_diff": head_diff,
                        "params_max_diff": param_diff, "launches": got,
                        "step_ms": ms}}
    # one pipe member: the timetable's run against the host-driven path
    spmd = p22_bind(SpmdPipelineTrainer(net, num_stages=1, devices=[card],
                                        **kw), shapes, args)
    host = p22_bind(PipelineTrainer(net, num_stages=1, devices=[card], **kw),
                    shapes, args)
    same = True
    for b in batches:
        same &= torch.equal(spmd.step(b)[0], host.step(b)[0])
    sp, hp = p22_host(torch, spmd), p22_host(torch, host)
    same &= all(np.array_equal(sp[n].view(np.int32), hp[n].view(np.int32))
                for n in hp)
    check(spmd.dispatch_count == P22_STEPS, f"(b) SpmdPipelineTrainer ran "
          f"{spmd.dispatch_count} member runs in {P22_STEPS} steps")
    check(same, "(b) SpmdPipelineTrainer at one pipe member is not bitwise "
          "PipelineTrainer's")
    four = max(float(np.abs(sp[n] - pp_p[n]).max()) for n in sp)
    out["spmd_one_member"] = {"dispatch_count": spmd.dispatch_count,
                              "bitwise_pipeline_trainer": True,
                              "max_diff_vs_four_stages": four}
    # pipeline_apply over {"pipe": 1} against the stage, microbatch by
    # microbatch
    stage_fn = p22_stage_fn(torch)
    params, x = p22_stacked(torch, np, 1)
    y = pipeline_apply(stage_fn, params, x, make_mesh({"pipe": 1}, [card]),
                       num_microbatches=P22_MLP_MICRO)
    mb = x.shape[0] // P22_MLP_MICRO
    seq = torch.cat([stage_fn({k: v[0] for k, v in params.items()},
                              x[j * mb:(j + 1) * mb])
                     for j in range(P22_MLP_MICRO)])
    check(torch.equal(y, seq), "(b) pipeline_apply at one pipe member is "
          "not bitwise the sequential stage")
    out["pipeline_apply_one_member"] = {"bitwise_sequential": True}
    log("  (b) " + json.dumps(out))
    return out


def p22_two_cards(torch, np, mx, fa, nn_ops, fu, launches):
    """(c) where two cards exist: the LM through PipelineTrainer over both
    cards, SpmdPipelineTrainer (the MLP) and pipeline_apply over
    ``{"pipe": 2}``, each against the same work on one card."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import (PipelineTrainer,
                                          SpmdPipelineTrainer, make_mesh,
                                          pipeline_apply)
    if DEVICE == "cuda" and torch.cuda.device_count() < 2:
        log(f"  (c) not run: {torch.cuda.device_count()} CUDA device(s); "
            "pipelines over distinct cards need two")
        return {"run": False, "devices": torch.cuda.device_count()}
    ctx = mx.gpu if DEVICE == "cuda" else mx.cpu
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    batch = lm_batch(np, seed=320)
    out = {"run": True}
    runs = {}
    for label, devices in (("one", [ctx(0), ctx(0)]),
                           ("two", [ctx(0), ctx(1)])):
        pp = p22_bind(PipelineTrainer(sym, num_stages=2, devices=devices,
                                      num_microbatches=2, optimizer="adam",
                                      optimizer_params=dict(LM_OPT),
                                      compute_dtype="bfloat16"),
                      shapes, args)
        before = p22_read(fa, nn_ops, fu)
        heads, ms, _ = p22_steps(torch, pp, [batch, batch])
        after = p22_read(fa, nn_ops, fu)
        if label == "two":
            for k in ("flash_attn_fwd", "flash_attn_bwd"):
                launches[k] += after[k] - before[k]
        runs[label] = (heads, p22_host(torch, pp), ms)
        del pp
    (h1, p1, ms1), (h2, p2, ms2) = runs["one"], runs["two"]
    head_diff = max(float((a - b).abs().max()) for a, b in zip(h1, h2))
    param_diff = max(float(np.abs(p1[n] - p2[n]).max()) for n in p1)
    check(head_diff <= P22_HEAD_TOL and param_diff <= P22_UPDATE_LIMIT * 2,
          f"(c) the LM over two cards: heads {head_diff}, parameters "
          f"{param_diff} from one card's")
    out["lm"] = {"heads_max_diff": head_diff, "params_max_diff": param_diff,
                 "step_ms_two": ms2, "step_ms_one": ms1}
    net = p22_mlp_net(mx)
    mshapes, margs, mbatches = p22_mlp_data(np, net)
    kw = dict(num_stages=2, num_microbatches=P22_MLP_MICRO, optimizer="sgd",
              optimizer_params=dict(P22_MLP_OPT))
    spmd = p22_bind(SpmdPipelineTrainer(net, devices=[ctx(0), ctx(1)], **kw),
                    mshapes, margs)
    host = p22_bind(PipelineTrainer(net, devices=[ctx(0), ctx(0)], **kw),
                    mshapes, margs)
    diff = 0.0
    for b in mbatches:
        diff = max(diff, float((spmd.step(b)[0].cpu()
                                - host.step(b)[0].cpu()).abs().max()))
    sp, hp = p22_host(torch, spmd), p22_host(torch, host)
    pdiff = max(float(np.abs(sp[n] - hp[n]).max()) for n in hp)
    check(diff <= P22_MLP_TOL and pdiff <= P22_MLP_TOL,
          f"(c) SpmdPipelineTrainer over two cards: heads {diff}, "
          f"parameters {pdiff} from one card's")
    out["spmd"] = {"heads_max_diff": diff, "params_max_diff": pdiff,
                   "dispatch_count": spmd.dispatch_count}
    stage_fn = p22_stage_fn(torch)
    params, x = p22_stacked(torch, np, 2)
    y = pipeline_apply(stage_fn, params, x,
                       make_mesh({"pipe": 2}, [ctx(0), ctx(1)]),
                       num_microbatches=P22_MLP_MICRO)
    seq = x
    for s in range(2):
        seq = stage_fn({k: v[s] for k, v in params.items()}, seq)
    adiff = float((y - seq).abs().max())
    check(adiff <= P22_MLP_TOL, f"(c) pipeline_apply over two cards "
          f"{adiff} from one card's stages")
    out["pipeline_apply"] = {"max_diff": adiff,
                             "bitwise": bool(torch.equal(y, seq))}
    log(f"  (c) two cards: {json.dumps(out)}")
    return out


def p22_combined_mesh(torch, np, mx, fa, launches):
    """(d) where four cards exist: phase 9's LM trainer over ``{"model":
    2, "seq": 2}`` with ``megatron_rules`` (each model coordinate's seq
    group runs the ring over its local heads, K3/K4 on each visiting
    block) for ``P22_COMBINED_STEPS`` steps against the same trainer on
    one card, the first step held as phase 20 (c) holds two cards.  A
    mesh's members are distinct contexts, so one card cannot hold it."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import make_mesh, megatron_rules
    if DEVICE == "cuda" and torch.cuda.device_count() < 4:
        log(f"  (d) not run: {torch.cuda.device_count()} CUDA device(s); "
            "a {\"model\": 2, \"seq\": 2} mesh needs four distinct cards")
        return {"run": False, "devices": torch.cuda.device_count()}
    ctx = mx.gpu if DEVICE == "cuda" else mx.cpu
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    batches = [lm_batch(np, seed=330 + i) for i in range(P22_COMBINED_STEPS)]

    def run(tr):
        heads, ms, _ = p22_steps(torch, tr, batches[:1])
        first = p22_host(torch, tr)
        more, ms_more, _ = p22_steps(torch, tr, batches[1:])
        return heads + more, first, ms + ms_more

    h1, p1, ms1 = run(p20_trainer(torch, np, sym, args,
                                  make_mesh({"data": 1}, [ctx(0)])))
    four = p20_trainer(torch, np, sym, args,
                       make_mesh({"model": 2, "seq": 2},
                                 [ctx(i) for i in range(4)]),
                       rules=megatron_rules())
    check(four._tp_plan.plan == "split", f"(d) plan {four._tp_plan.plan}: "
          f"{four._tp_plan.reason}")
    before = p20_kernel_counts(fa)
    h4, p4, ms4 = run(four)
    p20_sync(torch)
    ran = {k: v - before[k] for k, v in p20_kernel_counts(fa).items()}
    p20_add(launches, fa, before)
    del four
    check(all(v > 0 for v in ran.values()), f"(d) the ring's kernels did "
          f"not launch: {ran}")
    heads = [float((a - b).abs().max()) for a, b in zip(h1, h4)]
    step1 = max(float(np.abs(p1[n] - p4[n]).max()) for n in p1)
    check(heads[0] <= P20_TP_HEAD_TOL, f"(d) the LM over {{model: 2, seq: "
          f"2}}: first heads {heads[0]} from one card's, over "
          f"{P20_TP_HEAD_TOL}")
    check(step1 <= P20_TP_STEP1_LIMIT, f"(d) the LM over {{model: 2, seq: "
          f"2}}: first update {step1} from one card's, over "
          f"{P20_TP_STEP1_LIMIT}")
    check(all(bool(torch.isfinite(h).all()) for h in h4),
          "(d) non-finite heads over four cards")
    out = {"run": True, "heads_max_diff_by_step": heads,
           "step1_max_param_diff": step1, "launches": ran,
           "step_ms_four": ms4, "step_ms_one": ms1}
    log(f"  (d) four cards: {json.dumps(out)}")
    return out


def phase_pipelines(torch, np, mx, fa, nn_ops, fu, _build):
    """Phase 22: (a) the LM through PipelineTrainer (4 stages on the
    card) against ShardedTrainer, (b) the dryrun's MLP through the three
    pipelines, (c) pipelines over two cards where there are two, (d) the
    LM over a ``{"model": 2, "seq": 2}`` mesh where there are four cards;
    builds no kernel.  Returns the K1/K3/K4 launches of its main runs and
    its numbers."""
    t_phase = time.perf_counter()
    built, compile_ = [], _build._compile

    def counting(jobs):
        built.extend(n for n, (_, dst) in jobs.items() if not dst.exists())
        return compile_(jobs)

    _build._compile = counting
    launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "softmax_rows": 0}
    out = {"card": card_line()}
    try:
        t0 = time.perf_counter()
        out["lm"] = p22_lm(torch, np, mx, fa, nn_ops, fu, launches)
        out["lm"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["mlp"] = p22_mlp(torch, np, mx, fa, nn_ops, fu, launches)
        out["mlp"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["two_cards"] = p22_two_cards(torch, np, mx, fa, nn_ops, fu,
                                         launches)
        out["two_cards"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["combined_mesh"] = p22_combined_mesh(torch, np, mx, fa,
                                                 launches)
        out["combined_mesh"]["seconds"] = time.perf_counter() - t0
    finally:
        _build._compile = compile_
    check(not built, f"phase 22 built kernels: {built}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("  pipelines: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# Phase 23: the multi-process tier (parameter server, launch, a data mesh
# that spans processes)
# ---------------------------------------------------------------------------

# (a) the reference nightly's integer pattern: init 1, every worker pushes
# (rank + 1) * RATE REPEAT times a key; the big key (2 MiB) is above the
# default BIGARRAY_BOUND (1 MiB), so it is striped over both servers
P23_WORKERS, P23_SERVERS = 2, 2
P23_AGG = dict(small=(3, 3), big=(1024, 512), rate=2, repeat=3)
# (b) phase 7's ResNet-50 through FeedForward.fit: each worker takes its
# contiguous half of one data set of 3 global batches of BATCH
P23_BATCHES = 3
# the workers' final parameters against the one-process sum of the two
# halves' gradients under the same SGD, both under deterministic cuDNN
# (the same calls on the same shapes): within f32 rounding, 1e-5
P23_RESNET_ATOL = 1e-5
# (c) phase 9's LM through ShardedTrainer over a data mesh of 2 processes
# against one process on the global batch (bf16 compute, Adam lr 1e-3):
# the ranks' parameters bitwise equal; each rank's loss over its rows
# within P23_LM_LOSS_RTOL relative at every step; at most the share
# P23_LM_SHARE[1] of the parameters more than P23_LM_SHARE[0] from the
# one-process run (two members' bf16 products round otherwise than one
# member's, and an element whose gradient is that noise flips its Adam
# step).  Adam's step does not see the gradient's scale, so the
# reduction's scale is held by the BatchNorm net below, under SGD
P23_LM_STEPS = 3
P23_LM_LOSS_RTOL = 2e-4
P23_LM_SHARE = (1e-4, 0.05)
# (c) then, in the same processes, a BatchNorm net with a softmax head
# and a global head (a sum over the global batch): the batch moments,
# the normalization's count and the global head meet across the
# processes, the global head's gradient crosses back.  f32, SGD at
# rate LR, the first process's rows shifted by 2 (its moments differ).
# Against one process on the global batch: each parameter's and moving
# statistic's largest difference over the largest move of the
# one-process run from the initial value within P23_BN_RTOL, the heads
# within P23_BN_HEAD_RTOL relative
P23_BN = dict(batch=64, inp=1024, hidden=1024, classes=1000, steps=3,
              lr=0.1)
P23_BN_RTOL = 1e-3
P23_BN_HEAD_RTOL = 1e-4
# each child program's time limit (seconds)
P23_TIMEOUT = {"kv-sync": 300, "kv-async": 120, "lm": 300, "pm": 300}


def p23_plan(device):
    """What every child program of phase 23 runs: the device and the
    sizes (the parent's constants, so that a rehearsal that shrinks them
    shrinks the children too)."""
    return {"device": device, "agg": P23_AGG, "depth": DEPTH,
            "classes": CLASSES, "image": list(IMAGE), "batch": BATCH,
            "batches": P23_BATCHES, "train_opt": TRAIN_OPT,
            "lm": dict(vocab=VOCAB, layers=LAYERS, d_model=D_MODEL,
                       heads=HEADS, batch=LM_BATCH, seq=LM_SEQ,
                       opt=LM_OPT, steps=P23_LM_STEPS),
            "bn": P23_BN,
            "lm_cards": [0, 0]}


def p23_images(np, plan, rows):
    """Rows ``rows`` of phase 23's synthetic data set: sample k drawn
    from its own seed, so a worker can make its half alone."""
    shape = tuple(plan["image"])
    x = np.empty((len(rows),) + shape, np.float32)
    y = np.empty(len(rows), np.float32)
    for i, k in enumerate(rows):
        rng = np.random.RandomState(23000 + k)
        x[i] = rng.uniform(-1.0, 1.0, shape)
        y[i] = rng.randint(0, plan["classes"])
    return x, y


def p23_resnet(plan):
    """Phase 7's ResNet-50 under a fresh name manager: a child and this
    process (which built other symbols before) name its nodes alike."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.name import NameManager
    with NameManager():
        return models.get_symbol("resnet", num_classes=plan["classes"],
                                 depth=plan["depth"])


def p23_lm_symbol(plan):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.name import NameManager
    lm = plan["lm"]
    with NameManager():
        return models.get_symbol(
            "transformer-lm", vocab_size=lm["vocab"],
            num_layers=lm["layers"], d_model=lm["d_model"],
            heads=lm["heads"], batch_size=lm["batch"], seq_len=lm["seq"],
            loss_head=True)


def p23_lm_state(np, plan, sym):
    lm = plan["lm"]
    shapes = dict(data=(lm["batch"], lm["seq"]),
                  softmax_label=(lm["batch"], lm["seq"]))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    toks = np.random.RandomState(0).randint(0, lm["vocab"],
                                            (lm["batch"], lm["seq"] + 1))
    batch = {"data": toks[:, :-1].astype(np.float32),
             "softmax_label": toks[:, 1:].astype(np.float32)}
    return shapes, args, batch


def p23_bn_symbol(plan):
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.name import NameManager
    bn = plan["bn"]
    with NameManager():
        h = S.FullyConnected(data=S.Variable("data"),
                             num_hidden=bn["hidden"], no_bias=True,
                             name="fc1")
        h = S.BatchNorm(data=h, fix_gamma=False, name="bn1")
        h = S.Activation(data=h, act_type="relu", name="relu1")
        h = S.FullyConnected(data=h, num_hidden=bn["classes"], name="fc2")
        soft = S.SoftmaxOutput(data=h, normalization="batch",
                               name="softmax")
        total = S.MakeLoss(S.sum(S.square(h), name="sq_sum")
                           * (1.0 / (bn["batch"] * bn["classes"])),
                           name="glob")
        return S.Group([soft, total])


def p23_bn_state(np, plan, sym):
    """(shapes, initial parameters and aux states, the global batches)."""
    bn = plan["bn"]
    shapes = dict(data=(bn["batch"], bn["inp"]),
                  softmax_label=(bn["batch"],))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=23)
    rng = np.random.RandomState(23)
    batches = []
    for _ in range(bn["steps"]):
        x = rng.randn(bn["batch"], bn["inp"]).astype(np.float32)
        x[:bn["batch"] // 2] += 2.0
        batches.append({"data": x, "softmax_label": rng.randint(
            0, bn["classes"], bn["batch"]).astype(np.float32)})
    return shapes, args, aux, batches


def p23_bn_train(torch, np, mx, plan, rows, **where):
    """The BatchNorm net's SGD steps through a ShardedTrainer placed by
    ``where`` (``mesh=`` or ``device=``) on rows ``rows`` of each global
    batch.  Returns (its parameters and aux states on the host, each
    step's heads on the host)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = p23_bn_symbol(plan)
    shapes, args, aux, batches = p23_bn_state(np, plan, sym)
    tr = ShardedTrainer(sym, optimizer="sgd",
                        optimizer_params={"learning_rate":
                                          plan["bn"]["lr"]}, **where)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]},
            arg_params=args, aux_params=aux)
    heads = []
    for b in batches:
        heads.append([h.float().cpu() for h in tr.step(
            {k: v[rows] for k, v in b.items()})])
    arg, auxp = tr.get_params()
    state = {k: v.data.cpu() for k, v in list(arg.items())
             + list(auxp.items())}
    del tr
    return state, heads


def p23_counts():
    """The K1-K4 launch counts of this process."""
    from mxnet_tpu_torch.ops import fused_update as fu
    from mxnet_tpu_torch.ops import nn_ops
    from mxnet_tpu_torch.parallel import flash_attention as fa
    return {"softmax_rows": nn_ops.softmax_rows.launches,
            "fused_update": fu.fused_update.launches,
            "flash_attn_fwd": fa.flash_fwd.launches,
            "flash_attn_bwd": fa.flash_bwd.launches,
            "forms": {"softmax_rows": dict(
                nn_ops.softmax_rows.launches_by_form),
                "fused_update": dict(fu.fused_update.launches_by_form),
                "flash_attn_fwd": dict(fa.flash_fwd.launches_by_form),
                "flash_attn_bwd": dict(fa.flash_bwd.launches_by_form)}}


def p23_sync(torch, plan):
    if plan["device"] == "cuda":
        torch.cuda.synchronize()


# -- the child programs (python3 chip_smoke.py --dist-worker JOB DIR) --

def p23_aggregate(np, mx, kv, plan, ctx):
    """(a): integer pushes on the card through the ``test`` optimizer on
    the servers (``w += g``); every pulled value bitwise the closed
    form, which counts each push applied once."""
    agg = plan["agg"]
    kv.set_optimizer(mx.optimizer.create("test"))
    kv.init("agg_small", mx.nd.ones(tuple(agg["small"]), ctx=ctx))
    kv.init("agg_big", mx.nd.ones(tuple(agg["big"]), ctx=ctx))
    rank, n = kv.rank, kv.num_workers
    for _ in range(agg["repeat"]):
        for key in ("agg_small", "agg_big"):
            kv.push(key, mx.nd.ones(tuple(agg[key[4:]]), ctx=ctx)
                    * ((rank + 1) * agg["rate"]))
    if kv.type == "dist_async":
        kv.barrier()    # every worker's pushes were applied
    # each push applied once: init 1 + rate * repeat * sum(rank + 1)
    want = n * (n + 1) / 2 * agg["rate"] * agg["repeat"] + 1
    for key in ("agg_small", "agg_big"):
        out = mx.nd.zeros(tuple(agg[key[4:]]), ctx=ctx)
        kv.pull(key, out=out)
        got = out.asnumpy()
        check(out.context == ctx and got.dtype == np.float32
              and bool((got == want).all()),
              f"(a) {kv.type}: {key} pulled {np.unique(got)[:4]}, the "
              f"closed form is {want}")
    return {"closed_form": want, "pushes_a_key": n * agg["repeat"]}


def p23_fit(torch, np, mx, kv, plan, ctx, out):
    """(b): ResNet-50 through FeedForward.fit over the dist_sync store,
    SGD on the servers; this worker's contiguous half of the data set.
    Returns its numbers; writes its final parameters."""
    from mxnet_tpu_torch import telemetry
    sym = p23_resnet(plan)
    half = plan["batch"] // kv.num_workers
    nrows = half * plan["batches"]
    x, y = p23_images(np, plan, range(kv.rank * nrows,
                                       (kv.rank + 1) * nrows))
    shapes = dict(data=(half,) + tuple(plan["image"]),
                  softmax_label=(half,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    cpu = mx.cpu()
    model = mx.FeedForward(
        sym, ctx=ctx, num_epoch=1, optimizer="sgd", numpy_batch_size=half,
        arg_params={k: mx.nd.array(v, ctx=cpu) for k, v in args.items()},
        aux_params={k: mx.nd.array(v, ctx=cpu) for k, v in aux.items()},
        **plan["train_opt"])
    # the training thread's time inside the store (push enqueues, pull
    # waits on the wire and the servers: the card idles)
    in_store = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                in_store[0] += time.perf_counter() - t0
        return run

    kv.push, kv.pull = timed(kv.push), timed(kv.pull)
    marks = []

    def batch_end(_):
        p23_sync(torch, plan)
        marks.append((time.perf_counter(), in_store[0],
                      telemetry.counter("dist.push_bytes").value(),
                      telemetry.counter("dist.pull_bytes").value()))

    it = mx.io.NDArrayIter(x, y, batch_size=half)
    p23_sync(torch, plan)
    marks.append((time.perf_counter(), in_store[0],
                  telemetry.counter("dist.push_bytes").value(),
                  telemetry.counter("dist.pull_bytes").value()))
    model.fit(X=it, kvstore=kv, batch_end_callback=batch_end)
    torch.save({k: v.data.cpu() for k, v in model.arg_params.items()},
               os.path.join(out, f"resnet_rank{kv.rank}.pt"))
    rows = []
    for (t0, s0, pu0, pl0), (t1, s1, pu1, pl1) in zip(marks, marks[1:]):
        rows.append({"ms": (t1 - t0) * 1e3,
                     "host_share": (s1 - s0) / (t1 - t0),
                     "pushed_bytes": pu1 - pu0, "pulled_bytes": pl1 - pl0})
    return {"batches": rows, "images": len(x)}


def p23_kv_job(torch, np, mx, plan, out, kind):
    ctx = mx.gpu(0) if plan["device"] == "cuda" else mx.cpu()
    kv = mx.kvstore.create(kind)    # a server or the scheduler exits here
    res = {"rank": kv.rank, "aggregate": p23_aggregate(np, mx, kv, plan,
                                                       ctx)}
    if kind == "dist_sync":
        # held to the parent's run of the same convolutions: cuDNN's
        # default backward is not deterministic
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        res["fit"] = p23_fit(torch, np, mx, kv, plan, ctx, out)
    kv.close()
    res["counts"] = p23_counts()
    return res


def p23_lm_job(torch, np, mx, plan, out):
    """(c): the LM through ShardedTrainer over a data mesh of every
    process's member; this process's rows of the global batch."""
    from mxnet_tpu_torch.parallel import ShardedTrainer, dist, make_mesh
    from mxnet_tpu_torch.parallel.collectives import count_collectives
    rank = int(os.environ["MXTPU_PROC_ID"])
    dev = (mx.gpu(plan["lm_cards"][rank]) if plan["device"] == "cuda"
           else mx.cpu())
    dist.init_distributed(device=dev)
    mesh = make_mesh({"data": -1})
    sym = p23_lm_symbol(plan)
    shapes, args, batch = p23_lm_state(np, plan, sym)
    tr = ShardedTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        compute_dtype="bfloat16", mesh=mesh)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    n = plan["lm"]["batch"] // dist.process_count()
    mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    step_ms, losses, reduced = [], [], []
    for _ in range(plan["lm"]["steps"]):
        p23_sync(torch, plan)
        t0 = time.perf_counter()
        with count_collectives() as st:
            heads = tr.step(mine)
        p23_sync(torch, plan)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(heads[0].float().sum()))
        reduced.append(sum(r["nbytes"] for r in st.records
                           if r["kind"] == "process"))
    torch.save({k: v.data.cpu() for k, v in tr.get_params()[0].items()},
               os.path.join(out, f"lm_rank{rank}.pt"))
    del tr
    counts = p23_counts()
    res = {"rank": rank, "backend": dist.backend(), "step_ms": step_ms,
           "loss_sums": losses, "rows": n * plan["lm"]["seq"],
           "reduced_bytes": reduced, "counts": counts}
    half = plan["bn"]["batch"] // dist.process_count()
    state, heads = p23_bn_train(torch, np, mx, plan,
                                slice(rank * half, (rank + 1) * half),
                                mesh=mesh)
    torch.save({"state": state, "heads": heads},
               os.path.join(out, f"bn_rank{rank}.pt"))
    after = p23_counts()
    res["bn_counts"] = {k: after[k] - counts[k] for k in after
                        if k != "forms"}
    dist.shutdown()
    return res


def dist_worker(job, out):
    """``--dist-worker JOB DIR``: one child program of phase 23
    (``kv-sync``, ``kv-async`` under ``launch_local`` in every role,
    ``lm`` as a rank of a process group) or of phase 24 (``wd-hung``,
    ``wd-dead``, ``wd-monitor`` as a rank of a process group with the
    watchdog on, ``el-chaos`` in every role of a ``tools/torch_launch.py``
    cluster, ``el-sigterm`` alone) or of phase 28 (``pm`` as a rank of a
    process group).  Its output goes to a log in ``DIR``, ending with its
    exit code unless the process ends itself (the watchdog's
    ``os._exit(70)``, a planted death); a result is its ``P23 {json}`` or
    ``P24 {json}`` line."""
    role = os.environ.get("MXTPU_ROLE") or (
        "rank" + os.environ.get("MXTPU_PROC_ID", "?"))
    tag = f"{job}-{role}-{os.environ.get('MXTPU_WORKER_ID', os.getpid())}"
    fd = os.open(os.path.join(out, tag + ".log"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    code = 1
    try:
        import numpy as np
        import torch
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import mxnet_tpu_torch as mx
        # float32 products stay full float32, as in the parent
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(os.path.join(out, "plan.json")) as f:
            plan = json.load(f)
        if job.startswith("wd-"):
            res = p24_wd_job(torch, np, mx, plan, out, job[3:])
        elif job == "el-chaos":
            res = p24_chaos_job(torch, np, mx, plan, out)
        elif job == "el-sigterm":
            res = p24_sigterm_job(torch, np, mx, plan, out)
        elif job == "lm":
            res = p23_lm_job(torch, np, mx, plan, out)
        elif job == "pm":
            res = p28_job(torch, np, mx, plan, out)
        else:
            res = p23_kv_job(torch, np, mx, plan, out,
                             "dist_" + job.split("-")[1])
        if res is not None:
            res["foreign"] = p24_foreign()
            tag = ("P23 " if job in ("lm", "kv-sync", "kv-async", "pm")
                   else "P24 ")
            print(tag + json.dumps(res), flush=True)
        code = 0
    except SystemExit as exc:   # a server or the scheduler left its loop
        code = exc.code or 0
    except BaseException:       # reported in the log the parent prints
        import traceback
        traceback.print_exc()
    finally:
        print(f"exit code {code}", flush=True)
    return code


# -- the parent --

def p23_logs(out, job):
    """Every child log of ``job`` in ``out``: {name: text}."""
    return {n: open(os.path.join(out, n)).read()
            for n in sorted(os.listdir(out))
            if n.startswith(job + "-") and n.endswith(".log")}


def p23_fail(out, job, why, phase=23):
    for name, text in p23_logs(out, job).items():
        log(f"  --- {name} ---")
        log(text[-6000:])
    raise SmokeFailure(f"phase {phase} {job}: {why}")


def p23_results(out, job, n, phase=23):
    res = []
    for name, text in p23_logs(out, job).items():
        lines = [ln for ln in text.splitlines() if ln.startswith("P23 ")]
        if lines:
            res.append(json.loads(lines[-1][4:]))
    res.sort(key=lambda r: r["rank"])
    if [r["rank"] for r in res] != list(range(n)):
        p23_fail(out, job, f"results from ranks {[r['rank'] for r in res]}",
                 phase)
    for r in res:
        if r["foreign"]:
            p23_fail(out, job, f"a child imported {r['foreign']}", phase)
    return res


def p23_launch(out, job, env):
    """``launch_local`` of ``job`` (1 scheduler, the servers and the
    workers) under its time limit; a child's failure fails the phase."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.launch import launch_local
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        codes = launch_local(
            [sys.executable, os.path.abspath(__file__), "--dist-worker", job,
             out], num_workers=P23_WORKERS, num_servers=P23_SERVERS,
            root_port=p23_free_port(), timeout=P23_TIMEOUT[job],
            return_codes=True)
    except MXNetError as exc:
        p23_fail(out, job, str(exc))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if codes != [0] * P23_WORKERS:
        p23_fail(out, job, f"worker exit codes {codes}")
    return p23_results(out, job, P23_WORKERS)


def p23_free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def p23_spawn_ranks(out, job, env, n=2, phase=23):
    """``n`` ranks of ``job`` as fresh interpreters with the rendezvous
    environment; each under ``P23_TIMEOUT[job]``, all killed past it; a
    failure names ``phase``."""
    timeout = P23_TIMEOUT[job]
    port = p23_free_port()
    procs = []
    for rank in range(n):
        e = dict(env, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                 MXTPU_NUM_PROC=str(n), MXTPU_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker", job,
             out], env=e, stdin=subprocess.DEVNULL))
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for rank, p in enumerate(procs):
            try:
                codes.append(p.wait(timeout=max(0.0, deadline
                                                - time.monotonic())))
            except subprocess.TimeoutExpired:
                p23_fail(out, job, f"rank {rank} did not finish within "
                         f"{timeout} s", phase)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * n:
        p23_fail(out, job, f"rank exit codes {codes}", phase)
    return p23_results(out, job, n, phase)


def p23_child_env():
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return {"PYTHONPATH": here if not path else here + os.pathsep + path}


def p23_resnet_reference(torch, np, mx, plan, ctx):
    """(b)'s one-process run: the same initial weights; a step's
    gradients of the two workers' batches, each through an executor on
    the card, summed on the host as the server sums them (``a + b``
    commutes), and the servers' SGD applied on the host."""
    from mxnet_tpu_torch import optimizer as opt_mod
    sym = p23_resnet(plan)
    half, steps = plan["batch"] // P23_WORKERS, plan["batches"]
    shapes = dict(data=(half,) + tuple(plan["image"]),
                  softmax_label=(half,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    ex = sym.simple_bind(ctx, **shapes)
    for k, v in aux.items():
        ex.aux_dict[k][:] = v
    names = [n for n in sym.list_arguments() if n in args]
    opt = opt_mod.create("sgd", rescale_grad=1.0 / (half * P23_WORKERS),
                         param_idx2name=dict(enumerate(names)),
                         **plan["train_opt"])
    update = opt_mod.get_updater(opt)
    cpu = mx.cpu()
    weights = {n: mx.nd.array(args[n], ctx=cpu) for n in names}
    for j in range(steps):
        grads = None
        for w in range(P23_WORKERS):
            base = w * half * steps + j * half
            x, y = p23_images(np, plan, range(base, base + half))
            for n in names:
                ex.arg_dict[n][:] = weights[n].asnumpy()
            ex.forward(is_train=True, data=x, softmax_label=y)
            ex.backward()
            g = {n: ex.grad_dict[n].asnumpy() for n in names}
            grads = g if grads is None else {n: grads[n] + g[n]
                                             for n in names}
        for i, n in enumerate(names):
            update(i, mx.nd.array(grads[n], ctx=cpu), weights[n])
    return {n: weights[n].data for n in names}


def p23_lm_reference(torch, np, mx, plan):
    """(c)'s one-process run: ShardedTrainer on the global batch, on
    one card (a device without an index would take every card)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = p23_lm_symbol(plan)
    shapes, args, batch = p23_lm_state(np, plan, sym)
    tr = ShardedTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        compute_dtype="bfloat16",
                        device="cuda:0" if DEVICE == "cuda" else DEVICE)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    placed = tr.place_batch(batch)
    step_ms, heads = [], []
    for _ in range(plan["lm"]["steps"]):
        p23_sync(torch, plan)
        t0 = time.perf_counter()
        h = tr.step(placed)[0]
        p23_sync(torch, plan)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        heads.append(h.float().cpu())
    params = {k: v.data.cpu() for k, v in tr.get_params()[0].items()}
    del tr
    return params, heads, step_ms


def p23_lm_compare(torch, plan, ranks, ref, heads, out, label):
    """The ranks agree bitwise; each rank's loss over its rows and its
    parameters against the one-process run (P23_LM_* tolerances)."""
    loaded = [torch.load(os.path.join(out, f"lm_rank{r['rank']}.pt"))
              for r in ranks]
    for n in loaded[0]:
        check(torch.equal(loaded[0][n], loaded[1][n]),
              f"(c) {label}: the ranks' {n} differ")
    far, total, worst = 0, 0, 0.0
    for n, want in ref.items():
        d = (loaded[0][n].float() - want.float()).abs()
        far += int((d > P23_LM_SHARE[0]).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    share = far / total
    check(share <= P23_LM_SHARE[1],
          f"(c) {label}: {share:.4%} of the parameters are more than "
          f"{P23_LM_SHARE[0]} from the one-process run")
    rel = []
    for r in ranks:
        rows = r["rows"]
        for s, h in enumerate(heads):
            want = float(h[r["rank"] * rows:(r["rank"] + 1) * rows].sum())
            rel.append(abs(r["loss_sums"][s] - want) / abs(want))
    check(max(rel) <= P23_LM_LOSS_RTOL,
          f"(c) {label}: a rank's step loss is {max(rel)} from the "
          "one-process run's")
    return {"max_param_diff": worst, "share_beyond_1e-4": share,
            "max_loss_rel": max(rel)}


def p23_bn_compare(torch, plan, ranks, ref, out, label):
    """The ranks' BatchNorm net bitwise equal; its parameters, moving
    statistics and heads against the one-process run (P23_BN_*)."""
    got = [torch.load(os.path.join(out, f"bn_rank{r['rank']}.pt"))
           for r in ranks]
    for n in got[0]["state"]:
        check(torch.equal(got[0]["state"][n], got[1]["state"][n]),
              f"(c) {label}, BatchNorm net: the ranks' {n} differ")
    (state, heads), init = ref
    worst = {}
    for n, want in state.items():
        moved = float((want - init[n]).abs().max())
        check(moved > 0, f"(c) {label}, BatchNorm net: {n} did not move")
        worst[n] = float((got[0]["state"][n] - want).abs().max()) / moved
    name = max(worst, key=worst.get)
    check(worst[name] <= P23_BN_RTOL,
          f"(c) {label}, BatchNorm net: {name} is {worst[name]} of its "
          f"move from the one-process run")
    half = plan["bn"]["batch"] // len(ranks)
    head_rel = 0.0
    for r, g in zip(ranks, got):
        rows = slice(r["rank"] * half, (r["rank"] + 1) * half)
        for mine, want in zip(g["heads"], heads):
            pairs = [(mine[0], want[0][rows]), (mine[1], want[1])]
            for a, b in pairs:
                check(a.shape == b.shape,
                      f"(c) {label}, BatchNorm net: a head of shape "
                      f"{tuple(a.shape)}, the one-process run's "
                      f"{tuple(b.shape)}")
                head_rel = max(head_rel, float((a - b).abs().max())
                               / float(b.abs().max()))
    check(head_rel <= P23_BN_HEAD_RTOL,
          f"(c) {label}, BatchNorm net: a head is {head_rel} (relative) "
          "from the one-process run's")
    return {"bn_worst_over_move": worst[name], "bn_worst": name,
            "bn_head_rel": head_rel}


def p23_add(launches, counts):
    for k in launches:
        launches[k] += counts[k]


def p23_parameter_server(torch, np, mx, plan, out, env, launches, stats):
    """(a) and (b) in one dist_sync cluster, then (a) over dist_async."""
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    t0 = time.perf_counter()
    kv = p23_launch(out, "kv-sync", env)
    stats["kv_seconds"] = time.perf_counter() - t0
    for r in kv:
        p23_add(launches, r["counts"])
        check(r["counts"]["softmax_rows"] == plan["batches"]
              or DEVICE != "cuda",
              f"(b) worker {r['rank']}: K1 launched "
              f"{r['counts']['softmax_rows']} times in "
              f"{plan['batches']} batches")
    stats["aggregate"] = kv[0]["aggregate"]
    fits = [r["fit"]["batches"] for r in kv]
    later = [b for rows in fits for b in rows[1:]]
    stats["fit"] = {
        "first_batch_ms": [rows[0]["ms"] for rows in fits],
        "ms_a_batch": float(np.median([b["ms"] for b in later])),
        "host_share": float(np.median([b["host_share"] for b in later])),
        "pushed_bytes_a_batch": float(np.median(
            [b["pushed_bytes"] for b in later])),
        "pulled_bytes_a_batch": float(np.median(
            [b["pulled_bytes"] for b in later]))}
    got = [torch.load(os.path.join(out, f"resnet_rank{r}.pt"))
           for r in range(P23_WORKERS)]
    for n in got[0]:
        check(torch.equal(got[0][n], got[1][n]),
              f"(b) the workers' {n} differ")
    before = p23_counts()
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ref = p23_resnet_reference(torch, np, mx, plan, ctx)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    after = p23_counts()
    p23_add(launches, {k: after[k] - before[k] for k in launches})
    diffs = sorted(((float((got[0][n] - ref[n]).abs().max()), n)
                    for n in ref), reverse=True)
    diff = diffs[0][0]
    bitwise = all(torch.equal(got[0][n], ref[n]) for n in ref)
    check(diff <= P23_RESNET_ATOL,
          f"(b) the workers' parameters are {diff} from the one-process "
          f"run (largest: {diffs[:3]})")
    stats["fit"].update(max_param_diff=diff, bitwise=bitwise)
    t0 = time.perf_counter()
    kva = p23_launch(out, "kv-async", env)
    stats["async"] = dict(kva[0]["aggregate"],
                          seconds=time.perf_counter() - t0)


def p23_collective(torch, np, mx, plan, out, env, launches, stats,
                   layouts):
    """(c): the one-process run, then the ranks in each layout (label,
    each rank's card, the backend it must take)."""
    before = p23_counts()
    ref, heads, ref_ms = p23_lm_reference(torch, np, mx, plan)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    sym = p23_bn_symbol(plan)
    _, args, aux, _ = p23_bn_state(np, plan, sym)
    init = {k: torch.from_numpy(v) for k, v in {**args, **aux}.items()}
    bn_ref = (p23_bn_train(torch, np, mx, plan, slice(None),
                           device="cuda:0" if DEVICE == "cuda"
                           else DEVICE), init)
    after = p23_counts()
    p23_add(launches, {k: after[k] - before[k] for k in launches})
    stats["lm"] = {"one_process_step_ms": ref_ms}
    for label, cards, backend in layouts:
        plan["lm_cards"] = cards
        with open(os.path.join(out, "plan.json"), "w") as f:
            json.dump(plan, f)
        t0 = time.perf_counter()
        ranks = p23_spawn_ranks(out, "lm", env)
        for r in ranks:
            check(r["backend"] == backend,
                  f"(c) {label}: rank {r['rank']} ran {r['backend']}, "
                  f"expected {backend}")
            c, steps = r["counts"], plan["lm"]["steps"]
            if DEVICE == "cuda":
                check(c["flash_attn_fwd"] == c["flash_attn_bwd"]
                      == plan["lm"]["layers"] * steps
                      and c["fused_update"] == steps,
                      f"(c) {label}: rank {r['rank']} launched {c}")
                check(c["forms"]["flash_attn_fwd"]["hopper"]
                      == c["flash_attn_fwd"]
                      and c["forms"]["fused_update"]["hopper"] == steps,
                      f"(c) {label}: forms {c['forms']}")
            p23_add(launches, c)
            b = r["bn_counts"]
            check(DEVICE != "cuda"
                  or b["softmax_rows"] == b["fused_update"]
                  == plan["bn"]["steps"],
                  f"(c) {label}: rank {r['rank']}'s BatchNorm net "
                  f"launched {b}")
            p23_add(launches, b)
        row = p23_lm_compare(torch, plan, ranks, ref, heads, out, label)
        row.update(p23_bn_compare(torch, plan, ranks, bn_ref, out, label))
        row.update(
            backend=backend, seconds=time.perf_counter() - t0,
            step_ms=[r["step_ms"] for r in ranks],
            ms_a_step=float(np.median([ms for r in ranks
                                       for ms in r["step_ms"][1:]])),
            reduced_bytes_a_step=ranks[0]["reduced_bytes"][-1])
        stats["lm"][label] = row


def phase_multiprocess(torch, np, mx, nn_ops, fu, fa, parts=("ps", "lm")):
    """Phase 23: (a) exact aggregation over the parameter server
    (``launch_local``: 1 scheduler, 2 servers, 2 workers on the card;
    dist_sync, then dist_async), (b) ResNet-50 through FeedForward.fit
    over dist_sync (in (a)'s cluster) against the one-process sum of the
    halves' gradients, (c) the LM through ShardedTrainer over a data mesh
    of 2 processes (gloo on one card; NCCL over two cards where there
    are two) against one process.  ``parts`` picks (a)-(b) ("ps"), (c)
    ("lm") or (c) over two cards alone ("lm-two-cards").  Returns the
    K1-K4 launches of the children's main paths and of this process's
    reference runs, and its numbers."""
    import tempfile
    t_phase = time.perf_counter()
    launches = dict.fromkeys(("softmax_rows", "fused_update",
                              "flash_attn_fwd", "flash_attn_bwd"), 0)
    stats = {"card": card_line() if DEVICE == "cuda" else "cpu"}
    plan = p23_plan(DEVICE)
    env = p23_child_env()
    two = DEVICE == "cuda" and torch.cuda.device_count() > 1
    layouts = ([] if "lm-two-cards" in parts
               else [("one card", [0, 0], "gloo")])
    if two:
        layouts.append(("two cards", [0, 1], "nccl"))
    with tempfile.TemporaryDirectory(prefix="p23-") as out:
        with open(os.path.join(out, "plan.json"), "w") as f:
            json.dump(plan, f)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        if "ps" in parts:
            p23_parameter_server(torch, np, mx, plan, out, env, launches,
                                 stats)
        if layouts:
            p23_collective(torch, np, mx, plan, out, env, launches, stats,
                           layouts)
        if not two:
            stats.setdefault("lm", {})["two cards"] = "not run: one card"
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log("  multi-process tier: " + json.dumps(stats))
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 24: the multi-process tier, part two -- the collective tier's
# watchdog on the card, ElasticTrainer under membership chaos, SIGTERM
# inside a step, and a live resize where two cards exist
# ---------------------------------------------------------------------------
# (a) three ranks over gloo on the card (phase 23 (c)'s layout), the
# watchdog at a probed port with a short beat: a beat every 0.5 s, a peer
# silent for 2.5 s is dead.  A survivor exits 70 within P24_WD["timeout"]
# + P24_WD_GRACE of the fault: the grace holds the stale check's period
# (0.5 s), the default on_failure's 0.5 s wait and the process's exit
P24_WD = {"interval": 0.5, "timeout": 2.5}
P24_WD_GRACE = 4.0
# (a)1 trains phase 9's LM over the three processes: its global batch is
# cut to a multiple of 3 (2 rows a rank); rank 2 freezes after 2 steps
P24_HUNG_BATCH, P24_HUNG_STEPS = 6, 2
# how long an idle rank of (a)2/(a)3 waits for the watchdog to end it
P24_IDLE = 60.0
# (b) 4 members of capacity 1 started through tools/torch_launch.py;
# the trainer takes 8 steps, member 1 kills itself at the trainer's step 3
# (MXNET_TPU_CHAOS=worker_kill:3); the trainer waits at most
# P24_VIEW_WAIT s for the kill to show in the membership view
P24_CHAOS = dict(workers=4, capacity=1, steps=8, kill_at=3, kill_worker=1)
P24_VIEW_WAIT = 60.0
# (c) SIGTERM lands inside update 4; the fresh trainer takes 2 more steps
P24_SIGTERM = dict(at=4, more=2)
# (d) resized 2 -> 1 -> 2 over two cards, 2 steps a segment
P24_RESIZE_STEPS = 2
P24_TIMEOUT = {"wd-hung": 240, "wd-dead": 120, "wd-monitor": 120,
               "el-chaos": 300, "el-sigterm": 240}


def p24_plan(device):
    """Phase 23's plan with phase 24's knobs (children read both)."""
    plan = p23_plan(device)
    plan["p24"] = {"wd": P24_WD, "hung_batch": P24_HUNG_BATCH,
                   "hung_steps": P24_HUNG_STEPS, "idle": P24_IDLE,
                   "chaos": P24_CHAOS, "view_wait": P24_VIEW_WAIT,
                   "sigterm": P24_SIGTERM}
    return plan


def p24_batch(np, plan, i):
    """Step i's batch of the LM (its own seed), ``plan``'s batch rows."""
    lm = plan["lm"]
    toks = np.random.RandomState(2400 + i).randint(
        0, lm["vocab"], (lm["batch"], lm["seq"] + 1))
    return {"data": toks[:, :-1].astype(np.float32),
            "softmax_label": toks[:, 1:].astype(np.float32)}


def p24_card(mx, plan):
    return mx.gpu(0) if plan["device"] == "cuda" else mx.cpu(0)


def p24_foreign():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))


def p24_say(tag, obj):
    """A line the parent reads from the child's log, flushed at once."""
    print(f"{tag} {json.dumps(obj)}", flush=True)


def p24_write(out, name, obj):
    tmp = os.path.join(out, f"{name}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(out, name))


def p24_wait_file(path, seconds, proc=None):
    """Wait for ``path``; False past ``seconds`` or once ``proc`` ended."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline or (proc is not None
                                           and proc.poll() is not None):
            return False
        time.sleep(0.01)
    return True


def p24_lm_trainer(torch, mx, plan, sym, mesh, **kw):
    """Phase 9's trainer (Adam, bf16 compute) over ``mesh``."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    return ShardedTrainer(sym, optimizer="adam",
                          optimizer_params=dict(plan["lm"]["opt"]),
                          compute_dtype="bfloat16", mesh=mesh, **kw)


def p24_host(tr):
    """A trainer's parameters on the host."""
    return {k: v.data.cpu() for k, v in tr.get_params()[0].items()}


def p24_steps(torch, np, plan, tr, lo, hi):
    """Steps lo..hi-1 of ``tr`` on their batches: the first head of each
    on the host, and each step's ms."""
    heads, ms = [], []
    for i in range(lo, hi):
        batch = p24_batch(np, plan, i)
        p23_sync(torch, plan)
        t0 = time.perf_counter()
        h = tr.step(batch)[0]
        p23_sync(torch, plan)
        ms.append((time.perf_counter() - t0) * 1e3)
        heads.append(h.detach().float().cpu())
    return heads, ms


def p24_same(torch, a, b):
    """Two lists of tensors (or dicts of them) bitwise equal."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                              for k in a)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- the child programs --

def p24_wd_job(torch, np, mx, plan, out, case):
    """(a): a rank of three over gloo on the card, the watchdog on
    (``MXTPU_WATCHDOG``, phase 24's beat, the default ``on_failure``; an
    ``on_death`` observer prints who died).  ``hung``: the ranks train
    the LM over a data mesh of the three processes and rank 2 freezes
    itself (SIGSTOP) after step 2; ``dead``/``monitor``: the ranks meet
    once, then idle outside any collective while rank 2, or rank 0 (the
    monitor), exits silently."""
    import logging
    import signal
    from mxnet_tpu_torch.parallel import dist, make_mesh
    logging.basicConfig(level=logging.WARNING)
    p24 = plan["p24"]
    rank = int(os.environ["MXTPU_PROC_ID"])
    dist.init_distributed(device=p24_card(mx, plan), watchdog=dict(
        p24["wd"], on_death=lambda r: p24_say("P24-DEATH",
                                             {"rank": rank, "dead": r})))
    p24_say("P24-UP", {"rank": rank, "backend": dist.backend(),
                       "watchdog": list(dist._watchdog.monitor_addr),
                       "foreign": p24_foreign()})
    victim = 0 if case == "monitor" else 2
    if case == "hung":
        lm = dict(plan, lm=dict(plan["lm"], batch=p24["hung_batch"]))
        sym = p23_lm_symbol(lm)
        shapes, args, _ = p23_lm_state(np, lm, sym)
        tr = p24_lm_trainer(torch, mx, lm, sym, make_mesh({"data": -1}))
        tr.bind({"data": shapes["data"]},
                {"softmax_label": shapes["softmax_label"]}, arg_params=args)
        n = p24["hung_batch"] // dist.process_count()
        for i in range(p24["hung_steps"] + 1):
            if i == p24["hung_steps"]:
                # every rank's launches so far: a survivor never returns
                p24_say("P24-COUNTS", {"rank": rank,
                                       "counts": p23_counts()})
                if rank == victim:
                    p24_write(out, "fault-hung", {"time": time.time()})
                    os.kill(os.getpid(), signal.SIGSTOP)
            batch = p24_batch(np, lm, i)
            tr.step({k: v[rank * n:(rank + 1) * n]
                     for k, v in batch.items()})
            p23_sync(torch, plan)
        return {"rank": rank, "survived": True}
    import torch.distributed as tdist
    tdist.barrier()
    p24_write(out, f"idle-{case}-{rank}", {})
    if rank == victim:
        for r in range(dist.process_count()):
            if not p24_wait_file(os.path.join(out, f"idle-{case}-{r}"),
                                 p24["idle"]):
                raise SmokeFailure(f"rank {r} never went idle")
        p24_write(out, f"fault-{case}", {"time": time.time()})
        os._exit(1)     # silent death, no goodbye
    deadline = time.monotonic() + p24["idle"]
    while time.monotonic() < deadline:
        time.sleep(0.05)
    return {"rank": rank, "survived": True}


def p24_member(plan, wid):
    """(b): a capacity member: joins, beats, kills itself when the chaos
    spec targets it and the trainer's published step reaches the point,
    leaves when the view closes."""
    import signal
    from mxnet_tpu_torch import chaos
    from mxnet_tpu_torch.parallel.dist_kvstore import MembershipClient
    spec = chaos.elastic_from_env()
    kill_at = (min(spec.points["worker_kill"])
               if spec is not None and chaos.chaos_worker() == int(wid)
               and "worker_kill" in spec.points else None)
    client = MembershipClient(member_id=wid,
                              capacity=plan["p24"]["chaos"]["capacity"])
    client.start()
    deadline = time.monotonic() + P24_TIMEOUT["el-chaos"]
    while time.monotonic() < deadline:
        view = client.view
        if view is not None:
            step = max([m["progress"] for m in view["members"].values()]
                       or [0])
            if kill_at is not None and step >= kill_at:
                print(f"worker {wid}: chaos worker_kill at trainer step "
                      f"{step}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            if view["closing"]:
                client.leave()
                client.close()
                return {"rank": int(wid), "foreign": p24_foreign()}
        time.sleep(0.02)
    raise SmokeFailure(f"member {wid}: the view never closed")


def p24_chaos_trainer(torch, np, mx, plan, out):
    """(b): the trainer: an ElasticTrainer on the card (ZeRO, phase 9's
    LM) over the membership view; after the chaos step it waits until the
    kill shows in the view.  Then a plain ShardedTrainer (ZeRO) on the
    same weights and batches, in this process."""
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import ElasticTrainer, make_mesh
    from mxnet_tpu_torch.parallel.dist_kvstore import MembershipClient
    c, wait = plan["p24"]["chaos"], plan["p24"]["view_wait"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    client = MembershipClient(member_id="0", capacity=c["capacity"]).start()
    if client.wait_for(lambda v: len(v["members"]) >= c["workers"],
                       timeout=wait) is None:
        raise SmokeFailure("the members never assembled")
    epoch0 = client.epoch
    sym = p23_lm_symbol(plan)
    shapes, args, _ = p23_lm_state(np, plan, sym)
    card = p24_card(mx, plan)
    mgr = CheckpointManager(os.path.join(out, "chaos-ckpt"))
    et = ElasticTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        manager=mgr, membership=client, devices=[card],
                        trainer_kwargs={"shard_optimizer": True,
                                        "compute_dtype": "bfloat16"})
    et.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]})
    et.trainer.set_params(args)
    heads, ms, members, builds = [], [], None, None
    for i in range(c["steps"]):
        h, t = p24_steps(torch, np, plan, et, i, i + 1)
        heads += h
        ms += t
        if i == 0:
            builds = _build.build_count()
        client.set_progress(i + 1)
        client.beat_now()   # the step clock reaches the members at once
        if i + 1 == c["kill_at"]:
            view = client.wait_for(
                lambda v: len(v["members"]) < c["workers"], timeout=wait)
            if view is None:
                raise SmokeFailure(f"the kill never showed in the view "
                                   f"within {wait} s")
            members = len(view["members"])
    params = p24_host(et.trainer)
    res = {"rank": 0, "num_update": et.num_update, "epoch_initial": epoch0,
           "epoch_final": client.epoch, "members_after_kill": members,
           "generation": et.generation, "resizes": et.resizes,
           "size": et.size, "step_ms": ms}
    et.shutdown(final=True)
    mgr.close()
    client.close()
    plain = p24_lm_trainer(torch, mx, plan, sym,
                           make_mesh({"data": 1}, [card]),
                           shard_optimizer=True)
    plain.bind({"data": shapes["data"]},
               {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    plain.compile()
    p_heads, p_ms = p24_steps(torch, np, plan, plain, 0, c["steps"])
    res.update(plain_step_ms=p_ms,
               heads_bitwise=p24_same(torch, heads, p_heads),
               params_bitwise=p24_same(torch, params, p24_host(plain)),
               builds_after_step1=_build.build_count() - builds,
               counts=p23_counts(), foreign=p24_foreign())
    return res


def p24_chaos_job(torch, np, mx, plan, out):
    """(b) in every role of the cluster: the scheduler's membership
    views, the trainer (worker 0), the capacity members."""
    from mxnet_tpu_torch.parallel.dist_kvstore import (role_from_env,
                                                       run_scheduler)
    cfg = role_from_env()
    if cfg.get("role") == "scheduler":
        run_scheduler(cfg)
        return None
    wid = os.environ["MXTPU_WORKER_ID"]
    if wid == "0":
        return p24_chaos_trainer(torch, np, mx, plan, out)
    return p24_member(plan, wid)


def p24_sigterm_job(torch, np, mx, plan, out):
    """(c): an ElasticTrainer on the card with the preemption hook
    (``install_preemption_hook(et.save_now, exit_after=True)``); inside
    update 4 it reports the point (a file) and goes on once the SIGTERM
    was handled, which defers the save to the step's end and exits."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import ElasticTrainer
    torch.use_deterministic_algorithms(True, warn_only=True)
    s = plan["p24"]["sigterm"]
    sym = p23_lm_symbol(plan)
    shapes, args, _ = p23_lm_state(np, plan, sym)
    mgr = CheckpointManager(os.path.join(out, "sigterm-ckpt"))
    et = ElasticTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        manager=mgr, devices=[p24_card(mx, plan)],
                        trainer_kwargs={"compute_dtype": "bfloat16"})
    mgr.install_preemption_hook(et.save_now, exit_after=True)
    et.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]})
    et.trainer.set_params(args)
    tr = et.trainer
    fill = tr._fill_step_scalars

    def fill_and_report():
        fill()
        if tr._num_update == s["at"]:
            p24_write(out, "sigterm-inside", {"update": tr._num_update})
            deadline = time.monotonic() + P24_TIMEOUT["el-sigterm"]
            while not mgr.preempted and time.monotonic() < deadline:
                time.sleep(0.005)   # the handler runs between these

    tr._fill_step_scalars = fill_and_report
    try:
        p24_steps(torch, np, plan, et, 0, s["at"] + s["more"])
    except SystemExit:
        p24_say("P24", {"rank": 0, "update": tr._num_update,
                        "counts": p23_counts(), "foreign": p24_foreign()})
        raise
    p24_say("P24-SURVIVED", {"update": tr._num_update})
    return None


# -- the parent --

def p24_lines(out, job, tag):
    """Every ``tag {json}`` line of ``job``'s child logs, by log name."""
    got = {}
    for name, text in p23_logs(out, job).items():
        got[name] = [json.loads(ln[len(tag) + 1:])
                     for ln in text.splitlines()
                     if ln.startswith(tag + " ")]
    return got


def p24_fail(out, job, why):
    for name, text in p23_logs(out, job).items():
        log(f"  --- {name} ---")
        log(text[-6000:])
    raise SmokeFailure(f"phase 24 {job}: {why}")


def p24_wd_spawn(out, env, case):
    """(a) one case: three ranks with the watchdog at a probed port, the
    monitor's flight dumps in their own directory."""
    job = "wd-" + case
    victim = 0 if case == "monitor" else 2
    port = p23_free_port()
    wd_port = p23_free_port()
    while wd_port == port:
        wd_port = p23_free_port()
    run = {"case": case, "job": job, "victim": victim,
           "survivors": [r for r in range(3) if r != victim],
           "flight": os.path.join(out, "flight-" + job), "procs": [],
           "exit_at": {}, "t0": time.perf_counter()}
    for rank in range(3):
        e = dict(os.environ, **env, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                 MXTPU_NUM_PROC="3", MXTPU_PROC_ID=str(rank),
                 MXTPU_WATCHDOG=f"127.0.0.1:{wd_port}",
                 MXNET_TPU_FLIGHTREC=run["flight"])
        run["procs"].append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker", job,
             out], env=e, stdin=subprocess.DEVNULL))
    return run


def p24_wd_wait(out, runs):
    """Poll every rank of ``runs`` (each rank's exit time on this host's
    clock) until each run's survivors have exited; past a run's time
    limit the phase fails naming the ranks still running.  Every rank
    still alive at the end is killed (the frozen rank of (a)1 too)."""
    deadline = {id(r): time.monotonic() + P24_TIMEOUT[r["job"]]
                for r in runs}
    try:
        while not all(all(i in r["exit_at"] for i in r["survivors"])
                      for r in runs):
            for r in runs:
                for i, p in enumerate(r["procs"]):
                    if i not in r["exit_at"] and p.poll() is not None:
                        r["exit_at"][i] = time.time()
                left = [i for i in r["survivors"] if i not in r["exit_at"]]
                if left and time.monotonic() > deadline[id(r)]:
                    p24_fail(out, r["job"], f"ranks {left} still ran after "
                             f"{P24_TIMEOUT[r['job']]} s")
            time.sleep(0.01)
    finally:
        for r in runs:
            for p in r["procs"]:
                if p.poll() is None:
                    p.kill()
                p.wait()
            r["seconds"] = time.perf_counter() - r["t0"]


def p24_wd_check(out, run, launches):
    """(a) one case's verdict: each survivor exited 70 within the
    watchdog's timeout plus the grace of the fault, its log naming the
    dead rank; the monitor's flight dump exists where the monitor lives.
    Returns the case's numbers."""
    import glob
    job, case, victim = run["job"], run["case"], run["victim"]
    survivors, exit_at = run["survivors"], run["exit_at"]
    codes = [p.returncode for p in run["procs"]]
    fault = os.path.join(out, "fault-" + case)
    if not os.path.exists(fault):
        p24_fail(out, job, f"no fault was planted (exit codes {codes})")
    with open(fault) as f:
        t_fault = json.load(f)["time"]
    secs = {r: exit_at[r] - t_fault for r in survivors}
    limit = P24_WD["timeout"] + P24_WD_GRACE
    for r in survivors:
        if codes[r] != 70 or not 0 < secs[r] <= limit:
            p24_fail(out, job, f"rank {r} exited {codes[r]} {secs[r]:.3f} s "
                     f"after the fault (70 within {limit} s expected)")
    logs = p23_logs(out, job)
    ups = p24_lines(out, job, "P24-UP")
    deaths = p24_lines(out, job, "P24-DEATH")
    for r in range(3):
        name = [n for n in logs if n.startswith(f"{job}-rank{r}-")]
        if len(name) != 1:
            p24_fail(out, job, f"rank {r} left logs {name}")
        up = ups[name[0]]
        if not up or up[0]["foreign"] or up[0]["backend"] != "gloo":
            p24_fail(out, job, f"rank {r} started as {up}")
        if r not in survivors:
            continue
        text = logs[name[0]]
        if f"peer rank {victim} declared DEAD" not in text:
            p24_fail(out, job, f"rank {r}'s log does not name rank {victim}")
        # the monitor's verdict and an abort frame reach on_death; the
        # monitor's own death reaches on_failure alone
        if case != "monitor" and [d["dead"] for d in deaths[name[0]]] \
                != [victim]:
            p24_fail(out, job, f"rank {r}'s on_death saw "
                     f"{deaths[name[0]]}")
    dumps = sorted(glob.glob(os.path.join(
        run["flight"], "flightrec-watchdog-peer-death-*.json")))
    if case != "monitor":
        if len(dumps) != 1:
            p24_fail(out, job, f"the monitor's flight dumps: {dumps}")
        with open(dumps[0]) as f:
            extra = json.load(f)["extra"]
        if extra["dead_rank"] != victim or extra["rank"] != 0:
            p24_fail(out, job, f"the flight dump says {extra}")
    if case == "hung":
        counts = p24_lines(out, job, "P24-COUNTS")
        for name, lines in counts.items():
            if len(lines) != 1:
                p24_fail(out, job, f"{name} reported counts {lines}")
            p23_add(launches, lines[0]["counts"])
    return {"exit_codes": codes, "fault_to_exit_s": secs,
            "fault_to_last_exit_s": max(secs.values()),
            "flight_dumps": [os.path.basename(d) for d in dumps],
            "seconds": run["seconds"]}


def p24_chaos(torch, out, env, launches):
    """(b) the cluster through tools/torch_launch.py under its time
    limit (past it the launcher's process group is killed)."""
    import signal
    job = "el-chaos"
    c = P24_CHAOS
    here = os.path.dirname(os.path.abspath(__file__))
    e = dict(os.environ, **env, MXNET_TPU_CHAOS=f"worker_kill:{c['kill_at']}",
             MXNET_TPU_CHAOS_WORKER=str(c["kill_worker"]),
             MXNET_TPU_ELASTIC_HEARTBEAT_MS="100")
    cmd = [sys.executable, os.path.join(here, "tools", "torch_launch.py"),
           "-n", str(c["workers"]), "-s", "0", "--launcher", "local",
           "--root-port", str(p23_free_port()), sys.executable,
           os.path.abspath(__file__), "--dist-worker", job, out]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=e, stdin=subprocess.DEVNULL,
                            start_new_session=True)
    try:
        code = proc.wait(timeout=P24_TIMEOUT[job])
    except subprocess.TimeoutExpired:
        code = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)     # stragglers included
        except ProcessLookupError:
            pass
        proc.wait()
    if code is None:
        p24_fail(out, job, f"the cluster did not finish within "
                 f"{P24_TIMEOUT[job]} s")
    if code != 0:
        p24_fail(out, job, f"tools/torch_launch.py exited {code}")
    res = {}
    for name, lines in p24_lines(out, job, "P24").items():
        for r in lines:
            res[r["rank"]] = r
    killed = c["kill_worker"]
    want = [r for r in range(c["workers"]) if r != killed]
    if sorted(res) != want:
        p24_fail(out, job, f"results from members {sorted(res)}")
    logs = p23_logs(out, job)
    kill_log = [t for n, t in logs.items()
                if n.startswith(f"{job}-worker-{killed}")]
    if len(kill_log) != 1 or "chaos worker_kill" not in kill_log[0] \
            or "exit code" in kill_log[0]:
        p24_fail(out, job, f"member {killed} did not kill itself")
    tr = res[0]
    for r in res.values():
        if r["foreign"]:
            p24_fail(out, job, f"member {r['rank']} imported {r['foreign']}")
    ok = (tr["num_update"] == c["steps"]
          and tr["epoch_final"] > tr["epoch_initial"]
          and tr["members_after_kill"] == c["workers"] - 1
          and tr["generation"] == 1 and tr["resizes"] == []
          and tr["size"] == 1)
    if not ok:
        p24_fail(out, job, f"the trainer ended as {tr}")
    if not (tr["heads_bitwise"] and tr["params_bitwise"]):
        p24_fail(out, job, "the elastic run is not bitwise the plain "
                 f"trainer's: heads {tr['heads_bitwise']}, parameters "
                 f"{tr['params_bitwise']}")
    if tr["builds_after_step1"]:
        p24_fail(out, job, f"{tr['builds_after_step1']} kernel libraries "
                 "built after step 1")
    p23_add(launches, tr["counts"])
    return {"seconds": time.perf_counter() - t0,
            "epoch": [tr["epoch_initial"], tr["epoch_final"]],
            "ms_a_step": float(sorted(tr["step_ms"][1:])[
                len(tr["step_ms"][1:]) // 2]),
            "plain_ms_a_step": float(sorted(tr["plain_step_ms"][1:])[
                len(tr["plain_step_ms"][1:]) // 2]),
            "step_ms": tr["step_ms"], "plain_step_ms": tr["plain_step_ms"]}


def p24_sigterm(torch, np, mx, plan, out, env, launches):
    """(c) the child under SIGTERM inside update 4, then a fresh
    ShardedTrainer here restored from its save against the uninterrupted
    run (this process, the same settings, run while the child starts)."""
    import signal
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import make_mesh
    job = "el-sigterm"
    s = P24_SIGTERM
    before = p23_counts()
    sym = p23_lm_symbol(plan)
    shapes, args, _ = p23_lm_state(np, plan, sym)
    mesh = make_mesh({"data": 1}, [p24_card(mx, plan)])
    bind = ({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]})
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", job,
         out], env=dict(os.environ, **env), stdin=subprocess.DEVNULL)
    try:
        # the uninterrupted run and the trainer that resumes, while the
        # child starts and steps (it waits inside update 4 for the signal)
        straight = p24_lm_trainer(torch, mx, plan, sym, mesh)
        straight.bind(*bind, arg_params=args)
        straight.compile()
        want, _ = p24_steps(torch, np, plan, straight, 0,
                            s["at"] + s["more"])
        want_params = p24_host(straight)
        del straight
        fresh = p24_lm_trainer(torch, mx, plan, sym, mesh, seed=11)
        fresh.bind(*bind)
        fresh.compile()
        if not p24_wait_file(os.path.join(out, "sigterm-inside"),
                             P24_TIMEOUT[job], proc):
            p24_fail(out, job, "the child never reported update "
                     f"{s['at']} (exit {proc.poll()})")
        proc.send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        code = proc.wait(timeout=P24_TIMEOUT[job])
        exit_s = time.perf_counter() - t0
    except subprocess.TimeoutExpired:
        p24_fail(out, job, f"the child outlived {P24_TIMEOUT[job]} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(p23_logs(out, job).values())
    if code != 128 + signal.SIGTERM or "P24-SURVIVED" in text:
        p24_fail(out, job, f"the child exited {code}")
    if f"asked for inside update {s['at']}; deferred" not in text:
        p24_fail(out, job, "the save was not deferred to the step's end")
    mgr = CheckpointManager(os.path.join(out, "sigterm-ckpt"))
    if mgr.all_steps() != [s["at"]]:
        p24_fail(out, job, f"committed steps {mgr.all_steps()}")
    child = [r for lines in p24_lines(out, job, "P24").values()
             for r in lines]
    if len(child) != 1 or child[0]["foreign"] \
            or child[0]["update"] != s["at"]:
        p24_fail(out, job, f"the child reported {child}")
    p23_add(launches, child[0]["counts"])
    _, step = fresh.restore_state(mgr)
    mgr.close()
    got, ms = p24_steps(torch, np, plan, fresh, s["at"],
                        s["at"] + s["more"])
    check(step == s["at"], f"(c) restored update {step}")
    check(p24_same(torch, got, want[s["at"]:])
          and p24_same(torch, p24_host(fresh), want_params),
          "(c) the resumed steps are not bitwise the uninterrupted run's")
    after = p23_counts()
    p23_add(launches, {k: after[k] - before[k] for k in launches})
    return {"exit_code": code, "sigterm_to_exit_s": exit_s,
            "saved_update": step, "resumed_step_ms": ms}


def p24_resize(torch, np, mx, plan, out, cards, launches):
    """(d) the LM with ZeRO through ElasticTrainer over two cards,
    resized 2 -> 1 -> 2: each post-resize segment bitwise a fresh
    ShardedTrainer on that mesh restored from the resize's snapshot."""
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import ElasticTrainer, make_mesh
    before = p23_counts()
    k = P24_RESIZE_STEPS
    sym = p23_lm_symbol(plan)
    shapes, args, _ = p23_lm_state(np, plan, sym)
    bind = ({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]})
    kw = {"shard_optimizer": True, "compute_dtype": "bfloat16"}
    mgr = CheckpointManager(os.path.join(out, "resize-ckpt"))
    et = ElasticTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        manager=mgr, devices=cards, trainer_kwargs=kw)
    et.bind(*bind)
    et.trainer.set_params(args)
    p24_steps(torch, np, plan, et, 0, k)
    segs = []
    for n in (1, 2):
        rec = et.resize(n)
        heads, ms = p24_steps(torch, np, plan, et, len(segs) * k + k,
                              len(segs) * k + 2 * k)
        segs.append((n, rec, heads, ms))
    rows = []
    for i, (n, rec, heads, ms) in enumerate(segs):
        lo = (i + 1) * k
        check(rec["steps_lost"] == 0 and rec["retraces"] == 0
              and rec["num_update"] == lo,
              f"(d) the resize to {n} card(s) recorded {rec}")
        fresh = p24_lm_trainer(torch, mx, plan, sym,
                               make_mesh({"data": n}, cards[:n]),
                               shard_optimizer=True, seed=7 + n)
        fresh.bind(*bind)
        _, step = fresh.restore_state(mgr, step=lo)
        ref, _ = p24_steps(torch, np, plan, fresh, lo, lo + k)
        check(step == lo and p24_same(torch, heads, ref),
              f"(d) the segment on {n} card(s) is not bitwise a fresh "
              "trainer restored from the resize's snapshot")
        rows.append({k2: rec[k2] for k2 in ("direction", "from_devices",
                                            "to_devices", "drain_ms",
                                            "restore_ms", "pause_ms",
                                            "steps_lost", "retraces")})
        rows[-1]["step_ms"] = ms
    mgr.close()
    after = p23_counts()
    p23_add(launches, {k2: after[k2] - before[k2] for k2 in launches})
    return rows


def phase_elastic(torch, np, mx, parts=("a", "b", "c", "d")):
    """Phase 24: (a) the watchdog on the card (a hung, a dead and a
    monitor rank), (b) ElasticTrainer under membership chaos through
    tools/torch_launch.py, (c) SIGTERM inside a step, (d) a live resize
    2 -> 1 -> 2 where two cards exist.  Returns the K1-K4 launches of the
    children's main paths and of this process's runs, and its numbers."""
    import tempfile
    t_phase = time.perf_counter()
    launches = dict.fromkeys(("softmax_rows", "fused_update",
                              "flash_attn_fwd", "flash_attn_bwd"), 0)
    stats = {"card": card_line() if DEVICE == "cuda" else "cpu",
             "watchdog": dict(P24_WD, grace=P24_WD_GRACE)}
    plan = p24_plan(DEVICE)
    env = p23_child_env()
    det = torch.are_deterministic_algorithms_enabled()
    # the embedding's scatter-add on the card is deterministic only in
    # this mode, and (b)-(d) are held bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(prefix="p24-") as out:
            with open(os.path.join(out, "plan.json"), "w") as f:
                json.dump(plan, f)
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
            if "a" in parts:
                # the hung case trains alone; the two idle cases at once
                for cases in (("hung",), ("dead", "monitor")):
                    runs = [p24_wd_spawn(out, env, c) for c in cases]
                    p24_wd_wait(out, runs)
                    for r in runs:
                        stats[f"(a) {r['case']}"] = p24_wd_check(
                            out, r, launches)
            if "b" in parts:
                stats["(b)"] = p24_chaos(torch, out, env, launches)
            if "c" in parts:
                t0 = time.perf_counter()
                stats["(c)"] = p24_sigterm(torch, np, mx, plan, out, env,
                                           launches)
                stats["(c)"]["seconds"] = time.perf_counter() - t0
            cards = ([mx.gpu(0), mx.gpu(1)]
                     if DEVICE == "cuda" and torch.cuda.device_count() > 1
                     else [mx.cpu(0), mx.cpu(1)] if DEVICE == "cpu"
                     else None)
            if "d" in parts and cards is not None:
                t0 = time.perf_counter()
                stats["(d)"] = p24_resize(torch, np, mx, plan, out, cards,
                                          launches)
                stats["(d) seconds"] = time.perf_counter() - t0
            elif "d" in parts:
                stats["(d)"] = ("not run: one card (a mesh's members are "
                                "distinct cards, so the largest mesh here "
                                "has one member and no resize can happen)")
    finally:
        torch.use_deterministic_algorithms(det)
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log("  multi-process tier, part two: " + json.dumps(stats))
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 25: the analysis tooling on the card -- the concurrency sanitizer
# over the framework's threads, the schedule fuzzer, the static gate
# ---------------------------------------------------------------------------

# (a): phase 9's LM at full width and batch, depth cut to 2 layers, its
# step captured; P25_STEPS steps fed by the prefetcher, each followed by
# an async save of the CUDA parameters
P25_LAYERS = 2
P25_STEPS = 4
# (b): seeded interleavings a scenario on the card
P25_SEEDS = 2
# (c): the gate's child process
P25_GATE_TIMEOUT = 300


def p25_counts(fa, fu, fd):
    return {"fused_update": fu.fused_update.launches,
            "flash_attn_fwd": fa.flash_fwd.launches,
            "flash_attn_bwd": fa.flash_bwd.launches,
            "flash_decode": fd.flash_decode_attention.launches}


def p25_reset(fa, fu, fd):
    reset_train_counts(fu.fused_update, fa.flash_fwd, fa.flash_bwd)
    reset_decode_counts(fd)


def p25_patched():
    """What an audit window patches: the threading primitives, the queue,
    ``time.sleep``, ``open``, and the framework singletons' locks and
    shared containers that ``instrument_framework`` wraps."""
    import builtins
    import queue
    from mxnet_tpu_torch import compile_cache, telemetry
    fr, reg = telemetry.flight_recorder(), telemetry.registry()
    cache = compile_cache.get_cache()
    return [threading.Lock, threading.RLock, threading.Condition,
            threading.Event, threading.Thread, queue.Queue, time.sleep,
            builtins.open, fr._lock, fr._ring, reg._lock, reg._metrics,
            cache._lock, cache._mem]


def p25_restored(before, what):
    after = p25_patched()
    check(len(after) == len(before)
          and all(a is b for a, b in zip(after, before)),
          f"{what}: the audit window left patches behind: "
          f"{[str(a) for a, b in zip(after, before) if a is not b]}")


def p25_framework(torch, np, mx, analysis, tmp):
    """(a): the LM's captured step with an async CheckpointManager saving
    its CUDA parameters after every step, a DevicePrefetchIter feeding it
    and the flight recorder recording, under ``audit_threads`` with the
    framework instrumented; every restored checkpoint byte-identical to
    the tensors at its ``save()``.  Returns the report and its numbers."""
    from mxnet_tpu_torch import models, telemetry
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.io import DevicePrefetchIter, NDArrayIter
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=P25_LAYERS, d_model=D_MODEL,
                            heads=HEADS, batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    tr = ShardedTrainer(sym, optimizer="adam",
                        optimizer_params=dict(LM_OPT),
                        compute_dtype="bfloat16", fused_update=True,
                        device=DEVICE)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    rows = [lm_batch(np, seed=i) for i in range(P25_STEPS)]
    data = np.concatenate([r["data"] for r in rows])
    label = np.concatenate([r["softmax_label"] for r in rows])
    flight = telemetry.flight_recorder()
    want, losses, save_ms = {}, [], []
    t0 = time.perf_counter()
    with analysis.audit_threads(instrument_framework=True) as audit:
        # the capture runs inside the window: the patched primitives must
        # not break it
        info = tr.compile(programs=("train",))[0]
        check(info["source"] == "capture",
              f"(a) the LM's step resolved {info}, not a capture")
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"),
                                keep_last=P25_STEPS + 1, async_write=True)
        it = DevicePrefetchIter(NDArrayIter(data, label,
                                            batch_size=LM_BATCH),
                                place_fn=tr.place_batch, device=DEVICE)
        for step, batch in enumerate(it):
            heads = tr.step(batch)
            ts = time.perf_counter()
            mgr.save(step, dict(tr._params))
            save_ms.append((time.perf_counter() - ts) * 1e3)
            # the saved tensors as they were at save(): the next step's
            # replay (K2) writes them in place
            want[step] = {n: v.detach().cpu().numpy().tobytes()
                          for n, v in tr._params.items()}
            losses.append(float(heads[0].float().mean()))
            telemetry.record_step({"step": step, "loss": losses[-1]})
        it.close()
        mgr.wait_until_finished()
    seconds = time.perf_counter() - t0
    check(len(want) == P25_STEPS, f"(a) {len(want)} steps, expected "
          f"{P25_STEPS}")
    check(all(np.isfinite(losses)), f"(a) non-finite loss {losses}")
    check(tr.aot_stats["hits"] == P25_STEPS,
          f"(a) {tr.aot_stats}: not every step replayed the capture")
    for step, tensors in want.items():
        got, _meta, s = mgr.restore(step)
        check(s == step and set(got) == set(tensors),
              f"(a) checkpoint {step} restored {s} with {sorted(got)[:3]}")
        for n, raw in tensors.items():
            check(np.ascontiguousarray(got[n]).tobytes() == raw,
                  f"(a) checkpoint {step}: {n} is not byte-identical to "
                  "the tensor at its save()")
    mgr.close()
    recorded = [r for r in flight.records() if "loss" in r]
    check(len(recorded) == P25_STEPS,
          f"(a) the flight ring holds {len(recorded)} step records")
    rep = audit.report
    m = rep.metrics.get("races", {})
    check(rep.clean, "(a) the framework's threads report findings:\n"
          + rep.format_text())
    check(m.get("events", 0) > 0 and m.get("threads", 0) >= 2,
          f"(a) the audit saw {m}: expected events and at least 2 threads")
    n_bytes = sum(len(b) for b in want[0].values())
    stats = {"seconds": seconds, "losses": losses, "save_ms": save_ms,
             "checkpoint_bytes": n_bytes, "capture_s":
             tr._aot["train"][0].capture_seconds, "races": m,
             "suppressed": [f.format() for f in rep.findings
                            if f.suppressed]}
    log(f"  (a) the LM ({P25_LAYERS} layers at phase 9's width) captured, "
        f"{P25_STEPS} steps from the prefetcher, an async save of "
        f"{n_bytes} bytes after each: every checkpoint byte-identical; "
        f"report clean, {m['events']} events, {m['threads']} threads, "
        f"{m['locations']} tracked locations, {m['races_found']} race(s) "
        f"(at info only), in {seconds:.1f} s")
    return stats


def p25_schedules(analysis):
    """(b): every scenario of the fuzzer on the card, P25_SEEDS seeds
    each; the serve scenarios' routers capture and replay their decode
    steps (K5) and every stream equals the single-threaded reference."""
    res = analysis.run_schedules(n=P25_SEEDS, seed=0, device=DEVICE,
                                 log=lambda s: log("  (b) " + s))
    check(res["ok"], f"(b) schedule failures on the card: "
          f"{json.dumps(res['failures'])}")
    check(len(res["scenarios"]) == 6
          and all(v["runs"] == P25_SEEDS
                  for v in res["scenarios"].values()),
          f"(b) ran {res['scenarios']}")
    return res


def p25_gate():
    """(c): ``tools/torch_staticcheck.py gate --json`` as a child process
    on the shipped tree: exit 0, ``ok``."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_staticcheck.py"),
         "gate", "--json"], capture_output=True, text=True, cwd=root,
        timeout=P25_GATE_TIMEOUT)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"(c) the gate exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout)
    check(out["ok"] and out["corpus"]["failures"] == [],
          f"(c) the gate's report: ok {out['ok']}, "
          f"{out['corpus']['failures']}")
    log(f"  (c) torch_staticcheck gate: exit 0, ok, "
        f"{out['metrics']['lint']['files']} files linted, "
        f"{len(out['corpus']['cases'])} thread cases, in {seconds:.1f} s")
    return {"seconds": seconds, "counts": out["counts"]}


def phase_analysis(torch, np, mx, fa, fu, fd):
    """Phase 25: (a) the framework's threads around the LM's captured
    step under the sanitizer, (b) the schedule fuzzer's six scenarios on
    the card, (c) the static gate.  Returns the K2-K5 launches it adds
    and its numbers."""
    import tempfile
    from mxnet_tpu_torch import analysis
    t_phase = time.perf_counter()
    stats = {"card": card_line() if DEVICE == "cuda" else "cpu"}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="p25-") as tmp:
        p25_reset(fa, fu, fd)
        from mxnet_tpu_torch import telemetry
        telemetry.reset_for_tests()
        before = p25_patched()
        stats["(a)"] = p25_framework(torch, np, mx, analysis, tmp)
        p25_restored(before, "(a)")
        stats["(a)"]["launches"] = p25_counts(fa, fu, fd)
        for name, n in stats["(a)"]["launches"].items():
            launches[name] = launches.get(name, 0) + n
        la = stats["(a)"]["launches"]
        check(la["fused_update"] >= P25_STEPS
              and la["flash_attn_fwd"] >= P25_LAYERS * P25_STEPS
              and la["flash_attn_bwd"] >= P25_LAYERS * P25_STEPS,
              f"(a) launches {la}: the steps did not run K2, K3 and K4")
    p25_reset(fa, fu, fd)
    t0 = time.perf_counter()
    res = p25_schedules(analysis)
    p25_restored(before, "(b)")
    log("  every patch of the audit windows restored after (a) and (b)")
    stats["(b)"] = {"seconds": time.perf_counter() - t0,
                    "scenarios": res["scenarios"],
                    "launches": p25_counts(fa, fu, fd)}
    check(stats["(b)"]["launches"]["flash_decode"] > 0,
          "(b) the serve scenarios' decode steps launched no K5")
    for name, n in stats["(b)"]["launches"].items():
        launches[name] = launches.get(name, 0) + n
    stats["(c)"] = p25_gate()
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  launches added by phase 25: K2 {launches['fused_update']}, K3 "
        f"{launches['flash_attn_fwd']}, K4 {launches['flash_attn_bwd']}, "
        f"K5 {launches['flash_decode']}")
    log("  analysis tooling: " + json.dumps(stats))
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 26: the program auditor on the card
# ---------------------------------------------------------------------------

P26_AUDIT_TIMEOUT = 300


def p26_names(nn_ops, fa, fu, fd):
    """Kernel wrapper -> the name its kernel notes carry."""
    return {nn_ops.softmax_rows: "softmax_rows",
            fu.fused_update: "fused_update", fa.flash_fwd: "flash_fwd",
            fa.flash_bwd: "flash_bwd", fd.flash_decode_attention:
            "flash_decode"}


def p26_counts(nn_ops, fa, fu, fd):
    """The launch counters, by note name (K5 and K5-fp8 together, as one
    note name with a ``quantized`` attribute)."""
    f = fd.flash_decode_attention
    return {"softmax_rows": nn_ops.softmax_rows.launches,
            "fused_update": fu.fused_update.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "flash_decode": f.launches + f.launches_fp8}


def p26_diff(after, before):
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def p26_capture_counts(prog, names):
    """The launches a captured program's capture counted (and took back),
    by note name: its kernel notes must equal these."""
    out = {}
    for fn, attr, key, d in prog._delta:
        if key is None and attr in ("launches", "launches_fp8") \
                and fn in names:
            out[names[fn]] = out.get(names[fn], 0) + d
    return out


def p26_notes_check(rep, label, want, what):
    got = rep.metrics[label]["kernel_notes"]
    check(got == want or DEVICE != "cuda",
          f"{what}: {label}'s kernel notes {got} are not the launches "
          f"{want} of its recorded iteration")


def p26_clean(rep, what):
    errors = rep.unsuppressed("error")
    check(not errors, f"{what}: the audit found errors:\n"
          + rep.format_text())
    return [f.format() for f in rep.unsuppressed("warn")]


def p26_fused_one_pass(rep, label, n_buckets, what):
    per = rep.metrics[label]["hbm_passes"]["per_grad"]
    want = {f"gradbucket:{i}": {"reads": 1, "writes": 1}
            for i in range(n_buckets)}
    check(per == want, f"{what}: {label}'s bucket passes {per}, expected "
          f"1 read / 1 write over each of {n_buckets} buckets")


def p26_lm(torch, np, analysis, cc, names, nn_ops, fa, fu, fd):
    """(a): phase 9's LM at full width, captured under ``audit_on_compile``
    and audited through ``audit_trainer``; two replayed steps bitwise an
    unaudited twin's."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = models.get_symbol("transformer-lm", vocab_size=VOCAB,
                            num_layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                            batch_size=LM_BATCH, seq_len=LM_SEQ,
                            loss_head=True)
    shapes = dict(data=(LM_BATCH, LM_SEQ), softmax_label=(LM_BATCH, LM_SEQ))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, _ = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)

    def trainer():
        tr = ShardedTrainer(sym, optimizer="adam",
                            optimizer_params=dict(LM_OPT),
                            compute_dtype="bfloat16", fused_update=True,
                            device=DEVICE)
        return tr.bind({"data": shapes["data"]},
                       {"softmax_label": shapes["softmax_label"]},
                       arg_params=args)

    out = {}
    tr, twin = trainer(), trainer()
    n_buckets = len(tr._fused_plan.buckets)
    t0 = time.perf_counter()
    with analysis.audit_on_compile() as rep:
        infos = tr.compile(programs=("train", "train_acc"))
    out["compile_s"] = time.perf_counter() - t0
    check(all(i["source"] == ("capture" if DEVICE == "cuda" else "eager")
              for i in infos), f"(a) the LM's programs resolved {infos}")
    check(sorted(rep.metrics) == ["trainer.train", "trainer.train_acc"],
          f"(a) the observers saw {sorted(rep.metrics)}")
    out["compile_warns"] = p26_clean(rep, "(a) audit_on_compile")
    for kind in ("train", "train_acc"):
        label = f"trainer.{kind}"
        p26_fused_one_pass(rep, label, n_buckets, "(a)")
        m = rep.metrics[label]
        p26_notes_check(rep, label, p26_capture_counts(tr._aot[kind][0],
                                                       names), "(a)")
        check(m["backward_ops"] > 0
              and m["kernel_notes"].get("flash_bwd", 0) == LAYERS,
              f"(a) {label}: {m['backward_ops']} backward ops and "
              f"{m['kernel_notes']} notes: the recorder did not reach "
              "autograd's thread")
        out[label] = {k: m[k] for k in ("eqns", "consts_bytes",
                                        "kernel_notes", "backward_ops")}
    before = p26_counts(nn_ops, fa, fu, fd)
    t0 = time.perf_counter()
    rep = analysis.audit_trainer(tr)
    torch.cuda.synchronize()
    out["audit_trainer_s"] = time.perf_counter() - t0
    launched = p26_diff(p26_counts(nn_ops, fa, fu, fd), before)
    out["audit_warns"] = p26_clean(rep, "(a) audit_trainer")
    notes = {}
    for kind in ("train", "train_acc"):
        label = f"trainer.{kind}"
        hbm = rep.metrics[label]["hbm_passes"]
        check(hbm["max_reads"] == hbm["max_writes"] == 1
              and len(hbm["buckets"]) == n_buckets,
              f"(a) audit_trainer {label}: {hbm['max_reads']} reads / "
              f"{hbm['max_writes']} writes over {len(hbm['buckets'])} "
              "buckets")
        for k, v in rep.metrics[label]["kernel_notes"].items():
            notes[k] = notes.get(k, 0) + v
    check(notes == launched or DEVICE != "cuda",
          f"(a) audit_trainer's notes {notes} != its launches {launched}")
    out["audit_launches"] = launched
    # auditing changed nothing: two replayed steps against the twin's
    twin.compile(programs=("train",))
    batch = lm_batch(np, seed=5)
    heads = [tr.step(batch) for _ in range(2)]
    twin_heads = [twin.step(batch) for _ in range(2)]
    same = all(torch.equal(a, b) for h, g in zip(heads, twin_heads)
               for a, b in zip(h, g))
    same_w = all(torch.equal(a, b) for a, b in zip(
        tr._written_tensors(), twin._written_tensors()))
    check(same and same_w, f"(a) after the audit, 2 replayed steps are not "
          f"bitwise the unaudited twin's (heads {same}, state {same_w})")
    check(tr.aot_stats["hits"] == twin.aot_stats["hits"] == 2
          or DEVICE != "cuda", f"(a) replays {tr.aot_stats}")
    log(f"  (a) LM {LAYERS}L d{D_MODEL}: captured under the observers in "
        f"{out['compile_s']:.1f} s, both programs clean, {n_buckets} "
        f"buckets at 1 read / 1 write, notes = capture launches "
        f"{out['trainer.train']['kernel_notes']}, "
        f"{out['trainer.train']['backward_ops']} backward ops; "
        f"audit_trainer {out['audit_trainer_s']:.1f} s (launched "
        f"{launched}); 2 replays bitwise the twin's")
    del tr, twin
    return out


def p26_resnet(torch, np, analysis, names, nn_ops, fa, fu, fd):
    """(b): phase 7's ResNet-50 step (SGD with momentum, guard, clip)
    captured under the observers, then ``audit_trainer``."""
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=0)
    tr = ShardedTrainer(sym, optimizer="sgd", optimizer_params=dict(TRAIN_OPT),
                        guard=True, clip_global_norm=CLIP, fused_update=True,
                        device=DEVICE)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]},
            arg_params=args, aux_params=aux)
    n_buckets = len(tr._fused_plan.buckets)
    out = {}
    t0 = time.perf_counter()
    with analysis.audit_on_compile() as rep:
        tr.compile(programs=("train",))
    out["compile_s"] = time.perf_counter() - t0
    out["compile_warns"] = p26_clean(rep, "(b) audit_on_compile")
    p26_fused_one_pass(rep, "trainer.train", n_buckets, "(b)")
    p26_notes_check(rep, "trainer.train", p26_capture_counts(
        tr._aot["train"][0], names), "(b)")
    before = p26_counts(nn_ops, fa, fu, fd)
    t0 = time.perf_counter()
    rep = analysis.audit_trainer(tr, programs=("train",))
    torch.cuda.synchronize()
    out["audit_trainer_s"] = time.perf_counter() - t0
    launched = p26_diff(p26_counts(nn_ops, fa, fu, fd), before)
    out["audit_warns"] = p26_clean(rep, "(b) audit_trainer")
    m = rep.metrics["trainer.train"]
    hbm = m["hbm_passes"]
    check(hbm["max_reads"] == hbm["max_writes"] == 1
          and len(hbm["buckets"]) == n_buckets,
          f"(b) {hbm['max_reads']} reads / {hbm['max_writes']} writes over "
          f"{len(hbm['buckets'])} buckets")
    check(m["kernel_notes"] == launched or DEVICE != "cuda",
          f"(b) notes {m['kernel_notes']} != launches {launched}")
    check(m["kernel_notes"].get("softmax_rows") == 1
          and m["kernel_notes"].get("fused_update") == 1,
          f"(b) notes {m['kernel_notes']}: expected one K1 and one K2")
    out.update(eqns=m["eqns"], notes=m["kernel_notes"],
               backward_ops=m["backward_ops"], audit_launches=launched)
    log(f"  (b) ResNet-{DEPTH} batch {BATCH}: clean, {n_buckets} buckets at "
        f"1 read / 1 write, {m['eqns']} ops and notes ({m['kernel_notes']}), "
        f"audit_trainer {out['audit_trainer_s']:.1f} s")
    return out


def p26_engine(torch, analysis, cc, quant_kind, params):
    """(c): an engine at ``ENGINE_KW`` warmed up under the observers; the
    recorded traces of its decode programs, and their captures' launch
    counts."""
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    traces = {}

    def keep(label, trace):
        traces[label] = trace

    eng = Engine(params, EngineConfig(**ENGINE_KW, kv_quant=quant_kind),
                 device=DEVICE)
    cc.add_lowering_observer(keep)
    try:
        with analysis.audit_on_compile() as rep:
            eng.warmup()
    finally:
        cc.remove_lowering_observer(keep)
    return eng, rep, traces


def p26_decode(torch, analysis, cc, names):
    """(c): the fp8 engine's decode programs read 1-byte KV and audit
    clean at ``expect_kv_itemsize=1``; the plain-pool engine's fire
    ``program.hbm-bytes`` there (the positive control); K5 and K5-fp8
    notes equal the captures' launches."""
    from mxnet_tpu_torch.models import transformer
    params = transformer.init_params(VOCAB, LAYERS, D_MODEL, seed=0)
    out = {}
    for quant_kind in ("fp8", None):
        t0 = time.perf_counter()
        eng, rep, traces = p26_engine(torch, analysis, cc, quant_kind,
                                      params)
        tag = quant_kind or "f32"
        warns = p26_clean(rep, f"(c) {tag} engine warmup")
        decode = sorted(k for k in traces if k.startswith("serve.decode."))
        check(decode and len(traces) == len(eng._programs),
              f"(c) {tag}: observed {sorted(traces)}")
        fired = {}
        for label in decode:
            trace = traces[label]
            reads = rep.metrics[label]["kv_reads"]["reads"]
            check({r["itemsize"] for r in reads}
                  == {1 if quant_kind else 4} and len(reads) == 2 * LAYERS,
                  f"(c) {tag} {label}: KV reads {reads}")
            check_rep = analysis.audit_traced(trace, label,
                                              expect_kv_itemsize=1)
            fired[label] = sorted({f.rule for f in check_rep.findings})
            prog = eng._programs[tuple(label.split(".")[1:2])
                                 + (int(label.rsplit(".", 1)[1]),)]
            quantized = [n.attrs["quantized"] for n in trace.notes
                         if n.kernel == "flash_decode"]
            check(set(quantized) == {bool(quant_kind)},
                  f"(c) {tag} {label}: notes' pools {quantized}")
            p26_notes_check(rep, label, p26_capture_counts(prog, names),
                            f"(c) {tag}")
        if quant_kind:
            check(all(v == [] for v in fired.values()),
                  f"(c) fp8 decode programs at expect_kv_itemsize=1: {fired}")
        else:
            check(all(v == ["program.hbm-bytes"] for v in fired.values()),
                  f"(c) the positive control did not fire: {fired}")
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "programs": sorted(traces), "warns": warns,
                    "expect_kv_itemsize_1": fired,
                    "kv_read_bytes": {k: rep.metrics[k]["kv_reads"]
                                      ["read_bytes"] for k in decode}}
        log(f"  (c) {tag} engine: {len(traces)} programs clean, decode "
            f"KV reads {1 if quant_kind else 4} byte(s)/elem, "
            f"expect_kv_itemsize=1 {'clean' if quant_kind else 'fires'} "
            f"{fired}, in {out[tag]['seconds']:.1f} s")
        del eng
    return out


def p26_cli():
    """(d): ``torch_staticcheck.py audit --json`` on the card and ``gate
    --json`` on the host, as child processes: both exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(root, "tools", "torch_staticcheck.py")
    out = {}
    for cmd in (["audit", "--json"] + (["--device", "cpu"]
                                       if DEVICE != "cuda" else []),
                ["gate", "--json"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, tool] + cmd,
                              capture_output=True, text=True, cwd=root,
                              timeout=P26_AUDIT_TIMEOUT)
        check(proc.returncode == 0, f"(d) torch_staticcheck {cmd[0]} exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        rep = json.loads(proc.stdout)
        check(rep["ok"], f"(d) {cmd[0]}: not ok")
        out[cmd[0]] = {"seconds": time.perf_counter() - t0,
                       "counts": rep["counts"]}
        if cmd[0] == "audit":
            out["audit"]["passes"] = {
                k: (m["hbm_passes"]["max_reads"],
                    m["hbm_passes"]["max_writes"])
                for k, m in rep["metrics"].items()}
            check(all(v == (1, 1) for v in out["audit"]["passes"].values()),
                  f"(d) audit passes {out['audit']['passes']}")
        else:
            check(rep["corpus"]["failures"] == []
                  and "corpus.hbm_bytes_quantized:program.hbm-bytes"
                  not in rep["corpus"]["programs"],
                  f"(d) the gate's program corpus: {rep['corpus']}")
    log(f"  (d) torch_staticcheck audit on {DEVICE}: exit 0 "
        f"({out['audit']['seconds']:.1f} s, passes "
        f"{out['audit']['passes']}); gate on the host: exit 0 "
        f"({out['gate']['seconds']:.1f} s)")
    return out


def phase_program_audit(torch, np, mx, nn_ops, fa, fu, fd,
                        parts=("a", "b", "c", "d")):
    """Phase 26: the program auditor over the port's captured programs
    on the card: (a) phase 9's LM, (b) phase 7's ResNet-50 step, (c) the
    serving engine's decode programs over fp8 and plain pools, (d) the
    CLI's audit on the card and the gate.  Returns the launches it adds
    (by result-line name) and its numbers."""
    from mxnet_tpu_torch import analysis, telemetry
    from mxnet_tpu_torch import compile_cache as cc
    t_phase = time.perf_counter()
    names = p26_names(nn_ops, fa, fu, fd)
    reset_train_counts(nn_ops.softmax_rows, fu.fused_update, fa.flash_fwd,
                       fa.flash_bwd)
    reset_decode_counts(fd)
    telemetry.counter("compile_cache.observer_errors")
    errors0 = telemetry.registry().get_value(
        "compile_cache.observer_errors") or 0
    stats = {"card": card_line() if DEVICE == "cuda" else "cpu"}
    det = torch.are_deterministic_algorithms_enabled()
    # bitwise replays against the twin: the embedding's scatter-add
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        if "a" in parts:
            stats["(a)"] = p26_lm(torch, np, analysis, cc, names, nn_ops, fa,
                                  fu, fd)
    finally:
        torch.use_deterministic_algorithms(det)
    if "b" in parts:
        stats["(b)"] = p26_resnet(torch, np, analysis, names, nn_ops, fa,
                                  fu, fd)
    if "c" in parts:
        stats["(c)"] = p26_decode(torch, analysis, cc, names)
        log("  (c) the compressed wire audit (int8 over two distinct "
            "cards) is not run: it needs two cards and this run has "
            f"{torch.cuda.device_count() if DEVICE == 'cuda' else 0}; the "
            "CPU tests hold it over two CPU members")
    f = fd.flash_decode_attention
    launches = {"softmax_rows": nn_ops.softmax_rows.launches,
                "fused_update": fu.fused_update.launches,
                "flash_attn_fwd": fa.flash_fwd.launches,
                "flash_attn_bwd": fa.flash_bwd.launches,
                "flash_decode": f.launches,
                "flash_decode_fp8": f.launches_fp8}
    if "d" in parts:
        stats["(d)"] = p26_cli()
    errors = (telemetry.registry().get_value(
        "compile_cache.observer_errors") or 0) - errors0
    check(errors == 0, f"{errors} capture observer error(s)")
    check(cc.lowering_observers() == [],
          f"observers left registered: {cc.lowering_observers()}")
    stats["observer_errors"] = errors
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  compile_cache.observer_errors 0, no observer registered; "
        f"launches added by phase 26: {launches}")
    log("  program auditor: " + json.dumps(stats))
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 27: the tuned conv backward, the C predict API and the last tools
# (after phase 26, before the result)
# ---------------------------------------------------------------------------

# (a) one shape of each family the tuned policy treats, named as in
# tools/torch_conv_probe.py's table: the stem 7x7 s2, 1x1 s1, 1x1 s2, 3x3
# s2 and 3x3 s1 (the backend's on both sides); held to cuDNN's backward
# within the probe's bounds (1e-2 x max(1, max |cuDNN|) in bf16, 1e-4 in
# f32), then timed by the probe (CUDA events, median of P27_REPS, L2
# flushed)
P27_SHAPES = ("stem_7x7_s2", "s1_1x1_64_256", "s2_1x1_sc_s2",
              "s2_3x3_128_s2", "s1_3x3_64")
P27_BATCH, P27_REPS = 64, 20
# (b) phase 7's ResNet-50, one step under tuned against one under the
# default from the same weights and batch (cuDNN deterministic): the
# parameters and moving statistics after it within the trainer tests'
# bounds (f32 summation order of the two backward forms, through one
# clipped SGD step), then P27_TIMED more steps of each, timed
P27_STEP_TOL = (1e-4, 1e-6)
P27_TIMED = 3
# (c) phase 19 (b)'s artifact served by the C driver: forwards, the first
# left out of the median as phase 19 leaves it out
P27_C_REPS = 11
# (d) a synthetic image folder: 2 classes of 12 PNGs, landscape and
# portrait, packed at 32x32 (resize, center crop) by two workers
P27_IMAGES, P27_SIDE = 12, 32


@contextlib.contextmanager
def p27_policy(value):
    """``MXNET_TPU_CONV_BWD`` set to ``value`` (``None``: unset, the
    default) inside the block, restored after it."""
    saved = os.environ.pop("MXNET_TPU_CONV_BWD", None)
    if value is not None:
        os.environ["MXNET_TPU_CONV_BWD"] = value
    try:
        yield
    finally:
        os.environ.pop("MXNET_TPU_CONV_BWD", None)
        if saved is not None:
            os.environ["MXNET_TPU_CONV_BWD"] = saved


def p27_tuned_kinds(cb, sym):
    """The tuned policy's kinds of every Convolution of ``sym`` whose
    backward it restructures (stride, pad and kernel decide them)."""
    kinds = []
    for node in json.loads(sym.tojson())["nodes"]:
        if node["op"] != "Convolution":
            continue
        attrs = node.get("attrs") or node.get("param") or {}

        def pair(key, default):
            v = attrs.get(key)
            return tuple(int(t) for t in v.strip("()").split(",")
                         if t.strip()) if v else default

        k = pair("kernel", None)
        got = cb._policy((1, 1, 8, 8), (1, 1) + k, pair("stride", (1, 1)),
                         pair("pad", (0, 0)))
        if got != ("xla", "xla"):
            kinds.append(got)
    return kinds


def p27_conv(torch, np, probe):
    """(a) ``_conv2d_bwd`` under tuned against cuDNN's backward, and the
    probe's times, at batch ``P27_BATCH`` in bf16 and f32."""
    from mxnet_tpu_torch.ops import conv_backward as cb
    shapes = [s for s in probe.RESNET50_SHAPES if s[0] in P27_SHAPES]
    check(len(shapes) == len(P27_SHAPES), f"probe shapes {shapes}")
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    flush = torch.empty(probe.FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    out = {"held": [], "rows": []}
    for dtype in ("bfloat16", "float32"):
        for shape in shapes:
            name, cin, hw, cout, k, s, p, _ = shape
            (x, w, dy), _ = probe.forms(torch, cin, hw, cout, k, s, p,
                                        P27_BATCH, dtype, gen)
            with p27_policy("tuned"):
                kinds = cb._policy(x.shape, w.shape, (s, s), (p, p))
            check(kinds != ("xla", "xla") or k == 3 and s == 1,
                  f"(a) {name}: the tuned policy picked {kinds}")
            got = cb._conv2d_bwd((s, s), (p, p), (x, w), dy, kinds)
            ref = cb._backend_grads(dy, x, w, (s, s), (p, p), (True, True))
            for side, g, r in zip(("dx", "dw"), got, ref):
                err, bound = probe.check_error(torch, g, r, dtype)
                check(g.dtype == r.dtype and g.shape == r.shape
                      and err <= bound,
                      f"(a) {name} {dtype} {side} ({kinds}): max abs error "
                      f"{err} above {bound} or {g.dtype}/{tuple(g.shape)} "
                      f"against {r.dtype}/{tuple(r.shape)}")
                out["held"].append({"shape": name, "dtype": dtype,
                                    "side": side, "kinds": list(kinds),
                                    "max_abs_err": err, "bound": bound})
            del x, w, dy, got, ref
            out["rows"] += probe.probe_shape(torch, shape, P27_BATCH, dtype,
                                             P27_REPS, False, flush, gen)
    for dtype in ("bfloat16", "float32"):
        for name in P27_SHAPES:
            rows = {r["form"]: r for r in out["rows"]
                    if r["shape"] == name and r["dtype"] == dtype}
            log(f"  (a) {name} {dtype} batch {P27_BATCH}: "
                + ", ".join(f"{f} {r['ms']:.4f} ms ({r['tflops']:.1f} "
                            "TFLOP/s)" for f, r in rows.items()))
    log(f"  (a) tuned backward held to cuDNN's: "
        f"{len(out['held'])} gradients, largest error share "
        f"{max(h['max_abs_err'] / h['bound'] for h in out['held']):.3g} "
        "of its bound")
    return out


def p27_steps(torch, np, nn_ops, fu, sym, shapes, args, aux, host, launches,
              state, policy):
    """One bound trainer's first step (its parameters and moving
    statistics kept in ``state[policy]``) and ``P27_TIMED`` more, under
    whatever policy is set; returns the step times."""
    from mxnet_tpu_torch.parallel import ShardedTrainer

    tr = ShardedTrainer(sym, optimizer="sgd",
                        optimizer_params=dict(TRAIN_OPT), guard=True,
                        clip_global_norm=CLIP, device=DEVICE)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]},
            arg_params=args, aux_params=aux)
    batch = tr.place_batch(host)
    torch.cuda.synchronize()
    reset_train_counts(nn_ops.softmax_rows, fu.fused_update)
    ms = []
    for i in range(1 + P27_TIMED):
        t0 = time.perf_counter()
        tr.step(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            arg_now, aux_now = tr.get_params()
            state[policy] = ({n: v.asnumpy() for n, v in arg_now.items()},
                             {n: v.asnumpy() for n, v in aux_now.items()})
    steps = 1 + P27_TIMED
    k1, k2 = nn_ops.softmax_rows.launches, fu.fused_update.launches
    check(k1 == steps and k2 == steps
          and fu.fused_update.launches_by_form["hopper"] == steps,
          f"(b) {policy}: K1 {k1}, K2 {k2} "
          f"({fu.fused_update.launches_by_form}) in {steps} steps")
    launches["softmax_rows"] += k1
    launches["fused_update"] += k2
    return {"first_step_ms": ms[0], "step_ms": ms[1:],
            "median_step_ms": float(np.median(ms[1:]))}


def p27_resnet(torch, np, nn_ops, fu, cb, launches):
    """(b) one ResNet-50 step under ``MXNET_TPU_CONV_BWD=tuned`` and one
    under the default, from the same weights and batch; then
    ``P27_TIMED`` steps of each."""
    from mxnet_tpu_torch import models

    sym = models.get_symbol("resnet", num_classes=CLASSES, depth=DEPTH)
    shapes = dict(data=(BATCH,) + IMAGE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = init_numpy(np, sym, arg_shapes, aux_shapes, seed=27)
    rng = np.random.RandomState(27)
    host = {"data": rng.rand(*shapes["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, CLASSES, BATCH)
            .astype(np.float32)}
    with p27_policy("tuned"):
        per_step = p27_tuned_kinds(cb, sym)
    calls = []
    real = cb._conv2d_bwd

    def counting(*a):
        calls.append(a[4])
        return real(*a)

    out, state = {}, {}
    cb._conv2d_bwd = counting
    try:
        for policy in ("default", "tuned"):
            with p27_policy(None if policy == "default" else policy):
                out[policy] = p27_steps(torch, np, nn_ops, fu, sym, shapes,
                                        args, aux, host, launches, state,
                                        policy)
            want = per_step * (1 + P27_TIMED) if policy == "tuned" else []
            check(sorted(calls) == sorted(want),
                  f"(b) {policy}: the tuned backward ran {len(calls)} times "
                  f"({sorted(set(calls))}), expected {len(want)}")
            out[policy]["tuned_backwards_a_step"] = \
                len(calls) // (1 + P27_TIMED)
            del calls[:]
    finally:
        cb._conv2d_bwd = real
    worst = {}
    for i, what in enumerate(("parameters", "moving statistics")):
        a, b = state["default"][i], state["tuned"][i]
        for n in a:
            d = float(np.abs(a[n] - b[n]).max())
            worst[n] = d
            check(np.allclose(b[n], a[n], rtol=P27_STEP_TOL[0],
                              atol=P27_STEP_TOL[1]),
                  f"(b) {what} {n} after one step: tuned differs from the "
                  f"default by {d}")
    out["max_abs_diff"] = max(worst.values())
    out["bitwise"] = sum(1 for d in worst.values() if d == 0)
    out["arrays"] = len(worst)
    out["kinds_a_step"] = {"/".join(k): per_step.count(k)
                           for k in sorted(set(per_step))}
    log(f"  (b) ResNet-{DEPTH} step, batch {BATCH}: default "
        f"{out['default']['median_step_ms']:.2f} ms (first "
        f"{out['default']['first_step_ms']:.2f}), tuned "
        f"{out['tuned']['median_step_ms']:.2f} ms (first "
        f"{out['tuned']['first_step_ms']:.2f}); {len(per_step)} tuned "
        f"backwards a step {out['kinds_a_step']}; after one step "
        f"{out['bitwise']} of {out['arrays']} arrays bitwise, max abs diff "
        f"{out['max_abs_diff']:.3g}")
    return out


def p27_c_predict(torch, np, _build):
    """(c) phase 19 (b)'s ResNet-50 artifact served by the port's C
    driver on the card, against the Predictor's output."""
    check(P19_EXPORT, "(c) phase 19 (b) exported no artifact")
    t0 = time.perf_counter()
    info = _build.build_c_predict()
    out = {"build_s": time.perf_counter() - t0, "cached": info["cached"]}
    ref = P19_EXPORT["ref"]
    got_path = os.path.join(os.path.dirname(P19_EXPORT["artifact"]),
                            "c_out.bin")
    base = {k: v for k, v in os.environ.items()
            if k != "MXNET_TPU_PREDICT_DEVICE"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [str(info["driver"]), P19_EXPORT["artifact"], P19_EXPORT["x"],
         got_path, str(P27_C_REPS)], capture_output=True, text=True,
        timeout=300, env=_build.c_predict_env(base=base))
    out["process_s"] = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"(c) the C driver exited {proc.returncode}: {proc.stdout} "
          f"{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    check(lines[-1] == "served 1 outputs ok", f"(c) {proc.stdout}")
    ms = [float(v) for v in next(line for line in lines
                                 if line.startswith("forward_ms")).split()[1:]]
    got = np.fromfile(got_path, np.float32).reshape(ref.shape)
    err = float(np.abs(got - ref).max())
    check(np.allclose(got, ref, rtol=EXPORT_TOL[0], atol=EXPORT_TOL[1]),
          f"(c) the C-served outputs differ from the Predictor's by {err}")
    out.update(forward_ms=ms, median_forward_ms=float(np.median(ms[1:])),
               python_median_ms=P19_EXPORT["python_ms"], max_abs_err=err)
    log(f"  (c) C predict API (built in {out['build_s']:.2f} s): the pure-C "
        f"driver served phase 19's ResNet-{DEPTH} artifact on the card "
        f"(default device), forward median {out['median_forward_ms']:.3f} "
        f"ms (host clock around MXTPUPredForward, the output copied back) "
        f"against phase 19's Python-served {out['python_median_ms']:.3f} ms "
        f"(CUDA events around the module); max abs diff {err:.3g} from the "
        f"Predictor (limit {EXPORT_TOL}); the process took "
        f"{out['process_s']:.1f} s")
    return out


def p27_tools(torch, np, tmp):
    """(d) ``tools/torch_im2rec.py`` packs an image folder that the port's
    ``ImageRecordIter`` reads back; ``tools/torch_ckpt_inspect.py`` shows,
    verifies and diffs a checkpoint written from CUDA tensors."""
    import io as pyio

    import cv2

    from mxnet_tpu_torch import image_io, recordio
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    root = os.path.join(tmp, "imgs")
    rng = np.random.RandomState(27)
    for label, cls in enumerate(("a", "b")):
        os.makedirs(os.path.join(root, cls))
        for i in range(P27_IMAGES):
            h, w = (48, 40) if i % 2 else (40, 48)
            cv2.imwrite(os.path.join(root, cls, f"{i:02d}.png"),
                        rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    prefix = os.path.join(tmp, "packed")
    tool = os.path.join(here, "tools", "torch_im2rec.py")
    t0 = time.perf_counter()
    for argv in (["--make-list"],
                 ["--lst", prefix + ".lst", "--encoding", ".png",
                  "--resize", str(P27_SIDE), "--center-crop",
                  "--num-thread", "2"]):
        proc = subprocess.run([sys.executable, tool, prefix, root, *argv],
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"(d) torch_im2rec {argv[0]} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
    out["im2rec_s"] = time.perf_counter() - t0
    n = 2 * P27_IMAGES
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    pixels, labels = 0, []
    for i in range(n):
        header, img = recordio.unpack_img(rec.read_idx(i))
        check(img.shape == (P27_SIDE, P27_SIDE, 3),
              f"(d) record {i} holds {img.shape}")
        pixels += int(img.astype(np.int64).sum())
        labels.append(header.label)
    rec.close()
    it = image_io.ImageRecordIter(prefix + ".rec", (3, P27_SIDE, P27_SIDE),
                                  8, path_imgidx=prefix + ".idx")
    seen, total, got_labels = 0, 0.0, []
    for b in it:
        k = b.data[0].shape[0] - b.pad
        seen += k
        total += float(b.data[0].asnumpy()[:k].astype(np.float64).sum())
        got_labels += b.label[0].asnumpy()[:k].tolist()
    check(seen == n and got_labels == labels
          and labels == [0.0] * P27_IMAGES + [1.0] * P27_IMAGES
          and total == pixels,
          f"(d) ImageRecordIter read {seen} of {n} images, labels "
          f"{got_labels}, pixel sum {total} against the records' {pixels}")
    out["records"] = n

    spec = importlib.util.spec_from_file_location(
        "torch_ckpt_inspect", os.path.join(here, "tools",
                                           "torch_ckpt_inspect.py"))
    inspect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(inspect)
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    arrays = {"fc_weight": torch.randn(1000, 2048, generator=gen,
                                       device=DEVICE),
              "fc_bias": torch.zeros(1000, device=DEVICE),
              "bn_moving_var": torch.rand(64, generator=gen, device=DEVICE),
              "num_update": torch.arange(4, dtype=torch.int32,
                                         device=DEVICE)}
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    first = mgr.save(1, arrays, meta={"num_update": 1}, blocking=True)
    arrays["fc_bias"] += 1
    second = mgr.save(2, arrays, meta={"num_update": 2}, blocking=True)
    mgr.close()

    def run(*argv):
        buf = pyio.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = inspect.main(list(argv))
        return rc, buf.getvalue()

    rc, text = run("show", first, "--verify")
    check(rc == 0 and text.count("[OK]") == len(arrays),
          f"(d) torch_ckpt_inspect show --verify exited {rc}: {text}")
    rc, text = run("diff", first, second)
    check(rc == 1 and [line.split()[1] for line in text.splitlines()
                       if line.startswith("~")] == ["fc_bias"],
          f"(d) torch_ckpt_inspect diff exited {rc}: {text}")
    rc, text = run("diff", first, first)
    check(rc == 0 and "identical" in text,
          f"(d) torch_ckpt_inspect diff of one checkpoint exited {rc}: "
          f"{text}")
    log(f"  (d) torch_im2rec packed {n} PNGs at {P27_SIDE}x{P27_SIDE} (list, "
        f"then 2 workers) in {out['im2rec_s']:.1f} s, read back by "
        "ImageRecordIter: labels and pixel sums equal the records'; "
        f"torch_ckpt_inspect on a checkpoint of {len(arrays)} CUDA "
        "tensors: show --verify all OK (exit 0), diff names fc_bias (exit "
        "1), diff of one step with itself identical (exit 0)")
    return out


def phase_conv_tools(torch, np, nn_ops, fu, _build):
    """Phase 27: (a) the tuned conv backward against cuDNN's and the
    probe's times, (b) ResNet-50 steps under tuned and the default, (c)
    the C predict API serving phase 19's artifact, (d) the im2rec and
    ckpt_inspect twins.  Returns the launches it adds and its numbers."""
    import tempfile

    from mxnet_tpu_torch.ops import conv_backward as cb
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_conv_probe", os.path.join(here, "tools",
                                         "torch_conv_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    launches = {"softmax_rows": 0, "fused_update": 0}
    stats = {"card": card_line()}
    builds = _build.build_count()
    # (a) times cuDNN as the probe does (its default algorithms); (b)
    # compares two trainers, so cuDNN is deterministic there
    t0 = time.perf_counter()
    stats["(a)"] = p27_conv(torch, np, probe)
    stats["(a)"]["seconds"] = time.perf_counter() - t0
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        t0 = time.perf_counter()
        stats["(b)"] = p27_resnet(torch, np, nn_ops, fu, cb, launches)
        stats["(b)"]["seconds"] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    t0 = time.perf_counter()
    stats["(c)"] = p27_c_predict(torch, np, _build)
    stats["(c)"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        stats["(d)"] = p27_tools(torch, np, tmp)
    stats["(d)"]["seconds"] = time.perf_counter() - t0
    check(_build.build_count() == builds,
          f"phase 27 built or first loaded {_build.build_count() - builds} "
          "kernel libraries after warmup")
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  launches added by phase 27: {launches}; no kernel built")
    # (a)'s rows and held gradients are on the lines above
    log("  conv backward, C predict API, tools: " + json.dumps(
        dict(stats, **{"(a)": {"seconds": stats["(a)"]["seconds"]}})))
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 28: ShardedTrainer over meshes that span processes, on one card
# ---------------------------------------------------------------------------
# Two ranks on the card over gloo: two processes are distinct members of a
# mesh even on one card, so a split axis laid across them runs here.
# (a) phase 9's LM (bf16, Adam, unfused) under megatron_rules() over
# {"model": 2} across the ranks (4 heads a member), P28_STEPS steps: the
# plan split for every Megatron parameter; K3 and K4 once a layer a step on
# each rank, in the hopper form; the ranks' replicated parameters bitwise
# equal; rank 0's first heads within P20_TP_HEAD_TOL and its first update
# within P20_TP_STEP1_LIMIT of this process's one-card run (phase 20 (c)'s
# limits for the same plan over two cards).  (b) the LM with ZeRO over
# {"data": 2} across the ranks, P28_STEPS steps, then save_state (each
# rank its slices, rank 0 the manifest); restored here into a one-card
# ZeRO trainer: parameters, Adam moments, the update count and the seed
# bitwise what the ranks dumped; tools/torch_ckpt_inspect.py verifies it.
# The bf16 Adam run's limits pass any first update within 2 lr of one
# card's, so (a) also takes one float32 SGD step (rate P28_F32_LR, depth
# cut to P28_F32_LAYERS, full width) on both sides: rank 0's heads within
# P28_F32_HEAD_TOL of one card's, and each parameter's update within
# P28_F32_STEP_RTOL of the one-card update, as root mean squares (the
# update's at least P28_F32_FLOOR of the largest parameter's).  Read on an
# H100 (PR 27): heads 4.8e-6, updates 8.0e-4 (layer1_ffn1_weight: ReLU
# gates that flip on rounding differences); a doubled cross-process
# gradient reads above 1
P28_STEPS = 2
P28_F32_LAYERS = 2
P28_F32_LR = 1.0
P28_F32_HEAD_TOL = 5e-5
P28_F32_STEP_RTOL = 5e-3
P28_F32_FLOOR = 1e-3
P28_KERNELS = ("softmax_rows", "fused_update", "flash_attn_fwd",
               "flash_attn_bwd")


def p28_steps(torch, plan, tr, feed, after_first=None):
    """``P28_STEPS`` steps of ``tr`` on ``feed``: each step's ms, K1-K4
    launches (and K3/K4's hopper-form launches), and the bytes that
    crossed processes by axis (``count_collectives``' ``process``
    records); ``after_first(heads)`` runs after the first step."""
    from mxnet_tpu_torch.parallel.collectives import count_collectives
    rows = []
    for s in range(plan["p28"]["steps"]):
        before = p23_counts()
        p23_sync(torch, plan)
        t0 = time.perf_counter()
        with count_collectives() as st:
            heads = tr.step(feed)
        p23_sync(torch, plan)
        ms = (time.perf_counter() - t0) * 1e3
        after = p23_counts()
        crossed = {}
        for r in st.records:
            if r["kind"] == "process":
                crossed[r["axis"]] = (crossed.get(r["axis"], 0)
                                      + r["wire_nbytes"])
        rows.append({
            "ms": ms, "crossed": crossed,
            "counts": {k: after[k] - before[k] for k in P28_KERNELS},
            "hopper": {k: after["forms"][k].get("hopper", 0)
                       - before["forms"][k].get("hopper", 0)
                       for k in ("flash_attn_fwd", "flash_attn_bwd")}})
        if s == 0 and after_first is not None:
            after_first(heads)
    return rows


def p28_f32(plan):
    """(a)'s float32 SGD plan: the LM cut to its depth."""
    return dict(plan, lm=dict(plan["lm"], layers=plan["p28"]["f32_layers"],
                              opt={"learning_rate": plan["p28"]["f32_lr"]}))


def p28_f32_trainer(np, plan, **kw):
    """(a)'s float32 SGD trainer, bound to its initial values, with its
    batch and those values."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    f32 = p28_f32(plan)
    sym = p23_lm_symbol(f32)
    shapes, args, batch = p23_lm_state(np, f32, sym)
    tr = ShardedTrainer(sym, optimizer="sgd",
                        optimizer_params=dict(f32["lm"]["opt"]), **kw)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    return tr, batch, args


def p28_job(torch, np, mx, plan, out):
    """A rank of phase 28: (a) the LM under Megatron's rules over the
    model axis across the ranks, (b) the LM with ZeRO over the data axis
    across them, then its checkpoint."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import (ShardedTrainer, dist, make_mesh,
                                          megatron_rules)
    rank = int(os.environ["MXTPU_PROC_ID"])
    dist.init_distributed(device=mx.gpu(0) if plan["device"] == "cuda"
                          else mx.cpu())
    sym = p23_lm_symbol(plan)
    shapes, args, batch = p23_lm_state(np, plan, sym)
    opt = dict(plan["lm"]["opt"])
    res = {"rank": rank, "backend": dist.backend()}

    tr = ShardedTrainer(sym, optimizer="adam", optimizer_params=opt,
                        compute_dtype="bfloat16", fused_update=False,
                        rules=megatron_rules(), mesh=make_mesh({"model": 2}))
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    info = tr._tp_plan.info()
    q = tr._params["layer0_q_weight"]
    res["a"] = {"plan": info["plan"], "reason": info["reason"],
                "split": sorted(info["params"]),
                "pieces": len(tr._pieces),
                "q_piece": list(q.shape),
                "heads_per_member": plan["lm"]["heads"] * q.shape[0]
                // plan["lm"]["d_model"]}

    def first(heads):
        # every rank gathers the pieces; rank 0 keeps the first step
        params = {k: v.data.cpu() for k, v in tr.get_params()[0].items()}
        if rank == 0:
            torch.save({"heads": heads[0].float().cpu(), "params": params},
                       os.path.join(out, "p28a_first.pt"))

    res["a"]["steps"] = p28_steps(torch, plan, tr, batch, first)
    torch.save({n: tr._params[n].detach().cpu() for n in tr._param_names
                if n not in tr._pieces},
               os.path.join(out, f"p28a_rank{rank}.pt"))
    del tr
    if plan["device"] == "cuda":
        torch.cuda.empty_cache()

    tr, batch32, _ = p28_f32_trainer(np, plan, rules=megatron_rules(),
                                     mesh=make_mesh({"model": 2}))
    res["a"]["f32_plan"] = tr._tp_plan.info()["plan"]

    def first32(heads):
        params = {k: v.data.cpu() for k, v in tr.get_params()[0].items()}
        if rank == 0:
            torch.save({"heads": heads[0].float().cpu(), "params": params},
                       os.path.join(out, "p28a_f32.pt"))

    res["a"]["f32_steps"] = p28_steps(
        torch, dict(plan, p28=dict(plan["p28"], steps=1)), tr, batch32,
        first32)
    del tr
    if plan["device"] == "cuda":
        torch.cuda.empty_cache()

    tr = ShardedTrainer(sym, optimizer="adam", optimizer_params=opt,
                        compute_dtype="bfloat16", shard_optimizer=True,
                        mesh=make_mesh({"data": 2}))
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    n = plan["lm"]["batch"] // 2
    res["b"] = {"steps": p28_steps(
        torch, plan, tr, {k: v[rank * n:(rank + 1) * n]
                          for k, v in batch.items()}),
        "zero_state_bytes": tr.optimizer_state_bytes_per_device()}
    mgr = checkpoint.CheckpointManager(os.path.join(out, "p28-ckpt"))
    p23_sync(torch, plan)
    t0 = time.perf_counter()
    res["b"]["path"] = tr.save_state(mgr)
    res["b"]["write_ms"] = (time.perf_counter() - t0) * 1e3
    mgr.close()
    torch.save({"params": {k: v.data.cpu()
                           for k, v in tr.get_params()[0].items()},
                "opt": {k: [leaf.cpu() for leaf in leaves]
                        for k, leaves in tr.opt_state_by_param().items()},
                "num_update": tr._num_update, "seed": tr._seed},
               os.path.join(out, f"p28b_rank{rank}.pt"))
    del tr
    dist.shutdown()
    return res


def p28_reference(torch, np, mx, plan):
    """The one-card run of (a): phase 9's trainer on the whole batch,
    its first heads and parameters, and each step's ms."""
    from mxnet_tpu_torch.parallel import ShardedTrainer
    sym = p23_lm_symbol(plan)
    shapes, args, batch = p23_lm_state(np, plan, sym)
    tr = ShardedTrainer(sym, optimizer="adam",
                        optimizer_params=dict(plan["lm"]["opt"]),
                        compute_dtype="bfloat16", fused_update=False,
                        device="cuda:0" if DEVICE == "cuda" else DEVICE)
    tr.bind({"data": shapes["data"]},
            {"softmax_label": shapes["softmax_label"]}, arg_params=args)
    got = {}

    def first(heads):
        got["heads"] = heads[0].float().cpu()
        got["params"] = {k: v.data.cpu()
                         for k, v in tr.get_params()[0].items()}

    rows = p28_steps(torch, plan, tr, tr.place_batch(batch), first)
    del tr
    tr, batch, args = p28_f32_trainer(
        np, plan, device="cuda:0" if DEVICE == "cuda" else DEVICE)

    def first32(heads):
        got["f32"] = {"heads": heads[0].float().cpu(), "args": args,
                      "params": {k: v.data.cpu() for k, v in
                                 tr.get_params()[0].items()}}

    rows += p28_steps(torch, dict(plan, p28=dict(plan["p28"], steps=1)), tr,
                      tr.place_batch(batch), first32)
    del tr
    return got, rows


def p28_f32_diffs(np, ref, got):
    """(a)'s float32 step against one card: the heads' largest
    difference; for each parameter, the root mean square of the update's
    difference over that of the one-card update (at least P28_F32_FLOOR
    of the largest over all parameters: a key bias's gradient is zero up
    to rounding), largest first; and the same with largest elements in
    place of root mean squares (a ReLU gate that flips on a rounding
    difference moves one of ~B*L terms of a sum)."""
    heads = float((got["heads"] - ref["heads"]).abs().max())
    moves = {}
    for k, a in ref["args"].items():
        a = np.asarray(a, np.float64)
        moves[k] = (a - ref["params"][k].double().numpy(),
                    a - got["params"][k].double().numpy())

    def worst(norm):
        floor = P28_F32_FLOOR * max(norm(d1) for d1, _ in moves.values())
        return sorted(((norm(d2 - d1) / max(norm(d1), floor), k)
                       for k, (d1, d2) in moves.items()), reverse=True)[:3]
    return (heads, worst(lambda x: float(np.sqrt(np.mean(np.square(x))))),
            worst(lambda x: float(np.abs(x).max())))


def p28_restore(torch, mx, plan, path, ranks_state):
    """(b): the ranks' checkpoint into a one-card ZeRO trainer, against
    what the ranks dumped: bitwise, and the restore's ms."""
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    a, b = ranks_state
    for k in a["params"]:
        check(torch.equal(a["params"][k], b["params"][k]),
              f"(b) the ranks' {k} differ")
    sym = p23_lm_symbol(plan)
    lm = plan["lm"]
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    tr = ShardedTrainer(sym, optimizer="adam",
                        optimizer_params=dict(lm["opt"]),
                        compute_dtype="bfloat16", shard_optimizer=True,
                        mesh=make_mesh({"data": 1}, [card]), seed=28)
    tr.bind({"data": (lm["batch"], lm["seq"])},
            {"softmax_label": (lm["batch"], lm["seq"])})
    mgr = checkpoint.CheckpointManager(os.path.dirname(path))
    t0 = time.perf_counter()
    _, step = tr.restore_state(mgr)
    ms = (time.perf_counter() - t0) * 1e3
    mgr.close()
    check(step == a["num_update"] == tr._num_update == plan["p28"]["steps"]
          and tr._seed == a["seed"],
          f"(b) restored update {tr._num_update} (step {step}), seed "
          f"{tr._seed}; the ranks held {a['num_update']}, {a['seed']}")
    for k, v in tr.get_params()[0].items():
        check(torch.equal(v.data.cpu(), a["params"][k]),
              f"(b) restored {k} differs from the ranks'")
    moments = 0
    for k, leaves in tr.opt_state_by_param().items():
        for i, leaf in enumerate(leaves):
            check(torch.equal(leaf.cpu(), a["opt"][k][i])
                  and torch.equal(a["opt"][k][i], b["opt"][k][i]),
                  f"(b) restored Adam state {k}:{i} differs")
            moments += 1
    del tr
    return {"restore_ms": ms, "moments": moments}


def p28_inspect(path):
    """``tools/torch_ckpt_inspect.py show --verify`` on the ranks'
    checkpoint: exit 0, every array OK."""
    import io as pyio
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_ckpt_inspect", os.path.join(here, "tools",
                                           "torch_ckpt_inspect.py"))
    inspect = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(inspect)
    from mxnet_tpu_torch.checkpoint import layout
    manifest = layout.read_manifest(path)
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = inspect.main(["show", path, "--verify"])
    text = buf.getvalue()
    check(rc == 0 and text.count("[OK]") == len(manifest["arrays"])
          and manifest["process_count"] == 2,
          f"(b) torch_ckpt_inspect show --verify exited {rc} over "
          f"{len(manifest['arrays'])} arrays, process_count "
          f"{manifest['process_count']}: {text[-2000:]}")
    files = [sh["file"] for e in manifest["arrays"].values()
             for sh in e["shards"]]
    return {"arrays": len(manifest["arrays"]), "shards": len(files),
            "rank1_shards": sum(f.endswith(".p1.bin") for f in files)}


def phase_process_meshes(torch, np, mx, _build):
    """Phase 28: (a) Megatron's split plan over a model axis across two
    processes on the card, (b) ZeRO over a data axis across them and its
    checkpoint, restored in this process.  Returns the K1-K4 launches of
    the ranks and of this process's one-card run, and its numbers."""
    import tempfile
    t_phase = time.perf_counter()
    launches = dict.fromkeys(P28_KERNELS, 0)
    stats = {"card": card_line() if DEVICE == "cuda" else "cpu"}
    plan = p23_plan(DEVICE)
    plan["p28"] = {"steps": P28_STEPS, "f32_layers": P28_F32_LAYERS,
                   "f32_lr": P28_F32_LR}
    steps, layers = P28_STEPS, plan["lm"]["layers"]
    builds = _build.build_count()
    with tempfile.TemporaryDirectory(prefix="p28-") as out:
        with open(os.path.join(out, "plan.json"), "w") as f:
            json.dump(plan, f)
        t0 = time.perf_counter()
        ref, ref_rows = p28_reference(torch, np, mx, plan)
        stats["one_card_s"] = time.perf_counter() - t0
        for row in ref_rows:
            p23_add(launches, row["counts"])
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = p23_spawn_ranks(out, "pm", p23_child_env(), phase=28)
        stats["ranks_s"] = time.perf_counter() - t0
        for r in ranks:
            check(r["backend"] == "gloo", f"rank {r['rank']} ran "
                  f"{r['backend']}, expected gloo (two processes, one card)")
            for part in ("a", "b"):
                for s, row in enumerate(r[part]["steps"]):
                    c, h = row["counts"], row["hopper"]
                    check(DEVICE != "cuda" or (
                        c["flash_attn_fwd"] == c["flash_attn_bwd"] == layers
                        and h["flash_attn_fwd"] == h["flash_attn_bwd"]
                        == layers and c["fused_update"] == 0),
                          f"({part}) rank {r['rank']} step {s} launched "
                          f"{c}, hopper {h}")
                    p23_add(launches, c)
            for row in r["a"]["f32_steps"]:
                p23_add(launches, row["counts"])
        a = ranks[0]["a"]
        from mxnet_tpu_torch.parallel import megatron_rules
        rules = megatron_rules()
        megatron = sorted(n for n in ref["params"] if rules.spec_for(n))
        check(a["plan"] == "split" and megatron == a["split"]
              and a["heads_per_member"] == plan["lm"]["heads"] // 2,
              f"(a) plan {a['plan']} ({a['reason']}), split "
              f"{len(a['split'])} params, {a['heads_per_member']} heads a "
              "member")
        reps = [torch.load(os.path.join(out, f"p28a_rank{i}.pt"))
                for i in range(2)]
        for k in reps[0]:
            check(torch.equal(reps[0][k], reps[1][k]),
                  f"(a) the ranks' replicated {k} differ")
        got = torch.load(os.path.join(out, "p28a_first.pt"))
        head_diff = float((got["heads"] - ref["heads"]).abs().max())
        step1 = max(float((got["params"][k].float()
                           - ref["params"][k].float()).abs().max())
                    for k in ref["params"])
        check(head_diff <= P20_TP_HEAD_TOL, f"(a) first heads {head_diff} "
              f"from one card's, over {P20_TP_HEAD_TOL}")
        check(step1 <= P20_TP_STEP1_LIMIT, f"(a) first update {step1} from "
              f"one card's, over {P20_TP_STEP1_LIMIT}")
        f32_heads, f32_rms, f32_max = p28_f32_diffs(
            np, ref["f32"], torch.load(os.path.join(out, "p28a_f32.pt")))
        f32_step = f32_rms[0][0]
        check(a["f32_plan"] == "split" and f32_heads <= P28_F32_HEAD_TOL,
              f"(a) float32 plan {a['f32_plan']}, heads {f32_heads} from "
              f"one card's, over {P28_F32_HEAD_TOL}")
        check(f32_step <= P28_F32_STEP_RTOL, f"(a) float32 SGD update "
              f"of {f32_rms[0][1]} {f32_step} from one card's (relative "
              f"root mean square), over {P28_F32_STEP_RTOL}")
        stats["a"] = {
            "plan": a["plan"], "split_params": len(a["split"]),
            "heads_per_member": a["heads_per_member"],
            "q_piece": a["q_piece"], "first_heads_max_diff": head_diff,
            "step1_max_param_diff": step1,
            "f32_sgd": {"layers": plan["p28"]["f32_layers"],
                        "heads_max_diff": f32_heads,
                        "update_rms_rel_diff": f32_rms,
                        "update_max_rel_diff": f32_max,
                        "ms": [r["a"]["f32_steps"][0]["ms"] for r in ranks],
                        "one_card_ms": ref_rows[-1]["ms"]},
            "ms_a_step": [[row["ms"] for row in r["a"]["steps"]]
                          for r in ranks],
            "one_card_ms_a_step": [row["ms"] for row in ref_rows[:-1]],
            "crossed_bytes_a_step": [r["a"]["steps"][-1]["crossed"]
                                     for r in ranks],
            "replicated_bitwise": len(reps[0])}
        b = ranks[0]["b"]
        state = [torch.load(os.path.join(out, f"p28b_rank{i}.pt"))
                 for i in range(2)]
        stats["b"] = {
            "ms_a_step": [[row["ms"] for row in r["b"]["steps"]]
                          for r in ranks],
            "crossed_bytes_a_step": [r["b"]["steps"][-1]["crossed"]
                                     for r in ranks],
            "zero_state_bytes": [r["b"]["zero_state_bytes"] for r in ranks],
            "write_ms": [r["b"]["write_ms"] for r in ranks]}
        t0 = time.perf_counter()
        stats["b"].update(p28_restore(torch, mx, plan, b["path"], state))
        stats["b"].update(p28_inspect(b["path"]))
        stats["restore_s"] = time.perf_counter() - t0
    check(_build.build_count() == builds,
          f"phase 28 built or first loaded {_build.build_count() - builds} "
          "kernel libraries")
    stats["launches"] = launches
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"  (a) Megatron over {{model: 2}} across 2 processes on one card: "
        f"{json.dumps(stats['a'])}")
    log(f"  (b) ZeRO over {{data: 2}} across 2 processes, save_state, "
        f"restored on one card: {json.dumps(stats['b'])}")
    log("  process meshes: " + json.dumps(
        {k: v for k, v in stats.items() if k not in ("a", "b")}))
    return launches, stats


def ptxas_summary(text):
    """``(kernel, registers, spills)`` per entry function of a ``ptxas
    -v`` log: the kernel's name (the lower-case identifier ending in
    ``_kernel`` after its length in the mangled name) with its first
    template argument as mangled, its registers at launch, and its spill
    line."""
    import re

    def name(mangled):
        m = re.search(r"\d((?:[a-z]+_)+kernel)(?:I(\w+?)E)?", mangled)
        if m is None:
            return mangled
        return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")

    rows, kernel, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel, spills = name(m.group(1)), ""
            continue
        if "spill stores" in line:
            spills = line.split(",", 1)[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spills))
            kernel = None
    return rows


def main(argv) -> int:
    if argv[:1] == ["--dist-worker"] and len(argv) == 3:
        return dist_worker(argv[1], argv[2])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--serve-ab"] and len(argv) == 2:
        return serve_ab(argv[1])
    serve_root = argv[1] if argv[:1] == ["--serve-only"] else None
    cost = argv[:1] == ["--telemetry-cost"]
    sys.path.insert(0, serve_root
                    or os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import _build, optimizer, quant, rtc
        from mxnet_tpu_torch.ops import fused_update as fu
        from mxnet_tpu_torch.ops import nn_ops
        from mxnet_tpu_torch.parallel import flash_attention as fa
        from mxnet_tpu_torch.serve import flash_decode as fd
        from mxnet_tpu_torch.serve import kvcache as kv
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 3
    # float32 products stay full float32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[1/28] device")
    smi = card_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    log("[2/28] build")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        for kernel, regs, spills in ptxas_summary(info["log"]):
            log(f"  {name}: {kernel}: {regs} registers, {spills}")
    if serve_root is not None:
        log(json.dumps(serve_only(torch, np, fd)))
        return 0
    if cost:
        log(json.dumps(telemetry_cost(torch, np, fd)))
        log(smi)
        return 0

    log("[3/28] kernels against their plain versions")
    errs = phase_kernel_vs_plain(torch, np, fd)
    fp8_errs, _ = phase_fp8_vs_plain(torch, np, fd, quant, kv)
    k1_errs = phase_k1_vs_plain(torch, np, nn_ops)
    k2_err = phase_k2_vs_unfused(torch, np, fu, optimizer)
    k34_errs = phase_k34_vs_plain(torch, np, fa)
    kern = rtc_kernels(torch, rtc)
    rtc_errs, _ = phase_rtc_vs_plain(torch, np, rtc, kern)

    log("[4/28] serving transformer-LM 6L d512 8 heads, 32k vocab")
    k5_launches, _ = phase_serve(torch, np, fd)

    log(f"[5/28] serving the round-12 configuration: chunked prefill "
        f"({R12_CHUNK}), f32 pools, then fp8 pools")
    fp8_launches, _ = phase_serve_r12(torch, np, fd, kv)

    log(f"[6/28] prefix cache: {PREFIX_REQUESTS} requests sharing a "
        f"{PREFIX_LEN}-token prefix, fp8 pools, defrag")
    phase_prefix_cache(torch, np, fd)

    log(f"[7/28] training ResNet-{DEPTH}, batch {BATCH}, "
        f"{'x'.join(map(str, IMAGE))}, {CLASSES} classes, f32")
    train_launches, train_stats = phase_train(torch, np, nn_ops, fu)

    log("[8/28] kernel timing")
    floor = phase_launch_floor(torch)
    timing = {"flash_decode": phase_timing_decode(torch, np, fd, quant, kv,
                                                  False),
              "flash_decode_fp8": phase_timing_decode(torch, np, fd, quant,
                                                      kv, True),
              "softmax_rows": phase_timing_k1(torch, np, nn_ops),
              "fused_update": phase_timing_k2(torch, np, fu)}
    for name in ("softmax_rows", "flash_decode", "flash_decode_fp8"):
        log(f"  {name}: {timing[name]['ms']:.6f} ms, "
            f"{timing[name]['ms'] - floor:.6f} ms above the launch floor")
    phase_decode_sweep(torch, np, fd, quant, kv)
    k34_timing = phase_timing_k34(torch, np, fa)
    # the LM's main path runs K3/K4 in bf16: those times go to the line
    timing.update(k34_timing["bf16"])
    timing.update(phase_timing_rtc(torch, np, kern))

    log(f"[9/28] training transformer-LM {LAYERS}L d{D_MODEL} {HEADS} heads, "
        f"{VOCAB} vocab, batch {LM_BATCH}, seq {LM_SEQ}, bf16 compute, "
        "Adam")
    lm_launches, lm_stats = phase_train_lm(torch, np, fa, fu)

    log("[10/28] imperative + executor: NDArray on the card, the MLP "
        f"{MLP_IN}-128-64-{MLP_CLASSES} with a K6 softmax head, batch "
        f"{MLP_BATCH}")
    phase_imperative(torch, np)
    rtc_launches, _ = phase_rtc_mlp(torch, np, mx, kern, nn_ops)

    log(f"[11/28] speculative decoding: {SPEC_REQUESTS} requests x "
        f"{SPEC_NEW} new tokens, k {SPEC_K}, chunks of "
        f"{SPEC_KW['prefill_chunk']}")
    t0 = time.perf_counter()
    spec_k5, spec_k5_fp8, _ = phase_speculate(torch, np, fd)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    log("[12/28] the serving control plane: crash failover, a hung and a "
        "poisoned replica, rolling swaps, the diurnal gameday with "
        "autoscaling, speculation under the router")
    t0 = time.perf_counter()
    cp_k5, _ = phase_control_plane(torch, np, fd, _build)
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[13/28] the training loop: ShardedTrainer.fit on ResNet-{DEPTH} "
        f"({LOOP_EPOCHS} epochs of {LOOP_BATCHES} batches, then under chaos) "
        f"and on the LM ({LM_LOOP_BATCHES} batches)")
    loop_launches, _ = phase_train_loop(
        torch, np, nn_ops, fu, fa, _build, train_stats["median_step_ms"],
        lm_stats["median_step_ms"])
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[14/28] the zoo and the legacy API: {', '.join(ZOO_NETS)} through "
        f"ShardedTrainer ({ZOO_STEPS} steps, batch {BATCH}, bf16), "
        "FeedForward and Module on inception-bn-28-small, BucketingModule "
        "over the LSTM, the new ops on the card")
    zoo_launches, _ = phase_zoo_legacy(torch, np, nn_ops, fu, _build)
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[16/28] long training runs: the LM with fp8 linears, recompute "
        f"scopes, {LONG_ACCUM} microbatches and dynamic loss scaling; fit "
        "with checkpoints, resume, SIGTERM, rollback; serving and the "
        "online loop from the checkpoint")
    long_launches, _ = phase_long_runs(torch, np, fa, fu, fd, quant, _build)
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[17/28] programs and the profiler: serve and train steps "
        "captured as CUDA graphs (the engine's warmup, ShardedTrainer."
        "compile, Module and BucketingModule compile), replays against "
        "eager, profiler.trace and profile_step, the persistent cache")
    p17_launches, _ = phase_programs(torch, np, nn_ops, fu, fa, fd, _build)
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[18/28] data parallelism in one process: ResNet-{DEPTH} through "
        "ShardedTrainer over the data mesh (implicit, int8 with error "
        "feedback fused and unfused, ZeRO), FeedForward and Module over two "
        "contexts of one card with the device kvstore, the kvstore over "
        "CUDA members, distinct cards where there are two")
    p18_launches, _ = phase_data_parallel(torch, np, _build)
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[19/28] input records, the deployment predictor and the last ops: "
        f"{REC_IMAGES} packed images through ImageRecordIter into "
        f"ResNet-{DEPTH}'s fit, predictor.create and an exported artifact "
        f"served without the port, WarpCTC at the OCR example's sizes, the "
        "detector (Proposal, ROIPooling)")
    p19_launches, _ = phase_records_predictor(torch, np, nn_ops, fu, _build)
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[20/28] tensor and model parallelism: the LM with its embedding "
        f"on the host through group2ctx, the split rewrite of "
        f"megatron_rules() at a model axis of 1, two cards where there "
        f"are two")
    p20_launches, _ = phase_tensor_model_parallel(torch, np, mx, fa, nn_ops,
                                                  _build)
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[21/28] mixture of experts and ring attention: MoEFFN (8 experts "
        f"of {P21_MOE['hidden_size']}, top-2 then top-1, aux head) over "
        f"{P21_TOKENS[0] * P21_TOKENS[1]} tokens at d {D_MODEL} on the card "
        f"against the host, ring_self_attention over a one-card seq mesh at "
        f"the LM's attention shape, two cards where there are two")
    p21_launches, _ = phase_moe_ring(torch, np, mx, fa, fu, _build)
    log(f"  phase 21 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[22/28] pipelines: the LM through PipelineTrainer over "
        f"{P22_STAGES} stages on the card (1F1B, remat) against "
        f"ShardedTrainer, the dryrun's MLP through PipelineTrainer, "
        f"SpmdPipelineTrainer and pipeline_apply, two cards where there "
        f"are two, the LM over {{model: 2, seq: 2}} where there are four")
    p22_launches, _ = phase_pipelines(torch, np, mx, fa, nn_ops, fu, _build)
    log(f"  phase 22 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[23/28] the multi-process tier: launch_local with 1 scheduler, "
        f"{P23_SERVERS} servers and {P23_WORKERS} workers on the card "
        f"(dist_sync exact aggregation and ResNet-{DEPTH} through "
        f"FeedForward.fit, then dist_async), the LM through ShardedTrainer "
        f"over a data mesh of 2 processes (gloo on one card; NCCL over two "
        f"cards where there are two)")
    p23_launches, _ = phase_multiprocess(torch, np, mx, nn_ops, fu, fa)
    log(f"  phase 23 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[24/28] the multi-process tier, part two: the watchdog on the card "
        "(a hung, a dead and a dead monitor rank of three over gloo), "
        "ElasticTrainer under membership chaos through "
        "tools/torch_launch.py, SIGTERM inside a step, a live resize where "
        "two cards exist")
    p24_launches, _ = phase_elastic(torch, np, mx)
    log(f"  phase 24 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[25/28] the analysis tooling on the card: the LM's captured step "
        f"({P25_LAYERS} layers) with async CUDA checkpoints and the "
        f"prefetcher under the concurrency sanitizer, the schedule fuzzer's "
        f"six scenarios ({P25_SEEDS} seeds each, routers replaying K5), the "
        f"static gate")
    p25_launches, _ = phase_analysis(torch, np, mx, fa, fu, fd)
    log(f"  phase 25 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[26/28] the program auditor on the card: the LM ({LAYERS}L "
        f"d{D_MODEL}, batch {LM_BATCH} x {LM_SEQ}) and ResNet-{DEPTH} "
        f"(batch {BATCH}) captured under audit_on_compile and audited by "
        f"audit_trainer, the engine's decode programs over fp8 and plain "
        f"pools, torch_staticcheck audit and gate")
    p26_launches, _ = phase_program_audit(torch, np, mx, nn_ops, fa, fu, fd)
    log(f"  phase 26 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[27/28] the tuned conv backward, the C predict API and the last "
        f"tools: _conv2d_bwd under tuned against cuDNN's at batch "
        f"{P27_BATCH} (bf16, f32) with torch_conv_probe's times, "
        f"ResNet-{DEPTH} steps under tuned and the default, phase 19's "
        f"artifact served from C, torch_im2rec and torch_ckpt_inspect")
    p27_launches, _ = phase_conv_tools(torch, np, nn_ops, fu, _build)
    log(f"  phase 27 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[28/28] meshes that span processes, two ranks on the card over "
        f"gloo: the LM ({LAYERS}L d{D_MODEL}, batch {LM_BATCH} x {LM_SEQ}, "
        f"bf16, Adam) under megatron_rules() over {{model: 2}} across the "
        f"ranks against one card, then with ZeRO over {{data: 2}} across "
        f"them, save_state by both and a restore on one card")
    p28_launches, _ = phase_process_meshes(torch, np, mx, _build)
    log(f"  phase 28 took {time.perf_counter() - t0:.1f} s")

    # the result comes last, after phase 28
    log("[15/28] result")
    # K3/K4 run the hopper form on the main path: their max abs error is
    # that form's, over its cases
    hopper_errs = [v for v in k34_errs.values() if v[4] == "hopper"]
    rows = [
        # the main paths' forms: K5 and K5-fp8 hopper, K1 warp
        # K5 and K5-fp8 launch on phases 4-6 and in phase 11's
        # non-speculative baselines (never in its speculative runs); K5
        # also on every replica of phase 12
        ("flash_decode", "mxnet_tpu_torch/csrc/flash_decode.cu",
         "mxnet_tpu/serve/flash_decode.py:60",
         k5_launches + spec_k5 + cp_k5 + long_launches["flash_decode"]
         + p17_launches["flash_decode"] + p25_launches["flash_decode"]
         + p26_launches["flash_decode"],
         max(v for (k, f), v in errs.items()
             if "bf16" not in k and f == "hopper")),
        ("flash_decode_fp8", "mxnet_tpu_torch/csrc/flash_decode.cu",
         "mxnet_tpu/serve/flash_decode.py:60",
         fp8_launches + spec_k5_fp8 + p17_launches["flash_decode_fp8"]
         + p26_launches["flash_decode_fp8"],
         max(v for k, v in fp8_errs.items()
             if k.endswith("float32 q, hopper"))),
        ("softmax_rows", "mxnet_tpu_torch/csrc/softmax_rows.cu",
         "mxnet_tpu/ops/nn_ops.py:847",
         train_launches["softmax_rows"] + loop_launches["softmax_rows"]
         + zoo_launches["softmax_rows"] + p17_launches["softmax_rows"]
         + p18_launches["softmax_rows"] + p19_launches["softmax_rows"]
         + p22_launches["softmax_rows"] + p23_launches["softmax_rows"]
         + p24_launches["softmax_rows"] + p26_launches["softmax_rows"]
         + p27_launches["softmax_rows"] + p28_launches["softmax_rows"],
         max(v for k, v in k1_errs.items()
             if "float32" in k and k.endswith("warp"))),
        # K2 runs on the training paths: ResNet-50 (SGD) and the LM
        # (Adam), stepped bare (phases 7, 9) and through fit (phases 13,
        # 19), the four ImageNet nets (phase 14), the OCR net (19), the
        # MoE trainers (21), the LM's ranks and its one-process run
        # (23), and the watchdog's training ranks and the SIGTERM run
        # (24; ZeRO's update is unfused, as in the JAX trainer), and the
        # ResNet-50 steps under both conv backward policies (27)
        ("fused_update", "mxnet_tpu_torch/csrc/fused_update.cu",
         "mxnet_tpu/ops/fused_update.py:216",
         train_launches["fused_update"] + lm_launches["fused_update"]
         + loop_launches["fused_update"] + zoo_launches["fused_update"]
         + long_launches["fused_update"] + p17_launches["fused_update"]
         + p18_launches["fused_update"] + p19_launches["fused_update"]
         + p21_launches["fused_update"] + p23_launches["fused_update"]
         + p24_launches["fused_update"] + p25_launches["fused_update"]
         + p26_launches["fused_update"] + p27_launches["fused_update"]
         + p28_launches["fused_update"],
         k2_err),
        ("flash_attn_fwd", "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
         "mxnet_tpu/parallel/flash_attention.py:77",
         lm_launches["flash_attn_fwd"] + loop_launches["flash_attn_fwd"]
         + long_launches["flash_attn_fwd"] + p17_launches["flash_attn_fwd"]
         + p20_launches["flash_attn_fwd"] + p21_launches["flash_attn_fwd"]
         + p22_launches["flash_attn_fwd"] + p23_launches["flash_attn_fwd"]
         + p24_launches["flash_attn_fwd"] + p25_launches["flash_attn_fwd"]
         + p26_launches["flash_attn_fwd"] + p28_launches["flash_attn_fwd"],
         max(e[2] for e in hopper_errs)),
        ("flash_attn_bwd", "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
         "mxnet_tpu/parallel/flash_attention.py:264",
         lm_launches["flash_attn_bwd"] + loop_launches["flash_attn_bwd"]
         + long_launches["flash_attn_bwd"] + p17_launches["flash_attn_bwd"]
         + p20_launches["flash_attn_bwd"] + p21_launches["flash_attn_bwd"]
         + p22_launches["flash_attn_bwd"] + p23_launches["flash_attn_bwd"]
         + p24_launches["flash_attn_bwd"] + p25_launches["flash_attn_bwd"]
         + p26_launches["flash_attn_bwd"] + p28_launches["flash_attn_bwd"],
         max(e[3] for e in hopper_errs)),
        # K6: the runtime (mxnet_tpu_torch/rtc.py) compiles these user
        # sources, which live in this script
        ("rtc_softmax_fwd", "chip_smoke.py", "mxnet_tpu/rtc.py:60",
         rtc_launches["rtc_softmax_fwd"],
         max(v for k, v in rtc_errs.items() if "softmax fwd" in k)),
        ("rtc_softmax_bwd", "chip_smoke.py", "mxnet_tpu/rtc.py:60",
         rtc_launches["rtc_softmax_bwd"],
         max(v for k, v in rtc_errs.items() if "ce bwd" in k)),
    ]
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
        **({"form": timing[name]["form"]} if "form" in timing[name] else {}),
        **({k: timing[name][k] for k in K2_LINE_KEYS if k in timing[name]}
           if name == "fused_update" else {}),
    } for name, source, replaces, launches, err in rows]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
