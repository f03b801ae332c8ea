"""Chip smoke test of horovod_tpu_torch: build, hold, train, report.

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``device``  — the card's name and ``nvidia-smi`` name/power limit.
2. ``build``   — nvcc seconds per kernel source (all built in parallel).
3. ``kernels`` — K1 ``flash_fwd``, B2 ``flash_bwd`` (the combined
   backward, on the body K5 shares) and K2 ``flash_bwd_dkdv`` + K3
   ``flash_bwd_dq`` (the split pair) held against their plain PyTorch
   versions (``ops/attention.py``) on the same inputs, each backward
   against the plain side of its own key tile: bf16 and f32 at the main
   path's shape (16, 8, 1024, 64), fp16, a non-causal case, and a ragged
   length with head_dim 128; in f32 also head dims 32, 96, 128 and 256
   (K1 and the split pair: the combined mode has no body at 256), a
   ragged non-causal length and a causal seq 8192 (K3's dQ summed over
   256 key tiles), dq's reading over query rows 0-7 reported
   apart under the limit without and with float32 dq's term.
   Times (CUDA events, median after warm-up) of K1 and B2 (and K2 + K3
   beside B2), in bf16 and f32 (all four on their 3xTF32 wgmma bodies,
   beside SDPA in float32), their
   plain versions and the library yardstick
   (``scaled_dot_product_attention``, which the port never calls, timed
   under each backend that takes the shape: flash, memory-efficient and
   cuDNN; ``library_ms`` is the fastest).
4. ``model``   — a small TransformerLM on the card: the kernels' path
   against the plain blockwise path, logits and every gradient.
5. ``train``   — the main path: ``hvd.init()``, the bench-width
   TransformerLM (vocab 32768, d_model 512, 8 layers, 8 heads, d_ff 2048,
   bf16, bf16 logits), ``DistributedOptimizer(AdamW)`` and
   ``build_train_step``, batch 16 x seq 1024, 2 warm-up + 5 timed steps.
   Launch counters are zeroed just before and read just after: K1 and B2
   must have run 8 layers x 7 steps times, K2 and K3 never (the
   reference's plan picks the combined backward at this shape).
   Then ``fused_loss``, the same path with the fused head and loss
   (``build_lm_step(fused_loss=True)``: ``model(inputs, targets=)``, 8
   chunks of 2048 tokens, each chunk's float32 logits recomputed in the
   backward): in float32 (TF32 off) the loss and every parameter's
   gradient against ``next_token_loss`` on float32 logits, at
   ``HEADLINE``'s batch (8 chunks) and at 3 x 1023 tokens (8 does not
   divide them: one chunk), each element within 1e-6 + 1e-5 |ref| (the
   reference's CPU tolerances) plus 3 x the spread of two runs of the
   logits path, the loss within 3 x that spread, at least 1e-6 relative;
   in bf16 each path's loss and gradient norms (printed, not gated); 2
   warm-up + 5 timed bf16 steps beside ``train``'s: tokens/s, step ms and
   peak memory, the peak gated lower than ``train``'s, K1 and B2 8 x 7
   times, K2 and K3 never; the head and loss alone, forward and backward
   (CUDA events), fused against the logits path.
   Then ``split``, the split pair's own path: at a shape where the plan
   picks it (1040 batch-heads, seq 512, bf16) K2 and K3 (and B2 beside
   them) held against the plain version that walks their key tile;
   ``flash_attention`` forward and backward with the counters zeroed just
   before and read just after (K1, K2 and K3 once, B2 never), its
   gradients against the plain blockwise path, here and at 65,600
   batch-heads (seq 16, head_dim 32) in bf16 and f32; the times of K2,
   K3 and B2 apart, beside SDPA's backward and K2's and K3's bounds, here
   and at seq 8192 (64 batch-heads) and 16384 (32), where the plan also
   picks the split pair (K2's and K3's entries in the summary come from
   the first shape).
   Then ``head_dims``: K1, K2 and K3 at head dim 256 (bf16, 1040
   batch-heads x seq 512; f32, 64 x 1024, all three on the 3xTF32 bodies
   of ``flash_wide_f32_sm90.cuh``) and on their wide bodies
   (``flash_wide.cu``) at
   288, 512 (64 batch-heads x seq 1024) and 1000 (32 x 1024, run padded
   to 1024) in bf16 (K1, K2 and K3 on the wgmma bodies of
   ``flash_wide_sm90.cuh``), at 512 in fp16, and in f32 at 288 (8
   batch-heads x seq 512, and 64 x 1024) and 512 (64 x 1024): K1 and K2
   on the 3xTF32 wgmma bodies of ``flash_wide_f32_sm90.cuh``, K3 on SIMT;
   f32 bounds at the 3xTF32 rate (``PEAK_FLOPS``), and K1 and B2 at
   head dims 16 and 80 on the main path's shape (run zero-padded to 32
   and 96), each held alone against its plain version at the caller's
   head dim, the padded columns exactly 0; ``flash_attention`` forward
   and backward at each with the counters zeroed just before and read
   just after (K1 1, and K2 1 + K3 1 at 256 and above, B2 1 at 16 and
   80), its output and gradients against the plain blockwise path; times
   beside SDPA's fastest backend at the same head dim (above 256 the math
   backend too), the bound of the caller's work, the TFLOP/s and share of
   that bound, and above 256 the SIMT bodies' times (bf16; f32 K1 and
   K2) quoted from PERF.md in this phase's line only (not measured here,
   so never in the summary).  The summary's rows of head dims 256 and
   above come from here.
6. ``ring_kernels`` — K4 ``ring_flash_fwd``, K5 ``ring_flash_bwd``, K6
   ``ring_permute`` and K7 ``phase_closer`` on a ring of 4 members
   co-located on the card (``RingMesh``, one stream each), shard
   (4, 8, 1024, 64): K4 and K5 in bf16 and f32 (the f32 on the 3xTF32
   wgmma bodies of ``flash_wide_f32_sm90.cuh`` at the step's offsets;
   float32 dq with its term) on diagonal, wholly
   visible and wholly masked steps, rotating and not, against their plain
   versions (POS_BIG lse rows must match, masked outputs be exactly 0),
   the rotated K/V in the neighbours' slots bit for bit; K6 bit-exact at
   shift +1 and -1 with its VJP; K7's zero block, and every flag word
   back at 0 after a fused forward + backward.
   Times of each kernel, its plain version and its library yardstick
   (K4 and K5 in bf16, and in f32 beside them); K6
   and K7 also by CUDA events on the member streams around their four
   launches alone (``kernel_ms``), beside their rounds with the fork and
   join, with K6 moving no bytes (its handshake and gate alone), an empty
   kernel per member (the floor of that measurement) and one ``copy_``
   per member on its stream.
7. ``ring_model`` — a small f32 LM sequence-parallel over 4 members in the
   fused, rdma and ppermute modes against the unsharded model on the same
   weights and tokens: logits and every gradient to 1e-4, and the launch
   counts each mode implies.
8. ``ring_train`` — the slice's path at full width: the same bench-width
   LM sequence-parallel over 4 members (``RING_HEADLINE``), batch 4 x seq
   4096, fused ring, 2 warm-up + 5 timed steps; counters zeroed just
   before and read just after, which must equal, per member, layer and
   step, K4 n, K5 n and K7 2 (n = 4 is even).  Then ``ring_train_rdma``:
   two steps of the rdma ring at the same width, K6 2(n-1) forward +
   2(n-1) backward per member and layer.

9. ``engine``  — the port's collective engine (``engine/cc``, host C++):
   the g++ seconds of its build (started beside the nvcc builds) and its
   exported dynamic symbols, which must all be ``hvd_tpu_*``.
10. ``collectives`` — 2 ranks started by the port's runner
   (``horovod_tpu_torch.runner``) on this one card, each
   ``hvd.init(device="cuda:0")``, CUDA tensors staged through pinned host
   memory to the engine's host ring: allreduce (sum and average) in f32,
   bf16, f16 and i32 at 1, 1001 elements and 64 MiB (small integers, so
   every sum is exact in 16 bits), the in-place variants, 64 small
   tensors enqueued async and completed in fewer engine cycles than
   tensors (fusion), allgather with a different dim 0 per rank, broadcast
   from root 1, each against its exact value; a shape mismatch across
   ranks must raise ``ValueError``, not hang.  Then an allreduce of 224
   MiB of f32 (the LM's gradient bytes) split into D2H, engine and H2D
   milliseconds, and timed whole; and the engine alone on host buffers
   of 1, 4, 16, 64 and 224 MiB.
11. ``train_dp`` — the main path data-parallel over 2 ranks on this card:
   ``HEADLINE`` per rank (weak scaling), rank r's weights seeded 100 + r
   and then broadcast from rank 0 with the optimizer state,
   ``DistributedOptimizer(AdamW)`` and ``build_train_step``, 2 warm-up +
   5 timed steps.  Every parameter must be equal across ranks bit for bit
   (one digest per rank), the loss finite and falling, K1 and B2 launched
   8 x 7 times per rank and K2, K3 never; printed: the job's tokens/s (2 x
   16,384 tokens a step), step ms, ``sync_sec``, each rank's peak memory,
   the engine cycles that completed each step's 51 gradient handles, and
   one profiled step's kernel, D2H and H2D milliseconds.  Then the
   averaging check: 3 steps of both ranks from one seed, rank r on rows
   [8r, 8r + 8) of a 16-row batch, against 3 steps of the size-1 step on
   all 16 rows; the losses must agree within 3 x the spread of two
   size-1 runs, with a floor of 1e-3 relative (printed beside them).
   Then ``ring_dp``: dp x sp, 2 ranks sharing the card, each
   ``build_lm_step(**RING_HEADLINE)`` (a fused ring of 4 members, batch 4
   x seq 4096 per rank, 2 x 16,384 tokens a job step; rank r's weights
   seeded 100 + r, then broadcast), 2 warm-up + 5 timed steps.  Printed:
   job tokens/s over the slower rank's median step, median step and sync
   ms, peak memory, launches, flags and one parameter digest per rank.
   Gates: per rank K4 and K5 n x n x 8 layers x 7 steps, K7 2 x n x 8 x
   7 (n = 4 is even), K6 never; equal digests and losses across ranks;
   balanced flags; losses finite, starting within 1 of ln(32768) and
   falling.  Then its averaging check: 3 steps of both ranks from
   ``AVG_SEED``, rank r on rows [2r, 2r + 2) of one 4-row batch whose
   rows 2 and 3 (rank 1's) hold only their first 512 targets (a mask),
   against 3 size-1 ring steps on all 4 rows with the whole mask, within
   ``train_dp``'s rule (``tools/torch_averaging_control.py --ring``
   normalises each rank's loss by its own count and must fail it).
11b. ``compression`` — ``train_dp``'s 2 ranks, seed and data under
   ``HVD_TPU_COMPRESSION=bf16``, then ``fp8`` (floor 1024 B), 2 warm-up +
   5 timed steps each: float32 gradient buckets at or above the floor
   cross the engine's ring narrowed, with an error-feedback residual per
   gradient name.  Printed beside ``train_dp``'s: tokens/s, median step
   and sync ms; the engine's wire and payload bytes over the timed steps
   and their ratio, its buckets per mode, the residual gauges after each
   step, the losses and their gap to ``train_dp``'s.  Gates, each mode:
   equal digests and equal per-bucket decision logs across ranks;
   wire/payload <= 0.51 (bf16) or <= 0.26 (fp8); one residual per float32
   gradient at or above the floor, constant over the steps; losses finite
   and falling; K1 and B2 launched as in ``train_dp``.  bf16 also: every
   step's loss within 2% relative of ``train_dp``'s (the bound of the
   reference's ``test_convergence_bf16_matches_fp32``); fp8's gap is
   printed only.
11c. ``autotune`` — the same step under ``HVD_TPU_AUTOTUNE=1`` from bad
   parameters (fusion threshold 1 KiB, cycle 50 ms, windows of 8
   collectives, 1 warm-up window) until a collective poll finds every
   rank's tuner frozen, or 40 steps, then 3 steps at the frozen point.
   Printed: the windows, the frozen step and point, step ms over the
   first and the last 3 steps beside ``train_dp``'s.  Gates: the applied
   sequences (tick, threshold, cycle, frozen) and the digests equal
   across ranks, losses finite, the threshold at least 64 KiB at the end.
12. ``timeline`` — 3 steps of ``HEADLINE`` on 2 ranks started by the
   port's launcher with ``--timeline DIR`` (``HVD_TPU_TIMELINE=DIR/``):
   each rank's trace parses as Chrome trace JSON, carries the ``hvd_rank``
   and ``hvd_clock_sync`` metadata, never steps back in time on a row
   (rank 0's ``RANK_READY`` instants carry the announcing rank's time), and holds
   exactly 3 ``TRAIN_STEP`` spans; on every gradient row B/E balance and
   each ``ALLREDUCE`` closes with ``bytes`` > 0, and on rank 0 (the
   coordinator, the one rank that records negotiation) the row opens
   with a ``NEGOTIATE`` that closes before its ``ALLREDUCE``;
   ``tools/timeline_merge.py DIR`` exits 0.  Printed per step and rank:
   the ms covered by ``NEGOTIATE`` spans and by ``ALLREDUCE`` spans (and
   by their activities: ``RING_ALLREDUCE`` on the wire, the host copies
   ``MEMCPY_IN_FUSION_BUFFER`` and ``MEMCPY_OUT_FUSION_BUFFER``) inside the
   step's span, and
   the step ms with the timeline on beside ``train_dp``'s.
   Then ``metrics``: ``train_dp``'s 2 ranks, seed and data with the
   metrics registry on (``HVD_TPU_METRICS=1``, a monitor port, a metrics
   file and a postmortem dir).  Rank 0 scrapes its ``/metrics`` (held to
   ``tools/hvdlint/metrics_check.py``'s ``lint``; ``step_sec`` counts the
   7 steps, ``wait_sec`` and ``negotiation_sec`` non-empty) and
   ``/cluster`` (2 of 2 live); the ``ops`` counters give 52 collectives a
   step; launches as ``train_dp``'s; losses within 1e-3 of its; the step
   median printed beside ``train_dp``'s with the ratio.  Then a 2-rank
   crash job, ``HVD_TPU_FAULT_SPEC`` killing rank 1 at step 2's 11th
   collective: both ranks' ``rank-N.json`` in the postmortem dir,
   rendered by ``tools/postmortem_dump.py``, and the runner's
   ``failure_report`` pointing at rank 1's.
13. ``checkpoint`` — 2 ranks, ``HEADLINE``: 2 steps, a sharded save of
   ``{"model", "optimizer", "step"}`` with ``keep=2``, a third step and
   a second save; per rank the save ms and the shard's bytes.  A fresh
   model and ``DistributedOptimizer`` (another seed) load the latest
   checkpoint collectively onto the card: every parameter and
   optimizer-state tensor bit-equal to the live ones (digests).  Two
   more steps from the live and from the restored state: the losses
   within 1e-3 relative (``train_dp``'s floor; B2's dQ reduces are not
   ordered).  Then 4 float32 requests served at size 1 through
   ``serving/engine.py`` from the sharded checkpoint and from the live
   parameters (rank 0's ``state_dict`` through ``torch.save``): the
   tokens equal.  All under a temporary directory, deleted after.
13b. ``elastic`` — 4 ranks of ``HEADLINE`` on this card under the
   elastic launcher (``run_membership``, min-np 2, no standby), each
   through ``DistributedOptimizer(AdamW)`` with the state plane armed,
   ``ElasticState(model=model.state_dict(), opt=opt.state_dict(),
   step=0)`` under ``run_elastic`` and a snapshot after each of 8 steps;
   ``HVD_TPU_FAULT_SPEC`` crashes slot 2 at a gradient allreduce of step
   4's backward (the op index counted from the structure,
   ``elastic_ops``, and checked against the lost rank's own count).
   Gates: slot 2 exits 43, the others 0; every survivor at size 3, epoch
   1, ranks lost [2], dense ranks 0-2; a peer restore and no root
   broadcast on each; the state each survivor holds on re-entering is
   bit-equal (``device_digest``: integer sums of the bit patterns, on
   the card) to rank 0's at the fence step and differs from its step
   before; equal final states; finite losses; K1 and B2 launched on every
   rank.  Printed: the capture's ms on the step path and the background
   write's per snapshot, the shard bytes per rank, restore ms, the ms
   from the crash (the launcher's report) and from each survivor's
   failed step to the end of its first step after the restore, step ms
   at 4 and at 3 ranks, peak memory per rank, the phase's seconds.
13c. ``topology`` — 4 ranks of ``train_dp``'s step (its model, seed and
   data, 16 x 1024 tokens a rank) on this card, 1 warm-up + 3 timed
   steps, three runs in turns in one job (a, b, c, c, b, a; the engine
   restarted with each run's knobs, the parameters and optimizer state
   put back to the first build's):
   (a) 2 nodes x 2 faked on
   this host (the launcher's local rank and size re-shaped before
   ``init()``) with ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``,
   ``HVD_TPU_COORD_TREE=1`` and ``HVD_TPU_SHM=force`` (a fall-back to TCP
   fails ``init()``), (b) the same with ``HVD_TPU_SHM=0``, (c) the flat
   ring.  After the steps each rank averages a probe through the engine:
   one float32 tensor per parameter, on the card, small integers from a
   seed, so that the exact average is known whatever the order of the
   sums (the parameters of two runs differ in their last bits: the
   gradient buckets' fusion follows timing, and a ring sums a segment in
   an order that depends on where it lies).  Gates: within each run the
   parameters' and the probe's digests equal across ranks; every run's
   probe equal to the exact average computed here; (a)'s losses within
   ``train_dp``'s rule of (c)'s (3 x the spread of two size-1 runs of the
   step, floor 1e-3 relative); rank by rank the ``topology`` section
   two-level on 2 nodes of 2 with ``local_transport`` ``shm`` in (a),
   ``tcp`` in (b), flat in (c); ``control`` the tree (depth 2, 2 hosts)
   in (a) and (b), the star in (c); the node-local peer's link on shm
   with bytes in (a); K1 and B2 8 x 4 times a rank in each turn.  Printed
   per run, over its two turns: the
   slower rank's step median, each rank's ``synchronize`` median, the
   medians a step of the engine's local reduce-scatter, cross and local
   allgather ms (its per-bucket topology log), the probe's ms, rank 0's
   local link (shm bytes and hand-offs), the launches.
13d. ``chaos`` — the network fault injector through the launcher's
   ``--net-fault-spec``: ``train_dp``'s step at 2 ranks (1 + 3 steps) under
   ``link=0-1:flaky=0.05`` and, side by side on the card,
   ``link=0-1:delay=5``, and 4 ranks of
   small allreduces on the card under ``partition=0,1/2,3@after=4`` with
   ``--postmortem-dir`` (heartbeats 100 ms x 10).  Gates: the flaky and
   slow jobs' probes exact, their parameters equal across ranks, their
   losses within ``train_dp``'s rule of ``train_dp``'s, no eviction, K1 and
   B2 launched; link 0-1's timed sends at least 5 ms on average in the
   slow job (rank 0's and rank 1's views); the partition job exits 7 (the
   typed error's code), every rank raises ``RanksDownError`` within 15
   s of its loop's start (whom it names is printed), and every rank
   leaves its postmortem dump.  Printed: step and ``synchronize`` medians beside
   ``train_dp``'s, the links' send means, the ``faults`` section (the
   process injector's firings: empty, as the reference's), the
   anomalies (a 2-rank job has one link: the detector needs 3 to
   localize one), the partition's times and the names each side gave.
13e. ``subset`` — rank-subset init: 3 ranks of the port's runner on
   this card, of which launcher rank 1 never calls ``init()`` and exits,
   and ranks 0 and 2 call ``init(comm=[0, 2], device="cuda:0")`` and run
   ``train_dp``'s step (its seed and split batch, 1 warm-up + 2 timed
   steps, counters zeroed just before).  Gates: ``size()`` 2 and
   ``rank()`` 0 and 1 in the list's order; the probe (one small-integer
   float32 tensor per parameter on the card) averaged exactly; the two
   members' parameters bit-identical; their losses within
   ``train_dp``'s rule of ``train_dp``'s own first 3; K1 and B2 launched
   8 x 3 times on each member, K2 and K3 never.  Printed: the step ms
   beside ``train_dp``'s and whether the losses equal ``train_dp``'s bit
   for bit.
14. ``pipeline`` — the pipeline path (``PIPE_HEADLINE``: the main path's
   widths, 2 stages of 4 layers, 4 micro-batches of 4 x 1024) on 2 stage
   ranks of the port's runner sharing this card, through
   ``torch/train.py::run_pipeline`` (1F1B over the engine's p2p plane,
   activations in pinned float32 buckets), 2 warm-up + 5 timed steps.
   First K1 and B2 alone at the micro-batch's shape (4, 8, 1024, 64),
   bf16, causal, against their plain versions, and timed there beside
   SDPA's fastest backend and their bounds.  Printed: job tokens/s (16,384
   tokens a step over the slower rank's median step, host clock), each
   rank's median step, p2p sends, recvs and bytes per step, the engine's
   cache hit rate over the timed steps, the bubble fraction, peak memory
   per rank.  Gates: per rank K1 and B2 launched 4 layers x 4
   micro-batches x 7 steps = 112 times, K2 and K3 never (the reference's
   plan at this shape), no unmatched transfer, hit rate >= 0.9, losses
   finite, starting within 1 of ln(32768) and falling; and the float32
   parity: 3 steps of the pipeline from ``AVG_SEED`` against 3 size-1
   ``build_lm_step`` steps on the whole batch (float32 logits), the last
   stage's loss and each stage's gradient norm before each update within
   3 x the spread of two size-1 runs, floor ``PIPE_FLOOR`` relative
   (``tools/torch_pipeline_control.py`` seeds the backward with 1 in
   place of 1/4 and must fail it).  The same in bf16 is printed, not
   gated: stages after the first carry a float32 residual stream.
15. ``pipeline_dp`` — 2 stages x 2 DP, 4 ranks on this card, batch 8 per
   DP rank (the same 16,384 tokens a step), 4 micro-batches of 2, 1
   warm-up + 3 timed steps.  Printed: job tokens/s and the wall ms of
   each step's stage-group gradient average.  Gates: every gradient
   average a stage-group op (one per leaf a step), the two replicas of a
   stage bit-identical (one digest per stage), hit rate >= 0.9, no
   unmatched transfer, K1 and B2 4 x 4 x 4 = 64 times per rank.

16. ``image_models`` — ResNet-50, VGG16, InceptionV3 (299) and MnistCNN
   (``horovod_tpu_torch/models``) at full width and batch 2 in float32
   with TF32 off: logits and every gradient on the card against the same
   weights on the CPU, both against the CPU in float64 (norm-wise: the
   card no further off than the CPU's float32, see the phase); then each
   in bf16 on the card, loss and gradients finite.
17. ``resnet`` — ``RESNET_HEADLINE`` (ResNet-50, batch 64, 224, bf16) and
   ``RESNET101_HEADLINE`` through ``hvd.init()``, ``DistributedOptimizer``
   and the image step (``torch/image_step.py``: SGD momentum 0.9, the
   fused BN EMA): 3 warm-up and 10 timed steps, images/s from the median
   host clock around ``step(...).item()``, peak memory, the loss finite
   and falling on the fixed batch; one traced window of ResNet-50's step
   summed by kernel class (``tools/torch_step_profile.py``'s
   ``image_category``) with the card's idle share.
18. ``resnet_dp`` — ResNet-50 data-parallel over 2 ranks on this card,
   batch 64 per rank, BN statistics cross-replica (``axis_name``, averaged
   through the engine inside the forward and their cotangent inside the
   backward, 53 + 53 blocking allreduces a step): job images/s,
   ``sync_sec``, the share of the step in the BN allreduces, engine cycles
   per step; one digest of every parameter and buffer per rank, equal
   bit for bit; the averaging check in float32: 3 steps of both ranks on
   rows [32r, 32r + 32) of one batch of 64 against the size-1 step on all
   64 rows, losses and running stats within train_dp's rule.
18b. ``packed`` — the packed train state (``build_image_step(...,
   packed=True)``: the small float32 parameters one ``nn.Parameter``, the
   BN running statistics one buffer, the fused EMA one update of it):
   ``RESNET_HEADLINE`` unpacked (a) and packed (b) in turns a, b, b, a,
   2 warm-up + 10 timed steps each.  Gates: losses finite, starting
   within 1.5 of ln(1000) and falling (``resnet``'s rule), each packed
   step's loss within 2% of the unpacked run's (bf16: ``compression``'s
   bound).  Then ResNet-18 in float32 (TF32 off, cuDNN deterministic) at
   ``tests/test_models.py::test_packed_train_step_bit_identical``'s shape
   (batch 4, 32 x 32, the 3 x 3 stem, 10 classes), 3 steps packed
   against unpacked within that test's bounds (loss rtol 1e-5; every
   parameter and statistic rtol 1e-5, atol 1e-6).  Then the same turns
   and the same float32 check data-parallel, 2 ranks of the port's runner
   on this card (each rank its own batch of 64; the float32 check on rows
   [2r, 2r + 2) of its batch of 4), where packing changes the traffic:
   gradients and averaged batch statistics through the engine a step.
   Gates: the same on every rank, and each turn's state digest and losses
   equal across the ranks.  Printed: step ms and images/s of each turn,
   the ms in ``synchronize`` and the engine cycles a step, the optimizer
   kernels' ms of one profiled step of each at size 1
   (``image_category``'s ``optimizer``), the tensors that
   ``DistributedOptimizer`` hooks and the aux tensors averaged a step,
   the host ms of one training forward's issue (the card idle first) and
   of the packed module's views.

19. ``serve`` — the serving plane at size 1 (``SERVE_HEADLINE``: the LM
   headline's widths in bf16, 8 decode slots, 16-token chunks and KV
   blocks, 512 blocks, 1024 tokens a request, bulk prefill from 256
   prompt tokens) through ``ServingEngine``: 24 requests of 3 tenants
   from ``RandomState(0)`` submitted 2 ms apart, prompts of 4-40 tokens
   and every 4th of 256-768, 8-32 new tokens each.  Printed: generated
   tokens/s, TTFT and per-token p50/p99, occupancy and steps, the median
   decode step's ms by CUDA events in the loop beside the median wall ms
   of its ``serve.plan`` broadcast, the step alone behind a 100 ms sleep
   kernel (device time) and without one, the serving window's memory.
   Gates: every request completes with all its tokens and no KV block is
   left in use; K1 is launched (bulk prefill; counters zeroed just before
   the loop starts and read after it stops) and no backward kernel; every
   position the paged step computed is within 0.05 (||paged - full|| /
   ||full||) of the full-context forward's logits
   (``tools/torch_serve_control.py`` shows K/V written one position late
   fails it); K1 alone at the prefill shapes (8 heads x 256/512/768, bf16
   and f32) against its plain version; then the first 12 requests in
   float32, all submitted before the loop starts (two of them bulk),
   token for token against ``reference_decode`` on the card.
20. ``serve_dp`` — 2 ranks of the port's runner on this card, each
   running the serving entry point's ``serve()`` in float32 at the same
   widths; rank 0's front door takes the 12 requests over HTTP, 2 ms
   apart.  Gates: tokens equal to the size-1 float32 run's, one digest of
   the KV pages (trash block aside) on both ranks, and a negotiation
   cache hit rate >= 0.9 over the serve window.

The two ranks time-slice the one card (two CUDA contexts, no MPS), and
NCCL cannot run two ranks on one device: the run shows the engine, the
staging and their numbers, not NVLink or NCCL.  Any rank that exits
non-zero, any mismatch and any timeout fails the run.

Then the ``{"kernels": [...]}`` summary (K1-K7, B2, K1, K2, K3 and B2 in
f32 at the main shape with the launches of the float32 paths
(``model``, the split phase's 65,600 batch-heads), and K1-K3 at head
dims 256 (bf16 and f32), 288, 512 and 1000; K1 and B2 with their launches per rank on
``train_dp``, ``pipeline`` and ``pipeline_dp`` and their times at the
pipeline's micro-batch shape, K1 with its launches on ``serve``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  K1
and B2 carry their launches on ``fused_loss`` and per rank on
``elastic``; K4, K5 and K7 theirs per rank on ``ring_dp``.  Any
failure raises: the script exits non-zero and prints no result line.
Tolerances (``horovod_tpu_torch/ops/kernel_check.py``, which gives the
reasons): every element within rtol * (|ref| + rms of its row + rms(ref)
/ 16) of a plain version that rounds p and ds to the storage dtype where the
kernels do; rtol is two units in the last place for 16-bit outputs and
for K5's f32 partials of 16-bit inputs (bf16 0.0156, fp16 0.00195) and
1e-4 for float32 outputs of float32 inputs and lse (summation order
only); float32 dq's limit grows by the rounding noise of dP, the term
``kernel_check`` gives as ``dq_noise``.

The members of a ring all sit on this one card: the run shows the ring's
kernels, handshakes and numbers, not the memory per member falling as
O(seq/n) or NVLink transfer times.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device")

import horovod_tpu_torch as hvd  # noqa: E402
import horovod_tpu_torch.torch as hvdt  # noqa: E402
from horovod_tpu_torch import common as hvd_common  # noqa: E402
from horovod_tpu_torch.engine import build as engine_build  # noqa: E402
from horovod_tpu_torch.models import (TransformerLM,  # noqa: E402
                                      fused_next_token_loss,
                                      next_token_loss)
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import kernel_check  # noqa: E402
from horovod_tpu_torch.ops import rdma  # noqa: E402
from horovod_tpu_torch.ops import ring_flash as RF  # noqa: E402
from horovod_tpu_torch.parallel import RingMesh  # noqa: E402
from horovod_tpu_torch.runner import run_command  # noqa: E402
from horovod_tpu_torch.models import norm as norm_mod  # noqa: E402
from horovod_tpu_torch.models.layers import Dense  # noqa: E402
from horovod_tpu_torch.torch import image_step as IS  # noqa: E402
from horovod_tpu_torch.parallel import pipeline as P  # noqa: E402
from horovod_tpu_torch.parallel.pipeline import partition_params  # noqa
from horovod_tpu_torch.torch.lm_step import (HEADLINE,  # noqa: E402
                                             PIPE_HEADLINE, RING_HEADLINE,
                                             SERVE_HEADLINE, adamw,
                                             build_lm_step,
                                             build_pipeline_stages)
from horovod_tpu_torch.torch.train import run_pipeline  # noqa: E402
from horovod_tpu_torch.serving import engine as SE  # noqa: E402
from horovod_tpu_torch.serving import server as serve_server  # noqa: E402
from horovod_tpu_torch.serving.__main__ import serve  # noqa: E402
from horovod_tpu_torch.serving.scheduler import Scheduler  # noqa: E402
from tools.torch_step_profile import image_category, trace_steps  # noqa

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
# H100 SXM data-sheet peaks (dense), at the 700 W limit.  float32: the
# 3xTF32 rate, the TF32 tensor-core peak (494.7 TFLOP/s) over the three
# products (hi.hi + hi.lo + lo.hi) that keep f32 to the 1e-4 rule: the
# least time the card could take for f32 work, since SDPA's
# memory-efficient backend and the port's wide f32 bodies run on it (the
# SIMT rate, 67 TFLOP/s, would let a tensor-core body read above 100%).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 494.7e12 / 3}
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock: time_ms's lead
MAIN = (16, 8, 1024, 64)  # batch, heads, seq, head_dim of the LM step
# Where the reference's plan picks the split backward (K2 + K3): more than
# 1024 batch-heads at a short sequence, and long sequences.
SPLIT = (1, 1040, 512, 64)
SPLIT_LONG = ((8, 8, 8192, 64), (4, 8, 16384, 64))
# More batch-heads than a grid's y dimension holds (65,535).
SPLIT_WIDE = (1, 65600, 16, 32)
RING = (4, 8, 1024, 64)  # one member's shard on the ring path (4 members)
# Head dims beside the main path's 64 (the head_dims phase): the wide body
# (K1, K2, K3) on the split phase's shape, and two head dims no body takes
# (run zero-padded to 32 and 96) on the main path's shape.
HEAD_DIM_WIDE = (1, 1040, 512, 256)
HEAD_DIM_WIDE_F32 = (1, 64, 1024, 256)  # K1, K2, K3's 3xTF32 bodies
HEAD_DIM_PADDED = ((16, 8, 1024, 16), (16, 8, 1024, 80))
# Head dims above 256 (ROADMAP C.1), (shape, dtype): the wide bodies of
# K1, K2 and K3 at 288 and 512, and at 1000 (run padded to 1024), in bf16;
# at 512 in fp16 (the wgmma bodies in the other 16-bit type); and in f32
# at 288 and 512 on the bf16 rows' shape and at 288 on a small one.
HEAD_DIM_WIDER = (((1, 64, 1024, 288), torch.bfloat16),
                  ((1, 64, 1024, 512), torch.bfloat16),
                  ((1, 32, 1024, 1000), torch.bfloat16),
                  ((1, 64, 1024, 512), torch.float16),
                  ((1, 8, 512, 288), torch.float32),
                  ((1, 64, 1024, 288), torch.float32),
                  ((1, 64, 1024, 512), torch.float32))
WIDE_SOURCE = "horovod_tpu_torch/ops/csrc/flash_wide.cu"
# K1's, K2's and K3's bodies above 256 in fp16 and bf16; K1's and K2's in
# f32 at every head dim (3xTF32; K3's f32 body above 256 is WIDE_SOURCE's
# SIMT one).
WIDE_SM90_SOURCE = "horovod_tpu_torch/ops/csrc/flash_wide_sm90.cuh"
WIDE_F32_SOURCE = "horovod_tpu_torch/ops/csrc/flash_wide_f32_sm90.cuh"
# The kernels phase's f32 cases beside MAIN and 1000 x 128: the 3xTF32 K1
# and K2 at head dims 32, 96 and 256 (two column CTAs; no B2 there), and a
# ragged non-causal length.
F32_CASES = [((16, 8, 1024, 32), torch.float32, True),
             ((16, 8, 1024, 128), torch.float32, True),
             ((16, 8, 1024, 96), torch.float32, True),
             ((2, 8, 1024, 256), torch.float32, True),
             ((16, 8, 1000, 64), torch.float32, False),
             ((2, 2, 8192, 64), torch.float32, True)]
# Quoted, not measured by this script: the SIMT bodies' times at
# HEAD_DIM_WIDER's shapes before they moved to tensor cores, in ms of K1,
# K2, K3 by the head_dims phase's row tag: bf16 (all three), and f32 (K1
# and K2; K3's f32 body is still SIMT, so measured) (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 6).  They go into the head_dims phase's
# line only, beside the times measured, never into the kernels line.
WIDE_QUOTED_MS = {"d288": (4.606, 14.604, 7.909),
                  "d512": (9.838, 33.260, 18.197),
                  "d1000": (17.525, 60.833, 33.673),
                  "d288_f32": (0.2748, 0.4829, None),
                  "d288_f32_bh64": (4.7655, 14.4897, None),
                  "d512_f32": (9.9314, 32.0191, None)}
# The image phases: the models held card against CPU, and the ResNet
# data-parallel phase's averaging check seed.
IMAGE_MODELS = (("resnet50", 224), ("vgg16", 224), ("inception_v3", 299),
                ("mnist", 28))
RESNET_AVG_SEED = 11
N_MEMBERS = 4
# The data-parallel phases: ranks on this one card, the LM's gradient
# bytes (58.7 M f32 parameters), the averaging check's seed.
DP_RANKS = 2
DP_DEVICE = "cuda:0"  # the card every rank of the DP phases shares
COMP_FLOOR = 1024  # HVD_TPU_COMPRESSION_MIN_BYTES, the reference's default
COMP_RATIO = {"bf16": 0.51, "fp8": 0.26}  # wire / payload bytes at most
COMP_LOSS_RTOL = 0.02  # bf16 against train_dp, step by step
AUTOTUNE_ENV = {"HVD_TPU_AUTOTUNE": "1", "HVD_TPU_FUSION_THRESHOLD": "1024",
                "HVD_TPU_CYCLE_TIME_MS": "50",
                "HVD_TPU_AUTOTUNE_WINDOW": "8",
                "HVD_TPU_AUTOTUNE_WARMUP": "1"}
AUTOTUNE_MAX_STEPS = 40
AUTOTUNE_AFTER = 3  # steps timed at the frozen point
GRAD_BYTES = 224 << 20
AVG_SEED = 7
# ring_dp's averaging check: rank 1's rows hold only their first 512
# targets, as rows of short documents padded to the context would.
RING_AVG_VALID = 512
# fused_loss's token count that 8 chunks do not divide (batch, seq).
FUSED_FALLBACK = (3, 1023)
# The pipeline phases: stage ranks on this card, the micro-batch's q at
# PIPE_HEADLINE (batch 4 of 16, 8 heads, seq 1024, head dim 64), and the
# float32 parity rule's relative floor: sound runs read at most 1.4e-6 of
# the value (a gradient norm), a backward seeded with 1 in place of 1/4
# reads 3.0 (NVIDIA H100 80GB HBM3, 700.00 W; tools/torch_pipeline_control.py).
PIPE_RANKS = 2
PIPE_DP_RANKS = 4
PIPE_MICRO = (4, 8, 1024, 64)
PIPE_FLOOR = 1e-4
PIPE_DP_HEADLINE = dict(PIPE_HEADLINE, batch=8)
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/attention.py:356",
    "flash_bwd": "horovod_tpu/ops/attention.py:498",
    "flash_bwd_dkdv": "horovod_tpu/ops/attention.py:429",
    "flash_bwd_dq": "horovod_tpu/ops/attention.py:465",
    "ring_flash_fwd": "horovod_tpu/ops/ring_flash.py:78",
    "ring_flash_bwd": "horovod_tpu/ops/attention.py:498",
    "ring_permute": "horovod_tpu/ops/rdma.py:103",
    "phase_closer": "horovod_tpu/ops/ring_flash.py:286",
}
SOURCES = {
    "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_bwd": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/ops/csrc/flash_bwd_split.cu",
    "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_bwd_split.cu",
    "ring_flash_fwd": "horovod_tpu_torch/ops/csrc/ring_flash.cu",
    "ring_flash_bwd": "horovod_tpu_torch/ops/csrc/ring_flash.cu",
    "ring_permute": "horovod_tpu_torch/ops/csrc/ring_permute.cu",
    "phase_closer": "horovod_tpu_torch/ops/csrc/ring_permute.cu",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, warmup=3, iters=15, host_ahead=True, lead=1):
    """Median milliseconds of ``fn`` on the card (CUDA events).  With
    ``host_ahead`` a sleep kernel of ``lead`` ms runs ahead of the start
    event, so the host has queued ``fn``'s launches before the card
    reaches them and the events hold device time alone (``fn`` must take
    the host less than ``lead`` ms to issue); without it they also hold
    the host's time to issue them (the Python wrapper's checks,
    allocations and launch), as the port's first timings did."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(lead * SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_ms(make, backends=("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                             "CUDNN_ATTENTION")):
    """``({backend: ms or None}, fastest ms)`` of the callable ``make()``
    returns, made and timed under each SDPA backend of ``backends``; None
    where the backend refuses the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in backends:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                times[name] = time_ms(make())
        except RuntimeError:
            times[name] = None
    done = [x for x in times.values() if x is not None]
    return times, (min(done) if done else None)


def causal_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def _entry(name, ms, plain_ms, library_ms, flops, nbytes, dtype, err,
           kernel=None, source=None, **extra):
    """A row of the summary; ``kernel`` names the kernel where ``name``
    is a row of its own (the rows of other head dims), ``source`` its
    body's source where that is not the kernel's."""
    bms, by = bound_ms(flops, nbytes, dtype)
    kernel = kernel or name
    return {"name": name, "route": "cuda",
            "source": source or SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "flops": flops, "bytes": nbytes, **extra}


def kernel_inputs(shape, dtype, seed):
    b, h, s, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: torch.randn(b * h, s, d, device="cuda", generator=g,  # noqa
                             dtype=torch.float32).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    p2, scale_r = A._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    return q, qr, k, v, do, p2, scale_r


def check_case(shape, dtype, causal, seed=0):
    """``{output: {max_abs_err, worst}}`` of K1, B2 (``dq``, ``dk``,
    ``dv``; up to head dim 128, where the combined mode has a body) and K2
    + K3 (``split_dq``, ...) against the plain versions (``kernel_check``),
    and ``{dq: {rows_0_7, rows_8_on}}`` (``split_dq`` too): dq's reading
    over the first 8 query rows and over the rest apart; fails on a
    non-finite output."""
    _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, seed)
    mode = "combined" if shape[3] <= A.HEAD_DIMS[-1] else "split"
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2, mode)
    args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, causal)
    got = kernel_check.kernel_outputs(*args, mode)
    if mode == "split":  # no B2: K1 and the split pair alone
        for n in ("dq", "dk", "dv", "dq_noise"):
            got.pop(n, None)
            ref.pop(n, None)
    # The split pair against the plain side that walks its own key tile.
    split = kernel_check.kernel_bwd_outputs(*args, "split")
    split_ref = kernel_check.plain_bwd_outputs(*args, "split")
    got.update({f"split_{n}": t for n, t in split.items()})
    ref.update({f"split_{n}": t for n, t in split_ref.items()})
    for name, t in got.items():
        if not torch.isfinite(t).all():
            fail(f"{name} not finite at {shape} {dtype}")
    # lse is compared finite-to-finite (ragged or causal rows all have
    # mass, so no POS_BIG sentinel appears here).
    # float32 dq by its limit with the term of dP's rounding noise
    # (kernel_check's dq_noise); its first rows under both limits.
    first = {n: kernel_check.compare_first_rows(got[n], ref[n],
                                                noise=ref.get(n + "_noise"))
             for n in ("dq", "split_dq") if n in got}
    return {n: kernel_check.compare(got[n], ref[n],
                                    noise=ref.get(n + "_noise"))
            for n in got}, first


def k1_b2_entries(shape, errs, dtype=torch.bfloat16, causal=True):
    """K1's and B2's summary rows at ``shape``: their times (and K2's and
    K3's beside B2), their plain versions' (as held against the kernels),
    SDPA's fastest backend's, the bounds, and the largest errors in
    ``errs`` (``check_case``'s).  ``(entries, K2 ms, K3 ms, SDPA forward
    ms by backend, SDPA backward ms by backend)``."""
    _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, 1)
    o, lse = A.flash_fwd(qr, k, v, scale_r, causal)
    delta = A._delta(o, do)
    t_fwd = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal))
    t_fwd_host = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal),
                         host_ahead=False)
    t_b2 = time_ms(lambda: A.flash_bwd(qr, k, v, do, lse, delta, scale_r, p2,
                                       causal))
    t_dkdv = time_ms(lambda: A.flash_bwd_dkdv(qr, k, v, do, lse, delta,
                                              scale_r, causal))
    t_dq = time_ms(lambda: A.flash_bwd_dq(qr, k, v, do, lse, delta, scale_r,
                                          p2, causal))
    t_plain_fwd = time_ms(lambda: A._blockwise_fwd_impl(
        qr, k, v, causal, scale_r,
        block_size=A.fwd_key_tile(dtype, shape[3])), warmup=1, iters=5)
    t_plain_bwd = time_ms(lambda: A._attention_bwd_impl(
        qr, k, v, lse, delta, do, causal, scale_r,
        block_size=A.bwd_key_tile("combined", dtype, shape[3]), dq_scale=p2,
        round_pds=True), warmup=1, iters=5)
    # Library yardstick: PyTorch's SDPA on (b, h, s, d) under each
    # backend, forward and its backward alone (dq, dk, dv in one autograd
    # call).
    b, h, s, d = shape
    lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(shape, dtype, causal,
                                                        None, 1)

    bh = b * h
    pairs = causal_pairs(s, s, causal) * bh
    el = torch.tensor([], dtype=dtype).element_size()
    tile = bh * s * d * el
    row = bh * s * 4
    err = {n: max(errs[o]["max_abs_err"] for o in outs)
           for n, outs in (("flash_fwd", ("o", "lse")),
                           ("flash_bwd", ("dq", "dk", "dv")))}
    entries = {  # (flops, bytes: each input read once, each output written)
        "flash_fwd": _entry(
            "flash_fwd", t_fwd, t_plain_fwd, t_lib_fwd, 4 * d * pairs,
            3 * tile + tile + row, dtype, err["flash_fwd"],
            library_by_backend=lib_fwd, ms_with_host=t_fwd_host),
        "flash_bwd": _entry(
            "flash_bwd", t_b2, t_plain_bwd, t_lib_bwd, 10 * d * pairs,
            4 * tile + 2 * row + 3 * tile, dtype, err["flash_bwd"],
            library_by_backend=lib_bwd, k2_plus_k3_ms=t_dkdv + t_dq),
    }
    return entries, t_dkdv, t_dq, lib_fwd, lib_bwd


def phase_kernels():
    cases = [(MAIN, torch.bfloat16, True), (MAIN, torch.float32, True),
             (MAIN, torch.float16, True), (MAIN, torch.bfloat16, False),
             ((16, 8, 1000, 128), torch.bfloat16, True),
             ((16, 8, 1000, 128), torch.float32, True)] + F32_CASES
    results = []
    case_errs = {}
    for shape, dtype, causal in cases:
        errs, first = check_case(shape, dtype, causal)
        ok = all(e["worst"] <= 1.0 for e in errs.values())
        results.append({"shape": list(shape), "dtype": str(dtype),
                        "causal": causal, "ok": ok, "errors": errs,
                        "dq_first_rows": first})
        case_errs[(shape, dtype, causal)] = errs
        if not ok:
            emit("kernels", cases=results)
            fail(f"kernel disagrees with its plain version: {results[-1]}")

    # Times at the main path's shape and dtype; the plain times are of the
    # plain versions as held against the kernels above.
    dtype = torch.bfloat16
    entries, t_dkdv, t_dq, lib_fwd, lib_bwd = k1_b2_entries(
        MAIN, case_errs[(MAIN, dtype, True)])
    # The f32 bodies at the same shape (K1, K2, K3 and B2 on 3xTF32
    # wgmma), beside SDPA in float32; their rows go into the summary with
    # the launches of the f32 paths.
    f32 = k1_b2_entries(MAIN, case_errs[(MAIN, torch.float32, True)],
                        torch.float32)
    f32_errs = case_errs[(MAIN, torch.float32, True)]
    flops, nbytes = split_bounds(MAIN, torch.float32, True)["flash_bwd_dkdv"]
    t_sdpa_bwd = f32[0]["flash_bwd"]["library_ms"]
    k1 = f32[0]["flash_fwd"]
    entries["flash_fwd_f32"] = dict(
        k1, name="flash_fwd_f32", source=WIDE_F32_SOURCE, shape=list(MAIN),
        x_library=k1["ms"] / k1["library_ms"])
    entries["flash_bwd_dkdv_f32"] = _entry(
        "flash_bwd_dkdv_f32", f32[1], f32[0]["flash_bwd"]["plain_ms"],
        t_sdpa_bwd, flops, nbytes, torch.float32,
        max(f32_errs[n]["max_abs_err"] for n in ("split_dk", "split_dv")),
        kernel="flash_bwd_dkdv", source=WIDE_F32_SOURCE, shape=list(MAIN),
        library_by_backend=f32[4], x_library=f32[1] / t_sdpa_bwd,
        note="plain_ms: the whole plain combined backward; library_ms: "
             "SDPA's whole backward in float32")
    # B2 and K3 on their 3xTF32 bodies.
    b2 = f32[0]["flash_bwd"]
    entries["flash_bwd_f32"] = dict(
        b2, name="flash_bwd_f32", source=WIDE_F32_SOURCE, shape=list(MAIN),
        x_library=b2["ms"] / t_sdpa_bwd)
    k3_flops, k3_bytes = split_bounds(MAIN, torch.float32, True)[
        "flash_bwd_dq"]
    entries["flash_bwd_dq_f32"] = _entry(
        "flash_bwd_dq_f32", f32[2], b2["plain_ms"], t_sdpa_bwd, k3_flops,
        k3_bytes, torch.float32, f32_errs["split_dq"]["max_abs_err"],
        kernel="flash_bwd_dq", source=WIDE_F32_SOURCE, shape=list(MAIN),
        library_by_backend=f32[4], x_library=f32[2] / t_sdpa_bwd,
        note="plain_ms: the whole plain combined backward; library_ms: "
             "SDPA's whole backward in float32")

    def timing(es):
        return {n: {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}
                for n, e in es.items()}
    f32_timing = timing({n: entries[f"{n}_f32"] for n in (
        "flash_fwd", "flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq")})
    for n, t in f32_timing.items():
        lib = (f32[0]["flash_fwd"] if n == "flash_fwd"
               else f32[0]["flash_bwd"])["library_ms"]
        t["x_sdpa"] = t["ms"] / lib
    emit("kernels", cases=results, shape=list(MAIN), dtype=str(dtype),
         timing=timing({n: entries[n] for n in ("flash_fwd", "flash_bwd")}),
         k2_ms=t_dkdv, k3_ms=t_dq,
         sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
         f32={"timing": f32_timing, "k2_ms": f32[1], "k3_ms": f32[2],
              "sdpa_fwd_ms": f32[3], "sdpa_bwd_ms": f32[4]},
         note="library_ms: the fastest SDPA backend's forward for K1, its "
              "whole backward (dq, dk, dv) for B2; k2_ms, k3_ms: the split "
              "pair at this shape, which no path gives it (its entries come "
              "from the split phase); f32: K1, K2, K3 and B2 (3xTF32 wgmma) "
              "in float32 at the same shape, beside SDPA in float32 "
              "(x_sdpa: ms over SDPA's fastest forward for K1, its whole "
              "backward for the others; bounds at the 3xTF32 rate, "
              "PEAK_FLOPS); dq_first_rows: dq's worst over query rows 0-7 "
              "and the rest apart (the causal first row's dq cancels to 0): "
              "worst under the limit without dq's term, worst_new with it, "
              "the one dq is held to in float32")
    return entries


def phase_model():
    """The kernels' path against the plain path through a small LM."""
    cfg = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
               dtype=torch.float32)
    flash = TransformerLM(**cfg, use_flash=True)
    plain = TransformerLM(**cfg, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 257))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    out = {}
    torch.cuda.synchronize()
    A.reset_launches()
    for name, m in (("flash", flash), ("plain", plain)):
        if name == "plain":
            torch.cuda.synchronize()
            launched = dict(A.launches)
        logits = m(inp)
        loss = next_token_loss(logits, tgt)
        loss.backward()
        out[name] = (logits.detach(), loss.item(),
                     {n: p.grad for n, p in m.named_parameters()})
    dl = (out["flash"][0] - out["plain"][0]).abs().max().item()
    dg = max((out["flash"][2][n] - out["plain"][2][n]).abs().max().item()
             for n in out["flash"][2])
    emit("model", logits_max_abs_err=dl, grad_max_abs_err=dg,
         loss_flash=out["flash"][1], loss_plain=out["plain"][1],
         launches=launched)
    # f32 on both sides: summation order only.
    if dl > 1e-4 or dg > 1e-4:
        fail(f"model path disagrees with the plain path: {dl}, {dg}")
    # The float32 path's K1 and B2 (2 layers, one step), on their 3xTF32
    # bodies.
    if launched != {"flash_fwd": 2, "flash_bwd": 2, "flash_bwd_dkdv": 0,
                    "flash_bwd_dq": 0}:
        fail(f"model path launched {launched}")
    return launched


def timed_steps(step, data, warmup, timed):
    """``warmup + timed`` calls of ``step(data)``: ``(losses, ms of each
    timed call on the host clock around step(...).item(), which
    synchronizes, and the ms of its synchronize)``."""
    losses, step_ms = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, [x * 1e3 for x in step.sync_sec[warmup:]]


def phase_train():
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    _, step, data = build_lm_step(**HEADLINE)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    n_layers = HEADLINE["n_layers"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms, _ = timed_steps(step, data, warmup, timed)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    med = statistics.median(step_ms)
    summary = dict(tokens_per_s=batch * seq / (med / 1e3),
                   median_step_ms=med,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
    emit("train", **summary, step_ms=step_ms,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         launches=launched)
    per = n_layers * (warmup + timed)
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if launched != want:
        fail(f"the main path launched {launched}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    # Random weights start near log(vocab); one fixed batch is memorised.
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"implausible loss trajectory: {losses}")
    hvd.shutdown()
    return launched, summary


def _lm(dtype, logits_dtype, seed):
    """The headline LM at ``dtype`` on the card, weights from ``seed``."""
    return TransformerLM(**{k: HEADLINE[k] for k in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff")},
        dtype=dtype, logits_dtype=logits_dtype,
        generator=torch.Generator().manual_seed(seed))


def _loss_and_grads(model, inp, tgt, fused):
    model.zero_grad(set_to_none=True)
    loss = (model(inp, targets=tgt) if fused
            else next_token_loss(model(inp), tgt))
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def fused_numerics(batch, seq):
    """float32: the fused loss and every gradient against two runs of the
    logits path on float32 logits.  Each element within 1e-6 + 1e-5 |ref|
    (the reference's CPU tolerances) plus 3 x the two runs' spread (B2's
    dQ adds are not ordered); the loss within 3 x its spread, at least
    1e-6 relative.  Returns the readings (``worst``: largest error over
    its limit, pass at <= 1)."""
    model = _lm(torch.float32, torch.float32, AVG_SEED)
    tokens = torch.from_numpy(np.random.RandomState(AVG_SEED).randint(
        0, HEADLINE["vocab_size"], (batch, seq + 1))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    l1, g1 = _loss_and_grads(model, inp, tgt, fused=False)
    l2, g2 = _loss_and_grads(model, inp, tgt, fused=False)
    lf, gf = _loss_and_grads(model, inp, tgt, fused=True)
    worst, worst_name = 0.0, None
    for n, a in gf.items():
        lim = 1e-6 + 1e-5 * g1[n].abs() + 3 * (g1[n] - g2[n]).abs()
        w = ((a - g1[n]).abs() / lim).max().item()
        if w > worst:
            worst, worst_name = w, n
    loss_lim = max(3 * abs(l1 - l2), 1e-6 * abs(l1))
    out = dict(batch=batch, seq=seq, tokens=batch * seq,
               chunks=8 if (batch * seq) % 8 == 0 else 1,
               loss_fused=lf, loss_logits=[l1, l2], loss_abs_err=abs(lf - l1),
               loss_limit=loss_lim, grad_worst=worst,
               grad_worst_param=worst_name,
               grad_spread_max=max((g1[n] - g2[n]).abs().max().item()
                                   for n in g1))
    del model, g1, g2, gf
    torch.cuda.empty_cache()
    if abs(lf - l1) > loss_lim or worst > 1.0:
        emit("fused_loss", numerics=out)
        fail(f"fused loss disagrees with the logits path: {out}")
    return out


def fused_bf16_report():
    """bf16 as ``train`` runs it (bf16 logits on the logits path): each
    path's loss and gradient norms, one bf16 rounding of each logit
    apart.  Printed, not gated."""
    model = _lm(torch.bfloat16, torch.bfloat16, AVG_SEED)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    tokens = torch.from_numpy(np.random.RandomState(AVG_SEED).randint(
        0, vocab, (batch, seq + 1))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    out = {}
    for name, fused in (("logits", False), ("fused", True)):
        loss, grads = _loss_and_grads(model, inp, tgt, fused)
        out[name] = {"loss": loss, "grad_norms": {
            n: g.float().norm().item() for n, g in grads.items()}}
    names = out["fused"]["grad_norms"]
    out["max_grad_norm_rel_diff"] = max(
        abs(out["fused"]["grad_norms"][n] - out["logits"]["grad_norms"][n])
        / max(out["logits"]["grad_norms"][n], 1e-30) for n in names)
    del model
    torch.cuda.empty_cache()
    return out


def fused_head_ms():
    """Median ms of the head and the loss alone, forward and backward, at
    ``HEADLINE``'s tokens in bf16 (CUDA events, the host's issue inside):
    ``fused_next_token_loss`` (float32 chunk products) against the logits
    path as ``train`` runs it (a bf16 head product, bf16 logits,
    ``next_token_loss``)."""
    vocab, batch, seq, d = (HEADLINE[k] for k in (
        "vocab_size", "batch", "seq", "d_model"))
    g = torch.Generator(device="cuda").manual_seed(AVG_SEED)
    h = torch.randn(batch, seq, d, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_()
    w = (torch.randn(d, vocab, device="cuda", generator=g)
         * d ** -0.5).requires_grad_()
    t = torch.randint(0, vocab, (batch, seq), device="cuda", generator=g)

    def fused():
        fused_next_token_loss(h, w, t, dtype=torch.bfloat16).backward()

    def logits():
        next_token_loss(torch.matmul(h, w.to(torch.bfloat16)), t).backward()

    out = {"fused": time_ms(fused, host_ahead=False),
           "logits": time_ms(logits, host_ahead=False)}
    del h, w, t
    torch.cuda.empty_cache()
    return out


def phase_fused_loss(train):
    """The main path with the fused head and loss: float32 numerics
    against the logits path, the bf16 report, then the timed steps
    beside ``train``'s (``train``: its tokens/s, step ms and peak)."""
    hvd.init()
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    _, step, data = build_lm_step(**HEADLINE, fused_loss=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms, _ = timed_steps(step, data, warmup, timed)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    del step, data
    torch.cuda.empty_cache()
    numerics = [fused_numerics(batch, seq), fused_numerics(*FUSED_FALLBACK)]
    bf16 = fused_bf16_report()
    head_ms = fused_head_ms()
    med = statistics.median(step_ms)
    per = HEADLINE["n_layers"] * (warmup + timed)
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    emit("fused_loss", nvidia_smi=smi_line(),
         tokens_per_s=batch * seq / (med / 1e3), median_step_ms=med,
         step_ms=step_ms, max_memory_allocated=peak,
         train=train, head_and_loss_ms=head_ms, losses=losses,
         launches=launched, want_launches=want, numerics=numerics,
         bf16=bf16)
    if launched != want:
        fail(f"the fused-loss path launched {launched}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"fused_loss: non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"fused_loss: implausible loss trajectory: {losses}")
    if peak >= train["max_memory_allocated"]:
        fail(f"fused_loss: peak {peak} B not below train's "
             f"{train['max_memory_allocated']} B")
    hvd.shutdown()
    return launched


def split_bounds(shape, dtype, causal):
    """``{kernel: (flops, bytes)}`` of K2 and K3 at ``shape`` (each input
    read once, each output written once)."""
    b, h, s, d = shape
    bh = b * h
    pairs = causal_pairs(s, s, causal) * bh
    tile = bh * s * d * torch.tensor([], dtype=dtype).element_size()
    row = bh * s * 4
    return {"flash_bwd_dkdv": (8 * d * pairs, 4 * tile + 2 * row + 2 * tile),
            "flash_bwd_dq": (6 * d * pairs, 4 * tile + 2 * row + tile)}


def hold_many_heads(dtype):
    """``flash_attention`` forward and backward at SPLIT_WIDE (65,600
    batch-heads, past a grid's 65,535 y-blocks) with the counters zeroed
    just before and read just after (K1, K2, K3 once: the plan picks the
    split pair past 1024 batch-heads); output and gradients against the
    plain blockwise path."""
    launched, got, want = drive_flash_attention(SPLIT_WIDE, dtype, True, 7)
    if dtype == torch.float32:
        # f32 on both sides: summation order only (kernel_check's rule, dq
        # with its term).
        errs = {n: kernel_check.compare(got[n], want[n],
                                        noise=want.get(n + "_noise"))
                for n in got}
        ok = all(e["worst"] <= 1.0 for e in errs.values())
    else:
        # 16-bit kernels against the f32 plain path: rounding of the
        # inputs' products and of the outputs (5e-2 of the largest value).
        errs = _rel_errs(got, want)
        ok = max(errs.values()) <= 5e-2
    finite = all(bool(torch.isfinite(x).all()) for x in got.values())
    return {"dtype": str(dtype), "launches": launched, "errors": errs,
            "finite": finite, "ok": ok and finite}


def phase_split():
    """The split backward where the reference's plan picks it (more than
    1024 batch-heads at seq 512), bf16, causal: K2 and K3 held against
    their plain version at this shape, B2 beside them; ``flash_attention``
    forward and backward with the counters zeroed just before and read
    just after (K1, K2 and K3 once, B2 never) and its gradients against
    the plain blockwise path, here and at 65,600 batch-heads in bf16 and
    f32; then K2, K3 and B2 (all held first) timed apart at this shape and
    at two long sequences that the plan also sends to the split pair,
    beside SDPA's backward; the plain version timed here.  Returns the
    launches and K2's and K3's entries."""
    dtype, causal = torch.bfloat16, True
    b, h, s, d = SPLIT
    bh = b * h
    mode = A.bwd_mode(s, d, bh)
    if mode != "split":
        fail(f"the plan picks {mode} at {SPLIT}, not split")
    q, qr, k, v, do, p2, scale_r = kernel_inputs(SPLIT, dtype, 4)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2, "split")
    args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, causal)
    errs = {}
    for m in ("split", "combined"):
        got = kernel_check.kernel_bwd_outputs(*args, m)
        want = kernel_check.plain_bwd_outputs(*args, m)
        errs[m] = {n: kernel_check.compare(got[n], want[n]) for n in got}
    held = all(e["worst"] <= 1.0 for es in errs.values() for e in es.values())

    xs = [t.reshape(SPLIT).clone().requires_grad_() for t in (q, k, v)]
    ct = do.reshape(SPLIT)
    torch.cuda.synchronize()
    A.reset_launches()
    grads = torch.autograd.grad(A.flash_attention(*xs, causal=True), xs, ct)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    ref_in = [x.detach().float().requires_grad_() for x in xs]
    ref_grads = torch.autograd.grad(
        A.blockwise_attention(*ref_in, causal=True), ref_in, ct.float())
    # bf16 kernels against the f32 plain path: bf16 rounding of the inputs'
    # products and of the outputs (5e-2 of the largest gradient).
    path_err = [(a.float() - r).abs().max().item() / r.abs().max().item()
                for a, r in zip(grads, ref_grads)]
    del xs, grads, ref_in, ref_grads
    wide = [hold_many_heads(dt) for dt in (torch.bfloat16, torch.float32)]

    t_plain = time_ms(lambda: kernel_check.plain_bwd_outputs(*args, "split"),
                      warmup=1, iters=5)
    times = {}
    for shape in (SPLIT,) + SPLIT_LONG:
        if A.bwd_mode(shape[2], shape[3], shape[0] * shape[1]) != "split":
            fail(f"the plan does not pick split at {shape}")
        if shape == SPLIT:
            sqr, sk_, sv, sdo, sp2, sr = qr, k, v, do, p2, scale_r
            slse, sdelta = ref["lse"], delta
            worst = {m: max(e["worst"] for e in errs[m].values())
                     for m in errs}
        else:
            _, sqr, sk_, sv, sdo, sp2, sr = kernel_inputs(shape, dtype, 6)
            o, slse = A.flash_fwd(sqr, sk_, sv, sr, causal)
            sdelta = A._delta(o, sdo)
            del o
            # Both modes held here too (the backward alone, on K1's lse),
            # so the times compare kernels that are right at this length.
            kargs = (sqr, sk_, sv, sdo, slse, sdelta, sp2, sr, causal)
            worst = {}
            for m in ("split", "combined"):
                got = kernel_check.kernel_bwd_outputs(*kargs, m)
                want = kernel_check.plain_bwd_outputs(*kargs, m)
                worst[m] = max(kernel_check.compare(got[n], want[n])["worst"]
                               for n in got)
                del got, want
            held &= max(worst.values()) <= 1.0
        largs = (sqr, sk_, sv, sdo, slse, sdelta, sr)
        t_k2 = time_ms(lambda: A.flash_bwd_dkdv(*largs, causal))
        t_k3 = time_ms(lambda: A.flash_bwd_dq(*largs, sp2, causal))
        t_b2 = time_ms(lambda: A.flash_bwd(*largs, sp2, causal))
        _, _, lib_bwd, t_lib = sdpa_times(shape, dtype, causal, sr, 6)
        bounds = {n: bound_ms(f, nb, dtype)[0] for n, (f, nb)
                  in split_bounds(shape, dtype, causal).items()}
        times["x".join(map(str, shape))] = {
            "k2_ms": t_k2, "k3_ms": t_k3, "k2_plus_k3_ms": t_k2 + t_k3,
            "b2_ms": t_b2, "sdpa_bwd_ms": lib_bwd, "library_ms": t_lib,
            "k2_bound_ms": bounds["flash_bwd_dkdv"],
            "k3_bound_ms": bounds["flash_bwd_dq"], "worst": worst}
        del largs, sqr, sk_, sv, sdo, slse, sdelta
    emit("split", shape=list(SPLIT), mode=mode, launches=launched,
         errors=errs, path_rel_err=path_err, many_heads=wide, times=times,
         plain_ms=t_plain,
         note="sdpa_bwd_ms, library_ms: SDPA's whole backward (dq, dk, dv) "
              "per backend and the fastest, at the kernels' q'")
    want = {"flash_fwd": 1, "flash_bwd": 0, "flash_bwd_dkdv": 1,
            "flash_bwd_dq": 1}
    if not held:
        fail(f"split pair or B2 disagrees with its plain version: {errs}, "
             f"{times}")
    if launched != want or max(path_err) > 5e-2:
        fail(f"split path launched {launched} for {want}, gradients off "
             f"by {path_err}")
    for w in wide:
        if w["launches"] != want or not w["ok"]:
            fail(f"flash_attention at {SPLIT_WIDE}: {w}, want launches "
                 f"{want}")

    err = {n: max(errs["split"][o]["max_abs_err"] for o in outs)
           for n, outs in (("flash_bwd_dkdv", ("dk", "dv")),
                           ("flash_bwd_dq", ("dq",)))}
    at = times["x".join(map(str, SPLIT))]
    entries = {}
    for name, key, body in (
            ("flash_bwd_dkdv", "k2_ms", "flash_bwd_sm90.cuh"),
            ("flash_bwd_dq", "k3_ms", "flash_dq_sm90.cuh")):
        flops, nbytes = split_bounds(SPLIT, dtype, causal)[name]
        entries[name] = _entry(
            name, at[key], t_plain, at["library_ms"], flops, nbytes, dtype,
            err[name], library_by_backend=at["sdpa_bwd_ms"],
            shape=list(SPLIT), body=f"horovod_tpu_torch/ops/csrc/{body}",
            note="plain_ms: the whole plain split backward; library_ms: "
                 "SDPA's whole backward")
    # The float32 split path's launches (65,600 batch-heads): K2 and K3 on
    # their 3xTF32 bodies.
    return launched, entries, wide[1]["launches"]


def hold_padded(shape, dtype, causal, mode, seed):
    """K1 and the backward in ``mode``, each alone, on inputs zero-padded
    to the body's head dim as ``flash_attention`` pads them, against the
    plain side at the caller's head dim (``kernel_check``; the plain side
    walks the padded body's key tiles): ``{output: compare}``, and whether
    every padded column came out exactly 0."""
    d = shape[-1]
    _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, seed)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2, mode)
    body = A.padded_head_dim(d)
    pad = [A.pad_head(t, body) for t in (qr, k, v, do)]
    got = kernel_check.kernel_outputs(*pad, ref["lse"], delta, p2, scale_r,
                                      causal, mode)
    zero_pad = all(int(torch.count_nonzero(t[..., d:])) == 0
                   for n, t in got.items() if n != "lse")
    got = {n: t if n == "lse" else t[..., :d] for n, t in got.items()}
    for name, t in got.items():
        if not torch.isfinite(t).all():
            fail(f"{name} not finite at {shape} {dtype}")
    return kernel_check.compare_outputs(got, ref), zero_pad


def drive_flash_attention(shape, dtype, causal, seed):
    """``flash_attention`` forward and backward at ``shape`` on inputs
    from ``seed``, with the counters zeroed just before and read just
    after: ``(launches, {o, dq, dk, dv}, the same of the plain blockwise
    path in f32, in f32 with dq's term dq_noise)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, ct = (torch.randn(shape, device="cuda", generator=g,
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    A.reset_launches()
    out = A.flash_attention(*xs, causal=causal)
    grads = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    ref_in = [x.detach().float().requires_grad_() for x in xs]
    ref = A.blockwise_attention(*ref_in, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_in, ct.float())
    names = ("o", "dq", "dk", "dv")
    want = dict(zip(names, (ref.detach(), *ref_grads)))
    if dtype == torch.float32:
        want["dq_noise"] = kernel_check.path_dq_noise(q, k, v, ct, causal)
    return launched, dict(zip(names, (out.detach(), *grads))), want


def _rel_errs(got, want):
    """Largest error of each output over the largest value of its plain
    version."""
    return {n: (got[n].float() - want[n]).abs().max().item()
            / want[n].abs().max().item() for n in got}


def sdpa_times(shape, dtype, causal, scale, seed):
    """SDPA's forward and whole backward at ``shape`` under each backend
    (and the math backend above head dim 256, where the fused ones refuse
    or may refuse the shape): ``(fwd by backend, fastest fwd, bwd by
    backend, fastest bwd)``."""
    backends = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
    if shape[-1] > A.WIDE_HEAD_DIM:
        backends += ("MATH",)
    g = torch.Generator(device="cuda").manual_seed(seed)
    qs, ks, vs = (torch.randn(shape, device="cuda", generator=g,
                              dtype=torch.float32).to(dtype)
                  .requires_grad_() for _ in range(3))
    dos = torch.randn(shape, device="cuda", generator=g).to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, t_fwd = sdpa_ms(lambda: lambda: sdpa(qs, ks, vs, is_causal=causal,
                                              scale=scale), backends)

    def bwd():
        out = sdpa(qs, ks, vs, is_causal=causal, scale=scale)
        return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                           retain_graph=True)
    bwd_by, t_bwd = sdpa_ms(bwd, backends)
    return fwd, t_fwd, bwd_by, t_bwd


def attention_work(shape, dtype, causal):
    """``(pairs, tile bytes, row bytes)`` of attention at ``shape``."""
    b, h, s, d = shape
    pairs = causal_pairs(s, s, causal) * b * h
    tile = b * h * s * d * torch.tensor([], dtype=dtype).element_size()
    return pairs, tile, b * h * s * 4


def _dtype_tag(dtype):
    return {torch.bfloat16: "", torch.float16: "_fp16",
            torch.float32: "_f32"}[dtype]


def _rates(entry):
    """``entry`` with the TFLOP/s of the caller's work and its share of
    the bound."""
    entry["tflops"] = entry["flops"] / entry["ms"] / 1e9
    entry["bound_share"] = entry["bound_ms"] / entry["ms"]
    return entry


def phase_head_dims():
    """Head dims other than the main path's (ROADMAP C.1), causal.
    K1, K2 and K3 at the wide head dim 256 on the split phase's shape
    (bf16) and on their wide bodies at HEAD_DIM_WIDER (288, 512 and 1000,
    run padded to 1024, in bf16; 512 in fp16; 288 and 512 in f32), and K1
    and B2 at head dims 16 and 80 (no body takes them: the inputs run
    zero-padded to 32 and 96) on the main path's shape in bf16, each held
    alone against its plain version at the caller's head dim;
    ``flash_attention`` forward and backward at each, the counters zeroed
    just before and read just after each (K1 1, and K2 1 + K3 1 at 256
    and above, B2 1 at 16 and 80), its output and gradients against the
    plain blockwise path;
    then the kernels (at 256 and above) and ``flash_attention`` (at 16 and
    80, padding included) timed beside SDPA's fastest backend at the same
    head dim and the bound of the caller's work.  Returns the summary's
    rows of 256 and above."""
    causal = True
    cases = ([(HEAD_DIM_WIDE, torch.bfloat16, "split"),
              (HEAD_DIM_WIDE_F32, torch.float32, "split")]
             + [(s, dt, "split") for s, dt in HEAD_DIM_WIDER]
             + [(s, torch.bfloat16, "combined") for s in HEAD_DIM_PADDED])
    result, entries = {}, {}
    for shape, dtype, mode in cases:
        d = shape[-1]
        tag = f"d{d}{_dtype_tag(dtype)}"
        if tag in result:  # a second shape at this head dim and dtype
            tag += f"_bh{shape[0] * shape[1]}"
        if A.bwd_mode(shape[2], d, shape[0] * shape[1]) != mode:
            fail(f"the plan does not pick {mode} at {shape}")
        errs, zero_pad = hold_padded(shape, dtype, causal, mode, 20 + d)
        launched, got, want = drive_flash_attention(shape, dtype, causal,
                                                    30 + d)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            fail(f"flash_attention at {shape} {dtype}: non-finite output")
        path_err = _rel_errs(got, want)
        del got, want
        want_launches = {"flash_fwd": 1,
                         "flash_bwd": int(mode == "combined"),
                         "flash_bwd_dkdv": int(mode == "split"),
                         "flash_bwd_dq": int(mode == "split")}
        worst = max(e["worst"] for e in errs.values())
        row = {"shape": list(shape), "dtype": str(dtype), "mode": mode,
               "body_head_dim": A.padded_head_dim(d), "errors": errs,
               "worst": worst, "padded_columns_zero": zero_pad,
               "launches": launched, "path_rel_err": path_err}
        result[tag] = row
        if worst > 1.0 or not zero_pad or launched != want_launches \
                or max(path_err.values()) > 5e-2:
            emit("head_dims", cases=result)
            fail(f"head dim {d} {dtype}: {row}, want launches "
                 f"{want_launches}")

        # Times: the kernels at 256 and above; flash_attention itself at 16
        # and 80, where the padding is part of the cost.
        pairs, tile, rowb = attention_work(shape, dtype, causal)
        scale = d ** -0.5
        lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(
            shape, dtype, causal, scale, 40 + d)
        fwd_bound = bound_ms(4 * d * pairs, 4 * tile + rowb, dtype)
        if mode == "split":
            body = A.padded_head_dim(d)
            _, qr, k, v, do, p2, scale_r = kernel_inputs(
                shape[:3] + (body,), dtype, 50)
            o, lse = A.flash_fwd(qr, k, v, scale_r, causal)
            delta = A._delta(o, do)
            del o
            largs = (qr, k, v, do, lse, delta, scale_r)
            t_k1 = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal))
            t_k2 = time_ms(lambda: A.flash_bwd_dkdv(*largs, causal))
            t_k3 = time_ms(lambda: A.flash_bwd_dq(*largs, p2, causal))
            t_plain_fwd = time_ms(lambda: A._blockwise_fwd_impl(
                qr, k, v, causal, scale_r,
                block_size=A.fwd_key_tile(dtype, body)), warmup=1, iters=3)
            t_plain_bwd = time_ms(lambda: kernel_check.plain_bwd_outputs(
                qr, k, v, do, lse, delta, p2, scale_r, causal, "split"),
                warmup=1, iters=3)
            row["times"] = {"k1_ms": t_k1, "k2_ms": t_k2, "k3_ms": t_k3,
                            "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                            "k1_bound_ms": fwd_bound[0]}
            err = {n: max(errs[o]["max_abs_err"] for o in outs)
                   for n, outs in (("flash_fwd", ("o", "lse")),
                                   ("flash_bwd_dkdv", ("dk", "dv")),
                                   ("flash_bwd_dq", ("dq",)))}
            bounds = split_bounds(shape, dtype, causal)
            wide = d > A.WIDE_HEAD_DIM
            note = (f"head dim {d} at {list(shape)}, {dtype}"
                    + (f" (the wide body, padded to {body})"
                       if wide and body != d else
                       " (the wide body)" if wide else "")
                    + "; library_ms: SDPA's fastest backend (forward for "
                    "K1, whole backward for K2 and K3); bound of the "
                    "caller's head dim's work")
            quoted = WIDE_QUOTED_MS.get(tag, (None,) * 3)
            # In f32 K1, K2 and K3 run the 3xTF32 bodies, but K3 above 256
            # the SIMT one; above 256 the 16-bit bodies are the wgmma ones.
            f32 = dtype == torch.float32
            sources = {n: WIDE_SOURCE if f32 and wide and n == "flash_bwd_dq"
                       else WIDE_F32_SOURCE if f32 else WIDE_SM90_SOURCE
                       if wide else None
                       for n in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq")}
            entries[f"flash_fwd_{tag}"] = _rates(_entry(
                f"flash_fwd_{tag}", t_k1, t_plain_fwd, t_lib_fwd,
                4 * d * pairs, 4 * tile + rowb, dtype, err["flash_fwd"],
                kernel="flash_fwd", source=sources["flash_fwd"],
                library_by_backend=lib_fwd, shape=list(shape), note=note))
            for name, t in (("flash_bwd_dkdv", t_k2),
                            ("flash_bwd_dq", t_k3)):
                entries[f"{name}_{tag}"] = _rates(_entry(
                    f"{name}_{tag}", t, t_plain_bwd, t_lib_bwd,
                    *bounds[name], dtype, err[name], kernel=name,
                    source=sources[name],
                    library_by_backend=lib_bwd, shape=list(shape),
                    note=note + "; plain_ms: the whole plain split "
                    "backward"))
            for name, q in zip(("flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq"), quoted):
                e = entries[f"{name}_{tag}"]
                e["launches"] = launched[name]
                row["times"][name] = {k: e[k] for k in (
                    "ms", "tflops", "bound_share", "library_ms")}
                row["times"][name]["quoted_simt_ms"] = q
                if wide and not (f32 and name == "flash_bwd_dq"):
                    # The work the body does, its column CTAs' recompute
                    # (and in f32 the three TF32 products) included, over
                    # the caller's pairs.
                    row["times"][name]["tensor_core_tflops"] = (
                        pairs * A.wide_tensor_core_flops(name, d, dtype)
                        / e["ms"] / 1e9)
            del largs, qr, k, v, do, lse, delta
        else:
            g = torch.Generator(device="cuda").manual_seed(60 + d)
            xs = [torch.randn(shape, device="cuda", generator=g,
                              dtype=torch.float32).to(dtype).requires_grad_()
                  for _ in range(3)]
            ct = torch.randn(shape, device="cuda", generator=g).to(dtype)
            with torch.no_grad():
                t_fwd = time_ms(lambda: A.flash_attention(*xs, causal=causal))
            out = A.flash_attention(*xs, causal=causal)
            t_bwd = time_ms(lambda: torch.autograd.grad(
                out, xs, ct, retain_graph=True))
            bwd_bound = bound_ms(10 * d * pairs, 7 * tile + 2 * rowb, dtype)
            # K1 and B2 alone on the padded inputs: the bodies' share.
            _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, 50)
            pad = [A.pad_head(t, A.padded_head_dim(d)) for t in (qr, k, v, do)]
            o, lse = A.flash_fwd(*pad[:3], scale_r, causal)
            delta = A._delta(o, pad[3])
            t_k1 = time_ms(lambda: A.flash_fwd(*pad[:3], scale_r, causal))
            t_b2 = time_ms(lambda: A.flash_bwd(*pad, lse, delta, scale_r, p2,
                                               causal))
            del pad, o, lse, delta, qr, k, v, do
            row["times"] = {
                "fwd_ms": t_fwd, "bwd_ms": t_bwd, "k1_padded_ms": t_k1,
                "b2_padded_ms": t_b2, "sdpa_fwd_ms": lib_fwd,
                "sdpa_bwd_ms": lib_bwd, "library_fwd_ms": t_lib_fwd,
                "library_bwd_ms": t_lib_bwd, "fwd_bound_ms": fwd_bound[0],
                "bwd_bound_ms": bwd_bound[0]}
            del xs, ct, out
        torch.cuda.empty_cache()
    emit("head_dims", cases=result,
         note="times: flash_attention (fwd_ms, bwd_ms: the padding, the "
              "kernels and the slicing) at head dims 16 and 80, K1 and B2 "
              "alone on the padded inputs beside them, the kernels alone at "
              "256 and above (on inputs padded to the body's head dim; "
              "tflops and bound_share of the caller's work; quoted_simt_ms: "
              "the SIMT bodies' times from PERF.md, quoted and not "
              "measured in this run; tensor_core_tflops above 256: the "
              "body's own products, its column CTAs' recompute and in f32 "
              "the three TF32 products of each included, over the caller's "
              "pairs, attention.wide_tensor_core_flops; none for f32 K3, "
              "SIMT); bounds of the caller's head dim's work, f32 at the "
              "3xTF32 rate (PEAK_FLOPS); sdpa: each backend at the same "
              "head dim (and the math backend above 256)")
    return entries


def _worst(rows):
    return max(e["worst"] for r in rows for e in r["errors"].values())


def _max_err(rows, names):
    return max(r["errors"][n]["max_abs_err"] for r in rows for n in names)


def member_round_ms(mesh, launch, warmup=3, iters=15):
    """Median over rounds of the longest member's ``launch(i)``, by CUDA
    events on the member streams around the launches alone.  Each round
    forks the member streams off a sleep on the caller's stream, so every
    launch is queued before any starts, and joins them after the events;
    the fork and join stay outside the events."""
    rounds = []
    for _ in range(warmup + iters):
        torch.cuda._sleep(SLEEP_CYCLES)
        caller = mesh.fork()
        events = []
        for i in range(mesh.size):
            with mesh.on(i):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(i)
                end.record()
                events.append((start, end))
        mesh.join(caller)
        rounds.append(events)
    torch.cuda.synchronize()
    return statistics.median(max(s.elapsed_time(e) for s, e in events)
                             for events in rounds[warmup:])


def handshake_split(mesh, xs):
    """Kernel-only times (``member_round_ms``) of K6 on the shards ``xs``,
    of K6 moving no bytes (its handshake and gate alone), of K7, of an
    empty kernel per member (the floor of any kernel on these streams) and
    of one ``copy_`` per member on its stream."""
    n = mesh.size
    outs = [torch.empty_like(x) for x in xs]
    table = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    table_ptr = ctypes.cast(table, ctypes.c_void_p)
    nbytes = xs[0].numel() * xs[0].element_size()
    k6 = rdma._kernel_fn("hvdt_ring_permute")
    k7 = RF._kernel_fn("ring_permute", "hvdt_phase_closer")
    zeros = [torch.empty((8, 128), device="cuda") for _ in range(n)]
    ns6, ns7 = rdma.NS_RDMA, RF.NS_FUSED + 1
    blocks = rdma.copy_blocks(n)

    def k6_launch(size):
        return lambda i: A._launch(
            k6, xs[i].data_ptr(), table_ptr, size, blocks, 1,
            mesh.flags.data_ptr(), mesh.go.data_ptr(), mesh.err.data_ptr(),
            i, n, ns6, mesh.next_epoch(i, ns6))
    split = {
        "k6_kernel_ms": member_round_ms(mesh, k6_launch(nbytes)),
        "k6_0b_kernel_ms": member_round_ms(mesh, k6_launch(0)),
        "k7_kernel_ms": member_round_ms(mesh, lambda i: A._launch(
            k7, zeros[i].data_ptr(), mesh.flags.data_ptr(),
            mesh.err.data_ptr(), i, n, ns7)),
        "empty_kernel_ms": member_round_ms(
            mesh, lambda i: torch.cuda._sleep(0)),
        "copy_members_ms": member_round_ms(
            mesh, lambda i: outs[i].copy_(xs[i]))}
    if not all(torch.equal(outs[i], x) for i, x in enumerate(xs)):
        fail("copy_ on the member streams did not copy")
    if not all(bool((z == 0).all()) for z in zeros):
        fail("K7 left a nonzero in its zero block")
    return split


def phase_ring_kernels():
    """K4-K7 held against their plain versions (``kernel_check``) and
    timed."""
    cases, rows_by = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        mesh = RingMesh(N_MEMBERS)
        members, _, scale_r = kernel_check.ring_inputs(N_MEMBERS, RING,
                                                       dtype, 0)
        # t=0: every member on the diagonal; t=1: member 0 wholly masked,
        # the others wholly visible; t=n-1 without rotation: masked but
        # for the last member.  Rotating and non-rotating variants.
        for t, rotate in ((0, True), (1, True), (0, False),
                          (N_MEMBERS - 1, False)):
            rows = kernel_check.hold_ring_round(mesh, members, t, scale_r,
                                                rotate=rotate)
            balanced = mesh.flags_balanced()
            slots = all(r.get("slot_exact", True) for r in rows)
            ok = _worst(rows) <= 1.0 and balanced and slots
            cases.append({"dtype": str(dtype), "step": t, "rotate": rotate,
                          "kinds": [r["kind"] for r in rows],
                          "worst": _worst(rows), "slots_exact": slots,
                          "flags_balanced": balanced, "ok": ok})
            rows_by.setdefault(dtype, []).extend(rows)
            if not ok:
                emit("ring_kernels", cases=cases, failed=rows)
                fail(f"ring kernel disagrees with its plain version: "
                     f"{cases[-1]}")

    # K6: bit-exact rotations by +1 and -1, and the VJP (rotation by -1 on
    # the flipped namespace).
    mesh = RingMesh(N_MEMBERS)
    g = torch.Generator(device="cuda").manual_seed(5)
    shard = (RING[0] * RING[1], RING[2], RING[3])
    xs = [torch.randn(shard, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(N_MEMBERS)]
    exact = {}
    for shift in (1, -1):
        outs = rdma.permute_shards(xs, mesh, shift, 0)
        torch.cuda.synchronize()
        exact[shift] = all(torch.equal(outs[(i + shift) % N_MEMBERS], x)
                           for i, x in enumerate(xs))
    xg = [x.clone().requires_grad_() for x in xs]
    ws = [torch.randn(shard, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(N_MEMBERS)]
    rot = rdma.ring_permute(xg, mesh, 1, 2)
    grads = torch.autograd.grad(rot, xg, ws)
    exact["vjp"] = all(torch.equal(grads[i], ws[(i + 1) % N_MEMBERS])
                       for i in range(N_MEMBERS))
    k6_ok = all(exact.values()) and mesh.flags_balanced()

    # K7: zero blocks, and every flag back in balance after a full fused
    # forward + backward (which closes each pass with K7 on an even ring).
    caller = mesh.fork()
    zeros = RF.launch_round(mesh, RF.phase_closer, [{}] * N_MEMBERS)
    mesh.join(caller)
    torch.cuda.synchronize()
    k7_zero = all(bool((z == 0).all()) for z in zeros)
    ring_qkv = [[m[n].reshape(RING).clone().requires_grad_()
                 for m in members] for n in ("qr", "k", "v")]
    outs = RF.fused_ring_attention(*ring_qkv, mesh, causal=True)
    torch.autograd.grad(outs, [t for ts in ring_qkv for t in ts],
                        [torch.ones_like(o) for o in outs])
    torch.cuda.synchronize()
    k7_ok = k7_zero and mesh.flags_balanced()
    if not (k6_ok and k7_ok):
        fail(f"K6/K7 check failed: K6 {exact}, K7 zeros {k7_zero}, "
             f"flags {mesh.flags.tolist()}")

    # Times at the ring path's shape: K4 and K5 on a wholly visible step
    # (the heaviest kind), one launch without rotation, in bf16 and f32; in
    # bf16 a rotating round of all members beside them.  K6 and K7: one
    # round of all members.
    dtype = torch.bfloat16
    steps = {dt: ring_step_times(mesh, dt)
             for dt in (dtype, torch.float32)}
    members, scale_r = steps[dtype]["members"], steps[dtype]["scale_r"]
    sl = RING[2]
    t_k4_host = time_ms(steps[dtype]["k4"], host_ahead=False)
    calls = [dict(qr=members[i]["qr"], k=members[i]["k"],
                  v=members[i]["v"], q_offset=i * sl, k_offset=i * sl,
                  scale_r=scale_r, causal=True, rotate=True, phase=0)
             for i in range(N_MEMBERS)]

    def rotating_round(kernel, calls):
        caller = mesh.fork()
        RF.launch_round(mesh, kernel, calls)
        mesh.join(caller)
    t_k4_round = time_ms(lambda: rotating_round(RF.ring_flash_fwd, calls))
    t_k6 = time_ms(lambda: rdma.permute_shards(xs, mesh, 1, 0))
    split = handshake_split(mesh, xs)
    dsts = [torch.empty_like(x) for x in xs]
    t_copy = time_ms(lambda: [o.copy_(x) for o, x in zip(dsts, xs)])
    t_k7 = time_ms(lambda: rotating_round(RF.phase_closer,
                                          [{}] * N_MEMBERS))
    mesh.check()
    if not mesh.flags_balanced():
        fail(f"flags out of balance after the timed rounds: "
             f"{mesh.flags.tolist()}")

    b, h, _, d = RING
    tile = b * h * sl * d * torch.tensor([], dtype=dtype).element_size()

    def step_entry(name, dt, outs, **extra):
        s = steps[dt]
        flops, nbytes, lib_ms, by_backend = s["work"][name]
        return _entry(name, s["ms"][name], s["plain_ms"][name], lib_ms,
                      flops, nbytes, dt, _max_err(rows_by[dt], outs),
                      library_by_backend=by_backend, **extra)

    f32 = {}
    for n, outs in (("ring_flash_fwd", ("o", "lse")),
                    ("ring_flash_bwd", ("dq", "dk", "dv"))):
        e = step_entry(n, torch.float32, outs)
        f32[n] = {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_by_backend",
                                    "max_abs_err")}
        f32[n]["x_sdpa"] = e["ms"] / e["library_ms"] if e["library_ms"] \
            else None
    entries = {
        "ring_flash_fwd": step_entry(
            "ring_flash_fwd", dtype, ("o", "lse"),
            rotating_round_ms=t_k4_round, ms_with_host=t_k4_host,
            f32=f32["ring_flash_fwd"]),
        "ring_flash_bwd": step_entry(
            "ring_flash_bwd", dtype, ("dq", "dk", "dv"),
            f32=f32["ring_flash_bwd"]),
        "ring_permute": _entry(
            "ring_permute", t_k6, None, t_copy, 0,
            2 * N_MEMBERS * tile, dtype, 0.0,
            kernel_ms=split["k6_kernel_ms"], **{k: split[k] for k in (
                "k6_0b_kernel_ms", "empty_kernel_ms", "copy_members_ms")},
            note="ms: one round, fork and join included; kernel_ms: the "
                 "longest member launch by CUDA events on its stream "
                 "(k6_0b: moving no bytes, the handshake and gate alone; "
                 "empty: an empty kernel per member, the floor); library: "
                 "one copy_ per member on one stream (copy_members: each on "
                 "its member's stream, kernel-only)"),
        "phase_closer": _entry(
            "phase_closer", t_k7, None, None, 0, N_MEMBERS * 8 * 128 * 4,
            torch.float32, 0.0, kernel_ms=split["k7_kernel_ms"],
            empty_kernel_ms=split["empty_kernel_ms"],
            note="ms: one round, every member's launch, fork and join "
                 "included; kernel_ms: the longest member launch"),
    }
    emit("ring_kernels", cases=cases, shard=list(RING), members=N_MEMBERS,
         k6_exact=exact, k7_zero=k7_zero,
         timing={n: {k: e.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                 for n, e in entries.items()},
         k4_rotating_round_ms=t_k4_round, handshake_split=split, f32=f32,
         note="K4/K5: one launch on a wholly visible step of the ring "
              "shard, no rotation, in bf16 (f32: the same in float32, on "
              "their 3xTF32 wgmma bodies, bounds at the 3xTF32 rate); "
              "library_ms: SDPA forward / backward (non-causal) on the same "
              "shard")
    return entries


def ring_step_times(mesh, dtype):
    """K4's and K5's times at the ring path's shard in ``dtype``: one
    launch on a wholly visible step, no rotation, beside their plain
    versions and SDPA (non-causal) on the same shard, with each one's work
    (flops, bytes, SDPA's ms and its backends), the inputs and K4's call."""
    members, _, scale_r = kernel_check.ring_inputs(N_MEMBERS, RING, dtype, 1)
    m0, m1 = members[0], members[1]
    b, h, sl, d = RING
    ref, delta = kernel_check.ring_plain_step(m1["qr"], m0["k"], m0["v"],
                                              m1["do"], sl, 0, True, scale_r)

    def k4():
        return RF.ring_flash_fwd(mesh, 1, m1["qr"], m0["k"], m0["v"], sl, 0,
                                 scale_r, True)
    ms = {"ring_flash_fwd": time_ms(k4),
          "ring_flash_bwd": time_ms(lambda: RF.ring_flash_bwd(
              mesh, 1, m1["qr"], m0["k"], m0["v"], m1["do"], ref["lse"],
              delta, sl, 0, scale_r, True))}
    plain = {"ring_flash_fwd": time_ms(lambda: A._blockwise_fwd_impl(
                 m1["qr"], m0["k"], m0["v"], True, scale_r,
                 block_size=A.fwd_key_tile(dtype, d), q_offset=sl,
                 k_offset=0), warmup=1, iters=5),
             "ring_flash_bwd": time_ms(lambda: A._attention_bwd_impl(
                 m1["qr"], m0["k"], m0["v"], ref["lse"], delta, m1["do"],
                 True, scale_r,
                 block_size=A.bwd_key_tile("combined", dtype, d),
                 round_pds=True, q_offset=sl, k_offset=0,
                 grad_dtype=torch.float32), warmup=1, iters=5)}
    lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(RING, dtype, False,
                                                        1.0, 1)
    el = torch.tensor([], dtype=dtype).element_size()
    tile, tile32, row = b * h * sl * d * el, b * h * sl * d * 4, b * h * sl * 4
    pairs = b * h * sl * sl  # a wholly visible step
    # (flops, bytes: each input read once, each output written once; K5's
    # gradients are f32 partials)
    work = {"ring_flash_fwd": (4 * d * pairs, 4 * tile + row, t_lib_fwd,
                               lib_fwd),
            "ring_flash_bwd": (10 * d * pairs, 4 * tile + 2 * row + 3 * tile32,
                               t_lib_bwd, lib_bwd)}
    return {"ms": ms, "plain_ms": plain, "work": work, "members": members,
            "scale_r": scale_r, "k4": k4}


def ring_launches():
    return {**{n: RF.launches[n] for n in RF.launches},
            **{n: rdma.launches[n] for n in rdma.launches}}


def reset_ring_launches():
    RF.reset_launches()
    rdma.reset_launches()


def phase_ring_model():
    """A small f32 LM sequence-parallel over a ring of 4 members, in every
    ring mode, against the unsharded model on the same weights and
    tokens: logits and every gradient."""
    cfg = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
               dtype=torch.float32)
    base = TransformerLM(**cfg)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 4 * 64 + 1))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits = base(inp)
    next_token_loss(logits, tgt).backward()
    want = (logits.detach(), {n: p.grad for n, p in base.named_parameters()})
    result = {}
    n_layers = cfg["n_layers"]
    for impl in ("fused", "rdma", "ppermute"):
        mesh = RingMesh(N_MEMBERS)
        model = TransformerLM(**cfg, seq_axis=mesh, ring_impl=impl)
        model.load_state_dict(base.state_dict())
        reset_ring_launches()
        logits = model(inp)
        next_token_loss(logits, tgt, axis_name=mesh).backward()
        torch.cuda.synchronize()
        got = ring_launches()
        dl = (logits.detach() - want[0]).abs().max().item()
        dg = max((p.grad - want[1][n]).abs().max().item()
                 for n, p in model.named_parameters())
        per = N_MEMBERS * n_layers
        expect = {"ring_flash_fwd": 0, "ring_flash_bwd": 0,
                  "phase_closer": 0, "ring_permute": 0}
        if impl == "fused":
            expect.update(ring_flash_fwd=per * N_MEMBERS,
                          ring_flash_bwd=per * N_MEMBERS,
                          phase_closer=per * 2 * (N_MEMBERS % 2 == 0))
        elif impl == "rdma":
            expect["ring_permute"] = per * 4 * (N_MEMBERS - 1)
        result[impl] = {"logits_max_abs_err": dl, "grad_max_abs_err": dg,
                        "launches": got,
                        "flags_balanced": mesh.flags_balanced()}
        # f32 on both sides: summation order only (K5's dQ atomics too).
        if dl > 1e-4 or dg > 1e-4 or got != expect \
                or not mesh.flags_balanced():
            emit("ring_model", modes=result)
            fail(f"ring model ({impl}) disagrees with the unsharded "
                 f"model, or launched {got} for {expect}")
    emit("ring_model", members=N_MEMBERS, modes=result)


def phase_ring_train():
    """The slice's path at full width: the headline LM sequence-parallel
    over a ring of 4 members on the card, batch 4 x seq 4096, fused
    (K4, K5, K7); then two steps with ``ring_impl="rdma"`` (K6)."""
    hvd.init()
    cfg = {k: v for k, v in RING_HEADLINE.items()}
    vocab, batch, seq = cfg["vocab_size"], cfg["batch"], cfg["seq"]
    n_layers, members = cfg["n_layers"], cfg["members"]
    model, step, data = build_lm_step(**cfg)
    mesh = model.seq_axis
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    reset_ring_launches()
    losses, step_ms, _ = timed_steps(step, data, warmup, timed)
    torch.cuda.synchronize()
    launched = ring_launches()
    peak = torch.cuda.max_memory_allocated()
    want = ring_want(warmup + timed, members, n_layers)
    med = statistics.median(step_ms)
    emit("ring_train", members=members, batch=batch, seq=seq,
         ring_impl=cfg["ring_impl"], tokens_per_s=batch * seq / (med / 1e3),
         median_step_ms=med, step_ms=step_ms, max_memory_allocated=peak,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         launches=launched, want_launches=want,
         flags_balanced=mesh.flags_balanced())
    if launched != want:
        fail(f"ring path launched {launched}, the JAX program implies "
             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"implausible loss trajectory: {losses}")
    if not mesh.flags_balanced():
        fail(f"flags out of balance: {mesh.flags.tolist()}")
    del model, step, data

    # The rdma ring at the same width: K6 rotates K and V.
    rcfg = dict(cfg, ring_impl="rdma")
    model, step, data = build_lm_step(**rcfg)
    steps = 2
    reset_ring_launches()
    rlosses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        rlosses.append(step(data).item())
    rdma_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    rlaunched = ring_launches()
    rwant = {"ring_flash_fwd": 0, "ring_flash_bwd": 0, "phase_closer": 0,
             "ring_permute": members * n_layers * steps * 4 * (members - 1)}
    emit("ring_train_rdma", members=members, batch=batch, seq=seq,
         losses=rlosses, mean_step_ms=rdma_ms, launches=rlaunched,
         want_launches=rwant)
    if rlaunched != rwant:
        fail(f"rdma ring launched {rlaunched}, want {rwant}")
    # Same weights and tokens as the fused run's first step.
    if abs(rlosses[0] - losses[0]) > 1e-2 or rlosses[1] >= rlosses[0]:
        fail(f"rdma ring losses {rlosses} against fused {losses[:2]}")
    hvd.shutdown()
    return {**launched, "ring_permute": rlaunched["ring_permute"]}

# --- the data-parallel phases: ranks of the port's runner on this card ---


def run_ranks(phase, timeout, ranks=DP_RANKS, script=__file__, env=None,
              tag=None):
    """Run ``<script> --rank <phase>`` (this script by default) on
    ``ranks`` ranks, with ``env`` added to this process's environment;
    each rank's ``RESULT`` line, parsed.  A rank that exits non-zero or a
    timeout fails the run; every rank's output is kept in OUT_DIR as
    ``<tag or phase>_rank<r>.log``."""
    env = dict(os.environ, **(env or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    results = run_command(
        [sys.executable, os.path.abspath(script), "--rank", phase],
        ranks, env=env, timeout=timeout, capture=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    out = []
    for r in results:
        with open(os.path.join(OUT_DIR, f"{tag or phase}_rank{r.rank}.log"),
                  "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
        if r.returncode != 0:
            fail(f"{phase}: rank {r.rank} exited {r.returncode}:\n"
                 f"{r.stderr[-4000:]}")
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if not lines:
            fail(f"{phase}: rank {r.rank} printed no result")
        out.append(json.loads(lines[-1][len("RESULT "):]))
    return out


def rank_result(**fields):
    print("RESULT " + json.dumps(fields), flush=True)


def events_ms(fn):
    """Milliseconds of ``fn``'s work on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rank_collectives():
    """One rank of ``collectives``: every op held against its exact value;
    raises on the first mismatch."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    held = []

    def hold(name, got, want):
        got = got.cpu()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(
                f"{name}: got {got.flatten()[:6].tolist()} ({got.dtype}, "
                f"{tuple(got.shape)}), want {want.flatten()[:6].tolist()} "
                f"({want.dtype}, {tuple(want.shape)})")
        held.append(name)

    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        for numel in (1, 1001, (64 << 20) // dtype.itemsize):
            base = torch.arange(numel, device="cuda") % 7
            x = (base + r + 1).to(dtype)
            total = n * base + n * (n + 1) // 2
            mean = (total.double() / n if dtype.is_floating_point
                    else total // n)  # the engine truncates integer means
            tag = f"{str(dtype)[6:]}.{numel}"
            hold(f"sum.{tag}", hvdt.allreduce(x, average=False,
                                              name=f"sum.{tag}"),
                 total.to(dtype).cpu())
            hold(f"mean.{tag}", hvdt.allreduce(x, average=True,
                                               name=f"mean.{tag}"),
                 mean.to(dtype).cpu())
            y = x.clone()
            if hvdt.allreduce_(y, average=False, name=f"sum_.{tag}") is not y:
                raise RuntimeError("allreduce_ did not return its input")
            hold(f"sum_.{tag}", y, total.to(dtype).cpu())
            z = (base * (r + 1)).to(dtype)
            if hvdt.broadcast_(z, 1, name=f"bcast_.{tag}") is not z:
                raise RuntimeError("broadcast_ did not return its input")
            hold(f"bcast_.{tag}", z, (base * 2).to(dtype).cpu())
            del base, x, y, z, total, mean
    # The small copies queue behind a ~20 ms sleep kernel and land
    # together, as a backward's gradients do, so the staging thread
    # enqueues them in a burst that the engine can fuse.
    smalls = [torch.full((16,), float(i + r), device="cuda")
              for i in range(64)]
    torch.cuda._sleep(20 * SLEEP_CYCLES)
    handles = [hvdt.allreduce_async(x, average=False, name=f"small.{i}")
               for i, x in enumerate(smalls)]
    for i, h in enumerate(handles):
        hold(f"small.{i}", hvdt.synchronize(h),
             torch.full((16,), float(n * i + n * (n - 1) // 2)))
    small_ticks = len({h.completion_tick for h in handles})
    if small_ticks >= len(handles):
        raise RuntimeError(f"64 small allreduces took {small_ticks} engine "
                           "cycles: not fused")
    hold("allgather", hvdt.allgather(
        torch.full((r + 1, 3), float(r + 1), device="cuda"),
        name="allgather"),
        torch.cat([torch.full((k + 1, 3), float(k + 1)) for k in range(n)]))
    ramp = torch.arange(1001, dtype=torch.float32)
    hold("broadcast.root1", hvdt.broadcast(
        (ramp * (r + 1)).cuda(), 1, name="broadcast.root1"), ramp * 2)
    try:
        hvdt.allreduce(torch.ones(r + 2, device="cuda"), name="mismatch")
        raise RuntimeError("a shape mismatch across ranks did not raise")
    except ValueError as exc:
        mismatch = f"{type(exc).__name__}: {exc}"[:300]

    # 224 MiB of f32, split: D2H into pinned memory, the engine's host
    # allreduce of it, H2D back; then through the staging route whole.
    numel = GRAD_BYTES // 4
    g = torch.full((numel,), float(r + 1), device="cuda")
    mean = torch.full((len(range(0, numel, 1 << 16)),), (n + 1) / 2)
    buf = torch.empty(numel, pin_memory=True)
    seq = iter(range(1 << 30))

    def barrier():
        hvd_common.allreduce_async(torch.zeros(1), False,
                                   f"barrier.{next(seq)}").wait()

    split = {"d2h_ms": [], "engine_ms": [], "h2d_ms": [], "whole_ms": []}
    for i in range(4):
        torch.cuda.synchronize()
        barrier()
        d2h = events_ms(lambda: buf.copy_(g, non_blocking=True))
        barrier()
        t0 = time.perf_counter()
        hvd_common.allreduce_async(buf, True, "big.host", out=buf).wait()
        eng = (time.perf_counter() - t0) * 1e3
        h2d = events_ms(lambda: g.copy_(buf, non_blocking=True))
        hold(f"big.host.{i}", g[:: 1 << 16], mean)
        g.fill_(float(r + 1))  # the ranks differ again for the whole route
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hvdt.allreduce_(g, average=True, name="big")
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
        hold(f"big.{i}", g[:: 1 << 16], mean)
        g.fill_(float(r + 1))
        if i:
            for k, v in zip(split, (d2h, eng, h2d, whole)):
                split[k].append(v)
    # The engine alone on host buffers by size: where its rate settles.
    sweep = {}
    for mib in (1, 4, 16, 64, 224):
        host = buf[:(mib << 20) // 4]
        times = []
        for _ in range(3):
            barrier()
            t0 = time.perf_counter()
            hvd_common.allreduce_async(host, True, f"sweep.{mib}",
                                       out=host).wait()
            times.append((time.perf_counter() - t0) * 1e3)
        sweep[mib] = statistics.median(times)
    rank_result(rank=r, size=n, held=len(held), small_ticks=small_ticks,
                mismatch=mismatch, pinned_allocs=hvdt.mpi_ops.pinned_allocs[0],
                **{k: statistics.median(v) for k, v in split.items()},
                split_runs=split, engine_ms_by_mib=sweep)
    hvdt.shutdown()


def phase_collectives():
    res = run_ranks("collectives", timeout=300)
    smi = smi_line()
    emit("collectives", ranks=res, nvidia_smi=smi,
         grad_bytes=GRAD_BYTES,
         d2h_ms=max(x["d2h_ms"] for x in res),
         engine_ms=max(x["engine_ms"] for x in res),
         h2d_ms=max(x["h2d_ms"] for x in res),
         whole_ms=max(x["whole_ms"] for x in res),
         engine_ms_by_mib={k: max(x["engine_ms_by_mib"][k] for x in res)
                           for k in res[0]["engine_ms_by_mib"]})
    if len({x["held"] for x in res}) != 1 or not res[0]["held"]:
        fail(f"collectives: the ranks held different checks: {res}")


def profile_step(run, name):
    """``run()`` (one step) under ``torch.profiler``: ``(wall ms,
    kernel-busy ms, D2H ms, H2D ms)`` of this process, or Nones if the
    trace holds no device time."""
    path = os.path.join(OUT_DIR, f"{name}_trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    copies = [e for e in events
              if e.get("cat") == "gpu_memcpy" and "dur" in e]
    if not kernels:
        return wall, None, None, None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels + copies)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    d2h = sum(e["dur"] for e in copies if "DtoH" in e["name"]) / 1e3
    h2d = sum(e["dur"] for e in copies if "HtoD" in e["name"]) / 1e3
    return wall, busy / 1e3, d2h, h2d


def params_digest(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def rank_train_dp():
    """One rank of ``train_dp``."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    batch = HEADLINE["batch"]
    model, step, data = build_lm_step(**HEADLINE, seed=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms, sync_ms, cycles = [], [], [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(data).item()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        cycles.append(len(set(step.optimizer.last_ticks)))
        if i >= warmup:
            step_ms.append(dt)
            sync_ms.append(step.sync_sec[-1] * 1e3)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    handles = len(step.optimizer.last_ticks)
    digest = params_digest(model)
    wall, busy, d2h, h2d = profile_step(lambda: step(data).item(),
                                        f"train_dp_rank{r}")
    del model, step, data
    torch.cuda.empty_cache()
    avg_losses = averaging_losses(slice(r * batch // n, (r + 1) * batch // n))
    rank_result(rank=r, size=n, losses=losses, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms), sync_ms=sync_ms,
                median_sync_ms=statistics.median(sync_ms),
                max_memory_allocated=peak, launches=launched,
                grad_handles=handles, engine_cycles_per_step=cycles,
                digest=digest, profiled_step_ms=wall, busy_ms=busy,
                d2h_ms=d2h, h2d_ms=h2d, avg_losses=avg_losses)
    hvdt.shutdown()


def averaging_losses(rows):
    """The averaging check's run on this rank: 3 steps of the LM headline
    from ``AVG_SEED`` on rows ``rows`` of one batch drawn from
    ``RandomState(AVG_SEED)``.  Every size starts from the same weights
    and optimizer state: at size 1 the zero-learning-rate step that a
    data-parallel run's ``broadcast_optimizer_state`` takes is taken
    here."""
    _, step, _ = build_lm_step(**HEADLINE, seed=AVG_SEED)
    if hvd.size() == 1:
        hvdt.broadcast_optimizer_state(step.optimizer, root_rank=0)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    tokens = torch.from_numpy(np.random.RandomState(AVG_SEED).randint(
        0, vocab, (batch, seq + 1))[rows]).cuda()
    losses = [step((tokens[:, :-1], tokens[:, 1:])).item() for _ in range(3)]
    del step, tokens
    torch.cuda.empty_cache()
    return losses


def averaging_reference():
    """``(refs, tolerance)``: two size-1 runs of ``averaging_losses`` on
    every row, and per step 3x their spread (B2's f32 dQ adds are not
    ordered), at least 1e-3 of the loss."""
    hvd.init()
    refs = [averaging_losses(slice(None)) for _ in range(2)]
    hvd.shutdown()
    spread = [abs(a - b) for a, b in zip(*refs)]
    return refs, [max(3 * s, 1e-3 * abs(a)) for s, a in zip(spread, refs[0])]


def phase_train_dp():
    torch.cuda.empty_cache()
    res = run_ranks("train_dp", timeout=300)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    per = HEADLINE["n_layers"] * 7
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    step_ms = max(x["median_step_ms"] for x in res)
    busy = [x["busy_ms"] for x in res]
    idle = (None if None in busy
            else 1.0 - sum(busy) / max(x["profiled_step_ms"] for x in res))

    refs, tol = averaging_reference()
    dp = res[0]["avg_losses"]
    off = [abs(a - b) for a, b in zip(dp, refs[0])]
    emit("train_dp", ranks=DP_RANKS, batch_per_rank=batch, seq=seq,
         nvidia_smi=smi_line(),
         tokens_per_s=DP_RANKS * batch * seq / (step_ms / 1e3),
         median_step_ms=step_ms,
         median_sync_ms=[x["median_sync_ms"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         engine_cycles_per_step=[x["engine_cycles_per_step"] for x in res],
         grad_handles=res[0]["grad_handles"],
         profiled_step_ms=[x["profiled_step_ms"] for x in res],
         kernel_and_copy_busy_ms=busy,
         d2h_ms=[x["d2h_ms"] for x in res], h2d_ms=[x["h2d_ms"] for x in res],
         card_idle_share_estimate=idle,
         losses=res[0]["losses"], launches=[x["launches"] for x in res],
         want_launches=want, digests=[x["digest"] for x in res],
         averaging={"dp": dp, "size1": refs, "abs_err": off,
                    "tolerance": tol})
    for x in res:
        if x["launches"] != want:
            fail(f"train_dp rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if x["losses"] != res[0]["losses"]:
            fail(f"train_dp: the ranks' mean losses differ: {res}")
        if x["grad_handles"] != 51 or max(
                x["engine_cycles_per_step"]) >= x["grad_handles"]:
            fail(f"train_dp: gradient handles not fused: {x}")
    if len({x["digest"] for x in res}) != 1:
        fail("train_dp: the ranks' parameters differ after the steps")
    losses = res[0]["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_dp: non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"train_dp: implausible loss trajectory: {losses}")
    if any(o > t for o, t in zip(off, tol)):
        fail(f"train_dp: averaged losses {dp} against size-1 {refs[0]}, "
             f"tolerance {tol}")
    return res[0]["launches"], step_ms, res


def rank_compression():
    """One rank of ``compression``: ``train_dp``'s steps under the
    environment's ``HVD_TPU_COMPRESSION``, with the engine's compression
    counters read around the timed steps."""
    hvdt.init(device=DP_DEVICE)
    r = hvdt.rank()
    model, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
    floor = hvdt.compression_report()["min_bytes"]
    at_floor = sum(1 for p in model.parameters()
                   if p.dtype == torch.float32
                   and p.numel() * p.element_size() >= floor)
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms, sync_ms, residuals = [], [], [], []
    for i in range(warmup + timed):
        if i == warmup:
            base = hvdt.compression_report()["engine"]
        t0 = time.perf_counter()
        loss = step(data).item()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        residuals.append(hvdt.compression_report()["residual_tensors"])
        if i >= warmup:
            step_ms.append(dt)
            sync_ms.append(step.sync_sec[-1] * 1e3)
    torch.cuda.synchronize()
    rep = hvdt.compression_report()
    eng = rep["engine"]
    log = [[e["name"], e["mode"]] for e in rep["log"]]
    rank_result(
        rank=r, mode=rep["mode"], min_bytes=rep["min_bytes"],
        losses=losses, step_ms=step_ms,
        median_step_ms=statistics.median(step_ms), sync_ms=sync_ms,
        median_sync_ms=statistics.median(sync_ms),
        launches=dict(A.launches), digest=params_digest(model),
        wire_bytes=eng["wire_bytes"] - base["wire_bytes"],
        payload_bytes=eng["payload_bytes"] - base["payload_bytes"],
        buckets={m: eng["ops"][m] - base["ops"][m] for m in eng["ops"]},
        residual_tensors=residuals, residual_bytes=rep["residual_bytes"],
        f32_grads_at_floor=at_floor, log_entries=len(log),
        log_digest=hashlib.sha256(json.dumps(log).encode()).hexdigest(),
        log_tail=log[-3:])
    hvdt.shutdown()


def compression_run(mode, dp_losses):
    """``compression``'s run of one mode: the ranks' results, gated."""
    res = run_ranks("compression", timeout=300, tag=f"compression_{mode}",
                    env={"HVD_TPU_COMPRESSION": mode,
                         "HVD_TPU_COMPRESSION_MIN_BYTES": str(COMP_FLOOR)})
    x = res[0]
    ratio = x["wire_bytes"] / max(x["payload_bytes"], 1)
    gap = [abs(a - b) / abs(b) for a, b in zip(x["losses"], dp_losses)]
    if any(y["mode"] != mode or y["min_bytes"] != COMP_FLOOR for y in res):
        fail(f"compression: the engine runs {[y['mode'] for y in res]} "
             f"at floors {[y['min_bytes'] for y in res]}, want {mode} at "
             f"{COMP_FLOOR}")
    if len({y["digest"] for y in res}) != 1:
        fail(f"compression {mode}: the ranks' parameters differ")
    if len({(y["log_entries"], y["log_digest"]) for y in res}) != 1:
        fail(f"compression {mode}: the ranks' decision logs differ: "
             f"{[(y['log_entries'], y['log_tail']) for y in res]}")
    if ratio > COMP_RATIO[mode] or not x["buckets"][mode]:
        fail(f"compression {mode}: wire/payload {ratio} (limit "
             f"{COMP_RATIO[mode]}), buckets {x['buckets']}")
    for y in res:
        if set(y["residual_tensors"]) != {y["f32_grads_at_floor"]}:
            fail(f"compression {mode}: residuals per step "
                 f"{y['residual_tensors']}, want "
                 f"{y['f32_grads_at_floor']} each step")
    losses = x["losses"]
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"compression {mode}: losses {losses}")
    if mode == "bf16" and max(gap) > COMP_LOSS_RTOL:
        fail(f"compression bf16: losses {losses} against train_dp's "
             f"{dp_losses}: relative gap {gap} > {COMP_LOSS_RTOL}")
    return res, ratio, gap


def phase_compression(dp_res, dp_launched):
    """``compression``: bf16, then fp8, beside ``train_dp``'s run."""
    t_phase = time.perf_counter()
    dp = dp_res[0]
    dp_step = max(y["median_step_ms"] for y in dp_res)
    tokens = DP_RANKS * HEADLINE["batch"] * HEADLINE["seq"]
    want = {k: dp_launched[k] for k in ("flash_fwd", "flash_bwd")}
    out = {}
    for mode in ("bf16", "fp8"):
        res, ratio, gap = compression_run(mode, dp["losses"])
        step_ms = max(y["median_step_ms"] for y in res)
        for y in res:
            if {k: y["launches"][k] for k in want} != want:
                fail(f"compression {mode} rank {y['rank']} launched "
                     f"{y['launches']}, want {want}")
        out[mode] = {
            "tokens_per_s": tokens / (step_ms / 1e3),
            "median_step_ms": step_ms,
            "median_sync_ms": [y["median_sync_ms"] for y in res],
            "wire_bytes": res[0]["wire_bytes"],
            "payload_bytes": res[0]["payload_bytes"],
            "wire_over_payload": ratio, "buckets": res[0]["buckets"],
            "residual_tensors": res[0]["residual_tensors"],
            "residual_bytes": res[0]["residual_bytes"],
            "log_entries": res[0]["log_entries"],
            "log_tail": res[0]["log_tail"],
            "losses": res[0]["losses"], "loss_gap_rel": gap,
            "launches": [y["launches"] for y in res],
            "digests": [y["digest"] for y in res]}
    emit("compression", ranks=DP_RANKS, floor_bytes=COMP_FLOOR,
         nvidia_smi=smi_line(), modes=out,
         train_dp={"tokens_per_s": tokens / (dp_step / 1e3),
                   "median_step_ms": dp_step,
                   "median_sync_ms": [y["median_sync_ms"] for y in dp_res],
                   "losses": dp["losses"]},
         seconds=time.perf_counter() - t_phase)


def rank_autotune():
    """One rank of ``autotune``: ``train_dp``'s step under the
    environment's ``HVD_TPU_AUTOTUNE``, until a collective poll finds every
    rank's tuner frozen or ``AUTOTUNE_MAX_STEPS`` steps, then
    ``AUTOTUNE_AFTER`` steps at the frozen point."""
    hvdt.init(device=DP_DEVICE)
    r, n = hvdt.rank(), hvdt.size()
    model, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
    A.reset_launches()
    losses, step_ms, frozen_at = [], [], None
    for i in range(AUTOTUNE_MAX_STEPS):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        # The ranks see the freeze at different ticks: a rank-local break
        # would leave the other's next step unmatched.
        frozen = torch.tensor([int(hvdt.autotune_report()["frozen"])],
                              dtype=torch.int32)
        if int(hvdt.allreduce(frozen, average=False,
                              name="autotune.poll")[0]) == n:
            frozen_at = i + 1
            break
    for _ in range(AUTOTUNE_AFTER if frozen_at else 0):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    rep = hvdt.autotune_report()
    rank_result(
        rank=r, steps=len(losses), frozen_at=frozen_at, losses=losses,
        step_ms=step_ms, launches=dict(A.launches),
        digest=params_digest(model), windows=rep["windows"],
        frozen=rep["frozen"], fusion_threshold=rep["fusion_threshold"],
        cycle_time_ms=rep["cycle_time_ms"], best_score=rep["best_score"],
        applied=[[a["tick"], a["fusion_threshold"], a["cycle_time_ms"],
                  a["frozen"]] for a in rep["applied"]],
        history=rep["history"])
    hvdt.shutdown()


def phase_autotune(dp_res):
    t_phase = time.perf_counter()
    res = run_ranks("autotune", timeout=400, env=AUTOTUNE_ENV)
    x = res[0]
    emit("autotune", ranks=DP_RANKS, start=AUTOTUNE_ENV,
         nvidia_smi=smi_line(), steps=x["steps"], frozen_at=x["frozen_at"],
         windows=x["windows"], frozen=[y["frozen"] for y in res],
         fusion_threshold=x["fusion_threshold"],
         cycle_time_ms=x["cycle_time_ms"], best_score=x["best_score"],
         applied=x["applied"], history=x["history"],
         first3_step_ms=x["step_ms"][:3], last3_step_ms=x["step_ms"][-3:],
         train_dp_median_step_ms=max(y["median_step_ms"] for y in dp_res),
         losses=x["losses"], launches=[y["launches"] for y in res],
         digests=[y["digest"] for y in res],
         seconds=time.perf_counter() - t_phase)
    if any(y["applied"] != x["applied"] for y in res):
        fail(f"autotune: the ranks applied different parameters: "
             f"{[y['applied'] for y in res]}")
    if len({y["digest"] for y in res}) != 1:
        fail("autotune: the ranks' parameters differ after the steps")
    if not all(math.isfinite(v) for y in res for v in y["losses"]):
        fail(f"autotune: non-finite loss: {[y['losses'] for y in res]}")
    if any(y["fusion_threshold"] < 64 * 1024 for y in res):
        fail(f"autotune: the threshold stayed at "
             f"{[y['fusion_threshold'] for y in res]}")


def ring_want(steps, members, n_layers):
    """``ring_train``'s launch formula for the fused ring: per member,
    layer and step K4 n, K5 n and, at even n, K7 2; K6 never."""
    per = members * n_layers * steps
    return {"ring_flash_fwd": per * members,
            "ring_flash_bwd": per * members,
            "phase_closer": per * 2 * (members % 2 == 0), "ring_permute": 0}


def rank_ring_dp():
    """One rank of ``ring_dp``: a fused ring of ``RING_HEADLINE`` on this
    rank's rows, the ranks averaging through the engine."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    model, step, data = build_lm_step(**RING_HEADLINE, seed=100)
    mesh = model.seq_axis
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    reset_ring_launches()
    losses, step_ms, sync_ms = timed_steps(step, data, warmup, timed)
    torch.cuda.synchronize()
    launched = ring_launches()
    peak = torch.cuda.max_memory_allocated()
    digest = params_digest(model)
    balanced = mesh.flags_balanced()
    del model, step, data, mesh
    torch.cuda.empty_cache()
    rows = RING_HEADLINE["batch"] // n
    avg_losses = ring_averaging_losses(slice(r * rows, (r + 1) * rows))
    rank_result(rank=r, size=n, losses=losses, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms), sync_ms=sync_ms,
                median_sync_ms=statistics.median(sync_ms),
                max_memory_allocated=peak, launches=launched,
                flags_balanced=balanced, digest=digest,
                avg_losses=avg_losses)
    hvdt.shutdown()


def ring_averaging_batch():
    """The averaging check's 4-row batch ``(inputs, targets, mask)`` from
    ``RandomState(AVG_SEED)``: rows 2 and 3 (rank 1's at np 2) hold only
    their first ``RING_AVG_VALID`` targets."""
    vocab, batch, seq = (RING_HEADLINE[k]
                         for k in ("vocab_size", "batch", "seq"))
    tokens = torch.from_numpy(np.random.RandomState(AVG_SEED).randint(
        0, vocab, (batch, seq + 1)))
    mask = torch.ones(batch, seq)
    mask[batch // DP_RANKS:, RING_AVG_VALID:] = 0.0
    return tokens[:, :-1], tokens[:, 1:], mask


def ring_averaging_losses(rows):
    """3 ring steps from ``AVG_SEED`` on rows ``rows`` of the averaging
    batch, the loss normalised over ``("dp", mesh)``.  At size 1 the
    zero-learning-rate step of a data-parallel run's
    ``broadcast_optimizer_state`` is taken here, as in
    ``averaging_losses``."""
    model, step, _ = build_lm_step(**RING_HEADLINE, seed=AVG_SEED)
    if hvd.size() == 1:
        hvdt.broadcast_optimizer_state(step.optimizer, root_rank=0)
    batch = tuple(x[rows].cuda() for x in ring_averaging_batch())
    losses = [step(batch).item() for _ in range(3)]
    del model, step, batch
    torch.cuda.empty_cache()
    return losses


def ring_averaging_reference():
    """``(refs, tolerance)`` of the ring's averaging check: two size-1
    runs on all 4 rows; per step 3x their spread, at least 1e-3 of the
    loss (``train_dp``'s rule)."""
    hvd.init()
    refs = [ring_averaging_losses(slice(None)) for _ in range(2)]
    hvd.shutdown()
    spread = [abs(a - b) for a, b in zip(*refs)]
    return refs, [max(3 * s, 1e-3 * abs(a)) for s, a in zip(spread, refs[0])]


def phase_ring_dp():
    """dp x sp: 2 ranks on this card, each a fused ring of 4 members."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks("ring_dp", timeout=600)
    vocab, batch, seq = (RING_HEADLINE[k]
                         for k in ("vocab_size", "batch", "seq"))
    members, n_layers = RING_HEADLINE["members"], RING_HEADLINE["n_layers"]
    want = ring_want(7, members, n_layers)
    step_ms = max(x["median_step_ms"] for x in res)
    refs, tol = ring_averaging_reference()
    dp = res[0]["avg_losses"]
    off = [abs(a - b) for a, b in zip(dp, refs[0])]
    emit("ring_dp", ranks=DP_RANKS, members=members, batch_per_rank=batch,
         seq=seq, nvidia_smi=smi_line(),
         tokens_per_s=DP_RANKS * batch * seq / (step_ms / 1e3),
         median_step_ms=step_ms,
         median_step_ms_per_rank=[x["median_step_ms"] for x in res],
         median_sync_ms=[x["median_sync_ms"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         launches=[x["launches"] for x in res], want_launches=want,
         flags_balanced=[x["flags_balanced"] for x in res],
         digests=[x["digest"] for x in res], losses=res[0]["losses"],
         averaging={"dp": dp, "per_rank": [x["avg_losses"] for x in res],
                    "size1": refs, "abs_err": off, "tolerance": tol,
                    "valid_targets_rank1_rows": RING_AVG_VALID},
         seconds=time.perf_counter() - t0)
    for x in res:
        if x["launches"] != want:
            fail(f"ring_dp rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if not x["flags_balanced"]:
            fail(f"ring_dp rank {x['rank']}: flags out of balance")
        if x["losses"] != res[0]["losses"] or \
                x["avg_losses"] != res[0]["avg_losses"]:
            fail(f"ring_dp: the ranks' mean losses differ: {res}")
    if len({x["digest"] for x in res}) != 1:
        fail("ring_dp: the ranks' parameters differ after the steps")
    losses = res[0]["losses"]
    if not all(math.isfinite(x) for x in losses + dp):
        fail(f"ring_dp: non-finite loss: {losses}, {dp}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"ring_dp: implausible loss trajectory: {losses}")
    if any(o > t for o, t in zip(off, tol)):
        fail(f"ring_dp: averaged losses {dp} against size-1 {refs[0]}, "
             f"tolerance {tol}")
    return res[0]["launches"]


# --- the timeline and the checkpoints (ROADMAP A.2, A.3) ---

TIMELINE_STEPS = 3
# The timeline and checkpoint ranks meet their output directory here.
SMOKE_DIR_ENV = "CHIP_SMOKE_DIR"


def rank_timeline():
    """One rank of ``timeline``: 3 steps of ``HEADLINE`` with the
    timeline on; the step ms and launches go to this rank's result
    file."""
    hvdt.init(device="cuda:0")
    if not hvd.timeline_enabled():
        fail("timeline: the launcher's --timeline did not reach the rank")
    r = hvdt.rank()
    model, step, data = build_lm_step(**HEADLINE, seed=100)
    torch.cuda.synchronize()
    A.reset_launches()
    step_ms, losses = [], []
    for _ in range(TIMELINE_STEPS):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launched = dict(A.launches)
    hvdt.shutdown()  # flushes and closes the trace
    with open(os.path.join(OUT_DIR, f"timeline_rank{r}.json"), "w") as f:
        json.dump({"rank": r, "step_ms": step_ms, "losses": losses,
                   "launches": launched}, f)


def _trace(path):
    """A timeline file's events (trailing comma, no closing bracket)."""
    with open(path) as f:
        return json.loads(f.read().rstrip().rstrip(",") + "]")


def _covered_ms(spans, lo, hi):
    """Milliseconds of [lo, hi] (us) covered by at least one span."""
    cut = sorted((max(a, lo), min(b, hi)) for a, b in spans
                 if b > lo and a < hi)
    total, end = 0.0, lo
    for a, b in cut:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def hold_trace(events, rank):
    """Hold one rank's trace to the timeline tests' checks; returns, per
    ``TRAIN_STEP`` span, the ms covered by the gradient rows' NEGOTIATE
    and ALLREDUCE spans inside it, and by the ALLREDUCE's activities: the
    ring on the wire and the host copies into and out of the fusion
    buffer."""
    for e in events:
        if not all(k in e for k in ("ph", "ts", "pid", "name")):
            fail(f"timeline rank {rank}: malformed event {e}")
    # Per row, as the timeline tests' validation holds it: the RANK_READY
    # instants on rank 0 carry the announcing rank's own time.
    last = {}
    for e in events:
        if e["ts"] < last.get(e["pid"], 0):
            fail(f"timeline rank {rank}: a timestamp steps back: {e}")
        last[e["pid"]] = e["ts"]
    metas = {e["name"] for e in events if e["ph"] == "M"}
    if not {"hvd_rank", "hvd_clock_sync"} <= metas:
        fail(f"timeline rank {rank}: metadata {metas}")
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    by_row = {}
    for e in events:
        if e["ph"] in ("B", "E"):
            by_row.setdefault(rows[e["pid"]], []).append(e)
    steps = by_row.get("torch.train_step", [])
    if [e["ph"] for e in steps] != ["B", "E"] * TIMELINE_STEPS:
        fail(f"timeline rank {rank}: {len(steps) // 2} TRAIN_STEP spans, "
             f"want {TIMELINE_STEPS}")
    grads = {k: v for k, v in by_row.items()
             if k.startswith("DistributedOptimizer.")}
    if len(grads) != 51:
        fail(f"timeline rank {rank}: {len(grads)} gradient rows, want 51")
    spans = {"NEGOTIATE": [], "ALLREDUCE": [], "RING_ALLREDUCE": [],
             "MEMCPY_IN_FUSION_BUFFER": [], "MEMCPY_OUT_FUSION_BUFFER": []}
    for row, evs in grads.items():
        names = [e["name"] for e in evs]
        if rank == 0 and (names[0] != "NEGOTIATE" or "ALLREDUCE" not in names
                          or next(i for i, e in enumerate(evs)
                                  if e["ph"] == "E")
                          >= names.index("ALLREDUCE")):
            fail(f"timeline rank 0: {row} does not negotiate before its "
                 f"allreduce: {names[:8]}")
        open_ = []
        for e in evs:
            if e["ph"] == "B":
                open_.append(e)
                continue
            if not open_:
                fail(f"timeline rank {rank}: {row} closes an unopened span")
            b = open_.pop()
            if b["name"] in spans:
                spans[b["name"]].append((b["ts"], e["ts"]))
            if b["name"] == "ALLREDUCE" and not (
                    e.get("args", {}).get("bytes", 0) > 0):
                fail(f"timeline rank {rank}: {row}'s ALLREDUCE closes "
                     f"without bytes: {e}")
        if open_:
            fail(f"timeline rank {rank}: {row} leaves spans open")
    return [{k: _covered_ms(v, b["ts"], e["ts"]) for k, v in spans.items()}
            for b, e in zip(steps[::2], steps[1::2])]


def phase_timeline(dp_step_ms):
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tl = tempfile.mkdtemp(prefix="hvdt_timeline_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(DP_RANKS), "--timeline", tl, "--", sys.executable,
             os.path.abspath(__file__), "--rank", "timeline"],
            capture_output=True, text=True, env=env, timeout=300)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "timeline_launcher.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            fail(f"timeline: the job exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        files = sorted(os.listdir(tl))
        if files != [f"rank{r}.json" for r in range(DP_RANKS)]:
            fail(f"timeline: trace files {files}")
        per_step = [hold_trace(_trace(os.path.join(tl, f)), r)
                    for r, f in enumerate(files)]
        merged = os.path.join(tl, "merged.json")
        merge = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "timeline_merge.py"),
             tl, "-o", merged], capture_output=True, text=True, timeout=120)
        if merge.returncode != 0:
            fail(f"timeline: timeline_merge.py exited {merge.returncode}: "
                 f"{merge.stderr[-2000:]}")
        for f in files:
            shutil.copy(os.path.join(tl, f),
                        os.path.join(OUT_DIR, f"timeline_trace_{f}"))
    finally:
        shutil.rmtree(tl, ignore_errors=True)
    res = []
    for r in range(DP_RANKS):
        with open(os.path.join(OUT_DIR, f"timeline_rank{r}.json")) as f:
            res.append(json.load(f))
    want = {"flash_fwd": HEADLINE["n_layers"] * TIMELINE_STEPS,
            "flash_bwd": HEADLINE["n_layers"] * TIMELINE_STEPS,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    emit("timeline", nvidia_smi=smi_line(), ranks=DP_RANKS,
         steps=TIMELINE_STEPS,
         step_ms=[x["step_ms"] for x in res],
         median_step_ms_timeline_on=max(statistics.median(x["step_ms"])
                                        for x in res),
         median_step_ms_train_dp=dp_step_ms,
         negotiate_allreduce_ms_per_step=per_step,
         merge_report=merge.stdout[-1500:],
         launches=[x["launches"] for x in res], want_launches=want,
         losses=res[0]["losses"], seconds=time.perf_counter() - t_phase)
    for x in res:
        if x["launches"] != want:
            fail(f"timeline rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if not all(math.isfinite(v) for v in x["losses"]):
            fail(f"timeline: non-finite loss {x['losses']}")


# --- the metrics registry, the monitor and the postmortem plane ---

METRICS_WARMUP, METRICS_TIMED = 2, 5  # train_dp's steps
METRICS_CRASH_AT = 10  # the crash job's rank 1 dies at step 2's 11th op
METRICS_LOSS_RTOL = 1e-3  # against train_dp's losses, step by step


def free_port_pair(host="127.0.0.1"):
    """A port ``p`` with ``p + 1`` free too: the monitors of the two
    ranks bind ``base + local_rank``."""
    import socket

    for _ in range(100):
        socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM)]
        try:
            socks[0].bind((host, 0))
            base = socks[0].getsockname()[1]
            socks.append(socket.socket(socket.AF_INET, socket.SOCK_STREAM))
            socks[1].bind((host, base + 1))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("metrics: no two consecutive free ports")


def _prom_value(text, sample):
    """The value of the unlabelled sample ``sample`` in Prometheus text."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split()[1])
    return None


def rank_metrics():
    """One rank of ``metrics``: ``train_dp``'s steps, seed and data with
    the registry on, its monitor at the environment's port + local rank,
    its metrics file and postmortem dir.  The ops a step are read from
    the registry after steps 1 and 2; after the timed steps rank 0
    scrapes its ``/metrics`` and ``/cluster`` while both monitors are up
    (an allreduce holds rank 1 until then)."""
    import urllib.request

    from horovod_tpu_torch.common import metrics
    from tools.hvdlint.metrics_check import lint

    hvdt.init(device=DP_DEVICE)
    r = hvdt.rank()
    port = metrics.monitor_port()
    if not metrics.registry.enabled or port is None:
        fail("metrics: HVD_TPU_MONITOR_PORT did not start the monitor")
    model, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
    torch.cuda.synchronize()
    A.reset_launches()
    losses, step_ms, ops = [], [], []
    for i in range(METRICS_WARMUP + METRICS_TIMED):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        dt = (time.perf_counter() - t0) * 1e3
        if i >= METRICS_WARMUP:
            step_ms.append(dt)
        if i < 2:
            ops.append(sum(hvd_common.metrics_snapshot()["ops"]["engine"]
                           .values()))
    torch.cuda.synchronize()
    launched = dict(A.launches)
    scrape = {}
    if r == 0:
        base = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        scrape_ms = (time.perf_counter() - t0) * 1e3
        cluster = json.loads(urllib.request.urlopen(
            base + "/cluster", timeout=30).read().decode())
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "metrics_rank0.prom"), "w") as f:
            f.write(text)
        with open(os.path.join(OUT_DIR, "metrics_cluster.json"), "w") as f:
            json.dump(cluster, f, indent=1)
        scrape = {
            "lint": lint(text), "families": sum(
                line.startswith("# TYPE ") for line in text.splitlines()),
            "scrape_ms": scrape_ms,
            **{k: _prom_value(text, f"hvd_tpu_{k}_count")
               for k in ("step_seconds", "wait_seconds",
                         "negotiation_seconds")},
            "ops_allreduce": next(
                (float(line.split()[1]) for line in text.splitlines()
                 if line.startswith('hvd_tpu_ops_total{plane="engine",'
                                    'op="allreduce"}')), None),
            "cluster": {"launched": cluster["launched"],
                        "live": cluster["live"],
                        "epochs_agree": cluster["membership_epochs_agree"],
                        "links": {k: v["links"] for k, v in
                                  cluster["ranks"].items()}}}
    hvdt.allreduce(torch.zeros(1), name="metrics.scraped")
    snap = hvd_common.metrics_snapshot()
    hist = snap["histograms"]
    rank_result(rank=r, losses=losses, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms), launches=launched,
                ops_after_steps=ops, scrape=scrape,
                wait_ms_median=_hist_median_ms(hist["wait_sec"]),
                negotiation_ms_median=_hist_median_ms(
                    hist["negotiation_sec"]),
                counts={k: hist[k]["count"] for k in (
                    "step_sec", "wait_sec", "negotiation_sec")},
                skew=snap["skew"], stalls=snap["stalls"]["count"],
                links={p: {k: v[k] for k in ("bytes_out", "sends",
                                             "send_us_sum",
                                             "send_us_count")}
                       for p, v in snap["links"]["peers"].items()})
    hvdt.shutdown()


def _hist_median_ms(hist):
    """The median of a fixed-bucket histogram in ms: the upper bound of
    the bucket that holds it (None when empty)."""
    seen = 0
    for bound, n in zip(hist["buckets"] + [math.inf], hist["counts"]):
        seen += n
        if hist["count"] and seen * 2 >= hist["count"]:
            return bound * 1e3
    return None


def rank_metrics_crash():
    """One rank of ``metrics``' crash job: ``train_dp``'s steps until
    the fault injector crashes rank 1 in step 2; rank 0 reports the typed
    error it caught."""
    hvdt.init(device=DP_DEVICE)
    r = hvdt.rank()
    _, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
    done, error = 0, None
    try:
        for _ in range(3):
            step(data).item()
            done += 1
    except hvd_common.HorovodInternalError as exc:
        error = type(exc).__name__
    rank_result(rank=r, steps_done=done, error=error)
    hvdt.shutdown()


def _crash_job(tmp, crash_op, script=__file__):
    """The crash job: 2 ranks, rank 1 crashed at its op ``crash_op`` by
    ``HVD_TPU_FAULT_SPEC``; every rank's dump must land in the
    postmortem dir, render through ``tools/postmortem_dump.py``, and the
    launcher's report must point at rank 1's."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE
    from horovod_tpu_torch.runner import failure_report

    root = os.path.dirname(os.path.abspath(__file__))
    pm = os.path.join(tmp, "pm_crash")
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(HVD_TPU_FAULT_SPEC=f"rank=1:crash@op={crash_op}",
               HVD_TPU_POSTMORTEM_DIR=pm,
               HVD_TPU_METRICS_FILE=os.path.join(tmp, "crash.json"),
               HVD_TPU_COLLECTIVE_TIMEOUT_SEC="120",
               HVD_TPU_KILL_GRACE_SEC="30")
    t0 = time.perf_counter()
    results = run_command(
        [sys.executable, os.path.abspath(script), "--rank",
         "metrics_crash"], DP_RANKS, env=env, timeout=300, capture=True)
    seconds = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for r in results:
        with open(os.path.join(OUT_DIR, f"metrics_crash_rank{r.rank}.log"),
                  "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    codes = {r.rank: r.returncode for r in results}
    if codes != {0: 0, 1: CRASH_EXIT_CODE}:
        fail(f"metrics: crash job exits {codes}:\n" + "\n".join(
            r.stderr[-3000:] for r in results))
    lines = [ln for ln in results[0].stdout.splitlines()
             if ln.startswith("RESULT ")]
    if not lines:
        fail("metrics: the crash job's rank 0 printed no result")
    r0 = json.loads(lines[-1][len("RESULT "):])
    dumps = {}
    for r in range(DP_RANKS):
        path = os.path.join(pm, f"rank-{r}.json")
        if not os.path.exists(path):
            fail(f"metrics: no postmortem dump of rank {r}: "
                 f"{sorted(os.listdir(pm)) if os.path.isdir(pm) else pm}")
        with open(path) as f:
            dumps[r] = json.load(f)
        with open(os.path.join(OUT_DIR, f"metrics_crash_rank-{r}.json"),
                  "w") as f:
            json.dump(dumps[r], f, indent=1)
        if not os.path.exists(os.path.join(tmp, f"crash.json.{r}")):
            fail(f"metrics: the crash job's rank {r} left no metrics file")
    render = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "postmortem_dump.py"),
         pm], capture_output=True, text=True, timeout=120)
    report = failure_report(results, postmortem_dir=pm)
    ring1 = [e for e in dumps[1]["ring"]["engine"]
             if e["event"] == "enqueue"]
    out = {"seconds": seconds, "crash_op": crash_op, "rank0": r0,
           "reasons": {r: d["reason"] for r, d in dumps.items()},
           "abort_codes": {r: d["abort"]["code"] for r, d in dumps.items()},
           "diagnosis": dumps[0]["diagnosis"],
           "pending_rank0": dumps[0]["pending"],
           "rank1_last_enqueue": ring1[-1]["name"] if ring1 else None,
           "render_rc": render.returncode,
           "render_head": render.stdout[:1500],
           "report_tail": report[-800:]}
    if render.returncode != 0 or f"{DP_RANKS} dump(s)" not in render.stdout:
        fail(f"metrics: postmortem_dump.py exited {render.returncode}: "
             f"{render.stdout[-1500:]}{render.stderr[-1500:]}")
    if f"postmortem: {os.path.join(pm, 'rank-1.json')}" not in report:
        fail(f"metrics: the failure report does not point at rank 1's "
             f"dump:\n{report}")
    if (out["reasons"] != {0: "ranks_down", 1: "fault_crash"}
            or r0["steps_done"] != 1 or r0["error"] != "RanksDownError"
            or "rank 1" not in (dumps[0]["diagnosis"] or "")):
        fail(f"metrics: the crash job's dumps do not tell the crash: {out}")
    return out


def phase_metrics(dp_step_ms, dp_res, script=__file__):
    """``metrics``: ``train_dp``'s 2 ranks with the registry on, a
    monitor (scraped by rank 0 during the run), a metrics file and a
    postmortem dir; its step median beside ``train_dp``'s from this run.
    Then the crash job.  Returns the K1 and B2 launches of each rank."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="hvdt_metrics_")
    try:
        mfile = os.path.join(tmp, "metrics.json")
        res = run_ranks("metrics", timeout=300, script=script, env={
            "HVD_TPU_METRICS": "1",
            "HVD_TPU_MONITOR_PORT": str(free_port_pair()),
            "HVD_TPU_METRICS_FILE": mfile,
            "HVD_TPU_POSTMORTEM_DIR": os.path.join(tmp, "pm")})
        files = []
        for r in range(DP_RANKS):
            with open(f"{mfile}.{r}") as f:
                files.append(json.load(f))
        leftover = (sorted(os.listdir(os.path.join(tmp, "pm")))
                    if os.path.isdir(os.path.join(tmp, "pm")) else [])
        ops = res[0]["ops_after_steps"]
        crash = _crash_job(tmp, ops[0] + METRICS_CRASH_AT, script)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = METRICS_WARMUP + METRICS_TIMED
    want = {"flash_fwd": HEADLINE["n_layers"] * steps,
            "flash_bwd": HEADLINE["n_layers"] * steps,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    step_ms = max(x["median_step_ms"] for x in res)
    dp_losses = dp_res[0]["losses"]
    loss_gap = [abs(a - b) / abs(b) for a, b in zip(res[0]["losses"],
                                                     dp_losses)]
    scrape = next(x["scrape"] for x in res if x["rank"] == 0)
    emit("metrics", nvidia_smi=smi_line(), ranks=DP_RANKS, steps=steps,
         median_step_ms_metrics_on=step_ms,
         median_step_ms_train_dp=dp_step_ms,
         ratio=step_ms / dp_step_ms,
         step_ms=[x["step_ms"] for x in res],
         ops_after_steps=[x["ops_after_steps"] for x in res],
         counts=[x["counts"] for x in res],
         wait_ms_median_bucket=[x["wait_ms_median"] for x in res],
         negotiation_ms_median_bucket=[x["negotiation_ms_median"]
                                       for x in res],
         skew=res[0]["skew"], stalls=[x["stalls"] for x in res],
         links=[x["links"] for x in res], scrape=scrape,
         metrics_files=[{"ops": f["ops"]["engine"],
                         "step_sec": f["histograms"]["step_sec"]["count"]}
                        for f in files],
         postmortem_left_by_clean_run=leftover,
         loss_rel_gap_to_train_dp=loss_gap,
         launches=[x["launches"] for x in res], want_launches=want,
         crash=crash, seconds=time.perf_counter() - t_phase)
    per_step = ops[1] - ops[0]
    for x in res:
        if x["launches"] != want:
            fail(f"metrics rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        # Every handle waited counts in wait_sec; negotiation_sec only
        # where the engine negotiated (the steady state replays).
        if x["counts"]["step_sec"] != steps or x["counts"][
                "wait_sec"] < steps * per_step or not x["counts"][
                "negotiation_sec"]:
            fail(f"metrics rank {x['rank']}: histogram counts "
                 f"{x['counts']} for {steps} steps of {per_step} ops")
        if x["ops_after_steps"][1] - x["ops_after_steps"][0] != per_step:
            fail(f"metrics: ops a step differ across ranks: {res}")
        if not all(math.isfinite(v) for v in x["losses"]):
            fail(f"metrics: non-finite loss {x['losses']}")
    if per_step != 52:  # 51 gradients and the loss
        fail(f"metrics: {per_step} collectives a step, want 52")
    if scrape["lint"] or scrape["step_seconds"] != steps or not (
            scrape["wait_seconds"] and scrape["negotiation_seconds"]):
        fail(f"metrics: rank 0's /metrics: {scrape}")
    if (scrape["cluster"]["launched"], scrape["cluster"]["live"]) != (
            DP_RANKS, DP_RANKS) or not scrape["cluster"]["epochs_agree"]:
        fail(f"metrics: /cluster {scrape['cluster']}")
    if any(f["histograms"]["step_sec"]["count"] != steps for f in files):
        fail("metrics: a metrics file does not count the steps")
    if leftover:
        fail(f"metrics: a clean run left postmortem dumps {leftover}")
    if max(loss_gap) > METRICS_LOSS_RTOL:
        fail(f"metrics: losses {res[0]['losses']} against train_dp's "
             f"{dp_losses}")
    return [x["launches"] for x in sorted(res, key=lambda x: x["rank"])]


def state_digest(tree):
    """One digest of a state tree's structure, scalars and tensor bytes."""
    from horovod_tpu_torch.state import flatten_tree

    leaves, rebuild = flatten_tree(tree)
    h = hashlib.sha256(repr(rebuild(list(range(len(leaves))))).encode())
    for x in leaves:
        if torch.is_tensor(x):
            t = x.detach().contiguous().cpu()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())
        else:
            h.update(repr(x).encode())
    return h.hexdigest()


CKPT_STEPS = (2, 3)  # the steps saved at
CKPT_MORE = 2  # steps taken from the live and from the restored state
CKPT_LOSS_RTOL = 1e-3  # train_dp's floor


def rank_checkpoint():
    """One rank of ``checkpoint``: train, save twice, restore into a
    fresh model collectively, hold the restored state bit-equal, step
    both.  Rank 0 also leaves its live ``state_dict`` for the parent."""
    from horovod_tpu_torch.torch import train as T

    hvdt.init(device="cuda:0")
    r = hvdt.rank()
    d = os.environ[SMOKE_DIR_ENV]
    model, step, data = build_lm_step(**HEADLINE, seed=100)
    A.reset_launches()
    losses, save_ms, shard_bytes = [], [], []
    for n in range(1, CKPT_STEPS[-1] + 1):
        losses.append(step(data).item())
        if n in CKPT_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = T.save_checkpoint(
                os.path.join(d, "ckpt"), n,
                {"model": model.state_dict(),
                 "optimizer": step.optimizer.state_dict(), "step": n},
                sharded=True, keep=2)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            shard_bytes.append(os.path.getsize(
                os.path.join(path, f"rank-{r}.pkl")))
    live = (params_digest(model), state_digest(step.optimizer.state_dict()))
    if r == 0:
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, os.path.join(d, "live.pt"))
    fresh, fresh_step, _ = build_lm_step(**HEADLINE, seed=200)
    if params_digest(fresh) == live[0]:
        fail("checkpoint: the fresh model starts equal to the live one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at, tree = T.load_latest_checkpoint(os.path.join(d, "ckpt"),
                                        device="cuda:0")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    fresh.load_state_dict(tree["model"])
    fresh_step.optimizer.load_state_dict(tree["optimizer"])
    restored = (params_digest(fresh),
                state_digest(fresh_step.optimizer.state_dict()))
    del tree
    more_live = [step(data).item() for _ in range(CKPT_MORE)]
    more_restored = [fresh_step(data).item() for _ in range(CKPT_MORE)]
    launched = dict(A.launches)
    kept = sorted(os.listdir(os.path.join(d, "ckpt")))
    hvdt.shutdown()
    rank_result(rank=r, losses=losses, save_ms=save_ms,
                shard_bytes=shard_bytes, load_ms=load_ms, loaded_step=at,
                live=live, restored=restored, more_live=more_live,
                more_restored=more_restored, launches=launched, kept=kept)


def serve_tokens(spec, params, traffic):
    """``traffic``'s tokens served at size 1 through ``ServingEngine`` on
    ``params`` (all submitted before the loop starts)."""
    cfg = SERVE_HEADLINE["cfg"]
    sch = Scheduler(cfg)
    engine = SE.ServingEngine(spec, cfg, params, sch)
    reqs = [sch.submit(*t) for t in traffic]
    loop = threading.Thread(target=engine.run, daemon=True)
    loop.start()
    for q in reqs:
        if not q.event.wait(600) or q.error is not None:
            fail(f"checkpoint: request {q.id} did not complete: {q.error}")
    engine.request_stop()
    loop.join(60)
    del engine
    torch.cuda.empty_cache()
    return [q.generated for q in reqs]


def phase_checkpoint():
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="hvdt_ckpt_")
    os.environ[SMOKE_DIR_ENV] = d
    try:
        res = run_ranks("checkpoint", timeout=300)
        f32 = dataclasses.replace(SERVE_HEADLINE["spec"], dtype="float32",
                                  ckpt=os.path.join(d, "ckpt"))
        traffic = serve_traffic()[:4]
        hvd.init()
        from_ckpt = serve_tokens(f32, SE.init_params(f32), traffic)
        live = {k: v.float() for k, v in torch.load(
            os.path.join(d, "live.pt")).items()}
        from_live = serve_tokens(dataclasses.replace(f32, ckpt=""), live,
                                 traffic)
        hvd.shutdown()
    finally:
        del os.environ[SMOKE_DIR_ENV]
        shutil.rmtree(d, ignore_errors=True)
    per = HEADLINE["n_layers"] * (CKPT_STEPS[-1] + 2 * CKPT_MORE)
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    gaps = [abs(a - b) / abs(a) for x in res
            for a, b in zip(x["more_live"], x["more_restored"])]
    emit("checkpoint", nvidia_smi=smi_line(), ranks=DP_RANKS,
         saved_at=list(CKPT_STEPS),
         save_ms=[x["save_ms"] for x in res],
         shard_bytes=[x["shard_bytes"] for x in res],
         load_ms=[x["load_ms"] for x in res],
         kept=res[0]["kept"], loaded_step=res[0]["loaded_step"],
         digests_equal=[x["live"] == x["restored"] for x in res],
         losses=res[0]["losses"], more_live=res[0]["more_live"],
         more_restored=res[0]["more_restored"], loss_rel_gap=gaps,
         loss_rtol=CKPT_LOSS_RTOL, launches=[x["launches"] for x in res],
         want_launches=want, served_tokens_equal=from_ckpt == from_live,
         served_tokens=[len(t) for t in from_ckpt],
         seconds=time.perf_counter() - t_phase)
    for x in res:
        if x["live"] != x["restored"]:
            fail(f"checkpoint rank {x['rank']}: restored state differs "
                 f"from the live one: {x['live']} {x['restored']}")
        if x["launches"] != want:
            fail(f"checkpoint rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if x["loaded_step"] != CKPT_STEPS[-1] or x["kept"] != [
                f"ckpt-{s:08d}" for s in CKPT_STEPS]:
            fail(f"checkpoint: loaded step {x['loaded_step']}, kept "
                 f"{x['kept']}")
    if max(gaps) > CKPT_LOSS_RTOL or not all(
            math.isfinite(v) for v in res[0]["more_live"]):
        fail(f"checkpoint: losses after the restore {res[0]}")
    if from_ckpt != from_live:
        fail(f"checkpoint: tokens served from the checkpoint {from_ckpt} "
             f"differ from the live parameters' {from_live}")


# --- the elastic phase: a rank lost mid-training (ROADMAP A.5.1) ---

ELASTIC_RANKS = 4
ELASTIC_MIN_NP = 2
ELASTIC_STEPS = 8
ELASTIC_LOST = 2  # the launch slot that crashes
ELASTIC_CRASH_STEP = 4  # the step in whose backward it crashes (1-based)
# Where the job and its ranks run: several ranks share this card.
ELASTIC_DEVICE = "cuda:0"


def elastic_ops(cfg):
    """``(collectives before the first step, collectives a step, trained
    parameters)`` of one rank of ``rank_elastic`` on the LM ``cfg``, in
    the order the fault injector counts them, from the structure alone
    (a copy of the model at ``cfg``'s depth and tiny widths on the CPU,
    its AdamW stepped once, so the optimizer's own ``state_dict`` keys
    of this PyTorch count): ``build_lm_step``'s broadcasts of every
    ``state_dict`` entry and of every tensor and scalar of the optimizer
    state; ``run_elastic``'s entry (the state plane's holdings and
    endpoint allgathers, then one broadcast per leaf of the state); then
    per step one allreduce per parameter and the loss's."""
    from horovod_tpu_torch.state import flatten_tree

    tiny = TransformerLM(vocab_size=64, d_model=cfg["n_heads"] * 4,
                         n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                         d_ff=32, dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    params = [p for p in tiny.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)
    for p in params:
        p.grad = torch.zeros_like(p)
    opt.step()
    sd, osd = tiny.state_dict(), opt.state_dict()

    def sent(v):
        return torch.is_tensor(v) or isinstance(v, (bool, int, float))

    opt_bcast = sum(sent(v) for st in osd["state"].values()
                    for v in st.values())
    opt_bcast += sum(sent(v) for g in osd["param_groups"]
                     for k, v in g.items() if k != "params")
    leaves = (len(flatten_tree(sd)[0]) + len(flatten_tree(osd)[0])
              + 1)  # the step counter
    before = (sum(v is not None for v in sd.values()) + opt_bcast + 2
              + leaves)
    return before, len(params) + 1, len(params)


def device_digest(tree):
    """One digest of a state tree, computed where its tensors live: per
    tensor its dtype, shape and three integer sums of its bit patterns
    (plain, position-weighted twice), wrapping in int64, so order-free
    and exact."""
    from horovod_tpu_torch.state import flatten_tree

    leaves, _ = flatten_tree(tree)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha256()
    for x in leaves:
        if not torch.is_tensor(x):
            h.update(repr(x).encode())
            continue
        t = x.detach().contiguous().reshape(-1)
        bits = t.view(ints[t.element_size()]).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device,
                         dtype=torch.int64)
        sums = torch.stack([bits.sum(), (bits * w).sum(),
                            (bits * (w % 65521)).sum()]).tolist()
        h.update(f"{t.dtype}{tuple(x.shape)}{sums}".encode())
    return h.hexdigest()


def rank_elastic():
    """One rank of ``elastic``: ``HEADLINE`` under ``run_elastic`` with
    the state plane armed and a snapshot every step; its record of every
    step, the digests of its live state, and the plane's times."""
    hvdt.init(device=ELASTIC_DEVICE)
    dev = torch.device(ELASTIC_DEVICE)
    slot = int(os.environ["HVD_TPU_DEVICE_SLOT"])
    model, step, data = build_lm_step(**HEADLINE, seed=100,
                                      device=ELASTIC_DEVICE)
    opt = step.optimizer
    plane = hvdt.state.arm()
    state = hvdt.ElasticState(model=model.state_dict(),
                              opt=opt.state_dict(), step=0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    A.reset_launches()

    def digest():
        return device_digest({"model": model.state_dict(),
                              "opt": opt.state_dict()})

    rec = {"slot": slot, "entries": [], "steps": [], "digests": {},
           "fail_t": None}

    def train(state):
        epoch = hvdt.membership_epoch()
        rec["entries"].append({"epoch": epoch, "step": state.step,
                               "size": hvdt.size(), "digest": digest(),
                               "t": time.time()})
        while state.step < ELASTIC_STEPS:
            # The fault injector's count (it counts on the rank it arms).
            print("SEQ", state.step + 1, hvd_common._collective_seq,
                  json.dumps(A.launches), flush=True)
            t0 = time.perf_counter()
            try:
                loss = step(data).item()
            except hvdt.HorovodInternalError:
                rec["fail_t"] = time.time()
                raise
            state.step += 1
            rec["steps"].append({
                "epoch": epoch, "step": state.step, "size": hvdt.size(),
                "ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                "t": time.time()})
            rec["digests"][f"{epoch}.{state.step}"] = digest()
            plane.snapshot(state)
        return digest()

    final = hvdt.run_elastic(train, state)
    plane.wait(120.0)
    snap = hvd_common.metrics_snapshot()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    rank_result(rank=hvdt.rank(), size=hvdt.size(), final=final,
                membership=snap["membership"], state=snap["state"],
                last_restore=plane.last_restore,
                restore_ms=[x * 1e3 for x in plane.restore_sec],
                capture_ms=[x * 1e3 for x in plane.capture_sec],
                write_ms=[x * 1e3 for x in plane._snapshotter.write_sec],
                launches=dict(A.launches), max_memory_allocated=peak, **rec)
    hvdt.shutdown()


def phase_elastic(script=__file__):
    """``elastic``: 4 ranks on this card under ``run_membership``, rank 2
    crashed by ``HVD_TPU_FAULT_SPEC`` in the backward of step 4 of 8;
    the survivors reshape to 3, restore from the state plane's snapshots
    and peer copies in place, and train on.  Returns the K1 and B2
    launches of every rank."""
    from horovod_tpu_torch.common.faults import CRASH_EXIT_CODE
    from horovod_tpu_torch.runner import membership_succeeded, run_membership

    t_phase = time.perf_counter()
    before, per_step, n_params = elastic_ops(HEADLINE)
    seq_crash = before + (ELASTIC_CRASH_STEP - 1) * per_step
    crash_op = seq_crash + n_params // 2  # mid-backward: handles in flight
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(HVD_TPU_FAULT_SPEC=f"rank={ELASTIC_LOST}:crash@op={crash_op}",
               HVD_TPU_COLLECTIVE_TIMEOUT_SEC="120",
               HVD_TPU_KILL_GRACE_SEC="30")
    events = []
    results = run_membership(
        [sys.executable, os.path.abspath(script), "--rank", "elastic"],
        ELASTIC_RANKS, min_np=ELASTIC_MIN_NP, max_np=ELASTIC_RANKS,
        max_rejoins=0, env=env, timeout=900, capture=True,
        report=lambda msg: events.append((time.time(), msg)))
    os.makedirs(OUT_DIR, exist_ok=True)
    for r in results:
        with open(os.path.join(OUT_DIR, f"elastic_rank{r.rank}.log"),
                  "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    lost = results[ELASTIC_LOST]
    if lost.returncode != CRASH_EXIT_CODE or not membership_succeeded(
            results, ELASTIC_MIN_NP) or any(
            r.returncode != 0 for r in results if r.rank != ELASTIC_LOST):
        fail("elastic: exits " + ", ".join(
            f"slot {r.rank}: {r.returncode}" for r in results)
            + "\n" + "\n".join(r.stderr[-3000:] for r in results
                                if r.returncode != 0))
    seqs = {}
    for line in lost.stdout.splitlines():
        if line.startswith("SEQ "):
            _, n, seq, launched = line.split(" ", 3)
            seqs[int(n)] = (int(seq), json.loads(launched))
    fired = [ln for ln in lost.stderr.splitlines() if "FAULT INJECTION" in ln]
    res = []
    for r in results:
        if r.rank != ELASTIC_LOST:
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if not lines:
                fail(f"elastic: slot {r.rank} printed no result")
            res.append(json.loads(lines[-1][len("RESULT "):]))
    res.sort(key=lambda x: x["rank"])
    crash_t = next((t for t, m in events
                    if f"rank {ELASTIC_LOST} exited" in m), None)
    x0 = res[0]
    fence = x0["last_restore"]["fence_step"] if x0["last_restore"] else None
    first_after = [min((s["t"] for s in x["steps"] if s["epoch"] == 1),
                       default=None) for x in res]
    step_ms = {e: [statistics.median([s["ms"] for s in x["steps"]
                                      if s["epoch"] == e][1:] or [0.0])
                   for x in res] for e in (0, 1)}
    per_rank = {x["slot"]: x["launches"] for x in res}
    per_rank[ELASTIC_LOST] = seqs[max(seqs)][1] if seqs else {}
    emit("elastic", nvidia_smi=smi_line(), ranks=ELASTIC_RANKS,
         min_np=ELASTIC_MIN_NP, steps=ELASTIC_STEPS,
         fault_spec=env["HVD_TPU_FAULT_SPEC"],
         ops_before_first_step=before, ops_per_step=per_step,
         lost_rank_seq={n: v[0] for n, v in sorted(seqs.items())},
         fired=fired, exits={r.rank: r.returncode for r in results},
         sizes=[x["size"] for x in res],
         dense_ranks=[x["rank"] for x in res],
         membership=[x["membership"] for x in res],
         peer_restores=[x["state"]["peer_restores"] for x in res],
         root_broadcast_fallbacks=[x["state"]["root_broadcast_fallbacks"]
                                   for x in res],
         fence_step=fence, last_restore=[x["last_restore"] for x in res],
         restore_ms=[x["restore_ms"] for x in res],
         capture_ms=[x["capture_ms"] for x in res],
         write_ms=[x["write_ms"] for x in res],
         shard_bytes=[x["state"]["snapshot_bytes"]
                      // max(x["state"]["snapshots"], 1) for x in res],
         crash_to_first_step_ms=[(t - crash_t) * 1e3
                                 if t and crash_t else None
                                 for t in first_after],
         detect_to_first_step_ms=[(t - x["fail_t"]) * 1e3
                                  if t and x["fail_t"] else None
                                  for t, x in zip(first_after, res)],
         step_ms_before=step_ms[0], step_ms_after=step_ms[1],
         losses=[[s["loss"] for s in x["steps"]] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         launches=per_rank, seconds=time.perf_counter() - t_phase)
    s0, s1 = seqs.get(ELASTIC_CRASH_STEP), seqs.get(ELASTIC_CRASH_STEP + 1)
    if (s0 is None or s0[0] != seq_crash or s1 is not None
            or len(fired) != 1 or "DistributedOptimizer." not in fired[0]):
        fail(f"elastic: the crash did not land in the backward of step "
             f"{ELASTIC_CRASH_STEP} (op {crash_op}; the lost rank's "
             f"counts {seqs}, {fired})")
    want_lost = [ELASTIC_LOST]
    for x in res:
        m = x["membership"]
        if (x["size"], m["epoch"], m["size"], m["ranks_lost"]) != (
                ELASTIC_RANKS - 1, 1, ELASTIC_RANKS - 1, want_lost):
            fail(f"elastic rank {x['rank']}: membership {m}, size "
                 f"{x['size']}")
        st = x["state"]
        if st["peer_restores"] < 1 or st["root_broadcast_fallbacks"]:
            fail(f"elastic rank {x['rank']}: state {st}")
        if x["last_restore"] != x0["last_restore"]:
            fail(f"elastic: restores differ {x['last_restore']} "
                 f"{x0['last_restore']}")
        entries = x["entries"]
        if [(e["epoch"], e["step"]) for e in entries] != [(0, 0),
                                                          (1, fence)]:
            fail(f"elastic rank {x['rank']}: entries {entries}")
        for s in x["steps"]:
            if not math.isfinite(s["loss"]):
                fail(f"elastic rank {x['rank']}: loss {s}")
        for name in ("flash_fwd", "flash_bwd"):
            if not x["launches"][name]:
                fail(f"elastic rank {x['rank']}: {name} never launched")
    if sorted(x["rank"] for x in res) != list(range(ELASTIC_RANKS - 1)):
        fail(f"elastic: ranks {[x['rank'] for x in res]}")
    if fence not in (ELASTIC_CRASH_STEP - 2, ELASTIC_CRASH_STEP - 1):
        fail(f"elastic: fence step {fence}")
    before_fence = x0["digests"].get(f"0.{fence - 1}",
                                     x0["entries"][0]["digest"])
    for x in res:
        restored = x["entries"][1]["digest"]
        if restored != x0["digests"][f"0.{fence}"] or \
                restored == before_fence:
            fail(f"elastic rank {x['rank']}: the restored state is not "
                 f"rank 0's at the fence step {fence}")
    if len({x["final"] for x in res}) != 1:
        fail("elastic: the survivors' final states differ")
    if not all(seqs[max(seqs)][1].get(k) for k in ("flash_fwd",
                                                   "flash_bwd")):
        fail(f"elastic: the lost rank launched {seqs[max(seqs)][1]}")
    return per_rank


# --- the two-level topology and the network fault injector ---

TOPO_RANKS = 4
TOPO_NODE = 2  # ranks a node: 2 nodes x 2 faked on this host
TOPO_WARMUP, TOPO_TIMED = 1, 3
TOPO_RUNS = {
    # (a) the two-level allreduce, the coordinator tree, and the node-local
    # hops on shared memory; force makes a fall-back to TCP an init error.
    "two_level_shm": {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                      "HVD_TPU_COORD_TREE": "1", "HVD_TPU_SHM": "force"},
    # (b) the same on TCP.
    "two_level_tcp": {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                      "HVD_TPU_COORD_TREE": "1", "HVD_TPU_SHM": "0"},
    # (c) the flat ring at 4 ranks.
    "flat": {},
}
# The runs in turns, so that no configuration has the job's start to
# itself (a, b, c, c, b, a).
TOPO_TURNS = tuple(TOPO_RUNS) + tuple(reversed(TOPO_RUNS))
PROBE_SEED = 13
CHAOS_RANKS = 2
CHAOS_PARTITION_RANKS = 4
CHAOS_DELAY_MS = 5
CHAOS_SPECS = {"flaky": "link=0-1:flaky=0.05",
               "delay": f"link=0-1:delay={CHAOS_DELAY_MS}",
               "partition": "partition=0,1/2,3@after=4"}
CHAOS_ENV = {"HVD_TPU_HEARTBEAT_MS": "100", "HVD_TPU_HEARTBEAT_MISS": "10",
             "HVD_TPU_COLLECTIVE_TIMEOUT_SEC": "30",
             "HVD_TPU_KILL_GRACE_SEC": "10"}
CHAOS_PARTITION_SEC = 15.0  # the reference's bound, from the loop's start


def probe_inputs(shapes, rank):
    """The allreduce probe's inputs on ``rank``: one float32 array per
    parameter (``shapes``: ``[name, shape]``), small integers from
    ``RandomState(PROBE_SEED + rank)``, whose sums and averages over 2 or
    4 ranks are exact in any order."""
    rng = np.random.RandomState(PROBE_SEED + rank)
    return [(n, rng.randint(-64, 64, tuple(s), dtype=np.int8).astype(
        np.float32)) for n, s in shapes]


def probe_digest(named):
    h = hashlib.sha256()
    for n, a in named:
        h.update(n.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def probe_want(shapes, ranks):
    """The digest of the exact average of every rank's probe."""
    total = [np.zeros(tuple(s), np.float32) for _, s in shapes]
    for r in range(ranks):
        for t, (_, a) in zip(total, probe_inputs(shapes, r)):
            t += a
    return probe_digest([(n, t / np.float32(ranks))
                         for (n, _), t in zip(shapes, total)])


def run_probe(model):
    """Average this rank's probe through the engine from tensors on the
    card, one named handle per parameter as the optimizer enqueues its
    gradients (staged, fused): ``(digest, ms, shapes)``."""
    shapes = [[n, list(p.shape)] for n, p in model.named_parameters()]
    ins = [(n, torch.from_numpy(a).to(DP_DEVICE))
           for n, a in probe_inputs(shapes, hvdt.rank())]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [(n, hvdt.allreduce_async(t, average=True, name=f"probe.{n}"))
               for n, t in ins]
    outs = [(n, hvdt.synchronize(h).cpu().numpy()) for n, h in handles]
    ms = (time.perf_counter() - t0) * 1e3
    return probe_digest(outs), ms, shapes


LINK_COUNTS = ("bytes_out", "send_us_sum", "send_us_count", "stalls",
               "short_writes", "shm_bytes_out", "shm_bytes_in",
               "shm_handoffs", "shm_us_sum", "shm_us_count")


def link_counts():
    """This rank's per-peer link counters (cumulative over the process:
    the engine keeps them across a re-init)."""
    return {p: {k: v[k] for k in LINK_COUNTS}
            for p, v in hvd.metrics_snapshot()["links"]["peers"].items()}


def engine_sections(links_before):
    """This rank's ``topology``, ``control``, ``links`` (each peer's
    transport, which the engine keeps from the last run that armed the
    rings, and its counters since ``links_before``), ``faults``,
    ``liveness`` and ``anomalies`` sections, and the medians of the
    ``topology_*_sec`` histograms (a bucket each: the upper bound of the
    histogram bucket that holds it)."""
    snap = hvd.metrics_snapshot()
    ctrl = snap["control"]
    links = {p: {"transport": v["transport"],
                 **{k: v[k] - links_before.get(p, {}).get(k, 0)
                    for k in LINK_COUNTS}}
             for p, v in snap["links"]["peers"].items()}
    an = snap["anomalies"]
    hists = snap["histograms"]
    return {"topology": snap["topology"],
            "bucket_medians_ms": {
                name: _hist_median_ms(hists[f"topology_{name}_sec"])
                for name in ("local_rs", "cross", "local_ag")},
            "control": {k: ctrl[k] for k in ("tree", "depth", "hosts",
                                             "children")},
            "links": links, "faults": snap["faults"]["injected"],
            "evictions": snap["liveness"]["evictions"],
            "anomalies": {"verdicts": an["verdicts"], "log": an["log"]}}


def dp_run(warmup, timed, start=None):
    """``train_dp``'s model, seed and data on this rank: ``warmup`` +
    ``timed`` steps with the launch counters zeroed just before, the
    engine's per-bucket phase times (local reduce-scatter, cross, local
    allgather) summed over each timed step, the parameters' digest, the
    probe, and the engine's sections.  ``start``, a ``StartState`` of an
    earlier run in this process, is put back in place of a new build."""
    lib = hvd_common._load_lib()

    def logged():
        return int(lib.hvd_tpu_topology_info().decode().split("|")[8])

    hvd.metrics_reset()  # the histograms of this run alone
    links_before = link_counts()
    t_start = time.perf_counter()
    if start is None:
        model, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
    else:
        model, step, data = start.restored()
    torch.cuda.synchronize()
    t_build = time.perf_counter()
    A.reset_launches()
    losses, step_ms, sync_ms, totals = [], [], [], [logged()]
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        dt = (time.perf_counter() - t0) * 1e3
        totals.append(logged())
        if i >= warmup:
            step_ms.append(dt)
            sync_ms.append(step.sync_sec[-1] * 1e3)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    log = [e.split("|") for e in
           lib.hvd_tpu_topology_log().decode().split(";") if e]
    phases = []  # [rs, cross, ag] ms a timed step
    for lo, hi in zip(totals[warmup:-1], totals[warmup + 1:]):
        back_lo, back_hi = totals[-1] - lo, totals[-1] - hi
        if back_lo > len(log):
            break
        sel = log[len(log) - back_lo:len(log) - back_hi]
        phases.append([sum(int(e[k]) for e in sel) / 1e3 for k in (2, 3, 4)])
    t_steps = time.perf_counter()
    digest = params_digest(model)
    probe, probe_ms, shapes = run_probe(model)
    seconds = {"build": t_build - t_start, "steps": t_steps - t_build,
               "digest_and_probe": time.perf_counter() - t_steps}
    return dict(rank=hvdt.rank(), size=hvdt.size(), losses=losses,
                seconds=seconds,
                step_ms=step_ms, median_step_ms=statistics.median(step_ms),
                sync_ms=sync_ms, median_sync_ms=statistics.median(sync_ms),
                phases_ms=phases, launches=launched, digest=digest,
                probe=probe, probe_ms=probe_ms, shapes=shapes,
                **engine_sections(links_before))


class StartState:
    """A built step and its parameters and optimizer state as they were
    built, put back before each later run: the same seed's start without
    building and broadcasting anew."""

    def __init__(self):
        self.model, self.step, self.data = build_lm_step(
            DP_DEVICE, **HEADLINE, seed=100)
        self.params = copy.deepcopy(self.model.state_dict())
        self.opt = copy.deepcopy(self.step.optimizer.state_dict())

    def restored(self):
        self.model.load_state_dict(self.params)
        # The optimizer keeps the tensors it is given: a copy each time.
        self.step.optimizer.load_state_dict(copy.deepcopy(self.opt))
        return self.model, self.step, self.data


def rank_topology():
    """One rank of ``topology``: ``train_dp``'s step at ``TOPO_RANKS``
    ranks in each of ``TOPO_TURNS``, the engine started afresh for each
    with its run's knobs; on nodes of ``TOPO_NODE`` where a run asks for
    the two-level allreduce (the reference's recipe: the launcher's local
    rank and size re-shaped before ``init()``)."""
    r = int(os.environ["HVD_TPU_RANK"])
    launched = {k: os.environ[k] for k in ("HVD_TPU_LOCAL_RANK",
                                           "HVD_TPU_LOCAL_SIZE")}
    out, start = [], None
    for tag in TOPO_TURNS:
        knobs = TOPO_RUNS[tag]
        for run in TOPO_RUNS.values():
            for k in run:
                os.environ.pop(k, None)
        os.environ.update(launched, **knobs)
        if knobs.get("HOROVOD_HIERARCHICAL_ALLREDUCE"):
            os.environ["HVD_TPU_LOCAL_SIZE"] = str(TOPO_NODE)
            os.environ["HVD_TPU_LOCAL_RANK"] = str(r % TOPO_NODE)
        t0 = time.perf_counter()
        hvdt.init(device=DP_DEVICE)
        if start is None:
            start = StartState()
        res = dp_run(TOPO_WARMUP, TOPO_TIMED, start)
        hvdt.shutdown()
        res["seconds"]["turn"] = time.perf_counter() - t0
        out.append(res)
    rank_result(rank=r, turns=out)


def rank_chaos():
    """One rank of ``chaos``' training jobs: ``train_dp``'s step under the
    launcher's ``--net-fault-spec``; the result goes to this rank's file
    (the CLI launcher does not capture the ranks' output)."""
    spec = os.environ["HVD_TPU_NET_FAULT_SPEC"]
    tag = next(k for k, v in CHAOS_SPECS.items() if v == spec)
    hvdt.init(device=DP_DEVICE)
    res = dp_run(TOPO_WARMUP, TOPO_TIMED)
    hvdt.shutdown()
    with open(os.path.join(os.environ[SMOKE_DIR_ENV],
                           f"chaos_{tag}_rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)


def rank_chaos_partition():
    """One rank of ``chaos``' partition job: small allreduces of tensors
    on the card until the cut; the typed error, whom it names and when.
    Exits 7 on the typed error (the reference's test's code), 9 if the
    job trained through the cut."""
    hvdt.init(device=DP_DEVICE)
    r = hvdt.rank()
    far = {2, 3} if r in (0, 1) else {0, 1}
    x = torch.ones(8, device=DP_DEVICE)
    out = {"rank": r, "error": None}
    t0 = time.monotonic()
    try:
        for i in range(400):
            hvdt.allreduce(x, name=f"p.{i}")
            time.sleep(0.02)
    except hvd.RanksDownError as e:
        out.update(error=type(e).__name__, ranks=sorted(e.ranks),
                   far_only=bool(e.ranks) and set(e.ranks) <= far,
                   seconds=time.monotonic() - t0, message=str(e)[:400])
    with open(os.path.join(os.environ[SMOKE_DIR_ENV],
                           f"chaos_partition_rank{r}.json"), "w") as f:
        json.dump(out, f)
    os._exit(7 if out["error"] else 9)


def size1_tolerance(steps):
    """``train_dp``'s rule for ``steps`` losses of its step: two size-1
    runs of the step (seed and data of rank 0); per step 3 x their spread
    (B2's dQ adds are not ordered), at least 1e-3 of the loss."""
    hvd.init(device=DP_DEVICE)
    runs = []
    for _ in range(2):
        _, step, data = build_lm_step(DP_DEVICE, **HEADLINE, seed=100)
        runs.append([step(data).item() for _ in range(steps)])
        del step, data
        torch.cuda.empty_cache()
    hvd.shutdown()
    return runs, [max(3 * abs(a - b), 1e-3 * abs(a)) for a, b in zip(*runs)]


def _median(xs):
    return statistics.median(xs) if xs else None


def topology_runs(want_launch, script=__file__):
    """The ``topology`` job: ``{run: [each turn's ranks' results]}``,
    gated within each turn."""
    res = run_ranks("topology", timeout=300, ranks=TOPO_RANKS, script=script)
    runs = {tag: [] for tag in TOPO_RUNS}
    for i, tag in enumerate(TOPO_TURNS):
        xs = [x["turns"][i] for x in res]
        runs[tag].append(xs)
        for x in xs:
            if x["launches"] != want_launch:
                fail(f"topology {tag} rank {x['rank']} launched "
                     f"{x['launches']}, want {want_launch}")
            if x["losses"] != xs[0]["losses"] or not all(
                    math.isfinite(v) for v in x["losses"]):
                fail(f"topology {tag}: losses {[y['losses'] for y in xs]}")
        for key in ("digest", "probe"):
            if len({x[key] for x in xs}) != 1:
                fail(f"topology {tag}: the ranks' {key}s differ")
    return runs


def _run_summary(turns):
    """What a run prints over its turns: the slower rank's step median
    and each rank's ``synchronize`` median (over both turns' timed
    steps), the phase medians a step, each turn's steps, probe ms and
    losses, rank 0's shm traffic, launches."""
    ranks = range(len(turns[0]))
    x0 = turns[-1][0]  # rank 0, whose node-local peer is rank 1
    phases = [p for xs in turns for x in xs for p in x["phases_ms"]]
    return {
        "median_step_ms": max(statistics.median(
            [v for xs in turns for v in xs[r]["step_ms"]]) for r in ranks),
        "median_sync_ms": [statistics.median(
            [v for xs in turns for v in xs[r]["sync_ms"]]) for r in ranks],
        "phase_medians_ms": {
            name: _median([p[k] for p in phases])
            for k, name in enumerate(("local_rs", "cross", "local_ag"))},
        "turns": [{"step_ms": [x["step_ms"] for x in xs],
                   "probe_ms": [x["probe_ms"] for x in xs],
                   "losses": xs[0]["losses"], "seconds": xs[0]["seconds"]}
                  for xs in turns],
        "topology": x0["topology"], "control": x0["control"],
        "rank0_bucket_medians_ms": x0["bucket_medians_ms"],
        "rank0_local_peer_link": (x0["links"].get("1")
                                  if x0["topology"]["hierarchical"]
                                  else None),
        "launches": [x["launches"] for x in turns[0]]}


def phase_topology(script=__file__):
    """``topology``: 4 ranks of ``train_dp``'s step on this card, three
    runs from the same seed, in turns (a, b, c, c, b, a): (a) two-level on
    2 nodes x 2 with the coordinator tree and the node-local hops on
    shared memory (``HVD_TPU_SHM=force``), (b) the same on TCP, (c) the
    flat ring.  Returns the K1 and B2 launches of (a)'s first turn's
    ranks and ``train_dp``'s rule for 4 steps."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    steps = TOPO_WARMUP + TOPO_TIMED
    per = HEADLINE["n_layers"] * steps
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    runs = topology_runs(want, script)
    t_job = time.perf_counter()
    probe = probe_want(runs["flat"][0][0]["shapes"], TOPO_RANKS)
    for tag, turns in runs.items():
        if any(xs[0]["probe"] != probe for xs in turns):
            fail(f"topology {tag}: the probe's average is not the exact one")
    t_probe = time.perf_counter()
    size1, tol = size1_tolerance(steps)
    seconds = {"job": t_job - t_phase, "probe_want": t_probe - t_job,
               "size1": time.perf_counter() - t_probe}
    a, b, c = (runs[t] for t in TOPO_RUNS)
    off = [[abs(x - y) for x, y in zip(ai[0]["losses"], ci[0]["losses"])]
           for ai, ci in zip(a, c)]
    emit("topology", nvidia_smi=smi_line(), ranks=TOPO_RANKS,
         nodes=TOPO_RANKS // TOPO_NODE, warmup=TOPO_WARMUP, timed=TOPO_TIMED,
         batch_per_rank=HEADLINE["batch"], seq=HEADLINE["seq"],
         runs={t: _run_summary(r) for t, r in runs.items()},
         turns=TOPO_TURNS,
         probe_bytes=4 * sum(math.prod(s) for _, s in a[0][0]["shapes"]),
         probe_equal_exact=True,
         param_digests_equal_across_runs={
             "two_level_shm_vs_tcp": a[0][0]["digest"] == b[0][0]["digest"],
             "two_level_shm_turns": a[0][0]["digest"] == a[1][0]["digest"],
             "two_level_shm_vs_flat": a[0][0]["digest"] == c[0][0]["digest"]},
         losses_two_level_vs_flat={"abs_err": off, "tolerance": tol,
                                   "size1": size1},
         parts_seconds=seconds, seconds=time.perf_counter() - t_phase)
    for tag, turns, transport in (("two_level_shm", a, "shm"),
                                  ("two_level_tcp", b, "tcp")):
        for x in (x for xs in turns for x in xs):
            topo, ctrl = x["topology"], x["control"]
            if not (topo["hierarchical"] and topo["nodes"] == 2
                    and topo["local_size"] == TOPO_NODE
                    and topo["local_transport"] == transport):
                fail(f"topology {tag} rank {x['rank']}: topology {topo}")
            if not (ctrl["tree"] and ctrl["depth"] == 2
                    and ctrl["hosts"] == 2):
                fail(f"topology {tag} rank {x['rank']}: control {ctrl}")
    for x in (x for xs in a for x in xs):
        local = str(x["rank"] + 1 if x["rank"] % 2 == 0 else x["rank"] - 1)
        link = x["links"].get(local, {})
        if link.get("transport") != "shm" or not link.get("shm_bytes_out"):
            fail(f"topology two_level_shm rank {x['rank']}: the local "
                 f"peer's link {link}")
    for x in (x for xs in c for x in xs):
        if x["topology"]["hierarchical"] or x["control"]["tree"]:
            fail(f"topology flat rank {x['rank']}: {x['topology']}, "
                 f"{x['control']}")
    if any(o > t for turn in off for o, t in zip(turn, tol)):
        fail(f"topology: two-level losses {[xs[0]['losses'] for xs in a]} "
             f"against the flat ring's {[xs[0]['losses'] for xs in c]}, "
             f"tolerance {tol}")
    return [x["launches"] for x in a[0]], (size1, tol)


def chaos_job(tag, ranks, rank_phase, out_dir, extra=(), script=__file__):
    """The port's launcher CLI with ``--net-fault-spec`` (``CHAOS_SPECS``)
    over ``ranks`` ranks of ``chip_smoke.py --rank <rank_phase>``: the
    launcher's exit code and output (kept in OUT_DIR)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **CHAOS_ENV)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env[SMOKE_DIR_ENV] = out_dir
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(ranks), "--net-fault-spec", CHAOS_SPECS[tag], *extra, "--",
         sys.executable, os.path.abspath(script), "--rank", rank_phase],
        capture_output=True, text=True, env=env, timeout=300)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chaos_{tag}_launcher.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    proc.seconds = time.perf_counter() - t0
    return proc


def _chaos_results(tag, ranks, out_dir):
    res = []
    for r in range(ranks):
        path = os.path.join(out_dir, f"chaos_{tag}_rank{r}.json")
        if not os.path.exists(path):
            fail(f"chaos {tag}: rank {r} wrote no result")
        with open(path) as f:
            res.append(json.load(f))
    return res


def _send_mean_us(link):
    return (link["send_us_sum"] / link["send_us_count"]
            if link and link["send_us_count"] else None)


def phase_chaos(dp_res, reference, script=__file__):
    """``chaos``: the network fault injector through the launcher's
    ``--net-fault-spec``: ``train_dp``'s step at 2 ranks on a flaky link
    and, side by side, on a slow link, then 4 ranks of small allreduces
    across a partition with a postmortem dir."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="hvdt_chaos_")
    try:
        out = {}
        steps = TOPO_WARMUP + TOPO_TIMED
        per = HEADLINE["n_layers"] * steps
        want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
                "flash_bwd_dq": 0}
        size1, tol = reference
        clean = dp_res[0]["losses"][:steps]
        probe = None
        # The two training jobs run side by side on the card (their step
        # times are printed, not gated).
        with ThreadPoolExecutor(2) as pool:
            procs = dict(zip(("flaky", "delay"), pool.map(
                lambda t: chaos_job(t, CHAOS_RANKS, "chaos", tmp,
                                    script=script), ("flaky", "delay"))))
        for tag, proc in procs.items():
            if proc.returncode != 0:
                fail(f"chaos {tag}: the job exited {proc.returncode}:\n"
                     f"{proc.stderr[-4000:]}")
            res = _chaos_results(tag, CHAOS_RANKS, tmp)
            if probe is None:
                probe = probe_want(res[0]["shapes"], CHAOS_RANKS)
            off = [abs(x - y) for x, y in zip(res[0]["losses"], clean)]
            links = {x["rank"]: x["links"][str(1 - x["rank"])] for x in res}
            out[tag] = {
                "median_step_ms": max(x["median_step_ms"] for x in res),
                "median_sync_ms": [x["median_sync_ms"] for x in res],
                "losses": res[0]["losses"], "train_dp_losses": clean,
                "abs_err": off, "tolerance": tol,
                "probe_exact": [x["probe"] == probe for x in res],
                "faults": [x["faults"] for x in res],
                "evictions": [x["evictions"] for x in res],
                "send_mean_us": {r: _send_mean_us(v)
                                 for r, v in links.items()},
                "links": links,
                "anomalies": [x["anomalies"] for x in res],
                "launches": [x["launches"] for x in res],
                "job_seconds": proc.seconds,
                "rank0_seconds": res[0]["seconds"]}
            for x in res:
                if x["launches"] != want:
                    fail(f"chaos {tag} rank {x['rank']} launched "
                         f"{x['launches']}, want {want}")
                if x["probe"] != probe or x["evictions"]:
                    fail(f"chaos {tag} rank {x['rank']}: probe exact "
                         f"{x['probe'] == probe}, evictions "
                         f"{x['evictions']}")
                if x["losses"] != res[0]["losses"] or \
                        x["digest"] != res[0]["digest"]:
                    fail(f"chaos {tag}: the ranks' losses or parameters "
                         f"differ")
            if any(o > t for o, t in zip(off, tol)):
                fail(f"chaos {tag}: losses {res[0]['losses']} against "
                     f"train_dp's {clean}, tolerance {tol}")
            if tag == "delay" and not all(
                    (m or 0) >= CHAOS_DELAY_MS * 1e3
                    for m in out[tag]["send_mean_us"].values()):
                fail(f"chaos delay: link 0-1's timed sends "
                     f"{out[tag]['send_mean_us']} us, not the "
                     f"{CHAOS_DELAY_MS} ms the clause injects")
        pm = os.path.join(tmp, "postmortem")
        proc = chaos_job("partition", CHAOS_PARTITION_RANKS,
                         "chaos_partition", tmp,
                         extra=("--postmortem-dir", pm), script=script)
        part = _chaos_results("partition", CHAOS_PARTITION_RANKS, tmp)
        dumps = sorted(os.listdir(pm)) if os.path.isdir(pm) else []
        for d in dumps:
            shutil.copy(os.path.join(pm, d),
                        os.path.join(OUT_DIR, f"chaos_partition_{d}"))
        out["partition"] = {
            "launcher_exit": proc.returncode, "dumps": dumps,
            "job_seconds": proc.seconds,
            "ranks": [{k: x.get(k) for k in ("rank", "error", "ranks",
                                             "far_only", "seconds")}
                      for x in part]}
        emit("chaos", nvidia_smi=smi_line(), specs=CHAOS_SPECS,
             heartbeat=CHAOS_ENV, size1=size1,
             train_dp_median_step_ms=max(x["median_step_ms"]
                                         for x in dp_res),
             runs=out, seconds=time.perf_counter() - t_phase)
        if proc.returncode != 7:
            fail(f"chaos partition: the launcher exited {proc.returncode}")
        for x in part:
            # Whom each rank names is printed, not gated: the clause arms
            # per process, and a rank that arms late can report its cut
            # neighbour before its own side goes dark (PERF.md).
            if x["error"] != "RanksDownError" or \
                    x["seconds"] >= CHAOS_PARTITION_SEC:
                fail(f"chaos partition rank {x['rank']}: {x}")
        if dumps != [f"rank-{r}.json" for r in range(CHAOS_PARTITION_RANKS)]:
            fail(f"chaos partition: postmortem dumps {dumps}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- the pipeline phases: stage ranks on this card (ROADMAP A.7) ---


# --- rank-subset init: init(comm=[...]) on a subset of the launched ranks ---

SUBSET_RANKS = 3  # launched; SUBSET_MEMBERS call init(comm=SUBSET_MEMBERS)
SUBSET_MEMBERS = [0, 2]
SUBSET_WARMUP, SUBSET_TIMED = 1, 2


def rank_subset():
    """One launched rank of ``subset``: outside ``SUBSET_MEMBERS`` it
    never calls ``init()`` and exits; a member calls
    ``init(comm=SUBSET_MEMBERS)`` and runs ``train_dp``'s step
    (:func:`dp_run`)."""
    me = int(os.environ["HVD_TPU_RANK"])
    if me not in SUBSET_MEMBERS:
        rank_result(launcher_rank=me, member=False)
        return
    hvdt.init(comm=SUBSET_MEMBERS, device=DP_DEVICE)
    res = dp_run(SUBSET_WARMUP, SUBSET_TIMED)
    res.update(launcher_rank=me, member=True, local_rank=hvdt.local_rank(),
               local_size=hvdt.local_size(),
               threads=hvdt.mpi_threads_supported())
    hvdt.shutdown()
    rank_result(**res)


def phase_subset(dp_step_ms, dp_res, reference, script=__file__):
    """``subset``: see the module's docstring.  ``reference`` is
    ``phase_topology``'s ``(size1, tolerance)``, ``train_dp``'s rule."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    res = run_ranks("subset", timeout=300, ranks=SUBSET_RANKS,
                    script=script)
    steps = SUBSET_WARMUP + SUBSET_TIMED
    per = HEADLINE["n_layers"] * steps
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    members = [x for x in res if x["member"]]
    outside = [x["launcher_rank"] for x in res if not x["member"]]
    if not members:
        fail(f"subset: no member reported: {res}")
    size1, tol = reference
    clean = dp_res[0]["losses"][:steps]
    losses = members[0]["losses"]
    off = [abs(a - b) for a, b in zip(losses, clean)]
    probe = probe_want(members[0]["shapes"], len(SUBSET_MEMBERS))
    identity = [[x[k] for k in ("launcher_rank", "rank", "size",
                                "local_rank", "local_size")]
                for x in members]
    emit("subset", nvidia_smi=smi_line(), launched=SUBSET_RANKS,
         members=SUBSET_MEMBERS, never_initialized=outside,
         identity_launcher_rank_size_local=identity,
         mpi_threads_supported=[x["threads"] for x in members],
         median_step_ms=max(x["median_step_ms"] for x in members),
         train_dp_median_step_ms=dp_step_ms,
         step_ms=[x["step_ms"] for x in members],
         median_sync_ms=[x["median_sync_ms"] for x in members],
         losses=losses, train_dp_losses=clean,
         losses_bit_equal_train_dp=losses == clean,
         losses_vs_train_dp={"abs_err": off, "tolerance": tol[:steps],
                             "size1": [r[:steps] for r in size1]},
         probe_exact=all(x["probe"] == probe for x in members),
         probe_ms=[x["probe_ms"] for x in members],
         launches=[x["launches"] for x in members], want_launches=want,
         seconds=time.perf_counter() - t_phase)
    if outside != [m for m in range(SUBSET_RANKS)
                   if m not in SUBSET_MEMBERS]:
        fail(f"subset: the ranks outside the subset reported {outside}")
    if identity != [[m, i, len(SUBSET_MEMBERS), i, len(SUBSET_MEMBERS)]
                    for i, m in enumerate(SUBSET_MEMBERS)]:
        fail(f"subset: identities {identity}")
    for x in members:
        if x["launches"] != want:
            fail(f"subset rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if x["probe"] != probe:
            fail(f"subset rank {x['rank']}: the probe's average is not "
                 "the exact one")
        if x["losses"] != losses or not all(math.isfinite(v)
                                            for v in x["losses"]):
            fail(f"subset: losses {[y['losses'] for y in members]}")
        if x["threads"] is not True:
            fail("subset: mpi_threads_supported() is not True")
    if len({x["digest"] for x in members}) != 1:
        fail("subset: the members' parameters differ after the steps")
    if any(o > t for o, t in zip(off, tol)):
        fail(f"subset: losses {losses} against train_dp's {clean}, "
             f"tolerance {tol[:steps]}")


def pipeline_kernels():
    """K1 and B2 held against their plain versions at the pipeline's
    micro-batch shape (``check_case``, ``kernel_check``'s rule) and timed
    there: their summary rows at ``PIPE_MICRO``."""
    errs = check_case(PIPE_MICRO, torch.bfloat16, True)[0]
    held = {n: e for n, e in errs.items()
            if n in ("o", "lse", "dq", "dk", "dv")}
    if any(e["worst"] > 1.0 for e in held.values()):
        fail(f"K1/B2 disagree with their plain versions at {PIPE_MICRO}: "
             f"{held}")
    entries = k1_b2_entries(PIPE_MICRO, errs)[0]
    emit("pipeline_kernels", shape=list(PIPE_MICRO), errors=held,
         timing={n: {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "max_abs_err")}
                 for n, e in entries.items()})
    return entries


def _pipe_batches(data, steps, mark, snaps, waits):
    """``steps`` copies of ``data``; a metrics snapshot (and a copy of
    ``waits``) before step ``mark`` and after the last step (before the
    closing barrier)."""
    for i in range(steps):
        if i == mark:
            snaps.append((hvd_common.metrics_snapshot(), dict(waits)))
        yield data
    snaps.append((hvd_common.metrics_snapshot(), dict(waits)))


def time_transport():
    """Patch ``EngineTransport``'s send, recv and flush in this process to
    add their host seconds to the returned dict: a send waits for its D2H
    copy (this stage's work queued before it), a receive for the peer's
    bucket, a flush for the peer to take the sends."""
    waits = {"send": 0.0, "recv": 0.0, "flush": 0.0}
    for name in waits:
        real = getattr(P.EngineTransport, name)

        def timed(self, *args, _real=real, _name=name):
            t0 = time.perf_counter()
            try:
                return _real(self, *args)
            finally:
                waits[_name] += time.perf_counter() - t0

        setattr(P.EngineTransport, name, timed)
    return waits


def p2p_round_trip_ms(nbytes, iters=5):
    """Median ms of one ``nbytes`` float32 transfer between ranks 0 and 1
    through the engine (half a ping-pong of pinned buffers)."""
    buf = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    r, times = hvdt.rank(), []
    for i in range(iters + 1):
        t0 = time.perf_counter()
        if r == 0:
            hvd_common.send(buf, 1, name="pingpong")
            hvd_common.recv(buf, 1, name="pingpong")
        else:
            hvd_common.recv(buf, 0, name="pingpong")
            hvd_common.send(buf, 0, name="pingpong")
        if i:
            times.append((time.perf_counter() - t0) * 1e3 / 2)
    return statistics.median(times)


def pipeline_window(snaps):
    """The engine's cache hit rate, the p2p counters and the transport's
    waits between the two snapshots of ``_pipe_batches``."""
    (a, wa), (b, wb) = snaps
    ca, cb = a["cache"]["engine"], b["cache"]["engine"]
    hits, misses = cb["hits"] - ca["hits"], cb["misses"] - ca["misses"]
    pa, pb = a["p2p"], b["p2p"]
    return {"hit_rate": hits / max(hits + misses, 1), "hits": hits,
            "misses": misses, "unmatched": pb["unmatched"],
            **{k: pb[k] - pa[k] for k in ("sends", "recvs", "group_ops")},
            "bytes_out": pb["bytes"]["out"] - pa["bytes"]["out"],
            "bytes_in": pb["bytes"]["in"] - pa["bytes"]["in"],
            **{f"{k}_wait_sec": wb[k] - wa[k] for k in wa}}


def grad_norm(params):
    return math.sqrt(sum(float(p.grad.double().square().sum())
                         for p in params if p.grad is not None))


def norm_probe(norms, names=None):
    """A pre-step hook that appends the gradient norm of the optimizer's
    parameters (with ``names``, a list of name sets and the optimizer's
    parameter names, one norm per set)."""
    def hook(opt, args, kwargs):
        params = [p for g in opt.param_groups for p in g["params"]]
        if names is None:
            norms.append(grad_norm(params))
        else:
            sets, order = names
            norms.append([grad_norm(p for n, p in zip(order, params)
                                    if n in want) for want in sets])
    return hook


def pipeline_parity_run(dtype):
    """3 steps of the pipeline from ``AVG_SEED`` in ``dtype`` on this
    rank: ``{"losses", "grad_norms"}`` (the norm of this stage's
    accumulated gradient before each update)."""
    modules, _, data = build_pipeline_stages(**PIPE_HEADLINE, dtype=dtype,
                                             seed=AVG_SEED)
    norms = []

    def make(params):
        opt = adamw(params)
        opt.register_step_pre_hook(norm_probe(norms))
        return opt

    _, _, losses = run_pipeline(modules, make, [data] * 3, n_stages=2,
                                n_microbatches=PIPE_HEADLINE["microbatches"])
    del modules, data
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms}


def rank_pipeline():
    """One stage rank of ``pipeline``: the timed run at PIPE_HEADLINE,
    then the parity runs (float32, and bf16 reported)."""
    hvdt.init(device="cuda:0")
    warmup, timed = 2, 5
    modules, grid, data = build_pipeline_stages(**PIPE_HEADLINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snaps, stats, waits = [], {}, time_transport()
    A.reset_launches()
    modules, _, losses = run_pipeline(
        modules, adamw,
        _pipe_batches(data, warmup + timed, warmup, snaps, waits),
        n_stages=PIPE_HEADLINE["stages"],
        n_microbatches=PIPE_HEADLINE["microbatches"], stats=stats)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [x * 1e3 for x in stats["step_sec"][warmup:]]
    # One more step traced (fresh AdamW state: its first update allocates
    # the moments), then one bucket's transfer alone.
    profiled = profile_step(lambda: run_pipeline(
        modules, adamw, [data], n_stages=PIPE_HEADLINE["stages"],
        n_microbatches=PIPE_HEADLINE["microbatches"]),
        f"pipeline_rank{hvdt.rank()}")
    b, _, s, _ = PIPE_MICRO
    bucket_ms = p2p_round_trip_ms(b * s * PIPE_HEADLINE["d_model"] * 4)
    del modules, data
    torch.cuda.empty_cache()
    rank_result(rank=hvdt.rank(), stage=grid.stage, losses=losses,
                step_ms=step_ms, median_step_ms=statistics.median(step_ms),
                window=pipeline_window(snaps), timed=timed,
                profiled_step_ms=profiled[0], busy_ms=profiled[1],
                d2h_ms=profiled[2], h2d_ms=profiled[3],
                bucket_transfer_ms=bucket_ms,
                max_memory_allocated=peak, launches=launched,
                parity={"float32": pipeline_parity_run(torch.float32),
                        "bfloat16": pipeline_parity_run(torch.bfloat16)})
    hvdt.shutdown()


def pipeline_reference():
    """Size-1 runs of ``build_lm_step`` from ``AVG_SEED`` on the whole
    batch, float32 logits: two in float32 and one in bf16, each
    ``{"losses", "grad_norms"}`` (per step, the norm of each stage's
    share of the gradient)."""
    n_layers, stages = PIPE_HEADLINE["n_layers"], PIPE_HEADLINE["stages"]

    def run(dtype):
        model, step, data = build_lm_step(**HEADLINE, dtype=dtype,
                                          logits_dtype=torch.float32,
                                          seed=AVG_SEED)
        sets = [set(part[0]) for part in partition_params(
            model.state_dict(), n_layers, stages)]
        norms = []
        step.optimizer._inner.register_step_pre_hook(norm_probe(
            norms, (sets, [n for n, _ in model.named_parameters()])))
        losses = [step(data).item() for _ in range(3)]
        del model, step, data
        torch.cuda.empty_cache()
        return {"losses": losses, "grad_norms": norms}

    hvd.init()
    out = {"float32": [run(torch.float32), run(torch.float32)],
           "bfloat16": run(torch.bfloat16)}
    hvd.shutdown()
    return out


def pipeline_rule(res, refs, dtype="float32"):
    """The parity rule on the ranks' ``parity[dtype]``: per step, the last
    stage's loss and each stage's gradient norm within 3x the spread of
    the two size-1 float32 runs, at least ``PIPE_FLOOR`` of the value.
    ``(passes, report)``."""
    a, b = refs["float32"]
    last = max(res, key=lambda x: x["stage"])
    rows = [("loss", last["parity"][dtype]["losses"], a["losses"],
             b["losses"])]
    for x in res:
        rows.append((f"grad_norm.s{x['stage']}",
                     x["parity"][dtype]["grad_norms"],
                     [n[x["stage"]] for n in a["grad_norms"]],
                     [n[x["stage"]] for n in b["grad_norms"]]))
    report, ok = {}, True
    for name, got, want, twin in rows:
        err = [abs(g - w) for g, w in zip(got, want)]
        tol = [max(3 * abs(w - t), PIPE_FLOOR * abs(w))
               for w, t in zip(want, twin)]
        ok = ok and len(got) == len(want) and all(
            e <= t for e, t in zip(err, tol))
        report[name] = {"pipeline": got, "size1": want, "abs_err": err,
                        "tolerance": tol,
                        "err_over_value": [e / abs(w)
                                           for e, w in zip(err, want)]}
    return ok, report


def _want_launches(per):
    """Launch counts of ``per`` attention calls at the pipeline's
    micro-batch shape, in the reference plan's backward mode."""
    b, h, s, d = PIPE_MICRO
    split = A.bwd_mode(s, d, b * h) == "split"
    return {"flash_fwd": per, "flash_bwd": 0 if split else per,
            "flash_bwd_dkdv": per if split else 0,
            "flash_bwd_dq": per if split else 0}


def phase_pipeline():
    torch.cuda.empty_cache()
    entries = pipeline_kernels()
    res = sorted(run_ranks("pipeline", timeout=600, ranks=PIPE_RANKS),
                 key=lambda x: x["rank"])
    refs = pipeline_reference()
    vocab, batch, seq = (PIPE_HEADLINE[k] for k in
                         ("vocab_size", "batch", "seq"))
    n_micro, stages = PIPE_HEADLINE["microbatches"], PIPE_HEADLINE["stages"]
    timed = res[0]["timed"]
    want = _want_launches(PIPE_HEADLINE["n_layers"] // stages * n_micro
                          * (len(res[0]["losses"])))
    step_ms = max(x["median_step_ms"] for x in res)
    ok, parity = pipeline_rule(res, refs)
    _, parity_bf16 = pipeline_rule(res, refs, "bfloat16")
    bf16 = refs["bfloat16"]["losses"]
    bf16_pipe = res[-1]["parity"]["bfloat16"]["losses"]
    losses = res[-1]["losses"]
    emit("pipeline", ranks=PIPE_RANKS, stages=stages, microbatches=n_micro,
         batch=batch, seq=seq, nvidia_smi=smi_line(),
         tokens_per_s=batch * seq / (step_ms / 1e3),
         median_step_ms=[x["median_step_ms"] for x in res],
         step_ms=[x["step_ms"] for x in res],
         p2p_per_step=[{k: x["window"][k] / timed for k in
                        ("sends", "recvs", "bytes_out", "bytes_in")}
                       for x in res],
         unmatched=[x["window"]["unmatched"] for x in res],
         hit_rate=[x["window"]["hit_rate"] for x in res],
         cache=[(x["window"]["hits"], x["window"]["misses"]) for x in res],
         wait_ms_per_step=[{k[:-4]: x["window"][k] * 1e3 / timed
                            for k in x["window"] if k.endswith("_wait_sec")}
                           for x in res],
         bucket_transfer_ms=res[0]["bucket_transfer_ms"],
         profiled_step_ms=[x["profiled_step_ms"] for x in res],
         kernel_and_copy_busy_ms=[x["busy_ms"] for x in res],
         d2h_ms=[x["d2h_ms"] for x in res], h2d_ms=[x["h2d_ms"] for x in res],
         card_idle_share_estimate=(
             None if None in [x["busy_ms"] for x in res] else
             1.0 - sum(x["busy_ms"] for x in res)
             / max(x["profiled_step_ms"] for x in res)),
         bubble_fraction=P.bubble_fraction(stages, n_micro),
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         launches=[x["launches"] for x in res], want_launches=want,
         losses=losses, parity_float32=parity, parity_passes=ok,
         parity_floor=PIPE_FLOOR,
         bf16_loss_diff=[p - r for p, r in zip(bf16_pipe, bf16)],
         bf16_grad_norms=parity_bf16)
    for x in res:
        if x["launches"] != want:
            fail(f"pipeline rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if x["window"]["unmatched"] or x["window"]["hit_rate"] < 0.9:
            fail(f"pipeline rank {x['rank']}: {x['window']}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"pipeline: non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"pipeline: implausible loss trajectory: {losses}")
    if not ok:
        fail(f"pipeline: float32 parity with the size-1 step: {parity}")
    return entries, res[0]["launches"]


def rank_pipeline_dp():
    """One rank of ``pipeline_dp`` (2 stages x 2 DP)."""
    hvdt.init(device="cuda:0")
    warmup, timed = 1, 3
    modules, grid, data = build_pipeline_stages(**PIPE_DP_HEADLINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snaps, stats = [], {}
    A.reset_launches()
    modules, _, losses = run_pipeline(
        modules, adamw, _pipe_batches(data, warmup + timed, warmup, snaps,
                                      {}),
        n_stages=PIPE_DP_HEADLINE["stages"],
        n_microbatches=PIPE_DP_HEADLINE["microbatches"], stats=stats)
    torch.cuda.synchronize()
    step_ms = [x * 1e3 for x in stats["step_sec"][warmup:]]
    sync_ms = [x * 1e3 for x in stats["grad_sync_sec"][warmup:]]
    rank_result(rank=hvdt.rank(), stage=grid.stage, losses=losses,
                step_ms=step_ms, median_step_ms=statistics.median(step_ms),
                median_grad_sync_ms=statistics.median(sync_ms),
                window=pipeline_window(snaps), timed=timed,
                n_params=sum(len(list(m.parameters())) for m in modules),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=dict(A.launches), digest=params_digest(modules[0]))
    hvdt.shutdown()


def phase_pipeline_dp():
    torch.cuda.empty_cache()
    res = sorted(run_ranks("pipeline_dp", timeout=600, ranks=PIPE_DP_RANKS),
                 key=lambda x: x["rank"])
    h = PIPE_DP_HEADLINE
    dp = PIPE_DP_RANKS // h["stages"]
    want = _want_launches(h["n_layers"] // h["stages"] * h["microbatches"]
                          * len(res[0]["losses"]))
    step_ms = max(x["median_step_ms"] for x in res)
    emit("pipeline_dp", ranks=PIPE_DP_RANKS, stages=h["stages"], dp=dp,
         microbatches=h["microbatches"], batch_per_dp_rank=h["batch"],
         seq=h["seq"], nvidia_smi=smi_line(),
         tokens_per_s=dp * h["batch"] * h["seq"] / (step_ms / 1e3),
         median_step_ms=[x["median_step_ms"] for x in res],
         group_allreduce_ms=[x["median_grad_sync_ms"] for x in res],
         group_ops_per_step=[x["window"]["group_ops"] / x["timed"]
                             for x in res],
         leaves=[x["n_params"] for x in res],
         unmatched=[x["window"]["unmatched"] for x in res],
         hit_rate=[x["window"]["hit_rate"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         launches=[x["launches"] for x in res], want_launches=want,
         losses=[x["losses"] for x in res],
         digests=[x["digest"] for x in res])
    for x in res:
        if x["launches"] != want:
            fail(f"pipeline_dp rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        w = x["window"]
        if w["unmatched"] or w["hit_rate"] < 0.9:
            fail(f"pipeline_dp rank {x['rank']}: {w}")
        # Every gradient average is a stage-group op, one per leaf a step.
        if w["group_ops"] != x["n_params"] * x["timed"]:
            fail(f"pipeline_dp rank {x['rank']}: {w['group_ops']} group "
                 f"ops for {x['n_params']} leaves x {x['timed']} steps")
    for stage in range(h["stages"]):
        digests = {x["digest"] for x in res if x["stage"] == stage}
        if len(digests) != 1:
            fail(f"pipeline_dp: stage {stage}'s replicas differ")
    last = [lo for x in res if x["stage"] == h["stages"] - 1
            for lo in x["losses"]]
    if not all(math.isfinite(lo) for lo in last):
        fail(f"pipeline_dp: non-finite loss: {last}")
    return res[0]["launches"]


# --- the image models (ROADMAP A.5) ---


def _image_grads(name, side, classes, images, labels, dtype, device):
    """``{"logits": ..., parameter name: gradient}`` in float64 on the CPU
    of one training-mode forward and backward of the image model ``name``
    (weights from seed 5, flax ``nn.BatchNorm``'s mode, dropout off) in
    ``dtype`` on ``device``; in float64 the head too computes in float64
    (the models fix it to float32)."""
    net = IS.build_image_model(name, num_classes=classes, image=side,
                               dtype=dtype, seed=5, device=device,
                               fused_ema=False)
    if dtype == torch.float64:
        net.double()
        for m in net.modules():
            if isinstance(m, Dense):
                m.dtype = torch.float64
    net.train()
    for m in net.modules():  # the devices draw other masks
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    logits = net(images.to(device, dtype))
    torch.nn.functional.cross_entropy(logits, labels.to(device)).backward()
    return {"logits": logits.detach().double().cpu(),
            **{n: p.grad.double().cpu() for n, p in net.named_parameters()}}


def _normwise(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def phase_image_models():
    """The float32 policy is the package's own (``import horovod_tpu_torch``
    turns TF32 off for matmuls and cuDNN convolutions); this phase holds
    the models under it and fails if it is not in force.

    ResNet-50, VGG16, InceptionV3 (299) and MnistCNN at full width and
    batch 2, the same weights and standard-normal images (centred, so BN's
    E[x^2] - E[x]^2 does not cancel) on the card and on the CPU:

    * float64 on both: the logits and every gradient, norm-wise
      ||card - cpu|| / ||cpu|| <= 1e-6 each (summation order in float64):
      the card computes the function the CPU does;
    * float32 with TF32 off, on the card and on the CPU, against the CPU
      in float64: the logits norm-wise no further off than 4 x the CPU's
      float32 (floor 1e-6).  The gradients are reported, not held: in
      float32 these nets at initialisation are too ill-conditioned for a
      bound.  Where two values of a max-pool window lie within rounding
      of each other the devices pick different ones and move that
      gradient entry to a neighbour, gradients whose terms
      cancel (a bias's, a BN scale's) are then off by a large share of
      their own small size, and InceptionV3's whole gradient is 2.4% off
      float64 on the CPU and 70% on the card, while in float64 the two
      devices agree to 5e-13;
    * bf16 on the card: loss and gradients finite."""
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        fail("the package's float32 policy (TF32 off for matmuls and cuDNN "
             "convolutions) is not in force")
    rows = {}
    for name, side in IMAGE_MODELS:
        classes = 10 if name == "mnist" else 1000
        ch = 1 if name == "mnist" else 3
        rng = np.random.RandomState(3)
        images = torch.from_numpy(rng.standard_normal(
            (2, side, side, ch)).astype(np.float32)).permute(0, 3, 1, 2)
        labels = torch.from_numpy(rng.randint(0, classes, 2))
        run = functools.partial(_image_grads, name, side, classes, images,
                                labels)
        cpu64 = run(torch.float64, "cpu")
        card64 = run(torch.float64, "cuda")
        err64 = {n: _normwise(card64[n], w) for n, w in cpu64.items()}
        del card64
        cpu32, card32 = run(torch.float32, "cpu"), run(torch.float32, "cuda")
        torch.cuda.empty_cache()
        names = [n for n in cpu64 if n != "logits"]
        flat = {k: torch.cat([d[n].flatten() for n in names])
                for k, d in (("cpu64", cpu64), ("cpu32", cpu32),
                             ("card", card32))}
        err32 = {"logits": (_normwise(card32["logits"], cpu64["logits"]),
                            _normwise(cpu32["logits"], cpu64["logits"])),
                 "grads": (_normwise(flat["card"], flat["cpu64"]),
                           _normwise(flat["cpu32"], flat["cpu64"]))}
        per_tensor = max(names, key=lambda n: _normwise(card32[n], cpu64[n]))
        del cpu64, cpu32, card32, flat
        # bf16 on the card: the models' working type.
        net = IS.build_image_model(name, num_classes=classes, image=side,
                                   dtype=torch.bfloat16, seed=5,
                                   device="cuda")
        loss16 = torch.nn.functional.cross_entropy(
            net(images.cuda()).float(), labels.cuda())
        loss16.backward()
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in net.parameters())
        del net
        torch.cuda.empty_cache()
        worst64 = max(err64, key=err64.get)
        ok32 = err32["logits"][0] <= max(4 * err32["logits"][1], 1e-6)
        rows[name] = {"image": side, "f64_worst": worst64,
                      "f64_worst_err": err64[worst64],
                      "f32_err_card_cpu32": err32,
                      "f32_worst_tensor": per_tensor,
                      "outputs_held": len(err64),
                      "bf16_loss": loss16.item(),
                      "bf16_grads_finite": grads_finite}
        if (err64[worst64] > 1e-6 or not ok32
                or not math.isfinite(loss16.item()) or not grads_finite):
            emit("image_models", models=rows)
            fail(f"image model {name} on the card: {rows[name]}")
    emit("image_models", models=rows, nvidia_smi=smi_line(),
         rule="float64: each output norm-wise <= 1e-6; float32 against "
              "float64: logits norm-wise <= 4 x the CPU's float32 (floor "
              "1e-6); float32 gradients reported (err32 grads: card, cpu32, "
              "all gradients as one vector, against float64)")


def _image_step_run(headline, warmup=3, timed=10, profile=False):
    """``headline`` through ``hvd.init()``, ``DistributedOptimizer`` and
    the image step: the images/s of the median host clock around
    ``step(data).item()``, peak memory, losses; with ``profile`` one
    traced window of 3 steps summed by kernel class."""
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    torch.cuda.reset_peak_memory_stats()
    # What earlier phases left allocated is in the peak; the step's own
    # peak is the difference.
    base = torch.cuda.memory_allocated()
    _, step, data = IS.build_image_step(**headline)
    losses, step_ms = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        if i >= warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    med = statistics.median(step_ms)
    res = {"model": headline["model"], "batch": headline["batch"],
           "image": headline["image"], "images_per_s":
           headline["batch"] / (med / 1e3), "median_step_ms": med,
           "step_ms": step_ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_before": base,
           "step_peak_bytes": torch.cuda.max_memory_allocated() - base,
           "losses": losses}
    if profile:
        prof = trace_steps(step, data, 3, os.path.join(
            OUT_DIR, f"resnet_trace_{headline['model']}.json"),
            image_category, keep_trace=False)
        with open(os.path.join(OUT_DIR, "resnet_top_kernels.txt"), "w") as f:
            for kname, ms in prof.pop("top_kernels"):
                f.write(f"{ms:10.4f} ms/step  {kname}\n")
        res["profile"] = prof
    hvd.shutdown()
    return res


def phase_resnet():
    """RESNET_HEADLINE (ResNet-50) and RESNET101_HEADLINE (bench.py's
    default) through the image step: 3 warm-up and 10 timed steps, images
    per second, peak memory, the loss finite and falling on the fixed
    batch; one traced window of ResNet-50's step by kernel class."""
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = [_image_step_run(IS.RESNET_HEADLINE, profile=True),
            _image_step_run(IS.RESNET101_HEADLINE)]
    torch.cuda.empty_cache()
    emit("resnet", runs=runs, nvidia_smi=smi_line())
    for r in runs:
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"resnet {r['model']}: non-finite loss {losses}")
        if abs(losses[0] - math.log(1000)) > 1.5 or losses[-1] >= losses[0]:
            fail(f"resnet {r['model']}: implausible losses {losses}")


def rank_resnet_dp():
    """One rank of ``resnet_dp``: ResNet-50 with cross-replica BN
    (``axis_name="hvd"``, the module EMA of the example's recipe) at batch
    64 per rank and 224 x 224."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    headline = dict(IS.RESNET_HEADLINE, axis_name="hvd", fused_ema=False)
    model, step, data = IS.build_image_step(**headline)
    norm_mod.take_sync_sec(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    losses, step_ms, sync_ms, bn_ms, bn_calls, cycles = [], [], [], [], [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(data).item()
        dt = (time.perf_counter() - t0) * 1e3
        bn = norm_mod.take_sync_sec(model)
        losses.append(loss)
        cycles.append(len(set(step.optimizer.last_ticks)))
        if i >= warmup:
            step_ms.append(dt)
            sync_ms.append(step.train_step.sync_sec[-1] * 1e3)
            bn_ms.append((bn["fwd"] + bn["bwd"]) * 1e3)
            bn_calls.append(bn["calls"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    digest = params_digest(model)  # parameters and buffers
    del model, step, data
    torch.cuda.empty_cache()
    avg = resnet_averaging_run(slice(r * 32, r * 32 + 32))
    med = statistics.median(step_ms)
    rank_result(rank=r, size=n, losses=losses, step_ms=step_ms,
                median_step_ms=med, sync_ms=sync_ms,
                median_sync_ms=statistics.median(sync_ms),
                bn_allreduce_ms=bn_ms,
                bn_allreduce_share=statistics.median(bn_ms) / med,
                bn_allreduces_per_step=bn_calls,
                engine_cycles_per_step=cycles, max_memory_allocated=peak,
                digest=digest, averaging=avg)
    hvdt.shutdown()


def resnet_averaging_run(rows):
    """The averaging check's run on this process: 3 steps of ResNet-50
    with cross-replica BN from ``RESNET_AVG_SEED`` on ``rows`` of one batch
    of 64, in float32 with TF32 off (in bf16 cuDNN's convolutions round
    each activation to 8 bits in an order that depends on the batch size,
    so the half-batch and the whole-batch statistics differ by bf16's
    rounding, ~4e-3, whatever the averaging does); the losses and every
    running stat after the last step."""
    headline = dict(IS.RESNET_HEADLINE, axis_name="hvd", fused_ema=False,
                    seed=RESNET_AVG_SEED, rows=rows, dtype=torch.float32)
    model, step, data = IS.build_image_step(**headline)
    losses = [step(data).item() for _ in range(3)]
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()}
    del model, step, data
    torch.cuda.empty_cache()
    return {"losses": losses,
            "stats": {n: t.tolist() for n, t in stats.items()}}


def phase_resnet_dp():
    """ResNet-50 data-parallel over 2 ranks of the port's runner on this
    card, BN statistics averaged across the ranks inside the forward
    (``axis_name``), the example's recipe: job images/s, ``sync_sec``,
    the share of the step in the BN allreduces, engine cycles per step;
    every parameter and buffer bit-identical across the ranks; the
    averaging check: 3 steps of both ranks on rows [32r, 32r + 32) of one
    batch of 64 against the size-1 step on all 64 rows, losses and running
    stats within 3 x the spread of two size-1 runs (floor 1e-3 of the
    loss, 1e-3 of each stat's largest element)."""
    torch.cuda.empty_cache()
    res = run_ranks("resnet_dp", timeout=600)
    hvd.init()
    refs = [resnet_averaging_run(slice(None)) for _ in range(2)]
    hvd.shutdown()
    batch = IS.RESNET_HEADLINE["batch"]
    step_ms = max(x["median_step_ms"] for x in res)
    dp = res[0]["averaging"]
    loss_tol = [max(3 * abs(a - b), 1e-3 * abs(a))
                for a, b in zip(refs[0]["losses"], refs[1]["losses"])]
    loss_off = [abs(a - b) for a, b in zip(dp["losses"], refs[0]["losses"])]
    stat_off, stat_tol = {}, {}
    for name, want in refs[0]["stats"].items():
        w, w2 = torch.tensor(want), torch.tensor(refs[1]["stats"][name])
        got = torch.tensor(dp["stats"][name])
        stat_off[name] = (got - w).abs().max().item()
        stat_tol[name] = max(3 * (w2 - w).abs().max().item(),
                             1e-3 * w.abs().max().item())
    bad_stats = [n for n in stat_off if stat_off[n] > stat_tol[n]]
    emit("resnet_dp", ranks=DP_RANKS, batch_per_rank=batch,
         nvidia_smi=smi_line(),
         images_per_s=DP_RANKS * batch / (step_ms / 1e3),
         median_step_ms=step_ms,
         median_sync_ms=[x["median_sync_ms"] for x in res],
         bn_allreduce_ms=[x["bn_allreduce_ms"] for x in res],
         bn_allreduce_share=[x["bn_allreduce_share"] for x in res],
         bn_allreduces_per_step=res[0]["bn_allreduces_per_step"],
         engine_cycles_per_step=[x["engine_cycles_per_step"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         losses=res[0]["losses"], digests=[x["digest"] for x in res],
         averaging={"dp": dp["losses"], "size1": [r["losses"] for r in refs],
                    "abs_err": loss_off, "tolerance": loss_tol,
                    "stats_checked": len(stat_off),
                    "stats_worst_over_tolerance": max(
                        stat_off[n] / max(stat_tol[n], 1e-30)
                        for n in stat_off),
                    "stats_failing": bad_stats[:5]})
    if len({x["digest"] for x in res}) != 1:
        fail("resnet_dp: the ranks' parameters or buffers differ")
    if any(x["losses"] != res[0]["losses"] for x in res):
        fail("resnet_dp: the ranks' mean losses differ")
    losses = res[0]["losses"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"resnet_dp: implausible losses {losses}")
    if any(o > t for o, t in zip(loss_off, loss_tol)) or bad_stats:
        fail(f"resnet_dp: averaged run off the size-1 run: losses "
             f"{loss_off} (tolerance {loss_tol}), stats {bad_stats[:5]}")


# --- the packed train state (models/packing.py) ---

PACKED_TURNS = (False, True, True, False)  # unpacked a, packed b: a b b a
PACKED_WARMUP, PACKED_TIMED = 2, 10
PACKED_HOST_REPS = 20  # host clocks of the views and of a forward's issue
PACKED_LOSS_RTOL = 0.02  # bf16 losses against the unpacked run's, per step
# tests/test_models.py::test_packed_train_step_bit_identical's shape; the
# 3 x 3 stem's ResNet-18 enters the image step's table for the check only.
PACKED_F32 = dict(model="resnet18_small", batch=4, image=32, num_classes=10,
                  dtype=torch.float32)
PACKED_F32_STEPS = 3
PACKED_F32_RTOL, PACKED_F32_ATOL = 1e-5, 1e-6


def small_stem():
    """``IS.MODELS`` with ``PACKED_F32``'s ResNet-18 (``small_inputs``)
    as ``resnet18_small``, for the duration of a ``with``."""
    from unittest import mock

    from horovod_tpu_torch import models as M

    return mock.patch.dict(IS.MODELS, {"resnet18_small": functools.partial(
        M.ResNet18, small_inputs=True)})


def _host_ms(fn, reps=PACKED_HOST_REPS):
    """The median host-clock ms of ``fn()``, the card idle before each."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def _packed_run(packed, profile=False):
    """``RESNET_HEADLINE`` through the image step on this process, packed
    or not: the losses, step ms (host clock around ``step(...).item()``),
    images/s of this rank, the ms in ``synchronize`` and the engine cycles
    a step, the tensors ``DistributedOptimizer`` hooks and the aux tensors
    averaged a step, a digest of the final state; the host ms of one
    training forward's issue (``fwd_issue_ms``, the card idle first: for
    the packed module the views and ``functional_call``'s swap of 213
    names included) and of the views alone; with ``profile`` one traced
    step's kernel ms by class."""
    headline = IS.RESNET_HEADLINE
    net, step, data = IS.build_image_step(**headline, packed=packed)
    hooked = sum(p.requires_grad for g in step.optimizer.param_groups
                 for p in g["params"])
    norms = norm_mod.batch_norms(net)
    losses, step_ms, sync_ms, cycles = [], [], [], []
    for i in range(PACKED_WARMUP + PACKED_TIMED):
        t0 = time.perf_counter()
        losses.append(step(data).item())
        if i >= PACKED_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            sync_ms.append(step.train_step.sync_sec[-1] * 1e3)
            cycles.append(len(set(step.optimizer.last_ticks)))
    torch.cuda.synchronize()
    digest = params_digest(net)
    med = statistics.median(step_ms)
    res = {"packed": packed, "losses": losses, "step_ms": step_ms,
           "median_step_ms": med,
           "images_per_s": headline["batch"] / (med / 1e3),
           "median_sync_ms": statistics.median(sync_ms),
           "engine_cycles_per_step": cycles, "hooked_tensors": hooked,
           "aux_tensors": 1 if packed else 2 * len(norms), "digest": digest,
           "fwd_issue_ms": _host_ms(lambda: net(data[0])),
           "views_ms": _host_ms(net.views) if packed else None}
    if profile:
        prof = trace_steps(step, data, 1, os.path.join(
            OUT_DIR, f"packed_trace_{int(packed)}.json"), image_category,
            keep_trace=False)
        res["kernel_ms_per_step"] = prof["kernel_ms_per_step"]
        res["optimizer_kernel_ms"] = prof["kernel_ms_per_step"].get(
            "optimizer", 0.0)
    del net, step, data
    torch.cuda.empty_cache()
    return res


def packed_f32_run(packed, device=None, rows=None):
    """``PACKED_F32_STEPS`` steps of ``PACKED_F32`` (on ``rows`` of its
    batch, one batch for every worker, where given): the losses and the
    final parameters and statistics by the model's own names, on the
    CPU."""
    with small_stem():
        net, step, data = IS.build_image_step(device, **PACKED_F32,
                                              packed=packed, rows=rows)
    losses = [step(data).item() for _ in range(PACKED_F32_STEPS)]
    state = (net.unpacked_state_dict() if packed else net.state_dict())
    return losses, {k: v.detach().cpu().clone() for k, v in state.items()}


def packed_f32_pair(rows=None):
    """``packed_f32_run`` unpacked and packed, cuDNN deterministic."""
    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        return {packed: packed_f32_run(packed, rows=rows)
                for packed in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark


def packed_f32_worst(a, b):
    """The largest ``|x - y| / (atol + rtol |y|)`` over the losses and
    every element of every tensor (pass at <= 1): ``x`` of the packed run
    ``b``, ``y`` of the unpacked run ``a``; and the losses' own."""
    (la, sa), (lb, sb) = a, b
    loss = max(abs(x - y) / (PACKED_F32_RTOL * abs(y))
               for x, y in zip(lb, la))
    if set(sa) != set(sb):
        return loss, float("inf")
    state = max(((sb[k].double() - sa[k].double()).abs()
                 / (PACKED_F32_ATOL + PACKED_F32_RTOL
                    * sa[k].double().abs())).max().item() for k in sa)
    return loss, state


def _packed_summary(runs, f32):
    """The turns' figures side by side, the bf16 losses' worst relative
    distance per pair, the float32 check's worst ratios."""
    a = [r for r in runs if not r["packed"]]
    b = [r for r in runs if r["packed"]]
    off = [max(abs(x - y) / abs(y) for x, y in zip(rb["losses"],
                                                   ra["losses"]))
           for ra, rb in zip(a, b)]
    loss_worst, state_worst = packed_f32_worst(f32[False], f32[True])
    both = {k: {"unpacked": [r[k] for r in a], "packed": [r[k] for r in b]}
            for k in ("median_step_ms", "images_per_s", "median_sync_ms",
                      "fwd_issue_ms")}
    both.update({k: {"unpacked": a[0][k], "packed": b[0][k]}
                 for k in ("hooked_tensors", "aux_tensors")})
    both["views_ms"] = [r["views_ms"] for r in b]
    return {**both, "bf16_loss_rel_err": off,
            "f32": {"losses": {"unpacked": f32[False][0],
                               "packed": f32[True][0]},
                    "loss_worst": loss_worst, "state_worst": state_worst,
                    "tensors": len(f32[False][1])}}


def _hold_packed(where, runs, summary):
    for r in runs:
        losses = r["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{where}: non-finite loss {losses}")
        if abs(losses[0] - math.log(1000)) > 1.5 or losses[-1] >= losses[0]:
            fail(f"{where}: implausible losses {losses}")
    off = summary["bf16_loss_rel_err"]
    if any(o > PACKED_LOSS_RTOL for o in off):
        fail(f"{where}: bf16 losses off the unpacked run's by {off}")
    hooked = summary["hooked_tensors"]
    if hooked["packed"] >= hooked["unpacked"]:
        fail(f"{where}: {hooked} hooked tensors")
    f32 = summary["f32"]
    if f32["loss_worst"] > 1 or f32["state_worst"] > 1:
        fail(f"{where}: float32 ResNet-18 packed against unpacked over "
             f"the bounds: losses {f32['loss_worst']}, state "
             f"{f32['state_worst']}")


def rank_packed_dp():
    """One rank of ``packed``'s data-parallel part: the turns of
    ``_packed_run`` on this rank's own batch, then the float32 pair on
    rows [2r, 2r + 2) of ``PACKED_F32``'s batch."""
    hvdt.init(device=DP_DEVICE)
    r, n = hvdt.rank(), hvdt.size()
    runs = [_packed_run(packed) for packed in PACKED_TURNS]
    per = PACKED_F32["batch"] // n
    f32 = packed_f32_pair(slice(r * per, (r + 1) * per))
    rank_result(rank=r, size=n, runs=runs,
                summary=_packed_summary(runs, f32),
                f32_digests=[state_digest(f32[p][1]) for p in (False, True)])
    hvdt.shutdown()


def phase_packed():
    """``packed``: see the module's docstring."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    hvd.init()
    try:
        runs = [_packed_run(packed, profile=i < 2)
                for i, packed in enumerate(PACKED_TURNS)]
        f32 = packed_f32_pair()
    finally:
        hvd.shutdown()
    summary = _packed_summary(runs, f32)
    t_dp = time.perf_counter()
    dp = sorted(run_ranks("packed_dp", timeout=300), key=lambda x: x["rank"])
    a = [r for r in runs if not r["packed"]]
    b = [r for r in runs if r["packed"]]
    emit("packed", nvidia_smi=smi_line(), model=IS.RESNET_HEADLINE["model"],
         batch=IS.RESNET_HEADLINE["batch"],
         image=IS.RESNET_HEADLINE["image"], warmup=PACKED_WARMUP,
         timed=PACKED_TIMED, turns=["b" if p else "a" for p in PACKED_TURNS],
         runs=runs, size1=summary,
         optimizer_kernel_ms={"unpacked": a[0]["optimizer_kernel_ms"],
                              "packed": b[0]["optimizer_kernel_ms"]},
         bf16_loss_rtol=PACKED_LOSS_RTOL,
         f32_shape={k: str(v) for k, v in PACKED_F32.items()},
         dp={"ranks": len(dp), "device": DP_DEVICE,
             "summary": [x["summary"] for x in dp],
             "runs": [x["runs"] for x in dp],
             "seconds": time.perf_counter() - t_dp},
         seconds=time.perf_counter() - t_phase)
    _hold_packed("packed", runs, summary)
    for x in dp:
        _hold_packed(f"packed dp rank {x['rank']}", x["runs"], x["summary"])
    for i in range(len(PACKED_TURNS)):
        if len({x["runs"][i]["digest"] for x in dp}) != 1:
            fail(f"packed dp turn {i}: the ranks' states differ")
        if len({tuple(x["runs"][i]["losses"]) for x in dp}) != 1:
            fail(f"packed dp turn {i}: the ranks' mean losses differ")
    if len({tuple(x["f32_digests"]) for x in dp}) != 1:
        fail("packed dp: the ranks' float32 states differ")


# --- the serving plane (ROADMAP A.8) ---

SERVE_TENANTS = ("acme", "beta", "gamma")
SERVE_REQUESTS = 24
# The first 12 requests: served in float32 at size 1 (against
# reference_decode) and over HTTP by serve_dp.
SERVE_DP_REQUESTS = 12
# bf16: every position the paged step computes held against the
# full-context forward, ||paged - full|| / ||full|| (PERF.md section 2).
SERVE_LOGIT_TOL = 0.05


def serve_traffic():
    """``(tenant, prompt, max_new_tokens)`` of the serve phase's requests,
    from ``RandomState(0)``: prompts of 4-40 tokens, every 4th of 256-768
    (bulk prefill), 8-32 new tokens each."""
    vocab = SERVE_HEADLINE["spec"].vocab
    rng = np.random.RandomState(0)
    out = []
    for i in range(SERVE_REQUESTS):
        n = int(rng.randint(256, 769) if i % 4 == 3 else rng.randint(4, 41))
        out.append((SERVE_TENANTS[i % 3], rng.randint(0, vocab, n).tolist(),
                    int(rng.randint(8, 33))))
    return out


class ServeProbe:
    """Wraps one engine's plan broadcast, step execution and decode step:
    the broadcast's wall ms and the execution's per step plan, the decode
    step's device ms (CUDA events around it), and with ``keep_logits``
    the paged logits at the positions each step computes."""

    def __init__(self, engine, keep_logits=False):
        self.plan_ms, self.execute_ms, self.logits = [], [], []
        self._events, self._plan = [], None
        execute, step, bcast = (engine._execute, engine._step_fn,
                                engine._broadcast_plan)
        self.step = step

        def timed_execute(plan):
            self._plan = plan
            t0 = time.perf_counter()
            out = execute(plan)
            self.execute_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sampled, logits = step(*args)
            end.record()
            self._events.append((start, end))
            for sp in self._plan.slots:
                if sp.n_new and keep_logits:
                    self.logits.append((sp.request_id, sp.length,
                                        logits[sp.slot, :sp.n_new].clone()))
            return sampled, logits

        def timed_broadcast(buf):
            t0 = time.perf_counter()
            wire = bcast(buf)
            if wire[0] == 1:  # OP_STEP: the broadcast a step waits for
                self.plan_ms.append((time.perf_counter() - t0) * 1e3)
            return wire

        engine._execute = timed_execute
        engine._step_fn = timed_step
        engine._broadcast_plan = timed_broadcast

    def step_device_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]


def _pcts(xs):
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def serve_run(spec, traffic, spaced, keep_logits=False):
    """Serve ``traffic`` at size 1 through ``ServingEngine`` on
    ``SERVE_HEADLINE``'s config in ``spec``'s dtype: submitted 2 ms apart
    while the loop runs (``spaced``), or all before it starts.  The launch
    counters are zeroed just before the loop starts and read when it has
    stopped.  Returns the requests, the probe, the launches and the run's
    numbers (``serve_memory``: the peak allocated from the engine's
    construction to the end of the traffic, less what was allocated
    before it); fails if a request did not complete."""
    cfg = SERVE_HEADLINE["cfg"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sch = Scheduler(cfg)
    engine = SE.ServingEngine(spec, cfg, SE.broadcast_params(
        SE.init_params(spec)), sch)
    hvd_common.metrics_reset()
    reqs = [] if spaced else [sch.submit(*t) for t in traffic]
    probe = ServeProbe(engine, keep_logits)
    loop = threading.Thread(target=engine.run, daemon=True)
    A.reset_launches()
    t0 = time.perf_counter()
    loop.start()
    if spaced:
        for t in traffic:
            reqs.append(sch.submit(*t))
            time.sleep(0.002)
    for r in reqs:
        if not r.event.wait(600) or r.error is not None:
            fail(f"serve: request {r.id} did not complete: {r.error}")
    wall = time.perf_counter() - t0
    engine.request_stop()
    loop.join(60)
    launched = dict(A.launches)
    snap = hvd_common.metrics_snapshot()["serving"]
    for r, (_, _, max_new) in zip(reqs, traffic):
        if len(r.generated) != max_new:
            fail(f"serve: request {r.id} generated {len(r.generated)} of "
                 f"{max_new} tokens")
    if snap["kv_blocks_in_use"] != 0 or snap["retired"] != len(reqs):
        fail(f"serve: blocks or requests left over: {snap}")
    device_ms = probe.step_device_ms()
    bulk = [r.id for r in reqs if any(
        e["event"] == "prefill_chunk" and e["tokens"] == len(r.prompt_ids)
        > cfg.prefill_chunk for e in r.spans)]
    numbers = dict(
        requests=len(reqs), wall_s=wall,
        generated_tokens=sum(len(r.generated) for r in reqs),
        tokens_per_s=sum(len(r.generated) for r in reqs) / wall,
        ttft_ms=_pcts([(r.t_first_token - r.t_submit) * 1e3 for r in reqs]),
        token_ms=_pcts([(r.t_done - r.t_submit) * 1e3 / len(r.generated)
                        for r in reqs]),
        occupancy=snap["occupancy"], steps=snap["steps"],
        step_device_ms_median=statistics.median(device_ms),
        plan_broadcast_ms_median=statistics.median(probe.plan_ms),
        execute_ms_median=statistics.median(probe.execute_ms),
        bulk_prefilled=len(bulk),
        serve_memory=torch.cuda.max_memory_allocated() - before)
    numbers["plan_broadcast_share"] = numbers["plan_broadcast_ms_median"] / (
        numbers["plan_broadcast_ms_median"] + numbers["execute_ms_median"])
    return reqs, probe, engine, launched, numbers


def paged_logit_errors(engine, reqs, probe):
    """Per recorded position, ||paged - full|| / ||full|| of the paged
    step's logits against the full-context forward of the request's whole
    feed (its attention is K1 on the card)."""
    by_id = {r.id: r for r in reqs}
    full = {}
    errs = []
    with torch.no_grad():
        for rid, length, got in probe.logits:
            if rid not in full:
                feed = by_id[rid].prompt_ids + by_id[rid].generated
                full[rid] = engine.model(torch.tensor([feed],
                                                      device="cuda"))[0]
            want = full[rid][length:length + got.shape[0]]
            errs += ((got - want).norm(dim=-1)
                     / want.norm(dim=-1)).tolist()
    return errs


def serve_bf16():
    """The bf16 headline run (the main path of serving) and its logits
    gate's reading: ``(numbers, launches, errors)``.  Also the decode
    step alone on a full batch of decode lanes (the step's shapes are
    fixed, so its work is the same whichever slots are live): its device
    ms behind a 100 ms sleep kernel, and its ms without one (the host's
    issue time inside)."""
    reqs, probe, engine, launched, numbers = serve_run(
        SERVE_HEADLINE["spec"], serve_traffic(), spaced=True,
        keep_logits=True)
    errs = paged_logit_errors(engine, reqs, probe)
    cfg = SERVE_HEADLINE["cfg"]
    b, nb = cfg.max_batch, cfg.max_blocks_per_seq
    args = (torch.zeros(b, cfg.prefill_chunk, dtype=torch.long,
                        device="cuda"),
            torch.ones(b, dtype=torch.long, device="cuda"),
            torch.full((b,), 512, dtype=torch.long, device="cuda"),
            torch.arange(b * nb, device="cuda").reshape(b, nb) % cfg.num_blocks)
    numbers["step_device_ms_alone"] = time_ms(
        lambda: probe.step(engine.pages, *args), iters=5, lead=100)
    numbers["step_ms_alone_host_inside"] = time_ms(
        lambda: probe.step(engine.pages, *args), iters=5, host_ahead=False)
    del engine, probe
    torch.cuda.empty_cache()
    return numbers, launched, errs


def hold_prefill_k1():
    """K1 alone at the bulk prefills' shapes (one request, 8 heads, the
    bucketed prompt lengths, head dim 64) in bf16 and float32 against its
    plain version, and its time beside them at 768 in bf16."""
    rows = []
    for seq in (256, 512, 768):
        for dtype in (torch.bfloat16, torch.float32):
            _, qr, k, v, _, _, scale_r = kernel_inputs((1, 8, seq, 64),
                                                       dtype, seq)
            errs = kernel_check.hold_fwd(qr, k, v, scale_r, True)
            rows.append({"seq": seq, "dtype": str(dtype), "errors": errs})
            if max(e["worst"] for e in errs.values()) > 1.0:
                fail(f"serve: K1 disagrees with its plain version at "
                     f"prefill shape {seq} {dtype}: {errs}")
    _, qr, k, v, _, _, scale_r = kernel_inputs((1, 8, 768, 64),
                                               torch.bfloat16, 1)
    timing = {
        "ms": time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, True)),
        "plain_ms": time_ms(lambda: A._blockwise_fwd_impl(
            qr, k, v, True, scale_r,
            block_size=A.fwd_key_tile(torch.bfloat16, 64)),
            warmup=1, iters=5),
        "bound_ms": bound_ms(4 * 64 * causal_pairs(768, 768, True) * 8,
                             4 * 8 * 768 * 64 * 2 + 8 * 768 * 4,
                             torch.bfloat16)[0]}
    return rows, timing


def phase_serve():
    """The serving plane at size 1 on the card (``SERVE_HEADLINE``):
    the bf16 traffic and its logits gate, K1 held at the prefill shapes,
    then the first 12 requests in float32 against ``reference_decode``.
    Returns the bf16 run's launches and the float32 tokens."""
    hvd.init()
    numbers, launched, errs = serve_bf16()
    want = {"flash_fwd": launched["flash_fwd"], "flash_bwd": 0,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    k1_rows, k1_timing = hold_prefill_k1()
    f32 = dataclasses.replace(SERVE_HEADLINE["spec"], dtype="float32")
    traffic = serve_traffic()[:SERVE_DP_REQUESTS]
    reqs, _, engine, _, f32_numbers = serve_run(f32, traffic, spaced=False)
    tokens = [r.generated for r in reqs]
    refs = [SE.reference_decode(engine.model, p, n) for _, p, n in traffic]
    del engine
    torch.cuda.empty_cache()
    hvd.shutdown()
    same = [a == b for a, b in zip(tokens, refs)]
    emit("serve", nvidia_smi=smi_line(), bf16=numbers, launches=launched,
         logits={"positions": len(errs), "max_rel_err": max(errs),
                 "median_rel_err": statistics.median(errs),
                 "tolerance": SERVE_LOGIT_TOL},
         k1_prefill=k1_rows, k1_prefill_768_bf16=k1_timing,
         float32={**f32_numbers, "identical_to_reference_decode": same})
    if launched != want or not launched["flash_fwd"]:
        fail(f"serve: launched {launched}, want K1 > 0 and no backward")
    if max(errs) > SERVE_LOGIT_TOL:
        fail(f"serve: bf16 paged logits off the full forward by "
             f"{max(errs)} > {SERVE_LOGIT_TOL}")
    if not all(same) or f32_numbers["bulk_prefilled"] < 2:
        fail(f"serve: float32 tokens against reference_decode {same}, "
             f"{f32_numbers['bulk_prefilled']} bulk")
    return launched, tokens


def _http(port, path, body=None, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _serve_dp_client(out):
    """Rank 0's HTTP client: the first 12 requests over the front door,
    2 ms apart, then the drain."""
    while serve_server.server_port() is None:
        time.sleep(0.05)
    port = serve_server.server_port()
    base = _http(port, "/v1/stats")["cache"]["engine"]
    results = {}

    def post(i, tenant, prompt, max_new):
        results[i] = _http(port, "/v1/generate", {
            "tenant": tenant, "prompt_ids": prompt,
            "max_new_tokens": max_new})

    threads = []
    t0 = time.perf_counter()
    for i, t in enumerate(serve_traffic()[:SERVE_DP_REQUESTS]):
        threads.append(threading.Thread(target=post, args=(i, *t)))
        threads[-1].start()
        time.sleep(0.002)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    cache = _http(port, "/v1/stats")["cache"]["engine"]
    hits = cache["hits"] - base["hits"]
    misses = cache["misses"] - base["misses"]
    out.update(tokens=[results[i]["tokens"] for i in range(len(results))],
               hits=hits, misses=misses, hit_rate=hits / max(hits + misses, 1),
               tokens_per_s=sum(len(r["tokens"]) for r in results.values())
               / wall)
    _http(port, "/shutdown", {})


def rank_serve_dp():
    """One rank of ``serve_dp``: the serving entry point's ``serve()`` in
    float32 at ``SERVE_HEADLINE``'s widths on cuda:0, the front door on a
    free port; a digest of the pages after the drain, trash block aside
    (lanes that land there may collide, and which write wins is not
    fixed; nothing reads it as context)."""
    spec = dataclasses.replace(SERVE_HEADLINE["spec"], dtype="float32",
                               device="cuda:0")
    cfg = dataclasses.replace(SERVE_HEADLINE["cfg"], port=0)
    out, client = {}, None
    if os.environ.get("HVD_TPU_RANK") == "0":
        client = threading.Thread(target=_serve_dp_client, args=(out,),
                                  daemon=True)
        client.start()
    engine = serve(spec, cfg)
    if client is not None:
        client.join(60)
        if "tokens" not in out:
            fail("serve_dp: the HTTP client did not finish")
    digest = hashlib.sha256(engine.pages[:, :, :-1].contiguous().cpu().view(
        torch.uint8).numpy()).hexdigest()
    rank_result(rank=hvdt.rank(), digest=digest,
                max_memory_allocated=torch.cuda.max_memory_allocated(), **out)
    hvdt.shutdown()


def phase_serve_dp(f32_tokens):
    """Two ranks of the port's runner serving on this card in float32;
    rank 0's front door takes the first 12 requests over HTTP.  The
    tokens must equal the size-1 float32 run's, the pages' digest must be
    one across ranks, and the negotiation cache must hit >= 0.9 of the
    serve window's collectives.  Float32, because a long prompt's route
    follows arrival timing (bulk, or chunked when another prompt took its
    step's one bulk slot), and in bf16 the two routes round differently
    enough to flip a near-tie greedy token; in float32 they agree to
    ~1e-6."""
    torch.cuda.empty_cache()
    res = run_ranks("serve_dp", timeout=600)
    r0 = next(x for x in res if x["rank"] == 0)
    same = [a == b for a, b in zip(r0["tokens"], f32_tokens)]
    emit("serve_dp", ranks=DP_RANKS, nvidia_smi=smi_line(),
         requests=len(r0["tokens"]), tokens_per_s=r0["tokens_per_s"],
         hits=r0["hits"], misses=r0["misses"], hit_rate=r0["hit_rate"],
         digests=[x["digest"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         identical_to_size1=same)
    if len(r0["tokens"]) != SERVE_DP_REQUESTS or not all(same):
        fail(f"serve_dp: tokens differ from the size-1 run's: {same}")
    if len({x["digest"] for x in res}) != 1:
        fail("serve_dp: the ranks' KV pages differ")
    if r0["hit_rate"] < 0.9:
        fail(f"serve_dp: negotiation cache hit rate {r0['hit_rate']}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # The engine (g++) builds beside the kernels (nvcc).
    engine = {}

    def build_engine():
        try:
            engine["path"] = engine_build.build()
        except BaseException as exc:
            engine["error"] = exc

    engine_thread = threading.Thread(target=build_engine)
    engine_thread.start()
    t0 = time.perf_counter()
    info = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": v["seconds"], "cached": v["cached"]}
                  for k, v in info.items()})
    engine_thread.join()
    if "error" in engine:
        raise engine["error"]
    symbols = engine_build.exported_symbols(engine["path"])
    foreign = [x for x in symbols if not x.startswith("hvd_tpu_")]
    emit("engine", seconds=engine_build.build_info["seconds"],
         cached=engine_build.build_info["cached"],
         library=os.path.basename(engine["path"]), exported=len(symbols),
         not_c_api=foreign)
    if foreign or not symbols:
        fail(f"the engine exports {len(foreign)} symbols beyond its C API: "
             f"{foreign[:10]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for k, v in info.items():
            f.write(f"== {k}\n{v['log']}\n")

    entries = phase_kernels()
    model = phase_model()
    f32_launched = {"flash_fwd_f32": model["flash_fwd"],
                    "flash_bwd_f32": model["flash_bwd"]}
    launched, train = phase_train()
    fused_launched = phase_fused_loss(train)
    split, split_entries, split_f32 = phase_split()
    f32_launched["flash_bwd_dkdv_f32"] = split_f32["flash_bwd_dkdv"]
    f32_launched["flash_bwd_dq_f32"] = split_f32["flash_bwd_dq"]
    entries.update(split_entries)
    wide_entries = phase_head_dims()
    ring_entries = phase_ring_kernels()
    phase_ring_model()
    launched.update(phase_ring_train())
    phase_collectives()
    dp_launched, dp_step_ms, dp_res = phase_train_dp()
    phase_compression(dp_res, dp_launched)
    phase_autotune(dp_res)
    ring_dp_launched = phase_ring_dp()
    phase_timeline(dp_step_ms)
    metrics_launched = phase_metrics(dp_step_ms, dp_res)
    phase_checkpoint()
    elastic_launched = phase_elastic()
    topo_launched, size1_reference = phase_topology()
    phase_chaos(dp_res, size1_reference)
    phase_subset(dp_step_ms, dp_res, size1_reference)
    pipe_entries, pipe_launched = phase_pipeline()
    pipe_dp_launched = phase_pipeline_dp()
    phase_image_models()
    phase_resnet()
    phase_resnet_dp()
    phase_packed()
    serve_launched, f32_tokens = phase_serve()
    phase_serve_dp(f32_tokens)
    entries.update(ring_entries)
    for name_, e in entries.items():
        # K2 and K3 run on the split path, the f32 rows on the float32
        # paths (the model phase's, the split phase's at 65,600
        # batch-heads), every other kernel on the main path or the ring
        # path.
        e["launches"] = (split if name_ in ("flash_bwd_dkdv", "flash_bwd_dq")
                         else f32_launched if name_ in f32_launched
                         else launched)[name_]
    for name_ in ("flash_fwd", "flash_bwd"):
        entries[name_]["launches_train_dp_per_rank"] = dp_launched[name_]
        entries[name_]["launches_metrics_per_rank"] = [
            x[name_] for x in metrics_launched]
        entries[name_]["launches_pipeline_per_rank"] = pipe_launched[name_]
        entries[name_]["launches_pipeline_dp_per_rank"] = \
            pipe_dp_launched[name_]
        entries[name_]["pipeline_shape"] = {
            "shape": list(PIPE_MICRO),
            **{k: pipe_entries[name_][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_by_backend", "max_abs_err")}}
    entries["flash_fwd"]["launches_serve"] = serve_launched["flash_fwd"]
    for name_ in ("flash_fwd", "flash_bwd"):
        entries[name_]["launches_elastic_per_rank"] = {
            slot: x[name_] for slot, x in sorted(elastic_launched.items())}
    for name_ in ("flash_fwd", "flash_bwd"):
        entries[name_]["launches_fused_loss"] = fused_launched[name_]
        entries[name_]["launches_topology_per_rank"] = [
            x[name_] for x in topo_launched]
    for name_ in ("ring_flash_fwd", "ring_flash_bwd", "phase_closer"):
        entries[name_]["launches_ring_dp_per_rank"] = ring_dp_launched[name_]
    # The rows of head dims 256 and above carry the launches of the
    # head_dims phase's path.
    entries.update(wide_entries)
    for name_, e in entries.items():
        if not e["launches"]:
            fail(f"{name_} was not launched on its path")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


RANK_PHASES = {"collectives": rank_collectives, "train_dp": rank_train_dp,
               "compression": rank_compression, "autotune": rank_autotune,
               "ring_dp": rank_ring_dp,
               "timeline": rank_timeline, "metrics": rank_metrics,
               "metrics_crash": rank_metrics_crash,
               "checkpoint": rank_checkpoint,
               "elastic": rank_elastic, "topology": rank_topology,
               "chaos": rank_chaos,
               "chaos_partition": rank_chaos_partition,
               "resnet_dp": rank_resnet_dp, "serve_dp": rank_serve_dp,
               "subset": rank_subset, "packed_dp": rank_packed_dp,
               "pipeline": rank_pipeline, "pipeline_dp": rank_pipeline_dp}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        RANK_PHASES[sys.argv[2]]()
    else:
        main()
