"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the serving and training paths from
   veles_tpu_torch/ops/csrc with nvcc (sm_90a), all sources at once
   (ptxas's spill bytes for K1, K3 and K4 reported),
   then hold each kernel (K1 paged attention at the burst's lengths and
   at lopsided ones, one slot of 1100 positions beside seven of 0, each
   call twice bit for bit, with its plan printed, K2 the W8A16 product at
   8, 100 and 256 rows, each call twice bit for bit, and one decode
   step's 17 launches replayed from a CUDA graph, K3 int8-KV paged
   attention at the burst's and the lopsided lengths and in heads of
   256, each call twice bit for bit, with its plan printed, K4 dense
   int8-KV attention, on a slab view cut to a span too, twice bit for
   bit, with its plan printed; K1 and K3 also at every head width of
   C4_WIDTHS (8 to 1024, an odd one among them) in 4 heads, K1 in f32
   and bf16 pools and queries, K3 in both query types, each twice bit
   for bit; K1, K3 and K4 at C5_WIDTHS past 1024 (K4 at C5_K4_WIDTHS)
   alike, each timed at D = 2048 beside its byte bound; K1, K3 and K4
   also timed alone by
   torch.profiler, without the events' launch overhead; K5 the
   blocked GEMM at the weight-gradient and grad_x shapes of the wide
   MLP, K6 the fused dense layer at its forward shape, both in bf16 and
   f32 operands, K6 in each activation and at AlexNet's 1000-way head
   with the knobs on, (512, 4096, 1000); K7 the
   flash-attention forward at a ragged serving prefill, bf16 and f32,
   and at the long-context training shape (1, 8192, 8, 128) bf16, K8 and
   K9 its dK/dV and dQ backward at both (bf16); K7, K8 and K9 also at the
   wider heads the flash rule admits, (1, 4096, 4, 256) and (1, 4096, 2,
   384) causal bf16, and f32 K7 at 256; K7, K8 and K9's f32 route
   (3xTF32) at (1, 8192, 4, 128) and (1, 4096, 8, 256) causal, within
   1e-5 (K7) and 1e-4 row by row, its time at the first shape beside
   SDPA's f32 forward and backward and the bounds at 67 TFLOP/s f32 and
   165 TFLOP/s 3xTF32) against its plain PyTorch version
   at the path's shapes, and time kernel, plain version and the nearest
   PyTorch library call with CUDA events (L2 flushed before every timed
   launch, median of 25); then one attention() call at 4096 positions
   with 256-wide heads, which must launch K7 once;
3. GenerateAPI at the full width of the repo's serving model (embed
   1024, 16 heads, 4 blocks, vocab 32768, bf16, paged pool of 128-token
   pages, 8 slots) answers 8 concurrent HTTP requests in the float, int8
   and int8-KV tiers; the kernels' launch counters, zeroed before each
   run and read after it, show each run went through its kernels (K2 at
   least 17 times a decode step in both int8 tiers);
4. the repo's shared-prompt traffic (a two-page system prompt, eight
   tails behind it, the system prompt twice more) through GenerateAPI:
   /healthz must count one cold admission, eight tails and two hits;
   then cold against hit admission time on the same decoder;
5. the repo's continuous-serving traffic (bench.py:1044-1121: 16
   prompts of 512 tokens, a budget of 64, chunks of 64, half the
   requests up front and the rest joining one per lag-1 pass) through
   ContinuousDecoder on the dense slot slab, the JAX package's default
   tier, in the float, int8 and int8-KV tiers: a warm run, then a
   measured one whose counters must show K4 (and K2) in the int8-KV
   tier, K2 in the int8 tier and no attention kernel in the float tier;
6. the serving and shared-prompt configurations, and GenerateAPI on the
   dense slab in each tier, in float32 stream the same greedy tokens as
   the port's dense reference decode (on the card for float weights, on
   the CPU for the int8 tiers, where the card would run K2 and K4), up
   to the first step where the reference's top-2 logit gap is below
   1e-3; then per-request sampling: 8 sampled requests (temperature 0.8,
   top-k 50) to ContinuousDecoder at the serving model's width, in
   float32, each request's stream served alone (same request id, another
   slot) equal to its stream in the burst and to generate(batch=1,
   key=request_key(seed, request id)), and the same burst through
   GenerateAPI's HTTP front with temperature and top-k on the API, each
   stream equal to the decoder's for its request id; and, between the
   two, the paged
   pool in heads of 48 (embed 768 = 16 x 48, the serving model's depth
   and vocabulary, f32 weights, float and int8-KV tiers, 8 requests x 16
   tokens) against the dense reference in every compared step; then the
   survival layer at the serving model's width: the circuit breaker in
   the paged float (K1), paged int8-KV (K3) and dense int8-KV (K4 + K2)
   tiers (the shared-prompt mix, a chaos monkey failing one step, the
   mix again with clients retrying: every request 200, /readyz 200, the
   cached prompts hits over the restored pages, the tier's attend
   kernel launched by the rebuilt decoder; trip-to-ready ms by part,
   pages and bytes restored), the paged float tier in f32 after a trip
   against a fault-free run (every stream equal), and the int8 tier's
   live weight swap with a burst in flight (no reply but 200, the burst
   on the old weights, later streams equal a fresh API on the new ones,
   rollback, a NaN checkpoint refused);
7. training: MLPWorkflow over the bench's MNIST-shaped data (60000 x
   784, 10000 valid / 50000 train), 3 epochs at lr 0.03 — the wide MLP
   (784 -> 4096 tanh -> 10, minibatch 4096) with the engine knobs
   use_pallas and pallas_epilogue on (the main path: its counters must
   show K6 once per train and eval minibatch and K5 once per train
   minibatch), then off, off and on again (both orders on one card),
   and the reference MNIST784 configuration (784 -> 100 -> 10,
   minibatch 100); images/s, per-epoch train loss and validation
   errors;
8. one epoch of the wide MLP at precision level 2 (K5 and K6 on f32
   operands) on the card and on the CPU from the same weights: equal
   index streams, per-minibatch errors and final weights within the
   stated tolerances;
9. long prompts: GenerateAPI on the dense slab, bf16, at the serving
   model's width with longctx_device's 8 heads of 128 answers three
   requests at once (prompts of 8192, 6000 and 4096 tokens): each
   prefill launches K7 once per block; then a 4096-token prompt in
   float32 on the card (K7 in f32) against the reference decode on the
   CPU, greedy tokens equal up to the first small top-2 gap;
10. long-context training, the main path of K7, K8 and K9:
   StandardWorkflow with transformer_device's pre-LN stack (4 x
   [layer_norm, residual causal self-attention, layer_norm, residual gelu
   FFN]) at longctx_device's width (embed 1024, 8 heads of 128, 8192
   positions, minibatch 1), a 16-class softmax head, 2 epochs: the
   counters must read K7 once per block per train and valid minibatch,
   K8 and K9 once per block per train minibatch; tokens/s, per-epoch
   loss and validation errors, and the share of the run in K7-K9;
11. transformer_device at its own full width (batch 16, 512 positions,
   16 heads of 64, 256 classes): the plain attention route, no kernel;
12. one epoch of one such block at 4096 positions (embed 256, 2 heads of
   128) on the card (K7-K9) and on the CPU (plain versions) from the
   same weights: equal index streams and per-minibatch errors, every
   weight within 1e-2 of its leaf's largest;
13. (run after phase 8) AlexNet-227 (bench.py:777-817: single tower, 1000
   classes, 1000 valid / 2000 train RandomState(0) pixels, mean_disp,
   level 0): minibatch 128 with the engine knobs at their defaults, 3
   epochs, then minibatch 512 with use_pallas and pallas_epilogue on (the
   main path of K6 forward and K5 backward at its three dense layers,
   counters zeroed before it) and off, 2 epochs each; images/s over the
   run and per epoch, every epoch's loss finite; then one epoch at level
   2 on the card and on the CPU from the same weights of AlexNet at scale
   1/8 on 67 x 67 x 3 pixels and of the digits_conv stack (maxabs
   pooling, shift1 augmentation) on 8 x 8 x 1 pixels: equal index
   streams and augmentation seeds, per-minibatch n_err within 2, every
   leaf within 1e-3 of its largest element;
14. (run after phase 8) graph mode and the lower fusion tiers: the
   reference MNIST784 on the bench data in graph mode, the segment tier
   (a host unit spliced between the forwards), the sweep tier (the same
   unit sweep-transparent) and the fused tick, 2 epochs each: images/s,
   unit firings and composite calls per epoch, the tier asserted; the wide
   MLP in graph mode with the knobs on (K5 three times a train minibatch
   and once an eval one, counted) and off, 2 epochs; one epoch at level 2
   of graph mode on the card against the fused tick on the card and
   against graph mode on the CPU (equal index streams, n_err within 2,
   every leaf within 1e-4 of its largest element);
15. (run after phase 12) the long-context stack of phase 10 in graph mode,
   1 epoch: tokens/s, K7 per block on every minibatch and again on every
   train one (GDSelfAttention's autograd recomputes the forward), K8 and
   K9 per block per train minibatch; one block at 4096 positions in graph
   mode against the fused tick on the card (phase 12's limits); then the
   Kohonen SOM (an (8, 8) grid, minibatch 256, the bench's 60000 x 784
   pixels, 2 epochs): steps/s and the quantization error per epoch, which
   must fall, and one epoch on the card against the CPU (equal winners at
   every step, weights within 1e-4 of the largest).

16. (run after phase 15) the rest of the training surface: MNIST784
   through its idx loader (four idx files, two gzipped, written from the
   bench data at MNIST's 10000 test and 60000 train rows, pixels times 255
   as uint8; samples/mnist784.py's MLPWorkflow(loader_cls=MNISTLoader),
   784 -> 100 tanh -> 10, minibatch 100, lr 0.03, moment 0.9, 3 epochs
   in the fused tick): the loader's arrays equal the written bytes, its
   class lengths [0, 10000, 60000], the train loss falls; the wide MLP
   regressed (evaluator "mse", FullBatchLoaderMSE, one-hot targets), 3
   epochs knobs on, off, off and on: K6 once per train and eval minibatch
   and K5 once per train minibatch with the knobs on (a main path of
   both), the MSE falls; the same model for one epoch in graph mode, the
   sweep tier and the segment tier (the tier asserted); one epoch of it
   at level 2 on the card against the CPU from the same weights (equal
   index streams, losses within 1e-4 relative, leaves within 1e-4 of
   their largest); the eight normalizers' analyze and apply_state on the
   bench's 60000 x 784 pixels on the card against the CPU (within 1e-5 of
   the largest); the first MNIST epoch recorded by MinibatchesSaver
   (shuffling off) and replayed through MinibatchesLoader bit for bit,
   and PicklesLoader and AutoLabelSoundFileLoader on pickles and WAV
   tones the smoke writes, their arrays equal to what was written.

17. (run after phase 16, in its directory) snapshots, the CLI, the native
   export and per-tick REST serving: ``python -m veles_tpu_torch`` runs
   A5_WORKFLOW (samples/mnist784.py's MLPWorkflow at the wide MLP's width,
   784 -> 4096 tanh -> 10, minibatch 4096, lr 0.03, moment 0.9, on phase
   16's idx files) with samples/mnist784_config.py, the knobs on, seed 1,
   3 epochs, a Snapshotter on every improved epoch and the package
   exported at 32 and 16 bits at the end: exit 0, epochs 3, the snapshot,
   its sidecar and its ``_current.lnk``, and K6 once per train and eval
   minibatch, K5 once per train minibatch (counted in the subprocess, a
   main path of both); then ``-w <prefix>_current.lnk`` to 5 epochs
   (exit 0, "resuming from", epochs 5, the same launch rule); images/s
   and the seconds spent writing and unpickling snapshots; in process,
   the wide MLP at level 2 (momentum 0.9): 2 epochs, a snapshot, an
   import onto the card and a resume to 4 against 4 uninterrupted epochs
   (phase 8's limits, velocities among the leaves); the C++ runtime
   (native/, built with g++ while nvcc runs) on the exported f32 package
   against the port's f32 forward on the card over 1000 validation rows
   (rtol 2e-3, atol 1e-5, equal argmax), the f16 package under 0.65x its
   size and within 5e-3; and RestfulLoader (derive_from, minibatch 512)
   -> the restored chain (knobs on) -> RESTfulAPI answering 64 client
   threads x 20 requests (list and base64 codecs): every reply 200 and
   within 1e-4 of its row's forward, K6 once per served tick (a main
   path); requests/s, p50 and p99 latency, rows per tick.

18. (run after phase 17) accuracy parity, the digits samples and the
   autotune (the phases before it run with the tuning cache pointed at
   a fresh empty file, so no verdict moves their launches): the
   committed digits read without scikit-learn (both layouts' shapes, the
   canonical split's SHA-256); ``python -m veles_tpu_torch parity`` on
   the card, exit 0 and each family within its bound (3.0% / 0.7% /
   0.7%), its error, epochs, best epoch, seconds and images/s printed;
   beside it, digits_mlp, transformer_digits and som_digits through the
   CLI at once, each exit 0 (parity and the samples start before phase
   16 and run beside phases 16 and 17, whose checks read no clock; their
   seconds and images/s are read under that load); ``python -m
   veles_tpu_torch autotune`` for the wide
   MLP's K6 and K5 products and AlexNet's head (GEMM), the serving
   model's qkv prefill at M = 256 and its five decode products at M = 8
   (``--int8``) and its page size and head width (``--paged-attention``)
   into one cache, every verdict persisted under this card's key and
   printed with the kernel's and the plain route's ms; the wide MLP for
   one epoch under ``use_pallas="tuned"`` with that cache (K6 once per
   minibatch, K5 once per train minibatch exactly where the weight
   gradient's verdict says ``beats_xla``: a main path of both); the int8
   burst with no verdicts and under them (every product on the route its
   ``int8:`` verdict names, K2's launches equal to the products routed to
   it: a main path of K2; the streams equal, or the prefill logits within
   K2's bound); and ``device_benchmark``'s power.

19. (run after phase 18; phases 2-18 run with every observe plane off:
   the serving fronts' ``enable_metrics`` is held off and the flight ring
   is off) the observe plane at the serving model's width: the paged
   int8 (K1 + K2) and int8-KV (K3 + K2) bursts, 8 x 32 tokens, every
   POST carrying ``X-Veles-Trace``, with metrics, tracing (events to a
   JSONL file) and the flight ring on; ``/metrics`` as text and as
   OpenMetrics: the request and token counters exact, the device memory
   in use at least the weights plus the KV pool, the bf16 peak the card's
   (989 TFLOP/s on an H100 SXM), the dispatch's MFU in (0, 1.05], the
   kernel builds of K1's, K2's and K3's sources, the TTFT exemplars among
   the trace ids sent; the JSONL exported by ``python -m veles_tpu_torch
   observe export-trace``, every request one tree from ``serve.request``
   through its admission to a ``paged.dispatch`` and a
   ``decode.collect``, with the median host ms per span name; an int8
   burst in ``profile_window``, K1's and K2's kernels under
   ``paged.dispatch`` in its Chrome trace; the breaker phase's fault, a
   ``breaker_trip`` black box that ``observe blackbox`` reads (exit 0)
   with the trip note, the dispatch notes and spans; the int8 burst with
   the planes as ``start()`` leaves them, all off and traced (one run
   each: tokens/s printed, K1 and K2 launches a decode step equal); and the wide MLP through the CLI with
   ``--trace-events`` (knobs on, 1 epoch: a ``unit.run`` span for every
   firing of every unit) and, started beside it, again killed by SIGTERM
   after its first span (a ``sigterm`` black box, the previous handler
   ran). Phases 2-18
   also hold the serving hooks off (the request ledger, the serve scope,
   memscope's edges), and phase 19 runs without a metric history.

20. (run after phase 19) the observe plane's serving hooks at the serving
   model's width: the paged int8 burst (K1 + K2, 8 x 32 tokens) through
   HTTP inside the profiler window, every POST with a trace id and one
   of two tenants, the objectives ttft_p95_ms, tpot_p95_ms=0.5 (out of
   reach on this host-bound path) and availability=0.999, the metric
   history sampling every 0.2 s with a tight rule pair: every
   ``/debug/requests`` row holds the whole waterfall, its tenant and
   trace, live dispatches equal to the decoder's count for its request
   and 32 chunk tokens; ``veles_slo_*`` carry both tenants, tpot burns,
   availability holds at 1.0; the serve scope's ``tile_pad``,
   ``dead_slot``, ``discard`` and useful decode tokens equal counts from
   the request lengths (``group_dup`` and ``page_overshoot`` 0); the
   wall decomposition printed beside the card's kernel time in the
   profile (the busy share); ``/debug/history`` serves the latency
   series and an incident names ``veles_serving_latency_ms`` leading
   ``slo_burn``; ``observe slo --live``, ``observe serve-trace`` (one row
   per slot used) and ``observe incident`` exit 0. The dense int8-KV
   slab (K4 + K2) driven directly: ``span_overshoot`` against its count
   from the lengths. memscope in a fresh process (the parent's allocator
   holds the earlier phases): ``params``, ``kv_pool`` and
   ``decode_state`` equal counts from the widths, the untagged residue
   printed; a trip and rebuild and a hot swap give no verdict, a second
   trip while a reference holds the old pool and its state gives one
   naming ``kv_pool`` and a black box ``observe blackbox`` reads. Then
   the int8 burst in ``scripts/observe_cost.py``'s ``default``,
   ``ledger_off`` and ``history`` settings, one each after a warm-up:
   tokens/s printed, no gate; K1 4 and K2 17 launches a decode step in
   every run.

21. (run after phase 20) what acts on the hooks at the serving model's
   width, requests one at a time with prompts shorter than a page: the
   tier ladder (the paged front at bf16, ``ttft_p95_ms`` 250 over 2 s /
   8 s windows, a held 300 ms latency ramp, the governor's ladder
   int8+int8-kv with a 3 s cooldown): demote, demote, promote, promote
   and no more, one move a cooldown at most, every reply 200, every
   ledger row's quant the tier that served it (the demoted ones with
   their stage), every stream equal to a fixed-tier decoder's on the
   card, each rung's launches on its kernels (bf16 K1, int8 K1 + K2,
   int8-kv K3 + K2); the time from the first demotion to the last
   promotion and each swap's drain, build and probe printed, and any
   kernel build inside the ladder. Pressure: a pool flood past
   ``pool_high`` halves the admission bound, every 429 carries an
   integer Retry-After in [1, 60]. The breaker guard: the device-memory
   fraction below ``guard_memory_frac``, a compile storm trips the
   breaker once, the front heals with the same streams. Blue-green on the
   dense slab at int8-kv (K4 + K2), candidate weights from
   ``SWAP_SEED``, tenants picked by hash point: a clean rollout promotes
   (blue bit-equal to no deploy, green equal to the new weights, no
   ``rollout_promote`` verdict); a green ramp rolls back with nothing
   shed and an incident led by ``veles_ctrl_deploy_ttft_ms``; both walls
   printed. Record, replay, capacity and regress on the paged int8 front
   with two tenants, through ``observe``'s CLI: a trace without the
   tenants' bytes and a sidecar that verifies, a replay at x1 that
   delivers every token, a capacity report (sustained tokens/s and the
   first breaching series printed), regress 0 on itself and 1 at -15%.

22. (run after phase 21) the data-parallel mesh and the dashboards: (a)
   the wide MLP (784 -> 4096 tanh -> 10, minibatch 4096, knobs on,
   precision level 2) through ``python -m veles_tpu_torch --mesh data=2
   --coordinator ...``, two ranks on the one card over gloo (NCCL takes
   one rank per device), 2048 rows a rank, against one process stepping
   the same global minibatches from the same numpy weights: every
   epoch's validation n_err equal, every weight within DP_ATOL, each
   rank's K6 and K5 launches equal to the single run's; images/s and the
   all-reduce's share of the run printed, and which reduce tiers gloo
   ran on a CUDA tensor; (b) a world of one over NCCL in this process:
   reduce_sum's three tiers on CUDA tensors at the wide MLP's gradient
   shapes against their plain versions; (c) rank 0's WebStatusServer,
   pushed to by its launcher's StatusNotifier: the page, the state and
   /metrics with the mesh gauges and the reduce plane; (d) plotting
   without matplotlib raises naming it.
23. (run after phase 22) the training fleet, every process sharing the
   card: (a) phase 22's wide MLP, data and epochs through ``python -m
   veles_tpu_torch -l`` and one ``-m`` slave on the data plane, against
   one process from the same numpy weights: every epoch's validation
   n_err equal, every weight (the master's) and velocity (the slave's)
   within FLEET_ATOL, the slave's K6 and K5 launches equal to the single
   run's, the master's none; (b) the digits of tests/test_fleet.py's
   ``_kw(max_epochs=4)`` through a master that spawns two slaves with
   ``-n localhost,localhost`` (the second one's first job held for one
   epoch of the first's, the first then held for its first two answers):
   both take jobs, every lease done or requeued,
   the best validation n_err within the JAX test's 80 of 297;
   (c) the same digits for 2 epochs with ``--respawn``, the slave
   SIGKILLed mid-run: its lease requeued, the master respawns it
   (``python -m veles_tpu_torch -b``) and exits 0 (started before phase
   24's (a)); (d) (a) on the control plane, run beside phase 24's (b)
   and (c): (a)'s checks, per-job frames under 64 KiB and a fence sync
   each epoch. Printed: images/s a slave, each frame type's bytes both ways and whether they
   went through /dev/shm, the share of a slave's wall encoding, sending,
   waiting, decoding and in its jobs, and the master's merge ms per
   update.
24. (run after phase 23) the fleet x pod composition: phase 22's wide
   MLP, data, weights and epochs through a ``-l`` master and a pod
   slave, a world of two ``-m ... --mesh data=2 --coordinator ...``
   ranks sharing the card over gloo (rank 0 on the wire, rank 1 following
   its jobs): (a) on the data plane against phase 23's single run: every
   epoch's validation n_err equal, the weights and every rank's
   velocities within DP_ATOL, each rank's K6 and K5 launches the single
   run's, the master's none, every job handed on, the master's ignored
   ``--mesh`` warned of; then together: (b) on the control plane,
   fault-free and under tests/test_fleet_chaos.py's chaos profile on
   rank 0, the master's weights and both ranks' leaves bit-equal to a
   standalone two-rank world at the fleet's cadence (a step a minibatch,
   no sweep, no pipeline), its n_err, a fence sync an epoch, under chaos
   at least one death, duplicated update, requeue, fenced duplicate and
   rollback, every rollback handed on; (c) a pod's rank 0 SIGKILLed
   mid-run beside a single-rank slave: its lease requeued, the run
   finished on the single-rank slave, the follower out non-zero within
   the world's timeout. Printed: images/s a rank, the wire's share of
   rank 0's wall, the follower's waiting share, the bytes handed on a
   job, the phase's seconds.

25. (run after phase 24) the AOT bundle: (a) in this process, whose
   libraries are built by then, three serving bundles at the serving
   model's full width (paged int8, paged int8-KV, dense int8-KV; bytes,
   sha and build ms printed, the paged int8 one built twice to the same
   sha) and one of phase 22's wide-MLP tick (a 16384-row cut of its data,
   a step a minibatch); (b) fresh processes, each from a copy of the
   package with no ``_build/``, timed from Popen to the first token
   against ``time.time()`` stamps: cold-live (the paged int8 tier, no
   bundle: nvcc builds K1 and K2), aot in each tier (``root.common.serve.
   aot``: zero builds, every dispatch an AOT hit in the ledger and the
   bundle's stats, no miss, the tier's kernels launched, the streams of a
   first token and a warm-up of 100, 250 and 700-token prompts bit-equal
   to this process's live decoder), the tick (zero builds, three train and
   one eval step hits, the live run's n_err, K6 and K5 launched) and
   warm-live (a copy holding the built libraries: the boot's floor); each
   reading printed beside the card's name and power limit. The cold-live
   child starts before phase 23 and runs beside phases 23 and 24; the
   int8-KV tiers' children and the tick's run together.

27. (run after phase 26, rank 1 started beside it) sharded serving: the
   serving model at full width on a serving mesh of two ranks sharing
   the card over gloo (``model=2``: 8 heads, 2048 FFN columns and 16384
   vocab columns a rank; rank 0 this process, rank 1 a child that builds
   the same seeded weights and follows): K2 at every shard shape and K1,
   K3, K4 in 8 heads against their plain versions; (a) phase 4's
   shared-prompt traffic and six distinct prompts through rank 0's
   GenerateAPI over HTTP in the paged float tier on f32 weights, every
   stream and the prefix counters equal one process's, each rank's K1 4
   a decode step; (b) paged int8 (K1 + K2), paged int8-KV (K3 + K2) and
   dense int8-KV (K4 + K2) on bf16 weights through
   ContinuousDecoder(mesh=) against one process stepping a token at a
   time: the logits after the prefill within TP_BF16_LOGIT_RTOL of the
   largest, a stream leaving one process's only where its top-2 logits
   lie within two bf16 steps (each case printed), each rank's attend 4
   and K2 at least 17 a step; (c) seed-1 weights swapped onto the mesh
   from the host: a 0-byte receipt, the streams a fresh process's; (d)
   make_tp_generate at full width equal to generate's tokens on both
   ranks; (e) the governor over the mesh (rank 0's GenerateAPI on f32
   weights, its burn scripted) walks bf16 -> int8 -> int8-kv -> int8 ->
   bf16, a tier swap a move: each rung's streams equal one process's at
   that tier (the float rungs bit for bit, the int8 rungs but at near
   ties), K1 or K3 4 and K2 17 a step on both ranks (rank 1's by
   engine); (f) a blue-green rollout to seed-1 weights promoted, its
   streams one process's on them, memscope's promote edge no leak on
   either rank; (g) a rollout whose green probe is planted to fail
   refused, blue serving on unchanged; rank 1 builds an engine a swap and
   a green, discards each one replaced or refused and ends holding one;
   (h) rank 1 SIGKILLed under six clients: 503 within the world's 30 s
   timeout, nothing hangs. Printed: tokens/s of the world and of
   one process, alternated, the collectives' share of rank 0's dispatch
   time, the bytes handed on a dispatch, the phase's seconds. Both
   ranks' launches join the kernels line.

28. (run after phase 27, rank 1 started beside it) the model, seq, pipe
   and expert axes of a training mesh on two ranks sharing the card over
   gloo in one world, the mesh rebuilt for each part (rank 0 this
   process, rank 1 a child that builds the same seeded problems): K7, K8
   and K9 at a rank's Ulysses shape (1, 8192, 4, 128) and a stage's
   microbatch (1, 4096, 8, 128) and K5 at (b)'s shard shapes against
   their plain versions; (a) the main path, the sequence-parallel
   transformer step at full width (the serving stack in longctx_device's
   8 heads of 128, 8192 positions, batch 1, bf16 from RandomState(0)): 2
   steps over seq=2 with Ulysses, each rank K7, K8 and K9 4 a step, then
   2 with ring attention, none, then the same 2 steps in one process:
   both ranks' parameters bit-equal, the loss within 1e-2 relative,
   n_err within 1% of the tokens and every leaf within 1e-2 of its
   largest against one process, and ring against Ulysses alike; (b) the
   wide MLP's model-axis step over model=2 (784 -> 4096 tanh -> 10,
   minibatch 4096, use_pallas on, precision level 2, 3 steps): K5 2 a
   step on each rank, n_err equal to one process's and the leaves within
   phase 8's limit; (c) the pipeline over pipe=2, two of (a)'s blocks a
   stage at 4096 positions, 4 microbatches, MSE, remat, two steps: K7
   20, K8 and K9 10 a stage a step, the first step against
   sequential_reference's within (a)'s limits; (d) the experts over expert=2 (8 experts of 1024 x 4096, 8192
   tokens, f32): at capacity 8 nothing dropped and the forward and one
   train step against reference_moe within 2e-4 of the largest, the drop
   fraction at 2.0 printed; (e) (a)'s step in f32 over seq=2 with
   Ulysses (C11's shape: a rank attends (1, 8192, 4, 128)), each rank K7,
   K8 and K9 4 a step, all on their f32 route, and so one process's
   step, both ranks' parameters bit-equal, the loss and every leaf
   within 1e-4 of one process's f32 step. Printed: tokens/s of each run, the
   collectives' share of each rank's steps, the phase's seconds. Both
   ranks' launches join the kernels line.

29. (its children started beside phases 27 and 28) the meta-workflows on
   the card: MNIST-shaped idx files gzipped by the phase and read through
   MNISTLoader(url_base="file://...") (the downloader: the first read
   fetches and leaves an .ok marker a file, no later read fetches); (a)
   phase 22's wide MLP (784 -> 4096 -> 10, the knobs on) with its
   learning rate and momentum Range genes through ``python -m
   veles_tpu_torch ... --optimize 4:2`` (max_parallel 2, every
   evaluation a child on the card): the generations equal the port's
   Population replayed here from the same seed and fitnesses, the best
   fitness its child's -best_validation_errors, each child K6 on every
   minibatch and K5 on every train one; (b) ``--ensemble-train 3:0.8``
   then ``--ensemble-test`` of it: ensemble.json lists three instances,
   and each test child's dumped validation outputs read back through
   EnsembleLoader bit for bit. The GA's and the ensemble's training
   children's launches join the kernels line.

Phase 2's K1, K3 and K4 checks include C6: head widths 8200 to 16384 (K4
8224 to 16384) on the wide path, each timed at D = 16384 beside its byte
bound.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before printing either.
"""

import base64
import collections
import contextlib
import gc
import glob
import gzip
import hashlib
import heapq
import http.client
import io
import json
import math
import os
import pickle
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave
import zlib

import numpy
import torch

from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch import serving as serving_mod
from veles_tpu_torch.core import httpd, prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.logger import (enable_event_recording,
                                         get_event_recorder)
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.device import tree_to
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.inference import NativeWorkflow, build_native
from veles_tpu_torch.loader.base import TRAIN, VALID, Loader
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.loader.normalization import (make_normalizer,
                                                  normalizer_registry,
                                                  state_tensors)
from veles_tpu_torch.loader.pickles import PicklesLoader
from veles_tpu_torch.loader.saver import MinibatchesLoader, MinibatchesSaver
from veles_tpu_torch.loader.sound import AutoLabelSoundFileLoader
from veles_tpu_torch.models.alexnet import AlexNetWorkflow
from veles_tpu_torch.models.kohonen import KohonenWorkflow
from veles_tpu_torch.nn.kohonen import grid_coords, som_step
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn.decision import DecisionGD
from veles_tpu_torch.observe import servescope as servescope_mod
from veles_tpu_torch.observe.flight import get_flight_recorder, load_dump
from veles_tpu_torch.observe.governor import GovernorConfig, ServingGovernor
from veles_tpu_torch.observe.history import (AnomalyRule, IncidentRecorder,
                                             MetricHistory,
                                             set_metric_history)
from veles_tpu_torch.observe.memscope import get_memscope
from veles_tpu_torch.observe.metrics import get_metrics_registry
from veles_tpu_torch.observe.profile import profile_window
from veles_tpu_torch.observe.reqledger import (RequestLedger,
                                               get_request_ledger)
from veles_tpu_torch.observe.servescope import ServeScope, get_serve_scope
from veles_tpu_torch.observe.slo import SLOEngine
from veles_tpu_torch.observe.trace_export import span_tree
from veles_tpu_torch.observe.tracing import get_tracer
from veles_tpu_torch.observe.xla_stats import (get_compile_tracker,
                                               peak_tflops)
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import activations as act_lib
from veles_tpu_torch.ops.attention import (_flash_attention_dkv_plain,
                                           _flash_attention_dq_plain,
                                           _flash_attention_fwd_plain,
                                           _row_dot, attention,
                                           flash_attention_dkv,
                                           flash_attention_dq,
                                           flash_attention_fwd)
from veles_tpu_torch.ops import quant as quant_ops
from veles_tpu_torch.ops.benchmark import device_benchmark
from veles_tpu_torch.ops.gemm import (_blocked_matmul_plain,
                                      _dense_epilogue_plain, _gemm_kind,
                                      blocked_matmul, dense_epilogue,
                                      device_tag)
from veles_tpu_torch.ops._workspace import sm_count
from veles_tpu_torch.ops.paged_attention import (_paged_attend_int8_plain,
                                                 _paged_attend_plain,
                                                 _paged_plan, paged_attend,
                                                 paged_attend_int8)
from veles_tpu_torch.ops.quant import (_attend_plan, _cache_attend_plain,
                                       _int8_matmul_plain,
                                       int8_cache_attend, int8_matmul,
                                       quantize_int8)
from veles_tpu_torch.parallel.fused import forward_chain
from veles_tpu_torch.parity import digits_dataset
from veles_tpu_torch.parallel.decode import (_prefill_forward,
                                             _quantize_kv, generate,
                                             quantize_params, request_key,
                                             slot_state_bytes)
from veles_tpu_torch.parallel.kv_pool import (default_pool_pages,
                                              paged_kv_bytes)
from veles_tpu_torch.parallel.segments import FusedSegment
from veles_tpu_torch.parallel.sweep import FusedSweep
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.rollout import RolloutConfig
from veles_tpu_torch.serving import (ContinuousDecoder, GenerateAPI,
                                     RESTfulAPI, RestfulLoader, _tree_bytes)
from veles_tpu_torch.serving_chaos import (ServingChaosConfig,
                                           ServingChaosMonkey)
from veles_tpu_torch.snapshotter import SnapshotterToFile

REPO_DIR = os.path.dirname(os.path.abspath(__file__))

#: the repo's serving model at full width (bench.py:861-862)
EMBED, HEADS, BLOCKS, VOCAB = 1024, 16, 4, 32768
SLOTS, MAX_LEN, N_TOKENS, CHUNK, PAGE = 8, 1024, 32, 8, 128
#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s, and the
#: dense bf16 tensor-core peak, operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
#: K1 at the paged burst's lengths, and lopsided: one slot of 1100
#: positions beside seven of 0
K1_LENGTHS = (0, 127, 128, 300, 511, 700, 1023, 1100)
K1_LOPSIDED = (1100,) + (0,) * 7
#: K1 writes f32 from bf16 inputs that both versions widen exactly;
#: they differ only in summation order and exp over up to 1101
#: positions, far inside this bound
K1_ATOL = 2e-3
#: C4: head widths the JAX package's paged attends serve that K1 and K3
#: had no route for before (the toy models' 8 and 16, rows of 96 to 200
#: bf16 bytes, an odd width) and the widest two powers of two, held in
#: C4_HEADS heads at the burst's lengths, f32 and bf16 pools and queries
C4_WIDTHS = (8, 16, 33, 48, 80, 96, 100, 512, 1024)
C4_HEADS = 4
#: C5: head widths past 1024 the JAX package's attends serve (K4's a
#: multiple of 32: 1056 where K1 and K3 take 1025), held in C4_HEADS heads
#: in both pools and query types; C5_TIMED is timed beside its byte bound
C5_WIDTHS = (1025, 1536, 2048, 4096)
C5_K4_WIDTHS = (1056, 1536, 2048, 4096)
C5_TIMED = 2048
#: C6: head widths past 8192 the JAX package's attends serve, on the wide
#: path (q, K and V read from global memory, the split's sums in its
#: workspace row; K4's a multiple of 32), held in C4_HEADS heads in both
#: pools and query types; C6_TIMED is timed beside its byte bound
C6_WIDTHS = (8200, 12288, 16384)
C6_K4_WIDTHS = (8224, 12288, 16384)
C6_TIMED = 16384
#: the paged serving run in heads of 48: the serving model's depth and
#: vocabulary at embed 768 = 16 x 48, f32 weights, 8 requests x 16 tokens
NARROW_EMBED, NARROW_HEADS, NARROW_TOKENS = 768, 16, 16
#: K3 writes f32 from int8 codes both versions widen exactly and the
#: same f32 scales; they differ only in summation order and exp over up
#: to 1101 positions (~1e-6 of outputs of order 1)
K3_ATOL = 1e-4
#: K2 writes bf16: a one-ulp difference in the final rounding is 2^-8
#: relative, so the bound is 1e-2 of the output's largest magnitude
K2_RTOL = 1e-2
#: K4 writes f32 from int8 codes and f32 scales both versions widen
#: exactly and the same q; they differ only in summation order and exp
#: over 768 positions (~1e-6 of outputs of order 1)
K4_ATOL = 1e-4
#: the dense phase: bench.py's decode_continuous traffic (:1044-1121)
DENSE_PROMPT, DENSE_BUDGET, DENSE_REQUESTS, DENSE_CHUNK = 512, 64, 16, 64
#: two chunks of lag-1 headroom, as there (704; the int8-KV tier rounds
#: it to 768)
DENSE_MAX_LEN = DENSE_PROMPT + DENSE_BUDGET + 2 * DENSE_CHUNK
#: K4 at the dense int8-KV slab's width: ragged lengths (0, a tile
#: boundary, the last position) and the span a slot step cuts
K4_WIDTH, K4_SPAN = 768, 640
K4_LENGTHS = (0, 127, 128, 300, 511, 600, 700, 767)
#: decode-step weight shapes (K, N) and launches of each per step: the
#: four block projections per block, then the vocab head
K2_SHAPES = ((EMBED, 3 * EMBED), (EMBED, EMBED), (EMBED, 4 * EMBED),
             (4 * EMBED, EMBED), (EMBED, VOCAB))
K2_PER_STEP = (BLOCKS, BLOCKS, BLOCKS, BLOCKS, 1)
TOP2_GAP = 1e-3
#: the dense float32 rate outside the tensor cores (NVIDIA data sheet),
#: operations/s: the peak for K5's and K6's f32-operand runs
F32_OPS_PER_S = 67e12
#: f32 products in 3xTF32 on the tensor cores (three TF32 products an f32
#: product, 495 TFLOP/s TF32 dense): the ceiling of K7, K8 and K9's f32
#: route
F32_TF32X3_OPS_PER_S = 495e12 / 3
#: K5 and K6 at the training path's shapes (the wide MLP, bench.py:306:
#: 784 -> 4096 (tanh) -> 10 at minibatch 4096): (m, k, n) of the hidden
#: layer's forward (K6), its weight gradient x.T @ err (K5) and the input
#: gradient err @ w.T a deeper eligible layer would take (K5)
K6_SHAPE = (4096, 784, 4096)
K5_SHAPE = (784, 4096, 4096)
K5_GRAD_X_SHAPE = (4096, 4096, 784)
#: K5/K6 write f32 from operands both versions widen exactly; they differ
#: in summation order over up to 4096 terms (~1e-6 of outputs of order
#: 1), far inside this bound relative to the largest output. A bf16
#: output (K5's grad_x) may differ by one bf16 rounding: 2^-8 relative.
GEMM_F32_RTOL = 1e-4
GEMM_BF16_RTOL = 1e-2
#: the training phase: the wide MLP over the bench's data (bench.py:
#: 76-81, 306-356), 3 epochs at lr 0.03, and the reference MNIST784
#: configuration (bench.py:84-98)
WIDE_LAYERS, WIDE_MINIBATCH = (4096, 10), 4096
MNIST_LAYERS, MNIST_MINIBATCH = (100, 10), 100
TRAIN_EPOCHS, TRAIN_LR = 3, 0.03
BENCH_CLASS_LENGTHS = [0, 10000, 50000]
#: the training agreement: one epoch of the wide MLP at precision level
#: 2 (K5 and K6 on f32 operands) on the first 12288 rows of the bench
#: data, 4096 valid and 8192 train
AGREE_CLASS_LENGTHS = [0, 4096, 8192]
#: both sides compute in f32 with other summation orders (~1e-6
#: relative on the logits): an argmax may flip where two logits are
#: that close, so a minibatch's n_err may differ by this many samples
#: of 4096; after two SGD steps at lr 0.03 the weights differed by
#: 7.45e-9 on an H100
AGREE_N_ERR_TOL = 2
AGREE_WEIGHT_ATOL = 1e-4
#: the long-context tier: bench.py's longctx_device head layout (:573,
#: 8 heads of 128) on the serving model's depth, vocabulary and MLP
LONG_HEADS = 8
#: the long-prompt traffic: three requests at once, 32 tokens each; the
#: slab holds the longest with two chunks of lag-1 headroom
LONG_PROMPTS = (8192, 6000, 4096)
LONG_MAX_LEN = max(LONG_PROMPTS) + N_TOKENS + 2 * CHUNK
LONG_AGREE_PROMPT = 4096
#: K7, K8 and K9 at the training shape (longctx_device: batch 1, 8192
#: positions, 8 heads of 128, causal, bf16) and K7 at a ragged serving
#: prefill (2 rows of 5000 positions), as (batch, T, heads, head_dim)
FLASH_TRAIN_SHAPE = (1, 8192, LONG_HEADS, 128)
FLASH_SERVE_SHAPE = (2, 5000, LONG_HEADS, 128)
#: tolerances against the plain versions (computed in f32 from the same
#: inputs), row by row: each row (one position's head_dim values for one
#: head) may differ from its reference row by this much of that row's own
#: norm, so a late row, whose values are ~sqrt(1/T) of the first rows',
#: is held as tightly as an early one. Both sides round the output to
#: bf16 and P (and dS) to bf16 before the products; where the f32 values
#: straddle a rounding boundary an element lands one bf16 step (up to
#: 2^-7 of it) away. K7: such steps in a row of 128 -> 1e-2 (4.5e-3
#: read on an H100). K8 and K9: a late key's dK/dV (an early query's dQ)
#: is one or a few P or dS terms, each possibly a step apart, then the
#: output's own rounding -> 2e-2 (5.6e-3 read). f32 K7 differs only in
#: summation order and exp2 for exp -> 1e-5 (2.8e-6 read).
K7_RTOL, FLASH_BWD_RTOL, K7_F32_RTOL = 1e-2, 2e-2, 1e-5
#: a row whose reference norm is below this share of the median row's is
#: held against that floor: the causal first query's dQ is zero in exact
#: arithmetic (one key: P = 1 and dP = di), so both sides hold rounding
#: noise there (~1e-5 of the median). The smallest true rows, the last
#: keys' dK and dV, are ~5e-3 of the median at 8192 positions: the floor
#: at most doubles their tolerance
FLASH_ROW_FLOOR = 1e-2
#: the planted fault each flash check must see: the last 64 positions'
#: rows (one kernel tile) of the kernel's output scaled by this factor
FLASH_TILE, FLASH_FAULT = 64, 0.9
#: the wider heads the flash rule admits (head_dim % 128 == 0): K7's
#: second wgmma width and the chunked kernels' first, causal bf16, and f32
#: K7 at 256 (batch, T, heads, head_dim)
FLASH_WIDE_SHAPES = ((1, 4096, 4, 256), (1, 4096, 2, 384))
FLASH_WIDE_F32_SHAPE = (1, 4096, 4, 256)
#: K7, K8 and K9's f32 route: a rank's Ulysses attention in phase 28's
#: f32 step, (1, 8192, 4, 128) causal (timed), and (1, 4096, 8, 256); the
#: limit row by row: the f32 route sums up to 8192 terms a row in another
#: order than the plain version and dS takes the difference dP - di,
#: whose cancellation lifts a small row's relative error past K7's 1e-5
FLASH_F32_BWD_SHAPES = ((1, 8192, 4, 128), (1, 4096, 8, 256))
FLASH_F32_BWD_RTOL = 1e-4
#: the sampled serving phase: 8 requests at the serving model's width,
#: float32 weights: a request's prefill runs in a group of another size
#: alone than in the burst, so its logits differ by the products'
#: round-off, and a bf16 step (2^-8 of a logit) would flip a near-tied
#: Gumbel-max draw where f32's (2^-24) does not
SAMPLE_TEMPERATURE, SAMPLE_TOP_K, SAMPLE_SEED = 0.8, 50, 11
#: the breaker phase's tiers: (label, quantize, paged, attend kernel) —
#: the paged float pool on K1, the paged int8-KV pool on K3, the dense
#: int8-KV slab on K4 (and K2)
BREAKER_TIERS = (("paged float", None, True, "paged_attend"),
                 ("paged int8-kv", "int8-kv", True, "paged_attend_int8"),
                 ("dense int8-kv", "int8-kv", False, "int8_cache_attend"))
#: the breaker's first backoff in the smoke (the default is 0.5 s)
SMOKE_BACKOFF = 0.05
#: the hot swap's second weights: the serving model's width from
#: another seed
SWAP_SEED = 7
#: the long-context training main path: transformer_device's pre-LN stack
#: (bench.py:425-441: 4 x [layer_norm, residual causal self_attention,
#: layer_norm, residual gelu ffn ratio 4], a softmax head) at
#: longctx_device's width and length: 16 samples of (8192, 1024), 4 valid
#: and 12 train, minibatch 1, 16 classes (transformer_throughput's count,
#: bench.py:233), moment 0.9 (bench.py:260), 2 epochs, level 0
LONG_T, LONG_SAMPLES, LONG_CLASSES = 8192, 16, 16
LONG_CLASS_LENGTHS = [0, 4, 12]
LONG_EPOCHS = 2
#: the long-context run's learning rate. bench.py:260's 0.01 sent its
#: loss to NaN in the first epoch: at minibatch 1 one step moves a logit
#: of the head over the flattened T x E = 8.4M features by about lr * T *
#: E (84000 at 0.01). The JAX package and the port diverge alike at lr
#: 0.01 at a smaller T x E (tests/test_torch_transformer.py,
#: test_learning_rate_diverges_alike: both NaN in the second epoch at lr
#: * T * E = 82). 1e-5 keeps that product at 84.
LONG_LR = 1e-5
#: transformer_device at its own full width (bench.py:412-441): batch 16,
#: 512 positions, 16 heads of 64, 256 classes; 64 samples, 16 valid / 48
#: train; bench.py:468's learning rate
TD_T, TD_HEADS, TD_CLASSES, TD_MINIBATCH = 512, 16, 256, 16
TD_LR = 0.01
TD_CLASS_LENGTHS = [0, 16, 48]
TD_EPOCHS = 2
#: the training agreement: one block at 4096 positions, embed 256, 2
#: heads of 128, 4 samples (2 valid, 2 train), minibatch 1, one epoch at
#: level 0, compared on each leaf's update (final minus initial weights:
#: at LONG_LR a weight moves by ~1e-5 of itself, so the weights
#: alone would hide a wrong gradient). Both sides round the projections'
#: operands to bf16; the card also rounds P (K7, K8) and dS (K8, K9) to
#: bf16 (2^-9 relative) where the CPU's plain route keeps f32, and the
#: attention output, rounded to bf16 on both sides, may then land one
#: step (2^-8) apart: every leaf's update must lie within 2e-2 (five such
#: steps) of its largest element, where a wrong gradient is off by O(1).
#: Its two steps run at bench.py:260's lr 0.01, far above the f32 spacing
#: of the weights (two steps cannot diverge)
AGREE_LONG_LR = 0.01
AGREE_T, AGREE_EMBED, AGREE_HEADS = 4096, 256, 2
AGREE_LONG_CLASS_LENGTHS = [0, 2, 2]
AGREE_LONG_RTOL = 2e-2
#: AlexNet-227 (bench.py:777-817): single tower, 1000 classes, RandomState(0)
#: pixels in [0, 255), 1000 valid (one a class) and 2000 train (two a
#: class), mean_disp, precision level 0, the JAX package's lr 0.01, moment
#: 0.9, decay 5e-4; minibatch 128 with the knobs at their defaults, then
#: minibatch 512 with use_pallas and pallas_epilogue on (K6 forward and K5
#: backward at its three dense layers) and off
ALEX_CLASSES, ALEX_HW = 1000, 227
ALEX_CLASS_LENGTHS = [0, 1000, 2000]
ALEX_MINIBATCH, ALEX_EPOCHS = 128, 3
ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS = 512, 2
#: K6 at AlexNet's last hidden layer into the 1000-way head with the knobs
#: on, minibatch 512: (m, k, n)
K6_ALEX_SHAPE = (512, 4096, 1000)
#: K6 at the wide MLP's hidden layer on one served tick of phase 17's
#: REST serving (minibatch A5_SERVE_MINIBATCH): (m, k, n), tanh
K6_SERVE_SHAPE = (512, 784, 4096)
#: the conv agreement, card against CPU, precision level 2, one epoch,
#: per-minibatch serving, from the same weights: AlexNet at scale 1/8 on
#: 67 x 67 x 3 pixels (10 classes, 128 valid / 256 train, minibatch 64),
#: and the digits_conv stack (veles_tpu/parity.py:94-101: conv_tanh 32,
#: maxabs 2x2, conv_tanh 64, tanh 128, softmax) with shift1 on 8 x 8 x 1
#: pixels (297 valid / 1500 train, minibatch 100, lr 0.02, moment 0.9).
#: Both sides compute in f32 with other summation orders (cuDNN's conv
#: algorithms against the CPU's): a near-tied argmax may flip, so a
#: minibatch's n_err may differ by CONV_N_ERR_TOL, and after one epoch
#: every leaf must lie within CONV_LEAF_RTOL of its largest element
CONV_AGREE_SCALE, CONV_AGREE_HW = 1 / 8, 67
CONV_AGREE_CLASS_LENGTHS = [0, 128, 256]
DIGITS_CONV_LAYERS = [
    {"type": "conv_tanh", "n_kernels": 32, "kx": 3, "ky": 3},
    {"type": "maxabs_pooling", "kx": 2, "ky": 2},
    {"type": "conv_tanh", "n_kernels": 64, "kx": 3, "ky": 3},
    {"type": "all2all_tanh", "output_sample_shape": (128,)},
    {"type": "softmax", "output_sample_shape": (10,)}]
DIGITS_CLASS_LENGTHS = [0, 297, 1500]
CONV_N_ERR_TOL, CONV_LEAF_RTOL = 2, 1e-3
#: the fusion tiers (bench.py:150-230): the reference MNIST784 on the
#: bench data in graph mode, the segment tier (a host unit spliced between
#: the two forwards), the sweep tier (the same unit declared
#: sweep_transparent) and the fused tick, 2 epochs each
TIER_EPOCHS = 2
#: the wide MLP in graph mode (level 0, 2 epochs, knobs on and off): K5
#: runs the hidden layer's forward (4096 x 784 x 4096) on every minibatch
#: and its weight gradient (784 x 4096 x 4096) and error product (4096 x
#: 4096 x 784) on every train minibatch; the 10-wide head is no kernel's
GRAPH_EPOCHS = 2
#: the graph agreement: one epoch at level 2 of the wide MLP (the training
#: agreement's data), graph mode on the card against the fused tick on the
#: card and against graph mode on the CPU: equal index streams, n_err
#: within AGREE_N_ERR_TOL, every leaf within this share of its largest
#: element (the fused tick runs dense_layer/addmm and graph mode matmul:
#: the sums round in other orders)
GRAPH_LEAF_RTOL = 1e-4
#: the long-context stack in graph mode: 1 epoch (its K7 runs twice a
#: train minibatch a block: the forward unit's and the one GDSelfAttention
#: recomputes under autograd)
LONG_GRAPH_EPOCHS = 1
#: the Kohonen SOM: samples/som_digits.py's defaults (an (8, 8) grid,
#: minibatch 256) over the bench's 60000 x 784 pixels (uniform in [0, 1)),
#: 2 epochs. The card-CPU agreement runs one epoch in f32, each step of the
#: CPU from the card's weights before that step and its minibatch. On
#: uniform pixels every sample is nearly equidistant from the neurons: the
#: squared distances are ~100-260 and a sample's two nearest differ by as
#: little as 1.5e-5 (float64, measured on the CPU), below the f32
#: resolution of ||x||^2 - 2 x.w + ||w||^2 (~4e-4 over 784 terms), so a
#: winner may flip between two summation orders. Every winner whose
#: float64 top-2 gap exceeds SOM_TIE_GAP must be equal, and each step
#: whose winners all are equal must give new weights within
#: SOM_WEIGHT_RTOL of the largest
SOM_SHAPE, SOM_MINIBATCH, SOM_EPOCHS = (8, 8), 256, 2
SOM_TIE_GAP = 2e-3
SOM_WEIGHT_RTOL = 1e-4
#: MNIST784 through its idx loader: the bench data at MNIST's counts
#: (10000 test rows, the loader's validation, and 60000 train), pixels
#: times 255 as uint8 in four idx files (two gzipped), samples/
#: mnist784.py's configuration (784 -> 100 tanh -> 10, minibatch 100, lr
#: 0.03, moment 0.9), 3 epochs in the fused tick
MNIST_ROWS, MNIST_TEST, MNIST_EPOCHS, MNIST_MOMENT = 70000, 10000, 3, 0.9
MNIST_GZIPPED = ("train-labels-idx1-ubyte", "t10k-images-idx3-ubyte")
#: the wide MLP regressed (evaluator "mse", one-hot targets), 3 epochs;
#: its card-CPU agreement (level 2, one epoch, the training agreement's
#: rows): the losses differ in summation order only (~1e-6 relative) and
#: after three SGD steps every leaf lies within this share of its largest
MSE_EPOCHS, MSE_AGREE_RTOL = 3, 1e-4
#: the eight normalizers on the card against the CPU: float64 sums in
#: other orders, float32 outputs (~1e-7 relative)
NORMALIZER_NAMES = tuple(sorted(normalizer_registry))
NORM_RTOL = 1e-5
#: the file loaders: pickles of the bench data (4096 valid, 8192 train
#: rows) and 16 one-second 16-bit WAV tones at 16 kHz in two labels, in
#: windows of 1024 samples
PICKLE_VALID, PICKLE_TRAIN = 4096, 8192
SOUND_RATE, SOUND_WINDOW = 16000, 1024
#: phase 17 (snapshots, the CLI, the export, per-tick REST serving): the
#: CLI trains the wide MLP (samples/mnist784.py's workflow at bench.py's
#: width, minibatch 4096, lr 0.03, moment 0.9) on phase 16's idx files
#: for A5_EPOCHS epochs with a snapshot on every improved epoch, then
#: resumes from the last to A5_RESUMED_EPOCHS; the in-process resume
#: agreement runs 2 epochs, a snapshot and a resume to 4 against 4
#: uninterrupted ones at level 2 (phase 8's limits)
A5_EPOCHS, A5_RESUMED_EPOCHS = 3, 5
A5_AGREE_SPLIT, A5_AGREE_EPOCHS = 2, 4
#: the native runtime on the exported package: validation rows, phase
#: tests/test_native.py:72-78's bounds against the port's forward (f32,
#: level 2); the f16 package's size share, its bound against the f32
#: package's outputs, and the f32 top-2 gap past which its argmax must
#: hold
A5_NATIVE_ROWS, NATIVE_RTOL, NATIVE_ATOL = 1000, 2e-3, 1e-5
F16_SIZE_SHARE, F16_ATOL, F16_TOP2_GAP = 0.65, 5e-3, 1e-2
#: per-tick REST serving: a minibatch of 512 rows (K6's gate), the loader
#: flushing after 10 ms; 64 client threads of 20 requests each, half the
#: list codec and half base64; a reply may differ from the forward on
#: its own sample by this share of the largest output (its row sits in
#: another minibatch)
A5_SERVE_MINIBATCH, A5_FLUSH_S = 512, 0.01
A5_CLIENTS, A5_REQUESTS, REST_RTOL = 64, 20, 1e-4
#: the workflow file phase 17 runs through ``python -m veles_tpu_torch``
#: with samples/mnist784_config.py: it wires a Snapshotter between the
#: decision and the end point (skipped unless the epoch improved),
#: exports the trained chain at 32 and 16 bits, and writes its run's
#: kernel launches and tick minibatches beside the results
A5_WORKFLOW = '''"""The wide MLP on MNIST idx files (chip_smoke.py phase 17)."""

import json
import os
import time

import torch

from veles_tpu_torch.core.config import root
from veles_tpu_torch.export import package_export
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.snapshotter import Snapshotter

root.mnist784.update({"layers": [4096, 10], "minibatch_size": 4096,
                      "learning_rate": 0.03, "gradient_moment": 0.9,
                      "fail_iterations": 25, "directory": None,
                      "out": None})


def run(load, main):
    cfg = root.mnist784
    started = time.perf_counter()
    wf, resumed = load(
        MLPWorkflow, name="MNIST784-wide", layers=tuple(cfg.layers),
        loader_cls=MNISTLoader,
        loader_kwargs=dict(directory=cfg.directory,
                           minibatch_size=cfg.minibatch_size,
                           normalization_type="linear"),
        learning_rate=cfg.learning_rate,
        gradient_moment=cfg.gradient_moment, max_epochs=cfg.max_epochs,
        fail_iterations=cfg.fail_iterations)
    if wf.device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - started
    if resumed:
        wf.decision.max_epochs = cfg.max_epochs
        wf.decision.complete.unset()
        wf.decision.train_ended.unset()
        snap = wf.snapshotter
    else:
        snap = Snapshotter(wf, directory=cfg.out, prefix="wide",
                           compression="", interval=1, time_interval=0)
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.decision.improved
        wf.end_point.unlink_from(wf.decision)
        wf.end_point.link_from(snap)
        wf.snapshotter = snap
    before = list(getattr(wf.fused_tick, "minibatch_counts", [0, 0, 0]))
    written = snap.export_seconds
    main()
    run_name = "resumed" if resumed else "first"
    for bits in (32, 16):
        package_export(wf, os.path.join(
            cfg.out, "wide-%s-%d.tar" % (run_name, bits)), precision=bits)
    with open(os.path.join(cfg.out, "counters-%s.json" % run_name),
              "w") as fout:
        json.dump({"dense_epilogue": gemm.dense_epilogue.launches,
                   "blocked_matmul": gemm.blocked_matmul.launches,
                   "minibatches": [a - b for a, b in zip(
                       wf.fused_tick.minibatch_counts, before)],
                   "load_s": load_s,
                   "snapshot_s": snap.export_seconds - written,
                   "snapshot_bytes": os.path.getsize(snap.destination),
                   "device": str(wf.device)}, fout)
'''


#: phase 19 (the observe plane): the paged bursts observed, each tier with
#: its attend kernel (K2 in both); the client span every request's header
#: names as its parent; an MFU past OBSERVE_MFU_MAX means the FLOP count
#: is wrong
OBSERVE_TIERS = (("int8", "paged_attend"), ("int8-kv", "paged_attend_int8"))
CLIENT_SPAN = "c11e"
OBSERVE_MFU_MAX = 1.05
#: the admission spans a request's tree must reach one of
ADMIT_SPANS = ("paged.admit", "paged.admit_tail", "paged.admit_hit")
#: phase 19's CLI workflow: phase 17's wide MLP on the idx files, knobs
#: on, without the snapshotter and the export; it writes its kernel
#: launches, tick minibatches and every unit's firings
OBSERVE_WORKFLOW = """\"\"\"The wide MLP on MNIST idx files (chip_smoke.py phase 19).\"\"\"

import json
import os

from veles_tpu_torch.core.config import root
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm

root.mnist784.update({"layers": [4096, 10], "minibatch_size": 4096,
                      "learning_rate": 0.03, "gradient_moment": 0.9,
                      "fail_iterations": 25, "directory": None,
                      "out": None})


def run(load, main):
    cfg = root.mnist784
    wf, _ = load(
        MLPWorkflow, name="MNIST784-wide", layers=tuple(cfg.layers),
        loader_cls=MNISTLoader,
        loader_kwargs=dict(directory=cfg.directory,
                           minibatch_size=cfg.minibatch_size,
                           normalization_type="linear"),
        learning_rate=cfg.learning_rate,
        gradient_moment=cfg.gradient_moment, max_epochs=cfg.max_epochs,
        fail_iterations=cfg.fail_iterations)
    main()
    with open(os.path.join(cfg.out, "counters.json"), "w") as fout:
        json.dump({"dense_epilogue": gemm.dense_epilogue.launches,
                   "blocked_matmul": gemm.blocked_matmul.launches,
                   "minibatches": list(wf.fused_tick.minibatch_counts),
                   "run_calls": {u.name: u.run_calls for u in wf.units
                                 if u.run_calls}}, fout)
"""
#: a CLI run behind a SIGTERM handler of its own, which the CLI's black
#: box handler must chain to: it leaves a marker and ends the process
CHAINED_SIGTERM = """
import os, signal, sys
marker = sys.argv[1]

def previous(signum, frame):
    with open(marker, "w") as fout:
        fout.write("previous ran")
    os._exit(9)

signal.signal(signal.SIGTERM, previous)
from veles_tpu_torch.__main__ import main
sys.exit(main(sys.argv[2:]))
"""


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events, with the L2
    cache flushed (a 256 MB write) before every timed launch."""

    def __init__(self, device, reps=25, warmup=3):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)
        self.reps = reps
        self.warmup = warmup
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, fn):
        times = []
        for i in range(self.warmup + self.reps):
            self.flush.zero_()
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            if i >= self.warmup:
                times.append(self.start.elapsed_time(self.end))
        return statistics.median(times)

    def kernel_ms(self, fn, name):
        """The median device time of the kernels whose name holds
        ``name`` among those ``fn`` launches, from torch.profiler, the L2
        flushed the same way: the kernel alone, without the launch and
        event overhead the CUDA-event reading carries."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(self.warmup):
            fn()
        # a profiling session on the H100 has come back without a single
        # device event; such a session is taken again, twice at most
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(self.reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            times = [e.device_time for e in prof.events()
                     if e.device_type.name == "CUDA" and name in e.name]
            if times:
                return 1e-3 * statistics.median(times)
            print("kernel_ms: the profiler saw no %s kernel (session %d)"
                  % (name, attempt + 1))
        raise RuntimeError("kernel_ms: the profiler saw no %s kernel in "
                           "three sessions" % name)


def k1_problem(device, gen, lengths=K1_LENGTHS, heads=HEADS, head_dim=None,
               q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16):
    """The serving path's K1 shapes: 8 slots, 16 heads of 64 (or
    ``heads`` heads of EMBED / heads, or of ``head_dim``), 128-token bf16
    pages (or ``kv_dtype``), ragged lengths from 0 to 1100 (0, a page
    boundary, a full table row), and a page table with one column more
    than the longest row needs, rows padded with the scratch page."""
    head_dim = head_dim or EMBED // heads
    pb = 1100 // PAGE + 2
    table = numpy.zeros((SLOTS, pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(n // PAGE + 1):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt, PAGE, heads, head_dim)
    k = torch.randn(shape, generator=gen, device=device).to(kv_dtype)
    v = torch.randn(shape, generator=gen, device=device).to(kv_dtype)
    q = torch.randn((SLOTS, heads, head_dim), generator=gen,
                    device=device).to(q_dtype)
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def paged_plan(label, table, lengths):
    """K1's plan (K3's too) at these operands, printed: the split, the
    grid and the blocks that find live positions."""
    pb = table.shape[1]
    pages, splits, _ = _paged_plan(SLOTS, HEADS, EMBED // HEADS, pb, PAGE,
                                   sm_count(table.device))
    span = pages * PAGE
    live = sum(-(-min(n + 1, pb * PAGE) // span) for n in lengths.tolist())
    print("%s plan, lengths %s: splits of %d page(s), %d a slot, %d blocks "
          "launched, %d with live positions"
          % (label, lengths.tolist(), pages, splits,
             HEADS * splits * SLOTS, HEADS * live))


def k1_check(args, label=""):
    """K1 against its plain version, and two calls bit for bit."""
    out = paged_attend(*args, page_size=PAGE)
    again = paged_attend(*args, page_size=PAGE)
    ref = _paged_attend_plain(*args, PAGE)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, again)
    print("K1 paged_attend%s, lengths %s: max_abs_err %.3g (tolerance "
          "%.1g), two calls bit-equal: %s" % (label, args[4].tolist(), err,
                                              K1_ATOL, equal))
    if not err <= K1_ATOL:
        raise AssertionError("K1 disagrees with its plain version")
    if not equal:
        raise AssertionError("K1's two calls differ")
    return err


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def k1_widths(device, gen):
    """C4, C5 and C6: K1 at every width of C4_WIDTHS, C5_WIDTHS and
    C6_WIDTHS, f32 and bf16 pools and queries, against its plain version
    and twice bit for bit; returns the largest error."""
    t0 = time.perf_counter()
    err = 0.0
    for head_dim in C4_WIDTHS + C5_WIDTHS + C6_WIDTHS:
        for kv_dtype in (torch.float32, torch.bfloat16):
            for q_dtype in (torch.float32, torch.bfloat16):
                args = k1_problem(device, gen, heads=C4_HEADS,
                                  head_dim=head_dim, q_dtype=q_dtype,
                                  kv_dtype=kv_dtype)
                err = max(err, k1_check(args, ", D = %d, q %s, pool %s"
                                        % (head_dim, dtype_name(q_dtype),
                                           dtype_name(kv_dtype))))
    widths = C4_WIDTHS + C5_WIDTHS + C6_WIDTHS
    print("K1 C4, C5 and C6 widths %s: %d calls checked in %.1f s, "
          "max_abs_err %.3g" % (list(widths), 4 * len(widths),
                                time.perf_counter() - t0, err))
    return err


def wide_time(timer, label, fn, name, nbytes, head_dim=C5_TIMED,
              tag="C5"):
    """C5 (C6): a kernel at D = C5_TIMED (C6_TIMED) in C4_HEADS heads (the
    burst's lengths): the event timer and the kernel alone beside the
    byte bound (each live byte read once, the output written once)."""
    ms = timer(fn)
    alone = timer.kernel_ms(fn, name)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print("%s at D = %d (%s, %d heads, bf16 q): ms %.4f, alone %.4f, "
          "bound_ms %.4f (bytes, %d)" % (label, head_dim, tag, C4_HEADS, ms,
                                        alone, bound_ms, nbytes))
    return {"ms": ms, "kernel_ms": alone, "bound_ms": bound_ms}


def k1_wide_time(timer, device, gen, head_dim, tag):
    """K1 at ``head_dim`` in C4_HEADS heads, bf16 pool and q, timed."""
    wide = k1_problem(device, gen, heads=C4_HEADS, head_dim=head_dim)
    live = live_positions(wide[4], wide[3].shape[1])
    return wide_time(timer, "K1", lambda: paged_attend(*wide, page_size=PAGE),
                     "paged_attend", 2 * live * C4_HEADS * head_dim * 2
                     + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim, tag)


def live_positions(lengths, pb):
    return sum(min(int(n) + 1, pb * PAGE) for n in lengths.tolist())


def narrow_times(timer, label, fn, plain, name):
    """A kernel at the 48-wide serving shape (8 slots, 16 heads of 48,
    the burst's lengths): event timer, alone, and its plain version."""
    ms = timer(fn)
    alone = timer.kernel_ms(fn, name)
    plain_ms = timer(plain)
    print("%s at 16 heads of 48 (the tile path): ms %.4f, alone %.4f, "
          "plain_ms %.4f" % (label, ms, alone, plain_ms))


def k1_phase(timer, device, gen):
    q, k, v, table, lengths = k1_problem(device, gen)
    lopsided = k1_problem(device, gen, K1_LOPSIDED)
    for args in ((q, k, v, table, lengths), lopsided):
        paged_plan("K1", args[3], args[4])
    err = max(k1_check((q, k, v, table, lengths)), k1_check(lopsided),
              k1_widths(device, gen))
    narrow = k1_problem(device, gen, head_dim=NARROW_EMBED // NARROW_HEADS)
    narrow_times(timer, "K1", lambda: paged_attend(*narrow, page_size=PAGE),
                 lambda: _paged_attend_plain(*narrow, PAGE),
                 "paged_attend_kernel")
    c5 = k1_wide_time(timer, device, gen, C5_TIMED, "C5")
    c6 = k1_wide_time(timer, device, gen, C6_TIMED, "C6")
    # the library yardstick: SDPA over K/V already gathered contiguous
    # (the gather itself is not timed), with the same visibility mask
    span = table.shape[1] * PAGE
    idx = table.long()
    kg = k[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    vg = v[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    mask = (torch.arange(span, device=device)[None, :]
            <= lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: paged_attend(q, k, v, table, lengths,
                                    page_size=PAGE))
    lopsided_ms = timer(lambda: paged_attend(*lopsided, page_size=PAGE))
    kernel_ms = [timer.kernel_ms(lambda a=a: paged_attend(*a, page_size=PAGE),
                                 "paged_attend_kernel")
                 for a in ((q, k, v, table, lengths), lopsided)]
    plain_ms = timer(lambda: _paged_attend_plain(q, k, v, table, lengths,
                                                 PAGE))
    library_ms = timer(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    live = sum(min(int(n) + 1, table.shape[1] * PAGE)
               for n in lengths.tolist())
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * live * HEADS * head_dim * k.element_size()
              + table.numel() * 4 + lengths.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * live * HEADS * head_dim
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K1 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "live positions, %d bytes); lopsided lengths %s: %.4f ms; "
          "kernel alone (torch.profiler) %.4f and %.4f ms"
          % (ms, plain_ms, library_ms, bound_ms, bound_by, live, nbytes,
             list(K1_LOPSIDED), lopsided_ms, *kernel_ms))
    return {"name": "paged_attend", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "veles_tpu/ops/paged_attention.py:151",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "lopsided_ms": lopsided_ms,
            "kernel_ms": kernel_ms[0], "lopsided_kernel_ms": kernel_ms[1],
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the gathered pages"}


def k3_problem(device, gen, q_dtype, lengths=K1_LENGTHS, heads=HEADS,
               head_dim=None):
    """K1's smoke shapes in the int8-KV tier: the pool from
    ``_quantize_kv`` of random bf16 K/V, re-laid head-major (P, H, D,
    ps) with (P, H, ps) scales, and q pre-scaled by 1/sqrt(D)."""
    head_dim = head_dim or EMBED // heads
    q, k, v, table, lengths = k1_problem(device, gen, lengths, heads,
                                         head_dim)
    pool = []
    for val in (k, v):
        codes, scale = _quantize_kv(val)       # (P,ps,H,D), (P,ps,H)
        pool += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = (q.float() * head_dim ** -0.5).to(q_dtype)
    return (q, *pool, table, lengths)


def k3_check(label, args):
    """K3 against its plain version, and two calls bit for bit."""
    out = paged_attend_int8(*args, page_size=PAGE)
    again = paged_attend_int8(*args, page_size=PAGE)
    ref = _paged_attend_int8_plain(*args, PAGE)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, again)
    print("K3 paged_attend_int8, %s, lengths %s: max_abs_err %.3g "
          "(tolerance %.0e), two calls bit-equal: %s"
          % (label, args[6].tolist(), err, K3_ATOL, equal))
    if not err <= K3_ATOL:
        raise AssertionError("K3 disagrees with its plain version (%s)"
                             % label)
    if not equal:
        raise AssertionError("K3's two calls differ (%s)" % label)
    return err


def k3_phase(timer, device, gen):
    """K3 against its plain version with bf16 and with f32 q, at the
    lopsided lengths and at the serving model's width in heads of 256
    (4 of them), each call twice bit for bit; timed at bf16 q (the
    serving path's) at the burst's and the lopsided lengths, beside SDPA
    over K/V dequantized and gathered beforehand (the gather and
    dequantization not timed)."""
    err = 0.0
    for q_dtype in (torch.float32, torch.bfloat16):
        args = k3_problem(device, gen, q_dtype)
        err = max(err, k3_check("q %s" % str(q_dtype).split(".")[-1], args))
    lopsided = k3_problem(device, gen, torch.bfloat16, K1_LOPSIDED)
    err = max(err, k3_check("q bfloat16", lopsided))
    err = max(err, k3_check("q bfloat16, D = 256", k3_problem(
        device, gen, torch.bfloat16, heads=EMBED // 256)))
    t0 = time.perf_counter()
    widths = C4_WIDTHS + C5_WIDTHS + C6_WIDTHS
    for head_dim in widths:     # C4, C5 and C6
        for q_dtype in (torch.float32, torch.bfloat16):
            err = max(err, k3_check(
                "q %s, D = %d" % (dtype_name(q_dtype), head_dim),
                k3_problem(device, gen, q_dtype, heads=C4_HEADS,
                           head_dim=head_dim)))
    print("K3 C4, C5 and C6 widths %s: %d calls checked in %.1f s"
          % (list(widths), 2 * len(widths), time.perf_counter() - t0))
    c5, c6 = [], []
    for head_dim, out in ((C5_TIMED, c5), (C6_TIMED, c6)):
        wide = k3_problem(device, gen, torch.bfloat16, heads=C4_HEADS,
                          head_dim=head_dim)
        live = live_positions(wide[6], wide[5].shape[1])
        out.append(wide_time(
            timer, "K3", lambda: paged_attend_int8(*wide, page_size=PAGE),
            "paged_attend_int8", 2 * live * C4_HEADS * (head_dim + 4)
            + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim,
            "C5" if head_dim == C5_TIMED else "C6"))
    (c5,), (c6,) = c5, c6
    narrow = k3_problem(device, gen, torch.bfloat16,
                        head_dim=NARROW_EMBED // NARROW_HEADS)
    narrow_times(timer, "K3",
                 lambda: paged_attend_int8(*narrow, page_size=PAGE),
                 lambda: _paged_attend_int8_plain(*narrow, PAGE),
                 "paged_attend_int8_kernel")
    for a in (args, lopsided):
        paged_plan("K3", a[5], a[6])
    q, kq, ks, vq, vs, table, lengths = args
    span = table.shape[1] * PAGE
    idx = table.long()

    def dequantized(codes, scale):
        full = codes.float() * scale[:, :, None, :]          # (P,H,D,ps)
        return full[idx].permute(0, 2, 1, 4, 3).reshape(
            SLOTS, HEADS, span, -1).to(q.dtype)

    kg, vg = dequantized(kq, ks), dequantized(vq, vs)
    mask = (torch.arange(span, device=device)[None, :]
            <= lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: paged_attend_int8(*args, page_size=PAGE))
    lopsided_ms = timer(lambda: paged_attend_int8(*lopsided,
                                                  page_size=PAGE))
    kernel_ms = [timer.kernel_ms(
        lambda a=a: paged_attend_int8(*a, page_size=PAGE),
        "paged_attend_int8_kernel") for a in (args, lopsided)]
    plain_ms = timer(lambda: _paged_attend_int8_plain(*args, PAGE))
    library_ms = timer(lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=1.0))
    live = sum(min(int(n) + 1, span) for n in lengths.tolist())
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * live * HEADS * head_dim + 2 * live * HEADS * 4
              + table.numel() * 4 + lengths.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * live * HEADS * head_dim
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K3 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "live positions, %d bytes); lopsided lengths %s: %.4f ms; "
          "kernel alone (torch.profiler) %.4f and %.4f ms"
          % (ms, plain_ms, library_ms, bound_ms, bound_by, live, nbytes,
             list(K1_LOPSIDED), lopsided_ms, *kernel_ms))
    return {"name": "paged_attend_int8", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/paged_attention_int8.cu",
            "replaces": "veles_tpu/ops/paged_attention.py:201",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "lopsided_ms": lopsided_ms,
            "kernel_ms": kernel_ms[0], "lopsided_kernel_ms": kernel_ms[1],
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the dequantized "
                       "pages"}


def k4_problem(device, gen, q_dtype, width=K4_WIDTH, heads=HEADS,
               head_dim=None):
    """The dense int8-KV slab of the serving model at the dense phase's
    width: (8 slots, 16 heads, 64, width) codes and (8, 16, width)
    scales from ``_quantize_kv`` of random bf16 K/V, q (8, 1, 16, 64)
    pre-scaled by 1/sqrt(D) (or ``heads`` heads of ``head_dim``)."""
    head_dim = head_dim or EMBED // heads
    slab = []
    for _ in range(2):
        val = torch.randn((SLOTS, width, heads, head_dim), generator=gen,
                          device=device).to(torch.bfloat16)
        codes, scale = _quantize_kv(val)        # (S,T,H,D), (S,T,H)
        slab += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = torch.randn((SLOTS, 1, heads, head_dim), generator=gen,
                    device=device) * head_dim ** -0.5
    return q.to(q_dtype), slab


def k4_widths(timer, device, gen):
    """C5 and C6: K4 at every width of C5_K4_WIDTHS and C6_K4_WIDTHS in
    C4_HEADS heads, f32 and bf16 q, the per-row mask, against its plain
    version and twice bit for bit; timed at C5_TIMED and C6_TIMED.
    Returns the largest error and the two timings."""
    t0 = time.perf_counter()
    err = 0.0
    mask = k4_masks(device, K4_WIDTH)["per-row"]
    for head_dim in C5_K4_WIDTHS + C6_K4_WIDTHS:
        for q_dtype in (torch.float32, torch.bfloat16):
            q, slab = k4_problem(device, gen, q_dtype, heads=C4_HEADS,
                                 head_dim=head_dim)
            out = int8_cache_attend(q, *slab, mask, use_pallas=True)
            again = int8_cache_attend(q, *slab, mask, use_pallas=True)
            ref = _cache_attend_plain(q, *slab, mask)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            equal = torch.equal(out, again)
            print("K4 int8_cache_attend q %s, D = %d: max_abs_err %.3g "
                  "(tolerance %.0e), two calls bit-equal: %s"
                  % (dtype_name(q_dtype), head_dim, e, K4_ATOL, equal))
            if not e <= K4_ATOL or not equal:
                raise AssertionError("K4 fails at D = %d" % head_dim)
            err = max(err, e)
    widths = C5_K4_WIDTHS + C6_K4_WIDTHS
    print("K4 C5 and C6 widths %s: %d calls checked in %.1f s"
          % (list(widths), 2 * len(widths), time.perf_counter() - t0))
    timed = []
    for head_dim, tag in ((C5_TIMED, "C5"), (C6_TIMED, "C6")):
        q, slab = k4_problem(device, gen, torch.bfloat16, heads=C4_HEADS,
                             head_dim=head_dim)
        timed.append(wide_time(
            timer, "K4", lambda: int8_cache_attend(q, *slab, mask,
                                                   use_pallas=True),
            "cache_attend_int8", 2 * SLOTS * C4_HEADS * K4_WIDTH
            * (head_dim + 4) + mask.numel() * 4
            + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim, tag))
        del q, slab
    return err, timed[0], timed[1]


def k4_masks(device, t):
    """The slot step's per-row mask of K4_LENGTHS (clipped to t) and one
    shared mask."""
    pos = torch.arange(t, device=device)
    lengths = torch.tensor(K4_LENGTHS, device=device)
    per_row = torch.where(pos[None, :] <= lengths[:, None], 0.0, -1e30)
    shared = torch.where(pos <= 400, 0.0, -1e30)
    return {"per-row": per_row.float(), "shared": shared.float()}


def k4_phase(timer, device, gen):
    """K4 against its plain version with f32 and bf16 q, per-row and
    shared masks, and once on the slab cut to a 640-position span (a
    strided view, read in place); timed at bf16 q and the per-row mask
    (the serving path's), beside SDPA over K/V dequantized beforehand
    (the dequantization not timed)."""
    err = 0.0
    for q_dtype in (torch.float32, torch.bfloat16):
        q, slab = k4_problem(device, gen, q_dtype)
        for label, mask in k4_masks(device, K4_WIDTH).items():
            out = int8_cache_attend(q, *slab, mask, use_pallas=True)
            ref = _cache_attend_plain(q, *slab, mask)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            print("K4 int8_cache_attend q %s, %s mask: max_abs_err %.3g "
                  "(tolerance %.0e)" % (str(q_dtype).split(".")[-1], label,
                                        e, K4_ATOL))
            err = max(err, e)
    view = [a[..., :K4_SPAN] for a in slab]
    mask = k4_masks(device, K4_SPAN)["per-row"]
    out = int8_cache_attend(q, *view, mask, use_pallas=True)
    ref = _cache_attend_plain(q, *(a.contiguous() for a in view), mask)
    torch.cuda.synchronize()
    e = (out - ref).abs().max().item()
    print("K4 on a %d-position span of the %d-wide slab (row stride %d): "
          "max_abs_err %.3g" % (K4_SPAN, K4_WIDTH, view[0].stride(2), e))
    err = max(err, e)
    if not err <= K4_ATOL:
        raise AssertionError("K4 disagrees with its plain version")
    wide_err, c5, c6 = k4_widths(timer, device, gen)
    err = max(err, wide_err)
    mask = k4_masks(device, K4_WIDTH)["per-row"]
    for t in (K4_WIDTH, K4_SPAN):
        splits, chunk = _attend_plan(SLOTS, HEADS, t, sm_count(device))
        print("K4 plan at %d positions: %d splits of %d positions, %d "
              "blocks" % (t, splits, chunk, SLOTS * HEADS * splits))
    first = int8_cache_attend(q, *slab, mask, use_pallas=True)
    again = int8_cache_attend(q, *slab, mask, use_pallas=True)
    torch.cuda.synchronize()
    print("K4 two calls bit-equal: %s" % torch.equal(first, again))
    if not torch.equal(first, again):
        raise AssertionError("K4's two calls differ")

    def dequantized(codes, scale):
        full = codes.float() * scale[:, :, None, :]          # (S,H,D,T)
        return full.transpose(2, 3).to(q.dtype)              # (S,H,T,D)

    kd, vd = dequantized(*slab[:2]), dequantized(*slab[2:])
    visible = (mask == 0)[:, None, None, :]
    qs = q.transpose(1, 2)                                   # (S,H,1,D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: int8_cache_attend(q, *slab, mask, use_pallas=True))
    kernel_ms = timer.kernel_ms(
        lambda: int8_cache_attend(q, *slab, mask, use_pallas=True),
        "cache_attend_int8_kernel")
    plain_ms = timer(lambda: _cache_attend_plain(q, *slab, mask))
    library_ms = timer(lambda: sdpa(qs, kd, vd, attn_mask=visible,
                                    scale=1.0))
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * SLOTS * HEADS * head_dim * K4_WIDTH
              + 2 * SLOTS * HEADS * K4_WIDTH * 4 + mask.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * SLOTS * HEADS * head_dim * K4_WIDTH
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K4 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "positions a lane, %d bytes); kernel alone (torch.profiler) %.4f "
          "ms" % (ms, plain_ms, library_ms, bound_ms, bound_by, K4_WIDTH,
                  nbytes, kernel_ms))
    return {"name": "int8_cache_attend", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/cache_attend_int8.cu",
            "replaces": "veles_tpu/ops/quant.py:161",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "kernel_ms": kernel_ms,
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the dequantized "
                       "slab"}


def gemm_bound(m, k, n, operand_bytes, out_bytes, ops_per_s, bias=False):
    """The least time of one (m, k, n) product: each operand read once,
    the output (and K6's f32 bias) written or read once, 2mkn operations
    at ``ops_per_s``."""
    nbytes = ((m * k + k * n) * operand_bytes + m * n * out_bytes
              + (4 * n if bias else 0))
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / ops_per_s
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def gemm_operands(gen, device, shape, dtype, layout):
    """(a, b) of the (m, k, n) product laid out as the training path lays
    them: "forward" x (m, k) @ w (k, n), both row-major (K6);
    "weight_grad" x.T @ err, x.T a view of a row-major (k, m) x (K5);
    "grad_x" err @ w.T, w.T a view of a row-major (n, k) w (K5). Values
    are randn, b scaled by 1/sqrt(k) so outputs are of order 1."""
    m, k, n = shape
    if layout == "weight_grad":
        a = torch.randn((k, m), generator=gen, device=device).to(dtype).t()
    else:
        a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    if layout == "grad_x":
        b = (torch.randn((n, k), generator=gen, device=device)
             / math.sqrt(k)).to(dtype).t()
    else:
        b = (torch.randn((k, n), generator=gen, device=device)
             / math.sqrt(k)).to(dtype)
    return a, b


def gemm_error(out, ref, tol):
    """Max abs error and that error relative to the largest output;
    raises past ``tol`` (relative)."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not rel <= tol:
        raise AssertionError("max abs err %.3g is %.3g of the largest "
                             "output (tolerance %.0e)" % (err, rel, tol))
    return err, rel


def k5_phase(timer, device, gen):
    """K5 against its plain version at the weight-gradient shape (x.T
    read in place) and the grad_x shape (w.T read in place, written in
    x's type), bf16 and f32 operands; each timed against the plain
    version and cuBLAS through torch.matmul on the same operands (bf16
    out, widened to f32). The JSON numbers are the weight gradient's in
    bf16, the training path's."""
    worst = 0.0
    entry = None
    for layout, shape in (("weight_grad", K5_SHAPE),
                          ("grad_x", K5_GRAD_X_SHAPE)):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = gemm_operands(gen, device, shape, dtype, layout)
            out_dtype = dtype if layout == "grad_x" else torch.float32
            out = blocked_matmul(a, b, out_dtype=out_dtype)
            ref = _blocked_matmul_plain(a, b, out_dtype)
            torch.cuda.synchronize()
            err, rel = gemm_error(out, ref, GEMM_BF16_RTOL
                                  if out_dtype == torch.bfloat16
                                  else GEMM_F32_RTOL)
            worst = max(worst, err)
            ms = timer(lambda: blocked_matmul(a, b, out_dtype=out_dtype))
            plain_ms = timer(lambda: _blocked_matmul_plain(a, b, out_dtype))
            library_ms = timer(lambda: torch.matmul(a, b).float())
            bf16 = dtype == torch.bfloat16
            bound_ms, bound_by = gemm_bound(
                *shape, a.element_size(), out.element_size(),
                BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
            print("K5 blocked_matmul %s (m %d, k %d, n %d) %s -> %s: "
                  "max_abs_err %.3g (%.3g relative) ms %.4f plain_ms %.4f "
                  "library_ms %.4f bound_ms %.4f (%s)"
                  % (layout, *shape, str(dtype).split(".")[-1],
                     str(out_dtype).split(".")[-1], err, rel, ms, plain_ms,
                     library_ms, bound_ms, bound_by))
            if layout == "weight_grad" and bf16:
                entry = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
    return dict({"name": "blocked_matmul", "route": "cuda",
                 "source": "veles_tpu_torch/ops/csrc/gemm_sm90.cuh",
                 "replaces": "veles_tpu/ops/gemm.py:133",
                 "max_abs_err": worst, "library": "torch.matmul"}, **entry)


def k6_phase(timer, device, gen):
    """K6 against its plain version at the hidden layer's forward shape,
    bf16 and f32 operands, each of the five activations; tanh (the
    path's) timed against the plain version and torch.addmm plus the
    activation on the same operands; then tanh at one served tick's
    shape (K6_SERVE_SHAPE) and AlexNet's head (K6_ALEX_SHAPE) against the
    plain version. The JSON numbers are bf16's."""
    worst = 0.0
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        a, b = gemm_operands(gen, device, K6_SHAPE, dtype, "forward")
        bias = torch.randn(K6_SHAPE[2], generator=gen, device=device) * 0.1
        for activation in act_lib.ACTIVATIONS:
            out = dense_epilogue(a, b, bias, activation)
            ref = _dense_epilogue_plain(a, b, bias, activation)
            torch.cuda.synchronize()
            err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
            worst = max(worst, err)
            print("K6 dense_epilogue %s %s: max_abs_err %.3g (%.3g "
                  "relative)" % (str(dtype).split(".")[-1], activation,
                                 err, rel))
        act = act_lib.ACTIVATIONS["tanh"][0]
        bias_lib = bias.to(dtype)
        ms = timer(lambda: dense_epilogue(a, b, bias, "tanh"))
        plain_ms = timer(lambda: _dense_epilogue_plain(a, b, bias, "tanh"))
        library_ms = timer(lambda: act(torch.addmm(bias_lib, a, b).float()))
        bf16 = dtype == torch.bfloat16
        bound_ms, bound_by = gemm_bound(
            *K6_SHAPE, a.element_size(), 4,
            BF16_OPS_PER_S if bf16 else F32_OPS_PER_S, bias=True)
        print("K6 dense_epilogue tanh (m %d, k %d, n %d) %s: ms %.4f "
              "plain_ms %.4f library_ms %.4f bound_ms %.4f (%s)"
              % (*K6_SHAPE, str(dtype).split(".")[-1], ms, plain_ms,
                 library_ms, bound_ms, bound_by))
        if bf16:
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
    # the hidden layer on one served tick of phase 17 (tanh, level 0's
    # bf16 operands and level 2's f32)
    for dtype in (torch.bfloat16, torch.float32):
        a, b = gemm_operands(gen, device, K6_SERVE_SHAPE, dtype, "forward")
        bias = torch.randn(K6_SERVE_SHAPE[2], generator=gen,
                           device=device) * 0.1
        out = dense_epilogue(a, b, bias, "tanh")
        ref = _dense_epilogue_plain(a, b, bias, "tanh")
        torch.cuda.synchronize()
        err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
        worst = max(worst, err)
        print("K6 dense_epilogue %s tanh (m %d, k %d, n %d): max_abs_err "
              "%.3g (%.3g relative)" % (str(dtype).split(".")[-1],
                                        *K6_SERVE_SHAPE, err, rel))
    # AlexNet's 1000-way head at minibatch 512 with the knobs on (its
    # forward runs linear; relu as the issue of this shape asks)
    a, b = gemm_operands(gen, device, K6_ALEX_SHAPE, torch.bfloat16,
                         "forward")
    bias = torch.randn(K6_ALEX_SHAPE[2], generator=gen, device=device) * 0.1
    for activation in ("relu", "linear"):
        out = dense_epilogue(a, b, bias, activation)
        ref = _dense_epilogue_plain(a, b, bias, activation)
        torch.cuda.synchronize()
        err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
        worst = max(worst, err)
        print("K6 dense_epilogue bfloat16 %s (m %d, k %d, n %d): "
              "max_abs_err %.3g (%.3g relative)"
              % (activation, *K6_ALEX_SHAPE, err, rel))
    ms = timer(lambda: dense_epilogue(a, b, bias, "relu"))
    plain_ms = timer(lambda: _dense_epilogue_plain(a, b, bias, "relu"))
    bound_ms, bound_by = gemm_bound(*K6_ALEX_SHAPE, 2, 4, BF16_OPS_PER_S,
                                    bias=True)
    print("K6 dense_epilogue relu (m %d, k %d, n %d) bfloat16: ms %.4f "
          "plain_ms %.4f bound_ms %.4f (%s)"
          % (*K6_ALEX_SHAPE, ms, plain_ms, bound_ms, bound_by))
    return dict({"name": "dense_epilogue", "route": "cuda",
                 "source": "veles_tpu_torch/ops/csrc/gemm_sm90.cuh",
                 "replaces": "veles_tpu/ops/gemm.py:199",
                 "max_abs_err": worst, "library": "torch.addmm, then the "
                                                  "activation"}, **entry)


def library_available(x, q_t, scale_t):
    """Whether this PyTorch build runs its W8A16 operator
    (``torch._weight_int8pack_mm``) on the card: the yardstick, never
    called by the port."""
    try:
        torch._weight_int8pack_mm(x, q_t, scale_t)
        torch.cuda.synchronize()
        return True
    except (AttributeError, RuntimeError, NotImplementedError) as exc:
        print("K2 library yardstick unavailable: %s"
              % str(exc).splitlines()[0])
        return False


def k2_step_graph_ms(timer, problems):
    """One decode step's K2 launches (``problems``: (x, q, scale) in the
    step's order) captured in a CUDA graph and replayed: the card's time
    for the step's products back to back, without the host's launch gap
    or the per-call event overhead that single-call timings each pay."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # the capture stream's scratch, sized
        for problem in problems:
            int8_matmul(*problem)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for problem in problems:
            int8_matmul(*problem)
    graph.replay()
    torch.cuda.synchronize()
    return timer(graph.replay)


def k2_phase(timer, device, gen):
    """Every M in {8, 100, 256} at every weight shape of the decode
    step, bf16 x, each against its plain version and run twice, bit for
    bit (the split-K partials meet in a fixed order); the JSON numbers
    are one decode step's worth at M = 8 (each shape's time times its
    launches per step), and ``step_graph_ms`` the step's 17 launches
    replayed back to back from a CUDA graph."""
    worst_rel, worst_abs = 0.0, 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bytes_s": 0.0, "ops_s": 0.0}
    library = None
    decode = []  # the M = 8 problems, one a weight shape
    for (k, n), per_step in zip(K2_SHAPES, K2_PER_STEP):
        w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
        q, scale = quantize_int8(w)
        # the library yardstick's layout: (N, K) weights, scales in x's
        # type
        q_t = q.t().contiguous()
        scale_t = scale.to(torch.bfloat16)
        for m in (8, 100, 256):
            x = torch.randn((m, k), generator=gen,
                            device=device).to(torch.bfloat16)
            out = int8_matmul(x, q, scale)
            again = int8_matmul(x, q, scale)
            ref = _int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError("K2 M=%d K=%d N=%d: two calls differ"
                                     % (m, k, n))
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            worst_abs = max(worst_abs, diff)
            worst_rel = max(worst_rel, rel)
            if library is None:
                library = library_available(x, q_t, scale_t)
            ms = timer(lambda: int8_matmul(x, q, scale))
            plain_ms = timer(lambda: _int8_matmul_plain(x, q, scale))
            library_ms = (timer(lambda: torch._weight_int8pack_mm(
                x, q_t, scale_t)) if library else None)
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            ops = 2 * m * k * n
            bytes_s = nbytes / HBM_BYTES_PER_S
            ops_s = ops / BF16_OPS_PER_S
            print("K2 int8_matmul M=%d K=%d N=%d: rel_err %.3g abs_err "
                  "%.3g, two calls bit-equal; ms %.4f plain_ms %.4f "
                  "library_ms %s bound_ms %.4f (%s)"
                  % (m, k, n, rel, diff, ms, plain_ms,
                     "%.4f" % library_ms if library_ms is not None
                     else "null", 1e3 * max(bytes_s, ops_s),
                     "bytes" if bytes_s >= ops_s else "operations"))
            if m == 8:
                decode.append((x, q, scale))
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                if library:
                    step["library_ms"] += per_step * library_ms
                step["bytes_s"] += per_step * bytes_s
                step["ops_s"] += per_step * ops_s
    print("K2 worst rel_err %.3g (tolerance %.0e relative to the largest "
          "output)" % (worst_rel, K2_RTOL))
    if not worst_rel <= K2_RTOL:
        raise AssertionError("K2 disagrees with its plain version")
    # what a single timed call pays beyond its kernel's work: one
    # one-element kernel under the same timer
    tiny = torch.zeros(1, device=device)
    floor_ms = timer(lambda: tiny.add_(1))
    # the step's order: the four block projections of each block, then
    # the vocab head
    graph_ms = k2_step_graph_ms(
        timer, [p for _ in range(BLOCKS) for p in decode[:4]] + decode[4:])
    print("K2 one decode step at M=8: %.4f ms as the sum of single calls, "
          "%.4f ms replayed from a CUDA graph (17 launches back to back); "
          "a one-element kernel reads %.4f ms under the same timer"
          % (step["ms"], graph_ms, floor_ms))
    bound_s = max(step["bytes_s"], step["ops_s"])
    return {"name": "int8_matmul", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/int8_matmul.cu",
            "replaces": "veles_tpu/ops/quant.py:63",
            "max_abs_err": worst_abs, "ms": step["ms"],
            "plain_ms": step["plain_ms"], "bound_ms": 1e3 * bound_s,
            "bound_by": ("bytes" if step["bytes_s"] >= step["ops_s"]
                         else "operations"),
            "library_ms": step["library_ms"] if library else None,
            "library": "torch._weight_int8pack_mm" if library else None,
            "step_graph_ms": graph_ms}


def post(port, tokens, n_tokens, timeout=600, trace_id=None):
    """One POST to /generate; with ``trace_id`` it carries
    ``X-Veles-Trace: <trace_id>/CLIENT_SPAN`` and the reply must echo the
    trace id. Returns the tokens."""
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Veles-Trace"] = "%s/%s" % (trace_id, CLIENT_SPAN)
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens, "n_tokens": n_tokens}).encode(),
        headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        echoed = resp.headers.get("X-Veles-Trace") or ""
        tokens = json.loads(resp.read().decode())["tokens"]
    if trace_id is not None and not echoed.startswith(trace_id + "/"):
        raise AssertionError("request %s echoed %r" % (trace_id, echoed))
    return tokens


#: every kernel's launch counter, by the name the JSON line gives it
COUNTERS = {"paged_attend": paged_attend, "int8_matmul": int8_matmul,
            "paged_attend_int8": paged_attend_int8,
            "int8_cache_attend": int8_cache_attend,
            "blocked_matmul": blocked_matmul,
            "dense_epilogue": dense_epilogue,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_dkv": flash_attention_dkv,
            "flash_attention_dq": flash_attention_dq}
#: the attention kernels among them
ATTENTION = ("paged_attend", "paged_attend_int8", "int8_cache_attend",
             "flash_attention_fwd")
#: the flash kernels
FLASH = ("flash_attention_fwd", "flash_attention_dkv", "flash_attention_dq")


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def burst(port, prompts, n_tokens=N_TOKENS, trace_ids=None):
    """POST every prompt at once (request i with ``trace_ids[i]``, when
    given); returns the streams in order."""
    streams = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            streams[i] = post(port, prompts[i], n_tokens, trace_id=(
                trace_ids[i] if trace_ids is not None else None))
        except Exception as exc:  # reported below, fails the phase
            errors.append("request %d: %r" % (i, exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError("serving failed: %s" % errors)
    for stream in streams:
        if len(stream) != n_tokens or not all(0 <= t < VOCAB
                                              for t in stream):
            raise AssertionError("bad stream: %r" % (stream,))
    return streams


def serve(params, table, waves, quantize, device, paged=True, heads=HEADS,
          max_len=MAX_LEN, slots=SLOTS, n_tokens=N_TOKENS, on_zero=None,
          mesh=None):
    """Answer ``waves`` of prompts through a fresh GenerateAPI over HTTP
    (on the paged pool, or with ``paged=False`` the dense slab), each
    wave posted at once after the previous one completed. A short
    warm-up request runs first; every launch counter is zeroed after it
    and read after the last wave. Returns the streams, the wall seconds,
    the launches, the chunks, the host-blocking seconds (dispatch +
    collect, and admission), /healthz before and after the waves and the
    (stopped) API, by name. ``on_zero`` is called right after the
    counters are zeroed. ``mesh`` serves over a serving mesh (phase
    27), rank 0's side."""
    api = GenerateAPI(params, table, heads, slots=slots, max_len=max_len,
                      n_tokens=n_tokens, chunk=CHUNK, paged=paged,
                      page_size=PAGE, quantize=quantize, mesh=mesh,
                      device=device).start()
    try:
        # shorter than a page: never published to the prefix cache
        post(api.port, waves[0][0][:min(16, PAGE - 1)], CHUNK)
        torch.cuda.synchronize()
        health0 = api.health.snapshot()
        timings0 = dict(api.decoder.timings)
        for fn in COUNTERS.values():
            fn.launches = 0
        if on_zero is not None:
            on_zero()
        t0 = time.perf_counter()
        streams = [stream for wave in waves
                   for stream in burst(api.port, wave, n_tokens)]
        wall = time.perf_counter() - t0
        launches = counts()
        health = api.health.snapshot()
        chunks = (health["dispatch_counts"]["chunk"]
                  - health0["dispatch_counts"]["chunk"])
        host_s = sum(api.decoder.timings[key] - timings0[key]
                     for key in ("dispatch_s", "collect_s"))
        admit_s = api.decoder.timings["admit_s"] - timings0["admit_s"]
        return {"streams": streams, "wall": wall, "launches": launches,
                "chunks": chunks, "host_s": host_s, "admit_s": admit_s,
                "health0": health0, "health": health, "api": api}
    finally:
        api.stop()


def bf16_model(device):
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     dtype=torch.bfloat16, device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(
            device=device, dtype=torch.bfloat16)
    return params, table


def serving_phase(device, prompts):
    """The burst of ``prompts`` in the float, int8 and int8-KV tiers;
    each run must go through its kernels: K1 (or K3 in the int8-KV tier,
    where K1 must not launch) once per block and step, K2 in both int8
    tiers."""
    params, table = bf16_model(device)
    launches = dict.fromkeys(COUNTERS, 0)
    for quantize in (None, "int8", "int8-kv"):
        run = serve(params, table, [prompts], quantize, device)
        got, chunks = run["launches"], run["chunks"]
        steps = chunks * CHUNK
        attend = "paged_attend_int8" if quantize == "int8-kv" \
            else "paged_attend"
        print("serve %s bf16: %d requests x %d tokens in %.3f s = %.1f "
              "tokens/s; %d chunks of %d, %.3f host-blocking ms per chunk "
              "(dispatch + collect); launches K1 %d, K2 %d, K3 %d (%s >= "
              "%d blocks x %d steps); KV pool %d bytes"
              % (quantize or "float", len(prompts), N_TOKENS, run["wall"],
                 len(prompts) * N_TOKENS / run["wall"], chunks, CHUNK,
                 1e3 * run["host_s"] / max(chunks, 1),
                 got["paged_attend"], got["int8_matmul"],
                 got["paged_attend_int8"], attend, BLOCKS, steps,
                 paged_kv_bytes(run["api"].decoder.state)))
        if got[attend] < BLOCKS * steps or steps == 0:
            raise AssertionError("%s launches %d < %d blocks x %d steps"
                                 % (attend, got[attend], BLOCKS, steps))
        if quantize == "int8-kv" and got["paged_attend"]:
            raise AssertionError("the int8-KV run launched K1")
        if got["int8_cache_attend"]:
            raise AssertionError("the paged run launched K4")
        if quantize and got["int8_matmul"] < sum(K2_PER_STEP) * steps:
            raise AssertionError("the %s run launched K2 %d < %d per step "
                                 "x %d steps" % (quantize,
                                                 got["int8_matmul"],
                                                 sum(K2_PER_STEP), steps))
        for name, n in got.items():
            launches[name] += n
    return launches


def prefix_waves(rng):
    """The repo's shared-prompt mix (bench.py:1237-1281): a 256-token
    system prompt (two pages), then eight distinct tails of 24 + 8 i
    tokens behind it at once, then the system prompt twice more."""
    system = rng.randint(0, VOCAB, 2 * PAGE).tolist()
    tails = [system + rng.randint(0, VOCAB, 24 + 8 * i).tolist()
             for i in range(8)]
    return [[system], tails, [system], [system]]


def check_prefix_counts(health0, health, distinct=0):
    """One cold admission (the system prompt), eight tails and two
    hits: 10 prefix hits and 1 miss between the two /healthz reads, and a
    miss for each of ``distinct`` prompts served beside them."""
    def delta(section, key):
        return health[section][key] - health0[section][key]

    got = {"prefix_hits": delta("pool", "prefix_hits"),
           "prefix_misses": delta("pool", "prefix_misses"),
           "admit_tail": delta("dispatch_counts", "admit_tail"),
           "admit_hit": delta("dispatch_counts", "admit_hit")}
    if got["prefix_hits"] != 10 or got["prefix_misses"] != 1 + distinct \
            or got["admit_tail"] < 1 or got["admit_hit"] < 1:
        raise AssertionError("prefix traffic admitted %s, expected 10 "
                             "hits, %d miss(es), >= 1 tail and >= 1 hit "
                             "dispatch" % (got, 1 + distinct))
    return got


def admit_ms(dec, prompt):
    """Host-blocking ms of the admission of ``prompt``: the change in
    the decoder's ``timings["admit_s"]`` across the step that admits it
    (``bench.py:1241-1248``), the card idle before it."""
    rid = dec.submit(prompt, 1)
    torch.cuda.synchronize()
    before = dec.timings["admit_s"]
    dec.step()
    ms = 1e3 * (dec.timings["admit_s"] - before)
    dec.run_until_drained()
    dec.results.pop(rid, None)
    return ms


def prefix_phase(device, rng):
    """The shared-prompt traffic in the bf16 float tier through
    GenerateAPI; then, on the same (stopped) decoder, three fresh
    two-page prompts admitted cold and then again as hits."""
    params, table = bf16_model(device)
    waves = prefix_waves(rng)
    run = serve(params, table, waves, None, device)
    counted = check_prefix_counts(run["health0"], run["health"])
    got = run["launches"]
    requests = sum(len(wave) for wave in waves)
    print("prefix traffic bf16: %d requests x %d tokens in %.3f s = %.1f "
          "tokens/s, %d chunks; %s; launches K1 %d, K2 %d, K3 %d"
          % (requests, N_TOKENS, run["wall"],
             requests * N_TOKENS / run["wall"], run["chunks"], counted,
             got["paged_attend"], got["int8_matmul"],
             got["paged_attend_int8"]))
    if got["paged_attend"] == 0:
        raise AssertionError("the prefix traffic never launched K1")
    fresh = [rng.randint(0, VOCAB, 2 * PAGE) for _ in range(3)]
    dec = run["api"].decoder
    cold = [admit_ms(dec, prompt) for prompt in fresh]
    hits = dict(dec.dispatch_counts)
    hit = [admit_ms(dec, prompt) for prompt in fresh]
    if dec.dispatch_counts["admit_hit"] - hits["admit_hit"] != 3:
        raise AssertionError("the re-admitted prompts were not hits")
    print("admission of a %d-token prompt (host-blocking ms, admit_s, "
          "min of 3): cold %.3f, hit %.3f"
          % (2 * PAGE, min(cold), min(hit)))
    return got


def dense_run(params, table, prompts, quantize, device):
    """One drain of ``prompts`` through a fresh ContinuousDecoder on the
    dense slab with decode_continuous's stagger: the first SLOTS up
    front, then one more each lag-1 pass. Returns the decoder and the
    wall seconds of the drain, the card synchronised at both ends."""
    dec = ContinuousDecoder(params, table, HEADS, slots=SLOTS,
                            max_len=DENSE_MAX_LEN, n_tokens=DENSE_BUDGET,
                            quantize=quantize, device=device)
    pending = list(prompts)
    for _ in range(min(SLOTS, len(pending))):
        dec.submit(pending.pop())

    def admit():
        if pending:
            dec.submit(pending.pop())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.drain_pipelined(DENSE_CHUNK, admit=admit)
    torch.cuda.synchronize()
    return dec, time.perf_counter() - t0


def dense_phase(device):
    """decode_continuous's traffic on the dense slot slab in the float,
    int8 and int8-KV tiers: a warm run, then the counters zeroed and a
    measured run. The int8-KV run must launch K4 once per block and
    step and neither paged kernel, both int8 runs K2, the float run no
    attention kernel."""
    params, table = bf16_model(device)
    rng = numpy.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, DENSE_PROMPT)
               for _ in range(DENSE_REQUESTS)]
    launches = dict.fromkeys(COUNTERS, 0)
    for quantize in (None, "int8", "int8-kv"):
        dense_run(params, table, prompts, quantize, device)
        for fn in COUNTERS.values():
            fn.launches = 0
        dec, wall = dense_run(params, table, prompts, quantize, device)
        got = counts()
        steps = dec.dispatch_counts["chunk"] * DENSE_CHUNK
        timings = {key: round(1e3 * sec, 3)
                   for key, sec in dec.timings.items()}
        print("dense slab %s bf16: %d requests x %d tokens in %.3f s = %.1f "
              "tokens/s; host-blocking ms %s; dispatch_counts %s; max_len "
              "%d, slab K/V %d bytes, state %d bytes; launches %s"
              % (quantize or "float", DENSE_REQUESTS, DENSE_BUDGET, wall,
                 dec.tokens_out / wall, timings, dec.dispatch_counts,
                 dec.max_len, paged_kv_bytes(dec.state),
                 slot_state_bytes(dec.state), got))
        if dec.tokens_out != DENSE_REQUESTS * DENSE_BUDGET or any(
                len(stream) != DENSE_BUDGET
                or not all(0 <= t < VOCAB for t in stream)
                for stream in dec.results.values()):
            raise AssertionError("the dense %s run delivered %d tokens"
                                 % (quantize or "float", dec.tokens_out))
        if quantize == "int8-kv":
            if got["int8_cache_attend"] < BLOCKS * steps or steps == 0:
                raise AssertionError("K4 launched %d < %d blocks x %d "
                                     "steps" % (got["int8_cache_attend"],
                                                BLOCKS, steps))
            if got["paged_attend"] or got["paged_attend_int8"]:
                raise AssertionError("the dense int8-KV run launched a "
                                     "paged kernel")
        elif any(got[name] for name in ATTENTION):
            raise AssertionError("the dense %s run launched an attention "
                                 "kernel" % (quantize or "float"))
        if bool(quantize) != bool(got["int8_matmul"]):
            raise AssertionError("the dense %s run launched K2 %d times"
                                 % (quantize or "float",
                                    got["int8_matmul"]))
        for name, n in got.items():
            launches[name] += n
    return launches


def agreement_phase(device, prompts, waves):
    """float32 serving against the dense reference decode, on the paged
    pool and then on the dense slab (GenerateAPI with paged=False): float
    weights against generate() on the card (plain ops: no kernel may
    launch), int8 and int8-KV against generate() on the CPU (plain
    versions everywhere), and the shared-prompt traffic against
    generate() on the card. Each reference is decoded once and compared
    with every run of its tier."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02)
    runs = [("float", None, [prompts], True),
            ("int8", "int8", [prompts], True),
            ("int8-kv", "int8-kv", [prompts], True),
            ("prefix", None, waves, True),
            ("dense float", None, [prompts], False),
            ("dense int8", "int8", [prompts], False),
            ("dense int8-kv", "int8-kv", [prompts], False)]
    quantized = quantize_params(params)
    refs = {}
    for label, quantize, run_waves, paged in runs:
        tier = params if quantize is None else quantized
        run = serve(tier, table, run_waves, quantize, device, paged=paged)
        if label == "prefix":
            check_prefix_counts(run["health0"], run["health"])
        if paged != ("pool" in run["health"]):
            raise AssertionError("the %s run served the wrong KV tier"
                                 % label)
        compare_streams(label, tier, table, HEADS, quantize,
                        device if quantize is None else "cpu",
                        [p for wave in run_waves for p in wave],
                        run["streams"], refs)


def compare_streams(label, tier, table, heads, quantize, ref_device,
                    prompts, streams, refs, n_tokens=N_TOKENS):
    """Each stream against the dense reference decode (``generate``, which
    must launch no kernel) of its prompt, up to the first step where the
    reference's top-2 logit gap is below TOP2_GAP; ``refs`` caches the
    references by (tier, prompt)."""
    compared = cut = 0
    for prompt, stream in zip(prompts, streams):
        key = (quantize, tuple(prompt))
        if key not in refs:
            before = counts()
            ref, _, logits = generate(
                tier, table, numpy.asarray(prompt)[None], heads, n_tokens,
                return_logits=True, quantize=quantize, device=ref_device)
            if counts() != before:
                raise AssertionError("the reference decode launched a "
                                     "kernel")
            top2 = torch.topk(logits[0], 2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            n = next((i for i, g in enumerate(gaps) if g < TOP2_GAP),
                     len(gaps))
            refs[key] = (ref[0, :n].tolist(), len(gaps) - n)
        want, skipped = refs[key]
        if stream[:len(want)] != want:
            raise AssertionError(
                "%s stream disagrees with the reference: %r vs %r"
                % (label, stream[:len(want)], want))
        compared += len(want)
        cut += skipped
    print("agreement %s f32: %d steps compared, %d steps cut off at a "
          "reference top-2 gap below %.0e" % (label, compared, cut,
                                              TOP2_GAP))
    return compared


def narrow_heads_phase(device, prompts):
    """C4 on the serving path: the serving model's depth and vocabulary at
    embed 768 in 16 heads of 48 (head rows of 96 bf16 bytes; f32 here, so
    192), f32 weights, the paged pool in the float (K1) and int8-KV (K3)
    tiers, 8 requests x 16 tokens; each stream against the dense
    reference decode (on the card for float, the CPU for int8-KV) in
    every compared step."""
    t0 = time.perf_counter()
    rng = numpy.random.RandomState(3)
    params = init_transformer_params(rng, BLOCKS, NARROW_EMBED,
                                     NARROW_HEADS, VOCAB, device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, NARROW_EMBED).astype(numpy.float32) * 0.02)
    refs = {}
    for quantize, attend in ((None, "paged_attend"),
                             ("int8-kv", "paged_attend_int8")):
        tier = params if quantize is None else quantize_params(params)
        run = serve(tier, table, [prompts], quantize, device,
                    heads=NARROW_HEADS, n_tokens=NARROW_TOKENS)
        got = run["launches"][attend]
        print("serve %s f32, heads of %d: %d requests x %d tokens in %.3f "
              "s, %s launches %d" % (quantize or "float",
                                     NARROW_EMBED // NARROW_HEADS,
                                     len(prompts), NARROW_TOKENS,
                                     run["wall"], attend, got))
        if not got:
            raise AssertionError("the 48-wide %s run launched no %s"
                                 % (quantize or "float", attend))
        compare_streams("heads of 48, %s" % (quantize or "float"), tier,
                        table, NARROW_HEADS, quantize,
                        device if quantize is None else "cpu", prompts,
                        run["streams"], refs, NARROW_TOKENS)
    print("heads-of-48 serving phase: %.1f s" % (time.perf_counter() - t0))


def sampling_phase(device, prompts):
    """Per-request sampling streams on the card: ``prompts`` (8 requests)
    sampled at once through ContinuousDecoder on the dense slab at the
    serving model's width (float32 weights, SAMPLE_TEMPERATURE and
    SAMPLE_TOP_K, seed SAMPLE_SEED); then each request alone (the
    requests before it submitted and cancelled before any step, so it
    keeps its id and its key and takes another slot): its stream must
    equal its stream in the burst, and generate(batch=1,
    key=request_key(seed, request id)) on the card."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)

    def decoder():
        return ContinuousDecoder(
            params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
            n_tokens=N_TOKENS, temperature=SAMPLE_TEMPERATURE,
            top_k=SAMPLE_TOP_K, seed=SAMPLE_SEED, device=device)

    dec = decoder()
    dec.submit(prompts[0][:16], CHUNK)  # warm-up, its own request id 0
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [dec.submit(p) for p in prompts]
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [dec.results[rid] for rid in rids]
    if any(len(s) != N_TOKENS or not all(0 <= t < VOCAB for t in s)
           for s in streams) or len({tuple(s) for s in streams}) < 2:
        raise AssertionError("bad sampled streams: %r" % (streams,))
    for rid, prompt, stream in zip(rids, prompts, streams):
        alone = decoder()
        for _ in range(rid):
            alone.cancel(alone.submit(prompt))
        got = alone.submit(prompt)
        alone.drain_pipelined(CHUNK)
        if alone.results[got] != stream:
            raise AssertionError(
                "request %d sampled %r alone and %r in the burst"
                % (rid, alone.results[got], stream))
        ref, _ = generate(params, table, numpy.asarray(prompt)[None],
                          HEADS, N_TOKENS, temperature=SAMPLE_TEMPERATURE,
                          top_k=SAMPLE_TOP_K,
                          key=request_key(SAMPLE_SEED, rid), device=device)
        if ref[0].tolist() != stream:
            raise AssertionError(
                "request %d sampled %r in the burst, generate(key=) %r"
                % (rid, stream, ref[0].tolist()))
    print("sampling: %d requests x %d tokens at temperature %g, top-k %d, "
          "f32: %.1f tokens/s in the burst; every stream equal alone (its "
          "own id, another slot) and to generate(batch=1, key=)"
          % (len(prompts), N_TOKENS, SAMPLE_TEMPERATURE, SAMPLE_TOP_K,
             len(prompts) * N_TOKENS / wall))
    # the same burst through HTTP, temperature and top-k on the API: the
    # requests are posted in order (each staged before the next is sent,
    # so request i takes id i + 1 after the warm-up's 0) and all in
    # flight together; each stream must be the decoder's for its id
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK,
                      temperature=SAMPLE_TEMPERATURE, top_k=SAMPLE_TOP_K,
                      seed=SAMPLE_SEED, paged=False, device=device).start()
    try:
        post(api.port, prompts[0][:16], CHUNK)
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = post(api.port, prompts[i], N_TOKENS)

        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
            while api.decoder._next_id < i + 2:
                time.sleep(0.001)
        for thread in threads:
            thread.join(timeout=600)
    finally:
        api.stop()
    if answers != streams:
        raise AssertionError("sampled streams through HTTP %r differ from "
                             "the decoder's %r" % (answers, streams))
    print("sampling through HTTP (temperature %g, top-k %d on the API): "
          "%d streams equal the decoder's for the same request ids"
          % (SAMPLE_TEMPERATURE, SAMPLE_TOP_K, len(prompts)))


def post_retrying(port, tokens, n_tokens, codes):
    """POST until a 200, retrying on 429 and 503 (a client of a
    rebuilding replica); every reply's code goes to ``codes``."""
    for attempt in range(600):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % port,
            data=json.dumps({"tokens": tokens,
                             "n_tokens": n_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                codes.append(resp.status)
                return json.loads(resp.read().decode())["tokens"]
        except urllib.error.HTTPError as err:
            codes.append(err.code)
            if err.code not in (429, 503):
                raise
        time.sleep(0.01 * min(attempt + 1, 20))
    raise AssertionError("no 200 after 600 attempts")


def burst_retrying(port, prompts, codes, n_tokens=N_TOKENS):
    """``burst`` with retries on 429 and 503."""
    streams = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            streams[i] = post_retrying(port, prompts[i], n_tokens, codes)
        except Exception as exc:  # reported below, fails the phase
            errors.append("request %d: %r" % (i, exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError("serving failed: %s" % errors)
    return streams


def readyz(port):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d/readyz" % port,
                                    timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as err:
        return err.code


def heal_line(label, api):
    """The last rebuild's trip-to-ready seconds by part, as ms."""
    rb = api.last_rebuild
    return ("%s: trip to ready %.1f ms (shadow capture %.1f, decoder build "
            "%.1f, restore %.1f, probe %.1f); restored %d pages, %d bytes"
            % (label, 1e3 * rb["trip_to_ready_s"], 1e3 * rb["capture_s"],
               1e3 * rb["build_s"], 1e3 * rb["restore_s"],
               1e3 * rb["probe_s"], rb["restored_pages"],
               rb["restored_bytes"]))


def breaker_phase(device):
    """The circuit breaker at the serving model's width in three tiers
    (BREAKER_TIERS): the shared-prompt mix served once (the prefix cache
    fills), then a ServingChaosMonkey failing one step and the same mix
    again, clients retrying on 503 and 429. Every request must end with
    200, /readyz answer 200 with the breaker closed, the paged tiers
    admit the cached system prompt as a hit on the rebuilt decoder (no
    new prefix miss beyond the probe's and the int8-KV tier's cold
    tails), and the
    tier's attend kernel launch at least blocks x steps of the rebuilt
    decoder. Then the paged float tier in f32, requests one at a time:
    the streams after the trip equal a fault-free run's."""
    params, table = bf16_model(device)
    waves = prefix_waves(numpy.random.RandomState(5))
    launches = dict.fromkeys(COUNTERS, 0)
    for label, quantize, paged, attend in BREAKER_TIERS:
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          paged=paged, page_size=PAGE, quantize=quantize,
                          rebuild_backoff=SMOKE_BACKOFF,
                          device=device).start()
        try:
            codes = []
            post(api.port, waves[0][0][:min(16, PAGE - 1)], CHUNK)
            for wave in waves:
                burst_retrying(api.port, wave, codes)
            health0 = api.health.snapshot()
            api.chaos = ServingChaosMonkey(ServingChaosConfig(
                step_fail=1.0, step_fail_max=1))
            for fn in COUNTERS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            streams = [s for wave in waves
                       for s in burst_retrying(api.port, wave, codes)]
            wall = time.perf_counter() - t0
            got = counts()
            health = api.health.snapshot()
            ready = readyz(api.port)
        finally:
            api.stop()
        delta = {k: health["counters"][k] - health0["counters"][k]
                 for k in ("shed", "trips", "rebuilds")}
        chunks = api.decoder.dispatch_counts["chunk"]
        steps = chunks * CHUNK
        print("breaker %s bf16: %d requests x %d tokens over the trip in "
              "%.3f s = %.1f tokens/s; shed %d, trips %d, rebuilds %d; "
              "replies %s; %s launches %d (>= %d blocks x %d steps of the "
              "rebuilt decoder), K2 %d"
              % (label, len(streams), N_TOKENS, wall,
                 len(streams) * N_TOKENS / wall, delta["shed"],
                 delta["trips"], delta["rebuilds"],
                 {c: codes.count(c) for c in sorted(set(codes))}, attend,
                 got[attend], BLOCKS, steps, got["int8_matmul"]))
        print(heal_line("breaker %s" % label, api))
        if delta["trips"] != 1 or delta["rebuilds"] != 1 \
                or delta["shed"] < 1:
            raise AssertionError("the %s breaker did not trip, shed and "
                                 "rebuild once: %s" % (label, delta))
        if ready != 200 or health["breaker"] != "closed" \
                or not health["ready"]:
            raise AssertionError("the %s front did not heal: /readyz %d, "
                                 "%s" % (label, ready, health["breaker"]))
        if set(codes) - {200, 429, 503}:
            raise AssertionError("the %s run answered %s"
                                 % (label, sorted(set(codes))))
        if got[attend] < BLOCKS * steps or steps == 0:
            raise AssertionError("%s launches %d < %d blocks x %d steps"
                                 % (attend, got[attend], BLOCKS, steps))
        if paged:
            hits = health["dispatch_counts"]["admit_hit"]
            misses = (health["pool"]["prefix_misses"]
                      - health0["pool"]["prefix_misses"])
            # the probe's one-token prompt is the one cold admission the
            # float pool makes; the int8-KV pool reuses exact prompts
            # only, so its tails (not page-aligned) go cold too
            cold = 1 + (len(waves[1]) if quantize == "int8-kv" else 0)
            print("breaker %s: on the rebuilt decoder admit_hit %d, "
                  "admit_tail %d, prefix misses +%d (expected +%d)"
                  % (label, hits, health["dispatch_counts"]["admit_tail"],
                     misses, cold))
            if hits < 1 or misses != cold:
                raise AssertionError("the %s pool did not admit the "
                                     "cached prompts as hits over the "
                                     "restored pages" % label)
        for name, n in got.items():
            launches[name] += n
    breaker_agreement(device, waves)
    return launches


def breaker_agreement(device, waves):
    """The paged float tier in f32 at the serving width, the mix posted
    one request at a time twice: with a trip at the start of the second
    pass the second pass's streams equal a fault-free run's, step for
    step (the restored pages are copies; the hits' cached logits
    survive)."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)
    prompts = [p for wave in waves for p in wave]
    runs = []
    for chaos in (False, True):
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          paged=True, page_size=PAGE,
                          rebuild_backoff=SMOKE_BACKOFF,
                          device=device).start()
        try:
            codes = []
            for prompt in prompts:
                post_retrying(api.port, prompt, N_TOKENS, codes)
            if chaos:
                api.chaos = ServingChaosMonkey(ServingChaosConfig(
                    step_fail=1.0, step_fail_max=1))
            runs.append([post_retrying(api.port, p, N_TOKENS, codes)
                         for p in prompts])
            trips = api.health.counter("trips")
        finally:
            api.stop()
        if trips != int(chaos):
            raise AssertionError("f32 breaker run: %d trips" % trips)
    if runs[0] != runs[1]:
        raise AssertionError("the f32 streams after the trip differ from "
                             "the fault-free run's")
    print("breaker agreement paged float f32: %d streams after the trip "
          "equal the fault-free run's step for step (%d tokens)"
          % (len(prompts), sum(len(s) for s in runs[1])))


def swap_phase(device, prompts):
    """The live hot swap in the int8 tier on the paged pool (K2 + K1) at
    the serving width, f32 activations: weights A serve; a burst holds
    every slot when swap_params(B) is asked for: no reply but 200, and
    the burst's streams equal A's (they drain on A); then each prompt
    equals a fresh GenerateAPI on B, rollback_swap() brings A's streams
    back, and a checkpoint with one NaN leaf is refused, naming it,
    while A keeps serving. Requests are posted one at a time where
    streams are compared across runs, so the batches match."""
    rng = numpy.random.RandomState(0)
    params_a = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                       device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)
    params_b = init_transformer_params(numpy.random.RandomState(SWAP_SEED),
                                       BLOCKS, EMBED, HEADS, VOCAB,
                                       device=device)

    def api_on(params):
        return GenerateAPI(params, table, HEADS, slots=SLOTS,
                           max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                           paged=True, page_size=PAGE, quantize="int8",
                           device=device).start()

    def one_by_one(api):
        return [post(api.port, p, N_TOKENS) for p in prompts]

    fresh = api_on(params_b)
    try:
        want_b = one_by_one(fresh)
    finally:
        fresh.stop()
    api = api_on(params_a)
    try:
        want_a = one_by_one(api)
        answers = [None] * len(prompts)
        codes = []

        def client(i):
            answers[i] = post_retrying(api.port, prompts[i], N_TOKENS,
                                       codes)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        first = api.decoder._next_id
        for thread in threads:
            thread.start()
        # every request submitted to the decoder: it decodes on A
        while api.decoder._next_id < first + len(prompts):
            time.sleep(0.001)
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        api.swap_params(params_b, version="B")
        swap_wall = time.perf_counter() - t0
        timings = dict(api.last_swap)
        for thread in threads:
            thread.join(timeout=600)
        after = one_by_one(api)
        got = counts()
        api.rollback_swap()
        rolled = one_by_one(api)
        poisoned = dict(params_b, lnf_w=torch.full_like(params_b["lnf_w"],
                                                        float("nan")))
        try:
            api.swap_params(poisoned, version="poisoned")
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        still = one_by_one(api)
        health = api.health.snapshot()
    finally:
        api.stop()
    print("hot swap int8 f32: swap_params wall %.1f ms (drain %.1f, swap "
          "and quantize %.1f, probe %.1f); replies %s; launches after the "
          "swap K1 %d, K2 %d"
          % (1e3 * swap_wall, 1e3 * timings["drain_s"],
             1e3 * timings["swap_s"], 1e3 * timings["probe_s"],
             {c: codes.count(c) for c in sorted(set(codes))},
             got["paged_attend"], got["int8_matmul"]))
    if set(codes) != {200}:
        raise AssertionError("5xx or 429 across the swap: %s" % codes)
    if answers != want_a:
        raise AssertionError("the in-flight burst did not finish on A")
    if after != want_b:
        raise AssertionError("after the swap the streams differ from a "
                             "fresh API on B")
    if rolled != want_a or still != want_a:
        raise AssertionError("rollback or the refused swap did not leave "
                             "A serving")
    if refused is None or "['lnf_w']" not in refused:
        raise AssertionError("the NaN checkpoint was not refused by "
                             "name: %r" % refused)
    if not got["paged_attend"] or not got["int8_matmul"]:
        raise AssertionError("the swapped weights did not run K1 and K2")
    if health["counters"]["param_swaps"] != 2 \
            or health["counters"]["swap_failures"] != 1:
        raise AssertionError("swap counters %s" % health["counters"])
    print("hot swap: in-flight burst on A, %d prompts equal a fresh API on "
          "B, rollback back to A, NaN checkpoint refused (%s)"
          % (len(prompts), refused))
    return got


def bench_dataset(n=60000, features=784, classes=10, n_valid=10000):
    """The bench's MNIST-shaped set (bench.py:61-81): uniform pixels from
    RandomState(0), class-balanced shuffled labels, valid block first."""
    rng = numpy.random.RandomState(0)
    data = rng.rand(n, features).astype(numpy.float32)
    blocks = []
    for length in (n_valid, n - n_valid):
        block = numpy.tile(numpy.arange(classes, dtype=numpy.int32),
                           length // classes + 1)[:length]
        rng.shuffle(block)
        blocks.append(block)
    return data, numpy.concatenate(blocks)


def build_mlp(device, data, labels, layers, minibatch, class_lengths,
              knobs, epochs, precision_level=0, sweep=True, weights=None,
              fused="auto"):
    """An MLPWorkflow as bench.py builds it (seeds 1234, linear
    normalization, lr 0.03) with the engine knobs set, in the fused tick
    or (``fused=False``) graph mode; ``weights`` (per-layer numpy dicts)
    are put into the units before initialize()."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = MLPWorkflow(
        DummyLauncher(), layers=layers,
        loader_kwargs=dict(data=data, labels=labels,
                           class_lengths=class_lengths,
                           minibatch_size=minibatch,
                           normalization_type="linear"),
        learning_rate=TRAIN_LR, max_epochs=epochs, fused_sweep=sweep,
        fused=fused, device=device, name="mlp")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def train(wf, device):
    """initialize() and run() ``wf``; returns the per-epoch records
    (host clock at the epoch's summary and at run()'s start, train loss,
    validation n_err) and the wall seconds of run(), the card
    synchronised at both ends."""
    epochs = []
    summary = wf.decision._epoch_summary

    def stamped(stats, epoch):
        epochs.append({"t": time.perf_counter(), "t0": t0,
                       "train_loss": stats[TRAIN][2] / max(stats[TRAIN][1],
                                                           1),
                       "valid_n_err": stats[VALID][0],
                       "valid_mse": stats[VALID][2] / max(stats[VALID][1],
                                                          1)})
        summary(stats, epoch)

    wf.decision._epoch_summary = stamped
    wf.initialize()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return epochs, time.perf_counter() - t0


def report_training(label, wf, epochs, wall, n_images):
    """Print images/s as bench.py:101-128 reads it (the dataset's images
    over the mean interval between epoch summaries) beside the whole
    run's, and the per-epoch train loss and validation n_err; fail on a
    non-finite loss."""
    stamps = [e["t"] for e in epochs]
    deltas = [b - a for a, b in zip(stamps, stamps[1:])]
    rate = n_images / (sum(deltas) / len(deltas)) if deltas else None
    losses = [e["train_loss"] for e in epochs]
    print("train %s: %d epochs, images/s %s (bench reading: mean of %d "
          "epoch intervals), %.1f over the whole run (%.3f s); train loss "
          "%s; validation n_err %s; minibatches per class (test, valid, "
          "train) %s" % (label, len(epochs),
                         "%.1f" % rate if rate else "n/a", len(deltas),
                         n_images * len(epochs) / wall, wall,
                         ["%.6f" % v for v in losses],
                         [e["valid_n_err"] for e in epochs],
                         minibatch_counts(wf)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)
    return losses


def training_phase(device):
    """The wide MLP on the bench data, 3 epochs, knobs on — the main
    path: the counters are zeroed before the run and must show K6 once
    per train and eval minibatch and K5 once per train minibatch (the
    first layer needs no input gradient; the 10-wide head is no kernel's)
    and no serving kernel; then the same with the knobs off (no kernel)
    twice and on once more (on, off, off, on: both orders, one card), and
    the reference MNIST784 configuration (no kernel). Returns the main
    run's launches."""
    data, labels = bench_dataset()
    runs = [("wide MLP 784-4096-10 mb 4096, knobs %s"
             % ("on" if knobs else "off"), WIDE_LAYERS, WIDE_MINIBATCH, knobs)
            for knobs in (True, False, False, True)]
    runs.append(("reference MNIST784 784-100-10 mb 100", MNIST_LAYERS,
                 MNIST_MINIBATCH, False))
    main = None
    for label, layers, minibatch, knobs in runs:
        wf = build_mlp(device, data, labels, layers, minibatch,
                       BENCH_CLASS_LENGTHS, knobs, TRAIN_EPOCHS)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        losses = report_training(label, wf, epochs, wall, len(data))
        test, valid, train_mb = wf.fused_tick.minibatch_counts
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want.update(dense_epilogue=test + valid + train_mb,
                        blocked_matmul=train_mb)
            main = main or got
            if not losses[-1] < losses[0]:
                raise AssertionError("the last epoch's train loss %.6f is "
                                     "not below the first's %.6f"
                                     % (losses[-1], losses[0]))
        print("  launches %s (the tick's minibatches require %s)"
              % (got, {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != TRAIN_EPOCHS:
            raise AssertionError("%s: %d epochs, launches %s, expected %s"
                                 % (label, len(epochs), got, want))
        del wf
    return main


def minibatch_counts(wf):
    """The (test, valid, train) minibatches the run stepped: the fused
    tick's count, or in graph mode and the lower tiers the loader's
    epochs times its minibatches a class."""
    if wf.fused_tick is not None:
        return wf.fused_tick.minibatch_counts
    size = wf.loader.max_minibatch_size
    return [wf.decision.epochs_done * -(-n // size)
            for n in wf.loader.class_lengths]


def recorded_run(wf):
    """initialize() and run() a per-minibatch workflow (the fused tick, or
    graph mode: the evaluator's firing) with the counters zeroed first;
    returns the served index blocks, each tick's n_err, the launches and
    the wall seconds of run() (the card synchronised)."""
    served, n_errs = [], []
    serve_next = wf.loader.serve_next_minibatch

    def recorded():
        block = serve_next()
        served.append(block[1])
        return block

    wf.loader.serve_next_minibatch = recorded
    wf.initialize()
    tick = wf.fused_tick or wf.evaluator
    tick_run = tick.run

    def counted():
        tick_run()
        n_errs.append(int(wf.evaluator.n_err.data))

    tick.run = counted
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    if wf.device.type == "cuda":
        torch.cuda.synchronize()
    return served, n_errs, counts(), time.perf_counter() - t0


def training_agreement_phase(device):
    """One epoch of the wide MLP at precision level 2 (K5 and K6 on f32
    operands) on the card and on the CPU (plain versions), per-minibatch
    serving, from the same weights drawn with numpy: the served index
    streams must be equal, each minibatch's n_err within
    AGREE_N_ERR_TOL, the final weights within AGREE_WEIGHT_ATOL."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, labels = data[:n], labels[:n]
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    results = []
    for dev in (device, torch.device("cpu")):
        wf = build_mlp(dev, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       AGREE_CLASS_LENGTHS, True, 1, precision_level=2,
                       sweep=False, weights=weights)
        served, n_errs, got, _ = recorded_run(wf)
        results.append((served, n_errs, [
            f.weights.data.cpu() for f in wf.forwards], got))
    (served_c, errs_c, w_c, got_c), (served_h, errs_h, w_h, got_h) = results
    same_stream = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    n_err_diff = max(abs(a - b) for a, b in zip(errs_c, errs_h))
    w_diff = max((a - b).abs().max().item() for a, b in zip(w_c, w_h))
    print("training agreement f32 (level 2), 1 epoch, %d minibatches: "
          "index streams %s; n_err card %s, CPU %s (max diff %d, tolerance "
          "%d); weights max abs diff %.3g (tolerance %.0e); card launches "
          "K5 %d, K6 %d; CPU launches %d"
          % (len(served_c), "equal" if same_stream else "DIFFER", errs_c,
             errs_h, n_err_diff, AGREE_N_ERR_TOL, w_diff,
             AGREE_WEIGHT_ATOL, got_c["blocked_matmul"],
             got_c["dense_epilogue"], sum(got_h.values())))
    if not same_stream or len(errs_c) != len(errs_h) \
            or n_err_diff > AGREE_N_ERR_TOL or not w_diff <= AGREE_WEIGHT_ATOL:
        raise AssertionError("the card's training disagrees with the CPU's")
    if not (got_c["blocked_matmul"] and got_c["dense_epilogue"]) \
            or any(got_h.values()):
        raise AssertionError("the card run skipped a kernel or the CPU run "
                             "launched one")


def balanced_labels(rng, classes, *lengths):
    """Label blocks, each as class-balanced as its length allows and
    shuffled (bench.py:61-73)."""
    blocks = []
    for length in lengths:
        block = numpy.tile(numpy.arange(classes, dtype=numpy.int32),
                           length // classes + 1)[:length]
        rng.shuffle(block)
        blocks.append(block)
    return numpy.concatenate(blocks)


def alexnet_dataset():
    """bench.py:786-792's AlexNet data: RandomState(0) pixels in [0, 255)
    of 227 x 227 x 3 (1.85 GB as f32), 1000 valid then 2000 train,
    exactly proportional over the 1000 classes."""
    rng = numpy.random.RandomState(0)
    n = sum(ALEX_CLASS_LENGTHS)
    data = (rng.rand(n, ALEX_HW, ALEX_HW, 3) * 255).astype(numpy.float32)
    return data, balanced_labels(rng, ALEX_CLASSES, *ALEX_CLASS_LENGTHS[1:])


def build_standard(device, data, labels, class_lengths, minibatch, epochs,
                   knobs=False, precision_level=0, sweep=True, layers=None,
                   scale=1.0, n_classes=ALEX_CLASSES, transform=None,
                   normalization="mean_disp", **trainer):
    """AlexNetWorkflow (or, with ``layers``, a StandardWorkflow of them)
    as bench.py:793-803 builds it (seeds 1, the JAX package's trainer
    defaults) with the engine knobs and precision level set; unpipelined
    (each epoch's summary waits for that epoch on the card, so the
    intervals between summaries are the epochs' times)."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1)
    prng.get("loader").seed(1)
    kwargs = dict(loader_kwargs=dict(data=data, labels=labels,
                                     class_lengths=class_lengths,
                                     minibatch_size=minibatch,
                                     normalization_type=normalization,
                                     train_transform=transform),
                  decision_kwargs=dict(max_epochs=epochs),
                  fused_sweep=sweep, fused_pipeline=False, device=device,
                  **trainer)
    if layers is None:
        return AlexNetWorkflow(DummyLauncher(), n_classes=n_classes,
                               scale=scale, name="alexnet", **kwargs)
    return StandardWorkflow(DummyLauncher(), layers=layers, name="convnet",
                            **kwargs)


def report_epochs(label, wf, epochs, wall, n_images):
    """Images/s over the whole run and in each epoch (the interval since
    the previous epoch's summary; the first from the run's start), the
    per-epoch train loss and validation n_err; fails on a non-finite
    loss."""
    losses = [e["train_loss"] for e in epochs]
    stamps = [epochs[0]["t0"]] + [e["t"] for e in epochs]
    per_epoch = [n_images / (b - a) for a, b in zip(stamps, stamps[1:])]
    print("train %s: %d epochs in %.3f s, %.1f images/s over the run; per "
          "epoch %s; train loss %s; validation n_err %s; minibatches per "
          "class (test, valid, train) %s"
          % (label, len(epochs), wall, n_images * len(epochs) / wall,
             ["%.1f" % r for r in per_epoch], ["%.6f" % v for v in losses],
             [e["valid_n_err"] for e in epochs],
             wf.fused_tick.minibatch_counts))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)
    return n_images * len(epochs) / wall


def alexnet_phase(device):
    """AlexNet-227 (bench.py:777-817) on the card: minibatch 128, level 0,
    the knobs at their defaults, ALEX_EPOCHS epochs; then minibatch 512
    with use_pallas and pallas_epilogue on (the main path of K6 forward
    and K5 backward at the three dense layers: 9216 -> 4096 -> 4096 ->
    1000; the counters are zeroed before the run) and off. Images/s and
    per-epoch losses for each; returns the knobs-on run's launches."""
    t0 = time.perf_counter()
    data, labels = alexnet_dataset()
    n = len(data)
    print("AlexNet data: %d x %d x %d x 3 f32 (%.2f GB) in %.1f s"
          % (n, ALEX_HW, ALEX_HW, data.nbytes / 1e9,
             time.perf_counter() - t0))
    main = None
    for minibatch, epochs, knobs in (
            (ALEX_MINIBATCH, ALEX_EPOCHS, False),
            (ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS, True),
            (ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS, False)):
        wf = build_standard(device, data, labels, ALEX_CLASS_LENGTHS,
                            minibatch, epochs, knobs=knobs)
        for fn in COUNTERS.values():
            fn.launches = 0
        records, wall = train(wf, device)
        got = counts()
        label = "AlexNet-227 mb %d, knobs %s" % (minibatch,
                                                  "on" if knobs else "off")
        report_epochs(label, wf, records, wall, n)
        _, valid, train_mb = wf.fused_tick.minibatch_counts
        print("  launches K5 %d, K6 %d (%d valid and %d train minibatches)"
              % (got["blocked_matmul"], got["dense_epilogue"], valid,
                 train_mb))
        if len(records) != epochs:
            raise AssertionError("%s ran %d epochs" % (label, len(records)))
        others = sum(v for k, v in got.items()
                     if k not in ("blocked_matmul", "dense_epilogue"))
        if knobs:
            # three dense forwards a minibatch; the backward's weight and
            # input gradients (the first dense layer's input gradient
            # goes to the last pool, so it is taken too)
            if got["dense_epilogue"] < 3 * (valid + train_mb) \
                    or got["blocked_matmul"] < 3 * train_mb or others:
                raise AssertionError("%s: launches %s" % (label, got))
            main = got
        elif any(got.values()):
            raise AssertionError("%s launched a kernel: %s" % (label, got))
        del wf
        torch.cuda.empty_cache()
    print("AlexNet phase: %.1f s" % (time.perf_counter() - t0))
    return main


def unit_leaves(wf):
    """Each forward's weights and bias as numpy ({} for a pool): what
    ``unit_params_from_jax`` takes."""
    return [{"weights": f.weights.data.cpu().numpy().copy(),
             "bias": f.bias.data.cpu().numpy().copy()}
            if getattr(f, "weights", None) is not None else {}
            for f in wf.forwards]


def conv_recorded_run(wf):
    """initialize() and run() a per-minibatch convnet; returns each tick's
    served indices with its augmentation seed, each tick's n_err, the
    initial and the final leaves, and the launches."""
    served, n_errs = [], []
    loader_run = wf.loader.run

    def recorded():
        loader_run()
        served.append((wf.loader.minibatch_indices.data.copy(),
                       getattr(wf.loader, "minibatch_transform_seed", 0)))

    wf.loader.run = recorded
    wf.initialize()
    initial = unit_leaves(wf)
    tick_run = wf.fused_tick.run

    def counted():
        tick_run()
        n_errs.append(int(wf.evaluator.n_err.data))

    wf.fused_tick.run = counted
    for fn in COUNTERS.values():
        fn.launches = 0
    wf.run()
    if wf.device.type == "cuda":
        torch.cuda.synchronize()
    return served, n_errs, initial, unit_leaves(wf), counts()


def conv_agreement_phase(device):
    """One epoch at precision level 2 on the CPU and on the card from the
    same weights (the CPU run's initial ones carried across),
    per-minibatch serving: (a) AlexNet at scale 1/8 on 67 x 67 x 3
    pixels, (b) the digits_conv stack with maxabs pooling and shift1 on
    8 x 8 x 1 pixels. The served indices and augmentation seeds must be
    equal, each minibatch's n_err within CONV_N_ERR_TOL, every leaf
    within CONV_LEAF_RTOL of its largest element."""
    t0 = time.perf_counter()
    rng = numpy.random.RandomState(8)
    n = sum(CONV_AGREE_CLASS_LENGTHS)
    alex = dict(data=(rng.rand(n, CONV_AGREE_HW, CONV_AGREE_HW, 3)
                      * 255).astype(numpy.float32),
                labels=balanced_labels(rng, 10,
                                       *CONV_AGREE_CLASS_LENGTHS[1:]),
                class_lengths=CONV_AGREE_CLASS_LENGTHS, minibatch=64,
                scale=CONV_AGREE_SCALE, n_classes=10)
    n = sum(DIGITS_CLASS_LENGTHS)
    digits = dict(data=(rng.rand(n, 8, 8, 1) * 16).astype(numpy.float32),
                  labels=balanced_labels(rng, 10, *DIGITS_CLASS_LENGTHS[1:]),
                  class_lengths=DIGITS_CLASS_LENGTHS, minibatch=100,
                  layers=DIGITS_CONV_LAYERS, transform="shift1",
                  normalization="linear", learning_rate=0.02,
                  gradient_moment=0.9)
    for label, config in (("AlexNet scale 1/8, 67 x 67", alex),
                          ("digits_conv maxabs + shift1, 8 x 8", digits)):
        config = dict(config)
        args = [config.pop(key) for key in ("data", "labels",
                                            "class_lengths", "minibatch")]
        host = build_standard(torch.device("cpu"), *args, 1,
                              precision_level=2, sweep=False, **config)
        served_h, errs_h, initial, leaves_h, got_h = conv_recorded_run(host)
        card = build_standard(device, *args, 1, precision_level=2,
                              sweep=False, **config)
        unit_params_from_jax(card, initial)
        served_c, errs_c, _, leaves_c, got_c = conv_recorded_run(card)
        same = len(served_c) == len(served_h) and all(
            numpy.array_equal(a[0], b[0]) and a[1] == b[1]
            for a, b in zip(served_c, served_h))
        seeds = sum(1 for _, seed in served_c if seed)
        n_err_diff = max(abs(a - b) for a, b in zip(errs_c, errs_h))
        leaf_rel = max(float(numpy.abs(a[k] - b[k]).max()
                             / numpy.abs(b[k]).max())
                       for a, b in zip(leaves_c, leaves_h) for k in b)
        print("conv agreement %s, f32 (level 2), 1 epoch, %d minibatches: "
              "index streams and %d augmentation seeds %s; n_err card %s, "
              "CPU %s (max diff %d, tolerance %d); leaves max diff %.3g of "
              "their largest (tolerance %.0e); launches card %d, CPU %d"
              % (label, len(served_c), seeds,
                 "equal" if same else "DIFFER", errs_c, errs_h, n_err_diff,
                 CONV_N_ERR_TOL, leaf_rel, CONV_LEAF_RTOL,
                 sum(got_c.values()), sum(got_h.values())))
        if not same or len(errs_c) != len(errs_h) \
                or n_err_diff > CONV_N_ERR_TOL \
                or not leaf_rel <= CONV_LEAF_RTOL:
            raise AssertionError("the card's %s training disagrees with the "
                                 "CPU's" % label)
    print("conv agreement phase: %.1f s" % (time.perf_counter() - t0))


def flash_problem(gen, device, shape, dtype):
    """q, k, v of the (batch, T, heads, head_dim) ``shape`` as the qkv
    projection hands them to the kernels: split views of one (batch, T,
    3 heads head_dim) tensor, read in place; and a random dO."""
    batch, t, heads, dim = shape
    qkv = torch.randn((batch, t, 3 * heads * dim), generator=gen,
                      device=device).to(dtype)
    q, k, v = (part.reshape(shape) for part in qkv.split(heads * dim, -1))
    do = torch.randn(shape, generator=gen, device=device).to(dtype)
    return q, k, v, do


def row_errors(out, ref):
    """The worst row's error relative to that row's own norm (a row: the
    last axis, one position's head_dim values for one head; the norm at
    least FLASH_ROW_FLOOR of the median row's), that row's position on
    axis 1, and the whole tensor's error relative to the reference's
    norm."""
    diff, ref = out.float() - ref.float(), ref.float()
    norms = ref.norm(dim=-1)
    rows = diff.norm(dim=-1) / norms.clamp_min(
        FLASH_ROW_FLOOR * norms.median())
    worst = rows.flatten().argmax().item()
    return (rows.flatten()[worst].item(),
            worst // rows.shape[2] % rows.shape[1],
            (diff.norm() / ref.norm()).item())


def flash_error(label, out, ref, tol):
    """Hold ``out`` (B, T, H, D) against ``ref`` row by row: the worst
    row's error relative to its own norm within ``tol`` (and so the max
    abs error within ``tol`` of the largest |reference|). A planted
    fault, the last FLASH_TILE positions' rows of ``out`` scaled by
    FLASH_FAULT, must read past ``tol``. Prints the readings; returns the
    max abs error."""
    worst, where, whole = row_errors(out, ref)
    planted = out.float().clone()
    planted[:, -FLASH_TILE:] *= FLASH_FAULT
    control = row_errors(planted, ref)[0]
    err = (out.float() - ref.float()).abs().max().item()
    print("%s: worst row %.3g of its own norm at position %d (tolerance "
          "%.0e), whole tensor %.3g of its norm, max_abs_err %.3g; planted "
          "fault (last %d positions x %g) reads %.3g"
          % (label, worst, where, tol, whole, err, FLASH_TILE, FLASH_FAULT,
             control))
    if not (worst <= tol and err <= tol * ref.float().abs().max().item()):
        raise AssertionError("%s disagrees with its plain version" % label)
    if not control > tol:
        raise AssertionError("%s: the check does not see the planted fault"
                             % label)
    return err


def flash_ops(shape, products):
    """The operations of a causal flash call at ``shape``: ``products``
    products of 2 D operations over the T (T + 1) / 2 visible pairs of
    each (row, head)."""
    batch, t, heads, dim = shape
    return products * 2 * dim * batch * heads * t * (t + 1) // 2


def flash_bound(shape, products, nbytes):
    """The least time of a causal flash call at ``shape``: its
    operations at the bf16 tensor-core rate, or ``nbytes`` at the memory
    rate, whichever is larger."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = flash_ops(shape, products) / BF16_OPS_PER_S
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def schedule_tail(walks, sms):
    """A model of a causal kernel's last wave, not a measurement: blocks
    whose work is ``walks`` (tiles walked), dispatched longest first, each
    to the SM that frees first (one block an SM). Returns when the last SM
    ends, as a share of the time a perfect balance would take."""
    loads = [0] * sms
    for walk in sorted(walks, reverse=True):
        heapq.heapreplace(loads, loads[0] + walk)
    return max(loads) * sms / sum(walks)


def flash_schedules(shape):
    """The 128-wide K8's and K9's walks at a causal ``shape``, in 64-row
    tiles: K8's block of 128 keys from k0 walks the queries from k0 on, K9's
    block of 128 queries the keys up to its last query."""
    batch, t, heads, _ = shape
    blocks = range(0, t, 128)
    per_row = batch * heads
    return {"dkv": [-(-(t - k0) // 64) for k0 in blocks] * per_row,
            "dq": [-(-min(t, q0 + 128) // 64) for q0 in blocks] * per_row}


def check_backward(label, q, k, v, do, out, lse):
    """K8 and K9 against their plain versions on the forward's ``out``
    and ``lse`` (flash_error's row-wise rule, FLASH_BWD_RTOL, with its
    planted fault). Returns (K8's max abs error, K9's, di)."""
    di = _row_dot(out, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di, True)
    ref_dk, ref_dv = _flash_attention_dkv_plain(q, k, v, do, lse, di, True)
    torch.cuda.synchronize()
    dkv = max(flash_error("K8 flash_attention_dkv dK " + label, dk, ref_dk,
                          FLASH_BWD_RTOL),
              flash_error("K8 flash_attention_dkv dV " + label, dv, ref_dv,
                          FLASH_BWD_RTOL))
    del dk, dv, ref_dk, ref_dv
    dq = flash_attention_dq(q, k, v, do, lse, di, True)
    ref_dq = _flash_attention_dq_plain(q, k, v, do, lse, di, True)
    torch.cuda.synchronize()
    return dkv, flash_error("K9 flash_attention_dq dQ " + label, dq, ref_dq,
                            FLASH_BWD_RTOL), di


def flash_phase(timer, device, gen):
    """K7 against its plain version at a ragged serving prefill (2 rows
    of 5000 positions, bf16 and f32) and at the training shape (1, 8192,
    8, 128) bf16, causal; K8 and K9 at both shapes in bf16 (the serving
    shape's batch and ragged T reach the tiles' edges, which 8192 hides).
    Each timed at the training shape beside its plain version and the
    library yardstick: scaled_dot_product_attention(is_causal=True)
    forward for K7, its autograd backward (dQ, dK and dV in one call) for
    K8 and K9; the rates beside the bound, and a model of K8's and K9's
    last wave."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = flash_problem(gen, device, FLASH_SERVE_SHAPE, dtype)
        label = "%s %s" % ("x".join(map(str, FLASH_SERVE_SHAPE)),
                           str(dtype).split(".")[-1])
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], flash_error(
            "K7 flash_attention_fwd " + label, out, ref,
            K7_RTOL if dtype == torch.bfloat16 else K7_F32_RTOL))
        if dtype == torch.bfloat16:
            worst["dkv"], worst["dq"], _ = check_backward(label, q, k, v, do,
                                                          out, lse)
    q, k, v, do = flash_problem(gen, device, FLASH_TRAIN_SHAPE,
                                torch.bfloat16)
    label = "x".join(map(str, FLASH_TRAIN_SHAPE)) + " bf16"
    out, lse = flash_attention_fwd(q, k, v, True)
    ref, _ = _flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    worst["fwd"] = max(worst["fwd"], flash_error(
        "K7 flash_attention_fwd " + label, out, ref, K7_RTOL))
    del ref
    dkv_err, dq_err, di = check_backward(label, q, k, v, do, out, lse)
    worst["dkv"] = max(worst["dkv"], dkv_err)
    worst["dq"] = max(worst["dq"], dq_err)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [t.transpose(1, 2) for t in (q, k, v)]
    leaves = [t.detach().requires_grad_(True) for t in heads_first]
    lib_out = sdpa(*leaves, is_causal=True)
    lib_do = do.transpose(1, 2)
    lib_bwd_ms = timer(lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                                   retain_graph=True))
    times = {
        "fwd": (timer(lambda: flash_attention_fwd(q, k, v, True)),
                timer(lambda: _flash_attention_fwd_plain(q, k, v, True)),
                timer(lambda: sdpa(*heads_first, is_causal=True))),
        "dkv": (timer(lambda: flash_attention_dkv(q, k, v, do, lse, di,
                                                  True)),
                timer(lambda: _flash_attention_dkv_plain(q, k, v, do, lse,
                                                         di, True)),
                lib_bwd_ms),
        "dq": (timer(lambda: flash_attention_dq(q, k, v, do, lse, di,
                                                True)),
               timer(lambda: _flash_attention_dq_plain(q, k, v, do, lse, di,
                                                       True)),
               lib_bwd_ms)}
    operand = q.numel() * q.element_size()
    row_stats = lse.numel() * 4
    # (products, bytes: each input read once, each output written once)
    work = {"fwd": (2, 4 * operand + row_stats),
            "dkv": (4, 6 * operand + 2 * row_stats),
            "dq": (3, 5 * operand + 2 * row_stats)}
    source = {"fwd": ("flash_attention.cu", 331),
              "dkv": ("flash_attention_bwd.cu", 796),
              "dq": ("flash_attention_bwd.cu", 1146)}
    # no library call computes dK, dV or dQ alone: K8's and K9's
    # library_ms is one call that computes all three, so it is held
    # against K8 + K9 together, not against either
    library = {"fwd": "scaled_dot_product_attention(is_causal=True)",
               "dkv": "scaled_dot_product_attention's autograd backward "
                      "(dQ, dK and dV in one call; the same call as K9's)",
               "dq": "scaled_dot_product_attention's autograd backward "
                     "(dQ, dK and dV in one call; the same call as K8's)"}
    entries = []
    for key, number in (("fwd", "K7"), ("dkv", "K8"), ("dq", "K9")):
        ms, plain_ms, library_ms = times[key]
        bound_ms, bound_by = flash_bound(FLASH_TRAIN_SHAPE, *work[key])
        print("%s flash_attention_%s %s causal: ms %.4f (%.1f TFLOP/s) "
              "plain_ms %.4f sdpa_%s_ms %.4f bound_ms %.4f (%s, %.0f TFLOP/s)"
              % (number, key, label, ms,
                 flash_ops(FLASH_TRAIN_SHAPE, work[key][0]) / ms / 1e9,
                 plain_ms, "fwd" if key == "fwd" else "bwd", library_ms,
                 bound_ms, bound_by, BF16_OPS_PER_S / 1e12))
        entries.append({
            "name": "flash_attention_" + key, "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/" + source[key][0],
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                        "%d (via veles_tpu/ops/attention.py:34)"
                        % source[key][1],
            "max_abs_err": worst[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": library[key]})
    print("K8 + K9 %.4f ms against sdpa_bwd_ms %.4f (one call computing dQ, "
          "dK and dV)" % (times["dkv"][0] + times["dq"][0], lib_bwd_ms))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for key, walks in flash_schedules(FLASH_TRAIN_SHAPE).items():
        print("%s schedule model at %s: %d blocks walking %d-%d tiles of 64, "
              "longest first over %d SMs: the last SM ends at %.4f of a "
              "perfect balance" % ("K8" if key == "dkv" else "K9", label,
                                   len(walks), min(walks), max(walks), sms,
                                   schedule_tail(walks, sms)))
    return entries


def flash_wide_phase(timer, device, gen):
    """K7, K8 and K9 at the wider heads the flash rule admits
    (FLASH_WIDE_SHAPES, causal bf16: K7's 256-wide wgmma kernel, the
    chunked kernels at 384 and for K8 and K9 at both) and f32 K7 at 256,
    each against its plain version under the row-wise rule with its
    planted fault, each timed beside its plain version and SDPA; then one
    attention() call at 4096 positions with 256-wide heads, which must run
    K7 (one launch). Returns the largest max abs error of each kernel."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in FLASH_WIDE_SHAPES:
        label = "x".join(map(str, shape)) + " bf16"
        q, k, v, do = flash_problem(gen, device, shape, torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], flash_error(
            "K7 flash_attention_fwd " + label, out, ref, K7_RTOL))
        del ref
        dkv_err, dq_err, di = check_backward(label, q, k, v, do, out, lse)
        worst["dkv"] = max(worst["dkv"], dkv_err)
        worst["dq"] = max(worst["dq"], dq_err)
        heads_first = [t.transpose(1, 2) for t in (q, k, v)]
        leaves = [t.detach().requires_grad_(True) for t in heads_first]
        lib_out = sdpa(*leaves, is_causal=True)
        lib_do = do.transpose(1, 2)
        times = {
            "K7": (lambda: flash_attention_fwd(q, k, v, True),
                   lambda: _flash_attention_fwd_plain(q, k, v, True),
                   lambda: sdpa(*heads_first, is_causal=True)),
            "K8": (lambda: flash_attention_dkv(q, k, v, do, lse, di, True),
                   lambda: _flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                      True),
                   lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                               retain_graph=True)),
            "K9": (lambda: flash_attention_dq(q, k, v, do, lse, di, True),
                   lambda: _flash_attention_dq_plain(q, k, v, do, lse, di,
                                                     True), None)}
        for number, (fn, plain, lib) in times.items():
            print("%s %s causal: ms %.4f plain_ms %.4f %s"
                  % (number, label, timer(fn), timer(plain),
                     "sdpa_ms %.4f" % timer(lib) if lib else
                     "(SDPA's backward is K8's yardstick)"))
        del lib_out, leaves
    q, k, v, _ = flash_problem(gen, device, FLASH_WIDE_F32_SHAPE,
                               torch.float32)
    label = "x".join(map(str, FLASH_WIDE_F32_SHAPE)) + " f32"
    out, _ = flash_attention_fwd(q, k, v, True)
    ref, _ = _flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    worst["fwd"] = max(worst["fwd"], flash_error(
        "K7 flash_attention_fwd " + label, out, ref, K7_F32_RTOL))
    print("K7 %s causal: ms %.4f plain_ms %.4f"
          % (label, timer(lambda: flash_attention_fwd(q, k, v, True)),
             timer(lambda: _flash_attention_fwd_plain(q, k, v, True))))
    # the port's attention() where the flash rule holds at 256-wide heads
    q, k, v, _ = flash_problem(gen, device, FLASH_WIDE_F32_SHAPE,
                               torch.bfloat16)
    before = flash_attention_fwd.launches
    out = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if flash_attention_fwd.launches != before + 1:
        raise AssertionError("attention() at %s launched K7 %d times, not "
                             "once" % (FLASH_WIDE_F32_SHAPE,
                                       flash_attention_fwd.launches - before))
    flash_error("attention() %s bf16 (K7)" % "x".join(
        map(str, FLASH_WIDE_F32_SHAPE)), out,
        _flash_attention_fwd_plain(q, k, v, True)[0], K7_RTOL)
    return worst


def flash_f32_phase(timer, device, gen):
    """K7, K8 and K9's f32 route (3xTF32 on the tensor cores) against
    their plain versions at FLASH_F32_BWD_SHAPES, causal, under the
    row-wise rule with its planted fault (K7_F32_RTOL for the forward,
    FLASH_F32_BWD_RTOL for the gradients, taken on the f32 forward's out
    and lse); timed at the first shape beside the plain version, SDPA's
    f32 autograd backward (one call for dQ, dK and dV) and SDPA's f32
    forward, each with its TFLOP/s and its bounds at the f32 rate without
    the tensor cores (F32_OPS_PER_S, "bound_fma_ms") and at the 3xTF32
    rate (F32_TF32X3_OPS_PER_S, "bound_3xtf32_ms"). "bound_ms" is the
    bound at the rate of the kernels' own route, 3xTF32. Returns {"fwd":
    ..., "dkv": ..., "dq": ...}: each the f32 route's readings for the
    kernels line."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    got = {}
    for shape in FLASH_F32_BWD_SHAPES:
        label = "x".join(map(str, shape)) + " f32"
        q, k, v, do = flash_problem(gen, device, shape, torch.float32)
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], flash_error(
            "K7 flash_attention_fwd " + label, out, ref, K7_F32_RTOL))
        del ref
        di = _row_dot(out, do)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, di, True)
        ref_dk, ref_dv = _flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                    True)
        torch.cuda.synchronize()
        worst["dkv"] = max(
            worst["dkv"],
            flash_error("K8 flash_attention_dkv dK " + label, dk, ref_dk,
                        FLASH_F32_BWD_RTOL),
            flash_error("K8 flash_attention_dkv dV " + label, dv, ref_dv,
                        FLASH_F32_BWD_RTOL))
        del dk, dv, ref_dk, ref_dv
        dq = flash_attention_dq(q, k, v, do, lse, di, True)
        ref_dq = _flash_attention_dq_plain(q, k, v, do, lse, di, True)
        torch.cuda.synchronize()
        worst["dq"] = max(worst["dq"], flash_error(
            "K9 flash_attention_dq dQ " + label, dq, ref_dq,
            FLASH_F32_BWD_RTOL))
        del dq, ref_dq
        if shape != FLASH_F32_BWD_SHAPES[0]:
            continue
        heads_first = [t.transpose(1, 2) for t in (q, k, v)]
        leaves = [t.detach().requires_grad_(True) for t in heads_first]
        lib_out = sdpa(*leaves, is_causal=True)
        lib_do = do.transpose(1, 2)
        library_bwd_ms = timer(lambda: torch.autograd.grad(
            lib_out, leaves, lib_do, retain_graph=True))
        del lib_out, leaves
        library_fwd_ms = timer(lambda: sdpa(*heads_first, is_causal=True))
        operand = q.numel() * q.element_size()
        row_stats = lse.numel() * 4
        bwd_library = ("scaled_dot_product_attention's f32 autograd "
                       "backward (dQ, dK and dV in one call)")
        for key, number, products, nbytes, fn, plain, library_ms, library \
                in (("fwd", "K7", 2, 4 * operand + row_stats,
                     lambda: flash_attention_fwd(q, k, v, True),
                     lambda: _flash_attention_fwd_plain(q, k, v, True),
                     library_fwd_ms,
                     "scaled_dot_product_attention's f32 forward"),
                    ("dkv", "K8", 4, 6 * operand + 2 * row_stats,
                     lambda: flash_attention_dkv(q, k, v, do, lse, di, True),
                     lambda: _flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                        True),
                     library_bwd_ms, bwd_library),
                    ("dq", "K9", 3, 5 * operand + 2 * row_stats,
                     lambda: flash_attention_dq(q, k, v, do, lse, di, True),
                     lambda: _flash_attention_dq_plain(q, k, v, do, lse, di,
                                                       True),
                     library_bwd_ms, bwd_library)):
            ms, plain_ms = timer(fn), timer(plain)
            ops = flash_ops(shape, products)
            bytes_s = nbytes / HBM_BYTES_PER_S
            fma_ms = 1e3 * max(bytes_s, ops / F32_OPS_PER_S)
            ops_s = ops / F32_TF32X3_OPS_PER_S
            bound_ms = 1e3 * max(bytes_s, ops_s)
            got[key] = {"shape": list(shape), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": ("bytes" if bytes_s >= ops_s
                                     else "operations"),
                        "bound_fma_ms": fma_ms, "bound_3xtf32_ms": bound_ms,
                        "library_ms": library_ms, "library": library}
            print("%s flash_attention_%s %s causal (the f32 route, 3xTF32): "
                  "ms %.4f (%.1f TFLOP/s) plain_ms %.4f sdpa_%s_f32_ms %.4f "
                  "bound_ms %.4f (%s, at the route's %.0f TFLOP/s 3xTF32), "
                  "%.2fx it; bound_fma_ms %.4f (%.0f TFLOP/s f32 FMA), "
                  "%.2fx it"
                  % (number, key, label, ms, ops / ms / 1e9, plain_ms,
                     "fwd" if key == "fwd" else "bwd", library_ms, bound_ms,
                     got[key]["bound_by"], F32_TF32X3_OPS_PER_S / 1e12,
                     ms / bound_ms, fma_ms, F32_OPS_PER_S / 1e12,
                     ms / fma_ms))
        print("K8 + K9 f32 %.4f ms against sdpa_bwd_f32_ms %.4f (%.2fx)"
              % (got["dkv"]["ms"] + got["dq"]["ms"], library_bwd_ms,
                 (got["dkv"]["ms"] + got["dq"]["ms"]) / library_bwd_ms))
        del q, k, v, do, out, lse, di
    for key in got:
        got[key]["max_abs_err"] = worst[key]
    return got


def long_serving_phase(device, rng):
    """Three long prompts (8192, 6000 and 4096 tokens, 32 tokens each) at
    once through GenerateAPI on the dense slab, bf16 float tier, at the
    serving model's width with 8 heads of 128: every request answered,
    and each prefill (one per prompt bucket group, every bucket >= 4096)
    launching K7 once per block and no other kernel."""
    params, table = bf16_model(device)
    prompts = [rng.randint(0, VOCAB, n).tolist() for n in LONG_PROMPTS]
    run = serve(params, table, [prompts], None, device, paged=False,
                heads=LONG_HEADS, max_len=LONG_MAX_LEN, slots=len(prompts))
    got = run["launches"]
    admits = (run["health"]["dispatch_counts"]["admit"]
              - run["health0"]["dispatch_counts"]["admit"])
    print("long prompts %s bf16 (dense slab, %d heads of %d, max_len %d): "
          "%d requests x %d tokens in %.3f s = %.1f tokens/s; %d prefills "
          "(prompt bucket groups), prefill host-blocking %.3f ms (admit_s), "
          "dispatch + collect %.3f ms over %d chunks; launches K7 %d "
          "(%d blocks x %d prefills)"
          % (list(LONG_PROMPTS), LONG_HEADS, EMBED // LONG_HEADS,
             LONG_MAX_LEN, len(prompts), N_TOKENS, run["wall"],
             len(prompts) * N_TOKENS / run["wall"], admits,
             1e3 * run["admit_s"], 1e3 * run["host_s"], run["chunks"],
             got["flash_attention_fwd"], BLOCKS, admits))
    if admits < 1 or got["flash_attention_fwd"] != BLOCKS * admits:
        raise AssertionError("K7 launched %d times for %d long prefills"
                             % (got["flash_attention_fwd"], admits))
    others = {name: n for name, n in got.items()
              if n and name != "flash_attention_fwd"}
    if others:
        raise AssertionError("the long-prompt run launched %s" % others)
    return got


def long_agreement_phase(device):
    """float32 weights: a 4096-token prompt through GenerateAPI on the
    dense slab on the card (K7 in f32, once per block) against the dense
    reference decode on the CPU (plain attention), greedy tokens equal up
    to the first step where the reference's top-2 gap is below 1e-3."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, LONG_HEADS, VOCAB,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02)
    prompt = numpy.random.RandomState(3).randint(0, VOCAB,
                                                 LONG_AGREE_PROMPT).tolist()
    run = serve(params, table, [[prompt]], None, device, paged=False,
                heads=LONG_HEADS,
                max_len=LONG_AGREE_PROMPT + N_TOKENS + 2 * CHUNK, slots=1)
    if run["launches"]["flash_attention_fwd"] != BLOCKS:
        raise AssertionError("the f32 long prefill launched K7 %d times"
                             % run["launches"]["flash_attention_fwd"])
    ref, _, logits = generate(params, table, numpy.asarray(prompt)[None],
                              LONG_HEADS, N_TOKENS, return_logits=True,
                              device="cpu")
    top2 = torch.topk(logits[0], 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    n = next((i for i, g in enumerate(gaps) if g < TOP2_GAP), len(gaps))
    want = ref[0, :n].tolist()
    stream = run["streams"][0]
    print("agreement long prompt f32 (%d tokens, K7 f32 on the card vs the "
          "CPU's plain attention): %d steps compared, %d cut off at a "
          "reference top-2 gap below %.0e; K7 launches %d"
          % (LONG_AGREE_PROMPT, n, len(gaps) - n, TOP2_GAP,
             run["launches"]["flash_attention_fwd"]))
    if stream[:n] != want:
        raise AssertionError("the long-prompt stream disagrees with the "
                             "reference: %r vs %r" % (stream[:n], want))


def split_labels(rng, classes, class_lengths):
    """Labels for a (test, valid, train) split, valid first: the train
    labels randint(0, classes), the valid ones drawn from them (the loader
    wants every validation label in the training set)."""
    _, n_valid, n_train = class_lengths
    train_labels = rng.randint(0, classes, n_train)
    return numpy.concatenate(
        [train_labels[rng.randint(0, n_train, n_valid)], train_labels])


def transformer_layers(heads, classes, depth):
    """transformer_device's pre-LN stack (bench.py:425-441): ``depth`` x
    [layer_norm, residual causal self_attention, layer_norm, residual
    gelu ffn of ratio 4], then a softmax head of ``classes``."""
    block = [{"type": "layer_norm"},
             {"type": "self_attention", "heads": heads, "causal": True,
              "residual": True},
             {"type": "layer_norm"},
             {"type": "ffn", "ratio": 4, "activation": "gelu",
              "residual": True}]
    return block * depth + [{"type": "softmax",
                             "output_sample_shape": classes}]


def build_transformer(device, data, labels, layers, class_lengths,
                      minibatch, epochs, lr, sweep=True, weights=None,
                      fused="auto"):
    """A StandardWorkflow over (N, T, E) samples at precision level 0
    with the GEMM knobs off (seeds 1234, no normalization, learning rate
    ``lr``, moment 0.9), in the fused tick or (``fused=False``) graph
    mode; ``weights`` (per-layer numpy dicts) are put into the units
    before initialize()."""
    root.common.engine.update({"use_pallas": False,
                               "pallas_epilogue": False,
                               "precision_level": 0})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = StandardWorkflow(
        DummyLauncher(), layers=layers,
        loader_kwargs=dict(data=data, labels=labels,
                           class_lengths=class_lengths,
                           minibatch_size=minibatch,
                           normalization_type="none"),
        learning_rate=lr, gradient_moment=0.9,
        decision_kwargs=dict(max_epochs=epochs), fused_sweep=sweep,
        fused=fused, device=device, name="transformer")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def report_tokens(label, wf, epochs, wall, t):
    """Print tokens/s over the whole run (every trained and evaluated
    sequence's positions), the per-epoch train loss and validation
    n_err; fail on a non-finite loss."""
    _, valid, train_mb = minibatch_counts(wf)
    minibatch = wf.loader.max_minibatch_size
    tokens = (valid + train_mb) * minibatch * t
    losses = [e["train_loss"] for e in epochs]
    print("train %s: %d epochs in %.3f s, %.1f tokens/s over the whole "
          "run (%d tokens); train loss %s; validation n_err %s; "
          "minibatches per class (test, valid, train) %s"
          % (label, len(epochs), wall, tokens / wall, tokens,
             ["%.6f" % v for v in losses], [e["valid_n_err"] for e in epochs],
             minibatch_counts(wf)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)


def longctx_training_phase(device):
    """The long-context training main path: transformer_device's stack at
    longctx_device's width (embed 1024, 8 heads of 128, 8192 positions),
    16 samples from RandomState(0).randn, 2 epochs, minibatch 1. The
    counters, zeroed before the run, must read K7 4 per train and valid
    minibatch (one per block) and K8 and K9 4 per train minibatch,
    nothing else. Returns the launches and the run's wall seconds."""
    rng = numpy.random.RandomState(0)
    data = rng.randn(LONG_SAMPLES, LONG_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, LONG_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(LONG_HEADS, LONG_CLASSES,
                                              BLOCKS),
                           LONG_CLASS_LENGTHS, 1, LONG_EPOCHS, LONG_LR)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("long-context 4 x [LN, attention 8x128 causal, LN, ffn "
                  "gelu x4] + softmax 16, T %d, mb 1" % LONG_T, wf, epochs,
                  wall, LONG_T)
    _, valid, train_mb = wf.fused_tick.minibatch_counts
    per_epoch = LONG_CLASS_LENGTHS[1] + LONG_CLASS_LENGTHS[2]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=LONG_EPOCHS * per_epoch * BLOCKS,
                flash_attention_dkv=LONG_EPOCHS * LONG_CLASS_LENGTHS[2]
                * BLOCKS,
                flash_attention_dq=LONG_EPOCHS * LONG_CLASS_LENGTHS[2]
                * BLOCKS)
    print("  launches %s (expected: K7 %d epochs x %d minibatches x %d "
          "blocks, K8 = K9 %d x %d train x %d)"
          % ({k: v for k, v in got.items() if v}, LONG_EPOCHS, per_epoch,
             BLOCKS, LONG_EPOCHS, LONG_CLASS_LENGTHS[2], BLOCKS))
    if got != want or len(epochs) != LONG_EPOCHS \
            or valid + train_mb != LONG_EPOCHS * per_epoch:
        raise AssertionError("long-context run: %d epochs, minibatches %s, "
                             "launches %s, expected %s"
                             % (len(epochs), wf.fused_tick.minibatch_counts,
                                got, want))
    return got, wall


def transformer_device_phase(device):
    """transformer_device at its own full width (batch 16, 512 positions,
    embed 1024, 16 heads of 64, 4 blocks, 256 classes; 64 samples, 16
    valid / 48 train), 2 epochs: the plain attention route, so no kernel
    may launch."""
    rng = numpy.random.RandomState(0)
    n = sum(TD_CLASS_LENGTHS)
    data = rng.randn(n, TD_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, TD_CLASSES, TD_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(TD_HEADS, TD_CLASSES, BLOCKS),
                           TD_CLASS_LENGTHS, TD_MINIBATCH, TD_EPOCHS, TD_LR)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("transformer_device 4 x [LN, attention 16x64 causal, LN, "
                  "ffn gelu x4] + softmax 256, T %d, mb %d"
                  % (TD_T, TD_MINIBATCH), wf, epochs, wall, TD_T)
    print("  launches %s (expected none)"
          % {k: v for k, v in got.items() if v})
    if any(got.values()) or len(epochs) != TD_EPOCHS:
        raise AssertionError("transformer_device: %d epochs, launches %s"
                             % (len(epochs), got))


def agreement_weights(rng, layers, t, embed):
    """Per-layer numpy leaves for ``layers``: projections U(+-1/sqrt(fan_in))
    as the units draw them, layer-norm scales 1 + U(+-0.1), every bias and
    shift U(+-0.1) (non-zero, so each leaf's tolerance is relative to a
    real magnitude)."""
    def uniform(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(numpy.float32)

    weights, hidden = [], 4 * embed
    for spec in layers:
        kind = spec["type"]
        if kind == "layer_norm":
            leaves = {"weights": 1 + uniform(0.1, embed),
                      "bias": uniform(0.1, embed)}
        elif kind == "self_attention":
            leaves = {"weights": uniform(embed ** -0.5, embed, 3 * embed),
                      "bias": uniform(0.1, 3 * embed),
                      "out_weights": uniform(embed ** -0.5, embed, embed),
                      "out_bias": uniform(0.1, embed)}
        elif kind == "ffn":
            leaves = {"weights": uniform(embed ** -0.5, embed, hidden),
                      "bias": uniform(0.1, hidden),
                      "out_weights": uniform(hidden ** -0.5, hidden, embed),
                      "out_bias": uniform(0.1, embed)}
        else:
            fan_in = t * embed
            leaves = {"weights": uniform(fan_in ** -0.5, fan_in,
                                         spec["output_sample_shape"]),
                      "bias": uniform(0.1, spec["output_sample_shape"])}
        weights.append(leaves)
    return weights


def long_training_agreement_phase(device):
    """One epoch of one pre-LN block at 4096 positions, embed 256, 2 heads
    of 128, level 0, per-minibatch ticks, on the card (K7, K8, K9) and on
    the CPU (the plain route), from the same numpy weights: equal index
    streams, equal per-minibatch n_err, every leaf's update within
    AGREE_LONG_RTOL of its largest element."""
    rng = numpy.random.RandomState(7)
    n = sum(AGREE_LONG_CLASS_LENGTHS)
    data = rng.randn(n, AGREE_T, AGREE_EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, AGREE_LONG_CLASS_LENGTHS)
    layers = transformer_layers(AGREE_HEADS, LONG_CLASSES, depth=1)
    weights = agreement_weights(rng, layers, AGREE_T, AGREE_EMBED)
    results = []
    for dev in (device, torch.device("cpu")):
        wf = build_transformer(dev, data, labels, layers,
                               AGREE_LONG_CLASS_LENGTHS, 1, 1, AGREE_LONG_LR,
                               sweep=False, weights=weights)
        served, n_errs, got, wall = recorded_run(wf)
        leaves = [{name: getattr(f, name).data.cpu() for name in
                   ("weights", "bias", "out_weights", "out_bias")
                   if hasattr(f, name)} for f in wf.forwards]
        results.append((served, n_errs, leaves, got, wall))
    (served_c, errs_c, w_c, got_c, wall_c), \
        (served_h, errs_h, w_h, got_h, wall_h) = results
    same_stream = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    worst, where, weights_rel = 0.0, None, 0.0
    for i, (lc, lh, init) in enumerate(zip(w_c, w_h, weights)):
        for name, ref in lh.items():
            start = torch.from_numpy(init[name])
            moved = (ref - start).abs().max()
            rel = ((lc[name] - ref).abs().max() / moved).item()
            weights_rel = max(weights_rel, ((lc[name] - ref).abs().max()
                                            / ref.abs().max()).item())
            if rel >= worst:
                worst, where = rel, "layer %d %s" % (i, name)
    train_mb = AGREE_LONG_CLASS_LENGTHS[2]
    want_c = dict.fromkeys(COUNTERS, 0)
    want_c.update(flash_attention_fwd=n, flash_attention_dkv=train_mb,
                  flash_attention_dq=train_mb)
    print("training agreement long context (level 0, T %d, embed %d, %d "
          "heads of %d, 1 epoch, %d minibatches): index streams %s; n_err "
          "card %s, CPU %s; largest update difference %.3g of the leaf's "
          "largest update (%s; tolerance %.0e), largest weight difference "
          "%.3g of the leaf's largest weight; card launches %s in %.3f s, "
          "CPU launches %d in %.3f s"
          % (AGREE_T, AGREE_EMBED, AGREE_HEADS, AGREE_EMBED // AGREE_HEADS,
             len(served_c), "equal" if same_stream else "DIFFER", errs_c,
             errs_h, worst, where, AGREE_LONG_RTOL, weights_rel,
             {k: v for k, v in got_c.items() if v}, wall_c,
             sum(got_h.values()), wall_h))
    if not same_stream or errs_c != errs_h or not worst <= AGREE_LONG_RTOL:
        raise AssertionError("the card's long-context training disagrees "
                             "with the CPU's")
    if got_c != want_c or any(got_h.values()):
        raise AssertionError("the card run launched %s (expected %s) or the "
                             "CPU run launched a kernel" % (got_c, want_c))


class HostObserver(Unit):
    """bench.py:170-175's host unit: counts its firings, touches no slot;
    ``transparent`` says so to the sweep tier."""

    def __init__(self, workflow, transparent, **kwargs):
        super().__init__(workflow, **kwargs)
        self.sweep_transparent = transparent
        self.ticks = 0

    def run(self):
        self.ticks += 1


def splice_observer(wf, transparent):
    """A HostObserver between the two forwards (control links only), so
    the fused tick must decline the chain (bench.py:176-181)."""
    obs = HostObserver(wf, transparent, name="observer")
    fwd1 = wf.forwards[1]
    fwd1.unlink_from(wf.forwards[0])
    obs.link_from(wf.forwards[0])
    fwd1.link_from(obs)
    return obs


def engaged_tier(wf):
    """Which execution tier the workflow runs: "fused", "sweep",
    "segment" or "graph"."""
    if wf.fused_tick is not None:
        return "fused"
    if isinstance(wf.sweep_unit, FusedSweep):
        return "sweep"
    if any(isinstance(u, FusedSegment) for u in wf.units):
        return "segment"
    return "graph"


def composite_calls(wf):
    """The tier's composite firings: fused-tick steps, sweep chunks or
    segment calls (0 in graph mode)."""
    if wf.fused_tick is not None:
        return wf.fused_tick.ticks
    if wf.sweep_unit is not None:
        return wf.sweep_unit.chunk_calls
    return sum(u.calls for u in wf.units if isinstance(u, FusedSegment))


def tiers_phase(device):
    """The bench's graph-mode cliff (bench.py:150-230): the reference
    MNIST784 (784 -> 100 tanh -> 10, minibatch 100) on the bench data in
    graph mode (fused=False), the segment tier (a host unit the chain
    cannot fuse spliced between the forwards), the sweep tier (the same
    unit declared sweep_transparent) and the fused tick, TIER_EPOCHS
    each: images/s, unit firings and composite calls per epoch, and the
    tier that engaged, asserted as bench.py asserts it. Returns the
    images/s by tier."""
    data, labels = bench_dataset()
    rates = {}
    for tier in ("graph", "segment", "sweep", "fused"):
        wf = build_mlp(device, data, labels, MNIST_LAYERS, MNIST_MINIBATCH,
                       BENCH_CLASS_LENGTHS, False, TIER_EPOCHS,
                       fused=False if tier == "graph" else "auto")
        obs = splice_observer(wf, tier == "sweep") \
            if tier in ("segment", "sweep") else None
        epochs, wall = train(wf, device)
        if engaged_tier(wf) != tier:
            raise AssertionError("the %s run engaged the %s tier"
                                 % (tier, engaged_tier(wf)))
        losses = report_training("tiers: %s, reference MNIST784" % tier, wf,
                                 epochs, wall, len(data))
        rates[tier] = len(data) * len(epochs) / wall
        # every unit's firings (Unit.run_calls), the splices' included
        per_epoch = [sum(u.run_calls for u in wf.units) / len(epochs),
                     composite_calls(wf) / len(epochs)]
        print("  tier %s engaged: %.1f images/s over the run, %.1f unit "
              "firings and %.1f composite calls per epoch%s"
              % (tier, rates[tier], per_epoch[0], per_epoch[1],
                 ", observer fired %d times" % obs.ticks if obs else ""))
        ticks = sum(minibatch_counts(wf))
        if len(epochs) != TIER_EPOCHS or not losses[-1] < losses[0] \
                or (obs is not None and obs.ticks != ticks):
            raise AssertionError("tier %s: %d epochs, losses %s, observer "
                                 "%s of %d ticks" % (tier, len(epochs),
                                                     losses, obs and
                                                     obs.ticks, ticks))
        del wf
    print("tiers (images/s over the run): %s" % json.dumps(rates))
    return rates


def graph_mlp_phase(device):
    """The wide MLP (784 -> 4096 tanh -> 10, minibatch 4096, level 0) in
    graph mode, GRAPH_EPOCHS epochs, with the kernel knobs on (K5 on the
    hidden layer's forward on every minibatch and its weight gradient
    and error product on every train minibatch: counted) and off (no
    kernel). Returns the knobs-on run's launches."""
    data, labels = bench_dataset()
    main = None
    for knobs in (True, False):
        wf = build_mlp(device, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       BENCH_CLASS_LENGTHS, knobs, GRAPH_EPOCHS,
                       fused=False)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        report_training("graph mode wide MLP 784-4096-10 mb 4096, knobs "
                        "%s" % ("on" if knobs else "off"), wf, epochs, wall,
                        len(data))
        _, valid, train_mb = minibatch_counts(wf)
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want["blocked_matmul"] = 3 * train_mb + valid
            main = got
        print("  tier %s; launches %s, K5 %.1f per epoch (graph mode's "
              "minibatches require %s)"
              % (engaged_tier(wf), {k: v for k, v in got.items() if v},
                 got["blocked_matmul"] / max(len(epochs), 1),
                 {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != GRAPH_EPOCHS \
                or engaged_tier(wf) != "graph":
            raise AssertionError("graph-mode wide MLP: %d epochs, launches "
                                 "%s, expected %s"
                                 % (len(epochs), got, want))
        del wf
    return main


def leaf_rel(a_leaves, b_leaves):
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(a_leaves, b_leaves))


def mlp_leaves(wf):
    return [getattr(f, name).data.float().cpu() for f in wf.forwards
            for name in ("weights", "bias")]


def graph_agreement_phase(device):
    """One epoch of the wide MLP at level 2 (f32), per-minibatch serving,
    from the same numpy weights (the training agreement's data): graph
    mode on the card against the fused tick on the card (K6 and K5
    there, K5 in graph mode) and against graph mode on the CPU (plain
    versions): equal index streams, per-minibatch n_err within
    AGREE_N_ERR_TOL, every leaf within GRAPH_LEAF_RTOL of its largest
    element."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, labels = data[:n], labels[:n]
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    runs = {}
    for label, dev, fused in (("graph card", device, False),
                              ("fused card", device, True),
                              ("graph CPU", torch.device("cpu"), False)):
        wf = build_mlp(dev, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       AGREE_CLASS_LENGTHS, True, 1, precision_level=2,
                       sweep=False, weights=weights, fused=fused)
        served, n_errs, got, wall = recorded_run(wf)
        runs[label] = (served, n_errs, mlp_leaves(wf), got, wall)
    base = runs["graph card"]
    for other in ("fused card", "graph CPU"):
        ref = runs[other]
        same = len(base[0]) == len(ref[0]) and all(
            numpy.array_equal(a, b) for a, b in zip(base[0], ref[0]))
        diff = max(abs(a - b) for a, b in zip(base[1], ref[1]))
        rel = leaf_rel(base[2], ref[2])
        print("graph agreement f32 (level 2), 1 epoch, %d minibatches, "
              "graph card against %s: index streams %s; n_err %s against "
              "%s (max diff %d, tolerance %d); largest leaf difference %.3g "
              "of the leaf's largest element (tolerance %.0e); launches "
              "%s against %s"
              % (len(base[0]), other, "equal" if same else "DIFFER",
                 base[1], ref[1], diff, AGREE_N_ERR_TOL, rel,
                 GRAPH_LEAF_RTOL, {k: v for k, v in base[3].items() if v},
                 {k: v for k, v in ref[3].items() if v}))
        if not same or len(base[1]) != len(ref[1]) \
                or diff > AGREE_N_ERR_TOL or not rel <= GRAPH_LEAF_RTOL:
            raise AssertionError("graph mode on the card disagrees with %s"
                                 % other)
    if not base[3]["blocked_matmul"] or any(runs["graph CPU"][3].values()):
        raise AssertionError("the card's graph mode skipped K5 or the CPU "
                             "run launched a kernel")


def longctx_graph_phase(device):
    """The long-context stack of longctx_training_phase (embed 1024, 8
    heads of 128, 8192 positions, minibatch 1, 16 samples, LONG_LR) in
    graph mode, LONG_GRAPH_EPOCHS epoch(s): tokens/s and the flash
    launches, K7 per block on every minibatch (the forward unit) and
    again on every train minibatch (GDSelfAttention's autograd recomputes
    the forward), K8 and K9 per block per train minibatch. Returns the
    launches."""
    rng = numpy.random.RandomState(0)
    data = rng.randn(LONG_SAMPLES, LONG_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, LONG_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(LONG_HEADS, LONG_CLASSES,
                                              BLOCKS),
                           LONG_CLASS_LENGTHS, 1, LONG_GRAPH_EPOCHS,
                           LONG_LR, fused=False)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("graph mode long-context 4 x [LN, attention 8x128 causal, "
                  "LN, ffn gelu x4] + softmax 16, T %d, mb 1" % LONG_T, wf,
                  epochs, wall, LONG_T)
    valid, train_mb = (LONG_GRAPH_EPOCHS * n for n in LONG_CLASS_LENGTHS[1:])
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=(valid + 2 * train_mb) * BLOCKS,
                flash_attention_dkv=train_mb * BLOCKS,
                flash_attention_dq=train_mb * BLOCKS)
    print("  tier %s; launches %s (expected: K7 (%d valid + 2 x %d train) "
          "x %d blocks, K8 = K9 %d train x %d)"
          % (engaged_tier(wf), {k: v for k, v in got.items() if v}, valid,
             train_mb, BLOCKS, train_mb, BLOCKS))
    if got != want or len(epochs) != LONG_GRAPH_EPOCHS \
            or engaged_tier(wf) != "graph":
        raise AssertionError("graph-mode long context: %d epochs, launches "
                             "%s, expected %s" % (len(epochs), got, want))
    return got


def long_graph_agreement_phase(device):
    """One epoch of one pre-LN block at 4096 positions (the long-context
    agreement's shapes, level 0, per-minibatch ticks) on the card in
    graph mode and in the fused tick, from the same numpy weights: equal
    index streams and per-minibatch n_err, every leaf's update within
    AGREE_LONG_RTOL of its largest element; graph mode's launches K7 on
    every minibatch and again on every train one, K8 and K9 on every
    train one."""
    rng = numpy.random.RandomState(7)
    n = sum(AGREE_LONG_CLASS_LENGTHS)
    data = rng.randn(n, AGREE_T, AGREE_EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, AGREE_LONG_CLASS_LENGTHS)
    layers = transformer_layers(AGREE_HEADS, LONG_CLASSES, depth=1)
    weights = agreement_weights(rng, layers, AGREE_T, AGREE_EMBED)
    results = []
    for fused in (False, True):
        wf = build_transformer(device, data, labels, layers,
                               AGREE_LONG_CLASS_LENGTHS, 1, 1, AGREE_LONG_LR,
                               sweep=False, weights=weights, fused=fused)
        served, n_errs, got, _ = recorded_run(wf)
        leaves = [{name: getattr(f, name).data.cpu() for name in
                   ("weights", "bias", "out_weights", "out_bias")
                   if hasattr(f, name)} for f in wf.forwards]
        results.append((served, n_errs, leaves, got))
    (served_g, errs_g, w_g, got_g), (served_f, errs_f, w_f, _) = results
    same = len(served_g) == len(served_f) and all(
        numpy.array_equal(a, b) for a, b in zip(served_g, served_f))
    worst, where = 0.0, None
    for i, (lg, lf, init) in enumerate(zip(w_g, w_f, weights)):
        for name, ref in lf.items():
            moved = (ref - torch.from_numpy(init[name])).abs().max()
            rel = ((lg[name] - ref).abs().max() / moved).item()
            if rel >= worst:
                worst, where = rel, "layer %d %s" % (i, name)
    train_mb = AGREE_LONG_CLASS_LENGTHS[2]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=n + train_mb,
                flash_attention_dkv=train_mb, flash_attention_dq=train_mb)
    print("long-context graph agreement (level 0, T %d, embed %d, %d heads "
          "of %d, 1 epoch, %d minibatches), graph mode against the fused "
          "tick on the card: index streams %s; n_err %s against %s; largest "
          "update difference %.3g of the leaf's largest update (%s; "
          "tolerance %.0e); graph-mode launches %s"
          % (AGREE_T, AGREE_EMBED, AGREE_HEADS, AGREE_EMBED // AGREE_HEADS,
             len(served_g), "equal" if same else "DIFFER", errs_g, errs_f,
             worst, where, AGREE_LONG_RTOL,
             {k: v for k, v in got_g.items() if v}))
    if not same or errs_g != errs_f or not worst <= AGREE_LONG_RTOL \
            or got_g != want:
        raise AssertionError("graph mode's long-context training disagrees "
                             "with the fused tick's (launches %s, expected "
                             "%s)" % (got_g, want))


def som_run(device, data, epochs, step_hook=None):
    """KohonenWorkflow (SOM_SHAPE, minibatch SOM_MINIBATCH) over ``data``
    for ``epochs`` epochs from the seeded streams; ``step_hook(trainer,
    weights, batch)`` is called after each step with the weights before
    it. Returns the workflow, each step's quantization error (a device
    scalar) and the wall seconds of run() (the card synchronised)."""
    prng.get("kohonen").seed(1234)
    prng.get("loader").seed(1234)
    wf = KohonenWorkflow(
        DummyLauncher(), shape=SOM_SHAPE, device=device,
        loader_kwargs=dict(data=data, class_lengths=[0, 0, len(data)],
                           minibatch_size=SOM_MINIBATCH),
        max_epochs=epochs, name="som")
    wf.initialize()
    trainer = wf.trainer
    errors = []
    real = trainer.run

    def recorded():
        before, batch = trainer.weights.data, trainer.input.data
        real()
        errors.append(trainer.quantization_error)
        if step_hook is not None:
            step_hook(trainer, before, batch)

    trainer.run = recorded
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return wf, errors, time.perf_counter() - t0


def som_phase(device):
    """The Kohonen SOM (BASELINE.json config 4) at samples/som_digits.py's
    defaults over the bench's 60000 x 784 pixels (uniform in [0, 1): the
    card's machine has no sklearn, and the digits file is not in the
    repository), SOM_EPOCHS epochs: steps/s and the mean quantization
    error of each epoch, which must fall; then one epoch on the card, each
    step also run on the CPU from the card's weights and minibatch (see
    SOM_TIE_GAP). Returns the steps/s."""
    data, _ = bench_dataset()
    wf, errors, wall = som_run(device, data, SOM_EPOCHS)
    per_epoch = len(errors) // SOM_EPOCHS
    means = [float(torch.stack(errors[i * per_epoch:(i + 1) * per_epoch])
                   .mean()) for i in range(SOM_EPOCHS)]
    print("Kohonen SOM %s grid, mb %d, %d x %d samples, %d epochs: %d steps "
          "in %.3f s, %.1f steps/s, %.1f samples/s; mean quantization error "
          "per epoch %s" % (SOM_SHAPE, SOM_MINIBATCH, len(data),
                            data.shape[1], SOM_EPOCHS, len(errors), wall,
                            len(errors) / wall, len(data) * SOM_EPOCHS / wall,
                            ["%.6f" % e for e in means]))
    if wf.gather_results()["epochs"] != SOM_EPOCHS \
            or not all(math.isfinite(e) for e in means) \
            or not means[-1] < means[0]:
        raise AssertionError("the SOM's quantization error did not fall: "
                             "%s" % means)
    tally = {"steps": 0, "winners": 0, "resolved": 0, "ties": 0,
             "tie_flips": 0, "compared": 0, "rel": 0.0, "bad": 0}
    coords = None

    def compare(trainer, before, batch):
        nonlocal coords
        if coords is None:
            coords = grid_coords(trainer.shape, torch.device("cpu"))
        x = batch.reshape(batch.shape[0], -1).cpu()
        w = before.cpu()
        lr, sigma = trainer.last_rates
        new_w, winners, _ = som_step(w, x, lr.cpu(), sigma.cpu(), coords)
        card = trainer.winners.data.cpu()
        x64, w64 = x.double(), w.double()
        d2 = ((x64 * x64).sum(1)[:, None] - 2 * x64 @ w64.T
              + (w64 * w64).sum(1)[None, :])
        top2 = d2.topk(2, dim=1, largest=False).values
        resolved = (top2[:, 1] - top2[:, 0]) > SOM_TIE_GAP
        equal = card == winners
        tally["steps"] += 1
        tally["winners"] += len(card)
        tally["resolved"] += int(resolved.sum())
        tally["ties"] += int((~resolved).sum())
        tally["tie_flips"] += int((~equal & ~resolved).sum())
        tally["bad"] += int((~equal & resolved).sum())
        if bool(equal.all()):
            ref = new_w
            rel = ((trainer.weights.data.cpu() - ref).abs().max()
                   / ref.abs().max()).item()
            tally["compared"] += 1
            tally["rel"] = max(tally["rel"], rel)

    _, _, wall_c = som_run(device, data, 1, compare)
    print("Kohonen agreement f32, 1 epoch, each CPU step from the card's "
          "weights: %d steps; winners: %d, %d with a float64 top-2 gap above "
          "%.0e, all equal: %s (%d flipped there); %d near ties, %d flipped; "
          "new weights of the %d steps with every winner equal within %.3g "
          "of the largest (tolerance %.0e); %.3f s"
          % (tally["steps"], tally["winners"], tally["resolved"], SOM_TIE_GAP,
             tally["bad"] == 0, tally["bad"], tally["ties"],
             tally["tie_flips"], tally["compared"], tally["rel"],
             SOM_WEIGHT_RTOL, wall_c))
    if tally["bad"] or not tally["compared"] \
            or not tally["rel"] <= SOM_WEIGHT_RTOL:
        raise AssertionError("the card's SOM disagrees with the CPU's")
    return len(errors) / wall

def write_idx(path, array):
    """An idx file of uint8 ``array`` (gzipped where the name ends in
    .gz): the big-endian header, then the payload."""
    header = struct.pack(">HBB", 0, 0x08, array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as fout:
        fout.write(header + array.astype(numpy.uint8).tobytes())


def mnist_files(directory):
    """MNIST's four idx files from the bench data (70000 rows: its 10000-
    row valid block the t10k set, the 60000 behind it the train set),
    pixels times 255 rounded to uint8, two of the files gzipped. Returns
    the (test, train) pixels and labels as written."""
    data, labels = bench_dataset(n=MNIST_ROWS, n_valid=MNIST_TEST)
    pixels = numpy.rint(data * 255).astype(numpy.uint8).reshape(-1, 28, 28)
    parts = {"t10k": (pixels[:MNIST_TEST], labels[:MNIST_TEST]),
             "train": (pixels[MNIST_TEST:], labels[MNIST_TEST:])}
    for prefix, (images, labs) in parts.items():
        for kind, array in (("images-idx3", images), ("labels-idx1", labs)):
            name = "%s-%s-ubyte" % (prefix, kind)
            if name in MNIST_GZIPPED:
                name += ".gz"
            write_idx(os.path.join(directory, name), array)
    return parts


def build_mnist(device, directory, epochs, shuffle_limit=None):
    """samples/mnist784.py's configuration through the port's
    MLPWorkflow(loader_cls=MNISTLoader): 784 -> 100 tanh -> 10, minibatch
    100, lr 0.03, moment 0.9, linear normalization, seeds 1234."""
    root.common.engine.update({"use_pallas": False,
                               "pallas_epilogue": False,
                               "precision_level": 0})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    return MLPWorkflow(
        DummyLauncher(), layers=MNIST_LAYERS, loader_cls=MNISTLoader,
        loader_kwargs=dict(directory=directory, minibatch_size=MNIST_MINIBATCH,
                           normalization_type="linear",
                           shuffle_limit=shuffle_limit),
        learning_rate=TRAIN_LR, gradient_moment=MNIST_MOMENT,
        max_epochs=epochs, device=device, name="MNIST784")


def mnist_phase(device, directory):
    """MNIST784 through its idx loader (samples/mnist784.py's workflow):
    the loader's arrays must equal the written bytes, its class lengths
    [0, 10000, 60000], and the train loss must fall over MNIST_EPOCHS
    epochs in the fused tick. Prints images/s and the validation errors
    per epoch."""
    parts = mnist_files(directory)
    wf = build_mnist(device, directory, MNIST_EPOCHS)
    epochs, wall = train(wf, device)
    loader = wf.loader
    images = numpy.concatenate([parts["t10k"][0], parts["train"][0]])
    labels = numpy.concatenate([parts["t10k"][1], parts["train"][1]])
    same = (numpy.array_equal(loader.original_data.data.cpu().numpy(),
                              images.reshape(len(images), -1).astype(
                                  numpy.float32))
            and numpy.array_equal(loader.original_labels.data.cpu().numpy(),
                                  labels))
    print("MNIST784 idx files (%s gzipped): class lengths %s, arrays equal "
          "the written bytes: %s, on %s"
          % (", ".join(MNIST_GZIPPED), loader.class_lengths, same,
             loader.original_data.data.device))
    losses = report_training("MNIST784 via MNISTLoader 784-100-10 mb 100, "
                             "moment 0.9, fused tick", wf, epochs, wall,
                             len(images))
    if not same or loader.class_lengths != [0, MNIST_TEST,
                                            MNIST_ROWS - MNIST_TEST] \
            or wf.fused_tick is None or len(epochs) != MNIST_EPOCHS \
            or not losses[-1] < losses[0]:
        raise AssertionError("MNIST784 through its loader failed")
    return len(images) * len(epochs) / wall


def build_regression(device, data, targets, class_lengths, knobs, epochs,
                     precision_level=0, sweep=True, weights=None,
                     fused="auto"):
    """The wide MLP regressed: MLPWorkflow(evaluator="mse") over
    FullBatchLoaderMSE (its default), the targets one-hot float32 with no
    target normalization, as build_mlp builds the classifier."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = MLPWorkflow(
        DummyLauncher(), layers=WIDE_LAYERS, evaluator="mse",
        loader_kwargs=dict(data=data, targets=targets,
                           class_lengths=class_lengths,
                           minibatch_size=WIDE_MINIBATCH,
                           normalization_type="linear",
                           target_normalization_type="none"),
        learning_rate=TRAIN_LR, max_epochs=epochs, fused_sweep=sweep,
        fused=fused, device=device, name="mse")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def one_hot(labels, classes=10):
    return numpy.eye(classes, dtype=numpy.float32)[labels]


def report_mse(label, wf, epochs, wall, n_images):
    """report_training's line for the regression family: train and
    validation MSE per epoch and the best validation MSE."""
    losses = report_training(label, wf, epochs, wall, n_images)
    valid = [e["valid_mse"] for e in epochs]
    print("  validation MSE per epoch %s; best %.6f (epoch %d)"
          % (["%.6f" % v for v in valid],
             wf.decision.best_mse[VALID], wf.decision.best_epoch))
    if not all(math.isfinite(v) for v in valid):
        raise AssertionError("%s: a validation MSE is not finite" % label)
    return losses


def mse_phase(device):
    """The wide MLP regressed on the bench data (one-hot targets),
    MSE_EPOCHS epochs in the fused tick with the knobs on, off, off and
    on: with the knobs on the counters (zeroed before each run) must
    show K6 once per train and eval minibatch and K5 once per train
    minibatch (the main path), with them off no kernel, and the train
    MSE must fall. Returns the first knobs-on run's launches."""
    data, labels = bench_dataset()
    targets = one_hot(labels)
    main = None
    for knobs in (True, False, False, True):
        wf = build_regression(device, data, targets, BENCH_CLASS_LENGTHS,
                              knobs, MSE_EPOCHS)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        losses = report_mse("wide MLP regressed (MSE) 784-4096-10 mb 4096, "
                            "knobs %s" % ("on" if knobs else "off"), wf,
                            epochs, wall, len(data))
        test, valid, train_mb = wf.fused_tick.minibatch_counts
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want.update(dense_epilogue=test + valid + train_mb,
                        blocked_matmul=train_mb)
            main = main or got
        print("  launches %s (the tick's minibatches require %s)"
              % ({k: v for k, v in got.items() if v},
                 {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != MSE_EPOCHS \
                or wf.fused_tick._loss_kind_ != "mse" \
                or not losses[-1] < losses[0]:
            raise AssertionError("wide MLP regressed: %d epochs, MSE %s, "
                                 "launches %s, expected %s"
                                 % (len(epochs), losses, got, want))
        del wf
    return main


def mse_tiers_phase(device):
    """The wide MLP regressed for one epoch each, knobs on, in graph mode
    (fused=False), in the sweep tier (a sweep-transparent host unit
    spliced between the forwards) and in the segment tier (the same unit
    opaque): the tier that engages is asserted; images/s."""
    data, labels = bench_dataset()
    targets = one_hot(labels)
    rates = {}
    for tier in ("graph", "sweep", "segment"):
        wf = build_regression(device, data, targets, BENCH_CLASS_LENGTHS,
                              True, 1,
                              fused=False if tier == "graph" else "auto")
        obs = splice_observer(wf, tier == "sweep") \
            if tier != "graph" else None
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        if engaged_tier(wf) != tier:
            raise AssertionError("the MSE %s run engaged the %s tier"
                                 % (tier, engaged_tier(wf)))
        report_mse("MSE tiers: %s, wide MLP regressed, knobs on" % tier, wf,
                   epochs, wall, len(data))
        rates[tier] = len(data) * len(epochs) / wall
        print("  tier %s engaged: %.1f images/s over the run, %.1f "
              "composite calls; launches %s%s"
              % (tier, rates[tier], composite_calls(wf),
                 {k: v for k, v in got.items() if v},
                 ", observer fired %d times" % obs.ticks if obs else ""))
        if len(epochs) != 1 or not got["blocked_matmul"] \
                or (obs is not None and obs.ticks != sum(
                    minibatch_counts(wf))):
            raise AssertionError("MSE tier %s: %d epochs, launches %s"
                                 % (tier, len(epochs), got))
        del wf
    return rates


def mse_agreement_phase(device):
    """One epoch of the wide MLP regressed at precision level 2 (f32; K5
    and K6 on f32 operands) on the card and on the CPU, per-minibatch
    serving, from the same numpy weights (the training agreement's data):
    equal index streams, each class's loss within MSE_AGREE_RTOL
    relative, every weight leaf within MSE_AGREE_RTOL of its largest
    element."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, targets = data[:n], one_hot(labels[:n])
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    runs = []
    for dev in (device, torch.device("cpu")):
        wf = build_regression(dev, data, targets, AGREE_CLASS_LENGTHS, True,
                              1, precision_level=2, sweep=False,
                              weights=weights)
        served = []
        serve_next = wf.loader.serve_next_minibatch

        def recorded(serve_next=serve_next, served=served):
            block = serve_next()
            served.append(block[1])
            return block

        wf.loader.serve_next_minibatch = recorded
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, _ = train(wf, dev)
        runs.append((served, [(e["train_loss"], e["valid_mse"])
                              for e in epochs], mlp_leaves(wf), counts()))
    (served_c, loss_c, leaves_c, got_c), (served_h, loss_h, leaves_h,
                                          got_h) = runs
    same = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    loss_rel = max(abs(a - b) / abs(b) for pc, ph in zip(loss_c, loss_h)
                   for a, b in zip(pc, ph))
    rel = leaf_rel(leaves_c, leaves_h)
    print("MSE agreement f32 (level 2), 1 epoch, %d minibatches: index "
          "streams %s; (train, valid) MSE card %s, CPU %s (largest relative "
          "difference %.3g, tolerance %.0e); largest leaf difference %.3g of "
          "the leaf's largest element (tolerance %.0e); card launches K5 %d, "
          "K6 %d; CPU launches %d"
          % (len(served_c), "equal" if same else "DIFFER", loss_c, loss_h,
             loss_rel, MSE_AGREE_RTOL, rel, MSE_AGREE_RTOL,
             got_c["blocked_matmul"], got_c["dense_epilogue"],
             sum(got_h.values())))
    if not same or len(loss_c) != 1 or len(loss_h) != 1 \
            or not loss_rel <= MSE_AGREE_RTOL or not rel <= MSE_AGREE_RTOL:
        raise AssertionError("the card's MSE training disagrees with the "
                             "CPU's")
    if not (got_c["blocked_matmul"] and got_c["dense_epilogue"]) \
            or any(got_h.values()):
        raise AssertionError("the card run skipped a kernel or the CPU run "
                             "launched one")


def normalizers_phase(device):
    """Each of the eight normalizers: analyze and apply_state on the
    bench's 60000 x 784 pixels on the card and on the CPU; the state and
    the output within NORM_RTOL of their largest element. Prints the
    card's and the CPU's seconds."""
    data, _ = bench_dataset()
    mean = data[:1000].mean(axis=0)
    for name in NORMALIZER_NAMES:
        kwargs = {"mean_source": mean} if name == "external_mean" else {}
        results = []
        for dev in (device, torch.device("cpu")):
            batch = torch.from_numpy(data).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            norm = make_normalizer(name, **kwargs)
            if not norm.STATELESS:
                norm.analyze(batch)
            state = norm.jit_state()
            out = norm.apply_state(batch, state_tensors(state, dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results.append((state, out.cpu(), wall))
        (state_c, out_c, wall_c), (state_h, out_h, wall_h) = results
        state_err = max([
            ((torch.as_tensor(state_c[k]).cpu().double()
              - torch.as_tensor(v).double()).abs().max()
             / max(torch.as_tensor(v).double().abs().max().item(), 1e-30)
             ).item() for k, v in state_h.items()] or [0.0])
        out_err = ((out_c - out_h).abs().max() / out_h.abs().max()).item()
        print("normalizer %s on %d x %d: state %s within %.3g, output within "
              "%.3g of its largest (tolerance %.0e); card %.4f s, CPU %.4f s"
              % (name, data.shape[0], data.shape[1], sorted(state_h),
                 state_err, out_err, NORM_RTOL, wall_c, wall_h))
        if sorted(state_c) != sorted(state_h) \
                or not torch.isfinite(out_c).all() \
                or not state_err <= NORM_RTOL or not out_err <= NORM_RTOL:
            raise AssertionError("normalizer %s: the card disagrees with "
                                 "the CPU" % name)


def write_wav(path, freq, rate=SOUND_RATE, seconds=1.0):
    """A 16-bit mono PCM tone; returns the samples written."""
    t = numpy.arange(int(rate * seconds)) / rate
    payload = (numpy.sin(2 * numpy.pi * freq * t) * 32000).astype(
        numpy.int16)
    with wave.open(path, "wb") as out:
        out.setnchannels(1)
        out.setsampwidth(2)
        out.setframerate(rate)
        out.writeframes(payload.tobytes())
    return payload


def loader_files_phase(device, directory):
    """The loaders' files: the first epoch of mnist_phase's loader with
    shuffling off (shuffle_limit=0) recorded by MinibatchesSaver and
    replayed through MinibatchesLoader, every minibatch equal bit for
    bit; PicklesLoader on pickles of the bench data and
    AutoLabelSoundFileLoader on WAV tones the smoke writes, their arrays
    equal to what was written."""
    wf = build_mnist(device, directory, 1, shuffle_limit=0)
    loader = wf.loader
    stream = os.path.join(directory, "minibatches.dat")
    saver = MinibatchesSaver(wf, file_name=stream, compression="raw")
    saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
                     "minibatch_class", "minibatch_valid_size",
                     "class_lengths", "max_minibatch_size")
    loader.initialize()
    saver.initialize()
    recorded = []
    t0 = time.perf_counter()
    while True:
        loader.run()
        saver.run()
        recorded.append((loader.minibatch_data.mem.copy(),
                         loader.minibatch_labels.mem.copy()))
        if loader.epoch_ended:
            break
    saver.stop()
    wall_w = time.perf_counter() - t0
    replay = MinibatchesLoader(wf, file_name=stream,
                               minibatch_size=MNIST_MINIBATCH)
    replay.initialize()
    t0 = time.perf_counter()
    equal = True
    for data, labels in recorded:
        replay.run()
        equal = equal and (
            replay.minibatch_data.mem.tobytes() == data.tobytes()
            and replay.minibatch_labels.mem.tobytes() == labels.tobytes())
    replay.stop()
    wall_r = time.perf_counter() - t0
    print("minibatch stream: %d minibatches of %d (%d MB, raw) recorded in "
          "%.2f s, replayed through MinibatchesLoader on %s in %.2f s: bit "
          "for bit %s" % (len(recorded), MNIST_MINIBATCH,
                          os.path.getsize(stream) >> 20, wall_w,
                          replay.minibatch_data.data.device, wall_r, equal))
    if not equal or len(recorded) != (MNIST_ROWS // MNIST_MINIBATCH):
        raise AssertionError("the replayed minibatch stream differs")
    data, labels = bench_dataset()
    rows = {"validation": slice(0, PICKLE_VALID),
            "train": slice(PICKLE_VALID, PICKLE_VALID + PICKLE_TRAIN)}
    paths = {}
    for part, rows_of in rows.items():
        paths[part] = os.path.join(directory, part + ".pickle")
        with open(paths[part], "wb") as fout:
            pickle.dump((data[rows_of], labels[rows_of]), fout, protocol=4)
    pickles = PicklesLoader(
        wf, validation_pickles=[paths["validation"]],
        train_pickles=[paths["train"]], minibatch_size=WIDE_MINIBATCH)
    pickles.initialize()
    n = PICKLE_VALID + PICKLE_TRAIN
    same_pickles = (
        pickles.class_lengths == [0, PICKLE_VALID, PICKLE_TRAIN]
        and numpy.array_equal(pickles.original_data.data.cpu().numpy(),
                              data[:n])
        and numpy.array_equal(pickles.original_labels.data.cpu().numpy(),
                              labels[:n]))
    sound_dir = os.path.join(directory, "sound")
    written = {}
    for split, count in (("validation", 2), ("train", 6)):
        for label, freq in (("high", 1800), ("low", 200)):
            os.makedirs(os.path.join(sound_dir, split, label))
            for i in range(count):
                path = os.path.join(sound_dir, split, label, "%d.wav" % i)
                written[path] = write_wav(path, freq + 7 * i)
    sound = AutoLabelSoundFileLoader(
        wf, validation_paths=[os.path.join(sound_dir, "validation")],
        train_paths=[os.path.join(sound_dir, "train")],
        window_size=SOUND_WINDOW, minibatch_size=64)
    sound.initialize()
    windows, sound_labels = [], []
    for split in ("validation", "train"):
        for path in sorted(p for p in written if os.sep + split + os.sep
                           in p):
            samples = (written[path] / 32768.0).astype(numpy.float32)
            for start in range(0, len(samples) - SOUND_WINDOW + 1,
                               SOUND_WINDOW):
                windows.append(samples[start:start + SOUND_WINDOW])
                sound_labels.append(path.split(os.sep)[-2])
    mapping = sound.labels_mapping
    same_sound = (
        numpy.array_equal(sound.original_data.data.cpu().numpy(),
                          numpy.stack(windows))
        and numpy.array_equal(sound.original_labels.data.cpu().numpy(),
                              [mapping[s] for s in sound_labels]))
    print("PicklesLoader: %s rows from 2 pickles, arrays equal the written "
          "ones: %s; AutoLabelSoundFileLoader: %d WAV files, %d windows of "
          "%d, class lengths %s, labels %s, arrays equal the written "
          "samples: %s" % (pickles.class_lengths, same_pickles, len(written),
                           len(windows), SOUND_WINDOW, sound.class_lengths,
                           mapping, same_sound))
    if not same_pickles or not same_sound:
        raise AssertionError("a file loader's arrays differ from the "
                             "written files")


def port_env():
    """The environment a ``python -m veles_tpu_torch`` subprocess runs
    in: this one, with the repository on PYTHONPATH."""
    return dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def a5_cli(device, directory, out, epochs, snapshot=None):
    """One ``python -m veles_tpu_torch`` run of A5_WORKFLOW with
    samples/mnist784_config.py, the knobs on, seed 1 (``snapshot``: the
    ``-w`` to resume from). Returns (results, counters, stderr, wall)."""
    workflow = os.path.join(out, "wide_mnist.py")
    with open(workflow, "w") as fout:
        fout.write(A5_WORKFLOW)
    results = os.path.join(out, "results-%d.json" % epochs)
    argv = [sys.executable, "-m", "veles_tpu_torch", workflow,
            os.path.join(REPO_DIR, "samples", "mnist784_config.py"),
            "root.common.engine.use_pallas=True",
            "root.common.engine.pallas_epilogue=True",
            "root.mnist784.directory=%r" % directory,
            "root.mnist784.out=%r" % out,
            "root.mnist784.max_epochs=%d" % epochs,
            "root.common.engine.pallas_autotune_cache=%r"
            % root.common.engine.pallas_autotune_cache,
            "--device", device.type, "--seed", "1",
            "--result-file", results]
    if snapshot is not None:
        argv += ["-w", snapshot]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO_DIR, env=port_env(),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError("the CLI run exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-4000:]))
    name = "resumed" if snapshot else "first"
    with open(results) as fin, \
            open(os.path.join(out, "counters-%s.json" % name)) as fin2:
        return json.load(fin), json.load(fin2), proc.stderr, wall


def a5_cli_launches(counters):
    """The launches a CLI run's main path requires: K6 once per train and
    eval minibatch, K5 once per train minibatch."""
    test, valid, train_mb = counters["minibatches"]
    return {"dense_epilogue": test + valid + train_mb,
            "blocked_matmul": train_mb}


def a5_cli_phase(device, directory, out):
    """The CLI run of A5_WORKFLOW on phase 16's idx files, A5_EPOCHS
    epochs (a snapshot per improved epoch, the package at 32 and 16 bits
    at the end), then ``-w <prefix>_current.lnk`` to A5_RESUMED_EPOCHS:
    exit 0, the epochs in the results, the snapshot, its sidecar and the
    link, "resuming from" in the log, and each run's K6 and K5 launches
    (counted in the subprocess) equal to what its tick's minibatches
    require. Returns the two runs' launches summed."""
    launches = dict.fromkeys(COUNTERS, 0)
    link = os.path.join(out, "wide_current.lnk")
    for epochs, snapshot in ((A5_EPOCHS, None),
                             (A5_RESUMED_EPOCHS, link)):
        results, counters, log, wall = a5_cli(device, directory, out,
                                              epochs, snapshot)
        want = a5_cli_launches(counters)
        got = {name: counters[name] for name in want}
        target = os.path.realpath(link)
        files_ok = (os.path.islink(link) and os.path.isfile(target)
                    and os.path.isfile(target + ".sha256"))
        images = MNIST_ROWS * (epochs - (A5_EPOCHS if snapshot else 0))
        print("CLI %s: python -m veles_tpu_torch wide_mnist.py "
              "samples/mnist784_config.py, knobs on, %s: exit 0 in %.1f s; "
              "results epochs %s, best validation errors %s; run_time %.3f "
              "s, %.1f images/s over it; snapshots written in %.3f s "
              "(%d MB each, uncompressed), link %s -> %s with sidecar: %s; "
              "%sminibatches (test, valid, train) %s, launches %s, required "
              "%s; run on %s"
              % ("resume" if snapshot else "run",
                 "-w %s" % os.path.basename(link) if snapshot
                 else "%d epochs" % epochs, wall, results["epochs"],
                 results["best_validation_errors"], results["run_time"],
                 images / results["run_time"], counters["snapshot_s"],
                 counters["snapshot_bytes"] >> 20, os.path.basename(link),
                 os.path.basename(target), files_ok,
                 "unpickled and placed on the card in %.3f s; "
                 % counters["load_s"] if snapshot else "",
                 counters["minibatches"], got, want, counters["device"]))
        if results["epochs"] != epochs or not files_ok or got != want \
                or (snapshot and "resuming from" not in log) \
                or counters["device"] != str(device):
            raise AssertionError("the CLI %s failed its checks"
                                 % ("resume" if snapshot else "run"))
        for name, n in got.items():
            launches[name] += n
    return launches


def a5_agreement_phase(device, directory):
    """Snapshot and resume on the card at level 2 (K5 and K6 on f32
    operands, momentum 0.9): A5_AGREE_SPLIT epochs, a snapshot after the
    run, import_ onto the card and a resume to A5_AGREE_EPOCHS, against
    A5_AGREE_EPOCHS uninterrupted epochs from the same seeds and numpy
    weights (phase 8's rows): equal index streams, per-epoch n_err within
    AGREE_N_ERR_TOL, every weight, bias and velocity within
    AGREE_WEIGHT_ATOL of its leaf's largest element."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, labels = data[:n], labels[:n]
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    log = {"sweeps": [], "epochs": []}
    serve, summary = Loader.serve_next_class_sweep, DecisionGD._epoch_summary

    def served(self):
        out = serve(self)
        log["sweeps"].append(numpy.asarray(out[1]).copy())
        return out

    def summarized(self, stats, epoch):
        log["epochs"].append(int(stats[VALID][0]))
        summary(self, stats, epoch)

    def build(epochs):
        root.common.engine.update({"use_pallas": True,
                                   "pallas_epilogue": True,
                                   "precision_level": 2})
        prng.get("default").seed(1234)
        prng.get("loader").seed(1234)
        wf = MLPWorkflow(
            DummyLauncher(), layers=WIDE_LAYERS,
            loader_kwargs=dict(data=data, labels=labels,
                               class_lengths=AGREE_CLASS_LENGTHS,
                               minibatch_size=WIDE_MINIBATCH,
                               normalization_type="linear"),
            learning_rate=TRAIN_LR, gradient_moment=MNIST_MOMENT,
            max_epochs=epochs, device=device, name="agree")
        unit_params_from_jax(wf, weights)
        return wf

    def leaves(wf):
        return mlp_leaves(wf) + [
            getattr(gd, name).data.float().cpu() for gd in wf.gds
            for name in ("_velocity_w", "_velocity_b")]

    # class-level hooks: instance attributes would ride the pickle
    Loader.serve_next_class_sweep = served
    DecisionGD._epoch_summary = summarized
    try:
        wf = build(A5_AGREE_EPOCHS)
        wf.initialize()
        wf.run()
        whole = (log["sweeps"][:], log["epochs"][:], leaves(wf))
        del wf
        log["sweeps"].clear()
        log["epochs"].clear()
        wf = build(A5_AGREE_SPLIT)
        wf.initialize()
        wf.run()
        snap = SnapshotterToFile(wf, directory=directory, prefix="agree",
                                 compression="", interval=1,
                                 time_interval=0)
        t0 = time.perf_counter()
        snap.export()
        export_s = time.perf_counter() - t0
        del wf
        t0 = time.perf_counter()
        restored = SnapshotterToFile.import_(snap.destination, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        placed = all(t.device.type == device.type for t in (
            restored.forwards[0].weights.data,
            restored.forwards[1].bias.data,
            restored.gds[0]._velocity_w.data,
            restored.loader.original_data.data,
            restored.loader.original_labels.data))
        restored.workflow = DummyLauncher()
        restored.decision.max_epochs = A5_AGREE_EPOCHS
        restored.decision.complete.unset()
        restored.decision.train_ended.unset()
        for fn in COUNTERS.values():
            fn.launches = 0
        restored.initialize()
        restored.run()
        got = counts()
        split = (log["sweeps"][:], log["epochs"][:], leaves(restored))
    finally:
        Loader.serve_next_class_sweep = serve
        DecisionGD._epoch_summary = summary
    same_stream = len(whole[0]) == len(split[0]) and all(
        numpy.array_equal(a, b) for a, b in zip(whole[0], split[0]))
    n_err_diff = max(abs(a - b) for a, b in zip(whole[1], split[1]))
    rel = leaf_rel(split[2], whole[2])
    print("resume agreement f32 (level 2), wide MLP, moment 0.9: %d epochs, "
          "a snapshot (%.3f s to write, %.3f s to unpickle and place on %s, "
          "every tensor there: %s), a resume to %d, against %d uninterrupted:"
          " index streams %s (%d sweeps), validation n_err %s vs %s (max "
          "diff %d, tolerance %d), leaves (weights, biases, velocities) "
          "within %.3g of their largest (tolerance %.0e); resumed run's "
          "launches K5 %d, K6 %d"
          % (A5_AGREE_SPLIT, export_s, load_s, device, placed,
             A5_AGREE_EPOCHS, A5_AGREE_EPOCHS,
             "equal" if same_stream else "DIFFER", len(whole[0]), split[1],
             whole[1], n_err_diff, AGREE_N_ERR_TOL, rel, AGREE_WEIGHT_ATOL,
             got["blocked_matmul"], got["dense_epilogue"]))
    if not same_stream or len(split[1]) != A5_AGREE_EPOCHS \
            or n_err_diff > AGREE_N_ERR_TOL or not rel <= AGREE_WEIGHT_ATOL \
            or not placed:
        raise AssertionError("the resumed run disagrees with the "
                             "uninterrupted one")


def a5_native_phase(device, out):
    """The CLI's last run restored onto the card (``_current.lnk``), its
    forward units given the exported f32 package's weights; the C++
    runtime (``native/``, built with g++ on this host) runs that package
    on A5_NATIVE_ROWS validation rows against the port's forward on the
    card in f32 (level 2, K6 on f32 operands): NATIVE_RTOL / NATIVE_ATOL
    and equal argmax. The f16 package must be under F16_SIZE_SHARE of the
    f32 one, within F16_ATOL of its outputs, and equal in argmax on every
    row whose f32 top-2 gap exceeds F16_TOP2_GAP. Returns the restored
    workflow."""
    t0 = time.perf_counter()
    restored = SnapshotterToFile.import_(
        os.path.join(out, "wide_current.lnk"), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p32, p16 = (os.path.join(out, "wide-resumed-%d.tar" % bits)
                for bits in (32, 16))
    with tarfile.open(p32) as tar:
        for fwd in restored.forwards:
            for name in ("weights", "bias"):
                blob = tar.extractfile("%s_%s.npy" % (fwd.name, name)).read()
                getattr(fwd, name).data = torch.from_numpy(
                    numpy.load(io.BytesIO(blob))).to(device)
    loader = restored.loader
    rows = loader.original_data.data[:A5_NATIVE_ROWS]
    batch = loader.normalizer.apply_state(
        rows, state_tensors(loader.normalizer.jit_state(), device))
    root.common.engine.update({"use_pallas": True, "pallas_epilogue": True,
                               "precision_level": 2})
    dense_before = dense_epilogue.launches
    ours = torch.softmax(forward_chain(restored)(batch), dim=-1).cpu().numpy()
    launched = dense_epilogue.launches - dense_before
    host = batch.cpu().numpy()
    t0 = time.perf_counter()
    rt32 = NativeWorkflow(p32)
    out32 = rt32.run(host)
    native_s = time.perf_counter() - t0
    out16 = NativeWorkflow(p16).run(host)
    err = numpy.abs(out32 - ours)
    within = bool(numpy.all(err <= NATIVE_ATOL + NATIVE_RTOL
                            * numpy.abs(ours)))
    same_argmax = bool(numpy.array_equal(out32.argmax(-1), ours.argmax(-1)))
    top2 = numpy.sort(out32, axis=-1)
    clear = (top2[:, -1] - top2[:, -2]) > F16_TOP2_GAP
    f16_err = float(numpy.abs(out16 - out32).max())
    f16_argmax = bool(numpy.array_equal(out16.argmax(-1)[clear],
                                        out32.argmax(-1)[clear]))
    share = os.path.getsize(p16) / os.path.getsize(p32)
    print("native export: the CLI's snapshot restored onto %s in %.3f s "
          "(%d units); C++ runtime (g++ build) on the f32 package, %d rows "
          "in %.3f s: max abs diff %.3g against the port's f32 forward on "
          "the card (K6 %d launch), within rtol %.0e / atol %.0e: %s, "
          "argmax equal: %s; f16 package %d KB = %.3f of the f32 %d KB, "
          "max abs diff %.3g (tolerance %.0e), argmax equal on %d of %d "
          "rows with a top-2 gap over %.0e: %s"
          % (device, load_s, rt32.unit_count, len(host), native_s,
             float(err.max()), launched, NATIVE_RTOL, NATIVE_ATOL, within,
             same_argmax, os.path.getsize(p16) >> 10, share,
             os.path.getsize(p32) >> 10, f16_err, F16_ATOL,
             int(clear.sum()), len(host), F16_TOP2_GAP, f16_argmax))
    if not within or not same_argmax or not share < F16_SIZE_SHARE \
            or not f16_err <= F16_ATOL or not f16_argmax or not clear.any():
        raise AssertionError("the native runtime disagrees with the port")
    return restored


def a5_rest_phase(device, restored):
    """Per-tick REST serving of the restored forward chain with the knobs
    on (level 0): RestfulLoader (derive_from the trained loader,
    minibatch A5_SERVE_MINIBATCH) -> fused.forward_chain -> RESTfulAPI,
    wired by hand as tests/test_serving.py:27-60 does; A5_CLIENTS client
    threads send A5_REQUESTS requests each (a validation row each, half
    the list codec, half base64). Every reply must be 200 and within
    REST_RTOL of the largest output of the forward on its own row, and
    the counters, zeroed just before, must show K6 once per served tick
    and nothing else: this checks the loader's batching, the codecs and
    the replies' order (phase 2 holds K6 at this tick's shape,
    K6_SERVE_SHAPE, against its plain version). Returns the launches."""
    root.common.engine.update({"use_pallas": True, "pallas_epilogue": True,
                               "precision_level": 0})
    forward = forward_chain(restored)
    loader_src = restored.loader
    n = A5_CLIENTS * A5_REQUESTS
    raw = loader_src.original_data.data[:n]
    state = state_tensors(loader_src.normalizer.jit_state(), device)
    want = []
    for start in range(0, n, A5_SERVE_MINIBATCH):
        block = torch.zeros((A5_SERVE_MINIBATCH, raw.shape[1]),
                            device=device)
        part = raw[start:start + A5_SERVE_MINIBATCH]
        block[:len(part)] = part
        block = loader_src.normalizer.apply_state(block, state)
        want.append(forward(block)[:len(part)].cpu().numpy())
    want = numpy.concatenate(want)
    samples = raw.cpu().numpy()
    wf = DummyWorkflow()
    wf.device = device
    loader = RestfulLoader(wf, minibatch_size=A5_SERVE_MINIBATCH,
                           max_response_time=A5_FLUSH_S)
    loader.derive_from(loader_src)
    loader.initialize()
    api = RESTfulAPI(wf, port=0, path="/api")
    api.feed = loader.feed
    api.requests = []
    api.initialize()
    ticks, rows = [0], [0]
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            loader.run()
            if loader.complete:
                return
            api.results = forward(loader.minibatch_data.data)
            api.requests = loader.requests
            api.run()
            ticks[0] += 1
            rows[0] += loader.minibatch_valid_size

    replies, latencies, errors = {}, [], []

    def client(c):
        for r in range(A5_REQUESTS):
            i = c * A5_REQUESTS + r
            if r % 2:
                body = {"input": base64.b64encode(
                    samples[i].tobytes()).decode(), "codec": "base64",
                    "shape": [samples.shape[1]], "type": "float32"}
            else:
                body = {"input": samples[i].tolist(), "codec": "list"}
            t0 = time.perf_counter()
            # a connection a request, as independent clients open them
            conn = http.client.HTTPConnection("127.0.0.1", api.port,
                                              timeout=60)
            try:
                conn.request("POST", "/api", body=json.dumps(body),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                replies[i] = (resp.status,
                              json.loads(resp.read().decode()).get("result"))
            except Exception as exc:  # reported below, fails the phase
                errors.append("request %d: %r" % (i, exc))
            finally:
                conn.close()
            latencies.append(time.perf_counter() - t0)

    for fn in COUNTERS.values():
        fn.launches = 0
    server = threading.Thread(target=serve, daemon=True)
    server.start()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(A5_CLIENTS)]
    t0 = time.perf_counter()
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    stop.set()
    loader.stop()
    server.join(timeout=30)
    api.stop()
    got = counts()
    ok = sum(1 for status, _ in replies.values() if status == 200)
    worst = max((numpy.abs(numpy.asarray(replies[i][1]) - want[i]).max()
                 / numpy.abs(want[i]).max() for i in replies), default=1.0)
    latencies.sort()
    expect = dict.fromkeys(COUNTERS, 0)
    expect["dense_epilogue"] = ticks[0]
    print("REST serving of the restored chain (RestfulLoader mb %d, flush "
          "%.0f ms -> forward_chain, knobs on -> RESTfulAPI): %d clients x "
          "%d requests (list and base64): %d replies 200 of %d, %d errors; "
          "%.1f requests/s, latency p50 %.2f ms p99 %.2f ms; %d ticks, %.1f "
          "rows per tick; worst reply off its row's forward by %.3g of the "
          "largest output (tolerance %.0e); launches %s, required %s"
          % (A5_SERVE_MINIBATCH, 1e3 * A5_FLUSH_S, A5_CLIENTS, A5_REQUESTS,
             ok, n, len(errors), n / wall,
             1e3 * latencies[len(latencies) // 2],
             1e3 * latencies[min(len(latencies) - 1,
                                 int(0.99 * len(latencies)))],
             ticks[0], rows[0] / max(ticks[0], 1), worst, REST_RTOL,
             {k: v for k, v in got.items() if v},
             {k: v for k, v in expect.items() if v}))
    if errors or ok != n or not worst <= REST_RTOL or got != expect \
            or not ticks[0]:
        raise AssertionError("REST serving failed: %s" % errors[:3])
    return got


# -- phase 18: parity on the card, the samples, the autotune and its routes --

#: the canonical digits split's SHA-256 (float32 pixels, int32 labels), as
#: scikit-learn's load_digits gives them (tests/test_torch_parity.py pins
#: the same digests against it)
DIGITS_X_SHA256 = ("b2b3b36b3126b74f5094139fa9c0003e55d3d445c07baad388e96d"
                   "594dfb658d")
DIGITS_Y_SHA256 = ("145cd6a20c97931d1ca61b3a4ccd37c02bbc5f3516cf28e868023"
                   "01870144436")
#: the images one parity epoch reads: the train and validation splits
DIGITS_EPOCH_IMAGES = 1500 + 297
#: the autotuned shapes. GEMM (MxNxK): the wide MLP's K6 forward and K5
#: weight gradient (one size bucket; the weight gradient, the product
#: "tuned" routes, last, so its verdict is the bucket's) and AlexNet's
#: head at minibatch 512
A6_GEMM_SHAPES = ((K6_SHAPE[0], K6_SHAPE[2], K6_SHAPE[1]),
                  (K5_SHAPE[0], K5_SHAPE[2], K5_SHAPE[1]), (512, 1000, 4096))
#: int8 (MxKxN): one prefill product at M = 256 first, then the serving
#: model's decode products at M = SLOTS (a KxN key keeps the last shape's
#: verdict, so the decode rows decide)
A6_INT8_SHAPES = ((256, EMBED, 3 * EMBED),) + tuple(
    (SLOTS, k, n) for k, n in K2_SHAPES)
#: the paged pool's page size and head width (PSxD)
A6_PAGED_SHAPES = ((PAGE, EMBED // HEADS),)
A6_TUNED_EPOCHS = 1


def run_port(argv, timeout=900):
    """``python -m veles_tpu_torch argv`` from the repository's root;
    returns (the completed process, its wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "veles_tpu_torch", *argv],
                          cwd=REPO_DIR, env=port_env(), capture_output=True,
                          text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def digits_phase():
    """The committed digits without scikit-learn: both layouts' shapes and
    the digests of the canonical split."""
    import hashlib
    import importlib.util
    for flat, shape in ((True, (1797, 64)), (False, (1797, 8, 8, 1))):
        x, y = digits_dataset(flat)
        digests = (hashlib.sha256(x.tobytes()).hexdigest(),
                   hashlib.sha256(y.tobytes()).hexdigest())
        print("digits (flat=%s): %s %s, %s %s; SHA-256 %s / %s; "
              "scikit-learn importable here: %s"
              % (flat, x.shape, x.dtype, y.shape, y.dtype, digests[0][:16],
                 digests[1][:16],
                 importlib.util.find_spec("sklearn") is not None))
        if x.shape != shape or y.shape != (1797,) \
                or digests != (DIGITS_X_SHA256, DIGITS_Y_SHA256):
            raise AssertionError("the committed digits are not the "
                                 "canonical split")


def parity_start(out):
    """Start ``python -m veles_tpu_torch parity`` on the card and, beside
    it, the three digits samples through the CLI, all at once, each
    writing its log into ``out``; returns the state parity_finish reads.
    They run beside the phases between the two calls."""
    samples = {"digits_mlp": ["samples/digits_config.py"],
               "transformer_digits": ["-"], "som_digits": ["-"]}
    state = {"out": out, "t0": time.perf_counter(), "samples": {}}
    try:
        for name, config in samples.items():
            log = open(os.path.join(out, name + ".log"), "w+")
            result = os.path.join(out, name + ".json")
            state["samples"][name] = (subprocess.Popen(
                [sys.executable, "-m", "veles_tpu_torch",
                 os.path.join(REPO_DIR, "veles_tpu_torch", "samples",
                              name + ".py"), *config, "--result-file",
                 result],
                cwd=REPO_DIR, env=port_env(), stdout=log,
                stderr=subprocess.STDOUT), log, result)
        log = open(os.path.join(out, "parity.log"), "w+")
        state["parity"] = (subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "parity", "--out",
             os.path.join(out, "PARITY.json")],
            cwd=REPO_DIR, env=port_env(), stdout=log,
            stderr=subprocess.STDOUT), log)
    except BaseException:
        parity_kill(state)
        raise
    return state


def parity_kill(state):
    """Stop whatever parity_start started (a phase between failed)."""
    for proc, log, *_ in list(state["samples"].values()) + [
            state.get("parity", (None, None))]:
        if proc is not None:
            proc.kill()
            proc.wait()
            log.close()


def parity_finish(state):
    """Wait for parity_start's children: parity exits 0 with every family
    within its bound, and each digits sample exits 0."""
    failed = []
    try:
        parity_run(state)
    finally:
        for name, (proc, log, result) in state["samples"].items():
            try:
                code = proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                code = proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            results = json.load(open(result)) if os.path.exists(result) \
                else {}
            print("sample %s through the CLI on the card: exit %d; results "
                  "%s" % (name, code, json.dumps(results)[:300]))
            if code:
                failed.append("%s (exit %d):\n%s" % (name, code,
                                                      text[-3000:]))
    print("the three digits samples, run at once beside parity: %.1f s "
          "from their start" % (time.perf_counter() - state["t0"]))
    if failed:
        raise AssertionError("samples failed: " + "\n".join(failed))


def parity_run(state):
    """Wait for the parity run (at most 900 s from its start) and check
    its verdict."""
    proc, log = state["parity"]
    try:
        proc.wait(timeout=max(1.0, 900 - (time.perf_counter()
                                          - state["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.perf_counter() - state["t0"]
    log.seek(0)
    text = log.read()
    log.close()
    if proc.returncode:
        raise AssertionError("parity exited %d:\n%s"
                             % (proc.returncode, text[-4000:]))
    verdict = json.load(open(os.path.join(state["out"], "PARITY.json")))
    for entry in verdict["results"]:
        print("parity %s: validation error %.3f%% (bound %.1f%%), %d "
              "epochs, best epoch %d, %.1f s, %.1f images/s"
              % (entry["name"], entry["val_error_pct"], entry["bound_pct"],
                 entry["epochs"], entry["best_epoch"], entry["seconds"],
                 entry["epochs"] * DIGITS_EPOCH_IMAGES / entry["seconds"]))
        if not entry["pass"] or entry["val_error_pct"] > entry["bound_pct"]:
            raise AssertionError("%s missed its bound" % entry["name"])
    print("parity: %s (mode %s), exit 0 in %.1f s from its start"
          % ("PASS" if verdict["pass"] else "FAIL", verdict["mode"], wall))
    if not verdict["pass"] or len(verdict["results"]) != 3:
        raise AssertionError("the parity verdict failed")


def autotune_phase(device, out):
    """``python -m veles_tpu_torch autotune`` on the card for the GEMM,
    int8 and paged-attention shapes into one cache file: every verdict
    persisted under this card's key, printed with the kernel's and the
    plain route's milliseconds. Returns (the cache path, its entries)."""
    cache = os.path.join(out, "pallas_tuning.json")

    def spec(shapes):
        return ",".join("x".join(map(str, shape)) for shape in shapes)

    lines = []
    for shapes, extra in ((A6_GEMM_SHAPES, []), (A6_INT8_SHAPES, ["--int8"]),
                          (A6_PAGED_SHAPES, ["--paged-attention"])):
        proc, wall = run_port(["autotune", spec(shapes), *extra,
                               "--cache", cache])
        if proc.returncode:
            raise AssertionError("autotune %s exited %d:\n%s"
                                 % (" ".join(extra), proc.returncode,
                                    proc.stderr[-4000:]))
        got = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
        print("autotune %s: %d shapes in %.1f s"
              % (" ".join(extra) or "(GEMM)", len(got), wall))
        if len(got) != len(shapes):
            raise AssertionError("autotune printed %d lines for %d shapes"
                                 % (len(got), len(shapes)))
        lines += got
    stored = json.load(open(cache))
    tag = device_tag(device)
    for line in lines:
        entry = stored.get("%s|%s" % (tag, line["key"]))
        choice = {key: line[key] for key in ("blocks", "splits", "pages")
                  if key in line}
        print("  verdict %s shape %s: kernel %.4f ms, plain route %.4f ms, "
              "%s, verdict %s; stored for shape %s, candidates %s"
              % (line["key"], line["shape"], line["kernel_ms"],
                 line["plain_ms"], choice, line["verdict"],
                 entry and entry.get("shape"),
                 entry and json.dumps(entry.get("measured"))))
        if not line["persisted"] or line["device"] != tag or entry is None:
            raise AssertionError("the %s verdict is not persisted under "
                                 "%r" % (line["key"], tag))
    return cache, stored


def tuned_mlp_phase(device, cache, stored):
    """The wide MLP for A6_TUNED_EPOCHS under ``use_pallas="tuned"`` with
    the autotuned cache (the knobs "tuned", so K6 runs every dense
    forward at the tuned tile width): K6 once per minibatch, and K5 once
    per train minibatch exactly where the weight gradient's bucket says
    ``beats_xla``, else never. Returns the launches."""
    kind = _gemm_kind(K5_SHAPE[0], K5_SHAPE[2], K5_SHAPE[1], torch.bfloat16)
    entry = stored.get("%s|%s" % (device_tag(device), kind)) or {}
    data, labels = bench_dataset()
    wf = build_mlp(device, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                   BENCH_CLASS_LENGTHS, "tuned", A6_TUNED_EPOCHS)
    isolated = root.common.engine.pallas_autotune_cache
    root.common.engine.pallas_autotune_cache = cache
    for fn in COUNTERS.values():
        fn.launches = 0
    try:
        epochs, wall = train(wf, device)
    finally:
        root.common.engine.pallas_autotune_cache = isolated
    got = counts()
    report_training("wide MLP 784-4096-10 mb 4096, use_pallas=\"tuned\"",
                    wf, epochs, wall, len(data))
    test, valid, train_mb = wf.fused_tick.minibatch_counts
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dense_epilogue=test + valid + train_mb,
                blocked_matmul=train_mb if entry.get("beats_xla") else 0)
    print("  bucket %s: beats_xla %s, BN %s; launches %s, the verdicts "
          "imply %s" % (kind, entry.get("beats_xla"), entry.get("blocks"),
                        {k: v for k, v in got.items() if v},
                        {k: v for k, v in want.items() if v}))
    if got != want or len(epochs) != A6_TUNED_EPOCHS:
        raise AssertionError("the tuned run's launches %s are not what the "
                             "verdicts imply, %s" % (got, want))
    del wf
    return got


def tuned_serving_phase(device, prompts, cache, stored):
    """The int8 burst with no verdicts (K2 wherever M <= 256, the pinned
    run) and under the autotuned cache: in the tuned run every product
    takes the route its ``int8:KxN`` verdict names (the kernel at the
    verdict's split count, or the dequantized product), and K2's
    launches equal the products routed to it; the streams equal the
    pinned run's, or the prefill logits of both routes agree within the
    K2 tolerance. Returns the tuned run's launches."""
    tag = device_tag(device)
    params, table = bf16_model(device)
    calls = {"kernel": [], "plain": []}
    recording = [False]
    real_plan, real_plain = quant_ops._int8_plan, quant_ops._int8_matmul_plain

    def plan(m, k, n, sms, splits=None):
        if recording[0]:
            calls["kernel"].append((m, k, n, splits))
        return real_plan(m, k, n, sms, splits)

    def plain(x, q, scale):
        if recording[0]:
            calls["plain"].append((x.shape[0], x.shape[1], q.shape[1]))
        return real_plain(x, q, scale)

    def expected(m, k, n, tuned):
        entry = stored.get("%s|int8:%dx%d" % (tag, k, n)) if tuned else None
        if m > quant_ops.PALLAS_MAX_ROWS:
            return False, None
        if entry:
            return bool(entry["use_pallas"]), entry.get("splits")
        return True, None

    runs = {}
    isolated = root.common.engine.pallas_autotune_cache
    quant_ops._int8_plan, quant_ops._int8_matmul_plain = plan, plain
    try:
        for label, path in (("pinned", isolated), ("tuned", cache)):
            root.common.engine.pallas_autotune_cache = path
            calls = {"kernel": [], "plain": []}
            run = serve(params, table, [prompts], "int8", device,
                        on_zero=lambda: recording.__setitem__(0, True))
            recording[0] = False
            routed = {"kernel": len(calls["kernel"]),
                      "plain": len(calls["plain"])}
            wrong = [c for c in calls["kernel"]
                     if expected(*c[:3], label == "tuned")
                     != (True, c[3])]
            wrong += [c for c in calls["plain"]
                      if expected(*c, label == "tuned")[0]]
            shapes = sorted({c[:3] for c in calls["kernel"]})
            print("serve int8 bf16, %s: %.1f tokens/s; K2 launches %d; "
                  "products to K2 %d, to the dequantized product %d; K2 "
                  "shapes (m, k, n) %d distinct; off-verdict %d"
                  % (label, len(prompts) * N_TOKENS / run["wall"],
                     run["launches"]["int8_matmul"], routed["kernel"],
                     routed["plain"], len(shapes), len(wrong)))
            if wrong or run["launches"]["int8_matmul"] != routed["kernel"]:
                raise AssertionError("%s: products off their verdicts: %s"
                                     % (label, wrong[:8]))
            runs[label] = run
        qparams = quantize_params(params)
        x = table[torch.tensor(prompts[0][:SLOTS], device=device)][None]
        logits = {}
        for label, path in (("pinned", isolated), ("tuned", cache)):
            root.common.engine.pallas_autotune_cache = path
            logits[label] = _prefill_forward(qparams, x, HEADS)[0].float()
    finally:
        quant_ops._int8_plan, quant_ops._int8_matmul_plain = real_plan, \
            real_plain
        root.common.engine.pallas_autotune_cache = isolated
    same = runs["tuned"]["streams"] == runs["pinned"]["streams"]
    err = (logits["tuned"] - logits["pinned"]).abs().max().item()
    bound = K2_RTOL * logits["pinned"].abs().max().item()
    print("  streams tuned vs pinned: %s; prefill logits (%d tokens) "
          "differ by %.3g (K2 bound %.3g)" % (
              "equal" if same else "differ", x.shape[1], err, bound))
    if not same and err > bound:
        raise AssertionError("the tuned routes change the streams and the "
                             "logits beyond the K2 tolerance")
    return runs["tuned"]["launches"]


def benchmark_phase(device):
    power = device_benchmark(device=device)
    print("device_benchmark (1024 x 1024 bf16, depth 4, 3 runs): power "
          "%.2f (1000/s of a run)" % power)
    if not (power > 0 and math.isfinite(power)):
        raise AssertionError("device_benchmark gave %r" % power)



# -- phase 19: the observe plane ----------------------------------------------

def planes(on):
    """Every observe plane on or off: the metrics registry, the
    device-truth tracker, the tracer and the flight ring."""
    for plane in (get_metrics_registry(), get_compile_tracker(),
                  get_tracer(), get_flight_recorder()):
        plane.enabled = on


def serving_hooks(on):
    """The serving hooks that are on by default: the request ledger, the
    serve scope and memscope's lifecycle edges."""
    for plane in (get_request_ledger(), get_serve_scope(), get_memscope()):
        plane.enabled = on


def hold_planes_off():
    """Phases 1-18 run with every observe plane off, as they ran before
    phase 19: the serving fronts' ``enable_metrics`` (core/httpd.py) hands
    back the registry without enabling it, the device truth or the
    history's sampler, and the flight ring, the request ledger, the serve
    scope and memscope's edges are off. Returns what
    :func:`release_planes` restores."""
    real = httpd.enable_metrics
    httpd.enable_metrics = lambda holder=None: get_metrics_registry()
    planes(False)
    serving_hooks(False)
    return real


def release_planes(real):
    """Phase 19 as before phase 20: the planes back, the serving hooks
    on (their defaults), and no metric history (phase 19's readings stay
    those of the planes it measures)."""
    httpd.enable_metrics = real
    get_flight_recorder().enabled = True
    serving_hooks(True)
    set_metric_history(None)


def scrape(port, openmetrics=False):
    headers = ({"Accept": "application/openmetrics-text"} if openmetrics
               else {})
    req = urllib.request.Request("http://127.0.0.1:%d/metrics" % port,
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read().decode()


_SAMPLE = re.compile(r'^([a-zA-Z_:][\w:]*)(?:\{(.*?)\})? (\S+)'
                     r'(?: # \{(.*?)\} .*)?$')
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def samples(text, name):
    """The samples of family member ``name`` in an exposition:
    ``[(labels, value, exemplar labels or None)]``."""
    out = []
    for line in text.splitlines():
        match = _SAMPLE.match(line)
        if match is None or match.group(1) != name:
            continue
        labels = dict(_LABEL.findall(match.group(2) or ""))
        exemplar = (dict(_LABEL.findall(match.group(4)))
                    if match.group(4) else None)
        out.append((labels, float(match.group(3)), exemplar))
    return out


def sample(text, name, **labels):
    """The one value of ``name`` whose labels include ``labels``."""
    found = [v for got, v, _ in samples(text, name)
             if all(got.get(k) == v for k, v in labels.items())]
    if len(found) != 1:
        raise AssertionError("%s%s: %d samples" % (name, labels,
                                                   len(found)))
    return found[0]


def observed_burst(params, table, prompts, quantize, attend, device, tier):
    """The paged ``quantize`` burst with every plane on and a trace
    header on each request (a short warm-up first), then ``/metrics`` as
    text and as OpenMetrics: the request and token counters exact, the
    device memory above what was live before the API at least its int8
    weights and pool, the bf16 peak, the dispatch's FLOPs within an
    independent count from the model's widths and its MFU in (0,
    OBSERVE_MFU_MAX], the kernel builds of K1, K2 and K3, and the latency
    exemplars among the trace ids sent. The registry starts empty (the
    fronts before bridged it too). Returns the launches after the warm-up
    and the trace ids sent."""
    get_metrics_registry().reset()
    # the bytes the earlier phases left live: the API's own allocations
    # are what /metrics reads above this
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize=quantize,
                      device=device).start()
    ids = ["%04x%04x" % (0xc0de, tier * 256 + i)
           for i in range(len(prompts) + 1)]
    try:
        warm = post(api.port, prompts[0][:min(16, PAGE - 1)], CHUNK,
                    trace_id=ids[0])
        torch.cuda.synchronize()
        chunks = api.decoder.dispatch_counts["chunk"]
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        streams = burst(api.port, prompts, trace_ids=ids[1:])
        wall = time.perf_counter() - t0
        got = counts()
        steps = (api.decoder.dispatch_counts["chunk"] - chunks) * CHUNK
        text, om = scrape(api.port), scrape(api.port, openmetrics=True)
        # the int8 weights the decoder quantized (the embedding table is
        # the caller's tensor, allocated before)
        held = _tree_bytes(api.decoder.params)
        pool = paged_kv_bytes(api.decoder.state)
    finally:
        api.stop()
    sent, tokens = len(prompts) + 1, len(warm) + sum(map(len, streams))
    outcomes = {labels["outcome"]: value for labels, value, _ in
                samples(text, "veles_serving_requests_total")
                if labels.get("api") == "generate-api"}
    in_use = sample(text, "veles_device_memory_bytes", device="0",
                    kind="bytes_in_use")
    peak = sample(text, "veles_device_peak_bf16_tflops")
    mfu = sample(text, "veles_mfu_ratio", program="paged.dispatch")
    flops = sample(text, "veles_program_flops", program="paged.dispatch")
    # an independent count of the last dispatch from the model's widths:
    # every lane's weight products each step (qkv + out 4 E^2, the MLP
    # 8 E^2 a block, the head E V), plus attention between none and
    # every lane attending MAX_LEN positions in every block each step
    products = 2.0 * SLOTS * CHUNK * (BLOCKS * 12 * EMBED ** 2
                                      + EMBED * VOCAB)
    flops_range = (products,
                   products + 4.0 * EMBED * BLOCKS * SLOTS * CHUNK * MAX_LEN)
    builds = {labels["kernel"]: value for labels, value, _ in
              samples(text, "veles_kernel_builds_total")}
    exemplars = [ex["trace_id"] for _, _, ex in
                 samples(om, "veles_request_ttft_seconds_bucket") if ex]
    print("observe %s bf16: %d traced requests x %d tokens in %.3f s = "
          "%.1f tokens/s; /metrics: requests %s, tokens %d; device memory "
          "%d bytes in use, %d above the %d before the API >= int8 "
          "weights %d + pool %d; peak %.1f TFLOP/s; paged.dispatch %.6g "
          "FLOPs (independent count %.6g-%.6g), MFU %.6g; builds %s; %d "
          "exemplars on the TTFT buckets" % (
              quantize, len(prompts), N_TOKENS, wall,
              len(prompts) * N_TOKENS / wall, outcomes,
              sample(text, "veles_decode_tokens_total"), in_use,
              in_use - before, before, held, pool, peak, flops,
              flops_range[0], flops_range[1], mfu, builds,
              len(exemplars)))
    want = dict.fromkeys(("rejected", "expired", "shed", "errors", "trips",
                          "rebuilds"), 0.0)
    want.update(admitted=sent, completed=sent)
    if {k: outcomes.get(k) for k in want} != want:
        raise AssertionError("requests_total %s, sent %d" % (outcomes,
                                                             sent))
    if sample(text, "veles_decode_tokens_total") != tokens:
        raise AssertionError("decode_tokens_total != %d returned" % tokens)
    if in_use - before < held + pool:
        raise AssertionError("bytes_in_use %d - %d before the API < int8 "
                             "weights + pool %d"
                             % (in_use, before, held + pool))
    if not flops_range[0] <= flops <= flops_range[1]:
        raise AssertionError("paged.dispatch FLOPs %r outside the "
                             "independent count %r" % (flops, flops_range))
    if peak != peak_tflops(torch.cuda.get_device_name(0)):
        raise AssertionError("peak %r is not the card's" % peak)
    if not 0 < mfu <= OBSERVE_MFU_MAX:
        raise AssertionError("paged.dispatch MFU %r outside (0, %g]: the "
                             "FLOP count is wrong" % (mfu, OBSERVE_MFU_MAX))
    missing = {"paged_attention.cu", "int8_matmul.cu",
               "paged_attention_int8.cu"} - {k for k, v in builds.items()
                                             if v >= 1}
    if missing:
        raise AssertionError("no kernel build booked for %s" % missing)
    if not exemplars or set(exemplars) - set(ids):
        raise AssertionError("TTFT exemplars %s, sent %s" % (exemplars,
                                                             ids))
    if got[attend] < BLOCKS * steps or got["int8_matmul"] \
            < sum(K2_PER_STEP) * steps:
        raise AssertionError("the observed %s burst launched %s over %d "
                             "steps" % (quantize, got, steps))
    return got, ids


def check_span_trees(events, trace_ids, out):
    """Export the events through ``python -m veles_tpu_torch observe
    export-trace``; every request's own spans must form one tree from its
    ``serve.request`` (the client span's child) through ``serve.submit``
    to ``serve.complete``, and its request id must ride the ``rids`` of
    an admission, a ``paged.dispatch`` and a ``decode.collect`` span,
    each of which hangs off its owner request's tree. Prints the median
    host ms of each span name."""
    trace_path = os.path.join(out, "serve.trace.json")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "observe",
         "export-trace", events, "-o", trace_path], cwd=REPO_DIR,
        env=port_env(), capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError("export-trace exited %d: %s"
                             % (proc.returncode, proc.stderr[-2000:]))
    with open(trace_path) as fin:
        trace = json.load(fin)
    trees = span_tree(trace)
    names = {e["args"]["span_id"]: e["name"] for e in trace["traceEvents"]
             if e.get("args", {}).get("span_id")}
    batch = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and e["name"] in ADMIT_SPANS + ("paged.dispatch",
                                             "decode.collect")]
    for trace_id in trace_ids:
        tree = trees.get(trace_id, {})
        roots = [s for s, p in tree.items() if p == CLIENT_SPAN]
        if [names[s] for s in roots] != ["serve.request"]:
            raise AssertionError("trace %s: roots %s" % (
                trace_id, [names[s] for s in roots]))
        for span_id in tree:
            seen, node = set(), span_id
            while tree.get(node) != CLIENT_SPAN:
                if node in seen or tree.get(node) not in tree:
                    raise AssertionError("trace %s: span %s (%s) is not "
                                         "connected" % (trace_id, span_id,
                                                        names[span_id]))
                seen.add(node)
                node = tree[node]
        got = {names[s] for s in tree}
        rids = [e["args"]["rid"] for e in trace["traceEvents"]
                if e["name"] == "serve.submit"
                and e["args"].get("trace_id") == trace_id]
        # a batch call's span is owned by its first traced request; the
        # others join it through its rids attribute
        joined = {e["name"] for e in batch
                  if rids and rids[0] in e["args"].get("rids", ())}
        if not ({"serve.request", "serve.submit", "serve.complete"} <= got
                and len(rids) == 1 and joined & set(ADMIT_SPANS)
                and {"paged.dispatch", "decode.collect"} <= joined):
            raise AssertionError("trace %s: own spans %s, request ids %s, "
                                 "joined through rids %s" % (
                                     trace_id, sorted(got), rids,
                                     sorted(joined)))
    for event in batch:
        tree = trees.get(event["args"]["trace_id"], {})
        if tree.get(event["args"]["span_id"]) not in tree:
            raise AssertionError("%s span %s hangs off no request's tree"
                                 % (event["name"],
                                    event["args"]["span_id"]))
    by_name = {}
    for event in trace["traceEvents"]:
        if event.get("ph") == "X":
            by_name.setdefault(event["name"], []).append(event["dur"])
    print("span trees: %d requests, each one tree from serve.request "
          "through serve.submit to serve.complete, joined through rids to "
          "an admission, paged.dispatch and decode.collect; "
          "median host ms per span: %s" % (len(trace_ids), ", ".join(
              "%s %.3f (%d)" % (name, statistics.median(durs) / 1e3,
                                len(durs))
              for name, durs in sorted(by_name.items()))))


def profiled_burst(params, table, prompts, device, out):
    """One int8 burst inside ``profile_window``: the Chrome trace must
    hold K1's and K2's kernels, every K1 and at least one K2 under a
    ``paged.dispatch`` range (on the card's timeline, or launched inside
    the host range)."""
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize="int8", device=device).start()
    ids = ["%04x%04x" % (0xfeed, i) for i in range(len(prompts))]
    try:
        post(api.port, prompts[0][:min(16, PAGE - 1)], CHUNK)
        with profile_window(os.path.join(out, "profile")) as path:
            burst(api.port, prompts, trace_ids=ids)
            torch.cuda.synchronize()
    finally:
        api.stop()
    if path is None or not os.path.isfile(path):
        raise AssertionError("the profile window wrote no trace")
    with open(path) as fin:
        events = json.load(fin)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "paged_attend" in e["name"]
          and "int8" not in e["name"]]
    k2 = [e for e in kernels if "int8_matmul" in e["name"]]
    gpu_ranges = [e for e in events if e.get("name") == "paged.dispatch"
                  and e.get("cat") == "gpu_user_annotation"]
    cpu_ranges = [e for e in events if e.get("name") == "paged.dispatch"
                  and e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def on_card(kernel):
        return any(r["ts"] <= kernel["ts"] and kernel["ts"] + kernel["dur"]
                   <= r["ts"] + r["dur"] + 1e-3 for r in gpu_ranges)

    def from_host(kernel):
        src = launch.get(kernel.get("args", {}).get("correlation"))
        return src is not None and any(
            r["tid"] == src["tid"] and r["ts"] <= src["ts"]
            <= r["ts"] + r["dur"] for r in cpu_ranges)

    under = {label: [k for k in found if on_card(k) or from_host(k)]
             for label, found in (("K1", k1), ("K2", k2))}
    cats = {}
    for event in events:
        cats[event.get("cat")] = cats.get(event.get("cat"), 0) + 1
    print("profile window: %s (%d events; by category %s); K1 %d kernels, "
          "%d under paged.dispatch (%d on the card's timeline); K2 %d, %d "
          "under paged.dispatch; paged.dispatch ranges %d host, %d card"
          % (os.path.basename(path), len(events), cats, len(k1),
             len(under["K1"]), sum(map(on_card, k1)), len(k2),
             len(under["K2"]), len(cpu_ranges), len(gpu_ranges)))
    if not k1 or not k2:
        raise AssertionError("K1 or K2 missing from the profile")
    if len(under["K1"]) != len(k1) or not under["K2"]:
        raise AssertionError("K1/K2 kernels outside paged.dispatch")


def breaker_black_box(params, table, prompts, device, out):
    """The breaker phase's fault (a ServingChaosMonkey failing one step)
    with every plane on: a ``breaker_trip`` black box that ``python -m
    veles_tpu_torch observe blackbox`` reads with exit 0, holding the
    ``breaker.trip`` note last, the dispatch notes before it and span
    entries."""
    flight = get_flight_recorder()
    dumps = flight.dumps
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize="int8",
                      rebuild_backoff=SMOKE_BACKOFF, device=device).start()
    codes = []
    try:
        post(api.port, prompts[0][:min(16, PAGE - 1)], CHUNK)
        burst_retrying(api.port, prompts, codes)
        api.chaos = ServingChaosMonkey(ServingChaosConfig(
            step_fail=1.0, step_fail_max=1))
        burst_retrying(api.port, prompts, codes)
        trips = api.health.counter("trips")
    finally:
        api.stop()
    if trips != 1 or flight.dumps != dumps + 1:
        raise AssertionError("trips %d, dumps %d" % (trips,
                                                     flight.dumps - dumps))
    path = flight.last_dump_path
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "observe", "blackbox",
         path], cwd=REPO_DIR, env=port_env(), capture_output=True,
        text=True, timeout=300)
    doc = load_dump(path)
    kinds = [e.get("kind") for e in doc["entries"]]
    print("breaker black box: %s, %d entries (%s), %d bytes; blackbox "
          "exit %d; replies %s" % (
              os.path.basename(path), len(kinds), ", ".join(
                  "%s=%d" % (k, kinds.count(k)) for k in sorted(set(kinds))),
              os.path.getsize(path), proc.returncode,
              {c: codes.count(c) for c in sorted(set(codes))}))
    if proc.returncode or "reason: breaker_trip" not in proc.stdout:
        raise AssertionError("blackbox: %s %s" % (proc.stdout[-1000:],
                                                  proc.stderr[-1000:]))
    if doc["reason"] != "breaker_trip" or kinds[-1] != "breaker.trip" \
            or "dispatch" not in kinds or "span" not in kinds:
        raise AssertionError("the black box holds %s" % sorted(set(kinds)))


def observe_cli(device, directory, out):
    """The wide MLP through the CLI with ``--trace-events``, knobs on, one
    epoch: a ``unit.run`` span for every firing of every unit, and K6/K5
    launches as the minibatches require. Beside it, the same run behind a
    SIGTERM handler of its own, killed once its first ``unit.run`` span
    is on disk: a ``sigterm`` black box holding unit spans, and the
    previous handler ran. Returns the traced run's launches."""
    workflow = os.path.join(out, "observe_wide.py")
    with open(workflow, "w") as fout:
        fout.write(OBSERVE_WORKFLOW)

    def args(epochs, events):
        return [workflow, os.path.join(REPO_DIR, "samples",
                                       "mnist784_config.py"),
                "root.common.engine.use_pallas=True",
                "root.common.engine.pallas_epilogue=True",
                "root.mnist784.directory=%r" % directory,
                "root.mnist784.out=%r" % out,
                "root.mnist784.max_epochs=%d" % epochs,
                "root.common.engine.pallas_autotune_cache=%r"
                % root.common.engine.pallas_autotune_cache,
                "--device", device.type, "--seed", "1",
                "--trace-events", events]

    events = os.path.join(out, "cli.jsonl")
    home = os.path.join(out, "home")
    killed = os.path.join(out, "killed.jsonl")
    marker = os.path.join(out, "marker")
    # the run SIGTERM kills starts beside the traced one: it ends after
    # its first span, so the two share only their start-up
    t0 = time.perf_counter()
    victim = subprocess.Popen(
        [sys.executable, "-c", CHAINED_SIGTERM, marker]
        + args(1000, killed),
        cwd=REPO_DIR, env=dict(port_env(), VELES_TPU_HOME=home),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    traced = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch"] + args(1, events),
        cwd=REPO_DIR, env=port_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        while time.perf_counter() - t0 < 300 and victim.poll() is None:
            if os.path.exists(killed) and "unit.run" in open(killed).read():
                break
            time.sleep(0.1)
        victim.send_signal(signal.SIGTERM)
        sigterm_s = time.perf_counter() - t0
        _, err = victim.communicate(timeout=120)
        _, traced_err = traced.communicate(timeout=600)
    finally:
        victim.kill()
        traced.kill()
    wall = time.perf_counter() - t0
    if traced.returncode:
        raise AssertionError("the traced CLI run exited %d:\n%s"
                             % (traced.returncode, traced_err[-4000:]))
    with open(os.path.join(out, "counters.json")) as fin:
        counters = json.load(fin)
    spans = {}
    for line in open(events):
        event = json.loads(line)
        if event.get("name") == "unit.run" and event["etype"] == "end":
            spans[event["unit"]] = spans.get(event["unit"], 0) + 1
    want = a5_cli_launches(counters)
    got = {name: counters[name] for name in want}
    print("traced CLI: the wide MLP, knobs on, 1 epoch, exit 0 in %.1f s; "
          "unit.run spans %s, firings %s; launches %s, required %s"
          % (wall, spans, counters["run_calls"], got, want))
    if spans != counters["run_calls"] or got != want:
        raise AssertionError("the traced CLI run failed its checks")
    proc = victim
    run_dir = os.path.join(home, "run")
    dumps = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    doc = load_dump(os.path.join(run_dir, dumps[0])) if dumps else {}
    entries = doc.get("entries", [])
    print("SIGTERM after the first unit.run span (%.1f s): exit %d, "
          "previous handler %s, black boxes %s (reason %s, %d entries, "
          "unit.run spans %d)" % (
              sigterm_s, proc.returncode,
              os.path.exists(marker), dumps, doc.get("reason"),
              len(entries), sum(e.get("name") == "unit.run"
                                for e in entries)))
    if proc.returncode != 9 or not os.path.exists(marker) \
            or len(dumps) != 1 or doc["reason"] != "sigterm" \
            or not any(e.get("name") == "unit.run" for e in entries):
        raise AssertionError("the SIGTERM black box failed its checks: %s"
                             % err[-3000:])
    return got


class StepLaunches:
    """Counts the K1 and K2 launches inside the paged decode steps (the
    serving module's ``paged_slot_step_many``) and the steps they ran;
    installed by :meth:`install`, zeroed by :meth:`zero`."""

    def __init__(self):
        self.real = serving_mod.paged_slot_step_many
        self.zero()

    def zero(self):
        self.k1 = self.k2 = self.steps = 0

    def __call__(self, *args, **kwargs):
        k1, k2 = paged_attend.launches, int8_matmul.launches
        out = self.real(*args, **kwargs)
        self.k1 += paged_attend.launches - k1
        self.k2 += int8_matmul.launches - k2
        self.steps += args[6]
        return out

    @contextlib.contextmanager
    def install(self):
        serving_mod.paged_slot_step_many = self
        try:
            yield self
        finally:
            serving_mod.paged_slot_step_many = self.real


#: the cost runs after one discarded warm-up run, one each of
#: ``default`` (GenerateAPI.start() as a user runs it: the flight ring
#: on, the registry and the device truth enabled by start(), the tracer
#: off), ``off`` (every plane off) and ``traced`` (the default with the
#: tracer writing spans to the events file): single bursts spread
#: 1.3-1.5x (two each, in ABBA order, until the smoke made room for phase
#: 25; four of ``default`` and ``off`` until phase 24)
COST_ORDER = ("default", "off", "traced")


def cost_planes(setting):
    """A fresh process's planes before a cost run's ``start()``: the
    flight ring on, the rest off until ``start()`` turns the registry and
    the device truth on; the tracer on for ``traced``."""
    planes(False)
    get_flight_recorder().enabled = True
    get_tracer().enabled = setting == "traced"


def observe_cost(params, table, prompts, device):
    """The int8 burst under each setting of :data:`COST_ORDER`, after a
    warm-up run: tokens/s, host ms a chunk and admission ms printed with
    each setting's median, without a gate (host noise); the default runs
    must have left the registry and the device truth on with nothing
    patched, and K1's and K2's launches per decode step must be equal in
    every setting. Returns the runs' launches."""
    launches = dict.fromkeys(COUNTERS, 0)
    rows = []
    steps = StepLaunches()
    with steps.install():
        for setting in ("warm-up",) + COST_ORDER:
            cost_planes(setting)
            # each timed burst starts from a collected heap: a full
            # collection after the profile's and the breaker's big
            # objects otherwise lands in whichever run comes first
            run = serve(params, table, [prompts], "int8", device,
                        on_zero=lambda: (
                            planes(False) if setting == "off" else None,
                            steps.zero(), gc.collect()))
            if setting == "default" and not (
                    get_metrics_registry().enabled
                    and get_compile_tracker().enabled):
                raise AssertionError("start() left the registry or the "
                                     "device truth off")
            for name, n in run["launches"].items():
                launches[name] += n
            if setting == "warm-up":
                continue
            rows.append((setting, len(prompts) * N_TOKENS / run["wall"],
                         1e3 * run["host_s"] / max(run["chunks"], 1),
                         1e3 * run["admit_s"], steps.k1 / steps.steps,
                         steps.k2 / steps.steps))
    planes(True)
    print("observe cost, int8 burst (%s, after a warm-up run): %s" % (
        ", ".join(COST_ORDER), "; ".join(
            "%s %.1f tokens/s, %.3f host ms a chunk, %.3f admission ms, "
            "K1 %.2f and K2 %.2f a decode step" % row for row in rows)))
    print("observe cost medians: %s" % ", ".join(
        "%s %.1f tokens/s" % (setting, statistics.median(
            row[1] for row in rows if row[0] == setting))
        for setting in dict.fromkeys(COST_ORDER)))
    per_step = {row[-2:] for row in rows}
    if per_step != {(float(BLOCKS), float(sum(K2_PER_STEP)))}:
        raise AssertionError("K1/K2 launches a decode step differ between "
                             "the settings: %s" % per_step)
    return launches


def observe_phase(device, prompts):
    """Phase 19: the observe plane on the serving model at full width.
    The paged int8 and int8-KV bursts observed (metrics, spans to a JSONL
    file, exemplars), their span trees exported and checked, an int8
    burst in the profiler window, the breaker's black box, the wide MLP
    traced through the CLI and killed by SIGTERM, and the cost of the
    planes. Returns the launches of its main paths."""
    t0 = time.perf_counter()
    params, table = bf16_model(device)
    launches = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory() as out:
        root.common.dirs.run = os.path.join(out, "run")
        events = os.path.join(out, "events.jsonl")
        enable_event_recording(events)
        planes(True)
        sent = []
        for tier, (quantize, attend) in enumerate(OBSERVE_TIERS):
            got, ids = observed_burst(params, table, prompts, quantize,
                                      attend, device, tier)
            sent += ids
            for name, n in got.items():
                launches[name] += n
        check_span_trees(events, sent, out)
        profiled_burst(params, table, prompts, device, out)
        breaker_black_box(params, table, prompts, device, out)
        for name, n in observe_cost(params, table, prompts,
                                    device).items():
            launches[name] += n
        with tempfile.TemporaryDirectory() as directory:
            mnist_files(directory)
            for name, n in observe_cli(device, directory, out).items():
                launches[name] += n
        get_event_recorder().close()
    print("observe phase: %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 20: the observe plane's serving hooks -------------------------------

#: phase 20's objectives: a ttft the burst meets, a tpot it cannot meet on
#: this host-bound path (0.5 ms a token), and availability
HOOKS_SLO = "ttft_p95_ms=10000,tpot_p95_ms=0.5,availability=0.999"
HOOKS_TENANTS = ("tenant-a", "tenant-b")
#: the metric history's cadence in phase 20 (seconds)
HOOKS_INTERVAL_S = 0.2
#: the waterfall of a paged request, in order
PAGED_WATERFALL = ["staged", "pool_gated", "admitted", "first_token",
                   "resolved"]
#: phase 20's cost runs (``scripts/observe_cost.py``'s settings), after a
#: discarded warm-up run: ``default`` (the planes as ``start()`` leaves
#: them, the history's sampler off), ``ledger_off`` (the ledger and the
#: scope off) and ``history`` (the sampler at its 1 s default), one run
#: each (two in ABBA order until the smoke made room for phase 25, four
#: until phase 24)
HOOKS_COST_ORDER = ("default", "ledger_off", "history")


def lane_positions(lengths):
    """The live positions each request's lanes reach on the lag-1 path: a
    request admitted at prompt length L rides N_TOKENS / CHUNK chunks and
    the one more dispatched before its last chunk is collected, so its
    lane is live to L + m at its m-th step, m = 1 .. N_TOKENS + CHUNK."""
    return [[n + m for m in range(1, N_TOKENS + CHUNK + 1)]
            for n in lengths]


def tile_pad_count(lengths, page):
    """The paged kernels' last-page residual from the request lengths
    alone: ``ceil(p / page) * page - p`` for every live position p."""
    return sum(-(-p // page) * page - p
               for lane in lane_positions(lengths) for p in lane)


def span_overshoot_count(lengths, tile, max_len):
    """The slab's span overshoot of a burst admitted in one dispatch,
    from the request lengths alone: dispatch j attends the tile-rounded
    longest live sequence plus its CHUNK appends; every live lane-step
    attends that span past its own position."""
    total = 0
    for j in range(N_TOKENS // CHUNK + 1):
        top = max(lengths) + CHUNK * j + CHUNK
        span = min(-(-top // tile) * tile, max_len)
        total += sum(max(0, span - (n + CHUNK * j + i)) for n in lengths
                     for i in range(1, CHUNK + 1))
    return total


def kernel_busy_ms(path):
    """The card's busy time in a profile: the union of the kernels'
    intervals, in ms, and the kernel count."""
    with open(path) as fin:
        events = json.load(fin)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3, len(spans)


def hooks_burst(params, table, prompts, device, out):
    """The paged int8 burst (K1 + K2) through HTTP with the serving hooks
    checked: every POST with a trace id and one of two tenants, the SLO
    objectives of :data:`HOOKS_SLO`, a fresh serve scope, the metric
    history at :data:`HOOKS_INTERVAL_S` with a tight rule pair, the burst
    inside the profiler window. Returns the launches, the /debug/serve
    and /debug/history payloads' paths, the slowest incident and the
    processes of the CLI checks it started (still running)."""
    run_dir = os.path.join(out, "run")
    scope = ServeScope()
    real_scope, servescope_mod._serve_scope = (servescope_mod._serve_scope,
                                               scope)
    history = MetricHistory(
        registry=get_metrics_registry(), interval_s=HOOKS_INTERVAL_S,
        incidents=IncidentRecorder(cooldown_s=0.0, directory=run_dir))
    history.rules = [
        # the fault's own series: the ttft window is fed at the first
        # token, the burn only at each resolve
        AnomalyRule("ttft_p95_high", "veles_serving_latency_ms",
                    match={"kind": "ttft", "quantile": "p95"},
                    kind="threshold", op=">=", threshold=1.0,
                    for_samples=1, cooldown_s=600.0),
        AnomalyRule("slo_burn", "veles_slo_burn_rate", kind="threshold",
                    op=">=", threshold=2.0, for_samples=2,
                    cooldown_s=600.0)]
    set_metric_history(history)
    # the waste autopsy's own rules stay out of the pair: their first
    # evaluation waits for more dispatched tokens than a run sends
    min_eval, servescope_mod.MIN_EVAL_TOKENS = (
        servescope_mod.MIN_EVAL_TOKENS, 1 << 62)
    ledger = RequestLedger()
    try:
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          paged=True, page_size=PAGE, quantize="int8",
                          slo=SLOEngine(HOOKS_SLO), ledger=ledger,
                          device=device).start()
    finally:
        servescope_mod._serve_scope = real_scope
    delivered = {}
    collect = api.decoder.collect_chunk

    def counted(dispatched):
        got = collect(dispatched)
        for rid, tokens in got.items():
            if tokens:
                delivered[rid] = delivered.get(rid, 0) + 1
        return got
    api.decoder.collect_chunk = counted
    url = "http://127.0.0.1:%d" % api.port
    ids = ["%04x%04x" % (0x5e1f, i) for i in range(len(prompts))]
    try:
        post(api.port, prompts[0][:min(16, PAGE - 1)], CHUNK)
        torch.cuda.synchronize()
        chunks0 = api.decoder.dispatch_counts["chunk"]
        for fn in COUNTERS.values():
            fn.launches = 0
        streams = [None] * len(prompts)

        def client(i):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(
                    {"tokens": prompts[i], "n_tokens": N_TOKENS}).encode(),
                headers={"X-Veles-Trace": "%s/%s" % (ids[i], CLIENT_SPAN),
                         "X-Veles-Tenant":
                             HOOKS_TENANTS[i % len(HOOKS_TENANTS)]})
            with urllib.request.urlopen(req, timeout=600) as resp:
                streams[i] = json.loads(resp.read().decode())["tokens"]

        with profile_window(os.path.join(out, "hooks_profile")) as trace:
            # the scope's wall from here: the profiler's start-up is no
            # part of the burst
            scope.reset()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the burst's wall: the profiler's export is no part of it
            seconds = dict(scope.seconds)
        launches = counts()
        chunks = api.decoder.dispatch_counts["chunk"] - chunks0
        # the history samples on its own thread: give the burn rule its
        # second breaching sample
        deadline = time.monotonic() + 20 * HOOKS_INTERVAL_S
        while time.monotonic() < deadline and not any(
                r.name == "slo_burn" and r.fired_total for r in
                history.rules):
            time.sleep(HOOKS_INTERVAL_S / 2)

        def fetch(path):
            with urllib.request.urlopen(url + path, timeout=60) as resp:
                return resp.read().decode()
        requests = json.loads(fetch("/debug/requests?n=64"))
        serve_payload = fetch("/debug/serve")
        series = json.loads(fetch("/debug/history?series="
                                  "veles_serving_latency_ms"))
        metrics = fetch("/metrics")
        health = json.loads(fetch("/healthz"))
        serve_path = os.path.join(out, "serve.json")
        with open(serve_path, "w") as fout:
            fout.write(serve_payload)
        incident = next((path for path in sorted(glob.glob(os.path.join(
            run_dir, "incident-*-slo_burn-*.json")))), None)
        clis = {"slo --live": ["slo", "--live", url, "--slowest", "3"],
                "serve-trace": ["serve-trace", serve_path, "-o",
                                os.path.join(out, "serve.trace.json")],
                "incident": ["incident", incident or run_dir]}
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "observe"] + argv,
            cwd=REPO_DIR, env=port_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for name, argv in clis.items()}
        for proc in procs.values():
            proc.wait(timeout=300)
    finally:
        api.stop()
        set_metric_history(None)
        servescope_mod.MIN_EVAL_TOKENS = min_eval
    if any(s is None or len(s) != N_TOKENS for s in streams):
        raise AssertionError("the hooks burst answered %s" % (streams,))
    busy_ms, kernels = kernel_busy_ms(trace)
    print("hooks burst (paged int8, %d requests x %d tokens, traced "
          "tenants %s, in the profiler window): %.3f s, %d chunks; wall by "
          "the serve scope: prefill %.1f ms, decode %.1f ms, host %.1f ms, "
          "idle %.1f ms; the card's kernels %d, busy %.1f ms = %.1f%% of "
          "the burst" % (
              len(prompts), N_TOKENS, "/".join(HOOKS_TENANTS), wall, chunks,
              1e3 * seconds["prefill_compute"],
              1e3 * seconds["decode_compute"], 1e3 * seconds["host"],
              1e3 * seconds["idle"], kernels, busy_ms,
              100.0 * busy_ms / (1e3 * wall)))
    check_hooks_rows(requests, ids, delivered)
    check_slo(metrics, health)
    lengths = [len(p) for p in prompts]
    check_scope(scope, lengths, chunks, paged=True,
                tile_pad=tile_pad_count(lengths, PAGE))
    check_history(history, series, incident)
    check_hooks_clis(procs, json.loads(serve_payload),
                     os.path.join(out, "serve.trace.json"))
    steps = chunks * CHUNK
    if launches["paged_attend"] < BLOCKS * steps \
            or launches["int8_matmul"] < sum(K2_PER_STEP) * steps:
        raise AssertionError("the hooks burst launched %s over %d steps"
                             % (launches, steps))
    return launches


def check_hooks_rows(requests, ids, delivered):
    """Every row of the burst: the whole paged waterfall, its tenant and
    trace id, live dispatches equal to the decoder's count for its
    request (its admission and each chunk collected with its tokens),
    chunk tokens adding up to N_TOKENS."""
    rows = {row["trace"]: row for row in requests["slowest"]
            if row.get("trace") in ids}
    if sorted(rows) != sorted(ids) or requests["inflight"]:
        raise AssertionError("/debug/requests rows %s, in flight %d"
                             % (sorted(rows), len(requests["inflight"])))
    for i, trace in enumerate(ids):
        row = rows[trace]
        stages = [stage for stage, _ in row["stages"]]
        want = {"stages": PAGED_WATERFALL,
                "tenant": HOOKS_TENANTS[i % len(HOOKS_TENANTS)],
                "live": 1 + delivered.get(row["rid"], -1),
                "tokens": N_TOKENS, "aot": 0, "outcome": "completed"}
        got = {"stages": stages, "tenant": row["tenant"],
               "live": row["dispatches"]["live"],
               "tokens": sum(chunk[1] for chunk in row["chunks"]),
               "aot": row["dispatches"]["aot"], "outcome": row["outcome"]}
        if got != want:
            raise AssertionError("row %s: %s, want %s" % (trace, got, want))
    walls = sorted(row["wall_ms"] for row in rows.values())
    print("ledger: %d rows, each %s, tenants %s, live dispatches %s, wall "
          "%.1f-%.1f ms" % (
              len(rows), "->".join(PAGED_WATERFALL),
              sorted({row["tenant"] for row in rows.values()}),
              sorted(row["dispatches"]["live"] for row in rows.values()),
              walls[0], walls[-1]))


def check_slo(metrics, health):
    """The SLO gauges carry both tenants' slices, the unmeetable tpot
    objective burns, availability holds at 1.0."""
    def aggregate(name, objective):
        (value,) = [v for labels, v, _ in samples(metrics, name)
                    if labels == {"objective": objective, "window": "60s"}]
        return value

    burn = aggregate("veles_slo_burn_rate", "tpot_p95_ms")
    available = [v for labels, v, _ in samples(metrics,
                                              "veles_slo_objective_ratio")
                 if labels.get("objective") == "availability"]
    tenants = {labels.get("tenant") for labels, _, _ in
               samples(metrics, "veles_slo_burn_rate")} - {None}
    ttft = aggregate("veles_slo_objective_ratio", "ttft_p95_ms")
    print("SLO: tpot burn %.3f (60s), ttft ratio %.3f, availability %s, "
          "tenant slices %s; /healthz slo %s" % (
              burn, ttft, sorted(set(available)), sorted(tenants),
              health.get("slo")))
    if not burn > 0 or set(available) != {1.0} \
            or tenants != set(HOOKS_TENANTS):
        raise AssertionError("SLO gauges: burn %r, availability %r, "
                             "tenants %r" % (burn, available, tenants))


def check_scope(scope, lengths, chunks, paged, tile_pad=0, overshoot=0):
    """The scope's tallies against the independent counts: ``tile_pad``
    (pool) or ``span_overshoot`` (slab) from the request lengths,
    ``dead_slot`` the empty lane-steps of the chunks dispatched, useful
    decode tokens the tokens delivered, ``discard`` the lag-1 tails, no
    ``group_dup`` and no page overshoot."""
    live = len(lengths) * (N_TOKENS + CHUNK)
    want = {"tile_pad": tile_pad, "span_overshoot": overshoot,
            "dead_slot": chunks * SLOTS * CHUNK - live,
            "discard": live - len(lengths) * N_TOKENS,
            "group_dup": 0, "page_overshoot": 0}
    got = {cause: scope.waste[cause] for cause in want}
    useful = scope.useful["decode"]
    print("serve scope (%s): waste %s, useful %s, goodput %.4f, occupancy "
          "%.4f; independent counts %s" % (
              "paged" if paged else "dense", dict(scope.waste),
              dict(scope.useful), scope.goodput_summary()["fraction"],
              scope.occupancy()["fraction"], want))
    if got != want or useful != len(lengths) * N_TOKENS:
        raise AssertionError("scope %s, useful %d; want %s, %d" % (
            got, useful, want, len(lengths) * N_TOKENS))


def check_history(history, series, incident):
    """The history's latency series served on ``/debug/history``, and an
    incident whose leading indicator is ``veles_serving_latency_ms``
    against the ``slo_burn`` reference."""
    if not series["series"] or {row["name"] for row in series["series"]} \
            != {"veles_serving_latency_ms"}:
        raise AssertionError("/debug/history?series=: %s"
                             % [row["name"] for row in series["series"]])
    if incident is None:
        raise AssertionError("no slo_burn incident: rules %s"
                             % [r.state() for r in history.rules])
    with open(incident) as fin:
        doc = json.load(fin)
    lead = doc["leading_indicator"]
    print("history: %d samples at %.1f s, %d series, %d anomalies; "
          "incident %s: leading %s (%s) led %s by %.0f ms" % (
              history.samples_total, history.interval_s,
              series["series_count"], history.anomalies_total,
              os.path.basename(incident), lead["rule"], lead["series"],
              lead["reference"], lead["lead_ms"]))
    if lead["series"] != "veles_serving_latency_ms" \
            or lead["reference"] != "slo_burn":
        raise AssertionError("the leading indicator is %s" % lead)


def check_hooks_clis(procs, payload, trace_path):
    """``observe slo --live``, ``observe serve-trace`` and ``observe
    incident`` exit 0; the serve trace holds one thread row per slot the
    burst used."""
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        print("observe %s: exit %d, %d lines" % (
            name, proc.returncode, len(stdout.splitlines())))
        if proc.returncode:
            raise AssertionError("observe %s: %s %s" % (
                name, stdout[-1000:], stderr[-1000:]))
    with open(trace_path) as fin:
        events = json.load(fin)["traceEvents"]
    (slots_pid,) = [e["pid"] for e in events if e.get("ph") == "M"
                    and e["name"] == "process_name"
                    and e["args"]["name"].startswith("slots")]
    rows = {e["tid"] for e in events if e.get("ph") == "M"
            and e["name"] == "thread_name" and e["pid"] == slots_pid}
    used = {entry["slot"] for entry in payload["slots"]}
    print("serve trace: %d events, %d slot rows (slots used %s)"
          % (len(events), len(rows), sorted(used)))
    if rows != used:
        raise AssertionError("slot rows %s, slots used %s" % (rows, used))


def dense_hooks(params, table, prompts, device):
    """The dense int8-KV slab (K4 + K2) driven directly: every prompt
    submitted, so one dispatch admits them all; the scope's span
    overshoot and the rest against the independent counts. Returns the
    launches."""
    scope = ServeScope()
    real_scope, servescope_mod._serve_scope = (servescope_mod._serve_scope,
                                               scope)
    try:
        dec = ContinuousDecoder(params, table, HEADS, slots=SLOTS,
                                max_len=MAX_LEN, n_tokens=N_TOKENS,
                                quantize="int8-kv", device=device)
    finally:
        servescope_mod._serve_scope = real_scope
    dec.submit(prompts[0][:min(16, PAGE - 1)], CHUNK)
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    scope.reset()
    for fn in COUNTERS.values():
        fn.launches = 0
    chunks0 = dec.dispatch_counts["chunk"]
    for prompt in prompts:
        dec.submit(prompt)
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    launches = counts()
    chunks = dec.dispatch_counts["chunk"] - chunks0
    lengths = [len(p) for p in prompts]
    check_scope(scope, lengths, chunks, paged=False,
                overshoot=span_overshoot_count(lengths, dec.tile,
                                               dec.max_len))
    steps = chunks * CHUNK
    if launches["int8_cache_attend"] < BLOCKS * steps \
            or launches["int8_matmul"] < sum(K2_PER_STEP) * steps:
        raise AssertionError("the dense hooks run launched %s over %d "
                             "steps" % (launches, steps))
    return launches


def int8_param_bytes():
    """The int8 serving weights from the widths: each block's four int8
    products (12 E^2 bytes) with their f32 column scales (9 E), its bf16
    biases and norms (13 E); the int8 head (E V) with its scales (V);
    the final norm (2 E, bf16) and the bf16 embedding table (V E)."""
    e, v = EMBED, VOCAB
    return (BLOCKS * (12 * e * e + 4 * 9 * e + 2 * 13 * e)
            + e * v + 4 * v + 2 * 2 * e + 2 * v * e)


def memscope_child(out):
    """Phase 20's memscope checks, run in a fresh process so that the
    allocator holds only this server: the paged int8 server's owners
    against counts from the widths, the untagged residue, a breaker trip
    and rebuild and a hot swap with no verdict, and a second trip while a
    reference holds the old pool and its state: a verdict naming
    ``kv_pool`` and a black box that ``observe blackbox`` reads (the
    kernels load from the parent's build). Prints one JSON line; returns
    the exit code."""
    device = torch.device("cuda")
    root.common.dirs.run = os.path.join(out, "run")
    params, table = bf16_model(device)
    params_b = init_transformer_params(numpy.random.RandomState(SWAP_SEED),
                                       BLOCKS, EMBED, HEADS, VOCAB,
                                       dtype=torch.bfloat16, device=device)
    with open(os.path.join(out, "prompts.json")) as fin:
        prompts = json.load(fin)
    scope = get_memscope()
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize="int8",
                      rebuild_backoff=SMOKE_BACKOFF, device=device).start()

    def trip():
        rebuilds = api.health.counter("rebuilds")
        api.request_trip("memscope drill")
        deadline = time.monotonic() + 120
        while api.health.counter("rebuilds") == rebuilds:
            if time.monotonic() > deadline:
                raise AssertionError("no rebuild after the trip")
            time.sleep(0.01)
        return scope.edges[-1]

    try:
        post(api.port, prompts[0][:min(16, PAGE - 1)], CHUNK)
        burst(api.port, prompts)
        torch.cuda.synchronize()
        owners = scope.attribute()
        snap = scope.snapshot()
        pages = default_pool_pages(SLOTS, MAX_LEN, PAGE, chunk=N_TOKENS)
        want = {"params": int8_param_bytes(),
                "kv_pool": 2 * BLOCKS * pages * PAGE * EMBED * 2,
                "decode_state": SLOTS * (4 + 4 * VOCAB + 4 + 8)}
        clean = trip()
        api.swap_params(params_b, version="b")
        # the swap answers its caller before its edge closes
        deadline = time.monotonic() + 60
        while scope.edges[-1]["edge"] != "swap_params":
            if time.monotonic() > deadline:
                raise AssertionError("the swap's edge never closed")
            time.sleep(0.01)
        swap = scope.edges[-1]
        burst(api.port, prompts)
        planted = (api.decoder.pool, api.decoder.state)
        leak = trip()
        deadline = time.monotonic() + 60
        while not any(v.get("artifact") for v in scope.incidents):
            if time.monotonic() > deadline:
                raise AssertionError("no leak artifact")
            time.sleep(0.05)
        artifact = next(v["artifact"] for v in scope.incidents
                        if v.get("artifact"))
        planted_bytes = paged_kv_bytes(planted[1])
        del planted
    finally:
        api.stop()
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", "observe", "blackbox",
         artifact], cwd=REPO_DIR, env=port_env(), capture_output=True,
        text=True, timeout=300)
    doc = load_dump(artifact)
    result = {
        "owners": {k: owners.get(k, 0) for k in want},
        "want": want, "device_bytes": snap["device_bytes"],
        "tagged_bytes": snap["tagged_bytes"],
        "untagged": snap["owners"]["untagged"],
        "all_owners": snap["owners"],
        "edges": [(v["edge"], v["leak"], v["owner"]) for v in
                  (clean, swap, leak)],
        "leak_grew": leak["grew_bytes"], "planted_bytes": planted_bytes,
        "artifact": os.path.basename(artifact),
        "artifact_memscope": "memscope" in doc,
        "blackbox_exit": proc.returncode,
        "blackbox_named": "memscope_leak_kv_pool" in proc.stdout}
    print(json.dumps(result))
    return 0


def memscope_phase(out, prompts):
    """Run :func:`memscope_child` in a fresh process on ``prompts`` and
    check its reading."""
    with open(os.path.join(out, "prompts.json"), "w") as fout:
        json.dump(prompts, fout)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.memscope_child(sys.argv[1]))", out],
        cwd=REPO_DIR, env=port_env(), capture_output=True, text=True,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        raise AssertionError("memscope child: exit %d\n%s\n%s" % (
            proc.returncode, proc.stdout[-3000:], proc.stderr[-3000:]))
    got = json.loads(lines[-1])
    print("memscope (a fresh process): owners %s, from the widths %s; "
          "device %d bytes in use, tagged %d, untagged %d (%.1f MB); "
          "edges %s; the planted pool grew kv_pool by %d bytes (its pages "
          "%d); black box %s (memscope section %s), blackbox exit %d" % (
              got["owners"], got["want"], got["device_bytes"],
              got["tagged_bytes"], got["untagged"], got["untagged"] / 1e6,
              got["edges"], got["leak_grew"], got["planted_bytes"],
              got["artifact"], got["artifact_memscope"],
              got["blackbox_exit"]))
    print("memscope owners: %s" % got["all_owners"])
    if got["owners"] != got["want"]:
        raise AssertionError("owners %s != the widths' %s"
                             % (got["owners"], got["want"]))
    if got["untagged"] != max(0, got["device_bytes"] - got["tagged_bytes"]):
        raise AssertionError("untagged is not the residue")
    if [e[1] for e in got["edges"]] != [False, False, True] \
            or got["edges"][2][2] != "kv_pool" \
            or got["leak_grew"] != got["planted_bytes"]:
        raise AssertionError("edges %s" % got["edges"])
    if got["blackbox_exit"] or not got["blackbox_named"] \
            or not got["artifact_memscope"]:
        raise AssertionError("the leak's black box: %s" % got)


def hooks_cost_planes(setting):
    """A cost run's planes before its ``start()``: as
    ``scripts/observe_cost.py`` sets them (the flight ring, the ledger and
    the scope on, the registry and the device truth turned on by
    ``start()``, the tracer off), the ledger and scope off for
    ``ledger_off``, and the metric history at its 1 s default for
    ``history`` (None otherwise: the front starts no sampler)."""
    planes(False)
    get_flight_recorder().enabled = True
    serving_hooks(setting != "ledger_off")
    set_metric_history(MetricHistory.from_config(
        registry=get_metrics_registry()) if setting == "history" else None)


def hooks_cost(params, table, prompts, device):
    """The int8 burst under each setting of :data:`HOOKS_COST_ORDER`
    after a warm-up run: tokens/s and host ms a chunk with each setting's
    median, no gate; K1 4 and K2 17 launches a decode step in every run.
    Returns the runs' launches."""
    launches = dict.fromkeys(COUNTERS, 0)
    rows = []
    steps = StepLaunches()
    with steps.install():
        for setting in ("warm-up",) + HOOKS_COST_ORDER:
            hooks_cost_planes("default" if setting == "warm-up"
                              else setting)
            run = serve(params, table, [prompts], "int8", device,
                        on_zero=lambda: (steps.zero(), gc.collect()))
            for name, n in run["launches"].items():
                launches[name] += n
            if setting == "warm-up":
                continue
            rows.append((setting, len(prompts) * N_TOKENS / run["wall"],
                         1e3 * run["host_s"] / max(run["chunks"], 1),
                         steps.k1 / steps.steps, steps.k2 / steps.steps))
    planes(True)
    serving_hooks(True)
    set_metric_history(None)
    print("hooks cost, int8 burst (%s, after a warm-up run): %s" % (
        ", ".join(HOOKS_COST_ORDER), "; ".join(
            "%s %.1f tokens/s, %.3f host ms a chunk, K1 %.2f and K2 %.2f "
            "a decode step" % row for row in rows)))
    print("hooks cost medians: %s" % ", ".join(
        "%s %.1f tokens/s" % (setting, statistics.median(
            row[1] for row in rows if row[0] == setting))
        for setting in dict.fromkeys(HOOKS_COST_ORDER)))
    per_step = {row[-2:] for row in rows}
    if per_step != {(float(BLOCKS), float(sum(K2_PER_STEP)))}:
        raise AssertionError("K1/K2 launches a decode step differ between "
                             "the settings: %s" % per_step)
    return launches


def hooks_phase(device, prompts):
    """Phase 20: the observe plane's serving hooks on the serving model
    at full width: the request ledger, the SLO engine, the serve scope,
    the metric history and their CLIs on the paged int8 burst; the scope
    on the dense int8-KV slab; memscope in a fresh process; the hooks'
    cost. Returns the launches of its main paths."""
    t0 = time.perf_counter()
    params, table = bf16_model(device)
    launches = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory() as out:
        root.common.dirs.run = os.path.join(out, "run")
        for phase in (hooks_burst(params, table, prompts, device, out),
                      dense_hooks(params, table, prompts, device)):
            for name, n in phase.items():
                launches[name] += n
        memscope_phase(out, prompts)
        for name, n in hooks_cost(params, table, prompts, device).items():
            launches[name] += n
    print("hooks phase: %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 21: what acts on the hooks (ROADMAP A7 (c)) -----------------------

#: phase 21's prompts: shorter than a page, so no admission is a prefix
#: hit or tail and every stream compares with a single cold admission
ACT_PROMPT_LENS = (48, 80, 112)
#: the tier ladder: a ttft objective the fronts meet (single requests,
#: 50-100 ms on this host-bound path) and a held latency ramp well above
#: the host's noise (a chunk's enqueue reads 23-45 ms) that breaks it;
#: the cooldown at least the short window, or a swap's own stall burns
#: the objective again and the ladder oscillates
LADDER_SLO = {"ttft_p95_ms": 250.0}
LADDER_WINDOWS, LADDER_BUCKET_S = (2.0, 8.0), 0.25
LADDER_COOLDOWN_S = 3.0
LADDER_RAMP_MS = 300.0
LADDER_MOVES = [("demote", "int8"), ("demote", "int8-kv"),
                ("promote", "int8"), ("promote", "bf16")]
#: the kernels each rung must launch, and must not
RUNG_KERNELS = {"bf16": ({"paged_attend"},
                         {"int8_matmul", "paged_attend_int8"}),
                "int8": ({"paged_attend", "int8_matmul"},
                         {"paged_attend_int8"}),
                "int8-kv": ({"paged_attend_int8", "int8_matmul"},
                            {"paged_attend"})}
#: the pressure front: a flood of nine tenths of the pool past pool_high
#: and a bound the flood halves; a prompt of 990 tokens wants more pages
#: than the flood leaves
PRESSURE_MAX_QUEUE, PRESSURE_FLOOD, PRESSURE_BIG = 8, 0.9, 990
#: the rollout: the first rung's fraction, and the green ramp's peak (a
#: green TTFT of two stalled passes against blue's 50-100 ms)
ROLLOUT_STEPS = (0.3, 1.0)
GREEN_RAMP_MS = 400.0
#: record, replay, capacity: the recorded requests (four times the slots,
#: so a high warp queues them: 16 did not breach up to x64), the front's
#: objective, and the escalation (x2, x8, x32, x64 at most, then two
#: bisections of the cliff; x1 until the smoke made room for phase 24:
#: the replay above runs the trace at x1 already)
CAPACITY_REQUESTS = 32
CAPACITY_SLO = "ttft_p95_ms=300"
CAPACITY_WARPS = ("2", "4", "64", "2")
ACT_TENANTS = ("tenant-alpha", "tenant-beta")


def hash_point(tenant):
    """A tenant's fixed point in [0, 1) (``rollout.routes_green``)."""
    return (zlib.crc32(tenant.encode()) % 10000) / 10000.0


def act_post(port, tokens, trace=None, tenant=None):
    """One POST that returns (code, tokens or None, headers) for any
    status."""
    headers = {"Content-Type": "application/json"}
    if trace is not None:
        headers["X-Veles-Trace"] = "%s/%s" % (trace, CLIENT_SPAN)
    if tenant is not None:
        headers["X-Veles-Tenant"] = tenant
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port, data=json.dumps(
            {"tokens": tokens, "n_tokens": N_TOKENS}).encode(),
        headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return (resp.status, json.loads(resp.read().decode())["tokens"],
                    dict(resp.headers))
    except urllib.error.HTTPError as err:
        err.read()
        return err.code, None, dict(err.headers)


def fixed_tier_streams(params, table, prompts, quantize, paged, device):
    """Each prompt alone through a decoder fixed at ``quantize`` (the
    served requests are admitted one at a time too, so the batches
    match); the launches are not counted."""
    before = counts()
    decoder = ContinuousDecoder(params, table, HEADS, slots=SLOTS,
                                max_len=MAX_LEN, n_tokens=N_TOKENS,
                                quantize=quantize, paged=paged,
                                page_size=PAGE, device=device)
    streams = []
    for prompt in prompts:
        rid = decoder.submit(prompt)
        decoder.run_until_drained(chunk=CHUNK)
        streams.append(decoder.results.pop(rid))
    for name, fn in COUNTERS.items():
        fn.launches = before[name]
    return streams


def wait_for(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError("timed out waiting for %s" % what)
        time.sleep(0.01)


def ladder_phase(device, params, table, prompts):
    """The tier ladder on the paged front at bf16: a held latency ramp
    burns ``ttft_p95_ms``; the governor demotes bf16 -> int8 -> int8-kv
    while it holds, and after ``clear_ramp`` and a trickle of requests
    promotes back, one move per cooldown window at most. Requests go one
    at a time: every answer 200, every ledger row's quant the tier that
    served it (the demoted ones with their stage), every stream equal to
    a fixed-tier decoder's, each rung's launches on its kernels. Returns
    the launches."""
    governor = ServingGovernor(GovernorConfig(
        demote_burn=2.0, recover_burn=1.0, cooldown_s=LADDER_COOLDOWN_S,
        interval_s=0.05, ladder=("int8", "int8-kv"), breaker_guard=False,
        prewarm=False))
    monkey = ServingChaosMonkey(ServingChaosConfig(
        latency_ramp_ms=LADDER_RAMP_MS, latency_ramp_steps=2,
        latency_ramp_hold=1 << 30))
    ledger = RequestLedger()
    tracker = get_compile_tracker()
    builds0 = dict(tracker.snapshot()["compiles"])
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, ledger=ledger, governor=governor,
                      chaos=monkey, slo=SLOEngine(
                          LADDER_SLO, windows=LADDER_WINDOWS,
                          bucket_seconds=LADDER_BUCKET_S),
                      device=device).start()
    for fn in COUNTERS.values():
        fn.launches = 0
    rungs = [("bf16", counts())]
    apply_tier = api._apply_tier

    def counted_apply(tier):
        # the old decoder drained: what launches from here on (the new
        # decoder's probe first) is the new rung's
        rungs.append((tier, counts()))
        return apply_tier(tier)
    api._apply_tier = counted_apply
    sent = []

    def send():
        index = len(sent)
        trace = "%016x" % (0xac7000 + index)
        code, tokens, _ = act_post(api.port, prompts[index % len(prompts)],
                                   trace=trace)
        sent.append((trace, index % len(prompts), code, tokens))
    t0 = time.perf_counter()
    try:
        deadline = time.monotonic() + 90
        while api.decoder.quantize != "int8-kv" \
                and time.monotonic() < deadline:
            send()
        if api.decoder.quantize != "int8-kv":
            raise AssertionError("the ladder never reached int8-kv: %s"
                                 % governor.snapshot())
        for _ in range(2):   # the bottom rung holds under the ramp
            send()
        monkey.clear_ramp()
        cleared = time.monotonic()
        while (governor.level or api.decoder.quantize is not None) \
                and time.monotonic() < deadline + 60:
            send()
            time.sleep(0.05)
        send()
    finally:
        api.stop()
    wall = time.perf_counter() - t0
    rungs.append(("end", counts()))
    builds = dict(tracker.snapshot()["compiles"])
    if builds != builds0:
        print("kernel builds during the ladder: before %s, after %s"
              % (builds0, builds))
    moves = [t for t in governor.transitions
             if t["action"] in ("demote", "promote")]
    if [(t["action"], t["tier"]) for t in moves] != LADDER_MOVES:
        raise AssertionError("the ladder moved %s" % [
            (t["action"], t["tier"], t["reason"]) for t in moves])
    for a, b in zip(moves, moves[1:]):
        if b["mono"] - a["mono"] < LADDER_COOLDOWN_S:
            raise AssertionError("two moves inside one cooldown: %s, %s"
                                 % (a, b))
    codes = [code for _, _, code, _ in sent]
    if set(codes) != {200}:
        raise AssertionError("the ladder answered %s" % codes)
    want = {tier: fixed_tier_streams(
        params, table, prompts, None if tier == "bf16" else tier, True,
        device) for tier in ("bf16", "int8", "int8-kv")}
    rows = {row["trace"]: row for row in ledger.slowest(1024)}
    served = collections.Counter()
    for trace, index, _, tokens in sent:
        row = rows[trace]
        tier = row["quant"]
        served[tier] += 1
        if tokens != want[tier][index]:
            raise AssertionError("request %s at %s: %s != the fixed-tier "
                                 "decoder's %s" % (trace, tier, tokens,
                                                   want[tier][index]))
        stages = [stage for stage, _ in row["stages"]]
        if tier != "bf16" and ("demoted" not in stages
                               or row.get("tier") != tier):
            raise AssertionError("demoted row %s: %s" % (trace, row))
    if set(served) != set(RUNG_KERNELS):
        raise AssertionError("tiers served: %s" % dict(served))
    launches = dict.fromkeys(COUNTERS, 0)
    segments = []
    for (tier, start), (_, end) in zip(rungs, rungs[1:]):
        got = {name: end[name] - start[name] for name in COUNTERS}
        must, must_not = RUNG_KERNELS[tier]
        if any(got[name] <= 0 for name in must) \
                or any(got[name] for name in must_not) \
                or got["int8_cache_attend"]:
            raise AssertionError("the %s rung launched %s" % (tier, got))
        segments.append("%s K1 %d K2 %d K3 %d" % (
            tier, got["paged_attend"], got["int8_matmul"],
            got["paged_attend_int8"]))
        for name, n in got.items():
            launches[name] += n
    first, last = moves[0], moves[-1]
    print("tier ladder (paged front, bf16 base, ramp %.0f ms held, "
          "ttft_p95_ms %.0f over %s s windows, cooldown %.1f s): %d "
          "requests in %.1f s, all 200, served %s; demote to recover %.3f "
          "s (first demotion to last promotion; the ramp cleared %.3f s "
          "before the last promotion); moves %s" % (
              LADDER_RAMP_MS, LADDER_SLO["ttft_p95_ms"], LADDER_WINDOWS,
              LADDER_COOLDOWN_S, len(sent), wall, dict(served),
              last["mono"] - first["mono"], last["mono"] - cleared,
              ["%s %s burn %.3g" % (t["action"], t["tier"], t["burn"])
               for t in moves]))
    print("tier swaps (drained, built and probed at the new tier): %s" % (
        "; ".join("%s: drain %.3f s, build %.3f s, probe %.3f s, swap "
                  "%.3f s" % (swap["tier"], swap["drain_s"],
                              swap["build_s"], swap["probe_s"],
                              swap["swap_s"]) for swap in api.tier_swaps)))
    print("ladder launches by rung: %s" % "; ".join(segments))
    return launches


def pressure_phase(device, params, table, prompts):
    """Pressure and price on the paged front at bf16: a flood of
    :data:`PRESSURE_FLOOD` of the pool past ``pool_high`` halves the
    admission limit; a prompt wanting more pages than the flood leaves,
    and a burst past the halved bound, get 429s, each with an integer
    Retry-After in [1, 60] (the pool's page-release price and the
    governor's); nothing answers 5xx; the release brings the bound back.
    Returns the launches."""
    governor = ServingGovernor(GovernorConfig(
        demote_burn=1e9, cooldown_s=0.5, interval_s=0.02, pool_high=0.85,
        min_admit=2, breaker_guard=False, prewarm=False))
    pages = default_pool_pages(SLOTS, MAX_LEN, PAGE, chunk=N_TOKENS)
    flood = int(PRESSURE_FLOOD * pages)
    monkey = ServingChaosMonkey(ServingChaosConfig(
        pool_flood_pages=flood, pool_flood_at=2, pool_flood_steps=1 << 30))
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, max_queue=PRESSURE_MAX_QUEUE,
                      ledger=RequestLedger(), governor=governor,
                      chaos=monkey, device=device).start()
    for fn in COUNTERS.values():
        fn.launches = 0
    replies = []
    try:
        deadline = time.monotonic() + 60
        while "flood_start" not in monkey.stamps \
                and time.monotonic() < deadline:
            replies.append(act_post(api.port, prompts[0]))
        wait_for(lambda: (replies.append(act_post(api.port, prompts[1])),
                          api.effective_max_queue
                          == PRESSURE_MAX_QUEUE // 2)[1], 30,
                 "the halved admission bound")
        big = numpy.random.RandomState(5).randint(
            0, VOCAB, PRESSURE_BIG).tolist()
        big_reply = act_post(api.port, big)
        replies.append(big_reply)
        burst_replies = [None] * (2 * SLOTS)

        def client(i):
            burst_replies[i] = act_post(api.port, prompts[i % len(prompts)])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(burst_replies))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(600)
        replies.extend(burst_replies)
        price, health_price = governor.retry_price, \
            api.health.retry_after_s()
        monkey.release_flood()
        wait_for(lambda: (replies.append(act_post(api.port, prompts[2])),
                          api.effective_max_queue == PRESSURE_MAX_QUEUE)[1],
                 30, "the bound back")
        launches = counts()
    finally:
        monkey.release_flood()
        api.stop()
    codes = collections.Counter(code for code, _, _ in replies)
    rejected = [headers for code, _, headers in replies if code == 429]
    if big_reply[0] != 429 or len(rejected) < 2 \
            or set(codes) - {200, 429}:
        raise AssertionError("pressure replies %s (the big prompt %d)"
                             % (dict(codes), big_reply[0]))
    prices = [headers.get("Retry-After") for headers in rejected]
    if not all(p is not None and p.isdigit() and 1 <= int(p) <= 60
               for p in prices):
        raise AssertionError("Retry-After headers %s" % prices)
    if health_price != price:
        raise AssertionError("the health prices %s, the governor %s"
                             % (health_price, price))
    if governor.counters["admit_resizes"] < 2:
        raise AssertionError("admission resizes %s" % governor.counters)
    print("pressure (paged front, %d pages, flood %d = %.1f%% past "
          "pool_high 0.85): admission bound %d -> %d -> %d, %d replies "
          "%s, Retry-After %s s (governor price %.3f s)" % (
              pages, flood, 100.0 * flood / pages, PRESSURE_MAX_QUEUE,
              PRESSURE_MAX_QUEUE // 2, PRESSURE_MAX_QUEUE, len(replies),
              dict(codes), sorted(set(prices), key=int), price))
    return launches


def guard_phase(device, params, table, prompts):
    """The breaker guard on the paged front at bf16: the device-memory
    fraction the guard reads is below ``guard_memory_frac`` before the
    storm (so the guard cannot trip on its own), then ``compile_storm_at``
    books a rebuild storm; the governor trips the breaker once, the
    front rebuilds and is ready again, and the streams after the heal
    equal those before it. Returns the launches."""
    governor = ServingGovernor(GovernorConfig(
        demote_burn=1e9, cooldown_s=5.0, interval_s=0.02,
        breaker_guard=True, prewarm=False))
    monkey = ServingChaosMonkey(ServingChaosConfig(compile_storm_at=30))
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, ledger=RequestLedger(),
                      governor=governor, chaos=monkey,
                      rebuild_backoff=SMOKE_BACKOFF, device=device).start()
    for fn in COUNTERS.values():
        fn.launches = 0
    codes = collections.Counter()
    try:
        frac = ServingGovernor._device_memory_frac()
        if frac is None or frac >= governor.config.guard_memory_frac:
            raise AssertionError("device memory fraction %s" % frac)
        before = []
        for prompt in prompts:
            code, tokens, _ = act_post(api.port, prompt)
            codes[code] += 1
            before.append(tokens)
        deadline = time.monotonic() + 60
        while not governor.counters["guard_trips"] \
                and time.monotonic() < deadline:
            codes[act_post(api.port, prompts[0])[0]] += 1
        trip_at = time.monotonic()
        wait_for(lambda: api.health.counter("rebuilds") >= 1, 60,
                 "the rebuild")
        wait_for(lambda: api.health.ready, 60, "ready")
        healed = time.monotonic() - trip_at
        after = []
        for prompt in prompts:
            code, tokens, _ = act_post(api.port, prompt)
            codes[code] += 1
            after.append(tokens)
        launches = counts()
    finally:
        api.stop()
    if governor.counters["guard_trips"] != 1 \
            or monkey.counters["compile_storms"] != 1 \
            or not any(t["action"] == "guard_trip" and "storm" in t["reason"]
                       for t in governor.transitions):
        raise AssertionError("the guard: %s, chaos %s" % (
            governor.snapshot(), monkey.counters))
    if after != before or any(t is None for t in before):
        raise AssertionError("streams after the heal differ: %s vs %s"
                             % (after, before))
    if set(codes) - {200, 503}:
        raise AssertionError("guard replies %s" % dict(codes))
    print("breaker guard (paged front): device memory at %.4f of the "
          "card before the storm (guard at %.2f); the storm tripped the "
          "breaker once, ready again %.3f s after the trip (rebuild %s), "
          "replies %s, streams after the heal equal" % (
              frac, governor.config.guard_memory_frac, healed,
              {k: round(v, 4) for k, v in api.last_rebuild.items()},
              dict(codes)))
    return launches


def rollout_phase(device, params, table, prompts, run_dir):
    """Blue-green on the dense slab at int8-kv (K4 + K2), candidate
    weights from :data:`SWAP_SEED`, a blue and a green tenant picked by
    hash point, requests one at a time: a clean rollout reaches
    ``promoted`` with every blue stream bit-equal to a run with no deploy
    and every green stream equal to a decoder's on the new weights, and
    the ``rollout_promote`` memscope edge gives no verdict; a green ramp
    reaches ``rolled_back`` with nothing shed and an incident led by
    ``veles_ctrl_deploy_ttft_ms``. Returns the launches."""
    rng = numpy.random.RandomState(SWAP_SEED)
    params2 = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                      dtype=torch.bfloat16, device=device)
    tenants = ["tenant-%d" % i for i in range(1000)]
    green_t = next(t for t in tenants if hash_point(t) < ROLLOUT_STEPS[0])
    blue_t = next(t for t in tenants if hash_point(t) >= ROLLOUT_STEPS[0])
    want = {"blue": fixed_tier_streams(params, table, prompts, "int8-kv",
                                       False, device),
            "green": fixed_tier_streams(params2, table, prompts,
                                        "int8-kv", False, device)}
    launches = dict.fromkeys(COUNTERS, 0)
    walls = {}
    for label in ("clean", "bad"):
        bad = label == "bad"
        history = None
        if bad:
            history = MetricHistory(
                registry=get_metrics_registry(), interval_s=0.2,
                incidents=IncidentRecorder(cooldown_s=0.0,
                                           directory=run_dir))
            set_metric_history(history)
            min_eval, servescope_mod.MIN_EVAL_TOKENS = (
                servescope_mod.MIN_EVAL_TOKENS, 1 << 62)
        chaos = ServingChaosMonkey(ServingChaosConfig(
            deploy_green_ramp_ms=GREEN_RAMP_MS,
            deploy_green_ramp_steps=2)) if bad else None
        ledger = RequestLedger()
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          quantize="int8-kv", ledger=ledger, chaos=chaos,
                          device=device).start()
        for fn in COUNTERS.values():
            fn.launches = 0
        sent = []
        ends = {}
        try:
            act_post(api.port, prompts[0][:16])
            config = RolloutConfig(
                steps=ROLLOUT_STEPS, hold_s=30.0 if bad else 0.5,
                cooldown_s=30.0 if bad else 0.5, window_s=20.0,
                min_requests=2, interval_s=0.05,
                ttft_ratio=1.5 if bad else 5.0)
            began = time.perf_counter()
            rollout = api.begin_rollout(params2, version="v2",
                                        config=config)
            for name in ("finish_promote", "finish_rollback"):
                real = getattr(rollout, name)
                setattr(rollout, name, lambda api, real=real, name=name: (
                    ends.__setitem__(name, time.perf_counter()),
                    real(api=api))[1])
            terminal = "rolled_back" if bad else "promoted"
            deadline = time.monotonic() + 90
            while rollout.state != terminal \
                    and time.monotonic() < deadline:
                for tenant in (blue_t, green_t):
                    index = len(sent) % len(prompts)
                    trace = "%016x" % (0x9e11 + len(sent))
                    code, tokens, _ = act_post(api.port, prompts[index],
                                               trace=trace, tenant=tenant)
                    sent.append((trace, index, code, tokens))
            if rollout.state != terminal:
                raise AssertionError("the %s rollout stayed %s: %s" % (
                    label, rollout.state, rollout.snapshot()))
            if not bad:
                wait_for(lambda: any(v["edge"] == "rollout_promote"
                                     for v in get_memscope().edges), 30,
                         "the rollout_promote edge")
                verdict = [v for v in get_memscope().edges
                           if v["edge"] == "rollout_promote"][-1]
                if verdict["leak"]:
                    raise AssertionError("rollout_promote verdict %s"
                                         % verdict)
                for index in range(len(prompts)):
                    trace = "%016x" % (0x9e11 + len(sent))
                    code, tokens, _ = act_post(api.port, prompts[index],
                                               trace=trace, tenant=blue_t)
                    sent.append((trace, index, code, tokens))
            health = api.health.snapshot()
        finally:
            api.stop()
            if bad:
                set_metric_history(None)
                servescope_mod.MIN_EVAL_TOKENS = min_eval
        got = counts()
        if got["int8_cache_attend"] <= 0 or got["int8_matmul"] <= 0 \
                or got["paged_attend"] or got["paged_attend_int8"]:
            raise AssertionError("the %s rollout launched %s"
                                 % (label, got))
        for name, n in got.items():
            launches[name] += n
        rows = {row["trace"]: row for row in ledger.slowest(1024)}
        roles = collections.Counter()
        for trace, index, code, tokens in sent:
            row = rows[trace]
            # without a role: served after the rollback (blue's weights)
            # or after the promotion (green's)
            role = row.get("deploy") or ("rolled_back" if bad
                                         else "promoted")
            roles[role] += 1
            expect = want["blue" if role in ("blue", "rolled_back")
                          else "green"][index]
            if code != 200 or tokens != expect:
                raise AssertionError("%s rollout, %s request %s: %s %s, "
                                     "want %s" % (label, role, trace,
                                                  code, tokens, expect))
        if health["counters"].get("shed", 0) \
                or not roles["blue"] or not roles["green"]:
            raise AssertionError("%s rollout: roles %s, counters %s" % (
                label, dict(roles), health["counters"]))
        end = ends.get("finish_rollback" if bad else "finish_promote")
        walls[label] = end - began
        if bad:
            incidents = sorted(glob.glob(os.path.join(
                run_dir, "incident-*-deploy_green_ttft-*.json")))
            if not incidents:
                raise AssertionError("no deploy_green_ttft incident in %s"
                                     % os.listdir(run_dir))
            with open(incidents[-1]) as fin:
                leading = json.load(fin)["leading_indicator"]
            if leading.get("series") != "veles_ctrl_deploy_ttft_ms":
                raise AssertionError("the incident led with %s" % leading)
            print("bad green (ramp %.0f ms on green steps, ttft_ratio 1.5): "
                  "begin to rolled_back %.3f s, %s; requests %s, nothing "
                  "shed; incident led by %s" % (
                      GREEN_RAMP_MS, walls[label], rollout.reason,
                      dict(roles), leading["series"]))
        else:
            print("clean rollout (dense slab int8-kv, steps %s, blue %s at "
                  "%.4f, green %s at %.4f): begin to promoted %.3f s (the "
                  "green build and probe %.3f s of it); requests %s, blue "
                  "streams bit-equal to no deploy, green equal to the new "
                  "weights; rollout_promote edge: no verdict" % (
                      ROLLOUT_STEPS, blue_t, hash_point(blue_t), green_t,
                      hash_point(green_t), walls[label],
                      api.last_rebuild["build_s"]
                      + api.last_rebuild["probe_s"], dict(roles)))
    return launches


def capacity_phase(device, params, table, prompts, out):
    """Record, replay, capacity and regress on the paged int8 front (K1 +
    K2) with two tenants: ``observe record --live`` writes a trace with no
    raw tenant bytes and a sidecar that verifies; ``observe replay`` at
    warp 1 delivers every token; ``observe capacity`` writes a
    ``veles-capacity-report``; ``observe regress`` passes it against
    itself and fails a copy with ``capacity_sustained_tokens_per_sec``
    cut by 15%, naming the key. Returns the launches."""
    from veles_tpu_torch.observe.capacity import write_capacity_report
    from veles_tpu_torch.observe.regress import sha256_of
    from veles_tpu_torch.observe.replay import load_trace
    from veles_tpu_torch.observe.trace_export import main as observe_main

    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, quantize="int8",
                      ledger=RequestLedger(), slo=SLOEngine(CAPACITY_SLO),
                      device=device).start()
    base = "http://127.0.0.1:%d" % api.port
    trace = os.path.join(out, "act.trace.jsonl")
    report = os.path.join(out, "act.capacity.json")

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = observe_main(argv)
        return code, buf.getvalue()
    for fn in COUNTERS.values():
        fn.launches = 0
    try:
        for i in range(CAPACITY_REQUESTS):
            code, _, _ = act_post(api.port, prompts[i % len(prompts)],
                                  tenant=ACT_TENANTS[i % 2])
            if code != 200:
                raise AssertionError("recording request %d: %d" % (i, code))
        code, text = cli(["record", "--live", base, "-o", trace])
        raw = open(trace, "rb").read()
        if code or any(t.encode() in raw for t in ACT_TENANTS) \
                or open(trace + ".sha256").read().split()[0] \
                != sha256_of(trace):
            raise AssertionError("record: %d %s" % (code, text))
        header, rows = load_trace(trace)
        code, text = cli(["replay", trace, "--live", base, "--warp", "1",
                          "--vocab", str(VOCAB), "--workers", "16"])
        summary = json.loads(text[text.index("{"):])
        if code or summary["delivered_ratio"] != 1.0:
            raise AssertionError("replay: %d %s" % (code, summary))
        t0 = time.perf_counter()
        code, text = cli(["capacity", trace, "--live", base, "-o", report,
                          "--start-warp", CAPACITY_WARPS[0], "--warp-step",
                          CAPACITY_WARPS[1], "--max-warp", CAPACITY_WARPS[2],
                          "--refine-steps", CAPACITY_WARPS[3],
                          "--vocab", str(VOCAB),
                          "--workers", "16"])
        capacity_s = time.perf_counter() - t0
        launches = counts()
    finally:
        api.stop()
    doc = json.loads(open(report).read())
    if code or doc["kind"] != "veles-capacity-report" \
            or open(report + ".sha256").read().split()[0] \
            != sha256_of(report):
        raise AssertionError("capacity: %d %s" % (code, text))
    keys = doc["keys"]
    sustained = keys["capacity_sustained_tokens_per_sec"]
    if sustained <= 0:
        raise AssertionError("nothing sustained: %s" % doc["escalation"])
    code_same, _ = cli(["regress", report, report])
    cut = dict(doc, keys=dict(keys, capacity_sustained_tokens_per_sec=(
        0.85 * sustained)))
    worse = os.path.join(out, "act.capacity.cut.json")
    write_capacity_report(cut, worse)
    code_cut, text_cut = cli(["regress", report, worse])
    if code_same != 0 or code_cut != 1 \
            or "capacity_sustained_tokens_per_sec" not in text_cut:
        raise AssertionError("regress: %d, %d %s" % (code_same, code_cut,
                                                     text_cut))
    breach = doc.get("breach") or {}
    print("record, replay, capacity (paged int8 front, %s, %d requests of "
          "2 tenants): trace of %d rows over %.3f s, lossy %s; replay at "
          "x1 delivered %.3f, schedule skew p95 %.3f ms, %.1f tokens/s; "
          "capacity in %.1f s over warps %s: sustains %.1f tokens/s at "
          "x%.2f, cliff at x%.2f, first breaching series %s (%s), dominant "
          "waste %s; regress exits 0 on itself and 1 at -15%%" % (
              CAPACITY_SLO, CAPACITY_REQUESTS, header["count"],
              header["span_s"], header["lossy"],
              summary["delivered_ratio"], summary["schedule_skew_ms_p95"],
              summary["tokens_per_sec"], capacity_s,
              [e["warp"] for e in doc["escalation"]], sustained,
              keys["capacity_sustained_warp_x"],
              keys["capacity_cliff_warp_x"],
              breach.get("first_breaching_series"),
              (breach.get("detail") or {}).get("objective"),
              breach.get("dominant_waste_cause")))
    return launches


def act_phase(device, prompts):
    """Phase 21: what acts on the observe plane's hooks on the serving
    model at full width: the tier ladder, pressure and price, the
    rollout, the breaker guard, and record, replay, capacity and
    regress. Returns the launches of its main paths."""
    t0 = time.perf_counter()
    params, table = bf16_model(device)
    short = [prompt[:n] for prompt, n in zip(prompts, ACT_PROMPT_LENS)]
    launches = dict.fromkeys(COUNTERS, 0)
    with tempfile.TemporaryDirectory() as out:
        run_dir = os.path.join(out, "run")
        os.makedirs(run_dir)
        root.common.dirs.run = run_dir
        for phase in (
                lambda: ladder_phase(device, params, table, short),
                lambda: pressure_phase(device, params, table, short),
                lambda: rollout_phase(device, params, table, short,
                                      run_dir),
                lambda: guard_phase(device, params, table, short),
                lambda: capacity_phase(device, params, table, short, out)):
            started = time.perf_counter()
            for name, n in phase().items():
                launches[name] += n
            print("  (%.1f s)" % (time.perf_counter() - started))
    print("act phase: %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 22: the data-parallel mesh and the dashboards ---------------------

#: phase 22: the wide MLP (784 -> 4096 tanh -> 10) over the bench data,
#: minibatch 4096, knobs on, at precision level 2 (K5 and K6 on f32
#: operands, so that two runs differ only by the order of the gradient
#: sum), DP_EPOCHS epochs; DP_RANKS processes share the one card over
#: gloo (NCCL takes one rank per device), 2048 rows a rank. The single
#: run steps the same global minibatches from the same weights: its
#: per-epoch n_err must be the world's, each weight within DP_ATOL
DP_RANKS, DP_EPOCHS, DP_ATOL = 2, 3, 1e-4
#: the world's deadline, seconds
DP_DEADLINE = 300
#: the reduce tiers on the card at world size 1 over NCCL: f32 and bf16
#: are a sum of one term (the input and its bf16 rounding, bit for bit);
#: int8 quantizes twice, and the codes may move by one where a quotient
#: rounds otherwise on the card, so the bound is one second-stage step
DP_TIERS = ("f32", "bf16", "int8")
#: the workflow each rank runs through ``python -m veles_tpu_torch
#: --mesh data=2 --coordinator ...``: JAX-free numpy weights put into the
#: units, every epoch's validation errors recorded, the reduces timed; it
#: writes its weights, launches, minibatches and timings, and rank 0 hosts
#: a WebStatusServer its launcher's StatusNotifier pushes to, whose page,
#: state and /metrics it saves; then each rank tries the three reduce
#: tiers on a CUDA tensor over gloo and says which ran
DP_WORKFLOW = '''"""The data-parallel wide MLP (chip_smoke.py phase 22)."""

import json
import os
import time
import urllib.request

import numpy
import torch

from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core.config import root
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.parallel import mapreduce
from veles_tpu_torch.web_status import WebStatusServer

root.dp.update({"out": None, "epochs": 3, "lr": 0.03,
               "lengths": [0, 10000, 50000]})


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(load, main):
    cfg = root.dp
    rank = torch.distributed.get_rank()
    data = numpy.load(os.path.join(cfg.out, "data.npy"), mmap_mode="r")
    labels = numpy.load(os.path.join(cfg.out, "labels.npy"))
    wf, _ = load(MLPWorkflow, name="wide-dp", layers=(4096, 10),
                 loader_kwargs=dict(data=numpy.asarray(data), labels=labels,
                                    class_lengths=list(cfg.lengths),
                                    minibatch_size=4096,
                                    normalization_type="linear"),
                 learning_rate=cfg.lr, max_epochs=cfg.epochs)
    unit_params_from_jax(wf, list(numpy.load(
        os.path.join(cfg.out, "init.npy"), allow_pickle=True)))
    epochs = []
    summary = wf.decision._epoch_summary

    def stamped(stats, epoch):
        epochs.append((time.perf_counter(), int(stats[1][0])))
        summary(stats, epoch)
    wf.decision._epoch_summary = stamped
    real, spent = mapreduce.reduce_sum, [0.0, 0]

    def timed(*args, **kwargs):
        synchronize(wf.device)
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        synchronize(wf.device)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out
    mapreduce.reduce_sum = timed
    server = None
    if rank == 0:
        server = WebStatusServer(port=0, host="127.0.0.1").start()
        root.common.web.update({"enabled": True, "host": "127.0.0.1",
                                "port": server.port,
                                "notification_interval": 0.2})
    t0 = time.perf_counter()
    main()
    synchronize(wf.device)
    wall = time.perf_counter() - t0
    mapreduce.reduce_sum = real
    out = {"rank": rank, "epochs": [n for _, n in epochs],
           "stamps": [t for t, _ in epochs], "wall": wall,
           "reduce_s": spent[0], "reduces": spent[1],
           "dense_epilogue": gemm.dense_epilogue.launches,
           "blocked_matmul": gemm.blocked_matmul.launches,
           "minibatches": list(wf.fused_tick.minibatch_counts),
           "sharded": wf.fused_tick.mesh is not None,
           "device": str(wf.device)}
    numpy.save(os.path.join(cfg.out, "weights%d.npy" % rank),
               numpy.array([(f.weights.data.cpu().numpy(),
                             f.bias.data.cpu().numpy())
                            for f in wf.forwards], dtype=object))
    if server is not None:
        base = "http://127.0.0.1:%d" % server.port
        for _ in range(100):
            if server.statuses():
                break
            time.sleep(0.1)
        for name, path in (("page", "/"), ("state", "/service"),
                           ("metrics", "/metrics")):
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                out[name] = resp.read().decode()
        server.stop()
    tiers = {}
    x = torch.randn(4099, device=wf.device, generator=torch.Generator(
        device=wf.device).manual_seed(rank))
    for precision in ("f32", "bf16", "int8"):
        try:
            got = mapreduce.reduce_sum({"x": x}, precision=precision)["x"]
            tiers[precision] = "ran (%s)" % got.device
        except Exception as exc:
            tiers[precision] = "raised %s: %s" % (type(exc).__name__,
                                                   str(exc)[:200])
    out["tiers"] = tiers
    with open(os.path.join(cfg.out, "rank%d.json" % rank), "w") as fout:
        json.dump(out, fout)
'''


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_weights(rng):
    """The wide MLP's initial weights drawn with numpy (phase 8's
    rule)."""
    weights, fan_in = [], 784
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    return weights


def dp_world(device, out):
    """Start DP_RANKS ``python -m veles_tpu_torch --mesh data=2`` ranks
    on DP_WORKFLOW over gloo on the one card; wait DP_DEADLINE at most,
    killing them all on expiry. Returns each rank's record and the
    world's wall seconds."""
    workflow = os.path.join(out, "wide_dp.py")
    with open(workflow, "w") as fout:
        fout.write(DP_WORKFLOW)
    coordinator = "127.0.0.1:%d" % free_port()
    # the overrides follow the config file, the flags come after them
    argv = [sys.executable, "-m", "veles_tpu_torch", workflow, "-",
            "root.common.mesh.backend=gloo",
            "root.common.engine.use_pallas=True",
            "root.common.engine.pallas_epilogue=True",
            "root.common.engine.precision_level=2",
            "root.common.engine.pallas_autotune_cache=%r"
            % root.common.engine.pallas_autotune_cache,
            "root.dp.out=%r" % out, "root.dp.epochs=%d" % DP_EPOCHS,
            "root.dp.lr=%r" % TRAIN_LR,
            "root.dp.lengths=%r" % list(BENCH_CLASS_LENGTHS),
            "--device", device.type, "--mesh", "data=%d" % DP_RANKS,
            "--coordinator", coordinator, "--num-processes",
            str(DP_RANKS), "--seed", "default=1234,loader=1234"]
    logs = [open(os.path.join(out, "rank%d.log" % rank), "w+")
            for rank in range(DP_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--process-id", str(rank)],
                              cwd=REPO_DIR, env=port_env(), stdout=log,
                              stderr=subprocess.STDOUT)
             for rank, log in enumerate(logs)]
    try:
        for proc in procs:
            proc.wait(timeout=max(DP_DEADLINE - (time.perf_counter() - t0),
                                  1))
    except subprocess.TimeoutExpired:
        raise AssertionError("the %d-rank world passed its %d s deadline"
                             % (DP_RANKS, DP_DEADLINE))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode:
            raise AssertionError("rank %d exited %d:\n%s"
                                 % (rank, proc.returncode, text[-4000:]))
    ranks = []
    for rank in range(DP_RANKS):
        with open(os.path.join(out, "rank%d.json" % rank)) as fin:
            record = json.load(fin)
        record["weights"] = numpy.load(
            os.path.join(out, "weights%d.npy" % rank), allow_pickle=True)
        ranks.append(record)
    return ranks, wall


def dp_single(device, data, labels, weights):
    """The single-process run of the same global minibatches from the
    same weights and seeds: (per-epoch n_err, weights, launches, images/s
    as bench.py reads it)."""
    wf = build_mlp(device, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                   BENCH_CLASS_LENGTHS, True, DP_EPOCHS, precision_level=2,
                   weights=weights)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    stamps = [e["t"] for e in epochs]
    rate = len(data) * (len(stamps) - 1) / (stamps[-1] - stamps[0])
    return ([e["valid_n_err"] for e in epochs],
            [(f.weights.data.cpu().numpy(), f.bias.data.cpu().numpy())
             for f in wf.forwards], got, rate, wall)


def dp_web_checks(record):
    """Phase 22 (c): the page, the state and /metrics of rank 0's
    WebStatusServer, pushed to by its launcher's StatusNotifier."""
    state = json.loads(record["state"])
    status = next(iter(state.values()), {})
    metrics = record["metrics"]
    steps = re.search(r'veles_fleet_reduce_steps_total\{precision="f32"\} '
                      r'(\S+)', metrics)
    wire = re.search(r'veles_fleet_reduce_bytes_total\{precision="f32"\} '
                     r'(\S+)', metrics)
    checks = {
        "page names the run": "wide-dp" in record["page"],
        "page shows the mesh": "mesh data2" in record["page"],
        "state: standalone": status.get("mode") == "standalone",
        "state: mesh data2": (status.get("device") or {}).get("mesh")
        == "data2",
        "state: graph": bool((status.get("graph") or {}).get("nodes")),
        "metrics: data axis 2":
            'veles_mesh_axis_size{axis="data"} 2' in metrics,
        "metrics: 2 devices": "veles_mesh_devices 2" in metrics,
        "metrics: reduce steps": bool(steps and float(steps.group(1)) > 0),
        "metrics: reduce bytes": bool(wire and float(wire.group(1)) > 0)}
    print("  web status over rank 0: %s; reduce plane %s steps, %s bytes"
          % (", ".join("%s %s" % (k, "ok" if v else "FAILED")
                       for k, v in checks.items()),
             steps.group(1) if steps else "-", wire.group(1) if wire
             else "-"))
    if not all(checks.values()):
        raise AssertionError("the web status over the world failed")


def dp_nccl_tiers(device):
    """Phase 22 (b): a world of one over NCCL in this process: the three
    reduce tiers on CUDA tensors at the wide MLP's gradient shapes
    against their plain versions on the same inputs (DP_TIERS)."""
    from veles_tpu_torch.parallel import mapreduce
    from veles_tpu_torch.parallel.mesh import (build_mesh,
                                               finalize_distributed,
                                               initialize_distributed)
    initialize_distributed("127.0.0.1:%d" % free_port(), 1, 0,
                           device="cuda", timeout=120)
    try:
        mesh = build_mesh()
        assert torch.distributed.get_backend() == "nccl"
        gen = torch.Generator(device=device).manual_seed(22)
        tree = [{"w": torch.randn((784, 4096), generator=gen,
                                  device=device) * 1e-3,
                 "b": torch.randn(4096, generator=gen, device=device)},
                {"w": torch.randn((4096, 10), generator=gen,
                                  device=device),
                 "b": torch.randn(10, generator=gen, device=device)},
                torch.tensor(9, dtype=torch.int32, device=device)]
        leaves = [tree[0]["w"], tree[0]["b"], tree[1]["w"], tree[1]["b"]]
        report = []
        for precision in DP_TIERS:
            got = mapreduce.reduce_sum(tree, precision=precision,
                                       group=mesh.group)
            outs = [got[0]["w"], got[0]["b"], got[1]["w"], got[1]["b"]]
            worst = 0.0
            for x, y in zip(leaves, outs):
                ref = x.cpu()
                if precision == "bf16":
                    ref = ref.bfloat16().float()
                elif precision == "int8":
                    scale = ref.abs().max().clamp(min=1e-30) / 127.0
                    ref = torch.clamp(torch.round(ref / scale), -127,
                                      127).to(torch.int32).float() * scale
                    scale2 = ref.abs().max().clamp(min=1e-30) / 127.0
                    step = scale2.item()
                    ref = torch.clamp(torch.round(ref / scale2), -127,
                                      127).float() * scale2
                err = (y.cpu() - ref).abs().max().item()
                bound = step if precision == "int8" else 0.0
                if not (y.is_cuda and err <= bound):
                    raise AssertionError(
                        "reduce_sum %s over NCCL: max abs err %g past %g"
                        % (precision, err, bound))
                worst = max(worst, err)
            if int(got[2].item()) != 9:
                raise AssertionError("the integer leaf changed")
            report.append("%s max abs err %.3g" % (precision, worst))
        print("  NCCL world of 1 (%s): reduce_sum on CUDA tensors at the "
              "wide MLP's gradient shapes: %s"
              % (mesh, "; ".join(report)))
    finally:
        finalize_distributed()


def dp_plotting():
    """Phase 22 (d): where matplotlib is missing a plotter and a
    rendering GraphicsServer raise naming it; where it is present a plot
    renders."""
    import importlib.util
    from veles_tpu_torch import plotting
    if importlib.util.find_spec("matplotlib") is None:
        for make in (lambda: plotting.AccumulatingPlotter(DummyWorkflow()),
                     lambda: plotting.GraphicsServer()):
            try:
                make()
            except ImportError as exc:
                if "matplotlib" not in str(exc):
                    raise
                message = str(exc)
            else:
                raise AssertionError("a plotter was made without "
                                     "matplotlib")
        print("  plotting without matplotlib raises: %s" % message)
        return
    with tempfile.TemporaryDirectory() as out:
        server = plotting.GraphicsServer(directory=out)
        plot = plotting.AccumulatingPlotter(DummyWorkflow(), name="dp")
        plot.values = [3.0, 2.0, 1.0]
        server.enqueue(plot)
        done = server.flush(timeout=120)
        server.shutdown()
        if not done or "dp" not in server.rendered:
            raise AssertionError("matplotlib is here but nothing rendered")
        print("  matplotlib present: a plot rendered to %s"
              % os.path.basename(server.rendered["dp"]))


def mesh_phase(device):
    """Phase 22: (a) the data-parallel tick of the wide MLP at full width
    through the CLI's --mesh, DP_RANKS ranks on the card over gloo,
    against the single run; (b) the reduce tiers over NCCL; (c) the web
    status over (a); (d) plotting. Returns (a)'s launches, both ranks'."""
    t0 = time.perf_counter()
    data, labels = bench_dataset()
    weights = dp_weights(numpy.random.RandomState(22))
    with tempfile.TemporaryDirectory() as out:
        numpy.save(os.path.join(out, "data.npy"), data)
        numpy.save(os.path.join(out, "labels.npy"), labels)
        numpy.save(os.path.join(out, "init.npy"),
                   numpy.array(weights, dtype=object))
        ranks, world_wall = dp_world(device, out)
    n_err, single_w, single_got, single_rate, _ = dp_single(
        device, data, labels, weights)
    launches = dict.fromkeys(COUNTERS, 0)
    w_diff = 0.0
    for record in ranks:
        got = {name: record[name] for name in ("dense_epilogue",
                                                "blocked_matmul")}
        for name, n in got.items():
            launches[name] += n
        stamps = record["stamps"]
        rate = len(data) * (len(stamps) - 1) / (stamps[-1] - stamps[0])
        for (tw, tb), (sw, sb) in zip(record["weights"], single_w):
            w_diff = max(w_diff, numpy.abs(tw - sw).max(),
                         numpy.abs(tb - sb).max())
        print("  rank %d of %d (%s, gloo): validation n_err %s (single "
              "run %s); images/s %.1f (the single run %.1f; bench reading, "
              "mean of %d epoch intervals); all-reduce %.3f s of the run's "
              "%.3f s (%.1f%%, %d reduces, the card synchronised around "
              "each); minibatches (test, valid, train) %s; launches %s "
              "(the single run %s); reduce tiers on a CUDA tensor over "
              "gloo: %s"
              % (record["rank"], DP_RANKS, record["device"],
                 record["epochs"], n_err, rate, single_rate,
                 len(stamps) - 1, record["reduce_s"], record["wall"],
                 100 * record["reduce_s"] / record["wall"],
                 record["reduces"], record["minibatches"], got,
                 {k: single_got[k] for k in got}, record["tiers"]))
        if record["epochs"] != n_err or not record["sharded"] \
                or any(got[k] != single_got[k] for k in got) \
                or not all(got.values()) \
                or not record["tiers"]["f32"].startswith("ran"):
            raise AssertionError("rank %d disagrees with the single run"
                                 % record["rank"])
    print("  the world's weights against the single run's: max abs diff "
          "%.3g (tolerance %.0e); world wall %.1f s"
          % (w_diff, DP_ATOL, world_wall))
    if not w_diff <= DP_ATOL:
        raise AssertionError("the world's weights left the single run's")
    dp_web_checks(ranks[0])
    dp_nccl_tiers(device)
    dp_plotting()
    print("mesh phase: %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 23: the training fleet (ROADMAP A9 (a)) ----------------------------

#: phase 23 (a) and (d): the wide MLP of phase 22 (784 -> 4096 tanh -> 10,
#: minibatch 4096, knobs on, level 2) on its data and epochs, through a
#: ``python -m veles_tpu_torch -l`` master and one ``-m`` slave sharing
#: the card, against one process from the same numpy weights: every
#: epoch's validation n_err equal, every weight and velocity within
#: FLEET_ATOL (phase 22's DP_ATOL)
FLEET_ATOL = DP_ATOL
#: (b) and (c): the digits of tests/test_fleet.py's ``_kw(max_epochs=4)``
#: (layers (16, 10), 297 valid / 1500 train, minibatch 300, lr 0.5,
#: seeds 42 and 43). (b)'s master serves no job before both its slaves
#: are connected (the stream is shorter than the spread of two
#: processes' start-up), the second slave's first job waits for
#: FLEET_STAGGER updates of the first (one epoch), and the first then
#: waits for the second's first two answers. An even interleaving from
#: the first job loses every other update to the overwrite merge: from
#: the port's initial weights its best n_err passed the bound in 4 of 8
#: CPU trials and read 83 once on the card (from the JAX package's
#: weights the port reads JAX's 44-75); staggered, 16 CPU trials read
#: 41-75. Its bound is the JAX test's (tests/test_fleet.py:356-358).
#: (c)'s jobs are stretched by FLEET_SLOW_MS (the chaos slow-job fault at
#: probability 1), so that the run has a middle to kill its slave in
FLEET_DIGITS = {"layers": [16, 10], "lengths": [0, 297, 1500],
                "minibatch": 300, "lr": 0.5, "epochs": 4}
FLEET_SLOW_MS, FLEET_DIGITS_BOUND, FLEET_STAGGER = 100, 80, 6
#: (c)'s epochs: 2 (4, and jobs stretched by 300 ms, until the smoke made
#: room for phase 24; it now runs beside phase 24's (b) and (c))
FLEET_RESPAWN_EPOCHS = 2
#: (c): the slave is killed in the job after this many (it then holds
#: the job's lease)
FLEET_KILL_AFTER = 3
#: each part's deadline, seconds: every process it started is killed
FLEET_DEADLINE = 240
#: a per-job frame with no weights is far under this (the wide MLP's
#: weights are ~13 MB)
FLEET_SMALL_FRAME = 64 << 10
#: the workflow every fleet process runs (master and slaves alike, so the
#: checksum, the fleet's default secret, agrees). It records what its
#: role sees and writes it to ``<out>/<tag>-<role>-<pid>.json`` at the
#: end: the master its per-epoch validation n_err, each update's merge
#: time on the card, the updates per slave (also appended to
#: ``<out>/<tag>-progress.jsonl`` as they land), its ledger, respawns and
#: final weights; a slave its jobs' images and wall, its kernel launches,
#: its frames' bytes by type, whether they went through /dev/shm, the
#: seconds spent encoding, sending, waiting and decoding, and its final
#: weights and velocities
FLEET_WORKFLOW = '''"""The training fleet (chip_smoke.py phase 23)."""

import asyncio
import collections
import json
import os
import time

import numpy
import torch

from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core.config import root
from veles_tpu_torch.fleet import client as fleet_client
from veles_tpu_torch.fleet import protocol
from veles_tpu_torch.fleet.respawn import RespawnManager
from veles_tpu_torch.fleet.server import Server
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.parity import read_digits

root.fl.update({"out": None, "tag": "a", "data": "bench", "init": None,
               "hold_for": 1, "stagger": 0, "cadence": "sweep"})


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(record, key, fn):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record[key] += time.perf_counter() - t0
    return wrapper


def timed_async(record, key, fn):
    async def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return await fn(*args, **kwargs)
        finally:
            record[key] += time.perf_counter() - t0
    return wrapper


def hold_first_job(count, stagger=0):
    """Serve no job before ``count`` slaves are connected (once they
    were, serve on whoever stays). With ``stagger``, the first slave
    served runs alone until the master has taken ``stagger`` updates (or
    it left); then the others get their jobs and the first slave waits
    until each has answered two (or left): a fresh process's first eval job and first train
    job load their kernels (3.6 s on the card, where a digits job takes
    milliseconds), and the first slave must not run epochs ahead
    meanwhile."""
    serve, released, seen = Server._serve_job, [], []

    def waiting(self, slave):
        if not stagger or self._stopped.is_set():
            return False
        if slave.id != seen[0]:
            return seen[0] in self.slaves \
                and self.ledger.snapshot()["done"] < stagger
        return self.ledger.snapshot()["done"] >= stagger and any(
            getattr(self.slaves.get(sid), "jobs_done", 2) < 2
            for sid in seen[1:])

    async def held(self, slave, writer):
        while not released and len(self.slaves) < count \
                and not self._stopped.is_set():
            await asyncio.sleep(0.02)
        released.append(True)
        if slave.id not in seen:
            seen.append(slave.id)
        while waiting(self, slave):
            await asyncio.sleep(0.005)
        await serve(self, slave, writer)
    Server._serve_job = held


def instrument_master(wf, cfg, record):
    if cfg.hold_for > 1:
        hold_first_job(cfg.hold_for, cfg.stagger)
    progress = os.path.join(cfg.out, "%s-progress.jsonl" % cfg.tag)
    apply = wf.apply_data_from_slave
    jobs = collections.Counter()

    def merged(data, slave=None):
        t0 = time.perf_counter()
        out = apply(data, slave)
        synchronize(wf.device)
        record["merge_ms"].append((time.perf_counter() - t0) * 1e3)
        jobs[slave.id] += 1
        record["slaves"][slave.id] = {"pid": slave.pid,
                                      "updates": jobs[slave.id]}
        with open(progress, "a") as fout:
            fout.write(json.dumps({"sid": slave.id, "pid": slave.pid,
                                   "n": jobs[slave.id]}) + "\\n")
        return out
    wf.apply_data_from_slave = merged
    spawn = RespawnManager._spawn

    def spawned(self, *args):
        record["respawns"] += 1
        return spawn(self, *args)
    RespawnManager._spawn = spawned
    summary = wf.decision._epoch_summary

    def stamped(stats, epoch):
        record["epochs"].append(int(stats[1][0]))
        summary(stats, epoch)
    wf.decision._epoch_summary = stamped


def instrument_slave(wf, cfg, record):
    sent, got = record["sent"], record["got"]
    serialize, deserialize = protocol._serialize, protocol._deserialize

    def measured_out(message):
        payload, codec = serialize(message)
        if "type" in message:
            sent.setdefault(message["type"], []).append(len(payload))
        return payload, codec

    def measured_in(payload, codec):
        message = deserialize(payload, codec)
        if isinstance(message, dict) and "type" in message:
            got.setdefault(message["type"], []).append(len(payload))
        return message
    protocol._serialize, protocol._deserialize = measured_out, measured_in
    protocol.encode_frame = timed(record, "encode_s", protocol.encode_frame)
    fleet_client.write_frame = timed_async(record, "write_s",
                                           fleet_client.write_frame)
    fleet_client.read_frame = timed_async(record, "read_s",
                                          fleet_client.read_frame)
    asyncio.StreamReader.readexactly = timed_async(
        record, "wait_s", asyncio.StreamReader.readexactly)
    do_job = wf.do_job

    started = os.path.join(cfg.out, "%s-started.jsonl" % cfg.tag)
    jobs = []

    def job(data, callback=None):
        if callback is None:
            # a pod follower: its waits and jobs are in its own stats
            return do_job(data)
        t0 = time.perf_counter()
        # this slave holds the job's lease until its update: a kill rule
        # reading these rows kills it while it holds one
        jobs.append(t0)
        with open(started, "a") as fout:
            fout.write(json.dumps({"pid": os.getpid(),
                                   "n": len(jobs)}) + "\\n")

        def done(update):
            synchronize(wf.device)
            t1 = time.perf_counter()
            record["job_s"] += t1 - t0
            record["first"] = record["first"] or t0
            record["last"] = t1
            record["images"] += int(wf.loader.minibatch_valid_size)
            callback(update)
        do_job(data, done)
    wf.do_job = job


def run(load, main):
    cfg = root.fl
    if cfg.data == "digits":
        data, labels = read_digits()
        data, labels = data.astype(numpy.float32), labels.astype(numpy.int32)
    else:
        data = numpy.load(os.path.join(cfg.out, "data.npy"))
        labels = numpy.load(os.path.join(cfg.out, "labels.npy"))
    # the fleet's cadence, for a standalone world to be held to a fleet:
    # one step a minibatch, no sweep, no pipeline
    cadence = ({} if cfg.cadence == "sweep"
               else {"fused_sweep": False, "fused_pipeline": False})
    wf, _ = load(MLPWorkflow, name="fleet-" + cfg.tag,
                 layers=tuple(cfg.layers),
                 loader_kwargs=dict(data=data, labels=labels,
                                    class_lengths=list(cfg.lengths),
                                    minibatch_size=cfg.minibatch,
                                    normalization_type="linear"),
                 learning_rate=cfg.lr, max_epochs=cfg.epochs, **cadence)
    if cfg.init:
        unit_params_from_jax(wf, list(numpy.load(cfg.init,
                                                 allow_pickle=True)))
    launcher = wf.workflow
    role = launcher.mode
    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)
    record = {"role": role, "rank": rank, "pid": os.getpid(), "epochs": [],
              "merge_ms": [], "slaves": {}, "respawns": 0, "sent": {},
              "got": {}, "encode_s": 0.0, "write_s": 0.0, "read_s": 0.0,
              "wait_s": 0.0, "job_s": 0.0, "images": 0, "first": None,
              "last": None}
    if role == "slave":
        instrument_slave(wf, cfg, record)
    else:
        instrument_master(wf, cfg, record)
    gemm.dense_epilogue.launches = gemm.blocked_matmul.launches = 0
    t0 = time.perf_counter()
    main()
    synchronize(wf.device)
    record["wall"] = time.perf_counter() - t0
    record["dense_epilogue"] = gemm.dense_epilogue.launches
    record["blocked_matmul"] = gemm.blocked_matmul.launches
    record["device"] = str(wf.device)
    agent = launcher.agent
    if role == "master":
        record["ledger"] = agent.ledger.snapshot()
        record["best"] = wf.decision.best_n_err[1]
        record["plane"] = agent.plane
        status = agent.fleet_status()
        record["sync"] = status.get("sync")
        record["payload_rejects"] = status.get("payload_rejects", 0)
    elif role == "slave":
        # a pod slave's rank 0 runs the Client, its other ranks a Follower
        record["kind"] = type(agent).__name__
        record["jobs"] = agent.jobs_done
        record["shm"] = getattr(agent, "_shm_thr_", None) is not None
        record["fused"] = wf.fused_tick is not None
        record["meshed"] = wf.fused_tick is not None \
            and wf.fused_tick.mesh is not None
        pod = getattr(agent, "pod", None)
        record["pod"] = pod.stats if pod is not None \
            else getattr(agent, "stats", None)
        chaos = getattr(agent, "chaos", None)
        record["chaos"] = dict(chaos.counters) if chaos else {}
        record["rollbacks"] = agent.rollbacks
    else:
        record["best"] = wf.decision.best_n_err[1]
        record["meshed"] = wf.fused_tick is not None \
            and wf.fused_tick.mesh is not None
    name = "%s-%s-%d" % (cfg.tag, role, os.getpid())
    leaves = [(f.weights.data.cpu().numpy(), f.bias.data.cpu().numpy(),
               g._velocity_w.data.cpu().numpy(),
               g._velocity_b.data.cpu().numpy())
              for f, g in zip(wf.forwards, wf.gds)]
    numpy.save(os.path.join(cfg.out, name + ".npy"),
               numpy.array(leaves, dtype=object))
    with open(os.path.join(cfg.out, name + ".json"), "w") as fout:
        json.dump(record, fout)
'''


def fleet_argv(device, workflow, out, tag, overrides=(), flags=(),
               reconnects=12):
    """A ``python -m veles_tpu_torch`` command line of FLEET_WORKFLOW on
    ``device``: the engine knobs on at level 2, the empty tuning cache,
    ``root.fl``; a slave tries ``reconnects`` connections (a slave
    started beside its master waits while the master loads)."""
    return ([sys.executable, "-m", "veles_tpu_torch", workflow, "-",
             "root.common.engine.use_pallas=True",
             "root.common.engine.pallas_epilogue=True",
             "root.common.engine.precision_level=2",
             "root.common.engine.pallas_autotune_cache=%r"
             % root.common.engine.pallas_autotune_cache,
             "root.common.fleet.max_reconnect_attempts=%d" % reconnects,
             "root.fl.out=%r" % out, "root.fl.tag=%r" % tag]
            + list(overrides) + ["--device", device.type] + list(flags))


def alive(pid):
    """True while ``pid`` runs (a zombie waiting for its reaper counts
    as ended)."""
    try:
        with open("/proc/%d/stat" % pid) as fin:
            return fin.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def progress_rows(out, tag, kind="progress"):
    """The rows of ``<tag>-progress.jsonl`` (an update the master took)
    or, with ``kind="started"``, of ``<tag>-started.jsonl`` (a job a
    slave started)."""
    path = os.path.join(out, "%s-%s.jsonl" % (tag, kind))
    if not os.path.exists(path):
        return []
    with open(path) as fin:
        return [json.loads(line) for line in fin if line.strip()]


class FleetPart:
    """One fleet run of phases 23 and 24: its processes, started together,
    each with a log under ``out``. ``kill = (name, n)`` SIGKILLs process
    ``name`` once it has started job ``n + 1``, so that it dies holding a
    lease; with ``name`` None, the first slave to start job ``n + 1`` (one
    the master spawned). With ``spawned``, the part runs until every slave
    the master spawned has ended too. :func:`run_fleet_parts` waits for
    parts."""

    def __init__(self, out, tag, argvs, kill=None, spawned=False):
        self.out, self.tag, self.kill, self.spawned = out, tag, kill, spawned
        self.names = [name for name, _ in argvs]
        self.logs = [open(os.path.join(out, "%s-%s.log" % (tag, name)),
                          "w+") for name in self.names]
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(argv, cwd=REPO_DIR, env=port_env(),
                                       stdout=log, stderr=subprocess.STDOUT)
                      for (_, argv), log in zip(argvs, self.logs)]
        self.killed = self.killed_at = self.done_at = None
        self.ended = {}

    def proc(self, name):
        return self.procs[self.names.index(name)]

    def poll(self):
        """Apply the kill rule, note the ended processes; True while the
        part runs."""
        now = time.perf_counter()
        rows = progress_rows(self.out, self.tag) if self.spawned else []
        if self.kill is not None and self.killed is None:
            name, after = self.kill
            victim = None
            for row in progress_rows(self.out, self.tag, "started"):
                if row["n"] > after and (name is None or row["pid"]
                                         == self.proc(name).pid):
                    victim = row["pid"]
                    break
            if victim is not None:
                os.kill(victim, signal.SIGKILL)
                self.killed, self.killed_at = victim, now
        running = False
        for name, proc in zip(self.names, self.procs):
            if proc.poll() is None:
                running = True
            else:
                self.ended.setdefault(name, now)
        if self.spawned and not running:
            running = any(alive(row["pid"]) for row in rows)
        if not running and self.done_at is None:
            self.done_at = now
        return running

    def finish(self, failing=()):
        """Kill what still runs; every process but the killed one and
        ``failing`` must have exited 0. Returns the records by role (a
        pod's ranks in rank order)."""
        self.texts = {}
        for name, proc, log in zip(self.names, self.procs, self.logs):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.seek(0)
            self.texts[name] = log.read()
            log.close()
        for row in progress_rows(self.out, self.tag):
            if alive(row["pid"]):
                os.kill(row["pid"], signal.SIGKILL)
        self.wall = (self.done_at or time.perf_counter()) - self.t0
        for name, proc in zip(self.names, self.procs):
            if proc.returncode and proc.pid != self.killed \
                    and name not in failing:
                raise AssertionError("(%s) the %s exited %d:\n%s" % (
                    self.tag, name, proc.returncode,
                    self.texts[name][-4000:]))
        records = {}
        for path in glob.glob(os.path.join(self.out, "%s-*.json"
                                           % self.tag)):
            with open(path) as fin:
                record = json.load(fin)
            record["leaves"] = numpy.load(path[:-5] + ".npy",
                                          allow_pickle=True)
            records.setdefault(record["role"], []).append(record)
        for role in records.values():
            role.sort(key=lambda r: (r["rank"], r.get("kind") != "Client"))
        return records


def run_fleet_parts(parts, deadline=FLEET_DEADLINE, until=None):
    """Poll ``parts`` until each of ``until`` (default: every part) has
    ended, within ``deadline`` seconds; the others run on. Past the
    deadline, or on an error, every process of every part is killed."""
    until = parts if until is None else until
    t0 = time.perf_counter()
    try:
        while True:
            running = {part: part.poll() for part in parts}
            if not any(running[part] for part in until):
                return
            if time.perf_counter() - t0 > deadline:
                raise AssertionError("fleet parts %s passed their %d s "
                                     "deadline" % ([p.tag for p in until],
                                                   deadline))
            time.sleep(0.05)
    except BaseException:
        for part in parts:
            for proc in part.procs:
                if proc.poll() is None:
                    proc.kill()
        raise


def fleet_single(device, data, labels, weights):
    """One process stepping the same minibatches from the same weights:
    (per-epoch validation n_err, leaves, launches)."""
    wf = build_mlp(device, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                   BENCH_CLASS_LENGTHS, True, DP_EPOCHS, precision_level=2,
                   weights=weights)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, _ = train(wf, device)
    got = counts()
    leaves = [(f.weights.data.cpu().numpy(), f.bias.data.cpu().numpy(),
               g._velocity_w.data.cpu().numpy(),
               g._velocity_b.data.cpu().numpy())
              for f, g in zip(wf.forwards, wf.gds)]
    return [e["valid_n_err"] for e in epochs], leaves, got


def leaves_diff(got, want, velocities=True):
    """Max abs difference over weights, biases and (optionally) the
    velocities of two leaf lists."""
    count = 4 if velocities else 2
    return max(float(numpy.abs(numpy.asarray(a, numpy.float64)
                               - numpy.asarray(b, numpy.float64)).max())
               for x, y in zip(got, want)
               for a, b in zip(x[:count], y[:count]))


def frame_sizes(record, key):
    """Mean bytes of the frames of each message type one way."""
    return {kind: sum(sizes) / len(sizes)
            for kind, sizes in sorted(record[key].items())}


def slave_reading(label, slave, master):
    """Phase 23's readings of one slave: images/s, bytes per job each
    way, /dev/shm, and the share of its wall encoding, sending, waiting,
    decoding and in jobs; the master's merge ms per update."""
    span = slave["last"] - slave["first"]
    wall = slave["wall"]
    shares = {"encode": slave["encode_s"],
              "send": slave["write_s"] - slave["encode_s"],
              "wait": slave["wait_s"],
              "decode": slave["read_s"] - slave["wait_s"],
              "jobs": slave["job_s"]}
    merge = master["merge_ms"]
    print("  %s slave pid %d: %d jobs, %d images in %.3f s from the first "
          "job's start to the last one's end: %.1f images/s; frames "
          "received (mean bytes) %s, sent %s, through /dev/shm: %s; of "
          "its %.3f s: %s; the master's merge %.3f ms mean, %.3f median "
          "per update (%d updates, the card synchronised)"
          % (label, slave["pid"], slave["jobs"], slave["images"], span,
             slave["images"] / span, frame_sizes(slave, "got"),
             frame_sizes(slave, "sent"), slave["shm"], wall,
             ", ".join("%s %.3f s (%.1f%%)" % (k, v, 100 * v / wall)
                       for k, v in shares.items()),
             statistics.mean(merge), statistics.median(merge),
             len(merge)))


def fleet_wide(device, out, workflow, tag, plane, single):
    """Phase 23 (a) or (d): the wide MLP through a master and one slave
    on the wire plane ``plane``, held to the single run. Returns the
    started part and the function that checks it once it ended and
    returns (master, slave)."""
    n_err, single_leaves, single_got = single
    overrides = ["root.fl.%s=%r" % item for item in (
        ("layers", list(WIDE_LAYERS)), ("minibatch", WIDE_MINIBATCH),
        ("lengths", list(BENCH_CLASS_LENGTHS)), ("epochs", DP_EPOCHS),
        ("lr", TRAIN_LR), ("init", os.path.join(out, "init.npy")))]
    base = fleet_argv(device, workflow, out, tag, overrides,
                      ("--seed", "default=1234,loader=1234",
                       "--fleet-plane", plane))
    address = "127.0.0.1:%d" % free_port()
    part = FleetPart(out, tag, [("master", base + ["-l", address]),
                                ("slave", base + ["-m", address])])
    return part, lambda: fleet_wide_checks(device, tag, plane, single,
                                           part)


def fleet_wide_checks(device, tag, plane, single, part):
    """Phase 23 (a) or (d)'s checks and readings on its ended part."""
    n_err, single_leaves, single_got = single
    records = part.finish()
    ((master,), (slave,)), wall = (records["master"], records["slave"]), \
        part.wall
    got = {name: slave[name] for name in ("dense_epilogue",
                                          "blocked_matmul")}
    w_diff = leaves_diff(master["leaves"], single_leaves,
                         velocities=False)
    v_diff = leaves_diff(slave["leaves"], single_leaves)
    print("  (%s) %s plane: validation n_err %s (the single run %s); the "
          "master's weights %.3g, the slave's weights and velocities %.3g "
          "from the single run's (tolerance %.0e); slave launches %s (the "
          "single run %s), the master's %s; ledger %s; wall %.1f s"
          % (tag, plane, master["epochs"], n_err, w_diff, v_diff,
             FLEET_ATOL, got, {k: single_got[k] for k in got},
             {k: master[k] for k in got}, master["ledger"], wall))
    slave_reading(tag, slave, master)
    checks = {
        "n_err": master["epochs"] == n_err,
        "weights": w_diff <= FLEET_ATOL and v_diff <= FLEET_ATOL,
        "slave launches": all(got[k] == single_got[k] and got[k]
                              for k in got),
        "master launches none": not (master["dense_epilogue"]
                                     or master["blocked_matmul"]),
        "a fused slave on the card": slave["fused"]
        and slave["device"] == str(device),
        "plane": master["plane"] == plane}
    if plane == "control":
        small = max(max(slave["got"].get("job", [0])),
                    max(slave["sent"].get("update", [0])))
        checks["per-job frames carry no weights"] = \
            small < FLEET_SMALL_FRAME
        checks["a fence sync per epoch"] = \
            (master["sync"] or {}).get("applied") == DP_EPOCHS
        print("  (%s) the largest job or update frame %d bytes (bound %d); "
              "fence syncs %s" % (tag, small, FLEET_SMALL_FRAME,
                                  master["sync"]))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("phase 23 (%s) failed: %s" % (tag, failed))
    return master, slave


def fleet_digits(device, out, workflow, tag, flags, hold_for=1, slow_ms=0,
                 kill_after=None, epochs=FLEET_DIGITS["epochs"], stagger=0):
    """Phase 23 (b) or (c): the digits through a master that spawns its
    slaves with ``--nodes``: its first job held until ``hold_for`` slaves
    are connected, the second slave's first until ``stagger`` updates are
    in, each job stretched by ``slow_ms`` (the chaos slow-job fault at
    probability 1), for ``epochs``. Returns the started part and
    the function that reads it once it ended: (master, slave records, the
    killed pid, checks)."""
    overrides = ["root.fl.data='digits'", "root.fl.hold_for=%d" % hold_for,
                 "root.fl.stagger=%d" % stagger,
                 "root.common.fleet.chaos.slow_job_ms=%d" % slow_ms]
    overrides += ["root.fl.%s=%r" % item for item in dict(
        FLEET_DIGITS, epochs=epochs).items()]
    flags = ("--seed", "default=42,loader=43", "-l",
             "127.0.0.1:%d" % free_port()) + tuple(flags)
    if slow_ms:
        flags += ("--chaos-seed", "23", "--chaos-slow-job", "1")
    part = FleetPart(out, tag, [("master", fleet_argv(
        device, workflow, out, tag, overrides, flags, reconnects=2))],
        kill=(None, kill_after) if kill_after is not None else None,
        spawned=True)

    def result():
        records = part.finish()
        (master,), slaves = records["master"], records.get("slave", [])
        ledger = master["ledger"]
        print("  (%s) %s: validation n_err by epoch %s, best %d of 297; "
              "updates by slave %s; ledger %s; respawns %d; killed %s; "
              "slave records %d; wall %.1f s"
              % (tag, " ".join(flags), master["epochs"], master["best"],
                 master["slaves"], ledger, master["respawns"], part.killed,
                 len(slaves), part.wall))
        checks = {
            "every lease done or requeued": ledger["outstanding"] == 0
            and ledger["issued"] == ledger["done"] + ledger["requeued"],
            "epochs": len(master["epochs"]) == epochs}
        return master, slaves, part.killed, checks
    return part, result


def fleet_phase(device, beside=None):
    """Phase 23: (a) the data plane with one sync slave, (b) two slaves
    spawned through --nodes, (d) the control plane with one slave and (c)
    a slave killed mid-run and respawned, (d) and (c) together; every
    process shares the card. With a list ``beside``, (d) and (c) are not
    run here: ``("with", start)`` for (d) and ``("before", start)`` for
    (c) go into it, for phase 24 to start (c) before its (a) and (d)
    with its (b) and (c); each ``start`` returns the parts it started and
    the function that checks them once they ended and returns their
    slaves' launches. Returns the slaves' K6 and K5 launches (all of
    them when run here) and the single run (phase 24 holds its pod to
    it)."""
    t0 = time.perf_counter()
    data, labels = bench_dataset()
    weights = dp_weights(numpy.random.RandomState(23))
    single = fleet_single(device, data, labels, weights)
    out = tempfile.mkdtemp()
    workflow = os.path.join(out, "fleet_wf.py")
    with open(workflow, "w") as fout:
        fout.write(FLEET_WORKFLOW)
    numpy.save(os.path.join(out, "data.npy"), data)
    numpy.save(os.path.join(out, "labels.npy"), labels)
    numpy.save(os.path.join(out, "init.npy"),
               numpy.array(weights, dtype=object))
    del data
    try:
        part, check = fleet_wide(device, out, workflow, "a", "data", single)
        run_fleet_parts([part])
        slave = check()[1]
        part, read = fleet_digits(device, out, workflow, "b",
                                  ("-n", "localhost,localhost"), hold_for=2,
                                  stagger=FLEET_STAGGER)
        run_fleet_parts([part])
        master, spawned, _, checks = read()
        checks["both slaves took jobs"] = len(spawned) == 2 \
            and all(s["jobs"] for s in spawned)
        checks["best n_err <= %d" % FLEET_DIGITS_BOUND] = \
            master["best"] <= FLEET_DIGITS_BOUND
        if not all(checks.values()):
            raise AssertionError("phase 23 (b) failed: %s" % checks)
    except BaseException:
        shutil.rmtree(out, ignore_errors=True)
        raise
    launches = slave_launches([slave] + spawned)
    ended = []

    def cleanup():
        # the second of (c) and (d) to end removes the directory
        ended.append(True)
        if len(ended) == 2:
            shutil.rmtree(out, ignore_errors=True)

    def start_d():
        part, check = fleet_wide(device, out, workflow, "d", "control",
                                 single)

        def finished():
            try:
                return slave_launches([check()[1]])
            finally:
                cleanup()
        return [part], finished

    def start_c():
        part, read = fleet_digits(
            device, out, workflow, "c", ("-n", "localhost", "--respawn"),
            slow_ms=FLEET_SLOW_MS, kill_after=FLEET_KILL_AFTER,
            epochs=FLEET_RESPAWN_EPOCHS)

        def finished():
            try:
                master, respawned, killed, checks = read()
            finally:
                cleanup()
            checks["a slave was killed"] = killed is not None
            checks["its leases requeued"] = \
                master["ledger"]["requeued_dropped"] >= 1
            checks["respawned"] = master["respawns"] >= 1
            checks["the respawned slave ended the run"] = any(
                s["pid"] != killed and s["jobs"] for s in respawned)
            if not all(checks.values()):
                raise AssertionError("phase 23 (c) failed: %s" % checks)
            return slave_launches(respawned)
        return [part], finished
    print("fleet phase (a) and (b): %.1f s" % (time.perf_counter() - t0))
    if beside is not None:
        beside += [("with", start_d), ("before", start_c)]
        return launches, single
    started = [start_d(), start_c()]
    run_fleet_parts([p for parts, _ in started for p in parts])
    for _, finished in started:
        for name, n in finished().items():
            launches[name] += n
    print("fleet phase: %.1f s" % (time.perf_counter() - t0))
    return launches, single


def slave_launches(slaves):
    """The K6 and K5 launches of ``slaves``' records, summed."""
    launches = dict.fromkeys(COUNTERS, 0)
    for slave in slaves:
        for name in ("dense_epilogue", "blocked_matmul"):
            launches[name] += slave[name]
    return launches


# -- phase 24: the fleet x pod composition (ROADMAP A9 (e)) -------------------

#: phase 24: phase 22's wide MLP, data, weights and epochs through a
#: ``-l`` master and a pod slave: a world of POD_RANKS ranks sharing the
#: card over gloo, rank 0 on the fleet wire, rank 1 following its jobs
POD_RANKS = 2
#: the pod worlds' timeout (``root.common.mesh.timeout``, seconds): a
#: follower whose rank 0 is gone exits within it
POD_TIMEOUT = 60
#: (b)'s chaos on the pod's rank 0: tests/test_fleet_chaos.py:578-583
POD_CHAOS = ("--chaos-seed", "1", "--chaos-death", "0.18",
             "--chaos-frame-drop", "0.04", "--chaos-frame-delay", "0.10",
             "--chaos-duplicate-update", "0.25", "--chaos-slow-job", "0.25")
POD_CHAOS_SETTINGS = ("root.common.fleet.chaos.frame_delay_ms=5.0",
                      "root.common.fleet.chaos.slow_job_ms=20.0",
                      "root.common.fleet.chaos.death_mode='disconnect'")
#: (c): 2 epochs, the pod's rank 0 killed in the job after this many
#: (holding its lease; its jobs stretched by POD_SLOW_MS, the chaos
#: slow-job fault at probability 1). The master serves whichever slave
#: asks first alone for POD_STAGGER updates, then holds it until the other
#: has answered two, so the pod reaches that job whatever the order (a
#: fresh pod's first job takes seconds on the card: the single-rank
#: slave could otherwise run the stream dry first)
POD_DROP_EPOCHS, POD_KILL_AFTER, POD_SLOW_MS, POD_STAGGER = 2, 1, 100, 2
#: each group of parts' deadline, seconds: every process is killed past it
POD_DEADLINE = 300
#: the master's warning of an ignored mesh (veles_tpu/launcher.py:105-110)
POD_MASTER_WARNING = "the mesh is ignored here; configure it on the slaves"


def pod_argvs(base, master, tag_flags=()):
    """The pod's ranks: ``base`` with ``-m master --mesh data=2
    --coordinator ... --num-processes 2 --process-id i``."""
    coordinator = "127.0.0.1:%d" % free_port()
    return [("rank%d" % rank, base + list(tag_flags) + [
        "-m", master, "--mesh", "data=%d" % POD_RANKS, "--coordinator",
        coordinator, "--num-processes", str(POD_RANKS), "--process-id",
        str(rank)]) for rank in range(POD_RANKS)]


def pod_base(device, workflow, out, tag, plane, epochs=DP_EPOCHS,
             cadence="sweep", settings=(), flags=()):
    """A fleet process's command line for phase 24: the wide MLP on the
    bench data from the numpy weights, the engine knobs on at level 2,
    gloo for the world, POD_TIMEOUT."""
    overrides = ["root.fl.%s=%r" % item for item in (
        ("layers", list(WIDE_LAYERS)), ("minibatch", WIDE_MINIBATCH),
        ("lengths", list(BENCH_CLASS_LENGTHS)), ("epochs", epochs),
        ("lr", TRAIN_LR), ("cadence", cadence),
        ("init", os.path.join(out, "init.npy")))]
    overrides += ["root.common.mesh.backend='gloo'",
                  "root.common.mesh.timeout=%d" % POD_TIMEOUT]
    overrides += list(settings)
    return fleet_argv(device, workflow, out, tag, overrides,
                      ("--seed", "default=1234,loader=1234",
                       "--fleet-plane", plane) + tuple(flags))


def pod_leaves_equal(got, want, count=4):
    return all(numpy.array_equal(a, b) for x, y in zip(got, want)
               for a, b in zip(x[:count], y[:count]))


def pod_data_plane(device, out, workflow, single, background=()):
    """Phase 24 (a): a data-plane master (``--mesh`` given: it warns and
    ignores it) and one pod slave, held to the single run; the readings:
    images/s a rank, the wire's share of rank 0's wall, the follower's
    waiting share and the bytes handed on per job. The ``background``
    parts are polled meanwhile."""
    n_err, single_leaves, single_got = single
    address = "127.0.0.1:%d" % free_port()
    base = pod_base(device, workflow, out, "pa", "data")
    part = FleetPart(out, "pa", [("master", base + [
        "-l", address, "--mesh", "data=%d" % POD_RANKS])]
        + pod_argvs(base, address))
    run_fleet_parts([part] + list(background), POD_DEADLINE, until=[part])
    records = part.finish()
    (master,) = records["master"]
    ranks = records["slave"]
    leader, follower = ranks
    launches = {name: [r[name] for r in ranks]
                for name in ("dense_epilogue", "blocked_matmul")}
    w_diff = leaves_diff(master["leaves"], single_leaves, velocities=False)
    v_diff = max(leaves_diff(r["leaves"], single_leaves) for r in ranks)
    print("  (a) data plane, a pod of %d ranks (gloo, one card): validation "
          "n_err %s (the single run %s); the master's weights %.3g, the "
          "ranks' weights and velocities %.3g from the single run's "
          "(tolerance %.0e); launches by rank %s (the single run %s), the "
          "master's %s; ledger %s; wall %.1f s"
          % (POD_RANKS, master["epochs"], n_err, w_diff, v_diff, DP_ATOL,
             launches, {k: single_got[k] for k in launches},
             {k: master[k] for k in launches}, master["ledger"], part.wall))
    slave_reading("pa rank 0", leader, master)
    span = leader["last"] - leader["first"]
    wire = (leader["write_s"] + leader["read_s"]) / leader["wall"]
    stats = leader["pod"]
    per_job = stats["bytes"]["job"] / stats["events"]["job"]
    wait = follower["pod"]["wait_s"] / follower["wall"]
    print("  (a) images/s a rank (each steps every job, its %d rows of "
          "each minibatch): %.1f; the wire %.1f%% of rank 0's %.3f s "
          "(encode, send, wait and decode); rank 0 hands on %s events "
          "(%s bytes by kind) in %.3f s: %.0f bytes a job; the follower "
          "waits %.3f s of its %.3f s (%.1f%%), applies %.3f s, %d jobs"
          % (WIDE_MINIBATCH // POD_RANKS, leader["images"] / span,
             100 * wire, leader["wall"], stats["events"], stats["bytes"],
             stats["seconds"], per_job, follower["pod"]["wait_s"],
             follower["wall"], 100 * wait, follower["pod"]["apply_s"],
             follower["jobs"]))
    checks = {
        "n_err": master["epochs"] == n_err,
        "weights": w_diff <= DP_ATOL and v_diff <= DP_ATOL,
        "rank launches": all(n == single_got[k] and n
                             for k, ns in launches.items() for n in ns),
        "master launches none": not (master["dense_epilogue"]
                                     or master["blocked_matmul"]),
        "a meshed tick on every rank on the card": all(
            r["meshed"] and r["device"] == str(device) for r in ranks),
        "rank 0 the client, rank 1 the follower":
            (leader["kind"], follower["kind"]) == ("Client", "Follower"),
        "every job handed on": stats["events"].get("job")
        == leader["jobs"] == follower["jobs"] and stats["events"].get(
            "end") == 1,
        "the master warned of its mesh":
            POD_MASTER_WARNING in part.texts["master"]}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("phase 24 (a) failed: %s" % failed)
    return ranks


def pod_parts(device, out, workflow):
    """Phase 24 (b) and (c)'s processes, started together: the
    standalone world at the fleet's cadence, the control-plane master
    and pod fault-free and under chaos, and (c)'s master, pod and
    single-rank slave."""
    parts = []
    base = pod_base(device, workflow, out, "pw", "control", cadence="fleet")
    coordinator = "127.0.0.1:%d" % free_port()
    parts.append(FleetPart(out, "pw", [("rank%d" % rank, base + [
        "--mesh", "data=%d" % POD_RANKS, "--coordinator", coordinator,
        "--num-processes", str(POD_RANKS), "--process-id", str(rank)])
        for rank in range(POD_RANKS)]))
    for tag, chaos in (("pb", False), ("pc", True)):
        address = "127.0.0.1:%d" % free_port()
        settings = POD_CHAOS_SETTINGS if chaos else ()
        base = pod_base(device, workflow, out, tag, "control",
                        settings=settings)
        parts.append(FleetPart(out, tag, [("master", base + ["-l", address])]
                             + pod_argvs(base, address,
                                         POD_CHAOS if chaos else ())))
    address = "127.0.0.1:%d" % free_port()
    base = pod_base(device, workflow, out, "pd", "data",
                    epochs=POD_DROP_EPOCHS,
                    settings=("root.fl.hold_for=2",
                              "root.fl.stagger=%d" % POD_STAGGER,
                              "root.common.fleet.chaos.slow_job_ms=%d"
                              % POD_SLOW_MS))
    ranks = pod_argvs(base, address, ("--chaos-seed", "24",
                                      "--chaos-slow-job", "1"))
    parts.append(FleetPart(out, "pd", [("master", base + ["-l", address])]
                         + ranks + [("single", base + ["-m", address])],
                         kill=("rank0", POD_KILL_AFTER)))
    return parts


def pod_control_checks(anchor, part, records, chaos):
    """Phase 24 (b): the control-plane master's and the pod's weights
    bit-equal to the standalone world's, its n_err; the fences synced;
    under chaos every fault fired and every rollback reached the
    follower."""
    (master,) = records["master"]
    leader, follower = records["slave"]
    ledger = master["ledger"]
    counters = leader["chaos"]
    print("  (b) control plane%s: validation n_err %s (the standalone "
          "world %s); bit-equal to the world: the master's weights %s, "
          "rank 0's leaves %s, rank 1's %s; fence syncs %s; ledger %s; "
          "rank 0's chaos %s, rollbacks %d (the follower's %d); events "
          "handed on %s; launches by rank %s; wall %.1f s"
          % (" under chaos" if chaos else ", fault-free", master["epochs"],
             anchor["epochs"], pod_leaves_equal(master["leaves"],
                                                anchor["leaves"], 2),
             pod_leaves_equal(leader["leaves"], anchor["leaves"]),
             pod_leaves_equal(follower["leaves"], anchor["leaves"]),
             master["sync"], ledger, counters, leader["rollbacks"],
             follower["rollbacks"], leader["pod"]["events"],
             [(r["dense_epilogue"], r["blocked_matmul"])
              for r in (leader, follower)], part.wall))
    checks = {
        "n_err": master["epochs"] == anchor["epochs"],
        "the master bit-equal": pod_leaves_equal(master["leaves"],
                                                 anchor["leaves"], 2),
        "the ranks bit-equal": all(pod_leaves_equal(
            r["leaves"], anchor["leaves"]) for r in (leader, follower)),
        "a fence sync per epoch": (master["sync"] or {}).get("applied")
        == DP_EPOCHS if not chaos
        else (master["sync"] or {}).get("applied", 0) >= DP_EPOCHS,
        "every fence handed on": leader["pod"]["events"].get("fence", 0)
        >= DP_EPOCHS,
        "no weight payload on the wire": master["payload_rejects"] == 0,
        "every rollback handed on":
            leader["rollbacks"] == follower["rollbacks"],
        "master launches none": not (master["dense_epilogue"]
                                     or master["blocked_matmul"])}
    if chaos:
        checks.update({
            "deaths": counters.get("deaths", 0) >= 1,
            "duplicated updates": counters.get("updates_duplicated", 0) >= 1,
            "requeued": ledger["requeued"] >= 1,
            "fenced duplicates": ledger["fenced"]["duplicate"] >= 1,
            "rollbacks": leader["rollbacks"] >= 1})
    else:
        checks["nothing fenced"] = ledger["fenced_total"] == 0
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("phase 24 (b%s) failed: %s"
                             % (" under chaos" if chaos else "", failed))
    return [leader, follower]


def pod_drop_checks(part, records):
    """Phase 24 (c): the killed rank 0's lease requeued, the run finished
    on the single-rank slave, the follower out within POD_TIMEOUT."""
    (master,) = records["master"]
    singles = [r for r in records.get("slave", []) if not r["meshed"]]
    follower_s = part.ended.get("rank1", float("inf")) - part.killed_at \
        if part.killed is not None else None
    ledger = master["ledger"]
    code = part.proc("rank1").returncode
    print("  (c) drop: the pod's rank 0 SIGKILLed in its job %d; "
          "its follower exited %s %.1f s later (timeout %d s): %s; the "
          "master's ledger %s, updates by slave %s, validation n_err %s; "
          "wall %.1f s" % (POD_KILL_AFTER + 1, code, follower_s or -1,
                           POD_TIMEOUT, (part.texts["rank1"].strip()
                                         .splitlines() or ["-"])[-1][:200],
                           ledger, master["slaves"], master["epochs"],
                           part.wall))
    checks = {
        "killed": part.killed == part.proc("rank0").pid,
        "the follower failed": code not in (0, None),
        "within its timeout": follower_s is not None
        and follower_s < POD_TIMEOUT,
        "the lease requeued": ledger["requeued_dropped"] >= 1,
        "every lease done or requeued": ledger["outstanding"] == 0
        and ledger["issued"] == ledger["done"] + ledger["requeued"],
        "the single-rank slave finished it": len(singles) == 1
        and singles[0]["jobs"] > 0,
        "epochs": len(master["epochs"]) == POD_DROP_EPOCHS}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("phase 24 (c) failed: %s" % failed)
    return singles


def pod_phase(device, single=None, beside=()):
    """Phase 24: (a) a data-plane master and a pod slave of two ranks
    against the single run; then together (b) the control plane
    fault-free and under chaos against the standalone two-rank world at
    the fleet's cadence and (c) a pod's rank 0 killed mid-run, and beside
    them the parts ``beside``'s functions start: phase 23's (c), started
    before (a), and its (d).
    Returns every slave rank's K6 and K5 launches, those beside too."""
    t0 = time.perf_counter()
    data, labels = bench_dataset()
    weights = dp_weights(numpy.random.RandomState(23))
    if single is None:
        single = fleet_single(device, data, labels, weights)
    with tempfile.TemporaryDirectory() as out:
        workflow = os.path.join(out, "fleet_wf.py")
        with open(workflow, "w") as fout:
            fout.write(FLEET_WORKFLOW)
        numpy.save(os.path.join(out, "data.npy"), data)
        numpy.save(os.path.join(out, "labels.npy"), labels)
        numpy.save(os.path.join(out, "init.npy"),
                   numpy.array(weights, dtype=object))
        del data
        # phase 23's (c), mostly waiting on its processes' start-ups,
        # starts now and runs beside (a); its (d) starts with (b) and (c)
        early = [start() for when, start in beside if when == "before"]
        background = [p for parts, _ in early for p in parts]
        slaves = pod_data_plane(device, out, workflow, single, background)
        t1 = time.perf_counter()
        parts = pod_parts(device, out, workflow)
        started = early + [start() for when, start in beside
                           if when == "with"]
        run_fleet_parts(parts + [p for more, _ in started for p in more
                                 if p not in parts], POD_DEADLINE)
        print("  (b) and (c)%s ran together: %.1f s"
              % (" and phase 23's (c) and (d)" if started else "",
                 time.perf_counter() - t1))
        world, clean, chaos, drop = parts
        ranks = world.finish()["standalone"]
        anchor = ranks[0]
        if not (pod_leaves_equal(ranks[0]["leaves"], ranks[1]["leaves"])
                and all(r["meshed"] for r in ranks)):
            raise AssertionError("phase 24: the standalone world's ranks "
                                 "disagree")
        print("  (b) the standalone world at the fleet's cadence: "
              "validation n_err %s (the single run %s), its ranks "
              "bit-equal; wall %.1f s" % (anchor["epochs"], single[0],
                                          world.wall))
        slaves += pod_control_checks(anchor, clean, clean.finish(), False)
        slaves += pod_control_checks(anchor, chaos, chaos.finish(), True)
        slaves += pod_drop_checks(drop, drop.finish(failing=("rank1",)))
        launches = slave_launches(slaves)
        for _, finished in started:
            for name, n in finished().items():
                launches[name] += n
    print("pod phase: %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 25: the AOT bundle ------------------------------------------------

#: phase 25's serving bundles, each tier at the serving model's full width:
#: (label, quantize, paged, the kernels its dispatches launch, by counter)
AOT_TIERS = (("paged int8", "int8", True, ("paged_attend", "int8_matmul")),
             ("paged int8-kv", "int8-kv", True,
              ("paged_attend_int8", "int8_matmul")),
             ("dense int8-kv", "int8-kv", False,
              ("int8_cache_attend", "int8_matmul")))
#: the first request's prompt (its one token is the cold start's reading)
#: and the warm-up's: 1, 2 and 6 pages of the pool, three slab buckets
AOT_FIRST_LEN, AOT_WARMUP_LENS = 40, (100, 250, 700)
#: phase 25's tick: phase 22's wide MLP on a cut of the bench set, one
#: validation and three train minibatches of 4096 an epoch, one epoch
AOT_TICK_N, AOT_TICK_CLASS_LENGTHS = 16384, [0, 4096, 12288]
AOT_CHILD_TIMEOUT = 300
#: the kernels' launch counters a child reads, by the JSON line's names
AOT_COUNTERS = ("paged_attend", "paged_attend_int8", "int8_cache_attend",
                "int8_matmul", "blocked_matmul", "dense_epilogue")

#: a fresh serving replica: the serving model's weights loaded from the
#: checkpoint the parent saved (bf16_model's draws from seed 0), a
#: GenerateAPI booted with or without the bundle (``root.common.serve.
#: aot``), one request's first token, then the warm-up's prompts one at a
#: time; stamps on time.time() for the parent
AOT_SERVE_CHILD = r'''
import json, sys, time
stamps = {"start": time.time()}
args = json.loads(sys.argv[1])
import urllib.request
import torch
from veles_tpu_torch.core.config import root
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.ops.paged_attention import (paged_attend,
                                                 paged_attend_int8)
from veles_tpu_torch.ops.quant import int8_cache_attend, int8_matmul
from veles_tpu_torch.serving import GenerateAPI
stamps["imported"] = time.time()
if args["bundle"]:
    root.common.serve.aot = args["bundle"]
device = torch.device("cuda")
params, table = torch.load(args["model"], map_location=device)
torch.cuda.synchronize()
stamps["model"] = time.time()
api = GenerateAPI(params, table, args["heads"], device=device,
                  **args["serve"]).start()
stamps["booted"] = time.time()
# one short request through its own front: the card's first launches
# (library loads, handles) are paid here, not by the router's baseline
req = urllib.request.Request(
    "http://127.0.0.1:%d/generate" % api.port, data=json.dumps(
        {"tokens": list(range(1, 9)), "n_tokens": 2}).encode(),
    headers={"Content-Type": "application/json"})
urllib.request.urlopen(req, timeout=300).read()
stamps["warm"] = time.time()


def post(tokens, n_tokens):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % api.port,
        data=json.dumps({"tokens": tokens, "n_tokens": n_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read().decode())["tokens"]


try:
    streams = [post(args["first"], 1)]
    stamps["first_token"] = time.time()
    streams += [post(prompt, args["n_tokens"]) for prompt in args["warmup"]]
    stamps["warm"] = time.time()
    aot = api.decoder.aot
    out = {"stamps": stamps, "streams": streams,
           "builds": {name: n for name, n in
                      get_compile_tracker().snapshot()["compiles"].items()
                      if name.endswith(".cu")},
           "launches": {"paged_attend": paged_attend.launches,
                        "paged_attend_int8": paged_attend_int8.launches,
                        "int8_cache_attend": int8_cache_attend.launches,
                        "int8_matmul": int8_matmul.launches},
           "aot": None if aot is None else aot.stats(),
           "dispatches": [row["dispatches"] for row in
                          api.ledger.resolved(len(streams))]}
finally:
    api.stop()
print("AOT_CHILD " + json.dumps(out))
'''

#: a fresh trainer: phase 22's wide MLP (bench.py's seeds, knobs on, a
#: step a minibatch) on the data the parent saved, its fused tick
#: installed from the bundle before initialize(), one epoch
AOT_TICK_CHILD = r'''
import json, sys, time
stamps = {"start": time.time()}
args = json.loads(sys.argv[1])
import numpy
import torch
from veles_tpu_torch.aot.loader import install_workflow_tick, load_bundle
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.ops.gemm import blocked_matmul, dense_epilogue
stamps["imported"] = time.time()
root.common.engine.update({"use_pallas": True, "pallas_epilogue": True,
                           "precision_level": 0})
prng.get("default").seed(1234)
prng.get("loader").seed(1234)
wf = MLPWorkflow(
    DummyLauncher(), layers=tuple(args["layers"]),
    loader_kwargs=dict(data=numpy.load(args["data"]),
                       labels=numpy.load(args["labels"]),
                       class_lengths=args["class_lengths"],
                       minibatch_size=args["minibatch"],
                       normalization_type="linear"),
    learning_rate=args["lr"], max_epochs=1, fused_sweep=False,
    device="cuda", name="mlp")
aot = load_bundle(args["bundle"])
install_workflow_tick(aot, wf)
n_err = []
summary = wf.decision._epoch_summary


def recorded(stats, epoch):
    n_err.append(int(stats[VALID][0]))
    summary(stats, epoch)


wf.decision._epoch_summary = recorded
wf.initialize()
wf.run()
torch.cuda.synchronize()
stamps["trained"] = time.time()
print("AOT_CHILD " + json.dumps({
    "stamps": stamps, "n_err": n_err, "aot": aot.stats(),
    "builds": {name: n for name, n in
               get_compile_tracker().snapshot()["compiles"].items()
               if name.endswith(".cu")},
    "launches": {"blocked_matmul": blocked_matmul.launches,
                 "dense_epilogue": dense_epilogue.launches}}))
'''


def package_copy(directory, warm=False):
    """A copy of the package in ``directory`` as ``git archive`` gives it:
    no ``_build/`` (``warm``: one holding this process's built
    libraries) and no byte-compiled files. Returns ``directory``."""
    dest = os.path.join(directory, "veles_tpu_torch")
    shutil.copytree(os.path.join(REPO_DIR, "veles_tpu_torch"), dest,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if warm:
        os.makedirs(os.path.join(dest, "_build"))
        for name in _build.KERNELS:
            shutil.copy(_build.library_path(name),
                        os.path.join(dest, "_build"))
    return directory


class AotChild:
    """A phase-25 child run from the package copy in ``directory`` (only
    it on the path), its output in files there; the parent stamps
    time.time() just before the Popen."""

    def __init__(self, script, args, directory):
        self.out = open(os.path.join(directory, "child.out"), "w+")
        self.err = open(os.path.join(directory, "child.err"), "w+")
        self.popen = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, json.dumps(args)],
            cwd=directory, env=dict(os.environ, PYTHONPATH=directory),
            stdout=self.out, stderr=self.err, text=True)

    def result(self, deadline):
        """The child's JSON with ``popen`` set; fails on a non-zero exit
        or a child still running at ``deadline`` (time.time())."""
        try:
            code = self.proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError("a phase 25 child was past its deadline")
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        self.out.close()
        self.err.close()
        lines = [line for line in out.splitlines()
                 if line.startswith("AOT_CHILD ")]
        if code or not lines:
            raise AssertionError("phase 25 child exited %d:\n%s"
                                 % (code, err[-4000:]))
        result = json.loads(lines[-1][len("AOT_CHILD "):])
        result["popen"] = self.popen
        return result

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def aot_serve_kwargs(quantize, paged):
    return {"slots": SLOTS, "max_len": MAX_LEN, "n_tokens": N_TOKENS,
            "chunk": CHUNK, "paged": paged,
            "page_size": PAGE if paged else None, "quantize": quantize}


def aot_traffic():
    """The first request's prompt and the warm-up's, from seed 5."""
    rng = numpy.random.RandomState(5)
    return (rng.randint(0, VOCAB, AOT_FIRST_LEN).tolist(),
            [rng.randint(0, VOCAB, n).tolist() for n in AOT_WARMUP_LENS])


def aot_live_streams(params, table, quantize, paged, device):
    """This process's live decoder on the children's traffic, in their
    order: the first request's one token, then each warm-up prompt."""
    first, warmup = aot_traffic()
    api = GenerateAPI(params, table, HEADS, device=device,
                      **aot_serve_kwargs(quantize, paged)).start()
    try:
        return ([post(api.port, first, 1)]
                + [post(api.port, prompt, N_TOKENS) for prompt in warmup])
    finally:
        api.stop()


def aot_reading(label, child):
    """One child's cold start, printed beside the card: Popen to the first
    token, split into start-up and imports, the weights' load (a warm
    read of the checkpoint), the boot (decoder build, bundle load) and the
    first request."""
    stamps = child["stamps"]
    total = stamps.get("first_token", stamps.get("trained")) - child["popen"]
    parts = [("imports", stamps["imported"] - child["popen"])]
    if "model" in stamps:
        parts += [("weights", stamps["model"] - stamps["imported"]),
                  ("boot", stamps["booted"] - stamps["model"]),
                  ("first request", stamps["first_token"] - stamps["booted"]),
                  ("warm-up", stamps["warm"] - stamps["first_token"])]
    print("phase 25 %s: %.3f s from Popen to the %s (%s), %s builds: %s; "
          "%s" % (label, total,
                  "first token" if "first_token" in stamps else "trained epoch",
                  ", ".join("%s %.3f" % part for part in parts),
                  sum(child["builds"].values()),
                  json.dumps(child["builds"], sort_keys=True), card_line()))
    return total


def aot_check_tier(label, kernels, child, live, launches):
    """An aot child's checks: no build, no miss, every dispatch an AOT hit
    in the bundle's stats and the ledger, the libraries staged from the
    bundle, the tier's kernels (and only they) launched, the streams
    bit-equal to this process's live decoder."""
    stats = child["aot"]
    assert not child["builds"], (label, child["builds"])
    assert stats is not None and not stats["misses"], (label, stats)
    assert sum(stats["hits"].values()) > 0, (label, stats)
    assert set(stats["libraries"].values()) == {"bundle"}, (label, stats)
    assert all(row["live"] == 0 and row["aot"] > 0
               for row in child["dispatches"]), child["dispatches"]
    assert child["streams"] == live, \
        "%s: the AOT-served streams differ from the live ones" % label
    for name in AOT_COUNTERS:
        got = child["launches"].get(name, 0)
        assert (got > 0) == (name in kernels), (label, name, got)
        launches[name] += got
    print("phase 25 %s: %d dispatches AOT hits (%s), no miss, streams "
          "bit-equal to live, launches %s" % (
              label, sum(stats["hits"].values()),
              json.dumps(stats["hits"], sort_keys=True),
              json.dumps({k: v for k, v in child["launches"].items() if v},
                         sort_keys=True)))


def aot_serve_args(model):
    """A serving child's arguments but its bundle and tier."""
    first, warmup = aot_traffic()
    return {"model": model, "heads": HEADS, "first": first,
            "warmup": warmup, "n_tokens": N_TOKENS}


def aot_cold_start(device):
    """Phase 25's cold-live child, started before phase 23 so that its
    ``nvcc`` builds run beside phases 23 and 24 (the phase took 197.6 s
    with its children one at a time): a directory with the serving
    model's checkpoint and a package copy with no ``_build/``. Returns
    (the directory, the checkpoint, the child)."""
    from veles_tpu_torch.device import tree_to
    tmp = tempfile.mkdtemp(prefix="aot-phase-")
    params, table = bf16_model(device)
    model = os.path.join(tmp, "model.pt")
    torch.save(tree_to((params, table), "cpu"), model)
    cold = AotChild(AOT_SERVE_CHILD, dict(
        aot_serve_args(model), bundle=None,
        serve=aot_serve_kwargs("int8", True)),
        package_copy(os.path.join(tmp, "cold")))
    return tmp, model, cold


def aot_phase(device, early):
    """Phase 25: the AOT bundle, in the directory ``early`` made
    (:func:`aot_cold_start`). (a) In this process (every library built by
    now) three serving bundles at full width (paged int8, paged int8-KV,
    dense int8-KV) and one of phase 22's wide-MLP tick; one built twice,
    the same sha. (b) Fresh processes, each from a copy of the package
    with no ``_build/`` (as the card gets the tree from ``git archive``),
    the serving ones loading the weights saved in ``early``, timed from
    Popen to the first token: cold-live (``early``'s child: the paged
    int8 tier, no bundle, nvcc builds K2 and K1, beside phases 23 and
    24); aot paged int8, then warm-live (a copy holding the built
    libraries, no bundle: the boot's floor), one at a time; then aot
    paged int8-KV, aot dense int8-KV and the tick together. The aot
    children: zero builds, every dispatch a hit, no miss, the streams
    bit-equal to this process's live decoder, each tier's kernels
    launched; the tick: zero builds, its steps hits, the live run's
    n_err, K6 and K5 launched. Returns the children's launches."""
    from veles_tpu_torch.aot.artifact import (BundleBuilder,
                                              build_serving_bundle,
                                              capture_tick_programs,
                                              inspect_bundle, workflow_tick)
    t_phase = time.perf_counter()
    deadline = time.time() + AOT_CHILD_TIMEOUT
    tmp, model, cold = early
    params, table = bf16_model(device)
    launches = dict.fromkeys(COUNTERS, 0)
    root.common.serve.aot = None
    children = []
    serve_args = aot_serve_args(model)

    def start(script, args, name, warm=False):
        child = AotChild(script, args, package_copy(
            os.path.join(tmp, name), warm=warm))
        children.append(child)
        return child

    try:
        bundles, live = {}, {}
        for label, quantize, paged, _ in AOT_TIERS:
            path = os.path.join(tmp, label.replace(" ", "-")
                                + ".aot.tar")
            t0 = time.perf_counter()
            build_serving_bundle(params, table, HEADS, path,
                                 device=device,
                                 **aot_serve_kwargs(quantize, paged))
            ms = 1e3 * (time.perf_counter() - t0)
            info = inspect_bundle(path)
            with open(path + ".sha256") as fin:
                sha = fin.read().split()[0]
            print("phase 25 (a) %s bundle: %d bytes, sha256 %s, built "
                  "in %.1f ms; %d programs, libraries %s, %d verdicts"
                  % (label, os.path.getsize(path), sha, ms,
                     info["programs"],
                     json.dumps(info["libraries"], sort_keys=True),
                     info["verdicts"]))
            bundles[label] = (path, sha)
            live[label] = aot_live_streams(params, table, quantize,
                                           paged, device)
        again = os.path.join(tmp, "again.aot.tar")
        build_serving_bundle(params, table, HEADS, again, device=device,
                             **aot_serve_kwargs("int8", True))
        with open(again + ".sha256") as fin:
            assert fin.read().split()[0] == bundles["paged int8"][1], \
                "two builds of the paged int8 bundle differ"
        # the tick: phase 22's wide MLP, its live run the reference
        data, labels = bench_dataset(n=AOT_TICK_N,
                                     n_valid=AOT_TICK_CLASS_LENGTHS[1])
        numpy.save(os.path.join(tmp, "data.npy"), data)
        numpy.save(os.path.join(tmp, "labels.npy"), labels)
        wf = build_mlp(device, data, labels, WIDE_LAYERS,
                       WIDE_MINIBATCH, AOT_TICK_CLASS_LENGTHS, True, 1,
                       sweep=False)
        epochs, _ = train(wf, device)
        live_n_err = [int(epoch["valid_n_err"]) for epoch in epochs]
        specs, train_args, eval_args, _ = workflow_tick(wf)
        bundle = BundleBuilder(device=device)
        capture_tick_programs(bundle, wf.fused_tick._steps_,
                              train_args, eval_args, specs=specs)
        tick = bundle.write(os.path.join(tmp, "tick.aot.tar"))
        print("phase 25 (a) wide-MLP tick bundle: %d bytes, libraries "
              "%s" % (os.path.getsize(tick), json.dumps(
                  inspect_bundle(tick)["libraries"], sort_keys=True)))
        del wf
        # (b) the paged int8 tier's aot and warm-live boots, one at a
        # time beside the cold one's build
        readings = {}
        label, quantize, paged, kernels = AOT_TIERS[0]
        child = start(AOT_SERVE_CHILD, dict(
            serve_args, bundle=bundles[label][0],
            serve=aot_serve_kwargs(quantize, paged)),
            "aot-paged-int8").result(deadline)
        readings["aot " + label] = aot_reading("aot " + label, child)
        aot_check_tier(label, kernels, child, live[label], launches)
        warm = start(AOT_SERVE_CHILD, dict(
            serve_args, bundle=None,
            serve=aot_serve_kwargs("int8", True)), "warm",
            warm=True).result(deadline)
        readings["warm-live"] = aot_reading("warm-live (paged int8)",
                                            warm)
        assert not warm["builds"] and warm["aot"] is None, warm["builds"]
        assert warm["streams"] == live["paged int8"]
        # the int8-KV tiers' boots and the tick's, together
        rest = {label: start(AOT_SERVE_CHILD, dict(
            serve_args, bundle=bundles[label][0],
            serve=aot_serve_kwargs(quantize, paged)),
            "aot-" + label.replace(" ", "-"))
            for label, quantize, paged, _ in AOT_TIERS[1:]}
        ticked = start(AOT_TICK_CHILD, {
            "bundle": tick, "layers": list(WIDE_LAYERS),
            "minibatch": WIDE_MINIBATCH, "lr": TRAIN_LR,
            "class_lengths": AOT_TICK_CLASS_LENGTHS,
            "data": os.path.join(tmp, "data.npy"),
            "labels": os.path.join(tmp, "labels.npy")}, "aot-tick")
        for label, _, _, kernels in AOT_TIERS[1:]:
            child = rest[label].result(deadline)
            readings["aot " + label] = aot_reading(
                "aot " + label + " (beside the other)", child)
            aot_check_tier(label, kernels, child, live[label], launches)
        child = ticked.result(deadline)
        readings["aot tick"] = aot_reading("aot tick", child)
        stats = child["aot"]
        assert not child["builds"], child["builds"]
        assert not stats["misses"] and stats["hits"] == {
            "fused.train_step": 3, "fused.eval_step": 1}, stats
        assert set(stats["libraries"].values()) == {"bundle"}, stats
        assert child["n_err"] == live_n_err, (child["n_err"],
                                              live_n_err)
        assert child["launches"]["blocked_matmul"] > 0 \
            and child["launches"]["dense_epilogue"] > 0, \
            child["launches"]
        for name, n in child["launches"].items():
            launches[name] += n
        print("phase 25 aot tick: n_err %s (live %s), hits %s, launches "
              "%s" % (child["n_err"], live_n_err,
                      json.dumps(stats["hits"], sort_keys=True),
                      json.dumps(child["launches"], sort_keys=True)))
        cold = cold.result(deadline)
        readings["cold-live"] = aot_reading(
            "cold-live (paged int8, beside phases 23 and 24)", cold)
        assert cold["builds"].get("paged_attention.cu") \
            and cold["builds"].get("int8_matmul.cu"), cold["builds"]
        assert cold["aot"] is None and cold["streams"] == live[
            "paged int8"]
    finally:
        for child in children:
            child.kill()
    print("phase 25 readings (s from Popen to the first token): %s; "
          "phase 25 %.1f s; %s" % (json.dumps(readings, sort_keys=True),
                                   time.perf_counter() - t_phase,
                                   card_line()))
    return launches


# -- phase 26: the serving fleet and deploys ---------------------------------

#: the forge package every replica boots from (its bundle and the serving
#: checkpoint), and the rollout's: one name, two versions
SERVE_FLEET_PACKAGE = "serving-fleet"
SERVE_FLEET_REPLICAS = 3
#: the router's settings (tests/test_router.py::TestElasticChaosAcceptance
#: at the serving model's page of 128 tokens)
ROUTER_SPEC = ("poll_interval_s=0.2,fail_threshold=2,cooldown_s=0.0,"
               "hedge_after_s=2.0,backoff_s=0.01,page_size=%d" % PAGE)
SERVE_FLEET_CLIENTS, SERVE_FLEET_ROUNDS, SERVE_FLEET_N_TOKENS = 6, 6, 16
#: a replica child's own deadline, and the forge child's (started before
#: phase 23): each exits at it whatever happens
SERVE_FLEET_CHILD_DEADLINE, SERVE_FLEET_FORGE_DEADLINE = 600, 1200
#: the replicas' tier: the paged float tier on f32 weights. A replica's
#: greedy stream in the paged int8 tier (bf16 weights) is not the same
#: alone and inside a burst of six clients (ROADMAP C: 5 of 72 burst
#: streams differed on the card, ``scripts/batch_composition.py``); the
#: f32 float tier's are (0 of 72), so failover can be held bit-equal. The
#: rollout (c) keeps the int8 tier.
SERVE_FLEET_TIER = (None, True)
#: the rollout's other weights, and its ladder (ROLLOUT_STEPS, fast)
SERVE_FLEET_GREEN_SEED = 1
SERVE_FLEET_ROLLOUT = {"steps": ROLLOUT_STEPS, "hold_s": 0.5,
                       "cooldown_s": 0.5, "window_s": 20.0,
                       "min_requests": 2, "interval_s": 0.05}

#: a replica: fetch the package from the forge, load its bundle and its
#: serving checkpoint (bf16 leaves, widened exactly to f32), boot a
#: GenerateAPI from the bundle, print its port, serve until killed or
#: told "report" on stdin (then print its builds, AOT stats and launches)
SERVE_FLEET_REPLICA_CHILD = r"""
import json, os, sys, threading, time, urllib.request
stamps = {"start": time.time()}
args = json.loads(sys.argv[1])
threading.Timer(args["deadline_s"], lambda: os._exit(3)).start()
import numpy
import torch
from veles_tpu_torch.core.config import root
from veles_tpu_torch.deploy_cli import load_serving_checkpoint
from veles_tpu_torch.device import tree_to
from veles_tpu_torch.forge.client import ForgeClient
from veles_tpu_torch.observe.xla_stats import get_compile_tracker
from veles_tpu_torch.ops.paged_attention import paged_attend
from veles_tpu_torch.ops.quant import int8_matmul
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import GenerateAPI
stamps["imported"] = time.time()
dest, manifest = ForgeClient(args["forge"]).fetch(
    args["name"], version=args["version"], dest=args["dest"])
stamps["fetched"] = time.time()
root.common.serve.aot = os.path.join(dest, next(
    name for name in manifest["artifacts"] if name.endswith(".aot.tar")))
# the checkpoint is assembled against a tree of the model's structure:
# its depth and dtype, not its widths
like = init_transformer_params(numpy.random.RandomState(0), args["blocks"],
                               8, 2, 8, dtype=torch.bfloat16, device="cpu")
with open(os.path.join(dest, manifest.get("weights", "weights.npz")),
          "rb") as fin:
    params, table = load_serving_checkpoint(
        fin.read(), like, torch.empty(8, 8, dtype=torch.bfloat16))
device = torch.device(args["device"])
params = tree_to(params, device, torch.float32)
table = table.to(device=device, dtype=torch.float32)
if device.type == "cuda":
    torch.cuda.synchronize()
stamps["weights"] = time.time()
api = GenerateAPI(params, table, args["heads"], device=device,
                  **args["serve"]).start()
stamps["booted"] = time.time()
# one short request through its own front: the card's first launches
# (library loads, handles) are paid here, not by the router's baseline
req = urllib.request.Request(
    "http://127.0.0.1:%d/generate" % api.port, data=json.dumps(
        {"tokens": list(range(1, 9)), "n_tokens": 2}).encode(),
    headers={"Content-Type": "application/json"})
urllib.request.urlopen(req, timeout=300).read()
stamps["warm"] = time.time()
print("REPLICA " + json.dumps({"port": api.port, "stamps": stamps}),
      flush=True)
for line in sys.stdin:
    if line.strip() == "report":
        aot = api.decoder.aot
        print("REPLICA " + json.dumps({
            "builds": {name: n for name, n in get_compile_tracker()
                       .snapshot()["compiles"].items()
                       if name.endswith(".cu")},
            "aot": None if aot is None else aot.stats(),
            "launches": {"paged_attend": paged_attend.launches,
                         "int8_matmul": int8_matmul.launches}}),
              flush=True)
        break
api.stop()
os._exit(0)
"""


#: phase 26's forge: a ForgeServer on 127.0.0.1, and the packages packed
#: and uploaded over HTTP beside phases 23-25, at a lower CPU priority
#: (os.nice) so their gzip takes from those phases as little as it can:
#: version 1.0 (the replicas' bundle and phase 25's checkpoint, bf16
#: leaves), 1.1 (the int8 tier's weights drawn from seed 1 and quantized,
#: for the rollout) and a tampered package (1.0's bundle with one byte
#: flipped after its sidecar was written). Serves until stdin closes.
SERVE_FLEET_FORGE_CHILD = r"""
import hashlib, json, os, shutil, sys, threading, time
args = json.loads(sys.argv[1])
os.nice(10)
threading.Timer(args["deadline_s"], lambda: os._exit(3)).start()
import numpy
import torch
from veles_tpu_torch.aot.cli import stage_into_package
from veles_tpu_torch.deploy_cli import save_serving_checkpoint
from veles_tpu_torch.forge import ForgeClient, ForgeServer
from veles_tpu_torch.forge.package import MANIFEST, pack
from veles_tpu_torch.parallel.decode import quantize_params
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
top = args["dir"]
server = ForgeServer(os.path.join(top, "store"),
                     token=args["token"]).start()
print("FORGE " + json.dumps({"port": server.port}), flush=True)
client = ForgeClient("http://127.0.0.1:%d" % server.port,
                     token=args["token"])


def package(version, params, table, bundle=None):
    directory = os.path.join(top, "pkg-" + version)
    os.makedirs(directory)
    with open(os.path.join(directory, "serve.py"), "w") as fout:
        fout.write("# the serving model's checkpoint and programs\n")
    weights = os.path.join(directory, "weights.npz")
    with open(weights, "wb") as fout:
        save_serving_checkpoint(fout, params, table)
    with open(weights, "rb") as fin:
        digest = hashlib.sha256(fin.read()).hexdigest()
    with open(weights + ".sha256", "w") as fout:
        fout.write("%s  weights.npz\n" % digest)
    with open(os.path.join(directory, MANIFEST), "w") as fout:
        json.dump({"name": args["name"], "version": version,
                   "workflow": "serve.py",
                   "short_description": "the serving model at full width",
                   "artifacts": ["weights.npz"]}, fout)
    if bundle is not None:
        stage_into_package(bundle, directory)
    return directory


def tampered():
    directory = os.path.join(top, "tampered")
    os.makedirs(directory)
    name = os.path.basename(args["bundle"])
    for member in (MANIFEST, "serve.py", name, name + ".sha256"):
        shutil.copy(os.path.join(top, "pkg-1.0", member), directory)
    with open(os.path.join(directory, MANIFEST)) as fin:
        manifest = json.load(fin)
    manifest.update(version="1.9", artifacts=[name])
    with open(os.path.join(directory, MANIFEST), "w") as fout:
        json.dump(manifest, fout)
    with open(os.path.join(directory, name), "r+b") as fout:
        fout.seek(-1, os.SEEK_END)
        last = fout.read(1)
        fout.seek(-1, os.SEEK_END)
        fout.write(bytes([last[0] ^ 1]))
    return pack(directory, os.path.join(top, "tampered.tgz"))[0]


params, table = torch.load(args["model"], map_location="cpu")
t0 = time.time()
client.upload(package("1.0", params, table, bundle=args["bundle"]))
done = {"upload_s_1.0": time.time() - t0}
print("FORGE " + json.dumps({"stored": "1.0"}), flush=True)
t0 = time.time()
w = args["widths"]
green = init_transformer_params(
    numpy.random.RandomState(args["green_seed"]), w["blocks"], w["embed"],
    w["heads"], w["vocab"], dtype=torch.bfloat16, device="cpu")
client.upload(package("1.1", quantize_params(green), table))
done.update({"upload_s_1.1": time.time() - t0, "stored": "1.1",
             "tampered": tampered()})
print("FORGE " + json.dumps(done), flush=True)
sys.stdin.read()
server.stop()
os._exit(0)
"""


class FleetChild:
    """A phase-26 child (a replica, or the forge) running ``script`` from
    the package copy in ``directory`` (only it on the path); stdin is its
    control pipe, its stdout lines starting with ``prefix`` are JSON
    (a reader thread queues them), its stderr a file there."""

    def __init__(self, script, args, directory, prefix="REPLICA "):
        import queue

        self.err = open(os.path.join(directory, "child.err"), "w+")
        self.popen = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, json.dumps(args)],
            cwd=directory, env=dict(os.environ, PYTHONPATH=directory),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.err, text=True)
        self.lines = queue.Queue()

        def read():
            for text in self.proc.stdout:
                if text.startswith(prefix):
                    self.lines.put(json.loads(text[len(prefix):]))
            self.lines.put(None)   # the child closed its stdout

        threading.Thread(target=read, name="phase-26-reader",
                         daemon=True).start()

    def line(self, deadline):
        """The child's next JSON line; fails at ``deadline``
        (time.time()) or once the child closed its stdout."""
        import queue

        try:
            got = self.lines.get(timeout=max(0.0, deadline - time.time()))
        except queue.Empty:
            got = None
        if got is None:
            self.err.seek(0)
            raise AssertionError("a phase 26 child gave no line (exit "
                                 "%s):\n%s" % (self.proc.poll(),
                                               self.err.read()[-4000:]))
        return got

    def report(self, deadline):
        self.proc.stdin.write("report\n")
        self.proc.stdin.flush()
        return self.line(deadline)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.err.close()


def serve_fleet_prompts():
    """Phase 4's shared-prompt traffic (a two-page system prompt, eight
    tails behind it, the system prompt twice more) and six distinct
    prompts, one list."""
    shared = [prompt for wave in prefix_waves(numpy.random.RandomState(2))
              for prompt in wave]
    rng = numpy.random.RandomState(26)
    return shared, [rng.randint(0, VOCAB, n).tolist()
                    for n in (40, 100, 180, 300, 450, 700)]


def serve_fleet_prepare(device, early):
    """Phase 26's forge and packages, made before phase 23 so that their
    gzip runs beside phases 23-25: in this process the replicas' bundle
    (the paged float tier on f32 weights, this process's libraries), then
    the forge child (:data:`SERVE_FLEET_FORGE_CHILD`) in ``early``'s
    directory. Returns the state :func:`serve_fleet_start` and
    :func:`serve_fleet_phase` take."""
    from veles_tpu_torch.aot.artifact import build_serving_bundle
    from veles_tpu_torch.device import tree_to

    t0 = time.perf_counter()
    tmp, model, _ = early
    state = {"dir": os.path.join(tmp, "fleet")}
    os.makedirs(state["dir"])
    params, table = torch.load(model, map_location="cpu")
    bundle = os.path.join(state["dir"], "replica.aot.tar")
    build_serving_bundle(tree_to(params, device, torch.float32),
                         table.to(device=device, dtype=torch.float32),
                         HEADS, bundle, device=device,
                         **aot_serve_kwargs(*SERVE_FLEET_TIER))
    del params, table
    state["forge"] = FleetChild(SERVE_FLEET_FORGE_CHILD, {
        "dir": state["dir"], "token": "phase-26", "model": model,
        "bundle": bundle, "name": SERVE_FLEET_PACKAGE,
        "green_seed": SERVE_FLEET_GREEN_SEED,
        "widths": {"blocks": BLOCKS, "embed": EMBED, "heads": HEADS,
                   "vocab": VOCAB},
        "deadline_s": SERVE_FLEET_FORGE_DEADLINE},
        package_copy(os.path.join(state["dir"], "forge")), prefix="FORGE ")
    print("phase 26 prepared in %.1f s; its packages pack beside phases "
          "23-25" % (time.perf_counter() - t0))
    return state


def serve_fleet_start(state, device):
    """Phase 26 (a)'s replicas, started beside phase 25's children once
    version 1.0 is in the forge: each fetches and unpacks the package
    into its own directory and boots from its bundle."""
    deadline = time.time() + 600
    state["url"] = "http://127.0.0.1:%d" % state["forge"].line(
        deadline)["port"]
    assert state["forge"].line(deadline) == {"stored": "1.0"}
    state["replicas"] = []
    for i in range(SERVE_FLEET_REPLICAS):
        directory = package_copy(os.path.join(state["dir"],
                                              "replica-%d" % i))
        state["replicas"].append(FleetChild(SERVE_FLEET_REPLICA_CHILD, {
            "forge": state["url"], "name": SERVE_FLEET_PACKAGE,
            "version": "1.0", "dest": os.path.join(directory, "pkg"),
            "blocks": BLOCKS, "heads": HEADS,
            "serve": aot_serve_kwargs(*SERVE_FLEET_TIER),
            "device": device.type, "deadline_s": SERVE_FLEET_CHILD_DEADLINE},
            directory))


def serve_fleet_tamper_upload(state):
    """(a): the tampered package is refused at upload with 422, and
    nothing is stored."""
    with open(state["tampered"], "rb") as fin:
        blob = fin.read()
    req = urllib.request.Request(
        state["url"] + "/upload", data=blob,
        headers={"X-Forge-Token": "phase-26",
                 "Content-Type": "application/octet-stream"})
    try:
        urllib.request.urlopen(req, timeout=60)
        raise AssertionError("the tampered package was stored")
    except urllib.error.HTTPError as err:
        err.read()
        assert err.code == 422, err.code
    from veles_tpu_torch.forge import ForgeClient

    versions = ForgeClient(state["url"]).details(
        SERVE_FLEET_PACKAGE)["versions"]
    assert sorted(versions) == ["1.0", "1.1"], sorted(versions)


def route_post(url, tokens):
    """POST through the router: (status, body, the serving replica)."""
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(
            {"tokens": tokens, "n_tokens": SERVE_FLEET_N_TOKENS}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read().decode()), \
                resp.headers.get("X-Veles-Replica")
    except urllib.error.HTTPError as err:
        with err:
            return err.code, json.loads(err.read().decode() or "{}"), None


def serve_fleet_route(state, run_dir):
    """(b): the router over the three replicas, its replica 0 the shared
    prompt's affinity owner; a fault-free baseline; six clients of six
    rounds with replica 0 SIGKILLed (``ReplicaChaosMonkey``) while it
    holds a lease. Every reply 200 and its tokens the baseline's; the
    plane's transitions and the incident name replica 0; the router's
    /metrics count a failover and affinity hits; a request after the
    death answers its baseline. Returns the readings."""
    from veles_tpu_torch.router import HashRing, build_router, prefix_key
    from veles_tpu_torch.serving_chaos import (REPLICA_GOODPUT_SERIES,
                                               ReplicaChaosConfig,
                                               ReplicaChaosMonkey)

    shared, distinct = serve_fleet_prompts()
    prompts = shared + distinct
    urls = ["127.0.0.1:%d" % ready["port"] for ready in state["ready"]]
    owner = HashRing(urls).owners(prefix_key(shared[0], PAGE))[0]
    order = sorted(range(len(urls)), key=lambda i: urls[i] != owner)
    replicas = [state["replicas"][i] for i in order]
    history = MetricHistory(
        registry=get_metrics_registry(), interval_s=0.2,
        incidents=IncidentRecorder(cooldown_s=0.0, directory=run_dir))
    set_metric_history(history)
    min_eval, servescope_mod.MIN_EVAL_TOKENS = (
        servescope_mod.MIN_EVAL_TOKENS, 1 << 62)
    router = None
    readings = {}
    try:
        plane, router = build_router(["http://" + urls[i] for i in order],
                                     spec=ROUTER_SPEC)
        router.start()
        front = "http://127.0.0.1:%d" % router.port
        baseline = {}
        t0 = time.perf_counter()
        for prompt in prompts:
            status, body, _ = route_post(front, prompt)
            assert status == 200, body
            baseline[tuple(prompt)] = body["tokens"]
        readings["fault_free_rps"] = len(prompts) / (time.perf_counter()
                                                     - t0)
        monkey = ReplicaChaosMonkey(ReplicaChaosConfig(kill_at=1,
                                                       kill_index=0))
        results, errors, lock = [], [], threading.Lock()

        def pound(k):
            for r in range(SERVE_FLEET_ROUNDS):
                prompt = prompts[(k * SERVE_FLEET_ROUNDS + r) % len(prompts)]
                try:
                    got = route_post(front, prompt)
                except Exception as exc:   # noqa: BLE001 - counted
                    with lock:
                        errors.append(repr(exc))
                    continue
                with lock:
                    results.append((tuple(prompt),) + got)

        threads = [threading.Thread(target=pound, args=(k,))
                   for k in range(SERVE_FLEET_CLIENTS)]
        t0 = time.perf_counter()
        for thread in threads:
            thread.start()
        for tick in range(2):
            for action, index in monkey.actions(tick):
                assert action == "kill"
                wait_for(lambda: plane.replicas[index].leases > 0, 60,
                         "a lease on replica %d" % index)
                replicas[index].proc.send_signal(signal.SIGKILL)
        for thread in threads:
            thread.join(300)
        readings["under_kill_rps"] = len(results) / (time.perf_counter()
                                                     - t0)
        assert not any(thread.is_alive() for thread in threads)
        assert errors == [], errors
        assert len(results) == SERVE_FLEET_CLIENTS * SERVE_FLEET_ROUNDS
        for prompt, status, body, _ in results:
            assert status == 200, (status, body)
            assert body["tokens"] == baseline[prompt], \
                "a failover reply differs from the baseline"
        assert monkey.counters["kills"] == 1
        dead = plane.replicas[0].name
        wait_for(lambda: plane.find(dead).state == "dead", 30,
                 "the plane to name the dead replica")
        entry = next(t for t in plane.transitions
                     if t["action"] == "replica_dead")
        assert entry["replica"] == dead, entry
        wait_for(lambda: history.incidents.last_doc is not None, 30,
                 "the incident")
        leading = history.incidents.last_doc["leading_indicator"]
        assert leading["series"] == REPLICA_GOODPUT_SERIES, leading
        assert ["replica", dead] in leading["labels"], leading
        status, body, served = route_post(front, shared[0])
        assert status == 200 and served != dead
        assert body["tokens"] == baseline[tuple(shared[0])]
        text = scrape(router.port)
        failovers = sample(text, "veles_router_failovers_total")
        hits = sample(text, "veles_router_affinity_hits_total")
        assert failovers and failovers >= 1, failovers
        assert hits and hits > 0, hits
        failover_ms = router.failover_ms_samples()
        readings.update(
            failovers=failovers, affinity_hits=hits,
            affinity_misses=sample(text,
                                   "veles_router_affinity_misses_total"),
            failover_ms_p50=statistics.median(failover_ms)
            if failover_ms else None,
            failover_ms_max=max(failover_ms) if failover_ms else None,
            dead=dead, transitions=[(t["action"], t["replica"])
                                    for t in plane.transitions])
    finally:
        if router is not None:
            router.stop()
        set_metric_history(None)
        servescope_mod.MIN_EVAL_TOKENS = min_eval
    return replicas, readings


def serve_fleet_rollout(device, state, tampered):
    """(c): ``python -m veles_tpu_torch deploy rollout serving-fleet@1.1
    --forge-url URL`` into a GenerateAPI of this process (the paged int8
    tier, K1 and K2): exit 0 and promoted, every stream after it equal to
    a fresh api's on the new weights; a second rollout while one is in
    flight exits 4 and the tampered package 3, the live streams
    unchanged by both. Returns (the launches, the readings)."""
    from veles_tpu_torch.__main__ import main as cli_main
    from veles_tpu_torch.deploy_cli import load_serving_checkpoint

    params, table = bf16_model(device)
    shared, distinct = serve_fleet_prompts()
    prompts = [shared[0], shared[3]] + distinct[:3]
    kwargs = dict(aot_serve_kwargs("int8", True),
                  n_tokens=SERVE_FLEET_N_TOKENS)
    saved = {key: root.common.serve.rollout.get(key, None)
             for key in SERVE_FLEET_ROLLOUT}
    for key, value in SERVE_FLEET_ROLLOUT.items():
        setattr(root.common.serve.rollout, key, value)
    tenants = ["tenant-%d" % i for i in range(1000)]
    green_t = next(t for t in tenants if hash_point(t) < ROLLOUT_STEPS[0])
    blue_t = next(t for t in tenants if hash_point(t) >= ROLLOUT_STEPS[0])
    api = GenerateAPI(params, table, HEADS, device=device, **kwargs).start()
    readings = {}
    try:
        # the second pass: every prompt's pages in the prefix cache, as
        # they stay for the checks below (a tail or hit admission need
        # not be bit-equal to a cold one)
        before = [post(api.port, p, SERVE_FLEET_N_TOKENS)
                  for p in prompts + prompts][len(prompts):]
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        code = cli_main(["deploy", "rollout", SERVE_FLEET_PACKAGE + "@1.1",
                         "--forge-url", state["url"]])
        readings["deploy_s"] = time.perf_counter() - t0
        assert code == 0, code
        rollout = api._rollout
        assert rollout is not None and rollout.state == "shifting"
        assert rollout.version == SERVE_FLEET_PACKAGE + "@1.1"
        t1 = time.perf_counter()
        refusals = (cli_main(["deploy", "rollout",
                              SERVE_FLEET_PACKAGE + "@1.1",
                              "--forge-url", state["url"]]),
                    cli_main(["deploy", "rollout", tampered]))
        readings["refusals_s"] = time.perf_counter() - t1
        assert refusals == (4, 3), refusals
        assert [tenant_post(api.port, p, blue_t) for p in prompts] \
            == before, "a refusal changed the live streams"
        deadline = time.monotonic() + 90
        while rollout.state not in ("promoted", "rolled_back") \
                and time.monotonic() < deadline:
            for tenant in (green_t, blue_t):
                tenant_post(api.port, prompts[0], tenant)
        readings["promoted_s"] = time.perf_counter() - t0
        readings["ramp_s"] = time.perf_counter() - t1 \
            - readings["refusals_s"]
        assert rollout.state == "promoted", rollout.snapshot()
        assert api.version == SERVE_FLEET_PACKAGE + "@1.1"
        got = [post(api.port, p, SERVE_FLEET_N_TOKENS)
               for p in prompts + prompts][len(prompts):]
        launches = counts()
        like = (api.decoder.params, api.decoder.embed_table)
    finally:
        api.stop()
        for key, value in saved.items():
            setattr(root.common.serve.rollout, key, value)
    # a fresh api on the package's weights (the file the forge packed)
    with open(os.path.join(state["dir"], "pkg-1.1", "weights.npz"),
              "rb") as fin:
        green, table = load_serving_checkpoint(fin.read(), *like)
    del like
    after = fixed_streams(green, table, prompts, kwargs, device)
    assert got == after, "the promoted streams differ from a fresh api's " \
                         "on the new weights"
    assert launches["paged_attend"] > 0 and launches["int8_matmul"] > 0, \
        launches
    return launches, readings


def tenant_post(port, tokens, tenant):
    """One POST of SERVE_FLEET_N_TOKENS tokens as ``tenant``; returns
    them."""
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port, data=json.dumps(
            {"tokens": tokens, "n_tokens": SERVE_FLEET_N_TOKENS}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Veles-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read().decode())["tokens"]


def fixed_streams(params, table, prompts, kwargs, device):
    """Each prompt alone through a fresh api, twice: the second pass's
    streams (every prompt's pages cached); launches not counted."""
    saved = counts()
    api = GenerateAPI(params, table, HEADS, device=device, **kwargs).start()
    try:
        return [post(api.port, p, kwargs["n_tokens"])
                for p in prompts + prompts][len(prompts):]
    finally:
        api.stop()
        for name, fn in COUNTERS.items():
            fn.launches = saved[name]


def serve_fleet_phase(device, state):
    """Phase 26: the serving fleet and deploys at the serving model's full
    width. (a) The replicas (started by :func:`serve_fleet_start` beside phase
    25) booted from the forge package with no kernel build and no AOT
    miss; a tampered upload refused with 422. (b) The router and a kill
    -9 (:func:`serve_fleet_route`). (c) ``deploy rollout`` into a live api
    (:func:`serve_fleet_rollout`). Returns the launches: the surviving
    replicas' K1 (and K2) and (c)'s K1 and K2."""
    t_phase = time.perf_counter()
    deadline = time.time() + 300
    launches = dict.fromkeys(COUNTERS, 0)
    replicas = state["replicas"]
    try:
        state["ready"] = [rep.line(deadline) for rep in replicas]
        boots = []
        for rep, ready in zip(replicas, state["ready"]):
            stamps = ready["stamps"]
            boots.append(stamps["booted"] - rep.popen)
            print("phase 26 (a) replica on port %d: %.3f s from Popen to "
                  "serving (imports %.3f, fetch and unpack %.3f, weights "
                  "%.3f, boot %.3f), then a warm-up request %.3f" % (
                      ready["port"], boots[-1],
                      stamps["imported"] - rep.popen,
                      stamps["fetched"] - stamps["imported"],
                      stamps["weights"] - stamps["fetched"],
                      stamps["booted"] - stamps["weights"],
                      stamps["warm"] - stamps["booted"]))
        state.update(state["forge"].line(deadline))
        assert state["stored"] == "1.1", state
        serve_fleet_tamper_upload(state)
        with tempfile.TemporaryDirectory() as run_dir:
            ordered, readings = serve_fleet_route(state, run_dir)
        survivors = [rep for rep in ordered[1:]]
        for rep in survivors:
            report = rep.report(deadline)
            stats = report["aot"]
            assert not report["builds"], report["builds"]
            assert stats is not None and not stats["misses"], stats
            assert sum(stats["hits"].values()) > 0, stats
            assert set(stats["libraries"].values()) == {"bundle"}, stats
            assert report["launches"]["paged_attend"] > 0, report
            for name, n in report["launches"].items():
                launches[name] += n
        print("phase 26 (a) replicas: %d booted from %s@1.0, the survivors "
              "0 builds and no AOT miss, launches %s; the tampered upload "
              "422, nothing stored" % (
                  len(replicas), SERVE_FLEET_PACKAGE,
                  json.dumps({k: v for k, v in launches.items() if v},
                             sort_keys=True)))
        print("phase 26 (b) the router over %d replicas, %s killed: %d "
              "replies 200 and bit-equal to the baseline; transitions %s; "
              "%s failovers, %s affinity hits, %s misses" % (
                  len(replicas), readings["dead"],
                  SERVE_FLEET_CLIENTS * SERVE_FLEET_ROUNDS,
                  json.dumps(readings["transitions"]),
                  readings["failovers"], readings["affinity_hits"],
                  readings["affinity_misses"]))
        got, rollout = serve_fleet_rollout(device, state, state["tampered"])
        for name, n in got.items():
            launches[name] += n
        print("phase 26 (c) deploy rollout %s@1.1: exit 0 in %.3f s "
              "(fetch, verify, load, green build and probe), promoted "
              "%.3f s after it began (the ramp %.3f s), streams equal to a "
              "fresh api's on the new weights; refusals 4 (in flight) and "
              "3 (tampered) in %.3f s left the live streams unchanged; "
              "launches K1 %d, K2 %d" % (
                  SERVE_FLEET_PACKAGE, rollout["deploy_s"],
                  rollout["promoted_s"],
                  rollout["ramp_s"], rollout["refusals_s"],
                  got["paged_attend"], got["int8_matmul"]))
        print("phase 26 readings (no gate): replica boot s %s; requests/s "
              "through the router %.3f fault-free, %.3f under the kill; "
              "failover ms p50 %s, max %s; upload s %s; %s" % (
                  json.dumps([round(b, 3) for b in boots]),
                  readings["fault_free_rps"], readings["under_kill_rps"],
                  readings["failover_ms_p50"], readings["failover_ms_max"],
                  json.dumps({k: round(v, 3) for k, v in state.items()
                              if k.startswith("upload_s_")},
                             sort_keys=True), card_line()))
    finally:
        for child in replicas + [state["forge"]]:
            child.kill()
    print("phase 26: %.1f s; %s" % (time.perf_counter() - t_phase,
                                    card_line()))
    return launches


# -- phase 27: sharded serving, two ranks sharing the card ------------------

#: the serving mesh's size and rank 0's world timeout (seconds: each of
#: its collectives and its rendezvous)
TP_RANKS, TP_TIMEOUT = 2, 30
#: seconds the follower child may live
TP_DEADLINE = 600
#: the decode step's K2 shapes on a rank of the model=2 mesh: qkv of its
#: 8 heads, the out-projection's rows of them, its FFN columns and rows,
#: its vocab columns of the head
TP_K2_SHAPES = ((EMBED, 3 * EMBED // TP_RANKS),
                (EMBED // TP_RANKS, EMBED),
                (EMBED, 4 * EMBED // TP_RANKS),
                (4 * EMBED // TP_RANKS, EMBED),
                (EMBED, VOCAB // TP_RANKS))
#: (b)'s bf16 tiers: (label, quantize, paged, its attend's counter)
TP_TIERS = (("paged int8", "int8", True, "paged_attend"),
            ("paged int8-KV", "int8-kv", True, "paged_attend_int8"),
            ("dense int8-KV", "int8-kv", False, "int8_cache_attend"))
#: (b): the logits after a prefill against the single process's, as a
#: share of the largest: the ranks' partial products reduce in f32 and
#: round once to bf16, where one process rounds its whole product once;
#: a bf16 step is 2^-8 of a value and four blocks compound it
TP_BF16_LOGIT_RTOL = 5e-2
#: (b): a stream may leave the single process's only at a step where the
#: single process's top-2 logits lie within this many bf16 steps
TP_BF16_STEPS = 2
#: (d): make_tp_generate's prompt (rows, positions) and tokens
TP_GEN_SHAPE, TP_GEN_TOKENS = (2, 64), 16
#: (e): the governor's walk over the mesh, the burn each move is driven
#: by and the tier it lands on (phase 21's ladder: demote at a burn of 2,
#: promote at 1, one move a cooldown); over gloo a mesh request's TTFT
#: sits well past phase 21's ttft objective, so the burn is scripted
#: (TpBurnSLO) rather than raised by a latency ramp
TP_LADDER = ((3.0, "int8"), (3.0, "int8-kv"), (0.5, "int8"),
             (0.5, "bf16"))
TP_LADDER_COOLDOWN_S = 1.0
#: (e)-(g): each rung's traffic, three of the distinct prompts one at a
#: time; (f) the rollout to seed-1 weights at one rung (every request
#: green's), promoted at its first verdict; (g) a rollout to seed-2
#: weights whose green probe is planted to fail; with every request
#: green's there is no blue TTFT to hold green's against, so the TTFT
#: predicate's floor sits past any mesh request's (a mesh TTFT over gloo
#: reads 0.1-1 s, past the default floor's 3 x 20 ms)
TP_GOV_PROMPTS = 3
TP_ROLLOUT = RolloutConfig(steps=(1.0,), hold_s=0.0, cooldown_s=0.0,
                           min_requests=1, interval_s=0.05,
                           ttft_floor_s=60.0)


class TpBurnSLO:
    """(e)'s SLO engine: the burn the governor reads, set by the phase
    (None: no signal, the tier holds)."""
    burn = None

    def summary(self):
        if self.burn is None:
            return None
        return {"burn_rate": self.burn, "objective": "ttft_p95_ms",
                "window": "scripted"}

    def record(self, **kwargs):
        pass

    def publish(self, registry):
        pass

    def version_burn(self, version, now=None):
        return None


class TpProbeFault:
    """(g)'s chaos hook: once armed, the next probe decode (a probe passes
    no decoder) raises before its first dispatch is handed on."""
    armed = False

    def before_step(self, decoder=None):
        if decoder is None and self.armed:
            self.armed = False
            raise RuntimeError("planted green probe fault")

    def maybe_poison_swap(self, params):
        return params

#: rank 1 of phase 27: a fresh process on the same card that builds the
#: same seeded weights and follows rank 0 (this process) through every
#: stream of the phase, writing its launches and hand-off stats after
#: each; it is SIGKILLed in (e)
TP_FOLLOWER = r'''
import json, sys
import numpy, torch
import chip_smoke as cs
from veles_tpu_torch.core.config import root
from veles_tpu_torch.parallel import tp_engine
from veles_tpu_torch.parallel.decode import make_tp_generate
from veles_tpu_torch.parallel.mesh import build_mesh, initialize_distributed
from veles_tpu_torch.serving import GenerateAPI
coordinator, out, cache = sys.argv[1:4]
root.common.engine.pallas_autotune_cache = cache
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
f32 = cs.tp_model(dev, torch.float32)
bf16 = cs.tp_bf16(f32)
# rank 1 waits for rank 0 across its single-process runs: its own
# timeout is the child's deadline, rank 0's the world's TP_TIMEOUT
initialize_distributed(coordinator, cs.TP_RANKS, 1, device="cuda",
                       backend="gloo", timeout=cs.TP_DEADLINE)
mesh = build_mesh(data=1, model=cs.TP_RANKS)
reports = []
# each engine's launches and decode steps (the governor's stream holds
# one engine a rung)
per_engine = {}
_apply = tp_engine.ShardEngine.apply
def counted(self, op, args):
    before = cs.counts()
    try:
        return _apply(self, op, args)
    finally:
        after = cs.counts()
        row = per_engine.setdefault(str(self.engine_id), {
            "quantize": self.config.get("quantize"), "steps": 0,
            "launches": dict.fromkeys(after, 0)})
        for k in after:
            row["launches"][k] += after[k] - before[k]
        if op in ("dispatch", "paged.dispatch"):
            row["steps"] += args["n"]
tp_engine.ShardEngine.apply = counted
def report(label, stats, before):
    after = cs.counts()
    engine = stats.get("engine")
    reports.append({"label": label, "steps": stats.get("steps", 0),
                    "launches": {k: after[k] - before[k] for k in after},
                    "calls": stats.get("calls", {}),
                    "bytes": stats.get("bytes", {}),
                    "wait_s": stats.get("wait_s", 0.0),
                    "apply_s": stats.get("apply_s", 0.0),
                    "engines": stats.get("engines", []),
                    "in_service": getattr(engine, "engine_id", None),
                    "edges": stats.get("edges", []),
                    "per_engine": dict(per_engine)})
    per_engine.clear()
    with open(out, "w") as fout:
        json.dump(reports, fout)
def api_stream(label, params, table):
    before = cs.counts()
    api = GenerateAPI(params, table, cs.HEADS, device=dev, mesh=mesh).start()
    report(label, api.follow_stats, before)
def follow_stream(label, params, table):
    before = cs.counts()
    report(label, tp_engine.follow(mesh, params, table, cs.HEADS,
                                   device=dev), before)
api_stream("a", *f32)
api_stream("a-timed", *f32)
for tier in cs.TP_TIERS:
    follow_stream(tier[0], *bf16)
follow_stream("swap", *f32)
before = cs.counts()
run = make_tp_generate(mesh, cs.HEADS, cs.TP_GEN_TOKENS, device=dev)
tokens = run(f32[0], f32[1], cs.tp_gen_prompt())
report("generate", {"tokens": tokens.tolist()}, before)
reports[-1]["tokens"] = tokens.tolist()
with open(out, "w") as fout:
    json.dump(reports, fout)
api_stream("governor", *f32)
api_stream("kill", *f32)
'''


def tp_model(device, dtype, seed=0):
    """The serving model at full width from ``seed`` in ``dtype``, the
    table drawn after the weights as ``bf16_model`` draws it."""
    rng = numpy.random.RandomState(seed)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     dtype=dtype, device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(
            device=device, dtype=dtype)
    return params, table


def tp_bf16(model):
    """``bf16_model``'s weights cast from ``tp_model``'s f32 ones: the same
    draws, the same values, one draw fewer."""
    params, table = model
    return tree_to(params, table.device, dtype=torch.bfloat16), \
        table.to(torch.bfloat16)


def tp_gen_prompt():
    return numpy.random.RandomState(11).randint(0, VOCAB, TP_GEN_SHAPE)


def tp_distinct():
    """The six distinct prompts of (a) and (b): 60 to 700 tokens."""
    rng = numpy.random.RandomState(12)
    return [rng.randint(0, VOCAB, n).tolist()
            for n in numpy.linspace(60, 700, 6).astype(int)]


def tp_kernel_checks(device, gen):
    """The kernels at a rank's shapes: K2 at every shard shape of the
    decode step (M = 8, bf16 x), K1, K3 and K4 in 8 heads of 64, each
    against its plain version. Returns the largest error by kernel."""
    errs = {}
    worst = 0.0
    for k, n in TP_K2_SHAPES:
        w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
        q, scale = quantize_int8(w)
        x = torch.randn((SLOTS, k), generator=gen,
                        device=device).to(torch.bfloat16)
        out = int8_matmul(x, q, scale)
        ref = _int8_matmul_plain(x, q, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs().max().item()
        rel = diff / ref.float().abs().max().item()
        if not rel <= K2_RTOL:
            raise AssertionError("K2 at the shard shape (%d, %d): relative "
                                 "error %.3g" % (k, n, rel))
        worst = max(worst, diff)
    errs["int8_matmul"] = worst
    heads = HEADS // TP_RANKS
    errs["paged_attend"] = k1_check(k1_problem(device, gen, heads=heads,
                                               head_dim=EMBED // HEADS),
                                    " (a rank's 8 heads)")
    errs["paged_attend_int8"] = k3_check("a rank's 8 heads", k3_problem(
        device, gen, torch.bfloat16, heads=heads,
        head_dim=EMBED // HEADS))
    q, slab = k4_problem(device, gen, torch.bfloat16, heads=heads,
                         head_dim=EMBED // HEADS)
    mask = k4_masks(device, K4_WIDTH)["per-row"]
    out = int8_cache_attend(q, *slab, mask, use_pallas=True)
    ref = _cache_attend_plain(q, *slab, mask)
    torch.cuda.synchronize()
    errs["int8_cache_attend"] = (out - ref).abs().max().item()
    if not errs["int8_cache_attend"] <= K4_ATOL:
        raise AssertionError("K4 in a rank's 8 heads disagrees")
    print("phase 27 kernels at a rank's shapes: K2 at %s, max_abs_err "
          "%.3g; K1 %.3g, K3 %.3g, K4 %.3g in 8 heads of 64"
          % (list(TP_K2_SHAPES), errs["int8_matmul"],
             errs["paged_attend"], errs["paged_attend_int8"],
             errs["int8_cache_attend"]))
    return errs


def bf16_step(value):
    """One bf16 step at ``value``: 2^-7 of its binade's base."""
    return 2.0 ** (math.floor(math.log2(max(abs(value), 1e-30))) - 7)


def tp_divergence(label, prompt, single, mesh, logits_at, gap_ok):
    """Where ``mesh`` leaves ``single`` (one request's streams): None when
    they are equal; else the first differing step i, which must be one
    where the single process's top-2 logits lie within ``gap_ok(top1,
    gap)``. ``logits_at(i)`` gives ``(logits of step i, own)``: ``own`` is
    False where a reference decode's logits stand in and its stream left
    the single process's before step i (then nothing is checked). Prints
    every case."""
    if mesh == single:
        return None
    i = next(j for j, (a, b) in enumerate(zip(mesh, single)) if a != b)
    logits, own = logits_at(i)
    top2 = torch.topk(logits.float(), 2).values.tolist()
    gap = top2[0] - top2[1]
    print("  %s: a %d-token prompt leaves the single process at step %d: "
          "its top-2 logits %.6g and %.6g (gap %.3g)%s"
          % (label, len(prompt), i, top2[0], top2[1], gap,
             "" if own else "; the reference decode left it earlier"))
    if own and not gap_ok(top2[0], gap):
        raise AssertionError("%s: the stream diverged at step %d where the "
                             "single process's top-2 gap is %.3g"
                             % (label, i, gap))
    return i


def tp_reference(params, table, prompt, single, device):
    """``logits_at`` of :func:`tp_divergence` from an f32 ``generate`` of
    ``prompt`` in one process (run only where a stream diverged), its own
    where its stream is the single process's ``single`` so far."""
    def at(i):
        tokens, _, logits = generate(params, table, numpy.asarray(
            prompt)[None], HEADS, N_TOKENS, return_logits=True,
            device=device)
        return logits[0, i], tokens[0, :i].tolist() == single[:i]
    return at


def tp_start_follower():
    """Start rank 1 (TP_FOLLOWER) on a fresh rendezvous, in a directory of
    its own; returns the directory, the process, its log, its report path
    and the coordinator."""
    directory = tempfile.mkdtemp(prefix="tp_phase_")
    script = os.path.join(directory, "tp_follower.py")
    with open(script, "w") as fout:
        fout.write(TP_FOLLOWER)
    coordinator = "127.0.0.1:%d" % free_port()
    report = os.path.join(directory, "tp_follower.json")
    log = open(os.path.join(directory, "tp_follower.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, script, coordinator, report,
         str(root.common.engine.pallas_autotune_cache)],
        cwd=REPO_DIR, env=port_env(), stdout=log, stderr=subprocess.STDOUT)
    return directory, proc, log, report, coordinator


def tp_reports(path, label, proc=None):
    """Rank 1's report of stream ``label``, once it wrote it (after the
    stream's end event); fails when rank 1 died first."""
    deadline = time.monotonic() + TP_TIMEOUT
    while True:
        try:
            with open(path) as fin:
                got = [r for r in json.load(fin) if r["label"] == label]
            if got:
                return got[0]
        except (OSError, ValueError):
            pass
        if time.monotonic() > deadline or (proc is not None
                                           and proc.poll() is not None):
            raise AssertionError("rank 1 reported no %r stream" % label)
        time.sleep(0.05)


def tp_rank_launches(label, rank0, steps0, rank1, attend, quantized):
    """Each rank's launches in one stream: its attend kernel 4 a decode
    step (BLOCKS), K2 at least 17 a step in an int8 tier."""
    for rank, got, steps in ((0, rank0, steps0),
                             (1, rank1["launches"], rank1["steps"])):
        if steps < 1 or got[attend] != BLOCKS * steps:
            raise AssertionError(
                "%s rank %d: %s launched %d in %d decode steps, not %d a "
                "step" % (label, rank, attend, got[attend], steps, BLOCKS))
        if quantized and got["int8_matmul"] < sum(K2_PER_STEP) * steps:
            raise AssertionError("%s rank %d: K2 %d < %d a step"
                                 % (label, rank, got["int8_matmul"],
                                    sum(K2_PER_STEP)))
    print("  %s launches: rank 0 %s %d and K2 %d in %d steps, rank 1 %s %d "
          "and K2 %d in %d steps" % (
              label, attend, rank0[attend], rank0["int8_matmul"], steps0,
              attend, rank1["launches"][attend],
              rank1["launches"]["int8_matmul"], rank1["steps"]))


def tp_steps(decoder):
    """The decode steps a decoder dispatched: its chunks' and single
    steps'."""
    return decoder.dispatch_counts["chunk"] * CHUNK \
        + decoder.dispatch_counts["step"]


def tp_cost_line(label, dec, wall, tokens):
    """The hand-off and collective costs of a mesh decoder's stream."""
    stats = dec.tp_stats()
    calls, nbytes = stats["handoff"]["calls"], stats["handoff"]["bytes"]
    dispatches = sum(calls.get(op, 0) for op in ("dispatch",
                                                 "paged.dispatch"))
    handed = sum(nbytes.get(op, 0) for op in ("dispatch",
                                              "paged.dispatch"))
    collective_s = sum(row[2] for row in stats["collectives"].values())
    device_s = sum(dec.timings.values())
    print("  %s: %.1f tokens/s over the world, %.0f bytes handed on a "
          "dispatch, collectives %.3f s of rank 0's %.3f s of dispatch, "
          "admission and readback (%.1f%%)"
          % (label, tokens / wall, handed / max(dispatches, 1),
             collective_s, device_s, 100 * collective_s / max(device_s,
                                                               1e-9)))


def tp_alone_logits(params, table, prompts, quantize, device):
    """Each prompt alone through one process's decoder at ``quantize``,
    stepped a token at a time: the logits each token is picked from (the
    near-tie check's reading); the launches are not counted."""
    before = counts()
    dec = ContinuousDecoder(params, table, HEADS, slots=SLOTS,
                            max_len=MAX_LEN, n_tokens=N_TOKENS,
                            quantize=quantize, paged=True, page_size=PAGE,
                            device=device)
    logits = []
    for prompt in prompts:
        rid = dec.submit(prompt)
        dec._admit_pending()
        slot = {r: s for s, r in dec._slot_req.items()}[rid]
        seen = []
        while dec.busy:
            seen.append(dec.state["logits"][slot].clone())
            dec.step()
        dec.results.pop(rid)
        logits.append(seen)
    for name, fn in COUNTERS.items():
        fn.launches = before[name]
    return logits


def tp_rung(api, tier, prompts):
    """One rung's traffic: ``prompts`` posted one at a time; returns the
    streams, rank 0's launches and decode steps over them and the engine
    that served them."""
    before, counts0 = counts(), dict(api.decoder.dispatch_counts)
    streams = []
    for prompt in prompts:
        code, tokens, _ = act_post(api.port, prompt)
        if code != 200:
            raise AssertionError("(e) a %s request answered %d"
                                 % (tier, code))
        streams.append(tokens)
    after, now = counts(), api.decoder.dispatch_counts
    return {"tier": tier, "streams": streams,
            "launches": {k: after[k] - before[k] for k in after},
            "steps": (now["chunk"] - counts0["chunk"]) * CHUNK
            + now["step"] - counts0["step"],
            "engine": api.decoder.engine_id}


def tp_governor(device, mesh, f32, report, proc, clock):
    """Phase 27 (e)-(g) through one GenerateAPI(mesh=, governor=) on f32
    weights, the paged float tier: (e) the governor walks TP_LADDER (bf16
    -> int8 -> int8-kv -> int8 -> bf16), a tier swap a move: each rung's
    streams equal one process's decoder at that tier (the float rungs bit
    for bit, the int8 rungs but at near ties, ROADMAP C), K1 or K3 BLOCKS
    a step and K2 17 a step in the int8 rungs on both ranks (rank 1's by
    engine); (f) a rollout to seed-1 weights (carried by green's build)
    promoted, its streams one process's on them, memscope's promote edge
    no leak on either rank; (g) a rollout whose green probe is planted to
    fail refused, blue's streams unchanged. Rank 1 builds an engine a swap
    and a green, discards each one replaced or refused, and ends with one.
    Returns both ranks' launches."""
    prompts = tp_distinct()[:TP_GOV_PROMPTS]
    slo, chaos = TpBurnSLO(), TpProbeFault()
    governor = ServingGovernor(GovernorConfig(
        demote_burn=2.0, recover_burn=1.0, cooldown_s=TP_LADDER_COOLDOWN_S,
        interval_s=0.05, ladder=("int8", "int8-kv"), breaker_guard=False,
        prewarm=False))
    api = GenerateAPI(*f32, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, device=device, mesh=mesh,
                      governor=governor, slo=slo, chaos=chaos).start()
    new = tp_model(device, torch.float32, seed=1)
    try:
        rungs = [tp_rung(api, "bf16", prompts)]
        for burn, tier in TP_LADDER:
            level = governor.level
            slo.burn = burn
            wait_for(lambda: governor.level != level, 60,
                     "the governor's move to " + tier)
            slo.burn = None
            wait_for(lambda: (api.decoder.quantize or "bf16") == tier
                     and api._tier_request is None, 120,
                     "the swap to " + tier)
            rungs.append(tp_rung(api, tier, prompts))
        clock("(e)")
        started, t_begin = time.perf_counter(), time.time()
        rollout = api.begin_rollout(new[0], version="seed-1",
                                    config=TP_ROLLOUT)
        deadline = time.monotonic() + 120
        while rollout.state != "promoted":
            if time.monotonic() > deadline:
                raise AssertionError("(f) the rollout stayed %s"
                                     % rollout.state)
            act_post(api.port, prompts[-1])
        promote_s = time.perf_counter() - started
        # this promote's edge (phase 21's are in the same scope)
        wait_for(lambda: any(v["edge"] == "rollout_promote"
                             and v["t"] >= t_begin
                             for v in get_memscope().edges), 30,
                 "the rollout_promote edge")
        verdict = [v for v in get_memscope().edges
                   if v["edge"] == "rollout_promote"][-1]
        promoted = tp_rung(api, "promoted", prompts)
        clock("(f)")
        chaos.armed = True
        try:
            api.begin_rollout(tp_model(device, torch.float32, seed=2)[0],
                              version="seed-2")
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        after = tp_rung(api, "after", prompts)
        state = (api.version, api._green is not None, rollout.state)
        swaps = list(api.tier_swaps)
    finally:
        api.stop()
    rank1 = tp_reports(report, "governor", proc)
    launches = collections.Counter()
    moves = [(t["action"], t["tier"]) for t in governor.transitions
             if t["action"] in ("demote", "promote")]
    want_moves = [("demote" if burn > 2.0 else "promote", tier)
                  for burn, tier in TP_LADDER]
    if moves != want_moves:
        raise AssertionError("(e) the governor moved %s, not %s"
                             % (moves, want_moves))
    for rung in rungs:
        tier = rung["tier"]
        quantize = None if tier == "bf16" else tier
        one = fixed_tier_streams(*f32, prompts, quantize, True, device)
        if quantize is None:
            if rung["streams"] != one:
                raise AssertionError("(e) the %s rung's f32 streams left "
                                     "one process's" % tier)
        else:
            logits = tp_alone_logits(*f32, prompts, quantize, device)
            for i, prompt in enumerate(prompts):
                tp_divergence("(e) %s" % tier, prompt, one[i],
                              rung["streams"][i],
                              lambda j, i=i: (logits[i][j], True),
                              lambda top, gap: gap <= TP_BF16_STEPS
                              * bf16_step(top))
        attend = "paged_attend_int8" if tier == "int8-kv" else "paged_attend"
        engine = rank1["per_engine"][str(rung["engine"])]
        if engine["quantize"] != quantize:
            raise AssertionError("(e) rank 1's engine %s serves %s, not %s"
                                 % (rung["engine"], engine["quantize"],
                                    quantize))
        tp_rank_launches("(e) %s" % tier, rung["launches"], rung["steps"],
                         engine, attend, quantize is not None)
        for name, n in rung["launches"].items():
            launches[name] += n
    for engine in rank1["per_engine"].values():
        for name, n in engine["launches"].items():
            launches[name] += n
    want = fixed_tier_streams(new[0], f32[1], prompts, None, True, device)
    calls = rank1["calls"]
    edges = rank1["edges"]
    print("  (e) the governor over the mesh: moves %s; tier swaps %s"
          % (moves, "; ".join(
              "%s: build %.3f s, probe %.3f s, swap %.3f s" % (
                  swap["tier"], swap["build_s"], swap["probe_s"],
                  swap["swap_s"]) for swap in swaps)))
    print("  (f) rollout to seed-1 weights promoted in %.3f s, memscope's "
          "promote edge on rank 0 %s, on rank 1 %s; (g) the planted green "
          "probe fault refused: %r; rank 1's engine events %s, engines "
          "held at the end %s (in service %s)"
          % (promote_s, "a leak" if verdict["leak"] else "no leak",
             [(e["edge"], e["leak"]) for e in edges], refused,
             {k: calls.get(k, 0) for k in ("build", "install", "discard")},
             rank1["engines"], rank1["in_service"]))
    if promoted["streams"] != want or state[2] != "promoted" \
            or verdict["leak"] or [e["edge"] for e in edges] \
            != ["rollout_promote"] or any(e["leak"] for e in edges):
        raise AssertionError("(f) the promote: streams %s against %s, "
                             "state %s, verdicts %s, %s"
                             % (promoted["streams"], want, state, verdict,
                                edges))
    if refused is None or "planted green probe fault" not in refused \
            or after["streams"] != promoted["streams"] \
            or state[:2] != ("seed-1", False):
        raise AssertionError("(g) the refused rollout: %r, blue's streams "
                             "%s, state %s" % (refused, after["streams"],
                                               state))
    n_swaps = len(TP_LADDER)
    if (calls.get("build"), calls.get("install"), calls.get("discard")) \
            != (1 + n_swaps + 2, n_swaps + 1, n_swaps + 2) \
            or rank1["engines"] != [rank1["in_service"]]:
        raise AssertionError("(e)-(g) rank 1's engine events %s, engines "
                             "%s" % (calls, rank1["engines"]))
    for rung in (promoted, after):
        for name, n in rung["launches"].items():
            launches[name] += n
    return launches


def tp_phase(device, gen, early=None):
    """Phase 27: the serving model at full width on a serving mesh of two
    ranks sharing the card over gloo (model=2: 8 heads, 2048 FFN columns
    and 16384 vocab columns a rank), rank 0 this process, rank 1 a child.
    (a) the paged float tier on f32 weights through rank 0's GenerateAPI
    over HTTP, phase 4's shared-prompt traffic and six distinct prompts;
    (b) the bf16 tiers through ContinuousDecoder(mesh=); (c) a hot swap of
    seed-1 weights; (d) make_tp_generate; (e) the governor's ladder over
    the mesh, (f) a blue-green rollout promoted and (g) one whose green
    probe fails, all through one GenerateAPI (:func:`tp_governor`); (h)
    rank 1 SIGKILLed under traffic. ``early`` is rank 1 as :func:`tp_start_follower` started it
    beside an earlier phase (None: started here). Returns both ranks'
    launches on the main paths."""
    t0 = time.perf_counter()
    if early is None:
        early = tp_start_follower()
    directory, proc, log, report, coordinator = early
    try:
        launches = _tp_phase(device, gen, proc, report, coordinator, t0)
    except BaseException:
        log.seek(0)
        print("rank 1's log:\n%s" % log.read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
        from veles_tpu_torch.parallel.mesh import finalize_distributed
        finalize_distributed()
        shutil.rmtree(directory, ignore_errors=True)
    print("phase 27 (sharded serving, %d ranks on the card): %.1f s"
          % (TP_RANKS, time.perf_counter() - t0))
    return launches


def _tp_phase(device, gen, proc, report, coordinator, t0):
    from veles_tpu_torch.parallel.decode import make_tp_generate
    from veles_tpu_torch.parallel.mesh import (build_mesh,
                                               initialize_distributed)

    def clock(label):
        print("  phase 27 clock: %.1f s after %s"
              % (time.perf_counter() - t0, label))
    launches = collections.Counter()
    errs = tp_kernel_checks(device, gen)
    f32 = tp_model(device, torch.float32)
    waves = prefix_waves(numpy.random.RandomState(2)) + [tp_distinct()]
    requests = sum(len(wave) for wave in waves)
    # the single process's runs first, while rank 1 starts
    single = serve(*f32, waves, None, device)
    clock("the kernel checks and (a)'s single process")
    initialize_distributed(coordinator, TP_RANKS, 0, device="cuda",
                           backend="gloo", timeout=TP_TIMEOUT)
    mesh = build_mesh(data=1, model=TP_RANKS)
    clock("the rendezvous")
    # (a) the paged float tier over HTTP
    meshed = serve(*f32, waves, None, device, mesh=mesh)
    steps = meshed["chunks"] * CHUNK + (
        meshed["health"]["dispatch_counts"]["step"]
        - meshed["health0"]["dispatch_counts"]["step"])
    prompts = [p for wave in waves for p in wave]
    for prompt, one, two in zip(prompts, single["streams"],
                                meshed["streams"]):
        tp_divergence("(a) f32", prompt, one, two,
                      tp_reference(*f32, prompt, one, device),
                      lambda top, gap: gap < TOP2_GAP)
    counted = tuple(check_prefix_counts(run["health0"], run["health"],
                                        len(waves[-1]))
                    for run in (single, meshed))
    if counted[0] != counted[1]:
        raise AssertionError("(a) prefix counters %s on the mesh, %s on "
                             "one process" % counted)
    rank1 = tp_reports(report, "a", proc)
    tp_rank_launches("(a)", meshed["launches"], steps, rank1,
                     "paged_attend", False)
    for name, n in meshed["launches"].items():
        launches[name] += n + rank1["launches"][name]
    tp_cost_line("(a) paged f32 over HTTP", meshed["api"].decoder,
                 meshed["wall"], requests * N_TOKENS)
    # tokens/s alternated on the distinct prompts: the world, then one
    # process (after (a)'s one process, then the world)
    timed = serve(*f32, [tp_distinct()], None, device, mesh=mesh)
    again = serve(*f32, [tp_distinct()], None, device)
    print("  tokens/s alternated: (a)'s %d requests x %d one process %.1f, "
          "the world %.1f; six distinct prompts the world %.1f, one "
          "process %.1f (prefix counts %s on both)" % (
              requests, N_TOKENS, requests * N_TOKENS / single["wall"],
              requests * N_TOKENS / meshed["wall"],
              6 * N_TOKENS / timed["wall"], 6 * N_TOKENS / again["wall"],
              counted[0]))
    del single, meshed, timed, again
    clock("(a)")
    # (b) the bf16 tiers through ContinuousDecoder(mesh=)
    bf16 = tp_bf16(f32)
    distinct = tp_distinct() + [p[:300] for p in tp_distinct()[-2:]]
    for label, quantize, paged, attend in TP_TIERS:
        kw = dict(slots=SLOTS, max_len=MAX_LEN, n_tokens=N_TOKENS,
                  quantize=quantize, paged=paged, page_size=PAGE,
                  device=device)
        results = []
        for m in (None, mesh):
            dec = ContinuousDecoder(*bf16, HEADS, mesh=m, **kw)
            for prompt in distinct:
                dec.submit(prompt)
            dec._admit_pending()
            logits = dec.state["logits"].clone()
            slot_of = {rid: slot for slot, rid in dec._slot_req.items()}
            for fn in COUNTERS.values():
                fn.launches = 0
            started = time.perf_counter()
            if m is None:
                # one process steps a token at a time and keeps the
                # logits each token is picked from (every request was
                # admitted at once: token i of each at step i)
                seen = []
                while dec.busy:
                    seen.append(dec.state["logits"].clone())
                    dec.step()
            else:
                dec.run_until_drained(chunk=CHUNK)
            torch.cuda.synchronize()
            wall = time.perf_counter() - started
            results.append((logits, dict(dec.results), counts(),
                            tp_steps(dec)))
            if m is not None:
                tp_cost_line("(b) %s" % label, dec, wall,
                             len(distinct) * N_TOKENS)
                dec.close()
            else:
                single_slot = slot_of
                print("  (b) %s: %.1f tokens/s in one process, a step at "
                      "a time" % (label, len(distinct) * N_TOKENS / wall))
            del dec
        (l1, one, _, _), (l2, two, got, steps) = results
        rel = ((l2 - l1).abs().max() / l1.abs().max()).item()
        print("  (b) %s: logits after the prefill within %.3g of the "
              "largest (tolerance %.0e)" % (label, rel, TP_BF16_LOGIT_RTOL))
        if not rel <= TP_BF16_LOGIT_RTOL:
            raise AssertionError("(b) %s: the prefill's logits differ by "
                                 "%.3g" % (label, rel))
        for rid, prompt in enumerate(distinct):
            tp_divergence("(b) %s" % label, prompt, one[rid], two[rid],
                          lambda i, s=single_slot[rid]: (seen[i][s], True),
                          lambda top, gap: gap <= TP_BF16_STEPS
                          * bf16_step(top))
        rank1 = tp_reports(report, label, proc)
        tp_rank_launches("(b) %s" % label, got, steps, rank1, attend, True)
        for name, n in got.items():
            launches[name] += n + rank1["launches"][name]
    del bf16
    clock("(b)")
    # (c) a hot swap of seed-1 weights onto the mesh: slice-only
    new = tp_model(device, torch.float32, seed=1)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, n_tokens=N_TOKENS, paged=True,
              page_size=PAGE, device=device)
    dec = ContinuousDecoder(*f32, HEADS, mesh=mesh, **kw)
    dec.swap_params(new[0])
    receipt = dec.last_swap_stats
    if receipt["bytes"] != 0 or not set(receipt["counts"]) <= {"slice",
                                                                "keep"}:
        raise AssertionError("(c) the swap onto the mesh moved %s"
                             % receipt)
    fresh = ContinuousDecoder(new[0], f32[1], HEADS, **kw)
    for d in (dec, fresh):
        for prompt in tp_distinct():
            d.submit(prompt)
        d.run_until_drained(chunk=CHUNK)
    for rid, prompt in enumerate(tp_distinct()):
        tp_divergence("(c) swap", prompt, fresh.results[rid],
                      dec.results[rid],
                      tp_reference(new[0], f32[1], prompt,
                                   fresh.results[rid], device),
                      lambda top, gap: gap < TOP2_GAP)
    print("  (c) swap onto the mesh: receipt %d bytes, %s, %.4f s; the "
          "streams a fresh process's on the new weights"
          % (receipt["bytes"], receipt["counts"], receipt["seconds"]))
    dec.close()
    del dec, fresh, new
    clock("(c)")
    # (d) make_tp_generate at full width, f32
    run = make_tp_generate(mesh, HEADS, TP_GEN_TOKENS, device=device)
    got = run(f32[0], f32[1], tp_gen_prompt()).tolist()
    want, _, logits = generate(*f32, tp_gen_prompt(), HEADS, TP_GEN_TOKENS,
                               return_logits=True, device=device)
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])
    for row, (mine, theirs) in enumerate(zip(got, want.tolist())):
        if mine != theirs:
            i = next(j for j, (a, b) in enumerate(zip(mine, theirs))
                     if a != b)
            if gaps[row, i] >= TOP2_GAP:
                raise AssertionError("(d) make_tp_generate left generate "
                                     "at step %d of row %d" % (i, row))
    if tp_reports(report, "generate", proc)["tokens"] != got:
        raise AssertionError("(d) the ranks' tokens differ")
    print("  (d) make_tp_generate (%d x %d prompt, %d tokens): generate's "
          "tokens on both ranks" % (TP_GEN_SHAPE + (TP_GEN_TOKENS,)))
    clock("(d)")
    for name, n in tp_governor(device, mesh, f32, report, proc,
                               clock).items():
        launches[name] += n
    # (h) rank 1 SIGKILLed under traffic: 503 within the world's timeout
    api = GenerateAPI(*f32, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK, paged=True,
                      page_size=PAGE, device=device, mesh=mesh).start()
    answers = []
    try:
        post(api.port, tp_distinct()[0], CHUNK)

        def client(prompt):
            try:
                post(api.port, prompt, N_TOKENS, timeout=3 * TP_TIMEOUT)
                answers.append((200, time.perf_counter()))
            except urllib.error.HTTPError as exc:
                answers.append((exc.code, time.perf_counter()))
        threads = [threading.Thread(target=client, args=(p,))
                   for p in tp_distinct()]
        for thread in threads:
            thread.start()
        # under traffic: the burst's first chunks dispatched
        while api.decoder.dispatch_counts["chunk"] < 3 and len(answers) \
                < len(threads):
            time.sleep(0.01)
        killed = time.perf_counter()
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        for thread in threads:
            thread.join(timeout=3 * TP_TIMEOUT)
        after = None
        try:
            post(api.port, tp_distinct()[1], CHUNK, timeout=TP_TIMEOUT)
        except urllib.error.HTTPError as exc:
            after = exc.code
        seconds = time.perf_counter() - killed
    finally:
        api.stop()
    early = [code for code, at in answers if at < killed and code != 200]
    shed = [at - killed for code, at in answers if code == 503]
    print("  (h) rank 1 SIGKILLed under traffic: answers %s, %s after the "
          "kill, a new request %s, %.2f s from the kill to its answer "
          "(world timeout %d s)"
          % (sorted(code for code, _ in answers),
             "503 %.2f s" % min(shed) if shed else "no 503", after,
             seconds, TP_TIMEOUT))
    if any(thread.is_alive() for thread in threads) or early \
            or after != 503 or seconds > TP_TIMEOUT:
        raise AssertionError("(h) after rank 1's SIGKILL: answers %s (%s "
                             "before it), a new request %s, %.1f s"
                             % (answers, early, after, seconds))
    print("  phase 27 launches (both ranks): %s; kernel errors %s"
          % (dict(launches), errs))
    return launches


# -- phase 28: the model, seq, pipe and expert axes of a training mesh ------

#: two ranks sharing the card over gloo in one world, rank 0 this process
#: and rank 1 a child started beside phase 27; rank 0's collectives time
#: out after SP_TIMEOUT, rank 1's (it waits across phase 27 and rank 0's
#: single-process references) after SP_DEADLINE, the child's life
SP_RANKS, SP_TIMEOUT, SP_DEADLINE = 2, 120, 900
#: (a) the sequence-parallel transformer step at full width: the serving
#: model's stack (BLOCKS, EMBED, VOCAB) in longctx_device's head layout
#: (LONG_HEADS of 128), SP_T positions, batch 1, bf16, SP_STEPS SGD steps
SP_T, SP_STEPS, SP_LR = 8192, 2, 0.1
#: (a)'s and (c)'s limits against one process (bf16 steps whose sums
#: split over two ranks): the loss relative, n_err as a share of the
#: tokens, every leaf against its largest element (phase 12's limit)
SP_LOSS_RTOL, SP_N_ERR_SHARE, SP_LEAF_RTOL = 1e-2, 1e-2, 1e-2
#: a bf16 leaf may also lie this many bf16 steps (bf16_step, at its
#: largest element) an SGD step from the reference, as phase 27's
#: TP_BF16_STEPS: its gradient rounds to bf16, and a last-bit difference
#: there tips the update's own rounding. A step is 2^-8 to 2^-7 of the
#: element, so two steps' worth can pass SP_LEAF_RTOL on a bias that
#: started at zero (all update): the CPU rehearsal at cut widths read 2
#: steps (1.04e-2) against one process and 3 (1.52e-2) ring against one
#: process after (a)'s two steps
SP_BF16_STEPS = 2
#: (b) the model-axis step: the wide MLP (784 -> 4096 tanh -> 10,
#: minibatch 4096) at precision level 2, phase 8's, whose limits hold it
#: (n_err equal, leaves within AGREE_WEIGHT_ATOL), MP_STEPS steps
MP_STEPS = 3
MP_SPEC = [dict(activation="tanh", learning_rate=TRAIN_LR,
                learning_rate_bias=TRAIN_LR, weights_decay=5e-4,
                l1_vs_l2=0.0, gradient_moment=0.9),
           dict(activation="linear", learning_rate=TRAIN_LR,
                learning_rate_bias=TRAIN_LR, weights_decay=5e-4,
                l1_vs_l2=0.0, gradient_moment=0.9)]
#: (b)'s K5 launches a rank a step, from gemm._kernel_eligible (CUDA
#: operands, m, k and n >= 512): the hidden layer's forward x (4096, 784)
#: @ w (784, 2048) and its weight gradient x.T (784, 4096) @ err (4096,
#: 2048); the head's forward and weight gradient (n = 5) and its input
#: error (k = 5) are plain, and the first layer has no input error
MP_K5_PER_STEP = 2
#: (c) the pipeline over pipe=2: two of (a)'s blocks a stage at PP_T
#: positions, PP_MICRO microbatches of one sequence, bf16, MSE against
#: RandomState targets, remat; two steps, the first held against the
#: sequential step, the second timed without the first's one-time cost
#: (torch.utils.checkpoint imports torch._dynamo at its first call: 7.5 s
#: of the first step on the card's host, 2.7 s on a CPU box)
PP_T, PP_MICRO, PP_LR, PP_RUNS = 4096, 4, 1.0, 2
#: (c)'s flash launches a stage: the forward runs its two blocks at each
#: of the n_micro + n_stages - 1 steps (the bubbles too, as the JAX
#: package does) and remat runs them again in the backward: K7 twice a
#: block a step, K8 and K9 once
PP_STEPS = PP_MICRO + SP_RANKS - 1
PP_FLASH = {"flash_attention_fwd": 2 * 2 * PP_STEPS,
            "flash_attention_dkv": 2 * PP_STEPS,
            "flash_attention_dq": 2 * PP_STEPS}
#: (d) the experts over expert=2: 8 experts of (EMBED, MOE_HIDDEN),
#: MOE_TOKENS tokens (half a rank), f32; capacity factor 8 drops none
MOE_EXPERTS, MOE_HIDDEN, MOE_TOKENS, MOE_LR = 8, 4096, 8192, 0.05
#: (d) against reference_moe, relative to each output's and leaf's
#: largest element (the JAX test's tolerance); a row may leave the
#: reference only where its top-2 gate probabilities lie within
#: MOE_TIE_GAP (a routing flip from the product's rounding)
MOE_RTOL, MOE_TIE_GAP = 2e-4, 1e-5
#: (e) the f32 Ulysses step at C11's shape: (a)'s model and sequence in
#: f32 (a rank attends (1, SP_T, LONG_HEADS / 2, 128): K7, K8 and K9's
#: f32 route), one step against one process's; f32 sums split over two
#: ranks and reassociated: the loss and every leaf within this share of the
#: reference's (largest element), n_err within (a)'s share
SP_F32_RTOL = 1e-4

#: rank 1 of phase 28: a fresh process on the same card that builds the
#: same seeded problems, joins the world and runs every part beside rank 0
SP_FOLLOWER = r'''
import json, sys
import torch
import chip_smoke as cs
from veles_tpu_torch.parallel.mesh import initialize_distributed
coordinator, out, cache, device = sys.argv[1:5]
cs.root.common.engine.pallas_autotune_cache = cache
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device(device)
problems = cs.sp_problems(dev)
initialize_distributed(coordinator, cs.SP_RANKS, 1, device=device,
                       backend="gloo", timeout=cs.SP_DEADLINE)
report, _ = cs.sp_world(dev, 1, problems)
with open(out, "w") as fout:
    json.dump(report, fout)
'''


def sp_digest(tree):
    """A SHA-1 over a tree's tensors' bytes, in tree order."""
    from veles_tpu_torch.device import tree_leaves_with_path
    sha = hashlib.sha1()
    for _, leaf in tree_leaves_with_path(tree):
        sha.update(leaf.detach().contiguous().cpu().view(
            torch.uint8).numpy().tobytes())
    return sha.hexdigest()


def sp_problems(device):
    """Every part's seeded inputs, the same on both ranks: (a) the model
    (bf16 from RandomState(0)) and one sequence of SP_T tokens with its
    labels; (b) the wide MLP's weights (phase 8's rule) and a minibatch
    of the bench's data; (c) (a)'s blocks as two stages of two, four
    sequences of PP_T and MSE targets; (d) the experts and their tokens."""
    from veles_tpu_torch.parallel.expert import init_moe_params
    params = init_transformer_params(numpy.random.RandomState(0), BLOCKS,
                                     EMBED, LONG_HEADS, VOCAB,
                                     dtype=torch.bfloat16, device=device)
    rng = numpy.random.RandomState(1)

    def bf16(a):
        return torch.from_numpy(a.astype(numpy.float32)).to(
            device=device, dtype=torch.bfloat16)
    x = bf16(rng.randn(1, SP_T, EMBED) * 0.3)
    labels = torch.from_numpy(rng.randint(0, VOCAB, (1, SP_T))).to(device)
    data, digits = bench_dataset(n=WIDE_MINIBATCH, n_valid=0)
    mlp = {"w": [], "b": []}
    for layer in dp_weights(numpy.random.RandomState(5)):
        mlp["w"].append(torch.from_numpy(layer["weights"]).float().to(
            device))
        mlp["b"].append(torch.from_numpy(layer["bias"]).float().to(device))
    mlp["vw"] = [torch.zeros_like(w) for w in mlp["w"]]
    mlp["vb"] = [torch.zeros_like(b) for b in mlp["b"]]
    batch = (torch.from_numpy(data).to(device),
             torch.from_numpy(digits).to(device),
             torch.ones(WIDE_MINIBATCH, device=device))
    blocks = params["blocks"]
    stages = {"blocks": [{name: torch.stack([blocks[2 * s + j][name]
                                             for s in range(SP_RANKS)])
                          for name in blocks[0]} for j in range(2)]}
    rng = numpy.random.RandomState(2)
    pp = (bf16(rng.randn(PP_MICRO, PP_T, EMBED) * 0.3),
          bf16(rng.randn(PP_MICRO, PP_T, EMBED) * 0.3))
    moe = init_moe_params(numpy.random.RandomState(3), MOE_EXPERTS, EMBED,
                          MOE_HIDDEN, device=device)
    rng = numpy.random.RandomState(4)
    tokens = torch.from_numpy(rng.randn(MOE_TOKENS, EMBED).astype(
        numpy.float32)).to(device)
    targets = torch.from_numpy((rng.randn(MOE_TOKENS, EMBED) * 0.1).astype(
        numpy.float32)).to(device)
    params32 = init_transformer_params(numpy.random.RandomState(0), BLOCKS,
                                       EMBED, LONG_HEADS, VOCAB,
                                       device=device)
    return {"sp": (params, x, labels), "mp": (mlp, batch),
            "pp": (stages,) + pp, "moe": (moe, tokens, targets),
            "sp32": (params32, x.float(), labels)}


def pp_stage(w, x):
    """(c)'s stage: two of (a)'s pre-LN blocks, causal attention (K7 at
    PP_T positions)."""
    from veles_tpu_torch.parallel.transformer_step import (_attn_out,
                                                           _block_qkv, _mlp)
    for blk in w["blocks"]:
        q, k, v = _block_qkv(blk, x, LONG_HEADS)
        x = _mlp(blk, _attn_out(blk, x, attention(q, k, v, causal=True)))
    return x


def pp_loss(outputs, targets):
    return ((outputs.float() - targets.float()) ** 2).mean()


def sp_timed(device, mesh, fn):
    """``fn()`` with every kernel count set to 0 just before and read just
    after, its wall (synchronized) and its collectives' seconds."""
    from veles_tpu_torch.parallel.collectives import collective_seconds
    torch.cuda.synchronize(device)
    for counter in COUNTERS.values():
        counter.launches = 0
    flash_attention_fwd.launches_f32 = 0
    flash_attention_dkv.launches_f32 = flash_attention_dq.launches_f32 = 0
    before = collective_seconds(mesh) if mesh is not None else 0.0
    started = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - started
    launches = counts()
    launches.update(flash_attention_fwd_f32=flash_attention_fwd.launches_f32,
                    flash_attention_dkv_f32=flash_attention_dkv.launches_f32,
                    flash_attention_dq_f32=flash_attention_dq.launches_f32)
    return out, {"wall": wall, "launches": launches,
                 "collective_s": (collective_seconds(mesh) - before
                                  if mesh is not None else 0.0)}


def sp_world(device, rank, problems):
    """Both ranks' side of phase 28, part by part, the mesh rebuilt for
    each: (a) the transformer step over seq=2, Ulysses then ring; (b) the
    model-axis step over model=2; (c) the pipeline step over pipe=2; (d)
    the experts over expert=2. Returns a JSON-able report (per step: the
    wall, the collectives' seconds, the launches; losses, n_err, digests)
    and, for rank 0's checks, the gathered results."""
    from veles_tpu_torch.device import tree_leaves_with_path, tree_rebuild
    from veles_tpu_torch.parallel import collectives, expert, pipeline
    from veles_tpu_torch.parallel.mesh import build_mesh
    from veles_tpu_torch.parallel.step import (build_train_step,
                                               shard_batch, shard_params)
    from veles_tpu_torch.parallel.transformer_step import (
        build_transformer_train_step, shard_tokens)
    report, kept = {"rank": rank}, {}
    # (a)
    params, x, labels = problems["sp"]
    mesh = build_mesh(data=1, seq=SP_RANKS)
    xs, ls = shard_tokens([x, labels], mesh)
    for strategy in ("ulysses", "ring"):
        step = build_transformer_train_step(LONG_HEADS, mesh=mesh,
                                            learning_rate=SP_LR,
                                            sp_strategy=strategy)
        p, rows = params, []
        for _ in range(SP_STEPS):
            (p, (loss, n_err)), row = sp_timed(
                device, mesh, lambda p=p: step(p, xs, ls))
            row.update(loss=float(loss), n_err=int(n_err))
            rows.append(row)
        report["a_" + strategy] = {"steps": rows, "digest": sp_digest(p)}
        kept["a_" + strategy] = p
        del p, step
    del xs, ls
    # (b) the knobs on, precision level 2
    mlp, batch = problems["mp"]
    mesh = build_mesh(data=1, model=SP_RANKS)
    engine = root.common.engine
    knobs = (engine.get("use_pallas", "tuned"),
             engine.get("precision_level", 0))
    engine.use_pallas, engine.precision_level = True, 2
    try:
        step = build_train_step(MP_SPEC, mesh=mesh)
        p, rows = shard_params(mlp, mesh), []
        local = shard_batch(list(batch), mesh)
        for _ in range(MP_STEPS):
            (p, (loss, n_err)), row = sp_timed(
                device, mesh, lambda p=p: step(p, *local))
            row.update(loss=float(loss), n_err=int(n_err))
            rows.append(row)
    finally:
        engine.use_pallas, engine.precision_level = knobs
    report["b"] = {"steps": rows}
    kept["b"] = {key: [collectives.all_gather(
        t, mesh, "model", 1 if key in ("w", "vw") else 0) for t in leaves]
        for key, leaves in p.items()}
    # (c)
    stages, batch, targets = problems["pp"]
    mesh = build_mesh(pipe=SP_RANKS)
    step = pipeline.make_pipeline_train_step(
        mesh, pp_stage, PP_MICRO, pp_loss, learning_rate=PP_LR, remat=True)
    w, rows = pipeline.shard_stage_weights(stages, mesh), []
    for i in range(PP_RUNS):
        (w, loss), row = sp_timed(device, mesh,
                                  lambda w=w: step(w, batch, targets))
        row.update(loss=float(loss))
        rows.append(row)
        if i == 0:
            kept["c"] = tree_rebuild(w, iter([
                collectives.all_gather(t, mesh, "pipe", 0)
                for _, t in tree_leaves_with_path(w)]))
    report["c"] = {"steps": rows}
    del w, step
    # (d)
    moe, tokens, targets = problems["moe"]
    mesh = build_mesh(expert=SP_RANKS)
    t = MOE_TOKENS // SP_RANKS
    x_local = tokens[rank * t:(rank + 1) * t]
    t_local = targets[rank * t:(rank + 1) * t]
    local = expert.shard_moe_params(moe, mesh)
    rows = {}
    for cf in (8.0, 2.0):
        ffn = expert.make_moe_ffn(mesh, MOE_EXPERTS, capacity_factor=cf)
        (y, dropped), rows[cf] = sp_timed(device, mesh,
                                          lambda: ffn(local, x_local))
        rows[cf]["dropped"] = float(dropped)
        if cf == 8.0:
            kept["d_y"] = collectives.all_gather(y, mesh, "expert", 0)
    step = expert.make_moe_train_step(mesh, MOE_EXPERTS, capacity_factor=8.0,
                                      learning_rate=MOE_LR)
    (new, loss), row = sp_timed(device, mesh,
                                lambda: step(local, x_local, t_local))
    row.update(loss=float(loss))
    kept["d_step"] = {k: v if k == "gate" else collectives.all_gather(
        v, mesh, "expert", 0) for k, v in new.items()}
    report["d"] = {"forward": rows[8.0], "forward_cf2": rows[2.0],
                   "steps": [row], "gate": sp_digest(new["gate"])}
    del new, local
    # (e) the f32 Ulysses step at C11's shape
    params32, x32, labels = problems["sp32"]
    mesh = build_mesh(data=1, seq=SP_RANKS)
    xs, ls = shard_tokens([x32, labels], mesh)
    step = build_transformer_train_step(LONG_HEADS, mesh=mesh,
                                        learning_rate=SP_LR)
    (p, (loss, n_err)), row = sp_timed(device, mesh,
                                       lambda: step(params32, xs, ls))
    row.update(loss=float(loss), n_err=int(n_err))
    report["e"] = {"steps": [row], "digest": sp_digest(p)}
    kept["e"] = p
    return report, kept


def sp_references(device, problems):
    """Rank 0's one-process runs of every part, on the card, before the
    world: (a) the same SP_STEPS steps without a mesh, timed; (b)
    build_train_step without a mesh (the knobs as in the world); (c)
    sequential_reference's SGD step through autograd; (d) reference_moe
    and its SGD step through autograd."""
    from veles_tpu_torch.device import tree_leaves_with_path, tree_rebuild
    from veles_tpu_torch.parallel import expert, pipeline
    from veles_tpu_torch.parallel.step import build_train_step
    from veles_tpu_torch.parallel.transformer_step import (
        build_transformer_train_step)
    refs = {}
    params, x, labels = problems["sp"]
    step = build_transformer_train_step(LONG_HEADS, learning_rate=SP_LR)
    p, rows = params, []
    for _ in range(SP_STEPS):
        (p, (loss, n_err)), row = sp_timed(device, None,
                                           lambda p=p: step(p, x, labels))
        row.update(loss=float(loss), n_err=int(n_err))
        rows.append(row)
    refs["a"] = (p, rows)
    del p
    mlp, batch = problems["mp"]
    engine = root.common.engine
    knobs = (engine.get("use_pallas", "tuned"),
             engine.get("precision_level", 0))
    engine.use_pallas, engine.precision_level = True, 2
    try:
        step = build_train_step(MP_SPEC)
        p, rows = mlp, []
        for _ in range(MP_STEPS):
            p, (loss, n_err) = step(p, *batch)
            rows.append({"loss": float(loss), "n_err": int(n_err)})
    finally:
        engine.use_pallas, engine.precision_level = knobs
    refs["b"] = (p, rows)
    stages, batch, targets = problems["pp"]
    leaves = [t.detach().requires_grad_(True)
              for _, t in tree_leaves_with_path(stages)]
    loss = pp_loss(pipeline.sequential_reference(
        pp_stage, tree_rebuild(stages, iter(leaves)), batch), targets)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        refs["c"] = (tree_rebuild(stages, iter(
            [w - PP_LR * g for w, g in zip(leaves, grads)])), float(loss))
    del leaves, grads
    moe, tokens, targets = problems["moe"]
    with torch.no_grad():
        y = expert.reference_moe(moe, tokens)
        probs = torch.softmax(tokens @ moe["gate"], dim=1)
        top2 = torch.topk(probs, 2, dim=1).values
        gaps = top2[:, 0] - top2[:, 1]
    leaves = {k: v.detach().requires_grad_(True) for k, v in moe.items()}
    loss = ((expert.reference_moe(leaves, tokens) - targets) ** 2).mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    with torch.no_grad():
        new = {k: moe[k] - MOE_LR * grads[k] for k in moe}
    refs["d"] = (y, gaps, new, float(loss.detach()))
    del new, leaves, grads
    params32, x32, labels = problems["sp32"]
    step = build_transformer_train_step(LONG_HEADS, learning_rate=SP_LR)
    (p, (loss, n_err)), row = sp_timed(device, None,
                                       lambda: step(params32, x32, labels))
    row.update(loss=float(loss), n_err=int(n_err))
    refs["e"] = (p, row)
    return refs


def sp_kernel_checks(device, gen):
    """K7, K8 and K9 at the shapes this phase gives them (a rank's
    Ulysses heads, (1, 8192, 4, 128), and a pipeline stage's microbatch,
    (1, 4096, 8, 128), bf16, causal) and K5 at (b)'s shard shapes (the
    hidden layer's forward (4096, 784, 2048) and weight gradient (784,
    4096, 2048), f32 operands), each against its plain version. Returns
    the largest error by kernel."""
    errs = {name: 0.0 for name in FLASH + ("blocked_matmul",)}
    for shape in ((1, SP_T, LONG_HEADS // SP_RANKS, 128),
                  (1, PP_T, LONG_HEADS, 128)):
        q, k, v, do = flash_problem(gen, device, shape, torch.bfloat16)
        label = "x".join(map(str, shape)) + " bf16 (phase 28)"
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        errs["flash_attention_fwd"] = max(
            errs["flash_attention_fwd"],
            flash_error("K7 flash_attention_fwd " + label, out, ref,
                        K7_RTOL))
        dkv, dq, _ = check_backward(label, q, k, v, do, out, lse)
        errs["flash_attention_dkv"] = max(errs["flash_attention_dkv"], dkv)
        errs["flash_attention_dq"] = max(errs["flash_attention_dq"], dq)
        del q, k, v, do, out, lse, ref
    m, k, n = WIDE_MINIBATCH, 784, WIDE_LAYERS[0] // SP_RANKS
    for layout, shape in (("forward", (m, k, n)),
                          ("weight_grad", (k, m, n))):
        a, b = gemm_operands(gen, device, shape, torch.float32, layout)
        out = blocked_matmul(a, b, out_dtype=torch.float32)
        ref = _blocked_matmul_plain(a, b, torch.float32)
        torch.cuda.synchronize()
        err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
        errs["blocked_matmul"] = max(errs["blocked_matmul"], err)
        print("K5 blocked_matmul %s %s f32 (phase 28's shard shape): "
              "max_abs_err %.3g (%.3g relative)" % (layout, shape, err, rel))
    return errs


def sp_start_follower(device="cuda"):
    """Start rank 1 (SP_FOLLOWER) on a fresh rendezvous, in a directory of
    its own; returns the directory, the process, its log, its report path
    and the coordinator."""
    directory = tempfile.mkdtemp(prefix="sp_phase_")
    script = os.path.join(directory, "sp_follower.py")
    with open(script, "w") as fout:
        fout.write(SP_FOLLOWER)
    coordinator = "127.0.0.1:%d" % free_port()
    report = os.path.join(directory, "sp_follower.json")
    log = open(os.path.join(directory, "sp_follower.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, script, coordinator, report,
         str(root.common.engine.pallas_autotune_cache), str(device)],
        cwd=REPO_DIR, env=port_env(), stdout=log, stderr=subprocess.STDOUT)
    return directory, proc, log, report, coordinator


def sp_leaves_close(label, got, want, rtol, steps=0):
    """Every leaf of ``got`` within ``rtol`` of its ``want`` leaf's largest
    element or, for a bf16 leaf, within ``steps`` bf16 steps there (one
    an SGD step, :data:`SP_BF16_STEPS`). Returns the worst share of the
    largest element."""
    from veles_tpu_torch.device import tree_leaves_with_path
    worst = 0.0
    for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want)):
        largest = b.float().abs().max().item()
        diff = (a.float() - b.float()).abs().max().item()
        limit = rtol * largest
        if b.dtype == torch.bfloat16:
            limit = max(limit, steps * bf16_step(largest))
        worst = max(worst, diff / max(largest, 1e-30))
        if not diff <= limit:
            raise AssertionError("%s: leaf %s differs by %.3g, %.3g of its "
                                 "largest element (limit %.3g)"
                                 % (label, path, diff, diff / largest,
                                    limit))
    return worst


def sp_share(report):
    """The collectives' share of each step of one rank's run."""
    return ", ".join("%.3f of %.3f s (%.1f%%)" % (
        row["collective_s"], row["wall"],
        100 * row["collective_s"] / max(row["wall"], 1e-9))
        for row in report["steps"])


def sp_phase(device, gen, early=None):
    """Phase 28: the training mesh's model, seq, pipe and expert axes on
    two ranks sharing the card over gloo in one world (rank 0 this
    process, rank 1 a child started beside phase 27). Returns both ranks'
    launches on the main paths."""
    t0 = time.perf_counter()
    if early is None:
        early = sp_start_follower(device)
    directory, proc, log, report_path, coordinator = early
    try:
        launches = _sp_phase(device, gen, proc, report_path, coordinator,
                             t0)
    except BaseException:
        log.seek(0)
        print("phase 28 rank 1's log:\n%s" % log.read()[-4000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
        from veles_tpu_torch.parallel.mesh import finalize_distributed
        finalize_distributed()
        shutil.rmtree(directory, ignore_errors=True)
    print("phase 28 (the training mesh's axes, %d ranks on the card): %.1f s"
          % (SP_RANKS, time.perf_counter() - t0))
    return launches


def _sp_phase(device, gen, proc, report_path, coordinator, t0):
    from veles_tpu_torch.parallel.mesh import initialize_distributed

    def clock(label):
        print("  phase 28 clock: %.1f s after %s"
              % (time.perf_counter() - t0, label))
    errs = sp_kernel_checks(device, gen)
    problems = sp_problems(device)
    refs = sp_references(device, problems)
    clock("the kernel checks and the one-process references")
    initialize_distributed(coordinator, SP_RANKS, 0, device=device.type,
                           backend="gloo", timeout=SP_TIMEOUT)
    mine, kept = sp_world(device, 0, problems)
    clock("the world's parts")
    proc.wait(timeout=SP_TIMEOUT)
    with open(report_path) as fin:
        theirs = json.load(fin)
    ranks = (mine, theirs)
    launches = collections.Counter()
    # (a) the main path: K7, K8 and K9 exactly BLOCKS a Ulysses step on
    # each rank, none in the ring; both ranks' parameters the same bits
    ref_params, ref_rows = refs["a"]
    for strategy in ("ulysses", "ring"):
        for rank, report in enumerate(ranks):
            for i, row in enumerate(report["a_" + strategy]["steps"]):
                want = BLOCKS if strategy == "ulysses" else 0
                got = {name: row["launches"][name] for name in FLASH}
                if any(n != want for n in got.values()):
                    raise AssertionError(
                        "(a) %s step %d rank %d: flash launches %s, not %d "
                        "each" % (strategy, i, rank, got, want))
                for name, n in got.items():
                    launches[name] += n
        if mine["a_" + strategy]["digest"] != \
                theirs["a_" + strategy]["digest"]:
            raise AssertionError("(a) %s: the ranks' parameters differ"
                                 % strategy)
    for label, (got, rows), (want, want_rows) in (
            ("ulysses", (kept["a_ulysses"], mine["a_ulysses"]["steps"]),
             (ref_params, ref_rows)),
            ("ring", (kept["a_ring"], mine["a_ring"]["steps"]),
             (ref_params, ref_rows)),
            ("ring against ulysses", (kept["a_ring"],
                                      mine["a_ring"]["steps"]),
             (kept["a_ulysses"], mine["a_ulysses"]["steps"]))):
        loss_rel = max(abs(r["loss"] - w["loss"]) / abs(w["loss"])
                       for r, w in zip(rows, want_rows))
        n_err = max(abs(r["n_err"] - w["n_err"])
                    for r, w in zip(rows, want_rows))
        leaf = sp_leaves_close("(a) " + label, got, want, SP_LEAF_RTOL,
                               SP_BF16_STEPS * SP_STEPS)
        print("  (a) %s: losses %s against %s (%.3g relative), n_err %s "
              "against %s, leaves within %.3g of their largest"
              % (label, [r["loss"] for r in rows],
                 [w["loss"] for w in want_rows], loss_rel,
                 [r["n_err"] for r in rows],
                 [w["n_err"] for w in want_rows], leaf))
        if not (loss_rel <= SP_LOSS_RTOL
                and n_err <= SP_N_ERR_SHARE * SP_T):
            raise AssertionError("(a) %s disagrees with the reference"
                                 % label)
    for label, rows in (("one process", ref_rows),
                        ("ulysses", mine["a_ulysses"]["steps"]),
                        ("ring", mine["a_ring"]["steps"])):
        print("  (a) %s: %s tokens/s a step" % (label, ", ".join(
            "%.1f" % (SP_T / r["wall"]) for r in rows)))
    for strategy in ("ulysses", "ring"):
        print("  (a) %s collectives: rank 0 %s; rank 1 %s" % (
            strategy, sp_share(mine["a_" + strategy]),
            sp_share(theirs["a_" + strategy])))
    clock("(a)")
    # (b) K5 MP_K5_PER_STEP a step on each rank; n_err equal to one
    # process's, the leaves within phase 8's limit
    want_params, want_rows = refs["b"]
    for rank, report in enumerate(ranks):
        for i, row in enumerate(report["b"]["steps"]):
            if row["launches"]["blocked_matmul"] != MP_K5_PER_STEP:
                raise AssertionError("(b) step %d rank %d: K5 launched %d, "
                                     "not %d" % (i, rank,
                                                 row["launches"][
                                                     "blocked_matmul"],
                                                 MP_K5_PER_STEP))
            launches["blocked_matmul"] += row["launches"]["blocked_matmul"]
    rows = mine["b"]["steps"]
    w_diff = max((a - b).abs().max().item() for key in kept["b"]
                 for a, b in zip(kept["b"][key], want_params[key]))
    print("  (b) model=2 wide MLP, %d steps: n_err %s against one process's "
          "%s, losses %s against %s, leaves within %.3g (limit %.0e); "
          "collectives rank 0 %s; rank 1 %s" % (
              MP_STEPS, [r["n_err"] for r in rows],
              [r["n_err"] for r in want_rows], [r["loss"] for r in rows],
              [r["loss"] for r in want_rows], w_diff, AGREE_WEIGHT_ATOL,
              sp_share(mine["b"]), sp_share(theirs["b"])))
    if [r["n_err"] for r in rows] != [r["n_err"] for r in want_rows] \
            or [r["n_err"] for r in theirs["b"]["steps"]] \
            != [r["n_err"] for r in rows] or not w_diff <= AGREE_WEIGHT_ATOL:
        raise AssertionError("(b) the model-axis step disagrees")
    clock("(b)")
    # (c) the flash kernels PP_FLASH a stage; the step against the
    # sequential reference's
    for rank, report in enumerate(ranks):
        for row in report["c"]["steps"]:
            got = {name: row["launches"][name] for name in FLASH}
            if got != PP_FLASH:
                raise AssertionError("(c) stage %d: flash launches %s a "
                                     "step, not %s" % (rank, got, PP_FLASH))
            for name, n in got.items():
                launches[name] += n
    want_w, want_loss = refs["c"]
    loss = mine["c"]["steps"][0]["loss"]
    leaf = sp_leaves_close("(c)", kept["c"], want_w, SP_LEAF_RTOL,
                           SP_BF16_STEPS)
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    print("  (c) pipe=2, %d microbatches of %d positions: the first step's "
          "loss %.6g against the sequential step's %.6g (%.3g relative), "
          "leaves within %.3g of their largest; flash launches a stage a "
          "step %s; %s tokens/s a step (the first with torch._dynamo's "
          "import); collectives stage 0 %s; stage 1 %s"
          % (PP_MICRO, PP_T, loss, want_loss, loss_rel, leaf, PP_FLASH,
             ", ".join("%.1f" % (PP_MICRO * PP_T / r["wall"])
                       for r in mine["c"]["steps"]),
             sp_share(mine["c"]), sp_share(theirs["c"])))
    if not loss_rel <= SP_LOSS_RTOL \
            or theirs["c"]["steps"][0]["loss"] != loss:
        raise AssertionError("(c) the pipelined step disagrees")
    clock("(c)")
    # (d) the experts against reference_moe
    y_ref, gaps, new_ref, loss_ref = refs["d"]
    rows = (kept["d_y"] - y_ref).abs().amax(dim=1)
    scale = y_ref.abs().max().item()
    off = torch.nonzero(rows > MOE_RTOL * scale).flatten().tolist()
    on = rows.clone()
    on[off] = 0.0
    for row in off:
        print("  (d) token %d leaves the reference by %.3g: its top-2 gate "
              "probabilities' gap %.3g" % (row, rows[row].item(),
                                           gaps[row].item()))
        if not gaps[row].item() < MOE_TIE_GAP:
            raise AssertionError("(d) token %d's output differs where its "
                                 "routing is no near-tie" % row)
    leaf = sp_leaves_close("(d) step", kept["d_step"], new_ref, MOE_RTOL)
    update = max(((kept["d_step"][k] - problems["moe"][0][k])
                  - (new_ref[k] - problems["moe"][0][k])).abs().max().item()
                 / (new_ref[k] - problems["moe"][0][k]).abs().max().item()
                 for k in new_ref)
    loss = mine["d"]["steps"][0]["loss"]
    print("  (d) expert=2, %d experts, %d tokens: outputs within %.3g of "
          "the largest (%d tokens off at near-ties), dropped %.3g at "
          "capacity 8 and %.4f at 2.0; the step's loss %.6g against %.6g, "
          "leaves within %.3g of their largest, updates within %.3g of the "
          "largest update; collectives rank 0 %s; rank 1 %s" % (
              MOE_EXPERTS, MOE_TOKENS, (on.max() / scale).item(), len(off),
              mine["d"]["forward"]["dropped"],
              mine["d"]["forward_cf2"]["dropped"], loss, loss_ref, leaf,
              update, sp_share(mine["d"]), sp_share(theirs["d"])))
    if mine["d"]["forward"]["dropped"] != 0.0 \
            or abs(loss - loss_ref) > MOE_RTOL * abs(loss_ref) \
            or mine["d"]["gate"] != theirs["d"]["gate"]:
        raise AssertionError("(d) the experts disagree")
    clock("(d)")
    # (e) the f32 Ulysses step (C11's repair): K7, K8 and K9 BLOCKS a step
    # on each rank and in one process's step, all on their f32 route; the
    # ranks' parameters the same bits, and the step within SP_F32_RTOL of
    # one process's
    want_p, want_row = refs["e"]
    f32_flash = FLASH + tuple(name + "_f32" for name in FLASH)
    for who, got in [("rank %d" % rank, report["e"]["steps"][0]["launches"])
                     for rank, report in enumerate(ranks)] \
            + [("one process", want_row["launches"])]:
        flash = {name: got[name] for name in f32_flash}
        if any(n != BLOCKS for n in flash.values()):
            raise AssertionError("(e) %s: flash launches %s, not %d each"
                                 % (who, flash, BLOCKS))
        if who != "one process":
            for name, n in flash.items():
                launches[name] += n
    if mine["e"]["digest"] != theirs["e"]["digest"]:
        raise AssertionError("(e) the ranks' parameters differ")
    row = mine["e"]["steps"][0]
    loss_rel = abs(row["loss"] - want_row["loss"]) / abs(want_row["loss"])
    leaf = sp_leaves_close("(e) f32", kept["e"], want_p, SP_F32_RTOL)
    print("  (e) the f32 Ulysses step at a rank's (1, %d, %d, 128): loss "
          "%.8g against one process's %.8g (%.3g relative), n_err %d "
          "against %d, leaves within %.3g of their largest (limit %.0e); "
          "K7, K8 and K9 f32 %d each a rank; %.1f tokens/s (one process "
          "%.1f), collectives rank 0 %s; rank 1 %s"
          % (SP_T, LONG_HEADS // SP_RANKS, row["loss"], want_row["loss"],
             loss_rel, row["n_err"], want_row["n_err"], leaf, SP_F32_RTOL,
             BLOCKS, SP_T / row["wall"], SP_T / want_row["wall"],
             sp_share(mine["e"]), sp_share(theirs["e"])))
    if not (loss_rel <= SP_F32_RTOL
            and abs(row["n_err"] - want_row["n_err"])
            <= SP_N_ERR_SHARE * SP_T):
        raise AssertionError("(e) the f32 Ulysses step disagrees")
    clock("(e)")
    print("  phase 28 launches (both ranks): %s; kernel errors %s"
          % (dict(launches), errs))
    return launches


# -- phase 29: the meta-workflows on the card -------------------------------

#: the GA (--optimize SIZE:GENERATIONS, max_parallel 2: the optimizer's
#: default) and its stream's seed; the ensemble (--ensemble-train N:RATIO)
META_OPTIMIZE, META_SEED, META_ENSEMBLE = "4:2", 29, "3:0.8"
#: epochs of each child's wide MLP; the genes' ranges (learning rate and
#: momentum around phase 22's 0.03 and 0.9)
META_EPOCHS = 2
META_GENES = (("root.meta.learning_rate", (0.03, 0.005, 0.1)),
              ("root.meta.gradient_moment", (0.9, 0.5, 0.95)))
#: a child's deadline (seconds)
META_DEADLINE = 900
META_WORKFLOW = '''"""The wide MLP of the meta-workflows (chip_smoke.py phase 29)."""

import json
import os

import numpy

from veles_tpu_torch.core.config import root
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.ensemble import OutputDumper
from veles_tpu_torch.loader.base import TEST, VALID
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.snapshotter import Snapshotter

root.meta.update({"layers": [4096, 10], "minibatch_size": 4096,
                  "learning_rate": 0.03, "gradient_moment": 0.9,
                  "epochs": 2, "directory": None, "url": None, "out": None,
                  "snapshot": False})


def dump(wf, path):
    """The validation outputs of the snapshot's weights: each minibatch
    filled by the loader, run through the forward units' compute, fed to
    an OutputDumper; its models-JSON entry written to ``path``."""
    loader = wf.loader
    dumper = OutputDumper(DummyWorkflow(), model_id=path, klass=VALID)
    start = loader.class_lengths[TEST]
    stop = start + loader.class_lengths[VALID]
    loader.minibatch_class = VALID
    for first in range(start, stop, loader.max_minibatch_size):
        index = numpy.arange(first, min(first + loader.max_minibatch_size,
                                        stop))
        loader.fill_minibatch(index, len(index))
        x = loader.minibatch_data.data
        for unit in wf.forwards:
            x = unit.compute(x, unit.weights.data, unit.bias.data)
            x = x[0] if isinstance(x, tuple) else x
        dumper.output, dumper.minibatch_indices = x, index
        dumper.minibatch_valid_size = len(index)
        dumper.minibatch_class = VALID
        dumper.run()
    with open(path, "w") as fout:
        json.dump(dumper.entry(), fout)


def run(load, main):
    cfg = root.meta
    wf, resumed = load(
        MLPWorkflow, name="meta-wide", layers=tuple(cfg.layers),
        loader_cls=MNISTLoader,
        loader_kwargs=dict(directory=cfg.directory, url_base=cfg.url,
                           minibatch_size=cfg.minibatch_size,
                           normalization_type="linear"),
        learning_rate=cfg.learning_rate,
        gradient_moment=cfg.gradient_moment, max_epochs=cfg.epochs)
    tag = "%d" % os.getpid()
    if resumed:
        dump(wf, os.path.join(cfg.out, "outputs-%s.json" % tag))
        wf.decision.complete.unset()
        wf.decision.train_ended.unset()
    elif cfg.snapshot:
        snap = Snapshotter(wf, directory=cfg.out, prefix="meta-" + tag,
                           compression="", interval=1, time_interval=0)
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.decision.improved
        wf.end_point.unlink_from(wf.decision)
        wf.end_point.link_from(snap)
        wf.snapshotter = snap
    before = list(getattr(wf.fused_tick, "minibatch_counts", [0, 0, 0]))
    k6, k5 = gemm.dense_epilogue.launches, gemm.blocked_matmul.launches
    main()
    with open(os.path.join(cfg.out, "counters-%s.json" % tag), "w") as fout:
        json.dump({"dense_epilogue": gemm.dense_epilogue.launches - k6,
                   "blocked_matmul": gemm.blocked_matmul.launches - k5,
                   "minibatches": [a - b for a, b in zip(
                       wf.fused_tick.minibatch_counts, before)],
                   "values": [cfg.learning_rate, cfg.gradient_moment],
                   "best_validation_errors": wf.decision.best_n_err[VALID],
                   "resumed": resumed, "device": str(wf.device)}, fout)
'''


def meta_argv(directory, flags, overrides=()):
    """``python -m veles_tpu_torch`` of META_WORKFLOW with its config of
    Range genes, the kernel knobs on, on the card, in ``directory``."""
    return [sys.executable, "-m", "veles_tpu_torch", "meta_wf.py",
            "meta_config.py"] + list(overrides) + [
            "root.meta.epochs=%d" % META_EPOCHS,
            "root.meta.directory=%r" % os.path.join(directory, "mnist"),
            "root.meta.url=%r" % ("file://" + os.path.join(directory,
                                                           "src")),
            "root.meta.out=%r" % directory,
            "root.common.engine.use_pallas=True",
            "root.common.engine.pallas_epilogue=True",
            "root.common.engine.pallas_autotune_cache=%r"
            % root.common.engine.pallas_autotune_cache,
            "--device", "cuda"] + flags


def meta_tree(directory):
    """The fetched directory's files and their mtimes."""
    return {name: os.stat(os.path.join(directory, name)).st_mtime_ns
            for name in sorted(os.listdir(directory))}


def meta_start(device):
    """Phase 29's set-up and its children, on a thread: MNIST-shaped idx
    files gzipped into ``src``; the first read of them through
    MNISTLoader(url_base="file://src") into ``mnist`` on the card (a
    fetch, an .ok marker a file); then, on the thread, the GA
    (--optimize), the ensemble's training and its test, each a child
    process of children on the card. Returns the state meta_finish
    checks."""
    from veles_tpu_torch.dummy import DummyWorkflow as PortDummyWorkflow
    t0 = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="meta_phase_")
    src = os.path.join(directory, "src")
    os.makedirs(src)
    data, labels = bench_dataset(n=MNIST_ROWS, n_valid=MNIST_TEST)
    pixels = numpy.rint(data * 255).astype(numpy.uint8).reshape(-1, 28, 28)
    for prefix, rows in (("t10k", slice(0, MNIST_TEST)),
                         ("train", slice(MNIST_TEST, None))):
        for kind, array in (("images-idx3", pixels[rows]),
                            ("labels-idx1", labels[rows])):
            write_idx(os.path.join(src, "%s-%s-ubyte.gz" % (prefix, kind)),
                      array)
    wf = PortDummyWorkflow()
    wf.device = device
    loader = MNISTLoader(wf, directory=os.path.join(directory, "mnist"),
                         url_base="file://" + src, minibatch_size=4096)
    loader.initialize()
    same = numpy.array_equal(loader.original_data.data.cpu().numpy(),
                             pixels.reshape(len(pixels), -1).astype(
                                 numpy.float32))
    fetched = meta_tree(os.path.join(directory, "mnist"))
    del loader, wf
    with open(os.path.join(directory, "meta_wf.py"), "w") as fout:
        fout.write(META_WORKFLOW)
    with open(os.path.join(directory, "meta_config.py"), "w") as fout:
        fout.write("from veles_tpu_torch.genetics import Range\n\n")
        for path, (default, low, high) in META_GENES:
            fout.write("%s = Range(%r, %r, %r)\n"
                       % (path, default, low, high))
    state = {"directory": directory, "fetched": fetched, "same": same,
             "runs": {}, "t0": t0, "stop": False}

    def child(name, flags, overrides=()):
        # a session of its own: a stop (an earlier phase failed) or the
        # deadline kills the child and the children it started
        started = time.perf_counter()
        outs = [tempfile.TemporaryFile("w+") for _ in range(2)]
        proc = subprocess.Popen(meta_argv(directory, flags, overrides),
                                cwd=directory, env=port_env(),
                                stdout=outs[0], stderr=outs[1], text=True,
                                start_new_session=True)
        while proc.poll() is None:
            if state["stop"] or time.perf_counter() - started \
                    > META_DEADLINE:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                raise AssertionError("phase 29 %s stopped after %.1f s"
                                     % (name, time.perf_counter() - started))
            time.sleep(0.2)
        for out in outs:
            out.seek(0)
        stdout, stderr = (out.read() for out in outs)
        state["runs"][name] = (proc.returncode, stdout, stderr,
                               time.perf_counter() - started)
        if proc.returncode:
            raise AssertionError("phase 29 %s exited %d:\n%s"
                                 % (name, proc.returncode, stderr[-4000:]))

    def drive():
        try:
            child("optimize", ["--optimize", META_OPTIMIZE, "--seed",
                               "genetics=%d,default=1,loader=2"
                               % META_SEED])
            state["ga"] = set(meta_counters(directory))
            # the ensemble's instances snapshot their best epoch: the
            # test re-runs each snapshot
            child("ensemble_train", ["--ensemble-train", META_ENSEMBLE,
                                     "--seed", "ensemble=%d" % META_SEED],
                  ["root.meta.snapshot=True"])
            child("ensemble_test", ["--ensemble-test", "ensemble.json"],
                  ["root.meta.snapshot=True"])
        except BaseException as exc:   # noqa: BLE001 - meta_finish raises
            state["error"] = exc
    state["thread"] = threading.Thread(target=drive, name="meta-phase")
    state["thread"].start()
    print("phase 29 set-up (idx files written, first read through the "
          "downloader): %.1f s" % (time.perf_counter() - t0))
    return state


def meta_counters(directory):
    """Every child's counters file, by its pid."""
    out = {}
    for name in os.listdir(directory):
        if name.startswith("counters-"):
            with open(os.path.join(directory, name)) as fin:
                out[name[9:-5]] = json.load(fin)
    return out


def meta_finish(state):
    """Phase 29's checks, after its thread: (a) the GA's generations equal
    the port's Population replayed here (on the host) from the same seed
    and fitnesses, the best fitness is -best_validation_errors of its
    child, and every child trained on the card with K6 on each minibatch
    and K5 on each train one; (b) ensemble.json lists three instances, and
    each test child's dumped outputs read back through EnsembleLoader
    equal the dumped values bit for bit; the children's reads fetched
    nothing (the .ok markers). Returns the GA's and the ensemble's
    training children's launches."""
    from veles_tpu_torch.dummy import DummyWorkflow as PortDummyWorkflow
    from veles_tpu_torch.ensemble import EnsembleLoader, build_combiner_file
    from veles_tpu_torch.genetics import Range
    from veles_tpu_torch.genetics.core import Population
    state["thread"].join()
    directory = state["directory"]
    try:
        if "error" in state:
            raise state["error"]
        runs = state["runs"]
        counters = meta_counters(directory)
        got = json.loads(runs["optimize"][1])
        pops = got["populations"]
        prng.get("genetics").seed(META_SEED)
        replay = Population([(path, Range(*bounds))
                             for path, bounds in META_GENES],
                            size=int(META_OPTIMIZE.split(":")[0]))
        for generation, pop in enumerate(pops):
            if [m.values for m in replay.members] != [v for v, _ in pop]:
                raise AssertionError("(a) generation %d: %s, the replay %s"
                                     % (generation, pop,
                                        [m.values for m in replay.members]))
            for member, (_, fitness) in zip(replay.members, pop):
                member.fitness = fitness
            if generation + 1 < len(pops):
                replay.evolve()
        fresh = {pid: c for pid, c in counters.items() if not c["resumed"]}
        best = [c for pid, c in fresh.items() if pid in state["ga"]
                and c["values"] == list(got["best_values"].values())]
        launches = collections.Counter()
        for c in fresh.values():
            test, valid, train_mb = c["minibatches"]
            want = {"dense_epilogue": test + valid + train_mb,
                    "blocked_matmul": train_mb}
            if {k: c[k] for k in want} != want or c["device"] != "cuda" \
                    or train_mb < 1:
                raise AssertionError("(a)/(b) a child's launches %s, its "
                                     "minibatches require %s, on %s"
                                     % ({k: c[k] for k in want}, want,
                                        c["device"]))
            for name, n in want.items():
                launches[name] += n
        n_ga = sum(len(pop) for pop in pops)
        print("phase 29 (a) --optimize %s: %d children in %.1f s; "
              "generations %s; best fitness %s at %s (its child's best "
              "validation errors %s); the replay on the host equal"
              % (META_OPTIMIZE, n_ga, runs["optimize"][3],
                 [[f for _, f in pop] for pop in pops],
                 got["best_fitness"], got["best_values"],
                 [c["best_validation_errors"] for c in best]))
        if not best or any(got["best_fitness"]
                           != -c["best_validation_errors"] for c in best):
            raise AssertionError("(a) the best fitness %s is no child's "
                                 "-best_validation_errors" % got)
        with open(os.path.join(directory, "ensemble.json")) as fin:
            ensemble = json.load(fin)
        instances = ensemble["instances"]
        tests = json.loads(runs["ensemble_test"][1])["tests"]
        entries = []
        for name in sorted(os.listdir(directory)):
            if name.startswith("outputs-"):
                with open(os.path.join(directory, name)) as fin:
                    entries.append(json.load(fin))
        if [e["returncode"] for e in instances] != [0, 0, 0] \
                or [t["returncode"] for t in tests] != [0, 0, 0] \
                or len(entries) != 3:
            raise AssertionError("(b) instances %s, tests %s, %d dumps"
                                 % (instances, tests, len(entries)))
        path = build_combiner_file(entries, [0] * MNIST_TEST,
                                   os.path.join(directory, "models.json"))
        wf = PortDummyWorkflow()
        wf.device = torch.device("cpu")
        loader = EnsembleLoader(wf, file=path, minibatch_size=4096)
        loader.initialize()
        want = numpy.stack([numpy.asarray(e["Output"], numpy.float32)
                            for e in entries], axis=1)
        read = loader.original_data.data.numpy()
        print("phase 29 (b) --ensemble-train %s in %.1f s (seeds %s, best "
              "validation errors %s), --ensemble-test in %.1f s: %d dumps "
              "of %s outputs, read back through EnsembleLoader %s"
              % (META_ENSEMBLE, runs["ensemble_train"][3],
                 [e["seed"] for e in instances],
                 [e["results"]["best_validation_errors"]
                  for e in instances], runs["ensemble_test"][3],
                 len(entries), list(want.shape[::2]),
                 "bit for bit" if numpy.array_equal(read, want)
                 else "DIFFERENT"))
        if not numpy.array_equal(read, want) or len(fresh) != n_ga + 3:
            raise AssertionError("(b) the dumped outputs do not read back, "
                                 "or %d fresh children (want %d)"
                                 % (len(fresh), n_ga + 3))
        after = meta_tree(os.path.join(directory, "mnist"))
        markers = sorted(n for n in after if n.endswith(".ok"))
        print("phase 29 (a)+(b) reads: the first through the downloader "
              "(arrays equal the written bytes: %s) left %d .ok markers; "
              "the children's %d reads fetched nothing (the directory "
              "unchanged: %s); phase 29 %.1f s; %s"
              % (state["same"], len(markers), len(counters),
                 after == state["fetched"],
                 time.perf_counter() - state["t0"], card_line()))
        if not state["same"] or len(markers) != 4 \
                or after != state["fetched"]:
            raise AssertionError("(a)+(b) the idx files' reads: %s then %s"
                                 % (state["fetched"], after))
        return launches
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    t0 = time.perf_counter()
    # the native runtime (g++, phase 17) builds while nvcc runs
    native_done = []
    native_build = threading.Thread(
        target=lambda: (build_native(),
                        native_done.append(time.perf_counter())),
        name="native-build")
    native_build.start()
    logs = _build.build()
    built = time.perf_counter()
    print("kernels built in %.1f s" % (built - t0))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    for label, name in (("K1", "paged_attention"),
                        ("K3", "paged_attention_int8"),
                        ("K4", "cache_attend_int8")):
        spills = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            (_build.BUILD_DIR / (name + ".log")).read_text())]
        print("%s ptxas -v: %d functions, %d bytes of spill stores, %d of "
              "spill loads" % (label, len(spills),
                               sum(st for st, _ in spills),
                               sum(ld for _, ld in spills)))
    # phases 1-18 run with every observe plane off, as before phase 19
    real_enable_metrics = hold_planes_off()
    # phases 1-17 run without verdicts: a fresh, empty tuning cache
    isolated = tempfile.TemporaryDirectory()
    root.common.engine.pallas_autotune_cache = os.path.join(
        isolated.name, "empty.json")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timer = Timer(device)
    kernels = [k1_phase(timer, device, gen), k2_phase(timer, device, gen),
               k3_phase(timer, device, gen), k4_phase(timer, device, gen),
               k5_phase(timer, device, gen), k6_phase(timer, device, gen),
               *flash_phase(timer, device, gen)]
    wide = flash_wide_phase(timer, device, gen)
    # K7-K9's f32 routes, reported beside their bf16 readings
    flash_f32 = flash_f32_phase(timer, device, gen)

    def clock(label):
        # where the smoke's time goes: seconds since its start
        print("smoke clock: %.1f s after %s" % (time.perf_counter() - t0,
                                                label))
    clock("the kernel phases")
    for entry in kernels:
        key = entry["name"].replace("flash_attention_", "")
        if key in wide:
            entry["max_abs_err"] = max(entry["max_abs_err"], wide[key])
        if key in flash_f32:
            entry["f32"] = flash_f32[key]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       flash_f32[key]["max_abs_err"])
    prng = numpy.random.RandomState(1)
    prompts = [prng.randint(0, VOCAB, n).tolist()
               for n in numpy.linspace(60, 700, SLOTS).astype(int)]
    launches = collections.Counter(serving_phase(device, prompts))
    for phase in (prefix_phase(device, prng), dense_phase(device)):
        for name, n in phase.items():
            launches[name] += n
    clock("the serving, prefix and dense phases")
    agreement_phase(device, prompts,
                    prefix_waves(numpy.random.RandomState(2)))
    narrow_heads_phase(device, prompts)
    sampling_phase(device, prompts)
    clock("the agreement, heads-of-48 and sampling phases")
    t_survival = time.perf_counter()
    for phase in (breaker_phase(device), swap_phase(device, prompts)):
        for name, n in phase.items():
            launches[name] += n
    print("survival phases (breaker, f32 agreement, hot swap): %.1f s"
          % (time.perf_counter() - t_survival))
    # the training path's kernels count on its main paths alone: the
    # wide MLP and AlexNet with the knobs on
    launches.update((name, n) for name, n in training_phase(device).items()
                    if name in ("blocked_matmul", "dense_epilogue"))
    training_agreement_phase(device)
    clock("the training phases")
    # graph mode and the lower fusion tiers: the wide MLP in graph mode
    # with the knobs on is a main path of K5
    tiers_phase(device)
    launches["blocked_matmul"] += graph_mlp_phase(device)["blocked_matmul"]
    graph_agreement_phase(device)
    alexnet = alexnet_phase(device)
    for name in ("blocked_matmul", "dense_epilogue"):
        launches[name] += alexnet[name]
    conv_agreement_phase(device)
    clock("the tiers, graph, AlexNet and conv phases")
    # the flash kernels count on their two main paths: the long-prompt
    # serving run (K7) and the long-context training run (K7, K8, K9)
    long_serving = long_serving_phase(device, numpy.random.RandomState(4))
    long_agreement_phase(device)
    long_training, long_wall = longctx_training_phase(device)
    kernel_ms = {entry["name"]: entry["ms"] for entry in kernels}
    in_kernels = 1e-3 * sum(kernel_ms[name] * long_training[name]
                            for name in FLASH)
    print("long-context training: K7-K9 account for about %.3f s of the "
          "run's %.3f s (%.1f%%: kernel-phase medians x launches), the "
          "rest %.3f s" % (in_kernels, long_wall,
                           100 * in_kernels / long_wall,
                           long_wall - in_kernels))
    transformer_device_phase(device)
    long_training_agreement_phase(device)
    # graph mode's long-context stack: a main path of K7, K8 and K9 too
    long_graph = longctx_graph_phase(device)
    long_graph_agreement_phase(device)
    for name in FLASH:
        launches[name] = (long_serving[name] + long_training[name]
                          + long_graph[name])
    som_phase(device)
    clock("the long-context and SOM phases")
    # phase 18's parity run and the three digits samples start here and
    # run beside the training-surface, snapshot, CLI, export and REST
    # phases (their checks read no clock)
    parity_dir = tempfile.TemporaryDirectory()
    parity = parity_start(parity_dir.name)
    try:
        # the rest of the training surface: MNIST784 through its idx loader,
        # the regression family (its knobs-on wide MLP a main path of K5 and
        # K6), the normalizers and the file loaders
        t_a4 = time.perf_counter()
        with tempfile.TemporaryDirectory() as directory:
            mnist_phase(device, directory)
            mse = mse_phase(device)
            for name in ("blocked_matmul", "dense_epilogue"):
                launches[name] += mse[name]
            mse_tiers_phase(device)
            mse_agreement_phase(device)
            normalizers_phase(device)
            loader_files_phase(device, directory)
            print("training-surface phases (MNIST784 loader, MSE, "
                  "normalizers, file loaders): %.1f s"
                  % (time.perf_counter() - t_a4))
            # snapshots, the CLI, the native export and per-tick REST
            # serving: the CLI runs (K6 and K5, counted in the subprocess)
            # and the served ticks (K6) are main paths
            t_a5 = time.perf_counter()
            out = os.path.join(directory, "a5")
            os.makedirs(out)
            for name, n in a5_cli_phase(device, directory, out).items():
                launches[name] += n
            a5_agreement_phase(device, out)
            native_build.join()
            if native_done:
                # whether the g++ build overlapped any phase after the build
                print("native runtime built with g++ in %.1f s, %.1f s %s the "
                      "kernels' build ended" % (
                          native_done[0] - t0, abs(built - native_done[0]),
                          "before" if native_done[0] <= built else "after"))
            restored = a5_native_phase(device, out)
            for name, n in a5_rest_phase(device, restored).items():
                launches[name] += n
            del restored
            print("snapshot, CLI, export and REST phases: %.1f s"
                  % (time.perf_counter() - t_a5))
    except BaseException:
        parity_kill(parity)
        parity_dir.cleanup()
        raise
    # parity on the card, the digits samples, the autotune and the
    # routes its verdicts choose: the tuned wide MLP (K6, and K5 where the
    # verdict says) and the tuned int8 burst (K2) are main paths
    t_a6 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        digits_phase()
        try:
            parity_finish(parity)
        finally:
            parity_dir.cleanup()
        cache, stored = autotune_phase(device, out)
        for name, n in tuned_mlp_phase(device, cache, stored).items():
            launches[name] += n
        launches["int8_matmul"] += tuned_serving_phase(
            device, prompts, cache, stored)["int8_matmul"]
        benchmark_phase(device)
    print("parity, samples, autotune and tuned-route phases: %.1f s"
          % (time.perf_counter() - t_a6))
    # the observe plane: the observed bursts and the cost runs are main
    # paths of K1, K2 and K3, the traced CLI run of K6 and K5 (the
    # profiled and the breaker bursts are not counted)
    release_planes(real_enable_metrics)
    for name, n in observe_phase(device, prompts).items():
        launches[name] += n
    # the serving hooks: the hooks burst (K1, K2), the dense int8-KV run
    # (K4, K2) and the cost runs (K1, K2) are main paths
    for name, n in hooks_phase(device, prompts).items():
        launches[name] += n
    # what acts on the hooks: the ladder (K1, K2, K3), the pressure and
    # guard fronts (K1), the rollouts (K4, K2) and the capacity front (K1,
    # K2) are main paths
    for name, n in act_phase(device, prompts).items():
        launches[name] += n
    # the data-parallel mesh and the dashboards: both ranks' K6 and K5
    # are a main path
    for name, n in mesh_phase(device).items():
        launches[name] += n
    # phase 25's cold-live replica starts here: its nvcc builds run
    # beside phases 23 and 24
    early = aot_cold_start(device)
    serve_fleet = tp_early = None
    try:
        # phase 26's bundle and forge server; its packages pack on a
        # thread beside phases 23-25
        serve_fleet = serve_fleet_prepare(device, early)
        # the training fleet: every slave's K6 and K5 are a main path;
        # its (c), the respawn on the digits, starts before phase 24's (a)
        # and its (d) with phase 24's (b) and (c)
        beside = []
        fleet_launches, single = fleet_phase(device, beside)
        for name, n in fleet_launches.items():
            launches[name] += n
        # the fleet x pod composition: every pod rank's K6 and K5 are a
        # main path, and the single-rank slave's of (c)
        for name, n in pod_phase(device, single, beside).items():
            launches[name] += n
        clock("the mesh, fleet and pod phases")
        # phase 26's replicas start beside phase 25's children once its
        # packages (packed on a thread beside phases 23-24) are uploaded
        serve_fleet_start(serve_fleet, device)
        # the AOT bundle: each fresh replica's K1, K3, K4 and K2 and the
        # fresh trainer's K6 and K5 are a main path
        for name, n in aot_phase(device, early).items():
            launches[name] += n
        clock("the AOT phase")
        # phase 27's rank 1 starts beside phase 26: its imports and its
        # weights take as long as that phase
        tp_early = tp_start_follower()
        # the serving fleet and deploys: the surviving replicas' K1 and
        # the rolled-out api's K1 and K2 are a main path
        for name, n in serve_fleet_phase(device, serve_fleet).items():
            launches[name] += n
    except BaseException:
        if tp_early is not None:
            tp_early[1].kill()
            shutil.rmtree(tp_early[0], ignore_errors=True)
        raise
    finally:
        if serve_fleet is not None:
            for child in serve_fleet.get("replicas", []) \
                    + [serve_fleet["forge"]]:
                child.kill()
        early[2].kill()
        shutil.rmtree(early[0], ignore_errors=True)
    clock("the serving fleet phase")
    # phase 29's children (the GA's and the ensemble's) run beside
    # phases 27 and 28
    meta = meta_start(device)
    try:
        # phase 28's rank 1 starts beside phase 27: its imports and its
        # problems take about as long as that phase
        sp_early = sp_start_follower(device)
        try:
            # sharded serving: both ranks' K1, K2, K3 and K4 are a main
            # path, the governor's rungs too
            for name, n in tp_phase(device, gen, tp_early).items():
                launches[name] += n
        except BaseException:
            sp_early[1].kill()
            shutil.rmtree(sp_early[0], ignore_errors=True)
            raise
        clock("the sharded serving phase")
        # the training mesh's model, seq, pipe and expert axes: both
        # ranks' K5 (the model-axis step) and K7-K9 (the Ulysses steps,
        # the f32 one on K7, K8 and K9's f32 route, and the pipeline's
        # stages) are a main path
        for name, n in sp_phase(device, gen, sp_early).items():
            launches[name] += n
        clock("the training mesh phase")
    except BaseException:
        meta["stop"] = True
        meta["thread"].join()
        shutil.rmtree(meta["directory"], ignore_errors=True)
        raise
    # the meta-workflows: every GA and ensemble-training child's K6 and
    # K5 are a main path
    for name, n in meta_finish(meta).items():
        launches[name] += n
    clock("the meta-workflow phase")
    isolated.cleanup()
    print("the smoke's phases and build: %.1f s" % (time.perf_counter()
                                                     - t0))
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] + "_f32" in launches:
            # K7, K8 and K9's f32 route's launches on its main path: phase
            # 28's f32 Ulysses step on both ranks (among "launches" too)
            entry["f32"]["launches"] = launches[entry["name"] + "_f32"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
