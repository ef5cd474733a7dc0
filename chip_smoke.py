"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` next to this
file; exits non-zero (and prints no result line) without them.  Phases, any
failure of which raises:

1. setup — the card's name and power limit; build the kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and show ptxas' register/spill lines;
2. dense kernels — the two dense screens (the trimmed mean in both its
   divisor forms) against their plain PyTorch versions on the card: exact
   (NaN-aware ``==``) at the dense path's shape
   (M = 50, d = 7850, the full width of the linear model) and on edge-case
   payloads (NaN, +-inf, 1e30, ties, +-0, starved rows); within the float32
   summation bound at M = 100, where the plain version sums with a
   reduction tree; then all four dense screens (float and codeword rows)
   exact on nodes whose row counts sit at every boundary of the sorting
   networks' buckets (b - 1, b, b + 1 rows for each bucket b up to 128);
3. sparse kernels — the two gather screens, exact, at the sparse path's
   shape (``small_world(512, 6, 2)``, K = 16, d = 7850), at sparse
   BRIDGE-K / B's (``small_world(512, 8, 2)``, K = 20) and on a table whose
   nodes share few rows, each under the tile kernel's plan and its other
   candidate plans, and on edge-case payloads at K in {3, 16, 40, 63} with
   padded
   slots; the wide path (above the register networks' rows): the dense
   screens at M in {129, 513} and the gather screens at K in {64, 200},
   float and codeword rows, and the dense screens on nodes one row below,
   at and above each warp sort's 32 R rows (R = 1, 2, ..., 64, up to 2048
   rows to sort), the medians exact, the trimmed means exact against the
   plain arithmetic summed left to right and within the summation bound of
   the plain version; the int8 decode in its plain and carry forms, exact
   at M = 512, d = 7850, the plain form also at n in {1, 3, 50, 512} x d in
   {1, 127, 128, 129, 3925, 7850} and on codes one byte past a 16-byte
   boundary.  Every kernel is timed beside
   its plain version and its library yardstick (a call the port never
   makes) with CUDA events;
4. pairwise kernel — the distance kernel of BRIDGE-K / BRIDGE-B against its
   plain version at the main path's shapes ([50, 7850] dense, [100, 7850]
   the int8 form ``cat([w_hat, self_vals])``, [512, 7850] sparse) and on
   NaN, +-inf and 1e30 rows: within the float32 dot-product bound, exactly
   symmetric, an exact zero diagonal, the NaN/inf pattern kept; timed at
   the three shapes beside the plain version, ``torch.mm`` with the same
   epilogue and the bound;
5. codeword screens — this slice's path: the int8 codec's codewords of a
   seeded bank (d = 7850), the Byzantine senders' replaced by
   ``scale_abuse`` and by ``garbage_codeword``, screened through the
   ``kernels.ops`` entries (dense M = 50, b = 4; sparse M = 512, K = 16,
   b = 2), each equal bit for bit to its plain version and to its staged
   twin (the ``dequant`` kernel, then the float screen's kernel), also on
   edge-case codewords; timed beside the staged pair, the plain version
   and, for the medians, ``torch.nanquantile``;
6. dense trainer — `BridgeTrainer` on the MNIST-like linear task, M = 50,
   b = 4, random attack, 200 ticks, for DGD (mean), BRIDGE-T and BRIDGE-M;
   BRIDGE-T / BRIDGE-M must reach 0.95 honest test accuracy while DGD stays
   <= 0.5;
7. sparse trainer — ``BridgeConfig(sparse=True)`` on
   ``small_world(512, 6, 2)``, an iid partition of 16384 samples, batch 8,
   random attack, 200 ticks, for DGD, BRIDGE-T, BRIDGE-M and BRIDGE-T with
   the int8 codec; BRIDGE-T / BRIDGE-M must reach 0.95, DGD stay <= 0.85;
8. dense vector rules — BRIDGE-K and BRIDGE-B at M = 50, b = 4, random
   attack, 200 ticks (the distance kernel once a tick, Bulyan's trimmed
   mean once a tick), and geomedian, clipped_mean, rep_trimmed_mean and
   rep_median for 20 ticks each (no kernel);
9. sparse vector rules — BRIDGE-K and BRIDGE-B on ``small_world(512, 8, 2)``
   (Bulyan needs in-degree 9 at b = 2), K = 20, 200 ticks (the distance
   kernel once a tick, Bulyan's gather trimmed mean once a tick);
10. wire trainer — BRIDGE-T for 200 ticks: dense M = 50 with int8 under
   ``scale_abuse`` and ``garbage_codeword``, the identity codec under
   ``garbage_codeword`` (NaN and inf payloads), int4 and ``topk50_int8``
   under ``random``; sparse M = 512 with int8 under ``scale_abuse``; each
   ``wire_bits_per_edge`` the reference codec's;
11. variants — `repro_torch.sim.variants` at the reference's defaults
   (M = 20, b = 2, random attack): DGD and BRIDGE-T/M/K/B for 120 steps,
   ByRDiE for 2 sweeps (the dense trimmed-mean kernel, in its reciprocal
   form, once per block of 512, 16 a sweep), BRDSO for 120 steps; then the
   table's entry point under ``--codec int4 --attack scale_abuse``;
12. wide trainers — BRIDGE-T and BRIDGE-M for 3 ticks, dense M = 129
   (``erdos_renyi(129, 0.5, 4)``) and sparse K = 64
   (``small_world(128, 30, 2, max_degree=64)``): the wide path once a tick,
   and card-vs-CPU parity on honest rows at rtol 1e-5, atol 1e-6; then each
   of the four timed over 20 ticks on the card (ms/tick);
13. randomness — ``prng.bits`` and ``uniform`` on the card equal the CPU's
   at [512, 7850], ``normal`` within its tolerance of the CPU's; the int8
   encode and carry decode on the card give the CPU's codes, scales,
   ``x_hat`` and residual exactly;
14. parity — from one init and one batch stream (M = 50): 5 ticks on the
   card and on the CPU agree at rtol 1e-4, atol 1e-5 (sign flip dense;
   random attack dense and sparse, on honest rows); one int8 tick gives the
   CPU's honest carry exactly; the dense and the sparse trainer give
   bit-identical parameters on the card; BRIDGE-K and BRIDGE-B for 3
   ticks, one ByRDiE sweep and one BRDSO step agree with the CPU, and
   dense and sparse K and B are bit-identical on the card.

15. views kernels — the network runtime's screens over each node's own
   mailbox views ``[M, W, d]`` under its usable mask (``views_screen.cu``,
   the TPU kernels' own form) against their plain versions on edge-case
   views: dense W = 50, materialized and with a receiver stride of 0 (a
   broadcast expanded, read in place), sparse K = 16, the wide path at
   W = 129 (stride 0 too) and K = 64, starved nodes included; timed at the
   dense runtime's shape (M = 50, ``erdos_renyi(50, 0.5, 4)``, d = 7850)
   and at the sparse one's (M = 512, K = 16);
16. net trainer — the network runtime (`repro_torch.net`), d = 7850, each
   run's ``run_scan`` over batches stacked on the card (ms/tick and the
   mailbox state's bytes printed): (a) the ideal channel against the
   synchronous trainer, bit for bit after 200 ticks, dense M = 50, b = 4,
   random attack, BRIDGE-T and BRIDGE-M; (b) the net benchmark's settings
   (M = 20, ``erdos_renyi(20, 0.5, 2)``, b = 2, BRIDGE-T, ``alie``, t0 = 30,
   batch 32, 120 ticks) under every ``NET_SCENARIOS`` entry and
   ``selective_victim`` under ``lossy``; (c) dense M = 50 BRIDGE-T under
   ``lossy_laggy`` and ``narrowband64k`` with the identity and the per-link
   int8 codec (100 ticks); (d) the sparse runtime at the scale benchmark's
   settings (``small_world(512, 6, 1)``, b = 1, ``alie``, drop 0.05,
   staleness 2, t0 = 100, batch 8, 200 ticks), and dense against sparse
   bit for bit at M = 48 over 20 ticks.  Each accuracy within 0.01 of the
   reference's, and the means of ``delivered_frac`` and ``mean_staleness``
   equal to the reference's (``REFERENCE_NET``); the views kernels launched
   once a tick, ``dequant_carry`` once a tick under int8.  Then the dense
   ``lossy_laggy`` runs and the sparse run are profiled;
17. views BRIDGE-K / BRIDGE-B — the batched distance kernel (batch = node,
   each node's mailbox views and its own value; batch = cell, a grid's
   ``[E, M, d]`` rows) on the body ``pairwise.batch_plan`` picks (the
   cluster body, or the batch body for elements of at most 17 rows)
   against its plain version, node by node within the float32 dot-product
   bound, symmetric, with a zero diagonal, and every node equal bit for
   bit to the unbatched kernel of its rows and to the cluster body forced:
   dense M = W = 50, materialized and with a receiver stride of 0, sparse
   M = 512, K = 16, the net phase's M = W = 20, the K / B grid's E = 8,
   M = 50, K = 64, and NaN / +-inf / 1e30 rows at n = 7 and 17; timed
   (the picked body and the cluster body) beside ``torch.bmm`` with the
   same epilogue and the bound.  Then `AsyncBridgeTrainer` BRIDGE-K and
   BRIDGE-B at the net benchmark's settings on ``erdos_renyi(20, 0.9, 1)``
   (b = 1, ``alie``, t0 = 30, batch 32, 120 ticks) under ``ideal`` and
   ``lossy``: the distance kernel once a tick (Bulyan's views trimmed mean
   too, held exactly against its plain version at two ticks), accuracy
   within 0.01 of the reference's and the channel means equal to its
   (``REFERENCE_NET``), and 3 ticks of card-vs-CPU parity on honest rows;
   last BRIDGE-K over the sparse runtime at the scale benchmark's settings
   (``small_world(512, 6, 1)``, K = 16, b = 1, ``alie``, drop 0.05,
   staleness 2, t0 = 100, batch 8, 20 ticks): the batch body once a tick,
   ms/tick, accuracy within 0.01 of the reference's and the channel means
   equal to its (``REFERENCE_NET["net sparse krum"]``), and 3 ticks of
   card-vs-CPU parity on honest rows;
18. grids — the experiment-axis forms of the screens (the dense register
   kernels at E = 8, M = 12; the gather kernels at E = 4, M = 512, K = 16
   with per-experiment b; the wide path at E = 2, M = 129) equal their
   unbatched kernels experiment by experiment and their plain versions,
   timed; then `repro_torch.sim.GridEngine` at d = 7850: the reference's
   ``grid_bench`` grid (T / M x random, alie, sign_flip x 8 seeds, M = 12,
   b = 2, batch 32, 30 ticks), BRIDGE-K / BRIDGE-B at M = 50 (b = 4, random
   and alie, 2 seeds, 30 ticks), a sparse grid on ``small_world(512, 6, 2)``
   (T / M, random, 4 seeds, b = 2, t0 = 100, batch 8, 50 ticks) and a wide
   dense grid at M = 129 (T / M, 2 seeds, 3 ticks): every screening kernel
   launched once a tick per group, every cell equal to its own
   `BridgeTrainer` run on the card (parameters and key bit for bit), the
   T / M cells of the 30- and 50-tick grids at 0.95 honest accuracy or
   more, and cells/s and ms/tick of the engine against the cells run one by
   one; last, ``python -m repro_torch.launch.sweep --mode grid`` into a
   temporary store, whose second run finds every cell cached;
19. net grids — the views kernels with the experiment axis (one launch
   over ``[E, M, W, d]``, a usable mask a cell, per-cell b) at E = 44,
   M = W = 20 and E = 8, M = 512, K = 16, exact against their plain
   versions and each cell against the one-cell kernel, timed beside the
   path they replace (one launch per b over copied views); then
   `GridEngine(..., num_ticks=...)` at the net benchmark's task (d = 7850,
   b = 2, ``alie``, t0 = 30, batch 32, 30 ticks): (a) BRIDGE-T / M x the 11
   ``NET_SCENARIOS`` x seeds 0-1 on ``default_topology(20, (trimmed_mean,
   median), (2,))`` (44 cells), (b) BRIDGE-K / B x ``ideal``, ``lossy`` x
   b in {1, 2} (8 cells, the batched distance kernel over E M nodes), (c)
   the sparse runtime at the scale setting (``small_world(512, 6, 1)``,
   T / M x ``lossy``, ``lossy_laggy`` x 2 seeds, b = 1, t0 = 100, batch 8,
   20 ticks, one union table): each kernel once a tick per group, the
   views calls of two ticks held exactly against the plain versions on the
   path's operands, every cell equal to its own trainer run over
   ``schedule_for(scenario)`` (parameters and key, the channel streams),
   cells/s and ms/tick against the cells one by one, the mailbox bytes;
   last the sweep's grid mode with ``--scenarios ideal,lossy``, twice;
20. codec grids — lossy codecs and wire attacks over the grids' cells:
   (a) the ``grid_bench`` grid (M = 12, b = 2, 10 ticks) under T / M x
   random, alie, scale_abuse, garbage_codeword x identity, int8, int4,
   topk25_int8 x 2 seeds (64 cells); (b) dense net cells at M = 20 with the
   per-link int8 and int4 carries x ``lossy``, ``lossy_laggy``,
   ``narrowband64k`` x T / M x 2 seeds, ``alie`` (24 cells, 10 ticks); (c)
   the sparse runtime at M = 512, K = 16, int8 x ``lossy`` x T / M x 2
   seeds (10 ticks): each kernel once a tick per group (a lossy dense
   group's rows decoded by one ``dequant_carry`` launch), the per-link
   decodes of two ticks held exactly, every cell equal to its own trainer
   run (its codec carry included), cells/s against one by one, the carry
   bytes;
21. adversaries — the breakdown benchmark's task (M = 10, extreme non-iid,
   4000 / 800 samples, 60 ticks, ``default_topology(10, (T, M), (3,))``):
   T / M x random, alie, ipm, alie_online, dissensus, inner_max,
   equivocate, slander x b in {1, 2, 3} as one grid (48 cells), every cell
   equal to its own trainer run (its ``AdvState`` included) and its honest
   accuracy within 0.01 of the reference's (``REFERENCE_ACCURACY``, group
   ``adversary`` of ``tools/reference_accuracy.py``); whether an adaptive
   adversary beats the best static attack at equal b, on the card and in
   the reference; ms/tick of one BRIDGE-T trainer per adversary; BRIDGE-K
   and BRIDGE-B under ``inner_max`` at M = 20, b = 2; the runtime's message
   forms (``dissensus``, ``equivocate``, dense M = 20, ``lossy_laggy``) and
   ``inner_max`` through the views oracle (sparse M = 512, ``lossy``, 20
   ticks, BRIDGE-T and BRIDGE-M), each within 0.01 of the reference; every
   run's launches exact (a screen a tick, and under ``inner_max`` K + 3
   more forwards and K backwards, K = 6: the views backward kernel 6 a
   sparse tick); under ``inner_max`` the autograd Functions' gradient on
   the run's last operands held against autograd through the plain twins
   (rtol 1e-4), and the screen's forward and backward device times (kept
   off the counts); first the views backward kernels
   (``views_screen_grad_*``) exact against the plain backward at the
   sparse oracle's shape, timed beside it, and their wide kernel (above 64
   slots) exact at M = W = 129;
22. breakdown and search — (a) ``benchmarks/breakdown_bench.py``'s
   certification through `repro_torch.adversary.BreakdownEngine` (M = 10,
   extreme non-iid, 4000 / 800 samples, ``linear_task(10, 60)``'s batches
   stacked on the card, T / M x random, alie, ipm, inner_max, b_max 3, the
   ladder, score_drop 0.25, loss_ratio 50, measure_compile): b*,
   ``certified_monotone`` and every verdict the reference's
   (``REFERENCE_BREAKDOWN``, group ``breakdown`` of
   ``tools/reference_accuracy.py``), every final loss (the b = 0 probe's
   included) within rtol 1e-4 and every score within ``ACC_TOL`` (a
   verdict may move only where the reference's score is within
   ``ACC_TOL`` of its threshold, and is then printed); the bisection's b*
   the ladder's; (b) ``red_team_search`` at its CLI's defaults (BRIDGE-T,
   ipm, b = 2, 40 ticks, population 12, 4 generations): one step built,
   its step calls, best >= default, and generation 0's fitness proposal by
   proposal within rtol 1e-4 of the reference's; (c) a certification
   through the net grids (``lossy``, T x alie_online, b_max 2, 30 ticks:
   the views kernels' experiment axis) held as (a); (d) the sentinel dates
   each probe of the unstable quadratic at the reference's first bad tick,
   and the events file holds the divergences; (e) the batch draw alone and
   BRIDGE-T ms/tick over 200 ticks (dense M = 50, sparse M = 512) with
   ``stack_node_batches`` and a pageable copy and with the device gather,
   each device batch first held bit for bit against the host's; (f)
   ``sweep --mode breakdown`` into a temporary directory, its JSON read
   back, its two rounds' launches held to one screen a tick each.  Every
   round's launches exact (`grid_want` / `net_grid_want`;
   measure_compile runs a round twice);
23. trust and forensics — (a) the screens' decide form
   (``csrc/screen_decide.cu``, ``gather_screen_decide.cu``,
   ``views_screen_decide.cu``: the screening rules' decision twins) against
   its plain twins (``ref.*_decide``), y and trim exactly, y also against
   the plain kernel's: dense M = 50, d = 7850, b = 4 (T and M) and E = 8
   cells with a mask and a b each, gather M = 512, K = 16 and E = 4 with
   per-cell table masks, views M = 512, K = 16, dense views M = W = 50
   (materialized and with a receiver stride of 0) and E = 4, strides 1 and
   16, edge-case payloads on 40 and 100 dense nodes (the 128-row bucket)
   and at K in {3, 16, 40, 63}; timed beside the plain
   kernel, the plain sort and the bound; the wide shapes refused; (b)
   ``benchmarks/trust_bench.py``'s smoke measurements through the port: the
   breakdown study (M = 15, the complete graph, moderate non-iid,
   ``equivocate`` through ``ideal``, 64 ticks, b_max 7, score_drop 0.15:
   static BRIDGE-T against ``rep_trimmed_mean`` with the trust layer), its
   certificates held to the reference's (``REFERENCE_TRUST``, group
   ``trust`` of ``tools/reference_accuracy.py``) and detect-and-expel's b*
   above the static one's; the detection grid (M = 12, the d = 64
   quadratic, 16 ticks, b = 2, ``equivocate`` and ``slander``), each trust
   summary the reference's; the inertness cell (dense async M = 32, 12
   ticks), trust on but inert bit for bit trust off, each ms/tick; (c)
   ``benchmarks/obs_bench.py``'s ``trace_overhead`` cells through the
   sparse runtime (``small_world(512, 6, 2)``, ``alie``, drop 0.05): the
   d = 64 quadratic (20 ticks, stride 4) and the linear task (d = 7850, 3
   ticks, stride 16), traced against untraced bit for bit, AUC, edges seen
   and trim frequencies against the reference's, ms/tick of each; the
   stress cell under BRIDGE-M too; (d) a forensic trace on the synchronous
   trainers at d = 7850 (dense M = 50, sparse M = 512, BRIDGE-T and
   BRIDGE-M, 20 ticks, stride 16), traced against untraced bit for bit;
   (e) ``rep_median`` with the trust layer on its three layouts (dense M =
   50 and sparse M = 512 synchronous at d = 7850, the dense M = 32 runtime
   with the echo; 8 ticks): its decisions from the median decide kernel of
   the layout, the trust state and parameters bit for bit the same run's
   with the decide entries swapped for their plain twins.  Every run's
   launches exact;
24. live metrics, manifests and streaming — first every screen at the
   stream's block widths (dense M = 50: 1024, the 672-wide tail of the
   784 x 10 leaf, the 10-wide bias; sparse M = 512, K = 16: 2048, 1696,
   10 under every candidate tile plan; the views form over a mailbox's
   strided column blocks; the decide forms of all three at strides 1 and
   16) exact against its plain version on the blocks of the model, and
   the block's copy timed beside its screen; the honest mean's node sum
   (``byzantine.node_sum``) bit for bit a row-by-row loop, whole and per
   block; (a) ``benchmarks/obs_bench.py``'s ``metrics_overhead`` paper
   cell (the sparse runtime, M = 512, K = 16, d = 7850, 4 ticks, capacity
   2; then 40 ticks, capacity 20) through ``run_chunks`` with a real
   writer, event log, manifest and Perfetto export: metrics on bit for
   bit metrics off, rows gapless (one a tick across the repeated runs),
   ``monitor --once`` parsing the run, ``trace.json`` written, the
   manifest naming the card; off and on run in turn three times each, their
   median ms/tick and range and the overhead beside the reference's 0.10,
   then a profiled run of each naming what the metered tick adds; (b)
   ``sweep --mode grid --metrics --trace --profile`` at grid_bench's grid
   (48 cells, M = 12, 30 ticks): a ``metrics.jsonl`` stream a cell, every
   cell's AUC in ``obs_summary.json`` the reference's
   (``REFERENCE_SWEEP_OBS``, group ``sweep_obs`` of
   ``tools/reference_accuracy.py``), the manifest naming the card, a
   profiler trace with the kernels in it, the decide launches a (rule,
   attack) group and tick; (c) `repro_torch.stream.StreamBridgeTrainer`
   on the dense M = 50 paper task over 20 ticks: one block (the model as
   one 7850-wide leaf) for BRIDGE-T and BRIDGE-M under ``random`` and
   ``sign_flip`` bit for bit its `BridgeTrainer` run; ``screen_chunk =
   1024`` on ``{w [784, 10], b [10]}`` (9 blocks) under ``sign_flip`` and
   ``alie`` bit for bit; sparse M = 512, K
   = 16 at chunk 2048 (5 blocks) bit for bit; a forensic stream bit for
   bit its untraced run; the network path at drop 0.1; ms/tick of the
   flat trainer, the one-block and the 9-block stream.  Every run's
   launches exact (a screen a block and tick);
25. the wide decide form, the model zoo's dense family and the training
   CLIs — (a) the wide path's decide form (``screen_wide.cuh``, kDecide)
   against its plain twins at dense M = 129 and the views form at W = 129
   (edge-case payloads, the main path's d = 7850), gather and views at
   K = 64, strides 1, 4 and 16: trim exact, y the plain wide kernel's bit
   for bit; timed beside the plain sort; then the wide trainers of phase 12
   with a forensic trace, 3 ticks, bit for bit untraced, one wide decide
   launch a tick; (b) each reduced dense arch (starcoder2-3b, qwen3-4b,
   mistral-nemo-12b, gemma3-12b): ``init_params`` and ``train_loss`` with
   its gradients on the card against the CPU (TF32 off; loss rtol 1e-5,
   gradients rtol 1e-4, atol 1e-6); (c) ``train_llm --small`` at
   stream_bench's cell (M = 4, b = 1, trimmed mean, sign_flip): flat and
   stream (chunk 65536) bit for bit over 3 ticks, ``--resume`` from tick 2
   bit for bit; (d) qwen3-4b at its published widths cut to 2 layers
   (979,776,512 parameters a node) through the stream at M = 4, sequence
   128: 1 tick after a warm-up, ms/tick, finite losses, the peak memory
   of a tick less the bytes resident before it less the gradient below one
   flat [M, d] float32 matrix; (e) ``train_llm`` at its default ~126M
   config (1 tick), ``--trace --trust``, ``--sparse --codec int8`` and
   ``--net`` at ``--small``, ``launch.train --arch <arch> --reduce`` for
   each dense arch (2 steps) and ``sweep --mode net`` (2 jobs): finite
   losses, their screening kernels launched.  The exact runs' launches
   are held (a screen a block and tick, the wide forms a tick);
26. the rest of the model zoo and serving — (a) each reduced config of
   deepseek-v2-236b, deepseek-v3-671b (MTP), rwkv6-3b, zamba2-1.2b (and at
   5 layers, a remainder block), whisper-medium and qwen2-vl-2b:
   ``init_params``, ``train_loss`` with its gradients over two nodes and 4
   ``decode_step`` logits on the card against the CPU (loss rtol 1e-5,
   gradients rtol 1e-4 / atol 1e-6, the embedding's gradient and the
   logits within 1e-5 of their largest); (b) ``serve.generate`` at full
   width (batch 4, prompt 32, 16 greedy tokens) for qwen3-4b,
   deepseek-v2-236b cut to 2 layers (one dense, one MoE), rwkv6-3b,
   zamba2-1.2b, whisper-medium and qwen2-vl-2b: finite logits, the same
   tokens twice, decode against the family's forward within 2e-4 over 8
   tokens, ms a token beside the parameter bytes a step reads, peak
   memory, a profiled step; (c) ``launch.train --reduce`` for
   deepseek-v2-236b (trimmed mean), rwkv6-3b (median) and zamba2-1.2b, and
   the reduced zamba2 through the stream trainer: finite losses, one screen
   a step (a block and tick on the stream), held exactly;
27. the sharded path on ``torch.distributed`` in a world of one NCCL rank
   (gloo beside it for a CPU mesh; one card takes one rank) — (a)
   ``gossip_screen_params`` at the paper cell (M = 50 on
   ``erdos_renyi(50, 0.5, 4)``, b = 4, d = 7850) on a (1, 1) card mesh
   against the same call on a (1, 1) CPU mesh: the all_gather schedule,
   trimmed mean, median and mean x random, sign_flip x float, int8, Krum,
   Bulyan; rows 1-2 (the views form over the gathered rows at a receiver
   stride of 0), the mean and the int8 decodes exact, the random attack's
   rows within the normal's tolerance, Krum's picks equal; the
   all_to_all schedule at M = 1 (one node a rank, its only shape on one
   card: NCCL's all_to_all and the plumbing); launches held to a count
   worked out from the cases; (b) ``make_train_step`` on qwen3-4b at its
   published widths cut to 2 layers, M = 4 nodes on the rank, all_gather,
   BRIDGE-T, b = 1, gossip first, sequence 128: a warm-up step and 2 timed
   (ms a step, ``max_memory_allocated``), one under ``torch.profiler``
   (busy share, kernels a step), finite losses, one views trimmed-mean
   launch a leaf and step.

Every accuracy of phases 8-11 and 21 must land within 0.01 of the reference's
own CPU run at the same settings (``REFERENCE_ACCURACY``, from
``tools/reference_accuracy.py``), except where a run's accuracy turns on
Krum's picks (``PICK_BOUND``), which is held to card-vs-CPU parity.

Each configuration of a trainer phase trains on a task of its own, so all
see batches 0..199 of one stream.  Before each main-path phase (5-12,
16-27) every kernel's launch count is set to 0, and read
after its runs: each kernel of the phase must have launched once per
tick of the runs of its rule (codec), the others not at all; a kernel's
``launches`` in the JSON line is the sum over the phases.  Then each
configuration of phases 6-10 is profiled for 10 more ticks (`profile_phase`:
device busy share, kernels per tick, host time per stage), a measurement
that reports a profiler failure instead of raising.

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))  # the kernel tests' edge-case recipes (no JAX)

import torch  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.adversary import adaptive as adaptive_lib  # noqa: E402
from repro_torch.adversary import protocols as adv_lib  # noqa: E402
from repro_torch.adversary.breakdown import BreakdownConfig, BreakdownEngine  # noqa: E402
from repro_torch.adversary.search import SearchConfig, red_team_search  # noqa: E402
from repro_torch.comm import codec as codec_lib  # noqa: E402
from repro_torch.comm import exchange  # noqa: E402
from repro_torch.core import byzantine, screening  # noqa: E402
from repro_torch.core.brdso import BrdsoConfig, BrdsoTrainer  # noqa: E402
from repro_torch.core.bridge import (  # noqa: E402
    WIRE_SALT, BridgeConfig, BridgeTrainer, replicate, stack_batches, stack_flatten)
from repro_torch.core.byrdie import ByrdieConfig, ByrdieTrainer  # noqa: E402
from repro_torch.core.graph import erdos_renyi, small_world  # noqa: E402
from repro_torch.core.neighbors import NeighborTable  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    build, dequant, dequant_screen, gather_screen, median, networks, ops, pairwise, ref,
    screen_decide, screen_wide, trimmed_mean, views_screen)
from repro_torch.kernels import autograd as grad_ops  # noqa: E402
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer, ChannelConfig  # noqa: E402
from repro_torch.net.dynamic import scenario_schedule  # noqa: E402
from repro_torch.net.runtime import SparseUnreliableRuntime  # noqa: E402
from repro_torch.net.scenarios import NET_SCENARIOS, get_scenario  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.models import small as small_model  # noqa: E402
from repro_torch.obs import EventLog, read_events  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    Cell, ExperimentGrid, GridEngine, default_topology, variants)
from repro_torch.sim.tasks import honest_accuracy, linear_task  # noqa: E402
from test_torch_kernels import views_inputs  # noqa: E402

M, B, D = 50, 4, 7850
TICKS = 200
# the sparse path: the reference's scale setting (BENCH_scale.json's graph)
SM, SB, NEAREST = 512, 2, 6
KERNELS = {  # JSON name -> wrapper (its `launches` counter)
    "screen_trimmed_mean_dense": trimmed_mean.trimmed_mean_dense,
    "screen_median_dense": median.median_dense,
    "gather_screen_trimmed_mean": gather_screen.gather_screen_trimmed_mean,
    "gather_screen_median": gather_screen.gather_screen_median,
    "dequant_carry": dequant.dequant_carry,
    "pairwise_sq_dists": pairwise.pairwise_sq_dists,
    "dequant_screen_trimmed_mean_dense": dequant_screen.dequant_screen_trimmed_mean_dense,
    "dequant_screen_median_dense": dequant_screen.dequant_screen_median_dense,
    "gather_dequant_screen_trimmed_mean": gather_screen.gather_dequant_screen_trimmed_mean,
    "gather_dequant_screen_median": gather_screen.gather_dequant_screen_median,
    "dequant": dequant.dequant,
    "screen_wide": screen_wide.launch,
    "views_screen_trimmed_mean": views_screen.views_screen_trimmed_mean,
    "views_screen_median": views_screen.views_screen_median,
    # the batched distances' two bodies (`pairwise.batch_plan` picks one a call)
    "pairwise_sq_dists_batched": pairwise.cluster_body,
    "pairwise_sq_dists_batch_body": pairwise.batch_body,
    # the views screens' backward (inner_max through the sparse runtime's oracle)
    "views_screen_grad_trimmed_mean": grad_ops.views_grad_trimmed_mean,
    "views_screen_grad_median": grad_ops.views_grad_median,
    # the screens' decide form (the trace's forensics and the trust layer)
    "screen_trimmed_mean_dense_decide": screen_decide.trimmed_mean_dense_decide,
    "screen_median_dense_decide": screen_decide.median_dense_decide,
    "gather_screen_trimmed_mean_decide": screen_decide.gather_screen_trimmed_mean_decide,
    "gather_screen_median_decide": screen_decide.gather_screen_median_decide,
    "views_screen_trimmed_mean_decide": screen_decide.views_screen_trimmed_mean_decide,
    "views_screen_median_decide": screen_decide.views_screen_median_decide,
    # the wide path's decide form (above 128 dense rows or 63 slots)
    "screen_wide_decide": screen_wide.launch_decide,
}
COUNTED = KERNELS  # every counted wrapper is in the JSON line
# bits on the wire per message at d = 7850: the reference codec's
# wire_bits (repro.comm.codec; tests/test_torch_comm.py holds the port's
# equal to it for every codec)
REFERENCE_WIRE_BITS = {"identity": 251200, "int8": 64784, "int4": 33384, "topk50_int8": 40236}
# BRIDGE-K / BRIDGE-B on the sparse layout: small_world(512, 8, 2), whose
# in-degrees (12-20) meet Bulyan's max(4b, 3b + 2) + 1 = 9 at b = 2
KB_NEAREST = 8
# the wide path's dense trainer: more senders than the register networks sort
WIDE_M = 129
WIDE_TIMED_TICKS = 20  # the wide trainers' timed run on the card
PLAIN_TICKS = 20  # geomedian, clipped_mean, rep_trimmed_mean, rep_median
# The reference's honest test accuracy at each configuration below, on a CPU
# (tools/reference_accuracy.py: the same settings, seeds and batches); the
# card must land within ACC_TOL of each.
REFERENCE_ACCURACY = {
    "dense krum": 0.9785869989706122, "dense bulyan": 0.9989783323329428,
    "dense geomedian": 0.9885217871354974, "dense clipped_mean": 0.9879783106886822,
    "dense rep_trimmed_mean": 0.9881522240846053, "dense rep_median": 0.9865870022255442,
    "sparse krum": 0.8641510210785212, "sparse bulyan": 0.9918059280105666,
    "variants DGD": 0.19861110630962583, "variants BRIDGE-T": 0.9924305544959174,
    "variants BRIDGE-M": 0.9915972087118361, "variants BRIDGE-K": 0.9520833061801063,
    "variants BRIDGE-B": 0.9922222230169508, "variants ByRDiE": 0.6275694337156084,
    "variants BRDSO": 0.9916666547457377,
    "wire int8 scale_abuse": 0.9977174271707949,
    "wire int8 garbage_codeword": 0.9970869940260182,
    "wire identity garbage_codeword": 0.9970652551754661,
    "wire int4 random": 0.9973695990831956, "wire topk50_int8 random": 0.9973478680071624,
    "wire sparse int8 scale_abuse": 0.9930431743462881,
    "variants DGD identity scale_abuse": 0.9914583133326637,
    "variants DGD int4 scale_abuse": 0.11090277673469649,
    "variants BRIDGE-T identity scale_abuse": 0.9911110831631554,
    "variants BRIDGE-T int4 scale_abuse": 0.98499995470047,
    "variants BRIDGE-M identity scale_abuse": 0.9909027483728197,
    "variants BRIDGE-M int4 scale_abuse": 0.9847916265328726,
    "variants BRIDGE-K identity scale_abuse": 0.9718055360847049,
    "variants BRIDGE-K int4 scale_abuse": 0.936944435040156,
    "variants BRIDGE-B identity scale_abuse": 0.9906249642372131,
    "variants BRIDGE-B int4 scale_abuse": 0.9790971974531809,
}
ACC_TOL = 0.01
# The reference's asynchronous runs (tools/reference_accuracy.py, group net):
# honest test accuracy (also in REFERENCE_ACCURACY) and the per-tick means
# of delivered_frac and mean_staleness, which depend on the channel draws
# alone and must be equal.
REFERENCE_NET = {
    "net ideal": (0.9922916690508524, 1.0, 0.0),
    "net lossy": (0.9915972054004669, 0.799583375453949, 0.24948915839195251),
    "net laggy": (0.9884721802340614, 0.6760938167572021, 1.1965116262435913),
    "net lossy_laggy": (0.9884027474456363, 0.5818229913711548, 1.4862993955612183),
    "net bandwidth64": (0.9300694266955057, 1.0, 0.0),
    "net narrowband64k": (0.984166638718711, 0.9750000238418579, 2.924999952316284),
    "net churn": (0.9914583199554019, 1.0, 0.41351696848869324),
    "net partition": (0.9916666514343686, 1.0, 0.06562499701976776),
    "net smallworld_lossy": (0.9923611084620158, 0.9018229246139526, 0.1087181493639946),
    "net geometric_churn": (0.9918055401908027, 1.0, 0.2438795119524002),
    "net torus_laggy": (0.9886805216471354, 0.6978124976158142, 0.8787201046943665),
    "net lossy selective_victim": (0.9914583166440328, 0.799583375453949, 0.24948915839195251),
    "net dense lossy_laggy identity": (0.9940217759298242, 0.582976758480072, 1.4799712896347046),
    "net dense lossy_laggy int8": (0.9940000383750253, 0.582976758480072, 1.4799712896347046),
    "net dense narrowband64k identity": (0.41358697608761164, 0.9700000286102295,
                                         2.9100000858306885),
    "net dense narrowband64k int8": (0.9968261265236399, 1.0, 0.0),
    "net sparse lossy": (0.9936497454074031, 0.9500236511230469, 0.051934413611888885),
    # BRIDGE-K / BRIDGE-B over views (tools/reference_accuracy.py, group net_kb)
    "net krum ideal": (0.9623026189051176, 0.9999999403953552, 0.0),
    "net krum lossy": (0.9612499851929514, 0.7994758486747742, 0.24931100010871887),
    "net bulyan ideal": (0.9911841875628421, 0.9999999403953552, 0.0),
    "net bulyan lossy": (0.9908552326654133, 0.7994758486747742, 0.24931100010871887),
    # BRIDGE-K over the sparse runtime at the scale setting, 20 ticks (group net_kb)
    "net sparse krum": (0.7046027725923318, 0.9514811635017395, 0.04794158786535263),
}
REFERENCE_ACCURACY.update({tag: acc for tag, (acc, _, _) in REFERENCE_NET.items()})
# the adversaries (tools/reference_accuracy.py group adversary; phase 21)
REFERENCE_ACCURACY.update({
    "adversary trimmed_mean random b1": 0.8938888642523024,
    "adversary trimmed_mean random b2": 0.7879687249660492,
    "adversary trimmed_mean random b3": 0.7148214152881077,
    "adversary trimmed_mean alie b1": 0.8879166377915276,
    "adversary trimmed_mean alie b2": 0.7478124871850014,
    "adversary trimmed_mean alie b3": 0.5473214132445199,
    "adversary trimmed_mean ipm b1": 0.8708333174387614,
    "adversary trimmed_mean ipm b2": 0.7218749821186066,
    "adversary trimmed_mean ipm b3": 0.5857142635754177,
    "adversary trimmed_mean alie_online b1": 0.8812499841054281,
    "adversary trimmed_mean alie_online b2": 0.6437499895691872,
    "adversary trimmed_mean alie_online b3": 0.5135714156287057,
    "adversary trimmed_mean dissensus b1": 0.8338888684908549,
    "adversary trimmed_mean dissensus b2": 0.7926562204957008,
    "adversary trimmed_mean dissensus b3": 0.6330357023647853,
    "adversary trimmed_mean inner_max b1": 0.8506944245762296,
    "adversary trimmed_mean inner_max b2": 0.6162499859929085,
    "adversary trimmed_mean inner_max b3": 0.5008928392614637,
    "adversary trimmed_mean equivocate b1": 0.8818055391311646,
    "adversary trimmed_mean equivocate b2": 0.6448437348008156,
    "adversary trimmed_mean equivocate b3": 0.5132142731121608,
    "adversary trimmed_mean slander b1": 0.9874999721844991,
    "adversary trimmed_mean slander b2": 0.9779687225818634,
    "adversary trimmed_mean slander b3": 0.9687499914850507,
    "adversary median random b1": 0.8579166399108039,
    "adversary median random b2": 0.7948437184095383,
    "adversary median random b3": 0.7133928452219281,
    "adversary median alie b1": 0.8515277637375726,
    "adversary median alie b2": 0.7289062291383743,
    "adversary median alie b3": 0.46124998586518423,
    "adversary median ipm b1": 0.8479166428248087,
    "adversary median ipm b2": 0.7542187348008156,
    "adversary median ipm b3": 0.6558928489685059,
    "adversary median alie_online b1": 0.8563888536559211,
    "adversary median alie_online b2": 0.688906230032444,
    "adversary median alie_online b3": 0.581964271409171,
    "adversary median dissensus b1": 0.821249975098504,
    "adversary median dissensus b2": 0.789374977350235,
    "adversary median dissensus b3": 0.6783928530556815,
    "adversary median inner_max b1": 0.8563888536559211,
    "adversary median inner_max b2": 0.688906230032444,
    "adversary median inner_max b3": 0.5810714364051819,
    "adversary median equivocate b1": 0.8563888536559211,
    "adversary median equivocate b2": 0.688906230032444,
    "adversary median equivocate b3": 0.5812499948910305,
    "adversary median slander b1": 0.9527777565850152,
    "adversary median slander b2": 0.9517187252640724,
    "adversary median slander b3": 0.9510714071137565,
    "adversary krum inner_max b2 (M=20)": 0.16576388478279114,
    "adversary bulyan inner_max b2 (M=20)": 0.7555555436346266,
    "adversary net lossy_laggy dissensus": 0.8183333178361257,
    "adversary net lossy_laggy equivocate": 0.8932638731267717,
    "adversary net sparse lossy inner_max": 0.9296712749391619,
    "adversary net sparse lossy inner_max median": 0.9245010223640621,
})
NET_TICKS = 120  # the net benchmark's run (benchmarks/net_bench.py)
NET_DENSE_TICKS = 100  # dense M = 50 under lossy_laggy / narrowband64k
SPARSE_K_TICKS = 20  # BRIDGE-K over the sparse runtime, M = 512, K = 16
# Configurations whose run's accuracy is no measure of agreement: Krum's
# pick under the int4 codec turns on the distances' last bits from the
# first ticks, so runs that agree step for step (tests/test_torch_wire.py:
# 3 ticks from the reference's carried state at rtol 1e-5) end apart:
# the reference 0.9369, the port on the CPU 0.9419, on the card 0.9503.
# Each is held instead to 3 ticks of card-vs-CPU parity (`parity_phase`)
# and to ACC_FLOOR, which the attack would break (DGD: 0.11).
PICK_BOUND = {"variants BRIDGE-K int4 scale_abuse"}
ACC_FLOOR = 0.9
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
EPS32 = float(np.finfo(np.float32).eps)
# normal's tolerance against jax.random.normal on the CPU (torch.erfinv in
# place of XLA's polynomial, tests/test_torch_prng.py); the card's draw is
# held to it against the CPU's
NORMAL_RTOL = 5.8e-6


def batcher_pairs(n: int) -> int:
    """Compare-exchanges of Batcher's odd-even merge network on n rows (the
    reference's ``screening._batcher_pairs`` schedule)."""
    count, p = 0, 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        count += 1
            k //= 2
        p *= 2
    return count


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def edge_case_inputs(m: int, d: int, seed: int):
    """w [m, d] with NaN, +-inf, 1e30, ties and +-0 payloads, and an
    adjacency whose first rows are starved (0, 1 and 2 in-neighbors)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, d)).astype(np.float32)
    w[:, : d // 8] = np.round(w[:, : d // 8])  # ties
    for frac, val in ((0.04, np.nan), (0.03, np.inf), (0.03, -np.inf), (0.05, 1e30),
                      (0.03, -1e30), (0.04, -0.0), (0.04, 0.0)):
        w[rng.random((m, d)) < frac] = val
    adj = rng.random((m, m)) < 0.5
    for j, deg in enumerate((0, 1, 2)):
        adj[j] = False
        adj[j, rng.choice([i for i in range(m) if i != j], size=deg, replace=False)] = True
    np.fill_diagonal(adj, False)
    self_vals = rng.normal(size=(m, d)).astype(np.float32)
    self_vals[rng.random((m, d)) < 0.05] = np.nan
    return w, adj, self_vals


def cuda_ms(fn, *, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` calls.
    Each rep first parks the stream in a ~1 ms spin, so the host has
    enqueued all ``inner`` calls before the first one runs and the events
    time the device, not the launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def check_kernel_vs_plain(name, kernel, plain, w, adj, self_vals, *, exact: bool):
    out_k = kernel(w, adj, self_vals)
    out_p = plain(w, adj, self_vals)
    torch.cuda.synchronize()
    same = nan_equal(out_k, out_p)
    if exact:
        if not bool(same.all()):
            raise AssertionError(f"{name}: kernel != plain on {int((~same).sum())} entries "
                                 f"(M={w.shape[0]})")
        return
    # summation-order tolerance: |sequential - tree| <= 2 n eps (count + 1) max|x| / den
    n = w.shape[0]
    finite = torch.where(torch.isfinite(w), w.abs(), 0.0)
    colmax = torch.maximum(finite.max(dim=0).values[None, :],
                           torch.where(torch.isfinite(self_vals), self_vals.abs(), 0.0))
    count = adj.sum(dim=1).to(torch.float32)[:, None]
    tol = 2.0 * n * EPS32 * colmax * (count + 1.0)
    both_finite = torch.isfinite(out_k) & torch.isfinite(out_p)
    ok = torch.where(both_finite, (out_k - out_p).abs() <= tol, same)
    if not bool(ok.all()):
        raise AssertionError(f"{name}: kernel vs plain beyond the summation bound on "
                             f"{int((~ok).sum())} entries (M={n})")


def kernel_phase(dev):
    topo = erdos_renyi(M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.randn((M, D), generator=gen, device=dev)
    tm_kernel = lambda w_, a_, s_: trimmed_mean.trimmed_mean_dense(w_, a_, s_, B)
    tm_plain = lambda w_, a_, s_: ref.trimmed_mean_dense(w_, a_, s_, B)
    cases = {
        "trimmed_mean": (tm_kernel, tm_plain),
        "median": (median.median_dense, ref.median_dense),
    }
    # correctness: main shape, edge payloads at n <= 64 (exact), n = 100 (bound)
    for name, (kern, plain) in cases.items():
        check_kernel_vs_plain(name, kern, plain, w, adj, w, exact=True)
        for m, d, seed, exact in ((M, D, 1, True), (20, 1000, 2, True), (64, 999, 3, True),
                                  (5, 130, 4, True), (100, 2000, 5, name == "median")):
            ew, eadj, eself = (torch.as_tensor(x, device=dev) for x in edge_case_inputs(m, d, seed))
            check_kernel_vs_plain(name, kern, plain, ew, eadj, eself, exact=exact)
            check_kernel_vs_plain(name, kern, plain, ew, eadj, ew, exact=exact)
    # ByRDiE's reciprocal form of the trimmed mean's divisor
    recip_k = lambda w_, a_, s_: trimmed_mean.trimmed_mean_dense(w_, a_, s_, B, recip=True)
    recip_p = lambda w_, a_, s_: ref.trimmed_mean_dense(w_, a_, s_, B, recip=True)
    check_kernel_vs_plain("trimmed_mean recip", recip_k, recip_p, w, adj, w, exact=True)
    for m, d, seed in ((20, 512, 6), (64, 999, 7)):
        ew, eadj, eself = (torch.as_tensor(x, device=dev) for x in edge_case_inputs(m, d, seed))
        check_kernel_vs_plain("trimmed_mean recip", recip_k, recip_p, ew, eadj, eself, exact=True)
    print("kernels: equal to their plain versions (exact at M <= 64, summation bound at M = 100; "
          "the trimmed mean also in its reciprocal form)")

    counts = topo.adjacency.sum(axis=1)
    b_eff = np.minimum(B, np.maximum((counts - 1) // 2, 0))
    tm_ops = D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                     for c, e in zip(counts, b_eff, strict=True))
    med_ops = D * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts)
    # bytes: w (also self) read once, the mask read once, the output written once
    nbytes = 2 * M * D * 4 + M * M

    rows = torch.cat([torch.where(adj[:, :, None], w[None], torch.nan), w[:, None, :]], dim=1)
    records = []
    for name, (kern, plain), ops, replaces, lib_fn in (
        ("screen_trimmed_mean_dense", cases["trimmed_mean"], tm_ops,
         "src/repro/kernels/trimmed_mean.py:109", None),
        ("screen_median_dense", cases["median"], med_ops, "src/repro/kernels/median.py:87",
         lambda: torch.nanquantile(rows, 0.5, dim=1)),
    ):
        err = float((kern(w, adj, w) - plain(w, adj, w)).abs().max())
        records.append(record(name, "src/repro_torch/kernels/csrc/screen.cu", replaces,
                              lambda k=kern: k(w, adj, w), lambda p=plain: p(w, adj, w), lib_fn,
                              nbytes, ops, err))
    print("library: the trimmed mean has no single PyTorch call; the median's is "
          "torch.nanquantile(q=0.5) over the masked [M, M+1, d] rows (NaN for absent rows)")
    return records


def boundary_adjacency(rows, median_rows: bool, seed: int) -> np.ndarray:
    """An ``[m, m]`` mask whose node j has ``rows[j % len(rows)]`` rows to
    sort (one sender fewer for the median, whose own value is a row),
    senders drawn with self-loops allowed so a count can reach m; m as
    large as the kernels take, at most 8 above the largest count."""
    counts = [r - 1 if median_rows else r for r in rows]
    m = min(networks.MAX_ROWS - (1 if median_rows else 0), max(counts) + 8)
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        adj[j, rng.choice(m, size=counts[j % len(counts)], replace=False)] = True
    return adj


def left_to_right_trimmed_mean(w, adj, self_vals, b):
    """`ref.trimmed_mean_dense` with the kept ranks summed left to right at
    any M (the plain version sums with ``torch.sum`` above 64 rows, as the
    reference does): the kernel's order, for exact checks above 64 rows."""
    mask = adj.bool()
    count = mask.sum(dim=1)
    b_eff = ref.effective_trim(b, count)
    order = torch.sort(torch.where(mask[:, :, None], ref.sanitize(w)[None], torch.inf), dim=1).values
    total = torch.zeros_like(self_vals)
    for i in range(mask.shape[1]):
        keep = (i >= b_eff) & (i < count - b_eff)
        total = total + torch.where(keep[:, None], order[:, i], 0.0)
    return (total + self_vals) / (count - 2 * b_eff + 1).to(torch.float32)[:, None]


def bucket_boundary_phase(dev):
    """The four dense screens on nodes whose row counts sit at every
    boundary of the sorting networks' buckets (b - 1, b and b + 1 for each
    bucket b up to 128 rows), exact: float rows with the edge payloads and
    int8 codewords with inf and zero scales, against their plain versions
    (the trimmed means above 64 rows against the plain arithmetic summed
    left to right) and the codeword screens also against their staged
    twins."""
    groups = [tuple(r for r in (b - 1, b, b + 1) if r <= networks.MAX_ROWS)
              for b in networks.BUCKETS]
    d = 1000
    for gi, rows in enumerate(groups):
        for median_rows in (False, True):
            adj_np = boundary_adjacency(rows, median_rows, seed=100 + gi)
            m = adj_np.shape[0]
            w, _, sv = edge_case_inputs(m, d, seed=200 + gi)
            q, sc, _, csv = codeword_edge_inputs(m, d, seed=300 + gi)
            w, sv, q, sc, csv, adj = (torch.as_tensor(a, device=dev)
                                      for a in (w, sv, q, sc, csv, adj_np))
            tag = f"rows {rows}, M={m}"
            if median_rows:
                exact_or_raise(f"median {tag}", median.median_dense(w, adj, sv),
                               ref.median_dense(w, adj, sv))
                got = dequant_screen.dequant_screen_median_dense(q, sc, adj, csv)
                exact_or_raise(f"codeword median {tag}", got,
                               ref.dequant_median_dense(q, sc, adj, csv))
                exact_or_raise(f"codeword median {tag} staged", got,
                               median.median_dense(dequant.dequant(q, sc), adj, csv))
                continue
            got = trimmed_mean.trimmed_mean_dense(w, adj, sv, B)
            exact_or_raise(f"trimmed mean {tag}", got, left_to_right_trimmed_mean(w, adj, sv, B))
            if m <= ref.MAX_EXACT_ROWS:
                exact_or_raise(f"trimmed mean {tag}", got, ref.trimmed_mean_dense(w, adj, sv, B))
            got = dequant_screen.dequant_screen_trimmed_mean_dense(q, sc, adj, csv, B)
            exact_or_raise(f"codeword trimmed mean {tag}", got,
                           left_to_right_trimmed_mean(ref.dequant(q, sc), adj, csv, B))
            exact_or_raise(f"codeword trimmed mean {tag} staged", got,
                           trimmed_mean.trimmed_mean_dense(dequant.dequant(q, sc), adj, csv, B))
    print(f"bucket boundaries: the four dense screens exact on nodes with {[g for g in groups]} "
          f"rows to sort (float and codeword rows, d = {d})")
    return []


def sparse_case_inputs(k: int, d: int, seed: int):
    """``edge_case_inputs`` payloads over n = k + 8 nodes of in-degree at
    most k - 2 (every row of a width-k table has padded slots), the first
    rows starved (0, 1, 2 senders)."""
    n = k + 8
    w, _, self_vals = edge_case_inputs(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    adj = np.zeros((n, n), bool)
    for j in range(n):
        deg = (0, 1, 2)[j] if j < 3 else int(rng.integers(3, max(k - 1, 4)))
        others = np.array([i for i in range(n) if i != j])
        adj[j, rng.choice(others, size=min(deg, max(k - 2, 0)), replace=False)] = True
    return w, adj, self_vals


def exact_or_raise(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    same = nan_equal(got, want)
    if not bool(same.all()):
        raise AssertionError(f"{name}: kernel != plain on {int((~same).sum())} entries")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    finite = torch.isfinite(got) & torch.isfinite(want)
    return float((got - want).abs()[finite].max()) if bool(finite.any()) else 0.0


def record(name, source, replaces, kern, plain, lib_fn, nbytes, ops, err):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
        "max_abs_err": err, "ms": cuda_ms(kern),
        "plain_ms": cuda_ms(plain, reps=21, inner=2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None if lib_fn is None else cuda_ms(lib_fn, reps=21, inner=2),
    }
    print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"library {rec['library_ms']}, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}: "
          f"{nbytes} bytes, {ops} fp32 ops)")
    return rec


def gather_kernel_phase(dev):
    """The gather screens at the sparse path's shape and on edge cases."""
    topo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    table = NeighborTable.from_adjacency(topo, device=dev)
    k = table.k
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    w = torch.randn((SM, D), generator=gen, device=dev)
    tm_kernel = lambda w_, t_, s_: gather_screen.gather_screen_trimmed_mean(
        w_, t_.safe_idx, t_.valid_dev, s_, SB)
    tm_plain = lambda w_, t_, s_: ref.gather_trimmed_mean(w_, t_.safe_idx, t_.valid_dev, s_, SB)
    md_kernel = lambda w_, t_, s_: gather_screen.gather_screen_median(
        w_, t_.safe_idx, t_.valid_dev, s_)
    md_plain = lambda w_, t_, s_: ref.gather_median(w_, t_.safe_idx, t_.valid_dev, s_)
    cases = {"trimmed_mean": (tm_kernel, tm_plain), "median": (md_kernel, md_plain)}
    for name, (kern, plain) in cases.items():
        exact_or_raise(f"gather {name}", kern(w, table, w), plain(w, table, w))
        for kk in (3, 16, 40, 63):
            ew, eadj, eself = sparse_case_inputs(kk, 1000, kk)
            etable = NeighborTable.from_adjacency(eadj, k=kk, device=dev)
            ew, eself = torch.as_tensor(ew, device=dev), torch.as_tensor(eself, device=dev)
            for sv in (ew, eself):
                exact_or_raise(f"gather {name} K={kk}", kern(ew, etable, sv), plain(ew, etable, sv))
    # sparse BRIDGE-K / B's table (K = 20) and one whose consecutive nodes
    # share few rows, through the wrapper (tile_plan's plan) and under the
    # tile kernel's other candidate plans
    tables = {"K=20": NeighborTable.from_adjacency(
        small_world(SM, KB_NEAREST, SB, rewire_prob=0.2, seed=0), device=dev),
        "random K=16": NeighborTable.from_adjacency(random_table(SM, 8, 16, seed=4), k=16,
                                                    device=dev)}
    for tag, tab in tables.items():
        for median, kern, plain in ((False, gather_screen.gather_screen_trimmed_mean, tm_plain),
                                    (True, gather_screen.gather_screen_median, md_plain)):
            plan = gather_screen.tile_plan(SM, tab.k, D, 4, median)
            b = () if median else (SB,)
            args = (w, tab.safe_idx, tab.valid_dev, w, *b)
            want = plain(w, tab, w)
            exact_or_raise(f"gather {kern.__name__} {tag}", kern(*args), want)
            for p in gather_screen.candidates(SM, tab.k, D, 4, median):
                got = gather_screen.launch_tile(kern.__name__, p, (w,), tab.safe_idx,
                                                tab.valid_dev, w, *b)
                exact_or_raise(f"gather {kern.__name__} {tag} {p}", got, want)
            print(f"gather kernels {tag}: {kern.__name__} "
                  f"{cuda_ms(lambda a=args, f=kern: f(*a)):.4f} ms (plan {plan})")
    print(f"gather kernels: equal to their plain versions (exact at M = {SM}, K = {k}, "
          f"d = {D}, at K = 20 and on a table that shares few rows under every candidate plan, "
          f"and on edge cases at K in (3, 16, 40, 63)); plans at K = {k}: "
          f"{gather_screen.tile_plan(SM, k, D, 4)}, median {gather_screen.tile_plan(SM, k, D, 4, True)}")

    counts = table.valid.sum(axis=1)
    b_eff = np.minimum(SB, np.maximum((counts - 1) // 2, 0))
    tm_ops = D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                     for c, e in zip(counts, b_eff, strict=True))
    med_ops = D * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts)
    # bytes: w, self_vals and the output once each, plus the [M, K] table
    nbytes = 3 * SM * D * 4 + SM * k * 5
    gathered = torch.where(table.valid_dev[:, :, None], table.gather_rows(w), torch.nan)
    rows = torch.cat([gathered, w[:, None, :]], dim=1)
    src = "src/repro_torch/kernels/csrc/gather_screen.cu"
    records = []
    for name, key, ops, lib_fn in (
        ("gather_screen_trimmed_mean", "trimmed_mean", tm_ops, None),
        ("gather_screen_median", "median", med_ops, lambda: torch.nanquantile(rows, 0.5, dim=1)),
    ):
        kern, plain = cases[key]
        err = max_abs_err(kern(w, table, w), plain(w, table, w))
        records.append(record(name, src, "src/repro/kernels/gather_screen.py:127",
                              lambda kern=kern: kern(w, table, w),
                              lambda plain=plain: plain(w, table, w), lib_fn, nbytes, ops, err))
    print("library: the gather trimmed mean has no single PyTorch call; the gather median's is "
          "torch.nanquantile(q=0.5) over the gathered [M, K+1, d] rows (NaN in padded slots)")
    return records


def random_table(m: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """An ``[m, m]`` in-neighbor mask with ``lo`` to ``hi`` senders a node,
    drawn at random: consecutive nodes share few rows."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        others = np.array([i for i in range(m) if i != j])
        adj[j, rng.choice(others, size=int(rng.integers(lo, hi + 1)), replace=False)] = True
    return adj


def summation_or_raise(name, got, want, rows, count, self_vals):
    """``got`` within the float32 summation bound of ``want`` where both
    are finite (two orders of the kept ranks of ``rows.shape[1]`` rows,
    plus self), equal elsewhere."""
    torch.cuda.synchronize()
    fin = lambda x: torch.where(torch.isfinite(x), x.abs(), 0.0)
    colmax = torch.maximum(fin(rows).amax(dim=(0, 1))[None, :], fin(self_vals))
    tol = 2.0 * rows.shape[1] * EPS32 * colmax * (count.to(torch.float32)[:, None] + 1.0)
    both = torch.isfinite(got) & torch.isfinite(want)
    ok = torch.where(both, (got - want).abs() <= tol, nan_equal(got, want))
    if not bool(ok.all()):
        raise AssertionError(f"{name}: beyond the summation bound on {int((~ok).sum())} entries")


def wide_boundary_check(dev, regs: int, d: int) -> None:
    """The dense wide screens, float and codeword rows, on nodes whose row
    counts sit one below, at and one above the 32 R rows of the warp sort
    with ``regs`` registers a lane (one sender fewer for the median, whose
    own value is a row), M at least 129 so the wide path runs."""
    rows = [r for r in (32 * regs - 1, 32 * regs, 32 * regs + 1) if r <= screen_wide.MAX_ROWS]
    for median_rows in (False, True):
        counts = [r - 1 if median_rows else r for r in rows]
        m = min(screen_wide.MAX_ROWS - int(median_rows), max(WIDE_M, max(counts) + 8))
        rng = np.random.default_rng(regs)
        adj_np = np.zeros((m, m), bool)
        for j in range(m):
            adj_np[j, rng.choice(m, size=counts[j % len(counts)], replace=False)] = True
        w, _, sv = edge_case_inputs(m, d, seed=regs)
        q, sc, _, csv = codeword_edge_inputs(m, d, seed=regs + 1)
        w, adj, sv, q, sc, csv = (torch.as_tensor(a, device=dev) for a in (w, adj_np, sv, q, sc, csv))
        count = adj.sum(dim=1)
        tag = f"R={regs}, rows {rows}, M={m}"
        for form, x, own, tm, md in (
            ("float", w, sv, lambda: trimmed_mean.trimmed_mean_dense(w, adj, sv, B),
             lambda: median.median_dense(w, adj, sv)),
            ("codeword", ref.dequant(q, sc), csv,
             lambda: dequant_screen.dequant_screen_trimmed_mean_dense(q, sc, adj, csv, B),
             lambda: dequant_screen.dequant_screen_median_dense(q, sc, adj, csv)),
        ):
            if median_rows:
                exact_or_raise(f"wide {form} median {tag}", md(), ref.median_dense(x, adj, own))
                continue
            got = tm()
            exact_or_raise(f"wide {form} trimmed mean {tag}", got,
                           left_to_right_trimmed_mean(x, adj, own, B))
            summation_or_raise(f"wide {form} trimmed mean {tag}", got,
                               ref.trimmed_mean_dense(x, adj, own, B), x[None], count, own)


def wide_kernel_phase(dev):
    """The wide path (above the register networks' rows): the dense screens
    at M = 129 and 513 and the gather screens at K = 64 and 200, float and
    codeword rows, with the edge payloads, and the dense screens at every
    warp sort's boundary row counts (`wide_boundary_check`); the medians
    exact, the trimmed means exact against the plain arithmetic summed left
    to right and within the summation bound of the plain version; timed at
    the dense M = 129 trimmed mean, d = 7850, the shape of
    `wide_trainer_phase`, and held to both checks there too."""
    d = 1000
    for m in (129, 513):
        w, adj_np, sv = edge_case_inputs(m, d, seed=m)
        q, sc, _, csv = codeword_edge_inputs(m, d, seed=m + 1)
        w, adj, sv, q, sc, csv = (torch.as_tensor(a, device=dev) for a in (w, adj_np, sv, q, sc, csv))
        count = adj.sum(dim=1)
        for tag, rows, tm, md, own in (
            ("float", w, lambda: trimmed_mean.trimmed_mean_dense(w, adj, sv, B),
             lambda: median.median_dense(w, adj, sv), sv),
            ("codeword", ref.dequant(q, sc),
             lambda: dequant_screen.dequant_screen_trimmed_mean_dense(q, sc, adj, csv, B),
             lambda: dequant_screen.dequant_screen_median_dense(q, sc, adj, csv), csv),
        ):
            got = tm()
            exact_or_raise(f"wide {tag} trimmed mean M={m}", got,
                           left_to_right_trimmed_mean(rows, adj, own, B))
            summation_or_raise(f"wide {tag} trimmed mean M={m}", got,
                               ref.trimmed_mean_dense(rows, adj, own, B), rows[None], count, own)
            exact_or_raise(f"wide {tag} median M={m}", md(), ref.median_dense(rows, adj, own))
    for k in (64, 200):
        w, adj_np, sv = sparse_case_inputs(k, d, seed=k)
        n = adj_np.shape[0]
        q, sc, _, csv = codeword_edge_inputs(n, d, seed=k + 1)
        table = NeighborTable.from_adjacency(adj_np, k=k, device=dev)
        w, adj, sv, q, sc, csv = (torch.as_tensor(a, device=dev) for a in (w, adj_np, sv, q, sc, csv))
        idx, valid = table.safe_idx, table.valid_dev
        for tag, rows, tm, md, own in (
            ("float", w, lambda: gather_screen.gather_screen_trimmed_mean(w, idx, valid, sv, SB),
             lambda: gather_screen.gather_screen_median(w, idx, valid, sv), sv),
            ("codeword", ref.dequant(q, sc),
             lambda: gather_screen.gather_dequant_screen_trimmed_mean(q, sc, idx, valid, csv, SB),
             lambda: gather_screen.gather_dequant_screen_median(q, sc, idx, valid, csv), csv),
        ):
            got = tm()
            exact_or_raise(f"wide gather {tag} trimmed mean K={k}", got,
                           left_to_right_trimmed_mean(rows, adj, own, SB))
            summation_or_raise(f"wide gather {tag} trimmed mean K={k}", got,
                               ref.gather_trimmed_mean(rows, idx, valid, own, SB),
                               table.gather_rows(rows), valid.sum(dim=1), own)
            exact_or_raise(f"wide gather {tag} median K={k}", md(),
                           ref.gather_median(rows, idx, valid, own))
    print(f"wide path: the dense screens at M in (129, 513) and the gather screens at K in "
          f"(64, 200), float and codeword rows, d = {d}: medians exact, trimmed means exact "
          f"against the left-to-right sum and within the summation bound of the plain version")
    for regs in networks.WARP_REGS:
        wide_boundary_check(dev, regs, d=200)
    print(f"wide path: every warp sort ({networks.WARP_REGS} registers a lane) on nodes with one "
          f"row below, at and above its 32 R rows to sort, up to {screen_wide.MAX_ROWS}: the "
          f"dense screens (M >= 129), float and codeword rows, d = 200, medians exact, trimmed "
          f"means exact against the left-to-right sum and within the summation bound")

    m = WIDE_M
    topo = erdos_renyi(m, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    w = torch.randn((m, D), generator=gen, device=dev)
    counts = topo.adjacency.sum(axis=1)
    b_eff = np.minimum(B, np.maximum((counts - 1) // 2, 0))
    ops = D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                  for c, e in zip(counts, b_eff, strict=True))
    got = trimmed_mean.trimmed_mean_dense(w, adj, w, B)
    want = ref.trimmed_mean_dense(w, adj, w, B)
    exact_or_raise(f"wide float trimmed mean M={m}, d={D}", got,
                   left_to_right_trimmed_mean(w, adj, w, B))
    summation_or_raise(f"wide float trimmed mean M={m}, d={D}", got, want, w[None],
                       adj.sum(dim=1), w)
    err = max_abs_err(got, want)
    rec = record("screen_wide", "src/repro_torch/kernels/csrc/screen_wide.cuh",
                 "src/repro/kernels/trimmed_mean.py:109",
                 lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, B),
                 lambda: ref.trimmed_mean_dense(w, adj, w, B), None, 2 * m * D * 4 + m * m, ops,
                 err)
    print(f"library: the wide path's trimmed mean has no single PyTorch call (timed at dense "
          f"M = {m}, d = {D}; it also runs rows 2-3 and 6-8 above their register networks)")
    return [rec]


def wide_trainer_phase(dev):
    """The wide path on the main path: BRIDGE-T and BRIDGE-M, 3 ticks, dense
    M = 129 on erdos_renyi(129, 0.5, 4) (129 and 130 rows to sort) and
    sparse on small_world(128, 30, 2, max_degree=64) (a 64-slot table),
    random attack, from one init and one batch stream: the card launches
    the wide path once a tick and nothing else, and its parameters agree
    with the CPU run's (the plain versions) on honest rows at the trainer
    tolerance, rtol 1e-5, atol 1e-6; returns the kernel launches those runs
    made.  Then each of the four trains WIDE_TIMED_TICKS ticks on the card
    alone, timed (ms/tick), as a user who scales past the register networks
    runs it."""
    configs = {
        "dense M=129": BridgeConfig(topology=erdos_renyi(WIDE_M, 0.5, B, seed=0), num_byzantine=B,
                                    attack="random", t0=30),
        "sparse K=64": BridgeConfig(topology=small_world(128, 30, SB, seed=0, max_degree=64),
                                    num_byzantine=SB, attack="random", t0=30, sparse=True),
    }
    ticks = 3
    zero_launches()
    for tag, base in configs.items():
        m = base.topology.num_nodes
        task = linear_task(m, partition="iid", num_train=20 * m, num_test=100, device="cpu")
        init = task.init_fn(0)
        batches = [task.batch_fn(i) for i in range(ticks)]
        for rule in ("trimmed_mean", "median"):
            cfg = dataclasses.replace(base, rule=rule)
            states = []
            for device in (dev, "cpu"):
                trainer = BridgeTrainer(cfg, task.grad_fn, device=device)
                if tag == "sparse K=64" and trainer.neighbors.k != 64:
                    raise AssertionError(f"{tag}: the table is {trainer.neighbors.k} slots wide")
                state = trainer.init({k: v.to(device) for k, v in init.items()}, seed=1)
                before = read_launches()
                for batch in batches:
                    state, _ = trainer.step(state, tuple(x.to(device) for x in batch))
                want = {"screen_wide": ticks} if device == dev else {}
                check_grew(f"{tag} {rule} on {device}", before, want)
                states.append((state, trainer.honest_mask.cpu()))
            (gpu, honest), (cpu, _) = states
            for k in gpu.params:
                torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                           rtol=1e-5, atol=1e-6,
                                           msg=f"card vs CPU {tag} {rule} ({k})")
    print(f"wide trainers: dense M = {WIDE_M} and sparse K = 64, BRIDGE-T and BRIDGE-M, {ticks} "
          f"ticks on the card (the wide path once a tick) agree with the CPU on honest rows "
          f"(rtol 1e-5, atol 1e-6)")
    launches = read_launches()
    for tag, base in configs.items():
        m = base.topology.num_nodes
        task = linear_task(m, partition="iid", num_train=20 * m, num_test=100, device=dev)
        for rule in ("trimmed_mean", "median"):
            trainer = BridgeTrainer(dataclasses.replace(base, rule=rule), task.grad_fn, device=dev)
            state = trainer.init(task.init_fn(0), seed=1)
            state, _ = trainer.step(state, task.batch_fn(0))  # first use, untimed
            before = screen_wide.launch.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(WIDE_TIMED_TICKS):
                state, _ = trainer.step(state, task.batch_fn(1 + i))
            torch.cuda.synchronize()
            ms_tick = (time.perf_counter() - t0) / WIDE_TIMED_TICKS * 1e3
            if screen_wide.launch.launches - before != WIDE_TIMED_TICKS:
                raise AssertionError(f"wide trainer {tag} {rule}: the wide path did not run once "
                                     f"a tick")
            print(f"wide trainer {tag} {rule}: {ms_tick:.3f} ms/tick over {WIDE_TIMED_TICKS} ticks "
                  f"on the card (host clock, ending in a synchronize)")
    return launches


def dequant_kernel_phase(dev):
    """The int8 decode, plain and carry forms, on the codec's own codewords
    at the sparse path's shape (zero terms 0) and on edge-case codewords."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    target = torch.randn((SM, D), generator=gen, device=dev) * 1e-2
    est = torch.randn((SM, D), generator=gen, device=dev)
    msg = codec_lib.get_codec("int8").encode(np.array([0, 7], np.uint32), target)
    q, scale = msg.payload, msg.scale
    rng = np.random.default_rng(3)
    eq = torch.as_tensor(rng.integers(-127, 128, size=(SM, D)).astype(np.int8), device=dev)
    nblk = scale.shape[1]
    escale = torch.as_tensor(np.stack([rng.uniform(1e-4, 10, size=(SM, nblk)),
                                       rng.normal(size=(SM, nblk))], -1).astype(np.float32),
                             device=dev)
    escale[0, 0, 0], escale[1, 0, 0], escale[2, 1, 0] = float("inf"), -float("inf"), 0.0
    escale[3, :, 1] = 0.0
    eq[:, :3] = 0
    for qq, sc in ((q, scale), (eq, escale)):
        exact_or_raise("dequant", dequant.dequant(qq, sc), ref.dequant(qq, sc))
        got, want = dequant.dequant_carry(qq, sc, est, target), ref.dequant_carry(qq, sc, est, target)
        for g, w_ in zip(got, want, strict=True):
            exact_or_raise("dequant_carry", g, w_)
    for n in (1, 3, 50, 512):
        for d in (1, 127, 128, 129, 3925, 7850):
            oq, osc, _, _ = codeword_edge_inputs(max(n, 4), d, seed=n + d)
            oq = torch.as_tensor(oq[:n], device=dev)
            osc = torch.as_tensor(osc[:n], device=dev)
            exact_or_raise(f"dequant [{n}, {d}]", dequant.dequant(oq, osc), ref.dequant(oq, osc))
    # the dense runtime's per-link rows (M W = 2500 at M = 50) and rows
    # above gridDim.y's 65535, where a carry block takes more than one row
    for n, d in ((M * M, D), (70000, 130)):
        lt = torch.randn((n, d), generator=gen, device=dev) * 1e-2
        le = torch.randn((n, d), generator=gen, device=dev)
        lmsg = codec_lib.get_codec("int8").encode(np.array([0, n], np.uint32), lt)
        got = dequant.dequant_carry(lmsg.payload, lmsg.scale, le, lt)
        want = ref.dequant_carry(lmsg.payload, lmsg.scale, le, lt)
        for g, w_ in zip(got, want, strict=True):
            exact_or_raise(f"dequant_carry [{n}, {d}]", g, w_)
    base = torch.empty(SM * D + 1, dtype=torch.int8, device=dev)
    moved = base[1:].view(SM, D)  # a contiguous view one byte past a 16-byte boundary
    moved.copy_(eq)
    exact_or_raise("dequant, misaligned codes", dequant.dequant(moved, escale), ref.dequant(eq, escale))
    # the NaN-keeping form (the sharded gossip's decode): a NaN scale and
    # an inf scale times a zero code stay NaN
    nscale = escale.clone()
    nscale[4, 0, 0] = float("nan")
    kept = dequant.dequant(eq, nscale, keep_nan=True)
    exact_or_raise("dequant keep_nan", kept, ref.dequant(eq, nscale, keep_nan=True))
    exact_or_raise("dequant keep_nan, misaligned codes", dequant.dequant(moved, nscale, keep_nan=True),
                   kept)
    if not (bool(torch.isnan(kept[0, :3]).all()) and bool(torch.isnan(kept[4, :128]).all())):
        raise AssertionError("dequant keep_nan: a NaN product did not stay NaN")
    print(f"dequant: plain and carry forms equal to their plain versions (exact at M = {SM}, "
          f"d = {D}, codec codewords and edge-case scales); the carry form also exact on codec "
          f"codewords at [{M * M}, {D}] and [70000, 130]; the plain form also exact at n in "
          f"(1, 3, 50, 512) x d in (1, 127, 128, 129, 3925, 7850) and on codes one byte past a "
          f"16-byte boundary; the NaN-keeping form exact, NaN kept")

    x_hat, resid = dequant.dequant_carry(q, scale, est, target)
    want = ref.dequant_carry(q, scale, est, target)
    err = max(max_abs_err(x_hat, want[0]), max_abs_err(resid, want[1]))
    qf = q.float()
    s_full = ref.expand_scales(scale, D)[0].contiguous()
    lib_x = torch.addcmul(est, qf, s_full)
    lib_r = torch.addcmul(target, qf, s_full, value=-1.0)
    same = bool(nan_equal(lib_x, x_hat).all()) and bool(nan_equal(lib_r, resid).all())
    print(f"library: two torch.addcmul calls on float codes and pre-expanded scales "
          f"(x_hat = est + q s, resid = target - q s); same rounding as the kernel: {same}")
    # bytes: q, est and target in, x_hat and resid out, one (scale, zero) pair per 128
    nbytes = SM * D * (1 + 4 + 4 + 4 + 4) + SM * nblk * 8
    ops = 2 * 2 * SM * D  # two fused multiply-adds per coordinate
    records = [record("dequant_carry", "src/repro_torch/kernels/csrc/dequant.cu",
                      "src/repro/kernels/dequant_screen.py:117",
                      lambda: dequant.dequant_carry(q, scale, est, target),
                      lambda: ref.dequant_carry(q, scale, est, target),
                      lambda: (torch.addcmul(est, qf, s_full),
                               torch.addcmul(target, qf, s_full, value=-1.0)),
                      nbytes, ops, err)]
    # the plain form (the sparse codecs' kept values): q and the pairs in,
    # the decoded values out; one FMA per coordinate
    z_full = ref.expand_scales(scale, D)[1].contiguous()
    err = max_abs_err(dequant.dequant(q, scale), ref.dequant(q, scale))
    print("library: torch.addcmul(zero, q, scale) on float codes and pre-expanded pairs (the "
          "plain decode's yardstick; no NaN guard)")
    records.append(record("dequant", "src/repro_torch/kernels/csrc/dequant.cu",
                          "src/repro/kernels/dequant_screen.py:117",
                          lambda: dequant.dequant(q, scale), lambda: ref.dequant(q, scale),
                          lambda: torch.addcmul(z_full, qf, s_full),
                          SM * D * (1 + 4) + SM * nblk * 8, 2 * SM * D, err))
    return records


def dist_bound(x: torch.Tensor) -> torch.Tensor:
    """The float32 dot-product bound ``4 d 2^-24 (sq_i + sq_j)`` on each
    squared distance of two computations (tests/test_torch_krum.py)."""
    x64 = torch.where(torch.isfinite(x), x, 0.0).double()
    sq = torch.sum(x64 * x64, dim=1)
    return 4.0 * x.shape[1] * 2.0 ** -24 * (sq[:, None] + sq[None, :])


def check_dists(tag: str, got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """The kernel's ``d2`` against the plain version's: symmetric bit for
    bit, zero on the diagonal of every finite row, NaN and inf where the
    plain version has them, finite entries within `dist_bound`; returns the
    largest finite difference."""
    torch.cuda.synchronize()
    if not bool(nan_equal(got, got.T).all()):
        raise AssertionError(f"pairwise {tag}: d2 is not symmetric bit for bit")
    finite_rows = torch.isfinite(x).all(dim=1) & (x.abs().amax(dim=1) < 1e18)
    if not bool((torch.diagonal(got)[finite_rows] == 0).all()):
        raise AssertionError(f"pairwise {tag}: nonzero diagonal on a finite row")
    fin = torch.isfinite(got)
    if not (torch.equal(fin, torch.isfinite(want)) and torch.equal(got.isnan(), want.isnan())
            and bool(nan_equal(got[~fin], want[~fin]).all())):
        raise AssertionError(f"pairwise {tag}: NaN/inf pattern differs from the plain version")
    err = (got.double() - want.double()).abs()
    if not bool((err[fin] <= dist_bound(x)[fin]).all()):
        raise AssertionError(f"pairwise {tag}: kernel vs plain beyond the dot-product bound")
    return float(err[fin].max()) if bool(fin.any()) else 0.0


def pairwise_kernel_phase(dev):
    """The distance kernel against its plain version at the shapes the main
    path gives it — the dense broadcast [50, 7850], the int8 form
    cat([w_hat, self_vals]) [100, 7850], the sparse broadcast [512, 7850] —
    and on NaN, +-inf and 1e30 rows; timed at the sparse shape beside the
    plain version and torch.mm with the same epilogue (cuBLAS SGEMM, TF32
    off), a call the port never makes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    xs = {}
    for n, scale in ((M, 0.05), (SM, 0.05)):
        xs[n] = torch.randn((n, D), generator=gen, device=dev) * scale
    xs[2 * M] = torch.cat([xs[M], xs[M] + 1e-3 * torch.randn((M, D), generator=gen, device=dev)])
    for n, x in xs.items():
        err = check_dists(f"[{n}, {D}]", pairwise.pairwise_sq_dists(x), ref.pairwise_sq_dists(x), x)
        print(f"pairwise [{n}, {D}]: max |kernel - plain| {err:.3g}")
    for n, d in ((64, 1000), (130, 1000), (SM, 777)):
        x = torch.randn((n, d), generator=gen, device=dev)
        x[1] = float("nan")
        x[2, 3], x[3, 0] = float("inf"), -float("inf")
        x[4] = 1e30
        check_dists(f"edge [{n}, {d}]", pairwise.pairwise_sq_dists(x), ref.pairwise_sq_dists(x), x)
    print("pairwise: kernel equal to its plain version within the float32 dot-product bound, "
          "symmetric bit for bit, zero diagonal, NaN/inf pattern kept (main shapes and edge rows)")

    def library(x):
        g = torch.mm(x, x.T)
        sq = torch.diagonal(g)
        d2 = sq[:, None] + sq[None, :] - 2.0 * g
        return torch.where(d2 < 0, 0.0, d2)

    # bytes: x read once, d2 written once; operations: the upper triangle's
    # n (n + 1) / 2 dot products of d multiply-adds (d2 is symmetric)
    nbytes = {n: n * D * 4 + n * n * 4 for n in xs}
    ops = {n: n * (n + 1) * D for n in xs}
    for n in (M, 2 * M):
        x = xs[n]
        bound = max(nbytes[n] / HBM_BYTES_PER_S, ops[n] / FP32_OPS_PER_S) * 1e3
        print(f"pairwise [{n}, {D}] times: kernel {cuda_ms(lambda x=x: pairwise.pairwise_sq_dists(x)):.4f} "
              f"ms, plain {cuda_ms(lambda x=x: ref.pairwise_sq_dists(x), reps=21, inner=2):.4f} ms, "
              f"torch.mm {cuda_ms(lambda x=x: library(x), reps=21, inner=2):.4f} ms, bound "
              f"{bound:.5f} ms; plan {pairwise.split_plan(n, D)}")
    x = xs[SM]
    err = max_abs_err(pairwise.pairwise_sq_dists(x), ref.pairwise_sq_dists(x))
    print(f"library: torch.mm(x, x.T) with the same epilogue (cuBLAS SGEMM, TF32 off); plan at "
          f"[{SM}, {D}] {pairwise.split_plan(SM, D)}")
    return [record("pairwise_sq_dists", "src/repro_torch/kernels/csrc/pairwise.cu",
                   "src/repro/kernels/krum.py:44", lambda: pairwise.pairwise_sq_dists(x),
                   lambda: ref.pairwise_sq_dists(x), lambda: library(x), nbytes[SM], ops[SM], err)]


def zero_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def set_launches(counts: dict) -> None:
    """Put every counter back to ``counts`` (a `read_launches` reading)."""
    for k, fn in COUNTED.items():
        fn.launches = counts[k]


def read_launches() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def check_accuracy(tag: str, acc: float) -> None:
    if tag in PICK_BOUND:
        if not acc >= ACC_FLOOR:
            raise AssertionError(f"{tag}: accuracy {acc:.4f} < {ACC_FLOOR}")
        return
    want = REFERENCE_ACCURACY[tag]
    if not abs(acc - want) <= ACC_TOL:
        raise AssertionError(f"{tag}: accuracy {acc:.4f} not within {ACC_TOL} of the reference's "
                             f"{want:.4f}")


def run_trainer(tag, make_task, topo, cfg, dev, ticks, want_launches, wire_bits=None):
    """``ticks`` ticks of one configuration on a task of its own, so every
    configuration trains on batches 0..ticks-1 of the same stream; checks
    that the kernels grew by ``want_launches`` (the others by 0) and, when
    given, that ``wire_bits_per_edge`` is ``wire_bits``; returns the honest
    accuracy."""
    task = make_task()
    trainer = BridgeTrainer(cfg, task.grad_fn, device=dev)
    state = trainer.init(task.init_fn(0), seed=1)
    before = {k: fn.launches for k, fn in COUNTED.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ticks):
        state, metrics = trainer.step(state, task.batch_fn(i))
    torch.cuda.synchronize()
    ms_tick = (time.perf_counter() - t0) / ticks * 1e3
    acc = task.eval_accuracy(state.params, trainer.honest_mask)
    cons = float(metrics["consensus_dist"])
    # the batch draw alone (host indices, one copy, the gather on the
    # card), on an idle card, from this configuration's own stream, which
    # no later run reads
    torch.cuda.synchronize()
    tb = time.perf_counter()
    for i in range(20):
        task.batch_fn(ticks + i)
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - tb) / 20 * 1e3
    for k, fn in COUNTED.items():
        grew = fn.launches - before[k]
        want = want_launches.get(k, 0)
        if grew != want:
            raise AssertionError(f"{tag}: kernel {k} launched {grew} times in {ticks} ticks, "
                                 f"expected {want}")
    bits = float(metrics["wire_bits_per_edge"])
    if wire_bits is not None and bits != wire_bits:
        raise AssertionError(f"{tag}: wire_bits_per_edge {bits} != the reference's {wire_bits}")
    print(f"trainer {tag}: honest test accuracy {acc:.4f}, consensus {cons:.6g}, "
          f"{ms_tick:.3f} ms/tick over {ticks} ticks; the batch draw alone "
          f"{ms_batch:.3f} ms; wire_bits_per_edge {bits:.0f} (M={topo.num_nodes}, "
          f"b={cfg.num_byzantine}, {cfg.attack} attack, {'sparse' if cfg.sparse else 'dense'}, "
          f"codec {cfg.codec})")
    return acc


def warm_up(task, cfgs, dev):
    """First use of each library call, outside the timed runs."""
    for cfg in cfgs:
        warm = BridgeTrainer(cfg, task.grad_fn, device=dev)
        warm.step(warm.init(task.init_fn(0)), task.batch_fn(0))


def trainer_phase(dev):
    """The dense path; returns the kernel launches it made."""
    make_task = lambda: linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32,
                                    device=dev)
    topo = erdos_renyi(M, 0.5, B, seed=0)
    rules = ("mean", "trimmed_mean", "median")
    cfgs = {rule: BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack="random", t0=30)
            for rule in rules}
    warm_up(make_task(), cfgs.values(), dev)
    zero_launches()
    kernel_of = {"trimmed_mean": "screen_trimmed_mean_dense", "median": "screen_median_dense"}
    acc = {rule: run_trainer(rule, make_task, topo, cfgs[rule], dev, TICKS,
                             {kernel_of[rule]: TICKS} if rule in kernel_of else {})
           for rule in rules}
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    profile_phase(make_task(), cfgs.values(), dev)
    for rule in ("trimmed_mean", "median"):
        if not acc[rule] >= 0.95:
            raise AssertionError(f"{rule} accuracy {acc[rule]} < 0.95")
    if not acc["mean"] <= 0.5:
        raise AssertionError(f"DGD accuracy {acc['mean']} > 0.5: the attack did not bite")
    return launches


def profile_phase(task, cfgs, dev, ticks=10):
    """Device busy share, kernel launches and host time per stage of each
    configuration over ``ticks`` ticks (after 3 warm ones) under
    ``torch.profiler``: a measurement, not a check, run after the launch
    counts were read; a profiler that cannot trace the card is reported."""
    for cfg in cfgs:
        tag = f"{'sparse' if cfg.sparse else 'dense'} {cfg.rule} {cfg.codec} {cfg.attack}"
        trainer = BridgeTrainer(cfg, task.grad_fn, device=dev)
        profile_trainer(tag, trainer, trainer.init(task.init_fn(0), seed=1), task.batch_fn, ticks)


def profile_trainer(tag, trainer, state, batch_fn, ticks=10):
    """`profile_phase`'s measurement of one trainer from ``state``."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for i in range(3):
        state, _ = trainer.step(state, batch_fn(i))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(ticks):
                state, _ = trainer.step(state, batch_fn(i))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
    except RuntimeError as err:
        print(f"profile {tag}: torch.profiler failed ({err})")
        return
    # work on the card: kernels and copies; the record_function ranges'
    # mirrors on the card's timeline are not work
    work = [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("bridge.", "kernels."))]
    copies = [e for e in work if "memcpy" in e.name.lower() or "memset" in e.name.lower()]
    busy_us = sum(e.time_range.elapsed_us() for e in work)
    copy_us = sum(e.time_range.elapsed_us() for e in copies)
    stages = {}
    for e in events:
        if e.name.startswith("bridge.") and e.device_type == cpu:
            stages[e.name] = stages.get(e.name, 0.0) + e.time_range.elapsed_us()
    split = ", ".join(f"{k} {v / ticks / 1e3:.3f}" for k, v in sorted(stages.items()))
    print(f"profile {tag}: {wall_us / ticks / 1e3:.3f} ms/tick under the profiler, device "
          f"busy {busy_us / ticks / 1e3:.3f} ms/tick ({100 * busy_us / wall_us:.1f}%; copies "
          f"{copy_us / ticks / 1e3:.3f}), {(len(work) - len(copies)) / ticks:.1f} kernels "
          f"and {len(copies) / ticks:.1f} copies/tick; host ms/tick per stage: {split}")


def sparse_trainer_phase(dev):
    """The sparse path at the reference's scale setting; returns the kernel
    launches it made."""
    make_task = lambda: linear_task(SM, partition="iid", num_train=16384, num_test=1000, batch=8,
                                    device=dev)
    topo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    runs = (("mean", "identity"), ("trimmed_mean", "identity"), ("median", "identity"),
            ("trimmed_mean", "int8"))
    cfgs = {run: BridgeConfig(topology=topo, rule=run[0], num_byzantine=SB, attack="random",
                              t0=100, sparse=True, codec=run[1]) for run in runs}
    warm_up(make_task(), cfgs.values(), dev)
    zero_launches()
    kernel_of = {"trimmed_mean": "gather_screen_trimmed_mean", "median": "gather_screen_median"}
    acc = {}
    for rule, codec in runs:
        want = {kernel_of[rule]: TICKS} if rule in kernel_of else {}
        if codec == "int8":
            want["dequant_carry"] = TICKS
        acc[rule, codec] = run_trainer(f"sparse {rule} {codec}", make_task, topo,
                                       cfgs[rule, codec], dev, TICKS, want)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    profile_phase(make_task(), cfgs.values(), dev)
    for run in runs[1:]:
        if not acc[run] >= 0.95:
            raise AssertionError(f"sparse {run} accuracy {acc[run]} < 0.95")
    if not acc["mean", "identity"] <= 0.85:
        raise AssertionError(f"sparse DGD accuracy {acc['mean', 'identity']} > 0.85: "
                             f"the attack did not bite")
    return launches


def vector_trainer_phase(dev):
    """The dense path for the vector and plain rules: BRIDGE-K and BRIDGE-B
    (200 ticks) and the plain rules (20 ticks each), M = 50, b = 4,
    random attack; returns the kernel launches it made."""
    make_task = lambda: linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32,
                                    device=dev)
    topo = erdos_renyi(M, 0.5, B, seed=0)
    runs = (("krum", TICKS), ("bulyan", TICKS), ("geomedian", PLAIN_TICKS),
            ("clipped_mean", PLAIN_TICKS), ("rep_trimmed_mean", PLAIN_TICKS),
            ("rep_median", PLAIN_TICKS))
    cfgs = {rule: BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack="random", t0=30)
            for rule, _ in runs}
    warm_up(make_task(), cfgs.values(), dev)
    zero_launches()
    acc = {}
    for rule, ticks in runs:
        want = {"pairwise_sq_dists": ticks} if rule in ("krum", "bulyan") else {}
        if rule == "bulyan":
            want["screen_trimmed_mean_dense"] = ticks
        acc[rule] = run_trainer(rule, make_task, topo, cfgs[rule], dev, ticks, want)
    launches = read_launches()
    profile_phase(make_task(), (cfgs["krum"], cfgs["bulyan"]), dev)
    for rule, _ in runs:
        check_accuracy(f"dense {rule}", acc[rule])
    return launches


def sparse_vector_phase(dev):
    """BRIDGE-K and BRIDGE-B on the sparse path, small_world(512, 8, 2),
    200 ticks each; returns the kernel launches it made."""
    make_task = lambda: linear_task(SM, partition="iid", num_train=16384, num_test=1000, batch=8,
                                    device=dev)
    topo = small_world(SM, KB_NEAREST, SB, rewire_prob=0.2, seed=0)
    cfgs = {rule: BridgeConfig(topology=topo, rule=rule, num_byzantine=SB, attack="random",
                               t0=100, sparse=True) for rule in ("krum", "bulyan")}
    warm_up(make_task(), cfgs.values(), dev)
    zero_launches()
    acc = {}
    for rule, cfg in cfgs.items():
        want = {"pairwise_sq_dists": TICKS}
        if rule == "bulyan":
            want["gather_screen_trimmed_mean"] = TICKS
        acc[rule] = run_trainer(f"sparse {rule}", make_task, topo, cfg, dev, TICKS, want)
    launches = read_launches()
    profile_phase(make_task(), cfgs.values(), dev)
    for rule in cfgs:
        check_accuracy(f"sparse {rule}", acc[rule])
    return launches


def variants_phase(dev):
    """The variants comparison (`repro_torch.sim.variants`) at the
    reference's defaults: DGD and BRIDGE-T/M/K/B for 120 steps, ByRDiE for
    2 sweeps (the dense trimmed-mean kernel once per block of 512, 16 a
    sweep), BRDSO for 120 steps; then the table's entry point under
    ``--codec int4 --attack scale_abuse`` (each variant uncompressed and
    int4, no baselines); returns the kernel launches it made."""
    steps, sweeps = 120, 2
    nblocks = -(-D // 512)
    kernels_of = {"DGD": {}, "BRIDGE-T": {"screen_trimmed_mean_dense": steps},
                  "BRIDGE-M": {"screen_median_dense": steps},
                  "BRIDGE-K": {"pairwise_sq_dists": steps},
                  "BRIDGE-B": {"pairwise_sq_dists": steps, "screen_trimmed_mean_dense": steps},
                  "ByRDiE": {"screen_trimmed_mean_dense": sweeps * nblocks}, "BRDSO": {}}
    runs = [(label, lambda rule=rule: variants.run_decentralized(
        rule=rule, attack="random", num_nodes=20, num_byzantine=2, steps=steps, device=dev))
        for rule, label in variants.VARIANTS]
    runs += [("ByRDiE", lambda: variants.run_byrdie(num_nodes=20, num_byzantine=2, attack="random",
                                                    sweeps=sweeps, device=dev)),
             ("BRDSO", lambda: variants.run_brdso(num_nodes=20, num_byzantine=2, attack="random",
                                                  steps=steps, device=dev))]
    zero_launches()
    acc = {}
    for label, run in runs:
        before = {k: fn.launches for k, fn in COUNTED.items()}
        r = run()
        check_grew(f"variants {label}", before, kernels_of[label])
        acc[f"variants {label}"] = r["accuracy"]
        unit = "sweep" if label == "ByRDiE" else "step"
        print(f"variants {label}: honest test accuracy {r['accuracy']:.4f} (reference "
              f"{REFERENCE_ACCURACY[f'variants {label}']:.4f}), {r['us_per_step'] / 1e3:.3f} "
              f"ms/{unit} (M=20, b=2, random attack)")
    # the int4 row set through the table's own entry point: every kernel of a
    # variant's random-attack run, plus the decode with its carry each int4 step
    before = {k: fn.launches for k, fn in COUNTED.items()}
    rows = variants.main(["--codec", "int4", "--attack", "scale_abuse", "--nodes", "20",
                          "--byzantine", "2", "--steps", str(steps), "--no-baselines",
                          "--device", str(dev)])
    want = {}
    for label, kernels in kernels_of.items():
        if label in ("ByRDiE", "BRDSO"):
            continue
        for k, n in kernels.items():
            want[k] = want.get(k, 0) + 2 * n
    want["dequant_carry"] = len(variants.VARIANTS) * steps
    check_grew("variants --codec int4 --attack scale_abuse", before, want)
    for r in rows:
        tag = f"variants {r['variant']} {r['codec']} scale_abuse"
        acc[tag] = r["accuracy"]
        print(f"{tag}: honest test accuracy {r['accuracy']:.4f} (reference "
              f"{REFERENCE_ACCURACY[tag]:.4f}), {r['us_per_step'] / 1e3:.3f} ms/step, "
              f"{r['wire_bits_per_edge']:.0f} wire bits per edge")
        want_bits = REFERENCE_WIRE_BITS[r["codec"]]
        if r["wire_bits_per_edge"] != want_bits:
            raise AssertionError(f"{tag}: wire bits {r['wire_bits_per_edge']} != {want_bits}")
    launches = read_launches()
    for tag, a in acc.items():
        check_accuracy(tag, a)
    return launches


def check_grew(tag: str, before: dict, want: dict) -> None:
    """Each counted wrapper grew by ``want`` since ``before`` (others by 0)."""
    for k, fn in COUNTED.items():
        grew = fn.launches - before[k]
        if grew != want.get(k, 0):
            raise AssertionError(f"{tag}: kernel {k} launched {grew} times, expected "
                                 f"{want.get(k, 0)}")


def codeword_edge_inputs(m: int, d: int, seed: int):
    """The codeword form of `edge_case_inputs`: codes with ties, zeros and
    -128s; scales of several magnitudes with +-inf and 0 scales (an inf
    scale over zero codes decodes to NaN -> +inf) and nonzero zero terms;
    self values with NaN and +-inf; `edge_case_inputs`' adjacency."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, size=(m, d)).astype(np.int8)
    q[:, : d // 8] = rng.integers(-2, 3, size=(m, d // 8))
    q[rng.random((m, d)) < 0.05] = -128
    q[rng.random((m, d)) < 0.05] = 0
    nblk = -(-d // ref.SCALE_BLOCK)
    scale = np.stack([rng.uniform(1e-3, 0.1, size=(m, nblk)) * 10.0 ** rng.integers(-3, 3, (m, nblk)),
                      rng.normal(size=(m, nblk))], -1).astype(np.float32)
    q[0, :5] = 0
    scale[0, 0, 0] = np.inf
    scale[1, 0, 0] = -np.inf
    scale[2, 0] = 0.0
    scale[3, :, 1] = 0.0
    _, adj, self_vals = edge_case_inputs(m, d, seed)
    self_vals[rng.random((m, d)) < 0.03] = np.inf
    self_vals[rng.random((m, d)) < 0.03] = -np.inf
    return q, scale, adj, self_vals


def codeword_kernel_phase(dev):
    """The int8-codeword screens (rows 6-8) on this slice's path: the int8
    codec's codewords of a seeded bank scaled like iterates, d = 7850, the
    Byzantine senders' replaced by ``scale_abuse`` and by
    ``garbage_codeword``, screened through the `kernels.ops` entries —
    dense at M = 50 on ``erdos_renyi(50, 0.5, 4)``, b = 4, sparse at
    M = 512 on ``small_world(512, 6, 2)``, K = 16, b = 2.  The counts are
    set to 0 before those calls and read after; the outputs then equal,
    bit for bit, their plain versions and their staged twins (the
    ``dequant`` kernel, then the row 1 / 2 / 3 kernel).  Edge-case
    codewords follow, then the times.  Returns (records, launches)."""
    topo = erdos_renyi(M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    table = NeighborTable.from_adjacency(small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0),
                                         device=dev)
    idx, valid = table.safe_idx, table.valid_dev
    int8 = codec_lib.get_codec("int8")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    banks = {}
    for n, b in ((M, B), (SM, SB)):
        x = torch.randn((n, D), generator=gen, device=dev) * 0.05
        key = prng.PRNGKey(n)
        msg = int8.encode(key, x)
        byz = byzantine.byzantine_nodes(n, b, "scale_abuse", 0, dev)
        for attack in ("scale_abuse", "garbage_codeword"):
            hit = byzantine.wire_attack_for(attack)(msg, byz, prng.fold_in(key, WIRE_SALT), 0, D)
            banks[n, attack] = (hit.payload, hit.scale, x)
    # name -> (main-path entry, plain version, staged twin), over (q, scale, self)
    dense = {
        "dequant_screen_trimmed_mean_dense": (
            lambda q, sc, sv, a=adj: ops.dequant_trimmed_mean(q, sc, a, sv, B),
            lambda q, sc, sv, a=adj: ref.dequant_trimmed_mean_dense(q, sc, a, sv, B),
            lambda q, sc, sv, a=adj: trimmed_mean.trimmed_mean_dense(dequant.dequant(q, sc), a,
                                                                      sv, B)),
        "dequant_screen_median_dense": (
            lambda q, sc, sv, a=adj: ops.dequant_median(q, sc, a, sv),
            lambda q, sc, sv, a=adj: ref.dequant_median_dense(q, sc, a, sv),
            lambda q, sc, sv, a=adj: median.median_dense(dequant.dequant(q, sc), a, sv)),
    }
    sparse = {
        "gather_dequant_screen_trimmed_mean": (
            lambda q, sc, sv, i=idx, v=valid: ops.gather_dequant_trimmed_mean(q, sc, i, v, sv, SB),
            lambda q, sc, sv, i=idx, v=valid: ref.gather_dequant_trimmed_mean(q, sc, i, v, sv, SB),
            lambda q, sc, sv, i=idx, v=valid: gather_screen.gather_screen_trimmed_mean(
                dequant.dequant(q, sc), i, v, sv, SB)),
        "gather_dequant_screen_median": (
            lambda q, sc, sv, i=idx, v=valid: ops.gather_dequant_median(q, sc, i, v, sv),
            lambda q, sc, sv, i=idx, v=valid: ref.gather_dequant_median(q, sc, i, v, sv),
            lambda q, sc, sv, i=idx, v=valid: gather_screen.gather_screen_median(
                dequant.dequant(q, sc), i, v, sv)),
    }
    paths = [(name, fns, M) for name, fns in dense.items()]
    paths += [(name, fns, SM) for name, fns in sparse.items()]

    zero_launches()
    outs = {}
    for attack in ("scale_abuse", "garbage_codeword"):
        for name, fns, n in paths:
            outs[name, attack] = fns[0](*banks[n, attack])
    torch.cuda.synchronize()
    launches = read_launches()
    check_grew("codeword screens", {k: 0 for k in COUNTED}, {name: 2 for name, _, _ in paths})
    for (name, attack), out in outs.items():
        _, plain, staged = dict((p[0], p[1]) for p in paths)[name]
        bank = banks[M if name in dense else SM, attack]
        exact_or_raise(f"{name} ({attack}) vs plain", out, plain(*bank))
        exact_or_raise(f"{name} ({attack}) vs staged", out, staged(*bank))
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} ({attack}): non-finite output from finite codewords")
    print(f"codeword screens: the int8 codec's codewords under scale_abuse and garbage_codeword "
          f"through kernels.ops (dense M = {M}, sparse M = {SM}, K = {table.k}, d = {D}) equal "
          f"their plain versions and their staged twins bit for bit; launches {launches}")

    # edge-case codewords: dense at M <= 64 against both, M = 100 against the
    # staged twin (the plain trimmed mean sums above 64 rows with torch.sum)
    for m, d, seed in ((M, D, 21), (20, 1000, 22), (64, 999, 23), (5, 130, 24), (100, 2000, 25)):
        q, sc, a, sv = (torch.as_tensor(x, device=dev) for x in codeword_edge_inputs(m, d, seed))
        for kern, plain, stage in (
            (dequant_screen.dequant_screen_trimmed_mean_dense, ref.dequant_trimmed_mean_dense,
             lambda q_, s_, a_, v_: trimmed_mean.trimmed_mean_dense(dequant.dequant(q_, s_), a_,
                                                                     v_, B)),
            (dequant_screen.dequant_screen_median_dense, ref.dequant_median_dense,
             lambda q_, s_, a_, v_: median.median_dense(dequant.dequant(q_, s_), a_, v_)),
        ):
            tm = kern is dequant_screen.dequant_screen_trimmed_mean_dense
            extra = (B,) if tm else ()
            got = kern(q, sc, a, sv, *extra)
            exact_or_raise(f"{kern.__name__} edge M={m}", got, stage(q, sc, a, sv))
            if m <= ref.MAX_EXACT_ROWS or not tm:
                exact_or_raise(f"{kern.__name__} edge M={m}", got, plain(q, sc, a, sv, *extra))
    for kk in (3, 16, 40, 63):
        _, eadj, _ = sparse_case_inputs(kk, 8, kk)
        q, sc, _, sv = (torch.as_tensor(x, device=dev)
                        for x in codeword_edge_inputs(eadj.shape[0], 1000, kk))
        et = NeighborTable.from_adjacency(eadj, k=kk, device=dev)
        args = (q, sc, et.safe_idx, et.valid_dev, sv)
        staged_args = (dequant.dequant(q, sc), et.safe_idx, et.valid_dev, sv)
        exact_or_raise(f"gather codeword TM K={kk}",
                       gather_screen.gather_dequant_screen_trimmed_mean(*args, SB),
                       ref.gather_dequant_trimmed_mean(*args, SB))
        exact_or_raise(f"gather codeword TM K={kk} staged",
                       gather_screen.gather_dequant_screen_trimmed_mean(*args, SB),
                       gather_screen.gather_screen_trimmed_mean(*staged_args, SB))
        exact_or_raise(f"gather codeword median K={kk}",
                       gather_screen.gather_dequant_screen_median(*args),
                       ref.gather_dequant_median(*args))
        exact_or_raise(f"gather codeword median K={kk} staged",
                       gather_screen.gather_dequant_screen_median(*args),
                       gather_screen.gather_screen_median(*staged_args))
    print("codeword screens: equal to their plain versions and staged twins on edge-case "
          "codewords (inf scales over zero codes, codes of -128, NaN/+-inf self values; dense "
          "M in (5, 20, 50, 64, 100), sparse K in (3, 16, 40, 63))")

    # times on the scale_abuse codewords, with the bound for this input
    records = []
    for n, names, counts, b in ((M, dense, topo.adjacency.sum(axis=1), B),
                                (SM, sparse, table.valid.sum(axis=1), SB)):
        q, sc, sv = banks[n, "scale_abuse"]
        b_eff = np.minimum(b, np.maximum((counts - 1) // 2, 0))
        # the float screen's operations plus one FMA (2 operations) per decoded value
        decode_ops = 2 * D * int(counts.sum())
        tm_ops = D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                         for c, e in zip(counts, b_eff, strict=True)) + decode_ops
        med_ops = D * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts) + decode_ops
        # bytes: codes, scale pairs and self_vals in, the output out, the mask or table
        nbytes = n * D * (1 + 4 + 4) + n * sc.shape[1] * 8 + (n * n if n == M else n * table.k * 5)
        decoded = dequant.dequant(q, sc)
        if n == M:
            rows = torch.cat([torch.where(adj[:, :, None], decoded[None], torch.nan), sv[:, None]], 1)
        else:
            gathered = torch.where(valid[:, :, None], table.gather_rows(decoded), torch.nan)
            rows = torch.cat([gathered, sv[:, None, :]], dim=1)
        for name, (kern, plain, staged) in names.items():
            is_tm = "trimmed_mean" in name
            lib_fn = None if is_tm else (lambda r=rows: torch.nanquantile(r, 0.5, dim=1))
            src = ("src/repro_torch/kernels/csrc/dequant_screen.cu" if n == M
                   else "src/repro_torch/kernels/csrc/gather_screen.cu")
            replaces = {"dequant_screen_trimmed_mean_dense": "src/repro/kernels/dequant_screen.py:147",
                        "dequant_screen_median_dense": "src/repro/kernels/dequant_screen.py:178"
                        }.get(name, "src/repro/kernels/gather_screen.py:178")
            err = max_abs_err(kern(q, sc, sv), plain(q, sc, sv))
            rec = record(name, src, replaces, lambda k=kern: k(q, sc, sv),
                         lambda p=plain: p(q, sc, sv), lib_fn, nbytes,
                         tm_ops if is_tm else med_ops, err)
            staged_ms = cuda_ms(lambda st=staged: st(q, sc, sv))
            print(f"kernel {name}: staged pair (dequant kernel, then the float screen's kernel) "
                  f"{staged_ms:.4f} ms against the fused {rec['ms']:.4f} ms")
            records.append(rec)
    print("library: the codeword trimmed means have no single PyTorch call; the medians' is "
          "torch.nanquantile(q=0.5) over the decoded rows and self (NaN for absent rows)")
    return records, launches


def wire_trainer_phase(dev):
    """BRIDGE-T under the wire attacks and with the new codecs, 200 ticks
    each, each on a task of its own: dense M = 50 with int8 under
    scale_abuse and garbage_codeword, the identity codec under
    garbage_codeword, int4 and topk50_int8 under random; sparse M = 512
    with int8 under scale_abuse.  Every accuracy within 0.01 of the
    reference's, every wire_bits_per_edge the reference codec's; returns
    the kernel launches it made."""
    make_dense = lambda: linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32,
                                     device=dev)
    make_sparse = lambda: linear_task(SM, partition="iid", num_train=16384, num_test=1000, batch=8,
                                      device=dev)
    dtopo = erdos_renyi(M, 0.5, B, seed=0)
    stopo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    runs = (("int8", "scale_abuse", False), ("int8", "garbage_codeword", False),
            ("identity", "garbage_codeword", False), ("int4", "random", False),
            ("topk50_int8", "random", False), ("int8", "scale_abuse", True))
    cfgs = {run: BridgeConfig(topology=stopo if run[2] else dtopo, rule="trimmed_mean",
                              num_byzantine=SB if run[2] else B, attack=run[1], codec=run[0],
                              t0=100 if run[2] else 30, sparse=run[2]) for run in runs}
    dense_cfgs = [cfg for run, cfg in cfgs.items() if not run[2]]
    sparse_cfgs = [cfg for run, cfg in cfgs.items() if run[2]]
    warm_up(make_dense(), dense_cfgs, dev)
    warm_up(make_sparse(), sparse_cfgs, dev)
    zero_launches()
    acc = {}
    for codec, attack, is_sparse in runs:
        want = {("gather_screen_trimmed_mean" if is_sparse else "screen_trimmed_mean_dense"): TICKS}
        if codec in ("int8", "int4"):
            want["dequant_carry"] = TICKS
        elif codec == "topk50_int8":
            want["dequant"] = TICKS  # the kept values' decode; the scatter and adds are plain
        tag = f"wire {'sparse ' if is_sparse else ''}{codec} {attack}"
        acc[tag] = run_trainer(tag, make_sparse if is_sparse else make_dense,
                               stopo if is_sparse else dtopo, cfgs[codec, attack, is_sparse], dev,
                               TICKS, want, wire_bits=REFERENCE_WIRE_BITS[codec])
    launches = read_launches()
    profile_phase(make_dense(), dense_cfgs, dev)
    profile_phase(make_sparse(), sparse_cfgs, dev)
    for tag, a in acc.items():
        check_accuracy(tag, a)
    return launches


def randomness_phase(dev):
    """The Threefry streams and the int8 codec on the card against the CPU,
    at the sparse path's shape [512, 7850]."""
    key = prng.fold_in(prng.PRNGKey(7), 1234)
    shape = (SM, D)
    for name, draw in (("bits", prng.bits), ("uniform", prng.uniform)):
        if not torch.equal(draw(key, shape, dev).cpu(), draw(key, shape, "cpu")):
            raise AssertionError(f"prng.{name}: the card's draw differs from the CPU's")
    got, want = prng.normal(key, shape, dev).cpu(), prng.normal(key, shape, "cpu")
    rel = float(((got - want).abs() / want.abs().clamp_min(EPS32)).max())
    same = float((got == want).to(torch.float32).mean())
    if not rel <= NORMAL_RTOL:
        raise AssertionError(f"prng.normal: card vs CPU relative {rel} > {NORMAL_RTOL}")
    print(f"randomness: bits and uniform on the card equal the CPU's at {list(shape)}; normal "
          f"within a relative {rel:.3g} of the CPU's (equal on {100 * same:.1f}%, "
          f"tolerance {NORMAL_RTOL})")
    rng = np.random.default_rng(4)
    x, est, resid = (rng.normal(size=shape).astype(np.float32) * scl for scl in (0.05, 0.05, 1e-3))
    c = codec_lib.get_codec("int8")
    outs = []
    for device in (dev, "cpu"):
        state = exchange.CommState(*(torch.as_tensor(a, device=device) for a in (est, resid)))
        msg, target = exchange.encode(c, key, torch.as_tensor(x, device=device), state)
        x_hat, new = exchange.decode(c, msg, target, state)
        outs.append([t.cpu() for t in (msg.payload, msg.scale, x_hat, new.resid)])
    for name, a, b in zip(("codes", "scales", "x_hat", "resid"), *outs, strict=True):
        if not torch.equal(a, b):
            raise AssertionError(f"int8 exchange: the card's {name} differ from the CPU's")
    print(f"randomness: the int8 encode and carry decode on the card equal the CPU's "
          f"(codes, scales, x_hat, residual) at {list(shape)}")


def parity_phase(dev):
    """The trainer on the card against the CPU, and the dense against the
    sparse trainer on the card, all from one init and one batch stream."""
    task = linear_task(M, partition="iid", num_train=6000, num_test=1000, device="cpu")
    topo = erdos_renyi(M, 0.5, B, seed=0)
    init = task.init_fn(0)
    batches = [task.batch_fn(i) for i in range(5)]

    def run(device, ticks, **kw):
        cfg = BridgeConfig(topology=topo, num_byzantine=B, t0=30, **kw)
        trainer = BridgeTrainer(cfg, task.grad_fn, device=device)
        state = trainer.init({k: v.to(device) for k, v in init.items()}, seed=1)
        for batch in batches[:ticks]:
            state, _ = trainer.step(state, tuple(x.to(device) for x in batch))
        return state, trainer.honest_mask.cpu()

    # 5 ticks, within the gradient's summation order; the random attack's
    # Byzantine rows carry normal's tolerance, so honest rows are compared
    cases = [dict(rule=rule, attack="sign_flip") for rule in ("trimmed_mean", "median")]
    cases += [dict(rule=rule, attack="random", sparse=sparse)
              for rule in ("trimmed_mean", "median") for sparse in (False, True)]
    for kw in cases:
        (gpu, honest), (cpu, _) = run(dev, 5, **kw), run("cpu", 5, **kw)
        rows = slice(None) if kw["attack"] == "sign_flip" else honest
        for k in gpu.params:
            torch.testing.assert_close(gpu.params[k].cpu()[rows], cpu.params[k][rows],
                                       rtol=1e-4, atol=1e-5, msg=f"card vs CPU {kw} ({k})")
    print("parity: 5 ticks agree on the card and the CPU on honest rows (rtol 1e-4, atol 1e-5): "
          "sign flip dense, random dense and sparse, BRIDGE-T and BRIDGE-M")
    # int8: one tick from one iterate sends the same honest codes, so the
    # honest carry is exact; later ticks encode iterates that differ in the
    # last bits, where a stochastic code may round the other way
    for sparse in (False, True):
        kw = dict(rule="trimmed_mean", attack="random", sparse=sparse, codec="int8")
        (gpu, honest), (cpu, _) = run(dev, 1, **kw), run("cpu", 1, **kw)
        for name, a, b in zip(("est", "resid"), gpu.comm, cpu.comm, strict=True):
            if not torch.equal(a.cpu()[honest], b[honest]):
                raise AssertionError(f"int8 carry {name} differs on the card ({kw})")
        for k in gpu.params:
            torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                       rtol=1e-4, atol=1e-5, msg=f"card vs CPU {kw} ({k})")
    print("parity: one int8 tick (random attack, dense and sparse) gives the CPU's carry "
          "exactly and its parameters within rtol 1e-4, atol 1e-5 on honest rows")
    for kw in (dict(rule="trimmed_mean", attack="sign_flip"), dict(rule="median", attack="sign_flip"),
               dict(rule="trimmed_mean", attack="random", codec="int8")):
        (dense, _), (sparse, _) = run(dev, 5, **kw), run(dev, 5, sparse=True, **kw)
        for k in dense.params:
            if not torch.equal(dense.params[k], sparse.params[k]):
                raise AssertionError(f"{kw}: dense and sparse trainers differ on the card ({k})")
    print("parity: the dense and the sparse trainer give bit-identical parameters on the card "
          f"(5 ticks, M = {M}: sign flip BRIDGE-T and BRIDGE-M, random BRIDGE-T int8)")
    # BRIDGE-K and BRIDGE-B: 3 ticks (their picks among honest nodes turn on
    # the distances' last bits once the iterates near consensus, so longer
    # runs are held to the reference by accuracy)
    for rule in ("krum", "bulyan"):
        for sparse in (False, True):
            kw = dict(rule=rule, attack="random", sparse=sparse)
            (gpu, honest), (cpu, _) = run(dev, 3, **kw), run("cpu", 3, **kw)
            for k in gpu.params:
                torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                           rtol=1e-4, atol=1e-5, msg=f"card vs CPU {kw} ({k})")
        for kw in (dict(rule=rule, attack="random"), dict(rule=rule, attack="random", codec="int8")):
            (dense, _), (sparse, _) = run(dev, 5, **kw), run(dev, 5, sparse=True, **kw)
            for k in dense.params:
                if not torch.equal(dense.params[k], sparse.params[k]):
                    raise AssertionError(f"{kw}: dense and sparse trainers differ on the card ({k})")
    print("parity: BRIDGE-K and BRIDGE-B, 3 random-attack ticks on the card and the CPU agree on "
          "honest rows (rtol 1e-4, atol 1e-5), dense and sparse; dense and sparse bit-identical "
          "on the card (5 ticks, identity and int8)")
    # BRIDGE-K under int4 and scale_abuse, whose long runs `PICK_BOUND` holds
    # here: 3 ticks card against CPU
    kw = dict(rule="krum", attack="scale_abuse", codec="int4")
    (gpu, honest), (cpu, _) = run(dev, 3, **kw), run("cpu", 3, **kw)
    for k in gpu.params:
        torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                   rtol=1e-4, atol=1e-5, msg=f"card vs CPU {kw} ({k})")
    print("parity: BRIDGE-K with int4 under scale_abuse, 3 ticks on the card and the CPU agree "
          "on honest rows (rtol 1e-4, atol 1e-5)")
    # the baselines: one ByRDiE sweep (16 blocks of 512) and one BRDSO step
    batch = batches[0]
    for name, make in (
        ("ByRDiE", lambda d: ByrdieTrainer(ByrdieConfig(topology=topo, num_byzantine=B,
                                                        attack="random", t0=30, block=512),
                                           task.grad_fn, device=d)),
        ("BRDSO", lambda d: BrdsoTrainer(BrdsoConfig(topology=topo, num_byzantine=B,
                                                     attack="random", t0=30),
                                         task.grad_fn, device=d)),
    ):
        outs = []
        for device in (dev, "cpu"):
            tr = make(device)
            st = tr.init({k: v.to(device) for k, v in init.items()})
            b = tuple(x.to(device) for x in batch)
            st, _ = tr.sweep(st, b) if name == "ByRDiE" else tr.step(st, b)
            outs.append((st, (~tr.byz_mask).cpu()))
        (gpu, honest), (cpu, _) = outs
        for k in gpu.params:
            torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                       rtol=1e-4, atol=1e-5, msg=f"card vs CPU {name} ({k})")
    print("parity: one ByRDiE sweep and one BRDSO step agree on the card and the CPU on honest "
          "rows (rtol 1e-4, atol 1e-5)")


def left_to_right_views_trimmed_mean(views, mask, self_vals, b):
    """`ref.trimmed_mean_views` with the kept ranks summed left to right at
    any W: the kernel's order, for exact checks above 64 slots (over the
    experiment axis too: views ``[E, M, W, d]``, b an int or ``[E]``)."""
    mask = mask.bool()
    count = mask.sum(dim=-1)
    b_eff = ref.effective_trim(b, count)
    order = torch.sort(torch.where(mask[..., None], ref.sanitize(views), torch.inf),
                       dim=-2).values
    total = torch.zeros_like(self_vals)
    for i in range(mask.shape[-1]):
        keep = (i >= b_eff) & (i < count - b_eff)
        total = total + torch.where(keep[..., None], order[..., i, :], 0.0)
    return (total + self_vals) / (count - 2 * b_eff + 1).to(torch.float32)[..., None]


def views_bound(counts: np.ndarray, d: int, b: int) -> tuple[int, int, int]:
    """Bytes (the usable views, self_vals and the output once) and the fp32
    operations of Batcher's networks over each node's
    usable count, for the trimmed mean and for the median."""
    m = counts.shape[0]
    b_eff = np.minimum(b, np.maximum((counts - 1) // 2, 0))
    tm_ops = d * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                     for c, e in zip(counts, b_eff, strict=True))
    med_ops = d * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts)
    return int(counts.sum()) * d * 4 + 2 * m * d * 4, tm_ops, med_ops


def views_kernel_phase(dev):
    """The views screens (the network runtime's: each node's mailbox views
    ``[M, W, d]`` under its usable mask) against their plain versions on
    edge-case views: dense W = 50 (materialized and stride-0 over the
    receivers), sparse K = 16, and the wide path at W = 129 (stride 0 too)
    and K = 64, starved nodes included; exact up to 63 slots, above it the
    medians exact and the trimmed means exact against the left-to-right
    sum and within the summation bound of the plain version.  Timed at the
    dense runtime's shape (M = 50 on erdos_renyi(50, 0.5, 4), d = 7850,
    views in device memory, one distinct set a node) and printed at the
    sparse runtime's (M = 512, K = 16 on small_world(512, 6, 1))."""
    tm = lambda v, mk, sv, b: views_screen.views_screen_trimmed_mean(v, mk, sv, b)
    md = views_screen.views_screen_median
    cases = [(50, 50, 1000, False), (50, 50, 1000, True), (512, 16, 500, False),
             (129, 129, 300, False), (129, 129, 300, True), (72, 64, 300, False)]
    for m, w, d, stride0 in cases:
        views, mask, sv = (x.to(dev) for x in views_inputs(m, w, d, m + w, stride0))
        tag = f"views M={m} W={w} d={d}{' stride 0' if stride0 else ''}"
        for b in (0, 1, B):
            got = tm(views, mask, sv, b)
            if w <= gather_screen.MAX_SLOTS:
                exact_or_raise(f"{tag} trimmed mean b={b}", got,
                               ref.trimmed_mean_views(views, mask, sv, b))
            else:
                exact_or_raise(f"{tag} trimmed mean b={b}", got,
                               left_to_right_views_trimmed_mean(views, mask, sv, b))
                summation_or_raise(f"{tag} trimmed mean b={b}", got,
                                   ref.trimmed_mean_views(views, mask, sv, b), views,
                                   mask.sum(dim=1), sv)
            if not bool(torch.isfinite(got[0]).eq(torch.isfinite(sv[0])).all()):
                raise AssertionError(f"{tag}: a starved node's trimmed mean is not its own value")
        exact_or_raise(f"{tag} median", md(views, mask, sv), ref.median_views(views, mask, sv))
    print(f"views kernels: equal to their plain versions on edge-case views "
          f"({', '.join(f'M={m} W={w}' + (' stride 0' if s0 else '') for m, w, _, s0 in cases)}; "
          f"starved nodes finite where self is; above 63 slots the trimmed mean against the "
          f"left-to-right sum and within the summation bound)")

    records = []
    src = "src/repro_torch/kernels/csrc/views_screen.cu"
    for tag, topo, b in (("dense", erdos_renyi(M, 0.5, B, seed=0), B),
                         ("sparse", small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0), 1)):
        if tag == "dense":
            mask_np = topo.adjacency
        else:
            mask_np = NeighborTable.from_adjacency(topo, device="cpu").valid
        m, w = mask_np.shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        views = torch.randn((m, w, D), generator=gen, device=dev)
        sv = torch.randn((m, D), generator=gen, device=dev)
        mask = torch.as_tensor(mask_np, device=dev)
        exact_or_raise(f"views {tag} trimmed mean", tm(views, mask, sv, b),
                       ref.trimmed_mean_views(views, mask, sv, b))
        exact_or_raise(f"views {tag} median", md(views, mask, sv),
                       ref.median_views(views, mask, sv))
        nbytes, tm_ops, med_ops = views_bound(mask_np.sum(axis=1), D, b)
        nbytes += m * w
        full = torch.cat([torch.where(mask[:, :, None], views, torch.nan), sv[:, None]], dim=1)
        for name, kern, plain, lib, ops in (
            ("views_screen_trimmed_mean", lambda: tm(views, mask, sv, b),
             lambda: ref.trimmed_mean_views(views, mask, sv, b), None, tm_ops),
            ("views_screen_median", lambda: md(views, mask, sv),
             lambda: ref.median_views(views, mask, sv),
             lambda: torch.nanquantile(full, 0.5, dim=1), med_ops),
        ):
            err = max_abs_err(kern(), plain())
            rec = record(name, src, ("src/repro/kernels/trimmed_mean.py:109"
                                     if "trimmed" in name else "src/repro/kernels/median.py:87"),
                         kern, plain, lib, nbytes, ops, err)
            print(f"views kernel {name} {tag} (M={m}, W={w}, d={D}, "
                  f"{mask_np.sum() / m:.2f} usable views a node): {rec['ms']:.4f} ms")
            if tag == "dense":
                records.append(rec)
    print("library: the views trimmed mean has no single PyTorch call; the views median's is "
          "torch.nanquantile(q=0.5) over the masked [M, W+1, d] views and self (NaN in masked "
          "slots); the records are the dense shape's")
    return records


class HeldCalls:
    """The operands and outputs of chosen calls of the `ops` entries the
    runtime's tick launches (the views screens, the per-link carry
    decode), kept by reference while a run is timed and held against the
    plain versions after it: the kernels checked on the main path's own
    shapes, usable masks and per-link codewords.  No tick writes into a
    tensor it has handed on, so the references stay valid."""

    PLAIN = {"views_trimmed_mean": ref.trimmed_mean_views, "views_median": ref.median_views,
             "dequant_carry": ref.dequant_carry}

    def __init__(self):
        self.orig = {name: getattr(ops, name) for name in self.PLAIN}
        self.start(set())

    def start(self, keep: set) -> None:
        """Keep each entry's calls whose index (from 0, one a tick) is in ``keep``."""
        self.keep, self.calls, self.count = keep, [], dict.fromkeys(self.PLAIN, 0)

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(ops, name, fn)

    def _wrap(self, name, fn):
        def held(*args):
            out = fn(*args)
            if self.count[name] in self.keep:
                self.calls.append((name, self.count[name], args, out))
            self.count[name] += 1
            return out
        return held

    def check(self, tag: str, want: set) -> str:
        """Raise unless every entry of ``want`` had calls held and each held
        call equals its plain version exactly (a views trimmed mean above
        63 slots: the left-to-right sum, the kernel's order)."""
        if missing := want - {name for name, *_ in self.calls}:
            raise AssertionError(f"{tag}: no call of {sorted(missing)} held")
        for name, i, args, out in self.calls:
            if name == "views_trimmed_mean" and args[0].shape[-2] > gather_screen.MAX_SLOTS:
                plain = left_to_right_views_trimmed_mean(*args)
            else:
                plain = self.PLAIN[name](*args)
            pairs = zip(out, plain, strict=True) if name == "dequant_carry" else ((out, plain),)
            for got, ref_out in pairs:
                exact_or_raise(f"{tag}: {name} at call {i} on {tuple(args[0].shape)}", got,
                               ref_out)
        return "; ".join(
            f"{name} {tuple(args[0].shape)} at call {i}"
            + (f" ({float(args[1].sum()) * args[1].shape[-1] / args[1].numel():.2f} usable views "
               f"a node)"
               if name != "dequant_carry" else "")
            for name, i, args, _ in self.calls)


def net_task(m: int, dev, *, num_train: int, num_test: int, batch: int):
    return linear_task(m, partition="iid", num_train=num_train, num_test=num_test, batch=batch,
                       device=dev)


HELD_ENTRIES = {"views_screen_trimmed_mean": "views_trimmed_mean",
                "views_screen_median": "views_median", "dequant_carry": "dequant_carry"}


def net_run(tag, trainer, state, batches, want_launches, ticks, held):
    """``run_scan`` of ``trainer`` over the device-resident ``batches``:
    checks that the counted kernels grew by ``want_launches`` (others by 0),
    holds the runtime's kernels at ticks ticks // 2 and ticks - 1 against
    their plain versions (`HeldCalls`, after the timing) and returns the
    final state, the stacked metrics and ms/tick."""
    held.start({ticks // 2, ticks - 1})
    before = {k: fn.launches for k, fn in COUNTED.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hasattr(trainer, "run_scan"):
        state, mets = trainer.run_scan(state, batches)
    else:
        for i in range(ticks):
            state, mets = trainer.step(state, tuple(x[i] for x in batches))
    torch.cuda.synchronize()
    ms_tick = (time.perf_counter() - t0) / ticks * 1e3
    for k, fn in COUNTED.items():
        grew, want = fn.launches - before[k], want_launches.get(k, 0)
        if grew != want:
            raise AssertionError(f"{tag}: kernel {k} launched {grew} times in {ticks} ticks, "
                                 f"expected {want}")
    summary = held.check(tag, {HELD_ENTRIES[k] for k in want_launches if k in HELD_ENTRIES})
    if summary:
        print(f"{tag}: held exactly against the plain versions on the path's operands: {summary}")
    return state, mets, ms_tick


def net_check(tag, task, trainer, state, mets, ms_tick) -> float:
    """Accuracy within ACC_TOL of the reference's; the means of
    delivered_frac and mean_staleness equal to the reference's."""
    acc = task.eval_accuracy(state.params, trainer.honest_mask)
    delivered = float(np.mean(mets["delivered_frac"].cpu().numpy()))
    stale = float(np.mean(mets["mean_staleness"].cpu().numpy()))
    ring = 0 if state.net is None else state.net.nbytes()
    print(f"{tag}: honest test accuracy {acc:.4f} (reference {REFERENCE_ACCURACY[tag]:.4f}), "
          f"delivered_frac {delivered!r}, mean_staleness {stale!r}, {ms_tick:.3f} ms/tick of "
          f"run_scan over device-resident batches, mailbox state {ring} bytes")
    check_accuracy(tag, acc)
    _, want_delivered, want_stale = REFERENCE_NET[tag]
    if (delivered, stale) != (want_delivered, want_stale):
        raise AssertionError(f"{tag}: delivered_frac {delivered!r} / mean_staleness {stale!r} != "
                             f"the reference's {want_delivered!r} / {want_stale!r}")
    return acc


def net_trainer_phase(dev):
    """The network runtime on the card, d = 7850 (the module docstring's
    phase 16); returns the kernel launches it made."""
    with HeldCalls() as held:
        return net_trainer_runs(dev, held)


def net_trainer_runs(dev, held):
    zero_launches()
    profiles = []  # measured after the launch counts are read
    views_of = {"trimmed_mean": "views_screen_trimmed_mean", "median": "views_screen_median"}
    dense_of = {"trimmed_mean": "screen_trimmed_mean_dense", "median": "screen_median_dense"}

    # (a) the ideal channel against the synchronous trainer, bit for bit
    task = net_task(M, dev, num_train=6000, num_test=1000, batch=32)
    batches = stack_batches(task.batch_fn, TICKS, device=dev)
    topo = erdos_renyi(M, 0.5, B, seed=0)
    for rule in ("trimmed_mean", "median"):
        cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack="random", t0=30)
        sync = BridgeTrainer(cfg, task.grad_fn, device=dev)
        ideal = AsyncBridgeTrainer(AsyncBridgeConfig(**cfg.__dict__, channel=ChannelConfig.ideal(),
                                                     staleness_bound=0), task.grad_fn, device=dev)
        s0 = sync.init(task.init_fn(0), seed=1)
        s_sync, _, ms_sync = net_run(f"sync {rule}", sync, s0, batches, {dense_of[rule]: TICKS},
                                     TICKS, held)
        s_ideal, mets, ms_ideal = net_run(f"ideal {rule}", ideal, ideal.init(s0.params, seed=1),
                                          batches, {views_of[rule]: TICKS}, TICKS, held)
        for k in s_sync.params:
            if not torch.equal(s_sync.params[k], s_ideal.params[k]):
                raise AssertionError(f"ideal channel {rule}: parameters differ from the "
                                     f"synchronous trainer's after {TICKS} ticks")
        acc = task.eval_accuracy(s_ideal.params, ideal.honest_mask)
        print(f"net ideal vs synchronous {rule} (M={M}, b={B}, random, {TICKS} ticks): bit for "
              f"bit equal, honest test accuracy {acc:.4f}; ms/tick synchronous {ms_sync:.3f}, "
              f"ideal runtime {ms_ideal:.3f}; mailbox state {s_ideal.net.nbytes()} bytes")
    del batches

    # (b) the net benchmark's settings, every scenario, and selective_victim
    task = net_task(20, dev, num_train=4000, num_test=800, batch=32)
    batches = stack_batches(task.batch_fn, NET_TICKS, device=dev)
    topo = erdos_renyi(20, 0.5, 2, seed=0)
    runs = [(name, "alie") for name in NET_SCENARIOS] + [("lossy", "selective_victim")]
    for name, attack in runs:
        spec = get_scenario(name)
        cfg = AsyncBridgeConfig(
            topology=topo, rule="trimmed_mean", num_byzantine=2, attack=attack, lam=1.0, t0=30,
            channel=spec.channel, staleness_bound=spec.staleness_bound,
            schedule=scenario_schedule(spec.schedule_kind, topo, NET_TICKS, seed=0,
                                       churn_prob=spec.churn_prob))
        trainer = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
        state, mets, ms_tick = net_run(name, trainer, trainer.init(task.init_fn(0), seed=0),
                                       batches, {"views_screen_trimmed_mean": NET_TICKS},
                                       NET_TICKS, held)
        tag = f"net {name}" + ("" if attack == "alie" else f" {attack}")
        net_check(tag, task, trainer, state, mets, ms_tick)
    del batches

    # (c) dense M = 50 with the identity and the int8 per-link codec
    task = net_task(M, dev, num_train=6000, num_test=1000, batch=32)
    batches = stack_batches(task.batch_fn, NET_DENSE_TICKS, device=dev)
    topo = erdos_renyi(M, 0.5, B, seed=0)
    for name in ("lossy_laggy", "narrowband64k"):
        for codec in ("identity", "int8"):
            spec = get_scenario(name)
            cfg = AsyncBridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=B,
                                    attack="random", t0=30, codec=codec, channel=spec.channel,
                                    staleness_bound=spec.staleness_bound)
            trainer = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
            want = {"views_screen_trimmed_mean": NET_DENSE_TICKS}
            if codec == "int8":
                want["dequant_carry"] = NET_DENSE_TICKS
            state, mets, ms_tick = net_run(f"dense {name} {codec}", trainer,
                                           trainer.init(task.init_fn(0), seed=1), batches, want,
                                           NET_DENSE_TICKS, held)
            net_check(f"net dense {name} {codec}", task, trainer, state, mets, ms_tick)
            if name == "lossy_laggy":
                profiles.append((f"net dense {name} {codec}", trainer, task, 1))
    del batches

    # (d) the sparse runtime at the scale benchmark's settings
    task = net_task(SM, dev, num_train=16384, num_test=1000, batch=8)
    batches = stack_batches(task.batch_fn, TICKS, device=dev)
    topo = small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0)
    cfg = AsyncBridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=1, attack="alie",
                            channel=ChannelConfig(drop_prob=0.05), staleness_bound=2, lam=1.0,
                            t0=100, sparse=True)
    trainer = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
    state, mets, ms_tick = net_run("sparse lossy", trainer, trainer.init(task.init_fn(0), seed=0),
                                   batches, {"views_screen_trimmed_mean": TICKS}, TICKS, held)
    net_check("net sparse lossy", task, trainer, state, mets, ms_tick)
    profiles.append(("net sparse lossy", trainer, task, 0))
    del batches
    # dense against sparse at M = 48, 20 ticks, bit for bit
    task = net_task(48, dev, num_train=2000, num_test=200, batch=8)
    batches = stack_batches(task.batch_fn, 20, device=dev)
    topo = small_world(48, NEAREST, 1, rewire_prob=0.2, seed=0)
    states = {}
    for sparse in (False, True):
        cfg = AsyncBridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=1,
                                attack="alie", channel=ChannelConfig(drop_prob=0.05),
                                staleness_bound=2, lam=1.0, t0=100, sparse=sparse)
        tr = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
        states[sparse], _, ms_tick = net_run(f"M=48 sparse={sparse}", tr,
                                             tr.init(task.init_fn(0), seed=0), batches,
                                             {"views_screen_trimmed_mean": 20}, 20, held)
        print(f"net M=48 {'sparse' if sparse else 'dense'}: {ms_tick:.3f} ms/tick, mailbox "
              f"state {states[sparse].net.nbytes()} bytes")
    for k in states[False].params:
        if not torch.equal(states[False].params[k], states[True].params[k]):
            raise AssertionError("net M=48: the dense and the sparse runtime differ")
    print("net M=48: the dense and the sparse runtime bit for bit equal over 20 ticks")

    launches = read_launches()
    for tag, trainer, task, seed in profiles:
        profile_trainer(tag, trainer, trainer.init(task.init_fn(0), seed=seed), task.batch_fn)
    return launches


# ---------------------------------------------------------------------------
# 17. BRIDGE-K / BRIDGE-B over mailbox views on the card
# ---------------------------------------------------------------------------


def dist_body(bsz: int, n: int) -> str:
    """The counter of the body `pairwise.batch_plan` picks for ``[B, n, D]``."""
    return ("pairwise_sq_dists_batch_body" if pairwise.batch_plan(bsz, n, D).body == "batch"
            else "pairwise_sq_dists_batched")


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def views_dist_check(tag: str, views: torch.Tensor, self_vals) -> float:
    """The batched distance kernel (on the body `batch_plan` picks) on
    mailbox views (or, with ``self_vals`` None, a grid's ``[E, M, d]``
    rows) against its plain version, node by node (`check_dists`: the
    dot-product bound, symmetry, zero diagonal, the NaN/inf pattern), and
    every node equal bit for bit to the unbatched kernel of its stacked
    rows and to the cluster body forced; returns the
    largest finite difference."""
    got = pairwise.pairwise_sq_dists_batched(views, self_vals)
    want = ref.pairwise_sq_dists_batched(views, self_vals)
    x = views if self_vals is None else torch.cat([views, self_vals[:, None]], dim=1)
    bsz, n, d = x.shape
    err = max(check_dists(f"{tag} node {j}", got[j], want[j], x[j]) for j in range(bsz))
    for j in range(bsz):
        if not bit_equal(got[j], pairwise.pairwise_sq_dists(x[j].contiguous())):
            raise AssertionError(f"{tag}: node {j} differs from the unbatched kernel of its rows")
    plan = pairwise.batch_plan(bsz, n, d)
    cluster = pairwise.pairwise_sq_dists_batched(views, self_vals,
                                                 pairwise.BatchPlan(pairwise.split_plan(n, d)))
    if not bit_equal(got, cluster):
        raise AssertionError(f"{tag}: the {plan.body} body differs from the cluster body")
    print(f"pairwise batched {tag} {tuple(views.shape)} (node stride {views.stride(0)}): max "
          f"|kernel - plain| {err:.3g}, every node equal to the unbatched kernel and to the "
          f"cluster body bit for bit; {plan.body} body, order {plan.order}")
    return err


def views_edge_inputs(m: int, w: int, d: int, seed: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    views = torch.randn((m, w, d), generator=gen, device=dev)
    views[1, 1] = float("nan")
    views[2, 0, 3], views[3, 2, 0] = float("inf"), -float("inf")
    views[4, 3] = 1e30
    self_vals = torch.randn((m, d), generator=gen, device=dev)
    self_vals[5, 7] = float("nan")
    return views, self_vals


def net_parity(tag: str, cfg, task, dev, ticks: int = 3) -> None:
    """``ticks`` ticks of the runtime trainer on the card and on the CPU from
    one init and one batch stream: honest rows within rtol 1e-4, atol 1e-5."""
    init, batches = task.init_fn(0), [task.batch_fn(i) for i in range(ticks)]
    out = []
    for device in (dev, "cpu"):
        tr = AsyncBridgeTrainer(cfg, task.grad_fn, device=device)
        st = tr.init({k: v.to(device) for k, v in init.items()}, seed=0)
        for batch in batches:
            st, _ = tr.step(st, tuple(x.to(device) for x in batch))
        out.append((st, tr.honest_mask.cpu()))
    (gpu, honest), (cpu, _) = out
    for k in gpu.params:
        torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                   rtol=1e-4, atol=1e-5, msg=f"card vs CPU {tag} ({k})")


def views_kb_phase(dev):
    """Phase 17: the batched distance kernel on mailbox views and a grid's
    cells, then asynchronous BRIDGE-K and BRIDGE-B on the card; returns
    the records of its two bodies and the launches of the runs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=dev) * 0.05  # noqa: E731
    cases = {
        "dense W=50": (mk(M, M, D), mk(M, D)),
        "dense W=50 stride 0": (mk(1, M, D).expand(M, M, D), mk(M, D)),
        f"sparse M={SM} K=16": (mk(SM, 16, D), mk(SM, D)),
        "net M=20 W=20": (mk(20, 20, D), mk(20, D)),
        f"grid E=8 M={M}": (mk(8, M, D), None),
        "K=64": (mk(64, 64, D), mk(64, D)),
        "edge rows": views_edge_inputs(8, 6, 777, seed=18, dev=dev),
        "edge rows K=16": views_edge_inputs(64, 16, 777, seed=19, dev=dev),
    }
    errs = {tag: views_dist_check(tag, *args) for tag, args in cases.items()}

    def library(x):
        g = torch.bmm(x, x.mT)
        sq = torch.diagonal(g, dim1=1, dim2=2)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * g
        return torch.where(d2 < 0, 0.0, d2)

    def stack(views, self_vals):
        if self_vals is None:
            return views.contiguous()
        return torch.cat([views, self_vals[:, None]], 1)

    def cost(views, self_vals):
        """Bytes (the views' distinct rows once, self, the output) and the
        operations (each node's n (n + 1) / 2 dot products of d FMAs)."""
        m, w, d = views.shape
        n = w + (self_vals is not None)
        rows = w * d if views.stride(0) == 0 else m * w * d
        own = 0 if self_vals is None else m * d
        return (rows + own + m * n * n) * 4, m * n * (n + 1) * d

    for tag in ("dense W=50", "dense W=50 stride 0", f"sparse M={SM} K=16", "net M=20 W=20",
                f"grid E=8 M={M}"):
        v, s = cases[tag]
        n = v.shape[1] + (s is not None)
        stacked = stack(v, s)
        nbytes, ops_ = cost(v, s)
        bound = max(nbytes / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
        plan = pairwise.batch_plan(v.shape[0], n, D)
        cluster = pairwise.BatchPlan(plan.order)
        print(f"pairwise batched {tag} times: kernel ({plan.body} body) "
              f"{cuda_ms(lambda: pairwise.pairwise_sq_dists_batched(v, s)):.4f} ms, cluster body "
              f"{cuda_ms(lambda: pairwise.pairwise_sq_dists_batched(v, s, cluster)):.4f} ms, "
              f"torch.bmm {cuda_ms(lambda: library(stacked), reps=11, inner=2):.4f} ms, bound "
              f"{bound:.5f} ms")
    records = []
    # each body's record at the main path's shape it runs: the batch body at
    # sparse views K / B, the cluster body at the net phase's M = 20 views
    for name, tag in (("pairwise_sq_dists_batch_body", f"sparse M={SM} K=16"),
                      ("pairwise_sq_dists_batched", "net M=20 W=20")):
        v, s = cases[tag]
        if dist_body(v.shape[0], v.shape[1] + 1) != name:
            raise AssertionError(f"{tag}: batch_plan no longer picks {name}")
        stacked = stack(v, s)
        nbytes, ops_ = cost(v, s)
        records.append(record(name, "src/repro_torch/kernels/csrc/pairwise.cu",
                              "src/repro/kernels/krum.py:44",
                              lambda v=v, s=s: pairwise.pairwise_sq_dists_batched(v, s),
                              lambda v=v, s=s: ref.pairwise_sq_dists_batched(v, s),
                              lambda st=stacked: library(st), nbytes, ops_, errs[tag]))
    print(f"library: torch.bmm(x, x.mT) over the stacked [M, K + 1, d] views with the same "
          f"epilogue (TF32 off), a call the port never makes; the batch body timed at sparse "
          f"M = {SM}, K = 16, the cluster body at M = 20, W = 20")
    del cases, stacked

    # the runtime trainers, BRIDGE-K and BRIDGE-B, each tick through the kernel
    task = net_task(20, dev, num_train=4000, num_test=800, batch=32)
    batches = stack_batches(task.batch_fn, NET_TICKS, device=dev)
    topo = erdos_renyi(20, 0.9, 1, seed=0)
    cpu_task = net_task(20, "cpu", num_train=4000, num_test=800, batch=32)
    zero_launches()
    with HeldCalls() as held:
        for rule in ("krum", "bulyan"):
            for name in ("ideal", "lossy"):
                spec = get_scenario(name)
                cfg = AsyncBridgeConfig(
                    topology=topo, rule=rule, num_byzantine=1, attack="alie", lam=1.0, t0=30,
                    channel=spec.channel, staleness_bound=spec.staleness_bound,
                    schedule=scenario_schedule(spec.schedule_kind, topo, NET_TICKS, seed=0,
                                               churn_prob=spec.churn_prob))
                trainer = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
                want = {dist_body(20, 21): NET_TICKS}
                if rule == "bulyan":
                    want["views_screen_trimmed_mean"] = NET_TICKS
                tag = f"net {rule} {name}"
                state, mets, ms_tick = net_run(tag, trainer, trainer.init(task.init_fn(0), seed=0),
                                               batches, want, NET_TICKS, held)
                net_check(tag, task, trainer, state, mets, ms_tick)
    launches = read_launches()
    for rule in ("krum", "bulyan"):
        for name in ("ideal", "lossy"):
            spec = get_scenario(name)
            cfg = AsyncBridgeConfig(
                topology=topo, rule=rule, num_byzantine=1, attack="alie", lam=1.0, t0=30,
                channel=spec.channel, staleness_bound=spec.staleness_bound,
                schedule=scenario_schedule(spec.schedule_kind, topo, NET_TICKS, seed=0,
                                           churn_prob=spec.churn_prob))
            net_parity(f"net {rule} {name}", cfg, cpu_task, dev)
    print(f"net BRIDGE-K / BRIDGE-B (M = 20, erdos_renyi(20, 0.9, 1), b = 1, alie, "
          f"{NET_TICKS} ticks, ideal and lossy): the batched distance kernel once a tick, "
          f"Bulyan's views trimmed mean once a tick; 3 ticks on the card and the CPU agree on "
          f"honest rows (rtol 1e-4, atol 1e-5)")
    del batches

    # BRIDGE-K over the sparse runtime at the scale benchmark's settings
    # (M = 512, K = 16): each node's 16 views and itself, the batch body's shape
    task = net_task(SM, dev, num_train=16384, num_test=1000, batch=8)
    batches = stack_batches(task.batch_fn, SPARSE_K_TICKS, device=dev)
    cfg = AsyncBridgeConfig(topology=small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0),
                            rule="krum", num_byzantine=1, attack="alie",
                            channel=ChannelConfig(drop_prob=0.05), staleness_bound=2, lam=1.0,
                            t0=100, sparse=True)
    trainer = AsyncBridgeTrainer(cfg, task.grad_fn, device=dev)
    k = trainer.runtime.neighbors.k  # the mailbox slots a node: its views
    before = read_launches()
    with HeldCalls() as held:
        state, mets, ms_tick = net_run("sparse krum", trainer,
                                       trainer.init(task.init_fn(0), seed=0), batches,
                                       {dist_body(SM, k + 1): SPARSE_K_TICKS}, SPARSE_K_TICKS,
                                       held)
    for name, n in read_launches().items():
        launches[name] += n - before[name]
    acc = net_check("net sparse krum", task, trainer, state, mets, ms_tick)
    net_parity("net sparse krum", cfg, net_task(SM, "cpu", num_train=16384, num_test=1000,
                                                batch=8), dev)
    print(f"net sparse krum (small_world({SM}, {NEAREST}, 1), K = {k}, b = 1, alie, drop 0.05, "
          f"staleness 2, {SPARSE_K_TICKS} ticks): the {pairwise.batch_plan(SM, k + 1, D).body} "
          f"body once a tick, {ms_tick:.3f} ms/tick, honest test accuracy {acc:.4f} (the "
          f"reference's {REFERENCE_ACCURACY['net sparse krum']:.4f}), channel means equal to "
          f"the reference's; 3 ticks on the card and the CPU agree on honest rows (rtol 1e-4, "
          f"atol 1e-5)")
    return records, launches


# ---------------------------------------------------------------------------
# 18. The batched experiment grids
# ---------------------------------------------------------------------------

# rule -> the kernels a group of its cells launches once a tick (on a dense
# grid; the sparse grids' screens are the gather forms)
GRID_KERNELS = {"trimmed_mean": ("screen_trimmed_mean_dense",),
                "median": ("screen_median_dense",),
                "krum": ("pairwise_sq_dists_batched",),
                "bulyan": ("pairwise_sq_dists_batched", "screen_trimmed_mean_dense")}


def ascent_screens(thetas) -> tuple[int, int]:
    """The screen forwards and backwards that `inner_max` adds to a tick
    over cells of one call with ``thetas`` (None: the default; K their most
    ascent steps, `adaptive.ascent_steps`): K + 3 forwards (the unattacked
    reference, the ALIE candidate, the warm start, K - 1 steps, the last
    step's value) and K backwards (the warm start's and the K - 1 steps')."""
    if not thetas:
        return 0, 0
    default = adv_lib.get_adversary("inner_max").default_theta
    thetas = [default if t is None else t for t in thetas]
    k = int(adaptive_lib.ascent_steps(np.asarray(thetas, np.float32)).max())
    return k + 3, k


def grid_want(engine, ticks: int) -> dict:
    """Each screening kernel once a tick for each group of the grid (on a
    sparse grid the gather forms, above the register networks' rows the
    wide path), and `ascent_screens` more a tick for the rules of a group's
    ``inner_max`` cells (the dense and gathered backwards are plain)."""
    want: dict[str, int] = {}
    if engine.sparse:
        wide = engine.neighbors.k + 1 > gather_screen.MAX_SLOTS + 1
    else:
        wide = engine.grid.topology.num_nodes + 1 > trimmed_mean.MAX_ROWS
    for (rules, _, codecs, _), (lo, hi) in zip(engine._banks, engine._bounds, strict=True):
        cells = [engine.cells[i] for i in engine._perm[lo:hi]]
        ascent = [c for c in cells if c.adversary == "inner_max"]
        extra, _ = ascent_screens([c.theta for c in ascent])
        for rule in rules:
            calls = ticks * (1 + (extra if any(c.rule == rule for c in ascent) else 0))
            for k in GRID_KERNELS[rule]:
                if k.startswith("screen_"):
                    if wide:
                        k = "screen_wide"
                    elif engine.sparse:
                        k = "gather_screen_" + k[len("screen_"):-len("_dense")]
                want[k] = want.get(k, 0) + calls
        for k in decode_kernels(codecs):
            want[k] = want.get(k, 0) + ticks
    return want


def decode_kernels(codecs) -> list[str]:
    """The decode kernels a group's codec bank launches once a tick: the
    carry decode over every cell's rows (int8, int4), the kept values'
    decode (a quantized sparse codec)."""
    out = []
    for name in codecs:
        c = codec_lib.get_codec(name)
        if not c.lossless and c.mode == "dense":
            out.append("dequant_carry")
        elif c.bits < 32:
            out.append("dequant")
    return out


def _grid_run(tag, grid, task, dev, ticks, *, sparse=False, acc_rules=("trimmed_mean", "median"),
              accs_out=None):
    """One grid on the card: the engine's run, timed (its launches counted
    against `grid_want`: each screening kernel once a tick per group, more
    under ``inner_max``, each lossy codec's decode kernel once), then every
    cell's own `BridgeTrainer` run (its codec and adversary included) over
    the same batches, timed; each cell's parameters, key, codec carry and
    adversary state equal bit for bit, its loss stream too (else within
    rtol 1e-6, with the cause printed); the honest accuracy of every
    ``acc_rules`` cell at least 0.95 (every cell's into ``accs_out``, by
    tag).  Returns the launches of the engine's run."""
    batches = stack_batches(task.batch_fn, ticks, device=dev)
    engine = GridEngine(grid, task.grad_fn, sparse=sparse, device=dev)
    state0 = engine.init(task.init_fn)
    carry = sum(x.nbytes for x in state0.comm) if state0.comm is not None else 0
    before = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, metrics = engine.run(state0, batches)
    torch.cuda.synchronize()
    wall_grid = time.perf_counter() - t0
    check_grew(f"grid {tag}", before, grid_want(engine, ticks))
    grew = {k: n - before[k] for k, n in read_launches().items() if n != before[k]}
    e = engine.num_cells
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = []
    for cell in engine.cells:
        cfg = BridgeConfig(topology=grid.topology, rule=cell.rule, num_byzantine=cell.b,
                           attack=cell.attack, adversary=cell.adversary, codec=cell.codec,
                           lam=grid.lam, t0=grid.t0, lr=grid.lr, byzantine_seed=cell.mask_seed,
                           sparse=sparse)
        tr = BridgeTrainer(cfg, task.grad_fn, device=dev)
        st = tr.init(task.init_fn(cell.seed), seed=cell.seed)
        losses = []
        for i in range(ticks):
            st, m = tr.step(st, tuple(x[i] for x in batches))
            losses.append(m["loss"])
        seq.append((st, torch.stack(losses), tr.honest_mask))
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    loss_note = "bit for bit"
    accs = []
    for i, (cell, (st, losses, honest)) in enumerate(zip(engine.cells, seq, strict=True)):
        for k in st.params:
            if not torch.equal(final.params[k][i], st.params[k]):
                diff = float((final.params[k][i] - st.params[k]).abs().max())
                raise AssertionError(f"grid {tag}: cell {cell.tag} ({k}) differs from its "
                                     f"BridgeTrainer run by up to {diff:.3g}")
        if not np.array_equal(final.key[i], st.key):
            raise AssertionError(f"grid {tag}: cell {cell.tag}'s key differs")
        check_carries(f"grid {tag}", cell, final, i, st)
        if not torch.equal(metrics["loss"][i], losses):
            torch.testing.assert_close(metrics["loss"][i], losses, rtol=1e-6, atol=0,
                                       msg=f"grid {tag}: cell {cell.tag}'s loss stream")
            loss_note = ("within rtol 1e-6 (the loss sums over the nodes' [N, C] margins and "
                         "parameters round per batched reduction shape on the card)")
        acc = task.eval_accuracy({k: v[i] for k, v in final.params.items()}, honest)
        if accs_out is not None:
            accs_out[cell.tag] = acc
        if cell.rule in acc_rules:
            accs.append(acc)
            if acc < 0.95:
                raise AssertionError(f"grid {tag}: cell {cell.tag} honest accuracy {acc:.4f} "
                                     f"< 0.95")
    acc_note = (f"; honest accuracy of the {'/'.join(acc_rules)} cells {min(accs):.4f}-"
                f"{max(accs):.4f}" if accs else "")
    carry_note = f"; codec carry {carry} bytes" if carry else ""
    print(f"grid {tag}: {e} cells x {ticks} ticks, {engine.num_steps_built} groups: every cell "
          f"equal to its own BridgeTrainer run on the card (parameters, key, codec carry and "
          f"adversary state bit for bit, loss stream {loss_note}){acc_note}{carry_note}")
    print(f"grid {tag} throughput: engine {wall_grid:.3f} s ({e / wall_grid:.2f} cells/s, "
          f"{wall_grid / ticks * 1e3:.3f} ms/tick for all {e} cells); one by one through "
          f"BridgeTrainer {wall_seq:.3f} s ({e / wall_seq:.2f} cells/s, "
          f"{wall_seq / ticks / e * 1e3:.3f} ms/tick a cell); speedup "
          f"{wall_seq / wall_grid:.2f}x")
    return grew


def check_carries(tag, cell, final, i, st) -> None:
    """Cell ``i``'s codec carry and adversary state equal its trainer's
    (NaN-aware: a wire attack's scale rewrite can drive a Byzantine link's
    residual to inf - inf); where the trainer carries none (a lossless codec or
    a stateless adversary in a bank that carries one), the cell's rows stay
    all zeros."""
    for name in ("comm", "adv"):
        got, want = getattr(final, name), getattr(st, name)
        if got is None and want is None:
            continue
        if got is None:
            raise AssertionError(f"{tag}: cell {cell.tag}'s {name} carry is missing")
        rows = [a[i] for a in got]
        ok = (all(not bool(r.any()) for r in rows) if want is None
              else all(bool(nan_equal(r, b).all()) for r, b in zip(rows, want, strict=True)))
        if not ok:
            raise AssertionError(f"{tag}: cell {cell.tag}'s {name} carry differs")


def experiment_records(dev) -> list:
    """The experiment-axis forms of the screens at the grids' group shapes,
    each equal to its unbatched kernel per experiment and to its plain
    version, timed (records named ``<kernel>[E]``; their launches are the
    grid engine's, `grid_phase` sets them)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    records = []

    def dense_ops(counts, bs, median_rule):
        if median_rule:
            return D * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts) * len(bs)
        return D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * min(b, max((int(c) - 1) // 2, 0))
                       + 2 for b in bs for c in counts)

    def add(name, counter, source, replaces, kern, plain, lib_fn, nbytes, ops, per_exp, e):
        got, want = kern(), plain()
        exact_or_raise(f"{name} vs plain", got, want)
        for i in range(e):
            exact_or_raise(f"{name} experiment {i} vs the unbatched kernel", got[i], per_exp(i))
        rec = record(name, source, replaces, kern, plain, lib_fn, nbytes, ops,
                     max_abs_err(got, want))
        rec["_counter"] = counter
        records.append(rec)

    # dense register screens: a grid_bench group, E = 8 cells of M = 12, b = 2
    topo = default_topology(12, ("trimmed_mean", "median"), (2,), seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    e, m = 8, 12
    w = torch.randn((e, m, D), generator=gen, device=dev)
    b_t = torch.full((e,), 2, dtype=torch.int32, device=dev)
    counts = topo.adjacency.sum(axis=1)
    rows = torch.cat([torch.where(adj[None, :, :, None], w[:, None], torch.nan), w[:, :, None]],
                     dim=2)
    nbytes = 2 * e * m * D * 4 + m * m + 4 * e
    add("screen_trimmed_mean_dense[E]", "screen_trimmed_mean_dense",
        "src/repro_torch/kernels/csrc/screen.cu", "src/repro/kernels/trimmed_mean.py:109",
        lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, b_t),
        lambda: ref.trimmed_mean_dense(w, adj, w, b_t), None, nbytes,
        dense_ops(counts, [2] * e, False),
        lambda i: trimmed_mean.trimmed_mean_dense(w[i], adj, w[i], 2), e)
    add("screen_median_dense[E]", "screen_median_dense", "src/repro_torch/kernels/csrc/screen.cu",
        "src/repro/kernels/median.py:87", lambda: median.median_dense(w, adj, w),
        lambda: ref.median_dense(w, adj, w), lambda: torch.nanquantile(rows, 0.5, dim=2),
        2 * e * m * D * 4 + m * m, dense_ops(counts, [0] * e, True),
        lambda i: median.median_dense(w[i], adj, w[i]), e)
    # gather tile screens: a sparse-grid group, E = 4 cells of M = 512, K = 16
    topo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    tab = NeighborTable.from_adjacency(topo, device=dev)
    e = 4
    w = torch.randn((e, SM, D), generator=gen, device=dev)
    b_t = torch.tensor([SB, SB, 1, 0], dtype=torch.int32, device=dev)
    counts = tab.valid.sum(axis=1)
    gathered = torch.where(tab.valid_dev[None, :, :, None], ref.gather(w, tab.safe_idx), torch.nan)
    grows = torch.cat([gathered, w[:, :, None]], dim=2)
    src = "src/repro_torch/kernels/csrc/gather_screen.cu"
    nbytes = 3 * e * SM * D * 4 + SM * tab.k * 5 + 4 * e
    add("gather_screen_trimmed_mean[E]", "gather_screen_trimmed_mean", src,
        "src/repro/kernels/gather_screen.py:127",
        lambda: gather_screen.gather_screen_trimmed_mean(w, tab.safe_idx, tab.valid_dev, w, b_t),
        lambda: ref.gather_trimmed_mean(w, tab.safe_idx, tab.valid_dev, w, b_t), None, nbytes,
        dense_ops(counts, b_t.tolist(), False),
        lambda i: gather_screen.gather_screen_trimmed_mean(w[i], tab.safe_idx, tab.valid_dev,
                                                           w[i], int(b_t[i])), e)
    add("gather_screen_median[E]", "gather_screen_median", src,
        "src/repro/kernels/gather_screen.py:127",
        lambda: gather_screen.gather_screen_median(w, tab.safe_idx, tab.valid_dev, w),
        lambda: ref.gather_median(w, tab.safe_idx, tab.valid_dev, w),
        lambda: torch.nanquantile(grows, 0.5, dim=2), 3 * e * SM * D * 4 + SM * tab.k * 5,
        dense_ops(counts, [0] * e, True),
        lambda i: gather_screen.gather_screen_median(w[i], tab.safe_idx, tab.valid_dev, w[i]), e)
    del w, gathered, grows
    # the wide path: a wide-grid group, E = 2 cells of M = 129, b = 4
    topo = erdos_renyi(WIDE_M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    e, m = 2, WIDE_M
    w = torch.randn((e, m, D), generator=gen, device=dev)
    b_t = torch.full((e,), B, dtype=torch.int32, device=dev)
    counts = topo.adjacency.sum(axis=1)
    kern = lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, b_t)
    got = kern()
    for i in range(e):
        exact_or_raise(f"screen_wide[E] experiment {i} vs left-to-right", got[i],
                       left_to_right_trimmed_mean(w[i], adj, w[i], B))
        exact_or_raise(f"screen_wide[E] experiment {i} vs the unbatched kernel", got[i],
                       trimmed_mean.trimmed_mean_dense(w[i], adj, w[i], B))
    want = ref.trimmed_mean_dense(w, adj, w, b_t)
    for i in range(e):
        summation_or_raise(f"screen_wide[E] experiment {i}", got[i], want[i], w[i][None],
                           adj.sum(dim=1), w[i])
    rec = record("screen_wide[E]", "src/repro_torch/kernels/csrc/screen_wide.cuh",
                 "src/repro/kernels/trimmed_mean.py:109", kern,
                 lambda: ref.trimmed_mean_dense(w, adj, w, b_t), None,
                 2 * e * m * D * 4 + m * m + 4 * e, dense_ops(counts, [B] * e, False),
                 max_abs_err(got, want))
    rec["_counter"] = "screen_wide"
    records.append(rec)
    print("experiment axis: the dense register screens (E = 8, M = 12), the gather screens "
          f"(E = 4, M = {SM}, K = {tab.k}, per-experiment b) and the wide path (E = 2, "
          f"M = {WIDE_M}) equal their unbatched kernels experiment by experiment and their plain "
          "versions (the wide trimmed mean: exact against the left-to-right sum, within the "
          "summation bound of the plain version); library: torch.nanquantile for the medians, "
          "none for the trimmed means")
    return records


def grid_phase(dev):
    """Phase 18: the batched grids on the card (the module docstring's
    list), then the sweep's grid mode into a temporary store, twice;
    returns the experiment-axis records and the launches of the runs."""
    records = experiment_records(dev)
    zero_launches()
    engine_launches: dict[str, int] = {}  # the engines' runs alone: the [E] forms

    def grid_run(*args, **kw):
        for k, n in _grid_run(*args, **kw).items():
            engine_launches[k] = engine_launches.get(k, 0) + n

    rules = ("trimmed_mean", "median")
    # the reference's grid_bench grid
    task = linear_task(12, partition="iid", num_train=4000, num_test=800, batch=32, device=dev)
    grid = ExperimentGrid(default_topology(12, rules, (2,), seed=0), rules,
                          ("random", "alie", "sign_flip"), (2,), tuple(range(8)), lam=1.0,
                          t0=30.0)
    grid_run("grid_bench (M=12)", grid, task, dev, 30)
    # BRIDGE-K / BRIDGE-B at M = 50
    task = linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32, device=dev)
    grid = ExperimentGrid(erdos_renyi(M, 0.5, B, seed=0), ("krum", "bulyan"), ("random", "alie"),
                          (B,), (0, 1), lam=1.0, t0=30.0)
    grid_run(f"K/B (M={M})", grid, task, dev, 30, acc_rules=())
    # the sparse grid at the scale setting
    task = linear_task(SM, partition="iid", num_train=16384, num_test=1000, batch=8, device=dev)
    grid = ExperimentGrid(small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0), rules,
                          ("random",), (SB,), (0, 1, 2, 3), lam=1.0, t0=100.0)
    grid_run(f"sparse (M={SM}, K=16)", grid, task, dev, 50, sparse=True)
    # the wide dense grid above the register networks
    task = linear_task(WIDE_M, partition="iid", num_train=8000, num_test=1000, batch=32,
                       device=dev)
    grid = ExperimentGrid(erdos_renyi(WIDE_M, 0.5, B, seed=0), rules, ("random",), (B,), (0, 1),
                          lam=1.0, t0=30.0)
    grid_run(f"wide (M={WIDE_M})", grid, task, dev, 3, acc_rules=())
    # the sweep's entry point, into a temporary store, twice
    with tempfile.TemporaryDirectory() as store:
        before = read_launches()
        res = sweep.main(["--mode", "grid", "--out", store])
        if res is None or len(res.cells) != 4:
            raise AssertionError("sweep --mode grid: expected 4 cells computed")
        if sweep.main(["--mode", "grid", "--out", store]) is not None:
            raise AssertionError("sweep --mode grid: the second run recomputed cells")
        grew = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
        accs = ", ".join(f"{r['accuracy']:.4f}" for r in res.cells)
        print(f"sweep --mode grid on the card: 4 cells (accuracy {accs}), the second run found "
              f"every cell cached; kernels {grew}")
    for rec in records:
        rec["launches"] = engine_launches.get(rec.pop("_counter"), 0)
    print(f"launches of the grid engines' runs (the [E] forms): {engine_launches}")
    return records, read_launches()


# ---------------------------------------------------------------------------
# 19. Net-scenario grids
# ---------------------------------------------------------------------------

NET_GRID_TICKS = 30  # the dense net grids (a) and (b)
SPARSE_NET_GRID_TICKS = 20  # the sparse net grid (c)
# the codec grids' ticks (cut from 30 and 20 so that the script with phase 25
# stays well inside its time limit; their checks hold at any count)
CODEC_GRID_TICKS = 10
# rule -> the views kernel a group of its cells launches once a tick
VIEWS_OF = {"trimmed_mean": "views_screen_trimmed_mean", "median": "views_screen_median",
            "bulyan": "views_screen_trimmed_mean"}


def net_grid_want(engine, ticks: int) -> dict:
    """The kernels of a net grid's run, per group and tick: BRIDGE-T / M's
    views kernel once (the wide path above 63 slots), BRIDGE-K / B's
    batched distance kernel once over the group's E M nodes (the body
    `pairwise.batch_plan` picks) and Bulyan's views trimmed mean once."""
    m = engine.grid.topology.num_nodes
    w = engine.neighbors.k if engine.sparse else m
    want: dict[str, int] = {}
    for (rules, _, codecs, _), (lo, hi) in zip(engine._banks, engine._bounds, strict=True):
        for rule in rules:
            names = [dist_body((hi - lo) * m, w + 1)] if rule in ("krum", "bulyan") else []
            if rule in VIEWS_OF:
                names.append("screen_wide" if w > gather_screen.MAX_SLOTS else VIEWS_OF[rule])
            for k in names:
                want[k] = want.get(k, 0) + ticks
        for k in decode_kernels(codecs):
            want[k] = want.get(k, 0) + ticks
    return want


def _net_grid_run(tag, grid, task, dev, ticks, *, sparse=False, accs_out=None):
    """One net grid on the card: the engine's run, timed (each kernel once a
    tick per group, counted; the views calls of two ticks held exactly
    against their plain versions on the path's own operands), then every
    cell's own trainer run over ``schedule_for(scenario)`` (sparse: on the
    engine's union table), timed; each cell's parameters and key equal (the
    shared ring may turn a -0.0 payload into +0.0, which torch.equal treats
    alike), its delivered_frac and mean_staleness streams equal, its loss
    stream bit for bit (else within rtol 1e-6, the cause printed); a codec
    grid's per-link carry decodes (one ``dequant_carry`` a group and tick)
    held too, and each cell's codec carry and adversary state equal its
    trainer's.  ``accs_out`` as in `_grid_run`.
    Returns the launches of the engine's run."""
    batches = stack_batches(task.batch_fn, ticks, device=dev)
    engine = GridEngine(grid, task.grad_fn, num_ticks=ticks, sparse=sparse, device=dev)
    state0 = engine.init(task.init_fn)
    e = engine.num_cells
    ring = state0.net.nbytes()
    carry = sum(x.nbytes for x in state0.comm) if state0.comm is not None else 0
    before = read_launches()
    with HeldCalls() as held:
        held.start({ticks // 2, ticks - 1})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, metrics = engine.run(state0, batches)
        torch.cuda.synchronize()
        wall_grid = time.perf_counter() - t0
        check_grew(f"net grid {tag}", before, net_grid_want(engine, ticks))
        used = {HELD_ENTRIES[VIEWS_OF[r]] for r in engine.rule_bank if r in VIEWS_OF}
        if "dequant_carry" in decode_kernels(engine.codec_bank):
            used.add("dequant_carry")
        summary = held.check(f"net grid {tag}", used)
    grew = {k: n - before[k] for k, n in read_launches().items() if n != before[k]}
    del state0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = []
    for cell in engine.cells:
        spec = get_scenario(cell.scenario)
        sched = engine.runtime.schedule_for(cell.scenario)
        kw = dict(topology=grid.topology, rule=cell.rule, num_byzantine=cell.b,
                  attack=cell.attack, adversary=cell.adversary, codec=cell.codec, lam=grid.lam,
                  t0=grid.t0, byzantine_seed=cell.mask_seed)
        if sparse:
            rt = SparseUnreliableRuntime(sched, spec.channel, staleness_bound=spec.staleness_bound,
                                         neighbors=engine.neighbors, device=dev)
            tr = BridgeTrainer(BridgeConfig(**kw, sparse=True), task.grad_fn, runtime=rt,
                               device=dev)
        else:
            tr = AsyncBridgeTrainer(AsyncBridgeConfig(**kw, channel=spec.channel,
                                                      staleness_bound=spec.staleness_bound,
                                                      schedule=sched), task.grad_fn, device=dev)
        st = tr.init(task.init_fn(cell.seed), seed=cell.seed)
        hist = []
        for i in range(ticks):
            st, m = tr.step(st, tuple(x[i] for x in batches))
            hist.append(m)
        streams = {k: torch.stack([h[k] for h in hist])
                   for k in ("loss", "delivered_frac", "mean_staleness")}
        seq.append((st, streams, tr.honest_mask))
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    loss_note, accs = "bit for bit", []
    for i, (cell, (st, streams, honest)) in enumerate(zip(engine.cells, seq, strict=True)):
        for k in st.params:
            if not torch.equal(final.params[k][i], st.params[k]):
                diff = float((final.params[k][i] - st.params[k]).abs().max())
                raise AssertionError(f"net grid {tag}: cell {cell.tag} ({k}) differs from its "
                                     f"trainer run by up to {diff:.3g}")
        if not np.array_equal(final.key[i], st.key):
            raise AssertionError(f"net grid {tag}: cell {cell.tag}'s key differs")
        check_carries(f"net grid {tag}", cell, final, i, st)
        for k in ("delivered_frac", "mean_staleness"):
            if not torch.equal(metrics[k][i], streams[k]):
                raise AssertionError(f"net grid {tag}: cell {cell.tag}'s {k} stream differs")
        if not torch.equal(metrics["loss"][i], streams["loss"]):
            torch.testing.assert_close(metrics["loss"][i], streams["loss"], rtol=1e-6, atol=0,
                                       msg=f"net grid {tag}: cell {cell.tag}'s loss stream")
            loss_note = ("within rtol 1e-6 (the loss sums over the nodes' margins round per "
                         "batched reduction shape on the card)")
        accs.append(task.eval_accuracy({k: v[i] for k, v in final.params.items()}, honest))
        if accs_out is not None:
            accs_out[cell.tag] = accs[-1]
    if carry:
        print(f"net grid {tag}: per-link codec carry {carry} bytes ({carry // e} a cell)")
    print(f"net grid {tag}: {e} cells x {ticks} ticks, {engine.num_steps_built} groups, "
          f"scenarios {engine.scenario_bank}: every cell equal to its own trainer run on the card "
          f"(parameters and key bit for bit up to the sign of a zero, delivered_frac and "
          f"mean_staleness streams equal, loss stream {loss_note}); honest accuracy "
          f"{min(accs):.4f}-{max(accs):.4f}; mailbox state {ring} bytes ({ring // e} a cell)")
    if summary:
        print(f"net grid {tag}: held exactly against the plain versions on the path's "
              f"operands: {summary}")
    print(f"net grid {tag} throughput: engine {wall_grid:.3f} s ({e / wall_grid:.2f} cells/s, "
          f"{wall_grid / ticks * 1e3:.3f} ms/tick for all {e} cells); one by one through the "
          f"trainer {wall_seq:.3f} s ({e / wall_seq:.2f} cells/s, "
          f"{wall_seq / ticks / e * 1e3:.3f} ms/tick a cell); speedup "
          f"{wall_seq / wall_grid:.2f}x")
    return grew


def views_experiment_records(dev) -> list:
    """The views kernels with the experiment axis at the net grids' group
    shapes: E = 44 cells of M = W = 20 (E M = 880 nodes) and E = 8 of
    M = 512, K = 16 (4096), a usable mask a cell, per-cell b (1 and 2
    alternating): one launch, exact against the plain version and each
    cell bit for bit the one-cell kernel; timed beside the path it replaces
    (one launch per distinct b over the cells of that b, their views
    copied into [E_b M, W, d]), the plain version and, for the median,
    ``torch.nanquantile``.  Records ``views_screen_*[E]`` at the dense
    shape (their launches are the net grid engines', `net_grid_phase`
    sets them)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    records = []
    src = "src/repro_torch/kernels/csrc/views_screen.cu"
    for tag, e, m, w in (("dense", 44, 20, 20), ("sparse", 8, SM, 16)):
        views = torch.randn((e, m, w, D), generator=gen, device=dev)
        views[0, 1, 2, 3], views[1, 0, 1] = float("nan"), float("inf")
        views[2, 3, 0, :7] = 1e30
        sv = torch.randn((e, m, D), generator=gen, device=dev)
        mask = torch.rand((e, m, w), generator=gen, device=dev) < 0.6
        mask[0, 0] = False  # a starved node
        bs = [1 + (i % 2) for i in range(e)]
        b_t = torch.tensor(bs, dtype=torch.int32, device=dev)
        tm = lambda: views_screen.views_screen_trimmed_mean(views, mask, sv, b_t)  # noqa: E731
        md = lambda: views_screen.views_screen_median(views, mask, sv)  # noqa: E731

        def per_b():
            """The replaced path: one launch per distinct b over the cells
            of that b, their views stacked [E_b M, W, d] (a copy)."""
            out = torch.empty_like(sv)
            for b in sorted(set(bs)):
                sel = torch.as_tensor([i for i in range(e) if bs[i] == b], device=dev)
                y = views_screen.views_screen_trimmed_mean(
                    views.index_select(0, sel).reshape(-1, w, D),
                    mask.index_select(0, sel).reshape(-1, w), sv.index_select(0, sel).reshape(
                        -1, D), b)
                out.index_copy_(0, sel, y.reshape(-1, m, D))
            return out

        got_t, got_m = tm(), md()
        exact_or_raise(f"views[E] {tag} trimmed mean", got_t,
                       ref.trimmed_mean_views(views, mask, sv, b_t))
        exact_or_raise(f"views[E] {tag} median", got_m, ref.median_views(views, mask, sv))
        exact_or_raise(f"views[E] {tag} trimmed mean vs per b", got_t, per_b())
        for i in range(e):
            exact_or_raise(f"views[E] {tag} cell {i} trimmed mean vs the one-cell kernel",
                           got_t[i], views_screen.views_screen_trimmed_mean(views[i], mask[i],
                                                                          sv[i], bs[i]))
            exact_or_raise(f"views[E] {tag} cell {i} median vs the one-cell kernel", got_m[i],
                           views_screen.views_screen_median(views[i], mask[i], sv[i]))
        counts = mask.sum(dim=-1).reshape(-1).cpu().numpy()
        nbytes, _, med_ops = views_bound(counts, D, 0)
        nbytes += e * m * w + 4 * e
        tm_ops = D * sum(2 * batcher_pairs(int(c)) + int(c)
                         - 2 * min(b, max((int(c) - 1) // 2, 0)) + 2
                         for b, row in zip(bs, counts.reshape(e, m), strict=True) for c in row)
        print(f"views[E] {tag} (E={e}, M={m}, W={w}, E M = {e * m} nodes, "
              f"{counts.mean():.2f} usable views a node, b 1 and 2): trimmed mean one launch "
              f"{cuda_ms(tm):.4f} ms against one launch per b over copied views "
              f"{cuda_ms(per_b):.4f} ms; median {cuda_ms(md):.4f} ms")
        if tag != "dense":
            continue
        full = torch.cat([torch.where(mask[..., None], views, torch.nan), sv[:, :, None]], dim=2)
        for name, kern, plain, lib, ops in (
            ("views_screen_trimmed_mean", tm, lambda: ref.trimmed_mean_views(views, mask, sv, b_t),
             None, tm_ops),
            ("views_screen_median", md, lambda: ref.median_views(views, mask, sv),
             lambda: torch.nanquantile(full, 0.5, dim=2), med_ops),
        ):
            rec = record(f"{name}[E]", src, ("src/repro/kernels/trimmed_mean.py:109"
                                             if "trimmed" in name else
                                             "src/repro/kernels/median.py:87"),
                         kern, plain, lib, nbytes, ops, max_abs_err(kern(), plain()))
            rec["_counter"] = name
            records.append(rec)
        del full
    print("library: the views trimmed mean has no single PyTorch call; the median's is "
          "torch.nanquantile(q=0.5) over the masked [E, M, W+1, d] views and self")
    return records


def net_grid_phase(dev):
    """Phase 19: the net-scenario grids on the card (the module docstring's
    list), then the sweep's grid mode with scenarios into a temporary
    store, twice; returns the views experiment-axis records and the
    launches of the runs."""
    records = views_experiment_records(dev)
    zero_launches()
    engine_launches: dict[str, int] = {}  # the engines' runs alone: the [E] forms

    def grid_run(*args, **kw):
        for k, n in _net_grid_run(*args, **kw).items():
            engine_launches[k] = engine_launches.get(k, 0) + n

    rules = ("trimmed_mean", "median")
    # (a) the net benchmark's task over every scenario, one topology
    task = net_task(20, dev, num_train=4000, num_test=800, batch=32)
    grid = ExperimentGrid(default_topology(20, rules, (2,), seed=0), rules, ("alie",), (2,),
                          (0, 1), scenarios=tuple(NET_SCENARIOS), lam=1.0, t0=30.0)
    grid_run("dense (M=20, 11 scenarios)", grid, task, dev, NET_GRID_TICKS)
    # (b) BRIDGE-K / BRIDGE-B: the batched distance kernel over E M nodes
    kb = ("krum", "bulyan")
    grid = ExperimentGrid(default_topology(20, kb, (1, 2), seed=0), kb, ("alie",), (1, 2), (0,),
                          scenarios=("ideal", "lossy"), lam=1.0, t0=30.0)
    grid_run("K/B (M=20)", grid, task, dev, NET_GRID_TICKS)
    # (c) the sparse runtime at the scale setting, one union table
    task = net_task(SM, dev, num_train=16384, num_test=1000, batch=8)
    grid = ExperimentGrid(small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0), rules, ("alie",),
                          (1,), (0, 1), scenarios=("lossy", "lossy_laggy"), lam=1.0, t0=100.0)
    grid_run(f"sparse (M={SM})", grid, task, dev, SPARSE_NET_GRID_TICKS, sparse=True)
    # the sweep's grid mode with scenarios, into a temporary store, twice
    with tempfile.TemporaryDirectory() as store:
        args = ["--mode", "grid", "--out", store, "--scenarios", "ideal,lossy", "--grid-ticks",
                "10"]
        res = sweep.main(args)
        if res is None or len(res.cells) != 8 or any(r["scenario"] is None for r in res.cells):
            raise AssertionError("sweep --mode grid --scenarios: expected 8 net cells computed")
        if sweep.main(args) is not None:
            raise AssertionError("sweep --mode grid --scenarios: the second run recomputed cells")
        accs = ", ".join(f"{r['accuracy']:.4f}" for r in res.cells)
        print(f"sweep --mode grid --scenarios ideal,lossy on the card: 8 cells (accuracy "
              f"{accs}), the second run found every cell cached")
    for rec in records:
        rec["launches"] = engine_launches.get(rec.pop("_counter"), 0)
    print(f"launches of the net grid engines' runs (the [E] forms): {engine_launches}")
    return records, read_launches()


# ---------------------------------------------------------------------------
# 20. Codec grids
# ---------------------------------------------------------------------------


def codec_grid_phase(dev):
    """Phase 20: lossy codecs and wire attacks over the grids' cells (the
    module docstring's list); returns no records and the launches of the
    runs."""
    zero_launches()
    rules = ("trimmed_mean", "median")
    # (a) the grid_bench grid under the codecs and the wire attacks
    task = linear_task(12, partition="iid", num_train=4000, num_test=800, batch=32, device=dev)
    grid = ExperimentGrid(default_topology(12, rules, (2,), seed=0), rules,
                          ("random", "alie", "scale_abuse", "garbage_codeword"), (2,), (0, 1),
                          codecs=("identity", "int8", "int4", "topk25_int8"), lam=1.0, t0=30.0)
    _grid_run("codecs (a) grid_bench (M=12)", grid, task, dev, CODEC_GRID_TICKS, acc_rules=())
    # (b) dense net cells, per-link int8 / int4 carries
    task = net_task(20, dev, num_train=4000, num_test=800, batch=32)
    grid = ExperimentGrid(default_topology(20, rules, (2,), seed=0), rules, ("alie",), (2,),
                          (0, 1), scenarios=("lossy", "lossy_laggy", "narrowband64k"),
                          codecs=("int8", "int4"), lam=1.0, t0=30.0)
    _net_grid_run("codecs (b) dense (M=20)", grid, task, dev, CODEC_GRID_TICKS)
    # (c) the sparse runtime at the scale setting, per-link int8
    task = net_task(SM, dev, num_train=16384, num_test=1000, batch=8)
    grid = ExperimentGrid(small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0), rules, ("alie",),
                          (1,), (0, 1), scenarios=("lossy",), codecs=("int8",), lam=1.0,
                          t0=100.0)
    _net_grid_run(f"codecs (c) sparse (M={SM})", grid, task, dev, CODEC_GRID_TICKS,
                  sparse=True)
    print("dequant_carry launches per group and tick on the codec grids: 1 (counted above: "
          "each lossy dense group's cells decode in one launch)")
    return read_launches()


# ---------------------------------------------------------------------------
# 21. Adversaries
# ---------------------------------------------------------------------------

ADVERSARY_TICKS = 60
STATIC_ADVERSARIES = ("random", "alie")
ADAPTIVE_ADVERSARIES = ("ipm", "alie_online", "dissensus", "inner_max", "equivocate", "slander")
# each screen entry the adversaries' screening oracle reaches, under autograd
# in the ascent -> its plain twin (autograd through torch's own ops)
PLAIN_TWINS = {"trimmed_mean": ref.trimmed_mean_dense, "median": ref.median_dense,
               "gather_trimmed_mean": ref.gather_trimmed_mean, "gather_median": ref.gather_median,
               "views_trimmed_mean": ref.trimmed_mean_views, "views_median": ref.median_views}


class PlainAutograd:
    """Within it, the screens run their plain twins with torch's autograd
    through them (no `kernels.autograd` Function, no kernel): the
    yardstick the Functions' gradients are held against."""

    def __enter__(self):
        self.saved = {name: getattr(ops, name) for name in PLAIN_TWINS}
        self.screen = grad_ops.screen
        for name, fn in PLAIN_TWINS.items():
            setattr(ops, name, fn)
        grad_ops.screen = lambda spec, x, s: spec.forward(x, s)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(ops, name, fn)
        grad_ops.screen = self.screen


def delta_gradient(screen, w, byz, delta):
    """``d/d delta`` of ``sum(cot * screen(w with the Byzantine rows at
    mu + delta sigma))``, ``cot`` a seeded cotangent: the gradient the
    ascent reads, through ``screen`` (``[1, M, d] -> [1, M, d]``)."""
    mu, sigma, _ = adv_lib.honest_stats(w, byz)
    gen = torch.Generator(device=w.device)
    gen.manual_seed(21)
    cot = torch.randn(w.shape, generator=gen, device=w.device)
    leaf = delta.detach().clone().requires_grad_(True)
    wb = torch.where(byz[..., None], (mu + leaf * sigma)[:, None], w)
    (g,) = torch.autograd.grad((screen(wb) * cot).sum(), leaf)
    return g


def check_ascent(tag, screen, w, byz, delta, want: dict) -> str:
    """The Functions' gradient (kernels forward, plain or kernel backward)
    against autograd through the plain twins on the same operands, its
    launches exactly ``want`` (one screen forward and its backward); then
    the device time of the screen's forward and of its backward (CUDA
    events); returns a note.  The caller restores the counters after it."""
    before = read_launches()
    got = delta_gradient(screen, w, byz, delta)
    torch.cuda.synchronize()
    check_grew(f"{tag}: the delta gradient", before, want)
    with PlainAutograd():
        want_g = delta_gradient(screen, w, byz, delta)
    torch.testing.assert_close(got, want_g, rtol=1e-4, atol=1e-5,
                               msg=f"{tag}: the Functions' delta gradient")
    err = float((got - want_g).abs().max())
    x = w.clone().requires_grad_(True)
    y = screen(x)
    cot = torch.ones_like(y)
    fwd = cuda_ms(lambda: screen(w), reps=9, inner=4)
    bwd = cuda_ms(lambda: torch.autograd.grad(y, x, cot, retain_graph=True), reps=9, inner=4)
    return (f"delta gradient within {err:.3g} of autograd through the plain twins, kernels "
            f"{want}; the screen's forward {fwd:.4f} ms, its backward {bwd:.4f} ms (device; "
            f"the views form's on its kernel)")


def adversary_trainer(tag, cfg, make_task, dev, ticks, *, kernels, backward=(), runtime_kw=None,
                      oracle=None):
    """One trainer with an adversary on the card, on a task of its own
    (``make_task()``: batches 0..ticks-1 of its stream): ``ticks`` ticks timed,
    its launches exactly ``kernels`` (the screen's forward kernels) once a
    screen and ``backward`` (its backward kernels) once a backward, a screen
    a tick and under ``inner_max`` `ascent_screens` more; then (``oracle``:
    the screen its adversary ascends through, built from the trainer) the
    Functions' gradient held against the plain twins on the run's last
    operands, its launches and times kept off the counts; returns the honest
    accuracy and ms/tick."""
    task = make_task()
    if runtime_kw is None:
        tr = BridgeTrainer(cfg, task.grad_fn, device=dev)
    else:
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        tr = AsyncBridgeTrainer(AsyncBridgeConfig(**fields, **runtime_kw), task.grad_fn,
                                device=dev)
    st = tr.init(task.init_fn(0), seed=0)
    batches = stack_batches(task.batch_fn, ticks, device=dev)
    fwd, bwd = ascent_screens([None] if cfg.adversary == "inner_max" else [])
    want = {k: ticks * (1 + fwd) for k in kernels} | {k: ticks * bwd for k in backward}
    before = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ticks):
        st, _ = tr.step(st, tuple(x[i] for x in batches))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ticks * 1e3
    check_grew(tag, before, want)
    acc = task.eval_accuracy(st.params, tr.honest_mask)
    note = f"; launches {want} ({1 + fwd} screens and {bwd} backwards a tick)"
    if oracle is not None:
        saved = read_launches()
        note += "; " + check_ascent(
            tag, oracle(tr), stack_flatten(st.params)[0][None], tr.byz_mask[None],
            st.adv.dir[None] if st.adv.dir.ndim == 1 else st.adv.dir,
            dict.fromkeys((*kernels, *backward), 1))
        set_launches(saved)
    check_accuracy(tag, acc)
    print(f"{tag}: honest accuracy {acc:.4f} (reference {REFERENCE_ACCURACY[tag]:.4f}), "
          f"{ms:.3f} ms/tick over {ticks} ticks{note}")
    return acc, ms


# what the views backward kernels stand for: no TPU kernel computes this
# gradient; the reference takes it with jax.grad of its screening functions
GRAD_REPLACES = {"trimmed_mean": "jax.grad of src/repro/core/screening.py:165, no pallas_call",
                 "median": "jax.grad of src/repro/core/screening.py:191, no pallas_call"}


def views_grad_records(dev) -> list:
    """The views screens' backward kernels at the sparse oracle's shape
    (E = 1, M = 512, W = 16, d = 7850; NaN, inf, ties, a starved node),
    exact against the plain backward (`kernels.autograd.plain_backward`)
    for the trimmed mean at b = 1 and at per-cell b, and for the median;
    timed beside it (records; their launches are the main path's); then
    the wide kernel (above 64 slots, the dense runtime's views at M = W =
    129) exact against it and timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    e, m, w = 1, SM, 16
    views = torch.randn((e, m, w, D), generator=gen, device=dev)
    views[0, 1, 2, 3], views[0, 0, 1] = float("nan"), float("inf")
    views[0, 2, 3] = views[0, 2, 4]  # a tie
    mask = torch.rand((m, w), generator=gen, device=dev) < 0.75
    mask[0] = False  # a starved node
    sv = torch.randn((e, m, D), generator=gen, device=dev)
    gy = torch.randn((e, m, D), generator=gen, device=dev)
    b_t = torch.tensor([1], dtype=torch.int32, device=dev)
    src = "src/repro_torch/kernels/csrc/views_screen_grad.cu"
    records = []
    for name, rule, kern in (
        ("views_screen_grad_trimmed_mean", "trimmed_mean",
         lambda: grad_ops.views_grad_trimmed_mean(views, mask, gy, 1)),
        ("views_screen_grad_median", "median",
         lambda: grad_ops.views_grad_median(views, mask, sv, gy)),
    ):
        spec = grad_ops.ScreenSpec(None, rule, "views", mask, 1)
        plain = lambda spec=spec: grad_ops.plain_backward(spec, views, sv, gy)  # noqa: E731
        got, want = kern(), plain()
        for g, p_ in zip(got, want, strict=True):
            exact_or_raise(f"{name} against the plain backward", g, p_)
        if rule == "trimmed_mean":
            per_cell = grad_ops.views_grad_trimmed_mean(views, mask, gy, b_t)
            for g, p_ in zip(per_cell, want, strict=True):
                exact_or_raise(f"{name} with per-cell b", g, p_)
        n = w + (rule == "median")
        nbytes = 2 * views.numel() * 4 + mask.numel() + (2 + (rule == "median")) * gy.numel() * 4
        records.append(record(name, src, GRAD_REPLACES[rule], kern, plain, None, nbytes,
                              e * m * D * n * n, max(max_abs_err(g, p_) for g, p_ in
                                                     zip(got, want, strict=True))))
    print("library: no PyTorch call computes a screen's backward; the plain version is "
          "autograd.py's sort over every node's views")
    del views, sv, gy
    # the wide kernel: every slot of a dense runtime's views above 64 slots
    m = w = WIDE_M
    views = torch.randn((1, m, w, D), generator=gen, device=dev)
    views[0, 3, 5, :7] = float("nan")
    views[0, 4, 6:9] = views[0, 4, 9]  # ties
    mask = torch.rand((m, w), generator=gen, device=dev) < 0.9
    mask[1] = False
    sv = torch.randn((1, m, D), generator=gen, device=dev)
    gy = torch.randn((1, m, D), generator=gen, device=dev)
    for rule, bs in (("trimmed_mean", (0, 3)), ("median", (0,))):
        for b in bs:
            spec = grad_ops.ScreenSpec(None, rule, "views", mask, b)
            before = read_launches()
            got = grad_ops._backward(spec, views, sv, gy)
            check_grew(f"views backward {rule} W = {w}", before,
                       {f"views_screen_grad_{rule}": 1})
            want = grad_ops.plain_backward(spec, views, sv, gy)
            for g, p_ in zip(got, want, strict=True):
                exact_or_raise(f"views backward {rule} b = {b} at W = {w}", g, p_)
        kern_ms = cuda_ms(lambda spec=spec: grad_ops._backward(spec, views, sv, gy), reps=5,
                          inner=2)
        plain_ms = cuda_ms(lambda spec=spec: grad_ops.plain_backward(spec, views, sv, gy),
                           reps=5, inner=2)
        print(f"views backward {rule}, wide kernel at M = W = {w}, d = {D}: exact against the "
              f"plain backward; {kern_ms:.4f} ms, plain {plain_ms:.4f} ms (device)")
    return records


def adversary_phase(dev):
    """Phase 21: the adversaries on the card (the module docstring's list);
    returns the views backward kernels' records and the launches of the
    runs."""
    records = views_grad_records(dev)
    zero_launches()
    rules = ("trimmed_mean", "median")
    names = STATIC_ADVERSARIES + ADAPTIVE_ADVERSARIES
    extreme = lambda m: lambda: linear_task(  # noqa: E731
        m, partition="extreme", num_train=4000, num_test=800, batch=32, device=dev)
    task = extreme(10)()
    grid = ExperimentGrid(default_topology(10, rules, (3,), seed=0), rules, ("none",), (1, 2, 3),
                          (0,), adversaries=names, lam=1.0, t0=30.0)
    accs: dict[str, float] = {}
    _grid_run("adversaries (M=10)", grid, task, dev, ADVERSARY_TICKS, acc_rules=(),
              accs_out=accs)
    # each cell's accuracy against the reference's; the static / adaptive inversion
    by_cell, worst = {}, 0.0
    for cell in grid.cells():
        acc = accs[cell.tag]
        tag = f"adversary {cell.rule} {cell.adversary} b{cell.b}"
        check_accuracy(tag, acc)
        by_cell[cell.rule, cell.adversary, cell.b] = acc
        worst = max(worst, abs(acc - REFERENCE_ACCURACY[tag]))
    print(f"grid adversaries (M=10): every honest accuracy within {worst:.2g} of the "
          f"reference's ({min(accs.values()):.4f}-{max(accs.values()):.4f})")
    for rule in rules:
        for b in (1, 2, 3):
            static = min(by_cell[rule, a, b] for a in STATIC_ADVERSARIES)
            worst = min(ADAPTIVE_ADVERSARIES, key=lambda a: by_cell[rule, a, b])
            adaptive = by_cell[rule, worst, b]
            ref_static = min(REFERENCE_ACCURACY[f"adversary {rule} {a} b{b}"]
                             for a in STATIC_ADVERSARIES)
            ref_adaptive = min(REFERENCE_ACCURACY[f"adversary {rule} {a} b{b}"]
                               for a in ADAPTIVE_ADVERSARIES)
            print(f"adversary inversion {rule} b={b}: best static attack leaves {static:.4f}, "
                  f"the worst adaptive ({worst}) {adaptive:.4f}: "
                  f"{'holds' if adaptive < static else 'does not hold'} on the card "
                  f"(reference {ref_static:.4f} / {ref_adaptive:.4f}: "
                  f"{'holds' if ref_adaptive < ref_static else 'does not hold'})")
    ms_tick = {}
    for name in names:
        cfg = BridgeConfig(topology=grid.topology, rule="trimmed_mean", num_byzantine=2,
                           adversary=name, lam=1.0, t0=30.0, byzantine_seed=0)
        oracle = None
        if name == "inner_max":
            oracle = lambda tr: (lambda wb: screening.screen_all_banked(  # noqa: E731
                wb, tr.adjacency, ("trimmed_mean",), (0,), (2,), self_vals=wb))
        _, ms_tick[name] = adversary_trainer(
            f"adversary trimmed_mean {name} b2", cfg, extreme(10), dev, ADVERSARY_TICKS,
            kernels=("screen_trimmed_mean_dense",), oracle=oracle)
    print("adversary ms/tick (BRIDGE-T, M = 10, b = 2, one trainer): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms_tick.items()))
    # BRIDGE-K / BRIDGE-B under inner_max at M = 20
    kb = ("krum", "bulyan")
    topo = default_topology(20, kb, (2,), seed=0)
    for rule in kb:
        cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=2, adversary="inner_max",
                           lam=1.0, t0=30.0, byzantine_seed=0)
        oracle = (lambda r: lambda tr: (lambda wb: screening.screen_all_banked(
            wb, tr.adjacency, (r,), (0,), (2,), self_vals=wb)))(rule)
        # one experiment's distances run the unbatched kernel (`screening._dists`)
        adversary_trainer(f"adversary {rule} inner_max b2 (M=20)", cfg, extreme(20), dev,
                          ADVERSARY_TICKS, oracle=oracle,
                          kernels=("pairwise_sq_dists",) + (("screen_trimmed_mean_dense",)
                                                            if rule == "bulyan" else ()))
    # the runtime: the message forms, then the sparse views oracle
    topo = default_topology(20, ("trimmed_mean",), (2,), seed=0)
    spec = get_scenario("lossy_laggy")
    sched = scenario_schedule(spec.schedule_kind, topo, ADVERSARY_TICKS, seed=0,
                              churn_prob=spec.churn_prob)
    for name in ("dissensus", "equivocate"):
        cfg = BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=2, adversary=name,
                           lam=1.0, t0=30.0)
        adversary_trainer(f"adversary net lossy_laggy {name}", cfg, extreme(20), dev,
                          ADVERSARY_TICKS, kernels=(VIEWS_OF["trimmed_mean"],),
                          runtime_kw=dict(channel=spec.channel,
                                          staleness_bound=spec.staleness_bound, schedule=sched))
    topo = small_world(SM, NEAREST, 1, rewire_prob=0.2, seed=0)
    spec = get_scenario("lossy")
    sched = scenario_schedule(spec.schedule_kind, topo, SPARSE_NET_GRID_TICKS, seed=0,
                              churn_prob=spec.churn_prob)
    for rule, tag in (("trimmed_mean", ""), ("median", " median")):
        cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=1, adversary="inner_max",
                           lam=1.0, t0=100.0, sparse=True)

        def views_oracle(tr, rule=rule):
            nbr = tr.runtime.neighbors
            live = tr.runtime.adjacency_at(0)
            return lambda wb: screening.screen_views_banked(nbr.gather_rows(wb, lead=1), live, wb,
                                                            (rule,), (0,), (1,))

        adversary_trainer(f"adversary net sparse lossy inner_max{tag}", cfg,
                          lambda: net_task(SM, dev, num_train=16384, num_test=1000, batch=8), dev,
                          SPARSE_NET_GRID_TICKS, oracle=views_oracle,
                          kernels=(VIEWS_OF[rule],), backward=(f"views_screen_grad_{rule}",),
                          runtime_kw=dict(channel=spec.channel,
                                          staleness_bound=spec.staleness_bound, schedule=sched))
    return records, read_launches()


# ---------------------------------------------------------------------------
# 22. Breakdown certification, the red-team search, batches gathered on the card
# ---------------------------------------------------------------------------

# tools/reference_accuracy.py group breakdown (the reference on a CPU):
# each certification's feasible_b, reference probe, b*, certified_monotone
# and probes (survived, final_loss, score); the unstable quadratic's first
# bad ticks (b: tick, "0" the reference probe); the search's generation 0
REFERENCE_BREAKDOWN = {
    "breakdown certification": {
        "trimmed_mean": {"feasible_b": 3, "ref": {"final_loss": 0.4208391606807709,
                   "score": 0.9906249821186066}, "adversaries": {
            "random": {"bstar": 2, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.35683566331863403,
                      "score": 0.8938888642523024},
                "2": {"survived": True, "final_loss": 0.34383445978164673,
                      "score": 0.7879687249660492},
                "3": {"survived": False, "final_loss": 0.2624909281730652,
                      "score": 0.7148214152881077},
            }},
            "alie": {"bstar": 2, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 1.1993119716644287,
                      "score": 0.8879166377915276},
                "2": {"survived": True, "final_loss": 14.913347244262695,
                      "score": 0.7478124871850014},
                "3": {"survived": False, "final_loss": 80.99855041503906,
                      "score": 0.5473214132445199},
            }},
            "ipm": {"bstar": 1, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.5649731159210205,
                      "score": 0.8708333174387614},
                "2": {"survived": False, "final_loss": 0.7561164498329163,
                      "score": 0.7218749821186066},
                "3": {"survived": False, "final_loss": 0.8992071151733398,
                      "score": 0.5857142635754177},
            }},
            "inner_max": {"bstar": 1, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.8323385715484619,
                      "score": 0.8506944245762296},
                "2": {"survived": False, "final_loss": 15.775032997131348,
                      "score": 0.6162499859929085},
                "3": {"survived": False, "final_loss": 37.673805236816406,
                      "score": 0.5008928392614637},
            }},
        }},
        "median": {"feasible_b": 3, "ref": {"final_loss": 0.6548618078231812,
                   "score": 0.9532499790191651}, "adversaries": {
            "random": {"bstar": 3, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.6231481432914734,
                      "score": 0.8579166399108039},
                "2": {"survived": True, "final_loss": 0.47345539927482605,
                      "score": 0.7948437184095383},
                "3": {"survived": True, "final_loss": 0.44231048226356506,
                      "score": 0.7133928452219281},
            }},
            "alie": {"bstar": 2, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 1.1381888389587402,
                      "score": 0.8515277637375726},
                "2": {"survived": True, "final_loss": 4.506916046142578,
                      "score": 0.7289062291383743},
                "3": {"survived": False, "final_loss": 117.13956451416016,
                      "score": 0.46124998586518423},
            }},
            "ipm": {"bstar": 2, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.6981427669525146,
                      "score": 0.8479166428248087},
                "2": {"survived": True, "final_loss": 0.6849954128265381,
                      "score": 0.7542187348008156},
                "3": {"survived": False, "final_loss": 0.7974771857261658,
                      "score": 0.6558928489685059},
            }},
            "inner_max": {"bstar": 1, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 0.9527460932731628,
                      "score": 0.8563888536559211},
                "2": {"survived": False, "final_loss": 3.648162364959717,
                      "score": 0.688906230032444},
                "3": {"survived": False, "final_loss": 10.91140079498291,
                      "score": 0.5810714364051819},
            }},
        }},
    },
    "breakdown scenario lossy": {
        "trimmed_mean": {"feasible_b": 2, "ref": {"final_loss": 0.7292684316635132,
                   "score": 0.9687499880790711}, "adversaries": {
            "alie_online": {"bstar": 2, "certified_monotone": True, "probes": {
                "1": {"survived": True, "final_loss": 1.1555041074752808,
                      "score": 0.8548611005147299},
                "2": {"survived": True, "final_loss": 3.261141061782837,
                      "score": 0.7284374758601189},
            }},
        }},
    },
}
REFERENCE_UNSTABLE = {"0": 6, "1": 6, "2": 6}
REFERENCE_SEARCH = {
    "thetas": [
        [6.0, 1.5, 0.0, 0.0],
        [12.92075290276836, 1.1744667844096757, 0.0, 0.0],
        [1.2989837167557965, 0.5413190888213227, 0.0, 0.0],
        [16.35876966440531, 2.7818889431943044, 0.0, 0.0],
        [12.329397627460008, 2.323741402459996, 0.0, 0.0],
        [11.100687333575745, 2.8376810594694204, 0.0, 0.0],
        [16.40914430536988, 0.5068462504253702, 0.0, 0.0],
        [17.2193833934576, 0.5839639382636609, 0.0, 0.0],
        [14.72828120538391, 0.9391390515063975, 0.0, 0.0],
        [17.33198898582279, 1.8536530506227293, 0.0, 0.0],
        [6.344381865479003, 1.556718052994146, 0.0, 0.0],
        [1.0522335873365278, 0.8107081912489098, 0.0, 0.0],
    ],
    "generation0_fitness": [
        0.7621195912361145, 0.8234375715255737, 0.4216989278793335,
        1.064594030380249, 0.9393932819366455, 0.9283605813980103,
        0.46325862407684326, 0.5293097496032715, 0.709145724773407,
        1.0385804176330566, 0.7753125429153442, 0.4303092360496521,
    ],
    "best_fitness": 1.0904512405395508, "default_fitness": 0.7621195912361145,
}
BREAKDOWN_TICKS = 60  # benchmarks/breakdown_bench.py's certification
SCORE_DROP, LOSS_RATIO = 0.25, 50.0
SEARCH_TICKS, SEARCH_GENERATIONS = 40, 4  # the search CLI's defaults
SCENARIO_TICKS = 30
LOSS_RTOL = 1e-4  # a final loss (a search fitness is one) against the reference's
DRAW_TICKS = 200


def round_want(bd, ticks: int, *, net: bool = False, runs: int = 1) -> dict:
    """The launches of every probe round of a `BreakdownEngine` (each
    round's engine `grid_want` or `net_grid_want`, ``runs`` runs a round)."""
    want: dict[str, int] = {}
    for eng in bd.round_engines:
        for k, n in (net_grid_want(eng, ticks) if net else grid_want(eng, ticks)).items():
            want[k] = want.get(k, 0) + runs * n
    return want


def ascent_launches(bd, ticks: int, runs: int = 1) -> int:
    """Of `round_want`'s launches, those of ``inner_max``'s ascent (the
    screens under autograd: `ascent_screens`' forwards a tick for each
    group with ``inner_max`` cells)."""
    total = 0
    for eng in bd.round_engines:
        for lo, hi in eng._bounds:
            ascent = [eng.cells[i].theta for i in eng._perm[lo:hi]
                      if eng.cells[i].adversary == "inner_max"]
            total += runs * ticks * ascent_screens(ascent)[0]
    return total


def loss_err(tag: str, got: float, want: float) -> float:
    """``got``'s relative distance from the reference's final loss
    ``want``; raises above ``LOSS_RTOL`` (a non-finite ``want`` must be
    met by a non-finite ``got``)."""
    if not math.isfinite(want):
        if math.isfinite(got):
            raise AssertionError(f"{tag}: final loss {got} finite, the reference's {want}")
        return 0.0
    err = abs(got - want) / abs(want)
    if not err <= LOSS_RTOL:
        raise AssertionError(f"{tag}: final loss {got!r} not within rtol {LOSS_RTOL} of the "
                             f"reference's {want!r}")
    return err


def hold_certificate(tag: str, got: dict, want: dict,
                     score_drop: float | None = None) -> tuple[list[str], float]:
    """A certification against the reference's (``REFERENCE_BREAKDOWN``):
    each rule's ``feasible_b``, every probe's final loss (the b = 0
    reference probe's included) within ``LOSS_RTOL`` and score within
    ``ACC_TOL``, each verdict equal, each pair's b* and
    ``certified_monotone`` equal.  A verdict may differ only where the
    reference's score lies within ``ACC_TOL`` of its threshold (the
    reference probe's score less ``SCORE_DROP``); b* then follows the
    card's verdicts.  Returns those probes, described, and the largest
    relative loss error.  ``score_drop`` is the run's (default
    ``SCORE_DROP``)."""
    moved = []
    worst_loss = 0.0
    for rule, wr in want.items():
        gr = got["rules"][rule]
        if gr["feasible_b"] != wr["feasible_b"]:
            raise AssertionError(f"{tag}: {rule} feasible_b {gr['feasible_b']} != the "
                                 f"reference's {wr['feasible_b']}")
        worst_loss = max(worst_loss, loss_err(f"{tag}: {rule} b = 0", gr["ref"]["final_loss"],
                                              wr["ref"]["final_loss"]))
        if not abs(gr["ref"]["score"] - wr["ref"]["score"]) <= ACC_TOL:
            raise AssertionError(f"{tag}: {rule}'s b = 0 score {gr['ref']['score']:.4f} not "
                                 f"within {ACC_TOL} of the reference's {wr['ref']['score']:.4f}")
        threshold = wr["ref"]["score"] - (SCORE_DROP if score_drop is None else score_drop)
        for adv, wa in wr["adversaries"].items():
            ga = gr["adversaries"][adv]
            if set(ga["probes"]) != set(wa["probes"]):
                raise AssertionError(f"{tag}: {rule} {adv} probed b {sorted(ga['probes'])}, the "
                                     f"reference {sorted(wa['probes'])}")
            differ = []
            for b, wp in wa["probes"].items():
                gp = ga["probes"][b]
                worst_loss = max(worst_loss, loss_err(f"{tag}: {rule} {adv} b={b}",
                                                      gp["final_loss"], wp["final_loss"]))
                if gp["score"] is None or not abs(gp["score"] - wp["score"]) <= ACC_TOL:
                    raise AssertionError(f"{tag}: {rule} {adv} b={b} score {gp['score']} not "
                                         f"within {ACC_TOL} of the reference's {wp['score']:.4f}")
                if gp["survived"] != wp["survived"]:
                    if not abs(wp["score"] - threshold) <= ACC_TOL:
                        raise AssertionError(f"{tag}: {rule} {adv} b={b} survived "
                                             f"{gp['survived']}, the reference {wp['survived']}")
                    differ.append(b)
                    moved.append(f"{rule} {adv} b={b} (card {gp['score']:.4f}, reference "
                                 f"{wp['score']:.4f}, threshold {threshold:.4f})")
            if not differ and (ga["bstar"], ga["certified_monotone"]) != (
                    wa["bstar"], wa["certified_monotone"]):
                raise AssertionError(f"{tag}: {rule} {adv} b* {ga['bstar']} (certified "
                                     f"{ga['certified_monotone']}), the reference "
                                     f"{wa['bstar']} ({wa['certified_monotone']})")
    return moved, worst_loss


def stars(res: dict) -> str:
    return "; ".join(f"{rule} " + ", ".join(f"{a} {r['bstar']}"
                                            for a, r in rrec["adversaries"].items())
                     for rule, rrec in res["rules"].items())


def certification_runs(dev, grew) -> None:
    """Phase 22 (a) and (c): the breakdown benchmark's certification, its
    bisection, and a certification through the net grids."""
    rules = ("trimmed_mean", "median")
    advs = ("random", "alie", "ipm", "inner_max")
    topo = default_topology(10, rules, (3,), seed=0)
    t0 = time.perf_counter()
    task = linear_task(10, BREAKDOWN_TICKS, num_train=4000, num_test=800, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"breakdown task: linear_task(10, {BREAKDOWN_TICKS}) with its batches stacked on the "
          f"card, {(time.perf_counter() - t0) * 1e3:.1f} ms")
    cfg = dict(b_max=3, score_drop=SCORE_DROP, loss_ratio=LOSS_RATIO)
    results = {}
    for mode in ("ladder", "bisect"):
        before = read_launches()
        t0 = time.perf_counter()
        bd = BreakdownEngine(topo, rules, advs, task.grad_fn, task.init_fn, task.batches,
                             lam=1.0, t0=30.0, eval_fn=task.eval_accuracy, device=dev,
                             config=BreakdownConfig(mode=mode, measure_compile=mode == "ladder",
                                                    **cfg))
        res = results[mode] = bd.run()
        wall = time.perf_counter() - t0
        want = round_want(bd, BREAKDOWN_TICKS, runs=2 if mode == "ladder" else 1)
        check_grew(f"breakdown {mode}", before, want)
        grew(before)
        meta = res["meta"]
        rounds = [e.num_cells for e in bd.round_engines]
        print(f"breakdown {mode}: {meta['cells_run']} cells in {len(rounds)} rounds {rounds}, "
              f"{meta['compiles']} steps built, {wall:.2f} s ({meta['cells_per_sec']:.2f} "
              f"cells/s); b* {stars(res)}; every round's launches exact ({want}; of them "
              f"inner_max's ascent forwards through the autograd Functions "
              f"{ascent_launches(bd, BREAKDOWN_TICKS, 2 if mode == 'ladder' else 1)})")
        if mode == "ladder":
            print(f"breakdown ladder: compile_s {meta['compile_s']:.3f} (the first run's excess "
                  f"over the second's), steady_state_s {meta['steady_state_s']:.3f}")
            moved, loss_worst = hold_certificate("breakdown ladder", res,
                                                 REFERENCE_BREAKDOWN["breakdown certification"])
            worst = max(abs(p["score"] - REFERENCE_BREAKDOWN["breakdown certification"][r][
                "adversaries"][a]["probes"][b]["score"])
                for r, rr in res["rules"].items() for a, ar in rr["adversaries"].items()
                for b, p in ar["probes"].items())
            print(f"breakdown ladder: b*, certified_monotone and every verdict equal to the "
                  f"reference's, every score within {worst:.3g} of its, every final loss "
                  f"within {loss_worst:.3g} (relative) of its"
                  + (f"; verdicts at the threshold that moved: {moved}" if moved else ""))
    for rule in rules:
        for adv in advs:
            lad = results["ladder"]["rules"][rule]["adversaries"][adv]
            bis = results["bisect"]["rules"][rule]["adversaries"][adv]
            if bis["bstar"] != lad["bstar"]:
                raise AssertionError(f"breakdown: {rule} {adv} bisect b* {bis['bstar']} != the "
                                     f"ladder's {lad['bstar']}")
            for b, p in bis["probes"].items():
                if p != lad["probes"][b]:
                    raise AssertionError(f"breakdown: {rule} {adv} b={b}: the bisection's probe "
                                         f"differs from the ladder's")
    print("breakdown bisect: every b* the ladder's, every probe it ran equal to the ladder's")
    # (c) through the net grids: the views kernels with the experiment axis
    task = linear_task(10, SCENARIO_TICKS, num_train=4000, num_test=800, seed=0, device=dev)
    topo = default_topology(10, ("trimmed_mean",), (2,), seed=0)
    before = read_launches()
    t0 = time.perf_counter()
    bd = BreakdownEngine(topo, ("trimmed_mean",), ("alie_online",), task.grad_fn, task.init_fn,
                         task.batches, lam=1.0, t0=30.0, eval_fn=task.eval_accuracy,
                         scenario="lossy", device=dev,
                         config=BreakdownConfig(b_max=2, score_drop=SCORE_DROP,
                                                loss_ratio=LOSS_RATIO))
    res = bd.run()
    wall = time.perf_counter() - t0
    want = round_want(bd, SCENARIO_TICKS, net=True)
    check_grew("breakdown scenario lossy", before, want)
    grew(before)
    moved, loss_worst = hold_certificate("breakdown scenario lossy", res,
                                         REFERENCE_BREAKDOWN["breakdown scenario lossy"])
    print(f"breakdown scenario lossy: {res['meta']['cells_run']} net cells, {wall:.2f} s, b* "
          f"{stars(res)}, held to the reference's (final losses within {loss_worst:.3g}, "
          f"relative); launches {want}"
          + (f"; verdicts at the threshold that moved: {moved}" if moved else ""))


def search_run(dev, grew) -> None:
    """Phase 22 (b): the red-team search at its CLI's defaults, and its
    generation 0 proposal by proposal against the reference's."""
    topo = default_topology(10, ("trimmed_mean",), (2,), seed=0)
    task = linear_task(10, SEARCH_TICKS, seed=0, device=dev)
    before = read_launches()
    t0 = time.perf_counter()
    led = red_team_search(topo, "trimmed_mean", "ipm", 2, task.grad_fn, task.init_fn,
                          task.batches, lam=1.0, t0=30.0, device=dev,
                          config=SearchConfig(generations=SEARCH_GENERATIONS))
    wall = time.perf_counter() - t0
    check_grew("search", before, {"screen_trimmed_mean_dense": SEARCH_GENERATIONS * SEARCH_TICKS})
    grew(before)
    if led["trace_count"] != 1 or led["step_calls"] != SEARCH_GENERATIONS * SEARCH_TICKS:
        raise AssertionError(f"search: trace_count {led['trace_count']}, step_calls "
                             f"{led['step_calls']} (one group: 1 and {SEARCH_GENERATIONS} "
                             f"generations x {SEARCH_TICKS} ticks)")
    if not led["best_fitness"] >= led["default_fitness"]:
        raise AssertionError(f"search: best fitness {led['best_fitness']} below the default's "
                             f"{led['default_fitness']}")
    thetas = [tuple(t) for t in REFERENCE_SEARCH["thetas"]]
    cells = [Cell("trimmed_mean", "none", 2, 0, adversary="ipm", mask_seed=0, theta=th)
             for th in thetas]
    grid = ExperimentGrid(topo, ("trimmed_mean",), ("none",), (2,), (0,), adversaries=("ipm",),
                          lam=1.0, t0=30.0)
    engine = GridEngine(grid, task.grad_fn, cells=cells, device=dev)
    before = read_launches()
    _, metrics = engine.run(engine.init(task.init_fn), task.batches)
    check_grew("search generation 0", before, grid_want(engine, SEARCH_TICKS))
    grew(before)
    fits = metrics["loss"][:, -1].double().cpu().numpy()
    want = np.asarray(REFERENCE_SEARCH["generation0_fitness"])
    np.testing.assert_allclose(fits, want, rtol=LOSS_RTOL,
                               err_msg="search: generation 0's fitness against the reference's")
    gen0 = led["generations"][0]
    np.testing.assert_allclose([gen0["best_fitness"], gen0["mean_fitness"]],
                               [fits.max(), fits.mean()], rtol=LOSS_RTOL)
    print(f"search trimmed_mean ipm b=2: {led['proposals_evaluated']} proposals in {wall:.2f} s, "
          f"trace_count {led['trace_count']}, step_calls {led['step_calls']}; generation 0 "
          f"within {float(np.max(np.abs(fits / want - 1))):.3g} (relative) of the reference's "
          f"fitness proposal by proposal; best {led['best_fitness']:.6f} (reference "
          f"{REFERENCE_SEARCH['best_fitness']:.6f}) >= default {led['default_fitness']:.6f} "
          f"(reference {REFERENCE_SEARCH['default_fitness']:.6f}), theta "
          f"{[round(t, 3) for t in led['best_theta']]}")


def sentinel_run(dev, grew) -> None:
    """Phase 22 (d): the sentinel dates each probe of the unstable quadratic
    at the reference's first bad tick; the events file holds the
    divergences."""
    m, d, ticks = 10, 4, 12
    targets = torch.as_tensor((3.0 * np.random.default_rng(0).normal(size=(m, d))).astype(
        np.float32), device=dev)

    def unstable(params, batch):
        w = params["w"]
        return 0.5e4 * torch.sum((w - batch) ** 2, dim=-1), {"w": 1e4 * (w - batch)}

    def init_fn(seed):
        return replicate({"w": torch.zeros(d, device=dev)}, m, perturb=0.1,
                         key=prng.PRNGKey(seed))

    before = read_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "events.jsonl")
        with EventLog(path) as ev:
            bd = BreakdownEngine(erdos_renyi(m, 0.8, 2, seed=1), ("trimmed_mean",), ("random",),
                                 unstable, init_fn, targets[None].expand(ticks, m, d).contiguous(),
                                 lam=1.0, t0=10.0, config=BreakdownConfig(b_max=2), events=ev,
                                 device=dev)
            bd.run()
        tags = [r["tag"] for r in read_events(path)]
    check_grew("breakdown sentinel", before, round_want(bd, ticks))
    grew(before)
    got = {str(b): rec["first_bad_tick"] for (_, _, b), rec in bd.probes.items()}
    if got != REFERENCE_UNSTABLE:
        raise AssertionError(f"breakdown sentinel: first bad ticks {got}, the reference's "
                             f"{REFERENCE_UNSTABLE}")
    # a divergence event a probe, the reference probe's included
    if tags.count("obs.divergence") != len(got) or "breakdown.round" not in tags:
        raise AssertionError(f"breakdown sentinel: events {tags}")
    print(f"breakdown sentinel: the unstable quadratic's probes dated at the reference's first "
          f"bad ticks {got} (b: tick; 0 the reference probe); events {sorted(set(tags))}")


def batch_draw_runs(dev) -> dict:
    """Phase 22 (e): the batch draw alone and the dense T (M = 50) and sparse
    T (M = 512) trainers over 200 ticks, with `stack_node_batches` and a
    pageable copy, and with the device form; each device batch first held
    bit for bit against the host's.  Returns the trainers' launches."""
    from repro_torch.data.partition import (device_node_batches, partition_iid,
                                            stack_node_batches)
    from repro_torch.sim.tasks import dataset

    setups = {
        "dense": (M, 6000, 32, dict(topology=erdos_renyi(M, 0.5, B, seed=0), num_byzantine=B,
                                    t0=30)),
        "sparse": (SM, 16384, 8, dict(topology=small_world(SM, NEAREST, SB, rewire_prob=0.2,
                                                           seed=0),
                                      num_byzantine=SB, t0=100, sparse=True)),
    }
    kernel = {"dense": "screen_trimmed_mean_dense", "sparse": "gather_screen_trimmed_mean"}
    launches: dict[str, int] = {}
    for name, (m, n, bsz, kw) in setups.items():
        x, y, xt, yt = dataset(n, 1000, 0)
        shards = partition_iid(x, y, m, seed=0)
        host, drawer = (stack_node_batches(shards, bsz, seed=0),
                        device_node_batches(shards, bsz, seed=0, device=dev))
        for i in range(20):
            hx, hy = host(i)
            dx, dy = drawer(i)
            if not (torch.equal(dx, torch.as_tensor(hx, device=dev))
                    and torch.equal(dy, torch.as_tensor(hy, device=dev))):
                raise AssertionError(f"batches {name}: tick {i} differs from stack_node_batches'")
        sx, sy = drawer.stacked(20)
        for i in range(20):
            hx, hy = host(20 + i)
            if not (torch.equal(sx[i], torch.as_tensor(hx, device=dev))
                    and torch.equal(sy[i], torch.as_tensor(hy, device=dev))):
                raise AssertionError(f"batches {name}: stacked tick {i} differs")
        del sx, sy

        def paths():
            host = stack_node_batches(shards, bsz, seed=0)

            def host_fn(i):
                bx, by = host(i)
                return torch.as_tensor(bx, device=dev), torch.as_tensor(by, device=dev)

            return {"stack_node_batches + pageable copy": host_fn,
                    "device gather": device_node_batches(shards, bsz, seed=0, device=dev)}

        draw_ms = {}
        for path, fn in paths().items():
            fn(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DRAW_TICKS):
                fn(i)
            torch.cuda.synchronize()
            draw_ms[path] = (time.perf_counter() - t0) / DRAW_TICKS * 1e3
        stacked = device_node_batches(shards, bsz, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sx, sy = stacked.stacked(DRAW_TICKS)
        torch.cuda.synchronize()
        stacked_ms = (time.perf_counter() - t0) / DRAW_TICKS * 1e3
        del sx, sy
        xt, yt = torch.as_tensor(xt, device=dev), torch.as_tensor(yt, device=dev)
        cfg = BridgeConfig(rule="trimmed_mean", attack="random", **kw)
        tick_ms, accs = {}, {}
        for path, fn in paths().items():
            tr = BridgeTrainer(cfg, small_model.linear_loss_and_grad, device=dev)
            key = prng.PRNGKey(0)
            st = tr.init(replicate(small_model.init_linear(key, device=dev), m, perturb=0.01,
                                   key=key), seed=1)
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DRAW_TICKS):
                st, _ = tr.step(st, fn(i))
            torch.cuda.synchronize()
            tick_ms[path] = (time.perf_counter() - t0) / DRAW_TICKS * 1e3
            check_grew(f"batches {name} trainer ({path})", before, {kernel[name]: DRAW_TICKS})
            launches[kernel[name]] = launches.get(kernel[name], 0) + DRAW_TICKS
            accs[path] = honest_accuracy(st.params, tr.honest_mask, xt, yt)
        if accs["device gather"] != accs["stack_node_batches + pageable copy"]:
            raise AssertionError(f"batches {name}: the two batch paths trained apart {accs}")
        print(f"batches {name} (M = {m}, B = {bsz}, {DRAW_TICKS} ticks): draw alone "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in draw_ms.items())
              + f", stacked({DRAW_TICKS}) {stacked_ms:.3f} ms a tick; BRIDGE-T ms/tick "
              + ", ".join(f"{k} {v:.3f}" for k, v in tick_ms.items())
              + f" (honest accuracy {accs['device gather']:.4f} both)")
    return launches


def breakdown_phase(dev):
    """Phase 22: breakdown certification, the red-team search, the sentinel
    and the batches gathered on the card (the module docstring's list);
    returns the launches of the phase and those of its grid engines (the
    experiment-axis forms)."""
    zero_launches()
    t_phase = time.perf_counter()
    engine_launches: dict[str, int] = {}

    def grew(before):
        for k, n in read_launches().items():
            if n != before[k]:
                engine_launches[k] = engine_launches.get(k, 0) + n - before[k]

    certification_runs(dev, grew)
    search_run(dev, grew)
    sentinel_run(dev, grew)
    trainer_launches = batch_draw_runs(dev)
    # the sweep's breakdown mode, into a temporary directory: a ladder runs
    # two rounds (the b = 0 reference, then every b), each one group (one
    # rule, one adversary), so one dense screen a tick a round
    sweep_ticks = 20
    with tempfile.TemporaryDirectory() as out:
        before = read_launches()
        res = sweep.main(["--mode", "breakdown", "--out", out, "--rules", "trimmed_mean",
                          "--adversaries", "ipm", "--breakdown-b-max", "2", "--grid-nodes", "10",
                          "--grid-ticks", str(sweep_ticks), "--trace", os.path.join(out, "trace")])
        check_grew("sweep --mode breakdown", before,
                   {"screen_trimmed_mean_dense": 2 * sweep_ticks})
        grew(before)
        with open(os.path.join(out, "BENCH_breakdown.json")) as f:
            saved = json.load(f)
        if saved != json.loads(json.dumps(res, sort_keys=True)) or not os.path.exists(
                os.path.join(out, "trace", "events.jsonl")):
            raise AssertionError("sweep --mode breakdown: BENCH_breakdown.json or the events "
                                 "file does not hold the run")
        print(f"sweep --mode breakdown on the card: BENCH_breakdown.json read back, b* "
              f"{stars(saved)}, {saved['meta']['cells_run']} cells, launches exact "
              f"(screen_trimmed_mean_dense {2 * sweep_ticks})")
    launches = read_launches()
    total = {k: engine_launches.get(k, 0) + trainer_launches.get(k, 0) for k in launches}
    if total != launches:
        raise AssertionError(f"breakdown phase: launches {launches} != the runs' {total}")
    print(f"(phase 22 alone: {time.perf_counter() - t_phase:.1f} s)")
    return launches, engine_launches


# ---------------------------------------------------------------------------
# 23. Trust and forensics: the screens' decide form, the trust layer, the
#     trace's forensics
# ---------------------------------------------------------------------------

DECIDE_REPLACES = {
    "trimmed_mean": "none: src/repro/core/screening.py:489 trimmed_mean_with_decisions "
                    "(jnp, no pallas_call)",
    "median": "none: src/repro/core/screening.py:525 coordinate_median_with_decisions "
              "(jnp, no pallas_call)"}
DECIDE_STRIDES = (1, 16)


def decide_or_raise(tag: str, got, want, plain_y) -> float:
    """A decide kernel's ``(y, trim)`` against its plain twin's, exactly,
    and its y against the plain kernel's; returns the largest |trim|
    difference (0)."""
    exact_or_raise(f"{tag} y", got[0], want[0])
    exact_or_raise(f"{tag} y against the plain kernel", got[0], plain_y)
    exact_or_raise(f"{tag} trim", got[1], want[1])
    return max_abs_err(got[1], want[1])


def decide_ops(counts: np.ndarray, d: int, b, stride: int, median: bool) -> int:
    """The plain screen's operations (`views_bound`) plus the decisions':
    two compares a listed row and decided column."""
    cols = -(-d // stride)
    bb = b if isinstance(b, int) else 0
    tm, med = views_bound(counts, d, bb)[1:]
    return (med if median else tm) + 2 * int(counts.sum()) * cols


def decide_kernel_phase(dev):
    """(a) The decide form of the dense, gather and views screens against
    its plain twins (`ref.*_decide`), exactly, y also against the plain
    kernel: dense M = 50, d = 7850, b = 4 (T and M) and E = 8 cells with a
    mask and a b each; gather M = 512, K = 16; views M = 512, K = 16 and
    dense M = W = 50 (materialized and with a receiver stride of 0);
    strides 1 and 16; edge-case payloads (NaN, +-inf, 1e30, ties, +-0,
    starved nodes: count <= 2b and count 0).  Timed beside the plain kernel,
    the plain sort and the bound; the wide shapes are phase 25's."""
    gen = torch.Generator(device=dev).manual_seed(23)
    records = []
    src = {"dense": "src/repro_torch/kernels/csrc/screen_decide.cu",
           "gather": "src/repro_torch/kernels/csrc/gather_screen_decide.cu",
           "views": "src/repro_torch/kernels/csrc/views_screen_decide.cu"}
    # dense, the main path's shape
    topo = erdos_renyi(M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    w = torch.randn((M, D), generator=gen, device=dev)
    counts = topo.adjacency.sum(axis=1)
    for rule, kern, plain, ykern in (
        ("trimmed_mean", lambda s, a=adj: screen_decide.trimmed_mean_dense_decide(w, a, w, B, s),
         lambda s, a=adj: ref.trimmed_mean_dense_decide(w, a, w, B, s),
         lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, B)),
        ("median", lambda s, a=adj: screen_decide.median_dense_decide(w, a, w, s),
         lambda s, a=adj: ref.median_dense_decide(w, a, w, s),
         lambda: median.median_dense(w, adj, w)),
    ):
        name = f"screen_{rule}_dense_decide"
        err = max(decide_or_raise(f"{name} stride {s}", kern(s), plain(s), ykern())
                  for s in DECIDE_STRIDES)
        nbytes = 2 * M * D * 4 + M * M + 4 * M * M
        rec = record(name, src["dense"], DECIDE_REPLACES[rule], lambda: kern(16),
                     lambda: plain(16), None, nbytes,
                     decide_ops(counts, D, B, 16, rule == "median"), err)
        rec["plain_kernel_ms"] = cuda_ms(ykern)
        print(f"  {name}: plain kernel {rec['plain_kernel_ms']:.4f} ms, decide stride 1 "
              f"{cuda_ms(lambda: kern(1)):.4f} ms")
        records.append(rec)
    # E = 8 cells, a mask (evictions) and a b each
    e = 8
    we = torch.randn((e, M, D), generator=gen, device=dev)
    adj_e = (adj[None] & (torch.rand((e, M, M), generator=gen, device=dev) < 0.8)).contiguous()
    b_e = torch.tensor([1, 2, 3, 4, 4, 3, 2, 1], dtype=torch.int32, device=dev)
    for s in DECIDE_STRIDES:
        decide_or_raise(f"dense trimmed mean decide E = {e} stride {s}",
                        screen_decide.trimmed_mean_dense_decide(we, adj_e, we, b_e, s),
                        ref.trimmed_mean_dense_decide(we, adj_e, we, b_e, s),
                        trimmed_mean.trimmed_mean_dense(we, adj_e, we, b_e))
        decide_or_raise(f"dense median decide E = {e} stride {s}",
                        screen_decide.median_dense_decide(we, adj_e, we, s),
                        ref.median_dense_decide(we, adj_e, we, s),
                        median.median_dense(we, adj_e, we))
    # edge-case payloads, starved nodes; 100 nodes sort in the 128-row
    # bucket (rows re-read), where the plain twin's trimmed mean sums with
    # torch.sum: its y is held to the summation bound, its trim exactly
    for n_e in (40, 100):
        w_np, adj_np, sv_np = edge_case_inputs(n_e, 300, seed=5)
        wx, ax, sx = (torch.as_tensor(x, device=dev) for x in (w_np, adj_np, sv_np))
        for s in (1, 4):
            tag = f"dense trimmed mean decide edge cases n = {n_e} stride {s}"
            got = screen_decide.trimmed_mean_dense_decide(wx, ax, sx, 3, s)
            want = ref.trimmed_mean_dense_decide(wx, ax, sx, 3, s)
            plain_y = trimmed_mean.trimmed_mean_dense(wx, ax, sx, 3)
            if n_e <= 64:
                decide_or_raise(tag, got, want, plain_y)
            else:
                exact_or_raise(f"{tag} y against the plain kernel", got[0], plain_y)
                exact_or_raise(f"{tag} trim", got[1], want[1])
                summation_or_raise(f"{tag} y", got[0], want[0], wx[None], ax.sum(dim=1), sx)
            decide_or_raise(f"dense median decide edge cases n = {n_e} stride {s}",
                            screen_decide.median_dense_decide(wx, ax, sx, s),
                            ref.median_dense_decide(wx, ax, sx, s),
                            median.median_dense(wx, ax, sx))
    # gather: the sparse path's table
    stopo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    table = NeighborTable.from_adjacency(stopo.adjacency, device=dev)
    ws = torch.randn((SM, D), generator=gen, device=dev)
    idx, valid = table.safe_idx, table.valid_dev
    scounts = table.valid.sum(axis=1)
    for rule, kern, plain, ykern in (
        ("trimmed_mean",
         lambda s, v=valid: screen_decide.gather_screen_trimmed_mean_decide(ws, idx, v, ws, SB, s),
         lambda s, v=valid: ref.gather_trimmed_mean_decide(ws, idx, v, ws, SB, s),
         lambda: gather_screen.gather_screen_trimmed_mean(ws, idx, valid, ws, SB)),
        ("median",
         lambda s, v=valid: screen_decide.gather_screen_median_decide(ws, idx, v, ws, s),
         lambda s, v=valid: ref.gather_median_decide(ws, idx, v, ws, s),
         lambda: gather_screen.gather_screen_median(ws, idx, valid, ws)),
    ):
        name = f"gather_screen_{rule}_decide"
        err = max(decide_or_raise(f"{name} stride {s}", kern(s), plain(s), ykern())
                  for s in DECIDE_STRIDES)
        nbytes = 3 * SM * D * 4 + SM * table.k * (4 + 1 + 4)
        rec = record(name, src["gather"], DECIDE_REPLACES[rule], lambda: kern(16),
                     lambda: plain(16), None, nbytes,
                     decide_ops(scounts, D, SB, 16, rule == "median"), err)
        rec["plain_kernel_ms"] = cuda_ms(ykern)
        print(f"  {name}: plain kernel {rec['plain_kernel_ms']:.4f} ms, decide stride 1 "
              f"{cuda_ms(lambda: kern(1)):.4f} ms")
        records.append(rec)
    # gather: per-cell table masks, and edge cases on a table with padded slots
    e = 4
    wg = torch.randn((e, SM, D), generator=gen, device=dev)
    valid_e = (valid[None] & (torch.rand((e, SM, table.k), generator=gen, device=dev) < 0.8))
    valid_e = valid_e.contiguous()
    b_g = torch.tensor([1, 2, 3, 2], dtype=torch.int32, device=dev)
    for s in DECIDE_STRIDES:
        decide_or_raise(f"gather trimmed mean decide E = {e} stride {s}",
                        screen_decide.gather_screen_trimmed_mean_decide(wg, idx, valid_e, wg,
                                                                        b_g, s),
                        ref.gather_trimmed_mean_decide(wg, idx, valid_e, wg, b_g, s),
                        gather_screen.gather_screen_trimmed_mean(wg, idx, valid_e, wg, b_g))
        decide_or_raise(f"gather median decide E = {e} stride {s}",
                        screen_decide.gather_screen_median_decide(wg, idx, valid_e, wg, s),
                        ref.gather_median_decide(wg, idx, valid_e, wg, s),
                        gather_screen.gather_screen_median(wg, idx, valid_e, wg))
    for k in (3, 16, 40, 63):
        w_np, adj_np, sv_np = sparse_case_inputs(k, 300, seed=k)
        tab = NeighborTable.from_adjacency(adj_np, k=k, device=dev)
        wx, sx = torch.as_tensor(w_np, device=dev), torch.as_tensor(sv_np, device=dev)
        for s in (1, 4):
            decide_or_raise(f"gather trimmed mean decide edge cases K = {k} stride {s}",
                            screen_decide.gather_screen_trimmed_mean_decide(
                                wx, tab.safe_idx, tab.valid_dev, sx, 2, s),
                            ref.gather_trimmed_mean_decide(wx, tab.safe_idx, tab.valid_dev, sx, 2,
                                                           s),
                            gather_screen.gather_screen_trimmed_mean(wx, tab.safe_idx,
                                                                     tab.valid_dev, sx, 2))
            decide_or_raise(f"gather median decide edge cases K = {k} stride {s}",
                            screen_decide.gather_screen_median_decide(
                                wx, tab.safe_idx, tab.valid_dev, sx, s),
                            ref.gather_median_decide(wx, tab.safe_idx, tab.valid_dev, sx, s),
                            gather_screen.gather_screen_median(wx, tab.safe_idx, tab.valid_dev,
                                                               sx))
    # views: sparse M = 512, K = 16 (each node's gathered rows), dense M = W = 50
    views_s = ref.gather(ws, idx).contiguous()
    views_d = w[None].expand(M, M, D)  # a broadcast over the receivers, stride 0
    for tag, views, mask, sv, b, cnt in (("sparse", views_s, valid, ws, SB, scounts),
                                         ("dense", views_d.contiguous(), adj, w, B, counts)):
        for rule in ("trimmed_mean", "median"):
            if rule == "trimmed_mean":
                kern = lambda s, v=views, mk=mask, x=sv, bb=b: \
                    screen_decide.views_screen_trimmed_mean_decide(v, mk, x, bb, s)
                plain = lambda s, v=views, mk=mask, x=sv, bb=b: \
                    ref.trimmed_mean_views_decide(v, mk, x, bb, s)
                ykern = lambda v=views, mk=mask, x=sv, bb=b: \
                    views_screen.views_screen_trimmed_mean(v, mk, x, bb)
            else:
                kern = lambda s, v=views, mk=mask, x=sv: \
                    screen_decide.views_screen_median_decide(v, mk, x, s)
                plain = lambda s, v=views, mk=mask, x=sv: ref.median_views_decide(v, mk, x, s)
                ykern = lambda v=views, mk=mask, x=sv: views_screen.views_screen_median(v, mk, x)
            name = f"views_screen_{rule}_decide"
            err = max(decide_or_raise(f"{name} {tag} stride {s}", kern(s), plain(s), ykern())
                      for s in DECIDE_STRIDES)
            if tag == "dense":  # the stride-0 receivers read in place
                decide_or_raise(f"{name} dense stride-0 views", kern(16, views_d), plain(16),
                                ykern())
                continue
            mw = mask.shape[1]
            nbytes = int(cnt.sum()) * D * 4 + 2 * SM * D * 4 + SM * mw * (1 + 4)
            rec = record(name, src["views"], DECIDE_REPLACES[rule], lambda k_=kern: k_(16),
                         lambda p_=plain: p_(16), None, nbytes,
                         decide_ops(cnt, D, b, 16, rule == "median"), err)
            rec["plain_kernel_ms"] = cuda_ms(ykern)
            print(f"  {name} ({tag}): plain kernel {rec['plain_kernel_ms']:.4f} ms, decide "
                  f"stride 1 {cuda_ms(lambda k_=kern: k_(1)):.4f} ms")
            records.append(rec)
    # views: per-cell masks over E cells' views
    e = 4
    ve = torch.randn((e, SM, table.k, D // 8), generator=gen, device=dev)
    me = (valid[None] & (torch.rand((e, SM, table.k), generator=gen, device=dev) < 0.8))
    me = me.contiguous()
    se = torch.randn((e, SM, D // 8), generator=gen, device=dev)
    for s in DECIDE_STRIDES:
        decide_or_raise(f"views trimmed mean decide E = {e} stride {s}",
                        screen_decide.views_screen_trimmed_mean_decide(ve, me, se, b_g, s),
                        ref.trimmed_mean_views_decide(ve, me, se, b_g, s),
                        views_screen.views_screen_trimmed_mean(ve, me, se, b_g))
        decide_or_raise(f"views median decide E = {e} stride {s}",
                        screen_decide.views_screen_median_decide(ve, me, se, s),
                        ref.median_views_decide(ve, me, se, s),
                        views_screen.views_screen_median(ve, me, se))
    # above the register networks: the wide path's decide form, phase 25(a)
    print("decide kernels: every y and trim equal to the plain twins (strides 1 and 16, edge "
          "cases, per-cell masks); library: no PyTorch call computes the decisions")
    return records


# The reference's trust and forensics runs (tools/reference_accuracy.py,
# group trust: trust_bench's smoke sizes, obs_bench's trace_overhead cells
# at M = 512), on a CPU; phase 23 holds the card to them.
REFERENCE_TRUST = {
    "trust breakdown": {
        "static": {"feasible_b": 6,
            "ref": {"final_loss": 0.2471114844083786, "score": 0.996666669845581},
            "adversaries": {"equivocate": {"bstar": 6, "certified_monotone": True, "probes": {
            "1": {"survived": True, "final_loss": 0.2423565536737442, "score": 0.9982142874172756},
            "2": {"survived": True, "final_loss": 0.3583698272705078, "score": 0.989999954517071},
            "3": {"survived": True, "final_loss": 0.2686183750629425, "score": 0.9883332848548889},
            "4": {"survived": True, "final_loss": 0.30991142988204956, "score": 0.9565908908843994},
            "5": {"survived": True, "final_loss": 0.27027639746665955, "score": 0.9584999799728393},
            "6": {"survived": True, "final_loss": 0.21238496899604797, "score": 0.863611082235972},
            }}}},
        "rep_trust": {"feasible_b": 7,
            "ref": {"final_loss": 0.2471114993095398, "score": 0.996666669845581},
            "adversaries": {"equivocate": {"bstar": 7, "certified_monotone": True, "probes": {
            "1": {"survived": True, "final_loss": 0.24950312077999115, "score": 0.9978571449007306},
            "2": {"survived": True, "final_loss": 0.3152696490287781, "score": 0.9865384147717402},
            "3": {"survived": True, "final_loss": 0.2942735552787781, "score": 0.9822916239500046},
            "4": {"survived": True, "final_loss": 0.43668463826179504, "score": 0.9320454434915022},
            "5": {"survived": True, "final_loss": 0.26773467659950256, "score": 0.9444999933242798},
            "6": {"survived": True, "final_loss": 0.23564580082893372, "score": 0.8477777507570055},
            "7": {"survived": True, "final_loss": 0.3887954354286194, "score": 0.8637499660253525},
            }}}},
    },
    "trust detection": {
        "equivocate": {
            "edges_evicted": 22, "echo_mismatch_total": 110.0, "max_suspicion": 1.0,
            "byz_edges": 20, "honest_edges": 100, "byz_evicted": 20, "honest_evicted": 0,
            "honest_eviction_rate": 0.0, "byz_eviction_rate": 1.0, "auc_byzantine_edges": 1.0},
        "slander": {
            "edges_evicted": 22, "echo_mismatch_total": 110.0, "max_suspicion": 1.0,
            "byz_edges": 20, "honest_edges": 100, "byz_evicted": 0, "honest_evicted": 0,
            "honest_eviction_rate": 0.0, "byz_eviction_rate": 0.0, "auc_byzantine_edges": 1.0},
    },
    "trust inertness": {"bit_identical": True},
    "obs trace stress": {"bit_identical": True, "auc_byzantine_edges": 0.9727895341207349,
        "k": 16, "dim": 64, "survival": {
            "byz_edges_seen": 479.0,
            "byz_trim_freq": 0.649008350730689,
            "honest_edges_seen": 122072.0,
            "honest_trim_freq": 0.3329930287043712,
        }},
    "obs trace paper": {"bit_identical": True, "auc_byzantine_edges": 1.0,
        "k": 16, "dim": 7850, "survival": {
            "byz_edges_seen": 71.0,
            "byz_trim_freq": 0.8170448088310134,
            "honest_edges_seen": 18037.0,
            "honest_trim_freq": 0.3374168538542302,
        }},
}
# AUC and trim-frequency tolerance of the obs cells: their trajectories are
# the reference's within the crafted rows' ulps, not bit for bit (on an
# H100 the stress cell's AUC and survival read the reference's exactly, the
# paper cell's survival within 5.4e-08)
OBS_TOL = 1e-5
TRUST_TICKS, DETECT_TICKS, INERT_TICKS = 64, 16, 12
STRESS_TICKS, PAPER_TICKS, FORENSIC_TICKS, REP_TICKS = 20, 3, 20, 8
QUAD_DIM = 64  # the trust and obs benchmarks' synthetic quadratic


def quad_task(m: int, dev, seed: int = 0):
    """The trust and obs benchmarks' d = 64 quadratic (``0.5 |w - c|^2``,
    targets ``default_rng(seed).normal((M, 64))``, replicas from ``PRNGKey``
    perturbed by 0.1): ``(grad_fn, init_fn, targets)``."""
    targets = torch.as_tensor(np.random.default_rng(seed).normal(size=(m, QUAD_DIM))
                              .astype(np.float32), device=dev)

    def grad_fn(params, batch):
        w = params["w"]
        return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}

    def init_fn(s):
        return replicate({"w": torch.zeros(QUAD_DIM, device=dev)}, m, perturb=0.1,
                         key=prng.PRNGKey(s))

    return grad_fn, init_fn, targets


def trust_breakdown_runs(dev) -> None:
    """(b) trust_bench's breakdown study: static BRIDGE-T against
    ``rep_trimmed_mean`` with the trust layer, ``equivocate`` through
    ``ideal`` on the complete graph, held to the reference's certificate."""
    from repro_torch.core.graph import complete_graph
    from repro_torch.trust import TrustSpec

    m, b_max, drop = 15, 7, 0.15
    task = linear_task(m, TRUST_TICKS, partition="moderate", num_train=2000, num_test=400, seed=0,
                       device=dev)
    cfg = BreakdownConfig(mode="ladder", seeds=(0,), b_max=b_max, loss_ratio=LOSS_RATIO,
                          score_drop=drop)
    stars_of = {}
    for arm, rule, spec in (("static", "trimmed_mean", None),
                            ("rep_trust", "rep_trimmed_mean", TrustSpec(warmup=4))):
        before = read_launches()
        t0 = time.perf_counter()
        bd = BreakdownEngine(complete_graph(m, b_max), (rule,), ("equivocate",), task.grad_fn,
                             task.init_fn, task.batches, lam=1.0, t0=30.0, config=cfg,
                             eval_fn=task.eval_accuracy, scenario="ideal", trust=spec, device=dev)
        res = bd.run()
        wall = time.perf_counter() - t0
        check_grew(f"trust breakdown {arm}", before, round_want(bd, TRUST_TICKS, net=True))
        moved, loss_worst = hold_certificate(f"trust breakdown {arm}", res,
                                             {rule: REFERENCE_TRUST["trust breakdown"][arm]},
                                             score_drop=drop)
        arec = res["rules"][rule]["adversaries"]["equivocate"]
        stars_of[arm] = arec["bstar"]
        print(f"trust breakdown {arm} ({rule}{', trust' if spec else ''}): b* {arec['bstar']} "
              f"(feasible {res['rules'][rule]['feasible_b']}; the reference's "
              f"{REFERENCE_TRUST['trust breakdown'][arm]['adversaries']['equivocate']['bstar']}),"
              f" {res['meta']['cells_run']} cells, {wall:.2f} s; scores "
              + ", ".join(f"b={b} {p['score']:.4f}" for b, p in arec["probes"].items())
              + f"; final losses within {loss_worst:.3g} of the reference's"
              + (f"; verdicts at the threshold that moved: {moved}" if moved else ""))
    if not stars_of["rep_trust"] > stars_of["static"]:
        raise AssertionError(f"trust breakdown: detect-and-expel b* {stars_of['rep_trust']} does "
                             f"not beat the static {stars_of['static']}")
    print(f"trust breakdown: detect_and_expel_beats_static True ({stars_of['rep_trust']} > "
          f"{stars_of['static']})")


def trust_detection_runs(dev) -> None:
    """(b) trust_bench's detection cells: one net grid (``ideal``, the
    complete graph, ``rep_trimmed_mean``), ``equivocate`` evicted and
    ``slander`` evicting nothing, each summary the reference's."""
    from repro_torch.core.graph import complete_graph
    from repro_torch.trust import TrustSpec
    from repro_torch.trust import summarize as trust_summary

    m, b = 12, 2
    grad_fn, init_fn, targets = quad_task(m, dev)
    spec = TrustSpec(warmup=4)
    grid = ExperimentGrid(complete_graph(m, b), ("rep_trimmed_mean",), ("none",), (b,), (0,),
                          scenarios=("ideal",), adversaries=("equivocate", "slander"),
                          lam=1.0, t0=30.0)
    before = read_launches()
    engine = GridEngine(grid, grad_fn, num_ticks=DETECT_TICKS, trust=spec, device=dev)
    t0 = time.perf_counter()
    final, _ = engine.run(engine.init(init_fn), targets[None].expand(DETECT_TICKS, m, QUAD_DIM))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_grew("trust detection", before, net_grid_want(engine, DETECT_TICKS))
    senders = engine.sender_grid()
    want = REFERENCE_TRUST["trust detection"]
    for i, cell in enumerate(engine.cells):
        rec = trust_summary(spec, type(final.trust)(*(x[i] for x in final.trust)),
                            byz_mask=engine.byz_masks[i], senders=senders)
        rec.pop("spec")
        ref_rec = want[cell.adversary]
        exact = {k: v for k, v in rec.items() if k != "max_suspicion"}
        if exact != {k: v for k, v in ref_rec.items() if k != "max_suspicion"} or not math.isclose(
                rec["max_suspicion"], ref_rec["max_suspicion"], rel_tol=1e-5):
            raise AssertionError(f"trust detection {cell.adversary}: {rec} != the reference's "
                                 f"{ref_rec}")
        print(f"trust detection {cell.adversary}: evicted {rec['edges_evicted']}, byz rate "
              f"{rec['byz_eviction_rate']:.2f}, honest evicted {rec['honest_evicted']}, AUC "
              f"{rec['auc_byzantine_edges']}: the reference's")
    eq, sl = (want[a] for a in ("equivocate", "slander"))
    acc = {"equivocators_detected": eq["byz_eviction_rate"] >= 0.8
           and (eq["auc_byzantine_edges"] or 0.0) >= 0.9,
           "honest_eviction_rate_zero": eq["honest_evicted"] == 0 and sl["honest_evicted"] == 0,
           "slander_evicts_nothing": sl["honest_evicted"] == 0 and sl["byz_evicted"] == 0}
    if not all(acc.values()):
        raise AssertionError(f"trust detection: {acc}")
    print(f"trust detection: {acc}, {wall:.2f} s for {DETECT_TICKS} ticks")


def steady_run(trainer, state, batches, reps: int = 2):
    """(min wall over ``reps`` runs after a first, final state) of
    ``run_scan`` from ``state``, each run ending in a synchronize."""
    walls = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        fin, _ = trainer.run_scan(state, batches)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
    return min(walls), fin


def trust_inertness_run(dev) -> dict:
    """(b) trust_bench's inertness cell: a dense async cell (M = 32, the
    complete graph, BRIDGE-T, ``alie``, drop 0.05) trust off against trust
    on but inert (warmup past the horizon): bit for bit, and the wall of
    each (the echo and the reputation's cost)."""
    from repro_torch.core.graph import complete_graph
    from repro_torch.trust import TrustSpec

    m = 32
    grad_fn, init_fn, targets = quad_task(m, dev)
    batches = targets[None].expand(INERT_TICKS, m, QUAD_DIM).contiguous()
    out = {}
    for tag, spec in (("off", None), ("on", TrustSpec(warmup=INERT_TICKS + 1))):
        cfg = AsyncBridgeConfig(topology=complete_graph(m, 2), rule="trimmed_mean",
                                num_byzantine=2, attack="alie",
                                channel=ChannelConfig(drop_prob=0.05), staleness_bound=2,
                                lam=1.0, t0=100.0, trust=spec)
        tr = AsyncBridgeTrainer(cfg, grad_fn, device=dev)
        out[tag] = steady_run(tr, tr.init(init_fn(0), seed=0), batches)
        # where the tick's time goes: 13 ticks, profiled
        profile_trainer(f"trust inertness {tag}", tr, tr.init(init_fn(0), seed=0),
                        lambda i: targets)
    if not bit_equal(out["off"][1].params["w"], out["on"][1].params["w"]):
        raise AssertionError("trust inertness: trust on but inert moved the trajectory")
    off, on = out["off"][0], out["on"][0]
    ref_inert = REFERENCE_TRUST["trust inertness"]["bit_identical"]
    print(f"trust inertness (M = {m}, {INERT_TICKS} ticks): bit_identical True (the reference: "
          f"{ref_inert}); off {off / INERT_TICKS * 1e3:.3f} ms/tick, on "
          f"{on / INERT_TICKS * 1e3:.3f} ms/tick ({on / off - 1.0:+.1%})")
    return {"views_screen_trimmed_mean": 3 * INERT_TICKS + 13,
            "views_screen_trimmed_mean_decide": 3 * INERT_TICKS + 13}


def obs_cell(dev, paper: bool):
    """obs_bench's sparse cell (`_build`): ``(task pieces, config kw)``."""
    if paper:
        task = net_task(SM, dev, num_train=max(2000, 32 * SM), num_test=200, batch=8)
        return task.grad_fn, task.init_fn, task.batch_fn
    grad_fn, init_fn, targets = quad_task(SM, dev)
    return grad_fn, init_fn, lambda i: targets


def obs_trace_runs(dev) -> dict:
    """(c) obs_bench's ``trace_overhead`` cells through the sparse runtime
    (``small_world(512, 6, 2)``, BRIDGE-T, ``alie``, drop 0.05): traced
    against untraced, bit for bit; AUC and survival against the
    reference's; ms/tick of each and the overhead.  Then the stress cell
    under BRIDGE-M, traced against untraced (the views median's decide
    form)."""
    from repro_torch.obs import TraceSpec
    from repro_torch.obs import trace as obs_trace

    topo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    want: dict[str, int] = {}
    for name, ticks, stride, rule in (("stress", STRESS_TICKS, 4, "trimmed_mean"),
                                      ("paper", PAPER_TICKS, 16, "trimmed_mean"),
                                      ("stress", STRESS_TICKS, 4, "median")):
        grad_fn, init_fn, batch_fn = obs_cell(dev, name == "paper")
        batches = stack_batches(batch_fn, ticks, device=dev)
        spec = TraceSpec(decide_stride=stride)
        runs = {}
        for tag, trace in (("untraced", None), ("traced", spec)):
            cfg = AsyncBridgeConfig(topology=topo, rule=rule, num_byzantine=SB, attack="alie",
                                    channel=ChannelConfig(drop_prob=0.05), staleness_bound=2,
                                    lam=1.0, t0=100.0, sparse=True, trace=trace)
            tr = AsyncBridgeTrainer(cfg, grad_fn, device=dev)
            runs[tag] = steady_run(tr, tr.init(init_fn(0), seed=0), batches), tr
        (off, fin_off), tr_off = runs["untraced"]
        (on, fin_on), tr = runs["traced"]
        if name == "paper":  # where the stage's time goes: 13 ticks each, profiled
            step_of = lambda i: tuple(x[i % ticks] for x in batches)  # noqa: E731
            for tag, trainer in (("untraced", tr_off), ("traced", tr)):
                profile_trainer(f"obs trace paper {tag}", trainer,
                                trainer.init(init_fn(0), seed=0), step_of)
            kern = VIEWS_OF[rule]
            for k in (kern, f"{kern}_decide"):
                want[k] = want.get(k, 0) + 13
        for k in fin_off.params:
            if not bit_equal(fin_off.params[k], fin_on.params[k]):
                raise AssertionError(f"obs trace {name} {rule}: the traced run moved the "
                                     f"trajectory")
        kern = VIEWS_OF[rule]
        for k, n in ((kern, 3 * ticks), (f"{kern}_decide", 3 * ticks)):
            want[k] = want.get(k, 0) + n
        summary = obs_trace.summarize(spec, fin_on.obs, byz_mask=tr.byz_mask.cpu().numpy(),
                                      senders=obs_trace.sender_grid(SM, neighbors=tr.runtime
                                                                    .neighbors))
        line = (f"obs trace {name} {rule} (M = {SM}, K = {tr.runtime.neighbors.k}, {ticks} "
                f"ticks, stride {stride}): bit_identical True, untraced "
                f"{off / ticks * 1e3:.3f} ms/tick, traced {on / ticks * 1e3:.3f} ms/tick "
                f"({on / off - 1.0:+.1%}), AUC {summary['auc_byzantine_edges']}, survival "
                f"{summary['survival']}")
        if rule == "trimmed_mean":
            ref_rec = REFERENCE_TRUST[f"obs trace {name}"]
            auc_err = abs(summary["auc_byzantine_edges"] - ref_rec["auc_byzantine_edges"])
            surv_err = max(abs(summary["survival"][k] - v)
                           for k, v in ref_rec["survival"].items())
            seen = {k: summary["survival"][k] for k in ("byz_edges_seen", "honest_edges_seen")}
            if seen != {k: ref_rec["survival"][k] for k in seen} or auc_err > OBS_TOL or \
                    surv_err > OBS_TOL:
                raise AssertionError(f"obs trace {name}: AUC / survival beyond {OBS_TOL} of the "
                                     f"reference's {ref_rec} ({summary})")
            line += (f"; the reference's: AUC {ref_rec['auc_byzantine_edges']}, edges seen "
                     f"equal, trim frequencies within {surv_err:.3g}")
        print(line)
    return want


def forensic_trainer_runs(dev) -> dict:
    """(d) The trace's forensics on the synchronous main path at d = 7850:
    BRIDGE-T and BRIDGE-M, dense (M = 50, random, b = 4: the dense decide
    kernels) and sparse (``small_world(512, 6, 2)``, b = 2: the gather
    decide kernels), traced (stride 16) against untraced over
    `FORENSIC_TICKS` ticks, bit for bit."""
    from repro_torch.obs import TraceSpec

    want: dict[str, int] = {}
    for path, m, b, batch, topo in (
            ("dense", M, B, 32, erdos_renyi(M, 0.5, B, seed=0)),
            ("sparse", SM, SB, 8, small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0))):
        task = linear_task(m, FORENSIC_TICKS, partition="iid",
                           num_train=6000 if path == "dense" else 16384, num_test=1000,
                           batch=batch, seed=0, device=dev)
        for rule in ("trimmed_mean", "median"):
            finals, times = [], []
            for trace in (None, TraceSpec(decide_stride=16)):
                tr = BridgeTrainer(BridgeConfig(topology=topo, rule=rule, num_byzantine=b,
                                                attack="random", lam=1.0, t0=30.0,
                                                sparse=path == "sparse", trace=trace),
                                   task.grad_fn, device=dev)
                st = tr.init(task.init_fn(0), seed=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(FORENSIC_TICKS):
                    st, _ = tr.step(st, tuple(x[i] for x in task.batches))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / FORENSIC_TICKS * 1e3)
                finals.append(st)
            for k in finals[0].params:
                if not bit_equal(finals[0].params[k], finals[1].params[k]):
                    raise AssertionError(f"forensic trainer {path} {rule}: traced != untraced")
            kern = {"dense": {"trimmed_mean": "screen_trimmed_mean_dense",
                              "median": "screen_median_dense"},
                    "sparse": {"trimmed_mean": "gather_screen_trimmed_mean",
                               "median": "gather_screen_median"}}[path][rule]
            for k in (kern, f"{kern}_decide"):
                want[k] = want.get(k, 0) + FORENSIC_TICKS
            obs = finals[1].obs
            freq = float(obs.byz_trim / torch.clamp(obs.byz_seen, min=1.0))
            hon = float(obs.hon_trim / torch.clamp(obs.hon_seen, min=1.0))
            print(f"forensic trainer {path} {rule} (d = {D}, stride 16): traced == untraced bit "
                  f"for bit; {times[0]:.3f} -> {times[1]:.3f} ms/tick; byz trim freq "
                  f"{freq:.4f}, honest {hon:.4f}")
    return want


class PlainDecide:
    """Within it, the median's decide entries (`kernels.ops`) run their
    plain twins, no kernel: the yardstick of `rep_median_trust_runs`."""

    TWINS = {"median_decide": ref.median_dense_decide,
             "gather_median_decide": ref.gather_median_decide,
             "views_median_decide": ref.median_views_decide}

    def __enter__(self):
        self.saved = {name: getattr(ops, name) for name in self.TWINS}
        for name, fn in self.TWINS.items():
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(ops, name, fn)


def rep_median_trust_runs(dev) -> dict:
    """(e) ``rep_median`` with the trust layer (warmup 2) on its three
    layouts: dense (M = 50, random, b = 4) and sparse (``small_world(512,
    6, 2)``) synchronous on the linear task, and the dense runtime with
    the echo (M = 32, the complete graph, ``alie``, drop 0.05) on the d =
    64 quadratic.  Its trim comes from the median decide kernel of the
    layout (one launch a tick, no other kernel); the trust state and the
    parameters must equal, bit for bit, the same run's under
    `PlainDecide`."""
    from repro_torch.core.graph import complete_graph
    from repro_torch.trust import TrustSpec

    spec = TrustSpec(warmup=2)
    runs = []
    for path, m, b, batch, topo in (
            ("dense", M, B, 32, erdos_renyi(M, 0.5, B, seed=0)),
            ("sparse", SM, SB, 8, small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0))):
        task = linear_task(m, REP_TICKS, partition="iid",
                           num_train=6000 if path == "dense" else 16384, num_test=1000,
                           batch=batch, seed=0, device=dev)
        cfg = BridgeConfig(topology=topo, rule="rep_median", num_byzantine=b, attack="random",
                           lam=1.0, t0=30.0, sparse=path == "sparse", trust=spec)
        runs.append((f"{path} synchronous", "screen_median_dense_decide" if path == "dense"
                     else "gather_screen_median_decide",
                     lambda cfg=cfg, task=task: BridgeTrainer(cfg, task.grad_fn, device=dev),
                     task.init_fn, lambda i, task=task: tuple(x[i] for x in task.batches)))
    grad_fn, init_fn, targets = quad_task(32, dev)
    rcfg = AsyncBridgeConfig(topology=complete_graph(32, 2), rule="rep_median", num_byzantine=2,
                             attack="alie", channel=ChannelConfig(drop_prob=0.05),
                             staleness_bound=2, lam=1.0, t0=100.0, trust=spec)
    runs.append(("dense runtime with the echo", "views_screen_median_decide",
                 lambda: AsyncBridgeTrainer(rcfg, grad_fn, device=dev), init_fn,
                 lambda i: targets))
    want: dict[str, int] = {}
    for tag, kern, make, init, batch_of in runs:
        saved = read_launches()  # two warm-up ticks each way, not counted
        for plain in (False, True):
            tr = make()
            st = tr.init(init(0), seed=1)
            with PlainDecide() if plain else contextlib.nullcontext():
                for i in range(2):
                    st, _ = tr.step(st, batch_of(i))
        torch.cuda.synchronize()
        set_launches(saved)
        finals, ms = [], []
        for plain in (False, True):
            tr = make()
            st = tr.init(init(0), seed=1)
            torch.cuda.synchronize()
            before = read_launches()
            t0 = time.perf_counter()
            with PlainDecide() if plain else contextlib.nullcontext():
                for i in range(REP_TICKS):
                    st, _ = tr.step(st, batch_of(i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / REP_TICKS * 1e3)
            grown = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
            if grown != ({} if plain else {kern: REP_TICKS}):
                raise AssertionError(f"rep_median trust {tag} ({'twins' if plain else 'kernels'}"
                                     f"): launches {grown}")
            finals.append(st)
        got, yard = finals
        for name, x, y in (*zip(got.trust._fields, got.trust, yard.trust),
                           *((k, got.params[k], yard.params[k]) for k in got.params)):
            if not (bit_equal(x, y) if x.is_floating_point() else torch.equal(x, y)):
                raise AssertionError(f"rep_median trust {tag}: {name} differs from the plain "
                                     f"twins' run")
        want[kern] = want.get(kern, 0) + REP_TICKS
        print(f"rep_median trust {tag} ({REP_TICKS} ticks): {kern} {REP_TICKS} launches; trust "
              f"state and parameters equal to the plain twins' run bit for bit (max suspicion "
              f"{float(got.trust.suspicion.max()):.4f}, {int(got.trust.evicted.sum())} edges "
              f"evicted); {ms[0]:.3f} ms/tick, the plain twins {ms[1]:.3f} (after two "
              f"warm-up ticks each)")
    return want


def trust_phase(dev):
    """Phase 23 (the module docstring's list): the decide kernels' records,
    then the main-path runs, each held to its exact launches; returns the
    records and the phase's launches."""
    t_phase = time.perf_counter()
    records = decide_kernel_phase(dev)
    zero_launches()
    want: dict[str, int] = {}
    before = read_launches()
    trust_breakdown_runs(dev)
    trust_detection_runs(dev)
    grown = {k: v - before[k] for k, v in read_launches().items() if v != before[k]}
    for part in (grown, trust_inertness_run(dev), obs_trace_runs(dev),
                 forensic_trainer_runs(dev), rep_median_trust_runs(dev)):
        for k, n in part.items():
            want[k] = want.get(k, 0) + n
    launches = read_launches()
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"phase 23: launches {launches} != the runs' {want}")
    print(f"(phase 23 alone: {time.perf_counter() - t_phase:.1f} s)")
    return records, launches


# ---------------------------------------------------------------------------
# 24. Live metric rings, run manifests, the obs CLIs and streaming
# ---------------------------------------------------------------------------

METRICS_CELLS = ((4, 2), (40, 20))  # obs_bench's metrics_overhead cell (ticks, capacity); longer
METRICS_REPS = 3  # runs each of metrics off and on, in turn
METRICS_BUDGET = 0.10  # the reference's acceptance bound on the paper cell
STREAM_TICKS = 20
STREAM_CHUNK = 1024
SPARSE_STREAM_CHUNK = 2048
FORENSIC_STREAM_TICKS = 5
DECIDE_STRIDES = (1, 16)
# grid_bench's grid through the sweep (tools/reference_accuracy.py's SWEEP_OBS_ARGS)
SWEEP_OBS_RULES = ("trimmed_mean", "median")
SWEEP_OBS_ATTACKS = ("random", "alie", "sign_flip")
SWEEP_OBS_TICKS = 30
SWEEP_OBS_ARGS = ["--mode", "grid", "--rules", ",".join(SWEEP_OBS_RULES), "--attacks",
                  ",".join(SWEEP_OBS_ATTACKS), "--byz", "2", "--seeds", "0,1,2,3,4,5,6,7",
                  "--grid-nodes", "12", "--grid-ticks", str(SWEEP_OBS_TICKS), "--grid-train",
                  "4000", "--grid-test", "800"]
# each cell's AUC in obs_summary.json after the reference's sweep at
# SWEEP_OBS_ARGS (tools/reference_accuracy.py --only sweep_obs, JAX on the CPU)
_AUC_ALIE = {"trimmed_mean": (0.9888888888888889, 0.9501466275659824, 0.946949602122016,
                              0.9389920424403183, 0.9777777777777777, 0.9888888888888889,
                              0.8571428571428571, 0.9738095238095238),
             "median": (0.8583333333333333, 1.0, 1.0, 1.0, 1.0, 0.8583333333333333,
                        0.9030612244897959, 0.8809523809523809)}
REFERENCE_SWEEP_OBS = {
    f"{rule}_{attack}_b2_s{s}" + ("" if s == 0 else f"_m{s}"):
        (_AUC_ALIE[rule][s] if attack == "alie" else 1.0)
    for rule in ("trimmed_mean", "median") for attack in ("random", "alie", "sign_flip")
    for s in range(8)}


def one_leaf(task):
    """The paper model as one ``[M, 7850]`` leaf ``theta`` (``[b | w]``,
    stack_flatten's order): ``(grad_fn, init_fn)`` over it."""
    def grad_fn(params, batch):
        th = params["theta"]
        lead = th.shape[:-1]
        losses, g = task.grad_fn({"b": th[..., :10], "w": th[..., 10:].reshape(*lead, 784, 10)},
                                 batch)
        return losses, {"theta": torch.cat([g["b"], g["w"].reshape(*lead, -1)], dim=-1)}

    return grad_fn, lambda seed: {"theta": stack_flatten(task.init_fn(seed))[0]}


def stream_run(trainer, params, batch_fn, ticks):
    """``ticks`` steps from ``params``; (final state, ms a tick on the host
    clock, ending in a synchronize; Python's collector run before the
    clock starts)."""
    state = trainer.init(params, seed=1)
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ticks):
        state, _ = trainer.step(state, batch_fn(i))
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / ticks * 1e3


def block_kernel_checks(dev) -> None:
    """Every screen and its decide form (strides 1 and 16) at the stream's
    block widths, on the blocks of the models' parameters (a strided column
    slice copied contiguous, as the stream does), exact against its plain
    version; the copy's device time beside the screen's.  Then the honest
    mean's node sum (`byzantine.node_sum`, one cumsum launch on the card)
    against the loop that adds the rows one after another."""
    topo = erdos_renyi(M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    task = linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32, device=dev)
    p = task.init_fn(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    w2d = p["w"].reshape(M, -1) + 0.01 * torch.randn((M, 7840), generator=gen, device=dev)
    b2d = p["b"] + 0.01 * torch.randn((M, 10), generator=gen, device=dev)
    blocks = {1024: w2d[:, :1024], 672: w2d[:, 7168:], 10: b2d}
    lines = []
    for width, blk in blocks.items():
        x = blk.contiguous()
        for name, kern, plain in (
                ("trimmed_mean", lambda v: trimmed_mean.trimmed_mean_dense(v, adj, v, B),
                 lambda v: ref.trimmed_mean_dense(v, adj, v, B)),
                ("median", lambda v: median.median_dense(v, adj, v),
                 lambda v: ref.median_dense(v, adj, v)),
                *((f"trimmed_mean decide {s_}",
                   lambda v, s_=s_: screen_decide.trimmed_mean_dense_decide(v, adj, v, B, s_),
                   lambda v, s_=s_: ref.trimmed_mean_dense_decide(v, adj, v, B, s_))
                  for s_ in DECIDE_STRIDES),
                *((f"median decide {s_}",
                   lambda v, s_=s_: screen_decide.median_dense_decide(v, adj, v, s_),
                   lambda v, s_=s_: ref.median_dense_decide(v, adj, v, s_))
                  for s_ in DECIDE_STRIDES)):
            got, want = kern(x), plain(x)
            for g_, w_ in zip(got if isinstance(got, tuple) else (got,),
                              want if isinstance(want, tuple) else (want,), strict=True):
                exact_or_raise(f"stream block dense {name} width {width}", g_, w_)
        copy_ms = cuda_ms(lambda b_=blk: b_.contiguous())
        screen_ms = cuda_ms(lambda v=x: trimmed_mean.trimmed_mean_dense(v, adj, v, B))
        lines.append(f"{width}: copy {copy_ms:.4f} ms, screen {screen_ms:.4f} ms")
    print(f"stream blocks dense M = {M} (T, M and their decide forms at strides "
          f"{DECIDE_STRIDES} exact at every width): "
          + "; ".join(lines))
    # sparse: the gather tile kernel under every candidate plan
    table = NeighborTable.from_adjacency(small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0),
                                         device=dev)
    wsp = torch.randn((SM, 7840), generator=gen, device=dev)
    bsp = torch.randn((SM, 10), generator=gen, device=dev)
    lines = []
    for width, blk in ((2048, wsp[:, :2048]), (1696, wsp[:, 6144:]), (10, bsp)):
        x = blk.contiguous()
        for median_, kern, plain in (
                (False, gather_screen.gather_screen_trimmed_mean,
                 lambda v: ref.gather_trimmed_mean(v, table.safe_idx, table.valid_dev, v, SB)),
                (True, gather_screen.gather_screen_median,
                 lambda v: ref.gather_median(v, table.safe_idx, table.valid_dev, v))):
            b_ = () if median_ else (SB,)
            want = plain(x)
            exact_or_raise(f"stream block gather width {width}",
                           kern(x, table.safe_idx, table.valid_dev, x, *b_), want)
            plans = gather_screen.candidates(SM, table.k, width, 4, median_)
            for plan in plans:
                got = gather_screen.launch_tile(kern.__name__, plan, (x,), table.safe_idx,
                                                table.valid_dev, x, *b_)
                exact_or_raise(f"stream block gather width {width} {plan}", got, want)
            for s_ in DECIDE_STRIDES:
                if median_:
                    got = screen_decide.gather_screen_median_decide(
                        x, table.safe_idx, table.valid_dev, x, s_)
                    want_d = ref.gather_median_decide(x, table.safe_idx, table.valid_dev, x, s_)
                else:
                    got = screen_decide.gather_screen_trimmed_mean_decide(
                        x, table.safe_idx, table.valid_dev, x, SB, s_)
                    want_d = ref.gather_trimmed_mean_decide(x, table.safe_idx, table.valid_dev,
                                                            x, SB, s_)
                for g_, w_ in zip(got, want_d, strict=True):
                    exact_or_raise(f"stream block gather decide {s_} width {width}", g_, w_)
        copy_ms = cuda_ms(lambda b_=blk: b_.contiguous())
        screen_ms = cuda_ms(lambda v=x: gather_screen.gather_screen_trimmed_mean(
            v, table.safe_idx, table.valid_dev, v, SB))
        lines.append(f"{width}: {len(plans)} plans, copy {copy_ms:.4f} ms, screen "
                     f"{screen_ms:.4f} ms")
    print(f"stream blocks gather M = {SM}, K = {table.k} (T and M exact under every candidate "
          f"plan, their decide forms at strides {DECIDE_STRIDES}): " + "; ".join(lines))
    # the network path's views: a per-leaf mailbox read in place at each block
    slots = 24
    mb_vals = torch.randn((M, slots, 7840), generator=gen, device=dev)
    mask = torch.rand((M, slots), generator=gen, device=dev) < 0.8
    for width, lo in ((1024, 0), (672, 7168), (10, 100)):
        views = mb_vals[..., lo:lo + width]
        sv = torch.randn((M, width), generator=gen, device=dev)
        exact_or_raise(f"stream block views trimmed_mean width {width}",
                       views_screen.views_screen_trimmed_mean(views, mask, sv, B),
                       ref.trimmed_mean_views(views, mask, sv, B))
        exact_or_raise(f"stream block views median width {width}",
                       views_screen.views_screen_median(views, mask, sv),
                       ref.median_views(views, mask, sv))
        for s_ in DECIDE_STRIDES:
            for name, got, want in (
                    ("trimmed_mean", screen_decide.views_screen_trimmed_mean_decide(
                        views, mask, sv, B, s_), ref.trimmed_mean_views_decide(
                        views, mask, sv, B, s_)),
                    ("median", screen_decide.views_screen_median_decide(views, mask, sv, s_),
                     ref.median_views_decide(views, mask, sv, s_))):
                for g_, w_ in zip(got, want, strict=True):
                    exact_or_raise(f"stream block views {name} decide {s_} width {width}", g_,
                                   w_)
    print(f"stream blocks views M = {M}, W = {slots} (strided mailbox blocks, read in "
          f"place): T, M and their decide forms at strides {DECIDE_STRIDES} exact at widths "
          f"1024, 672, 10")
    # the honest mean's node sum: one order at every width, on the card too
    for shape in ((M, 7850), (SM, 7850), (4, 12, 7850)):
        x = torch.randn(shape, generator=gen, device=dev)
        loop = torch.zeros_like(x[..., 0, :])
        for i in range(shape[-2]):
            loop = loop + x[..., i, :]
        whole = byzantine.node_sum(x)
        exact_or_raise(f"node_sum {shape}", whole, loop)
        for lo, width in ((10, 1024), (7178, 672), (0, 10)):
            exact_or_raise(f"node_sum {shape} block {lo}:{lo + width}",
                           byzantine.node_sum(x[..., lo:lo + width].contiguous()),
                           whole[..., lo:lo + width])
    print("node_sum (cumsum over the node axis) bit for bit the row-by-row loop at M = 50, "
          "512 and [4, 12], whole and at block widths 1024, 672, 10")


def metrics_overhead_runs(dev) -> dict:
    """(a) obs_bench's ``metrics_overhead`` paper cell through
    ``run_chunks``: metrics off and on run in turn (off, on, on, off, ...)
    ``METRICS_REPS`` times each after a warm run, the median and the range
    of ms/tick each, then one profiled run of each whose difference names
    the ops that the metered tick adds; returns the launches of its runs."""
    from repro_torch.obs import (AlertRules, EventLog, MetricSpec, MetricWriter, perfetto,
                                 read_manifest, read_metrics, write_manifest)
    from repro_torch.obs import monitor as obs_monitor

    topo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    grad_fn, init_fn, batch_fn = obs_cell(dev, paper=True)
    want = {"views_screen_trimmed_mean": 0}
    for ticks, capacity in METRICS_CELLS:
        batches = stack_batches(batch_fn, ticks, device=dev)
        batch_at = lambda i, b_=batches: tuple(x[i] for x in b_)  # noqa: E731
        with tempfile.TemporaryDirectory() as live:
            write_manifest(live, kind="obs-bench-live",
                           config={"num_nodes": SM, "ticks": ticks, "capacity": capacity})
            events = EventLog(os.path.join(live, "events.jsonl"))
            writer = MetricWriter(os.path.join(live, "metrics.jsonl"), alerts=AlertRules(),
                                  events=events)
            runners = {}
            for tag, spec in (("off", None), ("on", MetricSpec(capacity=capacity))):
                cfg = AsyncBridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=SB,
                                        attack="alie", channel=ChannelConfig(drop_prob=0.05),
                                        staleness_bound=2, lam=1.0, t0=100.0, sparse=True,
                                        metrics=spec)
                tr = AsyncBridgeTrainer(cfg, grad_fn, device=dev)
                io_ = dict(writer=writer, events=events) if spec is not None else {}
                runners[tag] = (tr, tr.init(init_fn(0), seed=0), io_)

            def run(tag):
                tr, st0, io_ = runners[tag]
                gc.collect()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fin, _ = tr.run_chunks(st0, batch_at, ticks, **io_)
                torch.cuda.synchronize()
                want["views_screen_trimmed_mean"] += ticks
                return fin, (time.perf_counter() - t0) / ticks * 1e3

            finals = {tag: run(tag)[0] for tag in runners}  # warm
            ms = {"off": [], "on": []}
            for rep in range(METRICS_REPS):
                for tag in (("off", "on") if rep % 2 == 0 else ("on", "off")):
                    ms[tag].append(run(tag)[1])
            profiles = {}
            for tag in runners:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA]) as pr:
                    run(tag)
                profiles[tag] = list(pr.key_averages())
            writer.close()
            events.close()
            write_manifest(live, extra={"ended": True})
            rows = read_metrics(os.path.join(live, "metrics.jsonl"))
            if [r["tick"] for r in rows] != list(range(ticks)):
                raise AssertionError(f"metrics {ticks} ticks: rows {[r['tick'] for r in rows]}")
            trace_bytes = os.path.getsize(perfetto.export(live))
            snap_out = io.StringIO()
            with contextlib.redirect_stdout(snap_out):
                obs_monitor.main([live, "--once"])
            snap = json.loads(snap_out.getvalue())
            env = read_manifest(live)["environment"]
            chunks = sum(e["tag"] == "train.chunk" for e in read_events(
                os.path.join(live, "events.jsonl")))
            if (snap["rows"] != ticks or not trace_bytes
                    or env["device_kind"] != torch.cuda.get_device_name(0)
                    or env["backend"] != "cuda" or not env["power_limit"]):
                raise AssertionError(f"metrics {ticks} ticks: monitor {snap['rows']} rows, "
                                     f"manifest {env}")
        for k in finals["off"].params:
            if not bit_equal(finals["off"].params[k], finals["on"].params[k]):
                raise AssertionError(f"metrics {ticks} ticks: metrics on moved the trajectory")
        off, on = statistics.median(ms["off"]), statistics.median(ms["on"])
        pair = sorted(b / a - 1.0 for a, b in zip(ms["off"], ms["on"], strict=True))
        print(f"metrics overhead (obs_bench paper cell, M = {SM}, K = 16, d = {D}, {ticks} "
              f"ticks, capacity {capacity}, {ticks // capacity} chunks a run, {METRICS_REPS} "
              f"runs each in turn): bit_identical True, metrics off median {off:.3f} ms/tick "
              f"(range {min(ms['off']):.3f}-{max(ms['off']):.3f}), on median {on:.3f} "
              f"(range {min(ms['on']):.3f}-{max(ms['on']):.3f}); overhead of the medians "
              f"{on / off - 1.0:+.4f}, of each pair {pair[0]:+.4f} to {pair[-1]:+.4f} (median "
              f"{statistics.median(pair):+.4f}), the reference's budget {METRICS_BUDGET}; rows "
              f"streamed {len(rows)} of {ticks} ticks ({chunks} train.chunk events), monitor "
              f"--once {snap['rows']} rows, trace.json {trace_bytes} bytes, manifest "
              f"{env['device_kind']} / {env['power_limit']}")
        print(f"metrics profile ({ticks} ticks, one run each): " + profile_diff(profiles, ticks))
    return want


def profile_diff(profiles: dict, ticks: int, top: int = 8) -> str:
    """What the metered run adds, from two profiler runs' key averages
    (lists): the host time of the ``bridge.metrics`` range, the kernels'
    device time, and the ops whose self host time grew most, each in us a
    tick."""
    def is_range(e):
        return getattr(e, "is_user_annotation", False) or e.key.startswith(("bridge.",
                                                                             "kernels."))

    def host(tag, key):
        return sum(e.self_cpu_time_total for e in profiles[tag]
                   if e.key == key and not is_range(e)) / ticks

    def kernels(tag):
        return sum(e.self_device_time_total for e in profiles[tag]
                   if e.device_type == torch.autograd.DeviceType.CUDA and not is_range(e)) / ticks

    metered = max((e.cpu_time_total for e in profiles["on"] if e.key == "bridge.metrics"),
                  default=0.0) / ticks
    keys = {e.key for tag in profiles for e in profiles[tag] if not is_range(e)}
    grew = sorted(keys, key=lambda k: host("off", k) - host("on", k))[:top]
    return (f"bridge.metrics {metered:.1f} us host a tick; kernels' device time off "
            f"{kernels('off'):.1f}, on {kernels('on'):.1f} us a tick; ops' self host time grown "
            f"(us a tick): " + ", ".join(f"{k} {host('on', k) - host('off', k):+.1f}"
                                         for k in grew))


def sweep_obs_run(dev) -> dict:
    """(b) ``sweep --mode grid --metrics --trace --profile`` at grid_bench's
    grid; returns the launches of its run."""
    from repro_torch.obs import read_manifest, read_metrics
    from repro_torch.sim.results import cell_of

    # the engine groups cells by (rule, attack); the forensic trace screens
    # every tick of a group through its rule's decide form, and nothing else
    want = {f"screen_{rule}_dense_decide": len(SWEEP_OBS_ATTACKS) * SWEEP_OBS_TICKS
            for rule in SWEEP_OBS_RULES}
    before = {k: fn.launches for k, fn in COUNTED.items()}
    with tempfile.TemporaryDirectory() as tmp:
        run, prof = os.path.join(tmp, "run"), os.path.join(tmp, "prof")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = sweep.main(SWEEP_OBS_ARGS + ["--out", os.path.join(tmp, "out"), "--metrics",
                                               run, "--trace", run, "--profile", prof])
        wall = time.perf_counter() - t0
        tags = [cell_of(c).tag for c in res.cells]
        rows = read_metrics(os.path.join(run, "metrics.jsonl"))
        for tag in tags:
            if [r["tick"] for r in rows if r["tag"] == tag] != list(range(SWEEP_OBS_TICKS)):
                raise AssertionError(f"sweep obs: cell {tag}'s metric rows are not gapless")
        with open(os.path.join(run, "obs_summary.json")) as f:
            summary = {c["tag"]: c for c in json.load(f)["cells"]}
        if set(summary) != set(REFERENCE_SWEEP_OBS) or set(tags) != set(REFERENCE_SWEEP_OBS):
            raise AssertionError(f"sweep obs: cells {sorted(summary)}")
        errs = {t: abs(summary[t]["auc_byzantine_edges"] - want)
                for t, want in REFERENCE_SWEEP_OBS.items()}
        worst = max(errs, key=errs.get)
        if errs[worst] > OBS_TOL:
            raise AssertionError(f"sweep obs: {worst}'s AUC {summary[worst]['auc_byzantine_edges']}"
                                 f" not within {OBS_TOL} of the reference's "
                                 f"{REFERENCE_SWEEP_OBS[worst]}")
        man = read_manifest(run)
        env = man["environment"]
        if not man.get("ended") or env["device_kind"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"sweep obs: manifest {man}")
        ev = [e["tag"] for e in read_events(os.path.join(run, "events.jsonl"))]
        if not {"run.start", "run.end", "profile.capture"} <= set(ev):
            raise AssertionError(f"sweep obs: events {sorted(set(ev))}")
        trace_file = os.path.join(prof, "profile.trace.json")
        with open(trace_file) as f:
            trace_events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in trace_events)
        ranges = {e["name"] for e in trace_events if str(e.get("name", "")).startswith("bridge.")}
        if not kernels or "bridge.metrics" not in ranges:
            raise AssertionError(f"sweep obs: the profiler trace has {kernels} kernels, "
                                 f"ranges {sorted(ranges)}")
        size = os.path.getsize(trace_file)
    check_grew("sweep obs", before, want)
    print(f"sweep --mode grid --metrics --trace --profile ({len(tags)} cells, M = 12, "
          f"{SWEEP_OBS_TICKS} ticks): {wall:.1f} s; metrics.jsonl {len(rows)} rows, "
          f"{SWEEP_OBS_TICKS} a cell, gapless; obs_summary.json AUCs the reference's (worst "
          f"{errs[worst]:.3g}, {worst}); manifest {env['device_kind']} / {env['power_limit']}; "
          f"events {sorted(set(ev))}; profile.trace.json {size} bytes, {kernels} kernel events, "
          f"ranges {sorted(ranges)}; launches {want}, as worked out")
    return want


def stream_runs(dev) -> dict:
    """(c) the chunk-streaming trainer against the flat trainer on the
    card; returns the launches of its runs."""
    from repro_torch.obs import TraceSpec
    from repro_torch.stream import StreamBridgeTrainer, StreamChannelConfig

    want: dict[str, int] = {}

    def add(kernel, n):
        want[kernel] = want.get(kernel, 0) + n

    kern = {"trimmed_mean": "screen_trimmed_mean_dense", "median": "screen_median_dense"}
    topo = erdos_renyi(M, 0.5, B, seed=0)
    # the batches stacked once, so every run sees the same ones
    task = linear_task(M, STREAM_TICKS, partition="iid", num_train=6000, num_test=1000, batch=32,
                       device=dev)
    batch_at = lambda i: tuple(x[i] for x in task.batches)  # noqa: E731
    grad1, init1 = one_leaf(task)
    times = {}
    for rule in ("trimmed_mean", "median"):
        for attack in ("random", "sign_flip"):
            cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack=attack, t0=30)
            flat, ms_flat = stream_run(BridgeTrainer(cfg, grad1, device=dev), init1(0),
                                       batch_at, STREAM_TICKS)
            st, ms_one = stream_run(StreamBridgeTrainer(cfg, grad1, device=dev), init1(0),
                                    batch_at, STREAM_TICKS)
            if not bit_equal(flat.params["theta"], st.params["theta"]):
                raise AssertionError(f"stream one block {rule} {attack}: != BridgeTrainer")
            add(kern[rule], 2 * STREAM_TICKS)
            times[rule, attack] = ms_flat, ms_one
    print(f"stream one block (the paper model as one {D}-wide leaf, M = {M}, {STREAM_TICKS} "
          f"ticks): BRIDGE-T / M under random and sign_flip bit for bit their BridgeTrainer "
          f"runs; ms/tick flat / stream: " + ", ".join(
              f"{r} {a} {f:.3f} / {o:.3f}" for (r, a), (f, o) in times.items()))
    spec_blocks = None
    # sign_flip, and alie, whose honest mean and variance add the nodes in
    # one order at every width (`byzantine.node_sum`)
    for attack in ("sign_flip", "alie"):
        for rule in ("trimmed_mean", "median"):
            cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack=attack, t0=30)
            flat, ms_flat = stream_run(BridgeTrainer(cfg, task.grad_fn, device=dev),
                                       task.init_fn(0), batch_at, STREAM_TICKS)
            tr = StreamBridgeTrainer(dataclasses.replace(cfg, screen_chunk=STREAM_CHUNK),
                                     task.grad_fn, device=dev)
            st, ms_blocks = stream_run(tr, task.init_fn(0), batch_at, STREAM_TICKS)
            spec_blocks = tr.spec.block_sizes()
            for k in flat.params:
                if not bit_equal(flat.params[k], st.params[k]):
                    raise AssertionError(f"stream chunk {STREAM_CHUNK} {rule} {attack}: {k} != "
                                         f"BridgeTrainer")
            add(kern[rule], STREAM_TICKS * (1 + len(spec_blocks)))
            acc = task.eval_accuracy(st.params, tr.honest_mask)
            one = (f", one block {times[rule, attack][1]:.3f}" if (rule, attack) in times
                   else "")
            print(f"stream screen_chunk {STREAM_CHUNK} {rule} {attack} ({len(spec_blocks)} "
                  f"blocks {spec_blocks}, {STREAM_TICKS} ticks): bit for bit BridgeTrainer's, "
                  f"honest accuracy {acc:.4f}; ms/tick flat {ms_flat:.3f}{one}, "
                  f"{len(spec_blocks)} blocks {ms_blocks:.3f}; screens a tick {len(spec_blocks)}")
    # a forensic stream: the decide form a block, bit-inert
    traced = StreamBridgeTrainer(BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=B,
                                              attack="sign_flip", t0=30,
                                              screen_chunk=STREAM_CHUNK,
                                              trace=TraceSpec(decide_stride=16)),
                                 task.grad_fn, device=dev)
    plain = StreamBridgeTrainer(BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=B,
                                             attack="sign_flip", t0=30, screen_chunk=STREAM_CHUNK),
                                task.grad_fn, device=dev)
    st_t, ms_t = stream_run(traced, task.init_fn(0), batch_at, FORENSIC_STREAM_TICKS)
    st_p, _ = stream_run(plain, task.init_fn(0), batch_at, FORENSIC_STREAM_TICKS)
    for k in st_t.params:
        if not bit_equal(st_t.params[k], st_p.params[k]):
            raise AssertionError("forensic stream: the trace moved the trajectory")
    add("screen_trimmed_mean_dense_decide", FORENSIC_STREAM_TICKS * len(spec_blocks))
    add("screen_trimmed_mean_dense", FORENSIC_STREAM_TICKS * len(spec_blocks))
    print(f"stream forensic (chunk {STREAM_CHUNK}, {FORENSIC_STREAM_TICKS} ticks, stride 16): bit "
          f"for bit untraced, {ms_t:.3f} ms/tick, edges seen "
          f"{int((st_t.obs.edge_seen > 0).sum())}")
    # sparse M = 512 at chunk 2048
    stopo = small_world(SM, NEAREST, SB, rewire_prob=0.2, seed=0)
    stask = linear_task(SM, STREAM_TICKS, partition="iid", num_train=16384, num_test=1000,
                        batch=8, device=dev)
    sbatch_at = lambda i: tuple(x[i] for x in stask.batches)  # noqa: E731
    cfg = BridgeConfig(topology=stopo, rule="trimmed_mean", num_byzantine=SB, attack="sign_flip",
                       t0=100, sparse=True)
    flat, ms_flat = stream_run(BridgeTrainer(cfg, stask.grad_fn, device=dev), stask.init_fn(0),
                               sbatch_at, STREAM_TICKS)
    tr = StreamBridgeTrainer(dataclasses.replace(cfg, screen_chunk=SPARSE_STREAM_CHUNK),
                             stask.grad_fn, device=dev)
    st, ms_blocks = stream_run(tr, stask.init_fn(0), sbatch_at, STREAM_TICKS)
    for k in flat.params:
        if not bit_equal(flat.params[k], st.params[k]):
            raise AssertionError(f"sparse stream: {k} != BridgeTrainer")
    sblocks = tr.spec.block_sizes()
    add("gather_screen_trimmed_mean", STREAM_TICKS * (1 + len(sblocks)))
    print(f"stream sparse M = {SM}, K = {tr.neighbors.k}, chunk {SPARSE_STREAM_CHUNK} "
          f"({len(sblocks)} blocks {sblocks}, sign_flip, {STREAM_TICKS} ticks): bit for bit "
          f"BridgeTrainer's; ms/tick flat {ms_flat:.3f}, stream {ms_blocks:.3f}")
    # the network path at drop 0.1
    cfg = BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=B, attack="random",
                       t0=30, screen_chunk=STREAM_CHUNK)
    tr = StreamBridgeTrainer(cfg, task.grad_fn, channel=StreamChannelConfig(drop_prob=0.1,
                                                                           staleness_bound=2),
                             device=dev)
    state = tr.init(task.init_fn(0), seed=1)
    delivered = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STREAM_TICKS):
        state, m = tr.step(state, batch_at(i))
        delivered.append(m["delivered_frac"])
    torch.cuda.synchronize()
    ms_net = (time.perf_counter() - t0) / STREAM_TICKS * 1e3
    frac = float(torch.stack(delivered).mean())
    if not (all(torch.isfinite(v).all() for v in state.params.values()) and 0.8 < frac < 1.0):
        raise AssertionError(f"stream network path: delivered_frac {frac}")
    add("views_screen_trimmed_mean", STREAM_TICKS * len(spec_blocks))
    print(f"stream network path (drop 0.1, staleness 2, chunk {STREAM_CHUNK}, M = {M}, "
          f"{STREAM_TICKS} ticks): delivered_frac {frac:.4f}, honest accuracy "
          f"{task.eval_accuracy(state.params, tr.honest_mask):.4f}, {ms_net:.3f} ms/tick, "
          f"views screens a tick {len(spec_blocks)}")
    return want


def stream_phase(dev):
    """Phase 24 (the module docstring's list): the block widths' kernel
    checks, then the main-path runs, each held to its exact launches;
    returns the phase's launches."""
    t_phase = time.perf_counter()
    block_kernel_checks(dev)
    zero_launches()
    want: dict[str, int] = {}
    for part in (metrics_overhead_runs(dev), sweep_obs_run(dev), stream_runs(dev)):
        for k, n in part.items():
            want[k] = want.get(k, 0) + n
    launches = read_launches()
    if {k: v for k, v in launches.items() if v} != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"phase 24: launches {launches} != the runs' {want}")
    print(f"(phase 24 alone: {time.perf_counter() - t_phase:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 25: the wide decide form, the model zoo's dense family and the
# training CLIs
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("starcoder2-3b", "qwen3-4b", "mistral-nemo-12b", "gemma3-12b")
MODEL_LOSS_RTOL, MODEL_GRAD_RTOL, MODEL_GRAD_ATOL = 1e-5, 1e-4, 1e-6  # card against CPU
FULL_WIDTH_PARAMS = 979_776_512  # qwen3-4b cut to 2 layers, the reference's param_count
FULL_TICKS = 1  # the full-width run's measured ticks, after one warm-up tick
FULL_SEQ = 128
LLM_DEFAULT_STEPS = 1  # train_llm at its default ~126M config (cut from 2 for phase 27)
DENSE_CLI_STEPS = 2  # launch.train --reduce for each dense arch
STREAM_BENCH_CHUNK = 1 << 16  # benchmarks/stream_bench.py's CHUNK, train_llm's --chunk
WIDE_DECIDE_TICKS = 3


def wide_decide_records(dev) -> list:
    """(a) The wide path's decide form against its plain twins: dense M =
    129 and the views form over the same rows (a broadcast, stride 0) on
    edge-case payloads, gather and views at K = 64 with padded slots and
    starved nodes, strides 1 and 4; then dense M = 129, d = 7850
    (`wide_trainer_phase`'s graph) at strides 1 and 16.  trim exact; y
    exact against the plain wide kernel; y against the twin exact but the
    trimmed mean above 64 rows, where the twin sums with ``torch.sum``
    (within the summation bound).  Timed: the dense trimmed mean (the
    record) and median, and the views form at W = 129, beside the plain
    sort (the twin) and the plain wide kernel."""
    gen = torch.Generator(device=dev).manual_seed(25)
    w_np, adj_np, sv_np = edge_case_inputs(WIDE_M, 300, seed=25)
    wx, ax, sx = (torch.as_tensor(x, device=dev) for x in (w_np, adj_np, sv_np))
    vx = wx[None].expand(WIDE_M, WIDE_M, 300)
    for s in (1, 4):
        for tag, got, want, plain_y in (
            ("dense", screen_decide.trimmed_mean_dense_decide(wx, ax, sx, 3, s),
             ref.trimmed_mean_dense_decide(wx, ax, sx, 3, s),
             trimmed_mean.trimmed_mean_dense(wx, ax, sx, 3)),
            ("views", screen_decide.views_screen_trimmed_mean_decide(vx, ax, sx, 3, s),
             ref.trimmed_mean_views_decide(vx, ax, sx, 3, s),
             views_screen.views_screen_trimmed_mean(vx, ax, sx, 3)),
        ):
            name = f"wide decide {tag} trimmed mean edge cases M = {WIDE_M} stride {s}"
            exact_or_raise(f"{name} y against the plain wide kernel", got[0], plain_y)
            exact_or_raise(f"{name} trim", got[1], want[1])
            summation_or_raise(f"{name} y", got[0], want[0], wx[None], ax.sum(dim=1), sx)
        decide_or_raise(f"wide decide dense median edge cases stride {s}",
                        screen_decide.median_dense_decide(wx, ax, sx, s),
                        ref.median_dense_decide(wx, ax, sx, s), median.median_dense(wx, ax, sx))
        decide_or_raise(f"wide decide views median edge cases stride {s}",
                        screen_decide.views_screen_median_decide(vx, ax, sx, s),
                        ref.median_views_decide(vx, ax, sx, s),
                        views_screen.views_screen_median(vx, ax, sx))
    k = 64
    w_np, adj_np, sv_np = sparse_case_inputs(k, 300, seed=k)
    tab = NeighborTable.from_adjacency(adj_np, k=k, device=dev)
    wk, sk = torch.as_tensor(w_np, device=dev), torch.as_tensor(sv_np, device=dev)
    idx, valid = tab.safe_idx, tab.valid_dev
    views = ref.gather(wk, idx).contiguous()
    for s in (1, 4):
        decide_or_raise(f"wide decide gather trimmed mean K = {k} stride {s}",
                        screen_decide.gather_screen_trimmed_mean_decide(wk, idx, valid, sk, 2, s),
                        ref.gather_trimmed_mean_decide(wk, idx, valid, sk, 2, s),
                        gather_screen.gather_screen_trimmed_mean(wk, idx, valid, sk, 2))
        decide_or_raise(f"wide decide gather median K = {k} stride {s}",
                        screen_decide.gather_screen_median_decide(wk, idx, valid, sk, s),
                        ref.gather_median_decide(wk, idx, valid, sk, s),
                        gather_screen.gather_screen_median(wk, idx, valid, sk))
        decide_or_raise(f"wide decide views trimmed mean K = {k} stride {s}",
                        screen_decide.views_screen_trimmed_mean_decide(views, valid, sk, 2, s),
                        ref.trimmed_mean_views_decide(views, valid, sk, 2, s),
                        views_screen.views_screen_trimmed_mean(views, valid, sk, 2))
        decide_or_raise(f"wide decide views median K = {k} stride {s}",
                        screen_decide.views_screen_median_decide(views, valid, sk, s),
                        ref.median_views_decide(views, valid, sk, s),
                        views_screen.views_screen_median(views, valid, sk))
    # the main path's shape: dense M = 129, d = 7850
    topo = erdos_renyi(WIDE_M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    w = torch.randn((WIDE_M, D), generator=gen, device=dev)
    counts = topo.adjacency.sum(axis=1)
    kern = lambda s=16: screen_decide.trimmed_mean_dense_decide(w, adj, w, B, s)  # noqa: E731
    plain = lambda s=16: ref.trimmed_mean_dense_decide(w, adj, w, B, s)  # noqa: E731
    ykern = lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, B)  # noqa: E731
    err = 0.0
    for s in DECIDE_STRIDES:
        got, want = kern(s), plain(s)
        exact_or_raise(f"wide decide M = {WIDE_M} d = {D} stride {s} y against the plain wide "
                       f"kernel", got[0], ykern())
        exact_or_raise(f"wide decide M = {WIDE_M} d = {D} stride {s} trim", got[1], want[1])
        summation_or_raise(f"wide decide M = {WIDE_M} d = {D} stride {s} y", got[0], want[0],
                           w[None], adj.sum(dim=1), w)
        err = max(err, max_abs_err(got[1], want[1]))
    nbytes = 2 * WIDE_M * D * 4 + WIDE_M * WIDE_M + 4 * WIDE_M * WIDE_M
    rec = record("screen_wide_decide", "src/repro_torch/kernels/csrc/screen_wide.cuh",
                 DECIDE_REPLACES["trimmed_mean"], kern, plain, None, nbytes,
                 decide_ops(counts, D, B, 16, False), err)
    rec["plain_kernel_ms"] = cuda_ms(ykern)
    mkern = lambda: screen_decide.median_dense_decide(w, adj, w, 16)  # noqa: E731
    decide_or_raise(f"wide decide median M = {WIDE_M} d = {D}", mkern(),
                    ref.median_dense_decide(w, adj, w, 16), median.median_dense(w, adj, w))
    vw = w[None].expand(WIDE_M, WIDE_M, D)
    vkern = lambda: screen_decide.views_screen_trimmed_mean_decide(  # noqa: E731
        vw, adj, w, B, 16)
    vplain = lambda: ref.trimmed_mean_views_decide(vw, adj, w, B, 16)  # noqa: E731
    vgot, vwant = vkern(), vplain()
    exact_or_raise(f"wide views decide W = {WIDE_M} trim", vgot[1], vwant[1])
    exact_or_raise(f"wide views decide W = {WIDE_M} y against the plain wide kernel", vgot[0],
                   views_screen.views_screen_trimmed_mean(vw, adj, w, B))
    v_bytes = int(counts.sum()) * D * 4 + 2 * WIDE_M * D * 4 + WIDE_M * WIDE_M * (1 + 4)
    v_ops = decide_ops(counts, D, B, 16, False)
    v_bound = max(v_bytes / HBM_BYTES_PER_S, v_ops / FP32_OPS_PER_S) * 1e3
    print(f"  screen_wide_decide: stride 1 {cuda_ms(lambda: kern(1)):.4f} ms, the plain wide "
          f"kernel {rec['plain_kernel_ms']:.4f} ms; median {cuda_ms(mkern):.4f} ms (plain wide "
          f"kernel {cuda_ms(lambda: median.median_dense(w, adj, w)):.4f}, plain sort "
          f"{cuda_ms(lambda: ref.median_dense_decide(w, adj, w, 16), reps=21, inner=2):.4f}); "
          f"views form W = {WIDE_M} (stride-0 receivers): {cuda_ms(vkern):.4f} ms, plain sort "
          f"{cuda_ms(vplain, reps=21, inner=2):.4f} ms, bound {v_bound:.5f} ms; library: none")
    print(f"wide decide: dense M = {WIDE_M}, views W = {WIDE_M}, gather and views K = {k}, "
          f"strides 1, 4, 16, edge cases: trim exact, y the plain wide kernel's bit for bit")
    return [rec]


def wide_decide_trainers(dev) -> dict:
    """(a) The wide decide form on the main path: `wide_trainer_phase`'s
    dense M = 129 and sparse K = 64 trainers, BRIDGE-T and BRIDGE-M, with a
    forensic trace (decide stride 16) for 3 ticks, bit for bit the untraced
    runs; each traced tick one wide decide launch, each untraced one wide
    launch; returns the runs' launches."""
    from repro_torch.obs import TraceSpec

    configs = {
        "dense M=129": BridgeConfig(topology=erdos_renyi(WIDE_M, 0.5, B, seed=0), num_byzantine=B,
                                    attack="random", t0=30),
        "sparse K=64": BridgeConfig(topology=small_world(128, 30, SB, seed=0, max_degree=64),
                                    num_byzantine=SB, attack="random", t0=30, sparse=True),
    }
    want: dict[str, int] = {}
    for tag, base in configs.items():
        m = base.topology.num_nodes
        task = linear_task(m, partition="iid", num_train=20 * m, num_test=100, device=dev)
        # drawn once: every run sees the same batches (batch_fn draws anew)
        batches = [task.batch_fn(i) for i in range(WIDE_DECIDE_TICKS)]
        for rule in ("trimmed_mean", "median"):
            finals = []
            for trace in (None, TraceSpec(decide_stride=16)):
                tr = BridgeTrainer(dataclasses.replace(base, rule=rule, trace=trace),
                                   task.grad_fn, device=dev)
                before = read_launches()
                st = tr.init(task.init_fn(0), seed=1)
                for batch in batches:
                    st, _ = tr.step(st, batch)
                kernel = "screen_wide" if trace is None else "screen_wide_decide"
                check_grew(f"wide {tag} {rule} trace={trace is not None}", before,
                           {kernel: WIDE_DECIDE_TICKS})
                want[kernel] = want.get(kernel, 0) + WIDE_DECIDE_TICKS
                finals.append(st)
            for k in finals[0].params:
                if not bit_equal(finals[0].params[k], finals[1].params[k]):
                    raise AssertionError(f"wide {tag} {rule}: the forensic trace moved {k}")
            seen = int((finals[1].obs.edge_seen > 0).sum())
            if seen == 0:
                raise AssertionError(f"wide {tag} {rule}: the trace saw no edge")
            print(f"wide decide trainer {tag} {rule} ({WIDE_DECIDE_TICKS} ticks, forensic trace, "
                  f"stride 16): bit for bit untraced; the wide decide form once a tick; edges "
                  f"seen {seen}")
    return want


def zoo_parity_runs(dev) -> None:
    """(b) Each reduced dense arch on the card against the CPU (TF32 off):
    `init_params` within `prng.normal`'s tolerance, and `ModelApi.grad_fn`
    over two nodes on a token batch, losses within rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-6 (the CPU tests' bounds against the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import api as model_api

    for arch in ZOO_ARCHS:
        cfg = get_config(arch).reduced()
        api_ = model_api.build(cfg)
        key = prng.PRNGKey(3)
        host = api_.init_params(key, cfg, device="cpu")
        card = api_.init_params(key, cfg, device=dev)
        for k in host:
            torch.testing.assert_close(card[k].cpu(), host[k], rtol=NORMAL_RTOL, atol=2.2e-5,
                                       msg=f"{arch} init {k}: card vs CPU")
        params = replicate(host, 2, perturb=0.01, key=key)
        toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, 32, 2, 2, seed=1).batch(0)["tokens"])
        lc, gcpu = api_.grad_fn()(params, {"tokens": toks})
        lg, gcard = api_.grad_fn()({k: v.to(dev) for k, v in params.items()},
                                   {"tokens": toks.to(dev)})
        torch.testing.assert_close(lg.cpu(), lc, rtol=MODEL_LOSS_RTOL, atol=0.0,
                                   msg=f"{arch}: loss card vs CPU")
        worst = 0.0
        for k in gcpu:
            torch.testing.assert_close(gcard[k].cpu(), gcpu[k], rtol=MODEL_GRAD_RTOL,
                                       atol=MODEL_GRAD_ATOL, msg=f"{arch}: grad {k} card vs CPU")
            diff = (gcard[k].cpu() - gcpu[k]).abs() - MODEL_GRAD_ATOL
            worst = max(worst, float((diff / gcpu[k].abs().clamp(min=1e-30)).max()))
        print(f"zoo parity {arch} (reduced, 2 nodes x 2 sequences of 32): losses "
              f"{[round(float(x), 6) for x in lg]}, card vs CPU loss rel "
              f"{float(((lg.cpu() - lc).abs() / lc.abs()).max()):.2e}, worst gradient rel beyond "
              f"atol {worst:.2e}; init within the normal tolerance")


def full_width_run(dev) -> dict:
    """(d) qwen3-4b at its published widths (d_model 2560, 32 / 8 heads of
    128, d_ff 9728, vocab 151936, qk-norm, rope 1e6), depth cut to 2 layers
    (979,776,512 parameters a node), trained by the stream trainer (chunk
    65536) at M = 4, b = 1, trimmed mean, sign_flip, sequence 128, batch 1
    a node: one warm-up tick, then FULL_TICKS measured ticks, each's loss
    finite, ms/tick on the host clock to a synchronize, and the peak
    device memory of each tick (``max_memory_allocated`` after a reset)
    less the bytes resident before it less the gradient's bytes, which
    must stay below one flat [M, d] float32 matrix (stream_bench's
    ``peak_below_flat_matrix``); returns the run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import make_topology
    from repro_torch.data.tokens import TokenPipeline, device_batch
    from repro_torch.models import api as model_api
    from repro_torch.stream import StreamBridgeTrainer

    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    api_ = model_api.build(cfg)
    n = model_api.param_count(cfg)
    if n != FULL_WIDTH_PARAMS:
        raise AssertionError(f"full width: {n} parameters a node, want {FULL_WIDTH_PARAMS}")
    m = 4
    topo = make_topology("erdos_renyi:0.9", m, 1, seed=0)
    bcfg = BridgeConfig(topology=topo, rule="trimmed_mean", num_byzantine=1, attack="sign_flip",
                        lr=0.02, screen_chunk=STREAM_BENCH_CHUNK)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = StreamBridgeTrainer(bcfg, api_.grad_fn(), device=dev)
    key = prng.PRNGKey(0)
    state = tr.init(replicate(api_.init_params(key, cfg, device=dev), m, perturb=0.005, key=key))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d, blocks = tr.spec.total_dim, tr.spec.num_blocks
    flat_bytes = grad_bytes = m * d * 4
    pipe = TokenPipeline(cfg.vocab_size, FULL_SEQ, 1, m, seed=0)
    before = read_launches()
    t0 = time.perf_counter()
    state, met = tr.step(state, device_batch(pipe.batch(0), dev))
    warm_loss = float(met["loss"])
    warm_s = time.perf_counter() - t0
    rows = []
    for i in range(1, 1 + FULL_TICKS):
        batch = device_batch(pipe.batch(i), dev)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, met = tr.step(state, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        rows.append((loss, ms, peak, resident, peak - resident - grad_bytes))
    want = {"screen_trimmed_mean_dense": blocks * (1 + FULL_TICKS)}
    check_grew("full width", before, want)
    losses = [r[0] for r in rows]
    if not all(math.isfinite(x) for x in [warm_loss, *losses]):
        raise AssertionError(f"full width: non-finite loss {warm_loss}, {losses}")
    worst = max(r[4] for r in rows)
    print(f"full width qwen3-4b, 2 layers ({n:,} parameters a node, d = {d}), M = {m}, b = 1, "
          f"trimmed mean, sign_flip, seq {FULL_SEQ}, batch 1, stream chunk {STREAM_BENCH_CHUNK} "
          f"({blocks} blocks): init {init_s:.1f} s, warm-up tick {warm_s * 1e3:.1f} ms (loss "
          f"{warm_loss:.4f})")
    for i, (loss, ms, peak, resident, excess) in enumerate(rows, 1):
        print(f"  full width tick {i}: loss {loss:.6f}, {ms:.1f} ms/tick, max_memory_allocated "
              f"{peak} B, resident before {resident} B, gradient {grad_bytes} B, peak less "
              f"resident less gradient {excess} B, flat [M, d] matrix {flat_bytes} B")
    print(f"full width: {statistics.median(r[1] for r in rows):.1f} ms/tick (median of "
          f"{FULL_TICKS}); screen_trimmed_mean_dense {want['screen_trimmed_mean_dense']} "
          f"launches ({blocks} a tick); peak_below_flat_matrix: {worst} < {flat_bytes}: "
          f"{worst < flat_bytes}")
    if not worst < flat_bytes:
        raise AssertionError(f"full width: the tick's peak less resident less gradient {worst} "
                             f"B is not below the flat matrix's {flat_bytes} B")
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return want


def llm_small_runs(dev, tmp: str) -> dict:
    """(c) ``train_llm --small`` at stream_bench's cell (M = 4, b = 1,
    trimmed mean, sign_flip, sequence 64, batch 1): the flat trainer and
    the stream at chunk 65536 give the same state bit for bit after 3
    ticks, and ``--resume`` from the checkpoint written at tick 2 gives the
    3-tick state bit for bit; returns the runs' launches."""
    from repro_torch.examples import train_llm
    from repro_torch.stream import BlockSpec

    base = ["--small", "--seq", "64", "--batch", "1", "--attack", "sign_flip", "--device",
            dev.type, "--ckpt", os.path.join(tmp, "llm_small")]
    before = read_launches()
    flat, loss_f = train_llm.main(base + ["--steps", "3", "--flat", "--ckpt-every", "100"])
    stream, loss_s = train_llm.main(base + ["--steps", "3", "--ckpt-every", "100"])
    for k in flat.params:
        if not bit_equal(flat.params[k], stream.params[k]):
            raise AssertionError(f"train_llm --small: flat != stream at {k}")
    train_llm.main(base + ["--steps", "2", "--ckpt-every", "2"])
    resumed, _ = train_llm.main(base + ["--steps", "3", "--ckpt-every", "100", "--resume"])
    same = resumed.t == stream.t and bool((resumed.key == stream.key).all()) and all(
        bit_equal(resumed.params[k], stream.params[k]) for k in stream.params)
    if not same:
        raise AssertionError("train_llm --small --resume: not the uninterrupted state")
    blocks = BlockSpec.from_params(stream.params, STREAM_BENCH_CHUNK).num_blocks
    want = {"screen_trimmed_mean_dense": 3 + blocks * (3 + 2 + 1)}
    check_grew("train_llm --small", before, want)
    if not (math.isfinite(loss_f) and math.isfinite(loss_s)):
        raise AssertionError(f"train_llm --small: losses {loss_f}, {loss_s}")
    print(f"train_llm --small (M = 4, b = 1, sign_flip, seq 64): flat and stream (chunk "
          f"{STREAM_BENCH_CHUNK}, {blocks} blocks) bit for bit over 3 ticks (loss {loss_s:.4f}); "
          f"--resume from tick 2 bit for bit the uninterrupted run")
    return want


def cli_runs(dev, tmp: str) -> None:
    """(e) The entry points as a user calls them: ``train_llm`` at its
    default ~126M config for 2 ticks; one tick each of ``--trace --trust``,
    ``--sparse --codec int8`` and ``--net`` at ``--small``; ``launch.train
    --arch <arch> --reduce`` for 2 steps for each dense arch; ``sweep --mode
    net`` over 2 scenario jobs.  Each exits with a finite loss; the paths'
    screening kernels launched."""
    from repro_torch.examples import train_llm
    from repro_torch.launch import train

    ck = os.path.join(tmp, "llm_cli")
    runs = [(["--steps", str(LLM_DEFAULT_STEPS)], "screen_trimmed_mean_dense"),
            (["--small", "--steps", "1", "--trace", "--trust"], "screen_trimmed_mean_dense_decide"),
            (["--small", "--steps", "1", "--sparse", "--codec", "int8"],
             "gather_screen_trimmed_mean"),
            (["--small", "--steps", "1", "--net"], "views_screen_trimmed_mean")]
    for extra, kernel in runs:
        before = read_launches()
        t0 = time.perf_counter()
        _, loss = train_llm.main(extra + ["--device", dev.type, "--ckpt", ck])
        grew = KERNELS[kernel].launches - before[kernel]
        if not (math.isfinite(loss) and grew > 0):
            raise AssertionError(f"train_llm {extra}: loss {loss}, {kernel} launched {grew}")
        print(f"train_llm {' '.join(extra)}: loss {loss:.4f}, {kernel} {grew} launches, "
              f"{time.perf_counter() - t0:.1f} s")
    for arch in ZOO_ARCHS:
        before = read_launches()
        steps = str(DENSE_CLI_STEPS)
        _, loss = train.main(["--arch", arch, "--reduce", "--steps", steps, "--log-every", steps,
                              "--device", dev.type])
        grew = KERNELS["screen_trimmed_mean_dense"].launches - before["screen_trimmed_mean_dense"]
        if not (math.isfinite(loss) and grew == DENSE_CLI_STEPS):
            raise AssertionError(f"launch.train {arch}: loss {loss}, {grew} screens")
        print(f"launch.train --arch {arch} --reduce: {steps} steps, loss {loss:.4f}")
    t0 = time.perf_counter()
    done = sweep.main(["--mode", "net", "--out", os.path.join(tmp, "net_sweep"), "--rules",
                       "trimmed_mean", "--attacks", "alie", "--scenarios", "ideal,lossy",
                       "--net-steps", "2", "--jobs", "2", "--device", dev.type])
    if [st.split()[0] for _, st in done] != ["ok", "ok"]:
        raise AssertionError(f"sweep --mode net: {done}")
    for tag, _ in done:
        with open(os.path.join(tmp, "net_sweep", tag + ".json")) as f:
            out = json.load(f)["stdout"]
        loss = float(out.split("loss")[-1].split()[0])
        if not math.isfinite(loss):
            raise AssertionError(f"sweep --mode net {tag}: loss {loss}")
    print(f"sweep --mode net: 2 jobs ok through python -m repro_torch.launch.train on the card "
          f"({time.perf_counter() - t0:.1f} s)")


def zoo_phase(dev):
    """Phase 25 (the module docstring's list): the wide decide form's
    kernel records, then the main-path runs, the exact ones held to their
    launches; returns (records, the phase's launches)."""
    from repro_torch.device import set_numerics

    set_numerics()
    t_phase = time.perf_counter()
    records = wide_decide_records(dev)
    zero_launches()
    want: dict[str, int] = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for part in (wide_decide_trainers(dev), full_width_run(dev), llm_small_runs(dev, tmp)):
            for k, n in part.items():
                want[k] = want.get(k, 0) + n
        zoo_parity_runs(dev)
        cli_runs(dev, tmp)
    launches = read_launches()
    for k, n in want.items():
        if launches[k] < n:
            raise AssertionError(f"phase 25: {k} launched {launches[k]}, the exact runs alone "
                                 f"{n}")
    print(f"(phase 25 alone: {time.perf_counter() - t_phase:.1f} s)")
    return records, launches


# ---------------------------------------------------------------------------
# phase 26: the rest of the model zoo and serving
# ---------------------------------------------------------------------------

REST_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "rwkv6-3b", "zamba2-1.2b",
              "whisper-medium", "qwen2-vl-2b")
# each serving config at its published widths; deepseek-v2 cut to 2 layers
# (one dense, one MoE), the only cut: the reference's param_count of each
SERVE_CELLS = (("qwen3-4b", None, 4_411_424_256), ("deepseek-v2-236b", 2, 5_358_679_040),
               ("rwkv6-3b", None, 3_073_313_280), ("zamba2-1.2b", None, 1_170_473_856),
               ("whisper-medium", None, 793_605_120), ("qwen2-vl-2b", None, 1_777_030_656))
# examples/serve.py's batch and prompt; its 32 greedy tokens cut to 16 so that
# the script with phase 27 stays inside its time limit (ms a token is the
# median decode step either way)
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 32, 16
DECODE_CHECK_TOKENS = 8
LOGIT_BOUND = 1e-5  # decode logits card against CPU, of the largest
DECODE_BOUND = 2e-4  # decode against forward, the reference's (tests/test_models.py)
EMBED_GRAD_BOUND = 1e-5  # the embedding's gradient, of its largest entry (a row sums its uses)
REST_CLI_STEPS = 3


def rest_configs(arch: str):
    """The phase's reduced configs of ``arch`` (zamba2 also at 5 layers,
    a remainder block)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if arch == "zamba2-1.2b":
        return [cfg, get_config(arch).reduced(num_layers=5)]
    return [cfg]


def rest_batch(cfg, nodes: int, seed: int) -> dict:
    """Tokens ``[nodes, 2, 33]`` and the family's embeddings, on the CPU."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (nodes, 2, 33)),
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.as_tensor(rng.normal(size=(nodes, 2, 32, cfg.d_model)),
                                              dtype=torch.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = torch.as_tensor(rng.normal(size=(nodes, 2, 4, cfg.d_model)),
                                              dtype=torch.float32)
    return out


def decode_logits(api_, params, cfg, toks, audio=None) -> torch.Tensor:
    """``toks [B, n]`` stepped through ``decode_step`` from a fresh cache
    (whisper's cross caches filled from ``audio``): logits ``[B, n, V]``."""
    dev = toks.device
    cache = api_.init_cache(cfg, toks.shape[0], toks.shape[1], device=dev)
    if cfg.family == "encdec":
        cache = api_.extra["prefill_cache"](params, cache, audio, cfg)
    outs = []
    for i in range(toks.shape[1]):
        lg, cache = api_.decode_step(params, cache, toks[:, i:i + 1], cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)


def rest_parity_runs(dev) -> None:
    """(a) Each reduced config of the MoE, RWKV, hybrid (and zamba2 with a
    remainder), enc-dec and VLM families on the card against the CPU (TF32
    off): ``init_params`` within the normal tolerance, ``ModelApi.grad_fn``
    over two nodes (losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, the
    embedding's within 1e-5 of its largest entry), and 4 ``decode_step``
    logits (whisper after ``prefill_cache``) within 1e-5 of the largest;
    every config is checked before a failure raises."""
    from repro_torch.models import api as model_api

    failed = []
    for arch in REST_ARCHS:
        for cfg in rest_configs(arch):
            api_ = model_api.build(cfg)
            key = prng.PRNGKey(3)
            host = api_.init_params(key, cfg, device="cpu")
            card = api_.init_params(key, cfg, device=dev)
            for k in host:
                torch.testing.assert_close(card[k].cpu(), host[k], rtol=NORMAL_RTOL,
                                           atol=2.2e-5, msg=f"{cfg.name} init {k}: card vs CPU")
            del card
            params = replicate(host, 2, perturb=0.01, key=key)
            batch = rest_batch(cfg, 2, seed=1)
            lc, gcpu = api_.grad_fn()(params, batch)
            lg, gcard = api_.grad_fn()({k: v.to(dev) for k, v in params.items()},
                                       {k: v.to(dev) for k, v in batch.items()})
            torch.testing.assert_close(lg.cpu(), lc, rtol=MODEL_LOSS_RTOL, atol=0.0,
                                       msg=f"{cfg.name}: loss card vs CPU")
            worst = 0.0
            for k in gcpu:
                got, want = gcard[k].cpu(), gcpu[k]
                if k == "embed":
                    err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
                    if not err <= EMBED_GRAD_BOUND:
                        failed.append(f"{cfg.name}: embed gradient {err:.2e} of its largest "
                                      f"entry, card vs CPU")
                    continue
                if not torch.allclose(got, want, rtol=MODEL_GRAD_RTOL, atol=MODEL_GRAD_ATOL):
                    failed.append(f"{cfg.name}: grad {k} card vs CPU, max abs diff "
                                  f"{float((got - want).abs().max()):.2e}")
                diff = (got - want).abs() - MODEL_GRAD_ATOL
                worst = max(worst, float((diff / want.abs().clamp(min=1e-30)).max()))
            one = {k: v[0].contiguous() for k, v in params.items()}
            toks = batch["tokens"][0, :, :4]
            audio = batch.get("audio_embeds")
            audio = None if audio is None else audio[0]
            dc = decode_logits(api_, one, cfg, toks, audio)
            dg = decode_logits(api_, {k: v.to(dev) for k, v in one.items()}, cfg, toks.to(dev),
                               None if audio is None else audio.to(dev))
            derr = float((dg.cpu() - dc).abs().max() / dc.abs().max())
            if not derr <= LOGIT_BOUND:
                failed.append(f"{cfg.name}: 4 decode steps' logits card vs CPU {derr:.2e} of "
                              f"the largest > {LOGIT_BOUND}")
            print(f"zoo parity {cfg.name} {cfg.family} ({cfg.num_layers} layers, reduced, 2 nodes "
                  f"x 2 sequences of 32): losses {[round(float(x), 6) for x in lg]}, card vs CPU "
                  f"loss rel {float(((lg.cpu() - lc).abs() / lc.abs()).max()):.2e}, worst "
                  f"gradient rel beyond atol {worst:.2e}; 4 decode steps' logits {derr:.2e} of "
                  f"the largest; init within the normal tolerance")
    if failed:
        raise AssertionError("; ".join(failed))


def serve_config(arch: str, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def decode_bytes(params: dict, cfg) -> int:
    """The parameter bytes one decode step reads: all but the rows it only
    gathers (a separate head's embedding, ``dec_pos``) and those it never
    touches (whisper's encoder and ``enc_pos``, v3's MTP head)."""
    skip = ("enc_", "frontend_proj", "dec_pos", "mtp/")
    total = 0
    for k, v in params.items():
        if k.startswith(skip) or (k == "embed" and cfg.family != "encdec"):
            continue
        total += v.numel() * v.element_size()
    return total


def forward_logits(params, cfg, toks, audio=None) -> torch.Tensor:
    """The family's full-sequence forward over ``toks`` (whisper:
    ``decode_train`` over the encoder's output of ``audio``; the VLM: the
    dense backbone with text positions t = h = w)."""
    from repro_torch.models import dense, encdec, hybrid, moe, ssm

    if cfg.family == "encdec":
        return encdec.decode_train(params, encdec.encode(params, audio, cfg), toks, cfg)
    if cfg.family == "moe":
        return moe.forward(params, toks, cfg)[0]
    if cfg.family == "vlm":
        n = toks.shape[1]
        pos3 = torch.arange(n, dtype=torch.int32, device=toks.device)[None, None].expand(
            3, toks.shape[0], n)
        return dense.forward(params, toks, cfg, mrope_positions=pos3)
    fwd = {"dense": dense.forward, "rwkv": ssm.forward, "hybrid": hybrid.forward}[cfg.family]
    return fwd(params, toks, cfg)


def profile_decode(params, api_, cfg, dev, steps: int = 4) -> tuple[float, float, float]:
    """``steps`` decode steps from a fresh cache under `torch.profiler`,
    after two unprofiled ones: (wall ms, device-busy ms, kernels) a step."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    cache = api_.init_cache(cfg, SERVE_BATCH, steps + 2, device=dev)
    if cfg.family == "encdec":
        audio = torch.zeros((SERVE_BATCH, SERVE_PROMPT, cfg.d_model), device=dev)
        cache = api_.extra["prefill_cache"](params, cache, audio, cfg)
    tok = torch.ones((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    for _ in range(2):
        _, cache = api_.decode_step(params, cache, tok, cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, cache = api_.decode_step(params, cache, tok, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    work = [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    return wall_ms / steps, busy_ms / steps, len(work) / steps


def serve_runs(dev) -> list:
    """(b) ``serve.generate`` at full width (batch 4, prompt 32, 16 greedy
    tokens), each config of `SERVE_CELLS` in turn: finite logits, the same
    tokens on a second call, decode against the family's forward over 8
    tokens within 2e-4 of the largest logit (MoE at capacity_factor 8),
    ms a token at the median of the decode steps beside the parameter bytes
    a step reads over 3.35 TB/s, ``max_memory_allocated`` beside the
    parameter bytes, 4 more steps under `torch.profiler` (device busy,
    kernels a step); each model freed before the next.  Returns the rows."""
    from repro_torch.examples import serve
    from repro_torch.models import api as model_api

    rows = []
    for arch, layers, want_n in SERVE_CELLS:
        cfg = serve_config(arch, layers)
        n = model_api.param_count(cfg)
        if n != want_n:
            raise AssertionError(f"serve {arch}: {n} parameters, want {want_n}")
        api_ = model_api.build(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = api_.init_params(prng.PRNGKey(0), cfg, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pbytes = sum(v.numel() * v.element_size() for v in params.values())
        gen = serve.generate(api_, params, cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                             tokens=SERVE_TOKENS)
        again = serve.generate(api_, params, cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                               tokens=SERVE_TOKENS)
        if not (gen.finite and again.finite):
            raise AssertionError(f"serve {arch}: non-finite logits")
        if not np.array_equal(gen.ids, again.ids):
            raise AssertionError(f"serve {arch}: a second call decoded other tokens")
        rng = np.random.default_rng(1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, DECODE_CHECK_TOKENS)),
                               dtype=torch.int32).to(dev)
        audio = None
        if cfg.family == "encdec":
            audio = torch.as_tensor(rng.normal(size=(SERVE_BATCH, SERVE_PROMPT, cfg.d_model)),
                                    dtype=torch.float32).to(dev)
        ccfg = dataclasses.replace(cfg, capacity_factor=8.0) if cfg.family == "moe" else cfg
        with torch.no_grad():
            dec = decode_logits(api_, params, ccfg, toks, audio)
            full = forward_logits(params, ccfg, toks, audio)
        rel = float((dec - full).abs().max() / full.abs().max())
        if not rel <= DECODE_BOUND:
            raise AssertionError(f"serve {arch}: decode against forward {rel:.2e} > "
                                 f"{DECODE_BOUND}")
        del dec, full
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.no_grad():
            prof_ms, busy_ms, kernels = profile_decode(params, api_, cfg, dev)
        ms = statistics.median(gen.step_s) * 1e3
        rbytes = decode_bytes(params, cfg)
        bound_ms = rbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(arch=arch, layers=cfg.num_layers, params=n, ms_token=ms,
                         bound_ms=bound_ms, peak=peak, param_bytes=pbytes, busy_ms=busy_ms))
        print(f"serve {arch} ({cfg.num_layers} layers, {n:,} parameters, {pbytes} B): init "
              f"{init_s:.1f} s, prefill {gen.prefill_s * 1e3:.1f} ms ({SERVE_PROMPT} steps"
              f"{' (the encoder)' if cfg.family == 'encdec' else ''}), {ms:.3f} ms/token at the "
              f"median of {SERVE_TOKENS} steps (mean {sum(gen.step_s) / SERVE_TOKENS * 1e3:.3f}; "
              f"second call {statistics.median(again.step_s) * 1e3:.3f}), bound {bound_ms:.3f} "
              f"ms ({rbytes} B a step at 3.35 TB/s), max_memory_allocated {peak} B; finite, "
              f"the same tokens twice (row 0: {gen.ids[0][:8].tolist()}), decode vs forward "
              f"over {DECODE_CHECK_TOKENS} tokens {rel:.2e}; profiled: {prof_ms:.3f} ms a step, "
              f"device busy {busy_ms:.3f} ms ({100 * busy_ms / prof_ms:.1f}%), {kernels:.0f} "
              f"kernels and copies a step")
        del params, gen, again
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def rest_cli_runs(dev) -> dict:
    """(c) BRIDGE on three new families, as a user calls it: ``launch.train
    --arch deepseek-v2-236b --reduce --rule trimmed_mean`` and ``--arch
    rwkv6-3b --rule median`` (one screen a step), ``--arch zamba2-1.2b``,
    then the reduced zamba2 through the stream trainer (chunk 65536, one
    screen a block and tick): finite losses; returns the runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.graph import make_topology
    from repro_torch.data.tokens import TokenPipeline, device_batch
    from repro_torch.launch import train
    from repro_torch.models import api as model_api
    from repro_torch.stream import StreamBridgeTrainer

    want: dict[str, int] = {}
    for arch, rule in (("deepseek-v2-236b", "trimmed_mean"), ("rwkv6-3b", "median"),
                       ("zamba2-1.2b", "trimmed_mean")):
        kernel = f"screen_{rule}_dense"
        before = read_launches()
        t0 = time.perf_counter()
        state, loss = train.main(["--arch", arch, "--reduce", "--rule", rule, "--steps",
                                  str(REST_CLI_STEPS), "--batch", "2", "--seq", "32",
                                  "--log-every", str(REST_CLI_STEPS), "--device", dev.type])
        check_grew(f"launch.train {arch}", before, {kernel: REST_CLI_STEPS})
        want[kernel] = want.get(kernel, 0) + REST_CLI_STEPS
        if not math.isfinite(loss):
            raise AssertionError(f"launch.train {arch}: loss {loss}")
        print(f"launch.train --arch {arch} --reduce --rule {rule}: {REST_CLI_STEPS} steps, loss "
              f"{loss:.4f}, {kernel} {REST_CLI_STEPS} launches, {time.perf_counter() - t0:.1f} s")
    cfg = get_config("zamba2-1.2b").reduced()
    api_ = model_api.build(cfg)
    m = 4
    bcfg = BridgeConfig(topology=make_topology("erdos_renyi:0.9", m, 1, seed=0),
                        rule="trimmed_mean", num_byzantine=1, attack="sign_flip", lr=0.02,
                        screen_chunk=STREAM_BENCH_CHUNK)
    tr = StreamBridgeTrainer(bcfg, api_.grad_fn(), device=dev)
    key = prng.PRNGKey(0)
    state = tr.init(replicate(api_.init_params(key, cfg, device=dev), m, perturb=0.005, key=key))
    pipe = TokenPipeline(cfg.vocab_size, 32, 2, m, seed=0)
    before = read_launches()
    losses = []
    for i in range(REST_CLI_STEPS):
        state, met = tr.step(state, device_batch(pipe.batch(i), dev))
        losses.append(float(met["loss"]))
    blocks = tr.spec.num_blocks
    check_grew("stream zamba2", before, {"screen_trimmed_mean_dense": blocks * REST_CLI_STEPS})
    want["screen_trimmed_mean_dense"] += blocks * REST_CLI_STEPS
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stream zamba2: losses {losses}")
    print(f"stream zamba2-1.2b (reduced, M = {m}, b = 1, sign_flip, chunk {STREAM_BENCH_CHUNK}, "
          f"{blocks} blocks): {REST_CLI_STEPS} ticks, losses {[round(x, 4) for x in losses]}")
    return want


def zoo_rest_phase(dev):
    """Phase 26 (the module docstring's list); returns the phase's
    launches."""
    from repro_torch.device import set_numerics

    set_numerics()
    t_phase = time.perf_counter()
    zero_launches()
    rest_parity_runs(dev)
    t0 = time.perf_counter()
    serve_runs(dev)
    print(f"(phase 26(b) serving: {time.perf_counter() - t0:.1f} s)")
    want = rest_cli_runs(dev)
    launches = read_launches()
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"phase 26: {k} launched {launches[k]}, the runs {n}")
    print(f"(phase 26 alone: {time.perf_counter() - t_phase:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 27: the sharded path on torch.distributed, a world of one NCCL rank
# ---------------------------------------------------------------------------

SHARD_ATTACKS = (("random", False), ("sign_flip", False), ("random", True), ("sign_flip", True))
SHARD_LEAVES = 2  # the paper cell's linear model: w [M, 784, 10], b [M, 10]
SHARD_WARM, SHARD_STEPS = 1, 2  # the full-width train step: warm-up, then timed
SHARD_SEQ = 128
# 27(b)'s screens held against the CPU: a leaf of at most SHARD_TAIL
# columns a node whole, a wider one its first SHARD_HEAD and last
# SHARD_TAIL columns (the top of the embedding's index range)
SHARD_HEAD, SHARD_TAIL = 1 << 16, 1 << 20


def sharded_want(cases, a2a_cases) -> dict:
    """The launches phase 27(a) makes, worked out from its cases: a screen
    a leaf (the views kernels on the all_gather schedule, Bulyan's last
    stage the views trimmed mean; the dense kernels on the all_to_all), a
    ``dequant`` a leaf of each int8 call; Krum and the means launch none."""
    want: dict[str, int] = {}

    def add(k, n):
        want[k] = want.get(k, 0) + n

    for rule, _, q in cases:
        kernel = {"trimmed_mean": "views_screen_trimmed_mean", "median": "views_screen_median",
                  "bulyan": "views_screen_trimmed_mean"}.get(rule)
        if kernel:
            add(kernel, SHARD_LEAVES)
        if q:
            add("dequant", SHARD_LEAVES)
    for rule, q in a2a_cases:
        if rule != "mean":
            add(f"screen_{rule}_dense", SHARD_LEAVES)
        if q:
            add("dequant", SHARD_LEAVES)
    return want


def sharded_gossip_runs(dev) -> dict:
    """(a) `gossip_screen_params` at the paper cell (M = 50 on
    ``erdos_renyi(50, 0.5, 4)``, b = 4, the linear model's two leaves, d =
    7850) on a (1, 1) mesh of the NCCL world, against the same call on a
    (1, 1) CPU mesh of the same world (gloo, the plain versions): the
    all_gather schedule, trimmed mean, median and mean under random and
    sign_flip, float and int8, Krum, Bulyan under both attacks, and the
    int8 mean and trimmed mean over a NaN payload (the decode keeps NaN,
    as the reference's plain product does); rows 1-2,
    the mean and the decodes exact (the random attack's rows within
    `prng.normal`'s tolerance, card against CPU), Krum's picks equal and
    its rows and Bulyan's within the dot-product bound.  Then the
    all_to_all schedule at M = 1, its one legal shape on one card (one node
    a rank): it holds the plumbing and NCCL's all_to_all, not the
    schedule's arithmetic.  Returns the launches, held to `sharded_want`."""
    from repro_torch.core.gossip import gossip_screen_params
    from repro_torch.launch import mesh as mesh_lib

    card = mesh_lib.make_mesh_compat((1, 1), ("data", "model"), device=dev)
    host = mesh_lib.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    topo = erdos_renyi(M, 0.5, B, seed=0)
    rng = np.random.default_rng(27)
    params = {"w": rng.normal(size=(M, 784, 10)).astype(np.float32),
              "b": rng.normal(size=(M, 10)).astype(np.float32)}
    specs = {"w": ("data", None, "model"), "b": ("data", "model")}
    byz = np.zeros(M, bool)
    byz[[3, 17, 29, 41]] = True
    cases = [(r, a, q) for r in ("trimmed_mean", "median", "mean") for a, q in SHARD_ATTACKS]
    cases += [("krum", "none", False), ("bulyan", "random", False),
              ("bulyan", "sign_flip", False)]
    a2a_cases = [(r, q) for r in ("trimmed_mean", "median", "mean") for q in (False, True)]
    # a NaN payload in node 7's rows: its int8 scale is NaN and its rows
    # decode to NaN, as the reference's product does (DGD's mean keeps it)
    nan_params = {k: v.copy() for k, v in params.items()}
    for v in nan_params.values():
        v[7].flat[5] = np.nan
    nan_cases = [("mean", "none", True), ("trimmed_mean", "none", True)]

    def run(mesh, device, rule, attack, q, *, m=M, schedule="all_gather", src=params):
        sub = {k: torch.as_tensor(v[:m]).to(device) for k, v in src.items()}
        adj = torch.as_tensor(topo.adjacency[:m, :m] if m > 1 else np.zeros((1, 1), bool))
        return gossip_screen_params(
            sub, specs, mesh=mesh, node_axes=("data",), rule=rule, b=B if m > 1 else 0,
            adjacency=adj.to(device), schedule=schedule, byz_mask=torch.as_tensor(byz[:m]).to(device),
            attack=attack, key=prng.PRNGKey(27), t=5, quantize=q)

    zero_launches()
    got = {c: run(card, dev, *c) for c in cases}
    got_a2a = {c: run(card, dev, c[0], "none", c[1], m=1, schedule="all_to_all") for c in a2a_cases}
    got_nan = {c: run(card, dev, *c, src=nan_params) for c in nan_cases}
    torch.cuda.synchronize()
    launches = read_launches()
    for c in cases:
        want = run(host, "cpu", *c)
        rule, attack, q = c
        for k in params:
            g, w = got[c][k].cpu(), want[k]
            tag = f"sharded gossip {rule} {attack} {'int8' if q else 'f32'} {k}"
            if rule in ("krum", "bulyan"):
                err = float((g - w).abs().max())
                bound = 1e-5 * max(float(w.abs().max()), 1.0)
                if rule == "krum" and not torch.equal(g, w):
                    raise AssertionError(f"{tag}: Krum picked other rows on the card")
                if err > bound:
                    raise AssertionError(f"{tag}: {err:.3g} beyond {bound:.3g}")
            elif attack == "random":
                torch.testing.assert_close(g, w, rtol=NORMAL_RTOL, atol=10 * 2.2e-5, msg=tag)
            else:
                exact_or_raise(tag, g, w)
    for c in a2a_cases:
        want = run(host, "cpu", c[0], "none", c[1], m=1, schedule="all_to_all")
        for k in params:
            exact_or_raise(f"sharded all_to_all M = 1 {c[0]} {'int8' if c[1] else 'f32'} {k}",
                           got_a2a[c][k].cpu(), want[k])
    for c in nan_cases:
        want = run(host, "cpu", *c, src=nan_params)
        for k in params:
            g = got_nan[c][k].cpu()
            exact_or_raise(f"sharded gossip {c[0]} int8, a NaN payload, {k}", g, want[k])
            if c[0] == "mean" and not bool(torch.isnan(g).any()):
                raise AssertionError(f"sharded gossip mean int8 {k}: the NaN payload was not kept")
    want = sharded_want(cases + nan_cases, a2a_cases)
    for k, n in launches.items():
        if n != want.get(k, 0):
            raise AssertionError(f"phase 27(a): {k} launched {n}, worked out {want.get(k, 0)}")
    print(f"sharded gossip (a world of one NCCL rank, mesh (1, 1)): M = {M}, b = {B}, d = {D}, "
          f"all_gather: trimmed mean, median, mean x random, sign_flip x f32, int8; Krum; Bulyan "
          f"x random, sign_flip: card == CPU (rows 1-2, the mean and the decodes exact; random "
          f"within the normal's tolerance; Krum's picks equal, K / B within the dot-product "
          f"bound); all_to_all at M = 1 (one node a rank, the schedule's only shape on one card: "
          f"NCCL's all_to_all and the plumbing, not the schedule's arithmetic) exact; int8 mean "
          f"and trimmed mean over a NaN payload exact (NaN kept, as the reference's decode); "
          f"launches "
          f"{({k: v for k, v in launches.items() if v})}, as worked out")
    return launches


def sharded_train_run(dev) -> dict:
    """(b) `make_train_step` at full width: qwen3-4b at its published
    widths cut to 2 layers (979,776,512 parameters a node), M = 4 nodes on
    the one rank (mesh (1, 1)), the all_gather schedule, BRIDGE-T, b = 1,
    gossip first, sequence 128, batch 1 a node: one warm-up step, then
    SHARD_STEPS timed (host clock to a synchronize) with
    ``max_memory_allocated`` after a reset, finite losses, then one step
    under `torch.profiler` (device busy share, kernels a step).  One
    ``views_screen_trimmed_mean`` launch a leaf and step, held to the count
    worked out from the config's leaves; returns the run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.graph import make_topology
    from repro_torch.data.tokens import TokenPipeline, device_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api as model_api

    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    api_ = model_api.build(cfg)
    n = model_api.param_count(cfg)
    if n != FULL_WIDTH_PARAMS:
        raise AssertionError(f"sharded full width: {n} parameters a node, want {FULL_WIDTH_PARAMS}")
    m = 4
    shapes = {k: (m, *s) for k, s in api_.param_shapes(cfg).items()}
    leaves = len(shapes)
    steps = SHARD_WARM + SHARD_STEPS + 1  # the profiled step last
    want = {"views_screen_trimmed_mean": leaves * steps}
    mesh = mesh_lib.make_mesh_compat((1, 1), ("data", "model"), device=dev)
    specs = sharding.param_specs(cfg, shapes, node_axes=("data",))
    topo = make_topology("erdos_renyi:0.9", m, 1, seed=0)
    step = make_train_step(cfg, mesh, ("data",), specs, torch.as_tensor(topo.adjacency).to(dev),
                           rule="trimmed_mean", num_byzantine=1, gossip_schedule="all_gather")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    key = prng.PRNGKey(0)
    params = replicate(api_.init_params(key, cfg, device=dev), m, perturb=0.005, key=key)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = sum(v.numel() * v.element_size() for v in params.values())
    pipe = TokenPipeline(cfg.vocab_size, SHARD_SEQ, 1, m, seed=0)
    zero_launches()
    losses, rows = [], []
    for t in range(SHARD_WARM + SHARD_STEPS):
        batch = device_batch(pipe.batch(t), dev)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        params, met = step(params, batch, t)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        rows.append(((time.perf_counter() - t1) * 1e3, torch.cuda.max_memory_allocated(dev),
                     resident))
    cuda = torch.autograd.DeviceType.CUDA
    batch = device_batch(pipe.batch(steps - 1), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, met = step(params, batch, steps - 1)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    work = [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    launches = read_launches()
    for k, v in launches.items():
        if v != want.get(k, 0):
            raise AssertionError(f"phase 27(b): {k} launched {v}, worked out {want.get(k, 0)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"sharded full width: non-finite loss {losses}")
    cols = sharded_screens_exact(params, specs, mesh, topo.adjacency, m)
    print(f"sharded train step, qwen3-4b at full width, 2 layers ({n:,} parameters a node, "
          f"{pbytes} B for M = {m}), mesh (1, 1), all_gather, trimmed mean, b = 1, gossip first, "
          f"seq {SHARD_SEQ}, batch 1 a node: init {init_s:.1f} s; losses "
          f"{[round(x, 6) for x in losses]}")
    for i, (ms, peak, resident) in enumerate(rows):
        print(f"  sharded step {i} ({'warm-up' if i < SHARD_WARM else 'timed'}): {ms:.1f} ms, "
              f"max_memory_allocated {peak} B ({peak / 1e9:.2f} GB), resident before {resident} B")
    timed = [r[0] for r in rows[SHARD_WARM:]]
    print(f"sharded full width: {statistics.median(timed):.1f} ms a step (median of "
          f"{SHARD_STEPS}; {timed}), peak {max(r[1] for r in rows[SHARD_WARM:]) / 1e9:.2f} GB; "
          f"profiled step {prof_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / prof_ms:.1f}%), {len(work)} kernels and copies a step; "
          f"views_screen_trimmed_mean {launches['views_screen_trimmed_mean']} launches ({leaves} "
          f"leaves x {steps} steps, as worked out); the step's screen of every leaf at these "
          f"shapes (M = {m}, b = 1, receivers at stride 0) == the plain screen on the CPU on "
          f"{cols} columns a node (leaves of at most {SHARD_TAIL} whole, wider ones their first "
          f"{SHARD_HEAD} and last {SHARD_TAIL})")
    del params, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sharded_screens_exact(params: dict, specs: dict, mesh, adjacency, m: int) -> int:
    """27(b)'s screens at the main path's own shapes: the step's gossip
    (`coordwise_gossip_leaf`, all_gather, BRIDGE-T, b = 1) of each leaf of
    the final parameters on the card, held exactly against the plain
    screen (`screening.screen_views` over the same rows on the CPU) on
    every column of a leaf of at most SHARD_TAIL columns a node and on the
    first SHARD_HEAD and last SHARD_TAIL of a wider one.  Run after the
    step's launches are read, so they do not count.  Returns the columns
    a node held."""
    from repro_torch.core import screening
    from repro_torch.core.gossip import coordwise_gossip_leaf

    adj_cpu = torch.as_tensor(adjacency)
    adj_dev = adj_cpu.to(params[next(iter(params))].device)
    held = 0
    for k in sorted(params):
        y = coordwise_gossip_leaf(params[k], specs[k], mesh=mesh, node_axes=("data",),
                                  rule="trimmed_mean", b=1, adjacency=adj_dev,
                                  schedule="all_gather").reshape(m, -1)
        x = params[k].reshape(m, -1)
        s = x.shape[1]
        spans = [(0, s)] if s <= SHARD_TAIL else [(0, SHARD_HEAD), (s - SHARD_TAIL, s)]
        for lo, hi in spans:
            xs = x[:, lo:hi].cpu()
            want = screening.screen_views(xs[None].expand(m, m, hi - lo), adj_cpu, xs,
                                          rule="trimmed_mean", b=1)
            exact_or_raise(f"sharded full width screen {k} [{lo}:{hi}]", y[:, lo:hi].cpu(), want)
            held += hi - lo
        del y
    return held


def sharded_phase(dev):
    """Phase 27 (the module docstring's list) in a world of one NCCL rank
    (gloo beside it for the CPU mesh), torn down after; returns the
    phase's launches, the sum of its two runs'."""
    from repro_torch.device import set_numerics
    from repro_torch.launch import mesh as mesh_lib

    set_numerics()
    t_phase = time.perf_counter()
    mesh_lib.init_world(dev.type)
    try:
        a = sharded_gossip_runs(dev)
        t0 = time.perf_counter()
        b = sharded_train_run(dev)
        print(f"(phase 27(b) full width: {time.perf_counter() - t0:.1f} s)")
    finally:
        mesh_lib.close_world()
    print(f"(phase 27 alone: {time.perf_counter() - t_phase:.1f} s)")
    return {k: a[k] + b[k] for k in a}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    secs = build.build()
    print(f"build: {secs:.2f} s nvcc, {len(build.sources())} sources in parallel "
          f"({build.library_path().name})")
    for line in build.ptxas_report().splitlines():
        if line.startswith("# ") or "spill" in line or "registers" in line or (
                "Compiling entry" in line):
            print("ptxas:", line.strip())

    t_start = time.perf_counter()
    records = []
    for phase in (kernel_phase, bucket_boundary_phase, gather_kernel_phase, wide_kernel_phase,
                  dequant_kernel_phase, pairwise_kernel_phase, views_kernel_phase):
        records += phase(dev)
    # each main-path phase zeroes the counts before its runs and reads them
    # after; a kernel's launches are the sum over the phases
    t0 = time.perf_counter()
    codeword_records, codeword_launches = codeword_kernel_phase(dev)
    records += codeword_records
    phase_launches = {"codeword_kernel_phase": codeword_launches}
    print(f"(codeword_kernel_phase: {time.perf_counter() - t0:.1f} s; kernel phases: "
          f"{time.perf_counter() - t_start:.1f} s)")
    for phase in (trainer_phase, sparse_trainer_phase, vector_trainer_phase, sparse_vector_phase,
                  wire_trainer_phase, variants_phase, wide_trainer_phase, net_trainer_phase):
        t0 = time.perf_counter()
        phase_launches[phase.__name__] = phase(dev)
        print(f"({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    # this slice's paths: each phase's kernel records, then its runs
    for phase in (views_kb_phase, grid_phase, net_grid_phase):
        t0 = time.perf_counter()
        phase_records, phase_launches[phase.__name__] = phase(dev)
        records += phase_records
        print(f"({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_launches["codec_grid_phase"] = codec_grid_phase(dev)
    print(f"(codec_grid_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_records, phase_launches["adversary_phase"] = adversary_phase(dev)
    records += phase_records
    print(f"(adversary_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_launches["breakdown_phase"], breakdown_engines = breakdown_phase(dev)
    print(f"(breakdown_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_records, phase_launches["trust_phase"] = trust_phase(dev)
    records += phase_records
    print(f"(trust_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_launches["stream_phase"] = stream_phase(dev)
    print(f"(stream_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_records, phase_launches["zoo_phase"] = zoo_phase(dev)
    records += phase_records
    print(f"(zoo_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_launches["zoo_rest_phase"] = zoo_rest_phase(dev)
    print(f"(zoo_rest_phase: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_launches["sharded_phase"] = sharded_phase(dev)
    print(f"(sharded_phase: {time.perf_counter() - t0:.1f} s)")
    for rec in records:
        if rec["name"].endswith("[E]"):  # this phase's grid engines ran the experiment forms
            rec["launches"] += breakdown_engines.get(rec["name"][:-len("[E]")], 0)
    for name, launches in phase_launches.items():
        print(f"launches in {name}: {({k: v for k, v in launches.items() if v})}")
    for rec in records:
        # a kernel's launches: its wrapper's count over the phases (an
        # experiment-axis form's were set by the grid phase: its engines')
        if not rec["name"].endswith("[E]"):
            rec["launches"] = sum(launches[rec["name"]] for launches in phase_launches.values())
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the main path")
    t0 = time.perf_counter()
    randomness_phase(dev)
    parity_phase(dev)
    print(f"(randomness and parity: {time.perf_counter() - t0:.1f} s; whole script after the "
          f"build {time.perf_counter() - t_start:.1f} s)")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
