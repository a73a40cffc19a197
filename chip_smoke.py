#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (doubly_stochastic_dgp_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check:

0. the card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA kernel from the sources in this checkout (one nvcc per
   source, all started together); raises if a build fails.  Prints each
   kernel's registers and spills (ptxas), resident blocks an SM, the
   fused backward's reduction launch at the MNIST layers' shapes and the
   headline's (dX's, dZ's, dalpha's and the products' tiles, threads,
   shared memory, resident blocks an SM; raises if none fits), the
   psi2 backward's launch plan at both collapsed cells and at (2000, 512,
   2) (raises if its gZ scratch is above 32 MB at N or at 1000 N, or if
   fewer blocks fit an SM than the plan counts on), and the psi2
   forward's, symmetric and general, at both cells and phase 10's shapes
   (micro-tiles, blocks, chunks, stages, scratch, registers, resident
   blocks an SM; raises if no block fits);
1. every kernel (the fused conditional's forward, backward, save-gram
   forward and save-gram backward) against its plain PyTorch version at
   the serving path's per-layer shapes (B=100,000), the training path's
   (B=10,000, M=100, Dx=8, Do=8 and 1), a ragged multi-tile, a
   clamp-active and an M=512 shape, the edges of the tiling (B=1, one
   row past a 40-row block and past a 16-row reduction slice, Do=13, M=1),
   wide inputs through the gram stage's 16-wide chunks (Dx=9, 30 and 784
   at B=1, 41 and 1000, and Dx=785, one past a chunk) and through the
   backward's dX and dZ tiles (Dx=784 at M=37, B=41), in float32, both
   also held against the plain version in float64 on the same inputs.
   Raises if a kernel fails to launch, gives a non-finite value, differs
   from the plain float32 version by more than 1e-4 of the output scale
   (per gradient tensor for the backward), is more than 2x as far from
   float64 as the plain float32 version, gives different bits on a repeat
   launch, or (save-gram forward) differs from the forward's mean and
   var.  Prints the forward's error against float64 under each precision
   design (fp32 FFMA, the kernel; 3xTF32 with per-k-step fp32 sums; 3xTF32
   chained in the tensor core) beside the plain version's, and the
   backward's launch plan at the training shape and at M=512 (raises if
   its slice-partial scratch is above 8 MB or depends on B);
2. the serving path, live: a 5-layer DGP at the headline width
   (kin8nm-shaped synthetic data, N=8192 and D=8, M=100, RBF+White
   inner kernels, Gaussian likelihood 0.05, S=100) built with
   ``DGP.build`` on the card and served by ``make_server(precompute=
   False, batch_buckets=(128, 512, 1000))``: three requests (the 820-row
   test split, 1000 rows, 1300 rows in two chunks), with launch counts
   (the counters from before the server is built: its captures; the
   profiler: the requests' replays), shapes, finiteness, pinned-seed reproducibility, and agreement of the
   live and cached float32 paths with the port's float64 CPU path on a
   small input at fixed draws;
3. the cached server (``precompute=True``) on the same requests, and its
   distance from the live server at the same seeds;
4. timings: the forward kernel at the serving shapes with CUDA events
   (median of 30 launches) and its device time under torch.profiler, its
   plain version, its bound against the fp32 FFMA peak and with its
   products at the 3xTF32 rate, and a GEMM yardstick (torch.matmul of
   its dominant product, (B x M) by (M x Do M), which does not compute
   the same function); per-request latency of the live and the cached
   servers;
5. a torch.profiler breakdown of a request's device time by kernel;
6. the training path, live: the headline model with S=10 samples
   (``DGP.build`` on the card, ``use_pallas=True``) trained by ``fit`` for
   300 Adam steps at minibatch 1000 (10,000 rows per layer a step),
   each chunk of 10 one replay of a captured CUDA graph.  Raises unless
   the counters show 5 forward and 5 backward launches a step in the
   capture's eager warm-up chunk and in the capture, and none in a replay,
   the profiler shows 5 of each a step in a replayed chunk, and the loss
   is finite and lower at the end than at the start.  Then the ELBO gradient at a fixed minibatch and fixed draws on
   the card, in float32 through the kernels and through the plain
   (``use_pallas=False``) path, against the port's float64 CPU path;
   raises if a gradient is not finite or the kernel path's worst
   relative error per parameter tensor is above 2x the plain path's.
   ``evaluate_regression`` on the test split (raises unless RMSE and
   loglik are finite); 60 ``fit`` steps under ``use_pallas='saved'``
   (raises unless finite and 5 save-gram launches of each kind a step,
   counted as above) and under ``False`` (raises if a kernel other than
   rbf_gram launched, or rbf_gram other than 3 times a layer a step); and whether two
   20-step fits from one seed agree bit for bit (printed);
7. timings as in phase 4: each fused kernel and its plain version at the
   training shapes, with its device time, bounds and GEMM yardstick
   (every kernel's record carries ``device_ms`` and
   ``gemm_yardstick_ms``; psi2's yardstick is (M x N) by (N x M),
   rbf_gram's (N x D) by (D x M)); training steps/s of
   ``fit`` for ``use_pallas=True``, ``'saved'`` and ``False``, measured in
   turns;
8. an eager training step's wall time, its host syncs (counted in
   torch's sync debug mode; raises unless 0) and a torch.profiler
   breakdown of its device time: busy, idle share, device ops, top
   device ops;
9. the collapsed DGPs at full width, each built on the card with its
   ``build`` (float32, jitter 1e-5, ``solve_mode='inverse'``; Z by
   k-means, seed 0, as the JAX bench): ``damianou_large`` (DGPDamianou,
   RBF(8) -> RBF(2), M=256, the 7372-row training split) and
   ``collapsed_L2`` (DGPCollapsed, RBF(8) x 2, M=100, the first 1500 rows,
   inner SVGP layer on the fused conditional kernel).  With the launch
   counts set to 0, each evaluates its bound and serves predict_y and
   predict_density on the 820 test rows at S=100 with fixed draws; raises
   unless psi2_core launched once per bound and per prediction (and the
   fused conditional once per bound and twice per prediction for
   DGPCollapsed).  The same on the plain psi2 route (``psi2_impl='xla'``,
   no psi2 launch) and in float64 on the plain route on the card; raises
   if a value is not finite, the kernel route's error against float64
   (bound, predictions) is above 2x the plain route's, or the kernel
   route differs from the plain route in float32 by more than 1e-2 on
   the bound or 5e-2 of scale on the predictions (at the fixed draws, and
   at S=100 draws from one seeded generator on both routes).  Prints the jitter ladder's
   escalations per route, two witnesses of where damianou_large's float32
   error comes from (``solve_mode='solve'``; float64 with psi2 alone in
   float32);
10. the psi2 route on the card (at M=513 and in float64 ``'auto'`` takes
   the plain route, equal to ``'xla'``; ``'pallas'`` raises; no launch),
   then the psi2 kernel against its plain version on the operands the two
   models pass it (captured from ``_rbf_cross_psi2``; raises unless the
   call is symmetric), a ragged N, D=12 (Z from shared memory), M=512, a
   clamp-active case and the tiling's edges (M=1, M=65, N=1, N=33, N=1500
   at M=100), as ``symmetric=True`` wherever the operands are symmetric
   and as ``symmetric=False``, in float32 and float64; raises if it
   differs from the plain float32 version (with the same ``symmetric``)
   by more than 1e-4 of the output scale, is more than 2x as far from
   float64 as the plain float32 version, gives other bits on a repeat
   launch or on launches on two streams at once (eager, and two CUDA
   graphs replayed on two streams), or (symmetric) differs from its
   transpose;
11. timings at both path shapes: the psi2 kernel symmetric (the path's
   call) and general, and its plain version, each with
   CUDA events (median of 30), torch.profiler device time and CUDA-graph
   replays, with the profiler's kernel records counted against the calls
   (eager and in replays), beside the triangle's and the full square's
   bounds and a GEMM yardstick; the kernel at every wt that fits beside
   the wt forward_plan picks (``psi2 forward wt sweep`` lines); one
   bound evaluation and one 820-row S=100 predict_y request per model and
   route; and a torch.profiler breakdown of each on the kernel route;
12. the psi2 backward kernel against its plain version, with a seeded
   dense cotangent, on phase 10's cases plus exact ties (pre == 0 on some
   rows: nothing may pass the gate there) and a row with logdet = -1e30
   (exactly 0 everywhere, no NaN): raises if a gradient tensor differs from
   the plain float32 backward by more than 1e-4 of its scale, is more than
   2x as far from the float64 plain backward as the plain float32 backward
   is, or changes bits on a repeat launch; and its refusals (float64,
   M=513, a cotangent of another shape or not contiguous raise, with no
   launch).  Prints a witness of the gate's discontinuity (the M=512 case
   before its U is shifted away from pre = 0);
13. the bound's gradient on the card at both collapsed cells: float32 on
   the kernel route (psi2 forward and backward kernels, and for
   DGPCollapsed the fused conditional pair) and on the plain route
   (``psi2_impl='xla'``, ``use_pallas=False``) against the port's float64
   CPU path on the same parameters and draws.  Raises unless every
   gradient is finite, one bound and its backward launched each kernel
   once, and at collapsed_L2 the kernel route's worst relative error per
   parameter tensor is within 2x the plain route's (damianou_large's
   float32 bound is known to be unusable, so its errors are printed only);
14. training the collapsed DGPs at full width with ``fit`` (no batch size;
   the reject-nonfinite guard on by ``fit``'s own rule, chunks of 10
   steps): ``collapsed_L2`` for 200 steps on the kernel route, with the
   launch counts set to 0 just before (raises unless the loss is finite
   and lower at the end, psi2 forward and fused conditional forward
   launched once a step plus once a chunk for the guard's verification
   forward, psi2 backward and fused conditional backward once a step, in
   the warm-up and capture chunks by the counters and in a replayed chunk
   by the profiler, and
   ``evaluate_regression`` is finite), the same fit on the plain psi2
   route, and ``damianou_large`` for 100 steps on the kernel route (raises
   unless the final loss and every parameter are finite; prints the
   rejected steps) and 20 on the plain route (for its rate);
15. timings: the psi2 backward kernel, its plain version and its bound at
   both cells' shapes (CUDA events, median of 30); the fits' steps/s per
   route (``fit``'s own per-chunk rate, median); and per model one guarded
   chunk of 8 training steps, graphed: host syncs a step and a
   torch.profiler breakdown (device busy, device ops, idle share, top
   device ops);
16. (run right after phase 1) the rbf_gram kernel, which every RBF gram on
   the card goes through, against its plain version and float64 at the
   cells' Kuf shapes (M=100 x B=10,000 and 100,000, M=256 x N=7372 at D=8
   and 2, M=100 x N=1500), ragged sizes and the square K(X, X) at M=100 and
   B=200, and the wide kernel's (D > 8: D=9, 30, a ragged D=37, the MNIST
   Kuu and Kuf at D=784, D=100 with a partial last chunk, the square gram
   at D=30 and 784), in float32 and float64: raises if it differs from the
   plain version by more than 1e-4 of scale, (float32) is more than 2x as far
   from float64 as the plain float32 version, changes bits on a repeat, if
   K(X, X) is not bitwise symmetric with its diagonal exactly var, or if
   the backward through the Function differs from autograd through the
   plain version by more than 1e-4 of scale per gradient tensor; its
   refusals raise with no launch, and its C entry point refuses a plan
   other than launch_plan's; CUDA-event and profiler times beside the
   bound and the plain version's;
17. the slice's main path, the DGP under the default numerics
   (solve_mode='solve', use_pallas=False): the headline model built with
   ``Config(dtype=float32, jitter=1e-5)``, fit for 100 steps with the
   launch counts at 0 (raises unless rbf_gram launched 15 times a step,
   3 a layer, in the warm-up and capture chunks by the counters and in a
   replayed chunk by the profiler, nothing else launched, and the loss is finite and falls),
   then with ``Config()`` itself (float64) for 20 steps (finite),
   ``evaluate_regression``, and the ELBO gradient against the float64 CPU
   path through the kernel and through the plain gram (inside
   ``gram.plain_on_card()``, which only this script enters): raises unless
   the kernel's worst error is within 2x the plain gram's;
18. steps/s of fit on the solve route beside the inverse route, in turns,
   a profiled step of each, and the device busy a step of the three
   routes (use_pallas=True, use_pallas=False, solve) side by side;
19. full covariances of the trained model at 200 test rows, S=10, fixed
   draws: predict_f_full_cov and predict_all_layers_full_cov against the
   float64 CPU path (layer 0 within 5e-3; every layer within 2x the plain
   gram's error), the first layer's diagonal against the diagonal route,
   every (N, N) slice symmetric, latencies; the same parameters and draws
   in float32 on the CPU, whose error per layer against float64 is printed
   beside the card's (cuSOLVER against LAPACK); and predict_f_full_cov of
   DGPCollapsed at collapsed_L2 (finite, symmetric);
20. the one-program dispatch (after phase 15): the sync-free Cholesky
   rung selection's device time (every rung in one batched
   ``cholesky_ex``) beside one factorization and one call a rung, each
   captured in a CUDA graph and timed over its replays with CUDA events
   (the profiler's sum beside it), and whether its first rung keeps
   ``torch.linalg.cholesky``'s bits; then on
   four routes (the headline DGP with ``use_pallas=True`` and on the
   solve route, damianou_large and collapsed_L2 with fit's guard) 50
   ``fit`` steps graphed and inside ``graphs.eager_on_card()`` from one
   seed (raises unless the parameters agree bit for bit or within 1e-4
   of each tensor's scale), then 4 chunks of 10 steps of each in turns:
   steps/s (median), every replay under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), a
   profiled chunk of each (device busy, device ops, idle share and each
   kernel's launches a step; profiled again if the profiler saw no device
   time, and raises if it never does; raises unless the graphed idle
   share is below the eager one, and unless each kernel's launches a step
   in the graphed replay, by the profiler, equal the eager chunk's by the
   counters, and a replay ticks no counter) and the graph's memory pool;
21. a guarded chunk of the headline DGP with 5 NaN training rows for one
   chunk of three, graphed and eager: raises unless it rejects steps,
   keeps a finite state, recovers in the next chunk, and graphed equals
   eager bit for bit;
22. 1000-row S=100 requests to the live and cached servers, graphed and
   eager in turns: latency (median of 7), pinned seeds bit for bit
   between the two (raises otherwise), replays under sync debug 'error',
   the graph pool the server's buckets share;
23. ``fit`` for 20 steps with ``ckpt_dir``, a fresh model resumed from the
   checkpoint to 40, against 40 straight steps: raises unless bit for
   bit;
24. (run right after phase 11) both collapsed models under ``Config()``
   (float64, ``psi2_impl='auto'``) on the card: the bound against the
   port's float64 CPU bound on the same parameters (raises above 1e-6
   relative), an 820-row S=100 predict_y, and for damianou_large 20 fit
   steps, with no psi2 kernel launch (raises otherwise);
   ``psi2_impl='pallas'`` raises before a launch; the bound's, the
   request's and a step's times;
25. classification with the paper's MNIST DGPs (DGP2 784 -> 30 -> 10 and
   DGP3 784 -> 30 -> 30 -> 10, robust-max ``MultiClass(10)``, M=100,
   RBF(2.0, 2.0), float32, jitter 1e-5, ``solve_mode='inverse'``,
   ``use_pallas=True``) on MNIST-shaped data made from ``--seed`` (60,000
   training and 10,000 test rows of 784 pixels in [0, 1], labels
   learnable through the PCA; through ``load_mnist_npz``).  The main path
   of each model, the launch counts at 0 just before it and read just
   after (raises unless the fused pair and rbf_gram launched): ``fit``
   300 graphed steps (lr 0.01, minibatch 1000, S=1; raises unless the
   loss falls and the fused launches a step are L forward and L backward,
   by the counters on the eager chunks and by the profiler on a replay),
   ``evaluate_classification`` on the test rows at S=100 (raises unless
   finite and above the untrained model's accuracy), and 1000-row S=100
   ``predict_y`` requests live and cached (graphed against eager bit for
   bit at a pinned seed, replays under sync debug 'error', latency).  On
   the trained parameters: the ELBO gradient against the float64 CPU path
   (the fused route's worst relative error <= 2x the ``use_pallas=False``
   route's), the class probabilities at fixed draws within 5e-3 of
   float64, and graphed steps/s of both routes in turns.  Then the fused
   pair at (1000, 100, Dx=784, Do=30), (1000, 100, 30, 30), (1000, 100,
   30, 10) and its forward at the serving shape (100,000, 100, 784, 30),
   and rbf_gram at (100 x 784) and (1000 x 784 against 100 x 784), on
   random operands with O(1) scaled distances and on the trained DGP3's,
   under phase 1's gates, each timed beside its bound and GEMM
   yardsticks.

26. the rest of the model surface at the headline shape (float32, jitter
   1e-5, ``solve_mode='inverse'``, minibatch 1000, S=10, graphed ``fit``
   chunks of 10), each model's main path (``fit`` from its build state,
   ``evaluate_regression``, ``make_server`` requests) with the launch
   counts at 0 just before it and read just after: ``DGPHeteroscedastic``
   (5 layers, the last with a mean and a log-noise head) and the
   input-propagation stack (``init_layers_input_prop``: RBF(8), then
   RBF(16) x 4, on ``DGPBase``), each ``use_pallas=True`` for 300 steps
   (raises unless 5 fused forward and 5 fused backward launches a step,
   counted as phase 6, a finite and falling loss, the ELBO gradient within
   phase 6's 2x rule, finite test metrics, and 1000-row S=100 requests
   live and cached graphed against eager bit for bit; the heteroscedastic
   model's ``predict_density`` of shape (N, 1); the input-propagation
   fused calls at Dx 8 then 16, and the inner layers' outputs (S, N, 16)
   whose first 8 columns are the input bit for bit); the DGP on Matern52
   kernels, 300 steps (raises if a fused or rbf_gram launch happens,
   unless the loss falls, its float32 predictions at fixed draws are
   within phase 2's 5e-3 of float64, and its requests graphed equal
   eager); ``DGPQuad`` (RBF(8) + White to width 1, then RBF(1), H=100:
   100,000 rows a layer at minibatch 1000; raises unless two bound
   evaluations give the same bits, the float32 bound and gradient on the
   kernel route are within 2x of the plain route's error against the
   float64 CPU path, and 100 graphed steps lower the bound with the fused
   pair twice a step); collapsed_L2 with a ``Sum(RBF(8), Linear(8,
   ard=True))`` collapsed kernel (raises unless psi2 forward launches once
   a bound and psi2 backward once a gradient, the kernel route against
   ``psi2_impl='xla'`` against float64 passes phase 9's and phase 13's
   rules, and 60 guarded graphed steps are finite and lower).  Each
   model's graphed steps/s (both routes in turns, where it has two),
   device busy a step and request latency are printed with the card.

27. natural gradients, L-BFGS and the single-layer baselines (float32,
   jitter 1e-5, ``solve_mode='inverse'``), each sub-phase's main path with
   the launch counts at 0 just before and read just after.  27a: the
   headline DGP trained by ``fit(natgrad_gamma=0.1, ng_layers=(-1,))``
   for 300 steps (raises unless the loss is finite and falls, the last
   layer's q moves, and the launches a step are 10 fused forwards, 6 fused
   backwards and 20 rbf_gram); ``natgrad_update`` on the trained last
   layer in float32 on the card within 2x the CPU float32 error against
   float64, and its device time; 2 chunks graphed against eager bit for
   bit; NatGrad+Adam and Adam-only chunks replayed in turns under sync
   debug 'error' (steps/s, device busy, idle share; an eager chunk's
   launches by the counters equal to a replayed one's by the profiler);
   the full-data loss after 100 steps of each from one state; the fused
   pair and rbf_gram on the trained model's operands on a training
   minibatch under phase 1's gates.  27b: one
   gamma = 1 natural step in float64 on the card lands on the collapsed
   bound (SVGP on SGPR, rtol 1e-8; DGPQuad(H=200) on DGPCollapsed, rtol
   1e-7).  27c: the UCI notebook's baselines at the kin8nm shape (M=100,
   kmeans2 Z): SGPR and GPRFITC by ``lbfgs_minimize`` (at most 100
   iterations; raises unless the loss is finite and falls, and unless,
   over 8 parameter points, the card's float32 bound's median error
   against float64 is within 2x the CPU float32 bound's median and its
   worst error within 2x the CPU's worst; the ratio at the trained point
   alone is printed, not gated), SVGP by 300 Adam steps (the fused route), a
   GPR on 1000 rows; test rmse and loglik; the fused pair and rbf_gram on
   the operands each trained model hands them (SVGP's at B=1000, Do=1;
   SGPR's and FITC's Kuu and Kuf at 100 x 7372; GPR's K(X) at 1000 x
   1000) under phase 1's gates.  27d: ``make_server(precompute=True)`` on
   SGPR, GPRFITC, the GPR and phase 9's collapsed_L2 and damianou_large:
   cached against live (5e-3, or 5e-2 of scale for the collapsed DGPs at
   fixed draws), 1000-row requests graphed against eager bit for bit,
   latency cached against live; the kernels on a 1000-row request's
   operands, live and cached, under phase 1's gates (the forward).

28. MCMC and the rest of serving (float32, jitter 1e-5), each sub-phase's
   main path with the launch counts at 0 just before and read just after.
   28a: ``sgpmc_headline``, HMC over the 3300 inducing values of the
   headline stack built as ``init_layers_linear`` builds it with each
   layer an ``SGPMCLayer(white=True)`` (``use_pallas=True``), target
   ``elbo`` at fixed draws plus ``log_prior``, full batch (7372 rows),
   S=1, 10 leapfrog steps, initial step 0.01 adapted, 100 burn-in + 100
   samples, chunks of 10 iterations each one captured graph: 20
   iterations graphed against eager from one seed (raises unless bit for
   bit or within 1e-4 of scale), the chain with every replay under sync
   debug 'error', chunks graphed and eager in turns (iterations/s, device
   busy a gradient, idle share; raises unless an eager chunk's launches
   by the counters and a replayed chunk's by the profiler are 5 fused
   forwards, 5 fused backwards and 5 rbf_gram a gradient), accept rate,
   step size, ESS min and median; the fused pair (Do = 8 with the
   broadcast W, and Do = 1) and rbf_gram on one gradient's operands
   under phase 1's gates.  28b: a single ``SGPMCLayer(white=True)``,
   M=100, on the 7372 rows, whose target is exactly Gaussian: HMC (300 +
   1000, 5 leapfrog steps, the trajectory's closest approach to a whole
   turn in any eigen-direction printed) and NUTS (``max_depth=6``, 200 + 600) on the card recover the
   float64 closed-form mean within 4.5 max sd / sqrt(ESS min) and the
   marginal sds within 25% (raises otherwise, or on a post-warmup NUTS
   divergence); the NUTS host reads a transition.  28c: ``DGPHeinonen``
   on the first 1000 rows (tests/test_zoo.py's recipe on RBF kernels):
   NUTS over the GPMC layer's q_mu (raises unless finite and moving),
   ``make_server`` cached against live within 5e-3 and graphed equal to
   eager, rbf_gram on the 1000 x 1000 Kuf of a request and on the GPR K
   under phase 1's gates.  28d: ``DynamicPredictor`` on the headline DGP
   of phases 2-3: S in (1, 5, 25, 100) over buckets (1, 8, 32, 128),
   raises unless one capture a bucket used (4) and the kept samples equal
   ``make_server``'s at the bucket size and seed bit for bit; latency of
   each S beside ``make_server``'s at S=100.  28e: ``export_predict_y`` of
   that DGP at 1000 rows and S=100, live and ``precomputed=True``, saved,
   loaded and run in a fresh process that imports only the port's
   ``ops.cuda``: raises unless equal to the model bit for bit or within
   1e-6 of scale, and (live) the profiler sees 5 fused forwards.
29. data parallelism over torch.distributed (``parallel/``), the kernels
   built by this process before any rank starts; each main path with the
   launch counts at 0 just before and read just after.  29a: a one-rank
   NCCL group on cuda:0: ``fit_dp`` on the headline DGP (5 layers, M=100,
   batch 1000, S=10, ``use_pallas=True``, graphed chunks of 10) for 100
   steps against ``fit`` from the same seed (raises unless bit for bit or
   within 1e-5 of scale, unless every chunk went as a graph, and unless
   the counters show fit's 5 fused forwards, 5 backwards and 10 rbf_gram
   a step over the warm-up and capture chunks); the captured chunk's
   all-reduces, by the profiler's host records at its warm-up and
   capture (raises unless NCCL's own record counts one a step, and the
   c10d op's counts the warm-up's steps once and the capture's twice);
   a replay's launches by the profiler (fit's; a one-rank in-place NCCL
   sum launches no kernel, so the collective's device work is printed,
   not checked), every replay under sync debug 'error'; steps/s of
   fit_dp's and fit's chunks, 4 each in turns; and the NCCL gather
   (``all_gather``: ``all_gather_into_tensor``, its backward a
   ``reduce_scatter_tensor``) on one rank, raising unless it returns its
   input and the gradient bit for bit.  29b: two gloo ranks sharing cuda:0, spawned by this script
   (every collective, and the run, bounded by a timeout; a rank that
   fails or hangs fails the phase): ``dp_elbo`` and its gradient at 1001
   rows (padded) and fixed draws against the single-process float32
   ``elbo`` (raises unless within 1e-5 of scale or 2x the float32
   error against float64, and unless the ranks agree bit for bit); 20
   ``fit_dp`` steps (ranks bit for bit); ``dp_predict_y`` at 1000 rows,
   S=100, against the single-process moments of the same draws;
   ``dp_evaluate_regression`` on 821 rows (padded) against
   ``evaluate_regression`` on the ranks' draws; ``dp_damianou_elbo`` at
   damianou_large and ``dp_collapsed_elbo`` at collapsed_L2 on the psi2
   kernel route (raises unless one psi2 forward a rank a bound and the
   bound within a tenth of the single-process float32 bound's error
   against float64, or 1e-5 of scale, of that float32 bound) and in
   float64 on the plain route (raises unless within 1e-9 of the
   single-process float64 bound: the data-parallel algebra), and one step of each model's data-parallel train step
   (raises unless the loss is finite, the replicated parameters agree
   across the ranks bit for bit, and one psi2 backward ran a rank); two
   HMC chains of 28b's target, one a rank, against
   ``hmc_sample_chains`` in one process, no mesh, from the same
   generator (raises unless bit for bit).  29c: a (data 1 x sample 2) mesh on the
   same ranks: ``sp_elbo`` at fixed draws against the single-process
   ``elbo`` (the gate of 29b), and 10 ``fit_dp(sample_axis='sample')``
   steps (ranks bit for bit).  Prints the phase's time.
30. output-dimension and pipeline parallelism (``parallel/outdim.py``,
   ``parallel/pp.py``), on the same groups.  30c, in 29a's one-rank NCCL
   group: ``outdim_elbo`` over a dim axis of 1 on mnist_DGP2 and
   ``pp_elbo`` over 1 stage on the headline DGP against ``elbo`` on the
   same draws (raises unless bit for bit or within 1e-5 of scale;
   prints which).  30a and 30b on 29b's two gloo ranks, each with the
   launch counts at 0 just before and read just after: 30a, outdim on
   mnist_DGP2 (784 -> 30 -> 10, MultiClass(10), M=100, batch 1000, S=1,
   ``use_pallas=True``, phase 25's data) over a dim axis of 2, each rank
   holding 15 and 5 of the layers' latent dims; 30b, pp on the headline
   DGP (batch 1000, S=10), ``pp_stack(split_final=True)``: its 4-layer
   trunk over 2 stages, 4 microbatches of 250, the head replicated.
   Each: the objective and its gradient at fixed draws on the whole
   model, and on a data 1 x ... mesh (the value), against this
   process's float32 ``elbo`` on the same draws and route (29b's gate),
   the ranks bit for bit; 20 eager steps of ``make_outdim_train_step`` /
   ``make_pp_train_step`` on the model placed by ``outdim_shard`` /
   ``pp_shard`` (raises unless the loss is finite and falls, the
   replicated leaves agree across the ranks bit for bit, and each
   sharded leaf holds half its whole bytes), with steps/s; the launches
   a rank against the counts derived from the code (30a: 2 fused
   forwards and 4 ``rbf_gram`` an evaluation, 2 backwards a gradient;
   30b: 15 fused forwards and 18 ``rbf_gram`` an evaluation, 15
   backwards a gradient); and every fused call and distinct gram of an
   evaluation on each rank's own operands, sent back by the rank, under
   phase 1's gates as phase 26 holds its models' (Do=15 and Do=5 at
   Dx=784 and 30; B=2500).  Prints the phase's time.
31. the torch demos (``demos_torch/``) and ``with_config``.  31a: each
   demo in-process at its default device (the card), through its
   ``run``, the launch counts at 0 just before and read just after:
   ``run_regression kin8nm 5 0 --synthetic`` at the reference harness's
   width (5 layers, M=100, S=1, minibatch 10000: the whole 7372-row
   split) cut to 100 iterations, logged every 50; ``mnist --synthetic
   --layers 2`` (784 -> 30 -> 10, M=100, minibatch 1000) for 200
   iterations, and again with ``--data-parallel`` on a one-rank NCCL
   group; ``damianou --n 1500 --dims 4 --inducing 50`` for 100
   iterations (float32: the psi2 kernel route, in its collapsed SGPR
   and its Damianou DGP); the other demos at
   tests/test_demos.py's arguments (step_function 200 iterations and
   natural_gradients 100, so that their logs show the loss fall), and
   ``uci_benchmark --iterations 400 --max-layers 2 --num-inducing 50
   --eval-samples 10`` and ``collapsed --iterations 50``.  Raises unless
   each returns, every number in its summary is finite, the loss falls
   where it trains, its launches equal the counts derived from the code
   (``rbf_gram`` in every demo with an RBF kernel, the psi2 pair in
   damianou; one or more where the count depends on the data: L-BFGS,
   the samplers, torch.export; no fused launch in any demo), the serving
   demo's reloaded program equals the model bit for bit (or within 1e-6
   of scale), and collapsed's gamma = 1 identity holds within its own
   bound (float64 on the card).  31b: ``with_config(m, use_pallas=True)``
   of the trained run_regression model: a 1000-row S=100 request at
   fixed draws through the copy and the original against the float64
   CPU path (raises unless the copy is within 5e-3 and within 2x the
   original's error, with 5 fused forwards on the copy and none on the
   original), then 40 graphed ``fit`` steps of the copy and of
   ``with_config(m, use_pallas='saved')`` (phase 6's launch rule by the
   counters and a profiled replay); raises unless the original's
   parameters and buffers, and its server's answer, are bit for bit as
   before.  Prints each demo's launches and wall seconds, and the
   ``summary`` table of the card model.

It prints a ``{"kernels": [...]}`` line (seven records: forward, backward,
save-gram forward, save-gram backward, psi2 forward, psi2 backward,
rbf_gram; the fused pair's and rbf_gram's also with phase 25's shapes and
launches; every record with ``extra_launches``, each phase-26 model's
main-path launches, ``natgrad_launches``, phase 27's by sub-phase, and
``mcmc_launches``, phase 28's, and ``parallel_launches``, phase 29's and
30's (``outdim_mnist``, ``pp_headline``, the two ranks' sum), and
``demo_launches``, each phase-31 demo's, and ``with_config_launches``,
31b's; the fused
pair's and rbf_gram's also with phase 27's, phase 28's and phase 30's
worst errors),
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

import argparse
import contextlib
import copy
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from doubly_stochastic_dgp_tpu_torch import (  # noqa: E402
    DGP, RBF, Config, DGPBase, DGPCollapsed, DGPDamianou, DGPHeinonen,
    DGPHeteroscedastic, DGPQuad, DynamicPredictor, Gaussian, GPMCLayer,
    GPRLayer, Identity, Linear, LinearKernel, Matern52, MultiClass,
    SGPMCLayer, SyntheticRegression, White, Zero, effective_sample_size,
    evaluate_classification, evaluate_regression, export_predict_y, fit,
    hmc_sample, init_layers_input_prop, init_layers_linear, load_mnist_npz,
    log_prior, make_server, nuts_sample, precompute)
from doubly_stochastic_dgp_tpu_torch.training.hmc import (  # noqa: E402
    CHUNK, HMCChains)
from doubly_stochastic_dgp_tpu_torch.ops import psi_stats  # noqa: E402
from doubly_stochastic_dgp_tpu_torch.ops.cuda import (  # noqa: E402
    build, gram, psi2)
from doubly_stochastic_dgp_tpu_torch.ops.cuda import (  # noqa: E402
    conditional)
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (  # noqa: E402
    backward_plan, flops, flops_bwd, forward_plan, fused_conditional,
    fused_conditional_backward, fused_conditional_backward_plain,
    fused_conditional_forward, fused_conditional_plain,
    fused_conditional_saved, fused_conditional_saved_plain)
from doubly_stochastic_dgp_tpu_torch.ops.linalg import (  # noqa: E402
    safe_cholesky_ladder)
from doubly_stochastic_dgp_tpu_torch.utils.timing import (  # noqa: E402
    timed_per_call_stats)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
FP32_PEAK = 67e12          # FLOP/s, fp32 outside the tensor cores
FP64_PEAK = 34e12          # FLOP/s, fp64 outside the tensor cores
TF32_PEAK = 495e12         # FLOP/s, TF32 on the tensor cores; 3xTF32 takes
                           # three products for each fp32-accurate one
HBM_RATE = 3.35e12         # bytes/s
# exp results/s of the SFUs: 132 SMs x 16 a clock (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0: exp2 and
# the other transcendentals) x the 1.98 GHz boost clock
SFU_EXP_RATE = 132 * 16 * 1.98e9
LAYERS, M, S = 5, 100, 100
BUCKETS = (128, 512, 1000)
# training: S=10 samples, minibatch 1000, so 10,000 rows per layer a step
TRAIN_S, BATCH, TRAIN_STEPS = 10, 1000, 300
# fit's chunk of steps (log_every here), one replay of a captured graph
FIT_CHUNK = 10
# on the card fit captures its chunk as a CUDA graph: an eager warm-up
# chunk, run from a snapshot that it restores (no step, but real
# launches), then the capture, whose launches go into the graph.  The
# counters count both chunks' launches and nothing of the replays, which
# run no wrapper; the profiler counts a replay's kernels (LAUNCH_MARKER)
FIT_CAPTURE_CHUNKS = 2
# (name, source, the TPU kernel it replaces, the launch counter's owner and
# attribute)
_COND = "doubly_stochastic_dgp_tpu/ops/pallas/conditional.py"
KERNELS = (
    ("fused_conditional", "fused_conditional.cu", f"{_COND}:206",
     fused_conditional, "launches"),
    ("fused_conditional_backward", "fused_conditional_bwd.cu",
     f"{_COND}:390", fused_conditional, "backward_launches"),
    ("fused_conditional_saved", "fused_conditional.cu", f"{_COND}:166",
     fused_conditional_saved, "launches"),
    ("fused_conditional_saved_backward", "fused_conditional_bwd.cu",
     f"{_COND}:239", fused_conditional_saved, "backward_launches"),
    ("psi2_core_forward", "psi2.cu",
     "doubly_stochastic_dgp_tpu/ops/pallas/psi2.py:240", psi2.psi2_core,
     "launches"),
    ("psi2_core_backward", "psi2_bwd.cu",
     "doubly_stochastic_dgp_tpu/ops/pallas/psi2.py:305", psi2.psi2_core,
     "backward_launches"),
    ("rbf_gram", "rbf_gram.cu",
     "doubly_stochastic_dgp_tpu/ops/pallas/gram.py:67", gram.rbf_gram,
     "launches"),
)
KERNEL_NAMES = [k[0] for k in KERNELS]
# the device kernels of each record's launch, as torch.profiler names them
DEVICE_KERNELS = {
    "fused_conditional": ("fused_conditional_fwd_kernel",),
    "fused_conditional_saved": ("fused_conditional_fwd_kernel",),
    "fused_conditional_backward": ("fused_conditional_bwd",
                                   "sum_slices_kernel"),
    "fused_conditional_saved_backward": ("fused_conditional_bwd",
                                         "sum_slices_kernel"),
    "psi2_core_forward": ("psi2_fwd_kernel",),
    "psi2_core_backward": ("psi2_bwd_kernel", "psi2_bwd_finish_kernel"),
    "rbf_gram": ("rbf_gram_kernel",),
}
# the device kernel that one launch of each record's wrapper runs once, as
# torch.profiler names it: what a graph replay's launches are counted by
LAUNCH_MARKER = {
    "fused_conditional": "fused_conditional_fwd_kernel<false,",
    "fused_conditional_saved": "fused_conditional_fwd_kernel<true,",
    "fused_conditional_backward": "fused_conditional_bwd_rows_kernel<false,",
    "fused_conditional_saved_backward":
        "fused_conditional_bwd_rows_kernel<true,",
    "psi2_core_forward": "psi2_fwd_kernel",
    "psi2_core_backward": "psi2_bwd_kernel",
    "rbf_gram": "rbf_gram_kernel",
}
# device ms a launch of the redesigned kernels' earlier designs (two
# passes over the terms; lengthscales divided out by separate device ops),
# from this script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section
# 6), printed beside this run's
EARLIER_DEVICE_MS = {
    # the psi2 forward's first design (64 x 64 tiles of the full square,
    # its chunks added by a second kernel; removed): CUDA-graph replays of
    # its two kernels, the last measurement before its removal
    ("psi2_core_forward", "damianou_large"): "0.2360-0.2371",
    ("psi2_core_forward", "collapsed_L2"): "0.0359-0.0365",
    ("psi2_core_backward", "damianou_large"): "0.9711-1.0036",
    ("psi2_core_backward", "collapsed_L2"): "0.1081-0.1115",
    ("rbf_gram", "Kuf_M100_B10000_D8 float32"): "0.0061-0.0064",
    ("rbf_gram", "Kuf_M100_B100000_D8 float32"): "0.0481",
    # the wide gram before the staged, cluster-split kernel (one thread 4 x
    # 4 outputs over every d from L1, Kahan per term) and the fused forward
    # before the tiled gram stage (one thread a gram entry from L1): the
    # MNIST shapes, CUDA-graph replays (PERF.md §6, rows 1 and 5)
    ("rbf_gram", "mnist Kuu_M100_D784"): "1.7105",
    ("rbf_gram", "mnist Kuf_B1000_M100_D784"): "1.7212",
    # the fused pair's row kernels before their cluster plan at small B
    # (one block of 40 rows a row block: 25 blocks at B = 1000), by
    # CUDA-graph replays in turns with this tree's in one call
    # (tools/backward_bitwise.py; PERF.md §6, rows 1 and 3)
    ("fused_conditional", "mnist layer0_Dx784_Do30"): "0.3415-0.3420",
    ("fused_conditional", "mnist hidden_Dx30_Do30"): "0.2477-0.2480",
    ("fused_conditional", "mnist last_Dx30_Do10"): "0.0936",
    # the MNIST serving forward (B = 100,000: no cluster, so the same code
    # in both designs): this script's own reading in an earlier run of it
    # (PERF.md §6, row 1), by CUDA-graph replays but not in turns
    ("fused_conditional", "mnist serving_Dx784_Do30"): "5.1551",
    ("fused_conditional_backward", "mnist layer0_Dx784_Do30"):
        "0.5220-0.5244",
    ("fused_conditional_backward", "mnist hidden_Dx30_Do30"):
        "0.4049-0.4052",
    ("fused_conditional_backward", "mnist last_Dx30_Do10"): "0.1997-0.1998"}
# kernel vs plain float32 on the same inputs: both are float32 with
# different summation orders, so they may differ by float32 roundoff
# amplified by the staged products; relative to the output scale
KERNEL_VS_PLAIN_RTOL = 1e-4
# the live float32 path on the card vs the port's float64 CPU path on a
# small request (5 layers of float32 staging and cancellation)
F32_PATH_ATOL = 5e-3
# the collapsed models' psi2 kernel route vs their plain psi2 route, both
# float32 on the same parameters and draws (bound relative to its
# magnitude, predictions relative to each output's scale).  The routes
# differ only in psi2's rounding, which damianou_large's (M, M) algebra
# amplifies: on an H100 the gaps there were 3.7e-3 (bound) and 1.3e-2
# (predictions), while a wrong psi2 moves both by O(1)
ROUTE_GAP_RTOL = {"bound": 1e-2, "predictions": 5e-2}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counts():
    return {name: getattr(owner, attr)
            for name, _, _, owner, attr in KERNELS}


def set_launch_counts(counts):
    for name, _, _, owner, attr in KERNELS:
        setattr(owner, attr, counts[name])


def device_launches(prof):
    """{record: its launches in a torch.profiler profile}: the device
    kernels named by its LAUNCH_MARKER, a graph replay's included."""
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    return {name: sum(e.count for e in events if marker in e.key)
            for name, marker in LAUNCH_MARKER.items()}


# the profiler can lose a kernel's record: twice in about 25 runs of this
# script on an NVIDIA H100 80GB HBM3 it counted 39 of the 40 rbf_gram
# launches of phase 26's replayed quad chunk.  A launch count by the
# profiler that differs from what the counters expect is taken again on
# the next replay, up to PROFILE_TRIES profiles in all, each retry
# printed; a CUDA graph replays the same kernels every time, so a launch
# that the path really lacks or adds fails every try
PROFILE_TRIES = 3
# uncounted launches at a profile's start: with 8 of them, a whole run of
# this script on an NVIDIA H100 80GB HBM3 still lost the first rbf_gram of
# 27c's replayed SVGP chunk on all 3 tries (PERF.md, section 6)
SHIELD_LAUNCHES = 64


def shield_profile():
    """Uncounted device work at a profile's start: the profiler can drop a
    profile's first device records (PERF.md §6), so give it some to drop
    before the profiled run, whose first kernel may be a counted one."""
    for _ in range(SHIELD_LAUNCHES):
        torch.ones(1, device="cuda").add_(1.0)
    torch.cuda.synchronize()


class ProfiledChunk:
    """A ``fit`` callback that profiles the chunk between its first two
    calls (log boundaries), on the card one replay of the captured chunk:
    ``launches`` is then :func:`device_launches` of that chunk.  ``fit``
    reads the loss (a host sync) before it calls back, so the chunk's
    device work has ended by then.  The counters at the first call hold
    the warm-up and capture chunks (FIT_CAPTURE_CHUNKS of them); while a
    profiled replay's launches differ from one chunk's share of them, the
    next chunk is profiled, up to PROFILE_TRIES in all (``tries``)."""

    def __init__(self):
        self.prof, self.launches, self.calls = None, None, 0
        self.counts, self.tries = None, 0

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        shield_profile()
        self.tries += 1

    def __call__(self, step, model, loss, stats):
        self.calls += 1
        if self.calls == 1:
            self.counts = launch_counts()
            self._start()
        elif self.prof is not None:
            torch.cuda.synchronize()
            self.prof.stop()
            self.launches = device_launches(self.prof)
            self.prof = None
            chunks = {n: FIT_CAPTURE_CHUNKS * v
                      for n, v in self.launches.items()}
            if chunks != self.counts and self.tries < PROFILE_TRIES:
                print(f"profiled chunk (try {self.tries}): the profiler "
                      f"counted {self.launches}, the counters "
                      f"{self.counts} over {FIT_CAPTURE_CHUNKS} chunks; "
                      f"profiling the next chunk", flush=True)
                self._start()

    def close(self):
        """Stop a profile the fit's end left open (its chunk never came)."""
        if self.prof is not None:
            self.prof.stop()
            self.prof = None


def event_ms(fn, reps=30):
    """Median over ``reps`` warm runs, each timed with CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def conditional_inputs(B, M_, Dx, Do, seed, clamp=False, spread=1.0):
    """float32 inputs on the card in the kernel's contract (staged LiT,
    symmetric W), drawn from a seeded numpy stream; X and Z with std
    ``spread`` (1 / sqrt(Dx) keeps the scaled distances O(1) at any
    Dx)."""
    rng = np.random.RandomState(seed)
    LiT = np.eye(M_) + 0.1 * rng.randn(M_, M_)
    Wh = rng.randn(Do, M_, M_) * 0.1
    W = (Wh + np.swapaxes(Wh, 1, 2)) / 2
    if clamp:
        W = -np.einsum("dij,dkj->dik", Wh, Wh) * 20.0
    arrays = (rng.randn(B, Dx) * spread, rng.randn(M_, Dx) * spread, LiT,
              rng.randn(M_, Do) * 0.3, W, np.float64(1.4),
              np.float64(1.4 + 2e-6))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def cotangents(B, Do, seed):
    rng = np.random.RandomState(seed + 7)
    return [torch.tensor(rng.randn(B, Do), dtype=torch.float32,
                         device="cuda") for _ in range(2)]


def compare(got, plain, ref, joint_scale):
    """(max |kernel - plain|, and the three errors relative to the output
    scale: kernel vs plain, kernel vs f64, plain f32 vs f64).  The scale
    is max(max |ref|, 1) over all outputs (joint_scale, the forward's rule)
    or per output tensor (the gradients, whose scales differ by orders)."""
    scales = [max(r.abs().max().item(), 1.0) for r in ref]
    if joint_scale:
        scales = [max(scales)] * len(scales)
    abs_err, err, e_k, e_p = 0.0, 0.0, 0.0, 0.0
    for g, p, r, sc in zip(got, plain, ref, scales):
        check(bool(torch.isfinite(g).all()), "kernel output not finite")
        a = (g - p).abs().max().item()
        abs_err = max(abs_err, a)
        err = max(err, a / sc)
        e_k = max(e_k, (g.double() - r).abs().max().item() / sc)
        e_p = max(e_p, (p.double() - r).abs().max().item() / sc)
    return abs_err, err, e_k, e_p


def hold(name, case, errs, floor=False):
    """The kernel within KERNEL_VS_PLAIN_RTOL of scale of its plain
    version, and within 2x the plain float32 error against float64.  With
    ``floor`` (a model's own operands, on which float32 itself can be far
    off float64) the first tolerance is the larger of KERNEL_VS_PLAIN_RTOL
    and the plain float32 error against float64."""
    abs_err, err, e_k, e_p = errs
    tol = max(KERNEL_VS_PLAIN_RTOL, e_p) if floor else KERNEL_VS_PLAIN_RTOL
    print(f"kernel {name} {case}: |kernel-plain| {abs_err:.3e} "
          f"({err:.3e} of scale), kernel vs f64 {e_k:.3e}, plain f32 vs "
          f"f64 {e_p:.3e} (of scale)"
          + (f"; kernel vs plain gate {tol:.3e}" if floor else ""),
          flush=True)
    check(err <= tol,
          f"{name} {case}: kernel vs plain {err} > {tol} of the output "
          f"scale")
    check(e_k <= 2.0 * e_p,
          f"{name} {case}: kernel error vs f64 {e_k} > 2x the plain f32 "
          f"error {e_p}")


def check_repeat(name, case, fn, first):
    again = fn()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{name} {case}: two launches on the same inputs differ")


KERNEL_CASES = [("serving_Do8", 100000, M, 8, 8, False),
                ("serving_Do1", 100000, M, 8, 1, False),
                ("ragged_multi_tile", 1300, 37, 8, 3, False),
                ("clamp_active", 4000, 50, 5, 3, True),
                ("M512", 513, 512, 3, 2, False),
                ("training_Do8", TRAIN_S * BATCH, M, 8, 8, False),
                ("training_Do1", TRAIN_S * BATCH, M, 8, 1, False),
                # the edges of the tiling: one row; one row past a 40-row
                # block (M=100) and past a 16-row reduction slice; Do not a
                # power of two; M=1
                ("B1", 1, M, 8, 8, False),
                ("block40_plus_1", 41, M, 8, 8, False),
                ("slice16_plus_1", 17, M, 8, 8, False),
                ("Do13", 2000, M, 8, 13, False),
                ("M1", 300, 1, 4, 2, False),
                # wide inputs, through the gram stage's 16-wide chunks of
                # Dx: one partial chunk (9), two (30), 49 (784) at one row,
                # one past a 40-row block and B=1000; 785, one past a chunk
                # (operands with std Dx^-1/2: wide_spread)
                ("Dx9_B1", 1, M, 9, 8, False),
                ("Dx9_B41", 41, M, 9, 8, False),
                ("Dx9_B1000", 1000, M, 9, 8, False),
                ("Dx30_B1", 1, M, 30, 8, False),
                ("Dx30_B41", 41, M, 30, 8, False),
                ("Dx30_B1000", 1000, M, 30, 8, False),
                ("Dx784_B1", 1, M, 784, 8, False),
                ("Dx784_B41", 41, M, 784, 8, False),
                ("Dx784_B1000", 1000, M, 784, 8, False),
                ("Dx785_B1000", 1000, M, 785, 8, False),
                # a ragged M (the tail of dX's four chains) and a dX tile
                # one row past B
                ("Dx784_M37_B41", 41, 37, 784, 8, False),
                # the row kernels' cluster plan (conditional.forward_plan):
                # the last B with clusters (2 a row block at M=100) and the
                # first without; rows past B in a cluster's row block (8
                # blocks); Do not a multiple of the cluster (13 over 4: a
                # last round with idle blocks); Do=1 (no cluster at B=1000);
                # M=37 at B=1000 (clusters of 8 over 10 column groups)
                ("cluster_last_B5280", 5280, M, 8, 8, False),
                ("cluster_none_B5281", 5281, M, 8, 8, False),
                ("cluster_B1001_Dx30_Do30", 1001, M, 30, 30, False),
                ("cluster_Do13_B1000", 1000, M, 30, 13, False),
                ("Do1_B1000", 1000, M, 30, 1, False),
                ("cluster_M37_B1000", 1000, 37, 30, 30, False)]


def wide_spread(D):
    """The std of wide operands: D^-1/2 (scaled distances O(1), where
    unit rows at D=784 would put every gram entry at exp(-784) = 0); 1 at
    D <= 8, as the other cases draw them."""
    return 1.0 if D <= 8 else D ** -0.5
# the forward's precision designs (fused_conditional.cu), all held against
# float64 on phase 1's cases: the kernel's fp32 FFMA and the two 3xTF32
# tensor-core designs it was chosen over
PRECISIONS = {"fp32 FFMA (the kernel)": conditional.DESIGN_FFMA,
              "3xTF32, per-k-step fp32 sums": conditional.DESIGN_3XTF32,
              "3xTF32, sums chained in the tensor core":
                  conditional.DESIGN_3XTF32_CHAINED}


def precision_comparison(case, args, plain, ref):
    """The forward's error against float64 under each precision design
    (relative to the output scale, the forward's rule), beside the plain
    float32 version's; returns {design: error}."""
    kvar, kdiag = conditional._scalars(args[5], args[6], args[0])
    errs = {}
    for name, design in PRECISIONS.items():
        m, v, _ = conditional._forward_kernel(*args[:5], kvar, kdiag, False,
                                              design)
        errs[name] = compare((m, v), plain, ref, joint_scale=True)[2]
    errs["plain float32"] = compare(plain, plain, ref, joint_scale=True)[2]
    print(f"precision fused_conditional {case}: error vs f64 of scale: "
          + "; ".join(f"{d} {e:.3e}" for d, e in errs.items())
          + " (gate: <= 2x plain)", flush=True)
    return errs


def print_backward_plans():
    """The backward's launch plan at the training shape and at M=512:
    its slice-partial scratch must stay within 8 MB whatever B is."""
    for B, M_, Dx, Do in ((TRAIN_S * BATCH, M, 8, 8), (513, 512, 3, 2)):
        plan = backward_plan(B, M_, Dx, Do, torch.cuda.get_device_properties(
            0).multi_processor_count)
        big = backward_plan(1000 * B, M_, Dx, Do,
                            torch.cuda.get_device_properties(
                                0).multi_processor_count)
        mb = 4 * plan["scratch_floats"] / 1e6
        print(f"backward plan B={B} M={M_} Dx={Dx} Do={Do}: row pass "
              f"{plan['row_blocks']} blocks of {plan['tb']} rows (clusters "
              f"of {plan['cluster']}); reduction "
              f"{plan['nslices']} slices of {plan['rows_per_slice']} rows, "
              f"tiles {plan['tile']} x {plan['tile']}, "
              f"{plan['reduce_blocks']} blocks; scratch {mb:.3f} MB (at "
              f"1000 B: {4 * big['scratch_floats'] / 1e6:.3f} MB); row "
              f"panels {4 * plan['panel_floats'] / 1e6:.3f} MB", flush=True)
        check(mb <= 8.0 and big["scratch_floats"] == plan["scratch_floats"],
              f"backward scratch {mb} MB at B={B} M={M_}: above 8 MB or "
              f"dependent on B")


def phase_kernels(seed):
    """Every kernel against its plain version in float32 and float64 on
    the same inputs; repeat launches must agree bit for bit and the saved
    forward must equal the forward.  Returns the worst errors per kernel
    (these launches are not the main path's and are not counted)."""
    worst = {n: [0.0] * 4 for n in KERNEL_NAMES}
    precision = {}
    counts = launch_counts()
    for case, B, M_, Dx, Do, clamp in KERNEL_CASES:
        args = conditional_inputs(B, M_, Dx, Do, seed, clamp,
                                  wide_spread(Dx))
        a64 = [a.double() for a in args]
        gm, gv = cotangents(B, Do, seed)
        with torch.no_grad():
            fwd = lambda: fused_conditional_forward(*args)[:2]  # noqa: E731
            km, kv = fwd()
            torch.cuda.synchronize()
            pm, pv, pK = fused_conditional_saved_plain(*args)
            rm, rv, rK = fused_conditional_saved_plain(*a64)
            errs = compare((km, kv), (pm, pv), (rm, rv), joint_scale=True)
            hold("fused_conditional", case, errs)
            check_repeat("fused_conditional", case, fwd, (km, kv))
            if clamp:
                check(bool((kv == 0).any() and (kv > 0).any()
                           and (pv == 0).any()),
                      f"{case}: the variance clamp is not active")
            worst["fused_conditional"] = list(
                map(max, worst["fused_conditional"], errs))
            precision[case] = precision_comparison(case, args, (pm, pv),
                                                   (rm, rv))

            saved = lambda: fused_conditional_forward(  # noqa: E731
                *args, save_gram=True)
            sm, sv, sK = saved()
            check(torch.equal(sm, km) and torch.equal(sv, kv),
                  f"{case}: the saved forward's mean/var differ from the "
                  f"forward's")
            errs = compare((sm, sv, sK), (pm, pv, pK), (rm, rv, rK),
                           joint_scale=True)
            hold("fused_conditional_saved", case, errs)
            check_repeat("fused_conditional_saved", case, saved,
                         (sm, sv, sK))
            worst["fused_conditional_saved"] = list(
                map(max, worst["fused_conditional_saved"], errs))

            # the backward at the kernel forward's outputs (so all three
            # versions mask the same clamped entries)
            g64 = (gm.double(), gv.double())
            for name, K, K64 in (("fused_conditional_backward", None, None),
                                 ("fused_conditional_saved_backward", sK,
                                  rK)):
                bwd = lambda: fused_conditional_backward(  # noqa: E731
                    *args, km, kv, gm, gv, K)
                kg = bwd()
                torch.cuda.synchronize()
                pg = fused_conditional_backward_plain(*args, km, kv, gm, gv,
                                                      K)
                rg = fused_conditional_backward_plain(
                    *a64, km.double(), kv.double(), *g64, K64)
                errs = compare(kg, pg, rg, joint_scale=False)
                hold(name, case, errs)
                check_repeat(name, case, bwd, kg)
                worst[name] = list(map(max, worst[name], errs))
        del args, a64, gm, gv, pK, rK, sK
    print_backward_plans()
    set_launch_counts(counts)
    return worst, precision


# ---------------------------------------------------------------------------
# phase 2/3: the serving path
# ---------------------------------------------------------------------------

def build_model(seed, device="cuda", dtype=torch.float32, use_pallas=True,
                num_samples=1, random_posterior=True, config=None):
    """The headline model (bench.py's build_regression at BASELINE.json's
    width) on kin8nm-shaped synthetic data; Z is a seeded random subset
    of X.  Numerics: ``config``, else float32 or float64, jitter 1e-5,
    ``solve_mode='inverse'`` and ``use_pallas``."""
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    rng = np.random.RandomState(seed)
    Z = X[rng.choice(X.shape[0], M, replace=False)]
    kernels = [RBF(8) + White(8, variance=2e-6, trainable=False)
               for _ in range(LAYERS - 1)] + [RBF(8)]
    cfg = config or Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                           use_pallas=use_pallas)
    model = DGP.build(X, Y, Z, kernels, Gaussian(0.05), config=cfg,
                      num_samples=num_samples, device=device)
    # near-deterministic inner layers (reference run_regression.py)
    for layer in model.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    if random_posterior:   # so that the posterior is not the prior
        for layer in model.layers:
            layer.q_mu.set_value(rng.randn(*layer.q_mu.value.shape) * 0.5)
    return model, data


def serve_all(serve, requests):
    out = [serve(x, seed=s) for s, x in requests]
    torch.cuda.synchronize()
    return out


def predictions_vs_f64(label, models, ref, data, seed):
    """predict_y of each float32 card model {name: model} against the
    port's float64 CPU path ``ref`` (the path the CPU tests pin to the JAX
    package), at fixed draws, on test rows and on inducing inputs (where
    the variance cancels to about the jitter: the worst case for float32):
    raises above F32_PATH_ATOL.  Returns {name: (max |dmean|, max
    |dvar|)}."""
    rng = np.random.RandomState(seed + 1)
    n, s_ref = 200, 20
    first = next(iter(models.values()))
    Z = first.layers[0].Z.value.detach().cpu().double().numpy()
    xs = np.concatenate([data["Xs"][:n - 50], Z[:50]])
    zs = [rng.randn(s_ref, n, 8) for _ in range(LAYERS - 1)] + [
        rng.randn(s_ref, n, 1)]
    cm, cv = ref.predict_y(xs, S=s_ref, zs=zs)
    out = {}
    for name, m in models.items():
        gm, gv = m.predict_y(xs, S=s_ref, zs=zs)
        dm = (gm.cpu().double() - cm).abs().max().item()
        dv = (gv.cpu().double() - cv).abs().max().item()
        print(f"{label} {name} f32 on the card vs the f64 CPU path ({n} "
              f"rows incl. 50 inducing inputs, S={s_ref}, fixed draws): "
              f"max |dmean| {dm:.3e}, max |dvar| {dv:.3e}", flush=True)
        check(dm <= F32_PATH_ATOL and dv <= F32_PATH_ATOL,
              f"{label} {name} f32 card path vs f64 CPU path: {dm}, {dv} > "
              f"{F32_PATH_ATOL}")
        out[name] = (dm, dv)
    return out


def phase_serving(seed):
    model, data = build_model(seed)
    check(model.X_data.device.type == "cuda", "model not on the card")
    X = data["X"]
    requests = [(101, data["Xs"]), (102, X[:1000]), (103, X[1000:2300])]
    chunks = sum(-(-len(x) // BUCKETS[-1]) for _, x in requests)
    from torch.profiler import ProfilerActivity, profile

    # building the server captures each bucket's request: an eager
    # warm-up and the capture, each a launch a layer on the counters; the
    # requests replay graphs, which the profiler counts
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    live = make_server(model, S=S, precompute=False, batch_buckets=BUCKETS)
    built = fused_conditional.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = serve_all(live, requests)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = device_launches(prof)["fused_conditional"]
    for i in range(2, PROFILE_TRIES + 1):
        if launches == LAYERS * chunks:
            break
        print(f"serving live: the profiler counted {launches} fused "
              f"launches, expected {LAYERS * chunks} (try {i - 1}); "
              f"profiling the requests again", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_all(live, requests)
            torch.cuda.synchronize()
        launches = device_launches(prof)["fused_conditional"]
    print(f"serving live: 3 requests ({[len(x) for _, x in requests]} rows,"
          f" {chunks} chunks) in {first_s:.3f} s under the profiler; "
          f"fused_conditional launches: building the server {built} "
          f"(counters; expected 2 x {LAYERS} layers x {len(BUCKETS)} "
          f"buckets), the requests {launches} (profiler; expected {LAYERS} "
          f"layers x {chunks} chunks), the counters after the requests "
          f"{fused_conditional.launches}", flush=True)
    check(built == 2 * LAYERS * len(BUCKETS),
          f"building the server: launches {built} != 2 x {LAYERS} x "
          f"{len(BUCKETS)}")
    check(launches == LAYERS * chunks,
          f"launches {launches} != {LAYERS} x {chunks}")
    check(fused_conditional.launches == built,
          "a replayed request ticked the launch counter")
    for (_, x), (mean, var) in zip(requests, outs):
        for name, t in (("mean", mean), ("var", var)):
            check(tuple(t.shape) == (S, len(x), 1),
                  f"{name} shape {tuple(t.shape)}")
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
        check(bool((var > 0).all()), "predictive variance not positive")
    again = serve_all(live, requests)
    check(all(torch.equal(a, b) for o1, o2 in zip(outs, again)
              for a, b in zip(o1, o2)),
          "pinned seeds did not reproduce bit for bit")
    print("serving live: pinned-seed repeats bit-identical", flush=True)

    ref, _ = build_model(seed, device="cpu", dtype=torch.float64)
    ref.load_state_dict(model.state_dict())
    predictions_vs_f64("serving", {"live": model,
                                   "cached": precompute(model)}, ref, data,
                       seed)

    cached = make_server(model, S=S, precompute=True, batch_buckets=BUCKETS)
    couts = serve_all(cached, requests)
    dmc = max((a[0] - b[0]).abs().max().item()
              for a, b in zip(outs, couts))
    dvc = max((a[1] - b[1]).abs().max().item()
              for a, b in zip(outs, couts))
    for mean, var in couts:
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
              "cached server output not finite")
    print(f"serving cached vs live at the same seeds: max |dmean| "
          f"{dmc:.3e}, max |dvar| {dvc:.3e}", flush=True)
    return live, cached, requests, launches


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

def bound_ms(B, M_, Dx, Do, backward=False, saved=False):
    """The least time for the call: the larger of its bytes (each input
    read once, each output written once) over the HBM rate and its flops
    over the fp32 peak.  The backward reads the forward's inputs and the
    cotangents gm, gv and writes a gradient of the same size as each of
    the forward's tensor inputs; the saved pair also writes (forward) or
    reads (backward) the (B, M) gram."""
    params = M_ * Dx + M_ * M_ + M_ * Do + Do * M_ * M_
    if backward:
        floats = B * Dx + params + 2 + 2 * B * Do + B * Dx + params
        n_flops = flops_bwd(B, M_, Dx, Do, saved=saved)
    else:
        floats = B * Dx + params + 2 + 2 * B * Do
        n_flops = flops(B, M_, Dx, Do)
    floats += B * M_ if saved else 0
    t_ops = n_flops / FP32_PEAK
    t_bytes = 4 * floats / HBM_RATE
    # the second bound of a tensor-core design: the GEMM-shaped products
    # (G = K LiT, the variance's G W_d, and in the backward dG, dK, dW and
    # dLiT) as 3xTF32 on the tensor cores, the rest as fp32 FFMA (the
    # kernels are FFMA throughout, so the first bound is theirs)
    n_gemm = 2 * B * M_ * M_ * ((Do + 2) + (Do + 1) if backward else Do + 1)
    t_tc = n_gemm / (TF32_PEAK / 3) + (n_flops - n_gemm) / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_tc, t_bytes))


def gemm_yardstick_ms(rows, inner, cols):
    """CUDA-event time of one float32 torch.matmul (rows x inner) by
    (inner x cols): a yardstick of the kernel's dominant product, not a
    library call that computes the kernel's function."""
    a = torch.randn(rows, inner, device="cuda")
    b = torch.randn(inner, cols, device="cuda")
    return event_ms(lambda: torch.matmul(a, b))


def fused_row_timing(name, kern, plain, B, M_, Dx, Do, backward, saved,
                     card, what="timing"):
    """One fused-conditional row: event, device, plain and GEMM-yardstick
    times beside both bounds; returns the record's shape entry."""
    k_ms = event_ms(kern)
    d_ms = device_ms(kern, DEVICE_KERNELS[name])
    p_ms = event_ms(plain)
    y_ms = gemm_yardstick_ms(B, M_, Do * M_)
    b_ms, b_by, tc_ms = bound_ms(B, M_, Dx, Do, backward, saved)
    gflop = (flops_bwd(B, M_, Dx, Do, saved) if backward
             else flops(B, M_, Dx, Do)) / 1e9
    d_txt = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
    print(f"{what} {name} B={B} M={M_} Dx={Dx} Do={Do}: kernel {k_ms:.4f} "
          f"ms (device time {d_txt}), plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {gflop:.3f} GFLOP at "
          f"{FP32_PEAK / 1e12:.0f} TFLOP/s fp32) / {tc_ms:.4f} ms with the "
          f"products at {TF32_PEAK / 3e12:.0f} TFLOP/s (3xTF32), GEMM "
          f"yardstick (torch.matmul ({B} x {M_}) by ({M_} x {Do * M_}), "
          f"not this function) {y_ms:.4f} ms, library call: none [{card}]",
          flush=True)
    return {"B": B, "M": M_, "Dx": Dx, "Do": Do, "ms": k_ms,
            "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_tc_ms": tc_ms,
            "gemm_yardstick_ms": y_ms, "gflop": gflop}


def phase_timings(seed, live, cached, requests, card):
    shapes = []
    for Do in (8, 1):
        B, Dx = S * BUCKETS[-1], 8
        args = conditional_inputs(B, M, Dx, Do, seed)
        counts = launch_counts()
        with torch.no_grad():
            shapes.append(fused_row_timing(
                "fused_conditional", lambda: fused_conditional(*args),
                lambda: fused_conditional_plain(*args), B, M, Dx, Do, False,
                False, card))
        set_launch_counts(counts)
        del args
    latency = {}
    _, x1000 = requests[1]
    for name, serve in (("live", live), ("cached", cached)):
        times = []
        for i in range(7):
            t0 = time.perf_counter()
            serve(x1000, seed=1000 + i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        latency[name] = statistics.median(times)
        print(f"timing {name} server, 1000-row request, S={S}: median "
              f"{latency[name]:.3f} ms over 7 (all: "
              f"{', '.join(f'{t:.3f}' for t in times)})", flush=True)
    return shapes, latency


def device_breakdown(prof, n):
    """(device busy ms per unit, device ops per unit, top device ops) from
    a profile over n units of work; None when the profiler saw no device
    time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    if not kernels:
        return None
    busy = sum(e.self_device_time_total for e in kernels) / (1e3 * n)
    ops = sum(e.count for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    desc = "; ".join(f"{e.key[:60]} {e.self_device_time_total / (1e3 * n):.3f}"
                     f" ms x{e.count // n}" for e in top)
    return busy, ops, desc


def phase_profile(live, cached, requests):
    """Where a request's time goes: device time by kernel over three
    1000-row requests under torch.profiler (whose own overhead inflates
    the wall time, so the idle share here is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    _, x1000 = requests[1]
    for name, serve in (("live", live), ("cached", cached)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                serve(x1000, seed=2000 + i)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 3
        found = device_breakdown(prof, 3)
        if found is None:
            print(f"profile {name}: device time not measured", flush=True)
            continue
        busy, _, top = found
        print(f"profile {name} server, 1000-row request: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler "
              f"(idle share {1 - busy / wall:.2f}); top kernels: {top}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def run_fit(model, steps, seed, profiled=True, **fit_kw):
    """fit() (with ``fit_kw``) with the launch counts set to 0 just before
    and read just after, logging (and syncing) every chunk; returns the
    history, the counts and (``profiled``) the launches of the second
    chunk (one replay) by the profiler."""
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    replay = ProfiledChunk()
    _, hist = fit(model, iterations=steps, learning_rate=0.01,
                  batch_size=BATCH, seed=seed, log_every=FIT_CHUNK,
                  callbacks=[replay] if profiled else [], **fit_kw)
    torch.cuda.synchronize()
    replay.close()
    return hist, launch_counts(), replay.launches


def check_fit_launches(label, counts, replay, per_step):
    """Raise unless the counters hold the launches of fit's warm-up and
    capture chunks, and the profiled replay those of one chunk, for each
    record: ``per_step`` {record: launches a step}, every other record 0."""
    want = {n: per_step.get(n, 0) for n in KERNEL_NAMES}
    check(counts == {n: FIT_CAPTURE_CHUNKS * FIT_CHUNK * k
                     for n, k in want.items()},
          f"{label}: launch counters {counts} != {want} a step over the "
          f"warm-up and capture chunks")
    check(replay == {n: FIT_CHUNK * k for n, k in want.items()},
          f"{label}: a replayed chunk launched {replay} (profiler) != "
          f"{want} a step")


def named_grads(model):
    return {n: p.grad.detach().double().cpu()
            for n, p in model.named_parameters()
            if p.requires_grad and p.grad is not None}


def loss_grads(model, idx, zs):
    model.zero_grad(set_to_none=True)
    loss = model.loss(model.X_data[idx], model.Y_data[idx], zs=zs)
    loss.backward()
    return loss.item(), named_grads(model)


def gradient_errors(label, runs, ref, seed, widths=(8,) * (LAYERS - 1) + (1,),
                    samples=TRAIN_S):
    """The ELBO gradient of each float32 card run {name: (model, context
    it runs in)} at a fixed minibatch and fixed draws (``samples`` of each
    layer's output ``widths``) against the float64 CPU model ``ref`` (the
    same parameters): per parameter tensor, max |g - g64| / max |g64|.
    Returns {name: worst over the tensors}."""
    rng = np.random.RandomState(seed + 3)
    idx = rng.randint(0, ref.X_data.shape[0], BATCH)
    zs = [rng.randn(samples, BATCH, d) for d in widths]
    l64, g64 = loss_grads(ref, torch.as_tensor(idx), zs)
    worst = {}
    for name, (m, context) in runs.items():
        with context:
            loss, grads = loss_grads(
                m, torch.as_tensor(idx, device=m.X_data.device), zs)
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f"ELBO gradient ({label} {name}) not finite")
        errs = {p: ((g - g64[p]).abs().max()
                    / g64[p].abs().max().clamp_min(1e-30)).item()
                for p, g in grads.items()}
        worst[name] = max(errs.values())
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"{label} gradient {name} vs f64 (batch {BATCH}, S="
              f"{samples}, fixed draws): loss {loss:.6f} vs {l64:.6f}; "
              f"worst relative error over {len(errs)} tensors "
              f"{worst[name]:.3e} ("
              + ", ".join(f"{p} {e:.2e}" for p, e in top) + ")",
              flush=True)
    return worst


def check_gradient(model, seed):
    """The ELBO gradient of the float32 card paths against the port's
    float64 CPU path: the kernel path's worst relative error must be
    within 2x the plain (use_pallas=False) float32 path's worst."""
    state = model.state_dict()
    runs = {"kernel f32": (model, contextlib.nullcontext())}
    for name, kw in (("plain f32", dict(use_pallas=False)),
                     ("f64 cpu", dict(device="cpu", dtype=torch.float64))):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False,
                           **kw)
        m.load_state_dict(state)
        runs[name] = (m, contextlib.nullcontext())
    ref, _ = runs.pop("f64 cpu")
    worst = gradient_errors("training", runs, ref, seed)
    check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
          f"ELBO gradient through the kernels {worst['kernel f32']} > 2x "
          f"the plain float32 path's {worst['plain f32']}")
    return worst


def phase_training(seed):
    model, data = build_model(seed, num_samples=TRAIN_S,
                              random_posterior=False)
    hist, counts, replay = run_fit(model, TRAIN_STEPS, seed)
    losses = [h["loss"] for h in hist]
    print(f"training use_pallas=True: {TRAIN_STEPS} Adam steps, 5 layers, "
          f"M={M}, S={TRAIN_S}, batch {BATCH}: loss {losses[0]:.3f} "
          f"(steps 1-10) -> {losses[-1]:.3f} (last 10); launches (counters:"
          f" the warm-up and capture chunks) "
          + ", ".join(f"{n} {c}" for n, c in counts.items())
          + "; a replayed chunk (profiler) "
          + ", ".join(f"{n} {c}" for n, c in replay.items()), flush=True)
    # and 2 grams a layer a step: Kuu and the KL's Kuu
    check_fit_launches("use_pallas=True", counts, replay,
                       {"fused_conditional": LAYERS,
                        "fused_conditional_backward": LAYERS,
                        "rbf_gram": 2 * LAYERS})
    check(all(np.isfinite(losses)), "training loss not finite")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")

    grad_worst = check_gradient(model, seed)

    metrics = evaluate_regression(model, data["Xs"], data["Ys"],
                                  data["Y_std"], S=100, seed=seed)
    print(f"training evaluate_regression on the {len(data['Xs'])}-row test "
          f"split, S=100: rmse {metrics['rmse']:.6f}, loglik "
          f"{metrics['loglik']:.6f}", flush=True)
    check(np.isfinite(metrics["rmse"]) and np.isfinite(metrics["loglik"]),
          "test metrics not finite")

    saved_counts = None
    for route in ("saved", False):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False,
                           use_pallas=route)
        h, c, r = run_fit(m, 60, seed)
        print(f"training use_pallas={route!r}: 60 steps, loss "
              f"{h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}; launches "
              f"(counters) " + ", ".join(f"{n} {k}" for n, k in c.items())
              + "; a replayed chunk (profiler) "
              + ", ".join(f"{n} {k}" for n, k in r.items()), flush=True)
        check(all(np.isfinite([x["loss"] for x in h])),
              f"use_pallas={route!r}: loss not finite")
        if route == "saved":
            saved_counts = c
            check_fit_launches("use_pallas='saved'", c, r,
                               {"fused_conditional_saved": LAYERS,
                                "fused_conditional_saved_backward": LAYERS,
                                "rbf_gram": 2 * LAYERS})
        else:
            # 3 grams a layer a step: Kuf, Kuu, the KL's Kuu
            check_fit_launches("use_pallas=False", c, r,
                               {"rbf_gram": 3 * LAYERS})

    runs = []
    for _ in range(2):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False)
        run_fit(m, 2 * FIT_CHUNK, seed, profiled=False)
        runs.append(m.state_dict())
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    print(f"training: two 20-step fits from one seed agree bit for bit: "
          f"{same}", flush=True)

    launches = {**counts, **{n: saved_counts[n] for n in
                             ("fused_conditional_saved",
                              "fused_conditional_saved_backward")}}
    return model, launches, grad_worst, metrics, same


def steps_per_s(models, seed, card, label):
    """Training steps/s of ``fit`` for each {route: model}, measured in
    turns (3 rounds of a 30-step fit per route) so that the shared host's
    load falls alike on all: the median of the 10-step chunk rates,
    leaving out each fit's first chunk (optimizer set-up)."""
    samples = {r: [] for r in models}
    for i in range(3):
        for r, m in models.items():
            hist = run_fit(m, 30, seed + i, profiled=False)[0]
            samples[r] += [h["iters_per_sec"] for h in hist[1:]]
    rates = {r: statistics.median(v) for r, v in samples.items()}
    print(f"{label} steps/s of fit (median of 6 ten-step chunks, in turns; "
          "range): " + ", ".join(
              f"{r} {rates[r]:.2f} ({min(v):.2f}-{max(v):.2f})"
              for r, v in samples.items()) + f" [{card}]", flush=True)
    return rates


def phase_steps_per_s(seed, card):
    """Steps/s of the three use_pallas routes, in turns."""
    models = {f"use_pallas={r!r}": build_model(
        seed, num_samples=TRAIN_S, random_posterior=False, use_pallas=r)[0]
        for r in (True, "saved", False)}
    rates = steps_per_s(models, seed, card, "training")
    return {r.split("=")[1].strip("'"): v for r, v in rates.items()}


def phase_training_timings(seed, card):
    """Each kernel and its plain version at the training shapes (B = S x
    batch = 10,000 rows, M=100, Dx=8), CUDA-event medians of 30."""
    shapes = {n: [] for n in KERNEL_NAMES}
    counts = launch_counts()
    for Do in (8, 1):
        B, Dx = TRAIN_S * BATCH, 8
        args = conditional_inputs(B, M, Dx, Do, seed)
        gm, gv = cotangents(B, Do, seed)
        with torch.no_grad():
            km, kv, kK = fused_conditional_forward(*args, save_gram=True)
            calls = {
                "fused_conditional": (
                    lambda: fused_conditional_forward(*args),
                    lambda: fused_conditional_plain(*args), False, False),
                "fused_conditional_backward": (
                    lambda: fused_conditional_backward(*args, km, kv, gm, gv),
                    lambda: fused_conditional_backward_plain(
                        *args, km, kv, gm, gv), True, False),
                "fused_conditional_saved": (
                    lambda: fused_conditional_forward(*args, save_gram=True),
                    lambda: fused_conditional_saved_plain(*args), False,
                    True),
                "fused_conditional_saved_backward": (
                    lambda: fused_conditional_backward(*args, km, kv, gm, gv,
                                                       kK),
                    lambda: fused_conditional_backward_plain(
                        *args, km, kv, gm, gv, kK), True, True),
            }
            for name, (kern, plain, backward, saved) in calls.items():
                shapes[name].append(fused_row_timing(
                    name, kern, plain, B, M, Dx, Do, backward, saved, card))
    set_launch_counts(counts)
    return shapes


def phase_training_profile(model, seed, card, route="use_pallas=True"):
    """One training step's device time by kernel (mean of 5 profiled
    steps) against the unprofiled step wall time (median of 20)."""
    from torch.profiler import ProfilerActivity, profile

    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_sgd_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    step = make_sgd_train_step(masked_optimizer(model, 0.01), BATCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    times = []
    for i in range(23):
        t0 = time.perf_counter()
        step(model, generator=gen)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    wall = statistics.median(times)
    # host syncs a step: torch's sync debug mode warns on each
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(model, generator=gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"training step (eager): {syncs} host syncs (torch.cuda sync "
          f"debug mode)", flush=True)
    check(syncs == 0, f"an eager training step made {syncs} host syncs")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(model, generator=gen)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / 5
    found = device_breakdown(prof, 5)
    print(f"timing training step ({route}, batch {BATCH}, S="
          f"{TRAIN_S}), synchronized each step: median {wall:.3f} ms over "
          f"20 (all: {', '.join(f'{t:.3f}' for t in times)}) [{card}]",
          flush=True)
    if found is None:
        print(f"profile training step ({route}): device time not measured",
              flush=True)
        return {"step_ms": wall, "busy_ms": None, "host_syncs": syncs}
    busy, ops, top = found
    print(f"profile training step ({route}): device busy {busy:.3f} ms in {ops:.0f} "
          f"device ops; wall {prof_wall:.3f} ms under the profiler, "
          f"{wall:.3f} ms without (idle share {1 - busy / wall:.2f} of the "
          f"unprofiled wall); top device ops: {top}", flush=True)
    return {"step_ms": wall, "busy_ms": busy, "device_ops": ops,
            "idle_share": 1 - busy / wall, "host_syncs": syncs}


# ---------------------------------------------------------------------------
# phases 9-11: the collapsed DGPs and the psi2 kernel
# ---------------------------------------------------------------------------

COLLAPSED = ("damianou_large", "collapsed_L2")
# (psi2, fused conditional) launches at L=2 per bound and per prediction:
# DGPDamianou's hidden layer is its one layer on Gaussian inputs; a
# DGPCollapsed prediction propagates the training rows (the collapsed
# layer's inputs) and the test rows through the inner SVGP layer
EXPECTED = {"damianou_large": {"bound": (1, 0), "predict": (1, 0)},
            "collapsed_L2": {"bound": (1, 1), "predict": (1, 2)},
            # phase 26: collapsed_L2 with a Sum(RBF, Linear ARD) collapsed
            # kernel, whose RBF part alone calls psi2
            "collapsed_L2_sum": {"bound": (1, 1), "predict": (1, 2)}}
# (dtype, psi2_impl, use_pallas) of each route: the plain route differs
# from the kernel route in psi2 only; float64 takes the plain versions of
# psi2 and the fused conditional (their kernels take float32) and the
# float64 rbf_gram kernel
ROUTES = {"kernel": (torch.float32, "auto", True),
          "plain": (torch.float32, "xla", True),
          "f64": (torch.float64, "xla", False)}


def collapsed_models(data, seed):
    """Builders of the two configurations (the JAX bench's build_damianou
    at the damianou_large row and build_collapsed at collapsed_L2; Z by
    scipy's kmeans2, seed 0), and their fixed draws for the test rows."""
    from scipy.cluster.vq import kmeans2
    X, Y = data["X"], data["Y"]
    Z256 = kmeans2(X, 256, minit="points", seed=0)[0]
    Z100 = kmeans2(X[:1500], 100, minit="points", seed=0)[0]
    rng = np.random.RandomState(seed + 5)
    n = len(data["Xs"])

    def build(name, dtype=None, impl=None, use_pallas=None,
              solve_mode="inverse", device="cuda", config=None):
        cfg = config or Config(dtype=dtype, jitter=1e-5,
                               solve_mode=solve_mode, use_pallas=use_pallas,
                               psi2_impl=impl)
        if name == "damianou_large":
            return DGPDamianou.build(X, Y, Z256, [RBF(8), RBF(2)],
                                     Gaussian(0.05), config=cfg,
                                     device=device)
        return DGPCollapsed.build(X[:1500], Y[:1500], Z100,
                                  [RBF(8), RBF(8)], Gaussian(0.05),
                                  config=cfg, device=device)

    # DGPCollapsed hands one zs to the training-row and the test-row
    # propagation (the JAX semantics), so its draws broadcast over both
    zs = {"damianou_large": [rng.randn(S, n, d) for d in (2, 1)],
          "collapsed_L2": [rng.randn(1, 1, d) for d in (8, 1)]}
    return build, zs


def counted(fn):
    """(result, (psi2, fused conditional) launches of the call)."""
    before = (psi2.psi2_core.launches, fused_conditional.launches)
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, (psi2.psi2_core.launches - before[0],
                 fused_conditional.launches - before[1])


def evaluate_route(name, route, model, data, zs, counts=None):
    """Bound, predict_y and predict_density at fixed draws; checks the
    launches of each call (EXPECTED on the kernel route, no psi2 launch on
    the plain route, none at all in float64) and collects them in
    ``counts``."""
    Xs, Ys = data["Xs"], data["Ys"]
    calls = {"bound": lambda: model.elbo(),
             "predict_y": lambda: model.predict_y(Xs, S=S, zs=zs),
             "predict_density": lambda: model.predict_density(Xs, Ys, S=S,
                                                              zs=zs)}
    out = {}
    for call, fn in calls.items():
        out[call], n = counted(fn)
        want = EXPECTED[name]["bound" if call == "bound" else "predict"]
        want = {"kernel": want, "plain": (0, want[1]), "f64": (0, 0)}[route]
        check(n == want, f"{name} {route} route {call}: (psi2, "
                         f"fused_conditional) launches {n} != {want}")
        if counts is not None:
            counts[call] = n
    check(bool(torch.isfinite(out["bound"])), f"{name}: bound not finite")
    preds = (*out["predict_y"], out["predict_density"])
    for t in preds:
        check(bool(torch.isfinite(t).all()), f"{name}: prediction not "
                                             f"finite")
    return out["bound"], preds


def pred_err(preds, refs):
    """Worst max abs difference of the outputs, each relative to its
    reference's scale (at least 1)."""
    return max((p.double() - r.double()).abs().max().item()
               / max(r.abs().max().item(), 1.0) for p, r in zip(preds, refs))


def generator_predictions(model, data, seed):
    """predict_y and predict_density on the test rows at S=100, each
    drawn from a CUDA generator seeded with ``seed``."""
    gen = torch.Generator(device="cuda")
    with torch.no_grad():
        gen.manual_seed(seed)
        mean, var = model.predict_y(data["Xs"], S=S, generator=gen)
        gen.manual_seed(seed)
        dens = model.predict_density(data["Xs"], data["Ys"], S=S,
                                     generator=gen)
    return mean, var, dens


def f32_witnesses(build, model, data, zs, b64, p64):
    """Two variants that split the float32 error of damianou_large: the
    plain psi2 route in float32 with solve_mode='solve' (no explicit Kuu^-1
    or B^-1), and the float64 model whose psi2 data sum alone runs in
    float32 through the kernel (so psi2's float32 rounding is all that
    differs from float64).  Returns {variant: (bound err, predictions err,
    ladder escalations)}."""
    out = {}
    kernel = psi_stats.psi2_core

    def f32_psi2(*args, symmetric=False):
        return kernel(*[a.float().contiguous() for a in args],
                      symmetric=symmetric).double()

    for variant in ("f32 solve_mode=solve", "f64, f32 psi2"):
        if variant.startswith("f32"):
            m = build("damianou_large", torch.float32, "xla", True, "solve")
        else:
            # 'pallas': the kernel route whatever the dtype ('auto' takes
            # the plain route in float64), here into f32_psi2
            m = build("damianou_large", torch.float64, "pallas", False)
            psi_stats.psi2_core = f32_psi2
        m.load_state_dict(model.state_dict())
        safe_cholesky_ladder.escalations.reset()
        try:
            with torch.no_grad():
                b = m.elbo()
                preds = (*m.predict_y(data["Xs"], S=S, zs=zs),
                         m.predict_density(data["Xs"], data["Ys"], S=S,
                                           zs=zs))
        finally:
            psi_stats.psi2_core = kernel
        check(bool(torch.isfinite(b)) and all(
            bool(torch.isfinite(t).all()) for t in preds),
            f"damianou_large {variant}: not finite")
        out[variant] = (abs(b.item() - b64.item()) / abs(b64.item()),
                        pred_err(preds, p64),
                        int(safe_cholesky_ladder.escalations))
        print(f"collapsed damianou_large witness {variant}: bound "
              f"{b.item():.6f}, rel err vs f64 {out[variant][0]:.3e}; "
              f"predictions worst err {out[variant][1]:.3e} of scale; "
              f"ladder escalations {out[variant][2]}", flush=True)
    return out


def capture_psi2_operands(model):
    """The (U, V, w, logdet, Z) that the model's bound hands psi2_core
    (the launch is not counted); raises unless the call is symmetric (a
    single RBF's psi2)."""
    got = []
    inner = psi_stats.psi2_core
    n = psi2.psi2_core.launches

    def record(*args, symmetric=False):
        check(symmetric is True, "the bound's psi2_core call is not "
                                 "symmetric")
        got.append([a.detach().clone() for a in args])
        return inner(*args, symmetric=symmetric)

    psi_stats.psi2_core = record
    try:
        with torch.no_grad():
            model.elbo()
    finally:
        psi_stats.psi2_core = inner
        psi2.psi2_core.launches = n
    check(len(got) == 1, f"the bound called psi2_core {len(got)} times")
    return got[0]


def route_errors(label, name, model, build_route, data, zs, seed):
    """Bound and predictions at the fixed draws ``zs`` on the kernel route
    (``model``), the plain route and float64 (``build_route(route)`` on
    ``model``'s parameters), each call's launches checked by
    evaluate_route: each float32 route's errors against float64, the
    kernel route's within 2x the plain route's; and the kernel route
    against the plain route in float32, at the fixed draws and at S=100
    draws from one seeded generator (DGPCollapsed's fixed draws are one
    draw shared by all samples and rows), within ROUTE_GAP_RTOL.  Returns
    (results, errors, ladder escalations, gap, {route: model})."""
    results, escal, models = {}, {}, {"kernel": model}
    for route in ("kernel", "plain", "f64"):
        if route != "kernel":
            models[route] = build_route(route)
            models[route].load_state_dict(model.state_dict())
        safe_cholesky_ladder.escalations.reset()
        results[route] = evaluate_route(name, route, models[route], data, zs)
        escal[route] = int(safe_cholesky_ladder.escalations)
    b64, p64 = results["f64"]
    errs = {}
    for route in ("kernel", "plain"):
        b, preds = results[route]
        eb = abs(b.item() - b64.item()) / abs(b64.item())
        ep = pred_err(preds, p64)
        errs[route] = (eb, ep)
        print(f"{label} {route} route (f32): bound "
              f"{b.item():.6f} vs f64 {b64.item():.6f} (rel err "
              f"{eb:.3e}); predict_y mean/var and predict_density on "
              f"{len(data['Xs'])} rows, S={S}, fixed draws: worst err "
              f"{ep:.3e} of scale", flush=True)
    print(f"{label}: safe_cholesky_ladder escalations per "
          f"route (bound + 2 predictions): {escal}", flush=True)
    for i, what in enumerate(("bound", "predictions")):
        check(errs["kernel"][i] <= 2.0 * errs["plain"][i],
              f"{name} {what}: kernel route error vs f64 "
              f"{errs['kernel'][i]} > 2x the plain route's "
              f"{errs['plain'][i]}")
    (bk, pk), (bp, pp) = results["kernel"], results["plain"]
    gap = {"bound": abs(bk.item() - bp.item()) / abs(bp.item()),
           "predictions fixed draws": pred_err(pk, pp),
           "predictions generator": pred_err(
               generator_predictions(model, data, seed + 7),
               generator_predictions(models["plain"], data, seed + 7))}
    print(f"{label}: kernel route vs plain route (f32), "
          f"relative to each output's scale: {gap}", flush=True)
    for what, e in gap.items():
        tol = ROUTE_GAP_RTOL[what.split()[0]]
        check(e <= tol, f"{name} {what}: kernel route vs plain route "
                        f"{e} > {tol}")
    return results, errs, escal, gap, models


def phase_collapsed(seed, card):
    """The main path of this phase: both models on the kernel route with
    the launch counts at 0, then the plain route and float64 (plain
    route) on the same parameters; the kernel route's errors against
    float64 within 2x the plain route's."""
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    build, zs = collapsed_models(data, seed)
    out = {"data": data, "build": build, "zs": zs, "models": {},
           "operands": {}, "launches": {}}
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    for name in COLLAPSED:
        model = build(name, *ROUTES["kernel"])
        counts = {}
        evaluate_route(name, "kernel", model, data, zs[name], counts)
        print(f"collapsed {name}: (psi2_core, fused_conditional) launches "
              f"per call {counts} [{card}]", flush=True)
        out["models"][name] = {"kernel": model}
        out["launches"][name] = counts
    main_counts = launch_counts()
    for name in COLLAPSED:
        model = out["models"][name]["kernel"]
        results, errs, escal, gap, models = route_errors(
            f"collapsed {name}", name, model,
            lambda route: build(name, *ROUTES[route]), data, zs[name], seed)
        out["models"][name].update(models)
        b64, p64 = results["f64"]
        witness = (f32_witnesses(build, model, data, zs[name], b64, p64)
                   if name == "damianou_large" else None)
        out["operands"][name] = capture_psi2_operands(model)
        out[name] = {"errors": errs, "escalations": escal,
                     "route_gap": gap, "witness": witness,
                     "bound": results["kernel"][0].item(),
                     "bound_f64": b64.item()}
    out["main_counts"] = main_counts
    return out


def psi2_inputs(N, M_, D, seed, clamp=False, symmetric=False):
    """float64 operands on the card in the psi2 contract (w >= 0); with
    ``symmetric`` U = V - t/2 row by row, as one RBF's staging makes them
    (the output is then symmetric)."""
    rng = np.random.RandomState(seed)
    U = rng.randn(N, M_) * 0.5 - 0.2 + (1.0 if clamp else 0.0)
    V = rng.randn(N, M_) * 0.5 - 0.2
    if symmetric:
        U = V - rng.rand(N, 1) * 0.25
    arrays = (U, V, rng.rand(N, D), rng.randn(N, 1) * 0.3,
              rng.randn(M_, D) * 0.5)
    return [torch.tensor(a, dtype=torch.float64, device="cuda")
            for a in arrays]


def check_psi2_refusals(seed):
    """The route is chosen before any launch: on a CUDA tensor 'auto'
    takes the kernel only where it can (float32, M <= 512, 1 <= D <= 32)
    and the plain route elsewhere (M=513, float64), with no launch;
    'pallas' asks for the kernel and raises there, with no launch; 'xla'
    runs the plain route."""
    rng = np.random.RandomState(seed)
    n = psi2.psi2_core.launches
    for dtype, M_, err in ((torch.float32, psi2.MAX_M + 1, ValueError),
                           (torch.float64, 16, TypeError)):
        kern = RBF(2).to(device="cuda", dtype=dtype)
        mu, Sv, Z = (torch.tensor(a, dtype=dtype, device="cuda") for a in
                     (rng.randn(64, 2), rng.rand(64, 2) * 0.1,
                      rng.randn(M_, 2)))
        with torch.no_grad():
            raised = None
            try:
                psi_stats.psi_statistics(kern, mu, Sv, Z, "pallas")
            except err as e:
                raised = e
            check(raised is not None, f"psi_statistics pallas on CUDA "
                                      f"{dtype}, M={M_}: did not raise")
            auto = psi_stats.psi_statistics(kern, mu, Sv, Z, "auto")[2]
            plain = psi_stats.psi_statistics(kern, mu, Sv, Z, "xla")[2]
        check(plain.shape == (M_, M_) and bool(torch.isfinite(plain).all())
              and torch.equal(auto, plain),
              f"psi_statistics auto/xla on CUDA {dtype}, M={M_}")
    check(psi2.psi2_core.launches == n, "a psi2 call off the kernel's "
                                        "limits launched")
    print(f"psi2 route on CUDA: at M={psi2.MAX_M + 1} and in float64 "
          f"'auto' takes the plain route (equal to 'xla'), 'pallas' "
          f"raises; no launch", flush=True)


# phase 10's cases beyond the models' operands: (name, N, M, D, clamp,
# symmetric operands): ragged N, D above the register-held range, the
# cap, the clamp active; and the tiling's edges: M=1, one past a 64-wide
# tile, one row, one past a 32-row step, and collapsed_L2's N and M
PSI2_CASES = [("ragged_N1301_M100", 1301, 100, 3, False, False),
              ("D12_shared_Z", 500, 64, 12, False, False),
              ("M512", 2000, 512, 2, False, False),
              ("clamp_active", 300, 37, 2, True, False),
              ("M1", 300, 1, 2, False, True),
              ("M65", 700, 65, 2, False, True),
              ("N1", 1, 100, 8, False, True),
              ("N33", 33, 100, 8, False, True),
              ("N1500_M100", 1500, 100, 8, False, True)]


def check_psi2_streams(name, a32, sym, want):
    """psi2 forward launches on two streams at once, eagerly and as two
    CUDA graphs replayed on the two streams, 8 rounds: raises unless every
    output has ``want``'s bits (each launch has its own ticket counters,
    in its scratch from the caching allocator on its stream)."""
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for k in range(8):
        with torch.cuda.stream(streams[k % 2]):
            outs.append(psi2.psi2_core_forward(*a32, symmetric=sym))
    torch.cuda.synchronize()
    check(all(torch.equal(o, want) for o in outs),
          f"psi2_core_forward {name}: launches on two streams at once "
          f"differ from one stream's")
    graphs, graph_outs = [], []
    for _ in streams:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            graph_outs.append(psi2.psi2_core_forward(*a32, symmetric=sym))
        graphs.append(g)
    for _ in range(8):
        for g, st in zip(graphs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                g.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(o, want) for o in graph_outs),
              f"psi2_core_forward {name}: two graphs replayed on two "
              f"streams at once differ from one stream's launch")


def phase_psi2_kernel(seed, operands):
    """psi2 kernel vs its plain version (float32) and float64, on the
    models' operands and the cases above, as symmetric=True wherever the
    operands are symmetric and as symmetric=False; bit-identical repeats,
    on one stream and on two at once, and (symmetric) outputs equal to
    their transpose.  Returns the worst
    errors (the launches here are not counted)."""
    counts = launch_counts()
    check_psi2_refusals(seed)
    cases = [(name, [t.double() for t in operands[name]], True)
             for name in COLLAPSED]
    cases += [(name, psi2_inputs(N, M_, D, seed + i, clamp, sym), sym)
              for i, (name, N, M_, D, clamp, sym) in enumerate(PSI2_CASES)]
    worst = [0.0] * 4
    for case, a64, symmetric_operands in cases:
        a32 = [t.float().contiguous() for t in a64]
        N, M_ = a32[0].shape
        D = a32[4].shape[1]
        if case == "clamp_active":
            U, V, w, _, Z = a64
            pre = (U[:, :, None] + V[:, None, :]
                   - torch.einsum("nd,ad,bd->nab", w, Z, Z))
            check(bool((pre > 0).any() and (pre < 0).any()),
                  "psi2 clamp_active: the clamp is not active")
        for sym in ((True, False) if symmetric_operands else (False,)):
            name = f"{case} symmetric={sym}"
            with torch.no_grad():
                fwd = lambda: (psi2.psi2_core_forward(  # noqa: E731
                    *a32, symmetric=sym),)
                got = fwd()
                torch.cuda.synchronize()
                plain = (psi2.psi2_core_plain(*a32, symmetric=sym),)
                ref = (psi2.psi2_core_plain(*a64, symmetric=sym),)
                errs = compare(got, plain, ref, joint_scale=True)
                hold("psi2_core_forward", name, errs)
                check_repeat("psi2_core_forward", name, fwd, got)
                check_psi2_streams(name, a32, sym, got[0])
                if sym:
                    check(torch.equal(got[0], got[0].T),
                          f"psi2_core_forward {name}: not symmetric")
            print(f"kernel psi2_core_forward {name} (N={N}, M={M_}, D={D}): "
                  f"bitwise symmetric {torch.equal(got[0], got[0].T)}",
                  flush=True)
            worst = list(map(max, worst, errs))
    set_launch_counts(counts)
    return worst


def psi2_bound_ms(N, M_, D, backward=False, symmetric=False):
    """The least time of one call: its bytes (U, V, w, logdet, Z read
    once, the (M, M) output written once; the backward also reads g and
    writes a gradient of the size of each input) over the HBM rate, its
    fp32 flops over the fp32 peak, and its exps over the SFU exp rate; a
    symmetric call's least work is the upper triangle's terms."""
    inputs = 2 * N * M_ + N * D + N + M_ * D
    n_bytes = 4 * (2 * inputs + M_ * M_ if backward else inputs + M_ * M_)
    n_flops = (psi2.backward_flops(N, M_, D) if backward
               else psi2.flops(N, M_, D, symmetric))
    times = {"bytes": n_bytes / HBM_RATE,
             "operations": max(n_flops / FP32_PEAK,
                               psi2.terms(N, M_, symmetric) / SFU_EXP_RATE)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def psi2_wt_sweep(name, a32, sms, card):
    """The psi2 forward at every wt that fits (tile warps a block;
    forward_plan's other choices follow from it), symmetric and general:
    device ms a call by CUDA-graph replays, beside the wt that
    forward_plan's cost model picks.  The readings the model is held to."""
    N, M_ = a32[0].shape
    D = a32[4].shape[1]
    out = {}
    for symmetric in (True, False):
        plan = psi2.forward_plan(N, M_, D, sms, symmetric)
        sweep = {}
        with torch.no_grad():
            for wt in range(1, min(16, -(-plan["tiles"] // 32)) + 1):
                try:
                    psi2.forward_plan(N, M_, D, sms, symmetric, wt)
                except ValueError:
                    continue
                sweep[wt] = graph_calls_ms(
                    lambda: psi2._forward_kernel(  # noqa: B023
                        *a32, symmetric=symmetric, wt=wt), reps=5, rounds=3)
        fastest = min(sweep, key=sweep.get)
        print(f"psi2 forward wt sweep {name} symmetric={symmetric} (device "
              f"ms a call, CUDA-graph replays): "
              + ", ".join(f"wt={k} {v:.4f}" for k, v in sweep.items())
              + f"; the plan's wt={plan['wt']} {sweep[plan['wt']]:.4f}, the "
              f"fastest wt={fastest} {sweep[fastest]:.4f} [{card}]",
              flush=True)
        out[f"symmetric={symmetric}"] = {"plan_wt": plan["wt"],
                                         "ms": sweep}
    return out


def phase_collapsed_timings(collapsed, card):
    """psi2 kernel at both path shapes, symmetric (the path's call) and
    general, beside the plain version (CUDA-event
    medians of 30, torch.profiler device time and CUDA-graph replays; the
    profiler's kernel records counted against the calls, eager and in
    replays), the triangle's and the full square's bounds, a GEMM
    yardstick and the wt sweep (psi2_wt_sweep); one bound evaluation and
    one 820-row S=100 predict_y request per model and route (medians of
    10), and a torch.profiler breakdown of the kernel route's bound and
    request."""
    from torch.profiler import ProfilerActivity, profile
    counts = launch_counts()
    shapes, paths = [], {}
    Xs = collapsed["data"]["Xs"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in COLLAPSED:
        a32 = [t.contiguous() for t in collapsed["operands"][name]]
        N, M_ = a32[0].shape
        D = a32[4].shape[1]
        sym = lambda: psi2.psi2_core_forward(  # noqa: E731
            *a32, symmetric=True)
        gen = lambda: psi2.psi2_core_forward(*a32)  # noqa: E731
        plain = lambda: psi2.psi2_core_plain(  # noqa: E731
            *a32, symmetric=True)
        kernel = DEVICE_KERNELS["psi2_core_forward"]
        t, records = {}, {}
        with torch.no_grad():
            for what, fn in (("symmetric", sym), ("general", gen)):
                d_ms, got = kernel_records(fn, kernel, n=20)
                t[what] = (event_ms(fn), d_ms, graph_calls_ms(fn))
                g_ms, g_got = kernel_records(capture_calls(fn, 10).replay,
                                             kernel, n=5)
                records[what] = {"eager_records": got,
                                 "eager_expected": 20,
                                 "graph_profiler_ms": g_ms,
                                 "graph_records": g_got,
                                 "graph_expected": 50}
                print(f"profiler psi2_core_forward {name} {what}: eager "
                      f"{d_ms} ms a call from {got} kernel records of 20 "
                      f"expected; under CUDA-graph replays {g_ms} ms a call "
                      f"from {g_got} of 50; CUDA events on the replays "
                      f"{t[what][2]:.4f} ms [{card}]", flush=True)
            t["plain"] = (event_ms(plain),
                          (total_device_ms(plain) or (None,))[0],
                          graph_calls_ms(plain, calls=2))
        y_ms = gemm_yardstick_ms(M_, N, M_)
        b_ms, b_by = psi2_bound_ms(N, M_, D, symmetric=True)
        full_ms, full_by = psi2_bound_ms(N, M_, D)
        shapes.append({
            "config": name, "N": N, "M": M_, "D": D,
            "ms": t["symmetric"][0], "device_ms": t["symmetric"][1],
            "graph_ms": t["symmetric"][2],
            "general_ms": t["general"][0],
            "general_device_ms": t["general"][1],
            "general_graph_ms": t["general"][2],
            "plain_ms": t["plain"][0], "plain_device_ms": t["plain"][1],
            "plain_graph_ms": t["plain"][2],
            "gemm_yardstick_ms": y_ms, "bound_ms": b_ms, "bound_by": b_by,
            "full_bound_ms": full_ms, "full_bound_by": full_by,
            "exps_M": psi2.terms(N, M_, True) / 1e6,
            "gflop": psi2.flops(N, M_, D, True) / 1e9,
            "profiler_records": records,
            "wt_sweep_ms": psi2_wt_sweep(name, a32, sms, card)})
        print(f"timing psi2_core_forward {name} N={N} M={M_} D={D} (CUDA "
              f"events ms, profiler device ms, CUDA-graph replay ms): "
              + ", ".join(f"{k} {v[0]:.4f}, {v[1]}, {v[2]:.4f}"
                          for k, v in t.items())
              + f"; bound {b_ms:.4f} ms triangle ({b_by}; "
              f"{psi2.terms(N, M_, True) / 1e6:.1f} M exps at "
              f"{SFU_EXP_RATE / 1e12:.2f} T/s, "
              f"{psi2.flops(N, M_, D, True) / 1e9:.3f} GFLOP), {full_ms:.4f} "
              f"ms full square ({full_by}); the first design (removed) "
              f"{EARLIER_DEVICE_MS[('psi2_core_forward', name)]} ms; "
              f"GEMM yardstick (torch.matmul ({M_} x {N}) by ({N} x {M_}), "
              f"not this function) {y_ms:.4f} ms; library call: none "
              f"[{card}]", flush=True)
        paths[name] = {}
        for route in ("kernel", "plain"):
            model = collapsed["models"][name][route]
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1)
            with torch.no_grad():
                bound_ms = event_ms(lambda: model.elbo(), reps=10)
                req_ms = event_ms(lambda: model.predict_y(
                    Xs, S=S, generator=gen), reps=10)
            paths[name][route] = {"bound_ms": bound_ms, "predict_ms": req_ms}
            print(f"timing {name} {route} route: bound {bound_ms:.3f} ms, "
                  f"{len(Xs)}-row S={S} predict_y {req_ms:.3f} ms (CUDA "
                  f"events, median of 10) [{card}]", flush=True)
        model = collapsed["models"][name]["kernel"]
        gen = torch.Generator(device="cuda")
        for what, fn in (("bound", lambda: model.elbo()),
                         ("predict_y", lambda: model.predict_y(
                             Xs, S=S, generator=gen))):
            with torch.no_grad(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / 3
            found = device_breakdown(prof, 3)
            if found is None:
                print(f"profile {name} {what}: device time not measured",
                      flush=True)
                continue
            busy, ops, top = found
            paths[name]["kernel"][f"{what}_busy_ms"] = busy
            print(f"profile {name} {what} (kernel route): device busy "
                  f"{busy:.3f} ms in {ops:.0f} device ops of {wall:.3f} ms "
                  f"wall under the profiler (idle share "
                  f"{1 - busy / wall:.2f}); top device ops: {top}",
                  flush=True)
    set_launch_counts(counts)
    return shapes, paths


# ---------------------------------------------------------------------------
# phase 24 (run right after phase 11): the collapsed DGPs under Config()
# ---------------------------------------------------------------------------

# the float64 card bound against the float64 CPU bound on the same
# parameters: Kuu is near singular at damianou_large (PERF.md, section 6),
# so a tighter gate would test cuSOLVER against LAPACK, not the route
F64_BOUND_RTOL = 1e-6
F64_FIT_STEPS = 20


def phase_f64_route(collapsed, seed, card):
    """DGPDamianou at damianou_large and DGPCollapsed at collapsed_L2 under
    ``Config()`` (float64, psi2_impl='auto') on the card: 'auto' takes the
    plain psi2 route there, so the bound (against the port's float64 CPU
    bound on the same parameters, within 1e-6 relative), an 820-row S=100
    predict_y and (damianou_large) fit launch no psi2 kernel; 'pallas' in
    float64 raises before any launch.  Times the bound, the request and a
    step (the second chunk of 10)."""
    counts = launch_counts()
    build, data = collapsed["build"], collapsed["data"]
    Xs, out = data["Xs"], {}
    for name in COLLAPSED:
        set_launch_counts({n: 0 for n in KERNEL_NAMES})
        model = build(name, config=Config())
        cpu = build(name, config=Config(), device="cpu")
        cpu.load_state_dict(model.state_dict())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        with torch.no_grad():
            bound = model.elbo()
            bound_cpu = cpu.elbo()
            bound_ms = event_ms(lambda: model.elbo(), reps=5)
            mean, var = model.predict_y(Xs, S=S, generator=gen)
            req_ms = event_ms(lambda: model.predict_y(Xs, S=S,
                                                      generator=gen), reps=5)
        rel = abs(bound.item() - bound_cpu.item()) / abs(bound_cpu.item())
        rec = {"bound": bound.item(), "bound_cpu": bound_cpu.item(),
               "rel_err": rel, "bound_ms": bound_ms, "predict_ms": req_ms}
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
              and mean.shape[-2] == len(Xs),
              f"{name} under Config(): predict_y not finite")
        check(rel <= F64_BOUND_RTOL, f"{name} under Config(): bound "
                                     f"{bound.item()} vs the CPU's "
                                     f"{bound_cpu.item()}, {rel} > "
                                     f"{F64_BOUND_RTOL} relative")
        step = ""
        if name == "damianou_large":
            _, hist = fit(model, iterations=F64_FIT_STEPS,
                          learning_rate=0.01, seed=seed, log_every=FIT_CHUNK)
            torch.cuda.synchronize()
            check(np.isfinite(hist[-1]["loss"]) and all(
                bool(torch.isfinite(p).all()) for p in model.parameters()),
                f"{name} under Config(): the fit ended non-finite")
            rec["fit_steps_per_s"] = hist[-1]["iters_per_sec"]
            step = (f"; fit {F64_FIT_STEPS} steps, loss {hist[0]['loss']:.3f}"
                    f" -> {hist[-1]['loss']:.3f}, second chunk of "
                    f"{FIT_CHUNK}: {rec['fit_steps_per_s']:.2f} steps/s "
                    f"({1e3 / rec['fit_steps_per_s']:.2f} ms a step)")
        c = launch_counts()
        check(c["psi2_core_forward"] == c["psi2_core_backward"] == 0,
              f"{name} under Config(): a psi2 kernel launched {c}")
        pallas = build(name, config=Config(psi2_impl="pallas"))
        raised = None
        try:
            with torch.no_grad():
                pallas.elbo()
        except TypeError as e:
            raised = e
        check(raised is not None and launch_counts()["psi2_core_forward"]
              == 0, f"{name}: psi2_impl='pallas' in float64 did not raise "
                    f"before a launch")
        print(f"f64 route {name} under Config() (float64, psi2_impl='auto'"
              f", the plain psi2 route): bound {bound.item():.6f} vs CPU "
              f"{bound_cpu.item():.6f} (rel {rel:.3e}); bound {bound_ms:.3f}"
              f" ms, {len(Xs)}-row S={S} predict_y {req_ms:.3f} ms (CUDA "
              f"events, median of 5){step}; psi2 launches 0; 'pallas' "
              f"raises before a launch [{card}]", flush=True)
        out[name] = rec
        del model, cpu, pallas
    set_launch_counts(counts)
    return out


# ---------------------------------------------------------------------------
# phases 12-15: the psi2 backward kernel and training the collapsed DGPs
# ---------------------------------------------------------------------------

PSI2_GRADS = ("gU", "gV", "gw", "glogdet", "gZ")
# fit's chunk (the guard's verification forward runs once a chunk)
COLLAPSED_FIT = {"collapsed_L2": 200, "damianou_large": 100}


def check_psi2_backward_refusals(seed):
    """On CUDA tensors the backward wrapper launches or raises: float64,
    M=513, a cotangent of another shape or not contiguous raise, and
    nothing launches."""
    n = psi2.psi2_core.backward_launches

    def args(M_=16, dtype=torch.float32):
        a = [t.to(dtype) for t in psi2_inputs(40, M_, 2, seed)]
        return a + [torch.ones(M_, M_, dtype=dtype, device="cuda")]

    wrong_shape = args()
    wrong_shape[5] = wrong_shape[5][:, :15].contiguous()
    strided = args()
    strided[5] = torch.ones(16, 32, device="cuda")[:, ::2]
    for case, a, err in (("float64", args(dtype=torch.float64), TypeError),
                         (f"M={psi2.MAX_M + 1}", args(psi2.MAX_M + 1),
                          ValueError),
                         ("g of another shape", wrong_shape, ValueError),
                         ("non-contiguous g", strided, ValueError)):
        raised = None
        try:
            psi2.psi2_core_backward(*a)
        except err as e:
            raised = e
        check(raised is not None, f"psi2_core_backward on CUDA, {case}: did "
                                  f"not raise {err.__name__}")
    check(psi2.psi2_core.backward_launches == n,
          "a refused psi2 backward call launched")
    print("psi2 backward kernel on CUDA: raises in float64, at M="
          f"{psi2.MAX_M + 1}, on a cotangent of another shape or not "
          "contiguous; no launch", flush=True)


def gate_witness(seed):
    """Prints what the unshifted M512 case shows: the gate pre < 0 drops or
    keeps whole terms, so two float32 versions can differ from float64 (and
    from each other) by a term where pre lies within rounding of 0.  Counts
    the terms whose gate differs from float64's for the plain version's
    pre (rounded products) and for the kernels' (FMAs, emulated in
    float64), and each version's worst gradient error.  Holds nothing."""
    a64 = psi2_inputs(2000, 512, 2, seed + 2)
    g64 = torch.tensor(np.random.RandomState(seed + 11).randn(512, 512),
                       dtype=torch.float64, device="cuda")
    a32 = [t.float().contiguous() for t in a64 + [g64]]
    U, V, w, _, Z = a32[:5]
    flips = {"plain": 0, "fma": 0}
    for n0 in range(0, U.shape[0], 250):
        sl = slice(n0, n0 + 250)
        open64 = psi2._pre(a64[0][sl], a64[1][sl], a64[2][sl], a64[4]) < 0
        fma = U[sl][:, :, None] + V[sl][:, None, :]
        for d in range(Z.shape[1]):
            wz = (w[sl, d:d + 1] * Z[:, d][None, :]).double()
            fma = (fma.double() - wz[:, :, None]
                   * Z[:, d].double()[None, None, :]).float()
        flips["plain"] += int(((psi2._pre(U[sl], V[sl], w[sl], Z) < 0)
                               != open64).sum())
        flips["fma"] += int(((fma < 0) != open64).sum())
    with torch.no_grad():
        got = psi2.psi2_core_backward(*a32)
        plain = psi2.psi2_core_backward_plain(*a32)
        ref = psi2.psi2_core_backward_plain(*a64, g64)
    _, _, e_k, e_p = compare(got, plain, ref, joint_scale=False)
    print(f"psi2 backward gate witness (M512 unshifted, {psi2.terms(2000, 512)}"
          f" terms): terms whose gate differs from float64's: plain pre "
          f"{flips['plain']}, FMA pre {flips['fma']}; worst gradient error "
          f"vs f64 of scale: kernel {e_k:.3e}, plain f32 {e_p:.3e}",
          flush=True)


def phase_psi2_backward_kernel(seed, operands):
    """psi2 backward kernel vs its plain version (float32) and float64 per
    gradient tensor, on the models' operands and the edge cases, with a
    seeded dense cotangent; bit-identical repeats.  Returns the worst
    errors (the launches here are not counted)."""
    counts = launch_counts()
    check_psi2_backward_refusals(seed)
    tie = psi2_inputs(200, 40, 2, seed + 4)
    for t in tie[:3]:
        t[:70] = 0.0                    # U = V = 0, w = 0: pre == 0 exactly
    dead = psi2_inputs(150, 70, 3, seed + 5)
    dead[3][11] = -1e30                 # the JAX kernels' padding rows
    # the gate pre < 0 is not continuous: a term within float32 rounding of
    # 0 may pass in one float32 version and not in another (the kernel
    # forms pre with FMAs, the plain version with rounded products), which
    # moves a gradient entry by a whole term.  Of M512's 524 M terms a few
    # would lie that close (gate_witness prints them), so its U is shifted:
    # the clamp stays active on some 1e-5 of the terms, and none is expected
    # within rounding of 0
    gate_witness(seed)
    m512 = psi2_inputs(2000, 512, 2, seed + 2)
    m512[0] -= 2.5
    cases = [(name, [t.double() for t in operands[name]])
             for name in COLLAPSED]
    cases += [("ragged_N1301_M100", psi2_inputs(1301, 100, 3, seed)),
              ("D12_shared_Z", psi2_inputs(500, 64, 12, seed + 1)),
              ("M512", m512),
              ("clamp_active", psi2_inputs(300, 37, 2, seed + 3, True)),
              ("exact_tie", tie), ("logdet_-1e30_row", dead)]
    worst = [0.0] * 4
    for case, a64 in cases:
        M_ = a64[0].shape[1]
        g64 = torch.tensor(np.random.RandomState(seed + 11).randn(M_, M_),
                           dtype=torch.float64, device="cuda")
        a64 = a64 + [g64]
        a32 = [t.float().contiguous() for t in a64]
        if case in ("M512", "clamp_active"):
            pre = psi2._pre(*a64[:3], a64[4])
            check(bool((pre > 0).any() and (pre < 0).any()),
                  f"psi2 backward {case}: the clamp is not active")
            del pre
        with torch.no_grad():
            bwd = lambda: psi2.psi2_core_backward(*a32)  # noqa: E731
            got = bwd()
            torch.cuda.synchronize()
            plain = psi2.psi2_core_backward_plain(*a32)
            ref = psi2.psi2_core_backward_plain(*a64)
        errs = compare(got, plain, ref, joint_scale=False)
        hold("psi2_core_backward", case, errs)
        check_repeat("psi2_core_backward", case, bwd, got)
        per = ", ".join(
            f"{n} {(g.double() - r).abs().max().item() / max(r.abs().max().item(), 1.0):.2e}"
            f"/{(p.double() - r).abs().max().item() / max(r.abs().max().item(), 1.0):.2e}"
            for n, g, p, r in zip(PSI2_GRADS, got, plain, ref))
        print(f"kernel psi2_core_backward {case} (N={a32[0].shape[0]}, M="
              f"{M_}, D={a32[4].shape[1]}): error vs f64 of scale, "
              f"kernel/plain: {per}", flush=True)
        if case == "exact_tie":
            check(not any(bool(t[:70].any()) for t in got[:3]),
                  "psi2 backward exact_tie: a tied row passed the gate")
            want = g64.sum() * torch.exp(a64[3][:70])
            check(bool(((got[3][:70].double() - want).abs()
                        <= 1e-4 * want.abs().max()).all()),
                  "psi2 backward exact_tie: glogdet of the tied rows")
        if case == "logdet_-1e30_row":
            check(all(bool((t[11] == 0).all()) for t in got[:4]),
                  "psi2 backward: the logdet = -1e30 row is not exactly 0")
        worst = list(map(max, worst, errs))
    set_launch_counts(counts)
    return worst


def route_gradients(label, base, build, zs, want, card):
    """The bound's gradient in float32 on the card through the kernels
    (``base``) and on the plain route (``build(float32, 'xla', False)``)
    against the port's float64 CPU path (the kernels' plain versions,
    ``build(float64, 'auto', False, device='cpu')``), all on ``base``'s
    parameters and the draws ``zs``: the kernel route's (psi2 fwd, psi2
    bwd, fused fwd, fused bwd) launches must be ``want``, the plain route's
    none; per parameter tensor max |g - g64| / max |g64|.  Returns {route:
    worst}."""
    ref = build(torch.float64, "auto", False, device="cpu")
    ref.load_state_dict(base.state_dict())
    t0 = time.perf_counter()
    l64 = ref.loss(zs=zs)
    l64.backward()
    g64 = named_grads(ref)
    cpu_s = time.perf_counter() - t0
    worst = {}
    for route in ("kernel f32", "plain f32"):
        m = base
        if route != "kernel f32":
            m = build(torch.float32, "xla", False)
            m.load_state_dict(base.state_dict())
        m.zero_grad(set_to_none=True)
        set_launch_counts({n: 0 for n in KERNEL_NAMES})
        loss = m.loss(zs=zs)
        loss.backward()
        torch.cuda.synchronize()
        c = launch_counts()
        got = (c["psi2_core_forward"], c["psi2_core_backward"],
               c["fused_conditional"], c["fused_conditional_backward"])
        check(got == (want if route == "kernel f32" else (0, 0, 0, 0)),
              f"{label} {route}: (psi2 fwd, psi2 bwd, fused fwd, fused "
              f"bwd) launches {got}")
        grads = named_grads(m)
        check(set(grads) == set(g64), f"{label} {route}: gradients reach "
              f"{sorted(grads)}, float64 {sorted(g64)}")
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f"{label} bound gradient ({route}) not finite")
        errs = {p: ((g - g64[p]).abs().max()
                    / g64[p].abs().max().clamp_min(1e-30)).item()
                for p, g in grads.items()}
        worst[route] = max(errs.values())
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"{label} {route} vs f64 on the CPU "
              f"({cpu_s:.1f} s): loss {loss.item():.6f} vs "
              f"{l64.item():.6f}; worst relative error over "
              f"{len(errs)} tensors {worst[route]:.3e} ("
              + ", ".join(f"{p} {e:.2e}" for p, e in top)
              + f"); launches {got} [{card}]", flush=True)
        m.zero_grad(set_to_none=True)
    return worst


def phase_collapsed_gradient(collapsed, card):
    """The bound's gradient at both cells (route_gradients); through the
    kernels within 2x the plain route's error at collapsed_L2 (float32 is
    O(1) off float64 at damianou_large on both routes)."""
    build, zs = collapsed["build"], collapsed["zs"]
    want = {"damianou_large": (1, 1, 0, 0), "collapsed_L2": (1, 1, 1, 1)}
    out = {}
    for name in COLLAPSED:
        worst = route_gradients(
            f"collapsed gradient {name}",
            collapsed["models"][name]["kernel"],
            lambda *a, name=name, **k: build(name, *a, **k), zs[name],
            want[name], card)
        if name == "collapsed_L2":
            check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
                  f"{name}: bound gradient through the kernels "
                  f"{worst['kernel f32']} > 2x the plain route's "
                  f"{worst['plain f32']}")
        out[name] = worst
    return out


def collapsed_fit(model, steps, seed, profiled):
    """fit() on a collapsed model (no batch size, the guard by fit's own
    rule), the launch counts set to 0 just before and read just after;
    with (``profiled``) the launches of the second chunk (one replay) by
    the profiler."""
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    replay = ProfiledChunk()
    _, hist = fit(model, iterations=steps, learning_rate=0.01, seed=seed,
                  log_every=FIT_CHUNK, callbacks=[replay] if profiled else [])
    torch.cuda.synchronize()
    replay.close()
    return hist, launch_counts(), replay.launches


def phase_collapsed_training(collapsed, seed, card):
    """Both cells trained by fit from the build state: the kernel route
    with its launch counts per step, the plain psi2 route beside it."""
    build, data = collapsed["build"], collapsed["data"]
    out, main_counts = {}, {}
    for name in COLLAPSED[::-1]:
        steps = COLLAPSED_FIT[name]
        out[name] = {}
        for route in ("kernel", "plain"):
            n = steps if route == "kernel" or name == "collapsed_L2" else 20
            model = build(name, *ROUTES[route])
            hist, c, r = collapsed_fit(model, n, seed,
                                       profiled=route == "kernel")
            losses = [h["loss"] for h in hist]
            rates = [h["iters_per_sec"] for h in hist[1:]]
            rejected = hist[-1]["rejected"]
            params_ok = all(bool(torch.isfinite(p).all())
                            for p in model.parameters())
            print(f"collapsed training {name} {route} route: fit {n} steps "
                  f"(guard on, chunks of {FIT_CHUNK}): loss {losses[0]:.3f} "
                  f"(steps 1-{FIT_CHUNK}) -> {losses[-1]:.3f} (last "
                  f"{FIT_CHUNK}); rejected steps {rejected}; steps/s median "
                  f"of {len(rates)} chunks {statistics.median(rates):.2f} "
                  f"({min(rates):.2f}-{max(rates):.2f}); launches "
                  + ", ".join(f"{k} {v}" for k, v in c.items() if v)
                  + f" [{card}]", flush=True)
            check("rejected" in hist[0], f"{name}: fit did not turn the "
                                         f"guard on")
            check(np.isfinite(losses[-1]) and params_ok,
                  f"{name} {route}: the fit ended non-finite")
            out[name][route] = {"steps": n, "loss_first": losses[0],
                                "loss_last": losses[-1],
                                "rejected": rejected,
                                "steps_per_s": statistics.median(rates)}
            if route == "plain":
                check(c["psi2_core_forward"] == c["psi2_core_backward"] == 0,
                      f"{name}: the plain psi2 route launched {c}")
                continue
            main_counts[name] = c
            # a chunk: its steps and one verification forward; the
            # counters hold the warm-up and capture chunks, the profiler
            # one replayed chunk
            fwd, bwd = FIT_CHUNK + 1, FIT_CHUNK
            fused = (fwd, bwd) if name == "collapsed_L2" else (0, 0)
            want = {"psi2_core_forward": fwd, "psi2_core_backward": bwd,
                    "fused_conditional": fused[0],
                    "fused_conditional_backward": fused[1]}
            print(f"collapsed training {name}: a replayed chunk launched "
                  f"(profiler) " + ", ".join(f"{k} {v}" for k, v in r.items()
                                              if v), flush=True)
            check(all(c[k] == FIT_CAPTURE_CHUNKS * v
                      for k, v in want.items()),
                  f"{name}: launch counters {c} != {FIT_CAPTURE_CHUNKS} x "
                  f"{want} (the warm-up and capture chunks)")
            check(all(r[k] == v for k, v in want.items()),
                  f"{name}: a replayed chunk launched {r} (profiler) != "
                  f"{want}")
            if name == "collapsed_L2":
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      f"{name}: training loss did not fall: {losses}")
                metrics = evaluate_regression(
                    model, data["Xs"], data["Ys"], data["Y_std"], S=100,
                    seed=seed)
                print(f"collapsed training {name}: evaluate_regression on "
                      f"the {len(data['Xs'])}-row test split, S=100: rmse "
                      f"{metrics['rmse']:.6f}, loglik "
                      f"{metrics['loglik']:.6f}", flush=True)
                check(np.isfinite(metrics["rmse"])
                      and np.isfinite(metrics["loglik"]),
                      f"{name}: test metrics not finite")
                out[name]["test_metrics"] = metrics
    return out, main_counts


def phase_psi2_backward_timings(collapsed, card):
    """The backward kernel, its plain version and its bound at both cells'
    psi2 operands (CUDA-event medians of 30)."""
    counts = launch_counts()
    shapes = []
    for name in COLLAPSED:
        a32 = [t.contiguous() for t in collapsed["operands"][name]]
        N, M_ = a32[0].shape
        D = a32[4].shape[1]
        a32.append(torch.tensor(np.random.RandomState(3).randn(M_, M_),
                                dtype=torch.float32, device="cuda"))
        with torch.no_grad():
            k_ms = event_ms(lambda: psi2.psi2_core_backward(*a32))
            d_ms = device_ms(lambda: psi2.psi2_core_backward(*a32),
                             DEVICE_KERNELS["psi2_core_backward"])
            p_ms = event_ms(lambda: psi2.psi2_core_backward_plain(*a32),
                            reps=10)
        y_ms = gemm_yardstick_ms(M_, N, M_)
        b_ms, b_by = psi2_bound_ms(N, M_, D, backward=True)
        shapes.append({"config": name, "N": N, "M": M_, "D": D, "ms": k_ms,
                       "device_ms": d_ms, "plain_ms": p_ms,
                       "gemm_yardstick_ms": y_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "exps_M": psi2.terms(N, M_) / 1e6,
                       "gflop": psi2.backward_flops(N, M_, D) / 1e9})
        before = EARLIER_DEVICE_MS[("psi2_core_backward", name)]
        print(f"timing psi2_core_backward {name} N={N} M={M_} D={D}: kernel "
              f"{k_ms:.4f} ms (device time {d_ms}; the earlier design's "
              f"{before} ms), plain {p_ms:.4f} ms "
              f"(median of 10), GEMM yardstick (torch.matmul ({M_} x {N}) "
              f"by ({N} x {M_}), not this function) {y_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; "
              f"{psi2.backward_flops(N, M_, D) / 1e9:.3f} GFLOP at "
              f"{FP32_PEAK / 1e12:.0f} TFLOP/s, {psi2.terms(N, M_) / 1e6:.1f}"
              f" M exps at {SFU_EXP_RATE / 1e12:.2f} T/s), library call: "
              f"none [{card}]", flush=True)
    set_launch_counts(counts)
    return shapes


def phase_collapsed_step_profile(collapsed, seed, card):
    """Per model, on the kernel route: a guarded chunk of 8 training steps
    (and its verification forward), per step: wall (median of 5 chunks),
    host syncs (torch's sync debug mode) and a torch.profiler breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    counts = launch_counts()
    out, steps = {}, 8
    for name in COLLAPSED:
        model = collapsed["build"](name, *ROUTES["kernel"])
        chunk = make_scan_train_step(masked_optimizer(model, 0.01),
                                     inner_steps=steps,
                                     reject_nonfinite=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        times = []
        for i in range(6):
            t0 = time.perf_counter()
            chunk(model, generator=gen)
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0) / steps)
        wall = statistics.median(times)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            chunk(model, generator=gen)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message) for w in caught) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(model, generator=gen)
            torch.cuda.synchronize()
            prof_wall = 1e3 * (time.perf_counter() - t0) / steps
        found = device_breakdown(prof, steps)
        print(f"timing collapsed training step {name} (kernel route, guarded "
              f"chunk of {steps} steps + 1 verification forward), per step: "
              f"wall median {wall:.3f} ms over 5 chunks (all: "
              f"{', '.join(f'{t:.3f}' for t in times)}); host syncs "
              f"{syncs:.2f}; rejected so far {int(chunk.rejected)} [{card}]",
              flush=True)
        out[name] = {"step_ms": wall, "host_syncs": syncs, "busy_ms": None}
        if found is None:
            print(f"profile collapsed training step {name}: device time not "
                  f"measured", flush=True)
            continue
        busy, ops, top = found
        print(f"profile collapsed training step {name}: device busy "
              f"{busy:.3f} ms in {ops:.0f} device ops a step; wall "
              f"{prof_wall:.3f} ms under the profiler, {wall:.3f} ms without "
              f"(idle share {1 - busy / wall:.2f} of the unprofiled wall); "
              f"top device ops: {top}", flush=True)
        out[name].update(busy_ms=busy, device_ops=ops,
                         idle_share=1 - busy / wall)
    set_launch_counts(counts)
    return out


# ---------------------------------------------------------------------------
# phases 16-19: the rbf_gram kernel; the DGP under the default numerics
# (solve_mode='solve') and its full-covariance predictions
# ---------------------------------------------------------------------------

# (case, rows N, columns M, D): the cells' Kuf grams K(Z, X), M inducing
# rows against the batch (training B=10,000; serving 100,000;
# damianou_large's 7372 rows at both widths; collapsed_L2's 1500), ragged
# sizes (one with two 16-dim chunks), and the square K(X, X) at M=100 and
# at the full-covariance batch (M None: X against itself); then the wide
# kernel's (D > 8, operands of std wide_spread(D)): one partial chunk (9),
# two (30, also square: a cluster of 2), a ragged D=37 on ragged N and M,
# the MNIST Kuu and Kuf at D=784 (clusters of 8), and D=100, a multiple of
# the 16-byte copy with a partial last chunk
GRAM_CASES = [("Kuf_M100_B10000_D8", 100, 10000, 8),
              ("Kuf_M100_B100000_D8", 100, 100000, 8),
              ("Kuf_M256_N7372_D8", 256, 7372, 8),
              ("Kuf_M256_N7372_D2", 256, 7372, 2),
              ("Kuf_M100_N1500_D8", 100, 1500, 8),
              ("ragged_N77_M1301_D3", 77, 1301, 3),
              ("ragged_N1000_M33_D19", 1000, 33, 19),
              ("square_M100_D8", 100, None, 8),
              ("square_B200_D8", 200, None, 8),
              ("wide_N1000_M100_D9", 1000, 100, 9),
              ("wide_N1000_M100_D30", 1000, 100, 30),
              ("square_M100_D30", 100, None, 30),
              ("ragged_N77_M1301_D37", 77, 1301, 37),
              ("square_M100_D784", 100, None, 784),
              ("Kuf_N1000_M100_D784", 1000, 100, 784),
              ("partial_chunk_N300_M70_D100", 300, 70, 100)]
# the cases before the wide ones draw unit rows, as they always have
GRAM_WIDE_FROM = 9
GRAM_TIMED = 5                      # the first five cases are timed
GRAM_NAMES = ("dX", "dZ", "dls", "dvar")
SOLVE_STEPS, SOLVE_F64_STEPS = 100, 20
# rbf_gram launches a layer a step on the solve and inverse routes: Kuf
# and Kuu in the conditional, and Kuu again in the KL term
GRAMS_PER_LAYER_STEP = 3
FULL_COV_N = 200
# float32 full-covariance sampling: from layer 1 on, the error of the
# samples against float64 grows about tenfold a layer on both gram routes
# (the float32 Cholesky of the (200, 200) covariances; the diagonal route
# stays flat; PERF.md §6), so layer 0 is held to F32_PATH_ATOL and every
# layer to 2x the plain gram's error
# float32 roundoff: the first layer's full-covariance diagonal against the
# diagonal route (the same products summed in another order), and the
# asymmetry of A^T (SK A); both relative to the variance's scale
FULL_COV_DIAG_RTOL = 1e-5
FULL_COV_SYM_RTOL = 1e-4


def gram_inputs(N, M_, D, seed, spread=1.0):
    """float64 (X, Z, lengthscales, variance) on the card: normal rows of
    std ``spread``, ARD lengthscales in [0.8, 2], variance 1.3; Z is X
    when M_ is None (the square gram)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D) * spread
    Z = X if M_ is None else rng.randn(M_, D) * spread
    arrays = (X, Z, rng.uniform(0.8, 2.0, D), np.float64(1.3))
    out = [torch.tensor(a, dtype=torch.float64, device="cuda")
           for a in arrays]
    if M_ is None:
        out[1] = out[0]
    return out


def check_gram_refusals():
    """On CUDA tensors the kernel wrapper launches or raises: a
    non-contiguous operand, mixed or unsupported dtypes, a CPU operand, a
    variance of two values, and (the Function) float64 lengthscales on
    float32 inputs raise, and nothing launches."""
    n = gram.rbf_gram.launches
    X = torch.randn(64, 3, device="cuda")
    Z = torch.randn(40, 3, device="cuda")
    ls = torch.tensor(0.9, device="cuda")
    v = torch.tensor(1.3, device="cuda")
    k = gram.rbf_gram_kernel
    cases = (
        ("non-contiguous X",
         lambda: k(torch.randn(3, 64, device="cuda").T, Z, ls, v),
         ValueError),
        ("float64 Z with float32 X", lambda: k(X, Z.double(), ls, v),
         TypeError),
        ("float64 variance", lambda: k(X, Z, ls, v.double()), TypeError),
        ("float16", lambda: k(X.half(), Z.half(), ls.half(), v.half()),
         TypeError),
        ("CPU X", lambda: k(X.cpu(), Z, ls, v), ValueError),
        ("two-element variance",
         lambda: k(X, Z, ls, torch.ones(2, device="cuda")), ValueError),
        ("rbf_gram, float64 lengthscales on float32 X",
         lambda: gram.rbf_gram(X, Z, torch.ones(3, dtype=torch.float64,
                                                device="cuda"), v),
         TypeError))
    for case, fn, err in cases:
        raised = None
        try:
            fn()
        except err as e:
            raised = e
        check(raised is not None, f"rbf_gram on CUDA, {case}: did not raise "
                                  f"{err.__name__}")
    check(gram.rbf_gram.launches == n, "a refused rbf_gram call launched")
    # the C entry point refuses a plan other than launch_plan's, before
    # any launch: K keeps its NaNs
    f32, _ = gram._fns()
    Xw, Zw = torch.randn(64, 784, device="cuda"), torch.randn(40, 784,
                                                               device="cuda")
    K = torch.full((64, 40), float("nan"), device="cuda")
    good = gram.launch_plan(64, 40, 784)
    stream = torch.cuda.current_stream().cuda_stream
    plans = {"3 splits": (Xw, Zw, 3), "16 splits": (Xw, Zw, 16),
             "0 splits": (Xw, Zw, 0), "2 splits at D=3": (X, Z, 2),
             "more splits than chunks at D=9": (Xw[:, :9].contiguous(),
                                                Zw[:, :9].contiguous(), 2)}
    for case, (a, b, splits) in plans.items():
        err = f32(a.data_ptr(), b.data_ptr(), ls.data_ptr(), 0,
                  v.data_ptr(), K.data_ptr(), a.shape[0], b.shape[0],
                  a.shape[1], splits, 0, stream)
        check(err != 0, f"rbf_gram C entry point: {case} was not refused")
    torch.cuda.synchronize()
    check(bool(torch.isnan(K).all()), "a refused rbf_gram plan wrote K")
    print("rbf_gram kernel on CUDA: raises on a non-contiguous operand, "
          "mixed dtypes, float16, a CPU operand, a two-element variance and "
          "(the Function) float64 lengthscales on float32 inputs; no launch; "
          f"the C entry point refuses {', '.join(plans)} (launch_plan's at "
          f"64 x 40 x 784: {good['splits']} splits)",
          flush=True)


def gram_grads(fn, X, Z, ls, v, g, square):
    """Gradients of sum(fn(X, Z, ls, v) * g) in X, Z (not for the square
    gram, whose Z is X), ls and v."""
    leaves = [t.detach().clone().requires_grad_() for t in (X, Z, ls, v)]
    if square:
        leaves[1] = leaves[0]
    torch.autograd.backward(fn(*leaves), g)
    return [t.grad for i, t in enumerate(leaves) if not (square and i == 1)]


def gram_bound_ms(N, M_, D, dtype):
    """The least time of one call: its bytes (X, Z, lengthscales,
    variance read once, K written once) over the HBM rate, or its
    operations: in float32 the flops over the fp32 peak and the exps over
    the SFU exp rate; in float64 the flops, the exps' fp64 instructions
    included, over the fp64 peak."""
    item = torch.finfo(dtype).bits // 8
    times = {"bytes": gram.bytes_moved(N, M_, D, item) / HBM_RATE}
    if dtype == torch.float32:
        times["operations"] = max(gram.flops(N, M_, D) / FP32_PEAK,
                                  gram.exps(N, M_) / SFU_EXP_RATE)
    else:
        times["operations"] = (gram.flops(N, M_, D) + gram.F64_EXP_FLOPS
                               * gram.exps(N, M_)) / FP64_PEAK
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def device_ms(fn, name, n=20):
    """Device time of one call of ``fn`` in the kernels whose names hold
    ``name`` (or one of the names in a tuple), by torch.profiler (the
    CUDA-event times of a small kernel also hold the host's time between
    the events); see kernel_records."""
    return kernel_records(fn, name, n)[0]


def kernel_records(fn, name, n=20):
    """(device ms a call, kernel records) of ``fn`` in the kernels whose
    names hold ``name`` (or one of the names in a tuple), each launched
    once a call: torch.profiler over n calls after one unprofiled call,
    each kernel's device time over its own records, summed.  The
    profiler loses the records of the first 3-4 launches it should see
    (phase 11 counts them), so the time over n calls would read low;
    (None, 0) when it saw none."""
    names = (name,) if isinstance(name, str) else tuple(name)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type.name == "CUDA"
             and any(n in e.key for n in names)]
    if not found:
        return None, 0
    return (sum(e.self_device_time_total / e.count for e in found) / 1e3,
            sum(e.count for e in found))


def sass_fp64_opcodes():
    """fp64 opcode counts of the D = 8 float64 kernel's SASS (cuobjdump),
    the source of gram.F64_EXP_FLOPS; None where cuobjdump is missing."""
    exe = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    lib = build._target("rbf_gram")
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "rbf_gram_kernelIdLi8ELb0E" in line
        elif inside and "/*" in line and ";" in line:
            op = line.split("*/")[1].strip().split()[0]
            if op.startswith("@"):
                op = line.split("*/")[1].strip().split()[1]
            op = op.split(".")[0]
            if op in ("DADD", "DFMA", "DMUL", "DSETP", "MUFU"):
                counts[op] = counts.get(op, 0) + 1
    return counts


def phase_gram_kernel(seed, card):
    """rbf_gram against its plain version (same dtype) and against the
    float64 plain version, in float32 and float64; repeats bit-identical;
    the square gram bitwise symmetric with its diagonal exactly var; the
    backward through the Function against autograd through the plain
    version per gradient tensor; timings at the cells' shapes.  Returns
    the float32 worst errors and the timed shapes (launches here are not
    counted)."""
    counts = launch_counts()
    check_gram_refusals()
    worst, shapes = [0.0] * 4, []
    for i, (case, N, M_, D) in enumerate(GRAM_CASES):
        square = M_ is None
        a64 = gram_inputs(N, M_, D, seed + i,
                          wide_spread(D) if i >= GRAM_WIDE_FROM else 1.0)
        Mc = N if square else M_
        g64 = torch.tensor(np.random.RandomState(seed + 50 + i).randn(N, Mc),
                           dtype=torch.float64, device="cuda")
        for dtype in (torch.float32, torch.float64):
            tag = f"{case} {str(dtype).split('.')[1]}"
            X, Z, ls, v = (t.to(dtype) for t in a64)
            if square:
                Z = X
            with torch.no_grad():
                fwd = lambda: (gram.rbf_gram(X, Z, ls, v),)  # noqa: E731
                got = fwd()
                torch.cuda.synchronize()
                plain = (gram.rbf_gram_plain(X, Z, ls, v),)
                ref = (gram.rbf_gram_plain(*a64),)
                errs = compare(got, plain, ref, joint_scale=True)
                check_repeat("rbf_gram", tag, fwd, got)
            if dtype == torch.float32:
                hold("rbf_gram", tag, errs)
                worst = list(map(max, worst, errs))
                with torch.no_grad():
                    other = gram.rbf_gram_kernel(X, Z, ls, v,
                                                 fast_exp=not gram.FAST_EXP)
                e_other = compare((other,), plain, ref, joint_scale=True)[2]
                print(f"kernel rbf_gram {tag}: exp variant in use "
                      f"{'__expf' if gram.FAST_EXP else 'expf'}; the other's "
                      f"error vs f64 {e_other:.3e} of scale", flush=True)
            else:
                print(f"kernel rbf_gram {tag}: |kernel-plain| {errs[0]:.3e} "
                      f"({errs[1]:.3e} of scale)", flush=True)
                check(errs[1] <= KERNEL_VS_PLAIN_RTOL,
                      f"rbf_gram {tag}: kernel vs plain {errs[1]} > "
                      f"{KERNEL_VS_PLAIN_RTOL} of the output scale")
            if square:
                K = got[0]
                check(torch.equal(K, K.T), f"rbf_gram {tag}: K(X, X) is not "
                                           f"bitwise symmetric")
                check(bool((torch.diagonal(K) == v).all()),
                      f"rbf_gram {tag}: the diagonal is not exactly var")
            g = g64.to(dtype)
            kg = gram_grads(gram.rbf_gram, X, Z, ls, v, g, square)
            pg = gram_grads(gram.rbf_gram_plain, X, Z, ls, v, g, square)
            rg = gram_grads(gram.rbf_gram_plain, *a64, g64, square)
            b_errs = compare(kg, pg, rg, joint_scale=False)
            names = [n for n in GRAM_NAMES if not (square and n == "dZ")]
            per = ", ".join(
                f"{n} {(k.double() - r).abs().max().item() / max(r.abs().max().item(), 1.0):.2e}"
                f"/{(p.double() - r).abs().max().item() / max(r.abs().max().item(), 1.0):.2e}"
                for n, k, p, r in zip(names, kg, pg, rg))
            print(f"kernel rbf_gram backward {tag}: |Function-plain| "
                  f"{b_errs[1]:.3e} of scale; error vs f64 of scale, "
                  f"Function/plain: {per}", flush=True)
            check(b_errs[1] <= KERNEL_VS_PLAIN_RTOL,
                  f"rbf_gram backward {tag}: Function vs plain autograd "
                  f"{b_errs[1]} > {KERNEL_VS_PLAIN_RTOL} of scale")
            if i >= GRAM_TIMED:
                continue
            with torch.no_grad():
                k_ms = event_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v))
                f_ms = event_ms(lambda: gram.rbf_gram(X, Z, ls, v))
                p_ms = event_ms(lambda: gram.rbf_gram_plain(X, Z, ls, v))
                d_ms = device_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v),
                                 DEVICE_KERNELS["rbf_gram"])
            y_ms = gemm_yardstick_ms(N, D, Mc)
            b_ms, b_by = gram_bound_ms(N, Mc, D, dtype)
            shapes.append({"case": case, "dtype": str(dtype), "N": N,
                           "M": Mc, "D": D, "ms": k_ms, "device_ms": d_ms,
                           "function_ms": f_ms, "plain_ms": p_ms,
                           "gemm_yardstick_ms": y_ms,
                           "bound_ms": b_ms, "bound_by": b_by})
            d_txt = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
            before = EARLIER_DEVICE_MS.get(("rbf_gram", tag))
            print(f"timing rbf_gram {tag}: kernel {k_ms:.4f} ms (device time "
                  f"a launch under torch.profiler {d_txt}"
                  + ("" if before is None else
                     f"; the earlier design's {before} ms")
                  + f"; through the autograd Function {f_ms:.4f} ms), plain "
                  f"{p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), GEMM yardstick "
                  f"(torch.matmul ({N} x {D}) by ({D} x {Mc}) float32, not "
                  f"this function) {y_ms:.4f} ms, library call: none "
                  f"[{card}]", flush=True)
    ops = sass_fp64_opcodes()
    print(f"rbf_gram float64 kernel SASS opcode counts: {ops}", flush=True)
    set_launch_counts(counts)
    return worst, shapes


@contextlib.contextmanager
def plain_gram():
    """gram.plain_on_card(), checked: rbf_gram launches nothing inside."""
    n = gram.rbf_gram.launches
    with gram.plain_on_card():
        yield
    check(gram.rbf_gram.launches == n, "plain_on_card() launched rbf_gram")


def solve_config(dtype):
    """The default numerics: Config() itself in float64; in float32 the
    same with jitter 1e-5 (solve_mode='solve', use_pallas=False)."""
    if dtype == torch.float64:
        return Config()
    return Config(dtype=torch.float32, jitter=1e-5)


def phase_solve_dgp(seed, card):
    """The slice's main path: the headline model under the default
    numerics, fit in float32 (and in float64 with Config() itself), with
    its rbf_gram launches a step; evaluate_regression; the ELBO gradient
    through the kernel against the plain gram."""
    model, data = build_model(seed, num_samples=TRAIN_S,
                              random_posterior=False,
                              config=solve_config(torch.float32))
    hist, counts, replay = run_fit(model, SOLVE_STEPS, seed)
    losses = [h["loss"] for h in hist]
    rate = statistics.median(h["iters_per_sec"] for h in hist[1:])
    print(f"solve route float32 (Config(dtype=float32, jitter=1e-5), "
          f"solve_mode='solve'): fit {SOLVE_STEPS} Adam steps, batch {BATCH}"
          f", S={TRAIN_S}: loss {losses[0]:.3f} (steps 1-10) -> "
          f"{losses[-1]:.3f} (last 10); steps/s median of the chunks after "
          f"the first {rate:.2f}; rbf_gram launches in a replayed chunk "
          f"(profiler) {replay['rbf_gram']} = "
          f"{replay['rbf_gram'] / FIT_CHUNK:.0f} a step (expected "
          f"{GRAMS_PER_LAYER_STEP} a layer: Kuf, Kuu, the KL's Kuu); "
          f"counters (the warm-up and capture chunks): {counts}; profiler: "
          f"{replay} [{card}]", flush=True)
    check_fit_launches("solve route", counts, replay,
                       {"rbf_gram": GRAMS_PER_LAYER_STEP * LAYERS})
    check(all(np.isfinite(losses)), "solve route: loss not finite")
    check(losses[-1] < losses[0], f"solve route: loss did not fall {losses}")

    m64, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False,
                         config=solve_config(torch.float64))
    # not profiled: its second chunk's rate is printed
    h64, c64, _ = run_fit(m64, SOLVE_F64_STEPS, seed, profiled=False)
    print(f"solve route float64 (Config()): fit {SOLVE_F64_STEPS} steps: "
          f"loss {h64[0]['loss']:.3f} -> {h64[-1]['loss']:.3f}; steps/s of "
          f"the second chunk {h64[-1]['iters_per_sec']:.2f}; rbf_gram "
          f"launches {c64['rbf_gram']} [{card}]", flush=True)
    check(all(np.isfinite([h["loss"] for h in h64])),
          "solve route float64: loss not finite")
    check(c64["rbf_gram"] == GRAMS_PER_LAYER_STEP * LAYERS
          * FIT_CAPTURE_CHUNKS * FIT_CHUNK,
          f"solve route float64: rbf_gram launches {c64['rbf_gram']} (the "
          f"warm-up and capture chunks)")
    del m64

    metrics = evaluate_regression(model, data["Xs"], data["Ys"],
                                  data["Y_std"], S=100, seed=seed)
    print(f"solve route evaluate_regression on the {len(data['Xs'])}-row "
          f"test split, S=100: rmse {metrics['rmse']:.6f}, loglik "
          f"{metrics['loglik']:.6f}", flush=True)
    check(np.isfinite(metrics["rmse"]) and np.isfinite(metrics["loglik"]),
          "solve route: test metrics not finite")

    ref, _ = build_model(seed, device="cpu", num_samples=TRAIN_S,
                         random_posterior=False,
                         config=Config(dtype=torch.float64, jitter=1e-5))
    ref.load_state_dict(model.state_dict())
    print("solve route gradient: the plain-gram reference runs inside "
          "gram.plain_on_card() (rbf_gram's plain version on the card; set "
          "by chip_smoke.py only)", flush=True)
    worst = gradient_errors(
        "solve route", {"kernel f32": (model, contextlib.nullcontext()),
                        "plain gram f32": (model, plain_gram())},
        ref, seed)
    check(worst["kernel f32"] <= 2.0 * worst["plain gram f32"],
          f"solve route ELBO gradient through rbf_gram {worst['kernel f32']}"
          f" > 2x the plain gram's {worst['plain gram f32']}")
    return model, data, {"losses": [losses[0], losses[-1]],
                         "f64_losses": [h64[0]["loss"], h64[-1]["loss"]],
                         "launches_per_step": replay["rbf_gram"] / FIT_CHUNK,
                         "test_metrics": metrics,
                         "grad_rel_err": worst}, counts["rbf_gram"]


def phase_solve_timings(model, seed, card):
    """steps/s of fit on the solve route beside the inverse route (both
    float32, use_pallas=False, in turns), and a profiled step of each (the
    inverse route's on its freshly built model)."""
    models = {"solve": build_model(seed, num_samples=TRAIN_S,
                                   random_posterior=False,
                                   config=solve_config(torch.float32))[0],
              "inverse": build_model(seed, num_samples=TRAIN_S,
                                     random_posterior=False,
                                     use_pallas=False)[0]}
    rates = steps_per_s(models, seed, card, "solve vs inverse route")
    inverse = phase_training_profile(models["inverse"], seed, card,
                                     route="use_pallas=False")
    del models
    step = phase_training_profile(model, seed, card,
                                  route="solve_mode='solve'")
    return rates, step, inverse


def max_diff(a, b):
    return max((x.double().cpu() - y.double().cpu()).abs().max().item()
               for x, y in zip(a, b))


def asymmetry(var):
    """max |V - V^T| over the (N, N) slices of var (S, N, N, D), relative
    to the variance's scale."""
    return ((var - var.transpose(1, 2)).abs().max()
            / var.abs().max().clamp_min(1.0)).item()


def layer_errors(got, ref):
    """Per layer, max |d| over F, mean and var of two propagations."""
    return [max_diff(g, r) for g, r in zip(zip(*got), zip(*ref))]


def phase_full_cov(model, data, seed, card):
    """predict_f_full_cov and predict_all_layers_full_cov of the trained
    float32 solve-route model at 200 test rows, S=10, fixed draws, against
    the float64 CPU path, through the kernel and through the plain gram
    (2x rule), layer 0 also absolutely; the diagonal route's errors beside
    them; the first layer's diagonal against the diagonal route; every
    (N, N) slice symmetric; then DGPCollapsed at collapsed_L2."""
    xs = data["Xs"][:FULL_COV_N]
    rng = np.random.RandomState(seed + 13)
    zs = [rng.randn(TRAIN_S, FULL_COV_N, d)
          for d in (8,) * (LAYERS - 1) + (1,)]
    ref, _ = build_model(seed, device="cpu", num_samples=TRAIN_S,
                         random_posterior=False,
                         config=Config(dtype=torch.float64, jitter=1e-5))
    ref.load_state_dict(model.state_dict())
    times = {}
    for what, fn in (("predict_f_full_cov", model.predict_f_full_cov),
                     ("predict_all_layers_full_cov",
                      model.predict_all_layers_full_cov)):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(xs, S=TRAIN_S, zs=zs)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        times[what] = statistics.median(runs)
    fm, fv = model.predict_f_full_cov(xs, S=TRAIN_S, zs=zs)
    full = model.predict_all_layers_full_cov(xs, S=TRAIN_S, zs=zs)
    with plain_gram():
        pfull = model.predict_all_layers_full_cov(xs, S=TRAIN_S, zs=zs)
    rm, rv = ref.predict_f_full_cov(xs, S=TRAIN_S, zs=zs)
    rfull = ref.predict_all_layers_full_cov(xs, S=TRAIN_S, zs=zs)
    diag = model.predict_all_layers(xs, S=TRAIN_S, zs=zs)
    rdiag = ref.predict_all_layers(xs, S=TRAIN_S, zs=zs)
    for t in (fm, fv, *full[0], *full[1], *full[2]):
        check(bool(torch.isfinite(t).all()), "full-cov output not finite")
    check(tuple(fv.shape) == (TRAIN_S, FULL_COV_N, FULL_COV_N, 1),
          f"predict_f_full_cov var shape {tuple(fv.shape)}")
    # the same parameters and draws in float32 on the CPU: whether the
    # card's float32 error (cuSOLVER's factorizations) grows through the
    # layers faster than the CPU's (LAPACK's)
    cpu32, _ = build_model(seed, device="cpu", num_samples=TRAIN_S,
                           random_posterior=False,
                           config=solve_config(torch.float32))
    cpu32.load_state_dict(model.state_dict())
    cfull = cpu32.predict_all_layers_full_cov(xs, S=TRAIN_S, zs=zs)
    errs = {"kernel": layer_errors(full, rfull),
            "plain gram": layer_errors(pfull, rfull),
            "diagonal route": layer_errors(diag, rdiag),
            "cpu f32": layer_errors(cfull, rfull)}
    ratio = [c / max(p, 1e-30) for c, p in zip(errs["kernel"],
                                                 errs["cpu f32"])]
    print(f"full cov float32 error per layer vs the f64 CPU path, card "
          f"(cuSOLVER) beside CPU (LAPACK), same parameters and draws: "
          + "; ".join(f"layer {l} {c:.2e} / {p:.2e} (x{r:.2f})"
                      for l, (c, p, r) in enumerate(zip(
                          errs["kernel"], errs["cpu f32"], ratio)))
          + f"; card more than 2x the CPU at a layer: "
            f"{any(r > 2.0 for r in ratio)} [{card}]", flush=True)
    d_f = max_diff((fm, fv), (rm, rv))
    diag0 = torch.diagonal(full[2][0], dim1=1, dim2=2).transpose(1, 2)
    e_diag = ((diag0 - diag[2][0]).abs().max()
              / diag[2][0].abs().max().clamp_min(1.0)).item()
    asym = max(asymmetry(v) for v in full[2])
    print(f"full cov solve route f32 ({FULL_COV_N} test rows, S={TRAIN_S}, "
          f"fixed draws) vs the f64 CPU path, max |d| over F, mean, var per "
          f"layer: " + "; ".join(f"{k} " + ", ".join(f"{e:.2e}" for e in v)
                                  for k, v in errs.items())
          + f"; predict_f_full_cov {d_f:.3e}; layer 0 diagonal vs the "
          f"diagonal route {e_diag:.3e} of scale; worst asymmetry "
          f"{asym:.3e} of scale; latency predict_f_full_cov "
          f"{times['predict_f_full_cov']:.3f} ms, predict_all_layers_full_cov"
          f" {times['predict_all_layers_full_cov']:.3f} ms (median of 5) "
          f"[{card}]", flush=True)
    check(errs["kernel"][0] <= F32_PATH_ATOL,
          f"full cov layer 0 f32 vs f64: {errs['kernel'][0]} > "
          f"{F32_PATH_ATOL}")
    check(max(errs["kernel"]) <= 2.0 * max(errs["plain gram"]),
          f"full cov through rbf_gram {max(errs['kernel'])} > 2x the plain "
          f"gram's {max(errs['plain gram'])}")
    check(e_diag <= FULL_COV_DIAG_RTOL,
          f"full cov layer 0 diagonal vs the diagonal route {e_diag} > "
          f"{FULL_COV_DIAG_RTOL}")
    check(asym <= FULL_COV_SYM_RTOL,
          f"full cov asymmetry {asym} > {FULL_COV_SYM_RTOL}")

    build, _ = collapsed_models(SyntheticRegression(N=8192, D=8).get_data(
        split=0), seed)
    cm = build("collapsed_L2", *ROUTES["kernel"])
    t0 = time.perf_counter()
    cmean, cvar = cm.predict_f_full_cov(xs, S=TRAIN_S)
    torch.cuda.synchronize()
    c_ms = 1e3 * (time.perf_counter() - t0)
    c_asym = asymmetry(cvar)
    print(f"full cov collapsed_L2 (DGPCollapsed, kernel route) "
          f"predict_f_full_cov, {FULL_COV_N} rows, S={TRAIN_S}: var "
          f"{tuple(cvar.shape)}, asymmetry {c_asym:.3e} of scale, "
          f"{c_ms:.3f} ms (first call) [{card}]", flush=True)
    check(bool(torch.isfinite(cmean).all() and torch.isfinite(cvar).all()),
          "collapsed_L2 full cov not finite")
    check(c_asym <= FULL_COV_SYM_RTOL,
          f"collapsed_L2 full cov asymmetry {c_asym}")
    return {"layer_errors_vs_f64": errs, "card_over_cpu_f32": ratio,
            "predict_f_full_cov_vs_f64": d_f,
            "diag_rel_err": e_diag,
            "asymmetry": asym, "latency_ms": times,
            "collapsed_L2_ms": c_ms, "collapsed_L2_asymmetry": c_asym}


# ---------------------------------------------------------------------------
# phases 20-24: the one-program dispatch (captured CUDA graphs) and
# checkpoints
# ---------------------------------------------------------------------------

# fit steps of the graphed-vs-eager comparison (100 until phase 31 came:
# cut to keep the script near 900 s; the gate is the same at 50)
GRAPH_STEPS = 50
GRAPH_CHUNK = 10            # fit's chunk: one replay
# timed chunks a route and mode, in turns (6 until phase 31 came: cut to
# keep the script near 900 s; the steps/s medians it gives are not gated)
GRAPH_ROUNDS = 4
# graphed vs eager parameters after GRAPH_STEPS steps: bit for bit, or
# else within this fraction of each parameter tensor's scale
GRAPH_VS_EAGER_RTOL = 1e-4
LATENCY_REPS = 7
RESUME_STEPS = 20           # k: k steps, a checkpoint, k more vs 2k
# rows of the headline DGP's training set set to NaN for one guarded chunk
NAN_ROWS = 5


@contextlib.contextmanager
def no_sync():
    """torch's sync debug mode at 'error' while inside: a host sync
    raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def param_agreement(a, b):
    """(bit for bit, worst max|a - b| / max|b| over the parameter tensors,
    the tensor where it is) for two models' parameters."""
    same, worst, where = True, 0.0, None
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        same = same and torch.equal(p, q)
        d = ((p - q).abs().max() / q.abs().max().clamp_min(1e-30)).item()
        if d > worst:
            worst, where = d, name
    return same, worst, where


def total_device_ms(fn, n=20):
    """(device ms, device ops) of one call of ``fn``, all its device ops
    summed (torch.profiler over n calls); None when the profiler saw
    none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    found = device_breakdown(prof, n)
    return None if found is None else found[:2]


def capture_calls(fn, calls):
    """A CUDA graph of ``calls`` calls of ``fn`` (after an eager call and
    one on a side stream), replayed once."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    return g


def graph_calls_ms(fn, calls=10, reps=10, rounds=5):
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA
    graph, timed with CUDA events over ``reps`` replays back to back, per
    call, the median of ``rounds`` (no host time between the calls, and no
    profiler records to lose)."""
    g = capture_calls(fn, calls)
    times = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps * calls))
    del g
    return statistics.median(times)


def graph_event_ms(fn, reps=20, rounds=5):
    """Device ms of one call of ``fn`` captured in a CUDA graph: CUDA
    events around ``reps`` replays back to back, per replay, the median of
    ``rounds``; the launch gaps are a graph's, as in a captured chunk."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    times = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del g
    return statistics.median(times)


def phase_cholesky_rungs(seed, card):
    """The sync-free rung selection's cost: every rung factorized in one
    batched cholesky_ex, against one factorization (the healthy path of
    the design with a host read) and against one call a rung, at the
    DGP's Kuu (M=100, 3 absolute rungs) and the collapsed cells' B (M=100
    and 256, the 8 relative rungs); and whether the first rung's factor
    keeps torch.linalg.cholesky's bits.  Each is timed captured in a CUDA
    graph (CUDA events over its replays) and by the profiler's sum of its
    device ops.  The CUDA graph conditional node (the other design) is not
    in this PyTorch's Python API."""
    from doubly_stochastic_dgp_tpu_torch.ops.linalg import safe_cholesky
    cond = sorted({n for mod in (torch.cuda, torch.cuda.graphs)
                   for n in dir(mod) if "conditional" in n.lower()})
    print(f"cholesky rungs: CUDA graph conditional nodes in torch "
          f"{torch.__version__}'s torch.cuda API: {cond or 'none'}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for M_, relative in ((100, False), (100, True), (256, True)):
        A = torch.randn(M_, M_, generator=g, device="cuda")
        K = A @ A.T / M_ + torch.eye(M_, device="cuda")
        js = ((0.0, 1e-7, 1e-5, 1e-3, 1e-1, 1.0, 1e1, 1e3) if relative
              else (1e-5, 1e-3, 1e-1))
        I = torch.eye(M_, device="cuda")
        stack = torch.stack([K + j * I for j in js])
        fn = ((lambda: safe_cholesky_ladder(K)) if relative
              else (lambda: safe_cholesky(K, js[0])))
        ref = torch.linalg.cholesky(K + js[0] * I)
        got = fn()
        fns = {"one factorization":
                   lambda: torch.linalg.cholesky_ex(K + js[0] * I),
               "one call a rung":
                   lambda: [torch.linalg.cholesky_ex(K + j * I) for j in js],
               "batched rungs": lambda: torch.linalg.cholesky_ex(stack),
               "safe_cholesky": fn}
        t = {k: graph_event_ms(f) for k, f in fns.items()}
        t_prof = {k: total_device_ms(f) for k, f in fns.items()}
        kind = "relative" if relative else "absolute"
        key = f"M={M_} {len(js)} {kind} rungs"
        out[key] = {"graph_replay_ms": t, "profiler_ms": t_prof,
                    "first_rung_bits_equal": torch.equal(got, ref),
                    "first_rung_max_diff": (got - ref).abs().max().item()}
        print(f"cholesky rungs {key}: device ms a call, captured and "
              f"replayed (CUDA events) "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + "; the profiler's sum of device ops (ms, ops) "
              + ", ".join(f"{k} {v if v is None else (round(v[0], 4), v[1])}"
                          for k, v in t_prof.items())
              + f"; the first rung's factor against torch.linalg.cholesky: "
              f"bits equal {out[key]['first_rung_bits_equal']}, max |d| "
              f"{out[key]['first_rung_max_diff']:.3e} [{card}]", flush=True)
    return out


def graph_routes(seed, build_collapsed):
    """{route: (build function, minibatch)}: the headline DGP on the fused
    route and on the solve route, and the two collapsed cells on the kernel
    route (full batch, fit's guard on)."""
    def dgp(config=None):
        return lambda: build_model(seed, num_samples=TRAIN_S,
                                   random_posterior=False, config=config)[0]
    return {"use_pallas=True": (dgp(), BATCH),
            "solve_mode='solve'": (dgp(solve_config(torch.float32)), BATCH),
            "damianou_large": (lambda: build_collapsed(
                "damianou_large", *ROUTES["kernel"]), None),
            "collapsed_L2": (lambda: build_collapsed(
                "collapsed_L2", *ROUTES["kernel"]), None)}


def profile_chunk(run, steps, what, expect=None):
    """(device busy ms, device ops, top device ops) a step and each
    record's device launches (:func:`device_launches`) in one ``run()`` of
    ``steps`` steps under torch.profiler.  Profiles again, up to
    PROFILE_TRIES times in all, when the profiler saw no device time
    (raises if it never does) or, given ``expect``, counted other launches
    than it (the last try's are returned).  Each profile starts with
    :func:`shield_profile`'s uncounted work, as ``ProfiledChunk``'s do: a
    run whose first kernel is a counted one (28a's replay starts with a
    gram) would otherwise lose its record whenever the profiler drops a
    profile's first device records."""
    from torch.profiler import ProfilerActivity, profile
    found = None
    for i in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            shield_profile()
            run()
            torch.cuda.synchronize()
        found = device_breakdown(prof, steps)
        launches = device_launches(prof)
        if found is None:
            print(f"{what}: the profiler saw no device time (try {i}); "
                  f"profiling again", flush=True)
        elif expect is None or launches == expect:
            return found, launches
        elif i < PROFILE_TRIES:
            print(f"{what}: the profiler counted {launches}, expected "
                  f"{expect} (try {i}); profiling again", flush=True)
    check(found is not None,
          f"{what}: the profiler saw no device time in {PROFILE_TRIES} tries")
    return found, launches


def phase_graphs(seed, build_collapsed, card):
    """Per route: GRAPH_STEPS fit steps graphed and eager from one seed, their
    parameters compared; then chunks of 10 steps graphed and eager in
    turns (steps/s; the eager chunks' launches by the counters, which a
    replay must not tick), every replay under torch's sync debug mode at
    'error'; a profiled chunk of each (device busy, device ops, idle
    share, each kernel's device launches; the replay's must equal the
    eager chunk's counts; the eager profile's are printed only, since
    the profiler can lose a few of an eager chunk's ~27,000 kernel
    records); the graph's memory pool."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    counts0 = launch_counts()
    out = {}
    for route, (build_fn, batch) in graph_routes(seed,
                                                 build_collapsed).items():
        guard = batch is None
        ma, mb = build_fn(), build_fn()
        fit(ma, GRAPH_STEPS, 0.01, batch_size=batch, seed=seed,
            log_every=GRAPH_CHUNK)
        with eager_on_card():
            fit(mb, GRAPH_STEPS, 0.01, batch_size=batch, seed=seed,
                log_every=GRAPH_CHUNK)
        torch.cuda.synchronize()
        same, worst, where = param_agreement(ma, mb)
        print(f"graphs {route}: parameters after {GRAPH_STEPS} fit steps, "
              f"graphed vs eager: bit for bit {same}; worst {worst:.3e} of "
              f"scale ({where})", flush=True)
        check(same or worst <= GRAPH_VS_EAGER_RTOL,
              f"{route}: graphed and eager parameters differ by {worst} of "
              f"scale in {where}")
        chunks = {mode: make_scan_train_step(
            masked_optimizer(m, 0.01), batch, GRAPH_CHUNK,
            reject_nonfinite=guard) for mode, m in (("graphed", ma),
                                                     ("eager", mb))}
        gens = {mode: torch.Generator(device="cuda").manual_seed(seed + 1)
                for mode in chunks}
        runs = {"graphed": lambda: chunks["graphed"](ma, gens["graphed"]),
                "eager": lambda: chunks["eager"](mb, gens["eager"])}
        runs["graphed"]()                          # capture
        with eager_on_card():
            runs["eager"]()
        torch.cuda.synchronize()
        rates = {m: [] for m in runs}
        counted = {}
        for _ in range(GRAPH_ROUNDS):
            for mode in runs:
                before = launch_counts()
                t0 = time.perf_counter()
                if mode == "graphed":
                    with no_sync():
                        runs[mode]()
                else:
                    with eager_on_card():
                        runs[mode]()
                torch.cuda.synchronize()
                rates[mode].append(GRAPH_CHUNK / (time.perf_counter() - t0))
                counted[mode] = {n: launch_counts()[n] - before[n]
                                 for n in KERNEL_NAMES}
        check(not any(counted["graphed"].values()),
              f"{route}: a replay ticked the launch counters "
              f"{counted['graphed']}")
        rec = {"bit_for_bit": same, "worst_rel_diff": worst,
               "launches_per_step": {n: v / GRAPH_CHUNK for n, v in
                                     counted["eager"].items() if v},
               "pool_bytes": chunks["graphed"].graph[2].pool_bytes()}
        by_prof = {}
        for mode, run in runs.items():
            rate = statistics.median(rates[mode])
            with (eager_on_card() if mode == "eager"
                  else contextlib.nullcontext()):
                (busy, ops, top), by_prof[mode] = profile_chunk(
                    run, GRAPH_CHUNK, f"graphs {route} {mode}",
                    expect=counted["eager"] if mode == "graphed" else None)
            rec[mode] = {"steps_per_s": rate, "rates": rates[mode],
                         "step_ms": 1e3 / rate, "busy_ms": busy,
                         "device_ops": ops,
                         "idle_share": 1 - busy * rate / 1e3,
                         "device_launches_per_step": {
                             n: v / GRAPH_CHUNK
                             for n, v in by_prof[mode].items() if v},
                         "top": top}
            print(f"graphs {route} {mode}: steps/s median of "
                  f"{GRAPH_ROUNDS} chunks of {GRAPH_CHUNK} (in turns) "
                  f"{rate:.2f} (all: "
                  f"{', '.join(f'{r:.2f}' for r in rates[mode])}); device "
                  f"busy {busy:.3f} ms in {ops:.0f} device ops a step, idle "
                  f"share {rec[mode]['idle_share']:.3f}; kernel launches a "
                  f"step (profiler) {rec[mode]['device_launches_per_step']};"
                  f" top: {top} [{card}]", flush=True)
        print(f"graphs {route}: kernel launches a step, eager by the "
              f"counters {rec['launches_per_step']}, graphed replay by the "
              f"profiler {rec['graphed']['device_launches_per_step']}; "
              f"graph pool {rec['pool_bytes'] / 2**20:.1f} MiB", flush=True)
        check(by_prof["graphed"] == counted["eager"],
              f"{route}: a replayed chunk launched {by_prof['graphed']} "
              f"(profiler) != the eager chunk's {counted['eager']} "
              f"(counters)")
        check(rec["graphed"]["idle_share"] < rec["eager"]["idle_share"],
              f"{route}: graphed idle share {rec['graphed']['idle_share']} "
              f"not below eager {rec['eager']['idle_share']}")
        out[route] = rec
        del ma, mb, chunks, runs
    set_launch_counts(counts0)
    return out


def phase_guard_nan(seed, card):
    """The guarded chunk with NaN training rows for one chunk, graphed and
    eager: three chunks (clean, NAN_ROWS rows of X NaN, restored); the
    NaN chunk must reject some steps and keep a finite state, the next
    must recover, and graphed must equal eager bit for bit."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    counts0 = launch_counts()
    res = {}
    for mode in ("graphed", "eager"):
        model = build_model(seed, num_samples=TRAIN_S,
                            random_posterior=False)[0]
        chunk = make_scan_train_step(masked_optimizer(model, 0.01), BATCH,
                                     GRAPH_CHUNK, reject_nonfinite=True)
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        X0 = model.X_data.clone()
        losses, rejected = [], []
        with (eager_on_card() if mode == "eager"
              else contextlib.nullcontext()):
            for c in range(3):
                if c == 1:
                    model.X_data[:NAN_ROWS] = float("nan")
                if c == 2:
                    model.X_data.copy_(X0)
                losses.append(float(chunk(model, gen)))
                rejected.append(int(chunk.rejected))
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        res[mode] = (model, losses, rejected, finite)
        print(f"guard NaN injection {mode}: chunk losses {losses}, rejected "
              f"so far {rejected}, parameters finite {finite} [{card}]",
              flush=True)
    (mg, lg, rg, fg), (me, le, re_, _) = res["graphed"], res["eager"]
    same = param_agreement(mg, me)[0]
    check(same and lg == le and rg == re_,
          f"guard NaN injection: graphed {lg} {rg} != eager {le} {re_} or "
          f"parameters differ")
    check(rg[0] == 0 and rg[1] > 0 and rg[2] == rg[1] and fg
          and np.isfinite(lg).all(),
          f"guard NaN injection: did not reject and recover: {lg}, {rg}")
    set_launch_counts(counts0)
    return {"losses": lg, "rejected": rg, "bit_for_bit": same}


def phase_graph_serving(seed, card):
    """1000-row S=100 requests to the live and the cached server, graphed
    and eager in turns: latency (median of 7), pinned-seed answers bit
    for bit, replays under sync debug 'error', the pool the server's
    graphs share."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    model, data = build_model(seed)
    X = torch.as_tensor(data["X"][:1000], dtype=torch.float32,
                        device="cuda")
    out = {}
    for name, pre in (("live", False), ("cached", True)):
        serve = make_server(model, S=S, precompute=pre,
                            batch_buckets=BUCKETS)
        a = serve(X, seed=5)
        with eager_on_card():
            b = serve(X, seed=5)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        check(same, f"{name} server: graphed and eager answers differ at a "
                    f"pinned seed")
        times = {"graphed": [], "eager": []}
        for i in range(LATENCY_REPS):
            for mode in times:
                t0 = time.perf_counter()
                if mode == "graphed":
                    with no_sync():
                        serve(X, seed=3000 + i)
                else:
                    with eager_on_card():
                        serve(X, seed=3000 + i)
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - t0))
        lat = {m: statistics.median(t) for m, t in times.items()}
        pool = next(iter(serve.captured.values()))[3].pool_bytes()
        out[name] = {"bit_for_bit": same, "latency_ms": lat,
                     "pool_bytes": pool,
                     "buckets": [k[0][0] for k in serve.captured]}
        print(f"graphs serving {name}, 1000-row request, S={S}: graphed "
              f"{lat['graphed']:.3f} ms, eager {lat['eager']:.3f} ms "
              f"(median of {LATENCY_REPS}, in turns; all graphed "
              f"{', '.join(f'{t:.3f}' for t in times['graphed'])}); pinned "
              f"seed bit for bit {same}; replays with no host sync; the "
              f"graph pool of the buckets {out[name]['buckets']} "
              f"{pool / 2**20:.1f} MiB [{card}]", flush=True)
    return out


def phase_resume(seed, card):
    """fit k steps with a checkpoint, restore into a fresh model and fit k
    more, against 2k straight steps, graphed, bit for bit."""
    import shutil
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    counts0 = launch_counts()

    def fresh():
        return build_model(seed, num_samples=TRAIN_S,
                           random_posterior=False)[0]

    kw = dict(learning_rate=0.01, batch_size=BATCH, seed=seed,
              log_every=GRAPH_CHUNK)
    try:
        straight, want = fit(fresh(), 2 * RESUME_STEPS, **kw)
        fit(fresh(), RESUME_STEPS, ckpt_dir=ckpt, **kw)
        resumed, hist = fit(fresh(), 2 * RESUME_STEPS, ckpt_dir=ckpt, **kw)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same, worst, where = param_agreement(resumed, straight)
    print(f"checkpoint resume: fit {RESUME_STEPS} steps, checkpoint, a "
          f"fresh model restored and fit to {2 * RESUME_STEPS}, against "
          f"{2 * RESUME_STEPS} straight steps: bit for bit {same} (worst "
          f"{worst:.3e} in {where}); last loss {hist[-1]['loss']} vs "
          f"{want[-1]['loss']} [{card}]", flush=True)
    check(same and hist[-1]["loss"] == want[-1]["loss"]
          and hist[0]["iter"] > RESUME_STEPS,
          "a resumed fit differs from the straight one")
    set_launch_counts(counts0)
    return {"bit_for_bit": same}


# ---------------------------------------------------------------------------
# phase 25: classification with the paper's MNIST DGP
# ---------------------------------------------------------------------------

# MNIST's shape (60,000 training and 10,000 test rows, 784 pixels in
# [0, 1], 10 classes); the DGPs of the reference MNIST demo (DGP2 784 ->
# 30 -> 10, DGP3 784 -> 30 -> 30 -> 10; M=100, minibatch 1000, S=1, RBF
# with lengthscale 2.0 and variance 2.0 on every layer, float32, jitter
# 1e-5, solve_mode='inverse')
MNIST_N, MNIST_NS, MNIST_D, MNIST_K = 60000, 10000, 784, 10
MNIST_LATENT = 20
MNIST_MODELS = {"DGP2": (30,), "DGP3": (30, 30)}
MNIST_STEPS = 300
# the class probabilities at fixed draws, float32 on the card against the
# port's float64 CPU path (probabilities, so absolute)
MNIST_PROBS_ATOL = 5e-3
# the fused pair at the MNIST layers' shapes: (case, B, Dx, Do, with the
# backward); minibatch 1000 at S=1, and layer 0 of a 1000-row S=100
# request
MNIST_KERNEL_CASES = [("layer0_Dx784_Do30", BATCH, MNIST_D, 30, True),
                      ("hidden_Dx30_Do30", BATCH, 30, 30, True),
                      ("last_Dx30_Do10", BATCH, 30, MNIST_K, True),
                      ("serving_Dx784_Do30", S * BATCH, MNIST_D, 30, False)]
# rbf_gram at layer 0: Kuu (100 x 784, square) and Kuf off the fused route
# (1000 x 784 against 100 x 784)
MNIST_GRAM_CASES = [("Kuu_M100_D784", None), ("Kuf_B1000_M100_D784", BATCH)]


def mnist_data(seed):
    """MNIST-shaped data from ``seed``: a 20-dimensional latent h, pixels
    clip(0.5 + h A + noise, 0, 1) (std 0.15 of signal, 0.05 of noise a
    pixel) and labels argmax(h W), so that the labels are learnable
    through the 784 -> 30 PCA; written to an npz and read back with
    load_mnist_npz, the classification loader."""
    rng = np.random.RandomState(seed + 11)
    n = MNIST_N + MNIST_NS
    h = rng.randn(n, MNIST_LATENT)
    A = rng.randn(MNIST_LATENT, MNIST_D) * (0.15 / np.sqrt(MNIST_LATENT))
    X = np.clip(0.5 + h @ A + 0.05 * rng.randn(n, MNIST_D), 0.0, 1.0)
    y = np.argmax(h @ rng.randn(MNIST_LATENT, MNIST_K), 1)[:, None]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mnist.npz")
        np.savez(path, X=X[:MNIST_N].astype(np.float32), Y=y[:MNIST_N],
                 Xs=X[MNIST_N:].astype(np.float32), Ys=y[MNIST_N:])
        return load_mnist_npz(path)


def mnist_model(data, hidden, seed, use_pallas=True, device="cuda",
                dtype=torch.float32):
    """DGP.build with the MNIST demo's architecture and numerics; Z a
    seeded random subset of 100 training rows (k-means on 60,000 x 784
    costs minutes on the host)."""
    rng = np.random.RandomState(seed)
    Z = data["X"][rng.choice(MNIST_N, M, replace=False)]
    kernels = [RBF(w, lengthscales=2.0, variance=2.0)
               for w in (MNIST_D,) + hidden]
    cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                 use_pallas=use_pallas)
    return DGP.build(data["X"], data["Y"], Z, kernels, MultiClass(MNIST_K),
                     num_outputs=MNIST_K, num_samples=1, config=cfg,
                     device=device)


def captured_calls(fn, owner, attr):
    """The arguments of every call of ``owner.<attr>`` while ``fn`` runs
    under torch.no_grad, tensors cloned (the launches are not counted)."""
    got = []
    inner = getattr(owner, attr)
    counts = launch_counts()

    def record(*args):
        got.append([a.detach().clone() if torch.is_tensor(a) else a
                    for a in args])
        return inner(*args)

    setattr(owner, attr, record)
    try:
        with torch.no_grad():
            fn()
    finally:
        setattr(owner, attr, inner)
        set_launch_counts(counts)
    return got


def capture_fused_operands(model, X):
    """The fused conditional's operands of every layer in a 1000-row S=1
    prediction (the launches are not counted)."""
    from doubly_stochastic_dgp_tpu_torch.models import layers
    return captured_calls(lambda: model.predict_f(X, S=1), layers,
                          "fused_conditional")


def plain_by_rows(args, rows=10000):
    """fused_conditional_plain in row chunks of ``rows`` (its (B, M, Dx)
    differences at the serving shape, 100,000 x 100 x 784, would not fit
    the card in float64); the rows are independent, so it is the same
    function."""
    B = args[0].shape[0]
    if B <= rows:
        return fused_conditional_plain(*args)
    parts = [fused_conditional_plain(args[0][i:i + rows], *args[1:])
             for i in range(0, B, rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def check_fused_mnist(case, args, backward, seed, worst, floor=False):
    """The forward (and the backward) kernel against its plain version in
    float32 and float64, repeats bit-identical (phase 1's gates; hold's
    ``floor``)."""
    B, Do = args[0].shape[0], args[3].shape[1]
    a64 = [a.double() for a in args]
    with torch.no_grad():
        fwd = lambda: fused_conditional_forward(*args)[:2]  # noqa: E731
        km, kv = fwd()
        torch.cuda.synchronize()
        plain = plain_by_rows(args)
        ref = plain_by_rows(a64)
        errs = compare((km, kv), plain, ref, joint_scale=True)
        del plain, ref
        hold("fused_conditional", case, errs, floor)
        check_repeat("fused_conditional", case, fwd, (km, kv))
        worst["fused_conditional"] = list(map(max,
                                              worst["fused_conditional"],
                                              errs))
        if not backward:
            return
        gm, gv = cotangents(B, Do, seed)
        bwd = lambda: fused_conditional_backward(  # noqa: E731
            *args, km, kv, gm, gv)
        kg = bwd()
        torch.cuda.synchronize()
        pg = fused_conditional_backward_plain(*args, km, kv, gm, gv)
        rg = fused_conditional_backward_plain(*a64, km.double(),
                                              kv.double(), gm.double(),
                                              gv.double())
        errs = compare(kg, pg, rg, joint_scale=False)
        hold("fused_conditional_backward", case, errs, floor)
        check_repeat("fused_conditional_backward", case, bwd, kg)
        worst["fused_conditional_backward"] = list(map(
            max, worst["fused_conditional_backward"], errs))


def mnist_gram_operands(case, N, seed, captured=None):
    """(X, Z, lengthscales, variance) float32 on the card: random rows with
    std 1/sqrt(784) and ARD lengthscales in [0.8, 2] (scaled distances
    O(1)), or layer 0's rows, Z and kernel (``captured``: the model and a
    batch); Z is X for the square gram (N None)."""
    if captured is not None:
        model, Xb = captured
        kern = model.layers[0].kern
        Z = model.layers[0].Z.value.detach().contiguous()
        X = Z if N is None else Xb[:N].contiguous()
        return [X, Z, kern.lengthscales.value.detach().clone(),
                kern.variance.value.detach().clone()]
    rng = np.random.RandomState(seed)
    Z = rng.randn(M, MNIST_D) / np.sqrt(MNIST_D)
    X = Z if N is None else rng.randn(N, MNIST_D) / np.sqrt(MNIST_D)
    out = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in
           (X, Z, rng.uniform(0.8, 2.0, MNIST_D), np.float64(1.3))]
    if N is None:
        out[0] = out[1]
    return out


def check_gram_mnist(tag, ops, square, seed, worst):
    """rbf_gram against its plain version in float32 and float64, repeats
    bit-identical, K(Z, Z) bitwise symmetric with its diagonal exactly
    var; the backward through the Function against plain autograd."""
    X, Z, ls, v = ops
    a64 = [t.double() for t in ops]
    if square:
        a64[1] = a64[0]
    with torch.no_grad():
        fwd = lambda: (gram.rbf_gram(X, Z, ls, v),)  # noqa: E731
        got = fwd()
        torch.cuda.synchronize()
        errs = compare(got, (gram.rbf_gram_plain(X, Z, ls, v),),
                       (gram.rbf_gram_plain(*a64),), joint_scale=True)
        hold("rbf_gram", tag, errs)
        check_repeat("rbf_gram", tag, fwd, got)
    if square:
        check(torch.equal(got[0], got[0].T),
              f"rbf_gram {tag}: K(Z, Z) is not bitwise symmetric")
        check(bool((torch.diagonal(got[0]) == v).all()),
              f"rbf_gram {tag}: the diagonal is not exactly var")
    g64 = torch.tensor(np.random.RandomState(seed + 5).randn(
        *got[0].shape), dtype=torch.float64, device="cuda")
    g = g64.float()
    b_errs = compare(gram_grads(gram.rbf_gram, X, Z, ls, v, g, square),
                     gram_grads(gram.rbf_gram_plain, X, Z, ls, v, g, square),
                     gram_grads(gram.rbf_gram_plain, *a64, g64, square),
                     joint_scale=False)
    print(f"kernel rbf_gram backward {tag}: |Function-plain| "
          f"{b_errs[1]:.3e} of scale", flush=True)
    check(b_errs[1] <= KERNEL_VS_PLAIN_RTOL,
          f"rbf_gram backward {tag}: Function vs plain autograd "
          f"{b_errs[1]} > {KERNEL_VS_PLAIN_RTOL} of scale")
    worst["rbf_gram"] = list(map(max, worst["rbf_gram"], errs))


def mnist_graph_ms(fn, event_ms_):
    """Device ms of one call by CUDA-graph replays (graph_calls_ms), with
    fewer calls for a call of tens of ms: the profiler's records of these
    kernels can go missing in a long run (then "not measured")."""
    if event_ms_ > 10.0:
        return graph_calls_ms(fn, calls=2, reps=2, rounds=3)
    return graph_calls_ms(fn)


def mnist_call_ms(fn):
    """utils.timing.timed_per_call_stats of ``fn``: (median, spread %) of
    three blocks of 10 calls, each block timed with CUDA events."""
    st = timed_per_call_stats(lambda i: fn(), n=10, repeats=3)
    return 1e3 * st["median"], st["spread_pct"]


def phase_mnist_kernels(seed, trained, card):
    """The fused pair and rbf_gram at the MNIST shapes against their
    plain versions, on random operands with O(1) scaled distances and on
    the operands of the trained DGP3's layers (the pixels' own distances
    at lengthscale ~2 make Kuf ~ e^-10, where a relative gate sees
    little); then each timed: CUDA events, device time by the kernel's
    own records, the plain version, the bound, and GEMM yardsticks of the
    gram ((B x Dx) by (Dx x M)) and of the staging ((B x M) by (M x Do
    M))."""
    counts = launch_counts()
    worst = {n: [0.0] * 4 for n in ("fused_conditional",
                                     "fused_conditional_backward",
                                     "rbf_gram")}
    model, Xb = trained
    operands = capture_fused_operands(model, Xb)
    check(len(operands) == len(model.layers),
          f"captured {len(operands)} fused calls for "
          f"{len(model.layers)} layers")
    shapes = {n: [] for n in worst}
    for case, B, Dx, Do, backward in MNIST_KERNEL_CASES:
        args = conditional_inputs(B, M, Dx, Do, seed, spread=Dx ** -0.5)
        check_fused_mnist(f"mnist {case} random", args, backward, seed,
                          worst)
        with torch.no_grad():
            km, kv = fused_conditional_forward(*args)[:2]
            gm, gv = cotangents(B, Do, seed)
            calls = [("fused_conditional",
                      lambda: fused_conditional_forward(*args),
                      lambda: plain_by_rows(args), False)]
            if backward:
                calls.append((
                    "fused_conditional_backward",
                    lambda: fused_conditional_backward(*args, km, kv, gm,
                                                       gv),
                    lambda: fused_conditional_backward_plain(
                        *args, km, kv, gm, gv), True))
            for name, kern, plain, bwd in calls:
                row = fused_row_timing(name, kern, plain, B, M, Dx, Do, bwd,
                                       False, card, what="timing mnist")
                row["case"] = case
                row["gram_yardstick_ms"] = gemm_yardstick_ms(B, Dx, M)
                row["graph_ms"] = mnist_graph_ms(kern, row["ms"])
                row["timed_per_call_ms"], spread = mnist_call_ms(kern)
                before = EARLIER_DEVICE_MS.get((name, f"mnist {case}"))
                print(f"timing mnist {name} {case}: device ms a call by "
                      f"CUDA-graph replays {row['graph_ms']:.4f} (the "
                      f"earlier design's {before}); "
                      f"timed_per_call_stats median {row['timed_per_call_ms']:.4f}"
                      f" (spread {spread:.1f}%); GEMM "
                      f"yardstick of the gram (torch.matmul ({B} x {Dx}) by "
                      f"({Dx} x {M})) {row['gram_yardstick_ms']:.4f} ms "
                      f"[{card}]", flush=True)
                shapes[name].append(row)
        del args
    for layer, args in enumerate(operands):
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        check_fused_mnist(f"mnist DGP3 layer {layer} operands (B="
                          f"{args[0].shape[0]}, Dx={args[0].shape[1]}, Do="
                          f"{args[3].shape[1]})", args, True, seed, worst)
    for i, (case, N) in enumerate(MNIST_GRAM_CASES):
        square = N is None
        for source, cap in (("random", None), ("DGP3 layer 0", trained)):
            ops = mnist_gram_operands(case, N, seed + i, cap)
            check_gram_mnist(f"mnist {case} {source}", ops, square, seed,
                             worst)
        X, Z, ls, v = mnist_gram_operands(case, N, seed + i)
        Nr = M if square else N
        with torch.no_grad():
            k_ms = event_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v))
            p_ms = event_ms(lambda: gram.rbf_gram_plain(X, Z, ls, v))
            d_ms = device_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v),
                             DEVICE_KERNELS["rbf_gram"])
            g_ms = mnist_graph_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v),
                                  k_ms)
            t_ms, _ = mnist_call_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, v))
        y_ms = gemm_yardstick_ms(Nr, MNIST_D, M)
        b_ms, b_by = gram_bound_ms(Nr, M, MNIST_D, torch.float32)
        shapes["rbf_gram"].append({
            "case": case, "N": Nr, "M": M, "D": MNIST_D, "ms": k_ms,
            "device_ms": d_ms, "graph_ms": g_ms, "timed_per_call_ms": t_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "gemm_yardstick_ms": y_ms})
        d_txt = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        before = EARLIER_DEVICE_MS.get(("rbf_gram", f"mnist {case}"))
        print(f"timing mnist rbf_gram {case}: kernel {k_ms:.4f} ms (device "
              f"time {d_txt}; by CUDA-graph replays {g_ms:.4f} ms, the "
              f"earlier design's {before} ms; "
              f"timed_per_call_stats median {t_ms:.4f} ms), plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), GEMM yardstick (torch.matmul ({Nr} x {MNIST_D}) "
              f"by ({MNIST_D} x {M})) {y_ms:.4f} ms, library call: none "
              f"[{card}]", flush=True)
    set_launch_counts(counts)
    return worst, shapes


def chunk_rates(models, seed, card, label, batch_size=BATCH,
                reject_nonfinite=False, profile=False):
    """Graphed training steps/s of each {route: model}: a captured chunk
    of FIT_CHUNK steps (minibatch ``batch_size``; the guard with
    ``reject_nonfinite``), replayed in turns (GRAPH_ROUNDS a route), every
    replay under sync debug 'error'; a replay ticks no launch counter.
    With ``profile``, one more replay of each under torch.profiler: its
    device busy a step and idle share (third value, {route: (busy ms,
    idle share)}; else None)."""
    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    chunks = {r: make_scan_train_step(masked_optimizer(m, 0.01), batch_size,
                                      FIT_CHUNK,
                                      reject_nonfinite=reject_nonfinite)
              for r, m in models.items()}
    gens = {r: torch.Generator(device="cuda").manual_seed(seed + 1)
            for r in models}
    for r, m in models.items():
        chunks[r](m, gens[r])                      # capture
    torch.cuda.synchronize()
    rates = {r: [] for r in models}
    before = launch_counts()
    for _ in range(GRAPH_ROUNDS):
        for r, m in models.items():
            t0 = time.perf_counter()
            with no_sync():
                chunks[r](m, gens[r])
            torch.cuda.synchronize()
            rates[r].append(FIT_CHUNK / (time.perf_counter() - t0))
    check(launch_counts() == before, f"{label}: a replay ticked the launch "
                                     f"counters")
    med = {r: statistics.median(v) for r, v in rates.items()}
    busy = None
    if profile:
        busy = {}
        for r, m in models.items():
            (ms, _, _), _ = profile_chunk(lambda: chunks[r](m, gens[r]),
                                          FIT_CHUNK, f"{label} {r}")
            busy[r] = (ms, 1.0 - ms * med[r] / 1e3)
    print(f"{label} graphed steps/s (chunks of {FIT_CHUNK}, median of "
          f"{GRAPH_ROUNDS} in turns, replays under sync debug 'error'): "
          + ", ".join(f"{r} {med[r]:.2f} (all "
                      f"{', '.join(f'{x:.2f}' for x in rates[r])})"
                      for r in rates)
          + ("" if busy is None else "; device busy a step (torch.profiler, "
             "a replayed chunk): " + ", ".join(
                 f"{r} {b:.3f} ms (idle share {i:.2f})"
                 for r, (b, i) in busy.items()))
          + f" [{card}]", flush=True)
    return med, rates, busy


def phase_mnist(seed, card):
    """Classification: the MNIST DGP2 and DGP3 trained, evaluated and
    served on the card through the package's entry points (the main path
    of this phase, the launch counts at 0 before each model's fit and
    read after its requests), and held against the float64 CPU path; then
    the kernels at these shapes."""
    t0 = time.perf_counter()
    data = mnist_data(seed)
    print(f"mnist data: X {data['X'].shape}, Xs {data['Xs'].shape}, "
          f"{MNIST_K} classes, class shares "
          f"{np.bincount(data['Y'][:, 0].astype(int), minlength=MNIST_K)}"
          f" / {MNIST_N}; {time.perf_counter() - t0:.1f} s", flush=True)
    out, trained = {}, None
    for label, hidden in MNIST_MODELS.items():
        L = len(hidden) + 1
        t_model = time.perf_counter()
        model = mnist_model(data, hidden, seed)
        check(isinstance(model.layers[0].mean_function, Linear),
              f"{label}: layer 0 has no PCA Linear mean function")
        untrained_model = copy.deepcopy(model)
        t_fit = time.perf_counter()
        hist, counts, replay = run_fit(model, MNIST_STEPS, seed)
        fit_s = time.perf_counter() - t_fit
        losses = [h["loss"] for h in hist]
        print(f"mnist training {label}: {MNIST_STEPS} Adam steps "
              f"(graphed, lr 0.01, minibatch {BATCH}, S=1) in {fit_s:.1f} "
              f"s: loss {losses[0]:.3f} (steps 1-10) -> {losses[-1]:.3f} "
              f"(last 10); launches (counters: the warm-up and capture "
              f"chunks) " + ", ".join(f"{n} {c}" for n, c in counts.items()
                                       if c)
              + "; a replayed chunk (profiler) "
              + ", ".join(f"{n} {c}" for n, c in replay.items() if c),
              flush=True)
        check_fit_launches(f"mnist {label}", counts, replay,
                           {"fused_conditional": L,
                            "fused_conditional_backward": L,
                            "rbf_gram": 2 * L})
        check(all(np.isfinite(losses)), f"{label}: loss not finite")
        check(losses[-1] < losses[0], f"{label}: loss did not fall: "
                                      f"{losses}")
        t_eval = time.perf_counter()
        metrics = evaluate_classification(model, data["Xs"], data["Ys"],
                                          S=S, seed=seed)
        eval_s = time.perf_counter() - t_eval
        serving = serving_graphed_vs_eager(
            model, data["Xs"], None, f"mnist {label}", card,
            shape=(S, BATCH, MNIST_K),
            values_ok=lambda p: bool(((p > 0) & (p < 1)).all()))
        main = launch_counts()
        for name in ("fused_conditional", "fused_conditional_backward",
                     "rbf_gram"):
            check(main[name] > 0, f"mnist {label}: {name} was not launched "
                                  f"on the main path")
        untrained = evaluate_classification(
            untrained_model, data["Xs"], data["Ys"], S=S, seed=seed)
        del untrained_model
        print(f"mnist evaluate_classification {label} on the "
              f"{MNIST_NS} test rows, S={S}: accuracy "
              f"{metrics['accuracy']:.4f}, loglik {metrics['loglik']:.4f} "
              f"in {eval_s:.2f} s; untrained {untrained['accuracy']:.4f}, "
              f"{untrained['loglik']:.4f}; main path launches "
              + ", ".join(f"{n} {c}" for n, c in main.items() if c)
              + f" [{card}]", flush=True)
        check(np.isfinite(metrics["accuracy"])
              and np.isfinite(metrics["loglik"]),
              f"{label}: test metrics not finite")
        check(metrics["accuracy"] > untrained["accuracy"],
              f"{label}: accuracy {metrics['accuracy']} not above the "
              f"untrained model's {untrained['accuracy']}")

        # the card's float32 against the port's float64 CPU path, on the
        # trained parameters: the ELBO gradient, and the class
        # probabilities at fixed draws
        state = model.state_dict()
        plain = mnist_model(data, hidden, seed, use_pallas=False)
        plain.load_state_dict(state)
        ref = mnist_model(data, hidden, seed, device="cpu",
                          dtype=torch.float64)
        ref.load_state_dict(state)
        grad = gradient_errors(
            f"mnist {label}", {"kernel f32": (model,
                                              contextlib.nullcontext()),
                               "plain f32": (plain,
                                             contextlib.nullcontext())},
            ref, seed, widths=hidden + (MNIST_K,), samples=1)
        check(grad["kernel f32"] <= 2.0 * grad["plain f32"],
              f"{label}: ELBO gradient through the kernels "
              f"{grad['kernel f32']} > 2x the plain float32 path's "
              f"{grad['plain f32']}")
        rng = np.random.RandomState(seed + 4)
        xs = data["Xs"][:200]
        zs = [rng.randn(10, len(xs), w) for w in hidden + (MNIST_K,)]
        p32 = model.predict_y(xs, S=10, zs=zs)[0].cpu().double()
        p64 = ref.predict_y(xs, S=10, zs=zs)[0]
        dp = (p32 - p64).abs().max().item()
        print(f"mnist {label} class probabilities f32 on the card vs the "
              f"f64 CPU path (200 test rows, S=10, fixed draws): max "
              f"|dp| {dp:.3e}", flush=True)
        check(dp <= MNIST_PROBS_ATOL, f"{label}: probabilities {dp} > "
                                      f"{MNIST_PROBS_ATOL} from float64")
        rates, all_rates, _ = chunk_rates(
            {"use_pallas=True": model, "use_pallas=False": plain}, seed,
            card, f"mnist {label}")
        out[label] = {
            "losses": losses, "fit_s": fit_s, "launches_fit": counts,
            "launches_replay": replay, "launches_main_path": main,
            "metrics": metrics, "untrained": untrained, "eval_s": eval_s,
            "serving": serving, "grad_rel_err": grad,
            "probs_max_abs_err": dp, "steps_per_s": rates,
            "steps_per_s_all": all_rates,
            "phase_s": time.perf_counter() - t_model}
        if label == "DGP3":
            rng = np.random.RandomState(seed + 6)
            Xb = torch.as_tensor(data["X"][rng.randint(0, MNIST_N, BATCH)],
                                 device="cuda")
            trained = (model, Xb)
        del plain, ref
    worst, shapes = phase_mnist_kernels(seed, trained, card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"mnist phase wall time {out['wall_s']:.1f} s [{card}]",
          flush=True)
    return out, worst, shapes

# ---------------------------------------------------------------------------
# phase 26: the rest of the model surface at the headline width
# ---------------------------------------------------------------------------

EXTRA_STEPS = 300           # fit steps of each Monte-Carlo model
QUAD_H = 100                # Gauss-Hermite points: S = H^1 = 100 a row
QUAD_STEPS = 100
SUM_STEPS = 60              # collapsed_L2 with the Sum kernel
# each Monte-Carlo model of the phase: its output widths a layer (the
# fixed draws of the gradient check) and its kernels' launches a training
# step, counted as phase 6 counts them (the fused pair once a layer, and
# rbf_gram for Kuu and the KL's Kuu; Matern52 takes none of them)
FUSED_STEP = {"fused_conditional": LAYERS,
              "fused_conditional_backward": LAYERS,
              "rbf_gram": 2 * LAYERS}
EXTRA_MODELS = {"heteroscedastic": ((8,) * (LAYERS - 1) + (2,), FUSED_STEP),
                "input_prop": ((8,) * (LAYERS - 1) + (1,), FUSED_STEP),
                "matern52": ((8,) * (LAYERS - 1) + (1,), {})}


def extra_model(name, seed, use_pallas=True, device="cuda",
                dtype=torch.float32):
    """A phase-26 model on build_model's data, Z (M=100) and numerics
    (jitter 1e-5, solve_mode='inverse'): 'heteroscedastic' (5 layers, RBF
    + White inner, RBF last with the mean and log-noise heads),
    'input_prop' (RBF(8), then RBF(16) x 4: the 8 data columns beside a
    hidden width of 8), 'matern52' (Matern52(8) + White inner, Matern52
    last), all at S=10, and 'quad' (DGPQuad: RBF(8) + White to width 1 by
    the PCA mean, then RBF(1); H=100).  The inner layers are
    near-deterministic as in build_model, except in 'quad', whose grid
    integrates layer 0's spread."""
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    rng = np.random.RandomState(seed)
    Z = X[rng.choice(X.shape[0], M, replace=False)]
    cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                 use_pallas=use_pallas)

    def inner(kern):
        return kern + White(8, variance=2e-6, trainable=False)

    kw = dict(config=cfg, device=device)
    if name == "heteroscedastic":
        model = DGPHeteroscedastic.build(
            X, Y, Z, [inner(RBF(8)) for _ in range(LAYERS - 1)] + [RBF(8)],
            Gaussian(0.05), num_samples=TRAIN_S, **kw)
    elif name == "input_prop":
        layers = init_layers_input_prop(
            X, Y, Z, [RBF(8)] + [RBF(16) for _ in range(LAYERS - 1)],
            config=cfg)
        model = DGPBase.make(X, Y, Gaussian(0.05), layers,
                             num_samples=TRAIN_S, **kw)
    elif name == "matern52":
        model = DGP.build(
            X, Y, Z, [inner(Matern52(8)) for _ in range(LAYERS - 1)]
            + [Matern52(8)], Gaussian(0.05), num_samples=TRAIN_S, **kw)
    else:
        layers = init_layers_linear(X, Y, Z, [inner(RBF(8)), RBF(1)],
                                    config=cfg)
        return DGPQuad.build(X, Y, Gaussian(0.05), layers, H=QUAD_H,
                             **kw), data
    for layer in model.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    return model, data


def extra_twins(name, model, seed):
    """The plain route (use_pallas=False) on the card and the float64 CPU
    path, both with ``model``'s parameters."""
    state = model.state_dict()
    plain = extra_model(name, seed, use_pallas=False)[0]
    ref = extra_model(name, seed, use_pallas=False, device="cpu",
                      dtype=torch.float64)[0]
    plain.load_state_dict(state)
    ref.load_state_dict(state)
    return plain, ref


def extra_fit(name, model, steps, per_step, seed, card):
    """fit from the build state (run_fit: the counts at 0 just before),
    graphed; raises unless the launches a step are ``per_step`` (phase 6's
    count) and the loss is finite and falls."""
    t0 = time.perf_counter()
    hist, counts, replay = run_fit(model, steps, seed)
    fit_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    print(f"extra {name} training: fit {steps} Adam steps (graphed, lr "
          f"0.01, minibatch {BATCH}) in {fit_s:.1f} s: loss {losses[0]:.3f}"
          f" (steps 1-{FIT_CHUNK}) -> {losses[-1]:.3f} (last {FIT_CHUNK});"
          f" launches (counters: the warm-up and capture chunks) "
          + (", ".join(f"{n} {c}" for n, c in counts.items() if c) or "none")
          + "; a replayed chunk (profiler) "
          + (", ".join(f"{n} {c}" for n, c in replay.items() if c) or "none")
          + f" [{card}]", flush=True)
    check_fit_launches(f"extra {name}", counts, replay, per_step)
    check(all(np.isfinite(losses)), f"extra {name}: loss not finite")
    check(losses[-1] < losses[0], f"extra {name}: loss did not fall: "
                                  f"{losses}")
    return {"steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
            "fit_s": fit_s, "launches_fit": counts, "launches_replay": replay}


def serving_graphed_vs_eager(model, Xs, Ys, label, card, shape=None,
                             values_ok=None):
    """1000-row S=100 requests (the first 1000 rows of ``Xs``) to
    make_server live and cached, ``predict_y`` and, with ``Ys``,
    ``predict_density``: graphed against eager bit for bit at a pinned
    seed (raises otherwise), the outputs finite (and ``values_ok`` of the
    first) and of y-space shapes (``shape`` for the moments, else (S,
    1000, 1); (1000, 1) densities), replays under sync debug 'error',
    latency (host clock, median of LATENCY_REPS, in turns) and a graphed
    request's device busy (torch.profiler)."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    X = torch.as_tensor(Xs[:BATCH], dtype=torch.float32, device="cuda")
    requests = {"predict_y": ((X,), shape or (S, BATCH, 1))}
    if Ys is not None:
        Y = torch.as_tensor(Ys[:BATCH], dtype=torch.float32, device="cuda")
        requests["predict_density"] = ((X, Y), (BATCH, 1))
    out = {}
    for method, (args, want) in requests.items():
        for name, pre in (("live", False), ("cached", True)):
            serve = make_server(model, S=S, precompute=pre, method=method)
            a = serve(*args, seed=5)
            with eager_on_card():
                b = serve(*args, seed=5)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            check(same, f"{label} {method} {name}: graphed and eager "
                        f"answers differ at a pinned seed")
            check(all(tuple(t.shape) == want and bool(torch.isfinite(t).all())
                      for t in a)
                  and (values_ok is None or values_ok(a[0])),
                  f"{label} {method} {name}: outputs of shapes "
                  f"{[tuple(t.shape) for t in a]}, not all {want}, finite "
                  f"and in range")
            times = {"graphed": [], "eager": []}
            for i in range(LATENCY_REPS):
                for mode in times:
                    t0 = time.perf_counter()
                    if mode == "graphed":
                        with no_sync():
                            serve(*args, seed=3000 + i)
                    else:
                        with eager_on_card():
                            serve(*args, seed=3000 + i)
                    torch.cuda.synchronize()
                    times[mode].append(1e3 * (time.perf_counter() - t0))
            lat = {m: statistics.median(t) for m, t in times.items()}
            busy = total_device_ms(lambda: serve(*args, seed=7), n=5)
            busy_ms = None if busy is None else busy[0]
            out[f"{method} {name}"] = {"bit_for_bit": same,
                                       "latency_ms": lat,
                                       "latency_all_ms": times,
                                       "device_busy_ms": busy_ms}
            print(f"{label} serving {name} {method}, {BATCH}-row request, "
                  f"S={S}: graphed {lat['graphed']:.3f} ms, eager "
                  f"{lat['eager']:.3f} ms (host clock, median of "
                  f"{LATENCY_REPS}, in turns); device busy "
                  + ("not measured" if busy_ms is None
                     else f"{busy_ms:.3f} ms")
                  + f"; output shapes {[tuple(t.shape) for t in a]}; pinned "
                    f"seed bit for bit {same}; replays with no host sync "
                    f"[{card}]", flush=True)
    return out


def hold_captured_kernels(label, run, seed, worst, backward=True,
                          n_fused=None):
    """Phase 1's gates (check_fused_mnist, check_gram_mnist: within 1e-4
    of scale of the plain version, within 2x the plain float32 error
    against float64, repeats bit-identical) on the operands that ``run``,
    a call at a main path's shapes, hands the fused pair (every call; the
    backward too when ``backward``; the first gate relaxed to the plain
    float32 error against float64 where that is larger: hold's ``floor``)
    and rbf_gram (each distinct call); and on random operands at each
    fused shape that phase 1 does not hold, under its gates as they are.
    ``n_fused``: the number of fused calls ``run`` must make.  The worst
    errors go into ``worst``; returns the fused calls' (B, Dx, Do) and
    the grams' (N, M, D)."""
    from doubly_stochastic_dgp_tpu_torch.models import layers
    from doubly_stochastic_dgp_tpu_torch.ops import kernels
    fused = captured_calls(run, layers, "fused_conditional")
    check(n_fused is None or len(fused) == n_fused,
          f"{label}: captured {len(fused)} fused calls, expected {n_fused}")
    return hold_operands(label, fused, captured_calls(run, kernels,
                                                      "rbf_gram"),
                         seed, worst, backward)


def hold_operands(label, fused, gram_calls, seed, worst, backward=True):
    """hold_captured_kernels' gates on captured operands: ``fused``, the
    fused conditional's calls, and ``gram_calls``, rbf_gram's (each
    distinct call held once).  Returns the fused calls' (B, Dx, Do) and
    the grams' (N, M, D)."""
    shapes, held = [], {case[1:5] for case in KERNEL_CASES}
    for layer, args in enumerate(fused):
        args = [a.contiguous() if torch.is_tensor(a) else a for a in args]
        B, Dx, Do = args[0].shape[0], args[0].shape[1], args[3].shape[1]
        M_ = args[1].shape[0]
        shapes.append((B, Dx, Do))
        if (B, M_, Dx, Do) not in held:
            # a shape phase 1 does not hold: its random operands, too
            held.add((B, M_, Dx, Do))
            check_fused_mnist(
                f"{label} random (B, M, Dx, Do) = {(B, M_, Dx, Do)}",
                conditional_inputs(B, M_, Dx, Do, seed + layer,
                                   spread=Dx ** -0.5), backward, seed, worst)
        check_fused_mnist(f"{label} layer {layer} operands (B, Dx, Do) "
                          f"= {shapes[-1]}", args, backward, seed, worst,
                          floor=True)
    grams = []
    for ops in gram_calls:
        if not any(all(a.shape == b.shape and torch.equal(a, b)
                       for a, b in zip(ops, seen)) for seen in grams):
            grams.append(ops)
    gram_shapes = []
    for i, ops in enumerate(grams):
        ops = [t.contiguous() for t in ops]
        X, Z = ops[0], ops[1]
        # K(Z) is rbf_gram(Z, Z): one tensor in both places, as there
        square = X.shape == Z.shape and torch.equal(X, Z)
        if square:
            ops[1] = X
        gram_shapes.append((X.shape[0], Z.shape[0], X.shape[1]))
        check_gram_mnist(f"{label} call {i} "
                         f"{'K(Z, Z)' if square else 'K(X, Z)'} (N, M, D) = "
                         f"{gram_shapes[-1]}", ops, square, seed, worst)
    return shapes, gram_shapes


def kernel_worst():
    """Worst errors per kernel, as hold_captured_kernels keeps them."""
    return {n: [0.0] * 4 for n in ("fused_conditional",
                                    "fused_conditional_backward",
                                    "rbf_gram")}


def check_extra_kernels(name, model, run, seed):
    """hold_captured_kernels on a trained ``model``'s call ``run`` at its
    training shapes (one fused call a layer).  Returns the worst errors
    per kernel and the fused calls' (B, Dx, Do)."""
    worst = kernel_worst()
    shapes, _ = hold_captured_kernels(f"extra {name}", run, seed, worst,
                                      n_fused=len(model.layers))
    return worst, shapes


def check_input_prop_outputs(model, data, dx):
    """The input-propagation stack's fused calls (their Dx ``dx``) see
    Dx = 8, then 16, and the inner layers' samples and means are (S, N,
    16) whose first 8 columns are the input, bit for bit."""
    X = torch.as_tensor(data["Xs"][:200], dtype=torch.float32, device="cuda")
    check(dx == [8] + [16] * (LAYERS - 1),
          f"input_prop: the fused calls' Dx {dx}")
    Fs, Fmeans, _ = model.predict_all_layers(X, S=TRAIN_S)
    for l in range(LAYERS - 1):
        for what, F in (("samples", Fs[l]), ("means", Fmeans[l])):
            check(tuple(F.shape) == (TRAIN_S, 200, 16)
                  and torch.equal(F[..., :8], X.expand(TRAIN_S, 200, 8)),
                  f"input_prop layer {l} {what}: shape {tuple(F.shape)} or "
                  f"its first 8 columns are not the input")
    print(f"extra input_prop: fused calls at Dx {dx}; inner layers' samples "
          f"and means (S, N, 16), first 8 columns the input bit for bit",
          flush=True)


def phase_extra_mc(seed, card):
    """The three Monte-Carlo models: each one's main path (fit, then
    evaluate_regression and its requests) with the launch counts at 0
    just before and read just after; then the ELBO gradient (the 2x rule
    against the plain route) or the predictions against float64, and
    graphed steps/s with device busy a step."""
    out = {}
    for name, (widths, per_step) in EXTRA_MODELS.items():
        t0 = time.perf_counter()
        model, data = extra_model(name, seed)
        rec = {"fit": extra_fit(name, model, EXTRA_STEPS, per_step, seed,
                                card)}
        metrics = evaluate_regression(model, data["Xs"], data["Ys"],
                                      data["Y_std"], S=100, seed=seed)
        print(f"extra {name} evaluate_regression on the "
              f"{len(data['Xs'])}-row test split, S=100: rmse "
              f"{metrics['rmse']:.6f}, loglik {metrics['loglik']:.6f}",
              flush=True)
        check(np.isfinite(metrics["rmse"]) and np.isfinite(metrics["loglik"]),
              f"extra {name}: test metrics not finite")
        rec["serving"] = serving_graphed_vs_eager(
            model, data["X"], data["Y"] if name == "heteroscedastic" else None,
            f"extra {name}", card)
        main = launch_counts()
        for kernel in per_step:
            check(main[kernel] > 0, f"extra {name}: {kernel} was not "
                                    f"launched on the main path")
        check(name != "matern52" or not any(main.values()),
              f"extra matern52: a kernel launched on its path {main}")
        rec["launches_main_path"] = main
        rec["metrics"] = metrics
        if per_step:
            Xb = torch.as_tensor(data["X"][:BATCH], dtype=torch.float32,
                                 device="cuda")
            rec["kernel_errs"], rec["kernel_shapes"] = check_extra_kernels(
                name, model, lambda: model.predict_f(Xb, S=TRAIN_S), seed)
        if name == "input_prop":
            check_input_prop_outputs(
                model, data, [dx for _, dx, _ in rec["kernel_shapes"]])
        if name == "matern52":
            ref = extra_model(name, seed, device="cpu",
                              dtype=torch.float64)[0]
            ref.load_state_dict(model.state_dict())
            rec["f32_vs_f64"] = predictions_vs_f64(
                "extra matern52 predict_y", {"live": model}, ref, data,
                seed)["live"]
            routes = {"matern52": model}
        else:
            plain, ref = extra_twins(name, model, seed)
            worst = gradient_errors(
                f"extra {name}",
                {"kernel f32": (model, contextlib.nullcontext()),
                 "plain f32": (plain, contextlib.nullcontext())},
                ref, seed, widths=widths)
            check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
                  f"extra {name}: ELBO gradient through the kernels "
                  f"{worst['kernel f32']} > 2x the plain float32 path's "
                  f"{worst['plain f32']}")
            rec["grad_rel_err"] = worst
            routes = {"use_pallas=True": model, "use_pallas=False": plain}
            del ref
        rates, _, busy = chunk_rates(routes, seed, card, f"extra {name}",
                                     profile=True)
        rec["steps_per_s"], rec["busy_ms_step"] = rates, busy
        rec["phase_s"] = time.perf_counter() - t0
        out[name] = rec
        del model
    return out


def phase_extra_quad(seed, card):
    """DGPQuad: its main path (fit 100 graphed steps from the build state,
    the counts at 0 just before: the fused pair twice a step, at B = 100 x
    1000 rows a layer); then, on the trained parameters (at the build
    state the last layer is its prior and layer 0's gradient is 0 up to
    rounding), the bound the same bits twice, and the float32 bound and
    gradient at a fixed minibatch within 2x of the plain route's error
    against the float64 CPU path."""
    t0 = time.perf_counter()
    model, data = extra_model("quad", seed)
    rec = {"fit": extra_fit("quad", model, QUAD_STEPS,
                            {"fused_conditional": 2,
                             "fused_conditional_backward": 2,
                             "rbf_gram": 4}, seed, card)}
    rec["launches_main_path"] = launch_counts()
    # the kernels on the trained operands of a minibatch's bound (layer 1
    # at B = H x 1000, Dx = Do = 1); the bound and gradient gates below
    # hold the model, whose float32 gradient is O(1) off float64 on both
    # routes, and are no check on the kernels
    Xb, Yb = model.X_data[:BATCH], model.Y_data[:BATCH]
    rec["kernel_errs"], rec["kernel_shapes"] = check_extra_kernels(
        "quad", model, lambda: model.elbo(Xb, Yb), seed)
    plain, ref = extra_twins("quad", model, seed)
    rng = np.random.RandomState(seed + 23)
    idx = rng.randint(0, data["X"].shape[0], BATCH)
    bounds = {}
    with torch.no_grad():
        for route, m in (("kernel f32", model), ("plain f32", plain),
                         ("f64 cpu", ref)):
            i = torch.as_tensor(idx, device=m.X_data.device)
            bounds[route] = m.elbo(m.X_data[i], m.Y_data[i])
        i = torch.as_tensor(idx, device="cuda")
        again = model.elbo(model.X_data[i], model.Y_data[i])
    torch.cuda.synchronize()
    same = torch.equal(again, bounds["kernel f32"])
    check(same, "quad: two bound evaluations differ in their bits")
    b64 = bounds["f64 cpu"].item()
    berr = {r: abs(bounds[r].item() - b64) / abs(b64)
            for r in ("kernel f32", "plain f32")}
    print(f"extra quad bound (DGPQuad, H={QUAD_H}, minibatch {BATCH}: "
          f"{QUAD_H * BATCH} rows a layer), trained: kernel f32 "
          f"{bounds['kernel f32'].item():.6f}, plain f32 "
          f"{bounds['plain f32'].item():.6f}, f64 CPU {b64:.6f}; relative "
          f"errors {berr}; the same bits twice {same}", flush=True)
    check(berr["kernel f32"] <= 2.0 * berr["plain f32"],
          f"quad: the kernel route's bound error {berr['kernel f32']} > 2x "
          f"the plain route's {berr['plain f32']}")
    # where the float32 bound's error comes from: each layer's KL term
    # (layer 1 has M=100 inducing points on one dimension) and the
    # condition number of its jittered Kuu, float64 on the CPU
    with torch.no_grad():
        kl = [(l32.KL().item(), l64.KL().item())
              for l32, l64 in zip(model.layers, ref.layers)]
        lay = ref.layers[-1]
        Kuu = lay.kern.K(lay.Z.value)
        cond = torch.linalg.cond(
            Kuu + lay.jitter * torch.eye(Kuu.shape[0],
                                         dtype=Kuu.dtype)).item()
    print(f"extra quad KL per layer, f32 on the card vs f64 on the CPU: "
          + "; ".join(f"layer {l} {a:.6f} vs {b:.6f} (rel err "
                      f"{abs(a - b) / abs(b):.3e})"
                      for l, (a, b) in enumerate(kl))
          + f"; condition number of layer {len(kl) - 1}'s Kuu + jitter I "
            f"{cond:.3e}", flush=True)
    worst = gradient_errors(
        "extra quad", {"kernel f32": (model, contextlib.nullcontext()),
                       "plain f32": (plain, contextlib.nullcontext())},
        ref, seed, widths=(1, 1), samples=1)
    check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
          f"quad: bound gradient through the kernels {worst['kernel f32']} "
          f"> 2x the plain route's {worst['plain f32']}")
    del ref
    rates, _, busy = chunk_rates(
        {"use_pallas=True": model, "use_pallas=False": plain}, seed, card,
        "extra quad", profile=True)
    rec.update({"bound_same_bits": same, "bound_rel_err": berr,
                "kl_f32_f64": kl, "last_kuu_cond": cond,
                "grad_rel_err": worst, "steps_per_s": rates,
                "busy_ms_step": busy, "phase_s": time.perf_counter() - t0})
    return rec


def phase_extra_collapsed_sum(seed, card):
    """collapsed_L2 with a Sum(RBF(8), Linear(8, ARD)) collapsed kernel:
    its main path on the kernel route (bound and requests at fixed draws,
    then 60 guarded graphed fit steps; the counts at 0 before each, psi2
    forward once a bound, psi2 backward once a gradient), the routes
    against float64 with phase 9's rules, and the bound's gradient with
    phase 13's."""
    t0 = time.perf_counter()
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    from scipy.cluster.vq import kmeans2
    X, Y = data["X"][:1500], data["Y"][:1500]
    Z = kmeans2(X, 100, minit="points", seed=0)[0]

    def build(dtype, impl, use_pallas, device="cuda"):
        cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                     use_pallas=use_pallas, psi2_impl=impl)
        return DGPCollapsed.build(
            X, Y, Z, [RBF(8), RBF(8) + LinearKernel(8, ard=True)],
            Gaussian(0.05), config=cfg, device=device)

    # one draw shared by all samples and rows, as phase 9's collapsed_L2
    rng = np.random.RandomState(seed + 25)
    zs = [rng.randn(1, 1, d) for d in (8, 1)]
    name = "collapsed_L2_sum"
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    model = build(*ROUTES["kernel"])
    counts = {}
    evaluate_route(name, "kernel", model, data, zs, counts)
    main = launch_counts()
    print(f"extra {name}: (psi2_core, fused_conditional) launches per call "
          f"{counts} [{card}]", flush=True)
    _, errs, _, gap, _ = route_errors(
        f"extra {name}", name, model, lambda route: build(*ROUTES[route]),
        data, zs, seed)
    worst = route_gradients(f"extra {name} gradient", model, build, zs,
                            (1, 1, 1, 1), card)
    check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
          f"{name}: bound gradient through the kernels "
          f"{worst['kernel f32']} > 2x the plain route's "
          f"{worst['plain f32']}")

    fresh = build(*ROUTES["kernel"])
    hist, c, r = collapsed_fit(fresh, SUM_STEPS, seed, profiled=True)
    losses = [h["loss"] for h in hist]
    print(f"extra {name} training: fit {SUM_STEPS} steps (guard on, graphed "
          f"chunks of {FIT_CHUNK}): loss {losses[0]:.3f} -> {losses[-1]:.3f};"
          f" rejected {hist[-1]['rejected']}; launches (counters) "
          + ", ".join(f"{k} {v}" for k, v in c.items() if v)
          + "; a replayed chunk (profiler) "
          + ", ".join(f"{k} {v}" for k, v in r.items() if v)
          + f" [{card}]", flush=True)
    per_chunk = {"psi2_core_forward": FIT_CHUNK + 1,
                 "psi2_core_backward": FIT_CHUNK,
                 "fused_conditional": FIT_CHUNK + 1,
                 "fused_conditional_backward": FIT_CHUNK}
    check(all(c[k] == FIT_CAPTURE_CHUNKS * v for k, v in per_chunk.items()),
          f"{name}: launch counters {c} != {FIT_CAPTURE_CHUNKS} x "
          f"{per_chunk}")
    check(all(r[k] == v for k, v in per_chunk.items()),
          f"{name}: a replayed chunk launched {r} != {per_chunk}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: training loss not finite or did not fall: {losses}")
    rates, _, busy = chunk_rates({"kernel route": fresh}, seed, card,
                                 f"extra {name}", batch_size=None,
                                 reject_nonfinite=True, profile=True)
    return {"launches_per_call": counts,
            "launches_main_path": {n: main[n] + c[n] for n in KERNEL_NAMES},
            "launches_fit": c, "launches_replay": r, "errors": errs,
            "route_gap": gap, "grad_rel_err": worst,
            "loss_first": losses[0], "loss_last": losses[-1],
            "steps_per_s": rates, "busy_ms_step": busy,
            "phase_s": time.perf_counter() - t0}


def phase_extra(seed, card):
    """Phase 26: the heteroscedastic, input-propagation and Matern52 DGPs,
    DGPQuad and the Sum-kernel collapsed_L2, each through its entry points
    on the card."""
    t0 = time.perf_counter()
    out = phase_extra_mc(seed, card)
    out["quad"] = phase_extra_quad(seed, card)
    out["collapsed_L2_sum"] = phase_extra_collapsed_sum(seed, card)
    out["wall_s"] = time.perf_counter() - t0
    print(f"extra phase wall time {out['wall_s']:.1f} s [{card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 27: natural gradients, L-BFGS, the single-layer baselines and their
# serving caches
# ---------------------------------------------------------------------------

NG_GAMMA = 0.1
# scripts/stress_sweep.py's natgrad family (1000 steps there)
NG_STEPS = 300
NG_COMPARE_STEPS = 100
# a NatGrad+Adam step, counted by the wrappers on the CPU: the natural
# step's objective (a fused forward a layer; rbf_gram for each layer's Kuu
# in its conditional and in its KL) and its gradient in the last layer's
# (q_mu, q_sqrt) alone, for which autograd runs the last layer's fused
# backward and no other; then Adam's objective and full gradient
NG_STEP = {"fused_conditional": 2 * LAYERS,
           "fused_conditional_backward": LAYERS + 1,
           "rbf_gram": 4 * LAYERS}
# the SVGP baseline (one white layer on the fused route): its conditional's
# Kuu, and no KL gram (the whitened KL has none)
SVGP_STEP = {"fused_conditional": 1, "fused_conditional_backward": 1,
             "rbf_gram": 1}
BASELINE_LBFGS_ITERS = 100      # demos/uci_benchmark.py runs 300
GPR_ROWS = 1000
# precompute's collapsed snapshot against the live collapsed model, float32
# on the card: the collapsed-prediction limit of section 2 (PERF.md)
CACHED_COLLAPSED_RTOL = ROUTE_GAP_RTOL["predictions"]


def natgrad_chunk(model, natgrad=True):
    """A training chunk of FIT_CHUNK steps at minibatch BATCH, lr 0.01:
    NatGrad(NG_GAMMA, last layer) + Adam on the rest, or Adam alone."""
    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_natgrad_adam_step, make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        freeze_q_params, masked_optimizer)
    if not natgrad:
        return make_scan_train_step(masked_optimizer(model, 0.01), BATCH,
                                    FIT_CHUNK)
    opt = masked_optimizer(model, 0.01,
                           freeze=freeze_q_params((-1,), len(model.layers)))
    return make_scan_train_step(
        opt, BATCH, FIT_CHUNK,
        step=make_natgrad_adam_step(opt, NG_GAMMA, (-1,), BATCH))


def last_layer_grads(model, seed):
    """The objective's gradient in the last layer's (q_mu, q_sqrt) at a
    fixed minibatch and fixed draws: (q_mu, q_sqrt, dq_mu, dq_sqrt)."""
    rng = np.random.RandomState(seed + 13)
    idx = torch.as_tensor(rng.randint(0, model.X_data.shape[0], BATCH),
                          device="cuda")
    zs = [rng.randn(TRAIN_S, BATCH, 8) for _ in range(LAYERS - 1)] + [
        rng.randn(TRAIN_S, BATCH, 1)]
    last = model.layers[-1]
    loss = model.loss(model.X_data[idx], model.Y_data[idx], zs=zs)
    gm, gL = torch.autograd.grad(
        loss, [last.q_mu.unconstrained, last.q_sqrt.unconstrained])
    return (last.q_mu.value.detach(), last.q_sqrt.value.detach(), gm,
            torch.tril(gL))


def natgrad_update_precision(model, seed, card):
    """natgrad_update on the trained last layer's (q_mu, q_sqrt) and its
    gradients: float32 on the card and on the CPU against float64 on the
    CPU (each output's max |error| over its scale); raises when the card's
    error is above 2x the CPU float32 error (phase 19's rule for cuSOLVER
    against LAPACK).  Then the update's device time, captured in a CUDA
    graph and by the profiler."""
    from doubly_stochastic_dgp_tpu_torch import natgrad_update
    args = last_layer_grads(model, seed)
    jitter = model.layers[-1].jitter
    a64 = [a.double().cpu() for a in args]
    ref = natgrad_update(*a64, NG_GAMMA, jitter=jitter)
    runs = {"card f32": natgrad_update(*args, NG_GAMMA, jitter=jitter),
            "cpu f32": natgrad_update(*[a.float() for a in a64], NG_GAMMA,
                                      jitter=jitter)}
    errs = {run: [(g.double().cpu() - r).abs().max().item()
                  / r.abs().max().item() for g, r in zip(out, ref)]
            for run, out in runs.items()}
    print("natgrad_update f32 vs f64 (the trained last layer, M=100, D=1, "
          "gamma 0.1), max |error| of scale (q_mu, q_sqrt): "
          + ", ".join(f"{run} {e[0]:.3e}, {e[1]:.3e}"
                      for run, e in errs.items()) + f" [{card}]", flush=True)
    for k, what in enumerate(("q_mu", "q_sqrt")):
        check(errs["card f32"][k] <= 2.0 * errs["cpu f32"][k],
              f"natgrad_update {what}: card float32 error "
              f"{errs['card f32'][k]} > 2x the CPU float32 error "
              f"{errs['cpu f32'][k]}")
    fn = lambda: natgrad_update(*args, NG_GAMMA, jitter=jitter)  # noqa
    graph_ms = graph_event_ms(fn)
    busy = total_device_ms(fn)
    print(f"natgrad_update device time (the batched (1, 100, 100) "
          f"factorizations and solves): {graph_ms:.4f} ms a call captured "
          f"and replayed (CUDA events); the profiler's sum of device ops "
          + ("not measured" if busy is None
             else f"{busy[0]:.4f} ms in {busy[1]:.0f} ops")
          + f" [{card}]", flush=True)
    return {"errors_of_scale": errs, "graph_ms": graph_ms,
            "profiler_ms": None if busy is None else busy[0],
            "device_ops": None if busy is None else busy[1]}


def natgrad_rates(seed, card):
    """Graphed against eager over 2 chunks of NatGrad+Adam from one seed,
    bit for bit; then NatGrad+Adam and Adam-only chunks replayed in turns
    (GRAPH_ROUNDS each, every replay under sync debug 'error', no replay
    ticking a counter); an eager NatGrad+Adam chunk's launches by the
    counters against a replayed one's by the profiler, which must agree;
    device busy and idle share of each."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card

    def fresh():
        return build_model(seed, num_samples=TRAIN_S,
                           random_posterior=False)[0]

    ma, mb = fresh(), fresh()
    kw = dict(learning_rate=0.01, batch_size=BATCH, seed=seed,
              log_every=FIT_CHUNK, natgrad_gamma=NG_GAMMA)
    fit(ma, 2 * FIT_CHUNK, **kw)
    with eager_on_card():
        fit(mb, 2 * FIT_CHUNK, **kw)
    torch.cuda.synchronize()
    same, worst, where = param_agreement(ma, mb)
    print(f"natgrad graphs: parameters after {2 * FIT_CHUNK} NatGrad+Adam "
          f"steps (2 chunks), graphed vs eager: bit for bit {same}; worst "
          f"{worst:.3e} of scale ({where}) [{card}]", flush=True)
    check(same, f"NatGrad+Adam: graphed and eager parameters differ by "
                f"{worst} of scale in {where}")
    models = {"natgrad+adam": ma, "adam": fresh()}
    chunks = {r: natgrad_chunk(m, natgrad=r != "adam")
              for r, m in models.items()}
    gens = {r: torch.Generator(device="cuda").manual_seed(seed + 1)
            for r in models}
    runs = {r: (lambda r=r: chunks[r](models[r], gens[r])) for r in models}
    for run in runs.values():
        run()                                       # capture
    torch.cuda.synchronize()
    before = launch_counts()
    with eager_on_card():
        runs["natgrad+adam"]()
    torch.cuda.synchronize()
    eager = {n: launch_counts()[n] - before[n] for n in KERNEL_NAMES}
    rates = {r: [] for r in runs}
    before = launch_counts()
    for _ in range(GRAPH_ROUNDS):
        for r, run in runs.items():
            t0 = time.perf_counter()
            with no_sync():
                run()
            torch.cuda.synchronize()
            rates[r].append(FIT_CHUNK / (time.perf_counter() - t0))
    check(launch_counts() == before,
          "natgrad: a replay ticked the launch counters")
    out = {"bit_for_bit": same, "eager_chunk_launches": eager}
    for r, run in runs.items():
        rate = statistics.median(rates[r])
        (busy, ops, top), launches = profile_chunk(
            run, FIT_CHUNK, f"natgrad {r}",
            expect=eager if r == "natgrad+adam" else None)
        out[r] = {"steps_per_s": rate, "rates": rates[r], "busy_ms": busy,
                  "device_ops": ops, "idle_share": 1 - busy * rate / 1e3,
                  "replay_launches": launches, "top": top}
        print(f"natgrad graphs {r}: steps/s median of {GRAPH_ROUNDS} chunks "
              f"of {FIT_CHUNK} (in turns) {rate:.2f} (all "
              f"{', '.join(f'{x:.2f}' for x in rates[r])}); device busy "
              f"{busy:.3f} ms in {ops:.0f} device ops a step, idle share "
              f"{out[r]['idle_share']:.3f}; a replayed chunk's launches "
              f"(profiler) {', '.join(f'{n} {c}' for n, c in launches.items() if c)};"
              f" top: {top} [{card}]", flush=True)
    want = {n: FIT_CHUNK * NG_STEP.get(n, 0) for n in KERNEL_NAMES}
    print(f"natgrad graphs: an eager chunk's launches (counters) "
          f"{', '.join(f'{n} {c}' for n, c in eager.items() if c)}; "
          f"expected {FIT_CHUNK} x {NG_STEP}", flush=True)
    check(eager == want and out["natgrad+adam"]["replay_launches"] == eager,
          f"natgrad: an eager chunk launched {eager} (counters), a replay "
          f"{out['natgrad+adam']['replay_launches']} (profiler), expected "
          f"{want}")
    return out


def natgrad_vs_adam(seed, card):
    """NG_COMPARE_STEPS steps of NatGrad+Adam and of Adam alone from one
    build state and seed: the negative ELBO on the whole training set at
    one fixed generator seed, and the last logged chunk loss, of each."""
    out = {}
    for name, gamma in (("natgrad+adam", NG_GAMMA), ("adam", None)):
        model = build_model(seed, num_samples=TRAIN_S,
                            random_posterior=False)[0]
        _, hist = fit(model, NG_COMPARE_STEPS, 0.01, batch_size=BATCH,
                      seed=seed, log_every=FIT_CHUNK, natgrad_gamma=gamma)
        g = torch.Generator(device="cuda").manual_seed(seed + 17)
        with torch.no_grad():
            full = model.loss(generator=g).item()
        out[name] = {"full_loss": full, "last_chunk_loss": hist[-1]["loss"]}
        rows = model.X_data.shape[0]
    print(f"natgrad vs adam after {NG_COMPARE_STEPS} steps from one state "
          f"and seed: negative ELBO on the {rows}-row training set "
          f"(S={TRAIN_S}, one fixed draw) natgrad+adam "
          f"{out['natgrad+adam']['full_loss']:.3f}, adam "
          f"{out['adam']['full_loss']:.3f}; last chunk's mean minibatch "
          f"loss {out['natgrad+adam']['last_chunk_loss']:.3f} vs "
          f"{out['adam']['last_chunk_loss']:.3f} [{card}]", flush=True)
    return out


def phase_natgrad(seed, card, worst):
    """27a: the headline DGP trained by fit(natgrad_gamma=0.1,
    ng_layers=(-1,)) for NG_STEPS steps (its main path: the launch counts
    at 0 just before and read just after), then the natural update's
    precision and time, graphed against eager, steps/s against Adam, and
    the loss after NG_COMPARE_STEPS steps against Adam's; the kernels
    on the operands the trained model hands them on a training minibatch
    (hold_captured_kernels; worst errors into ``worst``)."""
    model = build_model(seed, num_samples=TRAIN_S,
                        random_posterior=False)[0]
    last = model.layers[-1]
    q0 = [t.detach().clone() for t in (last.q_mu.unconstrained,
                                        last.q_sqrt.unconstrained)]
    t0 = time.perf_counter()
    hist, counts, replay = run_fit(model, NG_STEPS, seed,
                                   natgrad_gamma=NG_GAMMA, ng_layers=(-1,))
    fit_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    rejected = hist[-1]["rejected"]
    moved = [not torch.equal(a, b) for a, b in zip(
        q0, (last.q_mu.unconstrained, last.q_sqrt.unconstrained))]
    print(f"natgrad training: fit {NG_STEPS} NatGrad(gamma {NG_GAMMA}, last "
          f"layer) + Adam steps (graphed chunks of {FIT_CHUNK}, lr 0.01, "
          f"minibatch {BATCH}) in {fit_s:.1f} s: loss {losses[0]:.3f} "
          f"(steps 1-{FIT_CHUNK}) -> {losses[-1]:.3f} (last {FIT_CHUNK}); "
          f"natural updates rejected {rejected}; last layer's (q_mu, "
          f"q_sqrt) moved {moved}; launches (counters: the warm-up and "
          f"capture chunks) "
          + ", ".join(f"{n} {c}" for n, c in counts.items() if c)
          + "; a replayed chunk (profiler) "
          + ", ".join(f"{n} {c}" for n, c in replay.items() if c)
          + f" [{card}]", flush=True)
    check_fit_launches("natgrad", counts, replay, NG_STEP)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"natgrad: loss not finite or did not fall: {losses}")
    check(all(moved), "natgrad: the last layer's q_mu or q_sqrt did not "
                      "move")
    out = {"steps": NG_STEPS, "loss_first": losses[0],
           "loss_last": losses[-1], "rejected": rejected, "fit_s": fit_s,
           "launches_fit": counts, "launches_replay": replay}
    out["update"] = natgrad_update_precision(model, seed, card)
    rng = np.random.RandomState(seed + 37)
    idx = torch.as_tensor(rng.randint(0, model.X_data.shape[0], BATCH),
                          device="cuda")
    zs = [rng.randn(TRAIN_S, BATCH, 8) for _ in range(LAYERS - 1)] + [
        rng.randn(TRAIN_S, BATCH, 1)]
    out["kernel_shapes"] = hold_captured_kernels(
        "natgrad", lambda: model.loss(model.X_data[idx], model.Y_data[idx],
                                      zs=zs), seed, worst, n_fused=LAYERS)
    del model
    out["graphs"] = natgrad_rates(seed, card)
    out["vs_adam"] = natgrad_vs_adam(seed, card)
    return out


def phase_gamma1(card):
    """27b: one gamma = 1 natural step in float64 on the card lands on the
    collapsed bound: an SVGP's against SGPR's (rtol 1e-8) at
    tests/test_single_layer_models.py's shapes, DGPQuad(H=200)'s last
    layer against DGPCollapsed's (rtol 1e-7) at tests/test_collapsed.py's;
    every gram there is the float64 rbf_gram kernel."""
    from doubly_stochastic_dgp_tpu_torch import (SGPR, SVGP,
                                                 NaturalGradient)
    cfg = Config(jitter=1e-12)
    rng = np.random.RandomState(0)
    X, Y, Z = rng.rand(12, 2), rng.randn(12, 2), rng.rand(5, 2)

    def kern():
        return RBF(2, variance=1.1, lengthscales=0.6)

    sgpr = SGPR.build(X, Y, kern(), Z, noise_variance=0.2, config=cfg)
    svgp = SVGP.build(X, Y, kern(), Gaussian(0.2), Z, white=False,
                      config=cfg)
    NaturalGradient(1.0, (0,)).step(svgp, lambda m: -m.log_likelihood())
    with torch.no_grad():
        got = {"svgp": (svgp.log_likelihood().item(),
                        sgpr.log_likelihood().item())}
    np.random.seed(100)
    X = np.random.uniform(size=(1, 1))
    Y = np.random.uniform(size=(1, 1))
    Z = np.random.uniform(size=(8, 1))
    Z[:1] = X[:8]

    def kerns():
        return [RBF(1, lengthscales=0.1), RBF(1, lengthscales=0.5)]

    q_mu1 = np.random.randn(8, 1)
    q_sqrt1 = np.tril(np.random.randn(8, 8))[None]
    collapsed = DGPCollapsed.build(X, Y, Z, kerns(), Gaussian(0.1),
                                   config=cfg)
    quad = DGPQuad.build(X, Y, Gaussian(0.1),
                         init_layers_linear(X, Y, Z, kerns(), config=cfg),
                         H=200, config=cfg)
    for m in (collapsed, quad):
        m.layers[0].q_mu.set_value(q_mu1)
        m.layers[0].q_sqrt.set_value(q_sqrt1)
    NaturalGradient(1.0, (-1,)).step(quad, lambda m: -m.elbo())
    with torch.no_grad():
        got["quad"] = (quad.elbo().item(), collapsed.elbo().item())
    for name, (a, b), rtol in (("SVGP vs SGPR", got["svgp"], 1e-8),
                               ("DGPQuad vs DGPCollapsed", got["quad"],
                                1e-7)):
        rel = abs(a - b) / abs(b)
        print(f"gamma=1 identity {name}, float64 on the card: {a!r} vs "
              f"{b!r}, relative {rel:.3e} (limit {rtol:g}) [{card}]",
              flush=True)
        check(rel <= rtol, f"gamma=1 identity {name}: {rel} > {rtol}")
    return {k: {"natgrad": a, "collapsed": b} for k, (a, b) in got.items()}


def eval_deterministic(model, data):
    """Test RMSE and mean Gaussian log-likelihood of a single-layer
    model's deterministic predictive moments, de-normalized, as
    demos/uci_benchmark.py's eval_deterministic."""
    from scipy.stats import norm
    Xs, Ys, Y_std = data["Xs"], data["Ys"], data["Y_std"]
    means, vars_ = [], []
    for mb in range(-(-len(Xs) // 1000)):
        m, v = model.predict_y(Xs[mb * 1000:(mb + 1) * 1000])
        means.append(m.double().cpu().numpy())
        vars_.append(v.double().cpu().numpy())
    mean, var = np.concatenate(means), np.concatenate(vars_)
    rmse = float(np.average(Y_std * np.mean((Ys - mean) ** 2) ** 0.5))
    ll = float(np.average(norm.logpdf(Ys * Y_std, mean * Y_std,
                                      var ** 0.5 * Y_std)))
    return {"rmse": rmse, "loglik": ll}


# points at which the baselines' float32 bounds are held against float64:
# the trained parameters and BOUND_POINTS - 1 perturbations of them (each
# unconstrained parameter times 1 + 0.01 u, u standard normal), since one
# scalar's rounding error is a draw from a spread (PERF.md, section 6)
BOUND_POINTS = 8


def baseline_bound_gate(name, model, build, seed):
    """The float32 bound on the card and on the CPU against the float64
    CPU bound at BOUND_POINTS parameter points: raises when the card's
    median error is above 2x the CPU float32 bound's median, or the
    card's worst error above 2x the CPU's worst."""
    state = model.state_dict()
    params = dict(model.named_parameters())
    rng = np.random.RandomState(seed + 23)
    runs = {"card f32": model, "cpu f32": build("cpu", torch.float32),
            "cpu f64": build("cpu", torch.float64)}
    bounds = {r: [] for r in runs}
    for k in range(BOUND_POINTS):
        point = {n: (t if k == 0 or n not in params
                     else t * (1.0 + 0.01 * torch.as_tensor(
                         rng.randn(*t.shape), dtype=t.dtype,
                         device=t.device)))
                 for n, t in state.items()}
        for r, m in runs.items():
            m.load_state_dict(point)
            with torch.no_grad():
                bounds[r].append(m.log_likelihood().double().item())
    model.load_state_dict(state)
    errs = {r: [abs(a - b) for a, b in zip(bounds[r], bounds["cpu f64"])]
            for r in ("card f32", "cpu f32")}
    worst = {r: max(e) for r, e in errs.items()}
    median = {r: statistics.median(e) for r, e in errs.items()}
    # the rule as first written, at the trained parameters alone: printed
    # and kept, not gated (PERF.md, section 6; ROADMAP, queue C)
    one_point = errs["card f32"][0] / max(errs["cpu f32"][0], 1e-300)
    print(f"baseline {name} bound at the trained parameters and "
          f"{BOUND_POINTS - 1} perturbations: cpu f64 "
          f"{bounds['cpu f64'][0]!r} at the trained ones; |f32 - f64| card "
          + ", ".join(f"{e:.3e}" for e in errs["card f32"]) + "; cpu "
          + ", ".join(f"{e:.3e}" for e in errs["cpu f32"])
          + f"; median card {median['card f32']:.3e}, cpu "
            f"{median['cpu f32']:.3e} (ratio "
            f"{median['card f32'] / max(median['cpu f32'], 1e-300):.3f}, "
            f"gated at 2); worst card {worst['card f32']:.3e}, cpu "
            f"{worst['cpu f32']:.3e} (ratio "
            f"{worst['card f32'] / max(worst['cpu f32'], 1e-300):.3f}, "
            f"gated at 2); at the trained parameters alone card / cpu "
            f"{one_point:.3f} (not gated)", flush=True)
    check(median["card f32"] <= 2.0 * median["cpu f32"],
          f"baseline {name}: the card's float32 bound's median error "
          f"against float64 over {BOUND_POINTS} points, "
          f"{median['card f32']}, is above 2x the CPU float32 bound's "
          f"{median['cpu f32']}")
    check(worst["card f32"] <= 2.0 * worst["cpu f32"],
          f"baseline {name}: the card's float32 bound is up to "
          f"{worst['card f32']} off float64, above 2x the CPU float32 "
          f"bound's {worst['cpu f32']}")
    return {"bounds": bounds, "errors": errs, "worst": worst,
            "median": median, "one_point_ratio": one_point}


def phase_baselines(seed, card, worst):
    """27c: the UCI notebook's baselines at the kin8nm shape
    (demos/uci_benchmark.py:83-101): M=100, Z by kmeans2; SGPR and
    GPRFITC by lbfgs_minimize (at most BASELINE_LBFGS_ITERS iterations),
    SVGP by fit (TRAIN_STEPS Adam steps, minibatch BATCH, the fused
    route), a GPR on a GPR_ROWS-row subset by lbfgs_minimize (for the
    serving cell), with the launch counts at 0 before and read after;
    each model's test rmse and loglik (eval_deterministic); the SGPR and
    FITC float32 bounds against float64; then the kernels on the
    operands each trained model hands them, under phase 1's gates
    (hold_captured_kernels; worst errors into ``worst``)."""
    from scipy.cluster.vq import kmeans2
    from doubly_stochastic_dgp_tpu_torch import (GPR, GPRFITC, SGPR, SVGP,
                                                 lbfgs_minimize)
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    Z = kmeans2(X, M, minit="points", seed=0)[0]

    def config(dtype):
        return Config(dtype=dtype, jitter=1e-5, solve_mode="inverse")

    builds = {
        "SGPR": lambda dev="cuda", dt=torch.float32: SGPR.build(
            X, Y, RBF(8), Z, noise_variance=0.01, config=config(dt),
            device=dev),
        "GPRFITC": lambda dev="cuda", dt=torch.float32: GPRFITC.build(
            X, Y, RBF(8), Z, noise_variance=0.01, config=config(dt),
            device=dev)}
    out, models = {}, {}
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    for name, build in builds.items():
        t0 = time.perf_counter()
        model = build()
        with torch.no_grad():
            l0 = -model.log_likelihood().item()
        _, loss = lbfgs_minimize(lambda m: -m.log_likelihood(), model,
                                 max_iters=BASELINE_LBFGS_ITERS)
        lbfgs_s = time.perf_counter() - t0
        with torch.no_grad():
            l1 = -model.log_likelihood().item()
        metrics = eval_deterministic(model, data)
        print(f"baseline {name}: lbfgs_minimize (at most "
              f"{BASELINE_LBFGS_ITERS} iterations) in {lbfgs_s:.1f} s: loss "
              f"{l0:.3f} -> {l1:.3f} (last iteration's start {loss:.3f}); "
              f"rmse {metrics['rmse']:.6f}, loglik {metrics['loglik']:.6f} "
              f"on the {len(data['Xs'])}-row test split [{card}]",
              flush=True)
        check(np.isfinite([l0, l1, loss]).all() and l1 < l0,
              f"baseline {name}: the L-BFGS loss {l0} -> {l1} is not finite "
              f"or did not fall")
        models[name] = model
        out[name] = {"loss_first": l0, "loss_last": l1, "lbfgs_s": lbfgs_s,
                     "metrics": metrics}
    svgp = SVGP.build(X, Y, RBF(8), Gaussian(0.01), Z,
                      config=Config(dtype=torch.float32, jitter=1e-5,
                                    solve_mode="inverse", use_pallas=True))
    main = launch_counts()
    hist, counts, replay = run_fit(svgp, TRAIN_STEPS, seed)
    check_fit_launches("baseline SVGP", counts, replay, SVGP_STEP)
    set_launch_counts({n: main[n] + counts[n] for n in KERNEL_NAMES})
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"baseline SVGP: loss not finite or did not fall: {losses}")
    metrics = eval_deterministic(svgp, data)
    print(f"baseline SVGP: fit {TRAIN_STEPS} Adam steps (graphed, minibatch "
          f"{BATCH}): loss {losses[0]:.3f} -> {losses[-1]:.3f}; rmse "
          f"{metrics['rmse']:.6f}, loglik {metrics['loglik']:.6f}; "
          f"launches (counters) "
          + ", ".join(f"{n} {c}" for n, c in counts.items() if c)
          + f" [{card}]", flush=True)
    out["SVGP"] = {"loss_first": losses[0], "loss_last": losses[-1],
                   "metrics": metrics, "launches_fit": counts}
    rows = np.random.RandomState(seed + 19).choice(len(X), GPR_ROWS,
                                                  replace=False)
    gpr = GPR.build(X[rows], Y[rows], RBF(8), noise_variance=0.01,
                    config=config(torch.float32), device="cuda")
    with torch.no_grad():
        l0 = -gpr.log_likelihood().item()
    _, loss = lbfgs_minimize(lambda m: -m.log_likelihood(), gpr,
                             max_iters=BASELINE_LBFGS_ITERS)
    metrics = eval_deterministic(gpr, data)
    out["launches_main_path"] = launch_counts()
    print(f"baseline GPR on {GPR_ROWS} training rows: lbfgs_minimize loss "
          f"{l0:.3f} -> {loss:.3f}; rmse {metrics['rmse']:.6f}, loglik "
          f"{metrics['loglik']:.6f} [{card}]", flush=True)
    check(np.isfinite(loss) and loss < l0, f"baseline GPR: L-BFGS loss "
                                           f"{l0} -> {loss}")
    check(out["launches_main_path"]["rbf_gram"] > 0
          and out["launches_main_path"]["fused_conditional"] > 0,
          f"baselines: rbf_gram or the fused conditional was not launched "
          f"on the main path {out['launches_main_path']}")
    models["GPR"] = gpr
    out["GPR"] = {"loss_first": l0, "loss_last": loss, "metrics": metrics}
    for name, build in builds.items():
        out[name]["bound_gate"] = baseline_bound_gate(name, models[name],
                                                      build, seed)
    # the kernels on the operands the trained models hand them: SGPR's and
    # FITC's bound (Kuu, and Kuf at 100 x 7372), SVGP's objective on a
    # training minibatch (the fused pair at B=BATCH, Do=1, and its Kuu),
    # GPR's bound (K(X) at GPR_ROWS x GPR_ROWS)
    idx = torch.as_tensor(np.random.RandomState(seed + 29).randint(
        0, len(X), BATCH), device="cuda")
    runs = {name: (lambda m=models[name]: m.log_likelihood())
            for name in ("SGPR", "GPRFITC", "GPR")}
    runs["SVGP"] = lambda: svgp.log_likelihood(svgp.X_data[idx],
                                               svgp.Y_data[idx])
    out["kernel_shapes"] = {
        name: hold_captured_kernels(f"baseline {name}", run, seed, worst,
                                    n_fused=int(name == "SVGP"))
        for name, run in runs.items()}
    return out, models, data


def phase_baseline_serving(seed, card, models, data, collapsed, worst):
    """27d: make_server(precompute=True) on the trained SGPR, GPRFITC and
    GPR and on phase 9's collapsed_L2 and damianou_large (the kernel
    route): each cached model against the live one (the single-layer
    models within F32_PATH_ATOL; the collapsed DGPs at phase 9's fixed
    draws within CACHED_COLLAPSED_RTOL of scale), then 1000-row S=100
    requests live and cached, graphed against eager bit for bit, with
    their latency (serving_graphed_vs_eager); the launch counts at 0
    before the requests and read after.  Then the kernels on the operands
    a 1000-row request hands them, live and cached (hold_captured_kernels,
    forward only; worst errors into ``worst``)."""
    Xs = data["Xs"]
    out = {}
    served = dict(models)
    served.update({name: collapsed["models"][name]["kernel"]
                   for name in COLLAPSED})
    for name, model in served.items():
        cached = precompute(model)
        if name in COLLAPSED:
            zs = collapsed["zs"][name]
            live_p = model.predict_y(Xs, S=S, zs=zs)
            cached_p = cached.predict_y(Xs, S=S, zs=zs)
            err = pred_err(cached_p, live_p)
            limit = CACHED_COLLAPSED_RTOL
        else:
            live_p, cached_p = model.predict_y(Xs), cached.predict_y(Xs)
            err = max((a - b).abs().max().item()
                      for a, b in zip(cached_p, live_p))
            limit = F32_PATH_ATOL
        print(f"serving {name} cached vs live predict_y on "
              f"{len(Xs)} test rows: {err:.3e} (limit {limit:g}"
              f"{' of scale' if name in COLLAPSED else ''}) [{card}]",
              flush=True)
        check(err <= limit, f"serving {name}: cached vs live {err} > "
                            f"{limit}")
        out[name] = {"cached_vs_live": err}
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    for name, model in served.items():
        shape = (S, BATCH, 1) if name in COLLAPSED else (BATCH, 1)
        out[name]["serving"] = serving_graphed_vs_eager(
            model, data["X"], None, f"serving {name}", card, shape=shape)
    main = launch_counts()
    check(main["rbf_gram"] > 0 and main["psi2_core_forward"] > 0,
          f"baseline serving: rbf_gram or psi2 not launched on the main "
          f"path {main}")
    out["launches_main_path"] = main
    X = torch.as_tensor(data["X"][:BATCH], dtype=torch.float32,
                        device="cuda")
    for name, model in served.items():
        for mode, m in (("live", model), ("cached", precompute(model))):
            if name in COLLAPSED:
                g = torch.Generator(device="cuda").manual_seed(seed + 31)
                run = lambda m=m, g=g: m.predict_y(X, S=S, generator=g)  # noqa
            else:
                run = lambda m=m: m.predict_y(X)  # noqa: E731
            out[name][f"kernel_shapes_{mode}"] = hold_captured_kernels(
                f"serving {name} {mode}", run, seed, worst, backward=False)
    return out


def phase_natgrad_baselines(seed, card, collapsed):
    """Phase 27: natural gradients on the headline DGP (27a), the gamma =
    1 identities on the card (27b), the UCI baselines (27c) and their
    serving caches with the collapsed DGPs' (27d)."""
    t0 = time.perf_counter()
    worst = kernel_worst()
    out = {"natgrad": phase_natgrad(seed, card, worst)}
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    out["gamma1"] = phase_gamma1(card)
    out["gamma1"]["launches_main_path"] = launch_counts()
    check(out["gamma1"]["launches_main_path"]["rbf_gram"] > 0,
          "gamma=1 identities: rbf_gram was not launched")
    out["baselines"], models, data = phase_baselines(seed, card, worst)
    out["serving"] = phase_baseline_serving(seed, card, models, data,
                                            collapsed, worst)
    out["kernel_errs"] = worst
    out["wall_s"] = time.perf_counter() - t0
    print(f"natgrad phase wall time {out['wall_s']:.1f} s [{card}]",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 28: MCMC (SGPMC, GPMC, DGPHeinonen, HMC, NUTS) and the rest of
# serving (DynamicPredictor, export)
# ---------------------------------------------------------------------------

MC_BURN, MC_SAMPLES, MC_LEAPFROG, MC_STEP = 100, 100, 10, 0.01
MC_COMPARE = 10             # burn-in and samples of the graphed-vs-eager run
MC_RATE_ROUNDS = 3          # timed chunks a mode, in turns
MC_GRAPH_VS_EAGER_RTOL = 1e-4
CLOSED_HMC = (300, 1000)    # burn-in, samples of 28b's HMC
# 28b's leapfrog steps: with 28a's 10 at the adapted step (0.0319) two
# eigen-directions of the target (sds 0.0506, 0.0527) turn within 0.13
# rad of a whole period a trajectory, so a fixed-length chain hardly
# moves along them (on an H100 its marginal sds came out 37% off with
# ESS min 262, and 36% off in float64 on the CPU, tools/hmc_resonance.py;
# PERF.md, section 6); at 5 no direction comes within 0.6 rad of a turn
# (closed_form_resonance prints it each run)
CLOSED_LEAPFROG = 5
# 28b refuses to judge an HMC chain whose trajectory comes this near a
# whole turn in some eigen-direction (tools/hmc_resonance.py)
RESONANCE_RAD = 0.3
CLOSED_NUTS = (200, 600)    # burn-in, samples of 28b's NUTS
NUTS_DEPTH = 6
HEIN_N, HEIN_ITERS, HEIN_DEPTH, HEIN_S = 1000, 20, 5, 10
HEIN_CACHED_ATOL = 5e-3
DYN_S, DYN_BUCKETS = (1, 5, 25, 100), (1, 8, 32, 128)
EXPORT_ROWS = 1000
EXPORT_RTOL = 1e-6
# the fused pair's and rbf_gram's launches a gradient of the 5-layer
# SGPMC DGP on the fused route: a forward and a backward a layer, and
# the gram of Kuu a layer (its backward is closed-form torch)
MC_GRAD = {"fused_conditional": LAYERS, "fused_conditional_backward": LAYERS,
           "rbf_gram": LAYERS}


def sgpmc_model(seed, layers=LAYERS, device="cuda", dtype=torch.float32):
    """``sgpmc_headline``: the headline stack as ``init_layers_linear``
    builds it (M=100, inner RBF + White(2e-6), last RBF, Gaussian(0.05),
    linear mean skips), each SVGPLayer replaced by an SGPMCLayer(white=
    True) of its kernel, Z and mean; float32, jitter 1e-5,
    ``use_pallas=True``; S=1.  ``layers=1``: 28b's single RBF layer."""
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    rng = np.random.RandomState(seed)
    Z = X[rng.choice(X.shape[0], M, replace=False)]
    kernels = [RBF(8) + White(8, variance=2e-6, trainable=False)
               for _ in range(layers - 1)] + [RBF(8)]
    cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                 use_pallas=True)
    svgp = init_layers_linear(X, Y, Z, kernels, num_outputs=1, config=cfg)
    stack = [SGPMCLayer(l.kern, l.Z.value.detach().numpy(), l.num_outputs,
                        l.mean_function, white=True, config=cfg)
             for l in svgp]
    model = DGP.make(X, Y, Gaussian(0.05), stack, config=cfg, device=device)
    return model, data


def q_mu_only(name, param):
    return not name.endswith("q_mu.unconstrained")


def mc_target(model, seed):
    """elbo at fixed draws (one (1, N, D_l) tensor a layer, seeded) plus
    the q_mu priors, full batch."""
    g = torch.Generator(device="cuda").manual_seed(seed + 28)
    N = model.X_data.shape[0]
    zs = [torch.randn(1, N, l.num_outputs, generator=g, device="cuda")
          for l in model.layers]
    return lambda m: m.elbo(zs=zs) + log_prior(m)


def mc_chains(model, logp, seed, burn, samples):
    return HMCChains(model, logp, torch.Generator(device="cuda").manual_seed(
        seed + 280), num_samples=samples, num_burn=burn, step_size=MC_STEP,
        num_leapfrog=MC_LEAPFROG, freeze=q_mu_only, adapt_step_size=True)


def phase_sgpmc_headline(seed, card, worst):
    """28a: HMC over the 3300 inducing values of sgpmc_headline."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    t_phase = time.perf_counter()
    model, _ = sgpmc_model(seed)
    logp = mc_target(model, seed)
    P = sum(p.numel() for n, p in model.named_parameters()
            if not q_mu_only(n, p))
    check(P == 3300, f"sgpmc_headline: {P} sampled values, not 3300")
    # graphed against eager from one seed
    runs = {}
    for mode in ("graphed", "eager"):
        chains = mc_chains(model, logp, seed, MC_COMPARE, MC_COMPARE)
        with (eager_on_card() if mode == "eager"
              else contextlib.nullcontext()):
            runs[mode] = chains.run()
    torch.cuda.synchronize()
    a, b = runs["graphed"], runs["eager"]
    same = torch.equal(a, b)
    scale = b.abs().max().clamp_min(1e-30)
    it_worst = ((a - b).abs().amax(dim=(1, 2)) / scale).cpu().numpy()
    print(f"28a sgpmc_headline: {2 * MC_COMPARE} HMC iterations graphed vs "
          f"eager from one seed: positions bit for bit {same}; worst "
          f"{it_worst.max():.3e} of scale (iteration "
          f"{int(it_worst.argmax())}, tensor 'q_mu positions')", flush=True)
    check(same or it_worst.max() <= MC_GRAPH_VS_EAGER_RTOL,
          f"28a: graphed and eager HMC positions differ by "
          f"{it_worst.max()} of scale at iteration {int(it_worst.argmax())}")
    print(f"28a graphed vs eager done at {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    # the main path: the whole chain, graphed, counts at 0 just before
    counts0 = launch_counts()
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    chains = mc_chains(model, logp, seed, MC_BURN, MC_SAMPLES)
    t0 = time.perf_counter()
    qs = [chains.run_chunk()]                        # capture
    with no_sync():
        while chains.done < chains.total:
            qs.append(chains.run_chunk())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_counts = launch_counts()
    set_launch_counts(counts0)
    check(all(main_counts[n] > 0 for n in MC_GRAD),
          f"28a: a kernel of the path did not launch: {main_counts}")
    qs = torch.cat(qs)[:, 0]
    check(bool(torch.isfinite(qs).all()), "28a: non-finite positions")
    samples = qs[MC_BURN:].double().cpu().numpy()
    ess = effective_sample_size(samples[None])
    accept = float(chains.acc[0]) / chains.total
    step = float(chains.da.final_step_sizes()[0])
    check(0.0 < accept <= 1.0 and step > 0.0,
          f"28a: accept rate {accept}, step size {step}")
    print(f"28a main path done at {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    # launches a leapfrog: eager chunks by the counters, a replay by the
    # profiler; the main chain continues past its samples (its step size
    # frozen), graphed and eager chunks in turns, on its captured graph
    rate_chain = chains
    # (room for PROFILE_TRIES profiled chunks of each mode)
    rate_chain.total += (CHUNK * (2 * MC_RATE_ROUNDS + PROFILE_TRIES)
                         + PROFILE_TRIES)
    rates = {"graphed": [], "eager": []}
    counted = {}
    for _ in range(MC_RATE_ROUNDS):
        for mode in rates:
            before = launch_counts()
            t0 = time.perf_counter()
            if mode == "graphed":
                with no_sync():
                    rate_chain.run_chunk()
            else:
                with eager_on_card():
                    rate_chain.run_chunk()
            torch.cuda.synchronize()
            rates[mode].append(CHUNK / (time.perf_counter() - t0))
            counted[mode] = {n: launch_counts()[n] - before[n]
                             for n in KERNEL_NAMES}
    check(not any(counted["graphed"].values()),
          f"28a: a replay ticked the counters {counted['graphed']}")
    grads = CHUNK * (MC_LEAPFROG + 1)
    want = {n: v * grads for n, v in MC_GRAD.items()}
    got_eager = {n: v for n, v in counted["eager"].items() if v}
    check(got_eager == want, f"28a: an eager chunk launched {got_eager}, "
                             f"expected {want} ({grads} gradients)")
    prof = {}
    # a replayed chunk of 10 iterations; eagerly one iteration (the
    # profiler's overhead on ~8000 eager ops an iteration).  Idle share: busy against the wall of the profiled run itself (the
    # profiler's own cost adds to that wall), and against the rate of the
    # timed chunks (other runs: negative when the two disagree)
    for mode, n_it in (("graphed", CHUNK), ("eager", 1)):
        walls = []

        def profiled():
            t0 = time.perf_counter()
            rate_chain.run_chunk(n_it)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        with (eager_on_card() if mode == "eager"
              else contextlib.nullcontext()):
            (busy, ops, top), launched = profile_chunk(
                profiled, n_it * (MC_LEAPFROG + 1), f"28a {mode}",
                expect={n: want.get(n, 0) for n in KERNEL_NAMES}
                if mode == "graphed" else None)
        rate = statistics.median(rates[mode])
        grads_run = n_it * (MC_LEAPFROG + 1)
        prof[mode] = {"iterations_per_s": rate, "rates": rates[mode],
                      "busy_ms_per_gradient": busy,
                      "device_ops_per_gradient": ops,
                      "profiled_wall_ms": 1e3 * walls[-1],
                      "idle_share_profiled":
                          1 - busy * grads_run / (1e3 * walls[-1]),
                      "idle_share": 1 - busy * (MC_LEAPFROG + 1) * rate
                      / 1e3,
                      "launches_per_iteration": {
                          n: v / n_it for n, v in launched.items() if v},
                      "top": top}
        idle, idle_rate = (prof[mode]["idle_share_profiled"],
                           prof[mode]["idle_share"])
        print(f"28a sgpmc_headline {mode}: iterations/s median of "
              f"{MC_RATE_ROUNDS} chunks of {CHUNK} in turns {rate:.2f} "
              f"(all: {', '.join(f'{r:.2f}' for r in rates[mode])}); device "
              f"busy {busy:.3f} ms a gradient in {ops:.0f} device ops; idle "
              f"share in the profiled run {idle:.3f} (its wall "
              f"{prof[mode]['profiled_wall_ms']:.3f} ms for {grads_run} "
              f"gradients, the profiler's cost in it), against the timed "
              f"rate {idle_rate:.3f}"
              f"{' (unresolved: below 0)' if idle_rate < 0 else ''}; kernel "
              f"launches an "
              f"iteration (profiler) {prof[mode]['launches_per_iteration']};"
              f" top: {top} [{card}]", flush=True)
        if mode == "graphed":
            check({n: v for n, v in launched.items() if v} == want,
                  f"28a: a replayed chunk launched {launched} (profiler), "
                  f"the eager chunk {want} (counters)")
    # the kernels on the operands of one gradient of the sampled state
    rate_chain.target.rebuild(rate_chain.q[0])
    shapes, gram_shapes = hold_captured_kernels(
        "28a sgpmc_headline gradient", lambda: rate_chain.target.
        value_and_grad(rate_chain.q[0]), seed, worst, n_fused=LAYERS)
    rate_chain.target.rebuild(rate_chain.target.flat0)
    check(shapes[-1][2] == 1 and all(s[0] == 7372 for s in shapes),
          f"28a: fused calls {shapes}")
    out = {"P": P, "graphed_vs_eager_bit_for_bit": same,
           "graphed_vs_eager_worst": float(it_worst.max()),
           "launches_main_path": main_counts, "chain_wall_s": wall,
           "accept_rate": accept, "step_size": step,
           "ess_min": float(ess.min()), "ess_median": float(np.median(ess)),
           "launches_per_gradient": {n: v / grads for n, v in want.items()},
           "rates": prof, "kernel_shapes": shapes, "gram_shapes": gram_shapes}
    print(f"28a sgpmc_headline: P={P}, {MC_BURN} + {MC_SAMPLES} iterations "
          f"of {MC_LEAPFROG} leapfrog steps graphed in {wall:.1f} s; accept "
          f"rate {accept:.3f}, adapted step size {step:.4g}, ESS min "
          f"{ess.min():.1f} median {np.median(ess):.1f} of {MC_SAMPLES}; "
          f"main-path launches {main_counts}; launches a gradient "
          f"{out['launches_per_gradient']} [{card}]", flush=True)
    return out


def closed_form_posterior(model):
    """(mu, sd, Sigma) of the exactly Gaussian target over v = q_mu of a
    single white SGPMC layer with a Gaussian likelihood, in float64 on the
    host: Lambda = I + A A^T / s2, mu = Lambda^-1 A (y - m) / s2, A =
    Lu^-1 Kuf, from the model's own parameters."""
    layer = model.layers[0]
    host = copy.deepcopy(layer).to(device="cpu", dtype=torch.float64)
    X = model.X_data.double().cpu()
    Y = model.Y_data.double().cpu()
    with torch.no_grad():
        Z = host.Z.value
        Kuu = host.kern.K(Z) + layer.jitter * torch.eye(Z.shape[0],
                                                        dtype=torch.float64)
        Lu = torch.linalg.cholesky(Kuu)
        A = torch.linalg.solve_triangular(Lu, host.kern.K(Z, X), upper=False)
        r = (Y - host.mean_function(X))[:, 0]
    s2 = float(model.likelihood.variance.value.detach())
    A, r = A.numpy(), r.numpy()
    Lam = np.eye(A.shape[0]) + A @ A.T / s2
    Sig = np.linalg.inv(Lam)
    mu = Sig @ A @ r / s2
    return mu, np.sqrt(np.diag(Sig)), Sig


def closed_form_resonance(Sig, step, L):
    """The leapfrog trajectory's rotation in each eigen-direction of a
    Gaussian target of covariance Sig (cos theta = 1 - step^2 / (2
    sd^2), L steps): (the smallest distance of L theta from a whole
    turn, the eigen-sd there).  Near 0 a fixed-length HMC chain barely
    moves along that direction."""
    sd = np.sqrt(np.linalg.eigvalsh(Sig))
    theta = np.arccos(np.clip(1 - step ** 2 / (2 * sd ** 2), -1.0, 1.0))
    off = np.abs((L * theta + np.pi) % (2 * np.pi) - np.pi)
    return float(off.min()), float(sd[off.argmin()])


def phase_closed_form(seed, card):
    """28b: HMC and NUTS on the card against the closed-form posterior of
    a single SGPMCLayer(white=True), M=100, on the 7372 headline rows."""
    model, _ = sgpmc_model(seed, layers=1)
    logp = mc_target(model, seed)
    mu, sd, Sig = closed_form_posterior(model)
    out = {"posterior_sd_min": float(sd.min()),
           "posterior_sd_max": float(sd.max())}
    counts0 = launch_counts()
    for name in ("hmc", "nuts"):
        set_launch_counts({n: 0 for n in KERNEL_NAMES})
        g = torch.Generator(device="cuda").manual_seed(seed + 281)
        t0 = time.perf_counter()
        if name == "hmc":
            burn, n = CLOSED_HMC
            s, acc, _, info = hmc_sample(
                model, logp, g, num_samples=n, num_burn=burn,
                step_size=MC_STEP, num_leapfrog=CLOSED_LEAPFROG,
                freeze=q_mu_only, adapt_step_size=True)
            info = info._asdict()
            info["closest_to_a_turn_rad"], info["sd_there"] = \
                closed_form_resonance(Sig, info["step_size"],
                                      CLOSED_LEAPFROG)
        else:
            burn, n = CLOSED_NUTS
            s, acc, _, info = nuts_sample(
                model, logp, g, num_samples=n, num_burn=burn,
                step_size=MC_STEP, max_depth=NUTS_DEPTH, freeze=q_mu_only)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        s = s.double().cpu().numpy()
        check(np.isfinite(s).all(), f"28b {name}: non-finite samples")
        ess = effective_sample_size(s[None])
        bound = 4.5 * sd.max() / np.sqrt(ess.min())
        mean_err = np.abs(s.mean(0) - mu).max()
        sd_err = np.abs(s.std(0) / sd - 1.0).max()
        rec = {"wall_s": wall, "accept": acc, "ess_min": float(ess.min()),
               "ess_median": float(np.median(ess)),
               "max_mean_err": float(mean_err), "mean_bound": float(bound),
               "max_sd_rel_err": float(sd_err), "launches": counts,
               "info": {k: v for k, v in info.items() if k != "ess"}}
        print(f"28b closed form {name}: {burn} + {n} iterations in "
              f"{wall:.1f} s; accept {acc:.3f}; ESS min {ess.min():.1f} "
              f"median {np.median(ess):.1f}; max |mean - mu| "
              f"{mean_err:.4e} (bound 4.5 max sd / sqrt(ESS min) = "
              f"{bound:.4e}); max |sd / sd_true - 1| {sd_err:.4f} (gate "
              f"0.25); info {rec['info']}; launches {counts} [{card}]",
              flush=True)
        if name == "hmc":
            check(info["closest_to_a_turn_rad"] >= RESONANCE_RAD,
                  f"28b hmc: at the adapted step {info['step_size']} an "
                  f"eigen-direction (sd {info['sd_there']}) turns within "
                  f"{info['closest_to_a_turn_rad']} rad of a whole turn a "
                  f"trajectory: fixed-length HMC resonance, under which "
                  f"the chain mixes slowly along it and its marginal sds "
                  f"come out wrong whatever the kernels do; the gates "
                  f"below cannot judge this chain")
        check(mean_err <= bound, f"28b {name}: posterior mean off by "
                                 f"{mean_err} > {bound}")
        check(sd_err < 0.25, f"28b {name}: marginal sds off by {sd_err}")
        check(counts["fused_conditional"] > 0
              and counts["fused_conditional_backward"] > 0,
              f"28b {name}: the fused pair did not launch: {counts}")
        if name == "nuts":
            check(info["divergences"] == 0,
                  f"28b nuts: {info['divergences']} post-warmup divergences")
            print(f"28b nuts: host reads a transition "
                  f"{info['host_reads_per_transition']:.3f} (one a "
                  f"doubling; {info['host_reads']} in all), mean tree depth "
                  f"{info['mean_tree_depth']:.3f}", flush=True)
        out[name] = rec
    set_launch_counts(counts0)
    return out


def heinonen_model(data, device="cuda", dtype=torch.float32):
    """DGPHeinonen on the headline's first HEIN_N rows: tests/test_zoo.py's
    recipe (lengthscales 0.6, inner variance 0.05, Identity mean, noise
    0.05^2) on RBF kernels; float32, jitter 1e-5."""
    X, Y = data["X"][:HEIN_N], data["Y"][:HEIN_N]
    D = X.shape[1]
    cfg = Config(dtype=dtype, jitter=1e-5)
    layers = [GPMCLayer(RBF(D, lengthscales=0.6, variance=0.05), X, D,
                        Identity(), config=cfg),
              GPRLayer(RBF(D, lengthscales=0.6), Zero(1), 1, config=cfg)]
    return DGPHeinonen.make(X, Y, Gaussian(0.05 ** 2), layers, config=cfg,
                            device=device)


def phase_heinonen(seed, card, worst):
    """28c: DGPHeinonen at N=1000: NUTS over the GPMC layer's q_mu; the
    cached server against the live one; rbf_gram on its operands."""
    from doubly_stochastic_dgp_tpu_torch.graphs import eager_on_card
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    model = heinonen_model(data)
    counts0 = launch_counts()
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    t0 = time.perf_counter()
    s, acc, _, info = nuts_sample(
        model, lambda m: m.log_posterior(),
        torch.Generator(device="cuda").manual_seed(seed + 282),
        num_samples=HEIN_ITERS, num_burn=HEIN_ITERS, step_size=0.05,
        max_depth=HEIN_DEPTH, freeze=q_mu_only)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nuts_counts = launch_counts()
    moved = float(s.std(0).max())
    print(f"28c DGPHeinonen NUTS over {s.shape[1]} values: "
          f"{HEIN_ITERS} + {HEIN_ITERS} transitions in {wall:.1f} s, accept "
          f"{acc:.3f}, info {info}, samples finite "
          f"{bool(torch.isfinite(s).all())}, largest sd {moved:.4g}; "
          f"launches {nuts_counts} [{card}]", flush=True)
    check(bool(torch.isfinite(s).all()) and moved > 0,
          "28c: NUTS samples not finite or not moving")
    check(nuts_counts["rbf_gram"] > 0, "28c: rbf_gram did not launch")
    with torch.no_grad():
        model.layers[0].q_mu.unconstrained.copy_(s[-1].view_as(
            model.layers[0].q_mu.unconstrained))
    Xq = torch.as_tensor(data["X"][HEIN_N:2 * HEIN_N], dtype=torch.float32,
                         device="cuda")
    served = {}
    for name, pre in (("live", False), ("cached", True)):
        set_launch_counts({n: 0 for n in KERNEL_NAMES})
        serve = make_server(model, S=HEIN_S, precompute=pre)
        a = serve(Xq, seed=5)
        with eager_on_card():
            b = serve(Xq, seed=5)
        served[name] = a
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        check(same, f"28c {name}: graphed and eager requests differ")
        check(all(bool(torch.isfinite(t).all()) for t in a),
              f"28c {name}: non-finite predictions")
        lat = []
        for i in range(LATENCY_REPS):
            t0 = time.perf_counter()
            with no_sync():
                serve(Xq, seed=100 + i)
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t0))
        served[name + "_ms"] = statistics.median(lat)
        served[name + "_launches"] = launch_counts()
    diff = max(float((x - y).abs().max()) for x, y in
               zip(served["live"], served["cached"]))
    print(f"28c DGPHeinonen {HEIN_N}-row S={HEIN_S} request: cached vs live "
          f"{diff:.3e} (gate {HEIN_CACHED_ATOL}); graphed equal to eager; "
          f"latency live {served['live_ms']:.3f} ms, cached "
          f"{served['cached_ms']:.3f} ms (host clock, median of "
          f"{LATENCY_REPS}); launches live {served['live_launches']}, "
          f"cached {served['cached_launches']} [{card}]", flush=True)
    check(diff <= HEIN_CACHED_ATOL, f"28c: cached vs live {diff}")
    set_launch_counts(counts0)
    # rbf_gram on the Kuf (1000 x 1000) of a request and the GPR K
    _, gram_shapes = hold_captured_kernels(
        "28c DGPHeinonen", lambda: (model.log_posterior(),
                                    model.predict_y(Xq, S=1)),
        seed, worst, n_fused=0)
    check(any(s_ == (HEIN_N, HEIN_N, 8) for s_ in gram_shapes),
          f"28c: no 1000 x 1000 gram among {gram_shapes}")
    return {"nuts_wall_s": wall, "accept": acc,
            "info": {k: v for k, v in info.items()},
            "nuts_launches": nuts_counts, "cached_vs_live": diff,
            "latency_ms": {k: served[k + "_ms"] for k in ("live", "cached")},
            "gram_shapes": gram_shapes,
            "launches_main_path": {
                n: nuts_counts[n] + served["live_launches"][n]
                + served["cached_launches"][n] for n in KERNEL_NAMES}}


def phase_dynamic(seed, card, worst):
    """28d: DynamicPredictor on the headline DGP of phases 2-3; the fused
    forward and rbf_gram held under phase 1's gates on the operands each
    bucket's request hands them."""
    model, data = build_model(seed)
    X = torch.as_tensor(data["X"][:BATCH], dtype=torch.float32,
                        device="cuda")
    Ys = torch.as_tensor(data["Y"][:BATCH], dtype=torch.float32,
                         device="cuda")
    counts0 = launch_counts()
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    dp = DynamicPredictor(model, buckets=DYN_BUCKETS)
    lat = {}
    for S_ in DYN_S:
        got = dp.predict_y(X, S_, seed=9)
        B_ = dp._plan(S_)[0]
        want = make_server(model, B_, precompute=False)(X, seed=9)
        check(all(torch.equal(a, b[:S_]) for a, b in zip(got, want)),
              f"28d: S={S_}: the kept samples are not the first S of "
              f"make_server's S={B_} request")
        times = []
        for i in range(LATENCY_REPS):
            t0 = time.perf_counter()
            with no_sync():
                dp.predict_y(X, S_, seed=200 + i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        lat[S_] = statistics.median(times)
    server = make_server(model, S, precompute=False)
    times = []
    for i in range(LATENCY_REPS):
        t0 = time.perf_counter()
        with no_sync():
            server(X, seed=200 + i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    server_ms = statistics.median(times)
    captures = dict(dp.trace_counts)
    density = dp.predict_density(X, Ys, 25, seed=9)
    counts = launch_counts()
    set_launch_counts(counts0)
    print(f"28d DynamicPredictor, {X.shape[0]}-row predict_y at S in "
          f"{DYN_S} over buckets {DYN_BUCKETS}: programs {captures} "
          f"({len(captures)} captures); latency (host clock, median of "
          f"{LATENCY_REPS}) " + ", ".join(f"S={k} {v:.3f} ms"
                                          for k, v in lat.items())
          + f"; make_server S={S} {server_ms:.3f} ms; predict_density "
            f"finite {bool(torch.isfinite(density).all())}; launches "
            f"{counts} [{card}]", flush=True)
    check(len(captures) == len(DYN_S)
          and all(v == 1 for v in captures.values()),
          f"28d: captures {captures}, expected one for each of the "
          f"{len(DYN_S)} buckets S maps to")
    check(bool(torch.isfinite(density).all()), "28d: density not finite")
    shapes, gram_shapes = hold_captured_kernels(
        "28d dynamic", lambda: [dp.model.predict_y(X, S=b)
                                for b in DYN_BUCKETS],
        seed, worst, backward=False, n_fused=LAYERS * len(DYN_BUCKETS))
    return {"captures": {f"{k[0]} {k[1]}": v for k, v in captures.items()},
            "latency_ms": lat, "make_server_ms": server_ms,
            "launches_main_path": counts, "kernel_shapes": shapes,
            "gram_shapes": gram_shapes}


EXPORT_CHILD = r"""
import json, sys, torch
import doubly_stochastic_dgp_tpu_torch.ops.cuda
from torch.profiler import ProfilerActivity, profile
inputs = torch.load(sys.argv[1])
counts = {}
for name, path, result in zip(*[iter(sys.argv[2:])] * 3):
    module = torch.export.load(path).module()
    out = module(inputs["X"], *inputs["zs"])
    torch.cuda.synchronize()
    # the program runs the same kernels every call, and the profiler can
    # lose a record: the most that one of three profiled calls showed
    counts[name] = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.ones(1, device="cuda").add_(1.0)
            torch.cuda.synchronize()
            module(inputs["X"], *inputs["zs"])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        for k in ("fused_conditional_fwd_kernel", "rbf_gram_kernel"):
            counts[name][k] = max(counts[name].get(k, 0),
                                  sum(e.count for e in events if k in e.key))
    torch.save(out, result)
print(json.dumps(counts))
"""


def phase_export(seed, card, worst):
    """28e: export_predict_y of the headline DGP, live and precomputed,
    saved, then loaded and run in one fresh process that imports only the
    port's ops.cuda; the kernels held under phase 1's gates on the
    operands the two models' requests hand them."""
    from doubly_stochastic_dgp_tpu_torch.serving import predict_y_draws
    model, data = build_model(seed)
    X = torch.as_tensor(data["X"][:EXPORT_ROWS], dtype=torch.float32,
                        device="cuda")
    zs = predict_y_draws(model, EXPORT_ROWS, S,
                         torch.Generator(device="cuda").manual_seed(seed))
    out, args = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({"X": X, "zs": zs}, inputs)
        for name, pre in (("live", False), ("precomputed", True)):
            t0 = time.perf_counter()
            path = os.path.join(tmp, f"predict_y_{name}.pt2")
            export_predict_y(model, EXPORT_ROWS, S, path=path,
                             precomputed=pre)
            out[name] = {"export_s": time.perf_counter() - t0}
            args += [name, path, os.path.join(tmp, f"out_{name}.pt")]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, inputs,
                               *args], capture_output=True, text=True,
                              timeout=600, env=env)
        child_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"28e: the loaded programs failed:\n"
                                    f"{proc.stderr[-3000:]}")
        prof = json.loads(proc.stdout.strip().splitlines()[-1])
        models = {"live": model, "precomputed": precompute(model)}
        for name, pre in (("live", False), ("precomputed", True)):
            got = torch.load(os.path.join(tmp, f"out_{name}.pt"))
            src = models[name]
            want = src.predict_y(X, S=S, zs=zs)
            scale = max(float(w.abs().max()) for w in want)
            err = max(float((g - w).abs().max())
                      for g, w in zip(got, want)) / max(scale, 1.0)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"28e export {name}: {EXPORT_ROWS}-row S={S} predict_y "
                  f"exported in {out[name]['export_s']:.1f} s, loaded and "
                  f"run in a fresh process ({child_s:.1f} s for both): "
                  f"equal to the model bit for bit {same}, worst "
                  f"{err:.3e} of scale (gate {EXPORT_RTOL}); device launches "
                  f"in the loaded program (profiler) {prof[name]} "
                  f"[{card}]", flush=True)
            check(same or err <= EXPORT_RTOL,
                  f"28e {name}: the loaded program differs by {err}")
            check(pre or prof[name]["fused_conditional_fwd_kernel"]
                  == LAYERS,
                  f"28e {name}: the loaded program launched the fused "
                  f"forward {prof[name]['fused_conditional_fwd_kernel']} "
                  f"times, not {LAYERS}")
            out[name].update(bit_for_bit=same, rel_err=err,
                             device_launches=prof[name])
        out["child_s"] = child_s
    out["kernel_shapes"], out["gram_shapes"] = hold_captured_kernels(
        "28e export", lambda: [m.predict_y(X, S=S, zs=zs)
                               for m in models.values()],
        seed, worst, backward=False, n_fused=LAYERS)
    return out


def phase_mcmc(seed, card):
    """Phase 28: 28a-28e; the worst kernel errors on their operands."""
    worst = kernel_worst()
    t0 = time.perf_counter()
    out = {"sgpmc_headline": phase_sgpmc_headline(seed, card, worst)}
    print(f"28a done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["closed_form"] = phase_closed_form(seed, card)
    print(f"28b done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["heinonen"] = phase_heinonen(seed, card, worst)
    print(f"28c done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["dynamic"] = phase_dynamic(seed, card, worst)
    print(f"28d done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["export"] = phase_export(seed, card, worst)
    print(f"28e done at {time.perf_counter() - t0:.1f} s", flush=True)
    out["kernel_errs"] = worst
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 29: data parallelism over torch.distributed
# ---------------------------------------------------------------------------

DP_STEPS = 100              # 29a: fit_dp against fit
DP_ROUNDS = 4               # 29a: timed chunks of each, in turns (was 6)
DP_FIT_RTOL = 1e-5          # 29a: fit_dp vs fit, if not bit for bit
DP_ROWS = 1001              # 29b: dp_elbo's batch (odd: padding runs)
DP_RANK_STEPS = 20          # 29b: fit_dp steps on the two ranks
DP_SP_STEPS = 10            # 29c
DP_PRED_ROWS, DP_PRED_S = 1000, 100
DP_HMC = (10, 10)           # 29b: burn-in, samples of the split chains
DP_GATE = 1e-5              # of scale, or 2x the float32 error vs float64
DP_F32_SHARE = 0.1          # 29b bounds: of one process's f32 error vs f64
DP_F64_RTOL = 1e-9          # 29b bounds in float64: the algebra
DP_TIMEOUT_S = 300.0        # every collective of 29b-c, and their run


def dp_draws(model, seed, rows, S_):
    """Fixed unit normals (S_, rows, D_l) a layer, on the card: drawn in
    float32 and cast to the model's dtype, so a float64 model gets the
    same numbers."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2900)
    return [torch.randn((S_, rows, l.num_outputs), generator=g,
                        device="cuda").to(model.X_data.dtype)
            for l in model.layers]


def eval_rows(data):
    """The test split and one training row (821 rows: the ranks' split
    pads one)."""
    return (np.concatenate([data["Xs"], data["X"][:1]]),
            np.concatenate([data["Ys"], data["Y"][:1]]))


def host(t):
    return t.detach().double().cpu().numpy()


def host_keep(t):
    """``t`` as a numpy array of its own dtype."""
    return t.detach().cpu().numpy()


def trainable_names(model):
    return [n for n, p in model.named_parameters() if p.requires_grad]


def dp_rank(rank, seed):
    """29b and 29c on one of two gloo ranks sharing cuda:0 (run by
    ``run_ranks``; this module is imported in the rank, its ``main`` not
    run): returns numpy results and the rank's main-path launches."""
    from torch.distributed.device_mesh import init_device_mesh
    from doubly_stochastic_dgp_tpu_torch import fit_dp
    from doubly_stochastic_dgp_tpu_torch.parallel import collapsed as pcoll
    from doubly_stochastic_dgp_tpu_torch.parallel import dp as pdp
    from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pmesh
    from doubly_stochastic_dgp_tpu_torch.training.hmc import (
        hmc_sample_chains)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    mesh = pmesh.make_mesh()
    out = {}
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    model, data = build_model(seed, num_samples=TRAIN_S)
    X, Y = model.X_data[:DP_ROWS], model.Y_data[:DP_ROWS]
    zs = dp_draws(model, seed, DP_ROWS, TRAIN_S)
    params = [p for p in model.parameters() if p.requires_grad]
    value, grads = pdp.dp_value_and_grads(
        lambda: pdp.dp_elbo(model, X, Y, None, mesh, zs=zs), params, mesh)
    out["dp_elbo"] = (float(value), [host(g) for g in grads])
    m = build_model(seed, num_samples=TRAIN_S, random_posterior=False)[0]
    t0 = time.perf_counter()
    _, hist = fit_dp(m, mesh, DP_RANK_STEPS, 0.01, batch_size=BATCH,
                     seed=seed, log_every=FIT_CHUNK)
    torch.cuda.synchronize()
    out["fit_dp"] = ([host(p) for p in m.parameters()],
                     [(h["iter"], h["loss"], h["dispatch"]) for h in hist],
                     time.perf_counter() - t0)
    out["predict_y"] = tuple(map(host, pdp.dp_predict_y(
        model, model.X_data[:DP_PRED_ROWS], DP_PRED_S, seed + 29, mesh)))
    Xe, Ye = eval_rows(data)
    out["evaluate"] = pdp.dp_evaluate_regression(
        model, Xe, Ye, data["Y_std"], DP_PRED_S, seed + 30, mesh)
    build, _ = collapsed_models(data, seed)
    for name in COLLAPSED:
        cm = build(name, *ROUTES["kernel"])
        before = psi2.psi2_core.launches
        with torch.no_grad():
            b = (pcoll.dp_damianou_elbo(cm, mesh) if name == "damianou_large"
                 else pcoll.dp_collapsed_elbo(
                     cm, mesh, zs=dp_draws(cm, seed, cm.X_data.shape[0], 1)))
        torch.cuda.synchronize()
        out[name] = (float(b), psi2.psi2_core.launches - before)
        cm64 = build(name, *ROUTES["f64"])
        with torch.no_grad():
            out[f"{name} f64"] = float(
                pcoll.dp_damianou_elbo(cm64, mesh)
                if name == "damianou_large" else pcoll.dp_collapsed_elbo(
                    cm64, mesh, zs=dp_draws(cm64, seed, cm64.X_data.shape[0],
                                            1)))
        del cm64
        # one data-parallel Adam step: the psi2 backward on the rank's rows
        if name == "damianou_large":
            cm = pcoll.damianou_shard(cm, mesh)
            step = pcoll.make_dp_damianou_train_step(
                masked_optimizer(cm, 0.01), mesh)
            run = lambda: step(cm)                          # noqa: E731
        else:
            step = pcoll.make_dp_collapsed_train_step(
                masked_optimizer(cm, 0.01), mesh)
            run = lambda: step(cm, seed=seed)               # noqa: E731
        before = psi2.psi2_core.backward_launches
        loss = float(run())
        torch.cuda.synchronize()
        specs = pcoll.damianou_specs(cm)
        out[f"{name} step"] = (loss, [host(p) for n, p in
                                      cm.named_parameters()
                                      if specs[n] is None])
        out[f"{name} step launches"] = (psi2.psi2_core.backward_launches
                                        - before)
        del cm, step, run
    sg, _ = sgpmc_model(seed, layers=1)
    samples, _, _, info = hmc_sample_chains(
        sg, mc_target(sg, seed), torch.Generator(device="cuda").manual_seed(
            seed + 290), num_chains=2, num_samples=DP_HMC[1],
        num_burn=DP_HMC[0], step_size=MC_STEP, num_leapfrog=CLOSED_LEAPFROG,
        freeze=q_mu_only, mesh=mesh)
    out["hmc"] = (host(samples), info["accept_rates"])
    out["counts_29b"] = launch_counts()
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    sp = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "sample"))
    with torch.no_grad():
        out["sp_elbo"] = float(pdp.sp_elbo(model, X, Y, None, sp, zs=zs))
    m = build_model(seed, num_samples=TRAIN_S, random_posterior=False)[0]
    _, hist = fit_dp(m, sp, DP_SP_STEPS, 0.01, batch_size=BATCH, seed=seed,
                     sample_axis="sample", log_every=DP_SP_STEPS)
    out["fit_dp_sample"] = ([host(p) for p in m.parameters()],
                            [h["loss"] for h in hist])
    out["counts_29c"] = launch_counts()
    out["30"] = sharded_ranks(seed)
    return out


def dp_gate(what, got, s32, s64):
    """Raise unless ``got`` is within DP_GATE of the float64 scale of the
    single-process float32 value ``s32``, or within 2x its error against
    float64; returns (|got - s32|, the allowance)."""
    got, s32, s64 = (np.asarray(a, dtype=np.float64) for a in (got, s32,
                                                               s64))
    scale = max(float(np.max(np.abs(s64))), 1e-30)
    err = float(np.max(np.abs(got - s32)))
    allow = max(DP_GATE * scale, 2.0 * float(np.max(np.abs(s32 - s64))))
    check(np.isfinite(got).all() and err <= allow,
          f"{what}: {err:.4e} from the single-process float32 value "
          f"(allowed {allow:.4e})")
    return err, allow


def nccl_kernels(prof):
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "nccl" in e.key.lower())


def phase_parallel_nccl(seed, card, mnist):
    """29a: a one-rank NCCL group on cuda:0, fit_dp against fit, and
    30c in the same group; the group is destroyed after the phase's
    graphs are freed."""
    import torch.distributed as dist
    from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pmesh
    with tempfile.TemporaryDirectory() as store:
        pmesh.initialize_distributed(f"file://{store}/store", 1, 0,
                                     timeout_s=DP_TIMEOUT_S)
        try:
            check(dist.get_backend() == "nccl", "29a: the group is not NCCL")
            mesh = pmesh.make_mesh()
            out = fit_dp_against_fit(seed, card, mesh)
            out["all_gather"] = nccl_gather(mesh)
            t0 = time.perf_counter()
            out["one_rank"] = one_rank_sharding(seed, mnist)
            out["one_rank"]["wall_s"] = time.perf_counter() - t0
            return out
        finally:
            torch.cuda.synchronize()
            dist.destroy_process_group()


def nccl_gather(mesh):
    """29a: ``all_gather`` on the one-rank NCCL mesh (a gather, its
    backward a reduce-scatter) returns its input and passes the gradient
    through, bit for bit."""
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import all_gather
    g = torch.Generator(device="cuda").manual_seed(2990)
    x = torch.randn((7, 3), generator=g, device="cuda").requires_grad_()
    ct = torch.randn((7, 3), generator=g, device="cuda")
    y = all_gather(x, mesh, "data")
    y.backward(ct)
    torch.cuda.synchronize()
    same = torch.equal(y, x) and torch.equal(x.grad, ct)
    print(f"29a all_gather on the one-rank NCCL mesh (all_gather_into_"
          f"tensor, backward reduce_scatter_tensor): value and gradient bit "
          f"for bit {same}", flush=True)
    check(same, "29a: the NCCL gather changed its input or its gradient")
    return same


def fit_dp_against_fit(seed, card, mesh):
    """29a's checks on ``mesh`` (one rank, NCCL)."""
    from torch.profiler import ProfilerActivity, profile
    from doubly_stochastic_dgp_tpu_torch import fit_dp
    from doubly_stochastic_dgp_tpu_torch.parallel.dp import (
        make_dp_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_scan_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    ma = build_model(seed, num_samples=TRAIN_S, random_posterior=False)[0]
    mb = build_model(seed, num_samples=TRAIN_S, random_posterior=False)[0]
    _, counts_fit, _ = run_fit(ma, DP_STEPS, seed, profiled=False)
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    _, hist = fit_dp(mb, mesh, DP_STEPS, 0.01, batch_size=BATCH,
                     seed=seed, log_every=FIT_CHUNK)
    torch.cuda.synchronize()
    counts = launch_counts()
    same, worst, where = param_agreement(mb, ma)
    print(f"29a fit_dp on a one-rank NCCL mesh vs fit: parameters after "
          f"{DP_STEPS} steps bit for bit {same}; worst {worst:.3e} of "
          f"scale ({where}); dispatch {sorted({h['dispatch'] for h in hist})}"
          f"; launches fit_dp {counts}, fit {counts_fit} [{card}]",
          flush=True)
    check(same or worst <= DP_FIT_RTOL,
          f"29a: fit_dp differs from fit by {worst} of scale in {where}")
    check(all(h["dispatch"] == "graph" for h in hist),
          "29a: a fit_dp chunk did not run as a captured graph")
    check(counts == counts_fit, f"29a: fit_dp launched {counts}, fit "
                                f"{counts_fit}")
    per_step = {"fused_conditional": LAYERS,
                "fused_conditional_backward": LAYERS,
                "rbf_gram": 2 * LAYERS}
    want = {n: FIT_CHUNK * per_step.get(n, 0) for n in KERNEL_NAMES}
    check(counts == {n: FIT_CAPTURE_CHUNKS * v for n, v in want.items()},
          f"29a: fit_dp's counters {counts} != {per_step} a step over "
          f"the warm-up and capture chunks")
    # the chunks, for the all-reduces, the launches and the rates
    chunks = {"fit_dp": make_dp_scan_train_step(
        masked_optimizer(mb, 0.01), mesh, batch_size=BATCH,
        inner_steps=FIT_CHUNK),
        "fit": make_scan_train_step(masked_optimizer(ma, 0.01), BATCH,
                                    FIT_CHUNK)}
    gens = {k: torch.Generator(device="cuda").manual_seed(seed + 1)
            for k in chunks}
    runs = {"fit_dp": lambda: chunks["fit_dp"](mb, gens["fit_dp"]),
            "fit": lambda: chunks["fit"](ma, gens["fit"])}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runs["fit_dp"]()                   # warm-up and capture
    # the host records of the collective (the c10d op, NCCL's own)
    reduces = {e.key: e.count for e in prof.key_averages()
               if "allreduce" in e.key.lower().replace("_", "")}
    runs["fit"]()
    torch.cuda.synchronize()
    # NCCL's own record counts the calls, one a step of the warm-up and
    # of the capture; the c10d op is recorded once a call in the warm-up
    # and twice in the capture, which runs under a TorchDispatchMode
    # (graphs.CapturedCall names a failed capture's op): the profiler
    # records the op where it enters the dispatcher and again where the
    # mode redispatches it
    want_records = {"nccl:all_reduce": FIT_CAPTURE_CHUNKS * FIT_CHUNK,
                    "c10d::allreduce_": 3 * FIT_CHUNK}
    check(all(reduces.get(k) == v for k, v in want_records.items()),
          f"29a: all-reduce records {reduces} in the warm-up and capture "
          f"of a {FIT_CHUNK}-step chunk, expected {want_records}")
    for i in range(1, PROFILE_TRIES + 1):
        shield_profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with no_sync():
                runs["fit_dp"]()
            torch.cuda.synchronize()
        replay, nccl = device_launches(prof), nccl_kernels(prof)
        if replay == want:
            break
        print(f"29a: a replay launched {replay} (try {i}); profiling again",
              flush=True)
    print(f"29a: a replayed fit_dp chunk of {FIT_CHUNK} steps: launches "
          f"(profiler) {replay}; NCCL kernels {nccl} (a one-rank in-place "
          f"sum launches none: the collective's device work is not "
          f"measurable on one rank); all-reduce records in its warm-up and "
          f"capture {reduces}", flush=True)
    check(replay == want, f"29a: a replay launched {replay} != {want}")
    rates = {k: [] for k in runs}
    for _ in range(DP_ROUNDS):
        for k, run in runs.items():
            t0 = time.perf_counter()
            with no_sync():
                run()
            torch.cuda.synchronize()
            rates[k].append(FIT_CHUNK / (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in rates.items()}
    print(f"29a steps/s, median of {DP_ROUNDS} chunks of {FIT_CHUNK} in "
          f"turns (sync debug 'error'): fit_dp {med['fit_dp']:.2f} "
          f"(all: {', '.join(f'{r:.2f}' for r in rates['fit_dp'])}), fit "
          f"{med['fit']:.2f} (all: "
          f"{', '.join(f'{r:.2f}' for r in rates['fit'])}) [{card}]",
          flush=True)
    return {"bit_for_bit": same, "worst_rel_diff": worst,
            "launches": counts, "replay_launches": replay,
            "nccl_kernels_per_step": nccl / FIT_CHUNK,
            "all_reduce_records_capture": reduces,
            "steps_per_s": med, "rates": rates}


def phase_parallel_gloo(seed, card, mnist):
    """29b-c and 30a-b: two gloo ranks on cuda:0 against this process."""
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import (
        rank_generator, run_ranks)
    from doubly_stochastic_dgp_tpu_torch.training.hmc import (
        hmc_sample_chains)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        value_and_grads)
    t0 = time.perf_counter()
    # run_ranks places its ranks on the card by default
    res = run_ranks(dp_rank, 2, (seed,), backend="gloo",
                    timeout_s=DP_TIMEOUT_S)
    print(f"29b-c: two gloo ranks on cuda:0 done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    a, b = res
    for key in ("dp_elbo", "predict_y", "evaluate", "hmc", "sp_elbo",
                "fit_dp_sample") + COLLAPSED + tuple(
                    f"{n} {k}" for n in COLLAPSED for k in ("step", "f64")):
        check(pickle_equal(a[key], b[key]),
              f"29b-c {key}: the two ranks disagree")
    check(pickle_equal(a["fit_dp"][:2], b["fit_dp"][:2]),
          "29b fit_dp: the two ranks disagree")
    out = {}
    model, data = build_model(seed, num_samples=TRAIN_S)
    m64, _ = build_model(seed, num_samples=TRAIN_S, dtype=torch.float64,
                         use_pallas=False)
    X, Y = model.X_data[:DP_ROWS], model.Y_data[:DP_ROWS]
    zs = dp_draws(model, seed, DP_ROWS, TRAIN_S)
    refs = {}
    for label, m in (("f32", model), ("f64", m64)):
        params = [p for p in m.parameters() if p.requires_grad]
        z = [t.to(m.X_data.dtype) for t in zs]
        v, g = value_and_grads(lambda: m.elbo(X.to(m.X_data.dtype),
                                              Y.to(m.X_data.dtype), zs=z),
                               params)
        refs[label] = (float(v), [host(t) for t in g])
    value, grads = a["dp_elbo"]
    err, allow = dp_gate("29b dp_elbo", value, refs["f32"][0],
                         refs["f64"][0])
    gerr = []
    for name, g, g32, g64 in zip(trainable_names(model), grads,
                                 refs["f32"][1], refs["f64"][1]):
        gerr.append((name,) + dp_gate(f"29b dp_elbo gradient {name}", g,
                                      g32, g64))
    worst = max(gerr, key=lambda e: e[1] / e[2])
    print(f"29b dp_elbo on 2 gloo ranks, {DP_ROWS} rows (padded), fixed "
          f"draws: {value:.6f} vs single-process float32 "
          f"{refs['f32'][0]:.6f} (float64 {refs['f64'][0]:.6f}): |d| "
          f"{err:.3e} (allowed {allow:.3e}); gradients: worst {worst[1]:.3e} "
          f"of allowed {worst[2]:.3e} ({worst[0]}); ranks bit for bit True",
          flush=True)
    out["dp_elbo"] = {"value": value, "f32": refs["f32"][0],
                      "f64": refs["f64"][0], "err": err, "allowed": allow}
    params, hist, wall = a["fit_dp"]
    losses = [h[1] for h in hist]
    print(f"29b fit_dp on 2 gloo ranks: {DP_RANK_STEPS} steps in {wall:.1f} "
          f"s ({DP_RANK_STEPS / wall:.2f} steps/s, dispatch "
          f"{sorted({h[2] for h in hist})}); losses {losses}; ranks bit for "
          f"bit True [{card}]", flush=True)
    check(all(np.isfinite(losses)) and all(h[2] == "eager" for h in hist),
          f"29b fit_dp: {hist}")
    out["fit_dp"] = {"losses": losses, "steps_per_s": DP_RANK_STEPS / wall}
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    mean_s, var_s = model.predict_y(model.X_data[:DP_PRED_ROWS], DP_PRED_S,
                                    generator=g)
    mean1 = mean_s.double().mean(0)
    var1 = (var_s.double() + mean_s.double() ** 2).mean(0) - mean1 ** 2
    d_mean = float(np.max(np.abs(a["predict_y"][0] - host(mean1))))
    d_var = float(np.max(np.abs(a["predict_y"][1] - host(var1))))
    print(f"29b dp_predict_y {DP_PRED_ROWS} rows S={DP_PRED_S} (50 samples "
          f"a rank): vs one process on the same draws max |dmean| "
          f"{d_mean:.3e}, max |dvar| {d_var:.3e}", flush=True)
    check(d_mean <= DP_GATE * float(mean1.abs().max())
          and d_var <= DP_GATE * float(var1.abs().max()),
          f"29b dp_predict_y: {d_mean}, {d_var}")
    Xs, Ys = eval_rows(data)
    n = len(Xs) + len(Xs) % 2
    gens = [rank_generator(seed + 30, r, "cuda") for r in range(2)]
    # rank r's draws, a layer at a time from its generator, joined by rows
    per_rank = [[torch.randn((DP_PRED_S, n // 2, l.num_outputs),
                             generator=gr, device="cuda")
                 for l in model.layers] for gr in gens]
    zs_eval = [torch.cat([d[i] for d in per_rank], dim=1)[:, :len(Xs)]
               for i in range(len(model.layers))]
    want = evaluate_regression(model, Xs, Ys, data["Y_std"], DP_PRED_S,
                               zs=zs_eval)
    got = a["evaluate"]
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("rmse", "nll"))
    print(f"29b dp_evaluate_regression on {len(Xs)} rows: {got} vs one "
          f"process on the ranks' draws {want}: worst relative {rel:.3e}",
          flush=True)
    check(rel <= DP_GATE, f"29b dp_evaluate_regression: {got} vs {want}")
    out["evaluate"] = {"dp": got, "single": want}
    build, _ = collapsed_models(data, seed)
    for name in COLLAPSED:
        vals = {}
        for route in ("kernel", "f64"):
            cm = build(name, *ROUTES[route])
            with torch.no_grad():
                vals[route] = float(cm.elbo(zs=dp_draws(
                    cm, seed, cm.X_data.shape[0], 1)) if name ==
                    "collapsed_L2" else cm.elbo())
            del cm
        got, launched = a[name]
        got64 = a[f"{name} f64"]
        # the kernel route on the ranks against one process on the same
        # route; the algebra in float64, where rounding does not hide it
        f32_err = abs(vals["kernel"] - vals["f64"])
        allow = max(DP_F32_SHARE * f32_err, DP_GATE * abs(vals["f64"]))
        err = abs(got - vals["kernel"])
        allow64 = DP_F64_RTOL * abs(vals["f64"])
        err64 = abs(got64 - vals["f64"])
        print(f"29b {name} data-parallel bound on 2 ranks (psi2 kernel "
              f"route): {got:.4f}; one process float32 {vals['kernel']:.4f}"
              f": |dp - f32| {err:.4e} (allowed {allow:.4e}); float64 on "
              f"the plain route {got64:.8f} vs one process {vals['f64']:.8f}"
              f": |d| {err64:.4e} (allowed {allow64:.4e}); against float64"
              f" |dp - f64| {abs(got - vals['f64']):.4e}, |f32 - f64| "
              f"{f32_err:.4e}; psi2 forward launches a rank {launched}",
              flush=True)
        check(np.isfinite(got) and err <= allow,
              f"29b {name}: {got} vs one process's float32 {vals['kernel']}")
        check(err64 <= allow64,
              f"29b {name} float64: {got64} vs one process's {vals['f64']}")
        check(launched == 1, f"29b {name}: {launched} psi2 launches a rank")
        loss, _ = a[f"{name} step"]
        back = [r[f"{name} step launches"] for r in res]
        print(f"29b {name} data-parallel Adam step on 2 ranks: loss "
              f"{loss:.4f}; replicated parameters bit for bit across the "
              f"ranks True; psi2 backward launches a rank {back}",
              flush=True)
        check(np.isfinite(loss) and back == [1, 1],
              f"29b {name} step: loss {loss}, psi2 backward launches {back}")
        out[name] = {"dp": got, "f32": vals["kernel"], "f64": vals["f64"],
                     "dp_f64": got64, "psi2_launches_per_rank": launched,
                     "step_loss": loss}
    sg, _ = sgpmc_model(seed, layers=1)
    samples, _, _, _ = hmc_sample_chains(
        sg, mc_target(sg, seed), torch.Generator(device="cuda").manual_seed(
            seed + 290), num_chains=2, num_samples=DP_HMC[1],
        num_burn=DP_HMC[0], step_size=MC_STEP, num_leapfrog=CLOSED_LEAPFROG,
        freeze=q_mu_only)
    same = np.array_equal(a["hmc"][0], host(samples))
    print(f"29b HMC: 2 chains split over 2 ranks vs one process, no mesh, "
          f"from the same generator ({DP_HMC[0]} + {DP_HMC[1]} iterations): "
          f"bit for bit {same}; accept {a['hmc'][1]}", flush=True)
    check(same, "29b: the split HMC chains differ from one process's")
    err, allow = dp_gate("29c sp_elbo", a["sp_elbo"], refs["f32"][0],
                         refs["f64"][0])
    print(f"29c sp_elbo on a (data 1 x sample 2) mesh, fixed draws: "
          f"{a['sp_elbo']:.6f} vs single-process {refs['f32'][0]:.6f}: |d| "
          f"{err:.3e} (allowed {allow:.3e}); fit_dp(sample_axis='sample') "
          f"{DP_SP_STEPS} steps: losses {a['fit_dp_sample'][1]}, ranks bit "
          f"for bit True", flush=True)
    check(np.isfinite(a["fit_dp_sample"][1]).all(), "29c fit_dp: loss")
    out["sp_elbo"] = {"value": a["sp_elbo"], "err": err, "allowed": allow}
    out["launches_29b"] = {n: a["counts_29b"][n] + b["counts_29b"][n]
                           for n in KERNEL_NAMES}
    out["launches_29c"] = {n: a["counts_29c"][n] + b["counts_29c"][n]
                           for n in KERNEL_NAMES}
    t0 = time.perf_counter()
    out["30"] = check_sharded(seed, card, a["30"], b["30"], mnist,
                              (model, m64))
    out["30"]["checks_s"] = time.perf_counter() - t0
    return out


def pickle_equal(x, y):
    import pickle
    return pickle.dumps(x) == pickle.dumps(y)


def phase_parallel(seed, card):
    """Phases 29 and 30: 29a and 30c (one-rank NCCL), 29b-c and 30a-b
    (two gloo ranks)."""
    counts0 = launch_counts()
    t0 = time.perf_counter()
    mnist = sharded_mnist(seed)
    build_s = time.perf_counter() - t0
    out = {"nccl": phase_parallel_nccl(seed, card, mnist)}
    print(f"29a and 30c done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    out["gloo"] = phase_parallel_gloo(seed, card, mnist)
    out["wall_s"] = time.perf_counter() - t0
    set_launch_counts(counts0)
    p30 = out["gloo"]["30"]
    # phase 30's share: this process's MNIST models, 30c, the ranks' work
    # for 30a-b (the slower rank's) and the checks here
    out["phase30_s"] = (build_s + out["nccl"]["one_rank"]["wall_s"]
                        + p30["rank_s"] + p30["checks_s"])
    print(f"parallel phase wall time {out['wall_s']:.1f} s, of it phase 30 "
          f"{out['phase30_s']:.1f} s (MNIST models here {build_s:.1f} s, "
          f"30c {out['nccl']['one_rank']['wall_s']:.1f} s, 30a-b in the "
          f"ranks {p30['rank_s']:.1f} s, their checks here "
          f"{p30['checks_s']:.1f} s) [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 30: output-dimension and pipeline parallelism
# ---------------------------------------------------------------------------

SHARD_STEPS = 20            # 30a-b: eager steps on the placed models
PP_MICRO = 4                # 30b: microbatches of 250 rows
PP_STAGES = 2
PP_TICKS = PP_MICRO + PP_STAGES - 1
# the launches a rank makes, derived from the code: an evaluation of
# outdim_elbo runs each layer's fused forward once on the rank's dims and
# its Kuu gram twice (the conditional's Cholesky and the non-white KL's);
# a gradient adds each layer's fused backward.  pp_elbo runs, every tick,
# the stage's layers and the split-final head's conditional (a fused
# forward and a Kuu gram each), then one Kuu gram for each KL (the
# stage's layers, the head)
OUTDIM_PER = {"eval": {"fused_conditional": 2, "rbf_gram": 4},
              "grad": {"fused_conditional_backward": 2}}
PP_LOCAL = (LAYERS - 1) // PP_STAGES
PP_PER = {"eval": {"fused_conditional": PP_TICKS * (PP_LOCAL + 1),
                   "rbf_gram": PP_TICKS * (PP_LOCAL + 1) + PP_LOCAL + 1},
          "grad": {"fused_conditional_backward": PP_TICKS * (PP_LOCAL + 1)}}


def sharded_draws(seed, shapes, device="cuda"):
    """Fixed float32 unit normals of the given shapes."""
    g = torch.Generator(device=device).manual_seed(seed + 3000)
    return [torch.randn(sh, generator=g, device=device) for sh in shapes]


def sharded_mnist(seed, f64=True):
    """30a's model: mnist_DGP2 (784 -> 30 -> 10, MultiClass(10), M=100,
    S=1, use_pallas=True, float32), its q_mu moved off zero (at zero the
    first layer's q_mu gradient is zero, and float32 noise is all a gate
    would see), with ``f64`` a float64 copy of it on the plain route, and
    the fixed draws of a 1000-row batch."""
    data = mnist_data(seed)
    m32 = mnist_model(data, MNIST_MODELS["DGP2"], seed)
    rng = np.random.RandomState(seed + 30)
    for layer in m32.layers:
        layer.q_mu.set_value(rng.randn(*layer.q_mu.value.shape) * 0.5)
    out = {"m32": m32, "zs": sharded_draws(
        seed, [(1, BATCH, l.num_outputs) for l in m32.layers],
        m32.X_data.device)}
    if f64:
        out["m64"] = copy.deepcopy(m32).to(torch.float64)
        for layer in out["m64"].layers:
            layer.use_pallas = False
    return out


def pp_draws(seed, device="cuda"):
    """30b's fixed draws: the headline trunk's (4, S, 1000, 8), stacked."""
    return sharded_draws(seed + 1, [(LAYERS - 1, TRAIN_S, BATCH, 8)],
                         device)[0]


def mesh_kind():
    """The device type of a mesh of this process group's backend."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def one_rank_sharding(seed, mnist):
    """30c on the one-rank NCCL group: ``outdim_elbo`` over a dim axis of
    1 on the MNIST DGP and ``pp_elbo`` over 1 stage on the headline DGP
    (split-final head, one microbatch) against ``elbo`` on the same
    draws; raises unless bit for bit or within 1e-5 of scale, and prints
    which."""
    from torch.distributed.device_mesh import init_device_mesh
    from doubly_stochastic_dgp_tpu_torch.parallel import outdim as pod
    from doubly_stochastic_dgp_tpu_torch.parallel import pp as ppp
    out = {}
    m = mnist["m32"]
    head = build_model(seed, num_samples=TRAIN_S)[0]
    dev = head.X_data.device
    zs = pp_draws(seed, dev)
    zs_all = list(zs) + [torch.zeros((1, BATCH, 1), device=dev)]
    dim = init_device_mesh(mesh_kind(), (1,), mesh_dim_names=("dim",))
    stage = init_device_mesh(mesh_kind(), (1,), mesh_dim_names=("stage",))
    with torch.no_grad():
        for name, got, want in (
                ("outdim_elbo (dim 1), mnist_DGP2",
                 lambda: pod.outdim_elbo(m, m.X_data[:BATCH],
                                         m.Y_data[:BATCH], None, dim,
                                         zs=mnist["zs"]),
                 lambda: m.elbo(m.X_data[:BATCH], m.Y_data[:BATCH],
                                zs=mnist["zs"])),
                ("pp_elbo (1 stage, split-final head), headline",
                 lambda: ppp.pp_elbo(ppp.pp_stack(head, split_final=True),
                                     head.X_data[:BATCH],
                                     head.Y_data[:BATCH], None, stage,
                                     zs=zs),
                 lambda: head.elbo(head.X_data[:BATCH], head.Y_data[:BATCH],
                                   zs=zs_all))):
            g, w = got(), want()
            torch.cuda.synchronize()
            same = torch.equal(g, w)
            rel = float(abs(g - w) / abs(w))
            print(f"30c {name} on the one-rank NCCL group: {float(g):.6f} "
                  f"vs elbo {float(w):.6f} on the same draws: "
                  f"{'bit for bit' if same else f'|d| {rel:.3e} of scale'}",
                  flush=True)
            check(same or rel <= DP_GATE,
                  f"30c {name}: {float(g)} vs elbo {float(w)}")
            out[name] = {"value": float(g), "elbo": float(w),
                         "bit_for_bit": same, "rel": rel}
    return out


def sharded_rank(model, elbo, elbo_data, place, make_step, mesh, axis, seed,
                 zs):
    """One of 30a-b on this rank, with the launch counts at 0 just before:
    ``elbo(m, X, Y, zs)`` of the whole model on a 1000-row batch at fixed
    draws and its gradient under the gradient rule, ``elbo_data`` (the
    same objective on a data x ... mesh, the value), the placed model's
    objective as its steps differentiate it (``log_prior_sharded`` plus
    ``elbo`` of ``place(model)``, its sharded leaves along ``axis`` this
    rank's own) at the same draws and its gradient, then SHARD_STEPS
    eager steps of ``make_step(optimizer)`` on the placed model; the
    counts just after.  Then, uncounted, the kernels' operands of one
    evaluation (for the holds in the main process)."""
    from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pmesh
    from doubly_stochastic_dgp_tpu_torch.models import layers
    from doubly_stochastic_dgp_tpu_torch.ops import kernels
    from doubly_stochastic_dgp_tpu_torch.parallel import dp as pdp
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    X, Y = model.X_data[:BATCH], model.Y_data[:BATCH]
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    params = [p for p in model.parameters() if p.requires_grad]
    value, grads = pdp.dp_value_and_grads(lambda: elbo(model, X, Y, zs),
                                          params, mesh)
    res = {"value": float(value),
           "grads": dict(zip(trainable_names(model), map(host, grads)))}
    with torch.no_grad():
        res["data_axis"] = float(elbo_data(model, X, Y, zs))
    placed = place(model)
    whole = dict(model.named_parameters())
    local = {n: p for n, p in placed.named_parameters()
             if p.shape != whole[n].shape}
    res["bytes"] = {n: (p.numel() * p.element_size(),
                        whole[n].numel() * whole[n].element_size())
                    for n, p in local.items()}
    # each sharded leaf's block of the whole leaf: (dim, start, size)
    at = pmesh.axis_index(mesh, axis)
    res["blocks"] = {}
    for n, p in local.items():
        d = next(i for i in range(p.ndim) if p.shape[i] != whole[n].shape[i])
        res["blocks"][n] = (d, at * p.shape[d], p.shape[d])
    shards = list(local.values())
    pvalue, pgrads = pdp.dp_value_and_grads(
        lambda: pdp.log_prior_sharded(placed, shards, mesh, axis)
        + elbo(placed, X, Y, zs),
        [p for p in placed.parameters() if p.requires_grad], mesh,
        local=shards)
    res["placed_value"] = float(pvalue)
    res["placed_grads"] = dict(zip(trainable_names(placed),
                                   map(host, pgrads)))
    step = make_step(masked_optimizer(placed, 0.01))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["losses"] = [float(step(placed, X, Y, seed=seed + i))
                     for i in range(SHARD_STEPS)]
    torch.cuda.synchronize()
    res["steps_per_s"] = SHARD_STEPS / (time.perf_counter() - t0)
    res["counts"] = launch_counts()
    res["replicated"] = {n: host(p) for n, p in placed.named_parameters()
                         if n not in local}

    def cpu(args):
        # numpy: a tensor sent through the ranks' queue is shared memory,
        # gone with the rank
        return [host_keep(a) if torch.is_tensor(a) else a for a in args]

    run = lambda: elbo(model, X, Y, zs)                       # noqa: E731
    res["fused"] = [cpu(a) for a in captured_calls(run, layers,
                                                   "fused_conditional")]
    res["grams"] = [cpu(a) for a in captured_calls(run, kernels, "rbf_gram")]
    return res


def sharded_ranks(seed):
    """30a and 30b on one of 29b's two gloo ranks (run by ``dp_rank``):
    30a outdim on mnist_DGP2 over a dim axis of 2 (and a data 1 x dim 2
    mesh), 30b pp on the headline DGP over 2 stages (split-final head,
    4 microbatches; and a data 1 x stage 2 mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    from doubly_stochastic_dgp_tpu_torch.parallel import outdim as pod
    from doubly_stochastic_dgp_tpu_torch.parallel import pp as ppp
    t0 = time.perf_counter()
    dim = init_device_mesh("cpu", (2,), mesh_dim_names=("dim",))
    dd = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "dim"))
    stage = init_device_mesh("cpu", (PP_STAGES,), mesh_dim_names=("stage",))
    ds = init_device_mesh("cpu", (1, PP_STAGES),
                          mesh_dim_names=("data", "stage"))
    mnist = sharded_mnist(seed, f64=False)
    out = {"30a": sharded_rank(
        mnist["m32"],
        lambda m, X, Y, z: pod.outdim_elbo(m, X, Y, None, dim, zs=z),
        lambda m, X, Y, z: pod.elbo_2d(m, X, Y, None, dd, zs=z),
        lambda m: pod.outdim_shard(m, dim),
        lambda opt: pod.make_outdim_train_step(opt, dim), dim, "dim", seed,
        mnist["zs"])}
    del mnist
    headline = build_model(seed, num_samples=TRAIN_S)[0]
    stacked = ppp.pp_stack(headline, split_final=True)
    out["30b"] = sharded_rank(
        stacked,
        lambda m, X, Y, z: ppp.pp_elbo(m, X, Y, None, stage, n_micro=PP_MICRO,
                                       zs=z),
        lambda m, X, Y, z: ppp.pp_elbo(m, X, Y, None, ds, n_micro=PP_MICRO,
                                       data_axis="data", zs=z),
        lambda m: ppp.pp_shard(m, stage),
        lambda opt: ppp.make_pp_train_step(opt, stage, n_micro=PP_MICRO),
        stage, "stage", seed, pp_draws(seed, headline.X_data.device))
    torch.cuda.synchronize()
    out["rank_s"] = time.perf_counter() - t0
    return out


def expected_counts(per, evals, grads):
    return {n: evals * per["eval"].get(n, 0) + grads * per["grad"].get(n, 0)
            for n in KERNEL_NAMES}


def stacked_name(name):
    """The single-process names of a pp-stacked model's parameter: the
    trunk's L - 1 layers' (stacked) or the head's."""
    if name.startswith("layers.0."):
        rest = name.split(".", 2)[2]
        return [f"layers.{i}.{rest}" for i in range(LAYERS - 1)]
    if name.startswith("layers.1."):
        return [f"layers.{LAYERS - 1}.{name.split('.', 2)[2]}"]
    return [name]


def check_sharded(seed, card, a, b, mnist, headline):
    """Phase 30's checks on the two ranks' results (``sharded_ranks``):
    the ranks bit for bit; 30a's outdim_elbo and 30b's pp_elbo and their
    gradients, and the data x ... values, against this process's float32
    ``elbo`` on the same draws and route (dp_gate: 1e-5 of scale, or 2x
    its float32 error against float64); the placed model's objective
    (log prior and bound) against ``log_prior`` plus ``elbo``, and its
    gradients, each rank's sharded leaves against their block of the
    whole gradient, under the same gate; the losses of the steps finite
    and falling; each rank's sharded leaves half the whole model's bytes;
    the launch counts as derived; the kernels on the ranks' operands
    under phase 1's gates."""
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        value_and_grads)
    from doubly_stochastic_dgp_tpu_torch.utils.params import log_prior
    m32, m64 = headline
    dev = m32.X_data.device
    zs = pp_draws(seed, dev)
    cases = {
        "30a": ("outdim, mnist_DGP2 over a dim axis of 2",
                (mnist["m32"], mnist["m64"]), mnist["zs"],
                lambda n: [n], OUTDIM_PER,
                [(BATCH, MNIST_D, 15), (BATCH, 30, 5)]),
        "30b": (f"pp, headline over {PP_STAGES} stages ({PP_MICRO} "
                f"microbatches, split-final head)", (m32, m64),
                list(zs) + [torch.zeros((1, BATCH, 1), device=dev)],
                stacked_name, PP_PER,
                ([(TRAIN_S * BATCH // PP_MICRO, 8, 8)] * PP_LOCAL
                 + [(TRAIN_S * BATCH // PP_MICRO, 8, 1)]) * PP_TICKS),
    }
    out = {"rank_s": max(a["rank_s"], b["rank_s"])}
    worst = kernel_worst()
    for key, (what, models, draws, names, per, shapes) in cases.items():
        ra, rb = a[key], b[key]
        for k in ("value", "grads", "data_axis", "placed_value", "losses",
                  "replicated"):
            check(pickle_equal(ra[k], rb[k]), f"{key} {k}: the two ranks "
                                              f"disagree")
        check(pickle_equal(
            *({n: g for n, g in r["placed_grads"].items()
               if n not in r["blocks"]} for r in (ra, rb))),
            f"{key} placed: the replicated leaves' gradients disagree")
        refs, priors = {}, {}
        for label, m in zip(("f32", "f64"), models):
            dt = m.X_data.dtype
            params = [p for p in m.parameters() if p.requires_grad]
            v, g = value_and_grads(lambda: m.elbo(
                m.X_data[:BATCH], m.Y_data[:BATCH],
                zs=[z.to(dt) for z in draws]), params)
            refs[label] = (float(v), dict(zip(trainable_names(m),
                                              map(host, g))))
            # the log prior and its gradient (zeros where no Param of the
            # model carries a prior: a constant, with no graph)
            with torch.enable_grad():
                lp = log_prior(m)
            g = (torch.autograd.grad(lp, params, allow_unused=True)
                 if lp.requires_grad else [None] * len(params))
            priors[label] = (float(lp), {
                n: np.zeros(tuple(p.shape)) if gi is None else host(gi)
                for n, p, gi in zip(trainable_names(m), params, g)})

        def whole(refs, name):
            """The one-process gradient of a (possibly stacked) leaf."""
            got = [refs[n] for n in names(name)]
            return np.stack(got) if len(got) > 1 else got[0]
        err, allow = dp_gate(f"{key} value", ra["value"], refs["f32"][0],
                             refs["f64"][0])
        derr, dallow = dp_gate(f"{key} data x ... mesh value",
                               ra["data_axis"], refs["f32"][0],
                               refs["f64"][0])
        gerr = []
        for name, g in ra["grads"].items():
            s32, s64 = (whole(r[1], name) for r in (refs["f32"],
                                                     refs["f64"]))
            gerr.append((name,) + dp_gate(f"{key} gradient {name}", g, s32,
                                          s64))
        gw = max(gerr, key=lambda e: e[1] / e[2])
        # the placed model: log prior plus bound, sharded leaves' blocks
        perr, pallow = dp_gate(
            f"{key} placed value", ra["placed_value"],
            *(refs[k][0] + priors[k][0] for k in ("f32", "f64")))
        pgerr = []
        for r, res in enumerate((ra, rb)):
            for name, g in res["placed_grads"].items():
                s32, s64 = (whole(refs[k][1], name)
                            + whole(priors[k][1], name)
                            for k in ("f32", "f64"))
                if name in res["blocks"]:
                    d, start, size = res["blocks"][name]
                    s32, s64 = (np.take(a, range(start, start + size),
                                        axis=d) for a in (s32, s64))
                pgerr.append((f"{name} rank {r}",) + dp_gate(
                    f"{key} placed gradient {name} rank {r}", g, s32, s64))
        pgw = max(pgerr, key=lambda e: e[1] / e[2])
        print(f"{key} {what}: {ra['value']:.6f} vs one process float32 "
              f"{refs['f32'][0]:.6f} (float64 {refs['f64'][0]:.6f}): |d| "
              f"{err:.3e} (allowed {allow:.3e}); on the data 1 x ... mesh "
              f"|d| {derr:.3e}; gradients ({len(gerr)} tensors) worst "
              f"{gw[1]:.3e} of allowed {gw[2]:.3e} ({gw[0]}); ranks bit for "
              f"bit True [{card}]", flush=True)
        print(f"{key} placed model (log prior + bound): "
              f"{ra['placed_value']:.6f} vs one process float32 "
              f"{refs['f32'][0] + priors['f32'][0]:.6f}: |d| {perr:.3e} "
              f"(allowed {pallow:.3e}); gradients ({len(pgerr)} tensors over "
              f"both ranks, sharded leaves against their block) worst "
              f"{pgw[1]:.3e} of allowed {pgw[2]:.3e} ({pgw[0]}) [{card}]",
              flush=True)
        losses = ra["losses"]
        print(f"{key} {SHARD_STEPS} eager steps on the placed model, fixed "
              f"batch of {BATCH}: {ra['steps_per_s']:.2f} / "
              f"{rb['steps_per_s']:.2f} steps/s (rank 0 / 1); losses "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}; replicated leaves bit "
              f"for bit across the ranks True [{card}]", flush=True)
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{key}: the loss did not fall: {losses}")
        for r, res in enumerate((ra, rb)):
            for name, (got, whole) in res["bytes"].items():
                check(2 * got == whole, f"{key} rank {r}: {name} holds "
                                        f"{got} of {whole} bytes")
        share = {r: sum(g for g, _ in res["bytes"].values())
                 for r, res in enumerate((ra, rb))}
        total = sum(w for _, w in ra["bytes"].values())
        print(f"{key} placed: each rank holds {share[0]} / {share[1]} of "
              f"the sharded leaves' {total} bytes ({len(ra['bytes'])} "
              f"leaves, each half: {sorted(ra['bytes'])})", flush=True)
        evals, grads = 3 + SHARD_STEPS, 2 + SHARD_STEPS
        want = expected_counts(per, evals, grads)
        for r, res in enumerate((ra, rb)):
            check(res["counts"] == want,
                  f"{key} rank {r}: launches {res['counts']}, derived "
                  f"{want}")
        print(f"{key} launches a rank (counters, {evals} evaluations, "
              f"{grads} gradients): {ra['counts']} = derived {per} each",
              flush=True)
        for r, res in enumerate((ra, rb)):
            fused = [[torch.as_tensor(t, device=dev)
                      if isinstance(t, np.ndarray) else t for t in args]
                     for args in res["fused"]]
            grams = [[torch.as_tensor(t, device=dev) for t in args]
                     for args in res["grams"]]
            got, _ = hold_operands(f"{key} rank {r}", fused, grams,
                                   seed + r, worst)
            check(got == shapes, f"{key} rank {r}: fused calls at (B, Dx, "
                                 f"Do) {got}, expected {shapes}")
        out[key] = {"value": ra["value"], "f32": refs["f32"][0],
                    "f64": refs["f64"][0], "err": err, "allowed": allow,
                    "data_axis_err": derr, "grad_worst": gw[1:],
                    "placed_err": perr, "placed_allowed": pallow,
                    "placed_grad_worst": pgw[1:],
                    "losses": losses, "steps_per_s": [ra["steps_per_s"],
                                                      rb["steps_per_s"]],
                    "launches": {n: ra["counts"][n] + rb["counts"][n]
                                 for n in KERNEL_NAMES},
                    "rank_bytes": share[0], "sharded_bytes": total}
    out["kernel_errs"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 31: the torch demos (demos_torch/) and with_config on the card
# ---------------------------------------------------------------------------

# rbf_gram launches a non-white SVGP layer a step on the solve and inverse
# routes (Kuu, Kuf, the KL's Kuu), and a layer a prediction (Kuu, Kuf)
DEMO_GRAMS_STEP, DEMO_GRAMS_PREDICT = 3, 2
# 31b: the served request and the copy's graphed steps (40: room for the
# profiler's retries on the chunks after the first two)
WITH_CONFIG_ROWS, WITH_CONFIG_STEPS = 1000, 40


def demo_runs(results):
    """(label, demo module name, argv) of 31a, all on the card."""
    return [
        # the reference harness at full width: 5 layers, M=100, S=1,
        # minibatch 10000 (the whole 7372-row training split); cut to 100
        # iterations
        ("run_regression", "run_regression",
         ["kin8nm", "5", "0", "--synthetic", "--iterations", "100",
          "--log-every", "50", "--results", results]),
        # 784 -> 30 -> 10, M=100, minibatch 1000; 200 iterations, so that
        # the history (a log every 100) shows the loss fall
        ("mnist", "mnist", ["--synthetic", "--layers", "2",
                            "--iterations", "200"]),
        ("mnist --data-parallel", "mnist",
         ["--synthetic", "--layers", "2", "--iterations", "200",
          "--data-parallel"]),
        ("damianou", "damianou", ["--n", "1500", "--dims", "4",
                                  "--inducing", "50", "--iterations", "100"]),
        # tests/test_demos.py's arguments, with the iterations raised where
        # one log event would not show the loss fall
        ("step_function", "step_function",
         ["--iterations", "200", "--num-samples", "5"]),
        ("priors", "priors", ["--frames", "2"]),
        ("natural_gradients", "natural_gradients", ["--iterations", "100"]),
        ("sgpmc", "sgpmc", ["--num-data", "30", "--num-inducing", "8",
                            "--num-samples", "60", "--num-burn", "40"]),
        ("sgpmc nuts", "sgpmc",
         ["--sampler", "nuts", "--max-depth", "5", "--num-data", "30",
          "--num-inducing", "8", "--num-samples", "60", "--num-burn", "40"]),
        ("serving", "serving", ["--num-data", "60", "--iterations", "30",
                                "--batch", "16", "--num-samples", "3"]),
        # not in tests/test_demos.py: small sizes of their own
        ("uci_benchmark", "uci_benchmark",
         ["--iterations", "400", "--max-layers", "2", "--num-inducing",
          "50", "--eval-samples", "10"]),
        ("collapsed", "collapsed", ["--iterations", "50"]),
    ]


def demo_expected(label, args):
    """The launches the code gives a demo's run, {record: count}, every
    record not named 0; a record at None is gated at one launch or more
    (a run whose count depends on the data: L-BFGS's evaluations, the
    samplers' trees, torch.export's trace).  ``fit`` counts its warm-up
    and capture chunks (FIT_CAPTURE_CHUNKS of min(10, log_every) steps);
    an eager loop counts every step."""
    step, pred = DEMO_GRAMS_STEP, DEMO_GRAMS_PREDICT
    if label == "run_regression":
        L = args.L
        evals = args.iterations // args.log_every + 1   # callbacks, final
        return {"rbf_gram": FIT_CAPTURE_CHUNKS * min(10, args.log_every)
                * step * L + evals * pred * L}
    if label.startswith("mnist"):       # one 1000-row batch at S=100
        L = args.layers
        return {"rbf_gram": FIT_CAPTURE_CHUNKS * 10 * step * L + pred * L}
    if label == "step_function":        # predict_all_layers once
        L = args.layers
        return {"rbf_gram": FIT_CAPTURE_CHUNKS * 10 * step * L + pred * L}
    if label == "natural_gradients":
        # Adam alone, then NatGrad + Adam: two objective evaluations a step
        return {"rbf_gram": FIT_CAPTURE_CHUNKS * 10 * step * 2
                + FIT_CAPTURE_CHUNKS * 10 * 2 * step * 2}
    if label == "priors":
        # full covariances: Kuu, Kuf and K(X) a layer a frame
        return {"rbf_gram": args.frames * 3 * args.layers}
    if label == "damianou":
        i = args.iterations
        # an eager step each: the 1-layer collapsed SGPR bound (Kuu and
        # the psi2 pair: a DGPCollapsed of one layer gives its layer
        # Gaussian inputs of zero variance), the Damianou bound (layer 0:
        # Kuu, Kuf; layer 1: Kuu and the psi2 pair), the 2-layer MC DGP
        # (3 a layer); then one 166-row prediction each: the SGPR two (Kuu,
        # K(Z, Xs)) and a psi2 forward, Damianou 5 and a psi2 forward,
        # the MC DGP 2 a layer
        return {"rbf_gram": (i + 2) + (3 * i + 5) + (2 * step * i
                                                     + 2 * pred),
                "psi2_core_forward": 2 * (i + 1),
                "psi2_core_backward": 2 * i}
    return {"rbf_gram": None}


def demo_loss_runs(label, state):
    """The loss sequences of a demo that trains, in the order logged."""
    if label in ("priors", "sgpmc", "sgpmc nuts"):
        return {}
    if label == "natural_gradients":
        return {f"fit {i}": [h["loss"] for h in hist]
                for i, hist in enumerate(state["histories"])}
    if label in ("damianou", "uci_benchmark"):
        return dict(state["losses"])
    if label == "collapsed":
        return {"lbfgs": state["losses"]}
    return {"fit": [h["loss"] for h in state["history"]]}


def phase_demos(card):
    """31a: every torch demo in-process on the card, the launch counts at 0
    just before each run and read just after."""
    import importlib

    from demos_torch._common import numbers
    out, trained = {}, None
    mnist_data = None
    with tempfile.TemporaryDirectory() as results:
        for label, name, argv in demo_runs(results):
            mod = importlib.import_module(f"demos_torch.{name}")
            args = mod.parse_args(argv)
            set_launch_counts({n: 0 for n in KERNEL_NAMES})
            t0 = time.perf_counter()
            if name == "mnist":
                summary, state = mod.run(args, mnist_data)
                mnist_data = state["data"]
            else:
                summary, state = mod.run(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            bad = [x for x in numbers(summary) if not np.isfinite(x)]
            check(not bad, f"31a {label}: non-finite values in {summary}")
            losses = demo_loss_runs(label, state)
            for what, seq in losses.items():
                check(len(seq) >= 2 and np.all(np.isfinite(seq))
                      and seq[-1] < seq[0],
                      f"31a {label} {what}: the loss did not fall {seq}")
            want = demo_expected(label, args)
            for n in KERNEL_NAMES:
                w = want.get(n, 0)
                check(counts[n] >= 1 if w is None else counts[n] == w,
                      f"31a {label}: {n} launched {counts[n]} times, the "
                      f"code gives {'one or more' if w is None else w}")
            extra = ""
            if label == "serving":
                extra = (f"; the reloaded program against the model: bit "
                         f"for bit {state['model_bitwise']}, "
                         f"{state['model_rel_err']:.3e} of scale (gate "
                         f"{EXPORT_RTOL})")
                check(state["model_bitwise"]
                      or state["model_rel_err"] <= EXPORT_RTOL,
                      f"31a serving: the reloaded program differs from the "
                      f"model by {state['model_rel_err']}")
            if label == "collapsed":
                l0, l1 = state["losses"]
                bound = 0.05 * (l0 - l1)
                extra = (f"; identity gap {summary['identity_gap']:.4e} < "
                         f"{bound:.4e} = 0.05 (l0 - l1), float64 on the card")
                check(summary["identity_gap"] < bound,
                      f"31a collapsed: identity gap "
                      f"{summary['identity_gap']} >= 0.05 (l0 - l1) = "
                      f"{bound}")
                check(next(state["model"].parameters()).dtype
                      == torch.float64,
                      "31a collapsed: the model is not float64")
            print(f"31a demo {label} ({' '.join(argv)}): {wall:.1f} s wall; "
                  f"launches {counts}, derived "
                  f"{ {n: want.get(n, 0) for n in KERNEL_NAMES} } (None: "
                  f"one or more); losses "
                  f"{ {k: [round(v, 3) for v in (s[0], s[-1])] for k, s in losses.items()} }"
                  f"{extra}; summary {json.dumps(summary)[:300]} [{card}]",
                  flush=True)
            out[label] = {"wall_s": wall, "launches": counts,
                          "derived": want, "summary": summary}
            if label == "run_regression":
                trained = state["model"]
    return out, trained


def with_config_fit(label, model, seed, per_step, card):
    hist, counts, replay = run_fit(model, WITH_CONFIG_STEPS, seed)
    losses = [h["loss"] for h in hist]
    print(f"31b {label}: fit {WITH_CONFIG_STEPS} graphed steps, batch "
          f"{BATCH}: loss {losses[0]:.3f} -> {losses[-1]:.3f}; counters "
          f"(the warm-up and capture chunks) {counts}; a replayed chunk "
          f"(profiler) {replay} [{card}]", flush=True)
    check(all(np.isfinite(losses)), f"31b {label}: loss not finite")
    check_fit_launches(f"31b {label}", counts, replay, per_step)
    return {"losses": [losses[0], losses[-1]], "launches": counts,
            "replay": replay}


def phase_with_config(model, seed, card):
    """31b: with_config on 31a's trained 5-layer run_regression model
    (float32, solve_mode='inverse', use_pallas=False)."""
    from doubly_stochastic_dgp_tpu_torch import summary, with_config
    before = {n: t.clone() for n, t in model.state_dict().items()}
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X = torch.as_tensor(data["X"][:WITH_CONFIG_ROWS], dtype=torch.float32,
                        device="cuda")
    served = make_server(model, S=S, precompute=False,
                         warmup_batch=WITH_CONFIG_ROWS)
    first = served(X, seed=5)
    fused = with_config(model, use_pallas=True)
    check(all(l.use_pallas is True for l in fused.layers)
          and all(l.use_pallas is False for l in model.layers),
          "31b: with_config did not set use_pallas on the copy alone")

    g = torch.Generator(device="cuda").manual_seed(seed + 31)
    zs = [torch.randn((S, WITH_CONFIG_ROWS, layer.num_outputs),
                      generator=g, device="cuda") for layer in model.layers]
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    with torch.no_grad():
        want = ref.predict_y(X.cpu().double(), S=S,
                             zs=[z.cpu().double() for z in zs])
        errs, counts = {}, {}
        for name, m in (("with_config(use_pallas=True)", fused),
                        ("original", model)):
            set_launch_counts({n: 0 for n in KERNEL_NAMES})
            got = m.predict_y(X, S=S, zs=zs)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            errs[name] = max((a.cpu().double() - b).abs().max().item()
                             for a, b in zip(got, want))
            print(f"31b request {WITH_CONFIG_ROWS} rows S={S} through "
                  f"{name}, fixed draws: max |d| against the float64 CPU "
                  f"path {errs[name]:.3e} (gate {F32_PATH_ATOL}); launches "
                  f"{counts[name]} [{card}]", flush=True)
    copy_err, orig_err = errs["with_config(use_pallas=True)"], errs[
        "original"]
    check(copy_err <= F32_PATH_ATOL,
          f"31b: the copy's request is {copy_err} off float64")
    check(copy_err <= 2.0 * orig_err,
          f"31b: the copy's error {copy_err} is more than 2x the "
          f"original's {orig_err}")
    check(counts["with_config(use_pallas=True)"]["fused_conditional"]
          == LAYERS, f"31b: the copy's request launched "
          f"{counts['with_config(use_pallas=True)']} fused forwards, not "
          f"{LAYERS}")
    check(counts["original"]["fused_conditional"] == 0,
          "31b: the original's request launched the fused forward")

    fits = {"use_pallas=True": with_config_fit(
        "with_config(use_pallas=True)", fused, seed,
        {"fused_conditional": LAYERS, "fused_conditional_backward": LAYERS,
         "rbf_gram": 2 * LAYERS}, card)}
    saved = with_config(model, use_pallas="saved")
    fits["use_pallas='saved'"] = with_config_fit(
        "with_config(use_pallas='saved')", saved, seed,
        {"fused_conditional_saved": LAYERS,
         "fused_conditional_saved_backward": LAYERS,
         "rbf_gram": 2 * LAYERS}, card)
    same = all(torch.equal(t, before[n])
               for n, t in model.state_dict().items())
    again = served(X, seed=5)
    route = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"31b the original after its copies' steps: parameters and "
          f"buffers bit for bit {same}; its server (made before the copies) "
          f"repeats its answer bit for bit {route}", flush=True)
    check(same, "31b: training a with_config copy changed the original")
    check(route, "31b: the original's server changed its answer")
    print("31b summary of the trained card model:\n" + summary(model),
          flush=True)
    launches = {n: sum(f["launches"][n] for f in fits.values())
                + sum(c[n] for c in counts.values()) for n in KERNEL_NAMES}
    return {"request_err_vs_f64": errs, "request_launches": counts,
            "fits": fits, "original_unchanged": same,
            "launches": launches}


def phase_slice(seed, card):
    """Phase 31: 31a and 31b."""
    t0 = time.perf_counter()
    demos, trained = phase_demos(card)
    t1 = time.perf_counter()
    wc = phase_with_config(trained, seed, card)
    wall = time.perf_counter() - t0
    print(f"demo phase wall time {wall:.1f} s (31a {t1 - t0:.1f} s, 31b "
          f"{wall - (t1 - t0):.1f} s) [{card}]", flush=True)
    return {"demos": demos, "with_config": wc, "wall_s": wall}


def print_kernel_resources(name, out):
    """Registers, shared memory and spills of each kernel in one source,
    as ``nvcc -Xptxas -v`` reported them (one line a kernel); kept in
    PTXAS by kernel."""
    kernel = None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("spill" in line or "registers" in line):
            print(f"ptxas {name}.cu {kernel[:96]}: {line.strip()}",
                  flush=True)
            for key, pattern in (("registers", r"Used (\d+) registers"),
                                 ("spill bytes", r"(\d+) bytes spill stores")):
                found = re.search(pattern, line)
                if found:
                    PTXAS.setdefault(kernel, {})[key] = int(found.group(1))


def print_occupancy():
    """Resident blocks an SM of the fused conditional's kernels on this
    card, as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them for
    the launches at M=100 (the cells) and M=512 (the cap); then the psi2
    backward's and rbf_gram's (see print_psi2_backward_plans)."""
    fwd = build.load_library("fused_conditional")
    fwd.fused_conditional_fwd_occupancy.argtypes = [ctypes.c_int] * 3
    bwd = build.load_library("fused_conditional_bwd")
    bwd.fused_conditional_bwd_occupancy.argtypes = [ctypes.c_int] * 6
    for M_, Do in ((M, 8), (512, 2)):
        plan = backward_plan(TRAIN_S * BATCH, M_, 8, Do)
        tb = plan["tb"]
        occ = {"forward": fwd.fused_conditional_fwd_occupancy(M_, 0, 1),
               "forward saved": fwd.fused_conditional_fwd_occupancy(
                   M_, 1, 1),
               "backward rows": bwd.fused_conditional_bwd_occupancy(
                   0, M_, Do, 0, 0, 1),
               "backward rows saved": bwd.fused_conditional_bwd_occupancy(
                   1, M_, Do, 0, 0, 1),
               "backward reduction": bwd.fused_conditional_bwd_occupancy(
                   2, M_, Do, plan["reduce_threads"],
                   plan["reduce_smem_bytes"], 1)}
        print(f"occupancy M={M_} Do={Do}: resident blocks an SM "
              + ", ".join(f"{k} {v}" for k, v in occ.items())
              + f" (row kernels {tb} rows and 256 threads a block, no "
              f"cluster; reduction {plan['reduce_threads']} threads)",
              flush=True)
    print_row_plans(fwd, bwd)
    print_backward_passes(bwd)
    lib = build.load_library("rbf_gram")
    lib.rbf_gram_occupancy.argtypes = [ctypes.c_int] * 2
    print("occupancy rbf_gram D=8: resident blocks an SM float32 "
          f"{lib.rbf_gram_occupancy(0, 8)}, float64 "
          f"{lib.rbf_gram_occupancy(1, 8)} (128 threads a block)", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wide = {f"{n} x {m} D={d}": gram.launch_plan(n, m, d, sms)
            for n, m, d in ((M, M, MNIST_D), (BATCH, M, MNIST_D),
                            (M, M, 30), (BATCH, M, 30),
                            (S * BATCH, M, MNIST_D))}
    print("occupancy rbf_gram D=784: resident blocks an SM float32 "
          f"{lib.rbf_gram_occupancy(0, 784)}, float64 "
          f"{lib.rbf_gram_occupancy(1, 784)} (256 threads a block); plans "
          + "; ".join(f"{k}: {p['tiles']} tiles x {p['splits']} splits = "
                      f"{p['grid']} blocks"
                      for k, p in wide.items()), flush=True)
    print_psi2_backward_plans()
    print_psi2_forward_plans()


# (B, M, Dx, Do) of the backward's reduction-launch printout: the MNIST
# layers (0, hidden, last; layer 0 of the output-dimension rank) and the
# headline's training layer
BACKWARD_PASS_SHAPES = ((BATCH, M, 784, 30), (BATCH, M, 30, 30),
                        (BATCH, M, 30, 10), (BATCH, M, 784, 15),
                        (TRAIN_S * BATCH, M, 8, 8))


def ptxas_of(kernel, template):
    """ptxas's (registers, spill bytes) of a row kernel's instantiation
    (``template`` as its mangled name spells it, ILb0ELb1E for <false,
    true>), as print_kernel_resources kept them."""
    res = next((v for k, v in PTXAS.items()
                if kernel in k and template in k), {})
    return res.get("registers"), res.get("spill bytes")


def print_row_plans(fwd, bwd):
    """The row kernels' launch plans (conditional.forward_plan and
    backward_plan) at BACKWARD_PASS_SHAPES: rows a block, blocks of a
    cluster, blocks, the gram's tile rows, shared memory, resident blocks
    an SM of the instantiation the plan launches, and its ptxas registers
    and spills (raises if no block fits)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, M_, Dx, Do in BACKWARD_PASS_SHAPES:
        for name, saved in (("forward", False), ("forward saved", True),
                            ("backward rows", False),
                            ("backward rows saved", True)):
            if name.startswith("forward"):
                p = forward_plan(B, M_, Dx, Do, sms)
                occ = fwd.fused_conditional_fwd_occupancy(
                    M_, int(saved), p["cluster"])
                kernel = "fused_conditional_fwd_kernel"
            else:
                p = backward_plan(B, M_, Dx, Do, sms, saved=saved)
                occ = bwd.fused_conditional_bwd_occupancy(
                    int(saved), M_, Do, 0, 0, p["cluster"])
                kernel = "fused_conditional_bwd_rows_kernel"
            template = (f"ILb{int(saved)}ELb{int(p['cluster'] > 1)}E")
            regs, spill = ptxas_of(kernel, template)
            blocks = p["blocks"] if "blocks" in p else p["row_blocks"]
            print(f"row plan {name} B={B} M={M_} Dx={Dx} Do={Do}: "
                  f"{p['tb']} rows a block, clusters of {p['cluster']}, "
                  f"{blocks} blocks, gram tiles {p['gram_rows']} x 4, "
                  f"{p['smem_bytes'] / 1024:.1f} KB, resident blocks an SM "
                  f"{occ}; ptxas {regs} registers, {spill} B spilled",
                  flush=True)
            check(occ >= 1, f"{name} at B={B} M={M_} Dx={Dx} Do={Do}: no "
                            f"block fits an SM")


def print_backward_passes(bwd):
    """The backward's reduction launch at BACKWARD_PASS_SHAPES: its jobs
    (dX's tiles, or dX in the row pass; dZ's and dalpha's column-sum tiles;
    the product tiles), threads, shared memory and resident blocks an SM
    (raises if none fits), beside the kernel's registers and spills
    (ptxas)."""
    res = next((v for k, v in PTXAS.items()
                if "fused_conditional_bwd_reduce_kernel" in k), {})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, M_, Dx, Do in BACKWARD_PASS_SHAPES:
        p = backward_plan(B, M_, Dx, Do, sms)
        occ = bwd.fused_conditional_bwd_occupancy(
            2, M_, Do, p["reduce_threads"], p["reduce_smem_bytes"],
            p["cluster"])
        dx = ("in the row pass" if p["dx_in_rows"] else
              f"{p['dx_blocks']} tiles of {4 * p['dx_row_groups']} x "
              f"{4 * p['dx_col_groups']}")
        cols = 4 * p["sum_groups"]
        print(f"backward passes B={B} M={M_} Dx={Dx} Do={Do}: dX {dx}; dZ "
              f"{p['dz_blocks']} tiles of {cols} x {4 * p['dz_groups']}, "
              f"dalpha {p['dalpha_blocks']} of {cols} x "
              f"{4 * p['dalpha_groups']} ({p['nslices']} slices of "
              f"{p['rows_per_slice']} rows); product tiles "
              f"{p['product_blocks']}; reduction launch {p['reduce_blocks']} "
              f"blocks of {p['reduce_threads']} threads, "
              f"{p['reduce_smem_bytes'] / 1024:.1f} KB, resident blocks an "
              f"SM {occ}; ptxas {res.get('registers')} registers, "
              f"{res.get('spill bytes')} B spilled", flush=True)
        check(occ >= 1, f"backward reduction at B={B} M={M_} Dx={Dx} "
                        f"Do={Do}: no block fits an SM")


# registers and spills of each kernel, as ptxas reported them in the build
PTXAS = {}
# (N, M, D) of the psi2 forward's plan printout: both cells, phase 10's
# edges, the cap
PSI2_FWD_PLAN_SHAPES = ((7372, 256, 2), (1500, 100, 8), (300, 1, 2),
                        (700, 65, 2), (1, 100, 8), (33, 100, 8),
                        (2000, 512, 2), (500, 64, 12))


def print_psi2_forward_plans():
    """The psi2 forward's launch plan, symmetric and general, at both
    cells' shapes and phase 10's: micro-tiles, groups x chunks blocks,
    threads, the ring's stages and box, shared memory, scratch (also at
    1000 N), registers and spills (ptxas), resident blocks an SM (raises
    below 1)."""
    lib = build.load_library("psi2")
    lib.psi2_fwd_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int64]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N, M_, D in PSI2_FWD_PLAN_SHAPES:
        for sym in (True, False):
            p = psi2.forward_plan(N, M_, D, sms, sym)
            big = psi2.forward_plan(1000 * N, M_, D, sms, sym)
            occ = lib.psi2_fwd_occupancy(D, p["threads"], p["smem_bytes"])
            dt = D if D <= 4 else 0
            regs = [f"{v.get('registers')} registers, "
                    f"{v.get('spill bytes')} B spilled"
                    for k, v in PTXAS.items()
                    if f"psi2_fwd_kernelILi{dt}E" in k]
            print(f"psi2 forward plan N={N} M={M_} D={D} symmetric={sym}: "
                  f"{p['tiles']} micro-tiles in {p['groups']} groups of "
                  f"{32 * p['wt']} x {p['chunks']} chunks of "
                  f"{p['rows_per_chunk']} rows = {p['blocks']} blocks of "
                  f"{p['threads']} threads ({p['row_groups']} row groups), "
                  f"{p['stages']} stages of {p['rows_per_step']} rows x "
                  f"{p['box']} columns, {p['smem_bytes']} B shared memory; "
                  f"scratch {4 * p['scratch_floats']} B (at {1000 * N} rows "
                  f"{4 * big['scratch_floats']} B); ptxas "
                  f"{regs[0] if regs else 'not reported'}; resident blocks "
                  f"an SM {occ}", flush=True)
            check(occ >= 1, f"psi2 forward plan N={N} M={M_} D={D}: no "
                            f"block fits an SM")


# (N, M, D) of the psi2 backward's plan printout: both cells and the cap
PSI2_PLAN_SHAPES = ((7372, 256, 2), (1500, 100, 8), (2000, 512, 2))
PSI2_SCRATCH_MAX = 32_000_000      # bytes of gZ partials, whatever N


def print_psi2_backward_plans():
    """The psi2 backward's launch plan at both cells' shapes and at
    (2000, 512, 2): rows a chunk, chunks, blocks, shared memory, resident
    blocks an SM and the gZ scratch, also at 1000 N; raises if the scratch
    is above 32 MB."""
    lib = build.load_library("psi2_bwd")
    lib.psi2_bwd_occupancy.argtypes = [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for N, M_, D in PSI2_PLAN_SHAPES:
        plan = psi2.backward_plan(N, M_, D, sms)
        mb = 4 * plan["scratch_floats"] / 1e6
        big = 4 * psi2.backward_plan(1000 * N, M_, D, sms)[
            "scratch_floats"] / 1e6
        occ = lib.psi2_bwd_occupancy(M_, D, plan["rows_per_chunk"])
        print(f"psi2 backward plan N={N} M={M_} D={D}: {plan['chunks']} "
              f"chunks of {plan['rows_per_chunk']} rows on {plan['grid']} "
              f"blocks x {plan['groups']}, {plan['sub_tiles']} sub-tiles of "
              f"{16 * plan['a_per_thread']} x 64, "
              f"{plan['smem_bytes']} B shared memory a block, resident "
              f"blocks an SM {occ} (planned {plan['blocks_per_sm']}); gZ "
              f"scratch {mb:.3f} MB (at {1000 * N} rows: {big:.3f} MB)",
              flush=True)
        check(max(mb, big) * 1e6 <= PSI2_SCRATCH_MAX,
              f"psi2 backward scratch {max(mb, big)} MB above 32 MB")
        check(occ >= plan["blocks_per_sm"],
              f"psi2 backward: {occ} resident blocks an SM, planned "
              f"{plan['blocks_per_sm']}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"torch.backends.cuda.matmul.allow_tf32 = {tf32}", flush=True)
    check(tf32 is False, "TF32 matmuls are enabled")
    t0 = time.perf_counter()
    for name, out in build.build_all().items():
        print_kernel_resources(name, out)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    print_occupancy()

    def lap(phase):
        print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    errs, precision = phase_kernels(args.seed)
    lap(1)
    errs["rbf_gram"], gram_shapes = phase_gram_kernel(args.seed, card)
    lap(16)
    live, cached, requests, serving_launches = phase_serving(args.seed)
    serving_shapes, latency = phase_timings(args.seed, live, cached,
                                            requests, card)
    phase_profile(live, cached, requests)
    del live, cached
    lap("2-5")
    model, launches, grad_worst, metrics, same = phase_training(args.seed)
    train_shapes = phase_training_timings(args.seed, card)
    rates = phase_steps_per_s(args.seed, card)
    step = phase_training_profile(model, args.seed, card)
    del model
    lap("6-8")
    train_shapes["rbf_gram"] = gram_shapes
    solve_model, solve_data, solve, launches["rbf_gram"] = phase_solve_dgp(
        args.seed, card)
    lap(17)
    solve["steps_per_s"], solve["step"], inverse_step = phase_solve_timings(
        solve_model, args.seed, card)
    busy = {"use_pallas=True": step.get("busy_ms"),
            "use_pallas=False": inverse_step.get("busy_ms"),
            "solve_mode='solve'": solve["step"].get("busy_ms")}
    print("device busy a training step by route (torch.profiler, mean of "
          "5): " + ", ".join(f"{r} {b if b is None else round(b, 3)} ms"
                            for r, b in busy.items())
          + f" [{card}]", flush=True)
    lap(18)
    full_cov = phase_full_cov(solve_model, solve_data, args.seed, card)
    del solve_model
    lap(19)
    collapsed = phase_collapsed(args.seed, card)
    errs["psi2_core_forward"] = phase_psi2_kernel(args.seed,
                                                  collapsed["operands"])
    psi2_shapes, collapsed_paths = phase_collapsed_timings(collapsed, card)
    lap("9-11")
    f64_route = phase_f64_route(collapsed, args.seed, card)
    lap(24)
    train_shapes["psi2_core_forward"] = psi2_shapes
    launches["psi2_core_forward"] = collapsed["main_counts"][
        "psi2_core_forward"]
    errs["psi2_core_backward"] = phase_psi2_backward_kernel(
        args.seed, collapsed["operands"])
    collapsed_grads = phase_collapsed_gradient(collapsed, card)
    collapsed_fits, fit_counts = phase_collapsed_training(collapsed,
                                                          args.seed, card)
    train_shapes["psi2_core_backward"] = phase_psi2_backward_timings(
        collapsed, card)
    collapsed_steps = phase_collapsed_step_profile(collapsed, args.seed, card)
    lap("12-15")
    launches["psi2_core_backward"] = sum(
        c["psi2_core_backward"] for c in fit_counts.values())
    cholesky = phase_cholesky_rungs(args.seed, card)
    graphs = phase_graphs(args.seed, collapsed["build"], card)
    lap(20)
    guard_nan = phase_guard_nan(args.seed, card)
    lap(21)
    graph_serving = phase_graph_serving(args.seed, card)
    lap(22)
    resume = phase_resume(args.seed, card)
    lap(23)
    mnist, mnist_errs, mnist_shapes = phase_mnist(args.seed, card)
    lap(25)
    extra = phase_extra(args.seed, card)
    lap(26)
    natgrad = phase_natgrad_baselines(args.seed, card, collapsed)
    lap(27)
    mcmc = phase_mcmc(args.seed, card)
    lap(28)
    parallel = phase_parallel(args.seed, card)
    lap("29-30")
    demos = phase_slice(args.seed, card)
    lap(31)
    parallel_launches = {
        "fit_dp_nccl": parallel["nccl"]["launches"],
        "gloo_ranks": parallel["gloo"]["launches_29b"],
        "sample_axis": parallel["gloo"]["launches_29c"],
        "outdim_mnist": parallel["gloo"]["30"]["30a"]["launches"],
        "pp_headline": parallel["gloo"]["30"]["30b"]["launches"]}
    mcmc_launches = {
        "sgpmc_headline": mcmc["sgpmc_headline"]["launches_main_path"],
        "closed_form_hmc": mcmc["closed_form"]["hmc"]["launches"],
        "closed_form_nuts": mcmc["closed_form"]["nuts"]["launches"],
        "heinonen": mcmc["heinonen"]["launches_main_path"],
        "dynamic": mcmc["dynamic"]["launches_main_path"]}
    natgrad_launches = {
        "natgrad_fit": natgrad["natgrad"]["launches_fit"],
        "gamma1": natgrad["gamma1"]["launches_main_path"],
        "baselines": natgrad["baselines"]["launches_main_path"],
        "serving": natgrad["serving"]["launches_main_path"]}
    extra_launches = {
        label: {n: rec["launches_main_path"][n] for n in KERNEL_NAMES}
        for label, rec in extra.items() if label != "wall_s"}
    # phase 26: the worst errors of the kernels on its models' operands
    extra_errs = {}
    for label, rec in extra.items():
        for n, e in (rec.get("kernel_errs", {}) if label != "wall_s"
                     else {}).items():
            extra_errs[n] = list(map(max, extra_errs.get(n, [0.0] * 4), e))

    records = []
    for name, src, replaces, _, _ in KERNELS:
        main_shape = train_shapes[name][0]
        abs_err, rel, rel_k, rel_p = errs[name]
        rec = {
            "name": name, "route": "cuda",
            "source": f"doubly_stochastic_dgp_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": abs_err,
            "max_rel_err": rel, "max_rel_err_vs_f64": rel_k,
            "plain_max_rel_err_vs_f64": rel_p,
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "device_ms": main_shape["device_ms"],
            "gemm_yardstick_ms": main_shape["gemm_yardstick_ms"],
            "shapes": train_shapes[name],
        }
        if name == "fused_conditional":
            rec["serving_launches"] = serving_launches
            rec["serving_shapes"] = serving_shapes
        if name in mnist_shapes:
            # phase 25: the MNIST DGPs' shapes and main-path launches
            rec["mnist_shapes"] = mnist_shapes[name]
            rec["mnist_launches"] = {
                label: mnist[label]["launches_main_path"][name]
                for label in MNIST_MODELS}
            rec["mnist_max_rel_err"] = mnist_errs[name][1]
            rec["mnist_max_rel_err_vs_f64"] = mnist_errs[name][2]
            rec["mnist_plain_max_rel_err_vs_f64"] = mnist_errs[name][3]
        # phase 26: each model's main-path launches
        rec["extra_launches"] = {label: c[name]
                                 for label, c in extra_launches.items()}
        # phase 27: each sub-phase's main-path launches
        rec["natgrad_launches"] = {label: c[name]
                                   for label, c in natgrad_launches.items()}
        if name in natgrad["kernel_errs"]:
            # phase 27: the worst errors on its models' operands
            ng_errs = natgrad["kernel_errs"][name]
            rec["natgrad_max_rel_err"] = ng_errs[1]
            rec["natgrad_max_rel_err_vs_f64"] = ng_errs[2]
            rec["natgrad_plain_max_rel_err_vs_f64"] = ng_errs[3]
        # phase 28: each sub-phase's main-path launches
        rec["mcmc_launches"] = {label: c[name]
                                for label, c in mcmc_launches.items()}
        # phase 29: each sub-phase's main-path launches
        rec["parallel_launches"] = {label: c[name] for label, c in
                                    parallel_launches.items()}
        # phase 31: each demo's launches, and with_config's (31b)
        rec["demo_launches"] = {label: d["launches"][name] for label, d in
                                demos["demos"].items()}
        rec["with_config_launches"] = demos["with_config"]["launches"][name]
        if name in parallel["gloo"]["30"]["kernel_errs"]:
            # phase 30: the worst errors on the ranks' operands
            p_errs = parallel["gloo"]["30"]["kernel_errs"][name]
            rec["parallel_max_rel_err"] = p_errs[1]
            rec["parallel_max_rel_err_vs_f64"] = p_errs[2]
            rec["parallel_plain_max_rel_err_vs_f64"] = p_errs[3]
        if name in mcmc["kernel_errs"]:
            mc_errs = mcmc["kernel_errs"][name]
            rec["mcmc_max_rel_err"] = mc_errs[1]
            rec["mcmc_max_rel_err_vs_f64"] = mc_errs[2]
            rec["mcmc_plain_max_rel_err_vs_f64"] = mc_errs[3]
        if name in extra_errs:
            rec["extra_max_rel_err"] = extra_errs[name][1]
            rec["extra_max_rel_err_vs_f64"] = extra_errs[name][2]
            rec["extra_plain_max_rel_err_vs_f64"] = extra_errs[name][3]
        records.append(rec)
    print(json.dumps({"serving_request_ms": latency,
                      "training_steps_per_s": rates,
                      "training_step": step,
                      "training_step_inverse_route": inverse_step,
                      "training_grad_rel_err": grad_worst,
                      "test_metrics": metrics,
                      "fit_bit_identical": same,
                      "collapsed": {n: collapsed[n] for n in COLLAPSED},
                      "collapsed_launches_per_call": collapsed["launches"],
                      "collapsed_paths": collapsed_paths,
                      "collapsed_f64_route": f64_route,
                      "collapsed_grad_rel_err": collapsed_grads,
                      "collapsed_fits": collapsed_fits,
                      "collapsed_fit_launches": fit_counts,
                      "collapsed_training_step": collapsed_steps,
                      "solve_route": solve, "full_cov": full_cov,
                      "cholesky_rungs": cholesky, "graphs": graphs,
                      "graph_guard_nan": guard_nan,
                      "graph_serving": graph_serving,
                      "checkpoint_resume": resume,
                      "mnist": mnist, "extra_models": extra,
                      "natgrad_baselines": natgrad,
                      "mcmc": mcmc, "parallel": parallel,
                      "demos": {label: {"wall_s": d["wall_s"],
                                        "summary": d["summary"]}
                                for label, d in demos["demos"].items()},
                      "with_config": {k: v for k, v in
                                      demos["with_config"].items()
                                      if k != "launches"},
                      "demo_phase_wall_s": demos["wall_s"],
                      "fused_forward_precision": precision,
                      "card": card}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
