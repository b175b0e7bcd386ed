#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ptx_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``ptx_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the main paths
give it, drives every path through the entry points a user calls (the CLI
render, ``make_train_step``) at full size with exact launch counts, and
checks the results.  Any failed phase raises: the exit code is nonzero and
no result line is printed.  Without CUDA it exits 1 before doing anything.
Each phase prints its seconds.

Phases on the demo (K1, K2, K3; each raises on failure, none is caught):
1. device: name, and power limit as ``nvidia-smi`` reports it;
2. build: nvcc on every source in parallel, timed;
3. K1 vs plain, at every shape the main paths give K1: (a) three
   chained bounces of 65,536 primary rays (a 128-row band of the 512×512
   demo camera), each on the kernel's own carry; (b) the first chunk of
   the render's bands at rows 0 and 256 as the render runs them
   (``render_rows``, 65,536 rays at depth 16, compacted to 21,845 lanes
   from bounce 2 and to 4,096 from bounce 6), each of the 17 recorded
   kernel inputs fed to ``bounce_reference``.  Decisions must be equal
   except flips a float64 recompute puts at a near-tie; floats must agree
   within ``rtol 1e-5, atol 5e-6`` on agreeing lanes;
4. render slice: ``python -m ptx_torch render --demo demo --width 512
   --height 512 --spp 16 --depth 16`` through ``ptx_torch.cli.main``, with
   the launch counters zeroed just before; then a 16-row band at spp 2
   rendered with the kernel and with the plain bounce on the card, equal
   within ``rtol 1e-4, atol 1e-5`` except pixels whose paths hold an
   adjudicated flip;
5. K2 and K3 vs plain, on the inputs a render chunk gives them: forward +
   backward of ``radiance.sum()`` over the first 65,536-ray chunk of band
   256 (widths 65,536, 21,845 and 4,096, filler lanes included), every
   backward bounce's carry, decisions and cotangents recorded and fed to
   K2 and to its plain versions, every sky-select histogram's inputs to K3
   and ``hist_reference``; then K8 on a 512×1024×4 image (past K3's shared
   memory).  Tolerances: K2 per lane within ``rtol 1e-5, atol
   1e-6`` of the plain value, or within twice the plain value's error
   against a float64 recompute plus 1e-4 relative (the hand adjoint orders
   its float32 operations unlike autograd, and near-grazing lanes are
   ill-conditioned); ``d_packed`` (the cotangent of K2's scene vector)
   against the per-leaf sums folded onto the materials, the float64 fold
   as truth, at the scale of the folded sums of |term|; two launches the
   same bits; ``d_params`` (``d_packed`` through the packing's VJP) within
   1e-4 of each tensor's largest entry, or within twice the plain value's
   error against the float64 sums mapped to the params.  K3 and K8
   against ``hist_reference`` run in float64: every texel within
   ``min(2·n·2⁻²⁴, HIST_REL)·Σ|ct|``, n its lanes with a nonzero ct (float
   atomics add in a varying order; K7's rule), the largest
   ``|k − p| / Σ|ct|`` logged;
6. gradients, kernel path against plain path on the card: a 32-row band at
   spp 2 (32,768 rays, compaction on), depth 16, the gradient of the mean
   radiance with respect to every param tensor, the sky image included,
   within 1e-4 of each tensor's largest entry;
7. training slice: ``make_train_step`` on the demo at 512×512, spp 16,
   depth 16 (one 4,194,304-ray wavefront per step), target the port's
   render of the true params under another key, start from sphere radii
   ×1.05 and const row 0 lowered by 0.1; 3 steps with the counters zeroed
   just before; loss and grad norm finite; exact launch counts (K1 17 and
   K2 16 per step: the last bounce's carry feeds nothing, so autograd runs
   no backward for it; K2's scene vector packed once and its VJP run once
   per step; the sky bank 1 forward and 2 backward launches per step, K3
   0) and no plain call; peak memory and seconds per step;
8. kernels at the training step's widths: one more step from the true
   params (the sky bank off, as in phase 5, so that the sky's gradient
   goes through K3) with every K1, K2 and K3 call's inputs recorded (4,194,304,
   1,398,101 and 262,144 lanes; the K2 grid's tile loop runs only here),
   each held against its plain version as in phases 3 and 5; K2's bare
   launch timed at 4,194,304 lanes beside its bound.

Path A, BASELINE config 4 (a checker-textured reflect slot: the unfused
bounce, plain-PyTorch shading on the hit-only kernel K4, the full-param
replay backward whose checker gather transposes through K3):
A1. K4 vs the dense hit on every bounce input of the first 65,536-ray
    chunk of band 256 (65,536 / 21,845 / 4,096 lanes, fillers included):
    every key of the dict the kernel writes (``t``, ``normal``, ``mat_id``,
    ``entering``, ``hit``, ``_evt``) in the plain dict's dtype; decisions
    equal except float64-adjudicated near-ties, ``t`` and the normal (hit
    lanes) within ``rtol 1e-5, atol 5e-6`` and ``max_abs_err`` 0; the
    distinct times the fold (the walk in time order) visits per lane;
A2. ``python -m ptx_torch render --demo config4`` at 512², spp 16, d16:
    K4 1,088 (4 bands × 16 samples × 17 bounces) and the sky bank 64,
    nothing else;
A3. 3 train steps at 512², spp 16, d16: K4 17 and K3 16 per step (16
    backward bounces each transpose the checker gather), the sky bank 1
    forward and 2 backward, K1 = K2 = 0, no plain call;
A4. gradients, kernel path vs plain path as in phase 6, the checker image
    and the sky included.

Path B, the 1536×3072 probe (``make_world`` under
``procedural_sky_image(1536, 3072)``, as ``bench.py --sky 1536x3072``),
the sky bank off (the sky's gradient as the plain route takes it, K8's
widest input; the bank serves the sky on the main path, path K):
B1. 3 train steps: K1 17, K2 16 (one pack and one VJP), K8 3 per step
    (one per phase's sky-select gradient: the 75.5 MB image is past K3's
    shared memory), K3 = 0;
B2. every K8 output of those steps against the float64 ``hist_reference``
    as in phase 5.

Path C, the fused emission kernel K7 (``PTX_EMK=1`` around
``compile_scene``, as tests/test_emission_kernel.py:26-30):
C1. the demo: one 65,536-ray chunk, K1 17 and K7 1 (``trace_rays``
    evaluates emission once, on all phases' records), nothing else; K7 vs
    ``eval_emissive`` on its inputs within ``rtol 1e-5, atol 1e-6``
    except lanes a float64 recompute puts within 1e-6 of a texel boundary,
    and its bins equal to ``lanes_reference``'s except those lanes; then
    the same chunk forward + backward: K1 17, K2 16, K7 1 and K7's
    backward 1, K3 0, the backward held against ``backward_reference``
    run in float64: each entry within ``min(2·n·2⁻²⁴, 1e-4)·Σ|term|``
    (n its terms with a nonzero ct);
C2. 3 train steps: K1 17, K2 16, K7 1 and K7's backward 1 per step, K3 0
    (the backward is one launch: the combined histogram of the sky image
    and the const rows and the factor's sum); every K7 call held against
    its plain version as in C1, every backward as in C1;
C3. gradients, kernel path vs plain path (``eval_emissive``);
C4, C5, C6. a mirror-ball sky world (tests/test_emission_kernel.py:87-115):
    C1's chunk (forward, then forward + backward), C3's gradients and C2's
    3 train steps (its 16×32 probe takes the backward's private regime at
    a step's width).

Path D, the large scenes (K5, the megasweep: union-sweep first hit, in
bounce mode with shade and scatter; K6, the row-fed replay backward):
S1 ``stress_spheres(249)`` (256 leaves), S2 ``stress_gadgets(112)`` (268
leaves: lenses, bulbs, bites), S3 ``stress_spheres(249, transformed=True)``
(the 32-column table), S4 S1 under the 1536×3072 probe (K5 + K6 + K8):
D1. the registers and stack frame of K1 and K4 (each leaf bucket),
    K5, K6 and K9 (each tile and sort size) from nvcc's report; the SASS
    instructions of each K1 and K4 instantiation (``cuobjdump -sass``);
D2. S1-S3: K5 on every bounce of one compacted 65,536-ray chunk (every
    4th row of the frame, depth 16: widths 65,536 / 21,845 / 4,096)
    against its plain version (the sweep + the plain shading) as phase 3
    holds K1, and cull on against cull off bit for bit; on every bounce
    K5's lane counters (fixpoint passes, active cull flags, the sizes of a
    lane's coverage and row lists, the culled gadgets' rows) and its list
    route against the recompute route (list capacities 0) and lists of
    one, bit for bit; on S2 some lanes must read a culled gadget class's
    live rows, and K5's hit mode is held against ``megasweep_reference``
    on the primary rays;
D3. S1, S2: every K6 call of that chunk's forward + backward against its
    plain versions as phase 5 holds K2; two launches the same bits;
D4. S1, S2: gradients, kernel path vs plain path, as phase 6;
D5. 3 ``make_train_step`` steps each on S1-S4 at 512², spp 16, d16: K5 17
    and K6 16 per step (S4 also K8 3), nothing else, no plain call;
D6. ``python -m ptx_torch render --scene scenes/composed.json`` (52 leaves,
    the spec's 512², spp 16, depth 8): K5 4 × 16 × 9 = 576 and the tile
    ordering in every ``trace_rays`` call;
D7. S1, S2 at 65,536 lanes: K5 (wrapper, bare launch back to back and
    queued behind a device sleep, plain, the bound there and summed over
    a train step's widths), K6 (wrapper, bare launch, plain), and K6's
    bare launch at 4,194,304 lanes (a D5 step's widest backward), each
    beside its bound.

Path E, the union sweep's other modes (K9, the sweep-select kernel; the
local membership fold; the candidate-blocked hit) on S1, S2 under
``PTX_SWEEP_MODE=kernel PTX_MEGAB=0`` (no K5), a bitten union (48 spheres
with four spherical bites each over the ground plane under the stress sky:
247 leaves, past the megasweep's slot algebra) under
``PTX_SWEEP_MODE=kernel`` and by default (the fixpoint sweep), and a carved
tape (a sphere intersected with a union of 64 spheres, the ground, the sky:
72 leaves, no union of small groups: the blocked hit); each with the
unfused bounce on its hit and K6:
E1. S1, S2, the bitten union in kernel mode: on every bounce of the D2
    chunk (65,536 / 21,845 / 4,096 lanes) each hit's intervals recomputed
    from its rays, K9 ``sort=False`` (stable-sorted starts) and K9
    ``sort=True`` (unsorted; what kernel mode calls up to
    ``sweep_kernel.SORT_INSIDE_ROWS`` padded rows) against
    ``sweep_select_reference``: 0 differing lanes in all five outputs; the
    whole hit equal to the ``fixpoint`` and ``sort`` modes' bit for bit; on
    S1 and S2 equal to K5's plain version except float64-adjudicated
    near-ties; the fixpoint's passes per bounce; then a chain of 12
    overlapping spheres (multi-hop chains: 65,536 rays from inside the
    first, down the row): K9 with both flags == plain, kernel == fixpoint ==
    sort mode, and the fixpoint taking more than one pass;
E2. gradients, kernel path vs plain path as phase 6: S2 (kernel mode, K9's
    plain version on the plain path), the bitten union (fixpoint), the
    carved tape (blocked);
E3. 3 ``make_train_step`` steps each at 512², spp 4, d16 (1,048,576 rays:
    the sweep holds (L, B) tensors per bounce): S1, S2 and the bitten union
    in kernel mode K9 17 and K6 16 per step; the bitten union by default and
    the carved tape K6 16; nothing else, no plain call; seconds per step,
    peak memory;
E4. ``render --scene scenes/composed.json`` under ``PTX_SWEEP_MODE=kernel
    PTX_MEGAB=0``: K9 4 × 16 × 9 = 576, K5 0, tile ordering in every call;
E5. S1, S2 at every width of E1's chunk (65,536 / 21,845 / 4,096) and of an
    E3 step (1,048,576 / 349,525), on recorded inputs: K9 with both flags ==
    plain bit for bit; K9 as the sweep calls it and the plain version; the
    bare launch with ``sort=False`` and ``sort=True``, back to back and
    queued behind a device sleep; the ``torch.sort`` + ``gather`` +
    ``sort=False`` route and ``torch.sort`` alone; the bound of each flag at
    each width, summed over E3's 17 calls, and a chunk's mean a call.

Path F, the CLI's other render modes on the demo (512², depth 16, K1;
each step through ``ptx_torch.cli.main`` with the counters zeroed just
before, or through the runtime's client):
F1. ``render --spp 4 --checkpoint X``, then ``--spp 8`` on the same file
    (``samples_done`` 4, then 8), an uninterrupted ``--spp 8 --checkpoint
    Y`` and the fast path's ``--spp 8``: K1 17 × 4 bands × the samples
    each renders; the resumed image equal to the uninterrupted one and to
    the fast path's within ``rtol 1e-6, atol 1e-7`` (bit equality logged;
    the fast path keeps a float32 running mean, the checkpoint float64
    sums); a ``--preview`` render at spp 4, its half-block frames counted,
    equal to the first run's image;
F2. ``render --adaptive --spp 16 --checkpoint A``: a base pass of 8 spp in
    one 2,097,152-ray band and 4 rounds of k = 32,768 pixels × 8 spp, K1
    17 × 5; the counts sum to 512² × 8 + 4 × 32,768 × 8, the image finite
    and not black; an API run stopped after round 1 through
    ``AdaptiveCheckpoint`` (round 1's refine chunk, 262,144 lanes
    compacted, held against ``bounce_reference`` as in phase 3), resumed
    by the command (K1 17 × 3): equal to the uninterrupted run as in F1;
F3. ``serve --demo demo`` and ``serve --adaptive`` subprocesses on the card
    (``--port 0``, stderr to ``build/chip_smoke/``), the port's client with
    ``max_attempts`` 2 and a 120 s io timeout: the 512² frame at ``--tile
    64 --spp 4 --depth 16`` in 16-row bands; each server logs 256 served
    bands and no traceback; garbage bytes get the busy byte from both.
    Then the counted run: a ``RenderFarmServer`` in this process on
    ``cli.serve_render_fn`` (the callback ``serve`` runs), plain and
    adaptive, the counters zeroed just before each frame is farmed: K1 17
    × 256 plain, 17 × 3 × 256 adaptive (a base pass and two rounds a
    band); each frame equal to the subprocess server's; the plain frame
    equal to the direct ``render_tile`` of every band with the client's
    seeds as in F1; K1 on one band's bounces (4,096 lanes) against its
    plain version; the adaptive frame finite, one tile's four bands equal
    to ``adaptive_tile_moments`` at their seeds with each count budget met
    (every band is 64 × 16).

Path G, the mesh (``ptx_torch.parallel``: ``torch.distributed``, a
(tiles × samples) ``DeviceMesh``) and the routing knobs, on the demo:
G1. a world-1 NCCL group made with a ``HashStore`` (NCCL's all-reduces
    run) and its 1×1 mesh at 512², spp 16, depth 16, each call with the
    counters zeroed just before: ``render_sharded`` (K1 17) and
    ``render_sharded_moments`` (K1 17) equal to the unsharded ``trace_rays``
    of the same rays under ``fold(key, 0, 0)`` bit for bit; one
    ``make_train_step(mesh=)`` step (K1 17, K2 16, K3 3) against the step
    without a mesh, run twice: the loss bit for bit, the params bit for
    bit wherever the two runs agree, and where float atomics make them
    differ, within twice their distance (at least one ulp; the counts are
    logged); ``render_adaptive(mesh=)`` (K1 34: a base pass at spp 16 and
    a round of 32,768 pixels × 16) equal to the adaptive render from the
    unsharded moments; seconds beside the unsharded calls; the all-reduce
    of the frame (3 MiB) and of the gradient buffer timed;
G2. S1 on the same mesh: the render (K5 17) against the unsharded one;
    one step counted (K5 17, K6 16) and timed as the main path runs it,
    then the mesh step and two unsharded steps compared as in G1 under
    ``torch.use_deterministic_algorithms`` (S1's const gradient sums 16.9 M
    emission records through autograd's ``index_add_``, whose atomics
    make two runs of one step differ by up to 230 ulps otherwise);
G3. two ranks on the one card, both on ``cuda:0``: first two NCCL ranks
    (NCCL refuses two ranks on one GPU; the outcome is logged), then a
    gloo world of 2 (subprocesses of this script, ``--g3-rank``) with a
    2×1 and a 1×2 mesh at 512², spp 16, depth 16: each rank's frame and
    one step's loss equal bit for bit, and its params by G1's rule, to
    this process's per-(tile, sample) band renders on the card combined in
    the JAX order (computed twice); each rank's counts exact (K1 17 a
    render; K1 17, K2 16, K3 3 a step); each rank also logs whether gloo's
    ``all_gather`` takes CUDA tensors (the mesh itself needs only
    all-reduces);
G4. ``PTX_FUSED=0`` on a demo chunk (128 rows × 512, spp 1, depth 16, no
    compaction): K4 17 and nothing else; equal to the default route's
    chunk within ``rtol 1e-4, atol 1e-5`` except pixels whose paths hold a
    decision flip the float64 adjudicator puts at a near-tie;
    ``PTX_PALLAS=0`` (the plain route) and ``fast=False`` (the span merge)
    launch nothing on phase 4's band, which agrees with the kernel band
    by phase 4's rule; for the span merge a flip of ``mat_id`` alone at an
    exactly coincident boundary (the demo's two spheres of one centre and
    radius) is its payload choice, as in the JAX package, and counted.

Path H, the plain-autograd route (``trace_rays(manual_vjp=False)``: plain
autograd through the bounce on the hit kernel, whose ``t`` and normal
differentiate through the hit replay; ``remat`` recomputes each bounce in
the backward), after path G:
H1. the demo on K4: one ``make_train_step(manual_vjp=False)`` step at 512²,
    spp 16, depth 16 (phase 7's start, target and first key; learning rate
    2²⁰, so that ``(start − new) / 2²⁰`` is each gradient to float32
    precision) with ``remat`` off and on, beside the manual route's step
    (K1, K2, K3). Under deterministic algorithms first: remat off (K4's
    inputs and outputs recorded) and on: the losses and the new params
    equal bit for bit, but the sky image's, whose K3 histograms must have
    inputs equal bit for bit and each output within phase 5's float64
    bound (K3's atomics add in an order that varies with the launches
    around them). Then each step counted and timed once
    (``profiling.timed``, ``max_memory_allocated`` after a reset): K4 17
    without ``remat`` and 33 with it (the backward recomputes every bounce
    but the last, whose carry feeds nothing), K3 3, nothing else; the loss
    within ``rtol 1e-5`` of the manual route's, each gradient entry within
    1e-4 of its tensor's largest entry or, for the geometry, within 1e-4 of
    its Σ|term| (the sum over the step's lanes of the absolute per-lane
    terms, measured in the recorded step: near-grazing lanes' adjoints are
    ill-conditioned, and phase 5 lets K2 / K6 differ from autograd by 1e-4
    relative there); K4's recorded hits against K1's on the
    same rays (decisions equal except float64-adjudicated near-ties, ``t``
    within ``rtol 1e-5, atol 5e-6``);
H2. S1 on K5's hit mode, the same: K5 17 / 33, K6 0; the manual route K5
    17 and K6 16; the hits against K5's bounce mode;
H3. K4's own gradient on a chunk's 65,536 primary rays: Σ w·t + Σ v·normal
    through K4's wrapper on the card against the dense hit's autograd,
    every geometry param and the rays within 1e-4 of each tensor's largest
    entry.

Path I, the roofline (``python -m ptx_torch.roofline``, the port of
``tools/roofline.py``; K10, the float32 chain, and K11, the copy, in
``csrc/roofline_kernel.cu``), after path H:
I1. K10 on (8192, 128) float32 uniform in [0.25, 0.5] from a seed, c 1e-3,
    R 1 (every element moves; at the tool's x = 0.5 and c = 1e-9 the chain
    returns 0.5), and K11 on (32768, 1024) normal float32 (128 MiB), each
    against its plain version on the card: equal bit for bit, one launch
    each;
I2. ``ptx_torch.roofline.main(["--device", "cuda:0"])`` at the tool's
    sizes with the counters zeroed just before, every JSON line it prints
    logged here: the FP32 chain (K10), the HBM ``mul_`` loop, the HBM copy
    (K11), the bf16 ``torch.matmul`` chain, K4 on 131,072 demo rays (chained
    and its bare launch queued) and the forward trace with ``compact`` off
    and on; exact launches (K10 8: one a window, 2 warm-ups and 3 windows
    at each R; K11 256 and K4 1,024: one an R over the same windows; K4 192
    bare launches queued; K1 1,394: 17 a forward, 41 forwards a setting),
    no plain call, every figure finite and positive, and no K10, K11 or
    loop rate above 1.02 of its ceiling (then the work counted was not done);
I3. K10 at R 16 (the wrapper, twice, and its plain version: 768 launches an
    R) and K11 on 128 MiB (the wrapper, twice, ``x + 1`` and the library
    call ``torch.add(x, 1, out=)``), each the median of 20 single calls
    between CUDA events (K10's plain version of 3), beside its bound: K10's
    operations at the unfused float32 rate, 33.5e12/s (the port builds with
    ``-fmad=false``; the published 67e12 counts an FFMA as two), K11's
    bytes at 3.35 TB/s.

Path J, the rng kernel (``rng.uniform_many`` on the card, ``csrc/rng_kernel.cu``;
it replaces no TPU kernel), run after phase 10:
J1. the draws of a demo train step's phase 0, 2 keys × 4,194,304
    ``u_coin`` and 2 × 12,582,912 ``u3``: equal to the plain int64 route
    (``rng.uniform_many_reference``) on the card bit for bit, one launch
    each; the wrapper, the plain route and the wrapper again between CUDA
    events, the wrapper also queued behind a device sleep, beside the bound
    (integer operations, 128 dispatched a clock an SM);
J2. two demo train steps under a CPU-only profiler capture: 9 launches a
    step (6 phase draws, the camera's jitter, 2 compaction offsets) by
    ``LAUNCHES`` and by the recorder's ``rng_kernel_launches``; no plain
    draw on the device (``threefry2x32`` never given a tensor).

Then:
9. a forward + backward chunk at the bench's shape (128 rows × 512, spp 1,
   depth 16, ``loss = radiance.mean()``): rays/s over the median of 10
   chunks between CUDA events, beside the forward alone;
10. timing per kernel at the main path's widths (65,536 lanes for K1-K4,
    a chunk's 263,508 and a train step's 16,864,596 emission records for
    K7, the probe's 4,194,304 sky-select lanes for K8): the wrapper as the
    main path calls it and the plain version, each the median of 20 single
    calls between CUDA events;
    for K1 and K4 also the bare launch queued behind a device sleep (the
    card's time) and the bound summed over a train
    step's widths; K4's wrapper is one kernel launch (counted by the
    profiler);
    for K2 also the once-per-call pack + VJP and a step's sum (16 wrappers
    and one pack + VJP) beside 16 times the per-bounce params route; for K3
    and K8 also the library calls ``index_put_(accumulate=True)`` and
    ``index_add_`` on the flat (H·W, C) view (the faster, each one's
    ``library_ms``), K3's wrapper at most 1.25 × ``index_add_``'s time at
    the demo's two widths and K8's at most half of ``index_put_``'s; for
    K7 at both widths (and at C6's mirror-ball step) the forward's
    wrapper (one kernel, counted by the profiler at the demo's widths),
    its bare launch queued, ``eval_emissive``; the backward's wrapper (one
    kernel), queued, in each regime (each held as in C1),
    ``backward_reference`` and ``index_add_`` of the same values
    into the same flat bins, the wrapper at most 1.25 × ``index_add_``'s
    time at the demo's two widths; and the device time a call of
    both K7 launches over one ``PTX_EMK=1`` train step (the profiler); the
    least time the card could take (``bound_ms``) from this run's inputs;
11. the summary line (with path F's rays/s and K1 launches, the largest
    K3 / K8 ratio, path G's seconds and all-reduce times, path H's step
    seconds and peak memory, path I's ceilings and path J's times), then the
    JSON lines: the eleven kernels and the rng kernel (launches from the
    paths' train steps: the demo's for K1-K3, config 4's for K4, S1's for K5
    and K6, C2's for K7, the probe's for K8, E3's S1 for K9; I2's for K10
    and K11; J2's a step for the rng kernel, K3's a step for the sky bank;
    K1's ``max_abs_err``
    includes path F's; K7's entry carries its backward's figures under
    ``backward``; K10's its bound's rate under ``bound_note``), then the
    device.

Path K, the sky bank (``ops/sky_bank.py``: the demo's emission; K1 and
K2 run after phase 10's K7 timings, K3 last):
K1. the kernel pair at a render wavefront's 65,536 lanes and a train step's
    4,194,304 (the schedule's three phases, 263,508 and 16,864,596 records)
    against ``sky_bank_reference64``, the plain route written out in
    float64: the picks and texels equal, each contribution and the
    gradients of the const table, the factor and the image within ``min(2·n·2⁻²⁴, 1e-4)·Σ|term|``, each record's ``d_thr`` equal
    to the plain route's autograd bit for bit, a second run the same bits
    but the image's gradient;
K2. at both widths, in turns with the plain route: the forward's wrapper
    (one kernel), its bare launch queued, the backward's wrapper (two
    kernels), queued, the plain forward and forward + backward, the bound;
    the profiler counts 1 and 2 kernels;
K3. a demo train step 1 forward and 2 backward launches, a render
    wavefront 1, by the counts and the recorder's ``sky_bank_launches``.

Outputs (the rendered image, the nvcc report) go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

W = H = 512
SPP, DEPTH = 16, 16
BAND_ROWS = 128                 # 128 × 512 = 65,536 rays: the CLI's chunk
DECISIONS = ("evt", "hit", "entering", "mat_id", "take_transmit",
             "scatter_alive", "alive2")
FLOATS = ("t", "o2", "d2", "thr2", "strength2")
TIE_REL = 1e-5                  # a near-tie: within 1e-5·max(1, |value|)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# flip adjudication (float64 recompute of the plain bounce on the CPU)
# ---------------------------------------------------------------------------

def _f64_cpu(params):
    return {k: ([x.double().cpu() for x in v] if isinstance(v, list)
                else v.double().cpu()) for k, v in params.items()}


def adjudicate(scene, inputs, out_k, out_p, lanes):
    """For lanes whose decisions differ between the kernel (``out_k``) and
    the plain bounce (``out_p``) on the same ``inputs``, return a bool per
    lane: True where a float64 recompute puts the flipped decision at a
    near-tie — two competing boundaries within ``TIE_REL·max(1, |t|)``, a
    boundary at EPS, or (same hit) the transmit coin, the strength or
    add-factor gate, or the scatter-cap bound within ``TIE_REL``.  That is
    the last-ulp class; anything else is a fault."""
    import torch
    from ptx_torch.core import linalg
    from ptx_torch.core.constants import EPS

    if lanes.numel() == 0:
        return torch.zeros(0, dtype=torch.bool)
    lanes = lanes.cpu()
    p64 = _f64_cpu(scene.params)
    o, d, _, st, _, uc, _, _ = inputs
    o, d = o.cpu()[lanes].double(), d.cpu()[lanes].double()
    st, uc = st.cpu()[lanes].double(), uc.cpu()[lanes].double()

    winner_tied = _winner_tied(scene, p64, o, d, lanes)
    n = lanes.numel()
    hit_class = torch.zeros(n, dtype=torch.bool)
    for k in ("evt", "hit", "entering", "mat_id"):
        hit_class |= (out_k[k] != out_p[k]).cpu()[lanes]
    hit_ok = winner_tied(out_k["evt"]) | winner_tied(out_p["evt"])

    # same hit: the shading gates, recomputed in float64
    hit = scene.plain_hit_fn(p64, o, d)
    m = scene.material_fn(p64, o + hit["t"][:, None] * d, hit["mat_id"])
    rel_ior = torch.where(hit["entering"], 1.0 / m["ior"], m["ior"])
    rf = (torch.clamp(m["transmit_reflect_f"], 0.0, 1.0)
          * linalg.refract_strength(d, rel_ior, hit["normal"]))
    refr_ok = (rf > EPS) & (linalg.refract(d, rel_ior, hit["normal"]) != 0).any(-1)
    p_tr = torch.where(refr_ok, rf, 0.0)
    sc = torch.clamp(m["scatter_f"], 0.0, 1.0)
    bias = (1.0 / torch.where(sc <= EPS, 1.0, sc) - 1.0)[:, None] * \
        linalg.reflect(d, hit["normal"])
    c = (EPS - linalg.dot(hit["normal"], bias)) / linalg.norm(hit["normal"])
    margins = torch.stack([(uc - p_tr).abs(), (st - EPS).abs(),
                           (1.0 - p_tr - EPS).abs(), (rf - EPS).abs(),
                           (c - 1.0).abs()])
    gate_ok = margins.min(dim=0).values <= TIE_REL
    return torch.where(hit_class, hit_ok, gate_ok)


def _winner_tied(scene, p64, o, d, lanes):
    """``tied(evt)``: per lane of ``lanes`` (rays ``o``, ``d`` already cut to
    them, float64 on the CPU), whether the winning event ``evt`` sits
    within ``TIE_REL·max(1, |t|)`` of EPS or of another finite boundary —
    but not exactly on it: exactly equal boundaries (the demo's coincident
    spheres) round identically in both versions, so a flip there breaks
    the leaf-order tie-break and is a fault."""
    import torch
    from ptx_torch.core.constants import EPS, MAX_VALUE
    from ptx_torch.geom import fasthit

    # every boundary time, in float64: (2L, n), event order of the kernel
    t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(scene.plan),
                                           p64, *o.unbind(-1), *d.unbind(-1))
    t_evt = torch.cat([t0, t1])
    idx = torch.arange(lanes.numel())

    def tied(evt):
        e = evt.cpu()[lanes].long()
        te = t_evt[e, idx]
        tol = TIE_REL * torch.clamp(te.abs(), min=1.0)
        gap = (t_evt - te[None]).abs()
        near = (gap > 0) & (gap <= tol) & (t_evt.abs() < MAX_VALUE)
        return (te.abs() < MAX_VALUE) & (near.any(dim=0) | ((te - EPS).abs() <= tol))
    return tied


def compare_bounce(scene, inputs, out_k, out_p):
    """Kernel vs plain on one bounce: (flips, max_abs_err); raises on an
    unexplained flip or a float outside tolerance on agreeing lanes."""
    import torch

    differ = torch.zeros_like(out_k["hit"])
    for k in DECISIONS:
        differ |= out_k[k] != out_p[k]
    lanes = differ.nonzero().flatten()
    ok = adjudicate(scene, inputs, out_k, out_p, lanes)
    if not bool(ok.all()):
        bad = lanes.cpu()[~ok][:8].tolist()
        raise AssertionError(f"{int((~ok).sum())} unexplained decision flips, "
                             f"lanes {bad}")
    agree = ~differ
    max_err = 0.0
    for k in FLOATS + ("u_sel",):
        keep = agree & out_p["hit"] if k == "u_sel" else agree
        a, b = out_k[k][keep], out_p[k][keep]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6, msg=lambda m: f"{k}: {m}")
        max_err = max(max_err, float((a - b).abs().max()) if a.numel() else 0.0)
    return int(lanes.numel()), max_err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {name}")
    log(smi)
    return name, smi


def phase_build():
    from ptx_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    with open(os.path.join(OUT, "nvcc_report.txt"), "w") as f:
        f.write(_build.BUILD_LOG)
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[2 build] {dt:.2f} s (nvcc and load); " + " | ".join(regs))
    return dt


def _primary_band(scene, key, y0, rows, spp=1):
    import torch
    from ptx_torch.integrate.camera import Camera, sample_rays

    o, d = sample_rays(Camera.reference_demo(W, H), key, range(y0, y0 + rows),
                       range(W), spp, scene.device)
    n = o.numel() // 3
    dev = scene.device
    return (o.reshape(-1, 3), d.reshape(-1, 3),
            torch.ones((n, 3), device=dev), torch.ones(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def phase_kernel_vs_plain(scene):
    import torch
    from ptx_torch.core import rng
    from ptx_torch.ops.bounce_kernel import bounce_reference

    key = rng.fold(rng.PRNGKey(0), 0, 192)
    carry = _primary_band(scene, key, 192, BAND_ROWS)
    B = carry[0].shape[0]
    flips, max_err = 0, 0.0
    for b in range(3):
        kb = rng.fold(key, b)
        uc = rng.uniform(rng.fold(kb, 1), (B,), scene.device)
        u3 = rng.uniform(rng.fold(kb, 2), (B, 3), scene.device)
        inputs = (*carry, uc, u3, True)
        if b == 0:
            first_inputs = inputs
        out_k = scene.bounce_fn(scene.params, *inputs)
        out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, max_err = flips + f, max(max_err, e)
        log(f"[3 kernel vs plain] bounce {b}: B={B} alive={int(carry[4].sum())} "
            f"flips={f} max_abs_err={e:.3g}")
        carry = (out_k["o2"], out_k["d2"], out_k["thr2"], out_k["strength2"],
                 out_k["alive2"])
    return flips, max_err, first_inputs


def phase_compacted_chunks(scene):
    """K1 vs plain on the inputs the render itself gives the kernel: the
    first 65,536-ray chunk of two of the CLI's bands (same keys, same
    ``render_rows`` call), recorded bounce by bounce.  Compaction runs
    there (B ≥ 16,384, depth ≥ 8), so each chunk reaches the kernel at
    65,536, 21,845 and 4,096 lanes, with dead filler lanes.  Band 0 is
    mostly sky, so few lanes survive it; band 256 fills the 21,845-lane
    wavefront, through the resampling."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows
    from ptx_torch.ops.bounce_kernel import bounce_reference

    B = BAND_ROWS * W
    expect = [B] * 2 + [B // 3] * 4 + [B // 16] * (DEPTH + 1 - 6)
    flips, max_err = 0, 0.0
    for y0 in (0, 256):
        recorded = []
        sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn,
                                                             recorded))
        render_rows(sk, scene.params, Camera.reference_demo(W, H),
                    rng.PRNGKey(0), y0, BAND_ROWS, 1, 1, DEPTH)
        widths = [inputs[0].shape[0] for inputs, _ in recorded]
        if widths != expect:
            raise AssertionError(f"band {y0}: bounce widths {widths}, "
                                 f"expected {expect}")
        for b, (inputs, out_k) in enumerate(recorded):
            out_p = bounce_reference(scene, scene.params, *inputs)
            torch.cuda.synchronize()
            f, e = compare_bounce(scene, inputs, out_k, out_p)
            flips, max_err = flips + f, max(max_err, e)
            log(f"[3 kernel vs plain] band {y0} chunk 0 bounce {b}: "
                f"B={widths[b]} alive={int(inputs[4].sum())} flips={f} "
                f"max_abs_err={e:.3g}")
    return flips, max_err


def phase_slice(scene):
    import numpy as np
    import torch
    from ptx_torch import cli
    from ptx_torch.ops import bounce_kernel

    out = os.path.join(OUT, "smoke_demo")
    _reset_counters()
    t0 = time.perf_counter()
    frame = cli.main(["render", "--demo", "demo", "--width", str(W), "--height",
                      str(H), "--spp", str(SPP), "--depth", str(DEPTH),
                      "--device", "cuda", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    launches, plain = c["K1"], c["plain"]
    bands = -(-H // min(H, 2 ** 16 // W))     # the CLI's 65,536-ray bands
    expected = bands * SPP * (DEPTH + 1)
    rays = W * H * SPP * (DEPTH + 1)
    log(f"[4 slice] {W}x{H} spp {SPP} depth {DEPTH}: wall {wall:.3f} s incl. "
        f"scene compile and image writes, {rays / wall:.4g} rays/s; "
        f"K1 launches {launches} (expected {expected}), plain bounces {plain}; "
        f"image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all():
        raise AssertionError("render is not a finite (H, W, 3) image")
    if not frame.mean() > 0:
        raise AssertionError("render is black")
    if c != _expect_demo(bands * SPP):
        raise AssertionError(f"render launches {c}: expected K1 {expected} and the sky "
                             f"bank {bands * SPP}, no other kernel, no plain call")
    return launches, wall, rays / wall


def _coincident(scene, inputs, evt, lanes):
    """Per lane of ``lanes``: whether another leaf boundary lies at exactly
    the float64 time of the winning event ``evt`` (the demo's bulb: two
    spheres of one centre and radius)."""
    import torch
    from ptx_torch.geom import fasthit

    o, d = (x.cpu()[lanes.cpu()].double() for x in inputs[:2])
    t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(scene.plan),
                                           _f64_cpu(scene.params), *o.unbind(-1), *d.unbind(-1))
    t_evt = torch.cat([t0, t1])
    te = t_evt[evt.cpu()[lanes.cpu()].long(), torch.arange(lanes.numel())]
    return (t_evt == te[None]).sum(dim=0) >= 2


def _flipped_pixels(scene, log_a, log_b, lanes, n_chunks, spans=False):
    """Pixels (lane = pixel: no compaction) whose paths in route B first
    diverge from route A at a decision a float64 recompute puts at a
    near-tie (:func:`adjudicate` on route B's inputs); raises on any other
    divergence.  ``spans`` (route B the span merge, which has no ``evt``):
    ``entering`` is compared only where both routes hit (a span walk's
    ``entering`` on a miss means nothing), ties are judged on route A's
    winner, and a flip of ``mat_id`` alone at an exactly coincident
    boundary is the span merge's payload choice (the first operand's; the
    fast hit's is the leaf order's), as in the JAX package.  Returns
    ``(flipped (n_chunks · lanes,) bool, flips, of which payload flips)``."""
    import torch

    decisions = tuple(k for k in DECISIONS if not (spans and k == "evt"))
    per_chunk = len(log_a) // n_chunks
    flipped, flips, payload = [], 0, 0
    for chunk in range(n_chunks):
        diverged = torch.zeros(lanes, dtype=torch.bool, device=scene.device)
        for b in range(per_chunk):
            (_, out_a), (inp_b, out_b) = log_a[chunk * per_chunk + b], log_b[chunk * per_chunk + b]
            if spans:
                out_b = dict(out_b, evt=out_a["evt"])
            differ = {}
            for k in decisions:
                differ[k] = out_a[k] != out_b[k]
                if spans and k == "entering":
                    differ[k] &= out_a["hit"] & out_b["hit"]
            first = torch.stack(list(differ.values())).any(dim=0) & ~diverged
            idx = first.nonzero().flatten()
            ok = adjudicate(scene, inp_b, out_a, out_b, idx)
            if spans and idx.numel():
                others = torch.stack([v for k, v in differ.items() if k != "mat_id"]).any(dim=0)
                is_payload = (~others)[idx].cpu() & _coincident(scene, inp_b, out_a["evt"], idx)
                payload += int((is_payload & ~ok).sum())
                ok = ok | is_payload
            if not bool(ok.all()):
                raise AssertionError(f"{int((~ok).sum())} unexplained flips")
            flips += int(idx.numel())
            diverged |= first
        flipped.append(diverged)
    return torch.cat(flipped), flips, payload


def _recording(fn, log_list):
    def call(params, *inputs, packed=None):
        out = fn(params, *inputs, packed=packed)
        log_list.append((inputs, out))
        return out
    return call


def phase_band_vs_plain(scene):
    """A 16-row band at spp 2 (two 8,192-ray chunks, no compaction, so
    lane = pixel) through the kernel and through the plain bounce."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows
    from ptx_torch.ops.bounce_kernel import bounce_reference

    rows, y0 = 16, 248
    cam = Camera.reference_demo(W, H)
    key = rng.PRNGKey(0)
    log_k, log_p = [], []
    sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, log_k))
    sp = dataclasses.replace(scene, bounce_fn=_recording(
        functools.partial(bounce_reference, scene), log_p))
    img_k = render_rows(sk, scene.params, cam, key, y0, rows, 1, 2, DEPTH)
    img_p = render_rows(sp, scene.params, cam, key, y0, rows, 1, 2, DEPTH)
    torch.cuda.synchronize()
    if not len(log_k) == len(log_p) == 2 * (DEPTH + 1):
        raise AssertionError(f"band: {len(log_k)} kernel and {len(log_p)} "
                             f"plain bounces, expected {2 * (DEPTH + 1)} each")

    flipped, flips, _ = _flipped_pixels(scene, log_k, log_p, rows * W, 2)
    keep = ~flipped.reshape(2, rows, W).any(dim=0)
    torch.testing.assert_close(img_k[keep], img_p[keep], rtol=1e-4, atol=1e-5)
    log(f"[4 slice] band {rows}x{W} spp 2 kernel vs plain: {int(keep.sum())} "
        f"pixels equal within rtol 1e-4 atol 1e-5, {flips} adjudicated flips, "
        f"max abs diff {float((img_k - img_p).abs().max()):.3g}")
    return flips


def _time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single calls, each between two CUDA events: the
    card's time for a call, or the host's where the host is slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def _time_back_to_back_ms(fn, reps=20, warmup=3):
    """Mean of ``reps`` calls issued back to back between two CUDA events,
    with no wait between them: the device time per call where launches
    queue faster than they run, else the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_queued_ms(fn, reps=20, warmup=3):
    """Mean device time of ``reps`` calls queued behind a device sleep of
    some 25 ms, so that all are enqueued before the first runs: the card's
    time per call without the host's.  Fails where the host took longer
    than the sleep to enqueue them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    torch.cuda._sleep(50_000_000)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    if host_ms >= s.elapsed_time(a):
        raise AssertionError(f"queued timing: the host took {host_ms:.3f} ms to enqueue "
                             f"{reps} calls, past the {s.elapsed_time(a):.3f} ms sleep")
    return a.elapsed_time(b) / reps


def phase_timing(scene, inputs):
    """K1 as the main path calls it (the wrapper: checks, allocations, one
    launch) against the plain bounce, both timed alike; the bare launch
    back to back and queued behind a device sleep (the card's time), and
    the bound at this width and summed over a train step's widths."""
    from ptx_torch.ops import bounce_kernel

    buf = scene.bounce_fn.pack(scene.params)     # once per trace_rays call
    wrapped = lambda: scene.bounce_fn(scene.params, *inputs, packed=buf)
    plain = lambda: bounce_kernel.bounce_reference(scene, scene.params, *inputs)
    raw = lambda: scene.bounce_fn.launch(buf, *inputs)
    # plain, kernel, kernel, plain: two readings of each on one card
    p1 = _time_ms(plain)
    w1, d1 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    w2, d2 = _time_ms(wrapped), _time_back_to_back_ms(raw)
    q = _time_queued_ms(raw)
    p2 = _time_ms(plain)
    B, L = inputs[0].shape[0], scene.bounce_fn.layout[0]
    bound, step = bound_k1(B, L), _step_bound(bound_k1, L)
    log(f"[10 timing] K1: one bounce at B={B}: K1 wrapper (checks, allocations, one "
        f"launch, as the render calls it) {w1:.4f} / {w2:.4f} ms; plain PyTorch {p1:.4f} / "
        f"{p2:.4f} ms (each the median of 20 single calls between CUDA events, 3 warm-up); "
        f"K1 bare launch {d1:.4f} / {d2:.4f} ms (mean of 20 launches back to back), queued "
        f"behind a sleep (the card's time) {q:.4f} ms; bound {bound[0]:.4g} ms ({bound[1]}), "
        f"summed over a train step's widths {step[0]:.4g} ms ({step[1]})")
    return min(w1, w2), min(p1, p2), min(d1, d2), q


PROFILE_PAD_S = 0.02            # host time either side of a one-call trace's call


def _kernels_launched(fn, tries=3):
    """The CUDA kernels one call of ``fn`` launches, counted by
    ``torch.profiler`` (after a warm-up call).  The call sits
    ``PROFILE_PAD_S`` of host time inside either end of the trace: the
    profiler keeps only the device records that fall inside its window,
    and the card's timestamps stray from the host's by up to milliseconds.
    A trace whose host side shows kernel launches but which holds no
    kernel at all lost its device records all the same (seen on the card
    for torch's own kernels too, in runs of such traces): it is taken
    again, up to ``tries`` times; if the records stay lost, the count is
    that of the host's launch calls in the last trace."""
    import torch
    from ptx_torch.utils.profiling import trace

    fn()
    torch.cuda.synchronize()
    path = os.path.join(OUT, "one_call_trace.json")
    for _ in range(tries):
        with trace(path):
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                       and "Launch" in e.get("name", ""))
        if kernels or not launches:
            return kernels
        log(f"[profiler] {launches} launch calls and no kernel in the trace: taken again")
    log(f"[profiler] device records lost {tries} times: the host's {launches} launch calls")
    return launches


def _step_bound(bound, *args):
    """A kernel's bound summed over the widths a train step (512², spp 16,
    depth 16: 4,194,304 rays) gives its 17 calls, and what bounds most of it."""
    parts = [bound(w, *args) for w in _wavefront_widths(W * H * SPP, DEPTH)]
    by = max(("bytes", "operations"), key=lambda k: sum(t for t, b in parts if b == k))
    return sum(t for t, _ in parts), by


# ---------------------------------------------------------------------------
# the backward slice: K2, K3, gradients, the training step
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24                # float32 unit roundoff
# SGD on every param, the sky image and its factor included: at the
# default 1e-2 (and at 1e-3) the loss grew from step to step on a small
# CPU rehearsal; 3e-4 keeps it near the start over three steps.
LR = 3e-4


def _leaf_params(params):
    """Fresh leaf copies of every param tensor, requiring grad."""
    return {k: ([x.detach().clone().requires_grad_(True) for x in v]
                if isinstance(v, list) else v.detach().clone().requires_grad_(True))
            for k, v in params.items()}


def _flat_grads(params):
    import torch

    out = {}
    for k, v in params.items():
        for i, x in enumerate(v if isinstance(v, list) else [v]):
            out[f"{k}[{i}]" if isinstance(v, list) else k] = (
                torch.zeros_like(x) if x.grad is None else x.grad)
    return out


def _close_f64(name, got, want, truth, scale=None):
    """Kernel ``got`` vs plain ``want``: within rtol 1e-5, atol 1e-6, or
    within twice the plain value's error against the float64 ``truth``
    plus 1e-4 of ``scale``; finite.  The default scale of an (n, 3) array
    is each row's largest |truth|: a direction or position cotangent's
    components mix through normalisations, so one that cancels to near 0
    carries the rounding of its row.  Returns (max|got − want|, a list of
    the elements off)."""
    import torch

    got, want, truth = (x.double() for x in (got, want, truth))
    if scale is None:
        scale = truth.abs().amax(dim=-1, keepdim=True).expand_as(truth)
    scale = scale.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: NaN or Inf")
    ok = torch.isclose(got, want, rtol=1e-5, atol=1e-6) | (
        (got - truth).abs() <= 2 * (want - truth).abs() + 1e-4 * scale + 1e-6)
    bad = [f"{name} at {tuple(i)}: kernel {float(got[tuple(i)]):.8g} plain "
           f"{float(want[tuple(i)]):.8g} float64 {float(truth[tuple(i)]):.8g} scale "
           f"{float(scale[tuple(i)]):.4g}" for i in (~ok).nonzero()[:4].tolist()]
    if bad:
        bad.insert(0, f"{name}: {int((~ok).sum())} elements off")
    return (float((got - want).abs().max()) if got.numel() else 0.0), bad


def _close_per_tensor(name, got, want, rel=1e-4, atol=1e-7):
    """Per param tensor: |got - want| <= rel · max|want| + atol, finite.
    Returns a list of the tensors off."""
    import torch

    offs = []
    for k in want:
        a, b = got[k], want[k]
        tol = rel * (float(b.abs().max()) if b.numel() else 0.0) + atol
        err = float((a - b).abs().max()) if b.numel() else 0.0
        if not bool(torch.isfinite(a).all()) or err > tol:
            offs.append(f"{name} {k}: max err {err:.4g} > {tol:.4g} (or not finite)")
    return offs


@contextlib.contextmanager
def _recording_hists(log_list, outputs=None):
    """While active, ``imagegrad.hist`` (the histogram routing, as the
    image gather's and K7's backward call it) logs each call's inputs, and
    its output into ``outputs`` when that list is given."""
    from ptx_torch.ops import imagegrad

    fn = imagegrad.hist

    def call(yi, xi, inb, ct, shape):
        log_list.append((yi, xi, inb, ct, shape))
        out = fn(yi, xi, inb, ct, shape)
        if outputs is not None:
            outputs.append(out)
        return out

    imagegrad.hist = call
    try:
        yield
    finally:
        imagegrad.hist = fn


class _RecordingBwd:
    """A replay backward wrapper (K2's or K6's) that logs each call's
    inputs; its other attributes are the wrapper's (``takes_packed``,
    ``pack``), so ``trace_rays`` routes as it would without it."""

    def __init__(self, kern, log_list):
        self.kern, self.log = kern, log_list

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def __call__(self, scene_in, o, d, thr, dec, *cts):
        self.log.append((o, d, thr, dec, cts))
        return self.kern(scene_in, o, d, thr, dec, *cts)


def _recording_bwd(scene, log_list):
    """``scene`` with a replay backward that logs each call's inputs."""
    return dataclasses.replace(scene, bounce_bwd_fn=_RecordingBwd(scene.bounce_bwd_fn,
                                                                  log_list))


# Ten times the largest reading of the float64 rule (4.45e-5: K3's direct
# regime forced onto config 4's 8×8 checker at a step's 4,194,304 lanes,
# ~65,536 device-memory atomics a texel; the routed regimes read ≤ 1e-6)
HIST_REL = 5e-4
HIST_WORST = {"ratio": 0.0, "where": "none"}   # the run's largest K3 / K8 reading


def _hist_bound_ok(name, got, yi, xi, inb, ct, shape):
    """K3 / K8 against ``hist_reference`` run in float64: every texel within
    ``min(2·n·2⁻²⁴, HIST_REL)·Σ|ct|`` of it, n the texel's lanes with a
    nonzero ct (the reordered-sum bound where it is the tighter; else a
    limit that does not grow with n, so a step's millions of lanes on one
    texel still check the sum to ``HIST_REL`` of its magnitude; K7's rule,
    ``_k7_bwd_within_bound``).  Returns (max|k − p|, the largest
    |k − p| / Σ|ct|), and keeps the run's largest ratio in ``HIST_WORST``."""
    import torch
    from ptx_torch.ops import imagegrad

    ct64 = ct.double()
    want = imagegrad.hist_reference(yi, xi, inb, ct64, shape)
    mag = imagegrad.hist_reference(yi, xi, inb, ct64.abs(), shape)
    n = imagegrad.hist_reference(yi, xi, inb, (ct != 0).double(), shape)
    err = (got.double() - want).abs()
    bad = err > torch.clamp(2 * n * U32, max=HIST_REL) * mag
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} texels more than min(2·n·2⁻²⁴, "
                             f"{HIST_REL:g})·Σ|ct| off the float64 sum (or not finite)")
    ratio = float((err / mag)[mag > 0].max()) if bool((mag > 0).any()) else 0.0
    if ratio > HIST_WORST["ratio"]:
        HIST_WORST.update(ratio=ratio, where=name)
    return float(err.max()), ratio


def _check_k2(scene, recorded, tag, name="K2"):
    """K2 (or K6, ``name``) against its plain versions on each recorded
    backward bounce (the same saved carry, decisions and cotangents): per
    lane by :func:`_close_f64` against ``bounce_bwd_lanes_reference`` and
    its float64 recompute; ``d_packed`` against those per-leaf sums
    folded onto the materials (``fold_packed``), the float64 fold as truth,
    at the scale of the folded sums of |term|; ``d_params`` (``d_packed``
    through the packing's VJP) by
    :func:`_close_f64` against ``bounce_bwd_reference`` (autograd through
    ``trace._bounce_replay``), the float64 sums mapped to the params as
    truth, at each tensor's largest entry; two launches the same bits.
    Returns max|k − p|."""
    import torch
    from ptx_torch.ops import bounce_kernel as bk

    kern = scene.bounce_bwd_fn
    sums = lambda a: bk.fold_packed(a, kern.leaf_mat, kern.n_materials)
    err2, offs = 0.0, []
    for o_, d_, thr_, dec, cts in reversed(recorded):
        packed, leaves = kern.pack_leaves(scene.params)
        packed_d = packed.detach()
        got = kern.launch(packed_d, o_, d_, thr_, dec, *cts)
        again = kern.launch(packed_d, o_, d_, thr_, dec, *cts)
        ref_packed = bk.pack_bwd(kern.rows, scene.material_fn, scene.params).detach()
        ref = bk.bounce_bwd_lanes_reference(ref_packed, kern.aux, o_, d_, thr_, dec, *cts)
        ref64 = bk.bounce_bwd_lanes_reference(
            ref_packed.double(), kern.aux.double(), o_.double(), d_.double(),
            thr_.double(), dict(dec, u_sel=dec["u_sel"].double()),
            *(c.double() for c in cts))
        want_s, truth_s, scale_s = sums(ref[3]), sums(ref64[3]), sums(ref64[4])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
        Bw = o_.shape[0]
        checks = [_close_f64(f"{name} B={Bw} {n}", g, w, t) for n, g, w, t in
                  zip(("d_o", "d_d", "d_thr"), got[:3], ref[:3], ref64[:3])]
        checks.append(_close_f64(f"{name} B={Bw} d_packed", got[3], want_s, truth_s,
                                 scale_s))
        got_p = kern.params_grad(packed, leaves, got[3])
        want_p = bk.bounce_bwd_reference(scene, scene.params, o_, d_, thr_, dec, *cts)[3]
        truth_p = kern.params_grad(*kern.pack_leaves(scene.params), truth_s.float())
        for k, t in truth_p.items():
            if t.numel():
                checks.append(_close_f64(f"{name} B={Bw} d_params {k}", got_p[k], want_p[k],
                                         t, torch.full_like(t, float(t.abs().max()))))
        e = max(c[0] for c in checks[:4])
        for c in checks:
            offs += c[1]
        err2 = max(err2, e)
        lane_e = max(float((g - w).abs().max()) for g, w in zip(got[:3], ref[:3]))
        # relative to Σ|term|, floored at 1e-6 of the largest (entries whose
        # terms all round to ~0 have no meaningful relative error)
        floor = 1e-6 * float(scale_s.max()) + 1e-30
        sums_rel = float(((got[3] - want_s).abs() / scale_s.clamp(min=floor)).max())
        log(f"[{tag}] B={Bw} continuing="
            f"{int((dec['take_transmit'] | dec['scatter_alive']).sum())} max_abs_err "
            f"{e:.3g}: per lane {lane_e:.3g} (largest |d_o| "
            f"{float(ref64[0].abs().max()):.4g}, |d_d| {float(ref64[1].abs().max()):.4g}), "
            f"d_packed {float((got[3] - want_s).abs().max()):.3g} (at most "
            f"{sums_rel:.3g} of their Σ|term|), d_params max diff "
            f"{max(c[0] for c in checks[4:]):.3g}; two launches bit-identical; "
            "no NaN/Inf")
    if offs:
        raise AssertionError(f"{tag}: {name} outside tolerance:\n" + "\n".join(offs))
    return err2


def _check_hists(hists, tag, kernel="K3", n=3, outputs=None):
    """K3 (or K8) against ``hist_reference`` on each of the ``n`` recorded
    histograms: the recorded output where ``outputs`` is given, else a
    fresh call of the routing.  Returns max|k − p|."""
    from ptx_torch.ops import imagegrad

    if len(hists) != n:
        raise AssertionError(f"{tag}: {len(hists)} histograms, expected {n}")
    err = 0.0
    for i, (yi, xi, inb, ct, shape) in enumerate(hists):
        if kernel != ("K3" if imagegrad.fits_k3(shape) else "K8"):
            raise AssertionError(f"{tag}: a {tuple(shape)} image does not route to {kernel}")
        got = outputs[i] if outputs is not None else imagegrad.hist(yi, xi, inb, ct, shape)
        e, ratio = _hist_bound_ok(f"{kernel} N={yi.numel()}", got, yi, xi, inb, ct, shape)
        err = max(err, e)
        log(f"[{tag}] {tuple(shape)} N={yi.numel()} in bounds {int(inb.sum())} "
            f"max_abs_err {e:.3g}, largest |k − p| / Σ|ct| {ratio:.3g} (limit "
            f"min(2·n·2⁻²⁴, {HIST_REL:g}))")
    return err


def _wavefront_widths(B, depth):
    """The widths ``trace_rays`` gives the bounces of a compacted B-ray
    wavefront: B for bounces 0-1, B // 3 for 2-5, B // 16 from 6 on."""
    return [B] * 2 + [B // 3] * 4 + [B // 16] * (depth + 1 - 6)


def phase_backward_kernels(scene):
    """K2 and K3 against their plain versions on the inputs the render's
    chunk gives them: the first 65,536-ray chunk of band 256 (the key
    ``render_rows`` gives it), forward + backward of the radiance sum."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import imagegrad

    recorded, hists = [], []
    # the sky bank off: the sky's gradient through the plain route's
    # gather, K3's input at a chunk's widths (path K holds the bank)
    sk = dataclasses.replace(_recording_bwd(scene, recorded), sky_bank=None)
    key = rng.fold(rng.PRNGKey(0), 0, 256)
    o, d = sample_rays(Camera.reference_demo(W, H), key, range(256, 256 + BAND_ROWS),
                       range(W), 1, scene.device)
    with _recording_hists(hists):
        trace_rays(sk, _leaf_params(scene.params), o, d, key, DEPTH).sum().backward()
        torch.cuda.synchronize()
    B = BAND_ROWS * W
    widths = sorted((r[0].shape[0] for r in recorded), reverse=True)
    if widths != _wavefront_widths(B, DEPTH - 1):
        raise AssertionError(f"K2 widths {widths}, expected "
                             f"{_wavefront_widths(B, DEPTH - 1)}")
    err2 = _check_k2(scene, recorded, "5 K2 vs plain")
    err3 = _check_hists(hists, "5 K3 vs plain")
    g = torch.Generator(device=scene.device).manual_seed(0)
    big = (512, 1024, 4)
    N = 1 << 20
    yi = torch.randint(0, big[0], (N,), device=scene.device, generator=g)
    xi = torch.randint(0, big[1], (N,), device=scene.device, generator=g)
    inb = torch.rand(N, device=scene.device, generator=g) < 0.95
    ct = torch.randn((N, 4), device=scene.device, generator=g)
    e8 = _check_hists([(yi, xi, inb, ct, big)], "5 K8 vs plain", "K8", 1)
    k2_in = next(r for r in recorded if r[0].shape[0] == B)
    k3_in = max(hists, key=lambda h: h[0].numel())      # phase 0's sky-select
    return err2, err3, e8, k2_in, k3_in


def _plain_scene(scene):
    """``scene`` with every kernel's plain version: the dense hit, the
    plain bounce and replay backward (K1's and K2's plain versions, the
    unfused composition on the dense hit) and ``eval_emissive``."""
    from ptx_torch.ops.bounce_kernel import bounce_bwd_reference, bounce_reference

    return dataclasses.replace(
        scene, hit_fn=scene.plain_hit_fn,
        bounce_fn=functools.partial(bounce_reference, scene),
        bounce_bwd_fn=functools.partial(bounce_bwd_reference, scene),
        emission_fn=scene.material_fn.eval_emissive if scene.emission_fn else None,
        sky_bank=None)


def phase_gradients(scene, tag="6 gradients", plain_cm=None):
    """Kernel path vs plain path on a compacted 32-row band at spp 2; the
    plain path runs every kernel's plain version, ``hist_reference`` for
    the histograms, and ``plain_cm`` (a context manager) around it where a
    kernel is reached through a module function."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import imagegrad

    key = rng.fold(rng.PRNGKey(0), 0, 240)
    o, d = sample_rays(Camera.reference_demo(W, H), key, range(240, 272), range(W), 2,
                       scene.device)

    def grads(sc):
        p = _leaf_params(scene.params)
        trace_rays(sc, p, o, d, key, DEPTH).mean().backward()
        torch.cuda.synchronize()
        return _flat_grads(p)

    g_k = grads(scene)
    plain_hist = imagegrad.hist
    imagegrad.hist = imagegrad.hist_reference
    try:
        with plain_cm or contextlib.nullcontext():
            g_p = grads(_plain_scene(scene))
    finally:
        imagegrad.hist = plain_hist
    offs = _close_per_tensor(f"{tag}: gradients kernel vs plain", g_k, g_p)
    if offs:
        raise AssertionError("\n".join(offs))
    worst = max(float((g_k[k] - g_p[k]).abs().max()) if g_p[k].numel() else 0.0
                for k in g_p)
    images = ", ".join(f"|d {k}| {float(v.abs().sum()):.4g}" for k, v in g_k.items()
                       if k.startswith("images"))
    log(f"[{tag}] 32x{W} spp 2 depth {DEPTH} (32,768 rays, compacted): kernel "
        f"path vs plain path, {len(g_p)} param tensors incl. every image, max abs "
        f"diff {worst:.3g}; |d sphere_radius| {float(g_k['sphere_radius'].abs().sum()):.4g}"
        f", {images}")
    if not all(float(v.abs().sum()) > 0 for k, v in g_k.items() if k.startswith("images")):
        raise AssertionError(f"{tag}: an image got no gradient")
    return worst


def _reset_counters():
    from ptx_torch.ops import bounce_kernel as bk, emission_kernel as ek
    from ptx_torch.ops import fasthit_kernel as fk, imagegrad, megasweep, roofline_kernel
    from ptx_torch.ops import sky_bank, sweep_kernel
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd

    bk.LAUNCHES = bk.REFERENCE_CALLS = bk.BWD_REFERENCE_CALLS = 0
    sky_bank.LAUNCHES = sky_bank.BWD_LAUNCHES = 0
    bk.BounceBwdKernel.LAUNCHES = bk.BounceBwdKernel.PACKS = 0
    bk.BounceBwdKernel.PACK_VJPS = 0
    imagegrad.LAUNCHES = imagegrad.REFERENCE_CALLS = 0
    imagegrad.BandedHistKernel.LAUNCHES = 0
    fk.LAUNCHES = fk.REFERENCE_CALLS = 0
    ek.LAUNCHES = ek.BWD_LAUNCHES = ek.REFERENCE_CALLS = 0
    megasweep.MegaSweepKernel.LAUNCHES = megasweep.REFERENCE_CALLS = 0
    RowFedReplayBwd.LAUNCHES = RowFedReplayBwd.PACKS = RowFedReplayBwd.PACK_VJPS = 0
    sweep_kernel.LAUNCHES = sweep_kernel.REFERENCE_CALLS = 0
    roofline_kernel.FMA_LAUNCHES = roofline_kernel.COPY_LAUNCHES = 0
    roofline_kernel.REFERENCE_CALLS = 0


def _counters():
    from ptx_torch.ops import bounce_kernel as bk, emission_kernel as ek
    from ptx_torch.ops import fasthit_kernel as fk, imagegrad, megasweep, roofline_kernel
    from ptx_torch.ops import sky_bank, sweep_kernel
    from ptx_torch.ops.replay_bwd import RowFedReplayBwd

    return {"K1": bk.LAUNCHES, "K2": bk.BounceBwdKernel.LAUNCHES,
            "K2 packs": bk.BounceBwdKernel.PACKS,
            "K2 pack VJPs": bk.BounceBwdKernel.PACK_VJPS,
            "K3": imagegrad.LAUNCHES, "K4": fk.LAUNCHES,
            "K5": megasweep.MegaSweepKernel.LAUNCHES, "K6": RowFedReplayBwd.LAUNCHES,
            "K6 packs": RowFedReplayBwd.PACKS, "K6 pack VJPs": RowFedReplayBwd.PACK_VJPS,
            "K7": ek.LAUNCHES, "K7 bwd": ek.BWD_LAUNCHES,
            "K8": imagegrad.BandedHistKernel.LAUNCHES,
            "K9": sweep_kernel.LAUNCHES,
            "K10": roofline_kernel.FMA_LAUNCHES, "K11": roofline_kernel.COPY_LAUNCHES,
            "SB": sky_bank.LAUNCHES, "SB bwd": sky_bank.BWD_LAUNCHES,
            "plain": (bk.REFERENCE_CALLS + bk.BWD_REFERENCE_CALLS + imagegrad.REFERENCE_CALLS
                      + fk.REFERENCE_CALLS + ek.REFERENCE_CALLS + megasweep.REFERENCE_CALLS
                      + sweep_kernel.REFERENCE_CALLS + roofline_kernel.REFERENCE_CALLS)}


def _expect(steps=0, k6_steps=0, **per_kernel):
    """Exact launch counts: the given kernels, every other kernel 0, and
    no plain-version call; ``steps`` K2 (``k6_steps`` K6) train steps or
    backward passes, each packing the replay backward's scene vector once
    and running its VJP once."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7 bwd", "K8", "K9",
                         "K10", "K11", "SB", "SB bwd", "plain"), 0)
    out.update(per_kernel)
    out["K2 packs"] = out["K2 pack VJPs"] = steps
    out["K6 packs"] = out["K6 pack VJPs"] = k6_steps
    return out


def _expect_demo(calls, steps=0, **per_kernel):
    """:func:`_expect` for ``calls`` ``trace_rays`` calls on a scene of the
    fused bounce and the sky bank (the demo): K1 ``DEPTH + 1`` and the
    bank's forward 1 a call; ``steps`` of them differentiated, K2
    ``DEPTH`` and the bank's backward 2 each."""
    if steps:
        per_kernel = dict(per_kernel, K2=steps * DEPTH, **{"SB bwd": 2 * steps})
    return _expect(steps, K1=calls * (DEPTH + 1), SB=calls, **per_kernel)


def phase_train(scene, tag, expect, recorder=None, spp=SPP):
    """3 ``make_train_step`` steps at full size (512², ``spp``, depth 16),
    the counters zeroed just before; ``expect`` the exact launch counts of
    the 3 steps; ``recorder`` an optional context manager held around the
    steps."""
    import math

    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel.render import _local_render, make_train_step

    cam = Camera.reference_demo(W, H)
    with torch.no_grad():
        target = _local_render(scene, cam, DEPTH, spp, scene.params, rng.PRNGKey(1), 0, H)
    params = dict(scene.params)
    params["sphere_radius"] = scene.params["sphere_radius"] * 1.05
    const = scene.params["const"].clone()
    const[0] -= 0.1
    params["const"] = const
    step = make_train_step(scene, cam, spp=spp, depth=DEPTH, learning_rate=LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    with recorder or contextlib.nullcontext():
        _reset_counters()
        for i in range(3):
            t0 = time.perf_counter()
            new, loss = step(params, target, rng.fold(rng.PRNGKey(2), i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            sq = 0.0
            for k in params:
                for a, b in zip(*(x if isinstance(x, list) else [x]
                                  for x in (params[k], new[k]))):
                    sq += float((((a - b) / LR) ** 2).sum())
            gnorm = math.sqrt(sq)
            log(f"[{tag}] step {i}: loss {float(loss):.6g} grad norm {gnorm:.6g} "
                f"{secs[-1]:.3f} s")
            if not (math.isfinite(float(loss)) and math.isfinite(gnorm) and gnorm > 0):
                raise AssertionError("train step: loss or gradient not finite")
            params = new
        c = _counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {W}x{H} spp {spp} depth {DEPTH} ({W * H * spp:,} rays per step): "
        f"launches {c} (expected {expect}); peak memory {peak:.3f} GiB; "
        f"seconds per step {[round(x, 4) for x in secs]}")
    if c != expect:
        raise AssertionError(f"train launches {c}, expected {expect}")
    return c, secs, peak, target


def phase_train_kernels(scene, target):
    """K1, K2 and K3 against their plain versions on the inputs one
    ``make_train_step`` step gives them at full size: a step from the true
    params with every kernel call's inputs recorded.  K1 and K2 run there
    at 4,194,304, 1,398,101 and 262,144 lanes, where each K2 block walks
    many 128-lane tiles (its grid is capped at 1,024 blocks), and K3 on
    the sky-select rows of each phase.  The checks and tolerances are
    phase 3's for K1 and phase 5's for K2 and K3."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.ops.bounce_kernel import bounce_reference
    from ptx_torch.parallel.render import make_train_step

    fwd, bwd, hists = [], [], []
    sk = _recording_bwd(scene, bwd)
    # the sky bank off, as in phase 5: K3 at a step's widths
    sk = dataclasses.replace(sk, bounce_fn=_recording(scene.bounce_fn, fwd), sky_bank=None)
    step = make_train_step(sk, Camera.reference_demo(W, H), spp=SPP, depth=DEPTH,
                           learning_rate=LR)
    with _recording_hists(hists):
        step(scene.params, target, rng.PRNGKey(2))
        torch.cuda.synchronize()
    N = W * H * SPP
    widths = [inputs[0].shape[0] for inputs, _ in fwd]
    if widths != _wavefront_widths(N, DEPTH):
        raise AssertionError(f"train step: K1 widths {widths}, expected "
                             f"{_wavefront_widths(N, DEPTH)}")
    widths = sorted((r[0].shape[0] for r in bwd), reverse=True)
    if widths != _wavefront_widths(N, DEPTH - 1):
        raise AssertionError(f"train step: K2 widths {widths}, expected "
                             f"{_wavefront_widths(N, DEPTH - 1)}")
    flips, err1 = 0, 0.0
    while fwd:
        inputs, out_k = fwd.pop(0)
        with torch.no_grad():
            out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err1 = flips + f, max(err1, e)
        log(f"[8 train-width K1 vs plain] bounce {DEPTH - len(fwd)}: B={inputs[0].shape[0]} "
            f"alive={int(inputs[4].sum())} flips={f} max_abs_err={e:.3g}")
        del inputs, out_k, out_p
    err2 = _check_k2(scene, bwd, "8 train-width K2 vs plain")
    err3 = _check_hists(hists, "8 train-width K3 vs plain")
    o, d, thr, dec, cts = next(r for r in bwd if r[0].shape[0] == N)
    kern = scene.bounce_bwd_fn
    packed = kern.pack(scene.params).detach()
    bare = [_time_back_to_back_ms(lambda: kern.launch(packed, o, d, thr, dec, *cts))
            for _ in range(2)]
    continuing = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    bound = bound_k2(N, continuing, packed.numel())
    log(f"[8 train-width timing] K2 bare launch at B={N} (continuing {continuing}): "
        f"{bare[0]:.4f} / {bare[1]:.4f} ms (mean of 20 back to back); bound "
        f"{bound[0]:.4g} ms ({bound[1]})")
    return flips, err1, err2, err3, max(hists, key=lambda h: h[0].numel())


def phase_fwd_bwd(scene):
    """Forward + backward of one bench-shaped chunk (128 rows × 512, spp 1,
    depth 16), and the forward alone: median seconds of 10 chunks."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays

    cam = Camera.reference_demo(W, H)
    rays = BAND_ROWS * W * (DEPTH + 1)

    def run(grad):
        times = []
        for i in range(12):
            key = rng.fold(rng.PRNGKey(0), i, 128)
            o, d = sample_rays(cam, key, range(128, 256), range(W), 1, scene.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if grad:
                p = _leaf_params(scene.params)
                trace_rays(scene, p, o, d, key, DEPTH).mean().backward()
            else:
                with torch.no_grad():
                    trace_rays(scene, scene.params, o, d, key, DEPTH)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        return statistics.median(times[2:])

    f1, fb1, fb2, f2 = run(False), run(True), run(True), run(False)
    log(f"[9 fwd+bwd] chunk 128x{W} spp 1 depth {DEPTH}: fwd+bwd {fb1:.4f} / "
        f"{fb2:.4f} s = {rays / fb1:.4g} / {rays / fb2:.4g} rays/s; forward alone "
        f"{f1:.4f} / {f2:.4f} s = {rays / f1:.4g} / {rays / f2:.4g} rays/s (median "
        f"of 10 chunks between CUDA events)")
    return rays / min(fb1, fb2), rays / min(f1, f2)


# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BPS = 3.35e12
F32_OPS = 67e12


def _bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bound_k1(B, L):
    """K1 at B lanes: reads o, d, thr, strength, alive, u_coin, u3 (57 B),
    writes t, o2, d2, thr2, strength2, u_sel, evt (56 B), five decision
    bytes and mat_id (int64); operations (estimate, every lane): ~25 per
    leaf interval, 2 compares per (event, leaf) pair of the membership
    fold, ~250 for shading and the scatter."""
    return _bound(126 * B, B * (25 * L + 4 * L * L + 250))


def bound_k2(B, continuing, sum_words):
    """K2 (and K6): reads o, d, thr, u_sel and three cotangents (21 floats,
    84 B), evt and four flags (8 B), writes d(o, d, thr) (36 B), plus the
    ``sum_words`` floats of the scene's sums (K2's ``d_packed``, L·26 +
    M·8; K6's (L, 34)); operations: ~450 per continuing lane (replay and
    reverse sweep) and its 34 adds into the per-leaf sums; other lanes
    copy."""
    return _bound(128 * B + 4 * sum_words, continuing * (450 + 34))


def bound_k3(yi, inb, ct, shape):
    """K3 (and K8): reads every lane's inb (1 B), the C floats of an
    in-bounds lane's cotangent and the two int64 indices of a lane that
    adds (in bounds, a nonzero cotangent; at C > 4 every in-bounds lane,
    as the kernels load them), writes the image once; one add per channel
    of each in-bounds lane."""
    N, C = ct.shape
    texels = shape[0] * shape[1] * shape[2]
    n_inb = int(inb.sum())
    n_add = int((inb & (ct != 0).any(dim=1)).sum()) if C <= 4 else n_inb
    return _bound(N + 4 * C * n_inb + 16 * n_add + 4 * texels, C * n_inb)


def _library_hists(yi, xi, inb, ct, shape):
    """The two PyTorch calls that compute the gather's transpose:
    ``index_put_(accumulate=True)`` on the (H, W, C) image and
    ``index_add_`` on its flat (H·W, C) view (masked cotangents and flat
    indices made beforehand)."""
    import torch

    ct_m = torch.where(inb[:, None], ct, 0.0)
    flat = yi * shape[1] + xi
    put = lambda: torch.zeros(shape, device=ct.device).index_put_((yi, xi), ct_m,
                                                                  accumulate=True)
    add = lambda: torch.zeros((shape[0] * shape[1], shape[2]), device=ct.device).index_add_(
        0, flat, ct_m)
    return put, add


def phase_timing_backward(scene, k2_in):
    """K2 as the main path calls it against its plain versions, in turns:
    plain, kernel, kernel, plain: the per-bounce wrapper as
    ``ManualBounce.backward`` calls it (input checks, allocations, the two
    launches), the once-per-call pack + VJP (``pack_bwd`` of the params with
    history, then its VJP on one ``d_packed``), and for a step's 16
    backward bounces 16 wrappers + one pack + VJP beside 16 times the
    per-bounce params route (launch, pack and VJP on every bounce, as the
    wrapper did before ``d_packed``)."""
    import torch
    from ptx_torch.ops import bounce_kernel as bk, imagegrad

    kern = scene.bounce_bwd_fn
    o, d, thr, dec, cts = k2_in
    packed = bk.pack_bwd(kern.rows, scene.material_fn, scene.params).detach()
    d_packed = kern(packed, o, d, thr, dec, *cts)[3]
    k2 = lambda: kern(packed, o, d, thr, dec, *cts)
    k2p = lambda: kern.reference(packed, o, d, thr, dec, *cts)
    k2_bare = lambda: kern.launch(packed, o, d, thr, dec, *cts)
    pack_vjp = lambda: kern.params_grad(*kern.pack_leaves(scene.params), d_packed)
    route = lambda: kern.params_grad(*kern.pack_leaves(scene.params),
                                     kern(packed, o, d, thr, dec, *cts)[3])
    whole = lambda: bk.bounce_bwd_reference(scene, scene.params, o, d, thr, dec, *cts)
    p1, a1 = _time_ms(k2p), _time_ms(whole)
    w1, w2 = _time_ms(k2), _time_ms(k2)
    v1, r1, r2, v2 = _time_ms(pack_vjp), _time_ms(route), _time_ms(route), _time_ms(pack_vjp)
    b1, b2 = _time_back_to_back_ms(k2_bare), _time_back_to_back_ms(k2_bare)
    a2, p2 = _time_ms(whole), _time_ms(k2p)
    n_bwd = DEPTH
    step_new, step_old = n_bwd * min(w1, w2) + min(v1, v2), n_bwd * min(r1, r2)
    log(f"[10 timing] K2 at B={o.shape[0]}: per-bounce wrapper (checks, allocations, "
        f"two launches) {w1:.4f} / {w2:.4f} ms; bare launch {b1:.4f} / {b2:.4f} ms (mean "
        f"of 20 back to back); plain (lanes + fold) {p1:.4f} / {p2:.4f} ms; whole-bounce "
        f"plain (autograd of the replay to the params) {a1:.4f} / {a2:.4f} ms")
    log(f"[10 timing] K2 pack + VJP once per trace_rays call {v1:.4f} / {v2:.4f} ms; "
        f"per-bounce params route (launch + pack + VJP) {r1:.4f} / {r2:.4f} ms; a step's "
        f"{n_bwd} backward bounces: {n_bwd} wrappers + one pack + VJP {step_new:.4f} ms, "
        f"{n_bwd} x the per-bounce params route {step_old:.4f} ms")
    continuing = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    return (min(w1, w2), min(p1, p2), bound_k2(o.shape[0], continuing, packed.numel()),
            min(v1, v2), step_new, step_old)


def _hist_stats(yi, xi, inb, ct, shape):
    """K3's input in figures: N; the lanes that add (inb and a nonzero
    cotangent); the texels they touch and the mean and largest lanes on a
    touched texel; the mean distinct texels a warp of 32 consecutive lanes
    adds into, over the warps with a lane that adds; lanes per image entry
    (N / H·W·C)."""
    import torch

    N = yi.numel()
    adds = inb & (ct != 0).any(dim=1)
    t = torch.where(adds, yi * shape[1] + xi, -1)
    counts = torch.bincount(t[adds], minlength=shape[0] * shape[1])
    touched = counts[counts > 0].float()
    w = torch.cat([t, t.new_full(((-N) % 32,), -1)]).reshape(-1, 32).sort(dim=1).values
    distinct = ((w[:, 1:] != w[:, :-1]) & (w[:, 1:] >= 0)).sum(1) + (w[:, 0] >= 0).long()
    active = distinct > 0
    return (f"N={N} adding {int(adds.sum())} on {touched.numel()} texels, lanes per "
            f"texel mean {float(touched.mean()) if touched.numel() else 0.0:.1f} max "
            f"{int(touched.max()) if touched.numel() else 0}, distinct texels per warp "
            f"{float(distinct[active].float().mean()) if bool(active.any()) else 0.0:.2f} "
            f"over {int(active.sum())} warps, {N / (shape[0] * shape[1] * shape[2]):.2f} "
            "lanes per image entry")


def phase_timing_k3(k3_ins):
    """K3 at the chunk width (phase 5's widest call), the train width
    (phase 8's) and on config 4's checker (A3's widest): each input's
    figures (:func:`_hist_stats`); the wrapper as the main path calls it
    beside ``hist_reference``, ``index_put_(accumulate=True)`` and
    ``index_add_`` on the flat view, in turns (plain, library, kernel,
    kernel, library, plain), each the median of 20 single calls; then,
    back to back (the device's time per call where launches queue faster
    than they run, else the host's), the wrapper in each regime (forced
    through ``launch(plan=)``, each output held against the float64
    reference, ``_hist_bound_ok``) and K8's plain atomic pass on the same
    lanes; and the routed wrapper queued behind a device sleep, the card's
    time alone.
    Fails if K3's wrapper takes more than 1.25 × ``index_add_``'s time at a
    demo width (the margin is for run-to-run noise)."""
    import torch
    from ptx_torch.ops import imagegrad

    out = {}
    for name, (yi, xi, inb, ct, shape) in k3_ins.items():
        N = yi.numel()
        H, W_, C = shape
        sms = torch.cuda.get_device_properties(yi.device).multi_processor_count
        entries = imagegrad.K3_PRIVATE_LANES * H * W_ * C
        plans = {"direct": (0, min(-(-N // 512), imagegrad.K3_BLOCKS_PER_SM * sms)),
                 "private": imagegrad.k3_plan(max(N, entries), shape, sms)}
        routed = imagegrad.k3_plan(N, shape, sms)
        k3 = lambda: imagegrad.hist(yi, xi, inb, ct, shape)
        k3p = lambda: imagegrad.hist_reference(yi, xi, inb, ct, shape)
        put, add = _library_hists(yi, xi, inb, ct, shape)
        q1, l1, m1 = _time_ms(k3p), _time_ms(put), _time_ms(add)
        h1, h2 = _time_ms(k3), _time_ms(k3)
        m2, l2, q2 = _time_ms(add), _time_ms(put), _time_ms(k3p)
        regimes = []
        for rname, plan in plans.items():
            run = lambda: imagegrad.k3.launch(yi, xi, inb, ct, shape, plan=plan)
            ratio = _hist_bound_ok(f"K3 {rname} N={N}", run(), yi, xi, inb, ct, shape)[1]
            regimes.append(f"{rname} {plan} {_time_back_to_back_ms(run):.4f} ms "
                           f"(|k − p| / Σ|ct| at most {ratio:.3g})"
                           + (" (routed)" if plan == routed else ""))
        k8 = _time_back_to_back_ms(lambda: imagegrad.k8.launch(yi, xi, inb, ct, shape))
        queued = _time_queued_ms(k3)
        bound = bound_k3(yi, inb, ct, shape)
        log(f"[10 K3 {name}] {tuple(shape)} {_hist_stats(yi, xi, inb, ct, shape)}")
        log(f"[10 K3 {name}] wrapper {h1:.4f} / {h2:.4f} ms; plain {q1:.4f} / {q2:.4f} ms; "
            f"index_put_(accumulate=True) {l1:.4f} / {l2:.4f} ms; index_add_ (flat) "
            f"{m1:.4f} / {m2:.4f} ms (each the median of 20 single calls); back to back: "
            f"{'; '.join(regimes)}; K8's atomic pass {k8:.4f} ms; queued behind a sleep "
            f"(the card's time) {queued:.4f} ms; bound {bound[0]:.4g} ms ({bound[1]})")
        out[name] = (min(h1, h2), min(q1, q2), min(l1, l2), bound, min(m1, m2))
    for name in ("chunk", "train"):
        if out[name][0] > 1.25 * out[name][4]:
            raise AssertionError(f"K3's wrapper at the {name} width {out[name][0]:.4f} ms "
                                 f"is more than 1.25 x index_add_'s {out[name][4]:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# the small-scene paths: config 4 (unfused bounce, K4), the probe (K8), K7
# ---------------------------------------------------------------------------

HIT_DECISIONS = ("_evt", "hit", "entering", "mat_id")
PROBE = (1536, 3072)            # the reference-scale probe, bench.py --sky 1536x3072


@contextlib.contextmanager
def _swapped(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def _all(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


class _RecordingHit:
    """A hit (K4's wrapper, or any ``hit_fn``), logging each call's rays
    and output."""

    def __init__(self, kern, log_list):
        self.kern, self.log = kern, log_list

    def pack(self, params):
        pack = getattr(self.kern, "pack", None)
        return pack(params) if pack is not None else None

    def __call__(self, params, o, d, packed=None):
        out = (self.kern(params, o, d) if packed is None
               else self.kern(params, o, d, packed=packed))
        self.log.append((o, d, out))
        return out


def _recording_em(kern, log_list):
    """K7's wrapper, logging each call's params, inputs and output."""
    def call(params, pos, mid):
        out = kern(params, pos, mid)
        log_list.append((params, pos, mid, out))
        return out
    return call


def compare_hit(scene, o, d, out_k, out_p, name="K4"):
    """K4 (or ``name``) vs the plain hit on one wavefront: (flips,
    max_abs_err); raises on a flip a float64 recompute does not put at a
    near-tie, or a float outside ``rtol 1e-5, atol 5e-6`` (the normal on hit
    lanes)."""
    import torch

    differ = torch.zeros_like(out_k["hit"])
    for k in HIT_DECISIONS:
        differ |= out_k[k] != out_p[k]
    lanes = differ.nonzero().flatten().cpu()
    if lanes.numel():
        p64 = _f64_cpu(scene.params)
        tied = _winner_tied(scene, p64, o.cpu()[lanes].double(), d.cpu()[lanes].double(),
                            lanes)
        ok = tied(out_k["_evt"]) | tied(out_p["_evt"])
        if not bool(ok.all()):
            raise AssertionError(f"{name}: {int((~ok).sum())} unexplained decision flips, "
                                 f"lanes {lanes[~ok][:8].tolist()}")
    max_err = 0.0
    for k, keep in (("t", ~differ), ("normal", ~differ & out_p["hit"])):
        a, b = out_k[k][keep], out_p[k][keep]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6,
                                   msg=lambda m: f"{name} {k}: {m}")
        max_err = max(max_err, float((a - b).abs().max()) if a.numel() else 0.0)
    return int(lanes.numel()), max_err


def phase_k4_chunk(c4):
    """K4 vs the dense hit on every bounce input of the first 65,536-ray
    chunk of config 4's band 256 as ``render_rows`` runs it: widths 65,536,
    21,845 and 4,096, fillers included.  Every key of the dict the kernel
    writes (``t``, ``normal``, ``mat_id``, ``entering``, ``hit``, ``_evt``,
    each in the plain dict's dtype): 0 unexplained flips and ``max_abs_err``
    0; per bounce the distinct times the fold visits (:func:`walk_visits`)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows

    rec = []
    with _swapped(c4, "hit_fn", _RecordingHit(c4.hit_fn, rec)):
        render_rows(c4, c4.params, Camera.reference_demo(W, H), rng.PRNGKey(0), 256,
                    BAND_ROWS, 1, 1, DEPTH)
    widths = [o.shape[0] for o, _, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"K4 widths {widths}")
    flips, err, visits = 0, 0.0, torch.zeros(0, dtype=torch.int64)
    for b, (o, d, out_k) in enumerate(rec):
        out_p = c4.plain_hit_fn(c4.params, o, d)
        torch.cuda.synchronize()
        for k, v in out_p.items():
            if out_k[k].dtype != v.dtype or out_k[k].shape != v.shape:
                raise AssertionError(f"A1 K4 {k}: {out_k[k].dtype} {tuple(out_k[k].shape)}, "
                                     f"the plain dict's {v.dtype} {tuple(v.shape)}")
        f, e = compare_hit(c4, o, d, out_k, out_p)
        flips, err = flips + f, max(err, e)
        v = walk_visits(c4, o, d, out_p)
        visits = torch.cat([visits, v.cpu()])
        log(f"[A1 K4 vs plain] config4 band 256 chunk 0 bounce {b}: B={o.shape[0]} "
            f"hit={int(out_k['hit'].sum())} flips={f} max_abs_err={e:.3g}; distinct times "
            f"visited {visits_histogram(v)}")
    if err != 0.0:
        raise AssertionError(f"A1 K4: max_abs_err {err} against the plain hit, not 0")
    log(f"[A1 K4] distinct times the fold visits over the chunk's {visits.numel()} lanes: "
        f"{visits_histogram(visits)}")
    return flips, err, rec[0][:2]


def phase_render_cli(demo, tag, expect):
    """``python -m ptx_torch render --demo <demo>`` at 512², spp 16, d16
    through ``ptx_torch.cli.main``, the counters zeroed just before."""
    import numpy as np
    import torch
    from ptx_torch import cli

    _reset_counters()
    t0 = time.perf_counter()
    frame = cli.main(["render", "--demo", demo, "--width", str(W), "--height", str(H),
                      "--spp", str(SPP), "--depth", str(DEPTH), "--device", "cuda",
                      "--out", os.path.join(OUT, f"smoke_{demo}")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    rays = W * H * SPP * (DEPTH + 1)
    log(f"[{tag}] render --demo {demo} {W}x{H} spp {SPP} depth {DEPTH}: wall {wall:.3f} s "
        f"incl. scene compile and image writes, {rays / wall:.4g} rays/s; launches {c} "
        f"(expected {expect}); image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all() or not frame.mean() > 0:
        raise AssertionError(f"{tag}: render is not a finite, non-black (H, W, 3) image")
    if c != expect:
        raise AssertionError(f"{tag}: render launches {c}, expected {expect}")
    return rays / wall


def _texel_boundary_lanes(kern, params, pos, tol=1e-6):
    """Lanes whose chain coordinates, recomputed in float64, lie within
    ``tol`` (in uv units) of a texel boundary: there a float32 rounding
    picks either texel."""
    import torch
    from ptx_torch.shade.textures import _mirror_ball_uv, _spherical_uv

    q = pos.double()
    if kern.xform_idx is not None:
        A = params["tex_xform"][kern.xform_idx].detach().double()
        q = q @ A[:, :3].T + A[:, 3]
    uv = (_mirror_ball_uv if kern.mirror else _spherical_uv)(q)
    img = params["images"][kern.img_id]
    x = (uv[:, 0] - torch.floor(uv[:, 0])) * img.shape[1]
    y = (1.0 - (uv[:, 1] - torch.floor(uv[:, 1]))) * img.shape[0]
    return (((x - torch.round(x)).abs() <= tol * img.shape[1])
            | ((y - torch.round(y)).abs() <= tol * img.shape[0]))


def _check_k7(scene, calls, tag):
    """K7 against ``eval_emissive`` on each recorded call's inputs: ``rtol
    1e-5, atol 1e-6`` except lanes of the chain's material whose texel a
    float64 recompute puts within 1e-6 of a boundary; its bins (a launch on
    the same inputs) equal to ``lanes_reference``'s except those lanes.
    Returns (max|k − p| on the other lanes, the lanes off only by such a
    boundary)."""
    import torch
    from ptx_torch.ops import emission_kernel as ek

    kern = scene.emission_fn
    err, n_near = 0.0, 0
    for params, pos, mid, em_k in calls:
        with torch.no_grad():
            p = {k: ([x.detach() for x in v] if isinstance(v, list) else v.detach())
                 for k, v in params.items()}
            em_p = scene.material_fn.eval_emissive(p, pos, mid)
            near = _texel_boundary_lanes(kern, p, pos) & (mid == kern.dyn_mi)
            args = (p["tex_xform"], p["const"], p["factor"], p["images"][kern.img_id], pos,
                    mid)
            bin_k = kern.launch(*args)[1]
            bin_p = ek.lanes_reference(kern, *args)[1]
        torch.cuda.synchronize()
        close = torch.isclose(em_k.detach(), em_p, rtol=1e-5, atol=1e-6).all(dim=-1)
        if not bool((close | near).all()):
            raise AssertionError(f"{tag}: K7 differs from eval_emissive on "
                                 f"{int((~(close | near)).sum())} lanes")
        if not bool(((bin_k == bin_p) | near).all()):
            raise AssertionError(f"{tag}: K7's bins differ from lanes_reference's on "
                                 f"{int((~((bin_k == bin_p) | near)).sum())} lanes")
        e = float((em_k.detach() - em_p)[~near].abs().max())
        flips = int((~close & near).sum())
        err, n_near = max(err, e), n_near + flips
        log(f"[{tag}] N={pos.shape[0]} chain lanes {int((mid == kern.dyn_mi).sum())}, "
            f"{int(near.sum())} within 1e-6 of a texel boundary, {flips} of them off "
            f"(another texel), {int((bin_k != bin_p).sum())} bins differ there; "
            f"max_abs_err {e:.3g} elsewhere")
    return err, n_near


class _RecordingEmBwd:
    """While active, K7's backward launches (``launch_bwd``) log each
    call's inputs and outputs."""

    def __init__(self, kern, log_list):
        self.kern, self.log = kern, log_list

    def __enter__(self):
        fn = self.kern.launch_bwd

        def call(*a, **k):
            out = fn(*a, **k)
            self.log.append((a, out))
            return out
        self.kern.launch_bwd = call
        return self

    def __exit__(self, *exc):
        del self.kern.launch_bwd                 # the class's method again


# K7's backward: at most 1e-4 of an entry's Σ|term| off the float64 sum.  At
# a train step's 16.9 M records an image bin of the direct regime adds
# ~1,400 near-equal values through device-memory atomics, whose roundings do
# not cancel: up to 9.35e-6 of Σ|term| on an H100 (PERF.md, PR 10); an entry
# off by a thousandth of its magnitude, as one block's share of a sum lost
# or added twice, fails.
K7_BWD_REL = 1e-4


def _k7_bwd_within_bound(kern, args, got, name):
    """K7's backward outputs ``got`` against ``backward_reference`` run in
    float64 on the same ``args``: every entry within ``min(2·n·2⁻²⁴,
    K7_BWD_REL)·Σ|term|`` of it, n the entry's terms with a nonzero ct
    (the reordered-sum bound where it is the tighter; else a limit that
    does not grow with n, so a step's millions of records in one bin
    still check the sum to 1e-4 of its magnitude).  Returns (max|k − p|,
    the largest |k − p| / Σ|term| and the output that holds it)."""
    import torch
    from ptx_torch.ops import emission_kernel as ek

    ct, bin_, img, factor, c_shape, f_shape = (
        x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in args)
    want = ek.backward_reference(kern, ct, bin_, img, factor, c_shape, f_shape)
    mag = ek.backward_reference(kern, ct.abs(), bin_, img.abs(), factor.abs(), c_shape,
                                f_shape)
    n = ek.backward_reference(kern, (ct != 0).double(), bin_, torch.ones_like(img),
                              torch.ones_like(factor), c_shape, f_shape)
    err, rel, where = 0.0, 0.0, "none"
    for label, g, w, m, c in zip(("d_img", "d_const", "d_factor"), got, want, mag, n):
        if w is None:
            if g is not None:
                raise AssertionError(f"{name}: {label} is not None")
            continue
        e = (g.double() - w).abs()
        lim = torch.clamp(2 * c * U32, max=K7_BWD_REL) * m
        if not bool(torch.isfinite(g).all()) or bool((e > lim).any()):
            raise AssertionError(f"{name} {label}: {int((e > lim).sum())} entries more "
                                 f"than min(2·n·2⁻²⁴, {K7_BWD_REL:g})·Σ|term| off the "
                                 "float64 sum")
        if e.numel():
            err = max(err, float(e.max()))
        r = float((e / m)[m > 0].max()) if bool((m > 0).any()) else 0.0
        if r > rel:
            rel, where = r, label
    return err, rel, where


def _check_k7_bwd(scene, calls, tag):
    """Each recorded K7 backward against the float64 ``backward_reference``
    (``_k7_bwd_within_bound``).  Returns max|k − p|."""
    kern = scene.emission_fn
    err = 0.0
    for args, got in calls:
        e, rel, where = _k7_bwd_within_bound(kern, args, got, tag)
        ct, bin_, img = args[:3]
        err = max(err, e)
        in_image = (bin_ >= 0) & (bin_ < img.shape[0] * img.shape[1])
        log(f"[{tag}] K7 backward N={ct.shape[0]}, nonzero ct {int((ct != 0).any(1).sum())}, "
            f"chain lanes in bounds {int(in_image.sum())}: within min(2·n·2⁻²⁴, "
            f"{K7_BWD_REL:g})·Σ|term| of the float64 sum, max_abs_err {e:.3g}, largest "
            f"|k − p| / Σ|term| {rel:.3g} ({where})")
    return err


def phase_k7_chunk(scene, tag):
    """One 65,536-ray chunk (band 256 of the render, depth 16) with the
    counters zeroed: K1 17 and K7 once (``trace_rays`` evaluates emission
    once, on all phases' records), no histogram, no plain call; K7 held
    against ``eval_emissive`` and ``lanes_reference`` on its inputs.  Then
    the same chunk forward + backward (``radiance.mean()``): K1 17, K2 16,
    K7 1 and K7's backward 1, no histogram, the backward held against
    ``backward_reference``.  Returns the errors, the chunk's K7 inputs and
    its backward's inputs."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate import render
    from ptx_torch.integrate.camera import Camera

    calls, bwds = [], []
    cam = Camera.reference_demo(W, H)
    kern = scene.emission_fn
    with _swapped(scene, "emission_fn", _recording_em(kern, calls)):
        _reset_counters()
        with torch.no_grad():
            band = render.render_rows(scene, scene.params, cam, rng.PRNGKey(0), 256,
                                      BAND_ROWS, 1, 1, DEPTH)
        torch.cuda.synchronize()
        c = _counters()
        expect = _expect(K1=DEPTH + 1, K7=1)
        log(f"[{tag}] one chunk of {BAND_ROWS * W} rays: launches {c} (expected {expect}); "
            f"band mean {float(band.mean()):.6g}")
        if c != expect or not bool(torch.isfinite(band).all()):
            raise AssertionError(f"{tag}: chunk launches {c}, expected {expect}, or not finite")
        # the same chunk (render_rows's key and rays) forward + backward
        k = rng.fold(rng.PRNGKey(0), 0, 256)
        o, d = render.sample_rays(cam, k, range(256, 256 + BAND_ROWS), range(W), 1,
                                  scene.device)
        params = _leaf_params(scene.params)
        with _RecordingEmBwd(kern, bwds):
            _reset_counters()
            render.trace_rays(scene, params, o, d, k, DEPTH).mean().backward()
            torch.cuda.synchronize()
            c = _counters()
    expect = _expect(1, K1=DEPTH + 1, K2=DEPTH, K7=1, **{"K7 bwd": 1})
    log(f"[{tag}] the chunk forward + backward: launches {c} (expected {expect})")
    if c != expect:
        raise AssertionError(f"{tag}: forward + backward launches {c}, expected {expect}")
    err, near = _check_k7(scene, calls, tag)
    err_b = _check_k7_bwd(scene, bwds, tag)
    _, pos, mid, _ = calls[0]
    return err, near, err_b, (pos, mid), bwds[0][0]


def phase_train_k7(scene, tag="C2"):
    """3 train steps with K7 (the demo, or ``tag``'s world): K1 17, K2 16,
    K7 1 and K7's backward 1 per step, K3 0 (the backward is one launch:
    the combined histogram of the sky image and the const rows and the
    factor's sum); every K7 call held against its plain versions, every
    backward against the float64 ``backward_reference``
    (``_k7_bwd_within_bound``).  Returns the figures, the errors, and the
    last step's K7 inputs and its backward's inputs."""
    calls, bwds = [], []
    c, secs, peak, _ = phase_train(
        scene, f"{tag} K7 train",
        _expect(3, K1=3 * (DEPTH + 1), K2=3 * DEPTH, K7=3, **{"K7 bwd": 3}),
        _all(_swapped(scene, "emission_fn", _recording_em(scene.emission_fn, calls)),
             _RecordingEmBwd(scene.emission_fn, bwds)))
    err7, near = _check_k7(scene, calls, f"{tag} train-width K7 vs plain")
    err7b = _check_k7_bwd(scene, bwds, f"{tag} train-width K7 backward vs plain")
    _, pos, mid, _ = calls[-1]
    train_in = ((pos, mid), bwds[-1][0])
    del calls, bwds
    return c, secs, peak, err7, near, err7b, train_in


def phase_train_config4(c4):
    """A3: 3 train steps of config 4, K4 17 and K3 19 per step (16 backward
    bounces each transpose the checker gather, 3 phases each the
    sky-select's), K1 = K2 = 0; every K3 call's output held against
    the float64 ``hist_reference`` (``_hist_bound_ok``; the recorded
    inputs and outputs count in the peak memory).  Returns the widest
    checker input (of those, the one with most lanes that add) beside the
    step's figures."""
    hists, outs = [], []
    c, secs, peak, _ = phase_train(
        c4, "A3 config4 train", _expect(K4=3 * (DEPTH + 1), K3=3 * DEPTH, SB=3,
                                        **{"SB bwd": 6}),
        _recording_hists(hists, outs))
    err3 = _check_hists(hists, "A3 train-width K3 vs plain", "K3", 3 * DEPTH, outs)
    checker = max((h for h in hists if h[4][0] * h[4][1] <= 64),
                  key=lambda h: (h[0].numel(), int((h[2] & (h[3] != 0).any(1)).sum())))
    return c, secs, peak, err3, checker


def phase_probe(pb):
    """The 1536×3072 probe: 3 train steps of the demo under that sky, K1
    17, K2 16 and K8 3 per step (one per phase's sky-select gradient, the
    75.5 MB image past K3's shared memory), K3 0; every K8 call's output
    held against the float64 ``hist_reference`` (``_hist_bound_ok``)."""
    hists, outs = [], []
    pb = dataclasses.replace(pb, sky_bank=None)
    c, secs, peak, _ = phase_train(
        pb, "B1 probe train", _expect(3, K1=3 * (DEPTH + 1), K2=3 * DEPTH, K8=9),
        _recording_hists(hists, outs))
    err8 = _check_hists(hists, "B2 probe K8 vs plain", "K8", 9, outs)
    k8_in = max(hists, key=lambda h: h[0].numel())
    return c, secs, peak, err8, k8_in


def bound_k4(B, L):
    """K4 at B lanes: reads o, d (24 B), writes t, normal, mat_id (int64),
    evt, hit and entering (30 B); operations (estimate, above what the walk
    does on most lanes): ~25 per leaf interval and 2 compares per (event,
    leaf) pair; bytes bound it either way."""
    return _bound(54 * B, B * (25 * L + 4 * L * L))


def bound_k7(N, img):
    """K7's forward at N lanes: reads pos and mid (20 B) and the image once,
    writes em and the backward's bin (16 B); ~90 operations a lane."""
    return _bound(36 * N + img.numel() * 4, 90 * N)


def bound_k7_bwd(ct, bin_, img, R, factor):
    """K7's backward: reads every lane's ct (12 B) and the bin of a lane
    whose ct is not zero (4 B; no other lane adds), the image once (the
    texels of the factor's sum), writes d_img, d_const and d_factor once;
    operations: 3 adds into a bin for a lane that adds, 9 more (ct·factor,
    ct·texel and its sum) for a chain lane in bounds."""
    HW = img.shape[0] * img.shape[1]
    adds = (ct != 0).any(dim=1) & (bin_ >= 0)
    n_add, n_chain = int(adds.sum()), int((adds & (bin_ < HW)).sum())
    out_words = img.numel() + 3 * R + factor.numel()
    return _bound(12 * ct.shape[0] + 4 * int((ct != 0).any(dim=1).sum()) + 4 * img.numel()
                  + 4 * out_words, 3 * n_add + 9 * n_chain)


def phase_timing_small(c4, k4_in, k8_in):
    """K4 and K8 as the main path calls them against their plain
    versions (K8 also against ``index_put_``), in turns: plain, kernel,
    kernel, plain."""
    import torch
    from ptx_torch.ops import imagegrad

    o, d = k4_in
    buf = c4.hit_fn.pack(c4.params)
    k4 = lambda: c4.hit_fn(c4.params, o, d, packed=buf)
    k4p = lambda: c4.plain_hit_fn(c4.params, o, d)
    n_kernels = _kernels_launched(k4)
    if n_kernels != 1:
        raise AssertionError(f"K4's wrapper launched {n_kernels} kernels, not 1")
    p1, w1, w2, p2 = _time_ms(k4p), _time_ms(k4), _time_ms(k4), _time_ms(k4p)
    q = _time_queued_ms(lambda: c4.hit_fn.launch(buf, o, d))
    L4 = c4.hit_fn.layout[0]
    bound, step = bound_k4(o.shape[0], L4), _step_bound(bound_k4, L4)
    log(f"[10 timing] K4 at B={o.shape[0]} (wrapper: one launch, {n_kernels} kernel in the "
        f"profiler) {w1:.4f} / {w2:.4f} ms; bare launch queued behind a sleep (the card's "
        f"time) {q:.4f} ms; plain dense hit {p1:.4f} / {p2:.4f} ms; bound "
        f"{bound[0]:.4g} ms ({bound[1]}), summed over a train step's widths {step[0]:.4g} ms "
        f"({step[1]})")
    k4_t = (min(w1, w2), min(p1, p2), bound)

    yi, xi, inb, ct, shape = k8_in
    k8 = lambda: imagegrad.hist(yi, xi, inb, ct, shape)
    k8p = lambda: imagegrad.hist_reference(yi, xi, inb, ct, shape)
    put, add = _library_hists(yi, xi, inb, ct, shape)
    r1, l1, m1 = _time_ms(k8p), _time_ms(put), _time_ms(add)
    h1, h2 = _time_ms(k8), _time_ms(k8)
    m2, l2, r2 = _time_ms(add), _time_ms(put), _time_ms(k8p)
    log(f"[10 timing] K8 at N={yi.numel()} on {tuple(shape)} (wrapper: zero-fill + "
        f"launch) {h1:.4f} / {h2:.4f} ms; plain {r1:.4f} / {r2:.4f} ms; "
        f"index_put_(accumulate=True) {l1:.4f} / {l2:.4f} ms; index_add_ (flat) "
        f"{m1:.4f} / {m2:.4f} ms")
    k8_t = (min(h1, h2), min(r1, r2), bound_k3(yi, inb, ct, shape), min(l1, l2),
            min(m1, m2))
    if not k8_t[0] <= 0.5 * k8_t[3]:
        raise AssertionError(f"K8's wrapper {k8_t[0]:.4f} ms is more than half of "
                             f"index_put_'s {k8_t[3]:.4f} ms")
    return k4_t, k8_t


def _library_k7_bwd(kern, ct, bin_, img, factor, c_shape, f_shape):
    """``index_add_`` of K7's backward values (``ct·factor`` on a chain lane
    in bounds, raw ``ct`` on another material's) into the same flat
    ``(H·W + R, 3)`` bins (values and indices made beforehand)."""
    import torch

    HW = img.shape[0] * img.shape[1]
    b = bin_.to(torch.int64)
    f = (factor[kern.factor_idx] if kern.factor_idx is not None
         else torch.ones(3, device=ct.device))
    vals = torch.where((b >= 0)[:, None], torch.where((b < HW)[:, None], ct * f, ct), 0.0)
    flat = b.clamp(min=0)
    return lambda: torch.zeros((HW + c_shape[0], 3), device=ct.device).index_add_(0, flat,
                                                                                  vals)


GATED_K7 = ("chunk", "train")   # the demo's widths: kernel counts and the index_add_ gate


def phase_timing_k7(k7_ins):
    """K7 at a chunk's and a train step's widths (C1's and C2's recorded
    inputs; C6's, a mirror-ball step's, where the backward's plan routes
    to the private regime), in turns (plain, kernel, kernel, plain): the forward's wrapper
    as ``trace_rays`` calls it (one kernel, counted by the profiler), its
    bare launch queued behind a device sleep, ``eval_emissive``; the
    backward's wrapper as ``_Emission.backward`` calls it (one kernel),
    queued, back to back in each regime (each output held by
    ``_k7_bwd_within_bound``), ``backward_reference`` and ``index_add_`` of the
    same values into the same flat bins.  Fails unless each wrapper is one
    kernel (the profiler's count, at the demo's widths) and the backward
    takes at most 1.25 × ``index_add_``'s time at the demo's two widths (the
    margin is for run-to-run noise)."""
    import torch
    from ptx_torch.ops import emission_kernel as ek

    out = {}
    for name, (pe, (pos, mid), bargs) in k7_ins.items():
        kern, P = pe.emission_fn, pe.params
        img = P["images"][kern.img_id]
        N = pos.shape[0]
        gated = name in GATED_K7
        fargs = (P["tex_xform"], P["const"], P["factor"], img, pos, mid)
        with torch.no_grad():
            wrap = lambda: kern(P, pos, mid)
            plain = lambda: pe.material_fn.eval_emissive(P, pos, mid)
            n_fwd = _kernels_launched(wrap) if gated else 1
            p1, w1, w2, p2 = _time_ms(plain), _time_ms(wrap), _time_ms(wrap), _time_ms(plain)
            q = _time_queued_ms(lambda: kern.launch(*fargs))
        bwd = lambda: kern.launch_bwd(*bargs)
        bplain = lambda: ek.backward_reference(kern, *bargs)
        add = _library_k7_bwd(kern, *bargs)
        n_bwd = _kernels_launched(bwd) if gated else 1
        if n_fwd != 1 or n_bwd != 1:
            raise AssertionError(f"K7 at N={N}: the forward's wrapper launched {n_fwd} kernels, "
                                 f"the backward's {n_bwd}, not 1 each")
        r1, a1 = _time_ms(bplain), _time_ms(add)
        b1, b2 = _time_ms(bwd), _time_ms(bwd)
        a2, r2 = _time_ms(add), _time_ms(bplain)
        bq = _time_queued_ms(bwd)
        routed = ek.bwd_regime(N, img.shape[0], img.shape[1], bargs[4][0], img.device)
        regimes = []
        for plan, rname in ((0, "direct"), (1, "private")):
            run = lambda: kern.launch_bwd(*bargs, plan=plan)
            _, rel, where = _k7_bwd_within_bound(kern, bargs, run(),
                                                 f"K7 backward {rname} N={N}")
            regimes.append(f"{rname} {_time_back_to_back_ms(run):.4f} ms (off {rel:.3g} "
                           f"of Σ|term|, {where})"
                           + (" (routed)" if plan == routed else ""))
        fb, bb = bound_k7(N, img), bound_k7_bwd(bargs[0], bargs[1], img, bargs[4][0], P["factor"])
        ct = bargs[0]
        counted = (f"{n_fwd} kernel in the profiler" if gated else "not counted here")
        log(f"[10 K7 {name}] N={N}: forward wrapper (one launch, {counted}) {w1:.4f} / "
            f"{w2:.4f} ms, bare launch queued behind a sleep (the card's "
            f"time) {q:.4f} ms, plain eval_emissive {p1:.4f} / {p2:.4f} ms, bound "
            f"{fb[0]:.4g} ms ({fb[1]}), {fb[0] / q:.3f} of it queued")
        log(f"[10 K7 {name}] backward N={N} (nonzero ct {int((ct != 0).any(1).sum())}): "
            f"wrapper ({n_bwd if gated else 'one'} kernel) {b1:.4f} / {b2:.4f} ms, queued "
            f"{bq:.4f} ms, back to "
            f"back {'; '.join(regimes)}; plain backward_reference {r1:.4f} / {r2:.4f} ms; "
            f"index_add_ (same values, same flat bins) {a1:.4f} / {a2:.4f} ms; bound "
            f"{bb[0]:.4g} ms ({bb[1]})")
        out[name] = {"ms": min(w1, w2), "queued_ms": q, "plain_ms": min(p1, p2), "bound": fb,
                     "bwd_ms": min(b1, b2), "bwd_queued_ms": bq, "bwd_plain_ms": min(r1, r2),
                     "bwd_bound": bb, "index_add_ms": min(a1, a2)}
    for name, t in out.items():
        if name in GATED_K7 and t["bwd_ms"] > 1.25 * t["index_add_ms"]:
            raise AssertionError(f"K7's backward at the {name} width {t['bwd_ms']:.4f} ms is "
                                 f"more than 1.25 x index_add_'s {t['index_add_ms']:.4f} ms")
    return out


def phase_k7_step_profile():
    """The device time a call of K7's two launches over one ``PTX_EMK=1``
    demo train step: ``python -m ptx_torch.layer_profile --train --chunks
    1`` under ``PTX_EMK=1``, its trace read back with ``summarize``."""
    from ptx_torch import layer_profile

    out = os.path.join(OUT, "layer_profile")
    with _env(PTX_EMK="1"):
        layer_profile.main(["--train", "--chunks", "1", "--out", out])
    with open(os.path.join(out, "trace_demo_train.json")) as f:
        s = layer_profile.summarize(json.load(f)["traceEvents"])
    log(f"[10 K7 step profile] one PTX_EMK=1 demo train step: K7 forward {s['k7_calls']} "
        f"call(s), {s['k7_mean_us']:.2f} us a call; backward {s['k7_bwd_calls']} call(s), "
        f"{s['k7_bwd_mean_us']:.2f} us a call; emission layer "
        f"{s['layers']['emission']['device_ms']:.3f} ms device, emission_bwd "
        f"{s['layers']['emission_bwd']['device_ms']:.3f} ms")
    if s["k7_calls"] != 1 or s["k7_bwd_calls"] != 1:
        raise AssertionError(f"K7 step profile: {s['k7_calls']} forward and "
                             f"{s['k7_bwd_calls']} backward calls, not 1 each")
    return s


@contextlib.contextmanager
def _env(**kv):
    """The environment variables ``kv`` set for the block, restored after."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)


def _compile_with_emk(root, device):
    """``compile_scene`` with ``PTX_EMK=1`` set around it, as
    tests/test_emission_kernel.py:26-30 does for the JAX package."""
    from ptx_torch.integrate.trace import compile_scene

    with _env(PTX_EMK="1"):
        scene = compile_scene(root, device)
    if scene.emission_fn is None:
        raise AssertionError("PTX_EMK=1 did not build the emission kernel")
    return scene


def _mirror_world():
    """A mirror-ball sky world, as tests/test_emission_kernel.py:87-115."""
    import numpy as np
    from ptx_torch.geom.tape import Sphere
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    probe = np.random.default_rng(7).uniform(0.0, 2.0, (16, 32, 4)).astype(np.float32)
    sky = builders.make_sky_mirror_sphere(probe, scale=(1.5, 1.0, 0.5))
    return builders.union_array([Sphere((0.0, 0.0, -4.0), 1.0,
                                        Material(reflect=0.8, scatter=1.0))]
                                + builders.sky_planes(sky))


# ---------------------------------------------------------------------------
# path D, the large scenes: K5 (megasweep, fused mega bounce) and K6
# ---------------------------------------------------------------------------

def _large_scenes():
    """S1-S4, the JAX package's large-scene ladder at full width."""
    from ptx_torch.scenes import builders

    return {"S1": lambda: builders.stress_spheres(249),
            "S2": lambda: builders.stress_gadgets(112),
            "S3": lambda: builders.stress_spheres(249, transformed=True),
            "S4": lambda: builders.stress_spheres(
                249, sky_image=builders.procedural_sky_image(*PROBE))}


def phase_build_report():
    """D1: registers and stack frame of K1, K4, K5, K6 and K9 (every
    instantiation of a templated kernel: K1's and K4's leaf buckets, K9's
    tiles and sort sizes), from nvcc's report; the SASS instructions of
    every K1 and K4 instantiation (``cuobjdump -sass``)."""
    from ptx_torch.ops import _build

    lines = _build.BUILD_LOG.splitlines()
    out, frames = [], {}
    for label, kname in (("K1", "bounce_forward_kernel"), ("K4", "first_hit_kernel"),
                         ("K5", "megasweep_kernel"), ("K6", "replay_bwd_kernel"),
                         ("K9", "sweep_select_kernel"), ("K9", "sweep_sort_select_kernel")):
        # the mangled entry name, length-prefixed (then E, or I for a
        # template's arguments): not the file's name in it
        tag = f"{len(kname)}{kname}"
        found = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln
                 and (f"{tag}E" in ln or f"{tag}I" in ln)]
        if not found:
            raise AssertionError(f"D1: no ptxas report for {kname}")
        for i in found:
            report = " ".join(ln.strip() for ln in lines[i + 1:i + 4])
            frame = int(report.split(" bytes stack frame")[0].split()[-1])
            frames[label] = max(frames.get(label, 0), frame)
            name = lines[i].split("'")[1]
            out.append(f"{label} {name[name.index(tag) + len(tag):][:12]}: {report}")
    log("[D1 build] " + " | ".join(out))
    log(f"[D1 build] largest stack frame per kernel (bytes): {frames}")
    for label, stem, kname in (("K1", "bounce_kernel", "bounce_forward_kernel"),
                               ("K4", "fasthit_kernel", "first_hit_kernel")):
        counts = sass_counts(stem, kname)
        tag = f"{len(kname)}{kname}"
        log(f"[D1 build] {label} SASS instructions: " + ", ".join(
            f"{n[n.index(tag) + len(tag):][:12]} {c}" for n, c in sorted(counts.items())))
    return frames


def _full_frame_chunk(scene, key):
    """A 65,536-ray chunk over the whole frame: every 4th row of the 512²
    camera (the frame's top rows see only the sky at bounce 0)."""
    from ptx_torch.integrate.camera import Camera, sample_rays

    return sample_rays(Camera.reference_demo(W, H), key, range(0, H, 4), range(W), 1,
                       scene.device)


def phase_k5_chunk(scene, tag, hit_check=False):
    """D2: K5 in bounce mode on every bounce of one compacted 65,536-ray
    chunk (full-frame rows, depth 16), recorded as ``trace_rays`` gives
    them (widths 65,536, 21,845, 4,096, fillers included): against its
    plain version (the sweep + the plain shading, ``bounce_reference``)
    as phase 3 holds K1, and cull on against cull off bit for bit; on every
    bounce K5's lane counters (:func:`_k5_stats`) and its list route
    against the recompute route (list capacities 0) and lists of one, bit
    for bit.  With ``hit_check``, K5 in hit mode against
    ``megasweep_reference`` on the primary rays.  Returns (flips,
    max_abs_err, the first bounce's inputs, the lanes that read a culled
    gadget's live rows)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops.bounce_kernel import bounce_reference

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, rec))
    with torch.no_grad():
        trace_rays(sk, scene.params, o, d, key, DEPTH)
    torch.cuda.synchronize()
    widths = [inputs[0].shape[0] for inputs, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"{tag}: K5 widths {widths}")
    packed = scene.bounce_fn.pack(scene.params)
    flips, err = 0, 0.0
    for b, (inputs, out_k) in enumerate(rec):
        with torch.no_grad():
            out_p = bounce_reference(scene, scene.params, *inputs)
            out_nc = scene.bounce_fn(scene.params, *inputs, packed=packed, cull=False)
        torch.cuda.synchronize()
        if not all(torch.equal(out_k[k], out_nc[k]) for k in out_k):
            raise AssertionError(f"{tag}: bounce {b}: cull on and off differ")
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err = flips + f, max(err, e)
        log(f"[{tag}] bounce {b}: B={widths[b]} alive={int(inputs[4].sum())} "
            f"hit={int(out_k['hit'].sum())} flips={f} max_abs_err={e:.3g}; cull on == off")
    lay = scene.plain_hit_fn.layout
    kern = scene.bounce_fn.kernel
    culled = 0
    for b, (inputs, out_k) in enumerate(rec):
        raw = kern.launch(packed, *inputs[:2], carry=inputs[2:7], in_depth=inputs[7],
                          stats=True)
        log(f"[{tag}] bounce {b} stats: " + _k5_stats(raw["stats"], lay))
        culled += int((raw["stats"][:, 4] > 0).sum())
        # the recompute route (every lane past its capacities) and a list of one
        for caps in ((0, 0), (1, 1)):
            got = kern.launch(packed, *inputs[:2], carry=inputs[2:7], in_depth=inputs[7],
                              caps=caps, stats=True)
            over = int(((got["stats"][:, 5] & 6) != 0).sum())
            if not all(torch.equal(out_k[k], got[k]) for k in out_k):
                raise AssertionError(f"{tag}: bounce {b}: list capacities {caps} differ from "
                                     "the list route")
            if caps == (0, 0) and over != inputs[0].shape[0]:
                raise AssertionError(f"{tag}: bounce {b}: capacity 0 left lanes on the list")
    log(f"[{tag}] every bounce: the recompute route (capacities 0) and lists of one equal to "
        f"the list route bit for bit; lanes with culled gadgets' live rows {culled}")
    inputs = rec[0][0]
    if hit_check:
        hk = scene.hit_fn(scene.params, *inputs[:2])
        with torch.no_grad():
            hp = scene.plain_hit_fn(scene.params, *inputs[:2])
        f, e = compare_hit(scene, *inputs[:2], hk, hp)
        flips, err = flips + f, max(err, e)
        log(f"[{tag}] K5 hit mode vs megasweep_reference on the primary rays: "
            f"hit={int(hk['hit'].sum())} flips={f} max_abs_err={e:.3g}")
    return flips, err, inputs, culled


def _k5_stats(stats, lay):
    """One line of K5's per-lane counters (``MegaSweepKernel.launch``
    with ``stats``): fixpoint passes, active cull flags a warp, the sizes
    of a lane's lists (coverage intervals, rows; counted past their
    capacities), the culled gadgets' member rows pass 1 evaluates, and the
    lanes past each capacity (the recompute route), as mean and
    quantiles."""
    import torch

    st = stats.float()
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0], device=st.device)
    qs = lambda c: "/".join(f"{v:g}" for v in torch.quantile(st[:, c], q).tolist())
    passes = torch.bincount(stats[:, 0].long(), minlength=4)[:4].tolist()
    bits = stats[:, 5]
    return (f"lanes {st.shape[0]}, hit {int((bits & 1).sum())}; fixpoint passes 0/1/2/3 "
            f"{passes}, max {int(st[:, 0].max())}; active cull flags a warp mean "
            f"{float(st[:, 1].mean()):.3f} of {lay.n_flags} ({lay.n_s_clusters} row clusters); "
            f"coverage list mean {float(st[:, 2].mean()):.3f} p50/p90/p99/p99.9/max {qs(2)}; "
            f"row list mean {float(st[:, 3].mean()):.3f} {qs(3)}; culled-gadget rows mean "
            f"{float(st[:, 4].mean()):.3f} max {int(st[:, 4].max())}; lanes past the "
            f"capacities {int(((bits >> 1) & 1).sum())} / {int(((bits >> 2) & 1).sum())}")


def phase_k6_chunk(scene, tag):
    """D3: K6 against its plain versions on every backward bounce of one
    fwd+bwd chunk (the D2 chunk, ``radiance.mean()``): per lane, per leaf
    and ``d_params`` as phase 5 holds K2; two launches the same bits."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.trace import trace_rays

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    trace_rays(_recording_bwd(scene, rec), _leaf_params(scene.params), o, d, key,
               DEPTH).mean().backward()
    torch.cuda.synchronize()
    widths = sorted((r[0].shape[0] for r in rec), reverse=True)
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH - 1):
        raise AssertionError(f"{tag}: K6 widths {widths}")
    err = _check_k2(scene, rec, tag, name="K6")
    return err, next(r for r in rec if r[0].shape[0] == BAND_ROWS * W)


class _WidestBwd:
    """A K6 wrapper that keeps the inputs of its calls at ``width`` lanes."""

    def __init__(self, kern, width):
        self.kern, self.width, self.calls = kern, width, []

    def __getattr__(self, name):
        return getattr(self.kern, name)

    def __call__(self, packed, o, d, thr, dec, *cts):
        if o.shape[0] == self.width:
            self.calls.append((o, d, thr, dec, cts))
        return self.kern(packed, o, d, thr, dec, *cts)


def phase_train_large(scene, tag, expect, keep_widest=False):
    """D5: 3 ``make_train_step`` steps at 512², spp 16, depth 16 with exact
    launch counts; with ``keep_widest``, the K6 inputs at 4,194,304 lanes."""
    widest = _WidestBwd(scene.bounce_bwd_fn, W * H * SPP) if keep_widest else None
    cm = _swapped(scene, "bounce_bwd_fn", widest) if keep_widest else None
    c, secs, peak, _ = phase_train(scene, tag, expect, cm)
    return c, secs, peak, (widest.calls[0] if keep_widest else None)


def phase_render_scene(tag, kernel="K5"):
    """D6 (E4): ``python -m ptx_torch render --scene scenes/composed.json``
    (512², spp 16, depth 8 from the spec) through ``ptx_torch.cli.main``,
    counters zeroed just before: ``kernel`` (K5; K9 under
    ``PTX_SWEEP_MODE=kernel PTX_MEGAB=0``) 4 bands × 16 samples × 9
    bounces, tile ordering on in every ``trace_rays`` call, nothing
    else."""
    import numpy as np
    import torch
    from ptx_torch import cli
    from ptx_torch.integrate import trace

    _reset_counters()
    tiled = trace.TILE_ORDERED
    t0 = time.perf_counter()
    frame = cli.main(["render", "--scene", os.path.join(ROOT, "scenes", "composed.json"),
                      "--device", "cuda", "--out", os.path.join(OUT, "smoke_composed")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    tiled = trace.TILE_ORDERED - tiled
    spp, depth = 16, 8
    expect = _expect(**{kernel: (H // BAND_ROWS) * spp * (depth + 1)},
                     SB=(H // BAND_ROWS) * spp)
    rays = W * H * spp * (depth + 1)
    log(f"[{tag}] render --scene scenes/composed.json {W}x{H} spp {spp} depth {depth}: wall "
        f"{wall:.3f} s incl. scene compile and image writes, {rays / wall:.4g} rays/s; "
        f"launches {c} (expected {expect}); tile-ordered trace_rays calls {tiled} of "
        f"{(H // BAND_ROWS) * spp}; image mean {float(frame.mean()):.6g}")
    if frame.shape != (H, W, 3) or not np.isfinite(frame).all() or not frame.mean() > 0:
        raise AssertionError(f"{tag}: render is not a finite, non-black (H, W, 3) image")
    if c != expect or tiled != (H // BAND_ROWS) * spp:
        raise AssertionError(f"{tag}: launches {c} or tiled calls {tiled} off")
    return rays / wall


def bound_k5(B, n_rows):
    """K5 in bounce mode at B lanes: reads o, d, thr, strength, alive,
    u_coin, u3 (57 B), writes t, o2, d2, thr2, strength2, u_sel, evt
    (56 B), five decision bytes and mat_id (int64); operations: one
    unculled pass of interval arithmetic, ~25 per (row, ray)."""
    return _bound(126 * B, 25 * n_rows * B)


def phase_timing_large(scene, tag, k5_in, k6_in, k6_wide):
    """D7: K5 (wrapper, bare launch, plain) at 65,536 lanes; K6 at 65,536
    lanes as K2 in phase 10 (the per-bounce wrapper, the bare launch, the
    plain lanes + fold, the whole-bounce plain, the once-per-call pack +
    VJP, and a step's 16 wrappers + one pack + VJP beside 16 per-bounce
    params routes) and its bare launch at 4,194,304 lanes; in turns plain,
    kernel, kernel, plain."""
    from ptx_torch.ops import bounce_kernel as bk

    inputs = k5_in
    packed = scene.bounce_fn.pack(scene.params)
    k5 = lambda: scene.bounce_fn(scene.params, *inputs, packed=packed)
    k5p = lambda: bk.bounce_reference(scene, scene.params, *inputs)
    k5b = lambda: scene.bounce_fn.kernel.launch(packed, *inputs[:2], carry=inputs[2:7],
                                                in_depth=True)
    p1, w1, w2, p2 = _time_ms(k5p), _time_ms(k5), _time_ms(k5), _time_ms(k5p)
    b1, b2 = _time_back_to_back_ms(k5b), _time_back_to_back_ms(k5b)
    bq = _time_queued_ms(k5b)
    B = inputs[0].shape[0]
    lay = scene.plain_hit_fn.layout
    k5_bound = bound_k5(B, lay.ns + lay.npl)
    step = _step_bound(bound_k5, lay.ns + lay.npl)
    log(f"[{tag}] K5 bounce mode at B={B} (L={lay.L}, {lay.ns + lay.npl} rows): wrapper "
        f"{w1:.4f} / {w2:.4f} ms; bare launch {b1:.4f} / {b2:.4f} ms (mean of 20 back to "
        f"back), queued behind a sleep (the card's time) {bq:.4f} ms; plain {p1:.4f} / "
        f"{p2:.4f} ms; bound {k5_bound[0]:.4g} ms ({k5_bound[1]}), summed over a train "
        f"step's widths {step[0]:.4g} ms ({step[1]})")
    kern = scene.bounce_bwd_fn
    o, d, thr, dec, cts = k6_in
    vec = kern.pack(scene.params).detach()
    d_packed = kern(vec, o, d, thr, dec, *cts)[3]
    k6 = lambda: kern(vec, o, d, thr, dec, *cts)
    k6p = lambda: kern.reference(vec, o, d, thr, dec, *cts)
    k6b = lambda: kern.launch(vec, o, d, thr, dec, *cts)
    whole = lambda: bk.bounce_bwd_reference(scene, scene.params, o, d, thr, dec, *cts)
    pack_vjp = lambda: kern.params_grad(*kern.pack_leaves(scene.params), d_packed)
    route = lambda: kern.params_grad(*kern.pack_leaves(scene.params),
                                     kern(vec, o, d, thr, dec, *cts)[3])
    q1, a1 = _time_ms(k6p), _time_ms(whole)
    v1, v2 = _time_ms(k6), _time_ms(k6)
    u1, r1, r2, u2 = _time_ms(pack_vjp), _time_ms(route), _time_ms(route), _time_ms(pack_vjp)
    c1, c2 = _time_back_to_back_ms(k6b), _time_back_to_back_ms(k6b)
    c3 = _time_queued_ms(k6b)
    a2, q2 = _time_ms(whole), _time_ms(k6p)
    step_new, step_old = DEPTH * min(v1, v2) + min(u1, u2), DEPTH * min(r1, r2)
    cont = int((dec["take_transmit"] | dec["scatter_alive"]).sum())
    k6_bound = bound_k2(o.shape[0], cont, vec.numel())
    wide = ""
    if k6_wide is not None:
        o2, d2, thr2, dec2, cts2 = k6_wide
        wb = _time_back_to_back_ms(lambda: kern.launch(vec, o2, d2, thr2, dec2, *cts2))
        wbound = bound_k2(o2.shape[0], int((dec2["take_transmit"] | dec2["scatter_alive"]).sum()),
                          vec.numel())
        wide = (f"; bare launch at B={o2.shape[0]} {wb:.4f} ms, bound {wbound[0]:.4g} ms "
                f"({wbound[1]})")
    log(f"[{tag}] K6 at B={o.shape[0]} (continuing {cont}, L={len(kern.leaves)}): "
        f"per-bounce wrapper {v1:.4f} / {v2:.4f} ms; bare launch {c1:.4f} / {c2:.4f} ms, "
        f"queued behind a sleep (the card's time) {c3:.4f} ms; "
        f"plain (lanes + fold) {q1:.4f} / {q2:.4f} ms; whole-bounce plain (autograd of the "
        f"replay to the params) {a1:.4f} / {a2:.4f} ms; bound {k6_bound[0]:.4g} ms "
        f"({k6_bound[1]}){wide}")
    log(f"[{tag}] K6 pack + VJP once per trace_rays call {u1:.4f} / {u2:.4f} ms; "
        f"per-bounce params route (launch + pack + VJP) {r1:.4f} / {r2:.4f} ms; a step's "
        f"{DEPTH} backward bounces: {DEPTH} wrappers + one pack + VJP {step_new:.4f} ms, "
        f"{DEPTH} x the per-bounce params route {step_old:.4f} ms")
    return ((min(w1, w2), min(p1, p2), k5_bound, min(b1, b2), bq),
            (min(v1, v2), min(q1, q2), k6_bound, min(c1, c2), min(u1, u2), step_new,
             step_old))


# ---------------------------------------------------------------------------
# path E, the union sweep's other modes: K9 (sweep select), the local fold,
# the candidate-blocked hit
# ---------------------------------------------------------------------------

SPP_E = 4               # path E's train steps: 1,048,576 rays (module docstring)
K9_OUTPUTS = ("t_star", "entering", "m_start", "m_end", "found")
_STRESS_SKY = dict(reflect=0.0, scatter=0.0, emissive=(0.7, 0.8, 1.0))


def _bitten_union(n=48):
    """``n`` spheres with four spherical bites each (``Difference(sphere,
    Union(4 bites))``, past the megasweep's slot algebra) in a jittered
    grid over the ground plane under the stress sky: ``5n + 7`` leaves."""
    import math

    import numpy as np
    from ptx_torch.geom.tape import Difference, Plane, Sphere, Union
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    diffuse = [Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
               Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)]
    r = np.random.default_rng(5)
    side = max(1, int(math.ceil(math.sqrt(n))))
    gadgets = []
    for i in range(n):
        rad = r.uniform(0.3, 0.5)
        c = np.array([(i % side - (side - 1) / 2) * 1.4 + r.uniform(-0.2, 0.2), -1.0 + rad,
                      -3.0 - (i // side) * 1.4 + r.uniform(-0.2, 0.2)])
        bites = [Sphere(c + 0.8 * rad * np.array([math.cos(a), 0.4, math.sin(a)]), 0.45 * rad,
                        diffuse[(i + 1) % 2]) for a in (0.3, 1.9, 3.5, 5.1)]
        gadgets.append(Difference(Sphere(c, rad, diffuse[i % 2]), Union(*bites)))
    return builders.union_array([*gadgets, Plane((0.0, 1.0, 0.0), 1.0,
                                                 Material(reflect=0.6, scatter=1.0)),
                                 *builders.sky_planes(Material(**_STRESS_SKY))])


def _carved_tape():
    """``Union(Intersection(big sphere, union_array(64 spheres)), ground,
    sky planes)``: 72 leaves, no union of small groups."""
    import numpy as np
    from ptx_torch.geom.tape import Intersection, Plane, Sphere, Union
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    m = Material(reflect=(0.7, 0.5, 0.3), scatter=0.5)
    r = np.random.default_rng(9)
    balls = [Sphere((r.uniform(-2, 2), r.uniform(-1, 1.5), r.uniform(-7, -3)),
                    r.uniform(0.3, 0.7), m) for _ in range(64)]
    return Union(Intersection(Sphere((0.0, 0.0, -5.0), 2.2, m), builders.union_array(balls)),
                 Plane((0.0, 1.0, 0.0), 1.0, Material(reflect=0.6, scatter=1.0)),
                 *builders.sky_planes(Material(**_STRESS_SKY)))


def _sweep_scenes():
    """Path E's worlds and the environment each compiles under."""
    from ptx_torch.scenes import builders

    kernel = dict(PTX_SWEEP_MODE="kernel", PTX_MEGAB="0")
    return {"S1": (lambda: builders.stress_spheres(249), kernel),
            "S2": (lambda: builders.stress_gadgets(112), kernel),
            "bitten": (_bitten_union, dict(PTX_SWEEP_MODE="kernel")),
            "bitten-default": (_bitten_union, {}),
            "carved": (_carved_tape, {})}


def _compile_e(name, dev):
    from ptx_torch.geom import fasthit
    from ptx_torch.integrate.trace import compile_scene

    make, env = _sweep_scenes()[name]
    with _env(**env):
        scene = compile_scene(make(), dev)
    want = {"bitten-default": (fasthit.UnionSweepHit, "fixpoint"),
            "carved": (fasthit.BlockedHit, None)}.get(name, (fasthit.UnionSweepHit, "kernel"))
    if not isinstance(scene.hit_fn, want[0]) or getattr(scene.hit_fn, "mode", None) != want[1]:
        raise AssertionError(f"E {name}: hit {type(scene.hit_fn).__name__} "
                             f"{getattr(scene.hit_fn, 'mode', '')}, expected {want}")
    return scene


def _plain_select(s, e, t0, t1, L, eps, sort=False):
    """K9's plain version in the wrapper's place (the plain path of E2)."""
    from ptx_torch.ops import sweep_kernel

    return sweep_kernel.sweep_select_reference(s, e, t0, t1, L, eps, sort)


def phase_k9_chunk(scene, tag, k5_check):
    """E1: the kernel-mode sweep on every bounce of one compacted 65,536-ray
    chunk (the D2 chunk: widths 65,536 / 21,845 / 4,096), each hit's
    intervals recomputed from its rays: K9 ``sort=False`` (on the
    stable-sorted starts) and K9 ``sort=True`` (on the unsorted valid-masked
    intervals, as kernel mode calls it) against ``sweep_select_reference``,
    0 differing lanes in all
    five outputs; the whole hit equal to the ``fixpoint`` and ``sort``
    modes' bit for bit; with ``k5_check``, equal to K5's plain version
    (``megasweep_reference``) except float64-adjudicated near-ties.
    Returns (lanes compared, K9's max_abs_err against its plain version,
    flips vs K5's plain version, max_abs_err of the hits' floats against it,
    the fixpoint passes per bounce)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.core.constants import EPS
    from ptx_torch.geom import fasthit
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.ops import sweep_kernel

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    rec = []
    with _swapped(scene, "hit_fn", _RecordingHit(scene.hit_fn, rec)), torch.no_grad():
        trace_rays(scene, scene.params, o, d, key, DEPTH)
    torch.cuda.synchronize()
    widths = [ob.shape[0] for ob, _, _ in rec]
    if widths != _wavefront_widths(BAND_ROWS * W, DEPTH):
        raise AssertionError(f"{tag}: hit widths {widths}")
    hit = scene.hit_fn
    other = {m: fasthit.UnionSweepHit(scene.plan, hit.leaves, m) for m in ("fixpoint", "sort")}
    mega = (fasthit.compile_fast_hit(scene.plan, scene.params, sweep_mode="mega")
            if k5_check else None)
    lanes, k9_err, flips, err, passes = 0, 0.0, 0, 0.0, []
    for b, (ob, db, out_k) in enumerate(rec):
        with torch.no_grad():
            t0, t1, s, e = hit.intervals(scene.params, ob, db)
            s_s, idx = torch.sort(s, dim=0, stable=True)
            e_s = e.gather(0, idx)
            want = sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, hit.L, EPS, False)
            got = {"sort=False": sweep_kernel.launch(s_s, e_s, t0, t1, hit.L, EPS, False),
                   "sort=True": sweep_kernel.launch(s, e, t0, t1, hit.L, EPS, True)}
            modes = {m: h(scene.params, ob, db) for m, h in other.items()}
        torch.cuda.synchronize()
        for flag, g in got.items():
            bad = {n: int((a != w).sum()) for n, a, w in zip(K9_OUTPUTS, g, want)}
            if any(bad.values()):
                raise AssertionError(f"{tag}: bounce {b}: K9 {flag} differs from its plain "
                                     f"version on {bad} lanes")
            k9_err = max([k9_err] + [float((a.double() - w.double()).abs().max())
                                     for a, w in zip(g, want)])
        for m, out in modes.items():
            if not all(torch.equal(out_k[k], out[k]) for k in out_k):
                raise AssertionError(f"{tag}: bounce {b}: kernel mode differs from {m} mode")
        passes.append(other["fixpoint"].last_passes)
        lanes += ob.shape[0]
        msg = ""
        if mega is not None:
            with torch.no_grad():
                out_p = mega(scene.params, ob, db)
            torch.cuda.synchronize()
            f, e_ = compare_hit(scene, ob, db, out_k, out_p, name=f"{tag} vs K5 plain")
            flips, err = flips + f, max(err, e_)
            msg = f"; vs K5's plain version: flips={f} max_abs_err={e_:.3g}"
        log(f"[{tag}] bounce {b}: B={ob.shape[0]} S={s.shape[0]} L={hit.L} "
            f"hit={int(out_k['hit'].sum())} entering={int(out_k['entering'].sum())}: K9 "
            f"sort=False and sort=True == plain on every lane of all five outputs; kernel "
            f"== fixpoint == sort mode bit for bit; fixpoint passes {passes[-1]}{msg}")
    return lanes, k9_err, flips, err, passes


def _chain(n=12):
    """``n`` unit spheres in a row, each overlapping the next, over the ground
    under the stress sky (tests/test_torch_sweep.py ``chain``)."""
    from ptx_torch.geom.tape import Plane, Sphere
    from ptx_torch.scenes import builders
    from ptx_torch.shade.materials import Material

    m = [Material(reflect=(0.8, 0.3, 0.3), scatter=1.0),
         Material(reflect=(0.3, 0.8, 0.3), scatter=1.0)]
    return builders.union_array([Sphere((0.3 * i, 0.0, -2.0 - 1.6 * i), 1.0, m[i % 2])
                                 for i in range(n)]
                                + [Plane((0.0, 1.0, 0.0), 1.0, Material(reflect=0.6, scatter=1.0)),
                                   *builders.sky_planes(Material(**_STRESS_SKY))])


def phase_k9_chain(dev):
    """E1's multi-hop chains: 65,536 rays from inside the first sphere of
    :func:`_chain` down the row, through the sweep in kernel mode (K9, the
    route of ``sweep_kernel.sort_inside``): K9 with both flags against
    ``sweep_select_reference`` bit for bit, the hit equal to the
    ``fixpoint`` and ``sort`` modes' bit for bit, and the fixpoint taking
    more than one pass.  Returns (K9's max_abs_err, the passes)."""
    import numpy as np
    import torch
    from ptx_torch.core.constants import EPS
    from ptx_torch.geom import fasthit
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.ops import sweep_kernel

    scene = compile_scene(_chain(), dev)
    leaves = fasthit.collect_leaves(scene.plan)
    hits = {m: fasthit.UnionSweepHit(scene.plan, leaves, m) for m in ("kernel", "fixpoint", "sort")}
    g = np.random.default_rng(3)
    n = BAND_ROWS * W
    o = np.array([0.0, 0.0, -2.0]) + g.uniform(-0.3, 0.3, (n, 3))
    d = np.stack([g.uniform(0.1, 0.25, n), g.uniform(-0.05, 0.05, n), -np.ones(n)], -1)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (o, d))
    with torch.no_grad():
        t0, t1, s, e = hits["kernel"].intervals(scene.params, o, d)
        s_s, idx = torch.sort(s, dim=0, stable=True)
        e_s = e.gather(0, idx)
        L = hits["kernel"].L
        want = sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, L, EPS, False)
        got = {"sort=False": sweep_kernel.launch(s_s, e_s, t0, t1, L, EPS, False),
               "sort=True": sweep_kernel.launch(s, e, t0, t1, L, EPS, True)}
        outs = {m: h(scene.params, o, d) for m, h in hits.items()}
    torch.cuda.synchronize()
    err = 0.0
    for flag, gk in got.items():
        bad = {nm: int((a != w).sum()) for nm, a, w in zip(K9_OUTPUTS, gk, want)}
        if any(bad.values()):
            raise AssertionError(f"E1 chain: K9 {flag} differs from its plain version on {bad}")
        err = max([err] + [float((a.double() - w.double()).abs().max()) for a, w in zip(gk, want)])
    for m in ("fixpoint", "sort"):
        if not all(torch.equal(outs["kernel"][k], v) for k, v in outs[m].items()):
            raise AssertionError(f"E1 chain: kernel mode differs from {m} mode")
    passes = hits["fixpoint"].last_passes
    if passes < 2:
        raise AssertionError(f"E1 chain: the fixpoint took {passes} pass, not several")
    log(f"[E1 chain] {len(leaves)} leaves, B={n} S={s.shape[0]} from inside the first sphere: "
        f"hit {int(outs['kernel']['hit'].sum())}; K9 sort=False and sort=True == plain on every "
        f"lane; kernel == fixpoint == sort mode bit for bit; fixpoint passes {passes}")
    return err, passes


def bound_k9(s, L, out, sort):
    """K9 on one input: reads s, e (S rows) and the payload rows this run's
    lanes need (the serial loop's: t0 up to its match and t1 up to its,
    both up to the later match, all L where one is missing), writes its
    outputs once (14 B a lane); operations: ~6 compares and selects per
    (row, lane) of the sweep, 1 per payload row, and with ``sort`` ~5 per
    compare-exchange of the bitonic network over each lane's rows with s <
    2e20 (padded to a power of 2 of at least 32)."""
    import torch

    S, B = s.shape
    ms, me = out[2].long(), out[3].long()
    stop = torch.where((ms < L) & (me < L), torch.maximum(ms, me) + 1, L)
    rows = lambda m: torch.where(m < L, torch.minimum(m + 1, stop), stop)
    n_pay = int(rows(ms).sum() + rows(me).sum())
    ops = 6 * S * B + n_pay
    if sort:
        n = (s < 2e20).sum(0)
        n32 = torch.clamp(2 ** torch.ceil(torch.log2(torch.clamp(n, min=1).double())), min=32)
        lg = torch.log2(n32)
        ops += int((5 * n32 / 2 * lg * (lg + 1) / 2 * (n > 0)).sum())
    return _bound(2 * S * B * 4 + n_pay * 4 + 14 * B, ops)


def record_select_inputs(scene, spp=SPP_E):
    """The inputs ``(t0, t1, s, e)`` of the sweep's ``select`` (the first
    call of each width) over E1's chunk (65,536 / 21,845 / 4,096 lanes) and
    one ``make_train_step`` step at 512², ``spp``, depth 16 (E3's step:
    1,048,576 / 349,525 / 65,536 lanes), keyed by width; and the hit."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.trace import trace_rays
    from ptx_torch.parallel.render import _local_render, make_train_step

    hit, rec = scene.hit_fn, {}
    select = hit.select

    def recording(t0, t1, s, e):
        rec.setdefault(s.shape[1], (t0, t1, s, e))
        return select(t0, t1, s, e)

    key = rng.fold(rng.PRNGKey(0), 0, 4)
    o, d = _full_frame_chunk(scene, key)
    cam = Camera.reference_demo(W, H)
    with torch.no_grad():
        target = _local_render(scene, cam, DEPTH, spp, scene.params, rng.PRNGKey(1), 0, H)
    step = make_train_step(scene, cam, spp=spp, depth=DEPTH, learning_rate=LR)
    with _swapped(hit, "select", recording):
        with torch.no_grad():
            trace_rays(scene, scene.params, o, d, key, DEPTH)
        step(scene.params, target, rng.PRNGKey(2))
    torch.cuda.synchronize()
    del target
    return rec, hit


def phase_timing_k9(tag, rec, hit):
    """E5: K9 at every width of E1's chunk and E3's step on the recorded
    inputs (:func:`record_select_inputs`).  Both flags against
    ``sweep_select_reference`` bit for bit; K9 as the sweep calls it (``hit``'s
    ``select`` in kernel mode: the route of ``sweep_kernel.sort_inside``) and
    the plain version (the ``sort`` mode's select), each the median of 20
    single calls between CUDA events; the bare launch with ``sort=False`` on
    the stable-sorted rows and ``sort=True`` on the unsorted ones, each back
    to back (mean of 20) and queued behind a device sleep (the card's time);
    the ``torch.sort`` + ``gather`` + ``sort=False`` route and ``torch.sort``
    alone; the bound of each flag at each width and summed over E3's 17
    calls.  Returns ({width: figures}, step sums)."""
    import torch
    from ptx_torch.core.constants import EPS
    from ptx_torch.ops import sweep_kernel

    L, out, step = hit.L, {}, {}
    for B in sorted(rec, reverse=True):
        t0, t1, s, e = rec[B]
        S = s.shape[0]
        with torch.no_grad():
            s_s, idx = torch.sort(s, dim=0, stable=True)
            e_s = e.gather(0, idx)
            want = sweep_kernel.sweep_select_reference(s_s, e_s, t0, t1, L, EPS, False)
            outs = {}
            for flag, args in ((False, (s_s, e_s)), (True, (s, e))):
                outs[flag] = sweep_kernel.launch(*args, t0, t1, L, EPS, flag)
                torch.cuda.synchronize()
                bad = {n: int((a != w).sum()) for n, a, w in zip(K9_OUTPUTS, outs[flag], want)}
                if any(bad.values()):
                    raise AssertionError(f"{tag}: K9 sort={flag} differs from its plain "
                                         f"version at B={B} on {bad} lanes")
            bare = {False: lambda: sweep_kernel.launch(s_s, e_s, t0, t1, L, EPS, False,
                                                       out=outs[False]),
                    True: lambda: sweep_kernel.launch(s, e, t0, t1, L, EPS, True,
                                                      out=outs[True])}

            def route_a():
                a, i = torch.sort(s, dim=0, stable=True)
                return sweep_kernel.launch(a.contiguous(), e.gather(0, i), t0, t1, L, EPS,
                                           False)

            wrap = lambda: hit.select(t0, t1, s, e)
            plain = lambda: sweep_kernel.sweep_select_reference(s, e, t0, t1, L, EPS, True)
            p1, w1, w2, p2 = _time_ms(plain), _time_ms(wrap), _time_ms(wrap), _time_ms(plain)
            b0, b1 = _time_back_to_back_ms(bare[False]), _time_back_to_back_ms(bare[True])
            q0, q1 = _time_queued_ms(bare[False]), _time_queued_ms(bare[True])
            ra, srt = _time_ms(route_a), _time_ms(lambda: torch.sort(s, dim=0, stable=True))
            bounds = {f: bound_k9(s, L, want, f) for f in (False, True)}
        del want
        out[B] = dict(S=S, wrapper_ms=min(w1, w2), plain_ms=min(p1, p2), bare_sort_false_ms=b0,
                      bare_sort_true_ms=b1, queued_sort_false_ms=q0, queued_sort_true_ms=q1,
                      torch_sort_route_ms=ra, torch_sort_ms=srt,
                      bound_sort_false=bounds[False], bound_sort_true=bounds[True],
                      sort_inside=sweep_kernel.sort_inside(S))
        log(f"[{tag}] K9 at B={B} (S={S}, L={L}; kernel mode sorts "
            f"{'inside K9' if out[B]['sort_inside'] else 'with torch.sort'}): == plain with "
            f"both flags; as the sweep calls it {w1:.4f} / {w2:.4f} ms, plain {p1:.4f} / "
            f"{p2:.4f} ms; bare sort=False {b0:.4f} ms back to back, {q0:.4f} ms queued "
            f"(bound {bounds[False][0]:.4g} ms, {bounds[False][1]}: {bounds[False][0] / q0:.3f} "
            f"of it); bare sort=True {b1:.4f} / {q1:.4f} ms (bound {bounds[True][0]:.4g} ms, "
            f"{bounds[True][1]}: {bounds[True][0] / q1:.3f}); torch.sort + gather + sort=False "
            f"{ra:.4f} ms, torch.sort alone {srt:.4f} ms")
    widths = _wavefront_widths(W * H * SPP_E, DEPTH)
    if all(B in out for B in widths):
        for k in ("queued_sort_false_ms", "queued_sort_true_ms", "torch_sort_route_ms"):
            step[k] = sum(out[B][k] for B in widths)
        for f in (False, True):
            step[f"bound_sort_{str(f).lower()}_ms"] = sum(out[B][f"bound_sort_{str(f).lower()}"][0]
                                                         for B in widths)
        log(f"[{tag}] summed over E3's step ({len(widths)} calls at widths "
            f"{sorted(set(widths), reverse=True)}): queued sort=False "
            f"{step['queued_sort_false_ms']:.4f} ms (bound {step['bound_sort_false_ms']:.4f}), "
            f"sort=True {step['queued_sort_true_ms']:.4f} ms (bound "
            f"{step['bound_sort_true_ms']:.4f}); the torch.sort route "
            f"{step['torch_sort_route_ms']:.4f} ms")
    chunk = _wavefront_widths(BAND_ROWS * W, DEPTH)
    if all(B in out for B in chunk):
        for f in ("false", "true"):
            step[f"chunk_mean_queued_sort_{f}_us"] = 1e3 * sum(
                out[B][f"queued_sort_{f}_ms"] for B in chunk) / len(chunk)
        log(f"[{tag}] a chunk's mean a call (queued, {len(chunk)} calls): sort=False "
            f"{step['chunk_mean_queued_sort_false_us']:.2f} us, sort=True "
            f"{step['chunk_mean_queued_sort_true_us']:.2f} us")
    return out, step


def walk_visits(scene, o, d, out):
    """Per lane of one hit: the distinct event times at or past EPS (below
    the miss padding) up to the first boundary, all of them on a lane
    without one: the iterations of a fold that visits events in time
    order."""
    import torch
    from ptx_torch.core.constants import EPS
    from ptx_torch.geom import fasthit

    with torch.no_grad():
        t0, t1, _, _ = fasthit._leaf_intervals(fasthit.collect_leaves(scene.plan),
                                               scene.params, *o.unbind(-1), *d.unbind(-1))
        T = torch.sort(torch.cat([t0, t1]), dim=0).values
        new = torch.ones_like(T, dtype=torch.bool)
        new[1:] = T[1:] != T[:-1]
        lim = torch.where(out["hit"], out["t"], torch.full_like(out["t"], float("inf")))
        return (new & (T >= EPS) & (T < 3e20) & (T <= lim[None])).sum(0)


def visits_histogram(counts):
    """``{visits: lanes}`` of :func:`walk_visits`'s counts."""
    import torch

    v, n = torch.unique(counts.cpu(), return_counts=True)
    return {int(a): int(b) for a, b in zip(v, n)}


def sass_counts(stem, kname):
    """SASS instructions of every instantiation of kernel ``kname`` in the
    built library ``stem`` (``cuobjdump -sass``), by mangled name."""
    import re
    import shutil

    from ptx_torch.ops import _build

    so = max(_build._BUILD.glob(f"{stem}-*.so"), key=os.path.getmtime)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, fn = {}, None
    for ln in txt.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            fn = fn if f"{len(kname)}{kname}" in fn else None
            if fn:
                counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            counts[fn] += 1
    return counts


def run_path_e(dev):
    """Path E (module docstring); returns what the summary and the kernels
    line read."""
    from ptx_torch.ops import sweep_kernel

    lanes, k9_err, flips, trainE = 0, 0.0, 0, {}
    for nm in ("S1", "S2", "bitten"):
        sc = _compile_e(nm, dev)
        n, e9, f, _, passes = _timed(f"E1 {nm} K9 chunk", phase_k9_chunk, sc,
                                     f"E1 {nm} K9 vs plain", nm != "bitten")
        lanes, k9_err, flips = lanes + n, max(k9_err, e9), flips + f
        log(f"[E1 {nm}] fixpoint passes per bounce {passes}")
        del sc
    e9, _ = _timed("E1 chain", phase_k9_chain, dev)
    k9_err = max(k9_err, e9)
    for nm, cm in (("S2", _swapped(sweep_kernel, "sweep_select", _plain_select)),
                   ("bitten-default", None), ("carved", None)):
        sc = _compile_e(nm, dev)
        _timed(f"E2 {nm} gradients", phase_gradients, sc, f"E2 {nm} gradients", cm)
        del sc
    for nm in ("S1", "S2", "bitten", "bitten-default", "carved"):
        sc = _compile_e(nm, dev)
        k9 = {"K9": 3 * (DEPTH + 1)} if getattr(sc.hit_fn, "mode", None) == "kernel" else {}
        trainE[nm] = _timed(f"E3 {nm} train", phase_train, sc, f"E3 {nm} train",
                            _expect(k6_steps=3, K6=3 * DEPTH, **k9), None, SPP_E)
        del sc
    with _env(PTX_SWEEP_MODE="kernel", PTX_MEGAB="0"):
        rays_s = _timed("E4 render --scene", phase_render_scene, "E4 render --scene", "K9")
    timeE = {}
    for nm in ("S1", "S2"):
        sc = _compile_e(nm, dev)
        rec, hit = _timed(f"E5 {nm} record", record_select_inputs, sc)
        timeE[nm] = _timed(f"E5 {nm} timing", phase_timing_k9, f"E5 {nm} timing", rec, hit)
        del sc, rec, hit
    return lanes, k9_err, flips, trainE, rays_s, timeE


# ---------------------------------------------------------------------------
# path F: the CLI's other render modes on the demo (K1), and serve / farm
# ---------------------------------------------------------------------------

F_SPP = 4                       # F1's first checkpoint run, then resumed to 2 × F_SPP
FARM_TILE, FARM_SPP, FARM_CHUNK = 64, 4, 16


def _cli_render(tag, argv, expect, stdout=None):
    """``ptx_torch.cli.main(argv)`` with the counters zeroed just before
    (its standard output into ``stdout`` where given): ``(frame, wall
    seconds)``; fails unless the counts are ``expect``."""
    import torch
    from ptx_torch import cli

    _reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout or sys.stdout):
        frame = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counters()
    log(f"[{tag}] {' '.join(argv)}: wall {wall:.3f} s incl. scene compile and writes; "
        f"launches {c} (expected {expect}); image mean {float(frame.mean()):.6g}")
    if c != expect:
        raise AssertionError(f"{tag}: launches {c}, expected {expect}")
    return frame, wall


def _same_image(tag, got, want, what):
    """Within ``rtol 1e-6, atol 1e-7``; logs whether the two are bit-equal."""
    import numpy as np

    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{tag}: {what}")
    log(f"[{tag}] {what}: {'bit-equal' if np.array_equal(got, want) else 'max abs diff ' + format(float(np.abs(got - want).max()), '.3g')}")


def _f_args(*extra):
    return ["render", "--demo", "demo", "--width", str(W), "--height", str(H), "--depth",
            str(DEPTH), "--device", "cuda", *extra]


def phase_f1_checkpoint():
    """F1: ``render --checkpoint X --spp 4``, then the same to ``--spp 8``
    (resumed), an uninterrupted ``--spp 8 --checkpoint Y`` and the fast
    path's ``--spp 8``: K1 17 × 4 bands × the samples each renders; the
    resumed image equals the uninterrupted one and the fast path's (the
    same keys); one ``--preview`` render at spp 4 writes its half-block
    frame and renders the first run's image.  Returns (rays/s of the
    uninterrupted checkpoint run, max abs diff, K1 launches)."""
    import io as _io
    from ptx_torch.parallel.checkpoint import RenderAccumulator

    bands = H // BAND_ROWS
    x, y = os.path.join(OUT, "f1_x.npz"), os.path.join(OUT, "f1_y.npz")
    for p in (x, y):
        if os.path.exists(p):
            os.remove(p)
    out = ["--out", os.path.join(OUT, "smoke_f1")]
    first, _ = _cli_render("F1 checkpoint", _f_args("--spp", str(F_SPP), "--checkpoint", x,
                                                    *out), _expect_demo(bands * F_SPP))
    done = [RenderAccumulator(H, W, x).samples_done]
    resumed, _ = _cli_render("F1 resume", _f_args("--spp", str(2 * F_SPP), "--checkpoint", x,
                                                  *out), _expect_demo(bands * F_SPP))
    done.append(RenderAccumulator(H, W, x).samples_done)
    if done != [F_SPP, 2 * F_SPP]:
        raise AssertionError(f"F1: samples_done {done}, expected {[F_SPP, 2 * F_SPP]}")
    whole, wall = _cli_render("F1 uninterrupted", _f_args(
        "--spp", str(2 * F_SPP), "--checkpoint", y, *out), _expect_demo(bands * 2 * F_SPP))
    fast, _ = _cli_render("F1 fast path", _f_args("--spp", str(2 * F_SPP), *out),
                          _expect_demo(bands * 2 * F_SPP))
    _same_image("F1", resumed, whole, "resumed vs uninterrupted")
    _same_image("F1", fast, whole, "fast path vs uninterrupted")
    buf = _io.StringIO()
    preview, _ = _cli_render("F1 preview", _f_args("--spp", str(F_SPP), "--preview", *out),
                             _expect_demo(bands * F_SPP), stdout=buf)
    text = buf.getvalue()
    frames, per_frame = text.count("\x1b[H\x1b[2J"), min(80, W) * (min(44, H - H % 2) // 2)
    if frames != bands * F_SPP or text.count("▀") != frames * per_frame:
        raise AssertionError(f"F1 preview: {frames} frames, {text.count('▀')} half blocks")
    _same_image("F1", preview, first, "preview vs checkpoint")
    rays = W * H * 2 * F_SPP * (DEPTH + 1)
    err = float(max(abs(a - b).max() for a, b in ((resumed, whole), (fast, whole),
                                                  (preview, first))))
    log(f"[F1] checkpointed spp {2 * F_SPP}: {rays / wall:.4g} rays/s (wall {wall:.3f} s); "
        f"preview: {frames} frames of {per_frame} half blocks")
    return rays / wall, err, (DEPTH + 1) * bands * 2 * F_SPP


def phase_f2_adaptive(scene):
    """F2: ``render --adaptive --spp 16 --checkpoint A``: a base pass of 8
    spp in one 2,097,152-ray band, then 4 rounds of k = 32,768 pixels × 8
    spp, K1 17 × 5; the counts sum to 512² × 8 + 4 × 32,768 × 8; then K1's
    inputs on round 1's refine chunk (262,144 lanes, compacted) held
    against ``bounce_reference`` as phase 3 holds them, in an API run
    stopped after round 1 through ``AdaptiveCheckpoint`` and resumed by
    the command: equal to the uninterrupted run.  Returns (rays/s, flips,
    max abs err, K1 launches)."""
    import numpy as np
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.adaptive import render_adaptive
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.ops.bounce_kernel import bounce_reference
    from ptx_torch.parallel.checkpoint import AdaptiveCheckpoint

    a, b = os.path.join(OUT, "f2_a.npz"), os.path.join(OUT, "f2_b.npz")
    for p in (a, b):
        if os.path.exists(p):
            os.remove(p)
    out = ["--out", os.path.join(OUT, "smoke_f2")]
    whole, wall = _cli_render("F2 adaptive", _f_args("--adaptive", "--spp", str(SPP),
                                                     "--checkpoint", a, *out),
                              _expect_demo(5))
    ck = AdaptiveCheckpoint(H, W, a)
    k, spp_half = W * H // 8, SPP // 2
    total = W * H * spp_half + 4 * k * spp_half
    if ck.rounds_done != 4 or ck.count.sum() != total:
        raise AssertionError(f"F2: rounds {ck.rounds_done}, counts sum {ck.count.sum()}, "
                             f"expected 4 and {total}")
    if not np.isfinite(whole).all() or not whole.mean() > 0:
        raise AssertionError("F2: the adaptive image is not finite and non-black")

    recorded, on = [], [False]

    def bounce(params, *inputs, packed=None):
        out_ = scene.bounce_fn(params, *inputs, packed=packed)
        if on[0]:
            recorded.append((inputs, out_))
        return out_

    part = AdaptiveCheckpoint(H, W, b)

    def stop_after_round_1(s1, s2, count, rounds_done):
        part.update(s1, s2, count, rounds_done)
        on[0] = rounds_done == 0            # record round 1's refine chunk
        if rounds_done == 1:
            raise KeyboardInterrupt

    sk = dataclasses.replace(scene, bounce_fn=bounce)
    try:
        render_adaptive(sk, Camera.reference_demo(W, H), rng.PRNGKey(0), spp_base=spp_half,
                        rounds=4, frac=0.125, spp_refine=spp_half, depth=DEPTH,
                        on_round=stop_after_round_1)
        raise AssertionError("F2: the adaptive render was not stopped after round 1")
    except KeyboardInterrupt:
        pass
    widths = [inputs[0].shape[0] for inputs, _ in recorded]
    if widths != _wavefront_widths(k * spp_half, DEPTH):
        raise AssertionError(f"F2: refine chunk widths {widths}")
    flips, err = 0, 0.0
    for bnc, (inputs, out_k) in enumerate(recorded):
        out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err = flips + f, max(err, e)
        log(f"[F2 K1 vs plain] refine chunk bounce {bnc}: B={widths[bnc]} "
            f"alive={int(inputs[4].sum())} flips={f} max_abs_err={e:.3g}")
    del recorded
    resumed, _ = _cli_render("F2 resume", _f_args("--adaptive", "--spp", str(SPP),
                                                  "--checkpoint", b, *out),
                             _expect_demo(3))
    _same_image("F2", resumed, whole, "resumed after round 1 vs uninterrupted")
    rays = total * (DEPTH + 1)
    log(f"[F2] adaptive spp {SPP}: counts {ck.count.min():.0f}-{ck.count.max():.0f} (sum "
        f"{ck.count.sum():.0f}), {rays / wall:.4g} rays/s (wall {wall:.3f} s incl. the "
        f"checkpoint writes)")
    return rays / wall, flips, err, (DEPTH + 1) * 5


def _start_server(err_path, *extra):
    """``python -m ptx_torch serve --demo demo`` at 512² on the card, port 0,
    its stderr into ``err_path`` (a file, so that no pipe fills)."""
    with open(err_path, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "ptx_torch", "serve", "--demo", "demo", "--width",
             str(W), "--height", str(H), "--device", "cuda", "--port", "0", *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=err, text=True)


def _server_port(proc, timeout=180):
    """The port a starting server prints; fails unless it serves on the card."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline() if ready else ""
    if "render-farm server on :" not in line or "device=cuda" not in line:
        raise AssertionError(f"the server did not start: {line!r}")
    return int(line.split("on :")[1].split()[0])


def _stop_server(proc, err_path):
    """SIGINT (the server stops and drains), then its stderr."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
    with open(err_path) as f:
        return f.read()


def _farm(port):
    """The 512² frame from the server at ``port`` through the port's
    bounded client: ``(frame, wall seconds)``."""
    from ptx_torch.runtime import RenderFarmClient

    t0 = time.perf_counter()
    with RenderFarmClient([f"127.0.0.1:{port}"], retry_ms=200, max_attempts=2,
                          io_timeout_ms=120000) as cli:
        img = cli.render_image(W, H, tile=FARM_TILE, spp=FARM_SPP, depth=DEPTH, seed=0,
                               parallel=8)
    return img, time.perf_counter() - t0


def _served_bands(name, err_log, n_bands):
    """Fails unless a server's stderr logs ``n_bands`` bands and no traceback."""
    done = err_log.count('"event": "tile_done"')
    if done != n_bands or "Traceback" in err_log:
        raise AssertionError(f"F3 {name}: {done} bands served (expected {n_bands}):\n"
                             f"{err_log[-3000:]}")


def _farm_in_process(scene, cam, adaptive, n_bands, expect):
    """The frame farmed from a ``RenderFarmServer`` in this process on the
    callback ``serve`` runs, the counters zeroed just before the client
    starts and read when it has the frame: ``(frame, wall seconds, K1)``;
    fails unless the counts are ``expect``."""
    from ptx_torch.cli import serve_render_fn
    from ptx_torch.runtime import RenderFarmServer

    name = "adaptive" if adaptive else "plain"
    err_path = os.path.join(OUT, f"f3_in_process_{name}.err")
    with open(err_path, "w") as err, contextlib.redirect_stderr(err):
        with RenderFarmServer(serve_render_fn(scene, cam, adaptive), port=0,
                              chunk_rows=FARM_CHUNK) as srv:
            _reset_counters()
            img, wall = _farm(srv.port)
            c = _counters()
    with open(err_path) as f:
        _served_bands(f"in-process {name} server", f.read(), n_bands)
    log(f"[F3 in-process {name} server] {wall:.3f} s; launches {c} (expected {expect})")
    if c != expect:
        raise AssertionError(f"F3 {name}: launches {c}, expected {expect}")
    return img, wall, c["K1"]


def phase_f3_farm(scene):
    """F3: ``serve`` and ``serve --adaptive`` subprocesses on the card and
    the port's client (``max_attempts`` 2, io timeout 120 s): the 512²
    frame at ``--tile 64 --spp 4 --depth 16``, default ``--chunk-rows 16``;
    garbage bytes get the busy byte.  The counted run: a server in this
    process on ``cli.serve_render_fn``, plain (K1 17 a band) and adaptive
    (K1 17 × 3 a band), each frame equal to the subprocess server's; the
    plain frame equal to the direct ``render_tile`` of every band with the
    client's seeds; K1 on one band's bounces (4,096 lanes) against its
    plain version; a tile's four adaptive bands equal to
    ``adaptive_tile_moments`` at their seeds, each count budget met (every
    band is 64 × 16).  Returns (rays/s, rays/s adaptive, the subprocess
    servers' two rays/s, flips, max abs err, K1 plain, K1 adaptive)."""
    import socket

    import numpy as np
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.adaptive import adaptive_tile_moments
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_tile
    from ptx_torch.ops.bounce_kernel import bounce_reference

    n_bands = (W // FARM_TILE) * (H // FARM_TILE) * (FARM_TILE // FARM_CHUNK)
    err_paths = [os.path.join(OUT, f"f3_serve{i}.err") for i in range(2)]
    servers = [_start_server(err_paths[0]), _start_server(err_paths[1], "--adaptive")]
    try:
        ports = [_server_port(p) for p in servers]
        img_cli, wall_cli = _farm(ports[0])
        img_cli_a, wall_cli_a = _farm(ports[1])
        for port in ports:
            with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
                s.sendall(b"GARBAGE!" * 8)
                if s.recv(1) != b"\x00":
                    raise AssertionError("F3: garbage bytes did not get the busy byte")
    finally:
        logs = [_stop_server(p, e) for p, e in zip(servers, err_paths)]
    for name, err_log in zip(("serve", "serve --adaptive"), logs):
        _served_bands(name, err_log, n_bands)

    cam = Camera.reference_demo(W, H)
    img, wall, k1 = _farm_in_process(scene, cam, False, n_bands,
                                     _expect_demo(n_bands))
    img_a, wall_a, k1_a = _farm_in_process(scene, cam, True, n_bands,
                                           _expect_demo(3 * n_bands))
    _same_image("F3", img, img_cli, "in-process server vs serve")
    _same_image("F3", img_a, img_cli_a, "in-process server vs serve --adaptive")

    bands = [(x0, y0, off, rng.PRNGKey(((y0 << 20) + x0) & 0x7FFFFFFF))
             for y0 in range(0, H, FARM_TILE) for x0 in range(0, W, FARM_TILE)
             for off in range(0, FARM_TILE, FARM_CHUNK)]
    direct = np.zeros_like(img)
    for x0, y0, off, key in bands:
        direct[y0 + off:y0 + off + FARM_CHUNK, x0:x0 + FARM_TILE] = render_tile(
            scene, scene.params, cam, key, x0, y0 + off, FARM_TILE, FARM_CHUNK, FARM_SPP,
            DEPTH).cpu().numpy()
    _same_image("F3", img, direct, "farmed frame vs the direct bands")

    recorded = []
    x0, y0, off, key = bands[len(bands) // 2 + 2]
    render_tile(dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, recorded)),
                scene.params, cam, key, x0, y0 + off, FARM_TILE, FARM_CHUNK, FARM_SPP, DEPTH)
    flips, err = 0, 0.0
    for bnc, (inputs, out_k) in enumerate(recorded):
        out_p = bounce_reference(scene, scene.params, *inputs)
        torch.cuda.synchronize()
        f, e = compare_bounce(scene, inputs, out_k, out_p)
        flips, err = flips + f, max(err, e)
    log(f"[F3 K1 vs plain] band ({x0}, {y0 + off}): {len(recorded)} bounces at B="
        f"{recorded[0][0][0].shape[0]}, flips {flips}, max_abs_err {err:.3g}")

    if not np.isfinite(img_a).all() or not img_a.mean() > 0:
        raise AssertionError("F3: the adaptive farmed frame is not finite and non-black")
    for x0, y0, off, key in bands[:FARM_TILE // FARM_CHUNK]:
        s1, _, count = adaptive_tile_moments(scene, scene.params, cam, key, x0, y0 + off,
                                             FARM_TILE, FARM_CHUNK, FARM_SPP, DEPTH)
        if float(count.sum()) != FARM_SPP * FARM_TILE * FARM_CHUNK:
            raise AssertionError(f"F3 adaptive band ({x0}, {y0 + off}): counts sum "
                                 f"{float(count.sum())}")
        _same_image("F3", img_a[y0 + off:y0 + off + FARM_CHUNK, x0:x0 + FARM_TILE],
                    (s1 / count[..., None]).cpu().numpy(),
                    f"adaptive band ({x0}, {y0 + off}) vs adaptive_tile_moments")
    rays = W * H * FARM_SPP * (DEPTH + 1)
    log(f"[F3] farmed {len(bands) // (FARM_TILE // FARM_CHUNK)} tiles ({n_bands} bands) "
        f"over loopback from the in-process server: {wall:.3f} s, {rays / wall:.4g} rays/s; "
        f"adaptive {wall_a:.3f} s, {rays / wall_a:.4g} rays/s (the same sample budget); "
        f"from the serve subprocesses {wall_cli:.3f} s, {rays / wall_cli:.4g} rays/s; "
        f"adaptive {wall_cli_a:.3f} s, {rays / wall_cli_a:.4g} rays/s")
    return (rays / wall, rays / wall_a, rays / wall_cli, rays / wall_cli_a, flips, err, k1,
            k1_a)


def run_path_f(scene):
    f1 = _timed("F1 checkpoint", phase_f1_checkpoint)
    f2 = _timed("F2 adaptive", phase_f2_adaptive, scene)
    f3 = _timed("F3 serve / farm", phase_f3_farm, scene)
    return f1, f2, f3


# ---------------------------------------------------------------------------
# path G, the mesh (ptx_torch.parallel on torch.distributed) and the knobs
# ---------------------------------------------------------------------------

G_RENDER_KEY, G_STEP_KEY, G_ADAPT_KEY = 21, 22, 23
G3_SHAPES = ((2, 1), (1, 2))
G3_TIMEOUT = 600


def _perturbed(params):
    """Phase 7's start: sphere radii ×1.05, const row 0 lowered by 0.1."""
    out = dict(params)
    out["sphere_radius"] = params["sphere_radius"] * 1.05
    const = params["const"].clone()
    const[0] -= 0.1
    out["const"] = const
    return out


def _flat(params):
    import torch

    return torch.cat([x.reshape(-1) for v in params.values()
                      for x in (v if isinstance(v, list) else [v])])


def _unsharded(scene, key, params=None):
    """The whole frame's radiance (spp, H, W, 3) in one wavefront under
    ``fold(key, 0, 0)``: what a 1×1 mesh renders."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera, sample_rays
    from ptx_torch.integrate.trace import trace_rays

    k = rng.fold(key, 0, 0)
    o, d = sample_rays(Camera.reference_demo(W, H), k, range(H), range(W), SPP, scene.device)
    with torch.no_grad():
        return trace_rays(scene, scene.params if params is None else params, o, d, k, DEPTH)


def _equal(tag, what, got, want):
    import torch

    if not torch.equal(got, want):
        n = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{tag}: {what} differs from the unsharded one at {n} entries")


def _ulps(a, b):
    """The distance between float32 tensors of one sign in units in the last
    place (the difference of their bit patterns)."""
    import torch

    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _params_check(tag, got, want, again):
    """A mesh step's new params ``got`` against the step without the mesh,
    run twice (``want``, ``again``), per param key (or one flat tensor):
    bit for bit wherever the two runs agree; where they differ (float
    atomics adding in a varying order), within the larger of one ulp and
    twice their distance in ulps.  Returns per key ``(entries off the
    first run, entries where the runs differ, the largest distance in
    ulps from the first run)``."""
    import torch

    pairs = lambda d: ([(k, x) for k, v in d.items() for x in (v if isinstance(v, list) else [v])]
                       if isinstance(d, dict) else [("params", d)])
    rep = {}
    for (k, g), (_, w), (_, a) in zip(pairs(got), pairs(want), pairs(again)):
        n_off, n_noisy, ulps = rep.get(k, (0, 0, 0))
        stable = w == a
        off = g != w
        far = _ulps(g, w)
        bad = (off & stable) | (~stable & (far > torch.clamp(2 * _ulps(w, a), min=1)))
        if bad.any():
            raise AssertionError(f"{tag}: param {k} differs from the step without the mesh at "
                                 f"{int(bad.sum())} entries beyond its run-to-run spread")
        rep[k] = (n_off + int(off.sum()), n_noisy + int((~stable).sum()),
                  max(ulps, int(far.max()) if far.numel() else 0))
    return rep


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for the block (warnings where an
    operation has none)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _frame_ms(mesh, numel, device):
    """Median of 20 all-reduces of ``numel`` float32 over the mesh's tile
    group, each between CUDA events."""
    import torch
    import torch.distributed as dist
    from ptx_torch.parallel.mesh import TILE_AXIS

    buf = torch.ones(numel, device=device)
    group = mesh.get_group(TILE_AXIS)
    return _time_ms(lambda: dist.all_reduce(buf, group=group))


def phase_g1_mesh_demo(scene):
    """G1: the demo on a 1×1 mesh over a world-1 NCCL group, against the
    unsharded computation, bit for bit, with exact launch counts."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate import adaptive
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import render as prender

    cam, dev = Camera.reference_demo(W, H), scene.device
    mesh = pmesh.make_mesh(1, 1, device=dev)
    params = pmesh.shard_params(scene.params, mesh)
    out = {}

    def counted(tag, expect, fn):
        _reset_counters()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = _counters()
        log(f"[{tag}] {secs:.3f} s; launches {c} (expected {expect})")
        if c != expect:
            raise AssertionError(f"{tag}: launches {c}, expected {expect}")
        return res, secs

    key = rng.PRNGKey(G_RENDER_KEY)
    prender.render_sharded(scene, cam, mesh, key, SPP, DEPTH, params)   # NCCL's first use
    img, out["render_s"] = counted("G1 render_sharded", _expect_demo(1),
                                   lambda: prender.render_sharded(scene, cam, mesh, key, SPP,
                                                                  DEPTH, params))
    t0 = time.perf_counter()
    rad = _unsharded(scene, key)
    torch.cuda.synchronize()
    out["render_u_s"] = time.perf_counter() - t0
    _equal("G1", "render_sharded", img, rad.mean(dim=0))
    (s1, s2), _ = counted("G1 render_sharded_moments", _expect_demo(1),
                          lambda: prender.render_sharded_moments(scene, cam, mesh, key, SPP,
                                                                 DEPTH, params))
    _equal("G1", "s1", s1, rad.sum(dim=0))
    _equal("G1", "s2", s2, (rad ** 2).sum(dim=0))
    del rad, s1, s2

    start, step_key = _perturbed(params), rng.PRNGKey(G_STEP_KEY)
    step_m = prender.make_train_step(scene, cam, mesh, spp=SPP, depth=DEPTH,
                                     learning_rate=LR)
    (new_m, loss_m), out["step_s"] = counted(
        "G1 make_train_step(mesh)", _expect_demo(1, 1),
        lambda: step_m(start, img, step_key))
    step_u = prender.make_train_step(scene, cam, spp=SPP, depth=DEPTH, learning_rate=LR)
    t0 = time.perf_counter()
    new_u, loss_u = step_u(start, img, step_key)
    torch.cuda.synchronize()
    out["step_u_s"] = time.perf_counter() - t0
    again, _ = step_u(start, img, step_key)
    _equal("G1", "loss", loss_m, loss_u)
    rep = _params_check("G1", new_m, new_u, again)
    log(f"[G1 make_train_step(mesh)] loss {float(loss_m):.6g} == unsharded; params (entries "
        f"off the unsharded step, entries two unsharded steps differ at, largest ulps): {rep}; "
        f"seconds: render {out['render_s']:.3f} (unsharded {out['render_u_s']:.3f}), step "
        f"{out['step_s']:.3f} (unsharded {out['step_u_s']:.3f})")
    out["params_demo"] = rep
    del new_m, new_u, again

    kw = dict(spp_base=SPP, rounds=1, frac=0.125, spp_refine=SPP, depth=DEPTH, params=params)
    akey = rng.PRNGKey(G_ADAPT_KEY)
    (a_img, a_count, _), out["adaptive_s"] = counted(
        "G1 render_adaptive(mesh)", _expect_demo(2),
        lambda: adaptive.render_adaptive(scene, cam, akey, mesh=mesh, **kw))
    rad = _unsharded(scene, akey)
    base = (rad.sum(dim=0), (rad ** 2).sum(dim=0),
            torch.full((H, W), float(SPP), device=dev), 0)
    del rad
    u_img, u_count, _ = adaptive.render_adaptive(scene, cam, akey, state=base, **kw)
    _equal("G1", "adaptive image", a_img, u_img)
    _equal("G1", "adaptive counts", a_count, u_count)
    if float(a_count.sum()) != W * H * SPP + int(W * H * 0.125) * SPP:
        raise AssertionError("G1: adaptive counts miss the budget")

    out["frame_ms"] = _frame_ms(mesh, H * W * 3, dev)
    out["grad_numel"] = int(_flat(params).numel())
    out["grad_ms"] = _frame_ms(mesh, out["grad_numel"], dev)
    log(f"[G1 collectives] NCCL world 1: the frame's all-reduce ({H}x{W}x3 float32, "
        f"{H * W * 3 * 4 / 2 ** 20:.2f} MiB) {out['frame_ms']:.4f} ms; the gradient buffer's "
        f"({out['grad_numel']:,} float32) {out['grad_ms']:.4f} ms (median of 20)")
    torch.save(img.cpu(), os.path.join(OUT, "g3_target.pt"))
    return out


def phase_g2_mesh_s1(dev):
    """G2: S1 (K5, K6) on the 1×1 NCCL mesh: its render and one train step
    against the unsharded ones."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import render as prender
    from ptx_torch.scenes import builders

    scene = compile_scene(builders.stress_spheres(249), dev)
    cam, mesh = Camera.reference_demo(W, H), pmesh.make_mesh(1, 1, device=dev)
    key = rng.PRNGKey(G_RENDER_KEY)
    _reset_counters()
    img = prender.render_sharded(scene, cam, mesh, key, SPP, DEPTH)
    torch.cuda.synchronize()
    c_render = _counters()
    _equal("G2 S1", "render_sharded", img, _unsharded(scene, key).mean(dim=0))
    start, step_key = _perturbed(scene.params), rng.PRNGKey(G_STEP_KEY)
    step_m = prender.make_train_step(scene, cam, mesh, spp=SPP, depth=DEPTH,
                                     learning_rate=LR)
    step_u = prender.make_train_step(scene, cam, spp=SPP, depth=DEPTH, learning_rate=LR)
    _reset_counters()
    t0 = time.perf_counter()
    step_m(start, img, step_key)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c_step = _counters()
    # S1's const gradient sums 16.9 M emission records through autograd's
    # index_add_, whose atomics make two runs of one step differ by up to
    # 230 ulps; PyTorch's deterministic algorithms sort them instead
    with _deterministic():
        new_m, loss_m = step_m(start, img, step_key)
        new_u, loss_u = step_u(start, img, step_key)
        again, _ = step_u(start, img, step_key)
    _equal("G2 S1", "loss", loss_m, loss_u)
    rep = _params_check("G2 S1", new_m, new_u, again)
    log(f"[G2 S1] render launches {c_render}; step launches {c_step}, {secs:.3f} s; loss "
        f"{float(loss_m):.6g} == unsharded; params (entries off, entries two unsharded "
        f"steps differ at, largest ulps): {rep}")
    if c_render != _expect(K5=DEPTH + 1):
        raise AssertionError(f"G2 S1 render launches {c_render}")
    if c_step != _expect(k6_steps=1, K5=DEPTH + 1, K6=DEPTH):
        raise AssertionError(f"G2 S1 step launches {c_step}")
    return {"s1_step_s": secs, "params_s1": rep}


def _g_rank_reference(scene, tiles, samples, params, target, key, step_key):
    """One process's combination of the per-(tile, sample) band renders on
    the card, in the JAX order (``tests/test_torch_mesh.py``): the frame,
    and one train step's new flat params and loss."""
    import torch
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel import render as prender

    cam, rows, spp = Camera.reference_demo(W, H), H // tiles, SPP // samples
    leaves = prender._leaves(params)
    frame, grads, losses = [], [], []
    for t in range(tiles):
        y0 = t * rows
        with torch.no_grad():
            bands = [prender._local_render(scene, cam, DEPTH, spp, params, key, y0, rows, t, s)
                     for s in range(samples)]
        frame.append(sum(bands[1:], bands[0]) / samples)
        per_sample = []
        for s in range(samples):
            xs = [x.detach().requires_grad_(True) for _, _, x in leaves]
            band = prender._local_render(scene, cam, DEPTH, spp,
                                         prender._rebuild(params, leaves, xs), step_key, y0,
                                         rows, t, s)
            per_sample.append((xs, band))
        mean = sum((b.detach() for _, b in per_sample[1:]), per_sample[0][1].detach())
        mean = (mean / samples).requires_grad_(True)
        loss = torch.mean((mean - target[y0:y0 + rows]) ** 2)
        (ct,) = torch.autograd.grad(loss, mean)
        losses.append(loss.detach())
        grads.append([torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1)
                                 for x, g in zip(xs, torch.autograd.grad(
                                     band, xs, ct, allow_unused=True))])
                      for xs, band in per_sample])
        del per_sample
    by_sample = [sum((grads[t][s] for t in range(1, tiles)), grads[0][s]) / tiles
                 for s in range(samples)]
    g = sum(by_sample[1:], by_sample[0]) / samples
    loss = sum(losses[1:], losses[0]) / tiles
    return torch.cat(frame), _flat(params) - LR * g, loss


def _g3_rank(rank, port):
    """One rank of G3 (``chip_smoke.py --g3-rank RANK PORT``): a gloo world
    of 2 on ``cuda:0``; each mesh of ``G3_SHAPES`` renders the frame and
    takes one train step, with its launch counts; results under ``OUT``."""
    import torch
    import torch.distributed as dist
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.parallel import mesh as pmesh
    from ptx_torch.parallel import render as prender
    from ptx_torch.scenes import builders

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    scene = compile_scene(builders.make_world(), dev)
    target = torch.load(os.path.join(OUT, "g3_target.pt")).to(dev)
    cam = Camera.reference_demo(W, H)
    # the render's frame gather is an all-reduce, which both backends run
    # on CUDA tensors; the probe records whether gloo gathers them too
    x = torch.full((4,), float(rank), device=dev)
    try:
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
        gather = "ran"
    except RuntimeError as e:
        gather = f"refused: {str(e).splitlines()[0][:200]}"
    report = {"all_gather": gather}
    for tiles, samples in G3_SHAPES:
        mesh = pmesh.make_mesh(tiles, samples, device=dev)
        params = pmesh.shard_params(_perturbed(scene.params), mesh)
        _reset_counters()
        frame = prender.render_sharded(scene, cam, mesh, rng.PRNGKey(G_RENDER_KEY), SPP,
                                       DEPTH, params)
        torch.cuda.synchronize()
        c_render = _counters()
        step = prender.make_train_step(scene, cam, mesh, spp=SPP, depth=DEPTH,
                                       learning_rate=LR)
        _reset_counters()
        t0 = time.perf_counter()
        new, loss = step(params, target, rng.PRNGKey(G_STEP_KEY))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        c_step = _counters()
        torch.save({"frame": frame.cpu(), "params": _flat(new).cpu(), "loss": loss.cpu()},
                   os.path.join(OUT, f"g3_{tiles}x{samples}_{rank}.pt"))
        report[f"{tiles}x{samples}"] = {"render": c_render, "step": c_step, "step_s": step_s,
                                        "backend": dist.get_backend()}
    dist.destroy_process_group()
    report["seconds"] = time.perf_counter() - t_start
    print("G3_REPORT " + json.dumps(report), flush=True)
    return 0


def _g3_nccl_rank(rank, port):
    """``chip_smoke.py --g3-nccl RANK PORT``: two NCCL ranks on ``cuda:0``,
    one all-reduce; NCCL is expected to refuse the pair."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    x = torch.ones(4, device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"G3_NCCL all-reduce ran: {x.tolist()}", flush=True)
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode, timeout):
    """Two ranks of this script in ``mode``; ``[(returncode, output), ...]``.
    A rank still running at ``timeout`` seconds is killed (rc None)."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            text = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            out.append((p.returncode, text))
        except subprocess.TimeoutExpired:
            p.kill()
            out.append((None, p.communicate()[0]))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def phase_g3_two_ranks(scene):
    """G3: two ranks on the one card.  NCCL first (expected to refuse two
    ranks on one GPU; logged), then gloo: 2×1 and 1×2 meshes, each rank's
    frame, step params and loss equal to this process's per-(tile, sample)
    combination, with exact counts."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    nccl = _run_ranks("--g3-nccl", 120)
    for r, (rc, text) in enumerate(nccl):
        tail = [ln for ln in text.strip().splitlines() if ln.strip()][-3:]
        log(f"[G3 NCCL] rank {r}: exit {rc}; " + " | ".join(ln.strip()[:300] for ln in tail))
    refused = any(rc not in (0, None) for rc, _ in nccl)
    log(f"[G3 NCCL] two NCCL ranks on one card: {'refused' if refused else 'not refused'} "
        f"({time.perf_counter() - t0:.1f} s)")

    runs = _run_ranks("--g3-rank", G3_TIMEOUT)
    reports = []
    for r, (rc, text) in enumerate(runs):
        with open(os.path.join(OUT, f"g3_rank{r}.log"), "w") as f:
            f.write(text)
        if rc != 0:
            raise AssertionError(f"G3 rank {r} exit {rc}:\n{text[-4000:]}")
        reports.append(json.loads(text.split("G3_REPORT ", 1)[1].splitlines()[0]))
    target = torch.load(os.path.join(OUT, "g3_target.pt")).to(scene.device)
    params = _perturbed(pmesh.shard_params(scene.params, pmesh.LocalMesh(scene.device)))
    out = {"rank_s": [rep["seconds"] for rep in reports]}
    for tiles, samples in G3_SHAPES:
        name = f"{tiles}x{samples}"
        frame, new, loss = _g_rank_reference(scene, tiles, samples, params, target,
                                             rng.PRNGKey(G_RENDER_KEY),
                                             rng.PRNGKey(G_STEP_KEY))
        again = _g_rank_reference(scene, tiles, samples, params, target,
                                  rng.PRNGKey(G_RENDER_KEY), rng.PRNGKey(G_STEP_KEY))[1]
        for r, rep in enumerate(reports):
            got = torch.load(os.path.join(OUT, f"g3_{name}_{r}.pt"))
            for what, a, b in (("frame", got["frame"], frame.cpu()),
                               ("loss", got["loss"], loss.cpu())):
                if not torch.equal(a, b):
                    raise AssertionError(f"G3 {name} rank {r}: {what} differs from the "
                                         f"per-band combination at {int((a != b).sum())} "
                                         "entries")
            rep_p = _params_check(f"G3 {name} rank {r}", got["params"], new.cpu(),
                                  again.cpu())["params"]
            log(f"[G3 gloo {name}] rank {r}: params (entries off the per-band combination, "
                f"entries where two combinations differ, largest ulps) {rep_p}")
            if rep[name]["render"] != _expect_demo(1):
                raise AssertionError(f"G3 {name} rank {r} render launches {rep[name]['render']}")
            if rep[name]["step"] != _expect_demo(1, 1):
                raise AssertionError(f"G3 {name} rank {r} step launches {rep[name]['step']}")
        log(f"[G3 gloo {name}] both ranks ({reports[0][name]['backend']}): frame and loss "
            f"{float(loss):.6g} equal the per-band combination bit for bit; "
            f"launches K1 {DEPTH + 1} a render, K1 {DEPTH + 1} K2 {DEPTH} a step, the sky "
            f"bank 1 a render, 3 a step; step "
            f"seconds {[round(rep[name]['step_s'], 3) for rep in reports]}")
        out[name] = [rep[name]["step_s"] for rep in reports]
    log(f"[G3] seconds per rank process {[round(s, 2) for s in out['rank_s']]}; gloo's "
        f"all_gather of CUDA tensors: {reports[0]['all_gather']}")
    return out


def _band(scene, bounce_log, y0=248, rows=16, spp=2):
    """Phase 4's band (``rows`` rows from ``y0``, ``spp`` one-sample
    chunks, no compaction), each bounce recorded: through ``bounce_fn``, or
    (a scene without one) through ``trace._bounce_live``."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate import trace
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows

    cam = Camera.reference_demo(W, H)
    if scene.bounce_fn is not None:
        sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, bounce_log))
        return render_rows(sk, scene.params, cam, rng.PRNGKey(0), y0, rows, 1, spp, DEPTH)
    live = trace._bounce_live

    def recorded(hit_fn, material_fn, params, o, d, thr, strength, alive, in_depth, uc, u3):
        carry, dec = live(hit_fn, material_fn, params, o, d, thr, strength, alive, in_depth,
                          uc, u3)
        # the inputs in the order of K1's wrapper (``adjudicate`` reads them so)
        bounce_log.append(((o, d, thr, strength, alive, uc, u3, in_depth),
                           dict(dec, o2=carry[0], d2=carry[1], thr2=carry[2],
                                strength2=carry[3], alive2=carry[4])))
        return carry, dec
    with _swapped(trace, "_bounce_live", recorded), torch.no_grad():
        return render_rows(scene, scene.params, cam, rng.PRNGKey(0), y0, rows, 1, spp, DEPTH)


def phase_g4_knobs(scene):
    """G4: ``PTX_FUSED=0`` on a demo chunk (K4 17, K1 0) against the default
    route; ``PTX_PALLAS=0`` and ``fast=False`` (no kernel) on phase 4's band
    against the kernel band, by phase 4's rule."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate import trace
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_tile
    from ptx_torch.scenes import builders

    dev, cam = scene.device, Camera.reference_demo(W, H)
    with _env(PTX_FUSED="0"):
        unfused = trace.compile_scene(builders.make_world(), dev)
    if not isinstance(unfused.bounce_fn, trace.UnfusedBounce):
        raise AssertionError("G4: PTX_FUSED=0 kept the fused bounce")
    y0, rows, key = 192, BAND_ROWS, rng.PRNGKey(3)
    log_k, log_u = [], []
    sk = dataclasses.replace(scene, bounce_fn=_recording(scene.bounce_fn, log_k))
    su = dataclasses.replace(unfused, bounce_fn=_recording(unfused.bounce_fn, log_u))
    img_k = render_tile(sk, scene.params, cam, key, 0, y0, W, rows, 1, DEPTH, compact=False)
    _reset_counters()
    img_u = render_tile(su, unfused.params, cam, key, 0, y0, W, rows, 1, DEPTH, compact=False)
    torch.cuda.synchronize()
    c = _counters()
    if c != _expect(K4=DEPTH + 1, SB=1):
        raise AssertionError(f"G4 PTX_FUSED=0 chunk launches {c}, expected K4 {DEPTH + 1}, "
                             f"the sky bank 1")
    flipped, flips, _ = _flipped_pixels(scene, log_k, log_u, rows * W, 1)
    keep = ~flipped.reshape(rows, W)
    torch.testing.assert_close(img_u[keep], img_k[keep], rtol=1e-4, atol=1e-5)
    log(f"[G4 PTX_FUSED=0] {rows}x{W} chunk spp 1 depth {DEPTH} (no compaction): launches "
        f"{c}; {int(keep.sum())} pixels equal the default route's within rtol 1e-4 atol "
        f"1e-5, {flips} adjudicated flips, max abs diff "
        f"{float((img_u - img_k).abs().max()):.3g}")
    del log_k, log_u
    out = {"fused0_flips": flips}

    log_k = []
    band_k = _band(scene, log_k)
    for name, make in (("PTX_PALLAS=0", lambda: _plain_route(dev)),
                       ("fast=False", lambda: trace.compile_scene(builders.make_world(), dev,
                                                                  fast=False))):
        plain = make()
        log_p = []
        _reset_counters()
        band_p = _band(plain, log_p)
        torch.cuda.synchronize()
        c = _counters()
        if c != _expect():
            raise AssertionError(f"G4 {name}: launches {c}, expected none")
        flipped, flips, payload = _flipped_pixels(scene, log_k, log_p, 16 * W, 2,
                                                  spans=plain.hit_fn is None)
        keep = ~flipped.reshape(2, 16, W).any(dim=0)
        torch.testing.assert_close(band_p[keep], band_k[keep], rtol=1e-4, atol=1e-5)
        log(f"[G4 {name}] phase 4's band: no launch ({c}); {int(keep.sum())} pixels equal "
            f"the kernel band within rtol 1e-4 atol 1e-5, {flips} adjudicated flips ({payload} "
            f"of them the span merge's payload at a coincident boundary), max abs diff "
            f"{float((band_p - band_k).abs().max()):.3g}")
        out[name] = flips
    return out


def _plain_route(dev):
    from ptx_torch.integrate import trace
    from ptx_torch.scenes import builders

    with _env(PTX_PALLAS="0"):
        plain = trace.compile_scene(builders.make_world(), dev)
    if plain.hit_fn is not plain.plain_hit_fn or plain.emission_fn is not None:
        raise AssertionError("G4: PTX_PALLAS=0 kept a kernel")
    return plain


def run_path_g(scene, dev):
    """Path G; G1 and G2 on a world-1 NCCL group made with a HashStore."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        g1 = _timed("G1 mesh demo", phase_g1_mesh_demo, scene)
        g2 = _timed("G2 mesh S1", phase_g2_mesh_s1, dev)
    finally:
        dist.destroy_process_group()
    g3 = _timed("G3 two ranks", phase_g3_two_ranks, scene)
    g4 = _timed("G4 knobs", phase_g4_knobs, scene)
    return g1, g2, g3, g4


# ---------------------------------------------------------------------------
# path H: the plain-autograd route (trace_rays(manual_vjp=False), remat)
# ---------------------------------------------------------------------------

# One step each at this rate: the update is then far above the params'
# rounding, and (start - new) / H_LR is each gradient to float32 precision.
H_LR = 2.0 ** 20


def _h_grads(start, new):
    """Each param tensor's gradient from one step at ``H_LR``."""
    out = {}
    for k, v in start.items():
        for i, (a, b) in enumerate(zip(*(x if isinstance(x, list) else [x]
                                          for x in (v, new[k])))):
            out[f"{k}[{i}]" if isinstance(v, list) else k] = (a - b) / H_LR
    return out


def _h_step(step, start, target, key, label):
    """One step with the counters zeroed and the peak memory reset just
    before: ``(new, loss, counts, seconds, peak GiB, peak above the memory
    allocated at its start in GiB)``; the seconds through
    ``profiling.timed``."""
    import torch
    from ptx_torch.utils.profiling import timed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_counters()
    with timed(label) as rec:
        new, loss = step(start, target, key)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return new, loss, _counters(), rec["seconds"], peak / 2 ** 30, (peak - base) / 2 ** 30


def _h_hit_flips(scene, params, rec, tag):
    """The autograd route's recorded hits (``rec``: rays and hit dicts, at
    ``params``) against the manual route's fused bounce (K1, K5's bounce mode) on the
    same rays: hit decisions equal except where a float64 recompute puts
    the flip at a near-tie, ``t`` within ``rtol 1e-5, atol 5e-6`` on
    agreeing lanes.  Returns (flips, lanes, max_abs_err of ``t``)."""
    import torch

    packed = scene.bounce_fn.pack(params)
    p64 = _f64_cpu(params)
    flips = lanes_n = 0
    err = 0.0
    for o, d, out in rec:
        B, dev = o.shape[0], o.device
        half = torch.full((B,), 0.5, device=dev)
        with torch.no_grad():
            kb = scene.bounce_fn(params, o, d, torch.ones((B, 3), device=dev),
                                 torch.ones(B, device=dev),
                                 torch.ones(B, dtype=torch.bool, device=dev), half,
                                 torch.full((B, 3), 0.5, device=dev), True, packed=packed)
        differ = ((out["_evt"].long() != kb["evt"].long()) | (out["hit"] != kb["hit"])
                  | (out["entering"] != kb["entering"])
                  | (out["mat_id"].long() != kb["mat_id"].long()))
        lanes = differ.nonzero().flatten().cpu()
        if lanes.numel():
            tied = _winner_tied(scene, p64, o.cpu()[lanes].double(), d.cpu()[lanes].double(),
                                lanes)
            ok = tied(out["_evt"]) | tied(kb["evt"])
            if not bool(ok.all()):
                raise AssertionError(f"{tag}: {int((~ok).sum())} unexplained hit flips against "
                                     f"the fused bounce, lanes {lanes[~ok][:8].tolist()}")
        a, b = out["t"].detach()[~differ], kb["t"][~differ]
        torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-6, msg=lambda m: f"{tag} t: {m}")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        flips, lanes_n = flips + int(lanes.numel()), lanes_n + B
    return flips, lanes_n, err


@contextlib.contextmanager
def _hit_term_sums(scene, acc):
    """While active, each backward of ``fasthit.HitReplay`` (the hit's
    replay VJP) also appends to ``acc`` the (L, 26) sums over its lanes of
    the absolute per-lane terms of the leaf rows' cotangent: the replay run
    again on one row a lane (``hitreplay.recompute_flat`` with the lane's
    own row), differentiated with respect to those rows.  The gradient it
    returns is the unpatched one."""
    import torch
    from ptx_torch.geom import fasthit, hitreplay

    leaves = fasthit.collect_leaves(scene.plan)
    rows_of = hitreplay.LeafRows(leaves)
    plain = fasthit.HitReplay.backward

    def backward(ctx, ct_t, ct_n):
        out = plain(ctx, ct_t, ct_n)
        evt, entering, hit, o, d, *geo = ctx.saved_tensors
        rows = rows_of(dict(zip(fasthit.GEO_KEYS, geo))).detach()
        L, B, dev = rows.shape[0], evt.numel(), evt.device
        e = evt.long()
        leaf = torch.where(e >= L, e - L, e)
        lane = torch.arange(B, device=dev)
        sph = torch.tensor([lf.kind == "sphere" for lf, _ in leaves], device=dev)[leaf]
        par = torch.tensor([p for _, p in leaves], dtype=o.dtype, device=dev)[leaf]
        with torch.enable_grad():
            lane_rows = rows.index_select(0, leaf).requires_grad_(True)
            t, nx, ny, nz, pp = hitreplay.recompute_flat(
                lane_rows, sph, par, *o.unbind(-1), *d.unbind(-1),
                torch.where(e < L, lane, B + lane))
            sign = pp * torch.where(entering, 1.0, -1.0)
            n = torch.stack([torch.where(hit, nx * sign, 0.0), torch.where(hit, ny * sign, 0.0),
                             torch.where(hit, nz * sign, 1.0)], dim=-1)
            (g,) = torch.autograd.grad((torch.where(hit, t, 0.0), n), lane_rows, (ct_t, ct_n))
        acc.append(torch.zeros_like(rows).index_add_(0, leaf, g.abs()))
        return out

    fasthit.HitReplay.backward = staticmethod(backward)
    try:
        yield
    finally:
        fasthit.HitReplay.backward = plain


def _geo_term_scale(scene, params, acc):
    """Per geometry param entry, Σ|term| over the lanes of a step: the
    leaf rows' summed absolute terms (``_hit_term_sums``) taken back to the
    params through the rows' packing (exact for untransformed spheres'
    centres and radii and planes' offsets, which a row holds as they are)."""
    import torch
    from ptx_torch.geom import fasthit, hitreplay

    geo = {k: params[k].detach().requires_grad_(True) for k in fasthit.GEO_KEYS}
    rows = hitreplay.LeafRows(fasthit.collect_leaves(scene.plan))(geo)
    grads = torch.autograd.grad(rows, list(geo.values()), sum(acc), allow_unused=True)
    return {k: (torch.zeros_like(x) if g is None else g.abs())
            for (k, x), g in zip(geo.items(), grads)}


def _h_grads_close(tag, g, g_m, scale):
    """The autograd route's gradients ``g`` against the manual route's
    ``g_m``: each entry within 1e-4 of its tensor's largest entry (+1e-7),
    or, for a geometry entry, within 1e-4 of its Σ|term| (``scale``): the
    per-lane replay adjoints may differ by 1e-4 relative on ill-conditioned
    (near-grazing) lanes (phase 5's K2 / K6 rule), and a sum of lanes
    inherits that of its absolute terms.  Returns (entries that needed the
    second clause, the largest |diff| / Σ|term| among them)."""
    import torch

    offs, n_term, worst = [], 0, 0.0
    for k in ("sphere_center", "sphere_radius"):      # Σ|term| ≥ |Σ term|: the scale is sane
        if bool((g[k].abs() > scale[k] * (1 + 1e-5) + 1e-12).any()):
            raise AssertionError(f"{tag}: |d {k}| above its Σ|term|")
    for k, b in g_m.items():
        if not b.numel():
            continue
        err = (g[k] - b).abs()
        ok = err <= 1e-4 * float(b.abs().max()) + 1e-7
        if k in scale:
            by_term = ~ok & (err <= 1e-4 * scale[k] + 1e-7)
            n_term += int(by_term.sum())
            if bool(by_term.any()):
                worst = max(worst, float((err[by_term] / scale[k][by_term]).max()))
            ok |= by_term
        if not bool(torch.isfinite(g[k]).all()) or not bool(ok.all()):
            offs.append(f"{tag} {k}: {int((~ok).sum())} entries off, max err "
                        f"{float(err.max()):.4g} (max|g| {float(b.abs().max()):.4g})")
    if offs:
        raise AssertionError("\n".join(offs))
    return n_term, worst


def _h_remat_check(tag, on, off, loss_on, loss_off, hists, bank=False):
    """Remat on against off, one step each under deterministic algorithms:
    the loss and every new param bit for bit, but the sky image's, whose
    gradient is the sum of the K3 histograms (their inputs must be equal
    bit for bit and each output within the float64 bound,
    ``_check_hists``) or, with ``bank``, the sky bank's: both add with
    float atomics in an order that varies with the launches around them.
    Returns the image entries that differ."""
    import torch

    _equal(tag, "loss with remat", loss_on, loss_off)
    (h_off, o_off), (h_on, o_on) = hists["off"], hists["on"]
    if len(h_on) != len(h_off) or not all(
            torch.equal(a, b) for x, y in zip(h_on, h_off) for a, b in zip(x[:4], y[:4])):
        raise AssertionError(f"{tag}: the K3 inputs differ with remat")
    for name, h, o in (("off", h_off, o_off), ("on", h_on, o_on)):
        if h:
            _check_hists(h, f"{tag} remat {name} K3", n=len(h), outputs=o)
    img_off = 0
    for k in on:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (on[k], off[k]))):
            if k == "images" and (h_off or bank):
                img_off += int((a != b).sum())
            else:
                _equal(tag, f"param {k} with remat", a, b)
    return img_off


def phase_h_route(scene, tag, kernel, manual_expect, extra=None):
    """H1 / H2: one ``make_train_step`` step of the plain-autograd route
    (``manual_vjp=False``) at 512², spp 16, depth 16 with ``remat`` off and
    on, against the manual route's step (phase 7's start, target and first
    key).  ``kernel`` is the hit kernel (K4, K5), ``manual_expect`` the
    manual step's launch counts, ``extra`` the autograd step's other
    kernels.  Under deterministic algorithms first: remat off (its hits
    recorded) and on, equal by :func:`_h_remat_check`; then each route counted
    and timed once: launches exact (the hit kernel 17 without remat, 17 +
    16 with it: the backward recomputes every bounce but the last, whose
    carry feeds nothing), the loss within rtol 1e-5 of the manual step's,
    every gradient by :func:`_h_grads_close`, step seconds and
    peak memory; the recorded hits against the fused bounce
    (:func:`_h_hit_flips`)."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.parallel.render import _local_render, make_train_step

    cam = Camera.reference_demo(W, H)
    with torch.no_grad():
        target = _local_render(scene, cam, DEPTH, SPP, scene.params, rng.PRNGKey(1), 0, H)
    start, key = _perturbed(scene.params), rng.fold(rng.PRNGKey(2), 0)
    kw = dict(spp=SPP, depth=DEPTH, learning_rate=H_LR)
    steps = {"manual": make_train_step(scene, cam, **kw),
             "remat off": make_train_step(scene, cam, manual_vjp=False, remat=False, **kw),
             "remat on": make_train_step(scene, cam, manual_vjp=False, remat=True, **kw)}
    rec, hists, terms = [], {"off": ([], []), "on": ([], [])}, []
    with _deterministic():
        with _swapped(scene, "hit_fn", _RecordingHit(scene.hit_fn, rec)), \
                _recording_hists(*hists["off"]), _hit_term_sums(scene, terms):
            off, loss_off = steps["remat off"](start, target, key)
        with _recording_hists(*hists["on"]):
            on, loss_on = steps["remat on"](start, target, key)
        torch.cuda.synchronize()
    det = _h_remat_check(tag, on, off, loss_on, loss_off, hists, scene.sky_bank is not None)
    scale = _geo_term_scale(scene, start, terms)
    del on, off, hists, terms
    runs = {name: _h_step(st, start, target, key, f"{tag} {name} step")
            for name, st in steps.items()}
    expect = {"manual": manual_expect,
              "remat off": _expect(**{kernel: DEPTH + 1}, **(extra or {})),
              "remat on": _expect(**{kernel: 2 * DEPTH + 1}, **(extra or {}))}
    for name, (_, _, c, *_) in runs.items():
        if c != expect[name]:
            raise AssertionError(f"{tag} {name} launches {c}, expected {expect[name]}")
    loss_m = float(runs["manual"][1])
    g_m = _h_grads(start, runs["manual"][0])
    worst = {}
    for name in ("remat off", "remat on"):
        loss = float(runs[name][1])
        if abs(loss - loss_m) > 1e-5 * abs(loss_m):
            raise AssertionError(f"{tag} {name}: loss {loss!r} against the manual route's "
                                 f"{loss_m!r}")
        g = _h_grads(start, runs[name][0])
        by_term = _h_grads_close(f"{tag} {name}: gradients vs the manual route", g, g_m, scale)
        # the largest |diff| / max|g| and the tensor, over the tensors whose
        # limit is not their atol's (a tensor of |g| < 1e-3 is held to 1e-7)
        worst[name] = max(((float((g[k] - g_m[k]).abs().max()) / float(g_m[k].abs().max()), k)
                           for k in g_m if g_m[k].numel() and float(g_m[k].abs().max()) > 1e-3),
                          default=(0.0, None)) + by_term
    flips, lanes, err = _h_hit_flips(scene, start, rec, tag)
    del rec
    fig = {name: {"seconds": r[3], "peak_gib": r[4], "step_gib": r[5]} for name, r in runs.items()}
    log(f"[{tag}] {W}x{H} spp {SPP} depth {DEPTH} ({W * H * SPP:,} rays), one step each: "
        + "; ".join(f"{name}: launches {runs[name][2]}, loss {float(runs[name][1])!r}, "
                    f"{f['seconds']:.4f} s, peak {f['peak_gib']:.3f} GiB ({f['step_gib']:.3f} "
                    f"GiB above its start)" for name, f in fig.items())
        + f"; gradients against the manual route: largest |diff| / max|g| and its tensor "
        f"over the tensors of max|g| > 1e-3, entries within only 1e-4 of their Σ|term| and "
        f"the largest |diff| / Σ|term| of those {worst}; remat on vs off under deterministic algorithms: loss and params bit for "
        f"bit but the sky image's {det} entries (K3's inputs equal, its outputs within "
        f"the float64 bound); "
        f"{kernel}'s hits vs the fused bounce: {flips} flips over {lanes:,} lanes "
        f"(float64-adjudicated near-ties), t max abs err {err:.3g}")
    return {"runs": fig, "flips": flips, "worst": worst, "det": det}


def phase_h3_k4_gradient(scene):
    """H3: K4's own gradient.  On a demo chunk's 65,536 primary rays (the
    128 rows about the frame's middle), Σ w·t + Σ v·normal (hit lanes; ``w``, ``v`` uniform in [-0.5, 0.5)
    from a seeded generator, 0 on lanes whose decisions differ from the
    dense hit's) differentiated through K4's wrapper on the card, with
    respect to every geometry param and the rays, against the dense plain
    hit's autograd: each tensor within 1e-4 of its largest entry."""
    import torch
    from ptx_torch.core import rng
    from ptx_torch.geom.fasthit import GEO_KEYS
    from ptx_torch.ops import fasthit_kernel

    y0 = (H - BAND_ROWS) // 2
    o, d, *_ = _primary_band(scene, rng.fold(rng.PRNGKey(0), 0, y0), y0, BAND_ROWS)
    dev = o.device
    gen = torch.Generator(dev).manual_seed(0)
    w = torch.rand(o.shape[0], device=dev, generator=gen) - 0.5
    v = torch.rand((o.shape[0], 3), device=dev, generator=gen) - 0.5
    with torch.no_grad():
        k, p = scene.hit_fn(scene.params, o, d), scene.plain_hit_fn(scene.params, o, d)
    same = (k["_evt"] == p["_evt"]) & (k["hit"] == p["hit"]) & (k["entering"] == p["entering"])
    w, v = torch.where(same, w, 0.0), torch.where(same[:, None], v, 0.0)

    def grads(hit_fn):
        prm = {key: scene.params[key].clone().requires_grad_(True) for key in GEO_KEYS}
        rays = [o.clone().requires_grad_(True), d.clone().requires_grad_(True)]
        out = hit_fn(dict(scene.params, **prm), *rays)
        loss = (w * out["t"]).sum() + (v * torch.where(out["hit"][:, None], out["normal"],
                                                        0.0)).sum()
        g = torch.autograd.grad(loss, [*prm.values(), *rays], allow_unused=True)
        torch.cuda.synchronize()
        return {name: torch.zeros_like(x) if gx is None else gx
                for name, x, gx in zip([*GEO_KEYS, "o", "d"], [*prm.values(), *rays], g)}

    launches = fasthit_kernel.LAUNCHES
    g_k = grads(scene.hit_fn)
    if fasthit_kernel.LAUNCHES != launches + 1:
        raise AssertionError("H3: K4's wrapper did not launch K4 once")
    g_p = grads(scene.plain_hit_fn)
    offs = _close_per_tensor("H3 K4 gradient vs the dense hit's autograd", g_k, g_p)
    if offs:
        raise AssertionError("\n".join(offs))
    if not all(float(g_k[name].abs().sum()) > 0 for name in ("sphere_center", "o", "d")):
        raise AssertionError("H3: K4's gradient is zero")
    rel = {name: float((g_k[name] - g_p[name]).abs().max()) / max(
        float(g_p[name].abs().max()), 1e-30) for name in g_p if g_p[name].numel()}
    log(f"[H3 K4 gradient] {o.shape[0]:,} rays, {int((~same).sum())} lanes off the dense "
        f"hit's decisions (weight 0); |diff| / max|g| per tensor {rel}; |d sphere_center| "
        f"{float(g_k['sphere_center'].abs().sum()):.4g}, |d o| "
        f"{float(g_k['o'].abs().sum()):.4g}")
    return rel


def run_path_h(scene, dev):
    """Path H: the plain-autograd route on the demo (K4) and on S1 (K5's
    hit mode), and K4's own gradient."""
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes import builders

    h1 = _timed("H1 autograd route, demo", phase_h_route, scene, "H1 demo", "K4",
                _expect_demo(1, 1), {"SB": 1, "SB bwd": 2})
    s1 = compile_scene(builders.stress_spheres(249), dev)
    h2 = _timed("H2 autograd route, S1", phase_h_route, s1, "H2 S1", "K5",
                _expect(k6_steps=1, K5=DEPTH + 1, K6=DEPTH))
    del s1
    h3 = _timed("H3 K4 gradient", phase_h3_k4_gradient, scene)
    return h1, h2, h3


# ---------------------------------------------------------------------------
# path I: the roofline (python -m ptx_torch.roofline): K10, K11, and K4 and
# the forward trace placed against the card's measured ceilings
# ---------------------------------------------------------------------------

I_K10_SHAPE = (8192, 128)       # tools/roofline.py:58: GRID x ROWS, LANES
I_K11_SHAPE = (32768, 1024)     # tools/roofline.py:121: 128 MiB of float32
I_K10_TIMING_R = 16             # K10's R where the kernels line times it beside its plain version
I_MEASURES = ("fp32_chain", "hbm_torch_loop", "hbm_copy_kernel", "tensor_bf16_matmul",
              "hit_kernel", "trace_forward", "trace_forward")


def bound_k10(n, reps):
    """K10 on n elements, ``reps`` passes: 3 × 256 operations an element a
    pass at the unfused float32 rate (the port builds with -fmad=false, and
    the published 67 TFLOP/s counts a fused multiply-add as two), or 8 bytes
    an element at the HBM rate."""
    from ptx_torch import roofline
    from ptx_torch.ops import roofline_kernel

    t_o = n * roofline_kernel.STEPS * 3 * reps / roofline.FP32_UNFUSED * 1e3
    t_b = 8 * n / HBM_BPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def bound_k11(n):
    """K11 on n elements: each read once and written once, one add each."""
    return _bound(8 * n, n)


def _i_inputs(dev, seed=14):
    """K10's input, uniform in [0.25, 0.5], and K11's, normal, at the tool's
    full shapes, from a seed."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.empty(I_K10_SHAPE, device=dev).uniform_(0.25, 0.5, generator=gen)
    return x, torch.randn(I_K11_SHAPE, device=dev, generator=gen)


def phase_i1_roofline_kernels(dev):
    """K10 (R 1, c 1e-3: every element moves) and K11 against their plain
    versions on the card at the tool's full shapes, bit for bit; one launch
    each."""
    import torch
    from ptx_torch.ops import roofline_kernel as rk

    x, y = _i_inputs(dev)
    _reset_counters()
    k10, k11 = rk.fma_chain(x, 1, c=1e-3), rk.copy_plus_one(y)
    torch.cuda.synchronize()
    c = _counters()
    if c != _expect(K10=1, K11=1):
        raise AssertionError(f"I1: launch counts {c}")
    p10, p11 = rk.fma_chain_reference(x, 1, c=1e-3), rk.copy_plus_one_reference(y)
    moved = int((p10 != x).sum())
    if moved != x.numel():
        raise AssertionError(f"I1: K10's plain chain left {x.numel() - moved} elements unmoved")
    errs = {}
    for name, k, p in (("K10", k10, p10), ("K11", k11, p11)):
        diff = int((k != p).sum())
        errs[name] = float((k - p).abs().max())
        if diff or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"I1: {name} differs from its plain version on {diff} of "
                                 f"{k.numel()} elements (max abs err {errs[name]:.3g})")
    log(f"[I1 roofline kernels] K10 (8192x128, R 1, c 1e-3) and K11 (32768x1024, 128 MiB) "
        f"equal to their plain versions bit for bit; launches {c['K10']} / {c['K11']}")
    return errs


def phase_i2_roofline(dev):
    """``python -m ptx_torch.roofline`` through its ``main``, at the tool's
    sizes, the counters zeroed just before: every line re-logged, the
    launches exact (K10 one a window, K11 and K4 one an R, K1 17 a forward
    and its warm-up; K4 also 64 bare launches in each of 3 queued windows),
    no measured rate above its physical ceiling."""
    import io
    import math
    from ptx_torch import roofline

    _reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = roofline.main(["--device", f"cuda:{dev.index or 0}"])
    c = _counters()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    for ln in lines:
        log("[I2 roofline] " + json.dumps(ln))
    if rc != 0 or tuple(ln["measure"] for ln in lines) != I_MEASURES:
        raise AssertionError(f"I2: exit {rc}, measures {[ln['measure'] for ln in lines]}")
    w = 1 + roofline.REPS
    expect = _expect(K10=2 * w, K11=(16 + 48) * w, K4=(64 + 192) * w + 64 * roofline.REPS,
                     K1=2 * (40 + 1) * (DEPTH + 1), SB=2 * (40 + 1))
    if c != expect:
        raise AssertionError(f"I2: launch counts {c}, expected {expect}")
    for ln in lines:
        bad = [k for k, v in ln.items() if isinstance(v, float) and not (math.isfinite(v)
                                                                           and v > 0)]
        if bad:
            raise AssertionError(f"I2 {ln['measure']}: not a positive finite figure: {bad}")
    fp32, loop, copy, mm, hit, tf0, tf1 = lines
    # the chain cannot beat 128 unfused operations a clock an SM, nor a copy the HBM
    for name, share in (("K10", fp32["share_of_unfused_peak"]),
                        ("K11", copy["share_of_published_peak"]),
                        ("torch loop", loop["share_of_published_peak"])):
        if share > 1.02:
            raise AssertionError(f"I2: {name} at {share:.4f} of its ceiling: it cannot "
                                 "have done the work counted")
    log(f"[I2 roofline] K10 {fp32['fp32_tops_per_s']:.4f} T op/s ("
        f"{fp32['share_of_unfused_peak']:.4f} of the unfused 33.5, SM clock "
        f"{fp32.get('clocks_sm_mhz')} MHz); HBM torch loop {loop['hbm_gb_per_s']:.1f} GB/s, "
        f"K11 {copy['hbm_gb_per_s']:.1f} GB/s; bf16 matmul {mm['bf16_tflops_per_s']:.1f} "
        f"TFLOP/s; K4 {hit['seconds_per_call'] * 1e3:.4f} ms a chained call, "
        f"{hit['share_of_fp32_chain']:.4f} of K10's rate (the bare launch queued "
        f"{hit['launch_queued_seconds'] * 1e3:.4f} ms, {hit['launch_share_of_fp32_chain']:.4f}); "
        f"forward "
        f"{tf0['seconds'] * 1e3:.3f} / {tf1['seconds'] * 1e3:.3f} ms (compact off / on), "
        f"hit fraction {tf0['hit_kernel_fraction_at_full_width']:.4f} / "
        f"{tf1['hit_kernel_fraction_at_full_width']:.4f}; launches {c}")
    return {"lines": lines, "counts": c}


def phase_i3_timing(dev):
    """K10 (R ``I_K10_TIMING_R``) and K11 (one pass over 128 MiB): the
    wrapper, the plain version (K10's the median of 3: 768 launches an R),
    K11's library call ``torch.add(x, 1, out=)``, the wrapper again; each
    beside its bound.  Returns ``(ms, plain_ms, bound, library_ms)`` a
    kernel, ``ms`` the better of the wrapper's two readings."""
    import torch
    from ptx_torch.ops import roofline_kernel as rk

    x, y = _i_inputs(dev)
    o10, o11 = torch.empty_like(x), torch.empty_like(y)
    R = I_K10_TIMING_R
    kern = {"K10": lambda: rk.fma_chain(x, R, out=o10), "K11": lambda: rk.copy_plus_one(y, out=o11)}
    first = {k: _time_ms(fn) for k, fn in kern.items()}
    plain = {"K10": _time_ms(lambda: rk.fma_chain_reference(x, R), reps=3, warmup=1),
             "K11": _time_ms(lambda: rk.copy_plus_one_reference(y))}
    lib = {"K10": None, "K11": _time_ms(lambda: torch.add(y, 1, out=o11))}
    again = {k: _time_ms(fn) for k, fn in kern.items()}
    bound = {"K10": bound_k10(x.numel(), R), "K11": bound_k11(y.numel())}
    out = {}
    for k in kern:
        ms = min(first[k], again[k])
        out[k] = (ms, plain[k], bound[k], lib[k])
        log(f"[I3 timing] {k}: wrapper {first[k]:.4f} / {again[k]:.4f} ms (each the median of "
            f"20 calls between CUDA events), plain {plain[k]:.4f} ms, library "
            f"{'none' if lib[k] is None else f'{lib[k]:.4f} ms'}; bound {bound[k][0]:.4g} ms "
            f"({bound[k][1]}), the wrapper at {bound[k][0] / ms:.4f} of it")
    return out


def run_path_i(dev):
    """Path I: the roofline's kernels against their plain versions, the
    roofline itself through its entry point, the kernels' timings."""
    errs = _timed("I1 roofline kernels", phase_i1_roofline_kernels, dev)
    i2 = _timed("I2 roofline", phase_i2_roofline, dev)
    timing = _timed("I3 roofline timing", phase_i3_timing, dev)
    return errs, i2, timing


# ---------------------------------------------------------------------------
# path J: the rng kernel (rng.uniform_many on the card)
# ---------------------------------------------------------------------------

J_KEY = 18                      # path J's base key: PRNGKey(18)
# the rng kernel's ceiling: 76 int32 operations a uniform (20 rounds of add,
# rotate and xor, 10 key adds, the counter, the mantissa), at most 128
# dispatched a clock an SM (four schedulers, a 32-lane instruction each)
RNG_OPS_PER_UNIFORM = 76
INT32_OPS_PER_S = 128 * 132 * 1.98e9


def bound_rng(uniforms):
    """The rng kernel on ``uniforms`` draws: their integer operations or
    their 4-byte outputs written at the HBM rate, the larger."""
    t_o = uniforms * RNG_OPS_PER_UNIFORM / INT32_OPS_PER_S * 1e3
    t_b = 4 * uniforms / HBM_BPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def phase_j1_rng_kernel(dev):
    """The rng kernel at a demo train step's phase-0 draws (2 keys ×
    4,194,304 ``u_coin``, 2 × 12,582,912 ``u3``): equal to the plain int64
    route on the card bit for bit, one launch each; the kernel, the plain
    route (the median of 5) and the kernel again, each the median of 20
    single calls between CUDA events, the kernel also queued behind a device
    sleep (the card's time), beside its bound."""
    import math

    import torch
    from ptx_torch.core import rng
    from ptx_torch.ops import rng_kernel as rk

    kbs = [rng.fold(rng.PRNGKey(J_KEY), b) for b in range(2)]
    B = W * H * SPP
    out = {}
    for name, d, shape in (("u_coin", 1, (B,)), ("u3", 2, (B, 3))):
        keys = [rng.fold(k, d) for k in kbs]
        launches = rk.LAUNCHES
        got = rng.uniform_many(keys, shape, dev)
        torch.cuda.synchronize()
        if rk.LAUNCHES != launches + 1:
            raise AssertionError(f"J1 {name}: {rk.LAUNCHES - launches} launches, expected 1")
        want = rng.uniform_many_reference(keys, shape, dev)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if diff:
            raise AssertionError(f"J1 {name}: the kernel differs from the int64 route on "
                                 f"{diff} of {got.numel()} draws")
        del got, want
        kern = lambda: rng.uniform_many(keys, shape, dev)
        k1 = _time_ms(kern)
        p = _time_ms(lambda: rng.uniform_many_reference(keys, shape, dev), reps=5, warmup=1)
        k2 = _time_ms(kern)
        q = _time_queued_ms(kern)
        n = len(keys) * math.prod(shape)
        bound = bound_rng(n)
        out[name] = {"uniforms": n, "ms": min(k1, k2), "plain_ms": p, "queued_ms": q,
                     "bound": bound}
        log(f"[J1 rng kernel] {name}: {len(keys)} keys x {shape} ({n:,} uniforms) equal to "
            f"the int64 route bit for bit, one launch; the wrapper {k1:.4f} / {k2:.4f} ms, "
            f"queued {q:.4f} ms, plain {p:.4f} ms; bound {bound[0]:.4g} ms ({bound[1]}), the "
            f"queued kernel at {bound[0] / q:.4f} of it")
    return out


def phase_j2_rng_step(scene):
    """Two demo train steps (512², spp 16, depth 16) under a CPU-only
    profiler capture (the recorder on; no device trace, which later
    phases' one-call traces must not follow): the rng kernel 9 launches a
    step (6 phase draws, the camera's jitter, 2 compaction offsets) by
    ``LAUNCHES`` and by the recorder's ``rng_kernel_launches``; no plain
    draw on the device (``threefry2x32`` never given a tensor)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.ops import rng_kernel as rk
    from ptx_torch.parallel.render import make_train_step
    from ptx_torch.utils import profiling

    step = make_train_step(scene, Camera.reference_demo(W, H), spp=SPP, depth=DEPTH,
                           learning_rate=LR)
    target = torch.zeros((H, W, 3), device=scene.device)
    step(scene.params, target, rng.PRNGKey(J_KEY))
    torch.cuda.synchronize()
    tensor_calls = []
    threefry = rng.threefry2x32

    def spy(*args):
        if any(isinstance(a, torch.Tensor) for a in args):
            tensor_calls.append(args)
        return threefry(*args)

    steps = 2
    profiling.reset()
    launches = rk.LAUNCHES
    with _swapped(rng, "threefry2x32", spy), profile(activities=[ProfilerActivity.CPU]):
        for i in range(steps):
            step(scene.params, target, rng.fold(rng.PRNGKey(J_KEY), i + 1))
        torch.cuda.synchronize()
    counted = profiling.snapshot()["counters"].get("rng_kernel_launches", 0)
    profiling.reset()
    got = {"LAUNCHES": rk.LAUNCHES - launches, "rng_kernel_launches": counted}
    if got != dict.fromkeys(got, 9 * steps) or tensor_calls:
        raise AssertionError(f"J2: rng kernel launches over {steps} steps {got}, expected "
                             f"{9 * steps} each; plain device draws {len(tensor_calls)}")
    log(f"[J2 rng step] {steps} demo train steps: rng kernel launches {got} (9 a step), no "
        f"plain device draw")
    return {"launches_per_step": 9}


def run_path_j(scene, dev):
    """Path J: the rng kernel against the int64 route at a step's widest
    draws, timed; its launches over demo train steps."""
    j1 = _timed("J1 rng kernel", phase_j1_rng_kernel, dev)
    j2 = _timed("J2 rng step", phase_j2_rng_step, scene)
    return j1, j2


# ---------------------------------------------------------------------------
# Path K: the sky bank (ptx_torch/ops/sky_bank.py), the emission of a scene
# whose one dynamic emitter is a terminal sky chain (the demo, config 4)
# ---------------------------------------------------------------------------

K_WIDTHS = (65_536, 4_194_304)      # a render wavefront's lanes, a train step's
K_KEY = 23                          # path K's base key: PRNGKey(23)
K_PHASES = ((2, 1), (4, 3), (11, 16))   # trace_rays's schedule at depth 16: (bounces, divisor)


def sky_bank_records(scene, B, seed):
    """One ``trace_rays`` call's records at ``B`` lanes in the schedule's
    three phases, made on the card from ``seed``: random materials, 80 %
    live, throughput with zeros; a fifth of the lanes all sky (several sky
    records: the first with nonzero throughput counts); sky positions at
    texel centres mapped back through the chain, so that every route picks
    the same texel; a tenth of each phase compaction's dead fillers."""
    import math

    import torch

    bank, P, dev = scene.sky_bank, scene.params, scene.device
    assert not bank.mirror
    H, W = P["images"][bank.img_id].shape[:2]
    M = scene.material_fn.n_materials
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, device=dev, generator=g)
    saved = []
    for nb, div in K_PHASES:
        Bp = B // div
        mid = torch.randint(0, M, (nb, Bp), device=dev, generator=g)
        mid[:, u(Bp) < 0.2] = bank.sky
        live = u(nb, Bp) < 0.8
        thr = u(nb, Bp, 3) * 2.0 * (u(nb, Bp, 1) < 0.9)
        filler = torch.arange(Bp, device=dev) >= Bp - Bp // 10
        live &= ~filler
        thr = thr * (~filler)[None, :, None]
        xi = torch.randint(0, W, (nb, Bp), device=dev, generator=g).double()
        yi = torch.randint(0, H, (nb, Bp), device=dev, generator=g).double()
        theta = ((xi + 0.5) / W - 0.5) * 2.0 * math.pi
        phi = (0.5 - (yi + 0.5) / H) * math.pi
        d = torch.stack([torch.cos(phi) * torch.cos(theta), torch.cos(phi) * torch.sin(theta),
                         torch.sin(phi)], -1) * (2.0 + 298.0 * u(nb, Bp, 1).double())
        if bank.xform_idx is not None:
            A = P["tex_xform"][bank.xform_idx].double()
            d = (d - A[:, 3]) @ torch.linalg.inv(A[:, :3]).T
        other = torch.randn((nb, Bp, 3), device=dev, generator=g) * 50.0
        pos = torch.where((mid == bank.sky)[..., None], d.float(), other)
        saved.append((pos.contiguous(), thr.contiguous(), mid, live, None))
    return saved


def sky_bank_reference64(scene, saved, cts, absolute=False):
    """The sky bank's outputs in float64, written out directly (no autograd,
    no kernel): each phase's contribution and ``d_thr``, then ``d_const``,
    ``d_factor`` and ``d_img``; with ``absolute``, the same on the inputs'
    absolute values (each entry's Σ|term|).  The picks are the plain
    route's (the first live sky record with nonzero float32 throughput),
    the texels its chain's (``emission_kernel.lanes_reference``)."""
    import torch
    from ptx_torch.ops import emission_kernel as ek

    bank, table, P, dev = scene.sky_bank, scene.material_fn, scene.params, scene.device
    f = torch.abs if absolute else (lambda x: x)
    img = P["images"][bank.img_id]
    H, W, C = img.shape
    img64 = f(img.double()).reshape(-1, C)[:, :3]
    fac = (f(P["factor"][bank.factor_idx].double()) if bank.factor_idx is not None
           else torch.ones(3, dtype=torch.float64, device=dev))
    rows = table.const_rows("emissive", dev)
    em = f(P["const"].double())[rows]
    kern = ek.EmissionKernel(table, dev)
    M = table.n_materials
    d_em = torch.zeros((M, 3), dtype=torch.float64, device=dev)
    d_fac = torch.zeros(3, dtype=torch.float64, device=dev)
    d_img3 = torch.zeros((H * W, 3), dtype=torch.float64, device=dev)
    outs, d_thrs, picks = [], [], []
    for (pos, thr, mid, live, _), ct in zip(saved, cts):
        t64, c64 = f(thr.double()), f(ct.double())
        mat = live & (mid != bank.sky)
        e_rec = torch.where(mat[..., None], em[mid], 0.0)
        is_sel = live & (mid == bank.sky) & (thr.abs().sum(-1) > 0)
        any_ = is_sel.any(0)
        first = torch.argmax(is_sel.to(torch.uint8), 0)
        pick = lambda a: a.gather(0, first[None, :, None].expand(1, -1, 3))[0]
        texel = ek.lanes_reference(kern, P["tex_xform"], P["const"], P["factor"], img,
                                   pick(pos), torch.full_like(first, bank.sky))[1].long()
        ok = any_ & (texel >= 0)
        tex = torch.where(ok[:, None], img64[texel.clamp(min=0)], 0.0)
        tp = pick(t64)
        e_sky = tex * fac
        outs.append((t64 * e_rec).sum(0) + torch.where(any_[:, None], tp * e_sky, 0.0))
        onehot = (torch.arange(thr.shape[0], device=dev)[:, None] == first[None]) & any_[None]
        d_thrs.append(c64[None] * e_rec + onehot[..., None] * (c64 * e_sky)[None])
        d_em.index_add_(0, mid[mat], (c64[None] * t64)[mat])
        dem = c64 * tp
        d_fac += (dem * tex)[ok].sum(0)
        d_img3.index_add_(0, texel[ok], (dem * fac)[ok])
        picks.append((torch.where(any_, first, -1), torch.where(any_, texel, -1)))
    keep = torch.arange(M, device=dev) != bank.sky
    d_const = torch.zeros(P["const"].shape, dtype=torch.float64, device=dev).index_add_(
        0, rows[keep], d_em[keep])
    d_factor = torch.zeros(P["factor"].shape, dtype=torch.float64, device=dev)
    if bank.factor_idx is not None:
        d_factor[bank.factor_idx] = d_fac
    d_img = torch.zeros((H, W, C), dtype=torch.float64, device=dev)
    d_img[..., :3] = d_img3.reshape(H, W, 3)
    return outs, d_thrs, d_const, d_factor, d_img, picks


def _sky_bank_cts(saved, seed):
    """Random cotangents, 70 % of the lanes nonzero."""
    import torch

    g = torch.Generator(device=saved[0][1].device).manual_seed(seed)
    return [torch.randn((thr.shape[1], 3), device=thr.device, generator=g)
            * (torch.rand(thr.shape[1], device=thr.device, generator=g) < 0.7)[:, None]
            for _, thr, *_ in saved]


def _flat_records(saved):
    return [x for pos, thr, mid, live, _ in saved for x in (pos, thr, mid, live)]


def sky_bank_check(scene, B, seed, tag):
    """The sky bank at ``B`` lanes against its plain route, raising on a
    failure: the picked records and texels equal to the plain route's;
    each contribution and the gradients of the const table, the factor and
    the image within ``min(2·n·2⁻²⁴,
    1e-4)·Σ|term|`` of :func:`sky_bank_reference64` (n the entry's terms);
    ``d_thr`` equal to the plain route's autograd in float32, bit for bit
    (one product a record in both); a second run the same bits in every
    output but the image's gradient (float atomics).  Returns the largest
    |kernel − float64| / Σ|term|."""
    import torch
    from ptx_torch.ops import sky_bank

    bank, P, table = scene.sky_bank, scene.params, scene.material_fn
    img = P["images"][bank.img_id]
    saved = sky_bank_records(scene, B, seed)
    flat = _flat_records(saved)
    cts = _sky_bank_cts(saved, seed + 1)
    args = (P["tex_xform"], P["const"], P["factor"], img)
    outs, sel = bank.launch(*args, flat)
    got = bank.launch_bwd(cts, P["const"], P["factor"], img, sel, flat)
    ref = sky_bank_reference64(scene, saved, cts)
    mag = sky_bank_reference64(scene, saved, cts, absolute=True)
    torch.cuda.synchronize()
    worst = 0.0

    def within(name, a, b, m, n):
        nonlocal worst
        lim = min(2 * n * 2.0 ** -24, 1e-4) * m
        off = (a.double() - b).abs()
        if not bool(torch.isfinite(a).all()) or bool((off > lim).any()):
            raise AssertionError(f"{tag} B={B}: {name} off the float64 route in "
                                 f"{int((off > lim).sum())} entries")
        worst = max(worst, float((off / m.clamp(min=1e-30)).max()))

    n_rec = sum(t.shape[0] * t.shape[1] for _, t, *_ in saved)
    for k, ((nb, _), (first, texel)) in enumerate(zip(K_PHASES, ref[5])):
        lanes = slice(sum(t.shape[1] for _, t, *_ in saved[:k]),
                      sum(t.shape[1] for _, t, *_ in saved[:k + 1]))
        if not (torch.equal(sel[lanes, 0].long(), first)
                and torch.equal(sel[lanes, 1].long(), texel)):
            raise AssertionError(f"{tag} B={B}: phase {k}'s picks or texels differ")
        within(f"phase {k}'s contribution", outs[k], ref[0][k], mag[0][k],
               2 * nb + table.n_materials)
    for name, a, b, m in zip(("d_const", "d_factor", "d_img"), got[1:], ref[2:5], mag[2:5]):
        within(name, a, b, m, n_rec)

    # d_thr: the plain route's autograd in float32
    thrs = [t.detach().clone().requires_grad_(True) for _, t, *_ in saved]
    plain = sky_bank.reference(table, P, [(p, t, m, lv, o) for (p, _, m, lv, o), t
                                          in zip(saved, thrs)])
    want = torch.autograd.grad(plain, thrs, cts)
    for k, (a, b) in enumerate(zip(got[0], want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} B={B}: phase {k}'s d_thr differs from the plain "
                                 f"route's in {int((a != b).sum())} entries")

    # run to run: the same bits but the image's atomics
    outs2, sel2 = bank.launch(*args, flat)
    got2 = bank.launch_bwd(cts, P["const"], P["factor"], img, sel2, flat)
    same = (all(torch.equal(a, b) for a, b in zip(outs, outs2)) and torch.equal(sel, sel2)
            and all(torch.equal(a, b) for a, b in zip(got[0], got2[0]))
            and torch.equal(got[1], got2[1]) and torch.equal(got[2], got2[2]))
    if not same:
        raise AssertionError(f"{tag} B={B}: two runs differ outside the image's gradient")
    picked = int((sel[:, 0] >= 0).sum())
    log(f"[{tag}] B={B} ({n_rec:,} records, {picked:,} lanes pick the sky): picks and "
        f"texels equal, d_thr equal to the plain route's, two runs the same bits but "
        f"d_img; largest |kernel - float64| / Σ|term| {worst:.3g}")
    return worst


def phase_k1_sky_bank(scene, tag="K1 sky bank"):
    """K1: :func:`sky_bank_check` at a render wavefront's and a train
    step's widths."""
    return max(sky_bank_check(scene, B, 31 + i, tag) for i, B in enumerate(K_WIDTHS))


def bound_sky_bank(saved, img):
    """The sky bank's bytes, forward and backward: per record thr (12 B),
    mid (8 B), live (1 B); per lane the picked position (12 B), the
    contribution (12 B), the pick and texel (8 B); the backward also writes
    d_thr (12 B a record), reads each lane's cotangent (12 B) and its pick
    and texel (8 B), and writes the image's gradient once (the picked
    record's throughput is among the records' reads).  Operations are a few
    a record: bytes bound it."""
    recs = sum(t.shape[0] * t.shape[1] for _, t, *_ in saved)
    lanes = sum(t.shape[1] for _, t, *_ in saved)
    fwd = 21 * recs + 32 * lanes + 12 * img.numel() // img.shape[2]
    bwd = 33 * recs + 20 * lanes + 4 * img.numel()
    return _bound(fwd, 0), _bound(bwd, 0)


def phase_k2_sky_bank_timing(scene):
    """K2: the sky bank at a wavefront's and a train step's widths, in turns
    with its plain route (plain, kernel, kernel, plain): the forward's
    wrapper as ``trace._emission`` calls it (one kernel), its bare launch
    queued behind a device sleep, the plain forward; the backward's
    wrapper (two kernels), queued, beside the plain route's forward +
    backward (autograd); the bound.  Fails unless the profiler counts 1
    kernel in the forward's wrapper and 2 in the backward's."""
    import torch
    from ptx_torch.ops import sky_bank

    bank, P, table = scene.sky_bank, scene.params, scene.material_fn
    img = P["images"][bank.img_id]
    out = {}
    for i, B in enumerate(K_WIDTHS):
        saved = sky_bank_records(scene, B, 41 + i)
        flat = _flat_records(saved)
        cts = _sky_bank_cts(saved, 51 + i)
        args = (P["tex_xform"], P["const"], P["factor"], img)
        with torch.no_grad():
            wrap = lambda: bank(P, saved)
            plain = lambda: sky_bank.reference(table, P, saved)
            n_fwd = _kernels_launched(wrap)
            p1, w1, w2, p2 = _time_ms(plain), _time_ms(wrap), _time_ms(wrap), _time_ms(plain)
            q = _time_queued_ms(lambda: bank.launch(*args, flat))
            sel = bank.launch(*args, flat)[1]
        bwd = lambda: bank.launch_bwd(cts, P["const"], P["factor"], img, sel, flat)
        n_bwd = _kernels_launched(bwd)
        thrs = [t.detach().clone().requires_grad_(True) for _, t, *_ in saved]
        leaves = [P["const"].detach().clone().requires_grad_(True),
                  P["factor"].detach().clone().requires_grad_(True)]
        pp = dict(P, const=leaves[0], factor=leaves[1])

        def plain_fb():
            o = sky_bank.reference(table, pp, [(p, t, m, lv, None) for (p, _, m, lv, _), t
                                               in zip(saved, thrs)])
            return torch.autograd.grad(o, thrs + leaves, cts)

        r1, b1, b2, r2 = _time_ms(plain_fb), _time_ms(bwd), _time_ms(bwd), _time_ms(plain_fb)
        bq = _time_queued_ms(bwd)
        fb, bb = bound_sky_bank(saved, img)
        if (n_fwd, n_bwd) != (1, 2):
            raise AssertionError(f"K2 sky bank at B={B}: the forward's wrapper launched "
                                 f"{n_fwd} kernels, the backward's {n_bwd}, not 1 and 2")
        log(f"[K2 sky bank] B={B}: kernels in the profiler {n_fwd} forward, {n_bwd} backward; "
            f"forward wrapper {w1:.4f} / {w2:.4f} ms, queued "
            f"{q:.4f} ms, plain route {p1:.4f} / {p2:.4f} ms, bound {fb[0]:.4g} ms "
            f"({fb[1]}), {fb[0] / q:.3f} of it queued; backward wrapper "
            f"{b1:.4f} / {b2:.4f} ms, queued {bq:.4f} ms, plain forward + backward "
            f"{r1:.4f} / {r2:.4f} ms, bound {bb[0]:.4g} ms, {bb[0] / bq:.3f} of it queued")
        out[B] = {"ms": min(w1, w2), "queued_ms": q, "plain_ms": min(p1, p2), "bound": fb,
                  "bwd_ms": min(b1, b2), "bwd_queued_ms": bq, "plain_fb_ms": min(r1, r2),
                  "bwd_bound": bb}
    return out


def phase_k3_sky_bank_launches(scene):
    """K3: the sky bank's launches a demo train step (1 forward, 2
    backward) and a render wavefront (1), by ``LAUNCHES`` / ``BWD_LAUNCHES``
    and the recorder's ``sky_bank_launches`` under a CPU-only capture; no
    K3 and no K7 launch (the sky's gradient is the bank's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ptx_torch.core import rng
    from ptx_torch.integrate.camera import Camera
    from ptx_torch.integrate.render import render_rows
    from ptx_torch.parallel.render import make_train_step
    from ptx_torch.utils import profiling

    cam = Camera.reference_demo(W, H)
    step = make_train_step(scene, cam, spp=SPP, depth=DEPTH, learning_rate=LR)
    target = torch.zeros((H, W, 3), device=scene.device)
    step(scene.params, target, rng.PRNGKey(K_KEY))
    torch.cuda.synchronize()
    got = {}
    for name, run in (("step", lambda: step(scene.params, target, rng.PRNGKey(K_KEY + 1))),
                      ("wavefront", lambda: render_rows(scene, scene.params, cam,
                                                        rng.PRNGKey(K_KEY + 2), 0, BAND_ROWS,
                                                        1, 1, DEPTH))):
        profiling.reset()
        _reset_counters()
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad() if name != "step" \
                else contextlib.nullcontext():
            run()
            torch.cuda.synchronize()
        c = _counters()
        got[name] = {"LAUNCHES": c["SB"], "BWD_LAUNCHES": c["SB bwd"],
                     "sky_bank_launches": profiling.snapshot()["counters"].get(
                         "sky_bank_launches", 0), "K3": c["K3"], "K7": c["K7"]}
        profiling.reset()
    want = {"step": {"LAUNCHES": 1, "BWD_LAUNCHES": 2, "sky_bank_launches": 3, "K3": 0,
                     "K7": 0},
            "wavefront": {"LAUNCHES": 1, "BWD_LAUNCHES": 0, "sky_bank_launches": 1, "K3": 0,
                          "K7": 0}}
    if got != want:
        raise AssertionError(f"K3 sky bank launches {got}, expected {want}")
    log(f"[K3 sky bank launches] {got}")
    return got


def run_path_k(scene):
    """Path K: the sky bank against its plain route at a wavefront's and a
    train step's widths, timed; its launches a step and a wavefront."""
    k1 = _timed("K1 sky bank", phase_k1_sky_bank, scene)
    k2 = _timed("K2 sky bank timing", phase_k2_sky_bank_timing, scene)
    k3 = _timed("K3 sky bank launches", phase_k3_sky_bank_launches, scene)
    return k1, k2, k3


def _timed(label, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase seconds] {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ptx_torch.integrate.trace import compile_scene
    from ptx_torch.scenes import builders

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()
    name, smi = phase_device()
    build_s = _timed("2 build", phase_build)

    # the demo: K1, K2, K3
    scene = compile_scene(builders.make_world(), dev)
    flips3, err3, inputs = _timed("3 K1 primary bounces", phase_kernel_vs_plain, scene)
    flips3c, err3c = _timed("3 K1 render chunks", phase_compacted_chunks, scene)
    render_launches, wall, rays_s = _timed("4 render", phase_slice, scene)
    flips4 = _timed("4 band", phase_band_vs_plain, scene)
    err_k2, err_k3, err_k8a, k2_in, k3_in = _timed("5 K2 K3 K8", phase_backward_kernels,
                                                   scene)
    _timed("6 gradients", phase_gradients, scene)
    train, secs, peak, target = _timed(
        "7 train", phase_train, scene, "7 train",
        _expect_demo(3, 3))
    flips8, err8_1, err8_2, err8_3, k3_train_in = _timed(
        "8 train-width kernels", phase_train_kernels, scene, target)
    del target

    # path A, config 4: the unfused bounce on K4, the checker's gradient on K3
    c4 = compile_scene(builders.baseline_config4(), dev)
    flipsA, err4, k4_in = _timed("A1 K4 chunk", phase_k4_chunk, c4)
    c4_rays_s = _timed("A2 render config4", phase_render_cli, "config4", "A2 render",
                       _expect(K4=(H // BAND_ROWS) * SPP * (DEPTH + 1),
                               SB=(H // BAND_ROWS) * SPP))
    train4, secs4, peak4, err3a, k3_checker_in = _timed("A3 config4 train",
                                                        phase_train_config4, c4)
    _timed("A4 config4 gradients", phase_gradients, c4, "A4 config4 gradients")

    # path B, the 1536x3072 probe: the sky's gradient on K8
    pb = compile_scene(builders.make_world(
        sky_image=builders.procedural_sky_image(*PROBE)), dev)
    trainB, secsB, peakB, err8, k8_in = _timed("B probe train", phase_probe, pb)
    del pb

    # path C, the emission kernel K7: the demo with PTX_EMK=1, a mirror-ball sky
    pe = _compile_with_emk(builders.make_world(), dev)
    err7a, near_a, err7ba, k7_fwd_in, k7_bwd_in = _timed("C1 K7 chunk", phase_k7_chunk, pe,
                                                        "C1 K7 chunk")
    trainC, secsC, peakC, err7b, near_b, err7bb, k7_train_in = _timed(
        "C2 K7 train", phase_train_k7, pe)
    _timed("C3 K7 gradients", phase_gradients, pe, "C3 K7 gradients")
    pm = _compile_with_emk(_mirror_world(), dev)
    err7m, near_m, err7bm, _, _ = _timed("C4 mirror-ball chunk", phase_k7_chunk, pm,
                                         "C4 mirror-ball K7 chunk")
    *_, err7mt, near_mt, err7bmt, k7_mirror_in = _timed("C6 mirror-ball train",
                                                       phase_train_k7, pm, "C6 mirror-ball")
    _timed("C5 mirror-ball gradients", phase_gradients, pm, "C5 mirror-ball gradients")

    # path D, the large scenes: K5 (fused mega bounce, hit mode) and K6
    _timed("D1 build report", phase_build_report)
    flipsD, err5, err6, k5_in, k6_in, trainD, large = 0, 0.0, 0.0, {}, {}, {}, {}
    for nm, make in _large_scenes().items():
        sc = compile_scene(make(), dev)
        if nm != "S4":
            f, e, k5_in[nm], culled = _timed(f"D2 {nm} K5 chunk", phase_k5_chunk, sc,
                                             f"D2 {nm} K5 vs plain", nm == "S2")
            flipsD, err5 = flipsD + f, max(err5, e)
            if nm == "S2" and not culled:
                raise AssertionError("D2 S2: no lane read a culled gadget's live rows")
        if nm in ("S1", "S2"):
            e, k6_in[nm] = _timed(f"D3 {nm} K6 chunk", phase_k6_chunk, sc, f"D3 {nm} K6 vs plain")
            err6 = max(err6, e)
            _timed(f"D4 {nm} gradients", phase_gradients, sc, f"D4 {nm} gradients")
            large[nm] = sc
        extra = {"SB": 3, "SB bwd": 6} if nm == "S4" else {}
        trainD[nm] = _timed(f"D5 {nm} train", phase_train_large, sc, f"D5 {nm} train",
                            _expect(k6_steps=3, K5=3 * (DEPTH + 1), K6=3 * DEPTH, **extra),
                            nm == "S1")
        del sc
    composed_rays_s = _timed("D6 render --scene", phase_render_scene, "D6 render --scene")
    timeD = {nm: _timed(f"D7 {nm} timing", phase_timing_large, large[nm], f"D7 {nm} timing",
                        k5_in[nm], k6_in[nm], trainD["S1"][3] if nm == "S1" else None)
             for nm in ("S1", "S2")}
    (k5_ms, k5p_ms, k5_bound, _, _), (k6_ms, k6p_ms, k6_bound, _, k6_pack_ms, k6_step,
                                   k6_step_old) = timeD["S1"]
    del large, k5_in, k6_in

    # path E, the union sweep's other modes: K9, the local fold, the blocked hit
    k9_lanes, err9, flipsE, trainE, composed_k9_rays_s, timeE = run_path_e(dev)
    k9_at = timeE["S1"][0][BAND_ROWS * W]
    k9_ms, k9p_ms = k9_at["wrapper_ms"], k9_at["plain_ms"]
    k9_bound = k9_at["bound_sort_true" if k9_at["sort_inside"] else "bound_sort_false"]

    # path F: render --checkpoint / --preview / --adaptive, serve / farm (K1)
    (f1_rays, f1_diff, f1_k1), (f2_rays, f2_flips, f2_err, f2_k1), \
        (f3_rays, f3a_rays, f3c_rays, f3ca_rays, f3_flips, f3_err, f3_k1, f3a_k1) = \
        run_path_f(scene)

    # path G: the mesh on torch.distributed, the routing knobs
    g1, g2, g3, g4 = run_path_g(scene, dev)

    # path H: the plain-autograd route (manual_vjp=False, remat) on K4 and K5
    h1, h2, h3 = run_path_h(scene, dev)

    # path I: the roofline (python -m ptx_torch.roofline): K10, K11, K4, the forward
    err_i, i2, time_i = run_path_i(dev)

    fb_rays, f_rays = _timed("9 fwd+bwd", phase_fwd_bwd, scene)
    w_ms, p_ms, dev_ms, _ = _timed("10 K1 timing", phase_timing, scene, inputs)
    k2_ms, k2p_ms, k2_bound, k2_pack_ms, k2_step, k2_step_old = _timed(
        "10 K2 timing", phase_timing_backward, scene, k2_in)
    time3 = _timed("10 K3 timing", phase_timing_k3,
                   {"chunk": k3_in, "train": k3_train_in, "checker": k3_checker_in})
    k3_ms, k3p_ms, k3_lib, k3_bound, k3_add = time3["chunk"]
    k4_t, k8_t = _timed("10 K4 K8 timing", phase_timing_small, c4, k4_in, k8_in)
    time7 = _timed("10 K7 timing", phase_timing_k7,
                   {"chunk": (pe, k7_fwd_in, k7_bwd_in), "train": (pe, *k7_train_in),
                    "mirror-ball train": (pm, *k7_mirror_in)})
    del k7_fwd_in, k7_bwd_in, k7_train_in, k7_mirror_in, pm
    # path K, the sky bank: K1 and K2 here, where one-call device traces
    # count kernels (they counted none after the step profile's capture
    # and after path J's), K3's CPU-only capture after path J
    err_sb = _timed("K1 sky bank", phase_k1_sky_bank, scene)
    time_sb = _timed("K2 sky bank timing", phase_k2_sky_bank_timing, scene)
    prof7 = _timed("10 K7 step profile", phase_k7_step_profile)

    # path J: the rng kernel (rng.uniform_many on the card), after every
    # phase that counts kernels in a device trace: those one-call traces
    # lost their kernel three times in three when path J ran before phase 9
    j1, j2 = run_path_j(scene, dev)
    launch_sb = _timed("K3 sky bank launches", phase_k3_sky_bank_launches, scene)
    k7_t = time7["chunk"]
    k1_bound = bound_k1(inputs[0].shape[0], scene.bounce_fn.layout[0])
    log(f"summary: build {build_s:.2f} s; flips {flips3} (primary bounces) + "
        f"{flips3c} (render chunks) + {flips4} (band) + {flips8} (train step) + {flipsA} "
        f"(K4); render {rays_s:.4g} rays/s (K1 launches {render_launches}), config4 "
        f"{c4_rays_s:.4g} rays/s; train step demo {min(secs):.3f} s / {peak:.3f} GiB, "
        f"config4 {min(secs4):.3f} s / {peak4:.3f} GiB, probe {min(secsB):.3f} s / "
        f"{peakB:.3f} GiB, K7 demo {min(secsC):.3f} s / {peakC:.3f} GiB; K7 lanes on "
        f"another texel at a boundary {near_a} + {near_b} + {near_m} + {near_mt}; fwd+bwd chunk "
        f"{fb_rays:.4g} "
        f"rays/s, fwd {f_rays:.4g} rays/s; K1 {w_ms:.4f} ms vs plain {p_ms:.4f} ms "
        f"(bound {k1_bound[0]:.4g} ms, {k1_bound[1]}); K2 {k2_ms:.4f} vs {k2p_ms:.4f} ms "
        f"(bound {k2_bound[0]:.4g} ms), pack + VJP {k2_pack_ms:.4f} ms once per call, "
        f"per step {k2_step:.4f} ms against {k2_step_old:.4f} ms per bounce; K3 "
        f"{k3_ms:.4f} vs {k3p_ms:.4f} ms, index_put_ {k3_lib:.4f} ms, index_add_ "
        f"{k3_add:.4f} ms (bound {k3_bound[0]:.4g} ms), at the train width "
        f"{time3['train'][0]:.4f} ms against index_add_ {time3['train'][4]:.4f} ms, on the "
        f"checker {time3['checker'][0]:.4f} ms against {time3['checker'][4]:.4f} ms; K4 "
        f"{k4_t[0]:.4f} vs "
        f"{k4_t[1]:.4f} ms (bound {k4_t[2][0]:.4g} ms); K7 {k7_t['ms']:.4f} vs "
        f"{k7_t['plain_ms']:.4f} ms (bound {k7_t['bound'][0]:.4g} ms; queued at the train "
        f"width {time7['train']['queued_ms']:.4f} ms against {time7['train']['bound'][0]:.4g}), "
        f"backward {k7_t['bwd_ms']:.4f} ms vs index_add_ {k7_t['index_add_ms']:.4f} ms (train "
        f"width {time7['train']['bwd_ms']:.4f} vs {time7['train']['index_add_ms']:.4f}), "
        f"device a call over a PTX_EMK=1 step {prof7['k7_mean_us']:.2f} + "
        f"{prof7['k7_bwd_mean_us']:.2f} us; K8 {k8_t[0]:.4f} vs "
        f"{k8_t[1]:.4f} ms, index_put_ {k8_t[3]:.4f} ms, index_add_ {k8_t[4]:.4f} ms "
        f"(bound {k8_t[2][0]:.4g} ms); "
        f"large scenes: flips {flipsD}, train step "
        + ", ".join(f"{nm} {min(v[1]):.3f} s / {v[2]:.3f} GiB" for nm, v in trainD.items())
        + f", render --scene {composed_rays_s:.4g} rays/s; K5 {k5_ms:.4f} vs {k5p_ms:.4f} ms "
        f"(bound {k5_bound[0]:.4g} ms); K6 {k6_ms:.4f} vs {k6p_ms:.4f} ms (bound "
        f"{k6_bound[0]:.4g} ms), pack + VJP {k6_pack_ms:.4f} ms once per call, per step "
        f"{k6_step:.4f} ms against {k6_step_old:.4f} ms per bounce; path E: K9 == plain on {k9_lanes} lanes, flips vs K5's "
        f"plain version {flipsE}, train step (spp {SPP_E}) "
        + ", ".join(f"{nm} {min(v[1]):.3f} s / {v[2]:.3f} GiB" for nm, v in trainE.items())
        + f", render --scene (kernel mode) {composed_k9_rays_s:.4g} rays/s; K9 {k9_ms:.4f} vs "
        f"{k9p_ms:.4f} ms (bound {k9_bound[0]:.4g} ms); path F: checkpointed render "
        f"{f1_rays:.4g} rays/s (K1 {f1_k1}, resumed / fast path / preview within "
        f"{f1_diff:.3g}), adaptive {f2_rays:.4g} rays/s (K1 {f2_k1}, refine chunk flips "
        f"{f2_flips}), farm {f3_rays:.4g} rays/s (K1 {f3_k1} over the served bands), "
        f"adaptive farm {f3a_rays:.4g} rays/s (K1 {f3a_k1}), from the serve subprocesses "
        f"{f3c_rays:.4g} / {f3ca_rays:.4g} rays/s, band flips {f3_flips}; K3 / K8 largest "
        f"|k − p| / "
        f"Σ|ct| {HIST_WORST['ratio']:.3g} ({HIST_WORST['where']}, limit {HIST_REL:g}); path G: "
        f"1x1 NCCL mesh render {g1['render_s']:.3f} s (phase 4: {rays_s:.4g} rays/s), step "
        f"{g1['step_s']:.3f} s (phase 7: {min(secs):.3f} s), adaptive {g1['adaptive_s']:.3f} s, "
        f"S1 step {g2['s1_step_s']:.3f} s; all-reduce of the frame {g1['frame_ms']:.4f} ms, of "
        f"the gradient buffer ({g1['grad_numel']:,} floats) {g1['grad_ms']:.4f} ms; two gloo "
        f"ranks on the card: seconds per rank {[round(x, 2) for x in g3['rank_s']]}; knob "
        f"flips {g4}; path H: "
        + "; ".join(f"{nm} " + ", ".join(f"{k} {v['seconds']:.3f} s / {v['peak_gib']:.3f} GiB"
                                         for k, v in h["runs"].items())
                    + f", hit flips vs the fused bounce {h['flips']}"
                    for nm, h in (("demo", h1), ("S1", h2)))
        + f"; H3 K4 gradient |diff| / max|g| {max(h3.values()):.3g}; path I: K10 "
        f"{i2['lines'][0]['fp32_tops_per_s']:.4f} T op/s, K11 "
        f"{i2['lines'][2]['hbm_gb_per_s']:.1f} GB/s, K4 at "
        f"{i2['lines'][4]['share_of_fp32_chain']:.4f} of K10's rate; path J: rng kernel "
        f"{j1['u3']['ms']:.4f} ms (queued {j1['u3']['queued_ms']:.4f}) vs plain "
        f"{j1['u3']['plain_ms']:.4f} ms at {j1['u3']['uniforms']:,} uniforms (bound "
        f"{j1['u3']['bound'][0]:.4g} ms), {j2['launches_per_step']} launches a demo step; "
        f"path K: sky bank at 65,536 lanes {time_sb[K_WIDTHS[0]]['ms']:.4f} ms (queued "
        f"{time_sb[K_WIDTHS[0]]['queued_ms']:.4f}) vs plain "
        f"{time_sb[K_WIDTHS[0]]['plain_ms']:.4f} ms, at 4,194,304 queued "
        f"{time_sb[K_WIDTHS[1]]['queued_ms']:.4f} ms forward and "
        f"{time_sb[K_WIDTHS[1]]['bwd_queued_ms']:.4f} ms backward (bounds "
        f"{time_sb[K_WIDTHS[1]]['bound'][0]:.4g} / {time_sb[K_WIDTHS[1]]['bwd_bound'][0]:.4g} "
        f"ms); total "
        f"{time.perf_counter() - t_start:.1f} s; {smi}")
    entry = lambda name_, source, replaces, launches, err, ms, plain, bound, lib: {
        "name": name_, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}
    print(smi)
    print(json.dumps({"kernels": [
        entry("bounce_forward (K1: fused hit + shade + scatter)",
              "ptx_torch/csrc/bounce_kernel.cu", "ptx/ops/bounce_kernel.py:236",
              train["K1"], max(err3, err3c, err8_1, f2_err, f3_err), w_ms, p_ms, k1_bound,
              None),
        entry("bounce_backward (K2: decision-frozen replay VJP)",
              "ptx_torch/csrc/bounce_bwd_kernel.cu", "ptx/ops/bounce_kernel.py:578",
              train["K2"], max(err_k2, err8_2), k2_ms, k2p_ms, k2_bound, None),
        entry("image_hist (K3: image-gather transpose)",
              "ptx_torch/csrc/image_hist_kernel.cu", "ptx/ops/imagegrad.py:91",
              train["K3"], max(err_k3, err8_3, err3a), k3_ms, k3p_ms, k3_bound, k3_add),
        entry("first_hit (K4: hit-only CSG fold)",
              "ptx_torch/csrc/fasthit_kernel.cu", "ptx/ops/fasthit_kernel.py:233",
              train4["K4"], err4, k4_t[0], k4_t[1], k4_t[2], None),
        entry("megasweep (K5: union-sweep first hit + shade + scatter, S1)",
              "ptx_torch/csrc/megasweep_kernel.cu", "ptx/ops/megasweep.py:589",
              trainD["S1"][0]["K5"], err5, k5_ms, k5p_ms, k5_bound, None),
        entry("replay_bwd (K6: row-fed replay VJP at any L, S1)",
              "ptx_torch/csrc/replay_bwd_kernel.cu", "ptx/ops/replay_bwd.py:47",
              trainD["S1"][0]["K6"], err6, k6_ms, k6p_ms, k6_bound, None),
        dict(entry("emission_forward (K7: fused emission chain; its backward under "
                   "'backward')", "ptx_torch/csrc/emission_kernel.cu",
                   "ptx/ops/emission_kernel.py:98", trainC["K7"],
                   max(err7a, err7b, err7m, err7mt),
                   k7_t["ms"], k7_t["plain_ms"], k7_t["bound"], None),
             backward=entry("emission_backward (K7's VJP: flat histogram + factor sum)",
                            "ptx_torch/csrc/emission_kernel.cu",
                            "ptx/ops/emission_kernel.py:346", trainC["K7 bwd"],
                            max(err7ba, err7bb, err7bm, err7bmt), k7_t["bwd_ms"],
                            k7_t["bwd_plain_ms"],
                            k7_t["bwd_bound"], k7_t["index_add_ms"])),
        entry("image_hist_atomic (K8: image-gather transpose by device-memory atomics)",
              "ptx_torch/csrc/image_hist_kernel.cu", "ptx/ops/imagegrad.py:218",
              trainB["K8"], max(err8, err_k8a), k8_t[0], k8_t[1], k8_t[2], k8_t[4]),
        entry("sweep_select (K9: union-sweep prefix max, break minima, payload match, S1)",
              "ptx_torch/csrc/sweep_kernel.cu", "ptx/ops/sweep_kernel.py:164",
              trainE["S1"][0]["K9"], err9, k9_ms, k9p_ms, k9_bound, None),
        dict(entry(f"fma_chain (K10: dependent float32 chain, the FP32 ceiling; timed at R "
                   f"{I_K10_TIMING_R})", "ptx_torch/csrc/roofline_kernel.cu",
                   "tools/roofline.py:48", i2["counts"]["K10"], err_i["K10"], *time_i["K10"]),
             bound_note="operations at the unfused float32 rate, 33.5e12/s: the port builds "
                        "with -fmad=false and the published 67e12 counts an FFMA as two"),
        entry("copy_plus_one (K11: o = x + 1 over 128 MiB, the HBM ceiling)",
              "ptx_torch/csrc/roofline_kernel.cu", "tools/roofline.py:109",
              i2["counts"]["K11"], err_i["K11"], *time_i["K11"]),
        entry("uniform_many (the rng kernel: threefry2x32 uniforms of up to 64 keys, at "
              "2 x 12,582,912; launches a demo step)", "ptx_torch/csrc/rng_kernel.cu", None,
              j2["launches_per_step"], 0.0, j1["u3"]["ms"], j1["u3"]["plain_ms"],
              j1["u3"]["bound"], None),
        dict(entry("sky_bank_forward (the sky bank: mat-sum + sky-select of a trace_rays "
                   "call at 65,536 lanes; its backward under 'backward')",
                   "ptx_torch/csrc/emission_kernel.cu", None, launch_sb["step"]["LAUNCHES"],
                   err_sb, time_sb[K_WIDTHS[0]]["ms"], time_sb[K_WIDTHS[0]]["plain_ms"],
                   time_sb[K_WIDTHS[0]]["bound"], None),
             backward=entry("sky_bank_backward + sky_bank_reduce (the sky bank's VJP)",
                            "ptx_torch/csrc/emission_kernel.cu", None,
                            launch_sb["step"]["BWD_LAUNCHES"], err_sb,
                            time_sb[K_WIDTHS[0]]["bwd_ms"],
                            time_sb[K_WIDTHS[0]]["plain_fb_ms"],
                            time_sb[K_WIDTHS[0]]["bwd_bound"], None)),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] in ("--g3-rank", "--g3-nccl"):
        # path G3's ranks, started by phase_g3_two_ranks
        sys.path.insert(0, ROOT)
        worker = _g3_rank if sys.argv[1] == "--g3-rank" else _g3_nccl_rank
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
