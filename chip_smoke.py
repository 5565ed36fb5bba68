"""Smoke run of tpu_pathtracer_torch on one NVIDIA GPU.

Drives the port's main path on the card and checks it, in phases that each
print one line; any failure exits non-zero:

1. environment: versions, the card, its power limit, nvcc, triton;
2. build: compiles csrc/*.cu for sm_90a, one nvcc per source started
   together, and links the kernels into one library under
   build/tpu_pathtracer_torch/; prints registers, stack and spill bytes of
   every build (kernel and template arguments), and for each build of the
   gradient kernel the shared memory per block and the blocks per SM at
   its scenes' slots and lights and at the limits of 16 and 16; for each
   (MESH, T) build of the tangent kernel its shared memory and blocks per
   SM, and kernel 8's blocks per SM and resident grid;
3. kernel vs plain PyTorch version on the card, with the same injected
   uniforms (cornell 160x120 brute force and NEE, the point-light scene with
   NEE) and with the production Philox draws; >= 98% of lanes must agree on
   the sample count and radiance, and the ray counts within 1%;
4. main path: PersistentRenderer(device="cuda") on cornell_spheres at
   640x480, spp 4, 10 bounces, brute force then NEE, render_to(16); the
   image is finite and the kernel's launch count equals the steps taken;
   each of those launches, replayed from its own input state, agrees with
   the plain version on the card on >= 98% of lanes (or, where the f32
   chaos of the budget-32 launch is larger, on no fewer lanes than the
   plain version on the CPU agrees with itself on the card), with ray
   counts within 1%; over the whole run the ray counts agree within 1% and
   the image means within 3%; update_camera resets the accumulation;
5. CLI: ``python -m tpu_pathtracer_torch.cli render`` writes a 640x480 PNG;
6. times at bench.py's workload (640x480, budget 16, tile_rows 32): step
   time and rays/s by the slope between 1 and K steps (CUDA events, median
   of REPS), the plain version's time per step, and from one torch.profiler
   trace of 10 steps the kernel's device time per launch, the device's busy
   time (union of kernel, memcpy and memset intervals), the device's idle
   share of that same window, and the device kernels that take the most
   time per step. The profiler slows the host, so that window is longer
   than the unprofiled step. The trace is kept under
   build/tpu_pathtracer_torch/;
7. gradient kernel vs plain PyTorch version on the card: cornell 160x120,
   spp 4, 10 bounces, budget 10, brute force and NEE, on injected uniforms
   and on the production Philox draws. Phase "adjoint": >= 98% of lanes
   agree on n_samp, radiance and every per-lane GA/GI plane (or, where the
   f32 chaos is larger, no fewer than the plain version on the CPU agrees
   with itself on the card), ray counts within 1%; phase "both" equals the
   cotangent fold over the kernel's own lanes (rtol 1e-4), the fold over
   the agreeing lanes equals the plain version's (loss rtol 1e-4, gradients
   2e-3); the lanes that differ on an output may not lean one way
   (``IMAGE_Z``), and the whole-image relative gaps of loss, gradient and
   radiance are printed; then the same checks at the kernel's largest
   shared-memory block: a sphere scene with 16 slots and 16 lights
   (``limit_spheres``), NEE, spp 1 and 4 at their default budgets;
8. trainer main path, BASELINE config 5 at full width: cornell 640x480,
   spp 4, 10 bounces, budget default_budget(4, 10) = 26, brute force then
   NEE. The target comes from render_target_kernel; then 6 same-seed Adam
   steps (lr 5e-2, fixed_iteration 0) from the perturbed parameters; the
   loss after 5 updates is below the loss at step 0, everything is finite,
   and the gradient kernel launched 1 + steps times. The last step's launch
   is replayed (bit for bit) and checked against the plain version on the
   card by phase 7's bars;
9. CLI: ``python -m tpu_pathtracer_torch.cli invert`` at its defaults;
10. times at config 5: ms per gradient and fwd+bwd rays/s by the slope
   between 1 and K gradients (CUDA events, median of REPS), the plain
   version's time per gradient, and from one torch.profiler trace the
   gradient kernel's device time per launch and the device's idle share;
   a ``[replay live share]`` line (here and in phases 13, 27 and 31) gives
   the schedule's live share of lane-iterations and its warp occupancy;
11. mesh forward kernel vs plain version at 160x120 (the kernel walks the
   BVH per thread, the plain version per tile as the TPU kernel does):
   cornell_boxes brute force and NEE, cornell_glass NEE and cornell_quad
   NEE (a TRI_LIGHT, no spheres), on injected uniforms and on Philox;
   phase 3's bars plus the sign test of phases 7-8 on the radiance;
12. mesh main path: ``cli render --scene cornell-boxes`` writes a 640x480
   PNG; PersistentRenderer on cornell_quad (NEE) at 640x480, budget 16,
   until 4 spp, every launch checked from its own input state as in phase
   4; then phase 6's times for cornell_boxes and cornell_quad;
13. mesh gradient: phase 7's checks at 160x120 on cornell_boxes and
   cornell_quad with NEE; the trainer on cornell_boxes (640x480, spp 4, 10
   bounces, NEE; target + 5 Adam steps, the loss falls, the last launch
   replayed and checked); phase 10's times on that workload, the JAX
   package's mesh fwd+bwd workload;
14. tangent kernel vs plain version at 160x120, spp 4, 10 bounces, budget
   10, on injected uniforms and on Philox: cornell_spheres brute force and
   NEE (the camera position's three tangents plus the glass ball's IOR),
   cornell_glass NEE (position and IOR), cornell_quad NEE and the
   point-light scene NEE (position); phase 7's bars on n_samp, L and every
   dL plane, the sign test on every plane, ray counts within 1%; tangents
   split over launches (4 in one launch, 2 + 2, and 4 + 2 through the
   wrapper) give identical outputs;
15. the JAX suite's finite-difference checks that need a real device: the
   camera position's gradient against per-seed central differences of the
   kernel's own primal on the edge-free floor and quad fixtures
   (``tests/test_camera_jvp.py``'s bars), and the IOR gradient on the
   glass-ball fixture (8x8, spp 32, budget 134, 16 iterations, brute force
   and NEE) within rtol 0.25 of the paired central difference (h 0.02) in
   expectation, and above 0.5;
16. the IOR trainer main path: cornell_spheres NEE at config 5 (640x480,
   spp 4, 10 bounces, budget 26) from ``params_of(scene, ior=True)`` with
   the glass IOR at 1.3 and phase 8's perturbed albedo and intensity; the
   target, then 5 same-seed Adam steps: the loss falls, everything is
   finite, the tangent kernel launches once per step; the last step's
   mat_coef gradient is replayed bit for bit and its launch checked against
   the plain version by phase 14's bars. Then times for the camera
   position's gradient (cornell_spheres brute force and NEE, cornell_quad
   NEE) and the full mat_coef gradient (cornell_spheres NEE) at config 5:
   end-to-end ms per gradient (slope, median of REPS), the kernel's ms per
   launch and the device's idle share (one trace), the bound and the plain
   version's ms, and the schedule's live share per workload from the plain
   version's counts (``[16 tangent live share]``: segments over lanes x
   budget, the warp-iterations with a live lane and with every lane
   drained);
17. the packet kernel (kernel 5, the per-thread walk of pack_bvh's tree)
   on the card: three waves recorded from one frame of cornell_boxes
   (256x256, 8 spp) and of the full terrain (config 4) - the primary wave,
   the bounce-2 closest-hit wave and the bounce-1 shadow wave, each on a
   fixed random subset of 64k lanes - as closest-hit and any-hit queries,
   against its plain version packet_bvh_ref (the share of bit-equal lanes
   printed), through a random permutation against a launch on the
   permuted rays (bit for bit), and against packet_ref on the 64-leaf
   tree (the TPU kernel's contract, by triangle id) sorted and unsorted:
   hit/miss and triangle equal on >= 99.9% of lanes, t within 1e-5
   max(1, t) there, normal, uv and material equal, the sign test on t;
18. the bin kernel (kernel 6, the coarse tree's walk) on the same waves,
   with its sort key: cell, tn and key bit for bit against both plain
   versions, bin_rays_ref (the TPU kernel's sweep) and bin_tree_ref (the
   walk; its node and cell tests per live ray printed), and the two-pass
   query against the single-pass one by phase 17's bars;
19. the wavefront main path: ProgressiveRenderer(device="cuda") on the
   terrain at config 4 (1024x1024, 2 spp, 3 bounces, NEE, two-pass) renders
   4 frames with one launch of each kernel per wave (8 per frame); the
   image is finite and shows both checker tiles; one 256x256 frame agrees
   with the same frame through the plain queries on the card on >= 98% of
   pixels (or the plain CPU-vs-card floor); cli render --scene terrain
   --backend auto writes a 1024x1024 PNG; config 1 renders;
20. the wavefront against PersistentRenderer on cornell_boxes NEE at
   256x256, 64 spp: image means within 3%;
21. times at config 4, two-pass and single-pass: ms per frame (CUDA events,
   slope between 1 and 3 frames, median of REPS), one profiler trace of 2
   frames (kernels 5 and 6 per launch, sort and gather glue, other ops,
   idle share); then every wave query of one more frame (closest-hit and
   shadow, at its full 2M lanes, with the permutation the kernels received
   it in) runs again through the plain versions on the same inputs: kernel
   5's answers are held to phase 17's bars against packet_bvh_ref and
   packet_ref, kernel 6's (cell, tn, key) bit for bit to both of its plain
   versions, the plain versions' counts of that work give both kernels'
   bounds (kernel 6: the walk's node and cell tests), and their ms per
   wave is printed; a
   ``[packet walk tests]`` line gives, per wave kind, the live share and
   the box and triangle tests per live ray on pack_bvh's leaf-<=4 tree and
   on the 64-leaf tree, and kernel 5's bound per wave in operations and in
   bytes on each;
22. the forward kernel with a thin lens (radius 4, focused at 60) against
   its plain version at 160x120: cornell_spheres and cornell_boxes, brute
   force and NEE (7 and 10 draws), injected and Philox, phase 11's bars;
23. the lens main path: PersistentRenderer with the lens on both scenes in
   both modes at 640x480, budget 16, to 4 spp, every launch checked as in
   phase 4; each image differs from the pinhole render (max |d| > 0.05);
24. the gradient kernel with the lens against its plain version (phase 7's
   checks at 160x120), and the lens trainer at config 5 (brute force and
   NEE, target + 5 Adam steps: the loss falls, the last launch replayed and
   checked by phase 7's bars);
25. the forward kernel with textures against its plain version at
   640x480, NEE: the checker quad of the JAX suite and terrain_textured(32)
   (1,922 triangles), injected and Philox, phase 11's bars; the textured
   main path (PersistentRenderer on terrain32, 3 bounces, to 4 spp, every
   launch checked); both checker tiles through the renderer; terrain32
   through the persistent kernel against the wavefront in image mean (256x256,
   64 spp, within MEAN_TOL);
26. config 4 at full width through the persistent kernel: the terrain at
   1024x1024, 3 bounces, NEE, PersistentRenderer at budget 16,
   render_to(2) (launches counted), its mean within MEAN_TOL of phase 19's
   wavefront image; every
   launch replayed and checked as in phase 4 on three bands of tiles (top,
   middle, bottom of the image), each band also launched alone and equal
   bit for bit to the whole launch's; ms to 2 spp (median of REPS) beside
   phase 21's wavefront frame, the kernel's ms per launch and the idle
   share from one trace (the bound is a lower bound: its rays split into
   path and shadow segments as the bands' plain walks split, no texel
   fetch counted);
27. times by phase 6's and 10's protocol: the forward kernel and the
   gradient with the lens on cornell_spheres; the forward kernel on
   terrain32 textured and with its texture stripped (on a mesh or textured
   scene the plain version's ms per step is that of the one plain launch
   the bound needs);
28. texture-atlas gradients against the plain version at 640x480, spp 4,
   10 bounces, budget 10: the JAX suite's tex_scene and terrain32, brute
   force and NEE, injected and Philox. Phase 7's bars on L, n_samp, every
   GA/GI plane and every C_tot record; the scatter launch's own radiance
   sums and counts equal launch 1's on every lane (the replay is exact);
   two scatters of the same inputs (the call's own and a replay) within
   ATOMIC_RTOL of each cell's sum of |terms|; with the same cotangent,
   zeroed where kernel and plain walks disagree, the atlas gradients within
   ATLAS_RTOL of max|gT|, and not zero;
29. the textured trainer main path: terrain32 at 640x480, spp 4, 10
   bounces, budget 26, NEE; the target from render_target_kernel (one
   launch, no atlas gradient), then 5 same-seed Adam steps from params_of
   with the atlas times 0.6: the loss falls, 11 launches (5 scatters); the
   last step's launches replayed and checked by phase 28's bars, its atlas
   gradient against the replay's within the atomic bound;
30. the chunked driver: tex_scene at 160x120, spp 48 (chunks 32 + 16), NEE,
   against the plain driver on the card (loss rtol 1e-4, gradients 2e-3,
   the atlas within ATLAS_RTOL);
31. the textured gradient's times on terrain32 at 640x480, spp 4, NEE:
   end to end with and without the atlas gradient (slope, median of REPS),
   each launch's kernel ms and the idle share (one trace), the plain
   version's ms per launch and each launch's bound (a lower bound);
32. the per-sample forward kernel (kernel 8, csrc/trace.cu) against
   trace_lanes_ref on the card at 160x120, spp 4, 10 bounces:
   cornell_spheres brute force and NEE, the point-light scene with NEE,
   injected and Philox; phase 3's bars (>= 98% of lanes or the CPU floor,
   rays within 1%, the sign test);
33. the pallas_render main path on cornell 640x480, spp 4, brute force and
   NEE, two frames each: launches counted, each launch replayed bit for bit
   and held to the plain version on the card; then the JAX suite's
   TPU-only tests of tests/test_pallas_kernel.py against the port's
   wavefront: the mean ratios within 3% (brute force, cornell 64x48, 15
   iterations) and 5% (NEE, single-sphere and small, 30 iterations),
   determinism, iteration decorrelation, tile-size invariance within 5%,
   the point light;
34. the per-sample gradient kernel (kernel 7, csrc/replay.cu) against
   replay_call_ref on the card at 160x120, 10 bounces: modes "mse" and
   "vjp", brute force and NEE, with and without the lens, spp 1, 4, 16 (the
   warp-shuffle pixel mean) and 64 (the shared-memory one), injected and
   Philox; >= 98% of lanes (or the CPU floor), rays within 1%, mode "mse"
   equal to the fold of its own lanes through mode "vjp" (rtol 1e-4), the
   loss (rtol 1e-4) and gradients (2e-3) over the pixels whose lanes agree,
   the sign test; then kernel 7's ptxas line per build and its dynamic
   shared memory per block and blocks per SM (``_replay_sample_build``);
35. the engine="sample" trainer at config 5 (cornell 640x480, spp 4, 10
   bounces, strat_k 2), brute force then NEE: the target from
   render_target_kernel(engine="sample"), 5 same-seed Adam steps from phase
   8's perturbed parameters; the loss falls, 1 + 5 launches of kernel 7 and
   none of another kernel, the last launch replayed bit for bit and held to
   the plain version by phase 34's checks; then the times of both kernels
   by phase 6's and 10's protocol (slope ms, kernel ms and idle share from
   one trace, bound, plain ms), and kernel 8's live share from its plain
   version's per-lane walks (``[35 trace live share]``: vertices over 32 x
   each warp's longest walk, one item per lane, and the same share when the
   resident grid's threads take the next item as a walk ends);
36. the wavefront under autograd at config 5 (cornell 640x480, spp 4, 10
   bounces), brute force and NEE, on the same Philox draws: path replay's
   (``render_replay``) gradients of sum(w * image) w.r.t. the colour and
   light tables against autograd of ``render`` within rtol 2e-3 (atol 2e-4
   and 2e-5, the JAX suite's bar), the images equal; one band of rows
   traced on the card and on the CPU, >= 98% of lanes agreeing;
37. the wavefront trainer main path (``make_train_step``, remat): target
   from ``render_target`` and 5 same-seed Adam steps at config 5 (brute
   force, NEE) and on cornell_boxes NEE; the loss falls, everything is
   finite; on cornell_boxes kernels 5 and 6 launch once per wave in the
   forward and once more in the backward's recomputation (waves x (1 + 2
   steps), counted from 0 before the target), and once per wave for a step
   without remat; ``cli invert --estimator replay`` exits 0;
38. the IOR and geometry gradients against central differences at the CPU
   tests' fixtures and bars (the glass ball, the emissive sphere's radius
   and centre, the floor quad's translation whole and per object, kernels
   5 and 6 walking it), and one finite run of each at 640x480;
39. times at 640x480 beside the fused kernels' for the same workload (the
   CUDA-event slope between 1 and 3 calls, median of 3): the wavefront
   train step and its device idle share, its heaviest kernels and peak
   memory with and without remat; ``render_replay``'s value-and-grad;
   ``ior_value_and_grad``; ``geometry_grads``;
40. sphere_field (128 spheres) through PersistentRenderer at 640x480, spp
   4, 10 bounces, budget 16, brute force and NEE, to 4 spp: every launch
   held to the plain version by phase 4's bars and the sign test; then
   phase 6's times and bound;
41. a JSON scene file (a quad, a rotated box, a uv_sphere and an OBJ
   triangle lit as a TRI_LIGHT) through ``cli render --scene <file>`` at
   640x480 on both backends: the pallas launches replayed bit for bit and
   each held to the plain version; the xla frame's primary wave held whole
   to packet_ref (kernel 5) and bin_rays_ref (kernel 6);
42. resume from a checkpoint bit for bit: kernel 1 on cornell NEE at
   640x480 (2 + 2 steps against 4) and the config-4 wavefront (1 + 1
   frames against 2);
43. ``[bvh trees]``: the SAH tree against the NumPy median split, A B B A:
   kernel 1's terrain32 NEE launch, config 4's persistent launch (budget
   32) and config 4's wavefront device ms per frame;
44. the terminal viewer headless (cornell 192x144, 8 frames) on both
   backends, frames per second; after a drag, a frame equal to a fresh
   renderer's first frame at the moved camera.

Each kernel's bound (the least time the card could take for the same work)
is the larger of its f32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s. The operations are counted from the kernels' source per unit of
work (see ``OPS``) and multiplied by the work this run's launches did; a
mesh walk's box and triangle tests per segment are counted by
``bvh_walk_ref`` on a sample of the segments that the plain versions walk
on the same workload (``WalkSample``: the mesh's leaf-<=4 tree walked per
thread; each mesh workload prints a ``[walk tests]`` line with them beside
those of the tree the kernels walk and of the 64-triangle-leaf tree); the
bytes are each input read once and each output written once.

The line before the last prints one JSON object {"kernels": [...]}, nine
entries with the scatter launch of kernel 3 as one of its own (kernels 5
and 6 also give their launches in phase 37's trainer,
``launches_autograd_trainer``), and the
card's name and power limit, as nvidia-smi prints them, precede it. The last line of standard output
is ``{"ok": true, "device": {...}}``. Run it with no arguments from the
repository root: ``python3 chip_smoke.py``.

``python3 chip_smoke.py --ab CHECKOUT`` runs no phase: it compares the
persistent kernels' device ms per launch between this checkout and
another (``ab``), A B B A, on the workloads of phases 6, 10, 12, 13, 16,
26, 27 and 31 (spheres, cornell_boxes, cornell_quad and terrain32
forward; spheres with and without the lens, cornell_boxes, cornell_quad
and textured terrain32 gradients, the scatter launch apart; the tangent
kernel on phase 16's four workloads and at T = 4 and 2, each with a
digest of L, dL, n_samp and rays, and phase 16's gradients end to end;
config 4's launch), the sphere forward outputs and every gradient output
bit for bit (the atlas gradient within the atomic bound); and kernel 5 on
the wave queries of one config-4 frame, recorded once and answered by
each checkout's own ``intersect_mesh_packet``
(two-pass): ms per launch of the closest-hit and shadow waves, the
frame's glue ms, the bounce-1 closest-hit wave unsorted, sorted and
two-pass, each checkout's answers equal across its runs and this
checkout's held to the other's by phase 17's bars, and the bound of a
mean wave; kernel 6 on the same waves: ms per wave, its cell, tn and sort
key bit for bit across checkouts, the coarse-tree walk's tests per live
ray and the bound of a mean wave (``_ab_bin_report``); and kernel 7 on
cornell_spheres at 640x480 (``_ab_sample``: modes "mse" and "vjp", brute
force and NEE, the lens, spp 64; every output bit for bit, -0 as +0),
with kernel 8 beside it on the same injected draws, the adjoint's cost,
and on Philox draws (digests of its radiance and rays), and phase 35's
pallas_render and gradient end to end (wall ms per call, CUDA-event
slope over ``AB_WALL``); and config 4's wavefront frame, two-pass and
single-pass, as phase 21 times it: wall ms per frame, device busy ms and
the gather and index kernels' ms per frame, the image bit for bit
(``_ab_frame``). ``--ab-only``
restricts it to some of its parts (``AB_PARTS``).
``python3 chip_smoke.py --leaf-cutoff`` runs no phase either: it times the
forward kernel on small meshes packed as one leaf and as the mesh's
leaf-<=4 tree (``leaf_cutoff``), the measurement behind ``BVH_MAX_LEAF``.
"""
from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
MEAN_TOL = 0.03
RAY_TOL = 0.01
REPS = 5
# segments of the plain versions' mesh walks sampled per mode and mesh, and
# taken from each call, to count the kernels' box and triangle tests
WALK_SAMPLE, WALK_TAKE = 2048, 64
W, H, TR = 640, 480, 32
SPP, MB = 4, 10  # BASELINE config 5 and bench.py's workload
LOSS_RTOL, GRAD_RTOL, FOLD_RTOL = 1e-4, 2e-3, 1e-4
# Sums over all lanes, kernel against plain. On a lane whose f32 walk
# diverged, the two sides take exchangeable paths, so the sign of their
# difference is a fair coin; a fault in one branch moves every lane it
# touches the same way. Of the n lanes that differ on an output beyond the
# per-lane bar, the excess of one sign over the other may be at most
# IMAGE_Z * sqrt(n) (P < 3e-8 for a fair coin, by Hoeffding's bound), so a
# one-sided fault fails once it touches more than ~36 lanes.
IMAGE_Z = 6.0
PROFILE_ATTEMPTS = 5  # see _traced
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's clock, see _traced
TRAIN_STEPS, LR = 6, 5e-2
F32_PEAK = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # bytes/s
# f32 operations per unit of work, counted from csrc/*.cu (pt_common.cuh):
# add, sub, mul, div, min, max, sqrt, rsqrt, sin and cos count 1, an FMA 2;
# compares, selects, integer Philox and addressing are left out, so the
# bound is a lower bound.
OPS = {
    "quadratic": 21,  # per prim per closest-hit test
    "segment": 80,  # hit point, normal, lobe sampling, throughput, RR
    "path": 33,  # camera ray of a regenerated path, flush of L
    "shadow": 133,  # light sample, support, MIS and contribution
    "shadow_prim": 20,  # per prim of the shadow sweep (light skipped)
    "adjoint_segment": 7,  # nA, cA at the vertex
    "adjoint_flush_slot": 9,  # GA at completion, per material slot
    "adjoint_flush_light": 3,  # GI at completion, per light
    "lens": 45,  # thin_lens() of a regenerated path
    "uv": 8,  # the winner's uv at a found mesh hit (mesh_walk_uv)
    "texel": 51,  # texel(): wrap and taps 12, blend 36, colour product 3
    "walk": 6,  # reciprocal direction of a ray's BVH walk
    "slab": 22,  # slab test per node entered
    "tri": 45,  # Moller-Trumbore per triangle tested
    # the packet kernel (packet.cu): the reciprocal direction ("walk"), slab
    # and triangle tests as above, and the attributes of a found hit
    "attrs": 66,  # normal, barycentrics and uv of the winning slot
    "bin_cell": 24,  # bin.cu: slab test and the nearest-cell update per cell
    # the tangent kernel (camera_jvp.cu), per tangent; where lanes take
    # different branches the cheaper one is counted
    "tangent_path": 29,  # primary-ray tangents, dL flush
    "tangent_segment": 81,  # IFT hit tangent, mirror JVP, throughput
    "tangent_shadow": 73,  # point-light tangents, cos, MIS, dC (lit only)
    "score": 71,  # Fresnel score and cS, per IOR-tangent vertex
    # the scatter walk (replay_persistent.cu, SCATTER), per textured vertex
    # of a recorded path: texel_taps 12 and the weights 1 - fx, 1 - fy 2,
    # the value per channel 7 (C_tot - C, ok * it + nee, g *, max, 1 /, *);
    # per tap per channel the two weight products and the atomic add
    "scatter_vertex": 35,
    "scatter_add": 3,
}
JVP_W, JVP_H, JVP_BUDGET = 160, 120, 10
IOR_START = 1.3  # the trainer's starting glass IOR (true: 1.5)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_environment():
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    smi = smi.splitlines()[0] if smi else "nvidia-smi printed nothing"
    from tpu_pathtracer_torch.ops.kernels import _build

    try:
        nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        nvcc = f"nvcc unavailable: {e}"
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        gxx = f"g++ unavailable: {e}"
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    print(f"[1 environment] torch {torch.__version__} cuda "
          f"{torch.version.cuda} device '{torch.cuda.get_device_name(0)}' "
          f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | "
          f"nvcc: {nvcc} | g++ (the host BVH builder): {gxx} | triton: "
          f"{has_triton}", flush=True)
    return smi


def phase_build():
    """Build the library; print registers, stack and spills per build."""
    from tpu_pathtracer_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path, compile_s = _build.build()
    log = path.with_suffix(".log")
    report = _build.ptxas_report(log.read_text()) if log.is_file() else {}
    builds = " | ".join(
        f"{k}: {v.get('regs')} regs, {v.get('stack')} B stack, "
        f"{v.get('spill_st')}/{v.get('spill_ld')} B spill st/ld"
        for k, v in report.items())
    print(f"[2 build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {compile_s:.2f} s); "
          f"ptxas: {builds or 'no register report'}", flush=True)
    _replay_occupancy()
    _tangent_trace_occupancy(report)
    return report


def _tangent_trace_occupancy(report):
    """Kernel 4's shared memory per block and blocks per SM for each
    (MESH, T) build beside its registers, stack and spills, and kernel 8's
    blocks per SM and resident grid (the card's occupancy calculator)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    parts = []
    for mesh in (False, True):
        for n_tan in range(1, cj.MAX_TAN + 1):
            nbytes, blocks = cj.tangent_blocks_per_sm(mesh, n_tan)
            r = report.get(f"camera_jvp_kernel<{int(mesh)},{n_tan}>", {})
            parts.append(
                f"<{int(mesh)},{n_tan}>: {r.get('regs')} regs, "
                f"{r.get('stack')} B stack, {r.get('spill_st')}/"
                f"{r.get('spill_ld')} B spill st/ld, {nbytes} B shared, "
                f"{blocks} blocks per SM")
    r = report.get("trace_kernel", {})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = tk._trace_grid(0)
    print("[2 tangent occupancy] camera_jvp_kernel<MESH,T>: " + " | ".join(
        parts) + f" || [2 trace occupancy] trace_kernel: {r.get('regs')} "
        f"regs, {r.get('stack')} B stack, {r.get('spill_st')}/"
        f"{r.get('spill_ld')} B spill st/ld, {grid // sms} blocks per SM, "
        f"{sms} SMs, a grid of {grid} blocks", flush=True)


# (slots, lights) of kernel 3's scenes: cornell_spheres; cornell_boxes and
# cornell_quad; terrain32; limit_spheres, the kernel's limits
OCCUPANCY_SCENES = ((5, 1), (4, 1), (2, 1), (16, 16))


def _replay_occupancy():
    """Kernel 3's shared memory per block and the blocks per SM that it and
    each build's registers allow (the card's occupancy calculator), for the
    slots and lights of its scenes and at the limits."""
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    parts = []
    for name, kw in (("spheres", dict(mesh=False, tex=False)),
                     ("mesh", dict(mesh=True, tex=False)),
                     ("textured", dict(mesh=True, tex=True)),
                     ("scatter", dict(mesh=True, tex=True, scatter=True))):
        for dof in (False, True):
            cells = []
            for n_slots, n_l in OCCUPANCY_SCENES:
                nbytes, blocks = rp.blocks_per_sm(n_slots, n_l, dof=dof, **kw)
                cells.append(f"{n_slots}/{n_l}: {nbytes} B, {blocks}")
            parts.append(f"{name}{' lens' if dof else ''} " + ", ".join(cells))
    print("[2 replay occupancy] kernel 3, slots/lights: shared memory per "
          "block, blocks per SM: " + " | ".join(parts), flush=True)


def _checker_quad(device):
    """The checker quad of the JAX suite (tests/test_persistent.py:494-528):
    a two-colour checker on a quad whose material colour is not white, lit
    by a point light, and its camera."""
    from tpu_pathtracer_torch.models import meshes, scene as sc
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    scene = sc.make_scene(
        [], [sc.diffuse([0.7, 1.0, 0.9])],
        [sc.point_light([0.0, 8.0, 0.0], [60.0, 60.0, 60.0])],
        mesh=build_bvh(v, f, uv, 0, device=device),
        textures=meshes.checker_texture(16, tiles=4, c0=(0.9, 0.15, 0.1),
                                        c1=(0.05, 0.85, 0.9)),
        mat_texture=[0], device=device)
    return scene, dict(eye=[0, 14, 9], look_at=[0, 0, 0], up=[0, 1, 0],
                       fov=60.0)


def _terrain32(device, textured=True):
    """terrain_textured(n=32): 1,922 triangles, under BIG_MESH_TRIS, so the
    CLI's auto backend renders it through the persistent kernel; with
    ``textured`` false the same scene with its texture stripped."""
    import dataclasses

    from tpu_pathtracer_torch.models import scene as sc

    scene, cs = sc.terrain_textured(n=32, device=device)
    return (scene if textured
            else dataclasses.replace(scene, textures=None)), cs


EXTRA_SCENES = {
    "checker": _checker_quad,
    "tex-scene": lambda device: _tex_scene(device),
    "terrain32": _terrain32,
    "terrain32-bare": lambda device: _terrain32(device, textured=False),
}
# A thin lens of radius 4 focused at 60 (tests/test_persistent.py:224-227).
LENS = dict(lens_radius=4.0, focal_distance=60.0)


def _scene(name, w, h, device, lens=None):
    """A built-in scene (its mesh packed for the persistent kernels), its
    camera (with ``lens`` = LENS, a thin-lens camera) and packed camera."""
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    build = EXTRA_SCENES.get(name) or sc.BUILTIN_SCENES[name]
    scene, cs = build(device=device)
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device=device, **(lens or {}))
    return sc.with_packet_mesh(scene), cam, pack_camera(cam)


def _cornell(w, h, device):
    return _scene("cornell", w, h, device)


def _point(w, h, device):
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    scene = sc.make_scene(
        [sc.sphere([0, -1e4 - 1, 0], 1e4, 0)],
        [sc.diffuse([0.7, 0.7, 0.7])],
        [sc.point_light([0, 3, 0], [40.0, 40.0, 40.0])], device=device)
    cam = cm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], w, h, 60.0,
                         device=device)
    return scene, cam, pack_camera(cam)


SPHERE_CASES = [
    # (name, scene builder, w, h, tile_rows, budget, use_nee, injected)
    ("cornell-brute", _cornell, 160, 120, 32, 8, False, True),
    ("cornell-nee", _cornell, 160, 120, 32, 8, True, True),
    ("point-nee", _point, 16, 12, 8, 8, True, True),
    ("cornell-nee-philox", _cornell, 160, 120, 32, 8, True, False),
]
MESH_CASES = [
    (f"{name}-{'nee' if nee else 'brute'}-{'injected' if inj else 'philox'}",
     lambda w, h, dev, name=name: _scene(name, w, h, dev), 160, 120, 32, 8,
     nee, inj)
    for name, nee in (("cornell-boxes", False), ("cornell-boxes", True),
                      ("cornell-glass", True), ("cornell-quad", True))
    for inj in (True, False)
]
DOF_CASES = [
    (f"{name}-lens-{'nee' if nee else 'brute'}-"
     f"{'injected' if inj else 'philox'}",
     lambda w, h, dev, name=name: _scene(name, w, h, dev, LENS), 160, 120,
     32, 8, nee, inj)
    for name in ("cornell", "cornell-boxes") for nee in (False, True)
    for inj in (True, False)
]
TEX_CASES = [
    (f"{name}-nee-{'injected' if inj else 'philox'}",
     lambda w, h, dev, name=name: _scene(name, w, h, dev), W, H, 32, 8, True,
     inj)
    for name in ("checker", "terrain32") for inj in (True, False)
]


def phase_compare(cases=SPHERE_CASES, label="3 kernel vs plain"):
    """Kernel vs plain version on the card, and the sign test of phases 7-8
    on the radiance of the lanes that differ; returns the worst numbers."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = dict(n_agree=1.0, l_agree=1.0, max_abs_err=0.0, sign_balance=0.0)
    parts = []
    for name, build, w, h, tr, budget, use_nee, injected in cases:
        scene, cam, cp = build(w, h, dev)
        kw = dict(budget=budget, width=w, height=h, max_bounces=10,
                  rr_start=3, tile_rows=tr, use_nee=use_nee,
                  use_dof=cam.use_dof)
        st_k = pk.init_state(w, h, tr, device=dev)
        st_r = st_k.clone()
        rays_k, rays_r = 0, 0
        for _ in range(2):
            u = None
            if injected:
                rows = st_k.lr.shape[0] * budget * pk.n_draws(use_nee,
                                                              cam.use_dof)
                u = torch.rand((rows, pk.LANES), generator=gen, device=dev)
            st_r, nr = pk.persistent_step_ref(scene, cp, (5, 1), st_r,
                                              uniforms=u, **kw)
            rays_r += int(nr)
            st_k, nk = pk.persistent_step(scene, cp, (5, 1), st_k,
                                          uniforms=u, **kw)
            rays_k += int(nk)
        torch.cuda.synchronize()
        if not (torch.isfinite(pk.state_image(st_k, w, h)).all()
                and torch.isfinite(pk.state_image(st_r, w, h)).all()):
            fail(f"{name}: non-finite radiance")
        n_ok, l_ok, dmax = lane_agreement(st_r, st_k, w, h)
        ray_err = abs(rays_k - rays_r) / max(rays_r, 1)
        sign, n_off = _sign_balance(
            [(torch.stack([st_k.lr, st_k.lg, st_k.lb]),
              torch.stack([st_r.lr, st_r.lg, st_r.lb]))], w * h)
        parts.append(f"{name}: n {n_ok:.4f} L {l_ok:.4f} max|dL| {dmax:.3g} "
                     f"rays {rays_k}/{rays_r} sign balance {sign:.3f} of its "
                     f"bar ({n_off} lanes)")
        if n_ok < AGREE or l_ok < AGREE or ray_err > RAY_TOL or sign > 1.0:
            fail(f"kernel vs plain {name}: n_agree {n_ok}, l_agree {l_ok}, "
                 f"rays {rays_k} vs {rays_r}, sign balance {sign} of its bar "
                 f"({n_off} lanes)")
        worst["n_agree"] = min(worst["n_agree"], n_ok)
        worst["l_agree"] = min(worst["l_agree"], l_ok)
        worst["max_abs_err"] = max(worst["max_abs_err"], dmax)
        worst["sign_balance"] = max(worst["sign_balance"], sign)
    print(f"[{label}] " + " | ".join(parts), flush=True)
    return worst


def _render_plain(scene, cp, seed, steps, use_nee, budget, use_dof=False,
                  max_bounces=10):
    """The plain version driven as the renderer drives the kernel: the same
    seed, salt 0, frames 0..steps-1, so the same Philox draws. Returns the
    state and the live rays it traced."""
    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st = pk.init_state(W, H, TR, device=scene.device)
    rays = 0
    for _ in range(steps):
        st, nr = pk.persistent_step_ref(
            scene, cp, (seed, 0), st, budget=budget, width=W, height=H,
            max_bounces=max_bounces, rr_start=3, tile_rows=TR,
            use_nee=use_nee, use_dof=use_dof)
        rays += int(nr)
    return st, rays


def _replay_per_step(scene, cam, cp, use_nee, main):
    """Replay the main path's launches one at a time and check each: a second
    renderer with the same seed takes the same steps, and before each step
    the plain version runs from a copy of the kernel's input state, on the
    same Philox draws, on the card and on the CPU. Returns, per launch, the
    kernel's agreement with the plain version on the card, the plain
    version's agreement with itself across the two backends and the sign
    test of the radiance of the lanes that differ (``_sign_balance``; only
    phase 40 holds a main path to it). Fails unless the replay ends in the
    main path's exact state.

    Each launch is checked from a shared input because a lane whose f32
    closest hit flips once takes other paths for every later sample, so over
    a whole run the share of diverged lanes grows with the iterations run.
    The plain version on the CPU against itself on the card is the floor of
    that chaos for one launch: the same code, rounded by two math
    libraries. The floor is computed only for a launch below the 98% bar
    (it is reported as 1.0 otherwise)."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch import PersistentRenderer
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    w, h = cam.width, cam.height
    r = PersistentRenderer(scene, cam, main.config, seed=main.seed,
                           device="cuda", budget=main.budget)
    scene_cpu, cp_cpu = scene.to("cpu"), cp.cpu()
    kw = dict(budget=r.budget, width=w, height=h,
              max_bounces=main.config.max_bounces, rr_start=3, tile_rows=TR,
              use_nee=use_nee, use_dof=cam.use_dof)
    out = []
    for _ in range(main.state.frame):
        before = r.state.clone()
        rays_k = r.step()
        ref, rays_r = pk.persistent_step_ref(scene, cp, (r.seed, 0), before,
                                             **kw)
        n_ok, l_ok, dmax = lane_agreement(ref, r.state, w, h)
        n_fl = l_fl = 1.0
        if min(n_ok, l_ok) < AGREE:
            before_cpu = dataclasses.replace(
                before,
                **{f: getattr(before, f).cpu() for f in pk.STATE_FIELDS})
            ref_cpu, _ = pk.persistent_step_ref(scene_cpu, cp_cpu,
                                                (r.seed, 0), before_cpu, **kw)
            n_fl, l_fl, _ = lane_agreement(ref, ref_cpu, w, h)
        sign, n_off = _sign_balance(
            [(torch.stack([r.state.lr, r.state.lg, r.state.lb]),
              torch.stack([ref.lr, ref.lg, ref.lb]))], w * h)
        out.append(dict(n_agree=n_ok, l_agree=l_ok, max_abs_err=dmax,
                        n_floor=n_fl, l_floor=l_fl, sign_balance=sign,
                        n_off=n_off,
                        ray_err=abs(rays_k - int(rays_r))
                        / max(int(rays_r), 1)))
    for f in pk.STATE_FIELDS:
        if not torch.equal(getattr(r.state, f), getattr(main.state, f)):
            fail(f"the replay of the main path differs in {f}")
    return out


def _bands(state, bands):
    """The bands of tiles ``bands`` ((first tile, tiles) pairs) of a state of
    TR-row tiles, copied into one state, in order."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    return dataclasses.replace(state, **{
        f: torch.cat([getattr(state, f)[t0 * TR:(t0 + nt) * TR]
                      for t0, nt in bands]) for f in pk.STATE_FIELDS})


def _replay_bands(main, bands, walks=None):
    """``_replay_per_step`` for a main path too large for the plain version
    over every lane: the same replay, but each launch is checked on the
    bands of tiles ``bands`` ((first tile, tiles) pairs) alone. From each
    band of the launch's input state the kernel runs again on the band
    (``tile_offset``, the same Philox draws), and must give that band of the
    whole launch bit for bit, since lanes do not interact. The plain version
    runs once on the card from all the bands together (``tile_offset`` a
    list of tiles: its per-tile walk costs about as much for three tiles as
    for one); its live rays are held to the band launches' and its lanes to
    the whole launch's, band by band. The plain version on the CPU, the
    floor, runs only for a launch below the 98% bar. The plain version on
    the card samples its walks' segments into ``walks``. Returns one dict
    per launch and band and the plain version's seconds per launch; fails
    unless the replay ends in main's exact state."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch import PersistentRenderer
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    scene, cam = main.scene, main.camera
    cp = pack_camera(cam)
    r = PersistentRenderer(scene, cam, main.config, seed=main.seed,
                           device="cuda", budget=main.budget)
    scene_cpu, cp_cpu = scene.to("cpu"), cp.cpu()
    kw = dict(budget=r.budget, width=cam.width, height=cam.height,
              max_bounces=main.config.max_bounces,
              rr_start=main.config.rr_start, tile_rows=TR,
              use_nee=main.config.use_nee, use_dof=cam.use_dof)
    tiles = [t for t0, nt in bands for t in range(t0, t0 + nt)]
    out, seconds = [], []
    for launch in range(main.state.frame):
        before = r.state.clone()
        r.step()
        got = _bands(r.state, bands)
        k_rays = 0
        for t0, nt in bands:
            k_st, nr = pk.persistent_step(scene, cp, (r.seed, 0),
                                          _bands(before, [(t0, nt)]),
                                          tile_offset=t0, **kw)
            k_rays += int(nr)
            for f in pk.STATE_FIELDS:
                if not torch.equal(getattr(k_st, f),
                                   getattr(_bands(r.state, [(t0, nt)]), f)):
                    fail(f"launch {launch}, tiles {t0}+{nt}: the band "
                         f"launch differs from the whole launch in {f}")
        t_start = time.perf_counter()
        ref, rays_r = pk.persistent_step_ref(scene, cp, (r.seed, 0),
                                             _bands(before, bands),
                                             tile_offset=tiles, walks=walks,
                                             **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t_start)
        ray_err = abs(k_rays - int(rays_r)) / max(int(rays_r), 1)

        def per_band(a, b):
            res, row = [], 0
            for _, nt in bands:
                part = [_bands(x, [(row // TR, nt)]) for x in (a, b)]
                res.append(lane_agreement(*part, nt * TR * pk.LANES, 1))
                row += nt * TR
            return res

        checks = per_band(ref, got)
        floors = [(1.0, 1.0, 0.0)] * len(bands)
        if min(min(c[0], c[1]) for c in checks) < AGREE:
            b_cpu = _bands(before, bands)
            b_cpu = dataclasses.replace(
                b_cpu, **{f: getattr(b_cpu, f).cpu()
                          for f in pk.STATE_FIELDS})
            ref_cpu, _ = pk.persistent_step_ref(
                scene_cpu, cp_cpu, (r.seed, 0), b_cpu, tile_offset=tiles,
                **kw)
            floors = per_band(ref, ref_cpu)
        for band, (n_ok, l_ok, dmax), (n_fl, l_fl, _) in zip(
                bands, checks, floors):
            out.append(dict(launch=launch, tiles=band, n_agree=n_ok,
                            l_agree=l_ok, max_abs_err=dmax, n_floor=n_fl,
                            l_floor=l_fl, rays=(k_rays, int(rays_r)),
                            ray_err=ray_err))
    for f in pk.STATE_FIELDS:
        if not torch.equal(getattr(r.state, f), getattr(main.state, f)):
            fail(f"the replay of the main path differs in {f}")
    return out, seconds


def phase_main_path(name="cornell", modes=(False, True), budget=32,
                    target=16, label="4 main path",
                    lens=None, max_bounces=10):
    """PersistentRenderer on ``name`` (with ``lens``, a thin-lens camera)
    until ``target`` spp in each mode, every launch replayed and checked
    (``_replay_per_step``), the whole run against the plain version's, and
    update_camera. Returns the kernel's launches in the rendering runs,
    those on a mesh scene, the worst agreement numbers and each mode's
    image."""
    import torch

    from tpu_pathtracer_torch import PersistentRenderer, RenderConfig
    from tpu_pathtracer_torch.models import camera as cm
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    scene, cam, cp = _scene(name, W, H, "cuda", lens)
    renderers, rays = {}, {}
    pk.launches = pk.mesh_launches = 0
    for use_nee in modes:
        r = PersistentRenderer(scene, cam,
                               RenderConfig(spp=4, max_bounces=max_bounces,
                                            rr_start=3, use_nee=use_nee),
                               seed=7, device="cuda", budget=budget)
        rays[use_nee] = r.render_to(target)
        renderers[use_nee] = r
    launches, mesh_launches = pk.launches, pk.mesh_launches
    steps = sum(r.state.frame for r in renderers.values())
    if launches != steps or steps == 0:
        fail(f"main path: {launches} kernel launches for {steps} steps")
    parts = []
    worst = dict(n_agree=1.0, l_agree=1.0, n_floor=1.0, l_floor=1.0,
                 max_abs_err=0.0, sign_balance=0.0)
    for use_nee, r in renderers.items():
        mode = "nee" if use_nee else "brute"
        img = r.image()
        if tuple(img.shape) != (H, W, 3) or not torch.isfinite(img).all():
            fail(f"main path ({mode}): bad image {tuple(img.shape)}")
        if r.min_samples < target:
            fail(f"main path ({mode}): min samples {r.min_samples}")
        launches_checked = _replay_per_step(scene, cam, cp, use_nee, r)
        for i, c in enumerate(launches_checked):
            # the reference's 98% bar, lowered only as far as the plain
            # version's own CPU-vs-card floor on this launch
            if c["n_agree"] < min(AGREE, c["n_floor"]) \
                    or c["l_agree"] < min(AGREE, c["l_floor"]) \
                    or c["ray_err"] > RAY_TOL:
                fail(f"main path ({mode}), launch {i} vs plain: {c}")
        step = {k: min(c[k] for c in launches_checked)
                for k in ("n_agree", "l_agree", "n_floor", "l_floor")}
        for key in ("max_abs_err", "ray_err", "sign_balance"):
            step[key] = max(c[key] for c in launches_checked)
        for key in ("n_agree", "l_agree", "n_floor", "l_floor"):
            worst[key] = min(worst[key], step[key])
        for key in ("max_abs_err", "sign_balance"):
            worst[key] = max(worst[key], step[key])
        # the whole run against the plain version's whole run
        ref_st, ref_rays = _render_plain(scene, cp, 7, r.state.frame,
                                         use_nee, r.budget, cam.use_dof,
                                         max_bounces)
        n_run, l_run, _ = lane_agreement(ref_st, r.state, W, H)
        ray_err = abs(rays[use_nee] - ref_rays) / max(ref_rays, 1)
        m = img.mean().item()
        m_ref = pk.state_image(ref_st, W, H).mean().item()
        if ray_err > RAY_TOL or abs(m - m_ref) > MEAN_TOL * abs(m_ref):
            fail(f"main path ({mode}) vs plain over the run: rays "
                 f"{rays[use_nee]} vs {ref_rays}, mean {m} vs {m_ref}")
        parts.append(
            f"{mode}: {r.state.frame} steps, min spp {r.min_samples}; worst "
            f"launch vs plain: n {step['n_agree']:.4f} L "
            f"{step['l_agree']:.4f} max|dL| {step['max_abs_err']:.3g} rays "
            f"err {step['ray_err']:.2e} sign balance "
            f"{step['sign_balance']:.3f} (plain cpu vs card: n "
            f"{step['n_floor']:.4f} L {step['l_floor']:.4f}); whole run vs "
            f"plain: n {n_run:.4f} "
            f"L {l_run:.4f} rays {rays[use_nee]}/{ref_rays} mean "
            f"{m:.6f}/{m_ref:.6f}")
    images = {use_nee: r.image().clone() for use_nee, r in renderers.items()}
    r = renderers[modes[-1]]
    before = r.image().clone()
    r.update_camera(cm.translate(r.camera, [0.0, 0.0, 10.0]))
    if r.iteration != 0 or r.min_samples != 0 or r.state.frame != 0:
        fail("update_camera did not reset the accumulation")
    r.step()
    if torch.equal(before, r.image()):
        fail("the image did not change after update_camera")
    lens_s = (f", lens radius {cam.lens_radius} focused at "
              f"{float(cam.focal_distance)}" if cam.use_dof else "")
    print(f"[{label}] {name}{lens_s} {W}x{H} spp 4, {max_bounces} bounces, "
          f"budget {r.budget}: " + " | ".join(parts) + f" | kernel launches "
          f"{launches} = steps {steps} ({mesh_launches} on a mesh) | "
          f"update_camera resets", flush=True)
    return launches, mesh_launches, worst, images


def phase_cli(scene="cornell", label="5 cli"):
    from tpu_pathtracer_torch.io.image import read_png
    from tpu_pathtracer_torch.ops.kernels import _build

    suffix = "" if scene == "cornell" else f"_{scene.replace('-', '_')}"
    out = _build.build_dir() / f"chip_smoke_cli{suffix}.png"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "render",
         "--scene", scene, "--size", f"{W}x{H}", "--spp", "4",
         "--iterations", "4", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not out.is_file():
        fail(f"cli render failed ({proc.returncode}): {proc.stderr[-2000:]}")
    img = read_png(str(out))
    if img.shape != (H, W, 3) or img.max() == 0:
        fail(f"cli wrote a bad PNG {img.shape}")
    print(f"[{label}] {scene}: wrote {out.relative_to(ROOT)} {img.shape} "
          f"(mean {img.mean():.4f}) in {time.perf_counter() - t0:.1f} s",
          flush=True)


def _time_steps(scene, cp, use_nee, k, salt, step_fn, budget=16,
                use_dof=False):
    """CUDA-event time of k steps from a fresh state (host wrapper
    included), and the rays they traced."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st = pk.init_state(W, H, TR, device="cuda")
    rays = []
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(k):
        st, nr = step_fn(scene, cp, (salt, 0), st, budget=budget, width=W,
                         height=H, max_bounces=10, rr_start=3, tile_rows=TR,
                         use_nee=use_nee, use_dof=use_dof)
        rays.append(nr)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), int(torch.stack(rays).sum())


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    return busy


def _profile_steps(scene, cp, use_nee, k=10, tag="", use_dof=False,
                   walks=None):
    """One torch.profiler trace of k steps from a fresh state (``_profile``'s
    numbers), and the work per launch: rays, paths started and lanes; on a
    textured scene also the texel fetches, from the plain version's first
    launch on the same seed, scaled to the kernel's rays per launch. That
    plain launch also runs on a mesh scene, where it samples its walks'
    segments into ``walks``; its seconds, less the sampler's, are the plain
    version's ms per step (``plain_ms``)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st, rays = None, []

    def start():
        nonlocal st, rays
        st, rays = pk.init_state(W, H, TR, device="cuda"), []

    def run(i):
        nonlocal st
        st, nr = pk.persistent_step(scene, cp, (400, i), st, budget=16,
                                    width=W, height=H, max_bounces=10,
                                    rr_start=3, tile_rows=TR,
                                    use_nee=use_nee, use_dof=use_dof)
        rays.append(nr)

    kernel_ms, busy, window, by_name = _profile(
        run, k, "persistent_kernel", tag + ("nee" if use_nee else "brute"),
        start=start)
    # paths started over the k launches: completed plus still in flight
    work = dict(rays=int(torch.stack(rays).sum()) / k,
                paths=int(st.n_samp.sum() + st.alive.sum()) / k,
                lanes=st.lr.numel(), texel=0.0)
    if scene.textured or walks is not None:
        counts = {}
        sampled = walks.seconds if walks is not None else 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, nr = pk.persistent_step_ref(
            scene, cp, (400, 0), pk.init_state(W, H, TR, device="cuda"),
            budget=16, width=W, height=H, max_bounces=10, rr_start=3,
            tile_rows=TR, use_nee=use_nee, use_dof=use_dof, counts=counts,
            walks=walks)
        torch.cuda.synchronize()
        sampled = (walks.seconds if walks is not None else 0.0) - sampled
        work["plain_ms"] = (time.perf_counter() - t0 - sampled) * 1e3
        work["texel"] = counts.get("texel", 0) / max(int(nr), 1) \
            * work["rays"]
    return kernel_ms, busy, window, by_name, work


def _traced(run, k, tag, complete, start=None, near=None):
    """A torch.profiler trace (device activity only) of run(0..k-1): the
    CUDA-event ms of the window and the trace's kernel, memcpy and memset
    events. The profiler on the card sometimes drops activity records (a
    whole first window, or one launch of ten), so a trace whose events fail
    ``complete`` is taken again, up to PROFILE_ATTEMPTS times in all;
    ``start`` resets the caller's state before each attempt. A spin kernel
    of ~20 ms on either side keeps the window's launches away from the
    session's ends: without them, late in the script the tracer dropped one
    launch of ten on each of 5 attempts of phase 35's traces (never in a
    fresh process); with them, a record has still been dropped on two
    attempts in a row, and has come back on the next, and on all five
    attempts of one trace in two runs (phases 35 and 31). So if no attempt
    is complete, the last attempt whose events pass ``near`` (if given:
    short of one launch record) is returned, with a note, and the caller
    takes its per-launch times over the launches recorded. Why the tracer
    drops records is not known."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.ops.kernels import _build

    trace = _build.build_dir() / f"chip_smoke_trace_{tag}.json"
    nearest = None
    for attempt in range(PROFILE_ATTEMPTS):
        if start is not None:
            start()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a first record for the tracer, outside the window and left out
            # of the events below, and a last one
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            a.record()
            for i in range(k):
                run(i)
            b.record()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "spin_kernel" not in e["name"]]
        problem = complete(events)
        if problem is None:
            return a.elapsed_time(b), events
        if near is not None and near(events):
            nearest = (a.elapsed_time(b), events)
        print(f"  (trace {tag}, attempt {attempt + 1}: {problem}; taken "
              "again)", flush=True)
    if near is not None and nearest is not None:
        print(f"  (trace {tag}: {problem} in {PROFILE_ATTEMPTS} attempts; "
              "the last trace short of one record is used)", flush=True)
        return nearest
    fail(f"trace {tag}: {problem} in {PROFILE_ATTEMPTS} attempts")


def _profile(run, k, kernel_name, tag, start=None):
    """One torch.profiler trace of run(0..k-1) (``_traced``). Returns the
    named kernel's device ms per launch, the device's busy ms per call
    (union of kernel, memcpy and memset intervals), the window's ms per call
    (CUDA events around the same k calls), and the device ms per call of
    each kernel or copy name. A trace that missed one launch record of
    ``k`` in every attempt (``_traced``) gives the named kernel's mean over
    the launches it recorded, and a busy time short of that launch."""

    def launched(events):
        return sum(kernel_name in e["name"] for e in events)

    def complete(events):
        n = launched(events)
        return None if n == k else (f"{n} {kernel_name} launches for {k} "
                                    "calls")

    window, events = _traced(
        run, k, tag, complete, start,
        near=(lambda ev: launched(ev) == k - 1) if k > 1 else None)
    kern = [e for e in events if kernel_name in e["name"]]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / k / 1e3
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events)
    return (sum(e["dur"] for e in kern) / len(kern) / 1e3, busy / k / 1e3,
            window / k, by_name)


def _slope_ms(call, k=24, reps=REPS):
    """ms per call by the CUDA-event slope between 1 and k calls (host
    work included) after a warm pair, median of reps, and the reps;
    ``call(salt, i)`` with a salt of its own for every timed run."""
    import torch

    def timed(n, salt):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for i in range(n):
            call(salt, i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    timed(2, 90)  # warm
    ms = []
    for rep in range(reps):
        t1 = timed(1, 100 + rep)
        ms.append((timed(k, 200 + rep) - t1) / (k - 1))
    return statistics.median(ms), ms


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of operations over the f32 peak and
    bytes over the memory rate."""
    return _bound_of(ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3)


def _bound_of(t_ops: float, t_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) from the two yardsticks' ms."""
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class WalkSample:
    """The segments that the persistent kernels' plain versions walk on one
    scene's mesh, sampled when it is passed to them as ``walks`` (they call
    it as ``mesh_walk_ref``'s ``record``): the origin, direction and t_init
    of up to WALK_SAMPLE live lanes per mode (closest hit, occlusion),
    WALK_TAKE at random from each walk, so that a run's sample spans its
    iterations. Only untimed plain runs take it, but for phase 26's, whose
    one plain run is also timed: ``seconds`` is its own wall time.
    ``rates`` counts the box and triangle tests per segment on the sample:
    of the mesh's leaf-<=4 tree (``pack_bvh(mesh, one_leaf=0)``), which the
    bounds take, of the tree the kernels walk (``scene.mesh_bvh``: one leaf
    for a mesh of <= BVH_MAX_LEAF triangles, else the same tree), both per
    thread (``bvh_walk_ref``; a shadow walk stops at its first occluder),
    and of the 64-triangle-leaf tree walked per thread (``mesh_walk_ref``,
    one live lane per tile), and prints them."""

    def __init__(self, scene, label):
        self.scene, self.label = scene, label
        self.sample = dict(closest=[], occlusion=[])
        self.walked = dict(closest=0, occlusion=0)
        self.seconds = 0.0
        self.out = None

    def __call__(self, occlusion, planes):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mode = "occlusion" if occlusion else "closest"
        live = torch.nonzero(planes[6].reshape(-1) > 0.0)[:, 0]
        self.walked[mode] += len(live)
        if sum(len(x[0]) for x in self.sample[mode]) < WALK_SAMPLE:
            gen = torch.Generator().manual_seed(len(self.sample[mode]))
            take = live[torch.randperm(len(live), generator=gen)[
                :WALK_TAKE].to(live.device)]
            self.sample[mode].append([x.reshape(-1)[take].clone()
                                      for x in planes])
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def shadow_share(self) -> float:
        """Occlusion walks among all the walks sampled."""
        n = self.walked
        return n["occlusion"] / max(n["closest"] + n["occlusion"], 1)

    def rates(self):
        """{mode: {"bound", "kernel", "old": (boxes, tris), "n": n}} per
        segment on the sample."""
        import torch

        from tpu_pathtracer_torch.ops.kernels._walk import (
            bvh_walk_ref, mesh_walk_ref,
        )
        from tpu_pathtracer_torch.ops.kernels.mesh_kernel import pack_bvh

        if self.out is not None:
            return self.out
        scene = self.scene
        if not self.sample["closest"]:
            fail(f"{self.label}: no plain walk ran on this scene's mesh, so "
                 "the bound has no segments to count the walk's tests on")
        trees = dict(bound=pack_bvh(scene.mesh, one_leaf=0),
                     kernel=scene.mesh_bvh)
        out = {}
        for mode, chunks in self.sample.items():
            if not chunks:
                continue
            occ = mode == "occlusion"
            o = [torch.cat([c[k] for c in chunks]) for k in range(7)]
            n = len(o[0])
            r = dict(n=n)
            for key, bvh in trees.items():
                c = {}
                bvh_walk_ref(bvh, *o, occlusion=occ, counts=c)
                r[key] = (c["boxes"] / n, c["tris"] / n)
            one = torch.zeros((n, 128), device=o[0].device)

            def tile(x, one=one):  # one live lane per 128-lane tile
                t = one.clone()
                t[:, 0] = x
                return t

            c = {}
            mesh_walk_ref(scene.mesh_packed, *(tile(x) for x in o),
                          tile_rows=1, occlusion=occ, counts=c)
            r["old"] = (c["boxes"] / n, c["tris"] / n)
            out[mode] = r
        self.out = out
        nodes = {k: t.num_nodes for k, t in trees.items()}
        print(f"[walk tests] {self.label}: box / triangle tests per "
              f"segment, per thread, on the leaf-<=4 tree ({nodes['bound']} "
              f"nodes; the bounds') | the kernels' tree ({nodes['kernel']} "
              f"nodes) | the 64-triangle-leaf tree: " + "; ".join(
                  f"{mode} ({r['n']} sampled segments) " + " | ".join(
                      f"{r[k][0]:.2f} / {r[k][1]:.2f}"
                      for k in ("bound", "kernel", "old"))
                  for mode, r in out.items())
              + f"; the sampler's own time in the plain runs "
              f"{self.seconds:.3f} s", flush=True)
        return out


def _walk_ops(scene, segments, paths, shadows, texels=0, lens_paths=0,
              walks=None) -> float:
    """f32 operations of a persistent walk: closest hit and shading per
    segment, a camera ray per path (its thin lens for ``lens_paths`` of
    them), a light sample and the shadow sweep per shadow segment, the uv
    and the four bilinear taps per texel fetch. With a mesh, every segment
    and shadow segment also walks the BVH (``_mesh_walk_ops``)."""
    n_prims = int(scene.num_prims)
    ops = (segments * (OPS["quadratic"] * n_prims + OPS["segment"])
           + paths * OPS["path"]
           + shadows * (OPS["shadow"]
                        + OPS["shadow_prim"] * max(n_prims - 1, 0)))
    if scene.mesh_packed is not None:
        ops += _mesh_walk_ops(walks, segments, shadows)
    return (ops + texels * (OPS["uv"] + OPS["texel"])
            + lens_paths * OPS["lens"])


def _mesh_walk_ops(walks, segments, shadows) -> float:
    """The mesh walk's part of ``_walk_ops``: per segment the reciprocal
    direction, and the box and triangle tests that the mesh's leaf-<=4 tree
    needs on this workload's segments, counted by ``bvh_walk_ref`` on the
    sample ``walks`` (``WalkSample.rates``; a shadow walk stops at its
    first occluder, as the kernel's)."""
    if walks is None:
        fail("a mesh bound needs a WalkSample of the workload's segments")
    rates = walks.rates()
    ops = 0.0
    for mode, n in (("closest", segments), ("occlusion", shadows)):
        if n:
            boxes, tris = rates[mode]["bound"]
            ops += n * (OPS["walk"] + OPS["slab"] * boxes + OPS["tri"] * tris)
    return ops


def _mesh_bytes(scene) -> int:
    """Bytes of the tree the kernels walk (nodes and triangle slots), read
    once; 0 without a mesh."""
    bvh = scene.mesh_bvh
    return 0 if bvh is None else 4 * (bvh.nodes.numel() + bvh.tris.numel())


def forward_bound(scene, work_brute, work, use_dof=False, walks=None):
    """Bound of one forward launch. The NEE walk traces the brute-force
    walk's path segments on the same Philox draws (NEE never changes a
    path's throughput or direction), so its shadow segments are its rays
    less the brute-force run's. A textured scene adds the texture atlas to
    the bytes, a mesh its tree (each read once)."""
    shadows = work["rays"] - work_brute["rays"]
    ops = _walk_ops(scene, work_brute["rays"], work["paths"], shadows,
                    work.get("texel", 0.0),
                    work["paths"] if use_dof else 0, walks)
    atlas = scene.textures.numel() * 4 if scene.textured else 0
    return _bound(ops, 20 * 4 * 2 * work["lanes"] + atlas
                  + _mesh_bytes(scene))


def phase_times(smi, name="cornell", label="6 times", lens=None):
    """End-to-end step time and rays/s (CUDA events, slope between 1 and K
    steps, median of REPS), the plain version's step time, then one profiled
    window for the kernel's device time and the device's idle share (last,
    so its tracing touches no other number). On a mesh or textured scene the
    plain version's step time is that of the one plain launch the bound
    needs anyway (``_profile_steps``), not of two more."""
    import functools

    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    scene, cam, cp = _scene(name, W, H, "cuda", lens)
    dof = cam.use_dof
    tag = ("" if name == "cornell" else f"{name}_") + ("lens_" if dof else "")
    step_k = functools.partial(pk.persistent_step, use_dof=dof)
    step_r = functools.partial(pk.persistent_step_ref, use_dof=dof)
    walks = (WalkSample(scene, f"{label} {name}") if scene.mesh is not None
             else None)
    K = 24
    out = {}
    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        _time_steps(scene, cp, use_nee, 2, 99, step_k)  # warm
        steps_ms, rates = [], []
        for rep in range(REPS):
            t1, r1 = _time_steps(scene, cp, use_nee, 1, 100 + rep, step_k)
            tk, rk = _time_steps(scene, cp, use_nee, K, 200 + rep, step_k)
            steps_ms.append((tk - t1) / (K - 1))
            rates.append((rk - r1) / (tk - t1) * 1e3)
        out[mode] = dict(step_ms=statistics.median(steps_ms),
                         rays_per_s=statistics.median(rates), reps=rates)
        if walks is None and not scene.textured:
            _time_steps(scene, cp, use_nee, 1, 98, step_r)
            t2, _ = _time_steps(scene, cp, use_nee, 2, 300, step_r)
            out[mode]["plain_ms"] = t2 / 2
    for mode, o in out.items():
        o["kernel_ms"], busy, window, by_name, o["work"] = _profile_steps(
            scene, cp, mode == "nee", tag=tag, use_dof=dof, walks=walks)
        o.setdefault("plain_ms", o["work"].get("plain_ms"))
        o["busy_ms"], o["window_ms"] = busy, window
        o["idle_share"] = 1.0 - busy / window
        if o["idle_share"] < 0.0:
            fail(f"{mode}: device busy {busy} ms per step exceeds the "
                 f"window's {window} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        o["top"] = "; ".join(f"{n[:48]} {ms:.4f}" for n, ms in top)
    for o in out.values():
        o["bound_ms"], o["bound_by"] = forward_bound(
            scene, out["brute"]["work"], o["work"], dof, walks)
        if walks is not None:
            # the mesh walk's own part of the launch (kernel 2's bound)
            segments = out["brute"]["work"]["rays"]
            o["walk_bound_ms"], o["walk_bound_by"] = _bound(
                _mesh_walk_ops(walks, segments, o["work"]["rays"] - segments),
                _mesh_bytes(scene))
    parts = [
        f"{mode}: step {o['step_ms']:.4f} ms, {o['rays_per_s']:.6g} rays/s "
        f"(median of {REPS}: {', '.join(f'{r:.6g}' for r in o['reps'])}), "
        f"plain {o['plain_ms']:.3f} ms/step; profiled window "
        f"{o['window_ms']:.4f} ms/step, device busy {o['busy_ms']:.4f} ms, "
        f"idle share {o['idle_share']:.3f}, kernel {o['kernel_ms']:.4f} "
        f"ms/launch (bound {o['bound_ms']:.5f} ms by {o['bound_by']}: "
        f"{o['work']['rays']:.0f} rays, {o['work']['paths']:.0f} paths, "
        f"{o['work']['texel']:.0f} texel fetches per launch); top device "
        f"ms/step: {o['top']}"
        for mode, o in out.items()]
    lens_s = f" lens {LENS}" if dof else ""
    print(f"[{label}] {name}{lens_s} {W}x{H} budget 16 tile_rows {TR} on "
          f"{smi}: " + " | ".join(parts), flush=True)
    return out


def _close(a, b, rtol, atol=0.0) -> bool:
    """|a - b| <= atol + rtol * |b| everywhere (b is the reference)."""
    import torch

    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def _grad_floor(args, kw, ref_adj, w, h):
    """The plain version on the CPU against itself on the card: the lowest
    of its agreement fractions on one launch."""
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import grad_lane_agreement

    scene, cp, seed, it, tgt = args
    kw_cpu = dict(kw, uniforms=None if kw.get("uniforms") is None
                  else kw["uniforms"].cpu())
    cpu = rp.persistent_replay_ref(scene.to("cpu"), cp.cpu(), seed, it,
                                   tgt.cpu(), phase="adjoint", **kw_cpu)
    fl = grad_lane_agreement(_lanes(ref_adj), _lanes(cpu), w, h)
    return min(fl["n_samp"], fl["L"], min(fl["planes"].values()))


def _lanes(adj):
    """The per-lane outputs of a phase "adjoint" call that the lane bars
    hold: L, n_samp, GA, GI and the C_tot records (None untextured)."""
    return (*adj[:4], adj[5])


def _sign_balance(pairs, n_lanes):
    """For (kernel, plain) pairs of per-lane outputs shaped (..., rows,
    128), each leading index one output, the plain version the reference:
    of the n real lanes where an output differs beyond the per-lane bar,
    the excess of one sign of difference over the other in units of
    IMAGE_Z * sqrt(n). Returns (the worst such ratio, its n)."""
    from tpu_pathtracer_torch.utils.metrics import L_TOL

    worst, worst_n = 0.0, 0
    for a, b in pairs:
        a = a.double().reshape(-1, a.shape[-2] * a.shape[-1])[:, :n_lanes]
        b = b.double().reshape(-1, b.shape[-2] * b.shape[-1])[:, :n_lanes]
        d = a - b
        off = d.abs() >= L_TOL * b.abs().clamp_min(1.0)
        n = off.sum(-1).double()
        excess = ((d > 0) & off).sum(-1) - ((d < 0) & off).sum(-1)
        for e, m in zip(excess.abs().tolist(), n.tolist()):
            r = e / (IMAGE_Z * math.sqrt(m)) if m else 0.0
            if r > worst:
                worst, worst_n = r, int(m)
    return worst, worst_n


def _image_gap(k_adj, r_adj, tgt, w, h):
    """Kernel against plain over all lanes. For each per-lane output of
    phase "adjoint" (radiance per channel, each GA/GI plane), the lanes
    that differ beyond the per-lane bar and the excess of one sign of
    difference over the other, in units of its null spread sqrt(n). Returns
    (worst excess / (IMAGE_Z * sqrt(n)), the number of lanes behind it, and
    the relative gaps of the whole-image loss, worst gradient entry (to the
    largest plain entry) and radiance sum)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    worst, worst_n = _sign_balance(
        [(k_adj[0].permute(2, 0, 1), r_adj[0].permute(2, 0, 1)),
         (k_adj[2], r_adj[2]), (k_adj[3], r_adj[3])], w * h)

    def sums(x):
        return x.double().sum((-2, -1))

    fk = [sums(t) for t in rp.mse_lane_terms(*k_adj[:4], tgt, w, h)]
    fr = [sums(t) for t in rp.mse_lane_terms(*r_adj[:4], tgt, w, h)]
    loss_gap = float((fk[0] - fr[0]).abs() / fr[0].abs().clamp_min(1e-300))
    g_k = torch.cat([x.reshape(-1) for x in fk[1:]])
    g_r = torch.cat([x.reshape(-1) for x in fr[1:]])
    grad_gap = float((g_k - g_r).abs().max()
                     / g_r.abs().max().clamp_min(1e-300))
    l_k, l_r = sums(k_adj[0].permute(2, 0, 1)), sums(r_adj[0].permute(2, 0, 1))
    l_gap = float(((l_k - l_r).abs() / l_r.abs().clamp_min(1e-300)).max())
    return worst, worst_n, loss_gap, grad_gap, l_gap


def _check_grad_launch(label, args, kw, w, h, main_loss=None):
    """Check one gradient-kernel launch against the plain version on the
    card, from the same inputs: phase "adjoint" lane for lane, phase "both"
    against the cotangent fold over the kernel's own lanes, the fold over
    the agreeing lanes against the plain version's, and the sign balance of
    the lanes that differ from it (``_image_gap``). ``main_loss``, if
    given, is the loss the main path's launch returned from these inputs,
    which the replayed launch must equal bit for bit. On a textured scene
    the C_tot records are held like the GA/GI planes; the outputs are
    returned under "outs" for the texture checks."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import AGREE, grad_lane_agreement

    tgt = args[4]
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    k_both = rp.persistent_replay_call(*args, **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    torch.cuda.synchronize()
    if main_loss is not None and not torch.equal(k_both[2], main_loss):
        fail(f"{label}: the replayed launch's loss {float(k_both[2])} is not "
             f"the main path's {float(main_loss)}")
    outs = (*k_adj[:4], *k_both[2:5], *r_adj[:4])
    outs += tuple(x for x in (k_adj[5], r_adj[5], k_both[6]) if x is not None)
    if not all(bool(torch.isfinite(x.float()).all()) for x in outs):
        fail(f"{label}: non-finite outputs")
    ag = grad_lane_agreement(_lanes(r_adj), _lanes(k_adj), w, h)
    worst = min(ag["n_samp"], ag["L"], min(ag["planes"].values()))
    floor = _grad_floor(args, kw, r_adj, w, h) if worst < AGREE else None
    if worst < AGREE and worst < floor:
        fail(f"{label}: kernel vs plain agreement {worst} is below both "
             f"{AGREE} and the plain version's CPU-vs-card floor {floor}")
    rays_k, rays_r = int(k_adj[4]), int(r_adj[4])
    if abs(rays_k - rays_r) > RAY_TOL * max(rays_r, 1):
        fail(f"{label}: rays {rays_k} vs plain {rays_r}")
    f_loss, f_ga, f_gi = rp.mse_fold(*k_adj[:4], tgt, w, h)
    scale = float(k_both[3].abs().max())
    if not (_close(k_both[2], f_loss, FOLD_RTOL)
            and _close(k_both[3], f_ga, FOLD_RTOL, 1e-6 * scale)
            and _close(k_both[4], f_gi, FOLD_RTOL, 1e-6 * scale)):
        fail(f"{label}: phase both {k_both[2:5]} is not the fold of its "
             f"adjoint lanes {(f_loss, f_ga, f_gi)}")
    mask = ag["mask"].to(tgt.device)
    t_fold = rp.mse_fold(*k_adj[:4], tgt, w, h, mask)
    r_fold = rp.mse_fold(*r_adj[:4], tgt, w, h, mask)
    if not (_close(t_fold[0], r_fold[0], LOSS_RTOL)
            and _close(t_fold[1], r_fold[1], GRAD_RTOL, 1e-6 * scale)
            and _close(t_fold[2], r_fold[2], GRAD_RTOL, 1e-6 * scale)):
        fail(f"{label}: fold over agreeing lanes {t_fold} vs plain {r_fold}")
    image = _image_gap(k_adj, r_adj, tgt, w, h)
    if not image[0] <= 1.0:
        fail(f"{label}: the lanes that differ from the plain version lean "
             f"one way, {image[0]} times the bar ({image[1]} lanes; "
             f"whole-image relative gaps: loss {image[2]}, gradient "
             f"{image[3]}, radiance {image[4]})")
    return dict(n_agree=ag["n_samp"], l_agree=ag["L"],
                plane_agree=min(ag["planes"].values()), all_agree=ag["all"],
                floor=floor, max_abs_err=ag["max_abs_err"],
                rays=(rays_k, rays_r), loss=float(k_both[2]),
                image=image, outs=(k_adj, k_both, r_adj), mask=ag["mask"])


def _fmt_check(c) -> str:
    floor = "" if c["floor"] is None else f" (cpu floor {c['floor']:.4f})"
    ratio, n_off, loss_gap, grad_gap, l_gap = c["image"]
    return (f"n {c['n_agree']:.4f} L {c['l_agree']:.4f} GA/GI "
            f"{c['plane_agree']:.4f} all {c['all_agree']:.4f}{floor} "
            f"max|d| {c['max_abs_err']:.3g} rays {c['rays'][0]}/"
            f"{c['rays'][1]}; whole image, relative gaps: loss "
            f"{loss_gap:.3g}, gradient {grad_gap:.3g}, radiance {l_gap:.3g}; "
            f"sign balance {ratio:.3f} of its bar ({n_off} lanes)")


def phase_grad_compare(cases=(("cornell", False), ("cornell", True)),
                       label="7 gradient kernel vs plain", lens=None):
    """Gradient kernel vs plain version on the card at 160x120, for each
    (scene, use_nee) case (with ``lens``, a thin-lens camera) on injected
    uniforms and on Philox."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    w, h, budget = 160, 120, 10
    rows, _ = rp.pixel_lanes_layout(w, h, TR)
    gen = torch.Generator(device="cuda").manual_seed(77)
    tgt = rp.target_to_lanes(
        torch.rand((h, w, 3), generator=gen, device="cuda"), rows)
    parts, checks = [], []
    for name, use_nee in cases:
        scene, cam, cp = _scene(name, w, h, "cuda", lens)
        dof = cam.use_dof
        for injected in (True, False):
            case = (f"{name}{'-lens' if dof else ''}-"
                    f"{'nee' if use_nee else 'brute'}-"
                    f"{'injected' if injected else 'philox'}")
            u = (torch.rand((rows * budget * pk.n_draws(use_nee, dof),
                             pk.LANES), generator=gen, device="cuda")
                 if injected else None)
            kw = dict(spp=SPP, budget=budget, width=w, height=h,
                      max_bounces=MB, rr_start=3, tile_rows=TR,
                      use_nee=use_nee, use_dof=dof, uniforms=u)
            c = _check_grad_launch(case, (scene, cp, (5, 2), 3, tgt), kw,
                                   w, h)
            checks.append(c)
            parts.append(f"{case}: {_fmt_check(c)}")
    print(f"[{label}] 160x120 spp 4, 10 bounces, budget 10: "
          + " | ".join(parts), flush=True)
    return dict(n_agree=min(c["n_agree"] for c in checks),
                l_agree=min(c["l_agree"] for c in checks),
                plane_agree=min(c["plane_agree"] for c in checks),
                max_abs_err=max(c["max_abs_err"] for c in checks),
                sign_balance=max(c["image"][0] for c in checks))


def phase_grad_limits():
    """The gradient kernel's largest shared-memory block: a sphere scene
    with 16 slots and 16 lights (``limit_spheres``) at 160x120, NEE, 10
    bounces, spp 1 (its blocks drain early) and 4 (late) at their default
    budgets, Philox draws; phase 7's checks against the plain version."""
    import torch

    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    w, h = 160, 120
    scene, cs = sc.limit_spheres(device="cuda")
    n_slots, n_l = len(rp.material_slots(scene)[0]), len(scene.light_structure)
    if (n_slots, n_l) != (rp.MAX_SLOTS, rp.MAX_GRAD_LIGHTS):
        fail(f"limit_spheres has {n_slots} slots and {n_l} lights")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device="cuda")
    rows, _ = rp.pixel_lanes_layout(w, h, TR)
    gen = torch.Generator(device="cuda").manual_seed(78)
    tgt = rp.target_to_lanes(
        torch.rand((h, w, 3), generator=gen, device="cuda"), rows)
    parts, checks = [], []
    for spp in (1, 4):
        kw = dict(spp=spp, budget=rp.default_budget(spp, MB), width=w,
                  height=h, max_bounces=MB, rr_start=3, tile_rows=TR,
                  use_nee=True)
        c = _check_grad_launch(f"limits spp {spp}",
                               (scene, pack_camera(cam), (6, 1), 0, tgt), kw,
                               w, h)
        checks.append(c)
        parts.append(f"spp {spp}, budget {kw['budget']}: {_fmt_check(c)}")
    print(f"[7 gradient at the adjoint limits] limit_spheres ({n_slots} "
          f"slots, {n_l} lights, {rp.replay_smem_bytes(n_slots, n_l)} B of "
          f"shared memory per block) 160x120, NEE, {MB} bounces: "
          + " | ".join(parts), flush=True)
    return dict(n_agree=min(c["n_agree"] for c in checks),
                l_agree=min(c["l_agree"] for c in checks),
                plane_agree=min(c["plane_agree"] for c in checks),
                max_abs_err=max(c["max_abs_err"] for c in checks),
                sign_balance=max(c["image"][0] for c in checks))


def phase_trainer(name="cornell", modes=(False, True), mat=3,
                  steps=TRAIN_STEPS, label="8 trainer main path", lens=None):
    """BASELINE config 5 (or its workload on another scene, or with
    ``lens`` a thin-lens camera) through the trainer's entry points:
    material ``mat`` and the light start perturbed; the target, then
    ``steps`` same-seed Adam steps."""
    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, cam, cp = _scene(name, W, H, "cuda", lens)
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    budget = rp.default_budget(SPP, MB)
    seed = (17, 0)
    parts, launches, mesh_launches, checks = [], {}, {}, []
    true_albedo = scene.mat_color[mat].tolist()
    true_inten = scene.light_intensity[0].tolist()
    for use_nee in modes:
        mode = "nee" if use_nee else "brute"
        config = RenderConfig(spp=SPP, max_bounces=MB, rr_start=3,
                              use_nee=use_nee)
        p0 = inverse.params_of(scene)
        p0["mat_color"][mat] = 0.3
        p0["light_intensity"] *= 0.5
        state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
        step = inverse.make_kernel_train_step(scene, cam, config,
                                              fixed_iteration=0)
        pk.launches = rp.launches = rp.mesh_launches = 0
        target = inverse.render_target_kernel(scene, cam, seed, config,
                                              iteration=0)
        losses = []
        for i in range(steps):
            last_params = {k: v.detach().clone()
                           for k, v in state.params.items()}
            state, loss = step(state, target, seed)
            losses.append(loss)
        torch.cuda.synchronize()
        launches[mode] = rp.launches
        mesh_launches[mode] = rp.mesh_launches
        if rp.launches != 1 + steps or pk.launches:
            fail(f"trainer ({mode}): {rp.launches} gradient-kernel and "
                 f"{pk.launches} forward-kernel launches for 1 target and "
                 f"{steps} steps")
        vals = [float(x) for x in losses]
        finite = (bool(torch.isfinite(target).all())
                  and all(bool(torch.isfinite(v.detach()).all())
                          for v in state.params.values())
                  and all(map(math.isfinite, vals)))
        if tuple(target.shape) != (W * H, 3) or not finite:
            fail(f"trainer ({mode}): non-finite or misshapen results")
        if not vals[-1] < vals[0]:
            fail(f"trainer ({mode}): loss {vals[0]} -> {vals[-1]} did not "
                 "fall")
        tgt_lanes = rp.target_to_lanes(target.reshape(H, W, 3), rows)
        kw = dict(spp=SPP, budget=budget, width=W, height=H, max_bounces=MB,
                  rr_start=3, tile_rows=TR, use_nee=use_nee,
                  use_dof=cam.use_dof)
        c = _check_grad_launch(
            f"trainer ({mode}) last launch",
            (inverse.apply_params(scene, last_params), cp, seed, 0,
             tgt_lanes), kw, W, H, main_loss=losses[-1])
        checks.append(c)
        alb = state.params["mat_color"][mat].detach().cpu().tolist()
        inten = state.params["light_intensity"][0].detach().cpu().tolist()
        parts.append(
            f"{mode}: loss {' '.join(f'{v:.6g}' for v in vals)}; albedo "
            f"{mat} {[round(a, 4) for a in alb]} (true "
            f"{[round(a, 4) for a in true_albedo]}), intensity "
            f"{[round(a, 3) for a in inten]} (true "
            f"{[round(a, 3) for a in true_inten]}); launches "
            f"{launches[mode]} = 1 + {steps} ({mesh_launches[mode]} on a "
            f"mesh); last launch vs plain: {_fmt_check(c)}")
    lens_s = f" lens {LENS}" if cam.use_dof else ""
    print(f"[{label}] {name}{lens_s} {W}x{H} spp {SPP}, {MB} bounces, budget "
          f"{budget}, lr {LR}: " + " | ".join(parts), flush=True)
    return launches, sum(mesh_launches.values()), dict(
        n_agree=min(c["n_agree"] for c in checks),
        l_agree=min(c["l_agree"] for c in checks),
        plane_agree=min(c["plane_agree"] for c in checks),
        floor=min((c["floor"] for c in checks if c["floor"] is not None),
                  default=None),
        max_abs_err=max(c["max_abs_err"] for c in checks),
        sign_balance=max(c["image"][0] for c in checks))


def phase_cli_invert():
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "invert"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "recovered albedo" not in proc.stdout:
        fail(f"cli invert failed ({proc.returncode}): {proc.stdout[-1000:]}"
             f"{proc.stderr[-2000:]}")
    tail = " / ".join(proc.stdout.strip().splitlines()[-3:])
    print(f"[9 cli invert] defaults (32x32, spp 4, 30 steps) in "
          f"{time.perf_counter() - t0:.1f} s: {tail}", flush=True)


def _time_grads(scene, cam, cp, target, use_nee, k, salt, plain=False,
                counts=None, walks=None):
    """CUDA-event time of k gradients at config 5 (host wrapper included)
    and the live rays they traced, on seeds (salt, 0) .. (salt, k - 1).
    ``plain`` times the plain version, which fills ``counts`` and samples
    its walks' segments into ``walks``."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    kw = dict(spp=SPP, budget=rp.default_budget(SPP, MB), max_bounces=MB,
              rr_start=3, tile_rows=TR, use_nee=use_nee)
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    rays = []
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(k):
        if plain:
            out = rp.persistent_replay_ref(
                scene, cp, (salt, i), 0,
                rp.target_to_lanes(target, rows), width=W, height=H,
                use_dof=cam.use_dof, counts=counts, walks=walks, **kw)
            rays.append(out[5])
        else:
            rays.append(rp.persistent_mse_value_and_grad(
                scene, cam, (salt, i), 0, target, **kw)[2])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), int(torch.stack(rays).sum())


def grad_bound(scene, cp, target, use_nee, seed, shadows, use_dof=False,
               walks=None):
    """Bound of one gradient launch at config 5, from the work of the
    kernel's launch on ``seed``: its path segments and completed paths, and
    ``shadows``, the NEE shadow segments the plain version traced on the
    same seed (the kernel does not count them; the two walks differ only on
    the lanes that f32 chaos flips)."""
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    out = rp.persistent_replay_call(
        scene, cp, seed, 0, rp.target_to_lanes(target, rows), spp=SPP,
        budget=rp.default_budget(SPP, MB), width=W, height=H,
        max_bounces=MB, rr_start=3, tile_rows=TR, use_nee=use_nee,
        use_dof=use_dof)
    n_slots = len(rp.material_slots(scene)[0])
    n_l = len(scene.light_structure)
    segments, paths = int(out[5]), int(out[1].sum())
    ops = (_walk_ops(scene, segments, paths, shadows,
                     lens_paths=paths if use_dof else 0, walks=walks)
           + segments * OPS["adjoint_segment"]
           + paths * (OPS["adjoint_flush_slot"] * n_slots
                      + OPS["adjoint_flush_light"] * n_l))
    lanes = rows * 128
    k = 3 * n_slots + 3 * n_l + 1
    nbytes = lanes * (12 + 12 + 4) + rows * (4 * k + 4) + _mesh_bytes(scene)
    bound_ms, by = _bound(ops, nbytes)
    return dict(bound_ms=bound_ms, bound_by=by, segments=segments,
                shadows=shadows, paths=paths)


def _live_share(counts, segments, lanes, budget) -> dict:
    """Occupancy of one gradient launch's schedule: ``u``, the live share
    of its lane-iterations (segments / (lanes x budget), the kernel's own
    segment count); from the plain version's ``counts`` on the same seed
    (``_count_occupancy``), the shares of its warp-iterations with a live
    lane, with every lane done, and the share that the live lanes would
    fill if each 128-lane row packed them into its leading warps."""
    n = int(counts["warp_iters"])
    live, packed = int(counts["warp_live"]), int(counts["warp_packed"])
    return dict(u=segments / (lanes * budget), warp_live=live / n,
                warp_done=(n - live) / n, warp_packed=packed / n)


def _fmt_live(label, o) -> str:
    return (f"{label}: u {o['u']:.4f}, warp-iterations with a live lane "
            f"{o['warp_live']:.4f}, with every lane done {o['warp_done']:.4f},"
            f" packed per row {o['warp_packed']:.4f}")


def _trace_live(counts, threads) -> dict:
    """Occupancy of one kernel-8 launch from the plain version's per-lane
    walks (``trace_lanes_ref``'s counts on the same seed): ``before``, the
    vertices over the sum over warps of 32 x the warp's longest walk (one
    item per lane, each warp running to its longest path); ``fetch``, the
    same share when ``threads`` threads walk one vertex per iteration and
    a thread whose walk ends takes the next unstarted item in the next
    iteration (free threads in index order), a warp running until its
    threads find no item left. Vertices are traced segments."""
    import torch

    seg = counts["lane_segments"].reshape(-1).long().cpu()
    seg = seg[seg > 0]  # the image's items
    left = torch.zeros(-(-threads // 32) * 32, dtype=torch.int64)
    nxt, warp_iters = 0, 0
    while True:
        free = (left == 0).nonzero().reshape(-1)
        take = free[:max(0, min(free.numel(), seg.numel() - nxt))]
        left[take] = seg[nxt:nxt + take.numel()]
        nxt += take.numel()
        busy = left > 0
        if not bool(busy.any()):
            break
        warp_iters += int(busy.reshape(-1, 32).any(-1).sum())
        left = left - busy.long()
    return dict(before=counts["vertices"] / counts["warp_longest"],
                fetch=int(seg.sum()) / (32 * warp_iters),
                vertices=counts["vertices"],
                warp_longest=counts["warp_longest"], threads=threads)


def _fmt_trace_live(label, o) -> str:
    return (f"{label}: {o['vertices']} vertices over {o['warp_longest']} "
            f"(32 x the warps' longest walks) = {o['before']:.4f}; with "
            f"{o['threads']} threads taking items {o['fetch']:.4f}")


def phase_grad_times(smi, name="cornell", modes=(False, True),
                     label="10 gradient times", lens=None):
    """Config 5 (or the same workload on another scene): ms per gradient
    and fwd+bwd rays/s by the CUDA-event slope between 1 and K gradients
    (median of REPS), the plain version's time per gradient, the bound, then
    one profiled window for the kernel's device time and the device's idle
    share (last, so its tracing touches no other number)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, cam, cp = _scene(name, W, H, "cuda", lens)
    tag = ("" if name == "cornell" else f"{name}_") + (
        "lens_" if cam.use_dof else "")
    gen = torch.Generator(device="cuda").manual_seed(5)
    target = torch.rand((H, W, 3), generator=gen, device="cuda")
    K = 24
    out = {}
    for use_nee in modes:
        mode = "nee" if use_nee else "brute"
        walks = (WalkSample(scene, f"{label} {name} {mode}")
                 if scene.mesh is not None else None)
        _time_grads(scene, cam, cp, target, use_nee, 2, 90)  # warm
        ms, rates = [], []
        for rep in range(REPS):
            t1, r1 = _time_grads(scene, cam, cp, target, use_nee, 1,
                                 100 + rep)
            tk, rk = _time_grads(scene, cam, cp, target, use_nee, K,
                                 200 + rep)
            ms.append((tk - t1) / (K - 1))
            rates.append((rk - r1) / (tk - t1) * 1e3)
        counts = {}
        t_plain, _ = _time_grads(scene, cam, cp, target, use_nee, 1, 300,
                                 plain=True, counts=counts)
        if walks is not None:  # untimed, on the same seed
            _time_grads(scene, cam, cp, target, use_nee, 1, 300, plain=True,
                        walks=walks)
        out[mode] = dict(grad_ms=statistics.median(ms),
                         rays_per_s=statistics.median(rates), reps=ms,
                         plain_ms=t_plain,
                         **grad_bound(scene, cp, target, use_nee, (300, 0),
                                      int(counts["shadow"]), cam.use_dof,
                                      walks))
        out[mode]["live"] = _live_share(counts, out[mode]["segments"], W * H,
                                        rp.default_budget(SPP, MB))
    for mode, o in out.items():
        def run(i, use_nee=(mode == "nee")):
            rp.persistent_mse_value_and_grad(
                scene, cam, (400, i), 0, target, spp=SPP,
                budget=rp.default_budget(SPP, MB), max_bounces=MB,
                rr_start=3, tile_rows=TR, use_nee=use_nee)

        o["kernel_ms"], busy, window, by_name = _profile(
            run, 10, "replay_persistent_kernel", f"grad_{tag}{mode}")
        o["busy_ms"], o["window_ms"] = busy, window
        o["idle_share"] = 1.0 - busy / window
        if o["idle_share"] < 0.0:
            fail(f"gradient {mode}: device busy {busy} ms per gradient "
                 f"exceeds the window's {window} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        o["top"] = "; ".join(f"{n[:40]} {v:.4f}" for n, v in top)
    parts = [
        f"{mode}: {o['grad_ms']:.4f} ms per gradient, "
        f"{o['rays_per_s']:.6g} fwd+bwd rays/s (median of {REPS}; ms "
        f"{', '.join(f'{v:.4f}' for v in o['reps'])}), plain "
        f"{o['plain_ms']:.2f} ms; kernel {o['kernel_ms']:.4f} ms/launch, "
        f"bound {o['bound_ms']:.5f} ms by {o['bound_by']} ({o['segments']} "
        f"segments, {o['paths']} paths, {o['shadows']} shadow segments); "
        f"profiled window {o['window_ms']:.4f} ms, device busy "
        f"{o['busy_ms']:.4f} ms, idle share {o['idle_share']:.3f}; top "
        f"device ms/gradient: {o['top']}"
        for mode, o in out.items()]
    lens_s = f" lens {LENS}" if cam.use_dof else ""
    print(f"[{label}] {name}{lens_s} {W}x{H} spp {SPP}, {MB} bounces, budget "
          f"{rp.default_budget(SPP, MB)} on {smi}: " + " | ".join(parts),
          flush=True)
    print(f"[replay live share] {name}{lens_s} (phase {label.split()[0]}): "
          + " | ".join(_fmt_live(mode, o["live"]) for mode, o in out.items()),
          flush=True)
    return out


def _position_rows(device):
    """d pack_camera / d pos: the camera position's three tangent rows."""
    import torch

    rows = torch.zeros((3, 24), device=device)
    rows[0, 9] = rows[1, 10] = rows[2, 11] = 1.0
    return rows


JVP_CASES = [
    # (name, scene builder, use_nee); every transmissive material adds its
    # IOR tangent to the position's three
    ("cornell-brute", _cornell, False),
    ("cornell-nee", _cornell, True),
    ("cornell-glass-nee",
     lambda w, h, dev: _scene("cornell-glass", w, h, dev), True),
    ("cornell-quad-nee",
     lambda w, h, dev: _scene("cornell-quad", w, h, dev), True),
    ("point-nee", _point, True),
]


def _jvp_floor(args, kw, ref, w, h):
    """The plain tangent walk on the CPU against itself on the card: the
    lowest of its agreement fractions on one launch."""
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.utils.metrics import tangent_lane_agreement

    scene, cp, dcam, seed, it = args
    kw_cpu = dict(kw, uniforms=None if kw.get("uniforms") is None
                  else kw["uniforms"].cpu())
    cpu = cj.camera_jvp_ref(scene.to("cpu"), cp.cpu(), dcam.cpu(), seed, it,
                            **kw_cpu)
    fl = tangent_lane_agreement(ref[:3], cpu[:3], w, h)
    return min(fl["n_samp"], fl["L"], min(fl["planes"].values()))


def _check_jvp_launch(label, args, kw, w, h):
    """Check one tangent-kernel launch against the plain version on the
    card, from the same inputs: >= AGREE of lanes on n_samp, L and every dL
    plane (or no fewer than the plain version on the CPU agrees with itself
    on the card), ray counts within RAY_TOL, and the sign test on L and
    every dL plane. Also returns the whole-image relative gap of each dL
    plane's sum, worst plane."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, tangent_lane_agreement,
    )

    k = cj.camera_jvp_call(*args, **kw)
    r = cj.camera_jvp_ref(*args, **kw)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in (*k[:2], *r[:2])):
        fail(f"{label}: non-finite outputs")
    ag = tangent_lane_agreement(r[:3], k[:3], w, h)
    worst = min(ag["n_samp"], ag["L"], min(ag["planes"].values()))
    floor = _jvp_floor(args, kw, r, w, h) if worst < AGREE else None
    if worst < AGREE and worst < floor:
        fail(f"{label}: kernel vs plain agreement {worst} (n_samp "
             f"{ag['n_samp']}, L {ag['L']}, dL {ag['planes']}) is below "
             f"both {AGREE} and the plain version's CPU-vs-card floor "
             f"{floor}")
    rays_k, rays_r = int(k[3]), int(r[3])
    if abs(rays_k - rays_r) > RAY_TOL * max(rays_r, 1):
        fail(f"{label}: rays {rays_k} vs plain {rays_r}")
    sign, n_off = _sign_balance(
        [(k[0].permute(2, 0, 1), r[0].permute(2, 0, 1)),
         (k[1].permute(0, 3, 1, 2), r[1].permute(0, 3, 1, 2))], w * h)
    if not sign <= 1.0:
        fail(f"{label}: the lanes that differ from the plain version lean "
             f"one way, {sign} times the bar ({n_off} lanes)")
    s_k, s_r = k[1].double().sum((1, 2)), r[1].double().sum((1, 2))
    gap = float(((s_k - s_r).abs() / r[1].double().abs().sum((1, 2))
                 .clamp_min(1e-300)).max())
    return dict(n_agree=ag["n_samp"], l_agree=ag["L"],
                plane_agree=min(ag["planes"].values()), floor=floor,
                max_abs_err=ag["max_abs_err"], rays=(rays_k, rays_r),
                sign=sign, n_off=n_off, gap=gap, n_tan=int(k[1].shape[0]))


def _fmt_jvp(c) -> str:
    floor = "" if c["floor"] is None else f" (cpu floor {c['floor']:.4f})"
    return (f"T {c['n_tan']}: n {c['n_agree']:.4f} L {c['l_agree']:.4f} dL "
            f"{c['plane_agree']:.4f}{floor} max|d| {c['max_abs_err']:.3g} "
            f"rays {c['rays'][0]}/{c['rays'][1]}; dL sums' relative gap "
            f"{c['gap']:.3g}; sign balance {c['sign']:.3f} of its bar "
            f"({c['n_off']} lanes)")


def _worst(checks) -> dict:
    return dict(n_agree=min(c["n_agree"] for c in checks),
                l_agree=min(c["l_agree"] for c in checks),
                plane_agree=min(c["plane_agree"] for c in checks),
                floor=min((c["floor"] for c in checks
                           if c["floor"] is not None), default=None),
                max_abs_err=max(c["max_abs_err"] for c in checks),
                sign_balance=max(c["sign"] for c in checks))


def _check_jvp_chunks(scene, cp, kw):
    """Tangents split over launches walk the same paths: four camera rows in
    one launch equal two launches of two, and five rows with the IOR
    tangents through the wrapper (a launch of the first four, then the
    rest) equal the four and a call with the rest, bit for bit."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj

    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = torch.cat([_position_rows("cuda"),
                      torch.randn((2, 24), generator=gen, device="cuda")])
    rows[3:, 12:] = 0.0  # the lens and view rows feed no pinhole ray
    coef = kw["coef_mats"]
    kw = dict(kw, coef_mats=())
    args = ((5, 2), 3)
    before = cj.launches
    four = cj.camera_jvp_call(scene, cp, rows[:4], *args, **kw)
    halves = [cj.camera_jvp_call(scene, cp, rows[i:i + 2], *args, **kw)
              for i in (0, 2)]
    every = cj.camera_jvp_call(scene, cp, rows, *args,
                               **dict(kw, coef_mats=coef))
    rest = cj.camera_jvp_call(scene, cp, rows[4:], *args,
                              **dict(kw, coef_mats=coef))
    torch.cuda.synchronize()
    n_launch = cj.launches - before
    want = 1 + 2 + -(-(5 + len(coef)) // 4) + -(-(1 + len(coef)) // 4)
    same = all(torch.equal(o[0], four[0]) and torch.equal(o[2], four[2])
               and int(o[3]) == int(four[3]) for o in (*halves, every, rest))
    if not (same and n_launch == want
            and torch.equal(torch.cat([halves[0][1], halves[1][1]]), four[1])
            and torch.equal(every[1][:4], four[1])
            and torch.equal(every[1][4:], rest[1])):
        fail(f"tangent chunks differ ({n_launch} launches)")
    return n_launch


def phase_jvp_compare():
    """Phase 14: the tangent kernel against the plain version at 160x120
    for each JVP_CASES entry, on injected uniforms and on Philox, and the
    tangent chunks."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    w, h, budget = JVP_W, JVP_H, JVP_BUDGET
    rows, _ = rp.pixel_lanes_layout(w, h, TR)
    gen = torch.Generator(device="cuda").manual_seed(31)
    parts, checks, n_chunk = [], [], 0
    for name, build, use_nee in JVP_CASES:
        scene, _, cp = build(w, h, "cuda")
        coef = cj.transmissive_mats(scene)
        for injected in (True, False):
            case = f"{name}-{'injected' if injected else 'philox'}"
            u = (torch.rand((rows * budget * pk.n_draws(use_nee), pk.LANES),
                            generator=gen, device="cuda")
                 if injected else None)
            kw = dict(spp=SPP, budget=budget, width=w, height=h,
                      max_bounces=MB, rr_start=3, tile_rows=TR,
                      use_nee=use_nee, coef_mats=coef, uniforms=u)
            c = _check_jvp_launch(
                case, (scene, cp, _position_rows("cuda"), (5, 2), 3), kw,
                w, h)
            checks.append(c)
            parts.append(f"{case}: {_fmt_jvp(c)}")
            if name == "cornell-nee" and not injected:
                n_chunk = _check_jvp_chunks(scene, cp, kw)
    print(f"[14 tangent kernel vs plain] {w}x{h} spp {SPP}, {MB} bounces, "
          f"budget {budget}: " + " | ".join(parts) + f" | tangent chunks "
          f"identical over {n_chunk} launches", flush=True)
    return _worst(checks)


def _glass_scene(device):
    """tests/test_ior_kernel.py's edge-free glass ball (IOR 1.5, material
    0): refraction never bends a ray across a silhouette; two emitters, one
    behind it and one ahead."""
    from tpu_pathtracer_torch.models import scene as sc

    return sc.make_scene(
        [sc.sphere([0, 0, 0], 5.0, 0), sc.sphere([0, 0, -80], 40.0, 1, 0),
         sc.sphere([0, 0, 140], 70.0, 1, 1)],
        [sc.transmissive([1, 1, 1], ior=1.5), sc.diffuse([0, 0, 0])],
        [sc.area_light(1, [4, 4, 4]), sc.area_light(2, [9, 9, 9])],
        device=device)


def phase_jvp_fd():
    """Phase 15: gradients against central differences of the kernel's own
    primal on the same seeds."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_pathtracer_torch.models import camera as cm, meshes
    from tpu_pathtracer_torch.models import scene as sc
    from tpu_pathtracer_torch.models.mesh import build_bvh
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    dev = "cuda"
    parts, out = [], {}

    def mean_of(scene, cam, w, h, seed, it, kw):
        """The walk's own primal: the (H, W, 3) completed-path mean."""
        L, _, ns, _ = cj.camera_jvp_call(
            scene, pack_camera(cam), torch.zeros(24, device=dev), seed, it,
            width=w, height=h, **kw)
        mean, _ = cj._pixel_means(L, L[None], ns, w, h)
        return mean

    # the camera position, per seed (tests/test_camera_jvp.py)
    w, h = 16, 12
    kw = dict(spp=2, max_bounces=1, budget=5, tile_rows=8, use_nee=True)
    cam = cm.make_camera([0, 3, 6], [0, 0, 0], [0, 1, 0], w, h, 45.0,
                         device=dev)
    light = sc.point_light([2, 4, 1], [30, 30, 30])
    grey = sc.diffuse([0.8, 0.8, 0.8])
    floor = sc.make_scene([sc.sphere([0, -1e4, 0], 1e4, 0)], [grey], [light],
                          device=dev)
    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    quad = sc.with_packet_mesh(sc.make_scene(
        [], [grey], [light], mesh=build_bvh(v, f, uv, 0, device=dev),
        device=dev))
    for name, scene, w_seed, seed in (("floor", floor, 1, (5, 2)),
                                      ("quad", quad, 3, (9, 4))):
        wts = torch.tensor(np.random.default_rng(w_seed).random(
            (h, w, 3), np.float32), device=dev)
        _, g = cj.camera_weighted_grad(scene, cam, seed, wts, **kw)
        g = g["pos"].cpu().numpy().astype(np.float64)
        if not (np.isfinite(g).all() and np.abs(g).max() > 1.0):
            fail(f"camera gradient on {name}: {g}")

        def value(pos, scene=scene, seed=seed, wts=wts):
            c = dataclasses.replace(
                cam, pos=torch.tensor(pos, dtype=torch.float32, device=dev))
            return float(torch.sum(wts * mean_of(scene, c, w, h, seed, 0,
                                                 kw)))

        p0 = cam.pos.cpu().numpy().astype(np.float64)
        fds = []
        for i, eps, rtol, atol in ((0, 8e-3, 2e-2, 1e-2),
                                   (1, 8e-3, 2e-2, 1e-2), (2, 3e-2, 0.2, 0.5)):
            dp = np.zeros(3)
            dp[i] = eps
            fd = (value(p0 + dp) - value(p0 - dp)) / (2 * eps)
            fds.append(fd)
            if not abs(g[i] - fd) <= atol + rtol * abs(fd):
                fail(f"camera gradient on {name}, axis {i}: kernel {g[i]} vs "
                     f"central difference {fd} (rtol {rtol}, atol {atol})")
        out[f"pos_{name}"] = (g.tolist(), fds)
        parts.append(f"pos on {name} seed {seed}: kernel "
                     f"{[f'{x:.5g}' for x in g]} vs central difference "
                     f"{[f'{x:.5g}' for x in fds]}")

    # the IOR in expectation (tests/test_ior_kernel.py)
    w = h = 8
    n_it, step = 16, 0.02
    cam = cm.make_camera([0, 0, 30], [0, 0, 0], [0, 1, 0], w, h, 0.5,
                         device=dev)
    scene = _glass_scene(dev)
    wts = torch.full((h, w, 3), 1.0 / (h * w * 3), device=dev)
    kw = dict(spp=32, max_bounces=6, budget=134, tile_rows=8)

    def shifted(d):
        coef = scene.mat_coef.clone()
        coef[0] = 1.5 + d
        return dataclasses.replace(scene, mat_coef=coef)

    s_plus, s_minus = shifted(step), shifted(-step)
    for use_nee in (False, True):
        gs, fds = [], []
        for it in range(n_it):
            _, g = cj.ior_weighted_grad(scene, cam, (5, 2), wts,
                                        use_nee=use_nee, iteration=it, **kw)
            gs.append(float(g[0]))
            vp, vm = (float(torch.sum(wts * mean_of(
                s, cam, w, h, (5, 2), it, dict(kw, use_nee=use_nee))))
                for s in (s_plus, s_minus))
            fds.append((vp - vm) / (2 * step))
        gs, fds = np.asarray(gs), np.asarray(fds)
        grad, fd = gs.mean(), fds.mean()
        se_g, se_fd = (x.std(ddof=1) / math.sqrt(n_it) for x in (gs, fds))
        mode = "nee" if use_nee else "brute"
        out[f"ior_{mode}"] = dict(grad=grad, grad_se=se_g, fd=fd, fd_se=se_fd)
        parts.append(f"IOR {mode}: kernel {grad:.5f} +- {se_g:.5f}, paired "
                     f"central difference {fd:.5f} +- {se_fd:.5f}")
        if not (np.isfinite(gs).all() and grad > 0.5
                and abs(grad - fd) <= 0.25 * abs(fd)):
            fail(f"IOR gradient ({mode}): kernel {grad} vs central "
                 f"difference {fd} (rtol 0.25, and above 0.5)")
    print("[15 finite differences] " + " | ".join(parts), flush=True)
    return out


def phase_ior_trainer(steps=5):
    """Phase 16's main path: the IOR trainer through ``params_of(scene,
    ior=True)`` and ``make_kernel_train_step`` on cornell_spheres NEE at
    config 5. Returns the tangent kernel's launches and the worst numbers
    of the last launch's check."""
    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, cam, cp = _scene("cornell", W, H, "cuda")
    glass = cj.transmissive_mats(scene)
    budget = rp.default_budget(SPP, MB)
    seed, mat = (17, 0), 3
    config = RenderConfig(spp=SPP, max_bounces=MB, rr_start=3, use_nee=True)
    p0 = inverse.params_of(scene, ior=True)
    p0["mat_color"][mat] = 0.3
    p0["light_intensity"] *= 0.5
    p0["mat_coef"][list(glass)] = IOR_START
    state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
    step = inverse.make_kernel_train_step(scene, cam, config,
                                          fixed_iteration=0)
    pk.launches = rp.launches = rp.mesh_launches = 0
    cj.launches = cj.mesh_launches = 0
    target = inverse.render_target_kernel(scene, cam, seed, config,
                                          iteration=0)
    losses, coefs = [], []
    for _ in range(steps):
        last_params = {k: v.detach().clone() for k, v in state.params.items()}
        state, loss = step(state, target, seed)
        losses.append(loss)
        coefs.append(state.params["mat_coef"][glass[0]].detach().clone())
    torch.cuda.synchronize()
    launches = cj.launches
    if launches != steps or rp.launches != 1 + steps or pk.launches:
        fail(f"IOR trainer: {launches} tangent-kernel, {rp.launches} "
             f"gradient-kernel and {pk.launches} forward-kernel launches for "
             f"1 target and {steps} steps")
    vals = [float(x) for x in losses]
    finite = (bool(torch.isfinite(target).all())
              and all(bool(torch.isfinite(v.detach()).all())
                      for v in state.params.values())
              and all(map(math.isfinite, vals)))
    if tuple(target.shape) != (W * H, 3) or not finite:
        fail("IOR trainer: non-finite or misshapen results")
    if not vals[-1] < vals[0]:
        fail(f"IOR trainer: loss {vals[0]} -> {vals[-1]} did not fall")
    # the last step's tangent launch, replayed: its mat_coef gradient is the
    # one the main path used, bit for bit, and it agrees with the plain
    # version
    g_main = state.params["mat_coef"].grad.detach().clone()
    scene_last = inverse.apply_params(scene, last_params)
    kw = dict(spp=SPP, budget=budget, max_bounces=MB, rr_start=3,
              tile_rows=TR, use_nee=True)
    g_replay = cj.ior_mse_grad(scene_last, cam, seed, target.reshape(H, W, 3),
                               iteration=0, **kw)
    if not torch.equal(g_replay, g_main):
        fail(f"IOR trainer: the replayed mat_coef gradient {g_replay} is not "
             f"the main path's {g_main}")
    c = _check_jvp_launch("IOR trainer last tangent launch",
                          (scene_last, cp, cp.new_zeros((0, 24)), seed, 0),
                          dict(kw, width=W, height=H, coef_mats=glass), W, H)
    print(f"[16 IOR trainer main path] cornell {W}x{H} spp {SPP}, {MB} "
          f"bounces, budget {budget}, NEE, lr {LR}: loss "
          f"{' '.join(f'{v:.6g}' for v in vals)}; mat_coef[{glass[0]}] "
          f"{IOR_START} -> {' '.join(f'{float(x):.5f}' for x in coefs)} "
          f"(true 1.5); albedo {mat} "
          f"{[round(a, 4) for a in state.params['mat_color'][mat].tolist()]}"
          f"; last mat_coef gradient {g_main[glass[0]].item():.6g}, replayed "
          f"bit for bit; tangent-kernel launches {launches} = {steps} steps; "
          f"last launch vs plain: {_fmt_jvp(c)}", flush=True)
    return launches, _worst([c])


def _jvp_bound(scene, counts, n_tan, rows, walks=None):
    """Bound of one tangent launch from the plain version's work on the same
    seed (the kernel does not count it): the primal walk (``_walk_ops``)
    plus, per tangent, its path, segment and lit-shadow tangents, plus the
    score vertices; bytes are the 3 + 3T output planes, n_samp and the row
    counts written once."""
    ops = (_walk_ops(scene, counts["segments"], counts["paths"],
                     counts["shadow"], walks=walks)
           + n_tan * (counts["paths"] * OPS["tangent_path"]
                      + counts["segments"] * OPS["tangent_segment"]
                      + counts["lit"] * OPS["tangent_shadow"])
           + counts["score"] * OPS["score"])
    return _bound(ops, rows * 128 * 4 * (4 + 3 * n_tan) + rows * 4
                  + _mesh_bytes(scene))


JVP_TIMES = [
    # (key, scene, use_nee, gradient): the JAX package's recorded
    # workloads for this kernel at config 5 (BASELINE.md:40,44)
    ("pos_cornell_brute", "cornell", False, "pos"),
    ("pos_cornell_nee", "cornell", True, "pos"),
    ("pos_cornell_quad_nee", "cornell-quad", True, "pos"),
    ("ior_cornell_nee", "cornell", True, "ior"),
]


def phase_jvp_times(smi):
    """Phase 16's times: ms per gradient end to end through
    camera_weighted_grad (the position) or ior_mse_grad (every
    transmissive material's IOR) by the CUDA-event slope between 1 and K
    gradients (median of REPS), the plain version's ms for one walk (which
    also counts the work for the bound), then one profiled window for the
    kernel's device time and the device's idle share."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    budget = rp.default_budget(SPP, MB)
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(6)
    weights = torch.rand((H, W, 3), generator=gen, device="cuda")
    kw = dict(spp=SPP, budget=budget, max_bounces=MB, rr_start=3,
              tile_rows=TR)
    K = 24
    out = {}
    for key, name, use_nee, kind in JVP_TIMES:
        scene, cam, cp = _scene(name, W, H, "cuda")
        glass = cj.transmissive_mats(scene) if kind == "ior" else ()

        def grad(salt, i, scene=scene, cam=cam, use_nee=use_nee, kind=kind):
            if kind == "pos":
                cj.camera_weighted_grad(scene, cam, (salt, i), weights,
                                        use_nee=use_nee, **kw)
            else:
                cj.ior_mse_grad(scene, cam, (salt, i), weights,
                                use_nee=use_nee, **kw)

        grad_ms, ms = _slope_ms(grad, K)
        dcam = _position_rows("cuda") if kind == "pos" else cp.new_zeros(
            (0, 24))
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cj.camera_jvp_ref(scene, cp, dcam, (300, 0), 0, width=W, height=H,
                          use_nee=use_nee, coef_mats=glass, counts=counts,
                          **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        walks = None
        if scene.mesh is not None:  # untimed, on the same seed
            walks = WalkSample(scene, f"16 tangent times {key}")
            cj.camera_jvp_ref(scene, cp, dcam, (300, 0), 0, width=W,
                              height=H, use_nee=use_nee, coef_mats=glass,
                              walks=walks, **kw)
        n_tan = dcam.shape[0] + len(glass)
        bound_ms, by = _jvp_bound(scene, counts, n_tan, rows, walks)
        kernel_ms, busy, window, by_name = _profile(
            lambda i, grad=grad: grad(400, i), 10, "camera_jvp_kernel",
            f"jvp_{key}")
        if busy > window:
            fail(f"{key}: device busy {busy} ms per gradient exceeds the "
                 f"window's {window} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        live = _live_share(counts, counts["segments"], W * H, budget)
        work = {k: v for k, v in counts.items()
                if k in ("paths", "segments", "shadow", "lit", "score")}
        out[key] = dict(grad_ms=grad_ms, reps=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                        kernel_ms=kernel_ms, busy_ms=busy, window_ms=window,
                        idle_share=1.0 - busy / window, n_tan=n_tan,
                        work=work, live=live,
                        top="; ".join(f"{n[:40]} {v:.4f}" for n, v in top))
    parts = [
        f"{key} (T {o['n_tan']}): {o['grad_ms']:.4f} ms per gradient (median "
        f"of {REPS}; ms {', '.join(f'{v:.4f}' for v in o['reps'])}), plain "
        f"{o['plain_ms']:.2f} ms; kernel {o['kernel_ms']:.4f} ms/launch, "
        f"bound {o['bound_ms']:.5f} ms by {o['bound_by']} (work {o['work']}); "
        f"profiled window {o['window_ms']:.4f} ms, device busy "
        f"{o['busy_ms']:.4f} ms, idle share {o['idle_share']:.3f}; top device "
        f"ms/gradient: {o['top']}"
        for key, o in out.items()]
    print(f"[16 tangent times] {W}x{H} spp {SPP}, {MB} bounces, budget "
          f"{budget} on {smi}: " + " | ".join(parts), flush=True)
    print(f"[16 tangent live share] {W}x{H} spp {SPP}, {MB} bounces, budget "
          f"{budget} on {smi}: " + " | ".join(
              _fmt_live(key, o["live"]) for key, o in out.items()),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# The wavefront slice: kernels 5 (packet) and 6 (bin), phases 17-21
# ---------------------------------------------------------------------------

# Config 4 (BASELINE.md): the textured terrain at 1024x1024, 2 spp, 3
# bounces, NEE, the two-pass binned packet traversal.
C4_W, C4_H, C4_SPP, C4_MB = 1024, 1024, 2, 3
C4_BUDGET = 16  # phase 26's renderer budget
C4_BAND_TILES = 1  # tiles per band of phase 26's check against the plain
WAVE_LANES = 1 << 16  # lanes per kernel check (a fixed random subset)


def _c4_config(**kw):
    from tpu_pathtracer_torch import RenderConfig

    return RenderConfig(**{**dict(spp=C4_SPP, max_bounces=C4_MB,
                                  use_nee=True), **kw})


class _Recorder:
    """Record the calls of a mesh_kernel function (its tensor arguments
    cloned) and their results while passing them through."""

    def __init__(self, name):
        from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

        self.mk, self.name = mk, name
        self.fn = getattr(mk, name)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kw):
            saved = tuple(a.clone() if hasattr(a, "clone") else a
                          for a in args)
            out = self.fn(*args, **kw)
            self.calls.append((saved, dict(kw), out))
            return out

        setattr(self.mk, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mk, self.name, self.fn)


def _packet_ref_ids(packed, o, d, t_init, tmin, any_hit=False, bvh=None,
                    perm=None, counts=None):
    """packet_ref, the walk of the 64-triangle-leaf tree (the TPU kernel's
    contract), with its padded slots mapped to MeshData triangle ids as
    kernel 5 returns them; kernel 5's ``bvh`` and ``perm`` change no
    answer and are not read."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    t, slot, n, uv, mat = mk.packet_ref(packed, o, d, t_init, tmin, any_hit,
                                        counts=counts)
    found = t < torch.where(t_init > 0, t_init, 0.0)
    if any_hit:
        return t, slot, n, uv, mat
    return (t, torch.where(found, packed.remap[slot.long()], 0).to(slot.dtype),
            n, uv, mat)


class _PlainMeshQueries:
    """Route the wavefront's mesh queries on CUDA tensors to the plain
    versions of the TPU kernels' contract (packet_ref on the 64-leaf tree,
    by triangle id, and bin_rays_ref) for a reference run on the card."""

    def __enter__(self):
        from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

        self.mk, self.saved = mk, (mk.packet_query, mk.bin_rays)
        mk.packet_query = _packet_ref_ids
        mk.bin_rays = functools.partial(_bin_plain, mk.bin_rays_ref)
        return self

    def __exit__(self, *exc):
        self.mk.packet_query, self.mk.bin_rays = self.saved


def _wave_scene(name, w, h, two_pass=True):
    from tpu_pathtracer_torch.models import camera as cm, scene as sc

    scene, cs = sc.BUILTIN_SCENES[name](device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device="cuda")
    return sc.with_packet_mesh(scene, two_pass=two_pass), cam


def _record_waves(scene, cam, config, seed=11):
    """The wave queries of one frame: (o, d, t_init, any_hit) per wave, in
    the order the frame makes them (per bounce the closest-hit wave, then
    the shadow wave)."""
    from tpu_pathtracer_torch.models.integrator import render

    with _Recorder("intersect_mesh_packet") as rec:
        render(scene, cam, seed, config)
    return [(a[1], a[2], kw["t_init"], kw.get("any_hit", False))
            for a, kw, _ in rec.calls]


def _subset(n, k=WAVE_LANES, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:min(k, n)].sort().values.cuda()


def _hold_packet(k, r, t0, any_hit, what, plain="packet_ref"):
    """Kernel 5's answer k against a plain version's r on the same query
    (utils.metrics.packet_agreement's bars; triangles by MeshData id).
    Returns the numbers and ``bit_equal``, the share of lanes whose t,
    triangle, normal, uv and material are all equal; fails below the
    bars."""
    import torch

    from tpu_pathtracer_torch.utils.metrics import packet_agreement

    out = packet_agreement(k, r, t0, any_hit)
    if not out["ok"]:
        fail(f"kernel 5 vs {plain} ({what}): {out}")
    eq = torch.ones_like(k[0], dtype=torch.bool)
    for a, b in zip(k, r):
        e = a == b.to(a.dtype)
        eq &= e.all(-1) if e.dim() > 1 else e
    out["bit_equal"] = float(eq.double().mean())
    return out


def _twin_check(pm, bvh, o, d, t0, any_hit, what):
    """Kernel 5 (one launch of packet_query) against its plain version
    packet_bvh_ref on the same rays, by _hold_packet's bars (both walk
    pack_bvh's tree and are built to round alike, so ``bit_equal`` should
    be 1); then a launch through a random permutation against a launch on
    the rays permuted beforehand, bit for bit."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    p0 = mk.packet_launches
    k = mk.packet_query(pm, o, d, t0, 3e-2, any_hit, bvh=bvh)
    torch.cuda.synchronize()
    if mk.packet_launches != p0 + 1:
        fail("packet_query did not launch kernel 5 exactly once")
    out = _hold_packet(k, mk.packet_bvh_ref(bvh, o, d, t0, 3e-2, any_hit),
                       t0, any_hit, what, "packet_bvh_ref")
    g = torch.Generator(device="cuda").manual_seed(o.shape[0])
    perm = torch.randperm(o.shape[0], generator=g, device="cuda")
    through = mk.packet_query(pm, o, d, t0, 3e-2, any_hit, bvh=bvh,
                              perm=perm.to(torch.int32))
    before = mk.packet_query(pm, o[perm].contiguous(), d[perm].contiguous(),
                             t0[perm].contiguous(), 3e-2, any_hit, bvh=bvh)
    if not all(torch.equal(a[perm], b) for a, b in zip(through, before)):
        fail(f"kernel 5 ({what}): the permuted launch differs from the "
             "launch on the permuted rays")
    return out


def _hold_bin(k, r, what):
    """Kernel 6's (cell, tn) against the plain version's
    (utils.metrics.bin_agreement's bars). Returns (agreement, tn's relative
    error, tn's absolute error on binned lanes); fails below the bars."""
    from tpu_pathtracer_torch.utils.metrics import bin_agreement

    out = bin_agreement(k, r)
    if not out["ok"]:
        fail(f"kernel 6 vs bin_rays_ref ({what}): {out}")
    return out["agree"], out["tn_rel"], out["tn_abs"]


def _bin_plain(ref, coarse, o, d, t0, tmin, counts=None):
    """(cell, tn, key) as kernel 6 returns them, from one of its plain
    versions (bin_rays_ref or bin_tree_ref) and bin_sort_key."""
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    cell, tn = ref(coarse, o, d, t0, tmin, counts=counts)
    return cell, tn, mk.bin_sort_key(cell, tn, d, coarse.key_scale)


def _bin_io_bytes(t_init) -> int:
    """Bytes of one kernel-6 launch's rays and answers, each moved once:
    t_init read and cell, tn and key written on every lane, the origin and
    direction read on live lanes only (a dead lane reads neither)."""
    return t_init.shape[0] * 16 + int((t_init > 0).sum()) * 24


def _bin_exact(got, coarse, o, d, t0, what, counts=None):
    """Kernel 6's (cell, tn, key) against both plain versions on the same
    rays, bin_rays_ref (the sweep, the contract) and bin_tree_ref (the
    walk, adding its node and cell tests to ``counts``), each with
    bin_sort_key: bit for bit, or fail. Returns the sweep's answer."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    sweep = _bin_plain(mk.bin_rays_ref, coarse, o, d, t0, 3e-2)
    walk = _bin_plain(mk.bin_tree_ref, coarse, o, d, t0, 3e-2, counts)
    for ref, name in ((sweep, "bin_rays_ref"), (walk, "bin_tree_ref")):
        for g, w, f in zip(got, ref, ("cell", "tn", "key")):
            if not torch.equal(g, w):
                fail(f"kernel 6 vs {name} ({what}): {f} differs on "
                     f"{int((g != w).sum())} lanes")
    return sweep


def _packet_check(pm, bvh, o, d, t0, any_hit, sort, coarse):
    """Kernel 5 (through intersect_mesh_packet) against the same query with
    packet_ref on the 64-leaf tree (and bin_rays_ref) on the card, by
    _hold_packet's bars, triangles by MeshData id."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    kw = dict(t_init=t0, any_hit=any_hit, sort=sort, coarse=coarse, bvh=bvh)
    p0 = mk.packet_launches
    k = mk.intersect_mesh_packet(pm, o, d, 3e-2, **kw)
    torch.cuda.synchronize()
    if mk.packet_launches != p0 + 1:
        fail("a packet query did not launch kernel 5 exactly once")
    with _PlainMeshQueries():
        r = mk.intersect_mesh_packet(pm, o, d, 3e-2, **kw)
    fields = ("t", "tri", "n", "uv", "mat")
    return _hold_packet(
        [getattr(k, f) for f in fields], [getattr(r, f) for f in fields], t0,
        any_hit, f"{'any' if any_hit else 'closest'}, sort {sort}, two-pass "
                 f"{coarse is not None}")


def phase_packet_compare(smi):
    """17 and 18: kernels 5 and 6 against their plain versions on the card,
    on three waves recorded from one main-path frame of cornell_boxes and of
    the full terrain (the primary wave, the bounce-2 closest-hit wave and
    the bounce-1 shadow wave), each on a fixed random subset of 64k lanes:
    kernel 5 against packet_bvh_ref (its plain version on pack_bvh's tree)
    and through a permutation against the permuted rays (_twin_check), and
    against packet_ref on the 64-leaf tree by triangle id, closest-hit and
    any-hit, sorted and unsorted; then kernel 6 on the same waves, and the
    two-pass query against the single-pass one."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk
    from tpu_pathtracer_torch.utils.metrics import PACKET_AGREE, PACKET_T_TOL

    worst = dict(agree=1.0, max_abs_err=0.0, sign=0.0, bin_agree=1.0,
                 bin_tn_err=0.0, bin_abs_err=0.0, two_vs_one=1.0,
                 twin_agree=1.0, twin_bit_equal=1.0, twin_max_abs_err=0.0)
    parts, bin_parts = [], []
    for name, w, h, spp in (("cornell-boxes", 256, 256, 8),
                            ("terrain", C4_W, C4_H, C4_SPP)):
        scene, cam = _wave_scene(name, w, h)
        waves = _record_waves(scene, cam, _c4_config(spp=spp))
        if len(waves) != 2 * (C4_MB + 1):
            fail(f"{name}: {len(waves)} wave queries in a frame, want "
                 f"{2 * (C4_MB + 1)}")
        pm, coarse = scene.mesh_packed, scene.mesh_packed_coarse
        bvh = scene.mesh_bvh
        for label, idx in (("primary", 0), ("bounce2", 4), ("shadow1", 3)):
            o, d, t0, _ = waves[idx]
            sel = _subset(o.shape[0])
            o, d, t0 = o[sel].contiguous(), d[sel].contiguous(), t0[sel]
            dead = float((t0 <= 0).double().mean())
            cases, twins = [], []
            for any_hit in (False, True):
                tw = _twin_check(pm, bvh, o, d, t0, any_hit,
                                 f"{name} {label}, "
                                 f"{'any' if any_hit else 'closest'}")
                twins.append(tw)
                worst["twin_agree"] = min(worst["twin_agree"], tw["agree"])
                worst["twin_bit_equal"] = min(worst["twin_bit_equal"],
                                              tw["bit_equal"])
                worst["twin_max_abs_err"] = max(worst["twin_max_abs_err"],
                                                tw["max_abs_err"])
                for sort in (False, True):
                    c = _packet_check(pm, bvh, o, d, t0, any_hit, sort, None)
                    cases.append(c)
                    worst["agree"] = min(worst["agree"], c["agree"])
                    worst["max_abs_err"] = max(worst["max_abs_err"],
                                               c["max_abs_err"])
                    worst["sign"] = max(worst["sign"], c["sign"])
            parts.append(
                f"{name} {label} ({o.shape[0]} lanes, dead {dead:.3f}, hits "
                f"{cases[0]['hits']:.3f}): vs packet_bvh_ref closest/any "
                f"agree {twins[0]['agree']:.5f}/{twins[1]['agree']:.5f}, "
                f"bit-equal {twins[0]['bit_equal']:.5f}/"
                f"{twins[1]['bit_equal']:.5f}, permuted launch equal; vs "
                f"packet_ref agree "
                + "/".join(f"{c['agree']:.5f}" for c in cases)
                + f" (bit-equal "
                + "/".join(f"{c['bit_equal']:.5f}" for c in cases)
                + f") max|dt| {max(c['max_abs_err'] for c in cases):.3g}")
            # kernel 6 on the same wave, with its sort key
            b0 = mk.bin_launches
            got = mk.bin_rays(coarse, o, d, t0, 3e-2)
            torch.cuda.synchronize()
            if mk.bin_launches != b0 + 1:
                fail("bin_rays did not launch kernel 6 exactly once")
            cell = got[0]
            walk = {}
            sweep = _bin_exact(got, coarse, o, d, t0, f"{name} {label}",
                               walk)
            b_agree, tn_err, tn_abs = _hold_bin(got[:2], sweep[:2],
                                                f"{name} {label}")
            n_live = max(int((t0 > 0).sum()), 1)
            worst["bin_abs_err"] = max(worst["bin_abs_err"], tn_abs)
            two = _packet_check(pm, bvh, o, d, t0, False, True, coarse)
            k1 = mk.intersect_mesh_packet(pm, o, d, 3e-2, t_init=t0,
                                          bvh=bvh)
            k2 = mk.intersect_mesh_packet(pm, o, d, 3e-2, t_init=t0,
                                          coarse=coarse, bvh=bvh)
            lim = torch.where(t0 > 0, t0, 0.0)
            s12 = ((k1.t < lim) == (k2.t < lim)) & (
                (k1.t >= lim) | (k1.tri == k2.tri))
            a12 = float(s12.double().mean())
            if a12 < PACKET_AGREE:
                fail(f"{name} {label}: two-pass vs single-pass {a12}")
            worst["bin_agree"] = min(worst["bin_agree"], b_agree)
            worst["bin_tn_err"] = max(worst["bin_tn_err"], tn_err)
            worst["two_vs_one"] = min(worst["two_vs_one"], a12)
            bin_parts.append(
                f"{name} {label}: cells {b_agree:.5f} (binned "
                f"{float((cell >= 0).double().mean()):.3f}) tn rel "
                f"{tn_err:.2g}, cell/tn/key equal to both plain versions; "
                f"walk tests per live ray {walk['nodes'] / n_live:.2f} nodes "
                f"+ {walk['cells'] / n_live:.2f} cells of "
                f"{coarse.cell_ids.shape[0]}; two-pass kernel vs plain "
                f"{two['agree']:.5f}, two-pass vs single-pass {a12:.5f}")
    print(f"[17 packet kernel vs plain] bars: hit/miss and triangle >= "
          f"{PACKET_AGREE}, |dt| <= {PACKET_T_TOL} max(1, t), n/uv/mat "
          f"equal, sign test; against packet_ref the cases closest "
          f"unsorted/sorted, any unsorted/sorted: " + " | ".join(parts),
          flush=True)
    print(f"[18 bin kernel vs plain] " + " | ".join(bin_parts), flush=True)
    return worst


def _texture_modes(img):
    """Shares of lit pixels whose green/red ratio is the checker's green
    tile's (> 1.15) and its pale tile's (< 1.0)."""
    lum = img.mean(-1)
    lit = lum > 0.05 * float(lum.max())
    gr = img[..., 1] / img[..., 0].clamp_min(1e-6)
    n = max(int(lit.sum()), 1)
    return (int(((gr > 1.15) & lit).sum()) / n,
            int(((gr < 1.0) & lit).sum()) / n)


def phase_wavefront_main(smi):
    """19: the wavefront main path. ProgressiveRenderer(device="cuda") on the
    terrain at config 4 renders 4 frames (the counts of kernels 5 and 6 set
    to 0 just before and read just after); one frame is rendered again at
    256x256 through the plain mesh queries on the card, on the same Philox
    draws; cli render --scene terrain --backend auto; single-sphere at
    128x128, 16 spp, 2 bounces."""
    import torch

    from tpu_pathtracer_torch import ProgressiveRenderer, RenderConfig
    from tpu_pathtracer_torch.io.image import read_png
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import render
    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    t0 = time.perf_counter()
    scene, cs = sc.terrain_textured(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], C4_W, C4_H,
                         cs["fov"], device="cuda")
    r = ProgressiveRenderer(scene, cam, _c4_config(), seed=3, device="cuda")
    setup_s = time.perf_counter() - t0
    if r.scene.mesh_packed_coarse is None:
        fail("ProgressiveRenderer did not pack the mesh two-pass")
    frames = 4
    mk.packet_launches = mk.bin_launches = 0
    for _ in range(frames):
        r.step()
    torch.cuda.synchronize()
    launches = dict(packet=mk.packet_launches, bin=mk.bin_launches)
    waves = frames * 2 * (C4_MB + 1)  # closest-hit and shadow per bounce
    if launches["packet"] != waves or launches["bin"] != waves:
        fail(f"main path: kernel launches {launches}, want {waves} each "
             f"({frames} frames x {C4_MB + 1} bounces x 2 waves)")
    img = r.image()
    if tuple(img.shape) != (C4_H, C4_W, 3) or not torch.isfinite(img).all():
        fail(f"main path: bad image {tuple(img.shape)}")
    green, pale = _texture_modes(img)
    if green < 0.05 or pale < 0.05:
        fail(f"main path: the checker does not show (green {green}, pale "
             f"{pale})")
    # one frame again at 256x256, kernels against the plain queries
    cam_s = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 256, 256,
                           cs["fov"], device="cuda")
    k_img = render(r.scene, cam_s, 3, _c4_config(), iteration=1)
    with _PlainMeshQueries():
        p_img = render(r.scene, cam_s, 3, _c4_config(), iteration=1)
    ok = (k_img - p_img).abs() <= 1e-4 * p_img.abs().clamp_min(1.0)
    px_agree = float(ok.all(-1).double().mean())
    floor = None
    if px_agree < 0.98:
        cpu_scene = r.scene.to("cpu")
        c_img = render(cpu_scene, cam_s.to("cpu"), 3, _c4_config(),
                       iteration=1)
        ok_c = (c_img.cuda() - p_img).abs() <= 1e-4 * p_img.abs().clamp_min(
            1.0)
        floor = float(ok_c.all(-1).double().mean())
        if px_agree < floor:
            fail(f"main path frame vs plain: {px_agree} of pixels, below "
                 f"0.98 and the plain CPU-vs-card floor {floor}")
    # the CLI
    out = _build.build_dir() / "chip_smoke_cli_terrain.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "render",
         "--scene", "terrain", "--size", f"{C4_W}x{C4_H}", "--spp",
         str(C4_SPP), "--bounces", str(C4_MB), "--nee", "--iterations", "1",
         "--backend", "auto", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not out.is_file():
        fail(f"cli render terrain failed ({proc.returncode}): "
             f"{proc.stderr[-2000:]}")
    png = read_png(str(out))
    if png.shape != (C4_H, C4_W, 3) or png.max() == 0:
        fail(f"cli wrote a bad terrain PNG {png.shape}")
    cli_s = time.perf_counter() - t1
    # config 1
    s1, cs1 = sc.single_sphere(device="cuda")
    cam1 = cm.make_camera(cs1["eye"], cs1["look_at"], cs1["up"], 128, 128,
                          cs1["fov"], device="cuda")
    r1 = ProgressiveRenderer(s1, cam1, RenderConfig(spp=16, max_bounces=2),
                             seed=42, device="cuda")
    r1.step()
    img1 = r1.image()
    if not torch.isfinite(img1).all() or float(img1.mean()) <= 0.0:
        fail("config 1 (single-sphere) did not render")
    print(f"[19 wavefront main path] terrain {C4_W}x{C4_H} spp {C4_SPP}, "
          f"{C4_MB} bounces, NEE, two-pass ({scene.mesh.num_tris} triangles, "
          f"{r.scene.mesh_packed.num_nodes} fine nodes, "
          f"{r.scene.mesh_packed_coarse.cell_ids.shape[0]} coarse cells; "
          f"scene set-up {setup_s:.1f} s): {frames} frames, kernel 5 "
          f"launches {launches['packet']}, kernel 6 launches "
          f"{launches['bin']} (= {frames} frames x {C4_MB + 1} bounces x 2 "
          f"waves), mean {float(img.mean()):.6f}, checker modes green "
          f"{green:.3f} pale {pale:.3f} | 256x256 frame vs plain queries on "
          f"the card: {px_agree:.5f} of pixels"
          + (f" (plain cpu vs card floor {floor:.5f})" if floor else "")
          + f" | cli render --scene terrain --backend auto wrote "
          f"{out.relative_to(ROOT)} in {cli_s:.1f} s | config 1 "
          f"single-sphere 128x128 16 spp mean {float(img1.mean()):.6f}",
          flush=True)
    return launches, r, dict(px_agree=px_agree, floor=floor)


def phase_wavefront_vs_persistent():
    """20: cornell_boxes NEE at 256x256, 64 spp: the wavefront (8 frames of
    8 spp) against PersistentRenderer in image mean, within MEAN_TOL."""
    import torch

    from tpu_pathtracer_torch import (
        PersistentRenderer, ProgressiveRenderer, RenderConfig,
    )
    from tpu_pathtracer_torch.models import camera as cm, scene as sc

    scene, cs = sc.cornell_boxes(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 256, 256,
                         cs["fov"], device="cuda")
    cfg = RenderConfig(spp=8, max_bounces=10, use_nee=True)
    wf = ProgressiveRenderer(scene, cam, cfg, seed=5, device="cuda")
    for _ in range(8):
        wf.step()
    pr = PersistentRenderer(scene, cam, cfg, seed=5, device="cuda")
    pr.render_to(64)
    m_w, m_p = float(wf.image().mean()), float(pr.image().mean())
    if not torch.isfinite(wf.image()).all() \
            or abs(m_w - m_p) > MEAN_TOL * abs(m_p):
        fail(f"wavefront mean {m_w} vs persistent {m_p}")
    print(f"[20 wavefront vs persistent] cornell_boxes NEE 256x256, 64 spp, "
          f"10 bounces: wavefront mean {m_w:.6f}, persistent mean {m_p:.6f} "
          f"(min spp {pr.min_samples}), gap {abs(m_w - m_p) / m_p:.4f} "
          f"(bar {MEAN_TOL})", flush=True)
    return m_w, m_p


def _wavefront_profile(r, frames, tag):
    """One torch.profiler trace of ``frames`` frames: device ms per frame
    by kernel group, ms per launch of kernels 5 and 6, and the idle share
    of the window."""
    waves = 2 * (r.config.max_bounces + 1) * frames
    bins = waves if r.scene.mesh_packed_coarse is not None else 0

    def launched(events):
        return (sum("packet_kernel" in e["name"] for e in events),
                sum("bin_kernel" in e["name"] for e in events))

    def complete(events):
        n_p, n_b = launched(events)
        if (n_p, n_b) != (waves, bins):
            return f"{n_p} packet and {n_b} bin launches for {frames} frames"
        return None

    window, events = _traced(
        lambda i: r.step(), frames, f"wavefront_{tag}", complete,
        near=lambda ev: sum(launched(ev)) == waves + bins - 1)
    groups = {"packet": 0.0, "bin": 0.0, "sort": 0.0, "gather": 0.0,
              "other": 0.0}
    n_packet = n_bin = 0
    for e in events:
        nm = e["name"].lower()
        if "packet_kernel" in nm:
            g = "packet"
            n_packet += 1
        elif "bin_kernel" in nm:
            g = "bin"
            n_bin += 1
        elif "sort" in nm:
            g = "sort"
        elif any(x in nm for x in ("index", "gather", "scatter")):
            g = "gather"
        else:
            g = "other"
        groups[g] += e["dur"] / 1e3
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    return dict(
        window_ms=window / frames, busy_ms=busy / frames,
        idle_share=1.0 - busy / window,
        packet_ms=groups["packet"] / max(n_packet, 1),
        bin_ms=groups["bin"] / max(n_bin, 1),
        packet_per_frame=n_packet / frames, bin_per_frame=n_bin / frames,
        **{f"{g}_ms_per_frame": v / frames for g, v in groups.items()})


def _timed(fn):
    """(fn(), its CUDA-event ms)."""
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _packet_bound(live, boxes, tris, found, nbytes) -> tuple[float, float]:
    """Kernel 5's bound in its two yardsticks, ms: f32 operations over the
    f32 peak (counted from csrc/packet.cu: the reciprocal direction per live
    ray, a slab test per box entered, Moller-Trumbore per triangle tested,
    the attributes per found hit; a lower bound, no compare or select
    counted) and bytes over the memory rate."""
    ops = (live * OPS["walk"] + boxes * OPS["slab"] + tris * OPS["tri"]
           + found * OPS["attrs"])
    return ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3


def _packet_tree_bytes(tree) -> int:
    """Bytes of a tree kernel 5 could walk, read once: pack_bvh's nodes and
    slots, or the 64-leaf layout's node tables and slot rows."""
    if hasattr(tree, "tris"):
        return 4 * (tree.nodes.numel() + tree.tris.numel())
    return 4 * (tree.boxes.numel() + tree.meta.numel()
                + tree.tri_rows.numel())


def _packet_io_bytes(t_init, any_hit, perm) -> int:
    """Bytes of one wave query's rays and answers, each moved once:
    t_init (and the permutation, where there is one) on every lane, the
    origin and direction on live lanes only (a dead lane returns at once),
    and the answers the query needs: t, triangle, normal, uv and material
    (32 B) of a closest hit, t alone of an any-hit query."""
    lanes = t_init.shape[0]
    live = int((t_init > 0).sum())
    per_lane = 4 + 4 * (perm is not None) + (4 if any_hit else 32)
    return lanes * per_lane + live * 24


def _kernel_work(r, mode):
    """One frame's wave queries, each as the kernels received it (the rays,
    t_init and permutation of every full wave): kernel 5's answers held
    against its plain version packet_bvh_ref (pack_bvh's tree, the one it
    walks) and against packet_ref (the 64-leaf tree, the TPU kernel's
    contract, by triangle id) on the same inputs by phase 17's bars, kernel
    6's against bin_rays_ref by phase 18's, the work the plain versions
    count (per wave kind: closest hit, shadow), and their ms per wave (CUDA
    events). The bound counts the leaf-<=4 tree's tests (the kernel's own
    tree on a mesh of more than BVH_MAX_LEAF triangles) and the bytes each
    input and output the query needs moves once (``_packet_io_bytes``) with
    the tree; the 64-leaf tree's tests and bytes give the same yardstick on
    the old tree."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    if r.scene.mesh.num_tris <= mk.BVH_MAX_LEAF:
        fail("phase 21's bound counts the kernel's own tree, which is one "
             "leaf on this mesh, not the leaf-<=4 tree")
    with _Recorder("packet_query") as pq, _Recorder("bin_rays") as br:
        r.step()
    torch.cuda.synchronize()
    kinds = {k: dict(waves=0, lanes=0, live=0, io=0, new={}, old={})
             for k in ("closest", "shadow")}
    bins, ms_p, ms_64, ms_b, ms_t = {}, [], [], [], []
    held = dict(agree=1.0, max_abs_err=0.0, sign=0.0, bit_equal=1.0,
                agree_64=1.0, max_abs_err_64=0.0, sign_64=0.0,
                bit_equal_64=1.0, bin_agree=1.0, bin_tn_err=0.0,
                bin_abs_err=0.0)
    pm, bvh = r.scene.mesh_packed, r.scene.mesh_bvh
    for i, (args, kw, out) in enumerate(pq.calls):
        _, o, d, t0, tmin, any_hit = args
        w = kinds["shadow" if any_hit else "closest"]
        w["waves"] += 1
        w["lanes"] += o.shape[0]
        w["live"] += int((t0 > 0).sum())
        w["io"] += _packet_io_bytes(t0, any_hit, kw.get("perm"))
        what = f"{mode} wave {i}, {o.shape[0]} lanes"
        twin, ms = _timed(lambda: mk.packet_bvh_ref(
            kw["bvh"], o, d, t0, tmin, any_hit, counts=w["new"]))
        ms_p.append(ms)
        ref, ms = _timed(lambda: _packet_ref_ids(
            pm, o, d, t0, tmin, any_hit, counts=w["old"]))
        ms_64.append(ms)
        c = _hold_packet(out, twin, t0, any_hit, what, "packet_bvh_ref")
        c64 = _hold_packet(out, ref, t0, any_hit, what)
        for suffix, x in (("", c), ("_64", c64)):
            held["agree" + suffix] = min(held["agree" + suffix], x["agree"])
            held["bit_equal" + suffix] = min(held["bit_equal" + suffix],
                                             x["bit_equal"])
            held["max_abs_err" + suffix] = max(held["max_abs_err" + suffix],
                                               x["max_abs_err"])
            held["sign" + suffix] = max(held["sign" + suffix], x["sign"])
    for i, (args, kw, out) in enumerate(br.calls):
        ref, ms = _timed(lambda: mk.bin_rays_ref(*args, **kw))
        ms_b.append(ms)
        ms_t.append(_timed(lambda: mk.bin_tree_ref(*args, **kw))[1])
        _bin_exact(out, *args[:4], f"{mode} wave {i}", bins)
        agree, rel, absolute = _hold_bin(out[:2], ref[:2],
                                         f"{mode} wave {i}")
        held["bin_agree"] = min(held["bin_agree"], agree)
        held["bin_tn_err"] = max(held["bin_tn_err"], rel)
        held["bin_abs_err"] = max(held["bin_abs_err"], absolute)
    n_waves = len(pq.calls)
    tree, tree_64 = _packet_tree_bytes(bvh), _packet_tree_bytes(pm)
    for w in kinds.values():
        n = max(w["waves"], 1)
        new, old = w["new"], w["old"]
        w["bound"] = _packet_bound(
            w["live"] / n, new.get("boxes", 0) / n, new.get("tris", 0) / n,
            new.get("found", 0) / n, w["io"] / n + tree)
        w["bound_64"] = _packet_bound(
            w["live"] / n, old.get("nodes", 0) / n, old.get("tris", 0) / n,
            old.get("found", 0) / n, w["io"] / n + tree_64)
    # the frame's mean wave, as kernel 5's ms per launch is taken
    per_wave = [sum(w[key][j] * w["waves"] for w in kinds.values()) / n_waves
                for key in ("bound", "bound_64") for j in (0, 1)]
    p_bound = _bound_of(per_wave[0], per_wave[1])
    p_bound_64 = _bound_of(per_wave[2], per_wave[3])
    lanes = sum(w["lanes"] for w in kinds.values())
    live = sum(w["live"] for w in kinds.values())
    out = dict(held=held, waves=n_waves, lanes_per_wave=lanes / n_waves,
               live_per_wave=live / n_waves, kinds=kinds,
               boxes_per_wave=sum(w["new"].get("boxes", 0)
                                  for w in kinds.values()) / n_waves,
               tris_per_wave=sum(w["new"].get("tris", 0)
                                 for w in kinds.values()) / n_waves,
               packet_plain_ms=statistics.median(ms_p),
               packet_plain_64_ms=statistics.median(ms_64),
               packet_bound_ms=p_bound[0], packet_bound_by=p_bound[1],
               packet_bound_64_ms=p_bound_64[0],
               packet_bound_64_by=p_bound_64[1])
    if br.calls:
        coarse = r.scene.mesh_packed_coarse
        C = coarse.cell_ids.shape[0]
        n_b = len(br.calls)
        b_live = sum(int((c[0][3] > 0).sum()) for c in br.calls)
        # the walk's tests (bin_tree_ref's counts), the rays and answers
        # (_bin_io_bytes) and the walk table per wave
        b_ops = ((bins["nodes"] + bins["cells"]) * OPS["bin_cell"]
                 + b_live * OPS["walk"])
        b_bytes = (sum(_bin_io_bytes(c[0][3]) for c in br.calls)
                   + n_b * 4 * coarse.walk_nodes.numel())
        b_bound = _bound(b_ops / n_b, b_bytes / n_b)
        out.update(bin_waves=n_b, cells=C, nodes=coarse.num_nodes,
                   bin_tests_per_ray=(bins["nodes"] + bins["cells"])
                   / max(b_live, 1),
                   bin_nodes_per_ray=bins["nodes"] / max(b_live, 1),
                   bin_cells_per_ray=bins["cells"] / max(b_live, 1),
                   bin_plain_ms=statistics.median(ms_b),
                   bin_tree_plain_ms=statistics.median(ms_t),
                   bin_bound_ms=b_bound[0], bin_bound_by=b_bound[1])
    return out


def _fmt_walk_tests(mode, o) -> str:
    """One mode's part of the [packet walk tests] line."""
    parts = []
    for kind, w in o["kinds"].items():
        live = max(w["live"], 1)
        new, old = w["new"], w["old"]
        parts.append(
            f"{kind} ({w['waves']} waves, live share "
            f"{w['live'] / max(w['lanes'], 1):.4f}): boxes / triangles per "
            f"live ray, leaf-<=4 tree {new.get('boxes', 0) / live:.2f} / "
            f"{new.get('tris', 0) / live:.2f}, 64-leaf tree "
            f"{old.get('nodes', 0) / live:.2f} / "
            f"{old.get('tris', 0) / live:.2f}; bound per wave, operations / "
            f"bytes ms: leaf-<=4 {w['bound'][0]:.5f} / {w['bound'][1]:.5f}, "
            f"64-leaf {w['bound_64'][0]:.5f} / {w['bound_64'][1]:.5f}")
    return f"{mode}: " + "; ".join(parts)


def phase_wavefront_times(smi, r2):
    """21: times at config 4, two-pass (the main path's renderer) and
    single-pass: ms per frame (CUDA events, slope between 1 and 3 frames,
    median of REPS), one profiler trace of 2 frames (kernels 5 and 6 per
    launch, sort and gather glue, other ops, idle share), then one more
    frame whose every wave query is run again through the plain versions
    on the kernels' own inputs (``_kernel_work``): the kernels' answers held
    to phases 17 and 18's bars at the main path's full shapes, the bounds
    from the plain versions' counts of that work, and their ms per wave;
    the ``[packet walk tests]`` line gives those counts per wave kind on
    both trees and kernel 5's bound in both yardsticks."""
    import dataclasses

    from tpu_pathtracer_torch import ProgressiveRenderer

    out = {}
    r1 = ProgressiveRenderer(
        dataclasses.replace(r2.scene, mesh_packed_coarse=None), r2.camera,
        r2.config, seed=4, device="cuda")
    for mode, r in (("two_pass", r2), ("single_pass", r1)):
        ms, slopes = _slope_ms(lambda salt, i: r.step(), 3)
        o = dict(frame_ms=ms, frame_ms_reps=slopes)
        o.update(_wavefront_profile(r, 2, mode))
        o.update(_kernel_work(r, mode))
        out[mode] = o
    parts = []
    for mode, o in out.items():
        s = (f"{mode}: frame {o['frame_ms']:.3f} ms (median of {REPS}: "
             f"{', '.join(f'{x:.3f}' for x in o['frame_ms_reps'])}); "
             f"profiled window {o['window_ms']:.3f} ms/frame, device busy "
             f"{o['busy_ms']:.3f}, idle share {o['idle_share']:.3f}; "
             f"kernel 5 {o['packet_ms']:.4f} ms/launch x "
             f"{o['packet_per_frame']:.0f}/frame (bound "
             f"{o['packet_bound_ms']:.5f} ms by {o['packet_bound_by']} on "
             f"the leaf-<=4 tree, {o['packet_bound_64_ms']:.5f} ms by "
             f"{o['packet_bound_64_by']} on the 64-leaf tree; "
             f"{o['live_per_wave']:.0f} live rays, {o['boxes_per_wave']:.0f} "
             f"box and {o['tris_per_wave']:.0f} triangle tests per wave; "
             f"plain packet_bvh_ref {o['packet_plain_ms']:.1f} ms/wave, "
             f"packet_ref {o['packet_plain_64_ms']:.1f}; every full wave vs "
             f"packet_bvh_ref: agree >= {o['held']['agree']:.5f}, bit-equal "
             f">= {o['held']['bit_equal']:.5f}, max|dt| "
             f"{o['held']['max_abs_err']:.3g}, sign balance "
             f"{o['held']['sign']:.3f} of its bar; vs packet_ref: agree >= "
             f"{o['held']['agree_64']:.5f}, bit-equal >= "
             f"{o['held']['bit_equal_64']:.5f}, max|dt| "
             f"{o['held']['max_abs_err_64']:.3g}, sign balance "
             f"{o['held']['sign_64']:.3f})")
        if "bin_bound_ms" in o:
            s += (f"; kernel 6 {o['bin_ms']:.4f} ms/launch x "
                  f"{o['bin_per_frame']:.0f}/frame (bound "
                  f"{o['bin_bound_ms']:.5f} ms by {o['bin_bound_by']}; "
                  f"{o['cells']} cells, {o['nodes']} nodes, the walk's "
                  f"tests per live ray {o['bin_nodes_per_ray']:.2f} nodes "
                  f"+ {o['bin_cells_per_ray']:.2f} cells; plain "
                  f"bin_rays_ref {o['bin_plain_ms']:.1f} ms/wave, "
                  f"bin_tree_ref {o['bin_tree_plain_ms']:.1f}; every full "
                  f"wave's cell, tn and key equal to both plain versions)")
        s += (f"; device ms/frame: packet {o['packet_ms_per_frame']:.3f}, "
              f"bin {o['bin_ms_per_frame']:.3f}, sort "
              f"{o['sort_ms_per_frame']:.3f}, gather/scatter "
              f"{o['gather_ms_per_frame']:.3f}, other "
              f"{o['other_ms_per_frame']:.3f}")
        parts.append(s)
    print(f"[21 wavefront times] terrain {C4_W}x{C4_H} spp {C4_SPP}, "
          f"{C4_MB} bounces, NEE on {smi}: " + " | ".join(parts), flush=True)
    print("[packet walk tests] config 4, every wave of a main-path frame as "
          "kernel 5 received it: " + " | ".join(
              _fmt_walk_tests(mode, o) for mode, o in out.items()),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Thin-lens DOF and in-kernel textures in the persistent kernels, phases
# 22-27
# ---------------------------------------------------------------------------

def _red_cyan(img):
    """Shares of lit pixels where red, or green, is more than twice the
    other: the checker quad's two tiles."""
    lum = img.sum(-1)
    lit = lum > 0.05 * float(lum.max())
    n = max(int(lit.sum()), 1)
    return (int((lit & (img[..., 0] > 2 * img[..., 1])).sum()) / n,
            int((lit & (img[..., 1] > 2 * img[..., 0])).sum()) / n)


def phase_dof_main():
    """23: PersistentRenderer with the lens on cornell_spheres and
    cornell_boxes, brute force and NEE (7 and 10 draws), 640x480, budget 16,
    to 4 spp, every launch replayed and checked by phase 4's bars; each
    image differs from the same render through the pinhole camera."""
    import torch

    from tpu_pathtracer_torch import PersistentRenderer, RenderConfig

    total, mesh_total, worst, parts = 0, 0, [], []
    for name in ("cornell", "cornell-boxes"):
        launches, mesh_l, w, images = phase_main_path(
            name, (False, True), budget=16, target=4,
            label="23 DOF main path", lens=LENS)
        total, mesh_total = total + launches, mesh_total + mesh_l
        worst.append(w)
        scene, cam, _ = _scene(name, W, H, "cuda")
        for use_nee, img in images.items():
            r = PersistentRenderer(
                scene, cam, RenderConfig(spp=4, max_bounces=10, rr_start=3,
                                         use_nee=use_nee),
                seed=7, device="cuda", budget=16)
            r.render_to(4)
            gap = float((img - r.image()).abs().max())
            if not gap > 0.05:
                fail(f"{name} lens image equals the pinhole image "
                     f"(max |d| {gap})")
            parts.append(f"{name} {'nee' if use_nee else 'brute'} lens vs "
                         f"pinhole max|d| {gap:.3f}")
    torch.cuda.synchronize()
    print("[23 DOF main path] " + " | ".join(parts), flush=True)
    return total, mesh_total, {
        k: (min if "agree" in k or "floor" in k else max)(x[k] for x in worst)
        for k in worst[0]}


def phase_texture_main(smi):
    """25: the textured main path. PersistentRenderer on terrain32 (NEE, 3
    bounces, 640x480, budget 16, to 4 spp) with every launch replayed and
    checked; the checker quad through the renderer shows both tiles; and
    terrain32 through the persistent kernel against the wavefront in image
    mean (256x256, 64 spp, as phase 20)."""
    import torch

    from tpu_pathtracer_torch import (
        PersistentRenderer, ProgressiveRenderer, RenderConfig,
    )

    launches, walks, worst, _ = phase_main_path(
        "terrain32", (True,), budget=16, target=4,
        label="25 textured main path", max_bounces=C4_MB)
    if walks != launches:
        fail(f"textured main path: {walks} of {launches} launches walked a "
             "mesh")
    scene, cam, _ = _scene("checker", W, H, "cuda")
    r = PersistentRenderer(scene, cam, RenderConfig(spp=4, max_bounces=1,
                                                    use_nee=True),
                           seed=3, device="cuda", budget=16)
    r.render_to(4)
    red, cyan = _red_cyan(r.image())
    if red < 0.05 or cyan < 0.05:
        fail(f"checker quad: the tiles do not both show (red {red}, cyan "
             f"{cyan})")
    scene, cam, _ = _scene("terrain32", 256, 256, "cuda")
    cfg = RenderConfig(spp=8, max_bounces=C4_MB, use_nee=True)
    wf = ProgressiveRenderer(scene, cam, cfg, seed=5, device="cuda")
    for _ in range(8):
        wf.step()
    pr = PersistentRenderer(scene, cam, cfg, seed=5, device="cuda")
    pr.render_to(64)
    torch.cuda.synchronize()
    m_w, m_p = float(wf.image().mean()), float(pr.image().mean())
    if not torch.isfinite(pr.image()).all() \
            or abs(m_w - m_p) > MEAN_TOL * abs(m_p):
        fail(f"terrain32: wavefront mean {m_w} vs persistent {m_p}")
    print(f"[25 textured checks] checker quad 640x480 NEE, 4 spp: red tiles "
          f"{red:.3f}, cyan tiles {cyan:.3f} of lit pixels | terrain32 NEE "
          f"256x256, 64 spp, {C4_MB} bounces: wavefront mean {m_w:.6f}, "
          f"persistent mean {m_p:.6f} (min spp {pr.min_samples}), gap "
          f"{abs(m_w - m_p) / m_p:.4f} (bar {MEAN_TOL})", flush=True)
    return launches, walks, worst, dict(red=red, cyan=cyan, wavefront=m_w,
                                        persistent=m_p)


def phase_c4_persistent(smi, wf_renderer, wf_times):
    """26: config 4 at full width through the persistent kernel: the terrain
    (99,458 triangles) at 1024x1024, 3 bounces, NEE, PersistentRenderer
    (the backend cli render --backend pallas takes) at budget C4_BUDGET
    (half the renderer's default, so the plain version's replay of a launch
    takes half as long; phase 43 times a default launch), render_to(2), the
    launch count set to 0 just before and read just after; the image is
    finite, shows the checker and its mean is within MEAN_TOL of the
    wavefront's (phase 19's 4 frames). Every launch is replayed and held to
    the plain version on the card by phase 4's bars on three bands of tiles
    (``_replay_bands``): the plain walk over all 1M lanes of a 4,095-node
    tree would take minutes. Then ms to 2 spp (CUDA events around reset +
    render_to(2), median of REPS) beside phase 21's wavefront frame, and one
    profiler trace of those launches for the kernel's ms per launch and the
    idle share."""
    import torch

    from tpu_pathtracer_torch import PersistentRenderer
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE

    t0 = time.perf_counter()
    scene, cs = sc.terrain_textured(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], C4_W, C4_H,
                         cs["fov"], device="cuda")
    r = PersistentRenderer(scene, cam, _c4_config(), seed=3, device="cuda",
                           budget=C4_BUDGET)
    setup_s = time.perf_counter() - t0
    pk.launches = pk.mesh_launches = 0
    rays = r.render_to(C4_SPP)
    torch.cuda.synchronize()
    launches, walks, steps = pk.launches, pk.mesh_launches, r.state.frame
    if launches != steps or walks != launches or steps == 0:
        fail(f"config 4 persistent: {launches} launches ({walks} on a mesh) "
             f"for {steps} steps")
    img = r.image()
    if tuple(img.shape) != (C4_H, C4_W, 3) or not torch.isfinite(img).all():
        fail(f"config 4 persistent: bad image {tuple(img.shape)}")
    green, pale = _texture_modes(img)
    m_p, m_w = float(img.mean()), float(wf_renderer.image().mean())
    if green < 0.05 or pale < 0.05 or abs(m_p - m_w) > MEAN_TOL * abs(m_w):
        fail(f"config 4 persistent: mean {m_p} vs the wavefront's {m_w}, "
             f"checker modes green {green} pale {pale}")
    paths = int(r.state.n_samp.sum() + r.state.alive.sum())
    # every launch held to the plain version on three bands of
    # C4_BAND_TILES tiles spread over the image (top, middle, bottom)
    n_tiles = r.state.lr.shape[0] // TR
    bands = [(int(n_tiles * f), C4_BAND_TILES)
             for f in (1 / 6, 1 / 2, 5 / 6)]
    # the plain version's one run samples the segments for the bound (its
    # seconds include the sampler's, printed on the [walk tests] line)
    sample = WalkSample(r.scene,
                        "26 config 4 persistent, the bands' segments")
    checks, plain_s = _replay_bands(r, bands, sample)
    for c in checks:
        if c["n_agree"] < min(AGREE, c["n_floor"]) \
                or c["l_agree"] < min(AGREE, c["l_floor"]) \
                or c["ray_err"] > RAY_TOL:
            fail(f"config 4 persistent, launch {c['launch']} tiles "
                 f"{c['tiles']} vs plain: {c}")
    worst = {k: min(c[k] for c in checks)
             for k in ("n_agree", "l_agree", "n_floor", "l_floor")}
    worst["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    band_s = " | ".join(
        f"launch {c['launch']} tiles {c['tiles'][0]}-"
        f"{c['tiles'][0] + c['tiles'][1] - 1}: n {c['n_agree']:.4f} L "
        f"{c['l_agree']:.4f} max|dL| {c['max_abs_err']:.3g} (plain cpu vs "
        f"card: n {c['n_floor']:.4f} L {c['l_floor']:.4f})"
        for c in checks) + "; rays of the bands " + ", ".join(
        f"{c['rays'][0]}/{c['rays'][1]}" for c in checks[::len(bands)]) \
        + "; plain s per launch " + ", ".join(f"{x:.1f}" for x in plain_s)

    def to_spp():
        r.reset()
        return r.render_to(C4_SPP)

    _timed(to_spp)  # warm
    runs = [_timed(to_spp)[1] for _ in range(REPS)]
    ms = statistics.median(runs)
    kernel_ms, busy, window, _ = _profile(lambda i: r.step(), steps,
                                          "persistent_kernel",
                                          "c4_persistent", start=r.reset)
    pm = r.scene.mesh_packed
    # the counted rays split into path and shadow segments as the plain
    # version's walks on the three bands split; no texel fetch is counted
    # (no plain run counts them at this size), so a lower bound
    shadow = sample.shadow_share()
    ops = _walk_ops(r.scene, rays / steps * (1.0 - shadow), paths / steps,
                    rays / steps * shadow, walks=sample)
    nbytes = (20 * 4 * 2 * r.state.lr.numel() + _mesh_bytes(r.scene)
              + 4 * scene.textures.numel())
    bound_ms, bound_by = _bound(ops, nbytes)
    frame = wf_times["two_pass"]["frame_ms"]
    print(f"[26 config 4 persistent] terrain {C4_W}x{C4_H}, {C4_MB} bounces, "
          f"NEE, PersistentRenderer budget {r.budget} on {smi} (scene set-up "
          f"{setup_s:.1f} s, the kernel's tree {r.scene.mesh_bvh.num_nodes} "
          f"nodes, the plain version's {pm.num_nodes}): {launches} launches = "
          f"{steps} steps to {C4_SPP} spp (min spp {r.min_samples}), "
          f"{rays} rays, mean {m_p:.6f} vs the wavefront's {m_w:.6f} (gap "
          f"{abs(m_p - m_w) / m_w:.4f}, bar {MEAN_TOL}), checker modes green "
          f"{green:.3f} pale {pale:.3f} | {ms:.3f} ms to {C4_SPP} spp "
          f"(median of {REPS}: {', '.join(f'{x:.3f}' for x in runs)}) "
          f"against the wavefront's {frame:.3f} ms per {C4_SPP}-spp frame; "
          f"kernel {kernel_ms:.4f} ms/launch (bound {bound_ms:.5f} ms by "
          f"{bound_by}, a lower bound), profiled window {window:.4f} "
          f"ms/launch, idle share {1.0 - busy / window:.3f} | every launch "
          f"vs plain on the card, band by band: {band_s}", flush=True)
    return dict(launches=launches, walks=walks, ms_to_spp=ms, runs=runs,
                worst=worst,
                kernel_ms=kernel_ms, idle_share=1.0 - busy / window,
                bound_ms=bound_ms, bound_by=bound_by, mean=m_p,
                wavefront_mean=m_w, wavefront_frame_ms=frame)


# ---------------------------------------------------------------------------
# --ab: the persistent kernels' device time per launch in two checkouts
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Texture-atlas gradients: kernel 3's TEX build (launch 1, C_tot records)
# and its scatter walk (launch 2), the textured trainer, the chunked driver
# ---------------------------------------------------------------------------

TEX_GRAD_BUDGET = 10
TEX_TRAIN_STEPS = 5
TEX_ATLAS_SCALE = 0.6  # the trainer starts from the atlas times this


def _tex_scene(device):
    """The JAX suite's tex_scene (tests/test_replay_persistent.py:951-976):
    a quad floor with an 8x8 two-colour checker, a diffuse sphere, an
    emissive sphere area light and a point light, and its camera."""
    from tpu_pathtracer_torch.models import meshes, scene as sc
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    scene = sc.make_scene(
        [sc.sphere([0, 2, 0], 1.0, 1),
         sc.sphere([2, 2.5, 0], 1.5, 2, light=1)],
        [sc.diffuse([0.7, 1.0, 0.9]), sc.diffuse([0.8, 0.4, 0.3]),
         sc.diffuse([0.05, 0.05, 0.05])],
        [sc.point_light([0.0, 8.0, 3.0], [60.0, 60.0, 60.0]),
         sc.area_light(1, [40.0, 40.0, 40.0])],
        mesh=build_bvh(v, f, uv, 0, device=device),
        textures=meshes.checker_texture(8, tiles=2, c0=(0.9, 0.2, 0.15),
                                        c1=(0.1, 0.8, 0.85)),
        mat_texture=[0, -1, -1], device=device)
    return scene, dict(eye=[0, 10, 9], look_at=[0, 0, 0], up=[0, 1, 0],
                       fov=60.0)


def _atomic_ratio(a, b, s_abs):
    """The largest |a - b| over ATOMIC_RTOL * s_abs (1.0 is the bar): two
    scatters of the same inputs, s_abs the scatter of |g|."""
    import torch

    from tpu_pathtracer_torch.utils.metrics import ATOMIC_RTOL

    d = (a.double() - b.double()).abs()
    lim = ATOMIC_RTOL * s_abs.double()
    if bool(((d > 0) & (lim == 0)).any()):
        return math.inf
    return float(torch.where(lim > 0, d / lim.clamp_min(1e-300), 0.0).max())


def _check_tex_launch(label, args, kw, w, h, main_loss=None, main_gT=None):
    """``_check_grad_launch`` on a textured scene (L, n_samp, GA/GI and the
    C_tot records lane for lane), then the scatter: launch 2 replays launch
    1's radiance and counts bit for bit; two scatters of the same inputs
    (the call's own launch 2, its replay and ``main_gT``, the main path's
    atlas gradient, if given) agree within the atomic bound; with the same
    cotangent, zeroed on the lanes where kernel and plain walks disagree,
    the kernel's atlas gradient is within ATLAS_RTOL of the plain one and
    not zero."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import ATLAS_RTOL, atlas_gap

    c = _check_grad_launch(label, args, kw, w, h, main_loss)
    k_adj, k_both, r_adj = c.pop("outs")
    mask = c.pop("mask").to("cuda")
    tgt = args[4]
    lane0 = kw.get("tile_offset", 0) * kw["tile_rows"] * 128
    g = rp.lane_cotangent(k_adj[0], k_adj[1], tgt, w, h, lane0)
    L2, n2, rays2, gT = rp.scatter_walk(*args, g, k_adj[5], k_adj[1], **kw)
    s_abs = rp.scatter_walk(*args, g.abs(), k_adj[5], k_adj[1], **kw)[3]
    gm = g * mask
    gk = rp.scatter_walk(*args, gm, k_adj[5], k_adj[1], **kw)[3]
    gr = rp.persistent_replay_ref(*args, phase="scatter", ext_g=gm,
                                  ext_ct=r_adj[5], ext_ns=r_adj[1], **kw)
    torch.cuda.synchronize()
    off = int((L2 != k_adj[0]).any(-1).sum() + (n2 != k_adj[1]).sum())
    if off or int(rays2) != int(k_adj[4]):
        fail(f"{label}: the scatter launch's replay differs from launch 1 on "
             f"{off} lane outputs (rays {int(rays2)} vs {int(k_adj[4])})")
    ratio = max(_atomic_ratio(x, gT, s_abs)
                for x in (k_both[6], main_gT) if x is not None)
    if not ratio <= 1.0:
        fail(f"{label}: two scatters of the same inputs differ by {ratio} "
             "times the atomic bound")
    gap, top = atlas_gap(gk, gr), float(gr.abs().max())
    if not (gap <= ATLAS_RTOL and top > 0):
        fail(f"{label}: masked-g atlas gradient gap {gap} of max|gT| {top} "
             f"(bar {ATLAS_RTOL})")
    c.update(atlas_gap=gap, atomic_ratio=ratio, gT_max=top,
             atlas_abs_err=float((gk - gr).abs().max()),
             masked=int((~mask).reshape(-1)[:w * h].sum()),
             taps=int((gr != 0).sum()))
    return c


def _fmt_tex(c) -> str:
    return (f"{_fmt_check(c)}; replay bit for bit; atlas: masked-g gap "
            f"{c['atlas_gap']:.3g} of max|gT| {c['gT_max']:.4g} ({c['taps']} "
            f"nonzero cells, {c['masked']} lanes masked), atomic "
            f"{c['atomic_ratio']:.3g} of its bound")


def _worst_tex(checks) -> dict:
    return dict(n_agree=min(c["n_agree"] for c in checks),
                l_agree=min(c["l_agree"] for c in checks),
                plane_agree=min(c["plane_agree"] for c in checks),
                floor=min((c["floor"] for c in checks
                           if c["floor"] is not None), default=None),
                max_abs_err=max(c["max_abs_err"] for c in checks),
                sign_balance=max(c["image"][0] for c in checks),
                atlas_gap=max(c["atlas_gap"] for c in checks),
                atlas_abs_err=max(c["atlas_abs_err"] for c in checks),
                atomic_ratio=max(c["atomic_ratio"] for c in checks))


def phase_tex_grad_compare():
    """28: the textured gradient against its plain version at 640x480, spp
    4, 10 bounces, budget 10: tex_scene and terrain32, brute force and NEE,
    injected uniforms and Philox (``_check_tex_launch``)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(78)
    tgt = rp.target_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), rows)
    parts, checks = [], []
    for name in ("tex-scene", "terrain32"):
        scene, cam, cp = _scene(name, W, H, "cuda")
        for use_nee in (False, True):
            for injected in (True, False):
                case = (f"{name}-{'nee' if use_nee else 'brute'}-"
                        f"{'injected' if injected else 'philox'}")
                u = (torch.rand((rows * TEX_GRAD_BUDGET * pk.n_draws(use_nee),
                                 pk.LANES), generator=gen, device="cuda")
                     if injected else None)
                kw = dict(spp=SPP, budget=TEX_GRAD_BUDGET, width=W, height=H,
                          max_bounces=MB, rr_start=3, tile_rows=TR,
                          use_nee=use_nee, uniforms=u)
                c = _check_tex_launch(case, (scene, cp, (6, 2), 3, tgt), kw,
                                      W, H)
                checks.append(c)
                parts.append(f"{case}: {_fmt_tex(c)}")
    print(f"[28 textured gradient vs plain] {W}x{H} spp {SPP}, {MB} "
          f"bounces, budget {TEX_GRAD_BUDGET}: " + " | ".join(parts),
          flush=True)
    return _worst_tex(checks)


def phase_tex_trainer():
    """29: the textured trainer at full width: terrain32 at 640x480, spp 4,
    10 bounces, budget 26, NEE; the target from render_target_kernel (one
    launch, no atlas gradient), then TEX_TRAIN_STEPS same-seed Adam steps
    from params_of (the true colours and light, the atlas times
    TEX_ATLAS_SCALE): the loss falls, two launches per step, one of them a
    scatter; the last step's launches replayed and checked."""
    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, cam, cp = _scene("terrain32", W, H, "cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    budget = rp.default_budget(SPP, MB)
    seed = (19, 0)
    config = RenderConfig(spp=SPP, max_bounces=MB, rr_start=3, use_nee=True)
    p0 = inverse.params_of(scene)
    if set(p0) != {"mat_color", "light_intensity", "textures"}:
        fail(f"params_of(terrain32) holds {sorted(p0)}")
    p0["textures"] = p0["textures"] * TEX_ATLAS_SCALE
    state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
    step = inverse.make_kernel_train_step(scene, cam, config,
                                          fixed_iteration=0)
    pk.launches = rp.launches = rp.mesh_launches = rp.scatter_launches = 0
    target = inverse.render_target_kernel(scene, cam, seed, config,
                                          iteration=0)
    losses = []
    for _ in range(TEX_TRAIN_STEPS):
        last = {k: v.detach().clone() for k, v in state.params.items()}
        state, loss = step(state, target, seed)
        losses.append(loss)
    torch.cuda.synchronize()
    counts = dict(launches=rp.launches, scatter=rp.scatter_launches,
                  mesh=rp.mesh_launches)
    if (rp.launches != 1 + 2 * TEX_TRAIN_STEPS
            or rp.scatter_launches != TEX_TRAIN_STEPS
            or rp.mesh_launches != rp.launches or pk.launches):
        fail(f"textured trainer: launches {counts} and {pk.launches} forward "
             f"for 1 target and {TEX_TRAIN_STEPS} steps")
    main_gT = state.params["textures"].grad.detach().clone()
    vals = [float(x) for x in losses]
    finite = (bool(torch.isfinite(target).all())
              and all(bool(torch.isfinite(v.detach()).all())
                      for v in state.params.values())
              and all(map(math.isfinite, vals)))
    if tuple(target.shape) != (W * H, 3) or not finite:
        fail("textured trainer: non-finite or misshapen results")
    if not vals[-1] < vals[0]:
        fail(f"textured trainer: loss {vals[0]} -> {vals[-1]} did not fall")
    true_tex = scene.textures
    gap0 = float((p0["textures"] - true_tex).abs().mean())
    gap1 = float((state.params["textures"].detach() - true_tex).abs().mean())
    kw = dict(spp=SPP, budget=budget, width=W, height=H, max_bounces=MB,
              rr_start=3, tile_rows=TR, use_nee=True)
    c = _check_tex_launch(
        "textured trainer last launches",
        (inverse.apply_params(scene, last), cp, seed, 0,
         rp.target_to_lanes(target.reshape(H, W, 3), rows)), kw, W, H,
        main_loss=losses[-1], main_gT=main_gT)
    print(f"[29 textured trainer main path] terrain32 {W}x{H} spp {SPP}, "
          f"{MB} bounces, budget {budget}, NEE, lr {LR}, atlas x "
          f"{TEX_ATLAS_SCALE}: loss {' '.join(f'{v:.6g}' for v in vals)}; "
          f"mean |atlas - true| {gap0:.5f} -> {gap1:.5f}; launches "
          f"{counts['launches']} = 1 + 2 x {TEX_TRAIN_STEPS} ("
          f"{counts['scatter']} scatter, {counts['mesh']} on the mesh); last "
          f"launches vs plain: {_fmt_tex(c)}", flush=True)
    return counts, _worst_tex([c])


def phase_tex_chunked():
    """30: the chunked driver, tex_scene at 160x120, spp 48 (chunks 32 +
    16, default budgets), NEE, Philox: the kernel's loss and gradients
    against the plain driver's on the card (the plain walk in place of the
    kernel), loss rtol 1e-4, gradients rtol 2e-3 (the fold bars of phase 7,
    atol 1e-6 of the largest entry), the atlas within ATLAS_RTOL."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import ATLAS_RTOL, atlas_gap

    w, h, spp = 160, 120, 48
    scene, cam, _ = _scene("tex-scene", w, h, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    target = torch.rand((h, w, 3), generator=gen, device="cuda")
    kw = dict(spp=spp, max_bounces=MB, rr_start=3, tile_rows=TR,
              use_nee=True)
    plan = rp.chunk_plan(spp, None, MB)
    before = rp.launches
    k = rp.persistent_mse_value_and_grad(scene, cam, (3, 1), 2, target, **kw)
    torch.cuda.synchronize()
    if rp.launches - before != 2 * len(plan):
        fail(f"chunked driver: {rp.launches - before} launches for "
             f"{len(plan)} chunks")
    call = rp.persistent_replay_call
    rp.persistent_replay_call = rp.persistent_replay_ref
    try:
        r = rp.persistent_mse_value_and_grad(scene, cam, (3, 1), 2, target,
                                             **kw)
    finally:
        rp.persistent_replay_call = call
    torch.cuda.synchronize()
    gaps = {}
    for name in ("mat_color", "light_intensity"):
        a, b = k[1][name], r[1][name]
        scale = float(b.abs().max())
        if not _close(a, b, GRAD_RTOL, 1e-6 * scale):
            fail(f"chunked driver: {name} {a} vs plain {b}")
        gaps[name] = float(((a - b).abs() / (b.abs() + 1e-6 * scale)).max())
    gaps["textures"] = atlas_gap(k[1]["textures"], r[1]["textures"])
    if not (_close(k[0], r[0], LOSS_RTOL)
            and gaps["textures"] <= ATLAS_RTOL
            and float(r[1]["textures"].abs().max()) > 0):
        fail(f"chunked driver: loss {float(k[0])} vs plain {float(r[0])}, "
             f"atlas gap {gaps['textures']}")
    loss_gap = abs(float(k[0]) - float(r[0])) / abs(float(r[0]))
    print(f"[30 chunked driver] tex_scene {w}x{h} spp {spp} = chunks "
          f"{plan} (samples, budget), NEE: {rp.launches - before} launches; "
          f"loss {float(k[0]):.6g} vs plain {float(r[0]):.6g} (relative gap "
          f"{loss_gap:.3g}); relative gaps mat_color "
          f"{gaps['mat_color']:.3g}, light_intensity "
          f"{gaps['light_intensity']:.3g}, atlas {gaps['textures']:.3g} of "
          f"max|gT|", flush=True)
    return dict(loss_gap=loss_gap, **gaps)


def phase_tex_grad_times(smi):
    """31: the textured gradient on terrain32 at 640x480, spp 4, 10 bounces,
    budget 26, NEE (BASELINE's texture-gradient row at spp 4): ms per
    gradient by the CUDA-event slope between 1 and K calls (median of
    REPS), with and without the atlas gradient; one profiled window for
    each launch's kernel ms and the idle share; the plain version's ms per
    launch; each launch's bound from this run's work (the plain version's
    counts of shadow segments, texel fetches and scattered vertices on the
    same seed; the mesh walk's box and triangle tests counted on a sample
    of its segments, ``WalkSample``)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, cam, cp = _scene("terrain32", W, H, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    target = torch.rand((H, W, 3), generator=gen, device="cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    tgt = rp.target_to_lanes(target, rows)
    budget = rp.default_budget(SPP, MB)
    K = 12
    out = {}
    for tex_grad in (True, False):
        # the atlas gradient (two launches) or the same call without it
        grad_ms, ms = _slope_ms(
            lambda salt, i, tex_grad=tex_grad: rp.persistent_replay_call(
                scene, cp, (salt, i), 0, tgt, spp=SPP, budget=budget,
                width=W, height=H, max_bounces=MB, rr_start=3, tile_rows=TR,
                use_nee=True, compute_tex_grad=tex_grad), K)
        out[tex_grad] = dict(grad_ms=grad_ms, reps=ms)

    kw = dict(spp=SPP, budget=budget, width=W, height=H, max_bounces=MB,
              rr_start=3, tile_rows=TR, use_nee=True)
    args = (scene, cp, (300, 0), 0, tgt)
    # the plain version: launch 1 (records), then the scatter, timed apart
    counts = {}
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    start.record()
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", counts=counts,
                                     **kw)
    mid.record()
    g = rp.lane_cotangent(r_adj[0], r_adj[1], tgt, W, H)
    rp.persistent_replay_ref(*args, phase="scatter", ext_g=g,
                             ext_ct=r_adj[5], ext_ns=r_adj[1], counts=counts,
                             **kw)
    end.record()
    torch.cuda.synchronize()
    plain1_ms, plain2_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    walks = WalkSample(scene, "31 textured gradient times terrain32")
    rp.persistent_replay_ref(*args, phase="adjoint", walks=walks, **kw)
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    n_slots = len(rp.material_slots(scene)[0])
    n_l = len(scene.light_structure)
    segments, paths = int(k_adj[4]), int(k_adj[1].sum())
    shadows, texels = int(counts["shadow"]), int(counts["texel"])
    scattered = int(counts["scatter"])
    walk = _walk_ops(scene, segments, paths, shadows, texels, walks=walks)
    lanes = rows * 128
    atlas = scene.textures.numel() * 4
    k_part = 3 * n_slots + 3 * n_l + 1
    b1 = _bound(walk + segments * OPS["adjoint_segment"]
                + paths * (OPS["adjoint_flush_slot"] * n_slots
                           + OPS["adjoint_flush_light"] * n_l),
                lanes * (12 + 12 + 4) + rows * (4 * k_part + 4) + atlas
                + 3 * SPP * lanes * 4)
    b2 = _bound(walk + scattered * (OPS["scatter_vertex"]
                                    + 12 * OPS["scatter_add"]),
                lanes * 4 * (3 + 3 * SPP + 1) + lanes * 4 * 4 + rows * 4
                + 2 * atlas)

    def run(i):
        rp.persistent_replay_call(
            scene, cp, (400, i), 0, tgt, spp=SPP, budget=budget, width=W,
            height=H, max_bounces=MB, rr_start=3, tile_rows=TR, use_nee=True)

    names = ("replay_persistent_kernel", "replay_scatter_kernel")

    def launched(events):
        return [sum(nm in e["name"] for e in events) for nm in names]

    def complete(events):
        n = launched(events)
        return None if n == [10, 10] else f"{n} launches of {names} for 10"

    window, events = _traced(run, 10, "grad_textured_nee", complete,
                             near=lambda ev: sum(launched(ev)) == 19)
    # per launch over the launches the trace recorded (_traced)
    kern = [sum(e["dur"] for e in events if nm in e["name"]) / n / 1e3
            for nm, n in zip(names, launched(events))]
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 10 / 1e3
    idle = 1.0 - busy / (window / 10)
    if idle < 0.0:
        fail(f"textured gradient: device busy {busy} ms exceeds the window")
    t, f = out[True], out[False]
    live = _live_share(counts, segments, W * H, budget)
    res = dict(grad_ms=t["grad_ms"], grad_ms_no_atlas=f["grad_ms"], live=live,
               ms1=kern[0], ms2=kern[1], idle_share=idle, busy_ms=busy,
               window_ms=window / 10, plain1_ms=plain1_ms,
               plain2_ms=plain2_ms, bound1_ms=b1[0], bound1_by=b1[1],
               bound2_ms=b2[0], bound2_by=b2[1], segments=segments,
               paths=paths, shadows=shadows, texels=texels,
               scattered=scattered)
    print(f"[31 textured gradient times] terrain32 {W}x{H} spp {SPP}, {MB} "
          f"bounces, budget {budget}, NEE, atlas {tuple(scene.textures.shape)}"
          f" on {smi}: {t['grad_ms']:.4f} ms per gradient with the atlas "
          f"(median of {REPS}; {', '.join(f'{v:.4f}' for v in t['reps'])}), "
          f"{f['grad_ms']:.4f} ms without ({', '.join(f'{v:.4f}' for v in f['reps'])}); "
          f"kernel ms per launch: launch 1 {kern[0]:.4f}, scatter "
          f"{kern[1]:.4f}; profiled window {window / 10:.4f} ms, device busy "
          f"{busy:.4f} ms, idle share {idle:.3f}; plain launch 1 "
          f"{plain1_ms:.2f} ms, scatter {plain2_ms:.2f} ms; bound launch 1 "
          f"{b1[0]:.5f} ms by {b1[1]}, scatter {b2[0]:.5f} ms by {b2[1]} "
          f"({segments} segments, {paths} paths, {shadows} "
          f"shadow segments, {texels} texel fetches, {scattered} scattered "
          f"vertices)", flush=True)
    print("[replay live share] terrain32 (phase 31, launch 1 and the "
          "scatter walk one schedule): " + _fmt_live("nee", live), flush=True)
    return res


# ---------------------------------------------------------------------------
# Phases 32-35: the per-sample kernels (kernel 8, csrc/trace.cu; kernel 7,
# csrc/replay.cu)
# ---------------------------------------------------------------------------

SAMPLE_W, SAMPLE_H, SAMPLE_TR = 160, 120, 16


def _sample_floor(fn, args, kw, ref_L, n_lanes):
    """The plain version on the CPU against itself on the card, on one
    launch's inputs: its lane agreement (the floor of f32 chaos)."""
    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    scene, cp, *rest = args
    kw_cpu = dict(kw, uniforms=None if kw.get("uniforms") is None
                  else kw["uniforms"].cpu())
    rest = [r.cpu() if hasattr(r, "cpu") else r for r in rest]
    cpu = fn(scene.to("cpu"), cp.cpu(), *rest, **kw_cpu)
    return sample_lane_agreement(cpu[0], ref_L, n_lanes)[0]


def _check_trace_launch(label, scene, cp, seed3, kw, w, h, main=None):
    """Kernel 8 against its plain version on the card from the same
    inputs: >= 98% of lanes (or the plain version's CPU-vs-card floor),
    rays within 1%, the sign test on the lanes that differ. ``main``, if
    given, is the (image, rays) the main path's launch returned from these
    inputs, which the replayed launch must equal bit for bit."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk
    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, sample_lane_agreement,
    )

    n = w * h * kw["spp"]
    Lk, nk = tk.trace_lanes(scene, cp, seed3, **kw)
    counts = {}
    Lr, nr = tk.trace_lanes_ref(scene, cp, seed3, counts=counts, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(Lk).all() and torch.isfinite(Lr).all()):
        fail(f"{label}: non-finite radiance")
    if main is not None:
        img = Lk.reshape(-1, 3)[:n].reshape(h, w, kw["spp"], 3).mean(2)
        if not (torch.equal(img, main[0]) and int(nk) == int(main[1])):
            fail(f"{label}: the replayed launch is not the main path's")
    frac, dmax, _ = sample_lane_agreement(Lk, Lr, n)
    floor = None
    if frac < AGREE:
        floor = _sample_floor(tk.trace_lanes_ref, (scene, cp, seed3), kw,
                              Lr, n)
        if frac < floor:
            fail(f"{label}: kernel vs plain agreement {frac} is below both "
                 f"{AGREE} and the plain version's CPU-vs-card floor {floor}")
    rays_k, rays_r = int(nk), int(nr)
    if abs(rays_k - rays_r) > RAY_TOL * max(rays_r, 1):
        fail(f"{label}: rays {rays_k} vs plain {rays_r}")
    sign, n_off = _sign_balance([(Lk.permute(2, 0, 1), Lr.permute(2, 0, 1))],
                                n)
    if sign > 1.0:
        fail(f"{label}: the lanes that differ lean one way, {sign} times "
             f"the bar ({n_off} lanes)")
    return dict(l_agree=frac, floor=floor, max_abs_err=dmax, sign=sign,
                n_off=n_off, rays=(rays_k, rays_r), shadows=counts["shadow"])


def _fmt_sample(c) -> str:
    floor = "" if c["floor"] is None else f" (cpu floor {c['floor']:.4f})"
    return (f"L {c['l_agree']:.4f}{floor} max|dL| {c['max_abs_err']:.3g} "
            f"rays {c['rays'][0]}/{c['rays'][1]} sign balance "
            f"{c['sign']:.3f} of its bar ({c['n_off']} lanes)")


def _worst_sample(checks) -> dict:
    return dict(l_agree=min(c["l_agree"] for c in checks),
                max_abs_err=max(c["max_abs_err"] for c in checks),
                sign_balance=max(c["sign"] for c in checks),
                floor=min((c["floor"] for c in checks
                           if c["floor"] is not None), default=None))


def phase_trace_compare():
    """32: kernel 8 against trace_lanes_ref on the card at 160x120, spp 4,
    10 bounces: cornell_spheres brute force and NEE, the point-light scene
    with NEE, each on injected uniforms and on Philox; phase 3's bars."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    w, h, tr = SAMPLE_W, SAMPLE_H, SAMPLE_TR
    gen = torch.Generator(device="cuda").manual_seed(3232)
    rows, _ = tk.lanes_layout(w, h, SPP, tr)
    parts, checks = [], []
    for name, build, use_nee in (("cornell", _cornell, False),
                                 ("cornell", _cornell, True),
                                 ("point", _point, True)):
        scene, _, cp = build(w, h, "cuda")
        for injected in (True, False):
            u = (torch.rand((rows * tk.sample_n_draws(MB, use_nee), 128),
                            generator=gen, device="cuda")
                 if injected else None)
            kw = dict(spp=SPP, width=w, height=h, max_bounces=MB,
                      rr_start=3, tile_rows=tr, use_nee=use_nee, uniforms=u)
            case = (f"{name}-{'nee' if use_nee else 'brute'}-"
                    f"{'injected' if injected else 'philox'}")
            c = _check_trace_launch(case, scene, cp, (5, 1, 2), kw, w, h)
            checks.append(c)
            parts.append(f"{case}: {_fmt_sample(c)}")
    print(f"[32 trace kernel vs plain] {w}x{h} spp {SPP}, {MB} bounces: "
          + " | ".join(parts), flush=True)
    return _worst_sample(checks)


def _pallas_tpu_tests():
    """The TPU-only tests of tests/test_pallas_kernel.py, on the card,
    against the port's wavefront (models/integrator.py::render_image):
    mean ratios, determinism, iteration decorrelation, tile-size invariance
    and the point light. Returns the printed numbers."""
    import torch

    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import (
        RenderConfig, render_image,
    )
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import (
        pack_camera, pallas_render,
    )

    def cam_of(cs, w, h):
        return cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                              cs["fov"], device="cuda")

    out = {}
    # test_matches_xla_integrator_in_distribution: cornell 64x48, 15 its
    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cam_of(cs, 64, 48)
    acc_p = acc_x = 0.0
    for it in range(15):
        ip, _ = pallas_render(scene, pack_camera(cam), (0, it, 7), spp=4,
                              width=64, height=48, max_bounces=10)
        acc_p += float(ip.mean())
        acc_x += float(render_image(scene, cam, 0,
                                    RenderConfig(spp=4, max_bounces=10),
                                    iteration=it).mean())
    out["brute_ratio"] = acc_p / acc_x
    if not abs(out["brute_ratio"] - 1.0) < 0.03:
        fail(f"pallas_render vs the wavefront: mean ratio "
             f"{out['brute_ratio']} (bar 3%)")
    # test_deterministic_and_iteration_decorrelated: single sphere 32x32
    s1, cs1 = sc.single_sphere(device="cuda")
    cp1 = pack_camera(cam_of(cs1, 32, 32))
    kw = dict(spp=4, width=32, height=32, max_bounces=3)
    a, na = pallas_render(s1, cp1, (0, 0, 7), **kw)
    b, _ = pallas_render(s1, cp1, (0, 0, 7), **kw)
    c, _ = pallas_render(s1, cp1, (0, 1, 7), **kw)
    if not (torch.equal(a, b) and not torch.equal(a, c)
            and int(na) >= 32 * 32 * 4):
        fail("pallas_render: not deterministic, not decorrelated across "
             "iterations, or fewer rays than primaries")
    # test_tile_size_invariance: cornell 64x48, tile_rows 8 and 32
    means = []
    for rows in (8, 32):
        acc = 0.0
        for it in range(10):
            img, _ = pallas_render(scene, pack_camera(cam), (0, it, 7),
                                   spp=4, width=64, height=48,
                                   max_bounces=10, tile_rows=rows)
            acc += float(img.mean())
        means.append(acc / 10)
    out["tile_ratio"] = means[0] / means[1]
    if not abs(out["tile_ratio"] - 1.0) < 0.05:
        fail(f"pallas_render: tile_rows 8 vs 32 mean ratio "
             f"{out['tile_ratio']} (bar 5%)")
    # test_nee_kernel_matches_xla_nee: single-sphere and small, 48x36, 30 its
    for name in ("single-sphere", "small"):
        sn, csn = sc.BUILTIN_SCENES[name](device="cuda")
        camn = cam_of(csn, 48, 36)
        acc_p = acc_x = 0.0
        for it in range(30):
            ip, _ = pallas_render(sn, pack_camera(camn), (91, it, 7), spp=4,
                                  width=48, height=36, max_bounces=5,
                                  use_nee=True)
            acc_p += float(ip.mean())
            acc_x += float(render_image(
                sn, camn, 91, RenderConfig(spp=4, max_bounces=5,
                                           use_nee=True),
                iteration=it).mean())
        out[f"nee_ratio_{name}"] = acc_p / acc_x
        if not abs(acc_p / acc_x - 1.0) < 0.05:
            fail(f"pallas_render NEE vs the wavefront on {name}: mean ratio "
                 f"{acc_p / acc_x} (bar 5%)")
    # test_nee_kernel_point_light
    sp = sc.make_scene([sc.sphere([0, -1e4 - 1, 0], 1e4, 0)],
                       [sc.diffuse([0.7, 0.7, 0.7])],
                       [sc.point_light([0, 3, 0], [40.0, 40.0, 40.0])],
                       device="cuda")
    camp = cm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], 32, 32, 60.0,
                          device="cuda")
    img, _ = pallas_render(sp, pack_camera(camp), (17, 0, 7), spp=4,
                           width=32, height=32, max_bounces=3, use_nee=True)
    out["point_max"] = float(img.max())
    if not out["point_max"] > 0.1:
        fail(f"pallas_render: the point light is not seen ({out})")
    return out


def phase_trace_main():
    """33: the pallas_render main path on cornell_spheres at 640x480, spp
    4, 10 bounces, brute force then NEE, two frames each (iterations 0 and
    1): finite images, launches counted; each launch replayed from its own
    inputs, bit for bit, and held to the plain version on the card by phase
    32's bars. Then the JAX suite's TPU-only tests of the kernel against
    the port's wavefront (``_pallas_tpu_tests``)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    scene, _, cp = _cornell(W, H, "cuda")
    kw = dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=3,
              tile_rows=SAMPLE_TR)
    frames = {}
    tk.launches = 0
    for use_nee in (False, True):
        for it in range(2):
            frames[(use_nee, it)] = tk.pallas_render(
                scene, cp, (17, it, 0), use_nee=use_nee, **kw)
    torch.cuda.synchronize()
    launches = tk.launches
    if launches != len(frames):
        fail(f"trace main path: {launches} kernel launches for "
             f"{len(frames)} frames")
    parts, checks = [], []
    for (use_nee, it), (img, rays) in frames.items():
        mode = "nee" if use_nee else "brute"
        if tuple(img.shape) != (H, W, 3) or not torch.isfinite(img).all():
            fail(f"trace main path ({mode}, iteration {it}): bad image")
        c = _check_trace_launch(f"trace main path ({mode}, iteration {it})",
                                scene, cp, (17, it, 0),
                                dict(kw, use_nee=use_nee), W, H,
                                main=(img, rays))
        checks.append(c)
        parts.append(f"{mode} iteration {it}: mean {float(img.mean()):.5f}, "
                     f"{int(rays)} rays; vs plain {_fmt_sample(c)}")
    tpu = _pallas_tpu_tests()
    print(f"[33 trace main path] cornell {W}x{H} spp {SPP}, {MB} bounces: "
          f"{launches} launches; " + " | ".join(parts)
          + f"; the JAX suite's TPU-only tests against the wavefront: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in tpu.items())}", flush=True)
    return launches, _worst_sample(checks), tpu


def _pixels_agree(k_L, r_L, spp, n_lanes):
    """(rows, 128) mask, float: 1 on the lanes of the pixels whose every
    lane agrees (``sample_lane_agreement``'s bar), else 0."""
    import torch

    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    ok = sample_lane_agreement(k_L, r_L, n_lanes)[2]
    return ok.reshape(-1, spp).all(-1).repeat_interleave(spp).reshape(
        ok.shape).to(device=k_L.device, dtype=torch.float32)


def _mse_of(L, tgt, spp, w, h, keep=None):
    """MSE of the pixel means of (rows, 128, 3) lanes against the broadcast
    target, in float64, over the lanes of ``keep`` (all by default)."""
    n = w * h * spp
    img = L.double().reshape(-1, 3)[:n].reshape(-1, spp, 3).mean(1)
    t = tgt.double().reshape(-1, 3)[:n:spp]
    d = (img - t) ** 2
    if keep is not None:
        d = d * keep.reshape(-1)[:n:spp, None].double()
    return float(d.sum() / (w * h * 3))


def _check_replay_launch(label, scene, cp, seed, it, tgt, kw, w, h,
                         main_loss=None):
    """Kernel 7 against its plain version on the card from the same inputs,
    in both modes: mode "mse" lane for lane (>= 98% or the CPU floor, rays
    within 1%, the sign test); its loss against the MSE of its own lanes
    and its gradients against mode "vjp" fed its own lanes' cotangent
    (rtol FOLD_RTOL: the fold of phase 7); then mode "vjp" on both sides
    with the plain lanes' cotangent zeroed on the pixels whose lanes
    disagree (gradients rtol GRAD_RTOL) and the loss over those pixels
    (rtol LOSS_RTOL). ``main_loss``, if given, is the loss the main path's
    launch returned from these inputs, which the replay must equal bit for
    bit."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, sample_lane_agreement,
    )

    spp = kw["spp"]
    n = w * h * spp
    args = (scene, cp, seed, it)
    k = rk.replay_call(*args, tgt, mode="mse", **kw)
    counts = {}
    r = rk.replay_call_ref(*args, tgt, mode="mse", counts=counts, **kw)
    torch.cuda.synchronize()
    if main_loss is not None and not torch.equal(k[1], main_loss):
        fail(f"{label}: the replayed launch's loss {float(k[1])} is not the "
             f"main path's {float(main_loss)}")
    if not all(bool(torch.isfinite(x).all()) for x in (*k[:4], *r[:4])):
        fail(f"{label}: non-finite outputs")
    frac, dmax, _ = sample_lane_agreement(k[0], r[0], n)
    floor = None
    if frac < AGREE:
        floor = _sample_floor(rk.replay_call_ref, (*args, tgt),
                              dict(kw, mode="mse"), r[0], n)
        if frac < floor:
            fail(f"{label}: kernel vs plain agreement {frac} is below both "
                 f"{AGREE} and the plain version's CPU-vs-card floor {floor}")
    rays_k, rays_r = int(k[4]), int(r[4])
    if abs(rays_k - rays_r) > RAY_TOL * max(rays_r, 1):
        fail(f"{label}: rays {rays_k} vs plain {rays_r}")
    # the fold: mode "mse" is mode "vjp" on its own lanes' cotangent
    scale = float(k[2].abs().max())
    g_own = rk.lane_cotangent(k[0], tgt, spp, w, h)
    kv = rk.replay_call(*args, g_own, mode="vjp", **kw)
    if not (_close(k[1], k[1].new_tensor(_mse_of(k[0], tgt, spp, w, h)),
                   FOLD_RTOL)
            and _close(k[2], kv[2], FOLD_RTOL, 1e-6 * scale)
            and _close(k[3], kv[3], FOLD_RTOL, 1e-6 * scale)):
        fail(f"{label}: mode mse {k[1:4]} is not the fold of its lanes "
             f"{kv[1:4]}")
    # kernel against plain over the agreeing pixels
    keep = _pixels_agree(k[0], r[0], spp, n)
    g = rk.lane_cotangent(r[0], tgt, spp, w, h) * keep[..., None]
    km = rk.replay_call(*args, g.contiguous(), mode="vjp", **kw)
    rm = rk.replay_call_ref(*args, g.contiguous(), mode="vjp", **kw)
    loss_k = _mse_of(k[0], tgt, spp, w, h, keep)
    loss_r = _mse_of(r[0], tgt, spp, w, h, keep)
    if not (abs(loss_k - loss_r) <= LOSS_RTOL * abs(loss_r)
            and _close(km[2], rm[2], GRAD_RTOL, 1e-6 * scale)
            and _close(km[3], rm[3], GRAD_RTOL, 1e-6 * scale)):
        fail(f"{label}: over the agreeing pixels, loss {loss_k} vs plain "
             f"{loss_r}, gradients {km[2:4]} vs plain {rm[2:4]}")
    sign, n_off = _sign_balance([(k[0].permute(2, 0, 1),
                                  r[0].permute(2, 0, 1))], n)
    if sign > 1.0:
        fail(f"{label}: the lanes that differ lean one way, {sign} times the "
             f"bar ({n_off} lanes)")
    loss_gap = abs(float(k[1]) - float(r[1])) / max(abs(float(r[1])), 1e-30)
    grad_gap = float((k[2] - r[2]).abs().max()
                     / r[2].abs().max().clamp_min(1e-30))
    return dict(l_agree=frac, floor=floor, max_abs_err=dmax, sign=sign,
                n_off=n_off, rays=(rays_k, rays_r),
                pixels=float(keep.reshape(-1)[:n].mean()), loss=float(k[1]),
                loss_gap=loss_gap, grad_gap=grad_gap,
                shadows=counts["shadow"])


def _fmt_replay(c) -> str:
    return (f"{_fmt_sample(c)}; agreeing pixels {c['pixels']:.4f}; whole "
            f"image, relative gaps: loss {c['loss_gap']:.3g}, gradient "
            f"{c['grad_gap']:.3g}")


REPLAY_CASES = [
    # (spp, use_nee, lens, injected): the warp path (spp <= 32) and the
    # shared-memory path (spp 64)
    (4, False, False, True), (4, True, False, True), (4, True, False, False),
    (4, False, True, True), (4, True, True, False), (1, True, False, False),
    (16, False, False, True), (64, True, False, False),
]


def phase_replay_compare():
    """34: kernel 7 against replay_call_ref on the card at 160x120, 10
    bounces (``_check_replay_launch``: modes "mse" and "vjp"), brute force
    and NEE, with and without the lens, spp 1, 4, 16 and 64, injected and
    Philox."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    w, h, tr = SAMPLE_W, SAMPLE_H, SAMPLE_TR
    gen = torch.Generator(device="cuda").manual_seed(3434)
    target = torch.rand((h, w, 3), generator=gen, device="cuda")
    parts, checks = [], []
    for spp, use_nee, lens, injected in REPLAY_CASES:
        scene, _, cp = _scene("cornell", w, h, "cuda", LENS if lens else None)
        rows, _ = rk.lanes_layout(w, h, spp, tr)
        u = (torch.rand((rows * tk.sample_n_draws(MB, use_nee, lens), 128),
                        generator=gen, device="cuda") if injected else None)
        kw = dict(spp=spp, width=w, height=h, max_bounces=MB, rr_start=3,
                  tile_rows=tr, use_nee=use_nee, use_dof=lens, uniforms=u)
        case = (f"spp{spp}-{'nee' if use_nee else 'brute'}"
                f"{'-lens' if lens else ''}-"
                f"{'injected' if injected else 'philox'}")
        c = _check_replay_launch(
            case, scene, cp, (5, 2), 3,
            rk.broadcast_pixels_to_lanes(target, spp, rows), kw, w, h)
        checks.append(c)
        parts.append(f"{case}: {_fmt_replay(c)}")
    print(f"[34 replay kernel vs plain] {w}x{h}, {MB} bounces: "
          + " | ".join(parts), flush=True)
    print(f"[34 replay kernel build] {_replay_sample_build()}", flush=True)
    return _worst_sample(checks)


# (slots, lights, spp) of kernel 7's scenes: cornell_spheres at spp 4 and
# 64, limit_spheres (16 slots, 16 lights: the largest block) at spp 128
SAMPLE_OCCUPANCY = ((5, 1, 4), (5, 1, 64), (16, 16, 128))


def _replay_sample_build() -> str:
    """Kernel 7's ptxas line per build (registers, stack, spills) and its
    dynamic shared memory per block with the blocks per SM that it and the
    registers allow (the card's occupancy calculator)."""
    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk

    report = _build.ptxas_report(
        _build.library_path().with_suffix(".log").read_text())
    parts = [f"{k}: {v.get('regs')} regs, {v.get('stack')} B stack, "
             f"{v.get('spill_st')}/{v.get('spill_ld')} B spill st/ld"
             for k, v in report.items() if k.startswith("replay_kernel")]
    for dof in (False, True):
        cells = []
        for n_slots, n_l, spp in SAMPLE_OCCUPANCY:
            nbytes, blocks = rk.sample_blocks_per_sm(n_slots, n_l, spp,
                                                     dof=dof)
            cells.append(f"{n_slots}/{n_l} spp {spp}: {nbytes} B, {blocks}")
        parts.append(f"{'lens' if dof else 'pinhole'} slots/lights: shared "
                     f"memory per block, blocks per SM: " + ", ".join(cells))
    return " | ".join(parts)


def phase_sample_trainer(steps=5):
    """35: the engine="sample" trainer at BASELINE config 5 (cornell
    640x480, spp 4, 10 bounces, strat_k 2), brute force then NEE: the
    target from render_target_kernel(engine="sample"), then ``steps``
    same-seed Adam steps from phase 8's perturbed parameters; the loss
    falls, 1 + steps launches of kernel 7 and none of another kernel; the
    last launch replayed bit for bit and held to the plain version by
    phase 34's checks."""
    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    scene, cam, cp = _cornell(W, H, "cuda")
    rows, _ = rk.lanes_layout(W, H, SPP, SAMPLE_TR)
    seed, mat = (17, 0), 3
    parts, launches, checks = [], {}, []
    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        config = RenderConfig(spp=SPP, max_bounces=MB, rr_start=3,
                              use_nee=use_nee)
        p0 = inverse.params_of(scene)
        p0["mat_color"][mat] = 0.3
        p0["light_intensity"] *= 0.5
        state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
        step = inverse.make_kernel_train_step(scene, cam, config,
                                              fixed_iteration=0,
                                              engine="sample")
        pk.launches = rp.launches = rk.launches = tk.launches = 0
        target = inverse.render_target_kernel(scene, cam, seed, config,
                                              engine="sample")
        losses = []
        for _ in range(steps):
            last = {k: v.detach().clone() for k, v in state.params.items()}
            state, loss = step(state, target, seed)
            losses.append(loss)
        torch.cuda.synchronize()
        launches[mode] = rk.launches
        if rk.launches != 1 + steps or pk.launches or rp.launches \
                or tk.launches:
            fail(f"sample trainer ({mode}): {rk.launches} launches of kernel "
                 f"7 and {pk.launches + rp.launches + tk.launches} of others "
                 f"for 1 target and {steps} steps")
        vals = [float(x) for x in losses]
        if tuple(target.shape) != (W * H, 3) or not (
                bool(torch.isfinite(target).all())
                and all(map(math.isfinite, vals))
                and all(bool(torch.isfinite(v.detach()).all())
                        for v in state.params.values())):
            fail(f"sample trainer ({mode}): non-finite or misshapen results")
        if not vals[-1] < vals[0]:
            fail(f"sample trainer ({mode}): loss {vals[0]} -> {vals[-1]} did "
                 "not fall")
        c = _check_replay_launch(
            f"sample trainer ({mode}) last launch",
            inverse.apply_params(scene, last), cp, seed, 0,
            rk.broadcast_pixels_to_lanes(target.reshape(H, W, 3), SPP, rows),
            dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=3,
                 tile_rows=SAMPLE_TR, use_nee=use_nee, use_dof=False), W, H,
            main_loss=losses[-1])
        checks.append(c)
        alb = state.params["mat_color"][mat].detach().cpu().tolist()
        parts.append(
            f"{mode}: loss {' '.join(f'{v:.6g}' for v in vals)}; albedo "
            f"{mat} {[round(a, 4) for a in alb]} (true "
            f"{[round(a, 4) for a in scene.mat_color[mat].tolist()]}); "
            f"launches {launches[mode]} = 1 + {steps}; last launch vs plain: "
            f"{_fmt_replay(c)}")
    print(f"[35 sample trainer main path] cornell {W}x{H} spp {SPP}, {MB} "
          f"bounces, strat_k 2, lr {LR}: " + " | ".join(parts), flush=True)
    return launches, _worst_sample(checks)


def _trace_ms(profiled) -> float:
    """Kernel 8's device ms per call from a ``_profile`` of one launch per
    call: the kernel and the zeroing of its counters (the item fetch's and
    the ray count's), a device op that every call makes before the
    launch."""
    kernel_ms, _, _, by_name = profiled
    return kernel_ms + sum(v for n, v in by_name.items()
                           if "FillFunctor" in n or "Memset" in n)


def _sample_bound(scene, segments, paths, shadows, shadow_prims, lanes,
                  nbytes, adjoint=None, lens=False):
    """Bound of a per-sample launch from this run's work: per segment the
    closest hit over every prim and the shading (OPS "quadratic",
    "segment"), per path its camera ray ("path", and "lens" with the thin
    lens), per NEE sample the light sample ("shadow") and per sphere its
    sweep tests ("shadow_prim", ``shadow_prims`` in all: kernel 8 tests
    every prim, kernel 7 every prim but the sampled light sphere); with
    ``adjoint`` = (slots, lights), the adjoint per segment and the
    cotangent per lane ("adjoint_segment", "adjoint_flush_slot",
    "adjoint_flush_light")."""
    p = int(scene.num_prims)
    ops = (segments * (OPS["quadratic"] * p + OPS["segment"])
           + paths * (OPS["path"] + (OPS["lens"] if lens else 0))
           + shadows * OPS["shadow"] + shadow_prims * OPS["shadow_prim"])
    if adjoint is not None:
        ops += (segments * OPS["adjoint_segment"]
                + lanes * (OPS["adjoint_flush_slot"] * adjoint[0]
                           + OPS["adjoint_flush_light"] * adjoint[1]))
    return _bound(ops, nbytes)


def phase_sample_times(smi):
    """35 times, by phase 6's and 10's protocol: kernel 8 (pallas_render
    at 640x480, spp 4, 10 bounces) and kernel 7 (mse_value_and_grad at
    config 5), brute force and NEE: ms per call by the CUDA-event slope
    (median of REPS), the kernel's device ms per launch (kernel 8's with
    the zeroing of its counters, ``_trace_ms``) and the device's idle
    share from one torch.profiler trace of 10 calls, the bound from
    this run's work (the plain version's counts on the same seed) and the
    plain version's ms."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    scene, cam, cp = _cornell(W, H, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(35)
    target = torch.rand((H, W, 3), generator=gen, device="cuda")
    rows, n = tk.lanes_layout(W, H, SPP, SAMPLE_TR)
    lanes = rows * 128
    n_slots = len(rk.material_slots(scene)[0])
    n_l = len(scene.light_structure)
    aux = rk.broadcast_pixels_to_lanes(target, SPP, rows)
    out = {}
    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        kw8 = dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=3,
                   tile_rows=SAMPLE_TR, use_nee=use_nee)
        kw7 = dict(spp=SPP, max_bounces=MB, rr_start=3, tile_rows=SAMPLE_TR,
                   use_nee=use_nee)
        o8, o7 = {}, {}
        o8["call_ms"], o8["reps"] = _slope_ms(
            lambda salt, i: tk.pallas_render(scene, cp, (salt, i, 0), **kw8))
        o7["call_ms"], o7["reps"] = _slope_ms(
            lambda salt, i: rk.mse_value_and_grad(scene, cam, (salt, i), 0,
                                                  target, **kw7))
        # the plain versions: their ms and this run's work on seed 300
        c8, c7 = {}, {}
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        a.record()
        _, rays_r = tk.trace_lanes_ref(scene, cp, (300, 0, 0), counts=c8,
                                       **kw8)
        b.record()
        out7 = rk.replay_call_ref(scene, cp, (300, 0), 0, aux, width=W,
                                  height=H, counts=c7, **kw7)
        c.record()
        torch.cuda.synchronize()
        o8["plain_ms"], o7["plain_ms"] = a.elapsed_time(b), b.elapsed_time(c)
        _, rays_k = tk.trace_lanes(scene, cp, (300, 0, 0), **kw8)
        segs7 = int(rk.replay_call(scene, cp, (300, 0), 0, aux, width=W,
                                   height=H, **kw7)[4])
        o8["bound_ms"], o8["bound_by"] = _sample_bound(
            scene, int(rays_k), n, int(c8["shadow"]),
            int(c8["shadow"]) * int(scene.num_prims), lanes,
            lanes * 12 + 8)
        k_part = 3 * n_slots + 3 * n_l + 1
        o7["bound_ms"], o7["bound_by"] = _sample_bound(
            scene, segs7, n, int(c7["shadow"]), int(c7["shadow_prims"]),
            lanes, lanes * 24 + rows * (4 * k_part + 4),
            adjoint=(n_slots, n_l))
        o8["work"] = (int(rays_k), n, int(c8["shadow"]))
        o8["live"] = _trace_live(c8, tk._trace_grid(0) * 128)
        o7["work"] = (segs7, n, int(c7["shadow"]))
        del out7, rays_r
        for o, name, run in (
                (o8, "trace_kernel",
                 lambda i: tk.pallas_render(scene, cp, (400, i, 0), **kw8)),
                (o7, "replay_kernel",
                 lambda i: rk.mse_value_and_grad(scene, cam, (400, i), 0,
                                                 target, **kw7))):
            profiled = _profile(run, 10, name, f"{name}_{mode}")
            o["kernel_ms"], busy, window, _ = profiled
            if name == "trace_kernel":
                o["kernel_ms"] = _trace_ms(profiled)
            o["idle_share"] = 1.0 - busy / window
            o["busy_ms"], o["window_ms"] = busy, window
            if o["idle_share"] < 0.0:
                fail(f"{name} {mode}: device busy {busy} ms exceeds the "
                     f"window's {window} ms")
        out[mode] = {"trace": o8, "replay": o7}
    parts = []
    for mode, d in out.items():
        for name, o in d.items():
            parts.append(
                f"{name} {mode}: {o['call_ms']:.4f} ms per call (median of "
                f"{REPS}; {', '.join(f'{v:.4f}' for v in o['reps'])}); "
                f"kernel {o['kernel_ms']:.4f} ms/launch, bound "
                f"{o['bound_ms']:.5f} ms by {o['bound_by']} ({o['work'][0]} "
                f"segments, {o['work'][1]} paths, {o['work'][2]} shadow "
                f"sweeps); profiled window {o['window_ms']:.4f} ms, device "
                f"busy {o['busy_ms']:.4f} ms, idle share "
                f"{o['idle_share']:.3f}; plain {o['plain_ms']:.2f} ms")
    print(f"[35 sample times] cornell {W}x{H} spp {SPP}, {MB} bounces, "
          f"tile_rows {SAMPLE_TR} on {smi}: " + " | ".join(parts), flush=True)
    print(f"[35 trace live share] cornell {W}x{H} spp {SPP}, {MB} bounces "
          f"on {smi}: " + " | ".join(
              _fmt_trace_live(mode, d["trace"]["live"])
              for mode, d in out.items()), flush=True)
    return out


AB_FORWARD = [("cornell", False), ("cornell", True), ("cornell-boxes", False),
              ("cornell-boxes", True), ("cornell-quad", False),
              ("cornell-quad", True), ("terrain32", False),
              ("terrain32", True)]
# kernel 3's workloads (name, NEE, lens): every output compared bit for bit,
# the atlas gradient within the atomic bound
AB_GRADIENT = [("cornell", False, False), ("cornell", True, False),
               ("cornell", False, True), ("cornell", True, True),
               ("cornell-boxes", True, False), ("cornell-quad", True, False),
               ("terrain32", True, False)]


# the window and the reps of --ab's end-to-end rows (``_slope_ms``): a
# longer window than the phases' 24 calls, so that a stall in the one-call
# run moves the slope less, and more reps for the median
AB_WALL = (96, 9)

# the parts of ab_worker, each named by --ab-only
AB_PARTS = ("forward", "gradient", "tangent", "config4", "sample", "trace",
            "packet", "frame")


def _digest(tensors, zero_sign=False) -> str:
    """A short sha256 of the tensors' bytes; ``zero_sign`` maps -0 to +0
    in float tensors first (x + 0)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach()
        if zero_sign and t.is_floating_point():
            t = t + 0.0
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _ab_gradient_key(name, nee, lens) -> str:
    return (f"gradient {name}{' lens' if lens else ''} "
            f"{'nee' if nee else 'brute'}")


def _ab_packet(waves_path, answers_out=None) -> dict:
    """Kernels 5 and 6 in this process's checkout on config 4's wave
    queries of one frame (the textured terrain, two-pass), recorded once by
    the first worker to ``waves_path`` and read by every worker, so that
    each checkout answers the same rays through its own
    ``intersect_mesh_packet``. Device ms per launch of the closest-hit and
    the shadow waves and the frame's glue (every other device op of the
    queries: sort, selects) from one torch.profiler trace per kind; kernel
    5's ms on the bounce-1 closest-hit wave unsorted, sorted by
    packet_sort_key, and two-pass; a digest of every wave's answers, saved
    to ``answers_out``; the bound of a mean wave as phase 21 counts it; and
    kernel 6 on every wave (``_ab_bin``)."""
    import torch

    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, cs = sc.terrain_textured(device="cuda")
    scene = sc.with_packet_mesh(scene)
    if not Path(waves_path).is_file():
        cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], C4_W, C4_H,
                             cs["fov"], device="cuda")
        torch.save([(o.cpu(), d.cpu(), t0.cpu(), a) for o, d, t0, a in
                    _record_waves(scene, cam, _c4_config())], waves_path)
    waves = [(o.cuda(), d.cuda(), t0.cuda(), a)
             for o, d, t0, a in torch.load(waves_path)]
    pm, coarse, bvh = (scene.mesh_packed, scene.mesh_packed_coarse,
                       scene.mesh_bvh)

    def query(i, **over):
        o, d, t0, a = waves[i]
        kw = dict(t_init=t0, any_hit=a, coarse=coarse, bvh=bvh)
        kw.update(over)
        return mk.intersect_mesh_packet(pm, o, d, 3e-2, **kw)

    ms, glue, total = {}, 0.0, 0.0
    for kind, any_hit in (("closest", False), ("shadow", True)):
        idx = [i for i, w in enumerate(waves) if w[3] == any_hit]
        k_ms, _, _, by_name = _profile(lambda j, idx=idx: query(idx[j]),
                                       len(idx), "packet_kernel",
                                       f"ab_packet_{kind}")
        ms[f"kernel 5 {kind} waves"] = k_ms
        total += k_ms * len(idx)
        glue += len(idx) * sum(v for name, v in by_name.items()
                               if "packet_kernel" not in name
                               and "bin_kernel" not in name)
    ms["kernel 5 mean wave"] = total / len(waves)
    ms["kernel 5 glue per frame"] = glue
    for label, over in (("unsorted", dict(sort=False, coarse=None)),
                        ("sorted by packet_sort_key", dict(coarse=None)),
                        ("two-pass", {})):
        ms[f"kernel 5 bounce-1 closest wave {label}"] = _profile(
            lambda j, over=over: query(2, **over), 5, "packet_kernel",
            "ab_packet_order")[0]
    answers = [query(i) for i in range(len(waves))]
    fields = ("t", "tri", "n", "uv", "mat")
    digests = [_digest([getattr(h, f) for f in fields]) for h in answers]
    if answers_out:
        torch.save([[getattr(h, f).cpu() for f in fields] for h in answers],
                   answers_out)
    with _Recorder("packet_query") as pq:
        for i in range(len(waves)):
            query(i)
    live = boxes = tris = found = nbytes = 0
    for args, kw, _ in pq.calls:
        c = {}
        mk.packet_bvh_ref(kw["bvh"], *args[1:], counts=c)
        live += int((args[3] > 0).sum())
        boxes, tris = boxes + c.get("boxes", 0), tris + c.get("tris", 0)
        found += c.get("found", 0)
        nbytes += (_packet_io_bytes(args[3], args[5], kw["perm"])
                   + _packet_tree_bytes(kw["bvh"]))
    n = len(pq.calls)
    bound = _bound_of(*_packet_bound(live / n, boxes / n, tris / n,
                                     found / n, nbytes / n))
    b_ms, b_digests = _ab_bin(coarse, waves)
    ms.update(b_ms)
    return dict(ms=ms, digests=digests, bound=bound, bin_digests=b_digests)


def _ab_bin(coarse, waves) -> tuple[dict, list]:
    """Kernel 6 in this process's checkout on every recorded config-4
    wave: device ms per launch over the frame's 8 waves (one profiler
    trace) and a digest per wave of (cell, tn, key)."""
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    def run(i):
        o, d, t0, _ = waves[i]
        return mk.bin_rays(coarse, o, d, t0, 3e-2)

    ms = {"kernel 6 wave": _profile(run, len(waves), "bin_kernel",
                                    "ab_bin")[0]}
    return ms, [_digest(run(i)) for i in range(len(waves))]


# kernel 7's workloads (spp, NEE, lens, mode), 640x480, 10 bounces, Philox
AB_SAMPLE = [(4, False, False, "mse"), (4, True, False, "mse"),
             (4, False, False, "vjp"), (4, True, False, "vjp"),
             (4, False, True, "mse"), (4, True, True, "mse"),
             (64, False, False, "mse"), (64, True, False, "mse")]


def _ab_sample(only=AB_PARTS, trace_out=None) -> tuple[dict, dict]:
    """Kernels 7 and 8 in this process's checkout on cornell_spheres at
    640x480, 10 bounces, tile_rows 16: device ms per launch of kernel 7
    (one profiler trace of 10 launches) on ``AB_SAMPLE``'s workloads, with
    a digest (-0 as +0) of one launch's radiance planes, loss, raw
    gradients (the row partials' sum, as the wrapper makes it) and ray
    count at fixed seeds; mode "vjp" takes the lane cotangent of the "mse"
    launch's radiance. Then kernels 8 and 7 at spp 4 on one injected
    uniform block each for brute force and NEE, the same draws for both:
    their gap is the adjoint's cost, and kernel 8 on Philox draws (the
    main path's), brute force and NEE; each kernel-8 row has a digest of
    one launch's radiance planes and ray count. Last, phase 35's
    end to end (pallas_render and mse_value_and_grad at config 5, brute
    force and NEE): wall ms per call by the CUDA-event slope over
    ``AB_WALL``, host work included. Kernel 7's rows and the end-to-end
    gradient are the part "sample" of ``only``, kernel 8's and
    pallas_render's the part "trace"; kernel 8's digested outputs are
    saved to ``trace_out`` (for ``_ab_trace_report``)."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk

    scene, cam, cps = _cornell(W, H, "cuda")
    cps = {False: cps, True: _scene("cornell", W, H, "cuda", LENS)[2]}
    gen = torch.Generator(device="cuda").manual_seed(13)
    target = torch.rand((H, W, 3), generator=gen, device="cuda")
    ms, digests, traced = {}, {}, {}
    sample = "sample" in only
    for spp, nee, lens, mode in AB_SAMPLE if sample else ():
        rows, _ = rk.lanes_layout(W, H, spp, SAMPLE_TR)
        aux = rk.broadcast_pixels_to_lanes(target, spp, rows)
        kw = dict(spp=spp, width=W, height=H, max_bounces=MB, rr_start=3,
                  tile_rows=SAMPLE_TR, use_nee=nee, use_dof=lens)
        cp = cps[lens]
        if mode == "vjp":
            L = rk.replay_call(scene, cp, (600, 0), 0, aux, **kw)[0]
            aux = rk.lane_cotangent(L, aux, spp, W, H)
        key = (f"kernel 7 {mode} {'nee' if nee else 'brute'}"
               f"{' lens' if lens else ''} spp {spp}")
        digests[key] = _digest(
            rk.replay_call(scene, cp, (600, 0), 0, aux, mode=mode, **kw),
            zero_sign=True)
        ms[key] = _profile(
            lambda i, cp=cp, aux=aux, kw=kw, mode=mode: rk.replay_call(
                scene, cp, (400, i), 0, aux, mode=mode, **kw),
            10, "replay_kernel", "ab_sample")[0]
        del aux
    rows, _ = rk.lanes_layout(W, H, SPP, SAMPLE_TR)
    aux = rk.broadcast_pixels_to_lanes(target, SPP, rows)
    for nee in (False, True):
        u = torch.rand((rows * tk.sample_n_draws(MB, nee, False), 128),
                       generator=gen, device="cuda")
        kw = dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=3,
                  tile_rows=SAMPLE_TR, use_nee=nee, uniforms=u)
        mode = "nee" if nee else "brute"
        for draws, kw8 in (("injected", kw), ("philox", dict(
                kw, uniforms=None))) if "trace" in only else ():
            key = f"kernel 8 {draws} {mode}"
            L, rays = tk.trace_lanes(scene, cps[False], (600, 0, 0), **kw8)
            digests[key] = _digest([L, torch.tensor(int(rays))])
            traced[key] = (L.cpu(), int(rays))
            ms[key] = _trace_ms(_profile(
                lambda i, kw8=kw8: tk.trace_lanes(scene, cps[False],
                                                  (400, i, 0), **kw8),
                10, "trace_kernel", "ab_sample"))
        if not sample:
            continue
        key = f"kernel 7 injected {mode}"
        digests[key] = _digest(
            rk.replay_call(scene, cps[False], (600, 0), 0, aux, **kw),
            zero_sign=True)
        ms[key] = _profile(
            lambda i, kw=kw: rk.replay_call(scene, cps[False], (400, i), 0,
                                            aux, **kw),
            10, "replay_kernel", "ab_sample")[0]
    for nee in (False, True):
        mode = "nee" if nee else "brute"
        kw = dict(spp=SPP, max_bounces=MB, rr_start=3, tile_rows=SAMPLE_TR,
                  use_nee=nee)
        if "trace" in only:
            ms[f"pallas_render end to end {mode}, wall"] = _slope_ms(
                lambda salt, i, kw=kw: tk.pallas_render(
                    scene, cps[False], (salt, i, 0), width=W, height=H,
                    **kw), *AB_WALL)[0]
        if sample:
            ms[f"gradient end to end {mode}, wall"] = _slope_ms(
                lambda salt, i, kw=kw: rk.mse_value_and_grad(
                    scene, cam, (salt, i), 0, target, **kw), *AB_WALL)[0]
    if trace_out and traced:
        torch.save(traced, trace_out)
    return ms, digests


# kernel 4's workloads (scene, NEE, tangents) at config 5: phase 16's four
# (the camera position's 3 rows, "pos", or every transmissive material's
# IOR, "ior") and one launch each of 4 (the position and the IOR) and 2
# tangents (the position's x row and the IOR, on a mesh)
AB_TANGENT = [("cornell", False, "pos"), ("cornell", True, "pos"),
              ("cornell-quad", True, "pos"), ("cornell", True, "ior"),
              ("cornell", True, "pos+ior"), ("cornell-glass", True, "x+ior")]


def _ab_tangent(scenes, k) -> tuple[dict, dict]:
    """Kernel 4 in this process's checkout on ``AB_TANGENT``'s workloads:
    device ms per launch of camera_jvp_call (one profiler trace of ``k``
    launches) and a digest of one launch's L, dL, n_samp and ray count at a
    fixed seed; then phase 16's gradients end to end (camera_weighted_grad
    of the position, ior_mse_grad): wall ms per call by the CUDA-event
    slope over ``AB_WALL``, host work included."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    kw = dict(spp=SPP, budget=rp.default_budget(SPP, MB), width=W, height=H,
              max_bounces=MB, rr_start=3, tile_rows=TR)
    rows = _position_rows("cuda")
    ms, digests = {}, {}
    for name, nee, kind in AB_TANGENT:
        scene, cams = scenes[name]
        cp = pack_camera(cams[False])
        dcam = {"pos": rows, "ior": rows[:0], "pos+ior": rows,
                "x+ior": rows[:1]}[kind]
        coef = cj.transmissive_mats(scene) if "ior" in kind else ()
        call = dict(kw, use_nee=nee, coef_mats=coef)
        key = (f"tangent {name} {'nee' if nee else 'brute'} {kind} T "
               f"{dcam.shape[0] + len(coef)}")
        out = cj.camera_jvp_call(scene, cp, dcam, (600, 0), 0, **call)
        digests[key] = _digest([*out[:3], torch.tensor(int(out[3]))])
        ms[key] = _profile(
            lambda i, scene=scene, cp=cp, dcam=dcam, call=call:
            cj.camera_jvp_call(scene, cp, dcam, (400, i), 0, **call),
            k, "camera_jvp_kernel", "ab")[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    weights = torch.rand((H, W, 3), generator=gen, device="cuda")
    kw = {k: v for k, v in kw.items() if k not in ("width", "height")}
    for key, name, nee, kind in JVP_TIMES:
        scene, cams = scenes[name]
        grad = cj.camera_weighted_grad if kind == "pos" else cj.ior_mse_grad
        ms[f"tangent end to end {key}, wall"] = _slope_ms(
            lambda salt, i, scene=scene, cam=cams[False], nee=nee, grad=grad:
            grad(scene, cam, (salt, i), weights, use_nee=nee, **kw),
            *AB_WALL)[0]
    return ms, digests


def _ab_frame():
    """Config 4's wavefront frame as phase 21 times it, two-pass (the main
    path's renderer) and single-pass: wall ms per frame by the CUDA-event
    slope between 1 and 3 frames (median of REPS), and the device busy ms
    and the gather and index ms per frame from one trace of 2 frames
    (``_wavefront_profile``); with a digest of the image after the first
    frame for every row. Returns (ms, digests)."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch import ProgressiveRenderer
    from tpu_pathtracer_torch.models import camera as cm, scene as sc

    scene, cs = sc.terrain_textured(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], C4_W, C4_H,
                         cs["fov"], device="cuda")
    r2 = ProgressiveRenderer(scene, cam, _c4_config(), seed=3, device="cuda")
    r1 = ProgressiveRenderer(
        dataclasses.replace(r2.scene, mesh_packed_coarse=None), cam,
        r2.config, seed=3, device="cuda")
    ms, digests = {}, {}
    for mode, r in (("two-pass", r2), ("single-pass", r1)):
        r.step()
        digest = _digest([r.image()])
        key = f"config 4 frame {mode}"
        ms[f"{key} wall"] = _slope_ms(lambda salt, i: r.step(), 3)[0]
        prof = _wavefront_profile(r, 2, f"ab_{mode}")
        ms[f"{key} device busy"] = prof["busy_ms"]
        ms[f"{key} gather and index"] = prof["gather_ms_per_frame"]
        for k in ("wall", "device busy", "gather and index"):
            digests[f"{key} {k}"] = digest
    del r1, r2
    torch.cuda.empty_cache()
    return ms, digests


def ab_worker(root: str, atlas_out=None, waves=None,
              answers_out=None, only=AB_PARTS, trace_out=None) -> dict:
    """With the package of the checkout ``root``: device ms per launch (one
    ``_profile`` trace of 10 launches) of the forward kernel on phases 6,
    12 and 27's workloads (cornell_spheres, cornell_boxes, cornell_quad and
    the textured terrain32, brute force and NEE, budget 16), of the
    gradient kernel at config 5 on phases 10, 13, 27 and 31's (spheres
    brute force and NEE, with and without the lens, cornell_boxes and
    cornell_quad NEE, terrain32 NEE with the atlas gradient: launch 1 and
    the scatter), of the tangent kernel on phase 16's workloads and at T =
    4 and 2 (``_ab_tangent``) and of config 4's launch through
    PersistentRenderer (phase 26, the terrain at 1024x1024, render_to(2)
    from a reset), all pinhole but the lens rows, and the plain version's
    wall ms per step on cornell_boxes brute force, through the calls that
    every checkout since the texture gradients runs; a digest of the
    outputs (Philox draws, seeds fixed): of each sphere forward workload
    (the state planes after two forward launches from a fresh state), of
    each gradient workload (phase "adjoint": radiance, counts, every GA/GI
    plane, rays and on terrain32 the C_tot records; phase "both": the loss
    and raw gradients; on terrain32 the scatter launch's replayed radiance,
    counts and rays); the terrain32 atlas gradient and the same scatter of
    |g| (its atomic bound) saved to ``atlas_out``; kernels 7 and 8 on
    cornell_spheres and phase 35's end-to-end gradient (``_ab_sample``);
    kernels 5 and 6 on config 4's recorded waves (``_ab_packet``, with
    ``waves`` and ``answers_out``); config 4's wavefront frame
    (``_ab_frame``); and the build log. ``only`` names the
    parts to run (``AB_PARTS``); kernel 8's outputs go to ``trace_out``."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    from tpu_pathtracer_torch import PersistentRenderer
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    if not Path(pk.__file__).resolve().is_relative_to(Path(root).resolve()):
        fail(f"imported {pk.__file__}, not from {root}")
    _build.load_library()
    log = _build.library_path().with_suffix(".log").read_text()
    k = 10
    out, digests, scenes = {}, {}, {}
    names = ([n for n, _ in AB_FORWARD] + [n for n, _, _ in AB_GRADIENT]
             + [n for n, _, _ in AB_TANGENT])
    for name in dict.fromkeys(names):
        scene, cs = (sc.BUILTIN_SCENES[name](device="cuda")
                     if name in sc.BUILTIN_SCENES
                     else EXTRA_SCENES[name]("cuda"))
        cams = {lens: cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W,
                                     H, cs["fov"], device="cuda",
                                     **(LENS if lens else {}))
                for lens in (False, True)}
        scenes[name] = (sc.with_packet_mesh(scene), cams)
    for name, nee in AB_FORWARD if "forward" in only else ():
        scene, cams = scenes[name]
        cp = pack_camera(cams[False])
        st = [None]

        def start(st=st):
            st[0] = pk.init_state(W, H, TR, device="cuda")

        def run(i, scene=scene, cp=cp, nee=nee, st=st):
            st[0], _ = pk.persistent_step(
                scene, cp, (400, i), st[0], budget=16, width=W, height=H,
                max_bounces=MB, rr_start=3, tile_rows=TR, use_nee=nee)

        key = f"forward {name} {'nee' if nee else 'brute'}"
        if name == "cornell":
            start()
            run(0)
            run(1)
            digests[key] = _digest(getattr(st[0], f) for f in pk.STATE_FIELDS)
        out[key] = _profile(run, k, "persistent_kernel", "ab", start)[0]
    if "forward" in only:
        # the plain version's wall ms per step by phase 12's protocol (one
        # warm step, then two), host work and all
        scene, cams = scenes["cornell-boxes"]
        cp = pack_camera(cams[False])
        _time_steps(scene, cp, False, 1, 98, pk.persistent_step_ref)
        out["plain forward cornell-boxes brute, wall"] = _time_steps(
            scene, cp, False, 2, 300, pk.persistent_step_ref)[0] / 2
    gen = torch.Generator(device="cuda").manual_seed(5)
    target = torch.rand((H, W, 3), generator=gen, device="cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    tgt = rp.target_to_lanes(target, rows)
    kw = dict(spp=SPP, budget=rp.default_budget(SPP, MB), max_bounces=MB,
              rr_start=3, tile_rows=TR)
    for name, nee, lens in AB_GRADIENT if "gradient" in only else ():
        scene, cams = scenes[name]
        cam = cams[lens]
        cp = pack_camera(cam)
        key = _ab_gradient_key(name, nee, lens)
        call = dict(kw, width=W, height=H, use_nee=nee, use_dof=lens)
        args = (scene, cp, (500, 0), 0, tgt)
        adj = rp.persistent_replay_call(*args, phase="adjoint", **call)
        both = rp.persistent_replay_call(*args, **call)
        # "both" on terrain32 ends with the atlas gradient (atomics)
        digests[key] = _digest([x for x in adj if x is not None]
                               + list(both[:6]))
        if scene.textured:
            g = rp.lane_cotangent(adj[0], adj[1], tgt, W, H)
            L2, n2, rays2, gT = rp.scatter_walk(*args, g, adj[5], adj[1],
                                                **call)
            s_abs = rp.scatter_walk(*args, g.abs(), adj[5], adj[1],
                                    **call)[3]
            digests[key + " scatter"] = _digest([L2, n2, rays2])
            # the scatter walk replays launch 1 bit for bit (phase 28)
            digests[key + " scatter replays launch 1"] = str(
                torch.equal(L2, adj[0]) and torch.equal(n2, adj[1])
                and int(rays2) == int(adj[4]))
            if atlas_out:
                torch.save({"gT": gT.cpu(), "s_abs": s_abs.cpu()},
                           atlas_out)

        def run(i, scene=scene, cam=cam, nee=nee):
            rp.persistent_mse_value_and_grad(scene, cam, (400, i), 0, target,
                                             use_nee=nee, **kw)

        ms, _, _, by_name = _profile(run, k, "replay_persistent_kernel", "ab")
        out[key] = ms
        if scene.textured:  # the scatter launch: one per call
            out[key + " scatter"] = sum(
                v for n, v in by_name.items() if "replay_scatter_kernel" in n)
    if "tangent" in only:
        tangent_ms, tangent_digests = _ab_tangent(scenes, k)
        out.update(tangent_ms)
        digests.update(tangent_digests)
    if "config4" in only:
        scene, cs = sc.terrain_textured(device="cuda")
        cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], C4_W, C4_H,
                             cs["fov"], device="cuda")
        r = PersistentRenderer(scene, cam, _c4_config(), seed=3,
                               device="cuda")
        r.render_to(C4_SPP)
        out["config 4 launch"] = _profile(lambda i: r.step(), r.state.frame,
                                          "persistent_kernel", "ab",
                                          start=r.reset)[0]
        del r
        torch.cuda.empty_cache()
    if "sample" in only or "trace" in only:
        sample_ms, sample_digests = _ab_sample(only, trace_out)
        out.update(sample_ms)
        digests.update(sample_digests)
        torch.cuda.empty_cache()
    packet = None
    if "packet" in only:
        packet = _ab_packet(waves, answers_out)
        out.update(packet.pop("ms"))
        digests["kernel 6 wave"] = " ".join(packet.pop("bin_digests"))
    if "frame" in only:
        frame_ms, frame_digests = _ab_frame()
        out.update(frame_ms)
        digests.update(frame_digests)
    return dict(ms=out, digests=digests, log=log, packet=packet)


def ab(other: str, only=AB_PARTS) -> int:
    """``ab_worker`` in one process per checkout, in the order other, this,
    this, other (A B B A, so that a drift of the card's clocks over the call
    shows as a gap between the two runs of one checkout). Prints each
    checkout's ptxas registers, stack and spills per build of the
    kernels, each run's device ms per launch, then per workload
    the two runs of each checkout, the change against the other checkout's
    mean, and whether the outputs are equal bit for bit across the four
    runs (the sphere forward workloads, every gradient workload, kernel
    4's and kernel 7's workloads, kernel 8's and kernel 6's waves), the
    terrain32 atlas gradients' largest gap over the atomic bound, kernel
    8's lanes against the other checkout's (``_ab_trace_report``), kernel
    5's checks (``_ab_packet_report``) and kernel 6's walk against its
    sweep (``_ab_bin_report``); exit 1 if outputs differ (kernel 8: if its
    report fails), a gap exceeds the bound or a kernel-5 or kernel-6 check
    fails. ``only`` names the parts of ``ab_worker`` to run."""
    sys.path.insert(0, str(ROOT))
    from tpu_pathtracer_torch.ops.kernels._build import ptxas_report

    import torch

    order = [("other", other), ("this", str(ROOT)), ("this", str(ROOT)),
             ("other", other)]
    runs, logs, digests, atlases, packets = [], {}, {}, [], []
    out_dir = ROOT / "build" / "tpu_pathtracer_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    waves = out_dir / "ab_packet_waves.pt"
    waves.unlink(missing_ok=True)
    for i, (tag, root) in enumerate(order):
        atlas = out_dir / f"ab_atlas_{i}.pt"
        atlas.unlink(missing_ok=True)
        answers = out_dir / f"ab_packet_answers_{i}.pt"
        answers.unlink(missing_ok=True)
        traced = out_dir / f"ab_trace_{i}.pt"
        traced.unlink(missing_ok=True)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--ab-worker",
             str(Path(root).resolve()), "--ab-atlas", str(atlas),
             "--ab-waves", str(waves), "--ab-only", ",".join(only),
             "--ab-trace", str(traced)]
            + (["--ab-answers", str(answers)] if i < 2 else []),
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((tag, got["ms"]))
        logs[tag] = got["log"]
        digests.setdefault(tag, []).append(got["digests"])
        packets.append((tag, got["packet"]))
        if atlas.is_file():
            atlases.append(torch.load(atlas))
        print(f"{tag} ({root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in got["ms"].items()), flush=True)
    # each run's terrain32 atlas gradient against the first run's, over the
    # atomic bound (1 is the bar)
    ratios = [_atomic_ratio(a["gT"], atlases[0]["gT"], atlases[0]["s_abs"])
              for a in atlases]
    for tag, log in logs.items():
        print(f"{tag} ptxas: " + " | ".join(
            f"{k}: {v.get('regs')} regs, {v.get('stack')} B stack, "
            f"{v.get('spill_st')}/{v.get('spill_ld')} B spill st/ld"
            for k, v in ptxas_report(log).items()
            if any(n in k for n in ("persistent", "scatter", "camera_jvp",
                                    "packet", "bin", "trace", "replay"))))
    print("device ms per launch (rows ending in 'wall': wall ms per step or "
          "per call): workload | other (run 1, run 4) | this (run 2, run 3) "
          "| this / other - 1 | outputs equal")
    unequal = 0
    for key in runs[0][1]:
        oth = [r[key] for t, r in runs if t == "other"]
        this = [r[key] for t, r in runs if t == "this"]
        gap = statistics.mean(this) / statistics.mean(oth) - 1.0
        seen = {d[key] for ds in digests.values() for d in ds if key in d}
        same = "-" if not seen else "yes" if len(seen) == 1 else "NO"
        # kernel 8's NEE path may round apart from the other checkout (FMA
        # contraction): _ab_trace_report holds its lanes; brute force is
        # held bit for bit
        unequal += same == "NO" and not (key.startswith("kernel 8")
                                         and key.endswith("nee"))
        print(f"{key} | {oth[0]:.4f}, {oth[1]:.4f} | {this[0]:.4f}, "
              f"{this[1]:.4f} | {gap:+.4f} | {same}")
    if "gradient" in only:
        key = _ab_gradient_key("terrain32", True, False) + " scatter"
        replays = [d[key + " replays launch 1"] for ds in digests.values()
                   for d in ds]
        unequal += replays.count("False")
        print(f"{key}: replays launch 1 bit for bit, per run: {replays}; "
              f"atlas gradient against run 1 over the atomic bound (1 is the "
              f"bar): " + ", ".join(f"{r:.4g}" for r in ratios))
    if "trace" in only:
        unequal += _ab_trace_report(out_dir)
    if "packet" in only:
        unequal += _ab_packet_report(packets, runs, waves, out_dir)
        unequal += _ab_bin_report(runs, waves)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 1 if unequal or not all(r <= 1.0 for r in ratios) else 0


def _ab_trace_report(out_dir) -> int:
    """Kernel 8's part of ``ab``: per workload, this checkout's launch
    (run 2) against the other's (run 1) on the same inputs: the lanes that
    differ at all and by how much, the share within ``sample_lane_
    agreement``'s bar, and the ray counts, which must be equal (integer
    sums); each checkout's runs equal to each other. Fails where the rays
    differ, a checkout does not replay itself, or fewer than AGREE of the
    lanes agree. Returns the number of failures."""
    import torch

    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, sample_lane_agreement,
    )

    runs = [torch.load(out_dir / f"ab_trace_{i}.pt") for i in range(4)]
    n = W * H * SPP
    bad, parts = 0, []
    for key in runs[0]:
        (Lo, ro), (Lt, rt) = runs[0][key], runs[1][key]
        replay = (torch.equal(Lo, runs[3][key][0])
                  and torch.equal(Lt, runs[2][key][0]))
        frac, dmax, _ = sample_lane_agreement(Lt, Lo, n)
        lanes = Lo.reshape(-1, 3)[:n] != Lt.reshape(-1, 3)[:n]
        n_diff = int(lanes.any(-1).sum())
        ok = ro == rt and replay and frac >= AGREE
        bad += not ok
        parts.append(f"{key}: {n_diff} of {n} lanes differ (max |dL| "
                     f"{dmax:.3g}), {frac:.6f} within the lane bar; rays "
                     f"{rt} / {ro} (this / other); each replays itself "
                     f"{replay}")
    print("kernel 8 against the other checkout on the same inputs: "
          + " | ".join(parts), flush=True)
    return bad


def _ab_packet_report(packets, runs, waves, out_dir) -> int:
    """Kernel 5's part of ``ab``: whether each checkout's runs answered
    every wave alike (bit for bit), this checkout's answers against the
    other's on every wave at packet_agreement's bars (triangles by MeshData
    id), and the bound of a mean wave that this checkout's runs counted,
    beside both sides' ms. Returns the number of failures."""
    import torch

    from tpu_pathtracer_torch.utils.metrics import packet_agreement

    bad = 0
    for tag in ("other", "this"):
        ds = [p["digests"] for t, p in packets if t == tag]
        same = all(d == ds[0] for d in ds)
        bad += not same
        print(f"kernel 5 {tag}: every wave's answers equal across its runs: "
              f"{same}")
    t_inits = [(w[2], w[3]) for w in torch.load(waves)]
    other, this = (torch.load(out_dir / f"ab_packet_answers_{i}.pt")
                   for i in (0, 1))
    parts = []
    for i, ((t0, any_hit), o, t) in enumerate(zip(t_inits, other, this)):
        c = packet_agreement(t, o, t0, any_hit)
        bad += not c["ok"]
        parts.append(f"wave {i} ({'shadow' if any_hit else 'closest'}): "
                     f"agree {c['agree']:.6f}, max|dt| "
                     f"{c['max_abs_err']:.3g}, t ratio {c['t_ratio']:.3g}, "
                     f"sign {c['sign']:.3f}, ok {c['ok']}")
    print("kernel 5 this vs other, by packet_agreement's bars: "
          + "; ".join(parts))
    bounds = [p["bound"] for t, p in packets if p["bound"] is not None]
    if bounds:
        ms = {tag: statistics.mean(r["kernel 5 mean wave"] for t, r in runs
                                   if t == tag) for tag in ("other", "this")}
        print(f"kernel 5 bound of a mean wave on the leaf-<=4 tree: "
              f"{bounds[0][0]:.5f} ms by {bounds[0][1]}" + "".join(
                  f"; {tag} {v:.4f} ms per launch (the bound is {b:.1%} of "
                  f"it)" for tag, v in ms.items()
                  for b in [bounds[0][0] / v]))
    return bad


def _ab_bin_report(runs, waves) -> int:
    """Kernel 6's part of ``ab``, with this checkout's plain versions on the
    recorded config-4 waves: bin_tree_ref (the coarse tree's DFS walk) equal
    to bin_rays_ref (the sweep) bit for bit on every wave, the walk's node
    and cell tests per live ray against the sweep's C cell tests, and the
    bound of a mean wave (the walk's tests; bytes: ``_bin_io_bytes`` and
    the walk table) beside both sides' ms per launch. Returns the number of
    failures."""
    import torch

    from tpu_pathtracer_torch.models import scene as sc
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, _ = sc.terrain_textured(device="cuda")
    coarse = sc.with_packet_mesh(scene).mesh_packed_coarse
    C = coarse.cell_ids.shape[0]
    counts, live, io, bad, parts = {}, 0, 0, 0, []
    for i, (o, d, t0, any_hit) in enumerate(torch.load(waves)):
        o, d, t0 = o.cuda(), d.cuda(), t0.cuda()
        c = {}
        walk = mk.bin_tree_ref(coarse, o, d, t0, 3e-2, counts=c)
        sweep = mk.bin_rays_ref(coarse, o, d, t0, 3e-2)
        same = all(torch.equal(a, b) for a, b in zip(walk, sweep))
        bad += not same
        n_live = int((t0 > 0).sum())
        live, io = live + n_live, io + _bin_io_bytes(t0)
        for k in ("nodes", "cells"):
            counts[k] = counts.get(k, 0) + c.get(k, 0)
        parts.append(f"wave {i} ({'shadow' if any_hit else 'closest'}, "
                     f"{n_live} live of {o.shape[0]}): "
                     f"{c.get('nodes', 0) / max(n_live, 1):.2f} nodes + "
                     f"{c.get('cells', 0) / max(n_live, 1):.2f} cells per "
                     f"live ray, walk equals sweep {same}")
    n = len(parts)
    ops = ((counts["nodes"] + counts["cells"]) * OPS["bin_cell"]
           + live * OPS["walk"]) / n
    nbytes = io / n + 4 * coarse.walk_nodes.numel()
    bound, by = _bound(ops, nbytes)
    sweep_ops = (live * C * OPS["bin_cell"] + live * OPS["walk"]) / n
    print(f"kernel 6 walk tests on the recorded waves ({C} cells, "
          f"{coarse.num_nodes} nodes): " + "; ".join(parts)
          + f"; all waves: {counts['nodes'] / live:.2f} nodes + "
          f"{counts['cells'] / live:.2f} cells per live ray (the sweep: {C} "
          f"cells); bound of a mean wave {bound:.5f} ms by {by} (the sweep's "
          f"operations {sweep_ops / F32_PEAK * 1e3:.5f} ms)" + "".join(
              f"; {tag} {v:.4f} ms per launch (the bound is {bound / v:.1%} "
              f"of it)" for tag in ("other", "this")
              for v in [statistics.mean(r["kernel 6 wave"] for t, r in runs
                                        if t == tag)]))
    return bad


# --leaf-cutoff: small meshes, the one leaf against the leaf-<=4 tree
CUTOFF_MESHES = [("cornell_boxes", None), ("terrain_textured", 6),
                 ("terrain_textured", 7), ("terrain_textured", 8)]


def leaf_cutoff() -> int:
    """Kernel 1's device ms per forward launch (one ``_profile`` trace of 10
    launches; 640x480, budget 16, brute force and NEE) on small meshes
    packed two ways: as one leaf and as the mesh's leaf-<=4 tree
    (``pack_bvh`` with ``one_leaf`` its triangle count, or 0), A B B A in
    one process; cornell_boxes (36 triangles) and terrain_textured at
    n = 6, 7 and 8 (50, 72 and 98 triangles), which lie between the meshes
    that set ``BVH_MAX_LEAF``."""
    import dataclasses

    import torch

    sys.path.insert(0, str(ROOT))
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels.mesh_kernel import pack_bvh
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    print("device ms per forward launch: mesh (triangles) mode | one leaf "
          "(runs 1, 4) | leaf-<=4 tree, nodes (runs 2, 3) | tree / one "
          "leaf - 1", flush=True)
    for name, n in CUTOFF_MESHES:
        build = getattr(sc, name)
        scene, cs = build(device="cuda") if n is None else build(
            n=n, device="cuda")
        scene = sc.with_packet_mesh(scene, two_pass=False)
        cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                             cs["fov"], device="cuda")
        cp = pack_camera(cam)
        T = scene.mesh.num_tris
        packs = {"one": dataclasses.replace(
                     scene, mesh_bvh=pack_bvh(scene.mesh, one_leaf=T)),
                 "tree": dataclasses.replace(
                     scene, mesh_bvh=pack_bvh(scene.mesh, one_leaf=0))}
        for use_nee in (False, True):
            ms = {"one": [], "tree": []}
            for key in ("one", "tree", "tree", "one"):
                st = [None]

                def start():
                    st[0] = pk.init_state(W, H, TR, device="cuda")

                def run(i, sc_=packs[key]):
                    st[0], _ = pk.persistent_step(
                        sc_, cp, (400, i), st[0], budget=16, width=W,
                        height=H, max_bounces=10, rr_start=3, tile_rows=TR,
                        use_nee=use_nee)

                ms[key].append(_profile(run, 10, "persistent_kernel",
                                        "cutoff", start=start)[0])
            gap = statistics.mean(ms["tree"]) / statistics.mean(ms["one"]) - 1
            print(f"{name}{'' if n is None else f'({n})'} ({T}) "
                  f"{'nee' if use_nee else 'brute'} | {ms['one'][0]:.4f}, "
                  f"{ms['one'][1]:.4f} | {ms['tree'][0]:.4f}, "
                  f"{ms['tree'][1]:.4f}, {packs['tree'].mesh_bvh.num_nodes} "
                  f"nodes | {gap:+.4f}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


_LAP = [0.0]


# ---------------------------------------------------------------------------
# The wavefront under autograd (phases 36-39)
# ---------------------------------------------------------------------------

# rows of config 5's image whose lanes phase 36 traces on the CPU as well
AD_BAND = (232, 248)
# the slope window and reps of the wavefront gradients' times (phase 39):
# a step takes hundreds of ms, so a short window
AD_K, AD_REPS = 3, 3
REPLAY_RTOL, REPLAY_ATOL_A, REPLAY_ATOL_I = 2e-3, 2e-4, 2e-5


def _ad_inputs(name, w, h, use_nee, seed):
    """A scene (its mesh packed, two-pass), its camera, config 5's render
    settings and a random (h, w, 3) adjoint image."""
    import torch

    from tpu_pathtracer_torch.models.integrator import RenderConfig

    scene, cam, _ = _scene(name, w, h, "cuda")
    config = RenderConfig(spp=SPP, max_bounces=MB, rr_start=3,
                          use_nee=use_nee)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scene, cam, config, torch.rand((h, w, 3), generator=gen,
                                          device="cuda")


def _table_grads(fn, scene, cam, seed, config, weights):
    """(image, d sum(weights * image) / d mat_color, / d light_intensity)
    through ``fn`` (``render`` or ``render_replay``)."""
    import dataclasses

    import torch

    A = scene.mat_color.detach().clone().requires_grad_(True)
    I = scene.light_intensity.detach().clone().requires_grad_(True)
    img = fn(dataclasses.replace(scene, mat_color=A, light_intensity=I),
             cam, seed, config)
    torch.sum(img * weights).backward()
    torch.cuda.synchronize()
    return img.detach(), A.grad, I.grad


def _rel_gap(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_autograd_replay():
    """36: path replay against autograd of the wavefront at config 5
    (cornell 640x480, spp 4, 10 bounces, RR after 3), brute force and NEE,
    on the same Philox draws: the image, and the gradients of sum(weights
    * image) w.r.t. mat_color and light_intensity within rtol 2e-3 (atol
    2e-4 and 2e-5, the JAX suite's bar); then the lanes of one band of
    rows traced on the card and on the CPU (the plain run): >= AGREE of
    lanes within L_TOL."""
    import torch

    from tpu_pathtracer_torch.diff import replay
    from tpu_pathtracer_torch.models.integrator import render, trace_pixels
    from tpu_pathtracer_torch.utils import rng
    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, sample_lane_agreement,
    )

    parts, worst = [], {"l_agree": 1.0, "max_abs_err": 0.0}
    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        scene, cam, config, w = _ad_inputs("cornell", W, H, use_nee, 36)
        seed = 36
        img_a, gA_a, gI_a = _table_grads(render, scene, cam, seed, config, w)
        img_r, gA_r, gI_r = _table_grads(replay.render_replay, scene, cam,
                                         seed, config, w)
        for name, x in (("image", img_a), ("mat_color", gA_a),
                        ("light_intensity", gI_a), ("replay mat_color", gA_r),
                        ("replay light_intensity", gI_r)):
            if not bool(torch.isfinite(x).all()):
                fail(f"autograd vs replay ({mode}): {name} not finite")
        if tuple(img_a.shape) != (H, W, 3) or float(gA_a.abs().max()) == 0:
            fail(f"autograd vs replay ({mode}): misshapen image or zero "
                 "gradient")
        img_gap = _rel_gap(img_r, img_a)
        if img_gap > 1e-5:
            fail(f"autograd vs replay ({mode}): images {img_gap} apart")
        for name, r, a, atol in (("mat_color", gA_r, gA_a, REPLAY_ATOL_A),
                                 ("light_intensity", gI_r, gI_a,
                                  REPLAY_ATOL_I)):
            if not torch.allclose(r, a, rtol=REPLAY_RTOL, atol=atol):
                fail(f"autograd vs replay ({mode}): {name} differs: "
                     f"{r.tolist()} against {a.tolist()}")
        # one band of rows on the CPU: the card's lanes against the plain run
        lanes = torch.arange(AD_BAND[0] * W * SPP, AD_BAND[1] * W * SPP,
                             dtype=torch.int32)
        with torch.no_grad():
            L_card = trace_pixels(scene, cam, lanes.cuda(),
                                  rng.philox_draws(seed, 0), config)
            t0 = time.perf_counter()
            L_cpu = trace_pixels(scene.to("cpu"), cam.to("cpu"), lanes,
                                 rng.philox_draws(seed, 0), config)
            cpu_s = time.perf_counter() - t0
        agree, dmax, _ = sample_lane_agreement(L_card, L_cpu, len(lanes))
        if agree < AGREE:
            fail(f"wavefront card vs CPU ({mode}): {agree:.4f} of lanes "
                 f"agree (< {AGREE})")
        worst["l_agree"] = min(worst["l_agree"], agree)
        worst["max_abs_err"] = max(worst["max_abs_err"], dmax)
        parts.append(
            f"{mode}: image gap {img_gap:.2e}, replay/autograd gradient gaps "
            f"mat_color {_rel_gap(gA_r, gA_a):.2e} light_intensity "
            f"{_rel_gap(gI_r, gI_a):.2e} (of max |g| {float(gA_a.abs().max()):.6g}"
            f" / {float(gI_a.abs().max()):.6g}); rows {AD_BAND[0]}-"
            f"{AD_BAND[1] - 1} ({len(lanes)} lanes) card vs CPU: "
            f"{agree:.5f} agree, max |dL| {dmax:.3g}, CPU {cpu_s:.1f} s")
    print(f"[36 autograd vs replay] cornell {W}x{H} spp {SPP}, {MB} bounces: "
          + " | ".join(parts), flush=True)
    return worst


def phase_wavefront_trainer(steps=5):
    """37: the wavefront trainer (``make_train_step``, autograd through the
    wavefront with ``remat``): at config 5 on cornell_spheres, brute force
    and NEE, and on cornell_boxes NEE (640x480, spp 4, 10 bounces), the
    target from ``render_target`` (one iteration at fixed_iteration 0),
    then ``steps`` same-seed Adam steps from phase 8's perturbed parameters:
    the loss falls and everything is finite. On cornell_boxes every wave
    (a closest-hit and a shadow wave per bounce) is one launch of kernel 6
    and one of kernel 5, and each wave of a step runs twice (the forward
    and the bounce's recomputation in the backward): launches = waves x (1
    + 2 steps), counted from 0 just before the target; one more step
    without remat launches each once per wave. The wall seconds per step
    are printed. Then ``cli invert --estimator replay --steps 5`` exits
    0."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    parts, counts = [], {}
    for name, use_nee, mat in (("cornell", False, 3), ("cornell", True, 3),
                               ("cornell-boxes", True, 0)):
        mode = f"{name} {'nee' if use_nee else 'brute'}"
        scene, cam, config, _ = _ad_inputs(name, W, H, use_nee, 37)
        seed = 37
        p0 = inverse.params_of(scene)
        p0["mat_color"][mat] = 0.3
        p0["light_intensity"] *= 0.5
        state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
        step = inverse.make_train_step(scene, cam, config, fixed_iteration=0)
        mk.packet_launches = mk.bin_launches = 0
        target = inverse.render_target(scene, cam, seed, config,
                                       n_iterations=1, base_iteration=0)
        t0 = time.perf_counter()
        losses = [float(step(state, target, seed)[1]) for _ in range(steps)]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        got = (mk.packet_launches, mk.bin_launches)
        if not (bool(torch.isfinite(target).all())
                and all(map(math.isfinite, losses))
                and all(bool(torch.isfinite(v.detach()).all())
                        for v in state.params.values())):
            fail(f"wavefront trainer ({mode}): non-finite results")
        if not losses[-1] < losses[0]:
            fail(f"wavefront trainer ({mode}): loss {losses[0]} -> "
                 f"{losses[-1]} did not fall")
        line = (f"{mode}: loss {' '.join(f'{v:.6g}' for v in losses)} "
                f"({step_s:.2f} s per step)")
        if scene.mesh is not None:
            waves = (MB + 1) * (2 if use_nee else 1)
            want = waves * (1 + 2 * steps)
            if got != (want, want):
                fail(f"wavefront trainer ({mode}): kernel 5 / 6 launched "
                     f"{got} times, not {want} = {waves} waves x (1 + 2 x "
                     f"{steps})")
            counts["remat"] = got
            mk.packet_launches = mk.bin_launches = 0
            once = inverse.make_train_step(
                scene, cam, dataclasses.replace(config, remat=False),
                fixed_iteration=0)
            once(state, target, seed)
            torch.cuda.synchronize()
            if (mk.packet_launches, mk.bin_launches) != (waves, waves):
                fail(f"wavefront trainer ({mode}, no remat): kernel 5 / 6 "
                     f"launched {mk.packet_launches} / {mk.bin_launches} "
                     f"times for {waves} waves")
            counts["no_remat"] = waves
            line += (f"; kernels 5 / 6 {got[0]} / {got[1]} launches = "
                     f"{waves} waves x (1 + 2 x {steps}) under remat, "
                     f"{waves} / {waves} for one step without")
        alb = state.params["mat_color"][mat].detach().cpu().tolist()
        parts.append(line + f"; albedo {mat} {[round(a, 4) for a in alb]} "
                     f"(true {[round(a, 4) for a in scene.mat_color[mat].tolist()]})")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "invert",
         "--estimator", "replay", "--steps", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "recovered albedo" not in proc.stdout:
        fail(f"cli invert --estimator replay failed ({proc.returncode}): "
             f"{proc.stdout[-1000:]}{proc.stderr[-2000:]}")
    tail = " / ".join(proc.stdout.strip().splitlines()[-2:])
    parts.append(f"cli invert --estimator replay (32x32, spp 4, 5 steps) in "
                 f"{time.perf_counter() - t0:.1f} s: {tail}")
    print(f"[37 wavefront trainer main path] {W}x{H} spp {SPP}, {MB} "
          f"bounces, lr {LR}, {steps} steps: " + " | ".join(parts),
          flush=True)
    return counts


def _floor_scene(with_ceiling=False):
    """The JAX geometry tests' edge-free floor quad (and a far ceiling of
    material 1) under a point light, packed, and its 48x36 camera."""
    import numpy as np

    from tpu_pathtracer_torch.models import camera as cm, meshes
    from tpu_pathtracer_torch.models import scene as sc
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-40, 0, -40], [-40, 0, 40], [40, 0, 40],
                           [40, 0, -40])
    mats, fm = [sc.diffuse([0.8, 0.7, 0.6])], 0
    if with_ceiling:
        v2, f2, uv2 = meshes.quad([-40, 30, -40], [40, 30, -40],
                                  [40, 30, 40], [-40, 30, 40])
        v, f = np.concatenate([v, v2]), np.concatenate([f, f2 + 4])
        uv = np.concatenate([uv, uv2])
        fm = np.array([0, 0, 1, 1], np.int32)
        mats.append(sc.diffuse([0.3, 0.3, 0.3]))
    scene = sc.make_scene(
        [], mats, [sc.point_light([2, 6, 1], [60, 60, 60])],
        mesh=build_bvh(v, f, uv, fm, device="cuda"), device="cuda")
    cam = cm.make_camera([0, 5, 0.1], [0, 0, 0], [0, 0, -1], 48, 36, 45.0,
                         device="cuda")
    return sc.with_packet_mesh(scene), cam


def _np_weights(seed, shape):
    """The CPU tests' adjoint image: numpy's default_rng(seed), on the
    card."""
    import numpy as np
    import torch

    return torch.tensor(np.random.default_rng(seed).random(shape,
                                                           np.float32),
                        device="cuda")


def _fd_mean(J, h, iters):
    """Mean over iterations of the central difference (J(h) - J(-h)) /
    2h."""
    return sum((J(h, it) - J(-h, it)) / (2 * h) for it in range(iters)) \
        / iters


def phase_score_geometry_fd():
    """38: the IOR and geometry gradients on the card against central
    differences of ``render``, at the CPU tests' fixtures and bars: the
    glass ball (4x4, spp 64, 6 bounces, 14 iterations, brute force): the
    mean gradient above 0.3 and within rtol 0.4 of the FD mean;
    the adjoint images are the CPU tests' (numpy's default_rng); the
    emissive sphere on black (48x36, spp 48, 8192 edge samples): the
    radius within 2e-2 (8 iterations, h 0.25), the centre's z within 5e-2
    (10 iterations, h 0.4); the floor quad (48x36, spp 4, 1 bounce, NEE,
    kernels 5 and 6): the y translation of the whole mesh and of the
    floor alone within 2e-2 (6 iterations, h 0.02, ``_translate_mesh``
    packing the moved mesh again). Then one run of each estimator at
    640x480 (config 5, NEE; geometry_grads on cornell_spheres,
    mesh_translation_grads on cornell_boxes): finite."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch.diff import geometry, score
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import RenderConfig, render

    parts = []
    glass = _glass_scene("cuda")
    gcam = cm.make_camera([0, 0, 30], [0, 0, 0], [0, 1, 0], 4, 4, 0.5,
                          device="cuda")
    w = torch.full((4, 4, 3), 1.0 / 48, device="cuda")
    # brute force only: NEE adds nothing on this fixture (its only diffuse
    # material is black), so both modes give the same numbers
    for use_nee in (False,):
        cfg = RenderConfig(spp=64, max_bounces=6, use_nee=use_nee)

        def J(h, it, cfg=cfg):
            coef = glass.mat_coef.clone()
            coef[0] += h
            return float(torch.sum(w * render(dataclasses.replace(
                glass, mat_coef=coef), gcam, 3, cfg, iteration=it)))

        g = sum(float(score.ior_value_and_grad(glass, gcam, 3, cfg, w,
                                               iteration=it)[1][0])
                for it in range(14)) / 14
        fd = _fd_mean(J, 0.02, 14)
        if not (math.isfinite(g) and g > 0.3 and abs(g - fd) <= 0.4 * abs(fd)):
            fail(f"IOR gradient ({'nee' if use_nee else 'brute'}): {g} "
                 f"against FD {fd}")
        parts.append(f"IOR {'nee' if use_nee else 'brute'} {g:.4f} vs FD "
                     f"{fd:.4f}")

    cov = sc.make_scene([sc.sphere([0.0, 0.0, 0.0], 8.0, 0, 0)],
                        [sc.diffuse([0.0, 0.0, 0.0])],
                        [sc.area_light(0, [5.0] * 3)], device="cuda")
    ccam = cm.make_camera([0.0, 5.0, 60.0], [0.0, 0.0, 0.0],
                          [0.0, 1.0, 0.0], 48, 36, 45.0, device="cuda")
    wimg = _np_weights(11, (36, 48, 3))
    cfg = RenderConfig(spp=48, max_bounces=0)
    g = geometry.geometry_grads(cov, ccam, 3, cfg, wimg, n_edge_samples=8192)
    for what, h, iters, rtol, get in (
            ("radius", 0.25, 8, 2e-2, lambda g: float(g["radii"][0])),
            ("centre z", 0.4, 10, 5e-2,
             lambda g: float(g["centers"][0, 2]))):
        def J(d, it, what=what):
            c, r = cov.centers.clone(), cov.radii.clone()
            if what == "radius":
                r[0] += d
            else:
                c[0, 2] += d
            return float(torch.sum(wimg * render(dataclasses.replace(
                cov, centers=c, radii=r), ccam, 3, cfg, iteration=it)))

        fd = _fd_mean(J, h, iters)
        if not abs(get(g) - fd) <= rtol * abs(fd):
            fail(f"geometry gradient ({what}): {get(g)} against FD {fd}")
        parts.append(f"{what} {get(g):.4f} vs FD {fd:.4f}")

    mcfg = RenderConfig(spp=4, max_bounces=1, use_nee=True)
    for objects, ceiling, key in ((None, False, 5), ((0,), True, 7)):
        fl, fcam = _floor_scene(ceiling)
        wf = _np_weights(2 if objects is None else 4, (36, 48, 3))
        g = float(geometry.mesh_translation_grads(fl, fcam, key, mcfg, wf,
                                                  objects=objects)[1])

        def J(h, it, fl=fl, fcam=fcam, wf=wf, objects=objects, key=key):
            moved = geometry._translate_mesh(
                fl, torch.tensor([0.0, h, 0.0], device="cuda"), objects)
            return float(torch.sum(wf * render(moved, fcam, key, mcfg,
                                               iteration=it)))

        fd = _fd_mean(J, 2e-2, 6)
        what = "floor" if objects else "mesh"
        if not (abs(g) > 0.1 and abs(g - fd) <= 2e-2 * abs(fd)):
            fail(f"mesh translation ({what}): {g} against FD {fd}")
        parts.append(f"{what} y {g:.4f} vs FD {fd:.4f}")

    # one full-size run of each
    scene, cam, config, wbig = _ad_inputs("cornell", W, H, True, 38)
    _, gc = score.ior_value_and_grad(scene, cam, 38, config, wbig)
    gg = geometry.geometry_grads(scene, cam, 38, config, wbig)
    boxes, bcam, bconfig, wb = _ad_inputs("cornell-boxes", W, H, True, 38)
    gm = geometry.mesh_translation_grads(boxes, bcam, 38, bconfig, wb)
    for name, x in (("ior", gc), ("centers", gg["centers"]),
                    ("radii", gg["radii"]), ("mesh", gm)):
        if not bool(torch.isfinite(x).all()):
            fail(f"{name} gradient at {W}x{H} not finite")
    parts.append(f"{W}x{H} finite: mat_coef {gc.tolist()}, mesh "
                 f"{[round(v, 4) for v in gm.tolist()]}")
    print("[38 score and geometry vs FD] " + " | ".join(parts), flush=True)


def _device_idle(run, k, tag, top=4):
    """(window ms per call, device busy ms per call, idle share, the
    ``top`` kernels by device ms per call as (ms, launches per call, name))
    from one torch.profiler trace of run(0..k-1) (``_traced``; every
    kernel, memcpy and memset counts as busy)."""
    window, events = _traced(run, k, tag,
                             lambda ev: None if ev else "no device events")
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"] / 1e3 / k
        acc[1] += 1
    heavy = sorted(((ms, n / k, name[:60]) for name, (ms, n)
                    in by_name.items()), reverse=True)[:top]
    return window / k, busy / k, 1.0 - busy / window, heavy


def _peak_mb(fn) -> tuple[float, float]:
    """(torch.cuda.max_memory_allocated over one call of fn, the same less
    what was allocated before the call: the call's own peak), MiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 2**20, (peak - before) / 2**20


def phase_autograd_times(smi):
    """39: times of the wavefront's gradients at config 5 (cornell
    640x480, spp 4, 10 bounces), each beside the fused kernel's gradient of
    the same workload, end to end by the CUDA-event slope between 1 and
    AD_K calls (median of AD_REPS; the fused ones by phase 10's 24 calls,
    median of REPS): the train step (``make_train_step``, remat) against
    ``make_kernel_train_step``'s, brute force and NEE, with the step's
    device idle share (one torch.profiler trace of one step) and
    ``torch.cuda.max_memory_allocated`` over one step with remat on and
    off; ``render_replay``'s value-and-grad of sum(w * image) against
    ``persistent_mse_value_and_grad``, brute force and NEE; with NEE,
    ``ior_value_and_grad`` against the tangent kernel's
    ``ior_weighted_grad``, and ``geometry_grads``, which has no fused
    counterpart. Each row is printed as it is measured."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch.diff import geometry, inverse, replay, score
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    out = {}

    def row(text):
        print(f"[39 autograd times] {text}", flush=True)

    def replay_vg(scene, cam, config, w, seed):
        p = {k: getattr(scene, k).detach().clone().requires_grad_(True)
             for k in ("mat_color", "light_intensity")}
        img = replay.render_replay(dataclasses.replace(scene, **p), cam,
                                   seed, config)
        torch.sum(img * w).backward()

    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        scene, cam, config, w = _ad_inputs("cornell", W, H, use_nee, 39)
        kw = dict(spp=SPP, budget=rp.default_budget(SPP, MB), max_bounces=MB,
                  rr_start=3, tile_rows=TR, use_nee=use_nee)
        o = {}
        target = inverse.render_target(scene, cam, 39, config,
                                       n_iterations=1, base_iteration=0)
        t_img = target.reshape(H, W, 3)
        p0 = inverse.params_of(scene)
        p0["mat_color"][3] = 0.3
        state = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
        step = inverse.make_train_step(scene, cam, config)
        o["step_ms"], o["step_reps"] = _slope_ms(
            lambda salt, i: step(state, target, salt), AD_K, AD_REPS)
        kstate = inverse.init_state(scene, inverse.make_optimizer(LR), p0)
        kstep = inverse.make_kernel_train_step(scene, cam, config)
        o["fused_step_ms"], _ = _slope_ms(
            lambda salt, i: kstep(kstate, t_img, (salt, i)), 24)
        row(f"{mode} train step {o['step_ms']:.2f} ms (slope 1-{AD_K}, "
            f"median of {AD_REPS}: "
            f"{', '.join(f'{v:.2f}' for v in o['step_reps'])}); fused step "
            f"{o['fused_step_ms']:.4f} ms; ratio "
            f"{o['step_ms'] / o['fused_step_ms']:.1f}")
        (o["window_ms"], o["busy_ms"], o["idle_share"],
         o["heavy"]) = _device_idle(
            lambda i: step(state, target, 500 + i), 1,
            f"wavefront_step_{mode}")
        for remat in (True, False):
            s = inverse.make_train_step(
                scene, cam, dataclasses.replace(config, remat=remat))
            (o[f"peak_mb_remat_{remat}"],
             o[f"step_peak_mb_remat_{remat}"]) = _peak_mb(
                lambda s=s: s(state, target, 600))
        row(f"{mode} train step profiled: window {o['window_ms']:.2f} ms, "
            f"device busy {o['busy_ms']:.2f} ms, idle share "
            f"{o['idle_share']:.3f}; peak memory (the step's own above "
            f"what was allocated before it / all) "
            f"{o['step_peak_mb_remat_True']:.0f} / "
            f"{o['peak_mb_remat_True']:.0f} MiB with remat, "
            f"{o['step_peak_mb_remat_False']:.0f} / "
            f"{o['peak_mb_remat_False']:.0f} MiB without; heaviest kernels "
            "(ms, launches per step): " + "; ".join(
                f"{ms:.1f} ms x{n:.0f} {name}" for ms, n, name in o["heavy"]))
        o["replay_ms"], o["replay_reps"] = _slope_ms(
            lambda salt, i: replay_vg(scene, cam, config, w, salt), AD_K,
            AD_REPS)
        o["fused_grad_ms"], _ = _slope_ms(
            lambda salt, i: rp.persistent_mse_value_and_grad(
                scene, cam, (salt, i), 0, t_img, **kw), 24)
        row(f"{mode} render_replay value-and-grad {o['replay_ms']:.2f} ms "
            f"({', '.join(f'{v:.2f}' for v in o['replay_reps'])}); fused "
            f"persistent_mse_value_and_grad {o['fused_grad_ms']:.4f} ms; "
            f"ratio {o['replay_ms'] / o['fused_grad_ms']:.1f}")
        if use_nee:
            o["ior_ms"], o["ior_reps"] = _slope_ms(
                lambda salt, i: score.ior_value_and_grad(scene, cam, salt,
                                                         config, w),
                AD_K, AD_REPS)
            o["fused_ior_ms"], _ = _slope_ms(
                lambda salt, i: cj.ior_weighted_grad(
                    scene, cam, (salt, i), w, **kw), 24)
            row(f"{mode} ior_value_and_grad {o['ior_ms']:.2f} ms "
                f"({', '.join(f'{v:.2f}' for v in o['ior_reps'])}); fused "
                f"ior_weighted_grad {o['fused_ior_ms']:.4f} ms; ratio "
                f"{o['ior_ms'] / o['fused_ior_ms']:.1f}")
            o["geometry_ms"], o["geometry_reps"] = _slope_ms(
                lambda salt, i: geometry.geometry_grads(scene, cam, salt,
                                                        config, w),
                AD_K, AD_REPS)
            row(f"{mode} geometry_grads {o['geometry_ms']:.2f} ms "
                f"({', '.join(f'{v:.2f}' for v in o['geometry_reps'])}); no "
                "fused counterpart")
        out[mode] = o
    row(f"on {smi}")
    return out


# ---------------------------------------------------------------------------
# Scenes, the host builder, resume and the viewer: sphere-field, a JSON
# scene through the CLI, checkpoints, the SAH and median-split trees, and the
# terminal viewer
# ---------------------------------------------------------------------------

# A JSON scene in the shape of tests/test_io.py:115-150 (a quad floor, a
# rotated box, an OBJ triangle lit as a TRI_LIGHT) with a uv_sphere beside
# them; the OBJ file is written next to it.
JSON_OBJ = "v -2 6 -2\nv 2 6 -2\nv 0 6 2\nf 1 2 3\n"
JSON_SCENE = {
    "camera": {"eye": [0, 4, 12], "look_at": [0, 2, 0], "fov": 60.0},
    "materials": [
        {"type": "diffuse", "color": [0.7, 0.7, 0.7]},
        {"type": "diffuse", "color": [0.8, 0.2, 0.2]},
        {"type": "diffuse", "color": [1.0, 1.0, 1.0]},
        {"type": "specular", "color": [0.9, 0.9, 0.9]},
    ],
    "meshes": [
        {"type": "quad", "corners": [[-8, 0, 8], [8, 0, 8], [8, 0, -8],
                                     [-8, 0, -8]], "material": 0},
        {"type": "box", "center": [0, 1.5, 0], "size": [2, 3, 2],
         "rotation_y": 0.4, "material": 1},
        {"type": "uv_sphere", "center": [3, 1.5, -1], "radius": 1.2,
         "material": 3, "n_lat": 16, "n_lon": 24},
        {"type": "obj", "path": "chip_smoke_tri.obj", "material": 2},
    ],
    "lights": [{"type": "tri", "material": 2, "intensity": [25, 25, 25]}],
}
VIEW_W, VIEW_H, VIEW_FRAMES = 192, 144, 8


def phase_sphere_field(smi):
    """40: sphere_field (128 spheres, half of the kernels' MAX_PRIMS, never
    on the card before) through PersistentRenderer at 640x480, spp 4, 10
    bounces, RR after 3, budget 16, brute force and NEE, to 4 spp: every
    launch replayed and held to the plain version by phase 4's bars (98% of
    lanes or the plain version's CPU-vs-card floor, rays within 1%) and by
    the sign test; then phase 6's times and bound at bench.py's workload."""
    from tpu_pathtracer_torch.utils.metrics import AGREE

    launches, _, worst, _ = phase_main_path(
        "sphere-field", (False, True), budget=16, target=4,
        label="40 sphere-field main path")
    if worst["sign_balance"] > 1.0:
        fail(f"sphere-field main path: sign balance {worst} of its bar")
    times = phase_times(smi, "sphere-field", "40 sphere-field times")
    floor_s = (" (below the bar, held to the floor)"
               if min(worst["n_agree"], worst["l_agree"]) < AGREE else "")
    print(f"[40 sphere-field] {launches} launches checked{floor_s}; kernel "
          + ", ".join(f"{m} {o['kernel_ms']:.4f} ms/launch (bound "
                      f"{o['bound_ms']:.5f} ms by {o['bound_by']}, "
                      f"{o['bound_ms'] / o['kernel_ms']:.3f} of it)"
                      for m, o in times.items()), flush=True)
    return dict(launches=launches, worst=worst, times=times)


def _write_json_scene():
    from tpu_pathtracer_torch.ops.kernels import _build

    d = _build.build_dir()
    d.mkdir(parents=True, exist_ok=True)
    (d / "chip_smoke_tri.obj").write_text(JSON_OBJ)
    path = d / "chip_smoke_scene.json"
    path.write_text(json.dumps(JSON_SCENE, indent=1))
    return path


def _cli_quiet(args):
    """cli.main(args) in this process, its stdout kept."""
    import contextlib
    import io

    from tpu_pathtracer_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(args)
    if rc != 0:
        fail(f"cli {' '.join(args)} exited {rc}: {out.getvalue()[-1000:]}")
    return out.getvalue()


def phase_json_scene():
    """41: a JSON scene file (``JSON_SCENE``: a quad floor, a rotated box, a
    uv_sphere and an OBJ triangle lit as a TRI_LIGHT; the mesh built by the
    SAH builder) through ``cli render --scene <file>`` at 640x480, spp 4, 10
    bounces, NEE, on both backends, the kernels' counts set to 0 before each
    and read after. pallas: a PersistentRenderer on the same file renders
    the CLI's image bit for bit in as many launches, and each launch is
    replayed and held to the plain version by phase 4's bars. xla: one frame
    of ``--iterations 1``; its first wave (the primary rays) is held whole
    to the plain versions on the card, kernel 5 (two-pass, sorted) against
    packet_ref on the 64-leaf tree (``packet_agreement``) and kernel 6
    against bin_rays_ref (``bin_agreement``)."""
    import numpy as np
    import torch

    from tpu_pathtracer_torch import PersistentRenderer, RenderConfig
    from tpu_pathtracer_torch.io.scene_io import load_scene
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera
    from tpu_pathtracer_torch.utils.metrics import AGREE

    path = _write_json_scene()
    d = _build.build_dir()
    base = ["render", "--scene", str(path), "--size", f"{W}x{H}", "--spp",
            "4", "--iterations", "1", "--bounces", str(MB), "--nee", "-q"]
    hdr = {}
    counts = {}
    for backend in ("pallas", "xla"):
        out = d / f"chip_smoke_scene_{backend}.npy"
        pk.launches = pk.mesh_launches = 0
        mk.packet_launches = mk.bin_launches = 0
        _cli_quiet(base + ["--backend", backend, "--hdr-output", str(out)])
        torch.cuda.synchronize()
        counts[backend] = (pk.launches, pk.mesh_launches, mk.packet_launches,
                           mk.bin_launches)
        hdr[backend] = np.load(out)
        if hdr[backend].shape != (H, W, 3) \
                or not np.isfinite(hdr[backend]).all() \
                or hdr[backend].max() <= 0:
            fail(f"json scene ({backend}): bad image")
    k1, k1_mesh, _, _ = counts["pallas"]
    _, _, k5, k6 = counts["xla"]
    if k1 == 0 or k1_mesh != k1 or counts["pallas"][2:] != (0, 0):
        fail(f"json scene (pallas): launches {counts['pallas']}")
    waves = 2 * (MB + 1)
    if (k5, k6) != (waves, waves) or counts["xla"][:2] != (0, 0):
        fail(f"json scene (xla): launches {counts['xla']}, want {waves} of "
             "kernels 5 and 6")
    scene, cs = load_scene(str(path), device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         device="cuda")
    config = RenderConfig(spp=4, max_bounces=MB, use_nee=True)
    # pallas: the CLI's launches again, each held to the plain version
    r = PersistentRenderer(scene, cam, config, seed=0, device="cuda")
    r.render_to(4)
    if r.state.frame != k1 or not np.array_equal(r.image().cpu().numpy(),
                                                  hdr["pallas"]):
        fail("json scene: the renderer's replay is not the CLI's render")
    checks = _replay_per_step(r.scene, cam, pack_camera(cam), True, r)
    for i, c in enumerate(checks):
        if c["n_agree"] < min(AGREE, c["n_floor"]) \
                or c["l_agree"] < min(AGREE, c["l_floor"]) \
                or c["ray_err"] > RAY_TOL:
            fail(f"json scene (pallas), launch {i} vs plain: {c}")
    # xla: the first wave of the CLI's frame, whole
    packed = sc.with_packet_mesh(scene)
    o, dd, t0, _ = _record_waves(packed, cam, config, seed=0)[0]
    pm, bvh, coarse = (packed.mesh_packed, packed.mesh_bvh,
                       packed.mesh_packed_coarse)
    p_out = _packet_check(pm, bvh, o, dd, t0, False, True, coarse)
    b0 = mk.bin_launches
    got = mk.bin_rays(coarse, o, dd, t0, 3e-2)
    torch.cuda.synchronize()
    if mk.bin_launches != b0 + 1:
        fail("bin_rays did not launch kernel 6 exactly once")
    sweep = _bin_plain(mk.bin_rays_ref, coarse, o, dd, t0, 3e-2)
    b_agree, tn_err, tn_abs = _hold_bin(got[:2], sweep[:2],
                                        "json scene, primary wave")
    worst = {k: min(c[k] for c in checks)
             for k in ("n_agree", "l_agree", "n_floor", "l_floor")}
    worst["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    means = {b: float(x.mean()) for b, x in hdr.items()}
    print(f"[41 json scene] {path.relative_to(ROOT)}: "
          f"{scene.mesh.num_tris} triangles, SAH tree of "
          f"{scene.mesh.num_nodes} nodes; cli render pallas: {k1} launches "
          f"of kernel 1, replayed bit for bit, each vs plain: n "
          f"{worst['n_agree']:.4f} L {worst['l_agree']:.4f} max|dL| "
          f"{worst['max_abs_err']:.3g} (floor n {worst['n_floor']:.4f} L "
          f"{worst['l_floor']:.4f}); cli render xla: {k5} launches of kernel "
          f"5 and {k6} of kernel 6 in one frame; its primary wave "
          f"({o.shape[0]} lanes) kernel 5 vs packet_ref agree "
          f"{p_out['agree']:.5f} (bit-equal {p_out['bit_equal']:.5f}) "
          f"max|dt| {p_out['max_abs_err']:.3g}, kernel 6 vs bin_rays_ref "
          f"cells {b_agree:.5f} tn rel {tn_err:.2g}; image means pallas "
          f"{means['pallas']:.5f} (4 spp or more) xla {means['xla']:.5f} "
          f"(4 spp)", flush=True)
    return dict(k1=k1, k5=k5, k6=k6, worst=worst, packet=p_out,
                bin_agree=b_agree, bin_abs_err=tn_abs)


def phase_resume(wf_renderer):
    """42: checkpoints on the card. Kernel 1: cornell_spheres NEE at
    640x480 through PersistentRenderer (budget 32), 2 steps, save, restore
    into a fresh renderer and 2 more steps: its PathState equals 4
    uninterrupted steps' bit for bit. The wavefront: ProgressiveRenderer on
    the terrain at config 4 (1024x1024, 2 spp, 3 bounces, NEE; phase 19's
    scene), 1 frame, save, restore, 1 more: equal to 2 uninterrupted frames
    bit for bit. Returns the launches of kernels 1, 5 and 6."""
    import shutil

    import torch

    from tpu_pathtracer_torch import (
        PersistentRenderer, ProgressiveRenderer, RenderConfig,
    )
    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils import checkpoint as ckpt

    root = _build.build_dir() / "chip_smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    pk.launches = 0
    mk.packet_launches = mk.bin_launches = 0
    scene, cam, _ = _scene("cornell", W, H, "cuda")
    config = RenderConfig(spp=4, max_bounces=MB, use_nee=True)

    def persistent():
        return PersistentRenderer(scene, cam, config, seed=5, device="cuda")

    full, part = persistent(), persistent()
    for _ in range(4):
        full.step()
    for _ in range(2):
        part.step()
    ckpt.save_state(str(root / "persistent"), part.state.frame, part.state)
    resumed = persistent()
    resumed.state = ckpt.restore_state(str(root / "persistent"),
                                       resumed.state)
    for _ in range(2):
        resumed.step()
    for f in pk.STATE_FIELDS:
        if not torch.equal(getattr(resumed.state, f), getattr(full.state, f)):
            fail(f"resume (kernel 1): {f} differs from the uninterrupted run")
    if resumed.state.frame != full.state.frame:
        fail("resume (kernel 1): frame differs")

    def wavefront():
        return ProgressiveRenderer(wf_renderer.scene, wf_renderer.camera,
                                   _c4_config(), seed=11, device="cuda")

    wf_full, wf_part = wavefront(), wavefront()
    for _ in range(2):
        wf_full.step()
    wf_part.step()
    ckpt.save_state(str(root / "wavefront"), wf_part.iteration, wf_part.state)
    wf_res = wavefront()
    wf_res.state = ckpt.restore_state(str(root / "wavefront"), wf_res.state)
    wf_res.step()
    torch.cuda.synchronize()
    if wf_res.iteration != 2 or not torch.equal(wf_res.state.radiance_sum,
                                                wf_full.state.radiance_sum):
        fail("resume (wavefront, config 4): the image differs from the "
             "uninterrupted run's")
    out = dict(k1=pk.launches, k5=mk.packet_launches, k6=mk.bin_launches)
    if out != dict(k1=8, k5=32, k6=32):
        fail(f"resume: launches {out}")
    print(f"[42 resume] kernel 1, cornell NEE {W}x{H}: 2 steps + save + "
          f"restore + 2 steps equal 4 steps bit for bit (every PathState "
          f"field, frame {full.state.frame}, min spp {full.min_samples}); "
          f"the wavefront at config 4: 1 frame + save + restore + 1 frame "
          f"equal 2 frames bit for bit; launches {out}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _median_split(scene, n=224):
    """``terrain_textured(n)`` with its mesh built by the NumPy median split
    (``use_native=False``) in place of the SAH tree (its one light is a
    sphere, so nothing else of the scene depends on the tree)."""
    import dataclasses

    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.terrain(n=n, extent=120.0, height=14.0, seed=3)
    return dataclasses.replace(
        scene, mesh=build_bvh(v, f, uv, 0, use_native=False, device="cuda"))


def phase_bvh_trees(smi):
    """43: the SAH tree (the default, as in the JAX package) against the
    NumPy median split (the port's tree before) on the same seeds, A B B A:
    kernel 1's terrain32 NEE launch (640x480, budget 16, phase 27's
    workload) and config 4's persistent launch (1024x1024, 3 bounces, NEE,
    budget 32, from a fresh state: phase 26's launch), each the kernel's ms
    per launch from one torch.profiler trace, and config 4's wavefront
    (two-pass) device busy ms per frame from one trace of 2 frames. Only
    printed: the SAH tree is the default whatever they read."""
    from tpu_pathtracer_torch import PersistentRenderer, ProgressiveRenderer
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    t_start = time.perf_counter()
    scenes = {}
    for tree in ("sah", "median"):
        t32, cs32 = sc.terrain_textured(n=32, device="cuda")
        c4, cs4 = sc.terrain_textured(device="cuda")
        if tree == "median":
            t32, c4 = _median_split(t32, 32), _median_split(c4)
        # the two-pass packing also serves the persistent kernel, which
        # never reads its coarse tree
        scenes[tree] = (sc.with_packet_mesh(t32), sc.with_packet_mesh(c4))
    cam32 = cm.make_camera(cs32["eye"], cs32["look_at"], cs32["up"], W, H,
                           cs32["fov"], device="cuda")
    cam4 = cm.make_camera(cs4["eye"], cs4["look_at"], cs4["up"], C4_W, C4_H,
                          cs4["fov"], device="cuda")
    cp32 = pack_camera(cam32)
    runs = {tree: {"t32": [], "c4p": [], "c4w": []}
            for tree in ("sah", "median")}
    nodes = {}
    for rep, tree in enumerate(("sah", "median", "median", "sah")):
        t32, c4 = scenes[tree]
        nodes[tree] = (t32.mesh.num_nodes, c4.mesh.num_nodes)
        st = {}

        def start32():
            st["s"] = pk.init_state(W, H, TR, device="cuda")

        def run32(i):
            st["s"], _ = pk.persistent_step(
                t32, cp32, (400, i), st["s"], budget=16, width=W, height=H,
                max_bounces=10, rr_start=3, tile_rows=TR, use_nee=True)

        ms, _, _, _ = _profile(run32, 10, "persistent_kernel",
                               f"trees_t32_{tree}{rep}", start=start32)
        runs[tree]["t32"].append(ms)
        rp = PersistentRenderer(c4, cam4, _c4_config(), seed=3,
                                device="cuda")
        ms, _, _, _ = _profile(lambda i: rp.step(), 1, "persistent_kernel",
                               f"trees_c4p_{tree}{rep}", start=rp.reset)
        runs[tree]["c4p"].append(ms)
        rw = ProgressiveRenderer(c4, cam4, _c4_config(), seed=11,
                                 device="cuda")
        rw.step()  # warm
        prof = _wavefront_profile(rw, 2, f"trees_{tree}{rep}")
        runs[tree]["c4w"].append(prof["busy_ms"])
    med = {tree: {k: statistics.median(v) for k, v in r.items()}
           for tree, r in runs.items()}
    print(f"[bvh trees] on {smi}, SAH / median split, A B B A (ms: each "
          f"run, then the median): terrain32 nodes {nodes['sah'][0]} / "
          f"{nodes['median'][0]}, config 4 nodes {nodes['sah'][1]} / "
          f"{nodes['median'][1]} | "
          + " | ".join(
              f"{label} " + " / ".join(
                  f"{', '.join(f'{x:.4f}' for x in runs[t][k])} -> "
                  f"{med[t][k]:.4f}" for t in ("sah", "median"))
              for k, label in (("t32", "kernel 1 terrain32 NEE ms/launch"),
                               ("c4p", "kernel 1 config 4 ms/launch"),
                               ("c4w", "config 4 wavefront device busy "
                                       "ms/frame")))
          + f" | {time.perf_counter() - t_start:.1f} s", flush=True)
    return med


def phase_viewer():
    """44: the terminal viewer (``viewer.run_viewer``) headless on the card,
    VIEW_FRAMES frames of cornell_spheres at 192x144 (cli view's defaults:
    2 spp, 6 bounces), on backend pallas (kernel 1, counted) and xla (the
    wavefront; a sphere scene runs no mesh kernel); frames per second by
    the host clock. Then, on each backend, a left-button drag
    (``drag_camera``) through ``update_camera``: the next frame equals a
    fresh renderer's first frame at the moved camera bit for bit (the
    persistent one reset once, as a restart draws with the next salt)."""
    import io

    import torch

    from tpu_pathtracer_torch import RenderConfig
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.viewer import (
        drag_camera, make_renderer, run_viewer,
    )

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], VIEW_W, VIEW_H,
                         cs["fov"], device="cuda")
    config = RenderConfig(spp=2, max_bounces=6)
    out, parts = {}, []
    for backend in ("pallas", "xla"):
        run_viewer(scene, cam, config, max_frames=1, interactive=False,
                   backend=backend, device="cuda")  # warm
        pk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = run_viewer(scene, cam, config, max_frames=VIEW_FRAMES,
                            interactive=False, out=io.StringIO(),
                            backend=backend, device="cuda")
        fps = frames / (time.perf_counter() - t0)
        launches = pk.launches
        want = VIEW_FRAMES if backend == "pallas" else 0
        if frames != VIEW_FRAMES or launches != want:
            fail(f"viewer ({backend}): {frames} frames, {launches} kernel 1 "
                 "launches")
        r = make_renderer(scene, cam, config, seed=0, backend=backend,
                          device="cuda")
        r.step()
        moved = drag_camera(r.camera, 0, 3, -2, 1.0)
        r.update_camera(moved)
        r.step()
        fresh = make_renderer(scene, moved, config, seed=0, backend=backend,
                              device="cuda")
        if backend == "pallas":
            fresh.reset()
        fresh.step()
        if not torch.equal(r.image(), fresh.image()):
            fail(f"viewer ({backend}): the frame after a drag is not a fresh "
                 "renderer's first frame")
        out[backend] = dict(fps=fps, launches=launches)
        parts.append(f"{backend}: {frames} frames at {fps:.2f} frames/s, "
                     f"{launches} launches of kernel 1, the frame after a "
                     f"drag equals a fresh renderer's")
    print(f"[44 viewer] cornell {VIEW_W}x{VIEW_H}, spp 2, 6 bounces, "
          f"headless: " + " | ".join(parts), flush=True)
    return out


def _lap() -> float:
    """Seconds since the previous call."""
    now = time.perf_counter()
    dt, _LAP[0] = now - _LAP[0], now
    return dt


def _record_lap(laps, name) -> None:
    """Append (name, seconds since the previous lap) and print it."""
    laps.append((name, _lap()))
    print(f"  (phase {name}: {laps[-1][1]:.1f} s)", flush=True)


def _autograd_phases(smi, laps) -> dict:
    """Phases 36-39; returns phase 37's launch counts of kernels 5 and 6."""
    ad_worst = phase_autograd_replay()
    _record_lap(laps, '36')
    counts = phase_wavefront_trainer()
    _record_lap(laps, '37')
    phase_score_geometry_fd()
    _record_lap(laps, '38')
    phase_autograd_times(smi)
    _record_lap(laps, '39')
    counts["l_agree"] = ad_worst["l_agree"]
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import tpu_pathtracer_torch  # noqa: F401
    except ImportError as e:
        fail(f"tpu_pathtracer_torch is not importable here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_pathtracer_torch.utils.metrics import (
        AGREE, ATLAS_RTOL, ATOMIC_RTOL, BIN_TN_RTOL, L_TOL, PACKET_AGREE,
        PACKET_T_TOL, SIGN_Z,
    )

    _lap()
    laps = []
    smi = phase_environment()
    _record_lap(laps, '1')
    builds = phase_build()
    _record_lap(laps, '2')
    worst = phase_compare()
    _record_lap(laps, '3')
    launches, _, worst_main, _ = phase_main_path()
    _record_lap(laps, '4')
    phase_cli()
    _record_lap(laps, '5')
    times = phase_times(smi)
    _record_lap(laps, '6')
    worst_grad = phase_grad_compare()
    worst_limits = phase_grad_limits()
    for k in ("n_agree", "l_agree", "plane_agree"):
        worst_grad[k] = min(worst_grad[k], worst_limits[k])
    for k in ("max_abs_err", "sign_balance"):
        worst_grad[k] = max(worst_grad[k], worst_limits[k])
    _record_lap(laps, '7')
    grad_launches, _, worst_train = phase_trainer()
    _record_lap(laps, '8')
    phase_cli_invert()
    _record_lap(laps, '9')
    gtimes = phase_grad_times(smi)
    _record_lap(laps, '10')
    # the mesh slice: cornell_boxes, cornell_glass and cornell_quad
    m_worst = phase_compare(MESH_CASES, "11 mesh kernel vs plain")
    _record_lap(laps, '11')
    phase_cli("cornell-boxes", "12 mesh cli")
    _record_lap(laps, '12 cli')
    m_launches, m_walks, m_worst_main, _ = phase_main_path(
        "cornell-quad", (True,), budget=16, target=4,
        label="12 mesh main path")
    _record_lap(laps, '12 main')
    if m_walks != m_launches:
        fail(f"mesh main path: {m_walks} of {m_launches} launches walked a "
             "mesh")
    m_times = {name: phase_times(smi, name, "12 mesh times")
               for name in ("cornell-boxes", "cornell-quad")}
    _record_lap(laps, '12 times')
    m_worst_grad = phase_grad_compare(
        (("cornell-boxes", True), ("cornell-quad", True)),
        "13 mesh gradient kernel vs plain")
    _record_lap(laps, '13')
    m_grad_launches, m_grad_walks, m_worst_train = phase_trainer(
        "cornell-boxes", (True,), mat=0, steps=5,
        label="13 mesh trainer main path")
    _record_lap(laps, '13 trainer')
    if m_grad_walks != sum(m_grad_launches.values()):
        fail(f"mesh trainer: {m_grad_walks} of "
             f"{sum(m_grad_launches.values())} launches walked a mesh")
    m_gtimes = phase_grad_times(smi, "cornell-boxes", (True,),
                                "13 mesh gradient times")
    _record_lap(laps, '13 times')
    # the tangent kernel: camera-pose and IOR gradients
    j_worst = phase_jvp_compare()
    _record_lap(laps, '14')
    fd = phase_jvp_fd()
    _record_lap(laps, '15')
    j_launches, j_worst_main = phase_ior_trainer()
    _record_lap(laps, '16')
    j_times = phase_jvp_times(smi)
    _record_lap(laps, '16 times')
    # the wavefront slice: the packet and bin kernels
    p_worst = phase_packet_compare(smi)
    _record_lap(laps, '17-18')
    wf_launches, wf_renderer, wf_main = phase_wavefront_main(smi)
    _record_lap(laps, '19')
    wf_means = phase_wavefront_vs_persistent()
    _record_lap(laps, '20')
    wf_times = phase_wavefront_times(smi, wf_renderer)
    _record_lap(laps, '21')
    # thin-lens DOF and textures in the persistent kernels
    d_worst = phase_compare(DOF_CASES, "22 DOF kernel vs plain")
    _record_lap(laps, '22')
    d_launches, d_walks, d_worst_main = phase_dof_main()
    _record_lap(laps, '23')
    d_worst_grad = phase_grad_compare(
        (("cornell", False), ("cornell", True)),
        "24 DOF gradient kernel vs plain", lens=LENS)
    _record_lap(laps, '24')
    d_grad_launches, _, d_worst_train = phase_trainer(
        "cornell", (False, True), steps=5, label="24 DOF trainer main path",
        lens=LENS)
    _record_lap(laps, '24 trainer')
    t_worst = phase_compare(TEX_CASES, "25 textured kernel vs plain")
    _record_lap(laps, '25')
    t_launches, t_walks, t_worst_main, t_checks = phase_texture_main(smi)
    _record_lap(laps, '25 main')
    c4p = phase_c4_persistent(smi, wf_renderer, wf_times)
    _record_lap(laps, '26')
    d_times = phase_times(smi, "cornell", "27 DOF times", lens=LENS)
    _record_lap(laps, '27 lens')
    d_gtimes = phase_grad_times(smi, "cornell", (False, True),
                                "27 DOF gradient times", lens=LENS)
    _record_lap(laps, '27 lens gradient')
    t_times = {name: phase_times(smi, name, "27 texture times")
               for name in ("terrain32", "terrain32-bare")}
    _record_lap(laps, '27 texture')
    # texture-atlas gradients: kernel 3's TEX build and its scatter walk
    tg_worst = phase_tex_grad_compare()
    _record_lap(laps, '28')
    tg_counts, tg_worst_train = phase_tex_trainer()
    _record_lap(laps, '29')
    tg_chunked = phase_tex_chunked()
    _record_lap(laps, '30')
    tg_times = phase_tex_grad_times(smi)
    _record_lap(laps, '31')
    # the per-sample kernels: kernel 8 (pallas_render) and kernel 7 (the
    # engine="sample" trainer)
    s_worst = phase_trace_compare()
    _record_lap(laps, '32')
    s_launches, s_worst_main, s_tpu = phase_trace_main()
    _record_lap(laps, '33')
    r_worst = phase_replay_compare()
    _record_lap(laps, '34')
    r_launches, r_worst_main = phase_sample_trainer()
    _record_lap(laps, '35')
    s_times = phase_sample_times(smi)
    _record_lap(laps, '35 times')
    # the wavefront under autograd: replay, the XLA trainer, IOR and
    # geometry gradients
    ad_counts = _autograd_phases(smi, laps)
    # scenes, the host builder, checkpoints and the viewer
    sf = phase_sphere_field(smi)
    _record_lap(laps, '40')
    js = phase_json_scene()
    _record_lap(laps, '41')
    resumed = phase_resume(wf_renderer)
    _record_lap(laps, '42')
    trees = phase_bvh_trees(smi)
    _record_lap(laps, '43')
    viewer = phase_viewer()
    _record_lap(laps, '44')

    forward = {
        "name": "persistent_step",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/persistent.cu",
        "replaces": "tpu_pathtracer/ops/pallas/persistent.py:154",
        "launches": launches,
        "max_abs_err": max(worst["max_abs_err"], worst_main["max_abs_err"]),
        "ms": times["brute"]["kernel_ms"],
        "plain_ms": times["brute"]["plain_ms"],
        "bound_ms": times["brute"]["bound_ms"],
        "bound_by": times["brute"]["bound_by"],
        "library_ms": None,
        "tolerance": f">= {AGREE} of lanes: equal n_samp and "
                     f"|dL| < {L_TOL} * max(1, |L|)",
        "n_agree": min(worst["n_agree"], worst_main["n_agree"]),
        "l_agree": min(worst["l_agree"], worst_main["l_agree"]),
        "n_floor_main": worst_main["n_floor"],
        "l_floor_main": worst_main["l_floor"],
        "ms_nee": times["nee"]["kernel_ms"],
        "plain_ms_nee": times["nee"]["plain_ms"],
        "bound_ms_nee": times["nee"]["bound_ms"],
        "bound_by_nee": times["nee"]["bound_by"],
        "step_ms_brute": times["brute"]["step_ms"],
        "step_ms_nee": times["nee"]["step_ms"],
        "idle_share_brute": times["brute"]["idle_share"],
        "idle_share_nee": times["nee"]["idle_share"],
        "rays_per_s_brute": times["brute"]["rays_per_s"],
        "rays_per_s_nee": times["nee"]["rays_per_s"],
    }
    gradient = {
        "name": "persistent_replay_call",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/replay_persistent.cu",
        "replaces": "tpu_pathtracer/ops/pallas/replay_persistent.py:97",
        "launches": sum(grad_launches.values()),
        "max_abs_err": max(worst_grad["max_abs_err"],
                           worst_train["max_abs_err"]),
        "ms": gtimes["brute"]["kernel_ms"],
        "plain_ms": gtimes["brute"]["plain_ms"],
        "bound_ms": gtimes["brute"]["bound_ms"],
        "bound_by": gtimes["brute"]["bound_by"],
        "library_ms": None,
        "tolerance": f">= {AGREE} of lanes: equal n_samp, |dx| < {L_TOL} * "
                     f"max(1, |x|) on L and every GA/GI plane; fold over "
                     f"agreeing lanes: loss rtol {LOSS_RTOL}, gradients "
                     f"rtol {GRAD_RTOL}; of the n lanes that differ on an "
                     f"output, one sign in excess by <= {IMAGE_Z} * "
                     f"sqrt(n)",
        "n_agree": min(worst_grad["n_agree"], worst_train["n_agree"]),
        "l_agree": min(worst_grad["l_agree"], worst_train["l_agree"]),
        "plane_agree": min(worst_grad["plane_agree"],
                           worst_train["plane_agree"]),
        "floor_main": worst_train["floor"],
        "sign_balance": max(worst_grad["sign_balance"],
                            worst_train["sign_balance"]),
        "ms_nee": gtimes["nee"]["kernel_ms"],
        "plain_ms_nee": gtimes["nee"]["plain_ms"],
        "bound_ms_nee": gtimes["nee"]["bound_ms"],
        "bound_by_nee": gtimes["nee"]["bound_by"],
        "grad_ms_brute": gtimes["brute"]["grad_ms"],
        "grad_ms_nee": gtimes["nee"]["grad_ms"],
        "rays_per_s_brute": gtimes["brute"]["rays_per_s"],
        "rays_per_s_nee": gtimes["nee"]["rays_per_s"],
        "idle_share_brute": gtimes["brute"]["idle_share"],
        "idle_share_nee": gtimes["nee"]["idle_share"],
    }
    # the mesh slice, per kernel: both main paths' launches, the mesh
    # checks' worst numbers, and the times per mesh scene and mode
    forward.update(
        launches=launches + m_launches, launches_sphere_path=launches,
        launches_mesh_path=m_launches,
        n_agree_mesh=min(m_worst["n_agree"], m_worst_main["n_agree"]),
        l_agree_mesh=min(m_worst["l_agree"], m_worst_main["l_agree"]),
        n_floor_mesh_main=m_worst_main["n_floor"],
        l_floor_mesh_main=m_worst_main["l_floor"],
        max_abs_err_mesh=max(m_worst["max_abs_err"],
                             m_worst_main["max_abs_err"]),
        sign_balance_mesh=m_worst["sign_balance"])
    for name, t in m_times.items():
        for mode, o in t.items():
            key = f"{name.replace('-', '_')}_{mode}"
            forward.update({
                f"ms_{key}": o["kernel_ms"], f"plain_ms_{key}": o["plain_ms"],
                f"bound_ms_{key}": o["bound_ms"],
                f"bound_by_{key}": o["bound_by"],
                f"step_ms_{key}": o["step_ms"],
                f"idle_share_{key}": o["idle_share"],
                f"rays_per_s_{key}": o["rays_per_s"]})
    mg = m_gtimes["nee"]
    gradient.update(
        launches=sum(grad_launches.values()) + sum(m_grad_launches.values()),
        launches_sphere_path=sum(grad_launches.values()),
        launches_mesh_path=sum(m_grad_launches.values()),
        n_agree_mesh=min(m_worst_grad["n_agree"], m_worst_train["n_agree"]),
        l_agree_mesh=min(m_worst_grad["l_agree"], m_worst_train["l_agree"]),
        plane_agree_mesh=min(m_worst_grad["plane_agree"],
                             m_worst_train["plane_agree"]),
        max_abs_err_mesh=max(m_worst_grad["max_abs_err"],
                             m_worst_train["max_abs_err"]),
        sign_balance_mesh=max(m_worst_grad["sign_balance"],
                              m_worst_train["sign_balance"]),
        ms_cornell_boxes_nee=mg["kernel_ms"],
        plain_ms_cornell_boxes_nee=mg["plain_ms"],
        bound_ms_cornell_boxes_nee=mg["bound_ms"],
        bound_by_cornell_boxes_nee=mg["bound_by"],
        grad_ms_cornell_boxes_nee=mg["grad_ms"],
        rays_per_s_cornell_boxes_nee=mg["rays_per_s"],
        idle_share_cornell_boxes_nee=mg["idle_share"])
    # this slice: the lens and texture main paths, config 4 persistent
    forward.update(
        launches=forward["launches"] + d_launches + t_launches
        + c4p["launches"],
        launches_dof_path=d_launches, launches_texture_path=t_launches,
        launches_config4_path=c4p["launches"],
        n_agree_dof=min(d_worst["n_agree"], d_worst_main["n_agree"]),
        l_agree_dof=min(d_worst["l_agree"], d_worst_main["l_agree"]),
        n_floor_dof_main=d_worst_main["n_floor"],
        l_floor_dof_main=d_worst_main["l_floor"],
        max_abs_err_dof=max(d_worst["max_abs_err"],
                            d_worst_main["max_abs_err"]),
        sign_balance_dof=d_worst["sign_balance"],
        n_agree_texture=min(t_worst["n_agree"], t_worst_main["n_agree"]),
        l_agree_texture=min(t_worst["l_agree"], t_worst_main["l_agree"]),
        max_abs_err_texture=max(t_worst["max_abs_err"],
                                t_worst_main["max_abs_err"]),
        sign_balance_texture=t_worst["sign_balance"],
        checker_red_cyan=[t_checks["red"], t_checks["cyan"]],
        terrain32_mean_wavefront_persistent=[t_checks["wavefront"],
                                             t_checks["persistent"]],
        config4_ms_to_2spp=c4p["ms_to_spp"],
        config4_wavefront_frame_ms=c4p["wavefront_frame_ms"],
        config4_kernel_ms=c4p["kernel_ms"],
        config4_bound_ms=c4p["bound_ms"],
        config4_bound_by=c4p["bound_by"],
        config4_idle_share=c4p["idle_share"],
        config4_mean_persistent_wavefront=[c4p["mean"],
                                           c4p["wavefront_mean"]],
        n_agree_config4_bands=c4p["worst"]["n_agree"],
        l_agree_config4_bands=c4p["worst"]["l_agree"],
        n_floor_config4_bands=c4p["worst"]["n_floor"],
        l_floor_config4_bands=c4p["worst"]["l_floor"],
        max_abs_err_config4_bands=c4p["worst"]["max_abs_err"])
    for key, t in (("lens", d_times), ("terrain32", t_times["terrain32"]),
                   ("terrain32_bare", t_times["terrain32-bare"])):
        for mode, o in t.items():
            forward.update({
                f"ms_{key}_{mode}": o["kernel_ms"],
                f"plain_ms_{key}_{mode}": o["plain_ms"],
                f"bound_ms_{key}_{mode}": o["bound_ms"],
                f"bound_by_{key}_{mode}": o["bound_by"],
                f"step_ms_{key}_{mode}": o["step_ms"],
                f"idle_share_{key}_{mode}": o["idle_share"],
                f"rays_per_s_{key}_{mode}": o["rays_per_s"]})
    gradient.update(
        launches=gradient["launches"] + sum(d_grad_launches.values()),
        launches_dof_path=sum(d_grad_launches.values()),
        n_agree_dof=min(d_worst_grad["n_agree"], d_worst_train["n_agree"]),
        l_agree_dof=min(d_worst_grad["l_agree"], d_worst_train["l_agree"]),
        plane_agree_dof=min(d_worst_grad["plane_agree"],
                            d_worst_train["plane_agree"]),
        max_abs_err_dof=max(d_worst_grad["max_abs_err"],
                            d_worst_train["max_abs_err"]),
        sign_balance_dof=max(d_worst_grad["sign_balance"],
                             d_worst_train["sign_balance"]))
    for mode, o in d_gtimes.items():
        gradient.update({f"ms_lens_{mode}": o["kernel_ms"],
                         f"plain_ms_lens_{mode}": o["plain_ms"],
                         f"bound_ms_lens_{mode}": o["bound_ms"],
                         f"bound_by_lens_{mode}": o["bound_by"],
                         f"grad_ms_lens_{mode}": o["grad_ms"],
                         f"idle_share_lens_{mode}": o["idle_share"]})
    # texture-atlas gradients: launch 1 (TEX, C_tot records) of the textured
    # trainer's main path, its checks and times
    gradient.update(
        launches=gradient["launches"] + tg_counts["launches"]
        - tg_counts["scatter"],
        launches_texture_path=tg_counts["launches"] - tg_counts["scatter"],
        n_agree_texture=min(tg_worst["n_agree"], tg_worst_train["n_agree"]),
        l_agree_texture=min(tg_worst["l_agree"], tg_worst_train["l_agree"]),
        plane_agree_texture=min(tg_worst["plane_agree"],
                                tg_worst_train["plane_agree"]),
        max_abs_err_texture=max(tg_worst["max_abs_err"],
                                tg_worst_train["max_abs_err"]),
        sign_balance_texture=max(tg_worst["sign_balance"],
                                 tg_worst_train["sign_balance"]),
        ms_terrain32_textured_nee=tg_times["ms1"],
        plain_ms_terrain32_textured_nee=tg_times["plain1_ms"],
        bound_ms_terrain32_textured_nee=tg_times["bound1_ms"],
        bound_by_terrain32_textured_nee=tg_times["bound1_by"],
        grad_ms_terrain32_textured_nee=tg_times["grad_ms"],
        grad_ms_terrain32_no_atlas_nee=tg_times["grad_ms_no_atlas"],
        idle_share_terrain32_textured_nee=tg_times["idle_share"])
    scatter = {
        "name": "persistent_replay_call (phase scatter)",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/replay_persistent.cu",
        "replaces": "tpu_pathtracer/ops/pallas/replay_persistent.py:1478",
        "launches": tg_counts["scatter"],
        "max_abs_err": max(tg_worst["atlas_abs_err"],
                           tg_worst_train["atlas_abs_err"]),
        "ms": tg_times["ms2"],
        "plain_ms": tg_times["plain2_ms"],
        "bound_ms": tg_times["bound2_ms"],
        "bound_by": tg_times["bound2_by"],
        "library_ms": None,
        "tolerance": f"replayed L and n_samp equal to launch 1's on every "
                     f"lane; with the cotangent zeroed where kernel and "
                     f"plain walks disagree, |dgT| <= {ATLAS_RTOL} * "
                     f"max|gT|; two scatters of the same inputs within "
                     f"{ATOMIC_RTOL} * (the scatter of |g|) per cell",
        "atlas_gap": max(tg_worst["atlas_gap"], tg_worst_train["atlas_gap"]),
        "atomic_ratio": max(tg_worst["atomic_ratio"],
                            tg_worst_train["atomic_ratio"]),
        "chunked_vs_plain": tg_chunked,
        "idle_share_terrain32_nee": tg_times["idle_share"],
        "note": "the second launch of kernel 3 (replay_scatter_kernel): "
                "the walk of launch 1 replayed on the same draws, adding "
                "the atlas gradient into its four bilinear taps with float "
                "atomics; launches are the textured trainer's 5 steps "
                "(phase 29); ms, plain_ms and bound_ms on terrain32 "
                "640x480 spp 4 NEE (phase 31; the walk's tests counted on "
                "the mesh's leaf-<=4 tree by bvh_walk_ref on a sample of "
                "the segments)",
    }
    boxes = m_times["cornell-boxes"]["brute"]
    textured = t_times["terrain32"]["nee"]
    walk = {
        "name": "mesh_walk",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/pt_common.cuh",
        "replaces": "tpu_pathtracer/ops/pallas/_walk.py:22",
        "launches": m_walks + m_grad_walks + d_walks + t_walks
        + c4p["walks"] + tg_counts["mesh"],
        "max_abs_err": max(forward["max_abs_err_mesh"],
                           gradient["max_abs_err_mesh"],
                           forward["max_abs_err_texture"],
                           forward["max_abs_err_config4_bands"]),
        "ms": boxes["kernel_ms"],
        "plain_ms": boxes["plain_ms"],
        "bound_ms": boxes["walk_bound_ms"],
        "bound_by": boxes["walk_bound_by"],
        "library_ms": None,
        "ms_textured_nee": textured["kernel_ms"],
        "plain_ms_textured_nee": textured["plain_ms"],
        "bound_ms_textured_nee": textured["walk_bound_ms"],
        "bound_by_textured_nee": textured["walk_bound_by"],
        "note": "bvh_walk, a __device__ function inside persistent_step "
                "and persistent_replay_call (and the tangent walk), with no "
                "launch of its own: launches are those of the persistent "
                "kernels (the scatter walk included) on mesh scenes in the "
                "mesh main paths (the lens, textured, config-4 and "
                "textured-trainer paths included); ms and plain_ms are "
                "those of the cornell_boxes brute-force forward launch "
                "that runs it, bound_ms the walk's own part of that "
                "launch (the box and triangle tests that the mesh's "
                "leaf-<=4 tree needs on its segments, counted by "
                "bvh_walk_ref on a sample of them, and the bytes of the "
                "tree the kernels walk), the *_textured_* "
                "keys the same for terrain32 NEE with the uv tracked; "
                "held against the plain versions' mesh_walk_ref through "
                "the persistent kernels' mesh checks",
    }
    main_t = j_times["ior_cornell_nee"]
    jvp = {
        "name": "camera_jvp_call",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/camera_jvp.cu",
        "replaces": "tpu_pathtracer/ops/pallas/camera_jvp.py:64",
        "launches": j_launches,
        "max_abs_err": max(j_worst["max_abs_err"],
                           j_worst_main["max_abs_err"]),
        "ms": main_t["kernel_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "tolerance": f">= {AGREE} of lanes: equal n_samp, |dx| < {L_TOL} * "
                     f"max(1, |x|) on L and every dL plane; of the n lanes "
                     f"that differ on an output, one sign in excess by <= "
                     f"{IMAGE_Z} * sqrt(n)",
        "n_agree": min(j_worst["n_agree"], j_worst_main["n_agree"]),
        "l_agree": min(j_worst["l_agree"], j_worst_main["l_agree"]),
        "plane_agree": min(j_worst["plane_agree"],
                           j_worst_main["plane_agree"]),
        "floor": min((x for x in (j_worst["floor"], j_worst_main["floor"])
                      if x is not None), default=None),
        "sign_balance": max(j_worst["sign_balance"],
                            j_worst_main["sign_balance"]),
        "finite_differences": fd,
        "note": "ms, plain_ms and bound_ms are those of the main path's "
                "workload, the full mat_coef gradient on cornell_spheres "
                "NEE at config 5; the *_pos_* keys time the camera "
                "position's gradient",
    }
    for key, o in j_times.items():
        jvp.update({f"ms_{key}": o["kernel_ms"],
                    f"plain_ms_{key}": o["plain_ms"],
                    f"bound_ms_{key}": o["bound_ms"],
                    f"bound_by_{key}": o["bound_by"],
                    f"grad_ms_{key}": o["grad_ms"],
                    f"idle_share_{key}": o["idle_share"]})
    two, one = wf_times["two_pass"], wf_times["single_pass"]
    full = [two["held"], one["held"]]  # every wave of a main-path frame
    packet = {
        "name": "packet_query",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/packet.cu",
        "replaces": "tpu_pathtracer/ops/pallas/mesh_kernel.py:325",
        "launches": wf_launches["packet"],
        "launches_autograd_trainer": ad_counts["remat"][0],
        "max_abs_err": max([p_worst["twin_max_abs_err"]]
                           + [h["max_abs_err"] for h in full]),
        "ms": two["packet_ms"],
        "plain_ms": two["packet_plain_ms"],
        "bound_ms": two["packet_bound_ms"],
        "bound_by": two["packet_bound_by"],
        "library_ms": None,
        "tree": "pack_bvh's (the mesh's own tree, leaves of <= 4 "
                "triangles, one leaf for <= 40), walked per thread through "
                "the wave's permutation",
        "tolerance": f"against packet_bvh_ref (its plain version, the same "
                     f"tree) and against packet_ref (the 64-leaf tree, the "
                     f"TPU kernel's contract, by MeshData triangle id): >= "
                     f"{PACKET_AGREE} of lanes with equal hit/miss and "
                     f"triangle (any-hit: equal occlusion), |dt| <= "
                     f"{PACKET_T_TOL} * max(1, t), n/uv/mat equal where the "
                     f"triangles agree; of the n lanes that differ, one "
                     f"sign of dt in excess by <= {SIGN_Z} * sqrt(n); the "
                     f"permuted launch equal bit for bit to a launch on the "
                     f"permuted rays",
        "agree": p_worst["twin_agree"],
        "bit_equal": p_worst["twin_bit_equal"],
        "agree_packet_ref": p_worst["agree"],
        "sign_balance_packet_ref": p_worst["sign"],
        "max_abs_err_packet_ref": p_worst["max_abs_err"],
        "agree_full_waves": min(h["agree"] for h in full),
        "bit_equal_full_waves": min(h["bit_equal"] for h in full),
        "sign_balance_full_waves": max(h["sign"] for h in full),
        "agree_full_waves_packet_ref": min(h["agree_64"] for h in full),
        "sign_balance_full_waves_packet_ref": max(h["sign_64"]
                                                  for h in full),
        "two_pass_vs_single_pass": p_worst["two_vs_one"],
        "main_path_frame_vs_plain_px": wf_main["px_agree"],
        "launches_per_frame": two["packet_per_frame"],
        "frame_ms_two_pass": two["frame_ms"],
        "frame_ms_single_pass": one["frame_ms"],
        "idle_share_two_pass": two["idle_share"],
        "idle_share_single_pass": one["idle_share"],
        "ms_single_pass": one["packet_ms"],
        "plain_ms_single_pass": one["packet_plain_ms"],
        "bound_ms_single_pass": one["packet_bound_ms"],
        "bound_by_single_pass": one["packet_bound_by"],
        "plain_ms_packet_ref": two["packet_plain_64_ms"],
        "bound_ms_64_leaf_tree": two["packet_bound_64_ms"],
        "bound_by_64_leaf_tree": two["packet_bound_64_by"],
        "sort_ms_per_frame_two_pass": two["sort_ms_per_frame"],
        "gather_ms_per_frame_two_pass": two["gather_ms_per_frame"],
        "sort_ms_per_frame_single_pass": one["sort_ms_per_frame"],
        "gather_ms_per_frame_single_pass": one["gather_ms_per_frame"],
        "wavefront_mean": wf_means[0],
        "persistent_mean": wf_means[1],
        "note": "ms, plain_ms (packet_bvh_ref) and bound_ms are per wave of "
                "the main path, config 4 (terrain 1024x1024, 2 spp, 3 "
                "bounces, NEE) through the two-pass traversal, averaged "
                "over a frame's closest-hit and shadow waves; the bound "
                "counts the leaf-<=4 tree's box and triangle tests on the "
                "waves' own rays and the bytes the query needs (t_init and "
                "the permutation per lane, origin and direction per live "
                "lane, 32 B of answers per closest-hit lane and t alone per "
                "shadow lane) plus the tree; launches are the main path's "
                "4 frames",
    }
    binning = {
        "name": "bin_rays",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/bin.cu",
        "replaces": "tpu_pathtracer/ops/pallas/mesh_kernel.py:746",
        "launches": wf_launches["bin"],
        "launches_autograd_trainer": ad_counts["remat"][1],
        "max_abs_err": max(p_worst["bin_abs_err"], two["held"]["bin_abs_err"]),
        "ms": two["bin_ms"],
        "plain_ms": two["bin_plain_ms"],
        "bound_ms": two["bin_bound_ms"],
        "bound_by": two["bin_bound_by"],
        "library_ms": None,
        "tolerance": "cell, tn and sort key bit for bit against both "
                     "plain versions (bin_rays_ref, bin_tree_ref) on every "
                     f"lane (the bars: >= {PACKET_AGREE} of lanes, tn "
                     f"within {BIN_TN_RTOL} relative)",
        "agree": p_worst["bin_agree"],
        "tn_rel_err": p_worst["bin_tn_err"],
        "agree_full_waves": two["held"]["bin_agree"],
        "tn_rel_err_full_waves": two["held"]["bin_tn_err"],
        "launches_per_frame": two["bin_per_frame"],
        "cells": two["cells"],
        "tests_per_live_ray": two["bin_tests_per_ray"],
        "note": "per wave of the main path (config 4, two-pass); the "
                "bound counts the coarse-tree walk's node and cell tests "
                "and the bytes the launch needs (t_init, cell, tn and key "
                "per lane, origin and direction per live lane) plus the "
                "walk table; the single-pass traversal launches no bin "
                "kernel",
    }
    tb, tn = s_times["brute"]["trace"], s_times["nee"]["trace"]
    trace = {
        "name": "trace_kernel",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/trace.cu",
        "replaces": "tpu_pathtracer/ops/pallas/trace_kernel.py:98",
        "launches": s_launches,
        "max_abs_err": max(s_worst["max_abs_err"],
                           s_worst_main["max_abs_err"]),
        "ms": tb["kernel_ms"],
        "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"],
        "library_ms": None,
        "tolerance": f">= {AGREE} of lanes within {L_TOL} * max(1, |L|) "
                     f"(or the plain version's CPU-vs-card floor), rays "
                     f"within {RAY_TOL}; of the n lanes that differ, one "
                     f"sign in excess by <= {IMAGE_Z} * sqrt(n)",
        "l_agree": min(s_worst["l_agree"], s_worst_main["l_agree"]),
        "floor": min((x for x in (s_worst["floor"], s_worst_main["floor"])
                      if x is not None), default=None),
        "sign_balance": max(s_worst["sign_balance"],
                            s_worst_main["sign_balance"]),
        "ms_nee": tn["kernel_ms"], "plain_ms_nee": tn["plain_ms"],
        "bound_ms_nee": tn["bound_ms"], "bound_by_nee": tn["bound_by"],
        "call_ms_brute": tb["call_ms"], "call_ms_nee": tn["call_ms"],
        "idle_share_brute": tb["idle_share"],
        "idle_share_nee": tn["idle_share"],
        "tpu_only_tests": s_tpu,
        "note": "ms, plain_ms and bound_ms at the main path's shapes "
                "(pallas_render on cornell 640x480, spp 4, 10 bounces, "
                "brute force; *_nee with NEE); launches are phase 33's "
                "main path",
    }
    rb, rn = s_times["brute"]["replay"], s_times["nee"]["replay"]
    replay = {
        "name": "replay_kernel",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/replay.cu",
        "replaces": "tpu_pathtracer/ops/pallas/replay_kernel.py:61",
        "launches": sum(r_launches.values()),
        "max_abs_err": max(r_worst["max_abs_err"],
                           r_worst_main["max_abs_err"]),
        "ms": rb["kernel_ms"],
        "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"],
        "bound_by": rb["bound_by"],
        "library_ms": None,
        "tolerance": f">= {AGREE} of lanes within {L_TOL} * max(1, |L|) "
                     f"(or the CPU-vs-card floor), rays within {RAY_TOL}; "
                     f"mode mse equal to the fold of its own lanes (rtol "
                     f"{FOLD_RTOL}); over the agreeing pixels, loss rtol "
                     f"{LOSS_RTOL} and gradients rtol {GRAD_RTOL} against "
                     f"the plain version; the sign test",
        "l_agree": min(r_worst["l_agree"], r_worst_main["l_agree"]),
        "floor": min((x for x in (r_worst["floor"], r_worst_main["floor"])
                      if x is not None), default=None),
        "sign_balance": max(r_worst["sign_balance"],
                            r_worst_main["sign_balance"]),
        "ms_nee": rn["kernel_ms"], "plain_ms_nee": rn["plain_ms"],
        "bound_ms_nee": rn["bound_ms"], "bound_by_nee": rn["bound_by"],
        "grad_ms_brute": rb["call_ms"], "grad_ms_nee": rn["call_ms"],
        "idle_share_brute": rb["idle_share"],
        "idle_share_nee": rn["idle_share"],
        "note": "ms, plain_ms and bound_ms at config 5 "
                "(mse_value_and_grad on cornell 640x480, spp 4, 10 bounces, "
                "brute force; *_nee with NEE); launches are phase 35's "
                "trainer (target + 5 steps per mode)",
    }
    # this slice: sphere-field, the JSON scene through the CLI, resume and
    # the viewer (the launches of their runs, not of the comparisons)
    sft = sf["times"]
    forward.update(
        launches=forward["launches"] + sf["launches"] + js["k1"]
        + resumed["k1"] + viewer["pallas"]["launches"],
        launches_sphere_field_path=sf["launches"],
        launches_json_scene_cli=js["k1"], launches_resume=resumed["k1"],
        launches_viewer=viewer["pallas"]["launches"],
        n_agree_sphere_field=sf["worst"]["n_agree"],
        l_agree_sphere_field=sf["worst"]["l_agree"],
        n_floor_sphere_field=sf["worst"]["n_floor"],
        l_floor_sphere_field=sf["worst"]["l_floor"],
        max_abs_err_sphere_field=sf["worst"]["max_abs_err"],
        sign_balance_sphere_field=sf["worst"]["sign_balance"],
        n_agree_json_scene=js["worst"]["n_agree"],
        l_agree_json_scene=js["worst"]["l_agree"],
        resume_bit_exact=True,
        viewer_frames_per_s={b: o["fps"] for b, o in viewer.items()},
        bvh_trees_sah_median=trees)
    for mode, o in sft.items():
        forward.update({
            f"ms_sphere_field_{mode}": o["kernel_ms"],
            f"plain_ms_sphere_field_{mode}": o["plain_ms"],
            f"bound_ms_sphere_field_{mode}": o["bound_ms"],
            f"bound_by_sphere_field_{mode}": o["bound_by"],
            f"step_ms_sphere_field_{mode}": o["step_ms"],
            f"idle_share_sphere_field_{mode}": o["idle_share"],
            f"rays_per_s_sphere_field_{mode}": o["rays_per_s"]})
    for entry, k, extra in ((packet, "k5", dict(
            agree_json_scene_packet_ref=js["packet"]["agree"])),
                            (binning, "k6", dict(
            agree_json_scene=js["bin_agree"]))):
        entry.update(launches=entry["launches"] + js[k] + resumed[k],
                     launches_json_scene_cli=js[k],
                     launches_resume=resumed[k], **extra)
    packet["max_abs_err"] = max(packet["max_abs_err"],
                                js["packet"]["max_abs_err"])
    binning["max_abs_err"] = max(binning["max_abs_err"], js["bin_abs_err"])
    print(f"[slice checks] sphere-field {sf['launches']} launches held to "
          f"the plain version (n {sf['worst']['n_agree']:.4f} L "
          f"{sf['worst']['l_agree']:.4f}, sign balance "
          f"{sf['worst']['sign_balance']:.3f}); json scene through cli "
          f"render, pallas {js['k1']} launches, xla {js['k5']} + {js['k6']}; "
          f"resume bit for bit on kernel 1 and the config-4 wavefront; "
          f"viewer " + ", ".join(f"{b} {o['fps']:.2f} frames/s"
                                 for b, o in viewer.items()), flush=True)
    for entry, kernel in ((forward, "persistent_kernel"),
                          (gradient, "replay_persistent_kernel"),
                          (scatter, "replay_scatter_kernel"),
                          (jvp, "camera_jvp_kernel"),
                          (packet, "packet_kernel"), (binning, "bin_kernel"),
                          (trace, "trace_kernel"), (replay, "replay_kernel")):
        entry["ptxas"] = {k: v for k, v in builds.items()
                          if k.split("<")[0] == kernel}
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in laps)
          + f"; total {sum(v for _, v in laps):.1f}; the script "
          f"{time.perf_counter() - _START:.1f} s since it started",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": [forward, gradient, scatter, walk, jvp,
                                  packet, binning, trace, replay]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="CHECKOUT",
                    help="instead of the smoke run, time the persistent "
                    "kernels and kernel 5 per launch against another "
                    "checkout's (ab)")
    ap.add_argument("--ab-worker", help=argparse.SUPPRESS)
    ap.add_argument("--ab-atlas", help=argparse.SUPPRESS)
    ap.add_argument("--ab-waves", help=argparse.SUPPRESS)
    ap.add_argument("--ab-answers", help=argparse.SUPPRESS)
    ap.add_argument("--ab-trace", help=argparse.SUPPRESS)
    ap.add_argument("--ab-only", default=",".join(AB_PARTS),
                    help="with --ab, the parts to time, comma-separated, of "
                    + ", ".join(AB_PARTS) + " (default: all)")
    ap.add_argument("--leaf-cutoff", action="store_true",
                    help="instead of the smoke run, time the forward kernel "
                    "on small meshes as one leaf and as a tree "
                    "(leaf_cutoff)")
    args = ap.parse_args()
    only = tuple(args.ab_only.split(","))
    if not set(only) <= set(AB_PARTS):
        ap.error(f"--ab-only takes parts of {AB_PARTS}, got {only}")
    if args.ab_worker:
        print(json.dumps(ab_worker(args.ab_worker, args.ab_atlas,
                                   args.ab_waves, args.ab_answers, only,
                                   args.ab_trace)))
        sys.exit(0)
    if args.leaf_cutoff:
        sys.exit(leaf_cutoff())
    sys.exit(ab(args.ab, only) if args.ab else main())
