"""Persistent fused value-and-grad walk: CUDA kernel wrapper and plain version.

Counterpart of ``tpu_pathtracer/ops/pallas/replay_persistent.py``, whole:
phases ``"both"``, ``"adjoint"`` and ``"scatter"``. One launch walks
``budget`` wavefront iterations of the persistent regeneration schedule
(lane == pixel; a dead lane starts its pixel's next stratified sample while
it has completed fewer than ``spp``) and carries the streaming adjoint of
every path: per path, ``nA_m`` / ``cA_m`` per material and ``cI_l`` per
light, flushed at path completion into per-lane accumulators

    GA_m += C_tot * nA_m - cA_m        GI_l += cI_l

so that ``dLoss/dA_m = sum_lanes g * GA_m / A_m`` and ``dLoss/dI_l = sum_lanes
g * GI_l / I_l`` with the lane-local MSE cotangent ``g``. Paths still in
flight at the end of the launch enter neither the loss nor the gradient.

``persistent_replay_call`` launches the CUDA kernel
(``csrc/replay_persistent.cu``) for tensors on a CUDA device and runs
``persistent_replay_ref``, the plain PyTorch version, for tensors on the CPU.
There is no fallback between the two.

Randomness, as in ``persistent.py``: test mode takes the JAX kernel's
external uniform block ``(n_tiles, budget, n_draw, tile_rows, 128)``
flattened (the JAX side draws it under ``jax.random.key(2)``); production
mode draws Philox4x32-10 keyed on (seed, salt), countered on (global lane,
iteration, wavefront step, ``STREAM | draw group``). The stream tag keeps a
gradient walk from replaying a forward render's paths.

Mesh scenes (packed by ``models/scene.py::with_packet_mesh``) walk the mesh
in-kernel as the forward step does; a mesh vertex routes its adjoint to its
material's slot, and a TRI_LIGHT's emission and NEE credit its intensity
adjoint. ``use_dof`` regenerates paths through the thin lens, as the
forward step does.

Texture-atlas gradients take two launches, as in the JAX package. A
textured material's colour is multiplied by the bilinear texel, so every
factor at a textured vertex b is linear in the texel and

    dC_tot/dT[tap] = sum_b w_tap(b) / texel_b * (ok_b (C_tot - C_b) + nee_b)

with C_b the path radiance after the vertex's emission and NEE. Launch 1
(``record_ct``) records each completed path's C_tot in slot k = its sample
index (3 * spp planes); launch 2 (phase ``"scatter"``) replays the same
schedule on the same draws and, at every textured vertex of a path that
completed in launch 1, adds the bracket times the lane-local cotangent into
the four bilinear taps of an atlas-shaped ``(K, TH, TW, 3)`` gradient, the
final dLoss/dtextures. ``compute_tex_grad=False`` turns both off (a forward
target). ``chunked_mse_value_and_grad`` splits spp > 32 into chunks of 32
samples, as the JAX driver does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, EPSILON, SPECULAR, TRANSMISSIVE, Scene,
)
from tpu_pathtracer_torch.ops.kernels.persistent import (
    _MASK, _check, _f32_add, _f32_div, camera_rays, dot3_fma,
    emitter_light_pdf, fma, mesh_arguments, mesh_merge, mesh_occluded,
    n_draws, packed_mesh, pack_materials, pack_tri_lights, philox_uniforms,
    sample_light, sample_lobe, split_draws, tex_route, texel_taps,
    texture_arguments, tri_emitter_pdf,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (
    BIG, INV_PI, LANES, pack_camera, pack_lights, pack_prims,
)
from tpu_pathtracer_torch.ops.vecmath import dot3

STREAM = 0x10000  # Philox stream tag of this kernel's draws
MAX_PRIMS = 256  # sizes of the kernel's __constant__ tables
MAX_SLOTS = 16  # materials on a surface (prims or mesh triangles)
MAX_GRAD_LIGHTS = 16
MAX_MATS = 256
# Samples per textured-gradient launch: the JAX kernel keeps 3 * spp C_tot
# planes in VMEM and caps spp at 32; the port keeps the cap, because it
# decides which samples the chunked driver draws (chunked_mse_value_and_grad)
MAX_TEX_SPP = 32
# Shared memory a block may take on the H100 (227 KB, with the opt-in)
SMEM_PER_BLOCK = 232_448

# Kernel launches by persistent_replay_call (plain-version calls are not
# counted; a textured gradient is two launches), those of them on a mesh
# scene, and the scatter launches (phase "scatter", launch 2) among them.
launches = 0
mesh_launches = 0
scatter_launches = 0


def replay_smem_bytes(n_slots: int, n_lights: int, *,
                      scatter: bool = False) -> int:
    """Bytes of shared memory that one 128-lane block of the gradient kernel
    takes (``csrc/replay_persistent.cu::smem_bytes``): per lane, in launch 1
    the adjoint (7 words per slot: nA, cA, GA; 3 per light: GI) and the
    radiance sums, in the scatter walk the radiance sums; in launch 1 also
    the epilogue's four warp sums per partial (3 per slot, 3 per light, the
    loss). Raises ValueError past SMEM_PER_BLOCK."""
    words = (LANES * 3 if scatter else
             LANES * (7 * n_slots + 3 * n_lights + 3)
             + 4 * (3 * n_slots + 3 * n_lights + 1))
    if 4 * words > SMEM_PER_BLOCK:
        raise ValueError(
            f"the gradient kernel's block needs {4 * words} B of shared "
            f"memory for {n_slots} slots and {n_lights} lights; a block may "
            f"take {SMEM_PER_BLOCK} B")
    return 4 * words


def blocks_per_sm(n_slots: int, n_lights: int, *, mesh: bool, tex: bool,
                  dof: bool, scatter: bool = False) -> tuple[int, int]:
    """(bytes of shared memory per block, blocks per SM) of one build of the
    kernel for a scene of ``n_slots`` slots and ``n_lights`` lights, as the
    card's occupancy calculator gives them (needs the card)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    fn = _build.load_library().tpt_replay_occupancy
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    n = fn(int(mesh), int(tex), int(dof), int(scatter), n_slots, n_lights)
    if n < 0:
        raise RuntimeError("the gradient kernel's occupancy query failed")
    return replay_smem_bytes(n_slots, n_lights, scatter=scatter), n


def pixel_lanes_layout(width: int, height: int, tile_rows: int = 32,
                       tiles_multiple: int = 1) -> tuple[int, int]:
    """(rows_total, n_lanes) for the lane == pixel layout."""
    n_lanes = width * height
    tile_lanes = tile_rows * LANES
    n_tiles = -(-n_lanes // tile_lanes)
    n_tiles = -(-n_tiles // tiles_multiple) * tiles_multiple
    return n_tiles * tile_rows, n_lanes


def target_to_lanes(img: Tensor, rows_total: int) -> Tensor:
    """(H, W, 3) -> (rows_total, LANES, 3) in the lane == pixel layout."""
    flat = img.reshape(-1, 3).to(torch.float32)
    pad = rows_total * LANES - flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    return flat.reshape(rows_total, LANES, 3).contiguous()


def default_budget(spp: int, max_bounces: int) -> int:
    """Wavefront iterations per launch: enough to drain spp paths per pixel
    in practice (at config 5 a path is 3.79 segments on average on
    cornell_spheres, 3.66-3.72 on the Cornell meshes and 1.69 on
    terrain_textured(32), RR after bounce 3; the rest is slack for the
    tail: chip_smoke.py's ``[replay live share]``). Undrained paths are
    excluded from both the loss and the gradient, so correctness does not
    depend on it."""
    return spp * 4 + max_bounces


def material_slots(scene: Scene) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(slot_mats, prim_slot): the materials that carry prims or mesh
    triangles, in id order, and each prim's index among them. Only these
    get an adjoint: a material on no surface has GA == 0."""
    mids = tuple(scene.prim_material_ids)
    slot_mats = tuple(sorted(set(mids) | set(scene.mesh_mats_static)))
    return slot_mats, tuple(slot_mats.index(m) for m in mids)


def _check_route(scene: Scene, phase: str, spp: int, compute_tex_grad: bool,
                 ext: tuple) -> bool:
    """Validate the call; returns whether it makes atlas gradients."""
    if phase not in ("both", "adjoint", "scatter"):
        raise ValueError(f"unknown phase {phase!r}")
    tex_grad = compute_tex_grad and tex_route(scene)
    if tex_grad and spp > MAX_TEX_SPP:
        raise ValueError(
            "textured-atlas gradients record per-path totals in 3*spp lane "
            f"planes; spp={spp} > {MAX_TEX_SPP} per launch — "
            "persistent_mse_value_and_grad chunks the sample budget "
            "automatically (phase='adjoint'/'scatter')")
    if phase == "scatter":
        if not tex_grad:
            raise ValueError(
                'phase="scatter" replays a textured gradient walk: it needs '
                "a packed mesh, a texture atlas and compute_tex_grad")
        if any(x is None for x in ext):
            raise ValueError('phase="scatter" needs ext_g, ext_ct and ext_ns')
    return tex_grad


def lane_cotangent(L_lanes: Tensor, n_samp: Tensor, target_lanes: Tensor,
                   width: int, height: int, lane0: int = 0) -> Tensor:
    """(3, rows, 128) lane-local MSE cotangent of launch 1's pixel means, the
    scatter launch's ``g`` (JAX ``replay_persistent.py:1438-1453``, its f32
    arithmetic); ``lane0`` is the global lane of the first row."""
    lane = torch.arange(n_samp.numel(), device=n_samp.device).reshape(
        n_samp.shape) + lane0
    havef = ((n_samp > 0) & (lane < width * height)).to(torch.float32)
    inv_n = havef / torch.clamp_min(n_samp.to(torch.float32), 1.0)
    gscale = (2.0 / (width * height * 3)) * inv_n
    return torch.stack([(L_lanes[..., c] * inv_n - target_lanes[..., c])
                        * havef * gscale for c in range(3)])


def _scatter_slots(slot_vals: Tensor, slot_mats: Sequence[int],
                   n_mats: int) -> Tensor:
    """Per-slot rows -> per-material rows (zeros for materials without
    prims)."""
    out = slot_vals.new_zeros((n_mats,) + tuple(slot_vals.shape[1:]))
    if slot_mats:
        out[list(slot_mats)] = slot_vals
    return out


def _epilogue(Lr, Lg, Lb, n_samp, GA, GI, target_lanes, in_domain,
              inv_loss_n, rows_total):
    """Phase "both": the lane-local MSE cotangent, reduced per 128-lane row
    like the kernel's blocks, then over rows. GA and GI are (S, 3, rows,
    128) and (NL, 3, rows, 128). Returns (loss, slot grads (S, 3), light
    grads (NL, 3))."""
    havef = ((n_samp > 0) & in_domain).to(torch.float32)
    inv_n = havef / torch.clamp_min(n_samp.to(torch.float32), 1.0)
    d = torch.stack([(L * inv_n - target_lanes[..., c]) * havef
                     for c, L in enumerate((Lr, Lg, Lb))])
    g = d * (2.0 * inv_loss_n) * inv_n

    def rows_sum(x):  # (..., rows, 128) -> (...)
        return x.sum(-1).sum(-1)

    sse = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).sum(-1) * inv_loss_n
    return sse.sum(0), rows_sum(g * GA), rows_sum(g * GI)


def _drive(launch, scene: Scene, target_lanes: Tensor, width: int,
           height: int, lane0: int, phase: str, tex_grad: bool, ext: tuple):
    """persistent_replay_call's launches and return tuple, shared by the
    kernel and the plain version. ``launch(kind, record_ct, scatter_in)``
    runs one walk (``kind`` "both", "adjoint" or "scatter") and returns
    (L_lanes, n_samp, grads, live_rays, ct, gT): ``grads`` holds per-slot
    and per-light rows, (ga (S, 3, rows, 128), gi (NL, 3, rows, 128)) for
    "adjoint" and (loss, gA (S, 3), gI (NL, 3)) for "both"; ``ct`` the C_tot
    planes (3*spp, rows, 128) with ``record_ct``; ``gT`` the atlas gradient
    of a scatter walk, which takes ``scatter_in`` = (g, ct, n_samp)."""
    if phase == "scatter":
        return launch("scatter", False, ext)[5]
    L_lanes, n_samp, grads, nrays, ct, _ = launch(phase, tex_grad, None)
    slot_mats = material_slots(scene)[0]
    n_mats = scene.mat_color.shape[0]
    if phase == "adjoint":
        ga, gi = grads
        return (L_lanes, n_samp, _scatter_slots(ga, slot_mats, n_mats), gi,
                nrays, ct)
    gT = None
    if tex_grad:
        g = lane_cotangent(L_lanes, n_samp, target_lanes, width, height,
                           lane0)
        gT = launch("scatter", False, (g, ct, n_samp))[5]
    loss, gA, gI = grads
    return (L_lanes, n_samp, loss, _scatter_slots(gA, slot_mats, n_mats), gI,
            nrays, gT)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def persistent_replay_ref(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    iteration: int,
    target_lanes: Tensor,
    *,
    spp: int,
    budget: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    use_dof: bool = False,
    strat_k: int = 2,
    tile_offset: int = 0,
    phase: str = "both",
    uniforms: Tensor | None = None,
    compute_tex_grad: bool = True,
    ext_g: Tensor | None = None,
    ext_ct: Tensor | None = None,
    ext_ns: Tensor | None = None,
    counts: dict | None = None,
    walks=None,
):
    """Plain PyTorch version of ``persistent_replay_call``: the JAX kernel's
    lane math, vectorized over all lanes with masked selects, with the
    explicit-FMA quadratics of ``persistent_step_ref``. Same arguments and
    returns; if ``counts`` is a dict it also receives ``"shadow"``, the NEE
    shadow segments traced, ``"texel"``, the texel fetches, and from a
    scatter walk ``"scatter"``, the textured vertices scattered into the
    atlas (for the kernel's bound; the kernel counts none of them), and
    the warp occupancy of the schedule, ``"warp_iters"``, ``"warp_live"``
    and ``"warp_packed"`` (``_count_occupancy``). ``walks``, if given, is
    called as ``mesh_walk_ref``'s ``record`` on every mesh walk of the
    adjoint walk (to sample the segments for the bound's walk tests)."""
    tex_grad = _check_route(scene, phase, spp, compute_tex_grad,
                            (ext_g, ext_ct, ext_ns))
    launch = functools.partial(
        _walk_ref, scene, cam_packed, seed, iteration, target_lanes, spp=spp,
        budget=budget, width=width, height=height, max_bounces=max_bounces,
        rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
        use_dof=use_dof, strat_k=strat_k, tile_offset=tile_offset,
        uniforms=uniforms, counts=counts, walks=walks)
    return _drive(launch, scene, target_lanes, width, height,
                  tile_offset * tile_rows * LANES, phase, tex_grad,
                  (ext_g, ext_ct, ext_ns))


def scatter_walk(scene: Scene, cam_packed: Tensor, seed: Sequence[int],
                 iteration: int, target_lanes: Tensor, ext_g: Tensor,
                 ext_ct: Tensor, ext_ns: Tensor, *, spp: int, budget: int,
                 width: int, height: int, max_bounces: int = 10,
                 rr_start: int = 3, tile_rows: int = 32,
                 use_nee: bool = False, use_dof: bool = False,
                 strat_k: int = 2, tile_offset: int = 0,
                 uniforms: Tensor | None = None):
    """Phase "scatter" with the replayed walk's own outputs: (L_lanes,
    n_samp, live_rays, gT). The scatter walk replays launch 1's schedule
    on the same draws, so its L_lanes and n_samp equal launch 1's on every
    lane; ``chip_smoke.py`` holds the kernel to that. CUDA tensors launch
    the kernel, CPU tensors run the plain walk."""
    ext = (ext_g, ext_ct, ext_ns)
    _check_route(scene, "scatter", spp, True, ext)
    kw = dict(spp=spp, budget=budget, width=width, height=height,
              max_bounces=max_bounces, rr_start=rr_start,
              tile_rows=tile_rows, use_nee=use_nee, use_dof=use_dof,
              strat_k=strat_k, tile_offset=tile_offset, uniforms=uniforms)
    L_lanes, n_samp, _, nrays, _, gT = _launcher(
        scene, cam_packed, seed, iteration, target_lanes, kw)(
            "scatter", False, ext)
    return L_lanes, n_samp, nrays, gT


def _launcher(scene, cam_packed, seed, iteration, target_lanes, kw):
    """``_drive``'s launch for the device of ``target_lanes``: the CUDA
    kernel or the plain walk."""
    dev = target_lanes.device
    if dev.type == "cuda":
        fn = _launch_cuda
    elif dev.type == "cpu":
        fn, kw = _walk_ref, dict(kw, counts=None)
    else:
        raise ValueError(f"persistent_replay_call: unsupported device {dev}")
    return functools.partial(fn, scene, cam_packed, seed, iteration,
                             target_lanes, **kw)


def _walk_ref(scene, cam_packed, seed, iteration, target_lanes, kind,
              record_ct, scatter_in, *, spp, budget, width, height,
              max_bounces, rr_start, tile_rows, use_nee, use_dof, strat_k,
              tile_offset, uniforms, counts, walks=None):
    """One plain walk of kind "both", "adjoint" or "scatter" (``_drive``'s
    ``launch``). A scatter walk replays launch 1's schedule without the
    adjoint sums: ``scatter_in`` = (g (3, rows, 128), ct (3*spp, rows, 128),
    launch 1's n_samp); the taps go into the atlas in a fixed order."""
    scatter = kind == "scatter"
    if scatter:  # it walks launch 1's segments again
        walks = None
    dev = target_lanes.device
    rows_total = target_lanes.shape[0]
    n_tiles = rows_total // tile_rows
    shape = (rows_total, LANES)
    n_lanes = width * height
    n_prims = int(scene.num_prims)
    tmin = EPSILON
    n_draw = n_draws(use_nee, use_dof)
    seed_i, salt = int(seed[0]), int(seed[1])
    inv_loss_n = 1.0 / (width * height * 3)

    P = pack_prims(scene).cpu().tolist()
    Lt = pack_lights(scene).cpu().tolist()
    cam = cam_packed.cpu().tolist()
    emissive = tuple(scene.emissive_prims)
    spec_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                       if t == SPECULAR)
    trans_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                        if t == TRANSMISSIVE)
    lights_static = tuple(scene.light_structure)
    n_l = len(lights_static)
    slot_mats, prim_slot = material_slots(scene)
    n_slots = len(slot_mats)
    mesh = packed_mesh(scene) is not None
    # mesh materials can be specular or transmissive without such a sphere
    any_spec = bool(spec_prims) or (mesh and SPECULAR in scene.mat_types)
    any_trans = bool(trans_prims) or (mesh and TRANSMISSIVE in scene.mat_types)
    MT = pack_materials(scene).cpu().tolist()
    TL, tris = pack_tri_lights(scene)
    TL = TL.cpu().tolist()
    tri_of = {li: (off, K) for li, _, off, K in tris}

    lane = (torch.arange(rows_total * LANES, device=dev, dtype=torch.int64)
            .reshape(shape) + tile_offset * tile_rows * LANES)
    in_domain = lane < n_lanes
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    if uniforms is not None:
        ublk = uniforms.reshape(n_tiles, budget, n_draw, tile_rows, LANES)
    fzeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    bzeros = torch.zeros(shape, dtype=torch.bool, device=dev)
    izeros = torch.zeros(shape, dtype=torch.int32, device=dev)
    where = torch.where

    Lr = Lg = Lb = fzeros
    n_samp = izeros
    ox = oy = oz = dx = dy = dz = fzeros
    Tr = Tg = Tb = Cr = Cg = Cb = fzeros
    bounce = izeros
    alive = bzeros
    prev_pdf = fzeros
    prev_delta = bzeros
    nA = [fzeros] * n_slots
    cA = [[fzeros] * 3 for _ in range(n_slots)]
    cI = [[fzeros] * 3 for _ in range(n_l)]
    GA = [[fzeros] * 3 for _ in range(n_slots)]
    GI = [[fzeros] * 3 for _ in range(n_l)]
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    n_shadow = torch.zeros((), dtype=torch.int64, device=dev)
    n_scatter = torch.zeros((), dtype=torch.int64, device=dev)
    # launch 1 of a textured gradient: each completed path's C_tot, slot k
    # = its sample index (JAX replay_persistent.py:1008-1015)
    Ct = [[fzeros] * 3 for _ in range(spp)] if record_ct else None
    if scatter:
        # launch 2: the cotangent, launch 1's records and final counts
        g_ct, ct_in, nsf = scatter_in
        ct_in = ct_in.reshape(spp, 3, *shape)
        K, TH, TW, _ = scene.textures.shape
        gT = torch.zeros((K * TH * TW, 3), dtype=torch.float32, device=dev)

    for it in range(budget):
        if uniforms is not None:
            u = [ublk[:, it, j].reshape(shape) for j in range(n_draw)]
        else:
            u = philox_uniforms(lane, seed_i, salt, iteration, it, n_draw,
                                stream=STREAM)
        (u_cam, v_cam), lens, (u1, u2, u3), nee_u = split_draws(
            u, use_nee, use_dof)
        if use_nee:
            ul1, ul2, usel = nee_u

        # ---- regenerate while the pixel has samples left (through the
        # thin lens with use_dof, replay_persistent.py:467-477, 512-527)
        regen = (~alive) & in_domain & (n_samp < spp)
        gox, goy, goz, gdx, gdy, gdz = camera_rays(
            cam, px, py, n_samp, strat_k, u_cam, v_cam, lens)
        ox = where(regen, gox, ox)
        oy = where(regen, goy, oy)
        oz = where(regen, goz, oz)
        dx = where(regen, gdx, dx)
        dy = where(regen, gdy, dy)
        dz = where(regen, gdz, dz)
        Tr = where(regen, 1.0, Tr)
        Tg = where(regen, 1.0, Tg)
        Tb = where(regen, 1.0, Tb)
        Cr = where(regen, 0.0, Cr)
        Cg = where(regen, 0.0, Cg)
        Cb = where(regen, 0.0, Cb)
        bounce = where(regen, 0, bounce)
        prev_pdf = where(regen, 0.0, prev_pdf)
        prev_delta = prev_delta | regen
        if not scatter:
            nA = [where(regen, 0.0, x) for x in nA]
            cA = [[where(regen, 0.0, x) for x in xs] for xs in cA]
            cI = [[where(regen, 0.0, x) for x in xs] for xs in cI]
        alive = alive | regen
        n_live = n_live + alive.sum()
        if counts is not None:
            _count_occupancy(counts, alive)

        # ---- closest hit; strict < keeps the FIRST prim on an exact tie
        best_t = fzeros + BIG
        best_p = izeros
        for p in range(n_prims):
            opx = P[p][0] - ox
            opy = P[p][1] - oy
            opz = P[p][2] - oz
            r = P[p][3]
            b = dot3_fma(opx, opy, opz, dx, dy, dz)
            det = fma(r, r, fma(b, b, -dot3_fma(opx, opy, opz, opx, opy, opz)))
            sq = torch.sqrt(torch.clamp_min(det, 0.0))
            t0 = b - sq
            t = where(t0 > tmin, t0, b + sq)
            closer = (det >= 0.0) & (t > tmin) & (t < best_t)
            best_t = where(closer, t, best_t)
            best_p = where(closer, p, best_p)
        hit = best_t < (0.5 * BIG)
        act = alive & hit
        actf = act.to(torch.float32)
        # Lanes that do not act sit on the origin, so that a miss lane's
        # o + d*1e30 cannot turn into inf/NaN in the NEE distance math.
        hx = fma(dx, best_t, ox) * actf
        hy = fma(dy, best_t, oy) * actf
        hz = fma(dz, best_t, oz) * actf
        nx = ny = nz = ar = ag = ab = fzeros
        is_ps = []
        for p in range(n_prims):
            is_p = best_p == p
            is_ps.append(is_p)
            inv_r = _f32_div(1.0, P[p][3])
            nx = where(is_p, (hx - P[p][0]) * inv_r, nx)
            ny = where(is_p, (hy - P[p][1]) * inv_r, ny)
            nz = where(is_p, (hz - P[p][2]) * inv_r, nz)
            ar = where(is_p, P[p][4], ar)
            ag = where(is_p, P[p][5], ag)
            ab = where(is_p, P[p][6], ab)
        coef = fzeros
        for p in (*spec_prims, *trans_prims):
            coef = where(is_ps[p], P[p][7], coef)
        er = eg = eb = fzeros
        for p in emissive:
            er = where(is_ps[p], P[p][9], er)
            eg = where(is_ps[p], P[p][10], eg)
            eb = where(is_ps[p], P[p][11], eb)
        is_s = bzeros
        for p in spec_prims:
            is_s = is_s | is_ps[p]
        is_t = bzeros
        for p in trans_prims:
            is_t = is_t | is_ps[p]
        mc = bzeros
        tex_out = {}
        if mesh:
            h = dict(hit=hit, hx=hx, hy=hy, hz=hz, nx=nx, ny=ny, nz=nz,
                     ar=ar, ag=ag, ab=ab, coef=coef, is_s=is_s, is_t=is_t,
                     er=er, eg=eg, eb=eb)
            mc, tm, mmat = mesh_merge(scene, tile_rows, alive, ox, oy, oz,
                                      dx, dy, dz, best_t, h, MT, tris, Lt,
                                      None if scatter else counts, tex_out,
                                      walks)
            (hit, hx, hy, hz, nx, ny, nz, ar, ag, ab, coef, is_s, is_t,
             er, eg, eb) = h.values()
            # the sphere winner fires on no mesh-won lane (emitter pdfs, cI
            # routing and the material adjoint masks key on it)
            is_ps = [m & ~mc for m in is_ps]
            act = alive & hit
            hx, hy, hz = hx * act, hy * act, hz * act
        is_d = ~(is_s | is_t)
        wox, woy, woz = dx, dy, dz

        # ---- emitter hit (+ MIS weight under NEE); credits cI
        one_sided = dot3(nx, ny, nz, -wox, -woy, -woz) > 0.0
        take = (act & one_sided).to(torch.float32)
        if use_nee:
            ldp = emitter_light_pdf(P, Lt, lights_static, is_ps, ox, oy, oz,
                                    fzeros)
            if mesh:
                ldp = tri_emitter_pdf(ldp, mc, tm, mmat, nx, ny, nz, wox,
                                      woy, woz, Lt, TL, tris)
            pp2 = prev_pdf * prev_pdf
            w_emit = where(prev_delta, 1.0,
                           pp2 / torch.clamp_min(pp2 + ldp * ldp, 1e-20))
            take = take * w_emit
        e_r, e_g, e_b = Tr * er * take, Tg * eg * take, Tb * eb * take
        Cr, Cg, Cb = Cr + e_r, Cg + e_g, Cb + e_b
        for li, (ltype, lprim) in enumerate(lights_static):
            if ltype != AREA_LIGHT or lprim < 0 or scatter:
                continue
            m = is_ps[lprim].to(torch.float32)
            cI[li] = [cI[li][0] + e_r * m, cI[li][1] + e_g * m,
                      cI[li][2] + e_b * m]
        for li, lmat, _, _ in () if scatter else tris:  # own emission
            m = (mc & (mmat == lmat)).to(torch.float32)
            cI[li] = [cI[li][0] + e_r * m, cI[li][1] + e_g * m,
                      cI[li][2] + e_b * m]

        # ---- next-event estimation (diffuse lanes); credits cI
        nee_r = nee_g = nee_b = fzeros
        if use_nee:
            for li, (ltype, lprim) in enumerate(lights_static):
                lo, sel = Lt[li][6], Lt[li][7]
                if li == n_l - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < _f32_add(lo, sel))
                (wlx, wly, wlz, dist_l, pdf_l, rad, valid,
                 is_delta) = sample_light(P, Lt, li, ltype, lprim, hx, hy, hz,
                                          ul1, ul2, fzeros,
                                          tri=(TL, *tri_of.get(li, (0, 0))))
                # shadow any-hit: the sphere quadratic's root in
                # (tmin, smax), skipping the sampled light sphere
                smax = fma(dist_l, 1.0 - 1e-3, -tmin)
                occ = bzeros
                skip_pp = lprim if (ltype == AREA_LIGHT and lprim >= 0) else -1
                for pp in range(n_prims):
                    if pp == skip_pp:
                        continue
                    sx2 = P[pp][0] - hx
                    sy2 = P[pp][1] - hy
                    sz2 = P[pp][2] - hz
                    rb = dot3_fma(sx2, sy2, sz2, wlx, wly, wlz)
                    rdet = fma(P[pp][3], P[pp][3],
                               fma(rb, rb, -dot3_fma(sx2, sy2, sz2,
                                                     sx2, sy2, sz2)))
                    rsq = torch.sqrt(torch.clamp_min(rdet, 0.0))
                    rt = where(rb - rsq > tmin, rb - rsq, rb + rsq)
                    occ = occ | ((rdet >= 0.0) & (rt > tmin) & (rt < smax))
                if mesh:
                    occ = occ | mesh_occluded(
                        scene, tile_rows, act & m_l & valid & ~occ
                        & (smax > 0.0), smax, hx, hy, hz, wlx, wly, wlz,
                        walks)
                cos_l = dot3(wlx, wly, wlz, nx, ny, nz)
                support = ((cos_l > 0.0)
                           & (dot3(wox, woy, woz, wlx, wly, wlz) < 0.0)
                           & is_d)
                if is_delta:
                    w_mis = 1.0
                else:
                    pdf_b_l = where(support, cos_l * INV_PI, 0.0)
                    w_mis = (pdf_l * pdf_l) / torch.clamp_min(
                        pdf_l * pdf_l + pdf_b_l * pdf_b_l, 1e-20)
                n_shadow = n_shadow + (act & m_l & valid & support).sum()
                gate = (act & m_l & valid & support & ~occ).to(torch.float32)
                scale = gate * cos_l * w_mis / torch.clamp_min(pdf_l, 1e-20)
                t_r = Tr * (ar * INV_PI) * rad[0] * scale
                t_g = Tg * (ag * INV_PI) * rad[1] * scale
                t_b = Tb * (ab * INV_PI) * rad[2] * scale
                nee_r, nee_g, nee_b = nee_r + t_r, nee_g + t_g, nee_b + t_b
                if not scatter:
                    cI[li] = [cI[li][0] + t_r, cI[li][1] + t_g,
                              cI[li][2] + t_b]
            Cr, Cg, Cb = Cr + nee_r, Cg + nee_g, Cb + nee_b

        # ---- BSDF sampling: one lobe per lane under masks
        wix, wiy, wiz, fr, fg, fb, pdf, wgt = sample_lobe(
            nx, ny, nz, wox, woy, woz, ar, ag, ab, coef, is_s, is_t, is_d,
            u1, u2, any_spec, any_trans)
        f_black = (fr <= 0.0) & (fg <= 0.0) & (fb <= 0.0)
        step_ok = act & ~f_black & (pdf > 0.0)
        okf = step_ok.to(torch.float32)

        if scatter and "texel" in tex_out:
            n_scatter = n_scatter + _scatter_taps(
                gT, scene, mc, mmat, tex_out, n_samp, nsf, step_ok, g_ct,
                ct_in, (Cr, Cg, Cb), (nee_r, nee_g, nee_b))

        # ---- streaming adjoint at the hit's material slot
        for s in range(n_slots if not scatter else 0):
            mm = bzeros
            for p in range(n_prims):
                if prim_slot[p] == s:
                    mm = mm | is_ps[p]
            if mesh and slot_mats[s] in scene.mesh_mats_static:
                mm = mm | (mc & (mmat == slot_mats[s]))
            mm = mm & act
            nA[s] = where(mm, nA[s] + okf, nA[s])
            cA[s] = [where(mm, x + (C * okf - nee), x)
                     for x, C, nee in zip(cA[s], (Cr, Cg, Cb),
                                          (nee_r, nee_g, nee_b))]

        Tr = where(step_ok, Tr * fr * wgt, Tr)
        Tg = where(step_ok, Tg * fg * wgt, Tg)
        Tb = where(step_ok, Tb * fb * wgt, Tb)

        # ---- Russian roulette after rr_start: p = min(0.5, max T)
        do_rr = bounce > rr_start
        p_cont = torch.clamp_max(torch.maximum(Tr, torch.maximum(Tg, Tb)),
                                 0.5)
        survive = u3 <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        inv_p = 1.0 / torch.clamp_min(p_cont, 1e-20)
        Tr = where(boost, Tr * inv_p, Tr)
        Tg = where(boost, Tg * inv_p, Tg)
        Tb = where(boost, Tb * inv_p, Tb)
        alive_next = step_ok & (survive | ~do_rr) & (bounce < max_bounces)

        # ---- path completion: flush radiance and the adjoint sums
        died = alive & ~alive_next
        Lr = where(died, Lr + Cr, Lr)
        Lg = where(died, Lg + Cg, Lg)
        Lb = where(died, Lb + Cb, Lb)
        if record_ct:
            for k in range(spp):
                mk = died & (n_samp == k)
                Ct[k] = [where(mk, C, x) for C, x in zip((Cr, Cg, Cb), Ct[k])]
        n_samp = n_samp + died.to(torch.int32)
        for s in range(n_slots if not scatter else 0):
            GA[s] = [where(died, G + (C * nA[s] - x), G)
                     for G, C, x in zip(GA[s], (Cr, Cg, Cb), cA[s])]
        for li in range(n_l if not scatter else 0):
            GI[li] = [where(died, G + x, G) for G, x in zip(GI[li], cI[li])]

        # ---- pending ray for the next iteration
        ox = where(act, hx, ox)
        oy = where(act, hy, oy)
        oz = where(act, hz, oz)
        dx = where(act, wix, dx)
        dy = where(act, wiy, dy)
        dz = where(act, wiz, dz)
        prev_pdf = where(act, pdf, prev_pdf)
        prev_delta = (act & (is_s | is_t)) | (~act & prev_delta)
        bounce = where(act, bounce + 1, bounce)
        alive = alive_next

    dom = in_domain.to(torch.float32)
    L_lanes = torch.stack([Lr * dom, Lg * dom, Lb * dom], dim=-1)
    if scatter:
        if counts is not None:
            counts["scatter"] = n_scatter
        return L_lanes, n_samp, None, n_live, None, gT.reshape(K, TH, TW, 3)

    def planes(G):
        return torch.stack([torch.stack(x) for x in G]) if G \
            else fzeros.new_zeros((0, 3) + shape)

    GA, GI = planes(GA), planes(GI)
    if kind == "adjoint":
        grads = (GA, GI)
    else:
        grads = _epilogue(Lr, Lg, Lb, n_samp, GA, GI, target_lanes, in_domain,
                          inv_loss_n, rows_total)
    if counts is not None:
        counts["shadow"] = n_shadow
    ct = torch.stack([x for xs in Ct for x in xs]) if record_ct else None
    return L_lanes, n_samp, grads, n_live, ct, None


def _count_occupancy(counts: dict, alive: Tensor) -> None:
    """Adds one iteration's warp occupancy to ``counts``: ``"warp_iters"``,
    the 32-lane warps of the layout; ``"warp_live"``, those with a live lane
    (a lane with no live path has drained: it cannot regenerate);
    ``"warp_packed"``, the warps that the live lanes of each 128-lane row
    would fill if packed into its leading threads."""
    per_row = alive.sum(-1)
    n_warps = alive.shape[0] * (LANES // 32)
    counts["warp_iters"] = counts.get("warp_iters", 0) + n_warps
    counts["warp_live"] = counts.get("warp_live", 0) + alive.reshape(
        -1, 32).any(-1).sum()
    counts["warp_packed"] = counts.get("warp_packed", 0) + (
        (per_row + 31) // 32).sum()


def _scatter_taps(gT, scene, mc, mmat, tex_out, n_samp, nsf, step_ok, g,
                  ct, C, nee):
    """One iteration of the plain scatter (JAX ``replay_persistent.py:
    912-978``): at each acting textured vertex of a path that completed in
    launch 1 (sample index ``n_samp`` below launch 1's count ``nsf``), per
    channel ``g * (ok (C_tot - C) + nee) / max(texel, 1e-8)``, with C_tot
    the path's record in ``ct`` (spp, 3, rows, 128), added with the bilinear
    weights into the four taps of the flat atlas gradient ``gT`` (K*TH*TW,
    3) by ``index_put_(accumulate=True)``. A tap of a texture id past the
    atlas adds nothing, as its TPU two-hot row matches no atlas row. Returns
    the vertices scattered."""
    has_tex, rgb = tex_out["texel"]
    K, TH, TW, _ = scene.textures.shape
    texk, (r0, r1, c0, c1), (fx, fy) = texel_taps(
        scene.textures.shape, scene.mat_textures_static, mc, mmat,
        *tex_out["uv"])
    m_sc = has_tex & (n_samp < nsf)  # has_tex implies an acting mesh hit
    slot = torch.clamp(n_samp, 0, ct.shape[0] - 1).to(torch.int64)
    ct_now = torch.gather(ct, 0, slot.expand(1, 3, *slot.shape))[0]
    mscf = m_sc.to(torch.float32)
    okf = step_ok.to(torch.float32)
    v = torch.stack([
        g[c] * (okf * (ct_now[c] - C[c]) + nee[c])
        * (1.0 / torch.clamp_min(rgb[c], 1e-8)) * mscf for c in range(3)], -1)
    sel = m_sc & (texk < K)
    v = v[sel]
    for r, wr in ((r0, 1.0 - fy), (r1, fy)):
        for col, wc in ((c0, 1.0 - fx), (c1, fx)):
            idx = (r * TW + col)[sel].to(torch.int64)
            gT.index_put_((idx,), (wc[sel][:, None] * v) * wr[sel][:, None],
                          accumulate=True)
    return sel.sum()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    """The bound C entry point of csrc/replay_persistent.cu (built on first
    use, into the same library as csrc/persistent.cu)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    fn = lib.tpt_replay_persistent
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        p, ip, ip, i, i,  # prims (device), flags, slots (host), n, n_mats
        p, ip, i, i,  # lights (device), light structure (host), n, n_slots
        p, p, p,  # camera, uniforms (or NULL), target (device)
        p, p, p, p, p,  # lr lg lb n_samp nrays (device)
        p, p,  # partials ("both") or gl ("adjoint"), the other NULL
        p, p, p, p, i,  # bvh nodes, tris, mats, tri lights; nodes
        p, i, i, i,  # texture atlas (or NULL), K, TH, TW
        p,  # C_tot records written by launch 1 (or NULL)
        p, p, p, p,  # scatter: g, C_tot records, counts in; atlas grad out
        i, i, i, i, i, i,  # rows_total tile_rows budget spp width n_lanes
        i, i, i, i, i, i,  # max_bounces rr_start use_nee use_dof strat_k
        #                    tile_offset
        f, u, u, u,  # inv_loss_n seed salt iteration
        p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return fn, lib.tpt_error_string


def _launch_cuda(scene, cam_packed, seed, iteration, target_lanes, kind,
                 record_ct, scatter_in, *, spp, budget, width, height,
                 max_bounces, rr_start, tile_rows, use_nee, use_dof, strat_k,
                 tile_offset, uniforms):
    """One kernel launch of kind "both", "adjoint" or "scatter"
    (``_drive``'s ``launch``)."""
    global launches, mesh_launches, scatter_launches
    dev = target_lanes.device
    rows_total = target_lanes.shape[0]
    if rows_total % tile_rows:
        raise ValueError(f"{rows_total} lane rows are not whole tiles of "
                         f"{tile_rows} rows")
    n_tiles = rows_total // tile_rows
    _check(target_lanes, "target_lanes", torch.float32, (rows_total, LANES, 3),
           dev)
    n_prims = int(scene.num_prims)
    lights_static = tuple(scene.light_structure)
    n_lights = len(lights_static)
    slot_mats, prim_slot = material_slots(scene)
    n_slots = len(slot_mats)
    n_mats = scene.mat_color.shape[0]
    if n_prims > MAX_PRIMS or n_lights > MAX_GRAD_LIGHTS \
            or n_slots > MAX_SLOTS or n_mats > MAX_MATS:
        raise ValueError(
            f"the gradient kernel takes at most {MAX_PRIMS} prims, "
            f"{MAX_GRAD_LIGHTS} lights, {MAX_MATS} materials and "
            f"{MAX_SLOTS} materials on a surface; got {n_prims}, {n_lights}, "
            f"{n_mats} and {n_slots}")
    replay_smem_bytes(n_slots, n_lights, scatter=kind == "scatter")
    prims = pack_prims(scene).contiguous()
    lights = pack_lights(scene).contiguous()
    _check(prims, "prims", torch.float32, (n_prims, 12), dev)
    _check(lights, "lights", torch.float32, (max(n_lights, 1), 8), dev)
    _check(cam_packed, "cam_packed", torch.float32, (24,), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32,
               (n_tiles * budget * n_draws(use_nee, use_dof) * tile_rows,
                LANES), dev)
    if strat_k < 1 or budget < 0 or spp < 0:
        raise ValueError("strat_k must be >= 1, budget and spp >= 0")

    mesh_ptrs, _keep, ls = mesh_arguments(scene, dev)
    emissive = set(scene.emissive_prims)
    pflags = (ctypes.c_int * max(n_prims, 1))(*[
        (1 if q in emissive else 0) | (int(t) << 1)
        for q, t in enumerate(scene.prim_mtypes)])
    # adjoint slots of the prims' materials, then of every material
    slots = (ctypes.c_int * max(n_prims + n_mats, 1))(
        *prim_slot, *[slot_mats.index(m) if m in slot_mats else -1
                      for m in range(n_mats)])
    lstruct = (ctypes.c_int * max(len(ls), 1))(*ls)
    shape = (rows_total, LANES)
    lr, lg, lb = (torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(3))
    n_samp = torch.empty(shape, dtype=torch.int32, device=dev)
    nrays = torch.empty(rows_total, dtype=torch.int32, device=dev)
    n_k = 3 * n_slots + 3 * n_lights + 1
    partials = gl = ct = gT = None
    tex, _keep_tex = texture_arguments(scene, dev)
    scatter = [None] * 3
    if kind == "both":
        partials = torch.empty((rows_total, n_k), dtype=torch.float32,
                               device=dev)
    elif kind == "adjoint":
        gl = torch.empty(((n_slots + n_lights) * 3,) + shape,
                         dtype=torch.float32, device=dev)
    else:
        g, ct_in, nsf = scatter_in
        _check(g, "ext_g", torch.float32, (3,) + shape, dev)
        _check(ct_in, "ext_ct", torch.float32, (3 * spp,) + shape, dev)
        _check(nsf, "ext_ns", torch.int32, shape, dev)
        gT = torch.zeros(scene.textures.shape, dtype=torch.float32,
                         device=dev)
        scatter = [g.data_ptr(), ct_in.data_ptr(), nsf.data_ptr()]
    if record_ct:
        # slots of paths that never complete stay 0, as the JAX records
        ct = torch.zeros((3 * spp,) + shape, dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn, error_string = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(prims.data_ptr(), pflags, slots, n_prims, n_mats,
                 lights.data_ptr(), lstruct, n_lights, n_slots,
                 cam_packed.data_ptr(), ptr(uniforms),
                 target_lanes.data_ptr(),
                 lr.data_ptr(), lg.data_ptr(), lb.data_ptr(),
                 n_samp.data_ptr(), nrays.data_ptr(), ptr(partials), ptr(gl),
                 *mesh_ptrs, *tex, ptr(ct), *scatter, ptr(gT),
                 rows_total, tile_rows, budget, spp, width, width * height,
                 max_bounces, rr_start, int(use_nee), int(use_dof), strat_k,
                 int(tile_offset), 1.0 / (width * height * 3),
                 int(seed[0]) & _MASK, int(seed[1]) & _MASK,
                 int(iteration) & _MASK, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"gradient kernel launch failed: {msg} ({err})")
    launches += 1
    mesh_launches += scene.mesh is not None
    scatter_launches += kind == "scatter"
    L_lanes = torch.stack([lr, lg, lb], dim=-1)
    if kind == "scatter":
        grads = None
    elif kind == "adjoint":
        planes = gl.reshape(n_slots + n_lights, 3, *shape)
        grads = (planes[:n_slots], planes[n_slots:])
    else:
        part = partials.sum(0)
        grads = (part[n_k - 1], part[:3 * n_slots].reshape(n_slots, 3),
                 part[3 * n_slots:n_k - 1].reshape(n_lights, 3))
    return L_lanes, n_samp, grads, nrays.sum(), ct, gT


def persistent_replay_call(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    iteration: int,
    target_lanes: Tensor,
    *,
    spp: int,
    budget: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    use_dof: bool = False,
    strat_k: int = 2,
    tile_offset: int = 0,
    phase: str = "both",
    uniforms: Tensor | None = None,
    compute_tex_grad: bool = True,
    ext_g: Tensor | None = None,
    ext_ct: Tensor | None = None,
    ext_ns: Tensor | None = None,
):
    """One fused fwd+bwd walk over the (rows_total, 128) lane layout, and on
    a textured mesh scene the scatter walk after it.

    ``seed`` is ``(seed, salt)`` and ``iteration`` the RNG frame, as host
    integers; ``target_lanes`` is the per-pixel target in the lane layout
    (``target_to_lanes``). Returns, as the JAX function does:

    * phase ``"both"``: (L_lanes (rows, 128, 3), n_samp, loss, gA_raw (M, 3),
      gI_raw (NL, 3), live_rays, gT), with gT the final dLoss/dtextures
      (K, TH, TW, 3) of the second launch on a textured mesh scene, None
      otherwise or with ``compute_tex_grad`` false;
    * phase ``"adjoint"``: (L_lanes, n_samp, ga_lanes (M, 3, rows, 128),
      gi_lanes (NL, 3, rows, 128), live_rays, ct_lanes), the cotangent not
      applied; ct_lanes the C_tot records (3*spp, rows, 128), plane k*3 + c
      for slot k and channel c, on a textured mesh scene, else None;
    * phase ``"scatter"``: gT of the scatter walk alone, replaying this
      call's schedule with the cotangent ``ext_g`` (3, rows, 128), the
      records ``ext_ct`` (3*spp, rows, 128) and the final counts ``ext_ns``
      (rows, 128) int32 of a phase "adjoint" call (the chunked driver).

    A textured gradient takes spp <= 32 per launch (ValueError otherwise,
    as in JAX; ``persistent_mse_value_and_grad`` chunks). Callers divide the
    raw gradients by clamp(mat_color, 1e-8) and clamp(light_intensity,
    1e-8); gT needs no division. ``use_dof`` regenerates paths through the
    packed camera's thin lens. ``live_rays`` counts the lanes alive after
    regeneration, once per iteration (the JAX kernel's count). For tensors
    on a CUDA device this launches the CUDA kernel on the current stream;
    on the CPU it runs ``persistent_replay_ref``; any other device raises.
    """
    ext = (ext_g, ext_ct, ext_ns)
    tex_grad = _check_route(scene, phase, spp, compute_tex_grad, ext)
    kw = dict(spp=spp, budget=budget, width=width, height=height,
              max_bounces=max_bounces, rr_start=rr_start,
              tile_rows=tile_rows, use_nee=use_nee, use_dof=use_dof,
              strat_k=strat_k, tile_offset=tile_offset, uniforms=uniforms)
    launch = _launcher(scene, cam_packed, seed, iteration, target_lanes, kw)
    return _drive(launch, scene, target_lanes, width, height,
                  tile_offset * tile_rows * LANES, phase, tex_grad, ext)


def mse_lane_terms(L_lanes: Tensor, n_samp: Tensor, ga_lanes: Tensor,
                   gi_lanes: Tensor, target_lanes: Tensor, width: int,
                   height: int) -> tuple[Tensor, Tensor, Tensor]:
    """Each lane's share of (loss, gA_raw, gI_raw), from the per-lane outputs
    of phase "adjoint": the JAX package's pooled-mean cotangent
    (``replay_persistent.py:1656-1676``) before its sum over lanes. Shapes
    (rows, 128), (M, 3, rows, 128) and (NL, 3, rows, 128)."""
    n_pix3 = width * height * 3
    lane = torch.arange(n_samp.numel(), device=n_samp.device).reshape(
        n_samp.shape)
    havef = ((n_samp > 0) & (lane < width * height)).to(torch.float32)
    inv_n = havef / torch.clamp_min(n_samp.to(torch.float32), 1.0)
    d = (L_lanes.permute(2, 0, 1) * inv_n - target_lanes.permute(2, 0, 1)) \
        * havef
    g = d * (2.0 / n_pix3) * inv_n  # (3, rows, 128)
    return (d * d).sum(0) / n_pix3, g * ga_lanes, g * gi_lanes


def mse_fold(L_lanes: Tensor, n_samp: Tensor, ga_lanes: Tensor,
             gi_lanes: Tensor, target_lanes: Tensor, width: int, height: int,
             mask: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """(loss, gA_raw, gI_raw): ``mse_lane_terms`` summed over the lanes of
    ``mask`` if given (all lanes otherwise)."""
    terms = mse_lane_terms(L_lanes, n_samp, ga_lanes, gi_lanes, target_lanes,
                           width, height)
    if mask is not None:
        terms = tuple(t * mask for t in terms)
    return tuple(t.sum((-2, -1)) for t in terms)


def persistent_mse_value_and_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    iteration: int,
    target: Tensor,
    *,
    spp: int,
    budget: int | None = None,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    uniforms=None,
) -> tuple[Tensor, dict, Tensor]:
    """Loss and gradients of mean((render - target)^2), ``target`` (H, W,
    3), w.r.t. ``mat_color`` and ``light_intensity``, and on a textured mesh
    scene w.r.t. ``textures`` (the atlas, (K, TH, TW, 3)): one fused launch,
    plus the scatter launch for the atlas. A lens camera's paths start on
    its thin lens. A textured scene at spp > 32 goes to
    ``chunked_mse_value_and_grad`` (``uniforms`` then one block per chunk).
    Returns (loss, grads, live_rays)."""
    if tex_route(scene) and spp > MAX_TEX_SPP:
        return chunked_mse_value_and_grad(
            scene, camera, seed, iteration, target, spp=spp, budget=budget,
            max_bounces=max_bounces, rr_start=rr_start, tile_rows=tile_rows,
            use_nee=use_nee, strat_k=strat_k, uniforms=uniforms)
    w, h = camera.width, camera.height
    rows_total, _ = pixel_lanes_layout(w, h, tile_rows)
    aux = target_to_lanes(target, rows_total)
    if budget is None:
        budget = default_budget(spp, max_bounces)
    _, _, loss, gA_raw, gI_raw, nrays, gT = persistent_replay_call(
        scene, pack_camera(camera), seed, iteration, aux, spp=spp,
        budget=budget, width=w, height=h, max_bounces=max_bounces,
        rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
        use_dof=camera.use_dof, strat_k=strat_k, uniforms=uniforms)
    return loss, _param_grads(scene, gA_raw, gI_raw, gT), nrays


def _param_grads(scene: Scene, gA_raw: Tensor, gI_raw: Tensor,
                 gT: Tensor | None) -> dict:
    """The raw colour and intensity gradients divided by the clamped
    parameters; the atlas gradient, already final, as it is."""
    gI_full = torch.zeros_like(scene.light_intensity)
    gI_full[: gI_raw.shape[0]] = gI_raw
    grads = {
        "mat_color": gA_raw / torch.clamp_min(scene.mat_color, 1e-8),
        "light_intensity": gI_full / torch.clamp_min(scene.light_intensity,
                                                     1e-8),
    }
    if gT is not None:
        grads["textures"] = gT
    return grads


def chunk_plan(spp: int, budget: int | None, max_bounces: int
               ) -> list[tuple[int, int]]:
    """(samples, budget) of each chunk of the chunked driver: chunks of
    MAX_TEX_SPP samples and the remainder, each with the default budget of
    its samples, or the caller's budget shared out by samples (rounded up,
    at least 1), as ``_chunked_mse_value_and_grad`` does."""
    sizes = [MAX_TEX_SPP] * (spp // MAX_TEX_SPP) + (
        [spp % MAX_TEX_SPP] if spp % MAX_TEX_SPP else [])
    return [(c, default_budget(c, max_bounces) if budget is None
             else max(1, -(-budget * c // spp))) for c in sizes]


def chunked_mse_value_and_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    iteration: int,
    target: Tensor,
    *,
    spp: int,
    budget: int | None = None,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    uniforms: Sequence[Tensor] | None = None,
) -> tuple[Tensor, dict, Tensor]:
    """Fused gradients of a textured scene with spp > 32 (the JAX
    package's ``_chunked_mse_value_and_grad``), by the pooled mean.

    The samples are split by ``chunk_plan``: chunk r walks its own draws at
    iteration ``iteration * n_chunks + r`` with phase "adjoint" (raw
    per-lane GA/GI sums and C_tot records). The MSE of the pooled mean
    (sum L / sum n over the chunks) is the loss; its lane-local cotangent
    is dotted with the summed GA/GI lanes, and fed to one phase "scatter"
    walk per chunk for the atlas. The JAX kernel caps a launch at 32
    samples because its 3*spp C_tot planes live in VMEM; here the records
    are planes in device memory and need no cap, but the cap stays: it
    decides which samples (chunk draws and budgets) a spp > 32 gradient
    takes, and the port takes the same ones. ``uniforms`` (test mode) is
    one block per chunk. Returns (loss, grads, live_rays)."""
    w, h = camera.width, camera.height
    rows_total, n_lanes = pixel_lanes_layout(w, h, tile_rows)
    aux = target_to_lanes(target, rows_total)
    cp = pack_camera(camera)
    plan = chunk_plan(spp, budget, max_bounces)
    if uniforms is not None and len(uniforms) != len(plan):
        raise ValueError(f"{len(plan)} chunks need {len(plan)} uniform "
                         f"blocks, got {len(uniforms)}")
    chunks, L_tot, n_tot, nrays, gaL, giL = [], 0.0, 0, 0, 0.0, 0.0
    for r, (c_spp, c_budget) in enumerate(plan):
        kw = dict(spp=c_spp, budget=c_budget, width=w, height=h,
                  max_bounces=max_bounces, rr_start=rr_start,
                  tile_rows=tile_rows, use_nee=use_nee,
                  use_dof=camera.use_dof, strat_k=strat_k,
                  uniforms=None if uniforms is None else uniforms[r])
        it_r = iteration * len(plan) + r
        L, ns, ga, gi, nr, ct = persistent_replay_call(
            scene, cp, seed, it_r, aux, phase="adjoint", **kw)
        chunks.append((it_r, kw, ns, ct))
        L_tot, n_tot, nrays = L_tot + L, n_tot + ns, nrays + nr
        gaL, giL = gaL + ga, giL + gi

    # the pooled-mean MSE and its lane-local cotangent (JAX :1656-1676)
    lane = torch.arange(rows_total * LANES, device=aux.device).reshape(
        rows_total, LANES)
    havef = ((n_tot > 0) & (lane < n_lanes)).to(torch.float32)
    inv_n = havef / torch.clamp_min(n_tot.to(torch.float32), 1.0)
    n3 = w * h * 3
    d = torch.stack([(L_tot[..., c] * inv_n - aux[..., c]) * havef
                     for c in range(3)])
    loss = (d * d).sum() / n3
    g = d * (2.0 / n3) * inv_n
    gA_raw = (g * gaL).sum((-2, -1))
    gI_raw = (g * giL).sum((-2, -1))
    gT = torch.zeros_like(scene.textures) if tex_route(scene) else None
    for it_r, kw, ns_r, ct_r in chunks if gT is not None else ():
        gT = gT + persistent_replay_call(
            scene, cp, seed, it_r, aux, phase="scatter", ext_g=g,
            ext_ct=ct_r, ext_ns=ns_r, **kw)
    return loss, _param_grads(scene, gA_raw, gI_raw, gT), nrays
