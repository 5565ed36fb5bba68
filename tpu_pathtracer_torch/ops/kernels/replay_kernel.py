"""Per-sample fused value-and-grad walk: CUDA kernel wrapper and plain
version.

Counterpart of ``tpu_pathtracer/ops/pallas/replay_kernel.py``
(``_replay_kernel``, TPU kernel 7) for sphere scenes. Lanes are (pixel,
sample), lane = pixel * spp + s with spp dividing 128, so a pixel's samples
sit in one 128-lane row. Each lane walks one path of up to max_bounces + 1
vertices (stratified over strat_k^2 cells, through the thin lens with
``use_dof``) and carries its streaming adjoint: every BSDF factor and
emission term is linear in its material colour A_m or light intensity I_l,
so with the path's radiance L after each vertex and its total L_tot

    dL_tot/dA_m = (L_tot * nA_m - cA_m) / A_m     dL_tot/dI_l = cI_l / I_l

where nA_m counts the vertices on m whose factor was applied and cA_m sums
L * ok - nee there. The cotangent g is applied after the walk: in mode
``"mse"`` the kernel forms each pixel's mean over its spp lanes and the
lane-local MSE cotangent against the target (loss and gradients in one
launch), in mode ``"vjp"`` g comes in per lane. Per-row partials are summed
by the wrapper; the callers divide the raw gradients by the clamped
parameters. The ray count is the TPU kernel's: lanes that act (alive and
hit), once per bounce.

``replay_call`` launches the CUDA kernel (``csrc/replay.cu``) for tensors on
a CUDA device and runs ``replay_call_ref``, the plain PyTorch version, for
tensors on the CPU. There is no fallback between the two.

Randomness, in the draw order u_cam v_cam [u_lens v_lens], then per bounce
u1 u2 u3 [ul1 ul2 usel]: test mode takes the JAX kernel's external block
(interpret mode, ``replay_kernel.py:684-697``), ``(n_draw * tile_rows,
128)`` per tile flattened, drawn there under ``jax.random.key(1)``;
production mode draws Philox4x32-10 keyed on (seed, salt) and countered on
(global lane, iteration, 0, ``STREAM | j // 4``) (``trace_kernel.py::
sample_draws``). ``tile_offset`` makes the lanes (and the draws) those of
global tiles, so that a slice of the image replays its part of the whole.

The TPU kernel has no mesh route (the JAX trainer refuses a mesh scene on
this engine); the port's ``replay_call`` raises ValueError for a mesh scene
too, where the JAX function would silently trace only its spheres.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import AREA_LIGHT, EPSILON, Scene
from tpu_pathtracer_torch.ops.kernels.persistent import (
    _MASK, _check, emitter_light_pdf, fma, sample_light, sample_lobe,
    thin_lens,
)
from tpu_pathtracer_torch.ops.kernels.replay_persistent import (
    MAX_GRAD_LIGHTS, MAX_SLOTS, _param_grads, material_slots,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (
    INV_PI, LANES, jitter_div, lanes_layout, pack_camera, pack_lights,
    pack_prims, sample_draws, sample_n_draws, scene_arguments, shadow_sweep,
    sphere_hits,
)
from tpu_pathtracer_torch.ops.vecmath import dot3, normalize3

STREAM = 0x50000  # Philox stream tag of this kernel's draws
MODES = ("mse", "vjp")

# Kernel launches by replay_call (plain-version calls are not counted).
launches = 0


def broadcast_pixels_to_lanes(img: Tensor, spp: int, rows_total: int
                              ) -> Tensor:
    """(H, W, 3) -> (rows_total, 128, 3), each pixel repeated spp times
    (lane = pixel * spp + s; padding zeros)."""
    flat = torch.repeat_interleave(img.reshape(-1, 3).to(torch.float32), spp,
                                   dim=0)
    pad = rows_total * LANES - flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
    return flat.reshape(rows_total, LANES, 3).contiguous()


def _check_call(scene: Scene, aux_lanes: Tensor, *, spp, width, height,
                tile_rows, max_bounces, strat_k, mode) -> None:
    if LANES % spp:
        raise ValueError(f"spp={spp} must divide {LANES}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if scene.mesh is not None:
        raise ValueError(
            "replay_call: the per-sample gradient kernel traces spheres "
            "only, and this scene has a mesh; use engine='persistent'")
    if width < 1 or height < 1 or tile_rows < 1 or max_bounces < 0 \
            or strat_k < 1:
        raise ValueError("width, height, tile_rows and strat_k must be >= 1, "
                         "max_bounces >= 0")
    rows_total = aux_lanes.shape[0]
    if aux_lanes.dim() != 3 or tuple(aux_lanes.shape[1:]) != (LANES, 3) \
            or rows_total % tile_rows:
        raise ValueError(f"aux_lanes must be (rows, {LANES}, 3) in whole "
                         f"tiles of {tile_rows} rows, got "
                         f"{tuple(aux_lanes.shape)}")


def _split(out: Tensor, scene: Scene) -> tuple[Tensor, Tensor]:
    """Per-slot and per-light rows (3 each, in that order) -> (gA_raw (M,
    3), gI_raw (NL, 3)), zeros for materials on no prim."""
    slot_mats = material_slots(scene)[0]
    n_slots = len(slot_mats)
    gA = out.new_zeros((scene.mat_color.shape[0], 3))
    if slot_mats:
        gA[list(slot_mats)] = out[:3 * n_slots].reshape(n_slots, 3)
    return gA, out[3 * n_slots:].reshape(-1, 3)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def replay_call_ref(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    iteration: int,
    aux_lanes: Tensor,
    *,
    spp: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    use_dof: bool = False,
    strat_k: int = 2,
    mode: str = "mse",
    tile_offset: int = 0,
    uniforms: Tensor | None = None,
    counts: dict | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of ``replay_call``: the JAX kernel's lane math,
    vectorized over all lanes with masked selects, with the explicit-FMA
    quadratics of the persistent plain versions. Same arguments and
    returns; if ``counts`` is a dict it also receives ``"shadow"``, the NEE
    shadow sweeps, and ``"shadow_prims"``, the spheres they test (every
    prim but the sampled light sphere; for the kernel's bound)."""
    _check_call(scene, aux_lanes, spp=spp, width=width, height=height,
                tile_rows=tile_rows, max_bounces=max_bounces, strat_k=strat_k,
                mode=mode)
    where = torch.where
    dev = aux_lanes.device
    rows_total = aux_lanes.shape[0]
    n_tiles = rows_total // tile_rows
    shape = (rows_total, LANES)
    n_lanes, n_pix = width * height * spp, width * height
    lane = (torch.arange(rows_total * LANES, device=dev).reshape(shape)
            + tile_offset * tile_rows * LANES)
    in_domain = lane < n_lanes
    nb = 6 if use_nee else 3
    u0 = 4 if use_dof else 2
    draw = sample_draws(lane, sample_n_draws(max_bounces, use_nee, use_dof),
                        tile_rows, int(seed[0]), int(seed[1]), int(iteration),
                        STREAM, uniforms)
    P = pack_prims(scene).to(dev)
    Ph = P.cpu().tolist()
    Lt = pack_lights(scene).cpu().tolist()
    cam = cam_packed.cpu().tolist()
    mtypes, emissive = tuple(scene.prim_mtypes), tuple(scene.emissive_prims)
    lights_static = tuple(scene.light_structure)
    n_prims, n_lights = int(scene.num_prims), len(lights_static)
    slot_mats, prim_slot = material_slots(scene)
    slot_of = torch.tensor(list(prim_slot) or [0], device=dev)
    any_delta = 1 in mtypes, 2 in mtypes
    fzeros = torch.zeros(shape, dtype=torch.float32, device=dev)

    # ---- camera ray (replay_kernel.py:184-218)
    pix, s_id = lane // spp, lane % spp
    jx, jy = jitter_div(s_id % (strat_k * strat_k), strat_k, draw(0),
                        draw(1))
    sx = (pix % width).to(torch.float32) + jx
    sy = (pix // width).to(torch.float32) + jy
    dx, dy, dz = normalize3(cam[0] - cam[6] * sy + cam[3] * sx,
                            cam[1] - cam[7] * sy + cam[4] * sx,
                            cam[2] - cam[8] * sy + cam[5] * sx)
    ox, oy, oz = fzeros + cam[9], fzeros + cam[10], fzeros + cam[11]
    if use_dof:
        ox, oy, oz, dx, dy, dz = thin_lens(cam, draw(2), draw(3), dx, dy, dz)

    Lr = Lg = Lb = fzeros
    Tr = Tg = Tb = fzeros + 1.0
    alive = in_domain
    prev_pdf = fzeros
    prev_delta = torch.ones(shape, dtype=torch.bool, device=dev)
    nA = [fzeros] * len(slot_mats)
    cA = [[fzeros] * 3 for _ in slot_mats]
    cI = [[fzeros] * 3 for _ in range(n_lights)]
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    n_shadow = n_shadow_prims = 0

    for bounce in range(max_bounces + 1):
        base = u0 + bounce * nb
        u1, u2, u3 = draw(base), draw(base + 1), draw(base + 2)
        h = sphere_hits(P, mtypes, emissive, ox, oy, oz, dx, dy, dz,
                        reciprocal=True)
        act = alive & h["hit"]
        n_live = n_live + act.sum()
        wox, woy, woz = dx, dy, dz
        nx, ny, nz = h["nx"], h["ny"], h["nz"]
        hx, hy, hz = h["hx"], h["hy"], h["hz"]
        ar, ag, ab = h["ar"], h["ag"], h["ab"]
        is_s, is_t = h["is_s"], h["is_t"]
        is_d = ~(is_s | is_t)
        bp = h["prim"]
        actf = act.to(torch.float32)

        # ---- emitter hit, MIS-weighted under NEE, credited to its light
        take = (act & (dot3(nx, ny, nz, -wox, -woy, -woz) > 0.0)).to(
            torch.float32)
        if use_nee:
            is_ps = [bp == q for q in range(n_prims)]
            ldp = emitter_light_pdf(Ph, Lt, lights_static, is_ps, ox, oy, oz,
                                    fzeros)
            pp2 = prev_pdf * prev_pdf
            take = take * where(prev_delta, 1.0,
                                pp2 / torch.clamp_min(pp2 + ldp * ldp,
                                                      1e-20))
        e = (Tr * h["er"] * take, Tg * h["eg"] * take, Tb * h["eb"] * take)
        Lr, Lg, Lb = Lr + e[0], Lg + e[1], Lb + e[2]
        for li, (ltype, lprim) in enumerate(lights_static):
            if ltype != AREA_LIGHT or lprim < 0:
                continue
            m = (bp == lprim).to(torch.float32)
            cI[li] = [cI[li][c] + e[c] * m for c in range(3)]

        # ---- NEE over the lights, the quadratic shadow sweep skipping the
        # sampled light sphere; credits cI (:280-401)
        nee = [fzeros] * 3
        if use_nee:
            ul1, ul2, usel = draw(base + 3), draw(base + 4), draw(base + 5)
            for li, (ltype, lprim) in enumerate(lights_static):
                lo, sel = Lt[li][6], Lt[li][7]
                if li == n_lights - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < lo + sel)
                (wlx, wly, wlz, dist, pdf_l, rad, valid,
                 is_delta) = sample_light(Ph, Lt, li, ltype, lprim, hx, hy,
                                          hz, ul1, ul2, fzeros)
                area = ltype == AREA_LIGHT and lprim >= 0
                occ = shadow_sweep(P, hx, hy, hz, wlx, wly, wlz,
                                   fma(dist, 1.0 - 1e-3, -EPSILON),
                                   skip=lprim if area else -1)
                cos_l = dot3(wlx, wly, wlz, nx, ny, nz)
                support = ((cos_l > 0.0)
                           & (dot3(wox, woy, woz, wlx, wly, wlz) < 0.0)
                           & is_d)
                if is_delta:
                    w_mis = 1.0
                else:
                    pdf_b = where(support, cos_l * INV_PI, 0.0)
                    w_mis = (pdf_l * pdf_l) / torch.clamp_min(
                        pdf_l * pdf_l + pdf_b * pdf_b, 1e-20)
                swept = act & m_l & valid & support
                n_swept = int(swept.sum())
                n_shadow += n_swept
                n_shadow_prims += n_swept * (len(P) - (1 if area else 0))
                gate = (swept & ~occ).to(torch.float32)
                scale = gate * cos_l * w_mis / torch.clamp_min(pdf_l, 1e-20)
                t = (Tr * (ar * INV_PI) * rad[0] * scale,
                     Tg * (ag * INV_PI) * rad[1] * scale,
                     Tb * (ab * INV_PI) * rad[2] * scale)
                nee = [nee[c] + t[c] for c in range(3)]
                cI[li] = [cI[li][c] + t[c] for c in range(3)]
            Lr, Lg, Lb = Lr + nee[0], Lg + nee[1], Lb + nee[2]

        # ---- BSDF sampling: the polar diffuse map, mirror, dielectric
        wix, wiy, wiz, fr, fg, fb, pdf, wgt = sample_lobe(
            nx, ny, nz, wox, woy, woz, ar, ag, ab, h["coef"], is_s, is_t,
            is_d, u1, u2, *any_delta)
        step_ok = act & ~((fr <= 0.0) & (fg <= 0.0) & (fb <= 0.0)) \
            & (pdf > 0.0)
        okf = step_ok.to(torch.float32)

        # ---- streaming adjoint at the vertex's material (:491-506)
        slot = slot_of[bp]
        for k in range(len(slot_mats)):
            mf = (slot == k).to(torch.float32)
            nA[k] = nA[k] + mf * okf
            cA[k] = [cA[k][c] + (L * okf - nee[c] * actf) * mf
                     for c, L in enumerate((Lr, Lg, Lb))]

        Tr = where(step_ok, Tr * fr * wgt, Tr)
        Tg = where(step_ok, Tg * fg * wgt, Tg)
        Tb = where(step_ok, Tb * fb * wgt, Tb)

        # ---- Russian roulette (:521-532)
        if bounce > rr_start:
            p_cont = torch.clamp_max(torch.maximum(Tr, torch.maximum(Tg, Tb)),
                                     0.5)
            survive = u3 <= p_cont
            boost = step_ok & survive & (p_cont > 0.0)
            inv_p = 1.0 / torch.clamp_min(p_cont, 1e-20)
            Tr = where(boost, Tr * inv_p, Tr)
            Tg = where(boost, Tg * inv_p, Tg)
            Tb = where(boost, Tb * inv_p, Tb)
            alive = step_ok & survive & (bounce < max_bounces)
        else:
            alive = step_ok & (bounce < max_bounces)

        # dead lanes keep their last finite ray (:534-541)
        ox, oy, oz = where(act, hx, ox), where(act, hy, oy), where(act, hz, oz)
        dx, dy, dz = (where(act, wix, dx), where(act, wiy, dy),
                      where(act, wiz, dz))
        prev_pdf = pdf
        prev_delta = is_s | is_t

    # ---- the cotangent per lane (:547-579)
    dom_f = in_domain.to(torch.float32)
    L = (Lr, Lg, Lb)
    inv_loss_n = 1.0 / (n_pix * 3)
    if mode == "mse":
        groups = (rows_total, LANES // spp, spp)
        g, sse = [], fzeros.new_zeros(n_tiles)
        lead_dom = dom_f.reshape(groups)[..., 0]
        for c in range(3):
            lg = L[c].reshape(groups)
            total = lg[..., 0]
            for s in range(1, spp):  # the JAX kernel's order
                total = total + lg[..., s]
            d = (total / spp - aux_lanes[..., c].reshape(groups)[..., 0]) \
                * lead_dom
            sse = sse + (d * d).reshape(n_tiles, -1).sum(1)
            g.append((d * (2.0 * inv_loss_n / spp))[..., None]
                     .expand(groups).reshape(shape))
        loss = (sse * inv_loss_n).sum()
    else:
        g = [aux_lanes[..., c] * dom_f for c in range(3)]
        loss = fzeros.new_zeros(())

    parts = []
    for k in range(len(slot_mats)):
        parts += [(g[c] * (L[c] * nA[k] - cA[k][c])).sum() for c in range(3)]
    for li in range(n_lights):
        parts += [(g[c] * cI[li][c]).sum() for c in range(3)]
    gA_raw, gI_raw = _split(torch.stack(parts) if parts else fzeros.new_zeros(
        0), scene)
    if counts is not None:
        counts["shadow"] = n_shadow
        counts["shadow_prims"] = n_shadow_prims
    L_lanes = torch.stack([x * dom_f for x in L], dim=-1)
    return L_lanes, loss, gA_raw, gI_raw, n_live


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    """The bound C entry point of csrc/replay.cu (built on first use)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    fn = lib.tpt_replay
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        p, ip, ip, i,  # prims (device), flags, slots (host), n_prims
        p, ip, i, i,  # lights (device), light structure (host), n, n_slots
        p, p, p,  # camera, uniforms (or NULL), aux lanes (device)
        p, p, p, p, p,  # lr lg lb partials nrays (device)
        i, i, i, i, i, i,  # rows_total tile_rows spp strat_k width n_lanes
        i, i, i, i, i, i,  # max_bounces rr_start use_nee use_dof mse
        #                    tile_offset
        f, f, u, u, u,  # inv_loss_n g_scale seed salt iteration
        p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return fn, lib.tpt_error_string


def sample_smem_bytes(n_slots: int, n_lights: int, spp: int) -> int:
    """Bytes of dynamic shared memory that one 128-lane block of the kernel
    takes (``csrc/replay.cu::smem_words``): per lane nA and cA (4 words per
    slot) and, at spp > 32, the pixel mean's radiance (3 words); the
    epilogue's four warp sums per partial (3 per slot, 3 per light, the
    loss) and, per warp, its reached slots and lights and its ray count."""
    words = (LANES * (4 * n_slots + (3 if spp > 32 else 0))
             + 4 * (3 * n_slots + 3 * n_lights + 1) + 12)
    return 4 * words


def sample_blocks_per_sm(n_slots: int, n_lights: int, spp: int, *,
                         dof: bool) -> tuple[int, int]:
    """(bytes of shared memory per block, blocks per SM) of one build of the
    kernel, as the card's occupancy calculator gives them (needs the card);
    raises if the kernel's own count of bytes differs from
    ``sample_smem_bytes``."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    size, occ = lib.tpt_replay_sample_smem_bytes, \
        lib.tpt_replay_sample_occupancy
    size.argtypes = [ctypes.c_int] * 3
    occ.argtypes = [ctypes.c_int] * 4
    size.restype = occ.restype = ctypes.c_int
    nbytes = size(n_slots, n_lights, spp)
    if nbytes != sample_smem_bytes(n_slots, n_lights, spp):
        raise RuntimeError(f"the kernel takes {nbytes} B of shared memory, "
                           f"sample_smem_bytes says "
                           f"{sample_smem_bytes(n_slots, n_lights, spp)}")
    n = occ(int(dof), n_slots, n_lights, spp)
    if n < 0:
        raise RuntimeError("the per-sample kernel's occupancy query failed")
    return nbytes, n


def _replay_cuda(scene, cam_packed, seed, iteration, aux_lanes, *, spp,
                 width, height, max_bounces, rr_start, tile_rows, use_nee,
                 use_dof, strat_k, mode, tile_offset, uniforms):
    global launches
    dev = aux_lanes.device
    rows_total = aux_lanes.shape[0]
    if (rows_total + tile_offset * tile_rows) * LANES >= 2 ** 31:
        raise ValueError(f"{rows_total} rows of lanes at tile offset "
                         f"{tile_offset} exceed int32 lane ids")
    _check(aux_lanes, "aux_lanes", torch.float32, (rows_total, LANES, 3), dev)
    _check(cam_packed, "cam_packed", torch.float32, (24,), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32,
               (rows_total * sample_n_draws(max_bounces, use_nee, use_dof),
                LANES), dev)
    prims, pflags, n_prims, lights, lstruct, n_lights = scene_arguments(
        scene, dev, MAX_GRAD_LIGHTS)
    slot_mats, prim_slot = material_slots(scene)
    n_slots = len(slot_mats)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"the kernel takes at most {MAX_SLOTS} materials on "
                         f"prims, got {n_slots}")
    slots = (ctypes.c_int * max(n_prims, 1))(*prim_slot)
    shape = (rows_total, LANES)
    lr, lg, lb = (torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(3))
    n_k = 3 * n_slots + 3 * n_lights + 1
    partials = torch.empty((rows_total, n_k), dtype=torch.float32,
                           device=dev)
    nrays = torch.empty(rows_total, dtype=torch.int32, device=dev)
    inv_loss_n = 1.0 / (width * height * 3)
    fn, error_string = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(prims.data_ptr(), pflags, slots, n_prims,
                 lights.data_ptr(), lstruct, n_lights, n_slots,
                 cam_packed.data_ptr(),
                 uniforms.data_ptr() if uniforms is not None else None,
                 aux_lanes.data_ptr(), lr.data_ptr(), lg.data_ptr(),
                 lb.data_ptr(), partials.data_ptr(), nrays.data_ptr(),
                 rows_total, tile_rows, spp, strat_k, width,
                 width * height * spp, max_bounces, rr_start, int(use_nee),
                 int(use_dof), int(mode == "mse"), int(tile_offset),
                 inv_loss_n, 2.0 * inv_loss_n / spp,
                 int(seed[0]) & _MASK, int(seed[1]) & _MASK,
                 int(iteration) & _MASK, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"replay kernel launch failed: {msg} ({err})")
    launches += 1
    part = partials.sum(0)
    gA_raw, gI_raw = _split(part[:n_k - 1], scene)
    return (torch.stack([lr, lg, lb], dim=-1), part[n_k - 1], gA_raw, gI_raw,
            nrays.sum())


def replay_call(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    iteration: int,
    aux_lanes: Tensor,
    *,
    spp: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    use_dof: bool = False,
    strat_k: int = 2,
    mode: str = "mse",
    tile_offset: int = 0,
    uniforms: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One fused fwd+bwd walk over the (rows_total, 128) lane layout.

    ``seed`` is ``(seed, salt)`` and ``iteration`` the RNG frame, as host
    integers; ``aux_lanes`` (rows_total, 128, 3) is the per-pixel target
    broadcast to the lanes (mode ``"mse"``, ``broadcast_pixels_to_lanes``)
    or the per-lane cotangent g (mode ``"vjp"``). ``tile_offset`` is the
    global index of the first tile. Returns, as the JAX function does,
    (L_lanes (rows, 128, 3), loss (0 in "vjp" mode), gA_raw (M, 3), gI_raw
    (NL, 3), live rays); callers divide the raw gradients by
    clamp(mat_color, 1e-8) and clamp(light_intensity, 1e-8). spp must
    divide 128 (ValueError otherwise, as in JAX); a mesh scene raises
    ValueError. For tensors on a CUDA device this launches the CUDA kernel
    on the current stream; on the CPU it runs ``replay_call_ref``; any
    other device raises."""
    kw = dict(spp=spp, width=width, height=height, max_bounces=max_bounces,
              rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
              use_dof=use_dof, strat_k=strat_k, mode=mode,
              tile_offset=tile_offset, uniforms=uniforms)
    dev = aux_lanes.device
    if dev.type == "cuda":
        _check_call(scene, aux_lanes, spp=spp, width=width, height=height,
                    tile_rows=tile_rows, max_bounces=max_bounces,
                    strat_k=strat_k, mode=mode)
        return _replay_cuda(scene, cam_packed, seed, iteration, aux_lanes,
                            **kw)
    if dev.type == "cpu":
        return replay_call_ref(scene, cam_packed, seed, iteration, aux_lanes,
                               **kw)
    raise ValueError(f"replay_call: unsupported device {dev}")


def mse_value_and_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    iteration: int,
    target: Tensor,
    *,
    spp: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    strat_k: int = 2,
    uniforms: Tensor | None = None,
) -> tuple[Tensor, dict, Tensor]:
    """Loss and gradients w.r.t. {mat_color, light_intensity} of
    mean((render - target)^2), ``target`` (H, W, 3), in ONE kernel walk;
    a lens camera's paths start on its thin lens. Returns (loss, grads,
    live rays)."""
    w, h = camera.width, camera.height
    rows_total, _ = lanes_layout(w, h, spp, tile_rows)
    aux = broadcast_pixels_to_lanes(target, spp, rows_total)
    _, loss, gA_raw, gI_raw, nrays = replay_call(
        scene, pack_camera(camera), seed, iteration, aux, spp=spp, width=w,
        height=h, max_bounces=max_bounces, rr_start=rr_start,
        tile_rows=tile_rows, use_nee=use_nee, use_dof=camera.use_dof,
        strat_k=strat_k, mode="mse", uniforms=uniforms)
    return loss, _param_grads(scene, gA_raw, gI_raw, None), nrays


def lane_cotangent(L_lanes: Tensor, target_lanes: Tensor, spp: int,
                   width: int, height: int, lane0: int = 0) -> Tensor:
    """(rows, 128, 3) lane-local MSE cotangent of the pixel means of
    ``L_lanes`` against the broadcast target: what mode "mse" applies,
    for mode "vjp" (``lane0`` is the global lane of the first row)."""
    rows = L_lanes.shape[0]
    groups = (rows, LANES // spp, spp, 3)
    mean = L_lanes.reshape(groups).sum(2, keepdim=True) / spp
    lane = torch.arange(rows * LANES, device=L_lanes.device).reshape(
        rows, LANES) + lane0
    dom = (lane < width * height * spp).to(torch.float32)[..., None]
    d = (mean - target_lanes.reshape(groups)[:, :, :1]).expand(groups)
    return d.reshape(rows, LANES, 3) * dom * (2.0 / (width * height * 3)
                                              / spp)

