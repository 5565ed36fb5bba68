"""Per-sample path-trace kernel: CUDA kernel wrapper, plain version and the
scene and camera tables of every kernel.

Counterpart of ``tpu_pathtracer/ops/pallas/trace_kernel.py``: the fused
per-sample forward ``pallas_render`` (``_trace_kernel``, TPU kernel 8) and
the packers (``:625-703``), with the same layouts. One lane traces one path,
lane = pixel * spp + s over ``(rows_total, 128)`` planes cut into tiles of
``tile_rows`` rows; padded tail lanes never trace. The primary hit comes
before the bounce loop; every bounce adds the emitter hit (MIS-weighted
under NEE), NEE over point and sphere lights with a quadratic shadow sweep
over every sphere, one BSDF lobe (the diffuse one through the concentric
disk map) and Russian roulette once ``bounce > rr_start``. Samples are
stratified when spp is a perfect square > 1. The ray count is the TPU
kernel's: every primary lane, then every lane alive after each bounce.

``trace_lanes`` (and ``pallas_render`` on it) launches the CUDA kernel
(``csrc/trace.cu``) for a packed camera on a CUDA device and runs
``trace_lanes_ref``, the plain PyTorch version, for one on the CPU. There is
no fallback between the two. The kernel runs a grid of resident blocks
(``_trace_grid``) whose threads take the (pixel, sample) items one after
another: each item's radiance and draws are those of its lane.

Randomness: the TPU kernel draws from the TPU's hardware generator, which
the Pallas interpreter stubs to zeros, and takes no external uniforms. The
port defines both modes, in the draw order u_cam v_cam, then per bounce u1
u2 u3 [ul1 ul2 usel] (``sample_n_draws``):

* test mode (``uniforms`` given): a block in ``replay_call``'s external
  layout without DOF, ``(n_draw * tile_rows, 128)`` per tile, flattened to
  ``(n_tiles * n_draw * tile_rows, 128)``; all zeros reproduces the JAX
  kernel in interpret mode;
* production mode: Philox4x32-10 keyed on (seed, salt) and countered on
  (lane, iteration, 0, ``STREAM | j // 4``), word j % 4 for draw j
  (``sample_draws``), the same bits on the CPU and on the card.

The TPU kernel reads only the pinhole slots of the packed camera and the
sphere table, so a lens camera renders there as a pinhole one and a mesh is
not traced; the port raises ValueError for both instead (a recorded
departure from the reference, ROADMAP Queue 3).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, EPSILON, SPECULAR, TRANSMISSIVE, TRI_LIGHT, Scene,
    prim_attrs,
)
from tpu_pathtracer_torch.ops.vecmath import dot3, normalize3

LANES = 128  # lanes per row of every state plane
BIG = 1e30
INV_PI = 1.0 / math.pi
STREAM = 0x40000  # Philox stream tag of this kernel's draws
MAX_PRIMS = 256  # sizes of the kernel's __constant__ tables
MAX_LIGHTS = 64

# Kernel launches by trace_lanes / pallas_render (plain-version calls are
# not counted).
launches = 0


def pack_camera(camera) -> Tensor:
    """(24,) f32: first_ray_dir[0:3], px_x[3:6], px_y[6:9], pos[9:12],
    lens_radius[12], focal_distance[13], view rows u[14:17], v[17:20],
    w[20:23], pad[23]. The persistent kernels read the lens slots when
    launched with ``use_dof``."""
    return torch.cat([
        camera.first_ray_dir, camera.px_x, camera.px_y, camera.pos,
        camera.focal_distance.new_full((1,), camera.lens_radius),
        camera.focal_distance[None],
        camera.view[0], camera.view[1], camera.view[2],
        torch.zeros(1, dtype=torch.float32, device=camera.device),
    ]).to(torch.float32)


def pack_prims(scene: Scene) -> Tensor:
    """(P, 12) per-prim table: cx cy cz r ax ay az coef mtype ex ey ez."""
    attrs = prim_attrs(scene)
    n = int(scene.num_prims)
    return torch.cat([
        scene.centers[:n],
        scene.radii[:n, None],
        attrs.albedo[:n],
        attrs.coef[:n, None],
        attrs.mtype[:n, None].to(torch.float32),
        attrs.emission[:n],
    ], dim=1)


def pack_lights(scene: Scene) -> Tensor:
    """(L, 8) light table for NEE: pos3 intensity3 cdf_lo sel_pdf, with
    power-proportional selection probabilities: luminance times the
    sphere's area for sphere lights, times the total emissive area for
    triangle lights, luminance alone for point lights."""
    lights_static = tuple(scene.light_structure)
    dev = scene.device
    if not lights_static:
        return torch.zeros((1, 8), dtype=torch.float32, device=dev)
    lum_w = torch.tensor([0.212671, 0.715160, 0.072169], device=dev)
    rows, powers = [], []
    for li, (ltype, lprim) in enumerate(lights_static):
        inten = scene.light_intensity[li]
        lum = torch.sum(inten * lum_w)
        if ltype == AREA_LIGHT and lprim >= 0:
            r = scene.radii[lprim]
            powers.append(lum * 4.0 * math.pi * r * r)
            pos = scene.centers[lprim]
        elif ltype == TRI_LIGHT:
            powers.append(lum * scene.tl_area[li])
            pos = scene.light_pos[li]
        else:
            powers.append(lum)
            pos = scene.light_pos[li]
        rows.append((pos, inten))
    pw = torch.stack(powers)
    total = torch.clamp_min(torch.sum(pw), 1e-20)
    sel = pw / total
    cdf_lo = torch.cat([torch.zeros(1, device=dev), torch.cumsum(sel, 0)[:-1]])
    return torch.stack([
        torch.cat([pos, inten, cdf_lo[li, None], sel[li, None]])
        for li, (pos, inten) in enumerate(rows)
    ]).to(torch.float32)


# ---------------------------------------------------------------------------
# The per-sample lane layout and draws (shared with replay_kernel.py)
# ---------------------------------------------------------------------------

def lanes_layout(width: int, height: int, spp: int, tile_rows: int = 16,
                 tiles_multiple: int = 1) -> tuple[int, int]:
    """(rows_total, n_lanes) of the lane = pixel * spp + s layout, whole
    tiles of ``tile_rows`` rows (their count a multiple of
    ``tiles_multiple``, so that rows split evenly over shards); JAX
    ``replay_kernel.py::lanes_layout``, which ``replay_kernel`` exports."""
    n_lanes = width * height * spp
    n_tiles = -(-n_lanes // (tile_rows * LANES))
    n_tiles = -(-n_tiles // tiles_multiple) * tiles_multiple
    return n_tiles * tile_rows, n_lanes


def sample_strat_k(spp: int) -> int:
    """The kernel's stratification: a k x k grid when spp = k^2 > 1, else 1
    (plain jitter)."""
    k = int(round(spp ** 0.5))
    return k if k * k == spp and k > 1 else 1


def sample_n_draws(max_bounces: int, use_nee: bool,
                   use_dof: bool = False) -> int:
    """Uniforms per lane: u_cam v_cam [u_lens v_lens], then per bounce u1
    u2 u3 [ul1 ul2 usel]."""
    return (4 if use_dof else 2) + (max_bounces + 1) * (6 if use_nee else 3)


def sample_draws(lane: Tensor, n_draw: int, tile_rows: int, seed: int,
                 salt: int, iteration: int, stream: int,
                 uniforms: Tensor | None = None):
    """``draw(j)``: draw j of every lane of a per-sample walk, shaped like
    ``lane`` (rows_total, 128). Test mode reads the external block
    ``uniforms`` (``(n_tiles * n_draw * tile_rows, 128)``, draw j of tile t
    at rows ``(t * n_draw + j) * tile_rows``); production mode draws Philox
    countered on (lane, iteration, 0, stream | j // 4), word j % 4, one
    group of four at a time, as the kernels do (``pt_common.cuh::
    SampleDraws``)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import (
        _MASK, bits_to_uniform, philox4x32,
    )

    rows_total = lane.shape[0]
    if uniforms is not None:
        blk = uniforms.reshape(rows_total // tile_rows, n_draw, tile_rows,
                               LANES)
        return lambda j: blk[:, j].reshape(rows_total, LANES)
    lane32 = lane.to(torch.int64) & _MASK
    cache: dict = {}

    def draw(j: int) -> Tensor:
        g = j // 4
        if g not in cache:
            cache.clear()
            cache[g] = [bits_to_uniform(w) for w in philox4x32(
                lane32, iteration, 0, stream | g, seed, salt)]
        return cache[g][j % 4]

    return draw


def jitter_div(cell: Tensor, k: int, u: Tensor, v: Tensor):
    """Sub-pixel jitter of a per-sample lane: cell of a k x k grid, divided
    by k as the per-sample TPU kernels divide (``pt_common.cuh::
    jitter_div``)."""
    jx = ((cell % k).to(torch.float32) + u) / k - 0.5
    jy = ((cell // k).to(torch.float32) + v) / k - 0.5
    return jx, jy


def sphere_hits(P: Tensor, mtypes: Sequence[int], emissive: Sequence[int],
                ox, oy, oz, dx, dy, dz, *, reciprocal: bool) -> dict:
    """Closest sphere hit of every lane (primitive.h:44 roots: t0 = b - sq
    if t0 > tmin, else b + sq), the first prim winning an exact tie, with
    the explicit-FMA quadratics of the persistent plain versions. ``P`` is
    the pack_prims table; the normal divides by the radius (kernel 8) or,
    with ``reciprocal``, multiplies by its f32 reciprocal (kernel 7).
    Lanes that miss report prim 0's attributes and the origin as their
    hit point (no lane uses them)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import dot3_fma, fma

    best_t = torch.full_like(dx, BIG)
    best_p = torch.zeros(dx.shape, dtype=torch.int64, device=dx.device)
    for q, (cx, cy, cz, r) in enumerate(P[:, :4].cpu().tolist()):
        opx, opy, opz = cx - ox, cy - oy, cz - oz
        b = dot3_fma(opx, opy, opz, dx, dy, dz)
        det = fma(r, r, fma(b, b, -dot3_fma(opx, opy, opz, opx, opy, opz)))
        sq = torch.sqrt(torch.clamp_min(det, 0.0))
        t0 = b - sq
        t = torch.where(t0 > EPSILON, t0, b + sq)
        closer = (det >= 0.0) & (t > EPSILON) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_p = torch.where(closer, q, best_p)
    hit = best_t < 0.5 * BIG
    tt = torch.where(hit, best_t, 0.0)
    hx, hy, hz = fma(dx, tt, ox), fma(dy, tt, oy), fma(dz, tt, oz)
    row = P[best_p]
    if reciprocal:
        inv_r = 1.0 / row[..., 3]
        nx, ny, nz = ((hx - row[..., 0]) * inv_r, (hy - row[..., 1]) * inv_r,
                      (hz - row[..., 2]) * inv_r)
    else:
        nx, ny, nz = ((hx - row[..., 0]) / row[..., 3],
                      (hy - row[..., 1]) / row[..., 3],
                      (hz - row[..., 2]) / row[..., 3])
    mt = torch.tensor(list(mtypes) or [0], device=dx.device)[best_p]
    em = torch.zeros(P.shape[0] or 1, dtype=torch.bool, device=dx.device)
    em[list(emissive)] = True
    em = em[best_p]
    is_s, is_t = mt == SPECULAR, mt == TRANSMISSIVE
    zero = torch.zeros_like(dx)
    return dict(hit=hit, prim=best_p, hx=hx, hy=hy, hz=hz, nx=nx, ny=ny,
                nz=nz, ar=row[..., 4], ag=row[..., 5], ab=row[..., 6],
                coef=torch.where(is_s | is_t, row[..., 7], zero),
                is_s=is_s, is_t=is_t,
                er=torch.where(em, row[..., 9], zero),
                eg=torch.where(em, row[..., 10], zero),
                eb=torch.where(em, row[..., 11], zero))


def shadow_sweep(P: Tensor, hx, hy, hz, wlx, wly, wlz, smax,
                 skip: int = -1) -> Tensor:
    """Any sphere but ``skip`` whose quadratic root lies in (tmin, smax)
    (scene.h:101-108), with the explicit-FMA quadratic."""
    from tpu_pathtracer_torch.ops.kernels.persistent import dot3_fma, fma

    occ = torch.zeros(hx.shape, dtype=torch.bool, device=hx.device)
    for q, (cx, cy, cz, r) in enumerate(P[:, :4].cpu().tolist()):
        if q == skip:
            continue
        sx, sy, sz = cx - hx, cy - hy, cz - hz
        rb = dot3_fma(sx, sy, sz, wlx, wly, wlz)
        rdet = fma(r, r, fma(rb, rb, -dot3_fma(sx, sy, sz, sx, sy, sz)))
        rsq = torch.sqrt(torch.clamp_min(rdet, 0.0))
        rt = torch.where(rb - rsq > EPSILON, rb - rsq, rb + rsq)
        occ = occ | ((rdet >= 0.0) & (rt > EPSILON) & (rt < smax))
    return occ


# ---------------------------------------------------------------------------
# Kernel 8's own arithmetic
# ---------------------------------------------------------------------------

def refuse_unsupported(scene: Scene, lens_radius: float, who: str) -> None:
    """Raise ValueError for what the TPU kernel would trace as something
    else: a mesh (it walks the sphere table only) and a lens (it reads the
    pinhole slots of the packed camera only)."""
    if scene.mesh is not None:
        raise ValueError(
            f"{who}: the per-sample kernel traces spheres only, and this "
            "scene has a mesh; render it with PersistentRenderer or the "
            "wavefront")
    if lens_radius > 0.0:
        raise ValueError(
            f"{who}: the per-sample kernel traces a pinhole camera, and this "
            f"camera has a lens (lens_radius {lens_radius}); render it with "
            "PersistentRenderer or the wavefront")


def _light_sample_div(P, Lt, li, ltype, lprim, hx, hy, hz, ul1, ul2):
    """NEE sample of light ``li``, kernel 8's arithmetic (sqrt and divide,
    ``csrc/trace.cu::sample_light_div``): (wlx, wly, wlz, dist, pdf, rad,
    valid, area)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import dot3_fma, fma

    where = torch.where
    sel = Lt[li][7]
    if ltype == AREA_LIGHT and lprim >= 0:
        cx, cy, cz, rl = P[lprim][:4]
        wrx, wry, wrz = cx - hx, cy - hy, cz - hz
        d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz)
        distc = torch.sqrt(torch.clamp_min(d2l, 1e-20))
        wcx, wcy, wcz = wrx / distc, wry / distc, wrz / distc
        sin2 = torch.clamp_max(rl * rl / torch.clamp_min(d2l, 1e-12), 1.0)
        ctm = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        cth = 1.0 - ul1 * (1.0 - ctm)
        sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
        phi = (2.0 * math.pi) * ul2
        usex = torch.abs(wcx) > torch.abs(wcz)
        ax, ay, az = normalize3(where(usex, -wcy, 0.0),
                                where(usex, wcx, -wcz),
                                where(usex, 0.0, wcy))
        bx = wcy * az - wcz * ay
        by = wcz * ax - wcx * az
        bz = wcx * ay - wcy * ax
        cp = torch.cos(phi) * sth
        sp = torch.sin(phi) * sth
        wlx = ax * cp + bx * sp + wcx * cth
        wly = ay * cp + by * sp + wcy * cth
        wlz = az * cp + bz * sp + wcz * cth
        bq = dot3_fma(wrx, wry, wrz, wlx, wly, wlz)
        detq = fma(rl, rl, fma(bq, bq, -d2l))
        thit = bq - torch.sqrt(torch.clamp_min(detq, 0.0))
        valid = (detq >= 0.0) & (thit > EPSILON) & (d2l > rl * rl)
        nsx = (hx + wlx * thit - cx) / rl
        nsy = (hy + wly * thit - cy) / rl
        nsz = (hz + wlz * thit - cz) / rl
        valid = valid & (dot3(nsx, nsy, nsz, -wlx, -wly, -wlz) > 0.0)
        pdf = sel / (2.0 * math.pi * torch.clamp_min(1.0 - ctm, 1e-12))
        return (wlx, wly, wlz, thit, pdf, tuple(Lt[li][3:6]), valid, True)
    wrx, wry, wrz = Lt[li][0] - hx, Lt[li][1] - hy, Lt[li][2] - hz
    d2l = dot3(wrx, wry, wrz, wrx, wry, wrz)
    dist = torch.sqrt(torch.clamp_min(d2l, 1e-20))
    inv_d2 = 1.0 / torch.clamp_min(d2l, 1e-12)
    rad = tuple(Lt[li][3 + c] * inv_d2 for c in range(3))
    return (wrx / dist, wry / dist, wrz / dist, dist,
            torch.full_like(dist, sel), rad, dist > EPSILON, False)


def concentric_lobe(nx, ny, nz, wox, woy, woz, u1, u2):
    """The diffuse lobe of kernel 8 (``trace_kernel.py:385-420``): the
    concentric disk map with its degenerate centre and zero-safe divides,
    lifted to the cosine hemisphere around n and re-normalized. Returns
    (wdx, wdy, wdz, pdf_d)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import fma

    where = torch.where
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    in_r12 = sx >= -sy
    in_r1 = in_r12 & (sx > sy)
    in_r2 = in_r12 & ~in_r1
    in_r3 = ~in_r12 & (sx <= sy)

    def safe(a, b):
        return a / where(torch.abs(b) > 0.0, b, 1.0)

    rr = where(in_r1, sx, where(in_r2, sy, where(in_r3, -sx, -sy)))
    th = where(in_r1, safe(sy, sx),
               where(in_r2, 2.0 - safe(sx, sy),
                     where(in_r3, 4.0 + safe(sy, sx), 6.0 - safe(sx, sy))))
    th = th * (math.pi / 4.0)
    degen = (sx == 0.0) & (sy == 0.0)
    ldx = where(degen, 0.0, rr * torch.cos(th))
    ldy = where(degen, 0.0, rr * torch.sin(th))
    # With both products fused, as XLA computes it: at the disk's rim
    # (|ld| = 1 to rounding, every lane of an all-zero block) the rounded
    # form gives 0 where XLA gives ~3e-8, and the lobe's pdf flips to 0.
    ldz = torch.sqrt(torch.clamp_min(fma(-ldy, ldy, fma(-ldx, ldx, 1.0)),
                                     0.0))
    use_x = torch.abs(nx) > torch.abs(nz)
    ux, uy, uz = normalize3(where(use_x, -ny, 0.0), where(use_x, nx, -nz),
                            where(use_x, 0.0, ny))
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    wdx, wdy, wdz = normalize3(ux * ldx + vx * ldy + nx * ldz,
                               uy * ldx + vy * ldy + ny * ldz,
                               uz * ldx + vz * ldy + nz * ldz)
    cos_d = dot3(wdx, wdy, wdz, nx, ny, nz)
    pdf_d = where(dot3(wox, woy, woz, wdx, wdy, wdz) < 0.0,
                  torch.abs(cos_d) * INV_PI, 0.0)
    return wdx, wdy, wdz, pdf_d


def _seed3(seed3) -> tuple[int, int, int]:
    """[seed, iteration, salt] as host ints."""
    seed, iteration, salt = (int(x) for x in seed3)
    return seed, iteration, salt


def _check_layout(spp, width, height, tile_rows, max_bounces):
    if spp < 1 or width < 1 or height < 1 or tile_rows < 1 \
            or max_bounces < 0:
        raise ValueError("spp, width, height and tile_rows must be >= 1, "
                         "max_bounces >= 0")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def trace_lanes_ref(
    scene: Scene,
    cam_packed: Tensor,
    seed3: Sequence[int],
    *,
    spp: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    uniforms: Tensor | None = None,
    counts: dict | None = None,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of ``trace_lanes``: the JAX kernel's lane math,
    vectorized over all lanes with masked selects. Returns (L_lanes
    (rows_total, 128, 3), rays traced). If ``counts`` is a dict it also
    receives ``"shadow"``, the NEE shadow sweeps (for the kernel's
    bound), and the walks' lengths in traced segments (a lane's primary
    ray and each continuing segment: its rays): ``"lane_segments"``, the
    (rows_total, 128) int32 plane of them (0 on padding lanes),
    ``"vertices"``, their sum (the ray count), and ``"warp_longest"``, the
    sum over the 32-lane warps of 32 times the warp's longest walk (what a
    warp that runs until its longest path ends spends)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import (
        emitter_light_pdf, fma, sample_lobe,
    )

    refuse_unsupported(scene, float(cam_packed[12]), "trace_lanes_ref")
    _check_layout(spp, width, height, tile_rows, max_bounces)
    seed, iteration, salt = _seed3(seed3)
    dev = cam_packed.device
    rows_total, n_lanes = lanes_layout(width, height, spp, tile_rows)
    shape = (rows_total, LANES)
    lane = torch.arange(rows_total * LANES, device=dev).reshape(shape)
    in_domain = lane < n_lanes
    nb = 6 if use_nee else 3
    n_draw = sample_n_draws(max_bounces, use_nee)
    draw = sample_draws(lane, n_draw, tile_rows, seed, salt, iteration,
                        STREAM, uniforms)
    P = pack_prims(scene).to(dev)
    Ph = P.cpu().tolist()
    Lt = pack_lights(scene).cpu().tolist()
    cam = cam_packed.cpu().tolist()
    mtypes, emissive = tuple(scene.prim_mtypes), tuple(scene.emissive_prims)
    lights_static = tuple(scene.light_structure)
    n_prims = int(scene.num_prims)
    any_delta = SPECULAR in mtypes, TRANSMISSIVE in mtypes
    where = torch.where
    fzeros = torch.zeros(shape, dtype=torch.float32, device=dev)

    # ---- camera rays (trace_kernel.py:144-165)
    s, pix = lane % spp, lane // spp
    k = sample_strat_k(spp)
    jx, jy = jitter_div(s % (k * k), k, draw(0), draw(1))
    sx = (pix % width).to(torch.float32) + jx
    sy = (pix // width).to(torch.float32) + jy
    dx, dy, dz = normalize3(cam[0] - cam[6] * sy + cam[3] * sx,
                            cam[1] - cam[7] * sy + cam[4] * sx,
                            cam[2] - cam[8] * sy + cam[5] * sx)
    pox, poy, poz = (fzeros + cam[9], fzeros + cam[10], fzeros + cam[11])
    h = sphere_hits(P, mtypes, emissive, pox, poy, poz, dx, dy, dz,
                    reciprocal=False)
    Lr = Lg = Lb = fzeros
    Tr = Tg = Tb = fzeros + 1.0
    alive = h["hit"] & in_domain
    wox, woy, woz = dx, dy, dz
    n_live = in_domain.sum()
    seg = in_domain.to(torch.int32)
    n_shadow = 0
    prev_pdf = fzeros
    prev_delta = torch.ones(shape, dtype=torch.bool, device=dev)

    for bounce in range(max_bounces + 1):
        base = 2 + bounce * nb
        u1, u2, u3 = draw(base), draw(base + 1), draw(base + 2)
        nx, ny, nz = h["nx"], h["ny"], h["nz"]
        hx, hy, hz = h["hx"], h["hy"], h["hz"]
        ar, ag, ab = h["ar"], h["ag"], h["ab"]
        is_s, is_t = h["is_s"], h["is_t"]
        is_d = ~(is_s | is_t)

        # ---- emitter hit, MIS-weighted under NEE (:246-274)
        take = (alive & (dot3(nx, ny, nz, -wox, -woy, -woz) > 0.0)).to(
            torch.float32)
        if use_nee:
            is_ps = [h["prim"] == q for q in range(n_prims)]
            ldp = emitter_light_pdf(Ph, Lt, lights_static,
                                    is_ps, pox, poy, poz, fzeros)
            pp2 = prev_pdf * prev_pdf
            take = take * where(prev_delta, 1.0,
                                pp2 / torch.clamp_min(pp2 + ldp * ldp,
                                                      1e-20))
        Lr = Lr + Tr * h["er"] * take
        Lg = Lg + Tg * h["eg"] * take
        Lb = Lb + Tb * h["eb"] * take

        # ---- NEE over the lights, the full quadratic shadow sweep
        # (:276-381)
        if use_nee:
            ul1, ul2, usel = draw(base + 3), draw(base + 4), draw(base + 5)
            for li, (ltype, lprim) in enumerate(lights_static):
                lo, sel = Lt[li][6], Lt[li][7]
                if li == len(lights_static) - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < lo + sel)
                wlx, wly, wlz, dist, pdf_l, rad, valid, area = \
                    _light_sample_div(Ph, Lt, li, ltype, lprim, hx, hy, hz,
                                      ul1, ul2)
                occ = shadow_sweep(P, hx, hy, hz, wlx, wly, wlz,
                                   fma(dist, 1.0 - 1e-3, -EPSILON))
                cos_l = dot3(wlx, wly, wlz, nx, ny, nz)
                support = ((cos_l > 0.0)
                           & (dot3(wox, woy, woz, wlx, wly, wlz) < 0.0)
                           & is_d)
                if area:
                    pdf_b = where(support, cos_l * INV_PI, 0.0)
                    w_mis = (pdf_l * pdf_l) / torch.clamp_min(
                        pdf_l * pdf_l + pdf_b * pdf_b, 1e-20)
                else:
                    w_mis = 1.0
                swept = alive & m_l & valid & support
                n_shadow += int(swept.sum())
                gate = (swept & ~occ).to(torch.float32)
                scale = gate * cos_l * w_mis / torch.clamp_min(pdf_l, 1e-20)
                Lr = Lr + Tr * (ar * INV_PI) * rad[0] * scale
                Lg = Lg + Tg * (ag * INV_PI) * rad[1] * scale
                Lb = Lb + Tb * (ab * INV_PI) * rad[2] * scale

        # ---- BSDF: the concentric diffuse lobe, the mirror and the
        # dielectric (:383-492)
        wix, wiy, wiz, fr, fg, fb, pdf, _ = sample_lobe(
            nx, ny, nz, wox, woy, woz, ar, ag, ab, h["coef"], is_s, is_t,
            is_d, u1, u2, *any_delta)
        wdx, wdy, wdz, pdf_d = concentric_lobe(nx, ny, nz, wox, woy, woz,
                                               u1, u2)
        wix, wiy, wiz = (where(is_d, wdx, wix), where(is_d, wdy, wiy),
                         where(is_d, wdz, wiz))
        pdf = where(is_d, pdf_d, pdf)
        wgt = torch.abs(dot3(wix, wiy, wiz, nx, ny, nz)) / torch.clamp_min(
            pdf, 1e-20)
        f_black = (fr <= 0.0) & (fg <= 0.0) & (fb <= 0.0)
        step_ok = alive & ~f_black & (pdf > 0.0)
        Tr = where(step_ok, Tr * fr * wgt, Tr)
        Tg = where(step_ok, Tg * fg * wgt, Tg)
        Tb = where(step_ok, Tb * fb * wgt, Tb)

        # ---- Russian roulette (:494-507)
        if bounce > rr_start:
            p_cont = torch.clamp_max(torch.maximum(Tr, torch.maximum(Tg, Tb)),
                                     0.5)
            survive = u3 <= p_cont
            boost = step_ok & survive & (p_cont > 0.0)
            inv_p = 1.0 / torch.clamp_min(p_cont, 1e-20)
            Tr = where(boost, Tr * inv_p, Tr)
            Tg = where(boost, Tg * inv_p, Tg)
            Tb = where(boost, Tb * inv_p, Tb)
            alive = step_ok & survive
        else:
            alive = step_ok
        if bounce == max_bounces:
            break
        n_live = n_live + alive.sum()
        seg = seg + alive.to(torch.int32)

        # ---- next segment
        pox, poy, poz = hx, hy, hz
        prev_pdf = pdf
        prev_delta = is_s | is_t
        h = sphere_hits(P, mtypes, emissive, hx, hy, hz, wix, wiy, wiz,
                        reciprocal=False)
        alive = alive & h["hit"]
        wox, woy, woz = wix, wiy, wiz

    if counts is not None:
        counts["shadow"] = n_shadow
        counts["lane_segments"] = seg
        counts["vertices"] = int(seg.sum())
        counts["warp_longest"] = 32 * int(seg.reshape(-1, 32).amax(-1).sum())
    return torch.stack([Lr, Lg, Lb], dim=-1), n_live


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    """The bound C entry point of csrc/trace.cu (built on first use)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    fn = lib.tpt_trace
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        p, ip, i,  # prims (device), prim flags (host), n_prims
        p, ip, i,  # lights (device), light structure (host), n_lights
        p, p,  # camera, uniforms (device or NULL)
        p, p, p, p,  # lr lg lb, counters (device)
        i, i, i, i, i, i,  # rows_total tile_rows spp strat_k width n_lanes
        i, i, i,  # max_bounces rr_start use_nee
        u, u, u,  # seed salt iteration
        i,  # blocks
        p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return fn, lib.tpt_error_string


@functools.cache
def _trace_grid(device_index: int) -> int:
    """Kernel 8's blocks on one card: as many as are resident at once, the
    SMs times the blocks per SM (the card's occupancy calculator, asked
    once per card)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    occupancy = _build.load_library().tpt_trace_occupancy
    occupancy.argtypes = []
    occupancy.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        per_sm = occupancy()
    if per_sm <= 0:
        raise RuntimeError("kernel 8's occupancy query failed")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def scene_arguments(scene: Scene, dev, max_lights: int = MAX_LIGHTS):
    """(prims, flags, n_prims, lights, light structure, n_lights) of a
    sphere scene for the per-sample kernels: the device tables and the host
    arrays of per-prim flags (bit 0 emissive, bits 1-2 the BSDF type) and of
    the light structure (LS = 5 ints per light)."""
    from tpu_pathtracer_torch.ops.kernels.persistent import (
        _check, light_structure,
    )

    n_prims = int(scene.num_prims)
    n_lights = len(scene.light_structure)
    if n_prims > MAX_PRIMS or n_lights > max_lights:
        raise ValueError(f"the kernel takes at most {MAX_PRIMS} prims and "
                         f"{max_lights} lights, got {n_prims} and "
                         f"{n_lights}")
    prims = pack_prims(scene).contiguous()
    lights = pack_lights(scene).contiguous()
    _check(prims, "prims", torch.float32, (n_prims, 12), dev)
    _check(lights, "lights", torch.float32, (max(n_lights, 1), 8), dev)
    em = set(scene.emissive_prims)
    pflags = (ctypes.c_int * max(n_prims, 1))(*[
        (1 if q in em else 0) | (int(t) << 1)
        for q, t in enumerate(scene.prim_mtypes)])
    ls = light_structure(scene, ())
    lstruct = (ctypes.c_int * max(len(ls), 1))(*ls)
    return prims, pflags, n_prims, lights, lstruct, n_lights


def check_lane_ids(rows_total: int) -> None:
    """Refuse, before any launch, a layout whose lane ids (int32 in the
    kernel, as in the TPU kernel) would wrap."""
    if rows_total * LANES >= 2 ** 31:
        raise ValueError(f"{rows_total} rows of lanes exceed int32 lane ids")


def _trace_cuda(scene, cam_packed, seed3, *, spp, width, height, max_bounces,
                rr_start, tile_rows, use_nee, uniforms):
    global launches
    from tpu_pathtracer_torch.ops.kernels.persistent import _MASK, _check

    dev = cam_packed.device
    rows_total, n_lanes = lanes_layout(width, height, spp, tile_rows)
    check_lane_ids(rows_total)
    _check(cam_packed, "cam_packed", torch.float32, (24,), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32,
               (rows_total * sample_n_draws(max_bounces, use_nee), LANES),
               dev)
    prims, pflags, n_prims, lights, lstruct, n_lights = scene_arguments(
        scene, dev)
    seed, iteration, salt = _seed3(seed3)
    shape = (rows_total, LANES)
    lr, lg, lb = (torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(3))
    # the item fetch's next item and the ray count (64-bit), zeroed by a
    # device op of the call
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    blocks = max(1, min(_trace_grid(dev.index), -(-n_lanes // LANES)))
    fn, error_string = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(prims.data_ptr(), pflags, n_prims, lights.data_ptr(),
                 lstruct, n_lights, cam_packed.data_ptr(),
                 uniforms.data_ptr() if uniforms is not None else None,
                 lr.data_ptr(), lg.data_ptr(), lb.data_ptr(),
                 counters.data_ptr(), rows_total, tile_rows, spp,
                 sample_strat_k(spp), width, n_lanes, max_bounces, rr_start,
                 int(use_nee), seed & _MASK, salt & _MASK, iteration & _MASK,
                 blocks, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"trace kernel launch failed: {msg} ({err})")
    launches += 1
    return torch.stack([lr, lg, lb], dim=-1), counters[1]


def trace_lanes(
    scene: Scene,
    cam_packed: Tensor,
    seed3: Sequence[int],
    *,
    spp: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    uniforms: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """One per-sample render's lanes: (L_lanes (rows_total, 128, 3), rays
    traced as a 0-d int64 tensor), lane = pixel * spp + s. ``seed3`` is [seed,
    iteration, salt] as host integers (or a 3-element tensor);
    ``uniforms`` is a test-mode block (module docstring). A packed camera on
    a CUDA device launches the CUDA kernel on the current stream; one on
    the CPU runs ``trace_lanes_ref``; any other device raises. A lens camera
    or a mesh scene raises ValueError (one device read of the lens slot)."""
    _check_layout(spp, width, height, tile_rows, max_bounces)
    kw = dict(spp=spp, width=width, height=height, max_bounces=max_bounces,
              rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
              uniforms=uniforms)
    dev = cam_packed.device
    if dev.type == "cuda":
        refuse_unsupported(scene, float(cam_packed[12]), "pallas_render")
        return _trace_cuda(scene, cam_packed, seed3, **kw)
    if dev.type == "cpu":
        return trace_lanes_ref(scene, cam_packed, seed3, **kw)
    raise ValueError(f"pallas_render: unsupported device {dev}")


def pallas_render(
    scene: Scene,
    cam_packed: Tensor,
    seed3: Sequence[int],
    *,
    spp: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 16,
    use_nee: bool = False,
    uniforms: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Render through the per-sample kernel: ((H, W, 3) image, rays traced),
    the mean of each pixel's spp lanes (JAX ``trace_kernel.py:533-622``).
    Arguments as ``trace_lanes``."""
    L, nrays = trace_lanes(scene, cam_packed, seed3, spp=spp, width=width,
                           height=height, max_bounces=max_bounces,
                           rr_start=rr_start, tile_rows=tile_rows,
                           use_nee=use_nee, uniforms=uniforms)
    n_lanes = width * height * spp
    img = L.reshape(-1, 3)[:n_lanes].reshape(height, width, spp, 3)
    return img.mean(dim=2), nrays
