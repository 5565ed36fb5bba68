"""Camera/IOR tangent walk: CUDA kernel wrapper, plain version and the
gradients built on it.

Counterpart of ``tpu_pathtracer/ops/pallas/camera_jvp.py``. One walk of the
persistent regeneration schedule (lane == pixel; a dead lane starts its
pixel's next stratified sample while it has completed fewer than ``spp``)
carries T tangent directions beside the primal and returns, per pixel, the
radiance sum L and its directional derivatives dL_j:

* a camera tangent is a row of d pack_camera / d theta (24 floats); it moves
  the primary ray's origin and direction;
* an IOR tangent (``coef_mats``) is d/d mat_coef[m] of a transmissive
  material m. Its camera row is zero; instead the refraction JVP gains the
  d(eta)/d(ior) source at m's vertices (Snell bending), and the Fresnel coin
  u < R(ior) contributes through a streaming score accumulator flushed at
  path completion as C_tot * sS - cS.

The estimator is interior-only, as in the JAX kernel: sampling is attached
(the cosine-hemisphere draw rotates with the shading frame, light samples
move with the shading point), discrete decisions (prim selection, occlusion,
light selection, support, Russian roulette and its boost, the Fresnel coin)
are detached, and geometry tangents follow the implicit function theorem on
the hit surface, dt = -(n.do + t n.dd) / (n.d). It is not ``torch.func.jvp``
of the primal: that would differentiate the detached decisions' factors too.

``camera_jvp_call`` launches the CUDA kernel (``csrc/camera_jvp.cu``) for
tensors on a CUDA device, in chunks of at most ``MAX_TAN`` tangents, and runs
``camera_jvp_ref``, the plain PyTorch version, for tensors on the CPU. There
is no fallback between the two.

Randomness, as in ``persistent.py``: test mode takes the JAX kernel's
external uniform block ``(n_tiles, budget, n_draw, tile_rows, 128)``
flattened (the JAX side draws it under ``jax.random.key(3)``); production
mode draws Philox4x32-10 keyed on (seed, salt), countered on (global lane,
iteration, wavefront step, ``STREAM | draw group``).

A textured scene raises ValueError, as in the JAX package
(``camera_jvp.py:1095-1098``): its interior estimator would need the
texture's uv-motion term, so textured scenes take the attached-autodiff
route: autograd of ``models/integrator.py::render`` with ``attached_geom``
(for the IOR, ``diff/score.py::ior_value_and_grad``). A lens camera
(``lens_radius > 0``) raises ValueError too, a recorded departure from the
JAX package: its kernel reads only the pinhole slots of the packed camera,
so on a lens camera it returns a pinhole camera's gradients.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.camera import refuse_lens
from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, EPSILON, SPECULAR, TRANSMISSIVE, TRI_LIGHT, Scene,
    refuse_textures,
)
from tpu_pathtracer_torch.ops.kernels._walk import mesh_walk_ref
from tpu_pathtracer_torch.ops.kernels.persistent import (
    _MASK, MAX_LIGHTS, MAX_PRIMS, _check, _f32_add, _f32_div, dot3_fma,
    emitter_light_pdf, fma, mesh_arguments, mesh_occluded, n_draws,
    pack_materials, pack_tri_lights, packed_mesh, philox_uniforms,
    sample_light, tri_emitter_pdf,
)
from tpu_pathtracer_torch.ops.kernels.replay_persistent import (
    SMEM_PER_BLOCK, _count_occupancy, default_budget, pixel_lanes_layout,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (
    BIG, INV_PI, LANES, pack_camera, pack_lights, pack_prims,
)
from tpu_pathtracer_torch.ops.vecmath import dot3

STREAM = 0x20000  # Philox stream tag of this kernel's draws
MAX_TAN = 4  # tangents per kernel launch; more are split into launches

# Kernel launches by camera_jvp_call (plain-version calls are not counted),
# and those of them on a mesh scene.
launches = 0
mesh_launches = 0


def _refuse_textures(scene: Scene, who: str) -> None:
    refuse_textures(
        scene, who, "the tangent walk's interior estimator would need the "
        "texture's uv-motion term, so textured scenes take the "
        "attached-autodiff route (JAX camera_jvp.py:1095-1098): autograd of "
        "models.integrator.render, or diff.score.ior_value_and_grad for the "
        "IOR", ValueError)


def tangent_rows(dcam: Tensor, coef_mats: Sequence[int]) -> Tensor:
    """(T, 24) tangent rows: the packed-camera rows, then one zero row per
    IOR tangent of ``coef_mats``."""
    if dcam.ndim == 1:
        dcam = dcam[None, :]
    dcam = dcam.to(torch.float32)
    if coef_mats:
        dcam = torch.cat([dcam, dcam.new_zeros((len(coef_mats), 24))])
    return dcam.contiguous()


def tangent_materials(n_tan: int, coef_mats: Sequence[int]) -> tuple:
    """Per tangent: the material of an IOR tangent, -1 for a camera one."""
    return (-1,) * (n_tan - len(coef_mats)) + tuple(int(m) for m in coef_mats)


def transmissive_mats(scene: Scene) -> tuple[int, ...]:
    """Material ids with transmissive geometry (spheres or mesh triangles):
    the materials whose mat_coef (index of refraction) has a gradient."""
    mids = scene.prim_material_ids
    tmats = {int(mids[p]) for p, t in enumerate(scene.prim_mtypes)
             if t == TRANSMISSIVE}
    if scene.mesh is not None:
        tmats |= {int(m) for m in scene.mesh_mats_static
                  if scene.mat_types[m] == TRANSMISSIVE}
    return tuple(sorted(tmats))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _cone_pdf_tangent(LP, sel, ox, oy, oz, tox, toy, toz):
    """Tangent of the cone pdf of sphere light LP (times its selection pdf
    ``sel``) seen from the moving previous vertex o (``camera_jvp.py:
    423-455``); ``to*`` are (T, ...) origin tangents."""
    elx, ely, elz = LP[0] - ox, LP[1] - oy, LP[2] - oz
    e2l = dot3(elx, ely, elz, elx, ely, elz)
    rl = LP[3]
    sin2 = torch.clamp_max(rl * rl / torch.clamp_min(e2l, 1e-12), 1.0)
    ctm = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    omc = torch.clamp_min(1.0 - ctm, 1e-12)
    pc = 1.0 / (2.0 * math.pi * omc)
    de2l = -2.0 * dot3(elx, ely, elz, tox, toy, toz)
    dsin2 = torch.where(sin2 < 1.0,
                        -(rl * rl) / torch.clamp_min(e2l * e2l, 1e-12) * de2l,
                        0.0)
    dctm = torch.where(ctm > 1e-6,
                       -0.5 * dsin2 / torch.clamp_min(ctm, 1e-6), 0.0)
    return torch.where(e2l > rl * rl, pc / omc * dctm, 0.0) * sel


def _light_tangent(P, Lt, TL, li, ltype, lprim, tri, hx, hy, hz, ul1, ul2,
                   dpx, dpy, dpz):
    """Tangents of the NEE sample of light ``li`` from the moving shading
    point (``camera_jvp.py:512-705``); the sample itself is
    ``persistent.sample_light``. Returns (fac, dwl (3 of (T, ...)), dpdf,
    dfac): ``fac`` scales the light's intensity (1/d^2 for a point light,
    else 1)."""
    where = torch.where
    zero = torch.zeros_like(dpx)
    if ltype == AREA_LIGHT and lprim >= 0:
        # attached cone sampling: the frame rotates with wc = normalize(c - h)
        wrx, wry, wrz = P[lprim][0] - hx, P[lprim][1] - hy, P[lprim][2] - hz
        rl = P[lprim][3]
        d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz)
        inv_dc = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
        wcx, wcy, wcz = wrx * inv_dc, wry * inv_dc, wrz * inv_dc
        sin2 = torch.clamp_max(rl * rl / torch.clamp_min(d2l, 1e-12), 1.0)
        ctm = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        omc = torch.clamp_min(1.0 - ctm, 1e-12)
        cth = 1.0 - ul1 * (1.0 - ctm)
        sth = torch.sqrt(torch.clamp_min(1.0 - cth * cth, 0.0))
        phi = (2.0 * math.pi) * ul2
        usex = torch.abs(wcx) > torch.abs(wcz)
        gax, gay, gaz = (where(usex, -wcy, 0.0), where(usex, wcx, -wcz),
                         where(usex, 0.0, wcy))
        inv_a = torch.rsqrt(torch.clamp_min(gax * gax + gay * gay + gaz * gaz,
                                            1e-20))
        ax, ay, az = gax * inv_a, gay * inv_a, gaz * inv_a
        bx = wcy * az - wcz * ay
        by = wcz * ax - wcx * az
        bz = wcx * ay - wcy * ax
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cp, sp = cphi * sth, sphi * sth
        pdf_l = Lt[li][7] / (2.0 * math.pi * omc)
        # d(wr) = -dp: the light's centre is fixed
        dd2l = -2.0 * dot3(wrx, wry, wrz, dpx, dpy, dpz)
        dinv_dc = -0.5 * inv_dc * inv_dc * inv_dc * dd2l
        dwcx = -dpx * inv_dc + wrx * dinv_dc
        dwcy = -dpy * inv_dc + wry * dinv_dc
        dwcz = -dpz * inv_dc + wrz * dinv_dc
        dsin2 = where(sin2 < 1.0,
                      -(rl * rl) / torch.clamp_min(d2l * d2l, 1e-12) * dd2l,
                      0.0)
        dctm = where(ctm > 1e-6, -0.5 * dsin2 / torch.clamp_min(ctm, 1e-6),
                     0.0)
        dcth = ul1 * dctm
        dsth = where(sth > 1e-6, -cth * dcth / torch.clamp_min(sth, 1e-6), 0.0)
        dgax, dgay, dgaz = (where(usex, -dwcy, zero), where(usex, dwcx, -dwcz),
                            where(usex, zero, dwcy))
        a_dg = ax * dgax + ay * dgay + az * dgaz
        dax = (dgax - ax * a_dg) * inv_a
        day = (dgay - ay * a_dg) * inv_a
        daz = (dgaz - az * a_dg) * inv_a
        dbx = dwcy * az + wcy * daz - dwcz * ay - wcz * day
        dby = dwcz * ax + wcz * dax - dwcx * az - wcx * daz
        dbz = dwcx * ay + wcx * day - dwcy * ax - wcy * dax
        dcp, dsp = cphi * dsth, sphi * dsth
        dwl = (dax * cp + ax * dcp + dbx * sp + bx * dsp + dwcx * cth
               + wcx * dcth,
               day * cp + ay * dcp + dby * sp + by * dsp + dwcy * cth
               + wcy * dcth,
               daz * cp + az * dcp + dbz * sp + bz * dsp + dwcz * cth
               + wcz * dcth)
        return 1.0, dwl, pdf_l / omc * dctm, zero
    if ltype == TRI_LIGHT:
        # the sampled point is fixed: tangents flow through the shading
        # point only (distance, direction, pdf)
        TLr, off, K = tri
        fz = torch.zeros_like(hx)
        attrs = [fz + TLr[off][k] for k in range(12)]
        c_lo, c_hi = fz, fz + TLr[off][12]
        for k in range(1, K):
            m_k = ul1 > TLr[off + k - 1][12]
            attrs = [where(m_k, TLr[off + k][c], a) for c, a in enumerate(attrs)]
            c_lo = where(m_k, TLr[off + k - 1][12], c_lo)
            c_hi = where(m_k, TLr[off + k][12], c_hi)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nlx, nly, nlz = attrs
        u0r = torch.clamp((ul1 - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-12),
                          0.0, 1.0)
        su = torch.sqrt(u0r)
        b1s, b2s = 1.0 - su, ul2 * su
        wrx = v0x + b1s * e1x + b2s * e2x - hx
        wry = v0y + b1s * e1y + b2s * e2y - hy
        wrz = v0z + b1s * e1z + b2s * e2z - hz
        d2l = dot3(wrx, wry, wrz, wrx, wry, wrz)
        inv_dl = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
        wlx, wly, wlz = wrx * inv_dl, wry * inv_dl, wrz * inv_dl
        cos_at = -dot3(nlx, nly, nlz, wlx, wly, wlz)
        abs_ca = torch.clamp_min(torch.abs(cos_at), 1e-9)
        pdf_l = Lt[li][7] * d2l / torch.clamp_min(
            torch.abs(cos_at) * max(TLr[off][13], 1e-20), 1e-12)
        dd2l = -2.0 * dot3(wrx, wry, wrz, dpx, dpy, dpz)
        dinv_dl = -0.5 * inv_dl * inv_dl * inv_dl * dd2l
        dwl = (-dpx * inv_dl + wrx * dinv_dl, -dpy * inv_dl + wry * dinv_dl,
               -dpz * inv_dl + wrz * dinv_dl)
        dcos_at = -dot3(nlx, nly, nlz, *dwl)
        dpdf = pdf_l * (dd2l / torch.clamp_min(d2l, 1e-12)
                        - torch.sign(cos_at) * dcos_at / abs_ca)
        return 1.0, dwl, dpdf, zero
    # point light: delta, 1/d^2 falloff
    wrx, wry, wrz = Lt[li][0] - hx, Lt[li][1] - hy, Lt[li][2] - hz
    d2l = dot3(wrx, wry, wrz, wrx, wry, wrz)
    inv_dl = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
    wlx, wly, wlz = wrx * inv_dl, wry * inv_dl, wrz * inv_dl
    fac = inv_dl * inv_dl
    dd2l = -2.0 * dot3(wrx, wry, wrz, dpx, dpy, dpz)
    wl_dwr = -dot3(wlx, wly, wlz, dpx, dpy, dpz)
    dwl = ((-dpx - wlx * wl_dwr) * inv_dl, (-dpy - wly * wl_dwr) * inv_dl,
           (-dpz - wlz * wl_dwr) * inv_dl)
    return fac, dwl, zero, -fac * fac * dd2l


def camera_jvp_ref(
    scene: Scene,
    cam_packed: Tensor,
    dcam: Tensor,
    seed: Sequence[int],
    iteration: int,
    *,
    spp: int,
    budget: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    tile_offset: int = 0,
    coef_mats: Sequence[int] = (),
    uniforms: Tensor | None = None,
    counts: dict | None = None,
    walks=None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of ``camera_jvp_call``: the JAX kernel's lane
    math (``camera_jvp.py:64-1058``), vectorized over all lanes with masked
    selects and over the tangents as a leading dimension, with the explicit
    FMA quadratics of ``persistent_step_ref``. Same arguments and returns;
    if ``counts`` is a dict it also receives the work done (for the kernel's
    bound): ``"paths"`` started, path ``"segments"``, NEE ``"shadow"``
    segments needed, of them ``"lit"`` (unoccluded), ``"score"``
    vertices (IOR-tangent vertices, summed over the tangents), and the
    schedule's warp occupancy as ``persistent_replay_ref`` counts it:
    ``"warp_iters"``, the 32-lane warps of the layout times the budget,
    ``"warp_live"``, those with a lane alive after regeneration (the others
    have drained: the kernel's warps stop there), and ``"warp_packed"``;
    ``"lane_segments"`` is the (rows, 128) int32 plane of each lane's
    segments (a lane acts in iterations 0 to its segment count - 1, as it
    regenerates at once while its pixel has samples left). ``walks``,
    if given, is called as ``mesh_walk_ref``'s ``record`` on every mesh
    walk (to sample the segments for the bound's walk tests)."""
    _refuse_textures(scene, "camera_jvp_ref")
    dev = cam_packed.device
    D = tangent_rows(dcam, coef_mats).to(dev)
    n_tan = D.shape[0]
    tan_mats = tangent_materials(n_tan, coef_mats)
    rows_total, n_lanes = pixel_lanes_layout(width, height, tile_rows)
    n_tiles = rows_total // tile_rows
    shape = (rows_total, LANES)
    n_prims = int(scene.num_prims)
    tmin = EPSILON
    n_draw = n_draws(use_nee)
    seed_i, salt = int(seed[0]), int(seed[1])

    P = pack_prims(scene).cpu().tolist()
    Lt = pack_lights(scene).cpu().tolist()
    cam = cam_packed.cpu().tolist()
    emissive = tuple(scene.emissive_prims)
    spec_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                       if t == SPECULAR)
    trans_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                        if t == TRANSMISSIVE)
    lights_static = tuple(scene.light_structure)
    pm = packed_mesh(scene)
    mesh = pm is not None
    any_spec = bool(spec_prims) or (mesh and SPECULAR in scene.mat_types)
    any_trans = bool(trans_prims) or (mesh and TRANSMISSIVE in scene.mat_types)
    MT = pack_materials(scene).cpu().tolist()
    TL, tris = pack_tri_lights(scene)
    TL = TL.cpu().tolist()
    tri_of = {li: (off, K) for li, _, off, K in tris}
    mids = scene.prim_material_ids
    mesh_trans = {m for m in scene.mesh_mats_static
                  if mesh and scene.mat_types[m] == TRANSMISSIVE}
    ior_js = [j for j, m in enumerate(tan_mats) if m >= 0]
    is_ior = torch.tensor([m >= 0 for m in tan_mats],
                          device=dev).reshape(n_tan, 1, 1, 1)

    lane = (torch.arange(rows_total * LANES, device=dev, dtype=torch.int64)
            .reshape(shape) + tile_offset * tile_rows * LANES)
    in_domain = lane < n_lanes
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    if uniforms is not None:
        ublk = uniforms.reshape(n_tiles, budget, n_draw, tile_rows, LANES)
    fz = torch.zeros(shape, dtype=torch.float32, device=dev)
    bz = torch.zeros(shape, dtype=torch.bool, device=dev)
    tz = torch.zeros((n_tan,) + shape, dtype=torch.float32, device=dev)
    tz3 = torch.zeros((n_tan, 3) + shape, dtype=torch.float32, device=dev)
    where = torch.where

    def dc(k):  # tangent k of the packed camera, broadcast over lanes
        return D[:, k].reshape(n_tan, 1, 1)

    # primal per-pixel sums and path state; RGB stacked on a leading axis
    Lp = torch.zeros((3,) + shape, dtype=torch.float32, device=dev)
    n_samp = torch.zeros(shape, dtype=torch.int32, device=dev)
    ox = oy = oz = dx = dy = fz
    dz = fz + 1.0
    Tp = Cp = Lp
    bounce = torch.zeros_like(n_samp)
    alive = prev_delta = bz
    prev_pdf = fz
    # tangents, (T, ...) and (T, 3, ...); IOR score state per tangent
    tox = toy = toz = tdx = tdy = tdz = tz
    tT = tC = dL = cS = tz3
    sS = tz
    n_live = torch.zeros((), dtype=torch.int64, device=dev)
    work = dict.fromkeys(("paths", "segments", "shadow", "lit", "score"), 0)
    lane_segments = torch.zeros_like(n_samp)

    for it in range(budget):
        if uniforms is not None:
            u = [ublk[:, it, j].reshape(shape) for j in range(n_draw)]
        else:
            u = philox_uniforms(lane, seed_i, salt, int(iteration), it, n_draw,
                                stream=STREAM)
        u_cam, v_cam, u1, u2, u3 = u[:5]
        if use_nee:
            ul1, ul2, usel = u[5:8]

        # ---- regenerate while the pixel has samples left, with the primary
        # ray's tangents: d normalize(g) = (dg - n (n.dg)) / |g|
        regen = (~alive) & in_domain & (n_samp < spp)
        if strat_k > 1:
            cell = n_samp % (strat_k * strat_k)
            jx = ((cell % strat_k).to(torch.float32) + u_cam) * (1.0 / strat_k) \
                - 0.5
            jy = ((cell // strat_k).to(torch.float32) + v_cam) \
                * (1.0 / strat_k) - 0.5
        else:
            jx, jy = u_cam - 0.5, v_cam - 0.5
        sx, sy = px + jx, py + jy
        gdx = cam[0] - cam[6] * sy + cam[3] * sx
        gdy = cam[1] - cam[7] * sy + cam[4] * sx
        gdz = cam[2] - cam[8] * sy + cam[5] * sx
        inv_g = torch.rsqrt(torch.clamp_min(gdx * gdx + gdy * gdy + gdz * gdz,
                                            1e-20))
        ndx, ndy, ndz = gdx * inv_g, gdy * inv_g, gdz * inv_g
        ox, oy, oz = (where(regen, cam[9], ox), where(regen, cam[10], oy),
                      where(regen, cam[11], oz))
        dx, dy, dz = where(regen, ndx, dx), where(regen, ndy, dy), \
            where(regen, ndz, dz)
        tgx = dc(0) - dc(6) * sy + dc(3) * sx
        tgy = dc(1) - dc(7) * sy + dc(4) * sx
        tgz = dc(2) - dc(8) * sy + dc(5) * sx
        gdot = ndx * tgx + ndy * tgy + ndz * tgz
        tox = where(regen, dc(9) + tz, tox)
        toy = where(regen, dc(10) + tz, toy)
        toz = where(regen, dc(11) + tz, toz)
        tdx = where(regen, (tgx - ndx * gdot) * inv_g, tdx)
        tdy = where(regen, (tgy - ndy * gdot) * inv_g, tdy)
        tdz = where(regen, (tgz - ndz * gdot) * inv_g, tdz)
        tT, tC, cS = (where(regen, 0.0, x) for x in (tT, tC, cS))
        sS = where(regen, 0.0, sS)
        Tp = where(regen, 1.0, Tp)
        Cp = where(regen, 0.0, Cp)
        bounce = where(regen, 0, bounce)
        prev_pdf = where(regen, 0.0, prev_pdf)
        prev_delta = prev_delta | regen
        alive = alive | regen
        n_live = n_live + alive.sum()
        if counts is not None:
            _count_occupancy(work, alive)
            lane_segments = lane_segments + alive.to(torch.int32)
        work["paths"] += regen.sum()
        work["segments"] += alive.sum()

        # ---- closest hit (min over per-prim roots), then the mesh walk
        # pruned from the sphere t; the LAST prim wins an exact tie
        best_t = fz + BIG
        ts = []
        for p in range(n_prims):
            opx, opy, opz = P[p][0] - ox, P[p][1] - oy, P[p][2] - oz
            r = P[p][3]
            b = dot3_fma(opx, opy, opz, dx, dy, dz)
            det = fma(r, r, fma(b, b, -dot3_fma(opx, opy, opz, opx, opy, opz)))
            sq = torch.sqrt(torch.clamp_min(det, 0.0))
            t0 = b - sq
            t = where(t0 > tmin, t0, b + sq)
            tv = where((det >= 0.0) & (t > tmin), t, BIG)
            ts.append(tv)
            best_t = torch.minimum(best_t, tv)
        mc = bz
        if mesh:
            tm, mnx, mny, mnz, mmat = mesh_walk_ref(
                pm, ox, oy, oz, dx, dy, dz, where(alive, best_t, 0.0),
                tile_rows=tile_rows, record=walks)
            mc = alive & (tm < best_t) & (tm < 0.5 * BIG)
            best_t = where(mc, tm, best_t)
        hit = best_t < (0.5 * BIG)
        act = alive & hit
        actf = act.to(torch.float32)
        t_hit = where(act, best_t, 0.0)  # lanes that do not act sit on o
        hx, hy, hz = fma(dx, t_hit, ox), fma(dy, t_hit, oy), fma(dz, t_hit, oz)
        cx = cy = cz = inv_r = ar = ag = ab = fz
        is_ps = []
        for p in range(n_prims):
            is_p = ts[p] == best_t
            is_ps.append(is_p)
            cx, cy, cz = (where(is_p, P[p][0], cx), where(is_p, P[p][1], cy),
                          where(is_p, P[p][2], cz))
            inv_r = where(is_p, _f32_div(1.0, P[p][3]), inv_r)
            ar, ag, ab = (where(is_p, P[p][4], ar), where(is_p, P[p][5], ag),
                          where(is_p, P[p][6], ab))
        nx, ny, nz = (hx - cx) * inv_r, (hy - cy) * inv_r, (hz - cz) * inv_r
        coef = fz
        for p in (*spec_prims, *trans_prims):
            coef = where(is_ps[p], P[p][7], coef)
        er = eg = eb = fz
        for p in emissive:
            er, eg, eb = (where(is_ps[p], P[p][9], er),
                          where(is_ps[p], P[p][10], eg),
                          where(is_ps[p], P[p][11], eb))
        is_s = is_t = bz
        for p in spec_prims:
            is_s = is_s | is_ps[p]
        for p in trans_prims:
            is_t = is_t | is_ps[p]
        if mesh:
            # the unit geometric normal wins on mesh lanes; inv_r stays 0
            # there, so dn = dp * inv_r = 0 (flat triangle)
            inv_len = torch.rsqrt(torch.clamp_min(
                mnx * mnx + mny * mny + mnz * mnz, 1e-20))
            nx, ny, nz = (where(mc, mnx * inv_len, nx),
                          where(mc, mny * inv_len, ny),
                          where(mc, mnz * inv_len, nz))
            ms = mt = bz
            for mi, mtype in enumerate(scene.mat_types):
                m_mask = mc & (mmat == mi)
                ar, ag, ab = (where(m_mask, MT[mi][0], ar),
                              where(m_mask, MT[mi][1], ag),
                              where(m_mask, MT[mi][2], ab))
                if mtype in (SPECULAR, TRANSMISSIVE):
                    coef = where(m_mask, MT[mi][3], coef)
                if mtype == SPECULAR:
                    ms = ms | (mmat == mi)
                elif mtype == TRANSMISSIVE:
                    mt = mt | (mmat == mi)
            is_s = (is_s & ~mc) | (mc & ms)
            is_t = (is_t & ~mc) | (mc & mt)
            er, eg, eb = where(mc, 0.0, er), where(mc, 0.0, eg), \
                where(mc, 0.0, eb)
            for li, lmat, _, _ in tris:
                m_mask = mc & (mmat == lmat)
                er, eg, eb = (where(m_mask, Lt[li][3], er),
                              where(m_mask, Lt[li][4], eg),
                              where(m_mask, Lt[li][5], eb))
        e = torch.stack([er, eg, eb])
        alb = torch.stack([ar, ag, ab])

        # per IOR tangent: this material's transmissive vertices on acting
        # lanes; ior = max(coef, 1) has no derivative at coef <= 1
        tmask = tz
        if ior_js:
            masks = []
            for m in tan_mats:
                mm = bz
                if m >= 0:
                    for p in trans_prims:
                        if mids[p] == m:
                            mm = mm | is_ps[p]
                    if m in mesh_trans:
                        mm = mm | (mc & (mmat == m))
                masks.append(mm & act & (coef > 1.0))
            tmask = torch.stack(masks).to(torch.float32)
            work["score"] += tmask.sum()

        # ---- geometry tangents, IFT on the hit surface
        nd = dot3(nx, ny, nz, dx, dy, dz)
        nd_safe = where(torch.abs(nd) > 1e-6, nd,
                        where(nd >= 0, 1e-6, -1e-6))
        n_do = dot3(nx, ny, nz, tox, toy, toz)
        n_dd = dot3(nx, ny, nz, tdx, tdy, tdz)
        dt = -(n_do + t_hit * n_dd) / nd_safe * actf
        dpx = (tox + dx * dt + tdx * t_hit) * actf
        dpy = (toy + dy * dt + tdy * t_hit) * actf
        dpz = (toz + dz * dt + tdz * t_hit) * actf
        dnx, dny, dnz = dpx * inv_r, dpy * inv_r, dpz * inv_r
        wox, woy, woz = dx, dy, dz
        twx, twy, twz = tdx, tdy, tdz

        # ---- emitter hit, MIS-weighted under NEE: the sphere light's cone
        # pdf moves with the previous vertex; the carried BSDF pdf and a
        # triangle emitter's pdf are detached
        one_sided = dot3(nx, ny, nz, -wox, -woy, -woz) > 0.0
        take = (act & one_sided).to(torch.float32)
        w_emit, dw_emit = 1.0, tz
        if use_nee:
            ldp = emitter_light_pdf(P, Lt, lights_static, is_ps, ox, oy, oz, fz)
            dldp = tz
            for li, (ltype, lprim) in enumerate(lights_static):
                if ltype == AREA_LIGHT and lprim >= 0:
                    dldp = where(is_ps[lprim], _cone_pdf_tangent(
                        P[lprim], Lt[li][7], ox, oy, oz, tox, toy, toz), dldp)
            if mesh:
                ldp = tri_emitter_pdf(ldp, mc, tm, mmat, nx, ny, nz, wox, woy,
                                      woz, Lt, TL, tris)
                for li, lmat, _, _ in tris:
                    dldp = where(mc & (mmat == lmat), 0.0, dldp)
            pp2 = prev_pdf * prev_pdf
            denom = torch.clamp_min(pp2 + ldp * ldp, 1e-20)
            w_emit = where(prev_delta, 1.0, pp2 / denom)
            # d[a/(a+b)] = -w db/(a+b): a squared denominator overflows f32
            dw_emit = where(prev_delta, 0.0,
                            -w_emit * (2.0 * ldp * dldp) / denom)
        Cp = Cp + Tp * e * take * w_emit
        tC = tC + e * take * (tT * w_emit + Tp * dw_emit[:, None])

        # ---- next-event estimation, with interior tangents: the light
        # sample moves with the shading point; occlusion, selection and
        # support are detached
        is_d = ~(is_s | is_t)
        if use_nee:
            n_l = len(lights_static)
            for li, (ltype, lprim) in enumerate(lights_static):
                if ltype == TRI_LIGHT and not mesh:
                    continue
                lo, sel = Lt[li][6], Lt[li][7]
                if li == n_l - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < _f32_add(lo, sel))
                (wlx, wly, wlz, dist_l, pdf_l, _, valid,
                 is_delta) = sample_light(P, Lt, li, ltype, lprim, hx, hy, hz,
                                          ul1, ul2, fz,
                                          tri=(TL, *tri_of.get(li, (0, 0))))
                fac, dwl, dpdf_l, dfac = _light_tangent(
                    P, Lt, TL, li, ltype, lprim,
                    (TL, *tri_of.get(li, (0, 0))), hx, hy, hz, ul1, ul2,
                    dpx, dpy, dpz)
                # shadow any-hit: segment-ball distance form over every prim
                # but the sampled light sphere, then the mesh
                smax = fma(dist_l, 1.0 - 1e-3, -tmin)
                occ = bz
                skip = lprim if (ltype == AREA_LIGHT and lprim >= 0) else -1
                for pp in range(n_prims):
                    if pp == skip:
                        continue
                    sx2, sy2, sz2 = P[pp][0] - hx, P[pp][1] - hy, P[pp][2] - hz
                    rb = dot3_fma(sx2, sy2, sz2, wlx, wly, wlz)
                    ts_ = torch.minimum(torch.clamp_min(rb, tmin), smax)
                    d2s = fma(-ts_, 2.0 * rb - ts_,
                              dot3_fma(sx2, sy2, sz2, sx2, sy2, sz2))
                    occ = occ | (d2s < P[pp][3] * P[pp][3])
                if mesh:
                    occ = occ | mesh_occluded(
                        scene, tile_rows, act & m_l & valid & ~occ
                        & (smax > 0.0), smax, hx, hy, hz, wlx, wly, wlz,
                        walks)
                cos_l = dot3(wlx, wly, wlz, nx, ny, nz)
                support = ((cos_l > 0.0)
                           & (dot3(wox, woy, woz, wlx, wly, wlz) < 0.0)
                           & is_d)
                gate_b = act & m_l & valid & support
                n_live = n_live + gate_b.sum()  # every needed shadow ray
                work["shadow"] += gate_b.sum()
                gate_b = gate_b & ~occ
                work["lit"] += gate_b.sum()
                gate = gate_b.to(torch.float32)
                ipl = 1.0 / torch.clamp_min(pdf_l, 1e-20)
                dcos_l = (dot3(*dwl, nx, ny, nz)
                          + dot3(wlx, wly, wlz, dnx, dny, dnz))
                if is_delta:
                    w_mis, dw_mis = 1.0, 0.0
                else:
                    pdf_b = where(support, cos_l * INV_PI, 0.0)
                    mden = torch.clamp_min(pdf_l * pdf_l + pdf_b * pdf_b,
                                           1e-20)
                    w_mis = (pdf_l * pdf_l) / mden
                    # w = a/(a+b): dw = ((1-w) da - w db)/(a+b)
                    dpdf_b = where(support, dcos_l * INV_PI, 0.0)
                    dw_mis = ((1.0 - w_mis) * 2.0 * pdf_l * dpdf_l
                              - w_mis * 2.0 * pdf_b * dpdf_b) / mden
                scale = gate * cos_l * w_mis * ipl
                dscale = gate * (dcos_l * w_mis * ipl + cos_l * dw_mis * ipl
                                 - cos_l * w_mis * dpdf_l * ipl * ipl)
                fd = alb * INV_PI
                rad = torch.tensor(Lt[li][3:6], device=dev).reshape(3, 1, 1)
                Cp = Cp + Tp * fd * rad * fac * scale
                contrib = fd * rad * (tT * fac * scale
                                      + Tp * dfac[:, None] * scale
                                      + Tp * fac * dscale[:, None])
                tC = where(gate_b, tC + contrib, tC)

        # ---- attached diffuse bounce: wi = ONB(n) @ l, l detached
        r_d = torch.sqrt(u1)
        th = (2.0 * math.pi) * u2
        ldx, ldy = r_d * torch.cos(th), r_d * torch.sin(th)
        ldz = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
        use_x = torch.abs(nx) > torch.abs(nz)
        gux, guy, guz = (where(use_x, -ny, 0.0), where(use_x, nx, -nz),
                         where(use_x, 0.0, ny))
        inv_u = torch.rsqrt(torch.clamp_min(gux * gux + guy * guy + guz * guz,
                                            1e-20))
        ux, uy, uz = gux * inv_u, guy * inv_u, guz * inv_u
        vx, vy, vz = ny * uz - nz * uy, nz * ux - nx * uz, nx * uy - ny * ux
        wdx = ux * ldx + vx * ldy + nx * ldz
        wdy = uy * ldx + vy * ldy + ny * ldz
        wdz = uz * ldx + vz * ldy + nz * ldz
        pdf_d = where(dot3(wox, woy, woz, wdx, wdy, wdz) < 0.0, ldz * INV_PI,
                      0.0)
        dgux, dguy, dguz = (where(use_x, -dny, tz), where(use_x, dnx, -dnz),
                            where(use_x, tz, dny))
        u_dg = ux * dgux + uy * dguy + uz * dguz
        dux, duy, duz = ((dgux - ux * u_dg) * inv_u, (dguy - uy * u_dg) * inv_u,
                         (dguz - uz * u_dg) * inv_u)
        dvx = dny * uz + ny * duz - dnz * uy - nz * duy
        dvy = dnz * ux + nz * dux - dnx * uz - nx * duz
        dvz = dnx * uy + nx * duy - dny * ux - ny * dux
        twix = dux * ldx + dvx * ldy + dnx * ldz
        twiy = duy * ldx + dvy * ldy + dny * ldz
        twiz = duz * ldx + dvz * ldy + dnz * ldz
        wix, wiy, wiz = wdx, wdy, wdz
        f = alb * INV_PI
        pdf = pdf_d

        won = dot3(wox, woy, woz, nx, ny, nz)
        if any_spec or any_trans:
            wsx, wsy, wsz = (wox - 2.0 * won * nx, woy - 2.0 * won * ny,
                             woz - 2.0 * won * nz)
            dwon = dot3(twx, twy, twz, nx, ny, nz) \
                + dot3(wox, woy, woz, dnx, dny, dnz)
            twsx = twx - 2.0 * (dwon * nx + won * dnx)
            twsy = twy - 2.0 * (dwon * ny + won * dny)
            twsz = twz - 2.0 * (dwon * nz + won * dnz)
        if any_trans:
            entering = won < 0.0
            ior = torch.clamp_min(coef, 1.0)
            n1, n2 = where(entering, 1.0, ior), where(entering, ior, 1.0)
            sgn = where(entering, 1.0, -1.0)
            nnx, nny, nnz = nx * sgn, ny * sgn, nz * sgn
            cos_i = -(wox * nnx + woy * nny + woz * nnz)
            eta = n1 / n2
            sin2t = eta * eta * (1.0 - cos_i * cos_i)
            cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2t, 1e-12))
            r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
            r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
            refl = where(sin2t > 1.0, 1.0,
                         0.5 * (r_orth * r_orth + r_par * r_par))
            do_reflect = u1 < refl  # detached coin
            fac_t = eta * (-cos_i) + cos_t
            wtx = where(do_reflect, wsx, wox * eta - fac_t * nnx)
            wty = where(do_reflect, wsy, woy * eta - fac_t * nny)
            wtz = where(do_reflect, wsz, woz * eta - fac_t * nnz)
            dnnx, dnny, dnnz = dnx * sgn, dny * sgn, dnz * sgn
            dcos_i = -(twx * nnx + wox * dnnx + twy * nny + woy * dnny
                       + twz * nnz + woz * dnnz)
            dsin2t = eta * eta * (-2.0 * cos_i * dcos_i)
            if ior_js:
                # the IOR source: d(ior) = 1 at the tangent's vertices moves
                # eta = n1/n2 and bends the refracted ray (Snell)
                dn1 = where(entering, 0.0, tmask)
                dn2 = where(entering, tmask, 0.0)
                deta = (dn1 * n2 - n1 * dn2) / (n2 * n2)
                dsin2t = dsin2t + 2.0 * eta * deta * (1.0 - cos_i * cos_i)
            dcos_t = -0.5 * dsin2t / cos_t
            dfac_t = eta * (-dcos_i) + dcos_t
            dtxx = twx * eta - dfac_t * nnx - fac_t * dnnx
            dtxy = twy * eta - dfac_t * nny - fac_t * dnny
            dtxz = twz * eta - dfac_t * nnz - fac_t * dnnz
            if ior_js:
                dfac_e = deta * (-cos_i)
                dtxx = dtxx + wox * deta - dfac_e * nnx
                dtxy = dtxy + woy * deta - dfac_e * nny
                dtxz = dtxz + woz * deta - dfac_e * nnz
            twtx = where(do_reflect, twsx, dtxx)
            twty = where(do_reflect, twsy, dtxy)
            twtz = where(do_reflect, twsz, dtxz)
            if ior_js:
                # streaming score of the detached Fresnel coin: dR/d(ior)
                # with the geometry fixed; TIR lanes sit on R == 1 (dR = 0)
                dn1s, dn2s = where(entering, 0.0, 1.0), where(entering, 1.0, 0.0)
                detas = (dn1s * n2 - n1 * dn2s) / (n2 * n2)
                dsin2ts = 2.0 * eta * detas * (1.0 - cos_i * cos_i)
                dcos_ts = -0.5 * dsin2ts / cos_t
                ao = n1 * cos_i - n2 * cos_t
                bo = n1 * cos_i + n2 * cos_t
                dao = dn1s * cos_i - dn2s * cos_t - n2 * dcos_ts
                dbo = dn1s * cos_i + dn2s * cos_t + n2 * dcos_ts
                bsafe = torch.clamp_min(bo, 1e-9)
                dro = (dao * bo - ao * dbo) / (bsafe * bsafe)
                cp_ = n2 * cos_i - n1 * cos_t
                dp_ = n2 * cos_i + n1 * cos_t
                dcp = dn2s * cos_i - dn1s * cos_t - n1 * dcos_ts
                ddp = dn2s * cos_i + dn1s * cos_t + n1 * dcos_ts
                dsafe = torch.clamp_min(dp_, 1e-9)
                drp = (dcp * dp_ - cp_ * ddp) / (dsafe * dsafe)
                dRv = where(sin2t > 1.0, 0.0, r_orth * dro + r_par * drp)
                scf = where(do_reflect, dRv / torch.clamp_min(refl, 1e-6),
                            -dRv / torch.clamp_min(1.0 - refl, 1e-6))
                sc = where(tmask > 0.0, scf * tmask, 0.0)
                # C here holds this vertex's emission and NEE, which do not
                # depend on the coin: the suffix starts after them
                sS = sS + sc
                cS = cS + sc[:, None] * Cp
        if any_spec:
            wix, wiy, wiz = (where(is_s, wsx, wix), where(is_s, wsy, wiy),
                             where(is_s, wsz, wiz))
            twix, twiy, twiz = (where(is_s, twsx, twix),
                                where(is_s, twsy, twiy),
                                where(is_s, twsz, twiz))
            f = where(is_s, coef * alb, f)
        if any_trans:
            wix, wiy, wiz = (where(is_t, wtx, wix), where(is_t, wty, wiy),
                             where(is_t, wtz, wiz))
            twix, twiy, twiz = (where(is_t, twtx, twix),
                                where(is_t, twty, twiy),
                                where(is_t, twtz, twiz))
            f = where(is_t, alb, f)
        if any_spec or any_trans:
            pdf = where(is_d, pdf_d, 1.0)
        f_black = (f[0] <= 0.0) & (f[1] <= 0.0) & (f[2] <= 0.0)
        step_ok = act & ~f_black & (pdf > 0.0)

        # ---- throughput: the diffuse weight pi*f = albedo is tangent-free
        # in the attached frame (cos == l_z); a delta lobe's |cos| moves
        if any_spec or any_trans:
            cos_dot = dot3(wix, wiy, wiz, nx, ny, nz)
            wgt = where(is_d, math.pi, torch.abs(cos_dot))
            dcos_wi = torch.sign(cos_dot) * (
                dot3(twix, twiy, twiz, nx, ny, nz)
                + dot3(wix, wiy, wiz, dnx, dny, dnz))
            dwgt = where(is_d, 0.0, dcos_wi)
            tT = where(step_ok, tT * f * wgt + Tp * f * dwgt[:, None], tT)
        else:
            wgt = math.pi
            tT = where(step_ok, tT * f * wgt, tT)
        Tp = where(step_ok, Tp * f * wgt, Tp)

        # ---- Russian roulette (detached decision and boost)
        do_rr = bounce > rr_start
        p_cont = torch.clamp_max(torch.maximum(Tp[0], torch.maximum(Tp[1],
                                                                    Tp[2])),
                                 0.5)
        survive = u3 <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        inv_p = 1.0 / torch.clamp_min(p_cont, 1e-20)
        Tp = where(boost, Tp * inv_p, Tp)
        tT = where(boost, tT * inv_p, tT)
        alive_next = step_ok & (survive | ~do_rr) & (bounce < max_bounces)

        # ---- path completion: flush radiance, tangents and the score
        # suffix sum_b s_b (C_tot - C_b) = C_tot sS - cS
        died = alive & ~alive_next
        Lp = where(died, Lp + Cp, Lp)
        dL = where(died, dL + tC, dL)
        if ior_js:
            dL = where(died & is_ior, dL + (Cp * sS[:, None] - cS), dL)
        n_samp = n_samp + died.to(torch.int32)

        # ---- pending ray and its tangents for the next iteration
        ox, oy, oz = where(act, hx, ox), where(act, hy, oy), where(act, hz, oz)
        dx, dy, dz = (where(act, wix, dx), where(act, wiy, dy),
                      where(act, wiz, dz))
        tox, toy, toz = (where(act, dpx, tox), where(act, dpy, toy),
                         where(act, dpz, toz))
        tdx, tdy, tdz = (where(act, twix, tdx), where(act, twiy, tdy),
                         where(act, twiz, tdz))
        prev_pdf = where(act, pdf, prev_pdf)
        new_delta = (is_s | is_t) if (any_spec or any_trans) else bz
        prev_delta = (act & new_delta) | (~act & prev_delta)
        bounce = where(act, bounce + 1, bounce)
        alive = alive_next

    if counts is not None:
        counts.update({k: int(v) for k, v in work.items()})
        counts["lane_segments"] = lane_segments
    dom = in_domain.to(torch.float32)
    L = (Lp * dom).permute(1, 2, 0)
    dL = (dL * dom).permute(0, 2, 3, 1)
    return L.contiguous(), dL.contiguous(), n_samp, n_live


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def tangent_smem_bytes(n_tan: int) -> int:
    """Bytes of dynamic shared memory that one 128-lane block of the
    tangent kernel takes for a launch of ``n_tan`` tangents, passed to the
    launch (which refuses any other count): per lane the radiance sums L (3
    words), and per tangent its sums dL (3) and its IOR score state sS, cS
    (4). Raises ValueError for ``n_tan < 1`` or past SMEM_PER_BLOCK."""
    if n_tan < 1:
        raise ValueError(f"a tangent launch needs a tangent, got {n_tan}")
    nbytes = 4 * LANES * (3 + 7 * n_tan)
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"the tangent kernel's block needs {nbytes} B of shared memory "
            f"for {n_tan} tangents; a block may take {SMEM_PER_BLOCK} B")
    return nbytes


def tangent_blocks_per_sm(mesh: bool, n_tan: int) -> tuple[int, int]:
    """(bytes of shared memory per block, blocks per SM) of the (MESH, T)
    build of the kernel, as the card's occupancy calculator gives them
    (needs the card)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    occ = _build.load_library().tpt_camera_jvp_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int
    nbytes = tangent_smem_bytes(n_tan)
    n = occ(int(mesh), n_tan, nbytes)
    if n < 0:
        raise RuntimeError("the tangent kernel's occupancy query failed")
    return nbytes, n


@functools.cache
def _kernel():
    """The bound C entry point of csrc/camera_jvp.cu (built on first use,
    into the same library as the other kernels)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    fn = lib.tpt_camera_jvp
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        p, ip, i,  # prims (device), prim info (host), n_prims
        p, ip, i,  # lights (device), light structure (host), n_lights
        p, p, ip, i,  # camera, tangent rows (device), their materials, n_tan
        p,  # uniforms (device) or NULL
        p, p, p,  # output planes, n_samp, per-row ray counts (device)
        p, p, p, p, i,  # bvh nodes, tris, mats, tri lights; nodes
        i, i, i, i, i, i,  # rows_total tile_rows budget spp width n_lanes
        i, i, i, i, i,  # max_bounces rr_start use_nee strat_k tile_offset
        u, u, u,  # seed salt iteration
        i,  # bytes of dynamic shared memory per block
        p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return fn, lib.tpt_error_string


def _camera_jvp_cuda(scene, cam_packed, dcam, seed, iteration, *, spp, budget,
                     width, height, max_bounces, rr_start, tile_rows, use_nee,
                     strat_k, tile_offset, coef_mats, uniforms):
    global launches, mesh_launches
    dev = cam_packed.device
    D = tangent_rows(dcam, coef_mats)
    n_tan = D.shape[0]
    tan_mats = tangent_materials(n_tan, coef_mats)
    rows_total, n_lanes = pixel_lanes_layout(width, height, tile_rows)
    n_tiles = rows_total // tile_rows
    n_prims = int(scene.num_prims)
    n_lights = len(scene.light_structure)
    if n_prims > MAX_PRIMS or n_lights > MAX_LIGHTS:
        raise ValueError(f"the tangent kernel takes at most {MAX_PRIMS} prims "
                         f"and {MAX_LIGHTS} lights, got {n_prims} and "
                         f"{n_lights}")
    if n_tan == 0 or strat_k < 1 or budget < 0 or spp < 0:
        raise ValueError("need a tangent, strat_k >= 1, budget and spp >= 0")
    prims = pack_prims(scene).contiguous()
    lights = pack_lights(scene).contiguous()
    _check(prims, "prims", torch.float32, (n_prims, 12), dev)
    _check(lights, "lights", torch.float32, (max(n_lights, 1), 8), dev)
    _check(cam_packed, "cam_packed", torch.float32, (24,), dev)
    _check(D, "dcam", torch.float32, (n_tan, 24), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32,
               (n_tiles * budget * n_draws(use_nee) * tile_rows, LANES), dev)

    mesh_ptrs, _keep, ls = mesh_arguments(scene, dev)
    # per prim: bit 0 emissive, bits 1-2 the BSDF type, bits 3+ the material
    emissive = set(scene.emissive_prims)
    pinfo = (ctypes.c_int * max(n_prims, 1))(*[
        (1 if q in emissive else 0) | (int(t) << 1)
        | (int(scene.prim_material_ids[q]) << 3)
        for q, t in enumerate(scene.prim_mtypes)])
    lstruct = (ctypes.c_int * max(len(ls), 1))(*ls)
    shape = (rows_total, LANES)
    fn, error_string = _kernel()
    L = n_samp = nrays = None
    dls = []
    for c in range(0, n_tan, MAX_TAN):
        k = min(MAX_TAN, n_tan - c)
        # the first chunk is the widest: a refusal comes before any launch
        nbytes = tangent_smem_bytes(k)
        out = torch.empty((3 + 3 * k,) + shape, dtype=torch.float32,
                          device=dev)
        ns = torch.empty(shape, dtype=torch.int32, device=dev)
        rays = torch.empty(rows_total, dtype=torch.int32, device=dev)
        tmats = (ctypes.c_int * k)(*tan_mats[c:c + k])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(prims.data_ptr(), pinfo, n_prims, lights.data_ptr(),
                     lstruct, n_lights, cam_packed.data_ptr(),
                     D[c:c + k].data_ptr(), tmats, k,
                     uniforms.data_ptr() if uniforms is not None else None,
                     out.data_ptr(), ns.data_ptr(), rays.data_ptr(),
                     *mesh_ptrs, rows_total, tile_rows, budget, spp, width,
                     n_lanes, max_bounces, rr_start, int(use_nee), strat_k,
                     int(tile_offset), int(seed[0]) & _MASK,
                     int(seed[1]) & _MASK, int(iteration) & _MASK, nbytes,
                     stream)
        if err != 0:
            msg = error_string(err).decode()
            raise RuntimeError(f"tangent kernel launch failed: {msg} ({err})")
        launches += 1
        mesh_launches += scene.mesh is not None
        if L is None:  # every chunk walks the same paths
            L, n_samp, nrays = out[:3].permute(1, 2, 0), ns, rays.sum()
        dls.append(out[3:].reshape(k, 3, *shape).permute(0, 2, 3, 1))
    return L, torch.cat(dls), n_samp, nrays


def camera_jvp_call(
    scene: Scene,
    cam_packed: Tensor,
    dcam: Tensor,
    seed: Sequence[int],
    iteration: int,
    *,
    spp: int,
    budget: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    tile_offset: int = 0,
    coef_mats: Sequence[int] = (),
    uniforms: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One tangent walk, T tangents beside the primal.

    ``dcam`` holds packed-camera tangent rows, (24,) or (T, 24); each id of
    ``coef_mats`` appends an IOR tangent, the full (Snell source plus Fresnel
    score) d L / d mat_coef[m]. ``seed`` is ``(seed, salt)`` and
    ``iteration`` the RNG frame, as host integers. Returns (L_sum (rows, 128,
    3), dL_sum (T, rows, 128, 3), n_samp (rows, 128), live_rays): per-pixel
    sums in the lane == pixel layout. ``live_rays`` counts the lanes alive
    after regeneration per iteration plus the NEE shadow segments needed.
    For tensors on a CUDA device this launches the CUDA kernel on the
    current stream, once per ``MAX_TAN`` tangents (each launch walks the
    same paths; L, n_samp and the ray count are the first one's); on the
    CPU it runs ``camera_jvp_ref``; any other device raises. A mesh must be
    packed (``models.scene.with_packet_mesh``). A lens (slot 12 of
    ``cam_packed`` > 0) raises ValueError; that slot is read from the
    device, one read per call (the gradient entry points below check the
    Camera's host value instead)."""
    if cam_packed.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"camera_jvp_call: unsupported device {cam_packed.device}")
    refuse_lens(float(cam_packed[12]), "camera_jvp_call")
    return _tangent_walk(
        scene, cam_packed, dcam, seed, iteration, spp=spp, budget=budget,
        width=width, height=height, max_bounces=max_bounces,
        rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
        strat_k=strat_k, tile_offset=tile_offset, coef_mats=coef_mats,
        uniforms=uniforms)


def _tangent_walk(scene, cam_packed, dcam, seed, iteration, *, tile_offset=0,
                  coef_mats=(), uniforms=None, **kw):
    """camera_jvp_call once the lens has been refused."""
    _refuse_textures(scene, "camera_jvp_call")
    packed_mesh(scene)  # refuses an unpacked mesh
    dev = cam_packed.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"camera_jvp_call: unsupported device {dev}")
    kw.update(tile_offset=tile_offset, coef_mats=tuple(coef_mats),
              uniforms=uniforms)
    if dev.type == "cuda":
        return _camera_jvp_cuda(scene, cam_packed, dcam, seed, iteration, **kw)
    return camera_jvp_ref(scene, cam_packed, dcam, seed, iteration, **kw)


# ---------------------------------------------------------------------------
# Gradients through the tangent walk
# ---------------------------------------------------------------------------

def _pixel_means(L: Tensor, dL: Tensor, ns: Tensor, width: int, height: int
                 ) -> tuple[Tensor, Tensor]:
    """(H, W, 3) completed-path mean and (T, H, W, 3) its tangents."""
    nsafe = torch.clamp_min(ns, 1).to(torch.float32)[..., None]
    n = width * height
    mean = (L / nsafe).reshape(-1, 3)[:n].reshape(height, width, 3)
    dmean = (dL / nsafe).reshape(dL.shape[0], -1, 3)[:, :n]
    return mean, dmean.reshape(-1, height, width, 3)


def camera_weighted_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    weights: Tensor,  # (H, W, 3) adjoint image (dLoss/dpixel)
    *,
    spp: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    budget: int | None = None,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    iteration: int = 0,
    params: Sequence[str] = ("pos",),
    uniforms: Tensor | None = None,
) -> tuple[Tensor, dict]:
    """sum(weights * image) and its gradient w.r.t. the named camera fields:
    one tangent walk per field, every scalar component of the field a
    tangent of it. d pack_camera / d field is ``torch.func.jacfwd`` of
    ``pack_camera`` over the replaced field. Returns (value, {name: grad})."""
    refuse_lens(camera.lens_radius, "camera_weighted_grad")
    w, h = camera.width, camera.height
    if budget is None:
        budget = default_budget(spp, max_bounces)
    grads, value = {}, None
    cp = pack_camera(camera)
    for name in params:
        base = getattr(camera, name)
        flat = base.reshape(-1).to(torch.float32)

        def packed_of(v, name=name, base=base):
            return pack_camera(dataclasses.replace(
                camera, **{name: v.reshape(base.shape)}))

        jac = torch.func.jacfwd(packed_of)(flat)  # (24, n)
        L, dL, ns, _ = _tangent_walk(
            scene, cp, jac.T.contiguous(), seed, iteration, spp=spp,
            budget=budget, width=w, height=h, max_bounces=max_bounces,
            rr_start=rr_start, tile_rows=tile_rows, use_nee=use_nee,
            strat_k=strat_k, uniforms=uniforms)
        mean, dmean = _pixel_means(L, dL, ns, w, h)
        if value is None:
            value = torch.sum(weights * mean)
        grads[name] = torch.sum(weights * dmean, dim=(1, 2, 3)).reshape(
            base.shape)
    return value, grads


def _ior_walk(scene, camera, seed, *, spp, max_bounces, rr_start, budget,
              tile_rows, use_nee, strat_k, iteration, uniforms, who):
    """One tangent walk with an IOR tangent per transmissive material.
    Returns (pixel mean, its tangents, the materials)."""
    refuse_lens(camera.lens_radius, who)
    tmats = transmissive_mats(scene)
    if not tmats:
        raise ValueError(f"{who}: scene has no transmissive material — "
                         "mat_coef has no ior gradient")
    w, h = camera.width, camera.height
    cp = pack_camera(camera)
    L, dL, ns, _ = _tangent_walk(
        scene, cp, cp.new_zeros((0, 24)), seed, iteration, spp=spp,
        budget=default_budget(spp, max_bounces) if budget is None else budget,
        width=w, height=h, max_bounces=max_bounces, rr_start=rr_start,
        tile_rows=tile_rows, use_nee=use_nee, strat_k=strat_k,
        coef_mats=tmats, uniforms=uniforms)
    mean, dmean = _pixel_means(L, dL, ns, w, h)
    return mean, dmean, tmats


def _scatter_mats(scene: Scene, weights: Tensor, dmean: Tensor,
                  tmats: Sequence[int]) -> Tensor:
    g = torch.zeros(scene.mat_coef.shape[0], dtype=torch.float32,
                    device=weights.device)
    g[list(tmats)] = torch.sum(weights * dmean, dim=(1, 2, 3))
    return g


def ior_weighted_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    weights: Tensor,  # (H, W, 3) adjoint image (dLoss/dpixel)
    *,
    spp: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    budget: int | None = None,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    iteration: int = 0,
    uniforms: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """sum(weights * image) and its full gradient w.r.t. scene.mat_coef
    (M,): Snell bending and the Fresnel score in one tangent walk. A
    material without transmissive geometry gets 0; a scene with none
    raises ValueError."""
    mean, dmean, tmats = _ior_walk(
        scene, camera, seed, spp=spp, max_bounces=max_bounces,
        rr_start=rr_start, budget=budget, tile_rows=tile_rows,
        use_nee=use_nee, strat_k=strat_k, iteration=iteration,
        uniforms=uniforms, who="ior_weighted_grad")
    return torch.sum(weights * mean), _scatter_mats(scene, weights, dmean,
                                                    tmats)


def ior_mse_grad(
    scene: Scene,
    camera,
    seed: Sequence[int],
    target: Tensor,  # (H, W, 3)
    *,
    spp: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    budget: int | None = None,
    tile_rows: int = 32,
    use_nee: bool = False,
    strat_k: int = 2,
    iteration: int = 0,
    uniforms: Tensor | None = None,
) -> Tensor:
    """d/d(mat_coef) of mean((image - target)^2) from one tangent walk, (M,).
    The cotangent 2 (mean - target) / (H W 3) comes from the walk's own
    primal mean, the plain stochastic-MSE convention of the JAX package;
    ``diff.inverse.kernel_loss_and_grads`` uses it for ``mat_coef``."""
    w, h = camera.width, camera.height
    mean, dmean, tmats = _ior_walk(
        scene, camera, seed, spp=spp, max_bounces=max_bounces,
        rr_start=rr_start, budget=budget, tile_rows=tile_rows,
        use_nee=use_nee, strat_k=strat_k, iteration=iteration,
        uniforms=uniforms, who="ior_mse_grad")
    weights = 2.0 * (mean - target.reshape(h, w, 3)) / (h * w * 3)
    return _scatter_mats(scene, weights, dmean, tmats)
