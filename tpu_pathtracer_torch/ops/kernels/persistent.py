"""Persistent path-regeneration step: CUDA kernel wrapper and plain version.

Counterpart of ``tpu_pathtracer/ops/pallas/persistent.py`` for sphere
scenes. One lane per pixel runs ``budget`` wavefront iterations; a lane whose
path dies starts its pixel's next stratified sample at once. Per-lane path
state is carried across calls in 20 ``(rows_total, 128)`` planes, with
``lane = tile*tile_rows*128 + row*128 + col = pixel``. Radiance collects per
path and is flushed into the per-pixel sums when the path completes.

``persistent_step`` launches the CUDA kernel (``csrc/persistent.cu``) for
state on a CUDA device and runs ``persistent_step_ref``, the plain PyTorch
version, for state on the CPU. There is no fallback between the two.

Randomness comes in two modes, both in the JAX kernel's draw order
``u_cam, v_cam[, u_lens, v_lens], u1, u2, u3[, ul1, ul2, usel]``
(``n_draws``: 5 to 10 per iteration, the lens pair with ``use_dof``, the
last three with NEE):

* test mode (``uniforms`` given): the JAX kernel's external uniform block,
  ``(n_tiles, budget, n_draw, tile_rows, 128)`` flattened to
  ``(n_tiles*budget*n_draw*tile_rows, 128)``;
* production mode: counter-based Philox4x32-10 with key (seed, salt) and
  counter (global lane, frame, iteration, draw group); draw group g gives
  the draws 4g to 4g+3 of that order. The plain version computes the same
  Philox in int64 tensor arithmetic, so kernel and plain version see
  identical uniforms in both modes.

``use_dof`` (a host bool, the JAX kernel's static argument) regenerates
paths through the packed camera's thin lens: a point of the lens disk by
the polar map, aimed at the pinhole ray's point on the plane of focus.

Scenes may hold a triangle mesh, packed by ``models/scene.py::
with_packet_mesh``: the closest hit merges the in-kernel BVH walk into the
sphere pass, triangles of a TRI_LIGHT's material emit, NEE samples triangle
lights by area, and shadow rays walk the mesh in occlusion mode. On a
textured scene the walk also returns the hit's uv, and a textured
material's colour is multiplied by the bilinear texel of the atlas there.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, EPSILON, SPECULAR, TRANSMISSIVE, TRI_LIGHT, Scene,
)
from tpu_pathtracer_torch.ops.kernels._walk import mesh_walk_ref
from tpu_pathtracer_torch.ops.kernels.mesh_kernel import MAX_NODES
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (
    BIG, INV_PI, LANES, pack_lights, pack_prims,
)
from tpu_pathtracer_torch.ops.vecmath import dot3, normalize3

F32_FIELDS = ("lr", "lg", "lb", "ox", "oy", "oz", "dx", "dy", "dz",
              "tr", "tg", "tb", "cr", "cg", "cb", "prev_pdf")
I32_FIELDS = ("n_samp", "bounce", "alive", "prev_delta")
# Plane order of the JAX kernel (and of the CUDA kernel's State struct).
STATE_FIELDS = (
    "lr", "lg", "lb", "n_samp",
    "ox", "oy", "oz", "dx", "dy", "dz",
    "tr", "tg", "tb", "cr", "cg", "cb",
    "bounce", "alive", "prev_pdf", "prev_delta",
)
MAX_PRIMS = 256  # sizes of the kernel's __constant__ tables
MAX_LIGHTS = 64

# Kernel launches by persistent_step (plain-version calls are not counted),
# and those of them on a mesh scene (each walks the mesh in-kernel).
launches = 0
mesh_launches = 0


@dataclasses.dataclass
class PathState:
    """Per-lane persistent state; every plane is (rows_total, 128).

    Lanes >= width*height are padding and never activate. ``frame`` counts
    the steps taken so far on the host (it keys the randomness), so the loop
    never waits on the device for it.
    """

    lr: Tensor  # per-pixel radiance sums
    lg: Tensor
    lb: Tensor
    n_samp: Tensor  # int32: completed paths per pixel
    ox: Tensor  # pending-ray origin (also the MIS previous vertex)
    oy: Tensor
    oz: Tensor
    dx: Tensor  # pending-ray direction
    dy: Tensor
    dz: Tensor
    tr: Tensor  # throughput
    tg: Tensor
    tb: Tensor
    cr: Tensor  # current-path radiance
    cg: Tensor
    cb: Tensor
    bounce: Tensor  # int32 bounce depth of the pending ray
    alive: Tensor  # int32 0/1: pending ray valid
    prev_pdf: Tensor  # BSDF pdf that produced the pending ray (MIS)
    prev_delta: Tensor  # int32 0/1: pending ray came from a delta lobe
    frame: int = 0

    def clone(self) -> "PathState":
        return dataclasses.replace(
            self, **{f: getattr(self, f).clone() for f in STATE_FIELDS})


def init_state(width: int, height: int, tile_rows: int = 32, *,
               device="cuda") -> PathState:
    """Fresh all-dead state: whole tiles of tile_rows x 128 lanes."""
    n_tiles = -(-(width * height) // (tile_rows * LANES))
    shape = (n_tiles * tile_rows, LANES)
    planes = {f: torch.zeros(shape, dtype=torch.float32, device=device)
              for f in F32_FIELDS}
    planes.update({f: torch.zeros(shape, dtype=torch.int32, device=device)
                   for f in I32_FIELDS})
    return PathState(**planes, frame=0)


def state_image(state: PathState, width: int, height: int) -> Tensor:
    """Progressive estimate: per-pixel completed-path mean, (H, W, 3)."""
    n = torch.clamp_min(state.n_samp, 1).to(torch.float32)
    img = torch.stack([state.lr / n, state.lg / n, state.lb / n], dim=-1)
    return img.reshape(-1, 3)[: width * height].reshape(height, width, 3)


def state_min_samples(state: PathState, width: int, height: int) -> Tensor:
    """Minimum completed sample count over real (non-padding) pixels."""
    return torch.min(state.n_samp.reshape(-1)[: width * height])


def n_draws(use_nee: bool, use_dof: bool = False) -> int:
    """Uniforms per lane per iteration (JAX ``persistent.py:525``)."""
    return (4 if use_dof else 2) + 3 + (3 if use_nee else 0)


def split_draws(u: list, use_nee: bool, use_dof: bool):
    """One iteration's draws in kernel order -> ((u_cam, v_cam), (u_lens,
    v_lens) or None, (u1, u2, u3), (ul1, ul2, usel) or None)."""
    k = 4 if use_dof else 2
    return (tuple(u[:2]), tuple(u[2:4]) if use_dof else None,
            tuple(u[k:k + 3]), tuple(u[k + 3:k + 6]) if use_nee else None)


# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., SC'11), in int64 tensor arithmetic
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: Tensor) -> tuple[Tensor, Tensor]:
    """(hi, lo) 32-bit words of m*x for 32-bit x. m is split into 16-bit
    halves so that no partial product leaves int64."""
    a = x * (m >> 16)
    b = x * (m & 0xFFFF)
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & _MASK
    return hi, lo


def philox4x32(c0: Tensor, c1: int, c2: int, c3: int, k0: int, k1: int
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1). c0 is an
    int64 tensor of 32-bit values; the rest are Python ints."""
    x0 = c0
    x1 = torch.full_like(c0, c1 & _MASK)
    x2 = torch.full_like(c0, c2 & _MASK)
    x3 = torch.full_like(c0, c3 & _MASK)
    k0 &= _MASK
    k1 &= _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK
            k1 = (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], x0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return x0, x1, x2, x3


def bits_to_uniform(x: Tensor) -> Tensor:
    """Top 24 bits of a 32-bit word -> float32 in [0, 1), exactly."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniforms(lane: Tensor, seed: int, salt: int, frame: int,
                    iteration: int, n_draw: int, stream: int = 0
                    ) -> list[Tensor]:
    """The production draws of one iteration, in the kernel's order. The
    counter's last word is ``stream | draw group``; each kernel draws under
    its own stream tag."""
    out = []
    for group in range(-(-n_draw // 4)):
        out += [bits_to_uniform(w) for w in
                philox4x32(lane, frame, iteration, stream | group, seed,
                           salt)]
    return out[:n_draw]


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

# The 1e5-radius wall spheres make the sphere quadratic b^2 - |op|^2 + r^2
# cancel badly in f32, so a one-ulp difference there changes which surface a
# lane hits. XLA on the CPU contracts multiply-adds into FMAs, and nvcc does
# by default, while PyTorch's elementwise ops round every step. The
# quadratics (closest hit, light-sphere hit, shadow test) and the hit point
# are therefore written with explicit FMAs in XLA's pattern, here and in
# csrc/persistent.cu: dot3 = fma(az, bz, fma(ax, bx, ay*by)) and
# det = fma(r, r, fma(b, b, -|op|^2)).

def fma(a, b, c) -> Tensor:
    """a*b + c rounded once to float32: the product of two float32 values
    is exact in float64, so only the final rounding is visible."""
    a, b, c = (x.double() if isinstance(x, Tensor) else x for x in (a, b, c))
    return (a * b + c).float()


def dot3_fma(ax, ay, az, bx, by, bz) -> Tensor:
    return fma(az, bz, fma(ax, bx, ay * by))


# The plain versions of the math that the two persistent kernels share
# (csrc/pt_common.cuh): the camera ray of a regenerated path, the cone pdf
# of an emitter hit for MIS, the NEE light sample and the BSDF lobes. ``P``
# and ``Lt`` are host lists of the pack_prims / pack_lights rows.

def camera_rays(cam, px, py, n_samp, strat_k, u_cam, v_cam, lens=None):
    """Primary rays of regenerated paths, (ox, oy, oz, dx, dy, dz): from the
    eye through the jittered pixel (``camera_dirs``), or with ``lens`` =
    (u_lens, v_lens) through the thin lens (JAX ``persistent.py:569-587``):
    the origin moves to a point of the lens disk by the polar map (sqrt(u)
    r, 2 pi v; the wavefront's camera uses the concentric map), and the ray
    aims at the pinhole ray's point on the plane of focus, ``focal / cos``
    along it against the view's w row. Origins are host floats when there
    is no lens."""
    dx, dy, dz = camera_dirs(cam, px, py, n_samp, strat_k, u_cam, v_cam)
    if lens is None:
        return cam[9], cam[10], cam[11], dx, dy, dz
    return thin_lens(cam, *lens, dx, dy, dz)


def thin_lens(cam, u_lens, v_lens, dx, dy, dz):
    """The thin lens of the TPU kernels (``pt_common.cuh::thin_lens``): the
    pinhole direction d from the eye becomes a ray (ox, oy, oz, dx, dy, dz)
    from a point of the lens disk by the polar map, aimed at the pinhole
    ray's point on the plane of focus."""
    lens_r = cam[12] * torch.sqrt(u_lens)
    phi = (2.0 * math.pi) * v_lens
    ldu = lens_r * torch.cos(phi)
    ldv = lens_r * torch.sin(phi)
    cos_w = dx * cam[20] + dy * cam[21] + dz * cam[22]
    ft = cam[13] / torch.clamp_min(cos_w, 1e-6)
    fpx, fpy, fpz = cam[9] + dx * ft, cam[10] + dy * ft, cam[11] + dz * ft
    ox = cam[9] + cam[14] * ldu + cam[17] * ldv
    oy = cam[10] + cam[15] * ldu + cam[18] * ldv
    oz = cam[11] + cam[16] * ldu + cam[19] * ldv
    return (ox, oy, oz) + normalize3(fpx - ox, fpy - oy, fpz - oz)


def camera_dirs(cam, px, py, n_samp, strat_k, u_cam, v_cam):
    """Primary ray directions of regenerated paths: stratified jitter over
    strat_k^2 cells picked by n_samp % strat_k^2 (persistent.py:551)."""
    if strat_k > 1:
        cell = n_samp % (strat_k * strat_k)
        ccx = (cell % strat_k).to(torch.float32)
        ccy = (cell // strat_k).to(torch.float32)
        jx = (ccx + u_cam) * (1.0 / strat_k) - 0.5
        jy = (ccy + v_cam) * (1.0 / strat_k) - 0.5
    else:
        jx = u_cam - 0.5
        jy = v_cam - 0.5
    sx = px + jx
    sy = py + jy
    return normalize3(cam[0] - cam[6] * sy + cam[3] * sx,
                      cam[1] - cam[7] * sy + cam[4] * sx,
                      cam[2] - cam[8] * sy + cam[5] * sx)


def emitter_light_pdf(P, Lt, lights_static, is_ps, ox, oy, oz, fzeros):
    """Light-sampling pdf of the sphere light a lane hit, seen from the
    previous vertex o (cone pdf times selection pdf), 0 elsewhere."""
    ldp = fzeros
    for li, (ltype, lprim) in enumerate(lights_static):
        if ltype != AREA_LIGHT or lprim < 0:
            continue
        dlx = P[lprim][0] - ox
        dly = P[lprim][1] - oy
        dlz = P[lprim][2] - oz
        d2l = dot3(dlx, dly, dlz, dlx, dly, dlz)
        rl = P[lprim][3]
        sin2 = torch.clamp_max(rl * rl / torch.clamp_min(d2l, 1e-12), 1.0)
        ctm = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        pc = 1.0 / (2.0 * math.pi * torch.clamp_min(1.0 - ctm, 1e-12))
        pc = torch.where(d2l > rl * rl, pc, 0.0)
        ldp = torch.where(is_ps[lprim], pc * Lt[li][7], ldp)
    return ldp


def sample_light(P, Lt, li, ltype, lprim, hx, hy, hz, ul1, ul2, fzeros,
                 tri=None):
    """NEE sample of light ``li`` from the hit points: cone sampling around
    a sphere light's centre (one-sided: only its outer face lights), a
    triangle light by area (``tri`` = (pack_tri_lights rows, first row,
    K)), or a point light, a delta light with 1/d^2 falloff. Returns (wlx,
    wly, wlz, dist, pdf, (rad_r, rad_g, rad_b), valid, is_delta)."""
    tmin = EPSILON
    where = torch.where
    sel = Lt[li][7]
    if ltype == TRI_LIGHT:
        wlx, wly, wlz, dist, pdf, valid = sample_tri_light(
            *tri, sel, hx, hy, hz, ul1, ul2)
        return wlx, wly, wlz, dist, pdf, tuple(Lt[li][3:6]), valid, False
    if ltype == AREA_LIGHT and lprim >= 0:
        wrx = P[lprim][0] - hx
        wry = P[lprim][1] - hy
        wrz = P[lprim][2] - hz
        rl = P[lprim][3]
        d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz)
        inv_dc = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
        wcx, wcy, wcz = wrx * inv_dc, wry * inv_dc, wrz * inv_dc
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
        valid = (detq >= 0.0) & (thit > tmin) & (d2l > rl * rl)
        inv_rl = _f32_div(1.0, rl)
        nsx = (hx + wlx * thit - P[lprim][0]) * inv_rl
        nsy = (hy + wly * thit - P[lprim][1]) * inv_rl
        nsz = (hz + wlz * thit - P[lprim][2]) * inv_rl
        valid = valid & (dot3(nsx, nsy, nsz, -wlx, -wly, -wlz) > 0.0)
        pdf_l = sel / (2.0 * math.pi * torch.clamp_min(1.0 - ctm, 1e-12))
        return (wlx, wly, wlz, thit, pdf_l, tuple(Lt[li][3:6]), valid,
                False)
    wrx = Lt[li][0] - hx
    wry = Lt[li][1] - hy
    wrz = Lt[li][2] - hz
    d2l = dot3(wrx, wry, wrz, wrx, wry, wrz)
    inv_dl = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
    dist_l = d2l * inv_dl
    inv_d2 = inv_dl * inv_dl
    rad = tuple(Lt[li][3 + c] * inv_d2 for c in range(3))
    return (wrx * inv_dl, wry * inv_dl, wrz * inv_dl, dist_l, sel + fzeros,
            rad, dist_l > tmin, True)


def sample_lobe(nx, ny, nz, wox, woy, woz, ar, ag, ab, coef, is_s, is_t,
                is_d, u1, u2, any_spec, any_trans):
    """One BSDF lobe per lane under masks: cosine hemisphere through the
    polar disk map, mirror reflection, or the Fresnel dielectric (whose
    reflection choice reuses u1). Returns (wix, wiy, wiz, fr, fg, fb, pdf,
    wgt), wgt = |cos| / pdf without the vector divide."""
    where = torch.where
    r_d = torch.sqrt(u1)
    th = (2.0 * math.pi) * u2
    ldx = r_d * torch.cos(th)
    ldy = r_d * torch.sin(th)
    ldz = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    use_x = torch.abs(nx) > torch.abs(nz)
    ux, uy, uz = normalize3(where(use_x, -ny, 0.0), where(use_x, nx, -nz),
                            where(use_x, 0.0, ny))
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    wdx = ux * ldx + vx * ldy + nx * ldz
    wdy = uy * ldx + vy * ldy + ny * ldz
    wdz = uz * ldx + vz * ldy + nz * ldz
    pdf_d = where(dot3(wox, woy, woz, wdx, wdy, wdz) < 0.0, ldz * INV_PI,
                  0.0)
    won = dot3(wox, woy, woz, nx, ny, nz)
    if any_spec or any_trans:
        wsx = wox - 2.0 * won * nx
        wsy = woy - 2.0 * won * ny
        wsz = woz - 2.0 * won * nz
    if any_trans:
        entering = won < 0.0
        ior = torch.clamp_min(coef, 1.0)
        n1 = where(entering, 1.0, ior)
        n2 = where(entering, ior, 1.0)
        sgn = where(entering, 1.0, -1.0)
        nnx, nny, nnz = nx * sgn, ny * sgn, nz * sgn
        cos_i = -(wox * nnx + woy * nny + woz * nnz)
        eta = n1 / n2
        sin2t = eta * eta * (1.0 - cos_i * cos_i)
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2t, 0.0))
        r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
        r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
        refl = where(sin2t > 1.0, 1.0,
                     0.5 * (r_orth * r_orth + r_par * r_par))
        do_reflect = u1 < refl
        txx = wox * eta - (eta * (-cos_i) + cos_t) * nnx
        txy = woy * eta - (eta * (-cos_i) + cos_t) * nny
        txz = woz * eta - (eta * (-cos_i) + cos_t) * nnz
        wtx = where(do_reflect, wsx, txx)
        wty = where(do_reflect, wsy, txy)
        wtz = where(do_reflect, wsz, txz)
    wix, wiy, wiz = wdx, wdy, wdz
    fr, fg, fb = ar * INV_PI, ag * INV_PI, ab * INV_PI
    pdf = pdf_d
    if any_spec:
        wix, wiy, wiz = (where(is_s, wsx, wix), where(is_s, wsy, wiy),
                         where(is_s, wsz, wiz))
        fr, fg, fb = (where(is_s, coef * ar, fr), where(is_s, coef * ag, fg),
                      where(is_s, coef * ab, fb))
    if any_trans:
        wix, wiy, wiz = (where(is_t, wtx, wix), where(is_t, wty, wiy),
                         where(is_t, wtz, wiz))
        fr, fg, fb = (where(is_t, ar, fr), where(is_t, ag, fg),
                      where(is_t, ab, fb))
    if any_spec or any_trans:
        pdf = where(is_d, pdf_d, 1.0)
        # cos/pdf is exactly pi on diffuse lanes, |cos| on delta lanes
        wgt = where(is_d, math.pi,
                    torch.abs(dot3(wix, wiy, wiz, nx, ny, nz)))
    else:
        wgt = math.pi
    return wix, wiy, wiz, fr, fg, fb, pdf, wgt


# ---------------------------------------------------------------------------
# Mesh tables and the mesh half of the plain versions
# ---------------------------------------------------------------------------

def packed_mesh(scene: Scene):
    """The scene's packed mesh, None for a sphere-only scene; an unpacked
    mesh is refused (the kernels walk the packed layout only)."""
    if scene.mesh is None:
        return None
    if scene.mesh_packed is None:
        raise ValueError(
            "the persistent kernels walk the packed mesh in-kernel: pack it "
            "first with models.scene.with_packet_mesh(scene)")
    return scene.mesh_packed


def pack_materials(scene: Scene) -> Tensor:
    """(M, 6) material table for mesh hits: r g b coef type texture (f32;
    texture -1: untextured), built on the scene's device from its material
    tables."""
    return torch.cat([scene.mat_color, scene.mat_coef[:, None],
                      scene.mat_type[:, None].to(torch.float32),
                      scene.mat_texture[:, None].to(torch.float32)],
                     dim=1).contiguous()


def texel(textures: Tensor, mat_tex: Sequence[int], mc: Tensor,
          mmat: Tensor, u: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
    """The bilinear texel at each lane's mesh hit (JAX ``persistent.py:
    413-438``), as four per-lane gathers with the TPU kernel's own index
    arithmetic: uv wrapped by ``u - floor(u)``, the taps' rows and columns
    wrapped into the texture, the row offset by ``texk * TH`` for the
    material's texture ``texk``; then y interpolated before x, as the
    kernel's two-hot contraction does. A texture id past the atlas gives a
    zero texel, as in the TPU kernel, whose rows then match no row of the
    atlas (``ops/texture.py`` reads the last texture instead). Returns
    (has_tex, (r, g, b)): has_tex marks mesh-closer lanes of textured
    materials."""
    K, TH, TW, _ = textures.shape
    texk, (r0, r1, c0, c1), (fx, fy) = texel_taps(
        textures.shape, mat_tex, mc, mmat, u, v)
    has_tex = texk >= 0.0
    flat = textures.reshape(-1, 3)

    def tap(r, c):
        return flat[(r * TW + c).to(torch.int64)]

    wy, wx = fy[..., None], fx[..., None]
    col0 = (1.0 - wy) * tap(r0, c0) + wy * tap(r1, c0)
    col1 = (1.0 - wy) * tap(r0, c1) + wy * tap(r1, c1)
    tex = (1.0 - wx) * col0 + wx * col1
    tex = torch.where((texk < K)[..., None], tex, 0.0)
    return has_tex, tex.unbind(-1)


def texel_taps(shape, mat_tex: Sequence[int], mc: Tensor, mmat: Tensor,
               u: Tensor, v: Tensor):
    """``texel``'s index arithmetic for an atlas of ``shape`` (K, TH, TW,
    3): (texk, (r0, r1, c0, c1), (fx, fy)), the texture id per lane (-1
    untextured, as f32), the taps' atlas rows (offset by ``texk * TH``, the
    id clamped into the atlas) and texture columns, and the bilinear
    weights of r1 and c1, all f32."""
    K, TH, TW = shape[:3]
    texk = torch.full_like(u, -1.0)
    for mi, tid in enumerate(mat_tex):
        if tid >= 0:
            texk = torch.where(mc & (mmat == mi), float(tid), texk)
    x = (u - torch.floor(u)) * TW - 0.5
    y = (v - torch.floor(v)) * TH - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    c0 = x0 + torch.where(x0 < 0.0, float(TW), 0.0)
    c1 = torch.where(x0 + 1.0 >= TW, x0 + 1.0 - TW, x0 + 1.0)
    base = torch.clamp(texk, 0.0, K - 1.0) * TH
    r0 = y0 + torch.where(y0 < 0.0, float(TH), 0.0) + base
    r1 = torch.where(y0 + 1.0 >= TH, y0 + 1.0 - TH, y0 + 1.0) + base
    return texk, (r0, r1, c0, c1), (fx, fy)


def pack_tri_lights(scene: Scene) -> tuple[Tensor, tuple]:
    """Triangle-light sampling rows and their static index.

    Rows (sum K, 14) f32: v0(3) e1(3) e2(3) n(3) cdf_hi area, one per real
    triangle of each TRI_LIGHT, in light order; the index holds
    (light, material, first row, K) per triangle light
    (``persistent.py:1091-1112`` of the JAX package)."""
    rows, index, off = [], [], 0
    for li, (ltype, _) in enumerate(scene.light_structure):
        K = scene.tri_light_counts[li] if ltype == TRI_LIGHT else 0
        if K <= 0:
            continue
        index.append((li, int(scene.light_mats[li]), off, K))
        rows.append(torch.cat([
            scene.tl_v0[li, :K], scene.tl_e1[li, :K], scene.tl_e2[li, :K],
            scene.tl_n[li, :K], scene.tl_cdf[li, :K, None],
            scene.tl_area[li].expand(K)[:, None]], dim=1))
        off += K
    if not rows:
        return torch.zeros((1, 14), dtype=torch.float32,
                           device=scene.device), ()
    return torch.cat(rows).to(torch.float32).contiguous(), tuple(index)


def mesh_merge(scene: Scene, tile_rows: int, alive, ox, oy, oz, dx, dy, dz,
               best_t, h: dict, MT, tris, Lt, counts: dict | None = None,
               tex_out: dict | None = None, walks=None):
    """Merge the mesh walk into a sphere hit record (``persistent.py:358-
    397, 498-507``): the walk starts from the sphere t on live lanes; where
    a triangle is strictly closer it wins the hit point (FMA, as the
    kernels), the unit geometric normal, the material's albedo, coefficient
    and BSDF type, and the emission of a TRI_LIGHT on its material. ``h``
    holds hit, hx hy hz, nx ny nz, ar ag ab, coef, is_s, is_t, er eg eb and
    is updated in place; ``MT`` is pack_materials as host rows, ``tris``
    pack_tri_lights' index. On a textured scene the walk tracks the hit's uv
    and the material colour of textured mesh hits is multiplied by their
    texel (``texel``; JAX ``persistent.py:491-497``), and ``counts``, if
    given, adds the texel fetches to ``"texel"``; ``tex_out``, if given,
    receives the hit's ``"uv"`` and ``"texel"`` (has_tex, (r, g, b)), for
    the gradient walk's atlas scatter; ``walks``, if given, is
    ``mesh_walk_ref``'s ``record``. Returns (mesh_closer, t_mesh,
    material)."""
    where = torch.where
    tex = scene.textured
    tm, mnx, mny, mnz, mmat, *uv = mesh_walk_ref(
        scene.mesh_packed, ox, oy, oz, dx, dy, dz,
        where(alive, best_t, 0.0), tile_rows=tile_rows, track_uv=tex,
        record=walks)
    mc = alive & (tm < best_t) & (tm < 0.5 * BIG)
    inv_len = torch.rsqrt(torch.clamp_min(mnx * mnx + mny * mny + mnz * mnz,
                                          1e-20))
    h["hit"] = h["hit"] | mc
    for k, o, d in (("hx", ox, dx), ("hy", oy, dy), ("hz", oz, dz)):
        h[k] = where(mc, fma(d, tm, o), h[k])
    for k, mn in (("nx", mnx), ("ny", mny), ("nz", mnz)):
        h[k] = where(mc, mn * inv_len, h[k])
    ms = mt_b = torch.zeros_like(mc)
    for mi, mt in enumerate(scene.mat_types):
        m_mask = mc & (mmat == mi)
        for c, k in enumerate(("ar", "ag", "ab")):
            h[k] = where(m_mask, MT[mi][c], h[k])
        if mt in (SPECULAR, TRANSMISSIVE):
            h["coef"] = where(m_mask, MT[mi][3], h["coef"])
        if mt == SPECULAR:
            ms = ms | (mmat == mi)
        elif mt == TRANSMISSIVE:
            mt_b = mt_b | (mmat == mi)
    h["is_s"] = (h["is_s"] & ~mc) | (mc & ms)
    h["is_t"] = (h["is_t"] & ~mc) | (mc & mt_b)
    if tex:
        has_tex, rgb = texel(scene.textures, scene.mat_textures_static, mc,
                             mmat, *uv)
        if counts is not None:
            counts["texel"] = counts.get("texel", 0) + int(has_tex.sum())
        if tex_out is not None:
            tex_out.update(uv=uv, texel=(has_tex, rgb))
        for k, t in zip(("ar", "ag", "ab"), rgb):
            h[k] = where(has_tex, t * h[k], h[k])
    for k in ("er", "eg", "eb"):
        h[k] = where(mc, 0.0, h[k])
    for li, lmat, _, _ in tris:
        m_mask = mc & (mmat == lmat)
        for c, k in enumerate(("er", "eg", "eb")):
            h[k] = where(m_mask, Lt[li][3 + c], h[k])
    return mc, tm, mmat


def tri_emitter_pdf(ldp, mc, tm, mmat, nx, ny, nz, wox, woy, woz, Lt, TL,
                    tris):
    """MIS pdf of a TRI_LIGHT hit as the light sampler sees it, t^2 / |cos|
    times selection over area (``persistent.py:644-653``)."""
    for li, lmat, off, _ in tris:
        m = mc & (mmat == lmat)
        cos_l = torch.abs(dot3(nx, ny, nz, wox, woy, woz))
        tt_c = torch.clamp_max(tm, 1e6)
        pc = (tt_c * tt_c / torch.clamp_min(cos_l, 1e-9)
              * _f32_div(Lt[li][7], max(TL[off][13], 1e-20)))
        ldp = torch.where(m, pc, ldp)
    return ldp


def sample_tri_light(TL, off, K, sel, hx, hy, hz, ul1, ul2):
    """NEE sample of a triangle light (``persistent.py:720-767``): the
    triangle by the area cdf through the cdf-hi chain (ul1 reused for the
    position within it), a uniform point on it, one-sided emission.
    Returns (wlx, wly, wlz, dist, pdf, valid)."""
    where = torch.where
    fz = torch.zeros_like(hx)
    attrs = [fz + TL[off][k] for k in range(12)]
    c_lo, c_hi = fz, fz + TL[off][12]
    for k in range(1, K):
        m_k = ul1 > TL[off + k - 1][12]
        attrs = [where(m_k, TL[off + k][c], a) for c, a in enumerate(attrs)]
        c_lo = where(m_k, TL[off + k - 1][12], c_lo)
        c_hi = where(m_k, TL[off + k][12], c_hi)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nlx, nly, nlz = attrs
    u0r = torch.clamp((ul1 - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-12),
                      0.0, 1.0)
    su = torch.sqrt(u0r)
    b1s = 1.0 - su
    b2s = ul2 * su
    wrx = v0x + b1s * e1x + b2s * e2x - hx
    wry = v0y + b1s * e1y + b2s * e2y - hy
    wrz = v0z + b1s * e1z + b2s * e2z - hz
    d2l = dot3(wrx, wry, wrz, wrx, wry, wrz)
    inv_dl = torch.rsqrt(torch.clamp_min(d2l, 1e-20))
    dist = d2l * inv_dl
    wlx, wly, wlz = wrx * inv_dl, wry * inv_dl, wrz * inv_dl
    cos_at = -dot3(nlx, nly, nlz, wlx, wly, wlz)
    pdf = sel * d2l / torch.clamp_min(
        torch.abs(cos_at) * max(TL[off][13], 1e-20), 1e-12)
    return wlx, wly, wlz, dist, pdf, (cos_at > 0.0) & (dist > EPSILON)


def mesh_occluded(scene: Scene, tile_rows: int, started, smax, hx, hy, hz,
                  wlx, wly, wlz, walks=None):
    """Shadow any-hit over the mesh (``persistent.py:816-824``): lanes that
    start walk from smax and are occluded once a triangle zeroes their t;
    ``walks`` is ``mesh_walk_ref``'s ``record``."""
    t = mesh_walk_ref(scene.mesh_packed, hx, hy, hz, wlx, wly, wlz,
                      torch.where(started, smax, 0.0), tile_rows=tile_rows,
                      occlusion=True, record=walks)
    return started & (t == 0.0)


def persistent_step_ref(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    state: PathState,
    *,
    budget: int,
    width: int,
    height: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int = 32,
    use_nee: bool = False,
    use_dof: bool = False,
    strat_k: int = 2,
    tile_offset: int | Sequence[int] = 0,
    uniforms: Tensor | None = None,
    counts: dict | None = None,
    walks=None,
) -> tuple[PathState, Tensor]:
    """Plain PyTorch version of ``persistent_step``: the JAX kernel's lane
    math, vectorized over all lanes at once with masked selects. Returns a
    new state (the input is not modified) and the live-ray count; if
    ``counts`` is a dict it also receives ``"texel"``, the texel fetches of
    textured mesh hits (for the kernel's bound); ``walks``, if given, is
    called as ``mesh_walk_ref``'s ``record`` on every mesh walk (to sample
    the segments for the bound's walk tests). ``tile_offset`` may also
    be a sequence, the image's tile index of each of the state's tiles, so
    that one call steps tiles scattered over the image (a walk costs about
    as much for several tiles as for one)."""
    dev = state.lr.device
    rows_total = state.lr.shape[0]
    n_tiles = rows_total // tile_rows
    shape = (rows_total, LANES)
    n_lanes = width * height
    n_prims = int(scene.num_prims)
    tmin = EPSILON
    n_draw = n_draws(use_nee, use_dof)
    seed_i, salt = int(seed[0]), int(seed[1])

    # host copies of the small tables: per-prim loops index them as scalars
    P = pack_prims(scene).cpu().tolist()
    Lt = pack_lights(scene).cpu().tolist()
    cam = cam_packed.cpu().tolist()
    emissive = tuple(scene.emissive_prims)
    spec_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                       if t == SPECULAR)
    trans_prims = tuple(i for i, t in enumerate(scene.prim_mtypes)
                        if t == TRANSMISSIVE)
    lights_static = tuple(scene.light_structure)
    mesh = packed_mesh(scene) is not None
    # mesh materials can be specular or transmissive without such a sphere
    any_spec = bool(spec_prims) or (mesh and SPECULAR in scene.mat_types)
    any_trans = bool(trans_prims) or (mesh and TRANSMISSIVE in scene.mat_types)
    MT = pack_materials(scene).cpu().tolist()
    TL, tris = pack_tri_lights(scene)
    TL = TL.cpu().tolist()
    tri_of = {li: (off, K) for li, _, off, K in tris}

    tile_of = torch.as_tensor(tile_offset, dtype=torch.int64, device=dev)
    if tile_of.dim() == 0:
        tile_of = tile_of + torch.arange(n_tiles, device=dev)
    if tuple(tile_of.shape) != (n_tiles,):
        raise ValueError(f"tile_offset names {tile_of.numel()} tiles for a "
                         f"state of {n_tiles}")
    lane = (torch.arange(rows_total * LANES, device=dev, dtype=torch.int64)
            .reshape(n_tiles, -1) % (tile_rows * LANES)
            + tile_of[:, None] * (tile_rows * LANES)).reshape(shape)
    in_domain = lane < n_lanes
    px = (lane % width).to(torch.float32)
    py = (lane // width).to(torch.float32)
    if uniforms is not None:
        ublk = uniforms.reshape(n_tiles, budget, n_draw, tile_rows, LANES)
    fzeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    bzeros = torch.zeros(shape, dtype=torch.bool, device=dev)
    where = torch.where
    mc = bzeros

    Lr, Lg, Lb = state.lr, state.lg, state.lb
    n_samp = state.n_samp
    ox, oy, oz = state.ox, state.oy, state.oz
    dx, dy, dz = state.dx, state.dy, state.dz
    Tr, Tg, Tb = state.tr, state.tg, state.tb
    Cr, Cg, Cb = state.cr, state.cg, state.cb
    bounce = state.bounce
    alive = state.alive != 0
    prev_pdf = state.prev_pdf
    prev_delta = state.prev_delta != 0
    n_live = torch.zeros(n_tiles, dtype=torch.int64, device=dev)

    def per_tile(mask):
        return mask.reshape(n_tiles, -1).sum(1)

    for it in range(budget):
        if uniforms is not None:
            u = [ublk[:, it, j].reshape(shape) for j in range(n_draw)]
        else:
            u = philox_uniforms(lane, seed_i, salt, state.frame, it, n_draw)
        (u_cam, v_cam), lens, (u1, u2, u3), nee_u = split_draws(
            u, use_nee, use_dof)
        if use_nee:
            ul1, ul2, usel = nee_u

        # ---- regenerate: dead lanes start the next sample of their pixel
        # (stratified jitter: cell = n_samp % strat_k^2, persistent.py:551)
        regen = (~alive) & in_domain
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
        alive = alive | regen
        n_live += per_tile(alive)

        # ---- closest hit: min over per-prim roots (root selection of
        # primitive.h:44: t0 if t0 > tmin else b + sq). On exact ties the
        # LAST matching prim wins the attribute selects.
        best_t = fzeros + BIG
        ts = []
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
            tv = where((det >= 0.0) & (t > tmin), t, BIG)
            ts.append(tv)
            best_t = torch.minimum(best_t, tv)
        hit = best_t < (0.5 * BIG)
        hx = fma(dx, best_t, ox)
        hy = fma(dy, best_t, oy)
        hz = fma(dz, best_t, oz)
        cx = cy = cz = inv_r = ar = ag = ab = fzeros
        is_ps = []
        for p in range(n_prims):
            is_p = ts[p] == best_t
            is_ps.append(is_p)
            cx = where(is_p, P[p][0], cx)
            cy = where(is_p, P[p][1], cy)
            cz = where(is_p, P[p][2], cz)
            inv_r = where(is_p, _f32_div(1.0, P[p][3]), inv_r)
            ar = where(is_p, P[p][4], ar)
            ag = where(is_p, P[p][5], ag)
            ab = where(is_p, P[p][6], ab)
        nx = (hx - cx) * inv_r
        ny = (hy - cy) * inv_r
        nz = (hz - cz) * inv_r
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
        if mesh:
            h = dict(hit=hit, hx=hx, hy=hy, hz=hz, nx=nx, ny=ny, nz=nz,
                     ar=ar, ag=ag, ab=ab, coef=coef, is_s=is_s, is_t=is_t,
                     er=er, eg=eg, eb=eb)
            mc, tm, mmat = mesh_merge(scene, tile_rows, alive, ox, oy, oz,
                                      dx, dy, dz, best_t, h, MT, tris, Lt,
                                      counts, walks=walks)
            (hit, hx, hy, hz, nx, ny, nz, ar, ag, ab, coef, is_s, is_t,
             er, eg, eb) = h.values()
            # sphere winner masks must not fire on mesh-won lanes
            is_ps = [m & ~mc for m in is_ps]

        act = alive & hit
        # Lanes that do not act sit on the origin: a miss lane's o + d*1e30
        # would overflow in the NEE distance math and turn into NaN.
        actf = act.to(torch.float32)
        hx = hx * actf
        hy = hy * actf
        hz = hz * actf
        wox, woy, woz = dx, dy, dz

        # ---- emitter hits, MIS-weighted against light sampling under NEE
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
        Cr = Cr + Tr * er * take
        Cg = Cg + Tg * eg * take
        Cb = Cb + Tb * eb * take

        # ---- next-event estimation
        is_d = ~(is_s | is_t)
        if use_nee:
            n_l = len(lights_static)
            for li, (ltype, lprim) in enumerate(lights_static):
                lo, sel = Lt[li][6], Lt[li][7]
                # the last light takes the remainder of [0, 1)
                if li == n_l - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < _f32_add(lo, sel))
                (wlx, wly, wlz, dist_l, pdf_l, (rad_r, rad_g, rad_b), valid,
                 is_delta) = sample_light(P, Lt, li, ltype, lprim, hx, hy, hz,
                                          ul1, ul2, fzeros,
                                          tri=(TL, *tri_of.get(li, (0, 0))))
                # shadow any-hit: segment-ball distance form over all prims
                # but the sampled light sphere (which cannot occlude its own
                # cone sample: its hit lies beyond smax by construction)
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
                if is_delta:
                    w_mis = 1.0
                else:
                    pdf_b_l = where(support, cos_l * INV_PI, 0.0)
                    w_mis = (pdf_l * pdf_l) / torch.clamp_min(
                        pdf_l * pdf_l + pdf_b_l * pdf_b_l, 1e-20)
                # every needed shadow segment counts as a traced ray
                n_live += per_tile(act & m_l & valid & support)
                gate = (act & m_l & valid & support & ~occ).to(torch.float32)
                scale = gate * cos_l * w_mis / torch.clamp_min(pdf_l, 1e-20)
                Cr = Cr + Tr * (ar * INV_PI) * rad_r * scale
                Cg = Cg + Tg * (ag * INV_PI) * rad_g * scale
                Cb = Cb + Tb * (ab * INV_PI) * rad_b * scale

        # ---- BSDF sampling: one lobe per lane under masks
        wix, wiy, wiz, fr, fg, fb, pdf, wgt = sample_lobe(
            nx, ny, nz, wox, woy, woz, ar, ag, ab, coef, is_s, is_t, is_d,
            u1, u2, any_spec, any_trans)
        f_black = (fr <= 0.0) & (fg <= 0.0) & (fb <= 0.0)
        contrib_ok = ~f_black & (pdf > 0.0)
        step_ok = act & contrib_ok
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

        # ---- path completion: flush per-path radiance into the pixel sum
        died = alive & ~alive_next
        diedf = died.to(torch.float32)
        Lr = Lr + Cr * diedf
        Lg = Lg + Cg * diedf
        Lb = Lb + Cb * diedf
        n_samp = n_samp + died.to(torch.int32)

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

    new = PathState(
        lr=Lr, lg=Lg, lb=Lb, n_samp=n_samp, ox=ox, oy=oy, oz=oz,
        dx=dx, dy=dy, dz=dz, tr=Tr, tg=Tg, tb=Tb, cr=Cr, cg=Cg, cb=Cb,
        bounce=bounce, alive=alive.to(torch.int32), prev_pdf=prev_pdf,
        prev_delta=prev_delta.to(torch.int32), frame=state.frame + 1,
    )
    return new, n_live.sum()


def _f32_div(a: float, b: float) -> float:
    """a / b rounded as float32 division of float32 scalars, as the kernels
    compute their per-prim reciprocals."""
    return float(torch.tensor(a, dtype=torch.float32)
                 / torch.tensor(b, dtype=torch.float32))


def _f32_add(a: float, b: float) -> float:
    return float(torch.tensor(a, dtype=torch.float32)
                 + torch.tensor(b, dtype=torch.float32))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

@functools.cache
def _kernel():
    """The bound C entry point of csrc/persistent.cu (built on first use)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    fn = lib.tpt_persistent_step
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ctypes.POINTER(p),  # state planes, STATE_FIELDS order (host array)
        p, ip, i,  # prims (device), prim flags (host), n_prims
        p, ip, i,  # lights (device), light structure (host), n_lights
        p, p, p,  # camera (device), uniforms (device or NULL), nrays
        p, p, p, p, i,  # bvh nodes, tris, mats, tri lights; nodes
        p, i, i, i,  # texture atlas (device or NULL), K, TH, TW
        i, i, i, i, i,  # rows_total, tile_rows, budget, width, n_lanes
        i, i, i, i, i, i,  # max_bounces, rr_start, use_nee, use_dof,
        #                    strat_k, tile_off
        u, u, u,  # seed, salt, frame
        p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    lib.tpt_error_string.argtypes = [ctypes.c_int]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return fn, lib.tpt_error_string


def _check(t: Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def light_structure(scene: Scene, tris) -> list[int]:
    """The kernels' light structure, LS = 5 ints per light: type, sphere
    prim (or -1), TRI_LIGHT material (or -1), first row and row count of
    its triangles in pack_tri_lights' table."""
    rows = {li: (off, K) for li, _, off, K in tris}
    out = []
    for li, (ltype, lprim) in enumerate(scene.light_structure):
        off, K = rows.get(li, (0, 0))
        out += [int(ltype), int(lprim), int(scene.light_mats[li]), off, K]
    return out


def mesh_arguments(scene: Scene, dev) -> tuple[list, list, list]:
    """(pointers, tensors to keep alive, light structure) for a kernel
    launch: the binary tree's nodes and triangle slots (``pack_bvh``, built
    once by with_packet_mesh), the material and triangle-light tables
    (built on the device from the scene's tables), and the node count; NULL
    pointers and 0 nodes for a sphere-only scene. Raises ValueError for an
    unpacked mesh and past the kernels' limits."""
    pm = packed_mesh(scene)
    tl, tris = pack_tri_lights(scene)
    lstruct = light_structure(scene, tris)
    if pm is None:
        return [None] * 4 + [0], [], lstruct
    bvh = scene.mesh_bvh
    if bvh is None:
        raise ValueError(
            "the persistent kernels walk the mesh's binary tree: pack it "
            "first with models.scene.with_packet_mesh(scene)")
    if bvh.num_nodes >= MAX_NODES or bvh.tris.numel() >= 2 ** 31:
        raise ValueError(
            f"the kernels' mesh walk takes fewer than {MAX_NODES} nodes and "
            f"2^31 floats of triangle slots, got {bvh.num_nodes} and "
            f"{bvh.tris.numel()}")
    mats = pack_materials(scene)
    keep = [bvh.nodes, bvh.tris, mats, tl]
    for t, name in zip(keep, ("bvh nodes", "bvh tris", "mats",
                              "tri_lights")):
        _check(t, name, torch.float32, tuple(t.shape), dev)
    return [t.data_ptr() for t in keep] + [bvh.num_nodes], keep, lstruct


def tex_route(scene: Scene) -> bool:
    """The kernels sample (and the gradient kernel differentiates) the
    texture atlas: the scene has a packed mesh and an atlas (JAX
    ``persistent.py:1131``, ``replay_persistent.py:1176``)."""
    return scene.textures is not None and packed_mesh(scene) is not None


def texture_arguments(scene: Scene, dev) -> tuple[list, list]:
    """(pointer, K, TH, TW) of the texture atlas (K, TH, TW, 3) f32 for a
    kernel launch, and the tensors to keep alive; NULL and zeros where the
    kernels take no atlas (``tex_route``; the untextured build runs
    then)."""
    if not tex_route(scene):
        return [None, 0, 0, 0], []
    atlas = scene.textures
    _check(atlas, "textures", torch.float32, tuple(atlas.shape), dev)
    if atlas.ndim != 4 or atlas.shape[-1] != 3 or atlas.numel() >= 2 ** 31:
        raise ValueError(f"the texture atlas must be (K, TH, TW, 3) with "
                         f"fewer than 2^31 floats, got {tuple(atlas.shape)}")
    return [atlas.data_ptr(), *atlas.shape[:3]], [atlas]


def _persistent_step_cuda(scene, cam_packed, seed, state, *, budget, width,
                          height, max_bounces, rr_start, tile_rows, use_nee,
                          use_dof, strat_k, tile_offset, uniforms):
    global launches, mesh_launches
    dev = state.lr.device
    rows_total = state.lr.shape[0]
    shape = (rows_total, LANES)
    if rows_total % tile_rows:
        raise ValueError(f"{rows_total} state rows are not whole tiles of "
                         f"{tile_rows} rows")
    n_tiles = rows_total // tile_rows
    for f in STATE_FIELDS:
        _check(getattr(state, f), f,
               torch.int32 if f in I32_FIELDS else torch.float32, shape, dev)
    n_prims = int(scene.num_prims)
    n_lights = len(scene.light_structure)
    if n_prims > MAX_PRIMS or n_lights > MAX_LIGHTS:
        raise ValueError(f"the kernel takes at most {MAX_PRIMS} prims and "
                         f"{MAX_LIGHTS} lights, got {n_prims} and {n_lights}")
    prims = pack_prims(scene).contiguous()
    lights = pack_lights(scene).contiguous()
    _check(prims, "prims", torch.float32, (n_prims, 12), dev)
    _check(lights, "lights", torch.float32, (max(n_lights, 1), 8), dev)
    _check(cam_packed, "cam_packed", torch.float32, (24,), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32,
               (n_tiles * budget * n_draws(use_nee, use_dof) * tile_rows,
                LANES), dev)
    if strat_k < 1 or budget < 0:
        raise ValueError("strat_k must be >= 1 and budget >= 0")

    mesh_ptrs, _keep, ls = mesh_arguments(scene, dev)
    tex_args, _keep_tex = texture_arguments(scene, dev)
    # per-prim flags: bit 0 emissive, bits 1-2 the BSDF type
    emissive = set(scene.emissive_prims)
    pflags = (ctypes.c_int * max(n_prims, 1))(*[
        (1 if p in emissive else 0) | (int(t) << 1)
        for p, t in enumerate(scene.prim_mtypes)])
    lstruct = (ctypes.c_int * max(len(ls), 1))(*ls)
    planes = (ctypes.c_void_p * len(STATE_FIELDS))(
        *[getattr(state, f).data_ptr() for f in STATE_FIELDS])
    nrays = torch.zeros(n_tiles, dtype=torch.int32, device=dev)

    fn, error_string = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(planes, prims.data_ptr(), pflags, n_prims,
                 lights.data_ptr(), lstruct, n_lights,
                 cam_packed.data_ptr(),
                 uniforms.data_ptr() if uniforms is not None else None,
                 nrays.data_ptr(), *mesh_ptrs, *tex_args,
                 rows_total, tile_rows, budget, width, width * height,
                 max_bounces, rr_start, int(use_nee), int(use_dof), strat_k,
                 int(tile_offset),
                 int(seed[0]) & _MASK, int(seed[1]) & _MASK,
                 state.frame & _MASK, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"persistent kernel launch failed: {msg} ({err})")
    launches += 1
    mesh_launches += scene.mesh is not None
    # the planes were updated in place; prims/lights/nrays and the mesh
    # tables stay referenced until here, and the kernel is ordered before
    # any later use of them on this stream
    return dataclasses.replace(state, frame=state.frame + 1), nrays.sum()


def persistent_step(
    scene: Scene,
    cam_packed: Tensor,
    seed: Sequence[int],
    state: PathState,
    *,
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
    uniforms: Tensor | None = None,
) -> tuple[PathState, Tensor]:
    """Advance every lane by ``budget`` wavefront iterations.

    ``seed`` is ``(seed, salt)`` as host integers; ``use_dof`` regenerates
    paths through the packed camera's thin lens (pass ``camera.use_dof``).
    Returns (new_state,
    live_rays_traced) with the ray count as a 0-d device tensor. For state on
    a CUDA device this launches the CUDA kernel on the current stream and
    UPDATES THE STATE PLANES IN PLACE (the JAX version donates its state): the
    returned state shares them, and the input state must not be reused. For
    state on the CPU it runs ``persistent_step_ref``, which returns new
    tensors. Any other device raises.
    """
    kw = dict(budget=budget, width=width, height=height,
              max_bounces=max_bounces, rr_start=rr_start,
              tile_rows=tile_rows, use_nee=use_nee, use_dof=use_dof,
              strat_k=strat_k,
              tile_offset=tile_offset, uniforms=uniforms)
    dev = state.lr.device
    if dev.type == "cuda":
        return _persistent_step_cuda(scene, cam_packed, seed, state, **kw)
    if dev.type == "cpu":
        return persistent_step_ref(scene, cam_packed, seed, state, **kw)
    raise ValueError(f"persistent_step: unsupported device {dev}")
