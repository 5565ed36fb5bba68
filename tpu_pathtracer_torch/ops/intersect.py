"""Batched ray-scene intersection: spheres, then the triangle mesh.

Counterpart of ``tpu_pathtracer/ops/intersect.py``. Every ray tests every
sphere, the two ray-dependent dot products phrased as ``(N, 3) x (3, P)``
matrix products; the closest hit is a min/argmin over the prim axis, with the
reference's root selection (take t0 = b - sqrt(det) if tmin < t0 < tmax, else
t1 = b + sqrt(det) if tmin < t1 < tmax). The mesh is merged after the sphere
pass: a packed mesh through ``intersect_mesh_packet`` (kernel 5 on the card,
with kernel 6 for the two-pass traversal), an unpacked one through
``ops/triangle.py::intersect_mesh`` (CPU tensors only). Hit attributes are
gathers from the material and light tables; a textured material's albedo is
the texture sample times its colour.

Under autograd the sphere pass is differentiable in the rays and in the
centres and radii, as the JAX package's is. The mesh walks are not: where a
gradient can reach a mesh hit (grad mode on and the rays or the mesh's
vertices require grad), its t and uv are evaluated once more by
``moller_trumbore`` from the winning triangle's vertices and enter as
``x + (x_re - sg(x_re))``, so the primal stays the walk's bit for bit and
the derivative is the one the JAX package's JVP through its traversal gives
(the walk's decisions carry no tangent).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    EPSILON, TRI_LIGHT, PrimAttrs, Scene,
)
from tpu_pathtracer_torch.ops import vecmath as vm

# Finite stand-in for FLT_MAX (reference globals.h:59).
BIG = 1e30


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA intersection record (reference scene.h:45-64)."""

    t: Tensor  # (N,) hit distance, BIG on a miss
    prim: Tensor  # (N,) int64 primitive index; mesh hits are >= num spheres
    hit: Tensor  # (N,) bool
    p: Tensor  # (N, 3) hit point
    n: Tensor  # (N, 3) outward geometric normal
    center: Tensor  # (N, 3) hit sphere centre (the hit point for triangles)
    radius: Tensor  # (N,) hit sphere radius (0 for triangles)
    albedo: Tensor  # (N, 3) material colour (textured where it applies)
    coef: Tensor  # (N,) material coefficient (specular scale or IOR)
    mtype: Tensor  # (N,) int32 material type
    emission: Tensor  # (N, 3) emitted radiance of the hit prim
    mat: Tensor  # (N,) int64 material id


def ray_sphere_t(scene: Scene, o: Tensor, d: Tensor, tmin: float = EPSILON,
                 tmax: float = BIG) -> Tensor:
    """Per (ray, prim) hit distance, (N, P); BIG where missed."""
    c = scene.centers
    r2 = scene.radii * scene.radii
    dc = torch.matmul(d, c.T)
    oc = torch.matmul(o, c.T)
    od = vm.dot(o, d)[:, None]
    o2 = vm.length_sq(o)[:, None]
    c2 = vm.length_sq(c)[None, :]
    b = dc - od
    op2 = c2 - 2.0 * oc + o2
    det = b * b - op2 + r2[None, :]
    sq = vm.safe_sqrt(det)
    t0 = b - sq
    t1 = b + sq
    t = torch.where(t0 > tmin, torch.where(t0 < tmax, t0, BIG),
                    torch.where((t1 > tmin) & (t1 < tmax), t1, BIG))
    miss = (det < 0.0) | ~scene.prim_valid[None, :]
    return torch.where(miss, BIG, t)


def intersect_p(scene: Scene, o: Tensor, d: Tensor, tmin: float = EPSILON,
                tmax: Tensor | float = BIG, mask: Tensor | None = None,
                presorted: bool = False) -> Tensor:
    """Any-hit shadow test (reference scene.h:101-108). ``tmax`` may be per
    ray. Returns (N,) bool, True where something occludes. ``mask``: lanes
    whose answer the caller discards; they report occluded and the packet
    kernel skips them. ``presorted``: lanes are already coherence-sorted,
    so the single-pass query skips its own sort."""
    tmax_t = torch.as_tensor(tmax, dtype=o.dtype, device=o.device)
    if tmax_t.ndim == 0:
        tmax_t = tmax_t.expand(o.shape[0])
    t = ray_sphere_t(scene, o, d, tmin=tmin)
    occluded = torch.any(t < tmax_t[:, None], dim=-1)
    if scene.mesh is None:
        return occluded
    if scene.mesh_packed is not None:
        from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
            intersect_mesh_packet,
        )

        # Walk from t_init = the segment length: the first occluder zeroes
        # t; lanes the sphere pass occluded or the caller masked are dead.
        t_init = torch.where(occluded, 0.0, tmax_t)
        if mask is not None:
            t_init = torch.where(mask, t_init, 0.0)
        coarse = scene.mesh_packed_coarse
        with torch.no_grad():
            ph = intersect_mesh_packet(
                scene.mesh_packed, o, d, tmin=tmin, t_init=t_init,
                sort=(not presorted) or coarse is not None, any_hit=True,
                coarse=coarse, bvh=scene.mesh_bvh)
        occluded = occluded | (ph.t < tmax_t)
        if mask is not None:
            occluded = occluded | ~mask
        return occluded
    from tpu_pathtracer_torch.ops.triangle import intersect_mesh

    with torch.no_grad():
        th = intersect_mesh(scene.mesh, o, d, tmin=tmin, tmax=tmax_t,
                            any_hit=True)
    return occluded | (th.t < tmax_t)


def intersect(scene: Scene, attrs: PrimAttrs, o: Tensor, d: Tensor,
              tmin: float = EPSILON, tmax: float = BIG,
              alive: Tensor | None = None, presorted: bool = False) -> Hit:
    """Closest-hit query with the shading attributes of the hit. ``alive``:
    lanes the caller knows are dead (the packet kernel skips them; their
    results are arbitrary but finite). ``presorted``: as in
    ``intersect_p``."""
    t_np = ray_sphere_t(scene, o, d, tmin=tmin, tmax=tmax)
    t = torch.amin(t_np, dim=-1)
    idx = torch.argmin(t_np, dim=-1)  # the first index of the minimum
    hit = t < 0.5 * BIG
    center = vm.take(scene.centers, idx)
    radius = vm.take(scene.radii, idx)
    albedo = vm.take(attrs.albedo, idx)
    emission = vm.take(attrs.emission, idx)
    coef = vm.take(attrs.coef, idx)
    mtype = attrs.mtype[idx]
    mat = scene.material_id[idx]
    # a miss lane gets a unit-distance dummy point, not o + BIG d
    p = o + d * torch.where(hit, t, 1.0)[:, None]
    n = (p - center) / torch.clamp_min(radius, 1e-12)[:, None]
    hit_rec = Hit(t=t, prim=idx, hit=hit, p=p, n=n, center=center,
                  radius=radius, albedo=albedo, coef=coef, mtype=mtype,
                  emission=emission, mat=mat)
    if scene.mesh is not None:
        hit_rec = _merge_mesh_hit(scene, o, d, tmin, alive, hit_rec,
                                  presorted)
    return hit_rec


def _merge_mesh_hit(scene: Scene, o: Tensor, d: Tensor, tmin: float,
                    alive: Tensor | None, h: Hit, presorted: bool) -> Hit:
    """Fold triangle hits into the sphere hit record (closest wins).
    Triangle attributes come from the material tables through the
    triangle's material; a textured material's albedo is the bilinear
    texture sample times its colour; a triangle of a TRI_LIGHT's material
    emits that light's intensity."""
    mesh = scene.mesh
    attach = torch.is_grad_enabled() and any(
        x.requires_grad for x in (o, d, mesh.v0, mesh.e1, mesh.e2))
    if scene.mesh_packed is not None:
        from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
            intersect_mesh_packet,
        )

        # the walk starts from the sphere t and skips caller-dead lanes
        t_init = torch.where(h.hit, h.t, BIG)
        if alive is not None:
            t_init = torch.where(alive, t_init, 0.0)
        coarse = scene.mesh_packed_coarse
        with torch.no_grad():
            ph = intersect_mesh_packet(
                scene.mesh_packed, o, d, tmin=tmin, t_init=t_init,
                sort=(not presorted) or coarse is not None, coarse=coarse,
                want_tri=attach, bvh=scene.mesh_bvh)
        th_t, th_tri, tn = ph.t, ph.tri.to(torch.int64), ph.n
        tmat, uv = ph.mat.to(torch.int64), ph.uv
    else:
        from tpu_pathtracer_torch.ops.triangle import intersect_mesh

        with torch.no_grad():
            th = intersect_mesh(mesh, o, d, tmin=tmin)
        th_t, th_tri = th.t, th.tri
        tn = mesh.n_geom[th_tri]
        tmat = mesh.material_id[th_tri].to(torch.int64)
        uv = (mesh.uv0[th_tri] + th.u[:, None] * mesh.uv_e1[th_tri]
              + th.v[:, None] * mesh.uv_e2[th_tri])
    closer = th_t < h.t
    if attach:
        th_t, uv = _reattach(mesh, o, d, tmin, closer, th_tri, th_t, uv)

    t_albedo = vm.take(scene.mat_color, tmat)
    if scene.textures is not None:
        from tpu_pathtracer_torch.ops.texture import sample_bilinear

        tex_id = scene.mat_texture[tmat]
        tex_rgb = sample_bilinear(scene.textures, tex_id, uv)
        t_albedo = torch.where((tex_id >= 0)[:, None], tex_rgb * t_albedo,
                               t_albedo)
    cl = closer[:, None]
    tp = o + d * torch.where(th_t < 0.5 * BIG, th_t, 1.0)[:, None]
    if scene.has_tri_lights:
        M = scene.mat_color.shape[0]
        is_tl = ((scene.light_type == TRI_LIGHT) & scene.light_valid)
        lm = torch.clamp(scene.light_mat, 0, M - 1).to(torch.int64)
        em_by_mat = torch.zeros((M, 3), dtype=h.emission.dtype,
                                device=o.device).index_add_(
            0, lm, scene.light_intensity * is_tl[:, None])
        t_emission = vm.take(em_by_mat, tmat)
    else:
        t_emission = torch.zeros_like(h.emission)
    return Hit(
        t=torch.where(closer, th_t, h.t),
        prim=torch.where(closer, scene.centers.shape[0] + th_tri, h.prim),
        hit=h.hit | closer,
        p=torch.where(cl, tp, h.p),
        n=torch.where(cl, tn, h.n),
        center=torch.where(cl, tp, h.center),
        radius=torch.where(closer, 0.0, h.radius),
        albedo=torch.where(cl, t_albedo, h.albedo),
        coef=torch.where(closer, vm.take(scene.mat_coef, tmat), h.coef),
        mtype=torch.where(closer, scene.mat_type[tmat], h.mtype),
        emission=torch.where(cl, t_emission, h.emission),
        mat=torch.where(closer, tmat, h.mat),
    )


def _reattach(mesh, o: Tensor, d: Tensor, tmin: float, won: Tensor,
              tri: Tensor, t: Tensor, uv: Tensor) -> tuple[Tensor, Tensor]:
    """t and uv of the lanes ``won`` by a triangle, with the derivative of
    Moller-Trumbore on its vertices and the rays and the walk's values as
    the primal. Lanes that no triangle won keep theirs, with no gradient."""
    from tpu_pathtracer_torch.ops.triangle import moller_trumbore

    tri = torch.where(won, tri, 0)
    v0, e1, e2, uv0, uv_e1, uv_e2 = (
        vm.take(getattr(mesh, f), tri)
        for f in ("v0", "e1", "e2", "uv0", "uv_e1", "uv_e2"))
    _, t_re, u_re, v_re = moller_trumbore(o, d, v0, e1, e2, tmin, t)
    uv_re = uv0 + u_re[:, None] * uv_e1 + v_re[:, None] * uv_e2
    t = t + torch.where(won, t_re - t_re.detach(), 0.0)
    uv = uv + torch.where(won[:, None], uv_re - uv_re.detach(), 0.0)
    return t, uv
