r"""Geometry gradients: sphere centres and radii, and mesh translation.

Counterpart of ``tpu_pathtracer/diff/geometry.py``. Moving a sphere moves
visibility discontinuities, so a pixel's derivative has a boundary term
that pointwise autodiff cannot see:

    d/dpi I_p = \int_pixel dL/dpi dx dy                    (interior)
              + \oint_{edges in pixel} (L_in - L_out) (v . n_hat) ds

* interior: autograd of ``integrator.render`` with ``attached_geom`` (the
  hit, the hit point and the diffuse cosine move with the sphere; sampling
  decisions stay detached);
* boundary: Monte Carlo over each sphere's primary silhouette. From eye e
  a sphere (c, r) with D = |c - e| > r has the silhouette circle of centre
  c - (r^2 / D) d_hat and radius r sqrt(1 - r^2 / D^2) in the plane normal
  to d_hat; theta -> raster position is smooth in (c, r), so the edge
  velocity v, its tangent and its outward normal come from
  ``torch.func.jacfwd``. L_in and L_out are traced a hair inside and
  outside the silhouette on the same lane ids, so an occluded edge sample
  cancels.

Scope, as in JAX: primary silhouettes only (no shadow or reflected
silhouettes); a camera inside a sphere (the Cornell walls) gives no
silhouette. The angles are stratified, offset per sphere by one draw of
``rng.EDGE_STREAM`` keyed on the prim index, and sphere p's edge lanes have
ids (p + 1) * S + i, with S the least multiple of 0x100000 at or above both
the image's lane count and the edge samples per sphere (JAX's 0x100000
while the image has at most 2^20 lanes), so they draw their own paths from
the render's streams, apart from every pixel lane's (tests pass
``theta_offsets`` and draws for those lanes).

``mesh_translation_grads`` is the mesh row: the attached interior term of a
rigid translation of the mesh (or of some materials' triangles). The walk
stays detached; ``ops/intersect.py`` re-evaluates each mesh hit's t and uv
from its triangle's translated vertices, which is the derivative of JAX's
JVP through its traversal. Mesh silhouettes and shadow edges are not
sampled (JAX's scope).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from tpu_pathtracer_torch.diff.replay import grad_or_zeros
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.models.integrator import (
    RenderConfig, render, trace,
)
from tpu_pathtracer_torch.models.scene import Scene, with_packet_mesh
from tpu_pathtracer_torch.ops import vecmath as vm
from tpu_pathtracer_torch.utils import rng

EDGE_LANE_STRIDE = 0x100000  # the unit of the edge lanes' stride


def edge_lane_stride(n_image_lanes: int, n_edge_samples: int) -> int:
    """S of the edge lanes' ids (p + 1) * S + i (module docstring)."""
    need = max(n_image_lanes, n_edge_samples)
    return EDGE_LANE_STRIDE * -(-need // EDGE_LANE_STRIDE)


def _raster_of(cam: Camera, q: Tensor) -> Tensor:
    """World point(s) q (..., 3) -> raster (sx, sy): solves
    [px_x | -px_y | first_ray_dir] (a, b, l) = q - pos, then (a, b) / l."""
    M = torch.stack([cam.px_x, -cam.px_y, cam.first_ray_dir], dim=-1)
    abl = (q - cam.pos) @ torch.linalg.inv(M).T
    return abl[..., :2] / abl[..., 2:3]


def _silhouette_raster(cam: Camera, center: Tensor, radius: Tensor,
                       theta: Tensor) -> Tensor:
    """Raster position of the silhouette point at angle theta, smooth in
    (center, radius)."""
    d = center - cam.pos
    D = vm.length(d)
    d_hat = d / D
    rs = radius * torch.sqrt(torch.clamp_min(
        1.0 - radius * radius / (D * D), 1e-12))
    c0 = center - (radius * radius / D) * d_hat
    e1, e2 = vm.orthonormal_basis(d_hat)
    q = c0 + rs * (torch.cos(theta)[..., None] * e1
                   + torch.sin(theta)[..., None] * e2)
    return _raster_of(cam, q)


def _edge_samples(cam: Camera, center: Tensor, radius: Tensor,
                  thetas: Tensor, eps_px: float):
    """(xs, x_in, x_out, v . n_hat per centre coordinate (N, 3), per radius
    (N,), |dx/dtheta| (N,), valid (N,)) of one sphere's silhouette."""
    W, H = cam.width, cam.height

    def xs_fn(c, r, th):
        return _silhouette_raster(cam, c, r, th)

    c, r = center.detach(), radius.detach()
    xs = xs_fn(c, r, thetas)  # (N, 2)
    t_vec = torch.func.vmap(torch.func.jacfwd(xs_fn, argnums=2),
                            in_dims=(None, None, 0))(c, r, thetas)
    v_c = torch.func.vmap(torch.func.jacfwd(xs_fn, argnums=0),
                          in_dims=(None, None, 0))(c, r, thetas)  # (N, 2, 3)
    v_r = torch.func.vmap(torch.func.jacfwd(xs_fn, argnums=1),
                          in_dims=(None, None, 0))(c, r, thetas)  # (N, 2)
    speed = torch.sqrt(torch.sum(t_vec * t_vec, dim=-1))
    # outward normal: the tangent turned 90 degrees, away from the raster
    # of the centre
    n_raw = torch.stack([t_vec[:, 1], -t_vec[:, 0]], dim=-1)
    n_hat = n_raw / torch.clamp_min(speed, 1e-12)[:, None]
    flip = torch.sign(torch.sum(n_hat * (xs - _raster_of(cam, c)), dim=-1))
    n_hat = n_hat * flip[:, None]
    pix = torch.floor(xs + 0.5)
    D = vm.length(c - cam.pos)
    valid = ((pix[:, 0] >= 0) & (pix[:, 0] < W) & (pix[:, 1] >= 0)
             & (pix[:, 1] < H) & (D > r)
             & torch.isfinite(xs).all(dim=-1) & torch.isfinite(n_hat).all(-1))
    # invalid samples trace a finite dummy ray and are masked out below
    xs = torch.where(valid[:, None], xs, 0.0)
    n_hat = torch.where(valid[:, None], n_hat, 0.0)
    vn_c = torch.einsum("nkc,nk->nc", v_c, n_hat)
    vn_r = torch.sum(v_r * n_hat, dim=-1)
    return (xs, xs - eps_px * n_hat, xs + eps_px * n_hat, vn_c, vn_r, speed,
            valid)


def _raster_rays(cam: Camera, x: Tensor) -> tuple[Tensor, Tensor]:
    d = vm.normalize(cam.first_ray_dir + cam.px_x * x[:, 0:1]
                     - cam.px_y * x[:, 1:2])
    return cam.pos.expand(d.shape).contiguous(), d


def geometry_grads(scene: Scene, cam: Camera, seed: int,
                   config: RenderConfig, d_loss_d_image: Tensor,
                   iteration: int = 0, n_edge_samples: int = 512,
                   eps_px: float = 0.05, draws: rng.Draws | None = None,
                   theta_offsets: Tensor | None = None) -> dict:
    """d loss / d {centers (P, 3), radii (P,)} of loss = sum(d_loss_d_image
    * image): the attached interior term plus the silhouette term of every
    sphere. Draws are Philox keyed on (seed, iteration) unless ``draws`` is
    given; ``theta_offsets`` (num_prims,) in [0, 1) replaces the per-sphere
    ``EDGE_STREAM`` draws."""
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    centers = scene.centers.detach().clone().requires_grad_(True)
    radii = scene.radii.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        img = render(dataclasses.replace(scene, centers=centers, radii=radii),
                     cam, seed, dataclasses.replace(config, attached_geom=True),
                     iteration, draws)
        g_c, g_r = grad_or_zeros(torch.sum(img * d_loss_d_image),
                                 (centers, radii))

    n_prims = int(scene.num_prims)
    if n_prims == 0:
        return {"centers": g_c, "radii": g_r}
    dev = scene.device
    N = n_edge_samples
    base = torch.arange(N, dtype=torch.float32, device=dev) / N
    prims = torch.arange(n_prims, dtype=torch.int32, device=dev)
    if theta_offsets is None:
        theta_offsets = draws(rng.EDGE_STREAM, 0, prims, 1)[:, 0]
    stride = edge_lane_stride(cam.height * cam.width * config.spp, N)
    if (n_prims + 1) * stride > 2**31:
        raise ValueError(f"geometry_grads: {n_prims} spheres' edge lanes at "
                         f"stride {stride} pass the int32 lane ids")
    rays, lanes, parts = [], [], []
    with torch.no_grad():
        for p in range(n_prims):
            thetas = (base + theta_offsets[p]) * (2.0 * math.pi)
            xs, x_in, x_out, vn_c, vn_r, speed, valid = _edge_samples(
                cam, scene.centers[p], scene.radii[p], thetas, eps_px)
            rays += [x_in, x_out]
            lane = (p + 1) * stride + torch.arange(
                N, dtype=torch.int32, device=dev)
            lanes += [lane, lane]
            parts.append((xs, vn_c, vn_r, speed, valid))
        o, d = _raster_rays(cam, torch.cat(rays))
        L = trace(scene, o, d, torch.cat(lanes), draws, config)
        gb_c = torch.zeros_like(g_c)
        gb_r = torch.zeros_like(g_r)
        H, W = cam.height, cam.width
        for p, (xs, vn_c, vn_r, speed, valid) in enumerate(parts):
            dL = L[2 * p * N:(2 * p + 1) * N] - L[(2 * p + 1) * N:
                                                   (2 * p + 2) * N]
            pix = torch.floor(xs + 0.5).to(torch.int64)
            w_pix = d_loss_d_image[torch.clamp(pix[:, 1], 0, H - 1),
                                   torch.clamp(pix[:, 0], 0, W - 1)]
            common = torch.where(
                valid, torch.sum(w_pix * dL, dim=-1) * (2.0 * math.pi / N),
                0.0)
            gb_c[p] = torch.sum(common[:, None] * vn_c * speed[:, None],
                                dim=0)
            gb_r[p] = torch.sum(common * vn_r * speed)
    return {"centers": g_c + gb_c, "radii": g_r + gb_r}


def _translate_mesh(scene: Scene, delta: Tensor,
                    mats: tuple | None = None) -> Scene:
    """The scene with the mesh (or the triangles of material ids ``mats``)
    rigidly translated by ``delta`` (3,), differentiably.

    The triangles (v0, tris_packed) and the TRI_LIGHT rows move by delta;
    the MeshData's node boxes are padded by max |delta| instead of moved,
    which keeps them conservative for a per-object translation and leaves
    them unchanged at delta = 0. A packed scene is packed again from that
    tree (``with_packet_mesh``: the 64-leaf tree of ``packet_ref``, kernel
    5's ``mesh_bvh`` and kernel 6's coarse tree, each from the translated
    triangles and the padded boxes), except at delta = 0, where the packs
    are the scene's own. The walks stay detached; gradients reach the
    hits through ``mesh.v0`` (``ops/intersect.py``)."""
    m = scene.mesh
    if mats is None:
        sel = torch.ones(m.v0.shape[0], dtype=m.v0.dtype, device=m.v0.device)
    else:
        sel = torch.zeros(m.v0.shape[0], dtype=m.v0.dtype,
                          device=m.v0.device)
        for mi in mats:
            sel = torch.where(m.material_id == mi, 1.0, sel)
    shift = sel[:, None] * delta
    pad = torch.max(torch.abs(delta.detach()))
    nodes = m.nodes_packed.clone()
    nodes[:, 0:3] -= pad
    nodes[:, 3:6] += pad
    mesh = dataclasses.replace(
        m, v0=m.v0 + shift,
        tris_packed=torch.cat([m.tris_packed[:, 0:3] + shift,
                               m.tris_packed[:, 3:]], dim=1),
        node_min=m.node_min - pad, node_max=m.node_max + pad,
        nodes_packed=nodes)
    out = dataclasses.replace(scene, mesh=mesh)
    if scene.tl_v0 is not None:
        on = [float(mats is None or int(lm) in mats)
              for lm in scene.light_mats]
        on += [0.0] * (scene.tl_v0.shape[0] - len(on))
        lsel = torch.tensor(on, dtype=delta.dtype, device=delta.device)
        out = dataclasses.replace(
            out, tl_v0=scene.tl_v0 + lsel[:, None, None] * delta)
    if scene.mesh_packed is not None and bool(torch.any(delta != 0)):
        flat = dataclasses.replace(mesh, **{
            f: getattr(mesh, f).detach() for f in ("v0", "tris_packed")})
        packed = with_packet_mesh(dataclasses.replace(out, mesh=flat),
                                  two_pass=scene.mesh_packed_coarse
                                  is not None)
        out = dataclasses.replace(
            out, mesh_packed=packed.mesh_packed,
            mesh_packed_coarse=packed.mesh_packed_coarse,
            mesh_bvh=packed.mesh_bvh)
    return out


def mesh_translation_grads(scene: Scene, cam: Camera, seed: int,
                           config: RenderConfig, d_loss_d_image: Tensor,
                           iteration: int = 0, objects: tuple | None = None,
                           draws: rng.Draws | None = None) -> Tensor:
    """d sum(d_loss_d_image * image) / d (rigid translation) at delta = 0,
    (3,), of the whole mesh or of the triangles of material ids
    ``objects``: the attached interior term (``attached_geom``), by one
    backward pass. Raises ValueError for a scene without a mesh."""
    if scene.mesh is None:
        raise ValueError("mesh_translation_grads: scene has no mesh")
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    delta = torch.zeros(3, dtype=torch.float32, device=scene.device,
                        requires_grad=True)
    with torch.enable_grad():
        img = render(_translate_mesh(scene, delta, objects), cam, seed,
                     dataclasses.replace(config, attached_geom=True),
                     iteration, draws)
        g, = grad_or_zeros(torch.sum(img * d_loss_d_image), (delta,))
    return g
