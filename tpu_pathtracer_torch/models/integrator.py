"""Wavefront path-tracing integrator and render settings.

Counterpart of ``tpu_pathtracer/models/integrator.py``: all paths of a frame
advance in lockstep, one bounce per step of a Python loop, with liveness as
a lane mask. Each step traces the segment the previous one produced
(intersect first), so a frame makes ``max_bounces + 1`` scene queries, each
one closest-hit wave and, with NEE, one shadow wave. On the card a packed
mesh turns every wave into one launch of the packet kernel (kernel 5) and,
with the coarse tree, one of the bin kernel (kernel 6); the rest of the
wavefront is plain PyTorch, as it is XLA in the JAX package.

Per bounce, as the reference integrator (pathtracer.cu:112-170): emitter
hits add T Le (with NEE, MIS-weighted by the power heuristic against the
light sampler's pdf, TRI_LIGHT hits by their solid-angle pdf); NEE adds the
light sample's contribution behind a shadow wave; the BSDF is sampled and T
updated by its closed-form weight; Russian roulette after ``rr_start``.

Draws come from ``utils/rng.py`` keyed on global lane ids, so the
bounce-level sort of a packet-mesh scene without a coarse tree is invisible
to the estimate: lanes carry their ids and positions and the radiance is
scattered back by position once at the end.

``trace`` and ``render`` run under autograd, the estimator of the JAX
package's ``jax.grad``: gradients reach the material, light and texture
tables, the sphere centres and radii and the mesh vertices through the
hits. ``detach_sampling`` detaches the sampled direction and its pdf; the
Russian-roulette probability, the TRI_LIGHT MIS pdf and the MIS pdf carried
to the next bounce are detached always, as in JAX. ``attached_geom`` keeps
the diffuse cosine attached as cos / sg(cos) (the primal is unchanged).
Every mesh query stays detached (kernel 5 on the card, ``packet_ref`` on the
CPU); where a gradient can reach a mesh hit, its t and uv are evaluated once
more from the winning triangle (``ops/intersect.py``), which is the
derivative the JAX package's JVP through its traversal yields. A masked
branch whose partials are infinite at degenerate lanes takes a safe input
(the "double where"), never a multiply by zero, so no NaN reaches the
backward. The forward renderers (``render_image``, ``models/progressive``,
``cli render``) run under ``torch.no_grad()`` and build no graph.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from tpu_pathtracer_torch.models import camera as cam_mod
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.models.scene import EPSILON, Scene, prim_attrs
from tpu_pathtracer_torch.ops import bsdf, lights, sampling
from tpu_pathtracer_torch.ops import vecmath as vm
from tpu_pathtracer_torch.ops.intersect import intersect, intersect_p
from tpu_pathtracer_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's #defines and ctor args)."""

    spp: int = 4
    max_bounces: int = 10
    rr_start: int = 3
    tmin: float = EPSILON
    # Detach the sampled direction and its pdf from the autograd graph (the
    # detached-sampling estimator).
    detach_sampling: bool = True
    use_nee: bool = False
    # Under autograd, recompute each bounce in the backward instead of
    # keeping its intermediates (torch.utils.checkpoint).
    remat: bool = True
    count_rays: bool = False
    # Packet-mesh scenes without a coarse tree: the shadow wave sorts on
    # its own key instead of riding the bounce-level order.
    shadow_self_sort: bool = True
    # Keep the diffuse cosine attached as cos / sg(cos) (primal-identical):
    # the geometry gradients' interior term needs the normal's dependence.
    attached_geom: bool = False


def _permute(perm: Tensor, *arrays: Tensor) -> list[Tensor]:
    """One packed row gather for the whole carry: floats as columns, ints
    and bools bit-cast or cast to float32 (exact)."""
    cols, split = [], []
    for a in arrays:
        if a.dtype == torch.int32:
            c = a.view(torch.float32)[:, None]
        elif a.dtype == torch.bool:
            c = a.to(torch.float32)[:, None]
        else:
            c = a if a.ndim == 2 else a[:, None]
        cols.append(c)
        split.append(c.shape[1])
    packed = torch.cat(cols, dim=1)[perm]
    out = []
    for a, part in zip(arrays, torch.split(packed, split, dim=1)):
        if a.dtype == torch.int32:
            out.append(part[:, 0].detach().contiguous().view(torch.int32))
        elif a.dtype == torch.bool:
            out.append(part[:, 0] > 0.5)
        else:
            out.append(part if a.ndim == 2 else part[:, 0])
    return out


def _bounce(scene: Scene, attrs, draws: rng.Draws, config: RenderConfig,
            bounce: int, do_sort: bool, presorted: bool, park_d: Tensor, L,
            T, alive, prev_o, wo, prev_pdf, prev_delta, lids, pos):
    """One bounce of the wavefront: trace the segment (prev_o, wo), shade
    the hits and sample the next segment. Returns the new carry and the
    segments traced (the JAX scan body, ``integrator.py:129-326``)."""
    if do_sort:
        # bounce 0 is in raster order, already coherent
        from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
            packet_sort_key,
        )

        perm = torch.argsort(packet_sort_key(prev_o, wo, alive=alive),
                             stable=True)
        (L, T, prev_o, wo, alive, prev_pdf, prev_delta, lids,
         pos) = _permute(perm, L, T, prev_o, wo, alive, prev_pdf,
                         prev_delta, lids, pos)
    hit = intersect(scene, attrs, prev_o, wo, tmin=config.tmin,
                    alive=alive, presorted=presorted)
    live = torch.sum(alive.to(torch.int64))
    alive = alive & hit.hit
    u = rng.bounce_uniforms(draws, bounce, lids)

    # emitter hit
    take_le = alive & (vm.dot(hit.n, -wo) > 0.0)
    w_emit = emitter_weight(scene, hit, prev_o, wo, prev_pdf, prev_delta,
                            config.use_nee)
    L = L + T * hit.emission * (take_le.to(T.dtype) * w_emit)[:, None]
    if config.use_nee:
        nee, _ = next_event(scene, hit, wo, alive,
                            rng.light_uniforms(draws, bounce, lids), config,
                            presorted)
        L = L + T * nee

    wi, pdf, weight, contrib_ok = sample_bsdf(hit, wo, u, config)
    step_ok = alive & contrib_ok
    T = torch.where(step_ok[:, None], T * weight, T)
    T, rr_ok = roulette(T, step_ok, u, bounce, config)

    # termination; dead lanes park on a fixed finite ray
    alive = step_ok & rr_ok & (bounce < config.max_bounces)
    prev_delta = bsdf.is_specular_type(hit.mtype)
    av = alive[:, None]
    prev_o = torch.where(av, hit.p, 0.0)
    wo = torch.where(av, wi, park_d)
    # the MIS state's pdf is a sampling quantity: detached in the carry
    return (L, T, alive, prev_o, wo, pdf.detach(), prev_delta, lids,
            pos), live


def emitter_weight(scene: Scene, hit, prev_o: Tensor, wo: Tensor,
                   prev_pdf: Tensor, prev_delta: Tensor, use_nee: bool
                   ) -> Tensor:
    """(N,) MIS weight of the emitter each lane hit: 1 without NEE or after
    a delta lobe, else the power heuristic of the BSDF pdf that produced
    the hit against the light sampler's pdf for it (TRI_LIGHT hits by
    their solid-angle pdf, detached: a sampling pdf)."""
    if not use_nee:
        return torch.ones_like(prev_pdf)
    is_light = ~vm.is_black(hit.emission)
    lp = lights.light_dir_pdf(scene, prev_o, wo, hit.center, hit.radius,
                              is_light, hit_prim=hit.prim)
    if scene.has_tri_lights:
        is_tri_hit = hit.prim >= scene.centers.shape[0]
        fac = lights.tri_sel_over_area_by_mat(scene)[
            torch.clamp(hit.mat, 0, scene.mat_color.shape[0] - 1)]
        tt = torch.clamp_max(hit.t, 1e6)
        cos_l = torch.abs(vm.dot(hit.n, wo))
        lp_tri = tt * tt / torch.clamp_min(cos_l, 1e-9) * fac
        lp = torch.where(is_tri_hit, lp_tri.detach(), lp)
    return torch.where(prev_delta, 1.0,
                       sampling.power_heuristic(1.0, prev_pdf, 1.0, lp))


def next_event(scene: Scene, hit, wo: Tensor, alive: Tensor, ul: Tensor,
               config: RenderConfig, presorted: bool = False
               ) -> tuple[Tensor, Tensor]:
    """One light sample per live lane behind a shadow wave: (its radiance
    per unit throughput (N, 3), zero where the sample does not count; the
    sampled light's index (N,))."""
    ls = lights.sample_lights(scene, hit.p, ul, tmin=config.tmin)
    f_l = bsdf.f(hit.mtype, hit.albedo, wo, ls.wi, hit.n)
    pdf_b = bsdf.pdf(hit.mtype, wo, ls.wi, hit.n)
    # a tight shrink of the visibility segment: excludes the light surface,
    # keeps occluders that hug it
    vis_tmax = ls.dist * (1.0 - 1e-3) - EPSILON
    occluded = intersect_p(
        scene, hit.p, ls.wi, tmin=config.tmin, tmax=vis_tmax,
        mask=alive & ls.valid,
        presorted=presorted and not config.shadow_self_sort)
    w_l = torch.where(ls.is_delta, 1.0,
                      sampling.power_heuristic(1.0, ls.pdf, 1.0, pdf_b))
    cos_l = torch.abs(vm.dot(ls.wi, hit.n))
    take_nee = alive & ls.valid & ~occluded
    contrib = f_l * ls.radiance * torch.where(
        ls.pdf > 0.0, cos_l * w_l / torch.where(ls.pdf > 0.0, ls.pdf, 1.0),
        0.0)[:, None]
    return contrib * take_nee[:, None].to(contrib.dtype), ls.index


def sample_bsdf(hit, wo: Tensor, u: Tensor, config: RenderConfig
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Sample each lane's BSDF: (wi, pdf, the closed-form weight f |wi.n| /
    pdf per lobe, whether the sample carries light). ``detach_sampling``
    detaches wi and pdf; ``attached_geom`` keeps the diffuse cosine
    attached as cos / sg(cos) (the primal ratio is exactly 1, the gradient
    carries d cos(wi, n) / d geometry)."""
    f_val, wi, pdf = bsdf.sample(hit.mtype, hit.albedo, hit.coef, wo, hit.n,
                                 u[:, 0], u[:, 1])
    if config.detach_sampling:
        wi, pdf = wi.detach(), pdf.detach()
    contrib_ok = ~vm.is_black(f_val) & (pdf > 0.0)
    cos_wi = torch.abs(vm.dot(wi, hit.n))
    diff_w = hit.albedo
    if config.attached_geom:
        c0 = cos_wi.detach()
        diff_w = hit.albedo * torch.where(
            c0 > 1e-6, cos_wi / torch.clamp_min(c0, 1e-6), 1.0)[:, None]
    weight = torch.where(bsdf.is_specular_type(hit.mtype)[:, None],
                         f_val * cos_wi[:, None], diff_w)
    return wi, pdf, weight, contrib_ok


def roulette(T: Tensor, step_ok: Tensor, u: Tensor, bounce: int,
             config: RenderConfig) -> tuple[Tensor, Tensor]:
    """Russian roulette after ``rr_start``: (T boosted by 1 / p on the
    lanes that survive, whether each lane goes on). The probability is
    detached always: a discrete decision's parameter, and an attached 1 / p
    leaks inf into the backward."""
    do_rr = bounce > config.rr_start
    p_cont = torch.clamp_max(vm.max_component(T), 0.5).detach()
    survive = u[:, 2] <= p_cont
    boost = step_ok & do_rr & survive & (p_cont > 0.0)
    T = torch.where(boost[:, None],
                    T / torch.clamp_min(p_cont, 1e-20)[:, None], T)
    return T, (survive if do_rr else torch.ones_like(survive))


def trace(scene: Scene, o: Tensor, d: Tensor, lane_ids: Tensor,
          draws: rng.Draws, config: RenderConfig):
    """Radiance along N rays (o, d: (N, 3)); ``lane_ids`` (N,) int32 are the
    global path-sample ids that key the draws. Returns (N, 3), and with
    ``config.count_rays`` also the closest-hit segments traced, primaries
    included (the JAX package's count).

    Differentiable under autograd as the JAX function is under ``jax.grad``
    (module docstring); ``config.remat`` with grad mode on runs each bounce
    under ``torch.utils.checkpoint``, so the backward traces every wave a
    second time."""
    attrs = prim_attrs(scene)
    bounce_sort = (scene.mesh_packed is not None
                   and scene.mesh_packed_coarse is None)
    remat = config.remat and torch.is_grad_enabled()
    n = o.shape[0]
    L = torch.zeros_like(o)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    carry = (L, torch.ones_like(o), alive, o, d,
             torch.zeros(n, dtype=o.dtype, device=o.device), alive.clone(),
             lane_ids.to(torch.int32),
             torch.arange(n, dtype=torch.int32, device=o.device))
    park_d = torch.zeros_like(o)
    park_d[:, 2] = 1.0
    live_counts = []
    for bounce in range(config.max_bounces + 1):
        args = (scene, attrs, draws, config, bounce,
                bounce_sort and bounce > 0, bounce_sort, park_d) + carry
        if remat:
            carry, live = checkpoint(_bounce, *args, use_reentrant=False)
        else:
            carry, live = _bounce(*args)
        live_counts.append(live)
    L, pos = carry[0], carry[-1]
    if bounce_sort:
        L = torch.empty_like(L).index_copy(0, pos.to(torch.int64), L)
    if config.count_rays:
        return L, torch.stack(live_counts).sum()
    return L


def primary_rays(camera: Camera, lane_ids: Tensor, draws: rng.Draws,
                 spp: int) -> tuple[Tensor, Tensor]:
    """Primary rays (o, d) of the given lanes (lane = (py * W + px) * spp +
    s). A lens camera draws its two lens uniforms from ``LENS_STREAM``
    (JAX ``integrator.py:419-422``)."""
    W = camera.width
    s = lane_ids % spp
    pix = lane_ids // spp
    px = pix % W
    py = pix // W
    u = rng.camera_uniforms(draws, lane_ids)
    ox, oy = sampling.stratified_jitter_for_sample(u[:, 0], u[:, 1], s, spp)
    if camera.use_dof:
        lu = rng.lens_uniforms(draws, lane_ids)
        o, d = cam_mod.generate_rays(camera, px, py, ox, oy, lu[:, 0],
                                     lu[:, 1])
    else:
        o, d = cam_mod.generate_rays(camera, px, py, ox, oy)
    return o.contiguous(), d


def trace_pixels(scene: Scene, camera: Camera, lane_ids: Tensor,
                 draws: rng.Draws, config: RenderConfig):
    """The given lanes' primary rays (``primary_rays``), traced."""
    o, d = primary_rays(camera, lane_ids, draws, config.spp)
    return trace(scene, o, d, lane_ids, draws, config)


def render(scene: Scene, camera: Camera, seed: int, config: RenderConfig,
           iteration: int = 0, draws: rng.Draws | None = None):
    """One progressive iteration: (H, W, 3) mean radiance over spp. Draws
    are Philox keyed on (seed, iteration) unless ``draws`` is given."""
    H, W, spp = camera.height, camera.width, config.spp
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    lane_ids = torch.arange(H * W * spp, dtype=torch.int32,
                            device=camera.device)
    out = trace_pixels(scene, camera, lane_ids, draws, config)
    if config.count_rays:
        radiance, n_rays = out
        return radiance.reshape(H, W, spp, 3).mean(dim=2), n_rays
    return out.reshape(H, W, spp, 3).mean(dim=2)


@torch.no_grad()
def render_image(scene: Scene, camera: Camera, seed: int,
                 config: RenderConfig, iteration: int = 0,
                 draws: rng.Draws | None = None):
    """Single-iteration render (the JAX package's jitted entry point), with
    no autograd graph: ``render`` is the differentiable one."""
    return render(scene, camera, seed, config, iteration, draws)
