"""Path-replay backprop: gradients by re-tracing the paths.

Counterpart of ``tpu_pathtracer/diff/replay.py``. Every draw is a function
of (seed, iteration, stream, bounce, lane) (``utils/rng.py``), so the
backward pass walks the very same paths again instead of keeping per-bounce
intermediates: ``TraceReplay`` saves only its primal inputs and the per-lane
radiance ``L``.

The estimator is the detached-sampling one of ``models/integrator.py``:

    L = sum_b E_b,   E_b = T_b e_b,   T_b = prod_{k<b} w_k

Every BSDF factor w_k is linear in its material colour and every emission
in its light's intensity, so with suffix_k = L - prefix_k (the radiance
gathered at deeper vertices, Vicini et al.'s recurrence)

    dL/dA[m] = sum_k 1[m_k = m] (suffix_k + NEE_k) / A[m]
    dL/dI[l] = sum_b 1[light_b = l] T_b take_b  (+ NEE_b / I[l])

per channel. The adjoint divides by the table colour, not the textured
albedo (tex * A is linear in A), and a TRI_LIGHT emitter hit credits the
first TRI_LIGHT row that owns the hit material. The JAX package routes the
per-bounce adjoints with one-hot matrix products (its TPU has no fast
scatter); here they are ``index_add_`` into the (M, 3) and (NL, 3) tables.
On the card those sums are float atomics, so the gradients' last bits
change from run to run; on the CPU they are deterministic.

The same walk also carries ``diff/score.py``'s score-function term for the
index of refraction (``score=True``). The walk is plain PyTorch around the
mesh queries (kernel 5, and kernel 6 with the coarse tree, on the card).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from tpu_pathtracer_torch.models import integrator
from tpu_pathtracer_torch.models.integrator import RenderConfig
from tpu_pathtracer_torch.models.scene import (
    TRANSMISSIVE, TRI_LIGHT, Scene, prim_attrs,
)
from tpu_pathtracer_torch.ops import bsdf, optics
from tpu_pathtracer_torch.ops import vecmath as vm
from tpu_pathtracer_torch.ops.intersect import intersect
from tpu_pathtracer_torch.utils import rng


def fresnel_R_and_dR(coef: Tensor, wo: Tensor, n: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """Reflectance R of the transmissive lobe and dR / d coef, by a forward
    derivative of ``optics.fresnel_reflectance`` (entering test, ior clamp
    and total internal reflection as ``bsdf.sample``)."""
    entering = vm.dot(wo, n) < 0.0
    nnor = torch.where(entering[..., None], n, -n)

    def R_of(c):
        ior = torch.clamp_min(c, 1.0)
        one = torch.ones_like(ior)
        n1 = torch.where(entering, one, ior)
        n2 = torch.where(entering, ior, one)
        return optics.fresnel_reflectance(wo, nnor, n1, n2)

    return torch.func.jvp(R_of, (coef,), (torch.ones_like(coef),))


def grad_or_zeros(value: Tensor, inputs: tuple[Tensor, ...]
                  ) -> tuple[Tensor, ...]:
    """d value / d inputs by autograd, zeros for an input that ``value``
    does not depend on (``jax.grad``'s answer there)."""
    if not value.requires_grad:
        return tuple(torch.zeros_like(x) for x in inputs)
    gs = torch.autograd.grad(value, inputs, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, gs))


def _emit_light_ids(scene: Scene, hit, P: int) -> tuple[Tensor, Tensor]:
    """(light id, valid) of each lane's emitter hit: a sphere by its
    ``light_id``, a TRI_LIGHT triangle by the first TRI_LIGHT row that owns
    its material."""
    is_sphere = hit.prim < P
    lid = scene.light_id[torch.clamp(hit.prim, 0, P - 1)].to(torch.int64)
    valid = ~vm.is_black(hit.emission)
    if scene.has_tri_lights:
        is_tl = (scene.light_type == TRI_LIGHT) & scene.light_valid
        owns = (scene.light_mat[None, :] == hit.mat[:, None]) & is_tl[None, :]
        lid_tri = torch.argmax(owns.to(torch.int32), dim=1)
        lid = torch.where(is_sphere, lid, lid_tri)
        valid = valid & (is_sphere | torch.any(owns, dim=1))
    else:
        valid = valid & is_sphere
    return lid, valid & (lid >= 0)


@torch.no_grad()
def _walk(scene: Scene, o: Tensor, d: Tensor, lane_ids: Tensor,
          draws: rng.Draws, config: RenderConfig, *, adjoint: bool = False,
          score: bool = False, L_total: Tensor | None = None,
          g: Tensor | None = None):
    """One pass over the paths of rays (o, d), the integrator's estimator
    and draws. Returns the per-lane radiance (N, 3); with ``adjoint``, the
    gradients (mat_color (M, 3), light_intensity (NL, 3)) of sum(g * L)
    given the first pass's ``L_total``; with ``score``, the score-function
    part of d sum(g * L) / d mat_coef (M,) (``diff/score.py``)."""
    attrs = prim_attrs(scene)
    P = scene.centers.shape[0]
    M = scene.mat_color.shape[0]
    NL = scene.light_intensity.shape[0]
    n = o.shape[0]
    lids = lane_ids.to(torch.int32)
    L = torch.zeros_like(o)
    T = torch.ones_like(o)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    prev_delta = alive.clone()
    prev_pdf = torch.zeros(n, dtype=o.dtype, device=o.device)
    prev_o, wo = o, d
    park_d = torch.zeros_like(o)
    park_d[:, 2] = 1.0
    gA = torch.zeros((M, 3), dtype=o.dtype, device=o.device)
    gI = torch.zeros((NL, 3), dtype=o.dtype, device=o.device)
    gC = torch.zeros(M, dtype=o.dtype, device=o.device)
    for bounce in range(config.max_bounces + 1):
        hit = intersect(scene, attrs, prev_o, wo, tmin=config.tmin,
                        alive=alive)
        alive = alive & hit.hit
        u = rng.bounce_uniforms(draws, bounce, lids)

        take_le = alive & (vm.dot(hit.n, -wo) > 0.0)
        w_emit = integrator.emitter_weight(scene, hit, prev_o, wo, prev_pdf,
                                           prev_delta, config.use_nee)
        take = (take_le.to(T.dtype) * w_emit)[:, None]
        L = L + T * hit.emission * take
        if adjoint:
            lid, emit_ok = _emit_light_ids(scene, hit, P)
            gI.index_add_(0, torch.clamp(lid, 0, NL - 1),
                          g * T * take * emit_ok[:, None].to(T.dtype))

        nee_term = None
        if config.use_nee:
            nee, li = integrator.next_event(
                scene, hit, wo, alive, rng.light_uniforms(draws, bounce, lids),
                config)
            nee_term = T * nee
            L = L + nee_term
            if adjoint:
                # NEE is linear in the selected light's intensity
                I_l = scene.light_intensity[li]
                gI.index_add_(0, li,
                              g * nee_term / torch.clamp_min(I_l, 1e-8))

        wi, pdf, weight, contrib_ok = integrator.sample_bsdf(hit, wo, u,
                                                             config)
        step_ok = alive & contrib_ok
        mat = torch.clamp(hit.mat, 0, M - 1)
        if adjoint:
            # d w / d A = w / A for every lobe: the factor's adjoint is the
            # radiance it carries, the suffix, plus this vertex's NEE term
            part = (L_total - L) * step_ok[:, None].to(T.dtype)
            if nee_term is not None:
                part = part + nee_term * alive[:, None].to(T.dtype)
            gA.index_add_(0, mat, g * part / torch.clamp_min(
                scene.mat_color[mat], 1e-8))
        if score:
            # the reflect-or-refract choice u < R(ior) at a glass sphere:
            # d log p / d ior times the radiance gathered after it
            is_t = (hit.mtype == TRANSMISSIVE) & (hit.prim < P) & alive
            R, dR = fresnel_R_and_dR(hit.coef, wo, hit.n)
            s = torch.where(u[:, 0] < R, dR / torch.clamp_min(R, 1e-6),
                            -dR / torch.clamp_min(1.0 - R, 1e-6))
            s = torch.where(is_t, s, 0.0)
            gC.index_add_(0, mat, torch.sum(g * (L_total - L), dim=-1) * s)
        T = torch.where(step_ok[:, None], T * weight, T)
        T, rr_ok = integrator.roulette(T, step_ok, u, bounce, config)
        alive = step_ok & rr_ok & (bounce < config.max_bounces)
        prev_delta = bsdf.is_specular_type(hit.mtype)
        av = alive[:, None]
        prev_o = torch.where(av, hit.p, 0.0)
        wo = torch.where(av, wi, park_d)
        prev_pdf = pdf
    if score:
        return gC
    if adjoint:
        return gA, gI
    return L


class TraceReplay(torch.autograd.Function):
    """Per-lane radiance (N, 3) of rays (o, d), differentiable in
    (mat_color, light_intensity) by path replay (the JAX ``trace_replay``
    custom_vjp): the forward walks once and saves the primal inputs and L;
    the backward walks the same paths again with the suffix recurrence.
    The scene's own two tables are replaced by the first two arguments."""

    @staticmethod
    def forward(ctx, mat_color: Tensor, light_intensity: Tensor,
                scene: Scene, o: Tensor, d: Tensor, config: RenderConfig,
                lane_ids: Tensor, draws: rng.Draws) -> Tensor:
        s = dataclasses.replace(scene, mat_color=mat_color.detach(),
                                light_intensity=light_intensity.detach())
        L = _walk(s, o.detach(), d.detach(), lane_ids, draws, config)
        ctx.save_for_backward(mat_color, light_intensity, o, d, lane_ids, L)
        ctx.scene, ctx.config, ctx.draws = scene, config, draws
        return L

    @staticmethod
    def backward(ctx, g: Tensor):
        mat_color, light_intensity, o, d, lane_ids, L = ctx.saved_tensors
        s = dataclasses.replace(ctx.scene, mat_color=mat_color.detach(),
                                light_intensity=light_intensity.detach())
        gA, gI = _walk(s, o.detach(), d.detach(), lane_ids, ctx.draws,
                       ctx.config, adjoint=True, L_total=L,
                       g=g.contiguous())
        return gA, gI, None, None, None, None, None, None


# the JAX package's name: trace_replay(mat_color, light_intensity, scene, o,
# d, config, lane_ids, draws)
trace_replay = TraceReplay.apply


def primary_rays(camera, spp: int, draws: rng.Draws
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """(lane_ids, o, d) of every path sample of the image, as
    ``integrator.trace_pixels`` makes them (a lens camera's rays too)."""
    H, W = camera.height, camera.width
    lane_ids = torch.arange(H * W * spp, dtype=torch.int32,
                            device=camera.device)
    o, d = integrator.primary_rays(camera, lane_ids, draws, spp)
    return lane_ids, o, d


def render_replay(scene: Scene, camera, seed: int, config: RenderConfig,
                  iteration: int = 0, draws: rng.Draws | None = None
                  ) -> Tensor:
    """(H, W, 3) render whose gradients w.r.t. ``scene.mat_color`` and
    ``scene.light_intensity`` flow by path replay: a drop-in for
    ``integrator.render`` in inverse rendering. Draws are Philox keyed on
    (seed, iteration) unless ``draws`` is given."""
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    H, W, spp = camera.height, camera.width, config.spp
    lane_ids, o, d = primary_rays(camera, spp, draws)
    L = trace_replay(scene.mat_color, scene.light_intensity, scene, o, d,
                     config, lane_ids, draws)
    return L.reshape(H, W, spp, 3).mean(dim=2)
