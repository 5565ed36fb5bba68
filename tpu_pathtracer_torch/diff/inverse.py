"""Inverse rendering: recover scene parameters by gradient descent.

Counterpart of the single-device kernel routes of
``tpu_pathtracer/diff/inverse.py`` (BASELINE config 5): optimize the
material colours and light intensities of a sphere or mesh scene, the
texture atlas of a textured mesh scene (``params_of`` includes
``textures`` when the scene has an atlas), and with ``params_of(scene,
ior=True)`` the index of refraction of its transmissive materials
(``mat_coef``; not with textures, as in the JAX package), to match a target
image. A mesh scene must come packed (``models.scene.with_packet_mesh``),
as in the JAX package. Each step is ONE launch of a fused value-and-grad
kernel, which returns the loss and the colour and intensity gradients from
a single path walk: with ``engine="persistent"`` (the default) the
persistent kernel (``ops/kernels/replay_persistent.py``), plus the scatter
launch for the atlas gradient on a textured scene (chunks of 32 samples
above spp 32); with ``engine="sample"`` the per-sample kernel
(``ops/kernels/replay_kernel.py``, lane = (pixel, sample), sphere scenes
only: a mesh scene raises ValueError, as in JAX), the JAX package's
cross-check oracle of the persistent one. With ``mat_coef`` one tangent
walk follows (``ops/kernels/camera_jvp.py::ior_mse_grad``), on either
engine; then one Adam update. ``torch.optim.Adam`` has optax's ``adam``
update (bias-corrected moments, eps outside the square root).

The gradient enters autograd through ``KernelMSE``: its forward launches
the kernels and saves the gradients, its backward scales them by the
incoming cotangent. A train step is ``loss.backward()``,
``optimizer.step()`` and the physical clamps under ``no_grad``.

The JAX package's other trainer, ``make_train_step`` over ``sharded_loss``
with a target from ``render_target``, differentiates the wavefront
(``models/integrator.py``) by autograd: slower than a fused launch, but it
takes every parameter the wavefront reads, so the atlas of any textured
scene (no packed mesh needed) and ``mat_coef`` on a textured scene train
there. The fused routes keep JAX's refusals (``_check_texture_rules``).

Not ported yet: device meshes (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import Tensor

from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.models.integrator import (
    RenderConfig, render, trace_pixels,
)
from tpu_pathtracer_torch.models.scene import Scene
from tpu_pathtracer_torch.ops.kernels import replay_kernel
from tpu_pathtracer_torch.ops.kernels.camera_jvp import ior_mse_grad
from tpu_pathtracer_torch.ops.kernels.replay_persistent import (
    default_budget, persistent_mse_value_and_grad, persistent_replay_call,
    pixel_lanes_layout, tex_route,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera
from tpu_pathtracer_torch.utils import rng
from tpu_pathtracer_torch.utils.errors import not_ported

ENGINES = ("persistent", "sample")
PARAMS = ("mat_color", "light_intensity")
TEX = "textures"  # the atlas, in params_of when the scene has one
IOR = "mat_coef"  # optional: the index of refraction, params_of(ior=True)


@dataclasses.dataclass
class TrainState:
    params: dict  # {"mat_color": (M, 3), "light_intensity": (L, 3)} leaves,
    # "textures": (K, TH, TW, 3) on a scene with an atlas, and "mat_coef":
    # (M,) when the IOR is optimized
    optimizer: torch.optim.Optimizer  # Adam over params' tensors
    step: int = 0


def _names(params: Mapping[str, Any]) -> tuple[str, ...]:
    """The parameter names present, in a fixed order."""
    return PARAMS + tuple(k for k in (TEX, IOR) if k in params)


def params_of(scene: Scene, *, ior: bool = False) -> dict:
    """The optimizable tables, as fresh leaf tensors (the scene's own are
    left untouched): with the texture atlas when the scene has one (as the
    JAX package does); ``ior`` adds ``mat_coef``, whose gradient comes from
    the tangent walk."""
    names = PARAMS + ((TEX,) if scene.textures is not None else ()) + (
        (IOR,) if ior else ())
    return {k: getattr(scene, k).detach().clone() for k in names}


def apply_params(scene: Scene, params: Mapping[str, Tensor]) -> Scene:
    """Clamp-free parameter injection into the frozen Scene."""
    return dataclasses.replace(scene, **{k: params[k] for k in _names(params)})


def clamp_params(params: Mapping[str, Tensor]) -> dict:
    """Physical clamps: albedo and texels in [0, 1], intensity >= 0,
    ior >= 1."""
    out = {"mat_color": torch.clamp(params["mat_color"], 0.0, 1.0),
           "light_intensity": torch.clamp_min(params["light_intensity"], 0.0)}
    if TEX in params:
        out[TEX] = torch.clamp(params[TEX], 0.0, 1.0)
    if IOR in params:
        out[IOR] = torch.clamp_min(params[IOR], 1.0)
    return out


def make_optimizer(lr: float = 2e-2) -> Callable[..., torch.optim.Adam]:
    """Adam at learning rate ``lr`` (optax.adam's update); ``init_state``
    builds it over the parameter tensors."""
    return functools.partial(torch.optim.Adam, lr=lr)


def init_state(scene: Scene, optimizer: Callable[..., torch.optim.Optimizer],
               init_params: Mapping[str, Tensor] | None = None) -> TrainState:
    params = dict(init_params) if init_params is not None \
        else params_of(scene)
    names = _names(params)
    params = {k: params[k].detach().clone().requires_grad_(True)
              for k in names}
    return TrainState(params=params,
                      optimizer=optimizer([params[k] for k in names]),
                      step=0)


def train_state_from_numpy(params: Mapping[str, np.ndarray],
                           adam: Mapping[str, Any] | None, step: int, *,
                           lr: float, device="cuda") -> TrainState:
    """Carry the JAX trainer's state across: ``params`` holds the two
    tables (and ``textures`` and ``mat_coef`` where the JAX trainer
    optimizes them), ``adam`` optax's Adam
    state as {"count": int, "mu": {name: array}, "nu": {name: array}} (None
    for a fresh optimizer), ``step`` the train-step counter. The moments
    become torch Adam's ``exp_avg`` and ``exp_avg_sq`` and ``count`` its
    per-parameter ``step``."""
    names = _names(params)
    state = init_state(
        None, make_optimizer(lr),
        {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
         for k in names})
    if adam is not None:
        for k in names:
            p = state.params[k]
            state.optimizer.state[p] = {
                "step": torch.tensor(float(adam["count"])),
                "exp_avg": torch.tensor(np.asarray(adam["mu"][k], np.float32),
                                        device=device),
                "exp_avg_sq": torch.tensor(
                    np.asarray(adam["nu"][k], np.float32), device=device),
            }
    state.step = int(step)
    return state


def train_state_to_numpy(state: TrainState
                         ) -> tuple[dict, dict | None, int]:
    """The inverse of ``train_state_from_numpy``: (params, adam, step) as
    numpy arrays, ``adam`` None before the first optimizer step."""
    names = _names(state.params)
    params = {k: state.params[k].detach().cpu().numpy() for k in names}
    st = [state.optimizer.state.get(state.params[k]) for k in names]
    if not all(st):
        return params, None, state.step
    adam = {"count": int(st[0]["step"]),
            "mu": {k: s["exp_avg"].cpu().numpy() for k, s in zip(names, st)},
            "nu": {k: s["exp_avg_sq"].cpu().numpy()
                   for k, s in zip(names, st)}}
    return params, adam, state.step


def _check_route(scene: Scene, mesh, engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None:
        raise not_ported("gradients sharded over a device mesh (mesh=)",
                         "15")
    if engine == "sample" and scene.mesh is not None:
        raise ValueError(
            "engine='sample' does not trace mesh geometry; use "
            "engine='persistent' (in-kernel BVH walk) for mesh scenes")
    if scene.mesh is not None and scene.mesh_packed is None:
        raise ValueError(
            "engine='persistent' walks the packed mesh in-kernel: pack it "
            "first with models.scene.with_packet_mesh(scene)")


def _check_texture_rules(scene_p: Scene, names, engine: str) -> None:
    """The JAX trainer's texture rules (``diff/inverse.py:397-428``):
    ``mat_coef`` is not differentiated on a textured scene, and
    ``textures`` only where the fused walk makes atlas gradients."""
    if IOR in names and scene_p.textures is not None:
        raise ValueError(
            "mat_coef gradients use the tangent kernel, which does not trace "
            "textured materials — drop 'textures'/'mat_coef' from params, "
            "use the wavefront trainer (diff.inverse.make_train_step) or the "
            "score path (diff.score.ior_value_and_grad)")
    if TEX in names and not tex_route(scene_p):
        raise ValueError(
            "params include 'textures' but the selected engine cannot "
            f"produce atlas gradients (engine={engine!r}, "
            f"mesh={'present' if scene_p.mesh is not None else 'absent'}): "
            "use engine='persistent' with a packed triangle mesh, or remove "
            "'textures' from params / use the wavefront trainer "
            "(diff.inverse.make_train_step)")


def _loss_and_grads(scene_p: Scene, camera: Camera, target: Tensor,
                    seed: Sequence[int], iteration: int, kw: dict,
                    ior: bool) -> tuple[Tensor, dict]:
    """The fused kernel's loss and colour and intensity gradients (the
    engine in ``kw``), and the atlas gradient on a textured mesh scene;
    with ``ior``, the ``mat_coef`` gradient from one tangent walk on the
    same seed and iteration (its own uniform block in test mode), its
    tile_rows 32 unless given, as in JAX."""
    kw = dict(kw)
    ior_uniforms = kw.pop("ior_uniforms", None)
    engine, tile_rows = kw.pop("engine"), kw.pop("tile_rows")
    budget = kw.pop("budget")
    if engine == "sample":
        loss, grads, _ = replay_kernel.mse_value_and_grad(
            scene_p, camera, seed, iteration, target,
            tile_rows=16 if tile_rows is None else tile_rows, **kw)
    else:
        loss, grads, _ = persistent_mse_value_and_grad(
            scene_p, camera, seed, iteration, target, budget=budget,
            tile_rows=32 if tile_rows is None else tile_rows, **kw)
    if ior:
        kw["uniforms"] = ior_uniforms
        grads[IOR] = ior_mse_grad(
            scene_p, camera, seed, target, iteration=iteration,
            budget=budget, tile_rows=32 if tile_rows is None else tile_rows,
            **kw)
    return loss, grads


class KernelMSE(torch.autograd.Function):
    """MSE loss of a fused kernel's render against a target, as a function
    of (mat_color, light_intensity) and, if given, mat_coef and the texture
    atlas. The forward launches the kernels of the engine in ``kw`` and
    saves the gradients (the colour and intensity ones already divided by
    the clamped parameters, the atlas one final); the backward scales them
    by the cotangent."""

    @staticmethod
    def forward(ctx, mat_color: Tensor, light_intensity: Tensor,
                scene: Scene, camera: Camera, target: Tensor,
                seed: Sequence[int], iteration: int, kw: dict,
                mat_coef: Tensor | None = None,
                textures: Tensor | None = None) -> Tensor:
        params = {"mat_color": mat_color.detach(),
                  "light_intensity": light_intensity.detach()}
        for k, v in ((IOR, mat_coef), (TEX, textures)):
            if v is not None:
                params[k] = v.detach()
        names = _names(params)
        scene_p = apply_params(scene, params)
        _check_texture_rules(scene_p, names, kw["engine"])
        loss, grads = _loss_and_grads(scene_p, camera, target, seed,
                                      iteration, kw, mat_coef is not None)
        ctx.names = names
        ctx.save_for_backward(*(grads[k] for k in names))
        return loss

    @staticmethod
    def backward(ctx, grad_output: Tensor):
        g = dict(zip(ctx.names,
                     (grad_output * x for x in ctx.saved_tensors)))
        return (g["mat_color"], g["light_intensity"], None, None, None, None,
                None, None, g.get(IOR), g.get(TEX))


def _kernel_kw(engine, spp, max_bounces, rr_start, tile_rows, use_nee,
               strat_k, budget, uniforms, ior_uniforms) -> dict:
    """The engine, its kernel's keywords (tile_rows None: each kernel's
    default) and the tangent walk's own uniform block."""
    return dict(engine=engine, spp=spp, budget=budget,
                max_bounces=max_bounces, rr_start=rr_start,
                tile_rows=tile_rows, use_nee=use_nee, strat_k=strat_k,
                uniforms=uniforms, ior_uniforms=ior_uniforms)


def kernel_loss_and_grads(
    params: Mapping[str, Tensor],
    scene: Scene,
    camera: Camera,
    target: Tensor,  # (H, W, 3)
    seed: Sequence[int],
    iteration: int,
    *,
    spp: int,
    max_bounces: int = 10,
    rr_start: int = 3,
    tile_rows: int | None = None,
    use_nee: bool = False,
    strat_k: int = 2,
    mesh=None,
    engine: str = "persistent",
    budget: int | None = None,
    uniforms: Tensor | None = None,
    ior_uniforms: Tensor | None = None,
) -> tuple[Tensor, dict]:
    """MSE loss and gradients w.r.t. ``params`` from one fused launch (and
    the scatter launch for ``textures``, the atlas gradient), and with
    ``mat_coef`` in ``params`` one tangent walk for its gradient on the
    same seed and iteration (``ior_mse_grad``). ``seed`` is ``(seed,
    salt)``; ``engine`` "persistent" (tile_rows 32 unless given) or
    "sample" (tile_rows 16 unless given; ``budget`` is the tangent walk's
    only); ``uniforms`` and ``ior_uniforms`` (test mode) are the JAX
    kernels' external uniform blocks of the two walks (at spp > 32 on a
    textured scene, ``uniforms`` is one block per chunk). Raises
    ValueError, as the JAX trainer does, for a mesh scene on the sample
    engine, for ``mat_coef`` on a textured scene and for ``textures``
    where no atlas gradient can be made."""
    _check_route(scene, mesh, engine)
    scene_p = apply_params(scene, params)
    _check_texture_rules(scene_p, _names(params), engine)
    return _loss_and_grads(
        scene_p, camera, target, seed, iteration,
        _kernel_kw(engine, spp, max_bounces, rr_start, tile_rows, use_nee,
                   strat_k, budget, uniforms, ior_uniforms), IOR in params)


def make_kernel_train_step(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    *,
    mesh=None,
    fixed_iteration: int | None = None,
    tile_rows: int | None = None,
    engine: str = "persistent",
    budget: int | None = None,
    uniforms: Tensor | None = None,
    ior_uniforms: Tensor | None = None,
) -> Callable[[TrainState, Tensor, Sequence[int]], tuple[TrainState, Tensor]]:
    """A train step over a fused kernel (``engine``, as in
    ``kernel_loss_and_grads``): one launch (loss and gradients; with the
    atlas a parameter, the scatter launch too), one tangent walk if
    ``mat_coef`` is a parameter, then the Adam update and the clamps. ``train_step(state, target, seed)`` updates ``state`` in
    place and returns it with the loss of the parameters it started from.
    The RNG frame is the step counter, or ``fixed_iteration`` for same-seed
    optimization (pass the iteration the target was rendered with: the loss
    is then exactly zero at the true parameters). The optimizer is the one
    ``state`` carries (JAX's ``optimizer`` argument has no counterpart
    here)."""
    _check_route(scene, mesh, engine)
    kw = _kernel_kw(engine, config.spp, config.max_bounces, config.rr_start,
                    tile_rows, config.use_nee, 2, budget, uniforms,
                    ior_uniforms)
    h, w = camera.height, camera.width

    def train_step(state: TrainState, target: Tensor, seed: Sequence[int]
                   ) -> tuple[TrainState, Tensor]:
        it = state.step if fixed_iteration is None else fixed_iteration
        state.optimizer.zero_grad(set_to_none=True)
        loss = KernelMSE.apply(
            state.params["mat_color"], state.params["light_intensity"],
            scene, camera, target.reshape(h, w, 3), seed, it, kw,
            state.params.get(IOR), state.params.get(TEX))
        loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            for k, v in clamp_params(state.params).items():
                state.params[k].copy_(v)
        state.step += 1
        return state, loss.detach()

    return train_step


def render_target_kernel(
    scene: Scene, camera: Camera, seed: Sequence[int], config: RenderConfig,
    *, iteration: int = 0, tile_rows: int | None = None,
    engine: str = "persistent", budget: int | None = None,
    uniforms: Tensor | None = None,
) -> Tensor:
    """(H*W, 3) target rendered by the fused kernel's own forward walk (no
    atlas gradient, so one launch on a textured scene too), for same-seed
    inverse rendering with ``make_kernel_train_step`` at the same fixed
    iteration and engine. ``engine="sample"`` launches the per-sample
    kernel in mode "vjp" with g = 0 and averages each pixel's samples (JAX
    ``diff/inverse.py:531-547``); a mesh scene raises ValueError there (the
    JAX function traces its spheres alone)."""
    _check_route(scene, None, engine)
    w, h = camera.width, camera.height
    if engine == "sample":
        tr = 16 if tile_rows is None else tile_rows
        rows_total, n_lanes = replay_kernel.lanes_layout(w, h, config.spp,
                                                         tr)
        aux0 = torch.zeros((rows_total, 128, 3), dtype=torch.float32,
                           device=scene.device)
        L_lanes, *_ = replay_kernel.replay_call(
            scene, pack_camera(camera), seed, iteration, aux0,
            spp=config.spp, width=w, height=h,
            max_bounces=config.max_bounces, rr_start=config.rr_start,
            use_nee=config.use_nee, use_dof=camera.use_dof, tile_rows=tr,
            mode="vjp", uniforms=uniforms)
        lanes = L_lanes.reshape(-1, 3)[:n_lanes]
        return lanes.reshape(h * w, config.spp, 3).mean(dim=1)
    tr = 32 if tile_rows is None else tile_rows
    rows_total, n_lanes = pixel_lanes_layout(w, h, tr)
    aux0 = torch.zeros((rows_total, 128, 3), dtype=torch.float32,
                       device=scene.device)
    L_lanes, ns, *_ = persistent_replay_call(
        scene, pack_camera(camera), seed, iteration, aux0, spp=config.spp,
        budget=default_budget(config.spp, config.max_bounces)
        if budget is None else budget,
        width=w, height=h, max_bounces=config.max_bounces,
        rr_start=config.rr_start, use_nee=config.use_nee,
        use_dof=camera.use_dof, tile_rows=tr, uniforms=uniforms,
        compute_tex_grad=False)
    lanes = L_lanes.reshape(-1, 3)[:n_lanes]
    n = torch.clamp_min(ns.reshape(-1)[:n_lanes], 1)[:, None]
    return lanes / n


# ---------------------------------------------------------------------------
# The wavefront trainer: autograd through models/integrator.py
# ---------------------------------------------------------------------------

def sharded_loss(params: Mapping[str, Tensor], scene: Scene, camera: Camera,
                 target: Tensor, seed: int, config: RenderConfig, mesh=None,
                 iteration: int = 0, draws: rng.Draws | None = None
                 ) -> Tensor:
    """Mean squared pixel error of the wavefront's render with ``params``
    against ``target`` (H*W, 3): the mean over each pixel's spp samples,
    then the mean over pixels and channels (the JAX function's loss; this
    port has one device, so ``mesh`` must be None). Differentiable in
    ``params`` by autograd. Draws are Philox keyed on (seed, iteration)
    unless ``draws`` is given."""
    if mesh is not None:
        raise not_ported("the loss sharded over a device mesh (mesh=)", "15")
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    n_pix = camera.height * camera.width
    lane_ids = torch.arange(n_pix * config.spp, dtype=torch.int32,
                            device=camera.device)
    rad = trace_pixels(apply_params(scene, params), camera, lane_ids, draws,
                       config)
    est = rad.reshape(n_pix, config.spp, 3).mean(dim=1)
    return torch.sum((est - target.reshape(n_pix, 3)) ** 2) / (n_pix * 3)


def make_train_step(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    mesh=None,
    *,
    fixed_iteration: int | None = None,
    draws: rng.Draws | None = None,
) -> Callable[[TrainState, Tensor, int], tuple[TrainState, Tensor]]:
    """A train step over the wavefront: ``sharded_loss``, its gradients by
    autograd (every bounce recomputed in the backward under
    ``config.remat``), the Adam update of the optimizer ``state`` carries
    and the clamps. ``train_step(state, target, seed)`` updates ``state``
    in place and returns it with the loss of the parameters it started
    from. The iteration is the step counter, or ``fixed_iteration`` for
    same-seed optimization (a target from ``render_target`` at that
    iteration, so the loss is zero at the true parameters); ``draws``
    replaces the Philox draws (tests). ``mesh`` must be None."""
    if mesh is not None:
        raise not_ported("the loss sharded over a device mesh (mesh=)", "15")

    def train_step(state: TrainState, target: Tensor, seed: int
                   ) -> tuple[TrainState, Tensor]:
        it = state.step if fixed_iteration is None else fixed_iteration
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = sharded_loss(state.params, scene, camera, target, seed,
                                config, None, it, draws)
            loss.backward()
        state.optimizer.step()
        with torch.no_grad():
            for k, v in clamp_params(state.params).items():
                state.params[k].copy_(v)
        state.step += 1
        return state, loss.detach()

    return train_step


@torch.no_grad()
def render_target(scene: Scene, camera: Camera, seed: int,
                  config: RenderConfig, n_iterations: int = 4,
                  base_iteration: int = 1000,
                  draws: rng.Draws | None = None) -> Tensor:
    """A (H*W, 3) target: the mean of ``n_iterations`` wavefront renders
    from ``base_iteration``. For same-seed inverse rendering pass
    ``n_iterations=1`` and ``base_iteration`` = the trainer's
    ``fixed_iteration``. ``draws`` (tests) replaces the Philox draws of
    every iteration."""
    acc = torch.zeros((camera.height * camera.width, 3), dtype=torch.float32,
                      device=camera.device)
    for it in range(n_iterations):
        acc += render(scene, camera, seed, config, base_iteration + it,
                      draws).reshape(-1, 3)
    return acc / n_iterations
