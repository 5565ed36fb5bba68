"""Index-of-refraction gradients: attached autodiff plus a score function.

Counterpart of ``tpu_pathtracer/diff/score.py``. The IOR enters the
transport in two ways:

1. continuously, through the refracted direction (Snell): with
   ``detach_sampling=False`` autograd carries d wi / d ior through the
   rest of the path (edge-free integrands, as for the camera pose);
2. discretely, through the reflect-or-refract choice u < R(ior): the
   closed-form weight cancels R, so only the choice's probability depends
   on it, the score-function (REINFORCE) case.

    dL/dior = E[dL/dior | choices fixed]                      (attached)
            + E[sum_b suffix_b d log p(c_b) / dior]           (score)

with d log p / dior = R'/R after a reflection and -R'/(1 - R) after a
refraction, and suffix_b the radiance gathered after the choice at b,
L_total - prefix (``diff/replay.py``'s recurrence). R' is a forward
derivative of ``optics.fresnel_reflectance``. The score part replays the
same paths through ``replay._walk``, given the attached pass's per-lane
radiance as L_total. Under NEE the score factor is unchanged (dielectrics
take no NEE and MIS weights through delta lobes are 1); only the prefix
tracks the NEE terms.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from tpu_pathtracer_torch.diff import replay
from tpu_pathtracer_torch.models.integrator import RenderConfig, trace
from tpu_pathtracer_torch.models.scene import Scene
from tpu_pathtracer_torch.utils import rng


def ior_value_and_grad(scene: Scene, camera, seed: int, config: RenderConfig,
                       weights: Tensor, iteration: int = 0,
                       draws: rng.Draws | None = None
                       ) -> tuple[Tensor, Tensor]:
    """sum(weights * image) and its gradient w.r.t. ``scene.mat_coef``
    (M,), ``weights`` the (H, W, 3) adjoint image (e.g. dLoss/dpixel): the
    attached part by autograd of the wavefront with
    ``detach_sampling=False``, the score part by one replay walk of the
    same paths, in either transport mode. Draws are Philox keyed on
    (seed, iteration) unless ``draws`` is given."""
    if draws is None:
        draws = rng.philox_draws(seed, iteration)
    H, W, spp = camera.height, camera.width, config.spp
    config = dataclasses.replace(config, count_rays=False)
    lane_ids, o, d = replay.primary_rays(camera, spp, draws)
    coef = scene.mat_coef.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        lanes = trace(dataclasses.replace(scene, mat_coef=coef), o, d,
                      lane_ids, draws,
                      dataclasses.replace(config, detach_sampling=False))
        img = lanes.reshape(H, W, spp, 3).mean(dim=2)
        value = torch.sum(weights * img)
        g_att, = replay.grad_or_zeros(value, (coef,))

    g_lanes = torch.repeat_interleave(weights.reshape(-1, 3), spp, 0) / spp
    g_score = replay._walk(scene, o, d, lane_ids, draws, config, score=True,
                           L_total=lanes.detach(), g=g_lanes)
    return value.detach(), g_att + g_score
