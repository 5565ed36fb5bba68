"""Geometric optics: mirror reflection, Snell refraction, Fresnel.

Counterpart of ``tpu_pathtracer/ops/optics.py`` (reference globals.h:107-126):
batched over ``(..., 3)`` tensors, with no NaN under total internal
reflection.
"""
from __future__ import annotations

import torch
from torch import Tensor

from tpu_pathtracer_torch.ops import vecmath as vm


def reflect(wo: Tensor, n: Tensor) -> Tensor:
    """Mirror reflection of wo (pointing toward the surface) about n."""
    return wo - 2.0 * vm.dot(wo, n)[..., None] * n


def refract(wo: Tensor, n: Tensor, eta: Tensor) -> Tensor:
    """Snell refraction of wo through an interface of relative IOR eta =
    n1/n2; the radicand is clamped under TIR (Fresnel routes those lanes to
    ``reflect``)."""
    cos_i = vm.dot(wo, n)
    cos2_t = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    cos_t = vm.safe_sqrt(cos2_t)
    return vm.normalize(wo * eta[..., None] - (eta * cos_i + cos_t)[..., None]
                        * n)


def fresnel_reflectance(inc: Tensor, nor: Tensor, n1: Tensor, n2: Tensor
                        ) -> Tensor:
    """Unpolarized dielectric Fresnel reflectance, 1 under TIR. ``inc``
    points toward the surface; ``nor`` is the incident-side normal."""
    n = n1 / n2
    cos_i = -vm.dot(nor, inc)
    sin2_t = n * n * (1.0 - cos_i * cos_i)
    cos_t = vm.safe_sqrt(1.0 - sin2_t)
    r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
    r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
    refl = 0.5 * (r_orth * r_orth + r_par * r_par)
    return torch.where(sin2_t > 1.0, 1.0, refl)
