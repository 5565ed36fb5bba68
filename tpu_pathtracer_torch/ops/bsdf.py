"""BSDF evaluation and sampling with masked lane dispatch.

Counterpart of ``tpu_pathtracer/ops/bsdf.py`` (reference scene.h:177-221,
material.h:37-43): every lane computes the three lobes and keeps the one of
its material type. ``wo`` is the incoming direction pointing toward the
surface, ``wi`` the sampled outgoing one, ``n`` the outward normal.
"""
from __future__ import annotations

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import DIFFUSE, SPECULAR, TRANSMISSIVE
from tpu_pathtracer_torch.ops import optics, sampling, vecmath as vm

INV_PI = sampling.INV_PI


def _diffuse_support(wo: Tensor, wi: Tensor, n: Tensor) -> Tensor:
    """Directions the diffuse sampler produces: the +n hemisphere with the
    reference's wo.wi < 0 gate."""
    return (vm.dot(wi, n) > 0.0) & (vm.dot(wo, wi) < 0.0)


def f(mtype: Tensor, albedo: Tensor, wo: Tensor, wi: Tensor, n: Tensor
      ) -> Tensor:
    """BSDF value for a direction pair; only the diffuse lobe is non-zero."""
    sup = _diffuse_support(wo, wi, n)
    diffuse_f = albedo * INV_PI * sup[..., None]
    return torch.where((mtype == DIFFUSE)[..., None], diffuse_f, 0.0)


def pdf(mtype: Tensor, wo: Tensor, wi: Tensor, n: Tensor) -> Tensor:
    """Directional pdf of ``sample`` for the non-delta lobe."""
    sup = _diffuse_support(wo, wi, n)
    diffuse_pdf = torch.where(sup, vm.dot(wi, n) * INV_PI, 0.0)
    return torch.where(mtype == DIFFUSE, diffuse_pdf, 0.0)


def sample(mtype: Tensor, albedo: Tensor, coef: Tensor, wo: Tensor,
           n: Tensor, u1: Tensor, u2: Tensor
           ) -> tuple[Tensor, Tensor, Tensor]:
    """Importance-sample the BSDF: (f, wi, pdf). Diffuse: cosine hemisphere,
    pdf |wi.n|/pi gated on wo.wi < 0; specular: mirror, f = coef * colour,
    pdf 1; transmissive: Fresnel choice of reflection or refraction by u1,
    f = colour, pdf 1."""
    is_diffuse = mtype == DIFFUSE
    is_specular = mtype == SPECULAR
    is_transmissive = mtype == TRANSMISSIVE

    wi_d = sampling.cosine_sample_hemisphere(u1, u2, n)
    pdf_d = torch.where(vm.dot(wo, wi_d) < 0.0,
                        torch.abs(vm.dot(wi_d, n)) * INV_PI, 0.0)
    f_d = albedo * INV_PI

    wi_s = optics.reflect(wo, n)
    f_s = coef[..., None] * albedo

    entering = vm.dot(wo, n) < 0.0
    ior = torch.clamp_min(coef, 1.0)  # padding materials have coef 0
    one = torch.ones_like(ior)
    n1 = torch.where(entering, one, ior)
    n2 = torch.where(entering, ior, one)
    nnor = torch.where(entering[..., None], n, -n)
    refl = optics.fresnel_reflectance(wo, nnor, n1, n2)
    wi_t = torch.where((u1 < refl)[..., None], optics.reflect(wo, nnor),
                       optics.refract(wo, nnor, n1 / n2))
    f_t = albedo

    wi = torch.where(is_diffuse[..., None], wi_d,
                     torch.where(is_specular[..., None], wi_s, wi_t))
    f_val = torch.where(
        is_diffuse[..., None], f_d,
        torch.where(is_specular[..., None], f_s,
                    torch.where(is_transmissive[..., None], f_t, 0.0)))
    pdf_val = torch.where(
        is_diffuse, pdf_d,
        torch.where(is_specular | is_transmissive, 1.0, 0.0))
    return f_val, wi, pdf_val


def is_specular_type(mtype: Tensor) -> Tensor:
    """Delta lobes (no NEE, full MIS credit on the next emitter hit)."""
    return (mtype == SPECULAR) | (mtype == TRANSMISSIVE)
