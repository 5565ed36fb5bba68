"""Monte Carlo sampling routines, batched over lanes.

Counterpart of ``tpu_pathtracer/ops/sampling.py`` (reference
montecarlo.h:76-159): every region is computed and selected with
``torch.where``, as the JAX package does.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from tpu_pathtracer_torch.ops import vecmath as vm

PI = math.pi
INV_PI = 1.0 / math.pi


def concentric_sample_disk(u1: Tensor, u2: Tensor) -> tuple[Tensor, Tensor]:
    """Shirley's square-to-disk map (montecarlo.h:76-118)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0

    def safe_div(a, b):
        return a / torch.where(torch.abs(b) > 0.0, b, 1.0)

    in_r12 = sx >= -sy
    in_r1 = in_r12 & (sx > sy)
    in_r2 = in_r12 & ~in_r1
    in_r3 = ~in_r12 & (sx <= sy)
    in_r4 = ~in_r12 & ~(sx <= sy)

    r = torch.where(in_r1, sx, 0.0)
    r = torch.where(in_r2, sy, r)
    r = torch.where(in_r3, -sx, r)
    r = torch.where(in_r4, -sy, r)

    theta = torch.where(in_r1, safe_div(sy, sx), 0.0)
    theta = torch.where(in_r2, 2.0 - safe_div(sx, sy), theta)
    theta = torch.where(in_r3, 4.0 + safe_div(sy, sx), theta)
    theta = torch.where(in_r4, 6.0 - safe_div(sx, sy), theta)
    theta = theta * (PI / 4.0)

    degenerate = (sx == 0.0) & (sy == 0.0)
    dx = torch.where(degenerate, 0.0, r * torch.cos(theta))
    dy = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1: Tensor, u2: Tensor, n: Tensor) -> Tensor:
    """Cosine-weighted direction around normal n (pdf cos / pi)."""
    dx, dy = concentric_sample_disk(u1, u2)
    dz = vm.safe_sqrt(1.0 - dx * dx - dy * dy)
    local = torch.stack([dx, dy, dz], dim=-1)
    return vm.normalize(vm.to_world(local, n))


def uniform_sample_sphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform direction on the unit sphere (montecarlo.h:135-142)."""
    z = 1.0 - 2.0 * u1
    r = vm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_cone(u1: Tensor, u2: Tensor, cos_theta_max: Tensor,
                        x: Tensor, y: Tensor, z: Tensor) -> Tensor:
    """Uniform direction in the cone of half-angle acos(cos_theta_max)
    around z, in the frame (x, y, z) (montecarlo.h:144-150)."""
    cos_t = vm.lerp(u1, cos_theta_max, torch.ones_like(cos_theta_max))
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2
    return (x * (torch.cos(phi) * sin_t)[..., None]
            + y * (torch.sin(phi) * sin_t)[..., None]
            + z * cos_t[..., None])


def uniform_cone_pdf(cos_theta_max: Tensor) -> Tensor:
    """Solid-angle pdf of the uniform cone (montecarlo.h:152-154)."""
    return 1.0 / (2.0 * PI * torch.clamp_min(1.0 - cos_theta_max, 1e-12))


def make_distribution_1d(weights: Tensor) -> tuple[Tensor, Tensor]:
    """(cdf, pdf) of nonnegative weights, cdf[0] = 0; all-zero weights give
    the uniform distribution (montecarlo.h:28-74)."""
    w = torch.clamp_min(weights, 0.0)
    total = torch.sum(w)
    n = w.shape[0]
    uniform = torch.full((n,), 1.0 / n, dtype=w.dtype, device=w.device)
    pdf = torch.where(total > 0.0,
                      w / torch.where(total > 0.0, total, 1.0), uniform)
    cdf = torch.cat([torch.zeros(1, dtype=w.dtype, device=w.device),
                     torch.cumsum(pdf, 0)])
    return cdf, pdf


def sample_distribution_1d(cdf: Tensor, pdf: Tensor, u: Tensor
                           ) -> tuple[Tensor, Tensor]:
    """(index, pdf[index]) per uniform: the count of cdf[k+1] <= u, clamped
    (montecarlo.h:59-64)."""
    n = pdf.shape[0]
    idx = torch.sum((cdf[1:][None, :] <= u[..., None]).to(torch.int64),
                    dim=-1)
    idx = torch.clamp(idx, 0, n - 1)
    return idx, pdf[idx]


def power_heuristic(nf, f_pdf: Tensor, ng, g_pdf: Tensor) -> Tensor:
    """Beta = 2 power heuristic for MIS (montecarlo.h:156-159)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0,
                       f * f / torch.where(denom > 0.0, denom, 1.0), 0.0)


def stratified_jitter_for_sample(u: Tensor, v: Tensor, s: Tensor, spp: int
                                 ) -> tuple[Tensor, Tensor]:
    """Sub-pixel offsets in [-0.5, 0.5]: for spp = k*k > 1 sample s jitters
    inside cell s of a k x k grid, else around the centre."""
    k = int(round(spp ** 0.5))
    if k * k == spp and k > 1:
        cx = (s % k).to(u.dtype)
        cy = (s // k).to(u.dtype)
        return (cx + u) / k - 0.5, (cy + v) / k - 0.5
    return u - 0.5, v - 0.5
