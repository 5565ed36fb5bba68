"""Batched 3D vector math on trailing-dimension-3 tensors.

Counterpart of ``tpu_pathtracer/ops/vecmath.py``: every vector quantity is a
``(..., 3)`` float32 tensor. ``dot3`` and ``normalize3`` are the SoA forms the
kernels use, one tensor per component (``trace_kernel.py:89-95`` in the JAX
package).
"""
from __future__ import annotations

import torch
from torch import Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product over the trailing axis. (...,3),(...,3) -> (...,)."""
    return torch.sum(a * b, dim=-1)


def cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(a: Tensor) -> Tensor:
    return torch.sum(a * a, dim=-1)


def safe_sqrt(x: Tensor) -> Tensor:
    """sqrt clamped at zero (the JAX version also keeps its gradient finite)."""
    return torch.where(x > 0.0, torch.sqrt(torch.where(x > 0.0, x, 1.0)), 0.0)


def length(a: Tensor) -> Tensor:
    return safe_sqrt(length_sq(a))


def normalize(a: Tensor, eps: float = 1e-20) -> Tensor:
    """Unit vector along a; 0 for (near-)zero input instead of NaN."""
    sq = length_sq(a)[..., None]
    inv = torch.where(sq > eps, torch.rsqrt(torch.where(sq > eps, sq, 1.0)),
                      0.0)
    return a * inv


def dot3(ax, ay, az, bx, by, bz):
    """SoA dot product, summed left to right as the kernels do."""
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z):
    """SoA normalize through rsqrt with the kernels' 1e-20 clamp."""
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv
