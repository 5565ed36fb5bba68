"""Batched 3D vector math on trailing-dimension-3 tensors.

Counterpart of ``tpu_pathtracer/ops/vecmath.py``: every vector quantity is a
``(..., 3)`` float32 tensor. ``dot3`` and ``normalize3`` are the SoA forms the
kernels use, one tensor per component (``trace_kernel.py:89-95`` in the JAX
package).
"""
from __future__ import annotations

import torch
from torch import Tensor


def take(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx] along the first axis, by ``index_select``, whose backward
    adds the rows with ``index_add_``: advanced indexing's backward sorts
    the indices and sums each index's duplicates one after another, which
    on the card takes about a tenth of a second for a million lanes that
    gather from a handful of rows (the wavefront's material, light and
    sphere tables)."""
    flat = torch.index_select(table, 0, idx.reshape(-1))
    return flat.reshape(idx.shape + table.shape[1:])


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


def distance_sq(a: Tensor, b: Tensor) -> Tensor:
    return length_sq(a - b)


def distance(a: Tensor, b: Tensor) -> Tensor:
    return length(a - b)


def lerp(t: Tensor, v1: Tensor, v2: Tensor) -> Tensor:
    """(1-t)*v1 + t*v2 (reference globals.h:103-105)."""
    return (1.0 - t) * v1 + t * v2


def luminance(c: Tensor) -> Tensor:
    """Rec.601 luma (reference Color::Y)."""
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=c.dtype,
                     device=c.device)
    return torch.sum(c * w, dim=-1)


def max_component(c: Tensor) -> Tensor:
    """Max RGB component (drives Russian roulette)."""
    return torch.amax(c, dim=-1)


def is_black(c: Tensor, eps: float = 0.0) -> Tensor:
    """True where a colour has no contribution."""
    return torch.all(c <= eps, dim=-1)


def orthonormal_basis(n: Tensor) -> tuple[Tensor, Tensor]:
    """(u, v) completing unit normal n to a right-handed frame, with the
    JAX package's branch and a normalized tangent."""
    cond = (torch.abs(n[..., 0]) > torch.abs(n[..., 2]))[..., None]
    zero = torch.zeros_like(n[..., 0])
    u = torch.where(
        cond,
        torch.stack([-n[..., 1], n[..., 0], zero], dim=-1),
        torch.stack([zero, -n[..., 2], n[..., 1]], dim=-1),
    )
    u = normalize(u)
    return u, cross(n, u)


def to_world(local: Tensor, n: Tensor) -> Tensor:
    """Rotate a z-up local-frame vector into the frame around normal n."""
    u, v = orthonormal_basis(n)
    return u * local[..., 0:1] + v * local[..., 1:2] + n * local[..., 2:3]
