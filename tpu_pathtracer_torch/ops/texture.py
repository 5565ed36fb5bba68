"""Texture sampling: bilinear lookup in a stacked texture atlas.

Counterpart of ``tpu_pathtracer/ops/texture.py``. Textures are one
``(K, TH, TW, 3)`` stack; a material names a texture (-1 = untextured), and
the sampled texel modulates the material's colour. A lookup is a four-tap
gather with wrap-around.
"""
from __future__ import annotations

import torch
from torch import Tensor

from tpu_pathtracer_torch.ops import vecmath as vm


def sample_bilinear(textures: Tensor, tex_id: Tensor, uv: Tensor) -> Tensor:
    """textures (K, TH, TW, 3); tex_id (N,); uv (N, 2), wrapped into [0, 1).
    Returns (N, 3); lanes with tex_id < 0 get 0."""
    K, TH, TW, _ = textures.shape
    flat = textures.reshape(-1, 3)

    u = uv[:, 0] % 1.0
    v = uv[:, 1] % 1.0
    x = u * TW - 0.5
    y = v * TH - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    k = torch.clamp(tex_id.to(torch.int64), 0, K - 1)

    def at(xi, yi):
        xi = torch.remainder(xi.to(torch.int64), TW)
        yi = torch.remainder(yi.to(torch.int64), TH)
        return vm.take(flat, (k * TH + yi) * TW + xi)

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return out * (tex_id >= 0)[:, None]
