"""Per-lane random streams of the wavefront integrator.

Counterpart of ``tpu_pathtracer/utils/rng.py``, with the same stream layout:
every uniform is a function of (seed, iteration, stream, bounce, global lane
id) alone, so sorting, sharding or batching lanes never changes a value.

* ``CAMERA_STREAM``: 2 uniforms per path sample (sub-pixel jitter);
* ``BOUNCE_STREAM``, per bounce: 3 (bsdf u, bsdf v, russian roulette);
* ``LIGHT_STREAM``, per bounce: 3 for NEE (light u, light v, select);
* ``LENS_STREAM``: 2 per path sample for thin-lens DOF (lens cameras);
* ``EDGE_STREAM``: 1 per sphere, keyed on its prim index, the offset of
  ``diff/geometry.py``'s stratified silhouette angles (the JAX package
  folds the prim index into its own key).

The JAX package derives them from threefry keys by ``fold_in``; the port
draws Philox4x32-10 (``ops/kernels/persistent.py::philox4x32``) keyed on
(seed, iteration) and countered on (global lane id, bounce, stream,
``STREAM_TAG``), the same bits on the CPU and on the card. A ``Draws`` is
any callable ``(stream, bounce, lane_ids, n) -> (N, n)``: ``philox_draws``
in production, ``TableDraws`` to replay given uniforms (the tests fill it
with the JAX package's draws).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import Tensor

from tpu_pathtracer_torch.ops.kernels.persistent import (
    bits_to_uniform, philox4x32,
)

CAMERA_STREAM = 0
BOUNCE_STREAM = 1
LIGHT_STREAM = 2
LENS_STREAM = 3
EDGE_STREAM = 4
# Philox stream tags, the high half of the counter's last word (the kernels'
# list is csrc/pt_common.cuh's STREAM_*): 0 the persistent forward kernel,
# 0x10000 the persistent gradient kernel, 0x20000 the tangent kernel,
# 0x30000 the wavefront's draws here, 0x40000 the per-sample forward kernel
# (ops/kernels/trace_kernel.py) and 0x50000 the per-sample gradient kernel
# (ops/kernels/replay_kernel.py).
STREAM_TAG = 0x30000

Draws = Callable[[int, int, Tensor, int], Tensor]


def philox_draws(seed: int, iteration: int) -> Draws:
    """Production draws of one iteration (frame)."""

    def draw(stream: int, bounce: int, lane_ids: Tensor, n: int) -> Tensor:
        if n > 4:
            raise ValueError(f"a stream draws at most 4 uniforms, not {n}")
        lane = lane_ids.to(torch.int64) & 0xFFFFFFFF
        words = philox4x32(lane, int(bounce), int(stream), STREAM_TAG,
                           int(seed), int(iteration))
        return torch.stack([bits_to_uniform(w) for w in words[:n]], dim=-1)

    return draw


class TableDraws:
    """Given uniforms: ``tables[(stream, bounce)]`` is an (n_lanes, n) tensor
    indexed by global lane id."""

    def __init__(self, tables: Mapping[tuple[int, int], Tensor]):
        self.tables = dict(tables)

    def __call__(self, stream: int, bounce: int, lane_ids: Tensor,
                 n: int) -> Tensor:
        tab = self.tables[(int(stream), int(bounce))]
        return tab[lane_ids.to(torch.int64), :n]


def camera_uniforms(draws: Draws, lane_ids: Tensor) -> Tensor:
    """(u, v) sub-pixel jitter uniforms, (n_lanes, 2)."""
    return draws(CAMERA_STREAM, 0, lane_ids, 2)


def lens_uniforms(draws: Draws, lane_ids: Tensor) -> Tensor:
    """(u, v) thin-lens aperture uniforms, (n_lanes, 2)."""
    return draws(LENS_STREAM, 0, lane_ids, 2)


def bounce_uniforms(draws: Draws, bounce: int, lane_ids: Tensor) -> Tensor:
    """Per-bounce (bsdf u, bsdf v, russian roulette), (n_lanes, 3)."""
    return draws(BOUNCE_STREAM, bounce, lane_ids, 3)


def light_uniforms(draws: Draws, bounce: int, lane_ids: Tensor) -> Tensor:
    """Per-bounce NEE uniforms (light u, light v, select), (n_lanes, 3)."""
    return draws(LIGHT_STREAM, bounce, lane_ids, 3)
