"""Render settings.

Counterpart of ``RenderConfig`` in ``tpu_pathtracer/models/integrator.py``,
with the same fields and defaults. The wavefront integrator
(``trace``/``render``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

from tpu_pathtracer_torch.models.scene import EPSILON


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's #defines and ctor args)."""

    spp: int = 4
    max_bounces: int = 10
    rr_start: int = 3
    tmin: float = EPSILON
    detach_sampling: bool = True
    use_nee: bool = False
    remat: bool = True
    count_rays: bool = False
    shadow_self_sort: bool = True
    attached_geom: bool = False
