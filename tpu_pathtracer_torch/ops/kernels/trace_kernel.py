"""Scene and camera tables for the kernels.

Counterpart of the packers in ``tpu_pathtracer/ops/pallas/trace_kernel.py``
(``:625-703``), with the same layouts. The per-sample ``_trace_kernel`` of
that file is not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, TRI_LIGHT, Scene, prim_attrs,
)

LANES = 128  # lanes per row of every state plane
BIG = 1e30
INV_PI = 1.0 / math.pi


def pack_camera(camera) -> Tensor:
    """(24,) f32: first_ray_dir[0:3], px_x[3:6], px_y[6:9], pos[9:12],
    lens_radius[12], focal_distance[13], view rows u[14:17], v[17:20],
    w[20:23], pad[23]. The persistent kernels read the lens slots when
    launched with ``use_dof``."""
    return torch.cat([
        camera.first_ray_dir, camera.px_x, camera.px_y, camera.pos,
        camera.focal_distance.new_full((1,), camera.lens_radius),
        camera.focal_distance[None],
        camera.view[0], camera.view[1], camera.view[2],
        torch.zeros(1, dtype=torch.float32, device=camera.device),
    ]).to(torch.float32)


def pack_prims(scene: Scene) -> Tensor:
    """(P, 12) per-prim table: cx cy cz r ax ay az coef mtype ex ey ez."""
    attrs = prim_attrs(scene)
    n = int(scene.num_prims)
    return torch.cat([
        scene.centers[:n],
        scene.radii[:n, None],
        attrs.albedo[:n],
        attrs.coef[:n, None],
        attrs.mtype[:n, None].to(torch.float32),
        attrs.emission[:n],
    ], dim=1)


def pack_lights(scene: Scene) -> Tensor:
    """(L, 8) light table for NEE: pos3 intensity3 cdf_lo sel_pdf, with
    power-proportional selection probabilities: luminance times the
    sphere's area for sphere lights, times the total emissive area for
    triangle lights, luminance alone for point lights."""
    lights_static = tuple(scene.light_structure)
    dev = scene.device
    if not lights_static:
        return torch.zeros((1, 8), dtype=torch.float32, device=dev)
    lum_w = torch.tensor([0.212671, 0.715160, 0.072169], device=dev)
    rows, powers = [], []
    for li, (ltype, lprim) in enumerate(lights_static):
        inten = scene.light_intensity[li]
        lum = torch.sum(inten * lum_w)
        if ltype == AREA_LIGHT and lprim >= 0:
            r = scene.radii[lprim]
            powers.append(lum * 4.0 * math.pi * r * r)
            pos = scene.centers[lprim]
        elif ltype == TRI_LIGHT:
            powers.append(lum * scene.tl_area[li])
            pos = scene.light_pos[li]
        else:
            powers.append(lum)
            pos = scene.light_pos[li]
        rows.append((pos, inten))
    pw = torch.stack(powers)
    total = torch.clamp_min(torch.sum(pw), 1e-20)
    sel = pw / total
    cdf_lo = torch.cat([torch.zeros(1, device=dev), torch.cumsum(sel, 0)[:-1]])
    return torch.stack([
        torch.cat([pos, inten, cdf_lo[li, None], sel[li, None]])
        for li, (pos, inten) in enumerate(rows)
    ]).to(torch.float32)
