"""Perspective camera, pinhole or thin lens.

Counterpart of ``tpu_pathtracer/models/camera.py`` (reference camera.h:28-177
semantics): ``translate`` and ``rotate`` return a new Camera, the view matrix
is the 3x3 row stack [u; v; w], and ``generate_rays`` is batched over pixels.
A camera with ``lens_radius > 0`` has thin-lens depth of field focused at
``focal_distance``. ``lens_radius`` is a host float (the JAX camera's static
``use_dof``), so a route can branch on it without a device read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import Tensor

from tpu_pathtracer_torch.ops import vecmath as vm
from tpu_pathtracer_torch.ops.sampling import concentric_sample_disk

ARRAY_FIELDS = ("pos", "view", "px_x", "px_y", "first_ray_dir", "dist",
                "hfov", "vfov", "focal_distance")
STATIC_FIELDS = ("width", "height", "lens_radius")


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: Tensor  # (3,) eye position
    view: Tensor  # (3, 3) rows = [u (right), v (up), w (forward)]
    px_x: Tensor  # (3,) image-plane step for +1 pixel in x
    px_y: Tensor  # (3,) image-plane step for +1 pixel in y
    first_ray_dir: Tensor  # (3,) direction to the upper-left corner pixel
    dist: Tensor  # () distance eye -> image plane
    hfov: Tensor  # () horizontal fov, degrees
    vfov: Tensor  # () vertical fov, degrees
    focal_distance: Tensor  # ()
    width: int = 640
    height: int = 480
    lens_radius: float = 0.0  # host value; > 0: thin-lens DOF

    def __post_init__(self):
        object.__setattr__(self, "lens_radius", float(self.lens_radius))

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


    @property
    def use_dof(self) -> bool:
        return self.lens_radius > 0.0


def refuse_lens(lens_radius: float, who: str) -> None:
    """Raise ValueError in a route that traces pinhole rays only (the
    tangent walk), rather than give a lens camera a pinhole camera's
    results."""
    if lens_radius > 0.0:
        raise ValueError(
            f"{who}: the tangent walk traces a pinhole camera, and this "
            f"camera has a lens (lens_radius {lens_radius}); its gradients "
            "would be a pinhole camera's")


def _image_plane(view: Tensor, dist: Tensor, hfov: Tensor, vfov: Tensor,
                 width: int, height: int) -> tuple[Tensor, Tensor, Tensor]:
    """Per-pixel image-plane basis (camera.h:144-158 semantics)."""
    u, v, w = view[0], view[1], view[2]
    deg = math.pi / 180.0
    px_x = u * (dist * 2.0 * torch.tan(hfov * 0.5 * deg) / width)
    px_y = v * (dist * 2.0 * torch.tan(vfov * 0.5 * deg) / height)
    first_ray_dir = w * dist + px_y * (height * 0.5) - px_x * (width * 0.5)
    return px_x, px_y, first_ray_dir


def make_camera(eye: Any, look_at: Any, up: Any, width: int, height: int,
                fov: float = 60.0, lens_radius: float = 0.0,
                focal_distance: float = 0.0, *, device="cuda") -> Camera:
    """Build a camera; fov is the horizontal field of view in degrees and the
    vertical one follows from the aspect ratio (camera.h:31-57).
    ``lens_radius > 0`` gives thin-lens depth of field focused at
    ``focal_distance``."""
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.as_tensor(eye, **f32)
    look_at = torch.as_tensor(look_at, **f32)
    up = torch.as_tensor(up, **f32)
    aspect = float(height) / float(width)
    hfov = torch.as_tensor(fov, **f32)
    vfov = hfov * aspect

    to_target = look_at - eye
    dist = vm.length(to_target)
    w = to_target / dist
    v = vm.normalize(up - vm.dot(up, w) * w)
    u = vm.normalize(vm.cross(w, v))
    view = torch.stack([u, v, w])
    px_x, px_y, first_ray_dir = _image_plane(view, dist, hfov, vfov, width,
                                             height)
    return Camera(
        pos=eye, view=view, px_x=px_x, px_y=px_y,
        first_ray_dir=first_ray_dir, dist=dist, hfov=hfov, vfov=vfov,
        focal_distance=torch.as_tensor(focal_distance, **f32),
        width=width, height=height, lens_radius=lens_radius,
    )


def camera_from_numpy(arrays: Mapping[str, np.ndarray],
                      static: Mapping[str, Any], *, device="cuda") -> Camera:
    """Build a Camera from the array fields (numpy) and static fields of a
    JAX ``Camera`` (``lens_radius`` among the static ones: an array there,
    a host float here)."""
    lens = float(np.asarray(static["lens_radius"]))
    return Camera(
        **{f: torch.tensor(np.asarray(arrays[f], np.float32),
                           device=device) for f in ARRAY_FIELDS},
        width=int(static["width"]), height=int(static["height"]),
        lens_radius=lens,
    )


def generate_rays(cam: Camera, px: Tensor, py: Tensor, jitter_u: Tensor,
                  jitter_v: Tensor, lens_u: Tensor | None = None,
                  lens_v: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Primary rays through pixel (px, py) plus sub-pixel jitter:
    dir = first_ray_dir - px_y*sy + px_x*sx (camera.h:66-72). Returns
    (origins, dirs), each (..., 3).

    A lens camera given lens uniforms moves the origin to a point of the
    lens disk (the concentric map) and re-aims the ray at the point where
    the pinhole ray meets the plane of focus (JAX ``camera.py:136-150``)."""
    sx = px.to(torch.float32) + jitter_u
    sy = py.to(torch.float32) + jitter_v
    d = cam.first_ray_dir - cam.px_y * sy[..., None] + cam.px_x * sx[..., None]
    d = vm.normalize(d)
    o = cam.pos.expand(d.shape)
    if cam.use_dof and lens_u is not None and lens_v is not None:
        lx, ly = concentric_sample_disk(lens_u, lens_v)
        offset = (cam.view[0] * (lx * cam.lens_radius)[..., None]
                  + cam.view[1] * (ly * cam.lens_radius)[..., None])
        cos_w = vm.dot(d, cam.view[2])[..., None]
        ft = cam.focal_distance / torch.clamp_min(cos_w, 1e-6)
        focus = o + d * ft
        o = o + offset
        d = vm.normalize(focus - o)
    return o, d


def translate(cam: Camera, delta: Any) -> Camera:
    """Move the eye along the view axes; delta = (right, up, forward)."""
    delta = torch.as_tensor(delta, dtype=torch.float32, device=cam.device)
    u, v, w = cam.view[0], cam.view[1], cam.view[2]
    new_pos = cam.pos + u * delta[0] + v * delta[1] + w * delta[2]
    return dataclasses.replace(cam, pos=new_pos)


def rotate(cam: Camera, theta: Any) -> Camera:
    """Rotate the view by theta = (tx, ty) radians (camera.h:97-129): an
    x-axis rotation driven by ty composed with a y-axis rotation driven by
    tx. The 3x3 products run in float32 through torch.matmul."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=cam.device)
    ctx, stx = torch.cos(theta[0]), torch.sin(theta[0])
    cty, sty = torch.cos(theta[1]), torch.sin(theta[1])
    one, zero = torch.ones_like(ctx), torch.zeros_like(ctx)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, cty, -sty]),
                      torch.stack([zero, sty, cty])])
    ry = torch.stack([torch.stack([ctx, zero, stx]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-stx, zero, ctx])])
    view = torch.matmul(torch.matmul(rx, ry), cam.view)
    px_x, px_y, first_ray_dir = _image_plane(
        view, cam.dist, cam.hfov, cam.vfov, cam.width, cam.height)
    return dataclasses.replace(cam, view=view, px_x=px_x, px_y=px_y,
                               first_ray_dir=first_ray_dir)
