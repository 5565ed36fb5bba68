"""Scene data model for spheres: padded SoA tensors plus static structure.

Counterpart of the sphere part of ``tpu_pathtracer/models/scene.py``. The
array fields keep the JAX layouts and paddings; the static structure
(``emissive_prims``, ``prim_mtypes``, ``light_structure``, ...) stays as
Python tuples so the kernel wrapper can read it without a device sync.
Meshes, textures and triangle lights are not ported yet: ``make_scene``
raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import Tensor

# Material types (reference material.h:25)
DIFFUSE = 0
SPECULAR = 1
TRANSMISSIVE = 2

# Light types (reference light.h:34); TRI_LIGHT exists in the JAX package only
POINT_LIGHT = 0
AREA_LIGHT = 1
TRI_LIGHT = 2

# Reference globals.h:49: shadow/self-intersection epsilon.
EPSILON = 3e-2

# Tensor fields and static fields, in the JAX Scene's names.
ARRAY_FIELDS = (
    "centers", "radii", "material_id", "light_id", "prim_valid",
    "mat_color", "mat_coef", "mat_type",
    "light_type", "light_pos", "light_prim", "light_intensity", "light_valid",
)
STATIC_FIELDS = (
    "num_prims", "num_lights", "emissive_prims", "prim_mtypes",
    "prim_material_ids", "light_structure", "mat_types",
)


def _pad_to(n: int, m: int = 8) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class Scene:
    # Primitives (P = padded primitive count)
    centers: Tensor  # (P, 3) f32
    radii: Tensor  # (P,) f32
    material_id: Tensor  # (P,) int64 index
    light_id: Tensor  # (P,) int32, -1 = not emissive
    prim_valid: Tensor  # (P,) bool
    # Material table (M = padded material count)
    mat_color: Tensor  # (M, 3)
    mat_coef: Tensor  # (M,) specular scale or IOR
    mat_type: Tensor  # (M,) int32
    # Light table (L = padded light count)
    light_type: Tensor  # (L,) int32
    light_pos: Tensor  # (L, 3) point lights only
    light_prim: Tensor  # (L,) int64 index, area lights only
    light_intensity: Tensor  # (L, 3)
    light_valid: Tensor  # (L,) bool
    # Static structure
    num_prims: int = 0
    num_lights: int = 0
    emissive_prims: tuple = ()
    prim_mtypes: tuple = ()
    prim_material_ids: tuple = ()
    light_structure: tuple = ()  # ((light_type, prim_index_or_-1), ...)
    mat_types: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


@dataclasses.dataclass(frozen=True)
class PrimAttrs:
    """Per-primitive shading attributes, denormalized from the tables."""

    albedo: Tensor  # (P, 3)
    coef: Tensor  # (P,)
    mtype: Tensor  # (P,) int32
    emission: Tensor  # (P, 3) area-light radiance, 0 for non-emitters


def prim_attrs(scene: Scene) -> PrimAttrs:
    """Denormalize the material and light tables to per-primitive arrays."""
    albedo = scene.mat_color[scene.material_id]
    coef = scene.mat_coef[scene.material_id]
    mtype = scene.mat_type[scene.material_id]
    is_area = (scene.light_type == AREA_LIGHT) & scene.light_valid
    contrib = scene.light_intensity * is_area[:, None]
    emission = torch.zeros_like(scene.centers).index_add_(
        0, scene.light_prim, contrib)
    emission = emission * scene.prim_valid[:, None]
    return PrimAttrs(albedo=albedo, coef=coef, mtype=mtype, emission=emission)


# ---------------------------------------------------------------------------
# Host-side construction helpers
# ---------------------------------------------------------------------------

def diffuse(color: Sequence[float], coef: float = 0.0) -> dict:
    return {"type": DIFFUSE, "color": list(color), "coef": coef}


def specular(color: Sequence[float], coef: float = 1.0) -> dict:
    return {"type": SPECULAR, "color": list(color), "coef": coef}


def transmissive(color: Sequence[float], ior: float = 1.5) -> dict:
    return {"type": TRANSMISSIVE, "color": list(color), "coef": ior}


def sphere(center: Sequence[float], radius: float, material: int,
           light: int = -1) -> dict:
    return {"center": list(center), "radius": radius, "material": material,
            "light": light}


def point_light(pos: Sequence[float], intensity: Sequence[float]) -> dict:
    return {"type": POINT_LIGHT, "pos": list(pos),
            "intensity": list(intensity)}


def area_light(prim: int, intensity: Sequence[float]) -> dict:
    return {"type": AREA_LIGHT, "prim": prim, "intensity": list(intensity)}


def make_scene(
    spheres: Sequence[dict],
    materials: Sequence[dict],
    lights: Sequence[dict] = (),
    mesh: Any = None,
    textures: Any = None,
    mat_texture: Sequence[int] | None = None,
    *,
    device="cuda",
) -> Scene:
    """Build a padded SoA sphere Scene from declarative Python data, with the
    JAX package's host-side validation and padding."""
    if mesh is not None or textures is not None or mat_texture is not None:
        raise NotImplementedError(
            "meshes and textures are not ported to tpu_pathtracer_torch yet")
    n_p, n_m, n_l = len(spheres), len(materials), len(lights)
    for i, s in enumerate(spheres):
        if not 0 <= s["material"] < n_m:
            raise ValueError(
                f"sphere {i}: material id {s['material']} out of range "
                f"(have {n_m} materials)")
    for i, l in enumerate(lights):
        if l["type"] == TRI_LIGHT:
            raise NotImplementedError(
                f"light {i}: TRI_LIGHT is not ported to tpu_pathtracer_torch "
                "yet")
        if l["type"] == AREA_LIGHT and not 0 <= l["prim"] < n_p:
            raise ValueError(
                f"light {i}: area-light prim {l['prim']} out of range "
                f"(have {n_p} primitives)")
    for i, s in enumerate(spheres):
        li = s.get("light", -1)
        if li >= n_l:
            raise ValueError(
                f"sphere {i}: light id {li} out of range (have {n_l} lights)")
    P, M, L = _pad_to(n_p), _pad_to(n_m), _pad_to(max(n_l, 1))

    centers = np.zeros((P, 3), np.float32)
    radii = np.zeros((P,), np.float32)
    mat_id = np.zeros((P,), np.int64)
    light_id = np.full((P,), -1, np.int32)
    valid = np.zeros((P,), bool)
    for i, s in enumerate(spheres):
        centers[i] = s["center"]
        radii[i] = s["radius"]
        mat_id[i] = s["material"]
        light_id[i] = s.get("light", -1)
        valid[i] = True

    mat_color = np.zeros((M, 3), np.float32)
    mat_coef = np.zeros((M,), np.float32)
    mat_type = np.zeros((M,), np.int32)
    for i, m in enumerate(materials):
        mat_color[i] = m["color"]
        mat_coef[i] = m["coef"]
        mat_type[i] = m["type"]

    l_type = np.zeros((L,), np.int32)
    l_pos = np.zeros((L, 3), np.float32)
    # Padding rows point at padding prim P-1 (always invalid, non-emissive),
    # so the emission scatter in prim_attrs is a no-op for them.
    l_prim = np.full((L,), P - 1, np.int64)
    l_int = np.zeros((L, 3), np.float32)
    l_valid = np.zeros((L,), bool)
    for i, l in enumerate(lights):
        l_type[i] = l["type"]
        l_valid[i] = True
        l_int[i] = l["intensity"]
        if l["type"] == POINT_LIGHT:
            l_pos[i] = l["pos"]
        else:
            l_prim[i] = l["prim"]

    arrays = dict(
        centers=centers, radii=radii, material_id=mat_id, light_id=light_id,
        prim_valid=valid, mat_color=mat_color, mat_coef=mat_coef,
        mat_type=mat_type, light_type=l_type, light_pos=l_pos,
        light_prim=l_prim, light_intensity=l_int, light_valid=l_valid,
    )
    static = dict(
        num_prims=n_p,
        num_lights=n_l,
        emissive_prims=tuple(
            i for i, s in enumerate(spheres) if s.get("light", -1) >= 0),
        prim_mtypes=tuple(
            int(materials[s["material"]]["type"]) for s in spheres),
        prim_material_ids=tuple(int(s["material"]) for s in spheres),
        light_structure=tuple(
            (int(l["type"]), int(l.get("prim", -1))) for l in lights),
        mat_types=tuple(int(m["type"]) for m in materials),
    )
    return scene_from_numpy(arrays, static, device=device)


def scene_from_numpy(arrays: Mapping[str, np.ndarray],
                     static: Mapping[str, Any], *, device="cuda") -> Scene:
    """Build a Scene from the array fields (numpy) and the static fields of a
    JAX ``Scene``, so both packages compute on identical tables."""
    ints = {"material_id", "light_prim"}
    tensors = {}
    for f in ARRAY_FIELDS:
        a = np.asarray(arrays[f])
        if f in ints:
            a = a.astype(np.int64)  # torch indexes with int64
        tensors[f] = torch.tensor(a, device=device)
    if any(ltype == TRI_LIGHT for ltype, _ in static["light_structure"]):
        raise NotImplementedError("TRI_LIGHT is not ported yet")
    return Scene(**tensors, **{f: static[f] for f in STATIC_FIELDS})


# ---------------------------------------------------------------------------
# Built-in scenes
# ---------------------------------------------------------------------------

def reference_materials() -> list[dict]:
    """The reference's six materials (main.cpp:133-138)."""
    return [
        diffuse([1.0, 1.0, 1.0]),          # 0 default
        diffuse([0.75, 0.25, 0.25]),       # 1 red
        diffuse([0.25, 0.25, 0.75]),       # 2 blue
        diffuse([0.75, 0.75, 0.75]),       # 3 grey
        specular([0.999, 0.999, 0.999]),   # 4 mirror
        transmissive([0.999, 0.999, 0.999], 1.5),  # 5 glass
    ]


def cornell_spheres(device="cuda") -> tuple[Scene, dict]:
    """The reference's "scene 2" (main.cpp:152-164): a Cornell box of giant
    spheres with a mirror ball, a glass ball and a huge emissive sphere.
    Returns (scene, camera_spec)."""
    e5 = 1e5
    spheres = [
        sphere([e5 + 50, 40, 0], e5, 2),      # left (blue)
        sphere([-e5 - 50, 40, 0], e5, 1),     # right (red)
        sphere([0, 40, -e5 - 80], e5, 3),     # back
        sphere([0, 40, e5 + 80], e5, 3),      # front
        sphere([0, -e5, 0], e5, 3),           # bottom
        sphere([0, e5 + 80, 0], e5, 3),       # top
        sphere([-25, 16.5, -50], 16.5, 4),    # mirror ball
        sphere([25, 16.5, -25], 16.5, 5),     # glass ball
        sphere([0, 579.6, -40], 500, 1, 0),   # emitter
    ]
    lights = [area_light(8, [12.0, 12.0, 12.0])]
    cam = dict(eye=[0, 45, 79.5], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights,
                      device=device), cam


def small_spheres(device="cuda") -> tuple[Scene, dict]:
    """The reference's commented-out "scene 1" (main.cpp:142-150)."""
    e5 = 1e5
    spheres = [
        sphere([0, -e5 - 1, 0], e5, 1),       # floor
        sphere([0, e5 + 3, 0], e5, 1),        # ceiling
        sphere([0, 0, -e5 - 7], e5, 1),       # back
        sphere([0, 0, e5 + 7], e5, 1),        # front
        sphere([-e5 - 4, 0, 0], e5, 2),       # left
        sphere([e5 + 4, 0, 0], e5, 3),        # right
        sphere([-1.5, 0, 0], 1.0, 4),
        sphere([1.5, 0, 0], 1.0, 5),
        sphere([0, 2.0, 0], 0.5, 1, 0),
    ]
    lights = [area_light(8, [12.0, 12.0, 12.0])]
    cam = dict(eye=[0, 1, 6.5], look_at=[0, 1, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights,
                      device=device), cam


def single_sphere(device="cuda") -> tuple[Scene, dict]:
    """Single diffuse sphere under a sphere area light."""
    spheres = [
        sphere([0, 0, 0], 1.0, 0),
        sphere([0, 3.0, 0], 0.5, 0, 0),
    ]
    mats = [diffuse([0.8, 0.6, 0.4])]
    lights = [area_light(1, [20.0, 20.0, 20.0])]
    cam = dict(eye=[0, 1.0, 4.0], look_at=[0, 0.5, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, mats, lights, device=device), cam


BUILTIN_SCENES = {
    "cornell": cornell_spheres,
    "small": small_spheres,
    "single-sphere": single_sphere,
}
