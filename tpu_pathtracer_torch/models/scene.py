"""Scene data model: padded SoA tensors plus static structure.

Counterpart of ``tpu_pathtracer/models/scene.py`` for sphere and
triangle-mesh scenes with point, sphere-area and triangle (TRI_LIGHT)
lights. The array fields keep the JAX layouts and paddings; the static
structure (``emissive_prims``, ``prim_mtypes``, ``light_structure``, ...)
stays as Python tuples so the kernel wrappers can read it without a device
sync. A mesh is a ``models/mesh.py::MeshData``; ``with_packet_mesh`` packs
it for the kernels, with the coarse tree of the two-pass traversal. A texture
atlas ``(K, TH, TW, 3)`` and a per-material texture index modulate the
colours of textured materials; the wavefront integrator and both
persistent kernels sample them (the gradient kernel also differentiates the
atlas), and the route that cannot, the tangent walk, refuses textured
scenes (``refuse_textures``).
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

# Light types (reference light.h:34); TRI_LIGHT, a mesh-triangle area light,
# goes beyond the reference's light model
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
    "light_mat", "mat_texture",
)
STATIC_FIELDS = (
    "num_prims", "num_lights", "emissive_prims", "prim_mtypes",
    "prim_material_ids", "light_structure", "mat_types",
    "light_mats", "tri_light_counts", "mesh_mats_static", "has_tri_lights",
    "mat_textures_static",
)
# Triangle-light sampling tables: None in scenes without a TRI_LIGHT.
TRI_FIELDS = ("tl_v0", "tl_e1", "tl_e2", "tl_n", "tl_cdf", "tl_area")


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
    light_mat: Tensor  # (L,) int32 emissive material of a TRI_LIGHT, else -1
    mat_texture: Tensor  # (M,) int32 texture index per material, -1 = none
    # Static structure
    num_prims: int = 0
    num_lights: int = 0
    emissive_prims: tuple = ()
    prim_mtypes: tuple = ()
    prim_material_ids: tuple = ()
    light_structure: tuple = ()  # ((light_type, prim_index_or_-1), ...)
    mat_types: tuple = ()
    light_mats: tuple = ()  # per light: TRI_LIGHT material id, else -1
    tri_light_counts: tuple = ()  # per light: its triangle count, else 0
    mesh_mats_static: tuple = ()  # material ids used by mesh triangles
    has_tri_lights: bool = False
    mat_textures_static: tuple = ()  # host copy of mat_texture
    # Triangle mesh + BVH (models/mesh.py), None in sphere-only scenes, and
    # (with_packet_mesh) its packed layout for kernel 5 and the plain walks,
    # the coarse tree of the two-pass traversal, and the small-leaf tree
    # that the persistent kernels walk.
    mesh: Any = None
    mesh_packed: Any = None
    mesh_packed_coarse: Any = None
    mesh_bvh: Any = None
    textures: Tensor | None = None  # (K, TH, TW, 3) texture atlas
    # TRI_LIGHT sampling tables (L, K, ...) over the post-BVH triangle
    # order, K the padded largest triangle count (_build_tri_light_tables)
    tl_v0: Tensor | None = None  # (L, K, 3)
    tl_e1: Tensor | None = None  # (L, K, 3)
    tl_e2: Tensor | None = None  # (L, K, 3)
    tl_n: Tensor | None = None  # (L, K, 3) unit front normal
    tl_cdf: Tensor | None = None  # (L, K) area-weighted selection CDF
    tl_area: Tensor | None = None  # (L,) total emissive area

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def textured(self) -> bool:
        """Some material samples the texture atlas."""
        return self.textures is not None and any(
            t >= 0 for t in self.mat_textures_static)

    def to(self, device) -> "Scene":
        moved = {f: getattr(self, f).to(device) for f in ARRAY_FIELDS}
        moved.update({f: getattr(self, f).to(device) for f in TRI_FIELDS
                      if getattr(self, f) is not None})
        for f in ("mesh", "mesh_packed", "mesh_packed_coarse", "mesh_bvh",
                  "textures"):
            if getattr(self, f) is not None:
                moved[f] = getattr(self, f).to(device)
        return dataclasses.replace(self, **moved)


def refuse_textures(scene: Scene, who: str, why: str,
                    error: type[Exception] = NotImplementedError) -> None:
    """Raise ``error`` for a textured scene in a route that cannot sample
    textures, rather than give its textured materials untextured results;
    ``why`` names what is missing there."""
    if scene.textured:
        raise error(f"{who} does not take textured scenes: {why}")


def with_packet_mesh(scene: Scene, two_pass: bool = True,
                     coarse_leaf: int = 1024) -> Scene:
    """Pack the scene's mesh for the kernels: ``pack_mesh`` with 64-triangle
    leaves, the JAX package's defaults, for kernel 5 and the plain versions
    of the persistent kernels; ``pack_bvh``, the mesh's own small-leaf tree
    (one leaf for a mesh of at most 40 triangles), for the persistent
    kernels' per-thread walk. Raises ValueError where ``pack_bvh`` does.
    ``two_pass`` also builds the coarse nodes-only tree
    (``coarse_leaf``-triangle cells, with its map onto the fine tree) that
    drives the wavefront's two-pass binned traversal; the persistent
    kernels never read it."""
    if scene.mesh is None:
        return scene
    from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
        pack_bvh, pack_mesh,
    )

    coarse = (pack_mesh(scene.mesh, collapse_leaf=coarse_leaf,
                        nodes_only=True, fine_leaf=64) if two_pass else None)
    return dataclasses.replace(
        scene, mesh_packed=pack_mesh(scene.mesh, collapse_leaf=64),
        mesh_packed_coarse=coarse, mesh_bvh=pack_bvh(scene.mesh))


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


def tri_light(material: int, intensity: Sequence[float]) -> dict:
    """Triangle-mesh area light: every mesh triangle of ``material`` emits
    ``intensity`` from its front (geometric-normal) side."""
    return {"type": TRI_LIGHT, "material": material,
            "intensity": list(intensity)}


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
    """Build a padded SoA Scene from declarative Python data, with the JAX
    package's host-side validation and padding. ``mesh`` is a MeshData
    (``models/mesh.py::build_bvh``); a TRI_LIGHT's tables are built from it
    here. ``textures`` is one (TH, TW, 3) texture or a (K, TH, TW, 3) stack
    and ``mat_texture`` a texture index per material (-1 = untextured)."""
    n_p, n_m, n_l = len(spheres), len(materials), len(lights)
    mesh_mids = None if mesh is None else mesh.material_id.cpu().numpy()
    for i, s in enumerate(spheres):
        if not 0 <= s["material"] < n_m:
            raise ValueError(
                f"sphere {i}: material id {s['material']} out of range "
                f"(have {n_m} materials)")
    for i, l in enumerate(lights):
        if l["type"] == AREA_LIGHT and not 0 <= l["prim"] < n_p:
            raise ValueError(
                f"light {i}: area-light prim {l['prim']} out of range "
                f"(have {n_p} primitives)")
        if l["type"] == TRI_LIGHT:
            if mesh is None:
                raise ValueError(f"light {i}: TRI_LIGHT requires a mesh")
            if not 0 <= l["material"] < n_m:
                raise ValueError(
                    f"light {i}: tri-light material {l['material']} out of "
                    f"range (have {n_m} materials)")
            if not bool(np.any(mesh_mids == l["material"])):
                raise ValueError(
                    f"light {i}: no mesh triangle uses material "
                    f"{l['material']}")
    for i, s in enumerate(spheres):
        li = s.get("light", -1)
        if li >= n_l:
            raise ValueError(
                f"sphere {i}: light id {li} out of range (have {n_l} lights)")
    if mesh_mids is not None and mesh_mids.size and (
            mesh_mids.min() < 0 or mesh_mids.max() >= n_m):
        bad = int(mesh_mids.min()) if mesh_mids.min() < 0 \
            else int(mesh_mids.max())
        raise ValueError(
            f"mesh: triangle material id {bad} out of range "
            f"(have {n_m} materials)")
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
    l_mat = np.full((L,), -1, np.int32)
    for i, l in enumerate(lights):
        l_type[i] = l["type"]
        l_valid[i] = True
        l_int[i] = l["intensity"]
        if l["type"] == POINT_LIGHT:
            l_pos[i] = l["pos"]
        elif l["type"] == TRI_LIGHT:
            l_mat[i] = l["material"]
        else:
            l_prim[i] = l["prim"]

    arrays = dict(
        centers=centers, radii=radii, material_id=mat_id, light_id=light_id,
        prim_valid=valid, mat_color=mat_color, mat_coef=mat_coef,
        mat_type=mat_type, light_type=l_type, light_pos=l_pos,
        light_prim=l_prim, light_intensity=l_int, light_valid=l_valid,
        light_mat=l_mat,
    )
    mat_tex = np.full((M,), -1, np.int32)
    if mat_texture is not None:
        for i, t in enumerate(mat_texture):
            mat_tex[i] = t
    arrays["mat_texture"] = mat_tex
    if textures is not None:
        textures = np.asarray(textures, np.float32)
        arrays["textures"] = textures[None] if textures.ndim == 3 else textures
    tri_tabs = _build_tri_light_tables(mesh, l_type, l_mat, l_valid, L)
    arrays.update({f: v for f, v in tri_tabs.items() if v is not None})
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
        light_mats=tuple(int(l["material"]) if l["type"] == TRI_LIGHT else -1
                         for l in lights),
        tri_light_counts=tuple(
            int(np.sum(mesh_mids == l["material"]))
            if l["type"] == TRI_LIGHT else 0 for l in lights),
        mesh_mats_static=(tuple(sorted(int(m) for m in np.unique(mesh_mids)))
                          if mesh is not None else ()),
        has_tri_lights=tri_tabs["tl_area"] is not None,
        mat_textures_static=tuple(int(t) for t in mat_tex),
    )
    return scene_from_numpy(arrays, static, mesh=mesh, device=device)


def _build_tri_light_tables(mesh, l_type, l_mat, l_valid, L: int) -> dict:
    """Per-light triangle sampling tables for TRI_LIGHT lights: the mesh
    triangles of each light's material (post-BVH order), their unit front
    normals and an area-weighted selection CDF, padded to a common K."""
    is_tri = (l_type == TRI_LIGHT) & l_valid
    if mesh is None or not bool(is_tri.any()):
        return {f: None for f in TRI_FIELDS}
    v0, e1, e2 = (getattr(mesh, f).cpu().numpy().astype(np.float64)
                  for f in ("v0", "e1", "e2"))
    mat = mesh.material_id.cpu().numpy()
    per_light = [np.nonzero(mat == l_mat[i])[0] if is_tri[i]
                 else np.zeros((0,), np.int64) for i in range(L)]
    K = max(1, max(len(ids) for ids in per_light))
    tv0 = np.zeros((L, K, 3), np.float32)
    te1 = np.zeros((L, K, 3), np.float32)
    te2 = np.zeros((L, K, 3), np.float32)
    tn = np.zeros((L, K, 3), np.float32)
    tcdf = np.ones((L, K), np.float32)  # padding: cdf saturated at 1
    tarea = np.zeros((L,), np.float32)
    for i, ids in enumerate(per_light):
        k = len(ids)
        if k == 0:
            continue
        cr = np.cross(e1[ids], e2[ids])
        a = 0.5 * np.linalg.norm(cr, axis=-1)
        total = float(a.sum())
        if total <= 0.0:
            raise ValueError(f"tri light {i}: degenerate emissive triangles")
        tv0[i, :k] = v0[ids]
        te1[i, :k] = e1[ids]
        te2[i, :k] = e2[ids]
        tn[i, :k] = cr / np.maximum(
            np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
        tcdf[i, :k] = np.cumsum(a) / total
        tcdf[i, k - 1:] = 1.0
        tarea[i] = total
    return dict(tl_v0=tv0, tl_e1=te1, tl_e2=te2, tl_n=tn, tl_cdf=tcdf,
                tl_area=tarea)


def scene_from_numpy(arrays: Mapping[str, np.ndarray],
                     static: Mapping[str, Any], *, mesh=None,
                     device="cuda") -> Scene:
    """Build a Scene from the array fields (numpy) and the static fields of a
    JAX ``Scene``, so both packages compute on identical tables. ``mesh`` is
    a MeshData (``models/mesh.py::mesh_from_numpy`` carries a JAX mesh
    across); the TRI_LIGHT tables are read from ``arrays`` when the scene
    has triangle lights, and the texture atlas from ``arrays["textures"]``
    when it is there."""
    ints = {"material_id", "light_prim"}
    tensors = {}
    for f in ARRAY_FIELDS:
        a = np.asarray(arrays[f])
        if f in ints:
            a = a.astype(np.int64)  # torch indexes with int64
        tensors[f] = torch.tensor(a, device=device)
    if static["has_tri_lights"]:
        if mesh is None:
            raise ValueError("a scene with triangle lights needs its mesh")
        tensors.update({f: torch.tensor(np.asarray(arrays[f], np.float32),
                                        device=device) for f in TRI_FIELDS})
    if arrays.get("textures") is not None:
        tensors["textures"] = torch.tensor(
            np.asarray(arrays["textures"], np.float32), device=device)
    if mesh is not None:
        mesh = mesh.to(device)
    return Scene(**tensors, **{f: static[f] for f in STATIC_FIELDS},
                 mesh=mesh)


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


def limit_spheres(device="cuda") -> tuple[Scene, dict]:
    """Cornell spheres at the gradient kernels' adjoint limits: 16 materials
    on surfaces (six walls, a mirror ball, a glass ball, four diffuse balls
    and four emitter materials, each its own) and 16 lights: sixteen
    sphere emitters in a 4 x 4 grid above the ceiling, their caps poking
    through it. The emitters are wide (radius 25) and lit alike, so NEE
    picks each light alike; a small sphere light would make one ulp change
    a lane's radiance by more than 1e-4 far more often (its cone pdf
    cancels). Returns (scene, camera_spec), the camera of
    cornell_spheres."""
    e5 = 1e5
    spheres = [
        sphere([e5 + 50, 40, 0], e5, 0),
        sphere([-e5 - 50, 40, 0], e5, 1),
        sphere([0, 40, -e5 - 80], e5, 2),
        sphere([0, 40, e5 + 80], e5, 3),
        sphere([0, -e5, 0], e5, 4),
        sphere([0, e5 + 80, 0], e5, 5),
        sphere([-25, 16.5, -50], 16.5, 6),
        sphere([25, 16.5, -25], 16.5, 7),
    ]
    spheres += [sphere([-36 + 24 * i, 8, 10 - 12 * (i % 2)], 6, 8 + i)
                for i in range(4)]
    first = len(spheres)
    spheres += [sphere([-36 + 24 * (i % 4), 104.6, -72 + 20 * (i // 4)], 25,
                       12 + i % 4, i) for i in range(16)]
    materials = [diffuse([0.25 + 0.1 * i, 0.75 - 0.1 * i, 0.5])
                 for i in range(6)]
    materials += [specular([0.999, 0.999, 0.999]),
                  transmissive([0.999, 0.999, 0.999], 1.5)]
    materials += [diffuse([0.8, 0.3 + 0.1 * i, 0.2]) for i in range(8)]
    lights = [area_light(first + i, [4.0 + 0.4 * (i % 3), 4.0,
                                     4.0 + 0.4 * (i % 5)]) for i in range(16)]
    cam = dict(eye=[0, 45, 79.5], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, materials, lights, device=device), cam


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


def cornell_glass(device="cuda") -> tuple[Scene, dict]:
    """BASELINE config 3: Cornell box of triangle-quad walls with a mirror
    sphere and a glass sphere inside, under a sphere area emitter."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    grey, red, blue = 3, 1, 2
    walls = [
        (*meshes.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80],
                      [-50, 0, -80]), grey),             # floor (+y)
        (*meshes.quad([-50, 80, -80], [50, 80, -80], [50, 80, 80],
                      [-50, 80, 80]), grey),             # ceiling (-y)
        (*meshes.quad([50, 0, -80], [50, 80, -80], [-50, 80, -80],
                      [-50, 0, -80]), grey),             # back (+z)
        (*meshes.quad([-50, 0, 80], [-50, 80, 80], [50, 80, 80],
                      [50, 0, 80]), grey),               # front (-z)
        (*meshes.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80],
                      [-50, 0, 80]), red),               # left (+x)
        (*meshes.quad([50, 0, 80], [50, 80, 80], [50, 80, -80],
                      [50, 0, -80]), blue),              # right (-x)
    ]
    v, f, uv, m = meshes.merge(*walls)
    mesh = build_bvh(v, f, uv, m, device=device)
    spheres = [
        sphere([-25, 16.5, -50], 16.5, 4),   # mirror ball
        sphere([25, 16.5, -25], 16.5, 5),    # glass ball
        sphere([0, 86, -20], 10.0, 1, 0),    # emitter pokes below ceiling
    ]
    lights = [area_light(2, [60.0, 60.0, 60.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights, mesh=mesh,
                      device=device), cam


def _cornell_mesh_walls(white, red, blue):
    from tpu_pathtracer_torch.models import meshes

    return [
        (*meshes.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80],
                      [-50, 0, -80]), white),            # floor (+y)
        (*meshes.quad([-50, 80, -80], [50, 80, -80], [50, 80, 80],
                      [-50, 80, 80]), white),            # ceiling (-y)
        (*meshes.quad([50, 0, -80], [50, 80, -80], [-50, 80, -80],
                      [-50, 0, -80]), white),            # back (+z)
        (*meshes.quad([-50, 0, 80], [-50, 80, 80], [50, 80, 80],
                      [50, 0, 80]), white),              # front (-z)
        (*meshes.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80],
                      [-50, 0, 80]), red),               # left (+x)
        (*meshes.quad([50, 0, 80], [50, 80, 80], [50, 80, -80],
                      [50, 0, -80]), blue),              # right (-x)
    ]


def _cornell_mesh_boxes(white):
    from tpu_pathtracer_torch.models import meshes

    return [
        (*meshes.box([-18, 30, -35], [30, 60, 30], rotation_y=0.3), white),
        (*meshes.box([20, 14, -5], [28, 28, 28], rotation_y=-0.25), white),
    ]


def cornell_boxes(device="cuda") -> tuple[Scene, dict]:
    """BASELINE config 2: Cornell box with diffuse triangle walls and two
    boxes, lit by a sphere emitter poking below the ceiling."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    white, red, blue = 0, 1, 2
    v, f, uv, m = meshes.merge(*_cornell_mesh_walls(white, red, blue),
                               *_cornell_mesh_boxes(white))
    mesh = build_bvh(v, f, uv, m, device=device)
    spheres = [sphere([0, 86, -20], 10.0, 3, 0)]
    mats = [
        diffuse([0.75, 0.75, 0.75]),
        diffuse([0.75, 0.25, 0.25]),
        diffuse([0.25, 0.25, 0.75]),
        diffuse([1.0, 1.0, 1.0]),
    ]
    lights = [area_light(0, [60.0, 60.0, 60.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, mats, lights, mesh=mesh, device=device), cam


def cornell_quad(device="cuda") -> tuple[Scene, dict]:
    """Cornell box lit by an emissive ceiling quad (TRI_LIGHT): a pure mesh
    scene, no spheres; NEE samples the quad by area."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    white, red, blue, emit = 0, 1, 2, 3
    light_quad = (*meshes.quad([-15, 79.5, -35], [15, 79.5, -35],
                               [15, 79.5, -5], [-15, 79.5, -5]), emit)
    v, f, uv, m = meshes.merge(*_cornell_mesh_walls(white, red, blue),
                               light_quad, *_cornell_mesh_boxes(white))
    mesh = build_bvh(v, f, uv, m, device=device)
    mats = [
        diffuse([0.75, 0.75, 0.75]),
        diffuse([0.75, 0.25, 0.25]),
        diffuse([0.25, 0.25, 0.75]),
        diffuse([0.0, 0.0, 0.0]),  # emitter surface: pure emitter, no BSDF
    ]
    lights = [tri_light(emit, [34.0, 34.0, 34.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene([], mats, lights, mesh=mesh, device=device), cam


def terrain_textured(n: int = 224, device="cuda") -> tuple[Scene, dict]:
    """BASELINE config 4: a textured heightfield (2 (n-1)^2 triangles,
    99,458 at the default n = 224) under a sphere sky-light, its ground
    checker-textured."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.terrain(n=n, extent=120.0, height=14.0, seed=3)
    mesh = build_bvh(v, f, uv, 0, device=device)
    tex = meshes.checker_texture(256, tiles=24, c0=(0.85, 0.8, 0.7),
                                 c1=(0.35, 0.45, 0.25))
    spheres = [sphere([0, 320, 0], 160.0, 1, 0)]  # sky dome emitter
    mats = [diffuse([1.0, 1.0, 1.0]), diffuse([1.0, 1.0, 1.0])]
    lights = [area_light(0, [6.0, 6.0, 6.0])]
    cam = dict(eye=[0, 26, 52], look_at=[0, 6, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, mats, lights, mesh=mesh, textures=tex,
                      mat_texture=[0, -1], device=device), cam


def sphere_field(n: int = 128, seed: int = 7, device="cuda"
                 ) -> tuple[Scene, dict]:
    """An n-sphere stress scene: a 1e5-radius floor, an emitter overhead and
    a pseudo-random field of diffuse, mirror and glass balls, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so every
    array equals JAX's. At n = 128 it fills half the kernels' MAX_PRIMS."""
    rng = np.random.default_rng(seed)
    e5 = 1e5
    spheres = [
        sphere([0, -e5, 0], e5, 3),  # floor
        sphere([0, 90.0, 0], 30.0, 1, 0),  # emitter overhead
    ]
    n_field = n - len(spheres)
    pos = rng.uniform([-45, 2, -45], [45, 14, 45], (n_field, 3))
    rad = rng.uniform(1.0, 3.5, n_field)
    mat = rng.choice([0, 2, 3, 4, 5], size=n_field,
                     p=[0.3, 0.25, 0.25, 0.1, 0.1])
    for p, r, m in zip(pos, rad, mat):
        spheres.append(sphere(p.tolist(), float(r), int(m)))
    lights = [area_light(1, [14.0, 14.0, 14.0])]
    cam = dict(eye=[0, 26, 95], look_at=[0, 8, 0], up=[0, 1, 0], fov=55.0)
    return make_scene(spheres, reference_materials(), lights,
                      device=device), cam


BUILTIN_SCENES = {
    "cornell": cornell_spheres,
    "cornell-glass": cornell_glass,
    "small": small_spheres,
    "single-sphere": single_sphere,
    "cornell-boxes": cornell_boxes,
    "cornell-quad": cornell_quad,
    "terrain": terrain_textured,
    "sphere-field": sphere_field,
}
