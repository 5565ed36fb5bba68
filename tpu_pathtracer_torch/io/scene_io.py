"""Declarative scene files (JSON).

Counterpart of ``tpu_pathtracer/io/scene_io.py``, in the same format: a JSON
document with materials, spheres, triangle meshes, lights and a camera
block.

Example:
{
  "camera": {"eye": [0,45,79.5], "look_at": [0,35,0], "up": [0,1,0],
             "fov": 60.0, "lens_radius": 0.0, "focal_distance": 0.0},
  "materials": [
    {"type": "diffuse", "color": [0.75, 0.25, 0.25]},
    {"type": "specular", "color": [0.999, 0.999, 0.999], "coef": 1.0},
    {"type": "transmissive", "color": [0.999, 0.999, 0.999], "ior": 1.5}
  ],
  "spheres": [
    {"center": [0, 0, 0], "radius": 1.0, "material": 0},
    {"center": [0, 3, 0], "radius": 0.5, "material": 0, "light": 0}
  ],
  "meshes": [
    {"type": "obj", "path": "bunny.obj", "material": 0,
     "translate": [0, 0, 0], "scale": 1.0},
    {"type": "box", "center": [0, 5, 0], "size": [10, 10, 10],
     "rotation_y": 0.3, "material": 1},
    {"type": "quad", "corners": [[-5,0,5],[5,0,5],[5,0,-5],[-5,0,-5]],
     "material": 0},
    {"type": "uv_sphere", "center": [0, 3, 0], "radius": 2.0,
     "material": 2, "n_lat": 16, "n_lon": 24},
    {"type": "terrain", "n": 128, "extent": 200, "height": 14,
     "seed": 0, "material": 3}
  ],
  "lights": [
    {"type": "area", "prim": 1, "intensity": [12, 12, 12]},
    {"type": "point", "pos": [0, 5, 0], "intensity": [100, 100, 100]},
    {"type": "tri", "material": 3, "intensity": [30, 30, 30]}
  ]
}

Mesh entries merge into one BVH (``models/mesh.py::build_bvh``, the SAH
builder); "obj" paths resolve relative to the scene file. A "tri" light
turns every triangle of a material into an emitter (TRI_LIGHT).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from tpu_pathtracer_torch.models import scene as sc

_MAT_TYPES = {"diffuse": sc.DIFFUSE, "specular": sc.SPECULAR,
              "transmissive": sc.TRANSMISSIVE}
_MAT_NAMES = {v: k for k, v in _MAT_TYPES.items()}


def _mesh_part(i: int, m: dict, base_dir: str):
    """One "meshes" entry -> (verts, faces, uvs, material_id)."""
    from tpu_pathtracer_torch.models import meshes

    t = m.get("type", "obj")
    mat = int(m.get("material", 0))
    if t == "obj":
        path = m["path"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        v, f, uv = meshes.load_obj(path)
        v = np.asarray(v, np.float32) * float(m.get("scale", 1.0))
        v = v + np.asarray(m.get("translate", [0.0, 0.0, 0.0]), np.float32)
    elif t == "box":
        v, f, uv = meshes.box(m["center"], m["size"],
                              rotation_y=float(m.get("rotation_y", 0.0)))
    elif t == "quad":
        v, f, uv = meshes.quad(*m["corners"])
    elif t == "uv_sphere":
        v, f, uv = meshes.uv_sphere(
            m["center"], float(m["radius"]),
            n_lat=int(m.get("n_lat", 32)), n_lon=int(m.get("n_lon", 64)))
    elif t == "terrain":
        v, f, uv = meshes.terrain(
            n=int(m.get("n", 128)), extent=float(m.get("extent", 100.0)),
            height=float(m.get("height", 12.0)), seed=int(m.get("seed", 0)))
    else:
        raise ValueError(f"mesh {i}: unknown type {t!r}")
    return v, f, uv, mat


def scene_from_dict(doc: dict, base_dir: str = ".", *, device="cuda"
                    ) -> tuple[sc.Scene, dict]:
    """Build (Scene, camera_spec) from a parsed scene document, its tensors
    on ``device``. ``base_dir`` resolves relative OBJ paths (``load_scene``
    passes the scene file's directory)."""
    materials = []
    for i, m in enumerate(doc.get("materials", [])):
        t = m.get("type", "diffuse")
        if t not in _MAT_TYPES:
            raise ValueError(f"material {i}: unknown type {t!r}")
        coef = m.get("coef", m.get("ior", 1.5 if t == "transmissive" else 0.0))
        materials.append(
            {"type": _MAT_TYPES[t], "color": m["color"], "coef": float(coef)})

    spheres = [sc.sphere(s["center"], float(s["radius"]), int(s["material"]),
                         int(s.get("light", -1)))
               for s in doc.get("spheres", [])]

    mesh = None
    mesh_docs = doc.get("meshes", [])
    if mesh_docs:
        from tpu_pathtracer_torch.models import meshes
        from tpu_pathtracer_torch.models.mesh import build_bvh

        parts = [_mesh_part(i, m, base_dir) for i, m in enumerate(mesh_docs)]
        v, f, uv, mids = meshes.merge(*parts)
        mesh = build_bvh(v, f, uv, mids, device=device)

    lights = []
    for i, l in enumerate(doc.get("lights", [])):
        t = l.get("type", "area")
        if t == "area":
            lights.append(sc.area_light(int(l["prim"]), l["intensity"]))
        elif t == "point":
            lights.append(sc.point_light(l["pos"], l["intensity"]))
        elif t == "tri":
            lights.append(sc.tri_light(int(l["material"]), l["intensity"]))
        else:
            raise ValueError(f"light {i}: unknown type {t!r}")

    cam = doc.get("camera", {})
    cam_spec = dict(
        eye=cam.get("eye", [0, 0, 5]),
        look_at=cam.get("look_at", [0, 0, 0]),
        up=cam.get("up", [0, 1, 0]),
        fov=float(cam.get("fov", 60.0)),
        lens_radius=float(cam.get("lens_radius", 0.0)),
        focal_distance=float(cam.get("focal_distance", 0.0)),
    )
    return sc.make_scene(spheres, materials, lights, mesh=mesh,
                         device=device), cam_spec


def load_scene(path: str, *, device="cuda") -> tuple[sc.Scene, dict]:
    with open(path) as f:
        return scene_from_dict(
            json.load(f), base_dir=os.path.dirname(os.path.abspath(path)),
            device=device)


def scene_to_dict(scene: sc.Scene, cam_spec: dict | None = None) -> dict:
    """Serialize a Scene back to the JSON document format.

    Mesh geometry does not round-trip (the Scene holds a built BVH, not the
    source declarations), so mesh scenes are refused rather than written
    without their geometry.
    """
    if scene.mesh is not None:
        raise ValueError(
            "mesh scenes do not serialize back to JSON; keep their source "
            "scene documents")
    mat_type = scene.mat_type.cpu().numpy()
    mat_color = scene.mat_color.cpu().numpy()
    mat_coef = scene.mat_coef.cpu().numpy()
    mats = [{"type": _MAT_NAMES[int(mat_type[i])],
             "color": mat_color[i].tolist(), "coef": float(mat_coef[i])}
            for i in range(min(len(mat_type), _n_real_mats(scene)))]
    centers = scene.centers.cpu().numpy()
    radii = scene.radii.cpu().numpy()
    material_id = scene.material_id.cpu().numpy()
    light_id = scene.light_id.cpu().numpy()
    spheres = []
    for i in range(scene.num_prims):
        spheres.append({
            "center": centers[i].tolist(),
            "radius": float(radii[i]),
            "material": int(material_id[i]),
            **({"light": int(light_id[i])} if int(light_id[i]) >= 0 else {}),
        })
    light_type = scene.light_type.cpu().numpy()
    light_prim = scene.light_prim.cpu().numpy()
    light_pos = scene.light_pos.cpu().numpy()
    intensity = scene.light_intensity.cpu().numpy()
    lights = []
    for i in range(scene.num_lights):
        if int(light_type[i]) == sc.AREA_LIGHT:
            lights.append({"type": "area", "prim": int(light_prim[i]),
                           "intensity": intensity[i].tolist()})
        else:
            lights.append({"type": "point", "pos": light_pos[i].tolist(),
                           "intensity": intensity[i].tolist()})
    doc: dict[str, Any] = {"materials": mats, "spheres": spheres,
                           "lights": lights}
    if cam_spec:
        doc["camera"] = cam_spec
    return doc


def _n_real_mats(scene: sc.Scene) -> int:
    """Count the materials before the padding (padding rows are zeroed
    diffuse): one past the largest material id of a sphere."""
    used = set(scene.material_id[: scene.num_prims].cpu().tolist())
    return max(used) + 1 if used else 0


def save_scene(path: str, scene: sc.Scene, cam_spec: dict | None = None
               ) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, cam_spec), f, indent=2)
