"""Mesh constructors: boxes, quads, UV spheres, OBJ files, terrain,
merging, textures, in NumPy.

Counterpart of ``tpu_pathtracer/models/meshes.py``: the geometry of the mesh
Cornell scenes, of the textured terrain (BASELINE config 4) and of scene
files (``io/scene_io.py``). Every builder gives the JAX package's arrays bit
for bit.
"""
from __future__ import annotations

import numpy as np


def box(center, size, rotation_y: float = 0.0):
    """Axis-aligned box (optionally rotated about +y): 8 verts, 12 tris.

    Returns (vertices (8,3), faces (12,3), uvs (8,2)).
    """
    c = np.asarray(center, np.float64)
    s = np.asarray(size, np.float64) * 0.5
    corners = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    ) * s
    if rotation_y:
        ct, st = np.cos(rotation_y), np.sin(rotation_y)
        rot = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]])
        corners = corners @ rot.T
    verts = corners + c
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # back  (z-)
            [4, 5, 6], [4, 6, 7],  # front (z+)
            [0, 1, 5], [0, 5, 4],  # bottom
            [3, 7, 6], [3, 6, 2],  # top
            [0, 4, 7], [0, 7, 3],  # left
            [1, 2, 6], [1, 6, 5],  # right
        ],
        np.int64,
    )
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float64)
    return verts, faces, uvs


def quad(p0, p1, p2, p3):
    """Planar quad from 4 corners (ccw): 2 triangles with unit-square uvs."""
    verts = np.asarray([p0, p1, p2, p3], np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    return verts, faces, uvs


def uv_sphere(center, radius, n_lat: int = 32, n_lon: int = 64):
    """Triangulated sphere: ~2 n_lat n_lon triangles with spherical uvs.
    Returns (vertices, faces, uvs)."""
    c = np.asarray(center, np.float64)
    lats = np.linspace(0, np.pi, n_lat + 1)
    lons = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, uvs = [], []
    for th in lats:
        for ph in lons:
            verts.append(c + radius * np.array(
                [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)]))
            uvs.append([ph / (2 * np.pi), th / np.pi])
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            cc = (i + 1) * n_lon + j
            dd = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, cc])
            if i < n_lat - 1:
                faces.append([b, dd, cc])
    return np.asarray(verts), np.asarray(faces, np.int64), np.asarray(uvs)


def load_obj(path: str):
    """Minimal OBJ parser: ``v``, ``vt`` and ``f`` records, polygons
    fan-triangulated. A vertex shared by faces with different ``vt`` keeps
    the last one. Returns (vertices, faces, uvs)."""
    verts, uvs, faces, face_uvs = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx, tdx = [], []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    idx.append(int(comp[0]) - 1)
                    tdx.append(int(comp[1]) - 1
                               if len(comp) > 1 and comp[1] else -1)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    face_uvs.append([tdx[0], tdx[k], tdx[k + 1]])
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    uv_arr = np.zeros((len(verts), 2))
    if uvs:
        uvsrc = np.asarray(uvs, np.float64)
        for f, fu in zip(faces, face_uvs):
            for vi, ti in zip(f, fu):
                if ti >= 0:
                    uv_arr[vi] = uvsrc[ti]
    return verts, faces, uv_arr


def merge(*parts):
    """Concatenate (verts, faces, uvs[, mat_id]) tuples into one mesh.

    Each part is (verts, faces, uvs) or (verts, faces, uvs, material_id);
    returns (verts, faces, uvs, material_ids).
    """
    verts_all, faces_all, uvs_all, mats_all = [], [], [], []
    off = 0
    for part in parts:
        if len(part) == 4:
            v, f, u, m = part
        else:
            v, f, u = part
            m = 0
        verts_all.append(v)
        faces_all.append(np.asarray(f) + off)
        uvs_all.append(u)
        mats_all.append(np.full((len(f),), m, np.int64))
        off += len(v)
    return (
        np.concatenate(verts_all),
        np.concatenate(faces_all),
        np.concatenate(uvs_all),
        np.concatenate(mats_all),
    )


def terrain(n: int = 224, extent: float = 100.0, height: float = 12.0,
            seed: int = 0):
    """Procedural heightfield, 2 (n-1)^2 triangles with planar uvs: a few
    octaves of smoothstep-upsampled value noise. Returns (vertices, faces,
    uvs)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n))
    for octave in range(5):
        k = 4 * (2 ** octave)
        g = rng.standard_normal((k + 1, k + 1)) / (1.7 ** octave)
        xs = np.linspace(0, k, n)
        x0 = np.floor(xs).astype(int).clip(0, k - 1)
        fx = xs - x0
        w = fx * fx * (3 - 2 * fx)
        row = g[x0, :] * (1 - w[:, None]) + g[x0 + 1, :] * w[:, None]
        col = row[:, x0] * (1 - w[None, :]) + row[:, x0 + 1] * w[None, :]
        h += col
    h *= height / max(1e-9, np.abs(h).max())

    xs = np.linspace(-extent / 2, extent / 2, n)
    zz, xx = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([xx.ravel(), h.ravel(), zz.ravel()], axis=-1)
    uu, vv = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    uvs = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    # two triangles per grid cell, row-major, as the JAX package orders them
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a, b = (i * n + j).ravel(), ((i + 1) * n + j).ravel()
    faces = np.stack([np.stack([a, b, a + 1], -1),
                      np.stack([a + 1, b, b + 1], -1)], axis=1)
    return verts, faces.reshape(-1, 3).astype(np.int64), uvs


def checker_texture(n: int = 256, tiles: int = 8, c0=(0.9, 0.9, 0.9),
                    c1=(0.2, 0.3, 0.6)) -> np.ndarray:
    """(n, n, 3) float32 checkerboard of ``tiles`` x ``tiles`` squares."""
    ij = np.arange(n) * tiles // n
    mask = (ij[:, None] + ij[None, :]) % 2
    tex = np.where(mask[..., None] == 0, np.asarray(c0), np.asarray(c1))
    return tex.astype(np.float32)
