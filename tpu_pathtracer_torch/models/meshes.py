"""Mesh constructors: boxes, quads and merging, in NumPy.

Counterpart of ``box``, ``quad`` and ``merge`` in
``tpu_pathtracer/models/meshes.py``, the geometry of the mesh Cornell
scenes. ``uv_sphere``, ``terrain``, ``load_obj`` and ``checker_texture`` are
not ported yet (they serve the textured scenes).
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
