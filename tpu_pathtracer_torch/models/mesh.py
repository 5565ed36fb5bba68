"""Triangle meshes and their threaded BVH, as flat tensors.

Counterpart of ``tpu_pathtracer/models/mesh.py``. The BVH is threaded
(stackless): nodes are laid out in DFS order with a ``skip`` link, so a
traversal is ``node = hit ? node + 1 : skip[node]``. Leaves hold up to
``leaf_size`` contiguous triangles, reordered at build time; triangles are
stored as (v0, e1, e2) with per-triangle normal, uvs and material.

``build_bvh`` takes the host binned-SAH builder (``native/bvh.py``, C++)
by default, as the JAX package does, and gives the JAX package's trees and
triangle order bit for bit; ``use_native=False`` takes the NumPy median
split on the longest centroid axis (JAX's ``use_native=False``).
``mesh_from_numpy`` carries a built JAX mesh across unchanged.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Mapping

import numpy as np
import torch
from torch import Tensor

LEAF_SIZE = 4

# Tensor fields of MeshData, in the JAX MeshData's names.
ARRAY_FIELDS = (
    "v0", "e1", "e2", "n_geom", "uv0", "uv_e1", "uv_e2", "material_id",
    "node_min", "node_max", "node_skip", "node_start", "node_count",
    "nodes_packed", "tris_packed",
)
_INT_FIELDS = ("material_id", "node_skip", "node_start", "node_count")


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Flattened mesh + BVH (T triangles in leaf order, M nodes in DFS
    order)."""

    v0: Tensor  # (T, 3)
    e1: Tensor  # (T, 3) v1 - v0
    e2: Tensor  # (T, 3) v2 - v0
    n_geom: Tensor  # (T, 3) unit geometric normal
    uv0: Tensor  # (T, 2)
    uv_e1: Tensor  # (T, 2)
    uv_e2: Tensor  # (T, 2)
    material_id: Tensor  # (T,) int32
    node_min: Tensor  # (M, 3)
    node_max: Tensor  # (M, 3)
    node_skip: Tensor  # (M,) int32: next node on a miss or after a leaf
    node_start: Tensor  # (M,) int32: first triangle of a leaf
    node_count: Tensor  # (M,) int32: triangle count, 0 for inner nodes
    nodes_packed: Tensor  # (M, 12) f32: min3 max3 skip start count pad3
    tris_packed: Tensor  # (T, 12) f32: v0 e1 e2 pad3
    num_tris: int = 0
    num_nodes: int = 0
    leaf_size: int = LEAF_SIZE

    def to(self, device) -> "MeshData":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


def mesh_from_numpy(arrays: Mapping[str, np.ndarray], *,
                    leaf_size: int = LEAF_SIZE, device="cuda") -> MeshData:
    """A MeshData from the array fields (numpy) of a built mesh, such as a
    JAX ``MeshData``, so both packages walk the same tree."""
    tensors = {}
    for f in ARRAY_FIELDS:
        a = np.asarray(arrays[f])
        a = a.astype(np.int32 if f in _INT_FIELDS else np.float32)
        tensors[f] = torch.tensor(a, device=device)
    return MeshData(**tensors, num_tris=int(tensors["v0"].shape[0]),
                    num_nodes=int(tensors["node_min"].shape[0]),
                    leaf_size=int(leaf_size))


def build_bvh(
    vertices: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (T, 3) int
    uvs: np.ndarray | None = None,  # (V, 2)
    material_id: np.ndarray | int = 0,
    leaf_size: int = LEAF_SIZE,
    use_native: bool = True,
    *,
    device="cuda",
) -> MeshData:
    """Build the threaded BVH over a triangle mesh on the host: by the C++
    binned-SAH builder (``native/bvh.py``), which raises where it cannot be
    built rather than fall back, or with ``use_native=False`` by the NumPy
    median split on the longest centroid axis. Both emit the same threaded
    DFS layout, and each equals the JAX package's builder of that name."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    T = faces.shape[0]
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    if uvs is None:
        uvs = np.zeros((vertices.shape[0], 2), np.float64)
    else:
        uvs = np.asarray(uvs, np.float64)
    if np.isscalar(material_id):
        material_id = np.full((T,), material_id, np.int64)
    else:
        material_id = np.asarray(material_id, np.int64)

    if use_native:
        from tpu_pathtracer_torch.native import bvh as native_bvh

        perm, nmin, nmax, nskip, nstart, ncount = native_bvh.build_arrays(
            tri_min.astype(np.float32), tri_max.astype(np.float32),
            centroid.astype(np.float32), leaf_size)
        return _finalize(v0, v1, v2, uvs, faces, material_id,
                         perm.astype(np.int64), nmin, nmax, nskip, nstart,
                         ncount, leaf_size=leaf_size, device=device)

    order: list[int] = []  # triangle permutation (leaf order)
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_start: list[int] = []
    nodes_count: list[int] = []
    nodes_end: list[int] = []  # index of the node AFTER this subtree (skip)

    def rec(idx: np.ndarray) -> None:
        """Emit the subtree over triangle indices `idx`; DFS order."""
        me = len(nodes_min)
        nodes_min.append(tri_min[idx].min(axis=0))
        nodes_max.append(tri_max[idx].max(axis=0))
        if len(idx) <= leaf_size:
            nodes_start.append(len(order))
            nodes_count.append(len(idx))
            nodes_end.append(0)
            order.extend(idx.tolist())
            nodes_end[me] = len(nodes_min)
            return
        nodes_start.append(0)
        nodes_count.append(0)
        nodes_end.append(0)
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = len(idx) // 2
        part = np.argpartition(c[:, axis], mid)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])
        nodes_end[me] = len(nodes_min)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    return _finalize(
        v0, v1, v2, uvs, faces, material_id, np.asarray(order, np.int64),
        np.stack(nodes_min), np.stack(nodes_max), np.asarray(nodes_end),
        np.asarray(nodes_start), np.asarray(nodes_count),
        leaf_size=leaf_size, device=device,
    )


def _finalize(v0, v1, v2, uvs, faces, material_id, perm, node_min, node_max,
              node_skip, node_start, node_count, *, leaf_size, device
              ) -> MeshData:
    """Reorder triangles into leaf order and pack the MeshData."""
    v0o, v1o, v2o = v0[perm], v1[perm], v2[perm]
    e1o = v1o - v0o
    e2o = v2o - v0o
    n = np.cross(e1o, e2o)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    uv0o = uvs[faces[perm, 0]]
    uv1o = uvs[faces[perm, 1]]
    uv2o = uvs[faces[perm, 2]]

    M = int(node_min.shape[0])
    nodes_packed = np.zeros((M, 12), np.float32)
    nodes_packed[:, 0:3] = node_min
    nodes_packed[:, 3:6] = node_max
    nodes_packed[:, 6] = node_skip
    nodes_packed[:, 7] = node_start
    nodes_packed[:, 8] = node_count
    tris_packed = np.zeros((perm.shape[0], 12), np.float32)
    tris_packed[:, 0:3] = v0o
    tris_packed[:, 3:6] = e1o
    tris_packed[:, 6:9] = e2o

    return mesh_from_numpy(dict(
        v0=v0o, e1=e1o, e2=e2o, n_geom=n, uv0=uv0o, uv_e1=uv1o - uv0o,
        uv_e2=uv2o - uv0o, material_id=material_id[perm], node_min=node_min,
        node_max=node_max, node_skip=node_skip, node_start=node_start,
        node_count=node_count, nodes_packed=nodes_packed,
        tris_packed=tris_packed), leaf_size=leaf_size, device=device)
