"""Ray-triangle intersection and threaded-BVH traversal (per-lane).

Counterpart of ``tpu_pathtracer/ops/triangle.py``: each lane carries one node
pointer, ``node = hit ? node + 1 : skip[node]``, and every leaf is a
``leaf_size``-unrolled Moller-Trumbore loop, all lanes in lockstep. It walks
an unpacked ``MeshData`` and runs on CPU tensors only: on the card every mesh
query goes through the packet kernel (``ops/kernels/mesh_kernel.py``), so a
CUDA tensor here raises.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.mesh import MeshData
from tpu_pathtracer_torch.ops import vecmath as vm

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class TriHit:
    t: Tensor  # (N,) BIG on a miss
    tri: Tensor  # (N,) int64 triangle index (post-reorder), 0 on a miss
    u: Tensor  # (N,) barycentric u
    v: Tensor  # (N,) barycentric v


def _cpu_only(o: Tensor, who: str) -> None:
    if o.device.type != "cpu":
        raise ValueError(
            f"{who} walks an unpacked mesh on CPU tensors only; on "
            f"{o.device} pack the mesh (models.scene.with_packet_mesh) so the "
            "packet kernel traverses it")


def moller_trumbore(o: Tensor, d: Tensor, v0: Tensor, e1: Tensor, e2: Tensor,
                    tmin: float, t_best: Tensor
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Batched two-sided Moller-Trumbore: (valid, t, u, v)."""
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < t_best))
    return valid, t, u, v


def intersect_mesh(mesh: MeshData, o: Tensor, d: Tensor, tmin: float,
                   tmax: Tensor | float = BIG, any_hit: bool = False
                   ) -> TriHit:
    """Traverse the threaded BVH for N rays (o, d: (N, 3)). ``any_hit``
    retires a lane at its first accepted hit (shadow rays)."""
    _cpu_only(o, "intersect_mesh")
    n = o.shape[0]
    M = mesh.num_nodes
    T = mesh.v0.shape[0]
    safe_d = torch.where(torch.abs(d) > 1e-12, d,
                         torch.where(d >= 0, 1e-12, -1e-12))
    inv_d = 1.0 / safe_d
    t_init = torch.broadcast_to(
        torch.as_tensor(tmax, dtype=o.dtype, device=o.device), (n,))

    node = torch.zeros(n, dtype=torch.int64)
    t_best = t_init.clone()
    idx = torch.zeros(n, dtype=torch.int64)
    uu = torch.zeros(n, dtype=o.dtype)
    vv = torch.zeros(n, dtype=o.dtype)
    while bool(torch.any(node < M)):
        nd = mesh.nodes_packed[torch.clamp_max(node, M - 1)]
        skip = nd[:, 6].to(torch.int64)
        start = nd[:, 7].to(torch.int64)
        count = nd[:, 8].to(torch.int64)
        t0s = (nd[:, 0:3] - o) * inv_d
        t1s = (nd[:, 3:6] - o) * inv_d
        tn = torch.amax(torch.minimum(t0s, t1s), dim=-1)
        tf = torch.amin(torch.maximum(t0s, t1s), dim=-1)
        box_hit = (tn <= tf) & (tf > tmin) & (tn < t_best)
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf
        for j in range(mesh.leaf_size):
            tri = torch.clamp_max(start + j, T - 1)
            td = mesh.tris_packed[tri]
            valid, t, u_, v_ = moller_trumbore(
                o, d, td[:, 0:3], td[:, 3:6], td[:, 6:9], tmin, t_best)
            better = test_leaf & (j < count) & valid
            t_best = torch.where(better, t, t_best)
            idx = torch.where(better, tri, idx)
            uu = torch.where(better, u_, uu)
            vv = torch.where(better, v_, vv)
        active = node < M
        next_node = torch.where(is_leaf | ~box_hit, skip, node + 1)
        if any_hit:
            next_node = torch.where(t_best < t_init, M, next_node)
        node = torch.where(active, next_node, node)
    hit_t = torch.where(t_best < t_init, t_best, BIG)
    return TriHit(t=hit_t, tri=idx, u=uu, v=vv)


def mesh_brute_force_t(mesh: MeshData, o: Tensor, d: Tensor, tmin: float
                       ) -> TriHit:
    """Test every triangle: the O(N*T) oracle of the BVH walk."""
    _cpu_only(o, "mesh_brute_force_t")
    n = o.shape[0]
    t_best = torch.full((n,), BIG, dtype=o.dtype)
    idx = torch.zeros(n, dtype=torch.int64)
    uu = torch.zeros(n, dtype=o.dtype)
    vv = torch.zeros(n, dtype=o.dtype)
    for i in range(mesh.num_tris):
        v0, e1, e2 = (getattr(mesh, f)[i].expand_as(o)
                      for f in ("v0", "e1", "e2"))
        valid, t, u_, v_ = moller_trumbore(o, d, v0, e1, e2, tmin, t_best)
        t_best = torch.where(valid, t, t_best)
        idx = torch.where(valid, torch.full_like(idx, i), idx)
        uu = torch.where(valid, u_, uu)
        vv = torch.where(valid, v_, vv)
    return TriHit(t=t_best, tri=idx, u=uu, v=vv)
