"""Plain PyTorch version of the in-kernel threaded-DFS BVH walk.

Counterpart of ``tpu_pathtracer/ops/pallas/_walk.py::make_mesh_walk``, the
walk that both TPU persistent kernels trace, with its semantics kept
exactly: the whole tile of ``tile_rows x 128`` lanes walks ONE shared node
sequence over the packed mesh (``ops/kernels/mesh_kernel.py::pack_mesh``);
a subtree is entered, and a leaf tested, when ANY live lane of the tile hits
its box; each lane is pruned by its own running t, and ``t_init <= 0`` marks
a dead lane. Inside a leaf the triangles are tested in order and a hit wins
only if strictly closer (``tt < t_best``), so the first found wins a tie.

The CUDA kernels walk per thread instead (``csrc/pt_common.cuh``): a thread
enters only the boxes its own ray enters. The two differ only where a
lane's own slab test misses a box whose triangle that ray still hits, an
f32 edge case. The persistent kernels' plain versions call this walk. With
``track_uv`` the closest mode also returns the winner's interpolated texture
uv, as the TPU walk does for textured scenes.
"""
from __future__ import annotations

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import EPSILON
from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
    TRI_STRIDE, TRIS_PER_ROW, PackedMesh,
)


def _safe_inv(a: Tensor) -> Tensor:
    s = torch.where(a.abs() > 1e-12, a,
                    torch.where(a >= 0, 1e-12, -1e-12).to(a.dtype))
    return 1.0 / s


def mesh_walk_ref(packed: PackedMesh, ox: Tensor, oy: Tensor, oz: Tensor,
                  dx: Tensor, dy: Tensor, dz: Tensor, t_init: Tensor, *,
                  tile_rows: int, occlusion: bool = False,
                  track_uv: bool = False, tmin: float = EPSILON):
    """Walk the packed mesh for (rows_total, 128) lane planes.

    Closest mode returns (t, nx, ny, nz, mat): t stays ``t_init`` where no
    triangle is closer, the normal is the winner's unnormalized
    cross(e1, e2) (0 where none) and mat its material id (-1 where none);
    with ``track_uv`` also (u, v), the winner's uv0 + b1 uv_e1 + b2 uv_e2
    from slots 10-15 at its barycentrics (0 where none; JAX ``_walk.py:
    142-157``). Occlusion mode returns t alone, set to 0 at the first
    triangle found in (tmin, t_init); it never tracks uv."""
    shape = ox.shape
    n_tiles = shape[0] // tile_rows

    def tiles(x):
        return x.reshape(n_tiles, -1)

    ox, oy, oz, dx, dy, dz = (tiles(x) for x in (ox, oy, oz, dx, dy, dz))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t = tiles(t_init).clone()
    nx, ny, nz, hu, hv = (torch.zeros_like(t) for _ in range(5))
    track_uv = track_uv and not occlusion
    mat = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)

    M = packed.num_nodes
    boxes = packed.boxes.reshape(-1, 6)
    meta = packed.meta.reshape(-1, 3).to(torch.int64)
    slots = packed.tri_rows.reshape(-1, TRI_STRIDE)
    leaf_slots = max(1, -(-packed.leaf_size // TRIS_PER_ROW)) * TRIS_PER_ROW
    nn = torch.zeros(n_tiles, dtype=torch.int64, device=t.device)
    while M > 0:
        active = nn < M
        if not bool(active.any()):
            break
        nc = torch.clamp_max(nn, M - 1)
        b = boxes[nc]
        tx0 = (b[:, 0:1] - ox) * ix
        tx1 = (b[:, 3:4] - ox) * ix
        ty0 = (b[:, 1:2] - oy) * iy
        ty1 = (b[:, 4:5] - oy) * iy
        tz0 = (b[:, 2:3] - oz) * iz
        tz1 = (b[:, 5:6] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        box_hit = (t > 0.0) & (tn <= tf) & (tf > tmin) & (tn < t)
        anyb = box_hit.any(1) & active
        skip, start, count = meta[nc, 0], meta[nc, 1], meta[nc, 2]
        is_leaf = count > 0
        leaf = anyb & is_leaf
        if bool(leaf.any()):
            # the tiles at a leaf test all its slots at once, (tiles, slot,
            # lane); the first slot of the smallest t wins, as the
            # sequential strictly-closer test in slot order picks it
            ti = leaf.nonzero().squeeze(1)
            js = torch.arange(leaf_slots, device=t.device)
            tr = slots[torch.clamp_max(start[ti, None] + js,
                                       slots.shape[0] - 1)]
            (v0x, v0y, v0z, e1x, e1y, e1z,
             e2x, e2y, e2z) = (tr[:, :, k:k + 1] for k in range(9))
            lox, loy, loz, ldx, ldy, ldz = (x[ti, None, :] for x in
                                            (ox, oy, oz, dx, dy, dz))
            t_l = t[ti]
            px = ldy * e2z - ldz * e2y
            py = ldz * e2x - ldx * e2z
            pz = ldx * e2y - ldy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = det.abs() > 1e-12
            inv_det = 1.0 / torch.where(ok, det, 1.0)
            tvx = lox - v0x
            tvy = loy - v0y
            tvz = loz - v0z
            uu = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            vv = (ldx * qx + ldy * qy + ldz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            valid = ((js[None, :, None] < count[ti, None, None]) & ok
                     & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                     & (tt > tmin) & (tt < t_l[:, None, :]))
            found = valid.any(1)
            if occlusion:
                t[ti] = torch.where(found, 0.0, t_l)
            else:
                best, jb = torch.where(valid, tt, float("inf")).min(1)
                jb = jb[:, None, :]

                def pick(x):
                    return x.expand(-1, -1, jb.shape[-1]).gather(
                        1, jb).squeeze(1)

                w1x, w1y, w1z, w2x, w2y, w2z = (
                    pick(x) for x in (e1x, e1y, e1z, e2x, e2y, e2z))
                t[ti] = torch.where(found, best, t_l)
                for plane, g in ((nx, w1y * w2z - w1z * w2y),
                                 (ny, w1z * w2x - w1x * w2z),
                                 (nz, w1x * w2y - w1y * w2x)):
                    plane[ti] = torch.where(found, g, plane[ti])
                mat[ti] = torch.where(found, pick(tr[:, :, 9:10]).to(
                    torch.int32), mat[ti])
                if track_uv:
                    bu, bv = pick(uu), pick(vv)
                    a = [pick(tr[:, :, k:k + 1]) for k in range(10, 16)]
                    hu[ti] = torch.where(found, a[0] + bu * a[2] + bv * a[4],
                                         hu[ti])
                    hv[ti] = torch.where(found, a[1] + bu * a[3] + bv * a[5],
                                         hv[ti])
        nn = torch.where(active, torch.where(anyb & ~is_leaf, nn + 1, skip),
                         nn)
    if occlusion:
        return t.reshape(shape)
    out = (t, nx, ny, nz, mat) + ((hu, hv) if track_uv else ())
    return tuple(x.reshape(shape) for x in out)
