// Packet BVH query kernel for Hopper (sm_90a): kernel 5 of the port.
//
// Replaces: tpu_pathtracer/ops/pallas/mesh_kernel.py::_packet_kernel
// (launched by _run_packet, via intersect_mesh_packet), the closest-hit or
// any-hit query of one wavefront wave against the fine packed tree. Its
// plain PyTorch version is ops/kernels/mesh_kernel.py::packet_ref.
//
// Contract, per ray: a lane with t_init <= 0 is dead and returns t = 0 at
// once. A live lane walks the skip-link tree (PackedMesh: flat node boxes
// [min3 max3], meta [skip start count], 16-float triangle slots) from
// t = t_init, descends a node whose box it enters before its current t,
// tests a leaf's triangles with Moller-Trumbore in slot order and keeps a
// strictly closer hit (t, slot). In any-hit mode the first triangle closer
// than t_init sets t = 0 and ends the walk. After the walk the normal
// (cross(e1, e2) normalized), the uv (from the barycentrics) and the
// material of the winning slot are resolved from its row, the JAX package's
// defer_attrs route; they are 0 where nothing closer was found. The TPU
// kernel's hint-first restart (each tile first walks the fine subtree of
// its coarse cells) is an ordering aid that does not change the result;
// this kernel walks every lane from the root and takes no hints.
//
// What bounds it on this card: the node and triangle tests per ray (each
// about 22 and 45 f32 operations, every node and slot read through the
// read-only cache), and divergence between the 32 lanes of a warp: a warp
// runs until its longest walk ends, and lanes that take different subtrees
// serialize. The TPU kernel's shape (one shared walk per tile of 2048
// lanes, paired walks, leaf queues, an SMEM node budget) answers a scalar
// unit and an any-lane reduction per node step; none of it is carried over.
// What groups similar rays into a warp is the caller's sort
// (packet_sort_key, or the two-pass sort by coarse cell, octant and entry
// depth), which runs before the launch; one wave is one launch.
//
// Rounding: built without FMA contraction (-fmad=false, ops/kernels/
// _build.py SOURCE_FLAGS), so that every product and sum rounds as the
// plain version's PyTorch ops do: the kernel then returns the plain
// version's t, slot and attributes bit for bit. Built with contraction it
// is 4-6% faster per launch at BASELINE config 4 but fails two of the
// bars it is held to (utils/metrics.py::packet_agreement; measured by
// utils/packet_fmad.py on an H100 80GB HBM3 at 700 W): on lanes whose hit
// agrees, t differs by up to 1.66 times its allowance of 1e-5 * max(1, t)
// (7.1e-4 at most), and the normal and uv by up to 7.4e-6 where they must
// be equal.
//
// C interface (loaded with ctypes): tpt_packet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;

struct PacketParams {
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* t_init;  // (n,)
  const float* boxes;   // (n_nodes * 6,)
  const int* meta;      // (n_nodes * 3,)
  const float* slots;   // (slots * 16,)
  int n, n_nodes;
  float tmin;
  float* t;
  int* slot;
  float* nrm;  // (n, 3)
  float* uv;   // (n, 2)
  int* mat;
};

__device__ __forceinline__ float safe_inv(float a) {
  float s = fabsf(a) > 1e-12f ? a : (a >= 0.f ? 1e-12f : -1e-12f);
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Walk the whole skip-link tree from the root; an any-hit walk ends at the
// first occluder with t = 0.
template <bool ANY>
__device__ void walk(const PacketParams& p, const Ray& r, float& t,
                     int& slot) {
  int n = 0;
  while (n < p.n_nodes) {
    const float* b = p.boxes + 6 * n;
    float tx0 = (__ldg(b + 0) - r.ox) * r.ix;
    float tx1 = (__ldg(b + 3) - r.ox) * r.ix;
    float ty0 = (__ldg(b + 1) - r.oy) * r.iy;
    float ty1 = (__ldg(b + 4) - r.oy) * r.iy;
    float tz0 = (__ldg(b + 2) - r.oz) * r.iz;
    float tz1 = (__ldg(b + 5) - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                     fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                     fmaxf(tz0, tz1));
    bool box_hit = tn <= tf && tf > p.tmin && tn < t;
    const int* m = p.meta + 3 * n;
    int skip = __ldg(m + 0), count = __ldg(m + 2);
    if (box_hit && count > 0) {
      int start = __ldg(m + 1);
      for (int k = 0; k < count; ++k) {
        const float4* s =
            reinterpret_cast<const float4*>(p.slots + (size_t)(start + k) * 16);
        float4 a = __ldg(s), bb = __ldg(s + 1), c = __ldg(s + 2);
        float v0x = a.x, v0y = a.y, v0z = a.z;
        float e1x = a.w, e1y = bb.x, e1z = bb.y;
        float e2x = bb.z, e2y = bb.w, e2z = c.x;
        float px = r.dy * e2z - r.dz * e2y;
        float py = r.dz * e2x - r.dx * e2z;
        float pz = r.dx * e2y - r.dy * e2x;
        float det = e1x * px + e1y * py + e1z * pz;
        float inv_det = 1.0f / det;
        float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
        float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
        float qx = tvy * e1z - tvz * e1y;
        float qy = tvz * e1x - tvx * e1z;
        float qz = tvx * e1y - tvy * e1x;
        float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        // det == 0 gives inf/NaN, which every compare below rejects
        if (uu >= 0.f && vv >= 0.f && uu + vv <= 1.f && tt > p.tmin &&
            tt < t) {
          if (ANY) {
            t = 0.f;
            return;
          }
          t = tt;
          slot = start + k;
        }
      }
    }
    n = (box_hit && count == 0) ? n + 1 : skip;
  }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) packet_kernel(PacketParams p) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= p.n) return;
  float t0 = p.t_init[i];
  float t = 0.f;
  int slot = 0;
  bool found = false;
  Ray r;
  r.ox = p.o[3 * i];
  r.oy = p.o[3 * i + 1];
  r.oz = p.o[3 * i + 2];
  r.dx = p.d[3 * i];
  r.dy = p.d[3 * i + 1];
  r.dz = p.d[3 * i + 2];
  if (t0 > 0.f) {
    t = t0;
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    walk<ANY>(p, r, t, slot);
    found = !ANY && t < t0;
  }
  float nx = 0.f, ny = 0.f, nz = 0.f, tu = 0.f, tv = 0.f;
  int mat = 0;
  if (found) {
    const float4* s =
        reinterpret_cast<const float4*>(p.slots + (size_t)slot * 16);
    float4 a = __ldg(s), bb = __ldg(s + 1), c = __ldg(s + 2), e = __ldg(s + 3);
    float v0x = a.x, v0y = a.y, v0z = a.z;
    float e1x = a.w, e1y = bb.x, e1z = bb.y;
    float e2x = bb.z, e2y = bb.w, e2z = c.x;
    float gx = e1y * e2z - e1z * e2y;
    float gy = e1z * e2x - e1x * e2z;
    float gz = e1x * e2y - e1y * e2x;
    float nlen = sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-20f));
    nx = gx / nlen;
    ny = gy / nlen;
    nz = gz / nlen;
    float px = r.dy * e2z - r.dz * e2y;
    float py = r.dz * e2x - r.dx * e2z;
    float pz = r.dx * e2y - r.dy * e2x;
    float det = e1x * px + e1y * py + e1z * pz;
    float inv_det = 1.0f / (fabsf(det) > 1e-12f ? det : 1.0f);
    float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
    float qx = tvy * e1z - tvz * e1y;
    float qy = tvz * e1x - tvx * e1z;
    float qz = tvx * e1y - tvy * e1x;
    float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    // slot row: c = (e2z, mat, uv0.u, uv0.v), e = (uv_e1 uv, uv_e2 uv)
    tu = c.z + uu * e.x + vv * e.z;
    tv = c.w + uu * e.y + vv * e.w;
    mat = (int)c.y;
  }
  p.t[i] = t;
  p.slot[i] = found ? slot : 0;
  p.nrm[3 * i] = nx;
  p.nrm[3 * i + 1] = ny;
  p.nrm[3 * i + 2] = nz;
  p.uv[2 * i] = tu;
  p.uv[2 * i + 1] = tv;
  p.mat[i] = mat;
}

}  // namespace

extern "C" {

// One packet query on `stream`. o, d (n x 3), t_init (n), the packed
// tree's boxes (n_nodes x 6), meta (n_nodes x 3) and slots (16 floats
// each) and the outputs t, slot, nrm (n x 3), uv (n x 2), mat are device
// pointers.
// Returns the first CUDA error (0 on success).
int tpt_packet(const float* o, const float* d, const float* t_init,
               const float* boxes, const int* meta, const float* slots,
               int n_nodes, int n,
               float tmin, int any_hit, float* t, int* slot, float* nrm,
               float* uv, int* mat, void* stream) {
  if (n <= 0 || n_nodes <= 0 || !o || !d || !t_init ||
      !boxes || !meta || !slots || !t || !slot || !nrm || !uv || !mat)
    return (int)cudaErrorInvalidValue;
  PacketParams p;
  p.o = o;
  p.d = d;
  p.t_init = t_init;
  p.boxes = boxes;
  p.meta = meta;
  p.slots = slots;
  p.n = n;
  p.n_nodes = n_nodes;
  p.tmin = tmin;
  p.t = t;
  p.slot = slot;
  p.nrm = nrm;
  p.uv = uv;
  p.mat = mat;
  cudaStream_t st = (cudaStream_t)stream;
  int blocks = (n + BLOCK - 1) / BLOCK;
  if (any_hit)
    packet_kernel<true><<<blocks, BLOCK, 0, st>>>(p);
  else
    packet_kernel<false><<<blocks, BLOCK, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
