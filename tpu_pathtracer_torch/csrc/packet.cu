// Packet BVH query kernel for Hopper (sm_90a): kernel 5 of the port.
//
// Replaces: tpu_pathtracer/ops/pallas/mesh_kernel.py::_packet_kernel
// (launched by _run_packet, via intersect_mesh_packet), the closest-hit or
// any-hit query of one wavefront wave. Its plain PyTorch version is
// ops/kernels/mesh_kernel.py::packet_bvh_ref; the TPU kernel's own contract,
// a walk of the 64-triangle-leaf tree, is packet_ref, which the kernel is
// also held to (by triangle id, at utils/metrics.py::packet_agreement's
// bars).
//
// Contract, per ray: a lane with t_init <= 0 is dead and returns t = 0 at
// once, reading neither its origin nor its direction. A live lane walks
// pack_bvh's tree (the mesh's own tree in DFS order, leaves of <= 4
// triangles or one leaf for a mesh of <= 40; 32-byte nodes min3 skip | max3
// leaf; 16-float triangle slots in MeshData order) from t = t_init through
// pt_common.cuh::bvh_walk, the walk of kernels 1, 3 and 4: a node whose box
// it enters before t (far slab times ROBUST, pruned only past t times
// PRUNE) is descended into, a leaf's triangles are tested with
// Moller-Trumbore in slot order and a strictly closer hit is kept, so an
// equal t goes to the lower triangle id. The walk keeps only the winner's
// slot (SLOT_ONLY), which is its MeshData triangle id since pack_bvh's
// slots are in that order; after the walk the kernel resolves the normal
// (cross(e1, e2) normalized), the uv (Moller-Trumbore's barycentrics) and
// the material from the slot's row, the JAX package's defer_attrs route.
// The attributes are 0 where nothing closer was found (kept through the
// walk, as kernels 1, 3 and 4 keep them, they cost this kernel 14
// registers and 8% on a closest-hit wave). In any-hit mode the first triangle closer than
// t_init sets t = 0 and ends the walk, and t is the kernel's only output:
// the query has no attributes. The TPU kernel's hint-first restart (each tile first
// walks the fine subtree of its coarse cells) is an ordering aid that does
// not change the result; this kernel walks every lane from the root and
// takes no hints.
//
// The wave's order: with a permutation (the caller's coherence sort, by
// packet_sort_key or by coarse cell, octant and entry depth), thread i takes
// ray perm[i], reads its origin, direction and t_init there and writes its
// answers there, so that the rays of a warp are the sort's neighbours while
// the caller's tensors stay in wave order: no gathered copy of the rays and
// no scatter of the answers runs around the launch. An index outside the
// wave traps, so the launch reports an error. One wave is one launch.
//
// What bounds it on this card: latency. Every node visit is a dependent
// read, the 32 lanes of a warp diverge over the tree (a warp runs until its
// longest walk ends), and the card has no ray-tracing units that the port
// may use. The TPU kernel's shape (one shared walk per tile of 2048 lanes
// over 64-triangle leaves, tested on the MXU; paired walks, leaf queues, an
// SMEM node budget) answers a scalar unit and an any-lane reduction per node
// step; none of it is carried over. Here each thread walks its own ray over
// the small-leaf tree: a terrain segment tests ~10 triangles and ~25 boxes
// there, against ~80 triangles of the 64-leaf tree.
//
// Rounding: built without FMA contraction (-fmad=false, ops/kernels/
// _build.py SOURCE_FLAGS), so that every product and sum rounds as the
// plain version's PyTorch ops do: the kernel then returns packet_bvh_ref's
// t, slot and attributes bit for bit. tmin is the caller's (the box test's
// far bound and the triangle test's near bound), not pt_common.cuh's TMIN.
//
// C interface (loaded with ctypes): tpt_packet.

#include "pt_common.cuh"

namespace {

constexpr int BLOCK = 128;

struct PacketParams {
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* t_init;  // (n,)
  const int* perm;      // (n,) or null: thread i takes ray perm[i]
  MeshView mesh;        // pack_bvh's nodes and slots (no tables)
  int n;
  float tmin;
  float* t;
  int* slot;   // closest hit only, as nrm, uv and mat
  float* nrm;  // (n, 3)
  float* uv;   // (n, 2)
  int* mat;
};

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) packet_kernel(PacketParams p) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= p.n) return;
  const int k = p.perm ? __ldg(p.perm + i) : i;
  if ((unsigned)k >= (unsigned)p.n) __trap();  // not a permutation
  const float t0 = __ldg(p.t_init + k);
  if (!(t0 > 0.f)) {  // a dead lane
    p.t[k] = 0.f;
    if (!ANY) {
      p.slot[k] = 0;
      p.nrm[3 * k] = p.nrm[3 * k + 1] = p.nrm[3 * k + 2] = 0.f;
      p.uv[2 * k] = p.uv[2 * k + 1] = 0.f;
      p.mat[k] = 0;
    }
    return;
  }
  const float ox = __ldg(p.o + 3 * k), oy = __ldg(p.o + 3 * k + 1),
              oz = __ldg(p.o + 3 * k + 2);
  const float dx = __ldg(p.d + 3 * k), dy = __ldg(p.d + 3 * k + 1),
              dz = __ldg(p.d + 3 * k + 2);
  float gx, gy, gz, tu, tv;  // not kept by the walk
  int mat, slot = 0;
  const float t = bvh_walk<ANY, false, true>(p.mesh, ox, oy, oz, dx, dy, dz,
                                             t0, gx, gy, gz, mat, tu, tv,
                                             p.tmin, &slot);
  p.t[k] = t;
  if (ANY) return;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  tu = tv = 0.f;
  mat = 0;
  if (t < t0) {  // the winner's attributes, from its slot
    const float4* s = reinterpret_cast<const float4*>(
        p.mesh.tris + (size_t)slot * TRI_STRIDE);
    const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2),
                 e = __ldg(s + 3);
    const float3 g = slot_normal(a, b, c);
    const float nlen =
        sqrtf(fmaxf(g.x * g.x + g.y * g.y + g.z * g.z, 1e-20f));
    nx = g.x / nlen;
    ny = g.y / nlen;
    nz = g.z / nlen;
    float uu, vv, tt;
    moller_trumbore(ox, oy, oz, dx, dy, dz, a, b, c, uu, vv, tt);
    // slot row: c = (e2z, mat, uv0.u, uv0.v), e = (uv_e1 uv, uv_e2 uv)
    tu = c.z + uu * e.x + vv * e.z;
    tv = c.w + uu * e.y + vv * e.w;
    mat = (int)c.y;
  }
  p.slot[k] = slot;
  p.nrm[3 * k] = nx;
  p.nrm[3 * k + 1] = ny;
  p.nrm[3 * k + 2] = nz;
  p.uv[2 * k] = tu;
  p.uv[2 * k + 1] = tv;
  p.mat[k] = mat;
}

}  // namespace

extern "C" {

// One packet query on `stream`. o, d (n x 3), t_init (n), perm (n int32, or
// null for the wave's own order), pack_bvh's nodes (n_nodes x 8 floats) and
// triangle slots (TRI_STRIDE floats each) and the outputs t, slot, nrm
// (n x 3), uv (n x 2), mat are device pointers; an any-hit query writes t
// alone and may pass null for the others.
// Returns the first CUDA error (0 on success).
int tpt_packet(const float* o, const float* d, const float* t_init,
               const int* perm, const float* nodes, const float* tris,
               int n_nodes, int n, float tmin, int any_hit, float* t,
               int* slot, float* nrm, float* uv, int* mat, void* stream) {
  if (n <= 0 || n_nodes <= 0 || !o || !d || !t_init || !nodes || !tris ||
      !t || (!any_hit && (!slot || !nrm || !uv || !mat)))
    return (int)cudaErrorInvalidValue;
  PacketParams p;
  p.o = o;
  p.d = d;
  p.t_init = t_init;
  p.perm = perm;
  p.mesh.nodes = reinterpret_cast<const float4*>(nodes);
  p.mesh.tris = tris;
  p.mesh.mats = nullptr;
  p.mesh.tl = nullptr;
  p.mesh.n_nodes = n_nodes;
  p.n = n;
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
