// Ray-binning kernel for Hopper (sm_90a): kernel 6 of the port.
//
// Replaces: tpu_pathtracer/ops/pallas/mesh_kernel.py::_bin_kernel (launched
// by bin_rays), the first pass of the two-pass binned traversal. Its plain
// PyTorch versions are ops/kernels/mesh_kernel.py::bin_rays_ref (the
// contract, the TPU kernel's linear sweep over the cells) and bin_tree_ref
// (this kernel's walk).
//
// Contract, per ray: among the coarse tree's leaf cells (in DFS order), the
// cell whose box the ray enters nearest, by the clamped entry distance
// max(tn, 0), among cells it enters before t_init; ties go to the first
// cell in DFS order. The test is the JAX kernel's predicate
//   live & tn <= tf & tf > tmin & tn < min(t_init, best) & tn_eff < best.
// Output: the cell's node id and that distance, or (-1, 1e30) for a dead
// lane (t_init <= 0) or a ray that enters no cell: such a ray provably has
// no mesh hit before t_init, and the caller culls it from the fine walk.
// The launch also writes the two-pass sort key,
// ((cell * 8 + octant) << 6) | tq with tq = clamp(tn * scale, 0, 63) as
// int32, or 1 << 26 for a ray without a cell (mesh_kernel.py::
// bin_sort_key; scale, the coarse tree's key_scale, is read from the
// device, so the caller makes no host sync).
//
// The walk: a stackless DFS walk of the coarse tree (the walk table of
// mesh_kernel.py::_walk_table: per node min3 skip | max3 leaf), one thread
// per ray. Every node gets the sweep's slab arithmetic and predicate. A
// cell that passes becomes the best (strict < on best, as the sweep); an
// inner node that fails it is pruned: the walk jumps to its skip link.
// Why the answer is the sweep's bit for bit: every box of a subtree lies
// inside the box of its root in f32 (the table widens an inner box that
// would not hold its subtree's). Per axis the slab bound (b - o) * inv is
// monotone in b under round-to-nearest (a subtraction of a constant, then
// a product by inv, which safe_inv keeps finite and nonzero), so a child's
// slab interval lies inside its parent's: down the tree tn only grows and
// tf only shrinks. best only falls as the walk goes on. So if a node fails
// (tn > tf; tf <= tmin; tn >= min(t_init, best); max(tn, 0) >= best), every
// cell under it fails too, under the best it would be tested with in the
// sweep; the cells the walk does test, it tests in DFS order with the same
// best as the sweep, and the first of equal distances still wins.
//
// What bounds it on this card: device memory, 16 bytes per ray (t_init
// read, cell, tn and key written) and 24 more per live ray (o and d read),
// against a few node tests per live ray (about 24 f32 operations each)
// where the sweep made C (128 on the terrain). The design: a grid of as
// many blocks as are resident at once (the launcher passes that count,
// tpt_bin_occupancy) with a grid-stride loop over the rays, so each
// resident block stages the walk table (32 bytes per node, 8 KB at 255
// nodes) into shared memory once, not once per 256 rays; a table past
// 48 KB raises the kernel's dynamic shared-memory limit, and the launcher
// refuses one past the card's 227 KB. The sort key is formed in the
// launch, in place of ten elementwise ops on the whole wave.
//
// Rounding: built without FMA contraction (-fmad=false, ops/kernels/
// _build.py SOURCE_FLAGS). The slab test has no multiply-add to contract;
// the key's product is rounded on its own (__fmul_rn), as torch rounds it.
// The kernel equals both plain versions bit for bit.
//
// C interface (loaded with ctypes): tpt_bin, tpt_bin_occupancy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float BIG = 1e30f;
constexpr int NO_CELL_KEY = 1 << 26;
// dynamic shared memory a kernel may take without raising its limit
constexpr size_t SMEM_DEFAULT = 48 * 1024;

struct BinParams {
  const float* o;          // (n, 3)
  const float* d;          // (n, 3)
  const float* t_init;     // (n,)
  const float4* nodes;     // (n_nodes, 2): min3 skip | max3 leaf
  const float* key_scale;  // () the sort key's depth scale
  int n_nodes, n;
  float tmin;
  int* cell;
  float* tn;
  int* key;
};

__device__ __forceinline__ float safe_inv(float a) {
  float s = fabsf(a) > 1e-12f ? a : (a >= 0.f ? 1e-12f : -1e-12f);
  return 1.0f / s;
}

__global__ void __launch_bounds__(BLOCK)
    bin_kernel(const __grid_constant__ BinParams p) {
  extern __shared__ float4 nodes[];
  for (int k = threadIdx.x; k < 2 * p.n_nodes; k += BLOCK)
    nodes[k] = p.nodes[k];
  __syncthreads();
  const float scale = *p.key_scale;
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < p.n;
       i += gridDim.x * BLOCK) {
    const float t0 = p.t_init[i];
    float best = BIG;
    int cell = -1;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (t0 > 0.f) {
      const float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
      dx = p.d[3 * i];
      dy = p.d[3 * i + 1];
      dz = p.d[3 * i + 2];
      const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
      int k = 0;
      while (k < p.n_nodes) {
        const float4 lo = nodes[2 * k], hi = nodes[2 * k + 1];
        const float tx0 = (lo.x - ox) * ix;
        const float tx1 = (hi.x - ox) * ix;
        const float ty0 = (lo.y - oy) * iy;
        const float ty1 = (hi.y - oy) * iy;
        const float tz0 = (lo.z - oz) * iz;
        const float tz1 = (hi.z - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
        const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fmaxf(tz0, tz1));
        const float tn_eff = fmaxf(tn, 0.f);
        const bool pass = tn <= tf && tf > p.tmin &&
                          tn < fminf(t0, best) && tn_eff < best;
        const bool leaf = __float_as_int(hi.w) != 0;
        if (pass && leaf) {
          best = tn_eff;
          cell = k;
        }
        k = pass && !leaf ? k + 1 : __float_as_int(lo.w);
      }
    }
    int key = NO_CELL_KEY;
    if (cell >= 0) {
      const int octant = (dx < 0.f ? 4 : 0) + (dy < 0.f ? 2 : 0) +
                         (dz < 0.f ? 1 : 0);
      const int tq = (int)fminf(fmaxf(__fmul_rn(best, scale), 0.f), 63.f);
      key = ((cell * 8 + octant) << 6) | tq;
    }
    p.cell[i] = cell;
    p.tn[i] = best;
    p.key[i] = key;
  }
}

size_t table_bytes(int n_nodes) {
  return (size_t)n_nodes * 2 * sizeof(float4);
}

// Lets the kernel take the table's shared memory past the default 48 KB.
cudaError_t allow_smem(size_t smem) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(bin_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// One binning pass on `stream`, in a grid of at most max_blocks blocks
// (those resident at once: the SMs times tpt_bin_occupancy). o, d (n x 3),
// t_init (n), the walk table (n_nodes x 8 floats), key_scale (one float)
// and the outputs cell (n, int32), tn (n) and key (n, int32) are device
// pointers. Returns the first CUDA error (0 on success).
int tpt_bin(const float* o, const float* d, const float* t_init,
            const float* nodes, int n_nodes, int n, float tmin,
            const float* key_scale, int* cell, float* tn, int* key,
            int max_blocks, void* stream) {
  if (n <= 0 || n_nodes < 0 || max_blocks <= 0 || !o || !d || !t_init ||
      !key_scale || !cell || !tn || !key || (n_nodes > 0 && !nodes))
    return (int)cudaErrorInvalidValue;
  BinParams p;
  p.o = o;
  p.d = d;
  p.t_init = t_init;
  p.nodes = reinterpret_cast<const float4*>(nodes);
  p.key_scale = key_scale;
  p.n_nodes = n_nodes;
  p.n = n;
  p.tmin = tmin;
  p.cell = cell;
  p.tn = tn;
  p.key = key;
  const size_t smem = table_bytes(n_nodes);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)n + BLOCK - 1) / BLOCK;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  bin_kernel<<<blocks, BLOCK, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Blocks per SM of the kernel with a walk table of n_nodes nodes in shared
// memory, on the current device, as the card's occupancy calculator gives
// them (-1 on an error).
int tpt_bin_occupancy(int n_nodes) {
  const size_t smem = table_bytes(n_nodes);
  int n = -1;
  if (allow_smem(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bin_kernel, BLOCK,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
