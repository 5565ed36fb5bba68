// Ray-binning kernel for Hopper (sm_90a): kernel 6 of the port.
//
// Replaces: tpu_pathtracer/ops/pallas/mesh_kernel.py::_bin_kernel (launched
// by bin_rays), the first pass of the two-pass binned traversal. Its plain
// PyTorch version is ops/kernels/mesh_kernel.py::bin_rays_ref.
//
// Contract, per ray: among the coarse tree's C leaf cells (flat boxes
// [min3 max3] and node ids, in DFS order), the cell whose box the ray
// enters nearest, by the clamped entry distance max(tn, 0), among cells it
// enters before t_init; ties go to the first cell in DFS order. The test is
// the JAX kernel's predicate
//   live & tn <= tf & tf > tmin & tn < min(t_init, best) & tn_eff < best.
// Output: the cell's node id and that distance, or (-1, 1e30) for a dead
// lane (t_init <= 0) or a ray that enters no cell: such a ray provably has
// no mesh hit before t_init, and the caller culls it from the fine walk.
//
// What bounds it on this card: the slab tests, C per live ray, about 24 f32
// operations each; it reads 28 bytes per ray and writes 8. The design: one
// thread per ray; each block stages the cell table (24 bytes of box and 4
// of id per cell, about 5 KB at C ~ 180) in shared memory once, and every
// thread of a warp then reads the same cell at the same time, a broadcast.
// A linear sweep has no divergence beyond the live mask, which is why the
// TPU kernel chose it over a tree walk, and it suits a warp as well.
//
// Rounding: built without FMA contraction (-fmad=false, ops/kernels/
// _build.py SOURCE_FLAGS). The slab test has no multiply-add to contract, so
// the flag changes nothing here; it states that the kernel rounds as the
// plain version does, which it equals bit for bit.
//
// C interface (loaded with ctypes): tpt_bin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr float BIG = 1e30f;

struct BinParams {
  const float* o;       // (n, 3)
  const float* d;       // (n, 3)
  const float* t_init;  // (n,)
  const float* boxes;   // (n_cells * 6,)
  const int* ids;       // (n_cells,)
  int n_cells, n;
  float tmin;
  int* cell;
  float* tn;
};

__device__ __forceinline__ float safe_inv(float a) {
  float s = fabsf(a) > 1e-12f ? a : (a >= 0.f ? 1e-12f : -1e-12f);
  return 1.0f / s;
}

__global__ void __launch_bounds__(BLOCK) bin_kernel(BinParams p) {
  extern __shared__ float sh[];
  float* sbox = sh;
  int* sid = reinterpret_cast<int*>(sh + 6 * p.n_cells);
  for (int k = threadIdx.x; k < 6 * p.n_cells; k += BLOCK)
    sbox[k] = p.boxes[k];
  for (int k = threadIdx.x; k < p.n_cells; k += BLOCK) sid[k] = p.ids[k];
  __syncthreads();
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= p.n) return;
  float t0 = p.t_init[i];
  float best = BIG;
  int cell = -1;
  if (t0 > 0.f) {
    float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
    float ix = safe_inv(p.d[3 * i]), iy = safe_inv(p.d[3 * i + 1]),
          iz = safe_inv(p.d[3 * i + 2]);
    for (int c = 0; c < p.n_cells; ++c) {
      const float* b = sbox + 6 * c;
      float tx0 = (b[0] - ox) * ix;
      float tx1 = (b[3] - ox) * ix;
      float ty0 = (b[1] - oy) * iy;
      float ty1 = (b[4] - oy) * iy;
      float tz0 = (b[2] - oz) * iz;
      float tz1 = (b[5] - oz) * iz;
      float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                       fminf(tz0, tz1));
      float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                       fmaxf(tz0, tz1));
      float tn_eff = fmaxf(tn, 0.f);
      if (tn <= tf && tf > p.tmin && tn < fminf(t0, best) && tn_eff < best) {
        best = tn_eff;
        cell = sid[c];
      }
    }
  }
  p.cell[i] = cell;
  p.tn[i] = best;
}

}  // namespace

extern "C" {

// One binning pass on `stream`. o, d (n x 3), t_init (n), the cell boxes
// (n_cells x 6), cell ids (n_cells) and the outputs cell (n, int32) and tn
// (n) are device pointers. Returns the first CUDA error (0 on success).
int tpt_bin(const float* o, const float* d, const float* t_init,
            const float* boxes, const int* ids, int n_cells, int n,
            float tmin, int* cell, float* tn, void* stream) {
  if (n <= 0 || n_cells < 0 || !o || !d || !t_init || !cell || !tn ||
      (n_cells > 0 && !(boxes && ids)))
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)n_cells * (6 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  BinParams p;
  p.o = o;
  p.d = d;
  p.t_init = t_init;
  p.boxes = boxes;
  p.ids = ids;
  p.n_cells = n_cells;
  p.n = n;
  p.tmin = tmin;
  p.cell = cell;
  p.tn = tn;
  int blocks = (n + BLOCK - 1) / BLOCK;
  bin_kernel<<<blocks, BLOCK, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
