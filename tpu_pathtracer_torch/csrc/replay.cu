// Per-sample fused value-and-grad kernel for Hopper (sm_90a).
//
// Replaces: tpu_pathtracer/ops/pallas/replay_kernel.py::_replay_kernel
// (launched by replay_call), whole: sphere scenes, modes "mse" and "vjp",
// brute force and NEE+MIS with point and sphere-area lights, pinhole and
// thin-lens cameras (DOF, the polar lens map), stratified jitter over
// strat_k^2 cells, global tiles through tile_offset.
//
// What it computes: one path per lane, lane = pixel * spp + s with spp
// dividing 128, walked through up to max_bounces + 1 vertices (:184-545):
// the emitter hit with its MIS weight, NEE with the quadratic shadow sweep
// that skips the sampled light sphere, one BSDF lobe (the diffuse one
// through the polar disk map, weight pi), Russian roulette once bounce >
// rr_start. Every factor is linear in its material colour A_m or light
// intensity I_l, so the lane carries the streaming adjoint: nA_m, the
// vertices on m whose factor was applied, cA_m, the sum of L * ok - nee
// there (L the radiance after the vertex's emission and NEE), and cI_l, the
// emission and NEE terms credited to light l (:272-278, :398-400, :491-505).
// After the walk, g is the upstream cotangent per lane ("vjp") or, in
// "mse" mode, the lane-local MSE cotangent of the pixel's mean over its spp
// lanes against the target (:547-577); each block writes one row of
// partials, sum g * (L * nA_m - cA_m), sum g * cI_l and the loss, which the
// wrapper sums (:581-590).
//
// What bounds it on this card: the walk, as kernel 8's (per-prim
// quadratics, transcendentals, the lobes, the NEE sweep), plus the adjoint
// sums. Device memory: the target or cotangent is read once (12 B per
// lane), radiance written once (12 B per lane), one row of partials per
// block, and in test mode the uniform block.
//
// What the design does about it:
//  * one thread per lane, one 128-thread block per 128-lane row, the walk in
//    registers; a dead lane leaves the loop;
//  * the adjoint is kept only for the materials that carry prims ("slots",
//    as in replay_persistent.cu) and the lights. Each vertex touches the
//    slot of its hit, a runtime index, so the lane's nA and cA (4 words per
//    slot) sit in dynamic shared memory sized to the scene's slots
//    (S x 4 x 128 x 4 B: 10 KB on cornell_spheres, 32 KB at the limit of
//    16), [word][lane] so that a warp's accesses fall in distinct banks,
//    not in a per-thread array in local memory (512 B of stack before);
//    the light sums cI (3 floats per light) stay in a per-thread array, as
//    in replay_persistent.cu, where shared memory cost the NEE builds;
//  * a lane records the slots and lights it reached in two bit masks; a
//    warp reduces only the columns (3 per slot, 3 per light) that one of
//    its lanes reached, and the block writes 0 for a column that no lane
//    reached, unreduced;
//  * a pixel's spp samples sit in adjacent lanes of one row (spp | 128), so
//    the pixel mean needs no device-memory round trip: for spp <= 32 the
//    lanes of each spp-aligned group read each other's radiance by warp
//    shuffles (the TPU kernel's lane rolls), for spp 64 and 128 through
//    the same shared buffer; every lane of a group adds the group's values
//    in sample order, the TPU kernel's order;
//  * no atomics, and one pass over the partials: each warp's shuffle tree
//    (warp_tree) per reached column, the loss and the ray count, then one
//    barrier, then each partial as the four warp sums in order (the order
//    of the per-partial block reductions this epilogue replaced); the
//    wrapper sums the rows, so a launch replays bit for bit, and every
//    output equals the local-memory kernel's (a column that no lane of a
//    row reached may read +0 where it read -0);
//  * built twice, with and without the thin lens (DOF), as the persistent
//    kernels are.
//
// Rounding: the build keeps nvcc's FMA contraction. The sphere quadratics
// and hit points use explicit FMAs in XLA's pattern, and the emission and
// NEE products are rounded before the sums (__fmul_rn), as in
// replay_persistent.cu, so that L and cI take the same terms. Held to >= 98%
// of lanes against the plain version on the card.
//
// Randomness: test mode reads the TPU kernel's external block (n_tiles,
// n_draw, tile_rows, 128); production mode draws Philox4x32-10 under stream
// tag 0x50000 (STREAM_REPLAY), countered on the global lane.
//
// C interface (loaded with ctypes): tpt_replay, tpt_replay_sample_smem_bytes,
// tpt_replay_sample_occupancy.

#include "pt_common.cuh"

namespace {

__constant__ float c_prims[MAX_PRIMS * 12];       // pack_prims layout
__constant__ int c_pflags[MAX_PRIMS];             // bit 0 emissive, 1-2 type
__constant__ int c_slot[MAX_PRIMS];               // adjoint slot per prim
__constant__ float c_lights[MAX_GRAD_LIGHTS * 8];  // pack_lights layout
__constant__ int c_lstruct[MAX_GRAD_LIGHTS * LS];  // light structure
__constant__ float c_cam[24];                     // pack_camera layout

struct Params {
  int n_prims, n_lights, n_slots, tile_rows, spp, strat_k, width, n_lanes;
  int max_bounces, rr_start, use_nee, mse, tile_offset;
  float inv_loss_n;  // 1 / (n_pix * 3)
  float g_scale;     // 2 inv_loss_n / spp, the MSE cotangent per lane
  uint32_t seed, salt, iteration;
  const float* uniforms;  // NULL: production Philox
  const float* aux;       // (rows_total, 128, 3): target ("mse") or g
  float *lr, *lg, *lb;    // (rows_total, 128) per-lane radiance
  float* partials;        // (rows_total, 3 slots + 3 lights + 1)
  int* nrays;             // (rows_total,)
};

// Words of dynamic shared memory per block: per lane nA and cA (4 per
// slot) and, at spp > 32, the pixel mean's radiance (3); then the
// epilogue's four warp sums per partial (3 per slot, 3 per light, the
// loss) and, per warp, its reached slots, lights and ray count.
__host__ __device__ constexpr int smem_words(int S, int NL, int spp) {
  return LANES * (4 * S + (spp > 32 ? 3 : 0)) + 4 * (3 * S + 3 * NL + 1) +
         3 * 4;
}
static_assert(4 * smem_words(MAX_SLOTS, MAX_GRAD_LIGHTS, LANES) <= 48 * 1024,
              "the largest block fits the default 48 KB");

// 8 blocks per SM (at most 64 registers; ptxas spills 52 B): on Philox
// draws 8-10% faster than at the 80 registers nvcc picks by itself (6
// blocks) and 2-3% faster than at 7 (72 registers, no spills); on an
// injected uniform block 7 blocks ran fastest (PERF.md, Findings).
template <bool DOF>
__global__ void __launch_bounds__(LANES, 8)
    replay_kernel(const __grid_constant__ Params p) {
  const int row = blockIdx.x;  // one block per 128-lane row
  const int col = threadIdx.x;
  const int idx = row * LANES + col;
  const int tile = row / p.tile_rows;
  const int trow = row - tile * p.tile_rows;
  const int tile_lanes = p.tile_rows * LANES;
  const int lane = idx + p.tile_offset * tile_lanes;  // global lane
  const bool in_domain = lane < p.n_lanes;
  constexpr int U1 = DOF ? 4 : 2;  // index of the first bounce draw
  const int nb = p.use_nee ? 6 : 3;
  const int n_draw = U1 + (p.max_bounces + 1) * nb;
  const int S = p.n_slots, NL = p.n_lights;
  SampleDraws draw{
      p.uniforms ? p.uniforms + (size_t)tile * n_draw * tile_lanes +
                       trow * LANES + col
                 : nullptr,
      tile_lanes, (uint32_t)lane, p.iteration, p.seed, p.salt, STREAM_REPLAY,
      -1, make_uint4(0u, 0u, 0u, 0u)};

  // the lane's adjoint in shared memory, word w at adj[w * LANES]: nA from
  // 0 (S words), cA from CA (3S); then the pixel-mean group (3 words, spp >
  // 32) from GR
  extern __shared__ float smem[];
  float* const adj = smem + col;
  auto at = [adj](int w) -> float& { return adj[w * LANES]; };
  const int CA = S, GR = 4 * S;
  float Lr = 0.f, Lg = 0.f, Lb = 0.f;
  for (int k = 0; k < 4 * S; ++k) at(k) = 0.f;
  float cI[MAX_GRAD_LIGHTS * 3];
  for (int k = 0; k < 3 * NL; ++k) cI[k] = 0.f;
  unsigned slots_hit = 0u, lights_hit = 0u;  // reached by the lane's path
  int n_live = 0;

  if (in_domain) {
    // ---- camera ray: stratified jitter, then the thin lens (:184-218)
    const int s = lane % p.spp, pix = lane / p.spp;
    float jx, jy, ox, oy, oz, dx, dy, dz;
    jitter_div(s % (p.strat_k * p.strat_k), p.strat_k, draw(0), draw(1), jx,
               jy);
    pinhole_dir(c_cam, (float)(pix % p.width) + jx,
                (float)(pix / p.width) + jy, dx, dy, dz);
    ox = c_cam[9];
    oy = c_cam[10];
    oz = c_cam[11];
    if (DOF) thin_lens(c_cam, draw(2), draw(3), ox, oy, oz, dx, dy, dz);
    float Tr = 1.f, Tg = 1.f, Tb = 1.f;
    float prev_pdf = 0.f;
    bool prev_delta = true;  // primaries take full emitter credit

    for (int bounce = 0; bounce <= p.max_bounces; ++bounce) {
      const int base = U1 + bounce * nb;
      const float u1 = draw(base), u2 = draw(base + 1), u3 = draw(base + 2);
      const SphereHit h = closest_sphere<true>(c_prims, c_pflags, p.n_prims,
                                               ox, oy, oz, dx, dy, dz);
      if (!h.hit) break;  // a miss ends the path
      ++n_live;
      const float wox = dx, woy = dy, woz = dz;
      const bool is_s = h.mtype == SPECULAR, is_t = h.mtype == TRANSMISSIVE;
      const bool is_d = !(is_s || is_t);

      // ---- emitter hit, MIS-weighted under NEE from the ray's origin;
      // credited to every sphere light on this prim
      if (h.emissive) {
        float take =
            dot3(h.nx, h.ny, h.nz, -wox, -woy, -woz) > 0.f ? 1.f : 0.f;
        if (p.use_nee) {
          float ldp = 0.f;  // the last matching light wins
          for (int li = 0; li < NL; ++li) {
            const int* LSi = c_lstruct + li * LS;
            if (LSi[0] == AREA_LIGHT && LSi[1] == h.prim)
              ldp = cone_pdf(c_prims + h.prim * 12, ox, oy, oz) *
                    c_lights[li * 8 + 7];
          }
          const float pp2 = prev_pdf * prev_pdf;
          take *= prev_delta ? 1.f : pp2 / fmaxf(pp2 + ldp * ldp, 1e-20f);
        }
        const float e_r = __fmul_rn(Tr * h.er, take),
                    e_g = __fmul_rn(Tg * h.eg, take),
                    e_b = __fmul_rn(Tb * h.eb, take);
        Lr += e_r;
        Lg += e_g;
        Lb += e_b;
        for (int li = 0; li < NL; ++li) {
          const int* LSi = c_lstruct + li * LS;
          if (LSi[0] != AREA_LIGHT || LSi[1] != h.prim) continue;
          lights_hit |= 1u << li;
          cI[3 * li] += e_r;
          cI[3 * li + 1] += e_g;
          cI[3 * li + 2] += e_b;
        }
      }

      // ---- NEE on diffuse lanes (:280-401); credits cI too
      float nee_r = 0.f, nee_g = 0.f, nee_b = 0.f;
      if (p.use_nee && is_d) {
        const float ul1 = draw(base + 3), ul2 = draw(base + 4),
                    usel = draw(base + 5);
        for (int li = 0; li < NL; ++li) {
          const float* LT = c_lights + li * 8;
          const float lo = LT[6], sel = LT[7];
          const bool m_l =
              li == NL - 1 ? usel >= lo : (usel >= lo && usel < lo + sel);
          if (!m_l) continue;
          const int* LSi = c_lstruct + li * LS;
          const bool area = LSi[0] == AREA_LIGHT && LSi[1] >= 0;
          const LightSample ls =
              sample_light(LT, area ? c_prims + LSi[1] * 12 : nullptr, h.hx,
                           h.hy, h.hz, ul1, ul2);
          const float cos_l = dot3(ls.wlx, ls.wly, ls.wlz, h.nx, h.ny, h.nz);
          const bool support =
              cos_l > 0.f && dot3(wox, woy, woz, ls.wlx, ls.wly, ls.wlz) < 0.f;
          if (!(ls.valid && support)) continue;
          // shadow any-hit, skipping the sampled light sphere (its hit lies
          // beyond smax)
          if (sphere_occluded(c_prims, p.n_prims, area ? LSi[1] : -1, h.hx,
                              h.hy, h.hz, ls.wlx, ls.wly, ls.wlz,
                              fmaf(ls.dist, 0.999f, -TMIN)))
            continue;
          const float pdf_b = cos_l * INV_PI;
          const float w_mis =
              area ? (ls.pdf * ls.pdf) /
                         fmaxf(ls.pdf * ls.pdf + pdf_b * pdf_b, 1e-20f)
                   : 1.f;
          const float scale = cos_l * w_mis / fmaxf(ls.pdf, 1e-20f);
          const float t_r = __fmul_rn(Tr * (h.ar * INV_PI) * ls.rad_r, scale);
          const float t_g = __fmul_rn(Tg * (h.ag * INV_PI) * ls.rad_g, scale);
          const float t_b = __fmul_rn(Tb * (h.ab * INV_PI) * ls.rad_b, scale);
          nee_r += t_r;
          nee_g += t_g;
          nee_b += t_b;
          lights_hit |= 1u << li;
          cI[3 * li] += t_r;
          cI[3 * li + 1] += t_g;
          cI[3 * li + 2] += t_b;
        }
        Lr += nee_r;
        Lg += nee_g;
        Lb += nee_b;
      }

      // ---- BSDF sampling: the polar diffuse map, mirror, dielectric
      const Lobe lb = sample_lobe(is_s, is_t, h.nx, h.ny, h.nz, wox, woy,
                                  woz, h.ar, h.ag, h.ab, h.coef, u1, u2);
      const bool f_black = lb.fr <= 0.f && lb.fg <= 0.f && lb.fb <= 0.f;
      const bool step_ok = !f_black && lb.pdf > 0.f;

      // ---- streaming adjoint at this vertex's material (:491-506)
      const int sl = c_slot[h.prim];
      slots_hit |= 1u << sl;
      if (step_ok) {
        at(sl) += 1.f;
        at(CA + 3 * sl) += Lr - nee_r;
        at(CA + 3 * sl + 1) += Lg - nee_g;
        at(CA + 3 * sl + 2) += Lb - nee_b;
        Tr = Tr * lb.fr * lb.wgt;
        Tg = Tg * lb.fg * lb.wgt;
        Tb = Tb * lb.fb * lb.wgt;
      } else {
        at(CA + 3 * sl) -= nee_r;
        at(CA + 3 * sl + 1) -= nee_g;
        at(CA + 3 * sl + 2) -= nee_b;
      }

      // ---- Russian roulette once bounce > rr_start, p = min(0.5, max T)
      bool alive = step_ok;
      if (bounce > p.rr_start) {
        const float p_cont = fminf(0.5f, fmaxf(Tr, fmaxf(Tg, Tb)));
        const bool survive = u3 <= p_cont;
        if (step_ok && survive && p_cont > 0.f) {
          const float inv_p = 1.f / fmaxf(p_cont, 1e-20f);
          Tr *= inv_p;
          Tg *= inv_p;
          Tb *= inv_p;
        }
        alive = step_ok && survive;
      }
      if (!alive) break;
      // ---- next segment (MIS previous vertex = this hit)
      ox = h.hx;
      oy = h.hy;
      oz = h.hz;
      dx = lb.wix;
      dy = lb.wiy;
      dz = lb.wiz;
      prev_pdf = lb.pdf;
      prev_delta = !is_d;
    }
  }

  // ---- the cotangent per lane (:547-579)
  const float dom = in_domain ? 1.f : 0.f;
  float g[3], sse = 0.f;
  if (p.mse) {
    // the pixel's radiance summed over its spp lanes in sample order; a
    // group never spans warps below 64 samples
    const int first = col - col % p.spp;
    float sum[3] = {0.f, 0.f, 0.f};
    if (p.spp <= 32) {
      const float L[3] = {Lr, Lg, Lb};
      const int src = first & 31;
      for (int c = 0; c < 3; ++c) {
        float acc = __shfl_sync(0xffffffffu, L[c], src);
        for (int j = 1; j < p.spp; ++j)
          acc += __shfl_sync(0xffffffffu, L[c], src + j);
        sum[c] = acc;
      }
    } else {
      at(GR) = Lr;
      at(GR + 1) = Lg;
      at(GR + 2) = Lb;
      __syncthreads();
      for (int c = 0; c < 3; ++c) {
        const float* grp = smem + (GR + c) * LANES + first;
        float acc = grp[0];
        for (int j = 1; j < p.spp; ++j) acc += grp[j];
        sum[c] = acc;
      }
    }
    // the group's first lane holds its pixel's target (the TPU kernel
    // reads it there and rolls g across the group)
    const float* t = p.aux + (size_t)(row * LANES + first) * 3;
    for (int c = 0; c < 3; ++c) {
      const float d = (sum[c] / (float)p.spp - t[c]) * dom;
      g[c] = d * p.g_scale;
      if (col == first) sse += d * d;
    }
  } else {
    for (int c = 0; c < 3; ++c) g[c] = p.aux[(size_t)idx * 3 + c] * dom;
  }

  // ---- per-row partials (:581-590) in one pass, summed by the wrapper:
  // each warp's shuffle tree over its 32 lanes for the columns its lanes
  // reached (the others' warp sums are 0), the loss and the ray count; one
  // barrier; then each partial as the row's four warp sums in order
  const float L[3] = {Lr, Lg, Lb};
  const int K = 3 * S + 3 * NL + 1;
  float* const ws = smem + LANES * (4 * S + (p.spp > 32 ? 3 : 0));  // [K][4]
  int* const wm = reinterpret_cast<int*>(ws + 4 * K);  // slots, lights, rays
  const int warp = col >> 5, wl = col & 31;
  const unsigned w_slots = __reduce_or_sync(0xffffffffu, slots_hit);
  const unsigned w_lights = __reduce_or_sync(0xffffffffu, lights_hit);
  for (int k = wl; k < K - 1; k += 32) {
    const bool reached = k < 3 * S ? (w_slots >> (k / 3)) & 1u
                                   : (w_lights >> ((k - 3 * S) / 3)) & 1u;
    if (!reached) ws[4 * k + warp] = 0.f;
  }
  for (unsigned m = w_slots; m; m &= m - 1) {
    const int s = __ffs(m) - 1;
    for (int c = 0; c < 3; ++c) {
      const float v =
          warp_tree(g[c] * (L[c] * at(s) - at(CA + 3 * s + c)));
      if (wl == 0) ws[4 * (3 * s + c) + warp] = v;
    }
  }
  for (unsigned m = w_lights; m; m &= m - 1) {
    const int l = __ffs(m) - 1;
    for (int c = 0; c < 3; ++c) {
      const float v = warp_tree(g[c] * cI[3 * l + c]);
      if (wl == 0) ws[4 * (3 * S + 3 * l + c) + warp] = v;
    }
  }
  const float w_sse = warp_tree(sse);
  const int w_rays = __reduce_add_sync(0xffffffffu, n_live);
  if (wl == 0) {
    ws[4 * (K - 1) + warp] = w_sse;
    wm[warp] = (int)w_slots;
    wm[4 + warp] = (int)w_lights;
    wm[8 + warp] = w_rays;
  }
  p.lr[idx] = Lr * dom;
  p.lg[idx] = Lg * dom;
  p.lb[idx] = Lb * dom;
  __syncthreads();
  const unsigned b_slots = (unsigned)(wm[0] | wm[1] | wm[2] | wm[3]);
  const unsigned b_lights = (unsigned)(wm[4] | wm[5] | wm[6] | wm[7]);
  float* part = p.partials + (size_t)row * K;
  for (int k = col; k < K; k += LANES) {
    const bool reached =
        k == K - 1 || (k < 3 * S ? (b_slots >> (k / 3)) & 1u
                                 : (b_lights >> ((k - 3 * S) / 3)) & 1u);
    const float* w = ws + 4 * k;
    const float v = reached ? ((w[0] + w[1]) + w[2]) + w[3] : 0.f;
    part[k] = k == K - 1 ? v * p.inv_loss_n : v;
  }
  if (col == 0) p.nrays[row] = wm[8] + wm[9] + wm[10] + wm[11];
}

}  // namespace

extern "C" {

// Launch one per-sample value-and-grad walk on `stream`. prims/lights/cam/
// uniforms/aux and the outputs are device pointers; pflags, slots (the
// adjoint slot of each prim's material) and lstruct (LS ints per light) are
// host arrays, copied with the tables into __constant__ memory on the same
// stream, so launches must stay on one stream. aux is (rows_total, 128, 3);
// lr/lg/lb are rows_total x 128, partials rows_total x (3 n_slots + 3
// n_lights + 1), nrays rows_total. mse 1 reads aux as the broadcast target,
// 0 as the per-lane cotangent. Returns the first CUDA error (0 on success).
int tpt_replay(const float* prims, const int* pflags, const int* slots,
               int n_prims, const float* lights, const int* lstruct,
               int n_lights, int n_slots, const float* cam,
               const float* uniforms, const float* aux, float* lr, float* lg,
               float* lb, float* partials, int* nrays, int rows_total,
               int tile_rows, int spp, int strat_k, int width, int n_lanes,
               int max_bounces, int rr_start, int use_nee, int use_dof,
               int mse, int tile_offset, float inv_loss_n, float g_scale,
               uint32_t seed, uint32_t salt, uint32_t iteration,
               void* stream) {
  if (n_prims < 1 || n_prims > MAX_PRIMS || n_lights < 0 ||
      n_lights > MAX_GRAD_LIGHTS || n_slots < 0 || n_slots > MAX_SLOTS ||
      rows_total <= 0 || tile_rows <= 0 || rows_total % tile_rows != 0 ||
      width <= 0 || spp <= 0 || LANES % spp != 0 || strat_k < 1 ||
      max_bounces < 0 || tile_offset < 0)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_prims; ++q)
    if (slots[q] < 0 || slots[q] >= n_slots) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_prims, prims, sizeof(float) * 12 * n_prims, 0,
      cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_pflags, pflags, sizeof(int) * n_prims, 0,
                                  cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_slot, slots, sizeof(int) * n_prims, 0,
                                  cudaMemcpyHostToDevice, st);
  if (err == cudaSuccess && n_lights > 0) {
    err = cudaMemcpyToSymbolAsync(c_lights, lights,
                                  sizeof(float) * 8 * n_lights, 0,
                                  cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_lstruct, lstruct,
                                    sizeof(int) * LS * n_lights, 0,
                                    cudaMemcpyHostToDevice, st);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_cam, cam, sizeof(float) * 24, 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.n_prims = n_prims;
  p.n_lights = n_lights;
  p.n_slots = n_slots;
  p.tile_rows = tile_rows;
  p.spp = spp;
  p.strat_k = strat_k;
  p.width = width;
  p.n_lanes = n_lanes;
  p.max_bounces = max_bounces;
  p.rr_start = rr_start;
  p.use_nee = use_nee;
  p.mse = mse;
  p.tile_offset = tile_offset;
  p.inv_loss_n = inv_loss_n;
  p.g_scale = g_scale;
  p.seed = seed;
  p.salt = salt;
  p.iteration = iteration;
  p.uniforms = uniforms;
  p.aux = aux;
  p.lr = lr;
  p.lg = lg;
  p.lb = lb;
  p.partials = partials;
  p.nrays = nrays;
  const int smem = 4 * smem_words(n_slots, n_lights, spp);
  if (use_dof)
    replay_kernel<true><<<rows_total, LANES, smem, st>>>(p);
  else
    replay_kernel<false><<<rows_total, LANES, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory per block for n_slots, n_lights and spp
// (ops/kernels/replay_kernel.py::sample_smem_bytes computes the same), and
// the blocks per SM that it and the registers of one build allow
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 on an error).
int tpt_replay_sample_smem_bytes(int n_slots, int n_lights, int spp) {
  return 4 * smem_words(n_slots, n_lights, spp);
}

int tpt_replay_sample_occupancy(int dof, int n_slots, int n_lights,
                                int spp) {
  const void* kernel = dof ? (const void*)replay_kernel<true>
                           : (const void*)replay_kernel<false>;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, LANES, 4 * smem_words(n_slots, n_lights, spp)) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
