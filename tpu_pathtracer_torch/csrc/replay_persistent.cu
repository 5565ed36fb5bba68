// Persistent fused value-and-grad kernel for Hopper (sm_90a).
//
// Replaces: tpu_pathtracer/ops/pallas/replay_persistent.py::_preplay_kernel
// (launched by persistent_replay_call), whole: sphere and triangle-mesh
// scenes, phases "both", "adjoint" and "scatter"; brute force, and NEE+MIS
// with point, sphere-area and triangle (TRI_LIGHT) lights, pinhole and
// thin-lens cameras (DOF), textured mesh materials (TEX); a mesh vertex
// routes its adjoint to its material like a sphere vertex, and a triangle
// light's emission and NEE credit its intensity adjoint. Texture-atlas
// gradients take two launches, as on the TPU: replay_persistent_kernel with
// TEX records each completed path's total C_tot (record_ct), and
// replay_scatter_kernel replays the same walk and scatters the atlas
// gradient (phase "scatter").
//
// What it computes: one launch walks `budget` wavefront iterations of the
// persistent regeneration schedule (one lane per pixel; a dead lane starts
// its pixel's next stratified sample while it has fewer than spp), and
// carries the streaming adjoint of every path with it. Every BSDF factor and
// emission term is linear in its material colour A_m or light intensity I_l,
// so with the per-path radiance prefix C and total C_tot
//     dC_tot/dA_m = (C_tot * nA_m - cA_m) / A_m,   dC_tot/dI_l = cI_l / I_l
// where nA_m counts the path's vertices on material m whose BSDF factor was
// applied and cA_m sums (C after the vertex's emission and NEE) * ok - nee at
// them. The per-path sums are flushed into per-lane accumulators GA/GI when
// the path completes; paths still in flight at the end of the launch enter
// neither the loss nor the gradient. The epilogue applies the lane-local MSE
// cotangent (lane == pixel) and reduces per block (phase "both"), or writes
// GA/GI per lane (phase "adjoint", the TPU kernel's defer_g layout).
//
// A textured material's colour is multiplied by the bilinear texel, so every
// factor at a textured vertex b is linear in the texel, and
//     dC_tot/dT[tap] = sum_b w_tap(b) / texel_b * (ok_b (C_tot - C_b) + nee_b)
// with C_b the path radiance after the vertex's emission and NEE. C_tot is
// not known at the vertex, so launch 1 writes each completed path's C_tot
// to plane (3 n_samp + c) of the records, and the scatter launch walks the
// same schedule on the same draws and, at each textured vertex of a path
// that completed in launch 1 (n_samp < launch 1's final count), adds
// g * bracket / max(texel, 1e-8) with the bilinear weights into the four
// taps of the atlas gradient (K, TH, TW, 3), g the lane-local cotangent
// computed between the launches. The scatter launch also writes its own
// radiance sums and sample counts, which equal launch 1's on every lane if
// the replay is exact (chip_smoke.py requires it).
//
// What bounds it on this card: like the forward kernel, a long, divergent
// ALU state machine (per-prim quadratics, transcendentals, three lobes, the
// NEE shadow sweep), and here also the drain: a launch stops regenerating
// at spp paths per pixel, so lanes idle once their pixel is done (the live
// share of lane-iterations is 0.58 on cornell_spheres at config 5, 0.26 on
// terrain32: PERF.md). Its device-memory traffic is small: the target
// image is read once, the radiance sums, sample counts and per-block
// partials (or the per-lane GA/GI planes) are written once; in test mode
// the uniform block is read too; with textures the atlas is read through
// the read-only cache, the 3 spp C_tot planes written once by launch 1 and
// read at textured vertices by the scatter, and the 0.79 MB atlas gradient
// of a 256^2 texture is added to in L2.
//
// What the design does about it:
//  * one thread per lane, one 128-thread block per 128-lane row of the
//    layout, the path in registers, as in persistent.cu; the scene tables
//    sit in __constant__ memory. A warp whose lanes have all drained leaves
//    the loop (it would only draw uniforms it never uses);
//  * the adjoint is kept only for the materials that carry prims or mesh
//    triangles ("slots": 5 of cornell's 8 padded materials) and the lights,
//    in dynamic shared memory sized to the launch's slots and lights (7
//    words per slot and 3 per light per lane, [word][lane] so a warp's
//    accesses fall in distinct banks; 21 KB per block on cornell_spheres,
//    83 KB at the limits of 16 slots and 16 lights, which then runs fewer
//    blocks per SM), with the lane's radiance sums; only the in-flight
//    path's light sums cI (3 floats per light) stay in a per-thread array.
//    A path records the slots and lights it reaches in two bit masks; its
//    completion flushes and clears only those (an unreached slot holds
//    zeros, whose flush adds +0 to an accumulator that is never -0, so the
//    sums are the same bits), and regeneration has nothing left to clear;
//  * a mesh is walked per thread as in persistent.cu (pt_common.cuh's
//    bvh_walk over pack_bvh's small-leaf tree, so the scatter
//    launch replays launch 1's walk bit for bit), and the kernel is
//    built six times, with and without the mesh code (MESH), the texture
//    code (TEX, with a mesh only) and the thin lens (DOF), so that a sphere
//    scene, an untextured scene or a pinhole camera does not carry their
//    registers and spills; the scatter walk is the same template body
//    (replay_walk) with SCATTER set, built with and without DOF: it drops
//    the adjoint sums and their shared memory;
//  * the reduction across lanes is deterministic and uses no atomics: each
//    block writes one row of partials (3 per slot, 3 per light, the loss),
//    each summed in a fixed order (a warp's shuffle tree, then the
//    four warp sums in order) in one pass with one barrier, and the
//    wrapper sums the rows, as the JAX code sums its per-tile partials
//    outside the pallas_call;
//  * a completed path's C_tot goes straight to its record plane in device
//    memory (the TPU keeps 3 spp lane tiles in VMEM);
//  * the scatter adds into the atlas gradient with float atomicAdd
//    (RED.ADD.F32 on L2): a 256^2 RGB atlas is 0.79 MB, beyond a block's
//    227 KB of shared memory, and a partial atlas per block would take 2,400
//    x 0.79 MB at 640x480. The TPU's transposed two-hot MXU product stands
//    in for the scatter that Hopper has. The order of the additions changes
//    from launch to launch, so the atlas gradient is not bit for bit
//    reproducible; everything else of both launches is (ROADMAP,
//    "Determinism").
// Packing the acting lanes of a block into its leading warps every
// iteration (or whenever fewer warps would hold them) was built and
// measured, and dropped: it gained ~10% on the one-leaf Cornell meshes
// and lost 5-9% on terrain32 and up to 9% on the sphere builds (PERF.md,
// Findings).
//
// Rounding (REPLAY): the build keeps nvcc's FMA contraction, as the forward
// kernel's. The scatter launch is another instantiation of the same body,
// and its replay of launch 1 must be exact; chip_smoke.py holds its
// radiance sums and sample counts equal to launch 1's on every lane. nvcc
// fuses a product into the sum that takes it depending on the product's
// other uses, and the emission and NEE terms also feed the intensity
// adjoint in launch 1 only: with contraction, ~1,700 lane outputs of a
// 640x480 NEE launch differed. Those products are therefore rounded on
// their own (__fmul_rn), as the plain version rounds them.
//
// Differences from the forward kernel that are the TPU kernels' own: the
// closest hit keeps the FIRST prim on an exact tie (strict <), the NEE shadow
// test is the sphere quadratic (not the segment-ball distance form), and
// regeneration stops at spp completed paths per pixel. The ray count is the
// TPU kernel's: lanes alive after regeneration, once per iteration; shadow
// segments are not counted.
//
// Randomness: test mode reads the TPU kernel's external uniform block;
// production mode draws Philox4x32-10 under stream tag 0x10000 in the
// counter's last word, apart from every draw of the forward kernel.
//
// C interface (loaded with ctypes): tpt_replay_persistent,
// tpt_replay_smem_bytes, tpt_replay_occupancy.

#include "pt_common.cuh"

namespace {

constexpr int MAX_MATS = 256;  // materials a mesh triangle may use
// Shared memory a block may take on the H100 (227 KB, with the opt-in).
constexpr int MAX_SMEM_BLOCK = 232448;

__constant__ float c_prims[MAX_PRIMS * 12];  // pack_prims layout
__constant__ int c_pflags[MAX_PRIMS];        // bit 0 emissive, bits 1-2 type
// adjoint slot of each prim's material, then of each material (-1: none)
__constant__ int c_slot[MAX_PRIMS + MAX_MATS];
__constant__ float c_lights[MAX_LIGHTS * 8];  // pack_lights layout
__constant__ int c_lstruct[MAX_LIGHTS * LS];  // light structure (pt_common)
__constant__ float c_cam[24];                // pack_camera layout

struct Params {
  int n_prims, n_lights, n_slots, tile_rows, budget, spp, width, n_lanes;
  int max_bounces, rr_start, use_nee, strat_k, tile_offset;
  float inv_loss_n;
  uint32_t seed, salt, iteration;
  const float* uniforms;  // NULL: production Philox
  const float* target;    // (rows_total, 128, 3) per-pixel target
  float *lr, *lg, *lb;    // per-lane completed-path sums
  int* n_samp;
  int* nrays;             // (rows_total,) live lanes summed over iterations
  float* partials;        // phase "both": (rows_total, 3*slots+3*lights+1)
  float* gl;              // phase "adjoint": ((slots+lights)*3, rows, 128)
  MeshView mesh;          // n_nodes 0: no mesh
  const float* atlas;     // (tex_k, tex_th, tex_tw, 3) texture atlas (TEX)
  int tex_k, tex_th, tex_tw;
  float* ct;              // launch 1: (3 spp, rows, 128) C_tot records or NULL
  const float* g;         // scatter: (3, rows, 128) lane-local cotangent
  const float* ct_in;     // scatter: launch 1's C_tot records
  const int* nsf;         // scatter: launch 1's final sample counts
  float* gT;              // scatter: (tex_k, tex_th, tex_tw, 3) atlas gradient
};

// The walk of both launches. SCATTER (launch 2, with MESH and TEX) replays
// launch 1's walk without the adjoint sums and scatters the atlas gradient.
template <bool MESH, bool TEX, bool DOF, bool SCATTER>
__device__ __forceinline__ void replay_walk(const Params& p) {
  static_assert(MESH || !TEX, "textures live on mesh materials");
  static_assert(TEX || !SCATTER, "the scatter walk is a textured walk");
  __shared__ int iscratch[4];
  const int row = blockIdx.x;  // one block per 128-lane row
  const int col = threadIdx.x;
  const int idx = row * LANES + col;
  const int tile = row / p.tile_rows;
  const int trow = row - tile * p.tile_rows;
  const int tile_lanes = p.tile_rows * LANES;
  const int lane = idx + p.tile_offset * tile_lanes;  // global lane = pixel
  const bool in_domain = lane < p.n_lanes;
  // draws per iteration, in the TPU kernel's order (pt_common.cuh)
  constexpr int U1 = DOF ? 4 : 2;  // index of u1, after the camera's draws
  const int n_draw = U1 + 3 + (p.use_nee ? 3 : 0);
  const int S = p.n_slots, NL = p.n_lights;

  int n_samp = 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float Tr = 0.f, Tg = 0.f, Tb = 0.f, Cr = 0.f, Cg = 0.f, Cb = 0.f;
  int bounce = 0;
  bool alive = false;
  float prev_pdf = 0.f;
  bool prev_delta = false;
  // The adjoint in shared memory, word-major ([word][lane], so that the
  // lanes of a warp touch consecutive banks), sized to the launch (words
  // of this lane at adj[w * LANES]): the in-flight path's nA (S words, from
  // 0) and cA (3S, from CA), then the completed-path accumulators GA (3S,
  // from GA) and GI (3NL, from GI), then the lane's radiance sums (cold:
  // written at path completion only). The path's light sums cI stay in a
  // per-thread array: in shared memory their addressing in the light loops
  // cost the NEE builds registers and time (PERF.md, Findings). A path
  // records the slots and lights it reaches; its completion flushes and
  // clears only those.
  extern __shared__ float smem[];
  float* const adj = smem + col;
  auto at = [adj](int w) -> float& { return adj[w * LANES]; };
  const int CA = S, GA = 4 * S, GI = 7 * S;
  const int LR = SCATTER ? 0 : 7 * S + 3 * NL;  // Lr, Lg, Lb
  for (int k = 0; k < LR + 3; ++k) at(k) = 0.f;
  float cI[MAX_GRAD_LIGHTS * 3];
  for (int k = 0; k < (SCATTER ? 0 : 3 * NL); ++k) cI[k] = 0.f;
  unsigned slots_hit = 0u, lights_hit = 0u;  // reached by the path
  int n_live = 0;

  for (int it = 0; it < p.budget; ++it) {
    // a warp whose lanes have all drained stops (its draws are unused)
    if (!__any_sync(0xffffffffu, alive || (in_domain && n_samp < p.spp)))
      break;
    float u[DOF ? 12 : 8];
    draw_uniforms(u, p.uniforms, tile, p.budget, it, n_draw, tile_lanes, trow,
                  col, lane, p.iteration, p.seed, p.salt,
                  STREAM_GRADIENT);
    const float u1 = u[U1], u2 = u[U1 + 1], u3 = u[U1 + 2];
    const float ul1 = u[U1 + 3], ul2 = u[U1 + 4], usel = u[U1 + 5];

    // ---- regenerate while the pixel has samples left (the launch drains)
    if (!alive && in_domain && n_samp < p.spp) {
      camera_dir(c_cam, (float)(lane % p.width), (float)(lane / p.width),
                 n_samp, p.strat_k, u[0], u[1], dx, dy, dz);
      ox = c_cam[9];
      oy = c_cam[10];
      oz = c_cam[11];
      if (DOF) thin_lens(c_cam, u[2], u[3], ox, oy, oz, dx, dy, dz);
      Tr = Tg = Tb = 1.f;
      Cr = Cg = Cb = 0.f;
      bounce = 0;
      prev_pdf = 0.f;
      prev_delta = true;
      alive = true;
    }
    if (!alive) continue;  // padding and drained lanes never act
    ++n_live;

    // ---- closest hit; strict < keeps the FIRST prim on an exact tie
    float best_t = BIG;
    int best_p = -1;
    for (int q = 0; q < p.n_prims; ++q) {
      const float* P = c_prims + q * 12;
      const float opx = P[0] - ox, opy = P[1] - oy, opz = P[2] - oz;
      const float r = P[3];
      const float b = dot3_fma(opx, opy, opz, dx, dy, dz);
      const float det =
          fmaf(r, r, fmaf(b, b, -dot3_fma(opx, opy, opz, opx, opy, opz)));
      const float sq = sqrtf(fmaxf(det, 0.f));
      const float t0 = b - sq;
      const float t = t0 > TMIN ? t0 : b + sq;
      if (det >= 0.f && t > TMIN && t < best_t) {
        best_t = t;
        best_p = q;
      }
    }
    // ---- the mesh, pruned from the sphere t; a strictly closer triangle
    // wins (replay_persistent.py:302-339)
    float tm = BIG, gnx = 0.f, gny = 0.f, gnz = 0.f, hu = 0.f, hv = 0.f;
    int mmat = -1;
    if (MESH)
      tm = bvh_walk<false, TEX>(p.mesh, ox, oy, oz, dx, dy, dz, best_t,
                                gnx, gny, gnz, mmat, hu, hv);
    const bool mesh_hit = tm < best_t && tm < 0.5f * BIG;
    bool alive_next = false;
    if (mesh_hit || best_p >= 0) {
      const float t_hit = mesh_hit ? tm : best_t;
      const float hx = fmaf(dx, t_hit, ox), hy = fmaf(dy, t_hit, oy),
                  hz = fmaf(dz, t_hit, oz);
      float nx, ny, nz, ar, ag, ab, coef, er = 0.f, eg = 0.f, eb = 0.f;
      int mtype, sl;
      bool emissive = false;
      int texk = -1;  // the hit's texture (TEX), -1 untextured
      float3 tx = make_float3(0.f, 0.f, 0.f);
      if (mesh_hit) {
        const float inv_len =
            rsqrtf(fmaxf(gnx * gnx + gny * gny + gnz * gnz, 1e-20f));
        nx = gnx * inv_len;
        ny = gny * inv_len;
        nz = gnz * inv_len;
        const float* MT = p.mesh.mats + mmat * MAT_STRIDE;
        ar = __ldg(MT);
        ag = __ldg(MT + 1);
        ab = __ldg(MT + 2);
        coef = __ldg(MT + 3);
        mtype = (int)__ldg(MT + 4);
        sl = c_slot[p.n_prims + mmat];
        if (TEX) {
          // a textured material's colour is multiplied by the texel
          // (replay_persistent.py:413-415); a texture id past the atlas
          // gives a zero texel, as the TPU kernel's rows past the atlas
          // match no row
          texk = (int)__ldg(MT + 5);
          if (texk >= 0) {
            if (texk < p.tex_k)
              tx = texel(p.atlas, texk, p.tex_th, p.tex_tw, hu, hv);
            ar = tx.x * ar;
            ag = tx.y * ag;
            ab = tx.z * ab;
          }
        }
        for (int li = 0; li < NL; ++li) {  // the last matching light wins
          const int* S = c_lstruct + li * LS;
          if (S[0] != TRI_LIGHT || S[2] != mmat) continue;
          const float* LT = c_lights + li * 8;
          emissive = true;
          er = LT[3];
          eg = LT[4];
          eb = LT[5];
        }
      } else {
        const float* HP = c_prims + best_p * 12;
        const int pflag = c_pflags[best_p];
        mtype = (pflag >> 1) & 3;
        const float inv_r = 1.0f / HP[3];
        nx = (hx - HP[0]) * inv_r;
        ny = (hy - HP[1]) * inv_r;
        nz = (hz - HP[2]) * inv_r;
        ar = HP[4];
        ag = HP[5];
        ab = HP[6];
        coef = HP[7];
        sl = c_slot[best_p];
        if (pflag & 1) {
          emissive = true;
          er = HP[9];
          eg = HP[10];
          eb = HP[11];
        }
      }
      const bool is_s = mtype == SPECULAR, is_t = mtype == TRANSMISSIVE;
      const bool is_d = !(is_s || is_t);
      if (is_d) coef = 0.f;
      const float wox = dx, woy = dy, woz = dz;

      // ---- emitter hit, MIS-weighted under NEE; credits the intensity
      // adjoint of its light(s): every sphere light on this prim, or the
      // triangle light of this material
      if (emissive) {
        float take = dot3(nx, ny, nz, -wox, -woy, -woz) > 0.f ? 1.f : 0.f;
        if (p.use_nee) {
          // the light-sampling pdf of this emitter hit
          float ldp = 0.f;
          for (int li = 0; li < NL; ++li) {
            const int* S = c_lstruct + li * LS;
            if (mesh_hit && S[0] == TRI_LIGHT && S[2] == mmat)
              ldp = tri_light_pdf(tm, dot3(nx, ny, nz, dx, dy, dz),
                                  c_lights[li * 8 + 7],
                                  __ldg(p.mesh.tl + S[3] * TL_STRIDE + 13));
            else if (!mesh_hit && S[0] == AREA_LIGHT && S[1] == best_p)
              ldp = cone_pdf(c_prims + best_p * 12, ox, oy, oz) *
                    c_lights[li * 8 + 7];
          }
          const float pp2 = prev_pdf * prev_pdf;
          take *= prev_delta ? 1.f : pp2 / fmaxf(pp2 + ldp * ldp, 1e-20f);
        }
        // rounded before the sums (REPLAY below)
        const float e_r = __fmul_rn(Tr * er, take),
                    e_g = __fmul_rn(Tg * eg, take),
                    e_b = __fmul_rn(Tb * eb, take);
        Cr += e_r;
        Cg += e_g;
        Cb += e_b;
        for (int li = 0; li < (SCATTER ? 0 : NL); ++li) {
          const int* S = c_lstruct + li * LS;
          if (mesh_hit ? !(S[0] == TRI_LIGHT && S[2] == mmat)
                       : !(S[0] == AREA_LIGHT && S[1] == best_p))
            continue;
          cI[3 * li] += e_r;
          cI[3 * li + 1] += e_g;
          cI[3 * li + 2] += e_b;
          lights_hit |= 1u << li;
        }
      }

      // ---- next-event estimation on diffuse lanes; credits cI too
      float nee_r = 0.f, nee_g = 0.f, nee_b = 0.f;
      if (p.use_nee && is_d) {
        for (int li = 0; li < NL; ++li) {
          const float* LT = c_lights + li * 8;
          const float lo = LT[6], sel = LT[7];
          const bool m_l = li == NL - 1 ? usel >= lo
                                        : (usel >= lo && usel < lo + sel);
          if (!m_l) continue;
          const int* S = c_lstruct + li * LS;
          const bool area = S[0] == AREA_LIGHT && S[1] >= 0;
          const bool tri = MESH && S[0] == TRI_LIGHT;
          const LightSample ls =
              tri ? sample_tri_light(p.mesh.tl + S[3] * TL_STRIDE, S[4], LT,
                                     hx, hy, hz, ul1, ul2)
                  : sample_light(LT, area ? c_prims + S[1] * 12 : nullptr, hx,
                                 hy, hz, ul1, ul2);
          const float cos_l = dot3(ls.wlx, ls.wly, ls.wlz, nx, ny, nz);
          const bool support =
              cos_l > 0.f && dot3(wox, woy, woz, ls.wlx, ls.wly, ls.wlz) < 0.f;
          if (!(ls.valid && support)) continue;
          // shadow any-hit: the sphere quadratic's root in (tmin, smax),
          // skipping the sampled light sphere (its hit lies beyond smax),
          // then the mesh in occlusion mode
          const float smax = fmaf(ls.dist, 0.999f, -TMIN);
          const int skip = area ? S[1] : -1;
          bool occ = false;
          for (int q = 0; q < p.n_prims && !occ; ++q) {
            if (q == skip) continue;
            const float* P = c_prims + q * 12;
            const float sx2 = P[0] - hx, sy2 = P[1] - hy, sz2 = P[2] - hz;
            const float rb = dot3_fma(sx2, sy2, sz2, ls.wlx, ls.wly, ls.wlz);
            const float rdet = fmaf(
                P[3], P[3],
                fmaf(rb, rb, -dot3_fma(sx2, sy2, sz2, sx2, sy2, sz2)));
            const float rsq = sqrtf(fmaxf(rdet, 0.f));
            const float rt = rb - rsq > TMIN ? rb - rsq : rb + rsq;
            occ = rdet >= 0.f && rt > TMIN && rt < smax;
          }
          if (MESH && !occ && smax > 0.f)
            occ = bvh_occluded(p.mesh, hx, hy, hz, ls.wlx, ls.wly, ls.wlz,
                               smax);
          if (occ) continue;
          const float pdf_b = cos_l * INV_PI;
          const float w_mis =
              (area || tri) ? (ls.pdf * ls.pdf) /
                                  fmaxf(ls.pdf * ls.pdf + pdf_b * pdf_b, 1e-20f)
                            : 1.f;
          const float scale = cos_l * w_mis / fmaxf(ls.pdf, 1e-20f);
          // rounded before the sums (REPLAY below)
          const float t_r = __fmul_rn(Tr * (ar * INV_PI) * ls.rad_r, scale);
          const float t_g = __fmul_rn(Tg * (ag * INV_PI) * ls.rad_g, scale);
          const float t_b = __fmul_rn(Tb * (ab * INV_PI) * ls.rad_b, scale);
          nee_r += t_r;
          nee_g += t_g;
          nee_b += t_b;
          if (!SCATTER) {
            cI[3 * li] += t_r;
            cI[3 * li + 1] += t_g;
            cI[3 * li + 2] += t_b;
            lights_hit |= 1u << li;
          }
        }
        Cr += nee_r;
        Cg += nee_g;
        Cb += nee_b;
      }

      // ---- BSDF sampling: one lobe per lane
      const Lobe lb = sample_lobe(is_s, is_t, nx, ny, nz, wox, woy, woz, ar,
                                  ag, ab, coef, u1, u2);
      const bool f_black = lb.fr <= 0.f && lb.fg <= 0.f && lb.fb <= 0.f;
      const bool step_ok = !f_black && lb.pdf > 0.f;

      // ---- the atlas scatter (launch 2) at a textured vertex of a path
      // that completed in launch 1 (replay_persistent.py:912-978); a
      // texture id past the atlas adds nothing
      if (SCATTER && texk >= 0 && texk < p.tex_k &&
          n_samp < __ldg(p.nsf + idx)) {
        const size_t plane = (size_t)gridDim.x * LANES;
        const float okf = step_ok ? 1.f : 0.f;
        const float* ct = p.ct_in + (size_t)n_samp * 3 * plane + idx;
        const float C[3] = {Cr, Cg, Cb}, nee[3] = {nee_r, nee_g, nee_b};
        const float txc[3] = {tx.x, tx.y, tx.z};
        float v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = __ldg(p.g + c * plane + idx) *
                 (okf * (__ldg(ct + c * plane) - C[c]) + nee[c]) *
                 (1.f / fmaxf(txc[c], 1e-8f));
        const Taps t = texel_taps(p.tex_th, p.tex_tw, hu, hv);
        float* G = p.gT + (size_t)texk * p.tex_th * p.tex_tw * 3;
        const int tr[2] = {t.r0, t.r1}, tc[2] = {t.c0, t.c1};
        const float wr[2] = {1.f - t.fy, t.fy}, wc[2] = {1.f - t.fx, t.fx};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* cell = G + ((size_t)tr[i] * p.tex_tw + tc[j]) * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              atomicAdd(cell + c, (wc[j] * v[c]) * wr[i]);
          }
      }

      // ---- streaming adjoint at this vertex's material
      if (!SCATTER) slots_hit |= 1u << sl;
      if (step_ok) {
        if (!SCATTER) {
          at(sl) += 1.f;
          at(CA + 3 * sl) += Cr - nee_r;
          at(CA + 3 * sl + 1) += Cg - nee_g;
          at(CA + 3 * sl + 2) += Cb - nee_b;
        }
        Tr = Tr * lb.fr * lb.wgt;
        Tg = Tg * lb.fg * lb.wgt;
        Tb = Tb * lb.fb * lb.wgt;
      } else if (!SCATTER) {
        at(CA + 3 * sl) -= nee_r;
        at(CA + 3 * sl + 1) -= nee_g;
        at(CA + 3 * sl + 2) -= nee_b;
      }

      // ---- Russian roulette once bounce > rr_start, p = min(0.5, max T)
      const bool do_rr = bounce > p.rr_start;
      const float p_cont = fminf(0.5f, fmaxf(Tr, fmaxf(Tg, Tb)));
      const bool survive = u3 <= p_cont;
      if (step_ok && do_rr && survive && p_cont > 0.f) {
        const float inv_p = 1.f / fmaxf(p_cont, 1e-20f);
        Tr *= inv_p;
        Tg *= inv_p;
        Tb *= inv_p;
      }
      alive_next = step_ok && (survive || !do_rr) && bounce < p.max_bounces;
      // pending ray for the next iteration (MIS previous vertex = hit)
      ox = hx; oy = hy; oz = hz;
      dx = lb.wix; dy = lb.wiy; dz = lb.wiz;
      prev_pdf = lb.pdf;
      prev_delta = !is_d;
      ++bounce;
    }
    if (!alive_next) {
      // ---- path completion (a miss, a dead lobe, RR or the bounce cap):
      // flush radiance and the adjoint sums
      at(LR) += Cr;
      at(LR + 1) += Cg;
      at(LR + 2) += Cb;
      if (TEX && !SCATTER && p.ct) {
        // the path's total into its sample slot (replay_persistent.py:
        // 1008-1015); a padding lane never completes a path
        const size_t plane = (size_t)gridDim.x * LANES;
        float* ct = p.ct + (size_t)n_samp * 3 * plane + idx;
        ct[0] = Cr;
        ct[plane] = Cg;
        ct[2 * plane] = Cb;
      }
      ++n_samp;
      // flush and clear the slots and lights this path reached (the others
      // hold zeros, which would add +0 to the accumulators)
      for (unsigned m = SCATTER ? 0u : slots_hit; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        at(GA + 3 * k) += Cr * at(k) - at(CA + 3 * k);
        at(GA + 3 * k + 1) += Cg * at(k) - at(CA + 3 * k + 1);
        at(GA + 3 * k + 2) += Cb * at(k) - at(CA + 3 * k + 2);
        at(k) = 0.f;
        at(CA + 3 * k) = at(CA + 3 * k + 1) = at(CA + 3 * k + 2) = 0.f;
      }
      for (unsigned m = SCATTER ? 0u : lights_hit; m; m &= m - 1) {
        const int l = __ffs(m) - 1;
        for (int c = 0; c < 3; ++c) {
          at(GI + 3 * l + c) += cI[3 * l + c];
          cI[3 * l + c] = 0.f;
        }
      }
      slots_hit = lights_hit = 0u;
    }
    alive = alive_next;
  }

  const float dom = in_domain ? 1.f : 0.f;
  const float Lr = at(LR), Lg = at(LR + 1), Lb = at(LR + 2);
  p.lr[idx] = Lr * dom;
  p.lg[idx] = Lg * dom;
  p.lb[idx] = Lb * dom;
  p.n_samp[idx] = n_samp;
  const int rays = block_sum_int(n_live, iscratch);
  if (col == 0) p.nrays[row] = rays;
  if (SCATTER) return;  // the atlas gradient went out during the walk

  if (p.gl) {
    // phase "adjoint": raw per-lane accumulators, cotangent applied outside
    const size_t plane = (size_t)gridDim.x * LANES;
    for (int k = 0; k < 3 * S; ++k) p.gl[k * plane + idx] = at(GA + k);
    for (int k = 0; k < 3 * NL; ++k)
      p.gl[(3 * S + k) * plane + idx] = at(GI + k);
    return;
  }

  // ---- phase "both": the lane-local MSE cotangent (lane == pixel), then
  // every partial in a fixed order in one pass: each warp's shuffle
  // tree over its 32 lanes, then the row's four warp sums in order
  const bool have = n_samp > 0 && in_domain;
  const float havef = have ? 1.f : 0.f;
  const float inv_n = havef / fmaxf((float)n_samp, 1.f);
  const float* tg = p.target + (size_t)idx * 3;
  const float d_r = (Lr * inv_n - tg[0]) * havef;
  const float d_g = (Lg * inv_n - tg[1]) * havef;
  const float d_b = (Lb * inv_n - tg[2]) * havef;
  // g folded with the 1/n of the pixel mean
  const float g[3] = {d_r * (2.f * p.inv_loss_n) * inv_n,
                      d_g * (2.f * p.inv_loss_n) * inv_n,
                      d_b * (2.f * p.inv_loss_n) * inv_n};
  const int K = 3 * S + 3 * NL + 1;
  float* ws = smem + LANES * (LR + 3);  // [K][4] warp sums
  const int warp = col >> 5;
  const bool lead = (col & 31) == 0;
  for (int k = 0; k < 3 * S; ++k) {
    const float v = warp_tree(g[k % 3] * at(GA + k));
    if (lead) ws[4 * k + warp] = v;
  }
  for (int k = 0; k < 3 * NL; ++k) {
    const float v = warp_tree(g[k % 3] * at(GI + k));
    if (lead) ws[4 * (3 * S + k) + warp] = v;
  }
  const float sse = warp_tree(d_r * d_r + d_g * d_g + d_b * d_b);
  if (lead) ws[4 * (K - 1) + warp] = sse;
  __syncthreads();
  float* part = p.partials + (size_t)row * K;
  for (int k = col; k < K; k += LANES) {
    const float* w = ws + 4 * k;
    const float v = ((w[0] + w[1]) + w[2]) + w[3];
    part[k] = k == K - 1 ? v * p.inv_loss_n : v;
  }
}

// Dynamic shared memory of one block, in bytes: per lane the adjoint in
// shared memory (launch 1: 7 words per slot, 3 per light) and the radiance
// sums, then the epilogue's four warp sums per partial (3 per slot, 3 per
// light, the loss).
__host__ __device__ constexpr int smem_bytes(int S, int NL, bool scatter) {
  return 4 * (scatter ? LANES * 3
                      : LANES * (7 * S + 3 * NL + 3) +
                            4 * (3 * S + 3 * NL + 1));
}

// Launch 1, phases "both" and "adjoint". Blocks per SM: 7 for the sphere
// build (at most 73 registers; at the 80 nvcc picks by itself, 6 blocks fit
// and its NEE walk ran ~9% slower), 6 for the mesh builds (at most 85; asked
// for 1 block, nvcc takes 103 registers and the walk runs ~7% slower).
template <bool MESH, bool TEX, bool DOF>
__global__ void __launch_bounds__(LANES, MESH ? 6 : 7)
    replay_persistent_kernel(const __grid_constant__ Params p) {
  replay_walk<MESH, TEX, DOF, false>(p);
}

// Launch 2, phase "scatter": the textured walk replayed, scattering the
// atlas gradient.
template <bool DOF>
__global__ void __launch_bounds__(LANES, 6)
    replay_scatter_kernel(const __grid_constant__ Params p) {
  replay_walk<true, true, DOF, true>(p);
}

// Launches `kernel` over `rows` blocks with `smem` bytes of dynamic shared
// memory (above 48 KB only after the opt-in).
cudaError_t launch(const void* kernel, int rows, int smem, cudaStream_t st,
                   Params p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(rows), dim3(LANES),
                                           args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The kernel of one build: the scatter walk, or launch 1 with or without
// the mesh, the textures and the lens.
const void* kernel_of(bool scatter, bool mesh, bool tex, bool dof) {
  if (scatter)
    return dof ? (const void*)replay_scatter_kernel<true>
               : (const void*)replay_scatter_kernel<false>;
  if (!mesh)
    return dof ? (const void*)replay_persistent_kernel<false, false, true>
               : (const void*)replay_persistent_kernel<false, false, false>;
  if (!tex)
    return dof ? (const void*)replay_persistent_kernel<true, false, true>
               : (const void*)replay_persistent_kernel<true, false, false>;
  return dof ? (const void*)replay_persistent_kernel<true, true, true>
             : (const void*)replay_persistent_kernel<true, true, false>;
}

}  // namespace

extern "C" {

// Launch one fused value-and-grad walk on `stream`. prims/lights/cam/
// uniforms/target, the mesh tables and every output are device pointers;
// pflags/slots/lstruct are host arrays, copied with the tables into
// __constant__ memory on the same stream. `slots` holds the adjoint slot of
// each prim's material, then of each of the n_mats materials (-1 for a
// material on no surface). Exactly one of `partials` (phase "both") and `gl`
// (phase "adjoint") is non-NULL, or neither for the scatter walk; n_nodes
// == 0 means no mesh; a non-NULL atlas (tex_k, tex_th, tex_tw, 3), with a
// mesh, runs the textured build, and `ct` (3 spp planes, zeroed by the
// caller) then receives each completed path's C_tot. A non-NULL `gT` (the
// atlas gradient, zeroed by the caller) runs the scatter walk, which reads
// the cotangent `g` (3 planes), launch 1's records `ct_in` and final counts
// `nsf`, and adds into gT with atomics. use_dof runs the thin-lens build.
// Returns the first CUDA error (0 on success).
int tpt_replay_persistent(
    const float* prims, const int* pflags, const int* slots, int n_prims,
    int n_mats, const float* lights, const int* lstruct, int n_lights,
    int n_slots, const float* cam, const float* uniforms, const float* target,
    float* lr, float* lg, float* lb, int* n_samp, int* nrays, float* partials,
    float* gl, const float* mesh_nodes, const float* mesh_tris,
    const float* mesh_mats, const float* tri_lights,
    int n_nodes, const float* atlas, int tex_k, int tex_th, int tex_tw,
    float* ct, const float* g, const float* ct_in, const int* nsf, float* gT,
    int rows_total, int tile_rows, int budget, int spp,
    int width, int n_lanes, int max_bounces, int rr_start, int use_nee,
    int use_dof, int strat_k, int tile_offset, float inv_loss_n, uint32_t seed,
    uint32_t salt, uint32_t iteration, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_mats < 0 ||
      n_mats > MAX_MATS || n_lights < 0 || n_lights > MAX_GRAD_LIGHTS ||
      n_slots < 0 || n_slots > MAX_SLOTS || rows_total <= 0 ||
      tile_rows <= 0 || rows_total % tile_rows != 0 || width <= 0 ||
      strat_k < 1 || n_nodes < 0 ||
      (n_nodes > 0 && !(mesh_nodes && mesh_tris && mesh_mats &&
                        tri_lights)) ||
      (atlas && (n_nodes == 0 || tex_k <= 0 || tex_th <= 0 || tex_tw <= 0)) ||
      (ct && !atlas) ||
      (gT ? !(atlas && g && ct_in && nsf) || partials || gl || ct
          : (partials == nullptr) == (gl == nullptr)))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < n_prims + n_mats; ++q)
    if (slots[q] < (q < n_prims ? 0 : -1) || slots[q] >= n_slots)
      return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n_slots, n_lights, gT != nullptr);
  if (smem > MAX_SMEM_BLOCK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_prims > 0) {
    err = cudaMemcpyToSymbolAsync(c_prims, prims, sizeof(float) * 12 * n_prims,
                                  0, cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_pflags, pflags, sizeof(int) * n_prims,
                                    0, cudaMemcpyHostToDevice, st);
  }
  if (err == cudaSuccess && n_prims + n_mats > 0)
    err = cudaMemcpyToSymbolAsync(c_slot, slots,
                                  sizeof(int) * (n_prims + n_mats), 0,
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
  p.budget = budget;
  p.spp = spp;
  p.width = width;
  p.n_lanes = n_lanes;
  p.max_bounces = max_bounces;
  p.rr_start = rr_start;
  p.use_nee = use_nee;
  p.strat_k = strat_k;
  p.tile_offset = tile_offset;
  p.inv_loss_n = inv_loss_n;
  p.seed = seed;
  p.salt = salt;
  p.iteration = iteration;
  p.uniforms = uniforms;
  p.target = target;
  p.lr = lr;
  p.lg = lg;
  p.lb = lb;
  p.n_samp = n_samp;
  p.nrays = nrays;
  p.partials = partials;
  p.gl = gl;
  p.mesh.nodes = reinterpret_cast<const float4*>(mesh_nodes);
  p.mesh.tris = mesh_tris;
  p.mesh.mats = mesh_mats;
  p.mesh.tl = tri_lights;
  p.mesh.n_nodes = n_nodes;
  p.atlas = atlas;
  p.tex_k = tex_k;
  p.tex_th = tex_th;
  p.tex_tw = tex_tw;
  p.ct = ct;
  p.g = g;
  p.ct_in = ct_in;
  p.nsf = nsf;
  p.gT = gT;

  return (int)launch(kernel_of(gT != nullptr, n_nodes > 0, atlas != nullptr,
                               use_dof != 0),
                     rows_total, smem, st, p);
}

// Bytes of dynamic shared memory per block of the walk for n_slots and
// n_lights (ops/kernels/replay_persistent.py::replay_smem_bytes computes
// the same), and the blocks per SM that it and the registers of one build
// allow (cudaOccupancyMaxActiveBlocksPerMultiprocessor; -1 on an error).
int tpt_replay_smem_bytes(int n_slots, int n_lights, int scatter) {
  return smem_bytes(n_slots, n_lights, scatter != 0);
}

int tpt_replay_occupancy(int mesh, int tex, int dof, int scatter, int n_slots,
                         int n_lights) {
  const int smem = smem_bytes(n_slots, n_lights, scatter != 0);
  const void* kernel = kernel_of(scatter != 0, mesh != 0, tex != 0, dof != 0);
  int n = -1;
  if (smem > MAX_SMEM_BLOCK ||
      (smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, LANES, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
