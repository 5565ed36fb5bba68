// Device math shared by the persistent forward kernel (persistent.cu), the
// persistent fused value-and-grad kernel (replay_persistent.cu), the tangent
// kernel (camera_jvp.cu) and the per-sample kernels (trace.cu, replay.cu).
//
// Only code that is the same math in the TPU kernels that use it lives here:
// the uniforms of one wavefront iteration and of one per-sample lane, the
// camera ray of a path and its thin lens, the three BSDF lobes (the diffuse
// one through the polar disk map, and through the concentric map for the
// per-sample forward kernel), the NEE light samples (point light, cone
// sampling of a sphere light, area sampling of a triangle light), the MIS
// pdfs of sphere and triangle emitter hits, the BVH walk over pack_bvh's
// tree (with the hit's texture uv on request) and the bilinear texel of the
// texture atlas, and the per-sample kernels' sphere closest hit and
// quadratic shadow test. The persistent kernels' sphere loops differ from
// those (tie rule, segment-ball occlusion) and stay in each kernel.
//
// Everything is in an anonymous namespace: each translation unit gets its
// own copy and no symbol of this header reaches the library's interface.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MAX_PRIMS = 256;
constexpr int MAX_LIGHTS = 64;
// The gradient kernels' adjoint: materials on a surface ("slots") and
// lights with an intensity adjoint (replay_persistent.cu, replay.cu).
constexpr int MAX_SLOTS = 16;
constexpr int MAX_GRAD_LIGHTS = 16;
constexpr float BIG = 1e30f;
constexpr float TMIN = 3e-2f;  // EPSILON, reference globals.h:49
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_PI = 0.318309886183790671538f;
constexpr int SPECULAR = 1;
constexpr int TRANSMISSIVE = 2;
constexpr int AREA_LIGHT = 1;
constexpr int TRI_LIGHT = 2;
// Ints per light of the light structure: type, prim (sphere light, else -1),
// material (triangle light, else -1), first row and row count of its
// triangles in the triangle-light table.
constexpr int LS = 5;
constexpr int TRI_STRIDE = 16;  // floats per packed triangle slot
constexpr int TL_STRIDE = 14;   // floats per triangle-light row
constexpr int MAT_STRIDE = 6;   // floats per mesh material: r g b coef type tex

// The 1e5-radius wall spheres make the quadratic b^2 - |op|^2 + r^2 cancel
// badly in f32, so one ulp there changes which surface a lane hits. XLA on
// the CPU contracts multiply-adds into FMAs, nvcc does too but in its own
// pattern, and the plain PyTorch versions round every step. So the
// quadratics and the hit points use explicit FMAs in XLA's pattern, which
// the plain versions reproduce; elsewhere nvcc contracts as it likes.
__device__ __forceinline__ float dot3_fma(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return fmaf(az, bz, fmaf(ax, bx, __fmul_rn(ay, by)));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// top 24 bits -> [0, 1), exact in f32
__device__ __forceinline__ float bits_to_uniform(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// Philox stream tags, the high half of the counter's last word: each kernel
// draws under its own, so that no two of them replay each other's paths.
// The plain PyTorch versions use the same tags (utils/rng.py lists them).
constexpr uint32_t STREAM_FORWARD = 0x00000u;    // persistent.cu
constexpr uint32_t STREAM_GRADIENT = 0x10000u;   // replay_persistent.cu
constexpr uint32_t STREAM_TANGENT = 0x20000u;    // camera_jvp.cu
// 0x30000: the wavefront's draws (utils/rng.py, no kernel)
constexpr uint32_t STREAM_TRACE = 0x40000u;      // trace.cu
constexpr uint32_t STREAM_REPLAY = 0x50000u;     // replay.cu

// The n_draw uniforms of one wavefront iteration, in the TPU kernels' order
// u_cam v_cam [u_lens v_lens] u1 u2 u3 [ul1 ul2 usel] (the lens pair with a
// thin lens, the last three with NEE); N, 8 or 12, bounds n_draw. Test mode
// (`uniforms` non-NULL) reads the TPU kernels' external block (n_tiles,
// budget, n_draw, tile_rows, 128); production mode draws Philox keyed on
// (seed, salt), countered on (global lane, frame, iteration, stream | draw
// group), group g giving draws 4g to 4g+3: two groups always, a third when
// n_draw > 8. `stream` keeps the kernels' draws apart.
template <int N>
__device__ __forceinline__ void draw_uniforms(
    float (&u)[N], const float* uniforms, int tile, int budget, int it,
    int n_draw, int tile_lanes, int trow, int col, uint32_t lane,
    uint32_t frame, uint32_t seed, uint32_t salt, uint32_t stream) {
  static_assert(N == 8 || N == 12, "8 or 12 draws");
  if (uniforms) {
    const float* ub = uniforms +
                      (size_t)(tile * budget + it) * n_draw * tile_lanes +
                      trow * LANES + col;
#pragma unroll
    for (int j = 0; j < N; ++j) u[j] = j < n_draw ? ub[j * tile_lanes] : 0.f;
  } else {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (g < 2 || 4 * g < n_draw)
        a = philox4x32_10(make_uint4(lane, frame, it, stream | (uint32_t)g),
                          seed, salt);
      u[4 * g] = bits_to_uniform(a.x); u[4 * g + 1] = bits_to_uniform(a.y);
      u[4 * g + 2] = bits_to_uniform(a.z); u[4 * g + 3] = bits_to_uniform(a.w);
    }
  }
}

// Pinhole ray direction through the image-plane point (sx, sy), in pixels
// (cam: pack_camera layout).
__device__ __forceinline__ void pinhole_dir(const float* cam, float sx,
                                            float sy, float& dx, float& dy,
                                            float& dz) {
  dx = cam[0] - cam[6] * sy + cam[3] * sx;
  dy = cam[1] - cam[7] * sy + cam[4] * sx;
  dz = cam[2] - cam[8] * sy + cam[5] * sx;
  normalize3(dx, dy, dz);
}

// Primary ray direction of a regenerated path: stratified jitter over
// strat_k^2 cells picked by n_samp % strat_k^2 (cam: pack_camera layout).
__device__ __forceinline__ void camera_dir(const float* cam, float px,
                                           float py, int n_samp, int strat_k,
                                           float u_cam, float v_cam,
                                           float& dx, float& dy, float& dz) {
  float jx, jy;
  if (strat_k > 1) {
    const float inv_k = 1.0f / (float)strat_k;
    const int cell = n_samp % (strat_k * strat_k);
    jx = ((float)(cell % strat_k) + u_cam) * inv_k - 0.5f;
    jy = ((float)(cell / strat_k) + v_cam) * inv_k - 0.5f;
  } else {
    jx = u_cam - 0.5f;
    jy = v_cam - 0.5f;
  }
  pinhole_dir(cam, px + jx, py + jy, dx, dy, dz);
}

// Sub-pixel jitter of a per-sample lane (trace_kernel.py:148-156,
// replay_kernel.py:190-195): cell `cell` of a k x k grid, divided by k as
// those TPU kernels divide (the persistent kernels multiply by 1/k, which
// rounds otherwise when k is not a power of two). k = 1 is plain jitter.
__device__ __forceinline__ void jitter_div(int cell, int k, float u, float v,
                                           float& jx, float& jy) {
  jx = ((float)(cell % k) + u) / (float)k - 0.5f;
  jy = ((float)(cell / k) + v) / (float)k - 0.5f;
}

// The uniforms of one per-sample lane (trace.cu, replay.cu): draw j of the
// lane's n_draw, in the TPU kernels' order u_cam v_cam [u_lens v_lens], then
// per bounce u1 u2 u3 [ul1 ul2 usel]. Test mode (`ub` non-NULL) reads the
// TPU kernels' external block, (n_draw, tile_rows, 128) per tile: `ub` is
// this lane's first draw and `stride` = tile_rows * 128. Production mode
// draws Philox4x32-10 keyed on (seed, salt) and countered on (global lane,
// iteration, 0, stream | j / 4), word j % 4 of that group. The walks take
// draws in increasing j, so each group is computed once.
struct SampleDraws {
  const float* ub;
  int stride;
  uint32_t lane, iteration, seed, salt, stream;
  int group;
  uint4 words;

  __device__ __forceinline__ float operator()(int j) {
    if (ub) return ub[(size_t)j * stride];
    if ((j >> 2) != group) {
      group = j >> 2;
      words = philox4x32_10(
          make_uint4(lane, iteration, 0u, stream | (uint32_t)group), seed,
          salt);
    }
    const int w = j & 3;
    return bits_to_uniform(w == 0 ? words.x
                           : w == 1 ? words.y
                           : w == 2 ? words.z
                                    : words.w);
  }
};

// Thin lens of a regenerated path (TPU kernels: persistent.py:569-587,
// replay_persistent.py:512-527). On entry (o, d) is the pinhole ray; the
// origin moves to a point of the lens disk by the polar map (radius
// cam[12] sqrt(u_lens), angle 2 pi v_lens, along the view's u and v rows),
// and the ray aims at the pinhole ray's point on the plane of focus,
// cam[13] / cos(d, w) along it. A focal distance of 0 aims every ray at the
// lens centre, as in the TPU kernels. Every step is rounded on its own, as
// the plain version rounds it (no contraction): an origin one ulp off moves
// every later hit of the path, and this runs once per path.
__device__ __forceinline__ void thin_lens(const float* cam, float u_lens,
                                          float v_lens, float& ox, float& oy,
                                          float& oz, float& dx, float& dy,
                                          float& dz) {
  const float lens_r = __fmul_rn(cam[12], sqrtf(u_lens));
  const float phi = __fmul_rn(TWO_PI, v_lens);
  const float ldu = __fmul_rn(lens_r, cosf(phi));
  const float ldv = __fmul_rn(lens_r, sinf(phi));
  const float cos_w = __fadd_rn(
      __fadd_rn(__fmul_rn(dx, cam[20]), __fmul_rn(dy, cam[21])),
      __fmul_rn(dz, cam[22]));
  const float ft = __fdiv_rn(cam[13], fmaxf(cos_w, 1e-6f));
  const float fpx = __fadd_rn(ox, __fmul_rn(dx, ft));
  const float fpy = __fadd_rn(oy, __fmul_rn(dy, ft));
  const float fpz = __fadd_rn(oz, __fmul_rn(dz, ft));
  ox = __fadd_rn(__fadd_rn(ox, __fmul_rn(cam[14], ldu)), __fmul_rn(cam[17], ldv));
  oy = __fadd_rn(__fadd_rn(oy, __fmul_rn(cam[15], ldu)), __fmul_rn(cam[18], ldv));
  oz = __fadd_rn(__fadd_rn(oz, __fmul_rn(cam[16], ldu)), __fmul_rn(cam[19], ldv));
  dx = __fsub_rn(fpx, ox);
  dy = __fsub_rn(fpy, oy);
  dz = __fsub_rn(fpz, oz);
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float inv = rsqrtf(fmaxf(n2, 1e-20f));
  dx = __fmul_rn(dx, inv);
  dy = __fmul_rn(dy, inv);
  dz = __fmul_rn(dz, inv);
}

// Solid-angle pdf of cone-sampling the sphere light LP (a pack_prims row)
// from o, 0 from inside it; the MIS weight of an emitter hit uses it.
__device__ __forceinline__ float cone_pdf(const float* LP, float ox, float oy,
                                          float oz) {
  const float dlx = LP[0] - ox, dly = LP[1] - oy, dlz = LP[2] - oz;
  const float d2l = dot3(dlx, dly, dlz, dlx, dly, dlz);
  const float rl = LP[3];
  const float sin2 = fminf(rl * rl / fmaxf(d2l, 1e-12f), 1.f);
  const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
  const float pc = 1.f / (TWO_PI * fmaxf(1.f - ctm, 1e-12f));
  return d2l > rl * rl ? pc : 0.f;
}

struct LightSample {
  float wlx, wly, wlz, dist, pdf, rad_r, rad_g, rad_b;
  bool valid;
};

// NEE sample of light LT (a pack_lights row) from the hit point h. A sphere
// light (LP its pack_prims row, non-NULL) is cone-sampled around its centre
// and lights only its outer face; a point light is a delta light with 1/d^2
// falloff.
__device__ __forceinline__ LightSample sample_light(const float* LT,
                                                   const float* LP, float hx,
                                                   float hy, float hz,
                                                   float ul1, float ul2) {
  LightSample s;
  if (LP) {
    const float wrx = LP[0] - hx, wry = LP[1] - hy, wrz = LP[2] - hz;
    const float rl = LP[3];
    const float d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz);
    const float inv_dc = rsqrtf(fmaxf(d2l, 1e-20f));
    const float wcx = wrx * inv_dc, wcy = wry * inv_dc, wcz = wrz * inv_dc;
    const float sin2 = fminf(rl * rl / fmaxf(d2l, 1e-12f), 1.f);
    const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
    const float cth = 1.f - ul1 * (1.f - ctm);
    const float sth = sqrtf(fmaxf(1.f - cth * cth, 0.f));
    const float phi = TWO_PI * ul2;
    const bool usex = fabsf(wcx) > fabsf(wcz);
    float ax = usex ? -wcy : 0.f, ay = usex ? wcx : -wcz,
          az = usex ? 0.f : wcy;
    normalize3(ax, ay, az);
    const float bx = wcy * az - wcz * ay;
    const float by = wcz * ax - wcx * az;
    const float bz = wcx * ay - wcy * ax;
    const float cp = cosf(phi) * sth, sp = sinf(phi) * sth;
    s.wlx = ax * cp + bx * sp + wcx * cth;
    s.wly = ay * cp + by * sp + wcy * cth;
    s.wlz = az * cp + bz * sp + wcz * cth;
    const float bq = dot3_fma(wrx, wry, wrz, s.wlx, s.wly, s.wlz);
    const float detq = fmaf(rl, rl, fmaf(bq, bq, -d2l));
    const float thit = bq - sqrtf(fmaxf(detq, 0.f));
    s.valid = detq >= 0.f && thit > TMIN && d2l > rl * rl;
    const float inv_rl = 1.0f / rl;
    const float nsx = (hx + s.wlx * thit - LP[0]) * inv_rl;
    const float nsy = (hy + s.wly * thit - LP[1]) * inv_rl;
    const float nsz = (hz + s.wlz * thit - LP[2]) * inv_rl;
    s.valid = s.valid && dot3(nsx, nsy, nsz, -s.wlx, -s.wly, -s.wlz) > 0.f;
    s.pdf = LT[7] / (TWO_PI * fmaxf(1.f - ctm, 1e-12f));
    s.dist = thit;
    s.rad_r = LT[3];
    s.rad_g = LT[4];
    s.rad_b = LT[5];
  } else {
    const float wrx = LT[0] - hx, wry = LT[1] - hy, wrz = LT[2] - hz;
    const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
    const float inv_dl = rsqrtf(fmaxf(d2l, 1e-20f));
    s.dist = d2l * inv_dl;
    s.wlx = wrx * inv_dl;
    s.wly = wry * inv_dl;
    s.wlz = wrz * inv_dl;
    const float inv_d2 = inv_dl * inv_dl;
    s.rad_r = LT[3] * inv_d2;
    s.rad_g = LT[4] * inv_d2;
    s.rad_b = LT[5] * inv_d2;
    s.pdf = LT[7];
    s.valid = s.dist > TMIN;
  }
  return s;
}

// Area sampling of a triangle light (TL: its first row of the
// triangle-light table, K rows of v0 e1 e2 n cdf_hi area; LT its pack_lights
// row). The triangle is picked by the area cdf, the first k with
// ul1 <= cdf[k] (the TPU kernel's cdf-hi chain), and ul1's position inside
// [cdf[k-1], cdf[k]) is reused with ul2 for a uniform point on it; only the
// front (normal) side emits. TPU kernel: persistent.py:720-767.
__device__ __forceinline__ LightSample sample_tri_light(const float* TL,
                                                       int K, const float* LT,
                                                       float hx, float hy,
                                                       float hz, float ul1,
                                                       float ul2) {
  int k = 0;
  for (int q = 1; q < K; ++q)
    if (ul1 > __ldg(TL + (q - 1) * TL_STRIDE + 12)) k = q;
  const float* R = TL + k * TL_STRIDE;
  const float c_lo = k ? __ldg(R - TL_STRIDE + 12) : 0.f;
  const float c_hi = __ldg(R + 12);
  const float u0r =
      fminf(fmaxf((ul1 - c_lo) / fmaxf(c_hi - c_lo, 1e-12f), 0.f), 1.f);
  const float su = sqrtf(u0r);
  const float b1 = 1.f - su, b2 = ul2 * su;
  LightSample s;
  const float wrx = __ldg(R) + b1 * __ldg(R + 3) + b2 * __ldg(R + 6) - hx;
  const float wry = __ldg(R + 1) + b1 * __ldg(R + 4) + b2 * __ldg(R + 7) - hy;
  const float wrz = __ldg(R + 2) + b1 * __ldg(R + 5) + b2 * __ldg(R + 8) - hz;
  const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
  const float inv_dl = rsqrtf(fmaxf(d2l, 1e-20f));
  s.dist = d2l * inv_dl;
  s.wlx = wrx * inv_dl;
  s.wly = wry * inv_dl;
  s.wlz = wrz * inv_dl;
  const float cos_at =
      -dot3(__ldg(R + 9), __ldg(R + 10), __ldg(R + 11), s.wlx, s.wly, s.wlz);
  s.pdf = LT[7] * d2l / fmaxf(fabsf(cos_at) * fmaxf(__ldg(R + 13), 1e-20f),
                              1e-12f);
  s.valid = cos_at > 0.f && s.dist > TMIN;
  s.rad_r = LT[3];
  s.rad_g = LT[4];
  s.rad_b = LT[5];
  return s;
}

// Solid-angle pdf with which the triangle light (selection pdf `sel`, total
// area `area`) samples a point that a ray reached at distance t with cosine
// cos_l against the triangle: t^2 / |cos| * sel / area. TPU kernel:
// persistent.py:644-653.
__device__ __forceinline__ float tri_light_pdf(float t, float cos_l,
                                               float sel, float area) {
  const float tc = fminf(t, 1e6f);
  return tc * tc / fmaxf(fabsf(cos_l), 1e-9f) * (sel / fmaxf(area, 1e-20f));
}

// A mesh packed by ops/kernels/mesh_kernel.py::pack_bvh, with the tables
// the kernels read at mesh hits. n_nodes == 0: the scene has no mesh.
struct MeshView {
  const float4* nodes;  // (n_nodes, 2): min3 skip, max3 leaf
  const float* tris;    // (T, TRI_STRIDE) slots in MeshData triangle order:
                        // v0 e1 e2 mat uv0 uv_e1 uv_e2
  const float* mats;    // (n_mats, MAT_STRIDE): r g b coef type texture
  const float* tl;      // triangle-light rows (TL_STRIDE floats each)
  int n_nodes;
};

// A node's leaf word: first triangle | count << LEAF_BITS (0: inner node).
constexpr int LEAF_BITS = 24;
// 1 + 2 gamma(3) (Ize, "Robust BVH ray traversal", JCGT 2013), rounded up to
// 1 + 4 ulp: the far slab distance is scaled by it, so that rounding never
// drops a box that holds the hit.
constexpr float ROBUST = 1.00000047683716f;
// A box is pruned only when its entry distance is beyond t * PRUNE (1 +
// 2^-16): a triangle that lies on a box's face (a Cornell box standing on
// the floor, neighbouring terrain leaves) is hit at a t that rounds a few
// ulp below the box's entry distance.
constexpr float PRUNE = 1.0000152587890625f;

__device__ __forceinline__ float safe_inv(float a) {
  return 1.f / (fabsf(a) > 1e-12f ? a : (a >= 0.f ? 1e-12f : -1e-12f));
}

// Moller-Trumbore of a ray against a packed triangle slot, whose first
// three float4 are v0 = a.xyz, e1 = (a.w, b.x, b.y), e2 = (b.z, b.w, c.x):
// the barycentrics u, v and the distance t; false where the ray is
// parallel to the triangle's plane (|det| <= 1e-12, where u, v and t are
// computed with det = 1). The caller tests u, v and t.
__device__ __forceinline__ bool moller_trumbore(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                const float4& a,
                                                const float4& b,
                                                const float4& c, float& uu,
                                                float& vv, float& tt) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.f / (ok ? det : 1.f);
  const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
  uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  vv = (dx * qx + dy * qy + dz * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok;
}

// The unnormalized geometric normal cross(e1, e2) of a packed slot.
__device__ __forceinline__ float3 slot_normal(const float4& a,
                                              const float4& b,
                                              const float4& c) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  return make_float3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                     e1x * e2y - e1y * e2x);
}

// The BVH walk of ONE ray over pack_bvh's tree (replaces the TPU kernels'
// shared make_mesh_walk, ops/pallas/_walk.py:22; plain version
// ops/kernels/_walk.py::bvh_walk_ref). The TPU walk moves a whole tile of
// lanes through one node sequence of a tree with 64-triangle leaves, and
// its MXU tests a leaf for every lane at once. Here each thread walks its
// own ray, and what bounds it is latency: every node visit is a dependent
// read from memory, and the lanes of a warp diverge over the tree (the
// card has no ray-tracing units that the port may use). So the tree is the
// mesh's own, with leaves of a few triangles (a 64-triangle leaf costs 64
// tests, 45 operations each, wherever the ray enters its box); a mesh of
// at most 40 triangles is one leaf, which all lanes of a warp test in step.
// The walk is stackless, in DFS order through skip links: a node is 32
// bytes, its box and links read as two float4, and it keeps no state but
// the node index. (A near-first walk over nodes that hold both children's
// boxes, with a per-thread stack, tested fewer boxes and triangles but ran
// slower on the card: PERF.md, Findings.) From t (> 0; the sphere pass's t in
// the persistent kernels), closest mode (OCCLUSION false) returns the
// closest t (t itself if none is closer) with the unnormalized normal
// cross(e1, e2) and the material of the winner, and with TRACK_UV its
// texture uv, uv0 + u uv_e1 + v uv_e2 at its barycentrics (u, v) (TPU
// walk: _walk.py:142-157); occlusion mode returns 0 at the first triangle
// in (TMIN, t). Leaves are visited in triangle order and a hit must be
// strictly closer, so an equal t goes to the lower triangle index, as in
// the TPU walk. The box test is robust (ROBUST, PRUNE), so the walk enters
// every box whose triangle the ray hits. With SLOT_ONLY (the packet kernel,
// packet.cu) the closest walk keeps only the winner's slot, in *slot (its
// MeshData triangle id), and leaves the attributes to its caller, which
// resolves them once after the walk: carrying them through the walk cost
// that kernel 14 registers and 8% on a closest-hit wave (PERF.md,
// Findings). The packet kernel also passes its caller's tmin in place of
// TMIN.
template <bool OCCLUSION, bool TRACK_UV, bool SLOT_ONLY = false>
__device__ __forceinline__ float bvh_walk(const MeshView& m, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t,
                                          float& gnx, float& gny, float& gnz,
                                          int& mat, float& hu, float& hv,
                                          float tmin = TMIN,
                                          int* slot = nullptr) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  int node = 0;
  while (node < m.n_nodes) {
    const float4 lo = __ldg(m.nodes + 2 * node);
    const float4 hi = __ldg(m.nodes + 2 * node + 1);
    const float tx0 = (lo.x - ox) * ix, tx1 = (hi.x - ox) * ix;
    const float ty0 = (lo.y - oy) * iy, ty1 = (hi.y - oy) * iy;
    const float tz0 = (lo.z - oz) * iz, tz1 = (hi.z - oz) * iz;
    const float tn =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float tf =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) *
        ROBUST;
    if (!(tn <= tf && tf > tmin && tn <= t * PRUNE)) {
      node = __float_as_int(lo.w);  // skip the subtree
      continue;
    }
    const int leaf = __float_as_int(hi.w);
    if (leaf == 0) {  // inner node: descend to its first child
      ++node;
      continue;
    }
    // a leaf: Moller-Trumbore on its triangles in order, strictly closer
    // wins
    const int first = leaf & ((1 << LEAF_BITS) - 1);
    const int count = leaf >> LEAF_BITS;
    const float4* S =
        reinterpret_cast<const float4*>(m.tris + (size_t)first * TRI_STRIDE);
    for (int j = count; j > 0; --j, S += TRI_STRIDE / 4) {
      const float4 a = __ldg(S), b = __ldg(S + 1), c = __ldg(S + 2);
      float uu, vv, tt;
      const bool ok = moller_trumbore(ox, oy, oz, dx, dy, dz, a, b, c, uu,
                                      vv, tt);
      if (!(ok && uu >= 0.f && vv >= 0.f && uu + vv <= 1.f && tt > tmin &&
            tt < t))
        continue;
      if (OCCLUSION) return 0.f;
      t = tt;
      if (SLOT_ONLY) {
        *slot = first + count - j;
        continue;
      }
      const float3 g = slot_normal(a, b, c);
      gnx = g.x;
      gny = g.y;
      gnz = g.z;
      mat = (int)c.y;
      if (TRACK_UV) {
        // uv0 = (c.z, c.w); uv_e1 = (d.x, d.y); uv_e2 = (d.z, d.w)
        const float4 d = __ldg(S + 3);
        hu = c.z + uu * d.x + vv * d.z;
        hv = c.w + uu * d.y + vv * d.w;
      }
    }
    node = __float_as_int(lo.w);
  }
  return t;
}

// Is a triangle of the mesh in (TMIN, tmax) along d from o?
__device__ __forceinline__ bool bvh_occluded(const MeshView& m, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float tmax) {
  float gx, gy, gz, hu, hv;
  int mt;
  return bvh_walk<true, false>(m, ox, oy, oz, dx, dy, dz, tmax, gx, gy, gz,
                               mt, hu, hv) == 0.f;
}

// The bilinear taps of a (th, tw) texture at uv, with the TPU kernel's index
// arithmetic (persistent.py:419-438): uv wrapped by u - floor(u), the four
// taps' rows r0, r1 and columns c0, c1 wrapped into the texture, fx and fy
// the weights of c1 and r1. The indices are clamped into the texture, which
// changes nothing for a finite uv.
struct Taps {
  int r0, r1, c0, c1;
  float fx, fy;
};

__device__ __forceinline__ Taps texel_taps(int th, int tw, float u, float v) {
  const float x = (u - floorf(u)) * (float)tw - 0.5f;
  const float y = (v - floorf(v)) * (float)th - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  Taps t;
  t.fx = x - x0;
  t.fy = y - y0;
  const int xi = (int)x0, yi = (int)y0;
  t.c0 = min(max(xi < 0 ? xi + tw : xi, 0), tw - 1);
  t.c1 = min(max(xi + 1 >= tw ? xi + 1 - tw : xi + 1, 0), tw - 1);
  t.r0 = min(max(yi < 0 ? yi + th : yi, 0), th - 1);
  t.r1 = min(max(yi + 1 >= th ? yi + 1 - th : yi + 1, 0), th - 1);
  return t;
}

// Bilinear texel of texture k of a (K, TH, TW, 3) f32 atlas at uv
// (texel_taps), y interpolated before x. The TPU contracts two-hot rows with
// the atlas on its MXU for want of a per-lane gather; here each lane reads
// its four taps through the read-only cache (a 256^2 atlas is 0.79 MB, so it
// sits in L2).
__device__ __forceinline__ float3 texel(const float* atlas, int k, int th,
                                        int tw, float u, float v) {
  const Taps t = texel_taps(th, tw, u, v);
  const float* T = atlas + (size_t)k * th * tw * 3;
  const float* t00 = T + ((size_t)t.r0 * tw + t.c0) * 3;
  const float* t01 = T + ((size_t)t.r0 * tw + t.c1) * 3;
  const float* t10 = T + ((size_t)t.r1 * tw + t.c0) * 3;
  const float* t11 = T + ((size_t)t.r1 * tw + t.c1) * 3;
  float out[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col0 = (1.f - t.fy) * __ldg(t00 + ch) + t.fy * __ldg(t10 + ch);
    const float col1 = (1.f - t.fy) * __ldg(t01 + ch) + t.fy * __ldg(t11 + ch);
    out[ch] = (1.f - t.fx) * col0 + t.fx * col1;
  }
  return make_float3(out[0], out[1], out[2]);
}

struct Lobe {
  float wix, wiy, wiz, fr, fg, fb, pdf, wgt;  // wgt = |cos| / pdf
};

// One BSDF lobe per lane: cosine hemisphere through the polar disk map
// (diffuse), mirror reflection (specular), or the Fresnel dielectric, whose
// reflection choice reuses u1.
__device__ __forceinline__ Lobe sample_lobe(bool is_s, bool is_t, float nx,
                                            float ny, float nz, float wox,
                                            float woy, float woz, float ar,
                                            float ag, float ab, float coef,
                                            float u1, float u2) {
  Lobe l;
  const float won = dot3(wox, woy, woz, nx, ny, nz);
  if (!(is_s || is_t)) {
    const float r_d = sqrtf(u1);
    const float th = TWO_PI * u2;
    const float ldx = r_d * cosf(th), ldy = r_d * sinf(th);
    const float ldz = sqrtf(fmaxf(1.f - u1, 0.f));
    const bool use_x = fabsf(nx) > fabsf(nz);
    float ux = use_x ? -ny : 0.f, uy = use_x ? nx : -nz, uz = use_x ? 0.f : ny;
    normalize3(ux, uy, uz);
    const float vx = ny * uz - nz * uy;
    const float vy = nz * ux - nx * uz;
    const float vz = nx * uy - ny * ux;
    l.wix = ux * ldx + vx * ldy + nx * ldz;
    l.wiy = uy * ldx + vy * ldy + ny * ldz;
    l.wiz = uz * ldx + vz * ldy + nz * ldz;
    l.pdf = dot3(wox, woy, woz, l.wix, l.wiy, l.wiz) < 0.f ? ldz * INV_PI : 0.f;
    l.fr = ar * INV_PI;
    l.fg = ag * INV_PI;
    l.fb = ab * INV_PI;
    l.wgt = PI_F;  // cos/pdf is exactly pi
    return l;
  }
  // mirror reflection, shared by the specular lobe and the dielectric
  const float wsx = wox - 2.f * won * nx;
  const float wsy = woy - 2.f * won * ny;
  const float wsz = woz - 2.f * won * nz;
  if (is_s) {
    l.wix = wsx; l.wiy = wsy; l.wiz = wsz;
    l.fr = coef * ar;
    l.fg = coef * ag;
    l.fb = coef * ab;
  } else {
    const bool entering = won < 0.f;
    const float ior = fmaxf(coef, 1.f);
    const float n1 = entering ? 1.f : ior, n2 = entering ? ior : 1.f;
    const float sgn = entering ? 1.f : -1.f;
    const float nnx = nx * sgn, nny = ny * sgn, nnz = nz * sgn;
    const float cos_i = -(wox * nnx + woy * nny + woz * nnz);
    const float eta = n1 / n2;
    const float sin2t = eta * eta * (1.f - cos_i * cos_i);
    const float cos_t = sqrtf(fmaxf(1.f - sin2t, 0.f));
    const float r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t);
    const float r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t);
    const float refl =
        sin2t > 1.f ? 1.f : 0.5f * (r_orth * r_orth + r_par * r_par);
    if (u1 < refl) {
      l.wix = wsx; l.wiy = wsy; l.wiz = wsz;
    } else {
      const float k = eta * (-cos_i) + cos_t;
      l.wix = wox * eta - k * nnx;
      l.wiy = woy * eta - k * nny;
      l.wiz = woz * eta - k * nnz;
    }
    l.fr = ar;
    l.fg = ag;
    l.fb = ab;
  }
  l.pdf = 1.f;
  l.wgt = fabsf(dot3(l.wix, l.wiy, l.wiz, nx, ny, nz));
  return l;
}

// The diffuse lobe of the per-sample forward kernel (trace_kernel.py:
// 385-420, 487-488): the concentric disk map (Shirley-Chiu) with its
// degenerate centre and the zero-safe divides, lifted to the cosine
// hemisphere in the frame of n, re-normalized, and weighted by cos / pdf as
// computed (no wgt = pi shortcut: the re-normalized direction's cosine is
// not exactly the disk's z).
__device__ __forceinline__ Lobe sample_diffuse_concentric(
    float nx, float ny, float nz, float wox, float woy, float woz, float ar,
    float ag, float ab, float u1, float u2) {
  const float sx = 2.f * u1 - 1.f, sy = 2.f * u2 - 1.f;
  const bool in_r12 = sx >= -sy;
  const bool in_r1 = in_r12 && sx > sy;
  const bool in_r2 = in_r12 && !in_r1;
  const bool in_r3 = !in_r12 && sx <= sy;
  // a / b with b replaced by 1 where it is 0
  const float sy_sx = sy / (fabsf(sx) > 0.f ? sx : 1.f);
  const float sx_sy = sx / (fabsf(sy) > 0.f ? sy : 1.f);
  const float rr = in_r1 ? sx : in_r2 ? sy : in_r3 ? -sx : -sy;
  float th = in_r1 ? sy_sx
             : in_r2 ? 2.f - sx_sy
             : in_r3 ? 4.f + sy_sx
                     : 6.f - sx_sy;
  th = th * (PI_F / 4.f);
  const bool degen = sx == 0.f && sy == 0.f;
  const float ldx = degen ? 0.f : rr * cosf(th);
  const float ldy = degen ? 0.f : rr * sinf(th);
  // both products fused, as XLA computes it: at the disk's rim the rounded
  // form gives 0 where XLA gives ~3e-8, and the lobe's pdf flips to 0
  const float ldz = sqrtf(fmaxf(fmaf(-ldy, ldy, fmaf(-ldx, ldx, 1.f)), 0.f));
  const bool use_x = fabsf(nx) > fabsf(nz);
  float ux = use_x ? -ny : 0.f, uy = use_x ? nx : -nz, uz = use_x ? 0.f : ny;
  normalize3(ux, uy, uz);
  const float vx = ny * uz - nz * uy;
  const float vy = nz * ux - nx * uz;
  const float vz = nx * uy - ny * ux;
  Lobe l;
  l.wix = ux * ldx + vx * ldy + nx * ldz;
  l.wiy = uy * ldx + vy * ldy + ny * ldz;
  l.wiz = uz * ldx + vz * ldy + nz * ldz;
  normalize3(l.wix, l.wiy, l.wiz);
  const float cos_d = fabsf(dot3(l.wix, l.wiy, l.wiz, nx, ny, nz));
  l.pdf = dot3(wox, woy, woz, l.wix, l.wiy, l.wiz) < 0.f ? cos_d * INV_PI
                                                         : 0.f;
  l.fr = ar * INV_PI;
  l.fg = ag * INV_PI;
  l.fb = ab * INV_PI;
  l.wgt = cos_d / fmaxf(l.pdf, 1e-20f);
  return l;
}

// A closest sphere hit of the per-sample kernels (trace.cu, replay.cu):
// the hit point and normal, the material and the emission of its prim.
struct SphereHit {
  bool hit, emissive;
  int prim, mtype;
  float hx, hy, hz, nx, ny, nz, ar, ag, ab, coef, er, eg, eb;
};

// Closest sphere hit over the pack_prims table `prims` (flags `pflags`:
// bit 0 emissive, bits 1-2 type) with the primitive.h:44 roots: t0 = b - sq
// if t0 > tmin, else b + sq; the strict < keeps the first prim on an exact
// tie. The normal multiplies by the radius's reciprocal (RECIP, as
// replay_kernel.py:159 does) or divides by the radius (trace_kernel.py:
// 200-202).
template <bool RECIP>
__device__ __forceinline__ SphereHit closest_sphere(
    const float* prims, const int* pflags, int n_prims, float ox, float oy,
    float oz, float dx, float dy, float dz) {
  float best_t = BIG;
  int best_p = 0;
  for (int q = 0; q < n_prims; ++q) {
    const float* P = prims + q * 12;
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
  SphereHit h;
  h.hit = best_t < 0.5f * BIG;
  h.prim = best_p;
  if (!h.hit) return h;
  const float* HP = prims + best_p * 12;
  const int pflag = pflags[best_p];
  h.hx = fmaf(dx, best_t, ox);
  h.hy = fmaf(dy, best_t, oy);
  h.hz = fmaf(dz, best_t, oz);
  if (RECIP) {
    const float inv_r = 1.0f / HP[3];
    h.nx = (h.hx - HP[0]) * inv_r;
    h.ny = (h.hy - HP[1]) * inv_r;
    h.nz = (h.hz - HP[2]) * inv_r;
  } else {
    h.nx = (h.hx - HP[0]) / HP[3];
    h.ny = (h.hy - HP[1]) / HP[3];
    h.nz = (h.hz - HP[2]) / HP[3];
  }
  h.ar = HP[4];
  h.ag = HP[5];
  h.ab = HP[6];
  h.mtype = (pflag >> 1) & 3;
  h.coef = h.mtype == SPECULAR || h.mtype == TRANSMISSIVE ? HP[7] : 0.f;
  h.emissive = pflag & 1;
  h.er = h.emissive ? HP[9] : 0.f;
  h.eg = h.emissive ? HP[10] : 0.f;
  h.eb = h.emissive ? HP[11] : 0.f;
  return h;
}

// Shadow any-hit of the per-sample kernels (scene.h:101-108): does any
// sphere of `prims` but `skip` (-1: none) have a quadratic root in
// (tmin, smax) along w from h? Stops at the first occluder.
__device__ __forceinline__ bool sphere_occluded(const float* prims,
                                                int n_prims, int skip,
                                                float hx, float hy, float hz,
                                                float wx, float wy, float wz,
                                                float smax) {
  for (int q = 0; q < n_prims; ++q) {
    if (q == skip) continue;
    const float* P = prims + q * 12;
    const float sx = P[0] - hx, sy = P[1] - hy, sz = P[2] - hz;
    const float rb = dot3_fma(sx, sy, sz, wx, wy, wz);
    const float rdet =
        fmaf(P[3], P[3], fmaf(rb, rb, -dot3_fma(sx, sy, sz, sx, sy, sz)));
    const float rsq = sqrtf(fmaxf(rdet, 0.f));
    const float rt = rb - rsq > TMIN ? rb - rsq : rb + rsq;
    if (rdet >= 0.f && rt > TMIN && rt < smax) return true;
  }
  return false;
}

// Sum of one value over a warp's 32 lanes by a fixed shuffle tree (lane i
// adds lane i + 16, then i + 8, ... i + 1), valid on lane 0. Every lane of
// the warp must call it.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Per-block sum of an int over the block's 128 threads (exact, so any
// order gives the same sum). `scratch` holds 4 ints of shared memory;
// every thread of the block must call it. The sum is valid on thread 0.
__device__ __forceinline__ int block_sum_int(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return threadIdx.x == 0 ? scratch[0] + scratch[1] + scratch[2] + scratch[3]
                          : 0;
}

}  // namespace
