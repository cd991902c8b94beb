// Whitted megakernel for NVIDIA Hopper (sm_90a): one thread renders one
// pixel, start to finish; without triangles (K1, K2, K5) the threads of a
// warp shade their solid hits together.
//
// Replaces: tpuray/kernels/pallas_trace.py, _make_kernel.kernel (:659),
// launched by _pallas_forward (:2314) on 16x128 pixel tiles, plus the XLA
// texel-event resolve _resolve_events (:2468) that followed it.
// Instantiations of one body, megakernel<RECORD, TRIS, BILINEAR>:
//   <false, false, false>  K1, the base configuration (render_pallas :2452);
//   <false, true, *>       K3 and K4, with a triangle table (triangles
//                          resident in VMEM up to 32,768, or streamed from
//                          HBM up to 524,288: tri_closest :1196,
//                          tri_feeler_multi :1325, tri_pair_sum :931, the
//                          culls :988-1194, the DMA blocks :816-862);
//   <*, *, true>           K2, filter='bilinear' (:1882-1943): 4 weighted
//                          taps per texel fetch, in primitives.bilinear_taps
//                          order, sky taps clamped, texture taps wrapped;
//   <true, *, *>           K5, record mode (render_pallas_record :2665): the
//                          same image plus one record per DFS node for the
//                          gradient's replay (megakernel.py
//                          render_megakernel_record), triangle hits as
//                          TRI_CODE with the winner's id, 4 texel picks per
//                          node under BILINEAR.
// The host picks TRIS from the scene's triangle count and BILINEAR from the
// filter, so that each configuration runs code with none of the others' in
// it: compiled in, the triangle walk took stack frame and spills (K1 79 ->
// 80 registers, 800 -> 928 bytes, 24 B of spill stores) and 3-8% of K1's
// and K5's time on scenes that never ran it (PERF.md).
//
// What bounds it on this card: neither device-memory bytes nor a matrix
// unit.  The scene is ~0.6 KB and every thread of a warp reads the same
// scene word at the same time (a broadcast from the read-only cache); the
// only per-pixel traffic is 12 bytes of output and a few texel reads.  The
// work is scalar fp32 arithmetic, sqrt/rsqrt/sin/cos/pow and branches:
// per DFS node 3 light + 4 sphere + 2 plane tests, then at a solid hit per
// light and shadow sample a point on the light (4 precise sin/cos) and 6
// occluder tests.  A warp runs as long as its deepest pixel, and at
// 800x600 depth 15 that pixel sets the frame: the 32 rows that hold the
// glass spheres' pixels of 40 to 116 nodes took 86-89% of K1's frame time
// on their own, two thirds of it in the shadow feelers (PERF.md).  With one
// thread shading its node alone, each node is a serial chain of all nl x
// ss feelers, and the deepest pixel runs 116 nodes in a row while most of
// its warp's lanes, and most of the card, sit idle.
//
// K1, K2 and K5 (COOP below) therefore shade a warp's solid hits together
// (warp_shade): each lane still finds its own node's hit, ambient or texel
// term, Phong sums and continuation, but the nl x ss shadow feelers of all
// the warp's solid hits are shared out over its 32 lanes, one feeler a
// lane a round.  A lane whose pixel is done, or lies outside the image,
// stays in the DFS loop as a helper until the warp's last pixel is done.
// A deep node's chain shrinks to its hit tests, one round of feelers and
// the Phong sums (the deep rows' feeler time fell 2.3x); the draws, the
// sums and their order are the serial loop's, so K1, K2 and K5 still
// equal their plain version.  Where most lanes have a solid hit the rounds do
// the serial loop's work plus their bookkeeping and the warp-wide
// synchronisation: 1920x1080 depth 4 runs ~5% slower than with the serial
// shading.  Shared memory: a 1.4 KB WarpTasks slice a warp (11 KB a
// block), kept small because it is taken from L1, behind which the stack
// frame lives.  In K5 each owner also writes its node's shadow ratio per
// light as it finishes the light, and its children's parent codes cross
// the shared shading with it; the warp pads its pixels' unused record
// slots together after the loop, one slot for all its pixels a store.
// The padding is most of K5's bytes (~93% at 800x600 depth 15) and comes
// in one burst as each warp ends; the records' codes, ids, picks and
// padding are streaming stores (__stcs).  Without shadow samples a lane
// shades its own hit with no warp-wide step.
// The triangle instantiations keep the serial shading, a thread a pixel
// (a triangle feeler walks the tree), whose limit is still the instruction rate
// and divergence of each thread's DFS.
//
// For K1 ptxas gives ~80 registers and an ~800-byte stack frame (the ray
// stack, in local memory; figures of every instantiation in PERF.md).  A
// bilinear fetch reads 4 texels instead of 1 and adds ~30 operations; it
// changes neither bound.  The record instantiations add a
// parent code per stack level, and per node one i32 record, one i32 winner
// id, one i32 texel pick and nl f32 shadow ratios, stored slot-major
// ([slot, pixel]) so that the threads of a warp write adjacent words;
// under BILINEAR they write 4 picks per node ([slot, tap, pixel]).
//
// Triangles (K3/K4 as one path): the TPU kernel ran Moller-Trumbore as
// bilinear forms on the MXU at bf16x3 and streamed 256-triangle blocks
// through VMEM past 32,768 triangles; here the tables (triblocks.py) sit in
// device memory, the hot part in L2 (50 MB: 524,288 triangles take 25 MB of
// geometry), and each thread walks an implicit AABB tree (the whole mesh,
// unions of 8 nodes, blocks of 16 Morton-ordered triangles) with the walk
// of tri_walk.cuh, shared with the triangle-query kernel tri_query.cu: the
// 8 children of a node tested in one wide step, nearest child first for
// the closest hit, boxes and triangles read through __ldg.  The closest-hit
// walk skips every box beyond max(t_light, min(best solid, best triangle))
// (:1219), which shrinks as hits land; a shadow feeler stops at its first
// opaque triangle.  What bounds it is the latency of the walk's dependent
// loads and divergence: the rays of a warp enter different boxes and the
// warp runs the union of their paths.  A pixel keeps its thread, since its
// DFS and shading state live in registers (ptxas's figures for each
// instantiation: PERF.md).
//
// Why a thread per pixel: the TPU kernel's 16x128 tiles, one-hot selects and
// VMEM stacks exist because the TPU has vector registers and no gather.  A
// GPU thread has its own program counter, indexes its own stack (local
// memory, cached in L1) and can read texels from device memory, so the
// reference's per-pixel loop (raytracing.cl:14-195) maps onto a thread
// directly and the texels are fetched in-kernel: no event buffers, no
// resolve pass, no overflow.
//
// Semantics follow the TPU kernel operation for operation; the plain
// PyTorch version render_megakernel_reference (megakernel.py) is the same
// algorithm on tensors.  Built without --use_fast_math (the approximate
// sin/cos/pow/sqrt would move soft-shadow samples and grazing hits) and
// with --fmad=false, so that a*b+c rounds twice as in the plain version
// (build.py).

#include "tri_walk.cuh"

// ---- packed scene layout (megakernel.py pack_scene) ----
#define MAX_DEPTH_CAP 16
#define BASIS_SIZE 15
#define SPHERE_STRIDE 17   // origin3, radius, material13
#define PLANE_STRIDE 19    // normal3, point3, material13
#define LIGHT_STRIDE 8     // origin3, radius, intensity, rgb3
// material offsets
#define M_AMBIENT 3
#define M_DIFFUSE 4
#define M_SPECULAR 5
#define M_SHININESS 6
#define M_TRANSPARENT 7
#define M_DIELECTRIC 8
#define M_N 9
#define M_REFLECTIVITY 10
#define M_TEXTURE_ID 11
#define M_TEXTURE_SCALE 12

#define BLOCK_X 16
#define BLOCK_Y 16

// record codes (pallas_trace.py:2102-2148): solid index (spheres first),
// TRI_CODE for a triangle, LIGHT_CODE + l for light l, MISS_CODE for the
// sky; parent byte = 6-bit parent slot | PC_REFRACT for the refracted child
// | PC_VALID
#define LIGHT_CODE 64
#define TRI_CODE 126
#define MISS_CODE 127
#define PC_VALID 0x80
#define PC_REFRACT 0x40

// ---- triangle tables (triblocks.py build_tri_tables) ----
#define ATTR_STRIDE 16      // unit face normal3, material13
#define TRI_THROUGH 0.8f    // per transparent triangle (trace.py:385)

// Outputs of the record instantiation (all null in the base one).  Every
// element is written by the kernel, unused slots included.
struct Records {
  int krec;        // record slots per pixel
  int sky_base;    // texel picks index the textures, then the sky from here
  int* rec;        // [krec, n_pix] code | parent byte << 8; -1 = no node
  int* wid;        // [krec, n_pix] winning triangle id; -1 = not a triangle
  float* ssr;      // [krec, nl, n_pix] soft-shadow ratio; 0 off solid hits
  int* pick;       // [krec, NP, n_pix] texels the node fetched (NP = 1, or 4
                   // bilinear taps); -1 = none
  int* max_nodes;  // [1] image-wide max of the true per-pixel node count
};

// float32 values of 1/pi, 2*pi and pi, as the JAX package rounds them
#define INV_PI 0.31830987334251404f
#define TWO_PI 6.2831854820251465f
#define PI_F 3.1415927410125732f

// max(x, lo) that lets NaN through, as jnp.maximum and torch.clamp do
__device__ __forceinline__ float max_nan(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ V3 normalize(V3 v) {
  float n2 = dot(v, v);
  float inv = n2 > 0.0f ? rsqrtf(n2) : 0.0f;
  return scale(v, inv);
}

// floor-mod for a positive modulus (jnp.mod / torch.remainder)
__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// intersect_sphere with the far-root rule (primitives.cl:170-195); also the
// light test.  b = 2*dot(v, d) keeps the TPU kernel's order.
__device__ __forceinline__ bool sphere_t(V3 center, float r, V3 p, V3 q, float& t) {
  V3 v = sub(p, center);
  float a = dot(q, q);
  float b = 2.0f * dot(v, q);
  float c = dot(v, v) - r * r;
  float disc = b * b - 4.0f * a * c;
  bool has = disc >= 0.0f;
  float sq = sqrtf(has ? disc : 0.0f);
  float t_near = (-b - sq) / (2.0f * a);
  float t_far = (-b + sq) / (2.0f * a);
  t = t_near < 0.0f ? t_far : t_near;
  return has && t > 0.0f;
}

__device__ __forceinline__ bool plane_t(V3 normal, V3 point, V3 p, V3 q, float& t) {
  float b = dot(q, normal);
  float safe_b = b == 0.0f ? 1.0f : b;
  t = dot(sub(point, p), normal) / safe_b;
  return b != 0.0f && t > 0.0f;
}

// xorshift32 (primitives.cl:116-125); the sample is built as the TPU kernel
// builds it (pallas_trace.py:499): int32 bits -> f32, + 2^32 if negative,
// then / 2^31 * 2, i.e. [0, 4).
__device__ __forceinline__ float xorshift32(uint32_t& x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  float fx = (float)(int32_t)x;
  if (fx < 0.0f) fx += 4294967296.0f;
  return fx / 2147483648.0f * 2.0f;
}

// the 4x3-cross cubemap's face fractions (fu, fv) and texel shifts (su, sv)
// of a direction (primitives.cl:14-109); the six blocks are not exclusive,
// the later one wins
__device__ __forceinline__ void cube_face(V3 d, int face, float& fu, float& fv, int& su,
                                          int& sv) {
  float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  bool xp = d.x > 0.0f, yp = d.y > 0.0f, zp = d.z > 0.0f;
  float m = 1.0f, uc = 0.0f, vc = 0.0f;
  su = 0;
  sv = 0;
  if (xp && ax >= ay && ax >= az) { m = ax; uc = -d.z; vc = d.y; su = 2 * face; sv = face; }
  if (!xp && ax >= ay && ax >= az) { m = ax; uc = d.z; vc = d.y; su = 0; sv = face; }
  if (yp && ay >= ax && ay >= az) { m = ay; uc = d.x; vc = -d.z; su = face; sv = 2 * face; }
  if (!yp && ay >= ax && ay >= az) { m = ay; uc = d.x; vc = d.z; su = face; sv = 0; }
  if (zp && az >= ax && az >= ay) { m = az; uc = d.x; vc = d.y; su = face; sv = face; }
  if (!zp && az >= ax && az >= ay) { m = az; uc = -d.x; vc = d.y; su = 3 * face; sv = face; }
  float safe = m != 0.0f ? m : 1.0f;
  fu = 0.5f * (uc / safe + 1.0f);
  fv = 0.5f * (vc / safe + 1.0f);
}

// direction -> texel in the cubemap (primitives.map_to_cube)
__device__ __forceinline__ void map_to_cube(V3 d, int face, int& u, int& v) {
  float fu, fv;
  int su, sv;
  cube_face(d, face, fu, fv, su, sv);
  // __float2int_rz: truncate, saturate, NaN -> 0 (as XLA's convert)
  u = su + __float2int_rz(fu * (float)face);
  v = sv + __float2int_rz(fv * (float)face);
}

// direction -> continuous cubemap coordinates (primitives.map_to_cube_float)
__device__ __forceinline__ void map_to_cube_float(V3 d, int face, float& u, float& v) {
  float fu, fv;
  int su, sv;
  cube_face(d, face, fu, fv, su, sv);
  u = (float)su + fu * (float)face;
  v = (float)sv + fv * (float)face;
}

// min(max(x, lo), hi) that lets NaN through (jnp.clip, primitives.clip)
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// The 4 bilinear taps of continuous texel coordinates (u, v) in a w x h
// image (primitives.bilinear_taps): in the order (0, 0), (1, 0), (0, 1),
// (1, 1), the texel's index y * w + x and its weight.  WRAP: a floor-mod
// (tiled plane textures); else a clamp (the sky's edges).
struct Taps {
  int idx[4];
  float w[4];
};

template <bool WRAP>
__device__ __forceinline__ Taps bilinear_taps(float u, float v, int w, int h) {
  const float u0f = floorf(u), v0f = floorf(v);
  const float fu = u - u0f, fv = v - v0f;
  int x0 = __float2int_rz(u0f), y0 = __float2int_rz(v0f), x1, y1;
  if (WRAP) {
    x0 = floor_mod(x0, w);
    y0 = floor_mod(y0, h);
    x1 = x0 + 1 == w ? 0 : x0 + 1;
    y1 = y0 + 1 == h ? 0 : y0 + 1;
  } else {  // clamp(x0 + 1) without the overflow of x0 + 1
    x1 = min(max(x0, -1), w - 2) + 1;
    y1 = min(max(y0, -1), h - 2) + 1;
    x0 = min(max(x0, 0), w - 1);
    y0 = min(max(y0, 0), h - 1);
  }
  Taps tp;
  tp.idx[0] = y0 * w + x0;
  tp.idx[1] = y0 * w + x1;
  tp.idx[2] = y1 * w + x0;
  tp.idx[3] = y1 * w + x1;
  tp.w[0] = (1.0f - fu) * (1.0f - fv);
  tp.w[1] = fu * (1.0f - fv);
  tp.w[2] = (1.0f - fu) * fv;
  tp.w[3] = fu * fv;
  return tp;
}

// sum over the taps of weight * texel (u8 rgb from img), in tap order
__device__ __forceinline__ V3 tap_sum(const uint8_t* img, const Taps& tp) {
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int t = 0; t < 4; ++t) {
    const uint8_t* px = img + (size_t)tp.idx[t] * 3;
    acc = v3(acc.x + tp.w[t] * (float)px[0], acc.y + tp.w[t] * (float)px[1],
             acc.z + tp.w[t] * (float)px[2]);
  }
  return acc;
}

// One node's record: its code, its parent byte, triangle id and NP texel
// picks.  Records are written once here and read only by a later kernel
// (the replay), so they go out as streaming stores (evict first): K5 at
// 512x384 depth 3 without samples ran 5-10% faster than with plain stores
// (PERF.md).
template <int NP>
__device__ __forceinline__ void write_record(const Records& R, int slot, size_t pix,
                                             size_t n_pix, int code, int pcode, int wid,
                                             const int (&pick)[NP]) {
  __stcs(R.rec + slot * n_pix + pix, code | (pcode << 8));
  __stcs(R.wid + slot * n_pix + pix, wid);
  for (int t = 0; t < NP; ++t) __stcs(R.pick + ((size_t)slot * NP + t) * n_pix + pix, pick[t]);
}

// Slot `slot` of one pixel left unused: rec, wid and the NP picks -1, the nl
// shadow ratios 0.
template <int NP>
__device__ __forceinline__ void pad_slot(const Records& R, int slot, size_t pix, size_t n_pix,
                                         int nl) {
  __stcs(R.rec + slot * n_pix + pix, -1);
  __stcs(R.wid + slot * n_pix + pix, -1);
  for (int t = 0; t < NP; ++t) __stcs(R.pick + ((size_t)slot * NP + t) * n_pix + pix, -1);
  for (int i = 0; i < nl; ++i) __stcs(R.ssr + ((size_t)slot * nl + i) * n_pix + pix, 0.0f);
}

// One shadow sample toward light (lo, lrad) from ph (raytracing.cl:95-118):
// draws two numbers from rng and returns the sample's share of the light,
// 0 if an opaque solid blocks it (or the light is `dead`), else through^k
// for the k transparent spheres it crosses (testShadowPath,
// primitives.cl:396-442).
template <bool TRIS>
__device__ __forceinline__ float shadow_sample(uint32_t& rng, V3 lo, float lrad, V3 ph,
                                               bool dead, const float* SPH, int ns,
                                               const float* PL, int npl, float through,
                                               const Tris& T) {
  float theta = TWO_PI * xorshift32(rng);
  float phi = PI_F * xorshift32(rng);
  float sphi = sinf(phi);
  V3 spt = v3(lo.x + lrad * sphi * cosf(theta),
              lo.y + lrad * sphi * sinf(theta),
              lo.z + lrad * cosf(phi));
  V3 dd = sub(spt, ph);
  V3 q = normalize(dd);
  float tmax = sqrtf(dot(dd, dd));
  bool blocked = dead;
  float opac = 1.0f;
  for (int j = 0; j < ns; ++j) {
    const float* S = SPH + SPHERE_STRIDE * j;
    float t;
    bool rel = sphere_t(load3(S), __ldg(S + 3), ph, q, t) && t < tmax;
    if (__ldg(S + 4 + M_TRANSPARENT) > 0.5f) {
      if (rel) opac *= through;
    } else if (rel) {
      blocked = true;
    }
  }
  for (int j = 0; j < npl; ++j) {
    const float* P = PL + PLANE_STRIDE * j;
    float t;
    if (plane_t(load3(P), load3(P + 3), ph, q, t) && t < tmax) blocked = true;
  }
  if constexpr (TRIS) {
    if (!blocked) {
      int crossed = 0;
      blocked = tri_feeler<1, false>(T, ph, q, tmax, crossed, Lanes<1>());
      if (crossed) opac *= powf(TRI_THROUGH, (float)crossed);
    }
  }
  return blocked ? 0.0f : opac;
}

// A solid hit's view of the light centred at lo: the vector to the centre,
// the unit directions to it and of the half vector, and whether the light
// is dead (faces away, pallas_trace.py:1986-2015): its samples are still
// drawn but count 0.  Record mode gates on geometry only: a light dead only because
// diffuse or specular is 0 still has a gradient with respect to them, so
// its recorded ratio must be the real one.
struct LightView {
  V3 cd, sd, hv;
  bool dead;
};

template <bool RECORD>
__device__ __forceinline__ LightView light_view(V3 lo, V3 ph, V3 n, V3 vdir, float diffuse,
                                                float specular, float shininess) {
  LightView g;
  g.cd = sub(lo, ph);
  g.sd = normalize(g.cd);
  g.hv = normalize(add(vdir, g.sd));
  const bool geo_diff_dead = dot(n, g.sd) <= 0.0f;
  const bool geo_spec_dead = dot(n, g.hv) <= 0.0f && shininess > 0.0f;
  g.dead = RECORD ? (geo_diff_dead && geo_spec_dead)
                  : ((geo_diff_dead || diffuse <= 0.0f) &&
                     (specular <= 0.0f || geo_spec_dead));
  return g;
}

// acc plus light L's Phong term at soft-shadow ratio ssr (no distance
// falloff beyond 1/d^2 of the centre, raytracing.cl:119-134)
__device__ __forceinline__ V3 phong(V3 acc, const float* L, const LightView& g, V3 n,
                                    float ssr, float f, float diffuse, float specular,
                                    float shininess) {
  float dist = sqrtf(dot(g.cd, g.cd));
  dist = dist > 0.0f ? dist : 1.0f;
  float fall = __ldg(L + 4) * INV_PI / (dist * dist) * ssr;
  float ndh = max_nan(dot(n, g.hv), 0.0f);
  float spec = powf(max_nan(ndh, 1e-30f), shininess) * specular * f;
  float ndl = max_nan(dot(n, g.sd), 0.0f);
  float diff = ndl * diffuse * f;
  float w = (spec + diff) * fall;
  return v3(acc.x + w * __ldg(L + 5), acc.y + w * __ldg(L + 6), acc.z + w * __ldg(L + 7));
}

// ---- warp-cooperative shading (K1, K2, K5) ----
#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK (BLOCK_X * BLOCK_Y / 32)
#define SLOTS 8  // feelers of one task per chunk

// One warp's slice of shared memory: the solid hits it shades this trip
// ("tasks", numbered by their owners' lane order) and, per chunk, SLOTS
// feelers of each task: a slot holds the feeler's rng state, then its
// result.  [slot][task], so that the 32 lanes of a round and the owners
// touch 32 consecutive words.  1.4 KB a warp, 11 KB a block.
struct WarpTasks {
  float x[32], y[32], z[32];  // the task's eps-offset hit point ph
  uint32_t slot[SLOTS][32];   // rng state in, then the result (float bits)
};

template <bool COOP>
__device__ __forceinline__ WarpTasks* warp_tasks() {
  if constexpr (COOP) {
    __shared__ WarpTasks tasks[WARPS_PER_BLOCK];
    return tasks + (threadIdx.y * BLOCK_X + threadIdx.x) / 32;
  } else {
    return nullptr;
  }
}

// q / d for 0 <= q < 2^20 and 1 <= d, with inv = 1.0f / d: (q + 1/2) / d
// lies at least 1 / (2d) from an integer, far beyond float rounding
__device__ __forceinline__ int small_div(int q, float inv) {
  return __float2int_rz(((float)q + 0.5f) * inv);
}

// The Phong sum of every light at one solid hit, its shadow feelers shot by
// the whole warp.  All 32 lanes call it together; `shade` marks the lanes
// that own a solid hit (ph, n, vdir, material M, weight f, rng at the
// node's start).  Feeler j = i * ss + s of a task is sample s of light i;
// it draws with the rng state after 2j steps from the node's start, as the
// serial loop does.  In chunks of SLOTS feelers per task: the owners write
// the rng states of their chunk's feelers (moving their own rng on 2 steps
// a feeler); the K * jc feelers of the chunk are shared out over the 32
// lanes, one a lane a round, each result written over its rng state; then
// each owner adds its results in j order and finishes each light whose ss
// samples are in, as the serial loop does.  Every owner walks the same j,
// so the Phong terms run once for all of them.  RECORD: an owner whose
// node has record slot `slot` (>= 0) writes each light's shadow ratio
// there as it finishes the light, with the record mode's geometry-only
// dead test.
template <bool RECORD>
__device__ __forceinline__ V3 warp_shade(WarpTasks& W, bool shade, V3 ph, V3 n, V3 vdir,
                                         const float* M, float f, uint32_t& rng,
                                         const float* SPH, int ns, const float* PL,
                                         int npl, const float* LI, int nl, int ss,
                                         float through, const Tris& T, const Records& R,
                                         int slot, size_t pix, size_t n_pix) {
  V3 acc = v3(0.0f, 0.0f, 0.0f);
  const bool rec_on = RECORD && slot >= 0;
  if (ss == 0) {  // no feelers to share: each owner alone, every light at ratio 0 + 1
    if (shade) {
      const float diffuse = __ldg(M + M_DIFFUSE), specular = __ldg(M + M_SPECULAR),
                  shininess = __ldg(M + M_SHININESS);
      for (int i = 0; i < nl; ++i) {
        const float* L = LI + LIGHT_STRIDE * i;
        const LightView g = light_view<RECORD>(load3(L), ph, n, vdir, diffuse, specular,
                                               shininess);
        if (rec_on) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = 0.0f + 1.0f;
        acc = phong(acc, L, g, n, 0.0f + 1.0f, f, diffuse, specular, shininess);
      }
    }
    return acc;
  }
  const unsigned tasks = __ballot_sync(FULL_MASK, shade);
  if (!tasks) return acc;
  const unsigned lane = (threadIdx.y * BLOCK_X + threadIdx.x) & 31;
  const int rank = __popc(tasks & ((1u << lane) - 1u));
  const int K = __popc(tasks);
  const float inv_k = 1.0f / (float)K, inv_ss = 1.0f / (float)ss;
  float diffuse = 0.0f, specular = 0.0f, shininess = 0.0f;
  if (shade) {
    diffuse = __ldg(M + M_DIFFUSE);
    specular = __ldg(M + M_SPECULAR);
    shininess = __ldg(M + M_SHININESS);
    W.x[rank] = ph.x;
    W.y[rank] = ph.y;
    W.z[rank] = ph.z;
  }
  const int per = nl * ss;  // feelers of one task
  int li = 0, s = 0;        // the owner's light and sample
  float soft = 0.0f;
  for (int c0 = 0; c0 < per; c0 += SLOTS) {
    const int jc = min(SLOTS, per - c0);
    if (shade) {
      for (int jj = 0; jj < jc; ++jj) {
        W.slot[jj][rank] = rng;
        xorshift32(rng);
        xorshift32(rng);
      }
    }
    const int items = K * jc;
    for (int base = 0; base < items; base += 32) {
      __syncwarp();
      const int k = base + (int)lane;
      if (k < items) {
        const int jj = small_div(k, inv_k), t = k - jj * K;
        const int i = small_div(c0 + jj, inv_ss);
        uint32_t x = W.slot[jj][t];
        const float* L = LI + LIGHT_STRIDE * i;
        const float r = shadow_sample<false>(x, load3(L), __ldg(L + 3),
                                             v3(W.x[t], W.y[t], W.z[t]), false, SPH, ns,
                                             PL, npl, through, T);
        W.slot[jj][t] = __float_as_uint(r);
      }
    }
    __syncwarp();
    if (shade) {
      for (int jj = 0; jj < jc; ++jj) {
        soft += __uint_as_float(W.slot[jj][rank]);
        if (++s == ss) {  // light li's samples are in
          const float* L = LI + LIGHT_STRIDE * li;
          const LightView g = light_view<RECORD>(load3(L), ph, n, vdir, diffuse, specular,
                                                 shininess);
          const float ssr = (g.dead ? 0.0f : soft) / (float)ss;
          if (rec_on) R.ssr[((size_t)slot * nl + li) * n_pix + pix] = ssr;
          acc = phong(acc, L, g, n, ssr, f, diffuse, specular, shininess);
          soft = 0.0f;
          s = 0;
          ++li;
        }
      }
    }
  }
  return acc;
}

// One pixel, start to finish: the body of the kernels below.
template <bool RECORD, bool TRIS, bool BILINEAR>
__device__ __forceinline__ void render_pixel(
    const float* __restrict__ sc, int ns, int npl, int nl, const Tris T,
    const uint8_t* __restrict__ tex, int tex_h, int tex_w, const uint8_t* __restrict__ sky,
    int sky_h, int sky_w, int width, int height, int max_depth, int shadow_samples,
    float eps, float through, float default_n, float* __restrict__ out, const Records R) {
  // K1, K2 and K5 shade their warp's solid hits together (warp_shade); the
  // triangle instantiations shade each pixel's hit in its own thread
  constexpr bool COOP = !TRIS;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool in_image = col < width && row < height;
  if (!COOP && !in_image) return;
  // COOP: a lane whose pixel is done, or outside the image, stays in the
  // loop as a helper until its warp is done
  bool live = in_image;
  WarpTasks* W = warp_tasks<COOP>();
  // 32-bit pixel indices (the wrappers refuse 2^31 pixels), which save
  // registers; element offsets (3 x pix, slot x n_pix) are 64-bit
  const int n_pix = width * height;
  const int pix = in_image ? row * width + col : 0;
  constexpr int NP = BILINEAR ? 4 : 1;  // texel picks per node

  const float* SPH = sc + BASIS_SIZE;
  const float* PL = SPH + SPHERE_STRIDE * ns;
  const float* LI = PL + PLANE_STRIDE * npl;

  // ---- raygen (raygen.cl:10-24): global row, so slabs keep their ids ----
  const int row_g = row + __float2int_rz(__ldg(sc + 14));
  const float w_scale = __ldg(sc + 12) * (float)col;
  const float h_scale = __ldg(sc + 13) * (float)row_g;
  V3 corner = load3(sc), up = load3(sc + 6), right = load3(sc + 9);
  V3 o = load3(sc + 3);
  V3 d = normalize(v3(corner.x + right.x * w_scale - up.x * h_scale,
                      corner.y + right.y * w_scale - up.y * h_scale,
                      corner.z + right.z * w_scale - up.z * h_scale));
  V3 c = v3(0.0f, 0.0f, 0.0f);
  float f = 1.0f, n1 = default_n;
  int dep = 0, sp = 1;
  uint32_t rng = (uint32_t)(row_g * width + col);  // seed = pixel id

  // ray stack: origin3, dir3, colour3, f, n1 + depth, per level
  float stk[MAX_DEPTH_CAP][11];
  int stk_dep[MAX_DEPTH_CAP];
  const float INF = __int_as_float(0x7f800000);
  // record mode: the parent code of the current ray and of each stacked
  // (reflected) ray, and the pixel's node count (pallas_trace.py stk_p,
  // pcode, rec_cnt)
  int stk_pc[MAX_DEPTH_CAP];
  int pcode = 0, nodes = 0;

  for (;;) {
    if constexpr (COOP) {
      if (!__any_sync(FULL_MASK, live)) break;
    }
    V3 cx2 = c;
    bool pop = true;
    // a solid hit (COOP: to shade with the warp), then continue from: its
    // eps-offset point, its normal, the direction to the eye, its material
    bool shade = false;
    V3 ph, n, vdir;
    const float* M = nullptr;
    // record mode: the node's slot if recorded (-1 if not), and its
    // children's parent codes (0: the replay drops them)
    int rec_slot = -1, pc_refl = 0, pc_refr = 0;
    // --- the shaded hit's reflect / refract continuation
    //     (raytracing.cl:138-179) ---
    auto next_ray = [&]() {
      float n2 = n1 == default_n ? __ldg(M + M_N) : default_n;
      float r0 = (n1 - n2) / (n1 + n2);
      r0 = r0 * r0;
      float cos_i = -dot(n, d);
      float nr = n1 / n2;
      float sin_t2 = nr * nr * (1.0f - cos_i * cos_i);
      float cos_tr = sqrtf(max_nan(1.0f - sin_t2, 0.0f));
      bool use_tr = n1 > n2;
      float xs = 1.0f - (use_tr ? cos_tr : cos_i);
      float fr = r0 + (1.0f - r0) * xs * xs * xs * xs * xs;
      if (use_tr && sin_t2 > 1.0f) fr = 1.0f;
      float refl = __ldg(M + M_REFLECTIVITY);
      float ra = __ldg(M + M_DIELECTRIC) > 0.5f ? refl + (1.0f - refl) * fr : refl;
      float f_cont = f * ra;
      V3 rd = add(d, scale(n, 2.0f * cos_i));
      bool pushed = false;
      if (__ldg(M + M_TRANSPARENT) > 0.5f && sp < max_depth && ra < 1.0f) {
        bool entering = n1 < n2;
        V3 rn = entering ? n : v3(-n.x, -n.y, -n.z);
        float cos_i2 = -dot(rn, d);
        float sin2 = nr * nr * (1.0f - cos_i2 * cos_i2);
        if (!(sin2 > 1.0f)) {
          // push: the reflected ray waits, the refracted one goes on
          float cos_t = sqrtf(max_nan(1.0f - sin2, 0.0f));
          float k = nr * cos_i2 - cos_t;
          float* e = stk[sp - 1];
          e[0] = ph.x; e[1] = ph.y; e[2] = ph.z;
          e[3] = rd.x; e[4] = rd.y; e[5] = rd.z;
          e[6] = cx2.x; e[7] = cx2.y; e[8] = cx2.z;
          e[9] = f_cont; e[10] = n1;
          stk_dep[sp - 1] = dep + 1;
          o = entering ? sub(ph, scale(n, 2.0f * eps)) : ph;
          d = v3(nr * d.x + k * rn.x, nr * d.y + k * rn.y, nr * d.z + k * rn.z);
          c = v3(0.0f, 0.0f, 0.0f);
          f = f * (1.0f - ra);
          n1 = n2;
          dep += 1;
          sp += 1;
          pushed = true;
          if constexpr (RECORD) {  // the stacked ray is the reflected child
            stk_pc[sp - 2] = pc_refl;
            pcode = pc_refr;
          }
        }
      }
      if (!pushed) {  // continue along the reflected ray
        o = ph;
        d = rd;
        c = cx2;
        f = f_cont;
        dep += 1;
        if constexpr (RECORD) pcode = pc_refl;
      }
    };
    if (live && dep < max_depth) {
      // a node: one record in slot `slot` if it fits; a node that does not
      // fit gives its children parent code 0, so the replay drops them
      const int slot = nodes++;
      const bool rec_on = RECORD && slot < R.krec;
      if (rec_on) {
        rec_slot = slot;
        pc_refl = PC_VALID | slot;
        pc_refr = PC_VALID | PC_REFRACT | slot;
      }
      // --- findLightIntersection (primitives.cl:262-318) ---
      float lt = INF;
      int lwin = 0;
      for (int i = 0; i < nl; ++i) {
        const float* L = LI + LIGHT_STRIDE * i;
        float t;
        bool h = sphere_t(load3(L), __ldg(L + 3), o, d, t);
        float tm = h ? t : INF;
        if (tm < lt) { lt = tm; lwin = i; }
      }
      // --- findSolidIntersection (primitives.cl:322-394); light
      //     occluders: solids at t <= t_light, glass excepted ---
      bool lblock = false;
      float bt = INF;
      int bwin = -1;
      for (int i = 0; i < ns; ++i) {
        const float* S = SPH + SPHERE_STRIDE * i;
        float t;
        bool h = sphere_t(load3(S), __ldg(S + 3), o, d, t);
        bool transp = __ldg(S + 4 + M_TRANSPARENT) > 0.5f;
        if (h && t <= lt && !transp) lblock = true;
        float tm = h ? t : INF;
        if (tm < bt) { bt = tm; bwin = i; }
      }
      for (int i = 0; i < npl; ++i) {
        const float* P = PL + PLANE_STRIDE * i;
        float t;
        bool h = plane_t(load3(P), load3(P + 3), o, d, t);
        if (h && t <= lt) lblock = true;
        float tm = h ? t : INF;
        if (tm < bt) { bt = tm; bwin = ns + i; }
      }
      // --- triangles (trace.py:462-466): analytic solids win ties ---
      int wid = -1;
      if constexpr (TRIS) {
        float tt = INF;
        int w = -1;
        tri_closest(T, o, d, lt, bt, tt, w, lblock, Lanes<1>());
        if (tt < bt) {
          bt = tt;
          bwin = TRI_CODE;
          wid = w;
        }
      }

      if (isfinite(lt) && !lblock) {
        // light hit: rgb * I / pi, no distance term (primitives.cl:287)
        const float* L = LI + LIGHT_STRIDE * lwin;
        float s = __ldg(L + 4) * INV_PI;
        cx2 = v3(c.x + f * (__ldg(L + 5) * s), c.y + f * (__ldg(L + 6) * s),
                 c.z + f * (__ldg(L + 7) * s));
        if (rec_on) {
          int none[NP];
          for (int t = 0; t < NP; ++t) none[t] = -1;
          write_record(R, slot, pix, n_pix, LIGHT_CODE + lwin, pcode, -1, none);
        }
      } else if (!isfinite(bt)) {
        // miss: skybox texel, weight f (raytracing.cl:61-81)
        int pick[NP];
        if constexpr (BILINEAR) {
          // the v-flipped continuous coordinates, clamped (trace.py:573-581)
          float uf, vf;
          map_to_cube_float(d, sky_w / 4, uf, vf);
          const Taps tp = bilinear_taps<false>(clip_nan(uf, 0.0f, (float)(sky_w - 1)),
                                               clip_nan((float)sky_h - vf, 0.0f,
                                                        (float)(sky_h - 1)),
                                               sky_w, sky_h);
          const V3 acc = tap_sum(sky, tp);
          float w = f / 255.0f;
          cx2 = v3(c.x + w * acc.x, c.y + w * acc.y, c.z + w * acc.z);
          for (int t = 0; t < NP; ++t) pick[t] = R.sky_base + tp.idx[t];
        } else {
          int u, v;
          map_to_cube(d, sky_w / 4, u, v);
          int sy = min(max(sky_h - v, 0), sky_h - 1);
          int sx = min(max(u, 0), sky_w - 1);
          const uint8_t* px = sky + ((size_t)sy * sky_w + sx) * 3;
          float w = f / 255.0f;
          cx2 = v3(c.x + w * (float)px[0], c.y + w * (float)px[1],
                   c.z + w * (float)px[2]);
          pick[0] = R.sky_base + sy * sky_w + sx;
        }
        if (rec_on) {
          write_record(R, slot, pix, n_pix, MISS_CODE, pcode, -1, pick);
        }
      } else {
        pop = false;
        shade = true;
        V3 hp = add(o, scale(d, bt));
        const bool is_tri = TRIS && bwin == TRI_CODE;
        const bool is_plane = !is_tri && bwin >= ns;
        if (is_tri) {
          // the winner's face normal, flipped against the ray
          // (trace.py:479-484)
          const float* A = T.attr + ATTR_STRIDE * wid;
          n = load3(A);
          if (dot(n, d) > 0.0f) n = v3(-n.x, -n.y, -n.z);
          M = A + 3;
        } else if (!is_plane) {
          const float* S = SPH + SPHERE_STRIDE * bwin;
          n = normalize(sub(hp, load3(S)));
          M = S + 4;
        } else {
          const float* P = PL + PLANE_STRIDE * (bwin - ns);
          n = load3(P);
          M = P + 6;
        }
        const float ambient = __ldg(M + M_AMBIENT);
        const float tex_id = __ldg(M + M_TEXTURE_ID);
        int pick[NP];
        for (int t = 0; t < NP; ++t) pick[t] = -1;
        // a textured triangle is flat-shaded: texels are fetched for plane
        // hits only (pallas_trace.py:1832-1837, ROADMAP C6)
        if (is_plane && tex_id > -0.5f) {
          // textured plane: texel * f * ambient (primitives.cl:217-259)
          V3 b0;
          float s0 = 0.0f * n.x + -n.z + n.y;
          float s1 = n.z + 0.0f * n.x + -n.x;
          if (s0 != 0.0f) b0 = v3(0.0f * n.x, -n.z, n.y);
          else if (s1 != 0.0f) b0 = v3(n.z, 0.0f * n.x, -n.x);
          else b0 = v3(-n.y, n.x, 0.0f * n.x);
          V3 b1 = v3(n.y * b0.z - n.z * b0.y, n.z * b0.x - n.x * b0.z,
                     n.x * b0.y - n.y * b0.x);
          const float tscale = __ldg(M + M_TEXTURE_SCALE);
          float ui = dot(b0, hp) * tscale;
          float vi = dot(b1, hp) * tscale;
          if (!isfinite(ui)) ui = 0.0f;
          if (!isfinite(vi)) vi = 0.0f;
          if constexpr (BILINEAR) {
            const Taps tp = bilinear_taps<true>(ui, vi, tex_w, tex_h);
            const int base = (int)tex_id * tex_h * tex_w;
            const V3 acc = tap_sum(tex + (size_t)base * 3, tp);
            float w = (f * ambient) / 255.0f;
            cx2 = v3(c.x + w * acc.x, c.y + w * acc.y, c.z + w * acc.z);
            for (int t = 0; t < NP; ++t) pick[t] = base + tp.idx[t];
          } else {
            int tx = floor_mod(__float2int_rz(ui), tex_w);
            int ty = floor_mod(__float2int_rz(vi), tex_h);
            int tid = (int)tex_id;
            pick[0] = (tid * tex_h + ty) * tex_w + tx;
            const uint8_t* px = tex + (size_t)pick[0] * 3;
            float w = (f * ambient) / 255.0f;
            cx2 = v3(c.x + w * (float)px[0], c.y + w * (float)px[1],
                     c.z + w * (float)px[2]);
          }
        } else {
          float amb = f * ambient;
          cx2 = v3(c.x + amb * __ldg(M), c.y + amb * __ldg(M + 1),
                   c.z + amb * __ldg(M + 2));
        }
        ph = add(hp, scale(n, eps));  // eps-offset hit (primitives.cl:350)
        vdir = normalize(sub(o, ph));
        if (rec_on) write_record(R, slot, pix, n_pix, bwin, pcode, wid, pick);
        if constexpr (!COOP) {  // (COOP: shaded with the warp below)
          // --- per-light soft-shadow Phong (raytracing.cl:87-136) ---
          const float diffuse = __ldg(M + M_DIFFUSE);
          const float specular = __ldg(M + M_SPECULAR);
          const float shininess = __ldg(M + M_SHININESS);
          V3 acc = v3(0.0f, 0.0f, 0.0f);
          for (int i = 0; i < nl; ++i) {
            const float* L = LI + LIGHT_STRIDE * i;
            const V3 lo = load3(L);
            const float lrad = __ldg(L + 3);
            const LightView g = light_view<RECORD>(lo, ph, n, vdir, diffuse, specular,
                                                   shininess);
            float soft = 0.0f;
            for (int s = 0; s < shadow_samples; ++s)
              soft += shadow_sample<TRIS>(rng, lo, lrad, ph, g.dead, SPH, ns, PL, npl,
                                          through, T);
            float ssr = shadow_samples ? soft / (float)shadow_samples : soft + 1.0f;
            if (rec_on) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = ssr;
            acc = phong(acc, L, g, n, ssr, f, diffuse, specular, shininess);
          }
          cx2 = add(cx2, acc);
          next_ray();
        }
      }
      if (rec_on && !shade)  // a light or sky node: no shadow ratios
        for (int i = 0; i < nl; ++i) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = 0.0f;
    }

    if constexpr (COOP) {  // the warp's solid hits, shaded together
      const V3 acc = warp_shade<RECORD>(*W, shade, ph, n, vdir, M, f, rng, SPH, ns, PL,
                                        npl, LI, nl, shadow_samples, through, T, R,
                                        rec_slot, pix, n_pix);
      if (shade) {
        cx2 = add(cx2, acc);
        next_ray();
      }
    }
    if (live && pop) {
      if (sp == 1) {  // the root ray is done
        c = cx2;
        live = false;
        if constexpr (!COOP) break;
      } else {
        const float* e = stk[sp - 2];
        o = v3(e[0], e[1], e[2]);
        d = v3(e[3], e[4], e[5]);
        c = v3(e[6] + cx2.x, e[7] + cx2.y, e[8] + cx2.z);
        f = e[9];
        n1 = e[10];
        dep = stk_dep[sp - 2];
        if constexpr (RECORD) pcode = stk_pc[sp - 2];
        sp -= 1;
      }
    }
  }
  if constexpr (RECORD && COOP) {
    // the warp leaves the loop together: it pads the unused slots of its
    // in-image pixels slot by slot, so that each store covers its 2 x 16
    // neighbouring pixels, and reduces their node counts; lanes outside
    // the image write nothing
    const int lane = (threadIdx.y * BLOCK_X + threadIdx.x) & 31;
    const int first = __reduce_min_sync(FULL_MASK, in_image ? min(nodes, R.krec) : R.krec);
    for (int s = first; s < R.krec; ++s) {
      if (in_image && s >= nodes) pad_slot<NP>(R, s, pix, n_pix, nl);
    }
    const int warp_max = __reduce_max_sync(FULL_MASK, in_image ? nodes : 0);
    const unsigned inside = __ballot_sync(FULL_MASK, in_image);
    if (inside && lane == __ffs(inside) - 1) atomicMax(R.max_nodes, warp_max);
  }
  if (!in_image) return;
  float* px = out + (size_t)pix * 3;
  px[0] = c.x;
  px[1] = c.y;
  px[2] = c.z;
  if constexpr (RECORD && !COOP) {
    for (int s = min(nodes, R.krec); s < R.krec; ++s) pad_slot<NP>(R, s, pix, n_pix, nl);
    // image-wide max of the true node count: a warp reduction over the
    // threads that got here together, then one atomic per group
    const unsigned group = __activemask();
    const int warp_max = __reduce_max_sync(group, nodes);
    const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
    if (lane == __ffs(group) - 1) atomicMax(R.max_nodes, warp_max);
  }
}

template <bool RECORD, bool TRIS, bool BILINEAR>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
megakernel(const float* __restrict__ sc, int ns, int npl, int nl, const Tris T,
           const uint8_t* __restrict__ tex, int tex_h, int tex_w,
           const uint8_t* __restrict__ sky, int sky_h, int sky_w,
           int width, int height, int max_depth, int shadow_samples,
           float eps, float through, float default_n,
           float* __restrict__ out, const Records R) {
  render_pixel<RECORD, TRIS, BILINEAR>(
      sc, ns, npl, nl, T, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height, max_depth,
      shadow_samples, eps, through, default_n, out, R);
}

// K5 without triangles: at most 2 blocks a multiprocessor, so that ptxas
// may take up to 128 registers (95-96, no spills) where the bound above
// leaves it 80 and 16-88 B of spills; faster at every shape measured,
// 128x96 depth 3 (one wave of 48 blocks) included (PERF.md)
template <bool BILINEAR>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, 2)
megakernel_record(const float* __restrict__ sc, int ns, int npl, int nl, const Tris T,
                  const uint8_t* __restrict__ tex, int tex_h, int tex_w,
                  const uint8_t* __restrict__ sky, int sky_h, int sky_w,
                  int width, int height, int max_depth, int shadow_samples,
                  float eps, float through, float default_n,
                  float* __restrict__ out, const Records R) {
  render_pixel<true, false, BILINEAR>(
      sc, ns, npl, nl, T, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height, max_depth,
      shadow_samples, eps, through, default_n, out, R);
}

typedef void (*Megakernel)(const float*, int, int, int, const Tris, const uint8_t*, int, int,
                           const uint8_t*, int, int, int, int, int, int, float, float, float,
                           float*, const Records);

// The instantiation for a scene with or without triangles, and a filter.
template <bool RECORD>
static Megakernel instantiation(bool tris, bool bilinear) {
  if (tris) return bilinear ? megakernel<RECORD, true, true> : megakernel<RECORD, true, false>;
  if constexpr (RECORD) return bilinear ? megakernel_record<true> : megakernel_record<false>;
  else return bilinear ? megakernel<false, false, true> : megakernel<false, false, false>;
}

extern "C" int tpuray_megakernel(const float* scene, int ns, int npl, int nl,
                                 const float* tri_geom, const float* tri_attr,
                                 const float* tri_node, int n_tris, int tri_levels,
                                 const int* tri_level_n, int tri_block, int tri_fanout,
                                 const unsigned char* tex, int tex_h, int tex_w,
                                 const unsigned char* sky, int sky_h, int sky_w,
                                 int width, int height, int max_depth,
                                 int shadow_samples, float eps, float through,
                                 float default_n, int bilinear, float* out, void* stream) {
  Tris T;
  cudaError_t err = make_tris(tri_geom, tri_attr, tri_node, n_tris, tri_levels, tri_level_n,
                              tri_block, tri_fanout, T);
  if (err != cudaSuccess) return (int)err;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  const Records none = {0, 0, nullptr, nullptr, nullptr, nullptr, nullptr};
  Megakernel kernel = instantiation<false>(T.n != 0, bilinear != 0);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      scene, ns, npl, nl, T, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height,
      max_depth, shadow_samples, eps, through, default_n, out, none);
  return (int)cudaGetLastError();
}

// Record mode: the image in `out` plus the node records; `n_tex` textures
// precede the sky in the texel-pick index space; `pick` holds 4 planes per
// slot when `bilinear`.  Zeroes *max_nodes first.
extern "C" int tpuray_megakernel_record(
    const float* scene, int ns, int npl, int nl, const float* tri_geom,
    const float* tri_attr, const float* tri_node, int n_tris, int tri_levels,
    const int* tri_level_n, int tri_block, int tri_fanout, const unsigned char* tex,
    int n_tex, int tex_h, int tex_w, const unsigned char* sky, int sky_h,
    int sky_w, int width, int height, int max_depth, int shadow_samples,
    float eps, float through, float default_n, int bilinear, int krec, float* out, int* rec,
    int* wid, float* ssr, int* pick, int* max_nodes, void* stream) {
  Tris T;
  cudaError_t err = make_tris(tri_geom, tri_attr, tri_node, n_tris, tri_levels, tri_level_n,
                              tri_block, tri_fanout, T);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(max_nodes, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  const Records R = {krec, n_tex * tex_h * tex_w, rec, wid, ssr, pick, max_nodes};
  Megakernel kernel = instantiation<true>(T.n != 0, bilinear != 0);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      scene, ns, npl, nl, T, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height,
      max_depth, shadow_samples, eps, through, default_n, out, R);
  return (int)cudaGetLastError();
}

extern "C" const char* tpuray_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
