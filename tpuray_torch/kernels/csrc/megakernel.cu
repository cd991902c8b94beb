// Whitted megakernel for NVIDIA Hopper (sm_90a): one thread renders one
// pixel, start to finish.
//
// Replaces: tpuray/kernels/pallas_trace.py, _make_kernel.kernel (:659) with
// no triangles and nearest filtering, launched by _pallas_forward (:2314) on
// 16x128 pixel tiles, plus the XLA texel-event resolve _resolve_events
// (:2468) that followed it.  Two instantiations of one body:
//   megakernel<false>  K1, the base configuration (render_pallas :2452);
//   megakernel<true>   K5, record mode (render_pallas_record :2665): the same
//                      image plus one record per DFS node for the gradient's
//                      replay (megakernel.py render_megakernel_record).
//
// What bounds it on this card: neither device-memory bytes nor a matrix
// unit.  The scene is ~0.6 KB and every thread of a warp reads the same
// scene word at the same time (a broadcast from the read-only cache); the
// only per-pixel traffic is 12 bytes of output and a few texel reads.  The
// work is scalar fp32 arithmetic, sqrt/rsqrt/sin/cos/pow and branches:
// per DFS node 3 light + 4 sphere + 2 plane tests, then per light and
// shadow sample 6 occluder tests.  The limit is issue rate and divergence:
// pixels of one warp that take different paths through the reflect /
// refract tree serialise, and a warp runs as long as its deepest pixel.
// For the base instantiation ptxas gives 80 registers and an 800-byte stack
// frame (the ray stack, in local memory) with no spills.  The record
// instantiation adds a parent code per stack level, and per node one i32
// record, one i32 texel pick and nl f32 shadow ratios, stored slot-major
// ([slot, pixel]) so that the threads of a warp write adjacent words.
//
// Why a thread per pixel: the TPU kernel's 16x128 tiles, one-hot selects and
// VMEM stacks exist because the TPU has vector registers and no gather.  A
// GPU thread has its own program counter, indexes its own stack (local
// memory, cached in L1) and can read texels from device memory, so the
// reference's per-pixel loop (raytracing.cl:14-195) maps onto a thread
// directly and the texels are fetched in-kernel: no event buffers, no
// resolve pass, no overflow.  Warp-level ray compaction and work queues
// for divergent pixels are later work.
//
// Semantics follow the TPU kernel operation for operation; the plain
// PyTorch version render_megakernel_reference (megakernel.py) is the same
// algorithm on tensors.  Built without --use_fast_math (the approximate
// sin/cos/pow/sqrt would move soft-shadow samples and grazing hits) and
// with --fmad=false, so that a*b+c rounds twice as in the plain version
// (build.py).

#include <cuda_runtime.h>
#include <stdint.h>

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
// LIGHT_CODE + l for light l, MISS_CODE for the sky; parent byte = 6-bit
// parent slot | PC_REFRACT for the refracted child | PC_VALID
#define LIGHT_CODE 64
#define MISS_CODE 127
#define PC_VALID 0x80
#define PC_REFRACT 0x40

// Outputs of the record instantiation (all null in the base one).  Every
// element is written by the kernel, unused slots included.
struct Records {
  int krec;        // record slots per pixel
  int sky_base;    // texel picks index the textures, then the sky from here
  int* rec;        // [krec, n_pix] code | parent byte << 8; -1 = no node
  float* ssr;      // [krec, nl, n_pix] soft-shadow ratio; 0 off solid hits
  int* pick;       // [krec, n_pix] texel the node fetched; -1 = none
  int* max_nodes;  // [1] image-wide max of the true per-pixel node count
};

// float32 values of 1/pi, 2*pi and pi, as the JAX package rounds them
#define INV_PI 0.31830987334251404f
#define TWO_PI 6.2831854820251465f
#define PI_F 3.1415927410125732f

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

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

// direction -> texel in the 4x3-cross cubemap (primitives.cl:14-109); the
// six blocks are not exclusive, the later one wins
__device__ __forceinline__ void map_to_cube(V3 d, int face, int& u, int& v) {
  float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  bool xp = d.x > 0.0f, yp = d.y > 0.0f, zp = d.z > 0.0f;
  float m = 1.0f, uc = 0.0f, vc = 0.0f;
  int su = 0, sv = 0;
  if (xp && ax >= ay && ax >= az) { m = ax; uc = -d.z; vc = d.y; su = 2 * face; sv = face; }
  if (!xp && ax >= ay && ax >= az) { m = ax; uc = d.z; vc = d.y; su = 0; sv = face; }
  if (yp && ay >= ax && ay >= az) { m = ay; uc = d.x; vc = -d.z; su = face; sv = 2 * face; }
  if (!yp && ay >= ax && ay >= az) { m = ay; uc = d.x; vc = d.z; su = face; sv = 0; }
  if (zp && az >= ax && az >= ay) { m = az; uc = d.x; vc = d.y; su = face; sv = face; }
  if (!zp && az >= ax && az >= ay) { m = az; uc = -d.x; vc = d.y; su = 3 * face; sv = face; }
  float safe = m != 0.0f ? m : 1.0f;
  float fu = 0.5f * (uc / safe + 1.0f);
  float fv = 0.5f * (vc / safe + 1.0f);
  // __float2int_rz: truncate, saturate, NaN -> 0 (as XLA's convert)
  u = su + __float2int_rz(fu * (float)face);
  v = sv + __float2int_rz(fv * (float)face);
}

// One node's record: its code, its parent byte and texel pick.
__device__ __forceinline__ void write_record(const Records& R, int slot, size_t pix,
                                             size_t n_pix, int code, int pcode, int pick) {
  R.rec[slot * n_pix + pix] = code | (pcode << 8);
  R.pick[slot * n_pix + pix] = pick;
}

template <bool RECORD>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
megakernel(const float* __restrict__ sc, int ns, int npl, int nl,
           const uint8_t* __restrict__ tex, int tex_h, int tex_w,
           const uint8_t* __restrict__ sky, int sky_h, int sky_w,
           int width, int height, int max_depth, int shadow_samples,
           float eps, float through, float default_n,
           float* __restrict__ out, const Records R) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || row >= height) return;
  const size_t n_pix = (size_t)width * height;
  const size_t pix = (size_t)row * width + col;

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
    V3 cx2 = c;
    bool pop = true;
    if (dep < max_depth) {
      // a node: one record in slot `slot` if it fits; a node that does not
      // fit gives its children parent code 0, so the replay drops them
      const int slot = nodes++;
      const bool rec_on = RECORD && slot < R.krec;
      const int pc_refl = rec_on ? (PC_VALID | slot) : 0;
      const int pc_refr = rec_on ? (PC_VALID | PC_REFRACT | slot) : 0;
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

      if (isfinite(lt) && !lblock) {
        // light hit: rgb * I / pi, no distance term (primitives.cl:287)
        const float* L = LI + LIGHT_STRIDE * lwin;
        float s = __ldg(L + 4) * INV_PI;
        cx2 = v3(c.x + f * (__ldg(L + 5) * s), c.y + f * (__ldg(L + 6) * s),
                 c.z + f * (__ldg(L + 7) * s));
        if (rec_on) {
          write_record(R, slot, pix, n_pix, LIGHT_CODE + lwin, pcode, -1);
          for (int i = 0; i < nl; ++i) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = 0.0f;
        }
      } else if (!isfinite(bt)) {
        // miss: skybox texel, weight f (raytracing.cl:61-81)
        int u, v;
        map_to_cube(d, sky_w / 4, u, v);
        int sy = min(max(sky_h - v, 0), sky_h - 1);
        int sx = min(max(u, 0), sky_w - 1);
        const uint8_t* px = sky + ((size_t)sy * sky_w + sx) * 3;
        float w = f / 255.0f;
        cx2 = v3(c.x + w * (float)px[0], c.y + w * (float)px[1],
                 c.z + w * (float)px[2]);
        if (rec_on) {
          write_record(R, slot, pix, n_pix, MISS_CODE, pcode, R.sky_base + sy * sky_w + sx);
          for (int i = 0; i < nl; ++i) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = 0.0f;
        }
      } else {
        pop = false;
        V3 hp = add(o, scale(d, bt));
        V3 n;
        const float* M;
        bool is_plane = bwin >= ns;
        if (!is_plane) {
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
        int pick = -1;
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
          int tx = floor_mod(__float2int_rz(ui), tex_w);
          int ty = floor_mod(__float2int_rz(vi), tex_h);
          int tid = (int)tex_id;
          pick = (tid * tex_h + ty) * tex_w + tx;
          const uint8_t* px = tex + (size_t)pick * 3;
          float w = (f * ambient) / 255.0f;
          cx2 = v3(c.x + w * (float)px[0], c.y + w * (float)px[1],
                   c.z + w * (float)px[2]);
        } else {
          float amb = f * ambient;
          cx2 = v3(c.x + amb * __ldg(M), c.y + amb * __ldg(M + 1),
                   c.z + amb * __ldg(M + 2));
        }
        V3 ph = add(hp, scale(n, eps));  // eps-offset hit (primitives.cl:350)
        if (rec_on) write_record(R, slot, pix, n_pix, bwin, pcode, pick);

        // --- per-light soft-shadow Phong (raytracing.cl:87-136) ---
        const float diffuse = __ldg(M + M_DIFFUSE);
        const float specular = __ldg(M + M_SPECULAR);
        const float shininess = __ldg(M + M_SHININESS);
        V3 vdir = normalize(sub(o, ph));
        V3 acc = v3(0.0f, 0.0f, 0.0f);
        for (int i = 0; i < nl; ++i) {
          const float* L = LI + LIGHT_STRIDE * i;
          V3 lo = load3(L);
          float lrad = __ldg(L + 3);
          V3 cd = sub(lo, ph);
          V3 sd = normalize(cd);
          V3 hv = normalize(add(vdir, sd));
          // backface gate (pallas_trace.py:1986-2015): samples still drawn.
          // Record mode gates on geometry only: a light dead only because
          // diffuse or specular is 0 still has a gradient with respect to
          // them, so its recorded ratio must be the real one.
          const bool geo_diff_dead = dot(n, sd) <= 0.0f;
          const bool geo_spec_dead = dot(n, hv) <= 0.0f && shininess > 0.0f;
          const bool dead = RECORD ? (geo_diff_dead && geo_spec_dead)
                                   : ((geo_diff_dead || diffuse <= 0.0f) &&
                                      (specular <= 0.0f || geo_spec_dead));
          float soft = 0.0f;
          for (int s = 0; s < shadow_samples; ++s) {
            float theta = TWO_PI * xorshift32(rng);
            float phi = PI_F * xorshift32(rng);
            float sphi = sinf(phi);
            V3 spt = v3(lo.x + lrad * sphi * cosf(theta),
                        lo.y + lrad * sphi * sinf(theta),
                        lo.z + lrad * cosf(phi));
            V3 dd = sub(spt, ph);
            V3 q = normalize(dd);
            float tmax = sqrtf(dot(dd, dd));
            // testShadowPath (primitives.cl:396-442)
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
            soft += blocked ? 0.0f : opac;
          }
          float ssr = shadow_samples ? soft / (float)shadow_samples : soft + 1.0f;
          if (rec_on) R.ssr[((size_t)slot * nl + i) * n_pix + pix] = ssr;
          float dist = sqrtf(dot(cd, cd));
          dist = dist > 0.0f ? dist : 1.0f;
          float fall = __ldg(L + 4) * INV_PI / (dist * dist) * ssr;
          float ndh = max_nan(dot(n, hv), 0.0f);
          float spec = powf(max_nan(ndh, 1e-30f), shininess) * specular * f;
          float ndl = max_nan(dot(n, sd), 0.0f);
          float diff = ndl * diffuse * f;
          float w = (spec + diff) * fall;
          acc = v3(acc.x + w * __ldg(L + 5), acc.y + w * __ldg(L + 6),
                   acc.z + w * __ldg(L + 7));
        }
        cx2 = add(cx2, acc);

        // --- reflect / refract continuation (raytracing.cl:138-179) ---
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
      }
    }
    if (pop) {
      if (sp == 1) {  // the root ray is done
        c = cx2;
        break;
      }
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
  float* px = out + pix * 3;
  px[0] = c.x;
  px[1] = c.y;
  px[2] = c.z;
  if constexpr (RECORD) {
    for (int s = min(nodes, R.krec); s < R.krec; ++s) {
      R.rec[s * n_pix + pix] = -1;
      R.pick[s * n_pix + pix] = -1;
      for (int i = 0; i < nl; ++i) R.ssr[((size_t)s * nl + i) * n_pix + pix] = 0.0f;
    }
    // image-wide max of the true node count: a warp reduction over the
    // threads that got here together, then one atomic per group
    const unsigned group = __activemask();
    const int warp_max = __reduce_max_sync(group, nodes);
    const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
    if (lane == __ffs(group) - 1) atomicMax(R.max_nodes, warp_max);
  }
}

extern "C" int tpuray_megakernel(const float* scene, int ns, int npl, int nl,
                                 const unsigned char* tex, int tex_h, int tex_w,
                                 const unsigned char* sky, int sky_h, int sky_w,
                                 int width, int height, int max_depth,
                                 int shadow_samples, float eps, float through,
                                 float default_n, float* out, void* stream) {
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  const Records none = {0, 0, nullptr, nullptr, nullptr, nullptr};
  megakernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
      scene, ns, npl, nl, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height,
      max_depth, shadow_samples, eps, through, default_n, out, none);
  return (int)cudaGetLastError();
}

// Record mode: the image in `out` plus the node records; `n_tex` textures
// precede the sky in the texel-pick index space.  Zeroes *max_nodes first.
extern "C" int tpuray_megakernel_record(
    const float* scene, int ns, int npl, int nl, const unsigned char* tex,
    int n_tex, int tex_h, int tex_w, const unsigned char* sky, int sky_h,
    int sky_w, int width, int height, int max_depth, int shadow_samples,
    float eps, float through, float default_n, int krec, float* out, int* rec,
    float* ssr, int* pick, int* max_nodes, void* stream) {
  cudaError_t err = cudaMemsetAsync(max_nodes, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  const Records R = {krec, n_tex * tex_h * tex_w, rec, ssr, pick, max_nodes};
  megakernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
      scene, ns, npl, nl, tex, tex_h, tex_w, sky, sky_h, sky_w, width, height,
      max_depth, shadow_samples, eps, through, default_n, out, R);
  return (int)cudaGetLastError();
}

extern "C" const char* tpuray_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
