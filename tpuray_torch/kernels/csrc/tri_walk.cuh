// The triangle walk shared by the megakernel (megakernel.cu, K3/K4) and the
// triangle-query kernel (tri_query.cu, K6): the triangle tables as a kernel
// takes them, 3-vectors, Moller-Trumbore and the stackless walk of the
// implicit AABB tree (tables: triblocks.py build_query_tables).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---- triangle tables (triblocks.py) ----
#define TRI_MAX_LEVELS 8
#define TRI_DET_EPS 1e-7f   // primitives.intersect_triangle's |det| floor

struct Tris {
  int n;                    // triangles; 0: none
  int levels;               // levels of the AABB tree, root first
  int block;                // triangles per leaf block
  int fanout;               // children per node above the blocks
  const float4* geom;       // [n][3]: (v0, transparent), (e1, 0), (e2, 0)
  const float* attr;        // [n][ATTR_STRIDE] (megakernel only; else null)
  const float4* node;       // [nodes][2]: (lo, 0), (hi, 0), levels in order
  int off[TRI_MAX_LEVELS];  // first node of each level
  int cnt[TRI_MAX_LEVELS];  // nodes of each level
};

// The triangle tables as the kernels take them; level_n (host memory) holds
// the nodes of each level, root first.
static cudaError_t make_tris(const float* geom, const float* attr, const float* node, int n,
                             int levels, const int* level_n, int block, int fanout, Tris& T) {
  T = Tris{};
  if (n == 0) return cudaSuccess;
  if (levels < 1 || levels > TRI_MAX_LEVELS || block < 1 || fanout < 2) return cudaErrorInvalidValue;
  T.n = n;
  T.levels = levels;
  T.block = block;
  T.fanout = fanout;
  T.geom = (const float4*)geom;
  T.attr = attr;
  T.node = (const float4*)node;
  for (int l = 0, off = 0; l < levels; off += level_n[l], ++l) {
    T.off[l] = off;
    T.cnt[l] = level_n[l];
  }
  return cudaSuccess;
}

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
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// Moller-Trumbore on triangle g (primitives.intersect_triangle_edges, the
// same operations in the same order): double-faced, |det| <= 1e-7 rejected
// on the unnormalised det, u >= 0, v >= 0, u + v <= 1, t > 0.  The early
// returns reject only what the full predicate rejects (u > 1 with v >= 0
// gives u + v > 1 in f32 too).  A zero direction gives det = 0: a miss.
__device__ __forceinline__ bool tri_t(const float4* g, V3 o, V3 d, float& t, bool& transp) {
  const float4 a = __ldg(g), b = __ldg(g + 1), c = __ldg(g + 2);
  const V3 e1 = v3(b.x, b.y, b.z), e2 = v3(c.x, c.y, c.z);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  if (!(fabsf(det) > TRI_DET_EPS)) return false;
  const float inv_det = 1.0f / det;
  const V3 tvec = sub(o, v3(a.x, a.y, a.z));
  const float u = dot(tvec, pvec) * inv_det;
  if (!(u >= 0.0f) || u > 1.0f) return false;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return false;
  t = dot(e2, qvec) * inv_det;
  transp = a.w > 0.5f;
  return t > 0.0f;
}

// Does the segment [0, bound] of the ray (o, 1/d) meet box k?  The boxes
// are grown on the host (triblocks.AABB_PAD), so that rounding here never
// rejects a box whose triangle tri_t hits.
__device__ __forceinline__ bool box_hit(const float4* node, int k, V3 o, V3 inv, float bound) {
  const float4 lo = __ldg(node + 2 * k), hi = __ldg(node + 2 * k + 1);
  float t0 = (lo.x - o.x) * inv.x, t1 = (hi.x - o.x) * inv.x;
  float tmn = fmaxf(0.0f, fminf(t0, t1)), tmx = fminf(bound, fmaxf(t0, t1));
  t0 = (lo.y - o.y) * inv.y;
  t1 = (hi.y - o.y) * inv.y;
  tmn = fmaxf(tmn, fminf(t0, t1));
  tmx = fminf(tmx, fmaxf(t0, t1));
  t0 = (lo.z - o.z) * inv.z;
  t1 = (hi.z - o.z) * inv.z;
  tmn = fmaxf(tmn, fminf(t0, t1));
  tmx = fminf(tmx, fmaxf(t0, t1));
  return tmn <= tmx;
}

// 1/x with near-zero components clamped to 1e-12 (pallas_trace.py tri_inv3),
// which only widens a slab
__device__ __forceinline__ float safe_inv(float x) { return 1.0f / (fabsf(x) < 1e-12f ? 1e-12f : x); }

// Walk the AABB tree depth first, children in order, so blocks and their
// triangles come in id order; a node whose box the segment [0, bound()]
// misses is skipped with its subtree.  leaf(first, last) tests triangles
// [first, last) and returns true to stop the walk.  The tree is implicit
// (child j of node i is node i * fanout + j of the next level), so the walk
// needs no stack: after a leaf or a miss it climbs while at a last child,
// then steps to the next sibling.
template <class Bound, class Leaf>
__device__ __forceinline__ void tri_walk(const Tris& T, V3 o, V3 d, Bound bound, Leaf leaf) {
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  const int last = T.levels - 1;
  int l = 0, i = 0;
  for (;;) {
    if (box_hit(T.node, T.off[l] + i, o, inv, bound())) {
      if (l < last) {
        ++l;
        i *= T.fanout;
        continue;
      }
      const int first = i * T.block;
      if (leaf(first, min(first + T.block, T.n))) return;
    }
    while (l > 0 && (i % T.fanout == T.fanout - 1 || i + 1 == T.cnt[l])) {
      i /= T.fanout;
      --l;
    }
    if (l == 0) return;
    ++i;
  }
}

// Closest triangle and light occlusion of the ray (o, d) (trace.py:433-488):
// tbest/wbest the closest hit, the lowest id among equal t (children in id
// order, a strict <); lblock set by an opaque triangle at t <= lt.  Boxes
// beyond max(lt, min(bt, tbest)) cannot change either answer (lt no longer
// counts once the light is blocked).  lt = -inf asks for the closest hit
// alone.
__device__ __forceinline__ void tri_closest(const Tris& T, V3 o, V3 d, float lt, float bt,
                                            float& tbest, int& wbest, bool& lblock) {
  const float lt_seg = isfinite(lt) ? lt : 0.0f;
  tri_walk(
      T, o, d,
      [&] {
        const float b = fminf(bt, tbest);
        return lblock ? b : fmaxf(lt_seg, b);
      },
      [&](int first, int last) {
        for (int k = first; k < last; ++k) {
          float t;
          bool transp;
          if (!tri_t(T.geom + 3 * k, o, d, t, transp)) continue;
          if (t < tbest) {
            tbest = t;
            wbest = k;
          }
          if (!transp && t <= lt) lblock = true;
        }
        return false;
      });
}

// Blocker test of the ray from p along q (trace.py:305-386): true at the
// first opaque triangle with t < tmax (t <= tmax where INCLUSIVE, the light
// test); counts the transparent ones in range met until then.
template <bool INCLUSIVE>
__device__ __forceinline__ bool tri_feeler(const Tris& T, V3 p, V3 q, float tmax, int& crossed) {
  bool blocked = false;
  tri_walk(
      T, p, q, [&] { return tmax; },
      [&](int first, int last) {
        for (int k = first; k < last; ++k) {
          float t;
          bool transp;
          if (!tri_t(T.geom + 3 * k, p, q, t, transp) || !(INCLUSIVE ? t <= tmax : t < tmax))
            continue;
          if (!transp) {
            blocked = true;
            return true;
          }
          ++crossed;
        }
        return false;
      });
  return blocked;
}
