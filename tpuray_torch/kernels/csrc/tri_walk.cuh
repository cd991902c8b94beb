// The triangle walk shared by the megakernel (megakernel.cu, K3/K4) and the
// triangle-query kernel (tri_query.cu, K6): the triangle tables as a kernel
// takes them, 3-vectors, Moller-Trumbore and the walk of the implicit AABB
// tree (tables: triblocks.py build_query_tables).
//
// The walk is written for a group of G lanes that answer one ray together
// (G = 1: a thread alone, as in the megakernel; K6 uses groups of
// QUERY_GROUP lanes).  Every lane of a group holds the same traversal state;
// the lanes split the 8 child boxes of a node and the triangles of a leaf
// between them and merge their answers with warp shuffles.
//
// What it does about the latency of the walk, which is what bounds it (a
// chain of dependent loads from L2 per ray, and a warp that runs as long as
// its slowest lane):
//   - wide steps: the 8 children of a node are contiguous in `node` (child j
//     of node i is node i * 8 + j of the next level, 256 bytes) and are read
//     with independent loads and tested in one step;
//   - nearest child first for the closest-hit query: the children the
//     segment meets are visited in order of entry t, and a child taken up
//     after a sibling's subtree is tested again against the bound, which
//     shrinks as hits land; a shadow feeler (any-hit) visits them in id
//     order;
//   - bounded state: per level an 8-bit mask of the children still to visit
//     (8 levels x 8 bits in one 64-bit register) and the index of the node
//     in hand; the path to it follows from the index (the tree is implicit);
//   - every box and triangle read with __ldg from device memory and L2.
//     Staging the upper levels of `node` in shared memory once per block was
//     tried and measured: no faster at 7,424 triangles, and at 163,840
//     slower (K4 by 11%, K6's blocker by 14%), as the shared memory comes
//     out of the L1 that holds the megakernel's ray stack and the boxes
//     (PERF.md).
// The answers do not depend on the visiting order: a hit replaces the best
// when t < tbest, or t == tbest and its id is lower (the lowest id among
// equal t), and a box is pruned only when its entry t is beyond the bound
// (the slab test keeps tmn <= tmx inclusive).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---- triangle tables (triblocks.py) ----
#define TRI_MAX_LEVELS 8
#define TRI_FANOUT 8            // children per node above the blocks (triblocks.TRI_FANOUT)
#define TRI_DET_EPS 1e-7f       // primitives.intersect_triangle's |det| floor

struct Tris {
  int n;                    // triangles; 0: none
  int levels;               // levels of the AABB tree, root first
  int block;                // triangles per leaf block
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
  if (levels < 1 || levels > TRI_MAX_LEVELS || block < 1 || fanout != TRI_FANOUT)
    return cudaErrorInvalidValue;
  T.n = n;
  T.levels = levels;
  T.block = block;
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

// Does the segment [0, bound] of the ray (o, 1/d) meet the box (lo, hi)?
// tmn: where it enters.  The boxes are grown on the host
// (triblocks.AABB_PAD), so that rounding here never rejects a box whose
// triangle tri_t hits.
__device__ __forceinline__ bool box_entry(float4 lo, float4 hi, V3 o, V3 inv, float bound,
                                          float& tmn) {
  float t0 = (lo.x - o.x) * inv.x, t1 = (hi.x - o.x) * inv.x;
  tmn = fmaxf(0.0f, fminf(t0, t1));
  float tmx = fminf(bound, fmaxf(t0, t1));
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

// G lanes of a warp (aligned, G a power of two) that answer one ray; G = 1
// is a thread alone and needs no shuffles.
template <int G>
struct Lanes {
  unsigned mask;  // the group's lanes in the warp
  int rank;       // this lane's place in the group
  int base;       // the group's first lane
  __device__ __forceinline__ Lanes() {
    if constexpr (G == 1) {
      mask = 0;
      rank = 0;
      base = 0;
    } else {
      const int lane = threadIdx.x & 31;
      rank = lane & (G - 1);
      base = lane - rank;
      mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1)) << base;
    }
  }
  __device__ __forceinline__ unsigned any_or(unsigned x) const {
    if constexpr (G == 1) return x;
    else return __reduce_or_sync(mask, x);
  }
  __device__ __forceinline__ int sum(int x) const {
    if constexpr (G == 1) return x;
    else return (int)__reduce_add_sync(mask, (unsigned)x);
  }
  // the least (t, k) over the group: t first, then the lower k
  __device__ __forceinline__ void min_pair(float& t, int& k) const {
    if constexpr (G > 1) {
#pragma unroll
      for (int s = G / 2; s > 0; s /= 2) {
        const float ot = __shfl_xor_sync(mask, t, s, G);
        const int ok = __shfl_xor_sync(mask, k, s, G);
        if (ot < t || (ot == t && ok < k)) {
          t = ot;
          k = ok;
        }
      }
    }
  }
  // lane 0's value of the group
  __device__ __forceinline__ int first(int x) const {
    if constexpr (G == 1) return x;
    else return __shfl_sync(mask, x, 0, G);
  }
};

// One wide step: the children in `want` (8-bit mask) of node `par` of level
// l - 1, tested against the segment [0, bound].  Returns the mask of those
// it meets; j, the nearest of them (lowest entry t, then lowest index) when
// NEAREST, else the lowest index (8 when none).
template <int G, bool NEAREST>
__device__ __forceinline__ unsigned wide_step(const Tris& T, int l, int par, unsigned want, V3 o,
                                              V3 inv, float bound, const Lanes<G>& g, int& j) {
  const int first = par * TRI_FANOUT;
  const int nchild = min(TRI_FANOUT, T.cnt[l] - first);
  want &= (1u << nchild) - 1u;
  unsigned hit = 0;
  float tb = __int_as_float(0x7f800000);
  int jb = TRI_FANOUT;
#pragma unroll
  for (int s = 0; s < (TRI_FANOUT + G - 1) / G; ++s) {
    const int c = s * G + g.rank;
    if (c < TRI_FANOUT && (want >> c & 1u)) {
      const float4* box = T.node + 2 * (T.off[l] + first + c);
      float tmn;
      if (box_entry(__ldg(box), __ldg(box + 1), o, inv, bound, tmn)) {
        hit |= 1u << c;
        if (NEAREST && tmn < tb) {
          tb = tmn;
          jb = c;
        }
      }
    }
  }
  hit = g.any_or(hit);
  if constexpr (NEAREST) {
    g.min_pair(tb, jb);
    j = jb;
  } else {
    j = hit ? __ffs(hit) - 1 : TRI_FANOUT;
  }
  return hit;
}

// Walk the AABB tree depth first from the root; a node whose box the
// segment [0, bound()] misses is skipped with its subtree.  leaf(first,
// last) tests triangles [first, last) and returns true to stop the walk.
// NEAREST: children by entry t, each tested again against the bound when
// it is taken up (bound() must not grow); else children in id order.
template <int G, bool NEAREST, class Bound, class Leaf>
__device__ __forceinline__ void tri_walk(const Tris& T, V3 o, V3 d, const Lanes<G>& g,
                                         Bound bound, Leaf leaf) {
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  const int last = T.levels - 1;
  {
    float tmn;
    if (!box_entry(__ldg(T.node), __ldg(T.node + 1), o, inv, bound(), tmn)) return;
  }
  int l = 0, cur = 0;
  uint64_t pend = 0;  // byte l: children of cur's ancestor at level l - 1 still to visit
  for (;;) {
    // visit node cur of level l
    if (l == last) {
      const int first = cur * T.block;
      if (leaf(first, min(first + T.block, T.n))) return;
    } else {
      int j;
      const unsigned hit = wide_step<G, NEAREST>(T, l + 1, cur, 0xffu, o, inv, bound(), g, j);
      if (hit) {
        ++l;
        pend |= (uint64_t)(hit & ~(1u << j)) << (8 * l);
        cur = cur * TRI_FANOUT + j;
        continue;
      }
    }
    // up to the deepest level with a child still to visit
    for (;;) {
      if (l == 0) return;
      unsigned m = (unsigned)(pend >> (8 * l)) & 0xffu;
      pend &= ~((uint64_t)0xffu << (8 * l));
      int j = m ? __ffs(m) - 1 : TRI_FANOUT;
      if (NEAREST && m) m = wide_step<G, true>(T, l, cur / TRI_FANOUT, m, o, inv, bound(), g, j);
      if (m) {
        pend |= (uint64_t)(m & ~(1u << j)) << (8 * l);
        cur = cur - cur % TRI_FANOUT + j;
        break;
      }
      --l;
      cur /= TRI_FANOUT;
    }
  }
}

// Closest triangle and light occlusion of the ray (o, d) (trace.py:433-488):
// tbest/wbest the closest hit, the lowest id among equal t; lblock set by an
// opaque triangle at t <= lt.  Boxes beyond max(lt, min(bt, tbest)) cannot
// change either answer (lt no longer counts once the light is blocked).
// lt = -inf asks for the closest hit alone.  The lanes of a group test the
// triangles of a leaf in turn and merge.
template <int G>
__device__ __forceinline__ void tri_closest(const Tris& T, V3 o, V3 d, float lt, float bt,
                                            float& tbest, int& wbest, bool& lblock,
                                            const Lanes<G>& g) {
  const float lt_seg = isfinite(lt) ? lt : 0.0f;
  tri_walk<G, true>(
      T, o, d, g,
      [&] {
        const float b = fminf(bt, tbest);
        return lblock ? b : fmaxf(lt_seg, b);
      },
      [&](int first, int last) {
        bool lb = false;
        for (int k = first + g.rank; k < last; k += G) {
          float t;
          bool transp;
          if (!tri_t(T.geom + 3 * k, o, d, t, transp)) continue;
          if (t < tbest || (t == tbest && k < wbest)) {
            tbest = t;
            wbest = k;
          }
          if (!transp && t <= lt) lb = true;
        }
        g.min_pair(tbest, wbest);
        if (g.any_or(lb)) lblock = true;
        return false;
      });
}

// Blocker test of the ray from p along q (trace.py:305-386): true at the
// first opaque triangle with t < tmax (t <= tmax where INCLUSIVE, the light
// test); counts the transparent ones in range met until then, so the count
// is defined only where the ray is not blocked.  A group tests a whole leaf
// before it stops; a thread alone stops at the opaque triangle.
template <int G, bool INCLUSIVE>
__device__ __forceinline__ bool tri_feeler(const Tris& T, V3 p, V3 q, float tmax, int& crossed,
                                           const Lanes<G>& g) {
  bool blocked = false;
  tri_walk<G, false>(
      T, p, q, g, [&] { return tmax; },
      [&](int first, int last) {
        bool opaque = false;
        int n = 0;
        for (int k = first + g.rank; k < last; k += G) {
          float t;
          bool transp;
          if (!tri_t(T.geom + 3 * k, p, q, t, transp) || !(INCLUSIVE ? t <= tmax : t < tmax))
            continue;
          if (!transp) {
            opaque = true;
            if (G == 1) break;
          } else {
            ++n;
          }
        }
        crossed += g.sum(n);
        blocked = g.any_or(opaque) != 0;
        return blocked;
      });
  return blocked;
}
