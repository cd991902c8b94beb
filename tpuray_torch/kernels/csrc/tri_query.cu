// Triangle queries over a ray array for NVIDIA Hopper (sm_90a): one thread
// answers one ray.
//
// Replaces: tpuray/kernels/pallas_trace.py, _make_query_kernel.kernel
// (:2766), launched by _query_rays (:3046, pallas_call :3085) on 16x128 ray
// tiles through tri_query_closest (:3109) and tri_query_blocker (:3119).
// Wrappers and plain versions: query.py.
//   closest: t of the closest hit (inf on a miss) and the winner's id (-1),
//            the lowest id among equal t, as the JAX kernel's first_g
//            (:2876-2888);
//   blocker: whether an opaque triangle lies at 0 < t < tmax (t <= tmax
//            when inclusive) and the count of transparent ones met before
//            the walk stopped at the first opaque one (:2905-2906, fact):
//            the count is defined where the ray is not blocked.  A ray with
//            tmax <= 0 is inactive (:2790-2793): not blocked, count 0.
//
// The TPU kernel ran Moller-Trumbore as bilinear forms on the MXU at bf16x3
// over 256-triangle blocks held in VMEM, culled by block and superblock
// boxes, and capped the table at 32,768 triangles.  Here a thread walks the
// same implicit AABB tree as the megakernel (tri_walk.cuh: blocks of 16
// Morton-ordered triangles, unions of 8 per level up to the mesh), in f32,
// with the tables in device memory whatever their size (L2 holds 50 MB).
// What bounds it: the operations of the walk (25 per box test, 54 per
// Moller-Trumbore pair) over the fp32 rate, far above the bytes of the rays
// (28 in, 8 out per ray); and, beyond that bound, divergence: the rays of a
// warp enter different boxes and the warp runs the union of their walks.
// Ray sorting, wider trees or a real BVH are later work.

#include "tri_walk.cuh"

#define QUERY_BLOCK 128

__global__ void __launch_bounds__(QUERY_BLOCK)
tri_query_closest_kernel(const Tris T, int n, const float* __restrict__ o,
                         const float* __restrict__ d, float* __restrict__ t_out,
                         int* __restrict__ id_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float INF = __int_as_float(0x7f800000);
  float tbest = INF;
  int wbest = -1;
  bool lblock = false;
  tri_closest(T, load3(o + 3 * (size_t)i), load3(d + 3 * (size_t)i), -INF, INF, tbest, wbest,
              lblock);
  t_out[i] = tbest;
  id_out[i] = wbest;
}

template <bool INCLUSIVE>
__global__ void __launch_bounds__(QUERY_BLOCK)
tri_query_blocker_kernel(const Tris T, int n, const float* __restrict__ o,
                         const float* __restrict__ d, const float* __restrict__ tmax,
                         uint8_t* __restrict__ blocked, int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tm = tmax[i];
  int crossed = 0;
  bool b = false;
  if (tm > 0.0f)
    b = tri_feeler<INCLUSIVE>(T, load3(o + 3 * (size_t)i), load3(d + 3 * (size_t)i), tm,
                              crossed);
  blocked[i] = b;
  count[i] = crossed;
}

extern "C" int tpuray_tri_query_closest(const float* geom, const float* node, int n_tris,
                                        int levels, const int* level_n, int block, int fanout,
                                        int n, const float* o, const float* d, float* t,
                                        int* id, void* stream) {
  Tris T;
  cudaError_t err = make_tris(geom, nullptr, node, n_tris, levels, level_n, block, fanout, T);
  if (err != cudaSuccess) return (int)err;
  if (T.n == 0) return (int)cudaErrorInvalidValue;
  tri_query_closest_kernel<<<(n + QUERY_BLOCK - 1) / QUERY_BLOCK, QUERY_BLOCK, 0,
                             (cudaStream_t)stream>>>(T, n, o, d, t, id);
  return (int)cudaGetLastError();
}

extern "C" int tpuray_tri_query_blocker(const float* geom, const float* node, int n_tris,
                                        int levels, const int* level_n, int block, int fanout,
                                        int n, const float* o, const float* d,
                                        const float* tmax, int inclusive,
                                        unsigned char* blocked, int* count, void* stream) {
  Tris T;
  cudaError_t err = make_tris(geom, nullptr, node, n_tris, levels, level_n, block, fanout, T);
  if (err != cudaSuccess) return (int)err;
  if (T.n == 0) return (int)cudaErrorInvalidValue;
  auto kernel = inclusive ? tri_query_blocker_kernel<true> : tri_query_blocker_kernel<false>;
  kernel<<<(n + QUERY_BLOCK - 1) / QUERY_BLOCK, QUERY_BLOCK, 0, (cudaStream_t)stream>>>(
      T, n, o, d, tmax, blocked, count);
  return (int)cudaGetLastError();
}
