// Triangle queries over a ray array for NVIDIA Hopper (sm_90a).
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
// boxes, and capped the table at 32,768 triangles.  Here the rays walk the
// same implicit AABB tree as the megakernel (tri_walk.cuh: blocks of 16
// Morton-ordered triangles, unions of 8 per level up to the mesh), in f32,
// with the tables in device memory whatever their size (L2 holds 50 MB).
//
// What bounds it is not its operations or its bytes but the longest chain
// of dependent steps of one ray: few rays meet the mesh (1.6-6% of the
// primary rays of the benchmark camera), and a walk is a chain of box tests
// and triangle tests that each wait on a load.  So two kernels:
//   1. tri_query_live: one thread per ray tests the root box, writes the
//      answer of every ray that misses it, and appends the others to a
//      queue (a warp ballot, one atomic per warp);
//   2. tri_query_walk: persistent blocks, as many as fit on the card, in
//      which groups of QUERY_GROUP lanes take the queued rays one by one
//      from a counter and
//      walk each together: a lane per child box in a wide step, a triangle
//      a lane in a leaf (tri_walk.cuh), nearest child first for the closest
//      hit.  The few long walks spread over all SMs, and the chain of one
//      ray is cut by up to the group's width.
// QUERY_GROUP = 16 was the fastest of 4, 8 and 16 on the H100 (PERF.md):
// half of its lanes wait in a wide step, but a leaf is one step.

#include "tri_walk.cuh"

#define QUERY_BLOCK 256
#define QUERY_GROUP 16

// 1. the rays that enter the root box, appended to queue[]; queued[0]
//    counts them.  The answers of the others are written here.
template <bool CLOSEST>
__global__ void __launch_bounds__(QUERY_BLOCK)
tri_query_live(const Tris T, int n, const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, float* __restrict__ t_out,
               int* __restrict__ id_out, uint8_t* __restrict__ blocked,
               int* __restrict__ count, int* __restrict__ queue, int* __restrict__ queued) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < n) {
    if (CLOSEST) {
      t_out[i] = __int_as_float(0x7f800000);
      id_out[i] = -1;
    } else {
      blocked[i] = 0;
      count[i] = 0;
    }
    const float bound = CLOSEST ? __int_as_float(0x7f800000) : tmax[i];
    if (CLOSEST || bound > 0.0f) {
      const V3 dd = load3(d + 3 * (size_t)i);
      const V3 inv = v3(safe_inv(dd.x), safe_inv(dd.y), safe_inv(dd.z));
      float tmn;
      live = box_entry(__ldg(T.node), __ldg(T.node + 1), load3(o + 3 * (size_t)i), inv, bound,
                       tmn);
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (!ballot) return;
  const int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(queued, __popc(ballot));
  at = __shfl_sync(0xffffffffu, at, leader);
  if (live) queue[at + __popc(ballot & ((1u << lane) - 1u))] = i;
}

// 2. the walks of the queued rays; counters[0] = queued rays, counters[1] =
//    the next one to take.
template <bool CLOSEST, bool INCLUSIVE>
__global__ void __launch_bounds__(QUERY_BLOCK)
tri_query_walk(const Tris T, const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, float* __restrict__ t_out,
               int* __restrict__ id_out, uint8_t* __restrict__ blocked,
               int* __restrict__ count, const int* __restrict__ queue, int* counters) {
  const int queued = counters[0];
  const Lanes<QUERY_GROUP> g;
  for (;;) {
    int r = 0;
    if (g.rank == 0) r = atomicAdd(counters + 1, 1);
    r = g.first(r);
    if (r >= queued) return;
    const int i = queue[r];
    const V3 oo = load3(o + 3 * (size_t)i), dd = load3(d + 3 * (size_t)i);
    if (CLOSEST) {
      const float INF = __int_as_float(0x7f800000);
      float tbest = INF;
      int wbest = -1;
      bool lblock = false;
      tri_closest(T, oo, dd, -INF, INF, tbest, wbest, lblock, g);
      if (g.rank == 0) {
        t_out[i] = tbest;
        id_out[i] = wbest;
      }
    } else {
      int crossed = 0;
      const bool b = tri_feeler<QUERY_GROUP, INCLUSIVE>(T, oo, dd, tmax[i], crossed, g);
      if (g.rank == 0) {
        blocked[i] = b;
        count[i] = crossed;
      }
    }
  }
}

// Both kernels on `stream`: queue (n ints) and counters (2 ints) are
// scratch of the caller.
template <bool CLOSEST, bool INCLUSIVE>
static int query(const Tris& T, int n, const float* o, const float* d, const float* tmax,
                 float* t, int* id, uint8_t* blocked, int* count, int* queue, int* counters,
                 cudaStream_t stream) {
  if (T.n == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  tri_query_live<CLOSEST><<<(n + QUERY_BLOCK - 1) / QUERY_BLOCK, QUERY_BLOCK, 0, stream>>>(
      T, n, o, d, tmax, t, id, blocked, count, queue, counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto walk = tri_query_walk<CLOSEST, INCLUSIVE>;
  // persistent: the blocks that fit at once (asked once per device: the
  // query costs host time), no more than the rays need
  static int fit_dev = -1, fit = 0;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev != fit_dev) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk, QUERY_BLOCK, 0)) !=
            cudaSuccess)
      return (int)err;
    fit_dev = dev;
    fit = sms * per_sm;
  }
  const int groups = QUERY_BLOCK / QUERY_GROUP;
  const int grid = max(1, min(fit, (n + groups - 1) / groups));
  walk<<<grid, QUERY_BLOCK, 0, stream>>>(T, o, d, tmax, t, id, blocked, count, queue,
                                         counters);
  return (int)cudaGetLastError();
}

extern "C" int tpuray_tri_query_closest(const float* geom, const float* node, int n_tris,
                                        int levels, const int* level_n, int block, int fanout,
                                        int n, const float* o, const float* d, float* t,
                                        int* id, int* queue, int* counters, void* stream) {
  Tris T;
  cudaError_t err = make_tris(geom, nullptr, node, n_tris, levels, level_n, block, fanout, T);
  if (err != cudaSuccess) return (int)err;
  return query<true, false>(T, n, o, d, nullptr, t, id, nullptr, nullptr, queue, counters,
                            (cudaStream_t)stream);
}

extern "C" int tpuray_tri_query_blocker(const float* geom, const float* node, int n_tris,
                                        int levels, const int* level_n, int block, int fanout,
                                        int n, const float* o, const float* d,
                                        const float* tmax, int inclusive,
                                        unsigned char* blocked, int* count, int* queue,
                                        int* counters, void* stream) {
  Tris T;
  cudaError_t err = make_tris(geom, nullptr, node, n_tris, levels, level_n, block, fanout, T);
  if (err != cudaSuccess) return (int)err;
  auto run = inclusive ? query<false, true> : query<false, false>;
  return run(T, n, o, d, tmax, nullptr, nullptr, blocked, count, queue, counters,
             (cudaStream_t)stream);
}
