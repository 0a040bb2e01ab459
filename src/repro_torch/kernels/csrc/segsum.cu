// Segment-sum push SpMV over destination-sorted edges, dense and
// node-blocked, and the elementwise BFS frontier step.
//
// Replaces the Pallas TPU kernels src/repro/kernels/segsum.py::
// edge_segment_push (_push_kernel), ::edge_segment_push_blocked
// (_blocked_push_kernel, with _first_visit and _visited_block_mask) and
// ::frontier_update (_frontier_kernel).
//
// The push computes y[j] = sum of x[src[e]] over the edges e with
// dst[e] == j. Dense: an edge counts if 0 <= src, dst < n. Blocked: edge e
// of tile t counts if src lies in source block clip(src_block[t]) and dst in
// destination block clip(dst_block[t]), blocks of bn nodes clipped to
// [0, n_blocks). Every other edge (the sentinel padding, a struck id or
// block coordinate) drops, as in the reference's *_ref functions.
//
// What bounds the push on an H100: memory. The function reads 8 bytes of
// ids per edge, each x once and writes each y once (the blocked form also
// reads 8 bytes per tile): about 0.15 ms at 3.35 TB/s for a Graph500
// scale-22 graph (57 M edges). The gather x[src] is random, but the node
// vector (16.8 MB at 4 M nodes) stays in the 50 MB L2. The TPU kernel's
// one-hot matmuls (O(N x tile) work per tile) are not carried over: here
// one thread takes one edge. Edges are sorted by destination, and a
// power-law graph's hottest node has some 700,000 in-edges, so one atomic
// per edge would serialise on its address. Each warp therefore sums its
// runs of equal destination with a segmented shuffle scan first and issues
// one atomicAdd per run from the run's first lane.
//
// The sums are kept in float64, in a scratch vector the wrapper allocates
// and the entry point zeroes with cudaMemsetAsync, and rounded once to y's
// float32 by a second pass. The atomics land in an order that changes from
// run to run; in float32 some 20,000 of them into the hub's address would
// drift by a few 1e-6 of its value, in float64 the result is the float32
// rounding of the exact sum to within one ulp, as the plain version's. The
// scratch costs 12 bytes per node beside the 8 per edge. Destination
// blocks no tile reaches come out exactly 0, as the reference's where
// gives, and integer-valued x sums exactly.
//
// The frontier step is one thread per node: newly = pushed > 0 and not
// visited; visited |= newly; dist = newly ? level : dist. It reads 12 and
// writes 12 bytes per node and is bound by those bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Add v into acc[key] for every lane of the warp, summed first over each
// run of equal consecutive key (lanes in edge order), one atomic per run. A
// lane with key < 0 holds a dropped edge. All 32 lanes must call it.
__device__ __forceinline__ void warp_run_add(double* __restrict__ acc,
                                             int key, double v) {
  int lane = threadIdx.x & 31;
  int prev = __shfl_up_sync(kFull, key, 1);
  bool head = lane == 0 || prev != key;
  unsigned heads = __ballot_sync(kFull, head);
  // the run of this lane ends where the next head above it starts
  unsigned above = heads & ~(unsigned)((2ull << lane) - 1);
  int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    double other = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += other;
  }
  if (head && key >= 0) atomicAdd(acc + key, v);
}

__global__ void __launch_bounds__(kThreads)
push_kernel(const int* __restrict__ src, const int* __restrict__ dst,
            const float* __restrict__ x, double* __restrict__ acc,
            long long n_edges, int n) {
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  int key = -1;
  double v = 0.0;
  if (e < n_edges) {
    int s = src[e], d = dst[e];
    if (s >= 0 && s < n && d >= 0 && d < n) {
      key = d;
      v = x[s];
    }
  }
  warp_run_add(acc, key, v);
}

__global__ void __launch_bounds__(kThreads)
push_blocked_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ src_block,
                    const int* __restrict__ dst_block,
                    const float* __restrict__ x, double* __restrict__ acc,
                    long long n_edges, long long tile_edges, int n_blocks,
                    int bn) {
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  int key = -1;
  double v = 0.0;
  if (e < n_edges) {
    long long t = e / tile_edges;
    int sb = min(max(src_block[t], 0), n_blocks - 1);
    int db = min(max(dst_block[t], 0), n_blocks - 1);
    long long s = src[e], d = dst[e];
    long long s0 = (long long)sb * bn, d0 = (long long)db * bn;
    if (s >= s0 && s < s0 + bn && d >= d0 && d < d0 + bn) {
      key = (int)d;
      v = x[s];
    }
  }
  warp_run_add(acc, key, v);
}

__global__ void __launch_bounds__(kThreads)
round_kernel(const double* __restrict__ acc, float* __restrict__ y,
             long long n) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = (float)acc[i];
}

__global__ void __launch_bounds__(kThreads)
frontier_kernel(const float* __restrict__ pushed,
                const int* __restrict__ visited, const int* __restrict__ dist,
                int level, int* __restrict__ frontier_out,
                int* __restrict__ visited_out, int* __restrict__ dist_out,
                long long n) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int vis = visited[i];
  int newly = (pushed[i] > 0.f) && (vis == 0);
  frontier_out[i] = newly;
  visited_out[i] = vis | newly;
  dist_out[i] = newly ? level : dist[i];
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Zero acc (n,) f64, run the push on it, round it into y (n,) f32.
template <typename Push>
int push_into(void* y, void* acc, long long n, cudaStream_t st, Push push) {
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(double), st);
  if (err != cudaSuccess) return (int)err;
  push();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    round_kernel<<<blocks_for(n), kThreads, 0, st>>>((const double*)acc,
                                                     (float*)y, n);
  return (int)cudaGetLastError();
}

}  // namespace

// src, dst (n_edges,) i32, x (n,) f32 -> y (n,) f32; acc (n,) f64 scratch
extern "C" int hrm_segsum_push(const void* src, const void* dst,
                               const void* x, void* y, void* acc,
                               long long n_edges, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return push_into(y, acc, n, st, [&] {
    if (n_edges > 0)
      push_kernel<<<blocks_for(n_edges), kThreads, 0, st>>>(
          (const int*)src, (const int*)dst, (const float*)x, (double*)acc,
          n_edges, (int)n);
  });
}

// src, dst (n_edges,) i32 in tiles of tile_edges, src_block, dst_block
// (n_edges / tile_edges,) i32, x (n_blocks * bn,) f32 -> y, the same;
// acc (n_blocks * bn,) f64 scratch
extern "C" int hrm_segsum_push_blocked(const void* src, const void* dst,
                                       const void* src_block,
                                       const void* dst_block, const void* x,
                                       void* y, void* acc, long long n_edges,
                                       long long tile_edges,
                                       long long n_blocks, long long bn,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return push_into(y, acc, n_blocks * bn, st, [&] {
    if (n_edges > 0)
      push_blocked_kernel<<<blocks_for(n_edges), kThreads, 0, st>>>(
          (const int*)src, (const int*)dst, (const int*)src_block,
          (const int*)dst_block, (const float*)x, (double*)acc, n_edges,
          tile_edges, (int)n_blocks, (int)bn);
  });
}

// pushed (n,) f32, visited, dist (n,) i32, level -> frontier, visited',
// dist' (n,) i32
extern "C" int hrm_frontier_update(const void* pushed, const void* visited,
                                   const void* dist, void* frontier_out,
                                   void* visited_out, void* dist_out,
                                   long long level, long long n,
                                   void* stream) {
  if (n > 0)
    frontier_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pushed, (const int*)visited, (const int*)dist,
        (int)level, (int*)frontier_out, (int*)visited_out, (int*)dist_out,
        n);
  return (int)cudaGetLastError();
}
