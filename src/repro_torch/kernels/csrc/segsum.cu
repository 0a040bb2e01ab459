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
// What bounds the push on an H100: bytes. The function reads 8 bytes of
// ids per edge, each x once and writes each y once (the blocked form also
// reads 8 bytes per tile): about 0.15 ms at 3.35 TB/s for a Graph500
// scale-22 graph (57 M edges). In practice it is bound by L2 traffic. The
// gather x[src] is random; the node vector (16.8 MB at 4 M nodes) stays in
// the 50 MB L2, but each gather moves a 32-byte sector from L2 for 4
// useful bytes (1.8 GB at that size), and every float64 atomic is an L2
// operation: 4.2 M of them dense, 27.8 M blocked, where each destination's
// in-edges are split over up to 64 source-block buckets. The TPU kernel's
// one-hot matmuls (O(N x tile) work per tile) are not carried over.
//
// The design, and what it does about each cause (tools/push_trace.py
// times the variants that chose it):
// - K = kEdges consecutive edges per thread. The ids come in as 16-byte
//   int4 streaming loads, and all K gathers x[src] are issued before the
//   first add, so K loads are in flight per thread instead of one.
// - Edges are sorted by destination, and a power-law graph's hottest node
//   has some 700,000 in-edges, so one atomic per edge would serialise on
//   its address. Each thread sums its own runs of equal destination in
//   float64 registers and adds a run that lies wholly inside its K edges
//   at once. Its first and last runs may continue into the lanes beside
//   it: one segmented shuffle scan across the warp per 32 x K edges joins
//   them, and each run is added with one atomic per warp.
// - Blocks of 1024 threads take consecutive edges in edge order, one
//   block an SM. An SM then gathers from one bucket's 256 KB source block
//   at a time, and its L1 serves the sectors the bucket reuses (the ids
//   are loaded evict-first to leave it to them); the card as a whole
//   works on a narrow range of destinations, whose scratch lines stay in
//   L2 for the atomics. A persistent grid that spreads its blocks over the
//   whole edge array loses that and is slower.
// - The blocked push finds its tile once: when a tile is whole warps of
//   32 x K edges (the main path's 512-edge tiles, two warps), from the
//   warp's index, loading and clipping src_block[t] and dst_block[t] once
//   per warp. Any other tile size takes a general path in the same
//   kernel: the tile of a thread's first edge by one 32-bit division, then
//   advanced edge by edge.
// - A base pointer that is not 16-byte aligned (a slice such as src[1:])
//   is served by a scalar head: the thread of group 0 takes the edges
//   before the first aligned address, and groups 1.. start there. A
//   partial last group is the scalar tail. When src and dst differ in
//   alignment every group loads scalars.
//
// The sums are kept in float64, in a scratch vector the wrapper allocates
// and the entry point zeroes with cudaMemsetAsync, and rounded once to y's
// float32 by a second pass. The atomics land in an order that changes from
// run to run; in float64 the result is the float32 rounding of the exact
// sum to within one ulp, as the plain version's. The scratch costs 12
// bytes per node beside the 8 per edge; on an H100 the memset and the
// round pass take some 6 % of a call, so they stay two plain passes.
// Destination blocks no tile reaches
// come out exactly 0, as the reference's where gives, and integer-valued x
// sums exactly.
//
// The frontier step is one thread per node: newly = pushed > 0 and not
// visited; visited |= newly; dist = newly ? level : dist. It reads 12 and
// writes 12 bytes per node and is bound by those bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // round and frontier kernels
constexpr int kPushThreads = 1024;    // push kernels: one block an SM
constexpr int kEdges = 8;             // K: edges per thread in the pushes
constexpr unsigned kFull = 0xffffffffu;

// The edges [lo, hi) of thread group q. Group 0 is the scalar head of
// K - shift edges (none when shift is 0); group q > 0 starts at
// q * K - shift, and the last group is cut at n_edges.
struct Span {
  long long lo, hi;
};

template <int K>
__device__ __forceinline__ Span group_span(long long q, int shift,
                                           long long n_edges) {
  long long lo = q * K - shift, hi = lo + K;
  return {lo < 0 ? 0 : lo, hi < n_edges ? hi : n_edges};
}

// The ids of edges [lo, hi); the slots past hi get dst = -1, which every
// drop test drops. VEC: src + lo and dst + lo are 16-byte aligned whenever
// the group is whole. The ids are read once: streaming loads (evict
// first), so they leave the L1 to the x sectors the gathers reuse.
template <int K, bool VEC>
__device__ __forceinline__ void load_ids(const int* __restrict__ src,
                                         const int* __restrict__ dst, Span g,
                                         int (&s)[K], int (&d)[K]) {
  static_assert(K % 4 == 0, "K is whole int4 loads");
  if (VEC && g.hi - g.lo == K) {
    const int4* s4 = reinterpret_cast<const int4*>(src + g.lo);
    const int4* d4 = reinterpret_cast<const int4*>(dst + g.lo);
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      int4 a = __ldcs(s4 + j), b = __ldcs(d4 + j);
      s[4 * j] = a.x, s[4 * j + 1] = a.y, s[4 * j + 2] = a.z;
      s[4 * j + 3] = a.w;
      d[4 * j] = b.x, d[4 * j + 1] = b.y, d[4 * j + 2] = b.z;
      d[4 * j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      bool in = g.lo + i < g.hi;
      s[i] = in ? __ldcs(src + g.lo + i) : 0;
      d[i] = in ? __ldcs(dst + g.lo + i) : -1;
    }
  }
}

// v[i] = x[src] for each counted edge (key >= 0 and src_ok), else 0; all K
// gathers are issued before any is used.
template <int K>
__device__ __forceinline__ void gather(const float* __restrict__ x,
                                       const int (&s)[K], const int (&key)[K],
                                       const bool (&src_ok)[K], float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    v[i] = key[i] >= 0 && src_ok[i] ? __ldg(x + s[i]) : 0.f;
}

// Add v[i] into acc[key[i]] for the K edges of every lane of the warp
// (lanes in edge order, each lane's edges in order; key < 0 drops), each
// run of equal key summed in float64 first and added with one atomic per
// warp. All 32 lanes must call it.
template <int K>
__device__ __forceinline__ void warp_runs_add(double* __restrict__ acc,
                                              const int (&key)[K],
                                              const float (&v)[K]) {
  // the lane's own runs: the first (hk, hs) and the last (tk, ts) may
  // continue into the lanes beside it, every run between them is added
  int hk = key[0], tk = key[0];
  double hs = 0.0, ts = v[0];
  bool single = true;                 // one run over all K edges
#pragma unroll
  for (int i = 1; i < K; ++i) {
    if (key[i] != tk) {
      if (single) {
        hs = ts;
        single = false;
      } else if (tk >= 0) {
        atomicAdd(acc + tk, ts);
      }
      tk = key[i];
      ts = 0.0;
    }
    ts += v[i];
  }
  // Segmented inclusive scan of the last runs over the lanes: a segment
  // starts at a lane with a run boundary, or whose one run has another key
  // than the lane before's last run.
  int lane = threadIdx.x & 31;
  int prev_tk = __shfl_up_sync(kFull, tk, 1);
  bool seg_head = lane == 0 || !single || prev_tk != tk;
  unsigned heads = __ballot_sync(kFull, seg_head);
  int start = 31 - __clz(heads & (kFull >> (31 - lane)));
  double sum = ts;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    double other = __shfl_up_sync(kFull, sum, off);
    if (lane - off >= start) sum += other;
  }
  double prev_sum = __shfl_up_sync(kFull, sum, 1);
  int next_hk = __shfl_down_sync(kFull, hk, 1);
  // a lane's first run takes the segment that ends just before it when
  // their keys agree; otherwise the segment's last lane adds the segment
  if (!single && hk >= 0)
    atomicAdd(acc + hk, lane > 0 && hk == prev_tk ? hs + prev_sum : hs);
  bool seg_end = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (seg_end && tk >= 0 && !(lane < 31 && next_hk == tk))
    atomicAdd(acc + tk, sum);
}

// The drop tests: key = dst where dst counts, else -1; src_ok where src
// counts. Dense: each id counts in [0, n).
template <int K>
__device__ __forceinline__ void dense_test(int n, const int (&s)[K],
                                           const int (&d)[K], int (&key)[K],
                                           bool (&src_ok)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    key[i] = (unsigned)d[i] < (unsigned)n ? d[i] : -1;
    src_ok[i] = (unsigned)s[i] < (unsigned)n;
  }
}

// block b of bn nodes, b clipped to [0, n_blocks), as its first node
__device__ __forceinline__ int block_base(const int* __restrict__ table,
                                          unsigned t, int n_blocks, int bn) {
  return min(max(__ldg(table + t), 0), n_blocks - 1) * bn;
}

// Blocked: edge e of tile t counts if src lies in [s0, s0 + bn) and dst in
// [d0, d0 + bn), s0 and d0 the clipped blocks of src_block[t] and
// dst_block[t]. WARP_TILE: a tile is warps_per_tile whole warps (shift is
// 0), so the tile of group q's warp is its index over warps_per_tile.
// Otherwise the tile of each edge is found from the group's first edge.
// n_edges < 2**32.
template <int K, bool WARP_TILE>
__device__ __forceinline__ void blocked_test(
    const int* __restrict__ src_block, const int* __restrict__ dst_block,
    unsigned tile_edges, unsigned warps_per_tile, int n_blocks, int bn,
    long long q, Span g, const int (&s)[K], const int (&d)[K], int (&key)[K],
    bool (&src_ok)[K]) {
  unsigned ubn = (unsigned)bn;
  if (WARP_TILE) {
    int s0 = 0, d0 = 0;
    if (g.lo < g.hi) {
      unsigned t = (unsigned)(q >> 5) / warps_per_tile;
      s0 = block_base(src_block, t, n_blocks, bn);
      d0 = block_base(dst_block, t, n_blocks, bn);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      key[i] = (unsigned)d[i] - (unsigned)d0 < ubn ? d[i] : -1;
      src_ok[i] = (unsigned)s[i] - (unsigned)s0 < ubn;
    }
  } else {
    unsigned cnt = g.lo < g.hi ? (unsigned)(g.hi - g.lo) : 0u;
    unsigned t = 0, r = 0;
    int s0 = 0, d0 = 0;
    if (cnt) {
      unsigned e = (unsigned)g.lo;
      t = e / tile_edges;
      r = e - t * tile_edges;
      s0 = block_base(src_block, t, n_blocks, bn);
      d0 = block_base(dst_block, t, n_blocks, bn);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i > 0 && i < cnt && ++r == tile_edges) {
        r = 0;
        ++t;
        s0 = block_base(src_block, t, n_blocks, bn);
        d0 = block_base(dst_block, t, n_blocks, bn);
      }
      key[i] = (unsigned)d[i] - (unsigned)d0 < ubn ? d[i] : -1;
      src_ok[i] = (unsigned)s[i] - (unsigned)s0 < ubn;
    }
  }
}

template <int K, bool VEC>
__global__ void __launch_bounds__(kPushThreads)
push_kernel(const int* __restrict__ src, const int* __restrict__ dst,
            const float* __restrict__ x, double* __restrict__ acc,
            long long n_edges, int shift, int n) {
  long long q = (long long)blockIdx.x * kPushThreads + threadIdx.x;
  int s[K], d[K], key[K];
  bool src_ok[K];
  float v[K];
  load_ids<K, VEC>(src, dst, group_span<K>(q, shift, n_edges), s, d);
  dense_test<K>(n, s, d, key, src_ok);
  gather<K>(x, s, key, src_ok, v);
  warp_runs_add<K>(acc, key, v);
}

template <int K, bool VEC, bool WARP_TILE>
__global__ void __launch_bounds__(kPushThreads)
push_blocked_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ src_block,
                    const int* __restrict__ dst_block,
                    const float* __restrict__ x, double* __restrict__ acc,
                    long long n_edges, int shift, unsigned tile_edges,
                    unsigned warps_per_tile, int n_blocks, int bn) {
  long long q = (long long)blockIdx.x * kPushThreads + threadIdx.x;
  Span g = group_span<K>(q, shift, n_edges);
  int s[K], d[K], key[K];
  bool src_ok[K];
  float v[K];
  load_ids<K, VEC>(src, dst, g, s, d);
  blocked_test<K, WARP_TILE>(src_block, dst_block, tile_edges,
                             warps_per_tile, n_blocks, bn, q, g, s, d, key,
                             src_ok);
  gather<K>(x, s, key, src_ok, v);
  warp_runs_add<K>(acc, key, v);
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

unsigned blocks_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

// How the K-edge groups lie over src and dst: vec when both share their
// offset from a 16-byte boundary, and then shift = K - (edges before the
// first aligned src), or 0 when src is aligned; returns the group count.
template <int K>
long long edge_groups(const void* src, const void* dst, long long n_edges,
                      bool* vec, int* shift) {
  uintptr_t a = (uintptr_t)src & 15, b = (uintptr_t)dst & 15;
  *vec = a == b && a % 4 == 0;
  int head = *vec ? (int)((16 - a) & 15) / 4 : 0;
  *shift = head ? K - head : 0;
  return (n_edges + *shift + K - 1) / K;
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

template <int K>
void launch_push(const void* src, const void* dst, const void* x, void* acc,
                 long long n_edges, long long n, cudaStream_t st) {
  bool vec;
  int shift;
  long long groups = edge_groups<K>(src, dst, n_edges, &vec, &shift);
  auto kernel = vec ? push_kernel<K, true> : push_kernel<K, false>;
  kernel<<<blocks_for(groups, kPushThreads), kPushThreads, 0, st>>>(
      (const int*)src, (const int*)dst, (const float*)x, (double*)acc,
      n_edges, shift, (int)n);
}

template <int K>
void launch_push_blocked(const void* src, const void* dst,
                         const void* src_block, const void* dst_block,
                         const void* x, void* acc, long long n_edges,
                         long long tile_edges, long long n_blocks,
                         long long bn, cudaStream_t st) {
  bool vec;
  int shift;
  long long groups = edge_groups<K>(src, dst, n_edges, &vec, &shift);
  bool warp_tile = shift == 0 && tile_edges % (32 * K) == 0;
  auto kernel =
      vec ? (warp_tile ? push_blocked_kernel<K, true, true>
                       : push_blocked_kernel<K, true, false>)
          : (warp_tile ? push_blocked_kernel<K, false, true>
                       : push_blocked_kernel<K, false, false>);
  kernel<<<blocks_for(groups, kPushThreads), kPushThreads, 0, st>>>(
      (const int*)src, (const int*)dst, (const int*)src_block,
      (const int*)dst_block, (const float*)x, (double*)acc, n_edges, shift,
      (unsigned)tile_edges, (unsigned)(tile_edges / (32 * K)),
      (int)n_blocks, (int)bn);
}

}  // namespace

// src, dst (n_edges,) i32, x (n,) f32 -> y (n,) f32; acc (n,) f64 scratch
extern "C" int hrm_segsum_push(const void* src, const void* dst,
                               const void* x, void* y, void* acc,
                               long long n_edges, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return push_into(y, acc, n, st, [&] {
    if (n_edges > 0) launch_push<kEdges>(src, dst, x, acc, n_edges, n, st);
  });
}

// src, dst (n_edges,) i32 in tiles of tile_edges, src_block, dst_block
// (n_edges / tile_edges,) i32, x (n_blocks * bn,) f32 -> y, the same;
// acc (n_blocks * bn,) f64 scratch; n_edges < 2**32
extern "C" int hrm_segsum_push_blocked(const void* src, const void* dst,
                                       const void* src_block,
                                       const void* dst_block, const void* x,
                                       void* y, void* acc, long long n_edges,
                                       long long tile_edges,
                                       long long n_blocks, long long bn,
                                       void* stream) {
  if (n_edges >> 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return push_into(y, acc, n_blocks * bn, st, [&] {
    if (n_edges > 0)
      launch_push_blocked<kEdges>(src, dst, src_block, dst_block, x, acc,
                                  n_edges, tile_edges, n_blocks, bn, st);
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
