// Variants of the push kernels, built and timed by tools/push_trace.py.
//
// It includes the port's segsum.cu, so the library's K-edge pushes can be
// launched at other K, and adds beside them:
// - the pushes it replaced (one edge per thread, one warp scan per edge),
//   kept as they were, as the yardstick a redesign is timed against in
//   one run;
// - that push without its warp scan (one float64 atomic per counted edge)
//   and without its gather (v = 1), to isolate the two;
// - the K-edge push in parts: without its gather, without its atomics, its
//   ids alone (the floor of streaming them), and walking a persistent grid
//   of blocks over consecutive edges.
#include <type_traits>

#include "../src/repro_torch/kernels/csrc/segsum.cu"

namespace {

// ----------------------------------------------------- one edge a thread
__device__ __forceinline__ void one_edge_warp_run_add(
    double* __restrict__ acc, int key, double v) {
  int lane = threadIdx.x & 31;
  int prev = __shfl_up_sync(kFull, key, 1);
  bool head = lane == 0 || prev != key;
  unsigned heads = __ballot_sync(kFull, head);
  unsigned above = heads & ~(unsigned)((2ull << lane) - 1);
  int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    double other = __shfl_down_sync(kFull, v, off);
    if (lane + off < end) v += other;
  }
  if (head && key >= 0) atomicAdd(acc + key, v);
}

// SCAN false: one atomic per counted edge; GATHER false: v = 1
template <bool SCAN, bool GATHER>
__global__ void __launch_bounds__(kThreads)
one_edge_push_kernel(const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const float* __restrict__ x, double* __restrict__ acc,
                     long long n_edges, int n) {
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  int key = -1;
  double v = 0.0;
  if (e < n_edges) {
    int s = src[e], d = dst[e];
    if (s >= 0 && s < n && d >= 0 && d < n) {
      key = d;
      v = GATHER ? x[s] : 1.0;
    }
  }
  if (SCAN)
    one_edge_warp_run_add(acc, key, v);
  else if (key >= 0)
    atomicAdd(acc + key, v);
}

__global__ void __launch_bounds__(kThreads)
one_edge_push_blocked_kernel(const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const int* __restrict__ src_block,
                             const int* __restrict__ dst_block,
                             const float* __restrict__ x,
                             double* __restrict__ acc, long long n_edges,
                             long long tile_edges, int n_blocks, int bn) {
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
  one_edge_warp_run_add(acc, key, v);
}

// ------------------------------------------------- K-edge push, parts
struct Edges {
  const int *src, *dst, *src_block, *dst_block;
  const float* x;
  double* acc;
  long long n_edges;
  int shift;
  unsigned tile_edges, warps_per_tile;
  int n, n_blocks, bn;
};

// Cache hints of the loads, LOAD: 0 ids and x through ld.global.nc (the
// one-edge kernels' loads), 1 the ids as ld.global.cs (streaming, evict
// first: the library's), 2 the ids with L1::no_allocate, 3 as 2 and x
// with L1::evict_last.
template <int LOAD>
__device__ __forceinline__ int4 ld_ids(const int4* p) {
  int4 r;
  if (LOAD == 0) return __ldg(p);
  if (LOAD == 1) return __ldcs(p);
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

template <int LOAD>
__device__ __forceinline__ float ld_x(const float* p) {
  float r;
  if (LOAD != 3) return __ldg(p);
  asm("ld.global.nc.L1::evict_last.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

// PART: 0 the whole push, 1 without its gather (v = 1), 2 without its
// atomics (ids, drop tests and gathers, one store no input takes), 3 the
// ids and drop tests alone. WALK: gridDim.x blocks each walk per_block
// groups in rounds of THREADS consecutive groups; else one round a block.
// Whole groups of whole-warp tiles on aligned ids only (shift 0).
template <int K, bool BLOCKED, int PART, int THREADS, bool WALK, int LOAD,
          int MIN_BLOCKS = 1>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
part_kernel(Edges a, long long per_block) {
  long long first = (long long)blockIdx.x * (WALK ? per_block : THREADS);
  long long last = first + (WALK ? per_block : THREADS);
  for (long long q0 = first; q0 < last; q0 += THREADS) {
    long long q = q0 + threadIdx.x;
    Span g = group_span<K>(q, 0, a.n_edges);
    int s[K], d[K], key[K];
    bool ok[K];
    float v[K];
    if (g.hi - g.lo == K) {
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        int4 p = ld_ids<LOAD>(reinterpret_cast<const int4*>(a.src + g.lo) +
                              j);
        int4 r = ld_ids<LOAD>(reinterpret_cast<const int4*>(a.dst + g.lo) +
                              j);
        s[4 * j] = p.x, s[4 * j + 1] = p.y, s[4 * j + 2] = p.z;
        s[4 * j + 3] = p.w;
        d[4 * j] = r.x, d[4 * j + 1] = r.y, d[4 * j + 2] = r.z;
        d[4 * j + 3] = r.w;
      }
    } else {
      load_ids<K, false>(a.src, a.dst, g, s, d);
    }
    if (BLOCKED)
      blocked_test<K, true>(a.src_block, a.dst_block, a.tile_edges,
                            a.warps_per_tile, a.n_blocks, a.bn, q, g, s, d,
                            key, ok);
    else
      dense_test<K>(a.n, s, d, key, ok);
    if (PART == 0 || PART == 2) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[i] = key[i] >= 0 && ok[i] ? ld_x<LOAD>(a.x + s[i]) : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] = key[i] >= 0 && ok[i] ? 1.f : 0.f;
    }
    if (PART <= 1) {
      warp_runs_add<K>(a.acc, key, v);
    } else {
      float h = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) h += v[i] + (float)key[i];
      if (h == -12345.f) a.acc[q & 1023] = h;
    }
  }
}

// MAX_L1: ask for the largest L1 (no shared memory carveout); MIN_BLOCKS
// blocks an SM, registers capped to fit them
template <int K, bool BLOCKED, int PART, int THREADS, bool WALK,
          int LOAD = 0, bool MAX_L1 = false, int MIN_BLOCKS = 1>
int launch_part(const Edges& a, long long groups, cudaStream_t st) {
  auto kernel = part_kernel<K, BLOCKED, PART, THREADS, WALK, LOAD,
                            MIN_BLOCKS>;
  if (MAX_L1)
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         0);
  long long blocks = (groups + THREADS - 1) / THREADS, per_block = 0;
  if (WALK) {
    int dev, sms, per_sm;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  0);
    long long rounds = (blocks + (long long)sms * per_sm - 1) /
                       ((long long)sms * per_sm);
    per_block = rounds * THREADS;
    blocks = (groups + per_block - 1) / per_block;
  }
  kernel<<<(unsigned)blocks, THREADS, 0, st>>>(a, per_block);
  return 0;
}

// variant codes of the parts: 4 no gather, 5 ids alone, 8 no atomics (256
// threads a block, LOAD 0), 10 and 12 the whole push walking with 1024 and
// 256 threads a block; the whole push in edge order, one round a block:
// 20-23 with 256 threads and loads LOAD 0-3, 40 and 41 with 1024 threads
// and LOAD 0, 1, 51 with 512 and LOAD 1, 60 with 1024, LOAD 0 and the
// largest L1, 70 and 71 as 41 and 51 with 2048 threads an SM; 80-82 as 4,
// 8, 5 with 1024 threads a block and LOAD 1 (the library's)
template <int K, bool BLOCKED>
int parts(int variant, const Edges& a, long long groups, cudaStream_t st) {
  constexpr int T = kThreads;
  switch (variant) {
    case 4: return launch_part<K, BLOCKED, 1, T, false>(a, groups, st);
    case 5: return launch_part<K, BLOCKED, 3, T, false>(a, groups, st);
    case 8: return launch_part<K, BLOCKED, 2, T, false>(a, groups, st);
    case 10: return launch_part<K, BLOCKED, 0, 1024, true>(a, groups, st);
    case 12: return launch_part<K, BLOCKED, 0, 256, true>(a, groups, st);
    case 20: return launch_part<K, BLOCKED, 0, T, false, 0>(a, groups, st);
    case 21: return launch_part<K, BLOCKED, 0, T, false, 1>(a, groups, st);
    case 22: return launch_part<K, BLOCKED, 0, T, false, 2>(a, groups, st);
    case 23: return launch_part<K, BLOCKED, 0, T, false, 3>(a, groups, st);
    case 40: return launch_part<K, BLOCKED, 0, 1024, false, 0>(a, groups, st);
    case 41: return launch_part<K, BLOCKED, 0, 1024, false, 1>(a, groups, st);
    case 51: return launch_part<K, BLOCKED, 0, 512, false, 1>(a, groups, st);
    case 60:
      return launch_part<K, BLOCKED, 0, 1024, false, 0, true>(a, groups, st);
    case 70:
      return launch_part<K, BLOCKED, 0, 1024, false, 1, false, 2>(a, groups,
                                                                  st);
    case 71:
      return launch_part<K, BLOCKED, 0, 512, false, 1, false, 4>(a, groups,
                                                                 st);
    case 80: return launch_part<K, BLOCKED, 1, 1024, false, 1>(a, groups, st);
    case 81: return launch_part<K, BLOCKED, 2, 1024, false, 1>(a, groups, st);
    case 82: return launch_part<K, BLOCKED, 3, 1024, false, 1>(a, groups, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int K>
int dense(int variant, const void* src, const void* dst, const void* x,
          void* acc, long long n_edges, long long n, cudaStream_t st) {
  bool vec;
  int shift;
  long long groups = edge_groups<K>(src, dst, n_edges, &vec, &shift);
  if (!vec || shift) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    launch_push<K>(src, dst, x, acc, n_edges, n, st);
    return 0;
  }
  if (variant == 6) {
    push_kernel<K, false><<<blocks_for(groups, kPushThreads), kPushThreads,
                            0, st>>>(
        (const int*)src, (const int*)dst, (const float*)x, (double*)acc,
        n_edges, shift, (int)n);
    return 0;
  }
  // the parts are built at K 4, 8 and 16 only
  if (K == 32) return (int)cudaErrorInvalidValue;
  Edges a{(const int*)src, (const int*)dst, nullptr, nullptr,
          (const float*)x, (double*)acc, n_edges, 0, 0u, 0u, (int)n, 0, 0};
  return parts<(K == 32 ? 16 : K), false>(variant, a, groups, st);
}

template <int K>
int blocked(int variant, const void* src, const void* dst, const void* sb,
            const void* db, const void* x, void* acc, long long n_edges,
            long long te, long long nb, long long bn, cudaStream_t st) {
  bool vec;
  int shift;
  long long groups = edge_groups<K>(src, dst, n_edges, &vec, &shift);
  if (variant == 0) {
    launch_push_blocked<K>(src, dst, sb, db, x, acc, n_edges, te, nb, bn, st);
    return 0;
  }
  if (!vec || shift || te % (32 * K)) return (int)cudaErrorInvalidValue;
  if (variant == 7) {
    push_blocked_kernel<K, true, false><<<blocks_for(groups, kPushThreads),
                                          kPushThreads, 0, st>>>(
        (const int*)src, (const int*)dst, (const int*)sb, (const int*)db,
        (const float*)x, (double*)acc, n_edges, shift, (unsigned)te, 1u,
        (int)nb, (int)bn);
    return 0;
  }
  if (K == 32) return (int)cudaErrorInvalidValue;
  Edges a{(const int*)src, (const int*)dst, (const int*)sb, (const int*)db,
          (const float*)x, (double*)acc, n_edges, 0, (unsigned)te,
          (unsigned)(te / (32 * K)), 0, (int)nb, (int)bn};
  return parts<(K == 32 ? 16 : K), true>(variant, a, groups, st);
}

template <typename F>
int by_k(int k, F f) {
  switch (k) {
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 the library's K-edge push, 1 the one-edge push, 2 that without
// its warp scan, 3 that without its gather, 6 the library's with scalar id
// loads; the others K-edge parts and variants (see parts; at K 4, 8 or 16,
// on aligned ids). full: zero acc before and round into y after, as the
// library's entry point does; else the push kernel alone. Arguments as
// hrm_segsum_push's.
extern "C" int var_push(int variant, int k, int full, const void* src,
                        const void* dst, const void* x, void* y, void* acc,
                        long long n_edges, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  auto push = [&] {
    unsigned blocks = blocks_for(n_edges);
    const int *s = (const int*)src, *d = (const int*)dst;
    const float* xf = (const float*)x;
    double* a = (double*)acc;
    switch (variant) {
      case 1:
        one_edge_push_kernel<true, true><<<blocks, kThreads, 0, st>>>(
            s, d, xf, a, n_edges, (int)n);
        break;
      case 2:
        one_edge_push_kernel<false, true><<<blocks, kThreads, 0, st>>>(
            s, d, xf, a, n_edges, (int)n);
        break;
      case 3:
        one_edge_push_kernel<true, false><<<blocks, kThreads, 0, st>>>(
            s, d, xf, a, n_edges, (int)n);
        break;
      default:
        rc = by_k(k, [&](auto kk) {
          return dense<decltype(kk)::value>(variant, src, dst, x, acc,
                                            n_edges, n, st);
        });
    }
  };
  if (full) {
    int err = push_into(y, acc, n, st, push);
    return rc ? rc : err;
  }
  push();
  return rc ? rc : (int)cudaGetLastError();
}

// variant: 0 the library's K-edge blocked push, 1 the one-edge one, 7 the
// library's general tile path on whole warp tiles; the others as for
// var_push. Arguments as hrm_segsum_push_blocked's.
extern "C" int var_push_blocked(int variant, int k, int full, const void* src,
                                const void* dst, const void* src_block,
                                const void* dst_block, const void* x, void* y,
                                void* acc, long long n_edges,
                                long long tile_edges, long long n_blocks,
                                long long bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  auto push = [&] {
    if (variant == 1) {
      one_edge_push_blocked_kernel<<<blocks_for(n_edges), kThreads, 0,
                                     st>>>(
          (const int*)src, (const int*)dst, (const int*)src_block,
          (const int*)dst_block, (const float*)x, (double*)acc, n_edges,
          tile_edges, (int)n_blocks, (int)bn);
      return;
    }
    rc = by_k(k, [&](auto kk) {
      return blocked<decltype(kk)::value>(variant, src, dst, src_block,
                                          dst_block, x, acc, n_edges,
                                          tile_edges, n_blocks, bn, st);
    });
  };
  if (full) {
    int err = push_into(y, acc, n_blocks * bn, st, push);
    return rc ? rc : err;
  }
  push();
  return rc ? rc : (int)cudaGetLastError();
}
