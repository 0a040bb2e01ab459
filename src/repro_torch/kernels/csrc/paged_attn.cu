// Paged attention for one decode step: each slot's one query token against
// that slot's K/V, read in place from the page pools through its row of the
// page table, over positions 0..pos of the slot alone.
//
// Replaces no Pallas site. The JAX reference decodes against a contiguous
// cache (src/repro/models/attention.py::attn_decode, plain jnp), and its
// paged server gathers each slot's pages into that layout first. The port
// did the same on the card: it gathered every slot's every page into a
// contiguous view, inserted the new token by a mask, and ran the einsums
// over the whole view, copying it three times a layer. This kernel reads
// each needed K/V byte once, where it lies, and nothing past a slot's pos.
//
// What bounds it on an H100: bytes. A position costs 2 x dh elements of K
// and V per KV head and 4 x G x dh operations: about one operation a byte
// at G = 1 in bf16, far below the card's ~295. So the design spends
// nothing on tensor cores and everything on keeping loads in flight:
// - Split-K flash-decoding on a static grid (split, KV head, slot), each
//   split a fixed number of pages. The grid depends on the shapes alone,
//   so a CUDA graph replays one launch whatever the positions are; a
//   block whose split starts past its slot's pos returns at once, so the
//   work follows pos, which the kernel reads on the device.
// - A block serves all G query heads of its KV head, one a pass, so each
//   K/V byte is read from device memory once: the further passes over the
//   split (G > 1, grouped-query attention) are served by its L1 and L2.
// - A token's head row (dh contiguous elements) is read by a group of TG
//   lanes, 16 bytes a lane (256 B for dh 128 in bf16: 16 lanes). A warp
//   holds 32 / TG groups, and each group keeps kUnroll tokens' K and V
//   loads in flight before it uses the first.
// - The block loads its split's page ids from the table itself, once.
// - Scores, the running max and sum and the V accumulator are fp32, the
//   scores scaled by 1/sqrt(dh). Each block leaves (max, sum, unnormalised
//   accumulator) per query head in fp32 scratch the wrapper allocates; a
//   second kernel combines a slot's active splits and writes o in the
//   compute dtype. No atomics: the result does not depend on scheduling.
// - Two split kernels (bfloat16 and float32), so the file compiles in
//   seconds, in parallel with the other sources, at an engine's first use.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;          // tokens in flight per token group
constexpr int kMaxSplitPages = 128; // page ids a block stages
// groups x dh never exceeds kThreads x 8 (16 bytes of the narrowest type a
// lane, at most two chunks a lane in fp32), so the block's partial sums fit
constexpr int kRedFloats = kThreads * 8;
constexpr int kCombineThreads = 128;

// bfloat16 is stored as its 16 bits (uint16_t) and converted by hand, which
// keeps cuda_bf16.h, and its compile time, out of this file

// 16 bytes a lane: a float32 row chunk is 4 values, a bfloat16 one 8, so a
// lane holds two float32 chunks (NV = 2) and one bfloat16 chunk, 8 values
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kVec = 4, kNV = 2;
  __device__ static void to_float(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static float from_float(float x) { return x; }
};
template <> struct Elem<uint16_t> {
  static constexpr int kVec = 8, kNV = 1;
  __device__ static void to_float(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // round to nearest even, as __float2bfloat16_rn; NaN stays NaN
  __device__ static uint16_t from_float(float x) {
    unsigned u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40);
    return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
};

__device__ __forceinline__ int tokens_of(const long long* pos, int s,
                                         int smax) {
  long long p = pos[s] + 1;          // positions 0..pos
  return (int)(p < 0 ? 0 : (p > smax ? smax : p));
}

// grid (n_splits, K, S), kThreads threads. Lane `sub` of a token group
// reads chunks sub, sub + tg, ... (up to NV of them) of 16 bytes of a head
// row. One query head a pass: the first pass reads the split's K/V rows
// from device memory, the next G - 1 from L1 and L2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                        const T* __restrict__ pv,
                        const long long* __restrict__ table,
                        const long long* __restrict__ pos,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        float* __restrict__ part_acc, int P, int page_size,
                        int K, int G, int dh, int tg, int split_pages,
                        float scale) {
  constexpr int VEC = Elem<T>::kVec, NV = Elem<T>::kNV;
  const int split = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int n_tok = tokens_of(pos, s, P * page_size);
  const int split_tokens = split_pages * page_size;
  const int a = split * split_tokens;
  if (a >= n_tok) return;
  const int b = min(a + split_tokens, n_tok);
  const int n_splits = gridDim.x;

  const int chunks = dh / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % tg;
  const int per_warp = 32 / tg;
  const int group = warp * per_warp + lane / tg;
  const int n_groups = kWarps * per_warp;

  __shared__ long long page_ids[kMaxSplitPages];
  __shared__ float red_m[kThreads];
  __shared__ float red_l[kThreads];
  __shared__ float red_acc[kRedFloats];
  const int first_page = a / page_size;
  for (int i = threadIdx.x; i <= (b - 1) / page_size - first_page;
       i += kThreads)
    page_ids[i] = table[(long long)s * P + first_page + i];
  __syncthreads();

  const long long row_stride = (long long)K * dh;   // elements a position
  for (int g = 0; g < G; ++g) {
    float qf[NV][VEC], acc[NV][VEC], m = -INFINITY, l = 0.f;
    const T* qrow = q + (((long long)s * K + kh) * G + g) * dh;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = sub + j * tg;
      if (c < chunks) {
        uint4 v = *reinterpret_cast<const uint4*>(qrow + c * VEC);
        Elem<T>::to_float(v, qf[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
    }

    // the loop bound is the same for the whole block, so every lane of a
    // warp reaches each shuffle; a token past b is masked
    for (int t0 = a; t0 < b; t0 += n_groups * kUnroll) {
      uint4 kr[kUnroll][NV], vr[kUnroll][NV];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + group + u * n_groups;
        ok[u] = t < b;
        long long row = 0;
        if (ok[u]) {
          const long long pid = page_ids[t / page_size - first_page];
          row = ((pid * page_size + t % page_size) * row_stride +
                 (long long)kh * dh);
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = sub + j * tg;
          if (ok[u] && c < chunks) {
            kr[u][j] = __ldg(reinterpret_cast<const uint4*>(pk + row +
                                                            c * VEC));
            vr[u][j] = __ldg(reinterpret_cast<const uint4*>(pv + row +
                                                            c * VEC));
          } else {
            kr[u][j] = make_uint4(0, 0, 0, 0);
            vr[u][j] = make_uint4(0, 0, 0, 0);
          }
        }
      }
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[NV][VEC];
#pragma unroll
        for (int j = 0; j < NV; ++j) Elem<T>::to_float(kr[u][j], kf[j]);
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[j][e], kf[j][e], d);
        for (int o = tg >> 1; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[u] = ok[u] ? d * scale : -INFINITY;
      }
      if (ok[0]) {                       // else no token of this group here
        float mx = sc[0];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, sc[u]);
        // a NaN score leaves m as it was and turns p, l and acc into NaN
        const float m_new = fmaxf(m, mx);
        const float alpha = m == m_new ? 1.f : expf(m - m_new);
        m = m_new;
        l *= alpha;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;
          const float p = expf(sc[u] - m_new);
          l += p;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float vf[VEC];
            Elem<T>::to_float(vr[u][j], vf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][e] = fmaf(p, vf[e], acc[j][e]);
          }
        }
      }
    }

    // the block's groups into one (max, sum, accumulator) for head g
    if (sub == 0) {
      red_m[group] = m;
      red_l[group] = l;
    }
    __syncthreads();
    float M = -INFINITY;
    for (int r = 0; r < n_groups; ++r) M = fmaxf(M, red_m[r]);
    const float f = m == -INFINITY ? 0.f : expf(m - M);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = sub + j * tg;
      if (c < chunks)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red_acc[group * dh + c * VEC + e] = acc[j][e] * f;
    }
    __syncthreads();
    const long long out0 =
        (((long long)s * K + kh) * n_splits + split) * G + g;
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < n_groups; ++r) sum += red_acc[r * dh + d];
      part_acc[out0 * dh + d] = sum;
    }
    if (threadIdx.x == 0) {
      float L = 0.f;
      for (int r = 0; r < n_groups; ++r)     // a group without tokens: 0
        L += red_l[r] * (red_m[r] == -INFINITY ? 0.f : expf(red_m[r] - M));
      part_m[out0] = M;
      part_l[out0] = L;
    }
    __syncthreads();                  // the scratch is reused by the next pass
  }
}

// grid (K, S), kCombineThreads threads: o[s, (kh * G + g) * dh + d] over a
// slot's active splits; no split (pos < 0) gives 0 / 0, as a softmax over
// no position does
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_attn_combine_kernel(const long long* __restrict__ pos,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          T* __restrict__ out, int smax, int split_tokens,
                          int n_splits, int G, int dh) {
  const int kh = blockIdx.x, s = blockIdx.y, K = gridDim.x;
  const int n_act = (tokens_of(pos, s, smax) + split_tokens - 1) /
                    split_tokens;
  const long long base = ((long long)s * K + kh) * n_splits * G;
  for (int i = threadIdx.x; i < G * dh; i += kCombineThreads) {
    const int g = i / dh, d = i % dh;
    float M = -INFINITY;
    for (int sp = 0; sp < n_act; ++sp) M = fmaxf(M, part_m[base + sp * G + g]);
    float L = 0.f, o = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const long long at = base + sp * G + g;
      const float f = expf(part_m[at] - M);
      L = fmaf(part_l[at], f, L);
      o = fmaf(part_acc[at * dh + d], f, o);
    }
    out[((long long)s * K + kh) * G * dh + i] = Elem<T>::from_float(o / L);
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* pos, void* part_m, void* part_l, void* part_acc,
           void* out, int S, int P, int page_size, int K, int G, int dh,
           int tg, int split_pages, cudaStream_t st) {
  const int n_splits = (P + split_pages - 1) / split_pages;
  const float scale = (float)(1.0 / sqrt((double)dh));
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
  paged_attn_split_kernel<T><<<dim3(n_splits, K, S), kThreads, 0, st>>>(
      (const T*)q, (const T*)pk, (const T*)pv, (const long long*)table,
      (const long long*)pos, pm, pl, pa, P, page_size, K, G, dh, tg,
      split_pages, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_attn_combine_kernel<T><<<dim3(K, S), kCombineThreads, 0, st>>>(
      (const long long*)pos, pm, pl, pa, (T*)out, P * page_size,
      split_pages * page_size, n_splits, G, dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q (S, K, G, dh), pk and pv (n_pages, page_size, K, dh), all of one dtype
// (0 float32, 1 bfloat16); table (S, P) i64 page ids; pos (S,) i64 -> out
// (S, K * G * dh) of that dtype. part_m, part_l (S, K, n_splits, G) and
// part_acc (S, K, n_splits, G, dh) f32 scratch, n_splits = ceil(P /
// split_pages). A head row is whole 16-byte chunks, at most 256 elements;
// split_pages at most 128.
extern "C" int hrm_paged_attn_decode(const void* q, const void* pk,
                                     const void* pv, const void* table,
                                     const void* pos, void* part_m,
                                     void* part_l, void* part_acc, void* out,
                                     long long S, long long P,
                                     long long page_size, long long K,
                                     long long G, long long dh,
                                     long long split_pages, long long dtype,
                                     void* stream) {
  const int vec = dtype == 0 ? 4 : 8, chunks = (int)(dh / vec);
  if (dtype < 0 || dtype > 1 || dh <= 0 || dh % vec || dh > 256 || G < 1 ||
      split_pages < 1 || split_pages > kMaxSplitPages || K < 1 ||
      K > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  int tg = 1;                         // lanes a token: chunks, to a power of 2
  while (tg < chunks && tg < 32) tg <<= 1;
  cudaStream_t st = (cudaStream_t)stream;
#define HRM_ARGS q, pk, pv, table, pos, part_m, part_l, part_acc, out, \
    (int)S, (int)P, (int)page_size, (int)K, (int)G, (int)dh, tg,        \
    (int)split_pages, st
  if (dtype == 0) return launch<float>(HRM_ARGS);
  return launch<uint16_t>(HRM_ARGS);
#undef HRM_ARGS
}
