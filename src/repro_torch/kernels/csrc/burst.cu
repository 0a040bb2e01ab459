// SEC-DAEC adjacent-burst encode and scrub over packed 64-bit words (the
// BURST tier).
//
// Replaces the Pallas TPU kernels src/repro/kernels/burst.py::
// burst_encode_words (_encode_kernel) and ::burst_scrub_words
// (_scrub_kernel). Same results, bit for bit: 14 check bits per word, two
// interleaved copies of the (39,32) BCH t=1 sub-code, A over the even data
// bits (check bits 0-6) and B over the odd ones (7-13). Scrub decodes each
// 7-bit sub-syndrome on its own: zero is clean, one of the 32 sub-code data
// columns flips data bit 2i (A) or 2i+1 (B), a unit vector is a check-bit
// error, anything else is uncorrectable. If either sub-code is
// uncorrectable the word and its code are left untouched (burst.py's keep
// mask); otherwise ecc' is the code of the corrected word.
//
// The 14 spread masks and the 32 sub-code columns are a launch argument
// (BurstCode, 144 bytes, __grid_constant__), like the BCH kernels' code.
//
// What bounds it on an H100. Bytes: encode reads 8 B and writes 2 B per
// word; scrub reads 10 B and writes 10 B, plus two 4-byte counts per row.
// Operations: 14 parities per word for encode, each one 32-bit popcount of
// the XOR-folded masked word (parity64), as many for the scrub's syndrome;
// as for DEC-TED the popcount rate binds encode just before its bytes do
// (PERF.md gives both bounds). The column match (32 compares per
// sub-code) runs only for nonzero syndromes, so clean warps stay converged.
// One 64-bit word per thread, one 256-thread block per row, per-row counts
// from __syncthreads_count.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRowWords = 256;
constexpr int kSub = 7;            // check bits per sub-code
constexpr int kCheck = 2 * kSub;

// Field for field the layout of kernels/burst.py::_CodeArg.
struct BurstCode {
  unsigned long long mask[kCheck];  // encode mask of check bit j
  uint8_t sub_cols[32];             // sub-code syndrome column of sub-bit i
};
static_assert(sizeof(BurstCode) == 144, "layout shared with burst.py");

// Parity of a 64-bit value: its halves XOR-folded, then one 32-bit
// popcount (__popcll would take two).
__device__ __forceinline__ unsigned parity64(unsigned long long x) {
  return __popc((unsigned)x ^ (unsigned)(x >> 32)) & 1;
}

__device__ __forceinline__ unsigned encode(const BurstCode& c,
                                           unsigned long long w) {
  unsigned e = 0;
#pragma unroll
  for (int j = 0; j < kCheck; ++j)
    e |= parity64(w & c.mask[j]) << j;
  return e;
}

// t=1 decode of one sub-syndrome; data flips land on bits 2i + offset.
// Returns true when s is nonzero and matches no column (uncorrectable).
__device__ __forceinline__ bool decode_sub(const BurstCode& c, unsigned s,
                                           int offset,
                                           unsigned long long* flip) {
  if (s == 0) return false;
  bool matched = __popc(s) == 1;    // a check column
  for (int i = 0; i < 32; ++i)
    if (s == c.sub_cols[i]) {
      matched = true;
      *flip |= 1ull << (2 * i + offset);
    }
  return !matched;
}

__global__ void __launch_bounds__(kRowWords)
burst_encode_kernel(const __grid_constant__ BurstCode c,
                    const unsigned long long* __restrict__ words,
                    uint16_t* __restrict__ ecc) {
  long long i = (long long)blockIdx.x * kRowWords + threadIdx.x;
  ecc[i] = (uint16_t)encode(c, words[i]);
}

__global__ void __launch_bounds__(kRowWords)
burst_scrub_kernel(const __grid_constant__ BurstCode c,
                   const unsigned long long* __restrict__ words,
                   const uint16_t* __restrict__ ecc,
                   unsigned long long* __restrict__ words_out,
                   uint16_t* __restrict__ ecc_out,
                   int* __restrict__ corr, int* __restrict__ unc) {
  long long i = (long long)blockIdx.x * kRowWords + threadIdx.x;
  unsigned long long w = words[i];
  unsigned e = ecc[i];
  unsigned fresh = encode(c, w);
  unsigned s = fresh ^ e;
  int corrected = 0, bad = 0;
  if (s) {
    unsigned sa = s & ((1u << kSub) - 1);
    unsigned sb = (s >> kSub) & ((1u << kSub) - 1);
    unsigned long long flip = 0;
    bool unc_a = decode_sub(c, sa, 0, &flip);
    bool unc_b = decode_sub(c, sb, 1, &flip);
    bad = unc_a || unc_b;
    if (!bad) {
      // bits 14-15 of a stored code are no check bits: a syndrome with
      // only those set is no correction, but the code is rewritten
      corrected = (sa | sb) != 0;
      w ^= flip;
      e = flip ? encode(c, w) : fresh;
    }
  }
  words_out[i] = w;
  ecc_out[i] = (uint16_t)e;
  int nc = __syncthreads_count(corrected);
  int nu = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    corr[blockIdx.x] = nc;
    unc[blockIdx.x] = nu;
  }
}

}  // namespace

// code: BurstCode on the host, copied into the launch; words (rows, 256)
// u64 -> ecc (rows, 256) u16
extern "C" int hrm_burst_encode(const void* code, const void* words,
                                void* ecc, long long rows, void* stream) {
  BurstCode c;
  memcpy(&c, code, sizeof c);
  if (rows > 0)
    burst_encode_kernel<<<(unsigned)rows, kRowWords, 0,
                          (cudaStream_t)stream>>>(
        c, (const unsigned long long*)words, (uint16_t*)ecc);
  return (int)cudaGetLastError();
}

// words, ecc -> words_out, ecc_out (rows, 256); corr, unc (rows,) i32
extern "C" int hrm_burst_scrub(const void* code, const void* words,
                               const void* ecc, void* words_out,
                               void* ecc_out, void* corr, void* unc,
                               long long rows, void* stream) {
  BurstCode c;
  memcpy(&c, code, sizeof c);
  if (rows > 0)
    burst_scrub_kernel<<<(unsigned)rows, kRowWords, 0,
                         (cudaStream_t)stream>>>(
        c, (const unsigned long long*)words, (const uint16_t*)ecc,
        (unsigned long long*)words_out, (uint16_t*)ecc_out, (int*)corr,
        (int*)unc);
  return (int)cudaGetLastError();
}
