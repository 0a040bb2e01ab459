// Shortened-BCH encode and scrub over packed 64-bit words (the DEC-TED
// tier, and any code of kernels/bch.py::make_code with r <= 16).
//
// Replaces the Pallas TPU kernels src/repro/kernels/bch.py::
// bch_encode_words (_encode_kernel) and ::bch_scrub_words (_scrub_kernel),
// which kernels/dected.py calls with DECTED_CODE. Same results, bit for bit:
// check bit j is the parity of (word & mask_j); scrub computes the syndrome
// s = fresh ^ stored and
//   * s matching one of the n single-error columns is a single error (a data
//     column flips its bit, a check column flips nothing);
//   * for t = 2, an even-weight s (with the parity factor; without it, an s
//     matching no column) runs the multiplied-through Chien search
//     S1 a^{2p} ^ S1^2 a^p ^ (S3 ^ S1^3) == 0 over the n codeword degrees
//     p in [0, n). Exactly two roots with S1 != 0 correct both bits; roots at
//     check degrees (p < r) count but flip no data bit;
//   * anything else is uncorrectable: word and code are left untouched.
// ecc' is the stored code for an uncorrectable word, else the code of the
// corrected word.
//
// The code is a launch argument (BchCode, 320 bytes, __grid_constant__): the
// DEC-TED code, the BCH(72,64) t=1 instance and any other make_code result
// run back to back on one stream with no table in global or constant memory
// to swap.
//
// What bounds it on an H100. Bytes: encode reads 8 B and writes 2 B per
// word; scrub reads 10 B and writes 10 B, plus two 4-byte counts per row.
// Operations: DEC-TED encode is r = 15 parities per word, each one 32-bit
// popcount of the masked word with its halves XOR-folded (parity64), and the
// scrub's syndrome as many; at 16 popcounts per clock per SM the popcount
// rate binds encode before its 10 bytes do (PERF.md gives both bounds). The
// decode beyond the syndrome runs only for nonzero syndromes, so warps stay
// converged on clean data: the column match is k + 1 compares, and the Chien
// search (n steps of three GF(2^m) multiplications by x) runs only for the
// even-weight syndromes of double errors. One 64-bit word per thread, one
// 256-thread block per row: the per-row counts come from
// __syncthreads_count, with no atomics.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRowWords = 256;
constexpr int kMaxR = 16;          // check bits a uint16 sidecar holds
constexpr int kMaxK = 64;

// Field for field the layout of kernels/bch.py::_CodeArg.
struct BchCode {
  int32_t m, t, r, n, k, parity, poly, pad;
  unsigned long long mask[kMaxR];  // encode mask of check bit j (0 past r)
  uint16_t data_cols[kMaxK];       // syndrome column of data bit i
  uint8_t alpha1[kMaxR];           // alpha^j: S1 = s(alpha)
  uint8_t alpha3[kMaxR];           // alpha^{3j}: S3 = s(alpha^3)
};
static_assert(sizeof(BchCode) == 320, "layout shared with bch.py");

// Parity of a 64-bit value: its halves XOR-folded, then one 32-bit
// popcount (__popcll would take two).
__device__ __forceinline__ unsigned parity64(unsigned long long x) {
  return __popc((unsigned)x ^ (unsigned)(x >> 32)) & 1;
}

__device__ __forceinline__ unsigned encode(const BchCode& c,
                                           unsigned long long w) {
  unsigned e = 0;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < c.r) e |= parity64(w & c.mask[j]) << j;
  return e;
}

__device__ __forceinline__ unsigned gf_mulx(const BchCode& c, unsigned v) {
  unsigned full = (1u << c.m) - 1;
  unsigned top = (v >> (c.m - 1)) & 1;
  return ((v << 1) & full) ^ (top ? (unsigned)c.poly & full : 0u);
}

__device__ unsigned gf_mul(const BchCode& c, unsigned a, unsigned b) {
  unsigned res = 0;
  for (int i = 0; i < c.m; ++i) {
    if (b & 1) res ^= a;
    b >>= 1;
    a = gf_mulx(c, a);
  }
  return res;
}

// Two-error location: true when S1 != 0 and the locator has exactly two
// roots among the n codeword degrees; *flip gets the data bits among them.
__device__ bool chien_double(const BchCode& c, unsigned s,
                             unsigned long long* flip) {
  unsigned s1 = 0, s3 = 0;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j)
    if (j < c.r && ((s >> j) & 1)) {
      s1 ^= c.alpha1[j];
      s3 ^= c.alpha3[j];
    }
  unsigned q = gf_mul(c, s1, s1);              // S1^2 alpha^p
  unsigned t = s3 ^ gf_mul(c, q, s1);          // S3 + S1^3
  unsigned w = s1;                             // S1 alpha^{2p}
  int nroots = 0;
  unsigned long long f = 0;
  for (int p = 0; p < c.n; ++p) {
    if ((w ^ q ^ t) == 0) {
      ++nroots;
      if (p >= c.r) f |= 1ull << (p - c.r);
    }
    w = gf_mulx(c, gf_mulx(c, w));
    q = gf_mulx(c, q);
  }
  *flip = f;
  return s1 != 0 && nroots == 2;
}

__global__ void __launch_bounds__(kRowWords)
bch_encode_kernel(const __grid_constant__ BchCode c,
                  const unsigned long long* __restrict__ words,
                  uint16_t* __restrict__ ecc) {
  long long i = (long long)blockIdx.x * kRowWords + threadIdx.x;
  ecc[i] = (uint16_t)encode(c, words[i]);
}

__global__ void __launch_bounds__(kRowWords)
bch_scrub_kernel(const __grid_constant__ BchCode c,
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
    unsigned long long flip = 0;
    bool single = __popc(s) == 1 && (s >> c.r) == 0;    // a check column
    for (int b = 0; b < c.k; ++b)
      if (s == c.data_cols[b]) {
        single = true;
        flip = 1ull << b;
      }
    bool dbl = false;
    if (c.t == 2 && (c.parity ? (__popc(s) & 1) == 0 : !single)) {
      unsigned long long flip2;
      dbl = chien_double(c, s, &flip2);
      if (dbl) flip |= flip2;
    }
    corrected = single || dbl;
    bad = !corrected;
    if (flip) {                 // never set for an uncorrectable word
      w ^= flip;
      e = encode(c, w);
    } else if (corrected) {
      e = fresh;                // a check-bit error: rewrite the code
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

// code: BchCode on the host, copied into the launch; words (rows, 256) u64
// -> ecc (rows, 256) u16
extern "C" int hrm_bch_encode(const void* code, const void* words, void* ecc,
                              long long rows, void* stream) {
  BchCode c;
  memcpy(&c, code, sizeof c);
  if (rows > 0)
    bch_encode_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        c, (const unsigned long long*)words, (uint16_t*)ecc);
  return (int)cudaGetLastError();
}

// words, ecc -> words_out, ecc_out (rows, 256); corr, unc (rows,) i32
extern "C" int hrm_bch_scrub(const void* code, const void* words,
                             const void* ecc, void* words_out, void* ecc_out,
                             void* corr, void* unc, long long rows,
                             void* stream) {
  BchCode c;
  memcpy(&c, code, sizeof c);
  if (rows > 0)
    bch_scrub_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        c, (const unsigned long long*)words, (const uint16_t*)ecc,
        (unsigned long long*)words_out, (uint16_t*)ecc_out, (int*)corr,
        (int*)unc);
  return (int)cudaGetLastError();
}
