// Hsiao SEC-DED(72,64) encode and scrub over packed 64-bit words.
//
// Replaces the Pallas TPU kernels src/repro/kernels/secded.py::
// secded_encode_words (_encode_block) and ::secded_scrub_words
// (_scrub_kernel). Same results, bit for bit: 8 check bits per word, bit j
// the parity of (word & mask_j); scrub flips the data bit whose column the
// syndrome matches, rewrites the code on a data or check-bit error, and
// leaves an uncorrectable word and its code untouched.
//
// What bounds it on an H100: memory. Encode reads 8 bytes and writes 1 per
// word; scrub reads 9 and writes 9, plus two 4-byte counts per 256-word row.
// The arithmetic is 8 (encode) or 16 (scrub) masked popcounts per word, far
// below the card's integer rate. So the design is the simplest one that
// streams: one 64-bit word per thread, so a warp's loads are 256 contiguous
// bytes; the masks sit in constant memory, read by every thread alike; the
// syndrome is decoded with one lookup in the 256-entry action table
// (hsiao.SYNDROME_ACTION) instead of the reference's 72-way compare chain,
// taken only when the syndrome is nonzero, so clean words never diverge.
// One 256-thread block per packed row gives the per-row counts from
// __syncthreads_count, with no atomics. Word indices are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWords = 256;

__constant__ unsigned long long kMask[8];    // parity mask of check bit j
__constant__ signed char kAction[256];       // syndrome -> action, see hsiao.py

__device__ __forceinline__ unsigned encode(unsigned long long w) {
  unsigned e = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) e |= (unsigned)(__popcll(w & kMask[j]) & 1) << j;
  return e;
}

__global__ void __launch_bounds__(kRowWords)
secded_encode_kernel(const unsigned long long* __restrict__ words,
                     uint8_t* __restrict__ ecc, long long n) {
  long long i = (long long)blockIdx.x * kRowWords + threadIdx.x;
  if (i < n) ecc[i] = (uint8_t)encode(words[i]);
}

__global__ void __launch_bounds__(kRowWords)
secded_scrub_kernel(const unsigned long long* __restrict__ words,
                    const uint8_t* __restrict__ ecc,
                    unsigned long long* __restrict__ words_out,
                    uint8_t* __restrict__ ecc_out,
                    int* __restrict__ corr, int* __restrict__ unc) {
  long long i = (long long)blockIdx.x * kRowWords + threadIdx.x;
  unsigned long long w = words[i];
  unsigned e = ecc[i];
  unsigned s = encode(w) ^ e;
  int corrected = 0, bad = 0;
  if (s) {
    int a = kAction[s];
    if (a == -2) {
      bad = 1;                     // double error: word and code untouched
    } else {
      corrected = 1;
      if (a < 64) w ^= 1ull << a;  // data bit a; 64..71 is a check bit
      e = encode(w);
    }
  }
  words_out[i] = w;
  ecc_out[i] = (uint8_t)e;
  int nc = __syncthreads_count(corrected);
  int nu = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    corr[blockIdx.x] = nc;
    unc[blockIdx.x] = nu;
  }
}

}  // namespace

extern "C" int hrm_secded_set_tables(const void* masks, const void* action) {
  cudaError_t rc = cudaMemcpyToSymbol(kMask, masks, sizeof(kMask));
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaMemcpyToSymbol(kAction, action, sizeof(kAction));
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// words (rows, 256) u64 -> ecc (rows, 256) u8
extern "C" int hrm_secded_encode(const void* words, void* ecc, long long rows,
                                 void* stream) {
  if (rows > 0)
    secded_encode_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)words, (uint8_t*)ecc, rows * kRowWords);
  return (int)cudaGetLastError();
}

// words, ecc -> words_out, ecc_out (rows, 256); corr, unc (rows,) i32
extern "C" int hrm_secded_scrub(const void* words, const void* ecc,
                                void* words_out, void* ecc_out, void* corr,
                                void* unc, long long rows, void* stream) {
  if (rows > 0)
    secded_scrub_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)words, (const uint8_t*)ecc,
        (unsigned long long*)words_out, (uint8_t*)ecc_out, (int*)corr,
        (int*)unc);
  return (int)cudaGetLastError();
}
