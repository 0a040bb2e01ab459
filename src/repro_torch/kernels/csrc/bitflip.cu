// Controlled bit-flip injection into packed 64-bit words, in place.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitflip.py::bitflip_words
// (_flip_kernel). Strike e flips bit bit_idx[e] of flat word word_idx[e].
// A strike with word_idx < 0 is an inactive slot; one whose word lies past
// the buffer or whose bit lies outside [0, 64) drops; two strikes on the
// same bit cancel. These are the reference's results.
//
// What bounds it on an H100: for the E strikes of an injection plan, the
// 16 bytes of indices and one 8-byte read-modify-write per strike, so in
// practice the launch itself. The reference compares every word of the
// buffer with every strike (O(words * E)), which suits the TPU's vector
// unit; here it would read the whole buffer for a few flips. So this is a
// scatter: one thread per strike, atomicXor on its 64-bit word. XOR
// commutes, so duplicate strikes cancel in any order, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bitflip_kernel(unsigned long long* __restrict__ words,
                               long long n_words,
                               const long long* __restrict__ word_idx,
                               const long long* __restrict__ bit_idx,
                               long long n_strikes) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_strikes) return;
  long long w = word_idx[e], b = bit_idx[e];
  if (w < 0 || w >= n_words || b < 0 || b >= 64) return;
  atomicXor(words + w, 1ull << b);
}

}  // namespace

// words (n_words,) u64, flipped in place; word_idx, bit_idx (n_strikes,) i64
extern "C" int hrm_bitflip(void* words, long long n_words, const void* word_idx,
                           const void* bit_idx, long long n_strikes,
                           void* stream) {
  if (n_strikes > 0) {
    const int threads = 256;
    long long blocks = (n_strikes + threads - 1) / threads;
    bitflip_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)words, n_words, (const long long*)word_idx,
        (const long long*)bit_idx, n_strikes);
  }
  return (int)cudaGetLastError();
}
