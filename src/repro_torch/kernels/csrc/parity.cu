// Word parity encode and check over packed 64-bit words.
//
// Replaces the Pallas TPU kernels src/repro/kernels/parity.py::
// parity_encode_words (_encode_kernel) and ::parity_check_words
// (_check_kernel). One parity bit per word, packed 8 words per byte (bit k
// of byte b is word 8b+k of the row); check writes the packed bits of
// fresh-XOR-stored parity and the per-row count of mismatching words.
//
// What bounds it on an H100: memory. Encode reads 8 bytes per word and
// writes 1/8 byte; check also reads the 1/8 stored byte and writes 1/8
// error byte and a 4-byte count per 256-word row. One popcount per word is
// nothing beside that. So one thread loads one word (a warp loads 256
// contiguous bytes), __ballot_sync gathers a warp's 32 parity bits into the
// 4 bytes that warp owns, and its first 4 lanes store them: no shared memory
// and no second pass. One 256-thread block per row gives the count from
// __syncthreads_count, with no atomics. Row indices are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWords = 256;
constexpr int kRowBytes = kRowWords / 8;

__device__ __forceinline__ void store_ballot(uint8_t* row_bytes,
                                             unsigned ballot) {
  int lane = threadIdx.x & 31;
  if (lane < 4)
    row_bytes[(threadIdx.x >> 5) * 4 + lane] = (uint8_t)(ballot >> (8 * lane));
}

__global__ void __launch_bounds__(kRowWords)
parity_encode_kernel(const unsigned long long* __restrict__ words,
                     uint8_t* __restrict__ par) {
  long long row = blockIdx.x;
  unsigned bit = __popcll(words[row * kRowWords + threadIdx.x]) & 1;
  store_ballot(par + row * kRowBytes, __ballot_sync(0xffffffffu, bit));
}

__global__ void __launch_bounds__(kRowWords)
parity_check_kernel(const unsigned long long* __restrict__ words,
                    const uint8_t* __restrict__ par,
                    uint8_t* __restrict__ err, int* __restrict__ cnt) {
  long long row = blockIdx.x;
  int t = threadIdx.x;
  unsigned fresh = __popcll(words[row * kRowWords + t]) & 1;
  unsigned stored = (par[row * kRowBytes + (t >> 3)] >> (t & 7)) & 1;
  unsigned bad = fresh ^ stored;
  store_ballot(err + row * kRowBytes, __ballot_sync(0xffffffffu, bad));
  int n = __syncthreads_count(bad);
  if (t == 0) cnt[row] = n;
}

}  // namespace

// words (rows, 256) u64 -> par (rows, 32) u8
extern "C" int hrm_parity_encode(const void* words, void* par, long long rows,
                                 void* stream) {
  if (rows > 0)
    parity_encode_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)words, (uint8_t*)par);
  return (int)cudaGetLastError();
}

// words (rows, 256) u64, par (rows, 32) u8 -> err (rows, 32) u8, cnt (rows,) i32
extern "C" int hrm_parity_check(const void* words, const void* par, void* err,
                                void* cnt, long long rows, void* stream) {
  if (rows > 0)
    parity_check_kernel<<<(unsigned)rows, kRowWords, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)words, (const uint8_t*)par, (uint8_t*)err,
        (int*)cnt);
  return (int)cudaGetLastError();
}
