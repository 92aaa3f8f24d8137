// Byte histograms (kernels K9 and K6) for Hopper, sm_90a: the 256-bin count
// of every chunk of a byte array.  K9 is one chunk that spans all n bytes;
// K6 cuts the array into chunks of chunk_elems bytes (the last one may be
// shorter).
//
// Replaces the TPU kernels histogram_2d (K9) and chunk_histogram_2d (K6) in
// src/repro/kernels/histogram.py.  The TPU has no atomics, so those compare
// every byte against all 256 bins and reduce.  Here each block counts one
// tile of TILE bytes that lies inside one chunk into shared memory with
// shared atomic adds, one private 256-bin copy per warp so that the warps
// of a block do not contend with each other, then adds the warps' sum of
// each nonzero bin once, with a global atomic, into the chunk's row of the
// int32 output (zeroed by the caller).  The grid is flat: block i is tile
// i % tiles_per_chunk of chunk i / tiles_per_chunk, so any chunk length
// works and a chunk's last tile is simply shorter.  This is the scheme of
// K3's histogram stage (csrc/plane.cu).
//
// What bounds it on the H100: bytes, one read of each byte, against about
// four integer operations per byte (byte extract, address, the shared
// atomic, the loop) on the INT32 lanes.  A weight's exponent plane holds
// only a handful of distinct values, so the shared atomics of a warp
// collide on a few bins; they serialise inside the warp's copy and cost
// time, not correctness.  Each thread reads 16 bytes at a time from the
// tile's first 16-byte boundary on; the few bytes before it and after the
// last whole 16 go one by one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int64_t TILE = 16384;

__device__ __forceinline__ void count_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFFu], 1);
  atomicAdd(&h[(w >> 8) & 0xFFu], 1);
  atomicAdd(&h[(w >> 16) & 0xFFu], 1);
  atomicAdd(&h[w >> 24], 1);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint8_t* __restrict__ x, int* __restrict__ hist, int64_t n,
            int64_t chunk_elems, int64_t tiles_per_chunk) {
  const int64_t c = blockIdx.x / tiles_per_chunk;
  const int64_t begin = c * chunk_elems + (blockIdx.x % tiles_per_chunk) * TILE;
  int64_t end = (c + 1) * chunk_elems < n ? (c + 1) * chunk_elems : n;
  if (begin + TILE < end) end = begin + TILE;
  if (begin >= end) return;               // past the end of a short last chunk

  __shared__ int h[WARPS][256];
  for (int k = threadIdx.x; k < WARPS * 256; k += THREADS) (&h[0][0])[k] = 0;
  __syncthreads();
  int* mine = h[threadIdx.x >> 5];

  // Bytes before the tile's first 16-byte boundary, then whole 16-byte
  // words, then the rest.
  int64_t head = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(x + begin) & 15)) & 15);
  if (begin + head > end) head = end - begin;
  const int64_t body = begin + head;
  const int64_t nv = (end - body) / 16;
  for (int64_t i = begin + threadIdx.x; i < body; i += THREADS) atomicAdd(&mine[x[i]], 1);
  const uint4* v = reinterpret_cast<const uint4*>(x + body);
  for (int64_t k = threadIdx.x; k < nv; k += THREADS) {
    const uint4 q = v[k];
    count_word(mine, q.x);
    count_word(mine, q.y);
    count_word(mine, q.z);
    count_word(mine, q.w);
  }
  for (int64_t i = body + nv * 16 + threadIdx.x; i < end; i += THREADS) atomicAdd(&mine[x[i]], 1);
  __syncthreads();

  int* dst = hist + c * 256;
  for (int bin = threadIdx.x; bin < 256; bin += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += h[w][bin];
    if (s) atomicAdd(&dst[bin], s);
  }
}

}  // namespace

extern "C" {

// x: u8[n]; hist: int32[ceil(n / chunk_elems)][256], zeroed.
int histogram_launch(const void* x, void* hist, long long n, long long chunk_elems,
                     void* stream) {
  if (n > 0) {
    if (chunk_elems <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_chunks = (n + chunk_elems - 1) / chunk_elems;
    const int64_t span = chunk_elems < n ? chunk_elems : n;     // longest chunk
    const int64_t tiles_per_chunk = (span + TILE - 1) / TILE;
    const int64_t blocks = n_chunks * tiles_per_chunk;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    hist_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<int*>(hist), n, chunk_elems,
        tiles_per_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
