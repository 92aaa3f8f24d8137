// Byte histograms (kernels K9 and K6) for Hopper, sm_90a: the 256-bin count
// of every chunk of a byte array.  K9 is one chunk that spans all n bytes;
// K6 cuts the array into chunks of chunk_elems bytes (the last one may be
// shorter).
//
// Replaces the TPU kernels histogram_2d (K9) and chunk_histogram_2d (K6) in
// src/repro/kernels/histogram.py.  The TPU has no atomics, so those compare
// every byte against all 256 bins and reduce.
//
// What bounds it on the H100 (kernels/hist_launch_sweep.py): latency, not
// bytes.  At the ops path's 2,359,296-byte exponent plane a kernel on this
// grid that only loads the bytes takes 2.7 us of device time, 3.8x the
// bytes' 0.705 us at 3.35 TB/s: one wave's trip to device memory and its
// ramp.  Counting adds about 0.45 us: each shared atomicAdd(&h[b], 1)
// compiles to ATOMS.POPC.INC, which adds the lanes of a warp that share a
// bin in one operation, so a plane whose bytes sit in a few bins costs
// little; 4 instructions a byte.  Counters in registers for a window of
// bins, with atomics only outside it (8 bins in 4-bit fields; 16 bins in
// 8- or 16-bit fields of 64-bit registers), and a histogram per warp were
// slower on every plane (the sweep keeps them).
//
// Grid.  One wave: at most the card's SMs times the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Every chunk is cut into
// the same number of parts, each a contiguous range of at least MIN_STEPS
// 16-byte vectors a thread, so that the parts about fill the wave; a
// block walks parts (chunk c, part p) a grid apart.  Its threads
// keep VECTORS loads in flight each; a part's bytes before its first
// 16-byte boundary and after its last whole vector go one by one.  Then the
// block adds each nonzero bin of its histogram, once, with a global atomic,
// into the chunk's row of the output, which the caller zeroes.
//
// The zeroing stays a launch of its own.  Zeroing inside the launch needs
// an order between blocks: behind a grid-wide barrier (a cooperative
// launch) it saved 0.5 us of events time a call but cost 1.4 us of device
// time, and 2.4 us on a uniform plane, where every block's global adds
// leave the barrier at once; a last-block ticket cost 2 us.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECTORS = 4;                       // 16-byte loads in flight a thread
constexpr int MIN_STEPS = 2;                     // vectors a thread a part, at least
static_assert(THREADS == 256, "a thread a bin");

struct Plan {
  int64_t n, chunk_elems, part_len, parts, units;
};

__device__ __forceinline__ void count_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFFu], 1);
  atomicAdd(&h[(w >> 8) & 0xFFu], 1);
  atomicAdd(&h[(w >> 16) & 0xFFu], 1);
  atomicAdd(&h[w >> 24], 1);
}

// The block counts x[begin, end) into h: 16-byte vectors, VECTORS in
// flight a thread; the bytes around them one by one.
__device__ __forceinline__ void count_part(const uint8_t* __restrict__ x, int64_t begin,
                                           int64_t end, int* h) {
  const int t = threadIdx.x;
  int64_t head = static_cast<int64_t>((16u - (reinterpret_cast<uintptr_t>(x + begin) & 15u)) & 15u);
  if (head > end - begin) head = end - begin;
  const int64_t body = begin + head;
  const int64_t nv = (end - body) / 16;
  const uint4* v = reinterpret_cast<const uint4*>(x + body);
  for (int64_t bt = 0; bt * VECTORS * THREADS < nv; ++bt) {
    uint4 q[VECTORS];
#pragma unroll
    for (int j = 0; j < VECTORS; ++j) {
      const int64_t k = (bt * VECTORS + j) * THREADS + t;
      q[j] = k < nv ? v[k] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < VECTORS; ++j) {
      if ((bt * VECTORS + j) * THREADS + t < nv) {
        count_word(h, q[j].x);
        count_word(h, q[j].y);
        count_word(h, q[j].z);
        count_word(h, q[j].w);
      }
    }
  }
  for (int64_t i = begin + t; i < body; i += THREADS) atomicAdd(&h[x[i]], 1);
  for (int64_t i = body + nv * 16 + t; i < end; i += THREADS) atomicAdd(&h[x[i]], 1);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const uint8_t* __restrict__ x, int* __restrict__ out, Plan p) {
  __shared__ int h[256];
  const int t = threadIdx.x;
  h[t] = 0;
  __syncthreads();
  for (int64_t u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int64_t c = u / p.parts;
    const int64_t chunk_end = (c + 1) * p.chunk_elems < p.n ? (c + 1) * p.chunk_elems : p.n;
    int64_t begin = c * p.chunk_elems + (u % p.parts) * p.part_len;
    if (begin > chunk_end) begin = chunk_end;    // an empty part of a short last chunk
    const int64_t end = begin + p.part_len < chunk_end ? begin + p.part_len : chunk_end;
    count_part(x, begin, end, h);
    __syncthreads();
    const int s = h[t];
    if (s) {
      atomicAdd(out + c * 256 + t, s);
      h[t] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x: u8[n]; out: int32[ceil(n / chunk_elems)][256], zeroed by the caller.
int histogram_launch(const void* x, void* out, long long n, long long chunk_elems, void* stream) {
  if (n > 0) {
    if (chunk_elems <= 0) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel, THREADS, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t wave = static_cast<int64_t>(sms) * per_sm;
    Plan p{};
    p.n = n;
    p.chunk_elems = chunk_elems;
    const int64_t rows = (n + chunk_elems - 1) / chunk_elems;
    const int64_t span = chunk_elems < n ? chunk_elems : n;     // the longest chunk
    // parts a chunk: about one wave in all, each of at least MIN_STEPS
    // vectors a thread
    const int64_t min_part = static_cast<int64_t>(16) * THREADS * MIN_STEPS;
    int64_t parts = wave / rows;
    const int64_t most = (span + min_part - 1) / min_part;
    if (parts > most) parts = most;
    if (parts < 1) parts = 1;
    p.part_len = ((span + parts - 1) / parts + 15) / 16 * 16;
    p.parts = (span + p.part_len - 1) / p.part_len;
    p.units = rows * p.parts;
    const int64_t grid = p.units < wave ? p.units : wave;
    hist_kernel<<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<int*>(out), p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
