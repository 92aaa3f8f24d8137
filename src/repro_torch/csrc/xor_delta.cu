// XOR delta (kernels K10 and K5) for Hopper, sm_90a: the elementwise XOR of
// two checkpoints' element bits and, for K10, the count of nonzero bytes of
// the delta (the changed-byte statistic of the paper's Fig. 8a).
//
// Replaces the TPU kernels xor_delta_2d (K10) and xor_elems_2d (K5) in
// src/repro/kernels/xor_delta.py.  The TPU kernel carries the count in its
// output block across a sequential grid.  Here blocks run in no order: each
// thread counts its own bytes, a warp sums its threads with
// __reduce_add_sync, one warp sums the block's warps through shared memory,
// and the block adds its sum once, with one global atomic, into an int32 the
// caller zeroed.  The count is an integer, so the order of the atomics does
// not change it.  XOR works byte by byte, so one kernel serves u16 and u32
// operands: it sees n * itemsize bytes.
//
// What bounds it on the H100: bytes.  Each byte is read twice and written
// once, with about one integer operation per byte (XOR, and for K10 a
// per-byte compare and a population count per 32-bit word).  At the main
// path's sizes (4.7-9.4 MB an operand) the pass lasts a few microseconds,
// and how the reads reach device memory sets the time: the writes land in
// L2.  Each thread moves one 16-byte vector of each operand per step of a
// grid-stride loop (all three pointers 16-byte aligned, the caller checks),
// so at any moment the grid reads one contiguous front of each operand.
// The grid is sized so that each thread takes about VECTORS_PER_THREAD
// steps, rounded up to whole waves over the SMs: measured on the card
// (kernels/xor_launch_sweep.py), that beats both one vector per thread over
// many blocks and several loads in flight per thread, which spread each
// warp's reads over the operands.  The ragged end, or a misaligned
// operand, goes byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int VECTORS_PER_THREAD = 8;
constexpr int MAX_BLOCKS_PER_SM = 16;       // 2,048 threads: a full SM

__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;     // __vcmpne4: 0xFF per byte != 0
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
xor_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           uint8_t* __restrict__ d, int* __restrict__ count, int64_t nbytes,
           int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int local = 0;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = nbytes / 16;
    const uint4* va = reinterpret_cast<const uint4*>(a);
    const uint4* vb = reinterpret_cast<const uint4*>(b);
    uint4* vd = reinterpret_cast<uint4*>(d);
    for (int64_t k = tid; k < nv; k += stride) {
      const uint4 p = va[k], q = vb[k];
      const uint4 r = make_uint4(p.x ^ q.x, p.y ^ q.y, p.z ^ q.z, p.w ^ q.w);
      vd[k] = r;
      if constexpr (COUNT) {
        local += nonzero_bytes(r.x) + nonzero_bytes(r.y) + nonzero_bytes(r.z) +
                 nonzero_bytes(r.w);
      }
    }
    done = nv * 16;
  }
  for (int64_t i = done + tid; i < nbytes; i += stride) {
    const uint8_t r = a[i] ^ b[i];
    d[i] = r;
    if constexpr (COUNT) local += r != 0;
  }
  if constexpr (COUNT) {
    __shared__ int s_warp[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wsum = __reduce_add_sync(0xffffffffu, local);
    if (lane == 0) s_warp[warp] = wsum;
    __syncthreads();
    if (warp == 0) {
      const int bsum = __reduce_add_sync(0xffffffffu, lane < WARPS ? s_warp[lane] : 0);
      if (lane == 0 && bsum) atomicAdd(count, bsum);
    }
  }
}

}  // namespace

extern "C" {

// a, b: nbytes bytes each (u16 or u32 elements); d: nbytes bytes; count:
// one int32, zeroed, or null for the plain XOR (K5).  vec: all three
// pointers are 16-byte aligned.
int xor_delta_launch(const void* a, const void* b, void* d, void* count,
                     long long nbytes, int vec, void* stream) {
  if (nbytes > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    // about VECTORS_PER_THREAD vectors (or bytes, unaligned) a thread,
    // rounded up to whole waves over the SMs and capped at one full wave
    const int64_t per_block = static_cast<int64_t>(THREADS) * VECTORS_PER_THREAD * (vec ? 16 : 1);
    const int64_t want = (nbytes + per_block - 1) / per_block;
    int64_t blocks = (want + sms - 1) / sms * sms;
    if (blocks > static_cast<int64_t>(sms) * MAX_BLOCKS_PER_SM) {
      blocks = static_cast<int64_t>(sms) * MAX_BLOCKS_PER_SM;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* pa = static_cast<const uint8_t*>(a);
    const auto* pb = static_cast<const uint8_t*>(b);
    auto* pd = static_cast<uint8_t*>(d);
    if (count) {
      xor_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
          pa, pb, pd, static_cast<int*>(count), nbytes, vec);
    } else {
      xor_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
          pa, pb, pd, nullptr, nbytes, vec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* xor_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
