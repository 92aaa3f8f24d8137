// Plane consumer (kernel K2) for Hopper, sm_90a: un-byte-group, inverse
// rotate-left-1 and the optional XOR with a base, in one pass.
//
// Replaces the TPU kernel plane_consumer in
// src/repro/kernels/fused_unplane.py (bodies _bf16_unplane_kernel,
// _bf16_unplane_delta_kernel, _fp32_unplane_kernel,
// _fp32_unplane_delta_kernel).  Plane 0 is the most significant byte
// (the exponent after the encoder's rotate-left-1); the joined value is
// rotated right by one bit and, for a delta stream, XORed with base.
//
// What bounds it on the H100: bytes.  Each element reads itemsize plane
// bytes (plus itemsize base bytes) and writes itemsize bytes, with a
// handful of integer operations, far below the ~295 operations per byte
// where the ALUs would be the limit.  Design: one element per thread in a
// grid-stride loop, so a warp's plane loads and element stores cover
// contiguous addresses and every DRAM sector fetched is used; any n, with
// the tail masked by the loop bound (no row-block padding, unlike the
// TPU kernel's (M, 128) grid).  Four variants: 2 or 4 planes, with or
// without base.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int ITEMSIZE, bool HAS_BASE>
__global__ void unplane_kernel(const uint8_t* __restrict__ p0,
                               const uint8_t* __restrict__ p1,
                               const uint8_t* __restrict__ p2,
                               const uint8_t* __restrict__ p3,
                               const void* __restrict__ base,
                               void* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if constexpr (ITEMSIZE == 2) {
      const uint32_t rot = (static_cast<uint32_t>(p0[i]) << 8) | p1[i];
      uint16_t x = static_cast<uint16_t>((rot >> 1) | ((rot & 1u) << 15));
      if constexpr (HAS_BASE) x ^= static_cast<const uint16_t*>(base)[i];
      static_cast<uint16_t*>(out)[i] = x;
    } else {
      const uint32_t rot = (static_cast<uint32_t>(p0[i]) << 24) |
                           (static_cast<uint32_t>(p1[i]) << 16) |
                           (static_cast<uint32_t>(p2[i]) << 8) | p3[i];
      uint32_t x = (rot >> 1) | (rot << 31);
      if constexpr (HAS_BASE) x ^= static_cast<const uint32_t*>(base)[i];
      static_cast<uint32_t*>(out)[i] = x;
    }
  }
}

template <int ITEMSIZE, bool HAS_BASE>
void launch(const void* p0, const void* p1, const void* p2, const void* p3,
            const void* base, void* out, int64_t n, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond ~32 blocks/SM
  unplane_kernel<ITEMSIZE, HAS_BASE><<<static_cast<int>(blocks), threads, 0, stream>>>(
      static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
      static_cast<const uint8_t*>(p2), static_cast<const uint8_t*>(p3), base,
      out, n);
}

}  // namespace

extern "C" {

// itemsize 2: p0, p1 -> u16[n]; itemsize 4: p0..p3 -> u32[n].  base is a
// u16/u32[n] or null; unused plane pointers may be null.
int unplane_launch(const void* p0, const void* p1, const void* p2,
                   const void* p3, const void* base, void* out, long long n,
                   int itemsize, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (itemsize == 2) {
      if (base) launch<2, true>(p0, p1, p2, p3, base, out, n, s);
      else launch<2, false>(p0, p1, p2, p3, base, out, n, s);
    } else if (itemsize == 4) {
      if (base) launch<4, true>(p0, p1, p2, p3, base, out, n, s);
      else launch<4, false>(p0, p1, p2, p3, base, out, n, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* unplane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
