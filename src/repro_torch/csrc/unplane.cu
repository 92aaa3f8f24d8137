// Plane consumer (kernel K2) for Hopper, sm_90a: un-byte-group, inverse
// rotate-left-1 and the optional XOR with a base, in one pass.  Without a
// base it is also the byte ungrouping (kernel K11).
//
// Replaces the TPU kernel plane_consumer in
// src/repro/kernels/fused_unplane.py (bodies _bf16_unplane_kernel,
// _bf16_unplane_delta_kernel, _fp32_unplane_kernel,
// _fp32_unplane_delta_kernel), and ungroup_bf16_2d, ungroup_fp32_2d in
// src/repro/kernels/bytegroup.py.  Plane 0 is the most significant byte
// (the exponent after the encoder's rotate-left-1); the joined value is
// rotated right by one bit and, for a delta stream, XORed with base.
//
// What bounds it on the H100: bytes.  Each element reads itemsize plane
// bytes (plus itemsize base bytes) and writes itemsize bytes, with a
// handful of integer operations, far below the ~295 operations per byte
// where the ALUs would be the limit.  Design: a grid-stride loop over any
// n (no row-block padding, unlike the TPU kernel's (M, 128) grid).  When
// every pointer is 16-byte aligned (unplane_launch checks) a thread takes
// a group of 16 elements: one 16-byte load from each plane, byte permutes
// (__byte_perm) to join them, 16-byte loads of the base and 16-byte
// stores; the last n % 16 elements, or every element of a misaligned
// call, go one at a time.  Either way a warp's loads and stores cover
// contiguous addresses.  Four variants: 2 or 4 planes, with or without
// base.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 32;        // grid-stride beyond ~32 blocks/SM
constexpr int GROUP = 16;                       // elements per vector group

// Rotate both u16 halves of a word right by one bit.
__device__ __forceinline__ uint32_t rotr16x2(uint32_t w) {
  return ((w >> 1) & 0x7FFF7FFFu) | ((w << 15) & 0x80008000u);
}

// Rotated u32 of element k of four plane words (plane 0 most significant).
__device__ __forceinline__ uint32_t join(uint32_t p0, uint32_t p1, uint32_t p2,
                                         uint32_t p3, int k) {
  const int s = 8 * k;
  return (((p0 >> s) & 0xFFu) << 24) | (((p1 >> s) & 0xFFu) << 16) |
         (((p2 >> s) & 0xFFu) << 8) | ((p3 >> s) & 0xFFu);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <int ITEMSIZE, bool HAS_BASE>
__global__ void __launch_bounds__(THREADS)
unplane_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
               const uint8_t* __restrict__ p2, const uint8_t* __restrict__ p3,
               const void* __restrict__ base, void* __restrict__ out, int64_t n,
               int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const uint4* b4 = static_cast<const uint4*>(base);
  uint4* o4 = static_cast<uint4*>(out);
  int64_t done = 0;
  if (vec) {
    const int64_t ng = n / GROUP;
    for (int64_t g = tid; g < ng; g += stride) {
      if constexpr (ITEMSIZE == 2) {
        const uint4 ev = reinterpret_cast<const uint4*>(p0)[g];
        const uint4 fv = reinterpret_cast<const uint4*>(p1)[g];
        const uint32_t e[4] = {ev.x, ev.y, ev.z, ev.w}, f[4] = {fv.x, fv.y, fv.z, fv.w};
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // (exp << 8 | low byte) of elements 4k, 4k + 1, then 4k + 2, 4k + 3
          w[2 * k] = rotr16x2(__byte_perm(f[k], e[k], 0x5140));
          w[2 * k + 1] = rotr16x2(__byte_perm(f[k], e[k], 0x7362));
        }
        uint4 lo = make_uint4(w[0], w[1], w[2], w[3]);
        uint4 hi = make_uint4(w[4], w[5], w[6], w[7]);
        if constexpr (HAS_BASE) {
          lo = xor4(lo, b4[2 * g]);
          hi = xor4(hi, b4[2 * g + 1]);
        }
        o4[2 * g] = lo;
        o4[2 * g + 1] = hi;
      } else {
        const uint8_t* const planes[4] = {p0, p1, p2, p3};
        uint32_t p[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint4 q = reinterpret_cast<const uint4*>(planes[k])[g];
          p[k][0] = q.x; p[k][1] = q.y; p[k][2] = q.z; p[k][3] = q.w;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t rot = join(p[0][m], p[1][m], p[2][m], p[3][m], k);
            w[k] = __funnelshift_r(rot, rot, 1);
          }
          uint4 v = make_uint4(w[0], w[1], w[2], w[3]);
          if constexpr (HAS_BASE) v = xor4(v, b4[4 * g + m]);
          o4[4 * g + m] = v;
        }
      }
    }
    done = ng * GROUP;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    if constexpr (ITEMSIZE == 2) {
      const uint32_t rot = (static_cast<uint32_t>(p0[i]) << 8) | p1[i];
      uint16_t x = static_cast<uint16_t>((rot >> 1) | ((rot & 1u) << 15));
      if constexpr (HAS_BASE) x ^= static_cast<const uint16_t*>(base)[i];
      static_cast<uint16_t*>(out)[i] = x;
    } else {
      const uint32_t rot = (static_cast<uint32_t>(p0[i]) << 24) |
                           (static_cast<uint32_t>(p1[i]) << 16) |
                           (static_cast<uint32_t>(p2[i]) << 8) | p3[i];
      uint32_t x = __funnelshift_r(rot, rot, 1);
      if constexpr (HAS_BASE) x ^= static_cast<const uint32_t*>(base)[i];
      static_cast<uint32_t*>(out)[i] = x;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int ITEMSIZE, bool HAS_BASE>
void launch(const void* p0, const void* p1, const void* p2, const void* p3,
            const void* base, void* out, int64_t n, cudaStream_t stream) {
  const int vec = aligned16(p0) && aligned16(p1) && aligned16(out) &&
                  (ITEMSIZE == 2 || (aligned16(p2) && aligned16(p3))) &&
                  (!HAS_BASE || aligned16(base));
  const int64_t work = vec ? n / GROUP + GROUP : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  unplane_kernel<ITEMSIZE, HAS_BASE><<<static_cast<int>(blocks), THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
      static_cast<const uint8_t*>(p2), static_cast<const uint8_t*>(p3), base,
      out, n, vec);
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
