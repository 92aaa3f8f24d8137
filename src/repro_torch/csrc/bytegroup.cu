// Byte grouping (kernel K4) for Hopper, sm_90a: rotate each element's
// bits left by one and split them into byte planes, plane 0 the most
// significant byte (the exponent of bf16 and fp32).  Two widths: u16
// elements into 2 planes (bf16) and u32 elements into 4 (fp32).  The
// inverse (kernel K11) is K2 without a base, csrc/unplane.cu.
//
// Replaces the TPU kernels bytegroup_bf16_2d and bytegroup_fp32_2d in
// src/repro/kernels/bytegroup.py.  Those work on (rows, 128) blocks of a
// padded grid.  Here a grid-stride loop takes any n: a thread handles a
// group of 16 elements with 16-byte loads and stores, the bytes of each
// plane gathered from the rotated words with byte permutes (__byte_perm),
// when every pointer is 16-byte aligned (the caller checks); the last
// n % 16 elements, or every element of a misaligned call, go one at a
// time.  It is the plane stage of K3 (csrc/plane.cu) without its XOR and
// its histograms.
//
// What bounds it on the H100: bytes.  Each element moves its itemsize
// bytes in and out, with about two integer operations per byte (rotate,
// permute), far below the INT32 lanes' rate.  A warp's loads and stores
// cover contiguous addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 8192;
constexpr int GROUP = 16;                       // elements per vector group

// Rotate both u16 halves of a word left by one bit.
__device__ __forceinline__ uint32_t rotl16x2(uint32_t w) {
  return ((w << 1) & 0xFFFEFFFEu) | ((w >> 15) & 0x00010001u);
}

// Byte s/8 of each of four words, packed into one word (word k in byte k).
__device__ __forceinline__ uint32_t pick(uint32_t r0, uint32_t r1, uint32_t r2,
                                         uint32_t r3, int s) {
  return ((r0 >> s) & 0xFFu) | (((r1 >> s) & 0xFFu) << 8) |
         (((r2 >> s) & 0xFFu) << 16) | ((r3 >> s) << 24);
}

struct Planes {
  uint8_t* p[4];
};

__global__ void __launch_bounds__(THREADS)
group_bf16(const uint16_t* __restrict__ x, Planes out, int64_t n, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t ng = n / GROUP;
    const uint4* in = reinterpret_cast<const uint4*>(x);
    for (int64_t g = tid; g < ng; g += stride) {
      const uint4 lo = in[2 * g], hi = in[2 * g + 1];
      const uint32_t w[8] = {rotl16x2(lo.x), rotl16x2(lo.y), rotl16x2(lo.z), rotl16x2(lo.w),
                             rotl16x2(hi.x), rotl16x2(hi.y), rotl16x2(hi.z), rotl16x2(hi.w)};
      // Element 2j sits in the low half of w[j]: its exponent is byte 1, its
      // low byte byte 0; element 2j + 1 has bytes 3 and 2.
      uint4 e, f;
      e.x = __byte_perm(w[0], w[1], 0x7531); f.x = __byte_perm(w[0], w[1], 0x6420);
      e.y = __byte_perm(w[2], w[3], 0x7531); f.y = __byte_perm(w[2], w[3], 0x6420);
      e.z = __byte_perm(w[4], w[5], 0x7531); f.z = __byte_perm(w[4], w[5], 0x6420);
      e.w = __byte_perm(w[6], w[7], 0x7531); f.w = __byte_perm(w[6], w[7], 0x6420);
      reinterpret_cast<uint4*>(out.p[0])[g] = e;
      reinterpret_cast<uint4*>(out.p[1])[g] = f;
    }
    done = ng * GROUP;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const uint32_t v = x[i];
    const uint32_t rot = ((v << 1) | (v >> 15)) & 0xFFFFu;
    out.p[0][i] = static_cast<uint8_t>(rot >> 8);
    out.p[1][i] = static_cast<uint8_t>(rot & 0xFFu);
  }
}

__global__ void __launch_bounds__(THREADS)
group_fp32(const uint32_t* __restrict__ x, Planes out, int64_t n, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t ng = n / GROUP;
    const uint4* in = reinterpret_cast<const uint4*>(x);
    for (int64_t g = tid; g < ng; g += stride) {
      uint32_t r[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint4 q = in[4 * g + m];
        r[m][0] = __funnelshift_l(q.x, q.x, 1);
        r[m][1] = __funnelshift_l(q.y, q.y, 1);
        r[m][2] = __funnelshift_l(q.z, q.z, 1);
        r[m][3] = __funnelshift_l(q.w, q.w, 1);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int s = 24 - 8 * p;
        reinterpret_cast<uint4*>(out.p[p])[g] = make_uint4(
            pick(r[0][0], r[0][1], r[0][2], r[0][3], s),
            pick(r[1][0], r[1][1], r[1][2], r[1][3], s),
            pick(r[2][0], r[2][1], r[2][2], r[2][3], s),
            pick(r[3][0], r[3][1], r[3][2], r[3][3], s));
      }
    }
    done = ng * GROUP;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const uint32_t rot = __funnelshift_l(x[i], x[i], 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) out.p[p][i] = static_cast<uint8_t>(rot >> (24 - 8 * p));
  }
}

unsigned blocks_for(int64_t n, int vec) {
  const int64_t work = vec ? n / GROUP + GROUP : n;
  const int64_t b = (work + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// x: u16[n] (itemsize 2) or u32[n] (itemsize 4); p0..p3: u8[n] planes, the
// last two null for itemsize 2.  vec: every pointer is 16-byte aligned.
int bytegroup_launch(const void* x, void* p0, void* p1, void* p2, void* p3,
                     long long n, int itemsize, int vec, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Planes out{{static_cast<uint8_t*>(p0), static_cast<uint8_t*>(p1),
                      static_cast<uint8_t*>(p2), static_cast<uint8_t*>(p3)}};
    if (itemsize == 2) {
      group_bf16<<<blocks_for(n, vec), THREADS, 0, s>>>(static_cast<const uint16_t*>(x), out,
                                                        n, vec);
    } else if (itemsize == 4) {
      group_fp32<<<blocks_for(n, vec), THREADS, 0, s>>>(static_cast<const uint32_t*>(x), out,
                                                        n, vec);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bytegroup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
