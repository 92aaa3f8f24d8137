// Plane producer (kernel K3) for Hopper, sm_90a: optional XOR with a base,
// rotate-left-1, byte-group split and per-chunk 256-bin histograms of every
// plane, in one pass over the elements.
//
// Replaces the TPU kernel plane_producer in
// src/repro/kernels/fused_plane.py, which runs three Pallas calls under
// one jit: xor_elems_2d (src/repro/kernels/xor_delta.py), then
// bytegroup_bf16_2d / bytegroup_fp32_2d (src/repro/kernels/bytegroup.py),
// then chunk_histogram_2d once per plane (src/repro/kernels/histogram.py).
// Each of those makes its own pass over device memory, and the TPU has no
// atomics, so its histogram compares every byte against all 256 bins.
//
// What bounds it on the H100: bytes, once the histograms stay out of the
// way.  Each element moves itemsize bytes in (twice that with a base) and
// itemsize bytes out.  Two things kept an earlier design at 2.8x that
// bound.  Narrow traffic: one 2- or 4-byte element a thread a step.  Here
// a thread reads 16 bytes of elements (and of the base) a step, 8 bf16 or
// 4 fp32 elements, with VECTORS of them in flight, and writes each plane's
// bytes of them with one 8-byte (bf16) or 4-byte (fp32) store.  And
// contended counts: one shared histogram per block took a shared atomic
// per byte from all its warps, and an exponent plane puts most of its
// bytes in three or four bins, so the atomics serialised on a few
// addresses.  Here each warp (HIST_LANES threads) counts into a histogram
// of its own in shared memory with shared atomic adds, so no two warps
// touch one counter.  What is left is the shared atomics' own rate, about
// four lanes a clock an SM whether the lanes of a warp meet on a bin or
// not.  Measured on the card and set aside (kernels/plane_launch_sweep.py):
// a copy for every 16 or 8 lanes (the copies one word apart modulo the
// banks), which spreads a hot bin but costs bank conflicts and flushes;
// lanes that hold one exponent byte adding it once (__match_any_sync),
// whose match costs more than the atomics it saves; and 8-bit counters in
// a column of shared memory only the thread touches, four to a word, which
// take 256 bytes a plane a thread, so they cap the threads a block runs,
// and whose sums at the end of a tile cost more than the atomics they save.
// At the end of a tile the threads sum each bin over the copies, zero it,
// and add each nonzero bin once, with a global atomic, into the chunk's row
// of the int32 histograms (zeroed by the caller).  Counts are integers: the
// order of the adds does not change them.
//
// The grid is flat over (chunk, tile) pairs, so a tile lies inside one
// chunk and any chunk length works.  It is sized to one wave: at most as
// many blocks as the card holds at once, each walking tiles a grid apart,
// and a tile's length is chosen so that the tiles about fill that wave
// (fewer tiles, fewer flushes of the histograms; enough blocks to keep
// every SM's loads in flight).  A tile's elements before the first 16-byte
// boundary of x, and after its last whole vector, go one by one, as does
// every element when x and the base are not 16-byte aligned alike; a plane
// store that is not aligned goes in 4-byte or 1-byte pieces.  So any
// contiguous input works, a view that starts at an odd element too.  Four
// variants: 2 or 4 bytes, with or without a base.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int VECTORS = 2;                       // 16-byte loads in flight a thread
constexpr int HIST_LANES = 32;                   // threads that share a histogram copy
constexpr int MAX_STEPS = 16;                    // vectors a thread a tile, at most

template <int ITEMSIZE>
struct Shape {
  static constexpr int VEC = 16 / ITEMSIZE;      // elements a 16-byte vector
  static constexpr int BINS = ITEMSIZE * 256;    // a copy's bins, plane by plane
  static constexpr int STRIDE = BINS + 1;        // words from one copy to the next
  static constexpr int COPIES = THREADS / HIST_LANES;
  static constexpr int SMEM = (COPIES * STRIDE * 4 + 15) / 16 * 16;
};

__device__ __forceinline__ void store8(uint8_t* d, uint32_t lo, uint32_t hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(d);
  if (!(a & 7)) {
    *reinterpret_cast<uint2*>(d) = make_uint2(lo, hi);
  } else if (!(a & 3)) {
    reinterpret_cast<uint32_t*>(d)[0] = lo;
    reinterpret_cast<uint32_t*>(d)[1] = hi;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[k] = static_cast<uint8_t>(lo >> (8 * k));
      d[4 + k] = static_cast<uint8_t>(hi >> (8 * k));
    }
  }
}

__device__ __forceinline__ void store4(uint8_t* d, uint32_t w) {
  if (!(reinterpret_cast<uintptr_t>(d) & 3)) {
    *reinterpret_cast<uint32_t*>(d) = w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = static_cast<uint8_t>(w >> (8 * k));
  }
}

// One count of byte b of plane p in the thread's histogram copy h.
__device__ __forceinline__ void count_byte(uint32_t* h, int p, uint32_t b) {
  atomicAdd(&h[p * 256 + static_cast<int>(b)], 1u);
}

__device__ __forceinline__ void count_word(uint32_t* h, int p, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) count_byte(h, p, (w >> (8 * k)) & 0xFFu);
}

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

// One 16-byte vector of element bits (XORed already) at element i.
template <int ITEMSIZE>
__device__ __forceinline__ void vector_planes(uint4 q, uint8_t* planes, int64_t n,
                                              int64_t i, uint32_t* h) {
  if constexpr (ITEMSIZE == 2) {
    const uint32_t w0 = rotl16x2(q.x), w1 = rotl16x2(q.y), w2 = rotl16x2(q.z),
                   w3 = rotl16x2(q.w);
    // element 2j sits in the low half of a word: its exponent is byte 1
    const uint32_t e0 = __byte_perm(w0, w1, 0x7531), e1 = __byte_perm(w2, w3, 0x7531);
    const uint32_t f0 = __byte_perm(w0, w1, 0x6420), f1 = __byte_perm(w2, w3, 0x6420);
    store8(planes + i, e0, e1);
    store8(planes + n + i, f0, f1);
    count_word(h, 0, e0);
    count_word(h, 0, e1);
    count_word(h, 1, f0);
    count_word(h, 1, f1);
  } else {
    const uint32_t r0 = __funnelshift_l(q.x, q.x, 1), r1 = __funnelshift_l(q.y, q.y, 1),
                   r2 = __funnelshift_l(q.z, q.z, 1), r3 = __funnelshift_l(q.w, q.w, 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t b = pick(r0, r1, r2, r3, 24 - 8 * p);
      store4(planes + p * n + i, b);
      count_word(h, p, b);
    }
  }
}

template <int ITEMSIZE, bool HAS_BASE>
__device__ __forceinline__ void element_planes(const void* x, const void* base,
                                               uint8_t* planes, int64_t n, int64_t i,
                                               uint32_t* h) {
  if constexpr (ITEMSIZE == 2) {
    uint32_t v = static_cast<const uint16_t*>(x)[i];
    if constexpr (HAS_BASE) v ^= static_cast<const uint16_t*>(base)[i];
    const uint32_t rot = ((v << 1) | (v >> 15)) & 0xFFFFu;
    planes[i] = static_cast<uint8_t>(rot >> 8);
    planes[n + i] = static_cast<uint8_t>(rot & 0xFFu);
    count_byte(h, 0, rot >> 8);
    count_byte(h, 1, rot & 0xFFu);
  } else {
    uint32_t v = static_cast<const uint32_t*>(x)[i];
    if constexpr (HAS_BASE) v ^= static_cast<const uint32_t*>(base)[i];
    const uint32_t rot = __funnelshift_l(v, v, 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t b = (rot >> (24 - 8 * p)) & 0xFFu;
      planes[p * n + i] = static_cast<uint8_t>(b);
      count_byte(h, p, b);
    }
  }
}

template <int ITEMSIZE, bool HAS_BASE>
__global__ void __launch_bounds__(THREADS)
plane_kernel(const void* __restrict__ x, const void* __restrict__ base,
             uint8_t* __restrict__ planes, int* __restrict__ hists, int64_t n,
             int64_t chunk_elems, int64_t tile, int64_t tiles_per_chunk,
             int64_t n_tiles, int vec) {
  using S = Shape<ITEMSIZE>;
  constexpr int VEC = S::VEC;
  extern __shared__ uint4 smem[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  const int t = threadIdx.x;
  uint32_t* h = cnt + (t / HIST_LANES) * S::STRIDE;
  for (int k = t; k < S::SMEM / 16; k += THREADS) smem[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int64_t tl = blockIdx.x; tl < n_tiles; tl += gridDim.x) {
    const int64_t c = tl / tiles_per_chunk;
    const int64_t begin = c * chunk_elems + (tl % tiles_per_chunk) * tile;
    const int64_t end = begin + tile < (c + 1) * chunk_elems ? begin + tile : (c + 1) * chunk_elems;

    // Elements before x's first 16-byte boundary in the tile, then whole
    // vectors, then the rest; all one by one when not vec.
    int64_t body = end;
    if (vec) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(begin) * ITEMSIZE;
      body = begin + static_cast<int64_t>((16 - (a & 15)) & 15) / ITEMSIZE;
      if (body > end) body = end;
    }
    const int64_t nv = (end - body) / VEC;
    for (int64_t i = begin + t; i < body; i += THREADS) {
      element_planes<ITEMSIZE, HAS_BASE>(x, base, planes, n, i, h);
    }
    const uint4* xv =
        reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(x) + body * ITEMSIZE);
    const uint4* bv = HAS_BASE
        ? reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(base) + body * ITEMSIZE)
        : nullptr;
    for (int64_t v0 = t; v0 < nv; v0 += static_cast<int64_t>(THREADS) * VECTORS) {
      uint4 q[VECTORS];
#pragma unroll
      for (int u = 0; u < VECTORS; ++u) {
        const int64_t v = v0 + u * THREADS;
        if (v < nv) {
          q[u] = xv[v];
          if constexpr (HAS_BASE) {
            const uint4 b = bv[v];
            q[u] = make_uint4(q[u].x ^ b.x, q[u].y ^ b.y, q[u].z ^ b.z, q[u].w ^ b.w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < VECTORS; ++u) {
        const int64_t v = v0 + u * THREADS;
        if (v < nv) vector_planes<ITEMSIZE>(q[u], planes, n, body + v * VEC, h);
      }
    }
    for (int64_t i = body + nv * VEC + t; i < end; i += THREADS) {
      element_planes<ITEMSIZE, HAS_BASE>(x, base, planes, n, i, h);
    }
    __syncthreads();

    // Each bin summed over the copies and zeroed; nonzero bins go to the
    // chunk's histograms.
    int* dst = hists + c * S::BINS;
    for (int bin = t; bin < S::BINS; bin += THREADS) {
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k < S::COPIES; ++k) {
        sum += cnt[k * S::STRIDE + bin];
        cnt[k * S::STRIDE + bin] = 0u;
      }
      if (sum) atomicAdd(dst + bin, static_cast<int>(sum));
    }
    __syncthreads();
  }
}

template <int ITEMSIZE, bool HAS_BASE>
int launch(const void* x, const void* base, void* planes, void* hists, int64_t n,
           int64_t chunk_elems, int steps, cudaStream_t stream) {
  using S = Shape<ITEMSIZE>;
  auto kernel = plane_kernel<ITEMSIZE, HAS_BASE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, S::SMEM);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t wave = static_cast<int64_t>(sms) * per_sm;
  const int64_t vector_elems = static_cast<int64_t>(THREADS) * S::VEC;
  if (steps <= 0) {
    // tiles that about fill one wave: ceil(n / (wave * vector_elems)) vectors
    // a thread, within 1..MAX_STEPS
    const int64_t want = (n + wave * vector_elems - 1) / (wave * vector_elems);
    steps = static_cast<int>(want < 1 ? 1 : want > MAX_STEPS ? MAX_STEPS : want);
  }
  const int64_t tile = vector_elems * steps;
  const int64_t tiles_per_chunk = (chunk_elems + tile - 1) / tile;
  const int64_t n_tiles = n / chunk_elems * tiles_per_chunk;
  const int64_t blocks = n_tiles < wave ? n_tiles : wave;
  // vectors need x and the base 16-byte aligned alike (x's own alignment
  // is handled per tile)
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x), ab = reinterpret_cast<uintptr_t>(base);
  const int vec = !(ax % ITEMSIZE) && (!base || !((ax ^ ab) & 15));
  kernel<<<static_cast<unsigned>(blocks), THREADS, S::SMEM, stream>>>(
      x, base, static_cast<uint8_t*>(planes), static_cast<int*>(hists), n, chunk_elems, tile,
      tiles_per_chunk, n_tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: u16/u32[n] element bits; base: the same or null; planes: u8[itemsize][n];
// hists: int32[n / chunk_elems][itemsize][256], zeroed.  chunk_elems must
// divide n.  steps: 16-byte vectors a thread takes in a tile (a tile is
// THREADS x steps vectors), or 0 to size the tiles to about one wave.
int plane_launch(const void* x, const void* base, void* planes, void* hists,
                 long long n, long long chunk_elems, int steps, int itemsize,
                 void* stream) {
  if (n > 0) {
    if (chunk_elems <= 0 || n % chunk_elems) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (itemsize == 2) {
      return base ? launch<2, true>(x, base, planes, hists, n, chunk_elems, steps, s)
                  : launch<2, false>(x, base, planes, hists, n, chunk_elems, steps, s);
    }
    if (itemsize == 4) {
      return base ? launch<4, true>(x, base, planes, hists, n, chunk_elems, steps, s)
                  : launch<4, false>(x, base, planes, hists, n, chunk_elems, steps, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* plane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
