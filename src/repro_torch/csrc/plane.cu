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
// Here one thread reads an element (and its base), XORs, rotates, writes
// its itemsize plane bytes (plane 0 the most significant byte: the
// exponent) and counts each byte into a shared-memory histogram of its
// block with a shared atomic add.  A block covers one tile of elements
// that lies inside one chunk; at its end it adds each nonzero bin once into
// the chunk's row of the global int32 histogram (zeroed by the caller).
//
// What bounds it on the H100: bytes.  Each element moves itemsize bytes
// in (twice that with a base) and itemsize bytes out, with about ten
// integer operations and itemsize shared atomics.  An exponent plane has
// only a handful of distinct byte values, so its shared atomics serialise
// on a few bins; that costs time and not correctness (warp-private
// histograms are later work).  Loads and stores of a warp cover
// contiguous addresses.  Four variants: 2 or 4 bytes, with or without base.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int ITEMSIZE, bool HAS_BASE>
__global__ void plane_kernel(const void* __restrict__ x,
                             const void* __restrict__ base,
                             uint8_t* __restrict__ planes,
                             int* __restrict__ hists, int64_t n,
                             int64_t chunk_elems, int64_t tile) {
  __shared__ int h[ITEMSIZE * 256];
  for (int b = threadIdx.x; b < ITEMSIZE * 256; b += blockDim.x) h[b] = 0;
  __syncthreads();

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t end = begin + tile < n ? begin + tile : n;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    if constexpr (ITEMSIZE == 2) {
      uint32_t v = static_cast<const uint16_t*>(x)[i];
      if constexpr (HAS_BASE) v ^= static_cast<const uint16_t*>(base)[i];
      const uint32_t rot = ((v << 1) | (v >> 15)) & 0xFFFFu;
      const uint32_t b0 = rot >> 8, b1 = rot & 0xFFu;
      planes[i] = static_cast<uint8_t>(b0);
      planes[n + i] = static_cast<uint8_t>(b1);
      atomicAdd(&h[b0], 1);
      atomicAdd(&h[256 + b1], 1);
    } else {
      uint32_t v = static_cast<const uint32_t*>(x)[i];
      if constexpr (HAS_BASE) v ^= static_cast<const uint32_t*>(base)[i];
      const uint32_t rot = (v << 1) | (v >> 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t b = (rot >> (24 - 8 * k)) & 0xFFu;
        planes[k * n + i] = static_cast<uint8_t>(b);
        atomicAdd(&h[k * 256 + b], 1);
      }
    }
  }
  __syncthreads();

  // The tile lies in one chunk (tile divides chunk_elems): one global add
  // per nonzero bin of each plane.
  int* dst = hists + (begin / chunk_elems) * ITEMSIZE * 256;
  for (int b = threadIdx.x; b < ITEMSIZE * 256; b += blockDim.x) {
    const int c = h[b];
    if (c) atomicAdd(&dst[b], c);
  }
}

template <int ITEMSIZE, bool HAS_BASE>
void launch(const void* x, const void* base, void* planes, void* hists,
            int64_t n, int64_t chunk_elems, int64_t tile, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + tile - 1) / tile;
  plane_kernel<ITEMSIZE, HAS_BASE><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, base, static_cast<uint8_t*>(planes), static_cast<int*>(hists), n,
      chunk_elems, tile);
}

}  // namespace

extern "C" {

// x: u16/u32[n] element bits; base: the same or null; planes: u8[itemsize][n];
// hists: int32[n / chunk_elems][itemsize][256], zeroed.  tile must divide
// chunk_elems, and chunk_elems must divide n.
int plane_launch(const void* x, const void* base, void* planes, void* hists,
                 long long n, long long chunk_elems, long long tile,
                 int itemsize, void* stream) {
  if (n > 0) {
    if (tile <= 0 || chunk_elems <= 0 || chunk_elems % tile || n % chunk_elems)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (itemsize == 2) {
      if (base) launch<2, true>(x, base, planes, hists, n, chunk_elems, tile, s);
      else launch<2, false>(x, base, planes, hists, n, chunk_elems, tile, s);
    } else if (itemsize == 4) {
      if (base) launch<4, true>(x, base, planes, hists, n, chunk_elems, tile, s);
      else launch<4, false>(x, base, planes, hists, n, chunk_elems, tile, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* plane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
