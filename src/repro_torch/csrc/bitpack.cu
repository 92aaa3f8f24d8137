// Huffman bit-pack (kernel K7) for Hopper, sm_90a: canonical codes of many
// chunks, each under its own table, packed MSB first into 32-bit words.
//
// Replaces the TPU kernel bitpack_encode_chunks_multi in
// src/repro/kernels/bitpack.py.  That kernel binary-searches the producing
// symbol for every output bit and reduces 32 bits to a word with weighted
// sums: O(8n log n) gathers, a shape chosen for the TPU's vector unit.
// Here a symbol writes its own code instead.  One thread block packs one
// chunk.  It stages the chunk's (length, code) table row in shared memory,
// then walks the chunk in tiles of THREADS * SPT symbols: each thread looks
// up its SPT symbols' codes, a block-wide exclusive scan of the lengths
// (warp shuffles, then one warp over the warp totals) gives each code its
// bit position after a running carry, and each code (at most 15 bits) is
// ORed into a shared-memory window of words with shared atomics: a code
// spans at most two words.  Complete words of the window are then stored
// once to device memory; the partial last word moves to the window's
// front for the next tile.
//
// Bit j of a chunk lands in bit 31 - (j & 31) of word j >> 5, so the
// big-endian bytes of the words are the np.packbits stream of the host
// encoder.  Words past the chunk's raw-size capacity (chunk_syms / 4) are
// never stored (such a chunk is stored raw by the host), but the bit count
// still counts every code, pad symbols of a partial final chunk included,
// as the reference counts them.  Words the codes do not reach keep the
// zeros the caller allocated.
//
// What bounds it on the H100: operations.  Per symbol a byte load, two
// shared table lookups, its share of the scan, and one or two shared
// atomics; the bytes moved (one symbol in, at most one byte out) are
// small.  One block per chunk leaves most SMs idle on a tensor of 18
// chunks; splitting a chunk across blocks is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int SPT = 4;                             // symbols per thread per tile
constexpr int TILE = THREADS * SPT;
constexpr int MAXL = 15;
constexpr int WIN = (TILE * MAXL + 31) / 32 + 2;   // words a tile can touch

__device__ __forceinline__ void put_code(uint32_t* win, int local_bit,
                                         uint32_t code, int len) {
  const int w = local_bit >> 5, o = local_bit & 31;
  if (o + len <= 32) {
    atomicOr(&win[w], code << (32 - o - len));
  } else {
    const int spill = o + len - 32;
    atomicOr(&win[w], code >> spill);
    atomicOr(&win[w + 1], code << (32 - spill));
  }
}

__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const uint8_t* __restrict__ syms,
               const int* __restrict__ plane_ids,
               const int* __restrict__ len_tables,
               const int* __restrict__ code_tables, int n_tables,
               uint32_t* __restrict__ words, int* __restrict__ nbits,
               int chunk_syms) {
  __shared__ int s_len[256];
  __shared__ uint32_t s_code[256];
  __shared__ uint32_t win[WIN];
  __shared__ int s_warp[WARPS];
  __shared__ int s_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const int pid = plane_ids[c];
  if (pid < 0 || pid >= n_tables) {       // no such table: flag the chunk
    if (tid == 0) nbits[c] = -1;
    return;
  }
  for (int b = tid; b < 256; b += THREADS) {
    const int len = len_tables[pid * 256 + b];     // 0..MAXL (checked by the caller)
    s_len[b] = len;
    s_code[b] = static_cast<uint32_t>(code_tables[pid * 256 + b]) & ((1u << len) - 1u);
  }
  for (int w = tid; w < WIN; w += THREADS) win[w] = 0;
  __syncthreads();

  const uint8_t* src = syms + static_cast<int64_t>(c) * chunk_syms;
  uint32_t* dst = words + static_cast<int64_t>(c) * (chunk_syms / 4);
  const int cap_words = chunk_syms / 4;
  int carry = 0;                          // bits before this tile

  for (int t0 = 0; t0 < chunk_syms; t0 += TILE) {
    int len[SPT];
    uint32_t code[SPT];
    int sum = 0;
    const int i0 = t0 + tid * SPT;
    // chunk_syms is a multiple of SPT == 4: a thread's symbols are all in
    // the chunk or all past it, and one aligned 32-bit load reads them.
    const uint32_t four =
        i0 < chunk_syms ? *reinterpret_cast<const uint32_t*>(src + i0) : 0u;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = (four >> (8 * k)) & 0xFF;
      len[k] = i0 < chunk_syms ? s_len[s] : 0;
      code[k] = s_code[s];
      sum += len[k];
    }
    // Block-wide exclusive scan of the per-thread bit counts.
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = s_warp[lane];
      int wi = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += u;
      }
      __syncwarp();
      s_warp[lane] = wi - v;
      if (lane == 31) s_total = wi;
    }
    __syncthreads();

    const int wbase = carry >> 5;                  // device word of win[0]
    int bit = (carry & 31) + s_warp[warp] + incl - sum;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (len[k]) put_code(win, bit, code[k], len[k]);
      bit += len[k];
    }
    const int next = carry + s_total;
    __syncthreads();

    const int full = (next >> 5) - wbase;         // complete words in win
    for (int w = tid; w < full; w += THREADS) {
      if (wbase + w < cap_words) dst[wbase + w] = win[w];
    }
    const uint32_t partial = win[full];
    __syncthreads();
    for (int w = tid; w <= full; w += THREADS) win[w] = (w == 0) ? partial : 0u;
    __syncthreads();
    carry = next;
  }
  if (tid == 0) {
    if ((carry & 31) && (carry >> 5) < cap_words) dst[carry >> 5] = win[0];
    nbits[c] = carry;
  }
}

}  // namespace

extern "C" {

// syms: u8[n_chunks * chunk_syms]; plane_ids: int32[n_chunks]; len_tables,
// code_tables: int32[n_tables][256]; words: u32[n_chunks][chunk_syms / 4],
// zeroed; nbits: int32[n_chunks].  chunk_syms must be a positive multiple
// of 4 and syms 4-byte aligned; table lengths must lie in 0..15.
int bitpack_launch(const void* syms, const void* plane_ids,
                   const void* len_tables, const void* code_tables,
                   int n_tables, void* words, void* nbits, int n_chunks,
                   int chunk_syms, void* stream) {
  if (n_chunks > 0) {
    if (chunk_syms <= 0 || chunk_syms % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    bitpack_kernel<<<n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(syms), static_cast<const int*>(plane_ids),
        static_cast<const int*>(len_tables),
        static_cast<const int*>(code_tables), n_tables,
        static_cast<uint32_t*>(words), static_cast<int*>(nbits), chunk_syms);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bitpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
