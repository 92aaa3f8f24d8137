// Canonical-Huffman chunk decode (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel huffdecode_chunks_multi in
// src/repro/kernels/huffdecode.py:92 (bodies _decode_block and
// _huffdecode_multi_kernel).  Each HUFF chunk of a ZNN1 stream is an
// independent MSB-first canonical-code bitstream; every step takes a
// lut_bits-wide window at the bit cursor, gathers one fused (sym << 4) | len
// entry from the chunk's plane row of the stacked LUTs, writes sym and
// advances the cursor by len.  (The TPU kernel fuses (sym << 8) | len into
// int32; len <= 15 fits four bits, so here an entry is an int16 and a
// resident row is half the size.)
//
// Two kernels.
//
// huffdecode_kernel, the serial decode and the index pass: one thread per
// chunk walks all its symbols.  Symbol i+1's position depends on symbol i's
// code length, so a chunk is one chain of (word load -> LUT gather ->
// cursor add), ~300 cycles a step with the LUT in global memory, and a bf16
// weight's exponent plane has only 18 chunks at the default 256 KiB
// chunking: latency bounds it, thousands of times above its bytes bound.
// With a `sync` output it also records the bit cursor before every
// sync_every-th symbol of each chunk (the sync-point index).  The blob
// format is fixed, so the index is not stored in it: a resident payload feed
// runs this pass once at build, when it checks the cursors anyway, and keeps
// the index beside the words.
//
// huffdecode_sync_kernel, the decode the serving ring runs every step: the
// index cuts a chunk into ceil(count / sync_every) independent sub-streams.
// One block per chunk, one thread per sub-stream (a loop when there are more
// than the block's threads).  What bounds it is still the chain inside a
// sub-stream, now sync_every steps long instead of count, so the design
// makes each step short:
//  * the block stages its LUT row (<= 64 KiB) and, when they fit, the
//    chunk's words in dynamic shared memory with cp.async (16-byte copies
//    for the aligned body), so every gather and word read hits shared
//    memory.  A chunk's HUFF payload is smaller than its raw size, so at the
//    default 131,072-symbol plane chunks words plus row stay under the
//    227 KB a block may take; a block whose words do not fit (larger chunks)
//    reads them from global memory instead;
//  * each thread keeps a 64-bit MSB-aligned bit buffer and refills it one
//    word at a time, not two word loads per symbol;
//  * a thread's symbols are contiguous in the output, so it packs them into
//    16-byte stores, with the misaligned head and ragged tail byte by byte.
//
// Invariants both kernels keep:
//  * words are packed compactly: chunk c owns words
//    [word_off[c], word_off[c+1]), so the resident feed holds compressed
//    bytes only, not chunk-capacity-padded buffers;
//  * a read past a chunk's own words yields 0 (the zero padding a
//    capacity-padded layout would hold) and never leaves the chunk, so a
//    corrupt or truncated payload decodes garbage that the host-side
//    cursor check rejects, never an out-of-bounds read;
//  * symbols go straight to out[out_off[c] ...], the chunk's place in its
//    output plane, so the caller needs no per-chunk slice or concatenate;
//  * cursors (and index entries) only saturate at INT32_MAX.  They must not
//    be clamped to the chunk's own (compact) word capacity: that capacity
//    ends inside the payload's last word, so a runaway cursor clamped there
//    could land in the payload's final byte and pass the host check.  On
//    valid streams cursors equal the reference's exactly, and the sync
//    decode's final cursor (the last sub-stream's end) equals the serial
//    kernel's.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SYNC_THREADS = 256;

__device__ __forceinline__ int32_t saturate(int64_t x) {
  return static_cast<int32_t>(x < INT32_MAX ? x : INT32_MAX);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__host__ __device__ __forceinline__ int lut_region_bytes(int lut_bits) {
  // the row plus up to 12 bytes of lead (see stage), rounded to 16
  return ((2 << lut_bits) + 12 + 15) & ~15;
}

__global__ void huffdecode_kernel(const uint32_t* __restrict__ words,
                                  const int64_t* __restrict__ word_off,
                                  const int32_t* __restrict__ plane_ids,
                                  const int32_t* __restrict__ counts,
                                  const int64_t* __restrict__ out_off,
                                  const int16_t* __restrict__ luts,
                                  int lut_bits, int n_chunks,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ cursors,
                                  const int64_t* __restrict__ sync_off,
                                  int32_t* __restrict__ sync, int sync_every) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const uint32_t* w = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const int16_t* lut = luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits);
  uint8_t* dst = out + out_off[c];
  const int count = counts[c];
  const uint32_t shift = 32u - static_cast<uint32_t>(lut_bits);
  int32_t* idx = sync ? sync + sync_off[c] : nullptr;
  int next_sync = 0;

  int64_t bitpos = 0;
  for (int i = 0; i < count; ++i) {
    if (idx && i == next_sync) {
      *idx++ = saturate(bitpos);
      next_sync += sync_every;
    }
    const int64_t w0 = bitpos >> 5;
    const uint32_t o = static_cast<uint32_t>(bitpos & 31);
    const uint32_t a = w0 < nw ? __ldg(w + w0) : 0u;
    const uint32_t b = w0 + 1 < nw ? __ldg(w + w0 + 1) : 0u;
    // (a << o) puts the window's first bit at the MSB; b adds its top o
    // bits.  The double shift stays defined at o == 0.
    const uint32_t win = (a << o) | ((b >> 1) >> (31u - o));
    const int v = __ldg(lut + (win >> shift));
    dst[i] = static_cast<uint8_t>(v >> 4);
    bitpos += v & 0xF;
  }
  cursors[c] = saturate(bitpos);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Queues the copy of nbytes (a multiple of 4) from 4-byte-aligned global src
// into shared memory at dst + (src & 12), dst 16-byte aligned, so that both
// sides agree modulo 16 and the body moves in 16-byte copies; the head up to
// src's first 16-byte boundary and the tail move 4 bytes at a time.  Returns
// where the staged bytes start.  The block waits with cp_async_wait_all.
__device__ __forceinline__ uint8_t* stage(uint8_t* dst, const uint8_t* src, int64_t nbytes) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 12);
  uint8_t* s = dst + lead;
  const int64_t head = min64((16 - lead) & 15, nbytes);
  const int64_t body_end = head + (nbytes - head) / 16 * 16;
  for (int64_t i = 4 * threadIdx.x; i < head; i += 4 * blockDim.x) cp_async4(s + i, src + i);
  for (int64_t i = head + 16 * threadIdx.x; i < body_end; i += 16 * blockDim.x)
    cp_async16(s + i, src + i);
  for (int64_t i = body_end + 4 * threadIdx.x; i < nbytes; i += 4 * blockDim.x)
    cp_async4(s + i, src + i);
  return s;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool STAGED>
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int64_t i, int64_t nw) {
  // unsigned compare: a negative index (a bad sync entry) reads 0 too
  if (static_cast<uint64_t>(i) >= static_cast<uint64_t>(nw)) return 0u;
  return STAGED ? w[i] : __ldg(w + i);
}

// Decodes n symbols of one sub-stream starting at bit `pos` of the chunk's
// words w[0 .. nw) into dst; returns the bit cursor after the last one.
template <bool STAGED>
__device__ __forceinline__ int64_t decode_run(const uint32_t* w, int64_t nw,
                                              const int16_t* lut, int lut_bits,
                                              int64_t pos, int n, uint8_t* dst) {
  int64_t wi = pos >> 5;
  const uint32_t o = static_cast<uint32_t>(pos & 31);
  uint64_t buf = ((static_cast<uint64_t>(word_at<STAGED>(w, wi, nw)) << 32) |
                  word_at<STAGED>(w, wi + 1, nw)) << o;
  int nbits = 64 - static_cast<int>(o);      // valid bits at the top of buf
  wi += 2;
  const uint32_t shift = 64u - static_cast<uint32_t>(lut_bits);
  auto next = [&]() -> uint32_t {
    if (nbits < 32) {                        // >= 17 left: room for one word
      buf |= static_cast<uint64_t>(word_at<STAGED>(w, wi++, nw)) << (32 - nbits);
      nbits += 32;
    }
    const int v = lut[buf >> shift];
    const int len = v & 0xF;
    buf <<= len;
    nbits -= len;
    pos += len;
    return static_cast<uint32_t>(v >> 4) & 0xFFu;
  };
  int i = 0;
  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), n);
  for (; i < head; ++i) dst[i] = static_cast<uint8_t>(next());
  for (; i + 16 <= n; i += 16) {
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x = next();
      x |= next() << 8;
      x |= next() << 16;
      x |= next() << 24;
      q[j] = x;
    }
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(q[0], q[1], q[2], q[3]);
  }
  for (; i < n; ++i) dst[i] = static_cast<uint8_t>(next());
  return pos;
}

// Every sub-stream of chunk c, one thread each (a loop past blockDim.x), from
// the chunk's words w (staged in shared memory or not) and its staged LUT row.
template <bool STAGED>
__device__ __forceinline__ void decode_chunk(const uint32_t* w, int64_t nw, const int16_t* lut,
                                             int lut_bits, int count, const int32_t* idx,
                                             int sync_every, uint8_t* dst, int32_t* cursor) {
  const int nsub = static_cast<int>((static_cast<int64_t>(count) + sync_every - 1) / sync_every);
  for (int k = threadIdx.x; k < nsub; k += blockDim.x) {
    const int64_t first = static_cast<int64_t>(k) * sync_every;
    const int n = static_cast<int>(min64(sync_every, count - first));
    const int64_t end = decode_run<STAGED>(w, nw, lut, lut_bits, idx[k], n, dst + first);
    if (k == nsub - 1) *cursor = saturate(end);
  }
  if (nsub == 0 && threadIdx.x == 0) *cursor = 0;
}

__global__ void __launch_bounds__(SYNC_THREADS)
huffdecode_sync_kernel(const uint32_t* __restrict__ words,
                       const int64_t* __restrict__ word_off,
                       const int32_t* __restrict__ plane_ids,
                       const int32_t* __restrict__ counts,
                       const int64_t* __restrict__ out_off,
                       const int16_t* __restrict__ luts, int lut_bits,
                       const int64_t* __restrict__ sync_off,
                       const int32_t* __restrict__ sync, int sync_every,
                       int64_t word_cap, uint8_t* __restrict__ out,
                       int32_t* __restrict__ cursors) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x;
  const uint32_t* gw = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const auto* row = reinterpret_cast<const uint8_t*>(
      luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits));
  const auto* lut = reinterpret_cast<const int16_t*>(stage(smem, row, 2LL << lut_bits));
  const int32_t* idx = sync + sync_off[c];
  uint8_t* dst = out + out_off[c];
  // nw is the same for every thread: the block takes one branch
  if (nw <= word_cap) {
    const auto* sw = reinterpret_cast<const uint32_t*>(stage(
        smem + lut_region_bytes(lut_bits), reinterpret_cast<const uint8_t*>(gw), 4 * nw));
    cp_async_wait_all();
    __syncthreads();
    decode_chunk<true>(sw, nw, lut, lut_bits, counts[c], idx, sync_every, dst, cursors + c);
  } else {
    cp_async_wait_all();
    __syncthreads();
    decode_chunk<false>(gw, nw, lut, lut_bits, counts[c], idx, sync_every, dst, cursors + c);
  }
}

}  // namespace

extern "C" {

// words u32[W], word_off i64[n_chunks + 1], plane_ids i32[n_chunks],
// counts i32[n_chunks], out_off i64[n_chunks], luts i16[P, 1 << lut_bits]
// -> out u8[...] (count symbols at each out_off), cursors i32[n_chunks].
// With sync non-null, also the index: sync i32[sync_off[n_chunks]], chunk c's
// entries at sync_off[c] ..., ceil(counts[c] / sync_every) of them.
int huffdecode_chunks_launch(const void* words, const void* word_off,
                             const void* plane_ids, const void* counts,
                             const void* out_off, const void* luts,
                             int lut_bits, int n_chunks, void* out,
                             void* cursors, const void* sync_off, void* sync,
                             int sync_every, void* stream) {
  if (n_chunks > 0) {
    const int threads = 32;
    const int blocks = (n_chunks + threads - 1) / threads;
    huffdecode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int64_t*>(word_off),
        static_cast<const int32_t*>(plane_ids),
        static_cast<const int32_t*>(counts),
        static_cast<const int64_t*>(out_off),
        static_cast<const int16_t*>(luts), lut_bits, n_chunks,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(cursors),
        static_cast<const int64_t*>(sync_off), static_cast<int32_t*>(sync), sync_every);
  }
  return static_cast<int>(cudaGetLastError());
}

// Words a block of the sync kernel stages in shared memory on the current
// device: chunks with more words read them from global memory.
int huffdecode_sync_word_cap(int lut_bits, long long* cap) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const long long words = (optin - lut_region_bytes(lut_bits)) / 4 - 3;
  *cap = words > 0 ? words : 0;
  return static_cast<int>(err);
}

// The same inputs and outputs, decoded from the index sync (entries as the
// serial kernel writes them): one block per chunk on the stream.
int huffdecode_sync_launch(const void* words, const void* word_off,
                           const void* plane_ids, const void* counts,
                           const void* out_off, const void* luts, int lut_bits,
                           int n_chunks, const void* sync_off, const void* sync,
                           int sync_every, void* out, void* cursors, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  long long word_cap = 0;
  const int rc = huffdecode_sync_word_cap(lut_bits, &word_cap);
  if (rc) return rc;
  // the row region, then word_cap words and up to 3 words of lead
  const int smem = lut_region_bytes(lut_bits) + static_cast<int>(4 * (word_cap + 3));
  const cudaError_t err = cudaFuncSetAttribute(
      huffdecode_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  huffdecode_sync_kernel<<<n_chunks, SYNC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(plane_ids),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(out_off),
      static_cast<const int16_t*>(luts), lut_bits,
      static_cast<const int64_t*>(sync_off), static_cast<const int32_t*>(sync), sync_every,
      word_cap, static_cast<uint8_t*>(out), static_cast<int32_t*>(cursors));
  return static_cast<int>(cudaGetLastError());
}

const char* huffdecode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
