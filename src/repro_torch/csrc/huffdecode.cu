// Canonical-Huffman chunk decode (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel huffdecode_chunks_multi in
// src/repro/kernels/huffdecode.py (bodies _decode_block and
// _huffdecode_multi_kernel).  Each HUFF chunk of a ZNN1 stream is an
// independent MSB-first canonical-code bitstream; every step takes a
// lut_bits-wide window at the chunk's bit cursor (across two big-endian
// words), gathers one fused (sym << 4) | len entry from the chunk's plane
// row of the stacked LUTs, writes sym and advances the cursor by len.
// (The TPU kernel fuses (sym << 8) | len into int32; len <= 15 fits four
// bits, so here an entry is an int16 and a resident row is half the size.)
//
// What bounds it on the H100: latency, not bytes.  Symbol i+1's position
// depends on symbol i's code length, so a chunk is one serial chain of
// (word load -> LUT gather -> cursor add), and a bf16 weight's exponent
// plane has only a few dozen chunks at the default 256 KiB chunking.  The
// kernel therefore runs a few dozen threads and sits far above its
// bytes-over-bandwidth bound.  Making it fast (more chunks per tensor,
// several tensors per launch, shared-memory LUTs, a register bit buffer)
// is later work; this version is the simple one that is right.
//
// Design:
//  * one thread per chunk; chunks of every plane of a tensor ride one
//    launch, each gathering from its own LUT row (plane_ids; the caller
//    stacks rows only for planes that have HUFF chunks);
//  * words are packed compactly: chunk c owns words
//    [word_off[c], word_off[c+1]), so the resident feed holds compressed
//    bytes only, not chunk-capacity-padded buffers;
//  * a read past a chunk's own words yields 0 (the zero padding a
//    capacity-padded layout would hold) and never leaves the chunk, so a
//    corrupt or truncated payload decodes garbage that the host-side
//    cursor check rejects, never an out-of-bounds read;
//  * symbols go straight to out[out_off[c] ...], the chunk's place in its
//    output plane, so the caller needs no per-chunk slice or concatenate;
//  * the final cursor only saturates at INT32_MAX.  It must not be clamped
//    to the chunk's own (compact) word capacity: that capacity ends inside
//    the payload's last word, so a runaway cursor clamped there could land
//    in the payload's final byte and pass the host check.  On valid
//    streams cursors equal the reference's exactly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void huffdecode_kernel(const uint32_t* __restrict__ words,
                                  const int64_t* __restrict__ word_off,
                                  const int32_t* __restrict__ plane_ids,
                                  const int32_t* __restrict__ counts,
                                  const int64_t* __restrict__ out_off,
                                  const int16_t* __restrict__ luts,
                                  int lut_bits, int n_chunks,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ cursors) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const uint32_t* w = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const int16_t* lut = luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits);
  uint8_t* dst = out + out_off[c];
  const int count = counts[c];
  const uint32_t shift = 32u - static_cast<uint32_t>(lut_bits);

  int64_t bitpos = 0;
  for (int i = 0; i < count; ++i) {
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
  cursors[c] = static_cast<int32_t>(bitpos < INT32_MAX ? bitpos : INT32_MAX);
}

}  // namespace

extern "C" {

// words u32[W], word_off i64[n_chunks + 1], plane_ids i32[n_chunks],
// counts i32[n_chunks], out_off i64[n_chunks], luts i16[P, 1 << lut_bits]
// -> out u8[...] (count symbols at each out_off), cursors i32[n_chunks].
int huffdecode_chunks_launch(const void* words, const void* word_off,
                             const void* plane_ids, const void* counts,
                             const void* out_off, const void* luts,
                             int lut_bits, int n_chunks, void* out,
                             void* cursors, void* stream) {
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
        static_cast<uint8_t*>(out), static_cast<int32_t*>(cursors));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* huffdecode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
