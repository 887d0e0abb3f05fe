// Block scans and gap decoders shared by the port's kernels (rows_dot.cu,
// block_scan.cu). One thread owns 8 consecutive entries, 8t..8t+7, of a row
// or packed block; blockDim.x is a multiple of 32.
//
// Stream formats (gaps are u32; the caller prefix-sums them):
//   dotvbyte     gap j has control bit j%8 of byte j/8 (LSB first): 0 means one
//                data byte, 1 two little-endian bytes; its byte offset is the
//                exclusive prefix sum of (bit + 1).
//   streamvbyte  gap j has the 2-bit code in bits 2(j%4).. of byte j/4: code+1
//                little-endian data bytes; offset = exclusive prefix sum.
//   bitpack      gap j is bits [j*w, j*w + w) of the u32 words, LSB first; a
//                gap may straddle two words.
// Entries at or past `n` decode as 0, and no read goes past the stream's width,
// so a malformed stream gives wrong gaps, never an out-of-bounds read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

template <typename V>
__device__ __forceinline__ V warp_inclusive_scan(V x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum over the block (unsigned: modulo 2^32). `scratch`
// holds 32 values. Every thread of the block must call it.
template <typename V>
__device__ __forceinline__ V block_exclusive_scan(V x, V* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const V incl = warp_inclusive_scan(x);
  V excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = V(0);
  if (n_warps == 1) return excl;
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const V w = lane < n_warps ? scratch[lane] : V(0);
    const V ws = warp_inclusive_scan(w);
    V wx = __shfl_up_sync(kFull, ws, 1);
    if (lane == 0) wx = V(0);
    scratch[lane] = wx;
  }
  __syncthreads();
  const V out = excl + scratch[warp];
  __syncthreads();  // scratch is reused by the next scan
  return out;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum over the block; the result is valid in thread 0. Every thread must call it.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  x = warp_sum(x);
  if (n_warps == 1) return x;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) x = warp_sum(lane < n_warps ? scratch[lane] : 0.f);
  __syncthreads();  // scratch is reused by the next sum
  return x;
}

// DotVByte: thread t reads control byte ctrl[t]; a block scan of 8 + popcount
// gives its first data byte. Every thread must call it (the scan).
__device__ __forceinline__ void decode_dotvbyte8(const uint8_t* ctrl, const uint8_t* data,
                                                 int data_w, int t, int n,
                                                 unsigned* scratch, unsigned gap[8]) {
  const bool live = 8 * t < n;
  const int byte = live ? ctrl[t] : 0;
  unsigned off = block_exclusive_scan<unsigned>(live ? 8 + __popc(byte) : 0, scratch);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int two = (byte >> j) & 1;
    unsigned g = 0;
    if (8 * t + j < n && off + two < (unsigned)data_w) {
      g = data[off];
      if (two) g |= (unsigned)data[off + 1] << 8;
    }
    off += 1 + two;
    gap[j] = g;
  }
}

// StreamVByte: thread t reads control bytes 2t and 2t+1; a block scan of the
// 8 gaps' byte lengths gives its first data byte. Every thread must call it.
__device__ __forceinline__ void decode_streamvbyte8(const uint8_t* ctrl, const uint8_t* data,
                                                    int data_w, int t, int n,
                                                    unsigned* scratch, unsigned gap[8]) {
  const bool live = 8 * t < n;
  const unsigned codes = live ? ctrl[2 * t] | ((unsigned)ctrl[2 * t + 1] << 8) : 0u;
  unsigned n_bytes = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) n_bytes += ((codes >> (2 * j)) & 3u) + 1;
  unsigned off = block_exclusive_scan<unsigned>(live ? n_bytes : 0u, scratch);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int len = (int)((codes >> (2 * j)) & 3u) + 1;
    unsigned g = 0;
    if (8 * t + j < n && off + len <= (unsigned)data_w)
      for (int b = 0; b < len; ++b) g |= (unsigned)data[off + b] << (8 * b);
    off += len;
    gap[j] = g;
  }
}

// Bitpack at width w (clamped to [0, 32]); W > 0 fixes the width at compile
// time and ignores `w`. No scan: entry j starts at bit j*w. The straddle word
// is read only where it exists, and the mask is built in 64 bits (w may be 32).
template <int W>
__device__ __forceinline__ void decode_bitpack8(const uint32_t* words, int words_w, int w,
                                                int t, int n, unsigned gap[8]) {
  if constexpr (W > 0) w = W;
  w = min(max(w, 0), 32);
  const uint64_t mask = (1ull << w) - 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = 8 * t + j;
    unsigned g = 0;
    if (e < n) {
      const long long bit = (long long)e * w;
      const long long wi = bit >> 5;
      const int off = (int)(bit & 31);
      const uint64_t lo = wi < words_w ? words[wi] : 0u;
      const uint64_t hi = off && wi + 1 < words_w ? words[wi + 1] : 0u;
      g = (unsigned)(((lo >> off) | (hi << (32 - off))) & mask);
    }
    gap[j] = g;
  }
}

}  // namespace repro
