// Block scans, gap decoders and the query-lane scoring loop shared by the
// port's kernels (rows_dot.cu, block_scan.cu). One thread owns 8 consecutive
// entries, 8t..8t+7, of a row or packed block; blockDim.x is a multiple of
// 32. A decoder's scans run over the whole block, or over one warp when
// `warp` is set (then t is the lane and each warp decodes its own row).
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

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

// Inclusive prefix sum over each group of W lanes (W = 32: the warp; 16: a
// half-warp). Every lane of the warp must call it.
template <typename V, int W = 32>
__device__ __forceinline__ V warp_inclusive_scan(V x) {
  const int lane = threadIdx.x & (W - 1);
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const V y = __shfl_up_sync(kFull, x, o, W);
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

// Exclusive prefix sum over one warp (`warp`) or the whole block. `warp` must
// be uniform across the block; every thread of the scope must call it.
template <typename V>
__device__ __forceinline__ V group_exclusive_scan(V x, V* scratch, bool warp) {
  if (!warp) return block_exclusive_scan<V>(x, scratch);
  const V incl = warp_inclusive_scan(x);
  const V excl = __shfl_up_sync(kFull, incl, 1);
  return (threadIdx.x & 31) ? excl : V(0);
}

// -- one summation order for a (query, row) dot -----------------------------
//
// Every scoring stage of rows_dot.cu sums a dot in this order, so a score does
// not depend on the stage (and so on the batch) that computed it:
//   - each product is rounded alone (__fmul_rn: never contracted to an FMA);
//   - group g is entries 8g..8g+7, summed left to right from +0.f (__fadd_rn);
//     a dead entry adds nothing;
//   - the groups combine by the balanced pairwise tree over g, aligned at
//     powers of two: (0,1), (2,3), ..., then pairs of pairs.
// A sum that starts from +0.f is never -0.f under round-to-nearest, so a +0.f
// (a dead entry, an empty group, a padding group or lane) adds exactly nothing
// and the tree may be padded to any power of two.

// The aligned pairwise tree over the W lanes of each group of W (xor offsets
// ascending: lanes 2k and 2k+1 first); every lane gets the same bits. Every
// lane of the warp must call it.
template <int W = 32>
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < W; o <<= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The aligned pairwise tree over items pushed one at a time: slot l holds a
// complete subtree of 2^l items while bit l of the count is set, so K slots
// take fewer than 2^K items.
template <int K>
struct PairStack {
  float slot[K];

  // Push x as item n (n items already pushed, n + 1 < 2^K).
  __device__ __forceinline__ void push(float x, unsigned n) {
    bool done = false;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (done) continue;
      if ((n >> l) & 1u) {
        x = __fadd_rn(slot[l], x);
      } else {
        slot[l] = x;
        done = true;
      }
    }
  }

  // The tree over the n items pushed.
  __device__ __forceinline__ float total(unsigned n) const {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < K; ++l)
      if ((n >> l) & 1u) acc = __fadd_rn(slot[l], acc);
    return acc;
  }
};

// Sum over the block as the aligned tree over its threads (warp trees, then
// the tree over warps); the result is valid in thread 0. Every thread must
// call it.
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
                                                 unsigned* scratch, unsigned gap[8],
                                                 bool warp = false) {
  const bool live = 8 * t < n;
  const int byte = live ? ctrl[t] : 0;
  unsigned off = group_exclusive_scan<unsigned>(live ? 8 + __popc(byte) : 0, scratch, warp);
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
                                                    unsigned* scratch, unsigned gap[8],
                                                    bool warp = false) {
  const bool live = 8 * t < n;
  const unsigned codes = live ? ctrl[2 * t] | ((unsigned)ctrl[2 * t + 1] << 8) : 0u;
  unsigned n_bytes = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) n_bytes += ((codes >> (2 * j)) & 3u) + 1;
  unsigned off = group_exclusive_scan<unsigned>(live ? n_bytes : 0u, scratch, warp);
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

// -- warp-scope decoders over 16-byte loads ------------------------------------
//
// The resident-query block scan and the row-warp rows kernel give a whole row
// or packed block to one warp, in chunks of 256 entries: lane l of chunk k
// owns the group g = 32k + l, entries 8g..8g+7. The byte codecs carry the
// chunk's first data byte (`base`, uniform across the warp) from one chunk to
// the next, so one warp scan per chunk gives every lane its offset. A lane's
// data bytes (at most 16 for DotVByte, 32 for StreamVByte and bitpack) arrive
// as a window of aligned 16-byte loads where `vec` holds (the stream's base
// 16-byte aligned and its row width a multiple of 16 bytes), else byte by
// byte; bytes at or past the row's width read as 0 either way, and a byte
// gap that does not fit the row decodes as 0, as above.

// Bytes [off, off + 4N) of a row `w` bytes wide, as N little-endian words.
template <int N>
__device__ __forceinline__ void load_window(const uint8_t* row, unsigned w, unsigned off,
                                            bool vec, uint32_t out[N]) {
  if (vec) {
    constexpr int kLoads = (4 * N + 15) / 16 + 1;
    uint32_t raw[4 * kLoads];
    const unsigned a0 = off & ~15u;
#pragma unroll
    for (int c = 0; c < kLoads; ++c) {
      const unsigned a = a0 + 16u * c;
      const uint4 x =
          a < w ? __ldg(reinterpret_cast<const uint4*>(row + a)) : make_uint4(0, 0, 0, 0);
      raw[4 * c] = x.x;
      raw[4 * c + 1] = x.y;
      raw[4 * c + 2] = x.z;
      raw[4 * c + 3] = x.w;
    }
    // realign by off % 16 bytes: whole words by selects, the rest by funnel shifts
    const unsigned r = off & 15u, q = r >> 2, sh = 8 * (r & 3u);
    uint32_t sel[N + 1];
#pragma unroll
    for (int i = 0; i <= N; ++i)
      sel[i] = q == 0 ? raw[i] : q == 1 ? raw[i + 1] : q == 2 ? raw[i + 2] : raw[i + 3];
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __funnelshift_r(sel[i], sel[i + 1], sh);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const unsigned p = off + 4 * i + b;
        if (p < w) x |= (uint32_t)row[p] << (8 * b);
      }
      out[i] = x;
    }
  }
}

// Drop the low s bits (0 <= s <= 32) of an N-word window.
template <int N>
__device__ __forceinline__ void shift_window(uint32_t a[N], unsigned s) {
#pragma unroll
  for (int i = 0; i + 1 < N; ++i) a[i] = __funnelshift_rc(a[i], a[i + 1], s);
  a[N - 1] = s >= 32 ? 0u : a[N - 1] >> s;
}

// DotVByte, warp scope (groups of W lanes; W = 16 decodes two rows a warp):
// lane's group g reads control byte ctrl[g]; `base` is the chunk's first data
// byte and moves past the chunk. Every lane of the warp must call it.
template <int W = 32>
__device__ __forceinline__ void warp_decode_dotvbyte8(const uint8_t* ctrl, const uint8_t* data,
                                                      int data_w, bool vec, int g, int n,
                                                      unsigned& base, unsigned gap[8]) {
  const bool live = 8 * g < n;
  const int byte = live ? __ldg(ctrl + g) : 0;
  const unsigned len = live ? 8 + __popc(byte) : 0;
  const unsigned incl = warp_inclusive_scan<unsigned, W>(len);
  unsigned off = base + incl - len;
  base += __shfl_sync(kFull, incl, W - 1, W);
  uint32_t win[4] = {0, 0, 0, 0};
  if (live) load_window<4>(data, (unsigned)data_w, off, vec, win);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned two = (byte >> j) & 1;
    gap[j] = 8 * g + j < n && off + 1 + two <= (unsigned)data_w
                 ? win[0] & (two ? 0xffffu : 0xffu) : 0u;
    off += 1 + two;
    shift_window<4>(win, 8 + 8 * two);
  }
}

// StreamVByte, warp scope: lane's group g reads control bytes 2g and 2g+1.
template <int W = 32>
__device__ __forceinline__ void warp_decode_streamvbyte8(const uint8_t* ctrl,
                                                         const uint8_t* data, int data_w,
                                                         bool vec, int g, int n,
                                                         unsigned& base, unsigned gap[8]) {
  const bool live = 8 * g < n;
  const unsigned codes =
      live ? __ldg(ctrl + 2 * g) | ((unsigned)__ldg(ctrl + 2 * g + 1) << 8) : 0u;
  unsigned len = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) len += ((codes >> (2 * j)) & 3u) + 1;
  len = live ? len : 0u;
  const unsigned incl = warp_inclusive_scan<unsigned, W>(len);
  unsigned off = base + incl - len;
  base += __shfl_sync(kFull, incl, W - 1, W);
  uint32_t win[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) load_window<8>(data, (unsigned)data_w, off, vec, win);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned k = ((codes >> (2 * j)) & 3u) + 1;  // bytes of gap j
    gap[j] = 8 * g + j < n && off + k <= (unsigned)data_w
                 ? (k == 4 ? win[0] : win[0] & ((1u << (8 * k)) - 1)) : 0u;
    off += k;
    shift_window<8>(win, 8 * k);
  }
}

// Bitpack at width w (clamped to [0, 32]; W > 0 fixes it at compile time), warp
// scope in form only (no scan): group g's 8 gaps are the w bytes from byte g*w
// of the row's words (`words_w` bytes wide); words past the row read as 0.
template <int W>
__device__ __forceinline__ void warp_decode_bitpack8(const uint8_t* words, int words_w, int w,
                                                     bool vec, int g, int n, unsigned gap[8]) {
  if constexpr (W > 0) w = W;
  w = min(max(w, 0), 32);
  const uint32_t mask = w == 32 ? 0xffffffffu : (1u << w) - 1;
  uint32_t win[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (8 * g < n) load_window<8>(words, (unsigned)words_w, (unsigned)(g * w), vec, win);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gap[j] = 8 * g + j < n ? win[0] & mask : 0u;
    shift_window<8>(win, (unsigned)w);
  }
}

// Eight consecutive elements from p, widened; with `vec`, p is aligned to the
// eight elements' size (at most 16 bytes) and read in one or two vector loads.
__device__ __forceinline__ void load8(const int32_t* p, bool vec, int out[8]) {
  if (vec) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p)),
               y = __ldg(reinterpret_cast<const int4*>(p) + 1);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
    out[4] = y.x, out[5] = y.y, out[6] = y.z, out[7] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = p[j];
  }
}

__device__ __forceinline__ void load8(const int8_t* p, bool vec, int out[8]) {
  if (vec) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = (int)(int8_t)(((j < 4 ? x.x : x.y) >> (8 * (j & 3))) & 0xff);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = p[j];
  }
}

__device__ __forceinline__ void load8(const float* p, bool vec, float out[8]) {
  if (vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p)),
                 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
    out[4] = y.x, out[5] = y.y, out[6] = y.z, out[7] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = p[j];
  }
}

__device__ __forceinline__ void load8(const __half* p, bool vec, float out[8]) {
  if (vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = __half2float(__ushort_as_half((unsigned short)(w[j >> 1] >> (16 * (j & 1)))));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = __half2float(p[j]);
  }
}

__device__ __forceinline__ void load8(const uint8_t* p, bool vec, float out[8]) {
  if (vec) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = (float)(((j < 4 ? x.x : x.y) >> (8 * (j & 3))) & 0xff);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = (float)p[j];
  }
}

// Ask L2 for the 128-byte line at p, without waiting or using a register.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Whether a stream's rows, `row_bytes` apart from `base` on, are 16-byte
// aligned: the condition of the `vec` paths above.
inline bool rows_aligned(const void* base, long long row_bytes) {
  return ((uintptr_t)base & 15) == 0 && row_bytes % 16 == 0;
}

// -- the query-lane stage ------------------------------------------------------
//
// A decoded entry: its component and its scaled value. A dead entry (padding,
// or a component outside the vocabulary) is {0, 0.f}: it gathers Qt row 0 and
// adds nothing.
struct __align__(8) Ent {
  int c;
  float v;
};

// Queries a block scores per launch column (grid.y): lane l of a warp owns
// queries q0 + l + 32k, k < kLaneQueries. A tile of Qt (dim x 128 f32, 15.6 MB
// at dim 30,522) stays in the 50 MB L2 at any batch size.
constexpr int kQueryTile = 128;
constexpr int kLaneQueries = kQueryTile / 32;

// acc[k] += Qt[c, q0 + lane + 32k] * v over a run of n entries. Qt is the
// query batch transposed, [dim, nq]: every lane reads the same entry (a
// shared-memory broadcast) and its own queries of that entry's Qt row, so one
// entry costs one coalesced 128-byte read per k and no cross-lane step. nt,
// the queries of this tile, is uniform across the warp. Products and sums are
// rounded as plain operations (no fused multiply-add), as the plain versions
// round them.
__device__ __forceinline__ void score_run(const Ent* ent, int n, const float* Qt, int nq,
                                          int q0, int nt, float acc[kLaneQueries]) {
  const int lane = threadIdx.x & 31;
  const float* base = Qt + q0 + lane;
#pragma unroll 4
  for (int e = 0; e < n; ++e) {
    const Ent x = ent[e];
    const float* row = base + (size_t)(unsigned)x.c * nq;
#pragma unroll
    for (int k = 0; k < kLaneQueries; ++k)
      if (lane + 32 * k < nt) acc[k] = __fadd_rn(acc[k], __fmul_rn(row[32 * k], x.v));
  }
}

}  // namespace repro
