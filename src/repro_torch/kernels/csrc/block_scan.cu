// Full-scan block kernel: a query batch over every packed block, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference's full scan, with the
// codec tile functions that plug into them (dotvbyte_dot.py, streamvbyte_dot.py,
// bitpack_dot.py):
//   repro/kernels/tiles.py::dma_block_scan (pl.pallas_call at tiles.py:187), the
//     single-query scan behind {dotvbyte,streamvbyte,bitpack}_block_scores and
//     the static-width bitpack_block_scores_w;
//   repro/kernels/tiles.py::grid_batch_scores (pl.pallas_call at tiles.py:225),
//     the queries x tiles grid behind *_block_scores_batch.
// nq == 1 is the single-query scan and nq > 1 the batched one; either way each
// block is decoded once and scored for every query. It computes what the tile
// program computes; it is not a carry-over of the TPU's DMA pipeline or grid.
//
// Contract (checked by the Python wrapper, kernels/block_scan.py):
//   Q          f32 [nq, dim]          dense queries (any dim; not lane-padded)
//   p0, p1     dotvbyte     ctrl u8 [B, p0_w >= T/8], data u8 [B, p1_w]
//              streamvbyte  ctrl u8 [B, p0_w >= T/4], data u8 [B, p1_w]
//              bitpack      words u32 [B, p0_w]; widths i32 [B] under the
//                           per-block width, none under a static width
//   seg        i32 or i8 [B, T]       slot of each entry, -1 for padding
//   start_pos  i32 [B, D]             first entry of each slot
//   start_abs  i32 [B, D]             absolute first component of each slot
//   vals       f32, f16 or u8 [B, T]  values as stored
//   out        f32 [nq, B, D]         slot scores
// Per block (scoring.py components_from_gaps and block_slot_scores of the
// reference):
//   t_i    = inclusive prefix sum of the block's gaps. It runs across every
//            fragment of the block and may pass 2^31 at wide vocabularies, so
//            it is kept in unsigned arithmetic (modulo 2^32); the difference
//            below is exact all the same.
//   comp_i = start_abs[s] + t_i - t[start_pos[s]],  s = min(seg_i, D - 1)
//   prod_i = Q[q, comp_i] * (vals_i * scale); 0 where seg_i < 0 or comp_i lies
//            outside [0, dim)
//   slot d = sum of prod over [start_pos[d], end_d): end_d = start_pos[d + 1]
//            where that is larger, else T. Slot 0 is always used, a later slot
//            iff start_pos[d] > 0; an unused slot scores 0.
// The scatter of slot scores to documents stays outside the kernel
// (scoring.scatter_block_scores, an index_add_), as the reference keeps it
// outside Pallas.
//
// Design (a simple kernel that is right first): one thread block per packed
// block, T/8 threads rounded up to a warp; thread t owns entries 8t..8t+7.
//   1. decode the thread's 8 gaps (gaps.cuh; the byte codecs scan their byte
//      counts, bitpack reads bit j*w directly);
//   2. a block scan of the gap sums gives t, which goes to shared memory so
//      every entry can read t[start_pos[s]]; each entry's component and scaled
//      value then stay in registers for the whole query batch;
//   3. per query: gather Q[q, comp], multiply, and a block scan of the products
//      writes their exclusive prefix sums cz[0..T] over the same shared memory;
//      slot d's score is cz[end_d] - cz[start_d].
// Products and sums are rounded as plain operations (__fmul_rn, __fadd_rn), so
// every product equals the plain version's; only the order of the f32 sums
// differs.
// What bounds it: the bytes of the streams and the [nq, B, D] scores at the
// main path's sizes; this first version is far from that, latency-bound on the
// per-query block scan and its two barriers, with the Q gathers served from
// L2 (Q is 7.8 MB at nq 64, dim 30,522). Several blocks per thread block, a
// warp per query and a scatter fused into the epilogue are later work.
//
// Template parameters: CODE (0 dotvbyte, 1 streamvbyte, 2 bitpack at the
// per-block width, 2 + W bitpack at the static width W = 1..32), VT the value
// storage (float, __half, uint8_t) and ST the seg storage (int32_t, int8_t):
// 210 instantiations. So that they compile in parallel, the library is built
// in KERNEL_PARTS parts (kernels/build.py); part p holds the codes with
// CODE % KERNEL_PARTS == p and refuses the others.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "gaps.cuh"

#ifndef KERNEL_PART
#define KERNEL_PART 0
#endif
#ifndef KERNEL_PARTS
#define KERNEL_PARTS 1
#endif

namespace {

using namespace repro;

constexpr int kDotVByte = 0, kStreamVByte = 1, kBitpack = 2;
constexpr int kCodes = kBitpack + 1 + 32;
enum Vals { kValsF32 = 0, kValsF16 = 1, kValsU8 = 2 };
enum Seg { kSegI32 = 0, kSegI8 = 1 };
constexpr int kMaxT = 8 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

struct Args {
  const float* Q;
  const void* p0;
  const void* p1;
  const void* seg;
  const int* sp;
  const int* sa;
  const void* vals;
  float* out;
  int nq, dim, B, T, D, p0_w, p1_w;
  float scale;
};

// This thread's 8 gaps of block b. Every thread of the block must call it.
template <int CODE>
__device__ __forceinline__ void decode_block(const Args& a, size_t b, int t,
                                             unsigned* scratch, unsigned gap[8]) {
  if constexpr (CODE == kDotVByte || CODE == kStreamVByte) {
    const uint8_t* ctrl = static_cast<const uint8_t*>(a.p0) + b * a.p0_w;
    const uint8_t* data = static_cast<const uint8_t*>(a.p1) + b * a.p1_w;
    if constexpr (CODE == kDotVByte)
      decode_dotvbyte8(ctrl, data, a.p1_w, t, a.T, scratch, gap);
    else
      decode_streamvbyte8(ctrl, data, a.p1_w, t, a.T, scratch, gap);
  } else {
    const uint32_t* words = static_cast<const uint32_t*>(a.p0) + b * a.p0_w;
    const int w = CODE == kBitpack ? static_cast<const int*>(a.p1)[b] : 0;
    decode_bitpack8<CODE - kBitpack>(words, a.p0_w, w, t, a.T, gap);
  }
}

template <int CODE, typename VT, typename ST>
__global__ void block_scan_kernel(const Args a) {
  extern __shared__ unsigned smem[];  // T + 1 words: t, then the products' prefix sums
  __shared__ unsigned iscratch[32];
  __shared__ float fscratch[32];
  const size_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = a.T, D = a.D;
  const int* sp = a.sp + b * D;
  const int* sa = a.sa + b * D;
  const ST* seg = static_cast<const ST*>(a.seg) + b * T;
  const VT* vals = static_cast<const VT*>(a.vals) + b * T;

  // 1-2. gaps -> inclusive prefix sum t (modulo 2^32), shared
  unsigned tc[8];
  decode_block<CODE>(a, b, t, iscratch, tc);
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    run += tc[j];
    tc[j] = run;
  }
  const unsigned base = block_exclusive_scan<unsigned>(run, iscratch);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    tc[j] += base;
    if (8 * t + j < T) smem[8 * t + j] = tc[j];
  }
  __syncthreads();

  // rebase every live entry; dead ones keep component 0 and value 0
  int comp[8];
  float val[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = 8 * t + j;
    comp[j] = 0;
    val[j] = 0.f;
    if (e < T) {
      const int s = (int)seg[e];
      if (s >= 0) {
        const int sc = min(s, D - 1);
        const unsigned c = (unsigned)sa[sc] + tc[j] - smem[min(max(sp[sc], 0), T - 1)];
        if (c < (unsigned)a.dim) {
          comp[j] = (int)c;
          val[j] = __fmul_rn(to_float(vals[e]), a.scale);
        }
      }
    }
  }
  __syncthreads();  // smem now holds the products' prefix sums

  // 3. every query against this block's decoded entries
  float* cz = reinterpret_cast<float*>(smem);
  for (int q = 0; q < a.nq; ++q) {
    const float* qrow = a.Q + (size_t)q * a.dim;
    float incl[8], acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(qrow[comp[j]], val[j]));
      incl[j] = acc;
    }
    const float off = block_exclusive_scan<float>(acc, fscratch);
    if (t == 0) cz[0] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * t + j < T) cz[8 * t + j + 1] = __fadd_rn(off, incl[j]);
    __syncthreads();
    float* out = a.out + ((size_t)q * a.B + b) * D;
    for (int d = t; d < D; d += blockDim.x) {
      const int s0 = sp[d];
      const int nxt = d + 1 < D ? sp[d + 1] : 0;
      const int end = nxt > s0 ? nxt : T;
      const bool used = d == 0 || s0 > 0;
      out[d] = used ? cz[min(max(end, 0), T)] - cz[min(max(s0, 0), T)] : 0.f;
    }
    __syncthreads();  // the next query rewrites cz
  }
}

template <int CODE, typename VT, typename ST>
void launch(const Args& a, cudaStream_t stream) {
  const int threads = ((a.T / 8 + 31) / 32) * 32;
  const size_t smem = (size_t)(a.T + 1) * sizeof(unsigned);
  block_scan_kernel<CODE, VT, ST><<<(unsigned)a.B, threads, smem, stream>>>(a);
}

template <int CODE>
int launch_code(const Args& a, int vals_t, int seg_t, cudaStream_t stream) {
  if constexpr (CODE % KERNEL_PARTS != KERNEL_PART) {
    return (int)cudaErrorInvalidValue;  // compiled into another part
  } else {
    switch (vals_t * 2 + seg_t) {
      case kValsF32 * 2 + kSegI32: launch<CODE, float, int32_t>(a, stream); return 0;
      case kValsF32 * 2 + kSegI8: launch<CODE, float, int8_t>(a, stream); return 0;
      case kValsF16 * 2 + kSegI32: launch<CODE, __half, int32_t>(a, stream); return 0;
      case kValsF16 * 2 + kSegI8: launch<CODE, __half, int8_t>(a, stream); return 0;
      case kValsU8 * 2 + kSegI32: launch<CODE, uint8_t, int32_t>(a, stream); return 0;
      case kValsU8 * 2 + kSegI8: launch<CODE, uint8_t, int8_t>(a, stream); return 0;
    }
    return (int)cudaErrorInvalidValue;
  }
}

template <int... C>
int dispatch(int code, const Args& a, int vals_t, int seg_t, cudaStream_t stream,
             std::integer_sequence<int, C...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((code == C ? (rc = launch_code<C>(a, vals_t, seg_t, stream)) : 0), ...);
  return rc;
}

}  // namespace

extern "C" {

// Launch variant (code, vals_t, seg_t) on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take or a variant this part does not hold. The numbers are the enums above.
int block_scan(int code, int vals_t, int seg_t, const void* Q, const void* p0,
               const void* p1, const void* seg, const void* start_pos,
               const void* start_abs, const void* vals, void* out, int nq, int dim, int B,
               int T, int D, int p0_w, int p1_w, float scale, void* stream) {
  if (code < 0 || code >= kCodes || T <= 0 || T % 128 || T > kMaxT || D <= 0 || B <= 0 ||
      nq <= 0 || dim <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)Q, p0, p1, seg, (const int*)start_pos, (const int*)start_abs,
               vals, (float*)out, nq, dim, B, T, D, p0_w, p1_w, scale};
  const int rc = dispatch(code, a, vals_t, seg_t, (cudaStream_t)stream,
                          std::make_integer_sequence<int, kCodes>{});
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* block_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
