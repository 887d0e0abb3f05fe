// Fused candidate-row gather + decode + dequant + rescore, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rows_dot.py::rows_scores_batch
// (body `_kernel`, pl.pallas_call at rows_dot.py:190) for all sixteen of its
// compile-time variants: row codec (`_comps_*`) x value codec (`_dequant_row`).
// It computes what `_kernel` computes; it is not a block-by-block carry-over of
// the TPU grid.
//
// Contract (checked by the Python wrapper, kernels/rows_dot.py):
//   Q     f32 [nq, dim]       dense queries
//   docs  i32 [nd, C]         candidate row ids; nd == 1 shares one set with
//                             every query (flat), nd == nq gives each query
//                             its own set (Seismic)
//   vals  [n_rows, vals_w]    values as stored under vq f16 (f32, f16 or fixedu8
//                             u8; vals_w = L) or u8 codes (u8_sq: vals_w = L;
//                             u4_sq and pq: vals_w = L/2)
//   nnz   i32 [n_rows]        live entries per row
//   p0,p1 codec payload:      uncompressed  comps i32 [n_rows, p0_w]
//                             dotvbyte      ctrl u8 [n_rows, p0_w >= L/8],
//                                           data u8 [n_rows, p1_w]
//                             streamvbyte   ctrl u8 [n_rows, p0_w >= L/4],
//                                           data u8 [n_rows, p1_w]
//                             bitpack       words u32 [n_rows, p0_w],
//                                           widths i32 [n_rows]
//   v0,v1 value payload:      u8_sq/u4_sq   lo f32 [n_rows], step f32 [n_rows]
//                             pq            codebook f32 [256 * 2]
//   out   f32 [nq, C]         out[q, i] = sum_{j < nnz} Q[q, comp_j] * val_j * scale
// where L is the logical row capacity and row n_rows-1 is the all-zero sentinel.
//
// Row formats (the first gap of a row is absolute, so components are the
// inclusive prefix sum of the gaps):
//   dotvbyte     gap j has control bit j%8 of byte j/8 (LSB first): 0 means one
//                data byte, 1 two little-endian bytes; its byte offset is the
//                exclusive prefix sum of (bit + 1).
//   streamvbyte  gap j has the 2-bit code in bits 2(j%4).. of byte j/4: code+1
//                little-endian data bytes; offset = exclusive prefix sum.
//   bitpack      gap j is bits [j*w, j*w + w) of the row's u32 words, LSB
//                first, w = widths[row]; a gap may straddle two words.
//   uncompressed absolute components, no decode.
// The decoders and block scans live in gaps.cuh, shared with block_scan.cu.
// Values: under vq f16 the stored value converted to f32 (the reference casts
// whatever dtype is stored; the wrapper's scale is 1/32 for fixedu8); u8_sq lo + code * step; u4_sq the same on 4-bit codes,
// entry 2i in the low nibble of byte i; pq entry j is codebook[code[j/2]*2 + j%2].
// The dequant multiply and add are rounded separately (__fmul_rn, __fadd_rn),
// so every value equals the plain torch version's bit for bit; only the order
// of the final f32 sums differs.
//
// Design (a simple kernel that is right first): one thread block per
// (candidate, set), L/8 threads (rounded up to a warp); thread t owns entries
// 8t..8t+7:
//   1. byte codecs: a block-wide exclusive scan of the thread's data-byte count
//      gives the offset of its first data byte (bitpack needs no scan: entry j
//      starts at bit j*w);
//   2. the thread decodes its 8 gaps into registers, reading no byte beyond
//      the stream's row width;
//   3. a second block scan of the per-thread gap sums gives absolute
//      components (uncompressed reads them directly and skips 1-3);
//   4. the thread dequantizes its 8 values (the PQ codebook is staged in
//      shared memory once per block) and, for each query of the set, gathers
//      Q[q, comp], multiplies and a block reduction writes the score. With
//      nd == 1 the decoded row stays in registers across the whole query batch
//      (decode once, score many).
// The work is bound by bytes (the gathered rows, Q and the scores); this first
// version leaves the row gathers as plain loads. cp.async/TMA row staging,
// several rows per block and vector loads are later work.
//
// Ids outside [0, n_rows) score 0, and a decoded component outside [0, dim)
// contributes 0, so a corrupt index never reads outside its buffers.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gaps.cuh"

namespace {

using namespace repro;

enum Codec { kUncompressed = 0, kDotVByte = 1, kStreamVByte = 2, kBitpack = 3 };
enum Vq { kF16 = 0, kU8 = 1, kU4 = 2, kPq = 3 };
// value storage under vq f16 (the reference's raw-dtype values): the
// ForwardIndex's f32, f16 or fixedu8 values as stored
enum Vals { kValsF32 = 0, kValsF16 = 1, kValsU8 = 2 };

constexpr int kPqEntries = 256 * 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

struct Args {
  const float* Q;
  const int* docs;
  const void* vals;
  const int* nnz;
  const void* p0;
  const void* p1;
  const float* v0;
  const float* v1;
  float* out;
  int nq, dim, nd, C, n_rows, L, vals_w, p0_w, p1_w;
  float scale;
};

// Decode this thread's 8 gaps (entries 8t..8t+7, dead ones read as 0) into
// `gap`. Every thread of the block must call it (the byte codecs scan).
template <int CODEC>
__device__ __forceinline__ void decode_gaps(const Args& a, int doc, int nnz, int t,
                                            unsigned* iscratch, unsigned gap[8]) {
  if constexpr (CODEC == kDotVByte || CODEC == kStreamVByte) {
    const uint8_t* ctrl = static_cast<const uint8_t*>(a.p0) + (size_t)doc * a.p0_w;
    const uint8_t* row = static_cast<const uint8_t*>(a.p1) + (size_t)doc * a.p1_w;
    if constexpr (CODEC == kDotVByte)
      decode_dotvbyte8(ctrl, row, a.p1_w, t, nnz, iscratch, gap);
    else
      decode_streamvbyte8(ctrl, row, a.p1_w, t, nnz, iscratch, gap);
  } else {  // kBitpack
    const uint32_t* words = static_cast<const uint32_t*>(a.p0) + (size_t)doc * a.p0_w;
    decode_bitpack8<0>(words, a.p0_w, static_cast<const int*>(a.p1)[doc], t, nnz, gap);
  }
}

// VT is the value storage type under vq f16 (float, __half or uint8_t);
// the quantized vqs read u8 codes.
template <int VQ, typename VT>
__device__ __forceinline__ float dequant(const Args& a, int doc, int e,
                                         const float* cb, float lo, float step) {
  const uint8_t* codes = static_cast<const uint8_t*>(a.vals) + (size_t)doc * a.vals_w;
  if constexpr (VQ == kF16)
    return to_float(static_cast<const VT*>(a.vals)[(size_t)doc * a.vals_w + e]);
  if constexpr (VQ == kU8) return __fadd_rn(lo, __fmul_rn((float)codes[e], step));
  if constexpr (VQ == kU4) {
    const int byte = codes[e >> 1];
    return __fadd_rn(lo, __fmul_rn((float)((e & 1) ? byte >> 4 : byte & 15), step));
  }
  return cb[codes[e >> 1] * 2 + (e & 1)];  // kPq
}

template <int CODEC, int VQ, typename VT = __half>
__global__ void rows_dot_kernel(const Args a) {
  __shared__ unsigned iscratch[32];
  __shared__ float fscratch[32];
  __shared__ float cb[VQ == kPq ? kPqEntries : 1];
  const int c = blockIdx.x;
  const int set = blockIdx.y;
  const int t = threadIdx.x;

  const int doc = a.docs[(size_t)set * a.C + c];
  const bool in_range = doc >= 0 && doc < a.n_rows;
  const int nnz = in_range ? min(max(a.nnz[doc], 0), a.L) : 0;
  const int q_lo = a.nd == 1 ? 0 : set;
  const int q_hi = a.nd == 1 ? a.nq : set + 1;
  if (nnz == 0) {  // block-uniform: the whole block leaves together
    if (t == 0)
      for (int q = q_lo; q < q_hi; ++q) a.out[(size_t)q * a.C + c] = 0.f;
    return;
  }
  if constexpr (VQ == kPq) {
    for (int i = t; i < kPqEntries; i += blockDim.x) cb[i] = a.v0[i];
    __syncthreads();
  }

  // 1-3. absolute components of this thread's 8 entries
  int comp[8];
  if constexpr (CODEC == kUncompressed) {
    const int* row = static_cast<const int*>(a.p0) + (size_t)doc * a.p0_w;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 8 * t + j;
      comp[j] = e < nnz && e < a.p0_w ? row[e] : 0;
    }
  } else {
    unsigned gap[8];
    decode_gaps<CODEC>(a, doc, nnz, t, iscratch, gap);
    unsigned run = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      run += gap[j];
      gap[j] = run;
    }
    const unsigned base = block_exclusive_scan<unsigned>(run, iscratch);
#pragma unroll
    for (int j = 0; j < 8; ++j) comp[j] = (int)(gap[j] + base);
  }

  // 4. dequantize, then score against every query of the set
  const float lo = (VQ == kU8 || VQ == kU4) ? a.v0[doc] : 0.f;
  const float step = (VQ == kU8 || VQ == kU4) ? a.v1[doc] : 0.f;
  float val[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = 8 * t + j;
    val[j] = e < nnz ? dequant<VQ, VT>(a, doc, e, cb, lo, step) * a.scale : 0.f;
  }
  for (int q = q_lo; q < q_hi; ++q) {
    const float* qrow = a.Q + (size_t)q * a.dim;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * t + j < nnz && (unsigned)comp[j] < (unsigned)a.dim) acc += qrow[comp[j]] * val[j];
    acc = block_sum(acc, fscratch);
    if (t == 0) a.out[(size_t)q * a.C + c] = acc;
  }
}

template <int CODEC, int VQ, typename VT = __half>
void launch(const Args& a, int threads, cudaStream_t stream) {
  rows_dot_kernel<CODEC, VQ, VT><<<dim3((unsigned)a.C, (unsigned)a.nd), threads, 0, stream>>>(a);
}

template <int CODEC>
int launch_vq(int vq, int vals_t, const Args& a, int threads, cudaStream_t stream) {
  if (vq == kF16) {
    switch (vals_t) {
      case kValsF32: launch<CODEC, kF16, float>(a, threads, stream); return 0;
      case kValsF16: launch<CODEC, kF16, __half>(a, threads, stream); return 0;
      case kValsU8: launch<CODEC, kF16, uint8_t>(a, threads, stream); return 0;
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (vq) {
    case kU8: launch<CODEC, kU8>(a, threads, stream); return 0;
    case kU4: launch<CODEC, kU4>(a, threads, stream); return 0;
    case kPq: launch<CODEC, kPq>(a, threads, stream); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch the (codec, vq) variant on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape or variant the
// kernel does not take. Codec, vq and (under vq f16) value storage numbers
// are the enums above.
int rows_dot(int codec, int vq, int vals_t, const void* Q, const void* docs, const void* vals,
             const void* nnz, const void* p0, const void* p1, const void* v0,
             const void* v1, void* out, int nq, int dim, int nd, int C, int n_rows,
             int L, int vals_w, int p0_w, int p1_w, float scale, void* stream) {
  const int threads = ((L / 8 + 31) / 32) * 32;
  if (L % 8 || threads < 32 || threads > 1024 || nq <= 0 || C <= 0 || nd <= 0 ||
      nd > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)Q, (const int*)docs, vals, (const int*)nnz, p0, p1,
               (const float*)v0, (const float*)v1, (float*)out, nq, dim, nd, C,
               n_rows, L, vals_w, p0_w, p1_w, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (codec) {
    case kUncompressed: rc = launch_vq<kUncompressed>(vq, vals_t, a, threads, s); break;
    case kDotVByte: rc = launch_vq<kDotVByte>(vq, vals_t, a, threads, s); break;
    case kStreamVByte: rc = launch_vq<kStreamVByte>(vq, vals_t, a, threads, s); break;
    case kBitpack: rc = launch_vq<kBitpack>(vq, vals_t, a, threads, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* rows_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
