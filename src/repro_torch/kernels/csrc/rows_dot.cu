// Fused candidate-row gather + DotVByte decode + rescore, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rows_dot.py::rows_scores_batch
// (body `_kernel`, pl.pallas_call at rows_dot.py:190) for codec = dotvbyte,
// vq = f16. It computes what `_kernel` computes; it is not a block-by-block
// carry-over of the TPU grid.
//
// Contract (checked by the Python wrapper, kernels/rows_dot.py):
//   Q     f32 [nq, dim]          dense queries
//   docs  i32 [nd, C]            candidate row ids; nd == 1 shares one set with
//                                every query (flat), nd == nq gives each query
//                                its own set (Seismic)
//   vals  f16 [n_rows, L]        row values (row n_rows-1 is the all-zero sentinel)
//   nnz   i32 [n_rows]           live entries per row
//   ctrl  u8  [n_rows, ctrl_w]   DotVByte control bytes, ctrl_w >= L/8 (lane-padded)
//   data  u8  [n_rows, data_w]   DotVByte data bytes
//   out   f32 [nq, C]            out[q, i] = sum_{j < nnz} Q[q, comp_j] * f32(val_j) * scale
//
// Row format: gap j has control bit j%8 of byte j/8 (LSB first); bit 0 means
// one data byte, bit 1 two little-endian bytes; the byte offset of gap j is
// the exclusive prefix sum of (bit + 1); the first gap of a row is absolute,
// so the components are the inclusive prefix sum of the gaps.
//
// Design (a simple kernel that is right first): one thread block per
// (candidate, set). Thread t owns control byte t, i.e. gaps 8t..8t+7:
//   1. a block-wide exclusive scan of (8 + popcount) over the live control
//      bytes gives each thread the offset of its first data byte;
//   2. the thread decodes its 8 gaps from global memory into registers;
//   3. a second block scan of the per-thread gap sums turns them into
//      absolute components;
//   4. for each query of the set, the thread gathers Q[q, comp] for its live
//      entries, multiplies by f32(val) * scale, and a block reduction writes
//      the score. With nd == 1 the decoded row stays in registers across the
//      whole query batch (decode once, score many).
// The work is bound by bytes (the gathered rows, Q and the scores); this first
// version leaves the row gathers as plain loads. cp.async/TMA row staging,
// several rows per block and vector loads are later work.
//
// Ids outside [0, n_rows) score 0, and a decoded component outside [0, dim)
// contributes 0, so a corrupt index never reads outside its buffers.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum over the block. blockDim.x is a multiple of 32;
// `scratch` holds 32 ints. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int incl = warp_inclusive_scan(x);
  if (n_warps == 1) return incl - x;
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? scratch[lane] : 0;
    scratch[lane] = warp_inclusive_scan(w) - w;
  }
  __syncthreads();
  const int out = incl - x + scratch[warp];
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
  __syncthreads();  // scratch is reused by the next query's sum
  return x;
}

__global__ void rows_dot_dotvbyte_f16_kernel(
    const float* __restrict__ Q, const int* __restrict__ docs,
    const __half* __restrict__ vals, const int* __restrict__ nnz_rows,
    const uint8_t* __restrict__ ctrl, const uint8_t* __restrict__ data,
    float* __restrict__ out, int nq, int dim, int nd, int C, int n_rows, int L,
    int ctrl_w, int data_w, float scale) {
  __shared__ int iscratch[32];
  __shared__ float fscratch[32];
  const int c = blockIdx.x;
  const int set = blockIdx.y;
  const int t = threadIdx.x;

  const int doc = docs[(size_t)set * C + c];
  const bool in_range = doc >= 0 && doc < n_rows;
  const int nnz = in_range ? min(max(nnz_rows[doc], 0), L) : 0;
  const int q_lo = nd == 1 ? 0 : set;
  const int q_hi = nd == 1 ? nq : set + 1;
  if (nnz == 0) {  // block-uniform: the whole block leaves together
    if (t == 0)
      for (int q = q_lo; q < q_hi; ++q) out[(size_t)q * C + c] = 0.f;
    return;
  }

  // 1. data offset of this thread's first gap
  const bool live_byte = 8 * t < nnz;
  const int byte = live_byte ? ctrl[(size_t)doc * ctrl_w + t] : 0;
  int off = block_exclusive_scan(live_byte ? 8 + __popc(byte) : 0, iscratch);

  // 2. decode 8 gaps; running sum gives the thread-local prefix
  const uint8_t* row = data + (size_t)doc * data_w;
  int comp[8];
  int run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * t + j < nnz) {
      const int two = (byte >> j) & 1;
      int gap = 0;
      if (off + two < data_w) {
        gap = row[off];
        if (two) gap |= (int)row[off + 1] << 8;
      }
      off += 1 + two;
      run += gap;
    }
    comp[j] = run;
  }

  // 3. absolute components
  const int base = block_exclusive_scan(run, iscratch);
  const __half* vrow = vals + (size_t)doc * L;
  float val[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = 8 * t + j;
    comp[j] += base;
    val[j] = e < nnz ? __half2float(vrow[e]) * scale : 0.f;
  }

  // 4. score against every query of the set
  for (int q = q_lo; q < q_hi; ++q) {
    const float* qrow = Q + (size_t)q * dim;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * t + j < nnz && (unsigned)comp[j] < (unsigned)dim)
        acc += qrow[comp[j]] * val[j];
    acc = block_sum(acc, fscratch);
    if (t == 0) out[(size_t)q * C + c] = acc;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int rows_dot_dotvbyte_f16(const void* Q, const void* docs, const void* vals,
                          const void* nnz, const void* ctrl, const void* data,
                          void* out, int nq, int dim, int nd, int C, int n_rows,
                          int L, int ctrl_w, int data_w, float scale,
                          void* stream) {
  const int threads = ((L / 8 + 31) / 32) * 32;
  if (threads < 32 || threads > 1024 || nq <= 0 || C <= 0 || nd <= 0 ||
      nd > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)C, (unsigned)nd);
  rows_dot_dotvbyte_f16_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)Q, (const int*)docs, (const __half*)vals, (const int*)nnz,
      (const uint8_t*)ctrl, (const uint8_t*)data, (float*)out, nq, dim, nd, C,
      n_rows, L, ctrl_w, data_w, scale);
  return (int)cudaGetLastError();
}

const char* rows_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
