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
// of the final f32 sums differs. That order is one for all three stages below
// (gaps.cuh: products rounded alone, groups of 8 entries summed left to right,
// the balanced pairwise tree over the groups), so a score is the same bits
// whichever stage the batch's shape picks.
//
// Three scoring stages, picked by the wrapper (kernels/rows_dot.py):
//
// Row warps (the per-query form, nd == nq: Seismic's one launch a search, and
// one query over one set; where a query row fits in shared memory and the sets
// hold ROW_WARPS_MIN_ROWS = 65,536 rows in all: below that, blocks staging a
// 119 KB query row for a few tasks each lost to entry lanes on an H100, 0.0166
// vs 0.0038 ms at the hnsw engine's 64 x 8 seeds, 0.0300 vs 0.0057 at its
// 64 x 32 neighbours, 0.0165 vs 0.0075 at one query over 4,096; chip_smoke.py).
// Under entry lanes this form was a grid of C x nd one-warp blocks (262,144 at 64 x
// 4,096): the 32-blocks-per-SM limit held an SM to half its warps, each
// warp's life was one serial chain of loads, and the blocks resident on an SM
// belonged to several queries, so their Q gathers (one 32-byte L2 sector per
// live entry, ~1 GB a search at 100k docs) missed L1. Here:
//   - a persistent grid, one block of kRowThreads threads an SM; block i takes
//     the i-th share of the tasks (kWarpRows = 8 consecutive candidates of one
//     set each) in set order and stages each set's query row in shared memory
//     once (119 KB at dim 30,522; at most two sets a block at the Seismic
//     shape), so every Q gather is a shared-memory read;
//   - each warp takes tasks in turn: lanes 0..7 load the task's row ids and
//     lengths in two loads, and load the next task's ids and ask L2 for its
//     rows' first lines before this task's decode;
//   - a chunk of 128 entries (16 groups) reduces by the half-warp's pairwise
//     tree, and the chunks of a longer row combine on a pairwise stack;
//   - a warp scores its rows two at a time, a half-warp each (SPLADE rows hold
//     ~119 entries: one 128-entry chunk, where a whole warp left half its
//     lanes idle and ran one row's chain of loads at a time); a lane owns 8
//     entries of a chunk, the byte codecs' offsets and the components are
//     half-warp scans with a carry, so rows past 128 entries loop over chunks
//     with no barrier (gaps.cuh's warp_decode_*<16>), and a row's value loads
//     are issued before its decode waits on ctrl and data;
//   - data bytes come as aligned 16-byte loads (gaps.cuh::load_window), f16
//     values as one 16-byte load a lane, f32 as two, u8 codes as one 8-byte
//     and u4 / pq codes as one 4-byte load, where the stream's rows are
//     16-byte aligned (always, for packs), else element by element;
//   - lane r keeps row c0 + r's score, and lanes 0..7 write out[set, c0 : c0 +
//     8] as one 32-byte run.
//   On an H100 (700 W) at the Seismic shape (64 queries x 4,096 candidates of
//   100k docs, L = 256) the 16 variants took 0.122-0.185 ms against
//   0.176-0.335 ms on entry lanes in the same run (dotvbyte/f16 0.163 vs
//   0.220), 9-20x their byte bounds (chip_smoke.py; PERF.md): each warp waits
//   on its rows' chains of dependent loads.
//
// Entry lanes (the shared form below QUERY_LANES_MIN_NQ queries, and the
// per-query form where a query row does not fit in shared memory): one thread
// block per (candidate, set), L/8 threads (rounded up to a warp); thread t
// owns entries 8t..8t+7:
//   1. byte codecs: a block-wide exclusive scan of the thread's data-byte count
//      gives the offset of its first data byte (bitpack needs no scan: entry j
//      starts at bit j*w);
//   2. the thread decodes its 8 gaps into registers, reading no byte beyond
//      the stream's row width;
//   3. a second block scan of the per-thread gap sums gives absolute
//      components (uncompressed reads them directly and skips 1-3);
//   4. the thread dequantizes its 8 values (the PQ codebook is staged in
//      shared memory once per block) and, for each query of the set, sums its
//      group's products and a block reduction (the tree over threads, so over
//      groups) writes the score. With
//      nd == 1 the decoded row stays in registers across the whole query batch
//      (decode once, score many).
//
// Query lanes (the shared form, nd == 1, from QUERY_LANES_MIN_NQ queries on;
// the flat engine scores every row against the whole batch): Q arrives
// transposed, Qt [dim, nq]. A thread block takes R consecutive candidates
// (R = clamp(4096 / L, 1, 8)) and one tile of 32 x LQ queries (grid.y), LQ
// queries a lane: 2 up to nq 64, else 4 (lane_queries):
//   1. the block decodes its R rows into shared memory as {component, scaled
//      value} (R x L x 8 B: 16 KB at L = 256). Up to L = 256 each of 4 warps
//      decodes whole rows alone with warp scans (gaps.cuh, warp scope); above
//      that all threads decode one row at a time with block scans. The PQ
//      codebook is staged once per block, so once per R rows;
//   2. warp w scores rows w, w + 4, ...: lane q walks the row a group of 8
//      entries at a time and pushes each group's sum of Qt[comp, q] * val onto
//      a pairwise stack (score_row): one coalesced row of Qt per entry, no
//      reduction or barrier per query;
//   3. the scores go through shared memory and out[q, c0 : c0 + R] is written
//      as contiguous runs.
// The wrapper's threshold is QUERY_LANES_MIN_NQ = 8: on an H100 (700 W), over
// the 100,001 rows of the flat shape, entry lanes took 0.110 / 0.143 / 0.280 /
// 0.511 ms at nq 1 / 2 / 4 / 8 and query lanes 0.425 / 0.467 / 0.477 / 0.483
// ms; 5.25 vs 0.55 ms at 64 (chip_smoke.py's stage sweep; PERF.md).
// The work is bound by bytes (the gathered rows, Q and the scores); at the
// flat shape the batch's Qt reads from L2 dominate. cp.async/TMA row staging
// is later work.
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
enum Stage { kEntryLanes = 0, kQueryLanes = 1, kRowWarps = 2 };
// the query-lane stage: rows a block decodes at most, entries they may hold
// together, warps when a warp decodes a row alone (L <= 256)
constexpr int kMaxRows = 8;
constexpr int kRowEntries = 4096;
constexpr int kDecodeWarps = 4;
constexpr size_t kDefaultSmem = 48 * 1024;
// levels of a row's pairwise tree over groups that a lane keeps in registers
// (rows of up to 63 groups); a longer row keeps the rest in shared memory
constexpr int kRegLevels = 6;
// Query lanes: the queries a lane owns, LQ (lane l of a warp owns queries
// q0 + l + 32k, k < LQ; a block's tile is 32 x LQ). Each query keeps a
// kRegLevels stack of partial sums in registers. Up to 64 queries (the
// serving bucket) two a lane, where four left half of each lane's idle;
// above, four, so that a row is decoded and walked once for up to 128
// queries (two 64-query walks took 10-35% longer at nq 128 on an H100,
// tools/torch_rows_timing.py; PERF.md).
__host__ __device__ inline int lane_queries(int nq) { return nq > 64 ? 4 : 2; }
// the row-warp stage: candidates a warp scores in turn (one task), and
// threads of a block (one block an SM: the query row takes most of the
// shared memory; 768 threads leave 85 registers a thread)
constexpr int kWarpRows = 8;
constexpr int kRowThreads = 768;
constexpr int kRowLanes = 16;  // lanes a row takes: a half-warp
// levels of the pairwise stack over a row's 128-entry chunks (L <= 8,192: at
// most 64 chunks)
constexpr int kChunkLevels = 7;

// Levels of the pairwise tree over the groups of a row of L entries that do
// not fit kRegLevels (the bit length of L / 8, less kRegLevels).
__host__ __device__ inline int hi_levels(int L) {
  int levels = 0;
  while ((L / 8) >> levels) ++levels;
  return levels > kRegLevels ? levels - kRegLevels : 0;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

struct Args {
  const float* Q;  // Q [nq, dim] (entry lanes) or Qt [dim, nq] (query lanes)
  const int* docs;
  const void* vals;
  const int* nnz;
  const void* p0;
  const void* p1;
  const float* v0;
  const float* v1;
  float* out;
  int nq, dim, nd, C, n_rows, L, vals_w, p0_w, p1_w;
  int rows;  // query lanes: candidates a block decodes
  // row warps: whether the payload streams (p0: uncompressed comps, bitpack
  // words; p1: dotvbyte / streamvbyte data) and the values take vector loads
  int vec_p0, vec_p1, vec_v;
  float scale;
};

// Decode this thread's 8 gaps (entries 8t..8t+7, dead ones read as 0) into
// `gap`. Every thread of the block (of the warp, with `warp`) must call it:
// the byte codecs scan.
template <int CODEC>
__device__ __forceinline__ void decode_gaps(const Args& a, int doc, int nnz, int t,
                                            unsigned* iscratch, unsigned gap[8],
                                            bool warp = false) {
  if constexpr (CODEC == kDotVByte || CODEC == kStreamVByte) {
    const uint8_t* ctrl = static_cast<const uint8_t*>(a.p0) + (size_t)doc * a.p0_w;
    const uint8_t* row = static_cast<const uint8_t*>(a.p1) + (size_t)doc * a.p1_w;
    if constexpr (CODEC == kDotVByte)
      decode_dotvbyte8(ctrl, row, a.p1_w, t, nnz, iscratch, gap, warp);
    else
      decode_streamvbyte8(ctrl, row, a.p1_w, t, nnz, iscratch, gap, warp);
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
    float acc = 0.f;  // group t, left to right
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * t + j < nnz && (unsigned)comp[j] < (unsigned)a.dim)
        acc = __fadd_rn(acc, __fmul_rn(qrow[comp[j]], val[j]));
    acc = block_sum(acc, fscratch);
    if (t == 0) a.out[(size_t)q * a.C + c] = acc;
  }
}

// Query lanes: push x onto a lane's pairwise stack slots s[0 .. kRegLevels)
// as the item after n items, where c, the trailing ones of n, is the number of
// complete subtrees x closes (PairStack::push, with one uniform branch on c in
// place of a test per level). Returns true when x closed every register level:
// x is then a subtree of 2^kRegLevels items for the caller to carry on.
__device__ __forceinline__ bool push_regs(float (&s)[kRegLevels], float& x, int c) {
  static_assert(kRegLevels == 6, "push_regs spells out six levels");
  switch (c) {
    case 0: s[0] = x; return false;
    case 1: x = __fadd_rn(s[0], x); s[1] = x; return false;
    case 2: x = __fadd_rn(s[0], x); x = __fadd_rn(s[1], x); s[2] = x; return false;
    case 3:
      x = __fadd_rn(s[0], x); x = __fadd_rn(s[1], x); x = __fadd_rn(s[2], x);
      s[3] = x;
      return false;
    case 4:
      x = __fadd_rn(s[0], x); x = __fadd_rn(s[1], x); x = __fadd_rn(s[2], x);
      x = __fadd_rn(s[3], x);
      s[4] = x;
      return false;
    case 5:
      x = __fadd_rn(s[0], x); x = __fadd_rn(s[1], x); x = __fadd_rn(s[2], x);
      x = __fadd_rn(s[3], x); x = __fadd_rn(s[4], x);
      s[5] = x;
      return false;
    default:
      x = __fadd_rn(s[0], x); x = __fadd_rn(s[1], x); x = __fadd_rn(s[2], x);
      x = __fadd_rn(s[3], x); x = __fadd_rn(s[4], x); x = __fadd_rn(s[5], x);
      return true;
  }
}

// Query lanes: lane q's dots of one row of n entries against its LQ
// queries, each in the order of gaps.cuh. The lane walks the row a group of 8
// entries at a time and pushes each group's sum onto a pairwise stack: levels
// below kRegLevels in registers, the rest in `hi`, this warp's
// [hi_levels(L)][32 x LQ] floats of shared memory. The row's entries from n
// up to the next multiple of 8 must be dead ({0, 0.f}). Not inlined: its
// registers are then its own, not the decode's; inlined, with the group's
// loads in two runs of 4, the flat shape took up to twice the time on an H100
// for some variants (tools/torch_rows_timing.py; PERF.md).
template <int LQ>
__device__ __noinline__ void score_row(const Ent* ent, int n, const float* Qt, int nq,
                                          int q0, int nt, float* hi, float out[LQ]) {
  const int lane = threadIdx.x & 31;
  const float* base = Qt + q0 + lane;
  const unsigned groups = (unsigned)(n + 7) >> 3;
  float st[LQ][kRegLevels];
  for (unsigned g = 0; g < groups; ++g) {
    float s[LQ];
#pragma unroll
    for (int k = 0; k < LQ; ++k) s[k] = 0.f;
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Ent x = ent[8 * g + h + j];
        const float* row = base + (size_t)(unsigned)x.c * nq;
#pragma unroll
        for (int k = 0; k < LQ; ++k)
          if (lane + 32 * k < nt) s[k] = __fadd_rn(s[k], __fmul_rn(row[32 * k], x.v));
      }
    }
    const int c = __ffs(~g) - 1;  // trailing ones of g: uniform across the warp
#pragma unroll
    for (int k = 0; k < LQ; ++k) {
      if (!push_regs(st[k], s[k], c)) continue;
      // s[k] is a complete subtree of 2^kRegLevels groups: carry it up in `hi`
      const unsigned m = g >> kRegLevels;
      float* h = hi + lane + 32 * k;
      for (int l = 0;; ++l, h += 32 * LQ) {
        if (!((m >> l) & 1u)) {
          *h = s[k];
          break;
        }
        s[k] = __fadd_rn(*h, s[k]);
      }
    }
  }
  const unsigned low = groups & ((1u << kRegLevels) - 1), m = groups >> kRegLevels;
#pragma unroll
  for (int k = 0; k < LQ; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kRegLevels; ++l)
      if ((low >> l) & 1u) acc = __fadd_rn(st[k][l], acc);
    const float* h = hi + lane + 32 * k;
    for (int l = 0; (m >> l) != 0; ++l, h += 32 * LQ)
      if ((m >> l) & 1u) acc = __fadd_rn(*h, acc);
    out[k] = acc;
  }
}

// The query-lane stage of the shared form (nd == 1), LQ queries a lane; see
// the header.
template <int CODEC, int VQ, typename VT, int LQ>
__global__ void __launch_bounds__(1024) rows_dot_shared_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int R = a.rows, L = a.L;
  Ent* ent = reinterpret_cast<Ent*>(dyn);                        // [R][L]
  float* sc = reinterpret_cast<float*>(ent + (size_t)R * L);     // [tile queries][R]
  const int q0 = blockIdx.y * 32 * LQ;
  const int nt = min(32 * LQ, a.nq - q0);
  float* hi = sc + (size_t)nt * R;  // [scoring warps][hi_levels(L)][32 x LQ]
  __shared__ unsigned iscratch[32];
  __shared__ float cb[VQ == kPq ? kPqEntries : 1];
  __shared__ int row_nnz[kMaxRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  const int c0 = blockIdx.x * R;
  if constexpr (VQ == kPq) {
    for (int i = tid; i < kPqEntries; i += blockDim.x) cb[i] = a.v0[i];
    __syncthreads();
  }

  // 1. decode R rows: a warp per row up to L = 256, else the whole block
  const bool by_warp = L <= 256;
  const int t = by_warp ? lane : tid;
  for (int r = by_warp ? warp : 0; r < R; r += by_warp ? n_warps : 1) {
    const int c = c0 + r;
    const int doc = c < a.C ? a.docs[c] : -1;
    const bool in_range = doc >= 0 && doc < a.n_rows;
    const int nnz = in_range ? min(max(a.nnz[doc], 0), L) : 0;
    if (t == 0) row_nnz[r] = nnz;
    if (nnz == 0) continue;  // uniform across the decoding warp or block
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
      decode_gaps<CODEC>(a, doc, nnz, t, iscratch, gap, by_warp);
      unsigned run = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        run += gap[j];
        gap[j] = run;
      }
      const unsigned base = group_exclusive_scan<unsigned>(run, iscratch, by_warp);
#pragma unroll
      for (int j = 0; j < 8; ++j) comp[j] = (int)(gap[j] + base);
    }
    const float lo = (VQ == kU8 || VQ == kU4) ? a.v0[doc] : 0.f;
    const float step = (VQ == kU8 || VQ == kU4) ? a.v1[doc] : 0.f;
    Ent* out_row = ent + (size_t)r * L;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 8 * t + j;
      if (e >= nnz) {  // dead up to the next multiple of 8 (score_row's groups)
        if (8 * t < nnz) out_row[e] = Ent{0, 0.f};
        continue;
      }
      out_row[e] = (unsigned)comp[j] < (unsigned)a.dim
                       ? Ent{comp[j], dequant<VQ, VT>(a, doc, e, cb, lo, step) * a.scale}
                       : Ent{0, 0.f};
    }
  }
  __syncthreads();

  // 2. lane q of warp w scores rows w, w + W, ... against queries q0 + q
  float* warp_hi = hi + (size_t)warp * hi_levels(L) * 32 * LQ;
  for (int r = warp; r < R; r += n_warps) {
    float acc[LQ];
    score_row<LQ>(ent + (size_t)r * L, row_nnz[r], a.Q, a.nq, q0, nt, warp_hi, acc);
#pragma unroll
    for (int k = 0; k < LQ; ++k)
      if (lane + 32 * k < nt) sc[(lane + 32 * k) * R + r] = acc[k];
  }
  __syncthreads();

  // 3. out[q, c0 : c0 + R] in contiguous runs
  for (int i = tid; i < nt * R; i += blockDim.x) {
    const int q = i / R, r = i - q * R;
    if (c0 + r < a.C) a.out[(size_t)(q0 + q) * a.C + c0 + r] = sc[i];
  }
}

// Row-warp stage: group g's components and scaled values of row `doc`, over a
// group of W lanes (`off` and `t_run` carry the data offset and the components
// from one chunk of 8W entries to the next) -> the mask of live entries (inside
// nnz and the vocabulary); dead entries have component 0 and value 0. Nothing
// of the row is read where nnz is 0. Every lane of the warp must call it.
template <int CODEC, int VQ, typename VT>
__device__ __forceinline__ unsigned row_group(const Args& a, int doc, int nnz, int g,
                                              unsigned& off, unsigned& t_run, const float* cb,
                                              float lo, float step, int comp[8],
                                              float val[8]) {
  const bool live = 8 * g < nnz;
  // values first: their loads do not wait on the decode
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    if constexpr (VQ == kF16) {
      load8(static_cast<const VT*>(a.vals) + (size_t)doc * a.vals_w + 8 * g, a.vec_v, v);
    } else if constexpr (VQ == kU8) {
      load8(static_cast<const uint8_t*>(a.vals) + (size_t)doc * a.vals_w + 8 * g, a.vec_v, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(lo, __fmul_rn(v[j], step));
    } else {  // u4_sq, pq: 8 entries in 4 bytes
      const uint8_t* codes = static_cast<const uint8_t*>(a.vals) + (size_t)doc * a.vals_w + 4 * g;
      const uint32_t w = a.vec_v ? __ldg(reinterpret_cast<const uint32_t*>(codes))
                                 : codes[0] | codes[1] << 8 | codes[2] << 16 |
                                       (uint32_t)codes[3] << 24;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int byte = (w >> (8 * (j >> 1))) & 0xff;
        if constexpr (VQ == kU4)
          v[j] = __fadd_rn(lo, __fmul_rn((float)((j & 1) ? byte >> 4 : byte & 15), step));
        else
          v[j] = cb[byte * 2 + (j & 1)];
      }
    }
  }
  if constexpr (CODEC == kUncompressed) {
    const int* row = static_cast<const int*>(a.p0) + (size_t)doc * a.p0_w + 8 * g;
    if (live && a.vec_p0 && 8 * g + 8 <= a.p0_w) {
      load8(row, true, comp);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) comp[j] = live && 8 * g + j < a.p0_w ? row[j] : 0;
    }
  } else {
    unsigned gap[8];
    if constexpr (CODEC == kDotVByte || CODEC == kStreamVByte) {
      const uint8_t* ctrl = static_cast<const uint8_t*>(a.p0) + (size_t)doc * a.p0_w;
      const uint8_t* data = static_cast<const uint8_t*>(a.p1) + (size_t)doc * a.p1_w;
      if constexpr (CODEC == kDotVByte)
        warp_decode_dotvbyte8<kRowLanes>(ctrl, data, a.p1_w, a.vec_p1, g, nnz, off, gap);
      else
        warp_decode_streamvbyte8<kRowLanes>(ctrl, data, a.p1_w, a.vec_p1, g, nnz, off, gap);
    } else {  // kBitpack
      const uint8_t* words = static_cast<const uint8_t*>(a.p0) + (size_t)doc * a.p0_w * 4;
      warp_decode_bitpack8<0>(words, 4 * a.p0_w, nnz ? static_cast<const int*>(a.p1)[doc] : 0,
                              a.vec_p0, g, nnz, gap);
    }
    unsigned run = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      run += gap[j];
      gap[j] = run;
    }
    const unsigned incl = warp_inclusive_scan<unsigned, kRowLanes>(run);
    const unsigned pre = t_run + incl - run;
    t_run += __shfl_sync(kFull, incl, kRowLanes - 1, kRowLanes);
#pragma unroll
    for (int j = 0; j < 8; ++j) comp[j] = (int)(pre + gap[j]);
  }
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool ok = 8 * g + j < nnz && (unsigned)comp[j] < (unsigned)a.dim;
    mask |= (unsigned)ok << j;
    comp[j] = ok ? comp[j] : 0;
    val[j] = ok ? v[j] * a.scale : 0.f;
  }
  return mask;
}

// Row-warp stage: the doc id of row c0 + lane of set `set` on lanes below
// kWarpRows (-1 past C and on the other lanes).
__device__ __forceinline__ int task_doc(const Args& a, long long set, int c0, int lane) {
  return lane < kWarpRows && c0 + lane < a.C ? a.docs[set * a.C + c0 + lane] : -1;
}

// Row-warp stage: ask L2 for the first 256 bytes of each stream of row `doc`
// (the lanes that hold a doc id), so the next task's loads find them there.
template <int CODEC, int VQ, typename VT>
__device__ __forceinline__ void prefetch_row(const Args& a, int doc) {
  if (doc < 0 || doc >= a.n_rows) return;
  const size_t elt = VQ == kF16 ? sizeof(VT) : 1;
  const char* streams[3] = {
      static_cast<const char*>(a.vals) + (size_t)doc * a.vals_w * elt,
      static_cast<const char*>(a.p0) + (size_t)doc * a.p0_w * (CODEC == kDotVByte ||
                                                               CODEC == kStreamVByte ? 1 : 4),
      CODEC == kDotVByte || CODEC == kStreamVByte
          ? static_cast<const char*>(a.p1) + (size_t)doc * a.p1_w : nullptr};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (streams[k]) {
      prefetch_l2(streams[k]);
      prefetch_l2(streams[k] + 128);
    }
}

// The row-warp stage (the per-query form, nd == nq); see the header.
template <int CODEC, int VQ, typename VT = __half>
__global__ void __launch_bounds__(kRowThreads) rows_dot_warp_kernel(const Args a) {
  extern __shared__ __align__(16) float qs[];  // the current set's query row
  __shared__ float cb[VQ == kPq ? kPqEntries : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if constexpr (VQ == kPq)
    for (int i = threadIdx.x; i < kPqEntries; i += blockDim.x) cb[i] = a.v0[i];
  // this block's share of the tasks (kWarpRows consecutive candidates of one
  // set each), in set order
  const long long per_set = (a.C + kWarpRows - 1) / kWarpRows;
  const long long n_tasks = per_set * a.nd;
  const long long t0 = n_tasks * blockIdx.x / gridDim.x;
  const long long t1 = n_tasks * (blockIdx.x + 1) / gridDim.x;
  for (long long set = t0 / per_set; set * per_set < t1; ++set) {
    __syncthreads();  // every warp is done with the previous set's row
    const float* q = a.Q + set * a.dim;
    for (int i = threadIdx.x; i < a.dim; i += blockDim.x) qs[i] = q[i];
    __syncthreads();
    const long long lo = t0 > set * per_set ? t0 : set * per_set;
    const long long hi = t1 < (set + 1) * per_set ? t1 : (set + 1) * per_set;
    long long task = lo + warp;
    int next_doc = task < hi ? task_doc(a, set, (int)(task - set * per_set) * kWarpRows, lane) : -1;
    for (; task < hi; task += n_warps) {
      const int c0 = (int)(task - set * per_set) * kWarpRows;
      // lane r < kWarpRows holds row c0 + r's id and length; the next task's
      // ids are loaded and its rows asked of L2 before this task's decode
      const int my_doc = next_doc;
      const int my_nnz = my_doc >= 0 && my_doc < a.n_rows ? min(max(a.nnz[my_doc], 0), a.L) : 0;
      if (task + n_warps < hi) {
        next_doc = task_doc(a, set, (int)(task + n_warps - set * per_set) * kWarpRows, lane);
        prefetch_row<CODEC, VQ, VT>(a, next_doc);
      }
      // two rows at a time, a half-warp each: rows r and r + 1 of the task
      float keep = 0.f;  // lane r keeps row c0 + r's score
      const int half = lane / kRowLanes, hl = lane % kRowLanes;
#pragma unroll 1
      for (int r = 0; r < kWarpRows; r += 2) {
        const int doc = __shfl_sync(kFull, my_doc, r + half);
        const int nnz = __shfl_sync(kFull, my_nnz, r + half);
        const int most = max(nnz, __shfl_xor_sync(kFull, nnz, kRowLanes));
        if (most == 0) continue;  // warp-uniform: empty, sentinel, out of range or past C
        const bool scaled = (VQ == kU8 || VQ == kU4) && nnz;
        const float lo_v = scaled ? a.v0[doc] : 0.f;
        const float step = scaled ? a.v1[doc] : 0.f;
        PairStack<kChunkLevels> chunks;  // the row's chunk sums
        unsigned off = 0, t_run = 0, n_chunks = 0;
        for (int g = hl; 8 * (g - hl) < most; g += kRowLanes, ++n_chunks) {
          int comp[8];
          float val[8];
          const unsigned live = row_group<CODEC, VQ, VT>(a, doc, nnz, g, off, t_run, cb,
                                                             lo_v, step, comp, val);
          float s = 0.f;  // group g, left to right
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (live >> j & 1) s = __fadd_rn(s, __fmul_rn(qs[comp[j]], val[j]));
          s = warp_sum<kRowLanes>(s);  // the chunk: the tree over its 16 groups
          chunks.push(s, n_chunks);
        }
        const float acc = chunks.total(n_chunks);
        const float other = __shfl_xor_sync(kFull, acc, kRowLanes);  // the other half's row
        if (lane == r) keep = acc;
        if (lane == r + 1) keep = other;
      }
      // out[set, c0 : c0 + kWarpRows]: one contiguous 32-byte run
      if (lane < kWarpRows && c0 + lane < a.C) a.out[set * a.C + c0 + lane] = keep;
    }
  }
}

template <int CODEC, int VQ, typename VT = __half>
int launch(const Args& a, int threads, int stage, cudaStream_t stream) {
  if (stage == kRowWarps) {
    Args w = a;
    const size_t elt = VQ == kF16 ? sizeof(VT) : 1;
    w.vec_p0 = rows_aligned(a.p0, 4ll * a.p0_w);
    w.vec_p1 = CODEC == kDotVByte || CODEC == kStreamVByte ? rows_aligned(a.p1, a.p1_w) : 0;
    w.vec_v = rows_aligned(a.vals, (long long)elt * a.vals_w);
    auto kernel = rows_dot_warp_kernel<CODEC, VQ, VT>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t smem = (size_t)((a.dim + 3) & ~3) * sizeof(float);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, smem);
    if (e != cudaSuccess) return (int)e;  // a query row too wide: the wrapper's rule
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tasks = (long long)a.nd * ((a.C + kWarpRows - 1) / kWarpRows);
    const long long blocks = (long long)sms * per_sm;
    const long long grid = blocks < tasks ? blocks : tasks;
    kernel<<<(unsigned)grid, kRowThreads, smem, stream>>>(w);
    return 0;
  }
  if (stage == kEntryLanes) {
    rows_dot_kernel<CODEC, VQ, VT>
        <<<dim3((unsigned)a.C, (unsigned)a.nd), threads, 0, stream>>>(a);
    return 0;
  }
  const int lq = lane_queries(a.nq), tile = 32 * lq;
  auto kernel = lq == 4 ? rows_dot_shared_kernel<CODEC, VQ, VT, 4>
                        : rows_dot_shared_kernel<CODEC, VQ, VT, 2>;
  const int block_threads = a.L <= 256 ? 32 * kDecodeWarps : threads;
  const int score_warps = a.rows < block_threads / 32 ? a.rows : block_threads / 32;
  const int nt = a.nq < tile ? a.nq : tile;  // the first tile's queries: the most
  const size_t smem = (size_t)a.rows * a.L * sizeof(Ent) + (size_t)nt * a.rows * sizeof(float) +
                      (size_t)score_warps * hi_levels(a.L) * tile * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((a.C + a.rows - 1) / a.rows);
  const unsigned tiles = (unsigned)((a.nq + tile - 1) / tile);
  kernel<<<dim3(blocks, tiles), block_threads, smem, stream>>>(a);
  return 0;
}

template <int CODEC>
int launch_vq(int vq, int vals_t, const Args& a, int threads, int stage, cudaStream_t stream) {
  if (vq == kF16) {
    switch (vals_t) {
      case kValsF32: return launch<CODEC, kF16, float>(a, threads, stage, stream);
      case kValsF16: return launch<CODEC, kF16, __half>(a, threads, stage, stream);
      case kValsU8: return launch<CODEC, kF16, uint8_t>(a, threads, stage, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (vq) {
    case kU8: return launch<CODEC, kU8>(a, threads, stage, stream);
    case kU4: return launch<CODEC, kU4>(a, threads, stage, stream);
    case kPq: return launch<CODEC, kPq>(a, threads, stage, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch the (codec, vq) variant with scoring stage `stage` on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape or variant the kernel does not take. Codec, vq, stage and (under vq
// f16) value storage numbers are the enums above; `Q` is Qt [dim, nq] under
// query lanes, which take the shared form (nd == 1) only.
int rows_dot(int codec, int vq, int vals_t, int stage, const void* Q, const void* docs,
             const void* vals, const void* nnz, const void* p0, const void* p1,
             const void* v0, const void* v1, void* out, int nq, int dim, int nd, int C,
             int n_rows, int L, int vals_w, int p0_w, int p1_w, float scale, void* stream) {
  const int threads = ((L / 8 + 31) / 32) * 32;
  if (L % 8 || threads < 32 || threads > 1024 || nq <= 0 || C <= 0 || nd <= 0 ||
      nd > 65535 || stage < kEntryLanes || stage > kRowWarps ||
      (stage == kQueryLanes && (nd != 1 || (nq + 127) / 128 > 65535)) ||
      (stage == kRowWarps && nd != nq))
    return (int)cudaErrorInvalidValue;
  int rows = kRowEntries / L;
  rows = rows < 1 ? 1 : rows > kMaxRows ? kMaxRows : rows;
  const Args a{(const float*)Q, (const int*)docs, vals, (const int*)nnz, p0, p1,
               (const float*)v0, (const float*)v1, (float*)out, nq, dim, nd, C,
               n_rows, L, vals_w, p0_w, p1_w, rows, 0, 0, 0, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (codec) {
    case kUncompressed: rc = launch_vq<kUncompressed>(vq, vals_t, a, threads, stage, s); break;
    case kDotVByte: rc = launch_vq<kDotVByte>(vq, vals_t, a, threads, stage, s); break;
    case kStreamVByte: rc = launch_vq<kStreamVByte>(vq, vals_t, a, threads, stage, s); break;
    case kBitpack: rc = launch_vq<kBitpack>(vq, vals_t, a, threads, stage, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* rows_dot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
