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
// block is decoded once per query tile and scored for every query of it. It
// computes what the tile program computes; it is not a carry-over of the TPU's
// DMA pipeline or grid.
//
// Contract (checked by the Python wrapper, kernels/block_scan.py):
//   Q          f32 [nq, dim] under the entry-lane stage, Qt f32 [dim, nq] (the
//              batch transposed) under the query-lane stage; any dim
//   p0, p1     dotvbyte     ctrl u8 [B, p0_w >= T/8], data u8 [B, p1_w]
//              streamvbyte  ctrl u8 [B, p0_w >= T/4], data u8 [B, p1_w]
//              bitpack      words u32 [B, p0_w]; widths i32 [B] under the
//                           per-block width, none under a static width
//   seg        i32 or i8 [B, T]       slot of each entry, -1 for padding
//   start_pos  i32 [B, D]             first entry of each slot
//   start_abs  i32 [B, D]             absolute first component of each slot
//   vals       f32, f16 or u8 [B, T]  values as stored
//   doc_ids    i32 [B, D]             document of each slot (scatter mode only)
//   out        slot mode:    f32 [nq, B, D], every slot's score
//              scatter mode: f32 [n_docs, nq], zeroed by the caller; each used
//                            slot adds its score to out[doc_ids[b, d], q]
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
//            where that is larger, else T (both clamped to [0, T]). Slot 0 is
//            always used, a later slot iff start_pos[d] > 0; an unused slot
//            scores 0.
// The scatter mode is the port's own fusion: the reference scatters slot
// scores to documents outside Pallas (scoring.scatter_block_scores, an
// index_add_ over an [nq, B, D] intermediate of 363 MiB at 100k docs). Here an
// unused slot adds nothing, a document id outside [0, n_docs) drops (as the
// scatter drops it), and a zero score is not added (x + 0 == x: out starts at
// +0 and never holds -0). Documents that span blocks get their fragments in an
// order that changes from run to run; two fragments commute exactly, three or
// more agree to f32 rounding. The accumulator is doc-major, so the lanes of a
// warp, which own consecutive queries, add into one contiguous run of a row.
//
// Design, batched stages: one thread block per packed block (grid.x) and query
// tile (grid.y, query lanes only), T/8 threads rounded up to a warp; thread t
// owns entries 8t..8t+7.
//   1. decode the thread's 8 gaps (gaps.cuh; the byte codecs scan their byte
//      counts, bitpack reads bit j*w directly);
//   2. a block scan of the gap sums gives t, which goes to shared memory so
//      every entry can read t[start_pos[s]]; each entry's component and scaled
//      value land in registers;
//   3. the scoring stage, a runtime argument uniform across the launch:
//      query lanes (stage 1; the batched scan): the entries go to shared memory
//        as {component, value} (T x 8 B: 4 KB at T = 512, 64 KB at T = 8192,
//        above the 48 KB default, so the launch raises the limit). Warp w
//        scores slots w, w + W, ...: lane q walks the slot's contiguous
//        fragment and accumulates Qt[comp, q] * val (gaps.cuh::score_run), so
//        one entry's queries are one coalesced row of Qt, with no block scan,
//        no barrier and no reduction per query. In the slot mode the block's
//        scores are staged in shared memory, where they fit in the default
//        48 KB, and written as runs of D per query;
//      entry lanes (stage 0; small batches, where a warp of query lanes would
//        idle): per query, gather Q[q, comp], multiply, and a block scan of the
//        products writes their exclusive prefix sums cz[0..T] over the shared
//        memory of t; slot d's score is cz[end_d] - cz[start_d]. Q is read
//        row-major here.
//   The wrapper picks query lanes from QUERY_LANES_MIN_NQ = 8 queries on
//   (kernels/block_scan.py). On an H100 (700 W) at 100k docs the fused scan took
//   0.141 / 0.191 / 0.359 / 0.668 ms with entry lanes at nq 1 / 2 / 4 / 8 and
//   0.508 / 0.551 / 0.571 / 0.581 ms with query lanes; 5.15 vs 0.70 ms at 64
//   (chip_smoke.py's stage sweep; PERF.md).
// Design, the resident-query stage (stage 2; one query, where the wrapper's
// shape rule finds room: the query's dim floats plus one warp's scratch within
// the 227 KB a block may opt into). Under entry lanes a block of T/8 threads
// ran three block scans in a row per packed block (byte offsets, gap sums,
// products; three barriers each) and gathered every live entry's q[comp] from
// L2, and 64-thread blocks left an SM half its warps. Here:
//   - a persistent grid, one thread block per SM (as many as the occupancy API
//     allows at this shared memory), up to kResidentWarps warps;
//   - the dense query is staged once per thread block into shared memory (119
//     KB at dim 30,522), so every q[comp] is a shared-memory read;
//   - each warp takes whole packed blocks in a grid-stride loop and walks one
//     in chunks of 256 entries (lane l owns group 32k + l, entries 8g..8g+7),
//     with warp scans only and offsets carried from chunk to chunk: no
//     __syncthreads inside a block's work;
//   - the data bytes come as aligned 16-byte loads (gaps.cuh::load_window),
//     seg and values as one or two vector loads a lane, where the streams'
//     alignment allows (always, for packs: rows are lane-padded to 128);
//   - a warp's scratch (T + 1 + D words) holds t, then each slot's base
//     start_abs[d] - t[start_pos[d]], then the products' prefix sums cz over
//     the memory of t (each lane rewrites only entries it read), so slot d is
//     cz[end_d] - cz[start_d] with lanes across slots; the scatter adds with
//     atomics as above. At T = 8192 the scratch is 32 KB: three warps a block.
//   On an H100 (700 W) at 100k docs, T = 512, the kernel took 0.0785 ms of
//   device time (dotvbyte; 2.4x the 33 us the streams take at 3.35 TB/s) and
//   the fused call 0.080-0.105 ms over the three codecs, against 0.113-0.127
//   on entry lanes and 0.062 for torch.sparse.mm(csr, q) (chip_smoke.py;
//   PERF.md). It waits on each warp's chain of dependent steps, about one
//   instruction a cycle per SM: an L2 prefetch of each warp's next block and
//   a cp.async ring that staged it in shared memory (9 warps a block) were
//   both slower (0.092, 0.131 ms) and are not used.
// Products and sums are rounded as plain operations (__fmul_rn, __fadd_rn), so
// every product equals the plain version's; only the order of the f32 sums
// differs.
// What bounds it: at the main path's sizes the batched scan reads each live
// entry's Qt row (64 queries x 4 B) from L2, ~3 GB at 100k docs; the HBM
// bytes of the streams (the bound chip_smoke.py states) are a tenth of that.
// The query-lane stage makes that read coalesced; TMA staging of the streams
// and several packed blocks per thread block are later work.
//
// Template parameters: CODE (0 dotvbyte, 1 streamvbyte, 2 bitpack at the
// per-block width, 2 + W bitpack at the static width W = 1..32), VT the value
// storage (float, __half, uint8_t) and ST the seg storage (int32_t, int8_t):
// 210 instantiations of two kernels, the batched stages' (stage and output
// mode are runtime arguments) and the resident query's. So that they compile
// in parallel (19-31 s on the chip machine), the library is built in
// KERNEL_PARTS parts (kernels/build.py); part p holds the codes with
// CODE % KERNEL_PARTS == p and refuses the others. __launch_bounds__(1024)
// keeps every instantiation launchable at T = 8192 (1024 threads).

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
enum Stage { kEntryLanes = 0, kQueryLanes = 1, kResidentQuery = 2 };
enum Mode { kSlots = 0, kScatter = 1 };
constexpr int kMaxT = 8 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
// resident query: warps of a thread block at most (fewer where the scratch of
// a large T leaves no room)
constexpr int kResidentWarps = 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }

struct Args {
  const float* Q;  // Q [nq, dim] (entry lanes) or Qt [dim, nq] (query lanes)
  const void* p0;
  const void* p1;
  const void* seg;
  const int* sp;
  const int* sa;
  const void* vals;
  const int* doc_ids;
  float* out;
  int nq, dim, B, T, D, p0_w, p1_w, n_docs, stage, mode;
  int staged;  // query lanes, slot mode: slot scores go through shared memory
  // resident query: floats of the staged query and words of a warp's scratch
  // (both rounded up to 16 bytes); whether the data stream (dotvbyte and
  // streamvbyte data, bitpack words) and seg / vals take vector loads
  int q_words, scratch, vec_p, vec_e;
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

// Slot d's fragment [s0, end), clamped to [0, T]; returns whether it is used.
__device__ __forceinline__ bool slot_run(const int* sp, int d, int D, int T, int& s0,
                                         int& end) {
  const int s = sp[d];
  const int nxt = d + 1 < D ? sp[d + 1] : 0;
  end = min(max(nxt > s ? nxt : T, 0), T);
  s0 = min(max(s, 0), T);
  return d == 0 || s > 0;
}

// Query q's score of used slot d of block b into the scatter accumulator.
__device__ __forceinline__ void scatter_add(const Args& a, size_t b, int d, int q, float s) {
  const int doc = a.doc_ids[b * a.D + d];
  if (s != 0.f && (unsigned)doc < (unsigned)a.n_docs)
    atomicAdd(a.out + (size_t)doc * a.nq + q, s);
}

template <int CODE, typename VT, typename ST>
__global__ void __launch_bounds__(1024) block_scan_kernel(const Args a) {
  // T + 1 words of t (and, for entry lanes, the products' prefix sums); for
  // query lanes T Ents over the same memory once t is no longer read
  extern __shared__ __align__(16) unsigned smem[];
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
  __syncthreads();  // t is read no more: its memory is reused below

  if (a.stage == kQueryLanes) {
    // 3. query lanes: entries to shared memory, then a warp per slot
    Ent* ent = reinterpret_cast<Ent*>(smem);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * t + j < T) ent[8 * t + j] = Ent{comp[j], val[j]};
    __syncthreads();
    const int warp = t >> 5, lane = t & 31, n_warps = blockDim.x >> 5;
    const int q0 = blockIdx.y * kQueryTile;
    const int nt = min(kQueryTile, a.nq - q0);
    // slot mode: the lanes own queries B*D floats apart in out, so the
    // block's scores [nt][D + 1] (padded against bank conflicts) are staged
    // and written as runs of D, where they fit (launch())
    float* staged = reinterpret_cast<float*>(ent + T);
    for (int d = warp; d < D; d += n_warps) {
      int s0, end;
      const bool used = slot_run(sp, d, D, T, s0, end);
      float acc[kLaneQueries] = {};
      if (used) score_run(ent + s0, end - s0, a.Q, a.nq, q0, nt, acc);
#pragma unroll
      for (int k = 0; k < kLaneQueries; ++k) {
        const int q = q0 + lane + 32 * k;
        if (lane + 32 * k >= nt) continue;
        if (a.mode == kScatter) {
          if (used) scatter_add(a, b, d, q, acc[k]);
        } else if (a.staged) {
          staged[(lane + 32 * k) * (D + 1) + d] = acc[k];
        } else {
          a.out[((size_t)q * a.B + b) * D + d] = acc[k];
        }
      }
    }
    if (a.mode == kSlots && a.staged) {
      __syncthreads();
      for (int i = t; i < nt * D; i += blockDim.x) {
        const int q = i / D, d = i - q * D;
        a.out[((size_t)(q0 + q) * a.B + b) * D + d] = staged[q * (D + 1) + d];
      }
    }
    return;
  }

  // 3. entry lanes: every query against this block's decoded entries
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
    for (int d = t; d < D; d += blockDim.x) {
      int s0, end;
      const bool used = slot_run(sp, d, D, T, s0, end);
      const float s = used ? cz[end] - cz[s0] : 0.f;
      if (a.mode == kSlots)
        a.out[((size_t)q * a.B + b) * D + d] = s;
      else if (used)
        scatter_add(a, b, d, q, s);
    }
    __syncthreads();  // the next query rewrites cz
  }
}

// This lane's 8 gaps (group g) of block b, warp scope; `base` carries the
// byte codecs' data offset from chunk to chunk. Every lane must call it.
template <int CODE>
__device__ __forceinline__ void decode_group(const Args& a, size_t b, int g, unsigned& base,
                                             unsigned gap[8]) {
  if constexpr (CODE == kDotVByte || CODE == kStreamVByte) {
    const uint8_t* ctrl = static_cast<const uint8_t*>(a.p0) + b * a.p0_w;
    const uint8_t* data = static_cast<const uint8_t*>(a.p1) + b * a.p1_w;
    if constexpr (CODE == kDotVByte)
      warp_decode_dotvbyte8(ctrl, data, a.p1_w, a.vec_p, g, a.T, base, gap);
    else
      warp_decode_streamvbyte8(ctrl, data, a.p1_w, a.vec_p, g, a.T, base, gap);
  } else {
    const uint8_t* words = static_cast<const uint8_t*>(a.p0) + b * a.p0_w * 4;
    const int w = CODE == kBitpack ? static_cast<const int*>(a.p1)[b] : 0;
    warp_decode_bitpack8<CODE - kBitpack>(words, 4 * a.p0_w, w, a.vec_p, g, a.T, gap);
  }
}

// The resident-query stage (nq == 1): a persistent grid of one thread block
// per SM; see the header.
template <int CODE, typename VT, typename ST>
__global__ void __launch_bounds__(1024) block_scan_resident_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int T = a.T, D = a.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  float* qs = reinterpret_cast<float*>(smem);
  // the warp's scratch: t at [1, T] (then the products' prefix sums cz at
  // [0, T]) and each slot's base start_abs[d] - t[start_pos[d]] after it
  unsigned* ws = smem + a.q_words + (size_t)warp * a.scratch;
  float* cz = reinterpret_cast<float*>(ws);
  unsigned* tb = ws + T + 1;

  const size_t first = (size_t)blockIdx.x * n_warps + warp;
  if (((uintptr_t)a.Q & 15) == 0) {
    for (int i = threadIdx.x; 4 * i + 3 < a.dim; i += blockDim.x)
      reinterpret_cast<float4*>(qs)[i] = __ldg(reinterpret_cast<const float4*>(a.Q) + i);
    for (int i = (a.dim & ~3) + threadIdx.x; i < a.dim; i += blockDim.x) qs[i] = a.Q[i];
  } else {
    for (int i = threadIdx.x; i < a.dim; i += blockDim.x) qs[i] = a.Q[i];
  }
  __syncthreads();

  for (size_t b = first; b < (size_t)a.B; b += (size_t)gridDim.x * n_warps) {
    const int* sp = a.sp + b * D;
    const int* sa = a.sa + b * D;
    const ST* seg = static_cast<const ST*>(a.seg) + b * T;
    const VT* vals = static_cast<const VT*>(a.vals) + b * T;

    // 1. gaps -> inclusive prefix sum t (modulo 2^32), 256 entries a step
    // (two chunks an iteration, so one chunk's loads overlap the other's scans)
    unsigned off = 0, t_run = 0;
#pragma unroll 2
    for (int g = lane; 8 * (g - lane) < T; g += 32) {
      unsigned gap[8];
      decode_group<CODE>(a, b, g, off, gap);
      unsigned run = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        run += gap[j];
        gap[j] = run;
      }
      const unsigned incl = warp_inclusive_scan<unsigned>(run);
      const unsigned pre = t_run + incl - run;
      t_run += __shfl_sync(kFull, incl, 31);
      if (8 * g < T) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ws[8 * g + j + 1] = pre + gap[j];
      }
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32)
      tb[d] = (unsigned)__ldg(sa + d) - ws[min(max(__ldg(sp + d), 0), T - 1) + 1];
    __syncwarp();

    // 2. rebase, gather q from shared memory, multiply; the products'
    // prefix sums replace t (each lane rewrites only the entries it read)
    float z_run = 0.f;
#pragma unroll 2
    for (int g = lane; 8 * (g - lane) < T; g += 32) {
      float incl[8], acc = 0.f;
      if (8 * g < T) {
        int s[8];
        float v[8];
        load8(seg + 8 * g, a.vec_e, s);
        load8(vals + 8 * g, a.vec_e, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p = 0.f;
          if (s[j] >= 0) {
            const unsigned c = tb[min(s[j], D - 1)] + ws[8 * g + j + 1];
            if (c < (unsigned)a.dim) p = __fmul_rn(qs[c], __fmul_rn(v[j], a.scale));
          }
          acc = __fadd_rn(acc, p);
          incl[j] = acc;
        }
      }
      const float w_incl = warp_inclusive_scan<float>(acc);
      float pre = __shfl_up_sync(kFull, w_incl, 1);
      pre = __fadd_rn(z_run, lane ? pre : 0.f);
      z_run = __fadd_rn(z_run, __shfl_sync(kFull, w_incl, 31));
      if (8 * g < T) {
#pragma unroll
        for (int j = 0; j < 8; ++j) cz[8 * g + j + 1] = __fadd_rn(pre, incl[j]);
      }
    }
    if (lane == 0) cz[0] = 0.f;
    __syncwarp();

    // 3. slot d = cz[end_d] - cz[start_d], lanes across slots
    for (int d = lane; d < D; d += 32) {
      int s0, end;
      const bool used = slot_run(sp, d, D, T, s0, end);
      const float s = used ? cz[end] - cz[s0] : 0.f;
      if (a.mode == kSlots)
        a.out[b * D + d] = s;
      else if (used)
        scatter_add(a, b, d, 0, s);
    }
    __syncwarp();  // the next block rewrites the scratch
  }
}

template <int CODE, typename VT, typename ST>
int launch_resident(Args a, cudaStream_t stream) {
  auto kernel = block_scan_resident_kernel<CODE, VT, ST>;
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  a.q_words = (a.dim + 3) & ~3;
  a.scratch = (a.T + 1 + a.D + 3) & ~3;
  const size_t fixed = (size_t)a.q_words * 4, per_warp = (size_t)a.scratch * 4;
  if (fixed + per_warp > (size_t)optin) return (int)cudaErrorInvalidValue;  // the wrapper's rule
  size_t warps = ((size_t)optin - fixed) / per_warp;
  warps = warps < (size_t)kResidentWarps ? warps : (size_t)kResidentWarps;
  const size_t smem = fixed + warps * per_warp;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * (int)warps, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t need = ((size_t)a.B + warps - 1) / warps;
  const size_t grid = need < (size_t)sms * per_sm ? need : (size_t)sms * per_sm;
  a.vec_e = ((uintptr_t)a.seg & 15) == 0 && ((uintptr_t)a.vals & 15) == 0;
  a.vec_p = CODE < kBitpack ? rows_aligned(a.p1, a.p1_w) : rows_aligned(a.p0, 4ll * a.p0_w);
  kernel<<<(unsigned)grid, 32 * (unsigned)warps, smem, stream>>>(a);
  return 0;
}

template <int CODE, typename VT, typename ST>
int launch(Args a, cudaStream_t stream) {
  if (a.stage == kResidentQuery) return launch_resident<CODE, VT, ST>(a, stream);
  const int threads = ((a.T / 8 + 31) / 32) * 32;
  const bool lanes = a.stage == kQueryLanes;
  const size_t ents = (size_t)a.T * sizeof(Ent);
  const int tile = a.nq < kQueryTile ? a.nq : kQueryTile;
  const size_t slots = (size_t)tile * (a.D + 1) * sizeof(float);
  a.staged = lanes && a.mode == kSlots && ents + slots <= kDefaultSmem;
  const size_t smem = lanes ? ents + (a.staged ? slots : 0)
                            : (size_t)(a.T + 1) * sizeof(unsigned);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_scan_kernel<CODE, VT, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned tiles = lanes ? (unsigned)((a.nq + kQueryTile - 1) / kQueryTile) : 1u;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  block_scan_kernel<CODE, VT, ST><<<dim3((unsigned)a.B, tiles), threads, smem, stream>>>(a);
  return 0;
}

template <int CODE>
int launch_code(const Args& a, int vals_t, int seg_t, cudaStream_t stream) {
  if constexpr (CODE % KERNEL_PARTS != KERNEL_PART) {
    return (int)cudaErrorInvalidValue;  // compiled into another part
  } else {
    switch (vals_t * 2 + seg_t) {
      case kValsF32 * 2 + kSegI32: return launch<CODE, float, int32_t>(a, stream);
      case kValsF32 * 2 + kSegI8: return launch<CODE, float, int8_t>(a, stream);
      case kValsF16 * 2 + kSegI32: return launch<CODE, __half, int32_t>(a, stream);
      case kValsF16 * 2 + kSegI8: return launch<CODE, __half, int8_t>(a, stream);
      case kValsU8 * 2 + kSegI32: return launch<CODE, uint8_t, int32_t>(a, stream);
      case kValsU8 * 2 + kSegI8: return launch<CODE, uint8_t, int8_t>(a, stream);
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

// Launch variant (code, vals_t, seg_t) with scoring stage `stage` and output
// mode `mode` on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take or a variant this
// part does not hold. The numbers are the enums above; `Q` is Qt [dim, nq]
// under query lanes, and doc_ids / n_docs are read in the scatter mode only.
int block_scan(int code, int vals_t, int seg_t, int stage, int mode, const void* Q,
               const void* p0, const void* p1, const void* seg, const void* start_pos,
               const void* start_abs, const void* vals, const void* doc_ids, void* out,
               int nq, int dim, int B, int T, int D, int p0_w, int p1_w, int n_docs,
               float scale, void* stream) {
  if (code < 0 || code >= kCodes || T <= 0 || T % 128 || T > kMaxT || D <= 0 || B <= 0 ||
      nq <= 0 || dim <= 0 || stage < kEntryLanes || stage > kResidentQuery ||
      (stage == kResidentQuery && nq != 1) ||
      (mode != kSlots && mode != kScatter) || (mode == kScatter && (!doc_ids || n_docs < 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)Q, p0, p1, seg, (const int*)start_pos, (const int*)start_abs,
               vals, (const int*)doc_ids, (float*)out, nq, dim, B, T, D, p0_w, p1_w,
               n_docs, stage, mode, 0, 0, 0, 0, 0, scale};
  const int rc = dispatch(code, a, vals_t, seg_t, (cudaStream_t)stream,
                          std::make_integer_sequence<int, kCodes>{});
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* block_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
