// Top-k selection along the rows of a score matrix, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the counterpart of the jax.lax.top_k that
// the reference's flat engine (repro/serve/engines/flat.py) leaves to XLA, and
// of the port's serve/api.py::top_k, a full stable descending sort. It was
// added because that sort set the flat engine's pace: over [128, 1,000,001]
// f32 scores on an H100 the sort's three radix passes took ~10 ms a batch,
// more than the rows kernel that computed the scores (PERF.md).
//
// Contract (checked by the Python wrapper, kernels/topk.py):
//   scores  f32 [nq, n_cols]   row-major, contiguous, n_cols < 2**31
//   k       1 <= k <= min(n_cols, 256)
//   n_valid 0 <= n_valid <= n_cols; columns >= n_valid read as -inf
//   part    u64 [nq, S, k]     scratch: each chunk's k largest keys
//   values  f32 [nq, k]        idx i32 [nq, k]
// The result is exactly the first k entries of
// torch.sort(masked, dim=-1, descending=True, stable=True), `masked` being
// `scores` with the columns >= n_valid set to -inf: the lower index first on
// ties.
//
// Order. Element j of a row gets one 64-bit key: its high 32 bits map the
// float to an unsigned integer in the same order (-0.0 read as +0.0, as the
// sort counts them equal; a NaN the largest key, or the lowest, below -inf,
// where its sign bit is set, as jax.lax.top_k orders them; a column >= n_valid
// the key of -inf), its low 32 bits are ~j, so of two equal floats the lower
// index has the larger key. Keys are distinct, and the k largest keys are the
// answer in order. Values are read back from `scores` by index (-inf for a
// masked column), so they are the input's bits. Where sorts differ: torch.sort
// on the CPU puts a NaN with its sign bit set first (on the card last, as
// here); jax.lax.top_k's total order also puts +0.0 above -0.0.
//
// Bound: bytes. Selection reads every score once, nq * n_cols * 4 bytes: 512 MB
// at [128, 1,000,001], 0.153 ms at 3.35 TB/s. The outputs and the scratch are a
// few KB.
//
// Design. Two passes on the caller's stream; neither allocates nor syncs, so
// both are captured in a CUDA graph.
//
// Pass 1, grid (nq, S), 128 threads: block (r, s) streams chunk s of row r's
// 16-byte-aligned body with 16-byte loads, neighbouring threads on neighbouring
// addresses, four loads in flight a thread. (The <= 6 columns outside the body
// go to chunk 0.) The block keeps its running k largest keys sorted at the head
// of a shared array and the k-th of them in a register of every thread, the
// threshold. A thread forms each element's key and compares it with the
// threshold; only a key above it is appended, warp by warp, to a candidate
// buffer behind the head. So after the first few thousand elements of a chunk
// almost every element costs one comparison and nothing else, and the pass
// stays near one read of the matrix. Every 512 elements the block checks the
// buffer's fill (__syncthreads_or, one barrier); once it holds K candidates or
// more (K the bucket of k, a template argument) it sorts head and buffer
// together (bitonic, in shared memory), keeps the head and raises the
// threshold. A step adds at most 512 candidates, so head and buffer never pass
// 2K + 511 <= 1,024 keys (8 KB). Each block writes its k largest keys to `part`.
//
// Pass 2, grid nq, 256 threads: one block a row sorts the row's S * k keys
// (<= 4,096, in shared memory) and writes the k largest as values and indices.
//
// S (topk_select_chunks, which the wrapper asks before it sizes `part`) puts up
// to kBlocksPerSM blocks of pass 1 on each SM, all resident at once, so the loads
// of enough blocks are in flight to keep the memory busy: 32 KB of loads an SM.
// No chunk takes fewer than kMinChunk columns, and pass 2 merges at most
// kMergeKeys keys a row (S * k).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;               // pass 1 block
constexpr int kInFlight = 4;                // 16-byte loads in flight a thread
constexpr int kBlocksPerSM = 8;             // resident pass-1 blocks an SM (<= 64 registers)
constexpr int kStep = 4 * kThreads;         // elements a block offers between checks
constexpr int kKeys = 1024;                 // pass 1's shared keys, >= 2 * 256 + kStep - 1
constexpr int kMergeThreads = 256;          // pass 2 block
constexpr int kMergeKeys = 4096;            // pass 2's shared keys: S * k <= kMergeKeys
constexpr int kMinChunk = 4096;             // the fewest columns a pass-1 chunk takes
constexpr int kMaxK = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNegInfKey = 0x007FFFFFu;  // ~0xFF800000, the key of -inf

static_assert(2 * kMaxK + kStep - 1 <= kKeys, "head and buffer must fit the shared keys");

// The order-preserving key of column j holding v (see the head note).
__device__ __forceinline__ u64 make_key(float v, int j, int n_valid) {
  unsigned u = __float_as_uint(v);
  unsigned hi;
  if (j >= n_valid) {
    hi = kNegInfKey;
  } else if ((u & 0x7FFFFFFFu) > 0x7F800000u) {  // NaN: first, or last where negative
    hi = (u & 0x80000000u) ? 0u : 0xFFFFFFFFu;
  } else {
    if (u == 0x80000000u) u = 0u;  // -0.0 ties +0.0
    hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((u64)hi << 32) | (u64)(~(unsigned)j);
}

// Sort keys[0, n2) descending, n2 a power of two; every thread of the block
// calls it; it ends with a barrier once n2 >= 2.
__device__ void sort_desc(u64* keys, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n2 >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 a = keys[lo], b = keys[hi];
        if ((a < b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Offer one key a thread (every lane of the warp calls it): a valid key above
// the threshold goes to the buffer, keys[K + ...]. `filled` becomes the
// buffer's count after this warp's last append, so the block's largest
// `filled` is its count.
template <int K>
__device__ __forceinline__ void offer(u64 key, bool valid, u64 thr, u64* keys, int* count,
                                      int& filled) {
  const bool p = valid && key > thr;
  const unsigned m = __ballot_sync(kFull, p);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (p) keys[K + base + __popc(m & ((1u << lane) - 1u))] = key;
  filled = base + __popc(m);
}

// Sort the head and the buffer together, empty the buffer; returns the new
// threshold, the k-th largest key. Called by every thread right after a
// barrier that follows every append.
template <int K>
__device__ u64 merge(u64* keys, int* count, int k) {
  const int n = K + *count;
  int n2 = K;
  while (n2 < n) n2 <<= 1;
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) keys[i] = 0ull;
  __syncthreads();  // every thread has read the count
  if (threadIdx.x == 0) *count = 0;
  sort_desc(keys, n2);
  return keys[k - 1];
}

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) topk_chunk_kernel(
    const float* __restrict__ scores, int n_cols, int n_valid, int k, int S,
    u64* __restrict__ part) {
  __shared__ u64 keys[kKeys];
  __shared__ int count;
  const int r = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const float* row = scores + (size_t)r * n_cols;
  // the row's 16-byte-aligned body: [lead, tail) in float4s of n_vec
  int lead = (int)(((16u - (unsigned)((uintptr_t)row & 15u)) & 15u) >> 2);
  if (lead > n_cols) lead = n_cols;
  const int n_vec = (n_cols - lead) >> 2;
  const int tail = lead + 4 * n_vec;
  const int per = (n_vec + S - 1) / S;
  const int v0 = min(s * per, n_vec);
  const int v1 = min(v0 + per, n_vec);
  const float4* body = reinterpret_cast<const float4*>(row + lead);

  for (int i = tid; i < K; i += kThreads) keys[i] = 0ull;  // below every real key (its low half ~j >= 2**31)
  if (tid == 0) count = 0;
  __syncthreads();
  u64 thr = 0ull;
  int filled = 0;

  if (s == 0) {  // the <= 6 columns outside the body
    const int n_stray = lead + (n_cols - tail);
    const bool valid = tid < n_stray;
    const int j = tid < lead ? tid : tail + (tid - lead);
    const float v = valid ? row[j] : 0.f;
    offer<K>(make_key(v, j, n_valid), valid, thr, keys, &count, filled);
    if (__syncthreads_or(filled >= K)) {
      thr = merge<K>(keys, &count, k);
      filled = 0;
    }
  }

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n_steps = (v1 - v0 + kThreads - 1) / kThreads;
  float4 buf[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int vi = v0 + u * kThreads + tid;
    buf[u] = vi < v1 ? __ldcs(body + vi) : zero;
  }
  for (int step0 = 0; step0 < n_steps; step0 += kInFlight) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int step = step0 + u;
      if (step >= n_steps) break;  // the same for the whole block
      const float4 x = buf[u];
      const int vi = v0 + step * kThreads + tid;
      const int vn = vi + kInFlight * kThreads;
      buf[u] = vn < v1 ? __ldcs(body + vn) : zero;
      const bool valid = vi < v1;
      const int j = valid ? lead + 4 * vi : 0;
      offer<K>(make_key(x.x, j, n_valid), valid, thr, keys, &count, filled);
      offer<K>(make_key(x.y, j + 1, n_valid), valid, thr, keys, &count, filled);
      offer<K>(make_key(x.z, j + 2, n_valid), valid, thr, keys, &count, filled);
      offer<K>(make_key(x.w, j + 3, n_valid), valid, thr, keys, &count, filled);
      if (__syncthreads_or(filled >= K)) {
        thr = merge<K>(keys, &count, k);
        filled = 0;
      }
    }
  }
  if (__syncthreads_or(filled > 0)) merge<K>(keys, &count, k);
  u64* out = part + ((size_t)r * S + s) * k;
  for (int i = tid; i < k; i += kThreads) out[i] = keys[i];
}

__global__ void __launch_bounds__(kMergeThreads) topk_merge_kernel(
    const u64* __restrict__ part, const float* __restrict__ scores, int n_cols, int n_valid,
    int k, int S, float* __restrict__ values, int* __restrict__ idx) {
  __shared__ u64 keys[kMergeKeys];
  const int r = blockIdx.x;
  const int n = S * k;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  const u64* src = part + (size_t)r * n;
  for (int i = threadIdx.x; i < n2; i += kMergeThreads) keys[i] = i < n ? src[i] : 0ull;
  __syncthreads();
  sort_desc(keys, n2);
  __syncthreads();
  const float* row = scores + (size_t)r * n_cols;
  for (int i = threadIdx.x; i < k; i += kMergeThreads) {
    const int j = (int)~(unsigned)keys[i];
    values[(size_t)r * k + i] = j < n_valid ? row[j] : __int_as_float(0xFF800000);
    idx[(size_t)r * k + i] = j;
  }
}

template <int K>
void launch_chunks(dim3 grid, cudaStream_t st, const float* scores, int n_cols, int n_valid,
                   int k, int S, u64* part) {
  topk_chunk_kernel<K><<<grid, kThreads, 0, st>>>(scores, n_cols, n_valid, k, S, part);
}

}  // namespace

extern "C" {

// Pass 1's chunks a row, S, on a device of `n_sms` SMs: kBlocksPerSM blocks an
// SM over the nq rows, no chunk under kMinChunk columns (one at least), and at
// most kMergeKeys keys (S * k) for pass 2.
int topk_select_chunks(int nq, int n_cols, int k, int n_sms) {
  int S = n_sms * kBlocksPerSM / (nq > 1 ? nq : 1);
  if (S > n_cols / kMinChunk) S = n_cols / kMinChunk;
  if (k >= 1 && S > kMergeKeys / k) S = kMergeKeys / k;
  return S > 1 ? S : 1;
}

// Select the k largest of each row of `scores` into `values` and `idx`, with
// `part` [nq, S, k] u64 as scratch, on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a shape the kernel does not take.
int topk_select(const void* scores, int nq, int n_cols, int k, int n_valid, int S, void* part,
                void* values, void* idx, void* stream) {
  if (nq <= 0 || n_cols <= 0 || k < 1 || k > n_cols || k > kMaxK || n_valid < 0 ||
      n_valid > n_cols || S < 1 || S > 65535 || (long long)S * k > kMergeKeys)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)nq, (unsigned)S);
  const float* sc = (const float*)scores;
  u64* pt = (u64*)part;
  if (k <= 16) launch_chunks<16>(grid, st, sc, n_cols, n_valid, k, S, pt);
  else if (k <= 32) launch_chunks<32>(grid, st, sc, n_cols, n_valid, k, S, pt);
  else if (k <= 64) launch_chunks<64>(grid, st, sc, n_cols, n_valid, k, S, pt);
  else if (k <= 128) launch_chunks<128>(grid, st, sc, n_cols, n_valid, k, S, pt);
  else launch_chunks<256>(grid, st, sc, n_cols, n_valid, k, S, pt);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  topk_merge_kernel<<<nq, kMergeThreads, 0, st>>>(pt, sc, n_cols, n_valid, k, S,
                                                   (float*)values, (int*)idx);
  return (int)cudaGetLastError();
}

const char* topk_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
