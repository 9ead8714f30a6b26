// segment_usage: per-node sums of per-task rows, for B lanes at once.
//
// Replaces the TPU kernel `segment_usage_pallas` / `_kernel` in
// src/repro/kernels/segment_usage/kernel.py: out[b, n, v] = sum of
// values[b, t, v] over the tasks t of lane b with mask[b, t] and
// task_node[b, t] == n; masked or unplaced (-1) rows are dropped and a node
// with no task gets 0. The TPU kernel keeps the (N, V) sums resident in
// VMEM and adds one-hot products of task tiles into them; this design keeps
// only index permutations and counts in device memory.
//
// Bound on this card: reading task_node, mask and values once and writing
// the sums, about 4.4 MB a lane at T=262,144, V=3 (1.3 us at 3.35 TB/s).
// The gather of the value rows in node order reads 12- or 24-byte rows at
// random: each touches one or two 32-byte sectors, so a lane's rows cost
// ~6-12 MB of sector traffic instead of 3-6 MB, mostly from the 50 MB L2.
// At this size the eight launches' fixed costs (a few us each) weigh more
// than the bytes.
//
// Design: deterministic, no float atomics, and each node's sum is taken in
// increasing task order from 0.0f, the order of the reference's sequential
// scatter-add. Per lane, the kept tasks (mask set, 0 <= node < N) are
// sorted by node with a stable LSD radix sort of 7-bit digits, as many
// passes as the largest node id needs: ceil(bits(N - 1) / 7), at least 1
// (the wrapper's digit_passes: 2 up to N = 16,384, e.g. cell A, 3 up to
// 2,097,152, at most 5 for any int32 id), then one thread per node run adds
// the run's rows in task order. Each pass launches, for all lanes at once:
//   1. per-tile digit counts (shared-memory integer atomics, and the lane's
//      digit totals by global integer atomics: sums of counts do not
//      depend on their order), stored digit-major;
//   2. one block per (digit, lane) that scans the digit's per-tile counts
//      after the smaller digits' total: every (digit, tile) gets its first
//      output slot; the first pass's grand total is the lane's kept count;
//   3. a stable scatter of task indices: inside a 1,024-task tile a warp
//      ranks equal digits by lane with __match_any_sync, and the (chunk,
//      warp) counts of each digit are scanned in task order in shared
//      memory; the last pass also writes the sorted node ids.
// 4. Then a thread per sorted position that starts a node's run adds the
//    run's value rows, UNROLL rows loaded at a time, into MAX_V
//    accumulators; wider rows are taken MAX_V columns at a time, the run
//    walked once per group, each column still summed in task order.
// Work is O(T + N) per lane whatever the node distribution: a node that
// holds every task costs one serial run of T adds (the order the sum must
// keep). 7-bit digits keep a tile's counters at 128 and the scans at
// 128 x ceil(T / 1,024) entries a lane; one 14-bit pass would need 16,384
// counters a tile. Everything launches from one entry point on the
// caller's stream; the scratch (counts, each pass's totals, two (B, T)
// permutations and the sorted node ids) comes from the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_V = 8;                    // value columns a group
constexpr int DIGIT_BITS = 7;
constexpr int RADIX = 1 << DIGIT_BITS;      // 128 buckets a pass
constexpr int MAX_PASSES = 5;               // 35 bits: any int32 node id
constexpr int THREADS = 256;                // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 4;                   // tasks a thread sorts
constexpr int TILE = THREADS * CHUNKS;      // tasks a block sorts
constexpr int UNROLL = 4;                   // run rows loaded together
constexpr unsigned FULL = 0xffffffffu;

// The digit of position i of a pass, or -1 when it carries no kept task;
// *task and *nd get the task and its node. Pass 0 reads the lane's tasks
// in task order, a later pass the permutation the pass before it wrote
// (its first `kept` positions).
__device__ __forceinline__ int digit_of(
    int pass, int i, int T, int N, const int* __restrict__ node,
    const unsigned char* __restrict__ mask, const int* __restrict__ perm,
    int kept, int* task, int* nd) {
  if (pass == 0) {
    if (i >= T) return -1;
    const int n = node[i];
    *task = i;
    *nd = n;
    return (mask[i] && n >= 0 && n < N) ? (n & (RADIX - 1)) : -1;
  }
  if (i >= kept) return -1;
  const int t = perm[i];
  *task = t;
  *nd = node[t];
  return (*nd >> (DIGIT_BITS * pass)) & (RADIX - 1);
}

// 1. counts[b][digit * n_tiles + tile] for one tile of one lane, and the
// lane's digit totals (integer atomics: the sums do not depend on order).
__global__ void __launch_bounds__(THREADS) radix_hist_kernel(
    int pass, const int* __restrict__ task_node,
    const unsigned char* __restrict__ mask, const int* __restrict__ perm_in,
    const int* __restrict__ kept, int* __restrict__ counts,
    int* __restrict__ totals, int T, int N, int n_tiles) {
  __shared__ int hist[RADIX];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const long long lane_t = (long long)b * T;
  const int k = pass == 0 ? T : kept[b];
  for (int d = tid; d < RADIX; d += THREADS) hist[d] = 0;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    int task, nd;
    const int d = digit_of(pass, tile * TILE + c * THREADS + tid, T, N,
                           task_node + lane_t, mask + lane_t,
                           perm_in + lane_t, k, &task, &nd);
    if (d >= 0) atomicAdd(&hist[d], 1);
  }
  __syncthreads();
  int* out = counts + (long long)b * RADIX * n_tiles;
  for (int d = tid; d < RADIX; d += THREADS) {
    out[(long long)d * n_tiles + tile] = hist[d];
    if (hist[d] != 0) atomicAdd(&totals[b * RADIX + d], hist[d]);
  }
}

// Block-wide exclusive scan of one int a thread; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int u = warp_sums[w];
    before += w < warp ? u : 0;
    all += u;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// 2. In place, one block per (digit, lane): the digit's row of per-tile
// counts -> each tile's first output slot, after every smaller digit's
// tasks. The last digit's block writes the lane's kept total when kept is
// not null.
__global__ void __launch_bounds__(THREADS) radix_scan_kernel(
    int* __restrict__ counts, const int* __restrict__ totals,
    int* __restrict__ kept, int n_tiles) {
  __shared__ int warp_sums[WARPS];
  const int d = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int base;
  block_exclusive_scan(tid < d ? totals[b * RADIX + tid] : 0, warp_sums,
                       &base);
  int* row = counts + ((long long)b * RADIX + d) * n_tiles;
  int carry = base;
  for (int r0 = 0; r0 < n_tiles; r0 += THREADS) {
    const int i = r0 + tid;
    const int v = i < n_tiles ? row[i] : 0;
    int sum;
    const int ex = block_exclusive_scan(v, warp_sums, &sum);
    if (i < n_tiles) row[i] = carry + ex;
    carry += sum;
  }
  if (kept != nullptr && d == RADIX - 1 && tid == 0) kept[b] = carry;
}

// 3. Stable scatter of one tile's task indices (and, when keys_out is not
// null, their nodes) into their slots. Inside the tile, task order is
// (chunk, warp, lane): a warp ranks equal digits by lane with
// __match_any_sync, and the (chunk, warp) counts of each digit are scanned
// in that order in shared memory.
__global__ void __launch_bounds__(THREADS) radix_scatter_kernel(
    int pass, const int* __restrict__ task_node,
    const unsigned char* __restrict__ mask, const int* __restrict__ perm_in,
    const int* __restrict__ kept, const int* __restrict__ offsets,
    int* __restrict__ perm_out, int* __restrict__ keys_out, int T, int N,
    int n_tiles) {
  __shared__ int slot[CHUNKS][WARPS][RADIX];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long lane_t = (long long)b * T;
  const int k = pass == 0 ? T : kept[b];
  for (int e = tid; e < CHUNKS * WARPS * RADIX; e += THREADS)
    (&slot[0][0][0])[e] = 0;
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  int task[CHUNKS], nd[CHUNKS], digit[CHUNKS], rank[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    task[c] = 0;
    nd[c] = 0;
    digit[c] = digit_of(pass, tile * TILE + c * THREADS + tid, T, N,
                        task_node + lane_t, mask + lane_t, perm_in + lane_t,
                        k, &task[c], &nd[c]);
    // lanes without a kept task (-1) form their own group, ignored
    const unsigned peers = __match_any_sync(FULL, digit[c]);
    rank[c] = __popc(peers & lower);
    if (digit[c] >= 0 && rank[c] == 0)
      slot[c][warp][digit[c]] = __popc(peers);
  }
  __syncthreads();
  const int* off = offsets + (long long)b * RADIX * n_tiles;
  for (int d = tid; d < RADIX; d += THREADS) {
    int run = off[(long long)d * n_tiles + tile];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int v = slot[c][w][d];
        slot[c][w][d] = run;
        run += v;
      }
  }
  __syncthreads();
  int* out = perm_out + lane_t;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (digit[c] < 0) continue;
    const int pos = slot[c][warp][digit[c]] + rank[c];
    out[pos] = task[c];
    if (keys_out != nullptr) keys_out[lane_t + pos] = nd[c];
  }
}

// 4. One thread per position of the sorted order: a thread that starts a
// node's run adds the run's value rows in task order (UNROLL rows loaded
// at a time; the rows after a run belong to larger nodes), MAX_V columns a
// group, and writes out[b][node].
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const int* __restrict__ keys, const int* __restrict__ perm,
    const float* __restrict__ values, const int* __restrict__ kept,
    float* __restrict__ out, int T, int V, int N) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int k = kept[b];
  if (i >= k) return;
  const long long lane_t = (long long)b * T;
  const int* key = keys + lane_t;
  const int* p = perm + lane_t;
  const float* val = values + lane_t * V;
  const int n = key[i];
  if (i > 0 && key[i - 1] == n) return;
  float* o = out + ((long long)b * N + n) * V;
  for (int v0 = 0; v0 < V; v0 += MAX_V) {
    const int nv = min(MAX_V, V - v0);
    float acc[MAX_V];
#pragma unroll
    for (int v = 0; v < MAX_V; ++v) acc[v] = 0.0f;
    bool more = true;
    for (int j = i; more; j += UNROLL) {
      bool in[UNROLL];
      float row[UNROLL][MAX_V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        in[u] = j + u < k && key[j + u] == n;
        const float* src =
            val + (long long)(in[u] ? p[j + u] : 0) * V + v0;
#pragma unroll
        for (int v = 0; v < MAX_V; ++v)
          row[u][v] = (in[u] && v < nv) ? src[v] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (in[u]) {
#pragma unroll
          for (int v = 0; v < MAX_V; ++v)
            if (v < nv) acc[v] = acc[v] + row[u][v];
        }
      more = in[UNROLL - 1];
    }
    for (int v = 0; v < nv; ++v) o[v0 + v] = acc[v];
  }
}

}  // namespace

// Scratch ints the wrapper must pass: B * (RADIX * ceil(T / TILE) +
// passes * RADIX + 1 + 3 * T).
extern "C" long long segment_usage_scratch_ints(int B, int T, int passes) {
  const long long n_tiles = (T + TILE - 1) / TILE;
  return (long long)B * (RADIX * n_tiles + (long long)passes * RADIX + 1 +
                         3LL * T);
}

// task_node (B, T) i32, values (B, T, V) f32, mask (B, T) bool (one byte),
// out (B, N, V) f32, scratch of segment_usage_scratch_ints(B, T, passes)
// ints; `passes` 7-bit digits must hold every node id below N.
extern "C" int segment_usage_launch(
    const void* task_node, const void* values, const void* mask, void* out,
    void* scratch, long long scratch_ints, int B, int T, int V, int N,
    int passes, void* stream) {
  if (B < 1 || B > 65535 || T < 0 || V < 1 || N < 1 || passes < 1 ||
      passes > MAX_PASSES ||
      (passes < MAX_PASSES &&
       ((long long)(N - 1) >> (DIGIT_BITS * passes)) != 0) ||
      scratch_ints < segment_usage_scratch_ints(B, T, passes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * B * N * V, st);
  if (err != cudaSuccess || T == 0) return (int)err;
  const int n_tiles = (T + TILE - 1) / TILE;
  int* counts = static_cast<int*>(scratch);     // (B, RADIX, n_tiles)
  // (passes, B, RADIX)
  int* totals = counts + (long long)B * RADIX * n_tiles;
  int* kept = totals + (long long)passes * B * RADIX;     // (B,)
  int* perm[2] = {kept + B, kept + B + (long long)B * T};  // (B, T) each
  int* keys = perm[1] + (long long)B * T;
  err = cudaMemsetAsync(totals, 0, sizeof(int) * passes * B * RADIX, st);
  if (err != cudaSuccess) return (int)err;
  const int* node = static_cast<const int*>(task_node);
  const unsigned char* msk = static_cast<const unsigned char*>(mask);
  const dim3 tiles(n_tiles, B);
  for (int pass = 0; pass < passes; ++pass) {
    const int* in = perm[(pass + 1) % 2];       // unread in pass 0
    int* tot = totals + (long long)pass * B * RADIX;
    radix_hist_kernel<<<tiles, THREADS, 0, st>>>(pass, node, msk, in, kept,
                                                 counts, tot, T, N, n_tiles);
    radix_scan_kernel<<<dim3(RADIX, B), THREADS, 0, st>>>(
        counts, tot, pass == 0 ? kept : nullptr, n_tiles);
    radix_scatter_kernel<<<tiles, THREADS, 0, st>>>(
        pass, node, msk, in, kept, counts, perm[pass % 2],
        pass == passes - 1 ? keys : nullptr, T, N, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  segment_sum_kernel<<<dim3((T + THREADS - 1) / THREADS, B), THREADS, 0,
                       st>>>(keys, perm[(passes - 1) % 2],
                             static_cast<const float*>(values), kept,
                             static_cast<float*>(out), T, V, N);
  return (int)cudaGetLastError();
}
