// window_stats: every reduction one stats row needs.
//
// Replaces the TPU kernel `window_stats_pallas` / `_kernel` in
// src/repro/kernels/window_stats/kernel.py. Task side: running and pending
// counts, the (12, 2) priority x {running, pending} histogram (priority
// clipped to 0..11), the usage sum over running tasks. Node side: active
// capacity, reserved and used sums, the active-node count, and the
// variances of per-node CPU utilisation (used/max(total,1e-9), column 0)
// and of per-node mean reserved fraction.
//
// Bound on this card: reading the task table once, about 9.7 MB at
// T=262,144 (usage 8.4 MB, priorities 1 MB, states 0.26 MB), about 3 us at
// 3.35 TB/s; the node table adds 0.46 MB.
// Design: one launch, one thread-block cluster of CLUSTER = 16 blocks of
// 1,024 threads a lane; deterministic, no float atomics.
//   Nodes first: block k takes the k-th of 16 node chunks, one node a
//   thread at cell A (further nodes loop). Sweep 1 forms the sums, the
//   count and the two per-node ratios, which the thread keeps in
//   registers for its first node.
//   Tasks: block k sweeps the k-th of 16 contiguous task chunks, thread i
//   every 1,024th task from i, AHEAD tasks loaded before they are added;
//   it adds the usage columns of its rows in task order. The histogram is
//   counted a warp at a time without atomics: five ballots of the 5-bit
//   key (priority x state) and one popcount give lane k the warp's count
//   of bin k. (Streaming the chunk through shared memory with bulk copies
//   was measured no faster: 16 SMs pull the 9.7 MB task table in about
//   the same time either way; see PERF.md.)
//   Each block reduces its partials with warp shuffles (a fixed butterfly,
//   then the same over its 32 warp sums) into shared memory. After a
//   cluster barrier every block reads the 16 blocks' count and ratio sums
//   over distributed shared memory in rank order, so all hold the same two
//   means; block 0 also adds the other partials in rank order and writes
//   them. Sweep 2 forms the squared deviations, each block stores its two
//   sums into block 0's shared memory, and after a second barrier block 0
//   adds them in rank order. The shape (16 chunks, 1,024 threads) does not
//   depend on the lane count, so a lane's result does not either.
// Integer outputs are exact; on grid-aligned data the float sums are exact
// too. The per-node ratio terms of the two variances are inexact, so their
// sums (for the means and for the squares) are accumulated in f64 and
// rounded once to f32, as the plain version does: kernel and plain version
// then agree whatever order each sums in. IEEE division, no FMA
// contraction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int N_PRIO = 12;
constexpr int HIST = N_PRIO * 2;
constexpr int MAX_U = 16;
constexpr int MAX_R = 4;
constexpr int CLUSTER = 16;          // blocks a lane (non-portable size)
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
static_assert(WARPS == 32, "the block reductions read one warp sum a lane");
constexpr int AHEAD = 2;             // tasks a thread loads before it adds
constexpr int QF = MAX_U + 3 * MAX_R;   // float partials: usage, cap, rsv, used
constexpr int QI = HIST + 1;         // int partials: histogram, active nodes
constexpr int NONE = 31;             // key of a task in neither column
constexpr int TASK_PENDING = 1, TASK_RUNNING = 2;
constexpr unsigned FULL = 0xffffffffu;

// One block's partials, read by the cluster over distributed shared memory.
struct Part {
  float f[QF];          // usage[U], cap[R], reserved[R], used[R]
  double d[2];          // sums of the utilisation and reserved ratios
  int i[QI];            // histogram bins, active nodes
};

template <class V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

// Node n's ratios: utilisation (column 0) and mean reserved fraction, 0
// when inactive; adds its terms to the capacity, reserved and used sums.
template <bool SUMS>
__device__ __forceinline__ void node_terms(
    int n, int R, float inv_r, const unsigned char* __restrict__ active,
    const float* __restrict__ total, const float* __restrict__ reserved,
    const float* __restrict__ used, bool& a, float& util, float& resf,
    float* cap, float* rsv, float* usd) {
  a = active[n] != 0;
  float rs = 0.0f;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      const size_t o = (size_t)n * R + r;
      const float t = total[o];
      const float rv = reserved[o];
      if (SUMS) {
        cap[r] = cap[r] + (a ? t : 0.0f);
        rsv[r] = rsv[r] + rv;
        usd[r] = usd[r] + used[o];
      }
      rs = rs + (a ? rv / fmaxf(t, 1e-9f) : 0.0f);
    }
  }
  util = a ? used[(size_t)n * R] / fmaxf(total[(size_t)n * R], 1e-9f) : 0.0f;
  resf = rs * inv_r;
}

// A task's histogram key and masked usage terms. Called by every lane of
// the warp together (a task past the chunk has st = 0): five ballots of
// the key's bits leave the warp's count of bin `lane` in cnt.
template <int UM>
__device__ __forceinline__ void add_task(int st, int pr, const float (&row)[UM],
                                         float (&acc)[UM], int& cnt,
                                         const unsigned (&sel)[5]) {
  const bool running = st == TASK_RUNNING;
  const int p = pr < 0 ? 0 : (pr > N_PRIO - 1 ? N_PRIO - 1 : pr);
  const int key = running ? 2 * p : st == TASK_PENDING ? 2 * p + 1 : NONE;
  const float m = running ? 1.0f : 0.0f;
#pragma unroll
  for (int u = 0; u < UM; ++u) acc[u] = acc[u] + m * row[u];
  unsigned match = FULL;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    match &= __ballot_sync(FULL, (key >> j) & 1) ^ sel[j];
  }
  cnt += __popc(match);
}

// UM: the usage columns a thread carries (8 for U <= 8, else 16).
template <int UM>
__global__ void __launch_bounds__(THREADS, 1) window_stats_kernel(
    const signed char* __restrict__ state, const float* __restrict__ usage,
    const int* __restrict__ prio, const unsigned char* __restrict__ active,
    const float* __restrict__ total, const float* __restrict__ reserved,
    const float* __restrict__ used, int* __restrict__ iout,
    float* __restrict__ fout, int T, int U, int N, int R) {
  __shared__ Part part;
  __shared__ float wf[QF][WARPS];
  __shared__ double wd[2][WARPS];
  __shared__ int wi[QI][WARPS];
  __shared__ double sq[CLUSTER][2];    // block 0: the blocks' sweep-2 sums
  __shared__ float mean_s[2];
  __shared__ int hist_s[HIST];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  state += b * T;
  usage += b * T * U;
  prio += b * T;
  active += b * N;
  total += b * N * R;
  reserved += b * N * R;
  used += b * N * R;

  // ---- nodes, sweep 1: sums, count, ratio sums; the thread's first
  // node's ratios kept for sweep 2 ----
  const float inv_r = 1.0f / (float)R;
  bool a0 = false;
  float util0 = 0.0f, resf0 = 0.0f;
  const int nchunk = (N + CLUSTER - 1) / CLUSTER;
  const int nlo = rank * nchunk, nhi = min(N, nlo + nchunk);
  {
    float cap[MAX_R], rsv[MAX_R], usd[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) cap[r] = rsv[r] = usd[r] = 0.0f;
    int n_act = 0;
    double util_sum = 0.0, res_sum = 0.0;
    for (int n = nlo + tid; n < nhi; n += THREADS) {
      bool a;
      float util, resf;
      node_terms<true>(n, R, inv_r, active, total, reserved, used, a, util,
                       resf, cap, rsv, usd);
      n_act += a ? 1 : 0;
      util_sum = util_sum + (double)util;
      res_sum = res_sum + (double)resf;
      if (n == nlo + tid) {
        a0 = a;
        util0 = util;
        resf0 = resf;
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) {
        const float c = warp_sum(cap[r]);
        const float rv = warp_sum(rsv[r]);
        const float us = warp_sum(usd[r]);
        if (lane == 0) {
          wf[MAX_U + r][warp] = c;
          wf[MAX_U + MAX_R + r][warp] = rv;
          wf[MAX_U + 2 * MAX_R + r][warp] = us;
        }
      }
    }
    n_act = warp_sum(n_act);
    util_sum = warp_sum(util_sum);
    res_sum = warp_sum(res_sum);
    if (lane == 0) {
      wi[HIST][warp] = n_act;
      wd[0][warp] = util_sum;
      wd[1][warp] = res_sum;
    }
  }

  // ---- tasks: this block's chunk; thread tid takes every THREADS-th
  // task from lo + tid, AHEAD of them loaded before they are added ----
  float acc[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) acc[u] = 0.0f;
  unsigned sel[5];          // lane k's bit pattern, as ballot masks
#pragma unroll
  for (int j = 0; j < 5; ++j) sel[j] = ((lane >> j) & 1) ? 0u : FULL;
  int cnt = 0;              // lane k < 24: the warp's count of bin k
  const bool vec = (U & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(usage) & 15) == 0;
  const int chunk = (T + CLUSTER - 1) / CLUSTER;
  const int lo = min(T, rank * chunk), hi = min(T, lo + chunk);
  for (int t0 = lo; t0 < hi; t0 += THREADS * AHEAD) {
    int st[AHEAD], pr[AHEAD];
    float row[AHEAD][UM];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int t = t0 + k * THREADS + tid;
      const bool in = t < hi;
      st[k] = in ? state[t] : 0;
      pr[k] = in ? prio[t] : 0;
      const float* src = usage + (size_t)(in ? t : 0) * U;
      if (vec) {
#pragma unroll
        for (int u = 0; u < UM; u += 4) {
          float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (in && u < U) {
            q = __ldcs(reinterpret_cast<const float4*>(src + u));
          }
          row[k][u] = q.x;
          row[k][u + 1] = q.y;
          row[k][u + 2] = q.z;
          row[k][u + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < UM; ++u) {
          row[k][u] = in && u < U ? __ldcs(src + u) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      add_task<UM>(st[k], pr[k], row[k], acc, cnt, sel);
    }
  }
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (u < U) {
      const float v = warp_sum(acc[u]);
      if (lane == 0) wf[u][warp] = v;
    }
  }
  if (lane < HIST) wi[lane][warp] = cnt;

  __syncthreads();
  // the block's partials: quantity q reduced by warp q % 32 over the warps
  for (int q = warp; q < QF + 2 + QI; q += WARPS) {
    if (q < QF) {
      const bool used_q = q < MAX_U ? q < U : (q - MAX_U) % MAX_R < R;
      if (used_q) {
        const float v = warp_sum(wf[q][lane]);
        if (lane == 0) part.f[q] = v;
      }
    } else if (q < QF + 2) {
      const double v = warp_sum(wd[q - QF][lane]);
      if (lane == 0) part.d[q - QF] = v;
    } else {
      const int v = warp_sum(wi[q - QF - 2][lane]);
      if (lane == 0) part.i[q - QF - 2] = v;
    }
  }
  cluster.sync();           // every block's partials are in place

  // ---- the lane's totals, in rank order ----
  const int nf = 3 + HIST;            // iout row: counts[3], hist[24]
  const int nfl = U + 3 * R + 2;      // fout row: usage, cap, rsv, used, vars
  int n_nodes = 0;          // thread 0: the lane's active nodes
  if (tid == 0) {           // every block: the means
    double us = 0.0, rs = 0.0;
    for (int k = 0; k < CLUSTER; ++k) {
      const Part* pk = cluster.map_shared_rank(&part, k);
      n_nodes += pk->i[HIST];
      us = us + pk->d[0];
      rs = rs + pk->d[1];
    }
    const float n_div = (float)(n_nodes > 1 ? n_nodes : 1);
    mean_s[0] = (float)us / n_div;
    mean_s[1] = (float)rs / n_div;
    if (rank == 0) iout[b * nf + 2] = n_nodes;
  }
  if (rank == 0 && tid >= 32 && tid < 32 + QF) {
    const int q = tid - 32;
    const bool u_col = q < MAX_U;
    const int r = (q - MAX_U) % MAX_R, g = (q - MAX_U) / MAX_R;
    if (u_col ? q < U : r < R) {
      float s = 0.0f;
      for (int k = 0; k < CLUSTER; ++k) {
        s = s + cluster.map_shared_rank(&part, k)->f[q];
      }
      fout[b * nfl + (u_col ? q : U + g * R + r)] = s;
    }
  }
  if (rank == 0 && tid >= 64 && tid < 64 + HIST) {
    const int q = tid - 64;
    int h = 0;
    for (int k = 0; k < CLUSTER; ++k) {
      h += cluster.map_shared_rank(&part, k)->i[q];
    }
    hist_s[q] = h;
    iout[b * nf + 3 + q] = h;
  }
  __syncthreads();
  if (rank == 0 && tid == 0) {
    int run = 0, pend = 0;
    for (int k = 0; k < N_PRIO; ++k) {
      run += hist_s[k * 2];
      pend += hist_s[k * 2 + 1];
    }
    iout[b * nf + 0] = run;
    iout[b * nf + 1] = pend;
  }

  // ---- nodes, sweep 2: squared deviations about the means ----
  const float util_mean = mean_s[0], res_mean = mean_s[1];
  double util_sq = 0.0, res_sq = 0.0;
  for (int n = nlo + tid; n < nhi; n += THREADS) {
    bool a = a0;
    float util = util0, resf = resf0;
    if (n != nlo + tid) {
      node_terms<false>(n, R, inv_r, active, total, reserved, used, a, util,
                        resf, nullptr, nullptr, nullptr);
    }
    if (a) {
      const float du = util - util_mean;
      const float dr = resf - res_mean;
      util_sq = util_sq + (double)(du * du);
      res_sq = res_sq + (double)(dr * dr);
    }
  }
  util_sq = warp_sum(util_sq);
  res_sq = warp_sum(res_sq);
  if (lane == 0) {
    wd[0][warp] = util_sq;
    wd[1][warp] = res_sq;
  }
  __syncthreads();
  if (warp == 0) {
    const double v0 = warp_sum(wd[0][lane]);
    const double v1 = warp_sum(wd[1][lane]);
    if (lane == 0) {
      double* dst = cluster.map_shared_rank(&sq[0][0], 0);
      dst[rank * 2] = v0;
      dst[rank * 2 + 1] = v1;
    }
  }
  cluster.sync();           // block 0 holds every block's sums; no block
                            // reads another's shared memory after this
  if (rank == 0 && tid == 0) {
    double us = 0.0, rs = 0.0;
    for (int k = 0; k < CLUSTER; ++k) {
      us = us + sq[k][0];
      rs = rs + sq[k][1];
    }
    const float n_div = (float)(n_nodes > 1 ? n_nodes : 1);
    fout[b * nfl + U + 3 * R] = (float)us / n_div;
    fout[b * nfl + U + 3 * R + 1] = (float)rs / n_div;
  }
}

template <int UM>
cudaError_t launch(const void* state, const void* usage, const void* prio,
                   const void* active, const void* total,
                   const void* reserved, const void* used, void* iout,
                   void* fout, int B, int T, int U, int N, int R,
                   cudaStream_t stream) {
  static bool big = false;        // 16-block clusters need the opt-in
  if (!big) {
    cudaError_t err = cudaFuncSetAttribute(
        window_stats_kernel<UM>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    big = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, window_stats_kernel<UM>, (const signed char*)state,
      (const float*)usage, (const int*)prio, (const unsigned char*)active,
      (const float*)total, (const float*)reserved, (const float*)used,
      (int*)iout, (float*)fout, T, U, N, R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// iout (B, 27) i32: [n_running, n_pending, n_nodes | hist (12, 2)];
// fout (B, U + 3R + 2) f32: [usage_sum | cap | reserved | used | util_var,
// res_var].
extern "C" int window_stats_launch(
    const void* state, const void* usage, const void* prio,
    const void* active, const void* total, const void* reserved,
    const void* used, void* iout, void* fout, int B, int T, int U, int N,
    int R, void* stream) {
  if (U < 1 || U > MAX_U || R < 1 || R > MAX_R || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (U <= 8) {
    return (int)launch<8>(state, usage, prio, active, total, reserved, used,
                          iout, fout, B, T, U, N, R, s);
  }
  return (int)launch<16>(state, usage, prio, active, total, reserved, used,
                         iout, fout, B, T, U, N, R, s);
}
