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
// Design: two launches, both deterministic, no float atomics.
//   Stage 1: a grid of blocks sweeps contiguous task chunks; each thread
//   accumulates the usage columns of its rows in row order, the histogram
//   goes through integer shared-memory atomics (exact whatever the order),
//   and a fixed-shape tree reduces the usage columns; each block writes its
//   partial histogram and usage sums.
//   Stage 2: one block per lane adds the partials in block order and runs
//   the node pass: one sweep for the sums, the count and both means, a
//   second sweep for the variances (the mean comes first), each reduced by
//   a fixed-shape tree. Integer outputs are exact; on grid-aligned data the
//   float sums are exact too. The per-node ratio terms of the two variances
//   are inexact, so their sums (for the means and for the squares) are
//   accumulated in f64 and rounded once to f32, as the plain version does:
//   kernel and plain version then agree whatever order each sums in. IEEE
//   division, no FMA contraction.

#include <cuda_runtime.h>

namespace {

constexpr int N_PRIO = 12;
constexpr int HIST = N_PRIO * 2;
constexpr int MAX_U = 16;
constexpr int MAX_R = 4;
constexpr int T1 = 256;    // stage-1 threads per block
constexpr int T2 = 1024;   // stage-2 threads
constexpr int TASK_PENDING = 1, TASK_RUNNING = 2;

// Sum over the block in a fixed tree order (blockDim a power of two).
template <typename V>
__device__ V block_sum(V v, V* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = sh[tid] + sh[tid + s];
    __syncthreads();
  }
  const V out = sh[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(T1) task_partials_kernel(
    const signed char* __restrict__ state, const float* __restrict__ usage,
    const int* __restrict__ prio, int* __restrict__ part_hist,
    float* __restrict__ part_usum, int T, int U, int chunk) {
  __shared__ int hist[HIST];
  __shared__ float red[T1];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.y;
  const int g = blockIdx.x, G = gridDim.x;
  state += b * T;
  usage += b * T * U;
  prio += b * T;
  if (tid < HIST) hist[tid] = 0;
  __syncthreads();

  float acc[MAX_U];
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) acc[u] = 0.0f;
  const int lo = g * chunk;
  const int hi = min(T, lo + chunk);
  for (int t = lo + tid; t < hi; t += T1) {
    const int st = state[t];
    const bool running = st == TASK_RUNNING;
    int pr = prio[t];
    pr = pr < 0 ? 0 : (pr > N_PRIO - 1 ? N_PRIO - 1 : pr);
    if (running) atomicAdd(&hist[pr * 2], 1);
    if (st == TASK_PENDING) atomicAdd(&hist[pr * 2 + 1], 1);
    const float m = running ? 1.0f : 0.0f;
    const float* row = usage + (size_t)t * U;
#pragma unroll
    for (int u = 0; u < MAX_U; ++u) {
      if (u < U) acc[u] = acc[u] + m * row[u];
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_U; ++u) {
    if (u < U) {
      const float s = block_sum(acc[u], red);
      if (tid == 0) part_usum[(b * G + g) * U + u] = s;
    }
  }
  if (tid < HIST) part_hist[(b * G + g) * HIST + tid] = hist[tid];
}

__global__ void __launch_bounds__(T2) finish_kernel(
    const int* __restrict__ part_hist, const float* __restrict__ part_usum,
    const unsigned char* __restrict__ active,
    const float* __restrict__ total, const float* __restrict__ reserved,
    const float* __restrict__ used, int* __restrict__ counts,
    int* __restrict__ hist_out, float* __restrict__ usum_out,
    float* __restrict__ node_red, int G, int U, int N, int R) {
  __shared__ float fred[T2];
  __shared__ double dred[T2];
  __shared__ int ired[T2];
  __shared__ int hist[HIST];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  part_hist += b * G * HIST;
  part_usum += b * G * U;
  active += b * N;
  total += b * N * R;
  reserved += b * N * R;
  used += b * N * R;

  // --- partials, added in block order ---
  if (tid < HIST) {
    int h = 0;
    for (int g = 0; g < G; ++g) h += part_hist[g * HIST + tid];
    hist[tid] = h;
    hist_out[b * HIST + tid] = h;
  }
  if (tid >= 32 && tid - 32 < U) {
    const int u = tid - 32;
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s = s + part_usum[g * U + u];
    usum_out[b * U + u] = s;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0, pend = 0;
    for (int k = 0; k < N_PRIO; ++k) {
      run += hist[k * 2];
      pend += hist[k * 2 + 1];
    }
    counts[b * 3 + 0] = run;
    counts[b * 3 + 1] = pend;
  }

  // --- node pass, sweep 1: sums, count, means ---
  // the mean over R is the sum times the f32 reciprocal of R, as the
  // reference's mean rounds it
  const float inv_r = 1.0f / (float)R;
  float cap[MAX_R], rsv[MAX_R], usd[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) cap[r] = rsv[r] = usd[r] = 0.0f;
  int n_act = 0;
  double util_sum = 0.0, res_sum = 0.0;
  for (int n = tid; n < N; n += T2) {
    const bool a = active[n] != 0;
    n_act += a ? 1 : 0;
    float rs = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) {
        const float t = total[n * R + r];
        cap[r] = cap[r] + (a ? t : 0.0f);
        rsv[r] = rsv[r] + reserved[n * R + r];
        usd[r] = usd[r] + used[n * R + r];
        rs = rs + (a ? reserved[n * R + r] / fmaxf(t, 1e-9f) : 0.0f);
      }
    }
    util_sum = util_sum +
        (double)(a ? used[n * R] / fmaxf(total[n * R], 1e-9f) : 0.0f);
    res_sum = res_sum + (double)(rs * inv_r);
  }
  const int n_nodes = block_sum(n_act, ired);
  const float n_div = (float)(n_nodes > 1 ? n_nodes : 1);
  const float util_mean = (float)block_sum(util_sum, dred) / n_div;
  const float res_mean = (float)block_sum(res_sum, dred) / n_div;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < R) {
      const float c = block_sum(cap[r], fred);
      const float rv = block_sum(rsv[r], fred);
      const float us = block_sum(usd[r], fred);
      if (tid == 0) {
        node_red[b * (3 * R + 2) + r] = c;
        node_red[b * (3 * R + 2) + R + r] = rv;
        node_red[b * (3 * R + 2) + 2 * R + r] = us;
      }
    }
  }

  // --- node pass, sweep 2: variances about the means ---
  double util_sq = 0.0, res_sq = 0.0;
  for (int n = tid; n < N; n += T2) {
    if (active[n] == 0) continue;
    const float du = used[n * R] / fmaxf(total[n * R], 1e-9f) - util_mean;
    float rs = 0.0f;
    for (int r = 0; r < R; ++r) {
      rs = rs + reserved[n * R + r] / fmaxf(total[n * R + r], 1e-9f);
    }
    const float dr = rs * inv_r - res_mean;
    util_sq = util_sq + (double)(du * du);
    res_sq = res_sq + (double)(dr * dr);
  }
  const float util_var = (float)block_sum(util_sq, dred) / n_div;
  const float res_var = (float)block_sum(res_sq, dred) / n_div;
  if (tid == 0) {
    counts[b * 3 + 2] = n_nodes;
    node_red[b * (3 * R + 2) + 3 * R] = util_var;
    node_red[b * (3 * R + 2) + 3 * R + 1] = res_var;
  }
}

}  // namespace

extern "C" int window_stats_launch(
    const void* state, const void* usage, const void* prio,
    const void* active, const void* total, const void* reserved,
    const void* used, void* counts, void* hist, void* usum, void* node_red,
    void* part_hist, void* part_usum, int B, int T, int U, int N, int R,
    int G, void* stream) {
  if (U < 1 || U > MAX_U || R < 1 || R > MAX_R || G < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunk = (T + G - 1) / G;
  cudaStream_t s = (cudaStream_t)stream;
  task_partials_kernel<<<dim3(G, B), T1, 0, s>>>(
      (const signed char*)state, (const float*)usage, (const int*)prio,
      (int*)part_hist, (float*)part_usum, T, U, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<B, T2, 0, s>>>(
      (const int*)part_hist, (const float*)part_usum,
      (const unsigned char*)active, (const float*)total,
      (const float*)reserved, (const float*)used, (int*)counts, (int*)hist,
      (float*)usum, (float*)node_red, G, U, N, R);
  return (int)cudaGetLastError();
}
