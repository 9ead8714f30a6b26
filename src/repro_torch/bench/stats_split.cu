// stats_split: kernel C (csrc/window_stats.cu) beside the design it
// replaced (PR 11: stage 1, a grid of 256-thread blocks over task chunks
// writing partials; stage 2, one 1,024-thread block a lane adding them and
// sweeping the nodes twice), whose two launches are timed apart here. The
// old stages are kept below as they were, in namespace v1. Both run at
// cell A's shapes (T=262,144, U=8, N=12,500, R=3) for B=1 and B=8 lanes
// on grid-aligned inputs from a fixed seed, and their outputs are compared
// (integers and sums bitwise, variances within 2.5e-7); the kernel is also
// timed without its task side (T=0), without its node side (N=0) and
// without both. On a machine with the card, from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false \
//     -I src/repro_torch/csrc src/repro_torch/bench/stats_split.cu \
//     -o build/stats_split && build/stats_split
//
// Each line: the median of 20 launches (CUDA events, the 50 MB L2 flushed
// before each); the last line is one JSON object of the same numbers.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <vector>

#include "window_stats.cu"

namespace v1 {

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

}  // namespace v1

namespace {

#define CK(x)                                                       \
  do {                                                              \
    cudaError_t e = (x);                                            \
    if (e != cudaSuccess) {                                         \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e),   \
             __LINE__);                                             \
      exit(1);                                                      \
    }                                                               \
  } while (0)

template <class F>
float time_ms(F launch, unsigned char* flush, size_t flush_bytes) {
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  for (int i = 0; i < 2; ++i) launch();
  CK(cudaDeviceSynchronize());
  std::vector<float> t;
  for (int i = 0; i < 20; ++i) {
    CK(cudaMemsetAsync(flush, i, flush_bytes));
    CK(cudaEventRecord(e0));
    launch();
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms = 0.0f;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    t.push_back(ms);
  }
  CK(cudaGetLastError());
  std::sort(t.begin(), t.end());
  return t[t.size() / 2];
}

template <class T>
T* upload(const std::vector<T>& h) {
  T* d;
  CK(cudaMalloc(&d, h.size() * sizeof(T)));
  CK(cudaMemcpy(d, h.data(), h.size() * sizeof(T), cudaMemcpyHostToDevice));
  return d;
}

template <class T>
std::vector<T> download(const T* d, size_t n) {
  std::vector<T> h(n);
  CK(cudaMemcpy(h.data(), d, n * sizeof(T), cudaMemcpyDeviceToHost));
  return h;
}

}  // namespace

int main() {
  constexpr int T = 262144, U = 8, N = 12500, R = 3, BMAX = 8;
  constexpr int G = 256;               // the old stage 1's blocks a lane
  constexpr int FR = 3 * R + 2;          // node_red's row
  constexpr int NI = 3 + HIST, NF = U + FR;   // this kernel's out rows
  std::mt19937 rng(0);
  auto uni = [&](int lo, int hi) {
    return std::uniform_int_distribution<int>(lo, hi - 1)(rng);
  };
  std::vector<signed char> state(BMAX * T);
  std::vector<float> usage((size_t)BMAX * T * U), total(BMAX * N * R),
      reserved(BMAX * N * R), used(BMAX * N * R);
  std::vector<int> prio(BMAX * T);
  std::vector<unsigned char> active(BMAX * N);
  for (auto& x : state) x = (signed char)uni(0, 3);
  for (auto& x : usage) x = uni(0, 16) / 128.0f;
  for (auto& x : prio) x = uni(-1, 13);
  for (auto& x : active) x = uni(0, 100) < 95;
  for (auto& x : total) x = uni(64, 256) / 128.0f;
  for (auto& x : reserved) x = uni(0, 64) / 128.0f;
  for (auto& x : used) x = uni(0, 64) / 128.0f;
  const signed char* d_state = upload(state);
  const float* d_usage = upload(usage);
  const int* d_prio = upload(prio);
  const unsigned char* d_active = upload(active);
  const float* d_total = upload(total);
  const float* d_reserved = upload(reserved);
  const float* d_used = upload(used);
  int *counts, *hist, *part_hist, *iout;
  float *usum, *node_red, *part_usum, *fout;
  CK(cudaMalloc(&counts, BMAX * 3 * 4));
  CK(cudaMalloc(&hist, BMAX * v1::HIST * 4));
  CK(cudaMalloc(&usum, BMAX * U * 4));
  CK(cudaMalloc(&node_red, BMAX * FR * 4));
  CK(cudaMalloc(&part_hist, BMAX * G * v1::HIST * 4));
  CK(cudaMalloc(&part_usum, BMAX * G * U * 4));
  CK(cudaMalloc(&iout, BMAX * NI * 4));
  CK(cudaMalloc(&fout, BMAX * NF * 4));
  const size_t flush_bytes = 64u << 20;
  unsigned char* flush;
  CK(cudaMalloc(&flush, flush_bytes));

  std::string json = "{\"stats_split\": [";
  for (int B : {1, BMAX}) {
    const int chunk = (T + G - 1) / G;
    auto stage1 = [&]() {
      v1::task_partials_kernel<<<dim3(G, B), v1::T1>>>(
          d_state, d_usage, d_prio, part_hist, part_usum, T, U, chunk);
    };
    auto stage2 = [&]() {
      v1::finish_kernel<<<B, v1::T2>>>(
          part_hist, part_usum, d_active, d_total, d_reserved, d_used,
          counts, hist, usum, node_red, G, U, N, R);
    };
    auto both = [&]() { stage1(); stage2(); };
    auto now = [&]() {
      CK(launch<8>(d_state, d_usage, d_prio, d_active, d_total, d_reserved,
                   d_used, iout, fout, B, T, U, N, R, 0));
    };
    both();
    now();
    CK(cudaDeviceSynchronize());
    const auto c0 = download(counts, B * 3), h0 = download(hist, B * HIST);
    const auto u0 = download(usum, B * U), r0 = download(node_red, B * FR);
    const auto i1 = download(iout, B * NI);
    const auto f1 = download(fout, B * NF);
    bool same = true;
    double var_rel = 0.0;
    for (int b = 0; b < B; ++b) {
      for (int k = 0; k < 3; ++k) same &= c0[b * 3 + k] == i1[b * NI + k];
      for (int k = 0; k < HIST; ++k) {
        same &= h0[b * HIST + k] == i1[b * NI + 3 + k];
      }
      for (int k = 0; k < U; ++k) same &= u0[b * U + k] == f1[b * NF + k];
      for (int k = 0; k < 3 * R; ++k) {
        same &= r0[b * FR + k] == f1[b * NF + U + k];
      }
      for (int k = 3 * R; k < FR; ++k) {
        const double a = r0[b * FR + k], c = f1[b * NF + U + k];
        var_rel = std::max(var_rel, std::fabs(a - c) / std::fabs(a));
      }
    }
    same &= var_rel <= 2.5e-7;
    const float t1 = time_ms(stage1, flush, flush_bytes);
    const float t2 = time_ms(stage2, flush, flush_bytes);
    const float t12 = time_ms(both, flush, flush_bytes);
    const float tn = time_ms(now, flush, flush_bytes);
    // the same launch without its task side (T=0) or its node side (N=0):
    // where this kernel's time goes
    const float t_nodes = time_ms([&]() {
      CK(launch<8>(d_state, d_usage, d_prio, d_active, d_total, d_reserved,
                   d_used, iout, fout, B, 0, U, N, R, 0));
    }, flush, flush_bytes);
    const float t_tasks = time_ms([&]() {
      CK(launch<8>(d_state, d_usage, d_prio, d_active, d_total, d_reserved,
                   d_used, iout, fout, B, T, U, 0, R, 0));
    }, flush, flush_bytes);
    const float t_none = time_ms([&]() {
      CK(launch<8>(d_state, d_usage, d_prio, d_active, d_total, d_reserved,
                   d_used, iout, fout, B, 0, U, 0, R, 0));
    }, flush, flush_bytes);
    printf("stats_split B=%d: this kernel without its tasks (T=0) %.4f ms, "
           "without its nodes (N=0) %.4f ms, without both %.4f ms\n", B,
           t_nodes, t_tasks, t_none);
    printf("stats_split B=%d: parent stage 1 (%d blocks of %d a lane) %.4f "
           "ms, stage 2 (one block of %d a lane) %.4f ms, both %.4f ms; "
           "this kernel (one launch, a %d-block cluster a lane) %.4f ms; "
           "outputs agree %s (variances within %.3g)\n",
           B, G, v1::T1, t1, v1::T2, t2, t12, CLUSTER, tn,
           same ? "yes" : "NO", var_rel);
    char buf[320];
    snprintf(buf, sizeof buf,
             "%s{\"lanes\": %d, \"parent_stage1_ms\": %.5f, "
             "\"parent_stage2_ms\": %.5f, \"parent_ms\": %.5f, "
             "\"ms\": %.5f, \"ms_no_tasks\": %.5f, "
             "\"ms_no_nodes\": %.5f, \"ms_neither\": %.5f, "
             "\"agree\": %s}",
             B == 1 ? "" : ", ", B, t1, t2, t12, tn, t_nodes, t_tasks, t_none,
             same ? "true" : "false");
    json += buf;
    if (!same) return 2;
  }
  printf("%s]}\n", json.c_str());
  return 0;
}
