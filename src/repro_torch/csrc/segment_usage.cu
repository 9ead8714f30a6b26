// segment_usage: per-node sums of per-task rows.
//
// Replaces the TPU kernel `segment_usage_pallas` / `_kernel` in
// src/repro/kernels/segment_usage/kernel.py: out[n, v] = sum of
// values[t, v] over tasks t with mask[t] and task_node[t] == n; masked or
// unplaced (-1) rows are dropped.
//
// Bound on this card: reading task_node, mask and values once, about
// 4.4 MB at T=262,144, V=3 (1.3 us at 3.35 TB/s); the output is 150 KB.
// Design: deterministic, no float atomics, and each node's sum is taken in
// task order from 0, the order of the reference's sequential scatter-add.
// Each thread owns one node and its V accumulators; a block stages tiles of
// (task_node, mask, values) through shared memory in task order and every
// thread adds the rows whose node is its own. That is O(T x N) compares
// in all, far above the byte bound; it serves the accounting resync, which
// runs every ~64 windows. A sort-based design is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;    // nodes per block
constexpr int TILE = 1024;     // tasks staged per step
constexpr int MAX_V = 8;

__global__ void __launch_bounds__(THREADS) segment_usage_kernel(
    const int* __restrict__ task_node, const float* __restrict__ values,
    const unsigned char* __restrict__ mask, float* __restrict__ out,
    int T, int V, int N) {
  __shared__ int node_s[TILE];
  __shared__ float val_s[TILE * MAX_V];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * THREADS + tid;
  float acc[MAX_V];
#pragma unroll
  for (int v = 0; v < MAX_V; ++v) acc[v] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int len = min(TILE, T - t0);
    for (int i = tid; i < len; i += THREADS) {
      node_s[i] = mask[t0 + i] ? task_node[t0 + i] : -1;
    }
    for (int i = tid; i < len * V; i += THREADS) {
      val_s[i] = values[(size_t)t0 * V + i];
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      if (node_s[j] == n) {
#pragma unroll
        for (int v = 0; v < MAX_V; ++v) {
          if (v < V) acc[v] = acc[v] + val_s[j * V + v];
        }
      }
    }
    __syncthreads();
  }
  if (n < N) {
    for (int v = 0; v < V; ++v) out[(size_t)n * V + v] = acc[v];
  }
}

}  // namespace

extern "C" int segment_usage_launch(
    const void* task_node, const void* values, const void* mask, void* out,
    int T, int V, int N, void* stream) {
  if (V < 1 || V > MAX_V || N < 1) return (int)cudaErrorInvalidValue;
  segment_usage_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int*)task_node, (const float*)values,
      (const unsigned char*)mask, (float*)out, T, V, N);
  return (int)cudaGetLastError();
}
