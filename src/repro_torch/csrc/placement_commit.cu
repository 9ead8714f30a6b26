// placement_commit: the sequential capacity-checked commit scan.
//
// Replaces the TPU kernel `placement_commit_pallas` / `_kernel` in
// src/repro/kernels/placement_commit/kernel.py (modes 'static' and
// 'dynamic'; the per-lane traced flag, mode 'both', belongs to the scenario
// fleet and is not built here). For each lane, tasks are walked in row
// (priority) order; task p fits node n when req[p] <= total[n] - tally[n]
// + 1e-9 for every resource and ok[p, n]; its score is pref[p, n]
// ('static') or -sum_r (free - req) / denom ('dynamic', against the
// running tally); the first index of the largest fitting score wins (all
// -inf gives node 0); the task is placed if that node fits and the task is
// valid; then tally[n] += (placed ? req : 0), also when nothing is added.
//
// Bound on this card: reading ok (and pref in 'static') once, 12.8 MB
// (64 MB) at P=1,024, N=12,500: about 4 us (19 us) at 3.35 TB/s. The
// practical limit is the P dependent block-wide argmax reductions, one
// after another: the scan is sequential by definition.
// Design: one block per lane, 1,024 threads. The lane's running tally
// (N x R f32, 150,000 B at cell A) lives in dynamic shared memory for the
// whole scan; total and denom are read from global memory and stay in L2.
// Per task each thread scores its strided share of nodes, recomputing
// free = total - tally as the reference does; a warp-shuffle then
// shared-memory argmax keeps the largest score and, among ties, the lowest
// index (jnp.argmax's rule); one thread re-checks the winner's fit, writes
// node_of and updates the tally row. IEEE division, no FMA contraction.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_R = 4;

__device__ __forceinline__ void take_better(float& best, int& bidx,
                                            float v, int i) {
  if (v > best || (v == best && i < bidx)) {
    best = v;
    bidx = i;
  }
}

__global__ void __launch_bounds__(THREADS) placement_commit_kernel(
    const float* __restrict__ pref, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const float* __restrict__ res0, int* __restrict__ node_of,
    float* __restrict__ tally_out, int P, int N, int R, int dynamic) {
  extern __shared__ float tally[];                 // [N*R]
  __shared__ float warp_val[THREADS / 32];
  __shared__ int warp_idx[THREADS / 32];

  const size_t b = blockIdx.x;
  pref += b * P * N;
  req += b * P * R;
  ok += b * P * N;
  valid += b * P;
  total += b * N * R;
  denom += b * N * R;
  res0 += b * N * R;
  node_of += b * P;
  tally_out += b * N * R;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < N * R; i += THREADS) tally[i] = res0[i];
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    float rq[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) rq[r] = r < R ? req[p * R + r] : 0.0f;
    const unsigned char* ok_p = ok + (size_t)p * N;
    const float* pref_p = pref + (size_t)p * N;

    float best = -CUDART_INF_F;
    int bidx = INT_MAX;
    for (int n = tid; n < N; n += THREADS) {
      bool fit = ok_p[n] != 0;
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_R; ++r) {
        if (r < R) {
          const float fr = total[n * R + r] - tally[n * R + r];
          fit = fit && (rq[r] <= fr + 1e-9f);
          if (dynamic) s = s + (fr - rq[r]) / denom[n * R + r];
        }
      }
      float sc = dynamic ? -s : pref_p[n];
      sc = fit ? sc : -CUDART_INF_F;
      take_better(best, bidx, sc, n);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, best, off);
      const int i = __shfl_down_sync(0xffffffffu, bidx, off);
      take_better(best, bidx, v, i);
    }
    if (lane == 0) {
      warp_val[warp] = best;
      warp_idx[warp] = bidx;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_val[lane];                  // THREADS / 32 == 32 warps
      bidx = warp_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, best, off);
        const int i = __shfl_down_sync(0xffffffffu, bidx, off);
        take_better(best, bidx, v, i);
      }
      if (lane == 0) {
        const int n = bidx;
        bool fit = ok_p[n] != 0;
        for (int r = 0; r < R; ++r) {
          fit = fit && (rq[r] <= (total[n * R + r] - tally[n * R + r]) + 1e-9f);
        }
        const bool can = fit && valid[p] != 0;
        for (int r = 0; r < R; ++r) {
          tally[n * R + r] = tally[n * R + r] + (can ? rq[r] : 0.0f);
        }
        node_of[p] = can ? n : -1;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N * R; i += THREADS) tally_out[i] = tally[i];
}

}  // namespace

extern "C" int placement_commit_launch(
    const void* pref, const void* req, const void* ok, const void* valid,
    const void* total, const void* denom, const void* res0, void* node_of,
    void* tally, int B, int P, int N, int R, int dynamic, void* stream) {
  if (R < 1 || R > MAX_R || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * R;
  cudaError_t err = cudaFuncSetAttribute(
      placement_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  placement_commit_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pref, (const float*)req, (const unsigned char*)ok,
      (const unsigned char*)valid, (const float*)total, (const float*)denom,
      (const float*)res0, (int*)node_of, (float*)tally, P, N, R, dynamic);
  return (int)cudaGetLastError();
}
