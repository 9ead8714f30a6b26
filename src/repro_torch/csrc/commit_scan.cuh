// commit_scan.cuh: the sequential capacity-checked commit scan, shared by
// placement_commit.cu (kernel B: the preference comes in as a matrix) and
// sched_commit.cu (kernel D: the preference is derived per lane from its
// proposal family). One header, so the two scans cannot drift apart.
//
// One block per lane walks the lane's tasks in row (priority) order; task p
// fits node n when req[p] <= total[n] - tally[n] + 1e-9 for every resource
// and ok[p, n]; its score is pref(p, n) (static lanes) or
// -sum_r (free - req) / denom (dynamic lanes, against the running tally;
// pref is then not read); the first index of the largest fitting score wins
// (all -inf gives node 0, jnp.argmax's rule); the task is placed if that
// node fits and the task is valid; then tally[n] += (placed ? req : 0),
// also when nothing is added.
//
// The lane's running tally (N x R f32, 150,000 B at cell A) lives in
// dynamic shared memory for the whole scan; total and denom are read from
// global memory and stay in L2. Per task each thread scores its strided
// share of nodes, recomputing free = total - tally as the reference does; a
// warp-shuffle then shared-memory argmax keeps the largest score and, among
// ties, the lowest index; one thread re-checks the winner's fit, writes
// node_of and updates the tally row. IEEE division, no FMA contraction
// (the library is built with --fmad=false).

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
namespace commit_scan {

constexpr int THREADS = 1024;
constexpr int MAX_R = 4;

// Operand slots of the lane-broadcast bit mask: an operand whose bit is set
// has a lane axis of size 1, shared by every lane (stride 0, not copied).
constexpr int OP_PREF = 0, OP_REQ = 1, OP_OK = 2, OP_VALID = 3,
              OP_TOTAL = 4, OP_DENOM = 5, OP_RES0 = 6;

__device__ __forceinline__ size_t lane_of(int bcast, int op, size_t b) {
  return ((bcast >> op) & 1) ? 0 : b;
}

__device__ __forceinline__ void take_better(float& best, int& bidx,
                                            float v, int i) {
  if (v > best || (v == best && i < bidx)) {
    best = v;
    bidx = i;
  }
}

// The scan of one lane. Pointers are already offset to the lane; `tally`
// is the block's dynamic shared memory (N*R floats); `pref(p, n)` gives the
// static score and is called only when `dynamic` is false.
template <class Pref>
__device__ __forceinline__ void scan(
    const Pref& pref, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const float* __restrict__ res0, int* __restrict__ node_of,
    float* __restrict__ tally_out, int P, int N, int R, bool dynamic,
    float* tally) {
  __shared__ float warp_val[THREADS / 32];
  __shared__ int warp_idx[THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < N * R; i += THREADS) tally[i] = res0[i];
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    float rq[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) rq[r] = r < R ? req[p * R + r] : 0.0f;
    const unsigned char* ok_p = ok + (size_t)p * N;

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
      float sc = dynamic ? -s : pref(p, n);
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

// Host side: allow `smem` bytes of dynamic shared memory for `kernel`.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace commit_scan
}  // namespace
