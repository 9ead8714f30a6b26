// placement_commit: the sequential capacity-checked commit scan over a
// given preference matrix.
//
// Replaces the TPU kernel `placement_commit_pallas` / `_kernel` in
// src/repro/kernels/placement_commit/kernel.py, in its three modes: every
// lane static (score = pref), every lane dynamic (re-score against the
// running tally; pref is not read), or 'both', a per-lane flag `dyn` (the
// scenario fleet's switch dispatch, where lanes run different schedulers).
// The scan itself is commit_scan.cuh, shared with sched_commit.cu.
//
// Every operand carries a leading lane axis B, or 1 when the lanes share
// it (bit set in `bcast`, see commit_scan.cuh): a shared operand is read
// with lane stride 0, never copied B times.
//
// Bound on this card: reading ok (and pref in 'static') once, 12.8 MB
// (64 MB) a lane at P=1,024, N=12,500: about 4 us (19 us) at 3.35 TB/s.
// The practical limit is the P dependent block-wide argmax reductions, one
// after another: the scan is sequential by definition.
// Design: one block per lane, 1,024 threads, the lane's tally in shared
// memory (commit_scan.cuh).

#include "commit_scan.cuh"

namespace {

using namespace commit_scan;

struct RowPref {
  const float* __restrict__ pref;
  int N;
  __device__ __forceinline__ float operator()(int p, int n) const {
    return pref[(size_t)p * N + n];
  }
};

__global__ void __launch_bounds__(THREADS) placement_commit_kernel(
    const float* __restrict__ pref, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const float* __restrict__ res0, const unsigned char* __restrict__ dyn,
    int* __restrict__ node_of, float* __restrict__ tally_out, int P, int N,
    int R, int dyn_all, int bcast) {
  extern __shared__ float tally[];                 // [N*R]
  const size_t b = blockIdx.x;
  const bool dynamic = dyn != nullptr ? dyn[b] != 0 : dyn_all != 0;
  scan(RowPref{pref + lane_of(bcast, OP_PREF, b) * P * N, N},
       req + lane_of(bcast, OP_REQ, b) * P * R,
       ok + lane_of(bcast, OP_OK, b) * P * N,
       valid + lane_of(bcast, OP_VALID, b) * P,
       total + lane_of(bcast, OP_TOTAL, b) * N * R,
       denom + lane_of(bcast, OP_DENOM, b) * N * R,
       res0 + lane_of(bcast, OP_RES0, b) * N * R, node_of + b * P,
       tally_out + b * N * R, P, N, R, dynamic, tally);
}

}  // namespace

// dyn: (B,) bool per-lane flags ('both'), or null with dyn_all giving every
// lane's mode (0 static, 1 dynamic).
extern "C" int placement_commit_launch(
    const void* pref, const void* req, const void* ok, const void* valid,
    const void* total, const void* denom, const void* res0, const void* dyn,
    void* node_of, void* tally, int B, int P, int N, int R, int dyn_all,
    int bcast, void* stream) {
  if (R < 1 || R > MAX_R || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * R;
  cudaError_t err = allow_smem(placement_commit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  placement_commit_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)pref, (const float*)req, (const unsigned char*)ok,
      (const unsigned char*)valid, (const float*)total, (const float*)denom,
      (const float*)res0, (const unsigned char*)dyn, (int*)node_of,
      (float*)tally, P, N, R, dyn_all, bcast);
  return (int)cudaGetLastError();
}
