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
// The practical limit is the P dependent argmax reductions, one after
// another (the scan is sequential by definition): each is one block
// reduction plus one exchange of the C blocks' pairs, so P x (that
// latency) bounds the call whatever the bytes.
// Design: one cluster of C blocks per lane, the node axis split among
// the blocks, every node's tally with its owner thread, the blocks' argmax
// pairs exchanged through distributed shared memory (commit_scan.cuh);
// any N and R.

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

template <bool REG>
__global__ void __launch_bounds__(THREADS, 1) placement_commit_kernel(
    const float* __restrict__ pref, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const unsigned char* __restrict__ dyn, int* __restrict__ node_of,
    float* __restrict__ tally, int P, int N, int R, int dyn_all, int bcast,
    int C) {
  const size_t b = blockIdx.x / C;
  const bool dynamic = dyn != nullptr ? dyn[b] != 0 : dyn_all != 0;
  scan<THREADS, REG ? KREG : 0, AHEAD>(
      RowPref{pref + lane_of(bcast, OP_PREF, b) * P * N, N},
      req + lane_of(bcast, OP_REQ, b) * P * R,
      ok + lane_of(bcast, OP_OK, b) * P * N,
      valid + lane_of(bcast, OP_VALID, b) * P,
      total + lane_of(bcast, OP_TOTAL, b) * N * R,
      denom + lane_of(bcast, OP_DENOM, b) * N * R, node_of + b * P,
      tally + b * N * R, P, N, R, dynamic, C);
}

// The cluster size of a launch over B lanes (written to *C).
template <bool REG>
cudaError_t cluster_of(int B, int* C) {
  static int cache[129] = {0};
  return cluster_size(placement_commit_kernel<REG>, B, C, cache);
}

template <bool REG>
int launch(const void* pref, const void* req, const void* ok,
           const void* valid, const void* total, const void* denom,
           const void* dyn, void* node_of, void* tally, int B, int P, int N,
           int R, int dyn_all, int bcast, cudaStream_t st) {
  int C;
  cudaError_t err = cluster_of<REG>(B, &C);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(
      placement_commit_kernel<REG>, B, C, THREADS, st, (const float*)pref,
      (const float*)req, (const unsigned char*)ok,
      (const unsigned char*)valid, (const float*)total, (const float*)denom,
      (const unsigned char*)dyn, (int*)node_of, (float*)tally, P, N, R,
      dyn_all, bcast, C);
}

}  // namespace

// dyn: (B,) bool per-lane flags ('both'), or null with dyn_all giving every
// lane's mode (0 static, 1 dynamic). tally: (B, N, R) f32 holding each
// lane's reserved0 on entry, the final tally on exit.
extern "C" int placement_commit_launch(
    const void* pref, const void* req, const void* ok, const void* valid,
    const void* total, const void* denom, const void* dyn, void* node_of,
    void* tally, int B, int P, int N, int R, int dyn_all, int bcast,
    void* stream) {
  if (R < 1 || N < 1 || P < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return R <= MAX_R
             ? launch<true>(pref, req, ok, valid, total, denom, dyn, node_of,
                            tally, B, P, N, R, dyn_all, bcast, st)
             : launch<false>(pref, req, ok, valid, total, denom, dyn,
                             node_of, tally, B, P, N, R, dyn_all, bcast, st);
}

// The cluster size (blocks a lane) a launch over B lanes with R resources
// uses, or a negative CUDA error.
extern "C" int placement_commit_cluster(int B, int R) {
  int C;
  cudaError_t err = R <= MAX_R ? cluster_of<true>(B, &C)
                               : cluster_of<false>(B, &C);
  return err == cudaSuccess ? C : -(int)err;
}
