// sched_commit: the fused scheduler pass of the switchless scenario fleet:
// each lane's preference row is derived inside the kernel from its proposal
// family, then committed by the same scan as placement_commit.cu.
//
// Replaces the TPU kernel `sched_commit_pallas` in
// src/repro/kernels/placement_commit/kernel.py, with both of its bodies
// `_sched_kernel` (node dim whole) and `_sched_kernel_tiled` (node tiles
// streamed with a running argmax that adopts tile 0 and later tiles only on
// a strict improvement), and `_family_pref`. The tiled body exists for
// VMEM only; its carry gives the winner of one whole-row first-index
// argmax, which is what this kernel computes, so one kernel serves both.
//
// Per lane b, lane_params[b] = (fam, dyn, start, ext_row):
//   fam FAM_SCORES     (1): pref = scores[p, n]         (greedy)
//   fam FAM_NODE_ORDER (2): pref = -((n - start) mod N) (first-fit at
//                           start 0, round-robin at a rotating start)
//   fam FAM_EXTERNAL   (0): pref = ext[ext_row, p, n]   (a proposal that
//                           cannot be fused, evaluated beforehand)
//   dyn 1: the lane re-scores against its running tally (pref not read).
// A lane reads only the operands its family and mode use: node-order and
// dynamic lanes never read scores or ext. scores/req/ok/valid/total/denom
// carry a lane axis B, or 1 when shared (bit set in `bcast`; read with
// lane stride 0, not copied); the tally comes in holding reserved0.
//
// Bound on this card: the bytes every lane must read once, ok (12.8 MB a
// lane at P=1,024, N=12,500) plus scores (51.2 MB) or ext (51.2 MB) for a
// static lane of the score or external family: 0.03-0.15 ms for a B=8
// fleet at 3.35 TB/s. The practical limit, as for placement_commit, is the
// P dependent argmax reductions of each lane, one block reduction plus one
// exchange of the C blocks' pairs each; the lanes' clusters run side by
// side.
// Design: B's cluster scan (commit_scan.cuh), one cluster per lane, any N;
// the family is uniform in a lane, so its branch never diverges; C's %
// truncates toward zero, so the node order is taken as ((n - start) % N +
// N) % N, the reference's floor modulus.

#include "commit_scan.cuh"

namespace {

using namespace commit_scan;

constexpr int FAM_EXTERNAL = 0, FAM_SCORES = 1, FAM_NODE_ORDER = 2;

struct FamilyPref {
  int fam;
  const float* __restrict__ scores;
  const float* __restrict__ ext;
  int start;
  int N;
  __device__ __forceinline__ float operator()(int p, int n) const {
    if (fam == FAM_NODE_ORDER) {
      const int o = ((n - start) % N + N) % N;
      return -(float)o;
    }
    const float* src = fam == FAM_SCORES ? scores : ext;
    return src[(size_t)p * N + n];
  }
};

template <bool REG>
__global__ void __launch_bounds__(THREADS, 1) sched_commit_kernel(
    const float* __restrict__ scores, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const float* __restrict__ ext, const int* __restrict__ lane_params,
    int* __restrict__ node_of, float* __restrict__ tally, int P, int N,
    int R, int bcast, int C) {
  const size_t b = blockIdx.x / C;
  const int fam = lane_params[4 * b + 0];
  const bool dynamic = lane_params[4 * b + 1] != 0;
  const int start = lane_params[4 * b + 2];
  const int ext_row = lane_params[4 * b + 3];
  const FamilyPref pref{
      fam, scores + lane_of(bcast, OP_PREF, b) * P * N,
      fam == FAM_EXTERNAL ? ext + (size_t)ext_row * P * N : nullptr,
      start, N};
  scan<THREADS, REG ? KREG : 0, AHEAD>(
      pref, req + lane_of(bcast, OP_REQ, b) * P * R,
      ok + lane_of(bcast, OP_OK, b) * P * N,
      valid + lane_of(bcast, OP_VALID, b) * P,
      total + lane_of(bcast, OP_TOTAL, b) * N * R,
      denom + lane_of(bcast, OP_DENOM, b) * N * R, node_of + b * P,
      tally + b * N * R, P, N, R, dynamic, C);
}

template <bool REG>
cudaError_t cluster_of(int B, int* C) {
  static int cache[129] = {0};
  return cluster_size(sched_commit_kernel<REG>, B, C, cache);
}

template <bool REG>
int launch(const void* scores, const void* req, const void* ok,
           const void* valid, const void* total, const void* denom,
           const void* ext, const void* lane_params, void* node_of,
           void* tally, int B, int P, int N, int R, int bcast,
           cudaStream_t st) {
  int C;
  cudaError_t err = cluster_of<REG>(B, &C);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_clusters(
      sched_commit_kernel<REG>, B, C, THREADS, st, (const float*)scores,
      (const float*)req, (const unsigned char*)ok,
      (const unsigned char*)valid, (const float*)total, (const float*)denom,
      (const float*)ext, (const int*)lane_params, (int*)node_of,
      (float*)tally, P, N, R, bcast, C);
}

}  // namespace

// lane_params: (B, 4) int32 (fam, dyn, start, ext_row), validated by the
// wrapper; ext: (BE, P, N) f32, or null when no lane is FAM_EXTERNAL;
// tally: (B, N, R) f32 holding each lane's reserved0 on entry.
extern "C" int sched_commit_launch(
    const void* scores, const void* req, const void* ok, const void* valid,
    const void* total, const void* denom, const void* ext,
    const void* lane_params, void* node_of, void* tally, int B, int P,
    int N, int R, int bcast, void* stream) {
  if (R < 1 || N < 1 || P < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  return R <= MAX_R
             ? launch<true>(scores, req, ok, valid, total, denom, ext,
                            lane_params, node_of, tally, B, P, N, R, bcast,
                            st)
             : launch<false>(scores, req, ok, valid, total, denom, ext,
                             lane_params, node_of, tally, B, P, N, R, bcast,
                             st);
}

// The cluster size (blocks a lane) a launch over B lanes with R resources
// uses, or a negative CUDA error.
extern "C" int sched_commit_cluster(int B, int R) {
  int C;
  cudaError_t err = R <= MAX_R ? cluster_of<true>(B, &C)
                               : cluster_of<false>(B, &C);
  return err == cudaSuccess ? C : -(int)err;
}
