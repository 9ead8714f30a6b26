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
// dynamic lanes never read scores or ext. scores/req/ok/valid/total/denom/
// res0 carry a lane axis B, or 1 when shared (bit set in `bcast`; read with
// lane stride 0, not copied).
//
// Bound on this card: the bytes every lane must read once, ok (12.8 MB a
// lane at P=1,024, N=12,500) plus scores (51.2 MB) or ext (51.2 MB) for a
// static lane of the score or external family: 0.03-0.15 ms for a B=8
// fleet at 3.35 TB/s. The practical limit, as for placement_commit, is the
// P dependent block-wide argmax reductions of each lane.
// Design: one block per lane, the lane's tally in shared memory
// (commit_scan.cuh); the family is uniform in a block, so its branch never
// diverges; C's % truncates toward zero, so the node order is taken as
// ((n - start) % N + N) % N, the reference's floor modulus.

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

__global__ void __launch_bounds__(THREADS) sched_commit_kernel(
    const float* __restrict__ scores, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    const float* __restrict__ res0, const float* __restrict__ ext,
    const int* __restrict__ lane_params, int* __restrict__ node_of,
    float* __restrict__ tally_out, int P, int N, int R, int bcast) {
  extern __shared__ float tally[];                 // [N*R]
  const size_t b = blockIdx.x;
  const int fam = lane_params[4 * b + 0];
  const bool dynamic = lane_params[4 * b + 1] != 0;
  const int start = lane_params[4 * b + 2];
  const int ext_row = lane_params[4 * b + 3];
  const FamilyPref pref{
      fam, scores + lane_of(bcast, OP_PREF, b) * P * N,
      fam == FAM_EXTERNAL ? ext + (size_t)ext_row * P * N : nullptr,
      start, N};
  scan(pref, req + lane_of(bcast, OP_REQ, b) * P * R,
       ok + lane_of(bcast, OP_OK, b) * P * N,
       valid + lane_of(bcast, OP_VALID, b) * P,
       total + lane_of(bcast, OP_TOTAL, b) * N * R,
       denom + lane_of(bcast, OP_DENOM, b) * N * R,
       res0 + lane_of(bcast, OP_RES0, b) * N * R, node_of + b * P,
       tally_out + b * N * R, P, N, R, dynamic, tally);
}

}  // namespace

// lane_params: (B, 4) int32 (fam, dyn, start, ext_row), validated by the
// wrapper; ext: (BE, P, N) f32, or null when no lane is FAM_EXTERNAL.
extern "C" int sched_commit_launch(
    const void* scores, const void* req, const void* ok, const void* valid,
    const void* total, const void* denom, const void* res0, const void* ext,
    const void* lane_params, void* node_of, void* tally, int B, int P,
    int N, int R, int bcast, void* stream) {
  if (R < 1 || R > MAX_R || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * R;
  cudaError_t err = allow_smem(sched_commit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  sched_commit_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)req, (const unsigned char*)ok,
      (const unsigned char*)valid, (const float*)total, (const float*)denom,
      (const float*)res0, (const float*)ext, (const int*)lane_params,
      (int*)node_of, (float*)tally, P, N, R, bcast);
  return (int)cudaGetLastError();
}
