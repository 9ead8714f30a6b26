// commit_scan.cuh: the sequential capacity-checked commit scan, shared by
// placement_commit.cu (kernel B: the preference comes in as a matrix) and
// sched_commit.cu (kernel D: the preference is derived per lane from its
// proposal family). One header, so the two scans cannot drift apart.
//
// Semantics (the reference's `_kernel`, placement_commit/kernel.py): the
// lane's tasks in row (priority) order; task p fits node n when ok[p, n]
// and req[p, r] <= total[n, r] - tally[n, r] + 1e-9 for every resource r;
// its score is pref(p, n) (static lanes) or -sum_r (free - req) / denom
// summed from 0 in r order (dynamic lanes, against the running tally; pref
// is then not read); the first index of the largest fitting score wins
// (all -inf gives node 0, jnp.argmax's rule); the task is placed if that
// node fits and the task is valid; then tally[n] += (placed ? req : 0).
//
// Design: one thread-block cluster per lane. The cluster's C blocks
// (C = 16 where the card allows non-portable clusters and enough of them
// fit, else 8; picked by cudaOccupancyMaxActiveClusters, see pick_cluster)
// split the node axis into C contiguous slices of ceil(N / C) nodes, and
// every node has one owner thread for the whole scan: local index i of a
// block's slice belongs to thread i % 512. Only the owner ever reads or
// writes that node's tally, so no other thread needs it and the tally has
// no shared-memory home: N is not bounded by shared memory.
//   * The owner keeps its first KREG = 4 nodes' total, denom and running
//     tally in registers (36 registers at R <= MAX_R = 3; a 512-thread
//     block has 128 registers a thread). A block so holds 2,048 nodes in
//     registers: cell A's 12,500 nodes fit with C = 8 or 16, and the scan
//     then reads no total, denom or tally from memory; only the ok row
//     (and, static, the pref row) stream in.
//   * Further owned nodes (N > 2,048 C, or R > MAX_R: then every node)
//     keep their tally in the `tally` output itself, which the wrapper
//     initialises from reserved0 and only the owner updates in place;
//     their total and denom are read from device memory (L2) every task.
// Per task: each block reduces its slice to (best, lowest index) with warp
// shuffles, one __syncthreads and a second warp's shuffles; that warp's
// lane l then stores the pair into slot[rank] of block l's
// double-buffered slot array in distributed shared memory (st.async), and
// block l's mbarrier counts the bytes; every block waits on its own
// mbarrier for the C pairs, and every warp reduces them from local shared
// memory, one slot a lane, so every thread knows the winner; the winner's
// owner takes the fit it computed for this task, updates its tally and
// writes node_of[p]. No cluster barrier runs inside the loop: a releasing
// barrier waits for each thread's outstanding memory accesses, and the
// st.async bytes carry their own completion. A slot buffer is rewritten
// two tasks later, and a block can only get there after every block has
// sent the pairs of the task in between, which each sends after reading
// the buffer's previous pairs. The register nodes' task operands (request
// row, valid flag, ok bytes, static preferences) are loaded AHEAD = 2
// tasks early and kept as loaded (a compare right after a load would wait
// for it), so the loads' latency leaves the dependent chain.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tma.cuh"      // mbarriers

namespace {
namespace commit_scan {

constexpr int THREADS = 512;
constexpr int KREG = 4;             // register nodes a thread
constexpr int AHEAD = 2;            // tasks whose operands are loaded early
// Resources a register-held node carries: 3 in every shipped config
// (SimConfig.n_resources); a larger R is a config field away, and keeps
// every node in memory instead, so R has no ceiling.
constexpr int MAX_R = 3;
constexpr int CLUSTER_MAX = 16;     // non-portable cluster size on sm_90
constexpr int CLUSTER_PORTABLE = 8;
constexpr unsigned FULL = 0xffffffffu;

// Operand slots of the lane-broadcast bit mask: an operand whose bit is set
// has a lane axis of size 1, shared by every lane (stride 0, not copied).
constexpr int OP_PREF = 0, OP_REQ = 1, OP_OK = 2, OP_VALID = 3,
              OP_TOTAL = 4, OP_DENOM = 5;

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

// (best, lowest index) over the warp; every lane gets the result.
__device__ __forceinline__ void warp_best(float& best, int& bidx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(FULL, best, off);
    const int i = __shfl_xor_sync(FULL, bidx, off);
    take_better(best, bidx, v, i);
  }
}

__device__ __forceinline__ unsigned long long pack(float v, int i) {
  return static_cast<unsigned long long>(__float_as_uint(v)) |
         (static_cast<unsigned long long>(static_cast<unsigned>(i)) << 32);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster arrives (release) and waits (acquire); the
// non-.aligned forms, since threads may reach it from divergent code.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `p` (a shared-memory variable) in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// Store 8 bytes into another block's shared memory; its mbarrier `bar`
// (a shared::cluster address) counts them when they have landed.
__device__ __forceinline__ void st_async(uint32_t addr, unsigned long long v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(v), "r"(bar)
      : "memory");
}

// Fit and score of task p on a node whose operands live in memory (its
// tally in `tally`, owner-only).
template <class Pref>
__device__ __forceinline__ float score_mem(
    const Pref& pref, const float* __restrict__ req_p,
    const unsigned char* __restrict__ ok_p, const float* __restrict__ total,
    const float* __restrict__ denom, const float* tally, int p, int n,
    int R, bool dynamic, bool* fit_out) {
  bool fit = ok_p[n] != 0;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) {
    const size_t o = (size_t)n * R + r;
    const float fr = total[o] - tally[o];
    const float rq = req_p[r];
    fit = fit && (rq <= fr + 1e-9f);
    if (dynamic) s = s + (fr - rq) / denom[o];
  }
  *fit_out = fit;
  const float sc = dynamic ? -s : pref(p, n);
  return fit ? sc : -CUDART_INF_F;
}

// Task p's operands a thread needs for its register nodes, loaded ahead
// and kept as loaded: nothing reads them before their task, so no load
// is waited for early (a compare right after a load would wait for it).
template <int K>
struct TaskOps {
  float rq[MAX_R];
  float pf[K];
  unsigned char ok[K];
  unsigned char valid;
};

// The scan of one lane by one block of NT threads of its cluster.
// Pointers are offset to the lane; `tally` (N x R) holds reserved0 on
// entry and the final tally on exit; `pref(p, n)` gives the static score
// and is called only when `dynamic` is false. A thread's first NREG nodes
// live in registers (NREG = 0 when R > MAX_R); their task operands are
// loaded DP tasks ahead. The kernels run scan<THREADS, KREG, AHEAD>.
template <int NT, int NREG, int DP, class Pref>
__device__ __forceinline__ void scan(
    const Pref& pref, const float* __restrict__ req,
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ total, const float* __restrict__ denom,
    int* __restrict__ node_of, float* tally, int P, int N, int R,
    bool dynamic, int C) {
  constexpr int W = NT / 32;
  constexpr int K = NREG > 0 ? NREG : 1;     // register arrays' extent
  __shared__ float warp_val[2][W];
  __shared__ int warp_idx[2][W];
  __shared__ unsigned long long slot[2][CLUSTER_MAX];
  __shared__ __align__(8) unsigned long long bar[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = cluster_rank();
  const int per_block = (N + C - 1) / C;
  const int lo = (int)rank * per_block;
  const int hi = min(N, lo + per_block);
  if (tid == 0) {
    tma::mbar_init(tma::smem_u32(&bar[0]), 1);
    tma::mbar_init(tma::smem_u32(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();        // every block's mbarriers exist before any store

  // the register nodes lo + tid + k NT (k < KREG) and their operands
  float tot[K][MAX_R], den[K][MAX_R], tal[K][MAX_R];
  bool own[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = lo + tid + k * NT;
    own[k] = NREG > 0 && n < hi;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      const bool in = own[k] && r < R;
      const size_t o = (size_t)n * R + r;
      tot[k][r] = in ? total[o] : 0.0f;
      den[k][r] = in ? denom[o] : 1.0f;
      tal[k][r] = in ? tally[o] : 0.0f;
    }
  }
  const int mem_first = lo + tid + NREG * NT;

  // a node a thread does not own reads node N - 1's operands instead
  // (always in range) and ignores them
  auto load = [&](int p, TaskOps<K>& t) {
    if (p >= P) return;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (NREG > 0 && r < R) t.rq[r] = req[(size_t)p * R + r];
    t.valid = valid[p];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int n = own[k] ? lo + tid + k * NT : N - 1;
      t.ok[k] = ok[(size_t)p * N + n];
      if (!dynamic) t.pf[k] = pref(p, n);
    }
  };
  TaskOps<K> ring[DP] = {};
#pragma unroll
  for (int j = 0; j < DP; ++j) load(j, ring[j]);

  for (int p0 = 0; p0 < P; p0 += DP) {
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int p = p0 + j;
      if (p >= P) break;
      const int buf = p & 1;
      const TaskOps<K> cur = ring[j];
      load(p + DP, ring[j]);
      if (tid == 0)
        tma::mbar_expect_tx(tma::smem_u32(&bar[buf]), 8u * C);

      float best = -CUDART_INF_F;
      int bidx = INT_MAX;
      bool fit[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        fit[k] = false;
        if (own[k]) {
          bool f = cur.ok[k] != 0;
          float s = 0.0f;
#pragma unroll
          for (int r = 0; r < MAX_R; ++r) {
            if (r < R) {
              const float fr = tot[k][r] - tal[k][r];
              f = f && (cur.rq[r] <= fr + 1e-9f);
              if (dynamic) s = s + (fr - cur.rq[r]) / den[k][r];
            }
          }
          const float sc = dynamic ? -s : cur.pf[k];
          take_better(best, bidx, f ? sc : -CUDART_INF_F,
                      lo + tid + k * NT);
          fit[k] = f;
        }
      }
      const float* req_p = req + (size_t)p * R;
      const unsigned char* ok_p = ok + (size_t)p * N;
      for (int n = mem_first; n < hi; n += NT) {
        bool f;
        const float sc = score_mem(pref, req_p, ok_p, total, denom, tally,
                                   p, n, R, dynamic, &f);
        take_better(best, bidx, sc, n);
      }

      // the block's (best, lowest index) to every block of the cluster
      warp_best(best, bidx);
      if (lane == 0) {
        warp_val[buf][warp] = best;
        warp_idx[buf][warp] = bidx;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < W ? warp_val[buf][lane] : -CUDART_INF_F;
        bidx = lane < W ? warp_idx[buf][lane] : INT_MAX;
        warp_best(best, bidx);
        if (lane < C)
          st_async(cluster_addr(&slot[buf][rank], lane), pack(best, bidx),
                   cluster_addr(&bar[buf], lane));
      }
      tma::mbar_wait(tma::smem_u32(&bar[buf]), (p >> 1) & 1);
      const unsigned long long v =
          lane < C ? slot[buf][lane] : pack(-CUDART_INF_F, INT_MAX);

      // every warp: the cluster's winner from the C pairs
      best = __uint_as_float(static_cast<unsigned>(v));
      bidx = static_cast<int>(v >> 32);
      warp_best(best, bidx);
      const int n = bidx;
      if (n >= lo && n < hi && (n - lo) % NT == tid) {
        const int kn = (n - lo) / NT;
        if (kn < NREG) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k == kn) {
              const bool can = fit[k] && cur.valid != 0;
#pragma unroll
              for (int r = 0; r < MAX_R; ++r)
                if (r < R) tal[k][r] = tal[k][r] + (can ? cur.rq[r] : 0.0f);
              node_of[p] = can ? n : -1;
            }
          }
        } else {
          bool f;
          score_mem(pref, req_p, ok_p, total, denom, tally, p, n, R,
                    dynamic, &f);
          const bool can = f && cur.valid != 0;
          for (int r = 0; r < R; ++r) {
            const size_t o = (size_t)n * R + r;
            tally[o] = tally[o] + (can ? req_p[r] : 0.0f);
          }
          node_of[p] = can ? n : -1;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (own[k]) {
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < R) tally[(size_t)(lo + tid + k * NT) * R + r] = tal[k][r];
    }
  }
  cluster_sync();        // no block leaves while stores into it may land
}

// ---- host side ------------------------------------------------------------

inline cudaLaunchConfig_t cluster_config(int lanes, int C,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t st,
                                         int threads = THREADS) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * C));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size for B lanes: 16 or 8 blocks, whichever runs the lanes
// in fewer waves of resident clusters (ties: 16, more SMs a lane); 8 where
// non-portable sizes are refused. Written to *C; returns a CUDA error.
template <class Kernel>
cudaError_t pick_cluster(Kernel kernel, int B, int* C,
                         int threads = THREADS) {
  *C = CLUSTER_PORTABLE;
  int best_waves = INT_MAX;
  const bool big = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
      cudaSuccess;
  cudaGetLastError();                 // a refusal is an answer, not a fault
  const int sizes[2] = {CLUSTER_MAX, CLUSTER_PORTABLE};
  for (int c : sizes) {
    if (c > CLUSTER_PORTABLE && !big) continue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(1, c, attr, 0, threads);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess
        || active < 1) {
      cudaGetLastError();
      continue;
    }
    const int waves = (B + active - 1) / active;
    if (waves < best_waves) {
      best_waves = waves;
      *C = c;
    }
  }
  if (best_waves == INT_MAX) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// pick_cluster's answer, remembered per lane count in the caller's
// `cache` (one per kernel: the occupancy query is a host call of some
// microseconds, and the answer never changes).
template <class Kernel>
cudaError_t cluster_size(Kernel kernel, int B, int* C, int (&cache)[129]) {
  if (B >= 0 && B <= 128 && cache[B] != 0) {
    *C = cache[B];
    return cudaSuccess;
  }
  cudaError_t err = pick_cluster(kernel, B < 1 ? 1 : B, C);
  if (err == cudaSuccess && B >= 0 && B <= 128) cache[B] = *C;
  return err;
}

template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, int B, int C, int threads,
                            cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, C, attr, st, threads);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace commit_scan
}  // namespace
