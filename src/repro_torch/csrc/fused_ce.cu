// fused_ce: per-token cross-entropy of the logits x W^T, with the online
// (max, sum of exponentials, picked logit) statistics streamed over vocab
// tiles, so the (T, Vp) logits never reach device memory.
//
// Replaces the TPU kernel `fused_ce_pallas` / `_kernel` in
// src/repro/kernels/fused_ce/kernel.py: x (T, d) and W (Vp, d), both f32 or
// both bf16, int32 labels (T,); logits accumulated and kept in f32;
// columns at or past `vocab_size` are -1e30; nll = log(max(s, 1e-30)) + m -
// picked, and exactly 0 where the label is below 0. Besides the per-token
// nll it writes lse = log(max(s, 1e-30)) + m, which the backward
// (kernels/fused_ce/ops.py FusedCEMean) reuses. Any T is allowed: rows past
// T are masked (the reference pads T to its tile).
//
// Bound on this card: at qwen3-4b's training shape (T=2,048, d=2,560,
// Vp=152,064, bf16) the products are 1.595 TFLOP (1.61 ms at 989 TFLOP/s
// on bf16 tensor cores) against 0.79 GB of x and W read once (0.24 ms at
// 3.35 TB/s), so the operations bound it. This first kernel computes in
// f32 with scalar multiply-adds (__fmaf_rn, explicit since the library is
// built with --fmad=false) and sits far above that bound; mma.sync or wgmma
// on bf16 tiles is later work.
//
// Design: a block of 256 threads owns 64 token rows and one contiguous
// range of vocab tiles (a split); the grid is (row tiles, splits), with
// enough splits to fill the card even when T is small. For each 64-column
// tile it stages 32-wide slices of x and W in shared memory as f32
// (k-major, so a thread reads its 4 rows and 4 columns as two float4) and
// accumulates the 64x64 logits in registers (4x4 a thread). The epilogue
// of each tile masks the columns, picks the label by comparing the column
// index with it (no gather), and folds the tile into each thread's own
// running (m, s, picked) for its 4 rows; the 16 lanes that share rows merge
// theirs with shuffles once, at the end. A second small kernel merges the
// splits of each row and writes nll and lse. Both launch from one entry
// point, on the caller's stream, into buffers the wrapper allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 64;           // token rows per block
constexpr int BV = 64;           // vocab columns per tile
constexpr int BKD = 32;          // model-dim slice staged per step
constexpr int THREADS = 256;     // 16 x 16: tx picks columns, ty rows
constexpr int LD = BT + 4;       // padded k-major stride (float4 aligned)
constexpr float NEG = -1e30f;    // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Partial statistics of rows [row0, row0 + 64) over the vocab tiles
// [split * tiles_per_split, ...): pm/ps/pp hold (m, s, picked) at
// [split * n_tok + row].
template <typename T>
__global__ void __launch_bounds__(THREADS) fused_ce_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ pm,
    float* __restrict__ ps, float* __restrict__ pp, int n_tok, int D,
    int Vp, int V, int tiles_per_split) {
  __shared__ __align__(16) float Xs[BKD][LD];
  __shared__ __align__(16) float Ws[BKD][LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * BT;
  const int n_tiles = (Vp + BV - 1) / BV;
  const int tile_lo = blockIdx.y * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);

  int lab[4];
  float m[4], s[4], p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    lab[i] = r < n_tok ? labels[r] : -1;
    m[i] = NEG;
    s[i] = 0.0f;
    p[i] = 0.0f;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int col0 = tile * BV;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BKD) {
      __syncthreads();             // the previous slice has been read
      for (int e = tid; e < BT * BKD; e += THREADS) {
        const int r = e / BKD, kk = e % BKD;
        const int gk = k0 + kk;
        const int gr = row0 + r, gc = col0 + r;
        Xs[kk][r] = (gr < n_tok && gk < D)
                        ? to_f32(x[(long long)gr * D + gk]) : 0.0f;
        Ws[kk][r] = (gc < Vp && gk < D)
                        ? to_f32(w[(long long)gc * D + gk]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BKD; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }

    // epilogue: mask, pick, fold into the running statistics
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx * 4 + j;
        float l = acc[i][j];
        if (c >= Vp) l = -INFINITY;          // past the array: no column
        else if (c >= V) l = NEG;            // vocab padding, as the reference
        if (c == lab[i]) p[i] += l;
        acc[i][j] = l;
        tmax = fmaxf(tmax, l);
      }
      float si = s[i] * expf(m[i] - tmax);
#pragma unroll
      for (int j = 0; j < 4; ++j) si += expf(acc[i][j] - tmax);
      s[i] = si;
      m[i] = tmax;
    }
  }

  // the 16 lanes of a half-warp hold the same 4 rows: merge their states
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mm = m[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, off));
    float ss = s[i] * expf(m[i] - mm), pk = p[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      ss += __shfl_xor_sync(FULL, ss, off);
      pk += __shfl_xor_sync(FULL, pk, off);
    }
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < n_tok) {
      const long long o = (long long)blockIdx.y * n_tok + r;
      pm[o] = mm;
      ps[o] = ss;
      pp[o] = pk;
    }
  }
}

// Merge the splits of each row: nll and lse, both f32.
__global__ void fused_ce_combine_kernel(const float* __restrict__ pm,
                                        const float* __restrict__ ps,
                                        const float* __restrict__ pp,
                                        const int* __restrict__ labels,
                                        float* __restrict__ nll,
                                        float* __restrict__ lse, int n_tok,
                                        int n_split) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_tok) return;
  float M = NEG;
  for (int k = 0; k < n_split; ++k) M = fmaxf(M, pm[(long long)k * n_tok + r]);
  float S = 0.0f, P = 0.0f;
  for (int k = 0; k < n_split; ++k) {
    const long long o = (long long)k * n_tok + r;
    S += ps[o] * expf(pm[o] - M);
    P += pp[o];
  }
  const float l = logf(fmaxf(S, 1e-30f)) + M;
  lse[r] = l;
  nll[r] = labels[r] >= 0 ? l - P : 0.0f;
}

template <typename T>
int launch_typed(const void* x, const void* w, const int* labels,
                 float* nll, float* lse, float* scratch, int n_tok, int D,
                 int Vp, int V, int n_split, int tiles_per_split,
                 cudaStream_t st) {
  float* pm = scratch;
  float* ps = scratch + (long long)n_split * n_tok;
  float* pp = scratch + 2 * (long long)n_split * n_tok;
  const dim3 grid((n_tok + BT - 1) / BT, n_split);
  fused_ce_partial_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, pm, ps, pp,
      n_tok, D, Vp, V, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_combine_kernel<<<(n_tok + 255) / 256, 256, 0, st>>>(
      pm, ps, pp, labels, nll, lse, n_tok, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_tok, D), w (Vp, D) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// labels (n_tok,) int32; nll, lse (n_tok,) f32; scratch 3 * n_split * n_tok
// f32. The splits must cover the vocab tiles exactly: n_split *
// tiles_per_split >= ceil(Vp / 64) > (n_split - 1) * tiles_per_split.
extern "C" int fused_ce_launch(const void* x, const void* w,
                               const void* labels, void* nll, void* lse,
                               void* scratch, int n_tok, int D, int Vp, int V,
                               int n_split, int tiles_per_split, int dtype,
                               void* stream) {
  const int n_tiles = (Vp + BV - 1) / BV;
  if (n_tok < 1 || D < 1 || Vp < 1 || V < 0 || n_split < 1 ||
      n_split > 65535 || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split < n_tiles ||
      (long long)(n_split - 1) * tiles_per_split >= n_tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* lab = static_cast<const int*>(labels);
  float* o_nll = static_cast<float*>(nll);
  float* o_lse = static_cast<float*>(lse);
  float* scr = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return launch_typed<float>(x, w, lab, o_nll, o_lse, scr, n_tok, D, Vp,
                                 V, n_split, tiles_per_split, st);
    case 1:
      return launch_typed<__nv_bfloat16>(x, w, lab, o_nll, o_lse, scr, n_tok,
                                         D, Vp, V, n_split, tiles_per_split,
                                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
