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
// 3.35 TB/s), so the operations bound it.
//
// Two bodies write the same per-split partial statistics; a second small
// kernel (fused_ce_combine_kernel) merges the splits of each row and
// writes nll and lse. The wrapper picks the body from dtype and shape.
//
// Tensor-core body (fused_ce_tc_kernel; bf16 with d % 8 == 0, every model
// shape): a block owns 128 token rows and a split of the 256-column vocab
// tiles. One producer thread brings 64-wide slices of the block's x rows
// and of the tile's W rows into a ring of 4 stages (48 KB each, 128-byte
// swizzled) with TMA (cp.async.bulk.tensor, zero-filled past T, Vp and d),
// mbarriers saying when a stage is full and when it is free again. Two
// consumer warpgroups, 64 rows each, run wgmma m64n256k16 (bf16 operands
// K-major from shared memory, f32 accumulators in 128 registers a thread)
// over the slices; setmaxnreg gives them 232 registers and the producer
// 40. The epilogue of each tile runs in registers: mask the columns (past
// Vp absent, in [V, Vp) -1e30), pick the label by comparing its column (a
// tile that holds it only), and fold the tile into each thread's own
// running (m, s, picked) for its two rows with expf (no log2 prescale);
// the four lanes of a quad, which share rows, merge their states once at
// the end with two __shfl_xor_sync. W is read from device memory about
// once: the grid's x index is the row tile, so the 16 row tiles of one
// split start together and walk the same W tiles in step, and L2 serves
// the other 15 reads (at most ~9 splits are resident, ~12 MB of W tiles
// plus x's 10.5 MB, inside the 50 MB L2). A persistent block per vocab
// range with all rows' statistics in shared memory would read W once by
// construction but re-stream x per row tile and idle most SMs at small T;
// TMA multicast across a cluster is later work.
//
// SIMT body (fused_ce_partial_kernel; f32, where TF32 would miss the 1e-4
// bar, and bf16 with d % 8 != 0, which TMA's 16-byte strides refuse): a
// block of 256 threads owns 64 token rows and a split of the 64-column
// vocab tiles; it stages 32-wide slices of x and W in shared memory as f32
// (k-major, so a thread reads its 4 rows and 4 columns as two float4) and
// accumulates the 64x64 logits with scalar multiply-adds (__fmaf_rn,
// explicit since the library is built with --fmad=false), 4x4 a thread,
// folding each tile into per-thread running statistics that the 16 lanes
// sharing rows merge with shuffles at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

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


// ---- tensor-core body ---------------------------------------------------

namespace tc {

using namespace tma;

constexpr int BM = 128;                  // token rows a block (2 x 64)
constexpr int BN = 256;                  // vocab columns a tile
constexpr int BK = 64;                   // d a stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;     // x slice, 16 KB
constexpr int B_BYTES = BN * BK * 2;     // W slice, 32 KB
constexpr int THREADS = 384;             // 2 consumer warpgroups, 1 producer
constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1) fused_ce_tc_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const int* __restrict__ labels,
    float* __restrict__ pm, float* __restrict__ ps, float* __restrict__ pp,
    int n_tok, int D, int Vp, int V, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_base = base;
  const uint32_t b_base = base + STAGES * A_BYTES;
  const uint32_t full_bar = base + STAGES * (A_BYTES + B_BYTES);
  const uint32_t empty_bar = full_bar + STAGES * 8;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (Vp + BN - 1) / BN;
  const int tile_lo = blockIdx.y * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  const int n_k = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, 2);      // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile_lo; tile < tile_hi; ++tile) {
        for (int kc = 0; kc < n_k; ++kc) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1u);
          const uint32_t fb = full_bar + 8 * stage;
          mbar_expect_tx(fb, A_BYTES + B_BYTES);
          tma_load(a_base + stage * A_BYTES, &tm_x, fb, kc * BK, row0);
          tma_load(b_base + stage * B_BYTES, &tm_w, fb, kc * BK, tile * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [row0 + 64 wg, +64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);          // first column of the thread
    int lab[2];
    float m[2], s[2], p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      lab[h] = r < n_tok ? labels[r] : -1;
      m[h] = NEG;
      s[h] = 0.0f;
      p[h] = 0.0f;
    }
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;

    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int col0 = tile * BN;
      for (int kc = 0; kc < n_k; ++kc) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a = a_base + stage * A_BYTES + wg * 64 * (BK * 2);
        const uint32_t b = b_base + stage * B_BYTES;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n256k16(d, desc_sw128(a + 32 * k), desc_sw128(b + 32 * k),
                           (kc | k) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous slice's products are done: free its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kc > 0 && t == 0) mbar_arrive(empty_bar + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(d);
      if (t == 0) mbar_arrive(empty_bar + 8 * prev);

      // epilogue: d[4j + 2h + e] is row r_lo + 8h, column col0 + 8j + cq + e
      const bool ragged = col0 + BN > V;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ragged) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = col0 + 8 * j + cq + e;
              float& l = d[4 * j + 2 * h + e];
              if (c >= Vp) l = -INFINITY;    // past the array: no column
              else if (c >= V) l = NEG;      // vocab padding
            }
        }
        if (lab[h] >= col0 && lab[h] < col0 + BN) {
          const int rel = lab[h] - col0 - cq;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e == rel) p[h] += d[4 * j + 2 * h + e];
        }
        float tmax = m[h];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) tmax = fmaxf(tmax, d[4 * j + 2 * h + e]);
        float si = s[h] * expf(m[h] - tmax);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) si += expf(d[4 * j + 2 * h + e] - tmax);
        s[h] = si;
        m[h] = tmax;
      }
    }

    // the quad's four lanes hold the same two rows: merge their states
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mm = m[h];
      mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, 1));
      mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, 2));
      float ss = s[h] * expf(m[h] - mm), pk = p[h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        ss += __shfl_xor_sync(FULL, ss, off);
        pk += __shfl_xor_sync(FULL, pk, off);
      }
      const int r = r_lo + 8 * h;
      if (lane % 4 == 0 && r < n_tok) {
        const long long o = (long long)blockIdx.y * n_tok + r;
        pm[o] = mm;
        ps[o] = ss;
        pp[o] = pk;
      }
    }
  }
}

// A (rows, D) row-major bf16 matrix, read in boxes of box_rows x 64.
bool encode(CUtensorMap* map, const void* ptr, int rows, int D,
            int box_rows) {
  return encode_rows(map, ptr, rows, D, BK, box_rows);
}

}  // namespace tc

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

// The tensor-core body: x (n_tok, D) and w (Vp, D) contiguous bf16 with D
// a multiple of 8 and 16-byte aligned bases; the rest as fused_ce_launch,
// with 256-column vocab tiles: n_split * tiles_per_split >= ceil(Vp / 256)
// > (n_split - 1) * tiles_per_split.
extern "C" int fused_ce_tc_launch(const void* x, const void* w,
                                  const void* labels, void* nll, void* lse,
                                  void* scratch, int n_tok, int D, int Vp,
                                  int V, int n_split, int tiles_per_split,
                                  void* stream) {
  const int n_tiles = (Vp + tc::BN - 1) / tc::BN;
  if (n_tok < 1 || D < 8 || D % 8 != 0 || Vp < 1 || V < 0 || n_split < 1 ||
      n_split > 65535 || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split < n_tiles ||
      (long long)(n_split - 1) * tiles_per_split >= n_tiles ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  if (!tc::encode(&tm_x, x, n_tok, D, tc::BM) ||
      !tc::encode(&tm_w, w, Vp, D, tc::BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tc::fused_ce_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int* lab = static_cast<const int*>(labels);
  float* pm = static_cast<float*>(scratch);
  float* ps = pm + (long long)n_split * n_tok;
  float* pp = ps + (long long)n_split * n_tok;
  const dim3 grid((n_tok + tc::BM - 1) / tc::BM, n_split);
  tc::fused_ce_tc_kernel<<<grid, tc::THREADS, tc::SMEM, st>>>(
      tm_x, tm_w, lab, pm, ps, pp, n_tok, D, Vp, V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_combine_kernel<<<(n_tok + 255) / 256, 256, 0, st>>>(
      pm, ps, pp, lab, static_cast<float*>(nll), static_cast<float*>(lse),
      n_tok, n_split);
  return (int)cudaGetLastError();
}
