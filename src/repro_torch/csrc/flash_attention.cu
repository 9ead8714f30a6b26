// flash_attention: causal or full softmax attention with an online softmax
// (the FlashAttention-2 forward).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py: out = softmax(q k^T * scale)
// v per (batch, head), masked scores set to -1e30 before the running max,
// p kept in f32 for p v, the output acc / max(l, 1e-30) in q's dtype. q, k
// and v are read in the (B, S, H, D) layout by strides (KV heads already
// expanded to H).
//
// Bound on this card: at the serving shape of qwen3-4b (B=4, S=512, H=32,
// D=128, bf16, causal) the four tensors are 67 MB (20 us at 3.35 TB/s) and
// the causal products 8.6 GFLOP (8.7 us at 989 TFLOP/s), so the bytes bound
// it; keeping p at f32 accuracy as two bf16 products (below) makes the
// tensor-core work 12.9 GFLOP (13 us), still under the byte bound.
//
// Two bodies; the wrapper picks one from dtype and D alone
// (kernels/flash_attention/ops.py):
//
// Tensor-core body (flash_attention_tc_kernel; bf16 with D % 16 == 0,
// D <= 128): a block of 288 threads owns one (b*h, 128 query rows), the
// heaviest causal rows first. One producer thread loads the block's q rows
// once and keeps a ring of 3 stages of k and v tiles (64 keys x D) in
// flight with TMA (4-D tensor maps over the strided (B, S, H, D) views,
// 64 x 64 boxes of 128-byte swizzled rows, zeros past S and D), mbarriers
// saying when a stage is full and when both consumers have freed it. Two
// consumer warpgroups of 64 rows each compute s = q k^T with wgmma
// m64n64k16 (bf16 operands K-major from shared memory, f32 accumulators:
// bf16 x bf16 products are exact in f32, so only the order of the sums
// differs from the reference's f32 dot), multiply by `scale` after the
// product as the reference does, mask, and fold the tile into each row's
// running max and sum in f32 registers with expf (a quad of lanes holds
// a row's scores). p is kept at f32 accuracy as p_hi = bf16(p) and p_lo =
// bf16(p - p_hi) (about 16 bits of p), and o += p_hi v + p_lo v runs as
// two wgmma m64nDk16 a k-step with A from registers (the accumulator's own
// layout, so p never leaves the registers) and v's tile as B in MN-major
// form (keys x D, D contiguous: the transpose bit). D is padded to 64 or
// 128 by the maps' zero fill. Key tiles past a warpgroup's diagonal are
// skipped (exact, as the SIMT note below says). Each warpgroup waits for
// its products (wait_group 0) before it touches their accumulators, and
// defines an accumulator (zeroing s, rescaling o) only outside the span
// from a wgmma.fence to its wait: ptxas serialises every wgmma of the
// kernel otherwise (its C7515 warning). The two warpgroups' softmax and
// products interleave on the SM; the register accumulators are tied to
// the waits with an empty asm on each.
//
// SIMT body (flash_attention_kernel; f32, whose 1e-5 bar the tensor
// cores' products would miss, and bf16 with other D): one block of 256
// threads per (query tile of 64 rows, b*h). The q tile is staged in shared
// memory as f32; the loop over key tiles of 64 stages k, computes the 64x64
// scores in registers (4x4 per thread, scalar multiply-adds: the library
// is built with --fmad=false), takes the row max and row sum with shuffles
// inside each 16-lane half-warp (one half-warp holds whole rows), writes p
// to shared memory, then stages v in the same buffer and adds p v into an
// f32 accumulator held in registers (4 rows x DMAX/16 columns per thread).
// Under `causal` the key tiles past the diagonal are skipped: that is
// exact, since key 0 gives every row a finite max in the first tile, after
// which a wholly masked tile adds exp(-1e30 - m) = 0 and scales by
// exp(0) = 1. Rows and keys past S are masked, so S need not be a multiple
// of the tile. The heaviest causal tiles are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16: tx picks columns, ty rows
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage rows [row0, row0 + ROWS) of one (b, h) slice into dst (row stride
// LD floats) as f32; zeros past S and past D.
template <typename T, int DMAX, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long base, long long s_stride,
                                          int row0, int S, int D) {
  for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    const int s = row0 + r;
    float x = 0.0f;
    if (s < S && d < D) x = to_f32(src[base + (long long)s * s_stride + d]);
    dst[r * LD + d] = x;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int S, int H, int D, int causal, float scale) {
  constexpr int LD = DMAX + 4;     // padded row stride: conflict-free float4
  constexpr int LDP = BK + 4;
  constexpr int NJ = DMAX / 64;    // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x LD
  float* kvs = qs + BQ * LD;                     // BK x LD: k, then v
  float* ps = kvs + BK * LD;                     // BQ x LDP

  const int nq = gridDim.y;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int d_end = (D + 3) & ~3;  // past D the tiles hold zeros

  load_tile<T, DMAX, LD, BQ>(qs, q, b * qsb + h * qsh, qss, q0, S, D);

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
  }

  const int nk = (S + BK - 1) / BK;
  const int k_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the last tile's reads of kvs/ps done
    load_tile<T, DMAX, LD, BK>(kvs, k, b * ksb + h * ksh, kss, k0, S, D);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < d_end; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = a + qv[i].x * kv[j].x;
          a = a + qv[i].y * kv[j].y;
          a = a + qv[i].z * kv[j].z;
          a = a + qv[i].w * kv[j].w;
          s[i][j] = a;
        }
    }

    // online softmax; a row's 64 scores live in one 16-lane half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kc >= S || (causal && kc > qr)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs = rs + p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs = rs + __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = acc[i][j][c] * alpha;
    }
    __syncthreads();               // every read of k done, p written
    load_tile<T, DMAX, LD, BK>(kvs, v, b * vsb + h * vsh, vss, k0, S, D);
    __syncthreads();

    // acc += p v: rows ty + 16 i, columns 64 j + 4 tx + c
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &kvs[(kk + r) * LD + 64 * j + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = r == 0 ? pv[i].x : r == 1 ? pv[i].y
                          : r == 2 ? pv[i].z : pv[i].w;
            acc[i][j][0] = acc[i][j][0] + p * vv.x;
            acc[i][j][1] = acc[i][j][1] + p * vv.y;
            acc[i][j][2] = acc[i][j][2] + p * vv.z;
            acc[i][j][3] = acc[i][j][3] + p * vv.w;
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), contiguous (B, S, H, D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * S + qr) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 64 * j + 4 * tx + c;
        if (d < D) orow[d] = from_f32<T>(acc[i][j][c] / den);
      }
  }
}

template <typename T, int DMAX>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int B, int S, int H, int D, int causal, float scale,
                 cudaStream_t stream) {
  constexpr int LD = DMAX + 4;
  constexpr size_t smem =
      (size_t)(BQ * LD + BK * LD + BQ * (BK + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, qsb, qss, qsh, ksb, kss,
      ksh, vsb, vss, vsh, S, H, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o,
               long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               int B, int S, int H, int D, int causal, float scale,
               cudaStream_t stream) {
  if (D <= 64)
    return launch_typed<T, 64>(q, k, v, o, qsb, qss, qsh, ksb, kss, ksh,
                               vsb, vss, vsh, B, S, H, D, causal, scale,
                               stream);
  return launch_typed<T, 128>(q, k, v, o, qsb, qss, qsh, ksb, kss, ksh,
                              vsb, vss, vsh, B, S, H, D, causal, scale,
                              stream);
}


// ---- tensor-core body ---------------------------------------------------

namespace tc {

using namespace tma;

constexpr int BQ = 128;                  // query rows a block (2 x 64)
constexpr int BKEY = 64;                 // keys a tile
constexpr int CH = 64;                   // head-dim columns a box: 128 bytes
constexpr int BOX = 64 * CH * 2;         // one 64-row box, 8 KB
constexpr int STAGES = 3;                // K/V tiles in flight
constexpr int THREADS = 288;             // 2 consumer warpgroups, 1 producer
constexpr float NEG = -1e30f;

template <int DP>                        // head dim padded to 64 or 128
struct Plan {
  static constexpr int NCH = DP / CH;                // boxes a 64-row tile
  static constexpr int Q_BYTES = 2 * NCH * BOX;      // 128 query rows
  static constexpr int KV_BYTES = NCH * BOX;         // 64 keys of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + (1 + 2 * STAGES) * 8;
};

// wgmma descriptor of an MN-major operand in 128-byte swizzled rows: rows
// of 64 MN elements (128 B) at 128 B, 1,024 B between groups of 8 K rows,
// `lbo` bytes between 64-element MN blocks, swizzle mode 128B.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr,
                                                  uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// S (64 x 64) = A B^T, or += when scale_d: A (64 x 16) and B (64 x 16)
// bf16, K-major in 128-byte swizzled shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64) += A B: A (64 x 16 bf16) from registers, in the
// accumulator's layout; B (16 x 64) MN-major in 128-byte swizzled
// shared memory (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A B: A (64 x 16 bf16) from registers, in the
// accumulator's layout; B (16 x 128) MN-major in 128-byte swizzled
// shared memory (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void pv_mma(float (&o)[DP / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// The A operand's registers, as fence_regs does for accumulators.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One 64 x 64 box of a (B, S, H, D) map at (col, s, h, b); `perm` packs
// the map coordinates (1..3) of S, H and B, two bits each (encode_bshd).
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int perm, int col,
                                         int s, int h, int b) {
  int c[4];
  c[0] = col;
  c[perm & 3] = s;
  c[(perm >> 2) & 3] = h;
  c[(perm >> 4) & 3] = b;
  tma_load_4d(dst, map, bar, c[0], c[1], c[2], c[3]);
}

// One block: query rows [q0, q0 + 128) of one (b, h); warpgroup wg owns
// rows q0 + 64 wg + [0, 64), the producer warp's first thread the loads.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    int S, int H, int D, int causal, float scale, int perm_q, int perm_k,
    int perm_v) {
  using PL = Plan<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + PL::Q_BYTES;
  const uint32_t q_bar = kv_s + STAGES * PL::STAGE_BYTES;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + STAGES * 8;
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * BQ;  // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int nk = (S + BKEY - 1) / BKEY;
  const int k_end = causal ? min(nk, (q0 + BQ - 1) / BKEY + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, 2);      // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: Q once, then a ring of K/V tiles
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, PL::Q_BYTES);
      for (int g = 0; g < 2; ++g)
        for (int c = 0; c < PL::NCH; ++c)
          load_box(q_s + (g * PL::NCH + c) * BOX, &tm_q, q_bar, perm_q,
                   c * CH, q0 + 64 * g, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_end; ++kt) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1u);
        const uint32_t fb = full_bar + 8 * stage;
        const uint32_t ks = kv_s + stage * PL::STAGE_BYTES;
        mbar_expect_tx(fb, PL::STAGE_BYTES);
        for (int c = 0; c < PL::NCH; ++c) {
          load_box(ks + c * BOX, &tm_k, fb, perm_k, c * CH, kt * BKEY, h,
                   b);
          load_box(ks + PL::KV_BYTES + c * BOX, &tm_v, fb, perm_v, c * CH,
                   kt * BKEY, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumers: d[4j + 2hh + e] of a 64-row accumulator is row
  // r0 + 8 hh, column 8 j + cq + e
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  // key tiles past this warpgroup's diagonal are wholly masked: skipped
  const int my_end =
      causal ? min(k_end, (q0 + 64 * wg + 63) / BKEY + 1) : k_end;
  const int n_kd = (D + 15) / 16;          // k16 steps of q k^T
  const uint32_t qa = q_s + wg * PL::NCH * BOX;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < my_end; ++kt) {
    mbar_wait(full_bar + 8 * stage, phase);
    const uint32_t ks = kv_s + stage * PL::STAGE_BYTES;
    const uint32_t vs = ks + PL::KV_BYTES;
    // every non-wgmma definition of an accumulator lies outside the span
    // from a wgmma.fence to its wait_group (ptxas serialises the wgmmas
    // otherwise), so each product is waited for before the next begins
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk < n_kd) {
        const uint32_t off = (kk / 4) * BOX + 32 * (kk % 4);
        wgmma_ss_n64(s, desc_sw128(qa + off), desc_sw128(ks + off), kk != 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(s);

    // online softmax of rows r0 and r0 + 8 (a quad's four lanes hold each
    // row's 64 scores); scale after the product, as the reference does
    const int k0 = kt * BKEY;
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + cq + e;
          float x = s[4 * j + 2 * hh + e] * scale;
          if (key >= S || (causal && key > row)) x = NEG;
          s[4 * j + 2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = expf(m[hh] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[4 * j + 2 * hh + e] - m_new);
          s[4 * j + 2 * hh + e] = p;
          rs = rs + p;
        }
      rs = rs + __shfl_xor_sync(FULL, rs, 1);
      rs = rs + __shfl_xor_sync(FULL, rs, 2);
      l[hh] = l[hh] * alpha + rs;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[4 * j + 2 * hh + e] = acc[4 * j + 2 * hh + e] * alpha;
    }
    // p at f32 accuracy as two bf16 operands: p = hi + lo + O(2^-16 p);
    // keys 16 kk .. 16 kk + 15 are s[8 kk .. 8 kk + 7], A's register layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s[8 * kk + 2 * i], c = s[8 * kk + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            a - __low2float(hi), c - __high2float(hi));
        ph[kk][i] = bf16x2_bits(hi);
        pl[kk][i] = bf16x2_bits(lo);
      }
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_frag(ph[kk]);
      fence_frag(pl[kk]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn_sw128(vs + kk * 16 * 128, BOX);
      pv_mma<DP>(acc, ph[kk], dv);
      pv_mma<DP>(acc, pl[kk], dv);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (t == 0) mbar_arrive(empty_bar + 8 * stage);    // k and v read
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // out = acc / max(l, 1e-30) in bf16, contiguous (B, S, H, D)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= S) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] / den,
                                  acc[4 * j + 2 * hh + 1] / den);
    }
  }
}

// A (B, S, H, D) bf16 view with unit stride on D as a 4-D tensor map read
// in boxes of 64 rows of S x 64 columns of D (128-byte swizzle; zeros past
// S and D). The S, H and B axes go in increasing stride order (an axis of
// size 1 last), so the map's strides nest as the encoder expects; *perm
// gets the map coordinates (1..3) of S, H and B, two bits each.
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                 int D, long long sb, long long ss, long long sh,
                 int* perm) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  long long size[3] = {S, H, B}, stride[3] = {ss, sh, sb};
  long long top = 8;                     // 16 bytes: the smallest stride
  for (int a = 0; a < 3; ++a)
    if (size[a] > 1 && size[a] * stride[a] > top) top = size[a] * stride[a];
  for (int a = 0; a < 3; ++a)
    if (size[a] == 1) stride[a] = top;   // never stepped
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)            // insertion sort by stride, stable
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)CH, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    dims[i + 1] = (cuuint64_t)size[a];
    strides[i] = (cuuint64_t)stride[a] * 2;
    *perm |= (i + 1) << (2 * a);
    if (a == 0) box[i + 1] = 64;         // 64 rows of S
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements; the last dim
// of q, k and v has stride 1 and `o` is contiguous (B, S, H, D).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int B, int S, int H, int D, int causal, int dtype, float scale,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 128 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, o, qsb, qss, qsh, ksb, kss, ksh, vsb,
                               vss, vsh, B, S, H, D, causal, scale, st);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, o, qsb, qss, qsh, ksb, kss,
                                       ksh, vsb, vss, vsh, B, S, H, D, causal,
                                       scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core body: bf16 q, k, v with 1 <= D <= 128 and D % 16 == 0,
// each with a unit stride on D, 16-byte aligned bases and strides (TMA);
// strides in elements; `o` contiguous (B, S, H, D) bf16.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int B, int S, int H, int D, int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 16 || D > 128 || D % 16 != 0 ||
      (S + tc::BQ - 1) / tc::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  int pq, pk, pv;
  if (!tc::encode_bshd(&tm_q, q, B, S, H, D, qsb, qss, qsh, &pq) ||
      !tc::encode_bshd(&tm_k, k, B, S, H, D, ksb, kss, ksh, &pk) ||
      !tc::encode_bshd(&tm_v, v, B, S, H, D, vsb, vss, vsh, &pv))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + tc::BQ - 1) / tc::BQ);
  cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  cudaError_t err;
  if (D <= 64) {
    err = cudaFuncSetAttribute(tc::flash_attention_tc_kernel<64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::Plan<64>::SMEM);
    if (err != cudaSuccess) return (int)err;
    tc::flash_attention_tc_kernel<64>
        <<<grid, tc::THREADS, tc::Plan<64>::SMEM, st>>>(
            tm_q, tm_k, tm_v, out, S, H, D, causal, scale, pq, pk, pv);
  } else {
    err = cudaFuncSetAttribute(tc::flash_attention_tc_kernel<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::Plan<128>::SMEM);
    if (err != cudaSuccess) return (int)err;
    tc::flash_attention_tc_kernel<128>
        <<<grid, tc::THREADS, tc::Plan<128>::SMEM, st>>>(
            tm_q, tm_k, tm_v, out, S, H, D, causal, scale, pq, pk, pv);
  }
  return (int)cudaGetLastError();
}
