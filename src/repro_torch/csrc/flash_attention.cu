// flash_attention: causal or full softmax attention with an online softmax
// (the FlashAttention-2 forward).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_kernel` in
// src/repro/kernels/flash_attention/kernel.py: out = softmax(q k^T * scale)
// v per (batch, head), masked scores set to -1e30 before the running max,
// the output acc / max(l, 1e-30) in q's dtype. q, k and v are read in the
// (B, S, H, D) layout by strides (KV heads already expanded to H), in f32
// or bf16; everything inside is f32.
//
// Bound on this card: at the serving shape of qwen3-4b (B=4, S=512, H=32,
// D=128, bf16, causal) the four tensors are 67 MB (20 us at 3.35 TB/s) and
// the causal products 8.6 GFLOP (8.7 us at 989 TFLOP/s), so the bytes bound
// it. This first kernel computes in f32 with scalar multiply-adds (no tensor
// cores; the library is built with --fmad=false, so each is a multiply and
// an add) and sits far above that bound; wgmma and TMA are later work.
//
// Design: one block of 256 threads per (query tile of 64 rows, b*h). The
// q tile is staged in shared memory as f32; the loop over key tiles of 64
// stages k, computes the 64x64 scores in registers (4x4 per thread), takes
// the row max and row sum with shuffles inside each 16-lane half-warp (one
// half-warp holds whole rows), writes p to shared memory, then stages v in
// the same buffer and adds p v into an f32 accumulator held in registers
// (4 rows x DMAX/16 columns per thread). Under `causal` the key tiles past
// the diagonal are skipped: that is exact, since key 0 gives every row a
// finite max in the first tile, after which a wholly masked tile adds
// exp(-1e30 - m) = 0 and scales by exp(0) = 1. Rows and keys past S are
// masked, so S need not be a multiple of the tile. The heaviest causal
// tiles are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
