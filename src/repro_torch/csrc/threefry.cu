// threefry: the key stream's draws (core/prng: split, bits, uniform and
// randint's two bit planes), one launch a draw.
//
// Replaces no TPU kernel: the reference draws with `jax.random` under
// jax_threefry_partitionable, which XLA fuses into one loop. The port's
// plain version (kernels/threefry/ref.py, the CPU path) computes the same
// hash as a chain of int64 elementwise PyTorch ops, about 180 launches for
// every 2^23 positions. This kernel gives its bits exactly: key row r of a
// (K, 2) int64 key tensor hashes the counter pairs (i >> 32, i & 0xFFFFFFFF)
// of its flat indices i = 0..n-1 with threefry-2x32 (20 rounds), and one
// finish, chosen by the launch's mode, maps the pair (b0, b1):
//   PAIRS    (b0, b1) as int64 -> (K, n, 2)   split
//   BITS     b0 ^ b1 as int64 in [0, 2^32)   bits, randint
//   UNIFORM  float(1 | (b0 ^ b1) >> 9) - 1, at least 0   uniform
//
// Bound on this card: 32-bit integer issue, not bytes. An output costs
// about 80 int32 instructions: 20 rounds of an add, a rotate (one funnel
// shift) and an xor, five key injections of two adds, the counter words
// and the finish. The sweeps' draw of 1,024 x 12,500 uniforms needs ~61 us
// of issue at 132 SMs x 64 lanes x 1.98 GHz (the H100 SXM's top SM clock),
// and its 51 MB of f32 15 us at 3.35 TB/s; it takes 64 us on an H100 80GB
// HBM3 at 700 W.
//
// Design: every intermediate is a uint32 in registers; only the keys are
// read and each output is written once. A thread takes PER_THREAD
// consecutive flat positions of the (K, n) output: it finds its first
// position's key row with one division and steps across row ends, then
// hashes the PER_THREAD counters as independent chains that the compiler
// interleaves, which hides the ALU latency. Stores are coalesced,
// PER_THREAD consecutive outputs a thread: one float4 (UNIFORM), two
// (BITS) or four (PAIRS) 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;                 // consecutive outputs a thread
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;
constexpr int PAIRS = 0, BITS = 1, UNIFORM = 2;

__device__ __forceinline__ constexpr int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// threefry-2x32 of the counter pair (x0, x1) under the key (k0, k1), in
// place, as prng.threefry2x32.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ KS_PARITY};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float unit_float(uint32_t b) {
  return fmaxf(__uint_as_float((b >> 9) | 0x3F800000u) - 1.0f, 0.0f);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(const int64_t* __restrict__ keys, void* __restrict__ out,
                int64_t K, int64_t n) {
  const int64_t total = K * n;
  const int64_t p0 =
      ((int64_t)blockIdx.x * THREADS + threadIdx.x) * PER_THREAD;
  if (p0 >= total) return;
  int64_t row;
  if (total <= 0xFFFFFFFFLL) {       // a 32-bit divide, nearly always
    row = (uint32_t)p0 / (uint32_t)n;
  } else {
    row = p0 / n;
  }
  int64_t i = p0 - row * n;
  uint32_t k0[PER_THREAD], k1[PER_THREAD], x0[PER_THREAD], x1[PER_THREAD];
#pragma unroll
  for (int v = 0; v < PER_THREAD; ++v) {
    if (i == n) {                       // past a row's end: the next key
      i = 0;
      ++row;
    }
    const int64_t r = row < K ? row : K - 1;   // past the end: unstored
    k0[v] = (uint32_t)keys[2 * r];
    k1[v] = (uint32_t)keys[2 * r + 1];
    x0[v] = (uint32_t)((uint64_t)i >> 32);
    x1[v] = (uint32_t)i;
    ++i;
  }
#pragma unroll
  for (int v = 0; v < PER_THREAD; ++v) threefry(k0[v], k1[v], x0[v], x1[v]);

  const bool whole = p0 + PER_THREAD <= total;
  if (MODE == UNIFORM) {
    float f[PER_THREAD];
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) f[v] = unit_float(x0[v] ^ x1[v]);
    float* o = (float*)out + p0;
    if (whole) {
      *(float4*)o = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int v = 0; v < PER_THREAD; ++v) {
        if (p0 + v < total) o[v] = f[v];
      }
    }
  } else if (MODE == BITS) {
    long long b[PER_THREAD];
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) b[v] = (long long)(x0[v] ^ x1[v]);
    long long* o = (long long*)out + p0;
    if (whole) {
      ((longlong2*)o)[0] = make_longlong2(b[0], b[1]);
      ((longlong2*)o)[1] = make_longlong2(b[2], b[3]);
    } else {
#pragma unroll
      for (int v = 0; v < PER_THREAD; ++v) {
        if (p0 + v < total) o[v] = b[v];
      }
    }
  } else {
    longlong2* o = (longlong2*)out + p0;
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) {
      if (p0 + v < total) {
        o[v] = make_longlong2((long long)x0[v], (long long)x1[v]);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const void* keys, void* out, long long K, long long n,
                   cudaStream_t s) {
  const long long total = K * n;
  const long long per_block = (long long)THREADS * PER_THREAD;
  const long long blocks = (total + per_block - 1) / per_block;
  threefry_kernel<MODE><<<(unsigned)blocks, THREADS, 0, s>>>(
      (const int64_t*)keys, out, K, n);
  return cudaGetLastError();
}

}  // namespace

// keys (K, 2) int64 holding uint32 words, out (K, n, 2) int64 (mode 0),
// (K, n) int64 (mode 1) or (K, n) float32 (mode 2), both contiguous and
// 16-byte aligned; K * n > 0.
extern "C" int threefry_launch(const void* keys, void* out, long long K,
                               long long n, int mode, void* stream) {
  if (K < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case PAIRS: return (int)launch<PAIRS>(keys, out, K, n, s);
    case BITS: return (int)launch<BITS>(keys, out, K, n, s);
    case UNIFORM: return (int)launch<UNIFORM>(keys, out, K, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
