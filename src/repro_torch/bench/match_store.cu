// match_store: kernel A (csrc/constraint_match.cu) at cell A's shapes in
// other forms than the library ships, each checked bitwise against it:
// task runs of 16, 32 and 128 instead of 64; divides only for feasible
// pairs (a branch a pair) instead of every pair; its output written by TMA
// tile stores from shared memory (cp.async.bulk.tensor, a group of GT
// tasks stored while the next group is computed) instead of 16-byte
// streaming stores. Two diagnostics bound the store stream: the same grid
// writing a constant (no scores), and cudaMemsetAsync of the output. On a
// machine with the card, from the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false \
//     -I src/repro_torch/csrc src/repro_torch/bench/match_store.cu \
//     -o build/match_store -ldl && build/match_store
//
// Inputs: P=1,024 tasks, N=12,500 nodes, R=3, C=6, K=16, B=1 and B=8
// lanes, grid-aligned values from a fixed seed (as chip_smoke.py's). Each
// line: the median of 20 launches (CUDA events, the 50 MB L2 flushed
// before each); the last line is one JSON object of the same numbers.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <random>
#include <string>
#include <vector>

#include "tma.cuh"
#include "constraint_match.cu"

namespace {

#define CK(x)                                                       \
  do {                                                              \
    cudaError_t e = (x);                                            \
    if (e != cudaSuccess) {                                         \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(e),   \
             __LINE__);                                             \
      exit(1);                                                      \
    }                                                               \
  } while (0)

constexpr int GT = 4;         // tasks a TMA store group
constexpr int BOX_N = 256;    // nodes a box (the largest inner box)

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const float* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(tma::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Kernel A with the output staged in two shared-memory buffers of GT
// tasks x TILE_N nodes and written by TMA tile stores: while group g's
// stores drain, the block computes group g + 1 into the other buffer.
template <int R, int RUN>
__global__ void __launch_bounds__(THREADS) match_tma_kernel(
    const float* __restrict__ req, const int* __restrict__ cons,
    const float* __restrict__ total, const float* __restrict__ reserved,
    const int* __restrict__ attrs, const unsigned char* __restrict__ active,
    const __grid_constant__ CUtensorMap out_map, int P, int N, int C,
    int K) {
  extern __shared__ __align__(128) int4 smem_raw[];
  float* obuf = reinterpret_cast<float*>(smem_raw);   // [2][GT * TILE_N]
  const Smem sm = carve(obuf + 2 * GT * TILE_N, K, C, RUN);
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE_N;
  const int p0 = blockIdx.y * RUN;
  const int run = min(RUN, P - p0);
  const int n = n0 + tid * NPT;
  Nodes<R> nd;
  stage<R>(req, cons, total, reserved, attrs, active, b, p0, run, n, P, N,
           C, K, sm, nd);
  __syncthreads();

  // box h of a buffer holds nodes n0 + h*BOX_N .. as [GT][BOX_N]
  const int box = tid / (BOX_N / NPT);
  const int col = (tid % (BOX_N / NPT)) * NPT;
  const int groups = (run + GT - 1) / GT;
  for (int g = 0; g < groups; ++g) {
    float* buf = obuf + (g & 1) * GT * TILE_N;
    if (g >= 2) {             // group g - 2's stores have read this buffer
      if (tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      }
      __syncthreads();
    }
    for (int k = 0; k < GT; ++k) {
      const int pl = g * GT + k;
      float v[NPT] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (pl < run) scores<R>(nd, sm, pl, C, v);
      *reinterpret_cast<float4*>(buf + (box * GT + k) * BOX_N + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {           // rows past P and nodes past N are clipped
      for (int h = 0; h < TILE_N / BOX_N; ++h) {
        tma_store_3d(&out_map, buf + h * GT * BOX_N, n0 + h * BOX_N,
                     p0 + g * GT, (int)b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The shipped kernel's loop in other forms: SKIP divides only for
// feasible pairs, a branch a pair (the same scores); STORES_ONLY writes a
// constant (no scores: the store stream alone, a diagnostic).
template <int R, bool SKIP, bool STORES_ONLY>
__global__ void __launch_bounds__(THREADS) match_form_kernel(
    const float* __restrict__ req, const int* __restrict__ cons,
    const float* __restrict__ total, const float* __restrict__ reserved,
    const int* __restrict__ attrs, const unsigned char* __restrict__ active,
    float* __restrict__ out, int P, int N, int C, int K, int run_len) {
  extern __shared__ int4 smem_form[];
  const Smem sm = carve(smem_form, K, C, run_len);
  const size_t b = blockIdx.z;
  const int p0 = blockIdx.y * run_len;
  const int run = min(run_len, P - p0);
  const int n = blockIdx.x * TILE_N + threadIdx.x * NPT;
  Nodes<R> nd;
  stage<R>(req, cons, total, reserved, attrs, active, b, p0, run, n, P, N,
           C, K, sm, nd);
  __syncthreads();
  for (int pl = 0; pl < run; ++pl) {
    float v[NPT] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (!STORES_ONLY) scores<R, SKIP>(nd, sm, pl, C, v);
    float* o = out + (b * P + p0 + pl) * (size_t)N + n;
    if (n + NPT <= N) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      for (int j = 0; j < NPT; ++j) {
        if (n + j < N) __stcs(o + j, v[j]);
      }
    }
  }
}

bool encode_out(CUtensorMap* map, float* out, int B, int P, int N) {
  tma::EncodeTiled fn = tma::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 4, (cuuint64_t)P * N * 4};
  const cuuint32_t box[3] = {BOX_N, GT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Inputs {
  float *req, *total, *reserved;
  int *cons, *attrs;
  unsigned char* active;
};

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

template <class F>
float time_ms(F launch, unsigned char* flush, size_t flush_bytes) {
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  for (int i = 0; i < 2; ++i) CK(launch());
  std::vector<float> t;
  for (int i = 0; i < 20; ++i) {
    CK(cudaMemsetAsync(flush, i, flush_bytes));
    CK(cudaEventRecord(e0));
    CK(launch());
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms = 0.0f;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    t.push_back(ms);
  }
  CK(cudaEventDestroy(e0));
  CK(cudaEventDestroy(e1));
  return median(t);
}

}  // namespace

int main() {
  constexpr int P = 1024, N = 12500, R = 3, C = 6, K = 16, BMAX = 8;
  std::mt19937 rng(0);
  auto grid = [&](int lo, int hi) {
    return (float)std::uniform_int_distribution<int>(lo, hi - 1)(rng) / 128;
  };
  auto uni = [&](int lo, int hi) {
    return std::uniform_int_distribution<int>(lo, hi - 1)(rng);
  };
  std::vector<float> req(BMAX * P * R), total(BMAX * N * R),
      reserved(BMAX * N * R);
  std::vector<int> cons(BMAX * P * C * 3), attrs(BMAX * N * K);
  std::vector<unsigned char> active(BMAX * N);
  for (auto& x : req) x = grid(1, 48);
  for (auto& x : total) x = grid(64, 256);
  for (auto& x : reserved) x = grid(0, 64);
  for (auto& x : attrs) x = uni(0, 4);
  for (auto& x : active) x = uni(0, 100) < 95;
  for (int i = 0; i < BMAX * P * C; ++i) {
    cons[i * 3] = uni(0, K);
    cons[i * 3 + 1] = uni(0, 100) < 80 ? 0 : uni(1, 5);
    cons[i * 3 + 2] = uni(0, 4);
  }
  Inputs in;
  CK(cudaMalloc(&in.req, req.size() * 4));
  CK(cudaMalloc(&in.total, total.size() * 4));
  CK(cudaMalloc(&in.reserved, reserved.size() * 4));
  CK(cudaMalloc(&in.cons, cons.size() * 4));
  CK(cudaMalloc(&in.attrs, attrs.size() * 4));
  CK(cudaMalloc(&in.active, active.size()));
  CK(cudaMemcpy(in.req, req.data(), req.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(in.total, total.data(), total.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(in.reserved, reserved.data(), reserved.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(in.cons, cons.data(), cons.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(in.attrs, attrs.data(), attrs.size() * 4,
                cudaMemcpyHostToDevice));
  CK(cudaMemcpy(in.active, active.data(), active.size(),
                cudaMemcpyHostToDevice));
  const size_t out_n = (size_t)BMAX * P * N;
  float *want, *got;
  CK(cudaMalloc(&want, out_n * 4));
  CK(cudaMalloc(&got, out_n * 4));
  const size_t flush_bytes = 64u << 20;
  unsigned char* flush;
  CK(cudaMalloc(&flush, flush_bytes));
  std::vector<float> h_want(out_n), h_got(out_n);

  const size_t tma_smem = sizeof(float) * 2 * GT * TILE_N +
                          smem_bytes(K, C, RUN_P);
  CK(cudaFuncSetAttribute(match_tma_kernel<R, RUN_P>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)tma_smem));
  std::string json = "{\"match_store\": [";
  for (int B : {1, BMAX}) {
    auto lib = [&](float* o) {
      return [=]() {
        return launch<R>(in.req, in.cons, in.total, in.reserved, in.attrs,
                         in.active, o, B, P, N, C, K, 0);
      };
    };
    CK(lib(want)());
    CK(cudaDeviceSynchronize());
    CK(cudaMemcpy(h_want.data(), want, (size_t)B * P * N * 4,
                  cudaMemcpyDeviceToHost));
    CUtensorMap map;
    if (!encode_out(&map, got, B, P, N)) {
      printf("cuTensorMapEncodeTiled failed\n");
      return 1;
    }
    struct Form {
      const char* name;
      std::function<cudaError_t()> fn;
      bool diagnostic;        // not the scores: not compared
    };
    const dim3 tma_grid((N + TILE_N - 1) / TILE_N, (P + RUN_P - 1) / RUN_P,
                        B);
    auto form = [=](int run_len, bool skip, bool stores_only) {
      return [=]() {
        const dim3 g((N + TILE_N - 1) / TILE_N, (P + run_len - 1) / run_len,
                     B);
        const size_t sb = smem_bytes(K, C, run_len);
        if (stores_only) {
          match_form_kernel<R, false, true><<<g, THREADS, sb>>>(
              in.req, in.cons, in.total, in.reserved, in.attrs, in.active,
              got, P, N, C, K, run_len);
        } else if (skip) {
          match_form_kernel<R, true, false><<<g, THREADS, sb>>>(
              in.req, in.cons, in.total, in.reserved, in.attrs, in.active,
              got, P, N, C, K, run_len);
        } else {
          return launch<R>(in.req, in.cons, in.total, in.reserved, in.attrs,
                           in.active, got, B, P, N, C, K, 0, run_len);
        }
        return cudaGetLastError();
      };
    };
    std::vector<Form> forms = {
        {"16-byte streaming stores, 64-task runs (shipped)", lib(got),
         false},
        {"16-byte streaming stores, 16-task runs", form(16, false, false),
         false},
        {"16-byte streaming stores, 32-task runs", form(32, false, false),
         false},
        {"16-byte streaming stores, 128-task runs", form(128, false, false),
         false},
        {"divides only for feasible pairs, 64-task runs",
         form(64, true, false), false},
        {"TMA tile stores (4-task groups, double-buffered), 64-task runs",
         [=, &map]() {
           match_tma_kernel<R, RUN_P><<<tma_grid, THREADS, tma_smem>>>(
               in.req, in.cons, in.total, in.reserved, in.attrs, in.active,
               map, P, N, C, K);
           return cudaGetLastError();
         }, false},
        {"stores only (diagnostic: a constant, no scores)",
         form(64, false, true), true},
        {"cudaMemsetAsync of the output (diagnostic: the write floor)",
         [=]() { return cudaMemsetAsync(got, 0, (size_t)B * P * N * 4); },
         true},
    };
    for (size_t f = 0; f < forms.size(); ++f) {
      CK(cudaMemset(got, 0, (size_t)B * P * N * 4));
      CK(forms[f].fn());
      CK(cudaDeviceSynchronize());
      CK(cudaMemcpy(h_got.data(), got, (size_t)B * P * N * 4,
                    cudaMemcpyDeviceToHost));
      const bool same = forms[f].diagnostic ||
          memcmp(h_got.data(), h_want.data(), (size_t)B * P * N * 4) == 0;
      const float ms = time_ms(forms[f].fn, flush, flush_bytes);
      printf("match_store B=%d %-64s %.4f ms, bitwise %s\n", B,
             forms[f].name, ms,
             forms[f].diagnostic ? "(not compared)" : same ? "yes" : "NO");
      char buf[256];
      snprintf(buf, sizeof buf,
               "%s{\"lanes\": %d, \"form\": \"%s\", \"ms\": %.5f, "
               "\"bitwise\": %s}",
               (B == 1 && f == 0) ? "" : ", ", B, forms[f].name, ms,
               forms[f].diagnostic ? "null" : same ? "true" : "false");
      json += buf;
      if (!same) return 2;
    }
  }
  printf("%s]}\n", json.c_str());
  return 0;
}
