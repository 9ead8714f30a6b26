// scan_sweep: the commit scan of csrc/commit_scan.cuh (kernels B and D) in
// other shapes than the kernels use (threads a block, register nodes a
// thread, tasks loaded ahead) at cell A's sizes, each checked bitwise
// against the first; plus the raw cost of a cluster barrier (releasing or
// relaxed arrive) and of __syncthreads. On a machine with the card, from
// the repository root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 --fmad=false \
//     -I src/repro_torch/csrc src/repro_torch/bench/scan_sweep.cu \
//     -o build/scan_sweep -ldl && build/scan_sweep
//
// Each scan line: the median of 5 timed launches (CUDA events, after 2
// warm-up launches; the operands stay in L2 between launches), the time a
// task, the clusters the occupancy query says can be resident, and
// whether node_of and the tally equal the first variant's.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "commit_scan.cuh"

using namespace commit_scan;

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

struct RowPref {
  const float* pref;
  int N;
  __device__ __forceinline__ float operator()(int p, int n) const {
    return pref[(size_t)p * N + n];
  }
};

template <int NT, int NREG, int DP>
__global__ void __launch_bounds__(NT, 1) sweep_scan(
    const float* pref, const float* req, const unsigned char* ok,
    const unsigned char* valid, const float* total, const float* denom,
    int* node_of, float* tally, int P, int N, int R, int dyn, int C) {
  const size_t b = blockIdx.x / C;
  scan<NT, NREG, DP>(RowPref{pref + b * P * N, N}, req + b * P * R,
                     ok + b * P * N, valid + b * P, total + b * N * R,
                     denom + b * N * R, node_of + b * P, tally + b * N * R,
                     P, N, R, dyn != 0, C);
}

template <int NT, bool RELAXED>
__global__ void __launch_bounds__(NT, 1) sweep_barrier(int iters, int* out) {
  for (int i = 0; i < iters; ++i) {
    if (RELAXED) {
      asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    } else {
      cluster_sync();
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = iters;
}

template <int NT>
__global__ void __launch_bounds__(NT, 1) sweep_sync(int iters, int* out) {
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = iters;
}

// The scan's operands on grid data (multiples of 1/128), lane-major.
struct Data {
  int B, P, N, R;
  float *pref, *req, *total, *denom, *res0;
  unsigned char *ok, *valid;
};

template <class T>
T* upload(const std::vector<T>& h) {
  T* d;
  CK(cudaMalloc(&d, h.size() * sizeof(T)));
  CK(cudaMemcpy(d, h.data(), h.size() * sizeof(T), cudaMemcpyHostToDevice));
  return d;
}

Data make(int B, int P, int N, int R, unsigned seed) {
  std::mt19937 g(seed);
  auto grid = [&](int lo, int hi) {
    return (float)(lo + (int)(g() % (unsigned)(hi - lo))) / 128.0f;
  };
  const size_t pn = (size_t)B * P * N, nr = (size_t)B * N * R;
  std::vector<float> pref(pn), req((size_t)B * P * R), total(nr), res0(nr);
  std::vector<unsigned char> ok(pn), valid((size_t)B * P);
  for (auto& x : pref) x = grid(-256, 0);
  for (auto& x : req) x = grid(1, 48);
  for (size_t i = 0; i < nr; ++i) {
    total[i] = grid(64, 256);
    res0[i] = grid(0, 64);
  }
  for (auto& x : ok) x = (g() % 100) < 70;
  for (auto& x : valid) x = (g() % 100) < 90;
  Data d{B, P, N, R};
  d.pref = upload(pref);
  d.req = upload(req);
  d.total = upload(total);
  d.denom = upload(total);
  d.res0 = upload(res0);
  d.ok = upload(ok);
  d.valid = upload(valid);
  return d;
}

template <int NT, int NREG, int DP>
void run(const char* name, const Data& d, int C, int dyn,
         std::vector<int>* ref_n, std::vector<float>* ref_t) {
  auto kern = sweep_scan<NT, NREG, DP>;
  CK(cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t occ = cluster_config(1, C, attr, 0, NT);
  int active = 0;
  CK(cudaOccupancyMaxActiveClusters(&active, kern, &occ));
  const size_t n_tally = (size_t)d.B * d.N * d.R;
  int* node_of;
  float* tally;
  CK(cudaMalloc(&node_of, (size_t)d.B * d.P * sizeof(int)));
  CK(cudaMalloc(&tally, n_tally * sizeof(float)));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> times;
  for (int rep = 0; rep < 7; ++rep) {
    CK(cudaMemcpy(tally, d.res0, n_tally * sizeof(float),
                  cudaMemcpyDeviceToDevice));
    cudaEventRecord(e0);
    CK(launch_clusters(kern, d.B, C, NT, (cudaStream_t)0,
                       (const float*)d.pref, (const float*)d.req,
                       (const unsigned char*)d.ok,
                       (const unsigned char*)d.valid, (const float*)d.total,
                       (const float*)d.denom, node_of, tally, d.P, d.N, d.R,
                       dyn, C));
    cudaEventRecord(e1);
    CK(cudaEventSynchronize(e1));
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (rep >= 2) times.push_back(ms);
  }
  std::sort(times.begin(), times.end());
  const float med = times[times.size() / 2];
  std::vector<int> hn((size_t)d.B * d.P);
  std::vector<float> ht(n_tally);
  CK(cudaMemcpy(hn.data(), node_of, hn.size() * sizeof(int),
                cudaMemcpyDeviceToHost));
  CK(cudaMemcpy(ht.data(), tally, ht.size() * sizeof(float),
                cudaMemcpyDeviceToHost));
  const char* same = "first";
  if (ref_n->empty()) {
    *ref_n = hn;
    *ref_t = ht;
  } else {
    same = hn == *ref_n &&
                   memcmp(ht.data(), ref_t->data(), n_tally * 4) == 0
               ? "bitwise equal"
               : "DIFFERENT";
  }
  int placed = 0;
  for (int x : hn) placed += x >= 0;
  printf("scan %-26s B=%d P=%4d N=%6d dyn=%d C=%2d resident clusters %2d: "
         "%.4f ms (%.3f us a task), placed %d, %s\n",
         name, d.B, d.P, d.N, dyn, C, active, med, med * 1e3 / d.P, placed,
         same);
  cudaFree(node_of);
  cudaFree(tally);
}

template <int NT, bool RELAXED>
void barrier(int C) {
  auto kern = sweep_barrier<NT, RELAXED>;
  CK(cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  int* out;
  CK(cudaMalloc(&out, 64 * sizeof(int)));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 20000;
  CK(launch_clusters(kern, 1, C, NT, (cudaStream_t)0, 100, out));
  cudaEventRecord(e0);
  CK(launch_clusters(kern, 1, C, NT, (cudaStream_t)0, iters, out));
  cudaEventRecord(e1);
  CK(cudaEventSynchronize(e1));
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("cluster barrier, %4d threads a block, C=%2d, %s arrive: %.1f ns\n",
         NT, C, RELAXED ? "relaxed" : "releasing", ms * 1e6 / iters);
  cudaFree(out);
}

template <int NT>
void sync_cost() {
  int* out;
  CK(cudaMalloc(&out, sizeof(int)));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 20000;
  sweep_sync<NT><<<1, NT>>>(100, out);
  cudaEventRecord(e0);
  sweep_sync<NT><<<1, NT>>>(iters, out);
  cudaEventRecord(e1);
  CK(cudaEventSynchronize(e1));
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("__syncthreads, %4d threads: %.1f ns\n", NT, ms * 1e6 / iters);
  cudaFree(out);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, 0));
  printf("device: %s\n", prop.name);
  for (int C : {8, 16}) {
    barrier<1024, false>(C);
    barrier<1024, true>(C);
    barrier<512, false>(C);
    barrier<512, true>(C);
  }
  sync_cost<1024>();
  sync_cost<512>();
  sync_cost<256>();
  struct Case {
    int B, P, N, dyn, C;
  };
  // cell A's main path (B=1, C=16) and fleet (B=8, C=8), dynamic and
  // static; 150,000 nodes (memory-held nodes); 16 nodes (the floor)
  const Case cases[] = {{1, 1024, 12500, 1, 16}, {1, 1024, 12500, 0, 16},
                        {8, 1024, 12500, 1, 8},  {8, 1024, 12500, 0, 8},
                        {1, 64, 150000, 1, 16},  {1, 1024, 16, 1, 16}};
  for (const Case& c : cases) {
    Data d = make(c.B, c.P, c.N, 3, 7 + c.B + c.N);
    std::vector<int> rn;
    std::vector<float> rt;
    run<512, 4, 2>("512 threads x 4, ahead 2", d, c.C, c.dyn, &rn, &rt);
    run<512, 4, 1>("512 threads x 4, ahead 1", d, c.C, c.dyn, &rn, &rt);
    run<1024, 1, 1>("1024 threads x 1, ahead 1", d, c.C, c.dyn, &rn, &rt);
    run<1024, 1, 2>("1024 threads x 1, ahead 2", d, c.C, c.dyn, &rn, &rt);
    run<512, 2, 2>("512 threads x 2, ahead 2", d, c.C, c.dyn, &rn, &rt);
    run<256, 4, 2>("256 threads x 4, ahead 2", d, c.C, c.dyn, &rn, &rt);
    run<256, 8, 2>("256 threads x 8, ahead 2", d, c.C, c.dyn, &rn, &rt);
  }
  return 0;
}
