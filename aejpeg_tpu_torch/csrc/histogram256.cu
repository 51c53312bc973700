// Exact 256-bin histograms of int32 rows: (rows, n) -> (rows, 256) int32.
//
// Replaces the Pallas TPU kernel aejpeg_tpu/ops/pallas_kernels.py
// histogram256 (_hist_kernel).  The TPU had no fast scatter, so that kernel
// counted with radix-16 one-hot outer products on the MXU; Hopper has fast
// shared-memory atomics, so this is the plain formulation.
//
// Bound on the H100: bytes.  Each value is read once (4 bytes) and needs
// one shared-memory atomic; the 256 counts per row are negligible.  The
// design keeps the read coalesced and 16 bytes per thread (int4 loads when
// the row is 16-byte aligned), gives each warp its own 256-bin copy in
// shared memory so atomics contend only inside a warp, and merges the
// copies once per row.  One CTA per row: the codec's rows are 6K-49K
// values, so a row fills a CTA for a few iterations and the grid
// (hundreds to thousands of rows) fills the 132 SMs.
//
// Values outside [0, 255] (the callers' -1 padding) are not counted.
// Counts are integers, so the result equals the plain PyTorch version
// bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void count(int* bins, int v) {
  if (static_cast<unsigned>(v) < 256u) atomicAdd(bins + v, 1);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const int* __restrict__ vals, int* __restrict__ out,
               long long n) {
  __shared__ int sh[kWarps * 256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) sh[i] = 0;
  __syncthreads();

  const long long row = blockIdx.x;
  const int* v = vals + row * n;
  int* bins = sh + (threadIdx.x / 32) * 256;
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  if (vec) {
    const int4* v4 = reinterpret_cast<const int4*>(v);
    const long long n4 = n / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const int4 q = __ldg(v4 + i);
      count(bins, q.x);
      count(bins, q.y);
      count(bins, q.z);
      count(bins, q.w);
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      count(bins, __ldg(v + i));
    }
  }
  __syncthreads();

  // kThreads == 256: thread t owns bin t of the merged histogram
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w * 256 + threadIdx.x];
  out[row * 256 + threadIdx.x] = s;
}

}  // namespace

extern "C" int aej_histogram256(const void* vals, void* out, long long rows,
                                long long n, void* stream) {
  if (rows > 0) {
    hist256_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(vals), static_cast<int*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
