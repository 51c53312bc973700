// CLAHE LUT application: the bilinear blend of the four neighbouring tile
// LUTs at every pixel, before rounding.  Two kernels, batched over planes.
//
// aej_clahe_gather replaces the Pallas TPU kernel
// aejpeg_tpu/ops/pallas_kernels.py clahe_apply_gather (_clahe_gather_kernel).
// The 4 tile-column LUTs of each tile row are packed into int32 words (one
// byte per column).  Per pixel: read the words of the clamped top and
// bottom tile rows at the pixel value, extract the TL/TR/BL/BR bytes at
// the per-column shifts, and blend with OpenCV's association
//     (TL*xa1 + TR*xa)*ya1 + (BL*xa1 + BR*xa)*ya.
// The TPU banded the image by half tiles so its BlockSpec index maps could
// pick the two word rows; here each thread computes its tile rows from its
// own y.  Bound on the H100: bytes (a 4-byte pixel in, a 4-byte result
// out, ~20 integer operations and 3 float64 multiply-adds).  The plane's gh x 256 words (4 KB
// for the 4x4 grid) sit in shared memory, so the per-pixel lookups never
// touch device memory; reads and writes are coalesced along x.
//
// aej_clahe_lut_apply replaces clahe_lut_apply (_lut_apply_kernel), the
// fallback for shapes the gather cannot band.  The TPU built a one-hot
// (pixels, 256) matrix and multiplied it by the (256, 16) LUT matrix on
// the MXU; here each pixel gathers its 4 nonzero taps directly and never
// reads a 16-wide weight row.  Bound: bytes (pixel, 4 tap weights, result).
//
// Rounding.  The JAX reference, as XLA compiles it for the CPU, rounds each
// `a*b + c` of these blends once (an FMA whose first product is fused),
// and sums the fallback's taps as acc = fma(w, lut, acc).  Both kernels
// compute those FMAs as round_f32(f64(a) * f64(b) + f64(c)) (the product
// of two floats is exact in f64), the same formula as the plain PyTorch
// versions (ops/rounding.py), and every other product is a separate
// __fmul_rn, so nvcc contracts nothing and kernel and plain version agree
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 16;

__device__ __forceinline__ int clamp_u8(int v) {
  return min(max(v, 0), 255);
}

// round_f32(a*b + c) with a*b exact: ops/rounding.py fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

__global__ void __launch_bounds__(kThreads)
clahe_gather_kernel(const int* __restrict__ img, const int* __restrict__ words,
                    const int* __restrict__ ix0, const int* __restrict__ ix1,
                    const float* __restrict__ xa, const float* __restrict__ xa1,
                    const float* __restrict__ ya, const float* __restrict__ ya1,
                    float* __restrict__ out, int h, int w, int gh, int bh) {
  extern __shared__ int sw[];  // gh * 256 packed words of this plane
  const int p = blockIdx.y;
  const int* wp = words + static_cast<long long>(p) * gh * 256;
  for (int i = threadIdx.x; i < gh * 256; i += kThreads) sw[i] = wp[i];
  __syncthreads();

  const long long hw = static_cast<long long>(h) * w;
  const int* ip = img + p * hw;
  float* op = out + p * hw;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < hw; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int y = static_cast<int>(i / w);
    const int x = static_cast<int>(i - static_cast<long long>(y) * w);
    const int v = clamp_u8(__ldg(ip + i));
    const int k = y / bh;  // half-tile band
    const int top = max(k - 1, 0) / 2;
    const int bot = min((k + 1) / 2, gh - 1);
    const int wt = sw[top * 256 + v];
    const int wb = sw[bot * 256 + v];
    const int s0 = __ldg(ix0 + x) * 8;
    const int s1 = __ldg(ix1 + x) * 8;
    const float tl = static_cast<float>((wt >> s0) & 255);
    const float tr = static_cast<float>((wt >> s1) & 255);
    const float bl = static_cast<float>((wb >> s0) & 255);
    const float br = static_cast<float>((wb >> s1) & 255);
    const float fxa = __ldg(xa + x);
    const float fxa1 = __ldg(xa1 + x);
    const float t = fma32(tl, fxa1, __fmul_rn(tr, fxa));
    const float b = fma32(bl, fxa1, __fmul_rn(br, fxa));
    op[i] = fma32(t, __ldg(ya1 + y), __fmul_rn(b, __ldg(ya + y)));
  }
}

__global__ void __launch_bounds__(kThreads)
clahe_lut_apply_kernel(const int* __restrict__ img,
                       const float* __restrict__ lut,
                       const int* __restrict__ iy, const int* __restrict__ ix,
                       const float* __restrict__ wts, float* __restrict__ out,
                       int h, int w, int n_tiles, int gw) {
  const int p = blockIdx.y;
  const long long hw = static_cast<long long>(h) * w;
  const int* ip = img + p * hw;
  const float* lp = lut + static_cast<long long>(p) * n_tiles * 256;
  float* op = out + p * hw;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < hw; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int y = static_cast<int>(i / w);
    const int x = static_cast<int>(i - static_cast<long long>(y) * w);
    const int v = clamp_u8(__ldg(ip + i));
    const float4 wq = __ldg(reinterpret_cast<const float4*>(wts) + i);
    const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        int t = __ldg(iy + 2 * y + a) * gw + __ldg(ix + 2 * x + b);
        t = min(max(t, 0), n_tiles - 1);
        acc = fma32(wv[2 * a + b], __ldg(lp + t * 256 + v), acc);
      }
    }
    op[i] = acc;
  }
}

unsigned grid_x(long long hw) {
  const long long per_block = static_cast<long long>(kThreads) * kPixelsPerThread;
  long long g = (hw + per_block - 1) / per_block;
  return static_cast<unsigned>(g < 1 ? 1 : g);
}

}  // namespace

extern "C" int aej_clahe_gather(const void* img, const void* words,
                                const void* ix0, const void* ix1,
                                const void* xa, const void* xa1,
                                const void* ya, const void* ya1, void* out,
                                int planes, int h, int w, int gh, int th,
                                void* stream) {
  if (planes > 0 && h > 0 && w > 0) {
    const dim3 grid(grid_x(static_cast<long long>(h) * w), planes);
    const size_t smem = static_cast<size_t>(gh) * 256 * sizeof(int);
    clahe_gather_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(img), static_cast<const int*>(words),
        static_cast<const int*>(ix0), static_cast<const int*>(ix1),
        static_cast<const float*>(xa), static_cast<const float*>(xa1),
        static_cast<const float*>(ya), static_cast<const float*>(ya1),
        static_cast<float*>(out), h, w, gh, th / 2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aej_clahe_lut_apply(const void* img, const void* lut,
                                   const void* iy, const void* ix,
                                   const void* wts, void* out, int planes,
                                   int h, int w, int n_tiles, int gw,
                                   void* stream) {
  if (planes > 0 && h > 0 && w > 0) {
    const dim3 grid(grid_x(static_cast<long long>(h) * w), planes);
    clahe_lut_apply_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(img), static_cast<const float*>(lut),
        static_cast<const int*>(iy), static_cast<const int*>(ix),
        static_cast<const float*>(wts), static_cast<float*>(out), h, w,
        n_tiles, gw);
  }
  return static_cast<int>(cudaGetLastError());
}
