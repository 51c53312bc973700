// One dense resize axis, summed in the order XLA's CPU dot sums the
// reference's einsum (aejpeg_tpu/ops/resize.py resize2d, the two
// jnp.einsum calls).
//
// The reference has no Pallas kernel here: on the TPU the einsums are MXU
// matmuls.  The port needs the bits that jax.jit gives on the CPU, where
// XLA hands each einsum's 2-D dot to YNNPACK.  Its kernel keeps `lanes`
// partial sums per output (one per k modulo lanes, each a chain of FMAs
// from zero) and adds them as a tree, per k-block, adding the blocks in
// order; then it adds the tree of the products of the k past the last
// multiple of lanes.  The code runs with FTZ and DAZ.  The resize
// weights are banded, so only the few non-zero taps of each output take
// part: ops/resize.py lays them out per output as
//   [block][lane][step] chain slots, then [block][lane] tail slots,
// with idx -1 where a slot is empty.  The plain version,
// ops/kernels.py banded_resize_plain, runs the same steps; every FMA is
// __fmaf_rn (one rounding, as fma32_exact) and every add __fadd_rn, so the
// two agree bit for bit.  Subnormal inputs read as zero and subnormal
// results are flushed to a zero of their sign, as XLA's MXCSR does.
//
// One thread per output element.  axis 1 resizes the rows of a (P, H, W)
// tensor: neighbouring threads take neighbouring columns, so each tap's
// load is coalesced.  axis 2 resizes the columns: a thread's taps are
// neighbouring words of one row.  Bound on the H100: bytes (each input
// element is read about taps/scale times from L2, each output written
// once); the work is a few FMAs per output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 4;

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float lane_tree(const float* v, int lanes) {
  if (lanes == 1) return v[0];
  if (lanes == 2) return ftz(__fadd_rn(v[0], v[1]));
  return ftz(__fadd_rn(ftz(__fadd_rn(v[0], v[1])),
                       ftz(__fadd_rn(v[2], v[3]))));
}

__global__ void __launch_bounds__(kThreads)
banded_resize_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const int* __restrict__ idx,
                     const float* __restrict__ wt, int p, int h, int w,
                     int dst, int axis, int blocks, int lanes, int steps,
                     int slots) {
  const long long n = axis == 1 ? (long long)p * dst * w
                                : (long long)p * h * dst;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n; e += (long long)gridDim.x * blockDim.x) {
    int o;
    long long base, stride;
    if (axis == 1) {                 // out (P, dst, W)
      const int col = (int)(e % w);
      o = (int)((e / w) % dst);
      const long long pl = e / ((long long)w * dst);
      base = pl * h * w + col;
      stride = w;
    } else {                         // out (P, H, dst)
      o = (int)(e % dst);
      const long long row = e / dst;
      base = row * w;
      stride = 1;
    }
    const int* oi = idx + (long long)o * slots;
    const float* ow = wt + (long long)o * slots;
    const int width = lanes * steps + lanes;
    float acc = 0.0f;
    float tail_sum = 0.0f;
    bool any_tail = false;
    for (int j = 0; j < blocks; ++j) {
      const int* bi = oi + j * width;
      const float* bw = ow + j * width;
      bool used = false;
      float lane[kMaxLanes];
      for (int c = 0; c < lanes; ++c) {
        float a = 0.0f;
        for (int s = 0; s < steps; ++s) {
          const int k = bi[c * steps + s];
          if (k >= 0) {
            a = ftz(__fmaf_rn(ftz(x[base + k * stride]), bw[c * steps + s],
                              a));
            used = true;
          }
        }
        lane[c] = a;
      }
      const float blk = lane_tree(lane, lanes);
      if (j == 0) {
        acc = blk;
      } else if (used) {
        acc = ftz(__fadd_rn(acc, blk));
      }
      float tail[kMaxLanes];
      bool block_tail = false;
      for (int t = 0; t < lanes; ++t) {
        const int k = bi[lanes * steps + t];
        tail[t] = 0.0f;
        if (k >= 0) {
          tail[t] = ftz(__fmul_rn(ftz(x[base + k * stride]),
                                  bw[lanes * steps + t]));
          block_tail = true;
        }
      }
      if (block_tail) {
        tail_sum = lane_tree(tail, lanes);
        any_tail = true;
      }
    }
    if (any_tail) acc = ftz(__fadd_rn(acc, tail_sum));
    out[e] = acc;
  }
}

}  // namespace

extern "C" int aej_banded_resize(const float* x, float* out, const int* idx,
                                 const float* wt, int p, int h, int w,
                                 int dst, int axis, int blocks, int lanes,
                                 int steps, int slots, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes || lanes == 3) return -1;
  const long long n = axis == 1 ? (long long)p * dst * w
                                : (long long)p * h * dst;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 132LL * 32) grid = 132LL * 32;
  if (grid < 1) grid = 1;
  banded_resize_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
      x, out, idx, wt, p, h, w, dst, axis, blocks, lanes, steps, slots);
  return (int)cudaGetLastError();
}
