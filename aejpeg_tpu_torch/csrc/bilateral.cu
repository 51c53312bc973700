// OpenCV's bilateral filter on uint8 planes, bit for bit with the JAX
// package's bilateral_u8 (aejpeg_tpu/ops/canny.py:221-257) as XLA compiles
// it for the CPU, and with the plain version, ops/kernels.py
// bilateral_plain.
//
// The reference has no Pallas kernel here: on the TPU the 13-tap loop is
// elementwise code that XLA fuses.  The port's plain version runs it as
// about 300 eager launches, float64 among them; this kernel runs it in
// one.  Per pixel, over the taps of the disk in order, with per-tap colour
// weights w = f32(s_w * XLA's exp(f32(d * d) * cc)) read from a (taps,
// 256) table by |d| (ops/canny.py builds it): the numerator starts as
// fma(w0, nb0, w1 * nb1) (LLVM fuses the first product of that add) and
// takes each further tap as fma(w, nb, num); the denominator adds the
// weights; the result is floor(num / den + 0.5) clamped to [0, 255].
// __fmaf_rn gives the plain version's fma32 (a float64 product and sum,
// rounded once to float32) because that float64 sum is exact here: every
// nonzero w is at least 2**-17 (ops/canny.py checks) with 24 significant
// bits, nb an integer below 256 and num below 2**13, so the sum spans
// under 53 bits and both round the same exact value once.
//
// Bound on the H100: FP32 operations (3 a tap per pixel) and bytes (about
// 2 a pixel) are close.  Persistent blocks, as many as the card holds at
// once, stage the weights in shared memory once (staged per 256-pixel tile
// they cost 52 bytes a pixel at 13 taps), then tile after tile an
// (8 + 2r) x (32 + 2r) window of the padded plane, a thread an output
// pixel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32, kBY = 8;
constexpr int kTapsMax = 29;     // the disk of radius 3
constexpr int kRadiusMax = 3;

__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(const uint8_t* __restrict__ padded,
                 uint8_t* __restrict__ out, const float* __restrict__ wtab,
                 const int* __restrict__ offs, int p, int taps, int radius,
                 int h, int w) {
  extern __shared__ float sm[];  // [weights (taps, 256)][window bytes]
  __shared__ int s_off[kTapsMax];
  float* w_sm = sm;
  uint8_t* win = reinterpret_cast<uint8_t*>(sm + taps * 256);
  const int ww = kBX + 2 * radius, wh = kBY + 2 * radius;
  const int t = threadIdx.y * kBX + threadIdx.x;
  for (int i = t; i < taps * 256; i += kBX * kBY) w_sm[i] = wtab[i];
  for (int i = t; i < taps; i += kBX * kBY)
    s_off[i] = (offs[2 * i] + radius) * ww + offs[2 * i + 1] + radius;
  const int ph = h + 2 * radius, pw = w + 2 * radius;
  const int tiles_x = (w + kBX - 1) / kBX, tiles_y = (h + kBY - 1) / kBY;
  const long long tiles = (long long)p * tiles_y * tiles_x;
  // persistent blocks: the weights staged once, then tile after tile
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int plane = (int)(tile / ((long long)tiles_y * tiles_x));
    const int rest = (int)(tile % ((long long)tiles_y * tiles_x));
    const int x0 = rest % tiles_x * kBX, y0 = rest / tiles_x * kBY;
    const uint8_t* src = padded + (long long)plane * ph * pw;
    __syncthreads();                    // the last tile's window is read
    for (int i = t; i < wh * ww; i += kBX * kBY) {
      const int yy = y0 + i / ww, xx = x0 + i % ww;
      win[i] = yy < ph && xx < pw ? src[(long long)yy * pw + xx] : 0;
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= w || y >= h) continue;
    const uint8_t* c = win + threadIdx.y * ww + threadIdx.x;
    const int center = c[radius * ww + radius];
    const int v0 = c[s_off[0]];
    const float w0 = w_sm[abs(v0 - center)];
    float num, den;
    if (taps == 1) {
      num = __fmul_rn(w0, (float)v0);
      den = w0;
    } else {
      const int v1 = c[s_off[1]];
      const float w1 = w_sm[256 + abs(v1 - center)];
      num = __fmaf_rn(w0, (float)v0, __fmul_rn(w1, (float)v1));
      den = __fadd_rn(w0, w1);
    }
    for (int i = 2; i < taps; ++i) {
      const int v = c[s_off[i]];
      const float wt = w_sm[i * 256 + abs(v - center)];
      num = __fmaf_rn(wt, (float)v, num);
      den = __fadd_rn(den, wt);
    }
    const float r = floorf(__fadd_rn(__fdiv_rn(num, den), 0.5f));
    out[((long long)plane * h + y) * w + x] =
        (uint8_t)fminf(fmaxf(r, 0.0f), 255.0f);
  }
}

}  // namespace

// padded: (p, h + 2 radius, w + 2 radius) uint8, BORDER_REFLECT_101;
// wtab: (taps, 256) float32; offs: (taps, 2) int32 (dy, dx) -> out (p, h, w).
extern "C" int aej_bilateral(const uint8_t* padded, uint8_t* out,
                             const float* wtab, const int* offs, int p, int h,
                             int w, int taps, int radius, void* stream) {
  if (taps < 1 || taps > kTapsMax || radius < 0 || radius > kRadiusMax
      || h < 1 || w < 1)
    return -1;
  const int ww = kBX + 2 * radius, wh = kBY + 2 * radius;
  const int bytes = taps * 256 * 4 + (wh * ww + 3) / 4 * 4;
  const long long tiles = (long long)p * ((h + kBY - 1) / kBY)
                          * ((w + kBX - 1) / kBX);
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bilateral_kernel, kBX * kBY, bytes);
  if (err) return err;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(tiles < most ? tiles : most);
  bilateral_kernel<<<grid, dim3(kBX, kBY), bytes, (cudaStream_t)stream>>>(
      padded, out, wtab, offs, p, taps, radius, h, w);
  return (int)cudaGetLastError();
}
