// CLAHE LUT application: the bilinear blend of the four neighbouring tile
// LUTs at every pixel, before rounding.  Two kernels, batched over planes,
// both reading the (P, H, W) uint8 planes the caller already holds.
//
// aej_clahe_gather replaces the Pallas TPU kernel
// aejpeg_tpu/ops/pallas_kernels.py clahe_apply_gather (_clahe_gather_kernel).
// The 4 tile-column LUTs of each tile row are packed into int32 words (one
// byte per column).  Per pixel: read the words of the clamped top and
// bottom tile rows at the pixel value, extract the TL/TR/BL/BR bytes of the
// column's two tile columns, and blend with OpenCV's association
//     (TL*xa1 + TR*xa)*ya1 + (BL*xa1 + BR*xa)*ya.
// The TPU banded the image by half tiles so its BlockSpec index maps could
// pick the two word rows.  Here a CTA of 4 warps owns a 128-column strip
// and a band of 64 rows of one plane; each warp walks every 4th row of the
// band.  A lane owns 4 consecutive columns, so each warp-wide 4-byte pixel
// load and float4 store covers 128 contiguous pixels.  Per column (held in
// registers for the whole band): the byte selectors of the two tile
// columns and xa/xa1.  Per row (once per warp): the half-tile band y / bh,
// the two word rows, ya and ya1.  No per-pixel division and no 64-bit
// index arithmetic.  The plane's gh x 256 words (4 KB for the 4x4 grid)
// sit in shared memory; the lookups at the pixel value are a gather.
// Bound on the H100: bytes (a 1-byte pixel in, a 4-byte result out).
// Measured on the H100 (tools/probe_clahe_apply.py and this file's
// earlier revisions): 4 columns a lane (48 registers) beat 8 and 16 (64
// and 118 registers, fewer warps in flight); loading the next row ahead
// made it slower; lookups without bank conflicts took the same time.
//
// aej_clahe_lut_apply replaces clahe_lut_apply (_lut_apply_kernel), the
// fallback for shapes the gather cannot band.  The TPU built a one-hot
// (pixels, 256) matrix and multiplied it by the (256, 16) LUT matrix on
// the MXU; here each pixel gathers its 4 nonzero taps directly.  A CTA
// owns a 32-column x 16-row block of one plane (8 warps, 2 rows a thread),
// so the small planes this path serves still spread over every SM.  It
// reads its rows' tile rows iy and its columns' tile columns ix once into
// shared memory, stages only the tiles those span (2 x 2 x 1 KB when the
// block lies inside one tile cell) and reads the four taps from there.
// Bound: bytes (pixel, 4 tap weights, result); in practice the launch.
//
// Rounding.  The JAX reference, as XLA compiles it for the CPU, rounds each
// `a*b + c` of these blends once (an FMA whose first product is fused),
// and sums the fallback's taps as acc = fma(w, lut, acc).  The plain
// PyTorch versions (ops/rounding.py fma32) compute those FMAs as
// round_f32(f64(a) * f64(b) + f64(c)); the product of two floats is exact
// in float64.  A hardware __fmaf_rn equals that wherever the float64 sum
// is exact too.  For the gather's two inner blends it is: TL..BR are
// integers in 0..255 and xa, xa1 nonzero values >= 1/(2 tw), so every
// operand is a multiple of 2^-(23 + 1 + log2 tw) below a sum < 2^9, which
// fits float64's 53 bits for any tw < 2^20
// (tests/test_torch_kernels.py::test_inner_blend_fma_is_exact checks it
// exhaustively with TwoSum at the main path's widths).  The gather's outer
// blend and the fallback's four taps have no such test, so they keep the
// float64 formula (__fma_rn on doubles: the exact product plus c, rounded
// once to double, then to float).  Every other product is a separate
// __fmul_rn, so nvcc contracts nothing and kernel and plain version agree
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- gather
constexpr int kGatherWarps = 4;
constexpr int kGatherStrip = 32 * 4;                    // 4 columns a lane
constexpr int kGatherBand = 64;                         // rows per CTA

// float(byte `sel & 3` of word): the byte under the exponent of 2^23,
// minus 2^23 (exact).  sel = 0x7540 | byte index.
__device__ __forceinline__ float byte_to_float(int word, unsigned sel) {
  return __int_as_float(static_cast<int>(__byte_perm(word, 0x4B000000, sel)))
         - 8388608.0f;
}

__device__ __forceinline__ float gather_blend(const int* sw, int top, int bot,
                                              int v, unsigned s0, unsigned s1,
                                              float xa, float xa1, float ya,
                                              double ya1) {
  const int wt = sw[top + v];
  const int wb = sw[bot + v];
  // exact sums (see Rounding above): the hardware FMA is fma32
  const float t = __fmaf_rn(byte_to_float(wt, s0), xa1,
                            __fmul_rn(byte_to_float(wt, s1), xa));
  const float b = __fmaf_rn(byte_to_float(wb, s0), xa1,
                            __fmul_rn(byte_to_float(wb, s1), xa));
  return __double2float_rn(__fma_rn(static_cast<double>(t), ya1,
                                    static_cast<double>(__fmul_rn(b, ya))));
}

// The 4 pixels at p (n >= 1 of them inside the row; 0 past its end).
__device__ __forceinline__ uchar4 load4(const uint8_t* p, int n, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uchar4*>(p));
  uchar4 q = make_uchar4(__ldg(p), 0, 0, 0);
  if (n > 1) q.y = __ldg(p + 1);
  if (n > 2) q.z = __ldg(p + 2);
  if (n > 3) q.w = __ldg(p + 3);
  return q;
}

__global__ void __launch_bounds__(32 * kGatherWarps)
clahe_gather_kernel(const uint8_t* __restrict__ img,
                    const int* __restrict__ words,
                    const int* __restrict__ ix0, const int* __restrict__ ix1,
                    const float* __restrict__ xa,
                    const float* __restrict__ xa1,
                    const float* __restrict__ ya,
                    const float* __restrict__ ya1, float* __restrict__ out,
                    int h, int w, int gh, int bh, int vec) {
  extern __shared__ int sw[];  // gh * 256 packed words of this plane
  const int p = blockIdx.z;
  const int* wp = words + static_cast<size_t>(p) * gh * 256;
  for (int i = threadIdx.y * 32 + threadIdx.x; i < gh * 256;
       i += 32 * kGatherWarps) {
    sw[i] = __ldg(wp + i);
  }

  const int c = blockIdx.x * kGatherStrip + threadIdx.x * 4;
  const int n = w - c;  // columns of this lane's 4 inside the row
  unsigned s0[4], s1[4];
  float fxa[4], fxa1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = j < n;
    s0[j] = 0x7540u | static_cast<unsigned>(in ? __ldg(ix0 + c + j) : 0);
    s1[j] = 0x7540u | static_cast<unsigned>(in ? __ldg(ix1 + c + j) : 0);
    fxa[j] = in ? __ldg(xa + c + j) : 0.0f;
    fxa1[j] = in ? __ldg(xa1 + c + j) : 0.0f;
  }
  __syncthreads();
  const int y_end = min(h, static_cast<int>(blockIdx.y + 1) * kGatherBand);
  int y = blockIdx.y * kGatherBand + threadIdx.y;
  if (n <= 0 || y >= y_end) return;

  const size_t plane = static_cast<size_t>(p) * h * w;
  const uint8_t* ip = img + plane + c;
  float* op = out + plane + c;
  for (; y < y_end; y += kGatherWarps) {
    const uchar4 q = load4(ip + static_cast<size_t>(y) * w, n, vec);
    const int k = y / bh;  // half-tile band
    const int top = max(k - 1, 0) / 2 * 256;
    const int bot = min((k + 1) / 2, gh - 1) * 256;
    const float fya = __ldg(ya + y);
    const double dya1 = static_cast<double>(__ldg(ya1 + y));
    float4 r;
    r.x = gather_blend(sw, top, bot, q.x, s0[0], s1[0], fxa[0], fxa1[0],
                       fya, dya1);
    r.y = gather_blend(sw, top, bot, q.y, s0[1], s1[1], fxa[1], fxa1[1],
                       fya, dya1);
    r.z = gather_blend(sw, top, bot, q.z, s0[2], s1[2], fxa[2], fxa1[2],
                       fya, dya1);
    r.w = gather_blend(sw, top, bot, q.w, s0[3], s1[3], fxa[3], fxa1[3],
                       fya, dya1);
    float* orow = op + static_cast<size_t>(y) * w;
    if (vec) {  // w % 4 == 0 and aligned rows: all 4 columns are in
      *reinterpret_cast<float4*>(orow) = r;
    } else {
      orow[0] = r.x;
      if (n > 1) orow[1] = r.y;
      if (n > 2) orow[2] = r.z;
      if (n > 3) orow[3] = r.w;
    }
  }
}

// ------------------------------------------------------- 4-tap fallback
constexpr int kLutCols = 32;
constexpr int kLutWarps = 8;
constexpr int kLutRows = 16;                            // 2 per thread

// round_f32(a*b + c) with a*b exact: ops/rounding.py fma32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__fma_rn(static_cast<double>(a),
                                    static_cast<double>(b),
                                    static_cast<double>(c)));
}

__global__ void __launch_bounds__(kLutCols * kLutWarps)
clahe_lut_apply_kernel(const uint8_t* __restrict__ img,
                       const float* __restrict__ lut,
                       const int* __restrict__ iy, const int* __restrict__ ix,
                       const float* __restrict__ wts, float* __restrict__ out,
                       int h, int w, int n_tiles, int gw) {
  extern __shared__ float sl[];     // the staged tiles, 256 floats each
  __shared__ int s_iy[kLutRows][2];
  __shared__ int s_ix[kLutCols][2];
  __shared__ int s_range[4];        // tile rows lo..hi, tile columns lo..hi

  const int p = blockIdx.z;
  const int lane = threadIdx.x;
  const int y0 = blockIdx.y * kLutRows;
  const int x = blockIdx.x * kLutCols + lane;
  // warp 0: this block's tile rows; warp 1: its tile columns; each reduced
  // to the range of tiles to stage
  if (threadIdx.y < 2) {
    const bool rows = threadIdx.y == 0;
    const int i = rows ? y0 + lane : x;
    const bool in = rows ? (lane < kLutRows && i < h) : i < w;
    int a = 0, b = 0;
    if (in) {
      const int2 t = __ldg(reinterpret_cast<const int2*>(rows ? iy : ix) + i);
      a = t.x;
      b = t.y;
      if (rows) {
        s_iy[lane][0] = a;
        s_iy[lane][1] = b;
      } else {
        s_ix[lane][0] = a;
        s_ix[lane][1] = b;
      }
    }
    int lo = in ? min(a, b) : 0x7fffffff;
    int hi = in ? max(a, b) : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s_range[rows ? 0 : 2] = lo;
      s_range[rows ? 1 : 3] = hi;
    }
  }
  __syncthreads();
  const int ty = s_range[0];
  const int tx = s_range[2];
  const int pw = s_range[3] - tx + 1;
  // taps in range (the wrapper's contract) span at most every tile; the
  // clamps below only keep other inputs inside the buffer
  const int n_stage = min((s_range[1] - ty + 1) * pw, n_tiles);
  const float* lp = lut + static_cast<size_t>(p) * n_tiles * 256;
  const int tid = threadIdx.y * kLutCols + lane;
  for (int i = tid; i < n_stage * 64; i += kLutCols * kLutWarps) {
    const int s = i >> 6;  // staged tile
    int t = (ty + s / pw) * gw + tx + s % pw;
    t = min(max(t, 0), n_tiles - 1);
    reinterpret_cast<float4*>(sl)[i] =
        __ldg(reinterpret_cast<const float4*>(lp + t * 256) + (i & 63));
  }
  __syncthreads();
  if (x >= w) return;

  const int c0 = s_ix[lane][0] - tx;
  const int c1 = s_ix[lane][1] - tx;
  const size_t plane = static_cast<size_t>(p) * h * w;
#pragma unroll
  for (int r = threadIdx.y; r < kLutRows; r += kLutWarps) {
    const int y = y0 + r;
    if (y >= h) break;
    const size_t i = static_cast<size_t>(y) * w + x;
    const int v = __ldg(img + plane + i);
    const float4 wq = __ldg(reinterpret_cast<const float4*>(wts) + i);
    const int r0 = (s_iy[r][0] - ty) * pw;
    const int r1 = (s_iy[r][1] - ty) * pw;
    const int last = n_stage - 1;
    float acc = fma32(wq.x, sl[min(r0 + c0, last) * 256 + v], 0.0f);
    acc = fma32(wq.y, sl[min(r0 + c1, last) * 256 + v], acc);
    acc = fma32(wq.z, sl[min(r1 + c0, last) * 256 + v], acc);
    acc = fma32(wq.w, sl[min(r1 + c1, last) * 256 + v], acc);
    out[plane + i] = acc;
  }
}

}  // namespace

extern "C" int aej_clahe_gather(const void* img, const void* words,
                                const void* ix0, const void* ix1,
                                const void* xa, const void* xa1,
                                const void* ya, const void* ya1, void* out,
                                int planes, int h, int w, int gh, int th,
                                void* stream) {
  if (planes > 0 && h > 0 && w > 0) {
    const dim3 grid((w + kGatherStrip - 1) / kGatherStrip,
                    (h + kGatherBand - 1) / kGatherBand, planes);
    const dim3 block(32, kGatherWarps);
    const size_t smem = static_cast<size_t>(gh) * 256 * sizeof(int);
    const int vec = w % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(img) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    clahe_gather_kernel<<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), static_cast<const int*>(words),
        static_cast<const int*>(ix0), static_cast<const int*>(ix1),
        static_cast<const float*>(xa), static_cast<const float*>(xa1),
        static_cast<const float*>(ya), static_cast<const float*>(ya1),
        static_cast<float*>(out), h, w, gh, th / 2, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aej_clahe_lut_apply(const void* img, const void* lut,
                                   const void* iy, const void* ix,
                                   const void* wts, void* out, int planes,
                                   int h, int w, int n_tiles, int gw,
                                   void* stream) {
  if (planes > 0 && h > 0 && w > 0) {
    const dim3 grid((w + kLutCols - 1) / kLutCols,
                    (h + kLutRows - 1) / kLutRows, planes);
    const dim3 block(kLutCols, kLutWarps);
    const size_t smem = static_cast<size_t>(n_tiles) * 256 * sizeof(float);
    clahe_lut_apply_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), static_cast<const float*>(lut),
        static_cast<const int*>(iy), static_cast<const int*>(ix),
        static_cast<const float*>(wts), static_cast<float*>(out), h, w,
        n_tiles, gw);
  }
  return static_cast<int>(cudaGetLastError());
}
