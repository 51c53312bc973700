// OpenCV's bilateral filter on uint8 planes, bit for bit with the JAX
// package's bilateral_u8 (aejpeg_tpu/ops/canny.py:221-257) as XLA compiles
// it for the CPU, and with the plain version, ops/kernels.py
// bilateral_plain.
//
// The reference has no Pallas kernel here: on the TPU the 13-tap loop is
// elementwise code that XLA fuses.  Per pixel, over the taps of the disk
// of radius R in the reference's order (row by row), with the weight
// w = f32(s_w[t] * c_w[|d|]) (the space weight of the tap times the colour
// weight of the difference d to the centre, XLA's exp tabled by |d| in
// ops/canny.py): the numerator starts as fma(w0, nb0, w1 * nb1) (LLVM fuses
// the first product of that add) and takes each further tap as
// fma(w, nb, num); the denominator adds the weights in order; the result
// is floor(num / den + 0.5) clamped to [0, 255].  __fmaf_rn gives the plain
// version's fma32 (a float64 product and sum, rounded once to float32)
// because that float64 sum is exact here: every nonzero w is at least
// 2**-17 (ops/canny.py checks) with 24 significant bits, nb an integer
// below 256 and num below 2**13, so the sum spans under 53 bits and both
// round the same exact value once.
//
// Bound on the H100: the instructions a tap takes, not bytes (one read and
// one write a pixel) or FP32 operations (3 a tap).  So a tap is as few
// instructions as the bits allow:
// - a thread owns 4 neighbouring columns of a strip of kRows rows and
//   slides down it with the 2R + 1 window rows it needs in registers, as
//   floats (each staged byte is converted once, as 2**23 + byte less
//   2**23), so a new row costs 3 shared-memory words for 4 outputs;
// - the colour weight of a tap is one conflict-free shared-memory read: the
//   256-entry table is stored once per bank (entry d of lane l at
//   d * 32 + l, 32 KB), and its address comes from the float difference
//   (|nb - c| + 2**23 holds |d| in its low bits), so a tap is: 2 FADD, an
//   IMAD, the read, FMUL by the tap's space weight (a kernel parameter),
//   the numerator's FFMA and the denominator's FADD;
// - a CTA stages its tile and a halo of R rows and 4 columns from the
//   unpadded planes with 4-byte loads, reflecting indices
//   (BORDER_REFLECT_101) only in the tiles at the plane's edges, once per
//   row or byte, with no division in the interior.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRadiusMax = 3;
constexpr int kTapsMax = 29;           // the disk of radius 3
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;               // neighbouring columns a thread
constexpr int kTileW = 32 * kCols;     // 128 columns a CTA
constexpr int kHalo = 4;               // staged columns left and right
constexpr int kRowWords = (kTileW + 2 * kHalo) / 4;
constexpr int kRows = 4;               // output rows a warp's strip
constexpr int kTileH = kWarps * kRows;
constexpr int kTable = 256 * 32;       // the colour table, once per bank
constexpr unsigned kTwo23 = 0x4B000000u;   // 2**23 as float bits
// Shared memory a CTA takes: the table and the staged tile with its halo;
// within the 48 KB a launch may take without opting in.
constexpr int kSmemBytes =
    kTable * 4 + (kTileH + 2 * kRadiusMax) * kRowWords * 4;
static_assert(kSmemBytes <= 48 * 1024,
              "bilateral: over the 48 KB a launch takes without opt-in");

struct Space {
  float w[kTapsMax];
};

// The disk's taps in the reference's order: rows dy = -R..R, in each the
// columns dx = -R..R with dy * dy + dx * dx <= R * R.
template <int R>
struct Disk {
  int dy[kTapsMax], dx[kTapsMax], n;
  __host__ __device__ constexpr Disk() : dy(), dx(), n(0) {
    for (int y = -R; y <= R; ++y)
      for (int x = -R; x <= R; ++x)
        if (x * x + y * y <= R * R) {
          dy[n] = y;
          dx[n] = x;
          ++n;
        }
  }
};

__host__ __device__ constexpr int disk_taps(int r) {
  int n = 0;
  for (int y = -r; y <= r; ++y)
    for (int x = -r; x <= r; ++x) n += x * x + y * y <= r * r;
  return n;
}

// BORDER_REFLECT_101 of index v on an axis of n (edge not repeated).
__device__ __forceinline__ int reflect101(int v, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  v %= period;
  if (v < 0) v += period;
  return v < n ? v : period - v;
}

// The same for v in [-kHalo, n + kHalo): one fold where n is wide enough.
__device__ __forceinline__ int reflect_near(int v, int n) {
  if (n <= kHalo + 1) return reflect101(v, n);
  if (v < 0) v = -v;
  if (v >= n) v = 2 * n - 2 - v;
  return v;
}

// Byte i of word as a float: 2**23 + byte, less 2**23 (both exact).
__device__ __forceinline__ float byte_float(unsigned word, int i) {
  return __uint_as_float(__byte_perm(word, kTwo23, 0x7440 | i))
         - 8388608.0f;
}

__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// The 4 bytes at columns c..c+3 of a row, all inside the plane: an aligned
// word, or two and a funnel shift.
__device__ __forceinline__ unsigned row_word(const uint8_t* row, int c) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + c);
  const unsigned* p = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
  const unsigned sh = (unsigned)(a & 3) * 8;
  const unsigned lo = __ldg(p);
  return sh ? __funnelshift_r(lo, __ldg(p + 1), sh) : lo;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                 const float* __restrict__ colour, Space space, int h,
                 int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem);
  unsigned* tile = reinterpret_cast<unsigned*>(smem + kTable * 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = blockIdx.z;
  const uint8_t* src = x + plane * h * w;
  for (int i = threadIdx.x; i < kTable / 4; i += kThreads) {
    const float c = __ldg(colour + (i >> 3));
    reinterpret_cast<float4*>(table)[i] = make_float4(c, c, c, c);
  }
  // staged row r holds plane row y0 - R + r, word q its columns
  // x0 - kHalo + 4q .. + 3
  const bool inner = x0 >= kHalo && x0 + kTileW + kHalo <= w;
  for (int r = warp; r < kTileH + 2 * R; r += kWarps) {
    const int yy = y0 - R + r;
    const int sy = (unsigned)yy < (unsigned)h ? yy
                   : yy < h + R ? reflect101(yy, h) : h - 1;
    const uint8_t* row = src + (long long)sy * w;
    for (int q = lane; q < kRowWords; q += 32) {
      const int c = x0 - kHalo + 4 * q;
      unsigned v;
      if (inner) {
        v = row_word(row, c);
      } else {
        v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int cc = c + b;
          const int sx = cc < w + kHalo ? reflect_near(cc, w) : w - 1;
          v |= (unsigned)__ldg(row + sx) << (8 * b);
        }
      }
      tile[r * kRowWords + q] = v;
    }
  }
  __syncthreads();
  const int xc = x0 + kCols * lane;
  const int yb = y0 + warp * kRows;
  if (xc >= w || yb >= h) return;

  constexpr Disk<R> disk{};
  constexpr int C = kCols + 2 * R;   // window columns xc - R .. xc + 3 + R
  // shared address of entry d of this lane's copy: base + (2**23 + d) * 128
  const unsigned lane_base =
      (unsigned)__cvta_generic_to_shared(table) + 4u * lane - (kTwo23 << 7);
  float f[2 * R + 1][C];
  auto load = [&](int r, int j) {
    const unsigned* p = tile + r * kRowWords + lane;
    const unsigned wd[3] = {p[0], p[1], p[2]};
#pragma unroll
    for (int q = 0; q < C; ++q)
      f[j][q] = byte_float(wd[(kHalo - R + q) >> 2], (kHalo - R + q) & 3);
  };
#pragma unroll
  for (int j = 0; j < 2 * R; ++j) load(warp * kRows + j, j);
  const bool vec = (w & 3) == 0 && xc + kCols <= w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    load(warp * kRows + r + 2 * R, 2 * R);
    const int y = yb + r;
    if (y < h) {
      unsigned packed = 0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float cf = f[R][R + i];
        float num = 0.0f, den = 0.0f, w0 = 0.0f, nb0 = 0.0f;
#pragma unroll
        for (int t = 0; t < disk.n; ++t) {
          const float nb = f[R + disk.dy[t]][R + i + disk.dx[t]];
          // |nb - cf| + 2**23 holds |d| in its low bits
          const unsigned e = __float_as_uint(fabsf(nb - cf) + 8388608.0f);
          const float wt = __fmul_rn(space.w[t], lds((e << 7) + lane_base));
          if (t == 0) {
            w0 = wt;
            nb0 = nb;
            den = wt;
          } else if (t == 1) {
            num = __fmaf_rn(w0, nb0, __fmul_rn(wt, nb));
            den = __fadd_rn(den, wt);
          } else {
            num = __fmaf_rn(wt, nb, num);
            den = __fadd_rn(den, wt);
          }
        }
        if (disk.n == 1) num = __fmul_rn(w0, nb0);
        const float rr = floorf(__fadd_rn(__fdiv_rn(num, den), 0.5f));
        packed |= (unsigned)fminf(fmaxf(rr, 0.0f), 255.0f) << (8 * i);
      }
      uint8_t* dp = out + (plane * h + y) * w + xc;
      if (vec) {
        *reinterpret_cast<unsigned*>(dp) = packed;
      } else {
        for (int i = 0; i < kCols && xc + i < w; ++i)
          dp[i] = (uint8_t)(packed >> (8 * i));
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * R; ++j)
#pragma unroll
      for (int q = 0; q < C; ++q) f[j][q] = f[j + 1][q];
  }
}

template <int R>
int launch(const uint8_t* x, uint8_t* out, const float* colour,
           const float* space, int p, int h, int w, cudaStream_t stream) {
  Space sp{};
  for (int t = 0; t < disk_taps(R); ++t) sp.w[t] = space[t];
  const int bytes = kTable * 4 + (kTileH + 2 * R) * kRowWords * 4;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, p);
  bilateral_kernel<R><<<grid, kThreads, bytes, stream>>>(x, out, colour, sp,
                                                         h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (p, h, w) uint8; colour: (256,) float32 colour weights by |d|, on the
// card; space: the disk's taps(radius) float32 space weights, on the host
// -> out (p, h, w).
extern "C" int aej_bilateral(const uint8_t* x, uint8_t* out,
                             const float* colour, const float* space, int p,
                             int h, int w, int radius, void* stream) {
  if (radius < 0 || radius > kRadiusMax || h < 1 || w < 1 || p < 1
      || p > 65535 || (h + kTileH - 1) / kTileH > 65535)
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 0: return launch<0>(x, out, colour, space, p, h, w, s);
    case 1: return launch<1>(x, out, colour, space, p, h, w, s);
    case 2: return launch<2>(x, out, colour, space, p, h, w, s);
    default: return launch<3>(x, out, colour, space, p, h, w, s);
  }
}
