// Contractions along one axis of a (P, H, W) float32 tensor, summed in
// the order XLA's CPU dot sums the reference's einsums: the dense resize's
// two (aejpeg_tpu/ops/resize.py resize2d) and the DCT's two per direction
// (aejpeg_tpu/ops/dct.py dct2, idct2, dct2_dense, idct2_dense).
//
// The reference has no Pallas kernel here: on the TPU the einsums are MXU
// matmuls.  The port needs the bits that jax.jit gives on the CPU, where
// XLA hands each einsum's 2-D dot to YNNPACK.  Its kernel keeps `lanes`
// partial sums per output (one per k modulo lanes, each a chain of FMAs
// from zero) and adds them as a tree, per k-block, adding the blocks in
// order; then it adds the tree of the products of the k past the last
// multiple of lanes.  The code runs with FTZ and DAZ.  ops/xla_dot.py
// gives the order and lays it out as a band; the plain versions,
// ops/kernels.py banded_resize_plain and dct_pass_plain, run the same
// steps.  Every FMA is __fmaf_rn (one rounding) and every add __fadd_rn,
// so kernel and plain version agree bit for bit.  Subnormal inputs read as
// zero and subnormal results are flushed to a zero of their sign, as
// XLA's MXCSR does.
//
// aej_banded_resize: a band of few taps per output (a resize), tables
// slot-major (neighbouring outputs of one slot side by side).  XLA also
// runs the k whose weight is zero; the band skips them, so it repairs
// their only visible effects: an output is NaN where its dot row holds a
// NaN, or an infinity at a k that is not one of its taps (inf * 0), and a
// -0 sum becomes +0 where a skipped term x * 0 with x >= +0 follows it
// (see ops/kernels._zero_sign).  Both need the whole dot row, so a tile
// covers whole dot rows.  Persistent blocks keep the band's table in
// shared memory (read per output from L1/L2 it made the kernel latency
// bound) and walk over tiles:
//   axis 1 (contract H): a tile is a strip of 32 columns of one plane and
//     every output row; 8 x 32 threads, each 4 neighbouring columns
//     (16-byte loads and stores), the strip staged in shared memory;
//   axis 2 (contract W): a warp takes 4 rows, staged in shared memory;
//     each lane one output of all 4 rows, so a table entry serves 4 rows
//     and a warp's stores are 128 neighbouring bytes.
// aej_dct_pass: a dense periodic band (period s <= 128, the DCT), its
// s x s weights in shared memory, staged once by persistent blocks:
//   axis 1: a block takes max(s, 32) rows x 32 columns, staged; each
//     thread up to 4 output rows x 4 columns, so each staged input feeds
//     up to 16 FMA chains;
//   axis 2: a block takes 1024 consecutive elements (whole windows),
//     staged; each thread 4 neighbouring outputs of one window, which
//     share every input;
//   with an epilogue on axis 2: quantize to int16/int32 levels written in
//   block-row zigzag order (stage B), or add + fma(y, rcp, mid) (the
//   decoder's canvas sum and denormalize).
// Bound on the H100: bytes for the resize (a few FMAs per output); for the
// DCT bytes at small s and FP32 operations at large s (s FMAs per output
// per pass).

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMinNormal = 1.17549435e-38f;
// Loads a thread keeps in flight while it stages.
constexpr int kUnroll = 4;
// Steps of a DCT chain the compiler unrolls, so that their loads issue
// ahead.
constexpr int kChainUnroll = 4;
// Shared memory a block may stage (dynamic; above 48 KB after opting in).
constexpr int kStageLimit = 96 * 1024;

__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kMinNormal ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float add(float a, float b) {
  return ftz(__fadd_rn(a, b));
}

// Below this magnitude a non-zero input may make a product or sum under
// 2**-126 (with every weight at least 2**-10): tiles without such inputs
// skip the flushes, which then change nothing (every non-zero result is a
// multiple of 2**-116), as the plain version does.
constexpr float kTinyInput = 8.67361738e-19f;  // 2**-60

__device__ __forceinline__ bool tiny_input(float v) {
  return v != 0.0f && fabsf(v) < kTinyInput;
}

template <bool F>
__device__ __forceinline__ float fma_f(float a, float b, float c) {
  const float r = __fmaf_rn(a, b, c);
  return F ? ftz(r) : r;
}

template <bool F>
__device__ __forceinline__ float add_f(float a, float b) {
  const float r = __fadd_rn(a, b);
  return F ? ftz(r) : r;
}

// XLA's sum of its partial sums: a, a + b, (a + b) + (c + d).
template <bool F>
__device__ __forceinline__ float tree_f(float a, float b, float c, float d,
                                        int lanes) {
  if (lanes == 1) return a;
  if (lanes == 2) return add_f<F>(a, b);
  return add_f<F>(add_f<F>(a, b), add_f<F>(c, d));
}

struct Band {
  const int* idx;                 // (2, slots, period)
  const float* wt;                // (2, slots, period)
  const int* lanes_of;            // (2, period)
  const int* kblk;                // (2, period)
  const unsigned char* complete;  // (2, period)
  const int* trail;               // (2, blocks * lanes, period)
  int blocks, lanes, steps, slots, period, row_split, src;
};

// The band's sum for output o through table t, for N dot rows at once
// (load(k, v) gives the N rows' inputs at k, already flushed), and the
// count of infinite taps of each.
template <int LANES, int N, bool F, class Load>
__device__ __forceinline__ void band_sum(const Band& b, int t, int o, const Load& load,
                         float (&res)[N], int (&infs)[N]) {
  const int per = b.period;
  const int L = b.lanes_of[t * per + o];
  const int width = b.lanes * b.steps + b.lanes;
  const int* idx = b.idx + (long long)t * b.slots * per + o;
  const float* wt = b.wt + (long long)t * b.slots * per + o;
  float tsum[N];
  bool any_tail = false;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    res[n] = 0.0f;
    tsum[n] = 0.0f;
    infs[n] = 0;
  }
  for (int j = 0; j < b.blocks; ++j) {
    const int base = j * width;
    float lane[LANES][N];
    bool used = false;
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
#pragma unroll
      for (int n = 0; n < N; ++n) lane[c][n] = 0.0f;
      if (c >= L) continue;
      for (int s = 0; s < b.steps; ++s) {
        const int slot = base + c * b.steps + s;
        const int k = idx[(long long)slot * per];
        if (k < 0) break;
        const float w = wt[(long long)slot * per];
        float v[N];
        load(k, v);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          infs[n] += isinf(v[n]) ? 1 : 0;
          lane[c][n] = fma_f<F>(v[n], w, lane[c][n]);
        }
        used = true;
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float blk = tree_f<F>(lane[0][n], lane[LANES > 1 ? 1 : 0][n],
                                  lane[LANES > 2 ? 2 : 0][n],
                                  lane[LANES > 3 ? 3 : 0][n], L);
      if (j == 0) {
        res[n] = blk;
      } else if (used) {
        res[n] = add_f<F>(res[n], blk);
      }
    }
    float tl[LANES][N];
    bool has = false;
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
#pragma unroll
      for (int n = 0; n < N; ++n) tl[c][n] = 0.0f;
      if (c >= L) continue;
      const int slot = base + b.lanes * b.steps + c;
      const int k = idx[(long long)slot * per];
      if (k < 0) continue;
      const float w = wt[(long long)slot * per];
      float v[N];
      load(k, v);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        infs[n] += isinf(v[n]) ? 1 : 0;
        tl[c][n] = F ? ftz(__fmul_rn(v[n], w)) : __fmul_rn(v[n], w);
      }
      has = true;
    }
    if (has) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        tsum[n] = tree_f<F>(tl[0][n], tl[LANES > 1 ? 1 : 0][n],
                               tl[LANES > 2 ? 2 : 0][n],
                               tl[LANES > 3 ? 3 : 0][n], L);
      any_tail = true;
    }
  }
  if (any_tail) {
#pragma unroll
    for (int n = 0; n < N; ++n) res[n] = add_f<F>(res[n], tsum[n]);
  }
}

// band_sum with the flushes (F) or without them (no tiny input, no small
// weight: they would change nothing).
template <int LANES, int N, class Load>
__device__ __forceinline__ void band_sum_any(const Band& b, bool flush,
                                             int t, int o, const Load& load,
                                             float (&res)[N],
                                             int (&infs)[N]) {
  if (flush) {
    band_sum<LANES, N, true>(b, t, o, load, res, infs);
  } else {
    band_sum<LANES, N, false>(b, t, o, load, res, infs);
  }
}

// x86's NaN of inf * 0 and inf - inf.
constexpr int kDefaultNan = (int)0xffc00000u;
constexpr int kNoNan = 0x7fffffff;

// XLA's terms x * 0 of the k the band skips, on one dot row's result r:
// NaN where the row holds a NaN or an infinity off the taps (nan: the
// row's first NaN input, else x86's default NaN, as ops/kernels._row_nan);
// a -0 becomes +0 unless every partial sum of every k-block holds a tap
// and every input past the last tap of each partial sum is negative.
template <class Load1>
__device__ __forceinline__ float fix(const Band& b, int t, int o, float r, int infs,
                     bool row_nan, int row_inf, float nan,
                     const Load1& load1) {
  if (row_nan || row_inf > infs || isnan(r)) return nan;
  if (r != 0.0f || !signbit(r)) return r;
  const int per = b.period;
  if (!__ldg(b.complete + t * per + o)) return 0.0f;
  const int L = b.lanes_of[t * per + o];
  const int kb = __ldg(b.kblk + t * per + o);
  const int rows = b.blocks * b.lanes;
  for (int q = 0; q < rows; ++q) {
    const int st = __ldg(b.trail + ((long long)t * rows + q) * per + o);
    if (st < 0) continue;
    const int lo = st / kb * kb;
    const int hi = min(b.src, lo + kb);
    const int end = lo + (hi - lo) / L * L;
    for (int k = st; k < end; k += L) {
      if (!signbit(load1(k))) return 0.0f;
    }
  }
  return r;
}

// Stage table 0 of the band (idx, weights, lanes_of) in shared memory at
// `sm` when it is the only table the rows use (`staged`), and point b at
// it; returns the floats it took.
__device__ __forceinline__ int stage_band(Band& b, float* sm, int staged) {
  if (!staged) return 0;
  const int n = b.slots * b.period;
  int* s_idx = reinterpret_cast<int*>(sm);
  float* s_wt = sm + n;
  int* s_lanes = reinterpret_cast<int*>(sm + 2 * n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_idx[i] = __ldg(b.idx + i);
    s_wt[i] = __ldg(b.wt + i);
  }
  for (int i = threadIdx.x; i < b.period; i += kThreads)
    s_lanes[i] = __ldg(b.lanes_of + i);
  b.idx = s_idx;
  b.wt = s_wt;
  b.lanes_of = s_lanes;
  return (2 * n + b.period + 3) / 4 * 4;
}

// ------------------------------------------------------------ resize axis 1
// x (P, H, W) -> out (P, dst, W): a tile per (plane, 32-column strip);
// persistent blocks walk over tiles with the band's table in shared
// memory.
template <int LANES>
__global__ void __launch_bounds__(kThreads)
banded_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                   Band b, int p_count, int h, int w, int staged,
                   int tables_staged, int careful) {
  extern __shared__ float sm[];  // [band table][(h, 32) strip]
  __shared__ int s_nan[32], s_inf[32];
  const int off = stage_band(b, sm, tables_staged);
  float* strip = sm + off;
  const int strips = (w + 31) / 32;
  const int tiles = p_count * strips;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int dst = b.period;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p = tile / strips;
    const int w0 = (tile % strips) * 32;
    const int c0 = w0 + 4 * tx;
    const float* xp = x + (long long)p * h * w;
    if (threadIdx.x < 32) {
      s_nan[threadIdx.x] = kNoNan;
      s_inf[threadIdx.x] = 0;
    }
    __syncthreads();
    const bool vec = (w % 4 == 0) && c0 + 3 < w;
    int nan_c[4] = {kNoNan, kNoNan, kNoNan, kNoNan};
    int inf_c[4] = {0, 0, 0, 0};
    int tiny = 0;
    // kUnroll rows of loads in flight before any is used
    for (int r0 = ty; r0 < h; r0 += 32 * kUnroll) {
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + 32 * u;
#pragma unroll
        for (int n = 0; n < 4; ++n) v[u][n] = 0.0f;
        if (r >= h) continue;
        if (vec) {
          const float4 q = *reinterpret_cast<const float4*>(
              xp + (long long)r * w + c0);
          v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            v[u][n] = c0 + n < w ? xp[(long long)r * w + c0 + n] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + 32 * u;
        if (r >= h) break;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          v[u][n] = ftz(v[u][n]);
          if (isnan(v[u][n]) && nan_c[n] == kNoNan) nan_c[n] = r;
          inf_c[n] += isinf(v[u][n]) ? 1 : 0;
          tiny |= tiny_input(v[u][n]) ? 1 : 0;
        }
        if (staged) {
          *reinterpret_cast<float4*>(strip + r * 32 + 4 * tx) =
              make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (nan_c[n] != kNoNan) atomicMin(&s_nan[4 * tx + n], nan_c[n]);
      if (inf_c[n]) atomicAdd(&s_inf[4 * tx + n], inf_c[n]);
    }
    const bool flush = __syncthreads_or(tiny | careful) != 0;
    if (c0 < w) {
      const int cols = min(4, w - c0);
      float* op = out + (long long)p * dst * w;
      const long long row0 = (long long)p * w + c0;  // dot row of c0
      auto load4 = [=](int k, float (&v)[4]) {
        if (staged) {
          const float4 q = *reinterpret_cast<const float4*>(strip + k * 32
                                                            + 4 * tx);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            v[n] = n < cols ? ftz(xp[(long long)k * w + c0 + n]) : 0.0f;
        }
      };
      const int t0 = row0 >= b.row_split;
      const int t3 = row0 + cols - 1 >= b.row_split;
      int first[4], rinf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        first[n] = s_nan[4 * tx + n];
        rinf[n] = s_inf[4 * tx + n];
      }
      for (int o = ty; o < dst; o += 32) {
        float res[4];
        int infs[4];
        if (t0 == t3) {
          band_sum_any<LANES, 4>(b, flush, t0, o, load4, res, infs);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float r1[1];
            int i1[1];
            auto load1 = [=](int k, float (&v)[1]) {
              float v4[4];
              load4(k, v4);
              v[0] = v4[n];
            };
            band_sum_any<LANES, 1>(b, flush, row0 + n >= b.row_split, o,
                                   load1, r1, i1);
            res[n] = r1[0];
            infs[n] = i1[0];
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int t = row0 + n >= b.row_split;
          auto at = [=](int k) {
            float v4[4];
            load4(k, v4);
            return v4[n];
          };
          const float nan = first[n] == kNoNan
                                ? __int_as_float(kDefaultNan)
                                : at(first[n]);
          res[n] = fix(b, t, o, res[n], infs[n], first[n] != kNoNan,
                       rinf[n], nan, at);
        }
        float* dp = op + (long long)o * w + c0;
        if (vec) {
          *reinterpret_cast<float4*>(dp) = make_float4(res[0], res[1],
                                                       res[2], res[3]);
        } else {
          for (int n = 0; n < cols; ++n) dp[n] = res[n];
        }
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ resize axis 2
// x (P, H, W) -> out (P, H, dst): a warp per 4 dot rows (p, h), each
// staged; a lane computes one output of all 4 rows at once, so each table
// entry it loads serves 4 rows, and the lanes store neighbouring outputs.
// Persistent blocks walk over row groups with the band's table in shared
// memory.
// Rows a warp takes at once.
constexpr int kColsRows = 4;

template <int LANES>
__global__ void __launch_bounds__(kThreads)
banded_cols_kernel(const float* __restrict__ x, float* __restrict__ out,
                   Band b, long long rows, int w, int staged,
                   int tables_staged, int careful) {
  extern __shared__ float sm[];  // [band table][(8, 4, w) rows]
  const int off = stage_band(b, sm, tables_staged);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* srow = sm + off + warp * kColsRows * w;
  const long long groups = (rows + kColsRows - 1) / kColsRows;
  const int dst = b.period;
  for (long long grp = (long long)blockIdx.x * 8 + warp; grp < groups;
       grp += (long long)gridDim.x * 8) {
    const long long row0 = grp * kColsRows;
    const int nr = (int)min((long long)kColsRows, rows - row0);
    const float* xr = x + row0 * w;
    int nan_c[kColsRows], inf_c[kColsRows];
    int tiny = 0;
#pragma unroll
    for (int r = 0; r < kColsRows; ++r) {
      nan_c[r] = kNoNan;
      inf_c[r] = 0;
    }
    __syncwarp();
    // the 4 rows' loads of kUnroll columns in flight before any is used
    for (int c0 = lane; c0 < w; c0 += 32 * kUnroll) {
      float v[kColsRows][kUnroll];
#pragma unroll
      for (int r = 0; r < kColsRows; ++r)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          v[r][u] = r < nr && c < w ? xr[(long long)r * w + c] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kColsRows; ++r)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + 32 * u;
          if (r >= nr || c >= w) continue;
          const float x1 = ftz(v[r][u]);
          if (isnan(x1) && nan_c[r] == kNoNan) nan_c[r] = c;
          inf_c[r] += isinf(x1) ? 1 : 0;
          tiny |= tiny_input(x1) ? 1 : 0;
          if (staged) srow[r * w + c] = x1;
        }
    }
#pragma unroll
    for (int r = 0; r < kColsRows; ++r) {
      nan_c[r] = __reduce_min_sync(0xffffffffu, nan_c[r]);
      inf_c[r] = __reduce_add_sync(0xffffffffu, inf_c[r]);
    }
    const bool flush = __any_sync(0xffffffffu, tiny | careful) != 0;
    __syncwarp();
    auto at = [=](int r, int k) {
      return staged ? srow[r * w + k] : ftz(xr[(long long)r * w + k]);
    };
    auto load4 = [=](int k, float (&v)[kColsRows]) {
#pragma unroll
      for (int r = 0; r < kColsRows; ++r) v[r] = r < nr ? at(r, k) : 0.0f;
    };
    const int t0 = row0 >= b.row_split;
    const int t3 = row0 + nr - 1 >= b.row_split;
    for (int o = lane; o < dst; o += 32) {
      float res[kColsRows];
      int infs[kColsRows];
      if (t0 == t3) {
        band_sum_any<LANES, kColsRows>(b, flush, t0, o, load4, res, infs);
      } else {
#pragma unroll
        for (int r = 0; r < kColsRows; ++r) {
          float r1[1];
          int i1[1];
          auto load1 = [=](int k, float (&v)[1]) {
            v[0] = r < nr ? at(r, k) : 0.0f;
          };
          band_sum_any<LANES, 1>(b, flush, row0 + r >= b.row_split, o,
                                 load1, r1, i1);
          res[r] = r1[0];
          infs[r] = i1[0];
        }
      }
#pragma unroll
      for (int r = 0; r < kColsRows; ++r) {
        if (r >= nr) break;
        auto at1 = [=](int k) { return at(r, k); };
        const float nan = nan_c[r] == kNoNan ? __int_as_float(kDefaultNan)
                                             : at(r, nan_c[r]);
        out[(row0 + r) * dst + o] = fix(b, row0 + r >= b.row_split, o,
                                        res[r], infs[r], nan_c[r] != kNoNan,
                                        inf_c[r], nan, at1);
      }
    }
  }
}

// ------------------------------------------------------------------ DCT
// Epilogue of the second pass.
struct Epilogue {
  const float* hi;     // quantize: (L, s, s) reciprocal tables, or null
  const float* lo;
  int q_group, q_tables;
  const int* perm;     // zigzag position of each raster position, or null
  int out_kind;        // 0 float, 1 int16 levels, 2 int32 levels
  const float* add;    // float: added first (add + y), or null
  const float* rcp;    // float: then fma(y, rcp[l], mid[l]), or null
  const float* mid;
  int f_group, f_tables;
};

__device__ __forceinline__ int level(float y, float hi, float lo,
                                     int kind) {
  // XLA's quantize: fma(y, hi, y * lo), round half to even, saturating
  // convert (NaN -> 0).
  const float v = rintf(__fmaf_rn(y, hi, ftz(__fmul_rn(y, lo))));
  if (isnan(v)) return 0;
  if (kind == 1) {
    if (v <= -32768.0f) return -32768;
    if (v >= 32767.0f) return 32767;
  } else {
    if (v <= -2147483648.0f) return INT32_MIN;
    if (v >= 2147483648.0f) return INT32_MAX;
  }
  return (int)v;
}

// Floats before the staged tile in dct_rows_kernel's shared memory: the
// padded weights, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int rows_offset(int s) {
  return (s * (s + 1) + 3) / 4 * 4;
}

// One tile of dct_rows_kernel: every output row of thread (tx, ty) lies in
// the window of its row ty (with th = s one window).
template <int L, bool F>
__device__ __forceinline__ void rows_tile(const float* x_sm,
                                          const float* w_sm, int ws, int s,
                                          int th, int tx, int ty,
                                          float (&res)[4][4]) {
  const int no = th / 32;
  float acc[L][4][4];
#pragma unroll
  for (int c = 0; c < L; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[c][i][n] = 0.0f;
  const int base = th == s ? 0 : ty / s * s;
#pragma unroll kChainUnroll
  for (int k0 = 0; k0 < s; k0 += L) {
#pragma unroll
    for (int c = 0; c < L; ++c) {             // k = k0 + c feeds chain c
      const int k = k0 + c;
      const float4 q = *reinterpret_cast<const float4*>(
          x_sm + (base + k) * 32 + 4 * tx);
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= no) break;
        const float wv = w_sm[((ty + 32 * i) % s) * ws + k];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[c][i][n] = fma_f<F>(v[n], wv, acc[c][i][n]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      res[i][n] = tree_f<F>(acc[0][i][n], acc[L > 1 ? 1 : 0][i][n],
                            acc[L > 2 ? 2 : 0][i][n],
                            acc[L > 3 ? 3 : 0][i][n], L);
}

// Axis 1: out[(g * s + r), c] = sum_k W[r][k] x[(g * s + k), c] over the
// rows of the (P * H, W) matrix.  A tile: th = max(s, 32) rows x 32
// columns; thread (tx, ty): columns 4 tx.., rows ty, ty + 32, ...  A block
// stages the weights once and walks over tiles.
template <int L>
__global__ void __launch_bounds__(kThreads)
dct_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ wt, int rows, int w, int s,
                int careful) {
  extern __shared__ float sm[];
  const int th = s > 32 ? s : 32;
  const int ws = s + 1;                       // padded weight row
  float* w_sm = sm;                           // (s, s + 1)
  float* x_sm = sm + rows_offset(s);          // (th, 32), 16-byte aligned
  const int strips = (w + 31) / 32;
  const int tiles = (rows + th - 1) / th * strips;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  for (int i = threadIdx.x; i < s * s; i += kThreads)
    w_sm[(i / s) * ws + i % s] = wt[i];
  const bool vec_w = w % 4 == 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = (tile / strips) * th;
    const int c0 = (tile % strips) * 32 + 4 * tx;
    const bool vec = vec_w && c0 + 3 < w;
    int tiny = 0;
    for (int r = ty; r < th; r += 32) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r0 + r < rows) {
        const float* xp = x + (long long)(r0 + r) * w + c0;
        if (vec) {
          const float4 q = *reinterpret_cast<const float4*>(xp);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n) v[n] = c0 + n < w ? xp[n] : 0.0f;
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        v[n] = ftz(v[n]);
        tiny |= tiny_input(v[n]) ? 1 : 0;
      }
      *reinterpret_cast<float4*>(x_sm + r * 32 + 4 * tx) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    const bool flush = __syncthreads_or(tiny | careful) != 0;
    if (c0 < w) {
      float res[4][4];
      if (flush) {
        rows_tile<L, true>(x_sm, w_sm, ws, s, th, tx, ty, res);
      } else {
        rows_tile<L, false>(x_sm, w_sm, ws, s, th, tx, ty, res);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 32 * i;
        if (i >= th / 32 || r >= rows) break;
        float* dp = out + (long long)r * w + c0;
        if (vec) {
          *reinterpret_cast<float4*>(dp) = make_float4(res[i][0], res[i][1],
                                                       res[i][2], res[i][3]);
        } else {
          for (int n = 0; n < 4 && c0 + n < w; ++n) dp[n] = res[i][n];
        }
      }
    }
    __syncthreads();
  }
}

// Four neighbouring outputs i0..i0+3 of the staged 1024-element tile
// (one window when s >= 4, which share every input).
template <int L, bool F>
__device__ __forceinline__ void cols_tile(const float* x_sm,
                                          const float* w_sm, int s, int i0,
                                          float (&res)[4]) {
  if (s >= 4) {
    const int base = i0 / s * s, r0 = i0 % s;
    float acc[L][4];
#pragma unroll
    for (int c = 0; c < L; ++c)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[c][n] = 0.0f;
#pragma unroll kChainUnroll
    for (int k0 = 0; k0 < s; k0 += L) {
#pragma unroll
      for (int c = 0; c < L; ++c) {           // k = k0 + c feeds chain c
        const int k = k0 + c;
        const float v = x_sm[base + k];
        const float4 q = *reinterpret_cast<const float4*>(w_sm + k * s + r0);
        acc[c][0] = fma_f<F>(v, q.x, acc[c][0]);
        acc[c][1] = fma_f<F>(v, q.y, acc[c][1]);
        acc[c][2] = fma_f<F>(v, q.z, acc[c][2]);
        acc[c][3] = fma_f<F>(v, q.w, acc[c][3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      res[n] = tree_f<F>(acc[0][n], acc[L > 1 ? 1 : 0][n],
                         acc[L > 2 ? 2 : 0][n], acc[L > 3 ? 3 : 0][n], L);
    return;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int base = (i0 + n) / s * s, r = (i0 + n) % s;
    float acc[L];
#pragma unroll
    for (int c = 0; c < L; ++c) acc[c] = 0.0f;
    for (int k0 = 0; k0 < s; k0 += L) {
#pragma unroll
      for (int c = 0; c < L; ++c)
        acc[c] = fma_f<F>(x_sm[base + k0 + c], w_sm[(k0 + c) * s + r],
                          acc[c]);
    }
    res[n] = tree_f<F>(acc[0], acc[L > 1 ? 1 : 0], acc[L > 2 ? 2 : 0],
                       acc[L > 3 ? 3 : 0], L);
  }
}

// Axis 2: windows of s consecutive elements of the flat (P, H, W) tensor.
// A tile: 1024 consecutive elements, staged; thread: 4 neighbouring
// outputs.  A block stages the weights (transposed, wt_t[k][r]) once and
// walks over tiles.
template <int L>
__global__ void __launch_bounds__(kThreads)
dct_cols_kernel(const float* __restrict__ x, void* __restrict__ out,
                const float* __restrict__ wt_t, long long total, int h,
                int w, int s, int careful, Epilogue ep) {
  extern __shared__ float sm[];
  float* w_sm = sm;                 // (s, s) transposed: w_sm[k * s + r]
  float* x_sm = sm + s * s;         // 1024 elements
  for (int i = threadIdx.x; i < s * s; i += kThreads) w_sm[i] = wt_t[i];
  const long long tiles = (total + 1023) / 1024;
  const long long plane = (long long)h * w;
  const int i0 = 4 * threadIdx.x;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e0 = tile * 1024;
    float v[4];
    if (e0 + i0 + 3 < total && total % 4 == 0) {
      const float4 q = *reinterpret_cast<const float4*>(x + e0 + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        v[n] = e0 + i0 + n < total ? x[e0 + i0 + n] : 0.0f;
    }
    int tiny = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      v[n] = ftz(v[n]);
      tiny |= tiny_input(v[n]) ? 1 : 0;
    }
    *reinterpret_cast<float4*>(x_sm + i0) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    const bool flush = __syncthreads_or(tiny | careful) != 0;
    if (e0 + i0 < total) {
      float res[4];
      if (flush) {
        cols_tile<L, true>(x_sm, w_sm, s, i0, res);
      } else {
        cols_tile<L, false>(x_sm, w_sm, s, i0, res);
      }
      if (ep.out_kind == 0) {
        float* op = static_cast<float*>(out);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const long long e = e0 + i0 + n;
          if (e >= total) break;
          float y = res[n];
          if (ep.add) y = add(ep.add[e], y);
          if (ep.rcp) {
            const int l = (int)((e / plane) / ep.f_group % ep.f_tables);
            const float m = ep.mid[l];
            y = m == 0.0f ? ftz(__fmul_rn(y, ep.rcp[l]))
                          : ftz(__fmaf_rn(y, ep.rcp[l], m));
          }
          res[n] = y;
        }
        if (total % 4 == 0) {
          *reinterpret_cast<float4*>(op + e0 + i0) =
              make_float4(res[0], res[1], res[2], res[3]);
        } else {
          for (int n = 0; n < 4 && e0 + i0 + n < total; ++n)
            op[e0 + i0 + n] = res[n];
        }
      } else {
        // levels, (P, gh * gw, s * s), one row per block in raster order
        const int gw = w / s, gh = h / s;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const long long e = e0 + i0 + n;
          if (e >= total) break;
          const long long p = e / plane;
          const int rem = (int)(e - p * plane);
          const int hh = rem / w, ww = rem % w;
          const int blk = (hh / s) * gw + ww / s;
          const int q = (hh % s) * s + ww % s;
          const int l = (int)(p / ep.q_group % ep.q_tables);
          const int lv = level(res[n], __ldg(ep.hi + l * s * s + q),
                               __ldg(ep.lo + l * s * s + q), ep.out_kind);
          const long long at = (p * gh * gw + blk) * (long long)(s * s)
                               + (ep.perm ? __ldg(ep.perm + q) : q);
          if (ep.out_kind == 1) {
            static_cast<int16_t*>(out)[at] = (int16_t)lv;
          } else {
            static_cast<int32_t*>(out)[at] = lv;
          }
        }
      }
    }
    __syncthreads();
  }
}

// Per (device, kernel) the largest shared-memory opt-in above 48 KB made
// so far (the attribute holds per device; it is never lowered, as a launch
// may use any size up to it), and per (device, kernel, dynamic shared
// memory size) the blocks the card holds at once, found once (both calls
// cost host time at every launch otherwise).  A mutex keeps host threads
// (one per shard of a mesh) from recording a smaller opt-in than the one
// in force.  A full table only repeats the calls.
constexpr int kCacheSize = 128;

struct CacheEntry {
  const void* kernel;
  int device, bytes, grid;
};

struct LaunchCache {
  std::mutex mu;
  CacheEntry opted[kCacheSize];
  CacheEntry occupancy[kCacheSize];
  int n_opted, n_occupancy;
};

LaunchCache& launch_cache() {
  static LaunchCache cache{};
  return cache;
}

// The entry of (kernel, device), and of that bytes unless bytes < 0.
CacheEntry* find_entry(CacheEntry* e, int n, const void* kernel, int device,
                       int bytes) {
  for (int i = 0; i < n; ++i)
    if (e[i].kernel == kernel && e[i].device == device
        && (bytes < 0 || e[i].bytes == bytes))
      return e + i;
  return nullptr;
}

// Opts the current device's `kernel` in to `bytes` of dynamic shared
// memory and gives the most blocks of it the card holds at once (`grid`).
template <class K>
int launch_info(K kernel, int bytes, long long* grid) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  LaunchCache& c = launch_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  if (bytes > 48 * 1024) {
    CacheEntry* o = find_entry(c.opted, c.n_opted, key, dev, -1);
    if (!o || o->bytes < bytes) {
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err) return err;
      if (o) {
        o->bytes = bytes;
      } else if (c.n_opted < kCacheSize) {
        c.opted[c.n_opted++] = {key, dev, bytes, 0};
      }
    }
  }
  CacheEntry* e = find_entry(c.occupancy, c.n_occupancy, key, dev, bytes);
  if (e) {
    *grid = e->grid;
    return 0;
  }
  int blocks = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                           kThreads, bytes);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (err) return err;
  *grid = (long long)(blocks > 0 ? blocks : 1) * sms;
  if (c.n_occupancy < kCacheSize)
    c.occupancy[c.n_occupancy++] = {key, dev, bytes, (int)*grid};
  return 0;
}

// Persistent blocks: as many as fit on the card at once, at most the work.
// Opts the kernel in to `bytes` first.
template <class K>
int persistent_grid(K kernel, int bytes, long long work, long long* grid) {
  long long most = 1;
  const int err = launch_info(kernel, bytes, &most);
  if (err) return err;
  *grid = most < work ? most : (work > 0 ? work : 1);
  return 0;
}

template <int L>
int launch_dct(const float* x, void* out, const float* wt, const float* wt_t,
               int p, int h, int w, int s, int axis, int careful,
               const Epilogue& ep, cudaStream_t stream) {
  long long grid = 1;
  if (axis == 1) {
    const int th = s > 32 ? s : 32;
    const int bytes = (rows_offset(s) + th * 32) * 4;
    const long long rows = (long long)p * h;
    const int err = persistent_grid(dct_rows_kernel<L>, bytes,
                                    (rows + th - 1) / th * ((w + 31) / 32),
                                    &grid);
    if (err) return err;
    dct_rows_kernel<L><<<(unsigned)grid, kThreads, bytes, stream>>>(
        x, static_cast<float*>(out), wt, (int)rows, w, s, careful);
  } else {
    const int bytes = (s * s + 1024) * 4;
    const long long total = (long long)p * h * w;
    const int err = persistent_grid(dct_cols_kernel<L>, bytes,
                                    (total + 1023) / 1024, &grid);
    if (err) return err;
    dct_cols_kernel<L><<<(unsigned)grid, kThreads, bytes, stream>>>(
        x, out, wt_t, total, h, w, s, careful, ep);
  }
  return (int)cudaGetLastError();
}


template <int LANES>
int launch_banded(const float* x, float* out, const Band& b, int p, int h,
                  int w, int axis, int careful, cudaStream_t st) {
  const long long rows = (long long)p * (axis == 1 ? w : h);
  // table 0 staged when it is the only one the rows use
  const int tables = b.row_split >= rows
      ? (2 * b.slots * b.period + b.period + 3) / 4 * 4 * 4 : 0;
  const int tables_staged = tables > 0 && tables <= kStageLimit / 2;
  const int tbytes = tables_staged ? tables : 0;
  long long grid = 1;
  if (axis == 1) {
    const int staged = tbytes + (long long)h * 32 * 4 <= kStageLimit;
    const int bytes = tbytes + (staged ? h * 32 * 4 : 0);
    const int err = persistent_grid(banded_rows_kernel<LANES>, bytes,
                                    (long long)p * ((w + 31) / 32), &grid);
    if (err) return err;
    banded_rows_kernel<LANES><<<(unsigned)grid, kThreads, bytes, st>>>(
        x, out, b, p, h, w, staged, tables_staged, careful);
  } else {
    const int staged =
        tbytes + (long long)w * 8 * kColsRows * 4 <= kStageLimit;
    const int bytes = tbytes + (staged ? w * 8 * kColsRows * 4 : 0);
    const long long groups = (rows + kColsRows - 1) / kColsRows;
    const int err = persistent_grid(banded_cols_kernel<LANES>, bytes,
                                    (groups + 7) / 8, &grid);
    if (err) return err;
    banded_cols_kernel<LANES><<<(unsigned)grid, kThreads, bytes, st>>>(
        x, out, b, rows, w, staged, tables_staged, careful);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aej_banded_resize(
    const float* x, float* out, const int* idx, const float* wt,
    const int* lanes_of, const int* kblk, const unsigned char* complete,
    const int* trail, int p, int h, int w, int dst, int axis, int blocks,
    int lanes, int steps, int slots, int row_split, int careful,
    void* stream) {
  Band b{idx, wt, lanes_of, kblk, complete, trail, blocks, lanes, steps,
         slots, dst, row_split, axis == 1 ? h : w};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_banded<1>(x, out, b, p, h, w, axis, careful, st);
    case 2: return launch_banded<2>(x, out, b, p, h, w, axis, careful, st);
    case 4: return launch_banded<4>(x, out, b, p, h, w, axis, careful, st);
    default: return -1;
  }
}

extern "C" int aej_dct_pass(
    const float* x, void* out, const float* wt, const float* wt_t, int p,
    int h, int w, int s, int axis, int lanes, int careful, const float* hi,
    const float* lo, int q_group, int q_tables, const int* perm,
    int out_kind, const float* add_to, const float* rcp, const float* mid,
    int f_group, int f_tables, void* stream) {
  // the tiles hold whole windows only for a power of two
  if (s < 1 || s > 128 || (s & (s - 1)) || (axis == 1 ? h : w) % s)
    return -1;
  Epilogue ep{hi,   lo,     q_group, q_tables, perm,
              hi ? out_kind : 0, add_to, rcp, mid, f_group, f_tables};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      return launch_dct<1>(x, out, wt, wt_t, p, h, w, s, axis, careful, ep,
                           st);
    case 2:
      return launch_dct<2>(x, out, wt, wt_t, p, h, w, s, axis, careful, ep,
                           st);
    case 4:
      return launch_dct<4>(x, out, wt, wt_t, p, h, w, s, axis, careful, ep,
                           st);
    default:
      return -1;
  }
}
