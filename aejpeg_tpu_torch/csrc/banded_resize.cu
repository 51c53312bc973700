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
// XLA's MXCSR does.  An output whose band says 0 lanes sums one chain of
// rounded products (no FMA), as XLA's last narrow column group of some
// thin dots does; that step is built only into the kernels launched for
// bands with such outputs (Band.unfused).  Where a result is NaN, the
// kernels write the NaN XLA's dot passes on (nan_walk,
// ops/kernels.nan_model): the card's own NaNs carry no payload.
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
// aej_dct2d: both passes of the 2-D DCT (a dense periodic band of period
// s <= 128 along axis 1, then along axis 2) in one launch, block by block:
// each s x s block is independent.  Persistent blocks stage the s x s
// weights once and walk over tiles of whole blocks in shared memory,
// copying the next tile in (cp.async) while they compute the current one.
// The first pass writes its float32 results over the staged tile, the
// second reads them, so the intermediate never leaves the SM.  Each
// thread holds a register tile of outputs (4 x 8 at s >= 64, 4 x 4 below,
// one accumulator set per lane of XLA's order) and per k
// reads its operands as 16-byte vectors, laid out so that a warp's reads
// are free of bank conflicts: up to 32 FMAs per 3 vector loads.  Each
// output's chains run in XLA's k order and are never split, so the bits
// are those of the two-pass plain version.  Tensor cores cannot give
// them: wgmma and TF32 do not round each step to float32.  With an
// epilogue: quantize to int16/int32 levels, laid out per block in zigzag
// order in shared memory and stored as one contiguous run (stage B), or
// add + fma(y, rcp, mid) (the decoder's canvas sum and denormalize).
// Bound on the H100: bytes for the resize (a few FMAs per output); for the
// DCT bytes at s <= 16 and FP32 operations at s >= 32 (2 s FMAs per
// output).

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMinNormal = 1.17549435e-38f;
// Loads a thread keeps in flight while it stages.
constexpr int kUnroll = 4;
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

template <bool F>
__device__ __forceinline__ float mul_f(float a, float b) {
  const float r = __fmul_rn(a, b);
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
  const int* lanes_of;            // (2, period); 0: one chain, no FMA
  const int* kblk;                // (2, period)
  const unsigned char* complete;  // (2, period)
  const int* trail;               // (2, blocks * lanes, period)
  int blocks, lanes, steps, slots, period, row_split, src;
};

// The band's sum for output o through table t, for N dot rows at once
// (load(k, v) gives the N rows' inputs at k, already flushed), and the
// count of infinite taps of each.  U: the band has outputs of 0 lanes
// (Band.unfused); only then is the no-FMA step built.
template <int LANES, int N, bool F, bool U, class Load>
__device__ __forceinline__ void band_sum(const Band& b, int t, int o, const Load& load,
                         float (&res)[N], int (&infs)[N]) {
  const int per = b.period;
  const int lanes_of = b.lanes_of[t * per + o];
  const int L = U ? max(lanes_of, 1) : lanes_of;
  const bool unfused = U && lanes_of == 0;
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
          lane[c][n] = unfused ? add_f<F>(lane[c][n], mul_f<F>(v[n], w))
                               : fma_f<F>(v[n], w, lane[c][n]);
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
        tl[c][n] = mul_f<F>(v[n], w);
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
template <int LANES, bool U, int N, class Load>
__device__ __forceinline__ void band_sum_any(const Band& b, bool flush,
                                             int t, int o, const Load& load,
                                             float (&res)[N],
                                             int (&infs)[N]) {
  if (flush) {
    band_sum<LANES, N, true, U>(b, t, o, load, res, infs);
  } else {
    band_sum<LANES, N, false, U>(b, t, o, load, res, infs);
  }
}

// x86's NaN of inf * 0 and inf - inf.
constexpr int kDefaultNan = (int)0xffc00000u;
constexpr int kNoNan = 0x7fffffff;
constexpr unsigned kQuiet = 0x00400000u;   // set in a NaN x86 passes on

// The NaN XLA's CPU dot gives a result whose sum holds a NaN or an
// infinity (ops/kernels.nan_model): the card's own NaNs carry no payload,
// so this branch, taken only where a result is NaN, writes XLA's.  A
// partial sum's state is finite, +inf, -inf or a NaN's bits; a NaN operand
// wins, the first one of an add (in an FMA chain the input's, which
// vfmadd231 takes first); opposite infinities make the default NaN.
struct NanState {
  int kind;                 // 0 finite, 1 +inf, 2 -inf, 3 NaN
  unsigned bits;
};

__device__ __forceinline__ NanState ns_add(NanState a, NanState b) {
  if (a.kind == 3) return a;
  if (b.kind == 3) return b;
  if (a.kind && b.kind && a.kind != b.kind)
    return {3, (unsigned)kDefaultNan};
  return a.kind ? a : b;
}

__device__ __forceinline__ NanState ns_prod(float x, float w) {
  if (isnan(x)) return {3, __float_as_uint(x) | kQuiet};
  if (isinf(x)) {
    if (w == 0.0f) return {3, (unsigned)kDefaultNan};
    return {(x > 0.0f) == (w > 0.0f) ? 1 : 2, 0u};
  }
  return {0, 0u};
}

__device__ __forceinline__ NanState ns_tree(const NanState (&v)[4],
                                            int lanes) {
  if (lanes == 1) return v[0];
  if (lanes == 2) return ns_add(v[0], v[1]);
  return ns_add(ns_add(v[0], v[1]), ns_add(v[2], v[3]));
}

// Walks one dot row in XLA's order (per k-block of kb, `lanes` chains,
// their tree going before the sum of the blocks so far; the tail's tree
// last, or first in the paired columns of a k = 3 dot); x(k) the input at
// k, wt(k) its weight (0 off the taps).  Only non-finite inputs change a
// state.  Returns XLA's NaN (x86's default where the walk makes none).
template <class X, class Wt>
__device__ float nan_walk(int src, int lanes_of, int kb, const X& x,
                          const Wt& wt) {
  const bool unfused = lanes_of == 0;
  const int L = max(lanes_of, 1);
  const bool paired = L == 2 && src == 3;
  NanState out{0, 0u}, tail[4] = {}, ch[4] = {};
  bool has_tail = false;
  for (int lo = 0; lo < src; lo += kb) {
    const int hi = min(src, lo + kb);
    const int main = lo + (hi - lo) / L * L;
    for (int c = 0; c < 4; ++c) ch[c] = {0, 0u};
    for (int k = lo; k < hi; ++k) {
      const float v = x(k);
      if (isfinite(v)) continue;
      const NanState p = ns_prod(v, wt(k));
      if (k < main) {
        NanState& c = ch[(k - lo) % L];
        c = !unfused && isnan(v) ? p : ns_add(c, p);
      } else {
        tail[k - main] = p;
        has_tail = true;
      }
    }
    const NanState blk = ns_tree(ch, L);
    out = lo ? ns_add(blk, out) : blk;
  }
  if (has_tail) {
    const NanState t = ns_tree(tail, L);
    out = paired ? ns_add(out, t) : ns_add(t, out);
  }
  return __uint_as_float(out.kind == 3 ? out.bits : (unsigned)kDefaultNan);
}

constexpr float kMaxFloat = 3.40282347e38f;

// XLA's NaN of the 2-D DCT's result (r, c) of one block: the second pass's
// walk over Y[r][k] (yt[k * rs], the first pass's results as staged) with
// weights W[c][k] (w_sm[k * rs + c]), a NaN Y[r][k] taking the first
// pass's walk over the block's column k of the input (x0[k' * w + k], in
// device memory) with weights W[r][k'] (w_sm[k' * rs + r]).
__device__ __forceinline__ float dct_nan(const float* yt, const float* w_sm,
                                      const float* x0, int w, int rs, int s,
                                      int lanes, int r, int c) {
  auto y = [=](int k) {
    const float v = yt[k * rs];
    if (!isnan(v)) return v;
    return nan_walk(s, lanes, s, [=](int q) { return x0[q * w + k]; },
                    [=](int q) { return w_sm[q * rs + r]; });
  };
  return nan_walk(s, lanes, s, y, [=](int k) { return w_sm[k * rs + c]; });
}

// Tap weight of output o at k through table t (0 if k is no tap).
__device__ __forceinline__ float band_weight(const Band& b, int t, int o,
                                             int k) {
  const long long base = (long long)t * b.slots * b.period + o;
  for (int q = 0; q < b.slots; ++q)
    if (b.idx[base + (long long)q * b.period] == k)
      return b.wt[base + (long long)q * b.period];
  return 0.0f;
}

// nan_walk of output o's dot row through table t (load1(k) its input at
// k), out of line: the resize takes it only where a result is NaN.
template <class Load1>
__device__ __noinline__ float band_nan(const Band b, int t, int o,
                                       const Load1 load1) {
  return nan_walk(b.src, b.lanes_of[t * b.period + o],
                  __ldg(b.kblk + t * b.period + o), load1,
                  [&](int k) { return band_weight(b, t, o, k); });
}

// XLA's terms x * 0 of the k the band skips, on one dot row's result r:
// NaN where the row holds a NaN or an infinity off the taps (its bits
// nan_walk's); a -0 becomes +0 unless every partial sum of every k-block
// holds a tap and every input past the last tap of each partial sum is
// negative.
template <class Load1>
__device__ __forceinline__ float fix(const Band& b, int t, int o, float r, int infs,
                     bool row_nan, int row_inf, const Load1& load1) {
  if (row_nan || row_inf > infs || isnan(r)) return band_nan(b, t, o, load1);
  if (r != 0.0f || !signbit(r)) return r;
  const int per = b.period;
  if (!__ldg(b.complete + t * per + o)) return 0.0f;
  const int L = max(b.lanes_of[t * per + o], 1);
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
template <int LANES, bool U>
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
          band_sum_any<LANES, U, 4>(b, flush, t0, o, load4, res, infs);
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
            band_sum_any<LANES, U, 1>(b, flush, row0 + n >= b.row_split,
                                      o, load1, r1, i1);
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
          res[n] = fix(b, t, o, res[n], infs[n], first[n] != kNoNan,
                       rinf[n], at);
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

template <int LANES, bool U>
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
        band_sum_any<LANES, U, kColsRows>(b, flush, t0, o, load4, res,
                                          infs);
      } else {
#pragma unroll
        for (int r = 0; r < kColsRows; ++r) {
          float r1[1];
          int i1[1];
          auto load1 = [=](int k, float (&v)[1]) {
            v[0] = r < nr ? at(r, k) : 0.0f;
          };
          band_sum_any<LANES, U, 1>(b, flush, row0 + r >= b.row_split, o,
                                    load1, r1, i1);
          res[r] = r1[0];
          infs[r] = i1[0];
        }
      }
#pragma unroll
      for (int r = 0; r < kColsRows; ++r) {
        if (r >= nr) break;
        auto at1 = [=](int k) { return at(r, k); };
        out[(row0 + r) * dst + o] = fix(b, row0 + r >= b.row_split, o,
                                        res[r], infs[r], nan_c[r] != kNoNan,
                                        inf_c[r], at1);
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

// Geometry of dct2d_kernel for block size S.  A tile is NB consecutive
// blocks (raster order over planes, block rows, block columns), staged in
// shared memory with rows RS floats apart (padded) and blocks BS apart (at
// least S * S + 1 words, the slot of a block's int32 level row in the
// epilogue, and a whole number of vectors).  A thread computes TA x TB outputs of one block: rows V ta + i, columns
// V tb + j % V + (j / V) S / GB, so that the 8 lanes of a 16-byte load
// phase read 16-byte words in distinct banks or one word (a broadcast).
template <int S>
struct Geo {
  // threads a block of the grid, and blocks an SM should hold (several
  // small ones overlap each other's staging, barriers and epilogue; at
  // S = 8, five, which the NaN branch would otherwise take one of)
  static constexpr int NT = S == 128 ? 512 : 128;
  static constexpr int MINB = S == 128 ? 1 : S == 8 ? 5 : 4;
  static constexpr int V = S < 4 ? S : 4;          // floats a vector load
  static constexpr int GB = S >= 64 ? 2 : 1;       // column groups
  static constexpr int TA = V, TB = V * GB;
  static constexpr int NTA = S / TA, NTB = S / TB;
  static constexpr int TPB = NTA * NTB;            // threads a block
  static constexpr int NB = NT / TPB;              // blocks a tile
  static constexpr int RS = S >= 4 ? S + 4 : S;
  static constexpr int BS0 = S * RS + (S == 4 ? 4 : S == 8 ? 8 : 0);
  static constexpr int BS = BS0 > S * S ? BS0 : (S * S + V) / V * V;
  static constexpr int BUF = NB * BS;              // floats a tile buffer
  // weights (S, RS), then two tile buffers
  static constexpr int SMEM = (S * RS + 2 * BUF) * 4;
};

template <int V>
__device__ __forceinline__ void ld(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void st(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// An asynchronous copy of V floats from device to shared memory.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(V * 4));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int S, int L, bool F>
__device__ __forceinline__ void finish(float (&acc)[L][Geo<S>::TA][Geo<S>::TB],
                                       float (&res)[Geo<S>::TA][Geo<S>::TB]) {
#pragma unroll
  for (int i = 0; i < Geo<S>::TA; ++i)
#pragma unroll
    for (int j = 0; j < Geo<S>::TB; ++j)
      res[i][j] = tree_f<F>(acc[0][i][j], acc[L > 1 ? 1 : 0][i][j],
                            acc[L > 2 ? 2 : 0][i][j],
                            acc[L > 3 ? 3 : 0][i][j], L);
}

// One pass over one block: res[i][j] = sum_k A[k][r] B[k][c], r and c
// the thread's rows and columns, A and B staged k-major (rows RS apart):
// the first pass with A = W^T and B the input block, the second with A
// the first pass's results, transposed, and B = W^T.  k runs in order, k
// feeding chain k % L (one __fmaf_rn each), and the chains are summed as
// XLA sums them.  Step k + 1's operands load while step k's FMAs run.
template <int S, int L, bool F>
__device__ __forceinline__ void block_pass(const float* a_sm,
                                           const float* b_sm, int ta, int tb,
                                           float (&res)[Geo<S>::TA][Geo<S>::TB]) {
  using G = Geo<S>;
  constexpr int V = G::V, TA = G::TA, TB = G::TB;
  constexpr int U = S < 8 ? S : 8;        // steps unrolled (even, L | U)
  float acc[L][TA][TB];
#pragma unroll
  for (int c = 0; c < L; ++c)
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) acc[c][i][j] = 0.0f;
  const float* ap = a_sm + V * ta;
  const float* bp = b_sm + V * tb;
  float a[2][TA], b[2][TB];
  auto load = [&](int k, float* av, float* bv) {
    ld<V>(ap + k * G::RS, av);
#pragma unroll
    for (int g = 0; g < G::GB; ++g)
      ld<V>(bp + k * G::RS + g * (S / G::GB), bv + g * V);
  };
  load(0, a[0], b[0]);
  for (int k0 = 0; k0 < S; k0 += U) {
#pragma unroll
    for (int kk = 0; kk < U; ++kk) {
      if (kk + 1 < U || k0 + U < S)
        load(k0 + kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int j = 0; j < TB; ++j)
          acc[kk % L][i][j] = fma_f<F>(a[kk & 1][i], b[kk & 1][j],
                                       acc[kk % L][i][j]);
    }
  }
  finish<S, L, F>(acc, res);
}

// Both passes of the 2-D DCT over every S x S block of a (P, H, W) tensor,
// with the epilogue.  Persistent blocks stage the weights once (transposed,
// w_sm[k * RS + o] = W[o][k]) and walk over tiles of NB blocks; the next
// tile is copied in (cp.async) while the current one is computed.  The
// first pass reads the staged tile and writes its float32 results over
// it; the second reads them.  Each pass flushes (F) where its own input
// holds a tiny value (or a weight is small): elsewhere the flushes change
// nothing.
template <int S, int L>
__global__ void __launch_bounds__(Geo<S>::NT, Geo<S>::MINB)
dct2d_kernel(const float* __restrict__ x, void* __restrict__ out,
             const float* __restrict__ wt_t, int p_count, int h, int w,
             int careful, Epilogue ep) {
  using G = Geo<S>;
  constexpr int V = G::V, TA = G::TA, TB = G::TB;
  constexpr int CPR = S / V;                       // vectors a block row
  constexpr int CHUNKS = G::NB * S * CPR;          // vectors a tile
  extern __shared__ float sm[];
  float* w_sm = sm;
  float* bufs = sm + S * G::RS;
  for (int i = threadIdx.x; i < S * S; i += G::NT)
    w_sm[(i / S) * G::RS + i % S] = wt_t[i];
  const int gw = w / S, per_plane = (h / S) * gw;
  const int blocks = p_count * per_plane;
  const int tiles = (blocks + G::NB - 1) / G::NB;
  const int jb = threadIdx.x / G::TPB, tw = threadIdx.x % G::TPB;
  const int tb = tw % G::NTB, ta = tw / G::NTB;
  // offset of block b's first element in x (and in a float output)
  auto base_of = [=](int b) {
    const int p = b / per_plane, r = b % per_plane;
    return (p * h + (r / gw) * S) * w + (r % gw) * S;
  };
  // A thread's vectors of a tile: NCH rows KSTEP apart of one block
  // (threads side by side take neighbouring vectors of a row, then the
  // next block); CPR * NB divides NT, so the block and the column are the
  // same in every tile.
  constexpr int KSTEP = G::NT / (CPR * G::NB);
  constexpr int NCH = CHUNKS / G::NT;
  static_assert(G::NT % (CPR * G::NB) == 0 && CHUNKS % G::NT == 0,
                "a thread's vectors lie in one block");
  static_assert(G::BS >= S * S + 1 && G::BS % V == 0,
                "a block's int32 level row fits its slot in the tile buffer");
  const int s_cc = threadIdx.x % CPR, s_blk = threadIdx.x / CPR % G::NB;
  const int s_k = threadIdx.x / (CPR * G::NB);
  const int s_off = s_blk * G::BS + s_k * G::RS + s_cc * V;
  auto stage = [&](int tile, float* buf) {
    const int b = tile * G::NB + s_blk;
    if (b >= blocks) return;
    const float* src = x + base_of(b) + s_k * w + s_cc * V;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
      cp_async<V>(buf + s_off + i * KSTEP * G::RS, src + i * KSTEP * w);
  };
  int tile = blockIdx.x;
  if (tile < tiles) stage(tile, bufs);
  cp_commit();
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    float* cur = bufs + (it & 1) * G::BUF;
    if (tile + (int)gridDim.x < tiles)
      stage(tile + gridDim.x, bufs + ((it + 1) & 1) * G::BUF);
    cp_commit();
    cp_wait_one();
    // this thread's vectors: tiny values (then reading subnormals as zero)
    int tiny = 0;
    if (tile * G::NB + s_blk < blocks) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        float* q = cur + s_off + i * KSTEP * G::RS;
        float v[V];
        ld<V>(q, v);
        int t = 0;
#pragma unroll
        for (int n = 0; n < V; ++n) t |= tiny_input(v[n]) ? 1 : 0;
        if (t) {
#pragma unroll
          for (int n = 0; n < V; ++n) v[n] = ftz(v[n]);
          st<V>(q, v);
        }
        tiny |= t;
      }
    }
    const bool f1 = __syncthreads_or(tiny | careful) != 0;
    const int b = tile * G::NB + jb;
    const bool valid = b < blocks;
    float* xb = cur + jb * G::BS;
    float res[TA][TB];
    if (f1) {
      block_pass<S, L, true>(w_sm, xb, ta, tb, res);
    } else {
      block_pass<S, L, false>(w_sm, xb, ta, tb, res);
    }
    __syncthreads();                    // the tile is read: Y goes over it
    // Y transposed, yt[c][r] = Y[r][c], so that the second pass reads it
    // k-major as the first read the input
    int tiny2 = 0;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int c = V * tb + j % V + (j / V) * (S / G::GB);
      float v[V];
#pragma unroll
      for (int n = 0; n < V; ++n) {
        v[n] = res[n][j];
        tiny2 |= tiny_input(v[n]) ? 1 : 0;
      }
      st<V>(xb + c * G::RS + V * ta, v);
    }
    // the addend of the float epilogue, loaded while the second pass runs
    // (where the registers allow)
    constexpr bool PRE = TA * TB * L <= 32;
    float addv[PRE ? TA : 1][PRE ? TB : 1];
    if (PRE && ep.out_kind == 0 && ep.add && valid) {
      const int e0 = base_of(b);
#pragma unroll
      for (int i = 0; i < (PRE ? TA : 1); ++i) {
        const int r = V * ta + i;
#pragma unroll
        for (int g = 0; g < (PRE ? G::GB : 1); ++g)
          ld<V>(ep.add + e0 + r * w + V * tb + g * (S / G::GB),
                &addv[i][g * V]);
      }
    }
    const bool f2 = __syncthreads_or((valid ? tiny2 : 0) | careful) != 0;
    if (f2) {
      block_pass<S, L, true>(xb, w_sm, ta, tb, res);
    } else {
      block_pass<S, L, false>(xb, w_sm, ta, tb, res);
    }
    const int p = b / per_plane;
    if (ep.out_kind == 0) {
      if (valid) {
        float* op = static_cast<float*>(out);
        const int e0 = base_of(b);
        bool finite = true;
        float rcp = 1.0f, m = 0.0f;
        if (ep.rcp) {
          const int l = p / ep.f_group % ep.f_tables;
          rcp = ep.rcp[l];
          m = ep.mid[l];
        }
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const int r = V * ta + i;
#pragma unroll
          for (int g = 0; g < G::GB; ++g) {
            const int e = e0 + r * w + V * tb + g * (S / G::GB);
            float y[V], a[V];
            if (PRE) {
#pragma unroll
              for (int n = 0; n < V; ++n)
                a[n] = addv[PRE ? i : 0][PRE ? g * V + n : 0];
            } else if (ep.add) {
              ld<V>(ep.add + e, a);
            }
#pragma unroll
            for (int n = 0; n < V; ++n) {
              y[n] = res[i][g * V + n];
              if (ep.add) y[n] = add(a[n], y[n]);
              if (ep.rcp)
                y[n] = m == 0.0f ? ftz(__fmul_rn(y[n], rcp))
                                 : ftz(__fmaf_rn(y[n], rcp, m));
              finite &= fabsf(y[n]) <= kMaxFloat;
            }
            st<V>(op + e, y);
          }
        }
        if (!finite) {
          // where a result is NaN, XLA's NaN (the card's carry no
          // payload): the addend's, else both passes walked again
          // (dct_nan, x86's default NaN where the sum holds none: inf -
          // inf in the add), the first from the input in device memory
          // (its tile now holds Y).  One copy of the walk, no call.
#pragma unroll 1
          for (int q = 0; q < TA * TB; ++q) {
            const int i = q / TB, j = q % TB;
            const int r = V * ta + i;
            const int c = V * tb + j % V + (j / V) * (S / G::GB);
            const int e = e0 + r * w + c;
            if (!isnan(op[e])) continue;
            const float a = ep.add ? ep.add[e] : 0.0f;
            op[e] = ep.add && isnan(a)
                        ? __uint_as_float(__float_as_uint(a) | kQuiet)
                        : dct_nan(xb + r, w_sm, x + e0, w, G::RS, S, L, r,
                                  c);
          }
        }
      }
    } else {
      // levels of the tile's blocks, (blocks, S * S) rows in zigzag order,
      // laid out in shared memory (each block's row one word longer, so
      // that the lanes of neighbouring blocks write to other banks), then
      // stored as one contiguous run of words
      __syncthreads();                  // Y is read: the levels go over it
      const int l = p / ep.q_group % ep.q_tables;
      const bool half = ep.out_kind == 1;
      const int lstride = (half ? S * S / 2 : S * S) + 1;   // words
      int16_t* lv16 = reinterpret_cast<int16_t*>(cur) + jb * 2 * lstride;
      int32_t* lv32 = reinterpret_cast<int32_t*>(cur) + jb * lstride;
      const float* hi = ep.hi + l * S * S;
      const float* lo = ep.lo + l * S * S;
      const float* perm = reinterpret_cast<const float*>(ep.perm);
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const int r = V * ta + i;
#pragma unroll
        for (int g = 0; g < G::GB; ++g) {
          const int q0 = r * S + V * tb + g * (S / G::GB);
          float hv[V], lv[V], pv[V];
          ld<V>(hi + q0, hv);
          ld<V>(lo + q0, lv);
          if (perm) ld<V>(perm + q0, pv);
#pragma unroll
          for (int n = 0; n < V; ++n) {
            const int at = perm ? __float_as_int(pv[n]) : q0 + n;
            const int v = level(res[i][g * V + n], hv[n], lv[n],
                                ep.out_kind);
            if (half) {
              lv16[at] = (int16_t)v;
            } else {
              lv32[at] = v;
            }
          }
        }
      }
      __syncthreads();
      const int nb = min(G::NB, blocks - tile * G::NB);
      const int* src = reinterpret_cast<const int*>(cur);
      if (half) {
        constexpr int WD = S * S / 2;
        int* dst = static_cast<int*>(out) + (long long)tile * G::NB * WD;
        for (int o = threadIdx.x; o < nb * WD; o += G::NT)
          dst[o] = src[o / WD * (WD + 1) + o % WD];
      } else {
        constexpr int WD = S * S;
        int* dst = static_cast<int*>(out) + (long long)tile * G::NB * WD;
        for (int o = threadIdx.x; o < nb * WD; o += G::NT)
          dst[o] = src[o / WD * (WD + 1) + o % WD];
      }
    }
    __syncthreads();                    // the buffer is free for a stage
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
// memory and gives the most blocks of `threads` threads the card holds at
// once (`grid`).
template <class K>
int launch_info(K kernel, int bytes, long long* grid, int threads) {
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
                                                           threads, bytes);
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
int persistent_grid(K kernel, int bytes, long long work, long long* grid,
                    int threads = kThreads) {
  long long most = 1;
  const int err = launch_info(kernel, bytes, &most, threads);
  if (err) return err;
  *grid = most < work ? most : (work > 0 ? work : 1);
  return 0;
}

template <int S, int L>
int launch_dct2d(const float* x, void* out, const float* wt_t, int p, int h,
                 int w, int careful, const Epilogue& ep,
                 cudaStream_t stream) {
  using G = Geo<S>;
  const long long blocks = (long long)p * (h / S) * (w / S);
  long long grid = 1;
  const int err = persistent_grid(dct2d_kernel<S, L>, G::SMEM,
                                  (blocks + G::NB - 1) / G::NB, &grid, G::NT);
  if (err) return err;
  dct2d_kernel<S, L><<<(unsigned)grid, G::NT, G::SMEM, stream>>>(
      x, out, wt_t, p, h, w, careful, ep);
  return (int)cudaGetLastError();
}

template <int S>
int launch_dct2d_lanes(int lanes, const float* x, void* out,
                       const float* wt_t, int p, int h, int w, int careful,
                       const Epilogue& ep, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_dct2d<S, 1>(x, out, wt_t, p, h, w, careful, ep,
                                      stream);
    case 2: return launch_dct2d<S, 2>(x, out, wt_t, p, h, w, careful, ep,
                                      stream);
    case 4: return launch_dct2d<S, 4>(x, out, wt_t, p, h, w, careful, ep,
                                      stream);
    default: return -1;
  }
}

template <int LANES, bool U>
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
    const int err = persistent_grid(banded_rows_kernel<LANES, U>, bytes,
                                    (long long)p * ((w + 31) / 32), &grid);
    if (err) return err;
    banded_rows_kernel<LANES, U><<<(unsigned)grid, kThreads, bytes, st>>>(
        x, out, b, p, h, w, staged, tables_staged, careful);
  } else {
    const int staged =
        tbytes + (long long)w * 8 * kColsRows * 4 <= kStageLimit;
    const int bytes = tbytes + (staged ? w * 8 * kColsRows * 4 : 0);
    const long long groups = (rows + kColsRows - 1) / kColsRows;
    const int err = persistent_grid(banded_cols_kernel<LANES, U>, bytes,
                                    (groups + 7) / 8, &grid);
    if (err) return err;
    banded_cols_kernel<LANES, U><<<(unsigned)grid, kThreads, bytes, st>>>(
        x, out, b, rows, w, staged, tables_staged, careful);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aej_banded_resize(
    const float* x, float* out, const int* idx, const float* wt,
    const int* lanes_of, const int* kblk, const unsigned char* complete,
    const int* trail, int p, int h, int w, int dst, int axis, int blocks,
    int lanes, int steps, int slots, int row_split, int flags,
    void* stream) {
  // flags: 1 the band's small weights (flush always), 2 Band.unfused
  Band b{idx, wt, lanes_of, kblk, complete, trail, blocks, lanes, steps,
         slots, dst, row_split, axis == 1 ? h : w};
  const int careful = flags & 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (flags & 2) {
    switch (lanes) {
      case 1: return launch_banded<1, true>(x, out, b, p, h, w, axis,
                                            careful, st);
      case 2: return launch_banded<2, true>(x, out, b, p, h, w, axis,
                                            careful, st);
      case 4: return launch_banded<4, true>(x, out, b, p, h, w, axis,
                                            careful, st);
      default: return -1;
    }
  }
  switch (lanes) {
    case 1: return launch_banded<1, false>(x, out, b, p, h, w, axis, careful,
                                           st);
    case 2: return launch_banded<2, false>(x, out, b, p, h, w, axis, careful,
                                           st);
    case 4: return launch_banded<4, false>(x, out, b, p, h, w, axis, careful,
                                           st);
    default: return -1;
  }
}

extern "C" int aej_dct2d(
    const float* x, void* out, const float* wt_t, int p, int h, int w,
    int s, int lanes, int careful, const float* hi, const float* lo,
    int q_group, int q_tables, const int* perm, int out_kind,
    const float* add_to, const float* rcp, const float* mid, int f_group,
    int f_tables, void* stream) {
  if (h % s || w % s) return -1;
  Epilogue ep{hi,   lo,     q_group, q_tables, perm,
              hi ? out_kind : 0, add_to, rcp, mid, f_group, f_tables};
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 2: return launch_dct2d_lanes<2>(lanes, x, out, wt_t, p, h, w,
                                         careful, ep, st);
    case 4: return launch_dct2d_lanes<4>(lanes, x, out, wt_t, p, h, w,
                                         careful, ep, st);
    case 8: return launch_dct2d_lanes<8>(lanes, x, out, wt_t, p, h, w,
                                         careful, ep, st);
    case 16: return launch_dct2d_lanes<16>(lanes, x, out, wt_t, p, h, w,
                                           careful, ep, st);
    case 32: return launch_dct2d_lanes<32>(lanes, x, out, wt_t, p, h, w,
                                           careful, ep, st);
    case 64: return launch_dct2d_lanes<64>(lanes, x, out, wt_t, p, h, w,
                                           careful, ep, st);
    case 128: return launch_dct2d_lanes<128>(lanes, x, out, wt_t, p, h, w,
                                             careful, ep, st);
    default: return -1;
  }
}
