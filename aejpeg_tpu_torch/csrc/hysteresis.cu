// Canny's hysteresis: the strong edge pixels grown through the weak ones
// (8-connected) to the fixpoint, on (p, h, w) bool maps -> (p, h, w)
// float32 {0, 1}; bit for bit with the plain version, ops/kernels.py
// hysteresis_plain (the eager dilation loop), and with the JAX package's
// _hysteresis (aejpeg_tpu/ops/canny.py:341), since the fixpoint is unique.
//
// It replaces no Pallas kernel: the JAX package grows the map in jnp under
// a jax.lax.while_loop over bit-packed words.  The port's eager loop (8
// launches a dilation step on the whole group, a host check every 8 steps)
// was stage A's largest cost on both sides of the card: about 1,550-1,860
// launches and 24-29 host syncs a 42-image batch, the host issuing them
// for most of stage A's 194 ms, and the card's largest item of busy time
// (the non-vectorised elementwise kernel of the shifted views, about 24 ms
// a batch).
//
// Bound on the H100: bytes say two bool maps in and a float32 map out (about
// 99 MB, 30 us, for the 42 luma planes of 512x768), but the work is a chain
// of dependent steps: a pixel joins only after a neighbour has.  So the
// design spends its effort on how far one step carries:
// - a CTA holds a plane's (or a band's) two maps in shared memory, packed
//   32 pixels to a word as they are read (bit b of word j of a row is
//   column 32 j + b), and iterates there until __syncthreads_or says no
//   word changed: no host check and one launch a group where every plane
//   fits (2 x 48 KB for a 512x768 plane; the budget is the card's opt-in
//   per block, about 900k pixels);
// - a warp updates one row at a time, a lane holding NW neighbouring words
//   of it: the three rows' union, dilated by a pixel sideways, seeds the
//   row's weak pixels, and every weak run a seed touches is filled whole
//   across the row in one step, as a carry chain: ((k + s) ^ k) & k | s
//   fills each run of k from its lowest seed upward (s a subset of k), the
//   words' carries passed along the lanes by a carry-lookahead of two
//   ballots; the same on the bit-reversed words fills downward;
// - updates are made in place (any order reaches the one fixpoint), each
//   warp sweeping its band of rows down and then up, so that one sweep
//   carries a chain the band's whole height, and a row whose weak pixels
//   gain no new neighbour is skipped after its first update;
// - a plane that does not fit is cut into bands of whole rows that do, one
//   CTA each: a round loads the band and its neighbours' edge rows from a
//   packed state in device memory, iterates to the band's fixpoint, writes
//   the band back if it grew and records the round in a device-side flag;
//   a round returns at once when the previous one changed nothing, and the
//   host launches rounds in groups, with one check of the flag a group.

#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Threads a CTA whose lanes hold NW words of a row; fewer as NW grows, so
// that a lane's NW-word arrays stay in registers.
template <int NW>
struct Shape {
  static constexpr int kThreads =
      NW == 1 ? 1024 : NW == 2 ? 512 : NW == 4 ? 256 : 128;
  static constexpr int kWarps = kThreads / 32;
};

// Bit i set where byte i of x is not zero.
__device__ __forceinline__ unsigned bits4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// The word of columns c0 .. c0 + n - 1 (n <= 32) of a row of bytes; vec:
// the row's bytes lie on a 16-byte boundary at c0.
__device__ __forceinline__ unsigned pack_word(const uint8_t* row, int c0,
                                              int n, bool vec) {
  if (vec && n == 32) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c0);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    return bits4(a.x) | bits4(a.y) << 4 | bits4(a.z) << 8
           | bits4(a.w) << 12 | bits4(b.x) << 16 | bits4(b.y) << 20
           | bits4(b.z) << 24 | bits4(b.w) << 28;
  }
  unsigned m = 0;
  for (int i = 0; i < n; ++i) m |= (unsigned)(__ldg(row + c0 + i) != 0) << i;
  return m;
}

// Columns c0 .. c0 + n - 1 of a float32 row from the bits of m.
__device__ __forceinline__ void unpack_word(float* row, int c0, int n,
                                            unsigned m, bool vec) {
  if (vec && n == 32) {
    float4* p = reinterpret_cast<float4*>(row + c0);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned b = m >> (4 * q);
      p[q] = make_float4((float)(b & 1), (float)(b >> 1 & 1),
                         (float)(b >> 2 & 1), (float)(b >> 3 & 1));
    }
    return;
  }
  for (int i = 0; i < n; ++i) row[c0 + i] = (float)(m >> i & 1);
}

// Fills each run of k that holds a bit of s (s a subset of k), from its
// lowest seed to its top, along a row of 32 * NW words whose lane `lane`
// holds words lane * NW .. + NW - 1 least significant first: the row's sum
// k + s, its carries passed from word to word in the lane and from lane to
// lane by a carry-lookahead (lane generates: the carry out of its words;
// propagates: its words sum to all ones).  `order` is the bit of the
// ballots that is the lane.
template <int NW>
__device__ __forceinline__ void fill_up(const unsigned (&k)[NW],
                                        const unsigned (&s)[NW],
                                        unsigned (&out)[NW], int order,
                                        bool reversed) {
  unsigned carry = 0;
  bool prop = true;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const unsigned long long t = (unsigned long long)k[i] + s[i] + carry;
    carry = (unsigned)(t >> 32);
    prop &= (unsigned)t == kFull;
  }
  unsigned g = __ballot_sync(kFull, carry != 0);
  unsigned p = __ballot_sync(kFull, prop);
  if (reversed) {
    g = __brev(g);
    p = __brev(p);
  }
  const unsigned a = g | p;
  unsigned cin = ((a + g) ^ a ^ g) >> order & 1;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const unsigned long long t = (unsigned long long)k[i] + s[i] + cin;
    out[i] = (((unsigned)t ^ k[i]) & k[i]) | s[i];
    cin = (unsigned)(t >> 32);
  }
}

// One row of the staged band in place: staged rows r (above), r + 1 (this
// one) and r + 2 (below) of S, row r of the weak map K.  full: fill the
// row's runs even where no weak pixel gains a neighbour (a row's first
// update, which closes the runs of the strong pixels it was loaded with).
// Returns whether this lane's words changed.
template <int NW>
__device__ __forceinline__ bool update_row(volatile unsigned* S,
                                           const unsigned* K, int ww, int r,
                                           int lane, bool full) {
  unsigned c[NW], k[NW], s[NW], v[NW];
  const int j0 = lane * NW;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int j = j0 + i;
    if (j < ww) {
      c[i] = S[(r + 1) * ww + j];
      k[i] = K[r * ww + j];
      v[i] = S[r * ww + j] | S[(r + 2) * ww + j] | c[i];
    } else {
      c[i] = k[i] = v[i] = 0;
    }
  }
  const unsigned left = __shfl_up_sync(kFull, v[NW - 1], 1);
  const unsigned right = __shfl_down_sync(kFull, v[0], 1);
  bool fresh = full;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const unsigned lw = i > 0 ? v[i - 1] : lane > 0 ? left : 0u;
    const unsigned rw = i < NW - 1 ? v[i + 1] : lane < 31 ? right : 0u;
    s[i] = k[i] & (v[i] | v[i] << 1 | lw >> 31 | v[i] >> 1 | rw << 31);
    fresh |= (s[i] & ~c[i]) != 0;
  }
  if (!__any_sync(kFull, fresh)) return false;
  unsigned up[NW], kr[NW], sr[NW], dn[NW];
  fill_up<NW>(k, s, up, lane, false);
  // downward: the same on the row reversed (words and lanes in reverse)
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    kr[i] = __brev(k[NW - 1 - i]);
    sr[i] = __brev(s[NW - 1 - i]);
  }
  fill_up<NW>(kr, sr, dn, 31 - lane, true);
  bool changed = false;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const unsigned n = c[i] | up[i] | __brev(dn[NW - 1 - i]);
    if (n != c[i]) {
      S[(r + 1) * ww + j0 + i] = n;
      changed = true;
    }
  }
  return changed;
}

// Iterates the staged band (rows 0 .. R - 1 at staged rows 1 .. R of S,
// the rows above and below it at 0 and R + 1) to its fixpoint; this warp
// sweeps rows lo .. hi - 1, down and then up, until no thread of the CTA
// changed a word in a whole pass.  Returns the passes; *grew: whether any
// word changed.
template <int NW>
__device__ int relax(volatile unsigned* S, const unsigned* K, int ww, int lo,
                     int hi, int lane, bool* grew) {
  bool full = true, any = false;
  int passes = 0;
  for (;;) {
    bool ch = false;
    for (int r = lo; r < hi; ++r) ch |= update_row<NW>(S, K, ww, r, lane, full);
    full = false;
    for (int r = hi - 1; r >= lo; --r)
      ch |= update_row<NW>(S, K, ww, r, lane, false);
    ++passes;
    if (!__syncthreads_or(ch)) break;
    any = true;
  }
  *grew = any;
  return passes;
}

// The rows lo .. hi - 1 of `rows` that warp `warp` of `warps` takes.
__device__ __forceinline__ void warp_rows(int rows, int warp, int warps,
                                          int* lo, int* hi) {
  *lo = (int)((long long)warp * rows / warps);
  *hi = (int)((long long)(warp + 1) * rows / warps);
}

__device__ __forceinline__ void add_tally(int* tally, int passes, int round) {
  if (tally != nullptr && threadIdx.x == 0) {
    atomicMax(tally, passes);
    atomicAdd(tally + 1, passes);
    atomicMax(tally + 2, round + 1);
  }
}

// A whole plane a CTA (blockIdx.x): packed in, iterated, unpacked out.
template <int NW>
__global__ void __launch_bounds__(Shape<NW>::kThreads)
hysteresis_resident(const uint8_t* __restrict__ strong,
                    const uint8_t* __restrict__ weak, float* __restrict__ out,
                    int h, int w, int ww, bool vec_in, bool vec_out,
                    int* tally) {
  extern __shared__ unsigned smem[];
  unsigned* S = smem;                    // staged rows 0 .. h + 1
  unsigned* K = smem + (h + 2) * ww;     // rows 0 .. h - 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long base = (long long)blockIdx.x * h * w;
  for (int i = threadIdx.x; i < ww; i += blockDim.x) {
    S[i] = 0;
    S[(h + 1) * ww + i] = 0;
  }
  int lo, hi;
  warp_rows(h, warp, warps, &lo, &hi);
  for (int r = lo; r < hi; ++r) {
    const long long row = base + (long long)r * w;
    for (int j = lane; j < ww; j += 32) {
      const int n = min(32, w - 32 * j);
      S[(r + 1) * ww + j] = pack_word(strong + row, 32 * j, n, vec_in);
      K[r * ww + j] = pack_word(weak + row, 32 * j, n, vec_in);
    }
  }
  __syncthreads();
  bool grew;
  const int passes = relax<NW>(S, K, ww, lo, hi, lane, &grew);
  for (int r = lo; r < hi; ++r) {
    float* row = out + base + (long long)r * w;
    for (int j = lane; j < ww; j += 32)
      unpack_word(row, 32 * j, min(32, w - 32 * j), S[(r + 1) * ww + j],
                  vec_out);
  }
  add_tally(tally, passes, 0);
}

// One round over a band of `band_rows` rows (blockIdx.y) of a plane
// (blockIdx.x) that does not fit.  Round 0 packs the band and the rows
// around it from the bool maps and writes the band's packed state and
// weak map; later rounds read both, and the rows around the band from the
// other bands' state, and return at once when the round before changed
// nothing (*last, the latest round that changed a word, below it).
template <int NW>
__global__ void __launch_bounds__(Shape<NW>::kThreads)
hysteresis_band(const uint8_t* __restrict__ strong,
                const uint8_t* __restrict__ weak, unsigned* state,
                unsigned* __restrict__ weakp, int h, int w, int ww,
                int band_rows, int round, bool vec_in, int* last,
                int* tally) {
  if (round > 0 && *reinterpret_cast<volatile int*>(last) < round - 1)
    return;
  extern __shared__ unsigned smem[];
  const int r0 = blockIdx.y * band_rows;
  const int rows = min(band_rows, h - r0);
  unsigned* S = smem;                    // staged rows 0 .. rows + 1
  unsigned* K = smem + (rows + 2) * ww;  // rows 0 .. rows - 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long plane = blockIdx.x;
  for (int t = warp; t < rows + 2; t += warps) {
    const int pr = r0 - 1 + t;           // the plane's row
    const bool in = pr >= 0 && pr < h, own = t >= 1 && t <= rows;
    const long long words = (plane * h + pr) * ww;
    const long long bytes = (plane * h + pr) * w;
    for (int j = lane; j < ww; j += 32) {
      const int n = min(32, w - 32 * j);
      unsigned sv = 0;
      if (in)
        sv = round == 0 ? pack_word(strong + bytes, 32 * j, n, vec_in)
                        : __ldcg(state + words + j);
      S[t * ww + j] = sv;
      if (own) {
        unsigned kv;
        if (round == 0) {
          kv = pack_word(weak + bytes, 32 * j, n, vec_in);
          weakp[words + j] = kv;
        } else {
          kv = weakp[words + j];
        }
        K[(t - 1) * ww + j] = kv;
      }
    }
  }
  __syncthreads();
  int lo, hi;
  warp_rows(rows, warp, warps, &lo, &hi);
  bool grew;
  const int passes = relax<NW>(S, K, ww, lo, hi, lane, &grew);
  if (round == 0 || grew) {
    for (int r = lo; r < hi; ++r) {
      const long long words = (plane * h + r0 + r) * ww;
      for (int j = lane; j < ww; j += 32)
        state[words + j] = S[(r + 1) * ww + j];
    }
  }
  if (grew && threadIdx.x == 0) atomicMax(last, round);
  add_tally(tally, passes, round);
}

// The packed state of `words` words (rows of ww) to float32 rows of w.
__global__ void hysteresis_unpack(const unsigned* __restrict__ state,
                                  float* __restrict__ out, long long words,
                                  int w, int ww, bool vec_out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / ww;
    const int j = (int)(i - row * ww);
    unpack_word(out + row * w, 32 * j, min(32, w - 32 * j), state[i],
                vec_out);
  }
}

// Per (device, kernel) the largest shared-memory opt-in made so far (the
// attribute holds per device and is never lowered); a mutex keeps host
// threads from recording a smaller one than the one in force.
constexpr int kCacheSize = 64;

struct Opted {
  const void* kernel;
  int device, bytes;
};

std::mutex opted_mu;
Opted opted[kCacheSize];
int n_opted = 0;

int opt_in(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(opted_mu);
  Opted* o = nullptr;
  for (int i = 0; i < n_opted; ++i)
    if (opted[i].kernel == kernel && opted[i].device == dev) o = opted + i;
  if (o && o->bytes >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  if (o) {
    o->bytes = bytes;
  } else if (n_opted < kCacheSize) {
    opted[n_opted++] = {kernel, dev, bytes};
  }
  return 0;
}

int words_per_lane(int w) {
  const int ww = (w + 31) / 32;
  for (int nw = 1; nw <= 16; nw *= 2)
    if (32 * nw >= ww) return nw;
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NW>
int launch_resident(const uint8_t* strong, const uint8_t* weak, float* out,
                    int p, int h, int w, int* tally, cudaStream_t stream) {
  const int ww = (w + 31) / 32;
  const int bytes = (2 * h + 2) * ww * 4;
  auto kernel = hysteresis_resident<NW>;
  const int err = opt_in(reinterpret_cast<const void*>(kernel), bytes);
  if (err) return err;
  const bool vec_in = w % 16 == 0 && aligned16(strong) && aligned16(weak);
  const bool vec_out = w % 4 == 0 && aligned16(out);
  const int threads = 32 * std::min(Shape<NW>::kWarps, h);
  kernel<<<p, threads, bytes, stream>>>(strong, weak, out, h, w, ww, vec_in,
                                        vec_out, tally);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_rounds(const uint8_t* strong, const uint8_t* weak,
                  unsigned* state, unsigned* weakp, int* last, int* tally,
                  int p, int h, int w, int band_rows, int first, int count,
                  cudaStream_t stream) {
  const int ww = (w + 31) / 32;
  const int bytes = (2 * band_rows + 2) * ww * 4;
  auto kernel = hysteresis_band<NW>;
  int err = opt_in(reinterpret_cast<const void*>(kernel), bytes);
  if (err) return err;
  const bool vec_in = w % 16 == 0 && aligned16(strong) && aligned16(weak);
  const int threads = 32 * std::min(Shape<NW>::kWarps, band_rows);
  const dim3 grid(p, (h + band_rows - 1) / band_rows);
  for (int round = first; round < first + count; ++round) {
    kernel<<<grid, threads, bytes, stream>>>(strong, weak, state, weakp, h,
                                             w, ww, band_rows, round, vec_in,
                                             last, tally);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// The shared memory a block of the current device may opt in to: a CTA
// holds (2 * rows + 2) * ceil(w / 32) words of 4 bytes.
extern "C" int aej_hysteresis_smem(int* bytes) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// strong, weak: (p, h, w) bool (one byte a pixel) -> out (p, h, w) float32,
// one CTA a plane (every plane within the shared-memory budget).  tally:
// null, or 3 ints (zeroed) that take the largest count of passes of a CTA,
// their sum, and 1.
extern "C" int aej_hysteresis(const uint8_t* strong, const uint8_t* weak,
                              float* out, int p, int h, int w, int* tally,
                              void* stream) {
  if (p < 1 || h < 1 || w < 1) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (words_per_lane(w)) {
    case 1: return launch_resident<1>(strong, weak, out, p, h, w, tally, s);
    case 2: return launch_resident<2>(strong, weak, out, p, h, w, tally, s);
    case 4: return launch_resident<4>(strong, weak, out, p, h, w, tally, s);
    case 8: return launch_resident<8>(strong, weak, out, p, h, w, tally, s);
    case 16:
      return launch_resident<16>(strong, weak, out, p, h, w, tally, s);
    default: return -1;
  }
}

// Rounds first .. first + count - 1 of the banded path over bands of
// band_rows rows: state, weakp (p, h, ceil(w / 32)) words (written by round
// 0), last one int (-1 before round 0).  tally as aej_hysteresis's, its
// third int the rounds that ran.
extern "C" int aej_hysteresis_rounds(const uint8_t* strong,
                                     const uint8_t* weak, unsigned* state,
                                     unsigned* weakp, int* last, int* tally,
                                     int p, int h, int w, int band_rows,
                                     int first, int count, void* stream) {
  if (p < 1 || h < 1 || w < 1 || band_rows < 1 || first < 0 || count < 1
      || (h + band_rows - 1) / band_rows > 65535)
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (words_per_lane(w)) {
#define AEJ_ROUNDS(NW)                                                     \
  case NW:                                                                 \
    return launch_rounds<NW>(strong, weak, state, weakp, last, tally, p, h, \
                             w, band_rows, first, count, s);
    AEJ_ROUNDS(1)
    AEJ_ROUNDS(2)
    AEJ_ROUNDS(4)
    AEJ_ROUNDS(8)
    AEJ_ROUNDS(16)
#undef AEJ_ROUNDS
    default: return -1;
  }
}

// The banded path's packed state (p, h, ceil(w / 32)) words -> out (p, h,
// w) float32.
extern "C" int aej_hysteresis_unpack(const unsigned* state, float* out,
                                     int p, int h, int w, void* stream) {
  if (p < 1 || h < 1 || w < 1) return -1;
  const int ww = (w + 31) / 32;
  const long long words = (long long)p * h * ww;
  const bool vec_out = w % 4 == 0 && aligned16(out);
  const long long blocks = (words + 255) / 256;
  hysteresis_unpack<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                      (cudaStream_t)stream>>>(state, out, words, w, ww,
                                              vec_out);
  return (int)cudaGetLastError();
}
