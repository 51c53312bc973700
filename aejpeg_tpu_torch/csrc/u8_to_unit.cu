// Exact uint8 -> float32 x/255 of any-shape contiguous bytes, flat.
//
// Replaces the Pallas TPU kernel aejpeg_tpu/ops/pallas_kernels.py
// u8_to_unit_lut (_u8_lut_2d, _u8_lut_kernel): a 256-entry table gather.
// The TPU kernel viewed the array as (64k, 128m) tiles and split the table
// into two 128-lane halves because Mosaic gathers within 128 lanes; none of
// that layout is carried over.  Here the array is one flat run of bytes.
//
// Bound on the H100: bytes.  Each element is read once (1 byte) and written
// once (4 bytes); the work is one table lookup.  Each warp reads 32
// neighbouring 16-byte chunks (one uint4 a lane) into shared memory, then
// writes their 128 float4s with neighbouring lanes on neighbouring float4s
// (lane l writes float4 j*32 + l, the lookups of the staged 4-byte word
// j*32 + l), so loads and stores are both coalesced; each lane storing its
// own chunk's four float4s would scatter every store instruction across a
// 64-byte stride.  The 1 KB table sits in shared memory.  Elements before
// the first 16-byte aligned input byte and after the last whole chunk, and
// every element when the input and output cannot both be vector-aligned,
// take a masked scalar path.  The table holds numpy's
// np.arange(256, dtype=np.float32) / 255, so the result equals
// x.astype(np.float32) / 255 bit for bit; the kernel never divides.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ float4 lookup4(const float* tab, unsigned w) {
  return make_float4(tab[w & 255u], tab[(w >> 8) & 255u],
                     tab[(w >> 16) & 255u], tab[w >> 24]);
}

__global__ void __launch_bounds__(kThreads)
u8_to_unit_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ table, long long n,
                  long long head, long long n16) {
  __shared__ float tab[256];
  __shared__ uint4 stage[kThreads];
  tab[threadIdx.x] = table[threadIdx.x];  // kThreads == 256
  __syncthreads();

  // vector body: 16-byte chunks starting at element `head`, 32 a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned* words = reinterpret_cast<const unsigned*>(stage + warp * 32);
  const uint4* in16 = reinterpret_cast<const uint4*>(in + head);
  float4* out4 = reinterpret_cast<float4*>(out + head);
  const long long n_warp_chunks = (n16 + 31) / 32;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long wc = static_cast<long long>(blockIdx.x) * kWarps + warp;
       wc < n_warp_chunks; wc += warp_stride) {
    const long long c = wc * 32 + lane;
    if (c < n16) stage[warp * 32 + lane] = __ldg(in16 + c);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = j * 32 + lane;
      if (wc * 32 + f / 4 < n16) out4[wc * 128 + f] = lookup4(tab, words[f]);
    }
    __syncwarp();
  }

  // scalar remainder: the `head` elements, then the tail after the body
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long body_end = head + 16 * n16;
  const long long n_rest = head + (n - body_end);
  for (long long r = tid; r < n_rest; r += stride) {
    const long long i = r < head ? r : body_end + (r - head);
    out[i] = tab[in[i]];
  }
}

}  // namespace

extern "C" int aej_u8_to_unit(const void* in, void* out, const void* table,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t ia = reinterpret_cast<uintptr_t>(in);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  long long head = static_cast<long long>((16 - ia % 16) % 16);
  long long n16 = 0;
  // vector path only when both the input chunk and its 64 output bytes
  // start 16-byte aligned
  if (head < n && (oa + 4 * static_cast<uintptr_t>(head)) % 16 == 0) {
    n16 = (n - head) / 16;
  } else {
    head = n;
  }
  const long long units = n16 > (n - 16 * n16) ? n16 : (n - 16 * n16);
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  u8_to_unit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<float*>(out),
      static_cast<const float*>(table), n, head, n16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Rounded float32 -> the same unit floats, flat (aej_f32_to_unit).
//
// encode_batch's CUDA route uploads the images' float32 pixels and rounds
// them here, in the pass that u8_to_unit makes of uint8 ones: k = rint(x *
// 255) (one IEEE product, rounded half to even: numpy's
// np.rint(np.multiply(x, np.float32(255)))), clamped to [0, 255] with NaN
// at 0, then the same table[k].  That is one pass where the host's rounding
// to uint8, a uint8 upload and u8_to_unit's gather took three.  `out` may
// be `in` (in place: each element is read and then written by one thread).
// With `flags` (one zeroed int32 a run of `per` elements: an image), the
// kernel also sets flags[i / per] to 1 where table[k] != x, numpy's
// array_equal of the round trip: that image is not exactly uint8 / 255.
// Bound on the H100: bytes, 4 read and 4 written an element.  Both pointers
// 16-byte aligned: float4 loads and stores, a grid-stride loop, the tail
// of n % 4 elements scalar; else every element scalar.

namespace {

__device__ __forceinline__ float round_unit(const float* tab, float x,
                                            bool& bad) {
  const float r = rintf(__fmul_rn(x, 255.0f));
  const int k = r >= 255.0f ? 255 : (r > 0.0f ? static_cast<int>(r) : 0);
  const float u = tab[k];
  bad = u != x;
  return u;
}

__device__ __forceinline__ void flag(int* flags, long long i, long long per) {
  int* f = flags + i / per;
  if (*f == 0) *f = 1;  // read first: not a store from every element
}

__global__ void __launch_bounds__(kThreads)
f32_to_unit_kernel(const float* in, float* out,
                   const float* __restrict__ table, int* flags, long long n,
                   long long per, long long n4) {
  __shared__ float tab[256];
  tab[threadIdx.x] = table[threadIdx.x];  // kThreads == 256
  __syncthreads();

  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long c = tid; c < n4; c += stride) {
    const float4 x = in4[c];
    bool b0, b1, b2, b3;
    const float4 u = make_float4(round_unit(tab, x.x, b0),
                                 round_unit(tab, x.y, b1),
                                 round_unit(tab, x.z, b2),
                                 round_unit(tab, x.w, b3));
    out4[c] = u;
    if (flags != nullptr && (b0 | b1 | b2 | b3)) {
      if (b0) flag(flags, 4 * c, per);
      if (b1) flag(flags, 4 * c + 1, per);
      if (b2) flag(flags, 4 * c + 2, per);
      if (b3) flag(flags, 4 * c + 3, per);
    }
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    bool bad;
    out[i] = round_unit(tab, in[i], bad);
    if (flags != nullptr && bad) flag(flags, i, per);
  }
}

}  // namespace

extern "C" int aej_f32_to_unit(const void* in, void* out, const void* table,
                               void* flags, long long n, long long per,
                               void* stream) {
  if (n <= 0) return 0;
  if (per <= 0) return -1;
  const uintptr_t ia = reinterpret_cast<uintptr_t>(in);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const long long n4 = (ia % 16 == 0 && oa % 16 == 0) ? n / 4 : 0;
  const long long units = n4 > (n - 4 * n4) ? n4 : (n - 4 * n4);
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  f32_to_unit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const float*>(table), static_cast<int*>(flags), n, per,
      n4);
  return static_cast<int>(cudaGetLastError());
}
