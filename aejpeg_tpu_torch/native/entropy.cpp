// Native entropy backend for the .ajpg coefficient streams.
//
// Three jobs the Python/zlib path can't do fast enough at pod scale:
//   1. deflate_parallel: compress ONE logical zlib stream from N threads by
//      deflating independent chunks with Z_FULL_FLUSH boundaries and
//      splicing them.  The result is a single spec-valid zlib stream
//      (RFC 1950) that any inflater (including the reference decoder's
//      zlib.decompress) accepts.  Byte-identity with single-threaded
//      zlib-9 is intentionally NOT preserved in parallel mode; pass
//      threads=1 for byte parity with the reference encoder.
//   2. level < 0 selects the SPARSE encoder: a hand-rolled deflate encoder
//      specialized for the .ajpg coefficient distribution (int32 LE, mostly
//      zero).  It tokenizes byte runs (literal + distance-1 matches, the
//      Z_RLE token set) with word-at-a-time zero skipping and emits one
//      dynamic-Huffman block per chunk — ~5-10x the throughput of zlib
//      while keeping the dominant zero-run compression.  Output is still a
//      plain spec-valid zlib stream; zlib.decompress reads it.
//   3. inflate: plain decompression (bounded output).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: see build.py (g++ -O3 -shared -fPIC entropy.cpp -lz -lpthread).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

struct ChunkResult {
  std::vector<unsigned char> data;
  bool ok = false;
  uint32_t adler = 1;  // adler32 of the chunk's plaintext (sparse paths)
};

// Adler32 computed from run structure instead of a separate byte pass.
// All accumulation is deferred-mod uint64: between reduce() calls at most
// 2^22 plaintext bytes are absorbed, keeping every intermediate product
// < 2^63 (worst case: c*(L*(L+1)/2) = 255 * (2^22)^2/2 ~ 2.2e15).
struct RunAdler {
  uint64_t a = 1, b = 0, since = 0;
  inline void reduce() {
    a %= 65521;
    b %= 65521;
    since = 0;
  }
  inline void absorbed(uint64_t nbytes) {
    since += nbytes;
    if (since >= (1u << 22)) reduce();
  }
  // run of `m` zero bytes: a unchanged, b += m*a
  inline void zero_run(uint64_t m) {
    b += m * a;
    absorbed(m);
  }
  // run of L copies of byte c
  inline void byte_run(unsigned c, uint64_t L) {
    b += L * a + static_cast<uint64_t>(c) * (L * (L + 1) / 2);
    a += L * c;
    absorbed(L);
  }
  inline void byte(unsigned c) {
    a += c;
    b += a;
    absorbed(1);
  }
  // r repetitions of the 4-byte word (lo, hi, sb, sb) — one widened int16
  inline void word_rep(unsigned lo, unsigned hi, unsigned sb, uint64_t r) {
    uint64_t S = lo + hi + 2ull * sb;          // per-word sum
    uint64_t T = 4ull * lo + 3ull * hi + 3ull * sb;  // weighted in-word sum
    b += 4 * r * a + 4 * S * (r * (r - 1) / 2) + r * T;
    a += r * S;
    absorbed(4 * r);
  }
  // r == 1 fast path (the overwhelmingly common single coefficient)
  inline void word_one(unsigned lo, unsigned hi, unsigned sb) {
    uint64_t S = lo + hi + 2ull * sb;
    b += 4 * a + 4ull * lo + 3ull * hi + 3ull * sb;
    a += S;
    absorbed(4);
  }
  // one 128-byte block absorbed wholesale: S = sum of its bytes,
  // W = sum over bytes of (128 - j) * byte_j (j = in-block offset)
  inline void block128(uint64_t S, uint64_t W) {
    b += 128 * a + W;
    a += S;
    absorbed(128);
  }
  uint32_t value() {
    reduce();
    return static_cast<uint32_t>((b << 16) | a);
  }
};

// adler32(A || B) from adler32(A), adler32(B), len(B)  (zlib combine rule)
inline uint32_t adler_join(uint32_t ad1, uint32_t ad2, uint64_t len2) {
  const uint32_t MOD = 65521;
  uint64_t rem = len2 % MOD;
  uint64_t a1 = ad1 & 0xFFFF, b1 = ad1 >> 16;
  uint64_t a2 = ad2 & 0xFFFF, b2 = ad2 >> 16;
  uint64_t a = (a1 + a2 + MOD - 1) % MOD;
  uint64_t b = (b1 + b2 + rem * (a1 + MOD - 1) % MOD + MOD) % MOD;
  return static_cast<uint32_t>((b << 16) | a);
}

// ------------------------------------------------------------------ sparse
// Hand-rolled deflate encoder (RFC 1951) with the Z_RLE token set.

// RFC 1951 length code table (symbols 257..285)
static const uint16_t LBASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                   15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                   67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LBITS[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                  2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
                                  0};

struct LenLookup {
  uint8_t idx[259];  // match length 3..258 -> index into LBASE/LBITS
  LenLookup() {
    for (int c = 28; c >= 0; --c) {
      int hi = (c == 28) ? 258 : LBASE[c + 1] - 1;
      for (int l = LBASE[c]; l <= hi && l <= 258; ++l) idx[l] = c;
    }
    idx[258] = 28;
  }
};
static const LenLookup kLen;

inline uint32_t bit_reverse(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) {
    r = (r << 1) | (code & 1);
    code >>= 1;
  }
  return r;
}

// Length-limited Huffman code lengths (zlib tree.c overflow adjustment,
// with an exact integer Kraft restoration loop).  Returns the number of
// used symbols.
// Deflate permits 15-bit codes; our encoder caps lengths at 12 so the
// matching inflater can decode from flat 4096-entry (8 KB, L1-resident)
// tables — the 32768-entry tables a 15-bit limit forces live in L2 and
// cost ~14 cycles per symbol lookup.  Measured ratio cost of the shorter
// limit on LIVE coefficient streams: < 0.05%.  Foreign streams with
// longer codes (e.g. real zlib level-9 output) take the zlib fallback,
// which they already did for their general LZ77 distances.
constexpr int kMaxCodeLen = 12;

int huffman_lengths(const uint64_t* freq, int n, int limit, uint8_t* lens) {
  std::memset(lens, 0, n);
  std::vector<int> used;
  for (int i = 0; i < n; ++i)
    if (freq[i]) used.push_back(i);
  if (used.empty()) return 0;
  if (used.size() == 1) {
    lens[used[0]] = 1;
    return 1;
  }
  // heap-free Huffman over sorted leaves (two-queue method)
  int m = static_cast<int>(used.size());
  std::vector<int> order(used);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return freq[a] < freq[b]; });
  std::vector<uint64_t> w(2 * m);        // node weights
  std::vector<int> parent(2 * m, -1);
  for (int i = 0; i < m; ++i) w[i] = freq[order[i]];
  int leaf = 0, internal = m, next = m;
  auto take = [&]() {
    int pick;
    if (leaf < m && (internal >= next || w[leaf] <= w[internal]))
      pick = leaf++;
    else
      pick = internal++;
    return pick;
  };
  for (; next < 2 * m - 1; ++next) {
    int a = take(), b = take();
    w[next] = w[a] + w[b];
    parent[a] = next;
    parent[b] = next;
  }
  // depth per leaf: walk up (tree height <= m)
  std::vector<int> depth(m);
  for (int i = 0; i < m; ++i) {
    int d = 0;
    for (int x = i; parent[x] >= 0; x = parent[x]) ++d;
    depth[i] = d;
  }
  // clamp to limit; restore Kraft == 1 exactly
  std::vector<int> bl_count(limit + 2, 0);
  for (int i = 0; i < m; ++i)
    bl_count[depth[i] > limit ? limit : depth[i]]++;
  int64_t kraft = 0;
  for (int l = 1; l <= limit; ++l)
    kraft += static_cast<int64_t>(bl_count[l]) << (limit - l);
  int64_t target = static_cast<int64_t>(1) << limit;
  while (kraft > target) {
    int bits = limit - 1;
    while (bl_count[bits] == 0) bits--;
    bl_count[bits]--;
    bl_count[bits + 1] += 2;
    bl_count[limit]--;
    kraft -= 1;
  }
  // assign lengths: most frequent symbols get the shortest codes
  int pos = m - 1;  // order[] is ascending by freq
  for (int l = 1; l <= limit; ++l)
    for (int c = 0; c < bl_count[l]; ++c) lens[order[pos--]] = l;
  return m;
}

// canonical codes from lengths, pre-bit-reversed for LSB-first emission
void canonical_codes(const uint8_t* lens, int n, int limit, uint16_t* codes) {
  std::vector<int> bl_count(limit + 1, 0);
  for (int i = 0; i < n; ++i) bl_count[lens[i]]++;
  bl_count[0] = 0;
  std::vector<uint32_t> next(limit + 1, 0);
  uint32_t code = 0;
  for (int l = 1; l <= limit; ++l) {
    code = (code + bl_count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i)
    codes[i] =
        lens[i] ? static_cast<uint16_t>(bit_reverse(next[lens[i]]++, lens[i]))
                : 0;
}

// tokenizer: byte runs (dist-1 matches, the Z_RLE token set) plus dist-4
// matches for repeated int32 patterns.  Emitter: lit(b), match(len, dist)
// with dist in {1, 4}.
template <typename E>
inline void scan_tokens(const unsigned char* p, size_t n, E&& e,
                        RunAdler* ad = nullptr) {
  size_t i = 0;
  while (i < n) {
    unsigned char b = p[i];
    size_t j = i + 1;
    if (b == 0) {
      while (j + 8 <= n) {
        uint64_t wv;
        std::memcpy(&wv, p + j, 8);
        if (wv != 0) break;
        j += 8;
      }
      while (j < n && p[j] == 0) ++j;
    } else {
      while (j < n && p[j] == b) ++j;
    }
    size_t run = j - i;
    if (run >= 4) {
      if (ad) ad->byte_run(b, run);
      e.lit(b);
      size_t rem = run - 1;
      while (rem >= 3) {
        size_t l = rem < 258 ? rem : 258;
        e.match(l, 1);
        rem -= l;
      }
      while (rem--) e.lit(b);
      i = j;
      continue;
    }
    // short run: probe a distance-4 match (repeated int32 values, e.g.
    // runs of quantized +/-1 coefficients)
    if (i >= 4) {
      size_t lim = n - i < 258 ? n - i : 258;
      size_t l = 0;
      while (l < lim && p[i + l] == p[i - 4 + l]) ++l;
      if (l >= 6) {
        if (ad)
          for (size_t k = 0; k < l; ++k) ad->byte(p[i + k]);
        e.match(l, 4);
        i += l;
        continue;
      }
    }
    if (ad) ad->byte_run(b, run);
    for (size_t k = 0; k < run; ++k) e.lit(b);
    i = j;
  }
}

// Tokenize-once sink: records the token sequence (u16: <0x8000 literal,
// else bit14 = dist-4 flag + low bits = match length) while counting
// frequencies, so the emit pass replays tokens instead of rescanning the
// input bytes — the byte scan is the dominant cost of the sparse encoder.
// Tokens go into a caller-provided buffer (no capacity checks in the hot
// loop; callers size it to the 1-token-per-byte worst case).
struct TokenRecorder {
  uint16_t* toks = nullptr;
  size_t ntok = 0;
  uint64_t freq[286] = {0};
  uint64_t dfreq[30] = {0};
  inline void lit(unsigned char b) {
    toks[ntok++] = b;
    freq[b]++;
  }
  inline void match(size_t len, int dist) {
    toks[ntok++] = static_cast<uint16_t>(0x8000 | (dist == 4 ? 0x4000 : 0) |
                                         len);
    freq[257 + kLen.idx[len]]++;
    dfreq[dist == 1 ? 0 : 3]++;
  }
};

// Per-thread token scratch, sized for `cap` tokens (worst case: one token
// per plaintext byte).
inline uint16_t* token_scratch(size_t cap) {
  thread_local std::vector<uint16_t> buf;
  if (buf.size() < cap) buf.resize(cap);
  return buf.data();
}

// emit the code-length sequence with RLE symbols 16/17/18
template <typename Sink>
void cl_rle(const uint8_t* lens, int n, Sink&& sink) {
  int i = 0;
  while (i < n) {
    uint8_t v = lens[i];
    int j = i + 1;
    while (j < n && lens[j] == v) ++j;
    int run = j - i;
    if (v == 0) {
      while (run >= 3) {
        int r = run < 138 ? run : 138;
        if (r > 10)
          sink(18, r - 11, 7);
        else
          sink(17, r - 3, 3);
        run -= r;
      }
      while (run--) sink(0, 0, 0);
    } else {
      sink(v, 0, 0);
      run--;
      while (run >= 3) {
        int r = run < 6 ? run : 6;
        sink(16, r - 3, 2);
        run -= r;
      }
      while (run--) sink(v, 0, 0);
    }
    i = j;
  }
}

static const int CLORDER[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                11, 4, 12, 3, 13, 2, 14, 1, 15};

// stored (type-0) blocks for a chunk; ends byte-aligned by construction
void emit_stored(const unsigned char* src, size_t n, bool last,
                 std::vector<unsigned char>* out) {
  size_t off = 0;
  do {
    size_t m = n - off < 65535 ? n - off : 65535;
    bool fin = last && (off + m == n);
    out->push_back(fin ? 1 : 0);  // BFINAL + BTYPE=00, byte-aligned
    out->push_back(static_cast<unsigned char>(m & 0xFF));
    out->push_back(static_cast<unsigned char>(m >> 8));
    out->push_back(static_cast<unsigned char>(~m & 0xFF));
    out->push_back(static_cast<unsigned char>((~m >> 8) & 0xFF));
    if (m) out->insert(out->end(), src + off, src + off + m);
    off += m;
  } while (off < n);
}

// Advance past the zero run starting at v[i]: returns the first j >= i
// with v[j] != 0 (or n).  Quantized coefficient planes are mostly zero
// (85-98% measured on LIVE), so this is the hottest loop of the sparse
// encoder; target_clones gives it 512/256-bit compares with runtime ifunc
// dispatch while the .so stays baseline-buildable.
__attribute__((target_clones("arch=x86-64-v4", "arch=x86-64-v3", "default")))
size_t zero_span16(const int16_t* v, size_t i, size_t n) {
  while (i + 32 <= n) {
    // one 64-byte block per iteration; vectorizes to 1-2 compares
    uint64_t acc = 0;
    for (int k = 0; k < 8; ++k) {
      uint64_t w;
      std::memcpy(&w, v + i + 4 * k, 8);
      acc |= w;
    }
    if (acc) break;
    i += 32;
  }
  while (i + 4 <= n) {
    uint64_t w;
    std::memcpy(&w, v + i, 8);
    if (w != 0) break;
    i += 4;
  }
  while (i < n && v[i] == 0) ++i;
  return i;
}

// Raw-pointer bit writer: the caller preallocates the exact output size
// (computable from the frequency tables), so the hot token loop has no
// capacity checks or vector resizes.
class PtrBitWriter {
 public:
  explicit PtrBitWriter(unsigned char* out) : out_(out) {}
  inline void put(uint32_t bits, int n) {
    hold_ |= static_cast<uint64_t>(bits) << nbits_;
    nbits_ += n;
    if (nbits_ >= 32) {
      std::memcpy(out_, &hold_, 4);  // little-endian hosts only
      out_ += 4;
      hold_ >>= 32;
      nbits_ -= 32;
    }
  }
  // up to 40 bits in one call.  put() keeps nbits_ < 32; if the incoming
  // bits would not fit the 64-bit hold, flush whole BYTES first (write 4,
  // advance nbits_/8 — the partial 4th byte is rewritten by the next
  // flush), leaving nbits_ <= 7 so 40 more always fit.
  inline void put64(uint64_t bits, int n) {
    if (nbits_ + n > 64) {
      int fl = nbits_ & ~7;
      std::memcpy(out_, &hold_, 4);
      out_ += fl >> 3;
      hold_ >>= fl;
      nbits_ -= fl;
    }
    hold_ |= bits << nbits_;
    nbits_ += n;
    while (nbits_ >= 32) {
      std::memcpy(out_, &hold_, 4);
      out_ += 4;
      hold_ >>= 32;
      nbits_ -= 32;
    }
  }
  void align() {
    while (nbits_ > 0) {
      *out_++ = static_cast<unsigned char>(hold_ & 0xFF);
      hold_ >>= 8;
      nbits_ -= 8;
    }
    hold_ = 0;
    nbits_ = 0;
  }
  unsigned char* pos() const { return out_; }

 private:
  unsigned char* out_;
  uint64_t hold_ = 0;
  int nbits_ = 0;
};

// Shared Huffman-block emitter: tables + header + token replay from a
// TokenRecorder.  Appends the dynamic-Huffman block (plus sync flush if not
// last) to *body; output size is computed exactly up front.
//
// emit_block_with is the shared skeleton: Huffman tables, header, exact
// output size from the frequency tables, EOB and sync flush; the token
// section itself is produced by `replay(bw, ll_ent, d_codes, d_lens)` —
// either the byte-token loop (emit_token_block) or the coefficient-token
// loop (emit_coeff_tokens), both of which must emit bits consistent with
// the freq tables they recorded.
template <typename Replay>
void emit_block_with(const uint64_t* freq, const uint64_t* dfreq, bool last,
                     std::vector<unsigned char>* body, Replay&& replay) {
  uint8_t ll_lens[286];
  huffman_lengths(freq, 286, kMaxCodeLen, ll_lens);
  uint8_t d_lens[30] = {0};
  if (huffman_lengths(dfreq, 30, kMaxCodeLen, d_lens) == 0) d_lens[0] = 1;

  uint16_t ll_codes[286], d_codes[30];
  canonical_codes(ll_lens, 286, kMaxCodeLen, ll_codes);
  canonical_codes(d_lens, 30, kMaxCodeLen, d_codes);

  int hlit = 286;
  while (hlit > 257 && ll_lens[hlit - 1] == 0) hlit--;
  int hdist = d_lens[3] ? 4 : 1;

  std::vector<uint8_t> seq(ll_lens, ll_lens + hlit);
  seq.insert(seq.end(), d_lens, d_lens + hdist);
  uint64_t cl_freq[19] = {0};
  cl_rle(seq.data(), static_cast<int>(seq.size()),
         [&](int sym, int, int) { cl_freq[sym]++; });
  uint8_t cl_lens[19];
  int cl_used = huffman_lengths(cl_freq, 19, 7, cl_lens);
  if (cl_used == 1) {
    for (int i = 0; i < 19; ++i)
      if (cl_freq[i]) {
        cl_lens[(i + 1) % 19] = 1;
        break;
      }
  }
  uint16_t cl_codes[19];
  canonical_codes(cl_lens, 19, 7, cl_codes);
  int hclen = 19;
  while (hclen > 4 && cl_lens[CLORDER[hclen - 1]] == 0) hclen--;

  // exact bit count: header + code-length section + token section
  uint64_t bits = 3 + 5 + 5 + 4 + 3ull * hclen;
  cl_rle(seq.data(), static_cast<int>(seq.size()),
         [&](int sym, int, int ebits) { bits += cl_lens[sym] + ebits; });
  for (int i = 0; i < 286; ++i) bits += freq[i] * ll_lens[i];
  for (int c = 0; c < 29; ++c) bits += freq[257 + c] * LBITS[c];
  bits += dfreq[0] * d_lens[0] + dfreq[3] * d_lens[3];
  if (!last) bits += 3;  // empty stored block header (sync flush)
  size_t out_bytes = (bits + 7) / 8 + (last ? 0 : 4);

  size_t base = body->size();
  body->resize(base + out_bytes + 8);  // +8: 32-bit flush slack
  PtrBitWriter bw(body->data() + base);
  bw.put(last ? 1 : 0, 1);
  bw.put(2, 2);  // dynamic huffman
  bw.put(hlit - 257, 5);
  bw.put(hdist - 1, 5);
  bw.put(hclen - 4, 4);
  for (int i = 0; i < hclen; ++i) bw.put(cl_lens[CLORDER[i]], 3);
  cl_rle(seq.data(), static_cast<int>(seq.size()),
         [&](int sym, int extra, int ebits) {
           bw.put(cl_codes[sym], cl_lens[sym]);
           if (ebits) bw.put(extra, ebits);
         });

  // fused code|len entries: one load per literal, and the match's
  // length-code + extra bits + distance code combined into a single put
  // (<= 15+5+15 = 35 bits, within the 64-bit hold) — same bit stream,
  // fewer flush checks
  uint32_t ll_ent[286];
  for (int i = 0; i < 286; ++i)
    ll_ent[i] = ll_codes[i] | (static_cast<uint32_t>(ll_lens[i]) << 16);
  replay(bw, ll_ent, d_codes, d_lens);
  bw.put(ll_codes[256], ll_lens[256]);  // EOB
  if (!last) {
    bw.put(0, 1);
    bw.put(0, 2);
    bw.align();
    unsigned char* p = bw.pos();
    p[0] = 0x00;
    p[1] = 0x00;
    p[2] = 0xFF;
    p[3] = 0xFF;
  } else {
    bw.align();
  }
  body->resize(base + out_bytes);
}

void emit_token_block(const TokenRecorder& fc, bool last,
                      std::vector<unsigned char>* body) {
  emit_block_with(
      fc.freq, fc.dfreq, last, body,
      [&](PtrBitWriter& bw, const uint32_t* ll_ent, const uint16_t* d_codes,
          const uint8_t* d_lens) {
        const uint16_t* toks = fc.toks;
        for (size_t ti = 0; ti < fc.ntok; ++ti) {
          uint16_t t = toks[ti];
          if (t < 0x8000) {
            uint32_t e = ll_ent[t];
            bw.put(e & 0xFFFF, static_cast<int>(e >> 16));
          } else {
            int len = t & 0x3FFF;
            int c = kLen.idx[len];
            uint32_t e = ll_ent[257 + c];
            uint64_t bits = e & 0xFFFF;
            int nb = static_cast<int>(e >> 16);
            if (LBITS[c]) {
              bits |= static_cast<uint64_t>(len - LBASE[c]) << nb;
              nb += LBITS[c];
            }
            int ds = (t & 0x4000) ? 3 : 0;
            bits |= static_cast<uint64_t>(d_codes[ds]) << nb;
            nb += d_lens[ds];
            bw.put64(bits, nb);
          }
        }
      });
}

// ------------------------------------------------- coefficient-token path
// The byte-token scan above costs one recorded token + one freq increment
// per WIDENED BYTE of every nonzero coefficient (4 bytes each), and the
// emit pass replays those byte tokens one Huffman put at a time — together
// they dominated the host assemble stage.  The coefficient-granular path
// records ONE u32 token per zero run / nonzero value / value run, counts
// frequencies with O(1) closed forms, and emits a whole coefficient's
// literal codes with a single table lookup + put64.  The CHOSEN token
// sequence (lit/match decisions and the resulting bit stream) is exactly
// the one scan_coeffs + emit_token_block produced, so outputs stay
// byte-identical; only the bookkeeping granularity changed.

struct CoeffScan {
  // u32 tokens: 0x80000000|n = run of n zero BYTES; 0x40000000|u16(v)
  // followed by a bare u32 rep = repeated nonzero value; 0x20000000|
  // (zrun<<16)|u16(v) = single nonzero coefficient immediately followed by
  // a zero run of zrun (< 2^13) bytes (the dominant pattern in quantized
  // coefficient data — merging it halves replay loop iterations and makes
  // the token-type branch predictable); else u16(v) != 0 = single nonzero
  // coefficient.  All formats emit identical bits, so mixed producers
  // (AVX-512 scan merges, the scalar fallback doesn't) stay byte-identical.
  uint32_t* toks = nullptr;
  size_t ntok = 0;
  uint64_t freq[286] = {0};
  uint64_t dfreq[30] = {0};
};

inline uint32_t* coeff_token_scratch(size_t cap) {
  thread_local std::vector<uint32_t> buf;
  if (buf.size() < cap) buf.resize(cap);
  return buf.data();
}

// Frequency contribution of flush_z(zrun = n bytes): lit(0), then matches
// of 258 while rem >= 3 (min(rem, 258)), else trailing lit(0)s.
static inline void zrun_account(uint64_t n, uint64_t* freq,
                                uint64_t* dfreq) {
  if (n >= 4) {
    freq[0]++;
    uint64_t rem = n - 1;
    uint64_t k = rem / 258, r = rem % 258;
    freq[257 + 28] += k;  // length-258 code
    dfreq[0] += k;
    if (r >= 3) {
      freq[257 + kLen.idx[r]]++;
      dfreq[0]++;
    } else {
      freq[0] += r;
    }
  } else {
    freq[0] += n;
  }
}

// Frequency contribution of a value run's match chain: rem4 = (rep-1)*4
// bytes in matches of min(rem, 256) (multiples of 4, so no sub-3 tail).
static inline void run_account(uint64_t rem4, uint64_t* freq,
                               uint64_t* dfreq) {
  uint64_t k = rem4 / 256, r = rem4 % 256;
  freq[257 + kLen.idx[256]] += k;
  dfreq[3] += k;
  if (r) {
    freq[257 + kLen.idx[r]]++;
    dfreq[3]++;
  }
}

// scan_coeffs with coefficient-granular recording: same zero-span SIMD,
// same token choices, same RunAdler — but one token and O(1) freq updates
// per run/value instead of per widened byte.
//
// On AVX-512BW hosts (the build is -march=native) the classification runs
// mask-driven: one 512-bit load + compare per 32 coefficients, nonzero
// positions iterated with tzcnt, zero gaps accounted lazily in O(1) per
// gap.  The word-at-a-time scalar traversal this replaces spent ~70% of
// the scan walking zeros (42 of 60 ms on the LIVE bench batch).  Tokens,
// frequencies and adler are identical to the scalar path (same stream
// order), which the fallback below remains for non-AVX-512 builds.
#if defined(__AVX512BW__)
void scan_coeffs_fast(const int16_t* v, size_t n, CoeffScan& cs,
                      RunAdler* ad) {
  uint64_t zrun = 0;
  bool last_single = false;  // toks[ntok-1] is a bare single-coeff token
  auto flush_z = [&]() {
    if (zrun) {
      zrun_account(zrun, cs.freq, cs.dfreq);
      if (last_single && zrun < (1u << 13)) {
        cs.toks[cs.ntok - 1] |=
            0x20000000u | (static_cast<uint32_t>(zrun) << 16);
      } else {
        cs.toks[cs.ntok++] = 0x80000000u | static_cast<uint32_t>(zrun);
      }
      zrun = 0;
    }
    last_single = false;
  };
  size_t i = 0;     // everything before i is consumed (zeros before it may
                    // still be pending: they live in [zstart, i))
  size_t zstart = 0;  // first unaccounted position (start of pending zeros)
  auto settle_zeros = [&](size_t upto) {
    // account the zero gap [zstart, upto) — all positions there are zero
    // (adler is block-computed above, not per token)
    if (upto > zstart) zrun += (upto - zstart) * 4;
  };
  size_t base = 0;
  while (base < n) {
    if (base + 32 <= i) {  // consumed by a value run that crossed blocks
      // block128 above only covers blocks the mask loop visits; a block
      // fully inside a cross-block value run is skipped here, so its 128
      // widened bytes must still be absorbed or the zlib adler32 trailer
      // is wrong (strict decoders — zlib, the reference's jpeg.py — then
      // reject the container).  Every coefficient in it equals the run
      // value, so the closed-form repeat update covers the whole block.
      if (ad) {
        int16_t x = v[base];
        unsigned u = static_cast<uint16_t>(x);
        ad->word_rep(u & 0xFF, (u >> 8) & 0xFF, x < 0 ? 0xFFu : 0x00u, 32);
      }
      base += 32;
      continue;
    }
    uint32_t mask;
    size_t blk;
    if (base + 32 <= n) {
      blk = 32;
      __m512i x = _mm512_loadu_si512(
          reinterpret_cast<const void*>(v + base));
      mask = _mm512_cmpneq_epi16_mask(x, _mm512_setzero_si512());
      if (ad) {
        // adler of the widened byte stream, one closed-form update per
        // 128-byte block — the per-token a/b dependency chains were ~10
        // serial cycles per nonzero.  Bytes of coefficient c (offset
        // j = 4c..4c+3) are (lo, hi, sb, sb), so
        //   S  = sum S_c,  S_c = lo + hi + 2*sb
        //   W  = sum (128-j)*byte_j
        //      = 128*S - 4*sum c*S_c - sum (hi_c + 5*sb_c)
        const __m512i ff = _mm512_set1_epi16(0xFF);
        const __m512i ones16 = _mm512_set1_epi16(1);
        __m512i lo16 = _mm512_and_si512(x, ff);
        __m512i hi16 = _mm512_srli_epi16(x, 8);
        __mmask32 mneg = _mm512_movepi16_mask(x);
        __m512i s16 = _mm512_add_epi16(
            _mm512_add_epi16(lo16, hi16),
            _mm512_maskz_mov_epi16(mneg, _mm512_set1_epi16(510)));
        const __m512i cidx = _mm512_set_epi16(
            31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
            16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
        // s16 <= 1020, cidx <= 31: madd products fit int32
        __m512i s_sum32 = _mm512_madd_epi16(s16, ones16);
        __m512i cs32 = _mm512_madd_epi16(s16, cidx);
        __m512i hi_sum32 = _mm512_madd_epi16(hi16, ones16);
        uint64_t S = static_cast<uint64_t>(_mm512_reduce_add_epi32(s_sum32));
        uint64_t cS = static_cast<uint64_t>(_mm512_reduce_add_epi32(cs32));
        uint64_t hiS =
            static_cast<uint64_t>(_mm512_reduce_add_epi32(hi_sum32));
        uint64_t sbS = 255ull * static_cast<unsigned>(
            __builtin_popcount(static_cast<uint32_t>(mneg)));
        uint64_t W = 128 * S - 4 * cS - (hiS + 5 * sbS);
        ad->block128(S, W);
      }
    } else {
      blk = n - base;
      mask = 0;
      for (size_t k = 0; k < blk; ++k) {
        int16_t xv = v[base + k];
        if (xv) mask |= 1u << k;
        if (ad) {
          if (xv == 0) {
            ad->zero_run(4);
          } else {
            unsigned uu = static_cast<uint16_t>(xv);
            ad->word_one(uu & 0xFF, (uu >> 8) & 0xFF, xv < 0 ? 0xFF : 0);
          }
        }
      }
    }
    while (mask) {
      unsigned p = static_cast<unsigned>(__builtin_ctz(mask));
      mask &= mask - 1;
      size_t pos = base + p;
      if (pos < i) continue;  // inside an already-consumed value run
      settle_zeros(pos);
      i = pos;
      int16_t x = v[i];
      unsigned u = static_cast<uint16_t>(x);
      unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
      if (i + 1 >= n || v[i + 1] != x) {
        flush_z();
        unsigned neg = static_cast<unsigned>(x < 0);
        unsigned sb = neg ? 0xFFu : 0x00u;
        unsigned hi_ne_sb = static_cast<unsigned>(hi != sb);
        cs.freq[lo]++;
        cs.freq[hi] += hi_ne_sb;
        cs.freq[0xFF] += neg * (3 - hi_ne_sb);
        zrun = (1 - neg) * (3 - hi_ne_sb);
        cs.toks[cs.ntok++] = u;
        last_single = true;
        ++i;
      } else {
        size_t j = i + 2;
        while (j < n && v[j] == x) ++j;
        size_t rep = j - i;
        flush_z();
        unsigned sb = x < 0 ? 0xFF : 0x00;
        cs.freq[lo]++;
        cs.freq[hi]++;
        cs.freq[sb] += 2;
        run_account((rep - 1) * 4, cs.freq, cs.dfreq);
        cs.toks[cs.ntok++] = 0x40000000u | u;
        cs.toks[cs.ntok++] = static_cast<uint32_t>(rep);
        i = j;
      }
      zstart = i;
    }
    base += blk;
  }
  settle_zeros(n);
  flush_z();
}

[[maybe_unused]] void scan_coeffs_scalar(const int16_t* v, size_t n,
                                          CoeffScan& cs, RunAdler* ad) {
#else
void scan_coeffs_fast(const int16_t* v, size_t n, CoeffScan& cs,
                      RunAdler* ad) {
#endif
  uint64_t zrun = 0;
  auto flush_z = [&]() {
    if (zrun) {
      zrun_account(zrun, cs.freq, cs.dfreq);
      cs.toks[cs.ntok++] = 0x80000000u | static_cast<uint32_t>(zrun);
      zrun = 0;
    }
  };
  size_t i = 0;
  while (i < n) {
    int16_t x = v[i];
    if (x == 0) {
      // word-at-a-time zero span with a tzcnt exit: short runs (the common
      // case between nonzero coefficients) finish on the first load
      // instead of a per-element tail loop
      size_t j = i;
      for (;;) {
        if (j + 4 > n) {
          while (j < n && v[j] == 0) ++j;
          break;
        }
        uint64_t w;
        std::memcpy(&w, v + j, 8);
        if (w != 0) {
          j += static_cast<size_t>(__builtin_ctzll(w)) >> 4;
          break;
        }
        j += 4;
        if (j - i >= 32) {
          j = zero_span16(v, j, n);
          break;
        }
      }
      if (ad) ad->zero_run((j - i) * 4);
      zrun += (j - i) * 4;
      i = j;
      continue;
    }
    unsigned u = static_cast<uint16_t>(x);
    unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
    if (i + 1 >= n || v[i + 1] != x) {
      // single coefficient — the dominant nonzero case; branchless freq /
      // zrun-seed arithmetic (the branchy form cost ~40 cycles per
      // coefficient in mispredicts and dependent counter updates)
      flush_z();
      unsigned neg = static_cast<unsigned>(x < 0);
      unsigned sb = neg ? 0xFFu : 0x00u;
      unsigned hi_ne_sb = static_cast<unsigned>(hi != sb);
      if (ad) ad->word_one(lo, hi, sb);
      cs.freq[lo]++;
      cs.freq[hi] += hi_ne_sb;
      cs.freq[0xFF] += neg * (3 - hi_ne_sb);
      zrun = (1 - neg) * (3 - hi_ne_sb);  // positive tail zeros merge ahead
      cs.toks[cs.ntok++] = u;
      ++i;
      continue;
    }
    size_t j = i + 2;
    while (j < n && v[j] == x) ++j;
    size_t rep = j - i;
    flush_z();
    unsigned sb = x < 0 ? 0xFF : 0x00;
    if (ad) ad->word_rep(lo, hi, sb, rep);
    cs.freq[lo]++;
    cs.freq[hi]++;
    cs.freq[sb] += 2;
    run_account((rep - 1) * 4, cs.freq, cs.dfreq);
    cs.toks[cs.ntok++] = 0x40000000u | u;
    cs.toks[cs.ntok++] = static_cast<uint32_t>(rep);
    i = j;
  }
  flush_z();
}

// Per-value emit LUT: concatenated literal codes of the bytes a SINGLE
// coefficient v in [-512, 512) emits (positives leave their zero tail to
// the following zero run, exactly like the scan).  len 0 = build failed
// (> 57 bits, beyond put64's guarantee) -> slow path.
struct CoeffLut {
  uint64_t bits[1024];
  uint8_t len[1024];
};

inline CoeffLut* coeff_lut_scratch() {
  thread_local CoeffLut lut;
  return &lut;
}

void build_coeff_lut(const uint32_t* ll_ent, CoeffLut* lut) {
  for (int vi = -512; vi < 512; ++vi) {
    int idx = vi + 512;
    unsigned u = static_cast<uint16_t>(static_cast<int16_t>(vi));
    unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
    uint64_t bits = 0;
    int n = 0;
    auto app = [&](unsigned sym) {
      uint32_t e = ll_ent[sym];
      bits |= static_cast<uint64_t>(e & 0xFFFF) << n;
      n += static_cast<int>(e >> 16);
    };
    app(lo);
    if (vi < 0) {
      if (hi != 0xFF) app(hi);
      int k = hi == 0xFF ? 3 : 2;
      for (int q = 0; q < k; ++q) app(0xFF);
    } else if (hi) {
      app(hi);
    }
    if (n <= 57) {
      lut->bits[idx] = bits;
      lut->len[idx] = static_cast<uint8_t>(n);
    } else {
      lut->len[idx] = 0;
    }
  }
}

// Replay coefficient tokens through the bit writer (the emit half of the
// coefficient-granular path).
void emit_coeff_tokens(const uint32_t* toks, size_t ntok,
                       PtrBitWriter& bw, const uint32_t* ll_ent,
                       const uint16_t* d_codes, const uint8_t* d_lens) {
  CoeffLut* lut = coeff_lut_scratch();
  build_coeff_lut(ll_ent, lut);
  uint32_t l0e = ll_ent[0];
  uint32_t l0c = l0e & 0xFFFF;
  int l0n = static_cast<int>(l0e >> 16);
  auto match_bits = [&](int len, int ds, uint64_t* bits, int* nb) {
    int c = kLen.idx[len];
    uint32_t e = ll_ent[257 + c];
    *bits = e & 0xFFFF;
    *nb = static_cast<int>(e >> 16);
    if (LBITS[c]) {
      *bits |= static_cast<uint64_t>(len - LBASE[c]) << *nb;
      *nb += LBITS[c];
    }
    *bits |= static_cast<uint64_t>(d_codes[ds]) << *nb;
    *nb += d_lens[ds];
  };
  uint64_t m258b, m256b;
  int m258n, m256n;
  match_bits(258, 0, &m258b, &m258n);
  match_bits(256, 3, &m256b, &m256n);
  // per-block LUTs of every match length at both distances (the remainder
  // codes of zero runs and value runs) — match_bits recomputed codes per
  // token before round 4
  struct MatchLut {
    uint64_t bits[259];
    uint8_t len[259];
  };
  thread_local MatchLut m0, m3;
  for (int L = 3; L <= 258; ++L) {
    int nb;
    match_bits(L, 0, &m0.bits[L], &nb);
    m0.len[L] = static_cast<uint8_t>(nb);
    match_bits(L, 3, &m3.bits[L], &nb);
    m3.len[L] = static_cast<uint8_t>(nb);
  }
  // local bit accumulator: tokens average ~9 bits, so batching 4-6 of them
  // per put64 call removes most writer-call overhead; the emitted bit
  // sequence is unchanged (identical bits, identical order)
  uint64_t acc = 0;
  int accn = 0;
  auto flushacc = [&]() {
    if (accn) {
      bw.put64(acc, accn);
      acc = 0;
      accn = 0;
    }
  };
  auto add = [&](uint64_t bits, int nb) {
    if (accn + nb > 57) flushacc();
    acc |= bits << accn;
    accn += nb;
  };
  auto emit_lit_bytes = [&](unsigned u) {
    // slow path: the 4 widened bytes of one coefficient, scan semantics
    int16_t x = static_cast<int16_t>(u);
    unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
    auto put_sym = [&](unsigned sym) {
      uint32_t e = ll_ent[sym];
      add(e & 0xFFFF, static_cast<int>(e >> 16));
    };
    put_sym(lo);
    if (x < 0) {
      if (hi != 0xFF) put_sym(hi);
      int k = hi == 0xFF ? 3 : 2;
      for (int q = 0; q < k; ++q) put_sym(0xFF);
    } else if (hi) {
      put_sym(hi);
    }
  };
  auto emit_zrun = [&](uint64_t nn) {
    if (nn >= 4) {
      add(l0c, l0n);
      uint64_t rem = nn - 1;
      uint64_t k = rem / 258;
      uint32_t r = rem % 258;
      for (; k; --k) add(m258b, m258n);
      if (r >= 3) {
        add(m0.bits[r], m0.len[r]);
      } else {
        for (; r; --r) add(l0c, l0n);
      }
    } else {
      for (uint64_t q = nn; q; --q) add(l0c, l0n);
    }
  };
  for (size_t ti = 0; ti < ntok; ++ti) {
    uint32_t t = toks[ti];
    uint32_t kind = t >> 29;
    if (kind == 0) {  // single coefficient
      int idx = static_cast<int16_t>(static_cast<uint16_t>(t)) + 512;
      if (static_cast<uint32_t>(idx) < 1024 && lut->len[idx]) {
        add(lut->bits[idx], lut->len[idx]);
      } else {
        emit_lit_bytes(t & 0xFFFF);
      }
      continue;
    }
    if (kind == 1) {  // merged single + zero run
      int idx = static_cast<int16_t>(static_cast<uint16_t>(t)) + 512;
      if (static_cast<uint32_t>(idx) < 1024 && lut->len[idx]) {
        add(lut->bits[idx], lut->len[idx]);
      } else {
        emit_lit_bytes(t & 0xFFFF);
      }
      emit_zrun((t >> 16) & 0x1FFF);
      continue;
    }
    if (t & 0x80000000u) {  // zero run of nn bytes
      emit_zrun(t & 0x7FFFFFFFu);
    } else {  // value run: 4 literals + dist-4 chain
      unsigned u = t & 0xFFFF;
      uint32_t rep = toks[++ti];
      int16_t x = static_cast<int16_t>(u);
      unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
      unsigned sb = x < 0 ? 0xFF : 0x00;
      uint32_t el = ll_ent[lo];
      add(el & 0xFFFF, static_cast<int>(el >> 16));
      uint32_t eh = ll_ent[hi];
      add(eh & 0xFFFF, static_cast<int>(eh >> 16));
      uint32_t es = ll_ent[sb];
      add(es & 0xFFFF, static_cast<int>(es >> 16));
      add(es & 0xFFFF, static_cast<int>(es >> 16));
      uint64_t rem = static_cast<uint64_t>(rep - 1) * 4;
      uint64_t k = rem / 256;
      uint32_t r = rem % 256;
      for (; k; --k) add(m256b, m256n);
      if (r) add(m3.bits[r], m3.len[r]);
    }
  }
  flushacc();
}

// One coefficient chunk -> raw deflate bits (byte-aligned at the end).
void sparse16_chunk(const int16_t* v, size_t n_coeffs, bool last,
                    ChunkResult* out) {
  out->ok = true;
  if (n_coeffs == 0) {
    out->adler = 1;
    emit_stored(nullptr, 0, last, &out->data);
    return;
  }
  CoeffScan cs;
  cs.toks = coeff_token_scratch(2 * n_coeffs + 16);
  RunAdler ad;
  scan_coeffs_fast(v, n_coeffs, cs, &ad);
  out->adler = ad.value();
  cs.freq[256]++;  // EOB
  emit_block_with(cs.freq, cs.dfreq, last, &out->data,
                  [&](PtrBitWriter& bw, const uint32_t* ll_ent,
                      const uint16_t* d_codes, const uint8_t* d_lens) {
                    emit_coeff_tokens(cs.toks, cs.ntok, bw, ll_ent,
                                      d_codes, d_lens);
                  });
  // stored fallback if huffman lost (essentially never for coefficient
  // data, but keeps the 4x expansion bound)
  size_t n = n_coeffs * 4;
  size_t stored_cost = n + 5 * ((n + 65534) / 65535);
  if (out->data.size() > stored_cost) {
    std::vector<int32_t> wide(n_coeffs);
    for (size_t i = 0; i < n_coeffs; ++i) wide[i] = v[i];
    out->data.clear();
    emit_stored(reinterpret_cast<const unsigned char*>(wide.data()), n, last,
                &out->data);
  }
}

// One chunk -> raw deflate bits, byte-aligned at the end (sync flush if not
// last).  Never fails.
void sparse_chunk(const unsigned char* src, size_t n, bool last,
                  ChunkResult* out) {
  out->ok = true;
  if (n == 0) {
    out->adler = 1;
    emit_stored(src, 0, last, &out->data);
    return;
  }
  TokenRecorder fc;
  fc.toks = token_scratch(n + 64);
  RunAdler ad;
  scan_tokens(src, n, fc, &ad);
  out->adler = ad.value();
  fc.freq[256]++;  // EOB
  emit_token_block(fc, last, &out->data);
  // fall back to stored blocks if the huffman encoding lost
  size_t stored_cost = n + 5 * ((n + 65534) / 65535);
  if (out->data.size() > stored_cost) {
    out->data.clear();
    emit_stored(src, n, last, &out->data);
  }
}

// Deflate one chunk as raw deflate data ending on a byte boundary
// (Z_FULL_FLUSH), no zlib header/trailer.  level < 0 -> sparse encoder.
bool deflate_chunk(const unsigned char* src, size_t len, int level,
                   bool last, ChunkResult* out) {
  if (level < 0) {
    sparse_chunk(src, len, last, out);
    return out->ok;
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // windowBits = -15: raw deflate (we add the zlib wrapper ourselves);
  // memLevel 8 = zlib.compress default, keeps threads=1 byte-identical.
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK) {
    return false;
  }
  out->data.resize(deflateBound(&zs, len) + 16);
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = out->data.data();
  zs.avail_out = static_cast<uInt>(out->data.size());
  int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
  bool ok = last ? (rc == Z_STREAM_END) : (rc == Z_OK || rc == Z_BUF_ERROR);
  out->data.resize(zs.total_out);
  deflateEnd(&zs);
  out->ok = ok;
  return ok;
}

uint32_t adler32_combine_all(const unsigned char* src, size_t len) {
  return static_cast<uint32_t>(
      adler32(adler32(0L, Z_NULL, 0), src, static_cast<uInt>(len)));
}

// Inflate a zlib stream; returns decompressed size or 0 on failure.
size_t aej_inflate_impl(const unsigned char* src, size_t len,
                        unsigned char* dst, size_t dst_cap) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return 0;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_cap);
  int rc = inflate(&zs, Z_FINISH);
  size_t out = zs.total_out;
  inflateEnd(&zs);
  return rc == Z_STREAM_END ? out : 0;
}

// ------------------------------------------------------------- task pool
// Run f(0..n-1) on up to `threads` std::threads (atomic work stealing).
template <typename F>
void run_tasks(size_t n, int threads, F&& f) {
  if (n == 0) return;
  std::atomic<size_t> next(0);
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n) return;
      f(i);
    }
  };
  size_t nt = std::min<size_t>(threads < 1 ? 1 : threads, n);
  if (nt <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (size_t t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// --------------------------------------------------- sparse-stream inflater
// Token-domain decoder for the streams OUR sparse encoder emits (dynamic
// Huffman blocks with distance codes {1, 4} plus stored blocks).  It never
// materializes the widened int32 byte stream: zero runs just advance a
// cursor over the (pre-zeroed) dense tables, and only nonzero coefficients
// are narrowed and written.  Anything it doesn't recognize (general
// distances, static blocks — i.e. real zlib output) returns UNSUPPORTED and
// the caller falls back to zlib inflate.

struct BitReader {
  const unsigned char* p;
  const unsigned char* end;
  uint64_t hold = 0;
  int nbits = 0;
  inline void fill() {
    if (p + 8 <= end) {
      // Branchless 8-byte refill (libdeflate-style): hold may carry MORE
      // valid stream bits than nbits claims; the overlap re-ORed on the
      // next fill is bit-identical, so it is harmless.
      uint64_t w;
      std::memcpy(&w, p, 8);
      hold |= w << nbits;
      int take = (63 - nbits) >> 3;
      p += take;
      nbits += take * 8;
      return;
    }
    while (nbits <= 56 && p < end) {
      hold |= static_cast<uint64_t>(*p++) << nbits;
      nbits += 8;
    }
  }
  inline int64_t get(int n) {  // -1 on underflow
    if (nbits < n) {
      fill();
      if (nbits < n) return -1;
    }
    int64_t v = static_cast<int64_t>(hold & ((1ull << n) - 1));
    hold >>= n;
    nbits -= n;
    return v;
  }
  inline void drop(int n) {
    hold >>= n;
    nbits -= n;
  }
  inline void align_byte() {
    int r = nbits & 7;
    hold >>= r;
    nbits -= r;
  }
};

// Single-level Huffman decode table: entry = (sym << 4) | len, 0 = invalid.
// Detects over-subscribed codes; incomplete codes leave invalid entries.
bool build_decode_table(const uint8_t* lens, int n, int table_bits,
                        uint16_t* table) {
  std::memset(table, 0, sizeof(uint16_t) << table_bits);
  int bl_count[16] = {0};
  for (int i = 0; i < n; ++i) {
    if (lens[i] > table_bits) return false;
    bl_count[lens[i]]++;
  }
  bl_count[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= table_bits; ++l) {
    code = (code + bl_count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    int l = lens[i];
    if (!l) continue;
    uint32_t c = next[l]++;
    if (c >= (1u << l)) return false;  // over-subscribed
    uint32_t rc = bit_reverse(c, l);
    uint16_t e = static_cast<uint16_t>((i << 4) | l);
    for (uint32_t idx = rc; idx < (1u << table_bits); idx += (1u << l))
      table[idx] = e;
  }
  return true;
}

// Streaming consumer: assembles the virtual int32-LE bytes back into
// coefficients and scatters nonzero ones into the dense per-size tables,
// walking the preorder leaf list.  All leaf geometry is validated before
// use (malformed containers set `bad` instead of writing out of bounds).
struct TableScatter {
  const int32_t* sizes;
  const int32_t* ys;
  const int32_t* xs;
  int64_t n_leaves;
  int32_t pw, ph;
  int16_t* const* tables;

  int64_t li = -1;  // current leaf
  int64_t oi = 0, s2 = 0;
  int16_t* dst = nullptr;
  uint32_t cur = 0;
  int phase = 0;
  uint8_t hist[4] = {0, 0, 0, 0};
  uint64_t pos = 0;  // virtual bytes emitted
  bool bad = false;

  bool next_leaf() {
    ++li;
    if (li >= n_leaves) {
      dst = nullptr;
      s2 = 0;
      oi = 0;
      return false;
    }
    int32_t s = sizes[li];
    if (s <= 0 || (s & (s - 1)) || s > 128) {
      bad = true;
      return false;
    }
    int k = 0;
    while ((1 << k) < s) ++k;
    if (!tables[k]) {
      bad = true;
      return false;
    }
    int32_t y = ys[li], x = xs[li];
    if (y < 0 || x < 0 || (y % s) || (x % s) || y + s > ph || x + s > pw) {
      bad = true;
      return false;
    }
    s2 = static_cast<int64_t>(s) * s;
    dst = tables[k] +
          (static_cast<int64_t>(y / s) * (pw / s) + x / s) * s2;
    // zero the whole row up front: commit() skips zero writes and
    // skip_zero_words() only advances indices, and since the mask-gated
    // decode the tables arrive as UNINITIALIZED scratch, not np.zeros —
    // without this, garbage survives inside leaf rows at zero positions
    std::memset(dst, 0, static_cast<size_t>(s2) * 2);
    oi = 0;
    return true;
  }
  inline void commit(uint32_t w) {
    if (!dst) {
      bad = true;
      return;
    }
    if (w) dst[oi] = static_cast<int16_t>(w);
    if (++oi == s2) next_leaf();
  }
  inline void byte(unsigned c) {
    hist[pos & 3] = static_cast<uint8_t>(c);
    ++pos;
    cur |= c << (8 * phase);
    if (++phase == 4) {
      phase = 0;
      commit(cur);
      cur = 0;
    }
  }
  bool skip_zero_words(uint64_t nwords) {  // requires phase == 0
    while (nwords) {
      if (!dst) {
        bad = true;
        return false;
      }
      uint64_t room = static_cast<uint64_t>(s2 - oi);
      if (nwords < room) {
        oi += nwords;
        return true;
      }
      nwords -= room;
      next_leaf();
      if (bad) return false;
    }
    return true;
  }
  bool run(int dist, uint32_t L) {
    if (pos < static_cast<uint32_t>(dist)) return false;
    if (dist == 1) {
      unsigned c = hist[(pos - 1) & 3];
      if (c == 0) {
        // Zero gap.  Most gaps start mid-word (a positive coefficient
        // emits 1-2 literal bytes, so the merged zero run begins at
        // phase 1-2); walking those byte-by-byte dominated the scatter
        // half of decode (measured 154 of 239 ms/batch single-thread).
        // Hybrid: byte() to the word boundary, O(1)-skip whole words,
        // byte() the tail.
        uint32_t head = static_cast<uint32_t>((4 - phase) & 3);
        if (head > L) head = L;
        for (uint32_t k = 0; k < head; ++k) byte(0);
        if (bad) return false;
        uint32_t rem = L - head;
        uint64_t w = rem >> 2;
        if (w) {
          if (!skip_zero_words(w)) return false;
          pos += w * 4;
          // the skipped bytes were all zero
          hist[0] = hist[1] = hist[2] = hist[3] = 0;
        }
        for (uint32_t k = 0; k < (rem & 3); ++k) byte(0);
      } else {
        for (uint32_t k = 0; k < L; ++k) byte(c);
      }
    } else if (phase == 0 && (L & 3) == 0 && L >= 8) {
      // dist 4, word-aligned: the repeated word is constant — commit it
      // word-at-a-time instead of 4 byte() state-machine steps per word
      uint32_t wv = static_cast<uint32_t>(hist[(pos + 0) & 3]) |
                    (static_cast<uint32_t>(hist[(pos + 1) & 3]) << 8) |
                    (static_cast<uint32_t>(hist[(pos + 2) & 3]) << 16) |
                    (static_cast<uint32_t>(hist[(pos + 3) & 3]) << 24);
      uint64_t w = L >> 2;
      int16_t v16 = static_cast<int16_t>(wv);
      while (w) {
        if (!dst) {
          bad = true;
          return false;
        }
        uint64_t room = static_cast<uint64_t>(s2 - oi);
        uint64_t m = w < room ? w : room;
        if (wv) {
          int16_t* q = dst + oi;
          for (uint64_t k = 0; k < m; ++k) q[k] = v16;
        }
        oi += static_cast<int64_t>(m);
        w -= m;
        if (oi == s2) {
          next_leaf();
          if (bad) return false;
        }
      }
      pos += L;  // hist invariant: byte j copies its own slot 4 earlier
    } else {  // dist 4, unaligned/short: repeat the previous word bytewise
      for (uint32_t k = 0; k < L; ++k) byte(hist[pos & 3]);
    }
    return !bad;
  }
};

// Counting sink: same protocol as TableScatter but no leaf walking and no
// stores — profiling probe isolating the pure deflate-decode cost (Huffman
// + bit plumbing) from the scatter/leaf-geometry half.
struct CountSink {
  int64_t li = -1, n_leaves = 0;
  uint32_t cur = 0;
  int phase = 0;
  uint8_t hist[4] = {0, 0, 0, 0};
  uint64_t pos = 0;
  bool bad = false;
  bool next_leaf() {
    li = 0;
    return true;
  }
  inline void byte(unsigned c) {
    hist[pos & 3] = static_cast<uint8_t>(c);
    ++pos;
    if (++phase == 4) phase = 0;
  }
  bool run(int dist, uint32_t L) {
    if (pos < static_cast<uint32_t>(dist)) return false;
    if (dist == 1) {
      unsigned c = hist[(pos - 1) & 3];
      if (L >= 4) {
        hist[0] = hist[1] = hist[2] = hist[3] = static_cast<uint8_t>(c);
        pos += L;
        phase = static_cast<int>((phase + L) & 3);
      } else {
        for (uint32_t k = 0; k < L; ++k) byte(c);
      }
    } else {  // dist 4: each byte copies its own hist slot — hist invariant
      pos += L;
      phase = static_cast<int>((phase + L) & 3);
    }
    return true;
  }
};

enum { INF_OK = 1, INF_FALLBACK = 0, INF_BAD = -1 };

// Decode a zlib stream produced by the sparse encoder straight into `sink`.
// Returns INF_OK, INF_FALLBACK (valid-looking but uses features we don't
// speed-decode — use zlib), or INF_BAD (malformed).
template <class Sink>
int sparse_inflate_scatter(const unsigned char* comp, size_t comp_len,
                           Sink& sink, uint64_t expect_bytes) {
  if (comp_len < 6) return INF_BAD;
  if ((comp[0] & 0x0F) != 8) return INF_BAD;  // not deflate/zlib
  BitReader br{comp + 2, comp + comp_len - 4};
  sink.next_leaf();
  if (sink.bad) return INF_BAD;
  thread_local std::vector<uint16_t> lltab(1 << kMaxCodeLen),
      dtab(1 << kMaxCodeLen);
  for (;;) {
    int64_t hdr = br.get(3);
    if (hdr < 0) return INF_BAD;
    int bfinal = static_cast<int>(hdr) & 1;
    int btype = (static_cast<int>(hdr) >> 1) & 3;
    if (btype == 0) {
      br.align_byte();
      int64_t len = br.get(16), nlen = br.get(16);
      if (len < 0 || nlen < 0 || (len ^ 0xFFFF) != nlen) return INF_BAD;
      for (int64_t k = 0; k < len; ++k) {
        int64_t c = br.get(8);
        if (c < 0) return INF_BAD;
        sink.byte(static_cast<unsigned>(c));
        if (sink.bad) return INF_BAD;
      }
    } else if (btype == 2) {
      int64_t hlit = br.get(5), hdist = br.get(5), hclen = br.get(4);
      if (hlit < 0 || hdist < 0 || hclen < 0) return INF_BAD;
      int nlit = static_cast<int>(hlit) + 257;
      int ndist = static_cast<int>(hdist) + 1;
      int ncl = static_cast<int>(hclen) + 4;
      if (nlit > 286 || ndist > 30) return INF_BAD;
      uint8_t cl_lens[19] = {0};
      for (int i = 0; i < ncl; ++i) {
        int64_t v = br.get(3);
        if (v < 0) return INF_BAD;
        cl_lens[CLORDER[i]] = static_cast<uint8_t>(v);
      }
      uint16_t cltab[128];
      if (!build_decode_table(cl_lens, 19, 7, cltab)) return INF_BAD;
      uint8_t lens[286 + 30] = {0};
      int need = nlit + ndist, i = 0;
      while (i < need) {
        if (br.nbits < 7) br.fill();
        uint16_t e = cltab[br.hold & 0x7F];
        int l = e & 0xF;
        if (!e || l > br.nbits) return INF_BAD;
        br.drop(l);
        int sym = e >> 4;
        if (sym < 16) {
          lens[i++] = static_cast<uint8_t>(sym);
        } else if (sym == 16) {
          int64_t r = br.get(2);
          if (r < 0 || i == 0) return INF_BAD;
          r += 3;
          if (i + r > need) return INF_BAD;
          uint8_t pv = lens[i - 1];
          while (r--) lens[i++] = pv;
        } else if (sym == 17) {
          int64_t r = br.get(3);
          if (r < 0) return INF_BAD;
          r += 3;
          if (i + r > need) return INF_BAD;
          i += static_cast<int>(r);
        } else {
          int64_t r = br.get(7);
          if (r < 0) return INF_BAD;
          r += 11;
          if (i + r > need) return INF_BAD;
          i += static_cast<int>(r);
        }
      }
      for (int k = 0; k < nlit + ndist; ++k)
        if (lens[k] > kMaxCodeLen) return INF_FALLBACK;  // spec-valid,
            // but beyond our fast tables (foreign encoder) -> zlib
      if (!build_decode_table(lens, nlit, kMaxCodeLen, lltab.data()))
        return INF_BAD;
      if (!build_decode_table(lens + nlit, ndist, kMaxCodeLen, dtab.data()))
        return INF_BAD;
      // Pack a combined table over the same 12-bit window: when the entry
      // is a literal whose code leaves room for a complete second literal
      // code, both decode in ONE lookup (the per-symbol table walk was the
      // bulk of the remaining inflate cost — literals come in short-code
      // bursts: lo/hi/sign-byte sequences).  Entry layout:
      //   bits 0-3  combined length, 4-5 type (1=lit, 2=two lits,
      //   3=len/EOB — re-decode via lltab), 8-15 sym1, 16-23 sym2.
      thread_local std::vector<uint32_t> ctab(1 << kMaxCodeLen);
      {
        const uint16_t* t = lltab.data();
        uint32_t* c2 = ctab.data();
        for (uint32_t idx = 0; idx < (1u << kMaxCodeLen); ++idx) {
          uint16_t e1 = t[idx];
          if (!e1) {
            c2[idx] = 0;
            continue;
          }
          unsigned l1 = e1 & 0xF, s1 = e1 >> 4;
          if (s1 >= 256) {
            c2[idx] = 3u << 4;
            continue;
          }
          uint16_t e2 = t[(idx >> l1) & ((1u << kMaxCodeLen) - 1)];
          unsigned l2 = e2 & 0xF, s2 = e2 >> 4;
          if (e2 && s2 < 256 && l1 + l2 <= kMaxCodeLen)
            c2[idx] = (l1 + l2) | (2u << 4) | (s1 << 8) | (s2 << 16);
          else
            c2[idx] = l1 | (1u << 4) | (s1 << 8);
        }
      }
      const uint16_t* ll = lltab.data();
      const uint16_t* dd = dtab.data();
      const uint32_t* cc = ctab.data();
      constexpr uint32_t llmask = (1u << kMaxCodeLen) - 1;
      for (;;) {
        // literal fastloop: one branchless 8-byte refill guarantees >= 48
        // bits, i.e. four worst-case 12-bit windows — decode literal PAIRS
        // in a tight sub-loop without per-symbol fill checks
        br.fill();
        int sym;
        for (;;) {
          uint32_t e = cc[br.hold & llmask];
          unsigned t = (e >> 4) & 3;
          unsigned l = e & 0xF;
          if (t == 2) {
            if (l > static_cast<unsigned>(br.nbits)) return INF_BAD;
            br.drop(static_cast<int>(l));
            sink.byte((e >> 8) & 0xFF);
            sink.byte((e >> 16) & 0xFF);
            if (sink.bad) return INF_BAD;
          } else if (t == 1) {
            if (l > static_cast<unsigned>(br.nbits)) return INF_BAD;
            br.drop(static_cast<int>(l));
            sink.byte((e >> 8) & 0xFF);
            if (sink.bad) return INF_BAD;
          } else if (t == 3) {
            uint16_t e1 = ll[br.hold & llmask];
            int l1 = e1 & 0xF;
            if (!e1 || l1 > br.nbits) return INF_BAD;
            br.drop(l1);
            sym = e1 >> 4;
            break;
          } else {
            return INF_BAD;
          }
          if (br.nbits < 15) {
            sym = -1;
            break;
          }
        }
        if (sym < 0) continue;   // refill and keep decoding literals
        if (sym == 256) break;
        int c = sym - 257;
        if (c > 28) return INF_BAD;
        int64_t extra = LBITS[c] ? br.get(LBITS[c]) : 0;
        if (extra < 0) return INF_BAD;
        uint32_t L = LBASE[c] + static_cast<uint32_t>(extra);
        if (br.nbits < 15) br.fill();
        uint16_t de = dd[br.hold & ((1u << kMaxCodeLen) - 1)];
        int dl = de & 0xF;
        if (!de || dl > br.nbits) return INF_BAD;
        br.drop(dl);
        int dsym = de >> 4;
        int dist;
        if (dsym == 0) {
          dist = 1;
        } else if (dsym == 3) {
          dist = 4;
        } else {
          return INF_FALLBACK;  // general window distance: real zlib output
        }
        if (!sink.run(dist, L)) return INF_BAD;
      }
    } else if (btype == 1) {
      return INF_FALLBACK;  // static Huffman: our encoder never emits it
    } else {
      return INF_BAD;
    }
    if (bfinal) break;
  }
  if (sink.bad || sink.phase != 0 || sink.li < sink.n_leaves ||
      sink.pos != expect_bytes)
    return INF_BAD;
  return INF_OK;
}

// Replay packed 2-bit states into thread-local leaf arrays.  Returns the
// leaf count (and the coefficient total via *total_out), or -1 when the
// stream is malformed (root not a power of two / splits below size 2).
struct LeafLists {
  std::vector<int32_t> sizes, ys, xs;
};
int64_t replay_packed_states(const unsigned char* states_bytes,
                             int64_t bits_len, int32_t root_size,
                             LeafLists* out, int64_t* total_out) {
  if (root_size <= 0 || (root_size & (root_size - 1)) ||
      root_size > (1 << 20))
    return -1;
  int64_t n_states = bits_len / 2;
  struct Node {
    int32_t x, y, size;
  };
  std::vector<Node> stack;
  stack.reserve(128);
  stack.push_back({0, 0, root_size});
  out->sizes.clear();
  out->ys.clear();
  out->xs.clear();
  int64_t idx = 0, total = 0;
  while (!stack.empty() && idx < n_states) {
    Node nd = stack.back();
    stack.pop_back();
    int64_t t0 = 2 * idx, t1 = 2 * idx + 1;
    unsigned st = (((states_bytes[t0 >> 3] >> (7 - (t0 & 7))) & 1u) << 1) |
                  ((states_bytes[t1 >> 3] >> (7 - (t1 & 7))) & 1u);
    ++idx;
    if (st == 0) {
      out->sizes.push_back(nd.size);
      out->ys.push_back(nd.y);
      out->xs.push_back(nd.x);
      total += static_cast<int64_t>(nd.size) * nd.size;
    } else if (st == 1) {
      if (nd.size < 2) return -1;
      int32_t half = nd.size >> 1;
      stack.push_back({nd.x + half, nd.y + half, half});
      stack.push_back({nd.x, nd.y + half, half});
      stack.push_back({nd.x + half, nd.y, half});
      stack.push_back({nd.x, nd.y, half});
    }
  }
  *total_out = total;
  return static_cast<int64_t>(out->sizes.size());
}

// Mark each leaf's grid row in the caller's per-size mask planes (masks[k]
// nullable, 1 byte per grid cell).  With masks, the dense tables may come
// from UNINITIALIZED scratch: the device gates every row on its mask bit,
// so only leaf rows need writing — this removed the np.zeros page-fault
// cost that dominated decode 'parse' (codec/batch_decode.py).
void mark_leaf_masks(const LeafLists& leaves, int64_t nl, int32_t pw,
                     uint8_t* const* masks) {
  for (int64_t i = 0; i < nl; ++i) {
    int32_t s = leaves.sizes[i];
    int k = 0;
    while ((1 << k) < s) ++k;
    if (k >= 8 || !masks[k]) continue;  // geometry validated by the scatter
    masks[k][static_cast<int64_t>(leaves.ys[i] / s) * (pw / s) +
             leaves.xs[i] / s] = 1;
  }
}

// Core of layer decode: replay + custom inflate-scatter with zlib fallback.
// Returns leaf count or -1 (malformed).
int64_t decode_layer_impl(const unsigned char* states_bytes,
                          int64_t bits_len, int32_t root_size,
                          const unsigned char* comp, size_t comp_len,
                          int32_t pw, int32_t ph, int16_t* const* tables,
                          uint8_t* const* masks = nullptr) {
  thread_local LeafLists leaves;
  int64_t total = 0;
  int64_t nl = replay_packed_states(states_bytes, bits_len, root_size,
                                    &leaves, &total);
  if (nl < 0) return -1;
  TableScatter sink{leaves.sizes.data(), leaves.ys.data(), leaves.xs.data(),
                    nl, pw, ph, tables};
  int rc = sparse_inflate_scatter(comp, comp_len, sink, 4 * total);
  if (rc == INF_OK) {
    if (masks) mark_leaf_masks(leaves, nl, pw, masks);
    return nl;
  }
  // fallback: generic zlib inflate + validated scatter (also the recovery
  // path when the custom decode bailed after partial writes — it rewrites
  // every coefficient of every leaf, so partial state is overwritten)
  thread_local std::vector<int32_t> raw;
  raw.resize(static_cast<size_t>(total));
  if (aej_inflate_impl(comp, comp_len,
                       reinterpret_cast<unsigned char*>(raw.data()),
                       static_cast<size_t>(total) * 4) !=
      static_cast<size_t>(total) * 4)
    return -1;
  const int32_t* src = raw.data();
  for (int64_t i = 0; i < nl; ++i) {
    int32_t s = leaves.sizes[i];
    if (s <= 0 || (s & (s - 1)) || s > 128) return -1;
    int k = 0;
    while ((1 << k) < s) ++k;
    if (!tables[k]) return -1;
    int32_t y = leaves.ys[i], x = leaves.xs[i];
    if (y < 0 || x < 0 || (y % s) || (x % s) || y + s > ph || x + s > pw)
      return -1;
    int64_t s2 = static_cast<int64_t>(s) * s;
    int16_t* dst = tables[k] +
                   (static_cast<int64_t>(y / s) * (pw / s) + x / s) * s2;
    for (int64_t j = 0; j < s2; ++j) dst[j] = static_cast<int16_t>(src[j]);
    src += s2;
  }
  if (masks) mark_leaf_masks(leaves, nl, pw, masks);
  return nl;
}

}  // namespace

extern "C" {

// Compress int16 coefficients as the zlib stream of their int32-LE widening
// (the .ajpg coefficient payload, src/jpeg/jpeg.py:579-597) using the
// coefficient-domain sparse encoder — the widened bytes are never
// materialized.  Returns the output size, or 0 on failure.
size_t aej_payload16(const int16_t* v, size_t n_coeffs, int threads,
                     unsigned char* dst, size_t dst_cap) {
  if (threads < 1) threads = 1;
  const size_t chunk = (1 << 20) / 4;  // 1 MiB of virtual bytes
  size_t n_chunks = (n_coeffs + chunk - 1) / chunk;
  if (n_chunks == 0) n_chunks = 1;
  std::vector<ChunkResult> results(n_chunks);

  std::atomic<size_t> next(0);
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks) return;
      size_t off = i * chunk;
      size_t n = (off + chunk <= n_coeffs) ? chunk : (n_coeffs - off);
      sparse16_chunk(v + off, n, i + 1 == n_chunks, &results[i]);
    }
  };
  int nt = static_cast<int>(
      std::min<size_t>(static_cast<size_t>(threads), n_chunks));
  if (nt > 1) {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  } else {
    worker();
  }

  size_t total = 2 + 4;
  for (auto& r : results) total += r.data.size();
  if (total > dst_cap) return 0;
  unsigned char* p = dst;
  *p++ = 0x78;
  *p++ = 0x01;
  for (auto& r : results) {
    std::memcpy(p, r.data.data(), r.data.size());
    p += r.data.size();
  }
  // combine the per-chunk adlers computed inside the token scans
  uint32_t ad = results[0].adler;
  for (size_t i = 1; i < n_chunks; ++i) {
    size_t off = i * chunk;
    size_t nc = (off + chunk <= n_coeffs) ? chunk : (n_coeffs - off);
    ad = adler_join(ad, results[i].adler, 4 * nc);
  }
  *p++ = (ad >> 24) & 0xFF;
  *p++ = (ad >> 16) & 0xFF;
  *p++ = (ad >> 8) & 0xFF;
  *p++ = ad & 0xFF;
  return static_cast<size_t>(p - dst);
}

// Compress `len` bytes into `dst` (capacity dst_cap) as one zlib stream
// using `threads` workers and `chunk_size` bytes per chunk.  Returns the
// output size, or 0 on failure (including insufficient dst_cap).
size_t aej_deflate_parallel(const unsigned char* src, size_t len,
                            unsigned char* dst, size_t dst_cap, int level,
                            int threads, size_t chunk_size) {
  if (threads < 1) threads = 1;
  if (chunk_size < 1 << 16) chunk_size = 1 << 16;

  size_t n_chunks = (len + chunk_size - 1) / chunk_size;
  if (n_chunks == 0) n_chunks = 1;
  std::vector<ChunkResult> results(n_chunks);

  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= n_chunks || failed.load()) return;
      size_t off = i * chunk_size;
      size_t n = (off + chunk_size <= len) ? chunk_size : (len - off);
      if (!deflate_chunk(src + off, n, level, i + 1 == n_chunks,
                         &results[i])) {
        failed.store(true);
      }
    }
  };

  int nt = static_cast<int>(
      std::min<size_t>(static_cast<size_t>(threads), n_chunks));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (failed.load()) return 0;

  // Assemble: 2-byte zlib header, chunks, 4-byte adler32 (big-endian).
  size_t total = 2 + 4;
  for (auto& r : results) total += r.data.size();
  if (total > dst_cap) return 0;

  unsigned char* p = dst;
  *p++ = 0x78;  // CMF: deflate, 32K window
  *p++ = (level < 0)   ? 0x01
         : (level >= 7) ? 0xDA
         : (level >= 5) ? 0x9C
         : (level >= 2) ? 0x5E
                        : 0x01;
  for (auto& r : results) {
    std::memcpy(p, r.data.data(), r.data.size());
    p += r.data.size();
  }
  uint32_t ad;
  if (level < 0) {
    // sparse chunks computed their adler inside the token scan
    ad = results[0].adler;
    for (size_t i = 1; i < n_chunks; ++i) {
      size_t off = i * chunk_size;
      size_t nb = (off + chunk_size <= len) ? chunk_size : (len - off);
      ad = adler_join(ad, results[i].adler, nb);
    }
  } else {
    ad = adler32_combine_all(src, len);
  }
  *p++ = (ad >> 24) & 0xFF;
  *p++ = (ad >> 16) & 0xFF;
  *p++ = (ad >> 8) & 0xFF;
  *p++ = ad & 0xFF;
  return static_cast<size_t>(p - dst);
}

// Inflate a zlib stream; returns decompressed size or 0 on failure.
size_t aej_inflate(const unsigned char* src, size_t len, unsigned char* dst,
                   size_t dst_cap) {
  return aej_inflate_impl(src, len, dst, dst_cap);
}

// Preorder stack replay of 2-bit quadtree states -> leaf (size, y, x),
// mirroring the reference traversal (src/jpeg/jpeg.py:768-800 and
// codec/quadtree.py replay_positions).  Output arrays must have capacity
// n_states.  Returns the number of leaves.
size_t aej_replay_states(const unsigned char* states, size_t n_states,
                         int root_size, int32_t* sizes, int32_t* ys,
                         int32_t* xs) {
  struct Node {
    int32_t x, y, size;
  };
  std::vector<Node> stack;
  stack.reserve(128);
  stack.push_back({0, 0, root_size});
  size_t idx = 0, out = 0;
  while (!stack.empty() && idx < n_states) {
    Node nd = stack.back();
    stack.pop_back();
    unsigned char st = states[idx++];
    if (st == 0) {
      sizes[out] = nd.size;
      ys[out] = nd.y;
      xs[out] = nd.x;
      ++out;
    } else if (st == 1) {
      int32_t half = nd.size >> 1;
      stack.push_back({nd.x + half, nd.y + half, half});
      stack.push_back({nd.x, nd.y + half, half});
      stack.push_back({nd.x + half, nd.y, half});
      stack.push_back({nd.x, nd.y, half});
    }
  }
  return out;
}

// Preorder quadtree plan from pooled has-edge level masks — the native
// version of codec/quadtree.py plan_from_levels.  One stack DFS emits the
// 2-bit state stream and the leaf (size, y, x) lists in preorder directly
// (no sort).  Split predicate parity with the reference
// (src/jpeg/quadtree.py:118): split iff size > max_size, or
// (size > min_size AND the node's has-edge bit is set).  Nodes whose
// origin lies outside the (h, w) image serialize as ABSENT.
//
// levels: concatenated row-major g_k x g_k uint8 masks (g_k = root >> k)
// for k = k_lo..k_hi; level_offsets[k - k_lo] indexes each mask's start.
// Outputs: states (capacity >= total visited nodes), sizes/ys/xs
// (capacity >= leaf count).  Writes the state count to *n_states_out and
// returns the leaf count.
size_t aej_build_plan(const unsigned char* levels,
                      const int64_t* level_offsets, int k_lo, int k_hi,
                      int root_size, int h, int w, int max_size,
                      int min_size, unsigned char* states, int32_t* sizes,
                      int32_t* ys, int32_t* xs, size_t* n_states_out) {
  struct Node {
    int32_t x, y;
    int32_t k;
  };
  int lmax = 0;
  while ((1 << (lmax + 1)) <= root_size) ++lmax;
  int kmin = 0;
  while ((1 << (kmin + 1)) <= min_size) ++kmin;
  if (kmin > lmax) kmin = lmax;

  std::vector<Node> stack;
  stack.reserve(256);
  stack.push_back({0, 0, lmax});
  size_t ns = 0, nl = 0;
  while (!stack.empty()) {
    Node nd = stack.back();
    stack.pop_back();
    if (nd.x >= w || nd.y >= h) {
      states[ns++] = 2;  // absent
      continue;
    }
    int s = 1 << nd.k;
    bool split = false;
    if (nd.k > kmin) {
      if (s > max_size) {
        split = true;
      } else if (s > min_size && nd.k >= k_lo && nd.k <= k_hi) {
        int g = root_size >> nd.k;
        split = levels[level_offsets[nd.k - k_lo] +
                       static_cast<int64_t>(nd.y >> nd.k) * g +
                       (nd.x >> nd.k)] != 0;
      }
    }
    if (split) {
      states[ns++] = 1;
      int32_t half = s >> 1;
      int32_t ck = nd.k - 1;
      stack.push_back({nd.x + half, nd.y + half, ck});
      stack.push_back({nd.x, nd.y + half, ck});
      stack.push_back({nd.x + half, nd.y, ck});
      stack.push_back({nd.x, nd.y, ck});
    } else {
      states[ns++] = 0;
      sizes[nl] = s;
      ys[nl] = nd.y;
      xs[nl] = nd.x;
      ++nl;
    }
  }
  *n_states_out = ns;
  return nl;
}

// Batched quadtree planning: B images x n_layers plans in one call on an
// internal thread pool, reading the pooled has-edge levels directly from
// the BIT-PACKED stage-A output (np.packbits MSB-first; round 2 unpacked
// the whole tensor in Python first) and emitting the 2-bit state streams
// already packed in container format (quadtree.pack_states parity).
//
// bits: (B, row_stride) bytes.  Per-layer geometry: roots/hs/ws.
// bit_offs: (n_layers, n_k) bit offsets of each level mask within a row,
// for k = k_lo .. k_lo + n_k - 1.  Outputs are arena rows indexed by
// task t = b * n_layers + li: states_packed (sp_stride bytes per task,
// zero-padded), bits_len_out (in bits), sizes/ys/xs (leaf_stride int32
// per task), n_leaves_out, totals_out (sum of leaf size^2).  Returns the
// number of failed tasks (capacity overflow).
int64_t aej_build_plans_batch(
    const unsigned char* bits, int64_t row_stride, int64_t B,
    int32_t n_layers, const int32_t* roots, const int32_t* hs,
    const int32_t* ws, const int64_t* bit_offs, int32_t n_k, int32_t k_lo,
    int32_t max_size, int32_t min_size, unsigned char* states_packed,
    int64_t sp_stride, int64_t* bits_len_out, int32_t* sizes_arena,
    int32_t* ys_arena, int32_t* xs_arena, int64_t leaf_stride,
    int64_t* n_leaves_out, int64_t* totals_out, int32_t threads) {
  std::atomic<int64_t> failed(0);
  int32_t k_hi = k_lo + n_k - 1;
  run_tasks(static_cast<size_t>(B) * n_layers, threads, [&](size_t t) {
    int64_t b = static_cast<int64_t>(t) / n_layers;
    int32_t li = static_cast<int32_t>(t % n_layers);
    const unsigned char* row = bits + b * row_stride;
    const int64_t* offs = bit_offs + static_cast<int64_t>(li) * n_k;
    int32_t root = roots[li], h = hs[li], w = ws[li];
    unsigned char* sp = states_packed + static_cast<int64_t>(t) * sp_stride;
    int32_t* sizes = sizes_arena + static_cast<int64_t>(t) * leaf_stride;
    int32_t* ys = ys_arena + static_cast<int64_t>(t) * leaf_stride;
    int32_t* xs = xs_arena + static_cast<int64_t>(t) * leaf_stride;

    int lmax = 0;
    while ((1 << (lmax + 1)) <= root) ++lmax;
    int kmin = 0;
    while ((1 << (kmin + 1)) <= min_size) ++kmin;
    if (kmin > lmax) kmin = lmax;

    struct Node {
      int32_t x, y;
      int32_t k;
    };
    std::vector<Node> stack;
    stack.reserve(256);
    stack.push_back({0, 0, lmax});
    int64_t ns = 0, nl = 0, total = 0;
    unsigned acc = 0;  // byte accumulator for 2-bit states, MSB-first
    bool ok = true;
    int64_t cap_states = sp_stride * 4, cap_leaves = leaf_stride;
    auto emit_state = [&](unsigned st) {
      acc = (acc << 2) | st;
      if ((++ns & 3) == 0) {
        sp[(ns >> 2) - 1] = static_cast<unsigned char>(acc);
        acc = 0;
      }
    };
    while (!stack.empty()) {
      Node nd = stack.back();
      stack.pop_back();
      if (ns >= cap_states || nl >= cap_leaves) {
        ok = false;
        break;
      }
      if (nd.x >= w || nd.y >= h) {
        emit_state(2);  // absent
        continue;
      }
      int s = 1 << nd.k;
      bool split = false;
      if (nd.k > kmin) {
        if (s > max_size) {
          split = true;
        } else if (s > min_size && nd.k >= k_lo && nd.k <= k_hi) {
          int g = root >> nd.k;
          int64_t idx = offs[nd.k - k_lo] +
                        static_cast<int64_t>(nd.y >> nd.k) * g +
                        (nd.x >> nd.k);
          split = ((row[idx >> 3] >> (7 - (idx & 7))) & 1) != 0;
        }
      }
      if (split) {
        emit_state(1);
        int32_t half = s >> 1;
        int32_t ck = nd.k - 1;
        stack.push_back({nd.x + half, nd.y + half, ck});
        stack.push_back({nd.x, nd.y + half, ck});
        stack.push_back({nd.x + half, nd.y, ck});
        stack.push_back({nd.x, nd.y, ck});
      } else {
        emit_state(0);
        sizes[nl] = s;
        ys[nl] = nd.y;
        xs[nl] = nd.x;
        total += static_cast<int64_t>(s) * s;
        ++nl;
      }
    }
    if (!ok) {
      n_leaves_out[t] = -1;
      bits_len_out[t] = 0;
      totals_out[t] = 0;
      failed.fetch_add(1);
      return;
    }
    if (ns & 3) {  // flush the padded final byte (np.packbits zero-pad)
      sp[ns >> 2] =
          static_cast<unsigned char>(acc << (8 - 2 * (ns & 3)));
    }
    bits_len_out[t] = 2 * ns;
    n_leaves_out[t] = nl;
    totals_out[t] = total;
  });
  return failed.load();
}

// Row index of a boundary (partial) block in the static per-(layer, size)
// slow table.  Enumeration order (mirrored by the device-side bucket
// builder in codec/batch_encode.py): first the partial right column, grid
// rows 0..h/s-1 (present iff w % s != 0), then the partial bottom row,
// grid cols 0..ceil(w/s)-1 (present iff h % s != 0).
static inline int64_t boundary_rank(int32_t y, int32_t x, int32_t s,
                                    int32_t h, int32_t w) {
  int32_t ghf = h / s;
  int32_t gy = y / s;
  if (gy < ghf) return gy;                       // right column
  int64_t n_right = (w % s) ? ghf : 0;
  return n_right + x / s;                        // bottom row (incl corner)
}

// Assemble one layer's preorder int32 coefficient stream from the dense
// per-size level tables the device emits (ZIGZAG-ordered quantized int16,
// one row per grid-aligned block — the device applies the zigzag
// permutation) plus the slow bucket (reflect-padded boundary blocks, same
// zigzag rows, in boundary_rank order), widening int16 -> int32 as the
// container format requires (stream layout: src/jpeg/jpeg.py:579-597), then
// deflate in place.  `tables[k]`/`slow[k]` are indexed by k = log2(block
// size); `tables[k]` points at THIS plane's (gh*gw, s*s) rows, `slow[k]` at
// this plane's first boundary row, `pw` is the padded plane width (grid
// stride).  Returns the compressed size, 0 on failure.
size_t aej_layer_payload(const int32_t* leaf_sizes, const int32_t* leaf_y,
                         const int32_t* leaf_x, int64_t n_leaves, int32_t h,
                         int32_t w, int32_t pw,
                         const int16_t* const* tables,
                         const int16_t* const* slow, int32_t level,
                         int32_t threads, unsigned char* out,
                         size_t out_cap) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_leaves; ++i)
    total += static_cast<int64_t>(leaf_sizes[i]) * leaf_sizes[i];
  thread_local std::vector<int16_t> raw;
  if (raw.size() < static_cast<size_t>(total))
    raw.resize(static_cast<size_t>(total));
  int16_t* dst = raw.data();
  for (int64_t i = 0; i < n_leaves; ++i) {
    int32_t s = leaf_sizes[i];
    int k = 0;
    while ((1 << k) < s) ++k;
    int64_t s2 = static_cast<int64_t>(s) * s;
    const int16_t* src;
    if (leaf_y[i] + s <= h && leaf_x[i] + s <= w) {
      int64_t row = static_cast<int64_t>(leaf_y[i] / s) * (pw / s) +
                    leaf_x[i] / s;
      src = tables[k] + row * s2;
    } else {
      src = slow[k] + boundary_rank(leaf_y[i], leaf_x[i], s, h, w) * s2;
    }
    std::memcpy(dst, src, static_cast<size_t>(s2) * 2);
    dst += s2;
  }
  if (level < 0) {
    return aej_payload16(raw.data(), static_cast<size_t>(total), threads,
                         out, out_cap);
  }
  // reference-parity path: materialize the int32 widening and zlib it
  std::vector<int32_t> wide(static_cast<size_t>(total));
  for (int64_t j = 0; j < total; ++j) wide[j] = raw[j];
  return aej_deflate_parallel(
      reinterpret_cast<const unsigned char*>(wide.data()),
      static_cast<size_t>(total) * 4, out, out_cap, level, threads,
      1 << 20);
}

// Batched layer assembly: n_tasks (image, layer) payloads gathered from the
// dense tables and entropy-coded on an internal thread pool — one ctypes
// call per batch.  leaf_* / tables / slow are per-task pointer arrays
// (tables/slow: 8 slots per task); the payload for task i is written into
// arena[arena_offs[i] .. arena_offs[i+1]) and its size into out_sizes[i]
// (-1 on failure).  Returns the number of failed tasks.
int64_t aej_assemble_batch(int64_t n_tasks,
                           const int32_t* const* leaf_sizes,
                           const int32_t* const* leaf_ys,
                           const int32_t* const* leaf_xs,
                           const int64_t* n_leaves, const int32_t* hs,
                           const int32_t* ws, const int32_t* pws,
                           const int16_t* const* tables,
                           const int16_t* const* slow, int32_t level,
                           int32_t threads, unsigned char* arena,
                           const int64_t* arena_offs, int64_t* out_sizes) {
  std::atomic<int64_t> failed(0);
  run_tasks(static_cast<size_t>(n_tasks), threads, [&](size_t i) {
    size_t cap = static_cast<size_t>(arena_offs[i + 1] - arena_offs[i]);
    size_t n = aej_layer_payload(
        leaf_sizes[i], leaf_ys[i], leaf_xs[i], n_leaves[i], hs[i], ws[i],
        pws[i], tables + 8 * i, slow + 8 * i, level, 1,
        arena + arena_offs[i], cap);
    if (n == 0 && n_leaves[i] > 0) {
      out_sizes[i] = -1;
      failed.fetch_add(1);
    } else {
      out_sizes[i] = static_cast<int64_t>(n);
    }
  });
  return failed.load();
}

// Decode one layer: unpack the 2-bit state stream (np.packbits MSB-first
// convention), replay it to preorder leaf positions (the reference
// traversal, src/jpeg/jpeg.py:768-800), inflate the coefficient stream and
// scatter each leaf's zigzag row (narrowed to int16 — levels are bounded by
// size * 127.5 <= 16320) into the caller's pre-zeroed dense per-size tables
// (zigzag order preserved; the device inverse-zigzags).  The plane is
// padded so every leaf block lies inside the grid — boundary leaves need no
// special casing on decode.  Returns the leaf count, or -1 on a malformed
// stream.
int64_t aej_decode_layer(const unsigned char* states_bytes, int64_t bits_len,
                         int32_t root_size, const unsigned char* comp,
                         size_t comp_len, int32_t pw, int32_t ph,
                         int16_t* const* tables, uint8_t* const* masks) {
  return decode_layer_impl(states_bytes, bits_len, root_size, comp,
                           comp_len, pw, ph, tables, masks);
}

// Batched layer decode: n_tasks (container, layer) pairs decoded on an
// internal thread pool — one ctypes call per batch instead of per layer
// (the per-call Python overhead dominated round 2's decode 'parse' stage).
// Per-task arrays are indexed by task; `tables` holds 8 pointers per task
// (log2-size slots, this plane's rows).  out_leaves[i] = leaf count or -1
// (malformed).  Returns the number of failed tasks.
int64_t aej_decode_batch(int64_t n_tasks,
                         const unsigned char* const* states,
                         const int64_t* bits_lens, const int32_t* root_sizes,
                         const unsigned char* const* comps,
                         const int64_t* comp_lens, const int32_t* pws,
                         const int32_t* phs, int16_t* const* tables,
                         uint8_t* const* masks,
                         int32_t threads, int64_t* out_leaves) {
  std::atomic<int64_t> failed(0);
  run_tasks(static_cast<size_t>(n_tasks), threads, [&](size_t i) {
    int64_t nl = decode_layer_impl(states[i], bits_lens[i], root_sizes[i],
                                   comps[i], static_cast<size_t>(comp_lens[i]),
                                   pws[i], phs[i], tables + 8 * i,
                                   masks ? masks + 8 * i : nullptr);
    out_leaves[i] = nl;
    if (nl < 0) failed.fetch_add(1);
  });
  return failed.load();
}

// Upper bound for aej_deflate_parallel output.
size_t aej_deflate_bound(size_t len, size_t chunk_size) {
  if (chunk_size < 1 << 16) chunk_size = 1 << 16;
  size_t n_chunks = (len + chunk_size - 1) / chunk_size + 1;
  return len + len / 500 + 32 * n_chunks + 64;
}

}  // extern "C"

// Profiling probe (tools/profile_r5_parse.py): pure inflate cost of one
// layer payload with no scatter — full-minus-this = scatter+leaf half.
// Returns bytes decoded, or -1 (bad) / -2 (fallback-class stream).
extern "C" int64_t aej_bench_inflate_count(const unsigned char* comp,
                                           size_t comp_len,
                                           int64_t expect_bytes) {
  CountSink cs;
  int rc = sparse_inflate_scatter(comp, comp_len, cs,
                                  static_cast<uint64_t>(expect_bytes));
  if (rc == INF_OK) return static_cast<int64_t>(cs.pos);
  return rc == INF_BAD ? -1 : -2;
}

// TEMPORARY benchmark probe: scan-only cost of the sparse16 encoder.
// mode 0: full; mode 1: no adler; mode 2: zero-span traversal only.
extern "C" size_t aej_bench_scan16(const int16_t* v, size_t n_coeffs) {
  CoeffScan cs;
  cs.toks = coeff_token_scratch(2 * n_coeffs + 16);
  RunAdler ad;
  scan_coeffs_fast(v, n_coeffs, cs, &ad);
  return cs.ntok + (ad.value() & 1);
}

extern "C" size_t aej_bench_scan16_mode(const int16_t* v, size_t n_coeffs,
                                        int mode) {
#if defined(__AVX512BW__)
  if (mode == 3) {  // AVX classify + mask iterate, no per-nonzero work
    size_t acc = 0, base = 0;
    while (base + 32 <= n_coeffs) {
      __m512i x = _mm512_loadu_si512(
          reinterpret_cast<const void*>(v + base));
      uint32_t mask =
          _mm512_cmpneq_epi16_mask(x, _mm512_setzero_si512());
      while (mask) {
        unsigned p = static_cast<unsigned>(__builtin_ctz(mask));
        mask &= mask - 1;
        acc += v[base + p];
      }
      base += 32;
    }
    return acc;
  }
  if (mode == 4) {  // classify + token stores, no freq/adler/zrun logic
    CoeffScan cs;
    cs.toks = coeff_token_scratch(2 * n_coeffs + 16);
    size_t base = 0;
    while (base + 32 <= n_coeffs) {
      __m512i x = _mm512_loadu_si512(
          reinterpret_cast<const void*>(v + base));
      uint32_t mask =
          _mm512_cmpneq_epi16_mask(x, _mm512_setzero_si512());
      while (mask) {
        unsigned p = static_cast<unsigned>(__builtin_ctz(mask));
        mask &= mask - 1;
        cs.toks[cs.ntok++] = static_cast<uint16_t>(v[base + p]);
      }
      base += 32;
    }
    return cs.ntok;
  }
  if (mode == 5) {  // classify + freq updates, no tokens
    CoeffScan cs;
    size_t base = 0;
    while (base + 32 <= n_coeffs) {
      __m512i x = _mm512_loadu_si512(
          reinterpret_cast<const void*>(v + base));
      uint32_t mask =
          _mm512_cmpneq_epi16_mask(x, _mm512_setzero_si512());
      while (mask) {
        unsigned p = static_cast<unsigned>(__builtin_ctz(mask));
        mask &= mask - 1;
        int16_t xv = v[base + p];
        unsigned u = static_cast<uint16_t>(xv);
        unsigned lo = u & 0xFF, hi = (u >> 8) & 0xFF;
        unsigned neg = static_cast<unsigned>(xv < 0);
        unsigned hi_ne_sb =
            static_cast<unsigned>(hi != (neg ? 0xFFu : 0u));
        cs.freq[lo]++;
        cs.freq[hi] += hi_ne_sb;
        cs.freq[0xFF] += neg * (3 - hi_ne_sb);
      }
      base += 32;
    }
    return static_cast<size_t>(cs.freq[0] + cs.freq[255]);
  }
#endif
  if (mode == 2) {
    size_t i = 0, acc = 0;
    while (i < n_coeffs) {
      if (v[i] == 0) {
        i = zero_span16(v, i, n_coeffs);
      } else {
        ++acc;
        ++i;
      }
    }
    return acc;
  }
  CoeffScan cs;
  cs.toks = coeff_token_scratch(2 * n_coeffs + 16);
  if (mode == 1) {
    scan_coeffs_fast(v, n_coeffs, cs, nullptr);
    return cs.ntok;
  }
  RunAdler ad;
  scan_coeffs_fast(v, n_coeffs, cs, &ad);
  return cs.ntok + (ad.value() & 1);
}

// TEMPORARY benchmark probe: split one chunk's encode into scan / huffman
// table build / token replay, reporting nanoseconds per phase.
#include <chrono>
extern "C" size_t aej_bench_payload16_split(const int16_t* v, size_t n_coeffs,
                                            int64_t* ns_out /* [3] */) {
  using clk = std::chrono::steady_clock;
  auto t0 = clk::now();
  CoeffScan cs;
  cs.toks = coeff_token_scratch(2 * n_coeffs + 16);
  RunAdler ad;
  scan_coeffs_fast(v, n_coeffs, cs, &ad);
  cs.freq[256]++;
  auto t1 = clk::now();
  std::vector<unsigned char> body;
  int64_t replay_ns = 0;
  emit_block_with(cs.freq, cs.dfreq, true, &body,
                  [&](PtrBitWriter& bw, const uint32_t* ll_ent,
                      const uint16_t* d_codes, const uint8_t* d_lens) {
                    auto r0 = clk::now();
                    emit_coeff_tokens(cs.toks, cs.ntok, bw, ll_ent,
                                      d_codes, d_lens);
                    replay_ns = std::chrono::duration_cast<
                        std::chrono::nanoseconds>(clk::now() - r0).count();
                  });
  auto t2 = clk::now();
  ns_out[0] = std::chrono::duration_cast<std::chrono::nanoseconds>(
      t1 - t0).count();
  ns_out[1] = std::chrono::duration_cast<std::chrono::nanoseconds>(
      t2 - t1).count() - replay_ns;
  ns_out[2] = replay_ns;
  return body.size();
}
