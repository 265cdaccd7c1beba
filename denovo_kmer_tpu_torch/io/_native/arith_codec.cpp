// The PyTorch/CUDA port's own copy of denovo_kmer_tpu/io/_native/arith_codec.cpp (same code, same
// C ABI), built with bam_ingest.cpp into one library by denovo_kmer_tpu_torch/io/native.py.
//
// Native adaptive-arithmetic entropy decoder: the hot loop of CRAM 3.1 block
// method 6 (io/arith.py) and the entropy substrate shared with fqzcomp/tok3.
//
// Port of io/range_coder.py (carry-counting range decoder + SimpleModel) and
// io/arith.py::_decode_entropy — the Python implementations stay the normative
// reference (differential-tested in tests/test_native_arith.py); this exists
// because the per-symbol adaptive-model loop runs ~1 Kreads/s in Python
// (~800x slower than the native rANS path) — "supported but unusable" for a
// production feeder. Flag parsing, PACK/STRIPE/CAT/EXT transforms stay in
// Python (cheap, numpy-vectorized); only the range-coded payload lands here.
//
// Exported (ctypes, io/native.py): dk_arith_entropy_decode. Returns 0 on
// success, negative on malformed input; never reads past in_len (the range
// coder zero-fills past EOF exactly like the Python reference) and never
// writes past out_len.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace arith {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t STEP = 16;
constexpr uint32_t MAX_FREQ = (1u << 16) - 16;

struct RC {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
  uint32_t range;
  uint32_t code;
  uint8_t in() {
    if (pos < len) return buf[pos++];
    pos++;  // zero-fill past the end (encoder's 5-byte tail covers real payload)
    return 0;
  }
  void init() {
    range = 0xFFFFFFFFu;
    uint64_t c = 0;
    // 5-byte prime: the first byte is the encoder's initial empty cache and
    // falls off the top of the 32-bit window
    for (int i = 0; i < 5; i++) c = (c << 8) | in();
    code = (uint32_t)c;
  }
  uint32_t get_freq(uint32_t tot) {
    range /= tot;
    return code / range;
  }
  void decode(uint32_t cum, uint32_t freq) {
    code -= cum * range;
    range *= freq;
    while (range < TOP) {
      code = (code << 8) | in();
      range <<= 8;
    }
  }
};

// Adaptive frequency model (io/range_coder.py SimpleModel): linear scan with a
// one-place move-toward-front bubble; the array order is coded state.
struct Model {
  uint32_t total;
  uint16_t nsym;
  uint16_t freq[256];
  uint8_t sym[256];
  void init(int n) {
    total = (uint32_t)n;
    nsym = (uint16_t)n;
    for (int i = 0; i < n; i++) {
      freq[i] = 1;
      sym[i] = (uint8_t)i;
    }
  }
  int decode(RC& rc) {  // symbol, or -1 on corrupt stream
    uint32_t target = rc.get_freq(total);
    if (target >= total) return -1;
    uint32_t acc = 0;
    int i = 0;
    while (acc + freq[i] <= target) acc += freq[i++];  // terminates: target < total
    rc.decode(acc, freq[i]);
    int s = sym[i];
    freq[i] = (uint16_t)(freq[i] + STEP);
    total += STEP;
    if (total > MAX_FREQ) {
      uint32_t t = 0;
      for (int j = 0; j < nsym; j++) {
        uint16_t f = (uint16_t)(freq[j] - (freq[j] >> 1));
        freq[j] = f;
        t += f;
      }
      total = t;
    }
    if (i > 0 && freq[i] > freq[i - 1]) {
      uint16_t tf = freq[i - 1];
      freq[i - 1] = freq[i];
      freq[i] = tf;
      uint8_t ts = sym[i - 1];
      sym[i - 1] = sym[i];
      sym[i] = ts;
    }
    return s;
  }
};

// lazily-initialized model bank (256 literal contexts / 258 run contexts)
struct Bank {
  std::vector<Model> models;
  std::vector<uint8_t> live;
  explicit Bank(int n) : models(n), live(n, 0) {}
  Model& get(int i) {
    if (!live[i]) {
      models[i].init(256);
      live[i] = 1;
    }
    return models[i];
  }
};

int entropy_decode(const uint8_t* in, int64_t in_len, int64_t pos, uint8_t* out,
                   int64_t out_len, int order, int rle) {
  if (pos < 0 || pos > in_len) return -1;
  RC rc{in, in_len, pos, 0, 0};
  rc.init();
  Bank lit(order ? 256 : 1);

  if (!rle) {
    int prev = 0;
    for (int64_t i = 0; i < out_len; i++) {
      int b = lit.get(order ? prev : 0).decode(rc);
      if (b < 0) return -2;
      out[i] = (uint8_t)b;
      prev = b;
    }
    return 0;
  }

  Bank runm(258);
  int prev = 0;
  int64_t o = 0;
  while (o < out_len) {
    int b = lit.get(order ? prev : 0).decode(rc);
    if (b < 0) return -2;
    prev = b;
    uint64_t r = 0;
    int ctx = b;
    for (;;) {
      int chunk = runm.get(ctx).decode(rc);
      if (chunk < 0) return -2;
      r += (uint64_t)chunk;
      if (chunk < 255) break;
      ctx = (ctx == b) ? 256 : 257;
    }
    if (o + (int64_t)r + 1 > out_len) return -3;  // RLE run overran output
    memset(out + o, b, (size_t)r + 1);
    o += (int64_t)r + 1;
  }
  return 0;
}

// ------------------------------------------------------------------ fqzcomp
// Record loop of the fqzcomp quality codec (CRAM 3.1 method 7, io/fqz.py):
// header parse + CRC verification stay in Python; this decodes the range-coded
// stream (in-stream record lengths, dedup bits, context-modelled qualities).
// Context = (q1, q2-trend, position bucket, delta) exactly as io/fqz.py ctx_of.

struct FqzCtxPool {
  // up to 2^16 contexts, allocated lazily (typical blocks touch thousands)
  std::vector<Model> pool;
  std::vector<int32_t> index;
  int nsym;
  FqzCtxPool(int nctx, int nsym_) : index(nctx, -1), nsym(nsym_) {}
  Model& get(uint32_t ctx) {
    int32_t i = index[ctx];
    if (i < 0) {
      i = (int32_t)pool.size();
      pool.emplace_back();
      pool.back().init(nsym);
      index[ctx] = i;
    }
    return pool[i];
  }
};

int fqz_decode(const uint8_t* in, int64_t in_len, int64_t pos,
               const uint8_t* qmap, int nsym, int qbits, int q2bits, int pbits,
               int dbits, int dedup, uint8_t* out, int64_t ulen) {
  if (pos < 0 || pos > in_len) return -1;
  arith::RC rc{in, in_len, pos, 0, 0};
  rc.init();
  FqzCtxPool qual(1 << (qbits + q2bits + pbits + dbits), nsym);
  Model lens[4];
  for (int i = 0; i < 4; i++) lens[i].init(256);
  Model dup;
  dup.init(2);
  const uint32_t qmask = (1u << qbits) - 1;
  const uint32_t tmask = (1u << q2bits) - 1;
  const uint32_t dmask = (1u << dbits) - 1;
  const int64_t half = (int64_t)1 << (pbits - 1);

  int64_t o = 0;
  int64_t prev_off = -1, prev_len = -1;
  while (o < ulen) {
    if (rc.pos > in_len + 8) return -2;  // consuming zero-fill: truncated stream
    int64_t ln = 0;
    for (int i = 0; i < 4; i++) {
      int s = lens[i].decode(rc);
      if (s < 0) return -4;
      ln |= (int64_t)s << (8 * i);
    }
    if (o + ln > ulen) return -3;
    if (dedup && prev_len >= 0 && ln == prev_len) {
      int d = dup.decode(rc);
      if (d < 0) return -4;
      if (d) {
        memmove(out + o, out + prev_off, (size_t)ln);
        o += ln;
        continue;
      }
    }
    uint32_t q1 = 0, q2 = 0, delta = 0;
    for (int64_t p = 0; p < ln; p++) {
      // ctx_of: q2 enters as a trend; nonuniform position bucket (exact for the
      // first half of bucket space, 8-coarse after)
      uint32_t trend = (q2 == q1) ? 0 : (q2 < q1 ? 1 : 2);
      int64_t pb = p < half ? p : half + std::min((p - half) >> 3, half - 1);
      uint32_t c = std::min(q1, qmask);
      c = (c << q2bits) | std::min(trend, tmask);
      c = (c << pbits) | (uint32_t)pb;
      c = (c << dbits) | std::min(delta, dmask);
      int qi = qual.get(c).decode(rc);
      if (qi < 0) return -4;
      out[o + p] = qmap[qi];
      if ((uint32_t)qi != q1) delta++;
      q2 = q1;
      q1 = (uint32_t)qi;
    }
    prev_off = o;
    prev_len = ln;
    o += ln;
  }
  return 0;
}

}  // namespace arith

extern "C" {

int dk_arith_entropy_decode(const uint8_t* in, int64_t in_len, int64_t pos,
                            uint8_t* out, int64_t out_len, int order, int rle) {
  return arith::entropy_decode(in, in_len, pos, out, out_len, order, rle);
}

int dk_fqz_decode(const uint8_t* in, int64_t in_len, int64_t pos,
                  const uint8_t* qmap, int nsym, int qbits, int q2bits,
                  int pbits, int dbits, int dedup, uint8_t* out, int64_t ulen) {
  return arith::fqz_decode(in, in_len, pos, qmap, nsym, qbits, q2bits, pbits,
                           dbits, dedup, out, ulen);
}

}  // extern "C"
