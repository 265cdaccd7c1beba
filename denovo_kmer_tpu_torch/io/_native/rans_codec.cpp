// The PyTorch/CUDA port's own copy of denovo_kmer_tpu/io/_native/rans_codec.cpp (same code, same
// C ABI), built with bam_ingest.cpp into one library by denovo_kmer_tpu_torch/io/native.py.
//
// Native rANS decoders for the CRAM feeder: 4x8 (CRAM 3.0 method 4) and Nx16
// (CRAM 3.1 method 5). Byte-format mirrors of io/rans.py and io/rans_nx16.py —
// the Python implementations stay the normative reference (differential-tested in
// tests/test_native_rans.py); these exist because pure-Python entropy decode runs
// ~1 MB/s and the feeder contract wants hundreds (SURVEY.md §2.1 native-code
// checklist: the decompression hot loops are HTSlib C territory in the reference).
//
// Exported (ctypes, io/rans.py + io/rans_nx16.py pick these up when the shim is
// built): dk_rans4x8_decode, dk_rans_nx16_decode. Return 0 on success, negative
// on malformed input; they never read past in_len or write past out_len.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint8_t u8() {
    if (p >= end) { ok = false; return 0; }
    return *p++;
  }
  uint16_t u16le() {
    if (p + 2 > end) { ok = false; return 0; }
    uint16_t v = (uint16_t)(p[0] | (p[1] << 8));
    p += 2;
    return v;
  }
  uint32_t u32le() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v;
    memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  uint64_t uint7() {  // big-endian base-128 varint
    uint64_t v = 0;
    for (int i = 0; i < 10; i++) {
      uint8_t b = u8();
      if (!ok) return 0;
      v = (v << 7) | (b & 0x7F);
      if (!(b & 0x80)) return v;
    }
    ok = false;
    return 0;
  }
};

// ---------------------------------------------------------------- rANS 4x8

// spec §13 RLE'd key list: calls take(sym) per present key; returns false on error
template <typename F>
bool read_rle_keys(Cursor& c, F take) {
  int sym = c.u8();
  int last = -2;
  int rle = 0;
  bool explicit_read = true;
  while (c.ok) {
    if (explicit_read && last >= 0 && sym == last + 1) rle = c.u8();
    if (!take(sym)) return false;
    last = sym;
    if (rle) {
      rle--;
      sym = last + 1;
      explicit_read = false;
    } else {
      sym = c.u8();
      explicit_read = true;
      if (sym == 0) return c.ok;
    }
    if (sym > 255) return false;
  }
  return false;
}

// Packed decode-table entry, one 32-bit load per symbol instead of three array
// lookups (lut/freq/cum live on different cache lines; the packed form is the
// standard rANS layout, cf. htslib's rANS_static):
//   bits 20..31 = freq-1   (freq ∈ [1, 4096] — every reachable slot has freq ≥ 1)
//   bits  8..19 = bias     (slot - cum[sym], < 4096)
//   bits  0..7  = sym
// Works for any shift ≤ 12 (4x8 uses 12; Nx16 uses 10 or 12).
inline void build_ent(const uint16_t* freq, uint32_t* ent) {
  uint32_t acc = 0;
  for (uint32_t s = 0; s < 256; s++) {
    uint32_t f = freq[s];
    for (uint32_t i = 0; i < f; i++, acc++)
      ent[acc] = ((f - 1) << 20) | (i << 8) | s;
  }
}

inline uint32_t ent_step(uint32_t x, uint32_t e, uint32_t shift) {
  return ((e >> 20) + 1) * (x >> shift) + ((e >> 8) & 4095);
}

struct FreqHdr {  // header-side accumulation only; decode uses the ent table
  uint16_t freq[256] = {0};
  uint32_t total() const {
    uint32_t acc = 0;
    for (int s = 0; s < 256; s++) acc += freq[s];
    return acc;
  }
};

bool read_freqs_4x8(Cursor& c, FreqHdr& t) {
  return read_rle_keys(c, [&](int sym) {
    uint32_t f = c.u8();
    if (f >= 128) f = ((f & 0x7F) << 8) | c.u8();
    if (!c.ok) return false;
    t.freq[sym] = (uint16_t)f;
    return true;
  });
}

constexpr uint32_t RANS8_L = 1u << 23;

int rans4x8_decode_impl(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_len) {
  if (in_len < 9) return -1;
  Cursor c{in, in + in_len};
  uint8_t order = c.u8();
  c.u32le();  // compressed size (unused; in_len bounds us)
  uint32_t raw = c.u32le();
  if (!c.ok || (int64_t)raw != out_len) return -2;
  if (raw == 0) return 0;

  if (order == 0) {
    FreqHdr t;
    if (!read_freqs_4x8(c, t) || t.total() != 4096) return -3;
    std::vector<uint32_t> ent(4096);
    build_ent(t.freq, ent.data());
    uint32_t R[4];
    for (int j = 0; j < 4; j++) R[j] = c.u32le();
    if (!c.ok) return -4;
    const uint8_t* p = c.p;
    const uint8_t* end = c.end;
    uint32_t x0 = R[0], x1 = R[1], x2 = R[2], x3 = R[3];
    int64_t i = 0;
    // independent per-stream states in registers; renorm order is stream order
    for (int64_t n4 = out_len & ~(int64_t)3; i < n4; i += 4) {
      uint32_t e0 = ent[x0 & 4095];
      out[i] = (uint8_t)e0;
      x0 = ent_step(x0, e0, 12);
      while (x0 < RANS8_L && p < end) x0 = (x0 << 8) | *p++;
      uint32_t e1 = ent[x1 & 4095];
      out[i + 1] = (uint8_t)e1;
      x1 = ent_step(x1, e1, 12);
      while (x1 < RANS8_L && p < end) x1 = (x1 << 8) | *p++;
      uint32_t e2 = ent[x2 & 4095];
      out[i + 2] = (uint8_t)e2;
      x2 = ent_step(x2, e2, 12);
      while (x2 < RANS8_L && p < end) x2 = (x2 << 8) | *p++;
      uint32_t e3 = ent[x3 & 4095];
      out[i + 3] = (uint8_t)e3;
      x3 = ent_step(x3, e3, 12);
      while (x3 < RANS8_L && p < end) x3 = (x3 << 8) | *p++;
    }
    R[0] = x0; R[1] = x1; R[2] = x2; R[3] = x3;
    for (; i < out_len; i++) {
      uint32_t& x = R[i & 3];
      uint32_t e = ent[x & 4095];
      out[i] = (uint8_t)e;
      x = ent_step(x, e, 12);
      while (x < RANS8_L && p < end) x = (x << 8) | *p++;
    }
    return 0;
  }
  if (order == 1) {
    // context-major nested tables over the RLE'd context list; ent tables are
    // built lazily per PRESENT context (16 KB each) instead of zero-initializing
    // 256 table structs per block
    std::vector<std::vector<uint32_t>> pool;
    const uint32_t* etab[256] = {nullptr};
    bool ok = read_rle_keys(c, [&](int ctx) {
      FreqHdr t;
      if (!read_freqs_4x8(c, t) || t.total() != 4096) return false;
      pool.emplace_back(4096);
      build_ent(t.freq, pool.back().data());
      etab[ctx] = pool.back().data();
      return true;
    });
    if (!ok) return -3;
    uint32_t R[4];
    for (int j = 0; j < 4; j++) R[j] = c.u32le();
    if (!c.ok) return -4;
    int64_t n = out_len;
    int64_t q = n >> 2;
    const uint8_t* p = c.p;
    const uint8_t* end = c.end;
    uint32_t x0 = R[0], x1 = R[1], x2 = R[2], x3 = R[3];
    const uint32_t* t0 = etab[0];
    const uint32_t* t1 = etab[0];
    const uint32_t* t2 = etab[0];
    const uint32_t* t3 = etab[0];
    uint8_t* o0 = out;
    uint8_t* o1 = out + q;
    uint8_t* o2 = out + 2 * q;
    uint8_t* o3 = out + 3 * q;
    for (int64_t r = 0; r < q; r++) {
      // context-missing is checked at USE time (a symbol may name an absent
      // context as long as that stream never steps again) — matches io/rans.py
      if (!t0 || !t1 || !t2 || !t3) return -5;
      uint32_t e0 = t0[x0 & 4095];
      uint8_t s0 = (uint8_t)e0;
      o0[r] = s0;
      x0 = ent_step(x0, e0, 12);
      while (x0 < RANS8_L && p < end) x0 = (x0 << 8) | *p++;
      uint32_t e1 = t1[x1 & 4095];
      uint8_t s1 = (uint8_t)e1;
      o1[r] = s1;
      x1 = ent_step(x1, e1, 12);
      while (x1 < RANS8_L && p < end) x1 = (x1 << 8) | *p++;
      uint32_t e2 = t2[x2 & 4095];
      uint8_t s2 = (uint8_t)e2;
      o2[r] = s2;
      x2 = ent_step(x2, e2, 12);
      while (x2 < RANS8_L && p < end) x2 = (x2 << 8) | *p++;
      uint32_t e3 = t3[x3 & 4095];
      uint8_t s3 = (uint8_t)e3;
      o3[r] = s3;
      x3 = ent_step(x3, e3, 12);
      while (x3 < RANS8_L && p < end) x3 = (x3 << 8) | *p++;
      t0 = etab[s0]; t1 = etab[s1]; t2 = etab[s2]; t3 = etab[s3];
    }
    // stream 3 decodes the ragged tail (n not divisible by 4)
    uint32_t x = x3;
    const uint32_t* t = t3;
    for (int64_t at = 4 * q; at < n; at++) {
      if (!t) return -5;
      uint32_t e = t[x & 4095];
      uint8_t s = (uint8_t)e;
      out[at] = s;
      x = ent_step(x, e, 12);
      while (x < RANS8_L && p < end) x = (x << 8) | *p++;
      t = etab[s];
    }
    return 0;
  }
  return -6;
}

// ---------------------------------------------------------------- rANS Nx16

constexpr uint32_t NX16_L = 1u << 15;

enum : uint8_t {
  F_ORDER1 = 0x01, F_N32 = 0x04, F_STRIPE = 0x08, F_NOSZ = 0x10,
  F_CAT = 0x20, F_RLE = 0x40, F_PACK = 0x80,
};

// alphabet: ascending, consecutive-run byte, 0-terminated
bool read_alphabet(Cursor& c, std::vector<int>& syms) {
  int rle = 0;
  int sym = c.u8();
  while (c.ok) {
    if (sym > 255 || (int)syms.size() > 256) return false;
    syms.push_back(sym);
    if (rle > 0) {
      rle--;
      sym++;
    } else {
      int last = sym;
      sym = c.u8();
      if (sym == last + 1) rle = c.u8();
    }
    if (sym == 0) return c.ok;
  }
  return false;
}

bool decode_o0_payload_nx16(Cursor& c, uint8_t* out, int64_t out_len, int N) {
  std::vector<int> syms;
  if (!read_alphabet(c, syms)) return false;
  FreqHdr t;
  for (int s : syms) {
    uint64_t f = c.uint7();
    if (!c.ok || f > 4096) return false;
    t.freq[s] = (uint16_t)f;
  }
  if (t.total() != 4096) return false;
  std::vector<uint32_t> ent(4096);
  build_ent(t.freq, ent.data());
  std::vector<uint32_t> R(N);
  for (int j = 0; j < N; j++) R[j] = c.u32le();
  if (!c.ok) return false;
  const uint32_t kmask = (uint32_t)(N - 1);  // N ∈ {4, 32}
  for (int64_t i = 0; i < out_len; i++) {
    uint32_t& x = R[i & kmask];
    uint32_t e = ent[x & 4095];
    out[i] = (uint8_t)e;
    x = ent_step(x, e, 12);
    if (x < NX16_L) {
      if (c.p + 2 > c.end) {
        if (c.p < c.end) return false;  // odd trailing byte: malformed
      } else {
        x = (x << 16) | (uint32_t)(c.p[0] | (c.p[1] << 8));
        c.p += 2;
      }
    }
  }
  return true;
}

bool decode_o1_payload_nx16(Cursor& c, uint8_t* out, int64_t out_len, int N) {
  uint8_t hdr = c.u8();
  int shift = hdr >> 4;
  if (shift != 10 && shift != 12) return false;
  std::vector<uint8_t> tbl_store;
  Cursor tc = c;
  bool inline_tbl = !(hdr & 1);
  if (hdr & 1) {
    uint64_t c_len = c.uint7();
    uint64_t u_len = c.uint7();
    if (!c.ok || c.p + c_len > c.end) return false;
    tbl_store.resize(u_len);
    Cursor sub{c.p, c.p + c_len};
    if (!decode_o0_payload_nx16(sub, tbl_store.data(), (int64_t)u_len, 4))
      return false;
    c.p += c_len;
    tc = Cursor{tbl_store.data(), tbl_store.data() + tbl_store.size()};
  }
  std::vector<int> present;
  if (!read_alphabet(tc, present)) return false;
  uint32_t total = 1u << shift;
  // ent tables built lazily per PRESENT context (cf. rans4x8 order-1)
  std::vector<std::vector<uint32_t>> pool;
  const uint32_t* etab[256] = {nullptr};
  for (int ctx : present) {
    FreqHdr t;
    int run = 0;
    uint32_t acc = 0;
    for (int j : present) {
      if (run > 0) { run--; continue; }
      uint64_t f = tc.uint7();
      if (!tc.ok || f > total) return false;
      t.freq[j] = (uint16_t)f;
      acc += (uint32_t)f;
      if (f == 0) run = tc.u8();
    }
    if (acc == 0) continue;  // context never used: row omitted-equivalent
    if (acc != total) return false;
    pool.emplace_back(total);
    build_ent(t.freq, pool.back().data());
    etab[ctx] = pool.back().data();
  }
  if (inline_tbl) c = tc;
  std::vector<uint32_t> R(N);
  for (int j = 0; j < N; j++) R[j] = c.u32le();
  if (!c.ok) return false;
  int64_t frag = out_len / N;
  uint32_t mask = total - 1;
  // all N fragments have >= frag symbols, so rounds 0..frag-1 step every stream
  // in k order (identical byte-consumption order to the reference's round-robin);
  // the ragged remainder then belongs to stream N-1 alone
  const uint32_t* tptr[32];
  for (int k = 0; k < N; k++) tptr[k] = etab[0];
  const uint8_t* p = c.p;
  const uint8_t* end = c.end;
  for (int64_t r = 0; r < frag; r++) {
    for (int k = 0; k < N; k++) {
      const uint32_t* t = tptr[k];
      if (!t) return false;
      uint32_t& x = R[k];
      uint32_t e = t[x & mask];
      uint8_t s = (uint8_t)e;
      out[(int64_t)k * frag + r] = s;
      x = ent_step(x, e, shift);
      if (x < NX16_L && p + 2 <= end) {
        x = (x << 16) | (uint32_t)(p[0] | (p[1] << 8));
        p += 2;
      }
      tptr[k] = etab[s];
    }
  }
  {
    uint32_t x = R[N - 1];
    const uint32_t* t = tptr[N - 1];
    for (int64_t i = (int64_t)N * frag; i < out_len; i++) {
      if (!t) return false;
      uint32_t e = t[x & mask];
      uint8_t s = (uint8_t)e;
      out[i] = s;
      x = ent_step(x, e, shift);
      if (x < NX16_L && p + 2 <= end) {
        x = (x << 16) | (uint32_t)(p[0] | (p[1] << 8));
        p += 2;
      }
      t = etab[s];
    }
  }
  c.p = p;
  return true;
}

int nx16_decode_impl(const uint8_t* in, int64_t in_len, uint8_t* out,
                     int64_t out_len);

// one complete stream body (after flags+size handled by caller)
int nx16_decode_body(Cursor& c, uint8_t flags, uint8_t* out, int64_t ulen) {
  if (flags & F_STRIPE) {
    int X = c.u8();
    if (!c.ok || X <= 0 || X > 255) return -10;
    std::vector<uint64_t> clens(X);
    for (int j = 0; j < X; j++) clens[j] = c.uint7();
    if (!c.ok) return -10;
    std::vector<uint8_t> sub;
    for (int j = 0; j < X; j++) {
      int64_t sub_len = (ulen - j + X - 1) / X;
      if (c.p + clens[j] > c.end) return -10;
      sub.resize(sub_len);
      int rc = nx16_decode_impl(c.p, (int64_t)clens[j], sub.data(), sub_len);
      if (rc != 0) return rc;
      for (int64_t i = 0; i < sub_len; i++) out[(uint64_t)i * X + j] = sub[i];
      c.p += clens[j];
    }
    return 0;
  }
  if (flags & F_CAT) {
    if (c.p + ulen > c.end) return -11;
    memcpy(out, c.p, (size_t)ulen);
    c.p += ulen;
    return 0;
  }
  int N = (flags & F_N32) ? 32 : 4;
  int64_t final_len = ulen;

  // PACK meta
  std::vector<int> pack_syms;
  int64_t cur_len = final_len;
  if (flags & F_PACK) {
    int nsym = c.u8();
    if (!c.ok || nsym == 0 || nsym > 16) return -12;
    for (int i = 0; i < nsym; i++) pack_syms.push_back(c.u8());
    cur_len = (int64_t)c.uint7();
    if (!c.ok) return -12;
  }
  // RLE meta
  std::vector<uint8_t> rle_meta;
  int64_t rle_out_len = 0;
  bool do_rle = (flags & F_RLE) != 0;
  if (do_rle) {
    uint64_t m = c.uint7();
    uint64_t rans_len = c.uint7();
    if (!c.ok) return -13;
    rle_out_len = cur_len;
    if (m & 1) {
      uint64_t mlen = m >> 1;
      if (c.p + mlen > c.end) return -13;
      rle_meta.assign(c.p, c.p + mlen);
      c.p += mlen;
    } else {
      uint64_t c_len = c.uint7();
      if (!c.ok || c.p + c_len > c.end) return -13;
      rle_meta.resize(m >> 1);
      Cursor sub{c.p, c.p + c_len};
      if (!decode_o0_payload_nx16(sub, rle_meta.data(), (int64_t)(m >> 1), 4))
        return -13;
      c.p += c_len;
    }
    cur_len = (int64_t)rans_len;
  }

  std::vector<uint8_t> stage;
  uint8_t* entropy_out;
  bool staged = do_rle || (flags & F_PACK);
  if (staged) {
    stage.resize(cur_len);
    entropy_out = stage.data();
  } else {
    entropy_out = out;
  }
  bool ok = (flags & F_ORDER1)
                ? decode_o1_payload_nx16(c, entropy_out, cur_len, N)
                : decode_o0_payload_nx16(c, entropy_out, cur_len, N);
  if (!ok) return -14;

  std::vector<uint8_t> rle_stage;
  if (do_rle) {
    int nsym = rle_meta.empty() ? -1 : rle_meta[0];
    if (nsym < 0) return -15;
    int count = nsym == 0 ? 256 : nsym;
    if ((int)rle_meta.size() < 1 + count) return -15;
    uint8_t is_run[256] = {0};
    for (int i = 0; i < count; i++) is_run[rle_meta[1 + i]] = 1;
    Cursor mc{rle_meta.data() + 1 + count, rle_meta.data() + rle_meta.size()};
    uint8_t* dst = (flags & F_PACK) ? nullptr : out;
    if (flags & F_PACK) {
      rle_stage.resize(rle_out_len);
      dst = rle_stage.data();
    }
    int64_t o = 0;
    for (int64_t i = 0; i < cur_len; i++) {
      uint8_t s = entropy_out[i];
      if (o >= rle_out_len) return -15;
      dst[o++] = s;
      if (is_run[s]) {
        uint64_t run = mc.uint7();
        if (!mc.ok || o + (int64_t)run > rle_out_len) return -15;
        memset(dst + o, s, (size_t)run);
        o += (int64_t)run;
      }
    }
    if (o != rle_out_len) return -15;
    entropy_out = dst;
    cur_len = rle_out_len;
  }

  if (flags & F_PACK) {
    int nsym = (int)pack_syms.size();
    const uint8_t* src = entropy_out;
    if (nsym == 1) {
      memset(out, pack_syms[0], (size_t)final_len);
      return 0;
    }
    uint8_t lut[16];
    for (int i = 0; i < nsym; i++) lut[i] = (uint8_t)pack_syms[i];
    if (nsym <= 2) {
      for (int64_t i = 0; i < final_len; i++)
        out[i] = lut[(src[i >> 3] >> (i & 7)) & 1];
    } else if (nsym <= 4) {
      for (int64_t i = 0; i < final_len; i++)
        out[i] = lut[(src[i >> 2] >> (2 * (i & 3))) & 3];
    } else {
      for (int64_t i = 0; i < final_len; i++)
        out[i] = lut[(src[i >> 1] >> (4 * (i & 1))) & 15];
    }
  }
  return 0;
}

int nx16_decode_impl(const uint8_t* in, int64_t in_len, uint8_t* out,
                     int64_t out_len) {
  Cursor c{in, in + in_len};
  uint8_t flags = c.u8();
  if (!c.ok) return -1;
  int64_t ulen = out_len;
  if (!(flags & F_NOSZ)) {
    ulen = (int64_t)c.uint7();
    if (!c.ok || ulen != out_len) return -2;  // caller passes the block's raw size
  }
  return nx16_decode_body(c, flags, out, ulen);
}

}  // namespace

extern "C" {

int dk_rans4x8_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                      int64_t out_len) {
  return rans4x8_decode_impl(in, in_len, out, out_len);
}

int dk_rans_nx16_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_len) {
  return nx16_decode_impl(in, in_len, out, out_len);
}

}  // extern "C"
