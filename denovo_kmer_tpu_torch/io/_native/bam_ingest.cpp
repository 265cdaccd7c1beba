// bam_ingest — native host feeder: block-parallel BGZF inflate + BAM record parse + 2-bit pack.
//
// The PyTorch/CUDA port's own copy of denovo_kmer_tpu/io/_native/bam_ingest.cpp (same code,
// same C ABI), built by denovo_kmer_tpu_torch/io/native.py. It stands in for the HTSlib
// ingest layer (SURVEY.md §1 L0/L1, which links libdeflate — htslib's block-parallel
// decompression). Decodes BAM records and packs read bases directly into the engine's
// device-feed layout (see denovo_kmer_tpu_torch/ops/pack.py):
//   words  (B, Lp/16) u32 — base j at bits 2*(j%16) of word j/16 (LSB-first)
//   vwords (B, Lp/32) u32 — validity bit j at bit j%32 of word j/32
// applying the record flag filter and base-quality policy of SPEC_SEMANTICS.md §4 on the fly.
//
// Round-2 throughput design: BGZF blocks are independently inflatable, so a pool of worker
// threads (DENOVO_KMER_INGEST_THREADS, default 4, 0 = synchronous) inflates a ring of
// read-ahead blocks while the caller thread parses records and packs bases. Packing runs a
// per-BYTE lookup (two bases per step) instead of per-base; the per-base path remains only
// when a min-base-quality policy needs per-base quality reads.
//
// Exposed as a plain C ABI for ctypes. Single stream per handle; one handle per thread.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>
#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

constexpr size_t kMaxBlock = 0x10000;  // 64 KiB BGZF uncompressed limit
constexpr size_t kRing = 64;           // read-ahead ring slots (~1.1 MiB compressed)

struct Slot {
  enum State { EMPTY, COMP, INFLATING, READY, FAILED };
  State state = EMPTY;
  long coffset = 0;
  std::vector<uint8_t> cdata;
  uint32_t isize = 0;
  std::vector<uint8_t> udata;
  std::string err;
};

bool inflate_block(const uint8_t* cdata, size_t clen, uint8_t* out, uint32_t isize,
                   std::string* err) {
  if (isize == 0) return true;
#ifdef HAVE_LIBDEFLATE
  // one-shot whole-block decompress — ~2-3x zlib's streaming inflate; BGZF blocks are
  // complete raw-DEFLATE members, exactly libdeflate's fast path (the reference links
  // libdeflate for the same reason, SURVEY.md §0.1 ci.yml:27)
  static thread_local libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
  if (dec) {
    size_t actual = 0;
    if (libdeflate_deflate_decompress(dec, cdata, clen, out, isize, &actual) !=
            LIBDEFLATE_SUCCESS ||
        actual != isize) {
      *err = "BGZF inflate failed";
      return false;
    }
    return true;
  }
#endif
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) {
    *err = "inflateInit2 failed";
    return false;
  }
  zs.next_in = const_cast<uint8_t*>(cdata);
  zs.avail_in = (uInt)clen;
  zs.next_out = out;
  zs.avail_out = isize;
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END || zs.total_out != isize) {
    *err = "BGZF inflate failed";
    return false;
  }
  return true;
}

struct Reader {
  FILE* f = nullptr;
  std::string error;

  // current inflated block (being parsed)
  std::vector<uint8_t> block;
  size_t within = 0;
  long block_coffset = 0;
  bool eof = false;  // consumed past the last block

  // config
  int filter_flag_mask = 0;
  int min_base_quality = 0;
  int max_read_len = 0;

  int64_t n_records_seen = 0;

  // ---- decode-ahead pool (workers inflate; only the caller thread touches `f`) ----
  int n_threads = 0;
  std::vector<Slot> ring;
  uint64_t head = 0;    // sequence number of the next block the consumer takes
  uint64_t filled = 0;  // sequence number after the last compressed block read in
  bool raw_eof = false; // no more compressed blocks in the file
  std::string io_error; // compressed-stream read error (set by caller thread)
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_work;  // signals workers: a COMP slot exists / stop
  std::condition_variable cv_done;  // signals consumer: a slot became READY/FAILED
  std::vector<std::thread> workers;

  ~Reader() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    if (f) fclose(f);
  }
};

// Read one compressed block's header+body from `f` (caller thread only).
// Returns: 1 = block read into (coffset, cdata, isize); 0 = clean EOF; -1 = error (io_error).
int read_compressed(Reader* r, long* coffset, std::vector<uint8_t>* cdata,
                    uint32_t* isize) {
  *coffset = ftell(r->f);
  uint8_t hdr[12];
  size_t got = fread(hdr, 1, 12, r->f);
  if (got == 0) return 0;
  if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 || !(hdr[3] & 4)) {
    r->io_error = "bad BGZF block header";
    return -1;
  }
  uint16_t xlen = hdr[10] | (hdr[11] << 8);
  std::vector<uint8_t> extra(xlen);
  if (fread(extra.data(), 1, xlen, r->f) != xlen) {
    r->io_error = "truncated BGZF extra field";
    return -1;
  }
  int bsize = -1;
  for (size_t off = 0; off + 4 <= xlen;) {
    uint8_t si1 = extra[off], si2 = extra[off + 1];
    uint16_t slen = extra[off + 2] | (extra[off + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2)
      bsize = (extra[off + 4] | (extra[off + 5] << 8)) + 1;
    off += 4 + slen;
  }
  if (bsize < 0) {
    r->io_error = "missing BC subfield";
    return -1;
  }
  size_t cdata_len = bsize - 12 - xlen - 8;
  cdata->resize(cdata_len);
  uint8_t tail[8];
  if (fread(cdata->data(), 1, cdata_len, r->f) != cdata_len ||
      fread(tail, 1, 8, r->f) != 8) {
    r->io_error = "truncated BGZF block body";
    return -1;
  }
  memcpy(isize, tail + 4, 4);
  if (*isize > kMaxBlock) {
    r->io_error = "BGZF ISIZE too large";
    return -1;
  }
  return 1;
}

void worker_main(Reader* r) {
  for (;;) {
    size_t idx = kRing;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      for (;;) {
        if (r->stop) return;
        for (size_t i = 0; i < kRing; i++) {
          if (r->ring[i].state == Slot::COMP) {
            idx = i;
            break;
          }
        }
        if (idx != kRing) break;
        r->cv_work.wait(lk);
      }
      r->ring[idx].state = Slot::INFLATING;
    }
    Slot& s = r->ring[idx];
    s.udata.resize(s.isize);
    std::string err;
    bool ok = inflate_block(s.cdata.data(), s.cdata.size(), s.udata.data(), s.isize,
                            &err);
    {
      std::unique_lock<std::mutex> lk(r->mu);
      s.err = err;
      s.state = ok ? Slot::READY : Slot::FAILED;
    }
    r->cv_done.notify_all();
  }
}

// Keep the ring topped up with compressed blocks (caller thread only).
void fill_ahead(Reader* r) {
  while (!r->raw_eof && r->io_error.empty() && r->filled - r->head < kRing) {
    Slot& s = r->ring[r->filled % kRing];
    // slot is guaranteed EMPTY: consumer empties in order and filled-head < kRing
    int rc = read_compressed(r, &s.coffset, &s.cdata, &s.isize);
    if (rc == 0) {
      r->raw_eof = true;
      return;
    }
    if (rc < 0) return;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      s.state = Slot::COMP;
      r->filled++;
    }
    r->cv_work.notify_one();
  }
}

// Advance to the next inflated block (pool path). Returns false on EOF or error.
bool next_block_pooled(Reader* r) {
  fill_ahead(r);
  if (r->head == r->filled) {
    if (!r->io_error.empty()) {
      r->error = r->io_error;
      return false;
    }
    r->eof = true;
    return false;
  }
  Slot& s = r->ring[r->head % kRing];
  {
    std::unique_lock<std::mutex> lk(r->mu);
    while (s.state != Slot::READY && s.state != Slot::FAILED) r->cv_done.wait(lk);
    if (s.state == Slot::FAILED) {
      r->error = s.err;
      return false;
    }
    r->block.swap(s.udata);
    r->block_coffset = s.coffset;
    s.state = Slot::EMPTY;
    s.udata.clear();
    r->head++;
  }
  r->within = 0;
  fill_ahead(r);
  return true;
}

// Synchronous path (n_threads == 0): read + inflate inline.
bool next_block_sync(Reader* r) {
  long coffset;
  std::vector<uint8_t> cdata;
  uint32_t isize;
  int rc = read_compressed(r, &coffset, &cdata, &isize);
  if (rc == 0) {
    r->eof = true;
    return false;
  }
  if (rc < 0) {
    r->error = r->io_error;
    return false;
  }
  r->block.resize(isize);
  std::string err;
  if (!inflate_block(cdata.data(), cdata.size(), r->block.data(), isize, &err)) {
    r->error = err;
    return false;
  }
  r->block_coffset = coffset;
  r->within = 0;
  return true;
}

bool read_block(Reader* r) {
  return r->n_threads > 0 ? next_block_pooled(r) : next_block_sync(r);
}

// Discard all in-flight ring state (before a seek). Caller thread only.
void drain_ring(Reader* r) {
  if (r->n_threads == 0) return;
  std::unique_lock<std::mutex> lk(r->mu);
  for (;;) {
    bool busy = false;
    for (auto& s : r->ring)
      if (s.state == Slot::INFLATING) busy = true;
    if (!busy) break;
    r->cv_done.wait(lk);
  }
  for (auto& s : r->ring) {
    s.state = Slot::EMPTY;
    s.udata.clear();
    s.cdata.clear();
  }
  r->head = r->filled = 0;
}

// read exactly n bytes of the uncompressed stream into dst; false on EOF/error
bool uread(Reader* r, uint8_t* dst, size_t n) {
  size_t need = n;
  while (need > 0) {
    size_t avail = r->block.size() - r->within;
    if (avail == 0) {
      if (r->eof || !read_block(r)) return false;
      continue;
    }
    size_t take = avail < need ? avail : need;
    memcpy(dst + (n - need), r->block.data() + r->within, take);
    r->within += take;
    need -= take;
  }
  return true;
}

bool uskip(Reader* r, size_t n) {
  while (n > 0) {
    size_t avail = r->block.size() - r->within;
    if (avail == 0) {
      if (r->eof || !read_block(r)) return false;
      continue;
    }
    size_t take = avail < n ? avail : n;
    r->within += take;
    n -= take;
  }
  return true;
}

// at clean end-of-stream?
bool at_eof(Reader* r) {
  while (r->within >= r->block.size()) {
    if (r->eof) return true;
    if (!read_block(r)) return r->error.empty();
  }
  return false;
}

// ---------------- BAM nibble decode LUTs ----------------
// BAM SEQ nibbles: 1=A 2=C 4=G 8=T, others invalid (SAMv1 §4.2.3); 2-bit codes A0 C1 G2 T3.

struct NibLut {
  uint8_t code4[256];  // low 2 bits: first base code; bits 2-3: second base code
  uint8_t valid2[256]; // bit0: first base valid, bit1: second base valid
};

NibLut make_lut() {
  NibLut lut{};
  auto dec = [](int nib, uint8_t* code) -> bool {
    switch (nib) {
      case 1: *code = 0; return true;   // A
      case 2: *code = 1; return true;   // C
      case 4: *code = 2; return true;   // G
      case 8: *code = 3; return true;   // T
      default: *code = 0; return false; // N / ambiguity codes
    }
  };
  for (int b = 0; b < 256; b++) {
    uint8_t c0, c1;
    bool v0 = dec(b >> 4, &c0);
    bool v1 = dec(b & 0xF, &c1);
    lut.code4[b] = (uint8_t)(c0 | (c1 << 2));
    lut.valid2[b] = (uint8_t)((v0 ? 1 : 0) | (v1 ? 2 : 0));
  }
  return lut;
}

const NibLut kLut = make_lut();

int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

int env_threads() {
  const char* e = getenv("DENOVO_KMER_INGEST_THREADS");
  if (!e || !*e) return 4;
  int v = atoi(e);
  if (v < 0) v = 0;
  if (v > 16) v = 16;
  return v;
}

}  // namespace

extern "C" {

// Open a BAM file; parses the header. Returns handle or nullptr.
void* bam_ingest_open(const char* path, int filter_flag_mask, int min_base_quality,
                      int max_read_len) {
  Reader* r = new Reader();
  r->filter_flag_mask = filter_flag_mask;
  r->min_base_quality = min_base_quality;
  r->max_read_len = max_read_len;
  r->f = fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  r->n_threads = env_threads();
  if (r->n_threads > 0) {
    r->ring.resize(kRing);
    for (int i = 0; i < r->n_threads; i++)
      r->workers.emplace_back(worker_main, r);
  }
  uint8_t magic[4];
  if (!uread(r, magic, 4) || memcmp(magic, "BAM\x01", 4) != 0) {
    delete r;
    return nullptr;
  }
  uint8_t b4[4];
  if (!uread(r, b4, 4)) goto fail;
  if (!uskip(r, (size_t)rd_i32(b4))) goto fail;  // header text
  if (!uread(r, b4, 4)) goto fail;
  {
    int n_ref = rd_i32(b4);
    for (int i = 0; i < n_ref; i++) {
      if (!uread(r, b4, 4)) goto fail;
      if (!uskip(r, (size_t)rd_i32(b4) + 4)) goto fail;  // name + l_ref
    }
  }
  return r;
fail:
  delete r;
  return nullptr;
}

// Fill up to batch_reads packed reads. words: batch_reads*(lp/16) u32, vwords:
// batch_reads*(lp/32) u32, lengths: batch_reads i32 — all caller-allocated and ZEROED by
// this function. lp = padded length = ceil(max_read_len/32)*32.
// Returns reads packed (record-filter already applied), 0 at EOF, -1 on error.
int64_t bam_ingest_next_batch(void* handle, int64_t batch_reads, uint32_t* words,
                              uint32_t* vwords, int32_t* lengths) {
  Reader* r = (Reader*)handle;
  const int lp = ((r->max_read_len + 31) / 32) * 32;
  const int wpr = lp / 16;   // words per read
  const int vpr = lp / 32;   // vwords per read
  memset(words, 0, (size_t)batch_reads * wpr * 4);
  memset(vwords, 0, (size_t)batch_reads * vpr * 4);
  memset(lengths, 0, (size_t)batch_reads * 4);

  std::vector<uint8_t> rec;
  int64_t out = 0;
  while (out < batch_reads) {
    if (at_eof(r)) break;
    const uint8_t* recp;
    int32_t block_size;
    // fast path: record fully inside the current inflated block → parse IN PLACE
    // (the per-record uread memcpy dominated the single-thread profile; ~97% of
    // records don't straddle a 64 KiB block boundary at short-read sizes)
    if (r->within + 4 <= r->block.size() &&
        (block_size = rd_i32(r->block.data() + r->within), true) &&
        block_size >= 32 &&
        r->within + 4 + (size_t)block_size <= r->block.size()) {
      recp = r->block.data() + r->within + 4;
      r->within += 4 + (size_t)block_size;
    } else {
      uint8_t b4[4];
      if (!uread(r, b4, 4)) {
        if (r->error.empty()) break;  // clean EOF
        return -1;
      }
      block_size = rd_i32(b4);
      if (block_size < 32) {
        r->error = "record block_size too small";
        return -1;
      }
      rec.resize(block_size);
      if (!uread(r, rec.data(), block_size)) {
        r->error = "truncated record";
        return -1;
      }
      recp = rec.data();
    }
    r->n_records_seen++;

    uint16_t flag = rd_u16(recp + 14);
    if (flag & r->filter_flag_mask) continue;
    uint8_t l_read_name = recp[8];
    uint16_t n_cigar = rd_u16(recp + 12);
    int32_t l_seq = rd_i32(recp + 16);
    size_t off = 32 + l_read_name + 4ull * n_cigar;
    size_t seq_bytes = ((size_t)l_seq + 1) / 2;
    if (off + seq_bytes + (size_t)l_seq > (size_t)block_size) {
      r->error = "record SEQ/QUAL out of bounds";
      return -1;
    }
    const uint8_t* seq = recp + off;
    const uint8_t* qual = seq + seq_bytes;

    int n = l_seq < r->max_read_len ? l_seq : r->max_read_len;
    uint32_t* wrow = words + out * wpr;
    uint32_t* vrow = vwords + out * vpr;
    if (r->min_base_quality > 0) {
      // per-base path: quality policy needs each base's QUAL byte
      for (int j = 0; j < n; j++) {
        uint8_t byte = seq[j >> 1];
        int half = j & 1;
        uint32_t code = (kLut.code4[byte] >> (2 * half)) & 3u;
        uint32_t valid = (kLut.valid2[byte] >> half) & 1u;
        if (qual[j] != 0xFF && qual[j] < r->min_base_quality) valid = 0;
        wrow[j >> 4] |= code << (2 * (j & 15));
        vrow[j >> 5] |= valid << (j & 31);
      }
    } else {
      // per-byte path: two bases per lookup (the common no-quality-filter config)
      int nbytes = (n + 1) / 2;
      for (int i = 0; i < nbytes; i++) {
        uint8_t b = seq[i];
        wrow[i >> 3] |= (uint32_t)kLut.code4[b] << (4 * (i & 7));
        vrow[i >> 4] |= (uint32_t)kLut.valid2[b] << (2 * (i & 15));
      }
      if (n & 1) {
        // odd truncation: the last processed byte's low nibble is base n (beyond the
        // kept length) — scrub its code and validity bit
        wrow[n >> 4] &= ~(3u << (2 * (n & 15)));
        vrow[n >> 5] &= ~(1u << (n & 31));
      }
    }
    lengths[out] = n;
    out++;
  }
  return out;
}

// htslib-style virtual offsets for multi-host range sharding (SURVEY.md §5.8)
int64_t bam_ingest_tell_virtual(void* handle) {
  Reader* r = (Reader*)handle;
  return ((int64_t)r->block_coffset << 16) | (int64_t)r->within;
}

int bam_ingest_seek_virtual(void* handle, int64_t voffset) {
  Reader* r = (Reader*)handle;
  long coff = (long)(voffset >> 16);
  size_t within = (size_t)(voffset & 0xFFFF);
  drain_ring(r);
  r->io_error.clear();
  r->raw_eof = false;
  if (fseek(r->f, coff, SEEK_SET) != 0) return -1;
  r->eof = false;
  r->block.clear();
  r->within = 0;
  if (!read_block(r)) {
    // a cursor taken at end-of-stream points at the EOF marker / file end with
    // within == 0 — a valid "at EOF" position (resume checkpoints persist it)
    if (r->eof && within == 0) return 0;
    return -1;
  }
  if (within > r->block.size()) return -1;
  r->within = within;
  return 0;
}

int64_t bam_ingest_records_seen(void* handle) {
  return ((Reader*)handle)->n_records_seen;
}

const char* bam_ingest_error(void* handle) {
  return ((Reader*)handle)->error.c_str();
}

void bam_ingest_close(void* handle) {
  delete (Reader*)handle;
}

// One-shot gzip-member decompress for CRAM gzip blocks (io/cram.py _decompress):
// libdeflate's whole-buffer path, ~2-3x zlib streaming. Returns the decompressed
// size, or -1 on any mismatch OR when built without libdeflate (caller falls back
// to Python zlib, which also accepts zlib-wrapped streams).
int64_t dk_gzip_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                           int64_t out_len) {
#ifdef HAVE_LIBDEFLATE
  static thread_local libdeflate_decompressor* dec =
      libdeflate_alloc_decompressor();
  if (!dec || in_len <= 0) return -1;
  size_t actual = 0;
  if (libdeflate_gzip_decompress(dec, in, (size_t)in_len, out, (size_t)out_len,
                                 &actual) != LIBDEFLATE_SUCCESS)
    return -1;
  return (int64_t)actual;
#else
  (void)in; (void)in_len; (void)out; (void)out_len;
  return -1;
#endif
}

// Raw-DEFLATE one-shot (io/bgzf.py's pure-Python reader — the remote-BAM and
// BAI/VCF.gz paths that don't go through the native feeder ring).
int64_t dk_deflate_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                              int64_t out_len) {
#ifdef HAVE_LIBDEFLATE
  static thread_local libdeflate_decompressor* dec =
      libdeflate_alloc_decompressor();
  if (!dec || in_len < 0) return -1;
  size_t actual = 0;
  if (libdeflate_deflate_decompress(dec, in, (size_t)in_len, out,
                                    (size_t)out_len, &actual) !=
      LIBDEFLATE_SUCCESS)
    return -1;
  return (int64_t)actual;
#else
  (void)in; (void)in_len; (void)out; (void)out_len;
  return -1;
#endif
}

}  // extern "C"
