// The PyTorch/CUDA port's own copy of denovo_kmer_tpu/io/_native/cram_util.cpp (same code, same
// C ABI), built with bam_ingest.cpp into one library by denovo_kmer_tpu_torch/io/native.py.
//
// Native CRAM container utilities for the ingest shim (loaded via io/native.py).
//
// dk_itf8_decode_run: decode up to max_n consecutive ITF8 varints starting at
// `pos`, writing the signed 32-bit values and the byte offset AFTER each frame.
// Mirrors io/cram.py itf8_decode exactly (differential-tested in
// tests/test_cram_native.py). A frame that would run past `len` is NOT decoded —
// the Python caller's scalar path re-reads it and raises the same IndexError the
// pure-Python reader would, so truncation semantics are unchanged.
//
// This exists because the CRAM record loop reads ~9 small integers per record
// (BF/CF/RL/AP/MQ/TL/NF/...), each an EXTERNAL itf8 stream: after the byte-run
// bulk reads landed, ~all remaining record-loop time was itf8_decode Python
// calls. One call here predecodes a whole block's frames.

#include <cstdint>

extern "C" int64_t dk_itf8_decode_run(const uint8_t* buf, int64_t len,
                                      int64_t pos, int64_t max_n,
                                      int64_t* vals, int64_t* ends) {
  int64_t n = 0;
  while (n < max_n && pos < len) {
    const uint8_t b0 = buf[pos];
    uint32_t v;
    int64_t width;
    if (b0 < 0x80) {
      v = b0;
      width = 1;
    } else if (b0 < 0xC0) {
      width = 2;
      if (pos + width > len) break;
      v = (uint32_t(b0 & 0x3F) << 8) | buf[pos + 1];
    } else if (b0 < 0xE0) {
      width = 3;
      if (pos + width > len) break;
      v = (uint32_t(b0 & 0x1F) << 16) | (uint32_t(buf[pos + 1]) << 8) |
          buf[pos + 2];
    } else if (b0 < 0xF0) {
      width = 4;
      if (pos + width > len) break;
      v = (uint32_t(b0 & 0x0F) << 24) | (uint32_t(buf[pos + 1]) << 16) |
          (uint32_t(buf[pos + 2]) << 8) | buf[pos + 3];
    } else {
      width = 5;
      if (pos + width > len) break;
      v = (uint32_t(b0 & 0x0F) << 28) | (uint32_t(buf[pos + 1]) << 20) |
          (uint32_t(buf[pos + 2]) << 12) | (uint32_t(buf[pos + 3]) << 4) |
          (buf[pos + 4] & 0x0F);
    }
    pos += width;
    vals[n] = int64_t(int32_t(v));  // itf8 is a signed 32-bit value
    ends[n] = pos;
    ++n;
  }
  return n;
}
