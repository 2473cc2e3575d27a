// Native FLAC decoder for diarizen_tpu_torch.core.audio.
//
// Replaces the torchaudio (libsndfile/ffmpeg) decode path the reference
// relies on (pyannote-audio core/io.py:436 `torchaudio.load`) with a small
// self-contained C++ implementation, loaded from Python via ctypes
// (diarizen_tpu_torch/core/flac.py builds this file on demand with g++).
//
// Supported: the full FLAC bitstream — STREAMINFO + skipped metadata,
// fixed/variable blocking, all block-size/sample-rate/sample-size codes,
// subframe types CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32), rice and
// rice2 residual partitions incl. escape (raw) partitions, wasted bits,
// channel assignments independent / left-side / right-side / mid-side,
// bit depths 8..32.  Frame-header CRC-8 and frame CRC-16 are verified.
//
// API (extern "C"):
//   flac_decode(data, size, &out, &frames, &channels, &rate, &bits) -> 0 ok
//   flac_free(out)
// Output is interleaved int32 (not rescaled; `bits` tells the caller the
// significant width).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // byte index
  int bit = 0;     // bits consumed within d[pos], 0..7
  bool err = false;

  BitReader(const uint8_t* data, size_t size) : d(data), n(size) {}

  uint32_t bits(int k) {  // k <= 32
    uint32_t v = 0;
    while (k > 0) {
      if (pos >= n) {
        err = true;
        return 0;
      }
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      uint32_t cur = (uint32_t)(d[pos] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | cur;
      bit += take;
      k -= take;
      if (bit == 8) {
        bit = 0;
        pos++;
      }
    }
    return v;
  }

  uint64_t bits64(int k) {  // k <= 64
    if (k <= 32) return bits(k);
    uint64_t hi = bits(k - 32);
    return (hi << 32) | bits(32);
  }

  int64_t sbits(int k) {  // signed, k <= 63
    uint64_t v = bits64(k);
    uint64_t sign = 1ull << (k - 1);
    return (int64_t)((v ^ sign) - sign);
  }

  uint32_t unary() {  // count 0 bits until the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (pos >= n) {
        err = true;
        return 0;
      }
      int b = (d[pos] >> (7 - bit)) & 1;
      bit++;
      if (bit == 8) {
        bit = 0;
        pos++;
      }
      if (b) return q;
      q++;
    }
  }

  void align() {
    if (bit) {
      bit = 0;
      pos++;
    }
  }
};

uint8_t crc8(const uint8_t* d, size_t n) {  // poly x^8+x^2+x+1 (0x07), init 0
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= d[i];
    for (int b = 0; b < 8; b++) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* d, size_t n) {  // poly 0x8005, init 0
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++) {
    c ^= (uint16_t)(d[i]) << 8;
    for (int b = 0; b < 8; b++)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

// UTF-8-style coded frame/sample number (up to 36-bit values, 7 bytes).
uint64_t read_coded_number(BitReader& br) {
  uint32_t b0 = br.bits(8);
  int ones = 0;
  while (ones < 8 && (b0 & (0x80u >> ones))) ones++;
  if (ones == 0) return b0;
  if (ones == 1 || ones > 7) {
    br.err = true;
    return 0;
  }
  uint64_t v = b0 & (0xFFu >> (ones + 1));
  for (int i = 1; i < ones; i++) {
    uint32_t c = br.bits(8);
    if ((c & 0xC0u) != 0x80u) {
      br.err = true;
      return 0;
    }
    v = (v << 6) | (c & 0x3Fu);
  }
  return v;
}

bool decode_residual(BitReader& br, int blocksize, int pred_order, int64_t* out) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xFu : 0x1Fu;
  uint32_t porder = br.bits(4);
  int parts = 1 << porder;
  if ((blocksize >> porder) << porder != blocksize) return false;
  int idx = pred_order;
  for (int p = 0; p < parts; p++) {
    int count = (blocksize >> porder) - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    uint32_t param = br.bits(plen);
    if (param == escape) {
      uint32_t raw = br.bits(5);
      for (int i = 0; i < count; i++) out[idx++] = raw ? br.sbits((int)raw) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint64_t q = br.unary();
        uint32_t lo = param ? br.bits((int)param) : 0;
        uint64_t v = (q << param) | lo;
        out[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
      }
    }
    if (br.err) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* out) {
  if (br.bits(1) != 0) return false;  // reserved padding bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) wasted = 1 + (int)br.unary();
  bps -= wasted;
  if (br.err || bps <= 0) return false;

  if (type == 0) {  // CONSTANT
    int64_t c = br.sbits(bps);
    for (int i = 0; i < blocksize; i++) out[i] = c;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = (int)type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    switch (order) {
      case 0:
        break;
      case 1:
        for (int i = 1; i < blocksize; i++) out[i] += out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; i++) out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; i++)
          out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; i++)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (int)(type & 31u) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
    uint32_t prec = br.bits(4);
    if (prec == 15) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.sbits(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }

  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] = (int64_t)((uint64_t)out[i] << wasted);
  return !br.err;
}

const int kRateTable[12] = {0,     88200, 176400, 192000, 8000,  16000,
                            22050, 24000, 32000,  44100,  48000, 96000};

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise:
//  -1 bad magic / truncated metadata     -2 missing STREAMINFO
//  -3 bad frame header / lost sync       -4 bad subframe / residual
//  -5 header CRC-8 mismatch              -6 frame CRC-16 mismatch
//  -7 allocation failure
int flac_decode(const uint8_t* data, int64_t size, int32_t** out_ptr,
                int64_t* out_frames, int32_t* out_channels, int32_t* out_rate,
                int32_t* out_bits) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;
  int si_rate = 0, si_channels = 0, si_bits = 0;
  bool have_streaminfo = false;

  // Metadata blocks.
  for (;;) {
    if (pos + 4 > (size_t)size) return -1;
    uint8_t hdr = data[pos];
    uint32_t len = ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8) |
                   data[pos + 3];
    pos += 4;
    if (pos + len > (size_t)size) return -1;
    if ((hdr & 0x7F) == 0) {  // STREAMINFO
      if (len < 34) return -2;
      const uint8_t* s = data + pos;
      si_rate = ((int)s[10] << 12) | ((int)s[11] << 4) | (s[12] >> 4);
      si_channels = ((s[12] >> 1) & 0x7) + 1;
      si_bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      have_streaminfo = true;
    }
    pos += len;
    if (hdr & 0x80) break;  // last-metadata-block flag
  }
  if (!have_streaminfo) return -2;

  std::vector<int32_t> out;
  std::vector<int64_t> ch_buf;  // per-frame planar scratch
  BitReader br(data, (size_t)size);
  br.pos = pos;

  while (br.pos < br.n) {
    size_t frame_start = br.pos;
    if (br.n - br.pos < 2) break;  // trailing garbage smaller than a sync code
    if (br.bits(14) != 0x3FFE) {
      // Trailing non-frame data (ID3v1 tag, padding) after at least one
      // decoded frame ends the stream — libFLAC/ffmpeg tolerate this too.
      if (!out.empty()) break;
      return -3;
    }
    br.bits(1);                          // reserved
    br.bits(1);                          // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    read_coded_number(br);

    int blocksize;
    if (bs_code == 0) return -3;
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576 << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
    else blocksize = 256 << (bs_code - 8);

    int rate;
    if (sr_code == 0) rate = si_rate;
    else if (sr_code <= 11) rate = kRateTable[sr_code];
    else if (sr_code == 12) rate = (int)br.bits(8) * 1000;
    else if (sr_code == 13) rate = (int)br.bits(16);
    else if (sr_code == 14) rate = (int)br.bits(16) * 10;
    else return -3;

    int bps;
    switch (ss_code) {
      case 0: bps = si_bits; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -3;
    }

    int nch;
    int assignment = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code <= 7) nch = (int)ch_code + 1;
    else if (ch_code <= 10) {
      nch = 2;
      assignment = (int)ch_code - 7;
    } else return -3;
    if (nch != si_channels) return -3;

    uint32_t hdr_crc = br.bits(8);
    if (br.err) return -3;
    // The header occupies whole bytes [frame_start, br.pos-1); its CRC-8 is
    // the final byte.
    if (crc8(data + frame_start, br.pos - 1 - frame_start) != (uint8_t)hdr_crc)
      return -5;

    ch_buf.assign((size_t)nch * blocksize, 0);
    for (int c = 0; c < nch; c++) {
      int sub_bps = bps;
      if ((assignment == 1 && c == 1) ||  // side channel carries one extra bit
          (assignment == 2 && c == 0) || (assignment == 3 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, blocksize, sub_bps, &ch_buf[(size_t)c * blocksize]))
        return -4;
    }
    br.align();
    uint32_t frame_crc = br.bits(16);
    if (br.err) return -4;
    if (crc16(data + frame_start, br.pos - 2 - frame_start) != (uint16_t)frame_crc)
      return -6;

    if (assignment) {
      int64_t* a = &ch_buf[0];
      int64_t* b = &ch_buf[(size_t)blocksize];
      for (int i = 0; i < blocksize; i++) {
        if (assignment == 1) {  // left/side: right = left - side
          b[i] = a[i] - b[i];
        } else if (assignment == 2) {  // right/side: left = right + side
          int64_t side = a[i];
          a[i] = b[i] + side;
        } else {  // mid/side
          int64_t mid = (a[i] << 1) | (b[i] & 1);
          int64_t side = b[i];
          a[i] = (mid + side) >> 1;
          b[i] = (mid - side) >> 1;
        }
      }
    }

    size_t base = out.size();
    out.resize(base + (size_t)blocksize * nch);
    for (int c = 0; c < nch; c++) {
      const int64_t* src = &ch_buf[(size_t)c * blocksize];
      for (int i = 0; i < blocksize; i++)
        out[base + (size_t)i * nch + c] = (int32_t)src[i];
    }
    (void)rate;
  }

  int32_t* buf = (int32_t*)malloc(out.size() * sizeof(int32_t) + 1);
  if (!buf) return -7;
  memcpy(buf, out.data(), out.size() * sizeof(int32_t));
  *out_ptr = buf;
  *out_frames = (int64_t)(out.size() / (size_t)si_channels);
  *out_channels = si_channels;
  *out_rate = si_rate;
  *out_bits = si_bits;
  return 0;
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"
