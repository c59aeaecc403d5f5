// flac_tpu native runtime: the host-side hot paths of the codec.
//
// TPU-native counterpart of the reference's C runtime around the DSP:
//   - MD5 accumulate with channel interleave (src/libFLAC/md5.c:388-520):
//     fuses the [C,N] int32 -> little-endian bytes/sample interleave with
//     the hash so no intermediate buffer is materialized.
//   - frame-sync scan (src/libFLAC/stream_decoder.c:2321 frame_sync_ +
//     read_frame_header_ :2624): finds byte-aligned 0xFFF8 sync codes,
//     CRC-8-verifies headers, applies the sequential-number invariant.
//   - CRC-8 / CRC-16 (src/libFLAC/crc.c) for host-side verification.
//   - ordered frame gather: slices the device's padded per-frame word
//     buffers into one contiguous byte stream (the host half of the
//     encoder's ordered bitbuffer drain, stream_encoder.c:3614-3626).
//
// Built as a plain shared library; bound from Python with ctypes.

#include <cstdint>
#include <cstring>

// Bumped whenever any extern "C" signature or status enum changes; the
// Python loader refuses (and rebuilds) on mismatch so a stale .so can
// never be silently used with new bindings.
#define FT_ABI_VERSION 5

extern "C" {

int32_t ft_abi_version() { return FT_ABI_VERSION; }

// ---------------------------------------------------------------------------
// CRC-8 (poly x^8+x^2+x+1 = 0x07) and CRC-16 (poly 0x8005), MSB-first
// ---------------------------------------------------------------------------

static uint8_t CRC8_TABLE[256];
static uint16_t CRC16_TABLE[256];
// slice-by-8 CRC16: TABLE8[k][b] = CRC of byte b followed by k zero bytes.
// Processing 8 bytes per step quadruples throughput over the byte-at-a-
// time loop (same idea as the reference's FLAC__crc16_update_words32,
// crc.c slice tables — tables generated here, not copied).
static uint16_t CRC16_TABLE8[8][256];
static bool tables_ready = false;

static void init_tables() {
  if (tables_ready) return;
  for (int i = 0; i < 256; i++) {
    uint8_t c8 = (uint8_t)i;
    uint16_t c16 = (uint16_t)(i << 8);
    for (int b = 0; b < 8; b++) {
      c8 = (uint8_t)((c8 << 1) ^ ((c8 & 0x80) ? 0x07 : 0));
      c16 = (uint16_t)((c16 << 1) ^ ((c16 & 0x8000) ? 0x8005 : 0));
    }
    CRC8_TABLE[i] = c8;
    CRC16_TABLE[i] = c16;
  }
  for (int b = 0; b < 256; b++) CRC16_TABLE8[0][b] = CRC16_TABLE[b];
  for (int k = 1; k < 8; k++)
    for (int b = 0; b < 256; b++) {
      uint16_t c = CRC16_TABLE8[k - 1][b];
      CRC16_TABLE8[k][b] = (uint16_t)((c << 8) ^ CRC16_TABLE[c >> 8]);
    }
  tables_ready = true;
}

uint8_t ft_crc8(const uint8_t* data, int64_t len) {
  init_tables();
  uint8_t crc = 0;
  for (int64_t i = 0; i < len; i++) crc = CRC8_TABLE[crc ^ data[i]];
  return crc;
}

uint16_t ft_crc16(const uint8_t* data, int64_t len, uint16_t crc) {
  init_tables();
  while (len >= 8) {
    crc = (uint16_t)(CRC16_TABLE8[7][data[0] ^ (crc >> 8)] ^
                     CRC16_TABLE8[6][data[1] ^ (crc & 0xff)] ^
                     CRC16_TABLE8[5][data[2]] ^ CRC16_TABLE8[4][data[3]] ^
                     CRC16_TABLE8[3][data[4]] ^ CRC16_TABLE8[2][data[5]] ^
                     CRC16_TABLE8[1][data[6]] ^ CRC16_TABLE8[0][data[7]]);
    data += 8;
    len -= 8;
  }
  for (int64_t i = 0; i < len; i++)
    crc = (uint16_t)((crc << 8) ^ CRC16_TABLE[(crc >> 8) ^ data[i]]);
  return crc;
}

// ---------------------------------------------------------------------------
// MD5 (RFC 1321) with fused PCM interleave
// ---------------------------------------------------------------------------

typedef struct {
  uint32_t h[4];
  uint64_t nbytes;
  uint8_t buf[64];
  uint32_t buflen;
} MD5Ctx;

static inline uint32_t rol32(uint32_t x, int c) {
  return (x << c) | (x >> (32 - c));
}

static const uint32_t MD5_K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
static const int MD5_R[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};

// Fully unrolled rounds (the branchy loop form costs ~2x; MD5 is on the
// decode wall for every verified stream, so this matters).
#define MD5_STEP(f, a, b, c, d, i, r) \
  a = b + rol32(a + (f) + MD5_K[i] + m[g_##r(i)], MD5_R[i])
#define g_0(i) (i)
#define g_1(i) ((5 * (i) + 1) & 15)
#define g_2(i) ((3 * (i) + 5) & 15)
#define g_3(i) ((7 * (i)) & 15)

static void md5_block(MD5Ctx* c, const uint8_t* p) {
  uint32_t m[16];
  memcpy(m, p, 64);  // little-endian host
  uint32_t a = c->h[0], b = c->h[1], d0 = c->h[2], d1 = c->h[3];
  for (int i = 0; i < 16; i += 4) {
    MD5_STEP((b & d0) | (~b & d1), a, b, d0, d1, i, 0);
    MD5_STEP((a & b) | (~a & d0), d1, a, b, d0, i + 1, 0);
    MD5_STEP((d1 & a) | (~d1 & b), d0, d1, a, b, i + 2, 0);
    MD5_STEP((d0 & d1) | (~d0 & a), b, d0, d1, a, i + 3, 0);
  }
  for (int i = 16; i < 32; i += 4) {
    MD5_STEP((d1 & b) | (~d1 & d0), a, b, d0, d1, i, 1);
    MD5_STEP((d0 & a) | (~d0 & b), d1, a, b, d0, i + 1, 1);
    MD5_STEP((b & d1) | (~b & a), d0, d1, a, b, i + 2, 1);
    MD5_STEP((a & d0) | (~a & d1), b, d0, d1, a, i + 3, 1);
  }
  for (int i = 32; i < 48; i += 4) {
    MD5_STEP(b ^ d0 ^ d1, a, b, d0, d1, i, 2);
    MD5_STEP(a ^ b ^ d0, d1, a, b, d0, i + 1, 2);
    MD5_STEP(d1 ^ a ^ b, d0, d1, a, b, i + 2, 2);
    MD5_STEP(d0 ^ d1 ^ a, b, d0, d1, a, i + 3, 2);
  }
  for (int i = 48; i < 64; i += 4) {
    MD5_STEP(d0 ^ (b | ~d1), a, b, d0, d1, i, 3);
    MD5_STEP(b ^ (a | ~d0), d1, a, b, d0, i + 1, 3);
    MD5_STEP(a ^ (d1 | ~b), d0, d1, a, b, i + 2, 3);
    MD5_STEP(d1 ^ (d0 | ~a), b, d0, d1, a, i + 3, 3);
  }
  c->h[0] += a;
  c->h[1] += b;
  c->h[2] += d0;
  c->h[3] += d1;
}

void ft_md5_init(MD5Ctx* c) {
  c->h[0] = 0x67452301;
  c->h[1] = 0xefcdab89;
  c->h[2] = 0x98badcfe;
  c->h[3] = 0x10325476;
  c->nbytes = 0;
  c->buflen = 0;
}

void ft_md5_update(MD5Ctx* c, const uint8_t* data, int64_t len) {
  c->nbytes += (uint64_t)len;
  if (c->buflen) {
    int64_t need = 64 - c->buflen;
    if (need > len) need = len;
    memcpy(c->buf + c->buflen, data, (size_t)need);
    c->buflen += (uint32_t)need;
    data += need;
    len -= need;
    if (c->buflen == 64) {
      md5_block(c, c->buf);
      c->buflen = 0;
    }
  }
  while (len >= 64) {
    md5_block(c, data);
    data += 64;
    len -= 64;
  }
  if (len) {
    memcpy(c->buf, data, (size_t)len);
    c->buflen = (uint32_t)len;
  }
}

// Interleave [channels, n] int32 (channel-major, rows contiguous, rows
// ch_stride samples apart) into the FLAC MD5 byte stream: sample-major,
// little-endian, bytes_per_sample bytes each — and hash it in 64 KiB
// chunks without a full copy.  ch_stride lets the decoder hash spans of
// the final [C, total] PCM array in place.
void ft_md5_update_pcm(MD5Ctx* c, const int32_t* pcm, int64_t channels,
                       int64_t n, int64_t ch_stride,
                       int32_t bytes_per_sample) {
  uint8_t chunk[65536];
  const int64_t stride = (int64_t)bytes_per_sample * channels;
  const int64_t per_chunk = (int64_t)(sizeof(chunk)) / stride;
  for (int64_t s0 = 0; s0 < n; s0 += per_chunk) {
    int64_t cnt = n - s0 < per_chunk ? n - s0 : per_chunk;
    uint8_t* w = chunk;
    if (bytes_per_sample == 2 && channels == 2) {
      // hot path (16-bit stereo): one 32-bit store per sample pair
      const int32_t* L = pcm + s0;
      const int32_t* R = pcm + ch_stride + s0;
      for (int64_t s = 0; s < cnt; s++) {
        uint32_t v = ((uint32_t)L[s] & 0xffff) | ((uint32_t)R[s] << 16);
        memcpy(w, &v, 4);  // little-endian host
        w += 4;
      }
    } else {
      for (int64_t s = s0; s < s0 + cnt; s++) {
        for (int64_t ch = 0; ch < channels; ch++) {
          uint32_t v = (uint32_t)pcm[ch * ch_stride + s];
          for (int b = 0; b < bytes_per_sample; b++) {
            *w++ = (uint8_t)(v & 0xff);
            v >>= 8;
          }
        }
      }
    }
    ft_md5_update(c, chunk, cnt * stride);
  }
}

void ft_md5_final(MD5Ctx* c, uint8_t* out16) {
  uint64_t bits = c->nbytes * 8;
  uint8_t pad = 0x80;
  ft_md5_update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->buflen != 56) ft_md5_update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
  // bypass nbytes accounting for the trailer
  uint64_t saved = c->nbytes;
  ft_md5_update(c, lenb, 8);
  c->nbytes = saved;
  for (int i = 0; i < 4; i++)
    for (int b = 0; b < 4; b++) out16[4 * i + b] = (uint8_t)(c->h[i] >> (8 * b));
}

int32_t ft_md5_ctx_size() { return (int32_t)sizeof(MD5Ctx); }

// ---------------------------------------------------------------------------
// Frame-sync scan (stream_decoder.c:2321,2624)
// ---------------------------------------------------------------------------

static const int32_t BLOCKSIZE_TABLE[16] = {0,   192,  576,  1152, 2304, 4608,
                                            -1,  -2,   256,  512,  1024, 2048,
                                            4096, 8192, 16384, 32768};
static const int32_t SAMPLE_RATE_TABLE[16] = {0,     88200, 176400, 192000,
                                              8000,  16000, 22050,  24000,
                                              32000, 44100, 48000,  96000,
                                              -1,    -2,    -3,     0};
static const int32_t BPS_TABLE[8] = {0, 8, 12, 0, 16, 20, 24, 32};

// Decode FLAC's extended-UTF-8 coded number (bitwriter.c:832,879 format).
// Returns value or -1; *nbytes set to consumed length.
static int64_t utf8_decode(const uint8_t* d, int64_t avail, int* nbytes) {
  if (avail < 1) return -1;
  uint8_t b0 = d[0];
  int extra;
  int64_t v;
  if (b0 < 0x80) {
    *nbytes = 1;
    return b0;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return -1;
  }
  if (avail < 1 + extra) return -1;
  for (int i = 1; i <= extra; i++) {
    if ((d[i] & 0xC0) != 0x80) return -1;
    v = (v << 6) | (d[i] & 0x3F);
  }
  *nbytes = 1 + extra;
  return v;
}

// Parse one byte-aligned frame header at data[pos].  Mirrors
// decoder.parse_frame_header / read_frame_header_ (stream_decoder.c:2624).
// Fills out[0..8] = {number, blocksize, sample_rate, channels, assignment,
// bps, variable, header_end_bits, 0}; returns 1 on success.
static int parse_header(const uint8_t* data, int64_t len, int64_t pos,
                        int32_t stream_bps, int64_t stream_rate,
                        int64_t* out) {
  if (pos + 5 > len) return 0;
  if (data[pos] != 0xFF || (data[pos + 1] & 0xFC) != 0xF8) return 0;
  int variable = data[pos + 1] & 1;
  uint8_t b2 = data[pos + 2], b3 = data[pos + 3];
  int bs_code = b2 >> 4, sr_code = b2 & 0xF;
  int ch_code = b3 >> 4, bps_code = (b3 >> 1) & 0x7;
  if (bs_code == 0 || sr_code == 15 || ch_code > 10 || (b3 & 1)) return 0;
  if (bps_code == 3 || (bps_code == 0 && stream_bps == 0)) return 0;
  int nb = 0;
  int64_t number = utf8_decode(data + pos + 4, len - pos - 4, &nb);
  if (number < 0) return 0;
  int64_t p = pos + 4 + nb;
  int64_t blocksize, sample_rate;
  if (bs_code == 6) {
    if (p + 1 > len) return 0;
    blocksize = data[p] + 1;
    p += 1;
  } else if (bs_code == 7) {
    if (p + 2 > len) return 0;
    blocksize = ((int64_t)data[p] << 8 | data[p + 1]) + 1;
    p += 2;
  } else {
    blocksize = BLOCKSIZE_TABLE[bs_code];
  }
  if (sr_code == 12) {
    if (p + 1 > len) return 0;
    sample_rate = (int64_t)data[p] * 1000;
    p += 1;
  } else if (sr_code == 13 || sr_code == 14) {
    if (p + 2 > len) return 0;
    sample_rate = ((int64_t)data[p] << 8 | data[p + 1]);
    if (sr_code == 14) sample_rate *= 10;
    p += 2;
  } else if (sr_code == 0) {
    sample_rate = stream_rate;
  } else {
    sample_rate = SAMPLE_RATE_TABLE[sr_code];
  }
  if (p >= len) return 0;
  if (ft_crc8(data + pos, p - pos) != data[p]) return 0;
  out[0] = number;
  out[1] = blocksize;
  out[2] = sample_rate;
  out[3] = ch_code < 8 ? ch_code + 1 : 2;
  out[4] = ch_code < 8 ? 0 : ch_code - 7;  // CHANNEL_ASSIGNMENT_*
  out[5] = bps_code == 0 ? stream_bps : BPS_TABLE[bps_code];
  out[6] = variable;
  out[7] = (p + 1 - pos) * 8;  // header length in bits
  return 1;
}

// Scan [start, len) for frames.  Fixed-blocksize streams must number
// consecutively (from ANY first value — the reference accepts trimmed
// streams, stream_decoder.c has no number==0 check); variable streams
// chain sample numbers — the same false-sync rejection as
// decoder.scan_frames.  Each accepted frame writes 9 int64s {offset,
// number, blocksize, sample_rate, channels, assignment, bps, variable,
// header_bits} into out.  Returns the frame count.
int64_t ft_scan_frames(const uint8_t* data, int64_t len, int64_t start,
                       int32_t stream_bps, int64_t stream_rate, int64_t* out,
                       int64_t max_frames) {
  init_tables();
  int64_t count = 0;
  int64_t expected = -1;
  int64_t last_off = -1000, last_num = 0, last_bs = 0;
  int64_t hdr[8];
  for (int64_t pos = start; pos + 1 < len && count < max_frames; pos++) {
    if (data[pos] != 0xFF || (data[pos + 1] & 0xFC) != 0xF8) continue;
    if (count && pos < last_off + 10) continue;  // inside minimal frame
    if (!parse_header(data, len, pos, stream_bps, stream_rate, hdr)) continue;
    if (!hdr[6] && count && hdr[0] != expected) continue;
    if (hdr[6] && count && hdr[0] != last_num + last_bs) continue;
    int64_t* o = out + 9 * count;
    o[0] = pos;
    memcpy(o + 1, hdr, 8 * sizeof(int64_t));
    last_off = pos;
    last_num = hdr[0];
    last_bs = hdr[1];
    expected = hdr[0] + 1;
    count++;
    pos += 9;  // skip the minimal frame body (next ++ makes 10)
  }
  return count;
}

// ---------------------------------------------------------------------------
// Frame-body parse: bit layout + residual extraction (decode phase 1)
// ---------------------------------------------------------------------------
//
// The fast decode pipeline splits the reference's pull-based frame decode
// (stream_decoder.c:3000-3420 read_subframe_* + bitreader.c:834 Rice read)
// into two phases: this native bit-serial walk extracts per-subframe
// residuals/coefficients (the branchy, data-dependent-length part a TPU
// cannot vectorize), and the device then runs ONE uniform batched LPC
// restore over all subframes (decoder_fast.py).  To make the device side
// uniform, every subframe type is normalized to the LPC form here:
//   constant -> order 1, qlp = {1}, shift 0, res[0] = value, res[n>0] = 0
//   verbatim -> order 0, res[n] = sample
//   fixed    -> its taps as qlp, shift 0
//   lpc      -> as coded
// Warmup samples land in res[0..order) and the restore seeds from them.

typedef struct {
  const uint8_t* data;
  int64_t pos;    // absolute bit cursor
  int64_t limit;  // absolute bit limit
  int err;
} BitRd;

static inline uint64_t br_peek57(const BitRd* r) {
  // 64-bit big-endian window starting at the cursor's byte; cursor bit at
  // position (63 - (pos&7)).  Bytes past limit read as zero.
  int64_t b0 = r->pos >> 3;
  int64_t last = (r->limit + 7) >> 3;
  uint64_t w = 0;
  if (b0 + 8 <= last) {
    memcpy(&w, r->data + b0, 8);  // one unaligned load + bswap beats
    w = __builtin_bswap64(w);     // eight shift-or byte loads (hot path)
  } else {
    for (int i = 0; i < 8; i++) {
      uint8_t b = (b0 + i < last) ? r->data[b0 + i] : 0;
      w = (w << 8) | b;
    }
  }
  return w << (r->pos & 7);
}

static inline uint64_t br_read(BitRd* r, int nbits) {  // nbits in [0, 57]
  if (nbits == 0) return 0;
  if (r->pos + nbits > r->limit) {
    r->err = 1;
    return 0;
  }
  uint64_t w = br_peek57(r);
  r->pos += nbits;
  return w >> (64 - nbits);
}

static inline int64_t br_read_signed(BitRd* r, int nbits) {
  if (nbits == 0) return 0;
  uint64_t v = br_read(r, nbits);
  uint64_t sign = (uint64_t)1 << (nbits - 1);
  return (int64_t)((v ^ sign)) - (int64_t)sign;
}

static inline int64_t br_read_unary(BitRd* r) {
  int64_t q = 0;
  for (;;) {
    if (r->pos >= r->limit) {
      r->err = 1;
      return 0;
    }
    uint64_t w = br_peek57(r);
    if (w) {
      int nz = __builtin_clzll(w);
      int64_t avail = r->limit - r->pos;
      if (nz >= avail) {
        r->err = 1;
        return 0;
      }
      r->pos += nz + 1;
      return q + nz;
    }
    // whole window is zeros: usable bits this round
    int64_t usable = 64 - (r->pos & 7);
    int64_t avail = r->limit - r->pos;
    if (usable >= avail) {
      r->err = 1;
      return 0;
    }
    q += usable;
    r->pos += usable;
  }
}

static const int32_t FIXED_TAPS[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

// Frame status codes (frame_status[f]):
enum {
  FT_OK = 0,
  FT_PARSE_ERR = 1,
  FT_CRC16_BAD = 2,
  FT_RES_OVERFLOW = 3,   // residual/sample needs > int32 (wide retry)
  FT_EXTENT_MISMATCH = 4, // decoded extent != scan span (false sync?)
  FT_OOR = 5,            // decoded sample out of bps range (lost sync)
  FT_SEG_OVERFLOW = 6    // tile needs more segments than SEGMAX (fallback)
};

// Parse one subframe into normalized restore form.  Returns 0 on success.
static int parse_subframe(BitRd* r, int32_t sbps, int64_t N, int32_t* order,
                          int32_t* shift, int32_t* wasted, int32_t* sftype,
                          int32_t* qlp /*32*/, int32_t* res32 /*N*/,
                          int64_t* res64 /*N or null*/, int* overflow) {
  uint64_t hdr = br_read(r, 8);
  if (r->err) return 1;
  if (hdr & 0x80) return 1;  // padding bit must be 0 (format.h frame layout)
  int type6 = (int)((hdr >> 1) & 0x3F);
  int w = 0;
  if (hdr & 1) w = (int)br_read_unary(r) + 1;
  if (r->err) return 1;
  int32_t ebps = sbps - w;
  if (ebps <= 0) return 1;
  *wasted = w;
  *shift = 0;
  for (int i = 0; i < 32; i++) qlp[i] = 0;

  int ord;
  int is_lpc = 0;
  if (type6 == 0) {  // constant
    int64_t v = br_read_signed(r, ebps);
    if (r->err) return 1;
    *sftype = 0;
    *order = 1;
    qlp[0] = 1;
    if (res64) {
      memset(res64, 0, (size_t)N * 8);
      res64[0] = v;
    } else {
      memset(res32, 0, (size_t)N * 4);
      if (v < INT32_MIN || v > INT32_MAX) {
        *overflow = 1;
        return 0;
      }
      res32[0] = (int32_t)v;
    }
    return 0;
  } else if (type6 == 1) {  // verbatim
    *sftype = 1;
    *order = 0;
    for (int64_t n = 0; n < N; n++) {
      int64_t v = br_read_signed(r, ebps);
      if (r->err) return 1;
      if (res64) {
        res64[n] = v;
      } else if (v < INT32_MIN || v > INT32_MAX) {
        *overflow = 1;
        return 0;
      } else {
        res32[n] = (int32_t)v;
      }
    }
    return 0;
  } else if ((type6 & 0x38) == 0x08 && (type6 & 0x07) <= 4) {  // fixed
    ord = type6 & 0x07;
    *sftype = 2;
    for (int i = 0; i < ord; i++) qlp[i] = FIXED_TAPS[ord][i];
  } else if (type6 & 0x20) {  // lpc
    ord = (type6 & 0x1F) + 1;
    *sftype = 3;
    is_lpc = 1;
  } else {
    return 1;  // reserved type
  }
  if (ord > (int)N) return 1;
  *order = ord;

  // warmup samples -> res[0..ord)
  for (int i = 0; i < ord; i++) {
    int64_t v = br_read_signed(r, ebps);
    if (r->err) return 1;
    if (res64) {
      res64[i] = v;
    } else if (v < INT32_MIN || v > INT32_MAX) {
      *overflow = 1;
      return 0;
    } else {
      res32[i] = (int32_t)v;
    }
  }
  if (is_lpc) {
    int prec = (int)br_read(r, 4);
    if (r->err || prec == 15) return 1;  // precision code 15 invalid
    prec += 1;
    int sh = (int)br_read_signed(r, 5);
    if (r->err || sh < 0) return 1;  // negative shift reserved
    *shift = sh;
    for (int i = 0; i < ord; i++) {
      qlp[i] = (int32_t)br_read_signed(r, prec);
      if (r->err) return 1;
    }
  }

  // partitioned Rice residual (format.h RESIDUAL_CODING_METHOD_*)
  int method = (int)br_read(r, 2);
  if (r->err || method > 1) return 1;
  int plen = method ? 5 : 4;
  uint32_t esc = (1u << plen) - 1;
  int po = (int)br_read(r, 4);
  if (r->err) return 1;
  if (N % ((int64_t)1 << po)) return 1;
  int64_t m = N >> po;
  // the reference only rejects blocksize>>po < order (stream_decoder.c:3108);
  // equality is legal (partition 0 then has zero residuals)
  if (po > 0 && m < ord) return 1;
  if (po == 0 && N < ord) return 1;
  int64_t n = ord;
  for (int p = 0; p < (1 << po); p++) {
    int64_t pend = ((int64_t)p + 1) * m;
    uint32_t k = (uint32_t)br_read(r, plen);
    if (r->err) return 1;
    if (k == esc) {
      int rawbits = (int)br_read(r, 5);
      if (r->err) return 1;
      for (; n < pend; n++) {
        int64_t v = rawbits ? br_read_signed(r, rawbits) : 0;
        if (r->err) return 1;
        if (res64) {
          res64[n] = v;
        } else {
          res32[n] = (int32_t)v;  // rawbits <= 31: always fits
        }
      }
    } else {
      for (; n < pend; n++) {
        int64_t q = br_read_unary(r);
        if (r->err) return 1;
        if (q > (int64_t)1 << 30) return 1;  // insane run: corrupt stream
        uint64_t u = ((uint64_t)q << k) | br_read(r, (int)k);
        if (r->err) return 1;
        int64_t v = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        if (res64) {
          res64[n] = v;
        } else if (v < INT32_MIN || v > INT32_MAX) {
          *overflow = 1;
          return 0;
        } else {
          res32[n] = (int32_t)v;
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Tile scan (device-decode phase 1): boundaries + segment tables only
// ---------------------------------------------------------------------------
//
// The device Rice decoder (ops/bitunpack.py) decodes residual bits ON
// CHIP; the host's job shrinks from extracting every residual
// (ft_parse_frames) to a skip-walk that finds where codes live.  Each
// subframe's N samples split into fixed tiles of T samples; each tile
// becomes one device lane with a start bit and a short segment table:
//
//   segment = {skip:16 | count:8 | param:6 | kind:1}  (one int32)
//
// kind 0 = Rice codes with parameter `param` (bitreader.c:834's format:
// unary q, stop bit, param LSBs); kind 1 = raw signed codes of width
// `param` (escape partitions, verbatim samples, warmup, constant —
// width 0 means synthesized zeros).  `skip` bits are consumed before the
// segment's first code (subframe headers, LPC coefficient blocks, Rice
// k-parameters — everything the device does not need to understand).
// The walk is ~3x cheaper than the full parse: it never materializes
// residuals, only advances the cursor with clz hops.

static inline void tile_close_lane(int64_t emit_pos, int64_t lane_open_pos,
                                   int32_t* max_tile_bits) {
  int32_t bits = (int32_t)(emit_pos - lane_open_pos);
  if (bits > *max_tile_bits) *max_tile_bits = bits;
}

typedef struct {
  BitRd* r;
  int64_t emit_pos;     // all bits before this are attached to segments
  int64_t n;            // sample cursor within the subframe
  int64_t T;
  int64_t tiles;
  int64_t segmax;
  int32_t* segs;        // [tiles, SEGMAX] for this subframe
  int64_t* lane_start;  // [tiles]
  int64_t cur_lane;
  int64_t lane_open_pos;
  int32_t nseg;
  int32_t* max_tile_bits;
  int32_t* max_segs;
  int overflow;         // segment-table overflow
  int wide;             // any value needs > int32
} TileEm;

// Emit one run of `cnt` codes of (kind, param) starting at the walker's
// current position; the walker advances through them here.  Splits on
// tile boundaries.  Returns 0 on success.
static int tile_run(TileEm* e, int kind, int param, int64_t cnt) {
  BitRd* r = e->r;
  while (cnt > 0) {
    int64_t lane = e->n / e->T;
    if (lane != e->cur_lane) {
      if (e->cur_lane >= 0)
        tile_close_lane(e->emit_pos, e->lane_open_pos, e->max_tile_bits);
      e->cur_lane = lane;
      e->lane_open_pos = e->emit_pos;
      e->lane_start[lane] = e->emit_pos;
      e->nseg = 0;
    }
    int64_t take = (lane + 1) * e->T - e->n;
    if (take > cnt) take = cnt;
    // strict '<' keeps one slot free for the inert padding segment the
    // device needs to idle through partial tiles
    if (e->nseg >= e->segmax - 1) {
      e->overflow = 1;
      return 1;
    }
    int64_t skip = r->pos - e->emit_pos;
    if (skip > 0xFFFF) return 1;  // cannot happen for legal streams
    // walk the codes
    if (kind == 1) {
      r->pos += (int64_t)param * take;
      if (r->pos > r->limit) {
        r->err = 1;
        return 1;
      }
      if (param > 32) e->wide = 1;
    } else {
      for (int64_t i = 0; i < take; i++) {
        int64_t q = br_read_unary(r);
        if (r->err) return 1;
        if (q > (int64_t)1 << 30) return 1;  // insane run: corrupt
        // folded value u = q<<k | lsb needs int64 iff u >= 2^32
        // (conservatively assume max lsb)
        uint64_t umax =
            ((uint64_t)q << param) | (((uint64_t)1 << param) - 1);
        if (umax >> 32) e->wide = 1;
        r->pos += param;
        if (r->pos > r->limit) {
          r->err = 1;
          return 1;
        }
      }
    }
    e->segs[e->cur_lane * e->segmax + e->nseg++] =
        (int32_t)((skip << 15) | (take << 7) | (param << 1) | kind);
    if (e->nseg > *e->max_segs) *e->max_segs = e->nseg;
    e->emit_pos = r->pos;
    e->n += take;
    cnt -= take;
  }
  return 0;
}

// Skip-walk one subframe, emitting tiles.  Mirrors parse_subframe's bit
// layout handling but extracts only (order, shift, wasted, qlp) — the
// residual bits become segment tables.
static int tile_subframe(TileEm* e, int32_t sbps, int64_t N, int32_t* order,
                         int32_t* shift, int32_t* wasted, int32_t* sftype,
                         int32_t* qlp /*32*/) {
  BitRd* r = e->r;
  uint64_t hdr = br_read(r, 8);
  if (r->err) return 1;
  if (hdr & 0x80) return 1;
  int type6 = (int)((hdr >> 1) & 0x3F);
  int w = 0;
  if (hdr & 1) w = (int)br_read_unary(r) + 1;
  if (r->err) return 1;
  int32_t ebps = sbps - w;
  if (ebps <= 0) return 1;
  *wasted = w;
  *shift = 0;
  for (int i = 0; i < 32; i++) qlp[i] = 0;
  if (ebps > 32) e->wide = 1;

  int ord;
  int is_lpc = 0;
  if (type6 == 0) {  // constant: value then synthesized zeros
    *sftype = 0;
    *order = 1;
    qlp[0] = 1;
    if (tile_run(e, 1, ebps, 1)) return 1;
    return tile_run(e, 1, 0, N - 1);
  } else if (type6 == 1) {  // verbatim
    *sftype = 1;
    *order = 0;
    return tile_run(e, 1, ebps, N);
  } else if ((type6 & 0x38) == 0x08 && (type6 & 0x07) <= 4) {
    ord = type6 & 0x07;
    *sftype = 2;
    for (int i = 0; i < ord; i++) qlp[i] = FIXED_TAPS[ord][i];
  } else if (type6 & 0x20) {
    ord = (type6 & 0x1F) + 1;
    *sftype = 3;
    is_lpc = 1;
  } else {
    return 1;
  }
  if (ord > (int)N) return 1;
  *order = ord;

  // warmup samples -> raw codes for res[0..ord)
  if (ord && tile_run(e, 1, ebps, ord)) return 1;
  if (is_lpc) {
    int prec = (int)br_read(r, 4);
    if (r->err || prec == 15) return 1;
    prec += 1;
    int sh = (int)br_read_signed(r, 5);
    if (r->err || sh < 0) return 1;
    *shift = sh;
    for (int i = 0; i < ord; i++) {
      qlp[i] = (int32_t)br_read_signed(r, prec);
      if (r->err) return 1;
    }
  }

  int method = (int)br_read(r, 2);
  if (r->err || method > 1) return 1;
  int plen = method ? 5 : 4;
  uint32_t esc = (1u << plen) - 1;
  int po = (int)br_read(r, 4);
  if (r->err) return 1;
  if (N % ((int64_t)1 << po)) return 1;
  int64_t m = N >> po;
  if (po > 0 && m < ord) return 1;
  if (po == 0 && N < ord) return 1;
  for (int p = 0; p < (1 << po); p++) {
    int64_t cnt = (p == 0) ? m - ord : m;
    uint32_t k = (uint32_t)br_read(r, plen);
    if (r->err) return 1;
    if (k == esc) {
      int rawbits = (int)br_read(r, 5);
      if (r->err) return 1;
      if (cnt && tile_run(e, 1, rawbits, cnt)) return 1;
    } else {
      if (cnt && tile_run(e, 0, (int)k, cnt)) return 1;
    }
  }
  return 0;
}

// Tile-scan a group of same-shape frames.  Layouts:
//   per-subframe s = f*C + c: order/shift/wasted/sftype/qlp as in
//     ft_parse_frames;
//   per-lane l = s*tiles + t (tiles = ceil(N/T)): lane_start[l] absolute
//     bit offset, segs[l*segmax .. ] packed segments (caller prefills the
//     whole segs array with the inert padding pattern);
//   per-frame: end_bits, status (FT_*), wide flag.
// max_tile_bits receives the largest (bits consumed by one lane) across
// the group — the device sizes its gather window from it.  Returns the
// number of frames with bad status.
int64_t ft_tile_scan(const uint8_t* data, int64_t len, const int64_t* offsets,
                     const int64_t* start_bits, const int64_t* sizes,
                     const int32_t* ch_bps, int64_t F, int64_t C, int64_t N,
                     int64_t T, int64_t segmax, int32_t* order,
                     int32_t* shift, int32_t* wasted, int32_t* sftype,
                     int32_t* qlp, int64_t* lane_start, int32_t* segs,
                     int64_t* end_bits, int32_t* status, int32_t* wide,
                     int32_t* max_tile_bits, int32_t* max_segs) {
  init_tables();
  int64_t bad = 0;
  int64_t tiles = (N + T - 1) / T;
  for (int64_t f = 0; f < F; f++) {
    BitRd r;
    r.data = data;
    r.pos = start_bits[f];
    int64_t frame_end = offsets[f] + sizes[f];
    if (frame_end > len) frame_end = len;
    r.limit = frame_end * 8;
    r.err = 0;
    int st = FT_OK;
    int fr_wide = 0;
    for (int64_t c = 0; c < C && st == FT_OK; c++) {
      int64_t s = f * C + c;
      TileEm e;
      e.r = &r;
      e.emit_pos = r.pos;
      e.n = 0;
      e.T = T;
      e.tiles = tiles;
      e.segmax = segmax;
      e.segs = segs + s * tiles * segmax;
      e.lane_start = lane_start + s * tiles;
      e.cur_lane = -1;
      e.lane_open_pos = r.pos;
      e.nseg = 0;
      e.max_tile_bits = max_tile_bits;
      e.max_segs = max_segs;
      e.overflow = 0;
      e.wide = 0;
      if (tile_subframe(&e, ch_bps[s], N, order + s, shift + s, wasted + s,
                        sftype + s, qlp + 32 * s))
        st = e.overflow ? FT_SEG_OVERFLOW : FT_PARSE_ERR;
      else if (e.cur_lane >= 0)
        tile_close_lane(e.emit_pos, e.lane_open_pos, max_tile_bits);
      fr_wide |= e.wide;
    }
    end_bits[f] = r.pos;
    wide[f] = fr_wide;
    if (st == FT_OK) {
      int64_t byte_end = (r.pos + 7) >> 3;
      if (byte_end + 2 > frame_end) {
        st = FT_PARSE_ERR;
      } else {
        uint16_t got = ft_crc16(data + offsets[f], byte_end - offsets[f], 0);
        uint16_t stored = (uint16_t)((data[byte_end] << 8) |
                                     data[byte_end + 1]);
        if (got != stored)
          st = FT_CRC16_BAD;
        else if (byte_end + 2 != frame_end)
          st = FT_EXTENT_MISMATCH;
      }
    }
    status[f] = st;
    if (st != FT_OK) bad++;
  }
  return bad;
}

// Parse a group of same-shape frames (decode phase 1).  Per frame f the
// subframe records land at s = f*C + c.  res32 xor res64 receives the
// normalized residuals (pass res64 = null for the common int32 path; an
// out-of-range value then sets FT_RES_OVERFLOW and the caller retries
// wide).  end_bits[f] is the absolute bit cursor after the last subframe;
// CRC-16 is verified against the byte-aligned trailer.  Returns the
// number of frames with status != FT_OK.
int64_t ft_parse_frames(const uint8_t* data, int64_t len,
                        const int64_t* offsets, const int64_t* start_bits,
                        const int64_t* sizes, const int32_t* ch_bps,
                        int64_t F, int64_t C, int64_t N, int32_t* order,
                        int32_t* shift, int32_t* wasted, int32_t* sftype,
                        int32_t* qlp, int32_t* res32, int64_t* res64,
                        int64_t* end_bits, int32_t* frame_status) {
  init_tables();
  int64_t bad = 0;
  for (int64_t f = 0; f < F; f++) {
    BitRd r;
    r.data = data;
    r.pos = start_bits[f];
    int64_t frame_end = offsets[f] + sizes[f];
    if (frame_end > len) frame_end = len;
    r.limit = frame_end * 8;
    r.err = 0;
    int status = FT_OK;
    int overflow = 0;
    // An int32 overflow aborts parse_subframe mid-subframe, leaving the
    // cursor unusable for later channels — stop immediately and report
    // FT_RES_OVERFLOW with priority over any downstream FT_PARSE_ERR so
    // the caller's wide retry always happens for valid 27-32-bit streams.
    for (int64_t c = 0; c < C && status == FT_OK && !overflow; c++) {
      int64_t s = f * C + c;
      if (parse_subframe(&r, ch_bps[s], N, order + s, shift + s, wasted + s,
                         sftype + s, qlp + 32 * s,
                         res32 ? res32 + N * s : nullptr,
                         res64 ? res64 + N * s : nullptr, &overflow))
        status = FT_PARSE_ERR;
    }
    end_bits[f] = r.pos;
    if (overflow) status = FT_RES_OVERFLOW;
    if (status == FT_OK) {
      // byte-align, then verify CRC-16 over the whole frame through the
      // trailer (frame_footer, stream_decoder.c:2443 read_frame_ CRC check)
      int64_t byte_end = (r.pos + 7) >> 3;
      if (byte_end + 2 > frame_end) {
        status = FT_PARSE_ERR;
      } else {
        uint16_t got = ft_crc16(data + offsets[f],
                                byte_end - offsets[f], 0);
        uint16_t stored = (uint16_t)((data[byte_end] << 8) |
                                     data[byte_end + 1]);
        if (got != stored)
          status = FT_CRC16_BAD;
        else if (byte_end + 2 != frame_end)
          status = FT_EXTENT_MISMATCH;  // trailing junk or false next-sync
      }
    }
    frame_status[f] = status;
    if (status != FT_OK) bad++;
  }
  return bad;
}

// ---------------------------------------------------------------------------
// Host LPC restore (decode phase 2, CPU path)
// ---------------------------------------------------------------------------

// Uniform normalized restore: x[n] = res[n] for n < order, else
// res[n] + ((sum qlp[i]*x[n-1-i]) >> shift); finally x <<= wasted.
// The int64 history/accumulator covers the 33-bit side channel
// (lpc.c:978 FLAC__lpc_restore_signal + _wide_ variants, one loop here).
void ft_restore(const int32_t* res, const int32_t* order,
                const int32_t* shift, const int32_t* wasted,
                const int32_t* qlp, int64_t S, int64_t N, int64_t* out) {
  for (int64_t s = 0; s < S; s++) {
    const int32_t* r = res + s * N;
    const int32_t* c = qlp + s * 32;
    int64_t* x = out + s * N;
    int ord = order[s];
    int sh = shift[s], w = wasted[s];
    for (int64_t n = 0; n < ord && n < N; n++) x[n] = r[n];
    for (int64_t n = ord; n < N; n++) {
      int64_t acc = 0;
      for (int i = 0; i < ord; i++) acc += (int64_t)c[i] * x[n - 1 - i];
      x[n] = r[n] + (acc >> sh);
    }
    if (w)
      for (int64_t n = 0; n < N; n++) x[n] <<= w;
  }
}

void ft_restore_wide(const int64_t* res, const int32_t* order,
                     const int32_t* shift, const int32_t* wasted,
                     const int32_t* qlp, int64_t S, int64_t N, int64_t* out) {
  for (int64_t s = 0; s < S; s++) {
    const int64_t* r = res + s * N;
    const int32_t* c = qlp + s * 32;
    int64_t* x = out + s * N;
    int ord = order[s];
    int sh = shift[s], w = wasted[s];
    for (int64_t n = 0; n < ord && n < N; n++) x[n] = r[n];
    for (int64_t n = ord; n < N; n++) {
      int64_t acc = 0;
      for (int i = 0; i < ord; i++) acc += (int64_t)c[i] * x[n - 1 - i];
      x[n] = r[n] + (acc >> sh);
    }
    if (w)
      for (int64_t n = 0; n < N; n++) x[n] <<= w;
  }
}

}  // extern "C" (C++ template helpers below need C++ linkage)

// ---------------------------------------------------------------------------
// Fused frame decode (all-CPU engine): parse + in-place restore + stereo
// undo + range check in ONE cache-hot pass per frame.  This is the
// counterpart of the reference's read_frame_ (stream_decoder.c:2373-2560)
// which likewise fuses bit reading with prediction — but batched over a
// frame table instead of pull-driven, so a thread pool can split the
// frame axis across cores (frames are independent by format design).
// ---------------------------------------------------------------------------

namespace {

inline int32_t sat32(int64_t v) {
  if (v > INT32_MAX) return INT32_MAX;
  if (v < INT32_MIN) return INT32_MIN;
  return (int32_t)v;
}

// Order-specialized in-place restore: x[] holds residuals on entry,
// samples on exit (lpc.c:978 restore_signal, unrolled per order like the
// reference's SIMD variants but via templates the compiler vectorizes).
template <int ORD>
void restore_ord(int32_t* x, int64_t N, int sh, const int32_t* qlp) {
  for (int64_t n = ORD; n < N; n++) {
    int64_t acc = 0;
    for (int i = 0; i < ORD; i++) acc += (int64_t)qlp[i] * x[n - 1 - i];
    x[n] = sat32((int64_t)x[n] + (acc >> sh));
  }
}

void restore32_inplace(int32_t* x, int64_t N, int ord, int sh, int w,
                       const int32_t* qlp) {
  switch (ord) {
    case 0: break;
    case 1: restore_ord<1>(x, N, sh, qlp); break;
    case 2: restore_ord<2>(x, N, sh, qlp); break;
    case 3: restore_ord<3>(x, N, sh, qlp); break;
    case 4: restore_ord<4>(x, N, sh, qlp); break;
    case 5: restore_ord<5>(x, N, sh, qlp); break;
    case 6: restore_ord<6>(x, N, sh, qlp); break;
    case 7: restore_ord<7>(x, N, sh, qlp); break;
    case 8: restore_ord<8>(x, N, sh, qlp); break;
    case 9: restore_ord<9>(x, N, sh, qlp); break;
    case 10: restore_ord<10>(x, N, sh, qlp); break;
    case 11: restore_ord<11>(x, N, sh, qlp); break;
    case 12: restore_ord<12>(x, N, sh, qlp); break;
    default:
      for (int64_t n = ord; n < N; n++) {
        int64_t acc = 0;
        for (int i = 0; i < ord; i++) acc += (int64_t)qlp[i] * x[n - 1 - i];
        x[n] = sat32((int64_t)x[n] + (acc >> sh));
      }
  }
  if (w)
    for (int64_t n = 0; n < N; n++) x[n] = sat32((int64_t)x[n] << w);
}

void restore64_inplace(int64_t* x, int64_t N, int ord, int sh, int w,
                       const int32_t* qlp) {
  for (int64_t n = ord; n < N; n++) {
    int64_t acc = 0;
    for (int i = 0; i < ord; i++) acc += (int64_t)qlp[i] * x[n - 1 - i];
    x[n] += acc >> sh;
  }
  if (w)
    for (int64_t n = 0; n < N; n++) x[n] <<= w;
}

// In-place stereo decorrelation undo (stream_decoder.c:3476-3526).
// a = channel 0, b = channel 1; asg 1 = left/side, 2 = right/side,
// 3 = mid/side.
void undo_stereo32(int32_t* a, int32_t* b, int64_t N, int asg) {
  if (asg == 1) {
    for (int64_t n = 0; n < N; n++) b[n] = sat32((int64_t)a[n] - b[n]);
  } else if (asg == 2) {
    for (int64_t n = 0; n < N; n++) a[n] = sat32((int64_t)a[n] + b[n]);
  } else if (asg == 3) {
    for (int64_t n = 0; n < N; n++) {
      int64_t mid = ((int64_t)a[n] << 1) | (b[n] & 1);
      int64_t side = b[n];
      a[n] = sat32((mid + side) >> 1);
      b[n] = sat32((mid - side) >> 1);
    }
  }
}

void undo_stereo64(int64_t* a, int64_t* b, int64_t N, int asg) {
  if (asg == 1) {
    for (int64_t n = 0; n < N; n++) b[n] = a[n] - b[n];
  } else if (asg == 2) {
    for (int64_t n = 0; n < N; n++) a[n] = a[n] + b[n];
  } else if (asg == 3) {
    for (int64_t n = 0; n < N; n++) {
      int64_t mid = (a[n] << 1) | (b[n] & 1);
      int64_t side = b[n];
      a[n] = (mid + side) >> 1;
      b[n] = (mid - side) >> 1;
    }
  }
}

}  // namespace

extern "C" {

// Decode F same-shape frames to PCM in one native pass.  With out_off ==
// null, out receives packed [F, C, N] int32 samples; otherwise channel c
// of frame f is written at out + c*out_ch_stride + out_off[f] — letting
// the caller decode straight into the final channel-major PCM array with
// no assembly pass.  end_bits/status as in ft_parse_frames (plus FT_OOR
// when a decoded sample falls outside check_bps's range — the
// stream_decoder.c:2458-2472 lost-sync rejection; check_bps=0 disables).
// Frames needing >int32 residuals (27-33 bit paths) retry internally via
// an int64 scratch buffer; frames with a subframe of FT_WIDE_BPS bits or
// more take it at once.  Returns the number of frames with bad status.
//
// A subframe of 32 bits or more restores and undoes its stereo to values
// past int32 even where its residuals fit (a 33-bit side; a mid of 2^30
// doubles in the undo).  The device engines mark the same frames wide
// (decoder_fast.wide_frames, WIDE_BPS).
constexpr int FT_WIDE_BPS = 32;

int64_t ft_decode_frames(const uint8_t* data, int64_t len,
                         const int64_t* offsets, const int64_t* start_bits,
                         const int64_t* sizes, const int32_t* ch_bps,
                         int64_t F, int64_t C, int64_t N,
                         const int32_t* assignment, int32_t check_bps,
                         int32_t verify_crc, int32_t* out,
                         const int64_t* out_off, int64_t out_ch_stride,
                         int64_t* end_bits, int32_t* status) {
  init_tables();
  int64_t bad = 0;
  int64_t* scratch = nullptr;  // lazily allocated wide path, reused
  const int64_t xc = out_off ? out_ch_stride : N;  // stride between channels
  for (int64_t f = 0; f < F; f++) {
    int32_t* x = out_off ? out + out_off[f] : out + f * C * N;
    BitRd r;
    r.data = data;
    r.pos = start_bits[f];
    int64_t frame_end = offsets[f] + sizes[f];
    if (frame_end > len) frame_end = len;
    r.limit = frame_end * 8;
    r.err = 0;
    int st = FT_OK;
    int overflow = 0;
    for (int64_t c = 0; c < C; c++)
      if (ch_bps[f * C + c] >= FT_WIDE_BPS) overflow = 1;
    int32_t ord, sh, w, sft;
    int32_t qlp[32];
    for (int64_t c = 0; c < C && st == FT_OK && !overflow; c++) {
      if (parse_subframe(&r, ch_bps[f * C + c], N, &ord, &sh, &w, &sft, qlp,
                         x + c * xc, nullptr, &overflow)) {
        st = FT_PARSE_ERR;
      } else if (!overflow) {
        restore32_inplace(x + c * xc, N, ord, sh, w, qlp);
      }
    }
    if (overflow) {
      // wide retry: redo the whole frame through an int64 scratch
      if (!scratch) scratch = new int64_t[C * N];
      r.pos = start_bits[f];
      r.err = 0;
      st = FT_OK;
      for (int64_t c = 0; c < C && st == FT_OK; c++) {
        int ovf2 = 0;
        if (parse_subframe(&r, ch_bps[f * C + c], N, &ord, &sh, &w, &sft,
                           qlp, nullptr, scratch + c * N, &ovf2))
          st = FT_PARSE_ERR;
        else
          restore64_inplace(scratch + c * N, N, ord, sh, w, qlp);
      }
      if (st == FT_OK && C == 2 && assignment[f])
        undo_stereo64(scratch, scratch + N, N, assignment[f]);
      if (st == FT_OK)
        for (int64_t c = 0; c < C; c++)
          for (int64_t n = 0; n < N; n++)
            x[c * xc + n] = sat32(scratch[c * N + n]);
    }
    end_bits[f] = r.pos;
    if (st == FT_OK) {
      int64_t byte_end = (r.pos + 7) >> 3;
      if (byte_end + 2 > frame_end) {
        st = FT_PARSE_ERR;
      } else {
        if (verify_crc) {
          uint16_t got = ft_crc16(data + offsets[f], byte_end - offsets[f], 0);
          uint16_t stored =
              (uint16_t)((data[byte_end] << 8) | data[byte_end + 1]);
          if (got != stored) st = FT_CRC16_BAD;
        }
        if (st == FT_OK && byte_end + 2 != frame_end)
          st = FT_EXTENT_MISMATCH;
      }
    }
    if (st != FT_PARSE_ERR) {
      if (!overflow && C == 2 && assignment[f])
        undo_stereo32(x, x + xc, N, assignment[f]);
      if (check_bps && st != FT_CRC16_BAD) {
        int64_t lim = (int64_t)1 << (check_bps - 1);
        for (int64_t c = 0; c < C && st != FT_OOR; c++)
          for (int64_t n = 0; n < N; n++)
            if (x[c * xc + n] < -lim || x[c * xc + n] >= lim) {
              st = FT_OOR;
              break;
            }
      }
    }
    status[f] = st;
    if (st != FT_OK && st != FT_EXTENT_MISMATCH) bad++;
  }
  delete[] scratch;
  return bad;
}

// ---------------------------------------------------------------------------
// Ordered frame gather (encoder host assembly)
// ---------------------------------------------------------------------------

// words: [B, W] uint32 big-endian byte view flattened as bytes (B rows of
// 4*W bytes); lens: per-frame byte length.  Concatenates the first lens[i]
// bytes of each row into out.  Returns total bytes written.
int64_t ft_gather_frames(const uint8_t* rows, int64_t nrows, int64_t row_bytes,
                         const int64_t* lens, uint8_t* out) {
  int64_t total = 0;
  for (int64_t i = 0; i < nrows; i++) {
    memcpy(out + total, rows + i * row_bytes, (size_t)lens[i]);
    total += lens[i];
  }
  return total;
}

// ---------------------------------------------------------------------------
// Direct-form IIR filter (ReplayGain equal-loudness cascade)
// ---------------------------------------------------------------------------

// y[i] = b[0]*x[i] + sum_{k=1..order} (b[k]*x[i-k] - a[k]*y[i-k]).
// x and y each carry `order` history samples BEFORE index 0 (caller pads /
// threads state across calls), matching replaygain_analysis.c:258-297.
void ft_iir(const double* x, double* y, int64_t n, const double* b,
            const double* a, int32_t order) {
  for (int64_t i = 0; i < n; i++) {
    double acc = x[i] * b[0];
    for (int32_t k = 1; k <= order; k++)
      acc += x[i - k] * b[k] - y[i - k] * a[k];
    y[i] = acc;
  }
}

}  // extern "C"
