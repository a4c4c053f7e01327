// Host-side data-path routines of the port (C++), loaded with ctypes:
// CRC32C checksums, the TFRecord frame scan and the tf.train.Example walk
// of the reference's image records.  A copy of the JAX package's
// gansformer_tpu/native/host_ops.cpp; gansformer_tpu_torch/native builds it
// with g++ at first use.  They feed the card from the host and replace no
// TPU kernel.
//
// ABI: plain C functions, int64/size_t/uint8* only, so ctypes needs no
// struct mirroring.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, reflected 0x82F63B78) — slicing-by-8.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static bool crc_init_done = false;

static void crc_init() {
    for (int i = 0; i < 256; ++i) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
        kCrcTable[0][i] = c;
    }
    for (int t = 1; t < 8; ++t)
        for (int i = 0; i < 256; ++i)
            kCrcTable[t][i] = (kCrcTable[t - 1][i] >> 8) ^
                              kCrcTable[0][kCrcTable[t - 1][i] & 0xFF];
    crc_init_done = true;
}

uint32_t gft_crc32c(const uint8_t* buf, size_t len) {
    if (!crc_init_done) crc_init();
    uint32_t crc = 0xFFFFFFFFu;
    while (len >= 8) {
        uint64_t word;
        std::memcpy(&word, buf, 8);          // little-endian hosts only
        word ^= crc;
        crc = kCrcTable[7][word & 0xFF] ^
              kCrcTable[6][(word >> 8) & 0xFF] ^
              kCrcTable[5][(word >> 16) & 0xFF] ^
              kCrcTable[4][(word >> 24) & 0xFF] ^
              kCrcTable[3][(word >> 32) & 0xFF] ^
              kCrcTable[2][(word >> 40) & 0xFF] ^
              kCrcTable[1][(word >> 48) & 0xFF] ^
              kCrcTable[0][(word >> 56) & 0xFF];
        buf += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *buf++) & 0xFF];
    return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// TFRecord frame scan: u64 length, u32 masked-crc(len), payload, u32
// masked-crc(payload).  Fills (offset, length) pairs for every COMPLETE
// record in the buffer; *consumed reports the bytes covered by complete
// records so callers can stream the file in chunks (the next chunk starts
// at consumed).  verify_crc != 0 additionally checks both checksums (the
// pure-Python reader skips them; native is fast enough to verify).
//
// All bounds checks are subtraction-form — a hostile/corrupt u64 length
// field must not overflow `pos + rec_len` (that wrap previously caused an
// infinite loop / OOB read).
//
// Returns record count (>= 0; a partial record at the tail is NOT an
// error — it just isn't consumed), or -1 with *err_pos = byte offset on a
// CRC mismatch.
// ---------------------------------------------------------------------------

static inline uint32_t masked(uint32_t crc) {
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

int64_t gft_scan_records(const uint8_t* buf, size_t len,
                         int64_t* offs, int64_t* lens, int64_t cap,
                         int verify_crc, size_t* consumed,
                         size_t* err_pos) {
    size_t pos = 0;
    int64_t n = 0;
    *consumed = 0;
    *err_pos = 0;
    while (len - pos >= 12) {
        uint64_t rec_len;
        std::memcpy(&rec_len, buf + pos, 8);
        // need rec_len + 4 more bytes after the 12-byte header; overflow-safe
        size_t avail = len - pos - 12;
        if (rec_len > avail || avail - rec_len < 4) break;  // partial tail
        if (verify_crc) {
            uint32_t want;
            std::memcpy(&want, buf + pos + 8, 4);
            if (masked(gft_crc32c(buf + pos, 8)) != want) {
                *err_pos = pos;
                return -1;
            }
            std::memcpy(&want, buf + pos + 12 + rec_len, 4);
            if (masked(gft_crc32c(buf + pos + 12, rec_len)) != want) {
                *err_pos = pos;
                return -1;
            }
        }
        if (n < cap) {
            offs[n] = (int64_t)(pos + 12);
            lens[n] = (int64_t)rec_len;
        }
        ++n;
        pos += 12 + (size_t)rec_len + 4;
        *consumed = pos;
    }
    return n;
}

// ---------------------------------------------------------------------------
// tf.train.Example walk for the reference schema {shape: int64[..],
// data: bytes} (proto field numbers in data/dataset.py _parse_example_image).
// Fills shape (up to 4 dims) and the data span; returns 0 on success,
// negative error codes otherwise.
// ---------------------------------------------------------------------------

static int read_varint(const uint8_t* buf, size_t len, size_t* pos,
                       uint64_t* out) {
    uint64_t result = 0;
    int shift = 0;
    while (*pos < len && shift < 64) {
        uint8_t b = buf[(*pos)++];
        result |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = result; return 0; }
        shift += 7;
    }
    return -1;
}

// Walk one message level; returns 0 and the value span for `field`
// with wire type 2, scanning from *pos to end.
struct Span { size_t off; size_t len; };

static int find_fields(const uint8_t* buf, size_t off, size_t end,
                       int want_field, Span* out, int out_cap) {
    size_t pos = off;
    int found = 0;
    while (pos < end) {
        uint64_t tag, tmp;
        if (read_varint(buf, end, &pos, &tag)) return -2;
        int field = (int)(tag >> 3), wt = (int)(tag & 7);
        switch (wt) {
            case 0:
                if (read_varint(buf, end, &pos, &tmp)) return -2;
                break;
            case 2: {
                uint64_t ln;
                if (read_varint(buf, end, &pos, &ln)) return -2;
                if (ln > end - pos) return -2;     // overflow-safe bound
                if (field == want_field && found < out_cap) {
                    out[found].off = pos;
                    out[found].len = (size_t)ln;
                }
                if (field == want_field) ++found;
                pos += ln;
                break;
            }
            case 5: pos += 4; break;
            case 1: pos += 8; break;
            default: return -3;
        }
        if (pos > end) return -2;
    }
    return found;
}

int gft_parse_example(const uint8_t* buf, size_t len,
                      int64_t* shape, int32_t* ndim,
                      int64_t* data_off, int64_t* data_len) {
    Span features;
    int n = find_fields(buf, 0, len, 1, &features, 1);   // Example.features
    if (n < 1) return -10;
    Span entries[64];
    int n_ent = find_fields(buf, features.off, features.off + features.len,
                            1, entries, 64);             // feature map entries
    if (n_ent < 0) return -11;
    if (n_ent > 64) n_ent = 64;
    *ndim = 0;
    *data_off = -1;
    bool have_shape = false;
    for (int i = 0; i < n_ent; ++i) {
        Span key, val;
        if (find_fields(buf, entries[i].off, entries[i].off + entries[i].len,
                        1, &key, 1) < 1) continue;
        if (find_fields(buf, entries[i].off, entries[i].off + entries[i].len,
                        2, &val, 1) < 1) continue;
        if (key.len == 5 && !std::memcmp(buf + key.off, "shape", 5)) {
            Span lst;                                    // Feature.int64_list
            if (find_fields(buf, val.off, val.off + val.len, 3, &lst, 1) < 1)
                return -12;
            // int64_list.value: repeated varint (packed or not)
            size_t pos = lst.off, end = lst.off + lst.len;
            while (pos < end && *ndim < 4) {
                uint64_t tag;
                if (read_varint(buf, end, &pos, &tag)) return -12;
                int wt = (int)(tag & 7);
                if (wt == 0) {
                    uint64_t v;
                    if (read_varint(buf, end, &pos, &v)) return -12;
                    shape[(*ndim)++] = (int64_t)v;
                } else if (wt == 2) {                    // packed
                    uint64_t ln;
                    if (read_varint(buf, end, &pos, &ln)) return -12;
                    size_t pend = pos + ln;
                    while (pos < pend && *ndim < 4) {
                        uint64_t v;
                        if (read_varint(buf, pend, &pos, &v)) return -12;
                        shape[(*ndim)++] = (int64_t)v;
                    }
                } else return -12;
            }
            have_shape = true;
        } else if (key.len == 4 && !std::memcmp(buf + key.off, "data", 4)) {
            Span lst;                                    // Feature.bytes_list
            if (find_fields(buf, val.off, val.off + val.len, 1, &lst, 1) < 1)
                return -13;
            Span bytes;                                  // bytes_list.value
            if (find_fields(buf, lst.off, lst.off + lst.len, 1, &bytes, 1) < 1)
                return -13;
            *data_off = (int64_t)bytes.off;
            *data_len = (int64_t)bytes.len;
        }
    }
    if (!have_shape || *data_off < 0) return -14;
    return 0;
}

}  // extern "C"
