/* Host-side decoders for the orbax checkpoint format, with a plain C
 * interface for ctypes (nerfsr_torch/utils/zstd.py):
 *
 *   - zstd frames (RFC 8878): raw, RLE and compressed blocks; Huffman
 *     literals (1 and 4 streams, treeless repeats); FSE sequences
 *     (predefined, RLE, compressed and repeat modes); repeat offsets;
 *     skippable frames; several frames back to back. A frame with the
 *     checksum flag is held to its xxhash64 checksum. A frame that names a
 *     dictionary is refused: the checkpoints use none.
 *   - crc32c (Castagnoli, reflected 0x82F63B78), the checksum that ends
 *     every OCDBT manifest and b-tree node file.
 *   - xxhash64, for the zstd checksum.
 *
 * Every entry returns 0 or a negative NERFSR_Z_* code; nerfsr_zstd_error
 * names it. Nothing here allocates but the decoder's context.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    Z_OK = 0,
    Z_SRC = -1,       /* the input ends inside a frame */
    Z_CORRUPT = -2,   /* the input breaks the format */
    Z_DST = -3,       /* the output buffer is too small */
    Z_DICT = -4,      /* the frame needs a dictionary */
    Z_CHECKSUM = -5,  /* the content checksum disagrees */
    Z_MAGIC = -6,     /* not a zstd frame */
    Z_ALLOC = -7,     /* out of memory */
    Z_SIZE = -8       /* the frame's content size disagrees with its data */
};

const char *nerfsr_zstd_error(int code) {
    switch (code) {
    case Z_OK: return "ok";
    case Z_SRC: return "truncated input";
    case Z_CORRUPT: return "corrupt input";
    case Z_DST: return "output buffer too small";
    case Z_DICT: return "frame needs a dictionary";
    case Z_CHECKSUM: return "content checksum mismatch";
    case Z_MAGIC: return "not a zstd frame";
    case Z_ALLOC: return "out of memory";
    case Z_SIZE: return "content size mismatch";
    default: return "unknown error";
    }
}

#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define LL_MAX_SYM 35
#define ML_MAX_SYM 52
#define OF_MAX_SYM 31

static uint32_t rd16(const uint8_t *p) { return p[0] | (uint32_t)p[1] << 8; }
static uint32_t rd24(const uint8_t *p) { return rd16(p) | (uint32_t)p[2] << 16; }
static uint32_t rd32(const uint8_t *p) { return rd16(p) | (uint32_t)rd16(p + 2) << 16; }
static uint64_t rd64(const uint8_t *p) { return rd32(p) | (uint64_t)rd32(p + 4) << 32; }

static uint64_t rdle(const uint8_t *p, int n) {
    uint64_t v = 0;
    for (int i = n - 1; i >= 0; i--) v = v << 8 | p[i];
    return v;
}

static int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

/* ------------------------------------------------------------------ */
/* checksums                                                          */
/* ------------------------------------------------------------------ */

static uint32_t crc_table[8][256];
static int crc_ready = 0;

static void crc_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
        crc_table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
        for (int i = 0; i < 256; i++)
            crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^
                              crc_table[0][crc_table[t - 1][i] & 0xFF];
    crc_ready = 1;
}

/* crc32c of p[0:n), continuing from ``crc`` (0 to start). */
uint32_t nerfsr_crc32c(uint32_t crc, const uint8_t *p, size_t n) {
    if (!crc_ready) crc_init();
    crc = ~crc;
    while (n >= 8) {   /* slicing by eight */
        uint32_t lo = rd32(p) ^ crc, hi = rd32(p + 4);
        crc = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
              crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^
              crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
              crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

#define P1 0x9E3779B185EBCA87ull
#define P2 0xC2B2AE3D27D4EB4Full
#define P3 0x165667B19E3779F9ull
#define P4 0x85EBCA77C2B2AE63ull
#define P5 0x27D4EB2F165667C5ull

static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
static uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * P1 + P4; }

uint64_t nerfsr_xxh64(const uint8_t *p, size_t n, uint64_t seed) {
    const uint8_t *end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        do {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
            p += 32;
        } while (end - p >= 32);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)n;
    while (end - p >= 8) {
        h ^= xround(0, rd64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        h ^= (uint64_t)rd32(p) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p++) * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------------ */
/* bit streams                                                        */
/* ------------------------------------------------------------------ */

/* The ``nb`` bits at bit ``pos`` of p[0:n) (bit 0 is byte 0's lowest),
 * least significant first; bits outside the buffer read as 0. */
static uint64_t bits_at(const uint8_t *p, size_t n, int64_t pos, int nb) {
    if (nb == 0) return 0;
    uint64_t mask = nb >= 64 ? ~0ull : ((1ull << nb) - 1);
    if (pos >= 0 && (size_t)(pos >> 3) + 8 <= n && nb <= 56)
        return (rd64(p + (pos >> 3)) >> (pos & 7)) & mask;
    uint64_t v = 0;
    for (int i = 0; i < nb; i++) {
        int64_t b = pos + i;
        if (b >= 0 && (size_t)(b >> 3) < n) v |= (uint64_t)((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
}

/* A stream read backwards from its end: the highest set bit of its last
 * byte marks where the data starts; each read takes the bits just below
 * ``pos``. Reading past the start yields zeros and a negative ``pos``. */
typedef struct {
    const uint8_t *p;
    size_t n;
    int64_t pos;
} bwd_t;

static int bwd_init(bwd_t *s, const uint8_t *p, size_t n) {
    if (n == 0 || p[n - 1] == 0) return Z_CORRUPT;
    s->p = p;
    s->n = n;
    s->pos = (int64_t)(n - 1) * 8 + highbit(p[n - 1]);
    return Z_OK;
}

static uint64_t bwd_read(bwd_t *s, int nb) {
    s->pos -= nb;
    return bits_at(s->p, s->n, s->pos, nb);
}

static uint64_t bwd_peek(const bwd_t *s, int nb) {
    return bits_at(s->p, s->n, s->pos - nb, nb);
}

/* ------------------------------------------------------------------ */
/* FSE                                                                */
/* ------------------------------------------------------------------ */

typedef struct {
    uint16_t base;
    uint8_t sym;
    uint8_t nb;
} fse_t;

typedef struct {
    fse_t t[512];
    int log;
    int valid;
} fse_table_t;

/* The FSE table description at p[0:n): normalized counts of symbols
 * 0..max_sym into ``norm`` (-1 is "below one"), the accuracy log, the
 * number of symbols described and the bytes used. */
static int read_ncount(const uint8_t *p, size_t n, int16_t *norm, int max_sym,
                       int max_log, int *log_out, int *nsym_out, size_t *used) {
    if (n == 0) return Z_SRC;
    int64_t bp = 0;
    int log = (int)bits_at(p, n, bp, 4) + 5;
    bp += 4;
    if (log > max_log) return Z_CORRUPT;
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
    int sym = 0, prev0 = 0;
    while (remaining > 1 && sym <= max_sym) {
        if (prev0) {
            int n0 = sym;
            for (;;) {
                int r = (int)bits_at(p, n, bp, 2);
                bp += 2;
                n0 += r;
                if (r != 3) break;
                if ((size_t)(bp >> 3) > n) return Z_SRC;
            }
            if (n0 > max_sym) return Z_CORRUPT;
            while (sym < n0) norm[sym++] = 0;
        }
        int max = (2 * threshold - 1) - remaining;
        uint32_t v = (uint32_t)bits_at(p, n, bp, nbits);
        int count;
        if ((int)(v & (threshold - 1)) < max) {
            count = v & (threshold - 1);
            bp += nbits - 1;
        } else {
            count = v & (2 * threshold - 1);
            if (count >= threshold) count -= max;
            bp += nbits;
        }
        count--;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return Z_CORRUPT;
    size_t bytes = (size_t)((bp + 7) >> 3);
    if (bytes > n) return Z_SRC;
    *log_out = log;
    *nsym_out = sym;
    *used = bytes;
    return Z_OK;
}

static int build_fse(fse_table_t *tab, const int16_t *norm, int nsym, int log) {
    int size = 1 << log, high = size - 1;
    uint16_t next[256];
    fse_t *t = tab->t;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            t[high--].sym = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)norm[s];
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t[pos].sym = (uint8_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    }
    if (pos != 0) return Z_CORRUPT;
    for (int u = 0; u < size; u++) {
        int s = t[u].sym;
        uint32_t x = next[s]++;
        int nb = log - highbit(x);
        t[u].nb = (uint8_t)nb;
        t[u].base = (uint16_t)((x << nb) - size);
    }
    tab->log = log;
    tab->valid = 1;
    return Z_OK;
}

static void rle_fse(fse_table_t *tab, uint8_t sym) {
    tab->t[0].sym = sym;
    tab->t[0].nb = 0;
    tab->t[0].base = 0;
    tab->log = 0;
    tab->valid = 1;
}

/* ------------------------------------------------------------------ */
/* sequences' codes (RFC 8878 3.1.1.3.2.1)                            */
/* ------------------------------------------------------------------ */

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, -1, -1, -1, -1, -1};

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* ------------------------------------------------------------------ */
/* the decoder's context                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t huf_sym[1 << HUF_MAX_BITS];
    uint8_t huf_nb[1 << HUF_MAX_BITS];
    int huf_bits;
    int huf_valid;
    fse_table_t ll, of, ml;
    uint64_t rep[3];
    uint8_t lit[BLOCK_MAX + 8];
} ctx_t;

/* The Huffman tree description at p[0:n): the weights, directly or as an
 * FSE-coded stream, the implied last weight, and the decoding table. */
static int read_huffman(ctx_t *c, const uint8_t *p, size_t n, size_t *used) {
    if (n == 0) return Z_SRC;
    uint8_t w[256];
    int nw = 0;
    int hb = p[0];
    if (hb >= 128) {
        nw = hb - 127;
        size_t bytes = (size_t)(nw + 1) / 2;
        if (1 + bytes > n) return Z_SRC;
        for (int i = 0; i < nw; i++)
            w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
        *used = 1 + bytes;
    } else {
        size_t csize = (size_t)hb;
        if (1 + csize > n) return Z_SRC;
        int16_t norm[256];
        int log, nsym;
        size_t hdr;
        int err = read_ncount(p + 1, csize, norm, 255, 6, &log, &nsym, &hdr);
        if (err) return err;
        fse_table_t wt;
        err = build_fse(&wt, norm, nsym, log);
        if (err) return err;
        bwd_t s;
        err = bwd_init(&s, p + 1 + hdr, csize - hdr);
        if (err) return err;
        uint32_t s1 = (uint32_t)bwd_read(&s, log), s2 = (uint32_t)bwd_read(&s, log);
        /* two interleaved states, until the stream's bits run out */
        for (;;) {
            if (nw >= 255) return Z_CORRUPT;
            w[nw++] = wt.t[s1].sym;
            s1 = wt.t[s1].base + (uint32_t)bwd_read(&s, wt.t[s1].nb);
            if (nw >= 255) return Z_CORRUPT;
            if (s.pos < 0) {
                w[nw++] = wt.t[s2].sym;
                break;
            }
            w[nw++] = wt.t[s2].sym;
            s2 = wt.t[s2].base + (uint32_t)bwd_read(&s, wt.t[s2].nb);
            if (s.pos < 0) {
                if (nw >= 255) return Z_CORRUPT;
                w[nw++] = wt.t[s1].sym;
                break;
            }
        }
        *used = 1 + csize;
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS) return Z_CORRUPT;
        if (w[i]) total += 1u << (w[i] - 1);
    }
    if (total == 0) return Z_CORRUPT;
    int bits = highbit(total) + 1;
    if (bits > HUF_MAX_BITS) return Z_CORRUPT;
    uint32_t rest = (1u << bits) - total;
    if (rest & (rest - 1)) return Z_CORRUPT;
    w[nw++] = (uint8_t)(highbit(rest) + 1);
    int fill = 0;
    for (int weight = 1; weight <= bits; weight++) {
        for (int s = 0; s < nw; s++) {
            if (w[s] != weight) continue;
            int len = 1 << (weight - 1);
            memset(c->huf_sym + fill, s, (size_t)len);
            memset(c->huf_nb + fill, bits + 1 - weight, (size_t)len);
            fill += len;
        }
    }
    if (fill != 1 << bits) return Z_CORRUPT;
    c->huf_bits = bits;
    c->huf_valid = 1;
    return Z_OK;
}

static int huffman_stream(const ctx_t *c, const uint8_t *p, size_t n,
                          uint8_t *out, size_t count) {
    bwd_t s;
    int err = bwd_init(&s, p, n);
    if (err) return err;
    int bits = c->huf_bits;
    for (size_t i = 0; i < count; i++) {
        uint32_t v = (uint32_t)bwd_peek(&s, bits);
        out[i] = c->huf_sym[v];
        s.pos -= c->huf_nb[v];
    }
    return s.pos == 0 ? Z_OK : Z_CORRUPT;
}

/* The literals section at p[0:n) into c->lit: its size in *nlit and the
 * bytes it takes in *used. */
static int read_literals(ctx_t *c, const uint8_t *p, size_t n, size_t *used,
                         size_t *nlit) {
    if (n == 0) return Z_SRC;
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
        size_t hsize, rsize;
        if (sf == 1) {
            if (n < 2) return Z_SRC;
            hsize = 2;
            rsize = (p[0] >> 4) + ((size_t)p[1] << 4);
        } else if (sf == 3) {
            if (n < 3) return Z_SRC;
            hsize = 3;
            rsize = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
        } else {
            hsize = 1;
            rsize = p[0] >> 3;
        }
        if (rsize > BLOCK_MAX) return Z_CORRUPT;
        if (type == 0) {
            if (hsize + rsize > n) return Z_SRC;
            memcpy(c->lit, p + hsize, rsize);
            *used = hsize + rsize;
        } else {
            if (hsize + 1 > n) return Z_SRC;
            memset(c->lit, p[hsize], rsize);
            *used = hsize + 1;
        }
        *nlit = rsize;
        return Z_OK;
    }
    int streams = sf == 0 ? 1 : 4;
    int hsize = sf < 2 ? 3 : sf + 2;
    int bits = sf < 2 ? 10 : sf == 2 ? 14 : 18;
    if ((size_t)hsize > n) return Z_SRC;
    uint64_t h = rdle(p, hsize);
    size_t rsize = (size_t)((h >> 4) & ((1u << bits) - 1));
    size_t csize = (size_t)((h >> (4 + bits)) & ((1u << bits) - 1));
    if (rsize > BLOCK_MAX) return Z_CORRUPT;
    if (hsize + csize > n) return Z_SRC;
    const uint8_t *q = p + hsize;
    size_t m = csize;
    if (type == 2) {
        size_t tree;
        int err = read_huffman(c, q, m, &tree);
        if (err) return err;
        q += tree;
        m -= tree;
    } else if (!c->huf_valid) {
        return Z_CORRUPT;
    }
    int err;
    if (streams == 1) {
        err = huffman_stream(c, q, m, c->lit, rsize);
    } else {
        if (m < 6) return Z_CORRUPT;
        size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
        if (6 + s1 + s2 + s3 > m) return Z_CORRUPT;
        size_t s4 = m - 6 - s1 - s2 - s3;
        size_t seg = (rsize + 3) / 4;
        if (3 * seg > rsize) return Z_CORRUPT;
        const uint8_t *src = q + 6;
        size_t sizes[4] = {s1, s2, s3, s4};
        size_t counts[4] = {seg, seg, seg, rsize - 3 * seg};
        uint8_t *out = c->lit;
        err = Z_OK;
        for (int i = 0; i < 4 && !err; i++) {
            err = huffman_stream(c, src, sizes[i], out, counts[i]);
            src += sizes[i];
            out += counts[i];
        }
    }
    if (err) return err;
    *used = hsize + csize;
    *nlit = rsize;
    return Z_OK;
}

static int read_table(fse_table_t *tab, int mode, const uint8_t *p, size_t n,
                      size_t *used, const int16_t *dflt, int dflt_n,
                      int dflt_log, int max_sym, int max_log) {
    int16_t norm[256];
    int log, nsym, err;
    switch (mode) {
    case 0:
        *used = 0;
        return build_fse(tab, dflt, dflt_n, dflt_log);
    case 1:
        if (n < 1) return Z_SRC;
        if (p[0] > max_sym) return Z_CORRUPT;
        rle_fse(tab, p[0]);
        *used = 1;
        return Z_OK;
    case 2:
        err = read_ncount(p, n, norm, max_sym, max_log, &log, &nsym, used);
        if (err) return err;
        return build_fse(tab, norm, nsym, log);
    default:
        *used = 0;
        return tab->valid ? Z_OK : Z_CORRUPT;
    }
}

/* One compressed block p[0:n) appended at dst + *out (the frame's output
 * starts at dst + frame_start). */
static int compressed_block(ctx_t *c, const uint8_t *p, size_t n, uint8_t *dst,
                            size_t cap, size_t frame_start, size_t *out) {
    size_t used, nlit;
    int err = read_literals(c, p, n, &used, &nlit);
    if (err) return err;
    p += used;
    n -= used;
    if (n == 0) return Z_SRC;
    size_t nseq, h;
    if (p[0] < 128) {
        nseq = p[0];
        h = 1;
    } else if (p[0] < 255) {
        if (n < 2) return Z_SRC;
        nseq = ((size_t)(p[0] - 128) << 8) + p[1];
        h = 2;
    } else {
        if (n < 3) return Z_SRC;
        nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
        h = 3;
    }
    p += h;
    n -= h;
    size_t o = *out, lit_pos = 0;
    if (nseq > 0) {
        if (n < 1) return Z_SRC;
        int modes = p[0];
        if (modes & 3) return Z_CORRUPT;
        p++;
        n--;
        size_t u;
        err = read_table(&c->ll, modes >> 6, p, n, &u, LL_DEFAULT, 36, 6,
                         LL_MAX_SYM, 9);
        if (err) return err;
        p += u;
        n -= u;
        err = read_table(&c->of, (modes >> 4) & 3, p, n, &u, OF_DEFAULT, 29, 5,
                         OF_MAX_SYM, 8);
        if (err) return err;
        p += u;
        n -= u;
        err = read_table(&c->ml, (modes >> 2) & 3, p, n, &u, ML_DEFAULT, 53, 6,
                         ML_MAX_SYM, 9);
        if (err) return err;
        p += u;
        n -= u;
        bwd_t s;
        err = bwd_init(&s, p, n);
        if (err) return err;
        uint32_t ls = (uint32_t)bwd_read(&s, c->ll.log);
        uint32_t os = (uint32_t)bwd_read(&s, c->of.log);
        uint32_t ms = (uint32_t)bwd_read(&s, c->ml.log);
        for (size_t i = 0; i < nseq; i++) {
            int lc = c->ll.t[ls].sym, oc = c->of.t[os].sym, mc = c->ml.t[ms].sym;
            if (lc > LL_MAX_SYM || mc > ML_MAX_SYM || oc > OF_MAX_SYM)
                return Z_CORRUPT;
            uint64_t ofv = (1ull << oc) + bwd_read(&s, oc);
            uint64_t ml = ML_BASE[mc] + bwd_read(&s, ML_BITS[mc]);
            uint64_t ll = LL_BASE[lc] + bwd_read(&s, LL_BITS[lc]);
            uint64_t offset;
            if (ofv > 3) {
                offset = ofv - 3;
                c->rep[2] = c->rep[1];
                c->rep[1] = c->rep[0];
                c->rep[0] = offset;
            } else {
                int idx = (int)ofv + (ll == 0);
                if (idx == 1) {
                    offset = c->rep[0];
                } else {
                    offset = idx == 4 ? c->rep[0] - 1 : c->rep[idx - 1];
                    if (offset == 0) return Z_CORRUPT;
                    if (idx != 2) c->rep[2] = c->rep[1];
                    c->rep[1] = c->rep[0];
                    c->rep[0] = offset;
                }
            }
            if (i + 1 < nseq) {
                ls = c->ll.t[ls].base + (uint32_t)bwd_read(&s, c->ll.t[ls].nb);
                ms = c->ml.t[ms].base + (uint32_t)bwd_read(&s, c->ml.t[ms].nb);
                os = c->of.t[os].base + (uint32_t)bwd_read(&s, c->of.t[os].nb);
            }
            if (lit_pos + ll > nlit) return Z_CORRUPT;
            if (o + ll + ml > cap) return Z_DST;
            memcpy(dst + o, c->lit + lit_pos, (size_t)ll);
            o += ll;
            lit_pos += ll;
            if (offset > o - frame_start) return Z_CORRUPT;
            uint8_t *d = dst + o;
            const uint8_t *from = d - offset;
            if (offset >= ml) {
                memcpy(d, from, (size_t)ml);
            } else {
                for (uint64_t k = 0; k < ml; k++) d[k] = from[k];
            }
            o += ml;
        }
        if (s.pos != 0) return Z_CORRUPT;
    } else if (n != 0) {
        return Z_CORRUPT;
    }
    size_t left = nlit - lit_pos;
    if (o + left > cap) return Z_DST;
    memcpy(dst + o, c->lit + lit_pos, left);
    *out = o + left;
    return Z_OK;
}

/* ------------------------------------------------------------------ */
/* frames                                                             */
/* ------------------------------------------------------------------ */

typedef struct {
    size_t header;      /* bytes before the first block */
    int skippable;
    size_t skip;        /* a skippable frame's total bytes */
    int has_size;
    uint64_t size;
    int checksum;
} frame_t;

static int frame_header(const uint8_t *p, size_t n, frame_t *f) {
    memset(f, 0, sizeof(*f));
    if (n < 4) return Z_SRC;
    uint32_t magic = rd32(p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n < 8) return Z_SRC;
        f->skippable = 1;
        f->skip = 8 + (size_t)rd32(p + 4);
        if (f->skip > n) return Z_SRC;
        return Z_OK;
    }
    if (magic != 0xFD2FB528u) return Z_MAGIC;
    if (n < 5) return Z_SRC;
    int fhd = p[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
    if (fhd & 8) return Z_CORRUPT;
    f->checksum = (fhd >> 2) & 1;
    size_t pos = 5 + (single ? 0 : 1);
    static const int did_bytes[4] = {0, 1, 2, 4};
    static const int fcs_bytes[4] = {0, 2, 4, 8};
    int db = did_bytes[did_flag];
    int fb = fcs_flag == 0 && single ? 1 : fcs_bytes[fcs_flag];
    if (pos + db + fb > n) return Z_SRC;
    if (db && rdle(p + pos, db) != 0) return Z_DICT;
    pos += db;
    if (fb) {
        f->has_size = 1;
        f->size = rdle(p + pos, fb) + (fb == 2 ? 256 : 0);
    }
    f->header = pos + fb;
    return Z_OK;
}

/* Bytes of the frame at p (blocks and checksum included). */
static int frame_span(const uint8_t *p, size_t n, const frame_t *f, size_t *span) {
    if (f->skippable) {
        *span = f->skip;
        return Z_OK;
    }
    size_t pos = f->header;
    for (;;) {
        if (pos + 3 > n) return Z_SRC;
        uint32_t bh = rd24(p + pos);
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        if (type == 3) return Z_CORRUPT;
        pos += 3 + (type == 1 ? 1 : size);
        if (pos > n) return Z_SRC;
        if (last) break;
    }
    pos += f->checksum ? 4 : 0;
    if (pos > n) return Z_SRC;
    *span = pos;
    return Z_OK;
}

/* The decoded size of all frames in src[0:n) into *size: 0 when every
 * frame states its content size, 1 when one does not, or an error. */
int nerfsr_zstd_content_size(const uint8_t *src, size_t n, uint64_t *size) {
    uint64_t total = 0;
    int known = 1;
    size_t pos = 0;
    if (n == 0) return Z_SRC;
    while (pos < n) {
        frame_t f;
        size_t span;
        int err = frame_header(src + pos, n - pos, &f);
        if (!err) err = frame_span(src + pos, n - pos, &f, &span);
        if (err) return err;
        if (!f.skippable) {
            if (f.has_size)
                total += f.size;
            else
                known = 0;
        }
        pos += span;
    }
    *size = total;
    return known ? 0 : 1;
}

static int decode_frame(ctx_t *c, const uint8_t *p, size_t n, const frame_t *f,
                        uint8_t *dst, size_t cap, size_t *out, size_t *used) {
    size_t pos = f->header, start = *out, o = *out;
    c->huf_valid = c->ll.valid = c->of.valid = c->ml.valid = 0;
    c->rep[0] = 1;
    c->rep[1] = 4;
    c->rep[2] = 8;
    for (;;) {
        if (pos + 3 > n) return Z_SRC;
        uint32_t bh = rd24(p + pos);
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        pos += 3;
        if (size > BLOCK_MAX) return Z_CORRUPT;
        if (type == 0) {
            if (pos + size > n) return Z_SRC;
            if (o + size > cap) return Z_DST;
            memcpy(dst + o, p + pos, size);
            o += size;
            pos += size;
        } else if (type == 1) {
            if (pos + 1 > n) return Z_SRC;
            if (o + size > cap) return Z_DST;
            memset(dst + o, p[pos], size);
            o += size;
            pos += 1;
        } else if (type == 2) {
            if (pos + size > n) return Z_SRC;
            int err = compressed_block(c, p + pos, size, dst, cap, start, &o);
            if (err) return err;
            pos += size;
        } else {
            return Z_CORRUPT;
        }
        if (last) break;
    }
    if (f->has_size && o - start != f->size) return Z_SIZE;
    if (f->checksum) {
        if (pos + 4 > n) return Z_SRC;
        uint32_t want = rd32(p + pos);
        if ((uint32_t)nerfsr_xxh64(dst + start, o - start, 0) != want)
            return Z_CHECKSUM;
        pos += 4;
    }
    *out = o;
    *used = pos;
    return Z_OK;
}

/* Decode every frame of src[0:n) into dst[0:cap); the decoded size goes
 * to *out. */
int nerfsr_zstd_decompress(const uint8_t *src, size_t n, uint8_t *dst,
                           size_t cap, size_t *out) {
    ctx_t *c = (ctx_t *)malloc(sizeof(ctx_t));
    if (!c) return Z_ALLOC;
    size_t pos = 0, o = 0;
    int err = n == 0 ? Z_SRC : Z_OK;
    while (!err && pos < n) {
        frame_t f;
        size_t used = 0;
        err = frame_header(src + pos, n - pos, &f);
        if (err) break;
        if (f.skippable) {
            pos += f.skip;
            continue;
        }
        err = decode_frame(c, src + pos, n - pos, &f, dst, cap, &o, &used);
        pos += used;
    }
    free(c);
    *out = o;
    return err;
}
