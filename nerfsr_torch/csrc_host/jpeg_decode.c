/* JPEG decoder (ITU T.81) for the port's datasets, giving the bytes that
 * libjpeg-turbo gives with its decompression defaults, as PIL opens a
 * JPEG: the islow integer IDCT (jidctint.c), fancy upsampling
 * (jdsample.c's h2v1/h2v2 triangle filters, plain replication where it
 * uses that), no merged upsampler, and jdcolor.c's fixed-point YCbCr to
 * RGB tables.
 *
 * Covered: baseline (SOF0), extended sequential (SOF1) and progressive
 * (SOF2) Huffman frames of 8-bit samples; interleaved and
 * non-interleaved scans; DC first/refine and AC first/refine scans with
 * EOB runs and correction bits; restart intervals; 8- and 16-bit
 * quantization tables; 1 component (gray) or 3 (YCbCr, or RGB as the
 * Adobe transform 0 or component ids 'R' 'G' 'B' say); the sampling
 * layouts 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2) and gray 1x1. APPn and COM
 * segments are skipped.
 *
 * Refused by name: arithmetic coding, 12-bit samples, lossless and
 * hierarchical frames, 4 components (CMYK/YCCK), other sampling
 * layouts, a progression that leaves coefficients unrefined (libjpeg
 * would smooth its blocks), a height given by a DNL marker. Truncated
 * or corrupt data is an error: every read is bounds-checked.
 *
 * Entry points return 0, or -1 with a message in the caller's buffer.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_PIXELS 178956970ULL /* PIL's decompression-bomb error limit */

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* a corrupt run can push k past 63: land on 63, as libjpeg does */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
  uint16_t lut[1 << 16]; /* 16-bit lookahead -> (length << 8) | symbol */
  int max_symbol;
} huff_t;

typedef struct {
  int id, h, v, tq;
  int bw, bh;   /* blocks covering the component (width_in_blocks) */
  int pbw, pbh; /* the block grid padded to whole MCUs */
  int dw, dh;   /* samples of the component (downsampled_width) */
  int16_t *coef; /* pbh * pbw blocks of 64, natural order */
  int latched;
  int16_t q[64]; /* the quantization table latched at its first scan */
  int coef_bits[64];
  int dc_pred;
  uint8_t *plane; /* (bh * 8) x (bw * 8) samples after the IDCT */
  uint8_t *full;  /* the upsampled plane, hmax/h * bw * 8 wide */
} comp_t;

typedef struct {
  const uint8_t *end, *p;
  uint64_t buf;
  int nbits, pad, hit_marker, hit_end;
  jmp_buf jb;
  char *err;
  size_t errcap;
  int width, height, ncomp, progressive, hmax, vmax, mcux, mcuy;
  int restart_interval, saw_jfif, saw_adobe, adobe_transform, scans;
  comp_t comp[3];
  int qdef[4];
  int16_t qt[4][64];
  huff_t *dc[4], *ac[4];
  int eobrun;
  int *scratch; /* a row of column sums for h2v2_fancy_upsample */
} dec_t;

static void fail(dec_t *d, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  if (d->errcap)
    vsnprintf(d->err, d->errcap, fmt, ap);
  va_end(ap);
  longjmp(d->jb, 1);
}

#define TRUNCATED(d) fail(d, "image file is truncated")

static void *xcalloc(dec_t *d, size_t n, size_t size) {
  void *p = calloc(n ? n : 1, size);
  if (!p)
    fail(d, "out of memory (%zu bytes)", n * size);
  return p;
}

/* -- markers ------------------------------------------------------------ */

static int next_marker(dec_t *d) {
  for (;;) { /* skip garbage, fill bytes and FF 00 pairs, as libjpeg */
    while (d->p < d->end && *d->p != 0xFF)
      d->p++;
    while (d->p < d->end && *d->p == 0xFF)
      d->p++;
    if (d->p >= d->end)
      TRUNCATED(d);
    int c = *d->p++;
    if (c != 0)
      return c;
  }
}

/* The payload of the marker segment at d->p; advances past it. */
static const uint8_t *segment(dec_t *d, int *len) {
  if (d->end - d->p < 2)
    TRUNCATED(d);
  int n = d->p[0] << 8 | d->p[1];
  if (n < 2)
    fail(d, "corrupt JPEG data: marker segment length %d", n);
  if (d->end - d->p < n)
    TRUNCATED(d);
  const uint8_t *s = d->p + 2;
  d->p += n;
  *len = n - 2;
  return s;
}

static void read_dqt(dec_t *d) {
  int len;
  const uint8_t *s = segment(d, &len), *e = s + len;
  while (s < e) {
    int pq = s[0] >> 4, tq = s[0] & 15, size = pq ? 128 : 64;
    if (pq > 1 || tq > 3)
      fail(d, "corrupt JPEG data: DQT table %d precision %d", tq, pq);
    if (e - s - 1 < size)
      fail(d, "corrupt JPEG data: DQT segment too short");
    for (int i = 0; i < 64; i++) {
      int v = pq ? (s[1 + 2 * i] << 8 | s[2 + 2 * i]) : s[1 + i];
      d->qt[tq][natural_order[i]] = (int16_t)v;
    }
    d->qdef[tq] = 1;
    s += 1 + size;
  }
}

static void read_dht(dec_t *d) {
  int len;
  const uint8_t *s = segment(d, &len), *e = s + len;
  while (s < e) {
    if (e - s < 17)
      fail(d, "corrupt JPEG data: DHT segment too short");
    int tc = s[0] >> 4, th = s[0] & 15, count = 0;
    if (tc > 1 || th > 3)
      fail(d, "corrupt JPEG data: DHT table class %d index %d", tc, th);
    const uint8_t *bits = s + 1;
    for (int i = 0; i < 16; i++)
      count += bits[i];
    if (count > 256 || e - s - 17 < count)
      fail(d, "corrupt JPEG data: bad Huffman table");
    const uint8_t *vals = s + 17;
    huff_t **slot = tc ? &d->ac[th] : &d->dc[th];
    if (!*slot)
      *slot = xcalloc(d, 1, sizeof(huff_t));
    huff_t *t = *slot;
    memset(t->lut, 0, sizeof(t->lut));
    t->max_symbol = -1;
    unsigned code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, k++, code++) {
        if (code >= (1u << l))
          fail(d, "corrupt JPEG data: bad Huffman table");
        unsigned lo = code << (16 - l), n = 1u << (16 - l);
        uint16_t entry = (uint16_t)(l << 8 | vals[k]);
        for (unsigned j = 0; j < n; j++)
          t->lut[lo + j] = entry;
        if (vals[k] > t->max_symbol)
          t->max_symbol = vals[k];
      }
      /* no code may be all ones (jdhuff.c's jpeg_make_d_derived_tbl) */
      if (code >= (1u << l))
        fail(d, "corrupt JPEG data: bad Huffman table");
      code <<= 1;
    }
    s += 17 + count;
  }
}

static void read_app(dec_t *d, int marker) {
  int len;
  const uint8_t *s = segment(d, &len);
  if (marker == 0xE0 && len >= 14 && !memcmp(s, "JFIF", 5))
    d->saw_jfif = 1;
  if (marker == 0xEE && len >= 12 && !memcmp(s, "Adobe", 5)) {
    d->saw_adobe = 1;
    d->adobe_transform = s[11];
  }
}

static int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }

static void read_sof(dec_t *d, int marker) {
  int len;
  const uint8_t *s = segment(d, &len);
  if (d->ncomp)
    fail(d, "corrupt JPEG data: a second frame header");
  if (len < 6)
    fail(d, "corrupt JPEG data: SOF segment too short");
  if (s[0] == 12)
    fail(d, "12-bit JPEGs are not supported (8-bit samples only)");
  if (s[0] != 8)
    fail(d, "corrupt JPEG data: sample precision %d", s[0]);
  d->height = s[1] << 8 | s[2];
  d->width = s[3] << 8 | s[4];
  int nf = s[5];
  if (d->height == 0)
    fail(d, "JPEGs whose height a DNL marker gives are not supported");
  if (d->width == 0)
    fail(d, "corrupt JPEG data: empty image");
  if ((unsigned long long)d->width * d->height > MAX_PIXELS)
    fail(d, "image of %d x %d pixels is above the %llu-pixel limit",
         d->width, d->height, MAX_PIXELS);
  if (nf == 4)
    fail(d, "4-component (CMYK/YCCK) JPEGs are not supported");
  if (nf != 1 && nf != 3)
    fail(d, "%d-component JPEGs are not supported (1 or 3)", nf);
  if (len < 6 + 3 * nf)
    fail(d, "corrupt JPEG data: SOF segment too short");
  d->progressive = marker == 0xC2;
  d->hmax = d->vmax = 1;
  for (int i = 0; i < nf; i++) {
    comp_t *c = &d->comp[i];
    c->id = s[6 + 3 * i];
    c->h = s[7 + 3 * i] >> 4;
    c->v = s[7 + 3 * i] & 15;
    c->tq = s[8 + 3 * i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
      fail(d, "corrupt JPEG data: component %d sampling %dx%d table %d",
           i, c->h, c->v, c->tq);
    if (c->h > d->hmax)
      d->hmax = c->h;
    if (c->v > d->vmax)
      d->vmax = c->v;
  }
  comp_t *c = d->comp;
  int ok = nf == 1 ? c[0].h == 1 && c[0].v == 1
           : c[1].h == 1 && c[1].v == 1 && c[2].h == 1 && c[2].v == 1 &&
                 ((c[0].h == 1 && c[0].v == 1) ||
                  (c[0].h == 2 && c[0].v == 1) ||
                  (c[0].h == 2 && c[0].v == 2));
  if (!ok) {
    if (nf == 1)
      fail(d, "sampling layout %dx%d on a gray JPEG is not supported "
              "(1x1)", c[0].h, c[0].v);
    fail(d, "sampling layout %dx%d,%dx%d,%dx%d is not supported (4:4:4, "
            "4:2:2, 4:2:0 and gray are)", c[0].h, c[0].v, c[1].h, c[1].v,
         c[2].h, c[2].v);
  }
  d->ncomp = nf;
  d->mcux = ceil_div(d->width, 8L * d->hmax);
  d->mcuy = ceil_div(d->height, 8L * d->vmax);
  for (int i = 0; i < nf; i++) {
    c = &d->comp[i];
    c->bw = ceil_div((long)d->width * c->h, 8L * d->hmax);
    c->bh = ceil_div((long)d->height * c->v, 8L * d->vmax);
    c->pbw = nf == 1 ? c->bw : d->mcux * c->h;
    c->pbh = nf == 1 ? c->bh : d->mcuy * c->v;
    c->dw = ceil_div((long)d->width * c->h, d->hmax);
    c->dh = ceil_div((long)d->height * c->v, d->vmax);
    for (int k = 0; k < 64; k++)
      c->coef_bits[k] = -1;
  }
}

/* -- entropy-coded data ------------------------------------------------- */

static void bits_reset(dec_t *d) {
  d->buf = 0;
  d->nbits = d->pad = d->hit_marker = 0;
}

/* Top the bit buffer up to at least 57 bits. FF 00 is an FF data byte
 * (FF FF ... 00 too, as libjpeg reads it); at a marker or the end of the
 * data, zero bits are appended and counted in d->pad, and consuming any
 * of them is an error. */
static void fill(dec_t *d) {
  while (d->nbits <= 56) {
    unsigned c = 0;
    if (d->hit_marker || d->hit_end) {
      d->pad += 8;
    } else if (d->p >= d->end) {
      d->hit_end = 1;
      d->pad += 8;
    } else if ((c = *d->p) != 0xFF) {
      d->p++;
    } else {
      const uint8_t *q = d->p + 1;
      while (q < d->end && *q == 0xFF)
        q++;
      if (q < d->end && *q == 0) {
        d->p = q + 1;
      } else {
        if (q >= d->end)
          d->hit_end = 1;
        else
          d->hit_marker = 1;
        c = 0;
        d->pad += 8;
      }
    }
    d->buf = d->buf << 8 | c;
    d->nbits += 8;
  }
}

static void consume(dec_t *d, int n) {
  if (d->nbits - n < d->pad) {
    if (d->hit_end)
      TRUNCATED(d);
    fail(d, "corrupt JPEG data: premature end of a scan's data");
  }
  d->nbits -= n;
}

static int get_bits(dec_t *d, int n) {
  if (!n)
    return 0;
  if (d->nbits < n)
    fill(d);
  int v = (int)((d->buf >> (d->nbits - n)) & ((1u << n) - 1));
  consume(d, n);
  return v;
}

static int decode_symbol(dec_t *d, const huff_t *t) {
  if (d->nbits < 16)
    fill(d);
  uint16_t e = t->lut[(d->buf >> (d->nbits - 16)) & 0xFFFF];
  if (!(e >> 8))
    fail(d, "corrupt JPEG data: bad Huffman code");
  consume(d, e >> 8);
  return e & 0xFF;
}

static int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)(-(1u << s) + 1) : r;
}

/* The RSTn marker that ends a restart interval, then fresh state. */
static void restart(dec_t *d, int *next_rst) {
  bits_reset(d);
  int m = next_marker(d);
  if (m != 0xD0 + *next_rst)
    fail(d, "corrupt JPEG data: expected RST%d, found marker 0x%02X",
         *next_rst, m);
  *next_rst = (*next_rst + 1) & 7;
  for (int i = 0; i < d->ncomp; i++)
    d->comp[i].dc_pred = 0;
  d->eobrun = 0;
}

static int16_t *block_at(comp_t *c, int by, int bx) {
  return c->coef + ((size_t)by * c->pbw + bx) * 64;
}

static void decode_sequential(dec_t *d, int16_t *blk, comp_t *c,
                              const huff_t *dc, const huff_t *ac) {
  int s = decode_symbol(d, dc);
  if (s)
    s = extend(get_bits(d, s), s);
  c->dc_pred = (int)((unsigned)c->dc_pred + (unsigned)s);
  blk[0] = (int16_t)c->dc_pred;
  for (int k = 1; k < 64; k++) {
    s = decode_symbol(d, ac);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      blk[natural_order[k]] = (int16_t)extend(get_bits(d, s), s);
    } else {
      if (r != 15)
        break;
      k += 15;
    }
  }
}

static void decode_dc_first(dec_t *d, int16_t *blk, comp_t *c,
                            const huff_t *dc, int al) {
  int s = decode_symbol(d, dc);
  if (s)
    s = extend(get_bits(d, s), s);
  c->dc_pred = (int)((unsigned)c->dc_pred + (unsigned)s);
  blk[0] = (int16_t)((unsigned)c->dc_pred << al);
}

static void decode_ac_first(dec_t *d, int16_t *blk, const huff_t *ac,
                            int ss, int se, int al) {
  if (d->eobrun > 0) {
    d->eobrun--;
    return;
  }
  for (int k = ss; k <= se; k++) {
    int s = decode_symbol(d, ac), r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      blk[natural_order[k]] =
          (int16_t)((unsigned)extend(get_bits(d, s), s) << al);
    } else if (r == 15) {
      k += 15;
    } else {
      d->eobrun = (1 << r) + get_bits(d, r) - 1;
      break;
    }
  }
}

static void refine_coef(dec_t *d, int16_t *coef, int p1, int m1) {
  if (get_bits(d, 1) && !(*coef & p1))
    *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
}

static void decode_ac_refine(dec_t *d, int16_t *blk, const huff_t *ac,
                             int ss, int se, int al) {
  int p1 = 1 << al, m1 = -(1 << al), k = ss;
  if (d->eobrun == 0) {
    for (; k <= se; k++) {
      int s = decode_symbol(d, ac), r = s >> 4;
      s &= 15;
      if (s) {
        s = get_bits(d, 1) ? p1 : m1; /* a newly nonzero coefficient */
      } else if (r != 15) {
        d->eobrun = (1 << r) + get_bits(d, r);
        break;
      }
      /* pass r zero coefficients, refining the nonzero ones on the way */
      do {
        int16_t *coef = blk + natural_order[k];
        if (*coef)
          refine_coef(d, coef, p1, m1);
        else if (--r < 0)
          break;
        k++;
      } while (k <= se);
      if (s)
        blk[natural_order[k]] = (int16_t)s;
    }
  }
  if (d->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t *coef = blk + natural_order[k];
      if (*coef)
        refine_coef(d, coef, p1, m1);
    }
    d->eobrun--;
  }
}

static void read_scan(dec_t *d) {
  int len;
  const uint8_t *s = segment(d, &len);
  if (!d->ncomp)
    fail(d, "corrupt JPEG data: a scan before the frame header");
  int ns = len ? s[0] : 0;
  if (ns < 1 || ns > d->ncomp || len != 4 + 2 * ns)
    fail(d, "corrupt JPEG data: bad scan header");
  comp_t *sc[3];
  const huff_t *dct[3], *act[3];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], td = s[2 + 2 * i] >> 4, ta = s[2 + 2 * i] & 15;
    sc[i] = NULL;
    for (int j = 0; j < d->ncomp; j++)
      if (d->comp[j].id == id)
        sc[i] = &d->comp[j];
    for (int j = 0; j < i; j++)
      if (sc[j] == sc[i])
        sc[i] = NULL;
    if (!sc[i] || td > 3 || ta > 3)
      fail(d, "corrupt JPEG data: bad scan component %d", id);
    dct[i] = d->dc[td];
    act[i] = d->ac[ta];
  }
  const uint8_t *t = s + 1 + 2 * ns;
  int ss = t[0], se = t[1], ah = t[2] >> 4, al = t[2] & 15;
  int dc_scan = !d->progressive || ss == 0;
  if (d->progressive) {
    int bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah && al != ah - 1) || al > 13 || bad)
      fail(d, "corrupt JPEG data: bad progressive scan (Ss %d Se %d Ah %d "
              "Al %d)", ss, se, ah, al);
  } else {
    ss = 0, se = 63, ah = al = 0;
  }
  for (int i = 0; i < ns; i++) {
    comp_t *c = sc[i];
    int need_dc = dc_scan && !(d->progressive && ah);
    int need_ac = !d->progressive || ss > 0;
    if ((need_dc && !dct[i]) || (need_ac && !act[i]))
      fail(d, "corrupt JPEG data: a scan uses an undefined Huffman table");
    if (need_dc && dct[i]->max_symbol > 15)
      fail(d, "corrupt JPEG data: bad Huffman table");
    if (!c->latched) {
      if (!d->qdef[c->tq])
        fail(d, "corrupt JPEG data: undefined quantization table %d", c->tq);
      memcpy(c->q, d->qt[c->tq], sizeof(c->q));
      c->latched = 1;
    }
    if (!c->coef)
      c->coef = xcalloc(d, (size_t)c->pbw * c->pbh * 64, sizeof(int16_t));
    for (int k = ss; k <= se; k++)
      c->coef_bits[k] = al;
    c->dc_pred = 0;
  }
  d->eobrun = 0;
  bits_reset(d);
  d->scans++;

  /* MCUs: interleaved scans walk the padded MCU grid; a scan of one
   * component walks its own blocks, one block an MCU */
  long mcus_x = ns > 1 ? d->mcux : sc[0]->bw;
  long mcus_y = ns > 1 ? d->mcuy : sc[0]->bh;
  long total = mcus_x * mcus_y, left = d->restart_interval;
  int next_rst = 0;
  for (long m = 0; m < total; m++) {
    if (d->restart_interval && left == 0) {
      restart(d, &next_rst);
      left = d->restart_interval;
    }
    left--;
    int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
    for (int i = 0; i < ns; i++) {
      comp_t *c = sc[i];
      int bh = ns > 1 ? c->v : 1, bw = ns > 1 ? c->h : 1;
      for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
          int16_t *blk = ns > 1 ? block_at(c, my * c->v + y, mx * c->h + x)
                                : block_at(c, my, mx);
          if (!d->progressive)
            decode_sequential(d, blk, c, dct[i], act[i]);
          else if (ss == 0 && ah == 0)
            decode_dc_first(d, blk, c, dct[i], al);
          else if (ss == 0)
            blk[0] = (int16_t)(blk[0] | (get_bits(d, 1) << al));
          else if (ah == 0)
            decode_ac_first(d, blk, act[i], ss, se, al);
          else
            decode_ac_refine(d, blk, act[i], ss, se, al);
        }
    }
  }
  bits_reset(d);
}

/* -- samples ------------------------------------------------------------ */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* jdmaster.c's post-IDCT range limit, indexed by x & 1023 (RANGE_MASK):
 * the 10-bit wrap of x + 128, clamped to 0..255. */
static uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  v = (v >= 512 ? v - 1024 : v) + 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* The odd part and final butterflies of one 1-D pass of
 * jpeg_idct_islow; in[] holds the 8 inputs, out[] gets the 8 sums
 * before descaling. */
static void idct_1d(const int64_t in[8], int64_t out[8]) {
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  int64_t tmp0 = (int64_t)((uint64_t)(in[0] + in[4]) << CONST_BITS);
  int64_t tmp1 = (int64_t)((uint64_t)(in[0] - in[4]) << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = in[7], tmp1 = in[5], tmp2 = in[3], tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3, out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2, out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1, out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0, out[4] = tmp13 - tmp0;
}

/* jidctint.c's jpeg_idct_islow of one dequantized block into out[]
 * (row stride `stride`). */
static void idct_islow(const int16_t *blk, const int16_t *q, uint8_t *out,
                       size_t stride) {
  int32_t ws[64];
  int64_t in[8], o[8];
  for (int c = 0; c < 8; c++) { /* columns */
    int ac = 0;
    for (int r = 1; r < 8; r++)
      ac |= blk[8 * r + c];
    if (!ac) {
      int32_t dc = (int32_t)((uint32_t)(blk[c] * q[c]) << PASS1_BITS);
      for (int r = 0; r < 8; r++)
        ws[8 * r + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; r++)
      in[r] = (int64_t)blk[8 * r + c] * q[8 * r + c];
    idct_1d(in, o);
    for (int r = 0; r < 8; r++)
      ws[8 * r + c] = (int32_t)DESCALE(o[r], CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) { /* rows */
    const int32_t *w = ws + 8 * r;
    uint8_t *dst = out + r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t v = idct_limit(DESCALE((int64_t)w[0], PASS1_BITS + 3));
      memset(dst, v, 8);
      continue;
    }
    for (int i = 0; i < 8; i++)
      in[i] = w[i];
    idct_1d(in, o);
    for (int i = 0; i < 8; i++)
      dst[i] = idct_limit(DESCALE(o[i], CONST_BITS + PASS1_BITS + 3));
  }
}

/* The component's plane upsampled by (hr, vr) in {1, 2}^2, as jdsample.c:
 * the triangle filters where libjpeg uses them (h2v1 and h2v2 with more
 * than 2 samples a row; the edges repeat the last real sample and row),
 * plain replication otherwise. The result is hr * dw wide and vr * dh
 * tall, in c->full (stride hr * bw * 8). */
static void upsample(dec_t *d, comp_t *c, int hr, int vr) {
  size_t istride = (size_t)c->bw * 8, ostride = istride * hr;
  c->full = xcalloc(d, ostride * (size_t)c->dh * vr, 1);
  int fancy = c->dw > 2, dw = c->dw;
  int *sum = d->scratch = xcalloc(d, (size_t)dw, sizeof(int));
  for (int oy = 0; oy < c->dh * vr; oy++) {
    const uint8_t *near = c->plane + (size_t)(oy / vr) * istride;
    uint8_t *out = c->full + (size_t)oy * ostride;
    if (!fancy) {
      for (int x = 0; x < dw * hr; x++)
        out[x] = near[x / hr];
    } else if (vr == 1) { /* h2v1_fancy_upsample */
      for (int i = 0; i < dw; i++) {
        int v = near[i] * 3, l = near[i ? i - 1 : 0];
        int r = near[i < dw - 1 ? i + 1 : dw - 1];
        out[2 * i] = (uint8_t)((v + l + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((v + r + 2) >> 2);
      }
    } else { /* h2v2_fancy_upsample */
      int iy = oy / 2, fy = oy & 1 ? iy + 1 : iy - 1;
      fy = fy < 0 ? 0 : fy > c->dh - 1 ? c->dh - 1 : fy;
      const uint8_t *far = c->plane + (size_t)fy * istride;
      for (int i = 0; i < dw; i++)
        sum[i] = near[i] * 3 + far[i];
      for (int i = 0; i < dw; i++) {
        int v = sum[i] * 3, l = sum[i ? i - 1 : 0];
        int r = sum[i < dw - 1 ? i + 1 : dw - 1];
        out[2 * i] = (uint8_t)((v + l + 8) >> 4);
        out[2 * i + 1] = (uint8_t)((v + r + 7) >> 4);
      }
    }
  }
  free(sum);
  d->scratch = NULL;
}

static uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* jdcolor.c's ycc_rgb_convert tables (SCALEBITS 16) */
#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static void output(dec_t *d, uint8_t *out) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -FIX(0.71414) * x;
    cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
  }
  const uint8_t *rows[3];
  size_t strides[3];
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    size_t stride = (size_t)c->bw * 8;
    c->plane = xcalloc(d, stride * c->bh * 8, 1);
    if (!c->coef)
      c->coef = xcalloc(d, (size_t)c->pbw * c->pbh * 64, sizeof(int16_t));
    for (int by = 0; by < c->bh; by++)
      for (int bx = 0; bx < c->bw; bx++)
        idct_islow(block_at(c, by, bx), c->q,
                   c->plane + (size_t)by * 8 * stride + bx * 8, stride);
    int hr = d->hmax / c->h, vr = d->vmax / c->v;
    if (hr == 1 && vr == 1) {
      rows[i] = c->plane;
      strides[i] = stride;
    } else {
      upsample(d, c, hr, vr);
      rows[i] = c->full;
      strides[i] = stride * hr;
    }
  }
  int rgb = d->ncomp == 3 &&
            (d->saw_jfif ? 0
             : d->saw_adobe
                 ? d->adobe_transform == 0
                 : d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                       d->comp[2].id == 'B');
  size_t w = (size_t)d->width;
  for (int y = 0; y < d->height; y++) {
    uint8_t *o = out + (size_t)y * w * d->ncomp;
    const uint8_t *a = rows[0] + y * strides[0];
    if (d->ncomp == 1) {
      memcpy(o, a, w);
      continue;
    }
    const uint8_t *b = rows[1] + y * strides[1], *c = rows[2] + y * strides[2];
    for (size_t x = 0; x < w; x++, o += 3) {
      if (rgb) {
        o[0] = a[x], o[1] = b[x], o[2] = c[x];
        continue;
      }
      int yy = a[x], cb = b[x], cr = c[x];
      o[0] = clamp255(yy + cr_r[cr]);
      o[1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      o[2] = clamp255(yy + cb_b[cb]);
    }
  }
}

/* -- entry points -------------------------------------------------------- */

static void release(dec_t *d) {
  free(d->scratch);
  for (int i = 0; i < 3; i++) {
    free(d->comp[i].coef);
    free(d->comp[i].plane);
    free(d->comp[i].full);
  }
  for (int i = 0; i < 4; i++) {
    free(d->dc[i]);
    free(d->ac[i]);
  }
}

/* Walk the markers; stop after the frame header when `out` is NULL. */
static void run(dec_t *d, uint8_t *out, size_t cap) {
  if (d->end - d->p < 2 || d->p[0] != 0xFF || d->p[1] != 0xD8)
    fail(d, "not a JPEG file (no SOI marker)");
  d->p += 2;
  for (;;) {
    int m = next_marker(d);
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(d, m);
      if (!out)
        return;
    } else if (m == 0xC3) {
      fail(d, "lossless JPEGs (SOF3) are not supported");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xDE ||
               m == 0xDF) {
      fail(d, "hierarchical JPEGs (SOF%d) are not supported", m - 0xC0);
    } else if (m >= 0xC9 && m <= 0xCF) { /* SOF9-11, SOF13-15, DAC */
      fail(d, "arithmetic-coded JPEGs are not supported (Huffman only)");
    } else if (m == 0xC4) {
      read_dht(d);
    } else if (m == 0xDB) {
      read_dqt(d);
    } else if (m == 0xDD) {
      int len;
      const uint8_t *s = segment(d, &len);
      if (len < 2)
        fail(d, "corrupt JPEG data: DRI segment too short");
      d->restart_interval = s[0] << 8 | s[1];
    } else if (m == 0xDA) {
      if (!out)
        fail(d, "corrupt JPEG data: a scan before the frame header");
      read_scan(d);
    } else if (m == 0xD9) {
      break;
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      read_app(d, m); /* APPn, COM; a DNL after the first scan */
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      continue; /* a stray RSTn or TEM has no payload */
    } else {
      fail(d, "corrupt JPEG data: unknown marker 0x%02X", m);
    }
  }
  if (!d->ncomp)
    fail(d, "corrupt JPEG data: no frame header");
  if (!d->scans)
    fail(d, "corrupt JPEG data: no scans");
  if (d->progressive)
    for (int i = 0; i < d->ncomp; i++)
      for (int k = 0; k < 64; k++)
        if (d->comp[i].coef_bits[k] != 0)
          fail(d, "progressive JPEGs whose scans leave coefficients "
                  "unrefined are not supported (libjpeg smooths them)");
  for (int i = 0; i < d->ncomp; i++)
    if (!d->comp[i].latched)
      fail(d, "corrupt JPEG data: component %d is in no scan", i);
  if (cap < (size_t)d->width * d->height * d->ncomp)
    fail(d, "output buffer of %zu bytes is too small", cap);
  output(d, out);
}

static int start(dec_t *d, const uint8_t *data, size_t n, uint8_t *out,
                 size_t cap, char *err, size_t errcap) {
  memset(d, 0, sizeof(*d));
  d->p = data;
  d->end = data + n;
  d->err = err;
  d->errcap = errcap;
  if (errcap)
    err[0] = 0;
  if (setjmp(d->jb)) {
    release(d);
    return -1;
  }
  run(d, out, cap);
  release(d);
  return 0;
}

/* Width, height and components (1 or 3) from the frame header; refuses
 * what nerfsr_jpeg_decode refuses at the frame header. */
int nerfsr_jpeg_header(const uint8_t *data, size_t n, int32_t *whc,
                       char *err, size_t errcap) {
  dec_t *d = calloc(1, sizeof(dec_t));
  if (!d) {
    snprintf(err, errcap, "out of memory");
    return -1;
  }
  int rc = start(d, data, n, NULL, 0, err, errcap);
  if (rc == 0 && !d->ncomp) {
    snprintf(err, errcap, "corrupt JPEG data: no frame header");
    rc = -1;
  }
  whc[0] = d->width, whc[1] = d->height, whc[2] = d->ncomp;
  free(d);
  return rc;
}

/* The pixels, (height, width, components) uint8 row-major, into out. */
int nerfsr_jpeg_decode(const uint8_t *data, size_t n, uint8_t *out,
                       size_t cap, char *err, size_t errcap) {
  dec_t *d = calloc(1, sizeof(dec_t));
  if (!d) {
    snprintf(err, errcap, "out of memory");
    return -1;
  }
  int rc = start(d, data, n, out, cap, err, errcap);
  free(d);
  return rc;
}
