/* PIL's Lanczos resize of 8-bit images, with a plain C interface for
 * ctypes (nerfsr_torch/data/downx_common.py:lanczos_resize).
 *
 * The counterpart of Pillow's libImaging/Resample.c for 8 bits a channel
 * (Image.resize(size, Image.LANCZOS) of an L or RGB image, and of the
 * premultiplied La / RGBa that PIL resizes LA and RGBA through; the
 * premultiplication stays in Python):
 *   - precompute_coeffs: for each output pixel, the window of source
 *     pixels within the Lanczos support of 3 x max(scale, 1) around its
 *     centre and their filter values, in double, each divided by their
 *     sum;
 *   - normalize_coeffs_8bpc: each rounded to fixed point of
 *     PRECISION_BITS (22) fractional bits, half away from zero;
 *   - the horizontal pass first, over only the source rows the vertical
 *     pass reads (as ImagingResampleInner bounds it), then the vertical
 *     pass; each sums in integers from half a unit and clips to uint8, so
 *     the vertical pass reads the clipped horizontal result.
 * Channels (1-4, interleaved) are filtered alike and apart. The library
 * is built with -ffp-contract=off: a fused multiply-add in the
 * coefficients could move one by a unit and change bytes.
 *
 * Bound: the horizontal pass's multiply-adds, rows x out_w x taps x
 * channels (about 224 M for 4032x3024 RGB -> 504x378).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

#define PRECISION_BITS (32 - 8 - 2)
#define LANCZOS_SUPPORT 3.0

static double sinc_filter(double x) {
    if (x == 0.0) return 1.0;
    x = x * M_PI;
    return sin(x) / x;
}

static double lanczos_filter(double x) {
    /* truncated sinc */
    if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
    return 0.0;
}

/* bounds (out_size x 2: first source index, count) and fixed-point
 * coefficients (out_size x ksize, zero past each window); returns ksize,
 * or 0 when out of memory. */
static int coeffs(int in_size, int out_size, int **boundsp, int32_t **kkp) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = LANCZOS_SUPPORT * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;
    double *pre = malloc((size_t)out_size * ksize * sizeof *pre);
    int *bounds = malloc((size_t)out_size * 2 * sizeof *bounds);
    int32_t *kk = malloc((size_t)out_size * ksize * sizeof *kk);
    if (pre == NULL || bounds == NULL || kk == NULL) {
        free(pre);
        free(bounds);
        free(kk);
        return 0;
    }
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double *k = &pre[(size_t)xx * ksize];
        int x;
        for (x = 0; x < xmax; x++) {
            double w = lanczos_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        for (; x < ksize; x++) k[x] = 0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    for (size_t i = 0; i < (size_t)out_size * ksize; i++)
        kk[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << PRECISION_BITS))
                           : (int32_t)(0.5 + pre[i] * (1 << PRECISION_BITS));
    free(pre);
    *boundsp = bounds;
    *kkp = kk;
    return ksize;
}

static inline uint8_t clip8(int in) {
    int v = in >> PRECISION_BITS;
    return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v;
}

/* rows [row0, row0 + rows) of src (in_w x C a row) -> dst (out_w x C a
 * row), C a compile-time constant after inlining */
static inline __attribute__((always_inline)) void horizontal(
    const uint8_t *src, int in_w, uint8_t *dst, int out_w, int row0, int rows,
    const int *bounds, const int32_t *kk, int ksize, const int C) {
    for (int yy = 0; yy < rows; yy++) {
        const uint8_t *in = src + (size_t)(row0 + yy) * in_w * C;
        uint8_t *out = dst + (size_t)yy * out_w * C;
        for (int xx = 0; xx < out_w; xx++) {
            const int xmin = bounds[xx * 2 + 0], xmax = bounds[xx * 2 + 1];
            const int32_t *k = &kk[(size_t)xx * ksize];
            int ss[4] = {1 << (PRECISION_BITS - 1), 1 << (PRECISION_BITS - 1),
                         1 << (PRECISION_BITS - 1),
                         1 << (PRECISION_BITS - 1)};
            const uint8_t *p = in + (size_t)xmin * C;
            for (int x = 0; x < xmax; x++)
                for (int c = 0; c < C; c++) ss[c] += p[x * C + c] * k[x];
            for (int c = 0; c < C; c++) out[xx * C + c] = clip8(ss[c]);
        }
    }
}

/* src (in_h rows of `width` bytes) -> dst (out_h rows): each output row
 * sums its window's rows byte by byte (integer sums: the order does not
 * change them) */
static int vertical(const uint8_t *src, uint8_t *dst, int width, int out_h,
                    const int *bounds, const int32_t *kk, int ksize) {
    int *ss = malloc((size_t)width * sizeof *ss);
    if (ss == NULL) return -1;
    for (int yy = 0; yy < out_h; yy++) {
        const int ymin = bounds[yy * 2 + 0], ymax = bounds[yy * 2 + 1];
        const int32_t *k = &kk[(size_t)yy * ksize];
        for (int i = 0; i < width; i++) ss[i] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) {
            const uint8_t *in = src + (size_t)(y + ymin) * width;
            const int32_t ky = k[y];
            for (int i = 0; i < width; i++) ss[i] += in[i] * ky;
        }
        uint8_t *out = dst + (size_t)yy * width;
        for (int i = 0; i < width; i++) out[i] = clip8(ss[i]);
    }
    free(ss);
    return 0;
}

/* src (in_h, in_w, channels) uint8 -> dst (out_h, out_w, channels),
 * channels 1-4. Returns 0, -1 when out of memory, -2 on bad sizes. */
int nerfsr_lanczos_resize(const uint8_t *src, int in_w, int in_h,
                          int channels, uint8_t *dst, int out_w, int out_h) {
    if (in_w < 1 || in_h < 1 || out_w < 1 || out_h < 1 || channels < 1 ||
        channels > 4)
        return -2;
    const int C = channels;
    int *bh = NULL, *bv = NULL;
    int32_t *kh = NULL, *kv = NULL;
    const int ksh = coeffs(in_w, out_w, &bh, &kh);
    const int ksv = coeffs(in_h, out_h, &bv, &kv);
    int rc = -1;
    uint8_t *tmp = NULL;
    if (ksh == 0 || ksv == 0) goto done;
    const int need_h = out_w != in_w, need_v = out_h != in_h;
    /* the source rows the vertical pass reads */
    const int first = bv[0];
    const int last = bv[out_h * 2 - 2] + bv[out_h * 2 - 1];
    const uint8_t *mid = src;
    if (need_h) {
        uint8_t *hout = dst;
        if (need_v) {
            tmp = malloc((size_t)(last - first) * out_w * C);
            if (tmp == NULL) goto done;
            hout = tmp;
            for (int i = 0; i < out_h; i++) bv[i * 2] -= first;
        }
        const int r0 = need_v ? first : 0, rows = need_v ? last - first : in_h;
        switch (C) {
        case 1: horizontal(src, in_w, hout, out_w, r0, rows, bh, kh, ksh, 1);
                break;
        case 2: horizontal(src, in_w, hout, out_w, r0, rows, bh, kh, ksh, 2);
                break;
        case 3: horizontal(src, in_w, hout, out_w, r0, rows, bh, kh, ksh, 3);
                break;
        default: horizontal(src, in_w, hout, out_w, r0, rows, bh, kh, ksh, 4);
        }
        mid = hout;
    }
    if (need_v)
        rc = vertical(mid, dst, out_w * C, out_h, bv, kv, ksv);
    else if (need_h)
        rc = 0;
    else {
        memcpy(dst, src, (size_t)in_h * in_w * C);
        rc = 0;
    }
done:
    free(tmp);
    free(bh);
    free(bv);
    free(kh);
    free(kv);
    return rc;
}
