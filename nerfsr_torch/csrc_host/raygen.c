/* Host-side ray builder of the LLFF dataset, with a plain C interface for
 * ctypes (nerfsr_torch/utils/raygen.py).
 *
 * The counterpart of the JAX package's nerfsr_tpu/native/raygen.cpp
 * (build_rays): for each pose of a stack, every pixel's camera-space
 * direction (with the pixel-centre offset), rotated by the 3x4
 * camera-to-world matrix and normalised, with the camera centre as its
 * origin; optionally warped into normalised device coordinates in the
 * C++'s statement order (ndc_warp). Images are shared out among threads
 * (pthreads) as the C++ does: thread t takes images t, t + T, ...
 *
 * The library is built with -ffp-contract=off, so no multiply and add is
 * fused: the JAX package's library is built with -march=native, where GCC
 * may fuse them, so the two agree to rounding, not bit for bit.
 */

#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <unistd.h>

struct raygen_job {
    const float *c2w;
    int n_img, h, w;
    float focal, pixel_center, ndc_near;
    int apply_ndc, stride, first;
    float *origins, *dirs;
};

static void ndc_warp(int h, int w, float focal, float near, float ox,
                     float oy, float oz, float dx, float dy, float dz,
                     float *o_out, float *d_out) {
    float t = -(near + oz) / dz;
    ox += t * dx;
    oy += t * dy;
    oz += t * dz;
    float ox_oz = ox / oz;
    float oy_oz = oy / oz;
    float sx = -1.0f / (w / (2.0f * focal));
    float sy = -1.0f / (h / (2.0f * focal));
    float o2 = 1.0f + 2.0f * near / oz;
    o_out[0] = sx * ox_oz;
    o_out[1] = sy * oy_oz;
    o_out[2] = o2;
    d_out[0] = sx * (dx / dz - ox_oz);
    d_out[1] = sy * (dy / dz - oy_oz);
    d_out[2] = 1.0f - o2;
}

static void image_rays(const struct raygen_job *job, int img) {
    const float *m = job->c2w + (int64_t)img * 12;
    const int h = job->h, w = job->w;
    const float cx = m[3], cy = m[7], cz = m[11];
    const float half_w = w / 2.0f, half_h = h / 2.0f;
    float *o_img = job->origins + (int64_t)img * h * w * 3;
    float *d_img = job->dirs + (int64_t)img * h * w * 3;
    for (int j = 0; j < h; ++j) {
        for (int i = 0; i < w; ++i) {
            const float c0 = ((float)i + job->pixel_center - half_w) /
                             job->focal;
            const float c1 = -(((float)j + job->pixel_center - half_h) /
                               job->focal);
            const float c2 = -1.0f;
            float d0 = m[0] * c0 + m[1] * c1 + m[2] * c2;
            float d1 = m[4] * c0 + m[5] * c1 + m[6] * c2;
            float d2 = m[8] * c0 + m[9] * c1 + m[10] * c2;
            const float inv = 1.0f / sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
            d0 *= inv;
            d1 *= inv;
            d2 *= inv;
            const int64_t off = ((int64_t)j * w + i) * 3;
            if (job->apply_ndc) {
                ndc_warp(h, w, job->focal, job->ndc_near, cx, cy, cz, d0, d1,
                         d2, o_img + off, d_img + off);
            } else {
                o_img[off + 0] = cx;
                o_img[off + 1] = cy;
                o_img[off + 2] = cz;
                d_img[off + 0] = d0;
                d_img[off + 1] = d1;
                d_img[off + 2] = d2;
            }
        }
    }
}

static void *raygen_worker(void *arg) {
    const struct raygen_job *job = arg;
    for (int img = job->first; img < job->n_img; img += job->stride)
        image_rays(job, img);
    return NULL;
}

/* c2w: (n_img, 3, 4) row-major f32. origins, dirs: (n_img, h, w, 3) f32,
 * written. apply_ndc 1: NDC with the near plane ndc_near. n_threads <= 0:
 * one thread a core. Returns 0, or -1 when out of memory. */
int nerfsr_build_rays(const float *c2w, int n_img, int h, int w, float focal,
                      int use_pixel_centers, int apply_ndc, float ndc_near,
                      float *origins, float *dirs, int n_threads) {
    if (n_threads < 1) {
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        n_threads = cores < 1 ? 1 : (int)cores;
    }
    if (n_threads > n_img) n_threads = n_img < 1 ? 1 : n_img;
    struct raygen_job *jobs = calloc((size_t)n_threads, sizeof *jobs);
    pthread_t *threads = calloc((size_t)n_threads, sizeof *threads);
    if (jobs == NULL || threads == NULL) {
        free(jobs);
        free(threads);
        return -1;
    }
    for (int t = 0; t < n_threads; ++t)
        jobs[t] = (struct raygen_job){
            c2w, n_img, h, w, focal, use_pixel_centers ? 0.5f : 0.0f,
            ndc_near, apply_ndc, n_threads, t, origins, dirs};
    /* thread 0's images run on the caller's thread below */
    int started = 1;
    while (started < n_threads &&
           pthread_create(&threads[started], NULL, raygen_worker,
                          &jobs[started]) == 0)
        ++started;
    raygen_worker(&jobs[0]);
    for (int t = 1; t < started; ++t) pthread_join(threads[t], NULL);
    /* images of threads that did not start, on this thread */
    for (int t = started; t < n_threads; ++t) raygen_worker(&jobs[t]);
    free(jobs);
    free(threads);
    return 0;
}
