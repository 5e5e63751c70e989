/* Polygon ROI rasterization on the host.
 *
 * The port's own copy of the JAX package's C rasterizer
 * (thz_image_explorer_tpu/native/thznative.c, thz_polygon_mask and
 * point_in_polygon_u64), itself the reference's average_polygon_roi
 * (math_tools.rs:574-661): the Rust release build's wrapping u64
 * arithmetic, the x/y swap and the vertical flip. Built with the system C
 * compiler at first use (kernels.py) and called through ctypes by
 * ops/roi.polygon_mask; ops/roi.polygon_mask_plain is the same rule in
 * Python.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Ray cast with u64 wrap-around semantics (math_tools.rs:574-591). */
static int point_in_polygon_u64(uint64_t x, uint64_t y, const uint64_t *px,
                                const uint64_t *py, size_t n) {
    int inside = 0;
    size_t j = n - 1;
    for (size_t i = 0; i < n; i++) {
        uint64_t xi = px[i], yi = py[i];
        uint64_t xj = px[j], yj = py[j];
        if ((yi > y) != (yj > y)) {
            /* every operation wraps mod 2^64, as Rust's release usize */
            uint64_t den = yj - yi; /* nonzero: the edge crosses y */
            uint64_t t = (xj - xi) * (y - yi);
            uint64_t val = t / den + xi;
            if (x < val)
                inside = !inside;
        }
        j = i;
    }
    return inside;
}

/* The ROI mask over the data grid.
 *
 * poly_x / poly_y hold the vertices already wrapped to u64; each is divided
 * by `scaling` (integer division, math_tools.rs:604-609), and a scaling of
 * 0 gives an empty mask. The reference indexes data[y_size - y - 1, x]
 * with y_size = shape0 and x_size = shape1 (math_tools.rs:611-648), so
 * mask (shape0 x shape1, C order, zeroed here) gets a 1 at
 * [(y_size - 1 - y) * shape1 + x] for every (x, y) of the polygon's
 * bounding box, clamped to the grid, that the ray cast puts inside.
 *
 * Returns the number of pixels set, or -1 when memory runs out.
 */
long long thz_roi_polygon_mask(const uint64_t *poly_x, const uint64_t *poly_y,
                               size_t n_vertices, size_t shape0, size_t shape1,
                               uint64_t scaling, uint8_t *mask) {
    if (shape0 == 0 || shape1 == 0)
        return 0;
    memset(mask, 0, shape0 * shape1);
    if (n_vertices == 0 || scaling == 0)
        return 0;
    uint64_t *px = (uint64_t *)malloc(n_vertices * sizeof(uint64_t));
    uint64_t *py = (uint64_t *)malloc(n_vertices * sizeof(uint64_t));
    if (!px || !py) {
        free(px);
        free(py);
        return -1;
    }
    uint64_t x_min = UINT64_MAX, y_min = UINT64_MAX, x_max = 0, y_max = 0;
    for (size_t i = 0; i < n_vertices; i++) {
        px[i] = poly_x[i] / scaling;
        py[i] = poly_y[i] / scaling;
        if (px[i] < x_min) x_min = px[i];
        if (py[i] < y_min) y_min = py[i];
        if (px[i] > x_max) x_max = px[i];
        if (py[i] > y_max) y_max = py[i];
    }
    uint64_t x_size = shape1, y_size = shape0;
    /* clamp to the grid (math_tools.rs:633-637) */
    if (x_min > x_size - 1) x_min = x_size - 1;
    if (y_min > y_size - 1) y_min = y_size - 1;
    if (x_max > x_size - 1) x_max = x_size - 1;
    if (y_max > y_size - 1) y_max = y_size - 1;
    long long count = 0;
    for (uint64_t y = y_min; y <= y_max; y++) {
        for (uint64_t x = x_min; x <= x_max; x++) {
            if (point_in_polygon_u64(x, y, px, py, n_vertices)) {
                mask[(y_size - 1 - y) * shape1 + x] = 1;
                count++;
            }
        }
    }
    free(px);
    free(py);
    return count;
}
