"""Python mirrors of the browser-side pure functions.

The port's own copy of ``thz_image_explorer_tpu/viz/jslogic.py`` (host
numpy, the same values bit for bit).

No JS engine exists in the build/test environment, so the small amount of
logic that must live in the browser (click geometry, the ROI auto-close
rule, gauge value mapping) is mirrored here 1:1 and pinned by
``tests/test_jslogic.py`` (and, for this copy,
``tests/test_torch_viz_utils.py``): the tests (a) exercise these mirrors on edge
cases and (b) assert the embedded JS source in
:mod:`thz_image_explorer_tpu_torch.web` contains the exact same constants and
formulas, so the two cannot drift silently.

References: ``matrix_plot.rs:569-637`` (5%-close rule, click mapping with
the vertical flip), ``gauge_widget.rs:15-209`` (arc −45°..150°, log ticks).
"""

from __future__ import annotations

import math

#: auto-close tolerance as a fraction of the SMALLER image dimension
#: (matrix_plot.rs:594: ``width.min(height) * 0.05``)
ROI_CLOSE_FRACTION = 0.05

#: gauge arc span in degrees (gauge_widget.rs)
GAUGE_A0 = -45.0
GAUGE_A1 = 150.0


def roi_click_closes(
    first_vertex: tuple[float, float],
    click: tuple[float, float],
    image_shape: tuple[int, int],
    n_vertices: int = 3,
) -> bool:
    """True when a shift-click closes the polygon draft: MORE THAN ONE
    vertex drafted and the click within 5% of the SMALLER image dimension
    of the FIRST vertex (``matrix_plot.rs:594``: ``dist <
    width.min(height) * 0.05 && polygon.len() > 1``; JS:
    ``Math.hypot(fx-x, fy-y) < 0.05*Math.min(...)``)."""
    if n_vertices <= 1:
        return False
    tol = ROI_CLOSE_FRACTION * min(image_shape[0], image_shape[1])
    return math.hypot(first_vertex[0] - click[0], first_vertex[1] - click[1]) < tol


def display_to_plot(
    client_x: float, client_y: float, img_scale: float, image_h: int
) -> tuple[int, int]:
    """Canvas click -> reference PLOT coordinates, the system ROI polygon
    vertices live in (``matrix_plot.rs:585`` pushes raw ``[plot_x,
    plot_y]``): the canvas shows ``screen[(r, c)] = data[(r, c)]`` (see
    :func:`~thz_image_explorer_tpu_torch.viz.colormap.intensity_image_rgba`), and
    egui's plot y axis points up, so plot x = column and plot y =
    vertically flipped row. ``image_h`` is the canvas pixel height = the
    data width (x size)."""
    x = math.floor(client_x / img_scale)
    y = image_h - 1 - math.floor(client_y / img_scale)
    return x, y


def display_to_pixel(
    client_x: float, client_y: float, img_scale: float, image_h: int
) -> tuple[int, int]:
    """Canvas click -> selected DATA pixel ``(x, y)``: the reference maps
    plot x -> data y and inverts plot y -> data x (``pixel_y =
    floor(val.x)``, ``pixel_x = (h-1) - floor(val.y)``,
    ``matrix_plot.rs:610-613``); composed with :func:`display_to_plot` the
    two flips cancel to (row, column)."""
    px, py = display_to_plot(client_x, client_y, img_scale, image_h)
    return image_h - 1 - py, px


def gauge_fraction(value: float, min_i: float, max_i: float, log: bool) -> float:
    """Value -> [0, 1] arc fraction; log10 mapping for the pressure gauge
    (JS ``frac`` in ``drawGauge``). Unclamped AND edge-degrading like
    the JS: log10(0)/0-span divisions yield NaN (the browser's
    -Infinity/NaN arithmetic), never an exception — the mirror must be
    drivable on the same inputs the page survives."""
    try:
        if log:
            return (math.log10(max(value, min_i)) - math.log10(min_i)) / (
                math.log10(max_i) - math.log10(min_i)
            )
        return (value - min_i) / (max_i - min_i)
    except (ValueError, ZeroDivisionError):
        return float("nan")


def gauge_value_deg(value: float, min_i: float, max_i: float, log: bool) -> float:
    """The filled arc's end angle in gauge degrees (clamped fraction)."""
    frac = max(0.0, min(1.0, gauge_fraction(value, min_i, max_i, log)))
    return GAUGE_A0 + frac * (GAUGE_A1 - GAUGE_A0)


def gauge_angle_rad(deg: float) -> float:
    """Gauge degrees -> canvas radians (JS ``ang``): the reference's
    ``x = -cos(phi)`` convention puts 0° at the left, increasing
    counter-clockwise."""
    return (180.0 - deg) * math.pi / 180.0


# ------------------------------------------------------------- 3-D view
#: drag sensitivity: radians of orbit per pixel of mouse travel
ORBIT_RAD_PER_PX = 0.01
#: view scale: the voxel cloud's max |coord| maps to canvas_min/2.2
VIEW_FILL = 2.2


def project_voxel(
    x: float, y: float, z: float, rot_x: float, rot_z: float
) -> tuple[float, float, float]:
    """The canvas renderer's orbit projection (JS ``drawVoxels``; the
    pan-orbit camera of ``threed_plot.rs:281-409`` reduced to two orbit
    angles): rotate about the z axis, then about the x axis; returns
    ``(x1, y2, z2)`` = (screen x, screen y, depth). Painter's order draws
    ascending ``z2``."""
    cx, sx = math.cos(rot_x), math.sin(rot_x)
    cz, sz = math.cos(rot_z), math.sin(rot_z)
    x1 = x * cz - y * sz
    y1 = x * sz + y * cz
    y2 = y1 * cx - z * sx
    z2 = y1 * sx + z * cx
    return x1, y2, z2


def voxel_screen_xy(
    x1: float, y2: float, scale: float, canvas_w: float, canvas_h: float
) -> tuple[float, float]:
    """Projected coords -> canvas px: centered, y up (JS ``fillRect`` at
    ``(w/2 + x1*sc, h/2 - y2*sc)``)."""
    return canvas_w / 2.0 + x1 * scale, canvas_h / 2.0 - y2 * scale


def voxel_view_scale(max_abs: float, canvas_w: float, canvas_h: float) -> float:
    """px per world unit (JS ``sc``): the cloud's bounding half-extent
    fills 1/2.2 of the smaller canvas dimension (``max_abs`` is floored
    at 1 by the JS loop's ``let m = 1`` initialization)."""
    return min(canvas_w, canvas_h) / (VIEW_FILL * max(max_abs, 1.0))


def orbit_drag(
    rot_x: float, rot_z: float, dx_px: float, dy_px: float
) -> tuple[float, float]:
    """Mouse drag -> new orbit angles: horizontal travel spins about z,
    vertical about x, 0.01 rad/px (JS mousemove handler; the reference's
    bevy pan-orbit camera, ``threed_plot.rs:281-388``)."""
    return rot_x + dy_px * ORBIT_RAD_PER_PX, rot_z + dx_px * ORBIT_RAD_PER_PX


# -------------------------------------------------------- plot canvases
#: drawSeries margins: 10 px on every side
#: (JS: ``px = (x-xmin)/(xmax-xmin)*(W-20)+10``,
#:      ``py = H-10-(y-ymin)/(ymax-ymin)*(H-20)``)
SERIES_MARGINS = (10.0, 10.0, 10.0, 10.0)  # (left, right, top, bottom)
#: drawXY (PSF page) margins: 20 left / 10 right / 15 top / 15 bottom
#: (JS: ``px = (x-xmin)/(xmax-xmin)*(W-30)+20``,
#:      ``py = H-15-(y-ymin)/(ymax-ymin)*(H-30)``)
XY_MARGINS = (20.0, 10.0, 15.0, 15.0)


def point_in_poly(x: float, y: float, poly: list) -> bool:
    """Ray-casting hover test (JS ``pointInPoly``; the ROI hover highlight
    + centroid tooltip, ``matrix_plot.rs:497-567``). Must agree with the
    COMPUTE path's rasterizer (``ops/roi.polygon_mask`` ↔
    ``math_tools.rs:574-591``) on interior points, or the hover outline
    would highlight pixels the ROI average never read —
    ``tests/test_jslogic.py`` cross-checks the two on a pixel grid."""
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i][0], poly[i][1]
        xj, yj = poly[j][0], poly[j][1]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


def series_bounds(
    series: list, xs: list
) -> tuple[float, float, float, float] | None:
    """Axis bounds of the pulse/FFT plot (JS ``drawSeries`` scan):
    null samples are skipped, a series' own ``x`` overrides the shared
    axis, a SHORT x axis clamps to its last entry
    (``sx[Math.min(i, sx.length-1)]``), and a flat y range is bumped by
    +1 so the divide stays finite. Returns None when nothing is drawable
    (the JS early-returns on non-finite bounds)."""
    xmin = ymin = math.inf
    xmax = ymax = -math.inf
    for s in series:
        if not s or not s.get("y"):
            continue
        sx = s.get("x") or xs
        for i, v in enumerate(s["y"]):
            if v is None:
                continue
            x = sx[min(i, len(sx) - 1)]
            xmin, xmax = min(xmin, x), max(xmax, x)
            ymin, ymax = min(ymin, v), max(ymax, v)
    if not (math.isfinite(xmin) and math.isfinite(ymin)):
        return None
    if ymax == ymin:
        ymax = ymin + 1
    return xmin, xmax, ymin, ymax


def series_px(
    x: float, xmin: float, xmax: float, canvas_w: float,
    margins: tuple = SERIES_MARGINS,
) -> float:
    """Data x -> canvas px (JS ``px``): linear into the margin-inset span."""
    ml, mr = margins[0], margins[1]
    return (x - xmin) / (xmax - xmin) * (canvas_w - ml - mr) + ml


def series_py(
    y: float, ymin: float, ymax: float, canvas_h: float,
    margins: tuple = SERIES_MARGINS,
) -> float:
    """Data y -> canvas px (JS ``py``): inverted (canvas y grows down)."""
    mt, mb = margins[2], margins[3]
    return canvas_h - mb - (y - ymin) / (ymax - ymin) * (canvas_h - mt - mb)


# ---------------------------------------------------------------- colorbar
def cbar_click_mid(y: float, bar_h: float) -> float:
    """Mirror of JS ``cbarClickMid``: clicking the colorbar sets the
    midpoint from the distance to the bar TOP — the reference computes
    ``val_y = img.height - pointer.y`` in its y-up plot space and assigns
    it directly (``matrix_plot.rs:214-223``). Clamped to 1..99 where the
    reference clamps 0..100: its Rust colormap tolerates the
    divide-by-zero at the extremes, the server's numpy one must not."""
    return min(99.0, max(1.0, y / bar_h * 100.0))


def cbar_drag_mid(mid: float, dy: float, bar_h: float) -> float:
    """Mirror of JS ``cbarDragMid``: dragging the triangle marker moves
    the midpoint RELATIVELY by ``delta_y / bar_height * 100``
    (``matrix_plot.rs:264-271``), same 1..99 clamp as the click."""
    return min(99.0, max(1.0, mid + dy / bar_h * 100.0))


def cbar_marker_y(mid: float, bar_h: float) -> float:
    """Mirror of JS ``cbarMarkerY``: marker screen y from the bar top —
    ``y_start + (y_end - y_start) * mid/100`` (``matrix_plot.rs:243-245``
    with our bar spanning the full canvas height)."""
    return mid / 100.0 * bar_h
