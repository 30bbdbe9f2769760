"""Evaluation plot artifacts (confusion matrix, ROC, PR curves, reliability
diagram), drawn by the port itself (counterpart of
``dfu_multimodal_tpu/eval/plots.py``).

The artifact contract is the JAX package's: the file names
``confusion_matrix_<name>.png``, ``roc_curve_<name>.png``,
``pr_curve_<name>.png`` and ``reliability_diagram_<name>.png``, each a
valid PNG of the JAX figure's size at its dpi (8 x 6 in at 300 dpi, 2400 x
1800 pixels; the reliability diagram 8 x 8 in, 2400 x 2400), showing the
same elements in the same colours:

- the confusion matrix: ``Blues`` cells (matplotlib's ColorBrewer stops,
  normalised from the smallest count to the largest) with their counts,
  white on a cell above half the largest count, a colour bar;
- ROC: the curve in darkorange with "ROC (AUC=...)", the navy dashed
  diagonal and, with ``band``, the bootstrap band in darkorange at 0.18
  opacity;
- PR: the curve in green with "PR (AUC=...)";
- reliability: the curve (blue, circles), the black dashed diagonal, the
  optional temperature-scaled curve (orange, squares, dashed) and the
  count bars (steelblue) below.

The pictures are not matplotlib's: the canvas is a numpy uint8 array
filled with vectorised rectangles, stamped line samples and alpha blends,
its text is a fixed 5 x 7 bitmap font (``eval/_font.py``), and it is
written by ``data/png.py::write_png``.  There is no matplotlib on any
host and no second route, so the CPU tests hold the code the card runs.
Each curve is drawn above the diagonal and grid it crosses.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from dfu_multimodal_tpu_torch.data.png import write_png
from dfu_multimodal_tpu_torch.eval import metrics as M
from dfu_multimodal_tpu_torch.eval._font import text_mask

DPI = 300
Color = Tuple[int, int, int]
WHITE, BLACK = (255, 255, 255), (0, 0, 0)
DARKORANGE, NAVY, GREEN = (255, 140, 0), (0, 0, 128), (0, 128, 0)
STEELBLUE, C0, C1 = (70, 130, 180), (31, 119, 180), (255, 127, 14)
GRID, LEGEND_EDGE = (176, 176, 176), (204, 204, 204)
# matplotlib's "Blues": nine ColorBrewer stops, linear in between
BLUES = np.array([(247, 251, 255), (222, 235, 247), (198, 219, 239),
                  (158, 202, 225), (107, 174, 214), (66, 146, 198),
                  (33, 113, 181), (8, 81, 156), (8, 48, 107)], np.float64)
LINE_W = 8                       # 2 pt at 300 dpi
TEXT, TITLE, COUNT = 5, 6, 8     # font cell sizes, pixels


def blues(v: np.ndarray) -> np.ndarray:
    """``Blues`` at v in [0, 1] -> (..., 3) uint8."""
    t = np.clip(np.asarray(v, np.float64), 0.0, 1.0) * (len(BLUES) - 1)
    i = np.minimum(np.floor(t).astype(int), len(BLUES) - 2)
    f = (t - i)[..., None]
    return np.rint(BLUES[i] * (1 - f) + BLUES[i + 1] * f).astype(np.uint8)


@dataclass(frozen=True)
class Axes:
    """A data rectangle on the canvas: pixel box ``(left, top, right,
    bottom)`` and the data limits it shows (a limit pair may run
    backwards, as imshow's rows do)."""

    left: int
    top: int
    right: int
    bottom: int
    xlim: Tuple[float, float] = (0.0, 1.0)
    ylim: Tuple[float, float] = (0.0, 1.05)

    def px(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Data (x, y) -> canvas (column, row), float."""
        x0, x1 = self.xlim
        y0, y1 = self.ylim
        cx = self.left + (np.asarray(x, np.float64) - x0) / (x1 - x0) * (
            self.right - self.left)
        cy = self.bottom - (np.asarray(y, np.float64) - y0) / (y1 - y0) * (
            self.bottom - self.top)
        return cx, cy


# the four figures' axes (the tests read these to find the curves)
CURVE_SIZE = (8 * DPI, 6 * DPI)
ROC_AXES = Axes(300, 140, 2320, 1540)
PR_AXES = ROC_AXES
CM_SIZE = CURVE_SIZE
CM_AXES = Axes(560, 140, 1960, 1540, xlim=(-0.5, 1.5), ylim=(1.5, -0.5))
CM_BAR = (2060, 140, 2130, 1540)
REL_SIZE = (8 * DPI, 8 * DPI)
REL_AXES = Axes(300, 140, 2320, 1640, ylim=(0.0, 1.0))
REL_HIST = (300, 1760, 2320, 2240)


class Canvas:
    """A white (H, W, 3) uint8 picture with the few drawing operations the
    plots need, each vectorised over its pixels."""

    def __init__(self, size: Tuple[int, int]):
        w, h = size
        self.px = np.full((h, w, 3), 255, np.uint8)

    def blend(self, mask: np.ndarray, color: Color, alpha: float = 1.0,
              origin: Tuple[int, int] = (0, 0)) -> None:
        """Paint ``color`` at ``alpha`` where the bool ``mask`` (placed
        with its top-left pixel at ``origin`` = (column, row)) is set."""
        x0, y0 = origin
        h, w = self.px.shape[:2]
        mh, mw = mask.shape
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x0 + mw, w), min(y0 + mh, h)
        if cx1 <= cx0 or cy1 <= cy0:
            return
        m = mask[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
        region = self.px[cy0:cy1, cx0:cx1]
        c = np.asarray(color, np.float64)
        if alpha >= 1.0:
            region[m] = np.asarray(color, np.uint8)
        else:
            region[m] = np.rint(region[m] * (1 - alpha) + c * alpha
                                ).astype(np.uint8)

    def rect(self, x0, y0, x1, y1, color: Color, alpha: float = 1.0):
        x0, y0, x1, y1 = (int(round(v)) for v in (x0, y0, x1, y1))
        if x1 > x0 and y1 > y0:
            self.blend(np.ones((y1 - y0, x1 - x0), bool), color, alpha,
                       (x0, y0))

    def frame(self, box, color: Color = BLACK, width: int = 3) -> None:
        x0, y0, x1, y1 = box
        for r in ((x0 - width, y0 - width, x1 + width, y0),
                  (x0 - width, y1, x1 + width, y1 + width),
                  (x0 - width, y0, x0, y1), (x1, y0, x1 + width, y1)):
            self.rect(*r, color)

    def text(self, s: str, x: float, y: float, scale: int = TEXT,
             color: Color = BLACK, ha: str = "center", va: str = "center",
             vertical: bool = False, bold: bool = False) -> Tuple[int, int]:
        """Draw ``s`` anchored at (x, y) by ``ha`` (left / center / right)
        and ``va`` (top / center / bottom); ``vertical`` turns it a quarter
        counter-clockwise.  Returns its (width, height) in pixels."""
        mask = text_mask(s, scale)
        if bold:
            mask = mask | np.pad(mask, ((0, 0), (scale // 3, 0)))[
                :, :mask.shape[1]]
        if vertical:
            mask = np.rot90(mask)
        h, w = mask.shape
        ox = {"left": 0, "center": w / 2, "right": w}[ha]
        oy = {"top": 0, "center": h / 2, "bottom": h}[va]
        self.blend(mask, color, 1.0, (int(round(x - ox)), int(round(y - oy))))
        return w, h

    def line(self, x: Sequence[float], y: Sequence[float], color: Color,
             width: int = LINE_W, dash: Optional[Tuple[int, int]] = None,
             alpha: float = 1.0, clip=None) -> None:
        """A polyline through canvas points: samples every half pixel
        along each segment, each stamped with a disk of ``width``;
        ``dash`` = (on, off) pixels of arc length; ``clip`` a pixel box."""
        p = np.stack([np.asarray(x, np.float64),
                      np.asarray(y, np.float64)], axis=1)
        if len(p) == 1:
            p = np.repeat(p, 2, axis=0)
        d = np.diff(p, axis=0)
        seg = np.hypot(d[:, 0], d[:, 1])
        counts = np.ceil(seg * 2).astype(np.int64) + 1
        idx = np.repeat(np.arange(len(d)), counts)
        start = np.repeat(np.cumsum(counts) - counts, counts)
        t = (np.arange(counts.sum()) - start) / np.repeat(
            np.maximum(counts - 1, 1), counts)
        pts = p[idx] + t[:, None] * d[idx]
        if dash is not None:
            arc = (np.concatenate([[0.0], np.cumsum(seg)])[idx]
                   + t * seg[idx])
            pts = pts[arc % sum(dash) < dash[0]]
        r = width / 2.0
        k = int(np.ceil(r))
        oy, ox = np.mgrid[-k:k + 1, -k:k + 1]
        disk = (ox ** 2 + oy ** 2) <= r * r
        ox, oy = ox[disk], oy[disk]
        cx = np.rint(pts[:, 0]).astype(np.int64)[:, None] + ox[None]
        cy = np.rint(pts[:, 1]).astype(np.int64)[:, None] + oy[None]
        h, w = self.px.shape[:2]
        x0, y0, x1, y1 = clip if clip is not None else (0, 0, w, h)
        keep = ((cx >= max(x0, 0)) & (cx < min(x1, w))
                & (cy >= max(y0, 0)) & (cy < min(y1, h)))
        cx, cy = cx[keep], cy[keep]
        if cx.size == 0:
            return
        bx, by = int(cx.min()), int(cy.min())
        mask = np.zeros((int(cy.max()) - by + 1, int(cx.max()) - bx + 1),
                        bool)
        mask[cy - by, cx - bx] = True
        self.blend(mask, color, alpha, (bx, by))

    def markers(self, x, y, color: Color, size: int, square: bool = False):
        for cx, cy in zip(np.atleast_1d(x), np.atleast_1d(y)):
            r = size // 2
            oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
            m = np.ones_like(ox, bool) if square else ox ** 2 + oy ** 2 <= r * r
            self.blend(m, color, 1.0, (int(round(cx)) - r, int(round(cy)) - r))

    def fill_between(self, ax: Axes, x, lo, hi, color: Color,
                     alpha: float) -> None:
        """Shade between the curves ``lo`` and ``hi`` over ``x`` (data,
        ``x`` increasing), column by column inside ``ax``."""
        cols = np.arange(ax.left, ax.right)
        xd = ax.xlim[0] + (cols + 0.5 - ax.left) / (ax.right - ax.left) * (
            ax.xlim[1] - ax.xlim[0])
        inside = (xd >= x[0]) & (xd <= x[-1])
        _, ylo = ax.px(xd, np.interp(xd, x, lo))
        _, yhi = ax.px(xd, np.interp(xd, x, hi))
        rows = np.arange(ax.top, ax.bottom)[:, None] + 0.5
        mask = inside[None] & (rows >= np.minimum(ylo, yhi)[None]) & (
            rows <= np.maximum(ylo, yhi)[None])
        self.blend(mask, color, alpha, (ax.left, ax.top))

    def save(self, path: Path) -> Path:
        write_png(path, self.px)
        return Path(path)


# ---------------------------------------------------------------- axes


def _box(ax: Axes) -> Tuple[int, int, int, int]:
    return ax.left, ax.top, ax.right, ax.bottom


def _ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    """Round-numbered ticks in [lo, hi]: a step of 1, 2, 2.5 or 5 x 10^k
    giving about ``n`` intervals."""
    span = max(hi - lo, 1e-12)
    raw = span / n
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(s * mag for s in (1, 2, 2.5, 5, 10) if s * mag >= raw)
    first = np.ceil(lo / step - 1e-9) * step
    return np.arange(first, hi + step * 1e-6, step)


def _fmt(v: float, step: float) -> str:
    """A tick label with the decimals its step needs (at least one below
    a step of 1, as matplotlib's 0.0, 0.2, ...)."""
    if step >= 1 and float(v).is_integer():
        return f"{int(v)}"
    digits = 1
    while abs(step * 10 ** digits - round(step * 10 ** digits)) > 1e-6:
        digits += 1
    return f"{v:.{digits}f}"


def _axis(cv: Canvas, ax: Axes, xticks, yticks, xlabel: str, ylabel: str,
          grid: bool = False, xtick_labels=None, ytick_labels=None,
          show_xticks: bool = True) -> None:
    """Frame, ticks, tick labels, axis labels and an optional grid."""
    xticks, yticks = np.asarray(xticks, float), np.asarray(yticks, float)
    xs, _ = ax.px(xticks, np.full(len(xticks), ax.ylim[0]))
    _, ys = ax.px(np.full(len(yticks), ax.xlim[0]), yticks)
    if grid:
        for x in xs:
            cv.rect(x - 1.5, ax.top, x + 1.5, ax.bottom, GRID, 0.3)
        for y in ys:
            cv.rect(ax.left, y - 1.5, ax.right, y + 1.5, GRID, 0.3)
    cv.frame(_box(ax))
    xstep = float(np.diff(xticks).min()) if len(xticks) > 1 else 1.0
    ystep = float(np.diff(yticks).min()) if len(yticks) > 1 else 1.0
    for i, x in enumerate(xs):
        cv.rect(x - 1.5, ax.bottom + 3, x + 1.5, ax.bottom + 18, BLACK)
        if show_xticks:
            label = (xtick_labels[i] if xtick_labels is not None
                     else _fmt(xticks[i], xstep))
            cv.text(label, x, ax.bottom + 30, TEXT, va="top")
    for i, y in enumerate(ys):
        cv.rect(ax.left - 18, y - 1.5, ax.left - 3, y + 1.5, BLACK)
        label = (ytick_labels[i] if ytick_labels is not None
                 else _fmt(yticks[i], ystep))
        cv.text(label, ax.left - 30, y, TEXT, ha="right")
    if xlabel:
        cv.text(xlabel, (ax.left + ax.right) / 2, ax.bottom + 100, TITLE,
                va="top")
    cv.text(ylabel, ax.left - 200, (ax.top + ax.bottom) / 2, TITLE,
            vertical=True)


def _title(cv: Canvas, ax: Axes, title: str) -> None:
    cv.text(title, (ax.left + ax.right) / 2, ax.top - 50, TITLE + 1,
            va="bottom")


def _legend(cv: Canvas, ax: Axes, entries, loc: str) -> None:
    """``entries``: (label, color, kind) with kind ``"line"``,
    ``"dashed"``, ``"patch"`` or a marker line ``"o-"`` / ``"s--"``;
    drawn in a white box inside the ``loc`` corner."""
    pad, sample, row = 24, 110, 8 * TEXT + 24
    widths = [text_mask(e[0], TEXT).shape[1] for e in entries]
    w = pad * 3 + sample + max(widths)
    h = pad * 2 + row * len(entries) - 24
    x0 = ax.left + 30 if "left" in loc else ax.right - 30 - w
    y0 = ax.top + 30 if "upper" in loc else ax.bottom - 30 - h
    cv.rect(x0, y0, x0 + w, y0 + h, WHITE, 0.8)
    cv.frame((x0, y0, x0 + w, y0 + h), LEGEND_EDGE, 2)
    for i, (label, color, kind) in enumerate(entries):
        yc = y0 + pad + i * row + 7 * TEXT / 2
        xs = [x0 + pad, x0 + pad + sample]
        if kind == "patch":
            cv.rect(xs[0], yc - 18, xs[1], yc + 18, color, 0.18)
        else:
            cv.line(xs, [yc, yc], color,
                    dash=(30, 14) if kind.endswith("--") or kind == "dashed"
                    else None)
            if kind[0] in "os":
                cv.markers([(xs[0] + xs[1]) / 2], [yc], color, 24,
                           square=kind[0] == "s")
        cv.text(label, xs[1] + pad, yc, TEXT, ha="left")


# ---------------------------------------------------------------- plots


def plot_confusion_matrix(y_true, y_pred, model_name: str,
                          output_dir: Path) -> Path:
    cm = M.binary_confusion(y_true, y_pred)
    lo, hi = float(cm.min()), float(cm.max())
    norm = (cm - lo) / (hi - lo) if hi > lo else np.zeros((2, 2))
    cv = Canvas(CM_SIZE)
    ax = CM_AXES
    for i in range(2):
        for j in range(2):
            x0, y0 = ax.px(j - 0.5, i - 0.5)
            x1, y1 = ax.px(j + 0.5, i + 0.5)
            cv.rect(x0, y0, x1, y1, tuple(int(c) for c in blues(norm[i, j])))
            xc, yc = ax.px(j, i)
            cv.text(str(int(cm[i, j])), xc, yc, COUNT,
                    WHITE if cm[i, j] > hi / 2 else BLACK, bold=True)
    _axis(cv, ax, [0, 1], [0, 1], "Predicted Label", "True Label",
          xtick_labels=["Healthy", "Ulcer"],
          ytick_labels=["Healthy", "Ulcer"])
    _title(cv, ax, f"Confusion Matrix: {model_name}")
    # the colour bar: Blues from the smallest count (bottom) to the largest
    bx0, by0, bx1, by1 = CM_BAR
    v = np.linspace(1.0, 0.0, by1 - by0)
    cv.px[by0:by1, bx0:bx1] = blues(v)[:, None, :]
    cv.frame(CM_BAR, BLACK, 2)
    ticks = _ticks(lo, hi) if hi > lo else np.array([lo])
    step = float(np.diff(ticks).min()) if len(ticks) > 1 else 1.0
    for t in ticks:
        y = by1 - (t - lo) / (hi - lo) * (by1 - by0) if hi > lo else by1
        cv.rect(bx1 + 2, y - 1.5, bx1 + 16, y + 1.5, BLACK)
        cv.text(_fmt(t, step), bx1 + 28, y, TEXT, ha="left")
    return cv.save(Path(output_dir) / f"confusion_matrix_{model_name}.png")


def plot_roc_curve(y_true, y_probs, model_name: str, output_dir: Path,
                   band=None, band_alpha: float = 0.05) -> Path:
    """``band`` (optional): ``(fpr_grid, tpr_lo, tpr_mean, tpr_hi)`` from
    ``eval.bootstrap.roc_band`` — drawn as a shaded bootstrap CI behind
    the curve when ``extended_metrics --bootstrap`` is on; the default
    artifact is unchanged without it."""
    fpr, tpr, _ = M.roc_curve(y_true, y_probs)
    roc_auc = M.trapezoid_auc(fpr, tpr)
    cv = Canvas(CURVE_SIZE)
    ax = ROC_AXES
    ticks = np.linspace(0, 1, 6)
    _axis(cv, ax, ticks, ticks, "False Positive Rate", "True Positive Rate",
          grid=True)
    entries = []
    if band is not None:
        fgrid, lo, _, hi = band
        cv.fill_between(ax, np.asarray(fgrid), np.asarray(lo),
                        np.asarray(hi), DARKORANGE, 0.18)
        pct = round(100 * (1.0 - band_alpha))
        entries.append((f"Bootstrap {pct}% band", DARKORANGE, "patch"))
    clip = _box(ax)
    cv.line(*ax.px([0, 1], [0, 1]), NAVY, dash=(30, 14), clip=clip)
    cv.line(*ax.px(fpr, tpr), DARKORANGE, clip=clip)
    entries += [(f"ROC (AUC={roc_auc:.4f})", DARKORANGE, "line"),
                ("Random", NAVY, "dashed")]
    _legend(cv, ax, entries, "lower right")
    _title(cv, ax, f"ROC Curve: {model_name}")
    return cv.save(Path(output_dir) / f"roc_curve_{model_name}.png")


def plot_precision_recall_curve(y_true, y_probs, model_name: str,
                                output_dir: Path) -> Path:
    precision, recall, _ = M.precision_recall_curve(y_true, y_probs)
    pr_auc = M.trapezoid_auc(recall, precision)
    cv = Canvas(CURVE_SIZE)
    ax = PR_AXES
    ticks = np.linspace(0, 1, 6)
    _axis(cv, ax, ticks, ticks, "Recall", "Precision", grid=True)
    cv.line(*ax.px(recall, precision), GREEN, clip=_box(ax))
    _legend(cv, ax, [(f"PR (AUC={pr_auc:.4f})", GREEN, "line")],
            "lower left")
    _title(cv, ax, f"Precision-Recall Curve: {model_name}")
    return cv.save(Path(output_dir) / f"pr_curve_{model_name}.png")


def plot_reliability_diagram(y_true, y_probs, model_name: str,
                             output_dir: Path, n_bins: int = 15,
                             temperature: Optional[float] = None) -> Path:
    """Reliability diagram (beyond-reference, ``extended_metrics
    --calibration``): per-bin mean confidence vs empirical ulcer rate
    against the perfect-calibration diagonal, with the bin histogram
    underneath. When ``temperature`` is given, the temperature-scaled
    curve is overlaid."""
    from dfu_multimodal_tpu_torch.eval import calibration as C
    cv = Canvas(REL_SIZE)
    ax = REL_AXES
    ticks = np.linspace(0, 1, 6)
    _axis(cv, ax, ticks, ticks, "", "Empirical ulcer rate",
          show_xticks=False)
    clip = _box(ax)
    cv.line(*ax.px([0, 1], [0, 1]), BLACK, width=4, dash=(30, 14),
            clip=clip)
    entries = [("Perfect calibration", BLACK, "dashed")]

    def draw(probs, label, color, kind):
        mean_p, frac, counts = C.reliability_curve(y_true, probs, n_bins)
        ok = counts > 0
        err = C.calibration_errors(y_true, probs, n_bins)
        if ok.any():
            x, y = ax.px(mean_p[ok], frac[ok])
            cv.line(x, y, color, dash=(30, 14) if kind.endswith("--")
                    else None, clip=clip)
            cv.markers(x, y, color, 26, square=kind[0] == "s")
        entries.append((f"{label} (ECE {err['ece']:.3f}, "
                        f"Brier {err['brier']:.3f})", color, kind))
        return counts

    counts = draw(y_probs, model_name, C0, "o-")
    if temperature is not None:
        draw(C.apply_temperature(y_probs, temperature),
             f"T={temperature:.2f}", C1, "s--")
    _legend(cv, ax, entries, "upper left")
    _title(cv, ax, f"Reliability Diagram: {model_name}")

    top = max(float(counts.max()), 1.0) * 1.05
    hx = Axes(*REL_HIST, xlim=(0.0, 1.0), ylim=(0.0, top))
    width = 1.0 / n_bins * 0.9
    for b, n in enumerate(counts):
        if n:
            c = (b + 0.5) / n_bins
            x0, y0 = hx.px(c - width / 2, n)
            x1, y1 = hx.px(c + width / 2, 0)
            cv.rect(x0, y0, x1, y1, STEELBLUE)
    _axis(cv, hx, ticks, _ticks(0, top, 3), "Predicted P(Ulcer)", "Count")
    return cv.save(Path(output_dir)
                   / f"reliability_diagram_{model_name}.png")
