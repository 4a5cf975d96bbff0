"""Tracking visualization: region/grid/particle drawing + video recording
(port of `mtf_tpu/utils/viz.py`).

The reference draws tracked regions and diagnostics live into OpenCV
windows and optionally records them (`runMTF.cc:607-674` drawing/record
path; per-tracker colors from `objUtils.cc` col_rgb). Headless-first
here: `annotate` renders corners onto a frame, `VideoRecorder` writes the
annotated stream; live display stays optional (`show`).
"""
from __future__ import annotations

import numpy as np

# reference per-tracker color rotation (objUtils col_rgb order, BGR)
COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255),
          (255, 0, 255), (255, 255, 0), (255, 255, 255), (0, 0, 0)]


def to_bgr_u8(frame) -> np.ndarray:
    """float gray/RGB frame -> uint8 BGR canvas for drawing."""
    f = np.asarray(frame)
    f = np.clip(f, 0.0, 255.0).astype(np.uint8)
    if f.ndim == 2:
        return np.repeat(f[..., None], 3, axis=-1)
    return f[..., ::-1].copy()  # RGB -> BGR


def draw_region(canvas: np.ndarray, corners, color=(0, 255, 0),
                thickness: int = 2, label: str | None = None) -> np.ndarray:
    """Draw a (4, 2) corner polygon (drawRegion analog, miscUtils)."""
    import cv2  # type: ignore
    pts = np.asarray(corners, np.float32).reshape(4, 2)
    cv2.polylines(canvas, [pts.astype(np.int32).reshape(-1, 1, 2)],
                  isClosed=True, color=color, thickness=thickness)
    if label:
        org = pts.min(axis=0).astype(int)
        cv2.putText(canvas, label, (int(org[0]), max(12, int(org[1]) - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
    return canvas


def draw_points(canvas: np.ndarray, pts, color=(0, 255, 255),
                radius: int = 1) -> np.ndarray:
    """Scatter grid-tracker points / PF particles (the reference's grid
    and particle debug windows)."""
    import cv2  # type: ignore
    for x, y in np.asarray(pts, np.float32).reshape(-1, 2):
        cv2.circle(canvas, (int(x), int(y)), radius, color, -1)
    return canvas


def annotate(frame, regions, labels=None, gt=None) -> np.ndarray:
    """Render one frame: tracked region(s) in rotation colors, optional
    GT in white (the runMTF display composition)."""
    canvas = to_bgr_u8(frame)
    regions = np.asarray(regions, np.float32).reshape(-1, 4, 2)
    for i, r in enumerate(regions):
        lbl = labels[i] if labels else None
        draw_region(canvas, r, COLORS[i % len(COLORS)], 2, lbl)
    if gt is not None:
        draw_region(canvas, gt, (255, 255, 255), 1, "gt")
    return canvas


class VideoRecorder:
    """Annotated tracking video writer (the record path of runMTF)."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, canvas: np.ndarray) -> None:
        import cv2  # type: ignore
        if self._writer is None:
            h, w = canvas.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"MJPG")
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps,
                                           (w, h))
        self._writer.write(canvas)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def render_curves(series: dict, path: str, title: str = "",
                  size=(360, 640), y_label: str = "", x_label: str = "",
                  show: bool = False):
    """Render named scalar series as a line plot PNG via cv2 — the
    `graphUtils.cc` live-diagnostics-curve analog
    (Utilities/src/graphUtils.cc renders tracker error /
    similarity curves into a cv window; this environment is headless and
    has no matplotlib, so curves draw with cv2 primitives and write to
    `path`; `show=True` additionally cv2.imshow's the canvas when a
    display exists).

    series: {name: 1-D array-like}. Returns the BGR canvas.
    """
    import cv2
    h, w = size
    m = 46                                      # margin
    canvas = np.full((h, w, 3), 255, np.uint8)
    colors = [(180, 60, 30), (30, 120, 200), (40, 160, 60),
              (150, 40, 160), (20, 80, 120), (100, 100, 100)]
    ys = [np.asarray(v, np.float64).ravel() for v in series.values()]
    if not ys or all(len(y) == 0 for y in ys):
        cv2.imwrite(path, canvas)
        return canvas
    ymin = min(float(np.nanmin(y)) for y in ys if len(y))
    ymax = max(float(np.nanmax(y)) for y in ys if len(y))
    if not np.isfinite(ymin) or not np.isfinite(ymax) or ymax <= ymin:
        ymin, ymax = 0.0, max(1.0, ymax if np.isfinite(ymax) else 1.0)
    pad = 0.05 * (ymax - ymin)
    ymin, ymax = ymin - pad, ymax + pad
    nmax = max(len(y) for y in ys)
    # axes + gridlines with tick labels
    cv2.rectangle(canvas, (m, m // 2), (w - m // 4, h - m), (0, 0, 0), 1)
    for k in range(5):
        yv = ymin + (ymax - ymin) * k / 4
        py = int(np.interp(yv, [ymin, ymax], [h - m, m // 2]))
        cv2.line(canvas, (m, py), (w - m // 4, py), (225, 225, 225), 1)
        cv2.putText(canvas, f"{yv:.3g}", (2, py + 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.35, (60, 60, 60), 1)
    for i, (name, y) in enumerate(series.items()):
        y = np.asarray(y, np.float64).ravel()
        if len(y) < 2:
            continue
        xs = np.interp(np.arange(len(y)), [0, max(1, nmax - 1)],
                       [m, w - m // 4]).astype(np.int32)
        pys = np.interp(np.clip(y, ymin, ymax), [ymin, ymax],
                        [h - m, m // 2]).astype(np.int32)
        pts = np.stack([xs, pys], -1).reshape(-1, 1, 2)
        cv2.polylines(canvas, [pts], False, colors[i % len(colors)], 1,
                      cv2.LINE_AA)
        cv2.putText(canvas, name, (m + 6, m // 2 + 16 + 16 * i),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                    colors[i % len(colors)], 1)
    if title:
        cv2.putText(canvas, title, (m, m // 2 - 6),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    if x_label:
        cv2.putText(canvas, x_label, (w // 2, h - m // 3),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (60, 60, 60), 1)
    if y_label:
        cv2.putText(canvas, y_label, (2, 14),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (60, 60, 60), 1)
    cv2.imwrite(path, canvas)
    if show:  # pragma: no cover - display path
        try:
            cv2.imshow(title or "curves", canvas)
            cv2.waitKey(1)
        except Exception:
            pass
    return canvas
