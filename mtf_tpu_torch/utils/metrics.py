"""Tracking-error metrics and success-rate curves (port of
`mtf_tpu/utils/metrics.py`).

Re-designs of the reference error machinery
(`Utilities/include/mtf/Utilities/miscUtils.h:449-466`
TrackErrT{MCD, CL, Jaccard}; success-rate sweep `runMTF.cc:746-776`).
Pure numpy — host-side evaluation code.
"""
from __future__ import annotations

import numpy as np


def mcd_error(gt: np.ndarray, tracked: np.ndarray) -> float:
    """Mean corner distance over the 4 corners ((4,2) each)."""
    return float(np.mean(np.linalg.norm(np.asarray(gt) - np.asarray(tracked),
                                        axis=-1)))


def cl_error(gt: np.ndarray, tracked: np.ndarray) -> float:
    """Center-location error."""
    return float(np.linalg.norm(np.mean(np.asarray(gt), 0)
                                - np.mean(np.asarray(tracked), 0)))


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clipping of `subject` by convex `clip`."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        p1, p2, a, b = (np.asarray(v, np.float64) for v in (p1, p2, a, b))
        d, s = p2 - p1, b - a
        denom = d[0] * s[1] - d[1] * s[0]  # cross(d, s)
        if abs(denom) < 1e-12:
            return p2.tolist()
        ap = a - p1
        t = (ap[0] * s[1] - ap[1] * s[0]) / denom  # cross(a-p1, s)/cross(d, s)
        return (p1 + t * d).tolist()

    # ensure counter-clockwise clip polygon
    if np.cross(clip[1] - clip[0], clip[2] - clip[1]) < 0:
        clip = clip[::-1]
    output = [p.tolist() for p in subject]
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        prev = input_list[-1]
        for cur in input_list:
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersect(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersect(prev, cur, a, b))
            prev = cur
    return np.asarray(output) if output else np.zeros((0, 2))


def jaccard_error(gt: np.ndarray, tracked: np.ndarray) -> float:
    """1 - IoU of the two corner quadrilaterals (reference Jaccard)."""
    gt = np.asarray(gt, np.float64)
    tr = np.asarray(tracked, np.float64)
    # orient both CCW for clipping
    if np.cross(gt[1] - gt[0], gt[2] - gt[1]) < 0:
        gt = gt[::-1]
    if np.cross(tr[1] - tr[0], tr[2] - tr[1]) < 0:
        tr = tr[::-1]
    inter_poly = _clip_polygon(tr, gt)
    inter = _polygon_area(inter_poly) if len(inter_poly) >= 3 else 0.0
    union = _polygon_area(gt) + _polygon_area(tr) - inter
    if union <= 0:
        return 1.0
    return 1.0 - inter / union


ERROR_FNS = {"mcd": mcd_error, "cl": cl_error, "jaccard": jaccard_error}


def tracking_errors(gt_seq, tracked_seq, kind: str = "mcd") -> np.ndarray:
    fn = ERROR_FNS[kind]
    return np.asarray([fn(g, t) for g, t in zip(gt_seq, tracked_seq)])


def success_rate_curve(errors: np.ndarray, n_thresh: int = 100,
                       t_min: float = 0.1, t_max: float = 20.0):
    """SR(t) over threshold sweep (runMTF.cc:746-776 defaults).
    Returns (thresholds, sr, mean_sr)."""
    errors = np.asarray(errors)
    thresholds = np.linspace(t_min, t_max, n_thresh)
    sr = np.asarray([(errors < t).mean() for t in thresholds])
    return thresholds, sr, float(sr.mean())
