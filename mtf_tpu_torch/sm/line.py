"""LineTracker (port of `mtf_tpu/sm/line.py`): a grid tracker whose patch
centres are snapped to fitted row and column lines, over B trackers.

Per update: the grid's patches are tracked as `GridTracker` tracks them
(`_track_patches_pyr`: the grid-flow kernel K5 on the card with dense
taps); one line is fitted to each grid row and each grid column by
weighted total least squares (the principal eigenvector of a 2x2
covariance, closed form); each centre moves to its row x column line
intersection; the points whose snap moved them less than `conf_thresh`
(template units) weigh 1 and the others 0 in the robust fit, unless fewer
than the minimal sample remain (then all weigh 1), and RANSAC (or the
grid's estimator) fits the warp to the snapped centres.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mtf_tpu_torch.ops import ransac
from mtf_tpu_torch.sm.core import TrackerState
from mtf_tpu_torch.sm.grid import GridParams, GridState, GridTracker


@dataclass(frozen=True)
class LineParams:
    """The JAX package's `LineParams`."""
    conf_thresh: float = 0.05   # snap-residual confidence (template units)


def fit_line(pts: torch.Tensor, w: torch.Tensor):
    """Weighted TLS lines through points (..., K, 2) with weights (..., K)
    -> (point (..., 2), unit direction (..., 2)): the mean and the
    principal eigenvector of the weighted covariance (an axis where the
    covariance is diagonal)."""
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    mu = (w[..., None] * pts).sum(-2) / wsum[..., None]
    d = pts - mu[..., None, :]
    cov = (w[..., None] * d).transpose(-1, -2) @ d / wsum[..., None, None]
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    tr, det = a + c, a * c - b * b
    lam = tr / 2 + torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    v = torch.where((b.abs() > 1e-12)[..., None],
                    torch.stack([lam - c, b], -1),
                    torch.where((a >= c)[..., None],
                                torch.stack([one, zero], -1),
                                torch.stack([zero, one], -1)))
    return mu, v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-12)


def intersect(p1, d1, p2, d2):
    """Intersection (..., 2) of the lines p1 + t d1 and p2 + s d2; p1
    where they are near parallel."""
    a01, a11 = -d2[..., 0], -d2[..., 1]
    det = d1[..., 0] * a11 - a01 * d1[..., 1]
    rhs = p2 - p1
    ok = det.abs() > 1e-9
    t = torch.where(ok, (rhs[..., 0] * a11 - rhs[..., 1] * a01)
                    / torch.where(ok, det, torch.ones_like(det)),
                    torch.zeros_like(det))
    return p1 + t[..., None] * d1


class LineTracker(GridTracker):
    name = "line"

    def __init__(self, am, ssm, prm=None, grid: GridParams | None = None,
                 line: LineParams | None = None):
        super().__init__(am, ssm, prm, grid)
        self.line = line or LineParams()

    def _snap_to_lines(self, centers: torch.Tensor, weights: torch.Tensor):
        """Centres (B, P, 2) of the R x R grid (row-major) -> (the
        line-snapped centres (B, P, 2), their confidence (B, P))."""
        R = self.grid.grid_res
        b = centers.shape[0]
        pts = centers.reshape(b, R, R, 2)                  # [row, col]
        w = weights.reshape(b, R, R)
        row_mu, row_d = fit_line(pts, w)                   # (B, R, 2)
        col_mu, col_d = fit_line(pts.transpose(1, 2), w.transpose(1, 2))
        snapped = intersect(row_mu[:, :, None], row_d[:, :, None],
                            col_mu[:, None], col_d[:, None]).reshape(b, -1, 2)
        resid = torch.linalg.vector_norm(snapped - centers, dim=-1)
        return snapped, (resid < self.line.conf_thresh).to(centers.dtype)

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        gs: GridState = state.extra
        region = state.region
        centers_pred, pts_base = self._patch_points(state)
        disp = self._track_patches_pyr(self._pyr_frames(frame),
                                       region.norm_mat, pts_base,
                                       gs.templates)
        centers_new = centers_pred + disp
        snapped, conf = self._snap_to_lines(
            centers_new, torch.ones_like(centers_new[..., 0]))
        w = torch.where(conf.sum(-1, keepdim=True)
                        >= ransac.min_sample_size(self.ssm),
                        conf, torch.ones_like(conf))
        new_ssm, inl = self._fit_warp(region, gs.centers0, snapped,
                                      int(gs.step), w)
        return state._replace(ssm_state=new_ssm, extra=gs._replace(
            step=gs.step + 1, inlier_mask=inl))
