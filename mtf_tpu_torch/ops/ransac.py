"""Robust warp estimation: RANSAC, LMedS and least squares (port of
`mtf_tpu/ops/ransac.py`), over a leading batch of B trackers.

A fixed batch of minimal-sample hypotheses is fitted and scored at once
(every tracker's hypotheses in one batched DLT), then a weighted
least-squares refit over all points with the best hypothesis's inlier
weights. Correspondences are (B, N, 2), in the SSM's template frame.

The minimal samples are an (H, sample) index set shared by the B
trackers (`hyp_indices`, from a `torch.Generator`); the fits take it as
an argument, so a test can hand them the JAX package's threefry draw.
"""
from __future__ import annotations

import torch


def min_sample_size(ssm) -> int:
    """Minimal correspondences to determine the warp (2 constraints per
    point)."""
    return max(1, (ssm.dof + 1) // 2)


def hyp_indices(generator: torch.Generator, n_hyps: int, n_pts: int,
                sample_size: int) -> torch.Tensor:
    """The (n_hyps, sample_size) minimal-sample draw, uniform over
    [0, n_pts), on the generator's device."""
    return torch.randint(0, n_pts, (n_hyps, sample_size),
                         generator=generator, device=generator.device)


def _scored(ssm, src, dst, idx):
    """Hypotheses (B, H, S) fitted on the samples `idx` (H, ss), their
    residuals (B, H, N) and validity (B, H)."""
    hyps = ssm.fit_pts(src[:, idx], dst[:, idx])
    res = torch.linalg.vector_norm(ssm.warp_pts(hyps, src[:, None])
                                   - dst[:, None], dim=-1)
    return res, torch.isfinite(hyps).all(dim=-1)


def _refit(ssm, src, dst, w, ss):
    """Weighted refit; a tracker whose weights sum under `ss` falls back
    to the unweighted fit."""
    w = torch.where(w.sum(-1, keepdim=True) >= ss, w, torch.ones_like(w))
    return ssm.fit_pts(src, dst, weights=w), w


def ransac_fit(ssm, src: torch.Tensor, dst: torch.Tensor,
               idx: torch.Tensor, inlier_thresh=0.05,
               weights: torch.Tensor | None = None):
    """RANSAC warp fit -> (state (B, S), inlier weights (B, N)).
    `inlier_thresh` (a float, or (B,) per tracker) is in the
    correspondences' units; `weights` (B, N) multiply the inlier flags."""
    res, valid = _scored(ssm, src, dst, idx)
    thresh = torch.as_tensor(inlier_thresh, dtype=src.dtype,
                             device=src.device)
    if thresh.dim():
        thresh = thresh[:, None, None]
    inl = (res < thresh).to(src.dtype)
    if weights is not None:
        inl = inl * weights[:, None, :]
    scores = torch.where(valid, inl.sum(-1), -1.0)
    best = scores.argmax(dim=-1)          # the first maximum, as jnp.argmax
    w = inl[torch.arange(src.shape[0], device=src.device), best]
    return _refit(ssm, src, dst, w, min_sample_size(ssm))


def lmeds_fit(ssm, src: torch.Tensor, dst: torch.Tensor, idx: torch.Tensor,
              weights: torch.Tensor | None = None):
    """Least-median-of-squares fit: the hypothesis with the least median
    squared residual, then a refit on the points within 2.5 robust sigma."""
    res, valid = _scored(ssm, src, dst, idx)
    # the median of an even count is the mean of the middle two, as
    # jnp.median; a NaN anywhere gives NaN
    med = torch.quantile(res * res, 0.5, dim=-1)
    med = torch.where(valid, med, float("inf"))
    best = med.argmin(dim=-1)
    rows = torch.arange(src.shape[0], device=src.device)
    sigma = 1.4826 * torch.sqrt(med[rows, best]) + 1e-12
    w = (res[rows, best] < 2.5 * sigma[:, None]).to(src.dtype)
    if weights is not None:
        w = w * weights
    return _refit(ssm, src, dst, w, min_sample_size(ssm))


def robust_fit(ssm, src: torch.Tensor, dst: torch.Tensor,
               idx: torch.Tensor | None, method: str = "ransac",
               inlier_thresh=0.05, weights: torch.Tensor | None = None):
    """Dispatch over the estimators (SSMEstimatorParams.h:11): "ransac",
    "lmeds" / "least_median", and least squares for any other name."""
    if method == "ransac":
        return ransac_fit(ssm, src, dst, idx, inlier_thresh, weights)
    if method in ("lmeds", "least_median"):
        return lmeds_fit(ssm, src, dst, idx, weights)
    if method in ("median", "medianflow"):
        raise NotImplementedError(
            "the median-flow fit is not ported yet: it comes with ROADMAP "
            "Queue 1c (median flow, mf and tld)")
    w = weights if weights is not None else torch.ones(
        src.shape[:2], dtype=src.dtype, device=src.device)
    return ssm.fit_pts(src, dst, weights=w), w
