"""FeatureTracker (port of `mtf_tpu/sm/feature.py`): sparse
detector/descriptor matching and a robust warp fit, over B trackers.

Detection and description run on the host with OpenCV, as in the JAX
package and the reference (the detector x descriptor registry of
`mtf.h:672-744`): each tracker detects in its own search window, padded
to `max_keypoints` with a validity mask. The device stage,
`update_with_detections`, matches every tracker's template set against
its detections in one batched (B, K0, D) x (B, K1, D) product (binary
descriptors as {0, 1} rows, so that |a| + |b| - 2ab is their Hamming
distance, exact in float32 without TF32), then fits the SSM by RANSAC,
LMedS or least squares, and holds a tracker's state where its fit fails.

The RANSAC draw comes from `seeded_generator(seed, update count, SALT)`;
`update_with_detections(..., idx=)` takes another (a test hands it the
JAX package's threefry draw).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mtf_tpu_torch.am import get_am
from mtf_tpu_torch.ops import ransac
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.linalg import inv3x3
from mtf_tpu_torch.sm.core import (SearchMethod, SMParams, TrackerState,
                                   image_corners, multi_unported,
                                   seeded_generator)


@dataclass(frozen=True)
class FeatureParams:
    """feat_* parameter block (FeatureTrackerParams)."""
    detector: str = "orb"          # orb|brisk|sift|akaze|kaze|fast|agast|gftt|mser
    descriptor: str = ""           # "" = same family as detector
    max_keypoints: int = 500
    ratio_thresh: float = 0.75     # Lowe ratio test
    max_dist_ratio: float = 1.0
    search_margin: float = 1.5     # search window = region scaled by this
    min_matches: int = 8
    estimator: str = "ransac"      # ransac | lmeds | lsq
    inlier_thresh: float = 0.05    # in normalized template units
    n_hypotheses: int = 128
    seed: int = 0


def _make_detector(kind: str, n: int):
    """Keypoint detector registry (the reference's detector enum,
    mtf.h:672-706)."""
    import cv2
    k = kind.lower()
    if k == "orb":
        return cv2.ORB_create(nfeatures=n)
    if k == "brisk":
        return cv2.BRISK_create()
    if k == "sift":
        return cv2.SIFT_create(nfeatures=n)
    if k == "akaze":
        return cv2.AKAZE_create()
    if k == "kaze":
        return cv2.KAZE_create()
    if k == "fast":
        return cv2.FastFeatureDetector_create()
    if k == "agast":
        return cv2.AgastFeatureDetector_create()
    if k == "gftt":
        return cv2.GFTTDetector_create(maxCorners=n)
    if k == "mser":
        return cv2.MSER_create()
    raise ValueError(f"unknown detector {kind!r}")


def _make_descriptor(kind: str, n: int):
    """Descriptor extractor registry (mtf.h:707-744). The detector-only
    families (FAST, AGAST, GFTT, MSER) have no compute(); they pair with
    any entry here through FeatureParams.descriptor."""
    k = kind.lower()
    if k in ("orb", "brisk", "sift", "akaze", "kaze"):
        return _make_detector(k, n)
    raise ValueError(f"descriptor {kind!r} cannot compute()")


_DETECT_ONLY = ("fast", "agast", "gftt", "mser")


def _to_u8(frame) -> np.ndarray:
    """A frame (H, W) or (H, W, C), numpy or a tensor on any device, as
    the 8-bit gray image OpenCV detects in."""
    if isinstance(frame, torch.Tensor):
        frame = frame.detach().cpu().numpy()
    a = np.asarray(frame)
    if a.ndim == 3:
        a = a.mean(axis=-1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _descr_float(desc: np.ndarray) -> np.ndarray:
    """Binary descriptors -> {0, 1} float rows (Hamming by matmul); float
    descriptors pass through L2-normalised."""
    if desc.dtype == np.uint8:
        return np.unpackbits(desc, axis=1).astype(np.float32)
    d = desc.astype(np.float32)
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)


def _match(d0: torch.Tensor, d1: torch.Tensor, v0=None, v1=None,
           ratio: float = 0.75):
    """Mutual-best match with the ratio test on the full distance matrix
    of each tracker, mask-aware (invalid rows and columns never match).

    d0 (..., K0, D) template rows, d1 (..., K1, D) current rows, {0, 1} or
    unit float; dist = |a|^2 + |b|^2 - 2ab term by term as the JAX
    package computes it (the Hamming distance for binary rows). Ties go to
    the first index, as `jnp.argmin`'s. -> (the index into d1 of each
    template row (..., K0), the match mask (..., K0))."""
    if v0 is None:
        v0 = torch.ones(d0.shape[:-1], dtype=torch.bool, device=d0.device)
    if v1 is None:
        v1 = torch.ones(d1.shape[:-1], dtype=torch.bool, device=d1.device)
    n0 = torch.sum(d0 * d0, dim=-1)[..., :, None]
    n1 = torch.sum(d1 * d1, dim=-1)[..., None, :]
    dist = n0 + n1 - 2.0 * torch.matmul(d0, d1.transpose(-1, -2))
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    dist = torch.where(v0[..., :, None] & v1[..., None, :], dist, inf)
    best1 = torch.argmin(dist, dim=-1)                          # (..., K0)
    dbest = torch.amin(dist, dim=-1)
    # the second best, for the ratio test
    masked = dist.scatter(-1, best1[..., None], float("inf"))
    dsecond = torch.amin(masked, dim=-1)
    # the mutual check
    best0 = torch.argmin(dist, dim=-2)                          # (..., K1)
    k0 = torch.arange(dist.shape[-2], device=dist.device)
    mutual = torch.gather(best0, -1, best1) == k0
    ok = (mutual & (dbest < (ratio ** 2) * dsecond) & v0
          & torch.isfinite(dbest))
    return best1, ok


class FeatureState(NamedTuple):
    """Fixed-size template sets of B trackers, with validity masks."""
    desc0: torch.Tensor   # (B, Kmax, D) float
    pts0_t: torch.Tensor  # (B, Kmax, 2) template-frame coordinates
    valid0: torch.Tensor  # (B, Kmax) bool
    step: torch.Tensor    # () int64 on the CPU: the update count (the
                          # RANSAC draw's; the JAX package splits a key)


class FeatureTracker(SearchMethod):
    """The 'feat' key: the reference's FeatureTracker over B trackers."""

    name = "feat"
    SALT = 5

    def __init__(self, ssm, prm: SMParams | None = None,
                 feat: FeatureParams | None = None):
        # AM-less (the reference's SearchMethod<void, SSM>): the base
        # class samples an SSD template that the tracker never reads
        super().__init__(get_am("ssd"), ssm, prm)
        self.feat = feat or FeatureParams()
        det, desc = self.feat.detector.lower(), self.feat.descriptor.lower()
        if not desc:
            desc = "orb" if det in _DETECT_ONLY else det
        self._detector = _make_detector(det, self.feat.max_keypoints)
        self._descriptor = (self._detector if desc == det
                            else _make_descriptor(desc,
                                                  self.feat.max_keypoints))
        self._desc_dim = None  # resolved at the first detection

    # -- host stage: OpenCV detection at fixed shapes ---------------------
    def _detect(self, img: np.ndarray, region_corners: np.ndarray | None):
        """Keypoints (n, 2) and descriptor rows (n, D) of an 8-bit image,
        in the window of `region_corners` (4, 2) grown by search_margin
        (the whole image for None); (empty, None) when nothing is found."""
        mask = None
        if region_corners is not None:
            import cv2
            mask = np.zeros(img.shape, np.uint8)
            c = np.mean(region_corners, axis=0)
            grown = c + self.feat.search_margin * (region_corners - c)
            cv2.fillConvexPoly(mask, grown.astype(np.int32), 255)
        if self._descriptor is self._detector:
            kps, desc = self._detector.detectAndCompute(img, mask)
        else:
            kps = self._detector.detect(img, mask)
            kps, desc = self._descriptor.compute(img, kps)
        if desc is None or len(kps) == 0:
            return np.zeros((0, 2), np.float32), None
        pts = np.asarray([k.pt for k in kps], np.float32)
        return pts, _descr_float(desc)

    def detect_fixed(self, frame, region_corners=None):
        """Host detection zero-padded to (Kmax, 2) / (Kmax, D) numpy
        arrays with a (Kmax,) validity mask: the device stage's static
        shapes."""
        K = self.feat.max_keypoints
        img = frame if isinstance(frame, np.ndarray) and \
            frame.dtype == np.uint8 else _to_u8(frame)
        pts, desc = self._detect(img, region_corners)
        if desc is None:
            D = self._desc_dim or 256
            return (np.zeros((K, 2), np.float32), np.zeros((K, D), np.float32),
                    np.zeros((K,), bool))
        self._desc_dim = desc.shape[1]
        k = min(len(pts), K)
        pp = np.zeros((K, 2), np.float32)
        dd = np.zeros((K, desc.shape[1]), np.float32)
        vv = np.zeros((K,), bool)
        pp[:k], dd[:k], vv[:k] = pts[:k], desc[:k], True
        return pp, dd, vv

    def detect_batch(self, frame, corners_img):
        """Each tracker's detections in its own window: corners_img
        (B, 4, 2) image corners -> pts (B, Kmax, 2), desc (B, Kmax, D),
        valid (B, Kmax) on the tracker's device. The frame goes to the
        host once for the B detections."""
        img = _to_u8(frame)
        c = np.asarray(torch.as_tensor(corners_img).detach().cpu(),
                       np.float32)
        out = [self.detect_fixed(img, c[b]) for b in range(c.shape[0])]
        d_max = max(o[1].shape[1] for o in out)
        # a tracker with no detection before the dimension is known
        # reads 256 columns: zero rows of the common width
        desc = np.zeros((len(out), self.feat.max_keypoints, d_max),
                        np.float32)
        for b, o in enumerate(out):
            desc[b, :, :o[1].shape[1]] = o[1]
        dev = self.device
        return (torch.as_tensor(np.stack([o[0] for o in out]), device=dev),
                torch.as_tensor(desc, device=dev),
                torch.as_tensor(np.stack([o[2] for o in out]), device=dev))

    # -- init ---------------------------------------------------------------
    def initialize(self, frame, corners_img) -> TrackerState:
        state = super().initialize(frame, corners_img)
        pts, desc, valid = self.detect_batch(frame, corners_img)
        if not bool(valid.any(-1).all()):
            raise ValueError("no features detected in an init region")
        # keep the keypoints inside each region, in its template frame
        pts_t = W.apply_warp(inv3x3(state.region.norm_mat), pts)
        bc = state.region.base_corners
        lo = (bc.amin(-2) - 1e-3)[:, None]
        hi = (bc.amax(-2) + 1e-3)[:, None]
        inside = (pts_t >= lo).all(-1) & (pts_t <= hi).all(-1) & valid
        # the whole search window where the region is sparse
        inside = torch.where((inside.sum(-1) >= self.feat.min_matches)[:, None],
                             inside, valid)
        fs = FeatureState(desc0=desc, pts0_t=pts_t, valid0=inside,
                          step=torch.zeros((), dtype=torch.int64))
        return state._replace(extra=fs)

    # -- device stage ---------------------------------------------------------
    def hyp_draw(self, step: int) -> torch.Tensor:
        """The (n_hypotheses, minimal sample) RANSAC index draw of update
        `step`, shared by the B trackers."""
        gen = seeded_generator(self.feat.seed, step, self.SALT, self.device)
        return ransac.hyp_indices(gen, self.feat.n_hypotheses,
                                  self.feat.max_keypoints,
                                  ransac.min_sample_size(self.ssm))

    def _update_multi(self, state: TrackerState, frames):
        raise multi_unported(self)

    def update_with_detections(self, state: TrackerState, pts, desc, valid,
                               idx: torch.Tensor | None = None
                               ) -> TrackerState:
        """Match detections (B, K1, 2) / (B, K1, D) / (B, K1), or one
        frame's (K1, ...) shared by the trackers, against each template
        set and fit the warp robustly; a tracker with fewer than
        min_matches matches or a non-finite fit keeps its state. `idx`:
        the RANSAC draw (default `hyp_draw` of the update count)."""
        fs: FeatureState = state.extra
        feat, ssm = self.feat, self.ssm
        b = fs.desc0.shape[0]
        if pts.dim() == 2:
            pts, desc, valid = (pts.expand(b, -1, -1), desc.expand(b, -1, -1),
                                valid.expand(b, -1))
        idx1, ok = _match(fs.desc0, desc, fs.valid0, valid,
                          feat.ratio_thresh)
        dst = W.apply_warp(inv3x3(state.region.norm_mat), pts)
        dst_t = torch.gather(dst, 1, idx1[..., None].expand(-1, -1, 2))
        wts = ok.to(torch.float32)
        if feat.estimator == "lsq":
            new_ssm = ssm.fit_pts(fs.pts0_t, dst_t, weights=wts)
        else:
            if idx is None and feat.estimator in ransac.SAMPLED:
                idx = self.hyp_draw(int(fs.step))
            new_ssm, _ = ransac.robust_fit(
                ssm, fs.pts0_t, dst_t, idx, method=feat.estimator,
                inlier_thresh=feat.inlier_thresh, weights=wts)
        # hold the last state on failure (the reference's behaviour)
        good = (ok.sum(-1) >= feat.min_matches) & \
            torch.isfinite(new_ssm).all(-1)
        new_ssm = torch.where(good[:, None], new_ssm, state.ssm_state)
        return state._replace(ssm_state=new_ssm,
                              extra=fs._replace(step=fs.step + 1))

    def _update(self, state: TrackerState, frame) -> TrackerState:
        pts, desc, valid = self.detect_batch(
            frame, image_corners(self.ssm, state))
        return self.update_with_detections(state, pts, desc, valid)
