"""Synthetic warped sequences with exact ground truth (port of
`mtf_tpu/utils/synth.py`).

The warp trajectory is drawn from numpy `default_rng(seed)` as in the
JAX package, so both packages render the same sequence from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W


def full_grid(h: int, w: int, dtype=torch.float32, device=None):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def warp_image(img: torch.Tensor, warp_mat: torch.Tensor,
               kind: str = interp.CUBIC) -> torch.Tensor:
    """Render I'(x) = I(W^-1 x): the scene moves by `warp_mat`."""
    img3 = img[..., None] if img.dim() == 2 else img
    h, w, c = img3.shape
    pts = W.apply_warp(torch.linalg.inv(warp_mat),
                       full_grid(h, w, img3.dtype, img3.device))
    out = interp.sample(img3, pts, kind).reshape(h, w, c)
    return out[..., 0] if img.dim() == 2 else out


def synthetic_sequence(img, corners0, ssm, n_frames: int,
                       sigma_scale: float = 0.02, seed: int = 0,
                       noise_sigma: float = 0.0, gain_drift: float = 0.0,
                       bias_drift: float = 0.0):
    """Random-walk warp trajectory rendered as a frame sequence.

    corners0: (4, 2), or (M, 4, 2) for M objects riding one global scene
    warp. Frames are rendered on the device of `ssm`.

    Returns (frames (T, H, W[, C]) float32 tensor,
             gt_corners (T, 4, 2) or (T, M, 4, 2) numpy)."""
    dev = ssm.generators.device
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    corners0 = np.asarray(corners0, np.float32)
    rng = np.random.default_rng(seed)
    flat = corners0.reshape(-1, 2)
    c = np.mean(flat, axis=0)
    scale = float(np.mean(np.linalg.norm(flat - c, axis=-1)))
    T = np.array([[scale, 0.0, c[0]], [0.0, scale, c[1]], [0.0, 0.0, 1.0]],
                 np.float32)
    Tinv = np.linalg.inv(T)
    corners_t = torch.as_tensor(corners0, device=dev)
    state = torch.zeros(ssm.dof, dtype=torch.float32, device=dev)
    frames, gt = [], []
    for t in range(n_frames):
        Wimg = T @ ssm.to_matrix(state).cpu().numpy() @ Tinv
        Wimg_t = torch.as_tensor(Wimg, dtype=torch.float32, device=dev)
        frame = warp_image(img, Wimg_t)
        if gain_drift or bias_drift:
            frame = frame * (1.0 + gain_drift * t) + bias_drift * t
        if noise_sigma > 0:
            frame = frame + torch.as_tensor(
                rng.normal(0, noise_sigma, tuple(frame.shape)),
                dtype=torch.float32, device=dev)
        frames.append(frame)
        gt.append(W.apply_warp(Wimg_t, corners_t).cpu().numpy())
        dp = rng.normal(0, sigma_scale, ssm.dof).astype(np.float32)
        state = ssm.compositional_update(
            state, torch.as_tensor(dp, device=dev))
    return torch.stack(frames), np.stack(gt)


def mean_corner_distance(c1, c2) -> float:
    """Mean corner distance (the reference's MCD tracking error) between
    corner sets (..., 4, 2), tensors or arrays, over every corner."""
    c1, c2 = (np.asarray(c.detach().cpu() if torch.is_tensor(c) else c)
              for c in (c1, c2))
    return float(np.mean(np.linalg.norm(c1 - c2, axis=-1)))
