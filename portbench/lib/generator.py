"""The one generator of traffic: frames, targets and their exact ground
truth (GT), made from `--seed` on the device, from a mix's parameters
(`traffic/<mix>.json`).

A mix's keys:

    pool_seed         the seed the mix's cameras (scene, targets, walks)
                      are drawn from; a run's `--seed` draws their order
    frames            "per_camera": each camera sends its own frame a step
                      and the fleet steps through `update_multi` on the
                      (B, H, W) stack (the one kind there is)
    frames_per_camera T frames rendered per camera; frame 0 is the scene
    play              "ping_pong": steps show frames 1, 2, .., T-1, T-2,
                      .., 0, 1, .. so that the motion never stops
    walk_sigma        the standard deviation of each 8-DOF homography
                      parameter's step of the random walk, in the target's
                      normalised frame (centroid at 0, unit mean corner
                      distance), per camera
    targets           {"cx": [lo, hi], "cy": [lo, hi], "half": [lo, hi]}:
                      axis-aligned squares, centre and half-size uniform
    fail_mcd_px       a tracker-update whose mean corner distance from the
                      GT is over it, or not finite, counts as failed

Every camera initialises on frame 0 of its stream, which is the scene:
the program's `initialize` takes one frame for the whole fleet. From
frame 1 on, camera b shows the scene under its own walk, so the B frames
of a step are B distinct images.

Every run of a cell plays the same B cameras, drawn from the mix's
`pool_seed`: the run's seed only shuffles which slot of the fleet each
camera takes (and draws the check's samples, `lib/check.py`). So every
seed does the same work and reads the same accuracy: with the scene,
the targets and the walks drawn from the run's seed, the mean corner
distance of a cell moved by 1.6% from seed to seed, the two runs of one
seed alike, because all B trackers share the one scene.

The scene is a random texture with the spectrum of natural images (white
noise whose Fourier amplitude falls as 1/f, scaled to 0-255), the frames
are its bicubic renderings under the walk's warps (`I_t(x) = S(W_t^-1
x)`), and the GT corners are the warps applied to the targets' corners.
A smoother texture (amplitude 1/f^2, twice-integrated noise) leaves a
seed's whole scene to its few largest waves: targets on near-planar
ramps, which FCLK loses, in numbers that change from seed to seed."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# 8-DOF homography I + sum_i p_i G_i, the parameters (tx, ty, h00 - 1,
# h01, h10, h11 - 1, h20, h21)
_GENS = np.zeros((8, 3, 3))
for _i, (_r, _c) in enumerate([(0, 2), (1, 2), (0, 0), (0, 1), (1, 0),
                               (1, 1), (2, 0), (2, 1)]):
    _GENS[_i, _r, _c] = 1.0
RENDER_CHUNK = 64        # frames rendered per call


class Streams(NamedTuple):
    init_frame: torch.Tensor    # (H, W): every tracker initialises on it
    pool: torch.Tensor          # (T, B, H, W): frame t of each camera
    corners0: np.ndarray        # (B, 4, 2) float32, the targets on frame 0
    gt: np.ndarray              # (T, B, 4, 2) float64 GT corners


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of one of the run's streams of draws."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def frame_index(step: int, t: int) -> int:
    """The frame (0..t-1) that step `step` shows under ping-pong play;
    step 0 is the initialisation on frame 0."""
    if t == 1:
        return 0
    m = step % (2 * (t - 1))
    return m if m < t else 2 * (t - 1) - m


def frames_at(streams: Streams, step: int) -> torch.Tensor:
    """The frames step `step` hands the fleet: a (B, H, W) view of the
    pool."""
    return streams.pool[frame_index(step, streams.pool.shape[0])]


def scene(h: int, w: int, seed: int, device) -> torch.Tensor:
    """(H, W) float32 texture on `device` from `seed`: white noise whose
    Fourier amplitude is divided by the frequency (cycles per pixel, at
    least one cycle per frame), scaled to 0-255."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    noise = torch.randn((h, w), generator=gen, device=device,
                        dtype=torch.float32).double()
    fy = torch.fft.fftfreq(h, device=device, dtype=torch.float64)[:, None]
    fx = torch.fft.rfftfreq(w, device=device, dtype=torch.float64)[None]
    f = torch.sqrt(fx * fx + fy * fy).clamp(min=1.0 / max(h, w))
    img = torch.fft.irfft2(torch.fft.rfft2(noise) / f, s=(h, w))
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.float()


def targets(n: int, spec: dict, r: np.random.Generator) -> np.ndarray:
    """(n, 4, 2) float32 squares (ul, ur, lr, ll)."""
    cx = r.uniform(*spec["cx"], n)
    cy = r.uniform(*spec["cy"], n)
    s = r.uniform(*spec["half"], n)
    x = np.stack([cx - s, cx + s, cx + s, cx - s], -1)
    y = np.stack([cy - s, cy - s, cy + s, cy + s], -1)
    return np.stack([x, y], -1).astype(np.float32)


def _norm(corners: np.ndarray) -> np.ndarray:
    """(..., 3, 3) similarity taking a target's normalised frame (centroid
    0, unit mean corner distance) to the image, from corners (..., M, 2)."""
    c = corners.mean(-2)
    s = np.linalg.norm(corners - c[..., None, :], axis=-1).mean(-1)
    t = np.zeros(corners.shape[:-2] + (3, 3))
    t[..., 0, 0] = t[..., 1, 1] = s
    t[..., :2, 2] = c
    t[..., 2, 2] = 1.0
    return t


def walk(n: int, t: int, sigma: float, r: np.random.Generator) -> np.ndarray:
    """(n, t, 3, 3) compositional random walks of the homography from the
    identity, in the normalised frame, h22 = 1."""
    out = np.zeros((n, t, 3, 3))
    m = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    for k in range(t):
        out[:, k] = m
        dp = r.normal(0.0, sigma, (n, 8))
        m = m @ (np.eye(3) + np.einsum("ns,sij->nij", dp, _GENS))
        m = m / m[:, 2:3, 2:3]
    return out


def apply(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """dehom(H @ hom(p)) for (..., 3, 3) and (..., M, 2)."""
    q = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], -1) \
        @ np.swapaxes(h, -1, -2)
    return q[..., :2] / q[..., 2:3]


def render(img: torch.Tensor, warps: np.ndarray, out: torch.Tensor) -> None:
    """out[i] = img under warps[i] (image-frame (n, 3, 3)): bicubic, the
    border replicated."""
    h, w = img.shape
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    inv = torch.as_tensor(np.linalg.inv(warps), device=dev)
    for a in range(0, len(warps), RENDER_CHUNK):
        m = inv[a:a + RENDER_CHUNK]
        q = pix @ m.transpose(1, 2)                          # (n, HW, 3)
        gx = q[..., 0] / q[..., 2] * (2.0 / (w - 1)) - 1.0
        gy = q[..., 1] / q[..., 2] * (2.0 / (h - 1)) - 1.0
        grid = torch.stack([gx, gy], -1).float().reshape(-1, h, w, 2)
        src = img[None, None].expand(grid.shape[0], 1, h, w)
        out[a:a + RENDER_CHUNK] = F.grid_sample(
            src, grid, mode="bicubic", padding_mode="border",
            align_corners=True)[:, 0]


def make(mix: dict, cameras: int, height: int, width: int, seed: int,
         device) -> Streams:
    """The run's frames and GT: the mix's cameras in the order `seed`
    draws."""
    t = int(mix["frames_per_camera"])
    if mix.get("play", "ping_pong") != "ping_pong":
        raise ValueError(f"unknown play {mix['play']!r}")
    if mix["frames"] != "per_camera":
        raise ValueError(f"unknown frames {mix['frames']!r}")
    pool_seed = int(mix["pool_seed"])
    order = rng(seed, 5).permutation(cameras)
    img = scene(height, width, pool_seed, device)
    corners0 = targets(cameras, mix["targets"], rng(pool_seed, 1))[order]
    c0 = corners0.astype(np.float64)
    nrm = _norm(c0)                                          # (B, 3, 3)
    walks = walk(cameras, t, float(mix["walk_sigma"]),
                 rng(pool_seed, 2))[order]
    w_img = nrm[:, None] @ walks @ np.linalg.inv(nrm)[:, None]
    gt = apply(w_img, c0[:, None]).transpose(1, 0, 2, 3)     # (T, B, 4, 2)
    pool = torch.empty((t, cameras, height, width), dtype=torch.float32,
                       device=device)
    pool[0].copy_(img.expand(cameras, height, width))
    for k in range(1, t):
        render(img, w_img[:, k], pool[k])
    return Streams(img, pool, corners0, gt)
