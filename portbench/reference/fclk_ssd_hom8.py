"""Plain reference of `fclk_ssd_hom8`: forward compositional Lucas-Kanade
(FCLK) on the SSD appearance model and the 8-DOF homography, over M
independent trackers, in plain PyTorch float32.

Per tracker, from its init frame and corners:
  * the template frame: a similarity N taking the centred, unit-scale
    square of the init corners to the image; a resx x resy grid of base
    points inside the corners (the 4-point homography from the unit
    square);
  * the template: the init frame sampled at the base points (whole-frame
    window); its pixel Jacobian over the 8 parameters at the identity,
    sampled in a `crop` window (origin floor(min) - 2), and the
    Gauss-Newton matrix A = J^T J (the self0 Hessian); for each coarse
    phase (stride s, iterations k) of `coarse_pt_iters`, the same on the
    init frame blurred by the stride's binomial taps, at the stride-
    decimated points.
One update from a warp W (template frame, h22 = 1) on a frame: a `crop`
window per tracker at floor(min) - 4 of the points at W; the coarse
phases, then the full grid, up to `max_iters` iterations in all (epsilon
0: every iteration runs); each iteration samples the (blurred) frame at
N W p in the window, forms the steepest-descent images J through the
quotient rule of the projection, g = J^T (template - value), solves
(A + 1e-7 I) dp = g and composes W <- W (I + sum dp_i G_i), normalised.
The tracker's corners are N W c of its base corners c.

Nothing of the program is imported or read: the frames and corners come
from the benchmark, and the warp before an update is recovered from the
corners the program reported for the step before (the state it carries
from one update to the next is that warp alone)."""
from __future__ import annotations

import torch

from portbench.reference import _plain as P

INIT_MARGIN = 2.0        # the init Jacobian's window: floor(min) - 2
UPDATE_MARGIN = 4.0      # an update's window: floor(min) - 4
DAMP = 1e-7


def _grid(resx: int, resy: int, device) -> torch.Tensor:
    xs = torch.linspace(-0.5, 0.5, resx, dtype=torch.float32, device=device)
    ys = torch.linspace(-0.5, 0.5, resy, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _jac(m0, gens, pts_t, dx, dy):
    """Steepest-descent images (M, S, K) at template points pts_t (M, K,
    2) under image warps m0 (M, 3, 3): sum over x, y of the image
    derivative times the projection's quotient-rule derivative."""
    ph = torch.cat([pts_t, torch.ones_like(pts_t[..., :1])], -1)  # (M,K,3)
    q = (m0[:, None] * ph[:, :, None, :]).sum(-1)                # (M,K,3)
    winv = 1.0 / q[..., 2]
    xr, yr = q[..., 0] * winv, q[..., 1] * winv
    mg = (m0[:, None, :, :, None] * gens[None, :, None, :, :]).sum(-2)
    qs = (mg[:, :, None] * ph[:, None, :, None, :]).sum(-1)      # (M,S,K,3)
    jx = (qs[..., 0] - xr[:, None] * qs[..., 2]) * winv[:, None]
    jy = (qs[..., 1] - yr[:, None] * qs[..., 2]) * winv[:, None]
    return jx * dx[:, None] + jy * dy[:, None], xr, yr


def _project(m0, pts_t):
    ph = torch.cat([pts_t, torch.ones_like(pts_t[..., :1])], -1)
    q = (m0[:, None] * ph[:, :, None, :]).sum(-1)
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]


def _gram(j):
    """J J^T (M, S, S) by elementwise products (no TF32)."""
    return (j[:, :, None] * j[:, None]).sum(-1)


def track(cfg: dict, frame0, corners0, corners_prev, frame_prev, frame):
    """One update of M trackers -> corners (M, 4, 2). frame0 (M, H, W) and
    corners0 (M, 4, 2): the init frames and corners; corners_prev (M, 4,
    2): the corners after the step before (corners0 for the first update);
    frame (M, H, W): the frame of this update (`frame_prev` is not read)."""
    del frame_prev
    o = cfg["tracker"]["options"]
    if o.get("hess_type", "self0") != "self0" or o.get("epsilon", 0) > 0:
        raise ValueError("the reference runs self0 with epsilon 0 only")
    resx, resy, crop = int(o["resx"]), int(o["resy"]), int(o["crop"])
    max_iters = int(o["max_iters"])
    phases_cfg = [tuple(int(v) for v in p) for p in o["coarse_pt_iters"]]
    dev = frame.device
    m, h, w = frame.shape
    hc, wc = min(crop, h), min(crop, w)
    gens = P.generators(dev)
    corners0 = corners0.float()
    norm = P.norm_frame(corners0)
    ninv = P.inv_norm(norm)
    sq = torch.tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                      dtype=torch.float32, device=dev).expand(m, 4, 2)
    grid_img = P.apply(P.four_point(sq, corners0),
                       _grid(resx, resy, dev).expand(m, -1, -1))
    base = P.apply(ninv, grid_img)                      # (M, N, 2)
    base_c = P.apply(ninv, corners0)
    # the template and its Gauss-Newton matrices, per phase
    templ_full = P.sample_full(frame0, P.apply(norm, base))[0]
    phases = []
    for stride, n_it in phases_cfg + [(1, max_iters)]:
        img0 = P.blur(frame0, stride)
        xr, yr = _project(norm, base)
        x0 = P.crop_origin(xr, wc, w, INIT_MARGIN)
        y0 = P.crop_origin(yr, hc, h, INIT_MARGIN)
        val, dx, dy = P.sample(img0, xr, yr, x0, y0, hc, wc)
        j = _jac(norm, gens, base, dx, dy)[0]
        r = torch.arange(0, resy, stride, device=dev)
        c = torch.arange(0, resx, stride, device=dev)
        idx = (r[:, None] * resx + c[None]).reshape(-1)
        tp = templ_full if stride == 1 else val[:, idx]
        a = _gram(j[:, :, idx]) + DAMP * torch.eye(8, device=dev)
        phases.append((stride, n_it, idx, tp, a))
    # the update, from the warp the previous corners give
    wt = P.state_from_corners(norm, base_c, corners_prev.float())
    xr, yr = _project(norm @ wt, base)
    x0 = P.crop_origin(xr, wc, w, UPDATE_MARGIN)
    y0 = P.crop_origin(yr, hc, h, UPDATE_MARGIN)
    it = 0
    for stride, n_it, idx, tp, a in phases:
        img = P.blur(frame, stride)
        hi = max_iters if stride == 1 else min(it + n_it, max_iters)
        pts = base[:, idx]
        while it < hi:
            m0 = norm @ wt
            xr, yr = _project(m0, pts)
            val, dx, dy = P.sample(img, xr, yr, x0, y0, hc, wc)
            j = _jac(m0, gens, pts, dx, dy)[0]
            g = (j * (tp - val)[:, None]).sum(-1)
            dp = torch.linalg.solve(a, g)
            wt = wt @ (torch.eye(3, device=dev)
                       + (dp[:, :, None, None] * gens[None]).sum(1))
            wt = wt / wt[:, 2:3, 2:3]
            it += 1
    return P.apply(norm @ wt, base_c)
