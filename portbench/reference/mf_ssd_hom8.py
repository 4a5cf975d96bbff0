"""Plain reference of `mf_ssd_hom8`: Median Flow (Kalal, Mikolajczyk and
Matas, ICPR 2010) over M independent trackers, in plain PyTorch float32.

Per tracker, from its init corners: the template frame (a similarity N
from the centred, unit-scale square of the corners); a grid_res x
grid_res lattice of patch centres strictly inside the corners; each
patch a grid_patch_res x grid_patch_res lattice of offsets of half-size
grid_patch_scale / (grid_res + 1) template units.

One update from a warp W (template frame) on a frame, with the frame
before it:
  * the centres predicted by W; each patch rigid around its centre;
  * an image pyramid of grid_pyramid_levels levels of each frame: level
    l the frame resized to (H >> l, W >> l), bilinear with antialiasing;
  * the patches' templates from the previous frame's pyramid at the
    predicted centres, standardised (zero mean, unit population standard
    deviation + 1e-6);
  * forward flow, coarse to fine: per level a window per tracker of
    `crop` px at level 0 and max(48, crop / 2^l + 16) px above, at
    floor(min) - 4 of the level's points; grid_sub_iters iterations of
    a 2-DOF Lucas-Kanade step per patch on the standardised samples
    (dense linear taps clamped into the window, the Jacobian the image
    gradient times the level's scale, the 2x2 system damped by 1e-6 on
    its diagonal and solved in closed form), each level starting from
    the flow so far;
  * the same backwards on the previous frame from the moved patches,
    against templates from the current frame at the moved centres;
  * a patch whose forward-backward round trip misses by grid_fb_err px
    or more (in image px) is left out, unless fewer than 4 are left;
  * the median-flow similarity: the scale is the median over pairs of
    kept patches of the ratio of their distances after and before, the
    translation the median over kept patches of dst - scale * src per
    axis (a median of an even count is the mean of its middle two);
  * the new warp is that similarity of the init centres; the corners are
    N W c of the base corners.

Nothing of the program is imported or read: the frames and corners come
from the benchmark, and the warp before an update is recovered from the
corners the program reported for the step before (the warp, the previous
frame and the init geometry are all the state that Median Flow carries)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import _plain as P

WINDOW_MARGIN = 4.0
MIN_KEPT = 4             # the homography's minimal sample


def _unit_square_to(c: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) homographies taking the centred unit square onto the
    corner quads c (M, 4, 2) (ul, ur, lr, ll)."""
    sq = torch.tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                      dtype=c.dtype, device=c.device).expand(c.shape)
    return P.four_point(sq, c)


def _standardize(p: torch.Tensor) -> torch.Tensor:
    mu = p.mean(-1, keepdim=True)
    sd = torch.sqrt(((p - mu) ** 2).mean(-1, keepdim=True))
    return (p - mu) / (sd + 1e-6)


def _pyramid(frame: torch.Tensor, levels: int) -> list:
    h, w = frame.shape[-2:]
    out = [frame]
    for lvl in range(1, levels):
        out.append(F.interpolate(frame[:, None], size=(h >> lvl, w >> lvl),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)[:, 0])
    return out


def _level(norm: torch.Tensor, lvl: int) -> torch.Tensor:
    d = torch.tensor([0.5 ** lvl, 0.5 ** lvl, 1.0], dtype=norm.dtype,
                     device=norm.device)
    return d[:, None] * norm


def _templates(pyr, norm, centres, offsets) -> list:
    """Per level (M, P, n) standardised patches of the level frames."""
    pts = centres[:, :, None] + offsets[:, None]               # (M, P, n, 2)
    m, p, n, _ = pts.shape
    out = []
    for lvl, img in enumerate(pyr):
        v = P.sample_full(img, P.apply(_level(norm, lvl),
                                       pts.reshape(m, p * n, 2)))[0]
        out.append(_standardize(v.reshape(m, p, n)))
    return out


def _solve2(h00, h01, h11, g0, g1, eps=1e-12):
    det = h00 * h11 - h01 * h01
    det = torch.where(det.abs() < eps, torch.sign(det) * eps + eps, det)
    return (h11 * g0 - h01 * g1) / det, (h00 * g1 - h01 * g0) / det


def _flow(pyr, norm, pts_base, templ, iters: int, crop: int):
    """The (M, P, 2) template-frame flow of every patch, coarse to fine."""
    m, p, n, _ = pts_base.shape
    disp = torch.zeros((m, p, 2), dtype=pts_base.dtype,
                       device=pts_base.device)
    for lvl in reversed(range(len(pyr))):
        img = pyr[lvl]
        hl, wl = img.shape[-2:]
        size = crop if lvl == 0 else max(48, (crop >> lvl) + 16)
        hc, wc = min(size, hl), min(size, wl)
        nl = _level(norm, lvl)
        pts = P.apply(nl, (pts_base + disp[:, :, None]).reshape(m, p * n, 2))
        x0 = P.crop_origin(pts[..., 0], wc, wl, WINDOW_MARGIN)
        y0 = P.crop_origin(pts[..., 1], hc, hl, WINDOW_MARGIN)
        s = nl[:, 0, 0][:, None, None]
        px = pts[..., 0].reshape(m, p, n)
        py = pts[..., 1].reshape(m, p, n)
        t = templ[lvl]
        d = torch.zeros_like(disp)
        for _ in range(iters):
            x = (px + d[..., 0:1] * s).reshape(m, p * n)
            y = (py + d[..., 1:2] * s).reshape(m, p * n)
            val, dx, dy = P.sample(img, x, y, x0, y0, hc, wc)
            v = val.reshape(m, p, n)
            c = v - v.sum(-1, keepdim=True) / n
            v = c / (torch.sqrt((c * c).sum(-1, keepdim=True) / n) + 1e-6)
            r = v - t
            jx = dx.reshape(m, p, n) * s
            jy = dy.reshape(m, p, n) * s
            u0, u1 = _solve2((jx * jx).sum(-1) + 1e-6, (jx * jy).sum(-1),
                             (jy * jy).sum(-1) + 1e-6, (jx * r).sum(-1),
                             (jy * r).sum(-1))
            d = d - torch.stack([u0, u1], -1)
        disp = disp + d
    return disp


def _median(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of the entries where `ok` (the mean of
    the middle two of an even count); NaN where none is."""
    k = ok.sum(-1, keepdim=True)
    srt = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf"))),
                     dim=-1).values
    lo = srt.gather(-1, ((k - 1) // 2).clamp(min=0))
    hi = srt.gather(-1, (k // 2).clamp(max=x.shape[-1] - 1))
    return torch.where(k > 0, 0.5 * (lo + hi),
                       torch.full_like(lo, float("nan")))[..., 0]


def track(cfg: dict, frame0, corners0, corners_prev, frame_prev, frame):
    """One update of M trackers -> corners (M, 4, 2): corners0 (M, 4, 2)
    the init corners, corners_prev the corners after the step before,
    frame_prev and frame (M, H, W) the frames before and of this update
    (`frame0` is not read: the templates are the previous frame's)."""
    del frame0
    o = cfg["tracker"]["options"]
    res, pres = int(o["grid_res"]), int(o["grid_patch_res"])
    scale = float(o.get("grid_patch_scale", 1.0))
    iters, levels = int(o["grid_sub_iters"]), int(o["grid_pyramid_levels"])
    fb_err, crop = float(o["grid_fb_err"]), int(o["crop"])
    dev = frame.device
    m = frame.shape[0]
    corners0 = corners0.float()
    norm = P.norm_frame(corners0)
    base_c = P.apply(P.inv_norm(norm), corners0)
    r = torch.linspace(-0.5, 0.5, res + 2, dtype=torch.float32,
                       device=dev)[1:-1]
    cy, cx = torch.meshgrid(r, r, indexing="ij")
    unit = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)
    centres0 = P.apply(_unit_square_to(base_c), unit.expand(m, -1, -1))
    half = scale / (res + 1)
    o1 = torch.linspace(-half, half, pres, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(o1, o1, indexing="ij")
    offsets = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1).expand(
        m, -1, -1)
    wt = P.state_from_corners(norm, base_c, corners_prev.float())
    pred = P.apply(wt, centres0)                                # (M, P, 2)
    pts_base = pred[:, :, None] + offsets[:, None]
    cur, prev = _pyramid(frame, levels), _pyramid(frame_prev, levels)
    disp = _flow(cur, norm, pts_base, _templates(prev, norm, pred, offsets),
                 iters, crop)
    moved = pred + disp
    back = _flow(prev, norm, pts_base + disp[:, :, None],
                 _templates(cur, norm, moved, offsets), iters, crop)
    fb = torch.linalg.vector_norm(disp + back, dim=-1) * norm[:, 0, 0, None]
    ok = fb < fb_err
    ok = torch.where(ok.sum(-1, keepdim=True) >= MIN_KEPT, ok,
                     torch.ones_like(ok))
    p = ok.shape[-1]
    pair = ok[:, :, None] & ok[:, None, :] & ~torch.eye(
        p, dtype=torch.bool, device=dev)
    d_src = torch.linalg.vector_norm(centres0[:, :, None] - centres0[:, None],
                                     dim=-1)
    d_dst = torch.linalg.vector_norm(moved[:, :, None] - moved[:, None],
                                     dim=-1)
    ratio = d_dst / torch.clamp(d_src, min=1e-8)
    s = torch.nan_to_num(_median(ratio.reshape(m, p * p),
                                 pair.reshape(m, p * p)), nan=1.0)
    t = moved - s[:, None, None] * centres0
    okk = ok[:, None].expand(m, 2, p)
    tr = torch.nan_to_num(_median(t.transpose(1, 2), okk), nan=0.0)
    sim = torch.zeros((m, 3, 3), dtype=torch.float32, device=dev)
    sim[:, 0, 0] = sim[:, 1, 1] = s
    sim[:, :2, 2] = tr
    sim[:, 2, 2] = 1.0
    return P.apply(norm @ sim, base_c)
