"""Forward-compositional Lucas-Kanade, chain-fused path (port of the
`LKBase`/`FCLK` fast path in `mtf_tpu/sm/lk.py`).

Slice: SSD appearance, 8-DOF homography, dense linear sampling
(`interp="linear_mm"`) from a window of `crop` pixels hoisted out of the
iteration loop, selft Hessian (for SSD exactly -J^T J) and optional
coarse-to-fine point decimation (`coarse_pt_iters`). Every Gauss-Newton
iteration is one call of the chain kernel (`lk_fused_chain`) for all B
trackers; the 3x3 warp algebra and the 8x8 solve stay in PyTorch.

The update runs a fixed number of iterations (`epsilon <= 0`, the
fixed-iteration mode of the JAX package), so every tracker takes the same
steps and no done mask is needed.

Unlike the JAX fast path, which casts the frame to bf16 for the TPU's
MXU before the blur and crop, the window stays float32 here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.kernels.lk_fused import lk_fused_chain
from mtf_tpu_torch.ops.linalg import neg_def_solve
from mtf_tpu_torch.sm.core import SearchMethod, TrackerState
from mtf_tpu_torch.ssm.projective import Homography

# crop margin of the hoisted window: covers the motion within one update
# and the widest binomial support of the coarse phases
_CROP_MARGIN = 4.0


class LKCache(NamedTuple):
    """Per-tracker quantities cached at init."""
    J0: torch.Tensor     # (B, N, S) template pixel Jacobian at identity
    H0: torch.Tensor     # (B, S, S) initial self Hessian, -J0^T J0
    coarse: tuple = ()   # per coarse phase (templ_s (B, n_s), H0_s (B, S, S),
                         # J_s (B, n_s, S)) sampled from the blurred init
                         # frame at the decimated grid


def _coarse_idx(ry: int, rx: int, stride: int) -> torch.Tensor:
    """Row-major indices of the stride-decimated (ry, rx) point grid."""
    r = np.arange(0, ry, stride)
    c = np.arange(0, rx, stride)
    return torch.as_tensor((r[:, None] * rx + c[None, :]).ravel())


def _binomial(stride: int) -> np.ndarray:
    """Binomial low-pass taps for a stride-decimated phase
    (sigma ~ stride / 2)."""
    k = np.array([1.0], np.float64)
    for _ in range(2 * (stride - 1)):
        k = np.convolve(k, [0.5, 0.5])
    return k.astype(np.float32)


def _blur2(img: torch.Tensor, stride: int) -> torch.Tensor:
    """Separable edge-padded binomial blur of an (H, W) image, as
    shift-adds in float32 (`conv2d` would run in TF32 through cuDNN)."""
    if stride <= 1:
        return img
    k = _binomial(stride)
    r = (k.shape[0] - 1) // 2
    h, w = img.shape
    f = F.pad(img.to(torch.float32)[None, None], (r, r, r, r),
              mode="replicate")[0, 0]
    fh = sum(float(k[i]) * f[:, i:i + w] for i in range(len(k)))
    fv = sum(float(k[j]) * fh[j:j + h] for j in range(len(k)))
    return fv.to(img.dtype)


def _homogeneous(base_pts: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) -> (B, 3, N) homogeneous base points."""
    return W.homogenize(base_pts).transpose(1, 2).contiguous()


class FCLK(SearchMethod):
    """Forward compositional LK on the chain-fused path."""

    name = "fclk"

    def __init__(self, am, ssm, prm):
        super().__init__(am, ssm, prm)
        need = {
            "am 'ssd'": am.name == "ssd",
            "ssm '8'": isinstance(ssm, Homography),
            "interp 'linear_mm'": prm.interp == "linear_mm",
            "border 'replicate'": prm.border == "replicate",
            "a crop window": prm.crop is not None,
            "hess_type 'selft'": prm.hess_type == "selft",
            "epsilon <= 0 (fixed iterations)": prm.epsilon <= 0.0,
        }
        missing = [k for k, ok in need.items() if not ok]
        if missing:
            raise NotImplementedError(
                f"FCLK is ported for {', '.join(need)} only; this "
                f"configuration lacks {', '.join(missing)}. The other LK "
                "options come with ROADMAP Queue 1, slices 2 and 4")
        for i, (stride, _) in enumerate(prm.coarse_pt_iters):
            self.register_buffer(
                f"coarse_idx{i}",
                _coarse_idx(am.prm.resy, am.prm.resx, stride).to(self.device))

    def _coarse_index(self, i: int) -> torch.Tensor:
        return getattr(self, f"coarse_idx{i}")

    # -- init ----------------------------------------------------------
    def _patch_and_jac0(self, region, frame):
        """Patch (B, N, 1) and pixel Jacobian (B, N, S) at the identity
        warp, through the analytic chain: the dense-sampling gradient
        times the quotient-rule warp Jacobian."""
        ssm = self.ssm
        M = region.norm_mat @ ssm.to_matrix(ssm.identity(
            region.norm_mat.shape[:-2]))
        ph = _homogeneous(region.base_pts)                   # (B, 3, N)
        Q = M @ ph
        winv = 1.0 / Q[:, 2]
        xr, yr = Q[:, 0] * winv, Q[:, 1] * winv
        Qs = (M[:, None] @ ssm.generators[None]) @ ph[:, None]  # (B,S,3,N)
        jx = (Qs[:, :, 0] - xr[:, None] * Qs[:, :, 2]) * winv[:, None]
        jy = (Qs[:, :, 1] - yr[:, None] * Qs[:, :, 2]) * winv[:, None]
        pts = torch.stack([xr, yr], dim=-1)                  # (B, N, 2)
        patch, grad = interp.sample_dense(frame, pts, "linear",
                                          crop=self.prm.crop)
        J = (grad[:, :, 0, 0:1] * jx.transpose(1, 2)
             + grad[:, :, 0, 1:2] * jy.transpose(1, 2))      # (B, N, S)
        return patch, J

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        if frame.dim() != 2:
            raise NotImplementedError(
                "multi-channel frames come with ROADMAP Queue 1, slice 4")
        _, J0 = self._patch_and_jac0(state.region, frame)
        coarse = []
        for i, (stride, _) in enumerate(self.prm.coarse_pt_iters):
            idx = self._coarse_index(i)
            p_b, J_b = self._patch_and_jac0(state.region,
                                            _blur2(frame, stride))
            Js = J_b[:, idx]
            coarse.append((p_b[:, idx, 0], -(Js.transpose(1, 2) @ Js), Js))
        return LKCache(J0=J0, H0=-(J0.transpose(1, 2) @ J0),
                       coarse=tuple(coarse))

    # -- one Gauss-Newton iteration ------------------------------------
    def _iteration(self, state: TrackerState, ssm_state: torch.Tensor,
                   window: torch.Tensor, offs3: torch.Tensor,
                   ph: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
        """Chain-fused iteration: M0 = norm o W(p) shifted into window
        coordinates, the kernel, then the damped selft solve."""
        ssm = self.ssm
        M0 = state.region.norm_mat @ ssm.to_matrix(ssm_state)
        # window coords: rows 0/1 minus offset * row 2
        M0 = (M0 - offs3[:, :, None] * M0[:, 2:3, :]).contiguous()
        _, g, jtj = lk_fused_chain(window, M0, ssm.generators, ph, templ)
        # SSD: selft == -J^T J at the current J
        S = ssm.dof
        Hd = -jtj - 1e-7 * torch.eye(S, dtype=jtj.dtype, device=jtj.device)
        return ssm.compositional_update(ssm_state, neg_def_solve(Hd, g))

    # -- full update ----------------------------------------------------
    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        prm, ssm = self.prm, self.ssm
        h, w = frame.shape
        hc, wc = min(prm.crop, h), min(prm.crop, w)
        # one window per tracker for the whole update, from the points at
        # the pre-update state; the margin absorbs the motion within it
        pts0 = W.apply_warp(state.region.norm_mat,
                            ssm.warp_pts(state.ssm_state,
                                         state.region.base_pts))
        x0 = interp.crop_origin(pts0[..., 0], wc, w, _CROP_MARGIN)
        y0 = interp.crop_origin(pts0[..., 1], hc, h, _CROP_MARGIN)
        # the shared frame is blurred once per coarse stride, then every
        # variant is cropped for all trackers in one stacked gather
        strides = [st for st, _ in prm.coarse_pt_iters if st > 1]
        stk = torch.stack([frame] + [_blur2(frame, st) for st in strides])
        dev = frame.device
        rows = y0.long()[:, None] + torch.arange(hc, device=dev)
        cols = x0.long()[:, None] + torch.arange(wc, device=dev)
        win = stk[:, rows[:, :, None], cols[:, None, :]]     # (V, B, hc, wc)
        offs3 = torch.stack([x0, y0, torch.zeros_like(x0)], dim=-1)
        ph_full = _homogeneous(state.region.base_pts)

        ssm_state = state.ssm_state
        it = 0
        for i, ((stride, n_it), pack) in enumerate(
                zip(prm.coarse_pt_iters, state.extra.coarse)):
            idx = self._coarse_index(i)
            window = win[1 + strides.index(stride)] if stride > 1 else win[0]
            ph = ph_full[:, :, idx]
            hi = min(it + int(n_it), prm.max_iters)
            for _ in range(it, hi):
                ssm_state = self._iteration(state, ssm_state, window, offs3,
                                            ph, pack[0])
            it = hi
        templ = state.am_state.template[..., 0]
        for _ in range(it, prm.max_iters):
            ssm_state = self._iteration(state, ssm_state, win[0], offs3,
                                        ph_full, templ)
        return state._replace(ssm_state=ssm_state)


SM_LK_REGISTRY = {"fclk": FCLK, "fc": FCLK}
