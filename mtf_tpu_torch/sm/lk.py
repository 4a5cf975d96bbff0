"""Lucas-Kanade on the chain-fused path (port of the `LKBase` fast path
of `mtf_tpu/sm/lk.py`): forward compositional LK (`FCLK`) and ESM, each
with optional Levenberg-Marquardt accept/reject (the `*lm` keys).

Slices 1, 2 and 4: SSD or NCC appearance, 8-DOF homography, dense
sampling with linear, Catmull-Rom or cubic B-spline taps
(`interp="linear_mm"`, `"cubic_mm"`, `"cubic_bspl_mm"`) from a window of
`crop` pixels hoisted out of the iteration loop, selft Hessian and
optional coarse-to-fine point decimation (`coarse_pt_iters`). Every
Gauss-Newton iteration is one call of the chain kernel (`lk_fused_chain`)
for all B trackers, in the AM's mode (SSD, or NCC moments) and, for ESM,
with the template Jacobian as its constant J0 operand (mean Jacobian
½(J + J0)). The 3x3 warp algebra, the NCC combine, the 8x8 solve and the
LM test stay in PyTorch.

Multi-channel frames (H, W, C), C 2-4 (the `mcssd` / `ssd3` keys), take
the kernel's multi-channel SSD mode, as the JAX package's fused path
does: SSD without ESM only (`_fused_ok`, `mtf_tpu/sm/lk.py:316-320`).
Patches are (B, N, C); the pixel Jacobian is (B, N·C, S) with rows
interleaved n·C + c, and each coarse pack holds the blurred template
(B, n, C) and the rows of its decimated points.

The update runs a fixed number of iterations (`epsilon <= 0`, the
fixed-iteration mode of the JAX package), so every tracker takes the same
steps and no done mask is needed. LM keeps a per-tracker damping and
accepts or rejects each tracker's step with `torch.where`, evaluating f
phase-consistently: on the phase's (blurred, decimated) window and points
against the phase's template, re-seeded at every phase boundary.

Unlike the JAX fast path, which casts the frame to bf16 for the TPU's
MXU before the blur and crop, the window stays float32 here. The JAX LM
path blurs its cropped window instead of the frame; the two differ only
within one blur radius of the window's edge, which the crop margin
keeps the points' taps clear of.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.am.ncc import NCC
from mtf_tpu_torch.ops.kernels.lk_fused import (MAX_CHANNELS, lk_fused_chain,
                                                ncc_combine, ncc_moments)
from mtf_tpu_torch.ops.linalg import neg_def_solve
from mtf_tpu_torch.sm.core import SearchMethod, TrackerState
from mtf_tpu_torch.ssm.projective import Homography

# crop margin of the hoisted window: covers the motion within one update
# and the widest binomial support of the coarse phases
_CROP_MARGIN = 4.0
DENSE_INTERPS = ("linear_mm", "cubic_mm", "cubic_bspl_mm")


class LKCache(NamedTuple):
    """Per-tracker quantities cached at init (C channels; the layouts are
    the JAX package's with a leading B)."""
    J0: torch.Tensor     # (B, N·C, S) template pixel Jacobian at identity,
                         # rows n·C + c
    H0: torch.Tensor     # (B, S, S) initial self Hessian (SSD -J0^T J0)
    coarse: tuple = ()   # per coarse phase (templ_s (B, n_s) or, C > 1,
                         # (B, n_s, C); H0_s (B, S, S); J_s (B, n_s·C, S))
                         # sampled from the blurred init frame at the
                         # decimated grid


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
    """Separable edge-padded binomial blur of an (H, W) or (H, W, C)
    image, as shift-adds in float32 (`conv2d` would run in TF32 through
    cuDNN)."""
    if stride <= 1:
        return img
    k = _binomial(stride)
    r = (k.shape[0] - 1) // 2
    h, w = img.shape[:2]
    x = img.to(torch.float32)
    x = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    f = F.pad(x, (r, r, r, r), mode="replicate")[0]
    f = f[0] if img.dim() == 2 else f.permute(1, 2, 0)
    fh = sum(float(k[i]) * f[:, i:i + w] for i in range(len(k)))
    fv = sum(float(k[j]) * fh[j:j + h] for j in range(len(k)))
    return fv.to(img.dtype)


def _homogeneous(base_pts: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) -> (B, 3, N) homogeneous base points."""
    return W.homogenize(base_pts).transpose(1, 2).contiguous()


class LKBase(SearchMethod):
    """Shared LK machinery on the chain-fused path; subclasses pick the
    Jacobian (`use_esm_jac`)."""

    use_esm_jac = False     # True -> mean of init + current Jacobians

    def __init__(self, am, ssm, prm):
        super().__init__(am, ssm, prm)
        need = {
            "am 'ssd' or 'ncc'": am.name in ("ssd", "ncc"),
            "ssm '8'": isinstance(ssm, Homography),
            f"interp one of {DENSE_INTERPS}": prm.interp in DENSE_INTERPS,
            "border 'replicate'": prm.border == "replicate",
            "a crop window": prm.crop is not None,
            "hess_type 'selft'": prm.hess_type == "selft",
            "epsilon <= 0 (fixed iterations)": prm.epsilon <= 0.0,
            "jac_type 'original'": prm.jac_type == "original",
        }
        missing = [k for k, ok in need.items() if not ok]
        if missing:
            raise NotImplementedError(
                f"{type(self).__name__} is ported for {', '.join(need)} "
                f"only; this configuration lacks {', '.join(missing)}. The "
                "other LK options come with ROADMAP Queue 1b (the rest of "
                "slice 2) and Queue 1, slice 4")
        self._check_channels(am.prm.n_channels)
        self.kind = prm.interp[:-len(interp.MM_SUFFIX)]
        for i, (stride, _) in enumerate(prm.coarse_pt_iters):
            self.register_buffer(
                f"coarse_idx{i}",
                _coarse_idx(am.prm.resy, am.prm.resx, stride).to(self.device))

    def _coarse_index(self, i: int) -> torch.Tensor:
        return getattr(self, f"coarse_idx{i}")

    def _check_channels(self, c: int) -> None:
        """The JAX package fuses multi-channel frames for SSD without ESM
        and up to 4 channels; it runs the rest on its generic AD path."""
        if c > 1 and (self.use_esm_jac or self.am.name != "ssd"
                      or c > MAX_CHANNELS):
            raise NotImplementedError(
                f"{type(self).__name__} with {self.am.name} on {c} channels "
                f"is not ported yet: multi-channel frames take the chain "
                f"kernel for SSD without ESM and up to {MAX_CHANNELS} "
                "channels only; the rest runs on the JAX package's generic "
                "AD path, which comes with ROADMAP Queue 1b")

    def _frame(self, frame: torch.Tensor) -> torch.Tensor:
        """An (H, W) or (H, W, C) frame, C 2-4, checked against the fused
        path (a single channel is taken as a gray frame)."""
        if frame.dim() == 3 and frame.shape[2] == 1:
            return frame[..., 0]
        if frame.dim() == 3:
            self._check_channels(frame.shape[2])
        elif frame.dim() != 2:
            raise ValueError(f"frames are (H, W) or (H, W, C), got "
                             f"{tuple(frame.shape)}")
        return frame

    # -- init ----------------------------------------------------------
    def _patch_and_jac0(self, region, frame):
        """Patch (B, N, C) and pixel Jacobian (B, N·C, S) (rows n·C + c) at
        the identity warp, through the analytic chain: the dense-sampling
        gradient times the quotient-rule warp Jacobian."""
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
        patch, grad = interp.sample_dense(frame, pts, self.kind,
                                          crop=self.prm.crop)
        J = (grad[..., 0:1] * jx.transpose(1, 2)[:, :, None]
             + grad[..., 1:2] * jy.transpose(1, 2)[:, :, None])  # (B,N,C,S)
        return patch, J.flatten(1, 2)

    def _self_hessian(self, patch: torch.Tensor,
                      J: torch.Tensor) -> torch.Tensor:
        """Self Hessian at a perfect match with `patch` (B, N) through
        the pixel Jacobian J (B, N, S), in closed form: SSD -J^T J; NCC
        minus the combine of the chain kernel's moments with
        n0 = centre-normed patch (what the JAX package gets by AD)."""
        if self.am.name == "ssd":
            return -(J.transpose(1, 2) @ J)
        n0 = NCC._center_norm(patch[..., None])[..., 0]
        return -ncc_combine(*ncc_moments(patch, n0, J.transpose(1, 2)))[1]

    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        frame = self._frame(frame)
        patch0, J0 = self._patch_and_jac0(state.region, frame)
        b, _, c = patch0.shape
        s = self.ssm.dof
        coarse = []
        for i, (stride, _) in enumerate(self.prm.coarse_pt_iters):
            idx = self._coarse_index(i)
            p_b, J_b = self._patch_and_jac0(state.region,
                                            _blur2(frame, stride))
            # the decimated points' rows of the interleaved Jacobian
            Js = J_b.reshape(b, -1, c, s)[:, idx].reshape(b, -1, s)
            p_s = p_b[:, idx, 0] if c == 1 else p_b[:, idx]
            coarse.append((p_s, self._self_hessian(p_s, Js), Js))
        return LKCache(J0=J0, H0=self._self_hessian(
            patch0[..., 0] if c == 1 else patch0, J0), coarse=tuple(coarse))

    # -- one Gauss-Newton iteration ------------------------------------
    def _window_warp(self, state: TrackerState, ssm_state: torch.Tensor,
                     offs3: torch.Tensor) -> torch.Tensor:
        """M0 = norm o W(p) shifted into window coordinates (rows 0/1
        minus offset * row 2)."""
        M0 = state.region.norm_mat @ self.ssm.to_matrix(ssm_state)
        return (M0 - offs3[:, :, None] * M0[:, 2:3, :]).contiguous()

    def _iteration(self, state: TrackerState, ssm_state: torch.Tensor,
                   offs3: torch.Tensor, phase, delta) -> torch.Tensor:
        """Chain-fused iteration: the kernel in the AM's mode, then the
        damped selft solve and the compositional update. `delta` (B,) is
        the LM damping, or None."""
        ssm = self.ssm
        window, ph, templ, j0, _ = phase
        M0 = self._window_warp(state, ssm_state, offs3)
        _, g, h = lk_fused_chain(window, M0, ssm.generators, ph, templ,
                                 am=self.am.name, j0=j0, kind=self.kind)
        # selft: SSD -J^T J at the current J (with ESM's mean Jacobian the
        # ESM normal matrix); NCC the closed form of the moments
        H = -h
        eye = torch.eye(ssm.dof, dtype=H.dtype, device=H.device)
        if delta is not None:
            # Marquardt damping of the fused path: no mean-|diag| floor
            H = H - delta[:, None, None] * torch.diag_embed(
                H.diagonal(dim1=-2, dim2=-1).abs())
        Hd = H - 1e-7 * eye
        return ssm.compositional_update(ssm_state, neg_def_solve(Hd, g))

    def _f(self, state: TrackerState, ssm_state: torch.Tensor,
           offs3: torch.Tensor, phase) -> torch.Tensor:
        """The LM objective (B,): f of the phase's AM state on its window
        sampled at its points."""
        window, ph, _, _, am_state = phase
        q = self._window_warp(state, ssm_state, offs3) @ ph  # (B, 3, N)
        val = interp.sample_windows(window, q[:, 0] / q[:, 2],
                                    q[:, 1] / q[:, 2], kind=self.kind)
        # (B, N) or (B, C, N) -> the AM's (B, N, C)
        return self.am.f_corrected(am_state, val[..., None] if val.dim() == 2
                                   else val.transpose(1, 2))

    # -- full update ----------------------------------------------------
    def _phases(self, state: TrackerState, win: torch.Tensor,
                strides: list):
        """Per phase, coarse ones first: (n_iters, (window, points
        (B, 3, n), kernel template (B, n) or (B, C, n), J0 operand
        (B, S, n) or None, AM state of the phase's template))."""
        prm, am = self.prm, self.am
        ph_full = _homogeneous(state.region.base_pts)

        def operands(window, ph, am_state, J):
            # the kernel's NCC mode takes the centred unit template n0
            t = am_state.extra[0] if am.name == "ncc" else am_state.template
            t = t[..., 0] if t.shape[-1] == 1 else t.transpose(1, 2)
            j0 = (J.transpose(1, 2).contiguous() if self.use_esm_jac
                  else None)
            return (window, ph, t.contiguous(), j0, am_state)

        out = []
        for i, ((stride, n_it), (templ_s, _, Js)) in enumerate(
                zip(prm.coarse_pt_iters, state.extra.coarse)):
            window = win[1 + strides.index(stride)] if stride > 1 else win[0]
            tp = templ_s[..., None] if templ_s.dim() == 2 else templ_s
            out.append((int(n_it), operands(
                window, ph_full[:, :, self._coarse_index(i)], am.init(tp),
                Js)))
        out.append((prm.max_iters, operands(win[0], ph_full, state.am_state,
                                            state.extra.J0)))
        return out

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        prm, ssm = self.prm, self.ssm
        frame = self._frame(frame)
        h, w = frame.shape[:2]
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
        if frame.dim() == 2:
            win = stk[:, rows[:, :, None], cols[:, None, :]]  # (V, B, hc, wc)
        else:
            # channel-stacked windows (V, B, C, hc, wc) in the same gather
            ch = torch.arange(frame.shape[2], device=dev)
            win = stk[:, rows[:, None, :, None], cols[:, None, None, :],
                      ch[None, :, None, None]]
        offs3 = torch.stack([x0, y0, torch.zeros_like(x0)], dim=-1)

        ssm_state = state.ssm_state
        delta = (torch.full_like(x0, prm.lm_delta0) if prm.enable_lm
                 else None)
        it = 0
        for n_it, phase in self._phases(state, win, strides):
            hi = min(it + n_it, prm.max_iters)
            if delta is not None:
                f_prev = self._f(state, ssm_state, offs3, phase)
            for _ in range(it, hi):
                new = self._iteration(state, ssm_state, offs3, phase, delta)
                if delta is None:
                    ssm_state = new
                    continue
                # LM: keep a step only where it does not lower f
                f_new = self._f(state, new, offs3, phase)
                accept = f_new >= f_prev
                ssm_state = torch.where(accept[:, None], new, ssm_state)
                delta = torch.where(accept, delta * prm.lm_down,
                                    delta * prm.lm_up)
                f_prev = torch.where(accept, f_new, f_prev)
            it = hi
        return state._replace(ssm_state=ssm_state)


class FCLK(LKBase):
    """Forward compositional LK (NT/FCLK.cc)."""
    name = "fclk"


class ESM(LKBase):
    """Efficient second-order minimization: mean of the init and current
    Jacobians (NT/ESM.cc:228-230)."""
    name = "esm"
    use_esm_jac = True


# every key of the JAX registry that maps to FCLK or ESM; FESM and ESMH
# collapse to ESM there too
SM_LK_REGISTRY = {"fclk": FCLK, "fc": FCLK, "fclm": FCLK,
                  "esm": ESM, "fesm": ESM, "esmh": ESM, "eslm": ESM,
                  "esl": ESM}

LM_KEYS = {"eslm", "esl", "fclm"}
