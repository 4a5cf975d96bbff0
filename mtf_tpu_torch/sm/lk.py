"""Lucas-Kanade search methods (port of `mtf_tpu/sm/lk.py`): FCLK, ICLK,
ESM, AESM, FALK, IALK and FCSD, each optionally with Levenberg-Marquardt
accept/reject (the `*lm` keys), over a batch of B trackers.

Two execution paths, as in the JAX package, chosen per update by the
configuration alone (`LKBase._fused_ok`, the JAX package's rule):

  * the chain-fused path: every Gauss-Newton iteration is one call of the
    chain kernel (`lk_fused_chain`) for all B trackers, in the AM's mode
    (SSD, NCC moments, ESM's J0 operand, multi-channel SSD) on dense taps
    from a window hoisted out of the iteration loop (per tracker with a
    crop; the shared frame, read in place by every tracker, without; with
    `update_multi`, each tracker's window of its own frame). It
    takes forward compositional LK and ESM with SSD or NCC, a matrix SSM,
    the self0/selft (and for SSD std) Hessians, no SPI, and gray or (SSD
    without ESM) 2-4-channel frames;
  * the generic path, everything else (`use_pallas=False` forces it):
    the candidate patch is a function of the update q = [dp_ssm, dp_am];
    its Jacobian is the warp's (`torch.func.jvp` over the S basis
    vectors, no gathers) chained with one value-and-gradient sample, and
    the AM's derivatives and Hessian flavours (self0, selft, std, and std2
    through the sampler's second derivative) come from `torch.func`.
    No TPU kernel sits on this path in either package: the JAX package
    runs it in XLA.

The update loop is shared: coarse-to-fine point decimation
(`coarse_pt_iters`: each phase on the stride-decimated grid of a blurred
frame, against the cached blurred template; the LM objective is the
phase's own and is re-seeded at each phase boundary), LM accept/reject
per tracker, and, with `epsilon > 0`, per-tracker done masks with the
semantics of the JAX package's `vmap`ped `while_loop`: a tracker whose
corners moved less than `epsilon` (for LM: on an accepted step) freezes
every field of its carry (state, damping, f, its own iteration count)
until the full-resolution phase re-arms it; the loop stops when no
tracker is active, which costs one host sync per iteration. With
`epsilon <= 0` every tracker takes the same fixed count of iterations and
nothing syncs.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mtf_tpu_torch.ops import interp
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.kernels.lk_fused import (MAX_CHANNELS, STATE_DIMS,
                                                lk_fused_chain)
from mtf_tpu_torch.ops.linalg import neg_def_solve
from mtf_tpu_torch.ops.spi import SPI_KINDS, compute_spi_mask
from mtf_tpu_torch.sm.core import RegionState, SearchMethod, TrackerState
from mtf_tpu_torch.ssm.base import SSM as MatrixSSM

# crop margin of the hoisted window: covers the motion within one update
# and the widest binomial support of the coarse phases
_CROP_MARGIN = 4.0
DENSE_INTERPS = ("linear_mm", "cubic_mm", "cubic_bspl_mm")
GATHER_INTERPS = ("nearest", "linear", "cubic", "cubic_bspl")
HESS_TYPES = ("self0", "selft", "std", "std2")
JAC_TYPES = ("original", "diff_of_jacs")


class LKCache(NamedTuple):
    """Per-tracker quantities cached at init (C channels; the layouts are
    the JAX package's with a leading B)."""
    J0: torch.Tensor     # (B, N·C, S) template pixel Jacobian at identity,
                         # rows n·C + c
    H0: torch.Tensor     # (B, Q, Q) initial self Hessian
    coarse: tuple = ()   # per coarse phase (templ_s (B, n_s) or, C > 1,
                         # (B, n_s, C); H0_s (B, S, S); J_s (B, n_s·C, S))
                         # sampled from the blurred init frame at the
                         # decimated grid


class _Carry(NamedTuple):
    ssm_state: torch.Tensor
    p_am: torch.Tensor
    it: Any                  # int, or (B,) per tracker with done masks
    done: torch.Tensor       # (B,) bool
    lm_delta: Any            # (B,) LM damping, or None
    f_prev: Any              # (B,) LM objective at the state, or None


class _Runs(NamedTuple):
    """A chain-kernel window of F frames read by runs of trackers: rows
    start:stop read frame `f` of `frames` (F, [C,] H, W), one kernel call
    per run, the frame shared by the run's trackers in place."""
    frames: torch.Tensor
    runs: tuple              # ((f, start, stop), ...)


class _Phase(NamedTuple):
    """One phase of an update: its (decimated) region, the AM state of its
    template, its cached J0 / H0, the image it samples (per-tracker
    windows (B, C, Hc, Wc) with the crop offset, or the shared frame) and,
    on the fused path, the kernel's operands."""
    hi: int
    region: RegionState
    am_state: Any
    J0: torch.Tensor
    H0: torch.Tensor
    img: torch.Tensor
    kernel: Any = None       # (window, ph, templ, j0) of the chain kernel


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


def _blur_windows(win: torch.Tensor, stride: int) -> torch.Tensor:
    """`_blur2` of each window of (B, C, Hc, Wc), edge-padded at the
    window's own edges (the JAX package's generic path blurs its hoisted
    windows, `mtf_tpu/sm/lk.py:727-729`)."""
    if stride <= 1:
        return win
    k = _binomial(stride)
    r = (k.shape[0] - 1) // 2
    h, w = win.shape[-2:]
    f = F.pad(win, (r, r, r, r), mode="replicate")
    fh = sum(float(k[i]) * f[..., i:i + w] for i in range(len(k)))
    return sum(float(k[j]) * fh[..., j:j + h, :] for j in range(len(k)))


def _windows(frames, x0: torch.Tensor, y0: torch.Tensor,
             hc: int, wc: int, pad: int = 0) -> torch.Tensor:
    """Each tracker's window (B, C, hc + 2 pad, wc + 2 pad) of its own
    frame of frames (B, H, W, C) or of a `FrameStack`, from (x0 - pad,
    y0 - pad), with the indices clamped into the frame (its replicate
    border)."""
    if isinstance(frames, interp.FrameStack):
        frames, bi = frames
    else:
        bi = torch.arange(frames.shape[0], device=frames.device)
    _, h, w, _ = frames.shape
    dev = frames.device
    rows = (y0.long()[:, None] + torch.arange(-pad, hc + pad, device=dev)
            ).clamp(0, h - 1)
    cols = (x0.long()[:, None] + torch.arange(-pad, wc + pad, device=dev)
            ).clamp(0, w - 1)
    return frames[bi[:, None, None], rows[:, :, None], cols[:, None, :]
                  ].permute(0, 3, 1, 2).contiguous()


def _blur_valid(ext: torch.Tensor, stride: int) -> torch.Tensor:
    """`_blur2` of the frame, on a window read with the blur's radius of
    margin (`_windows(..., pad)`): the same sums in the same order, so
    the window of the blurred frame, bit for bit."""
    k = _binomial(stride)
    r = (k.shape[0] - 1) // 2
    h, w = ext.shape[-2] - 2 * r, ext.shape[-1] - 2 * r
    fh = sum(float(k[i]) * ext[..., i:i + w] for i in range(len(k)))
    return sum(float(k[j]) * fh[..., j:j + h, :] for j in range(len(k)))


def _homogeneous(base_pts: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) -> (B, 3, N) homogeneous base points."""
    return W.homogenize(base_pts).transpose(1, 2).contiguous()


def _bmv(g: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """(B, K) x (B, K, S) -> (B, S)."""
    return (g[:, None] @ J)[:, 0]


def hess_contract(am, am_state, at_patch: torch.Tensor,
                  J: torch.Tensor) -> torch.Tensor:
    """(B, Q, Q) J^T (d2 similarity / d corrected-patch^2) J by one
    Hessian-vector product per column of J (B, N·C, Q), at the corrected
    patches `at_patch` (B, N, C)."""
    shape = at_patch.shape

    def g(pf):
        return am.grad_corrected(am_state, pf.reshape(shape)).flatten(1)

    p0 = at_patch.flatten(1)
    cols = torch.func.vmap(lambda v: torch.func.jvp(g, (p0,), (v,))[1],
                           in_dims=-1, out_dims=-1)(J)
    return J.transpose(1, 2) @ cols


class LKBase(SearchMethod):
    """Shared LK machinery; subclasses pick the Jacobian source and the
    update rule."""

    compositional = True    # False -> additive (FALK, IALK, AESM)
    inverse = False         # True -> template-side Jacobian, inverted update
    use_esm_jac = False     # True -> mean of init and current Jacobians
    steepest = False        # True -> steepest ascent, dq = rate * j (FCSD)

    def __init__(self, am, ssm, prm):
        super().__init__(am, ssm, prm)
        if prm.border not in interp.BORDERS:
            raise ValueError(f"unknown border {prm.border!r}; known: "
                             f"{interp.BORDERS}")
        if prm.interp not in DENSE_INTERPS + GATHER_INTERPS:
            raise ValueError(f"unknown interp {prm.interp!r}; known: "
                             f"{DENSE_INTERPS + GATHER_INTERPS}")
        if prm.hess_type not in HESS_TYPES:
            raise ValueError(f"unknown hess_type {prm.hess_type!r}")
        if prm.jac_type not in JAC_TYPES:
            raise ValueError(f"unknown jac_type {prm.jac_type!r}")
        if prm.spi_type and prm.spi_type.lower() not in SPI_KINDS:
            raise ValueError(f"unknown SPI type {prm.spi_type!r}")
        self.dense = prm.interp in DENSE_INTERPS
        self.kind = (prm.interp[:-len(interp.MM_SUFFIX)] if self.dense
                     else prm.interp)
        for i, (stride, _) in enumerate(prm.coarse_pt_iters):
            self.register_buffer(
                f"coarse_idx{i}",
                _coarse_idx(am.prm.resy, am.prm.resx, stride).to(self.device))

    def _coarse_index(self, i: int) -> torch.Tensor:
        return getattr(self, f"coarse_idx{i}")

    @property
    def _q_dim(self) -> int:
        return self.ssm.dof + self.am.ilm.n_params

    def _frame(self, frame: torch.Tensor) -> torch.Tensor:
        """An (H, W) or (H, W, C) frame (one channel is a gray frame)."""
        if frame.dim() == 3 and frame.shape[2] == 1:
            return frame[..., 0]
        if frame.dim() not in (2, 3):
            raise ValueError(f"frames are (H, W) or (H, W, C), got "
                             f"{tuple(frame.shape)}")
        return frame

    # -- dispatch -------------------------------------------------------
    def _fused_ok(self, state: TrackerState, frame: torch.Tensor) -> bool:
        """True where the JAX package's `_fused_ok` takes the chain kernel
        (`mtf_tpu/sm/lk.py:299-332`): forward compositional, SSD (any
        Hessian flavour but std2) or NCC (self0, selft), the ESM mean
        Jacobian as the kernel's J0 operand, no ILM or SPI, dense taps, a
        gray frame or 2-4 channels for SSD without ESM, and a matrix SSM
        with the default matrix `warp_pts_from`, and no `crop_blocks`.
        `use_pallas=False` takes the generic path. FCSD's steepest-ascent
        step has no kernel mode: its JAX `_iteration` never reaches the
        kernel either."""
        prm, am, ssm = self.prm, self.am, self.ssm
        fuse_am = am.name == "ssd" or (am.name == "ncc" and prm.hess_type
                                       in ("self0", "selft"))
        mc_ok = (frame.dim() == 3 and am.name == "ssd"
                 and not self.use_esm_jac and frame.shape[2] <= MAX_CHANNELS)
        return (prm.use_pallas is not False and not self.steepest
                and self.dense and not self.inverse and self.compositional
                and (not self.use_esm_jac or prm.jac_type == "original")
                and fuse_am and am.ilm.n_params == 0
                and prm.hess_type in ("self0", "selft", "std")
                and not prm.spi_type and state.spi_mask is None
                and (frame.dim() == 2 or mc_ok)
                and prm.crop_blocks is None
                and isinstance(ssm, MatrixSSM)
                and type(ssm).warp_pts_from is MatrixSSM.warp_pts_from
                and ssm.dof in STATE_DIMS)

    # -- sampling and the patch Jacobian -----------------------------------
    def _sample(self, img, pts: torch.Tensor, offset, need_grad: bool,
                crop=None):
        """Patches (B, N, C) at image points pts (B, N, 2) and, with
        `need_grad`, their derivative (B, N, C, 2): from per-tracker
        windows (B, C, Hc, Wc) at pts - offset (dense taps), or from the
        shared frame (H, W[, C]) (dense taps in a `crop` window, or the
        gather kinds) or per-tracker frames (B, H, W, C) or a `FrameStack`
        (either kind). The value-and-gradient sample (the Jacobian's) is
        the one that `interp_bf16`, `interp_precision` and `crop_blocks`
        change, as in the JAX package's `_patch_and_jac`
        (`mtf_tpu/sm/lk.py:161-176`); value-only samples (the LM
        objective, template learning) stay float32."""
        prm = self.prm
        bf16 = need_grad and prm.interp_bf16
        if offset is not None:
            out = interp.sample_windows(
                img, pts[..., 0] - offset[:, None, 0],
                pts[..., 1] - offset[:, None, 1], need_grad, self.kind,
                bf16=bf16)
            if not need_grad:
                return out.transpose(1, 2), None
            val, dx, dy = out
            return (val.transpose(1, 2),
                    torch.stack([dx, dy], dim=-1).transpose(1, 2))
        if self.dense:
            if need_grad and prm.crop_blocks is not None:
                return interp.sample_dense_blocked(
                    img, pts, self.kind, crop=crop or 64,
                    grid_shape=(self.am.prm.resy, self.am.prm.resx),
                    blocks=tuple(prm.crop_blocks), bf16=bf16)
            return interp.sample_dense(
                img, pts, self.kind, crop=crop, need_grad=need_grad,
                bf16=bf16,
                precision=prm.interp_precision if need_grad else None)
        return interp.sample_val_grad(img, pts, self.kind, prm.border,
                                      need_grad=need_grad)

    def _pts(self, region: RegionState, ssm_state: torch.Tensor,
             dp: torch.Tensor) -> torch.Tensor:
        """Image points (B, N, 2) of the state perturbed by the update dp."""
        return W.apply_warp(region.norm_mat, self.ssm.warp_pts_from(
            ssm_state, dp, region.base_pts, self.compositional))

    def _patch_fn(self, region: RegionState, ssm_state: torch.Tensor,
                  p_am: torch.Tensor, img: torch.Tensor, offset):
        """q (B, Q) -> illumination-corrected patches (B, N, C),
        q = [dp_ssm, dp_am], differentiable through the sampler."""
        S = self.ssm.dof

        def fn(q):
            patch = self._sample(img, self._pts(region, ssm_state, q[:, :S]),
                                 offset, False)[0]
            return self.am.ilm.apply(patch, p_am + q[:, S:])
        return fn

    def _template_patch_fn(self, region: RegionState, frame: torch.Tensor):
        """q (B, Q) -> template-side patches (B, N, C) on the init frame,
        the warp perturbed from the identity and no illumination model
        (ICLK's and ESM's J0; `mtf_tpu/sm/lk.py:106`)."""
        S = self.ssm.dof

        def fn(q):
            ident = self.ssm.identity((q.shape[0],))
            return self._sample(frame, self._pts(region, ident, q[:, :S]),
                                None, False)[0]
        return fn

    def _patch_and_jac(self, region: RegionState, ssm_state: torch.Tensor,
                       p_am: torch.Tensor, img: torch.Tensor, offset,
                       crop=None):
        """Corrected patches (B, N, C) and their Jacobian (B, N·C, Q), rows
        n·C + c: the warp's Jacobian (one forward-mode product per basis
        vector, no gathers), one value-and-gradient sample, their
        contraction, and the illumination model's chain."""
        am, ssm = self.am, self.ssm
        S, P = ssm.dof, am.ilm.n_params
        b = ssm_state.shape[0]
        zero = ssm_state.new_zeros(b, S)

        def pts_fn(dp):
            return self._pts(region, ssm_state, dp)

        basis = torch.eye(S, dtype=zero.dtype, device=zero.device)[
            :, None, :].expand(S, b, S)
        pts = pts_fn(zero)
        Jpts = torch.func.vmap(
            lambda t: torch.func.jvp(pts_fn, (zero,), (t,))[1],
            out_dims=-1)(basis)                              # (B, N, 2, S)
        patch, grad = self._sample(img, pts, offset, True, crop)
        Jp = torch.einsum("bncd,bnds->bncs", grad, Jpts)     # (B, N, C, S)
        if P == 0:
            return patch, Jp.flatten(1, 2)
        # chain through the illumination model: its JVP in the patch for
        # the warp columns, its Jacobian in p_am for the photometric ones
        corrected = am.ilm.apply(patch, p_am)
        J_ssm = torch.func.vmap(lambda t: torch.func.jvp(
            lambda q: am.ilm.apply(q, p_am), (patch,), (t,))[1],
            in_dims=-1, out_dims=-1)(Jp)
        J_ilm = torch.func.vmap(torch.func.jacfwd(am.ilm.apply, argnums=1))(
            patch, p_am)                                     # (B, N, C, P)
        return corrected, torch.cat([J_ssm.flatten(1, 2),
                                     J_ilm.flatten(1, 2)], dim=-1)

    def _hess_contract(self, am_state, at_patch: torch.Tensor,
                       J: torch.Tensor) -> torch.Tensor:
        return hess_contract(self.am, am_state, at_patch, J)

    def _self_hessian(self, patch: torch.Tensor,
                      J: torch.Tensor) -> torch.Tensor:
        """Self Hessian (B, S, S) at a perfect match with patches (B, N)
        or (B, N, C) through their pixel Jacobian (B, N·C, S)."""
        patch = patch[..., None] if patch.dim() == 2 else patch
        return self._hess_contract(self.am.init(patch), patch, J)

    # -- init ----------------------------------------------------------
    def _init_extra(self, state: TrackerState, frame: torch.Tensor):
        """Template Jacobian J0 and self Hessian H0 at the identity warp
        and, where the JAX package builds them (`mtf_tpu/sm/lk.py:
        270-278`: one channel, or SSD on every channel; no ILM, template
        learning, SPI or std2), each coarse phase's blurred decimated
        template, self0 Hessian and template Jacobian."""
        am, ssm, prm = self.am, self.ssm, self.prm
        frame = self._frame(frame)
        region = state.region
        b, n = region.base_pts.shape[:2]
        S = ssm.dof
        ident = ssm.identity((b,))
        pam0 = am.ilm.identity_params((b,), device=frame.device)

        def patch_and_jac(img):
            return self._patch_and_jac(region, ident, pam0, img, None,
                                       crop=prm.crop)

        patch0, J_full = patch_and_jac(frame)
        H0 = self._hess_contract(state.am_state, patch0, J_full)
        c = patch0.shape[-1]
        ry, rx = am.prm.resy, am.prm.resx
        mc_pack = frame.dim() == 3 and am.name == "ssd" and c == frame.shape[2]
        coarse = []
        if (((c == 1 and frame.dim() == 2) or mc_pack) and n == ry * rx
                and am.ilm.n_params == 0 and not am.needs_update_model
                and not prm.spi_type and prm.hess_type != "std2"):
            for i, (stride, _) in enumerate(prm.coarse_pt_iters):
                idx = self._coarse_index(i)
                p_b, J_b = patch_and_jac(_blur2(frame, stride))
                # the decimated points' rows of the interleaved Jacobian
                Js = J_b[..., :S].reshape(b, n, c, S)[:, idx].flatten(1, 2)
                p_s = p_b[:, idx]
                coarse.append((p_s[..., 0] if c == 1 else p_s,
                               self._hess_contract(am.init(p_s), p_s, Js),
                               Js))
        return LKCache(J0=J_full[..., :S], H0=H0, coarse=tuple(coarse))

    # -- one iteration ---------------------------------------------------
    def _window_warp(self, state: TrackerState, ssm_state: torch.Tensor,
                     offs3: torch.Tensor) -> torch.Tensor:
        """M0 = norm o W(p) shifted into window coordinates (rows 0/1
        minus offset * row 2)."""
        M0 = state.region.norm_mat @ self.ssm.to_matrix(ssm_state)
        return (M0 - offs3[:, :, None] * M0[:, 2:3, :]).contiguous()

    def _iteration_fused(self, state: TrackerState, c: _Carry, ph: _Phase,
                         offs3: torch.Tensor) -> torch.Tensor:
        """Chain-fused iteration -> dq (B, S): the kernel in the AM's
        mode, then the Marquardt-damped solve (no mean-|diag| floor, as
        the JAX package's fused path, `mtf_tpu/sm/lk.py:419-422`)."""
        ssm = self.ssm
        window, ph_pts, templ, j0 = ph.kernel
        M0 = self._window_warp(state, c.ssm_state, offs3)
        kw = dict(am=self.am.name, kind=self.kind, bf16=self.prm.interp_bf16)
        if isinstance(window, _Runs):
            # one call per run of trackers on one frame (the sub-tracker
            # grid's P sub-trackers on their parent's frame), read in place
            out = [lk_fused_chain(
                window.frames[f].expand((b - a,) + window.frames.shape[1:]),
                M0[a:b], ssm.generators, ph_pts[a:b], templ[a:b],
                j0=None if j0 is None else j0[a:b], **kw)[1:]
                for f, a, b in window.runs]
            g, h = (torch.cat(x) for x in zip(*out))
        else:
            _, g, h = lk_fused_chain(window, M0, ssm.generators, ph_pts,
                                     templ, j0=j0, **kw)
        # SSD: selft == std == -J^T J at the current J (ESM: the ESM normal
        # matrix); NCC selft: the closed form of the moments; self0: the
        # phase's cached Hessian
        H = ph.H0 if self.prm.hess_type == "self0" else -h
        if c.lm_delta is not None:
            H = H - c.lm_delta[:, None, None] * torch.diag_embed(
                H.diagonal(dim1=-2, dim2=-1).abs())
        eye = torch.eye(ssm.dof, dtype=H.dtype, device=H.device)
        return neg_def_solve(H - 1e-7 * eye, g)

    def _iteration(self, state: TrackerState, c: _Carry, ph: _Phase,
                   offset) -> torch.Tensor:
        """Generic iteration -> dq (B, Q) (`mtf_tpu/sm/lk.py:426-533`)."""
        am, ssm, prm = self.am, self.ssm, self.prm
        S, P = ssm.dof, am.ilm.n_params
        st0 = ph.am_state._replace(p_am=c.p_am)
        J0 = ph.J0
        patch, J = self._patch_and_jac(ph.region, c.ssm_state, c.p_am,
                                       ph.img, offset, prm.crop)
        # SPI: per-pixel weights on the Jacobian and gradient rows, so j
        # and H are both w^2-weighted (a weighted GN step)
        mask = None
        if prm.spi_type:
            mask = compute_spi_mask(prm.spi_type, st0.template, patch,
                                    am.prm.resy, am.prm.resx, prm.spi_thresh)
        if state.spi_mask is not None:
            ext = state.spi_mask.to(patch.dtype)
            mask = ext if mask is None else mask * ext
        wm = None
        if mask is not None:
            wm = mask.repeat_interleave(patch.shape[-1], dim=-1)  # (B, N·C)
            J = J * wm[..., None]
            J0 = J0 * wm[..., None]

        def grad_of(fn):
            g = fn(st0, patch).flatten(1)
            return g if wm is None else g * wm

        if self.inverse:
            # template-side gradient with the cached J0 (ICLK, IALK)
            j = _bmv(grad_of(am.grad_template), J0)
            J_h = J0
            if P > 0:
                j = torch.cat([j, _bmv(grad_of(am.grad_corrected),
                                       J[..., S:])], dim=-1)
                J_h = torch.cat([J0, J[..., S:]], dim=-1)
        elif self.use_esm_jac:
            J_h = torch.cat([0.5 * (J[..., :S] + J0), J[..., S:]], dim=-1)
            gI = grad_of(am.grad_corrected)
            if prm.jac_type == "diff_of_jacs":
                j = 0.5 * (_bmv(gI, J[..., :S])
                           + _bmv(grad_of(am.grad_template), J0))
                if P > 0:
                    j = torch.cat([j, _bmv(gI, J[..., S:])], dim=-1)
            else:
                j = _bmv(gI, J_h)
        else:
            j = _bmv(grad_of(am.grad_corrected), J)
            J_h = J
        if self.steepest:
            return prm.sd_learning_rate * j                  # ascend

        if prm.hess_type == "self0":
            H = ph.H0
        elif prm.hess_type == "selft":
            H = self._hess_contract(am.self_state(patch, c.p_am), patch, J_h)
        elif prm.hess_type == "std":
            H = self._hess_contract(st0, patch, J_h)
        else:
            H = self._hess_std2(st0, c, ph, offset)
        # LM damping with the Levenberg mean-|diag| floor: the Marquardt
        # |diag| scaling alone cannot shrink near-zero-curvature dims
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        if c.lm_delta is not None:
            dia = H.diagonal(dim1=-2, dim2=-1).abs()
            H = H - c.lm_delta[:, None, None] * torch.diag_embed(
                dia + dia.mean(-1, keepdim=True))
        return neg_def_solve(H - 1e-7 * eye, j)

    def _hess_std2(self, st0, c: _Carry, ph: _Phase, offset) -> torch.Tensor:
        """The full second-order Hessian (B, Q, Q) of f(q) through the
        sampler: the Jacobian of the gradient, one forward-mode product
        per basis vector."""
        fn = self._patch_fn(ph.region, c.ssm_state, c.p_am, ph.img, offset)
        q0 = c.ssm_state.new_zeros(c.ssm_state.shape[0], self._q_dim)

        def grad_e(q):
            return torch.func.grad(
                lambda x: self.am.f_corrected(st0, fn(x)).sum())(q)

        basis = torch.eye(q0.shape[-1], dtype=q0.dtype, device=q0.device)
        cols = [torch.func.jvp(grad_e, (q0,), (basis[s].expand_as(q0),))[1]
                for s in range(q0.shape[-1])]
        return torch.stack(cols, dim=-1)

    def _apply_dq(self, ssm_state: torch.Tensor, p_am: torch.Tensor,
                  dq: torch.Tensor):
        S = self.ssm.dof
        dp, dpam = dq[:, :S], dq[:, S:]
        if self.inverse:
            new = self.ssm.inverse_compositional_update(ssm_state, dp)
        elif self.compositional:
            new = self.ssm.compositional_update(ssm_state, dp)
        else:
            new = ssm_state + dp
        return new, p_am + dpam

    def _f(self, ph: _Phase, ssm_state: torch.Tensor, p_am: torch.Tensor,
           offset) -> torch.Tensor:
        """The LM objective (B,): f of the phase's template state on its
        image, sampled at its points."""
        patch = self._sample(ph.img, self._pts(
            ph.region, ssm_state, torch.zeros_like(ssm_state)), offset,
            False, self.prm.crop)[0]
        return self.am.f_corrected(ph.am_state._replace(p_am=p_am),
                                   self.am.ilm.apply(patch, p_am))

    # -- full update ----------------------------------------------------
    def _crop(self, state: TrackerState, h: int, w: int):
        """The dense taps' window per tracker (x0 (B,), y0 (B,), hc, wc)
        in a frame of (h, w), where the crop is smaller than the frame;
        else None. One window for the whole update, from the points at
        the pre-update state: the margin absorbs the motion."""
        prm = self.prm
        if not (self.dense and prm.crop is not None and prm.crop_blocks is None
                and (prm.crop < h or prm.crop < w)):
            return None
        hc, wc = min(prm.crop, h), min(prm.crop, w)
        pts0 = W.apply_warp(state.region.norm_mat, self.ssm.warp_pts(
            state.ssm_state, state.region.base_pts))
        return (interp.crop_origin(pts0[..., 0], wc, w, _CROP_MARGIN),
                interp.crop_origin(pts0[..., 1], hc, h, _CROP_MARGIN),
                hc, wc)

    def _kernel_window(self, v: torch.Tensor) -> torch.Tensor:
        """A chain-kernel window as the kernel reads it: with
        `interp_bf16`, its values rounded to bfloat16 where it is made
        (the kernel rounds its tap weights)."""
        return interp.round_bf16(v) if self.prm.interp_bf16 else v

    def _views(self, state: TrackerState, frame: torch.Tensor, strides,
               fused: bool):
        """The images an update samples, per variant (the frame, then its
        blur for each coarse stride): per-tracker windows (B, C, Hc, Wc)
        from one stacked gather with the offset (B, 2) of their origin,
        where the dense taps read a crop smaller than the frame; else the
        shared frame and no offset. With `fused`, also the chain kernel's
        window per variant: the windows, or the shared frame with a batch
        stride of 0 (never B copies), rounded to bfloat16 with
        `interp_bf16`. The fused path crops every variant from the blurred
        frame; the generic path blurs its windows, as the JAX package's
        does (the two differ only within a blur radius of a window's
        edge)."""
        h, w = frame.shape[:2]
        mc = frame.dim() == 3
        b = state.ssm_state.shape[0]
        crop = self._crop(state, h, w)
        variants = [frame] + [_blur2(frame, st) for st in strides
                              if fused or crop is None]
        if crop is not None:
            x0, y0, hc, wc = crop
            stk = torch.stack(variants)
            dev = frame.device
            rows = y0.long()[:, None] + torch.arange(hc, device=dev)
            cols = x0.long()[:, None] + torch.arange(wc, device=dev)
            if mc:
                ch = torch.arange(frame.shape[2], device=dev)
                win = stk[:, rows[:, None, :, None], cols[:, None, None, :],
                          ch[None, :, None, None]]        # (V, B, C, hc, wc)
                imgs = list(win)
            else:
                win = stk[:, rows[:, :, None], cols[:, None, :]]
                imgs = [v[:, None] for v in win]
            if not fused:
                imgs += [_blur_windows(imgs[0], st) for st in strides]
            kwins = ([self._kernel_window(v) for v in win] if fused
                     else None)
            return imgs, kwins, torch.stack([x0, y0], dim=-1)
        kwins = None
        if fused:
            kwins = [self._kernel_window(
                v.permute(2, 0, 1).contiguous() if mc else v).expand(
                (b,) + (v.shape[2:3] if mc else ()) + (h, w))
                for v in variants]
        return variants, kwins, None

    def _views_multi(self, state: TrackerState, frames, strides,
                     fused: bool):
        """`_views` of per-tracker frames (B, H, W, C) or of a
        `FrameStack` (F frames read by index): the same images, each
        tracker's read from its own frame. Where a crop applies, the
        dense taps read windows (B, C, Hc, Wc) gathered from the frames,
        each blurred variant on a margin of the blur's radius. Else the
        stack (B, C, H, W) itself and its blur, with offset 0, so the
        chain kernel's window is the stack with no copy; or, by index, the
        F frames and their blur as `FrameStack`s, read in place by the
        samplers, and by the chain kernel one call per run of trackers on
        one frame (`_Runs`; never a frame per tracker). The gather kinds
        read the frames (B, H, W, C) or their `FrameStack`. With
        `interp_bf16` the kernel's windows are rounded."""
        index = None
        if isinstance(frames, interp.FrameStack):
            frames, index = frames
        b = state.ssm_state.shape[0]
        h, w, c = frames.shape[1:]
        crop = self._crop(state, h, w)
        if crop is None:
            stack = frames.permute(0, 3, 1, 2)
            blurs = [_blur_windows(stack, st) for st in strides]
            if not self.dense or index is not None:
                hwc = [frames] + [v.permute(0, 2, 3, 1) for v in blurs]
                imgs = (hwc if index is None
                        else [interp.FrameStack(v, index) for v in hwc])
                if not fused:
                    return imgs, None, None
                f, n = torch.unique_consecutive(index, return_counts=True)
                ends = np.cumsum(n.tolist())
                runs = tuple(zip(f.tolist(), (ends - n.tolist()).tolist(),
                                 ends.tolist()))
                kwins = [_Runs(self._kernel_window(
                    v[:, 0] if c == 1 else v).contiguous(), runs)
                    for v in [stack] + blurs]
                return imgs, kwins, None
            # the stack itself for C = 1; one copy of it for C > 1
            imgs = [stack.contiguous()] + blurs
            offset = frames.new_zeros(b, 2)
        else:
            src = (frames if index is None
                   else interp.FrameStack(frames, index))
            x0, y0, hc, wc = crop
            imgs = [_windows(src, x0, y0, hc, wc)]
            if fused:
                # every variant cropped from the blurred frame, as `_views`
                imgs += [_blur_valid(_windows(
                    src, x0, y0, hc, wc, (len(_binomial(st)) - 1) // 2),
                    st) for st in strides]
            else:
                imgs += [_blur_windows(imgs[0], st) for st in strides]
            offset = torch.stack([x0, y0], dim=-1)
        kwins = ([self._kernel_window(v[:, 0] if c == 1 else v)
                  for v in imgs] if fused else None)
        return imgs, kwins, offset

    def _phases(self, state: TrackerState, cache: LKCache, imgs, kwins,
                strides):
        """The update's phases, coarse ones first (those of `cache`)."""
        prm, am = self.prm, self.am
        region = state.region
        ph_full = _homogeneous(region.base_pts) if kwins else None

        def kernel_ops(v, idx, am_state, J):
            if kwins is None:
                return None
            # the kernel's NCC mode takes the centred unit template n0
            t = am_state.extra[0] if am.name == "ncc" else am_state.template
            t = t[..., 0] if t.shape[-1] == 1 else t.transpose(1, 2)
            j0 = (J.transpose(1, 2).contiguous() if self.use_esm_jac
                  else None)
            ph = ph_full if idx is None else ph_full[:, :, idx].contiguous()
            return (kwins[v], ph, t.contiguous(), j0)

        out, hi = [], 0
        for i, ((stride, n_it), (templ_s, h0s, Js)) in enumerate(
                zip(prm.coarse_pt_iters, cache.coarse)):
            v = 1 + strides.index(stride) if stride > 1 else 0
            idx = self._coarse_index(i)
            tp = templ_s[..., None] if templ_s.dim() == 2 else templ_s
            st = am.init(tp)
            hi = min(hi + int(n_it), prm.max_iters)
            out.append(_Phase(hi, region._replace(
                base_pts=region.base_pts[:, idx]), st, Js, h0s, imgs[v],
                kernel_ops(v, idx, st, Js)))
        out.append(_Phase(prm.max_iters, region, state.am_state, cache.J0,
                          cache.H0, imgs[0],
                          kernel_ops(0, None, state.am_state, cache.J0)))
        return out

    def _lm_decide(self, ph: _Phase, ssm_state: torch.Tensor,
                   p_am: torch.Tensor, offset, f_new: torch.Tensor,
                   f_prev: torch.Tensor, moved: torch.Tensor):
        """LM's accept/reject of a step to (`ssm_state`, `p_am`): keep it
        where f does not fall; a kept step that `moved` the corners less
        than epsilon is done. Returns (accept, done), each (B,)."""
        accept = f_new >= f_prev
        return accept, accept & moved

    def _step(self, state: TrackerState, c: _Carry, ph: _Phase, fused: bool,
              offset, offs3, masked: bool) -> _Carry:
        """One iteration of every tracker, LM accept/reject and the done
        test, frozen where a tracker is not active (with done masks)."""
        prm, ssm = self.prm, self.ssm
        dq = (self._iteration_fused(state, c, ph, offs3) if fused
              else self._iteration(state, c, ph, offset))
        new_ssm, new_pam = self._apply_dq(c.ssm_state, c.p_am, dq)
        if not masked and c.lm_delta is None:
            return c._replace(ssm_state=new_ssm, p_am=new_pam, it=c.it + 1)

        done = c.done
        if masked:
            def corners_of(s):
                return W.apply_warp(state.region.norm_mat, ssm.warp_pts(
                    s, state.region.base_corners))

            done = torch.linalg.vector_norm(
                corners_of(new_ssm) - corners_of(c.ssm_state),
                dim=-1).amax(-1) < prm.epsilon
        delta, f_keep = c.lm_delta, c.f_prev
        if c.lm_delta is not None:
            # keep a step only where it does not lower f
            f_new = self._f(ph, new_ssm, new_pam, offset)
            accept, done = self._lm_decide(ph, new_ssm, new_pam, offset,
                                           f_new, c.f_prev, done)
            new_ssm = torch.where(accept[:, None], new_ssm, c.ssm_state)
            new_pam = torch.where(accept[:, None], new_pam, c.p_am)
            delta = torch.where(accept, delta * prm.lm_down,
                                delta * prm.lm_up)
            f_keep = torch.where(accept, f_new, c.f_prev)
        new = _Carry(new_ssm, new_pam, c.it + 1, done, delta, f_keep)
        if not masked:
            return new
        active = (c.it < ph.hi) & ~c.done
        return _Carry(*[
            o if o is None else torch.where(
                active.view((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, c)])

    def _update(self, state: TrackerState,
                frame: torch.Tensor) -> TrackerState:
        frame = self._frame(frame)
        return self._track(state, self._fused_ok(state, frame),
                           lambda strides, fused: self._views(
                               state, frame, strides, fused))

    def _update_multi(self, state: TrackerState, frames) -> TrackerState:
        # the route is the one a shared frame of these frames' shape takes
        one = (frames.frames[0] if isinstance(frames, interp.FrameStack)
               else frames[0])
        fused = self._fused_ok(state, self._frame(one))
        return self._track(state, fused, lambda strides, fused:
                           self._views_multi(state, frames, strides, fused))

    def _track(self, state: TrackerState, fused: bool,
               views) -> TrackerState:
        """The update on the images `views(strides, fused)` gives."""
        prm, am = self.prm, self.am
        cache = state.extra
        if (not prm.coarse_pt_iters or not cache.coarse
                or (not fused and state.spi_mask is not None)):
            # generic phases need no external mask (`mtf_tpu/sm/lk.py:
            # 709-711`)
            cache = cache._replace(coarse=())
        strides = [st for (st, _), _ in zip(prm.coarse_pt_iters, cache.coarse)
                   if st > 1]
        imgs, kwins, offset = views(strides, fused)
        offs3 = None
        if fused:
            b = state.ssm_state.shape[0]
            offs3 = (F.pad(offset, (0, 1)) if offset is not None
                     else state.ssm_state.new_zeros(b, 3))
        phases = self._phases(state, cache, imgs, kwins if fused else None,
                              strides)
        masked = prm.epsilon > 0.0
        b = state.ssm_state.shape[0]
        dev = state.ssm_state.device
        c = _Carry(state.ssm_state, state.am_state.p_am,
                   torch.zeros(b, dtype=torch.long, device=dev) if masked
                   else 0, torch.zeros(b, dtype=torch.bool, device=dev),
                   (torch.full((b,), prm.lm_delta0, device=dev)
                    if prm.enable_lm else None), None)
        for k, ph in enumerate(phases):
            if k == len(phases) - 1 and k > 0:
                # the full-resolution iterations set the converged fixed
                # point: a coarse phase's done (at its own optimum) re-arms
                c = c._replace(done=torch.zeros_like(c.done))
            if prm.enable_lm:
                # the phase's own objective, re-seeded at its start
                c = c._replace(f_prev=self._f(ph, c.ssm_state, c.p_am,
                                              offset))
            if not masked:
                for _ in range(c.it, ph.hi):
                    c = self._step(state, c, ph, fused, offset, offs3, False)
                continue
            for _ in range(ph.hi):
                if not bool(((c.it < ph.hi) & ~c.done).any()):
                    break
                c = self._step(state, c, ph, fused, offset, offs3, True)
        new_state = state._replace(
            ssm_state=c.ssm_state,
            am_state=state.am_state._replace(p_am=c.p_am))
        if not am.needs_update_model:
            return new_state
        # online template learning from the final patch
        final = phases[-1]
        patch = self._sample(final.img, self._pts(
            final.region, c.ssm_state, torch.zeros_like(c.ssm_state)),
            offset, False, prm.crop)[0]
        return new_state._replace(am_state=am.update_model(
            new_state.am_state, am.ilm.apply(patch, c.p_am)))


class FCLK(LKBase):
    """Forward compositional LK (NT/FCLK.cc)."""
    name = "fclk"


class ICLK(LKBase):
    """Inverse compositional LK: the template Jacobian and Hessian cached
    at init, inverse update (NT/ICLK.cc)."""
    name = "iclk"
    inverse = True


class ESM(LKBase):
    """Efficient second-order minimization: mean of the init and current
    Jacobians (NT/ESM.cc:228-230)."""
    name = "esm"
    use_esm_jac = True


class AESM(ESM):
    """Additive ESM (NT/AESM.cc)."""
    name = "aesm"
    compositional = False


class FALK(LKBase):
    """Forward additive LK (NT/FALK.cc)."""
    name = "falk"
    compositional = False


class IALK(LKBase):
    """Inverse additive LK (NT/IALK.cc): the template Jacobian, additive
    inverted update."""
    name = "ialk"
    compositional = False
    inverse = True

    def _apply_dq(self, ssm_state, p_am, dq):
        S = self.ssm.dof
        return ssm_state - dq[:, :S], p_am + dq[:, S:]


class FCSD(LKBase):
    """Forward compositional steepest ascent with a learning rate
    (NT/FCSD.cc): dq = sd_learning_rate * j, j the similarity's gradient
    in q. The JAX package's `FCSD._iteration` (`mtf_tpu/sm/lk.py:851`)
    does not match the signature its caller uses, so every JAX `fcsd`
    update raises; this is the step it intends."""
    name = "fcsd"
    steepest = True


SM_LK_REGISTRY = {
    "fclk": FCLK, "fc": FCLK,
    "iclk": ICLK, "ic": ICLK,
    "esm": ESM, "aesm": AESM,
    "falk": FALK, "fa": FALK,
    "ialk": IALK, "ia": IALK,
    "fcsd": FCSD,
    # Levenberg-Marquardt variants
    "eslm": ESM, "esl": ESM, "aelm": AESM, "fclm": FCLK, "iclm": ICLK,
    "falm": FALK, "ialm": IALK,
    # variants that collapse in the JAX package too
    "fesm": ESM, "esmh": ESM, "ialk2": IALK,
}

LM_KEYS = {"eslm", "esl", "aelm", "fclm", "iclm", "falm", "ialm"}
