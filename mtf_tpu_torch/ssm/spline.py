"""Non-rigid SSMs (port of `mtf_tpu/ssm/spline.py`): the control-point
Spline and the thin-plate spline (TPS).

The state (..., 2K) holds the displacements of K control points in the
normalized template frame, and the warp is x + D(x; state), where D
interpolates the control displacements: a normalized product of 1-D
influence kernels over the control grid (Spline) or the TPS radial-basis
solve, whose (K+3) x (K+3) system inverse is computed once at
construction (TPS). Both are linear in the state, so updates are
additive whatever the search method's flavour, and `dwdp_*` (by
`torch.func.jacfwd`) does not depend on it. They have no 3x3 matrix
form: `to_matrix` raises, and the LK search methods run them on their
generic path.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mtf_tpu_torch import _device
from mtf_tpu_torch.ssm.base import SSM, jacfwd_warp


def _control_grid(kx: int, ky: int, span: float = 1.1) -> np.ndarray:
    """(K, 2) control points covering the normalized template square."""
    xs = np.linspace(-span, span, kx)
    ys = np.linspace(-span, span, ky)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


class NonRigidSSM(nn.Module):
    """Shared additive displacement-field machinery over batched states
    (..., S) and points (..., N, 2)."""

    name = "nonrigid"
    dof = 0

    def __init__(self, ctrl: np.ndarray, device=None):
        super().__init__()
        self.register_buffer("ctrl", torch.as_tensor(
            ctrl, dtype=torch.float32, device=_device.resolve(device)))

    @property
    def device(self) -> torch.device:
        return self.ctrl.device

    def displacement(self, state: torch.Tensor,
                     pts: torch.Tensor) -> torch.Tensor:
        """(..., N, 2) displacement field at pts."""
        raise NotImplementedError

    def identity(self, batch: tuple = (), dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(tuple(batch) + (self.dof,), dtype=dtype,
                           device=self.device)

    def warp_pts(self, state: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        return pts + self.displacement(state, pts)

    def warp_pts_from(self, state: torch.Tensor, dp: torch.Tensor,
                      pts: torch.Tensor,
                      compositional: bool = True) -> torch.Tensor:
        # compositional == additive for displacement fields
        return self.warp_pts(state + dp, pts)

    def to_matrix(self, state):
        raise TypeError(f"{self.name} is non-rigid: no 3x3 matrix form")

    def from_matrix(self, mat):
        raise TypeError(f"{self.name} is non-rigid: no 3x3 matrix form")

    def compose(self, s1, s2):
        return s1 + s2

    def invert(self, state):
        return -state

    def compositional_update(self, state, dp):
        return state + dp

    def inverse_compositional_update(self, state, dp):
        return state - dp

    def additive_update(self, state, dp):
        return state + dp

    # the matrix SSMs' samplers and corner fit hold as written: compose,
    # invert and the fractional warp are additive here
    random_walk = SSM.random_walk
    auto_regression1 = SSM.auto_regression1
    scale_state = SSM.scale_state
    mean_of_samples = SSM.mean_of_samples
    fit_corners = SSM.fit_corners

    def dwdp_at(self, state: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """(..., N, 2, S) warp Jacobian at `state` (..., S), pts
        (..., N, 2)."""
        return jacfwd_warp(self, state, pts)

    def dwdp_identity(self, pts: torch.Tensor) -> torch.Tensor:
        return self.dwdp_at(self.identity(), pts)

    def fit_pts(self, src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
        """Ridge least-squares control displacements (..., S) from
        correspondences (..., N, 2), optionally weighted per point:
        minimal-norm where underdetermined (4 corners)."""
        A = self.dwdp_identity(src).flatten(-3, -2)          # (..., 2N, S)
        r = (dst - src).flatten(-2)
        if weights is not None:
            w = torch.repeat_interleave(weights, 2, dim=-1)
            A = A * w[..., None]
            r = r * w
        At = A.transpose(-1, -2)
        AtA = At @ A + 1e-4 * torch.eye(self.dof, dtype=A.dtype,
                                        device=A.device)
        return torch.linalg.solve(AtA, (At @ r[..., None]))[..., 0]

    def state_sigma_from_pixel_sigma(self, pix_sigma, pts):
        # control displacements are already in point units
        return torch.full((self.dof,), float(pix_sigma), device=self.device)


def _spline_kernel(d: torch.Tensor, interp_type: str) -> torch.Tensor:
    """Truncated 1-D influence kernel on normalized distance d (support
    |d| <= 1): `bilinear`, or quadratic / cubic B-spline kernels rescaled
    to the same support (`biquadratic`, `bicubic`)."""
    a = torch.abs(d)
    if interp_type == "bilinear":
        return torch.clamp(1.0 - a, min=0.0)
    zero = torch.zeros_like(a)
    if interp_type == "biquadratic":
        t = a * 1.5
        return torch.where(t < 0.5, 0.75 - t * t,
                           torch.where(t < 1.5, 0.5 * (1.5 - t) ** 2, zero))
    if interp_type == "bicubic":
        t = a * 2.0
        return torch.where(t < 1.0, 2.0 / 3.0 - t * t + 0.5 * t ** 3,
                           torch.where(t < 2.0, (2.0 - t) ** 3 / 6.0, zero))
    raise ValueError(f"unknown spline interp_type {interp_type!r}")


class Spline(NonRigidSSM):
    """Control-point grid with per-point influence regions: each control
    point's kernel spans half the control spacing plus `overlap` of it,
    and the per-point weights are normalized to a partition of unity."""

    name = "spline"

    def __init__(self, kx: int = 5, ky: int = 5, span: float = 1.1,
                 overlap: float = 0.1, interp_type: str = "bilinear",
                 device=None):
        _spline_kernel(torch.zeros(()), interp_type)  # validate early
        super().__init__(_control_grid(kx, ky, span), device)
        self.kx, self.ky, self.span = kx, ky, span
        self.overlap = overlap
        self.interp_type = interp_type
        self.dof = 2 * kx * ky
        sx = 2.0 * span / max(kx - 1, 1)
        sy = 2.0 * span / max(ky - 1, 1)
        self._dist_norm = (0.5 * sx + overlap * sx, 0.5 * sy + overlap * sy)

    def weights(self, pts: torch.Tensor) -> torch.Tensor:
        """(..., N, K) normalized control-point influence weights."""
        dnx, dny = self._dist_norm
        dx = (pts[..., 0:1] - self.ctrl[:, 0]) / dnx
        dy = (pts[..., 1:2] - self.ctrl[:, 1]) / dny
        w = (_spline_kernel(dx, self.interp_type)
             * _spline_kernel(dy, self.interp_type))
        return w / (w.sum(-1, keepdim=True) + 1e-12)

    def displacement(self, state, pts):
        D = state.reshape(state.shape[:-1] + (self.kx * self.ky, 2))
        return self.weights(pts) @ D


class TPS(NonRigidSSM):
    """Thin-plate spline over K anchor points; the bending system inverse
    (float64, rounded to float32) makes each warp one (N, K+3) product."""

    name = "tps"

    def __init__(self, kx: int = 4, ky: int = 4, span: float = 1.0,
                 reg: float = 1e-4, device=None):
        ctrl = _control_grid(kx, ky, span)
        super().__init__(ctrl, device)
        K = ctrl.shape[0]
        self.dof = 2 * K
        self.n_ctrl = K
        # L = [[U + reg*I, P], [P^T, 0]],  P = [1, x, y]
        d2 = np.sum((ctrl[:, None] - ctrl[None]) ** 2, axis=-1)
        U = np.where(d2 > 1e-12, d2 * np.log(d2 + 1e-12), 0.0)
        P = np.concatenate([np.ones((K, 1)), ctrl], axis=1)
        L = np.zeros((K + 3, K + 3), np.float64)
        L[:K, :K] = U + reg * np.eye(K)
        L[:K, K:] = P
        L[K:, :K] = P.T
        self.register_buffer("L_inv", torch.as_tensor(
            np.linalg.inv(L), dtype=torch.float32, device=self.device))

    def displacement(self, state, pts):
        K = self.n_ctrl
        disp = state.reshape(state.shape[:-1] + (K, 2))
        rhs = torch.cat([disp, disp.new_zeros(disp.shape[:-2] + (3, 2))],
                        dim=-2)
        params = self.L_inv @ rhs                            # (..., K+3, 2)
        d2 = ((pts[..., :, None, :] - self.ctrl) ** 2).sum(-1)   # (..., N, K)
        U = torch.where(d2 > 1e-12, d2 * torch.log(d2 + 1e-12),
                        torch.zeros_like(d2))
        basis = torch.cat([U, torch.ones_like(pts[..., :1]), pts], dim=-1)
        return basis @ params


SPLINE_REGISTRY = {"spline": Spline, "spl": Spline, "tps": TPS}
