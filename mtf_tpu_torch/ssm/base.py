"""State-space model algebra (port of `mtf_tpu/ssm/base.py`).

An SSM is an `nn.Module` whose only tensors are its generator basis
(a registered buffer, so `.to(device)` moves it) and, for the Lie SSMs,
the basis's pseudo-inverse; both live on the card unless `device` says
otherwise. Its methods are plain functions of batched states (..., S)
and 3x3 warps (..., 3, 3).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mtf_tpu_torch import _device
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.linalg import inv3x3


def _sqrtm_db(A: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Principal square root of (..., 3, 3) matrices by the
    Denman-Beavers iteration."""
    Y = A
    Z = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(iters):
        Y, Z = 0.5 * (Y + inv3x3(Z)), 0.5 * (Z + inv3x3(Y))
    return Y


def logm_3x3(A: torch.Tensor, num_sqrts: int = 3,
             series_terms: int = 12) -> torch.Tensor:
    """Principal log of near-identity (..., 3, 3) matrices: `num_sqrts`
    Denman-Beavers square roots, a truncated log(I + X) series, scaled
    back by 2^num_sqrts (the JAX package's inverse scaling and
    squaring)."""
    for _ in range(num_sqrts):
        A = _sqrtm_db(A)
    X = A - torch.eye(3, dtype=A.dtype, device=A.device)
    out = torch.zeros_like(A)
    Xp = X
    for k in range(1, series_terms + 1):
        out = out + ((-1.0) ** (k + 1)) / k * Xp
        Xp = Xp @ X
    return out * (2.0 ** num_sqrts)


class SSM(nn.Module):
    """Base class: subclasses define name/dof/generators and
    to/from-matrix."""

    name: str = "base"
    dof: int = 0

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("generators", torch.as_tensor(
            self._generators(), dtype=torch.float32,
            device=_device.resolve(device)))

    def _generators(self):  # (dof, 3, 3)
        raise NotImplementedError

    def to_matrix(self, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def from_matrix(self, mat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def identity(self, batch: tuple = (), dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(tuple(batch) + (self.dof,), dtype=dtype,
                           device=self.generators.device)

    def warp_pts(self, state: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        return W.apply_warp(self.to_matrix(state), pts)

    def fit_pts(self, src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
        """Least-squares state (..., S) mapping src to dst points
        (..., N, 2), optionally weighted per point (..., N): the
        homography DLT at 8 DOF or more, the affine one at 5 or more,
        else the similitude one, projected through `from_matrix`.
        Low-DOF subclasses override it with closed forms."""
        if self.dof >= 8:
            mat = W.homography_dlt(src, dst, weights)
        elif self.dof >= 5:
            mat = W.affine_dlt(src, dst, weights)
        else:
            mat = W.similitude_dlt(src, dst, weights)
        return self.from_matrix(mat)

    def compose(self, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        """State of W(s1) @ W(s2) (s2 applied first in the template
        frame), at full float32 precision."""
        return self.from_matrix(self.to_matrix(s1) @ self.to_matrix(s2))

    def invert(self, state: torch.Tensor) -> torch.Tensor:
        return self.from_matrix(inv3x3(self.to_matrix(state)))

    def compositional_update(self, state: torch.Tensor,
                             dp: torch.Tensor) -> torch.Tensor:
        """p <- p o dp."""
        return self.compose(state, dp)

    def inverse_compositional_update(self, state: torch.Tensor,
                                     dp: torch.Tensor) -> torch.Tensor:
        """p <- p o dp^-1."""
        return self.from_matrix(self.to_matrix(state)
                                @ inv3x3(self.to_matrix(dp)))

    def additive_update(self, state: torch.Tensor,
                        dp: torch.Tensor) -> torch.Tensor:
        return state + dp

    def warp_pts_from(self, state: torch.Tensor, dp: torch.Tensor,
                      pts: torch.Tensor,
                      compositional: bool = True) -> torch.Tensor:
        """Warp pts by the state perturbed with update dp."""
        if compositional:
            M = self.to_matrix(state) @ self.to_matrix(dp)
        else:
            M = self.to_matrix(state + dp)
        return W.apply_warp(M, pts)


class AdditiveMatrixSSM(SSM):
    """W(p) = I + sum_i p_i G_i."""

    def to_matrix(self, state: torch.Tensor) -> torch.Tensor:
        eye = torch.eye(3, dtype=state.dtype, device=state.device)
        return eye + torch.einsum("...s,sij->...ij", state, self.generators)


class ExpSSM(SSM):
    """W(p) = expm(sum_i p_i G_i) (the Lie parameterizations). The
    generator basis is constant, so the least-squares projection onto it
    is a product with its pseudo-inverse, computed once (float64) and
    kept as a buffer."""

    def __init__(self, device=None):
        super().__init__(device)
        gflat = np.asarray(self._generators(), np.float64).reshape(
            self.dof, 9)
        self.register_buffer("gens_pinv", torch.as_tensor(
            np.linalg.pinv(gflat.T), dtype=torch.float32,
            device=self.generators.device))                 # (dof, 9)

    def to_matrix(self, state: torch.Tensor) -> torch.Tensor:
        return torch.linalg.matrix_exp(
            torch.einsum("...s,sij->...ij", state, self.generators))

    def project_algebra(self, X: torch.Tensor) -> torch.Tensor:
        """Least-squares coefficients (..., dof) of algebra elements
        (..., 3, 3) on the generator basis."""
        return X.flatten(-2) @ self.gens_pinv.T

    def from_matrix(self, mat: torch.Tensor) -> torch.Tensor:
        return self.project_algebra(logm_3x3(self._normalize(mat)))

    def _normalize(self, mat: torch.Tensor) -> torch.Tensor:
        return mat / mat[..., 2:3, 2:3]
