"""State-space model algebra (port of `mtf_tpu/ssm/base.py`).

An SSM is an `nn.Module` whose only tensor is its generator basis
(a registered buffer, so `.to(device)` moves it), on the card unless
`device` says otherwise. Its methods are plain functions of batched
states (..., S) and 3x3 warps (..., 3, 3).
"""
from __future__ import annotations

import torch
from torch import nn

from mtf_tpu_torch import _device
from mtf_tpu_torch.ops import warp as W
from mtf_tpu_torch.ops.linalg import inv3x3


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
