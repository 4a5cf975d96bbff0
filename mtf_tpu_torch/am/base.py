"""Appearance-model base (port of `mtf_tpu/am/base.py`).

The JAX package derives every AM derivative by AD. The ported slice
needs none: for SSD the patch gradient is the residual and the self
Hessian is exactly -J^T J, which the LK path forms in closed form.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


class AMState(NamedTuple):
    """Appearance side of the tracker state.

    template: raw template patch (B, N, C)
    p_am:     photometric params (B, P); empty for plain AMs
    extra:    per-AM extras (none for SSD)
    """
    template: torch.Tensor
    p_am: torch.Tensor
    extra: Any = ()


@dataclass(frozen=True)
class AMParams:
    """Shared AM configuration (the fields the ported slice reads)."""
    resx: int = 50
    resy: int = 50


class IlluminationModel:
    """Identity photometric map (no illumination parameters)."""

    name = "none"
    n_params = 0

    def apply(self, patch: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return patch

    def identity_params(self, batch: tuple = (), dtype=torch.float32,
                        device=None) -> torch.Tensor:
        return torch.zeros(tuple(batch) + (self.n_params,), dtype=dtype,
                           device=device)


class AM:
    """Base appearance model; subclasses implement `_similarity` on
    illumination-corrected patches."""

    name = "base"

    def __init__(self, params: AMParams | None = None,
                 ilm: IlluminationModel | None = None):
        self.prm = params or AMParams()
        self.ilm = ilm or IlluminationModel()

    def _similarity(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def init(self, patch0: torch.Tensor) -> AMState:
        """Template initialization from patches (B, N, C)."""
        return AMState(template=patch0,
                       p_am=self.ilm.identity_params(
                           patch0.shape[:-2], patch0.dtype, patch0.device))

    def f(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """Similarity of candidate patches vs state (higher = better)."""
        return self._similarity(state, self.ilm.apply(patch, state.p_am))
