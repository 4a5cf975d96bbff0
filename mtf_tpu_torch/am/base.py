"""Appearance-model base (port of `mtf_tpu/am/base.py`).

The JAX package derives every AM derivative by AD. The ported slices
need none: for SSD the patch gradient is the residual and the self
Hessian is exactly -J^T J; for NCC the chain kernel's moments give the
gradient and self Hessian in closed form (`ops/kernels/lk_fused.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


class AMState(NamedTuple):
    """Appearance side of the tracker state.

    template: raw template patch (B, N, C), C >= 1 channels
    p_am:     photometric params (B, P); empty for plain AMs
    extra:    per-AM extras (SSD: none; NCC: (n0,), the centred unit
              template (B, N, C))
    """
    template: torch.Tensor
    p_am: torch.Tensor
    extra: Any = ()


@dataclass(frozen=True)
class AMParams:
    """Shared AM configuration (the fields the ported slices read)."""
    resx: int = 50
    resy: int = 50
    n_channels: int = 1     # 3 for the multi-channel keys (mcssd, ssd3)


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

    def _init_extra(self, patch0: torch.Tensor):
        return ()

    def init(self, patch0: torch.Tensor) -> AMState:
        """Template initialization from patches (B, N, C)."""
        return AMState(template=patch0,
                       p_am=self.ilm.identity_params(
                           patch0.shape[:-2], patch0.dtype, patch0.device),
                       extra=self._init_extra(patch0))

    def f(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """Similarity of candidate patches vs state (higher = better)."""
        return self._similarity(state, self.ilm.apply(patch, state.p_am))

    def f_corrected(self, state: AMState, corrected: torch.Tensor
                    ) -> torch.Tensor:
        """Similarity on an already illumination-corrected patch (the LM
        objective of the LK path)."""
        return self._similarity(state, corrected)
