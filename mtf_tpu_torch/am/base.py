"""Appearance-model base (port of `mtf_tpu/am/base.py`), over B trackers.

An AM is one similarity f(state, patch) per tracker, higher is better,
on patches (B, N, C); any leading dims broadcast against the state's
(the particle filter scores (B, P, N, C) particle patches against
states whose leaves carry a particle axis of 1). Its derivatives come from `torch.func`, as the JAX
package takes them from `jax.grad` and `jax.jvp`: the trackers are
independent, so the gradient of the sum of f over the batch is each
tracker's own gradient, and one Hessian-vector product per Jacobian
column (vmapped over the columns) gives J^T (d2f/dI2) J for all of them.

    grad / grad_corrected   df/dIt (raw / illumination-corrected patch)
    grad_template           df/dI0, through `init` (NCC: through the
                            centred unit template re-derived from the raw
                            template; MI, CCRE: through the template's
                            Parzen weights)
    gn_hessian              J^T (d2f/dI2 at the current patch) J
    self_hessian            the same at a perfect match (template = patch)

The chain kernel's SSD and NCC modes form the same gradient and self
Hessians in closed form (`ops/kernels/lk_fused.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch


class AMState(NamedTuple):
    """Appearance side of the tracker state.

    template: raw template patch (B, N, C), C >= 1 channels
    p_am:     photometric params (B, P); empty for plain AMs
    extra:    per-AM extras (SSD, SSIM, SPSS: none; NCC: (n0,), the
              centred unit template (B, N, C); MI, CCRE: (w0,), the
              template's Parzen weights (B, C, N, n_bins); KLD: (p0,),
              its marginals (B, C, n_bins); LKLD: per block
              (B, k·k, C, n_bins))
    """
    template: torch.Tensor
    p_am: torch.Tensor
    extra: Any = ()


@dataclass(frozen=True)
class AMParams:
    """Shared AM configuration (reference AMParams.h:13-40)."""
    resx: int = 50
    resy: int = 50
    n_channels: int = 1        # 3 for the multi-channel keys (mcssd, ncc3)
    likelihood_alpha: float = 50.0
    likelihood_beta: float = 0.0
    pix_min: float = 0.0
    pix_max: float = 255.0
    n_bins: int = 8            # MI/CCRE/KLD/SCV histograms
    pre_seed: float = 1.0
    learning_rate: float = 0.0  # template forgetting (0 = no update)
    extra: dict = field(default_factory=dict)


class PerDevice:
    """A constant numpy array as a tensor on each device it is used on,
    made once per device."""

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self._on = {}

    def on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.arr, device=device)
        return self._on[key]


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

    def invert_params(self, p: torch.Tensor) -> torch.Tensor:
        return -p


class AM:
    """Base appearance model; subclasses implement `_similarity` on
    illumination-corrected patches, (B,) from (B, N, C)."""

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

    def f_with_pam(self, state: AMState, patch: torch.Tensor,
                   p_am: torch.Tensor) -> torch.Tensor:
        return self._similarity(state, self.ilm.apply(patch, p_am))

    def f_corrected(self, state: AMState, corrected: torch.Tensor
                    ) -> torch.Tensor:
        """Similarity on an already illumination-corrected patch (the LM
        objective of the LK path)."""
        return self._similarity(state, corrected)

    def grad(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """df/dIt, the shape of patch (reference `updateCurrGrad`)."""
        return torch.func.grad(lambda p: self.f(state, p).sum())(patch)

    def grad_corrected(self, state: AMState,
                       corrected: torch.Tensor) -> torch.Tensor:
        return torch.func.grad(
            lambda p: self._similarity(state, p).sum())(corrected)

    def grad_template(self, state: AMState,
                      corrected: torch.Tensor) -> torch.Tensor:
        """df/dI0 w.r.t. the raw template, re-deriving the AM's processed
        template through `init` (reference `updateInitGrad`)."""
        def f_of_t(t):
            st = self.init(t)._replace(p_am=state.p_am)
            return self._similarity(st, corrected).sum()
        return torch.func.grad(f_of_t)(state.template)

    def update_state(self, state: AMState, dp_am: torch.Tensor) -> AMState:
        """p_am <- p_am + dp_am (reference `updateState`)."""
        if self.ilm.n_params == 0:
            return state
        return state._replace(p_am=state.p_am + dp_am)

    @property
    def needs_update_model(self) -> bool:
        """False when `update_model` is a no-op, so the LK update can skip
        sampling the final patch."""
        return self.prm.learning_rate > 0.0

    def update_model(self, state: AMState, patch: torch.Tensor) -> AMState:
        """Online template learning: exponential forgetting of the raw
        template at `learning_rate` (reference `updateModel`)."""
        lr = self.prm.learning_rate
        if lr <= 0.0:
            return state
        return state._replace(
            template=(1.0 - lr) * state.template + lr * patch)

    def likelihood(self, state: AMState, patch: torch.Tensor) -> torch.Tensor:
        """Sampler-facing likelihood (`getLikelihood`): exp(alpha f) by
        default; SSIM, SPSS, MI and CCRE override it."""
        return torch.exp(self.prm.likelihood_alpha * self.f(state, patch))

    def dist_feat(self, patch: torch.Tensor) -> torch.Tensor:
        """Feature vector (..., D) of patches (..., N, C) for the NN
        search's distance (`updateDistFeat`): the flat raw patch (n·C + c)
        by default."""
        return patch.flatten(-2)

    def self_state(self, patch: torch.Tensor, p_am: torch.Tensor) -> AMState:
        """The state that takes `patch` as its template (current-self
        Hessians), through `init`."""
        return self.init(patch)._replace(p_am=p_am)


def jacobian(am: AM, state: AMState, patch: torch.Tensor,
             J_pix: torch.Tensor) -> torch.Tensor:
    """(B, S) similarity Jacobian (df/dIt) . dIt/dp, J_pix (B, N·C, S)
    (`cmptCurrJacobian`)."""
    g = am.grad(state, patch).flatten(1)
    return (g[:, None] @ J_pix)[:, 0]


def gn_hessian(am: AM, state: AMState, patch: torch.Tensor,
               J_pix: torch.Tensor) -> torch.Tensor:
    """(B, S, S) J^T (d2f/dI2) J at the current patch, J_pix (B, N·C, S):
    one Hessian-vector product per column (`cmptCurrHessian`)."""
    shape = patch.shape

    def g(p_flat):
        return am.grad(state, p_flat.reshape(shape)).flatten(1)

    p0 = patch.flatten(1)
    cols = torch.func.vmap(lambda v: torch.func.jvp(g, (p0,), (v,))[1],
                           in_dims=-1, out_dims=-1)(J_pix)
    return J_pix.transpose(1, 2) @ cols


def self_hessian(am: AM, patch: torch.Tensor, p_am: torch.Tensor,
                 J_pix: torch.Tensor) -> torch.Tensor:
    """(B, S, S) self Hessian: d2f/dI2 at a perfect match (template ==
    patch) contracted with J (`cmptSelfHessian`)."""
    return gn_hessian(am, am.self_state(patch, p_am), patch, J_pix)
