"""Tracker factory (port of `mtf_tpu/factory.py` for the LK slices).

    create_tracker("esm", "ncc", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=144,
                   coarse_pt_iters=((4, 6), (2, 3)))

The tracker lives on the card unless `device` says otherwise
(`device="cpu"` for a CPU run); without a card and without `device` it
raises. Keys and options outside the ported slices raise
`NotImplementedError` naming the ROADMAP queue that brings them.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any

from mtf_tpu_torch.am import AMParams, get_am
from mtf_tpu_torch.sm.core import SMParams
from mtf_tpu_torch.sm.lk import LM_KEYS, SM_LK_REGISTRY
from mtf_tpu_torch.ssm import get_ssm

_KNOWN_CFG = {"resx", "resy", "mtf_res", "max_iters", "epsilon", "interp",
              "border", "crop", "coarse_pt_iters", "hess_type", "jac_type",
              "enable_lm"}

# where each unported SM key is queued: "1b" is the rest of slice 2
_SLICE_OF_SM = {
    "iclk": "1b", "ic": "1b", "iclm": "1b", "aesm": "1, slice 4",
    "rklt": "1, slice 3", "rkl": "1, slice 3", "lmes": "1, slice 3",
    "grid": "1, slice 3", "lms": "1, slice 3", "ransac": "1, slice 3",
    "rnsc": "1, slice 3", "casc": "1, slice 3", "prl": "1, slice 3",
    "pyr": "1, slice 3", "hrch": "1, slice 3", "falk": "1, slice 4",
    "fa": "1, slice 4", "ialk": "1, slice 4", "ia": "1, slice 4",
    "fcsd": "1, slice 4", "falm": "1, slice 4", "ialm": "1, slice 4",
    "aelm": "1, slice 4", "pf": "1, slice 5", "nn": "1, slice 5",
    "gnn": "1, slice 5", "regnet": "1, slice 5", "lp": "1, slice 5",
}


def _stride_pair(v):
    """One coarse_pt_iters phase: (stride, iters) or "stride:iters"."""
    if isinstance(v, str):
        a, b = v.split(":")
        return (int(a), int(b))
    s, n = v
    return (int(s), int(n))


def create_tracker(sm: str = "fclk", am: str = "ssd", ssm: str = "8",
                   ilm: str | None = None, device=None, **cfg: Any):
    """Reference `mtf::getTracker(sm, am, ssm, ilm)` analog for the
    ported slices; the tracker's tensors live on `device` (None: the
    card)."""
    sm_key = sm.lower()
    if sm_key not in SM_LK_REGISTRY:
        where = _SLICE_OF_SM.get(sm_key, "1, slice 7")
        raise NotImplementedError(
            f"SM {sm!r} is not ported yet: it comes with ROADMAP Queue "
            f"{where}")
    unknown = sorted(set(cfg) - _KNOWN_CFG)
    if unknown:
        raise NotImplementedError(
            f"options {unknown} are not ported yet: the LK options beyond "
            "slices 1 and 2 come with ROADMAP Queue 1b and Queue 1, "
            "slice 4")
    prm = SMParams(
        max_iters=int(cfg.get("max_iters", 30)),
        epsilon=float(cfg.get("epsilon", 0.01)),
        interp=str(cfg.get("interp", "linear")),
        border=str(cfg.get("border", "replicate")),
        crop=int(cfg["crop"]) if cfg.get("crop") else None,
        coarse_pt_iters=tuple(
            _stride_pair(v) for v in cfg.get("coarse_pt_iters", ())),
        # the factory's default, unlike SMParams's "self0"
        hess_type=str(cfg.get("hess_type", "selft")),
        jac_type=str(cfg.get("jac_type", "original")),
        enable_lm=bool(cfg.get("enable_lm", False)),
    )
    if sm_key in LM_KEYS:
        prm = replace(prm, enable_lm=True)
    am_prm = AMParams(resx=int(cfg.get("resx", cfg.get("mtf_res", 50))),
                      resy=int(cfg.get("resy", cfg.get("mtf_res", 50))))
    return SM_LK_REGISTRY[sm_key](get_am(am, am_prm, ilm=ilm),
                                  get_ssm(ssm, device=device), prm)
