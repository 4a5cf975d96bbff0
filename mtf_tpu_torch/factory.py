"""Tracker factory (port of `mtf_tpu/factory.py` for the LK slice).

    create_tracker("fclk", "ssd", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=144,
                   coarse_pt_iters=((4, 6), (2, 3)), device="cuda")

Keys and options outside the ported slice raise `NotImplementedError`
naming the ROADMAP slice that brings them.
"""
from __future__ import annotations

from typing import Any

from mtf_tpu_torch.am import AMParams, get_am
from mtf_tpu_torch.sm.core import SMParams
from mtf_tpu_torch.sm.lk import SM_LK_REGISTRY
from mtf_tpu_torch.ssm import get_ssm

_KNOWN_CFG = {"resx", "resy", "mtf_res", "max_iters", "epsilon", "interp",
              "border", "crop", "coarse_pt_iters", "hess_type"}

_SLICE_OF_SM = {
    "iclk": 2, "ic": 2, "esm": 2, "aesm": 4, "eslm": 2, "esl": 2, "fclm": 2,
    "iclm": 2, "rklt": 3, "rkl": 3, "lmes": 3, "grid": 3, "lms": 3,
    "ransac": 3, "rnsc": 3, "casc": 3, "prl": 3, "pyr": 3, "hrch": 3,
    "falk": 4, "fa": 4, "ialk": 4, "ia": 4, "fcsd": 4, "falm": 4, "ialm": 4,
    "aelm": 4, "pf": 5, "nn": 5, "gnn": 5, "regnet": 5, "lp": 5,
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
    ported slice; the tracker's tensors live on `device`."""
    sm_key = sm.lower()
    if sm_key not in SM_LK_REGISTRY:
        slice_no = _SLICE_OF_SM.get(sm_key, 7)
        raise NotImplementedError(
            f"SM {sm!r} is not ported yet: it comes with ROADMAP Queue 1, "
            f"slice {slice_no}")
    unknown = sorted(set(cfg) - _KNOWN_CFG)
    if unknown:
        raise NotImplementedError(
            f"options {unknown} are not ported yet: the LK options beyond "
            "slice 1 come with ROADMAP Queue 1, slices 2 and 4")
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
    )
    am_prm = AMParams(resx=int(cfg.get("resx", cfg.get("mtf_res", 50))),
                      resy=int(cfg.get("resy", cfg.get("mtf_res", 50))))
    return SM_LK_REGISTRY[sm_key](get_am(am, am_prm, ilm=ilm),
                                  get_ssm(ssm, device=device), prm)
