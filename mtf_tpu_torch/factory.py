"""Tracker factory (port of `mtf_tpu/factory.py` for the ported slices).

    create_tracker("esm", "ncc", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=144,
                   coarse_pt_iters=((4, 6), (2, 3)))
    create_tracker("rklt", "ssd", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=160,
                   grid_sub_iters=(1, 8), grid_coarse_stride=2,
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
from mtf_tpu_torch.sm.composite import RKLT, RKLTParams
from mtf_tpu_torch.sm.core import SMParams
from mtf_tpu_torch.sm.grid import GridParams, GridTracker
from mtf_tpu_torch.sm.lk import LM_KEYS, SM_LK_REGISTRY
from mtf_tpu_torch.ssm import get_ssm

_KNOWN_CFG = {"resx", "resy", "mtf_res", "max_iters", "epsilon", "interp",
              "border", "crop", "coarse_pt_iters", "hess_type", "jac_type",
              "enable_lm",
              # grid and RKLT (`_grid_params`)
              "grid_res", "grid_patch_res", "grid_sub_iters",
              "grid_coarse_stride", "grid_estimator", "grid_n_hyps",
              "grid_inlier_thresh", "grid_fb_err", "grid_patch_scale",
              "grid_zncc", "grid_pyramid_levels", "grid_flow", "grid_sm",
              "seed", "rklt_failure_thresh", "rklt_feedback", "enable_spi"}

GRID_KEYS = {"grid": None, "lms": "lmeds", "ransac": "ransac",
             "rnsc": "ransac"}
RKLT_KEYS = {"rklt", "rkl", "lmes"}

# where each unported SM key is queued: "1b" is the rest of slice 2, "1c"
# the rest of slice 3
_SLICE_OF_SM = {
    "iclk": "1b", "ic": "1b", "iclm": "1b", "aesm": "1, slice 4",
    "casc": "1c", "prl": "1c", "pyr": "1c", "hrch": "1c", "hesm": "1c",
    "mf": "1c", "mflow": "1c", "medianflow": "1c", "tld": "1c",
    "gric": "1c", "grfc": "1c", "gres": "1c", "pfrk": "1c", "nnrk": "1c",
    "pfic": "1c", "pffc": "1c", "pfes": "1c", "nnic": "1c", "nnfc": "1c",
    "nnes": "1c", "falk": "1, slice 4",
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


def _sub_iters(v):
    """grid_sub_iters: an int or a per-pyramid-level tuple."""
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return int(v)


def _grid_params(cfg: dict, estimator: str | None = None) -> GridParams:
    return GridParams(
        grid_res=int(cfg.get("grid_res", 10)),
        patch_res=int(cfg.get("grid_patch_res", 8)),
        sub_iters=_sub_iters(cfg.get("grid_sub_iters", 10)),
        coarse_point_stride=int(cfg.get("grid_coarse_stride", 1)),
        estimator=str(estimator or cfg.get("grid_estimator", "ransac")),
        n_hyps=int(cfg.get("grid_n_hyps", 64)),
        inlier_thresh_px=float(cfg.get("grid_inlier_thresh", 2.0)),
        fb_err_px=float(cfg.get("grid_fb_err", -1.0)),
        patch_scale=float(cfg.get("grid_patch_scale", 1.0)),
        zncc=bool(cfg.get("grid_zncc", True)),
        pyramid_levels=int(cfg.get("grid_pyramid_levels",
                                   GridParams.pyramid_levels)),
        flow=str(cfg.get("grid_flow", "warped")).lower(),
        seed=int(cfg.get("seed", 0)),
    )


def create_tracker(sm: str = "fclk", am: str = "ssd", ssm: str = "8",
                   ilm: str | None = None, device=None, **cfg: Any):
    """Reference `mtf::getTracker(sm, am, ssm, ilm)` analog for the
    ported slices; the tracker's tensors live on `device` (None: the
    card)."""
    sm_key = sm.lower()
    if (sm_key not in SM_LK_REGISTRY and sm_key not in GRID_KEYS
            and sm_key not in RKLT_KEYS):
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
    am_prm = AMParams(resx=int(cfg.get("resx", cfg.get("mtf_res", 50))),
                      resy=int(cfg.get("resy", cfg.get("mtf_res", 50))))

    def make_am(key=am, params=am_prm):
        return get_am(key, params, ilm=ilm)

    def make_ssm():
        return get_ssm(ssm, device=device)

    if sm_key in GRID_KEYS:
        # grid_sm selects the per-patch tracker: "flow" / "cv" are the
        # batched flow grid ("cv" pyramidal over 3 levels by default)
        grid_sm = str(cfg.get("grid_sm", "flow")).lower()
        if grid_sm not in ("flow", "cv"):
            raise NotImplementedError(
                f"grid_sm {grid_sm!r} (a grid of sub-trackers) is not "
                "ported yet: it comes with ROADMAP Queue 1c")
        gp = _grid_params(cfg, GRID_KEYS[sm_key])
        if grid_sm == "cv":
            gp = replace(gp, pyramid_levels=int(
                cfg.get("grid_pyramid_levels", 3)))
        return GridTracker(make_am(), make_ssm(), prm, gp)
    if sm_key in RKLT_KEYS:
        # grid + ESM-LM template refiner (ReadMe.md:432 SOTA config)
        grid = GridTracker(make_am("ssd", replace(am_prm, resx=8, resy=8)),
                           make_ssm(), prm, _grid_params(cfg))
        templ = SM_LK_REGISTRY["esm"](
            make_am(), make_ssm(),
            replace(prm, enable_lm=True, hess_type="selft"))
        return RKLT(grid, templ, RKLTParams(
            failure_thresh_px=float(cfg.get("rklt_failure_thresh", 15.0)),
            enable_feedback=bool(cfg.get("rklt_feedback", True)),
            enable_spi=bool(cfg.get("enable_spi", False))))
    if sm_key in LM_KEYS:
        prm = replace(prm, enable_lm=True)
    return SM_LK_REGISTRY[sm_key](make_am(), make_ssm(), prm)
