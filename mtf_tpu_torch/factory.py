"""Tracker factory (port of `mtf_tpu/factory.py` for the ported slices).

    create_tracker("esm", "ncc", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=144,
                   coarse_pt_iters=((4, 6), (2, 3)))
    create_tracker("rklt", "ssd", "8", resx=50, resy=50, max_iters=10,
                   epsilon=0.0, interp="linear_mm", crop=160,
                   grid_sub_iters=(1, 8), grid_coarse_stride=2,
                   coarse_pt_iters=((4, 6), (2, 3)))
    create_tracker("fclk", "mcssd", "8", ..., interp="linear_mm")
    create_tracker("mf", "ssd", "8", resx=50, resy=50, interp="linear_mm",
                   crop=160)
    create_tracker("casc", "ssd", "8", members=[("grid", "ssd", "8"),
                                               ("fclk", "ssd", "8")], ...)
    create_tracker("pyr", "ssd", "8", pyr_sm="fclk", pyr_n_levels=3, ...)
    create_tracker("fclk", "ssd", "6", ...)       # any SSM key, e.g. affine
    create_tracker("grid", "ssd", "8", grid_sm="fclk", crop=32, ...)

Every SSM key of the JAX package's `SSM_REGISTRY` is ported (2-8 DOF:
translation to homography, the Lie SSMs, SL3 and CBH); the LK keys run
the chain kernel at S = the SSM's DOF. `grid_sm` other than "flow" /
"cv" builds a `SubTrackerGrid` of `grid_sm` sub-trackers on `grid_am`
(default "ssd") and `grid_ssm` (default "2") at `grid_patch_res`
(default 8), which take the configuration's other options, its `crop`
too (the port's LK needs one). The LK keys take `interp` "linear_mm",
"cubic_mm" (Catmull-Rom) or "cubic_bspl_mm" (cubic B-spline); the grid
keys take those and the
gather kinds "linear", "cubic" and "cubic_bspl", on (H, W) or (H, W, C)
frames. The AM keys "mcssd" and "ssd3" are SSD over (H, W, 3) frames
(FCLK and its LM variant fclm only, as in the JAX package's fused path).
The composites (`casc`, `prl`, `pyr` and their aliases, the shorthands
`grfc` and `gres`) build their members with this function, from the same
options. The tracker lives on the card unless `device` says otherwise
(`device="cpu"` for a CPU run); without a card and without `device` it
raises. Keys and options outside the ported slices raise
`NotImplementedError` naming the ROADMAP queue that brings them.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any

from mtf_tpu_torch.am import AMParams, get_am
from mtf_tpu_torch.sm.composite import (RKLT, CascadeSM, ParallelSM,
                                        PyramidalSM, RKLTParams)
from mtf_tpu_torch.sm.core import SMParams
from mtf_tpu_torch.sm.grid import GridParams, GridTracker, SubTrackerGrid
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
              "grid_am", "grid_ssm",
              "seed", "rklt_failure_thresh", "rklt_feedback", "enable_spi",
              # composites
              "members", "casc_reinit_thresh", "pyr_sm", "pyr_n_levels",
              "multi_cfg"}

GRID_KEYS = {"grid": None, "lms": "lmeds", "ransac": "ransac",
             "rnsc": "ransac"}
RKLT_KEYS = {"rklt", "rkl", "lmes"}
MF_KEYS = {"mf", "mflow", "medianflow"}
CASC_KEYS = {"casc", "casm", "cascade"}
PRL_KEYS = {"prl", "prlt", "prls", "prsm", "parallel"}
PYR_KEYS = {"pyr", "pyrt", "pysm", "pyrs"}
# the cascade shorthands whose members are all ported: <first><second>
CASCADE_SHORTHAND = {"grfc": ("grid", "fclk"), "gres": ("grid", "esm")}
_PORTED_SM = (set(SM_LK_REGISTRY) | set(GRID_KEYS) | RKLT_KEYS | MF_KEYS
              | CASC_KEYS | PRL_KEYS | PYR_KEYS | set(CASCADE_SHORTHAND))

# where each unported SM key is queued: "1b" is the rest of slice 2, "1c"
# the rest of slice 3
_SLICE_OF_SM = {
    "iclk": "1b", "ic": "1b", "iclm": "1b", "aesm": "1, slice 4",
    "hrch": "1c (unblocked: its low-DOF SSMs are ported)",
    "hesm": "1c (unblocked: its low-DOF SSMs are ported)",
    "tld": "1c (its detection cascade, sm/tld.py: Queue 1, slice 7)",
    "gric": "1c (ICLK: Queue 1b)", "pfrk": "1c (PF: Queue 1, slice 5)",
    "nnrk": "1c (NN: Queue 1, slice 5)", "pfic": "1c (PF: Queue 1, slice 5)",
    "pffc": "1c (PF: Queue 1, slice 5)", "pfes": "1c (PF: Queue 1, slice 5)",
    "nnic": "1c (NN: Queue 1, slice 5)", "nnfc": "1c (NN: Queue 1, slice 5)",
    "nnes": "1c (NN: Queue 1, slice 5)", "falk": "1, slice 4",
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


def _casc_thresh(cfg: dict):
    """Cascade auto-reinit divergence threshold (px); None disables."""
    v = cfg.get("casc_reinit_thresh")
    return float(v) if v is not None else None


def _members(sm_key: str, cfg: dict) -> list:
    members = cfg.get("members")
    if "multi_cfg" in cfg:
        raise NotImplementedError(
            "multi_cfg (members from a multi.cfg file) is not ported yet: "
            "it needs utils/config, which comes with ROADMAP Queue 1, "
            "slice 8")
    if not members:
        raise ValueError(f"{sm_key} requires members=[(sm, am, ssm), ...]")
    return list(members)


def create_tracker(sm: str = "fclk", am: str = "ssd", ssm: str = "8",
                   ilm: str | None = None, device=None, **cfg: Any):
    """Reference `mtf::getTracker(sm, am, ssm, ilm)` analog for the
    ported slices; the tracker's tensors live on `device` (None: the
    card)."""
    sm_key = sm.lower()
    if sm_key not in _PORTED_SM:
        where = _SLICE_OF_SM.get(sm_key, "1, slice 7")
        raise NotImplementedError(
            f"SM {sm!r} is not ported yet: it comes with ROADMAP Queue "
            f"{where}")
    unknown = sorted(set(cfg) - _KNOWN_CFG)
    if unknown:
        raise NotImplementedError(
            f"options {unknown} are not ported yet: the LK options beyond "
            "slices 1 and 2 come with ROADMAP Queue 1b")

    # a composite's members take its options, but not its own member
    # list or pyramid SM (a member of the same kind would recurse)
    sub_cfg = {k: v for k, v in cfg.items() if k not in ("members",
                                                         "pyr_sm")}

    def sub(key, m_am=am, m_ssm=ssm):
        return create_tracker(key, m_am, m_ssm, ilm, device=device,
                              **sub_cfg)

    if sm_key in CASCADE_SHORTHAND:
        first, second = CASCADE_SHORTHAND[sm_key]
        return CascadeSM([sub(first), sub(second)], _casc_thresh(cfg))
    if sm_key in CASC_KEYS:
        return CascadeSM([sub(*m) for m in _members(sm_key, cfg)],
                         _casc_thresh(cfg))
    if sm_key in PRL_KEYS:
        return ParallelSM([sub(*m) for m in _members(sm_key, cfg)])
    if sm_key in PYR_KEYS:
        return PyramidalSM(sub(str(cfg.get("pyr_sm", "fclk"))),
                           int(cfg.get("pyr_n_levels", 3)))

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

    if sm_key in MF_KEYS:
        # Median Flow (the reference's bundled TLD tracker core):
        # frame-to-frame pyramidal grid flow with forward-backward masking
        # fused by the pairwise-median similarity; 20 LK iterations per
        # level, as OpenTLD's pyrLK
        gp = replace(_grid_params(cfg, "median"), flow="f2f",
                     fb_err_px=float(cfg.get("grid_fb_err", 2.0)),
                     sub_iters=_sub_iters(cfg.get("grid_sub_iters", 20)),
                     pyramid_levels=int(cfg.get("grid_pyramid_levels", 3)))
        return GridTracker(make_am(), make_ssm(), prm, gp)
    if sm_key in GRID_KEYS:
        # grid_sm selects the per-patch tracker: "flow" / "cv" are the
        # batched flow grid ("cv" pyramidal over 3 levels by default),
        # any other SM key a grid of such sub-trackers
        grid_sm = str(cfg.get("grid_sm", "flow")).lower()
        gp = _grid_params(cfg, GRID_KEYS[sm_key])
        if grid_sm not in ("flow", "cv"):
            if not cfg.get("crop"):
                raise ValueError(
                    f"grid_sm {grid_sm!r}: the sub-trackers need a crop "
                    "window (the port's LK samples from one); pass crop=")
            patch_cfg = {k: v for k, v in cfg.items() if k != "grid_sm"}
            patch_cfg["resx"] = patch_cfg["resy"] = gp.patch_res
            sub_sm = create_tracker(grid_sm, str(cfg.get("grid_am", "ssd")),
                                    str(cfg.get("grid_ssm", "2")), ilm,
                                    device=device, **patch_cfg)
            return SubTrackerGrid(sub_sm, make_ssm(), prm, gp)
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
