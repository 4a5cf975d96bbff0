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

    create_tracker("eslm", "ncc", "8", resx=16, resy=16, max_iters=10)
    create_tracker("fclk", "ssd", "spline", resx=32, resy=32, ...)

    create_tracker("pffc", "ssim", "8", resx=25, resy=25,
                   pf_n_particles=500, enable_lm=True, max_iters=10,
                   interp="linear_mm", crop=256, pf_score_stride=4,
                   pf_score_blur=True, pf_rescore_top_k=64,
                   pf_pix_sigma=2.0, pf_score_downsample=True,
                   pf_rescore_crop=160, coarse_pt_iters=((4, 3), (2, 3)))
    create_tracker("nnic", "mi", "8", resx=25, resy=25, nn_n_samples=1000,
                   enable_lm=True, max_iters=10, interp="linear_mm",
                   crop=224, n_bins=32, coarse_pt_iters=((2, 5),),
                   nn_dist_feat="raw")
    create_tracker("hesm", "ssd", "8", ...)       # ESM on "2", then "8"
    create_tracker("lpfc", "ssd", "8", ...)       # LP on "2", then FCLK
    create_tracker("fclk", "ssd", "8", ilm="pgb", ...)
    create_tracker("fclk", "sum", "8", sum_am1="zncc", sum_am2="scv", ...)

Every SSM key of the JAX package (2-8 DOF: translation to homography,
the Lie SSMs, SL3 and CBH; and the 50-DOF spline and 32-DOF TPS) and
every LK key of its `SM_LK_REGISTRY`, with `haclk`, are ported; each LK
update takes the chain kernel (at S = the SSM's DOF) where the JAX
package's `_fused_ok` takes its Pallas kernel, else the generic path
(`sm/lk.py`). ICLK defaults to the self0 Hessian, as the JAX factory
sets it. `grid_sm` other than "flow" / "cv" builds a `SubTrackerGrid` of
`grid_sm` sub-trackers on `grid_am` (default "ssd") and `grid_ssm`
(default "2") at `grid_patch_res` (default 8), which take the
configuration's other options (with a crop, each reads a window; with
none, the whole frame, shared by all of them). The LK keys take
`interp` "linear_mm", "cubic_mm" (Catmull-Rom), "cubic_bspl_mm" (cubic
B-spline) or the gather kinds "nearest", "linear", "cubic" and
"cubic_bspl"; the grid keys the dense and gather kinds but "nearest";
frames are (H, W) or (H, W, C). The AM keys "mc<am>" and "<am>3" take
(H, W, 3) frames. The composites (`casc`, `prl`, `pyr` and their
aliases, the shorthands `grfc`, `gres` and `gric`) build their members
with this function, from the same options; `casc` and `prl` take them
from `members` or from the blocks of a multi.cfg (`multi_cfg=<path or
text>`, `create_trackers_from_multi`). The tracker lives on the card
unless `device` says otherwise (`device="cpu"` for a CPU run); without a
card and without `device` it raises. Every SM key of the JAX factory is
ported; another key raises `InvalidArgument`, as in the JAX package,
and so do an unknown AM, ILM or SSM key and a `casc` or `prl` without
members (the JAX package raises a bare `KeyError` for the ILM). Every
option the JAX factory reads is read as it reads it (`border` "constant"
for the gather kinds, `crop_blocks`, `interp_bf16`, `interp_precision`
among them); an option that neither package reads is ignored
(`_check_options`).

The AMs are every key of the JAX package's registry (SSD, NSSD, ZNCC,
SAD, NCC, SSIM, SPSS, MI, CCRE, KLD, LKLD, SCV, RSCV, LSCV, LRSCV, RIU,
NGF, PCA, DFM; each also as `mc<am>` / `<am>3`) and `sum` (`sum_am1`,
`sum_am2`), with their extras in `am_extra`; `ilm` is "gb", "pgb" or
"rbf". `hrch` / `hesm` cascade `hrch_sm` (default ESM) on `hrch_ssm`
(default "2") and on the tracker's SSM; `lp` is the linear predictor and
`lpfc lpic lpes` its cascades with an LK refiner (the LP stage on "2"
when the SSM has more than 4 DOF, unless `lp_ssm` says otherwise);
`regnet` is RegNet (`rg_*`), `gtrn` / `goturn` RegNet on "4" with
GOTURN's defaults; `line` the line tracker (`line_conf_thresh`).

The particle filter (`pf`, `pf100` to `pf5k`), the
nearest-neighbour search (`nn`, `nn1k` to `nn100k`, `gnn`, `fgnn`, and
`nnkdt`, `kdt`, `nnkmn`, `kmn`: the exact search), their cascades with an
LK refiner (`pfic pffc pfes nnic nnfc nnes`) or RKLT (`pfrk nnrk`), the
multi-layer `pfk*` / `nnk*` cascades and `pfsl3` (a PF on SL3 refined by
FCLK) are built as the JAX factory builds them (`mtf_tpu/factory.py`).

The box trackers: `mosse kcf dsst` (`CFParams` fields; KCF and DSST on
fHOG by default), `rct mil boost bsr strk struck frg frag` (their
parameter classes' fields), `dft` (`dft_sm`, default ESM, on the
descriptor fields; `dft_sigma`) and `tld` (`tld_*`: `TLDParams` fields;
its Median Flow leg takes the grid and SM options, as the JAX factory
builds it).

The OpenCV trackers: `feat` (the feature tracker, `feat_*` options as the
JAX factory reads them) and `cmt` (`cmt_*`: `CMTParams` fields) detect
on the host with cv2 and match, fit and vote on the device; the other
third-party keys that no port of the package takes (`csrt`, `visp`,
`cv3`, and keys given to `third_party.register_third_party`) build the
cv2 tracking-API adapter on the host where the machine's cv2 has the
tracker, and raise `NotImplementedError` with the list of the ones it
has where it does not, as the JAX package's `get_third_party` does.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any

from mtf_tpu_torch import third_party
from mtf_tpu_torch.am import AMParams, get_am
from mtf_tpu_torch.sm.cf import CF_REGISTRY, CFParams, get_cf_tracker
from mtf_tpu_torch.sm.cmt import CMT, CMTParams
from mtf_tpu_torch.sm.composite import (RKLT, CascadeSM, ParallelSM,
                                        PyramidalSM, RKLTParams)
from mtf_tpu_torch.sm.core import SMParams
from mtf_tpu_torch.sm.feature import FeatureParams, FeatureTracker
from mtf_tpu_torch.sm.grid import GridParams, GridTracker, SubTrackerGrid
from mtf_tpu_torch.sm.line import LineParams, LineTracker
from mtf_tpu_torch.sm.learn import (DFT, LEARN_PARAMS, LEARN_REGISTRY,
                                    get_learn_tracker)
from mtf_tpu_torch.sm.lk import LM_KEYS, SM_LK_REGISTRY
from mtf_tpu_torch.sm.lp import LP, LPParams
from mtf_tpu_torch.sm.nn import NN, NNParams
from mtf_tpu_torch.sm.pf import PF, PFParams
from mtf_tpu_torch.sm.regnet import RegNet, RegNetParams
from mtf_tpu_torch.sm.tld import TLD, TLDParams
from mtf_tpu_torch.ssm import get_ssm
from mtf_tpu_torch.utils.config import read_multi_cfg
from mtf_tpu_torch.utils.excp import InvalidArgument

_KNOWN_CFG = {"resx", "resy", "mtf_res", "max_iters", "epsilon", "interp",
              "border", "crop", "crop_blocks", "interp_bf16",
              "interp_precision", "coarse_pt_iters", "hess_type", "jac_type",
              "enable_lm", "use_pallas", "spi_type", "spi_thresh",
              "sd_learning_rate", "learning_rate",
              # grid and RKLT (`_grid_params`)
              "grid_res", "grid_patch_res", "grid_sub_iters",
              "grid_coarse_stride", "grid_estimator", "grid_n_hyps",
              "grid_inlier_thresh", "grid_fb_err", "grid_patch_scale",
              "grid_zncc", "grid_pyramid_levels", "grid_flow", "grid_sm",
              "grid_am", "grid_ssm",
              "seed", "rklt_failure_thresh", "rklt_feedback", "enable_spi",
              # composites
              "members", "casc_reinit_thresh", "pyr_sm", "pyr_n_levels",
              "multi_cfg",
              # the AMs' likelihood and histograms
              "likelihood_alpha", "n_bins",
              # PF and NN (`_pf_params`, `_nn_params`), their sigma
              # presets, the multi-layer cascades and pfsl3
              "pf_ssm_sigmas", "pf_ssm_sigma_ids", "pf_adapt_distr",
              "pf_n_particles", "pf_dynamic_model", "pf_update_type",
              "pf_likelihood", "pf_resampling", "pf_mean_type",
              "pf_pix_sigma", "pf_ssm_sigma", "pf_measurement_sigma",
              "pf_jacobian_as_sigma", "pf_am_sigma", "pf_score_stride",
              "pf_score_blur", "pf_score_downsample", "pf_rescore_top_k",
              "pf_rescore_crop", "nn_n_samples", "nn_max_iters",
              "nn_pix_sigma", "nn_ssm_sigma", "nn_ssm_sigma_ids",
              "nn_dist_feat", "nn_add_samples_gap", "nn_n_samples_to_add",
              "nn_use_gnn", "gnn_k", "gnn_max_steps", "_presets",
              "pfk_n_layers", "nnk_n_layers", "pfk_ssm_sigma_ids",
              "nnk_ssm_sigma_ids", "pfsl3_p_x", "pfsl3_p_y", "pfsl3_n",
              "pfsl3_n_c", "pfsl3_ncc_std", "pfsl3_state_std",
              "pfsl3_n_iter", "pfsl3_am",
              # the AMs' extras and the sum of AMs (`_am_params`)
              "am_extra", "sum_am1", "sum_am2",
              # the hierarchical SMs, LP, RegNet and the line tracker
              "hrch_sm", "hrch_ssm", "lp_n_samples", "lp_max_iters",
              "lp_pix_sigma", "lp_ssm_sigma", "lp_ridge", "lp_n_stages",
              "lp_epsilon", "lp_ssm", "rg_n_samples", "rg_hidden",
              "rg_train_steps", "rg_max_iters", "rg_pix_sigma",
              "rg_ssm_sigma", "line_conf_thresh",
              # DFT: the registration SM on the descriptor fields
              "dft_sm", "dft_sigma",
              # the feature tracker (the fields the JAX factory reads)
              "feat_detector", "feat_max_keypoints", "feat_ratio_thresh",
              "feat_search_margin", "feat_min_matches", "feat_estimator",
              "feat_inlier_thresh", "feat_n_hypotheses",
              # CMT
              *("cmt_" + f for f in CMTParams.__dataclass_fields__)}
# the CF and learn trackers take their parameter classes' fields, and TLD
# its `tld_`-prefixed ones (as the JAX factory reads them)
_BOX_CFG = {**{k: set(CFParams.__dataclass_fields__) for k in CF_REGISTRY},
            **{k: set(LEARN_PARAMS[c].__dataclass_fields__)
               for k, c in LEARN_REGISTRY.items()},
            "tld": {"tld_" + f for f in TLDParams.__dataclass_fields__}}

GRID_KEYS = {"grid": None, "lms": "lmeds", "ransac": "ransac",
             "rnsc": "ransac"}
RKLT_KEYS = {"rklt", "rkl", "lmes"}
MF_KEYS = {"mf", "mflow", "medianflow"}
CASC_KEYS = {"casc", "casm", "cascade"}
PRL_KEYS = {"prl", "prlt", "prls", "prsm", "parallel"}
PYR_KEYS = {"pyr", "pyrt", "pysm", "pyrs"}
# the cascade shorthands: <first><second> (mtf.h:344-478)
CASCADE_SHORTHAND = {"grfc": ("grid", "fclk"), "gres": ("grid", "esm"),
                     "gric": ("grid", "iclk"),
                     "pfic": ("pf", "iclk"), "pffc": ("pf", "fclk"),
                     "pfes": ("pf", "esm"), "nnic": ("nn", "iclk"),
                     "nnfc": ("nn", "fclk"), "nnes": ("nn", "esm"),
                     "pfrk": ("pf", "rklt"), "nnrk": ("nn", "rklt")}
PF_SIZES = {"pf": None, "pf100": 100, "pf250": 250, "pf500": 500,
            "pf1k": 1000, "pf2k": 2000, "pf5k": 5000}
NN_SIZES = {"nn": None, "nn1k": 1000, "nn2k": 2000, "nn5k": 5000,
            "nn10k": 10000, "nn100k": 100000}
# the exact search stands in for FLANN's KD-tree and k-means indices;
# gnn / fgnn descend a kNN graph
NN_KEYS = set(NN_SIZES) | {"gnn", "fgnn", "nnkdt", "kdt", "nnkmn", "kmn"}
STOCH_CASC_KEYS = {"pfk", "pfkic", "pfkfc", "pfkes",
                   "nnk", "nnkic", "nnkfc", "nnkes"}
HRCH_KEYS = {"hrch", "hesm"}
# the LP stage alone, or followed by an LK refiner
LP_KEYS = {"lp": None, "lpfc": "fclk", "lpic": "iclk", "lpes": "esm"}
GTRN_KEYS = {"gtrn", "goturn"}
_PORTED_SM = (set(SM_LK_REGISTRY) | {"haclk"} | set(GRID_KEYS) | RKLT_KEYS
              | MF_KEYS | CASC_KEYS | PRL_KEYS | PYR_KEYS
              | set(CASCADE_SHORTHAND) | set(PF_SIZES) | NN_KEYS
              | STOCH_CASC_KEYS | {"pfsl3"} | HRCH_KEYS | set(LP_KEYS)
              | GTRN_KEYS | {"regnet", "line", "dft", "feat", "cmt"}
              | set(_BOX_CFG))
# the third-party keys with a port of their own, which the registry of
# `third_party.py` never builds (the JAX factory's `_native_third_party`,
# with the CF and learn keys it takes before the registry)
_NATIVE_THIRD_PARTY = ({"mf", "rct", "strk", "dft", "frg", "pfsl3", "tld",
                        "cmt", "gtrn", "goturn"} | set(CF_REGISTRY)
                       | set(LEARN_REGISTRY))


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


def _resolve_sigma_presets(cfg: dict, ids) -> list:
    """Preset ids -> sigma vectors from `cfg["_presets"]["ssm_sigma"]`
    (the sigma.cfg registry, mtf.h:268-309; `mtf_tpu/utils/config.py`)."""
    presets = cfg.get("_presets", {}).get("ssm_sigma", {})
    if isinstance(ids, (int, float)):
        ids = [int(ids)]
    out = []
    for i in ids:
        if int(i) not in presets:
            raise KeyError(f"ssm_sigma preset {i} not in sigma.cfg")
        v = presets[int(i)]
        out.append(v if isinstance(v, list) else [v])
    return out


def _sigma_from_ids(cfg: dict, ids_key: str) -> tuple:
    """The sigma vector of an id-indexed preset selection (the first id
    wins, as the reference's primary sampler)."""
    ids = cfg.get(ids_key)
    if ids is None or "_presets" not in cfg:
        return ()
    vecs = _resolve_sigma_presets(cfg, ids)
    return tuple(vecs[0]) if vecs else ()


def _pf_params(cfg: dict, n_particles: int | None = None) -> PFParams:
    # several presets selected: the multi-distribution sampler
    sigmas = tuple(tuple(v) for v in cfg.get("pf_ssm_sigmas", ()))
    ids = cfg.get("pf_ssm_sigma_ids")
    if not sigmas and ids is not None and "_presets" in cfg:
        vecs = _resolve_sigma_presets(cfg, ids)
        if len(vecs) > 1:
            sigmas = tuple(tuple(v) for v in vecs)
    return PFParams(
        ssm_sigmas=sigmas,
        adapt_distr=bool(cfg.get("pf_adapt_distr", True)),
        n_particles=int(n_particles or cfg.get("pf_n_particles", 200)),
        dynamic_model=str(cfg.get("pf_dynamic_model", "rw")),
        update_type=str(cfg.get("pf_update_type", "compositional")),
        likelihood=str(cfg.get("pf_likelihood", "gaussian")),
        resampling=str(cfg.get("pf_resampling", "systematic")),
        mean_type=str(cfg.get("pf_mean_type", "weighted")),
        pix_sigma=float(cfg.get("pf_pix_sigma", 3.0)),
        ssm_sigma=tuple(cfg.get("pf_ssm_sigma", ())) or
        _sigma_from_ids(cfg, "pf_ssm_sigma_ids"),
        measurement_sigma=float(cfg.get("pf_measurement_sigma", 0.1)),
        jacobian_as_sigma=bool(cfg.get("pf_jacobian_as_sigma", False)),
        am_sigma=tuple(cfg.get("pf_am_sigma", ())),
        score_stride=int(cfg.get("pf_score_stride", 1)),
        score_blur=bool(cfg.get("pf_score_blur", False)),
        score_downsample=bool(cfg.get("pf_score_downsample", False)),
        rescore_top_k=int(cfg.get("pf_rescore_top_k", 0)),
        rescore_crop=int(cfg.get("pf_rescore_crop", 0)),
        seed=int(cfg.get("seed", 0)),
    )


def _nn_params(cfg: dict, n_samples: int | None = None) -> NNParams:
    return NNParams(
        n_samples=int(n_samples or cfg.get("nn_n_samples", 1000)),
        max_iters=int(cfg.get("nn_max_iters", 3)),
        pix_sigma=float(cfg.get("nn_pix_sigma", 4.0)),
        ssm_sigma=tuple(cfg.get("nn_ssm_sigma", ())) or
        _sigma_from_ids(cfg, "nn_ssm_sigma_ids"),
        dist_feat=str(cfg.get("nn_dist_feat", "am")),
        add_samples_gap=int(cfg.get("nn_add_samples_gap", 0)),
        n_samples_to_add=int(cfg.get("nn_n_samples_to_add", 8)),
        seed=int(cfg.get("seed", 0)),
    )


def _pfsl3_cfg(cfg: dict) -> dict:
    """PFSL3 (the reference's bundled ThirdParty/PFSL3, defaults
    PFSL3.cc:14-33 and thirdparty.cfg:59-68) as the JAX package builds it:
    a PF on SL3 (N x N_c particles, AR(1), a Gaussian NCC likelihood)
    whose mean is refined by FCLK on the same group (`pffc`)."""
    ncfg = dict(cfg)
    ncfg.setdefault("resx", int(cfg.get("pfsl3_p_x", 40)))
    ncfg.setdefault("resy", int(cfg.get("pfsl3_p_y", 40)))
    ncfg.setdefault("pf_n_particles", int(cfg.get("pfsl3_n", 50))
                    * int(cfg.get("pfsl3_n_c", 10)))
    ncfg.setdefault("pf_dynamic_model", "ar1")
    ncfg.setdefault("pf_likelihood", "gaussian")
    ncfg.setdefault("pf_measurement_sigma",
                    float(cfg.get("pfsl3_ncc_std", 0.05)))
    if "pfsl3_state_std" in cfg:
        ncfg.setdefault("pf_ssm_sigma", tuple(cfg["pfsl3_state_std"]))
    else:
        ncfg.setdefault("pf_pix_sigma", 3.5)
    ncfg.setdefault("max_iters", int(cfg.get("pfsl3_n_iter", 5)) * 2)
    return ncfg


def _casc_thresh(cfg: dict):
    """Cascade auto-reinit divergence threshold (px); None disables."""
    v = cfg.get("casc_reinit_thresh")
    return float(v) if v is not None else None


def _members(sm_key: str, cfg: dict, ilm, device) -> list:
    """A composite's member trackers: from `members` [(sm, am, ssm), ...]
    or, without it, one per block of the multi.cfg `multi_cfg` (a path or
    the text; `create_trackers_from_multi`, each block on the
    composite's other options)."""
    members = cfg.get("members")
    if not members and "multi_cfg" in cfg:
        base = {k: v for k, v in cfg.items() if k != "multi_cfg"}
        return create_trackers_from_multi(cfg["multi_cfg"], device=device,
                                          **base)
    if not members:
        raise InvalidArgument(f"{sm_key} requires members=[(sm, am, ssm), "
                              "...] or multi_cfg=<path>")
    # a composite's members take its options, but not its own member list
    sub_cfg = {k: v for k, v in cfg.items()
               if k not in ("members", "pyr_sm", "multi_cfg")}
    return [create_tracker(m_sm, m_am, m_ssm, ilm, device=device, **sub_cfg)
            for (m_sm, m_am, m_ssm) in members]


def create_trackers_from_multi(path_or_text: str, device=None, **base_cfg):
    """One tracker per multi.cfg block (readTrackerParams analog): each
    block's `sm`, `am`, `ssm` and `ilm` (defaults fclk, ssd, 8, none) on
    `base_cfg` updated by the block's other keys."""
    trackers = []
    for block in read_multi_cfg(path_or_text):
        merged = {**base_cfg, **block}
        sm = str(merged.pop("sm", "fclk"))
        am = str(merged.pop("am", "ssd"))
        ssm = str(merged.pop("ssm", "8"))
        ilm = merged.pop("ilm", None)
        ilm = None if ilm in (None, 0, "0", "none") else str(ilm)
        merged.pop("members", None)
        trackers.append(create_tracker(sm, am, ssm, ilm, device=device,
                                       **merged))
    return trackers


def _check_options(sm_key: str, cfg: dict) -> None:
    """The options rule: an option of another tracker's vocabulary (a box
    tracker's fields on any other tracker) raises; an option that neither
    package reads (a run's `syn_sigma`, `pre_proc_type`, the rest of a
    reference .cfg directory) is ignored, as the JAX factory ignores
    it."""
    own = _KNOWN_CFG | _BOX_CFG.get(sm_key, set())
    misplaced = sorted(k for k in cfg if k not in own and any(
        k in fields for fields in _BOX_CFG.values()))
    if misplaced:
        raise NotImplementedError(
            f"options {misplaced} belong to other trackers than {sm_key!r} "
            "(their parameter classes)")


def create_tracker(sm: str = "fclk", am: str = "ssd", ssm: str = "8",
                   ilm: str | None = None, device=None, **cfg: Any):
    """Reference `mtf::getTracker(sm, am, ssm, ilm)` analog for the
    ported slices; the tracker's tensors live on `device` (None: the
    card)."""
    sm_key = sm.lower()
    # the remaining third-party keys route as in the reference factory
    # (mtf.h:935 -> 1978): cv2 adapters or registered trackers on the host
    if (third_party.is_third_party(sm_key)
            and sm_key not in _NATIVE_THIRD_PARTY):
        return third_party.get_third_party(sm_key)
    if sm_key not in _PORTED_SM:
        raise InvalidArgument(f"unknown SM key {sm!r}")
    _check_options(sm_key, cfg)

    # the correlation-filter and learn trackers: axis-aligned box trackers
    # with no AM or SSM, built from their own parameter classes
    if sm_key in CF_REGISTRY:
        return get_cf_tracker(sm_key, device=device, **cfg)
    if sm_key in LEARN_REGISTRY:
        return get_learn_tracker(sm_key, device=device, **cfg)
    if sm_key == "cmt":
        # keypoints tracked by pyramidal LK and re-matched by descriptor
        # distances, scale and rotation by pairwise median votes, the
        # center by the vote cluster (sm/cmt.py)
        fields = set(CMTParams.__dataclass_fields__)
        return CMT(CMTParams(**{k[4:]: v for k, v in cfg.items()
                                if k.startswith("cmt_") and k[4:] in fields}),
                   device=device)

    # a composite's members take its options, but not its own member
    # list or pyramid SM (a member of the same kind would recurse)
    sub_cfg = {k: v for k, v in cfg.items() if k not in ("members",
                                                         "pyr_sm")}

    def sub(key, m_am=am, m_ssm=ssm):
        return create_tracker(key, m_am, m_ssm, ilm, device=device,
                              **sub_cfg)

    if sm_key in GTRN_KEYS:
        # GOTURN's weight-free analog in the JAX package: RegNet on the
        # 4-DOF similitude with GOTURN's wide motion range
        ncfg = dict(cfg)
        ncfg.setdefault("rg_n_samples", 3000)
        ncfg.setdefault("rg_pix_sigma", 8.0)
        ncfg.setdefault("rg_hidden", (256, 128))
        ncfg.setdefault("rg_max_iters", 4)
        return create_tracker("regnet", am or "ssd", "4", ilm, device=device,
                              **ncfg)
    if sm_key in HRCH_KEYS:
        # the low-DOF stage seeds the full-DOF one (HESM.h:61-99): a
        # cascade of one SM over two SSMs
        base = str(cfg.get("hrch_sm", "esm"))
        return CascadeSM([sub(base, am, str(cfg.get("hrch_ssm", "2"))),
                          sub(base)], _casc_thresh(cfg))
    if sm_key == "pfsl3":
        return create_tracker("pffc", str(cfg.get("pfsl3_am", "ncc")),
                              "sl3", ilm, device=device, **_pfsl3_cfg(cfg))
    if sm_key in CASCADE_SHORTHAND:
        first, second = CASCADE_SHORTHAND[sm_key]
        return CascadeSM([sub(first), sub(second)], _casc_thresh(cfg))
    if sm_key in STOCH_CASC_KEYS:
        # k stochastic layers (getPFk mtf.h:268-288, getNNk :290-309),
        # each with its sigma presets or half the previous layer's pixel
        # sigma, then optionally an LK refiner
        stoch = "pf" if sm_key.startswith("pf") else "nn"
        n_layers = int(cfg.get(f"{stoch}k_n_layers",
                               3 if stoch == "pf" else 5))
        layer_ids = cfg.get(f"{stoch}k_ssm_sigma_ids")
        members = []
        for layer in range(n_layers):
            layer_cfg = dict(sub_cfg)
            if layer_ids:
                layer_cfg[f"{stoch}_ssm_sigma_ids"] = (
                    list(layer_ids)[-n_layers:][layer])
            else:
                px_key = f"{stoch}_pix_sigma"
                base_px = float(cfg.get(px_key,
                                        3.0 if stoch == "pf" else 4.0))
                layer_cfg[px_key] = base_px * (0.5 ** layer)
            members.append(create_tracker(stoch, am, ssm, ilm,
                                          device=device, **layer_cfg))
        refiner = {"ic": "iclk", "fc": "fclk", "es": "esm"}.get(sm_key[3:])
        if refiner:
            members.append(sub(refiner))
        return CascadeSM(members, _casc_thresh(cfg))
    if sm_key in CASC_KEYS:
        return CascadeSM(_members(sm_key, cfg, ilm, device),
                         _casc_thresh(cfg))
    if sm_key in PRL_KEYS:
        return ParallelSM(_members(sm_key, cfg, ilm, device))
    if sm_key in PYR_KEYS:
        return PyramidalSM(sub(str(cfg.get("pyr_sm", "fclk"))),
                           int(cfg.get("pyr_n_levels", 3)))

    prm = SMParams(
        max_iters=int(cfg.get("max_iters", 30)),
        epsilon=float(cfg.get("epsilon", 0.01)),
        interp=str(cfg.get("interp", "linear")),
        border=str(cfg.get("border", "replicate")),
        crop=int(cfg["crop"]) if cfg.get("crop") else None,
        crop_blocks=(tuple(int(v) for v in cfg["crop_blocks"])
                     if cfg.get("crop_blocks") else None),
        interp_bf16=bool(cfg.get("interp_bf16", False)),
        interp_precision=cfg.get("interp_precision") or None,
        coarse_pt_iters=tuple(
            _stride_pair(v) for v in cfg.get("coarse_pt_iters", ())),
        # the factory's default, unlike SMParams's "self0"
        hess_type=str(cfg.get("hess_type", "selft")),
        jac_type=str(cfg.get("jac_type", "original")),
        enable_lm=bool(cfg.get("enable_lm", False)),
        use_pallas=(None if cfg.get("use_pallas") is None
                    else bool(cfg.get("use_pallas"))),
        spi_type=cfg.get("spi_type") or None,
        spi_thresh=float(cfg.get("spi_thresh", 0.2)),
        sd_learning_rate=float(cfg.get("sd_learning_rate", 0.1)),
    )
    am_prm = AMParams(resx=int(cfg.get("resx", cfg.get("mtf_res", 50))),
                      resy=int(cfg.get("resy", cfg.get("mtf_res", 50))),
                      likelihood_alpha=float(cfg.get("likelihood_alpha",
                                                     50.0)),
                      n_bins=int(cfg.get("n_bins", 8)),
                      learning_rate=float(cfg.get("learning_rate", 0.0)),
                      extra={**dict(cfg.get("am_extra", {})),
                             **{k: cfg[k] for k in ("sum_am1", "sum_am2")
                                if k in cfg}})

    def make_am(key=am, params=am_prm):
        return get_am(key, params, ilm=ilm)

    def make_ssm():
        return get_ssm(ssm, device=device)

    if sm_key == "feat":
        # the sparse feature tracker (FeatureTracker.cc; drives
        # trackMarkers)
        return FeatureTracker(make_ssm(), prm, FeatureParams(
            detector=str(cfg.get("feat_detector", "orb")),
            max_keypoints=int(cfg.get("feat_max_keypoints", 500)),
            ratio_thresh=float(cfg.get("feat_ratio_thresh", 0.75)),
            search_margin=float(cfg.get("feat_search_margin", 1.5)),
            min_matches=int(cfg.get("feat_min_matches", 8)),
            estimator=str(cfg.get("feat_estimator", "ransac")),
            inlier_thresh=float(cfg.get("feat_inlier_thresh", 0.05)),
            n_hypotheses=int(cfg.get("feat_n_hypotheses", 128))))
    if sm_key in LP_KEYS:
        refiner = LP_KEYS[sm_key]
        lp_prm = LPParams(
            n_samples=int(cfg.get("lp_n_samples", 512)),
            max_iters=int(cfg.get("lp_max_iters", 5)),
            pix_sigma=float(cfg.get("lp_pix_sigma", 4.0)),
            ssm_sigma=tuple(cfg.get("lp_ssm_sigma", ())),
            ridge=float(cfg.get("lp_ridge", 1e-3)),
            n_stages=int(cfg.get("lp_n_stages", 3)),
            epsilon=float(cfg.get("lp_epsilon", 0.01)),
            seed=int(cfg.get("seed", 0)))
        # a cascade's LP stage runs on the 2-DOF SSM when the tracker's
        # has more than 4 DOF (the JAX package's default: the projective
        # dims of an 8-DOF predictor are barely observable); the refiner
        # runs the tracker's SSM
        lp_ssm = str(cfg.get("lp_ssm", ssm if (
            not refiner or get_ssm(ssm, device="cpu").dof <= 4) else "2"))
        lp_sm = LP(make_am(), get_ssm(lp_ssm, device=device), prm, lp_prm)
        if refiner:
            return CascadeSM([lp_sm, sub(refiner)], _casc_thresh(cfg))
        return lp_sm
    if sm_key == "regnet":
        return RegNet(make_am(), make_ssm(), prm, RegNetParams(
            n_samples=int(cfg.get("rg_n_samples", 2000)),
            hidden=tuple(cfg.get("rg_hidden", (128, 64))),
            train_steps=int(cfg.get("rg_train_steps", 300)),
            max_iters=int(cfg.get("rg_max_iters", 5)),
            pix_sigma=float(cfg.get("rg_pix_sigma", 4.0)),
            ssm_sigma=tuple(cfg.get("rg_ssm_sigma", ())),
            seed=int(cfg.get("seed", 0))))
    if sm_key == "line":
        return LineTracker(make_am(), make_ssm(), prm, _grid_params(cfg),
                           LineParams(conf_thresh=float(
                               cfg.get("line_conf_thresh", 0.05))))
    if sm_key in PF_SIZES:
        return PF(make_am(), make_ssm(), prm,
                  _pf_params(cfg, PF_SIZES[sm_key]))
    if sm_key in NN_KEYS:
        nn_prm = _nn_params(cfg, NN_SIZES.get(sm_key))
        if sm_key in ("gnn", "fgnn") or bool(cfg.get("nn_use_gnn", False)):
            nn_prm = replace(nn_prm, use_gnn=True,
                             gnn_k=int(cfg.get("gnn_k", 10)),
                             gnn_max_steps=int(cfg.get("gnn_max_steps", 32)))
        return NN(make_am(), make_ssm(), prm, nn_prm)
    if sm_key == "dft":
        # a registration SM on the 4-channel descriptor fields of the frame
        inner = create_tracker(str(cfg.get("dft_sm", "esm")), "ssd", ssm,
                               ilm, device=device,
                               **{k: v for k, v in cfg.items()
                                  if k not in ("dft_sm", "dft_sigma")})
        return DFT(inner, sigma=float(cfg.get("dft_sigma", 1.5)))
    if sm_key == "tld":
        # a Median Flow leg on the similitude with SSD patches (the JAX
        # factory's: median fusion, f2f flow, fb 2 px, 20 iterations on 3
        # pyramid levels) and the detection cascade
        gp = replace(_grid_params(cfg, "median"), flow="f2f",
                     fb_err_px=float(cfg.get("grid_fb_err", 2.0)),
                     sub_iters=int(cfg.get("grid_sub_iters", 20)),
                     pyramid_levels=int(cfg.get("grid_pyramid_levels", 3)))
        mf_leg = GridTracker(get_am("ssd", am_prm),
                             get_ssm("4", device=device), prm, gp)
        return TLD(mf_leg, TLDParams(**{k[4:]: v for k, v in cfg.items()
                                        if k.startswith("tld_")}))
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
    if sm_key == "haclk":
        # FCLK whose Hessian is held at the template's (HACLK.cc): self0
        return SM_LK_REGISTRY["fclk"](make_am(), make_ssm(),
                                      replace(prm, hess_type="self0"))
    if sm_key in ("iclk", "ic", "iclm") and "hess_type" not in cfg:
        # the reference ships ic_hess_type 0 = InitialSelf (modules.cfg:98)
        prm = replace(prm, hess_type="self0")
    if sm_key in LM_KEYS:
        prm = replace(prm, enable_lm=True)
    return SM_LK_REGISTRY[sm_key](make_am(), make_ssm(), prm)
