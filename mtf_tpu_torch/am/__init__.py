from dataclasses import replace

from mtf_tpu_torch.am.base import AM, AMParams, AMState, IlluminationModel  # noqa: F401
from mtf_tpu_torch.am.base import gn_hessian, jacobian, self_hessian  # noqa: F401
from mtf_tpu_torch.am.dfm import DFM
from mtf_tpu_torch.am.ilm import GB, ILM_REGISTRY, PGB, RBF  # noqa: F401
from mtf_tpu_torch.am.info import CCRE, KLD, LKLD, MI
from mtf_tpu_torch.am.misc import NGF, PCA, RIU, SumOfAMs
from mtf_tpu_torch.am.ncc import NCC
from mtf_tpu_torch.am.scv import LRSCV, LSCV, RSCV, SCV
from mtf_tpu_torch.am.ssd import NSSD, SAD, SSD, ZNCC
from mtf_tpu_torch.am.ssim import SPSS, SSIM
from mtf_tpu_torch.utils.excp import InvalidArgument

AM_REGISTRY = {
    "ssd": SSD, "nssd": NSSD, "zncc": ZNCC, "sad": SAD,
    "ncc": NCC, "ssim": SSIM, "spss": SPSS,
    "mi": MI, "ccre": CCRE, "kld": KLD, "lkld": LKLD,
    "scv": SCV, "rscv": RSCV, "lscv": LSCV, "lrscv": LRSCV,
    "riu": RIU, "ngf": NGF, "pca": PCA, "dfm": DFM,
}


def get_ilm(ilm, params: AMParams) -> IlluminationModel | None:
    """An illumination model from its key ("gb", "pgb", "rbf"; PGB and RBF
    on the (resx, resy) grid), or `ilm` itself if it is one (or None)."""
    if not isinstance(ilm, str):
        return ilm
    k = ilm.lower()
    if k not in ILM_REGISTRY:
        raise InvalidArgument(
            f"unknown ILM {ilm!r}; known: {sorted(ILM_REGISTRY)}")
    if k in ("pgb", "rbf"):
        return ILM_REGISTRY[k](params.resx, params.resy)
    return ILM_REGISTRY[k]()


def get_am(key: str, params: AMParams | None = None, ilm=None) -> AM:
    """Construct an AM from its reference factory key, as the JAX
    package's `get_am`: `mc<key>` and `<key>3` select 3-channel input;
    "sum" is the sum of the AMs named by `params.extra`'s `sum_am1` and
    `sum_am2` (default ssd and ncc), each with its own ILM; `ilm` is an
    illumination model or its key."""
    k = key.lower()
    params = params or AMParams()
    if k == "sum":
        am1 = get_am(str(params.extra.get("sum_am1", "ssd")), params, ilm)
        am2 = get_am(str(params.extra.get("sum_am2", "ncc")), params, ilm)
        return SumOfAMs(am1, am2)
    base = (k[2:] if k.startswith("mc") else k[:-1] if k.endswith("3")
            else None)
    if base is not None and base in AM_REGISTRY:
        params = replace(params, n_channels=3)
        k = base
    if k not in AM_REGISTRY:
        raise InvalidArgument(
            f"unknown AM {key!r}; known: {sorted(AM_REGISTRY)}")
    return AM_REGISTRY[k](params, get_ilm(ilm, params))
