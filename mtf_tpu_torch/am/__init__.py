from dataclasses import replace

from mtf_tpu_torch.am.base import AM, AMParams, AMState, IlluminationModel  # noqa: F401
from mtf_tpu_torch.am.base import gn_hessian, jacobian, self_hessian  # noqa: F401
from mtf_tpu_torch.am.info import CCRE, KLD, LKLD, MI
from mtf_tpu_torch.am.ncc import NCC
from mtf_tpu_torch.am.ssd import SSD
from mtf_tpu_torch.am.ssim import SPSS, SSIM

AM_REGISTRY = {"ssd": SSD, "ncc": NCC, "ssim": SSIM, "spss": SPSS,
               "mi": MI, "ccre": CCRE, "kld": KLD, "lkld": LKLD}


def get_am(key: str, params: AMParams | None = None, ilm=None) -> AM:
    """Construct an AM from its reference factory key; `mc<key>` and
    `<key>3` select 3-channel input, as in the JAX package (the
    reference's MC* classes)."""
    k = key.lower()
    params = params or AMParams()
    base = (k[2:] if k.startswith("mc") else k[:-1] if k.endswith("3")
            else None)
    if base is not None and base in AM_REGISTRY:
        params = replace(params, n_channels=3)
        k = base
    if k not in AM_REGISTRY:
        raise NotImplementedError(
            f"AM {key!r} is not ported yet: SAD, NSSD, ZNCC, the SCV family, "
            "RIU, NGF, PCA, DFM and the sum of AMs come next (ROADMAP Queue "
            "1, slice 4, item 3)")
    if ilm is not None:
        raise NotImplementedError(
            "illumination models are not ported yet: they come with "
            "ROADMAP Queue 1, slice 4 (item 4)")
    return AM_REGISTRY[k](params)
