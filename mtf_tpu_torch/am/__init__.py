from mtf_tpu_torch.am.base import AM, AMParams, AMState, IlluminationModel  # noqa: F401
from mtf_tpu_torch.am.ncc import NCC
from mtf_tpu_torch.am.ssd import SSD

AM_REGISTRY = {"ssd": SSD, "ncc": NCC}


def get_am(key: str, params: AMParams | None = None, ilm=None) -> AM:
    """Construct an AM from its reference factory key."""
    k = key.lower()
    if k not in AM_REGISTRY:
        raise NotImplementedError(
            f"AM {key!r} is not ported yet: the remaining AMs come with "
            "ROADMAP Queue 1, slice 4")
    if ilm is not None:
        raise NotImplementedError(
            "illumination models are not ported yet: they come with "
            "ROADMAP Queue 1, slice 4")
    return AM_REGISTRY[k](params or AMParams())
