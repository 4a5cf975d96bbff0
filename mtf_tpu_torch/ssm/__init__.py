from mtf_tpu_torch.ssm.base import SSM  # noqa: F401
from mtf_tpu_torch.ssm.projective import SSM_REGISTRY
from mtf_tpu_torch.ssm.spline import SPLINE_REGISTRY
from mtf_tpu_torch.utils.excp import InvalidArgument


def get_ssm(key: str, device=None, **kwargs):
    """Construct an SSM from its reference factory key, on `device`
    (None: the card). kwargs go to the constructor (the spline's control
    grid, overlap and interp_type, the TPS anchors)."""
    k = key.lower()
    reg = {**SSM_REGISTRY, **SPLINE_REGISTRY}
    if k not in reg:
        raise InvalidArgument(f"unknown SSM {key!r}; known: {sorted(reg)}")
    return reg[k](device=device, **kwargs)
