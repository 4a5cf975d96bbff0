from mtf_tpu_torch.ssm.base import SSM  # noqa: F401
from mtf_tpu_torch.ssm.projective import SSM_REGISTRY


def get_ssm(key: str, device=None) -> SSM:
    """Construct an SSM from its reference factory key, on `device`
    (None: the card)."""
    k = key.lower()
    if k not in SSM_REGISTRY:
        raise NotImplementedError(
            f"SSM {key!r} is not ported yet: the remaining SSMs come with "
            "ROADMAP Queue 1, slice 4")
    return SSM_REGISTRY[k](device=device)
