"""Where the port's tensors live when the caller does not say."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the card: the port's entry points run on the first
    CUDA device unless the caller asks for another (`device="cpu"`), and
    raise where there is no card rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")
