"""Third-party tracker slots (port of `mtf_tpu/third_party.py`).

The reference bundles 15 external trackers (`ThirdParty/`; registry keys
`mtf.h:1978-2120`). As in the JAX package, this module keeps the slots:
the key registry, `register_third_party` for user-supplied trackers, and
`CVTrackerAdapter` over whatever OpenCV's tracking API offers on the
machine. These trackers are stateful host objects in both packages (the
reference wraps OpenCV), so they run on the host, one OpenCV object per
tracker; which keys exist depends on the machine's cv2 build, and a key
it lacks raises `NotImplementedError` with the list of the ones it has.

They are axis-aligned box learners; like the reference's adapters they
report the box as a 4-corner region: corners in (B, 4, 2) (or (4, 2) for
one tracker), out (B, 2, 4), as every tracker of the port. Their
`update_multi` raises: per-tracker frames need a device-only tracker (the
JAX fleet `vmap`s `update`, which a host object cannot be).
"""
from __future__ import annotations

import numpy as np
import torch

from mtf_tpu_torch.sm.core import multi_unported


class ThirdPartyState:
    """Mutable host state: one OpenCV tracker object per region."""

    def __init__(self, impls, corners):
        self.impls = list(impls)
        self.corners = np.asarray(corners, np.float32)  # (B, 4, 2)


def _to_u8_bgr(frame) -> np.ndarray:
    import cv2
    if isinstance(frame, torch.Tensor):
        frame = frame.detach().cpu().numpy()
    a = np.asarray(frame)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = cv2.cvtColor(a, cv2.COLOR_GRAY2BGR)
    return a


def _bbox_of(corners) -> tuple:
    c = np.asarray(corners)
    x0, y0 = c.min(axis=0)
    x1, y1 = c.max(axis=0)
    return (float(x0), float(y0), float(x1 - x0), float(y1 - y0))


def _batched(corners) -> np.ndarray:
    if isinstance(corners, torch.Tensor):
        corners = corners.detach().cpu().numpy()
    c = np.asarray(corners, np.float32)
    return c[None] if c.ndim == 2 else c


class CVTrackerAdapter:
    """Adapter for OpenCV tracking-API trackers (the tracker contract)."""

    def __init__(self, make_impl, name: str):
        self._make = make_impl
        self.name = name
        self.ssm = None  # no SSM: a box tracker

    def initialize(self, frame, corners) -> ThirdPartyState:
        img = _to_u8_bgr(frame)
        c = _batched(corners)
        impls = []
        for box in c:
            impl = self._make()
            impl.init(img, tuple(int(round(v)) for v in _bbox_of(box)))
            impls.append(impl)
        return ThirdPartyState(impls, c)

    def update(self, state: ThirdPartyState, frame) -> ThirdPartyState:
        img = _to_u8_bgr(frame)
        for b, impl in enumerate(state.impls):
            ok, bbox = impl.update(img)
            if ok:
                x, y, w, h = bbox
                state.corners[b] = np.asarray(
                    [[x, y], [x + w, y], [x + w, y + h], [x, y + h]],
                    np.float32)
        return state

    def update_multi(self, state: ThirdPartyState, frames):
        raise multi_unported(self)

    def corners(self, state: ThirdPartyState) -> torch.Tensor:
        """(B, 2, 4) corners on the host."""
        return torch.as_tensor(state.corners).transpose(-1, -2)

    def set_region(self, state: ThirdPartyState, corners,
                   frame=None) -> ThirdPartyState:
        state.corners = _batched(corners).copy()
        return state

    def reinitialize(self, frame, corners) -> ThirdPartyState:
        return self.initialize(frame, corners)


def _cv_available() -> dict:
    import cv2
    avail = {}
    if hasattr(cv2, "TrackerMIL_create"):
        avail["mil"] = lambda: cv2.TrackerMIL_create()
    if hasattr(cv2, "TrackerKCF_create"):
        avail["kcf"] = lambda: cv2.TrackerKCF_create()
    if hasattr(cv2, "TrackerCSRT_create"):
        avail["csrt"] = lambda: cv2.TrackerCSRT_create()
    if hasattr(cv2, "legacy"):
        leg = cv2.legacy
        for key, ctor in (("boost", "TrackerBoosting_create"),
                          ("tld", "TrackerTLD_create"),
                          ("mf", "TrackerMedianFlow_create")):
            if hasattr(leg, ctor):
                avail[key] = getattr(leg, ctor)
    return avail


def available() -> list:
    """The OpenCV tracker keys this machine's cv2 offers."""
    return sorted(_cv_available())


# the reference's third-party keys (mtf.h:1978-2120), resolved lazily; the
# factory takes the keys with a port of their own (dsst, kcf, mil, tld,
# ...) before this registry, which it reaches for csrt, visp, cv3 and the
# registered keys
THIRD_PARTY_KEYS = ("dsst kcf cmt tld rct mil strk frg boost dft "
                    "pfsl3 visp cv3 gtrn csrt mf").split()

_registry: dict = {}


def register_third_party(key: str, constructor) -> None:
    """Register a user-supplied tracker factory under a key (the
    extension mechanism of mtf.h:1978-2120)."""
    _registry[key.lower()] = constructor


def get_third_party(key: str):
    """Build a third-party tracker; a known key this machine lacks raises
    with the list of the ones it has."""
    k = key.lower()
    if k in _registry:
        return _registry[k]()
    avail = _cv_available()
    if k in avail:
        return CVTrackerAdapter(avail[k], k)
    if k in THIRD_PARTY_KEYS:
        raise NotImplementedError(
            f"third-party tracker {key!r} is a bundled-code slot; "
            f"available in this environment: {sorted(avail) or 'none'} "
            f"(register your own via register_third_party)")
    raise ValueError(f"unknown third-party key {key!r}")


def is_third_party(key: str) -> bool:
    return key.lower() in THIRD_PARTY_KEYS or key.lower() in _registry
