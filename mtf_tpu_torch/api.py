"""pyMTF-compatible procedural API (port of `mtf_tpu/api.py`).

Re-exposes the reference Python binding surface
(`Examples/cpp/pyMTF.cc:24-44`: `create(img, corners, cfg) -> id`,
`getRegion(img, out, id)`, `setRegion(corners, id)`, `remove(id)`) over
the port's trackers. Corners use the reference's 2x4 layout (x-row,
y-row; ul ur lr ll).

    import mtf_tpu_torch.api as pymtf
    tid = pymtf.create(frame, corners_2x4, sm="fclk", am="ncc", ssm="8")
    corners = pymtf.getRegion(next_frame, tid)
    pymtf.setRegion(corners_2x4, tid)
    pymtf.remove(tid)

State lives in a module-level registry like the reference's global tracker
map; each tracked object is a batch of one (B = 1) on its tracker's device
(the card unless `device` says otherwise). For the functional API (states
in and out, many objects in one batch) use `mtf_tpu_torch.create_tracker`
directly.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_registry: dict[int, dict] = {}
_next_id = 1
_lock = threading.Lock()


def _to_corners42(corners) -> np.ndarray:
    c = np.asarray(corners, np.float32)
    if c.shape == (2, 4):
        c = c.T
    if c.shape != (4, 2):
        raise ValueError(f"corners must be (2,4) or (4,2), got {c.shape}")
    return c


def _region(corners, device) -> torch.Tensor:
    return torch.as_tensor(_to_corners42(corners)[None], device=device)


def create(img, corners, config_dir: str | None = None, *,
           sm: str = "fclk", am: str = "ssd", ssm: str = "8",
           ilm: str | None = None, device=None, **cfg) -> int:
    """Create + initialize a tracker; returns its id (pyMTF.cc:67)."""
    from mtf_tpu_torch import create_tracker
    from mtf_tpu_torch.utils.config import read_params
    from mtf_tpu_torch.utils.preproc import get_preproc

    global _next_id
    if config_dir:
        file_cfg = read_params(config_dir, [])
        sm = file_cfg.get("mtf_sm", sm)
        am = file_cfg.get("mtf_am", am)
        ssm = file_cfg.get("mtf_ssm", ssm)
        ilm_f = file_cfg.get("mtf_ilm", ilm or "0")
        ilm = None if ilm_f in ("0", "none", None) else ilm_f
        cfg = {**file_cfg, **cfg}
    # the keys that name the tracker are arguments, not options
    opts = {k: v for k, v in cfg.items() if k not in ("sm", "am", "ssm",
                                                     "ilm")}
    tracker = create_tracker(str(sm), str(am), str(ssm), ilm, device=device,
                             **opts)
    pre = get_preproc(str(cfg.get("pre_proc_type", "none")))
    dev = tracker.device
    frame = pre(torch.as_tensor(np.asarray(img, np.float32), device=dev))
    state = tracker.initialize(frame, _region(corners, dev))
    with _lock:
        tid = _next_id
        _next_id += 1
        _registry[tid] = {"tracker": tracker, "state": state, "pre": pre}
    return tid


def getRegion(img, tracker_id: int = 1) -> np.ndarray:
    """Track one frame; returns the (2, 4) corner matrix (pyMTF.cc:35)."""
    ent = _registry[tracker_id]
    trk = ent["tracker"]
    frame = ent["pre"](torch.as_tensor(np.asarray(img, np.float32),
                                       device=trk.device))
    ent["state"] = trk.update(ent["state"], frame)
    return trk.corners(ent["state"])[0].cpu().numpy()


def setRegion(corners, tracker_id: int = 1) -> None:
    """Move the tracked region without re-templating (pyMTF.cc:40)."""
    ent = _registry[tracker_id]
    trk = ent["tracker"]
    ent["state"] = trk.set_region(ent["state"], _region(corners, trk.device))


def remove(tracker_id: int = 1) -> None:
    with _lock:
        _registry.pop(tracker_id, None)


def getTrackerIds() -> list[int]:
    return sorted(_registry)
