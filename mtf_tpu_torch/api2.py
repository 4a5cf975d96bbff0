"""pyMTF2-compatible streaming API: own input pipeline + tracker registry
(port of `mtf_tpu/api2.py`).

Re-exposes the reference's second-generation binding surface
(`Examples/cpp/pyMTF2.cc:17-40`: `init/isInitialized/quit/getFrame/
createTracker(s)/getRegion/setRegion/removeTracker(s)`), whose guts are
the Boost-thread pipeline of `TrackerStrct_mt.h:25-300`.

Here the input thread is the native C++ decode pipeline
(`native/framepipe.cpp`, ctypes-bound in `utils.native_input`) with a
Python fallback (`reader()` says which one `init` took); frames are
decoded on the host, and each tracker (a batch of one, on the card unless
`device` says otherwise) is updated from the host loop (`step`).

    import mtf_tpu_torch.api2 as pymtf2
    pymtf2.init("frames_dir")
    frame = pymtf2.getFrame()
    tid = pymtf2.createTracker(corners_2x4, sm="esm", am="ncc", ssm="8")
    while pymtf2.step():                # decode next frame + update all
        corners = pymtf2.getRegion(tid)
    pymtf2.quit()
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_state = {"input": None, "iter": None, "frame": None, "frame_id": -1,
          "trackers": {}, "next_id": 1, "reader": None}
_lock = threading.Lock()


def init(source: str, buffer_size: int = 8, n_threads: int = 2,
         preproc: str | None = None, pp1: float = 5.0,
         pp2: float = 0.0, to_gray: bool = False) -> bool:
    """Open the input pipeline (pyMTF2 `init`). `preproc` selects the
    host-side filter chain (none/gauss/med/box/bil/sobel) run inside the
    native decode workers (getPreProc analog, pipeline.h:178-247)."""
    try:
        from mtf_tpu_torch.utils.native_input import (NativeInput,
                                                      native_available)
        if native_available():
            src = NativeInput(source, buffer_size, n_threads,
                              preproc=preproc, pp1=pp1, pp2=pp2,
                              to_gray=to_gray)
            reader = "native"
        else:
            raise RuntimeError
    except Exception:
        from mtf_tpu_torch.utils.input import ArrayInput, get_input
        src = get_input(source)
        reader = "python"
        if preproc and preproc not in ("none", "raw"):
            from mtf_tpu_torch.utils.preproc import get_preproc
            fn = get_preproc(preproc)
            src = ArrayInput([fn(torch.as_tensor(
                np.asarray(f, np.float32))).numpy() for f in src])
    with _lock:
        _state["input"] = src
        _state["iter"] = iter(src)
        _state["frame"] = None
        _state["frame_id"] = -1
        _state["trackers"] = {}
        _state["reader"] = reader
    return _advance()


def isInitialized() -> bool:
    return _state["input"] is not None


def reader() -> str | None:
    """Which frame reader `init` opened: "native" (the C++ pipeline) or
    "python" (`utils.input`)."""
    return _state["reader"]


def _advance() -> bool:
    try:
        frame = next(_state["iter"])
    except StopIteration:
        return False
    _state["frame"] = np.asarray(frame, np.float32)
    _state["frame_id"] += 1
    return True


def getFrame():
    """Latest decoded frame (pyMTF2 `getFrame`)."""
    return _state["frame"]


def getFrameID() -> int:
    return _state["frame_id"]


def _corners42(corners) -> np.ndarray:
    c = np.asarray(corners, np.float32)
    return c.T if c.shape == (2, 4) else c


def createTracker(corners, *, sm: str = "esm", am: str = "ncc",
                  ssm: str = "8", ilm: str | None = None, device=None,
                  **cfg) -> int:
    """Create + initialize a tracker on the current frame."""
    from mtf_tpu_torch import create_tracker
    if _state["frame"] is None:
        raise RuntimeError("call init() first")
    trk = create_tracker(sm, am, ssm, ilm, device=device, **cfg)
    dev = trk.device
    st = trk.initialize(torch.as_tensor(_state["frame"], device=dev),
                        torch.as_tensor(_corners42(corners)[None],
                                        device=dev))
    with _lock:
        tid = _state["next_id"]
        _state["next_id"] += 1
        _state["trackers"][tid] = {"trk": trk, "st": st}
    return tid


def createTrackers(corners_list, **kw) -> list[int]:
    return [createTracker(c, **kw) for c in corners_list]


def step() -> bool:
    """Advance one frame and update every tracker (the TrackerThread
    loop of TrackerStrct_mt.h, host-driven); the frame goes to each
    device once."""
    if not _advance():
        return False
    on_device = {}
    for ent in _state["trackers"].values():
        dev = ent["trk"].device
        if dev not in on_device:
            on_device[dev] = torch.as_tensor(_state["frame"], device=dev)
        ent["st"] = ent["trk"].update(ent["st"], on_device[dev])
    return True


def getRegion(tracker_id: int) -> np.ndarray:
    ent = _state["trackers"][tracker_id]
    return ent["trk"].corners(ent["st"])[0].cpu().numpy()


def setRegion(corners, tracker_id: int) -> None:
    ent = _state["trackers"][tracker_id]
    trk = ent["trk"]
    ent["st"] = trk.set_region(ent["st"], torch.as_tensor(
        _corners42(corners)[None], device=trk.device))


def removeTracker(tracker_id: int) -> None:
    with _lock:
        _state["trackers"].pop(tracker_id, None)


def removeTrackers() -> None:
    with _lock:
        _state["trackers"].clear()


def quit() -> None:
    with _lock:
        src = _state["input"]
        _state["input"] = None
        _state["iter"] = None
        _state["trackers"] = {}
        _state["reader"] = None
    if src is not None and hasattr(src, "close"):
        src.close()
