"""mexMTF2-style command-string front-end (port of `mtf_tpu/api_mex.py`).

The reference's MATLAB interface (`Examples/cpp/mexMTF2.cc:24-35`) exposes
the whole pipeline through ONE entry point taking a command string —
`mexMTF2('init', ...)`, `mexMTF2('create_tracker', ...)` — so any host
language with a single FFI call can drive it. This module reproduces that
surface over `mtf_tpu_torch.api2` (the streaming pipeline): call
`mex('command', *args)` with the same command vocabulary:

    init, is_initialized, quit, get_frame, create_tracker,
    create_trackers, get_region, set_region, remove_tracker,
    remove_trackers

Returns follow mexMTF2's convention: a success flag first, then payloads.
A tracker's trailing pairs may name its `device` (default: the card).
"""
from __future__ import annotations

import numpy as np

from mtf_tpu_torch import api2
from mtf_tpu_torch.utils.excp import InvalidArgument


def _cmd_init(source, *args):
    kw = {}
    if args:
        kw["buffer_size"] = int(args[0])
    return (api2.init(str(source), **kw),)


def _cmd_is_initialized():
    return (api2.isInitialized(),)


def _cmd_quit():
    api2.quit()
    return (True,)


def _cmd_get_frame():
    frame = api2.getFrame()
    if frame is None:
        return (False, None)
    return (True, np.asarray(frame))


def _parse_tracker_kw(args):
    """Optional trailing 'key value ...' pairs (the mex front-end passes
    config pairs the same way runMTF's CLI does)."""
    kw = {}
    for i in range(0, len(args) - 1, 2):
        k, v = str(args[i]), args[i + 1]
        if k in ("sm", "am", "ssm", "ilm"):
            kw[k] = str(v)
        else:
            kw.setdefault("params", {})[k] = v
    return kw


def _cmd_create_tracker(corners, *args):
    kw = _parse_tracker_kw(args)
    params = kw.pop("params", {})
    tid = api2.createTracker(np.asarray(corners, np.float32), **kw, **params)
    return (True, tid)


def _cmd_create_trackers(corners_list, *args):
    kw = _parse_tracker_kw(args)
    params = kw.pop("params", {})
    ids = api2.createTrackers([np.asarray(c, np.float32)
                               for c in corners_list], **kw, **params)
    return (True, ids)


def _cmd_get_region(tracker_id):
    api2.step()
    return (True, api2.getRegion(int(tracker_id)))


def _cmd_set_region(tracker_id, corners):
    api2.setRegion(np.asarray(corners, np.float32), int(tracker_id))
    return (True,)


def _cmd_remove_tracker(tracker_id):
    api2.removeTracker(int(tracker_id))
    return (True,)


def _cmd_remove_trackers():
    api2.removeTrackers()
    return (True,)


_CMDS = {
    "init": _cmd_init,
    "is_initialized": _cmd_is_initialized,
    "quit": _cmd_quit,
    "get_frame": _cmd_get_frame,
    "create_tracker": _cmd_create_tracker,
    "create_trackers": _cmd_create_trackers,
    "get_region": _cmd_get_region,
    "set_region": _cmd_set_region,
    "remove_tracker": _cmd_remove_tracker,
    "remove_trackers": _cmd_remove_trackers,
}


def mex(command: str, *args):
    """Dispatch one mexMTF2 command. Returns a tuple, success flag first."""
    fn = _CMDS.get(str(command))
    if fn is None:
        raise InvalidArgument(
            f"Invalid command provided: {command}. Valid: {sorted(_CMDS)}")
    return fn(*args)


# -- mexMTF (v1) ------------------------------------------------------
# The original synchronous front-end (`Examples/cpp/mexMTF.cc`): no
# internal pipeline — the caller supplies each frame, like pyMTF.
# Commands: create(img, corners[, cfg_dir]) -> id,
# get_region(img[, id]) -> (ok, corners), set_region(corners[, id]),
# remove([id]).

def _mex1_create(img, corners, *args):
    from mtf_tpu_torch import api
    cfg_dir = str(args[0]) if args else None
    return (api.create(np.asarray(img), np.asarray(corners), cfg_dir),)


def _mex1_get_region(img, tracker_id=1):
    from mtf_tpu_torch import api
    return (True, api.getRegion(np.asarray(img), int(tracker_id)))


def _mex1_set_region(corners, tracker_id=1):
    from mtf_tpu_torch import api
    api.setRegion(np.asarray(corners), int(tracker_id))
    return (True,)


def _mex1_remove(tracker_id=1):
    from mtf_tpu_torch import api
    api.remove(int(tracker_id))
    return (True,)


_CMDS_V1 = {
    "create": _mex1_create,
    "get_region": _mex1_get_region,
    "set_region": _mex1_set_region,
    "remove": _mex1_remove,
}


def mex1(command: str, *args):
    """Dispatch one mexMTF (v1) command — the synchronous caller-driven
    surface (mexMTF.cc), mirroring pyMTF."""
    fn = _CMDS_V1.get(str(command))
    if fn is None:
        raise InvalidArgument(
            f"Invalid command provided: {command}. Valid: {sorted(_CMDS_V1)}")
    return fn(*args)
