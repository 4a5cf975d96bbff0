"""Exception taxonomy (port of `mtf_tpu/utils/excp.py`).

Mirrors the reference's `Utilities/include/mtf/Utilities/excpUtils.h`
(`InvalidTrackerState`, `FunctonNotImplemented`, `InvalidArgument`) so the
eval harness and API layers can distinguish tracker divergence (recoverable
via reinit, `runMTF.cc:470-476,708-714`) from programming errors.
"""
from __future__ import annotations


class TrackerException(Exception):
    """Base class for all mtf_tpu_torch exceptions."""


class InvalidTrackerState(TrackerException):
    """Tracker state became invalid (NaN/Inf corners, singular warp).

    The eval harness treats this as a tracking failure: reinit from GT when
    `reinit_on_failure` is set, otherwise terminate the run.
    """


class FunctionNotImplemented(TrackerException, NotImplementedError):
    """An optional interface member is not provided by this module
    (reference: the am_func/ssm_func_not_implemeted throwing stubs,
    `AppearanceModel.h:4-5`, `StateSpaceModel.h:8-9`)."""


class InvalidArgument(TrackerException, ValueError):
    """Bad user-supplied argument (unknown factory key, malformed config)."""


def check_corners(corners, where: str = "update"):
    """Raise `InvalidTrackerState` if corners contain NaN/Inf.

    Host-side guard used by the eval loop and API boundary — mirrors the
    invalid-state detection at `runMTF.cc:470-476`.
    """
    import numpy as np
    c = np.asarray(corners)
    if not np.all(np.isfinite(c)):
        raise InvalidTrackerState(
            f"non-finite tracker corners after {where}: {c.tolist()}")
    return c
