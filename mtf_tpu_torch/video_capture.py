"""cv2-style VideoCapture wrapper over the streaming pipeline (port of
`mtf_tpu/video_capture.py`).

Re-exposes the reference's python convenience class
(`Examples/python/mtf/mtf.py:4-50` — `mtf.VideoCapture`,
a cv2.VideoCapture look-alike backed by pyMTF2's threaded input pipeline).
Backed here by the native C++ decode pipeline when built, else the
pure-Python readers.

    from mtf_tpu_torch.video_capture import VideoCapture
    cap = VideoCapture("frames_dir")         # or video file / "cam:0"
    ok, frame = cap.read()
    cap.release()
"""
from __future__ import annotations

import numpy as np


class VideoCapture:
    def __init__(self, source: str, buffer_size: int = 8,
                 n_threads: int = 2):
        self._src = None
        try:
            from mtf_tpu_torch.utils.native_input import (
                NativeInput, native_available)
            if native_available():
                self._src = NativeInput(source, buffer_size, n_threads)
        except Exception:
            self._src = None
        if self._src is None:
            from mtf_tpu_torch.utils.input import get_input
            self._src = get_input(source)
        self._it = iter(self._src)
        self._opened = True

    def isOpened(self) -> bool:
        return self._opened

    def read(self):
        """-> (ok, frame float32) like cv2.VideoCapture.read()."""
        try:
            return True, np.asarray(next(self._it), np.float32)
        except StopIteration:
            return False, None

    def get(self, prop: int) -> float:
        """cv2.CAP_PROP_FRAME_{WIDTH=3, HEIGHT=4, COUNT=7} subset."""
        if prop == 3:
            return float(getattr(self._src, "width", 0))
        if prop == 4:
            return float(getattr(self._src, "height", 0))
        if prop == 7:
            try:
                return float(len(self._src))
            except TypeError:
                return -1.0
        return 0.0

    def release(self):
        self._opened = False
        if hasattr(self._src, "close"):
            self._src.close()
