"""Frame input pipelines (port of `mtf_tpu/utils/input.py`).

Re-designs the reference input layer
(`Utilities/include/mtf/Utilities/inputUtils.h:33-330`:
InputCV image-dir/video/camera, InputVP, InputXV, InputDummy) for a
host-side Python world: image directories via imageio/PIL/cv2 (whichever
is available), video via cv2 when present, synthetic/dummy sources for
tests, with the reference's ring-buffer semantics replaced by simple
iterator + prefetch (device feeding happens in the eval harness).
"""
from __future__ import annotations

import glob
import os

import numpy as np


def _load_image(path: str) -> np.ndarray:
    try:
        import cv2  # type: ignore
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(path)
        if img.ndim == 3:
            img = img[..., ::-1]  # BGR -> RGB
        return img.astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image  # type: ignore
        return np.asarray(Image.open(path), np.float32)
    except ImportError:
        pass
    import imageio.v2 as imageio  # type: ignore
    return np.asarray(imageio.imread(path), np.float32)


def load_image(path: str) -> np.ndarray:
    """Public single-image loader (cv2 -> PIL -> imageio fallback)."""
    return _load_image(path)


class InputBase:
    """Iterator protocol over frames (reference InputBase)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class ImageDirInput(InputBase):
    """Directory of numbered frames (reference InputCV jpeg-dir source)."""

    def __init__(self, path: str, pattern: str = "*.jpg"):
        self.files = sorted(glob.glob(os.path.join(path, pattern)))
        if not self.files:
            for pat in ("*.png", "*.bmp", "*.jpeg"):
                self.files = sorted(glob.glob(os.path.join(path, pat)))
                if self.files:
                    break
        if not self.files:
            raise FileNotFoundError(f"no frames under {path}")

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            yield _load_image(f)


class VideoInput(InputBase):
    """Video file via cv2 (reference InputCV video source)."""

    def __init__(self, path: str):
        import cv2  # type: ignore
        self.path = path
        cap = cv2.VideoCapture(path)
        self._len = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()

    def __len__(self):
        return self._len

    def __iter__(self):
        import cv2  # type: ignore
        cap = cv2.VideoCapture(self.path)
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1].astype(np.float32)
        cap.release()


class ArrayInput(InputBase):
    """In-memory frames (reference InputDummy, inputUtils.h:319)."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        return iter(self.frames)


class CameraInput(InputBase):
    """Live camera via cv2 (reference InputCV 'u'sb source; the ViSP
    USB/firewire InputVP variants collapse into this — cv2 is the only
    capture backend here). `n_frames` bounds live capture so tracking
    loops terminate; -1 streams forever (reference `Live` actor)."""

    def __init__(self, device: int = 0, n_frames: int = -1):
        self.device = device
        self.n_frames = n_frames

    def __len__(self):
        return self.n_frames if self.n_frames > 0 else 0

    def __iter__(self):
        import cv2  # type: ignore
        cap = cv2.VideoCapture(self.device)
        if not cap.isOpened():
            cap.release()
            raise RuntimeError(f"camera {self.device} unavailable")
        t = 0
        try:
            while self.n_frames < 0 or t < self.n_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[..., ::-1].astype(np.float32)
                t += 1
        finally:
            cap.release()


def get_input(source: str, **kw) -> InputBase:
    """Reference `getInput` (pipeline.h:35-176). source: a directory of
    frames, a video file, 'u[N]'/'camera[N]' for live capture, or
    'synthetic:<seed-image>' handled upstream."""
    import re
    s = str(source)
    m = re.fullmatch(r"(?:u|camera)(\d*)", s)
    if m and not os.path.exists(s):
        return CameraInput(int(m.group(1) or 0), **kw)
    if os.path.isdir(s):
        return ImageDirInput(s, **kw)
    if os.path.isfile(s):
        return VideoInput(s)
    raise FileNotFoundError(source)
