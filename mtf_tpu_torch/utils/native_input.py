"""ctypes binding for the native frame pipeline (native/framepipe.cpp;
port of `mtf_tpu/utils/native_input.py`, loading the same library).

The TPU-native runtime replacement for the reference's Boost-thread input
pipeline (`TrackerStrct_mt.h:25-300` behind pyMTF2): JPEG/video decode and
buffering run in C++ threads; Python only receives ready float32 frames.
Falls back to the pure-Python `mtf_tpu_torch.utils.input` readers when the
shared library is unavailable (it is auto-built with `make -C native` on
first use if a toolchain is present).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_NATIVE_DIR, "libframepipe.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR],
                           capture_output=True, timeout=300, check=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.fp_open.restype = ctypes.c_void_p
    lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fp_open2.restype = ctypes.c_void_p
    lib.fp_open2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_double,
                             ctypes.c_double, ctypes.c_int]
    lib.fp_dims.restype = ctypes.c_int
    lib.fp_dims.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.fp_total.restype = ctypes.c_int
    lib.fp_total.argtypes = [ctypes.c_void_p]
    lib.fp_next.restype = ctypes.c_int
    lib.fp_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fp_close.restype = None
    lib.fp_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeInput:
    """Iterator over frames decoded by the C++ pipeline.

    Drop-in alternative to `mtf_tpu_torch.utils.input.get_input` sources for
    image directories, video files, and `cam:N` devices.
    """

    def __init__(self, source: str, buffer_size: int = 8,
                 n_threads: int = 2, preproc: str | None = None,
                 pp1: float = 5.0, pp2: float = 0.0,
                 to_gray: bool = False):
        """`preproc`: none/gauss/med/box/bil/sobel — the reference's
        host-side filter chain (pipeline.h:178-247), run inside the C++
        decode workers so it overlaps device compute. `pp1` is the
        kernel size (or bilateral d), `pp2` the sigma."""
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native framepipe unavailable "
                               "(build native/libframepipe.so)")
        self._lib = lib
        if preproc or to_gray:
            self._h = lib.fp_open2(source.encode(), buffer_size, n_threads,
                                   (preproc or "none").encode(),
                                   float(pp1), float(pp2), int(to_gray))
        else:
            self._h = lib.fp_open(source.encode(), buffer_size, n_threads)
        if not self._h:
            raise IOError(f"framepipe cannot open {source!r}")
        hh, ww, cc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.fp_dims(self._h, ctypes.byref(hh), ctypes.byref(ww),
                    ctypes.byref(cc))
        self.height, self.width, self.channels = hh.value, ww.value, cc.value
        self._cap = self.height * self.width * self.channels

    def __len__(self):
        n = self._lib.fp_total(self._h)
        if n < 0:
            raise TypeError("stream length unknown (camera/video)")
        return n

    def __iter__(self):
        buf = np.empty((self._cap,), np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while True:
            fid = self._lib.fp_next(self._h, ptr, self._cap)
            if fid < 0:
                return
            frame = buf.reshape(self.height, self.width, self.channels)
            yield (frame[..., 0] if self.channels == 1
                   else frame).copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fp_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
