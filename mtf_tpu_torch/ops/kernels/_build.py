"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for `sm_90a` into `mtf_tpu_torch/_build/lib<name>-<hash>.so` at
first use, then loaded with `ctypes`. The hash covers the source and the
flags, so an edited source rebuilds. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A loaded kernel library and how it was built."""
    lib: ctypes.CDLL
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    log: str            # nvcc output, including ptxas register/spill lines


_LOADED: dict[str, Built] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def load_all(names) -> dict[str, Built]:
    """`load` each of `names`, their nvcc builds running side by side."""
    names = list(names)
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        return dict(zip(names, ex.map(load, names)))


def load(name: str) -> Built:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    built = Built(lib=ctypes.CDLL(str(out)), seconds=seconds,
                  log=log_path.read_text() if log_path.exists() else "")
    _LOADED[name] = built
    return built
