"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for `sm_90a` into `mtf_tpu_torch/_build/lib<name>-<hash>.so` at
first use, then loaded with `ctypes`. A source may be built several
times with different preprocessor defines (`-D<KEY>=<value>`, for
example the chain kernel once per state size), each into its own library
`lib<name>_<key><value>...-<hash>.so`. The hash covers the source, every
header it includes from `csrc/` (`#include "..."`, followed into nested
includes), the flags and the defines, so an edited source or header
rebuilds. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: Path) -> list[Path]:
    """`src` and the local headers it includes, in first-include order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _define_flags(defines: dict | None) -> list:
    return [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]


def lib_key(name: str, defines: dict | None = None) -> str:
    """Name of one build of `csrc/<name>.cu`: the source's name, then each
    define as `_<key><value>` (lower case), e.g. `lk_fused_chain_lk_s6`."""
    return name + "".join(f"_{k.lower()}{v}" for k, v
                          in sorted((defines or {}).items()))


def digest(name: str, csrc: Path = CSRC,
           defines: dict | None = None) -> str:
    """Build key of `<csrc>/<name>.cu` with `defines`: its bytes, its
    local headers' (name and bytes), the nvcc flags and the defines."""
    h = hashlib.sha256()
    for path in _sources(csrc / f"{name}.cu"):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS + tuple(_define_flags(defines))).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def load_all(specs) -> dict[str, Built]:
    """`load` each of `specs` (a source name, or a (name, defines) pair),
    their nvcc builds running side by side; keyed by `lib_key`."""
    specs = [(s, None) if isinstance(s, str) else tuple(s) for s in specs]
    with ThreadPoolExecutor(max(1, len(specs))) as ex:
        built = list(ex.map(lambda sp: load(*sp), specs))
    return {lib_key(*sp): b for sp, b in zip(specs, built)}


def load(name: str, defines: dict | None = None) -> Built:
    """Build (if needed) and load `csrc/<name>.cu` with `defines`; cached
    per process."""
    key = lib_key(name, defines)
    if key in _LOADED:
        return _LOADED[key]
    src = CSRC / f"{name}.cu"
    out = BUILD / f"lib{key}-{digest(name, defines=defines)}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *_define_flags(defines),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    built = Built(lib=ctypes.CDLL(str(out)), seconds=seconds,
                  log=log_path.read_text() if log_path.exists() else "")
    _LOADED[key] = built
    return built
