"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``ops/_build/lib<name>-<hash>.so``: a shared library with a plain C
interface, loaded with ctypes.  The hash covers the source and the
flags, so an edited source rebuilds and an unchanged one loads the
library already built.  Nothing is downloaded and no binary is kept in
the repository: the first use on a machine with a card builds.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together.  ``load(name)`` builds that one source if needed and
returns its ``ctypes.CDLL``.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def sources() -> List[str]:
    """Kernel source names: ops/csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Popen of the nvcc that builds ``name``, or None when built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build every source in parallel (one nvcc each) and load them."""
    with _lock:
        names = [n for n in sources() if n not in _libs]
        started = {n: _start(n) for n in names}
        errors = []
        for n in names:
            try:
                _finish(n, started[n])
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
        for n in names:
            _libs[n] = ctypes.CDLL(str(_target(n)))
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ops/csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def build_log(name: str) -> str:
    """nvcc's output for the last build of ``name`` (ptxas register and
    shared-memory report), or '' when it was not built here."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
