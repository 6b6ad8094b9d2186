"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source builds anew and an unchanged one
is loaded from ``build/`` without compiling. nvcc's output (the
``-Xptxas -v`` report) is kept beside the library as ``.log`` and read
back when the library is loaded from ``build/``. Nothing here runs at import
time: the first launch builds, and :func:`build_all` builds every source
at once, one ``nvcc`` per source, all started together.

Building and loading are the only points where the port compiles or
loads code at run time. Both run under one lock, so threads racing a
first launch build and load each library once, and each emits an event
(``"build"`` per nvcc run, ``"load"`` per ``ctypes`` load) to the
listeners of :func:`add_listener` — what the service's
``compile_counter`` counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "BUILD_LOG", "nvcc_path",
           "build_all", "load", "add_listener", "remove_listener"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "REPRO_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[3] / "build"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# name -> {"cached": True when loaded from build/ without compiling,
#          "seconds": build wall time (None when cached),
#          "log": nvcc's output, the -Xptxas -v report included}
BUILD_LOG: Dict[str, Dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# Re-entrant: load() builds under the same lock that build_all() takes.
_LOCK = threading.RLock()
_LISTENERS: List[Callable[[str, str], None]] = []


def add_listener(fn: Callable[[str, str], None]) -> None:
    """Call ``fn(event, name)`` on every build ("build") and library load
    ("load") from now on, in the thread that builds or loads."""
    with _LOCK:
        _LISTENERS.append(fn)


def remove_listener(fn: Callable[[str, str], None]) -> None:
    with _LOCK:
        _LISTENERS.remove(fn)


def _emit(event: str, name: str) -> None:
    for fn in list(_LISTENERS):
        fn(event, name)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _target(name: str, nvcc: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS + (nvcc,)).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that
    ``build/`` does not hold yet, in parallel. Raises with nvcc's output
    if a build fails."""
    with _LOCK:
        return _build_all(names)


def _build_all(names) -> Dict[str, Path]:
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, nvcc) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in targets.items():
        if out.exists():
            log_file = out.with_suffix(".log")
            BUILD_LOG.setdefault(n, {
                "cached": True, "seconds": None,
                "log": log_file.read_text() if log_file.exists() else ""})
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
        targets[n].with_suffix(".log").write_text(log)
        os.replace(tmp, targets[n])
        BUILD_LOG[n] = {"cached": False,
                        "seconds": time.perf_counter() - t0, "log": log}
        _emit("build", n)
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Thread-safe: racing first calls build and load it once."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = build_all([name])[name]
                lib = _LIBS[name] = ctypes.CDLL(str(path))
                _emit("load", name)
    return lib
