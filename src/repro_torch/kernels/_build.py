"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles at first use into its own shared library with a plain
C interface, loaded through ``ctypes``; the sources compile in parallel::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The library lands in ``build/kernels/`` at the root of the checkout, named by
a hash of its source, so an edited source rebuilds and an unchanged one is
reused.  ``build_all`` returns ``ptxas``'s report (registers, shared memory
and spills per kernel) for each library it compiled.

There is no fallback: no ``nvcc`` or a failed build raises.  Nothing here
runs at import time.  The first build and each library's load run once
under a module lock, so shard threads that reach a kernel together (a
threaded ``Cluster``) start one ``nvcc`` per source and one ``CDLL`` load.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: guards the first build and the library loads (shard threads race there)
_LOCK = threading.Lock()
#: ``build_all``'s result once it has run
_LIBS: Optional[Dict[str, Tuple[Path, str]]] = None
#: the loaded libraries by source stem
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built"
        )
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:12]}.so"


def build_all() -> Dict[str, Tuple[Path, str]]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all started together; once per process, whichever thread
    calls first.

    Returns ``{source stem: (library path, ptxas report)}``; the report is
    empty for a library that was already built.  Raises ``RuntimeError``
    with the compiler's output when a build fails (a later call tries
    again).
    """
    global _LIBS
    with _LOCK:
        if _LIBS is None:
            _LIBS = _compile_all()
        return _LIBS


def _compile_all() -> Dict[str, Tuple[Path, str]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, jobs = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = _target(src)
        libs[src.stem] = (lib, "")
        if not lib.is_file():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs[src] = (proc, tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: concurrent builds agree
        libs[src.stem] = (lib, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use,
    loaded once)."""
    libs = build_all()
    if name not in libs:
        raise RuntimeError(f"no kernel source csrc/{name}.cu")
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(libs[name][0]))
        return _LOADED[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
