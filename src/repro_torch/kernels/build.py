"""Build the hand-written CUDA kernels with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes no
PyTorch header, so it compiles in seconds. The shared library goes into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``) at
first use, under a name keyed by a hash of the source, the ``csrc/*.cuh``
headers it includes (``#include "name.cuh"``, followed through the headers
themselves) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. Nothing here runs
at import: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # nvcc wall time; 0.0 when the library was already built
    log: str         # nvcc's output, including the -Xptxas -v lines
    cached: bool


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_headers(src: Path) -> list:
    """The headers next to ``src`` that it includes in quotes, and theirs in
    turn, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = src.parent / inc
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def source_digest(src: Path) -> str:
    """Hash of ``src``, the headers it includes and the nvcc flags."""
    h = hashlib.sha256()
    for path in (src, *included_headers(src)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` for sm_90a unless a library built from the
    same source, headers and flags is already there."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log, True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Write under a private name, then rename: a concurrent build never
    # loads a half-written library.
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log, False)


def build_all(names) -> Dict[str, BuildResult]:
    """:func:`build` every named source at once, one nvcc process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: f.result() for name, f in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name).path))
