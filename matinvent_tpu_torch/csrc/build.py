"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``matinvent_tpu_torch/_build/lib<name>-<hash>.so``, where the hash
covers the source, every ``csrc/`` header it includes (directly or through
another header) and the flags, so an edited source or header is rebuilt.
A build with preprocessor defines (``build(name, ("FLAG",))``, for
instrumented variants) is a library of its own.
Threads may build different sources at the same time: nvcc runs outside
the lock. PyTorch's headers are not included and
``torch.utils.cpp_extension`` is not used: the build takes seconds. A
missing ``nvcc`` or a failed build raises with the compiler's output;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v",
    "-shared",
    "-Xcompiler", "-fPIC",
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()  # guards _loaded
_loaded: dict[tuple[str, tuple[str, ...]], "Built"] = {}


class Built:
    """A loaded library and the ``-Xptxas -v`` report of its build."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str, seconds: float):
        self.lib = lib
        self.path = path
        self.log = log
        self.seconds = seconds  # 0.0 when the library was already built


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of matinvent_tpu_torch are built from source on first use"
        )
    return nvcc


def source_digest(name: str, csrc: Path = CSRC, flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of ``csrc/<name>.cu``, of every file of ``csrc`` that it
    ``#include "..."``s (followed through headers, each file once) and of
    the flags. A quoted include that is not in ``csrc`` is left to nvcc."""
    root = csrc.resolve()
    h = hashlib.sha256(" ".join(flags).encode())
    todo, seen = [root / f"{name}.cu"], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        for inc in _INCLUDE.findall(text):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and dep.is_relative_to(root):
                todo.append(dep)
    return h.hexdigest()[:16]


def build(name: str, defines: tuple[str, ...] = ()) -> Built:
    """Compile (once) and load ``csrc/<name>.cu``, with ``-D`` of each of
    ``defines``."""
    key = (name, defines)
    with _lock:
        if key in _loaded:
            return _loaded[key]
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = source_digest(name, flags=flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        nvcc = find_nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *flags, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n{log}"
            )
        log_path.write_text(log)
        # atomic: a concurrent build of the same source sees a whole file
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    built = Built(ctypes.CDLL(str(lib_path)), lib_path, log, seconds)
    with _lock:
        return _loaded.setdefault(key, built)
