"""Build the CUDA sources under ``cadepth_tpu_torch/csrc`` and load them.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface, in
``build/cadepth_tpu_torch/`` at the root of the checkout. The library
name carries a hash of its source and of every header under ``csrc``
that it includes (``#include "..."``, followed into headers), so an
edited source or shared header rebuilds each library that uses it and a
stale library is never loaded. All sources are compiled together on the
first call of :func:`build_all` or :func:`library`; later calls load
what is there. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "cadepth_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels of cadepth_tpu_torch "
                       "build only where the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources_of(src: pathlib.Path) -> List[pathlib.Path]:
    """``src`` and the headers it includes with quotes, directly or
    through other headers, that exist beside it: each once, in the order
    first reached."""
    seen: List[pathlib.Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header.exists():
                todo.append(header)
    return seen


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256()
    for path in sources_of(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source stem: library path}.
    """
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: st for stem, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for stem, (src, lib) in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs.append((stem, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for stem, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
                os.unlink(tmp)
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no CUDA source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _loaded[stem] = lib
        return lib
