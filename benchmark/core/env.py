"""What a run sets up around the program and checks after it: fixed
cache directories inside the checkout, scratch space under the run's
``TMPDIR``, and the modules that must never load."""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path
from typing import List

from benchmark.core.manifest import ROOT

# top-level module names no run may load, compared whole (the port's
# package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cadepth_tpu")
PROGRAM = "cadepth_tpu_torch"


def prepare() -> None:
    """Fixed build and kernel caches inside the checkout, so only a
    checkout's first run of a cell builds (the port builds its CUDA
    libraries under ``build/cadepth_tpu_torch``, a fixed path there)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def program_present() -> bool:
    return (ROOT / PROGRAM / "__init__.py").is_file()


def scratch_dir(prefix: str) -> Path:
    """A new directory under the run's ``TMPDIR`` (removed by the
    caller)."""
    return Path(tempfile.mkdtemp(prefix=prefix))


def forbidden_loaded() -> List[str]:
    """Forbidden top-level names in ``sys.modules``."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
