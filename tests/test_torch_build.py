"""The naming of the CUDA libraries that ``ops/_build.py`` builds.

A library's file name carries a hash of its ``.cu`` source and of every
header under ``csrc/`` that the source includes with quotes, directly or
through another header, so editing a shared header rebuilds each library
that includes it and no other. Needs no ``nvcc``.
"""

from __future__ import annotations

from cadepth_tpu_torch.ops import _build


def test_hash_covers_included_headers(tmp_path):
    (tmp_path / "shared.cuh").write_text("// one\n")
    (tmp_path / "inner.cuh").write_text('#pragma once\n#include "shared.cuh"\n')
    a = tmp_path / "a.cu"
    a.write_text('#include "inner.cuh"\n#include <cuda_runtime.h>\n'
                 '  #  include "shared.cuh"\n')
    b = tmp_path / "b.cu"
    b.write_text("#include <math.h>\n")
    assert [p.name for p in _build.sources_of(a)] == \
        ["a.cu", "inner.cuh", "shared.cuh"]
    assert [p.name for p in _build.sources_of(b)] == ["b.cu"]
    ta, tb = _build._target(a), _build._target(b)
    assert ta.name.startswith("liba-") and ta.suffix == ".so"
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert _build._target(a) != ta
    assert _build._target(b) == tb
    a.write_text(a.read_text() + "// edited\n")
    assert _build._target(a) != ta


def test_the_warp_libraries_share_their_header():
    names = {s.stem: [p.name for p in _build.sources_of(s)]
             for s in _build.CSRC.glob("*.cu")}
    assert names == {"two_pass_warp": ["two_pass_warp.cu", "warp_common.cuh"],
                     "fused_warp": ["fused_warp.cu", "warp_common.cuh"],
                     "banded_affine_warp": ["banded_affine_warp.cu",
                                            "warp_common.cuh"],
                     "fused_loss": ["fused_loss.cu"],
                     "batch_norm": ["batch_norm.cu"]}
