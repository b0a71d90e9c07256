"""The port's ``BaselineUNet`` and ``IntrinsicsConditionedUNet`` against
the JAX package's, each at f=8 from the same numpy-drawn variables
(``torch_port_common.build_family``), f32 on both sides.

- The eval-mode forward at B=4 and at B=1 (where FiLM skips its
  BatchNorm1d): atol and rtol 1e-3 m, as ``test_torch_model.py`` holds
  the flagship; one bf16 forward at atol 0.1 m.
- The gradient of ``mean(depth * mask)`` in training mode, the measure of
  ``tests/test_torch_parity.py``: each parameter within relative L2 2e-3
  (baseline) and 2e-2 (FiLM), the whole tree within a tenth of that,
  against JAX's float64 gradient (``torch_port_common.family_grads`` says
  why not its f32 one). At 32x32, B=4 (baseline) and B=8 (FiLM, whose
  BatchNorm1d over the camera vectors wants the larger batch): JAX's
  batch-norm statistics stay f32 in its float64 model, and the larger
  the maps they sum, the further its reference strays.
- Parameter counts equal, at f=8 and at the shipped f=64; the
  converter's round trip exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from cadepth_tpu_torch.models import factory

from torch_port_common import (assert_grads_close, assert_round_trip_exact,
                               build_family, family_forward, family_grads,
                               family_raw, full_width_counts,
                               make_train_batch)

FAMILIES = {
    "baseline_unet": dict(model={}, cls="BaselineUNet", grad_b=4, tol=2e-3),
    "intrinsics_unet": dict(model={"use_attention": False},
                            cls="IntrinsicsConditionedUNet", grad_b=8,
                            tol=2e-2),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    arch = request.param
    return arch, build_family(family_raw(arch, **FAMILIES[arch]["model"]),
                              seed=21)


@pytest.mark.parametrize("b", [4, 1])
def test_forward_matches_jax_f32(family, b):
    arch, fam = family
    assert type(fam[1][1]).__name__ == FAMILIES[arch]["cls"]
    got, want, record = family_forward(fam, b, seed=b)
    assert got.shape == want.shape == (b, 64, 64, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert record == {}  # these families write no intermediates


def test_forward_matches_jax_bf16(family):
    _, fam = family
    got, want, _ = family_forward(fam, 2, seed=5, use_amp=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.1)


def test_gradients_match_jax(family):
    arch, fam = family
    b = FAMILIES[arch]["grad_b"]
    rng = np.random.default_rng(6)
    batch = make_train_batch(rng, b, 32, 32)
    mask = rng.uniform(size=(b, 32, 32, 1)).astype(np.float32)
    got, want = family_grads(fam, batch, mask)
    assert_grads_close(got, want, FAMILIES[arch]["tol"])


def test_parameter_counts_match(family):
    arch, fam = family
    (_, _, _), (_, model, _), (params, _) = fam
    from cadepth_tpu.models import factory as jax_factory

    assert factory.count_parameters(model) == \
        jax_factory.count_parameters(params)
    port, jax_count = full_width_counts(arch, **FAMILIES[arch]["model"])
    assert port == jax_count


def test_convert_round_trip_is_exact(family):
    assert_round_trip_exact(family[1])
