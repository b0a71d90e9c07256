"""The training batch norm's Function (``ops/batch_norm.py``) on the CPU.

Its plain version, the closed form the card's kernels compute and the
path a training ``BatchNorm2d`` takes on the CPU, on bf16 and float32
channels_last maps, against autograd through the layers' own formula
(``_FlaxTrainingNorm.forward`` on the float32 map, which BatchNorm1d
keeps) and against flax's ``BatchNorm`` as the JAX
package applies it: the output, the running statistics and the
gradients of x, weight and bias. Also a constant channel (the variance
clamped at 0), the running statistics left alone while a block is
recomputed, two Gloo ranks against one process, and the kernels' launch
plan. The kernels themselves are held against this plain version on the
card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from _torch_batch_norm_worker import (bf16_ulp, check_ranks, close,
                                      make_map, make_params,
                                      ranks_against_one_process)
from cadepth_tpu.models import layers as jax_layers
from cadepth_tpu_torch.models import layers
from cadepth_tpu_torch.ops import batch_norm as bn

SHAPES = [(4, 16, 6, 7), (2, 64, 5, 9), (3, 24, 4, 4)]
DTYPES = [torch.bfloat16, torch.float32]


def _layer(c, seed=1):
    norm = layers.BatchNorm2d(c)
    w, b, rm, rv = make_params(c, seed)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        norm.running_mean.copy_(rm)
        norm.running_var.copy_(rv)
    return norm.train()


def _through_layer(x, dy, out_dtype, seed=1):
    """(y, dx, dweight, dbias, layer) through the layers' float32 formula
    (``_FlaxTrainingNorm.forward``, the model's path on the CPU before
    the Function) and autograd."""
    norm = _layer(x.shape[1], seed)
    xa = x.clone().requires_grad_()
    y = layers._FlaxTrainingNorm.forward(norm, xa.float()).to(out_dtype)
    y.backward(dy)
    return y, xa.grad, norm.weight.grad, norm.bias.grad, norm


def _through_function(x, dy, out_dtype, seed=1, update=True):
    norm = _layer(x.shape[1], seed)
    xb = x.clone().requires_grad_()
    y = bn.batch_norm_train(xb, norm.weight, norm.bias, norm.running_mean,
                            norm.running_var, norm.num_batches_tracked,
                            norm.eps, layers.BN_MOMENTUM, update, None,
                            out_dtype)
    y.backward(dy)
    return y, xb.grad, norm.weight.grad, norm.bias.grad, norm


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_autograd_through_the_layer(shape, dtype):
    """The forward and the running statistics are the layer's own
    operations in its order, so they are bit-equal; the gradients are the
    closed form against autograd's chain (``_close``)."""
    x = make_map(shape, dtype)
    dy = make_map(shape, dtype, seed=2, offset=0.0)
    ya, dxa, dwa, dba, la = _through_layer(x, dy, dtype)
    yb, dxb, dwb, dbb, lb = _through_function(x, dy, dtype)
    assert yb.dtype == dtype and dxb.dtype == dtype
    assert yb.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(ya, yb)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(la, name), getattr(lb, name)), name
    assert int(lb.num_batches_tracked) == 1
    close(dxb, dxa, dtype, "dx")
    close(dwb, dwa, torch.float32, "dweight")
    close(dbb, dba, torch.float32, "dbias")


@pytest.mark.parametrize("out_dtype", DTYPES)
def test_plain_takes_a_bf16_map_to_either_output_dtype(out_dtype):
    """A bf16 map with a float32 output (and the other way) is the layer's
    ``norm(x.float()).to(out_dtype)``; dx comes back in x's dtype."""
    x = make_map((2, 16, 5, 6), torch.bfloat16)
    dy = make_map((2, 16, 5, 6), out_dtype, seed=3, offset=0.0)
    ya, dxa, *_ = _through_layer(x, dy, out_dtype)
    yb, dxb, *_ = _through_function(x, dy, out_dtype)
    assert yb.dtype == out_dtype and dxb.dtype == torch.bfloat16
    assert torch.equal(ya, yb)
    close(dxb, dxa, torch.bfloat16, "dx")


class _FlaxNorm(fnn.Module):
    """The JAX package's training batch norm: ``apply_norm(x, "batch",
    True, "bn", out_dtype)``."""

    out_dtype: object

    @fnn.compact
    def __call__(self, x):
        return jax_layers.apply_norm(x, "batch", True, "bn", self.out_dtype)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_flax(shape, dtype):
    """Against flax's BatchNorm under JAX on the CPU, NHWC: XLA sums in
    another order and may fuse a multiply-add, so float32 values agree
    within 1e-5 of the largest value (statistics within 2e-6 relative,
    running statistics 1e-6 absolute: they are 0.01 of the batch's) and
    bf16 maps within one bf16 ulp of each element (``_close``). JAX's dx
    of a bf16 map is the sum, in bf16, of two cotangents each rounded to
    bf16 (the transposes of x's two casts to float32, into the statistics
    and into the normalization), where the port rounds once: where the
    two cancel, JAX's is tens of ulps off (46 in this test's first case),
    so there the port's dx is held to lie no further from the float64
    closed form than JAX's, plus one ulp."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = make_map(shape, dtype)
    dy = make_map(shape, dtype, seed=2, offset=0.0)
    yb, dxb, dwb, dbb, norm = _through_function(x, dy, dtype)
    w, b, rm, rv = make_params(shape[1])

    def nhwc(t):
        return jnp.asarray(t.float().permute(0, 2, 3, 1).numpy()).astype(jdt)

    variables = {"params": {"bn": {"scale": jnp.asarray(w.numpy()),
                                   "bias": jnp.asarray(b.numpy())}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(rm.numpy()),
                                        "var": jnp.asarray(rv.numpy())}}}
    module = _FlaxNorm(jdt)

    def run(xj, params):
        return module.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xj,
                            mutable=["batch_stats"])

    yj, state = run(nhwc(x), variables["params"])
    _, pull = jax.vjp(lambda xj, p: run(xj, p)[0], nhwc(x),
                      variables["params"])
    dxj, dparams = pull(nhwc(dy))

    def torch_of(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))
                                ).permute(0, 3, 1, 2)

    close(yb, torch_of(yj), dtype, "y")
    stats = state["batch_stats"]["bn"]
    np.testing.assert_allclose(norm.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(norm.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)
    if dtype == torch.float32:
        close(dxb, torch_of(dxj), dtype, "dx")
    else:
        _, stats = bn.forward_plain(x.double(), w.double(), b.double(),
                                    rm.double(), rv.double(),
                                    torch.zeros((), dtype=torch.long),
                                    norm.eps, layers.BN_MOMENTUM, False)
        exact, _, _ = bn.backward_plain(x.double(), dy.double(), w.double(),
                                        stats)
        port_err = (dxb.double() - exact).abs()
        jax_err = (torch_of(dxj).double() - exact).abs()
        assert (port_err <= jax_err + bf16_ulp(exact).double()).all()
    close(dwb, torch.from_numpy(np.array(dparams["bn"]["scale"])),
           torch.float32, "dweight")
    close(dbb, torch.from_numpy(np.array(dparams["bn"]["bias"])),
           torch.float32, "dbias")


def _raw_variance(x: torch.Tensor) -> torch.Tensor:
    """E[x^2] - E[x]^2 per channel, the layer's float32 operations."""
    xf = x.float()
    mean = xf.mean([0, 2, 3])
    return (xf * xf).mean([0, 2, 3]) - mean * mean


def _constant_channel_map(dtype):
    """A (4, 3, 5, 6) channels_last map of ``dtype`` whose channel 1 is
    constant up to float32's round-off: in float32, 1000 plus noise of
    1e-3, the first seed whose E[x^2] - E[x]^2 comes out below 0 (the
    variance, 1e-6, is far under the sums' round-off, 0.06), so the clamp
    acts; in bf16, which cannot hold such noise, one value, whose
    variance comes out 0 (the clamp's edge, where it still passes the
    gradient)."""
    x = make_map((4, 3, 5, 6), torch.float32)
    for seed in range(100):
        noise = np.random.default_rng(seed).normal(0, 1e-3, (4, 5, 6))
        x[:, 1] = 1000.0 + torch.from_numpy(noise.astype(np.float32))
        if dtype == torch.bfloat16:
            x[:, 1] = 1.1015625
        t = x.to(dtype).contiguous(memory_format=torch.channels_last)
        if dtype == torch.bfloat16 or _raw_variance(t)[1].item() < 0:
            return t
    raise AssertionError("no seed clamps")


@pytest.mark.parametrize("dtype", DTYPES)
def test_constant_channel_takes_the_clamp(dtype):
    """A constant channel (``_constant_channel_map``): where its float32
    variance comes out below 0 the flag is set, the variance is 0, and
    the gradient drops the variance term, as autograd through
    ``clamp_min`` does; at exactly 0 the flag is clear and the term
    stays, as there too. Either way the output and the gradients are the
    layer's; the other channels are unaffected."""
    x = _constant_channel_map(dtype)
    shape = x.shape
    dy = make_map(shape, dtype, seed=4, offset=0.0)
    ya, dxa, dwa, dba, _ = _through_layer(x, dy, dtype)
    yb, dxb, dwb, dbb, norm = _through_function(x, dy, dtype)
    _, stats = bn.forward_plain(x, norm.weight, norm.bias,
                                norm.running_mean.clone(),
                                norm.running_var.clone(),
                                norm.num_batches_tracked.clone(), norm.eps,
                                layers.BN_MOMENTUM, False)
    clamped = float(dtype == torch.float32)
    assert stats[3].tolist() == [0.0, clamped, 0.0]
    if not clamped:
        assert _raw_variance(x)[1].item() == 0.0
    assert torch.equal(ya, yb)
    assert torch.isfinite(dxb.float()).all()
    close(dxb, dxa, dtype, "dx")
    close(dwb, dwa, torch.float32, "dweight")
    close(dbb, dba, torch.float32, "dbias")


def test_recomputing_leaves_the_running_statistics():
    """``update=False`` and a block recomputed for the backward (the layer
    passes ``not recomputing()``) leave the running statistics and the
    count as they were; a checkpointed block moves them once and gives
    the gradients of the block run whole."""
    x = make_map((2, 8, 4, 5), torch.bfloat16)
    dy = make_map((2, 8, 4, 5), torch.bfloat16, seed=5, offset=0.0)
    _, _, _, _, norm = _through_function(x, dy, torch.bfloat16, update=False)
    fresh = _layer(8)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(norm, name), getattr(fresh, name)), name
    with layers._recompute_context(None):
        norm(x, torch.bfloat16)
    assert int(norm.num_batches_tracked) == 0
    assert torch.equal(norm.running_mean, fresh.running_mean)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = layers.Conv2d(8, 8, 3, padding=1, bias=False)
            self.bn = _layer(8)

        def forward(self, t):
            return torch.relu(self.bn(self.conv(t), torch.bfloat16))

    torch.manual_seed(0)
    whole = Block()
    ckpt = Block()
    ckpt.load_state_dict(whole.state_dict())
    for block, run in ((whole, whole), (ckpt, None)):
        xi = x.clone().requires_grad_()
        y = block(xi) if run is not None else layers.checkpointed(block, xi)
        y.backward(dy)
        block.x_grad = xi.grad
    assert int(ckpt.bn.num_batches_tracked) == 1
    assert torch.equal(ckpt.bn.running_mean, whole.bn.running_mean)
    assert torch.equal(ckpt.bn.running_var, whole.bn.running_var)
    assert torch.equal(ckpt.x_grad, whole.x_grad)
    assert torch.equal(ckpt.conv.weight.grad, whole.conv.weight.grad)
    assert torch.equal(ckpt.bn.weight.grad, whole.bn.weight.grad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_gloo_ranks_match_one_process(tmp_path, dtype):
    ranks, one = ranks_against_one_process(tmp_path, "cpu", dtype,
                                           (4, 16, 6, 7))
    check_ranks(ranks, one, dtype)


def test_plan_cuts_the_maps_of_the_cells():
    """Eight channels a thread where C % 8 == 0 and the maps are aligned;
    a block's threads span whole chunks of C; blocks follow the rows up
    to BLOCKS."""
    p = bn.plan(32 * 240 * 320, 64, True)
    assert p == bn.Plan(vec=8, groups=8, rows=32, chunks=1, blocks=528)
    p = bn.plan(8 * 15 * 20, 3072, True)
    assert p == bn.Plan(vec=8, groups=192, rows=1, chunks=2, blocks=150)
    p = bn.plan(8 * 480 * 640, 96, True)
    assert (p.groups, p.rows, p.chunks) == (12, 21, 1)
    assert bn.plan(100, 64, False).vec == 1
    p = bn.plan(7, 3, True)
    assert p == bn.Plan(vec=1, groups=3, rows=85, chunks=1, blocks=1)
    for m, c, aligned in ((2240, 2048, True), (10, 24, True),
                          (5, 1000, False), (1 << 22, 96, True)):
        p = bn.plan(m, c, aligned)
        assert p.groups * p.chunks * p.vec == c
        assert p.groups * p.rows <= bn.THREADS
        assert 1 <= p.blocks <= bn.BLOCKS


def test_card_wrapper_refuses_a_cpu_map():
    """The card path's first check, reachable here: it takes card maps
    only (the Function sends CPU maps to the plain version)."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        bn.check_map(make_map((2, 8, 3, 3), torch.float32))


def test_norm_span_says_which_path_ran():
    """Under a profiler, ``apply_norm``'s span ``norm.fwd`` carries
    ``kernel``: 0 on the CPU, where no kernel runs (the card's are
    counted by ``tests/test_torch_cuda.py``), for a training batch norm
    and an eval-mode one alike."""
    from torch.profiler import ProfilerActivity, profile

    from cadepth_tpu_torch.utils import profiling

    norm = _layer(8)
    x = make_map((2, 8, 4, 5), torch.bfloat16)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        layers.apply_norm(x, norm, torch.bfloat16)
        layers.apply_norm(x, norm.eval(), torch.bfloat16)
    spans = [s for s in profiling.recorded_spans() if s["name"] == "norm.fwd"]
    assert [s["attrs"] for s in spans] == [{"kernel": 0}, {"kernel": 0}]


def test_training_layer_runs_the_function_on_the_cpu():
    """``apply_norm`` sends a training BatchNorm2d's map, in its own dtype,
    through the Function whose closed form the card's kernels compute
    (its output bit-equal to a direct call); an eval-mode one, and a
    training BatchNorm1d, stay on autograd through the float32 map."""
    x = make_map((2, 8, 4, 5), torch.bfloat16).requires_grad_()
    y = layers.apply_norm(x, _layer(8), torch.bfloat16)
    assert type(y.grad_fn).__name__ == "BatchNormTrainBackward"
    yb, *_ = _through_function(x.detach(), torch.ones_like(y),
                               torch.bfloat16)
    assert torch.equal(y, yb)
    y = layers.apply_norm(x, _layer(8).eval(), torch.bfloat16)
    assert "BatchNormTrain" not in type(y.grad_fn.next_functions[0][0]
                                        ).__name__
    norm1d = layers.BatchNorm1d(8).train()
    v = norm1d(torch.randn(4, 8, requires_grad=True))
    assert type(v.grad_fn).__name__ == "AddBackward0"
