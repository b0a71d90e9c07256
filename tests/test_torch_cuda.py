"""Tests of the port that need an NVIDIA card (marked ``cuda``).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has the card and no JAX. ``tests/conftest.py`` imports JAX,
so there run it without the conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Each test decides inside itself whether there is a card, and skips
where ``torch.cuda.is_available()`` is False.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cadepth_tpu_torch.config import config_from_dict
from cadepth_tpu_torch.inference import Predictor
from cadepth_tpu_torch.metrics.depth_metrics import compute_depth_metrics
from _torch_batch_norm_worker import (bf16_ulp, check_ranks,
                                      ranks_against_one_process)
from cadepth_tpu_torch.ops import banded_affine_warp as baw
from cadepth_tpu_torch.ops import batch_norm as bnk
from cadepth_tpu_torch.ops import fused_loss as fl
from cadepth_tpu_torch.ops import fused_warp as fw
from cadepth_tpu_torch.ops import two_pass_warp as warp_mod
from cadepth_tpu_torch.ops.affine_warp import (
    two_pass_affine_warp_plain,
    two_pass_affine_warp_plain_bwd,
    two_pass_affine_warp_plain_fwd,
)
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training.schedule import build_lr_schedule

THETAS = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[0.8, 0, 0.1], [0, 1.2, -0.2]],
    "rotation": [[0.999, -0.03, 0.02], [0.03, 0.999, 0.01]],
    "shear": [[1.0, 0.1, 0.0], [0.05, 1.0, 0.0]],
    "a_tiny": [[4e-4, 0.1, 0.05], [0.2, 0.9, 0.0]],
}
# thetas whose transposed passes visit a whole row or column (|A| or |q|
# near 0) or none of it: a 90 degree rotation (A = 0, clamped), zooms
# out and in, a singular map with q = E - p B = 0
GENERAL = {
    "rotation_90": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0]],
    "zoom_0.3": [[0.3, 0.0, 0.05], [0.0, 0.3, -0.05]],
    "zoom_3": [[3.0, 0.0, 0.1], [0.0, 3.0, -0.1]],
    "q_zero": [[1.0, 0.5, 0.0], [0.5, 0.25, 0.0]],
}
TWO_PASS_THETAS = dict(THETAS, **GENERAL)
# odd sizes, channel counts that do and do not fill 16-byte vectors, and
# the flagship's dec5 map (at the serving and the training batch)
SHAPES = [(2, 24, 32, 8), (3, 15, 20, 16), (2, 14, 20, 32), (1, 7, 9, 3),
          (2, 5, 6, 12), (8, 14, 20, 1024), (4, 14, 20, 1024)]
# the flagship's five decoder maps (f=64, 240x320) at batch 2
LEVELS = [(2, 2 * (240 >> k), 2 * (320 >> k), 64 << (k - 1))
          for k in (5, 4, 3, 2, 1)]
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """f32 at atol 1e-5, bf16 at atol 2e-2 on N(0, 1) inputs; both
    paddings, both align_corners."""
    _need_card()
    rng = np.random.default_rng(0)
    for shape in SHAPES:
        img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for name, th in TWO_PASS_THETAS.items():
            theta = np.tile(np.asarray(th, np.float32)[None], (shape[0], 1, 1))
            theta = torch.from_numpy(
                theta + rng.normal(scale=0.01, size=theta.shape)
                .astype(np.float32) * (name in THETAS and name != "a_tiny")
            ).cuda()
            for dtype, atol in ATOL.items():
                x = img.to(dtype)
                for pad in ("zeros", "border"):
                    for ac in (False, True):
                        before = warp_mod.launches
                        got = warp_mod.two_pass_warp(x, theta, pad, ac)
                        torch.cuda.synchronize()
                        assert warp_mod.launches == \
                            before + warp_mod.LAUNCHES_PER_CALL
                        want = two_pass_affine_warp_plain(x, theta, pad, ac)
                        assert got.dtype == dtype and got.shape == x.shape
                        err = (got.float() - want.float()).abs().max().item()
                        assert err <= atol, (shape, name, dtype, pad, ac, err)


@pytest.mark.cuda
def test_one_launch_forward_is_bit_equal_at_the_decoder_levels():
    """The one-launch forward, serving (no V) and training (V stored),
    equals the plain version exactly (max err 0, up to the sign of a
    zero) at the flagship's five decoder maps, f32 and bf16, every theta,
    both paddings and both align_corners; the stored V equals the plain
    V; serving stores none."""
    _need_card()
    rng = np.random.default_rng(5)
    for shape in LEVELS:
        img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for name, th in TWO_PASS_THETAS.items():
            theta = torch.from_numpy(np.tile(np.asarray(th, np.float32)[None],
                                             (shape[0], 1, 1))).cuda()
            for dtype in ATOL:
                x = img.to(dtype)
                for pad in ("zeros", "border"):
                    for ac in (False, True):
                        what = (shape, name, dtype, pad, ac)
                        want, want_v = two_pass_affine_warp_plain_fwd(
                            x, theta, pad, ac)
                        stores = warp_mod.v_stores
                        served, none = warp_mod._forward(x, theta, pad, ac,
                                                         keep_v=False)
                        assert none is None and warp_mod.v_stores == stores
                        out, v = warp_mod._forward(x, theta, pad, ac,
                                                   keep_v=True)
                        assert warp_mod.v_stores == stores + 1
                        for got, ref in ((served, want), (out, want),
                                         (v, want_v)):
                            err = (got.float() - ref.float()).abs().max()
                            assert err.item() == 0.0, (what, err.item())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    theta = torch.zeros(2, 2, 3, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(2, 8, 6, 4, device="cuda").transpose(1, 2)
        warp_mod.two_pass_warp(x, theta)
    with pytest.raises(ValueError, match="theta is on"):
        warp_mod.two_pass_warp(torch.zeros(2, 6, 8, 4, device="cuda"),
                               theta.cpu())


def _bwd_case(shape, name, dtype, rng):
    """(img, theta, grad_out, v) on the card for one backward check."""
    img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    theta = np.tile(np.asarray(TWO_PASS_THETAS[name], np.float32)[None],
                    (shape[0], 1, 1))
    # identity: the exact kinks; the general thetas exact too
    if name in THETAS and name not in ("identity", "a_tiny"):
        theta = theta + rng.normal(scale=0.01, size=theta.shape) \
            .astype(np.float32)
    theta = torch.from_numpy(theta).cuda()
    grad = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    x = img.to(dtype)
    return x, theta, grad.to(dtype)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """d_img at f32 atol 1e-5 x max(1, max|d_img|) (sums of many taps
    where |A| is tiny are taken in another order than the plain
    version's index_add_), bf16 atol 2e-2 x max(1, max|d_img|);
    d_theta divided by its largest |entry| at atol 1e-5 (f32) and 1e-3
    (bf16: a one-ulp difference of a bf16 d_v moves the g partials)."""
    _need_card()
    rng = np.random.default_rng(1)
    for shape in SHAPES + LEVELS[:2]:
        for name in TWO_PASS_THETAS:
            for dtype, atol in ATOL.items():
                x, theta, grad = _bwd_case(shape, name, dtype, rng)
                for pad in ("zeros", "border"):
                    for ac in (False, True):
                        _, v = two_pass_affine_warp_plain_fwd(x, theta, pad,
                                                              ac)
                        before = warp_mod.bwd_launches
                        got = warp_mod.two_pass_warp_bwd(x, v, theta, grad,
                                                         pad, ac)
                        torch.cuda.synchronize()
                        assert warp_mod.bwd_launches == \
                            before + warp_mod.BWD_LAUNCHES_PER_CALL
                        want = two_pass_affine_warp_plain_bwd(x, v, theta,
                                                              grad, pad, ac)
                        what = (shape, name, dtype, pad, ac)
                        assert got[0].dtype == dtype, what
                        scale = max(1.0, want[0].float().abs().max().item())
                        err = (got[0].float() - want[0].float()).abs().max()
                        assert err.item() <= atol * scale, (what, err)
                        t_scale = want[1].abs().max().item() + 1e-12
                        t_err = (got[1] - want[1]).abs().max().item()
                        t_atol = 1e-5 if dtype == torch.float32 else 1e-3
                        assert t_err <= t_atol * t_scale, (what, t_err)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic():
    _need_card()
    rng = np.random.default_rng(2)
    x, theta, grad = _bwd_case((2, 30, 40, 64), "rotation", torch.bfloat16,
                               rng)
    _, v = two_pass_affine_warp_plain_fwd(x, theta)
    a = warp_mod.two_pass_warp_bwd(x, v, theta, grad)
    b = warp_mod.two_pass_warp_bwd(x, v, theta, grad)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [2, 4])
def test_windowed_kernels_match_plain_on_card(bands):
    """The warp over windows of output rows (spatial parallelism's
    bands; the flagship's five decoder maps at batch 2, each cut into
    ``bands`` windows of rows): the forward's rows and V equal those rows of the
    whole kernel's and the windowed plain version's (max err 0, f32 and
    bf16); the windows' backward kernels summed equal the whole backward
    kernel's d_img (f32 within 1e-5 x max(1, max|d_img|), bf16 within
    2e-2 x that) and its d_theta (phase 6's 1e-5 / 1e-3 of its largest
    entry); every window's launches are counted as windowed, and two runs
    give the same bits."""
    _need_card()
    rng = np.random.default_rng(7)
    for shape in LEVELS:
        # a partition of the rows (the last window takes the rest)
        size = shape[1] // bands
        windows = [(k * size, size if k < bands - 1 else shape[1] - k * size)
                   for k in range(bands)]
        for name in ("identity", "rotation", "zoom_0.3", "q_zero"):
            for dtype, atol in ATOL.items():
                x, theta, grad = _bwd_case(shape, name, dtype, rng)
                what = (shape, name, dtype)
                whole, v = warp_mod._forward(x, theta, "zeros", False,
                                             keep_v=True)
                d_img, d_theta = warp_mod.two_pass_warp_bwd(x, v, theta, grad)
                sum_img = torch.zeros_like(d_img, dtype=torch.float32)
                sum_theta = torch.zeros_like(d_theta)
                for k, (row0, rows) in enumerate(windows):
                    before = (warp_mod.window_launches,
                              warp_mod.window_bwd_launches)
                    out, wv = warp_mod._forward(x, theta, "zeros", False,
                                                keep_v=True, row0=row0,
                                                rows=rows)
                    plain, plain_v = two_pass_affine_warp_plain_fwd(
                        x, theta, "zeros", False, row0, rows)
                    for got, ref in ((out, whole[:, row0:row0 + rows]),
                                     (wv, v[:, row0:row0 + rows]),
                                     (out, plain), (wv, plain_v)):
                        err = (got.float() - ref.float()).abs().max().item()
                        assert err == 0.0, (what, k, err)
                    g = grad[:, row0:row0 + rows].contiguous()
                    a, b = warp_mod.two_pass_warp_bwd(x, wv, theta, g,
                                                      row0=row0, rows=rows)
                    a2, b2 = warp_mod.two_pass_warp_bwd(x, wv, theta, g,
                                                        row0=row0, rows=rows)
                    assert torch.equal(a, a2) and torch.equal(b, b2), what
                    assert (warp_mod.window_launches,
                            warp_mod.window_bwd_launches) == (
                        before[0] + warp_mod.LAUNCHES_PER_CALL,
                        before[1] + 2 * warp_mod.BWD_LAUNCHES_PER_CALL)
                    sum_img += a.float()
                    sum_theta += b
                scale = max(1.0, d_img.float().abs().max().item())
                err = (sum_img - d_img.float()).abs().max().item()
                assert err <= atol * scale, (what, err)
                t_atol = 1e-5 if dtype == torch.float32 else 1e-3
                t_err = (sum_theta - d_theta).abs().max().item()
                assert t_err <= t_atol * (d_theta.abs().max().item()
                                          + 1e-12), (what, t_err)


@pytest.mark.cuda
def test_autograd_function_launches_the_backward_kernels():
    """Through the Function on the card, against the plain backward on
    the CPU, with a strided incoming gradient (copied, and counted)."""
    _need_card()
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 15, 20, 16)).astype(np.float32)
    theta = np.asarray([THETAS["rotation"]] * 2, np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        im = torch.from_numpy(img).to(dev).requires_grad_(True)
        th = torch.from_numpy(theta).to(dev).requires_grad_(True)
        warp_mod.launches = warp_mod.bwd_launches = warp_mod.grad_copies = 0
        warp_mod.v_stores = 0
        out = warp_mod.two_pass_warp(im, th).permute(0, 3, 1, 2)
        torch.sin(out.contiguous()).sum().backward()
        if dev == "cuda":
            assert warp_mod.launches == warp_mod.LAUNCHES_PER_CALL == 1
            assert warp_mod.v_stores == 1
            assert warp_mod.bwd_launches == warp_mod.BWD_LAUNCHES_PER_CALL
            assert warp_mod.BWD_LAUNCHES_PER_CALL <= 3
            assert warp_mod.grad_copies == 1
        grads.append((im.grad.cpu(), th.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], atol=1e-5, rtol=0)
    scale = grads[0][1].abs().max()
    torch.testing.assert_close(grads[1][1] / scale, grads[0][1] / scale,
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_three_train_steps_on_card_match_cpu():
    """A small f32 flagship takes three AdamW steps on the card (kernels,
    TF32 off) and on the CPU (plain) from the same weights and batches:
    losses at rtol 1e-4, parameters within 2 x sum(lr) (Adam moves a
    parameter by about lr per step, and a gradient entry whose sign is
    round-off may move it the other way on the other side, as
    test_torch_train_step.py explains); 10 backward launches per step."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 8},
        "data": {"input_height": 64, "input_width": 96},
        "training": {"use_amp": False, "batch_size": 4},
        "optimization": {"lr_warmup_epochs": 0, "learning_rate": 1e-4}})
    rng = np.random.default_rng(4)
    batches = [_train_batch(rng, 4, 64, 96) for _ in range(3)]
    runs = []
    for dev in ("cpu", "cuda"):
        model, loss_fn = ts.build_model_and_loss(
            cfg, device=dev, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("fc_transform.bias"):
                    p.copy_(torch.tensor([1.04, 0.95, 0.03, -0.02, 0.04,
                                          0.03]))
        opt = ts.build_optimizer(cfg.optimization, model.parameters())
        step = ts.make_train_step(cfg, model, loss_fn, opt,
                                  build_lr_schedule(cfg.optimization, 10, 5))
        logs = []
        for b in batches:
            warp_mod.bwd_launches = 0
            logs.append({k: float(v) for k, v in step(
                {k: torch.from_numpy(a).to(dev) for k, a in b.items()})
                .items()})
            if dev == "cuda":
                assert warp_mod.bwd_launches == \
                    5 * warp_mod.BWD_LAUNCHES_PER_CALL
        runs.append((logs, {k: v.cpu() for k, v in
                            model.state_dict().items()}))
    (cpu_logs, cpu_sd), (gpu_logs, gpu_sd) = runs
    for a, b in zip(gpu_logs, cpu_logs):
        for k in ("total_loss", "si_loss", "grad_loss", "smooth_loss",
                  "reproj_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    for k in cpu_sd:
        assert (gpu_sd[k].float() - cpu_sd[k].float()).abs().max() <= 6e-4, k


def _train_batch(rng, b, h, w):
    k = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    k[:, 0, 0] = rng.uniform(0.5, 1.5, b) * w
    k[:, 1, 1] = rng.uniform(0.5, 1.5, b) * w
    k[:, 0, 2] = rng.uniform(0.3, 0.7, b) * w
    k[:, 1, 2] = rng.uniform(0.3, 0.7, b) * h
    depth = rng.uniform(0.3, 9.5, (b, h, w, 1)).astype(np.float32)
    depth[rng.uniform(0, 1, depth.shape) < 0.1] = 0.05
    return {"rgb": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
            "depth": depth, "intrinsics": k,
            "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]],
                           -1)}


@pytest.mark.cuda
def test_predictor_on_card_matches_cpu():
    """A small f32 flagship served on the card, through the kernel, agrees
    with the same weights on the CPU (plain warp) at atol 1e-3 m, and
    launches the kernel twice per PCL per forward."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 8},
        "data": {"input_height": 64, "input_width": 96},
        "training": {"use_amp": False}})
    cpu = Predictor(cfg, batch_size=3, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in cpu.model.named_parameters():
            if name.endswith("fc_transform.bias"):
                p.copy_(torch.tensor([1.04, 0.95, 0.03, -0.02, 0.04, 0.03]))
    card = Predictor(cfg, cpu.model.state_dict(), batch_size=3, device="cuda")
    rgb = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 3)) \
        .astype(np.float32)
    warp_mod.launches = warp_mod.v_stores = 0
    got = card.predict(rgb)
    assert warp_mod.launches == 5 * warp_mod.LAUNCHES_PER_CALL
    assert warp_mod.v_stores == 0
    np.testing.assert_allclose(got, cpu.predict(rgb), atol=1e-3)


# the banded warp: odd sizes, it = 3 (15, 30 rows) and it = 2 (14 rows, the
# flagship's dec5), channel counts below a 16-byte vector, dense levels
# (kb >= H: 5 and 8 rows), a real band (48 rows), and dec5 at full width
FUSED_SHAPES = [(3, 15, 20, 16), (2, 30, 40, 8), (4, 14, 20, 8), (1, 7, 9, 3),
                (2, 5, 6, 12), (2, 8, 12, 4), (2, 48, 64, 8), (8, 14, 20, 1024)]
FUSED_THETAS = dict(THETAS, rot_02=[[0.98007, -0.19867, 0.0],
                                    [0.19867, 0.98007, 0.0]])


def _fused_case(shape, name, dtype, rng):
    img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    theta = np.tile(np.asarray(FUSED_THETAS[name], np.float32)[None],
                    (shape[0], 1, 1))
    if name not in ("identity", "a_tiny", "rot_02"):
        theta = theta + rng.normal(scale=0.01, size=theta.shape) \
            .astype(np.float32)
    grad = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    return img.to(dtype), torch.from_numpy(theta).cuda(), grad.to(dtype)


@pytest.mark.cuda
def test_fused_kernels_match_plain_on_card():
    """Forward (V and the output) at the kernel-vs-plain atols above;
    backward d_img at atol x max(1, max|d_img|), d_theta over its largest
    |entry| at 1e-5 (f32) and 1e-3 (bf16), as the two-pass backward."""
    _need_card()
    rng = np.random.default_rng(5)
    for shape in FUSED_SHAPES:
        for name in FUSED_THETAS:
            for dtype, atol in ATOL.items():
                x, theta, grad = _fused_case(shape, name, dtype, rng)
                for ac in (False, True):
                    what = (shape, name, dtype, ac)
                    before = fw.launches
                    out, v = fw._forward(x, theta, ac, keep_v=True)
                    torch.cuda.synchronize()
                    assert fw.launches == before + fw.LAUNCHES_PER_CALL
                    want_out, want_v = fw.fused_warp_plain_fwd(x, theta, ac)
                    for got, want in ((v, want_v), (out, want_out)):
                        assert got.dtype == dtype, what
                        err = (got.float() - want.float()).abs().max().item()
                        assert err <= atol, (what, err)
                    before = fw.bwd_launches
                    d_img, d_theta = fw.fused_warp_bwd(x, want_v, theta, grad,
                                                       ac)
                    torch.cuda.synchronize()
                    assert fw.bwd_launches == before + fw.BWD_LAUNCHES_PER_CALL
                    w_img, w_theta = fw.fused_warp_plain_bwd(x, want_v, theta,
                                                             grad, ac)
                    scale = max(1.0, w_img.float().abs().max().item())
                    err = (d_img.float() - w_img.float()).abs().max().item()
                    assert err <= atol * scale, (what, err)
                    t_err = ((d_theta - w_theta).abs().max()
                             / (w_theta.abs().max() + 1e-12)).item()
                    assert t_err <= (1e-5 if dtype == torch.float32
                                     else 1e-3), (what, t_err)


@pytest.mark.cuda
def test_fused_one_launch_forward_is_bit_equal_at_the_decoder_levels():
    """The one-launch banded forward, serving (no V) and training (V
    stored), equals fused_warp_plain_fwd exactly (max err 0, up to the
    sign of a zero) at the flagship's five decoder maps, f32 and bf16,
    every theta (the 0.2 rad rotation lies outside the band at the larger
    levels, where both drop the same taps), both align_corners; the
    stored V equals the plain V; serving stores none."""
    _need_card()
    rng = np.random.default_rng(8)
    for shape in LEVELS:
        img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for name, th in FUSED_THETAS.items():
            theta = torch.from_numpy(np.tile(np.asarray(th, np.float32)[None],
                                             (shape[0], 1, 1))).cuda()
            for dtype in ATOL:
                x = img.to(dtype)
                for ac in (False, True):
                    what = (shape, name, dtype, ac)
                    want, want_v = fw.fused_warp_plain_fwd(x, theta, ac)
                    stores, before = fw.v_stores, fw.launches
                    served, none = fw._forward(x, theta, ac, keep_v=False)
                    assert none is None and fw.v_stores == stores
                    out, v = fw._forward(x, theta, ac, keep_v=True)
                    assert fw.v_stores == stores + 1
                    assert fw.launches == before + 2 * fw.LAUNCHES_PER_CALL
                    for got, ref in ((served, want), (out, want),
                                     (v, want_v)):
                        err = (got.float() - ref.float()).abs().max()
                        assert err.item() == 0.0, (what, err.item())


@pytest.mark.cuda
def test_fused_kernels_are_deterministic_and_refuse_border():
    """Two runs of the forward and of the backward give the same bits, at
    a map the plan splits into channel chunks (dec5 at B=4) and at one it
    does not; the backward is three launches a call."""
    _need_card()
    rng = np.random.default_rng(6)
    for shape in ((2, 30, 40, 64), (4, 14, 20, 1024)):
        x, theta, grad = _fused_case(shape, "rotation", torch.bfloat16, rng)
        a = fw._forward(x, theta, False, keep_v=True)
        b = fw._forward(x, theta, False, keep_v=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        before = fw.bwd_launches
        da = fw.fused_warp_bwd(x, a[1], theta, grad)
        db = fw.fused_warp_bwd(x, a[1], theta, grad)
        torch.cuda.synchronize()
        assert fw.bwd_launches == before + 2 * fw.BWD_LAUNCHES_PER_CALL
        assert fw.BWD_LAUNCHES_PER_CALL == 3
        assert torch.equal(da[0], db[0]) and torch.equal(da[1], db[1])
    with pytest.raises(ValueError, match="zeros"):
        fw.fused_warp(x, theta, "border")


@pytest.mark.cuda
def test_fused_function_on_card_matches_cpu():
    """Through FusedWarp on the card (kernels, a strided incoming
    gradient that is copied and counted) against the CPU (plain)."""
    _need_card()
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 30, 40, 16)).astype(np.float32)
    theta = np.asarray([THETAS["rotation"]] * 2, np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        im = torch.from_numpy(img).to(dev).requires_grad_(True)
        th = torch.from_numpy(theta).to(dev).requires_grad_(True)
        fw.launches = fw.bwd_launches = fw.grad_copies = fw.v_stores = 0
        out = fw.fused_warp(im, th).permute(0, 3, 1, 2)
        torch.sin(out.contiguous()).sum().backward()
        if dev == "cuda":
            assert fw.launches == fw.LAUNCHES_PER_CALL == 1
            assert fw.v_stores == 1
            assert fw.bwd_launches == fw.BWD_LAUNCHES_PER_CALL
            assert fw.grad_copies == 1
        grads.append((im.grad.cpu(), th.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], atol=1e-5, rtol=0)
    scale = grads[0][1].abs().max()
    torch.testing.assert_close(grads[1][1] / scale, grads[0][1] / scale,
                               atol=1e-5, rtol=0)


def _loss_case(rng, b, h, w, empty=False):
    pred = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt[gt < 1.0] = 0.0
    if empty:
        gt[:] = 0.0
    pred[0, 0, :3] = [0.0, 1e-7, 2000.0]  # outside the clip range
    k4 = np.stack([rng.uniform(0.5, 1.5, b) * w, rng.uniform(0.5, 1.5, b) * w,
                   rng.uniform(0.3, 0.7, b) * w, rng.uniform(0.3, 0.7, b) * h],
                  -1).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (pred, gt, k4)]


@pytest.mark.cuda
def test_fused_loss_kernels_match_plain_on_card():
    """Statistics at 1e-5 of the sum of their terms' magnitudes (the
    count exactly), the gradient bit for bit (the plain version's
    expressions, elementwise): odd sizes, the flagship's (4, 240, 320), an
    empty mask; each call one launch; two runs give the same bits; the
    Function's gradient keeps a bf16 pred's dtype."""
    _need_card()
    rng = np.random.default_rng(8)
    for b, h, w, empty in [(1, 21, 30, False), (2, 24, 40, False),
                           (4, 240, 320, False), (1, 7, 5, True)]:
        pred, gt, k4 = _loss_case(rng, b, h, w, empty)
        fl.launches = fl.bwd_launches = 0
        got = fl.depth_loss_stats(pred, gt, k4)
        assert fl.launches == 1
        again = fl.depth_loss_stats(pred, gt, k4)
        assert fl.launches == 2 and torch.equal(got, again)
        want = fl.depth_loss_stats_plain(pred, gt, k4)
        maskf = (gt > 1e-6).float()
        d = fl._log_diff(pred, gt) * maskf
        mag = torch.stack([d.abs().sum(), want[1], want[2],
                           want[3]]).clamp_min(1.0)
        assert got[2] == want[2]
        assert ((got - want).abs() / mag).max() <= 1e-5, (b, h, w, got, want)
        coefs = torch.tensor([0.3, -1.7, 0.01], device="cuda")
        dp = fl.depth_loss_grad(pred, gt, k4, coefs)
        assert fl.bwd_launches == 1
        assert torch.equal(dp, fl.depth_loss_grad_plain(pred, gt, k4, coefs))
    x = pred.to(torch.bfloat16).requires_grad_(True)
    si, rep = fl.silog_reproj_losses(x, gt, k4)
    (si + rep).backward()
    assert x.grad.dtype == torch.bfloat16 and float(si) == 0.0


@pytest.mark.cuda
def test_fused_loss_stats_is_one_kernel_on_card():
    """Ten calls of the statistics run ten launches of one kernel on the
    card and nothing else (no sum, fill or memset), at the flagship's (4,
    240, 320); an unaligned pred (scalar loads) gives the same bits."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    pred, gt, k4 = _loss_case(np.random.default_rng(9), 4, 240, 320)
    fl.depth_loss_stats(pred, gt, k4)
    torch.cuda.synchronize()
    # the profiler can drop records at a profile's ends: spin kernels
    # there take the loss, and are left out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(10):
            got = fl.depth_loss_stats(pred, gt, k4)
        torch.cuda.synchronize()
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and "spin_kernel" not in e.key}
    assert len(seen) == 1 and "stats_kernel" in next(iter(seen)), seen
    assert next(iter(seen.values())) == 10, seen
    flat = torch.empty(pred.numel() + 1, device="cuda")
    shifted = flat[1:].view(pred.shape)
    shifted.copy_(pred)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(fl.depth_loss_stats(shifted, gt, k4), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 240, 320), (3, 17, 21), (2, 9, 1028),
                                   (3, 200, 1024), (8, 600, 1024)])
def test_fused_loss_stats_plans_on_card(shape):
    """Maps of one tile a block and of more tiles than the 256 blocks
    (tiles shared out round the blocks) keep the statistics within 1e-5
    of the plain version, the count exact, on a stream of their own
    too."""
    _need_card()
    b, h, w = shape
    pred, gt, k4 = _loss_case(np.random.default_rng(10), b, h, w)
    plan = fl.stats_plan(b, h, w)
    assert plan.blocks == min(plan.tiles, fl.STATS_MAX_BLOCKS)
    want = fl.depth_loss_stats_plain(pred, gt, k4)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got_side = fl.depth_loss_stats(pred, gt, k4)
    side.synchronize()
    got = fl.depth_loss_stats(pred, gt, k4)
    assert torch.equal(got, got_side)
    maskf = (gt > 1e-6).float()
    mag = torch.stack([(fl._log_diff(pred, gt) * maskf).abs().sum(),
                       want[1], want[2], want[3]]).clamp_min(1.0)
    assert got[2] == want[2]
    assert ((got - want).abs() / mag).max() <= 1e-5, (shape, got, want)


@pytest.mark.cuda
def test_fused_loss_stats_keeps_no_state_across_streams_and_graphs():
    """The statistics keep nothing between calls: calls on 40 streams
    made and dropped in turn, two of them at once, give the same bits and
    leave the allocated memory where it was; a call captured in a CUDA
    graph gives them on replay."""
    _need_card()
    pred, gt, k4 = _loss_case(np.random.default_rng(11), 4, 240, 320)
    want = fl.depth_loss_stats(pred, gt, k4)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for _ in range(20):
        one, two = torch.cuda.Stream(), torch.cuda.Stream()
        for stream in (one, two):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                got = fl.depth_loss_stats(pred, gt, k4)
            stream.synchronize()
            assert torch.equal(got, want)
        del one, two, got
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fl.depth_loss_stats(pred, gt, k4)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = fl.depth_loss_stats(pred, gt, k4)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 240, 320), (3, 17, 21), (2, 9, 1028),
                                   (3, 200, 1024), (8, 600, 1024),
                                   (2, 9, 1024), (1, 1, 7), (2, 5, 4)])
def test_fused_loss_grad_is_bit_equal_on_card(shape):
    """The gradient kernel equals the plain version bit for bit over
    grad_plan's plans (one quad a thread, a column a thread where W % 4
    != 0, two strips a row at 1028, several waves at (8, 600, 1024)), with
    an unaligned pred (a view one element into a buffer: scalar loads and
    stores) and an empty mask too; each call one launch."""
    _need_card()
    b, h, w = shape
    pred, gt, k4 = _loss_case(np.random.default_rng(12), b, h, w)
    coefs = torch.tensor([0.3, -1.7, 0.01], device="cuda")
    want = fl.depth_loss_grad_plain(pred, gt, k4, coefs)
    fl.bwd_launches = 0
    assert torch.equal(fl.depth_loss_grad(pred, gt, k4, coefs), want)
    flat = torch.empty(pred.numel() + 1, device="cuda")
    shifted = flat[1:].view(pred.shape)
    shifted.copy_(pred)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(fl.depth_loss_grad(shifted, gt, k4, coefs), want)
    empty = torch.zeros_like(gt)
    got = fl.depth_loss_grad(pred, empty, k4, coefs)
    assert torch.equal(got, torch.zeros_like(pred))
    assert not torch.signbit(got).any()  # +0, as the plain version's
    assert fl.bwd_launches == 3
    none = fl.depth_loss_grad(pred[:0], gt[:0], k4[:0], coefs)
    assert none.shape == (0, h, w) and fl.bwd_launches == 3


def _backward_cotangents():
    """(name, the (4,) cotangent autograd hands the Function's backward):
    contiguous, stats.sum()'s stride-0 ones, a [::2] view and a column
    of a stack."""
    w = torch.tensor([0.3, -1.7, 5.0, 0.01], device="cuda")
    spaced = torch.zeros(8, device="cuda")
    spaced[::2] = w
    return [("contiguous", w),
            ("stride_0", torch.ones(1, device="cuda").expand(4)),
            ("strided", spaced[::2]),
            ("stack_column", torch.stack([w, -w], 1)[:, 0])]


@pytest.mark.cuda
def test_fused_loss_backward_is_one_kernel_on_card():
    """Ten backwards of the Function with an f32 pred at the flagship's
    (4, 240, 320) run ten launches of the gradient kernel and nothing
    else (no index, copy, memcpy or fill), for a contiguous and a stride-0
    cotangent; every cotangent (strided ones too) gives the plain
    version's bits of its entries 0, 1 and 3."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    pred, gt, k4 = _loss_case(np.random.default_rng(13), 4, 240, 320)
    x = pred.clone().requires_grad_(True)
    stats = fl.fused_depth_loss_stats(x, gt, k4)
    cots = _backward_cotangents()
    for name, cot in cots:
        (got,) = torch.autograd.grad(stats, x, cot, retain_graph=True)
        want = fl.depth_loss_grad_plain(pred, gt, k4, cot[[0, 1, 3]])
        assert torch.equal(got, want), name
    for name, cot in cots[:2]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fl.bwd_launches = 0
            for _ in range(10):
                torch.autograd.grad(stats, x, cot, retain_graph=True)
            torch.cuda.synchronize()
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and "spin_kernel" not in e.key}
        assert len(seen) == 1 and "grad_kernel" in next(iter(seen)), \
            (name, seen)
        assert next(iter(seen.values())) == 10 == fl.bwd_launches, \
            (name, seen)


@pytest.mark.cuda
def test_fused_loss_backward_keeps_no_state_across_streams_and_graphs():
    """The Function's forward and backward on a side stream, and captured
    together in a CUDA graph, give the default stream's gradient bits
    (on replay, twice)."""
    _need_card()
    pred, gt, k4 = _loss_case(np.random.default_rng(14), 4, 240, 320)
    cot = torch.tensor([0.3, -1.7, 5.0, 0.01], device="cuda")
    x = pred.clone().requires_grad_(True)

    def grad():
        stats = fl.fused_depth_loss_stats(x, gt, k4)
        return torch.autograd.grad(stats, x, cot)[0]

    want = grad()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = grad()
    side.synchronize()
    assert torch.equal(on_side, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = grad()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, want)


def _rotation(rad):
    c, s_ = float(np.cos(rad)), float(np.sin(rad))
    return [[c, -s_, 0.0], [s_, c, 0.0]]


@pytest.mark.cuda
def test_banded_affine_kernel_matches_plain_on_card():
    """Odd shapes, C = 3 and channel counts that do not fill 16-byte
    vectors, the flagship's five decoder maps at batch 2, in band and out
    of band (0.35 and 0.6 rad): f32 and bf16 bit-equal (max error 0); one
    launch per call."""
    _need_card()
    rng = np.random.default_rng(5)
    thetas = dict(THETAS, rot_035=_rotation(0.35), rot_06=_rotation(0.6),
                  oob_translate=[[1, 0, 0.9], [0, 1, 0.9]])
    for shape in SHAPES + LEVELS + [(1, 48, 64, 16), (2, 33, 47, 5)]:
        img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for name, th in thetas.items():
            theta = torch.from_numpy(np.tile(np.asarray(th, np.float32)[None],
                                             (shape[0], 1, 1))).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x = img.to(dtype)
                before = baw.launches
                got = baw.banded_affine_warp(x, theta)
                torch.cuda.synchronize()
                assert baw.launches == before + baw.LAUNCHES_PER_CALL
                want = baw.banded_affine_warp_plain(x, theta)
                assert got.dtype == dtype and got.shape == x.shape
                err = (got.float() - want.float()).abs().max().item()
                assert err == 0.0, (shape, name, dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,chunk", [
    (1, 64, 16), (2, 64, 8), (3, 17, 16), (8, 5, 8), (4, 64, 24)])
def test_banded_affine_kernel_tilings_on_card(rows, cols, chunk):
    """Tilings other than the plan's (several rows a block, strips of
    columns narrower than the row, ragged tiles, strips and chunks) give
    the plain version's bits; the flagship's dec1 map and an odd one."""
    _need_card()
    rng = np.random.default_rng(6)
    for shape, th in [((2, 48, 64, 16), _rotation(0.05)),
                      ((3, 21, 37, 24), THETAS["zoom_shift"]),
                      ((2, 23, 64, 16), _rotation(0.35))]:
        img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .cuda()
        theta = torch.from_numpy(np.tile(np.asarray(th, np.float32)[None],
                                         (shape[0], 1, 1))).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = img.to(dtype)
            vec = 16 // x.element_size()
            if chunk % vec:
                continue
            plan = baw.plan_of(shape[0], shape[1], shape[2], shape[3], vec,
                               rows, min(cols, shape[2]), chunk)
            out = torch.empty_like(x)
            baw._launch(x, theta, out, plan)
            want = baw.banded_affine_warp_plain(x, theta)
            assert torch.equal(out, want), (shape, dtype, plan)


@pytest.mark.cuda
def test_banded_affine_kernel_is_deterministic_and_refuses_what_it_does_not_take():
    _need_card()
    x = torch.randn(2, 24, 32, 8, device="cuda").to(torch.bfloat16)
    theta = torch.tensor(_rotation(0.2), device="cuda").expand(2, 2, 3) \
        .contiguous()
    first = baw.banded_affine_warp(x, theta)
    for _ in range(3):
        assert torch.equal(baw.banded_affine_warp(x, theta), first)
    with pytest.raises(ValueError, match="contiguous"):
        baw.banded_affine_warp(x.transpose(1, 2), theta)
    with pytest.raises(TypeError, match="float32 or"):
        baw.banded_affine_warp(x.half(), theta)
    with pytest.raises(RuntimeError, match="forward only"):
        baw.banded_affine_warp(x.float().requires_grad_(True), theta)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "auto", "separable"])
def test_pcl_modes_train_step_on_card_matches_cpu(mode):
    """One f32 train step of the small flagship in each plain-PyTorch PCL
    mode, on the card (TF32 off) and on the CPU from the same weights:
    the losses at rtol 1e-4 (the bound of chip_smoke.py phase 8)."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 4,
                  "pcl_warp": mode, "norm": "group",
                  "decoder_upsample": "resize", "remat": "highres"},
        "data": {"input_height": 32, "input_width": 32},
        "training": {"use_amp": False, "batch_size": 4}})
    rng = np.random.default_rng(7)
    batch = {"rgb": rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(0.3, 9.5, (4, 32, 32, 1)).astype(np.float32)}
    k = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    k[:, 0, 0] = k[:, 1, 1] = rng.uniform(16, 48, 4)
    k[:, 0, 2] = k[:, 1, 2] = 16.0
    batch["intrinsics"] = k
    batch["k4"] = np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]],
                           -1)
    logs = []
    for dev in ("cpu", "cuda"):
        model, loss_fn = ts.build_model_and_loss(
            cfg, device=dev, generator=torch.Generator().manual_seed(3))
        step = ts.make_train_step(
            cfg, model, loss_fn,
            ts.build_optimizer(cfg.optimization, model.parameters()),
            build_lr_schedule(cfg.optimization, 1, 10))
        logs.append({k_: float(v) for k_, v in step(
            {k_: torch.from_numpy(v).to(dev) for k_, v in batch.items()})
            .items()})
    for key in logs[0]:
        if key.endswith("loss"):
            np.testing.assert_allclose(logs[1][key], logs[0][key], rtol=1e-4,
                                       err_msg=key)


@pytest.mark.cuda
def test_depth_metrics_on_card_match_cpu():
    """compute_depth_metrics on the card against the CPU, same seeded
    inputs: every metric at rtol 1e-5 (f32 sums over the pixels in
    another order), the pixel count exactly. Then log10 with equal bits
    where one pixel is valid, so that no sum of many terms can differ:
    the card divides |log p - log g| by log(10) as the CPU and JAX do
    (PyTorch's CUDA division by a Python float would multiply by its
    reciprocal). The pixels compared are those whose log p - log g the
    two devices' log functions round alike, so the division alone is
    held; at least half of them must be."""
    _need_card()
    rng = np.random.default_rng(9)
    pred = rng.uniform(0.05, 12.0, (2, 24, 32, 1)).astype(np.float32)
    gt = rng.uniform(0.05, 12.0, (2, 24, 32, 1)).astype(np.float32)
    gt[rng.uniform(0, 1, gt.shape) < 0.1] = 0.0
    maps = {dev: (torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev))
            for dev in ("cpu", "cuda")}
    out = {dev: compute_depth_metrics(*maps[dev]) for dev in maps}
    for key, want in out["cpu"].items():
        got = out["cuda"][key].cpu()
        if key == "num_valid_pixels":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0,
                                       msg=key)

    def log_diff(p, g):
        return torch.log(p.clamp(0.1, 10.0)) - torch.log(g)

    valid = np.flatnonzero((gt > 0.1) & (gt < 10.0))[:128]
    flat = {dev: [t.reshape(-1)[torch.from_numpy(valid).to(dev)]
                  for t in maps[dev]] for dev in maps}
    same = (log_diff(*flat["cpu"]) == log_diff(*flat["cuda"]).cpu()).numpy()
    assert same.sum() >= len(valid) // 2, (same.sum(), len(valid))
    for at in valid[same]:
        mask = np.zeros(gt.shape, bool)
        mask.reshape(-1)[at] = True
        got = {dev: compute_depth_metrics(
            *maps[dev], valid_mask=torch.from_numpy(mask).to(dev))["log10"]
            .cpu() for dev in maps}
        assert torch.equal(got["cuda"], got["cpu"]), (at, got)


def _fixture_loader(root, split="train", augment=True):
    """The port's synthetic SUN RGB-D fixture (12 scenes), loaded at 48x64
    with rays derived on the device, augmented on the train split."""
    from cadepth_tpu_torch.data.sunrgbd import AugmentationConfig, \
        SunRGBDLoader
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    manifest = generate_synthetic_dataset(str(root), images_per_sensor=3,
                                          seed=5)
    loader = SunRGBDLoader(f"{root}/sunrgbd", manifest, split=split,
                           target_height=48, target_width=64,
                           compute_rays=True, rays_on_device=True)
    if augment:
        loader.enable_augmentation(AugmentationConfig(random_seed=3))
    return loader


@pytest.mark.cuda
@pytest.mark.parametrize("use_native", ["never", "auto"])
def test_input_pipeline_on_card_yields_the_cpu_batches(tmp_path, use_native):
    """Pinned, asynchronous copies on the pipeline's own stream: every
    batch of two epochs, kept while later batches are copied (a ring of
    prefetch_depth + 2 = 3 pinned slots, reused four times an epoch) and
    while other work allocates on the card, equals the CPU pipeline's
    batch; a sum taken on the consumer's stream as each batch arrives
    equals the CPU's (the stream waits for the copy)."""
    from cadepth_tpu_torch.data.pipeline import InputPipeline

    _need_card()
    loader = _fixture_loader(tmp_path)
    kw = dict(batch_size=2, shuffle=True, seed=4, prefetch_depth=1,
              num_threads=2, use_native=use_native)
    card = InputPipeline(loader, device="cuda", **kw)
    cpu = InputPipeline(loader, device="cpu", **kw)
    for _ in range(2):
        kept, sums = [], []
        for b in card:
            assert b["rgb"].is_cuda
            sums.append(b["rgb"].sum(dtype=torch.float64))
            kept.append(b)
            torch.empty(4 << 20, device="cuda").fill_(7.0)  # reuse bait
        want = list(cpu)
        assert len(kept) == len(want) == 6
        for b, w, s in zip(kept, want, sums):
            assert b.keys() == w.keys()
            for k in w:
                assert torch.equal(b[k].cpu(), w[k]), k
            assert float(s) == float(w["rgb"].sum(dtype=torch.float64))


@pytest.mark.cuda
def test_trainer_epoch_on_card_matches_cpu(tmp_path):
    """One epoch of the port's Trainer (geometry_aware, f=4, 32x32, f32,
    TF32 off) on the card and on the CPU from the same weights and
    batches: the epoch's loss and the validation metrics at rtol 1e-3
    (f32 sums in other orders, then Adam's sign amplification of
    near-zero gradient entries over 3 steps), pcl_max_rot at rtol 1e-2
    (the PCL heads start at a zero kernel, so Adam's first updates move
    each entry by +-lr whatever the size of its gradient: 5e-3 apart on
    an H100); the card's steps launch the two-pass warp's kernels."""
    from cadepth_tpu_torch.config import config_from_dict
    from cadepth_tpu_torch.training.trainer import Trainer

    _need_card()
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    manifest = generate_synthetic_dataset(str(tmp_path / "ds"),
                                          images_per_sensor=3, seed=5)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = config_from_dict({
            "experiment": {"name": f"card_{dev}", "seed": 1},
            "data": {"data_dir": f"{tmp_path}/ds/sunrgbd",
                     "manifest_path": manifest, "input_height": 32,
                     "input_width": 32},
            "model": {"architecture": "geometry_aware",
                      "init_features": 4},
            "optimization": {"optimizer": "adam", "learning_rate": 1e-3,
                             "lr_scheduler": "none",
                             "lr_warmup_epochs": 0},
            "training": {"num_epochs": 1, "batch_size": 4,
                         "num_workers": 2, "use_amp": False},
            "checkpointing": {"checkpoint_dir": str(tmp_path / "ck")},
            "logging": {"log_dir": str(tmp_path / "logs"),
                        "tensorboard": {"enabled": False}},
        })
        tr = Trainer(cfg, device=dev)
        try:
            warp_mod.launches = warp_mod.bwd_launches = 0
            loss = tr.train_epoch(0)
            launched = (warp_mod.launches, warp_mod.bwd_launches)
            out[dev] = (loss, tr.validate(0), launched)
        finally:
            tr.close()
    (cl, cm, _), (gl, gm, launched) = out["cpu"], out["cuda"]
    assert launched == (5 * 3, 15 * 3)
    assert gl == pytest.approx(cl, rel=1e-3), (gl, cl)
    for k in cm:
        rel = 1e-2 if k == "pcl_max_rot" else 1e-3
        assert gm[k] == pytest.approx(cm[k], rel=rel, abs=1e-6), \
            (k, gm[k], cm[k])


def _fixture_pack(tmp_path, augment: bool = True):
    """(12 synthetic scenes packed at 48x64, a train loader over them)."""
    from cadepth_tpu_torch.data.packed import (PackedSunRGBDLoader,
                                               pack_dataset)
    from cadepth_tpu_torch.data.sunrgbd import AugmentationConfig
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    manifest = generate_synthetic_dataset(
        str(tmp_path / "ds"), images_per_sensor=3, seed=11,
        sensor_specs={s: (64, 48, 64, 48)
                      for s in ("kv1", "kv2", "realsense", "xtion")})
    pack_dataset(f"{tmp_path}/ds/sunrgbd", manifest, str(tmp_path / "pack"),
                 48, 64, num_threads=4)
    loader = PackedSunRGBDLoader(str(tmp_path / "pack"), split="train",
                                 compute_rays=True, rays_on_device=True)
    if augment:
        loader.enable_augmentation(AugmentationConfig(random_seed=3))
    return loader


_STORAGES = {"float32": {},
             "bfloat16": {"rgb_dtype": torch.bfloat16},
             "quantized": {"rgb_dtype": torch.uint8,
                           "depth_dtype": torch.uint16}}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", list(_STORAGES))
def test_device_dataset_on_card_yields_the_cpu_batches(tmp_path, storage):
    """DeviceDataset on the card against the same class on the CPU: two
    epochs of batches, augmented and not, the remainder kept, equal bits
    (divisions by device tensors; no fused multiply-add across ops)."""
    from cadepth_tpu_torch.data.device_resident import DeviceDataset

    _need_card()
    loader = _fixture_pack(tmp_path)
    card = DeviceDataset(loader, device="cuda", **_STORAGES[storage])
    cpu = DeviceDataset(loader, device="cpu", **_STORAGES[storage])
    assert card.nbytes() == cpu.nbytes()
    for epoch in (0, 1):
        for augment in (False, True):
            args = dict(seed=2, epoch=epoch, augment=augment,
                        drop_remainder=False)
            got = list(card.batches(5, **args))
            want = list(cpu.batches(5, **args))
            assert len(got) == len(want) == 3
            for b, w in zip(got, want):
                assert b["rgb"].is_cuda
                for k in w:
                    assert torch.equal(b[k].cpu(), w[k]), (k, epoch,
                                                            augment)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", ["thread", "serial"])
@pytest.mark.parametrize("storage", ["float32", "quantized"])
def test_chunked_on_card_matches_resident(tmp_path, prefetch, storage):
    """Chunks copied on their own stream from pinned slots, the consumer's
    stream waiting on each chunk's event: every batch of two epochs,
    kept while later chunks restage the slots and other work allocates,
    equals the resident dataset's on the card; a sum taken on the
    consumer's stream as each batch arrives equals the resident one's."""
    from cadepth_tpu_torch.data.device_resident import (ChunkedDeviceDataset,
                                                        DeviceDataset)

    _need_card()
    loader = _fixture_pack(tmp_path)
    kw = _STORAGES[storage]
    resident = DeviceDataset(loader, device="cuda", **kw)
    chunked = ChunkedDeviceDataset(loader, 3, device="cuda", **kw)
    for epoch in (0, 1):
        args = dict(seed=5, epoch=epoch, augment=True)
        kept, sums = [], []
        for b in chunked.batches(2, prefetch=prefetch, **args):
            sums.append(b["rgb"].sum(dtype=torch.float64))
            kept.append(b)
            torch.empty(4 << 20, device="cuda").fill_(7.0)  # reuse bait
        want = list(resident.batches(2, **args))
        assert len(kept) == len(want) == 6
        for b, w, s in zip(kept, want, sums):
            for k in w:
                assert torch.equal(b[k], w[k]), (k, epoch)
            assert float(s) == float(w["rgb"].sum(dtype=torch.float64))


# the lightweight network's four decoder maps (f=32, 240x320) at batch 2:
# 32 to 256 channels, a 30x40 map at dec4
LIGHT_LEVELS = [(2, 240 >> k, 320 >> k, 32 << k) for k in (3, 2, 1, 0)]


@pytest.mark.cuda
def test_lightweight_levels_kernels_match_plain_on_card():
    """At the lightweight network's four levels, f32 and bf16, the PCL's
    own padding and align_corners: the forward, served and storing V,
    equals the plain version exactly; the backward is within
    ``test_backward_kernel_matches_plain_on_card``'s bounds."""
    _need_card()
    rng = np.random.default_rng(11)
    for shape in LIGHT_LEVELS:
        for name in ("identity", "rotation", "zoom_shift", "shear"):
            for dtype, atol in ATOL.items():
                x, theta, grad = _bwd_case(shape, name, dtype, rng)
                what = (shape, name, dtype)
                want, want_v = two_pass_affine_warp_plain_fwd(x, theta)
                served, _ = warp_mod._forward(x, theta, "zeros", False,
                                              keep_v=False)
                out, v = warp_mod._forward(x, theta, "zeros", False,
                                           keep_v=True)
                for got, ref in ((served, want), (out, want), (v, want_v)):
                    err = (got.float() - ref.float()).abs().max().item()
                    assert err == 0.0, (what, err)
                got = warp_mod.two_pass_warp_bwd(x, v, theta, grad)
                ref = two_pass_affine_warp_plain_bwd(x, want_v, theta, grad)
                scale = max(1.0, ref[0].float().abs().max().item())
                err = (got[0].float() - ref[0].float()).abs().max().item()
                assert err <= atol * scale, (what, err)
                t_err = (got[1] - ref[1]).abs().max().item()
                t_atol = 1e-5 if dtype == torch.float32 else 1e-3
                assert t_err <= t_atol * (ref[1].abs().max().item() + 1e-12), \
                    (what, t_err)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["two_pass", "fused"])
def test_exported_program_on_card_equals_predict(tmp_path, mode):
    """A small f32 flagship's exported program on the card gives
    ``predict``'s depths (the same kernels run: atol 1e-6 m) and launches
    the warp's forward kernel once per PCL."""
    from cadepth_tpu_torch.inference import load_exported

    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 8,
                  "pcl_warp": mode},
        "data": {"input_height": 64, "input_width": 96},
        "training": {"use_amp": False}})
    pred = Predictor(cfg, batch_size=2, device="cuda",
                     generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, p in pred.model.named_parameters():
            if name.endswith("fc_transform.bias"):
                p.copy_(torch.tensor([1.04, 0.95, 0.03, -0.02, 0.04, 0.03]))
    path = tmp_path / "program.pt2"
    assert pred.export(str(path)) > 0
    fn = load_exported(str(path))
    rng = np.random.default_rng(2)
    batch = _train_batch(rng, 2, 64, 96)
    want = pred.predict(batch["rgb"], batch["intrinsics"])
    ops = warp_mod if mode == "two_pass" else fw
    ops.launches = ops.v_stores = 0
    got = fn({k: batch[k] for k in ("rgb", "intrinsics", "k4")})
    torch.cuda.synchronize()
    assert ops.launches == 5 * ops.LAUNCHES_PER_CALL and ops.v_stores == 0
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=1e-6)


@pytest.mark.cuda
def test_compiled_memory_analysis_on_card():
    """The allocator's account of one eval-mode forward of a small f32
    flagship at batch 4: JAX's keys, arguments counted exactly
    (parameters, buffers, the three inputs), the output's bytes, a
    positive temporary peak, and the estimate beside it finite."""
    from cadepth_tpu_torch.models import factory

    _need_card()
    model = factory.create_model("geometry_aware", init_features=8,
                                 dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(12)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(rng, 4, 64, 96).items()}
    batch["rays"] = batch["rgb"]
    out = factory.compiled_memory_analysis(model, batch, "geometry_aware")
    mb = 1.0 / 2**20
    args = sum(t.nbytes for t in model.parameters()) + \
        sum(t.nbytes for t in model.buffers()) + \
        sum(batch[k].nbytes for k in ("rgb", "rays", "k4"))
    assert set(out) == {"argument_mb", "output_mb", "temp_mb", "total_mb"}
    assert out["argument_mb"] == pytest.approx(args * mb)
    assert out["output_mb"] == pytest.approx(4 * 64 * 96 * 4 * mb)
    assert out["temp_mb"] > 0
    assert out["total_mb"] == pytest.approx(
        out["argument_mb"] + out["output_mb"] + out["temp_mb"])
    assert model.training
    assert 0 < factory.estimate_memory_mb(model, 4, 64, 96, 8) < 1e6


# the production configuration's five decoder maps (f=96, 480x640) at
# batch 1: the kernels' plan reads W and C alone, so a batch of one runs
# every level's plan (C/4 channels a block in bf16, C/8 in f32)
PRODUCTION_LEVELS = [(1, 2 * (480 >> k), 2 * (640 >> k), 96 << (k - 1))
                     for k in (5, 4, 3, 2, 1)]


@pytest.mark.cuda
def test_production_levels_kernels_match_plain_on_card():
    """At the production maps, f32 and bf16: the forward, served and
    storing V, equals the plain version exactly; the backward is within
    ``test_backward_kernel_matches_plain_on_card``'s bounds; the plan
    gives 30,720 bytes of shared memory a block at every level."""
    _need_card()
    rng = np.random.default_rng(14)
    for shape in PRODUCTION_LEVELS:
        for dtype, atol in ATOL.items():
            chunk, smem = warp_mod.fwd_plan(shape[2], shape[3], dtype)
            assert smem == 30720, (shape, dtype, chunk)
            for name in ("identity", "rotation", "zoom_shift"):
                x, theta, grad = _bwd_case(shape, name, dtype, rng)
                what = (shape, name, dtype)
                want, want_v = two_pass_affine_warp_plain_fwd(x, theta)
                served, _ = warp_mod._forward(x, theta, "zeros", False,
                                              keep_v=False)
                out, v = warp_mod._forward(x, theta, "zeros", False,
                                           keep_v=True)
                for got, ref in ((served, want), (out, want), (v, want_v)):
                    err = (got.float() - ref.float()).abs().max().item()
                    assert err == 0.0, (what, err)
                got = warp_mod.two_pass_warp_bwd(x, v, theta, grad)
                ref = two_pass_affine_warp_plain_bwd(x, want_v, theta, grad)
                scale = max(1.0, ref[0].float().abs().max().item())
                err = (got[0].float() - ref[0].float()).abs().max().item()
                assert err <= atol * scale, (what, err)
                t_err = (got[1] - ref[1]).abs().max().item()
                t_atol = 1e-5 if dtype == torch.float32 else 1e-3
                assert t_err <= t_atol * (ref[1].abs().max().item() + 1e-12), \
                    (what, t_err)


@pytest.mark.cuda
def test_capacity_check_on_card():
    """The capacity check at batch 1 (the production model): the
    record's fields, a peak above the parameters, gradients and AdamW's
    moments, the card's own total memory, the pack's quarter added, and
    the allocations at the traced step's peak."""
    from cadepth_tpu_torch.cli import capacity_check

    _need_card()
    record = capacity_check.run(batch=1, cards=4, log=lambda *a: None)
    gb = 1.0 / 2**30
    state = record["parameters"] * 4 * 4 * gb
    step = record["step"]
    assert step["peak_allocated_gb"] > state
    assert step["peak_reserved_gb"] >= step["peak_allocated_gb"]
    total = torch.cuda.get_device_properties(0).total_memory * gb
    assert step["card_total_gb"] == pytest.approx(total)
    pack = capacity_check.resident_pack(4)["per_card_bytes"] * gb
    assert record["per_card_total_gb"] == pytest.approx(
        step["peak_allocated_gb"] + pack)
    assert record["fits"] == (record["per_card_total_gb"] < total)
    assert all(np.isfinite(record["losses"]))
    top = record["top_at_peak"]
    assert 0 < len(top) <= capacity_check.TOP
    assert top[0]["bytes"] >= top[-1]["bytes"]
    assert record["peak_trace"]["peak_bytes"] >= \
        record["peak_trace"]["before_bytes"]


# The six training norm map shapes of each training cell: the flagship
# (f=64, 240x320) at batch 32, the production network (f=96, 480x640) at
# batch 8; four calls a step at each of the first five (two in an encoder
# block, two in its decoder block), two at the bottleneck's.
BN_MAPS = ([(32, 64 << k, 240 >> k, 320 >> k) for k in range(5)]
           + [(32, 2048, 7, 10)]
           + [(8, 96 << k, 480 >> k, 640 >> k) for k in range(5)]
           + [(8, 3072, 15, 20)])


def _card_map(shape, dtype, seed, offset):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 1.5 + offset
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _bn_state(c, dtype=torch.float32, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand(c, generator=g, device="cuda").to(dtype) + 0.5,
            torch.randn(c, generator=g, device="cuda").to(dtype) * 0.3,
            torch.randn(c, generator=g, device="cuda").to(dtype) * 0.1,
            torch.rand(c, generator=g, device="cuda").to(dtype) + 0.5,
            torch.zeros((), dtype=torch.long, device="cuda"))


def _bn_kernels(x, dy, w, b, rm, rv, tracked):
    y, stats = bnk._forward_card(x, w, b, rm, rv, tracked, 1e-5, 0.01, True,
                                 None, x.dtype)
    return (y, stats) + bnk._backward_card(x, dy, w, stats, None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [(s, torch.bfloat16) for s in BN_MAPS]
                         + [((8, 192, 60, 80), torch.float32)])
def test_batch_norm_kernels_against_plain_and_float64_on_card(shape, dtype):
    """The kernels at the training cells' norm maps (and a float32 map):
    y, the running statistics, dx, dweight and dbias each no further
    from a float64 evaluation of the same formula than the plain version
    on the card is, plus one bf16 ulp of each element (the two round
    their float32 values to bf16 apart where those lie about a rounding
    boundary), that ulp taken at no less than 2^-12 of the largest
    element: an element near 0 is a difference of terms of the largest
    one's size, whose float32 round-off (a few float32 ulps of those
    terms, and the two sides' statistics differ by their summation
    order) exceeds a bf16 ulp of the element itself; one call each
    way."""
    _need_card()
    c = shape[1]
    x = _card_map(shape, dtype, 0, 2.0)
    dy = _card_map(shape, dtype, 1, 0.0) * 0.01
    w, b, rm, rv, tracked = _bn_state(c)
    before = (bnk.launches, bnk.bwd_launches)
    kernel = _bn_kernels(x, dy, w, b, rm, rv, tracked)
    assert (bnk.launches, bnk.bwd_launches) == (before[0] + 1, before[1] + 1)
    w, b, rm_p, rv_p, tracked_p = _bn_state(c)
    y_p, stats_p = bnk.forward_plain(x, w, b, rm_p, rv_p, tracked_p, 1e-5,
                                     0.01, True)
    plain = (y_p, stats_p) + bnk.backward_plain(x, dy, w, stats_p)
    w64, b64, rm_r, rv_r, tracked_r = _bn_state(c, torch.float64)
    y_r, stats_r = bnk.forward_plain(x.double(), w64, b64, rm_r, rv_r,
                                     tracked_r, 1e-5, 0.01, True)
    exact = (y_r, stats_r) + bnk.backward_plain(x.double(), dy.double(), w64,
                                                stats_r)
    assert int(tracked) == int(tracked_p) == 1
    outputs = {"y": (kernel[0], plain[0], exact[0]),
               "running statistics": tuple(torch.stack(t) for t in (
                   (rm, rv), (rm_p, rv_p), (rm_r, rv_r)))}
    for i, name in enumerate(("dx", "dweight", "dbias"), 2):
        outputs[name] = (kernel[i], plain[i], exact[i])
    for name, (k, p, r) in outputs.items():
        assert k.dtype == p.dtype, name
        err_k = (k.double() - r).abs()
        err_p = (p.double() - r).abs()
        ulp = bf16_ulp(r.abs().clamp_min(r.abs().max() * 2.0 ** -12))
        assert (err_k <= err_p + ulp.double()).all(), \
            (name, err_k.max().item(), err_p.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [BN_MAPS[0], BN_MAPS[6], BN_MAPS[11]])
def test_batch_norm_kernels_repeat_bit_for_bit(shape):
    """Two runs of the kernels from the same state give the same bits:
    the partial sums' order is the plan's, with no atomics."""
    _need_card()
    x = _card_map(shape, torch.bfloat16, 2, 2.0)
    dy = _card_map(shape, torch.bfloat16, 3, 0.0) * 0.01
    runs = []
    for _ in range(2):
        w, b, rm, rv, tracked = _bn_state(shape[1])
        runs.append(_bn_kernels(x, dy, w, b, rm, rv, tracked) + (rm, rv))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_batch_norm_kernels_refuse_what_they_do_not_take():
    """An NCHW-contiguous map, a 2-D input and a float16 map raise before
    any launch."""
    _need_card()
    w, b, rm, rv, tracked = _bn_state(16)
    before = bnk.launches
    nchw = torch.randn(2, 16, 4, 5, device="cuda")
    for x, match in ((nchw, "channels_last"),
                     (torch.randn(4, 16, device="cuda"), "2-D"),
                     (_card_map((2, 16, 4, 5), torch.float16, 0, 0.0),
                      "bf16 or float32")):
        with pytest.raises(ValueError, match=match):
            bnk.batch_norm_train(x, w, b, rm, rv, tracked, 1e-5, 0.01)
    assert bnk.launches == before and int(tracked) == 0


@pytest.mark.cuda
def test_flagship_step_runs_every_training_norm_through_the_kernels():
    """One flagship training step (f=64, 240x320, bf16) at batch 2 under a
    profiler: 22 forward and 22 backward calls of the kernels, and every
    ``norm.fwd`` span carries ``kernel`` 1 (no map reached them other
    than channels_last, which they would refuse)."""
    from torch.profiler import ProfilerActivity, profile

    from cadepth_tpu_torch.utils import profiling

    _need_card()
    cfg = config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 64},
        "data": {"input_height": 240, "input_width": 320},
        "training": {"use_amp": True, "batch_size": 2}})
    model, loss_fn = ts.build_model_and_loss(
        cfg, device="cuda", generator=torch.Generator().manual_seed(5))
    opt = ts.build_optimizer(cfg.optimization, model.parameters())
    step = ts.make_train_step(cfg, model, loss_fn, opt,
                              build_lr_schedule(cfg.optimization, 10, 5))
    batch = {k: torch.from_numpy(a).cuda() for k, a in
             _train_batch(np.random.default_rng(7), 2, 240, 320).items()}
    step(batch)
    bnk.launches = bnk.bwd_launches = 0
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        logs = step(batch)
        torch.cuda.synchronize()
    assert np.isfinite(float(logs["total_loss"]))
    assert (bnk.launches, bnk.bwd_launches) == (22, 22)
    fwd = [s for s in profiling.recorded_spans() if s["name"] == "norm.fwd"]
    assert len(fwd) == 22
    assert all(s["attrs"].get("kernel") == 1 for s in fwd)


@pytest.mark.cuda
def test_batch_norm_two_gloo_ranks_on_card_match_one_process(tmp_path):
    """Two processes on the card over Gloo (CUDA tensors), each with half
    the batch under ``dp``: the statistics all-reduced between the
    forward's kernels and the gradient sums between the backward's,
    against one process with the whole batch on the card (the tolerances
    of ``check_ranks``)."""
    _need_card()
    ranks, one = ranks_against_one_process(tmp_path, "cuda", torch.bfloat16,
                                           (4, 64, 24, 32))
    check_ranks(ranks, one, torch.bfloat16)


@pytest.mark.cuda
def test_depth_anything_on_card_matches_the_reference_and_the_cpu():
    """The tiny DA-V2 (4 blocks, width 64, 4 heads, DPT features 32) at
    28x42: in float32 on the card (TF32 off) against the plain reference
    and against itself on the CPU, depth within 1e-4 relative (SDPA's
    fused softmax and cuDNN's convolutions against the materialised
    ones), and its gradients through a mean within 1e-3 of the largest
    entry of each leaf."""
    _need_card()
    from reference_dav2 import DepthAnythingV2Ref

    from cadepth_tpu_torch.models import factory
    from cadepth_tpu_torch.models.dpt import DepthAnythingV2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = dict(embed_dim=64, depth=4, num_heads=4, taps=(0, 1, 2, 3),
                features=32, out_channels=(32, 64, 64, 64), max_depth=20.0)
    cpu = DepthAnythingV2(dtype=torch.float32, **tiny)
    factory.init_weights(cpu, torch.Generator().manual_seed(5))
    card = DepthAnythingV2(dtype=torch.float32, **tiny).cuda()
    card.load_state_dict(cpu.state_dict())
    ref = DepthAnythingV2Ref(**tiny).cuda()
    ref.load_state_dict(cpu.state_dict())
    rgb = torch.rand(2, 28, 42, 3, generator=torch.Generator().manual_seed(6))
    got = card(rgb.cuda())
    want = ref(rgb.cuda())
    here = cpu(rgb)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.cpu(), here, rtol=1e-4, atol=0.0)
    got.mean().backward()
    want.mean().backward()
    mine = dict(card.named_parameters())
    for name, p in ref.named_parameters():
        if p.grad is None:
            continue
        err = (mine[name].grad - p.grad).abs().max() / \
            p.grad.abs().max().clamp_min(1e-30)
        assert float(err) < 1e-3, name
