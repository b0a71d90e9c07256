"""Depth Anything V2 (``depth_anything_v2``) on the CPU, at a tiny size
with the published structure: 4 blocks tapped at 0-3, width 64, 4
heads, patch 14, DPT features 32 with out_channels (32, 64, 64, 64), a
28x42 input (2 x 3 patches, a grid neither square nor the table's 37 x
37). Held:

- the port against the plain float32 reference (``reference_dav2.py``)
  on seeded random weights: depth, and every parameter's gradient
  through the repository's loss; the bf16 port inside a stated band;
- the position table's interpolation at the 2 x 3 grid;
- ``refinenet4.resConfUnit1``, built and unused as upstream's, gets no
  gradient, and the train step steps all the same;
- a ``Trainer`` epoch and a ``Predictor`` call through
  ``create_model('depth_anything_v2')`` (its ``vitl`` entry set to the
  tiny widths here), and the sizes both refuse;
- the encoder's, the attention's and the head's spans under a profiler;
- the benchmark's copy of the reference is this one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch.data.packed import pack_dataset
from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset
from cadepth_tpu_torch.inference import Predictor
from cadepth_tpu_torch.losses.depth_loss import CombinedDepthLoss
from cadepth_tpu_torch.models import factory
from cadepth_tpu_torch.models.dpt import DepthAnythingV2
from cadepth_tpu_torch.training import trainer as p_trainer
from cadepth_tpu_torch.utils import profiling

from reference_dav2 import DepthAnythingV2Ref, position_table

H, W = 28, 42
BATCH = 2
TINY = dict(embed_dim=64, depth=4, num_heads=4, taps=(0, 1, 2, 3),
            features=32, out_channels=(32, 64, 64, 64))
# f32 port against f32 reference: the same operations, SDPA's fused
# softmax against the materialised one and the LayerNorm's fused
# statistics, so depths of ~10 m agree to a few 1e-6 m
DEPTH_RTOL = 1e-5
# gradients through the loss: the same, summed over 2 x 28 x 42 pixels
# and 7 tokens in other orders; relative to each leaf's largest entry
GRAD_RTOL = 1e-4
# bf16 port against the f32 reference, ||d - r|| / ||r - mean(r)|| a
# frame: bf16 keeps 8 bits, so each of the ~40 products on the path
# rounds its operands by up to 2^-9; their errors add over 4 blocks and
# the head's convs to a few percent of the depths' own variation
# (1.0-2.6 % on seeds 0-5; the limit is twice the largest)
BF16_DEV = 0.05

torch.set_num_threads(2)


def _models(seed: int, dtype=torch.float32):
    port = DepthAnythingV2(max_depth=20.0, dtype=dtype, **TINY)
    factory.init_weights(port, torch.Generator().manual_seed(seed))
    ref = DepthAnythingV2Ref(max_depth=20.0, **TINY)
    ref.load_state_dict(port.state_dict())
    return port, ref


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    k = torch.eye(3).repeat(BATCH, 1, 1)
    k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2] = 40.0, 40.0, 21.0, 14.0
    return {"rgb": torch.rand(BATCH, H, W, 3, generator=g),
            "depth": 0.5 + 8.0 * torch.rand(BATCH, H, W, 1, generator=g),
            "intrinsics": k}


def _loss(pred, b):
    total, _ = CombinedDepthLoss()(pred, b["depth"], b["rgb"],
                                   b["intrinsics"], b["depth"] > 0.1)
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference_forward_and_gradient(seed):
    port, ref = _models(seed)
    b = _batch(seed)
    got, want = port(b["rgb"]), ref(b["rgb"])
    assert got.shape == (BATCH, H, W, 1) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=DEPTH_RTOL, atol=0.0)
    _loss(got, b).backward()
    _loss(want, b).backward()
    grads = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        mine = grads[name].grad
        if p.grad is None:
            assert mine is None, name
            continue
        scale = p.grad.abs().max().clamp_min(1e-30)
        err = (mine - p.grad).abs().max() / scale
        assert err < GRAD_RTOL, (name, float(err))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_port_within_its_band(seed):
    port, ref = _models(seed, torch.bfloat16)
    rgb = _batch(seed)["rgb"]
    with torch.no_grad():
        got, want = port(rgb), ref(rgb)
    flat_g, flat_w = got.reshape(BATCH, -1), want.reshape(BATCH, -1)
    spread = (flat_w - flat_w.mean(1, keepdim=True)).norm(dim=1)
    dev = (flat_g - flat_w).norm(dim=1) / spread
    assert torch.isfinite(got).all() and float(dev.max()) < BF16_DEV, dev


def test_position_table_is_interpolated_at_a_grid_of_its_own():
    port, ref = _models(2)
    vit = port.pretrained
    with torch.no_grad():
        table = vit.interpolate_pos_encoding(2, 3)
        assert table.shape == (1, 1 + 2 * 3, 64)
        torch.testing.assert_close(table, position_table(vit.pos_embed, 2, 3),
                                   rtol=0.0, atol=0.0)
        # the cls entry unchanged; the 37 x 37 grid is the table itself
        torch.testing.assert_close(table[:, 0], vit.pos_embed[:, 0])
        torch.testing.assert_close(vit.interpolate_pos_encoding(37, 37),
                                   vit.pos_embed)
        # bicubic weights sum to one: a constant table stays constant,
        # at the 518 x 686 cell's 37 x 49 grid too
        vit.pos_embed.fill_(0.25)
        for h, w in ((2, 3), (37, 49)):
            out = vit.interpolate_pos_encoding(h, w)
            assert out.shape == (1, 1 + h * w, 64)
            torch.testing.assert_close(out, torch.full_like(out, 0.25))


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A Trainer of ``create_model('depth_anything_v2')`` at the tiny
    widths over 4 synthetic scenes packed at 28x42, held on the CPU."""
    root = tmp_path_factory.mktemp("torch_dav2")
    manifest = generate_synthetic_dataset(str(root), images_per_sensor=1,
                                          seed=4)
    pack_dataset(f"{root}/sunrgbd", manifest, str(root / "pack"), H, W,
                 num_threads=2)
    cfg = port_config.config_from_dict({
        "experiment": {"name": "dav2", "seed": 3},
        "data": {"packed_dir": str(root / "pack"), "device_resident": True,
                 "input_height": H, "input_width": W},
        "model": {"architecture": "depth_anything_v2", "variant": "vitl",
                  "max_depth": 20.0},
        "optimization": {"optimizer": "adamw", "learning_rate": 1e-3,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0,
                         "weight_decay": 1e-2},
        "training": {"num_epochs": 1, "batch_size": BATCH,
                     "log_interval": 1, "use_amp": False},
        "checkpointing": {"checkpoint_dir": str(root / "ckpts")},
        "logging": {"log_dir": str(root / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    })
    mp = pytest.MonkeyPatch()
    mp.setitem(factory.DAV2_VARIANTS, "vitl", TINY)
    tr = p_trainer.Trainer(cfg, device="cpu")
    yield tr
    tr.close()
    mp.undo()


def test_unused_fusion_unit_gets_no_gradient_and_the_step_steps(trainer):
    model = trainer.model
    assert isinstance(model, DepthAnythingV2)
    unit = model.depth_head.scratch.refinenet4.resConfUnit1
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = next(iter(trainer.train_pipe))
    logs = trainer.train_step(batch)
    assert np.isfinite(float(logs["total_loss"]))
    for p in unit.parameters():
        assert p.grad is not None and not p.grad.any()
    unused = {id(p) for p in unit.parameters()}
    for n, p in model.named_parameters():
        if id(p) in unused:
            # AdamW's decay alone moves them (a zero gradient's update is 0)
            torch.testing.assert_close(p.detach(),
                                       before[n] * (1.0 - 1e-3 * 1e-2))
        else:
            assert not torch.equal(p.detach(), before[n]), n


def test_trainer_epoch_and_predictor(trainer):
    loss = trainer.train_epoch(1)
    assert np.isfinite(loss)
    metrics = trainer.validate(1)
    assert np.isfinite(metrics["abs_rel"])
    pred = Predictor(trainer.cfg, state_dict=trainer.model.state_dict(),
                     batch_size=BATCH, device="cpu")
    rgb = np.random.default_rng(0).random((1, H, W, 3), dtype=np.float32)
    depth = pred.predict(rgb)
    assert depth.shape == (1, H, W, 1)
    assert np.isfinite(depth).all() and (depth > 0).all() and \
        (depth < 20.0).all()


@pytest.mark.parametrize("h,w", [(28, 40), (30, 42)])
def test_sizes_off_the_patch_grid_are_refused(trainer, h, w):
    with pytest.raises(ValueError, match="multiples of 14"):
        Predictor(trainer.cfg, state_dict=trainer.model.state_dict(),
                  height=h, width=w, device="cpu")
    with pytest.raises(ValueError, match="multiples of 14"):
        trainer.model(torch.zeros(1, h, w, 3))


def test_spans_of_encoder_attention_and_head(trainer):
    profiling.clear_spans()
    batch = next(iter(trainer.train_pipe))
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(batch)
    spans = profiling.recorded_spans()
    names = [s["name"] for s in spans]
    depth = len(trainer.model.pretrained.blocks)
    for name, count in (("vit.encoder", 1), ("vit.encoder.bwd", 1),
                        ("attn.fwd", depth), ("attn.bwd", depth),
                        ("dpt.head", 1), ("dpt.head.bwd", 1)):
        assert names.count(name) == count, (name, names)
    by_id = {s["id"]: s for s in spans}
    step = next(s for s in spans if s["name"] == "train.step")
    for s in spans:
        if s["name"] == "attn.fwd":
            assert by_id[s["parent"]]["name"] == "vit.encoder"
            assert s["attrs"] == {"tokens": 1 + (H // 14) * (W // 14),
                                  "heads": 4}
        assert s["trace"] == step["trace"], s
    # the head's backward ends before the encoder's begins
    head_bwd = next(s for s in spans if s["name"] == "dpt.head.bwd")
    enc_bwd = next(s for s in spans if s["name"] == "vit.encoder.bwd")
    assert head_bwd["end_ns"] <= enc_bwd["start_ns"]
    profiling.clear_spans()


def test_the_benchmarks_copy_of_the_reference_is_this_one():
    here = Path(__file__).resolve().parent
    assert (here.parent / "benchmark" / "reference" / "dav2.py").read_text() \
        == (here / "reference_dav2.py").read_text()
