"""The Depth Anything V2 and data-parallel training cells on the CPU at
tiny sizes: their FLOP and attention counts against hand counts, the
DA-V2 driver end to end in one process, and the data-parallel driver
with four Gloo ranks (its start-up, the agreed window and the reference
over four shards), each port in float32, so a sound run's numbers sit at
round-off."""

import copy
import time
from pathlib import Path

import pytest

from benchmark.core import manifest
from benchmark.metrics.lib.attention_flops import (attention_flops,
                                                   dav2_step_flops)

ROOT = Path(__file__).resolve().parents[2]
TINY_VIT = dict(embed_dim=64, depth=4, num_heads=4, taps=[0, 1, 2, 3],
                features=32, out_channels=[32, 64, 64, 64])


def test_attention_flops_by_hand():
    # one layer, B=1, one head of 2 over 3 tokens: q k^T 2*3*3*2 = 36, p v
    # the same, forward 72; backward twice that
    assert attention_flops(1, 3, 1, 2, 1, train=False) == 72.0
    assert attention_flops(1, 3, 1, 2, 1) == 216.0
    conf = manifest.config("dav2_vitl_518x686")
    # batch 8, 1 + 37 * 49 tokens, 16 heads of 64, 24 layers
    want = 24 * 12.0 * 8 * 16 * 1814 ** 2 * 64
    assert dav2_step_flops(conf) == want
    # an image's forward: 0.323 TFLOP
    assert want / 8 / 3 == pytest.approx(0.3234e12, rel=1e-3)


def _dav2_tiny():
    cell = manifest.cell("dav2_vitl_train_b8")
    conf = copy.deepcopy(manifest.config(cell["config"]))
    c = conf["config"]
    c["data"]["input_height"], c["data"]["input_width"] = 28, 42
    c["training"]["batch_size"] = 2
    c["training"]["use_amp"] = False
    c["logging"]["tensorboard"]["enabled"] = False
    conf["reference"].update(TINY_VIT)
    conf["scenes"], conf["store_rows"] = 4, 12
    cell["mix"].update(warmup_steps=2)
    return cell, conf


def test_dav2_flops_cover_the_encoders_matmuls_and_scale_with_batch():
    from benchmark.metrics.lib.dav2_flops import model_flops

    _, conf = _dav2_tiny()
    conf["reference"].update(embed_dim=8, num_heads=1)
    one = model_flops(conf, 1)
    assert model_flops(conf, 2) == pytest.approx(2 * one, rel=1e-9)
    # 4 blocks at 7 tokens, width 8: qkv 2*7*8*24, attention 4*7*7*8,
    # proj 2*7*8*8, MLP 2*2*7*8*32; the patch conv 2*6*8*588; forward and
    # backward at least twice again (the head comes on top)
    encoder = 4 * (2 * 7 * 8 * 24 + 4 * 49 * 8 + 2 * 7 * 8 * 8
                   + 4 * 7 * 8 * 32) + 2 * 6 * 8 * 588
    assert one > 3 * encoder


def test_dav2_driver_runs_and_agrees_in_float32(monkeypatch, cpu):
    from benchmark.drivers import train_dav2
    from cadepth_tpu_torch.models import factory

    cell, conf = _dav2_tiny()
    tiny = {k: tuple(v) if isinstance(v, list) else v
            for k, v in TINY_VIT.items()}
    monkeypatch.setitem(factory.DAV2_VARIANTS, "vitl", tiny)
    out = train_dav2.run(cell, conf, 2 ** 31 + 17, 1.0, False, cpu,
                         time.perf_counter())
    assert out["attempted"] > 0 and out["failed"] == 0
    n = out["numbers"]
    assert n["depth_dev_first"] < 1e-4 and n["loss_gap"] < 1e-5
    assert n["update_gap_median"] < 1e-3


def test_dav2_driver_exits_cleanly_on_a_port_without_the_network(
        monkeypatch, cpu):
    from benchmark.drivers import train_dav2
    from cadepth_tpu_torch.models import factory

    cell, conf = _dav2_tiny()
    monkeypatch.setattr(factory, "ARCHITECTURES", factory.ARCHITECTURES[:5])
    with pytest.raises(SystemExit) as stop:
        train_dav2.run(cell, conf, 1, 1.0, False, cpu, time.perf_counter())
    assert stop.value.code == 2


def test_dp_driver_four_gloo_ranks_agree_in_float32(cpu):
    from benchmark.drivers import train_dp

    cell, conf = _dp_tiny()
    out = train_dp.run(cell, conf, 2 ** 31 + 5, 1.0, False, cpu,
                       time.perf_counter())
    assert out["attempted"] > 0 and out["failed"] == 0
    n = out["numbers"]
    assert n["depth_dev_first"] < 1e-4 and n["loss_gap"] < 1e-5
    assert n["update_gap_median"] < 1e-3
    assert n["exchange_gap_first"] < 1e-6


def _dp_tiny():
    cell = manifest.cell("production_train_dp4")
    conf = copy.deepcopy(manifest.config(cell["config"]))
    c = conf["config"]
    c["model"]["init_features"] = 4
    c["data"]["input_height"], c["data"]["input_width"] = 32, 48
    c["training"]["batch_size"] = 2
    c["training"]["use_amp"] = False
    c["logging"]["tensorboard"]["enabled"] = False
    conf["scenes"], conf["store_rows"] = 8, 12
    cell["mix"].update(warmup_steps=2)
    return cell, conf


@pytest.mark.parametrize("workload", ["dav2_vitl_train_b8",
                                      "production_train_dp4"])
def test_control_readings_part_the_port_from_the_faults(monkeypatch, cpu,
                                                         workload):
    from benchmark import control_cells
    from cadepth_tpu_torch.models import factory

    if workload == "dav2_vitl_train_b8":
        cell, conf = _dav2_tiny()
        monkeypatch.setitem(factory.DAV2_VARIANTS, "vitl", {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in TINY_VIT.items()})
        faults = ["none", "half_batch"]
    else:
        cell, conf = _dp_tiny()
        faults = ["none", "half_batch", "drop_rank"]
    out = control_cells.readings(cell, conf, 7, faults, cpu)
    assert set(out) == set(faults)
    sound = out["none"]
    assert sound["loss_gap"] < 1e-5 and sound["update_gap_median"] < 1e-3
    for fault in faults[1:]:
        bad = out[fault]
        assert max(bad["loss_gap"], bad["update_gap_median"],
                   bad["grad_gap_median"]) > 100 * max(
            sound["loss_gap"], sound["update_gap_median"], 1e-7), fault
    if workload == "production_train_dp4":
        # the exchange between the ranks: one rank's gradient left out of
        # the all-reduce fails the cell's own limit
        limit = cell["limits"]["exchange_gap_first"]
        for fault in faults:
            assert (out[fault]["exchange_gap_first"] > limit) == (
                fault == "drop_rank"), fault
