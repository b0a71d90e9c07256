"""The seeded generators repeat for a seed and differ between seeds."""

import numpy as np
import torch

from benchmark.core.weights import layout, seeded_state
from benchmark.drivers.serve import Requests
from benchmark.reference import feed
from benchmark.traffic.scenes import structured_scenes

SEED = 2 ** 31 + 977          # more than 32 signed bits hold


def test_scenes_repeat_for_a_seed(cpu):
    a = structured_scenes(3, 24, 32, SEED, cpu)
    b = structured_scenes(3, 24, 32, SEED, cpu)
    c = structured_scenes(3, 24, 32, SEED + 1, cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["rgb"], c["rgb"])
    # 8-bit rgb, whole millimetres, a few holes, depth within the scene's
    rgb, depth = a["rgb"], a["depth"]
    assert torch.equal(torch.round(rgb * 255.0) / 255.0, rgb)
    mm = depth * 1000.0
    assert torch.allclose(mm, torch.round(mm), atol=1e-3)
    assert float(depth.max()) <= 8.5 and float(depth[depth > 0].min()) >= 0.8


def test_requests_and_weights_repeat_for_a_seed(cpu):
    mix = {"batch": 2, "pool_scenes": 4}
    a, b = Requests(mix, 24, 32, SEED, cpu), Requests(mix, 24, 32, SEED, cpu)
    for i in (0, 1, 5):
        ra, rb = a.make(i), b.make(i)
        assert np.array_equal(ra["rgb"], rb["rgb"])
        assert np.array_equal(ra["k"], rb["k"])
    assert not np.array_equal(a.make(0)["rgb"], a.make(1)["rgb"])
    # the pool cycles, and each frame's K is its scene's sensor's
    assert np.array_equal(a.make(0)["k"], a.make(2)["k"])
    scenes = structured_scenes(4, 24, 32, SEED, cpu)
    ks = {tuple(k.ravel()) for k in scenes["k"].numpy()}
    assert all(tuple(k.ravel()) in ks for i in range(2)
               for k in a.make(i)["k"])
    wa = seeded_state(layout(4), SEED, cpu)
    wb = seeded_state(layout(4), SEED, cpu)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_feed_draws_repeat_for_a_seed():
    aug = {"crop_scale_min": 0.6, "crop_scale_max": 1.0,
           "brightness": 0.2, "contrast": 0.2}
    d = feed.epoch_draws(SEED, 3, 16, aug)
    assert np.array_equal(d, feed.epoch_draws(SEED, 3, 16, aug))
    assert not np.array_equal(d, feed.epoch_draws(SEED, 4, 16, aug))
    assert np.array_equal(feed.epoch_order(SEED, 0, 16),
                          feed.epoch_order(SEED, 0, 16))
