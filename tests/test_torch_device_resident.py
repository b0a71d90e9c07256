"""The port's GPU-resident feed (``cadepth_tpu_torch.data.device_resident``,
``device="cpu"``) against the JAX package's and within itself, on a pack
of 12 synthetic samples at 48x64.

Against JAX: non-augmented batches in the three storages, the epoch order,
``_augment_one`` given the draws JAX makes for its keys, and the host cv2
oracle of ``tests/test_device_resident.py``. Within the port: the draws as
a pure function of (seed, epoch, row), the chunked feed against the
resident one bit for bit, the trimmed tail, shared storage, the quantized
encodings, an abandoned consumer, slot reuse and the chunked feed's
overlap of uploads with compute."""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.data import device_resident as jdr
from cadepth_tpu.data import packed as j_packed
from cadepth_tpu.data import sunrgbd as j_sunrgbd
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu_torch.data import device_resident as pdr
from cadepth_tpu_torch.data import packed as p_packed
from cadepth_tpu_torch.data import sunrgbd as p_sunrgbd
from cadepth_tpu_torch.parallel import DataParallel

H, W = 48, 64
# the three storages: JAX's dtypes, the port's
STORAGES = {
    "float32": ({}, {}),
    "bfloat16": ({"rgb_dtype": jnp.bfloat16},
                 {"rgb_dtype": torch.bfloat16}),
    "quantized": ({"rgb_dtype": jnp.uint8, "depth_dtype": jnp.uint16},
                  {"rgb_dtype": torch.uint8, "depth_dtype": torch.uint16}),
}
QUANT = STORAGES["quantized"][1]


@pytest.fixture(scope="module")
def pack_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_devres")
    manifest = j_synthetic.generate_synthetic_dataset(
        str(root), images_per_sensor=3, seed=11,
        sensor_specs={s: (64, 48, 64, 48)
                      for s in ("kv1", "kv2", "realsense", "xtion")})
    out = root / "packed"
    j_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(out),
                          target_height=H, target_width=W, num_threads=4)
    return str(out)


def loaders(pack_dir, split="train", augment=True, **kw):
    args = dict(split=split, compute_rays=True, rays_on_device=True, **kw)
    jl = j_packed.PackedSunRGBDLoader(pack_dir, **args)
    pl = p_packed.PackedSunRGBDLoader(pack_dir, **args)
    if augment:
        jl.enable_augmentation(jl.aug_config)
        pl.enable_augmentation(pl.aug_config)
    return jl, pl


def port_ds(pack_dir, split="train", augment=True, **kw):
    _, pl = loaders(pack_dir, split, augment)
    return pl, pdr.DeviceDataset(pl, device="cpu", **kw)


def as_numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def assert_same(a, b, msg=""):
    assert set(a) == set(b), msg
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, msg)
        np.testing.assert_array_equal(x, y, err_msg=f"{k} {msg}")


# -- against JAX ---------------------------------------------------------------

@pytest.mark.parametrize("storage", list(STORAGES))
def test_batches_match_jax_gather_and_fast_batch(pack_dir, storage):
    """Non-augmented batches equal JAX's jitted gather and the port's
    fast_batch bit for bit; quantized depth equals fast_batch (the host's
    `mm / 1000.0`), and JAX's by 1 ulp: XLA rewrites JAX's divide by the
    constant 1000 into a multiply by f32(1/1000)."""
    jkw, pkw = STORAGES[storage]
    jl, pl = loaders(pack_dir, augment=False)
    jds = jdr.DeviceDataset(jl, **jkw)
    pds = pdr.DeviceDataset(pl, device="cpu", **pkw)
    assert pds.nbytes() == jds.nbytes()
    idx = [5, 2, 9, 0, 11, 7]
    got = as_numpy(pds._gather(idx))
    want = as_numpy(jds._gather(jnp.asarray(idx, jnp.int32), jnp.int32(0),
                                augment=False))
    host = pl.fast_batch(idx)
    if storage == "quantized":
        # the stored codes are JAX's
        np.testing.assert_array_equal(pds.rgb.numpy(), np.asarray(jds.rgb))
        np.testing.assert_array_equal(pds.depth.numpy().view(np.uint16),
                                      np.asarray(jds.depth))
        np.testing.assert_array_equal(got["depth"], host["depth"])
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=1.2e-7,
                                   atol=0)
        got.pop("depth"), want.pop("depth"), host.pop("depth")
    assert_same(got, want, storage)
    for k in ("intrinsics", "k4") + (("rgb", "depth")
                                     if storage == "float32" else ()):
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)


@pytest.mark.parametrize("drop_remainder,max_samples,batch", [
    (True, None, 4), (False, None, 5), (True, 9, 2), (False, 7, 3)])
def test_epoch_order_matches_jax(pack_dir, drop_remainder, max_samples,
                                 batch):
    """Two epochs of batches, shuffled by (seed, epoch), with and without
    the remainder and capped, equal JAX's; the tail comes out trimmed."""
    jl, pl = loaders(pack_dir, augment=False)
    jds, pds = jdr.DeviceDataset(jl), pdr.DeviceDataset(pl, device="cpu")
    for epoch in (0, 1):
        args = dict(shuffle=True, seed=3, epoch=epoch, augment=False,
                    drop_remainder=drop_remainder, max_samples=max_samples)
        want = [as_numpy(b) for b in jds.batches(batch, **args)]
        got = [as_numpy(b) for b in pds.batches(batch, **args)]
        assert len(got) == len(want) == pds.batches_per_epoch(
            batch, max_samples, drop_remainder)
        for a, b in zip(got, want):
            assert_same(a, b, f"epoch {epoch}")
    jp = jdr.DevicePipeline(jds, batch, shuffle=True, seed=4,
                            max_samples=max_samples,
                            drop_remainder=drop_remainder)
    pp = pdr.DevicePipeline(pds, batch, shuffle=True, seed=4,
                            max_samples=max_samples,
                            drop_remainder=drop_remainder)
    assert len(pp) == len(jp)
    for _ in range(2):
        for a, b in zip(pp, jp):
            assert_same(as_numpy(a), as_numpy(b))


def _configs():
    """(port, JAX) augmentation configs of the parity cases: the shipped
    one, a full-size crop (whose offset can be 1: the reference's quirk),
    jitter strong enough to clip at 0 and 1, and each part off."""
    cases = {
        "shipped": {},
        "full_size_crop": {"crop_scale_min": 1.0, "crop_scale_max": 1.0},
        "clipping_jitter": {"brightness_delta": 0.9, "contrast_delta": 0.9,
                            "random_seed": 5},
        "crop_only": {"enable_horizontal_flip": False,
                      "enable_color_jitter": False},
        "flip_and_jitter_only": {"enable_random_crop": False},
    }
    return {name: (p_sunrgbd.AugmentationConfig(**kw),
                   j_sunrgbd.AugmentationConfig(**kw))
            for name, kw in cases.items()}


def jax_draws(key, cfg):
    """The six values JAX's _augment_one draws from ``key``, made by the
    same jax.random calls on the same split keys (dr.py:177-210)."""
    ks = jax.random.split(key, 6)
    return np.array([
        jax.random.uniform(ks[0], (), jnp.float32, cfg.crop_scale_min,
                           cfg.crop_scale_max),
        jax.random.uniform(ks[1], ()),
        jax.random.uniform(ks[2], ()),
        jax.random.uniform(ks[3], ()),
        jax.random.uniform(ks[4], (), jnp.float32,
                           1.0 - cfg.brightness_delta,
                           1.0 + cfg.brightness_delta),
        jax.random.uniform(ks[5], (), jnp.float32,
                           1.0 - cfg.contrast_delta,
                           1.0 + cfg.contrast_delta)], np.float32)


def pack_rows(loader, idx):
    rows = [loader.sample_paths[i]["row"] for i in idx]
    return (np.asarray(loader._rgb[rows], np.float32),
            np.asarray(loader._depth[rows], np.float32),
            np.asarray(loader._intrinsics[rows], np.float32))


@pytest.mark.parametrize("case", list(_configs()))
def test_augment_matches_jax_augment_one(pack_dir, case):
    """The port's batched _augment_one against JAX's _augment_one (run op
    by op) on each of the 12 samples, given the draws JAX makes from its
    (seed, epoch, index) keys: depth and K exact, rgb within 1e-6 (XLA's
    CPU matrix product may fuse the tent's two terms into an FMA)."""
    pcfg, jcfg = _configs()[case]
    _, pl = loaders(pack_dir)
    idx = list(range(12))
    rgb, depth, k = pack_rows(pl, idx)
    base = jax.random.fold_in(jax.random.PRNGKey(jcfg.random_seed), 3)
    keys = [jax.random.fold_in(base, i) for i in idx]
    with jax.disable_jit():
        draws = np.stack([jax_draws(key, jcfg) for key in keys])
        want = [[np.asarray(o) for o in jdr._augment_one(
            jnp.asarray(rgb[j]), jnp.asarray(depth[j]), jnp.asarray(k[j]),
            keys[j], H, W, jcfg)] for j in range(len(idx))]
    got = pdr._augment_one(torch.from_numpy(rgb), torch.from_numpy(depth),
                           torch.from_numpy(k), torch.from_numpy(draws), H,
                           W, pcfg)
    got = [t.numpy() for t in got]
    want = [np.stack(w) for w in zip(*want)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # the cases reach what they are for
    if case == "shipped":
        flips = draws[:, 3] < jcfg.horizontal_flip_prob
        assert flips.any() and not flips.all()
    if case == "full_size_crop":
        assert (np.floor(draws[:, 1] * 2.0) == 1.0).any()  # offset 1
        assert (got[2][:, 0, 0] != k[:, 0, 0]).any()       # clamped crop
    if case == "clipping_jitter":
        lo = rgb * draws[:, 5, None, None, None] + \
            draws[:, 4, None, None, None] - 1.0
        assert (lo < 0).any() and (lo > 1).any()


def _reciprocal_taps(out_size, crop0, crop_len, flip):
    """The port's _axis_taps with the scale written as XLA compiles JAX's
    jitted ``crop_len / out_size``: a multiply by f32(1 / out_size)."""
    recip = torch.tensor(np.float32(1.0 / out_size))
    scale = (crop_len * recip)[:, None]
    dst = torch.arange(out_size, dtype=torch.float32)[None, :]
    top = (crop_len - 1.0)[:, None]
    flip = flip[:, None]
    u = torch.minimum(torch.clamp((dst + 0.5) * scale - 0.5, min=0.0), top)
    u = torch.where(flip, top - u, u) + crop0[:, None]
    lo = torch.floor(u)
    hi = torch.clamp(lo + 1.0, max=out_size - 1.0)
    n = torch.minimum(torch.floor(dst * scale), top)
    n = torch.where(flip, top - n, n) + crop0[:, None]
    return lo.long(), hi.long(), u - lo, n.long()


def test_augment_against_jax_jitted_gather(pack_dir, monkeypatch):
    """JAX's jitted gather (the path its DeviceDataset runs) against the
    port's _augment_one on the same draws. XLA rewrites the division by
    the constant ``out_size`` (dr.py:155) into a multiply by its f32
    reciprocal, which moves the positions by up to ~out_size ulps: rgb
    within 2e-5. With that rewrite restated in the port (a test-local
    _axis_taps), rgb is within 1e-6 and depth and K are exact: the
    rewrite is the whole difference."""
    jl, pl = loaders(pack_dir)
    jds = jdr.DeviceDataset(jl)
    cfg = jds.aug_config
    idx = list(range(12))
    rgb, depth, k = pack_rows(pl, idx)
    base = jax.random.fold_in(jax.random.PRNGKey(cfg.random_seed), 2)
    draws = torch.from_numpy(np.stack(
        [jax_draws(jax.random.fold_in(base, i), cfg) for i in idx]))
    want = as_numpy(jds._gather(jnp.asarray(idx, jnp.int32), jnp.int32(2),
                                augment=True))
    args = (torch.from_numpy(rgb), torch.from_numpy(depth),
            torch.from_numpy(k), draws, H, W, pl.aug_config)
    got = [t.numpy() for t in pdr._augment_one(*args)]
    np.testing.assert_allclose(got[0], want["rgb"], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[2], want["intrinsics"])
    monkeypatch.setattr(pdr, "_axis_taps", _reciprocal_taps)
    got = [t.numpy() for t in pdr._augment_one(*args)]
    np.testing.assert_allclose(got[0], want["rgb"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want["depth"])
    np.testing.assert_array_equal(got[2], want["intrinsics"])


def _host_oracle(rgb, depth, k, d, cfg):
    """Numpy/cv2 restatement of the host augment+resize tail, fed the
    draws ``d`` (tests/test_device_resident.py's oracle)."""
    import cv2

    scale, ucx, ucy, uflip, brightness, contrast = (float(v) for v in d)
    ch, cw = int(np.floor(H * scale)), int(np.floor(W * scale))
    ux = int(np.floor(ucx * (max(1, W - cw) + 1)))
    uy = int(np.floor(ucy * (max(1, H - ch) + 1)))
    flip = uflip < cfg.horizontal_flip_prob
    # host order: crop -> flip -> jitter -> resize back (sunrgbd.py)
    rgb = rgb[uy:uy + ch, ux:ux + cw]
    depth = depth[uy:uy + ch, ux:ux + cw]
    k = k.copy()
    k[0, 2] -= ux
    k[1, 2] -= uy
    if flip:
        rgb = np.ascontiguousarray(rgb[:, ::-1])
        depth = np.ascontiguousarray(depth[:, ::-1])
        k[0, 2] = rgb.shape[1] - k[0, 2] - 1
    rgb = np.clip(rgb * contrast + brightness - 1.0, 0.0, 1.0)
    sx, sy = W / rgb.shape[1], H / rgb.shape[0]
    rgb = cv2.resize(rgb, (W, H), interpolation=cv2.INTER_LINEAR)
    depth = cv2.resize(depth[..., 0], (W, H),
                       interpolation=cv2.INTER_NEAREST)[..., None]
    k[0, 0] *= sx
    k[1, 1] *= sy
    k[0, 2] *= sx
    k[1, 2] *= sy
    return rgb, depth, k


def test_augment_matches_host_oracle(pack_dir):
    """Augmented batches against the host's cv2 crop/flip/jitter/resize
    fed the same draws (the JAX test's bounds)."""
    pl, ds = port_ds(pack_dir)
    idx = list(range(12))
    rgb0, depth0, k0 = pack_rows(pl, idx)
    for epoch in (0, 3):
        got = as_numpy(ds._gather(idx, epoch, augment=True))
        draws = pdr.epoch_draws(ds.aug_config, epoch, len(ds))
        for j, i in enumerate(idx):
            rgb, depth, k = _host_oracle(rgb0[j], depth0[j], k0[j],
                                         draws[i], ds.aug_config)
            np.testing.assert_allclose(got["rgb"][j], rgb, atol=2e-5,
                                       rtol=0)
            np.testing.assert_array_equal(got["depth"][j], depth)
            np.testing.assert_allclose(got["intrinsics"][j], k, atol=1e-4,
                                       rtol=0)


# -- within the port -----------------------------------------------------------

def test_draws_are_a_pure_function_of_seed_epoch_and_row(pack_dir):
    cfg = p_sunrgbd.AugmentationConfig(random_seed=7)
    a = pdr.epoch_draws(cfg, 2, 40)
    np.testing.assert_array_equal(a[:12], pdr.epoch_draws(cfg, 2, 12))
    np.testing.assert_array_equal(a, pdr.epoch_draws(cfg, 2, 40))
    assert a.dtype == np.float32 and a.shape == (40, 6)
    assert not np.array_equal(a, pdr.epoch_draws(cfg, 3, 40))
    assert not np.array_equal(a, pdr.epoch_draws(
        dataclasses.replace(cfg, random_seed=8), 2, 40))
    # JAX's ranges
    assert (a[:, 0] >= np.float32(cfg.crop_scale_min)).all()
    assert (a[:, 0] < np.float32(cfg.crop_scale_max)).all()
    assert ((a[:, 1:4] >= 0) & (a[:, 1:4] < 1)).all()
    for col, delta in ((4, cfg.brightness_delta), (5, cfg.contrast_delta)):
        assert (a[:, col] >= np.float32(1 - delta)).all()
        assert (a[:, col] < np.float32(1 + delta)).all()
    # a sample's augmented batch row does not depend on its batch
    _, ds = port_ds(pack_dir)
    alone = as_numpy(ds._gather([3], 1, augment=True))
    among = as_numpy(ds._gather([5, 3, 1], 1, augment=True))
    for k in alone:
        np.testing.assert_array_equal(alone[k][0], among[k][1], err_msg=k)


def chunked(pack_dir, chunk, **kw):
    _, pl = loaders(pack_dir)
    return pdr.ChunkedDeviceDataset(pl, chunk, device="cpu", **kw)


@pytest.mark.parametrize("storage", ["float32", "quantized"])
@pytest.mark.parametrize("prefetch", ["thread", "serial"])
def test_chunked_matches_resident(pack_dir, storage, prefetch):
    """Same permutation slices and the same draws: the chunked batches
    equal the resident ones bit for bit, augmented or not, the remainder
    dropped or kept, with the batch bigger than the chunk too."""
    kw = STORAGES[storage][1]
    _, ds = port_ds(pack_dir, **kw)
    for chunk, batch in ((5, 4), (3, 5)):
        ch = chunked(pack_dir, chunk, **kw)
        for augment in (False, True):
            for drop in (True, False):
                args = dict(shuffle=True, seed=9, epoch=2, augment=augment,
                            drop_remainder=drop)
                want = list(ds.batches(batch, **args))
                got = list(ch.batches(batch, prefetch=prefetch, **args))
                assert len(got) == len(want) > 0
                for a, b in zip(got, want):
                    assert_same(as_numpy(a), as_numpy(b),
                                f"chunk {chunk} {augment} {drop}")


def test_tail_batch_trimmed_not_duplicated(pack_dir):
    pl, ds = port_ds(pack_dir)
    got = list(ds.batches(5, shuffle=False, drop_remainder=False))
    assert [b["rgb"].shape[0] for b in got] == [5, 5, 2]
    assert ds.batches_per_epoch(5, drop_remainder=False) == len(got)
    swept = np.concatenate([b["rgb"].numpy() for b in got])
    np.testing.assert_array_equal(swept, pack_rows(pl, range(12))[0])
    got = list(chunked(pack_dir, 4).batches(5, shuffle=False,
                                            drop_remainder=False))
    np.testing.assert_array_equal(
        np.concatenate([b["rgb"].numpy() for b in got]), swept)


def test_share_storage_from_keeps_identity_and_rejects(pack_dir):
    _, train_ds = port_ds(pack_dir)
    _, val_loader = loaders(pack_dir, split="val", augment=False)
    val_ds = pdr.DeviceDataset(val_loader, share_storage_from=train_ds)
    assert val_ds.rgb is train_ds.rgb and val_ds.depth is train_ds.depth
    assert val_ds.k is train_ds.k
    assert val_ds.split == "val" and train_ds.split == "train"
    assert train_ds.augmentation_enabled and not val_ds.augmentation_enabled
    idx = [1, 7, 3]
    assert_same(as_numpy(val_ds._gather(idx)), val_loader.fast_batch(idx))
    # resolution, rows
    small = p_packed.PackedSunRGBDLoader(pack_dir, split="val",
                                         target_height=32, target_width=32,
                                         rays_on_device=True)
    with pytest.raises(ValueError, match="matching resolution"):
        pdr.DeviceDataset(small, share_storage_from=train_ds)
    with pytest.raises(ValueError, match="target resolution"):
        pdr.DeviceDataset(small, device="cpu")
    filt = p_packed.PackedSunRGBDLoader(pack_dir, split="val",
                                        rays_on_device=True,
                                        split_filtering=True)
    assert len(filt) < len(train_ds)
    with pytest.raises(ValueError, match="identical sample rows"):
        pdr.DeviceDataset(filt, share_storage_from=train_ds)


def test_refusals(pack_dir, monkeypatch):
    _, pl = loaders(pack_dir)
    sharded = pdr.DeviceDataset(pl, mesh=DataParallel(2, 1), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2 dataset"):
        sharded.batches_per_epoch(3)
    with pytest.raises(ValueError, match="all-or-nothing"):
        pdr.ChunkedDeviceDataset(pl, 5, rgb_dtype=torch.uint8, device="cpu")
    with pytest.raises(ValueError, match="chunk_samples"):
        pdr.ChunkedDeviceDataset(pl, 0, device="cpu")
    with pytest.raises(ValueError, match="storage"):
        pdr.DeviceDataset(pl, depth_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        next(chunked(pack_dir, 5).batches(4, prefetch="eager"))
    monkeypatch.setenv("CADEPTH_CHUNK_PREFETCH", "eager")
    with pytest.raises(ValueError, match="CADEPTH_CHUNK_PREFETCH"):
        next(chunked(pack_dir, 5).batches(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pdr.DeviceDataset(pl)


def test_quantized_storage_semantics(pack_dir):
    """Depth stored mm-exact and decoded to the f32 pack's bits; rgb
    within the u8 rounding step; the same after augmentation (a convex
    interpolation and a clipped affine jitter; contrast <= 1.2 stretches
    the rgb step by <= 1.2)."""
    _, ds32 = port_ds(pack_dir)
    _, dsq = port_ds(pack_dir, **QUANT)
    assert dsq.rgb.dtype == torch.uint8 and dsq.depth_dtype == torch.uint16
    assert dsq.nbytes() < ds32.nbytes() / 3.0
    np.testing.assert_array_equal(
        dsq.depth.numpy().view(np.uint16).astype(np.float32),
        np.rint(ds32.depth.numpy() * 1000.0))
    idx = [1, 4, 7, 10]
    for epoch, augment, step in ((0, False, 0.5), (1, True, 1.2 * 0.5)):
        a = as_numpy(ds32._gather(idx, epoch, augment))
        b = as_numpy(dsq._gather(idx, epoch, augment))
        np.testing.assert_array_equal(a["depth"], b["depth"])
        np.testing.assert_array_equal(a["intrinsics"], b["intrinsics"])
        np.testing.assert_allclose(a["rgb"], b["rgb"], rtol=0,
                                   atol=step / 255.0 + 1e-6)


def test_chunked_abandoned_consumer(pack_dir):
    """Leaving batches() early stops and joins the producer, so the next
    epoch on the same instance owns the staging slots alone."""
    _, ds = port_ds(pack_dir)
    ch = chunked(pack_dir, 5)
    want = [as_numpy(b) for b in ds.batches(4, seed=13, epoch=0)]
    n_before = threading.active_count()
    for trial in range(4):
        it = ch.batches(4, seed=13, epoch=0, prefetch="thread")
        next(it)
        it.close()
        got = [as_numpy(b) for b in ch.batches(4, seed=13, epoch=0,
                                               prefetch="thread")]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b, f"trial {trial}")
    assert threading.active_count() <= n_before + 1


def test_chunked_slot_reuse(pack_dir):
    """The two slots are restaged every other chunk while earlier chunks'
    batches are still held: the held batches keep their values (the CPU
    takes private copies of a slot)."""
    _, ds = port_ds(pack_dir)
    want = [as_numpy(b) for b in ds.batches(4, seed=13, epoch=0)]
    ch = chunked(pack_dir, 4)
    for trial in range(8):
        got = list(ch.batches(4, seed=13, epoch=0, prefetch="thread"))
        for i, g in enumerate(got):
            assert_same(as_numpy(g), want[i], f"trial {trial} batch {i}")


def test_device_pipeline_advances_epochs_and_augments_train_only(pack_dir):
    _, ds = port_ds(pack_dir)
    pipe = pdr.DevicePipeline(ds, 4, shuffle=True, seed=3)
    assert len(pipe) == 3
    e0 = [as_numpy(b) for b in pipe]
    e1 = [as_numpy(b) for b in pipe]
    assert not all(np.array_equal(a["rgb"], b["rgb"])
                   for a, b in zip(e0, e1))
    for a, b in zip(e0, ds.batches(4, seed=3, epoch=0, augment=True)):
        assert_same(a, as_numpy(b))
    _, val = loaders(pack_dir, split="val", augment=True)
    vds = pdr.DeviceDataset(val, device="cpu")
    for a, b in zip(pdr.DevicePipeline(vds, 4, shuffle=False),
                    vds.batches(4, shuffle=False)):
        assert_same(as_numpy(a), as_numpy(b))


def test_chunked_thread_overlap_hides_upload(pack_dir, monkeypatch):
    """Thread-mode chunk prefetch OVERLAPS uploads with compute; serial
    mode alternates them (the JAX test's simulation): the wire and the
    device step are GIL-releasing sleeps of known length, so the real
    scheduling machinery (slots, token semaphore, producer thread) runs
    with controlled constants, and the serial fed fraction matches
    ``serial_fed_fraction``."""
    ch = chunked(pack_dir, 4)
    n_chunks = len(ch) // 4
    assert n_chunks == 3
    U, C = 0.12, 0.06   # simulated wire per chunk, device step per batch
    uploads, computes = [], []
    orig_upload = pdr.ChunkedDeviceDataset._upload

    def slow_upload(self, order_slice, slot=0, block=False):
        t0 = time.perf_counter()
        out = orig_upload(self, order_slice, slot=slot, block=block)
        time.sleep(U)
        uploads.append((t0, time.perf_counter()))
        return out

    monkeypatch.setattr(pdr.ChunkedDeviceDataset, "_upload", slow_upload)

    def run_epoch(prefetch):
        uploads.clear()
        computes.clear()
        t0 = time.perf_counter()
        n = 0
        for _ in ch.batches(2, shuffle=False, prefetch=prefetch):
            c0 = time.perf_counter()
            time.sleep(C)
            computes.append((c0, time.perf_counter()))
            n += 1
        return time.perf_counter() - t0, n

    run_epoch("serial")   # warm-up
    serial_wall, n_serial = run_epoch("serial")
    thread_wall, n_thread = run_epoch("thread")
    assert n_serial == n_thread == n_chunks * 2
    hidden = sum(max(0.0, min(ue, ce) - max(us, cs))
                 for us, ue in uploads for cs, ce in computes)
    assert hidden > U, f"only {hidden * 1e3:.0f} ms of upload hidden"
    assert thread_wall < serial_wall - 0.5 * U, (thread_wall, serial_wall)
    predicted = pdr.serial_fed_fraction(C / 2.0, U / 4.0, 1.0)
    measured = (n_serial * C) / serial_wall
    assert abs(measured - predicted) < 0.17, (measured, predicted)


def test_batches_make_no_host_copy_per_step(pack_dir, monkeypatch):
    """batches() copies the epoch's order (and draws) to the device once,
    not an index per step: count the host arrays it hands to torch."""
    _, ds = port_ds(pack_dir)
    calls = []
    orig = pdr._host_to
    monkeypatch.setattr(pdr, "_host_to", functools.partial(
        lambda f, arr, dev: (calls.append(arr.shape), f(arr, dev))[1], orig))
    assert len(list(ds.batches(2, epoch=5, augment=True))) == 6
    assert calls == [(12,), (12, 6)]
