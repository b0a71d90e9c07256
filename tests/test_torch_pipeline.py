"""The port's ``InputPipeline`` (``device="cpu"``) against the JAX
package's: the same batches in the same order, epoch after epoch, for
each producer (per-sample decode on a thread pool, the native C++ batch
loader, a packed loader's ``fast_batch``), with and without shuffling,
the remainder dropped or kept, capped samples, and augmentation that the
pipeline re-keys every epoch; the per-process slices; an abandoned
iterator's producer; and ``device="cuda"`` without a card."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.data import native as j_native
from cadepth_tpu.data import packed as j_packed
from cadepth_tpu.data import pipeline as j_pipeline
from cadepth_tpu.data import sunrgbd as j_sunrgbd
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu_torch.data import packed as p_packed
from cadepth_tpu_torch.data import pipeline as p_pipeline
from cadepth_tpu_torch.data import sunrgbd as p_sunrgbd

H, W = 32, 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline_fixture")
    manifest = j_synthetic.generate_synthetic_dataset(
        str(root), images_per_sensor=3, seed=2, with_rays=True)
    return str(root), manifest


def _loaders(dataset, augment=True, **kw):
    root, manifest = dataset
    args = dict(target_height=H, target_width=W, split="train")
    args.update(kw)
    jl = j_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **args)
    pl = p_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **args)
    if augment:
        jl.enable_augmentation(j_sunrgbd.AugmentationConfig(random_seed=9))
        pl.enable_augmentation(p_sunrgbd.AugmentationConfig(random_seed=9))
    return jl, pl


def _epochs(pipe, n=2):
    return [[{k: np.asarray(v) for k, v in b.items()} for b in pipe]
            for _ in range(n)]


def _assert_same_epochs(a, b):
    assert [len(e) for e in a] == [len(e) for e in b]
    for ea, eb in zip(a, b):
        for ba, bb in zip(ea, eb):
            assert set(ba) == set(bb)
            for k in ba:
                assert ba[k].dtype == bb[k].dtype, k
                assert np.array_equal(ba[k], bb[k]), k


@pytest.mark.parametrize("shuffle,drop_remainder,max_samples,batch", [
    (True, True, None, 4),
    (False, True, None, 4),
    (True, False, None, 5),
    (False, False, 7, 3),
    (True, True, 9, 2),
])
@pytest.mark.parametrize("rays", ["stored", "on_device"])
def test_same_batches_in_the_same_order(dataset, shuffle, drop_remainder,
                                        max_samples, batch, rays):
    """Per-sample producer, augmentation on, two epochs."""
    kw = {"stored": {}, "on_device": {"compute_rays": True,
                                      "rays_on_device": True}}[rays]
    jl, pl = _loaders(dataset, **kw)
    args = dict(batch_size=batch, shuffle=shuffle, seed=5, num_threads=3,
                prefetch_depth=2, drop_remainder=drop_remainder,
                max_samples=max_samples, use_native="never")
    jp = j_pipeline.InputPipeline(jl, **args)
    pp = p_pipeline.InputPipeline(pl, device="cpu", **args)
    assert len(jp) == len(pp)
    got = _epochs(pp)
    _assert_same_epochs(_epochs(jp), got)
    assert pp.producer == "per-sample"
    assert pl.epoch == jl.epoch == 1
    # the epochs differ (reshuffled or re-augmented)
    assert not all(np.array_equal(a["rgb"], b["rgb"])
                   for a, b in zip(*got))


@pytest.mark.parametrize("augment", [False, True])
def test_native_producer(dataset, augment):
    """use_native auto takes the native library where it loads (with rays
    derived from K), on both sides."""
    jl, pl = _loaders(dataset, augment=augment, compute_rays=True)
    args = dict(batch_size=4, shuffle=True, seed=1, num_threads=2)
    jp = j_pipeline.InputPipeline(jl, **args)
    pp = p_pipeline.InputPipeline(pl, device="cpu", **args)
    assert pp._native == jp._native == j_native.available()
    got = _epochs(pp)
    _assert_same_epochs(_epochs(jp), got)
    assert pp.producer == ("native" if pp._native else "per-sample")


@pytest.fixture(scope="module")
def pack(dataset, tmp_path_factory):
    root, manifest = dataset
    out = tmp_path_factory.mktemp("torch_pipeline_pack")
    j_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(out),
                          target_height=H, target_width=W, num_threads=2)
    return str(out)


@pytest.mark.parametrize("split,augment", [("test", False),
                                           ("train", True)])
def test_packed_producers(pack, split, augment):
    """A pack's validation split goes through fast_batch, its augmented
    train split per sample; both as JAX's."""
    kw = dict(split=split, rays_on_device=True)
    jl = j_packed.PackedSunRGBDLoader(pack, **kw)
    pl = p_packed.PackedSunRGBDLoader(pack, **kw)
    if augment:
        jl.enable_augmentation(j_sunrgbd.AugmentationConfig(random_seed=4))
        pl.enable_augmentation(p_sunrgbd.AugmentationConfig(random_seed=4))
    args = dict(batch_size=4, shuffle=augment, seed=3, max_samples=10,
                drop_remainder=False)
    jp = j_pipeline.InputPipeline(jl, **args)
    pp = p_pipeline.InputPipeline(pl, device="cpu", **args)
    assert not pp._native
    _assert_same_epochs(_epochs(jp), _epochs(pp))
    assert pp.producer == ("per-sample" if augment else "fast")


@pytest.mark.parametrize("process_count", [2, 4])
def test_process_slices_make_the_global_batches(dataset, process_count):
    """Each process yields its slice of every global batch; together, in
    process order, they are JAX's single-process batches (as
    tests/test_data.py::test_multiprocess_slicing_matches_single_process
    holds for JAX's own slices)."""
    jl, _ = _loaders(dataset)
    oracle = _epochs(j_pipeline.InputPipeline(
        jl, batch_size=4, shuffle=True, seed=7, use_native="never"), 1)[0]
    shards = []
    for p in range(process_count):
        _, pl = _loaders(dataset)
        pipe = p_pipeline.InputPipeline(
            pl, batch_size=4, shuffle=True, seed=7, use_native="never",
            process_index=p, process_count=process_count, device="cpu")
        shards.append(_epochs(pipe, 1)[0])
    assert all(len(s) == len(oracle) for s in shards)
    for b, want in enumerate(oracle):
        for k in want:
            got = np.concatenate([s[b][k] for s in shards])
            assert np.array_equal(got, want[k]), (b, k)
    with pytest.raises(ValueError):
        p_pipeline.InputPipeline(pl, batch_size=4, process_count=3,
                                 device="cpu")
    with pytest.raises(ValueError):
        p_pipeline.InputPipeline(pl, batch_size=4, process_count=2,
                                 drop_remainder=False, device="cpu")


def test_abandoned_iterator_releases_its_producer(dataset):
    """As tests/test_data.py holds for JAX's: breaking out of an epoch
    leaves no producer blocked, and a second full pass works."""
    _, pl = _loaders(dataset, augment=False)
    pipe = p_pipeline.InputPipeline(pl, batch_size=2, shuffle=False,
                                    prefetch_depth=1, use_native="never",
                                    device="cpu")
    before = threading.active_count()
    it = iter(pipe)
    next(it)
    it.close()
    assert len(list(pipe)) == 6
    assert threading.active_count() <= before + 2


def test_producer_errors_reach_the_consumer(dataset):
    _, pl = _loaders(dataset, augment=False)

    def broken(index):
        raise IOError(f"cannot decode sample {index}")

    pl.get_sample = broken
    pipe = p_pipeline.InputPipeline(pl, batch_size=2, use_native="never",
                                    device="cpu")
    with pytest.raises(IOError, match="cannot decode"):
        list(pipe)


def test_batches_are_cpu_tensors_and_cuda_raises_without_a_card(dataset):
    _, pl = _loaders(dataset, augment=False)
    pipe = p_pipeline.InputPipeline(pl, batch_size=4, use_native="never",
                                    device="cpu")
    batch = next(iter(pipe))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in batch.values())
    assert pipe._stream is None and pipe._ring is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p_pipeline.InputPipeline(pl, batch_size=4)


def test_many_threads_and_fast_switching_keep_the_order(dataset):
    """More decode threads than cores, a prefetch depth of 1 and a
    thread switch every microsecond: two epochs of the per-sample
    producer still yield JAX's batches in JAX's order (a lost or
    reordered sample would break it). Bounded by the pipeline's own
    join timeouts."""
    import sys

    jl, pl = _loaders(dataset)
    args = dict(batch_size=3, shuffle=True, seed=11, prefetch_depth=1,
                use_native="never")
    want = _epochs(j_pipeline.InputPipeline(jl, **args))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _epochs(p_pipeline.InputPipeline(pl, num_threads=24,
                                               device="cpu", **args))
    finally:
        sys.setswitchinterval(old)
    _assert_same_epochs(want, got)
