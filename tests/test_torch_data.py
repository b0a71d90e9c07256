"""The port's data layer against the JAX package's: the synthetic fixture,
the validator and manifests, the live and packed loaders (every sample
and batch, train and test splits, augmentation on over two epochs), the
ray grids, the native loader's bindings and the geometry file formats.

Both sides read the same files with the same cv2 calls, so every array
must be bit-equal (``np.array_equal``)."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.data import manifest as j_manifest
from cadepth_tpu.data import native as j_native
from cadepth_tpu.data import packed as j_packed
from cadepth_tpu.data import sunrgbd as j_sunrgbd
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu.geometry import io as j_io
from cadepth_tpu_torch.data import manifest as p_manifest
from cadepth_tpu_torch.data import native as p_native
from cadepth_tpu_torch.data import packed as p_packed
from cadepth_tpu_torch.data import sunrgbd as p_sunrgbd
from cadepth_tpu_torch.data import synthetic as p_synthetic
from cadepth_tpu_torch.geometry import io as p_io

H, W = 48, 64
SAMPLE_KEYS = ("rgb", "depth", "intrinsics", "extrinsics", "rays",
               "image_path", "sensor_type", "scene_type")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX generator's fixture (12 scenes, rays.bin files, the kv2
    sensor's mismatched RGB and depth sizes)."""
    root = tmp_path_factory.mktemp("torch_data_fixture")
    manifest = j_synthetic.generate_synthetic_dataset(
        str(root), images_per_sensor=3, seed=3, with_rays=True)
    return str(root), manifest


def _loaders(dataset, **kw):
    root, manifest = dataset
    args = dict(target_height=H, target_width=W)
    args.update(kw)
    return (j_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **args),
            p_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **args))


def _assert_same(a, b, keys=None):
    assert set(a) == set(b)
    for k in keys or a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["random", "structured", "projective"])
def test_synthetic_generator_writes_the_same_tree(tmp_path, mode):
    """The port's generator writes the JAX generator's files, byte for
    byte, and a manifest that differs only in the root."""
    kw = dict(images_per_sensor=2, seed=11, with_rays=True,
              structured=mode == "structured",
              projective=mode == "projective")
    mj = j_synthetic.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    mp = p_synthetic.generate_synthetic_dataset(str(tmp_path / "p"), **kw)
    files_j = sorted(p.relative_to(tmp_path / "j")
                     for p in (tmp_path / "j").rglob("*") if p.is_file())
    files_p = sorted(p.relative_to(tmp_path / "p")
                     for p in (tmp_path / "p").rglob("*") if p.is_file())
    assert files_j == files_p and len(files_j) > 8 * 5
    for rel in files_j:
        if rel.name == "sunrgbd_manifest.json":
            continue
        assert (tmp_path / "j" / rel).read_bytes() == \
            (tmp_path / "p" / rel).read_bytes(), rel
    text_j = open(mj).read().replace(str(tmp_path / "j"), "<root>")
    text_p = open(mp).read().replace(str(tmp_path / "p"), "<root>")
    assert text_j == text_p


def test_validator_and_manifests_are_equal(dataset, tmp_path):
    """Validation records, the printed summary and the saved manifest of a
    tree with one corrupt intrinsics file are equal."""
    root, _ = dataset
    bad = tmp_path / "bad"
    shutil.copytree(f"{root}/sunrgbd", bad)
    victim = sorted((bad / "kv1").iterdir())[0]
    (victim / "intrinsics.txt").write_text("-5 0 32 0 48 24 0 0 1\n")
    rj = j_manifest.SunRGBDValidator(str(bad)).validate_all_images()
    rp = p_manifest.SunRGBDValidator(str(bad)).validate_all_images()
    assert [vars(r) for r in rj] == [vars(r) for r in rp]
    assert sum(not r.is_valid for r in rp) == 1
    assert j_manifest.print_summary(rj) == p_manifest.print_summary(rp)
    mj = j_manifest.save_manifest(rj, str(tmp_path / "j.json"))
    mp = p_manifest.save_manifest(rp, str(tmp_path / "p.json"))
    assert mj == mp
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "p.json").read_text()
    assert p_manifest.load_manifest(str(tmp_path / "p.json")) == \
        j_manifest.load_manifest(str(tmp_path / "j.json"))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("rays", ["stored", "computed", "on_device"])
def test_every_sample_and_batch_over_two_augmented_epochs(dataset, split,
                                                          rays):
    """Augmentation enabled (it acts on the train split only): every
    get_sample of epochs 0 and 1 and a get_batch of each epoch are
    bit-equal, with rays from rays.bin, computed on the host from the
    final K, or left to the device."""
    kw = {"stored": {}, "computed": {"compute_rays": True},
          "on_device": {"compute_rays": True, "rays_on_device": True}}[rays]
    jl, pl = _loaders(dataset, split=split, **kw)
    cfg = dict(random_seed=7, crop_scale_min=0.6)
    jl.enable_augmentation(j_sunrgbd.AugmentationConfig(**cfg))
    pl.enable_augmentation(p_sunrgbd.AugmentationConfig(**cfg))
    assert len(jl) == len(pl) == 12
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for i in range(len(jl)):
            a, b = jl.get_sample(i), pl.get_sample(i)
            _assert_same(a, b)
        idx = [5, 0, 11, 3]
        _assert_same(jl.get_batch(idx), pl.get_batch(idx))


@pytest.mark.parametrize("kw", [
    {"allowed_sensors": ("kv2", "xtion")},
    {"split_filtering": True, "split": "train"},
    {"split_filtering": True, "split": "test"},
    {"target_height": 24, "target_width": 40},
])
def test_loader_options(dataset, kw):
    jl, pl = _loaders(dataset, compute_rays=True, **kw)
    assert [dict(s, image_dir=str(s["image_dir"])) for s in jl.sample_paths] \
        == [dict(s, image_dir=str(s["image_dir"])) for s in pl.sample_paths]
    assert jl.get_statistics() == pl.get_statistics()
    _assert_same(jl.get_batch(range(len(jl))), pl.get_batch(range(len(pl))))


@pytest.mark.parametrize("hw", [(48, 64), (31, 17), (240, 320)])
def test_compute_rays_is_equal(hw):
    rng = np.random.default_rng(hw[0])
    for _ in range(3):
        k = np.eye(3, dtype=np.float32)
        k[0, 0], k[1, 1] = rng.uniform(20, 400, 2)
        k[0, 2], k[1, 2] = rng.uniform(0, hw[1]), rng.uniform(0, hw[0])
        a = j_sunrgbd.SunRGBDLoader._compute_rays(k, *hw)
        b = p_sunrgbd.SunRGBDLoader._compute_rays(k, *hw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_split_hash_is_equal(dataset):
    jl, _ = _loaders(dataset)
    for s in jl.sample_paths:
        path = str(s["image_dir"])
        assert j_sunrgbd._split_hash(path) == p_sunrgbd._split_hash(path)


@pytest.fixture(scope="module")
def packs(dataset, tmp_path_factory):
    root, manifest = dataset
    out = tmp_path_factory.mktemp("torch_packs")
    kw = dict(target_height=H, target_width=W, num_threads=4)
    mj = j_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(out / "j"),
                               **kw)
    mp = p_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(out / "p"),
                               **kw)
    return out, mj, mp


def test_pack_dataset_files_are_equal(packs):
    out, mj, mp = packs
    assert mj == mp
    assert json.loads((out / "j" / "packed_meta.json").read_text()) == \
        json.loads((out / "p" / "packed_meta.json").read_text())
    for name in ("rgb", "depth", "intrinsics", "extrinsics"):
        a = np.load(out / "j" / f"{name}.npy")
        b = np.load(out / "p" / f"{name}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("kw", [
    {"split": "test", "rays_on_device": True},
    {"split": "test"},
    {"split": "test", "compute_rays": False},
    {"split": "train", "split_filtering": True},
    {"split": "test", "target_height": 24, "target_width": 32},
    {"split": "test", "allowed_sensors": ("kv1",), "preload": True},
])
def test_packed_loader_and_fast_batch(packs, kw):
    out, _, _ = packs
    jl = j_packed.PackedSunRGBDLoader(str(out / "j"), **kw)
    pl = p_packed.PackedSunRGBDLoader(str(out / "p"), **kw)
    assert len(jl) == len(pl) > 0
    assert jl.fast_batch_applicable() == pl.fast_batch_applicable()
    idx = list(range(len(jl)))[::-1][:5]
    fj, fp = jl.fast_batch(idx), pl.fast_batch(idx)
    assert (fj is None) == (fp is None)
    if fj is not None:
        _assert_same(fj, fp)
    for i in range(len(jl)):
        a, b = jl.get_sample(i), pl.get_sample(i)
        a["image_path"] = a["image_path"].replace(str(out / "j"), "")
        _assert_same(a, b)


def test_packed_augmented_equals_the_live_loader(dataset, packs):
    """The port's pack, augmented over two epochs, is the port's live
    loader (as tests/test_data.py holds for JAX), and JAX's pack."""
    out, _, _ = packs
    cfg = dict(random_seed=3)
    _, live = _loaders(dataset, split="train", compute_rays=True)
    live.enable_augmentation(p_sunrgbd.AugmentationConfig(**cfg))
    pp = p_packed.PackedSunRGBDLoader(str(out / "p"), split="train")
    pp.enable_augmentation(p_sunrgbd.AugmentationConfig(**cfg))
    jp = j_packed.PackedSunRGBDLoader(str(out / "j"), split="train")
    jp.enable_augmentation(j_sunrgbd.AugmentationConfig(**cfg))
    assert not pp.fast_batch_applicable()
    for epoch in (0, 1):
        for loader in (live, pp, jp):
            loader.set_epoch(epoch)
        for i in range(len(pp)):
            a, b, c = live.get_sample(i), pp.get_sample(i), jp.get_sample(i)
            for k in ("rgb", "depth", "intrinsics", "extrinsics", "rays"):
                assert np.array_equal(a[k], b[k]), (epoch, i, k)
                assert np.array_equal(b[k], c[k]), (epoch, i, k)


def test_packed_float16_and_warm(dataset, tmp_path):
    root, manifest = dataset
    kw = dict(target_height=H, target_width=W, dtype="float16")
    j_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(tmp_path / "j"),
                          **kw)
    p_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(tmp_path / "p"),
                          **kw)
    jl = j_packed.PackedSunRGBDLoader(str(tmp_path / "j"), split="test")
    pl = p_packed.PackedSunRGBDLoader(str(tmp_path / "p"), split="test")
    before = pl.get_batch([0, 1])
    pl.warm()
    _assert_same(before, pl.get_batch([0, 1]))
    _assert_same(jl.get_batch(range(12)), pl.get_batch(range(12)),
                 keys=("rgb", "depth", "intrinsics", "extrinsics", "rays"))


def test_native_bindings_are_equal(dataset):
    """The port's ctypes bindings load the repo's native/ library (the
    path resolves from the port's own file) and give the JAX bindings'
    batches, plain and augmented."""
    if not j_native.available():
        assert not p_native.available()
        pytest.skip("native/libcadepth_native.so is not built on this "
                    "machine (and the JAX bindings see none either)")
    assert p_native._NATIVE_DIR == j_native._NATIVE_DIR
    assert p_native.version() == j_native.version()
    k = np.array([[100.0, 0, 32], [0, 110.0, 24], [0, 0, 1]], np.float32)
    assert np.array_equal(p_native.ray_grid(k, H, W),
                          j_native.ray_grid(k, H, W))
    jl, _ = _loaders(dataset, compute_rays=True)
    dirs = [str(s["image_dir"]) for s in jl.sample_paths[:6]]
    augment = {"enable_crop": True, "enable_flip": True,
               "enable_jitter": True}
    for kw in ({}, {"augment": augment, "aug_seeds": list(range(6))}):
        a = j_native.load_batch(dirs, H, W, **kw)
        b = p_native.load_batch(dirs, H, W, **kw)
        _assert_same(a, b)


def test_geometry_io_round_trips(tmp_path):
    """Ray grids, intrinsics and poses written by one package are read by
    the other, equal; malformed files raise the same errors."""
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(7, 9, 3)).astype(np.float32)
    j_io.save_ray_directions(tmp_path / "j.bin", rays)
    p_io.save_ray_directions(tmp_path / "p.bin", rays)
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "p.bin").read_bytes()
    assert np.array_equal(p_io.load_ray_directions(tmp_path / "j.bin"), rays)
    assert np.array_equal(j_io.load_ray_directions(tmp_path / "p.bin"), rays)
    (tmp_path / "k.txt").write_text("500 0 320 0 510 240 0 0 1\n")
    assert np.array_equal(p_io.load_intrinsics_txt(tmp_path / "k.txt"),
                          j_io.load_intrinsics_txt(tmp_path / "k.txt"))
    theta = 0.3
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]]
    (tmp_path / "pose.txt").write_text(" ".join(f"{v:.7f}" for v in
                                                pose.ravel()))
    assert np.array_equal(p_io.load_pose_txt(tmp_path / "pose.txt"),
                          j_io.load_pose_txt(tmp_path / "pose.txt"))
    (tmp_path / "bad_k.txt").write_text("-1 0 1 0 1 1 0 0 1\n")
    (tmp_path / "bad_pose.txt").write_text(" ".join(["2"] * 16))
    (tmp_path / "short.bin").write_bytes(np.array([5, 5], "<i4").tobytes())
    for fn, path in ((p_io.load_intrinsics_txt, "bad_k.txt"),
                     (p_io.load_pose_txt, "bad_pose.txt"),
                     (p_io.load_ray_directions, "short.bin")):
        jfn = getattr(j_io, fn.__name__)
        with pytest.raises(ValueError) as ej:
            jfn(tmp_path / path)
        with pytest.raises(ValueError) as ep:
            fn(tmp_path / path)
        assert str(ej.value) == str(ep.value)
