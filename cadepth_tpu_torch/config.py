"""Layered configuration system, a copy of ``cadepth_tpu.config``.

The port reads the same YAML schema with the same override semantics:
base YAML -> named experiment override block (deep merge) -> debug-mode
override. The copy is kept byte-for-byte in behaviour so one YAML file
configures both packages; ``tests/test_torch_model.py`` holds the two
``Config`` trees equal. The port does not import the JAX package, so
the schema lives here a second time.

Fields that only the JAX trainer reads (mesh axes, TPU lowerings) are
parsed and kept so the tree stays equal; the port's model factory raises
on values it does not implement yet.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import pathlib
from typing import Any, Dict, List, Optional

log = logging.getLogger("cadepth_tpu_torch")


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "baseline_unet"
    description: str = ""
    tags: List[str] = dataclasses.field(default_factory=list)
    seed: int = 42
    deterministic: bool = False


@dataclasses.dataclass
class AugmentationYaml:
    random_crop: bool = True
    crop_scale_min: float = 0.7
    crop_scale_max: float = 1.0
    horizontal_flip: bool = True
    flip_probability: float = 0.5
    color_jitter: bool = True
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    random_gamma: bool = False
    gamma_range: List[float] = dataclasses.field(default_factory=lambda: [0.8, 1.2])


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = "sunrgbd"
    data_dir: str = "./data/sunrgbd"
    manifest_path: str = "./data/sunrgbd_manifest.json"
    train_split: str = "train"
    val_split: str = "test"
    sensor_types: List[str] = dataclasses.field(default_factory=list)
    input_height: int = 240
    input_width: int = 320
    resize_mode: str = "resize"
    split_filtering: bool = False  # reference-faithful default (SURVEY §2.3 #1)
    compute_rays: bool = True      # TPU-native: derive rays, don't store them
    use_native_loader: str = "auto"  # "auto" | "always" | "never" (C++ decode)
    packed_dir: str = ""  # decode-once cache dir (cli/pack_dataset.py); when
    #                       set, loaders read memmapped samples instead of
    #                       decoding data_dir images each epoch
    packed_preload: bool = False  # copy the pack into RAM (immune to page-
    #                               cache reclaim; costs the pack size in RAM)
    device_resident: bool = False  # upload the pack to HBM once and batch by
    #                                on-device gather (+ on-device augment);
    #                                zero per-step H2D. Needs packed_dir and
    #                                a pack at the target resolution.
    device_resident_dtype: str = "float32"  # HBM storage: "float32" |
    # "bfloat16" (halves RGB; depth stays fp32) | "quantized" (rgb uint8 +
    # depth uint16 mm — the dataset's native encodings; 3.2x less HBM/H2D,
    # depth stored mm-exact for mm-sourced packs, ±1 ulp on decode)
    # >0: stream the pack through HBM in chunks of this many samples
    # (double-buffered uploads) instead of holding it all resident —
    # for packs bigger than one chip's HBM (e.g. 480x640). Identical
    # epoch/sampling semantics to the resident path. 0 = fully resident.
    device_resident_chunk_samples: int = 0
    augmentation: AugmentationYaml = dataclasses.field(default_factory=AugmentationYaml)


@dataclasses.dataclass
class ModelConfig:
    architecture: str = "baseline_unet"
    in_channels: int = 3
    init_features: int = 64
    max_depth: float = 10.0
    camera_dim: int = 4
    use_pcl: bool = True
    use_attention: bool = True
    variant: str = "full"
    remat: bool = False  # gradient checkpointing for big configs
    # PCL warp backend: "two_pass" (gather-free GEMM warp — exact for
    # zero predicted rotation, <= |tan rot| px kernel displacement under
    # it; the DEFAULT), "auto" (two_pass under a runtime rotation bound
    # with exact gather fallback — ~2.7% slower since round 4),
    # "gather" (reference-parity grid_sample always), "separable"
    # (axis-aligned GEMM warp, drops rotation+shear). PERF_NOTES.md.
    pcl_warp: str = "two_pass"
    # Normalization: "batch" (reference parity: BN everywhere,
    # sync-stats under SPMD) | "group" (GroupNorm experiment — drops the
    # fp32 BN-statistic epilogues from every conv; revalidate quality).
    norm: str = "batch"
    # Decoder upsampling: "transpose" (reference parity: ConvTranspose
    # 2x2 s2) | "resize" (nearest 2x + Conv3x3 experiment — denser MXU
    # work than the strided transpose-conv lowering).
    decoder_upsample: str = "transpose"
    # Spatial-attention conv lowering (models/attention.py
    # SpatialGateConv): "toeplitz" (width-in-lanes GEMM, fastest on TPU)
    # | "stencil" (shifted-slice VPU fusion) | "conv" (direct lax.conv —
    # the reference-style lowering). Same math and parameters in all
    # three (bf16 summation-order tolerance); PERF_NOTES "CBAM cost".
    sa_lowering: str = "toeplitz"


@dataclasses.dataclass
class OptimizationConfig:
    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    adam_betas: List[float] = dataclasses.field(default_factory=lambda: [0.9, 0.999])
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    sgd_nesterov: bool = True
    lr_scheduler: str = "step"
    lr_step_size: int = 10
    lr_gamma: float = 0.5
    lr_warmup_epochs: int = 2
    lr_min: float = 1e-6
    gradient_clip: bool = True
    gradient_clip_value: float = 1.0
    grad_accum_steps: int = 1  # micro-batches averaged per optimizer update
    #                            (optax.MultiSteps; the reference has no
    #                            accumulation — trainer.h:24-92)


@dataclasses.dataclass
class LossConfig:
    si_weight: float = 1.0
    grad_weight: float = 0.1
    smooth_weight: float = 0.001
    reproj_weight: float = 0.01
    si_lambda: float = 0.5
    grad_num_scales: int = 4
    min_depth: float = 0.1
    max_depth: float = 10.0


@dataclasses.dataclass
class TrainingLoopConfig:
    num_epochs: int = 50
    batch_size: int = 8
    num_workers: int = 4
    prefetch_factor: int = 2
    use_amp: bool = True  # bf16 compute on TPU (real, unlike the reference)
    log_interval: int = 10
    val_interval: int = 1
    save_predictions: bool = True
    num_vis_samples: int = 4
    max_val_samples: int = 500  # production_trainer.h:242-281 caps val at 500


@dataclasses.dataclass
class ValidationConfig:
    metrics: List[str] = dataclasses.field(default_factory=lambda: [
        "abs_rel", "sq_rel", "rmse", "rmse_log", "mae", "log10",
        "delta_1.25", "delta_1.25^2", "delta_1.25^3"])
    primary_metric: str = "abs_rel"
    metric_mode: str = "min"
    min_depth: float = 0.1
    max_depth: float = 10.0


@dataclasses.dataclass
class CheckpointConfig:
    checkpoint_dir: str = "./checkpoints"
    save_interval: int = 5
    save_best_only: bool = True
    save_last: bool = True
    keep_last_n: int = 3
    resume_from: str = ""
    async_save: bool = False  # overlap checkpoint IO with the next epoch
    #                           (finalized before the next save/restore)
    save_on_preemption: bool = True  # SIGTERM -> checkpoint + clean exit
    #                                  (cloud TPU-VM preemption safety)


@dataclasses.dataclass
class EarlyStoppingConfig:
    enabled: bool = True
    patience: int = 10
    min_delta: float = 1e-4


@dataclasses.dataclass
class LoggingConfig:
    log_dir: str = "./logs"
    tensorboard_enabled: bool = True
    log_scalar_interval: int = 10
    log_image_interval: int = 100
    log_histogram_interval: int = 5
    csv_enabled: bool = True
    metrics_file: str = "metrics.csv"
    verbose: bool = True


@dataclasses.dataclass
class HardwareConfig:
    device: str = "tpu"
    num_devices: int = 0       # 0 = all available
    data_parallel: bool = True
    mesh_axis: str = "data"
    # >1 shards image HEIGHT over this many devices (2-D data x space
    # mesh; XLA inserts conv halo exchanges). For resolutions that
    # outgrow one chip's HBM.
    spatial_parallel: int = 1


@dataclasses.dataclass
class Config:
    experiment: ExperimentConfig = dataclasses.field(default_factory=ExperimentConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    training: TrainingLoopConfig = dataclasses.field(default_factory=TrainingLoopConfig)
    validation: ValidationConfig = dataclasses.field(default_factory=ValidationConfig)
    checkpointing: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    early_stopping: EarlyStoppingConfig = dataclasses.field(default_factory=EarlyStoppingConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    hardware: HardwareConfig = dataclasses.field(default_factory=HardwareConfig)


# -- YAML mapping ------------------------------------------------------------

def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _get(d: Dict[str, Any], *path, default=None):
    for p in path:
        if not isinstance(d, dict) or p not in d:
            return default
        d = d[p]
    return d


def _enum(value: str, allowed, name: str) -> str:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {'|'.join(allowed)}, "
                         f"got {value!r}")
    return value


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Map the reference YAML schema onto the Config tree
    (port of `loadConfig`, `train_main.cpp:60-167`)."""
    cfg = Config()

    exp = raw.get("experiment", {})
    cfg.experiment = ExperimentConfig(
        name=exp.get("name", cfg.experiment.name),
        description=exp.get("description", ""),
        tags=list(exp.get("tags", [])),
        seed=int(_get(raw, "reproducibility", "seed",
                      default=exp.get("seed", 42))),
        deterministic=bool(_get(raw, "reproducibility", "deterministic",
                                default=exp.get("deterministic", False))),
    )

    d = raw.get("data", {})
    aug = d.get("augmentation", {})
    if aug.get("saturation") or aug.get("hue"):
        log.warning(
            "augmentation.saturation/hue are accepted but not applied "
            "(parity with sunrgbd_loader.cpp:432-443, which only implements "
            "brightness/contrast)")
    if aug.get("random_gamma"):
        log.warning(
            "augmentation.random_gamma is accepted but not applied "
            "(the reference declares it in YAML but never implements it)")
    cfg.data = DataConfig(
        dataset_name=d.get("dataset_name", "sunrgbd"),
        data_dir=d.get("data_dir", "./data/sunrgbd"),
        manifest_path=d.get("manifest_path", "./data/sunrgbd_manifest.json"),
        train_split=d.get("train_split", "train"),
        val_split=d.get("val_split", "test"),
        sensor_types=list(d.get("sensor_types", [])),
        input_height=int(d.get("input_height", 240)),
        input_width=int(d.get("input_width", 320)),
        resize_mode=d.get("resize_mode", "resize"),
        split_filtering=bool(d.get("split_filtering", False)),
        compute_rays=bool(d.get("compute_rays", True)),
        use_native_loader=str(d.get("use_native_loader", "auto")),
        packed_dir=str(d.get("packed_dir", "")),
        packed_preload=bool(d.get("packed_preload", False)),
        device_resident=bool(d.get("device_resident", False)),
        device_resident_dtype=_enum(
            str(d.get("device_resident_dtype", "float32")),
            ("float32", "bfloat16", "quantized"), "device_resident_dtype"),
        device_resident_chunk_samples=int(
            d.get("device_resident_chunk_samples", 0)),
        augmentation=AugmentationYaml(
            random_crop=bool(aug.get("random_crop", True)),
            crop_scale_min=float(aug.get("crop_scale_min", 0.7)),
            crop_scale_max=float(aug.get("crop_scale_max", 1.0)),
            horizontal_flip=bool(aug.get("horizontal_flip", True)),
            flip_probability=float(aug.get("flip_probability", 0.5)),
            color_jitter=bool(aug.get("color_jitter", True)),
            brightness=float(aug.get("brightness", 0.2)),
            contrast=float(aug.get("contrast", 0.2)),
            saturation=float(aug.get("saturation", 0.2)),
            hue=float(aug.get("hue", 0.1)),
            random_gamma=bool(aug.get("random_gamma", False)),
            gamma_range=list(aug.get("gamma_range", [0.8, 1.2])),
        ),
    )

    m = raw.get("model", {})
    arch = m.get("architecture", "baseline_unet")
    # per-arch use_attention default parity: false for intrinsics_unet
    # (train_main.cpp:192 `as<bool>(false)`), true for geometry_aware
    # (train_main.cpp:203 `as<bool>(true)`)
    att_default = arch != "intrinsics_unet"
    cfg.model = ModelConfig(
        architecture=arch,
        in_channels=int(m.get("in_channels", 3)),
        init_features=int(m.get("init_features", 64)),
        max_depth=float(m.get("max_depth", 10.0)),
        camera_dim=int(m.get("camera_dim", 4)),
        use_pcl=bool(m.get("use_pcl", True)),
        use_attention=bool(m.get("use_attention", att_default)),
        variant=m.get("variant", "full"),
        # bool or the string policy "highres"/"full" (models/layers.py)
        remat=(m["remat"] if isinstance(m.get("remat"), str)
               else bool(m.get("remat", False))),
        pcl_warp=_enum(m.get("pcl_warp", "two_pass"),
                       ("two_pass", "auto", "gather", "separable",
                        "pallas", "fused"), "model.pcl_warp"),
        norm=_enum(m.get("norm", "batch"), ("batch", "group"),
                   "model.norm"),
        decoder_upsample=_enum(m.get("decoder_upsample", "transpose"),
                               ("transpose", "resize"),
                               "model.decoder_upsample"),
        sa_lowering=_enum(m.get("sa_lowering", "toeplitz"),
                          ("toeplitz", "stencil", "conv"),
                          "model.sa_lowering"),
    )

    o = raw.get("optimization", {})
    cfg.optimization = OptimizationConfig(
        optimizer=o.get("optimizer", "adamw"),
        learning_rate=float(o.get("learning_rate", 1e-4)),
        weight_decay=float(o.get("weight_decay", 1e-5)),
        adam_betas=list(_get(o, "adam", "betas", default=[0.9, 0.999])),
        adam_eps=float(_get(o, "adam", "eps", default=1e-8)),
        sgd_momentum=float(_get(o, "sgd", "momentum", default=0.9)),
        sgd_nesterov=bool(_get(o, "sgd", "nesterov", default=True)),
        lr_scheduler=o.get("lr_scheduler", "step"),
        lr_step_size=int(o.get("lr_step_size", 10)),
        lr_gamma=float(o.get("lr_gamma", 0.5)),
        lr_warmup_epochs=int(o.get("lr_warmup_epochs", 2)),
        lr_min=float(o.get("lr_min", 1e-6)),
        gradient_clip=bool(o.get("gradient_clip", True)),
        gradient_clip_value=float(o.get("gradient_clip_value", 1.0)),
        grad_accum_steps=int(o.get("grad_accum_steps", 1)),
    )

    l = raw.get("loss", {})
    cfg.loss = LossConfig(
        si_weight=float(l.get("si_weight", 1.0)),
        grad_weight=float(l.get("grad_weight", 0.1)),
        smooth_weight=float(l.get("smooth_weight", 0.001)),
        reproj_weight=float(l.get("reproj_weight", 0.01)),
        si_lambda=float(l.get("si_lambda", 0.5)),
        grad_num_scales=int(l.get("grad_num_scales", 4)),
        min_depth=float(l.get("min_depth", 0.1)),
        max_depth=float(l.get("max_depth", 10.0)),
    )

    t = raw.get("training", {})
    cfg.training = TrainingLoopConfig(
        num_epochs=int(t.get("num_epochs", 50)),
        batch_size=int(t.get("batch_size", 8)),
        num_workers=int(t.get("num_workers", 4)),
        prefetch_factor=int(t.get("prefetch_factor", 2)),
        use_amp=bool(t.get("use_amp", True)),
        log_interval=int(t.get("log_interval", 10)),
        val_interval=int(t.get("val_interval", 1)),
        save_predictions=bool(t.get("save_predictions", True)),
        num_vis_samples=int(t.get("num_vis_samples", 4)),
        max_val_samples=int(t.get("max_val_samples", 500)),
    )

    v = raw.get("validation", {})
    cfg.validation = ValidationConfig(
        metrics=list(v.get("metrics", cfg.validation.metrics)),
        primary_metric=v.get("primary_metric", "abs_rel"),
        metric_mode=v.get("metric_mode", "min"),
        min_depth=float(v.get("min_depth", 0.1)),
        max_depth=float(v.get("max_depth", 10.0)),
    )

    c = raw.get("checkpointing", {})
    cfg.checkpointing = CheckpointConfig(
        checkpoint_dir=c.get("checkpoint_dir", "./checkpoints"),
        save_interval=int(c.get("save_interval", 5)),
        save_best_only=bool(c.get("save_best_only", True)),
        save_last=bool(c.get("save_last", True)),
        keep_last_n=int(c.get("keep_last_n", 3)),
        resume_from=c.get("resume_from", ""),
        async_save=bool(c.get("async_save", False)),
        save_on_preemption=bool(c.get("save_on_preemption", True)),
    )

    e = raw.get("early_stopping", {})
    cfg.early_stopping = EarlyStoppingConfig(
        enabled=bool(e.get("enabled", True)),
        patience=int(e.get("patience", 10)),
        min_delta=float(e.get("min_delta", 1e-4)),
    )

    lg = raw.get("logging", {})
    tb = lg.get("tensorboard", {})
    csv = lg.get("csv", {})
    # accept the bool shorthand `tensorboard: false` (mirrors the CLI's
    # --tensorboard flag) alongside the reference's nested block
    # (`train_config.yaml:158-162`)
    if isinstance(tb, bool):
        tb = {"enabled": tb}
    if isinstance(csv, bool):
        csv = {"enabled": csv}
    cfg.logging = LoggingConfig(
        log_dir=lg.get("log_dir", "./logs"),
        tensorboard_enabled=bool(tb.get("enabled", True)),
        log_scalar_interval=int(tb.get("log_scalar_interval", 10)),
        log_image_interval=int(tb.get("log_image_interval", 100)),
        log_histogram_interval=int(tb.get("log_histogram_interval", 5)),
        csv_enabled=bool(csv.get("enabled", True)),
        metrics_file=csv.get("metrics_file", "metrics.csv"),
        verbose=bool(_get(lg, "console", "verbose", default=True)),
    )

    h = raw.get("hardware", {})
    if h.get("backend") == "nccl":
        log.info("hardware.backend=nccl is ignored: communication is XLA "
                 "collectives over ICI (no NCCL on TPU)")
    cfg.hardware = HardwareConfig(
        device=h.get("device", "tpu"),
        num_devices=int(h.get("num_devices", h.get("num_gpus", 0) or 0)),
        data_parallel=bool(h.get("data_parallel",
                                 h.get("distributed", True))),
        mesh_axis=h.get("mesh_axis", "data"),
        spatial_parallel=int(h.get("spatial_parallel", 1)),
    )
    return cfg


def load_config(
    path: str,
    experiment: Optional[str] = None,
    debug: bool = False,
) -> Config:
    """Load YAML, apply a named experiment override, then debug override."""
    # PyYAML is needed only here: the serving path builds its Config with
    # config_from_dict and runs where PyYAML is absent.
    import yaml

    raw = yaml.safe_load(pathlib.Path(path).read_text()) or {}
    if experiment:
        overrides = _get(raw, "experiments", experiment)
        if overrides is None:
            available = sorted((raw.get("experiments") or {}).keys())
            raise KeyError(
                f"Experiment '{experiment}' not found; available: {available}")
        raw = _deep_merge(raw, overrides)
    if debug:
        dbg = raw.get("debug", {})
        raw = _deep_merge(raw, {
            "training": {
                "num_epochs": int(dbg.get("num_epochs", 2)),
                "log_interval": int(dbg.get("log_interval", 1)),
            },
        })
        raw.setdefault("_debug_limits", {})
        raw["_debug_limits"] = {
            "num_train_samples": int(dbg.get("num_train_samples", 100)),
            "num_val_samples": int(dbg.get("num_val_samples", 50)),
        }
    cfg = config_from_dict(raw)
    if debug:
        cfg._debug_limits = raw["_debug_limits"]  # type: ignore[attr-defined]
    return cfg


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
