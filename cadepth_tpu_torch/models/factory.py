"""Config-driven model factory (port of ``cadepth_tpu.models.factory``).

The port's own initialisation follows flax's distributions, not its
bits: lecun-normal (truncated normal, variance 1/fan_in) for conv and
dense kernels with zero biases, FiLM's gamma head at normal(0.01) with a
bias of ones and its beta head at normal(0.01) with a bias of zeros, the
PCL head at a zero kernel with bias [1, 1, 0, 0, 0, 0], the
Perspective3DTransformer's translation head at zero, and norm scales at
one with zero biases. Weights are drawn on the CPU from an explicit
``torch.Generator`` and then moved, so one seed gives the same model on
every device.

``depth_anything_v2`` (Depth Anything V2-Large, metric; ``dinov2.py``
and ``dpt.py``) has no flax counterpart: its convolutions and dense
layers take the same lecun-normal draw, its LayerNorms and LayerScales
keep their construction's ones and zeros (upstream's LayerScale
``init_values`` 1.0), the cls token is normal(1e-6) and the position
table normal(0.02), as DINOv2 initialises them. Its widths are
:data:`DAV2_VARIANTS`' ``vitl`` entry, chosen by ``model.variant``, and
its inputs' height and width must be multiples of 14
(:func:`check_input_size`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from cadepth_tpu_torch.models.baseline_unet import BaselineUNet
from cadepth_tpu_torch.models.dinov2 import DinoVisionTransformer
from cadepth_tpu_torch.models.dpt import DepthAnythingV2, check_grid
from cadepth_tpu_torch.models.film import FiLMLayer
from cadepth_tpu_torch.models.geometry_aware import (
    GeometryAwareNetwork, LightweightGeometryNetwork)
from cadepth_tpu_torch.models.intrinsics_unet import (
    IntrinsicsAttentionUNet, IntrinsicsConditionedUNet)
from cadepth_tpu_torch.models.pcl import (Perspective3DTransformer,
                                          PerspectiveCorrectionLayer)

ARCHITECTURES = (
    "baseline_unet",
    "intrinsics_unet",
    "intrinsics_attention_unet",
    "geometry_aware",
    "geometry_aware_lightweight",
    "depth_anything_v2",
)

# Depth Anything V2's encoder sizes (``model.variant``) at upstream's
# published widths: ViT-L/14 and its DPT head
DAV2_VARIANTS = {
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16,
                 taps=(4, 11, 17, 23), features=256,
                 out_channels=(256, 512, 1024, 1024)),
}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    # flax's lecun_normal: truncated to +-2 std, std corrected for the cut
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` as flax initialises it."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose2d):
            _lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(),
                           generator)
        elif isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.weight.shape[1], generator)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, FiLMLayer):
            nn.init.normal_(m.fc_gamma.weight, 0.0, 0.01, generator=generator)
            m.fc_gamma.bias.fill_(1.0)
            nn.init.normal_(m.fc_beta.weight, 0.0, 0.01, generator=generator)
            m.fc_beta.bias.zero_()
        elif isinstance(m, DinoVisionTransformer):
            nn.init.normal_(m.cls_token, 0.0, 1e-6, generator=generator)
            nn.init.trunc_normal_(m.pos_embed, 0.0, 0.02,
                                  generator=generator)
        elif isinstance(m, PerspectiveCorrectionLayer):
            m.fc_transform.weight.zero_()
            m.fc_transform.bias.copy_(
                torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]))
        elif isinstance(m, Perspective3DTransformer):
            m.loc_fc2.weight.zero_()


def create_model(
    architecture: str,
    in_channels: int = 3,
    init_features: int = 64,
    camera_dim: int = 4,
    max_depth: float = 10.0,
    use_pcl: bool = True,
    use_attention: bool = True,
    variant: str = "full",
    pcl_warp: str = "two_pass",
    norm: str = "batch",
    decoder_upsample: str = "transpose",
    sa_lowering: str = "toeplitz",
    remat=False,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build a model by architecture string and initialise it, with the
    JAX factory's dispatch: ``intrinsics_unet`` with ``use_attention`` is
    the CBAM variant (``intrinsics_attention_unet`` an alias), and
    ``geometry_aware`` with ``variant: lightweight`` (or
    ``geometry_aware_lightweight``) the 4-level network at
    ``min(init_features, 32)``. ``depth_anything_v2`` takes its widths
    from ``DAV2_VARIANTS[variant]`` and its output scale from
    ``max_depth``; the U-Net options do not apply to it.

    ``generator`` (a CPU ``torch.Generator``) draws the weights; without
    one, seed 0 is used. The model is returned on ``device``.
    """
    dev = resolve_device(device)
    exp_kw = dict(norm=norm, decoder_upsample=decoder_upsample, remat=remat,
                  dtype=dtype, in_channels=in_channels, max_depth=max_depth)
    att_kw = dict(sa_lowering=sa_lowering, **exp_kw)
    if architecture == "baseline_unet":
        model = BaselineUNet(init_features=init_features, **exp_kw)
    elif architecture == "intrinsics_unet" and not use_attention:
        model = IntrinsicsConditionedUNet(init_features=init_features,
                                          camera_dim=camera_dim, **exp_kw)
    elif architecture in ("intrinsics_unet", "intrinsics_attention_unet"):
        model = IntrinsicsAttentionUNet(init_features=init_features,
                                        camera_dim=camera_dim, **att_kw)
    elif architecture == "geometry_aware_lightweight" or (
            architecture == "geometry_aware" and variant == "lightweight"):
        model = LightweightGeometryNetwork(
            init_features=min(init_features, 32), camera_dim=camera_dim,
            pcl_warp=pcl_warp, **att_kw)
    elif architecture == "depth_anything_v2":
        if variant not in DAV2_VARIANTS:
            raise ValueError(f"depth_anything_v2 has variants "
                             f"{sorted(DAV2_VARIANTS)}, got {variant!r}")
        model = DepthAnythingV2(max_depth=max_depth, dtype=dtype,
                                **DAV2_VARIANTS[variant])
    elif architecture == "geometry_aware":
        model = GeometryAwareNetwork(
            init_features=init_features, camera_dim=camera_dim,
            use_pcl=use_pcl, use_attention=use_attention, pcl_warp=pcl_warp,
            **att_kw)
    else:
        raise ValueError(f"Unknown architecture '{architecture}'; expected "
                         f"one of {ARCHITECTURES}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.to(dev)


def model_inputs(architecture: str,
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Positional model arguments for a batch dict with keys 'rgb'
    (B,H,W,3), 'rays' (B,H,W,3) and 'k4' (B,4)."""
    if architecture in ("baseline_unet", "depth_anything_v2"):
        return (batch["rgb"],)
    if architecture in ("intrinsics_unet", "intrinsics_attention_unet"):
        return (batch["rgb"], batch["k4"])
    if architecture in ("geometry_aware", "geometry_aware_lightweight"):
        return (batch["rgb"], batch["rays"], batch["k4"])
    raise ValueError(f"Unknown architecture '{architecture}'")


def check_input_size(architecture: str, height: int, width: int) -> None:
    """Raise where ``architecture`` cannot take images of this size:
    ``depth_anything_v2`` needs multiples of its 14-pixel patch (the
    U-Nets take any size)."""
    if architecture == "depth_anything_v2":
        check_grid(height, width)


def count_parameters(model: nn.Module) -> int:
    """Total parameter count (batch statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())


def estimate_memory_mb(model: nn.Module, batch_size: int, height: int,
                       width: int, init_features: int = 64, levels: int = 5,
                       activation_bytes: int = 2,
                       tensors_per_block: int = 4) -> float:
    """Activation and parameter memory estimate in MB from the NHWC
    pyramid, the JAX factory's arithmetic: level l holds (H/2^l, W/2^l,
    f*2^l) activations in the encoder and the decoder (the bottleneck
    once), ``tensors_per_block`` live tensors a conv block of
    ``activation_bytes`` each; parameters fp32 with two fp32 Adam moments
    (x3). :func:`compiled_memory_analysis` measures one forward instead."""
    act = 0.0
    for lvl in range(levels + 1):  # encoder levels + bottleneck
        h, w = height >> lvl, width >> lvl
        c = init_features << lvl
        act += batch_size * h * w * c
    for lvl in range(levels):      # decoder mirrors the encoder
        h, w = height >> lvl, width >> lvl
        c = init_features << lvl
        act += batch_size * h * w * c
    act_bytes = act * tensors_per_block * activation_bytes
    param_bytes = count_parameters(model) * 4 * 3  # params + 2 Adam moments
    return (act_bytes + param_bytes) / (1024.0 * 1024.0)


def compiled_memory_analysis(model: nn.Module,
                             batch: Dict[str, torch.Tensor],
                             architecture: str) -> Dict[str, float]:
    """Memory of one eval-mode forward of ``model`` over ``batch``, in MB,
    with the keys of the JAX factory's: ``argument_mb`` (parameters,
    buffers and the model's inputs), ``output_mb``, ``temp_mb`` and their
    sum ``total_mb``.

    JAX reads XLA's plan of the compiled forward; eager PyTorch has no such
    plan, so this measures the caching allocator on the card: ``temp_mb``
    is the peak of ``torch.cuda.max_memory_allocated`` during the forward,
    under ``no_grad``, less the bytes allocated before it and less the
    output. It resets the device's peak statistics. Off the card it
    returns ``{}``, as JAX's does when XLA gives no analysis."""
    dev = next(model.parameters()).device
    if dev.type != "cuda":
        return {}
    args = model_inputs(architecture, batch)
    arg_bytes = sum(t.nbytes for t in model.parameters()) + \
        sum(t.nbytes for t in model.buffers()) + sum(t.nbytes for t in args)
    was_training = model.training
    model.eval()
    try:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            out = model(*args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - before
    finally:
        model.train(was_training)
    out_bytes = out.nbytes
    scale = 1.0 / (1024.0 * 1024.0)
    temp = max(peak - out_bytes, 0)
    return {
        "argument_mb": arg_bytes * scale,
        "output_mb": out_bytes * scale,
        "temp_mb": temp * scale,
        "total_mb": (arg_bytes + out_bytes + temp) * scale,
    }
