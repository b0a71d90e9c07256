#!/usr/bin/env python3
"""Drive cadepth_tpu_torch's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py                 # on a machine with the card
    python3 chip_smoke.py --cpu-rehearsal # tiny sizes on the CPU, plain warp

Where a phase counts launches, it also counts the training batch norm's
kernel calls (``warp_counts``' ``bn`` and ``bn_bwd``): one each way a
``BatchNorm2d`` a training step, none while serving or validating.

Phases, each fatal on failure:

1. the card: name and power limit from nvidia-smi; TF32 off for the f32
   comparisons;
2. build: every kernel under cadepth_tpu_torch/csrc, compiled by nvcc;
3. kernel against plain: the two-pass warp's one-launch forward, without
   V (serving) and storing V (training), against its plain PyTorch
   version at the five decoder shapes of the flagship (B=8, 240x320,
   init_features 64), f32 and bf16, five thetas and four general ones
   (90 degree rotation, zoom 0.3 and 3, a singular map with q = 0), both
   paddings, both align_corners;
4. serving: a Predictor over the flagship at full width (f=64, 240x320,
   batch 8, bf16 over fp32 parameters, seeded random weights with a
   rotating PCL head) answers N=8, N=3 and a stream of 4 requests; the
   warp's launch count must be exactly 1 per PCL per forward, with no V
   stored; the depths must be finite, inside (0, max_depth), and agree
   with the same model run with the plain warp on the card; a small f32
   model on the card must agree with the same model on the CPU;
5. times: per decoder level the serving forward (no V; CUDA events and
   its device time), its bound, the plain version and F.grid_sample's
   time; the Predictor's latency at batch 8 and batch 1; peak device
   memory;
6. backward against plain: the warp's three backward kernels (two
   transposed passes, then the theta partials' sum and the chain to
   d_theta on the card) against the plain backward at the five decoder
   shapes at the training batch (B=4), f32 and bf16, phase 3's thetas
   (the exact identity among them), both paddings, both align_corners;
   two runs give the same bits;
7. training: the flagship as geometry_aware_full ships it (f=64,
   240x320, batch 4, bf16 over fp32 parameters, AdamW, clip 1.0, the
   step schedule with warmup) takes 10 steps on seeded batches, then an
   eval step; logs finite, parameters and BN statistics moved, exactly 5
   forward launches (each storing V) and 15 backward launches per step,
   and the same steps with the plain warp give the same logs; the depth
   metrics of the eval step's inputs on the card against the CPU (log10
   with equal bits on single pixels);
8. a small f32 model takes 3 train steps on the card and on the CPU from
   the same weights and batches;
9. training times: per decoder level the training forward (storing V),
   the backward call (its three kernels, and the two passes alone),
   their bounds, the backward call's host time, the plain backward and
   the backward of F.grid_sample; the train step's p50/p95 and images/s,
   the device's busy share over 3 profiled steps, peak device memory;
10. the banded ("fused") warp's kernels against its plain versions: the
   one-launch forward, served and storing V, equal to the plain forward
   (max err 0) at the five decoder shapes at B=8; the backward's three
   kernels at B=4 against the plain backward on a CPU copy of the same
   tensors (two runs print the same errors), run twice for the same
   bits; f32 and bf16, the five thetas and a 0.2 rad rotation that lies
   outside the band at dec1;
11. serving with pcl_warp fused: a Predictor over phase 4's weights
   answers N=8 and N=3; exactly 1 fused_warp launch per PCL per forward,
   no V stored and no other warp launch; the depths agree with the same
   model run with the plain banded warp and with phase 4's two-pass
   depths (every
   served theta is in band, where the two are one function); per level
   the forward kernels' time, bound, plain and F.grid_sample time; the
   fused Predictor's latency at batch 8;
12. training with pcl_warp fused: 10 full-width steps at batch 4 with
   exactly 5 forward launches (each storing V) and 15 backward fused_warp
   launches per step (none of the two-pass warp), then the same steps
   with the plain banded warp;
13. the fused depth-loss op on phase 12's predicted depth and gt: its
   statistics and gradient kernels launched once each on that path,
   against their plain versions (the gradient at max error 0) and
   against scale_invariant_loss + reprojection_loss; a statistics call
   and a backward of its autograd Function (with a contiguous and a
   stride-0 cotangent) are one kernel each in their profiles (no index,
   copy, sum, fill or memset), two calls give the same bits;
14. fused times: the banded backward and training forward per level,
   the loss kernels beside the device time of an empty launch (the
   floor), the Function's backward as a whole call and a same-bytes
   elementwise pass beside the gradient kernel, the fused train step;
15. the banded affine warp's kernel (the port of pallas_affine_warp)
   against its plain version at the five decoder shapes, f32 and bf16,
   tests/test_pallas.py's four thetas and, at dec1, 0.35 and 0.6 rad
   rotations past its 16-row band: max error 0, one launch a call, the
   same bits twice; max_rotation_rows;
16. serving with pcl_warp gather, auto and separable over phase 4's
   weights: each mode's kernel launches per forward, its depths against
   phase 4's (auto equal to them, and equal to gather with the heads
   turned past its 0.05 bound), the banded affine warp on the gather
   forward's five PCL inputs (1 launch per call, counted) against its
   plain version (max error 0, the same bits twice) and the gather warp,
   each mode's latency and device profile, a small f32 model card
   against CPU;
17. training at full width, batch 4: gather for 10 steps, again with
   remat highres (losses against the run without, peak memory), auto and
   separable for 3 steps each; a flagship with norm group and
   decoder_upsample resize trained for 3 steps and served once;
18. times: the banded affine kernel per level against its bound, the
   floor of an empty launch, its plain version and F.grid_sample; the
   gather warp's device time per level, per forward and per train step;
19. the trainer loop on host data: 96 seeded structured scenes at
   240x320 written by the port's synthetic generator and packed by its
   pack_dataset; the port's train CLI (in process) trains
   geometry_aware_full as shipped from the pack for 2 epochs (4 producer
   threads, the shipped augmentation, a log line each step, validation
   capped at 32 samples, panels and a checkpoint each epoch): finite
   losses, training.log, a 13-column metrics.csv of 2 rows, step_*/ and
   best/ checkpoints, the panels in the TensorBoard files, and exactly 5
   forward launches storing V and 15 backward launches per train step and
   5 forward launches without V per validation and panel forward; the
   pipeline's first train batch and a validation epoch's batches on the
   card against the pack's get_batch on the CPU (the same bits); the
   loop's step p50/p95 and images/s against phase 9's bare step, the
   queue wait, the epochs' wall time, the producer, the copies' device
   time and overlap; --resume latest for a third epoch (epoch 2, step and
   optimizer updates carried over, a finite loss); the evaluate CLI on
   best/ (the capped validation set);
20. the GPU-resident feed: 512 seeded structured scenes at 240x320 (128
   a sensor) packed as in phase 19; DeviceDataset's batches on the card
   against the same class on the CPU (the same bits) over two epochs, in
   f32, bf16 and quantized storage, augmented (crop 0.6-1.0 as the b32
   config ships it, flip, jitter) and not, the f32 ones also against
   fast_batch; ChunkedDeviceDataset (chunks of 128, thread and serial)
   against DeviceDataset on the card; one batch's gather, decode and
   augmentation in device time against its bound; the upload's rate and
   nbytes(); the two-pass warp's forward and backward at batch 32 against
   their plain versions at the five decoder levels (phases 3 and 6's
   checks and tolerances) and their times; the train CLI on
   configs/train_config_flagship_b32.yaml (f=64, 240x320, batch 32, bf16,
   data.device_resident) for 2 epochs from the pack held on the card,
   counted (5 forward launches storing V and 15 backward launches a step),
   the loop's p50/p95/images/s, in turns with the bare step on held
   batches, the busy share and peak memory; --resume latest for a third
   epoch; the evaluate CLI on best/ sweeping the card and the host (equal
   per-sample metrics); configs/train_config.yaml at batch 4 fed from the
   card against phase 19's host pipeline, in turns;
21. the other model families, from configs/train_config.yaml as shipped
   (240x320, batch 8, bf16): its base model baseline_unet (f=64),
   ablation_film_only (IntrinsicsConditionedUNet, f=64), intrinsics_only
   (IntrinsicsAttentionUNet, f=64) and geometry_aware_lightweight (f=32,
   two_pass): 10 train steps each on seeded batches, finite, counted (the
   lightweight network: 4 forward launches storing V and 12 backward
   launches a step; the others none); a Predictor at batch 8 and 1
   (depths in range, 4 launches a forward for the lightweight network);
   step p50/p95 and images/s, the step's and the forward's device busy
   time and kernels, peak memory; a small f32 model of the family (f=8,
   64x64) trained 3 steps on the card and on the CPU. For the lightweight
   network also phases 3 and 6's checks at its four levels (f32, bf16),
   served depths against the plain warp, and the kernels' times at its
   levels. Then the train CLI on configs/train_config.yaml (baseline_unet)
   from phase 19's pack for one epoch, and the evaluate CLI on its best/;
22. serving from a checkpoint: Predictor.from_checkpoint on phase 20's
   run ("best" and "latest" at batch 8, "best" at batch 1) bit-equal to
   Predictors built from the same state dicts, 5 two-pass launches a
   forward; the torch.export program at batch 8 and 1 read back by
   load_exported, against predict (max error, limit 1e-3 m), its size,
   its launches, and its batch-8 p50 in turns with the eager forward;
   phase 11's pcl_warp fused model exported once; the infer CLI on a
   640x480 PNG and an intrinsics.txt (its three files, its .npy equal to a
   batch-1 Predictor on the same resized input);
23. data parallel on the card: (a) the flagship as phase 7 trains it
   (f=64, 240x320, batch 4, bf16, rotating PCL heads) for 10 steps
   without a process group and through the data-parallel path in an
   NCCL group of one, in turns (A B A B) with deterministic cuDNN: the
   logs, the parameters after step 10 and the BN running statistics
   equal bit for bit, the group's first run counted (5 forward launches
   storing V and 15 backward launches a step), both step p50s and
   3 profiled steps of each (device busy, kernels, NCCL); (b) two
   processes on the one card over Gloo with CUDA tensors (NCCL refuses
   two ranks on one device), the f32 flagship at full width, global
   batch 8 split 4 + 4, 3 steps, against one process over the global
   batch: total_loss to rtol 1e-5 (grad_norm while the parameters agree
   to 5e-3), the parameters' median within the bound of
   tests/test_torch_parallel.py and their largest difference within
   twice its sum(lr) (a sign flip at every step); (c)
   compiled_memory_analysis of the flagship's forward at batch 8 beside
   estimate_memory_mb; (d) the
   data-tool CLIs on phase 19's tree: validate, rays on the card, a pack
   that equals phase 19's byte for byte, then compare_models over phase
   21's and phase 19's evaluate outputs;
25. spatial parallelism (run after 23, before 24's line): (a) the
   two-pass kernels over windows of output rows, at the flagship's five
   decoder maps at the training batch cut into 2 and 4 windows, f32 and
   bf16, both paddings, phase 3's thetas: each window's forward and V
   equal to those rows of the whole forward (max error 0), the windows'
   backward summed equal to the whole backward (phase 6's tolerances),
   the same bits twice, the windowed plain versions; the windowed
   training forward and backward at dec1 for rank 0 of two bands in
   device time beside their bounds, plain versions and F.grid_sample on
   the window's rows; (b) two processes on the one card over Gloo
   (``chip_smoke.py --sp-worker RANK PORT DIR``) as one data row of two
   bands of 120 rows: the f32 flagship at full width, global batch 4, 3
   steps against one process: total_loss to rtol 1e-5, the parameters
   by phase 23b's rule, the worst parameter's gradient at the initial
   state within twice the largest distance of one process's over the
   batch reordered (or 1e-3), 5 forward launches storing V
   and 15 backward launches a step on each rank (the 3 PCLs of the
   banded levels on windows), each rank's peak device memory and the
   memory a forward holds for its backward beside one process's, the
   step p50 over Gloo on one card (no speed figure); (c) the Trainer's
   spatial branch on the two ranks, geometry_aware_full from phase 19's
   pack for one capped epoch: rank 0's checkpoint, finite validation
   metrics on both ranks;
26. the production configuration (run after 25): (a) the two-pass
   kernels at its five decoder maps at 8 images a card ((8, 480, 640, 96)
   down to (8, 30, 40, 1536)), bf16, phase 3's thetas, both paddings:
   the forward at max error 0, served and storing V, the backward within
   phase 6's limits; their device times beside their bounds, the plain
   versions and F.grid_sample's; then the train CLI on
   configs/train_config_production.yaml as it ships (geometry_aware,
   f=96, 480x640, two_pass, attention, bf16, cosine with 5 warmup
   epochs, crop 0.6-1.0), overridden only by --set (batch 8, the data
   and output paths, one epoch), on 24 seeded structured 640x480 scenes
   of the four sensors through the host feed: 3 steps, counted (5
   forward launches storing V and 15 backward launches a step),
   validation, panels, best/; the bare step's p50/p95 on held batches,
   the device's busy share over 2 loop steps, peak memory; (b) the
   capacity check (``cli/capacity_check.py``): 3 production steps, the
   peak against the card's memory plus a quarter of the quantized
   SUN RGB-D pack, the largest live allocations at a traced step's peak
   (``PEAK_ALLOC``/``PEAK_BY_FRAME`` lines) and the record
   (``CAPACITY`` line); (c) the conditioning probe
   (``cli/probe_conditioning.py``) on (a)'s best/: 4 forwards, 5 launches
   each, a finite report with delta_focal_x1.5_m > 0;
27. the training batch norm's kernels (``ops/batch_norm.py``, run after
   26) at the six norm map shapes of each training cell (the flagship
   at batch 32, the production network at 8), bf16 channels_last:
   ``batch_norm_train`` and its backward, as the model calls them, held
   to a float64 evaluation (y, the running statistics, dx, dweight and
   dbias each no further from it than the plain version on the card,
   plus one bf16 ulp; ``check_batch_norm``), then the forward and
   backward kernels' device time a call (3 + 3 launches) beside the
   bound (10 bytes an element: x read and y written, dy and x read and
   dx written), the plain version's, and F.batch_norm(training=True)'s
   forward and backward through autograd (the library's yardstick; the
   port never calls it);
28. Depth Anything V2-Large (metric, ``models/dinov2.py`` and
   ``models/dpt.py``) through the port's TrainStep at 8 frames of
   518x686, bf16 over float32 parameters: the step's time, its images
   a second, the peak, the SDPA backend that ran (by its kernels' names
   in a profiled step) and the attention's card time (its kernels', and
   the port's ``attn.fwd`` + ``attn.bwd`` spans), then the port against
   the plain float32 reference (``tests/reference_dav2.py``, TF32 off)
   at batch 2: in float32 within DAV2_F32_RTOL of the depth, in bf16
   within DAV2_BF16_DEV of the depths' own variation. ``--phase 28``
   runs phases 1, 2 and this one alone;
24. one JSON line describing every kernel (the two-pass warp's windowed
   launches under ``windowed``, the production maps' under
   ``production``, the batch norm's under ``batch_norm`` with its calls
   on every training path), the train
   steps, the Predictors, the
   trainer loop, the device feed, the families, the served checkpoints,
   the data-parallel and the spatial runs; the script's wall time; last,
   the ok line.

Every timing line carries the card's name and power limit. The script
exits non-zero, printing no result, when there is no card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
START = time.perf_counter()

# (name, theta) pairs of the kernel checks; "identity_noise" adds N(0, 0.01)
THETAS = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "identity_noise": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[0.8, 0, 0.1], [0, 1.2, -0.2]],
    "rotation": [[0.999, -0.03, 0.02], [0.03, 0.999, 0.01]],
    "shear": [[1.0, 0.1, 0.0], [0.05, 1.0, 0.0]],
}
# the two-pass warp's checks also take thetas whose transposed passes
# visit a whole row or column (|A| or |q| near 0) or next to nothing
GENERAL_THETAS = {
    "rotation_90": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0]],
    "zoom_0.3": [[0.3, 0.0, 0.05], [0.0, 0.3, -0.05]],
    "zoom_3": [[3.0, 0.0, 0.1], [0.0, 3.0, -0.1]],
    "q_zero": [[1.0, 0.5, 0.0], [0.5, 0.25, 0.0]],
}
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}  # bf16: a few ulps at |x| ~ 4
# backward, kernel vs plain: d_img at these atols times max(1, max|d_img|)
# (d_v's f32 sums run in another order, so a bf16 d_v can round the other
# way, one bf16 ulp ~ 0.8 % of the value), and d_theta divided by its
# largest |entry|
BWD_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
THETA_ATOL = {"float32": 1e-5, "bfloat16": 1e-3}
# losses and grad_norm of the bf16 flagship over its train steps, kernels
# vs the plain warp on the card: bf16 rounding (2^-8) of d_img and d_v
# that differs in a few elements, amplified by the round-off sensitivity
# of this network's gradient (tests/test_torch_train_step.py), and cuDNN's
# backward algorithms, which need not be deterministic (the kernels run
# twice give the noise floor)
TRAIN_RTOL = 1e-2
# the small f32 model's losses over 3 steps, card (kernels) vs CPU
CROSS_TRAIN_RTOL = 1e-4
STEPS_PER_EPOCH = 2  # 2 warmup epochs = 4 steps: lr 0, 2.5e-5, 5e-5, ...
# served depths, kernel vs plain warp, bf16 model (1/200 of max_depth)
SERVE_ATOL = 0.05
# the small f32 model, card (kernel) vs CPU (plain), TF32 off
CROSS_ATOL = 1e-3
PCL_BIAS = [1.04, 0.95, 0.03, -0.02, 0.04, 0.03]
# the out-of-band rotation of the fused checks (rad): outside the band at
# dec1 (240 x 320, column strips of 64)
ROT_OUT = 0.2
# the fused loss on the trained model's depth against
# scale_invariant_loss + reprojection_loss: f32 sums over 307,200 pixels
# in another order, and SILog's difference of two means
LOSS_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
TPU_KERNEL = "cadepth_tpu/ops/pallas/two_pass_warp.py"
# the two-pass warp's kernels (substrings of their names in a profile)
TWO_PASS_FWD_KEYS = ("two_pass_fwd_kernel",)
TWO_PASS_BWD_KEYS = ("two_pass_bwd_h_kernel", "two_pass_bwd_v_kernel",
                     "two_pass_theta_kernel")
FUSED_KERNEL = "cadepth_tpu/ops/pallas/fused_warp.py"
# the banded warp's kernels (its transposed pass H and theta kernel are
# the two-pass warp's, launched from its own library)
FUSED_FWD_KEYS = ("fused_fwd_kernel",)
FUSED_BWD_KEYS = ("two_pass_bwd_h_kernel", "fused_bwd_v_kernel",
                  "two_pass_theta_kernel")
# compute_depth_metrics, card against CPU: f32 sums over the pixels in
# another order
METRICS_RTOL = 1e-5
LOSS_KERNEL = "cadepth_tpu/ops/pallas/fused_loss.py"
AFFINE_KERNEL = "cadepth_tpu/ops/pallas/affine_warp.py"
# the banded affine warp's checks: tests/test_pallas.py's four thetas
BANDED_THETAS = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[1.3, 0, 0.2], [0, 0.7, -0.3]],
    "rotation": [[0.999, -0.037, 0], [0.037, 0.999, 0.0]],
    "oob_translate": [[1, 0, 0.9], [0, 1, 0.9]],
}
# rotations (rad) past the banded affine warp's 16-row band at dec1
ROT_BAND_OUT = (0.35, 0.6)
# the banded affine warp against the gather warp on the PCL inputs, f32:
# tests/test_pallas.py's 5e-4 at N(0, 1) data, scaled by max|input| (the
# two write the f32 positions with other operations)
BANDED_VS_GATHER = 5e-4
# auto's fallback: a head rotation (rad) past its bound of 0.05
ROT_PAST_BOUND = 0.08
# the banded affine warp against its plain version, f32 and bf16: the
# same f32 operations and taps in the same order, so the same bits
BANDED_ATOL = 0.0
# the fused loss's gradient kernel against its plain version, f32: the
# same elementwise expressions, so the same bits
GRAD_ATOL = 0.0


def log(*parts) -> None:
    print(*parts, flush=True)


def phase(title: str) -> None:
    log(f"== {title}  [{time.perf_counter() - START:.0f} s]")


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def flagship_config(init_features: int, height: int, width: int,
                    batch: int = 8, pcl_warp: str = "two_pass",
                    norm: str = "batch", decoder_upsample: str = "transpose",
                    remat=False):
    from cadepth_tpu_torch.config import config_from_dict

    # the geometry_aware_full experiment of configs/train_config.yaml, with
    # the shipped defaults written out (its training batch is 4; serving
    # here runs at 8); pcl_warp, norm, decoder_upsample and remat select
    # the model options
    return config_from_dict({
        "model": {"architecture": "geometry_aware", "variant": "full",
                  "init_features": init_features, "use_pcl": True,
                  "use_attention": True, "pcl_warp": pcl_warp,
                  "norm": norm, "decoder_upsample": decoder_upsample,
                  "sa_lowering": "toeplitz", "remat": remat},
        "data": {"input_height": height, "input_width": width,
                 "compute_rays": True},
        "training": {"use_amp": True, "batch_size": batch},
        "optimization": {"optimizer": "adamw", "learning_rate": 1e-4,
                         "weight_decay": 1e-5, "lr_scheduler": "step",
                         "lr_warmup_epochs": 2, "gradient_clip": True,
                         "gradient_clip_value": 1.0},
        "experiment": {"name": "geometry_aware_full"},
    })


def decoder_shapes(batch: int, height: int, width: int, f: int,
                   levels: int = 5):
    """(level, (B, H, W, C)) of the map each PCL warps: decoder level k
    upsamples to 2 * (size // 2**k) with f * 2**(k-1) channels (levels 5
    to 1 in the flagship, 4 to 1 in the lightweight network)."""
    return [(f"dec{k}", (batch, 2 * (height >> k), 2 * (width >> k),
                         f << (k - 1))) for k in range(levels, 0, -1)]


def pcl_layers(model):
    from cadepth_tpu_torch.models.pcl import PerspectiveCorrectionLayer

    return [m for m in model.modules()
            if isinstance(m, PerspectiveCorrectionLayer)]


def rotate_pcl_heads(model, generator) -> None:
    """Give every PCL head a small random kernel and a bias that zooms,
    shifts, rotates and shears, so the warps do real work."""
    import torch

    with torch.no_grad():
        for pcl in pcl_layers(model):
            w = torch.empty(pcl.fc_transform.weight.shape)
            w.normal_(0.0, 0.002, generator=generator)
            pcl.fc_transform.weight.copy_(w)
            pcl.fc_transform.bias.copy_(torch.tensor(PCL_BIAS))


class Timer:
    """Mean milliseconds of fn() over ``iters`` calls after ``warmup``:
    CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters: int = 50, warmup: int = 5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1000.0 / iters


def two_pass_thetas(device, b: int, gen):
    """(name, theta) of the two-pass checks: THETAS and GENERAL_THETAS."""
    import torch

    out = []
    for tname, th in dict(THETAS, **GENERAL_THETAS).items():
        theta = torch.tensor(th, device=device).expand(b, 2, 3).contiguous()
        if tname == "identity_noise":
            theta = theta + 0.01 * torch.randn(b, 2, 3, device=device,
                                               generator=gen)
        out.append((tname, theta))
    return out


def check_kernel(device, shapes, seed: int,
                 dtypes=("float32", "bfloat16")):
    """Phase 3: the one-launch forward against its plain version, as
    served (no V) and as trained (V stored, and equal to the plain V), in
    each of ``dtypes``. Returns the max error per dtype."""
    import torch

    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_fwd,
    )

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {name: 0.0 for name in dtypes}
    for level, shape in shapes:
        b = shape[0]
        img32 = torch.randn(shape, device=device, generator=gen)
        for name in dtypes:
            dtype = getattr(torch, name)
            img = img32.to(dtype)
            for pad in ("zeros", "border"):
                for ac in (False, True):
                    errs = []
                    for tname, theta in two_pass_thetas(device, b, gen):
                        before, stores = warp.launches, warp.v_stores
                        got = warp.two_pass_warp(img, theta, pad, ac)
                        out, v = warp._forward(img, theta, pad, ac,
                                               keep_v=True)
                        if cuda:
                            torch.cuda.synchronize()
                            if warp.launches != \
                                    before + 2 * warp.LAUNCHES_PER_CALL or \
                                    warp.v_stores != stores + 1:
                                raise AssertionError(
                                    "two_pass_warp did not count its "
                                    "launches and V stores")
                        want, want_v = two_pass_affine_warp_plain_fwd(
                            img, theta, pad, ac)
                        if cuda:
                            torch.cuda.synchronize()
                        err = max((a.float() - w.float()).abs().max().item()
                                  for a, w in ((got, want), (out, want),
                                               (v, want_v)))
                        if not err <= ATOL[name]:
                            raise AssertionError(
                                f"kernel vs plain {level} {tuple(shape)} "
                                f"{name} {pad} align_corners={ac} {tname}: "
                                f"max err {err} > {ATOL[name]}")
                        errs.append(f"{tname}={err:.3g}")
                        worst[name] = max(worst[name], err)
                    log(f"  {level} {tuple(shape)} {name:8s} {pad:6s} "
                        f"ac={int(ac)} max|err| (served, trained, V) "
                        + " ".join(errs) + f"  (atol {ATOL[name]})")
    return worst


def serve(device, args):
    """Phase 4: the flagship Predictor at full width. Returns what phases
    5 and 6 need."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.geometry.rays import ray_grid_batch
    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import two_pass_affine_warp_plain

    f, h, w, bsz = args.init_features, args.height, args.width, args.batch
    cfg = flagship_config(f, h, w)
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    pred = Predictor(cfg, batch_size=bsz, device=device, generator=gen)
    rotate_pcl_heads(pred.model, gen)
    log(f"  Predictor built in {time.perf_counter() - t0:.1f} s: "
        f"geometry_aware full, init_features {f}, {h}x{w}, batch {bsz}, "
        f"bf16 compute over fp32 parameters, "
        f"{sum(p.numel() for p in pred.model.parameters()):,} parameters")

    # record what each warp is given on the main path
    seen = []
    pcls = pcl_layers(pred.model)

    def recording(fn):
        def wrapped(img, theta, padding_mode, align_corners):
            seen.append((tuple(img.shape), img.dtype, img.is_contiguous()))
            return fn(img, theta, padding_mode, align_corners)
        return wrapped

    for pcl in pcls:
        pcl.warp = recording(warp.two_pass_warp)

    rng = np.random.default_rng(args.seed)
    rgb8 = rng.uniform(0, 1, (bsz, h, w, 3)).astype(np.float32)
    k = np.tile(np.eye(3, dtype=np.float32), (bsz, 1, 1))
    k[:, 0, 0] = rng.uniform(0.8, 1.2, bsz) * w
    k[:, 1, 1] = k[:, 0, 0]
    k[:, 0, 2], k[:, 1, 2] = w / 2.0, h / 2.0
    rgb3 = rgb8[:3]  # padded to the batch
    m = min(2, bsz)
    rows = [i % (bsz - m + 1) for i in range(4)]
    stream = [(rgb8[j:j + m], k[j:j + m]) for j in rows]

    # the main path, counted
    warp.launches = warp.v_stores = 0
    depth8 = pred.predict(rgb8, k)
    depth3 = pred.predict(rgb3, k[:3])
    streamed = list(pred.predict_stream(iter(stream), depth=2))
    launches = warp.launches
    forwards = 2 + len(stream)
    per_forward = warp.LAUNCHES_PER_CALL * len(pcls)
    expected = per_forward * forwards if device.type == "cuda" else 0
    log(f"  main path: {forwards} forwards, two_pass_warp launches "
        f"{launches} (expected {expected} = {per_forward} per forward), "
        f"V stored by {warp.v_stores} of them (expected 0)")
    if launches != expected or warp.v_stores:
        raise AssertionError(f"launch count {launches} != {expected}, or "
                             f"{warp.v_stores} launches stored V")
    want_shapes = [s for _, s in decoder_shapes(bsz, h, w, f)]
    got_shapes = [s for s, _, _ in seen[:len(pcls)]]
    if got_shapes != [tuple(s) for s in want_shapes]:
        raise AssertionError(f"warp shapes {got_shapes} != {want_shapes}")
    if not all(c and d == torch.bfloat16 for _, d, c in seen):
        raise AssertionError(f"warp inputs not contiguous bf16 NHWC: {seen}")
    log(f"  warp inputs on the main path: {got_shapes}, bf16, contiguous NHWC")

    max_depth = cfg.model.max_depth
    for name, d, n in [("N=8", depth8, bsz), ("N=3", depth3, 3)] + [
            (f"stream[{i}]", s, m) for i, s in enumerate(streamed)]:
        if d.shape != (n, h, w, 1) or d.dtype != np.float32:
            raise AssertionError(f"{name}: shape {d.shape} {d.dtype}")
        if not (np.isfinite(d).all() and d.min() > 0 and d.max() < max_depth):
            raise AssertionError(f"{name}: depth outside (0, {max_depth}): "
                                 f"[{d.min()}, {d.max()}]")
    # padded and streamed requests hold rows of the N=8 request
    for name, d, want in [("N=3", depth3, depth8[:3])] + [
            (f"stream[{i}]", s, depth8[j:j + m])
            for i, (j, s) in enumerate(zip(rows, streamed))]:
        err = float(np.abs(d - want).max())
        if not err <= SERVE_ATOL:
            raise AssertionError(f"{name} differs from the N=8 rows by {err}")
    log(f"  depths finite, in [{depth8.min():.4f}, {depth8.max():.4f}] m "
        f"inside (0, {max_depth}); N=3 and stream answers agree with N=8")

    # the same model with the plain warp, on the card
    for pcl in pcls:
        pcl.warp = two_pass_affine_warp_plain
    depth8_plain = pred.predict(rgb8, k)
    for pcl in pcls:
        pcl.warp = warp.two_pass_warp
    serve_err = float(np.abs(depth8 - depth8_plain).max())
    log(f"  served depth, kernel vs plain warp: max|err| {serve_err:.3g} m "
        f"(atol {SERVE_ATOL})")
    if not serve_err <= SERVE_ATOL:
        raise AssertionError(f"kernel-served depth differs from plain by "
                             f"{serve_err}")

    record = {}
    batch = pred._make_batch(rgb8, k)
    with torch.inference_mode():
        pred.model(batch["rgb"], ray_grid_batch(batch["intrinsics"], h, w),
                   batch["k4"], record)
    rots = [float(r) for r in record["pcl_max_rot"]]
    log("  pcl_max_rot per level (dec5..dec1): "
        + ", ".join(f"{r:.4f}" for r in rots) + " rad")
    return pred, launches, per_forward, serve_err, (rgb8, k, depth8)


def cross_device(device, args, mode: str = "two_pass") -> float:
    """A small f32 flagship with ``pcl_warp: mode`` on the card (kernels,
    where the mode has them) against the same model on the CPU (plain)."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.config import config_from_dict
    from cadepth_tpu_torch.inference import Predictor

    raw = {"model": {"architecture": "geometry_aware", "init_features": 8,
                     "pcl_warp": mode},
           "data": {"input_height": 64, "input_width": 96},
           "training": {"use_amp": False}}
    preds = []
    for dev in ("cpu", device):
        gen = torch.Generator().manual_seed(args.seed + 1)
        p = Predictor(config_from_dict(raw), batch_size=2, device=dev,
                      generator=gen)
        rotate_pcl_heads(p.model, gen)
        preds.append(p)
    rgb = np.random.default_rng(args.seed + 1).uniform(
        0, 1, (2, 64, 96, 3)).astype(np.float32)
    ref, got = (p.predict(rgb) for p in preds)
    err = float(np.abs(got - ref).max())
    log(f"  small f32 model (f=8, 64x96, B=2, pcl_warp {mode}), {device} vs "
        f"cpu: max|err| {err:.3g} m (atol {CROSS_ATOL})")
    if not err <= CROSS_ATOL:
        raise AssertionError(f"card and CPU disagree by {err}")
    return err


def device_ms(fn, iters: int, kernels=(), launches: int = 0,
              attempts: int = 3):
    """Device time per call of fn(): the kernels' own durations summed by
    torch.profiler over ``iters`` calls, or None where the profiler sees
    no device time. Also returns {kernel name: ms per call}.

    Where ``kernels`` (substrings of kernel names) is given, fn() makes
    ``launches`` launches of those kernels a call, and their time per
    call is their mean over the launches the profile holds times
    ``launches``: a profile that lost records would otherwise read short
    by their share (spin kernels at the ends of each profile take the
    records the profiler drops there). A profile
    holding fewer than 90 % of ``iters * launches`` of them, or more, is
    taken again, and after ``attempts`` such profiles the call raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want = iters * launches
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the profiler drops a few records at the ends of a session
            # (up to 11 of 100 launches a profile, with no gap between
            # those it held): 32 spin kernels on either side, left out
            # below, take the loss
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in device_events(prof)
                  if "spin_kernel" not in e[2]]
        counts = {key: count for _, count, key in events
                  if any(k in key for k in kernels)}
        seen = sum(counts.values())
        if seen != want:
            log(f"  torch.profiler holds {seen} launches of "
                f"{'/'.join(kernels)} in {iters} calls, want {want} "
                f"(profile {attempt} of {attempts}): "
                + ", ".join(f"{n} x {key[:60]}" for key, n in counts.items()))
        if not kernels or 0.9 * want <= seen <= want:
            break
    else:
        raise AssertionError(f"torch.profiler held too few or too many "
                             f"launches of {'/'.join(kernels)} in "
                             f"{attempts} profiles")
    per_kernel = {key: us / 1000.0 * (launches / seen if key in counts
                                      else 1.0 / iters)
                  for us, _, key in events}
    total = sum(per_kernel.values())
    return (total if total > 0 else None), per_kernel


def device_events(prof):
    """[(device us, launches, kernel name)] summed over a profile's
    device-side events."""
    import torch

    out = []
    for e in prof.key_averages():
        # user annotations (the optimizer's step) span kernels on the
        # device's timeline; they are not kernels of their own
        if getattr(e, "is_user_annotation", False) or \
                e.key.startswith("Optimizer."):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            out.append((e.self_device_time_total, e.count, e.key))
    return out


def device_rows(prof, calls: int):
    """[(device ms per call, launches per call, kernel name)] of the
    device-side events of a profile, longest first."""
    return sorted(((us / 1000.0 / calls, count // calls, key)
                   for us, count, key in device_events(prof)), reverse=True)


def profile_forward(pred, card: str, forwards: int = 3,
                    warp_keys=TWO_PASS_FWD_KEYS,
                    warp_name: str = "two_pass_warp"):
    """Where a batch's forward spends the card's time: device time by
    kernel and the device's busy share of the wall time; the warp is the
    kernels whose names hold one of ``warp_keys``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = pred._make_batch(np.random.default_rng(0).uniform(
        0, 1, (pred.batch_size, pred.height, pred.width, 3))
        .astype(np.float32), None)
    pred._predict(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            pred._predict(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0 / forwards
    rows = device_rows(prof, forwards)
    busy = sum(r[0] for r in rows)
    warp_ms = sum(r[0] for r in rows if any(k in r[2] for k in warp_keys))
    log(f"  [{card}] profile of a batch-{pred.batch_size} forward "
        f"(torch.profiler, {forwards} forwards): device busy {busy:.3f} ms "
        f"of {wall_ms:.3f} ms wall ({busy / wall_ms:.1%}), "
        f"{sum(r[1] for r in rows)} kernels per forward; {warp_name} "
        f"{warp_ms:.3f} ms ({warp_ms / busy:.1%} of busy)" if busy else
        f"  [{card}] profile: no device time seen (not measured)")
    for ms, count, key in rows[:12]:
        log(f"    {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} {key[:90]}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "warp_ms": warp_ms,
            "kernels_per_forward": sum(r[1] for r in rows)}


def times(device, args, pred, card: str):
    """Phase 5: per-level warp times and the Predictor's latency."""
    import torch

    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import two_pass_affine_warp_plain

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    rows, total = level_times(device, args, card, "two_pass_warp",
                              warp.two_pass_warp, two_pass_affine_warp_plain,
                              warp, TWO_PASS_FWD_KEYS)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bench = pred.benchmark(iterations=args.bench_iters, warmup=5)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    log(f"  [{card}] Predictor batch {args.batch}: p50 {bench['p50_ms']:.3f} "
        f"ms, p95 {bench['p95_ms']:.3f} ms, p99 {bench['p99_ms']:.3f} ms, "
        f"{bench['images_per_sec']:.2f} images/s "
        f"({args.bench_iters} requests, host clock to the read-back){unit}")
    prof = profile_forward(pred, card) if cuda else None
    single = Predictor(pred.cfg, pred.model.state_dict(), batch_size=1,
                       device=device)
    one = single.benchmark(iterations=args.bench_iters, warmup=5)
    log(f"  [{card}] Predictor batch 1: p50 {one['p50_ms']:.3f} ms, "
        f"p95 {one['p95_ms']:.3f} ms{unit}")
    if cuda:
        profile_forward(single, card)
    if peak is not None:
        log(f"  [{card}] peak device memory while serving batch "
            f"{args.batch}: {peak / 2**30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated)")
    return rows, total, bench, one, peak, prof


def level_times(device, args, card: str, name: str, kernel, plain, counted,
                kernel_keys, flops_per_elem: int = 6, shapes=None):
    """Per decoder level at the serving batch (bf16, the rotation theta):
    ``kernel`` (CUDA events over back-to-back calls, and the device time
    of its launches from torch.profiler), its bound, ``plain`` and
    F.grid_sample(F.affine_grid(theta)). ``counted`` is the wrapper module
    whose ``launches`` the kernel moves, ``kernel_keys`` substrings of its
    kernels' names, which the profile must hold ``counted.LAUNCHES_PER_CALL``
    times a call; ``flops_per_elem`` the f32
    operations per output element (6 for the two-pass warp: two taps, a
    multiply-add each, per pass); ``shapes`` the (level, shape) pairs,
    the flagship's five decoder levels at the serving batch unless given.
    Returns (rows, all-level sums)."""
    import torch
    import torch.nn.functional as F

    cuda = device.type == "cuda"
    timer = Timer(device)
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    shapes = shapes or decoder_shapes(args.batch, args.height, args.width,
                                      args.init_features)
    theta = (torch.tensor(THETAS["rotation"], device=device)
             .expand(shapes[0][1][0], 2, 3).contiguous())
    rows = {}
    for level, shape in shapes:
        img = torch.randn(shape, device=device, generator=gen) \
            .to(torch.bfloat16)
        nchw = img.permute(0, 3, 1, 2)  # channels_last NCHW view
        elems = img.numel()
        bytes_moved = 2 * elems * img.element_size()
        flops = flops_per_elem * elems
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                       flops / F32_FLOPS_PER_S) * 1e3
        bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= \
            flops / F32_FLOPS_PER_S else "operations"
        iters = args.timing_iters
        calls = {
            "kernel": lambda: kernel(img, theta),
            "plain": lambda: plain(img, theta),
            "library": lambda: F.grid_sample(
                nchw, F.affine_grid(theta.to(img.dtype), list(nchw.shape),
                                    align_corners=False),
                mode="bilinear", padding_mode="zeros", align_corners=False),
        }
        row = dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=bytes_moved)
        for key, fn in calls.items():
            n = iters if key != "plain" else max(iters // 10, 2)
            before = counted.launches
            row[f"{key}_wall_ms"] = timer(fn, n, 2)
            if key == "kernel" and cuda and counted.launches == before:
                raise AssertionError(f"timing loop did not launch {name}")
            expect = dict(kernels=kernel_keys,
                          launches=counted.LAUNCHES_PER_CALL) \
                if key == "kernel" else {}
            row[f"{key}_ms"] = device_ms(fn, n, **expect)[0] if cuda else None
        rows[level] = row

        def fmt(key):
            dev = row[f"{key}_ms"]
            return (f"{dev:.4f} ms device" if dev is not None
                    else "device not measured") + \
                f" / {row[f'{key}_wall_ms']:.4f} ms wall"
        share = (f", {bound_ms / row['kernel_ms']:.1%} of bound"
                 if row["kernel_ms"] else "")
        log(f"  [{card}] {level} {shape} bf16 {name}: kernel {fmt('kernel')}; "
            f"bound {bound_ms * 1e3:.1f} us ({bound_by}, "
            f"{bytes_moved / 1e6:.1f} MB){share}; plain {fmt('plain')}; "
            f"grid_sample {fmt('library')}{unit}")
    keys = [k for k in rows["dec1"] if k.endswith("_ms")]
    total = {k: (None if any(r[k] is None for r in rows.values())
                 else sum(r[k] for r in rows.values())) for k in keys}
    log(f"  [{card}] {name}, all {len(rows)} levels per forward: "
        + ", ".join(f"{k} {v:.4f}" for k, v in total.items()
                    if v is not None) + unit)
    return rows, total


def synthetic_batch(rng, batch: int, height: int, width: int, device):
    """A seeded training batch: rgb in (0, 1), gt depth in (0, 10) with
    ~10 % of the pixels at or below the 0.1 m validity floor, a distinct
    K per sample."""
    import numpy as np
    import torch

    depth = rng.uniform(0.3, 9.5, (batch, height, width, 1)).astype(np.float32)
    low = rng.uniform(0, 1, depth.shape) < 0.1
    depth[low] = rng.uniform(0.0, 0.1, int(low.sum()))
    k = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1))
    k[:, 0, 0] = rng.uniform(0.5, 1.5, batch) * width
    k[:, 1, 1] = rng.uniform(0.5, 1.5, batch) * width
    k[:, 0, 2] = rng.uniform(0.3, 0.7, batch) * width
    k[:, 1, 2] = rng.uniform(0.3, 0.7, batch) * height
    rgb = rng.uniform(0, 1, (batch, height, width, 3)).astype(np.float32)
    b = {"rgb": rgb, "depth": depth, "intrinsics": k,
         "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1)}
    return {key: torch.from_numpy(v).to(device) for key, v in b.items()}


def check_backward(device, shapes, seed: int,
                   dtypes=("float32", "bfloat16")):
    """Phase 6: the backward kernels against the plain backward, and two
    runs of them against each other (the same bits), in each of
    ``dtypes``. Returns the worst errors: d_img per dtype, and d_theta
    over its largest |entry|."""
    import torch

    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_bwd,
        two_pass_affine_warp_plain_fwd,
    )

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    worst = dict({name: 0.0 for name in dtypes}, d_theta=0.0)
    for level, shape in shapes:
        b = shape[0]
        img32 = torch.randn(shape, device=device, generator=gen)
        grad32 = torch.randn(shape, device=device, generator=gen)
        for name in dtypes:
            dtype = getattr(torch, name)
            img, grad = img32.to(dtype), grad32.to(dtype)
            for pad in ("zeros", "border"):
                for ac in (False, True):
                    errs = []
                    for tname, theta in two_pass_thetas(device, b, gen):
                        _, v = two_pass_affine_warp_plain_fwd(img, theta, pad,
                                                              ac)
                        before = warp.bwd_launches
                        got = warp.two_pass_warp_bwd(img, v, theta, grad, pad,
                                                     ac)
                        if cuda:
                            torch.cuda.synchronize()
                            if warp.bwd_launches != \
                                    before + warp.BWD_LAUNCHES_PER_CALL:
                                raise AssertionError("two_pass_warp_bwd did "
                                                     "not count its launches")
                        want = two_pass_affine_warp_plain_bwd(img, v, theta,
                                                              grad, pad, ac)
                        scale = max(1.0, want[0].float().abs().max().item())
                        err = (got[0].float() - want[0].float()).abs().max() \
                            .item()
                        t_err = ((got[1] - want[1]).abs().max()
                                 / want[1].abs().max().clamp_min(1e-12)).item()
                        if not (err <= BWD_ATOL[name] * scale
                                and t_err <= THETA_ATOL[name]):
                            raise AssertionError(
                                f"backward kernel vs plain {level} "
                                f"{tuple(shape)} {name} {pad} align_corners="
                                f"{ac} {tname}: d_img err {err} (atol "
                                f"{BWD_ATOL[name]} x {scale:.3g}), d_theta "
                                f"err {t_err} (atol {THETA_ATOL[name]})")
                        if tname == "rotation" and not ac:
                            again = warp.two_pass_warp_bwd(img, v, theta, grad,
                                                           pad, ac)
                            if not (torch.equal(again[0], got[0])
                                    and torch.equal(again[1], got[1])):
                                raise AssertionError(
                                    f"backward {level} {name} {pad}: two runs "
                                    "differ")
                        errs.append(f"{tname}={err:.3g}/{t_err:.2g}")
                        worst[name] = max(worst[name], err)
                        worst["d_theta"] = max(worst["d_theta"], t_err)
                    log(f"  {level} {tuple(shape)} {name:8s} {pad:6s} "
                        f"ac={int(ac)} max|d_img err|/rel d_theta err "
                        + " ".join(errs))
    log("  the rotation's backward, run twice at each level, dtype and "
        "padding: the same bits")
    return worst


def plain_warp_function(mode: str = "two_pass"):
    """The warp of ``mode`` ("two_pass" or "fused") with the plain forward
    and the plain backward, as an autograd Function: the reference of the
    training phases for the kernels."""
    import torch

    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_bwd,
        two_pass_affine_warp_plain_fwd,
    )

    if mode == "fused":
        fwd = lambda img, th, pad, ac: fw.fused_warp_plain_fwd(  # noqa: E731
            img, th, ac)
        bwd = lambda img, v, th, g, pad, ac: fw.fused_warp_plain_bwd(  # noqa: E731
            img, v, th, g, ac)
    else:
        fwd, bwd = two_pass_affine_warp_plain_fwd, \
            two_pass_affine_warp_plain_bwd

    class PlainWarp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, img, theta, padding_mode, align_corners):
            out, v = fwd(img, theta, padding_mode, align_corners)
            ctx.save_for_backward(img, v, theta)
            ctx.args = (padding_mode, align_corners)
            return out

        @staticmethod
        def backward(ctx, grad):
            img, v, theta = ctx.saved_tensors
            d_img, d_theta = bwd(img, v, theta, grad.contiguous(), *ctx.args)
            return d_img, d_theta, None, None

    return lambda img, theta, pad, ac: PlainWarp.apply(img, theta, pad, ac)


def train(device, args, mode: str = "two_pass", steps=None):
    """Phase 7 (and 13): the flagship with ``pcl_warp: mode`` takes
    ``steps`` train steps at full width, then its eval step, and the same
    steps with the plain warp swapped in."""
    import math

    import numpy as np
    import torch

    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    # the wrapper the mode's PCLs call, and the other one, which must
    # launch nothing
    warp, other = (fw, tpw) if mode == "fused" else (tpw, fw)
    kernel_warp = fw.fused_warp if mode == "fused" else tpw.two_pass_warp
    name = "fused_warp" if mode == "fused" else "two_pass_warp"
    steps = steps or args.train_steps
    f, h, w, bsz = args.init_features, args.height, args.width, \
        args.train_batch
    cfg = flagship_config(f, h, w, bsz, mode)
    gen = torch.Generator().manual_seed(args.seed + 3)
    model, loss_fn = ts.build_model_and_loss(cfg, device=device,
                                             generator=gen)
    rotate_pcl_heads(model, gen)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = cfg.optimization
    schedule = build_lr_schedule(opt, STEPS_PER_EPOCH, cfg.training.num_epochs)
    lrs = [schedule(s) for s in range(steps)]
    log(f"  flagship f={f}, {h}x{w}, batch {bsz}, bf16 over fp32 "
        f"parameters; {opt.optimizer}, weight decay {opt.weight_decay}, clip "
        f"{opt.gradient_clip_value}, {opt.lr_scheduler} schedule with "
        f"{opt.lr_warmup_epochs} warmup epochs of {STEPS_PER_EPOCH} steps: "
        f"lr {', '.join(f'{x:.3g}' for x in lrs)}")
    rng = np.random.default_rng(args.seed + 4)
    batches = [synthetic_batch(rng, bsz, h, w, device) for _ in range(steps)]

    def run(warp_fn):
        model.load_state_dict(init)
        for pcl in pcl_layers(model):
            pcl.warp = warp_fn
        step = ts.make_train_step(cfg, model, loss_fn,
                                  ts.build_optimizer(opt, model.parameters()),
                                  schedule)
        return [step(b) for b in batches], step

    # the main path, counted
    reset_warp_counts()
    logs, step = run(kernel_warp)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches, bwd_launches = warp.launches, warp.bwd_launches
    norms = warp_counts()
    grad_copies, v_stores = warp.grad_copies, warp.v_stores
    logs = [{k: float(v) for k, v in x.items()} for x in logs]
    n_pcl = len(pcl_layers(model))
    per_step = warp.LAUNCHES_PER_CALL * n_pcl
    bwd_per_step = warp.BWD_LAUNCHES_PER_CALL * n_pcl
    cuda = device.type == "cuda"
    want = per_step * steps if cuda else 0
    want_bwd = bwd_per_step * steps if cuda else 0
    # the forward stores V once per training call
    want_v = n_pcl * steps if cuda else 0
    log(f"  main path: {steps} train steps, {name} launches {launches} "
        f"(expected {want} = {per_step} per step), {name}_bwd launches "
        f"{bwd_launches} (expected {want_bwd} = {bwd_per_step} per step); "
        f"{name} V stores {v_stores} (expected {want_v}); "
        f"{grad_copies} of {n_pcl * steps} backward calls copied "
        "a non-contiguous incoming gradient")
    want_bn = norm_counts(model, steps, cuda)
    norms = {k: norms[k] for k in want_bn}
    log(f"  main path: batch norm kernel calls {norms} (expected "
        f"{want_bn}: {training_norms(model)} training norms a step)")
    if launches != want or bwd_launches != want_bwd or v_stores != want_v:
        raise AssertionError(f"launch counts {launches}, {bwd_launches}, "
                             f"V stores {v_stores} != {want}, {want_bwd}, "
                             f"{want_v}")
    if norms != want_bn:
        raise AssertionError(f"batch norm calls {norms} != {want_bn}")
    if other.launches or other.bwd_launches or other.v_stores:
        raise AssertionError(f"pcl_warp {mode} launched the other warp's "
                             "kernels")
    for i, x in enumerate(logs):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in x.items()))
        if not all(math.isfinite(v) for v in x.values()):
            raise AssertionError(f"step {i}: non-finite logs {x}")
    after = model.state_dict()
    moved = {k: (after[k].float() - init[k].float()).abs().max().item()
             for k in init if not k.endswith("num_batches_tracked")}
    params = {k for k, _ in model.named_parameters()}
    p_moved = max(v for k, v in moved.items() if k in params)
    s_moved = min(v for k, v in moved.items() if "running" in k)
    log(f"  parameters moved by up to {p_moved:.3g}; every BN running "
        f"statistic moved (least max change {s_moved:.3g})")
    if not (p_moved > 0 and s_moved > 0):
        raise AssertionError("the train steps left the parameters or the "
                             "BN statistics as they were")

    ev = ts.make_eval_step(cfg, model, loss_fn)(batches[0])
    ev = {k: float(v) for k, v in ev.items()}
    log("  eval step: " + ", ".join(f"{k} {v:.5g}" for k, v in ev.items()))
    if len(ev) != 18 or not all(math.isfinite(v) for v in ev.values()) \
            or not ev["pcl_max_rot"] > 0:
        raise AssertionError(f"eval step: {ev}")

    def rel_diff(other):
        """[{log key: relative difference from ``logs``} per step]"""
        other = [{k: float(v) for k, v in x.items()} for x in other]
        return [{k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in a}
                for a, b in zip(logs, other)]

    # the kernels again (the run-to-run noise floor of the bf16 step), then
    # the plain warp, forward and backward
    again = rel_diff(run(kernel_warp)[0])
    plain = rel_diff(run(plain_warp_function(mode))[0])
    for label, d in (("kernels again", again), ("plain warp", plain)):
        log(f"  the same {steps} steps, {label}: max relative "
            "log differences " + ", ".join(
                f"{k} {max(x[k] for x in d):.3g}" for k in d[0])
            + "; grad_norm by step " + " ".join(f"{x['grad_norm']:.2g}"
                                                for x in d))
    # the losses at every step; the gradient's norm where both sides hold
    # the same parameters (before the first update with lr > 0); later
    # norms and the single entries grad_max and grad_min are reported:
    # Adam turns round-off-sized gradient differences into +-lr moves
    same = [i for i, lr in enumerate(lrs) if i == 0 or lrs[i - 1] == 0.0]
    worst = max([x[k] for x in plain for k in x if k.endswith("loss")]
                + [plain[i]["grad_norm"] for i in same])
    log(f"  kernels vs plain warp: losses at every step and grad_norm at "
        f"steps {same} within {worst:.3g} (rtol {TRAIN_RTOL})")
    if not worst <= TRAIN_RTOL:
        raise AssertionError(f"kernel and plain training differ by {worst}")
    plain = {k: max(x[k] for x in plain) for k in plain[0]}
    again = {k: max(x[k] for x in again) for k in again[0]}
    for pcl in pcl_layers(model):
        pcl.warp = kernel_warp
    fwd_keys = FUSED_FWD_KEYS if mode == "fused" else TWO_PASS_FWD_KEYS
    bwd_keys = FUSED_BWD_KEYS if mode == "fused" else TWO_PASS_BWD_KEYS
    return {"model": model, "loss_fn": loss_fn, "cfg": cfg, "step": step,
            "fwd_keys": fwd_keys, "bwd_keys": bwd_keys, "name": name,
            "batches": batches, "launches": launches,
            "bwd_launches": bwd_launches, "per_step": per_step,
            "bwd_per_step": bwd_per_step, "v_stores": v_stores,
            "grad_copies": grad_copies, "logs": logs, "eval": ev,
            "norm_counts": norms, "norm_calls_per_step": training_norms(model),
            "kernel_vs_plain_rel": plain, "kernel_vs_kernel_rel": again}


def metrics_card_vs_cpu(tr):
    """Phase 7b: compute_depth_metrics of the eval step's inputs (the
    trained model's depth on batch 0 and its gt) on the card against the
    CPU: every metric at METRICS_RTOL (f32 sums in another order), the
    pixel count exactly; then log10 with equal bits on single valid
    pixels (a one-pixel mask, so no sum of many terms differs), on the
    first 256 valid pixels whose log p - log g the two devices' log
    functions round alike, so that the division alone is compared. Also
    counts the pixels on which dividing by the Python float log(10)
    (which the card computes as a multiply by its reciprocal) gives other
    bits than the CPU's division."""
    import math

    import torch

    from cadepth_tpu_torch.metrics.depth_metrics import compute_depth_metrics
    from cadepth_tpu_torch.training import train_state as ts

    cfg, batch = tr["cfg"], tr["batches"][0]
    with torch.no_grad():
        pred = ts.make_predict_fn(cfg, tr["model"])(batch).float()
    gt = batch["depth"].float()
    lo, hi = cfg.validation.min_depth, cfg.validation.max_depth
    maps = {"card": (pred, gt), "cpu": (pred.cpu(), gt.cpu())}
    got = {k: compute_depth_metrics(*m, min_depth=lo, max_depth=hi)
           for k, m in maps.items()}
    worst = 0.0
    for key, want in got["cpu"].items():
        have = got["card"][key].cpu()
        if key == "num_valid_pixels":
            if not torch.equal(have, want):
                raise AssertionError(f"valid pixels {have} != {want}")
            continue
        worst = max(worst, ((have - want).abs()
                            / want.abs().clamp_min(1e-30)).item())

    valid = ((gt > lo) & (gt < hi)).reshape(-1).nonzero()[:, 0]
    flat = {k: [t.reshape(-1)[valid.to(t.device)] for t in m]
            for k, m in maps.items()}
    ld = {k: torch.log(p.clamp(lo, hi)) - torch.log(g)
          for k, (p, g) in flat.items()}
    alike = (ld["card"].cpu() == ld["cpu"]).nonzero()[:256, 0]
    old = int(((ld["card"].abs() / math.log(10.0)).cpu()
               != ld["cpu"].abs() / math.log(10.0))[alike].sum())
    few = {k: [t[alike.to(t.device)] for t in f] for k, f in flat.items()}
    unequal = 0
    for at in range(len(alike)):
        one = {}
        for k, (p, g) in few.items():
            mask = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
            mask[at] = True
            one[k] = compute_depth_metrics(p, g, mask, lo, hi)["log10"].cpu()
        unequal += int(not torch.equal(one["card"], one["cpu"]))
    log(f"  depth metrics of the eval step's inputs {tuple(pred.shape)}, "
        f"card against CPU: max rel err {worst:.3g} (rtol {METRICS_RTOL}), "
        f"valid pixels {int(got['cpu']['num_valid_pixels'])} equal; log10 "
        f"on {len(alike)} single pixels (the first of the {len(valid)} "
        f"valid ones whose log p - log g both devices round alike): "
        f"{unequal} unequal (must be 0); dividing by the Python float "
        f"log(10) would give other bits on {old} of them")
    if not (worst <= METRICS_RTOL and unequal == 0 and len(alike) > 0):
        raise AssertionError(f"depth metrics, card against CPU: rel err "
                             f"{worst}, log10 unequal on {unequal} of "
                             f"{len(alike)} pixels")
    return {"max_rel_err": worst, "log10_pixels": len(alike),
            "log10_unequal": unequal, "python_float_divisor_unequal": old}


def cross_device_train(device, args, model=None, hw=(64, 96)):
    """Phase 8: a small f32 flagship (or the family ``model`` names) takes
    3 train steps at ``hw`` on the card (kernels, TF32 off) and on the CPU
    (plain) from the same weights and batches."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.config import config_from_dict
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    h, w = hw
    cfg = config_from_dict({
        "model": dict(model or {"architecture": "geometry_aware"},
                      init_features=8),
        "data": {"input_height": h, "input_width": w},
        "training": {"use_amp": False, "batch_size": 4}})
    schedule = build_lr_schedule(cfg.optimization, 1, 50)  # 2-step warmup
    rng = np.random.default_rng(args.seed + 5)
    batches = [synthetic_batch(rng, 4, h, w, "cpu") for _ in range(3)]
    runs = []
    for dev in ("cpu", device):
        gen = torch.Generator().manual_seed(args.seed + 6)
        model, loss_fn = ts.build_model_and_loss(cfg, device=dev,
                                                 generator=gen)
        rotate_pcl_heads(model, gen)
        step = ts.make_train_step(
            cfg, model, loss_fn,
            ts.build_optimizer(cfg.optimization, model.parameters()), schedule)
        logs = [{k: float(v) for k, v in step(
            {k: t.to(dev) for k, t in b.items()}).items()} for b in batches]
        runs.append((logs, {k: v.cpu() for k, v in
                            model.state_dict().items()}))
    (cpu_logs, cpu_sd), (dev_logs, dev_sd) = runs
    loss_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                   zip(dev_logs, cpu_logs) for k in a if k.endswith("loss"))
    param_err = max((dev_sd[k].float() - cpu_sd[k].float()).abs().max().item()
                    for k in cpu_sd)
    # Adam moves a parameter by about lr per step, so a gradient entry whose
    # sign is round-off can move the two sides apart by 2 lr
    bound = 2 * sum(schedule(s) for s in range(3))
    log(f"  small f32 {type(model).__name__} (f=8, {h}x{w}, B=4), 3 steps, "
        f"{device} vs cpu: "
        f"losses max rel err {loss_err:.3g} (rtol {CROSS_TRAIN_RTOL}); "
        f"parameters and statistics max|err| {param_err:.3g} (bound "
        f"2 sum(lr) {bound:.3g})")
    if not (loss_err <= CROSS_TRAIN_RTOL and param_err <= bound):
        raise AssertionError("card and CPU training disagree")
    return loss_err, param_err


def bwd_times(device, args, card: str, name: str = "two_pass_warp",
              shapes=None):
    """Phase 9a (and 14a): per decoder level at the training batch, the
    backward kernels of ``name`` ("two_pass_warp" or "fused_warp"), their
    bound, the backward call's host time (the host clock over back-to-back
    calls, without a synchronize), the plain backward and the backward of
    F.grid_sample(F.affine_grid(theta)), bf16; and the training forward,
    which stores V. ``shapes``: the (level, shape) pairs, the flagship's
    five decoder levels at the training batch unless given."""
    import torch
    import torch.nn.functional as F

    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_bwd,
        two_pass_affine_warp_plain_fwd,
    )

    if name == "fused_warp":
        counted, plain_fwd = fw, fw.fused_warp_plain_fwd
        kernel, plain = fw.fused_warp_bwd, fw.fused_warp_plain_bwd
        keys, fwd_keys = FUSED_BWD_KEYS, FUSED_FWD_KEYS

        def train_fwd(img, theta):
            return fw._forward(img, theta, False, keep_v=True)
    else:
        counted, plain_fwd = warp, two_pass_affine_warp_plain_fwd
        kernel, plain = warp.two_pass_warp_bwd, two_pass_affine_warp_plain_bwd
        keys, fwd_keys = TWO_PASS_BWD_KEYS, TWO_PASS_FWD_KEYS

        def train_fwd(img, theta):
            return warp._forward(img, theta, "zeros", False, keep_v=True)
    cuda = device.type == "cuda"
    timer = Timer(device)
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    shapes = shapes or decoder_shapes(args.train_batch, args.height,
                                      args.width, args.init_features)
    theta = (torch.tensor(THETAS["rotation"], device=device)
             .expand(shapes[0][1][0], 2, 3).contiguous())
    rows = {}
    for level, shape in shapes:
        img = torch.randn(shape, device=device, generator=gen) \
            .to(torch.bfloat16)
        grad = torch.randn(shape, device=device, generator=gen) \
            .to(torch.bfloat16)
        _, v = plain_fwd(img, theta)
        elems = img.numel()
        # read grad_out, V and img once, write d_img once
        bytes_moved = 4 * elems * img.element_size()
        # per element: two tap multiply-adds and three tap dot
        # multiply-adds in each of the two transposed passes
        flops = 20 * elems
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        nchw = img.permute(0, 3, 1, 2).detach().requires_grad_(True)
        th = theta.to(torch.bfloat16).requires_grad_(True)
        with torch.enable_grad():
            gs = F.grid_sample(
                nchw, F.affine_grid(th, list(nchw.shape), align_corners=False),
                mode="bilinear", padding_mode="zeros", align_corners=False)
        gs_grad = grad.permute(0, 3, 1, 2)
        calls = {
            "kernel": lambda: kernel(img, v, theta, grad),
            "plain": lambda: plain(img, v, theta, grad),
            "library": lambda: torch.autograd.grad(gs, (nchw, th), gs_grad,
                                                   retain_graph=True),
        }
        row = dict(shape=shape, bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=bytes_moved, two_launch_bytes=6 * elems * 2)
        for call, fn in calls.items():
            n = args.timing_iters if call != "plain" else \
                max(args.timing_iters // 10, 2)
            before = counted.bwd_launches
            row[f"{call}_wall_ms"] = timer(fn, n, 2)
            if call == "kernel" and cuda and counted.bwd_launches == before:
                raise AssertionError(f"timing loop did not launch the "
                                     f"{name} backward kernels")
            if call == "kernel":
                # the host's time per call: enqueueing back-to-back calls
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                row["kernel_host_ms"] = (time.perf_counter() - t0) * 1e3 / n
                if cuda:
                    torch.cuda.synchronize()
            row[f"{call}_ms"] = row.setdefault("kernel_call_ms", None)
            row.setdefault("passes_ms", None)
            if cuda:
                expect = dict(kernels=keys,
                              launches=counted.BWD_LAUNCHES_PER_CALL) \
                    if call == "kernel" else {}
                total, per_kernel = device_ms(fn, n, **expect)
                row[f"{call}_ms"] = total
                if call == "kernel":
                    # the backward's three kernels, the transposed passes
                    # alone, and the whole call
                    row["kernel_ms"] = sum(
                        ms for key, ms in per_kernel.items()
                        if any(k in key for k in keys))
                    row["passes_ms"] = sum(
                        ms for key, ms in per_kernel.items()
                        if any(k in key for k in keys[:2]))
                    row["kernel_call_ms"] = total
        # the training forward: the one launch, storing V; reads img,
        # writes out and V
        fwd_bytes = 3 * elems * img.element_size()
        row["train_fwd_bound_ms"] = max(fwd_bytes / HBM_BYTES_PER_S,
                                        6 * elems / F32_FLOPS_PER_S) * 1e3

        def fwd():
            return train_fwd(img, theta)

        row["train_fwd_wall_ms"] = timer(fwd, args.timing_iters, 2)
        row["train_fwd_ms"] = device_ms(
            fwd, args.timing_iters, kernels=fwd_keys,
            launches=counted.LAUNCHES_PER_CALL)[0] if cuda else None
        rows[level] = row

        def fmt(call):
            dev = row[f"{call}_ms"]
            return (f"{dev:.4f} ms device" if dev is not None
                    else "device not measured") + \
                f" / {row[f'{call}_wall_ms']:.4f} ms wall"
        share = (f", {row['bound_ms'] / row['kernel_ms']:.1%} of bound"
                 if row["kernel_ms"] else "")
        call = (f" (passes {row['passes_ms']:.4f} ms, "
                f"{row['bound_ms'] / row['passes_ms']:.1%} of bound; the "
                f"whole call {row['kernel_call_ms']:.4f} ms device)"
                if row.get("kernel_call_ms") else "")
        log(f"  [{card}] {level} {shape} bf16 {name} backward: kernels "
            f"{fmt('kernel')}{call}; host {row['kernel_host_ms']:.4f} ms per "
            f"call; bound {row['bound_ms'] * 1e3:.1f} us "
            f"({row['bound_by']}, {bytes_moved / 1e6:.1f} MB; the two "
            f"passes move {row['two_launch_bytes'] / 1e6:.1f} MB){share}; "
            f"plain {fmt('plain')}; grid_sample backward {fmt('library')}"
            f"{unit}")
        dev = row["train_fwd_ms"]
        log(f"  [{card}] {level} {shape} bf16 {name} training forward "
            "(V stored): " + (f"{dev:.4f} ms device, "
                              f"{row['train_fwd_bound_ms'] / dev:.1%} of "
                              if dev else "device not measured, ")
            + f"bound {row['train_fwd_bound_ms'] * 1e3:.1f} us (3 maps)"
            f" / {row['train_fwd_wall_ms']:.4f} ms wall{unit}")
    return rows


def level_sum(rows, key: str):
    """``key`` summed over the five levels' rows, None if one lacks it."""
    vals = [r.get(key) for r in rows.values()]
    return None if any(v is None for v in vals) else sum(vals)


def train_times(device, args, card: str, tr, steps=None):
    """Phase 9b (and 14c): train step latency at the training batch over
    ``steps`` steps, the device's busy share over 3 profiled steps, peak
    device memory."""
    import torch

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    step, batches = tr["step"], tr["batches"]
    for b in batches[:2]:
        step(b)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps or args.train_time_steps):
        t0 = time.perf_counter()
        step(batches[i % len(batches)])
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(round(0.95 * (len(times) - 1))))]
    mean = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    out = {"batch": args.train_batch, "p50_ms": p50, "p95_ms": p95,
           "mean_ms": mean, "images_per_sec": args.train_batch * 1000.0 / mean,
           "steps_timed": len(times), "peak_bytes": peak}
    log(f"  [{card}] {tr['name']} train step batch {args.train_batch}: "
        f"p50 {p50:.3f} ms, "
        f"p95 {p95:.3f} ms, mean {mean:.3f} ms, "
        f"{out['images_per_sec']:.2f} images/s ({len(times)} steps, host "
        f"clock to a synchronize){unit}")
    if peak is not None:
        log(f"  [{card}] peak device memory while training batch "
            f"{args.train_batch}: {peak / 2**30:.3f} GiB "
            "(torch.cuda.max_memory_allocated)")
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        n = 3
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                step(batches[i])
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000.0 / n
        rows = device_rows(prof, n)
        busy = sum(r[0] for r in rows)
        bwd = sum(r[0] for r in rows
                  if any(k in r[2] for k in tr["bwd_keys"]))
        fwd = sum(r[0] for r in rows
                  if any(k in r[2] for k in tr["fwd_keys"]))
        log(f"  [{card}] profile of a batch-{args.train_batch} "
            f"{tr['name']} train step "
            f"(torch.profiler, {n} steps): device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall ({busy / wall:.1%}), "
            f"{sum(r[1] for r in rows)} kernels per step; warp forward "
            f"{fwd:.3f} ms, warp backward kernels {bwd:.3f} ms "
            f"({(fwd + bwd) / busy:.1%} of busy)" if busy else
            f"  [{card}] profile: no device time seen (not measured)")
        for ms, count, key in rows[:12]:
            log(f"    {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} {key[:90]}")
        out["profile"] = {"busy_ms": busy, "wall_ms": wall,
                          "busy_share": busy / wall if wall else None,
                          "warp_fwd_ms": fwd, "warp_bwd_ms": bwd,
                          "kernels_per_step": sum(r[1] for r in rows)}
    return out


def fused_thetas(device, b: int, gen):
    """(name, theta) of the fused checks: THETAS and a 0.2 rad rotation,
    which lies outside the band at the larger levels (there the banded
    warp drops taps; kernel and plain drop the same ones)."""
    import math

    import torch

    out = []
    for tname, th in dict(THETAS, rot_0_2=[
            [math.cos(ROT_OUT), -math.sin(ROT_OUT), 0.0],
            [math.sin(ROT_OUT), math.cos(ROT_OUT), 0.0]]).items():
        theta = torch.tensor(th, device=device).expand(b, 2, 3).contiguous()
        if tname == "identity_noise":
            theta = theta + 0.01 * torch.randn(b, 2, 3, device=device,
                                               generator=gen)
        out.append((tname, theta))
    return out


def check_fused(device, fwd_shapes, bwd_shapes, seed: int):
    """Phase 10: the banded warp's kernels against its plain versions, f32
    and bf16, THETAS and an out-of-band rotation: the one-launch forward
    at the serving batch, served (no V) and storing V, equal to the plain
    forward bit for bit; the backward's three kernels at the training
    batch, run twice for the same bits, against the plain backward
    computed on a CPU copy of the same tensors (its index_add_ is
    deterministic there, so two runs print the same errors). Returns the
    worst errors: forward per dtype; backward d_img per dtype and d_theta
    over its largest |entry|."""
    import torch

    from cadepth_tpu_torch.ops import fused_warp as fw

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    fwd = {"float32": 0.0, "bfloat16": 0.0}
    bwd = {"float32": 0.0, "bfloat16": 0.0, "d_theta": 0.0}
    for (level, shape), (_, bshape) in zip(fwd_shapes, bwd_shapes):
        img32 = torch.randn(shape, device=device, generator=gen)
        grad32 = torch.randn(bshape, device=device, generator=gen)
        band = fw.fused_tiles(shape[1], shape[2])
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            img, grad = img32.to(dtype), grad32.to(dtype)
            bimg = img[:bshape[0]].contiguous()
            plans = [fw.fused_plan(*s_, dtype)[:2] for s_ in (shape, bshape)]
            errs = []
            for tname, theta in fused_thetas(device, shape[0], gen):
                before, stores = fw.launches, fw.v_stores
                served, _ = fw._forward(img, theta, False, keep_v=False)
                out, v = fw._forward(img, theta, False, keep_v=True)
                if cuda:
                    torch.cuda.synchronize()
                    if fw.launches != before + 2 * fw.LAUNCHES_PER_CALL or \
                            fw.v_stores != stores + 1:
                        raise AssertionError("fused_warp did not count its "
                                             "launches or V stores")
                want_out, want_v = fw.fused_warp_plain_fwd(img, theta)
                err = max((got.float() - want.float()).abs().max().item()
                          for got, want in ((served, want_out),
                                            (out, want_out), (v, want_v)))
                if err != 0.0:
                    raise AssertionError(
                        f"fused kernel vs plain {level} {shape} {name} "
                        f"{tname}: max err {err}, not 0")
                fwd[name] = max(fwd[name], err)
                bth = theta[:bshape[0]].contiguous()
                bv = want_v[:bshape[0]].contiguous()
                before = fw.bwd_launches
                got = fw.fused_warp_bwd(bimg, bv, bth, grad)
                again = fw.fused_warp_bwd(bimg, bv, bth, grad)
                if cuda:
                    torch.cuda.synchronize()
                    if fw.bwd_launches != \
                            before + 2 * fw.BWD_LAUNCHES_PER_CALL:
                        raise AssertionError("fused_warp_bwd did not count "
                                             "its launches")
                if not (torch.equal(again[0], got[0])
                        and torch.equal(again[1], got[1])):
                    raise AssertionError(f"fused backward {level} {name} "
                                         f"{tname}: two runs differ")
                want = fw.fused_warp_plain_bwd(
                    *(t.cpu() for t in (bimg, bv, bth, grad)))
                got = [t.cpu() for t in got]
                scale = max(1.0, want[0].float().abs().max().item())
                d_err = (got[0].float() - want[0].float()).abs().max().item()
                t_err = ((got[1] - want[1]).abs().max()
                         / want[1].abs().max().clamp_min(1e-12)).item()
                if not (d_err <= BWD_ATOL[name] * scale
                        and t_err <= THETA_ATOL[name]):
                    raise AssertionError(
                        f"fused backward kernel vs plain {level} {bshape} "
                        f"{name} {tname}: d_img err {d_err} (atol "
                        f"{BWD_ATOL[name]} x {scale:.3g}), d_theta err "
                        f"{t_err} (atol {THETA_ATOL[name]})")
                bwd[name] = max(bwd[name], d_err)
                bwd["d_theta"] = max(bwd["d_theta"], t_err)
                band_ok = bool(fw.fused_warp_theta_ok(theta, shape[1],
                                                      shape[2]).all())
                errs.append(f"{tname}{'' if band_ok else '(out of band)'}="
                            f"{err:.3g}|{d_err:.3g}/{t_err:.2g}")
            log(f"  {level} {tuple(shape)}/{bshape[0]} {name:8s} (it, wt, "
                f"kb_f, kb_b) {band}, (vec, chunk) {plans[0]}/{plans[1]} "
                "max|err| fwd|d_img/rel d_theta " + " ".join(errs))
    log("  the forward served and storing V equals the plain forward (max "
        "err 0); each backward, run twice, gave the same bits")
    return fwd, bwd


def serve_fused(device, args, weights, request):
    """Phase 11: the flagship with pcl_warp fused, the two-pass Predictor's
    ``weights``, served at full width: the fused kernels' launch counts, the
    depths against the same model with the plain banded warp and against
    the two-pass flagship's (in band the two are the same function).
    Returns the Predictor and what the JSON line needs."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    rgb8, k, depth_two_pass = request
    cfg = flagship_config(args.init_features, args.height, args.width,
                          pcl_warp="fused")
    fused = Predictor(cfg, weights, batch_size=args.batch, device=device)
    pcls = pcl_layers(fused.model)
    seen = []

    def recording(img, theta, padding_mode, align_corners):
        seen.append((tuple(img.shape), img.dtype,
                     bool(fw.fused_warp_theta_ok(theta, img.shape[1],
                                                 img.shape[2]).all())))
        return fw.fused_warp(img, theta, padding_mode, align_corners)

    for pcl in pcls:
        if pcl.warp is not fw.fused_warp:
            raise AssertionError("a pcl_warp fused model holds another warp")
        pcl.warp = recording

    # the main path, counted
    fw.launches = fw.bwd_launches = tpw.launches = tpw.bwd_launches = 0
    fw.v_stores = 0
    depth8 = fused.predict(rgb8, k)
    depth3 = fused.predict(rgb8[:3], k[:3])
    launches = fw.launches
    per_forward = fw.LAUNCHES_PER_CALL * len(pcls)
    cuda = device.type == "cuda"
    expected = 2 * per_forward if cuda else 0
    log(f"  main path: 2 forwards, fused_warp launches {launches} (expected "
        f"{expected} = {per_forward} per forward, {fw.LAUNCHES_PER_CALL} per "
        f"PCL), V stores {fw.v_stores} (expected 0), two_pass_warp launches "
        f"{tpw.launches}, backward launches "
        f"{fw.bwd_launches + tpw.bwd_launches}")
    if launches != expected or fw.v_stores or tpw.launches \
            or fw.bwd_launches or tpw.bwd_launches:
        raise AssertionError("fused serving launched other kernels than "
                             f"{fw.LAUNCHES_PER_CALL} fused_warp launch per "
                             "PCL per forward, or stored V")
    shapes = [s for s, _, _ in seen[:len(pcls)]]
    want_shapes = [tuple(s) for _, s in decoder_shapes(
        args.batch, args.height, args.width, args.init_features)]
    if shapes != want_shapes or not all(d == torch.bfloat16
                                        for _, d, _ in seen):
        raise AssertionError(f"fused warp inputs {seen}")
    in_band = [ok for _, _, ok in seen[:len(pcls)]]
    log(f"  fused_warp_theta_ok per level (dec5..dec1): {in_band}")
    for pcl in pcls:
        pcl.warp = fw.fused_warp

    max_depth = cfg.model.max_depth
    for name, d, n in (("N=8", depth8, args.batch), ("N=3", depth3, 3)):
        if d.shape != (n, args.height, args.width, 1) or \
                not (np.isfinite(d).all() and d.min() > 0
                     and d.max() < max_depth):
            raise AssertionError(f"fused {name}: {d.shape}, "
                                 f"[{d.min()}, {d.max()}]")
    for pcl in pcls:
        pcl.warp = fw.fused_warp_plain
    depth8_plain = fused.predict(rgb8, k)
    for pcl in pcls:
        pcl.warp = fw.fused_warp
    errs = {"N=3 vs N=8 rows": float(np.abs(depth3 - depth8[:3]).max()),
            "kernels vs plain fused warp":
                float(np.abs(depth8 - depth8_plain).max()),
            "fused vs two_pass flagship":
                float(np.abs(depth8 - depth_two_pass).max())}
    log("  fused depths finite, in "
        f"[{depth8.min():.4f}, {depth8.max():.4f}] m; max|err| "
        + ", ".join(f"{k} {v:.3g} m" for k, v in errs.items())
        + f" (atol {SERVE_ATOL})")
    if not all(in_band):
        raise AssertionError("a served theta lies outside the band, so the "
                             "two-pass comparison does not hold")
    if not max(errs.values()) <= SERVE_ATOL:
        raise AssertionError(f"fused serving: {errs}")
    return fused, launches, per_forward, errs


def fused_loss_phase(device, args, tr):
    """Phase 13b: the fused depth-loss op on the fused train phase's
    predicted depth (the trained model, batch 0) and its gt. The op's
    main path (statistics, then the gradient through its Function),
    counted; the kernels against the plain versions; the losses and the
    gradient against scale_invariant_loss + 0.01 reprojection_loss."""
    import torch

    from cadepth_tpu_torch.losses.depth_loss import (
        reprojection_loss,
        scale_invariant_loss,
    )
    from cadepth_tpu_torch.ops import fused_loss as fl
    from cadepth_tpu_torch.training import train_state as ts

    cuda = device.type == "cuda"
    batch = tr["batches"][0]
    depth = ts.make_predict_fn(tr["cfg"], tr["model"])(batch).float()
    gt, k4, kmat = batch["depth"], batch["k4"], batch["intrinsics"]
    x = depth.clone().requires_grad_(True)

    # the main path, counted
    fl.launches = fl.bwd_launches = 0
    with torch.enable_grad():
        si, rep = fl.silog_reproj_losses(x, gt, k4)
        (si + 0.01 * rep).backward()
    if cuda:
        torch.cuda.synchronize()
    launches, bwd_launches = fl.launches, fl.bwd_launches
    want = 1 if cuda else 0
    log(f"  main path: silog_reproj_losses + backward on {tuple(depth.shape)}:"
        f" stats launches {launches}, grad launches {bwd_launches} (expected "
        f"{want} each)")
    if launches != want or bwd_launches != want:
        raise AssertionError("the fused loss did not launch its kernels")

    y = depth.clone().requires_grad_(True)
    with torch.enable_grad():
        si_r = scale_invariant_loss(y, gt)
        rep_r = reprojection_loss(y, gt, kmat)
        (si_r + 0.01 * rep_r).backward()
    si, rep, si_r, rep_r = (float(t.detach()) for t in (si, rep, si_r, rep_r))
    loss_err = max(abs(si - si_r) / abs(si_r), abs(rep - rep_r) / abs(rep_r))
    grad_err = ((x.grad - y.grad).abs().max()
                / y.grad.abs().max()).item()
    log(f"  silog {si:.6g}, reproj {rep:.6g}; against "
        f"scale_invariant_loss + reprojection_loss: losses max rel err "
        f"{loss_err:.3g}, gradient max|err|/max|grad| {grad_err:.3g} "
        f"(rtol {LOSS_RTOL})")
    if not (loss_err <= LOSS_RTOL and grad_err <= LOSS_RTOL):
        raise AssertionError("fused loss differs from the reference losses")

    pred3, gt3 = depth[..., 0].contiguous(), gt[..., 0].contiguous()
    stats = fl.depth_loss_stats(pred3, gt3, k4)
    again = fl.depth_loss_stats(pred3, gt3, k4)
    if not torch.equal(stats, again):
        raise AssertionError(f"two statistics calls differ: {stats} {again}")
    kernels = stats_call_kernels(pred3, gt3, k4) if cuda else []
    log(f"  20 statistics calls on the card run {kernels}, 20 launches "
        "(torch.profiler; expected one stats_kernel a call and nothing "
        "else); two calls give the same bits" if cuda
        else "  two statistics calls give the same bits")
    if cuda and (len(kernels) != 1 or "stats_kernel" not in kernels[0]):
        raise AssertionError(f"a statistics call ran {kernels}")
    plain = fl.depth_loss_stats_plain(pred3, gt3, k4)
    maskf = (gt3 > fl.EPS).float()
    d = fl._log_diff(pred3, gt3) * maskf
    mag = torch.stack([d.abs().sum(), plain[1], plain[2], plain[3]]) \
        .clamp_min(1.0)
    stats_abs = (stats - plain).abs().max().item()
    stats_err = ((stats - plain).abs() / mag).max().item()
    coefs = torch.tensor([0.3, -1.7, 0.01], device=device)
    dpred = fl.depth_loss_grad(pred3, gt3, k4, coefs)
    dplain = fl.depth_loss_grad_plain(pred3, gt3, k4, coefs)
    dpred_abs = (dpred - dplain).abs().max().item()
    dpred_err = dpred_abs / dplain.abs().max().item()
    log(f"  kernels vs plain: stats max|err| / sum|term| {stats_err:.3g} "
        f"(atol {ATOL['float32']}), count {float(stats[2]):.0f} == "
        f"{float(plain[2]):.0f}; grad max|err| {dpred_abs:.3g} (atol "
        f"{GRAD_ATOL})")
    if not (stats_err <= ATOL["float32"] and stats[2] == plain[2]
            and dpred_abs <= GRAD_ATOL):
        raise AssertionError("fused loss kernels differ from plain")

    # the Function's backward: the plain version's bits of its cotangent's
    # entries 0, 1 and 3, read in place, and one kernel a call
    x3 = pred3.clone().requires_grad_(True)
    with torch.enable_grad():
        stats3 = fl.fused_depth_loss_stats(x3, gt3, k4)
    cot4 = torch.tensor([0.3, -1.7, 5.0, 0.01], device=device)
    backward_kernels = {}
    for name, cot in (("contiguous", cot4),
                      ("stride_0", torch.ones(1, device=device).expand(4))):
        (got,) = torch.autograd.grad(stats3, x3, cot, retain_graph=True)
        if not torch.equal(got, fl.depth_loss_grad_plain(
                pred3, gt3, k4, cot[[0, 1, 3]])):
            raise AssertionError(f"the Function's backward ({name} "
                                 "cotangent) differs from plain")
        if cuda:
            _, per_kernel = backward_call_ms(stats3, x3, cot, 20)
            backward_kernels[name] = sorted(per_kernel)
    log(f"  20 backwards of the Function (f32 pred) on the card run "
        f"{backward_kernels}, 20 launches each (torch.profiler; expected "
        f"one grad_kernel a call and nothing else); equal to the plain "
        f"version's bits" if cuda
        else "  the Function's backward equals the plain version's bits")
    if cuda and any(len(k) != 1 or "grad_kernel" not in k[0]
                    for k in backward_kernels.values()):
        raise AssertionError(f"a backward ran {backward_kernels}")
    return {"launches": launches, "bwd_launches": bwd_launches,
            "backward_kernels": backward_kernels,
            "stats_err": stats_err, "grad_err": dpred_err,
            "stats_abs": stats_abs, "grad_abs": dpred_abs,
            "vs_reference_loss_rel": loss_err,
            "vs_reference_grad_rel": grad_err,
            "inputs": (pred3, gt3, k4, coefs)}


def stats_call_kernels(pred, gt, k4, calls: int = 20):
    """The names of the kernels (and copies or memsets) that ``calls``
    calls of the fused-loss statistics run on the card, by torch.profiler
    through device_ms (which pads the profile against the records the
    profiler drops at its ends, and checks it holds ``calls`` launches of
    stats_kernel)."""
    from cadepth_tpu_torch.ops import fused_loss as fl

    _, per_kernel = device_ms(lambda: fl.depth_loss_stats(pred, gt, k4),
                              calls, kernels=("stats_kernel",), launches=1)
    return sorted(per_kernel)


def backward_call_ms(stats, x, cot, calls: int):
    """Device time of one backward of the fused loss's autograd Function
    (``torch.autograd.grad(stats, x, cot)``, the graph kept), and
    {kernel, copy or memset name: ms per call}, by torch.profiler
    through device_ms (which checks that the profile holds ``calls``
    launches of grad_kernel). It takes the op's public API alone, so it
    times any version of the op."""
    import torch

    return device_ms(
        lambda: torch.autograd.grad(stats, x, cot, retain_graph=True), calls,
        kernels=("grad_kernel",), launches=1)


def launch_floor_ms(args, attempts: int = 3):
    """Device time of one launch of a kernel that does next to nothing
    (``torch.cuda._sleep(0)``: one thread reads the clock once), by
    torch.profiler: the floor under a small kernel's time. The mean over
    the launches the profile holds, so records it drops do not bias it.
    As in device_ms, fill kernels pad both ends of the profile (a profile
    of the empty launches alone can hold none of them), and a profile
    holding none is taken again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1024, device="cuda")
    torch.cuda._sleep(0)
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                pad.fill_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(args.timing_iters):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(32):
                pad.fill_(1.0)
            torch.cuda.synchronize()
        spins = [(us, n) for us, n, key in device_events(prof)
                 if "spin_kernel" in key]
        if spins:
            return sum(us for us, _ in spins) / sum(n for _, n in spins) \
                / 1000.0
        log(f"  torch.profiler held no empty launch (profile {attempt} of "
            f"{attempts})")
    raise AssertionError("torch.profiler held no empty launch")


def loss_times(device, args, card: str, inputs):
    """Phase 14b: the fused loss kernels' device time, their bound and
    the plain versions' time at the train phase's (4, 240, 320)."""
    from cadepth_tpu_torch.ops import fused_loss as fl

    cuda = device.type == "cuda"
    timer = Timer(device)
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    pred, gt, k4, coefs = inputs
    n = pred.numel()
    rows = {}
    floor = launch_floor_ms(args) if cuda else None
    if cuda:
        log(f"  [{card}] the floor: an empty kernel's launch "
            f"{floor * 1e3:.2f} us device")
    # stats: read pred and gt once; ~30 f32 operations and two logs per
    # element. grad: also write dpred once; ~40 operations.
    for name, kernel, plain, nbytes, ops in (
            ("fused_loss_stats", lambda: fl.depth_loss_stats(pred, gt, k4),
             lambda: fl.depth_loss_stats_plain(pred, gt, k4), 8 * n, 30 * n),
            ("fused_loss_grad",
             lambda: fl.depth_loss_grad(pred, gt, k4, coefs),
             lambda: fl.depth_loss_grad_plain(pred, gt, k4, coefs), 12 * n,
             40 * n)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        row = {"shape": tuple(pred.shape), "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "floor_ms": floor}
        for call, fn in (("kernel", kernel), ("plain", plain)):
            row[f"{call}_wall_ms"] = timer(fn, args.timing_iters, 2)
            row[f"{call}_ms"] = row.setdefault("kernel_call_ms", None)
            if cuda:
                # fused_loss_stats -> stats_kernel, fused_loss_grad ->
                # grad_kernel
                kname = name.split("_")[-1] + "_kernel"
                expect = dict(kernels=(kname,), launches=1) \
                    if call == "kernel" else {}
                total, per_kernel = device_ms(fn, args.timing_iters, **expect)
                row[f"{call}_ms"] = total
                if call == "kernel":
                    # the launch alone, and every kernel of the call (one)
                    row["kernel_ms"] = sum(
                        ms for key, ms in per_kernel.items() if kname in key)
                    row["kernel_call_ms"] = total
        if name == "fused_loss_grad":
            backward_rows(row, args, timer, pred, gt, k4, cuda)
        rows[name] = row
        dev = row["kernel_ms"]
        log(f"  [{card}] {name} {row['shape']} f32: kernel "
            + (f"{dev * 1e3:.2f} us device ({row['kernel_call_ms'] * 1e3:.2f} "
               f"us for the whole call)" if dev is not None
               else "device not measured")
            + f" / {row['kernel_wall_ms']:.4f} ms wall; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
            f"{nbytes / 1e6:.2f} MB)"
            + (f", floor {floor * 1e3:.2f} us" if floor is not None else "")
            + "; plain "
            + (f"{row['plain_ms']:.4f} ms device" if row["plain_ms"]
               is not None else "device not measured")
            + f"; no single PyTorch call computes it{unit}")
    grad = rows["fused_loss_grad"]
    log(f"  [{card}] fused_loss_grad: the Function's backward, one call "
        + (f"{grad['backward_call_ms'] * 1e3:.2f} us device "
           f"({grad['backward_call_kernels']})" if cuda
           else "device not measured")
        + f" / {grad['backward_call_wall_ms']:.4f} ms wall; a same-bytes "
        "pass, torch.add(pred, gt, out=buf) (reads 8 B and writes 4 B an "
        "element; not the same function), "
        + (f"{grad['same_bytes_ms'] * 1e3:.2f} us device" if cuda
           else "device not measured")
        + f" / {grad['same_bytes_wall_ms']:.4f} ms wall{unit}")
    return rows


def backward_rows(row, args, timer, pred, gt, k4, cuda: bool) -> None:
    """The gradient row's backward call (the autograd Function's whole
    backward, at a contiguous cotangent) and same-bytes pass times."""
    import torch

    from cadepth_tpu_torch.ops import fused_loss as fl

    x = pred.clone().requires_grad_(True)
    with torch.enable_grad():
        stats = fl.fused_depth_loss_stats(x, gt, k4)
    cot = torch.tensor([0.3, -1.7, 5.0, 0.01], device=pred.device)
    buf = torch.empty_like(pred)
    for key, fn in (
            ("backward_call",
             lambda: torch.autograd.grad(stats, x, cot, retain_graph=True)),
            ("same_bytes", lambda: torch.add(pred, gt, out=buf))):
        row[f"{key}_wall_ms"] = timer(fn, args.timing_iters, 2)
        row[f"{key}_ms"] = None
    if cuda:
        total, per_kernel = backward_call_ms(stats, x, cot, args.timing_iters)
        row["backward_call_ms"] = total
        row["backward_call_kernels"] = sorted(per_kernel)
        # counted, as the kernels are: an uncounted profile that drops
        # records reads short
        add_ms = device_ms(lambda: torch.add(pred, gt, out=buf),
                           args.timing_iters, kernels=("elementwise_kernel",),
                           launches=1)[1]
        row["same_bytes_ms"] = sum(ms for key, ms in add_ms.items()
                                   if "elementwise_kernel" in key)
    row["same_bytes_how"] = ("torch.add(pred, gt, out=buf): the gradient's "
                             "bytes (8 read, 4 written an element), not "
                             "its function")


def fused_serve_times(device, args, card: str, fused):
    """Phase 11b: the fused warp's forward per level and the fused
    Predictor's latency at batch 8."""
    from cadepth_tpu_torch.ops import fused_warp as fw

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    rows, total = level_times(device, args, card, "fused_warp", fw.fused_warp,
                              fw.fused_warp_plain, fw, FUSED_FWD_KEYS)
    bench = fused.benchmark(iterations=args.bench_iters, warmup=5)
    log(f"  [{card}] fused Predictor batch {args.batch}: p50 "
        f"{bench['p50_ms']:.3f} ms, p95 {bench['p95_ms']:.3f} ms, "
        f"{bench['images_per_sec']:.2f} images/s ({args.bench_iters} "
        f"requests){unit}")
    prof = profile_forward(fused, card, warp_keys=FUSED_FWD_KEYS,
                           warp_name="fused_warp") if cuda else None
    return rows, total, bench, prof


def rotation(rad: float):
    import math

    return [[math.cos(rad), -math.sin(rad), 0.0],
            [math.sin(rad), math.cos(rad), 0.0]]


def check_banded(device, shapes, seed: int):
    """Phase 15: the banded affine warp's kernel against its plain
    version at the five decoder shapes (serving batch), f32 and bf16:
    tests/test_pallas.py's four thetas at every level and, at dec1, two
    rotations past the band: max error 0 (BANDED_ATOL), one launch a
    call, the same bits on a second call; max_rotation_rows against its
    plain computation. Returns the worst error per dtype."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.ops import banded_affine_warp as baw

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for level, shape in shapes:
        b, h, w = shape[:3]
        img32 = torch.randn(shape, device=device, generator=gen)
        cases = dict(BANDED_THETAS)
        if level == "dec1":
            for rad in ROT_BAND_OUT:
                cases[f"rot_{rad}"] = rotation(rad)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            img = img32.to(dtype)
            errs = []
            for tname, th in cases.items():
                theta = torch.tensor(th, device=device).expand(b, 2, 3) \
                    .contiguous()
                rows = baw.max_rotation_rows(theta, h, w)
                t10 = np.asarray(th, np.float64)[1, 0]
                want_rows = abs(t10 * h / w) * (w - 1)
                if not np.allclose(rows.cpu().numpy(), want_rows, rtol=1e-6,
                                   atol=1e-6):
                    raise AssertionError(f"max_rotation_rows {rows} != "
                                         f"{want_rows}")
                before = baw.launches
                got = baw.banded_affine_warp(img, theta)
                again = baw.banded_affine_warp(img, theta)
                if cuda:
                    torch.cuda.synchronize()
                    if baw.launches != before + 2 * baw.LAUNCHES_PER_CALL:
                        raise AssertionError("banded_affine_warp did not "
                                             "count one launch a call")
                want = baw.banded_affine_warp_plain(img, theta)
                err = (got.float() - want.float()).abs().max().item()
                if not (err <= BANDED_ATOL and torch.equal(got, again)):
                    raise AssertionError(
                        f"banded affine kernel vs plain {level} {shape} "
                        f"{name} {tname}: max err {err} > {BANDED_ATOL}, "
                        "or two calls differ")
                worst[name] = max(worst[name], err)
                band = "" if float(rows.max()) + 2 <= baw.BAND_S else \
                    f"(out of band, {float(rows.max()):.1f} rows)"
                errs.append(f"{tname}{band}={err:.3g}")
            log(f"  {level} {tuple(shape)} {name:8s} max|err| "
                + " ".join(errs) + f"  (atol {BANDED_ATOL}; the same bits "
                "twice)")
    return worst


def set_head_rotation(model, rad: float) -> None:
    """Set every PCL head's rotation bias."""
    import torch

    with torch.no_grad():
        for pcl in pcl_layers(model):
            pcl.fc_transform.bias[4] = rad


def serve_modes(device, args, card: str, weights, request):
    """Phase 16: the flagship with pcl_warp gather, auto and separable,
    phase 4's weights, served at full width (batch 8). The warp kernels
    launched per forward (auto: the two-pass warp's 1 per PCL; gather and
    separable: none); auto equal to phase 4's two-pass depths with the
    shipped heads and equal to gather with the heads turned past its bound;
    the banded affine warp on the gather forward's five PCL inputs, counted
    (its path: 1 launch per call, 5 per forward), against its plain
    version and, in f32, against the gather warp; each mode's latency and
    device profile, and a small f32 model card against CPU."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.ops import banded_affine_warp as baw
    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.ops.grid_sample import gather_affine_warp

    rgb8, k, depth_two_pass = request
    cuda = device.type == "cuda"
    h, w = args.height, args.width
    preds, out, seen = {}, {}, []

    def recording(img, theta, padding_mode, align_corners):
        res = gather_affine_warp(img, theta, padding_mode, align_corners)
        seen.append((img, theta, res))
        return res

    for mode in ("gather", "auto", "separable"):
        cfg = flagship_config(args.init_features, h, w, pcl_warp=mode)
        pred = Predictor(cfg, weights, batch_size=args.batch, device=device)
        pcls = pcl_layers(pred.model)
        if mode == "gather":
            for pcl in pcls:
                pcl.warp = recording
        # the main path, counted
        for m in (tpw, fw, baw):
            m.launches = 0
        tpw.bwd_launches = fw.bwd_launches = 0
        depth = pred.predict(rgb8, k)
        if cuda:
            torch.cuda.synchronize()
        two_pass = tpw.launches
        others = fw.launches + baw.launches + tpw.bwd_launches + \
            fw.bwd_launches
        want = tpw.LAUNCHES_PER_CALL * len(pcls) if cuda and mode == "auto" \
            else 0
        if mode == "gather":
            for pcl in pcls:
                pcl.warp = gather_affine_warp
        if two_pass != want or others:
            raise AssertionError(f"pcl_warp {mode}: two_pass_warp launches "
                                 f"{two_pass} (expected {want}), other "
                                 f"kernels {others}")
        if depth.shape != (args.batch, h, w, 1) or not (
                np.isfinite(depth).all() and depth.min() > 0
                and depth.max() < cfg.model.max_depth):
            raise AssertionError(f"{mode}: depth {depth.shape} "
                                 f"[{depth.min()}, {depth.max()}]")
        err = float(np.abs(depth - depth_two_pass).max())
        log(f"  pcl_warp {mode}: 1 forward, two_pass_warp launches "
            f"{two_pass} (expected {want}), no other kernel; depths in "
            f"[{depth.min():.4f}, {depth.max():.4f}] m; against the "
            f"two-pass flagship max|err| {err:.3g} m")
        if mode == "auto" and err != 0.0:
            raise AssertionError("auto with in-bound heads differs from the "
                                 f"two-pass flagship by {err}")
        preds[mode] = pred
        out[mode] = {"two_pass_launches_per_forward": two_pass,
                     "vs_two_pass_max_err_m": err, "depth": depth}

    # the banded affine warp on the gather forward's PCL inputs, counted
    inputs = seen[:len(pcl_layers(preds["gather"].model))]
    baw.launches = 0
    results = [baw.banded_affine_warp(img, theta) for img, theta, _ in inputs]
    if cuda:
        torch.cuda.synchronize()
    launches = baw.launches
    if not all(torch.equal(got, baw.banded_affine_warp(img, theta))
               for (img, theta, _), got in zip(inputs, results)):
        raise AssertionError("banded_affine_warp gave other bits on a "
                             "second call")
    want = baw.LAUNCHES_PER_CALL * len(inputs) if cuda else 0
    log(f"  banded_affine_warp on the gather forward's {len(inputs)} PCL "
        f"inputs: launches {launches} (expected {want}, 1 per call)")
    if launches != want:
        raise AssertionError(f"banded_affine_warp launches {launches} != "
                             f"{want}")
    plain_err, gather_err = 0.0, []
    for (img, theta, _), got in zip(inputs, results):
        shape = tuple(img.shape)
        rows = float(baw.max_rotation_rows(theta, shape[1], shape[2]).max())
        e_plain = (got.float() - baw.banded_affine_warp_plain(img, theta)
                   .float()).abs().max().item()
        img32 = img.float()
        e_gather = (baw.banded_affine_warp(img32, theta)
                    - gather_affine_warp(img32, theta)).abs().max().item()
        bound = BANDED_VS_GATHER * img32.abs().max().item()
        log(f"    {shape} bf16: span {rows:.2f} rows; kernel vs plain "
            f"{e_plain:.3g} (atol {BANDED_ATOL}; the same bits twice); f32 "
            f"kernel vs the gather warp {e_gather:.3g} (bound {bound:.3g})")
        if rows + 2 > baw.BAND_S:
            raise AssertionError(f"{shape}: the served theta is out of band")
        if not (e_plain <= BANDED_ATOL and e_gather <= bound):
            raise AssertionError(f"banded affine warp on {shape}: plain "
                                 f"{e_plain}, gather {e_gather}")
        plain_err = max(plain_err, e_plain)
        gather_err.append(e_gather / max(img32.abs().max().item(), 1e-12))

    # heads turned past auto's bound: auto takes the gather warp
    for mode in ("gather", "auto"):
        set_head_rotation(preds[mode].model, ROT_PAST_BOUND)
    tpw.launches = 0
    past = {mode: preds[mode].predict(rgb8, k) for mode in ("gather", "auto")}
    for mode in ("gather", "auto"):
        set_head_rotation(preds[mode].model, PCL_BIAS[4])
    err = float(np.abs(past["auto"] - past["gather"]).max())
    moved = float(np.abs(past["auto"] - out["auto"]["depth"]).max())
    log(f"  heads turned to {ROT_PAST_BOUND} rad: auto vs gather max|err| "
        f"{err:.3g} m (must be 0); auto moved by {moved:.3g} m; two_pass_warp "
        f"launches {tpw.launches} (auto still runs it)")
    if err != 0.0 or not moved > 0.0:
        raise AssertionError("auto past its bound is not the gather warp")
    out["auto"]["past_bound_vs_gather_max_err_m"] = err

    for mode, pred in preds.items():
        bench = pred.benchmark(iterations=args.mode_bench_iters, warmup=3)
        keys = TWO_PASS_FWD_KEYS if mode == "auto" else ()
        prof = profile_forward(
            pred, card, warp_keys=keys, warp_name="two_pass_warp" if keys
            else "warp kernels (none)") if cuda else None
        unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
        log(f"  [{card}] {mode} Predictor batch {args.batch}: p50 "
            f"{bench['p50_ms']:.3f} ms, p95 {bench['p95_ms']:.3f} ms, "
            f"{bench['images_per_sec']:.2f} images/s "
            f"({args.mode_bench_iters} requests){unit}")
        out[mode].update(p50_ms=bench["p50_ms"], p95_ms=bench["p95_ms"],
                         images_per_sec=bench["images_per_sec"],
                         profile=prof,
                         card_vs_cpu_f32_max_err_m=cross_device(device, args,
                                                                mode))
        del out[mode]["depth"]
    return out, {"launches": launches, "per_forward": want,
                 "max_abs_err": plain_err,
                 "vs_gather_max_rel_err": max(gather_err)}


def train_mode(device, args, card: str, mode: str, steps: int, **model):
    """Phase 17: the flagship with ``pcl_warp: mode`` (and ``model``
    options) takes ``steps`` train steps at full width, batch 4, from
    phase 7's seeds: finite logs, the warp kernels it launches, step p50
    (host clock to a synchronize, the first step left out), busy device
    ms per step (torch.profiler, one step) and peak device memory."""
    import math

    import numpy as np
    import torch

    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    cuda = device.type == "cuda"
    f, h, w, bsz = args.init_features, args.height, args.width, \
        args.train_batch
    cfg = flagship_config(f, h, w, bsz, mode, **model)
    gen = torch.Generator().manual_seed(args.seed + 3)
    net, loss_fn = ts.build_model_and_loss(cfg, device=device, generator=gen)
    rotate_pcl_heads(net, gen)
    opt = cfg.optimization
    schedule = build_lr_schedule(opt, STEPS_PER_EPOCH, cfg.training.num_epochs)
    rng = np.random.default_rng(args.seed + 4)
    batches = [synthetic_batch(rng, bsz, h, w, device) for _ in range(steps)]
    step = ts.make_train_step(cfg, net, loss_fn,
                              ts.build_optimizer(opt, net.parameters()),
                              schedule)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for m in (tpw, fw):
        m.launches = m.bwd_launches = 0
    logs, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        logs.append({k: float(v) for k, v in step(b).items()})
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    calls = len(pcl_layers(net)) * steps \
        if cuda and mode in ("auto", "two_pass") else 0
    want = (tpw.LAUNCHES_PER_CALL * calls, tpw.BWD_LAUNCHES_PER_CALL * calls)
    launches = (tpw.launches, tpw.bwd_launches)
    if launches != want or fw.launches or fw.bwd_launches:
        raise AssertionError(f"pcl_warp {mode} training: two_pass_warp "
                             f"launches {launches}, expected {want}; "
                             f"fused {fw.launches}, {fw.bwd_launches}")
    if not all(math.isfinite(v) for x in logs for v in x.values()):
        raise AssertionError(f"{mode}: non-finite logs {logs}")
    timed = sorted(times[1:])
    p50 = timed[len(timed) // 2]
    busy = kernels = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(batches[0])
            torch.cuda.synchronize()
        rows = device_rows(prof, 1)
        busy, kernels = sum(r[0] for r in rows), sum(r[1] for r in rows)
    label = mode + "".join(f", {k} {v}" for k, v in model.items())
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    log(f"  [{card}] pcl_warp {label}: {steps} steps at batch {bsz}, losses "
        + " ".join(f"{x['total_loss']:.5g}" for x in logs)
        + f"; two_pass_warp launches {launches} (expected {want}); step "
        f"p50 {p50:.3f} ms (steps 2-{steps}){unit}"
        + (f"; device busy {busy:.3f} ms per step, {kernels} kernels; peak "
           f"{peak / 2**30:.3f} GiB" if cuda else ""))
    return {"steps": steps, "losses": [x["total_loss"] for x in logs],
            "last_logs": logs[-1], "p50_ms": p50, "busy_ms": busy,
            "kernels_per_step": kernels, "peak_bytes": peak,
            "two_pass_launches": launches}


def serve_options(device, args, card: str):
    """Phase 17b: the flagship with norm group and decoder_upsample resize
    (seeded random weights, rotating heads) serves batch 8 once at full
    width: finite depths, the two-pass warp's 1 launch per PCL."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    cfg = flagship_config(args.init_features, args.height, args.width,
                          norm="group", decoder_upsample="resize")
    gen = torch.Generator().manual_seed(args.seed + 11)
    pred = Predictor(cfg, batch_size=args.batch, device=device, generator=gen)
    rotate_pcl_heads(pred.model, gen)
    rgb = np.random.default_rng(args.seed + 11).uniform(
        0, 1, (args.batch, args.height, args.width, 3)).astype(np.float32)
    tpw.launches = 0
    depth = pred.predict(rgb)
    want = tpw.LAUNCHES_PER_CALL * len(pcl_layers(pred.model)) \
        if device.type == "cuda" else 0
    ok = np.isfinite(depth).all() and depth.min() > 0 and \
        depth.max() < cfg.model.max_depth
    log(f"  norm group, decoder_upsample resize: served batch {args.batch}, "
        f"depths in [{depth.min():.4f}, {depth.max():.4f}] m, two_pass_warp "
        f"launches {tpw.launches} (expected {want})")
    if not ok or tpw.launches != want:
        raise AssertionError("group/resize serving failed")
    return {"depth_min": float(depth.min()), "depth_max": float(depth.max()),
            "two_pass_launches": tpw.launches}


def gather_times(device, args, card: str):
    """Phase 18b: the gather warp's device time per level, its forward at
    the serving batch and forward plus backward at the training batch
    (torch.profiler), bf16, the rotation theta; summed over the five
    levels, per forward and per train step."""
    import torch

    from cadepth_tpu_torch.ops.grid_sample import gather_affine_warp

    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(args.seed + 12)
    rows = {}
    for (level, shape), (_, tshape) in zip(
            decoder_shapes(args.batch, args.height, args.width,
                           args.init_features),
            decoder_shapes(args.train_batch, args.height, args.width,
                           args.init_features)):
        theta = torch.tensor(THETAS["rotation"], device=device)
        img = torch.randn(shape, device=device, generator=gen) \
            .to(torch.bfloat16)
        timg = img[:tshape[0]].clone().requires_grad_(True)
        tth = theta.expand(tshape[0], 2, 3).clone().requires_grad_(True)
        grad = torch.randn(tshape, device=device, generator=gen) \
            .to(torch.bfloat16)
        bth = theta.expand(shape[0], 2, 3).contiguous()

        def step():
            with torch.enable_grad():
                out = gather_affine_warp(timg, tth)
                torch.autograd.grad(out, (timg, tth), grad)

        n = max(args.timing_iters // 5, 2)
        fwd = device_ms(lambda: gather_affine_warp(img, bth), n)[0] \
            if cuda else None
        both = device_ms(step, n)[0] if cuda else None
        rows[level] = {"fwd_ms": fwd, "fwd_bwd_ms": both}
        log(f"  [{card}] {level} gather warp: forward {shape} "
            + (f"{fwd:.4f} ms device" if fwd is not None else "not measured")
            + f"; forward + backward {tshape} "
            + (f"{both:.4f} ms device" if both is not None
               else "not measured"))
    total = {k: (None if any(r[k] is None for r in rows.values())
                 else sum(r[k] for r in rows.values()))
             for k in ("fwd_ms", "fwd_bwd_ms")}
    if cuda:
        log(f"  [{card}] gather warp over the five levels: "
            f"{total['fwd_ms']:.4f} ms per forward (batch {args.batch}), "
            f"{total['fwd_bwd_ms']:.4f} ms per train step (batch "
            f"{args.train_batch})")
    return rows, total


# phase 19: the trainer loop on host data
SENSORS = ("kv1", "kv2", "realsense", "xtion")
# pairs of loop-body blocks, fed by the pipeline and from held batches
LOOP_PAIRS = 5


def deep_merge(base: dict, extra: dict) -> dict:
    for key, value in extra.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            deep_merge(base[key], value)
        else:
            base[key] = value
    return base


def write_pack(root: pathlib.Path, args, per_sensor: int, seed: int) -> dict:
    """Phases 19 and 20's data: ``per_sensor`` seeded structured scenes (a
    floor and boxes, RGB keyed to depth) a sensor at the training size,
    spread over the four sensors' intrinsics, written as a SUN RGB-D tree
    by the port's generator (cv2 PNGs) and packed once, f32, by the port's
    pack_dataset."""
    from cadepth_tpu_torch.data.packed import pack_dataset
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    h, w = args.height, args.width
    t0 = time.perf_counter()
    manifest = generate_synthetic_dataset(
        str(root / "data"), images_per_sensor=per_sensor,
        seed=seed, structured=True,
        sensor_specs={s: (w, h, w, h) for s in SENSORS})
    meta = pack_dataset(str(root / "data" / "sunrgbd"), manifest,
                        str(root / "pack"), h, w, num_threads=8)
    size = sum(p.stat().st_size for p in (root / "pack").glob("*.npy"))
    log(f"  {meta['num_samples']} scenes at {h}x{w} written by "
        f"generate_synthetic_dataset and packed by pack_dataset (f32, "
        f"{size / 2**20:.1f} MiB) in {time.perf_counter() - t0:.1f} s")
    return meta


def loop_yaml(root: pathlib.Path, args, epochs: int,
              pack: pathlib.Path = None) -> pathlib.Path:
    """configs/train_config.yaml with phase 19's changes, run as
    --experiment geometry_aware_full: the pack (``root``'s own unless
    given), 4 producer threads, the shipped augmentation, validation
    capped, a log line and a checkpoint every epoch, logs and checkpoints
    under ``root``."""
    import yaml

    raw = yaml.safe_load((ROOT / "configs" / "train_config.yaml").read_text())
    deep_merge(raw, {
        "data": {"packed_dir": str(pack or root / "pack"),
                 "input_height": args.height, "input_width": args.width},
        "model": {"init_features": args.init_features},
        "training": {"num_epochs": epochs, "num_workers": 4,
                     "log_interval": 1, "max_val_samples": args.loop_val},
        "checkpointing": {"checkpoint_dir": str(root / "ckpts"),
                          "save_interval": 1, "save_best_only": False},
        "logging": {"log_dir": str(root / "logs")},
    })
    path = root / f"loop_{epochs}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


class LoopProbe:
    """Watches the port's trainer from outside while its CLI runs: the
    start of every train step and its logs, each train epoch's wall time
    with its pipeline's queue wait and producer, and the Trainer made."""

    def __enter__(self):
        from cadepth_tpu_torch.training import train_state as ts
        from cadepth_tpu_torch.training import trainer as tm

        probe = self
        self.stamps, self.losses, self.epochs, self.trainers = [], [], [], []
        self._orig = (ts.TrainStep, ts.TrainStep.__call__,
                      tm.Trainer, tm.Trainer.train_epoch, tm.Trainer.__init__)
        _, call, _, epoch, init = self._orig

        def timed_call(step, batch):
            probe.stamps.append(time.perf_counter())
            logs = call(step, batch)
            probe.losses.append(logs["total_loss"])
            return logs

        def timed_epoch(trainer, e):
            first = len(probe.stamps)
            before = (trainer.train_step.updates, trainer.optimizer.updates)
            t0 = time.perf_counter()
            loss = epoch(trainer, e)
            probe.epochs.append({
                "epoch": e, "step_before": before[0],
                "updates_before": before[1],
                "wall_s": time.perf_counter() - t0,
                # the device feed has no queue and no producer
                "wait_s": getattr(trainer.train_pipe, "wait_seconds", 0.0),
                "producer": getattr(trainer.train_pipe, "producer",
                                    "device"),
                "first": first, "steps": len(probe.stamps) - first,
                "loss": loss})
            return loss

        def init_and_keep(trainer, *a, **k):
            init(trainer, *a, **k)
            probe.trainers.append(trainer)

        ts.TrainStep.__call__ = timed_call
        tm.Trainer.train_epoch = timed_epoch
        tm.Trainer.__init__ = init_and_keep
        return self

    def __exit__(self, *exc):
        step_cls, call, trainer_cls, epoch, init = self._orig
        step_cls.__call__ = call
        trainer_cls.train_epoch = epoch
        trainer_cls.__init__ = init
        return False

    def step_ms(self):
        """Loop step times (ms): from one step's start to the next's within
        an epoch (the wait for the batch, the step, its log reads), the
        first epoch's first step left out."""
        out = []
        for i, ep in enumerate(self.epochs):
            s = self.stamps[ep["first"]:ep["first"] + ep["steps"]]
            d = [(b - a) * 1000.0 for a, b in zip(s, s[1:])]
            out += d[1:] if i == 0 else d
        return out


def warp_counts():
    """The kernels' counts since :func:`reset_warp_counts`: the two-pass
    warp's launches, backward launches and V stores, the fused warp's
    launches both ways, and the batch norm's calls that ran its kernels
    forward (``bn``) and backward (``bn_bwd``)."""
    from cadepth_tpu_torch.ops import batch_norm as bn
    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    return {"launches": tpw.launches, "bwd_launches": tpw.bwd_launches,
            "v_stores": tpw.v_stores, "fused": fw.launches + fw.bwd_launches,
            "bn": bn.launches, "bn_bwd": bn.bwd_launches}


def reset_warp_counts() -> None:
    from cadepth_tpu_torch.ops import batch_norm as bn
    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    for m in (tpw, fw):
        m.launches = m.bwd_launches = m.grad_copies = m.v_stores = 0
    bn.launches = bn.bwd_launches = 0


def training_norms(model) -> int:
    """The model's batch norms over maps (BatchNorm2d), each called once a
    forward; in training each runs the batch norm's kernels on the card
    (FiLM's BatchNorm1d run none)."""
    from cadepth_tpu_torch.models.layers import BatchNorm2d

    return sum(isinstance(m, BatchNorm2d) for m in model.modules())


def norm_counts(model, steps: int, cuda: bool) -> dict:
    """``warp_counts``' batch norm entries after ``steps`` training steps of
    ``model`` (or of a model with that many :func:`training_norms`) with
    no block recomputed: one call each way a training norm a step on the
    card; none on the CPU (the plain version) or in eval mode."""
    norms = model if isinstance(model, int) else training_norms(model)
    n = norms * steps if cuda else 0
    return {"bn": n, "bn_bwd": n}


NO_NORMS = {"bn": 0, "bn_bwd": 0}


def bn_calls(counts: dict) -> dict:
    """The batch norm's entries of ``warp_counts``' ``counts``."""
    return {"fwd": counts["bn"], "bwd": counts["bn_bwd"]}


def batches_equal(device, pipe, loader, batches: int):
    """Iterate ``pipe`` (a fresh epoch 0), keep ``batches`` of its batches
    as they arrive on ``device``, then hold each, copied back, against the
    loader's get_batch of the same indices on the CPU: the largest
    absolute difference over every key (0 = the same bits)."""
    import numpy as np
    import torch

    indices = pipe._epoch_indices()
    got = []
    for b in pipe:
        if b["rgb"].device.type != device.type:
            raise AssertionError(f"a batch on {b['rgb'].device}, not "
                                 f"{device}")
        got.append(b)
        if len(got) == batches:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    pipe.loader.set_epoch(0)
    worst = 0.0
    for i, b in enumerate(got):
        want = pipe.loader.get_batch(
            indices[i * pipe.batch_size:(i + 1) * pipe.batch_size])
        for k, v in b.items():
            a = v.cpu().numpy()
            if a.shape != want[k].shape or a.dtype != want[k].dtype:
                raise AssertionError(f"{k}: {a.shape} {a.dtype} against "
                                     f"{want[k].shape} {want[k].dtype}")
            worst = max(worst, float(np.abs(a - want[k]).max()))
    return worst


def copy_profile(trainer, steps: int):
    """Profile ``steps`` steps of the trainer loop: the pipeline's copies
    to the card (host-to-device memcpys on a stream other than the one
    the step's kernels run on; one a key, for the batches the producer
    copied in that time): their device time per batch, and the share of
    it during which a kernel ran on the step's stream."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, batch in enumerate(trainer.train_pipe):
            trainer.train_step(batch)
            if i + 1 == steps:
                break
        torch.cuda.synchronize()
    keys = len(batch)  # one copy a key; the producer runs batches ahead
    try:
        events = prof.profiler.kineto_results.events()
        spans = [(e.start_ns(), e.end_ns(), e.device_resource_id(), e.name())
                 for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    except AttributeError:  # another torch's profiler API
        return None
    kernels = [s for s in spans if "Memcpy" not in s[3]
               and "Memset" not in s[3]]
    if not kernels:
        return None
    compute = Counter(s[2] for s in kernels).most_common(1)[0][0]
    busy = sorted((a, b) for a, b, st, _ in kernels if st == compute)
    copies = [s for s in spans if "HtoD" in s[3] and s[2] != compute]
    total = sum(b - a for a, b, _, _ in copies)
    over = 0
    for a, b, _, _ in copies:
        for ka, kb in busy:
            if kb > a and ka < b:
                over += min(b, kb) - max(a, ka)
    return {"copies": len(copies),
            "ms_per_batch": total / 1e6 / len(copies) * keys if copies
            else None,
            "overlapped_share": over / total if total else None,
            "stream": copies[0][2] if copies else None,
            "compute_stream": compute}


def fed_step_ms(trainer, batches, steps: int):
    """p50 and p95 (ms) of ``steps`` steps of the trainer's loop body fed
    from ``batches``: the step, then the reads of its five logged scalars
    (log_interval 1); host clock from step to step, the first left out;
    and the mean time a step waited on the queue (0 for a list)."""
    stamps = []
    for i, batch in enumerate(batches):
        stamps.append(time.perf_counter())
        logs = trainer.train_step(batch)
        for key in ("total_loss", "grad_norm", "grad_max", "grad_min",
                    "si_loss"):
            float(logs[key])
        if i == steps:
            break
    d = sorted((b - a) * 1000.0 for a, b in zip(stamps[1:], stamps[2:]))
    wait = getattr(batches, "wait_seconds", 0.0) * 1000.0 / (steps + 1)
    return (d[len(d) // 2], d[min(len(d) - 1,
                                  int(round(0.95 * (len(d) - 1))))], wait)


def trainer_loop(device, args, card: str, bare_p50, root: pathlib.Path):
    """Phase 19: the port's train CLI trains geometry_aware_full from a pack
    for two epochs (validation and panels each epoch, a checkpoint each),
    resumes from the latest for a third, and the evaluate CLI scores best/;
    the warp's launches are counted over the first run, the pipeline's
    batches are held against the CPU's, and the loop is timed against
    phase 9's bare step. The pack and the run stay under ``root`` (phase
    21 trains from the pack)."""
    import csv
    import math

    import torch

    from cadepth_tpu_torch.cli import evaluate as evaluate_cli
    from cadepth_tpu_torch.cli import train as train_cli
    from cadepth_tpu_torch.data.pipeline import InputPipeline

    cuda = device.type == "cuda"
    meta = write_pack(root, args, args.loop_scenes, args.seed + 19)
    name = "geometry_aware_full"
    argv = ["--experiment", name, "--device", device.type]

    # the main path: two epochs through the train CLI, counted
    reset_warp_counts()
    with LoopProbe() as run1:
        rc = train_cli.main(["--config", str(loop_yaml(root, args, 2))]
                            + argv)
    counts = warp_counts()
    if rc != 0:
        raise AssertionError(f"the train CLI exited {rc}")
    trainer = run1.trainers[0]
    steps = sum(ep["steps"] for ep in run1.epochs)
    per_epoch = len(trainer.train_pipe)
    val_batches = len(trainer.val_pipe)
    vis = min(trainer.cfg.training.num_vis_samples,
              len(trainer.val_loader))
    panels = 2 if vis else 0
    log(f"  train CLI: {len(run1.epochs)} epochs of {per_epoch} steps "
        f"(batch {trainer.cfg.training.batch_size}, "
        f"{len(trainer.train_loader)} train samples with the shipped "
        f"augmentation), validation {val_batches} batches an epoch, "
        f"{vis} panels an epoch; producers: train "
        f"{run1.epochs[0]['producer']}, validation "
        f"{trainer.val_pipe.producer}; TensorBoard writer "
        f"{type(trainer.tb._writer).__name__}")
    if [ep["steps"] for ep in run1.epochs] != [per_epoch] * 2:
        raise AssertionError(f"epochs ran {run1.epochs} steps")
    n_pcl = len(pcl_layers(trainer.model))
    forwards_no_v = 2 * val_batches + panels
    want = {"v_stores": n_pcl * steps if cuda else 0,
            "bwd_launches": 3 * n_pcl * steps if cuda else 0,
            "launches": n_pcl * (steps + forwards_no_v) if cuda else 0,
            "fused": 0, **norm_counts(trainer.model, steps, cuda)}
    log(f"  two_pass_warp over the run: {counts['launches']} forward "
        f"launches ({counts['v_stores']} storing V: {n_pcl} per train "
        f"step; {counts['launches'] - counts['v_stores']} without: "
        f"{n_pcl} per validation and panel forward, "
        f"{forwards_no_v} forwards), {counts['bwd_launches']} backward "
        f"launches ({3 * n_pcl} per step), fused_warp "
        f"{counts['fused']}; batch norm kernel calls {counts['bn']} + "
        f"{counts['bn_bwd']} ({training_norms(trainer.model)} each way a "
        f"train step, none in validation); expected {want}")
    if counts != want:
        raise AssertionError(f"warp launches {counts} != {want}")

    losses = [float(x) for x in run1.losses]
    log_dir = root / "logs" / name
    rows = list(csv.reader((log_dir / "metrics.csv").open()))
    ckpt_dir = root / "ckpts" / name
    step_dirs = sorted(p.name for p in ckpt_dir.glob("step_*"))
    tb_bytes = b"".join(p.read_bytes() for p in
                        (log_dir / "tensorboard").rglob("*")
                        if p.is_file())
    log(f"  {len(losses)} step losses, first {losses[0]:.5g}, last "
        f"{losses[-1]:.5g}; metrics.csv {len(rows[0])} columns, "
        f"{len(rows) - 1} rows; checkpoints {step_dirs} and best/; "
        f"panels in the TensorBoard files: "
        f"{tb_bytes.count(b'predictions/sample_')}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"step losses {losses}")
    if not (log_dir / "training.log").exists() or len(rows[0]) != 13 \
            or len(rows) != 3:
        raise AssertionError(f"training.log or metrics.csv: {rows}")
    if not step_dirs or not (ckpt_dir / "best" / "state.pt").exists():
        raise AssertionError(f"checkpoints: {step_dirs}")
    if vis and b"predictions/sample_0" not in tb_bytes:
        raise AssertionError("no panel reached the TensorBoard files")

    # bits: the pipeline's first batches on the device against the
    # same pack's get_batch on the CPU
    cfg = trainer.cfg
    train_pipe = InputPipeline(
        trainer.train_loader, cfg.training.batch_size, shuffle=True,
        seed=cfg.experiment.seed, num_threads=4, device=device)
    val_pipe = InputPipeline(
        trainer.val_loader, cfg.training.batch_size, shuffle=False,
        max_samples=cfg.training.max_val_samples, device=device)
    bits = {"train_first": batches_equal(device, train_pipe,
                                         trainer.train_loader, 1),
            "val_epoch": batches_equal(device, val_pipe,
                                       trainer.val_loader,
                                       len(val_pipe))}
    log(f"  batches on {device.type} against get_batch on the CPU: "
        f"train's first (augmented, {train_pipe.producer}) max |diff| "
        f"{bits['train_first']}, validation's {len(val_pipe)} kept "
        f"through the epoch ({val_pipe.producer}) {bits['val_epoch']}")
    if any(bits.values()):
        raise AssertionError(f"the pipeline's batches differ: {bits}")

    # the loop against the bare step
    unit = "" if cuda else " [CPU rehearsal, not device numbers]"
    times = sorted(run1.step_ms())
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(round(0.95 * (len(times) - 1))))]
    mean = sum(times) / len(times)
    bsz = cfg.training.batch_size
    last = run1.epochs[-1]
    wait_ms = last["wait_s"] * 1000.0 / last["steps"]
    loop = {"step_p50_ms": p50, "step_p95_ms": p95, "step_mean_ms": mean,
            "images_per_sec": bsz * 1000.0 / mean,
            "steps_timed": len(times), "bare_step_p50_ms": bare_p50,
            "queue_wait_ms_per_step": wait_ms,
            "epoch_wall_s": [ep["wall_s"] for ep in run1.epochs],
            "producer": last["producer"],
            "val_producer": trainer.val_pipe.producer,
            "warp_counts": counts, "steps": steps,
            "bits_max_abs": bits, "samples": meta["num_samples"]}
    log(f"  [{card}] trainer loop, batch {bsz}: step p50 {p50:.3f} ms, "
        f"p95 {p95:.3f} ms, mean {mean:.3f} ms, "
        f"{loop['images_per_sec']:.2f} images/s ({len(times)} steps, "
        f"host clock from step to step); bare TrainStep p50 (phase 9) "
        f"{bare_p50:.3f} ms; waited on the queue {wait_ms:.3f} ms a "
        f"step (epoch {last['epoch']}); epochs "
        + ", ".join(f"{ep['wall_s']:.2f} s" for ep in run1.epochs)
        + f"; producer {last['producer']}{unit}")
    loop["gap_ms"] = p50 - bare_p50
    if cuda:
        prof = copy_profile(trainer, 6)
        loop["copy"] = prof
        if prof is None or not prof["copies"]:
            log(f"  [{card}] the copies to the card: not measured (the "
                "profile held no host-to-device copy on a side stream)")
        else:
            log(f"  [{card}] the pipeline's copies to the card "
                f"(torch.profiler, 6 loop steps): {prof['copies']} "
                f"host-to-device memcpys on stream {prof['stream']} "
                f"(the step's kernels on {prof['compute_stream']}), "
                f"{prof['ms_per_batch']:.4f} ms a batch, "
                f"{prof['overlapped_share']:.1%} of it while a kernel "
                "ran on the step's stream")
    # where the loop's time over the bare step goes: the same loop body
    # fed by the pipeline (its producer threads running) and from
    # batches already on the device (no producer threads), in turns,
    # LOOP_PAIRS pairs (phase 9's bare step ran minutes earlier, and
    # a host-bound step's p50 moves between runs and within one)
    n = min(20, per_epoch - 2)
    held = []
    for b in trainer.train_pipe:
        held.append(b)
        if len(held) == n + 1:
            break
    pairs = [(fed_step_ms(trainer, trainer.train_pipe, n),
              fed_step_ms(trainer, held, n)) for _ in range(LOOP_PAIRS)]
    del held
    diffs = sorted(p[0] - h[0] for p, h in pairs)
    cost = diffs[len(diffs) // 2]
    waits = sorted(p[2] for p, _ in pairs)
    pipe_wait = waits[len(waits) // 2]
    loop["fed_pairs_p50_p95_wait_ms"] = pairs
    loop["producer_cost_ms"] = cost
    above = sum(d > pipe_wait for d in diffs)
    loop["gil_finding"] = (
        "the producer threads take the dispatching thread's time: fed "
        "by the pipeline, the loop body is slower than fed from held "
        "batches by more than its queue wait"
        if cost > pipe_wait and above >= LOOP_PAIRS - 1 else
        "the producer threads do not slow the dispatching thread: fed "
        "by the pipeline, the loop body is within its queue wait of "
        "the held-fed body" if cost <= pipe_wait else
        "unresolved: the pairs disagree")
    log(f"  [{card}] the loop body ({n} steps a block, p50 ms), fed by "
        "the pipeline / from batches held on the device, in turns: "
        + ", ".join(f"{p[0]:.3f} / {h[0]:.3f}" for p, h in pairs)
        + f"; the pipeline-fed blocks waited {pipe_wait:.3f} ms a step "
        f"on the queue (median); bare TrainStep p50 (phase 9) "
        f"{bare_p50:.3f} ms{unit}")
    log(f"  [{card}] pipeline-fed p50 - held-fed p50, median of "
        f"{LOOP_PAIRS} pairs: {cost:.3f} ms ({above} of {LOOP_PAIRS} "
        f"pairs above the wait): {loop['gil_finding']}{unit}")
    del trainer, run1

    # resume from the latest checkpoint for a third epoch
    with LoopProbe() as run2:
        rc = train_cli.main(["--config", str(loop_yaml(root, args, 3)),
                             "--resume", "latest"] + argv)
    if rc != 0:
        raise AssertionError(f"the resumed train CLI exited {rc}")
    ep = run2.epochs[0]
    first = float(run2.losses[0])
    log(f"  resumed: started at epoch {ep['epoch']} with step "
        f"{ep['step_before']} and optimizer updates "
        f"{ep['updates_before']} (the first run took {steps}); first "
        f"loss {first:.5g}")
    if ep["epoch"] != 2 or ep["step_before"] != steps or \
            ep["updates_before"] != steps or not math.isfinite(first):
        raise AssertionError(f"resume: {ep}, first loss {first}")
    loop["resume"] = {"start_epoch": ep["epoch"],
                      "step": ep["step_before"],
                      "updates": ep["updates_before"],
                      "first_loss": first}
    del run2

    # the evaluate CLI on best/
    out = root / "eval"
    rc = evaluate_cli.main(
        ["--checkpoint", "best", "--config", str(loop_yaml(root, args, 3)),
         "--output", str(out), "--max-samples", str(args.loop_val),
         "--batch-size", str(cfg.training.batch_size), "--num-vis", "2"]
        + argv)
    per_sample = list(csv.reader((out / "per_sample_metrics.csv").open()))
    summary = list(csv.reader((out / "summary_metrics.csv").open()))
    abs_rel = {r[0]: r[1] for r in summary[1:]}.get("abs_rel")
    log(f"  evaluate CLI on best/: exit {rc}, {len(per_sample) - 1} "
        f"samples (validation capped at {args.loop_val}), mean abs_rel "
        f"{abs_rel}, files {sorted(p.name for p in out.iterdir())}")
    if rc != 0 or len(per_sample) - 1 != args.loop_val or \
            not (out / "report.txt").exists():
        raise AssertionError("the evaluate CLI's outputs")
    loop["eval"] = {"samples": len(per_sample) - 1,
                    "abs_rel": float(abs_rel)}
    return loop



# phase 20: the GPU-resident feed
B32_CONFIG = ROOT / "configs" / "train_config_flagship_b32.yaml"
# pairs of loop and bare-step blocks at batch 32; of device-fed and
# host-fed loop blocks at batch 4
FEED_PAIRS, FEED_B4_PAIRS = 3, 5
FEED_STORAGES = ("float32", "bfloat16", "quantized")


def feed_storage(name: str) -> dict:
    import torch

    return {"float32": {},
            "bfloat16": {"rgb_dtype": torch.bfloat16},
            "quantized": {"rgb_dtype": torch.uint8,
                          "depth_dtype": torch.uint16}}[name]


def feed_yaml(root: pathlib.Path, args, epochs: int,
              device_resident: bool = True) -> pathlib.Path:
    """configs/train_config_flagship_b32.yaml with phase 20's changes: the
    pack, the epochs, checkpoints and logs under ``root``, validation
    capped. The width, size and batch are the shipped ones on the card
    (checked); a CPU rehearsal shrinks them."""
    import yaml

    shipped = yaml.safe_load(B32_CONFIG.read_text())
    raw = deep_merge(yaml.safe_load(B32_CONFIG.read_text()), {
        "data": {"packed_dir": str(root / "pack"),
                 "device_resident": device_resident,
                 "input_height": args.height, "input_width": args.width},
        "model": {"init_features": args.init_features},
        "training": {"num_epochs": epochs, "batch_size": args.feed_batch,
                     "max_val_samples": args.feed_val},
        "checkpointing": {"checkpoint_dir": str(root / "ckpts")},
        "logging": {"log_dir": str(root / "logs")},
    })
    if args.height == 240:
        for section, key in (("data", "input_height"),
                             ("data", "input_width"),
                             ("model", "init_features"),
                             ("training", "batch_size")):
            if raw[section][key] != shipped[section][key]:
                raise AssertionError(f"{section}.{key} is not the shipped "
                                     f"{shipped[section][key]}")
    path = root / f"feed_{epochs}_{int(device_resident)}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def batch_diff(got, want):
    """(largest |difference|, differing elements, batches) of two streams
    of batches, ``want`` on the CPU."""
    worst, differing, n = 0.0, 0, 0
    for g, w in zip(got, want, strict=True):
        for k, v in w.items():
            a = g[k].cpu()
            if a.shape != v.shape or a.dtype != v.dtype:
                raise AssertionError(f"{k}: {tuple(a.shape)} {a.dtype} "
                                     f"against {tuple(v.shape)} {v.dtype}")
            worst = max(worst, float((a - v).abs().max()))
            differing += int((a != v).sum())
        n += 1
    return worst, differing, n


def feed_batches(device, args, card: str, pack: pathlib.Path):
    """Phase 20b: DeviceDataset's batches on the card against the same
    class on the CPU, two epochs, each storage, augmented and not; the
    f32 ones also against fast_batch; the chunked feed against the
    resident one on the card; the device time of one batch's gather,
    decode and augmentation against its bound; the upload's rate and
    each storage's nbytes()."""
    import numpy as np
    import torch
    import yaml

    from cadepth_tpu_torch.data.device_resident import (ChunkedDeviceDataset,
                                                        DeviceDataset)
    from cadepth_tpu_torch.data.packed import PackedSunRGBDLoader
    from cadepth_tpu_torch.data.sunrgbd import AugmentationConfig

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal, not device numbers]"
    aug = yaml.safe_load(B32_CONFIG.read_text())["data"]["augmentation"]
    cfg = AugmentationConfig(
        crop_scale_min=aug["crop_scale_min"],
        crop_scale_max=aug["crop_scale_max"],
        horizontal_flip_prob=aug["flip_probability"],
        brightness_delta=aug["brightness"], contrast_delta=aug["contrast"],
        random_seed=args.seed + 20)
    kw = dict(split="train", compute_rays=True, rays_on_device=True)
    loader = PackedSunRGBDLoader(str(pack), **kw)
    loader.enable_augmentation(cfg)
    plain = PackedSunRGBDLoader(str(pack), **kw)
    bsz, seed = args.feed_batch, args.seed + 20
    h, w = loader.target_height, loader.target_width
    out = {"batch": bsz, "samples": len(loader), "storages": {}}
    if cuda:
        torch.empty(1, device=device)   # the context, outside the timing
        torch.cuda.synchronize()
    for name in FEED_STORAGES:
        # the upload: the host's read of the pack, encoding or conversion,
        # and the copy to the card
        t0 = time.perf_counter()
        card_ds = DeviceDataset(loader, device=device, **feed_storage(name))
        if cuda:
            torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        cpu_ds = DeviceDataset(loader, device="cpu", **feed_storage(name))
        row = {"nbytes": card_ds.nbytes(), "upload_s": upload_s,
               "upload_gb_per_s": card_ds.nbytes() / upload_s / 1e9}
        for epoch in (0, 1):
            for augment in (False, True):
                args_ = dict(seed=seed, epoch=epoch, augment=augment,
                             drop_remainder=False)
                diff = batch_diff(card_ds.batches(bsz, **args_),
                                  cpu_ds.batches(bsz, **args_))
                row[f"epoch{epoch}_{'aug' if augment else 'plain'}"] = diff
                if diff[1]:
                    raise AssertionError(
                        f"{name} storage, epoch {epoch}, augment {augment}: "
                        f"the card's batches differ from the CPU's in "
                        f"{diff[1]} elements (max {diff[0]})")
        if name == "float32":
            for epoch in (0, 1):
                order = np.arange(len(plain))
                np.random.default_rng([seed, epoch]).shuffle(order)
                want = [{k: torch.from_numpy(v) for k, v in plain.fast_batch(
                    order[s:s + bsz]).items()}
                    for s in range(0, len(order), bsz)]
                diff = batch_diff(card_ds.batches(
                    bsz, seed=seed, epoch=epoch, drop_remainder=False), want)
                row[f"epoch{epoch}_vs_fast_batch"] = diff
                if diff[1]:
                    raise AssertionError(f"f32 batches against fast_batch: "
                                         f"{diff}")
        # one batch's gather, decode and augmentation on the device
        idx = torch.arange(bsz, device=device)
        per_sample = (card_ds.rgb.element_size() * 3
                      + card_ds.depth.element_size()) * h * w + 9 * 4
        # read each sample, its index and draws once; write rgb, depth, K
        # and k4 once in f32
        moved = bsz * (per_sample + 8 + 6 * 4 + (4 * h * w + 13) * 4)
        row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        row["bytes"] = moved
        for augment in (False, True):
            key = "aug" if augment else "plain"
            if cuda:
                row[f"{key}_ms"], per_kernel = device_ms(
                    lambda: card_ds._gather(idx, 1, augment), 20)
                row[f"{key}_kernels"] = len(per_kernel)
            else:
                row[f"{key}_ms"], row[f"{key}_kernels"] = None, None
        out["storages"][name] = row
        log(f"  {name} storage: nbytes {row['nbytes'] / 2**20:.1f} MiB, "
            f"uploaded (host read, conversion, copy) in "
            f"{row['upload_s']:.2f} s = {row['upload_gb_per_s']:.2f} GB/s; "
            f"card against CPU over 2 epochs, plain and augmented: "
            + ", ".join(f"{k} max|diff| {v[0]} ({v[2]} batches)"
                        for k, v in row.items() if k.startswith("epoch")))
        log(f"  [{card}] {name} storage, one batch of {bsz} on the device: "
            + "; ".join(
                f"{'augmented' if k == 'aug' else 'gather and decode'} "
                + (f"{row[k + '_ms']:.4f} ms device ({row[k + '_kernels']} "
                   f"kernels, torch.profiler)" if row[k + "_ms"] else
                   "not measured")
                for k in ("plain", "aug"))
            + f"; bound {row['bound_ms'] * 1e3:.1f} us ({moved / 1e6:.1f} "
            f"MB at 3.35 TB/s){unit}")
        del card_ds, cpu_ds
    for name in ("float32", "quantized"):
        resident = DeviceDataset(loader, device=device, **feed_storage(name))
        for prefetch in ("thread", "serial"):
            chunked = ChunkedDeviceDataset(loader, args.feed_chunk,
                                           device=device,
                                           **feed_storage(name))
            for epoch in (0, 1):
                args_ = dict(seed=seed, epoch=epoch, augment=True,
                             drop_remainder=False)
                diff = batch_diff(chunked.batches(bsz, prefetch=prefetch,
                                                  **args_),
                                  ({k: v.cpu() for k, v in b.items()}
                                   for b in resident.batches(bsz, **args_)))
                out[f"chunked_{name}_{prefetch}_epoch{epoch}"] = diff
                if diff[1]:
                    raise AssertionError(f"chunked ({name}, {prefetch}) "
                                         f"against resident: {diff}")
            del chunked
        del resident
    chunks = -(-len(loader) // args.feed_chunk)
    log(f"  ChunkedDeviceDataset ({args.feed_chunk} samples a chunk, "
        f"{chunks} chunks an epoch; f32 and quantized; thread and serial) "
        f"against DeviceDataset on {device.type}, 2 augmented epochs: "
        + ", ".join(f"{k[8:]} {v[0]}" for k, v in out.items()
                    if k.startswith("chunked_")))
    out["chunks_per_epoch"] = chunks
    return out


def check_b32_kernels(device, args, card: str):
    """Phase 20c: the two-pass kernels at batch 32: forward and backward
    against their plain versions at each decoder level (phases 3 and 6's
    checks and tolerances), and their device times per level."""
    import copy

    import torch

    shapes = decoder_shapes(args.feed_batch, args.height, args.width,
                            args.init_features)
    with torch.no_grad():
        fwd = check_kernel(device, shapes, args.seed + 21)
    bwd = check_backward(device, shapes, args.seed + 22)
    b32 = copy.copy(args)
    b32.train_batch, b32.timing_iters = args.feed_batch, args.feed_iters
    rows = bwd_times(device, b32, card)
    log(f"  [{card}] two_pass_warp at batch {args.feed_batch} over the five "
        "levels: " + ", ".join(
            f"{k} {v:.4f} ms" for k in ("train_fwd_ms", "kernel_ms",
                                        "bound_ms", "kernel_host_ms")
            if (v := level_sum(rows, k)) is not None))
    return {"fwd_max_abs_err": fwd, "bwd_max_abs_err": bwd, "levels": rows}


def bare_step_ms(trainer, batches, steps: int):
    """p50 (ms) of ``steps`` bare train steps on held batches: the host
    clock from a step's call to a synchronize after it."""
    import torch

    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)])
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


def busy_share(trainer, steps: int = 3):
    """The device's busy time and share of the wall time over ``steps``
    loop steps fed by the trainer's own pipeline (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    it = iter(trainer.train_pipe)
    trainer.train_step(next(it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(next(it))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000.0 / steps
    rows = device_rows(prof, steps)
    busy = sum(r[0] for r in rows)
    return {"busy_ms": busy, "wall_ms": wall,
            "busy_share": busy / wall if wall else None,
            "kernels_per_step": sum(r[1] for r in rows)}


def feed_train(device, args, card: str, root: pathlib.Path):
    """Phase 20d: the train CLI on configs/train_config_flagship_b32.yaml
    from the pack held on the card: two epochs, counted; the loop's times,
    in turns with the bare step on held batches; the busy share and peak
    memory; --resume latest for a third epoch; the evaluate CLI on best/
    with the device sweep and the host sweep."""
    import csv
    import math

    import torch

    from cadepth_tpu_torch.cli import evaluate as evaluate_cli
    from cadepth_tpu_torch.cli import train as train_cli
    from cadepth_tpu_torch.data.device_resident import DevicePipeline

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal, not device numbers]"
    argv = ["--device", device.type]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the main path: two epochs through the train CLI, counted
    reset_warp_counts()
    with LoopProbe() as run1:
        rc = train_cli.main(["--config", str(feed_yaml(root, args, 2))]
                            + argv)
    counts = warp_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if rc != 0:
        raise AssertionError(f"the train CLI exited {rc}")
    trainer = run1.trainers[0]
    if not isinstance(trainer.train_pipe, DevicePipeline) or \
            trainer.val_pipe.dataset.rgb is not trainer.train_pipe.dataset.rgb:
        raise AssertionError("the Trainer did not take the resident feed "
                             "with one upload for both splits")
    steps = sum(ep["steps"] for ep in run1.epochs)
    per_epoch = len(trainer.train_pipe)
    val_batches = len(trainer.val_pipe)
    vis = min(trainer.cfg.training.num_vis_samples, len(trainer.val_loader))
    panels = 2 if vis else 0
    n_pcl = len(pcl_layers(trainer.model))
    forwards_no_v = 2 * val_batches + panels
    want = {"v_stores": n_pcl * steps if cuda else 0,
            "bwd_launches": 3 * n_pcl * steps if cuda else 0,
            "launches": n_pcl * (steps + forwards_no_v) if cuda else 0,
            "fused": 0, **norm_counts(trainer.model, steps, cuda)}
    bsz = trainer.cfg.training.batch_size
    log(f"  train CLI on {B32_CONFIG.relative_to(ROOT)}: "
        f"{len(run1.epochs)} epochs of {per_epoch} steps (batch {bsz}, "
        f"{len(trainer.train_loader)} train samples, augmented on the "
        f"device), validation {val_batches} batches an epoch from the same "
        f"upload, {vis} panels an epoch; two_pass_warp over the run: "
        f"{counts['launches']} forward launches ({counts['v_stores']} "
        f"storing V, {n_pcl} a step), {counts['bwd_launches']} backward "
        f"launches ({3 * n_pcl} a step), fused_warp {counts['fused']}, "
        f"batch norm kernel calls {counts['bn']} + {counts['bn_bwd']} "
        f"({training_norms(trainer.model)} each way a step); expected "
        f"{want}")
    if [ep["steps"] for ep in run1.epochs] != [per_epoch] * 2:
        raise AssertionError(f"epochs ran {run1.epochs} steps")
    if counts != want:
        raise AssertionError(f"warp launches {counts} != {want}")
    losses = [float(x) for x in run1.losses]
    ckpt_dir = root / "ckpts" / trainer.cfg.experiment.name
    step_dirs = sorted(p.name for p in ckpt_dir.glob("step_*"))
    log(f"  {len(losses)} step losses, first {losses[0]:.5g}, last "
        f"{losses[-1]:.5g}; checkpoints {step_dirs} and best/")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"step losses {losses}")
    if not step_dirs or not (ckpt_dir / "best" / "state.pt").exists():
        raise AssertionError(f"checkpoints: {step_dirs}")

    times = sorted(run1.step_ms())
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(round(0.95 * (len(times) - 1))))]
    mean = sum(times) / len(times)
    out = {"batch": bsz, "steps": steps, "warp_counts": counts,
           "step_p50_ms": p50, "step_p95_ms": p95, "step_mean_ms": mean,
           "images_per_sec": bsz * 1000.0 / mean, "steps_timed": len(times),
           "epoch_wall_s": [ep["wall_s"] for ep in run1.epochs],
           "peak_bytes": peak, "samples": len(trainer.train_loader)}
    log(f"  [{card}] device-fed loop, batch {bsz}: step p50 {p50:.3f} ms, "
        f"p95 {p95:.3f} ms, mean {mean:.3f} ms, "
        f"{out['images_per_sec']:.2f} images/s ({len(times)} steps, host "
        f"clock from step to step); epochs "
        + ", ".join(f"{ep['wall_s']:.2f} s" for ep in run1.epochs)
        + (f"; peak device memory {peak / 2**30:.3f} GiB" if peak else "")
        + unit)
    # the loop body fed by the device pipeline against the bare step on
    # held batches, in turns
    n = max(min(12, per_epoch - 2), 2)
    held = []
    for b in trainer.train_pipe:
        held.append(b)
        if len(held) == n:
            break
    pairs = [(fed_step_ms(trainer, trainer.train_pipe, n)[0],
              bare_step_ms(trainer, held, n)) for _ in range(FEED_PAIRS)]
    del held
    out["loop_bare_pairs_p50_ms"] = pairs
    diffs = sorted(a - b for a, b in pairs)
    out["loop_minus_bare_median_ms"] = diffs[len(diffs) // 2]
    log(f"  [{card}] loop body fed by the device pipeline ({n} steps a "
        "block, p50 ms) / bare TrainStep on held batches, to a "
        "synchronize, in turns: "
        + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in pairs)
        + f"; median difference {out['loop_minus_bare_median_ms']:.3f} ms"
        + unit)
    if cuda:
        out["profile"] = busy_share(trainer)
        prof = out["profile"]
        # the profiler slows the host: its wall is no measure of the loop's
        prof["busy_of_loop_p50"] = prof["busy_ms"] / p50
        log(f"  [{card}] profile of 3 device-fed loop steps "
            f"(torch.profiler): device busy {prof['busy_ms']:.3f} ms of "
            f"{prof['wall_ms']:.3f} ms profiled wall "
            f"({prof['busy_share']:.1%}), {prof['busy_of_loop_p50']:.1%} "
            f"of the unprofiled loop's p50; {prof['kernels_per_step']} "
            "kernels a step")
    cfg = trainer.cfg
    del trainer, run1

    # resume from the latest checkpoint for a third epoch
    with LoopProbe() as run2:
        rc = train_cli.main(["--config", str(feed_yaml(root, args, 3)),
                             "--resume", "latest"] + argv)
    if rc != 0:
        raise AssertionError(f"the resumed train CLI exited {rc}")
    ep = run2.epochs[0]
    first = float(run2.losses[0])
    log(f"  resumed: started at epoch {ep['epoch']} with step "
        f"{ep['step_before']} (the first run took {steps}); first loss "
        f"{first:.5g}")
    if ep["epoch"] != 2 or ep["step_before"] != steps or \
            not math.isfinite(first):
        raise AssertionError(f"resume: {ep}, first loss {first}")
    out["resume"] = {"start_epoch": ep["epoch"], "step": ep["step_before"],
                     "first_loss": first}
    del run2

    # the evaluate CLI on best/, sweeping the card and the host
    rows = {}
    for device_resident in (True, False):
        dest = root / f"eval_{int(device_resident)}"
        rc = evaluate_cli.main(
            ["--checkpoint", "best", "--config",
             str(feed_yaml(root, args, 3, device_resident)),
             "--output", str(dest), "--max-samples", str(args.feed_val),
             "--batch-size", str(bsz), "--num-vis", "1"] + argv)
        if rc != 0:
            raise AssertionError(f"the evaluate CLI exited {rc}")
        rows[device_resident] = list(csv.reader(
            (dest / "per_sample_metrics.csv").open()))
    same = rows[True] == rows[False]
    abs_rel = sum(float(r[1]) for r in rows[True][1:]) / \
        max(len(rows[True]) - 1, 1)
    log(f"  evaluate CLI on best/: {len(rows[True]) - 1} samples swept from "
        f"the card and {len(rows[False]) - 1} by the host pipeline, "
        f"per-sample metrics equal: {same}; mean abs_rel {abs_rel:.5g}")
    if not same or len(rows[True]) - 1 != args.feed_val:
        raise AssertionError("the device sweep's per-sample metrics differ "
                             "from the host sweep's")
    out["eval"] = {"samples": len(rows[True]) - 1, "abs_rel": abs_rel,
                   "device_equals_host": same,
                   "config": cfg.experiment.name}
    return out


def feed_b4_pairs(device, args, card: str, root: pathlib.Path):
    """Phase 20e: the shipped configs/train_config.yaml (geometry_aware_full,
    batch 4) with data.device_resident on the same pack: its loop body fed
    by the device pipeline and by phase 19's host pipeline (4 producer
    threads, augmentation on the host), in turns, the same steps."""
    import yaml

    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.data.pipeline import InputPipeline
    from cadepth_tpu_torch.training.trainer import Trainer

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal, not device numbers]"
    raw = deep_merge(yaml.safe_load(loop_yaml(root, args, 1).read_text()),
                     {"data": {"device_resident": True},
                      "logging": {"tensorboard": {"enabled": False}}})
    path = root / "feed_b4.yaml"
    path.write_text(yaml.safe_dump(raw))
    trainer = Trainer(load_config(str(path),
                                  experiment="geometry_aware_full"),
                      device=device)
    try:
        cfg = trainer.cfg
        host = InputPipeline(trainer.train_loader, cfg.training.batch_size,
                             shuffle=True, seed=cfg.experiment.seed,
                             num_threads=4, device=device)
        n = max(min(20, len(host) - 2), 2)
        fed_step_ms(trainer, trainer.train_pipe, n)   # warm-up
        blocks = [(fed_step_ms(trainer, trainer.train_pipe, n),
                   fed_step_ms(trainer, host, n))
                  for _ in range(FEED_B4_PAIRS)]
    finally:
        trainer.close()
    pairs = [(d[0], h[0]) for d, h in blocks]
    diffs = sorted(h - d for d, h in pairs)
    waits = sorted(h[2] for _, h in blocks)
    out = {"batch": cfg.training.batch_size, "steps_a_block": n,
           "device_host_pairs_p50_ms": pairs,
           "host_minus_device_median_ms": diffs[len(diffs) // 2],
           "host_slower_pairs": sum(x > 0 for x in diffs),
           "host_queue_wait_ms": waits[len(waits) // 2]}
    log(f"  [{card}] batch {out['batch']} loop body ({n} steps a block, "
        "p50 ms), fed from the card / by the host pipeline, in turns: "
        + ", ".join(f"{d:.3f} / {h:.3f}" for d, h in pairs)
        + f"; host - device, median of {FEED_B4_PAIRS} pairs "
        f"{out['host_minus_device_median_ms']:.3f} ms "
        f"({out['host_slower_pairs']} of {FEED_B4_PAIRS} pairs slower on "
        f"the host feed; its consumer waited {out['host_queue_wait_ms']:.3f} "
        f"ms a step on the queue, median){unit}")
    return out


def device_feed(device, args, card: str, root: pathlib.Path):
    """Phase 20: the GPU-resident feed. A pack of seeded structured scenes
    at the training size; the feed's batches on the card against the CPU
    and the chunked feed against the resident one; the two-pass kernels
    at batch 32; the flagship's batch-32 config trained, resumed and
    evaluated from the card; batch 4 fed from the card against the host
    pipeline. The pack and the run stay under ``root`` (phase 22 serves
    its checkpoints)."""
    t0 = time.perf_counter()
    meta = write_pack(root, args, args.feed_scenes, args.seed + 20)
    out = {"pack": {"samples": meta["num_samples"],
                    "build_s": time.perf_counter() - t0}}
    out["batches"] = feed_batches(device, args, card, root / "pack")
    out["two_pass_b32"] = check_b32_kernels(device, args, card)
    out["train"] = feed_train(device, args, card, root)
    out["b4_pairs"] = feed_b4_pairs(device, args, card, root)
    return out


# phase 21: the other model families
TRAIN_CONFIG = ROOT / "configs" / "train_config.yaml"
# (case, experiment block of configs/train_config.yaml; None: its base
# model, baseline_unet)
FAMILY_CASES = (("baseline_unet", None),
                ("ablation_film_only", "ablation_film_only"),
                ("intrinsics_only", "intrinsics_only"),
                ("geometry_aware_lightweight", "geometry_aware_lightweight"))
FAMILY_STEPS = 10


def family_config(args, experiment):
    """configs/train_config.yaml with ``experiment`` as shipped: 240x320,
    the family's width and batch (checked on the card); a CPU rehearsal
    shrinks the size, the width and the batch."""
    from cadepth_tpu_torch.config import load_config

    cfg = load_config(str(TRAIN_CONFIG), experiment=experiment)
    if args.height == 240:
        d, m = cfg.data, cfg.model
        if (d.input_height, d.input_width, m.init_features,
                cfg.training.batch_size) != (240, 320, 64, 8):
            raise AssertionError(f"{experiment}: not the shipped 240x320, "
                                 "f=64, batch 8")
    else:
        cfg.data.input_height, cfg.data.input_width = args.height, args.width
        cfg.model.init_features = args.init_features
        cfg.training.batch_size = args.train_batch
    return cfg


def profile_steps(step, batches, n: int = 3):
    """(device busy ms, kernels) per call of ``step`` over ``n`` profiled
    calls (torch.profiler)."""
    out = step_profile(step, batches, n)
    return out["busy_ms"], out["kernels"]


def family_case(device, args, card: str, case: str, experiment):
    """Phase 21a: one family as configs/train_config.yaml ships it: 10
    train steps on seeded batches, counted; a Predictor at the batch and
    at batch 1; times, profiles, peak memory; the small f32 model card
    against CPU. For the lightweight network also its warp kernels
    against plain at its four levels, served depths against the plain
    warp and the kernels' times at its levels."""
    import math

    import numpy as np
    import torch

    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.models.factory import count_parameters
    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.ops.affine_warp import two_pass_affine_warp_plain
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    cfg = family_config(args, experiment)
    m, bsz = cfg.model, cfg.training.batch_size
    h, w = cfg.data.input_height, cfg.data.input_width
    gen = torch.Generator().manual_seed(args.seed + 21)
    model, loss_fn = ts.build_model_and_loss(cfg, device=device,
                                             generator=gen)
    rotate_pcl_heads(model, gen)
    n_pcl = len(pcl_layers(model))
    out = {"model": type(model).__name__, "architecture": m.architecture,
           "init_features": model.out_conv.in_channels, "batch": bsz,
           "parameters": count_parameters(model), "pcls": n_pcl}
    log(f"  {case}: {out['model']} ({m.architecture}, variant {m.variant}, "
        f"use_attention {m.use_attention}), f={out['init_features']}, "
        f"{h}x{w}, batch {bsz}, {'bf16' if cfg.training.use_amp else 'f32'}"
        f" over fp32 parameters, {out['parameters']:,} parameters")

    schedule = build_lr_schedule(cfg.optimization, STEPS_PER_EPOCH,
                                 cfg.training.num_epochs)
    step = ts.make_train_step(
        cfg, model, loss_fn,
        ts.build_optimizer(cfg.optimization, model.parameters()), schedule)
    rng = np.random.default_rng(args.seed + 21)
    batches = [synthetic_batch(rng, bsz, h, w, device)
               for _ in range(FAMILY_STEPS)]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # this path, counted
    reset_warp_counts()
    logs, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        logs.append(step(b))
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    counts = warp_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    logs = [{k: float(v) for k, v in x.items()} for x in logs]
    calls = n_pcl * FAMILY_STEPS if cuda else 0
    want = {"launches": calls, "bwd_launches": 3 * calls, "v_stores": calls,
            "fused": 0, **norm_counts(model, FAMILY_STEPS, cuda)}
    losses = [x["total_loss"] for x in logs]
    log(f"  {FAMILY_STEPS} train steps: losses "
        + " ".join(f"{x:.5g}" for x in losses)
        + f"; two_pass_warp and batch norm {counts} (expected {want}: "
        f"{training_norms(model)} training norms a step)")
    if counts != want:
        raise AssertionError(f"{case}: warp counts {counts} != {want}")
    if not all(math.isfinite(v) for x in logs for v in x.values()):
        raise AssertionError(f"{case}: non-finite logs {logs}")
    timed = sorted(times[2:])
    mean = sum(timed) / len(timed)
    out.update(train_counts=counts, losses=losses, peak_bytes=peak,
               step_p50_ms=timed[len(timed) // 2], step_p95_ms=timed[-1],
               images_per_sec=bsz * 1000.0 / mean)
    if cuda:
        out["step_busy_ms"], out["step_kernels"] = profile_steps(step,
                                                                 batches)
    log(f"  [{card}] train step batch {bsz}: p50 {out['step_p50_ms']:.3f} "
        f"ms, p95 {out['step_p95_ms']:.3f} ms, "
        f"{out['images_per_sec']:.2f} images/s (steps 3-{FAMILY_STEPS}, host "
        f"clock to a synchronize){unit}"
        + (f"; device busy {out['step_busy_ms']:.3f} ms a step, "
           f"{out['step_kernels']} kernels (torch.profiler, 3 steps); peak "
           f"{peak / 2**30:.3f} GiB" if cuda else ""))

    # serving the trained weights at the batch and at batch 1
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del step, model, loss_fn
    req = np.random.default_rng(args.seed + 22).uniform(
        0, 1, (bsz, h, w, 3)).astype(np.float32)
    for b in (bsz, 1):
        pred = Predictor(cfg, sd, batch_size=b, device=device)
        reset_warp_counts()
        depth = pred.predict(req[:b])
        served = warp_counts()
        want = {"launches": n_pcl if cuda else 0, "bwd_launches": 0,
                "v_stores": 0, "fused": 0, **NO_NORMS}
        ok = np.isfinite(depth).all() and 0 < depth.min() and \
            depth.max() < m.max_depth
        if not ok or served != want:
            raise AssertionError(f"{case} batch {b}: depths in "
                                 f"[{depth.min()}, {depth.max()}], warp "
                                 f"counts {served} != {want}")
        bench = pred.benchmark(iterations=args.mode_bench_iters, warmup=3)
        row = {"p50_ms": bench["p50_ms"], "p95_ms": bench["p95_ms"],
               "images_per_sec": bench["images_per_sec"],
               "warp_counts": served}
        if cuda and b == bsz:
            prof = profile_forward(pred, card)
            row.update(busy_ms=prof["busy_ms"],
                       kernels=prof["kernels_per_forward"])
        log(f"  [{card}] Predictor batch {b}: depths in [{depth.min():.4f}, "
            f"{depth.max():.4f}] m, two_pass_warp launches "
            f"{served['launches']} a forward (expected {want['launches']}); "
            f"p50 {bench['p50_ms']:.3f} ms, p95 {bench['p95_ms']:.3f} ms, "
            f"{bench['images_per_sec']:.2f} images/s{unit}")
        out[f"predictor_b{b}"] = row
    if n_pcl:
        # the served depths with the kernel against the plain warp
        pred_b = Predictor(cfg, sd, batch_size=bsz, device=device)
        kernel_depth = pred_b.predict(req)
        for pcl in pcl_layers(pred_b.model):
            pcl.warp = two_pass_affine_warp_plain
        err = float(np.abs(kernel_depth - pred_b.predict(req)).max())
        log(f"  served depths, kernel vs plain warp on the {device.type}: "
            f"max|err| {err:.3g} m (atol {SERVE_ATOL})")
        if not err <= SERVE_ATOL:
            raise AssertionError(f"{case}: served kernel vs plain {err}")
        out["served_vs_plain_max_err_m"] = err
        del pred_b
        # its four levels at its batch, serving and training alike
        shapes = decoder_shapes(bsz, h, w, out["init_features"], levels=4)
        out["fwd_max_abs_err"] = check_kernel(device, shapes, args.seed + 21)
        out["bwd_max_abs_err"] = check_backward(device, shapes,
                                                args.seed + 22)
        out["fwd_levels"], _ = level_times(
            device, args, card, "two_pass_warp (lightweight)",
            tpw.two_pass_warp, two_pass_affine_warp_plain, tpw,
            TWO_PASS_FWD_KEYS, shapes=shapes)
        out["bwd_levels"] = bwd_times(device, args, card, shapes=shapes)
    arch = {"architecture": m.architecture, "variant": m.variant,
            "use_attention": m.use_attention}
    out["card_vs_cpu_f32"] = cross_device_train(device, args, arch, (64, 64))
    return out


def family_cli(device, args, card: str, root: pathlib.Path,
               pack: pathlib.Path):
    """Phase 21b: the train CLI on configs/train_config.yaml as shipped
    (its base model, baseline_unet) from phase 19's pack for one epoch,
    then the evaluate CLI on its best/."""
    import csv
    import math

    import yaml

    from cadepth_tpu_torch.cli import evaluate as evaluate_cli
    from cadepth_tpu_torch.cli import train as train_cli

    raw = deep_merge(yaml.safe_load(TRAIN_CONFIG.read_text()), {
        "data": {"packed_dir": str(pack), "input_height": args.height,
                 "input_width": args.width},
        "training": {"num_epochs": 1, "max_val_samples": args.loop_val},
        "checkpointing": {"checkpoint_dir": str(root / "ckpts")},
        "logging": {"log_dir": str(root / "logs")},
    })
    if args.height != 240:
        raw["model"]["init_features"] = args.init_features
        raw["training"]["batch_size"] = args.train_batch
    path = root / "baseline.yaml"
    path.write_text(yaml.safe_dump(raw))
    argv = ["--device", device.type]
    reset_warp_counts()
    t0 = time.perf_counter()
    with LoopProbe() as run:
        rc = train_cli.main(["--config", str(path)] + argv)
    wall = time.perf_counter() - t0
    counts = warp_counts()
    trainer = run.trainers[0]
    name = trainer.cfg.experiment.name
    losses = [float(x) for x in run.losses]
    best = root / "ckpts" / name / "best" / "state.pt"
    log(f"  train CLI on {TRAIN_CONFIG.relative_to(ROOT)} "
        f"({type(trainer.model).__name__}, f="
        f"{trainer.cfg.model.init_features}, batch "
        f"{trainer.cfg.training.batch_size}): exit {rc}, {len(losses)} steps "
        f"in one epoch, losses {losses[0]:.5g} .. {losses[-1]:.5g}, "
        f"{wall:.1f} s with validation; best/ written: {best.exists()}; "
        f"warp and batch norm counts {counts}")
    want = {"launches": 0, "bwd_launches": 0, "v_stores": 0, "fused": 0,
            **norm_counts(trainer.model, len(losses), device.type == "cuda")}
    if rc != 0 or not losses or not all(map(math.isfinite, losses)) or \
            not best.exists() or counts != want:
        raise AssertionError(f"the baseline_unet train CLI run (counts "
                             f"{counts}, expected {want})")
    del trainer, run
    out_dir = root / "eval"
    rc = evaluate_cli.main(
        ["--checkpoint", "best", "--config", str(path), "--output",
         str(out_dir), "--max-samples", str(args.loop_val), "--batch-size",
         "8", "--num-vis", "1"] + argv)
    rows = list(csv.reader((out_dir / "per_sample_metrics.csv").open()))
    summary = {r[0]: r[1] for r in list(csv.reader(
        (out_dir / "summary_metrics.csv").open()))[1:]}
    log(f"  evaluate CLI on best/: exit {rc}, {len(rows) - 1} samples, mean "
        f"abs_rel {summary.get('abs_rel')}")
    if rc != 0 or len(rows) - 1 != args.loop_val:
        raise AssertionError("the evaluate CLI on the baseline's best/")
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1], "wall_s": wall,
            "eval_samples": len(rows) - 1,
            "eval_abs_rel": float(summary["abs_rel"])}


def other_families(device, args, card: str, root: pathlib.Path,
                   pack: pathlib.Path):
    """Phase 21: the four other families' cases, then the baseline's train
    and evaluate CLIs."""
    out = {case: family_case(device, args, card, case, experiment)
           for case, experiment in FAMILY_CASES}
    out["train_cli"] = family_cli(device, args, card, root, pack)
    return out


# phase 22: serving from a checkpoint
EXPORT_ATOL = 1e-3   # metres; the program runs the same kernels: 0 expected
EXPORT_PAIRS = 5


def run_ms(fn, calls: int = 10) -> float:
    """p50 ms of ``calls`` calls of fn(), each on the host clock to a
    synchronize."""
    import torch

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return sorted(times)[calls // 2]


def serve_checkpoint(device, args, card: str, root: pathlib.Path,
                     run: pathlib.Path, weights):
    """Phase 22: phase 20's run served through Predictor.from_checkpoint
    ("best" and "latest") against Predictors built from the same state
    dicts; the exported program at the batch and at batch 1 against
    predict, counted and timed in turns with the eager forward; phase
    11's pcl_warp fused model exported once; the infer CLI on a 640x480
    PNG."""
    import cv2
    import numpy as np
    import torch

    from cadepth_tpu_torch.cli import infer as infer_cli
    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.inference import Predictor, load_exported
    from cadepth_tpu_torch.ops import fused_warp as fw
    from cadepth_tpu_torch.training.checkpoint import CheckpointManager

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    cfg_path = feed_yaml(run, args, 3)
    cfg = load_config(str(cfg_path))
    h, w, bsz = cfg.data.input_height, cfg.data.input_width, args.batch
    mgr = CheckpointManager(str(run / "ckpts" / cfg.experiment.name))
    rng = np.random.default_rng(args.seed + 22)
    req = synthetic_batch(rng, bsz, h, w, "cpu")
    rgb, kmat = req["rgb"].numpy(), req["intrinsics"].numpy()
    out = {"config": cfg.experiment.name}
    preds = {}
    for which, b in (("best", bsz), ("latest", bsz), ("best", 1)):
        reset_warp_counts()
        pred = Predictor.from_checkpoint(cfg, which, batch_size=b,
                                         device=device)
        depth = pred.predict(rgb[:b], kmat[:b])
        counts = warp_counts()
        n_pcl = len(pcl_layers(pred.model))
        want = {"launches": n_pcl if cuda else 0, "bwd_launches": 0,
                "v_stores": 0, "fused": 0, **NO_NORMS}
        sd = mgr.restore(mgr.resolve(which))["model"]
        same = np.array_equal(depth, Predictor(cfg, sd, batch_size=b,
                                               device=device)
                              .predict(rgb[:b], kmat[:b]))
        log(f"  from_checkpoint({which!r}, batch {b}) "
            f"[{pathlib.Path(mgr.resolve(which)).name}]: depths in "
            f"[{depth.min():.4f}, {depth.max():.4f}] m, bit-equal to the "
            f"state-dict Predictor: {same}; two_pass_warp {counts} "
            f"(expected {want})")
        if not same or counts != want or not np.isfinite(depth).all():
            raise AssertionError(f"from_checkpoint {which} batch {b}")
        out[f"{which}_b{b}"] = {"bit_equal": same, "warp_counts": counts}
        if which == "best":
            preds[b] = pred

    # the exported programs
    for b, pred in preds.items():
        path = root / f"flagship_b{b}.pt2"
        t0 = time.perf_counter()
        nbytes = pred.export(str(path))
        export_s = time.perf_counter() - t0
        fn = load_exported(str(path))
        batch = pred._make_batch(rgb[:b], kmat[:b])
        reset_warp_counts()
        got = fn(batch)
        if cuda:
            torch.cuda.synchronize()
        counts = warp_counts()
        err = float(np.abs(got.cpu().numpy()
                           - pred.predict(rgb[:b], kmat[:b])).max())
        row = {"max_abs_err_m": err, "mib": nbytes / 2**20,
               "export_s": export_s, "warp_counts": counts}
        log(f"  exported program, batch {b}: {row['mib']:.1f} MiB written in "
            f"{export_s:.1f} s; max|program - predict| {err:.3g} m (limit "
            f"{EXPORT_ATOL}); two_pass_warp {counts} a forward")
        if not err <= EXPORT_ATOL or \
                counts["launches"] != (len(pcl_layers(pred.model))
                                       if cuda else 0):
            raise AssertionError(f"exported program batch {b}")
        if b == bsz:
            eager = lambda: pred._predict(batch)  # noqa: E731
            program = lambda: fn(batch)  # noqa: E731
            run_ms(eager, 3)
            run_ms(program, 3)
            pairs = [(run_ms(eager), run_ms(program))
                     for _ in range(EXPORT_PAIRS)]
            row["eager_program_pairs_p50_ms"] = pairs
            log(f"  [{card}] batch {b} forward p50 ms, eager / exported "
                f"program, in turns (10 calls a block, host clock to a "
                f"synchronize): " + ", ".join(f"{a:.3f} / {p:.3f}"
                                              for a, p in pairs) + unit)
        out[f"exported_b{b}"] = row
        path.unlink()

    # pcl_warp fused, phase 11's weights, exported once
    fcfg = flagship_config(args.init_features, args.height, args.width,
                           args.batch, "fused")
    fpred = Predictor(fcfg, weights, batch_size=bsz, device=device)
    path = root / "fused.pt2"
    fpred.export(str(path))
    fn = load_exported(str(path))
    fr = synthetic_batch(rng, bsz, args.height, args.width, "cpu")
    fbatch = fpred._make_batch(fr["rgb"].numpy(), fr["intrinsics"].numpy())
    reset_warp_counts()
    got = fn(fbatch)
    if cuda:
        torch.cuda.synchronize()
    fcount = fw.launches
    err = float(np.abs(got.cpu().numpy() - fpred.predict(
        fr["rgb"].numpy(), fr["intrinsics"].numpy())).max())
    n_pcl = len(pcl_layers(fpred.model))
    log(f"  exported pcl_warp fused program, batch {bsz}: max|program - "
        f"predict| {err:.3g} m; fused_warp launches {fcount} (expected "
        f"{n_pcl if cuda else 0})")
    if not err <= EXPORT_ATOL or fcount != (n_pcl if cuda else 0):
        raise AssertionError("the exported fused program")
    out["exported_fused"] = {"max_abs_err_m": err, "launches": fcount}
    path.unlink()
    del fpred, fn

    # the infer CLI on a 640x480 PNG and an intrinsics.txt
    png, ktxt = root / "frame.png", root / "intrinsics.txt"
    image = cv2.GaussianBlur(rng.integers(0, 256, (480, 640, 3), np.uint8),
                             (9, 9), 0)
    cv2.imwrite(str(png), image)
    k0 = np.array([[518.9, 0, 320.4], [0, 519.5, 242.1], [0, 0, 1]],
                  np.float32)
    np.savetxt(ktxt, k0)
    dest = root / "infer"
    reset_warp_counts()
    rc = infer_cli.main(["--checkpoint", "best", "--config", str(cfg_path),
                         "--image", str(png), "--intrinsics", str(ktxt),
                         "--output", str(dest), "--save-npy", "--device",
                         device.type])
    counts = warp_counts()
    files = sorted(p.name for p in dest.iterdir()) if dest.exists() else []
    rgb0 = cv2.cvtColor(cv2.imread(str(png)), cv2.COLOR_BGR2RGB) \
        .astype(np.float32) / 255.0
    k = k0.copy()
    k[0, 0] *= w / 640
    k[1, 1] *= h / 480
    k[0, 2] *= w / 640
    k[1, 2] *= h / 480
    want = preds[1].predict(cv2.resize(rgb0, (w, h),
                                       interpolation=cv2.INTER_LINEAR)[None],
                            k[None])[0, ..., 0]
    want = cv2.resize(want, (640, 480), interpolation=cv2.INTER_NEAREST)
    got = np.load(dest / "frame_depth.npy")
    same = got.shape == want.shape and np.array_equal(got, want)
    log(f"  infer CLI on a 640x480 PNG: exit {rc}, files {files}, two_pass_"
        f"warp launches {counts['launches']}; its .npy equals a batch-1 "
        f"Predictor on the same resized input: {same}")
    if rc != 0 or files != ["frame_depth.npy", "frame_depth.png",
                            "frame_depth_vis.png"] or not same:
        raise AssertionError("the infer CLI")
    out["infer_cli"] = {"files": files, "equals_predictor": same,
                        "warp_counts": counts}
    return out


# phase 23: data parallel on the card
DP_STEPS = 10        # 23a: steps of the flagship, without and with a group
DP_RANK_STEPS = 3    # 23b: steps of the two ranks against one process
DP_RANKS = 2
DP_WORKER_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_train(cfg, init, batches, device, dp=None):
    """``batches`` train steps of the flagship from the state dict
    ``init`` (None: the seeded initialisation) through ``make_train_step``, over ``dp``'s global batch when
    one is given: the logs, the parameters, the BN running statistics and
    each step's host time to a synchronize (ms)."""
    import torch

    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    model, loss_fn = ts.build_model_and_loss(cfg, device=device, dp=dp)
    if init is not None:
        model.load_state_dict(init)
    schedule = build_lr_schedule(cfg.optimization, STEPS_PER_EPOCH,
                                 cfg.training.num_epochs)
    step = ts.make_train_step(
        cfg, model, loss_fn,
        ts.build_optimizer(cfg.optimization, model.parameters()), schedule)
    logs, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        logs.append(step(b))
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
    return {"logs": [{k: float(v) for k, v in x.items()} for x in logs],
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.named_buffers()
                      if "running" in k},
            "ms": ms, "step": step}


def step_profile(step, batches, n: int = 3):
    """Device busy ms, kernels, and the NCCL kernels' ms and count, a call
    of ``step`` over ``n`` profiled calls (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
    rows = device_rows(prof, n)
    return {"busy_ms": sum(r[0] for r in rows),
            "kernels": sum(r[1] for r in rows),
            "nccl_ms": sum(r[0] for r in rows if "nccl" in r[2].lower()),
            "nccl_kernels": sum(r[1] for r in rows
                                if "nccl" in r[2].lower())}


def collective_cost(device, calls: int = 200) -> dict:
    """Where a collective's host time goes, in the process group: the
    host time of one all-reduce of three floats (us, p50 of ``calls``
    calls issued back to back) beside a one-element add's, the five host
    operations with the most self time a call under torch.profiler, and
    the flight recorder's buffer sizes (initialize_distributed sets 0
    under NCCL unless they are set)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(3, device=device)

    def p50_us(fn) -> float:
        for _ in range(10):
            fn()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return float(np.median(times))

    out = {"all_reduce_host_us": p50_us(lambda: dist.all_reduce(x)),
           "add_host_us": p50_us(lambda: x.add_(0.0))}
    n = 20
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            dist.all_reduce(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:5]
    out["top_host_us"] = {e.key: e.self_cpu_time_total / n for e in top}
    out["env"] = {k: os.environ.get(k) for k in (
        "TORCH_NCCL_TRACE_BUFFER_SIZE", "TORCH_FR_BUFFER_SIZE")}
    return out


def same_bits(a: dict, b: dict) -> bool:
    """Whether two dp_train runs gave the same logs, parameters and BN
    running statistics, bit for bit."""
    import torch

    return a["logs"] == b["logs"] and all(
        torch.equal(a[key][k], b[key][k])
        for key in ("params", "stats") for k in a[key])


def dp_group_of_one(device, args, card: str):
    """Phase 23a: the flagship's train steps at the training batch, without
    a group and through the data-parallel path in a process group of one
    (NCCL on the card, Gloo in a rehearsal), twice each in turns (A B A B),
    deterministic cuDNN: equal logs, parameters and BN statistics, bit for
    bit; the group's first run counted."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.parallel import initialize_distributed, make_mesh
    from cadepth_tpu_torch.training import train_state as ts

    cuda = device.type == "cuda"
    f, h, w, bsz = args.init_features, args.height, args.width, \
        args.train_batch
    cfg = flagship_config(f, h, w, bsz)
    gen = torch.Generator().manual_seed(args.seed + 23)
    model, _ = ts.build_model_and_loss(cfg, device=device, generator=gen)
    rotate_pcl_heads(model, gen)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_pcl, n_norms = len(pcl_layers(model)), training_norms(model)
    del model
    rng = np.random.default_rng(args.seed + 24)
    steps = DP_STEPS if cuda else args.train_steps
    batches = [synthetic_batch(rng, bsz, h, w, device) for _ in range(steps)]
    backend = "nccl" if cuda else "gloo"
    assert initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                  backend=backend)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        dp = make_mesh()
        plain = dp_train(cfg, init, batches, device)
        # the main path, counted
        reset_warp_counts()
        group = dp_train(cfg, init, batches, device, dp)
        if cuda:
            torch.cuda.synchronize()
        counts = warp_counts()
        plain2 = dp_train(cfg, init, batches, device)
        group2 = dp_train(cfg, init, batches, device, dp)
        prof = ({k: step_profile(r["step"], batches)
                 for k, r in (("plain", plain2), ("group", group2))}
                if cuda else {})
        cost = collective_cost(device)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            saved
        dist.destroy_process_group()
    want = {"launches": tpw.LAUNCHES_PER_CALL * n_pcl * steps if cuda else 0,
            "bwd_launches": tpw.BWD_LAUNCHES_PER_CALL * n_pcl * steps
            if cuda else 0,
            "v_stores": n_pcl * steps if cuda else 0, "fused": 0,
            **norm_counts(n_norms, steps, cuda)}
    log(f"  {backend} group of 1: flagship f={f}, {h}x{w}, batch {bsz}, "
        f"bf16, {steps} steps through the data-parallel path: two_pass_warp "
        f"launches {counts['launches']} (expected {want['launches']}), "
        f"two_pass_warp_bwd launches {counts['bwd_launches']} (expected "
        f"{want['bwd_launches']}), V stores {counts['v_stores']}, fused "
        f"{counts['fused']}, batch norm kernel calls {counts['bn']} + "
        f"{counts['bn_bwd']} (expected {want['bn']} each way)")
    if counts != want:
        raise AssertionError(f"data-parallel launch counts {counts} != "
                             f"{want}")
    equal = {"group_vs_plain": same_bits(group, plain),
             "plain_vs_plain": same_bits(plain2, plain),
             "group_vs_group": same_bits(group2, group)}
    for i, x in enumerate(group["logs"]):
        if not all(np.isfinite(v) for v in x.values()):
            raise AssertionError(f"step {i}: non-finite logs {x}")
    p50 = {"plain_p50_ms": float(np.median(plain2["ms"])),
           "group_p50_ms": float(np.median(group2["ms"])),
           "p50_ms_in_turns": [float(np.median(r["ms"]))
                               for r in (plain, group, plain2, group2)]}
    log(f"  [{card}] logs, parameters after step {steps} and BN running "
        f"statistics bit-equal: with the group against without "
        f"{equal['group_vs_plain']}, without twice "
        f"{equal['plain_vs_plain']}, with twice {equal['group_vs_group']}; "
        f"step p50 {p50['plain_p50_ms']:.2f} ms without the group, "
        f"{p50['group_p50_ms']:.2f} ms with it (the second run of each; "
        f"A B A B: {', '.join(f'{x:.2f}' for x in p50['p50_ms_in_turns'])} "
        f"ms); "
        f"a step's device busy ms, kernels, NCCL ms and NCCL kernels "
        f"(3 profiled steps): {prof or 'not measured (no card)'}; one "
        f"all-reduce of 3 floats in the group: {cost}")
    if not all(equal.values()):
        raise AssertionError(f"a group of one changed the steps: {equal}")
    return {"steps": steps, "batch": bsz, "backend": backend,
            "warp_counts": counts, "bit_equal": equal, **p50,
            "profile": prof, "collective": cost,
            "last_logs": group["logs"][-1]}


def dp_worker(rank: int, port: int, work: pathlib.Path,
              rehearsal: bool) -> int:
    """A rank of phase 23b: joins the group that ``work``'s setup names,
    trains its rows of the global batches written there and writes its
    logs and parameters there."""
    import torch
    import torch.distributed as dist

    from cadepth_tpu_torch.ops import batch_norm as bn
    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh, shard_batch)

    setup = torch.load(work / "setup.pt", weights_only=False)
    if rehearsal:   # the ranks share the host's cores
        torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # under NCCL the process takes card ``rank`` (initialize_distributed)
    assert initialize_distributed(f"127.0.0.1:{port}", setup["ranks"], rank,
                                  backend=setup["backend"])
    device = torch.device("cpu") if rehearsal else \
        torch.device("cuda", torch.cuda.current_device())
    dp = make_mesh()
    f, h, w, bsz = setup["size"]
    cfg = flagship_config(f, h, w, bsz)
    cfg.training.use_amp = False
    batches = [shard_batch({k: v.to(device) for k, v in b.items()}, dp)
               for b in setup["batches"]]
    out = dp_train(cfg, setup["init"], batches, device, dp)
    del out["step"]
    out["launches"] = (tpw.launches, tpw.bwd_launches)
    out["norm_launches"] = (bn.launches, bn.bwd_launches)
    out["params"] = {k: v.cpu() for k, v in out["params"].items()}
    out["stats"] = {k: v.cpu() for k, v in out["stats"].items()}
    torch.save(out, work / f"out_{rank}.pt")
    dist.destroy_process_group()
    return 0


def dp_ranks(device, args, card: str, root: pathlib.Path):
    """Phase 23b: two processes on the one card (Gloo carries CUDA
    tensors, since NCCL refuses two ranks on one device), the f32 flagship
    at full width, global batch 2 x the training batch split evenly,
    against one process over the global batch: total_loss at every step
    to rtol 1e-5, and the gradient's norm at the steps that start from
    equal parameters (the first update's learning rate is 0) to
    tests/test_torch_train_step.py's rtol 5e-3 (cuDNN runs other
    algorithms at another batch, and this norm moves 1.5e-4 under 1e-6
    parameter noise in JAX itself). The parameters: their median
    difference within 0.02 sum(lr), tests/test_torch_parallel.py's bound,
    and at most one in a million of them further apart than sum(lr), the
    largest difference that test allows. Among 129 million parameters a
    few gradient entries are round-off in sign, and Adam moves each by
    about +-lr a step whatever the gradient's size, so a few entries part
    by up to twice sum(lr); a wrong gradient flips the signs of many."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    cuda = device.type == "cuda"
    ranks, backend = DP_RANKS, "gloo"
    f, h, w, bsz = args.init_features, args.height, args.width, \
        ranks * args.train_batch
    size = (f, h, w, bsz)
    cfg = flagship_config(*size)
    cfg.training.use_amp = False
    gen = torch.Generator().manual_seed(args.seed + 25)
    model, _ = ts.build_model_and_loss(cfg, device="cpu", generator=gen)
    rotate_pcl_heads(model, gen)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    want_bn = tuple(norm_counts(model, DP_RANK_STEPS, cuda).values())
    del model
    rng = np.random.default_rng(args.seed + 26)
    batches = [synthetic_batch(rng, bsz, h, w, "cpu")
               for _ in range(DP_RANK_STEPS)]
    work = root / f"ranks_{ranks}"
    work.mkdir()
    torch.save({"size": size, "init": init, "batches": batches,
                "ranks": ranks, "backend": backend}, work / "setup.pt")
    if cuda:
        torch.cuda.empty_cache()
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker",
         str(r), str(port), str(work)]
        + (["--cpu-rehearsal"] if not cuda else []),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(ranks)]
    outputs = {}
    try:
        for r, p in enumerate(procs):
            outputs[r] = p.communicate(timeout=DP_WORKER_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of the {backend} group exited "
                                 f"{p.returncode}:\n{outputs[r][-3000:]}")
    outs = [torch.load(work / f"out_{r}.pt", weights_only=False)
            for r in range(ranks)]
    one = dp_train(cfg, init, [{k: v.to(device) for k, v in b.items()}
                               for b in batches], device)
    lrs = [build_lr_schedule(cfg.optimization, STEPS_PER_EPOCH,
                             cfg.training.num_epochs)(s)
           for s in range(DP_RANK_STEPS)]
    bound = sum(lrs)

    def rel(key, steps):
        return max(abs(outs[0]["logs"][i][key] - one["logs"][i][key])
                   / abs(one["logs"][i][key]) for i in steps)

    loss_rel = rel("total_loss", range(DP_RANK_STEPS))
    norm_rel = rel("grad_norm", [i for i in range(DP_RANK_STEPS)
                                 if not any(lrs[:i])])
    diffs = torch.cat([(outs[0]["params"][k] - v.cpu()).abs().flatten()
                       for k, v in one["params"].items()])
    p_max, p_median = float(diffs.max()), float(diffs.median())
    over = int((diffs > bound).sum())
    over_cap = diffs.numel() // 1_000_000
    same = all(torch.equal(outs[0]["params"][k], o["params"][k])
               for o in outs[1:] for k in outs[0]["params"])
    log(f"  [{card}] {ranks} {backend} ranks on one device, f32 flagship "
        f"f={f}, {h}x{w}, global batch {bsz} split {ranks} x "
        f"{bsz // ranks}, {DP_RANK_STEPS} steps ({wall:.1f} s with the "
        f"processes' start), against one process over the global batch: "
        f"total_loss max rel diff {loss_rel:.3g} (rtol 1e-5), grad_norm at "
        f"equal parameters {norm_rel:.3g} (rtol 5e-3); parameters: {over} of "
        f"{diffs.numel()} further apart than sum(lr) {bound:.3g} (at most "
        f"{over_cap}), max |diff| {p_max:.3g}, median {p_median:.3g} "
        f"(bound {0.02 * bound:.3g}); the ranks' parameters "
        f"equal: {same}; two_pass_warp launches (fwd, bwd) by rank "
        f"{[x['launches'] for x in outs]}; batch norm kernel calls (fwd, "
        f"bwd) by rank {[x['norm_launches'] for x in outs]} (expected "
        f"{want_bn} each)")
    if not (loss_rel <= 1e-5 and norm_rel <= 5e-3
            and over <= over_cap and p_median <= 0.02 * bound and same):
        raise AssertionError(f"{ranks} ranks differ from one process")
    if any(tuple(x["norm_launches"]) != want_bn for x in outs):
        raise AssertionError(f"batch norm calls by rank "
                             f"{[x['norm_launches'] for x in outs]} != "
                             f"{want_bn}")
    return {"ranks": ranks, "backend": backend, "global_batch": bsz,
            "steps": DP_RANK_STEPS, "total_loss_max_rel": loss_rel,
            "grad_norm_max_rel": norm_rel, "params_max_abs": p_max,
            "params_median_abs": p_median, "sum_lr": bound,
            "params_above_sum_lr": over, "params_above_cap": over_cap,
            "rank_launches": [x["launches"] for x in outs],
            "rank_norm_launches": [list(x["norm_launches"]) for x in outs],
            "wall_s": wall}


def dp_memory(device, args, card: str):
    """Phase 23c: compiled_memory_analysis of the flagship's forward at
    the serving batch beside estimate_memory_mb."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.geometry.rays import ray_grid_batch
    from cadepth_tpu_torch.models import factory
    from cadepth_tpu_torch.training import train_state as ts

    f, h, w, bsz = args.init_features, args.height, args.width, args.batch
    cfg = flagship_config(f, h, w, bsz)
    model, _ = ts.build_model_and_loss(
        cfg, device=device, generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(args.seed + 27), bsz, h,
                            w, device)
    batch["rays"] = ray_grid_batch(batch["intrinsics"], h, w)
    measured = factory.compiled_memory_analysis(model, batch,
                                                "geometry_aware")
    estimate = factory.estimate_memory_mb(model, bsz, h, w, f)
    log(f"  [{card}] flagship f={f}, {h}x{w}, batch {bsz}, bf16 forward: "
        f"compiled_memory_analysis {measured or 'not measured (no card)'}; "
        f"estimate_memory_mb {estimate:.1f} MB (activations of the "
        f"training step and Adam's state)")
    if device.type == "cuda" and not (
            measured and measured["temp_mb"] > 0
            and measured["total_mb"] > measured["argument_mb"]):
        raise AssertionError(f"compiled_memory_analysis {measured}")
    return {"compiled_memory_analysis": measured,
            "estimate_memory_mb": estimate, "batch": bsz}


def dp_data_tools(device, args, card: str, loop_root: pathlib.Path,
                  family_root: pathlib.Path, root: pathlib.Path):
    """Phase 23d: the data-tool CLIs on phase 19's synthetic tree
    (validate; rays on the device; pack, which must give phase 19's pack
    byte for byte), then compare_models over phase 21's and phase 19's
    evaluate outputs."""
    import json as json_mod

    import numpy as np

    from cadepth_tpu_torch.cli import compare_models, pack_dataset
    from cadepth_tpu_torch.cli import preprocess_rays, validate_sunrgbd
    from cadepth_tpu_torch.geometry.io import load_ray_directions

    data = loop_root / "data" / "sunrgbd"
    manifest = loop_root / "data" / "sunrgbd_manifest.json"
    out = {}
    t0 = time.perf_counter()
    rc = validate_sunrgbd.main([str(data), str(root / "manifest.json")])
    found = json_mod.loads((root / "manifest.json").read_text())
    out["validate"] = {"exit": rc, "valid_images": found["valid_images"]}
    rc = preprocess_rays.main(["--data_dir", str(data),
                               "--native-resolution", "--device",
                               device.type])
    files = sorted(data.rglob("rays.bin"))
    rays = load_ray_directions(files[0])
    norm_err = float(np.abs(np.linalg.norm(rays, axis=-1) - 1.0).max())
    out["preprocess_rays"] = {"exit": rc, "files": len(files),
                              "shape": list(rays.shape),
                              "unit_norm_max_err": norm_err}
    rc = pack_dataset.main(["--data-dir", str(data), "--manifest",
                            str(manifest), "--out", str(root / "pack"),
                            "--height", str(args.height), "--width",
                            str(args.width)])
    names = sorted(p.name for p in (root / "pack").iterdir())
    same = [n for n in names if (root / "pack" / n).read_bytes()
            == (loop_root / "pack" / n).read_bytes()]
    out["pack_dataset"] = {"exit": rc, "files": names,
                           "equal_to_phase_19": same}
    # the evaluate outputs under their runs' names (both are "eval")
    runs = [root / "runs" / "phase21_baseline_unet",
            root / "runs" / "phase19_geometry_aware_full"]
    for src, dst in zip((family_root / "eval", loop_root / "eval"), runs):
        shutil.copytree(src, dst)
    rc = compare_models.main([str(r) for r in runs]
                             + ["--output", str(root / "compare")])
    report = (root / "compare" / "comparison_report.md").read_text()
    out["compare_models"] = {"exit": rc, "report_lines":
                             len(report.splitlines()),
                             "paired_tests": "Paired t-test" in report}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  the data-tool CLIs on phase 19's tree ({out['wall_s']:.1f} s): "
        + json_mod.dumps(out))
    n = len(files)
    if not (out["validate"]["exit"] == 0 and found["valid_images"] == n
            and out["preprocess_rays"]["exit"] == 0 and n > 0
            and norm_err < 1e-5 and out["pack_dataset"]["exit"] == 0
            and same == names and out["compare_models"]["exit"] == 0
            and out["compare_models"]["paired_tests"]):
        raise AssertionError(f"the data-tool CLIs: {out}")
    return out


def data_parallel(device, args, card: str, roots):
    """Phase 23: data parallel on the card, memory analysis and the data
    tools."""
    out = {"group_of_one": dp_group_of_one(device, args, card),
           "two_ranks": dp_ranks(device, args, card, roots[23]),
           "memory": dp_memory(device, args, card)}
    out["data_tools"] = dp_data_tools(device, args, card, roots[19],
                                      roots[21], roots[23])
    return out


# phase 25: spatial parallelism on the card
SP_RANKS = 2          # one data row of two bands
SP_STEPS = 3
SP_BANDS = (2, 4)     # 25a: the windows a decoder map is cut into
SP_WORKER_TIMEOUT_S = 600
# 25c: the Trainer's epoch from phase 19's pack, capped
SP_TRAIN_SAMPLES, SP_VAL_SAMPLES = 8, 8


def windowed_pcls(height: int, spatial: int, levels: int = 5) -> int:
    """How many of a ``levels``-level network's PCLs warp a window of rows
    on ``spatial`` bands of a ``height``-row image: those of the decoder
    levels that the band rule of models/layers.py keeps banded, below
    a banded level (the first banded level from the bottom runs whole on
    the gathered skip)."""
    banded, band, ok = [], height // spatial, height % spatial == 0
    for _ in range(levels + 1):        # the levels, then the bottleneck
        banded.append(ok)
        ok = ok and band % 2 == 0
        band //= 2
    return sum(banded[i] and banded[i + 1] for i in range(levels))


def window_counts() -> dict:
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    return {"window_launches": tpw.window_launches,
            "window_bwd_launches": tpw.window_bwd_launches}


def reset_window_counts() -> None:
    from cadepth_tpu_torch.ops import two_pass_warp as tpw

    tpw.window_launches = tpw.window_bwd_launches = 0


def windows_of(rows: int, bands: int):
    """A partition of ``rows`` into ``bands`` windows (row0, rows), the
    last taking the rest."""
    size = rows // bands
    return [(k * size, size if k < bands - 1 else rows - k * size)
            for k in range(bands)]


def check_windowed(device, shapes, seed: int):
    """Phase 25a: the two-pass kernels over windows of output rows. At
    each decoder map, dtype, padding and theta of phase 3, cut into 2 and
    4 windows: each window's forward and V equal those rows of the whole
    forward's (max error 0); the windows' backward kernels summed equal
    the whole backward's d_img and d_theta (phase 6's tolerances); the
    rotation's windows run twice give the same bits; at each map and
    dtype the rotation's windowed forward and backward against their
    windowed plain versions (phases 3 and 6's tolerances). Returns the
    worst errors."""
    import torch

    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_bwd,
        two_pass_affine_warp_plain_fwd,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {"fwd": 0.0, "float32": 0.0, "bfloat16": 0.0, "d_theta": 0.0,
             "fwd_vs_plain": 0.0, "bwd_vs_plain": 0.0}
    for level, shape in shapes:
        b, h = shape[0], shape[1]
        img32 = torch.randn(shape, device=device, generator=gen)
        grad32 = torch.randn(shape, device=device, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            img, grad = img32.to(dtype), grad32.to(dtype)
            errs = []
            for pad in ("zeros", "border"):
                for tname, theta in two_pass_thetas(device, b, gen):
                    whole, v = warp._forward(img, theta, pad, False,
                                             keep_v=True)
                    d_img, d_theta = warp.two_pass_warp_bwd(img, v, theta,
                                                            grad, pad)
                    scale = max(1.0, d_img.float().abs().max().item())
                    t_scale = d_theta.abs().max().clamp_min(1e-12)
                    for bands in SP_BANDS:
                        sum_img = torch.zeros_like(d_img, dtype=torch.float32)
                        sum_theta = torch.zeros_like(d_theta)
                        fwd_err = 0.0
                        for row0, rows in windows_of(h, bands):
                            out, wv = warp._forward(img, theta, pad, False,
                                                    keep_v=True, row0=row0,
                                                    rows=rows)
                            fwd_err = max(fwd_err, *(
                                (a.float() - w.float()).abs().max().item()
                                for a, w in (
                                    (out, whole[:, row0:row0 + rows]),
                                    (wv, v[:, row0:row0 + rows]))))
                            g = grad[:, row0:row0 + rows].contiguous()
                            a, t = warp.two_pass_warp_bwd(
                                img, wv, theta, g, pad, False, row0, rows)
                            if tname == "rotation":
                                again = warp.two_pass_warp_bwd(
                                    img, wv, theta, g, pad, False, row0,
                                    rows)
                                if not (torch.equal(again[0], a)
                                        and torch.equal(again[1], t)):
                                    raise AssertionError(
                                        f"windowed backward {level} {name} "
                                        f"{pad} ({row0}, {rows}): two runs "
                                        "differ")
                            if tname == "rotation" and pad == "zeros" \
                                    and bands == SP_BANDS[0]:
                                want, want_v = two_pass_affine_warp_plain_fwd(
                                    img, theta, pad, False, row0, rows)
                                pw = two_pass_affine_warp_plain_bwd(
                                    img, want_v, theta, g, pad, False, row0,
                                    rows)
                                p_err = max((out.float() - want.float())
                                            .abs().max().item(),
                                            (wv.float() - want_v.float())
                                            .abs().max().item())
                                p_scale = max(1.0, pw[0].float().abs().max()
                                              .item())
                                pb_err = (a.float() - pw[0].float()).abs() \
                                    .max().item()
                                if not (p_err <= ATOL[name] and pb_err
                                        <= BWD_ATOL[name] * p_scale):
                                    raise AssertionError(
                                        f"windowed kernel vs windowed plain "
                                        f"{level} {name} ({row0}, {rows}): "
                                        f"forward {p_err}, d_img {pb_err}")
                                worst["fwd_vs_plain"] = max(
                                    worst["fwd_vs_plain"], p_err)
                                worst["bwd_vs_plain"] = max(
                                    worst["bwd_vs_plain"], pb_err / p_scale)
                            sum_img += a.float()
                            sum_theta += t
                        err = (sum_img - d_img.float()).abs().max().item()
                        t_err = ((sum_theta - d_theta).abs().max()
                                 / t_scale).item()
                        if not (fwd_err == 0.0
                                and err <= BWD_ATOL[name] * scale
                                and t_err <= THETA_ATOL[name]):
                            raise AssertionError(
                                f"windows of {level} {tuple(shape)} {name} "
                                f"{pad} {tname} in {bands}: forward max err "
                                f"{fwd_err} (want 0), summed d_img err {err} "
                                f"(atol {BWD_ATOL[name]} x {scale:.3g}), "
                                f"d_theta {t_err} (atol {THETA_ATOL[name]})")
                        worst["fwd"] = max(worst["fwd"], fwd_err)
                        worst[name] = max(worst[name], err / scale)
                        worst["d_theta"] = max(worst["d_theta"], t_err)
                        errs.append(f"{tname}/{bands}={err / scale:.2g}")
            log(f"  {level} {tuple(shape)} {name:8s} windows of 2 and 4, "
                f"both paddings: forward and V max err 0; summed d_img "
                f"err / max(1, max|d_img|): " + " ".join(errs[:9]) + " ...")
    log(f"  windowed forward against the whole forward's rows: max err "
        f"{worst['fwd']}; windows' backward summed against the whole "
        f"backward: d_img {max(worst['float32'], worst['bfloat16']):.3g} "
        f"of max(1, max|d_img|), d_theta {worst['d_theta']:.3g} of its "
        f"largest entry; windowed kernel against windowed plain: forward "
        f"{worst['fwd_vs_plain']:.3g}, d_img {worst['bwd_vs_plain']:.3g}; "
        f"the rotation's windows run twice: the same bits")
    return worst


def touched_rows(theta, height: int, width: int, row0: int,
                 rows: int) -> int:
    """Input rows a batch's window of the forward reads (its taps, zeros
    padding), summed over the batch: what this run's data needs."""
    import torch

    from cadepth_tpu_torch.ops.affine_warp import _positions

    g, _ = _positions(theta, height, width, False, theta.device, row0, rows)
    base = torch.floor(g)
    total = 0
    for b in range(g.shape[0]):
        taps = torch.cat([base[b].flatten(), base[b].flatten() + 1.0])
        taps = taps[(taps >= 0) & (taps <= height - 1)]
        total += int(torch.unique(taps).numel())
    return total


def window_times(device, args, card: str):
    """Phase 25a's times: at dec1, bf16, the training batch, rank 0's
    window of two bands, the rotation: the windowed training forward
    (storing V) and backward kernels' device time, their bounds from this
    run's theta (the input rows the window reads), the windowed plain
    versions and F.grid_sample on the window's rows of the grid (forward,
    and its backward)."""
    import torch
    import torch.nn.functional as F

    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_bwd,
        two_pass_affine_warp_plain_fwd,
    )

    cuda = device.type == "cuda"
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 27)
    level, shape = decoder_shapes(args.train_batch, args.height, args.width,
                                  args.init_features)[-1]
    b, h, w, c = shape
    row0, rows = windows_of(h, SP_RANKS)[0]
    img = torch.randn(shape, device=device, generator=gen).to(torch.bfloat16)
    grad = torch.randn((b, rows, w, c), device=device, generator=gen) \
        .to(torch.bfloat16)
    theta = (torch.tensor(THETAS["rotation"], device=device)
             .expand(b, 2, 3).contiguous())
    _, v = warp._forward(img, theta, "zeros", False, keep_v=True, row0=row0,
                         rows=rows)
    size = img.element_size()
    window = b * rows * w * c
    read = touched_rows(theta, h, w, row0, rows) * w * c * size
    nchw = img.permute(0, 3, 1, 2).detach().requires_grad_(True)
    th = theta.to(torch.bfloat16).requires_grad_(True)
    with torch.enable_grad():
        grid = F.affine_grid(th, list(nchw.shape),
                             align_corners=False)[:, row0:row0 + rows]
        gs = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                           align_corners=False)
    rows_out = {}
    for kind, calls, keys, n_launch, bytes_moved, flops in (
            ("forward", {
                "kernel": lambda: warp._forward(img, theta, "zeros", False,
                                                keep_v=True, row0=row0,
                                                rows=rows),
                "plain": lambda: two_pass_affine_warp_plain_fwd(
                    img, theta, "zeros", False, row0, rows),
                "library": lambda: F.grid_sample(
                    nchw.detach(), grid.detach(), mode="bilinear",
                    padding_mode="zeros", align_corners=False)},
             TWO_PASS_FWD_KEYS, warp.LAUNCHES_PER_CALL,
             # the rows read once, out and V written once
             read + 2 * window * size, 6 * window),
            ("backward", {
                "kernel": lambda: warp.two_pass_warp_bwd(
                    img, v, theta, grad, "zeros", False, row0, rows),
                "plain": lambda: two_pass_affine_warp_plain_bwd(
                    img, v, theta, grad, "zeros", False, row0, rows),
                "library": lambda: torch.autograd.grad(
                    gs, (nchw, th), grad.permute(0, 3, 1, 2),
                    retain_graph=True)},
             TWO_PASS_BWD_KEYS, warp.BWD_LAUNCHES_PER_CALL,
             # grad and V of the window and the rows of img read once, the
             # whole d_img written once
             read + 2 * window * size + img.numel() * size, 20 * window)):
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        row = {"shape": shape, "window": [row0, rows],
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": bytes_moved}
        for call, fn in calls.items():
            n = args.timing_iters if call != "plain" else \
                max(args.timing_iters // 10, 2)
            row[f"{call}_wall_ms"] = timer(fn, n, 2)
            row[f"{call}_ms"] = None
            if cuda:
                expect = dict(kernels=keys, launches=n_launch) \
                    if call == "kernel" else {}
                total, per_kernel = device_ms(fn, n, **expect)
                row[f"{call}_ms"] = total if call != "kernel" else sum(
                    ms for key, ms in per_kernel.items()
                    if any(k in key for k in keys))
        rows_out[kind] = row
        dev = row["kernel_ms"]
        log(f"  [{card}] {level} {shape} bf16, output rows {row0}.."
            f"{row0 + rows - 1} (two bands), windowed two_pass_warp {kind}: "
            + (f"{dev:.4f} ms device, {row['bound_ms'] / dev:.1%} of bound"
               if dev else "device not measured")
            + f" / {row['kernel_wall_ms']:.4f} ms wall; bound "
            f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}, "
            f"{bytes_moved / 1e6:.2f} MB); plain "
            + (f"{row['plain_ms']:.4f} ms device" if row["plain_ms"]
               else "device not measured")
            + f" / {row['plain_wall_ms']:.4f} ms wall; grid_sample on the "
            f"window's rows{' backward' if kind == 'backward' else ''} "
            + (f"{row['library_ms']:.4f} ms device" if row["library_ms"]
               else "device not measured")
            + f" / {row['library_wall_ms']:.4f} ms wall"
            + ("" if cuda else " [CPU rehearsal ms, not device numbers]"))
    return rows_out


def grads_at(cfg, init, batch, device, dp=None):
    """The gradient of the training loss of ``batch`` (``dp``'s global
    batch when one is given) at the state dict ``init``, on the CPU."""
    from cadepth_tpu_torch.training import train_state as ts

    model, loss_fn = ts.build_model_and_loss(cfg, device=device, dp=dp)
    model.load_state_dict(init)
    grads = ts.make_grad_fn(cfg, model, loss_fn)(batch)
    return {k: v.cpu() for k, v in grads.items()}


def held_bytes(cfg, init, batch, device, dp=None):
    """Device bytes a training forward and its loss hold for the backward
    (the activations autograd keeps, and the loss's inputs), at the state
    dict ``init``: allocated after them minus before; None off the
    card."""
    import torch

    from cadepth_tpu_torch.training import train_state as ts

    if device.type != "cuda":
        return None
    model, loss_fn = ts.build_model_and_loss(cfg, device=device, dp=dp)
    model.load_state_dict(init)
    model.train()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pred = model(*ts._inputs(cfg, batch, model.space))
    gt = batch["depth"]
    total, _ = loss_fn(pred, gt, batch["rgb"], batch["intrinsics"],
                       gt > cfg.loss.min_depth)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del pred, total
    return held


def tree_rel(got: dict, want: dict, skip=()) -> float:
    """Relative L2 distance of two gradient trees."""
    num = sum(float(((got[k] - w).double() ** 2).sum())
              for k, w in want.items() if not k.endswith(skip))
    den = sum(float((w.double() ** 2).sum())
              for k, w in want.items() if not k.endswith(skip))
    return (num / den) ** 0.5


def leaf_dist(got, want) -> float:
    """Relative L2 distance of two tensors (0 where both are zero)."""
    num = float(((got - want).double() ** 2).sum()) ** 0.5
    return num / max(float((want.double() ** 2).sum()) ** 0.5, 1e-30)


def sp_worker(rank: int, port: int, work: pathlib.Path,
              rehearsal: bool) -> int:
    """A rank of phases 25b and 25c: joins the group that ``work``'s setup
    names as one data row of two bands, trains its bands of the global
    batches written there (f32, counted, its peak device memory), then
    the Trainer's spatial branch for one capped epoch from phase 19's
    pack; writes what it saw there."""
    import torch
    import torch.distributed as dist

    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh_2d, shard_batch)
    from cadepth_tpu_torch.training.trainer import Trainer

    setup = torch.load(work / "setup.pt", weights_only=False)
    if rehearsal:   # the ranks share the host's cores
        torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert initialize_distributed(f"127.0.0.1:{port}", setup["ranks"], rank,
                                  backend="gloo")
    cuda = not rehearsal
    device = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    dp = make_mesh_2d(setup["ranks"], setup["ranks"])
    f, h, w, bsz = setup["size"]
    cfg = flagship_config(f, h, w, bsz)
    cfg.training.use_amp = False
    batches = [shard_batch({k: v.to(device) for k, v in b.items()}, dp)
               for b in setup["batches"]]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    reset_warp_counts()
    reset_window_counts()
    out = dp_train(cfg, setup["init"], batches, device, dp)
    if cuda:
        torch.cuda.synchronize()
    # the steps' peak, over the window one process's peak covers
    out["peak_bytes"] = (torch.cuda.max_memory_allocated() - base) if cuda \
        else None
    out["counts"] = dict(warp_counts(), **window_counts())
    out["held_bytes"] = held_bytes(cfg, setup["init"], batches[0], device,
                                   dp)
    # every rank takes part in the collectives; rank 0 keeps the result
    grads = grads_at(cfg, setup["init"], batches[0], device, dp)
    if rank == 0:
        out["grads"] = grads
    del grads
    del out["step"]
    out["params"] = {k: v.cpu() for k, v in out["params"].items()}
    out["stats"] = {k: v.cpu() for k, v in out["stats"].items()}
    out["band"] = list(batches[0]["rgb"].shape)

    # 25c: the Trainer's spatial branch, as the train CLI runs it
    tcfg = load_config(setup["yaml"], experiment="geometry_aware_full")
    tcfg.training.num_epochs = 1
    tcfg.hardware.data_parallel = True
    tcfg.hardware.spatial_parallel = setup["ranks"]
    tcfg._debug_limits = {"num_train_samples": SP_TRAIN_SAMPLES,
                          "num_val_samples": SP_VAL_SAMPLES}
    reset_warp_counts()
    reset_window_counts()
    tr = Trainer(tcfg, device=device)
    try:
        metrics = tr.train()
        out["trainer"] = {
            "metrics": metrics, "history": tr.history,
            "ranks": tr.dp.world_size, "bands": tr.dp.space.size,
            "counts": dict(warp_counts(), **window_counts()),
            "checkpoints": sorted(p.name for p in pathlib.Path(
                tcfg.checkpointing.checkpoint_dir,
                tcfg.experiment.name).iterdir())
            if rank == 0 else None}
    finally:
        tr.close()
    torch.save(out, work / f"out_{rank}.pt")
    dist.destroy_process_group()
    return 0


def sp_ranks(device, args, card: str, root: pathlib.Path,
             loop_root: pathlib.Path):
    """Phases 25b and 25c: two processes on the one card over Gloo with
    CUDA tensors (its all_gather_into_tensor and reduce_scatter_tensor,
    as NCCL's), one data row of two bands of 120 rows. 25b: the f32
    flagship at full width, global batch 4, 3 steps, against one process
    over the same batches: total_loss to rtol 1e-5, the parameters by
    phase 23b's rule (the median within 0.02 sum(lr), at most one in a
    million further than sum(lr); the FiLM MLPs' first two biases, whose
    gradient is round-off, left out), the gradient at the initial state
    over the tree within twice the distance of one process's over the
    batch with its samples reversed or rotated by one (the same sums in
    other orders), and the worst parameter's within twice the largest
    such distance of any parameter, or 1e-3, that bound below 0.5 (a
    parameter S times off lies 0.5 away), each rank's launches counted (5 forward launches storing V and 15 backward
    launches a step, of them the windowed ones of the banded levels), each
    rank's peak device memory of the steps beside one process's, and the
    step's p50 (two ranks sharing one card: not a speed figure). 25c: the Trainer on the two
    ranks, configs/train_config.yaml's geometry_aware_full (bf16) from
    phase 19's pack for one capped epoch: rank 0's checkpoint, finite
    validation metrics on both ranks, equal parameters."""
    import numpy as np
    import torch

    from cadepth_tpu_torch.ops import two_pass_warp as tpw
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    cuda = device.type == "cuda"
    ranks = SP_RANKS
    f, h, w, bsz = args.init_features, args.height, args.width, \
        args.train_batch
    size = (f, h, w, bsz)
    cfg = flagship_config(*size)
    cfg.training.use_amp = False
    gen = torch.Generator().manual_seed(args.seed + 28)
    model, _ = ts.build_model_and_loss(cfg, device="cpu", generator=gen)
    rotate_pcl_heads(model, gen)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_pcl, n_norms = len(pcl_layers(model)), training_norms(model)
    del model
    rng = np.random.default_rng(args.seed + 29)
    batches = [synthetic_batch(rng, bsz, h, w, "cpu")
               for _ in range(SP_STEPS)]
    work = root / f"bands_{ranks}"
    work.mkdir()
    yaml_path = loop_yaml(work, args, 1, loop_root / "pack")
    torch.save({"size": size, "init": init, "batches": batches,
                "ranks": ranks, "yaml": str(yaml_path)}, work / "setup.pt")
    if cuda:
        torch.cuda.empty_cache()
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--sp-worker",
         str(r), str(port), str(work)]
        + (["--cpu-rehearsal"] if not cuda else []),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(ranks)]
    outputs = {}
    try:
        for r, p in enumerate(procs):
            outputs[r] = p.communicate(timeout=SP_WORKER_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of the spatial group exited "
                                 f"{p.returncode}:\n{outputs[r][-3000:]}")
    outs = [torch.load(work / f"out_{r}.pt", weights_only=False)
            for r in range(ranks)]

    # one process over the same global batches
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    one = dp_train(cfg, init, [{k: v.to(device) for k, v in b.items()}
                               for b in batches], device)
    one_peak = (torch.cuda.max_memory_allocated() - base) if cuda else None
    del one["step"]
    # the noise floor: one process over the same batches with their
    # samples' halves swapped (the same sums in another order)
    half = bsz // 2
    swap = [{k: torch.cat([v[half:], v[:half]]).to(device)
             for k, v in b.items()} for b in batches]
    swapped = dp_train(cfg, init, swap, device)
    del swapped["step"]
    # the gradient at the initial state: the ranks', one process's, and
    # one process's over the first batch reordered
    first = {k: v.to(device) for k, v in batches[0].items()}
    one_held = held_bytes(cfg, init, first, device)
    g_one = grads_at(cfg, init, first, device)
    g_orders = [grads_at(cfg, init, {k: v[order] for k, v in first.items()},
                         device)
                for order in (list(range(bsz))[::-1],
                              list(range(1, bsz)) + [0])]
    lrs = [build_lr_schedule(cfg.optimization, STEPS_PER_EPOCH,
                             cfg.training.num_epochs)(s)
           for s in range(SP_STEPS)]
    bound = sum(lrs)
    loss_rel = max(abs(outs[0]["logs"][i]["total_loss"]
                       - one["logs"][i]["total_loss"])
                   / abs(one["logs"][i]["total_loss"])
                   for i in range(SP_STEPS))
    # the FiLM MLPs' first two biases feed a batch norm: their gradient is
    # zero but for round-off, which Adam turns into +-lr moves of either
    # sign (tests/torch_port_common.py: assert_grads_close), so they are
    # left out of the count
    noise = ("film.fc1.bias", "film.fc2.bias")
    g_rel = tree_rel(outs[0]["grads"], g_one, noise)
    g_floor = max(tree_rel(g, g_one, noise) for g in g_orders)
    # each parameter's gradient against the reorderings' distance
    leaf_rel, leaf_floor = {}, {}
    for k, g_k in g_one.items():
        if not k.endswith(noise):
            leaf_rel[k] = leaf_dist(outs[0]["grads"][k], g_k)
            leaf_floor[k] = max(leaf_dist(g[k], g_k) for g in g_orders)
    leaf_over = {k: (r, leaf_floor[k]) for k, r in leaf_rel.items()
                 if r > max(2.0 * leaf_floor[k], 1e-3)}
    worst = max(leaf_rel, key=leaf_rel.get)
    # the worst parameter against twice the largest reordered distance;
    # a parameter S times off lies at least 0.5 away, so the bound must
    # stay below that
    leaf_bound = max(2.0 * max(leaf_floor.values()), 1e-3)
    per = {k: (outs[0]["params"][k] - v.cpu()).abs().flatten()
           for k, v in one["params"].items() if not k.endswith(noise)}
    diffs = torch.cat(list(per.values()))
    p_max, p_median = float(diffs.max()), float(diffs.median())
    over = int((diffs > bound).sum())
    floor = torch.cat([(swapped["params"][k] - v).abs().flatten().cpu()
                       for k, v in one["params"].items()
                       if not k.endswith(noise)])
    over_floor = int((floor > bound).sum())
    over_cap = diffs.numel() // 1_000_000
    over_in = {k: int((d > bound).sum()) for k, d in per.items()
               if (d > bound).any()}
    same = all(torch.equal(outs[0]["params"][k], o["params"][k])
               for o in outs[1:] for k in outs[0]["params"])
    windowed = windowed_pcls(h, ranks)
    want = {"launches": tpw.LAUNCHES_PER_CALL * n_pcl * SP_STEPS,
            "bwd_launches": tpw.BWD_LAUNCHES_PER_CALL * n_pcl * SP_STEPS,
            "v_stores": n_pcl * SP_STEPS, "fused": 0,
            "window_launches": tpw.LAUNCHES_PER_CALL * windowed * SP_STEPS,
            "window_bwd_launches":
                tpw.BWD_LAUNCHES_PER_CALL * windowed * SP_STEPS,
            **norm_counts(n_norms, SP_STEPS, cuda)} if cuda \
        else {k: 0 for k in ("launches", "bwd_launches", "v_stores", "fused",
                             "window_launches", "window_bwd_launches", "bn",
                             "bn_bwd")}
    counts = [o["counts"] for o in outs]
    p50 = [float(np.median(o["ms"][1:] or o["ms"])) for o in outs]
    one_p50 = float(np.median(one["ms"][1:] or one["ms"]))
    peaks = [o["peak_bytes"] for o in outs]
    gib = (lambda x: f"{x / 2**30:.3f} GiB" if x is not None
           else "not measured")
    log(f"  [{card}] {ranks} Gloo ranks on one device as one data row of "
        f"{ranks} bands {outs[0]['band']} (rgb), f32 flagship f={f}, "
        f"{h}x{w}, global batch {bsz}, {SP_STEPS} steps ({wall:.1f} s with "
        f"the processes' start and phase 25c), against one process over "
        f"the global batch: total_loss max rel diff {loss_rel:.3g} (rtol "
        f"1e-5); parameters: {over} of {diffs.numel()} further apart than "
        f"sum(lr) {bound:.3g} (at most {over_cap}, one in a million"
        f"{'' if cuda else ', on the card only'}; one process over the "
        f"batches with their halves swapped: {over_floor}, max |diff| "
        f"{float(floor.max()):.3g}), max |diff| {p_max:.3g}, "
        f"median {p_median:.3g} (bound {0.02 * bound:.3g}), the FiLM MLPs' "
        f"first two biases left out; entries past sum(lr) by parameter: "
        f"{over_in}; the ranks' parameters equal: {same}; the gradient at "
        f"the initial state {g_rel:.3g} (relative L2 over the tree) from "
        f"one process's, where one process over the batch reordered is "
        f"up to {g_floor:.3g} from it; by parameter, the worst {worst} "
        f"{leaf_rel[worst]:.3g} (reordered up to {leaf_floor[worst]:.3g}), "
        f"the largest reordered distance "
        f"{max(leaf_floor.values()):.3g} (the worst at most twice that, "
        f"and that below 0.5); parameters past twice their own reordered "
        f"distance (or 1e-3), not held, as bands reorder the sums over "
        f"pixels where reordering samples does not: {leaf_over}")
    log(f"  [{card}] launches by rank over {SP_STEPS} steps: {counts} "
        f"(expected {want}: {n_pcl} PCLs a step, {windowed} of them on "
        f"windows, {n_norms} training norms a step on each rank's "
        f"bands)")
    held = [o["held_bytes"] for o in outs]
    log(f"  [{card}] device memory a training forward holds for its "
        f"backward (the first batch): "
        f"{', '.join(f'rank {r} {gib(x)}' for r, x in enumerate(held))}, "
        f"one process {gib(one_held)}; peak device memory of the "
        f"{SP_STEPS} steps (parameters, gradients, Adam's moments and "
        f"cuDNN's workspaces included): "
        f"{', '.join(f'rank {r} {gib(x)}' for r, x in enumerate(peaks))}, "
        f"one process {gib(one_peak)}; step p50 {p50} ms by rank, two "
        f"ranks sharing the card over Gloo (not a speed figure), one "
        f"process {one_p50:.1f} ms")
    # the count's cap is one in a million of the card's 129 million
    # parameters; the rehearsal's 2.8 million at f=8 leave it 2 entries,
    # fewer than the round-off entries a draw can flip there
    if not (loss_rel <= 1e-5 and p_median <= 0.02 * bound and same
            and g_rel <= 2.0 * g_floor
            and leaf_rel[worst] <= leaf_bound < 0.5
            and (over <= over_cap or not cuda)):
        raise AssertionError(f"{ranks} bands differ from one process")
    if any(c != want for c in counts):
        raise AssertionError(f"spatial launch counts {counts} != {want}")

    trainer = [o["trainer"] for o in outs]
    ckpts = trainer[0]["checkpoints"]
    finite = all(np.isfinite(t["metrics"][k]) for t in trainer
                 for k in ("total_loss", "abs_rel", "rmse"))
    log(f"  [{card}] the Trainer's spatial branch ({trainer[0]['ranks']} "
        f"ranks, {trainer[0]['bands']} bands), geometry_aware_full from "
        f"phase 19's pack, one epoch capped at {SP_TRAIN_SAMPLES} train and "
        f"{SP_VAL_SAMPLES} validation samples: rank 0's checkpoints {ckpts}; "
        f"validation abs_rel by rank "
        f"{[t['metrics']['abs_rel'] for t in trainer]}, finite {finite}; "
        f"launches by rank {[t['counts'] for t in trainer]}")
    if not (finite and ckpts and "best" in ckpts
            and trainer[0]["metrics"] == trainer[1]["metrics"]):
        raise AssertionError("the Trainer's spatial branch failed: "
                             f"{ckpts}, {[t['metrics'] for t in trainer]}")
    if cuda and any(t["counts"]["window_launches"] == 0 for t in trainer):
        raise AssertionError("the Trainer's spatial epoch launched no "
                             "windowed warp")
    # validation runs the norms in eval mode: the train steps' calls alone
    if cuda and any(t["counts"]["bn"] != t["counts"]["bn_bwd"]
                    or not t["counts"]["bn"]
                    or t["counts"]["bn"] % n_norms for t in trainer):
        raise AssertionError("the Trainer's spatial epoch ran the batch "
                             "norm's kernels other than "
                             f"{n_norms} each way a step: "
                             f"{[t['counts'] for t in trainer]}")
    return {"ranks": ranks, "bands": ranks, "global_batch": bsz,
            "steps": SP_STEPS, "total_loss_max_rel": loss_rel,
            "params_max_abs": p_max, "params_median_abs": p_median,
            "sum_lr": bound, "params_above_sum_lr": over,
            "params_above_cap": over_cap, "params_above_by_name": over_in,
            "swapped_params_above_sum_lr": over_floor,
            "grad_rel_l2": g_rel, "reordered_grad_rel_l2": g_floor,
            "grad_worst_param": worst,
            "grad_worst_param_rel_l2": leaf_rel[worst],
            "reordered_grad_worst_param_rel_l2": max(leaf_floor.values()),
            "grad_worst_param_bound": leaf_bound,
            "grad_params_over": leaf_over,
            "rank_counts": counts,
            "expected_counts": want, "windowed_pcls": windowed,
            "rank_peak_bytes": peaks, "one_process_peak_bytes": one_peak,
            "rank_held_bytes": held, "one_process_held_bytes": one_held,
            "rank_step_p50_ms": p50, "one_process_step_p50_ms": one_p50,
            "trainer": {"checkpoints": ckpts, "metrics": trainer[0]["metrics"],
                        "rank_counts": [t["counts"] for t in trainer]},
            "wall_s": wall}


def spatial_parallel(device, args, card: str, roots):
    """Phase 25: the windowed kernels, spatial train steps, the Trainer's
    spatial branch."""
    import torch

    with torch.no_grad():
        worst = check_windowed(
            device, decoder_shapes(args.train_batch, args.height, args.width,
                                   args.init_features), args.seed + 26)
    times = window_times(device, args, card)
    return {"windowed": worst, "window_times": times,
            "ranks": sp_ranks(device, args, card, roots[25], roots[19])}


# ---------------------------------------------------------------------------
# phase 26: the production configuration on the card

PRODUCTION_CONFIG = ROOT / "configs" / "train_config_production.yaml"
# 26a's set: 6 scenes a sensor at 640x480, 24 in all; the file reads the
# pool for both splits (no split_filtering), so one epoch is 3 steps of 8
PROD_SCENES, PROD_TIMED_STEPS = 6, 8


def production_sets(root: pathlib.Path, args, manifest: str):
    """The train CLI's --set overrides of configs/train_config_production
    .yaml for 26a: the batch a card (global 32 over four cards), the data
    and output paths, and one epoch (the smoke run's cut of depth); in a
    CPU rehearsal also the width and the resolution."""
    sets = [f"training.batch_size={args.prod_batch}",
            f"data.data_dir={root / 'data' / 'sunrgbd'}",
            f"data.manifest_path={manifest}",
            f"checkpointing.checkpoint_dir={root / 'ckpts'}",
            f"logging.log_dir={root / 'logs'}",
            "training.num_epochs=1"]
    if (args.prod_f, args.prod_h, args.prod_w) != (96, 480, 640):
        sets += [f"model.init_features={args.prod_f}",
                 f"data.input_height={args.prod_h}",
                 f"data.input_width={args.prod_w}"]
    return sets


def production_kernels(device, args, card: str):
    """26a, first: the two-pass kernels at the production decoder maps
    (bf16, the five levels at 8 images a card): the forward at max error
    0 against its plain version, served and storing V, and the backward
    within phase 6's limits; then their device times, bounds, plain
    versions and F.grid_sample's at each level."""
    import copy

    import torch

    shapes = decoder_shapes(args.prod_batch, args.prod_h, args.prod_w,
                            args.prod_f)
    with torch.no_grad():
        fwd = check_kernel(device, shapes, args.seed + 41, ("bfloat16",))
    if fwd["bfloat16"] != 0.0:
        raise AssertionError(f"production forward differs from plain: "
                             f"{fwd}")
    bwd = check_backward(device, shapes, args.seed + 42, ("bfloat16",))
    prod = copy.copy(args)
    prod.batch = prod.train_batch = args.prod_batch
    prod.height, prod.width, prod.init_features = \
        args.prod_h, args.prod_w, args.prod_f
    prod.timing_iters = args.prod_iters
    bwd_rows = bwd_times(device, prod, card)
    from cadepth_tpu_torch.ops import two_pass_warp as warp
    from cadepth_tpu_torch.ops.affine_warp import two_pass_affine_warp_plain
    with torch.no_grad():
        fwd_rows, fwd_total = level_times(
            device, prod, card, "two_pass_warp", warp.two_pass_warp,
            two_pass_affine_warp_plain, warp, TWO_PASS_FWD_KEYS)
    return {"fwd_max_abs_err": fwd, "bwd_max_abs_err": bwd,
            "bwd_levels": bwd_rows, "fwd_levels": fwd_rows,
            "fwd_per_forward": fwd_total,
            "shapes": {k: list(v) for k, v in shapes}}


def production_train(device, args, card: str, root: pathlib.Path):
    """26a: the train CLI on configs/train_config_production.yaml, unedited
    (its --set overrides: production_sets), for 3 steps at batch 8 from a
    seeded synthetic 640x480 set of the four sensors (host-fed: cv2
    decode, random crop 0.6-1.0, flip, jitter), validation and panels,
    counted (5 forward launches storing V and 15 backward launches a
    step); then the bare step's p50/p95 on held batches, the device's
    busy share over 2 loop steps, peak memory; a checkpoint."""
    import math

    import torch

    from cadepth_tpu_torch.cli import train as train_cli
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    cuda = device.type == "cuda"
    unit = "" if cuda else " [CPU rehearsal, not device numbers]"
    t0 = time.perf_counter()
    manifest = generate_synthetic_dataset(
        str(root / "data"), images_per_sensor=PROD_SCENES, seed=args.seed + 43,
        structured=True, sensor_specs={s: (640, 480, 640, 480)
                                       for s in SENSORS})
    log(f"  {4 * PROD_SCENES} seeded structured scenes at 640x480 written "
        f"by generate_synthetic_dataset in {time.perf_counter() - t0:.1f} s")
    sets = production_sets(root, args, manifest)
    argv = ["--config", str(PRODUCTION_CONFIG), "--device", device.type]
    for s in sets:
        argv += ["--set", s]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_warp_counts()
    t0 = time.perf_counter()
    with LoopProbe() as run:
        rc = train_cli.main(argv)
    wall = time.perf_counter() - t0
    counts = warp_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if rc != 0:
        raise AssertionError(f"the train CLI exited {rc}")
    trainer = run.trainers[0]
    cfg = trainer.cfg
    steps = sum(ep["steps"] for ep in run.epochs)
    n_pcl = len(pcl_layers(trainer.model))
    val_batches = len(trainer.val_pipe)
    vis = min(cfg.training.num_vis_samples, len(trainer.val_loader))
    forwards_no_v = val_batches + (1 if vis else 0)
    want = {"v_stores": n_pcl * steps if cuda else 0,
            "bwd_launches": 3 * n_pcl * steps if cuda else 0,
            "launches": n_pcl * (steps + forwards_no_v) if cuda else 0,
            "fused": 0, **norm_counts(trainer.model, steps, cuda)}
    log(f"  train CLI on {PRODUCTION_CONFIG.relative_to(ROOT)} "
        f"(--set {' '.join(s.split('=')[0] for s in sets)}): "
        f"{cfg.model.architecture} f={cfg.model.init_features} "
        f"{cfg.data.input_height}x{cfg.data.input_width} pcl_warp "
        f"{cfg.model.pcl_warp}, batch {cfg.training.batch_size}, "
        f"{len(trainer.train_loader)} train samples, {steps} steps, "
        f"producer {run.epochs[0]['producer']}, {wall:.1f} s; two_pass_warp "
        f"and batch norm {counts} ({training_norms(trainer.model)} norm "
        f"calls each way a step); expected {want}")
    if cfg.training.batch_size != args.prod_batch or steps != 3:
        raise AssertionError(f"{steps} steps at batch "
                             f"{cfg.training.batch_size}")
    if counts != want:
        raise AssertionError(f"warp launches {counts} != {want}")
    losses = [float(x) for x in run.losses]
    ckpt_dir = root / "ckpts" / cfg.experiment.name
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"step losses {losses}")
    if not (ckpt_dir / "best" / "state.pt").exists():
        raise AssertionError(f"no best/ checkpoint under {ckpt_dir}")
    val = trainer.history[-1]
    log(f"  step losses {[round(x, 5) for x in losses]}; validation "
        f"abs_rel {val['abs_rel']:.5g}, rmse {val['rmse']:.5g}; "
        f"checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")
    if not all(math.isfinite(val[k]) for k in ("abs_rel", "rmse")):
        raise AssertionError(f"validation {val}")

    # the bare step on held batches: p50/p95, peak memory
    held = []
    for b in trainer.train_pipe:
        held.append(b)
        if len(held) == 2:
            break
    step = trainer.train_step
    for b in held:
        step(b)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(args.prod_steps):
        t1 = time.perf_counter()
        step(held[i % len(held)])
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1000.0)
    times.sort()
    p50 = times[len(times) // 2]
    p95 = times[min(len(times) - 1, int(round(0.95 * (len(times) - 1))))]
    step_peak = torch.cuda.max_memory_allocated() if cuda else None
    out = {"config": str(PRODUCTION_CONFIG.relative_to(ROOT)), "sets": sets,
           "batch": args.prod_batch, "steps": steps, "warp_counts": counts,
           "pcls": n_pcl,
           "losses": losses, "val": {k: val[k] for k in ("abs_rel", "rmse")},
           "train_cli_wall_s": wall, "peak_bytes_train_cli": peak,
           "step_p50_ms": p50, "step_p95_ms": p95, "steps_timed": len(times),
           "images_per_sec": args.prod_batch * 1000.0 / p50,
           "peak_bytes": step_peak, "checkpoint": str(ckpt_dir / "best")}
    log(f"  [{card}] production bare step, batch {args.prod_batch}: p50 "
        f"{p50:.3f} ms, p95 {p95:.3f} ms, {out['images_per_sec']:.2f} "
        f"images/s ({len(times)} steps on held batches, host clock to a "
        "synchronize)" + (f"; peak device memory {step_peak / 2**30:.3f} "
                          f"GiB over the steps, {peak / 2**30:.3f} GiB over "
                          "the train CLI's run" if cuda else "") + unit)
    del held
    if cuda:
        # an epoch of this set is 3 batches: one to warm, two profiled
        out["profile"] = prof = busy_share(trainer, 2)
        log(f"  [{card}] profile of 2 host-fed production loop steps "
            f"(torch.profiler): device busy {prof['busy_ms']:.3f} ms of "
            f"{prof['wall_ms']:.3f} ms wall ({prof['busy_share']:.1%}), "
            f"{prof['kernels_per_step']} kernels a step")
    return out


# the batch norm's kernels, by name, and the training cells' norm maps
BN_KERNEL_KEYS = ("reduce_kernel", "fwd_finalize_kernel", "apply_kernel",
                  "bwd_finalize_kernel", "dx_kernel")


def norm_map_shapes(batch: int, height: int, width: int, f: int):
    """[(name, (B, C, H, W))] of the six shapes of the geometry network's
    22 training norm maps: enc1 .. enc5 (each at two calls a block, and
    the decoder block of its level at the same shape) and the
    bottleneck."""
    shapes, h, w = [], height, width
    for k in range(6):
        shapes.append(("bottleneck" if k == 5 else f"level{k + 1}",
                       (batch, f << k, h, w)))
        h, w = h // 2, w // 2
    return shapes


def bf16_ulp(t):
    """One bf16 unit in the last place at each element's magnitude."""
    import torch

    mag = t.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_batch_norm(bn, x, dy, w, b, state):
    """The training batch norm as the model calls it (``batch_norm_train``
    and autograd's backward: the kernels on the card) against its plain
    version and a float64 evaluation of the same formula: y, the running
    statistics, dx, dweight and dbias each no further from the float64
    values than the plain version's, plus one bf16 ulp of each element,
    taken at no less than 2^-12 of the largest (the rule and its reason:
    ``tests/test_torch_cuda.py::
    test_batch_norm_kernels_against_plain_and_float64_on_card``). Raises
    where one lies outside; returns {output: (max|got - float64|, max|plain
    - float64|)}."""
    import torch

    def fresh(dtype=torch.float32):
        return [t.clone() if t.dtype == torch.long else
                t.to(dtype, copy=True) for t in state]

    rm, rv, tracked = fresh()
    xg = x.detach().requires_grad_()
    wg, bg = w.detach().clone().requires_grad_(), \
        b.detach().clone().requires_grad_()
    before = (bn.launches, bn.bwd_launches)
    y = bn.batch_norm_train(xg, wg, bg, rm, rv, tracked, 1e-5, 0.01)
    y.backward(dy)
    if x.is_cuda and (bn.launches - before[0],
                      bn.bwd_launches - before[1]) != (1, 1):
        raise AssertionError("batch_norm_train did not run the kernels once "
                             "each way")
    got = {"y": y, "running statistics": torch.stack([rm, rv]),
           "dx": xg.grad, "dweight": wg.grad, "dbias": bg.grad}
    rm_p, rv_p, tracked_p = fresh()
    y_p, st_p = bn.forward_plain(x, w, b, rm_p, rv_p, tracked_p, 1e-5, 0.01,
                                 True)
    plain = dict(zip(("dx", "dweight", "dbias"),
                     bn.backward_plain(x, dy, w, st_p)))
    plain.update(y=y_p, **{"running statistics": torch.stack([rm_p, rv_p])})
    rm_r, rv_r, tracked_r = fresh(torch.float64)
    x64, w64 = x.double(), w.double()
    y_r, st_r = bn.forward_plain(x64, w64, b.double(), rm_r, rv_r, tracked_r,
                                 1e-5, 0.01, True)
    exact = dict(zip(("dx", "dweight", "dbias"),
                     bn.backward_plain(x64, dy.double(), w64, st_r)))
    exact.update(y=y_r, **{"running statistics": torch.stack([rm_r, rv_r])})
    del x64
    if not int(tracked) == int(tracked_p) == int(state[2]) + 1:
        raise AssertionError("num_batches_tracked did not move once")
    out = {}
    for name, k in got.items():
        p, r = plain[name], exact[name]
        err_k, err_p = (k.double() - r).abs(), (p.double() - r).abs()
        ulp = bf16_ulp(r.abs().clamp_min(r.abs().max() * 2.0 ** -12))
        if k.dtype != p.dtype or not (err_k <= err_p + ulp.double()).all():
            raise AssertionError(
                f"batch norm {name} at {tuple(x.shape)}: max|got - float64| "
                f"{err_k.max().item():.3g} past the plain version's "
                f"{err_p.max().item():.3g} plus one bf16 ulp")
        out[name] = (err_k.max().item(), err_p.max().item())
    return out


def batch_norm_kernels(device, args, card: str):
    """27: the batch norm's kernels at the flagship's and the production
    network's six norm map shapes: ``batch_norm_train`` and its backward
    held to float64 by :func:`check_batch_norm`, then device times a call,
    bound, plain and F.batch_norm's. Returns {configuration: {name:
    row}}."""
    import torch
    import torch.nn.functional as F

    from cadepth_tpu_torch.ops import batch_norm as bn

    cuda = device.type == "cuda"
    timer = Timer(device)
    unit = "" if cuda else " [CPU rehearsal ms, not device numbers]"
    gen = torch.Generator(device=device).manual_seed(args.seed + 27)
    configs = {"flagship": norm_map_shapes(args.feed_batch, args.height,
                                           args.width, args.init_features),
               "production": norm_map_shapes(args.prod_batch, args.prod_h,
                                             args.prod_w, args.prod_f)}
    out = {}
    for config, shapes in configs.items():
        rows = {}
        for name, shape in shapes:
            c = shape[1]
            x = (torch.randn(shape, device=device, generator=gen) * 1.5
                 + 2.0).to(torch.bfloat16).contiguous(
                     memory_format=torch.channels_last)
            dy = (torch.randn(shape, device=device, generator=gen) * 0.01
                  ).to(torch.bfloat16).contiguous(
                      memory_format=torch.channels_last)
            w = torch.rand(c, device=device, generator=gen) + 0.5
            b = torch.randn(c, device=device, generator=gen) * 0.3
            state = [torch.randn(c, device=device, generator=gen) * 0.1,
                     torch.rand(c, device=device, generator=gen) + 0.5,
                     torch.zeros((), dtype=torch.long, device=device)]
            errs = check_batch_norm(bn, x, dy, w, b, state)
            if cuda:
                torch.cuda.empty_cache()

            def fwd():
                return _bn_fwd(bn, x, w, b, state, plain=not cuda)

            def bwd(stats):
                return _bn_bwd(bn, x, dy, w, stats, plain=not cuda)

            n = x.numel()
            bound_ms = 10 * n / HBM_BYTES_PER_S * 1e3

            def pair():
                bwd(fwd()[1])

            def plain():
                _, st = bn.forward_plain(x, w, b, *state, 1e-5, 0.01, True)
                bn.backward_plain(x, dy, w, st)

            xl = x.detach().requires_grad_()
            wl, bl = w.detach().requires_grad_(), b.detach().requires_grad_()

            def library():
                F.batch_norm(xl, None, None, wl, bl, training=True,
                             eps=1e-5).backward(dy)

            iters = args.timing_iters
            row = dict(shape=shape, bound_ms=bound_ms, bytes=10 * n,
                       err_vs_float64={k: {"got": e[0], "plain": e[1]}
                                       for k, e in errs.items()})
            for key, fn in (("kernel", pair), ("plain", plain),
                            ("library", library)):
                k = iters if key != "plain" else max(iters // 10, 2)
                before = bn.launches
                row[f"{key}_wall_ms"] = timer(fn, k, 2)
                if key == "kernel" and cuda and bn.launches == before:
                    raise AssertionError("timing loop did not launch the "
                                         "batch norm's kernels")
                expect = dict(kernels=BN_KERNEL_KEYS,
                              launches=bn.LAUNCHES_PER_CALL
                              + bn.BWD_LAUNCHES_PER_CALL) \
                    if key == "kernel" else {}
                row[f"{key}_ms"] = device_ms(fn, k, **expect)[0] \
                    if cuda else None
            rows[name] = row

            def fmt(key):
                dev = row[f"{key}_ms"]
                return (f"{dev:.4f} ms device" if dev is not None
                        else "device not measured") + \
                    f" / {row[f'{key}_wall_ms']:.4f} ms wall"
            share = (f", {bound_ms / row['kernel_ms']:.1%} of bound"
                     if row["kernel_ms"] else "")
            log(f"  [{card}] {config} {name} {shape} bf16 batch norm "
                f"forward + backward: kernels {fmt('kernel')}; bound "
                f"{bound_ms * 1e3:.1f} us (bytes, {10 * n / 1e6:.1f} MB)"
                f"{share}; plain {fmt('plain')}; F.batch_norm "
                f"{fmt('library')}; max|x - float64| of batch_norm_train "
                f"(plain) " + ", ".join(f"{k} {e[0]:.3g} ({e[1]:.3g})"
                                        for k, e in errs.items())
                + f", each within the plain's + 1 bf16 ulp{unit}")
        step = {k: (None if any(r[k] is None for r in rows.values()) else
                    sum(r[k] * (2 if n == "bottleneck" else 4)
                        for n, r in rows.items()))
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"  [{card}] {config}: the 22 calls of a step (4 at each level's "
            f"shape, 2 at the bottleneck's): " + ", ".join(
                f"{k} {v:.4f}" for k, v in step.items() if v is not None)
            + unit)
        out[config] = {"levels": rows, "step": step}
    return out


def _bn_fwd(bn, x, w, b, state, plain=False):
    if plain:
        return bn.forward_plain(x, w, b, *state, 1e-5, 0.01, True)
    return bn._forward_card(x, w, b, *state, 1e-5, 0.01, True, None, x.dtype)


def _bn_bwd(bn, x, dy, w, stats, plain=False):
    if plain:
        return bn.backward_plain(x, dy, w, stats)
    return bn._backward_card(x, dy, w, stats, None)


def production(device, args, card: str, root: pathlib.Path):
    """Phase 26: the production configuration on the card (26a), its
    capacity check (26b) and the conditioning probe on 26a's checkpoint
    (26c)."""
    import gc

    import numpy as np
    import torch

    from cadepth_tpu_torch.cli import capacity_check, probe_conditioning

    cuda = device.type == "cuda"
    kernels = production_kernels(device, args, card)
    train = production_train(device, args, card, root)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    phase("26b. the production capacity check")
    if cuda:
        record = capacity_check.run(batch=args.prod_batch, cards=4, log=log)
        top = record.pop("top_at_peak")
        log("  CAPACITY " + json.dumps(record))
        if not record["fits"]:
            raise AssertionError("the production step and a card's share "
                                 "of the resident pack do not fit the card")
        record["top_at_peak"] = top
    else:
        pack = capacity_check.resident_pack(4)
        log("  skipped: the capacity check measures a card (no CPU mode); "
            f"the resident pack over 4 cards: {pack}")
        record = {"resident_pack": pack}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    phase("26c. the conditioning probe on 26a's checkpoint")
    reset_warp_counts()
    from cadepth_tpu_torch.config import load_config, parse_overrides
    probe_cfg = load_config(str(PRODUCTION_CONFIG), overrides=parse_overrides(
        train["sets"]))
    report = probe_conditioning.probe(probe_cfg, "best", 4, device)
    counts = warp_counts()
    want = {"launches": 4 * train["pcls"] if cuda else 0, "bwd_launches": 0,
            "v_stores": 0, "fused": 0, **NO_NORMS}
    log(f"  probe report {json.dumps(report)}; two_pass_warp {counts}, "
        f"expected {want} (4 forwards)")
    if counts != want:
        raise AssertionError(f"the probe's warp launches {counts} != {want}")
    keys = ("mean_depth_m", "delta_focal_x1.5_m", "delta_focal_x0.75_m",
            "delta_principal_+16px_m")
    if not all(np.isfinite(report[k]) for k in keys) or \
            not report["delta_focal_x1.5_m"] > 0:
        raise AssertionError(f"the probe's report {report}")
    return {"kernels": kernels, "train": train, "capacity": record,
            "probe": dict(report, warp_counts=counts)}



# phase 28: the attention kernels' names (substrings) by SDPA backend
SDPA_BACKENDS = (("flash", ("flash_fwd", "flash_bwd", "pytorch_flash")),
                 ("cudnn", ("cudnn_generated", "sdpa_cudnn", "fmha_sm90",
                            "cudnn::fusion")),
                 ("efficient", ("fmha_cutlass", "efficient_attention",
                                "mem_efficient")))
# phase 28: the f32 port against the f32 reference, depth in metres
# relative (SDPA's fused softmax and the LayerNorm's fused statistics
# against the materialised ones, over 24 blocks and 1,814 tokens)
DAV2_F32_RTOL = 1e-3
# the bf16 port against the f32 reference: ||d - r|| / ||r - mean(r)||
# a frame, the benchmark cell's limit on depth_dev_first
DAV2_BF16_DEV = 0.15
DAV2_STEPS = 10


def depth_anything(device, args, card: str) -> dict:
    """28: Depth Anything V2-Large (metric) through the port's TrainStep at
    batch ``args.dav2_batch`` of ``args.dav2_h`` x ``args.dav2_w`` frames,
    bf16 over float32 parameters: the step's time (CUDA events over
    DAV2_STEPS steps after 3), the peak, the SDPA backend that ran (by its
    kernels' names in a profiled step) and the attention's card time (its
    kernels' device time, and the port's spans ``attn.fwd`` + ``attn.bwd``),
    then the port against the plain float32 reference
    (``tests/reference_dav2.py``) on the card at batch 2: the port in
    float32 and in bf16."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from reference_dav2 import DepthAnythingV2Ref

    from cadepth_tpu_torch.config import config_from_dict
    from cadepth_tpu_torch.models import factory
    from cadepth_tpu_torch.training.train_state import (
        build_model_and_loss, build_optimizer, make_train_step)
    from cadepth_tpu_torch.utils import profiling

    cuda = device.type == "cuda"
    widths = factory.DAV2_VARIANTS["vitl"]
    if not cuda:
        widths = dict(embed_dim=64, depth=4, num_heads=4, taps=(0, 1, 2, 3),
                      features=32, out_channels=(32, 64, 64, 64))
    b, h, w = args.dav2_batch, args.dav2_h, args.dav2_w
    saved = factory.DAV2_VARIANTS["vitl"]
    factory.DAV2_VARIANTS["vitl"] = widths
    try:
        cfg = config_from_dict({
            "model": {"architecture": "depth_anything_v2", "variant": "vitl",
                      "max_depth": 20.0},
            "data": {"input_height": h, "input_width": w},
            "optimization": {"optimizer": "adamw", "learning_rate": 1e-5,
                             "lr_scheduler": "none", "lr_warmup_epochs": 0},
            "training": {"batch_size": b, "use_amp": True}})
        model, loss_fn = build_model_and_loss(
            cfg, device=device, generator=torch.Generator().manual_seed(28))
    finally:
        factory.DAV2_VARIANTS["vitl"] = saved
    params = factory.count_parameters(model)
    opt = build_optimizer(cfg.optimization, model.parameters())
    step = make_train_step(cfg, model, loss_fn, opt, lambda i: 1e-5)
    gen = torch.Generator(device=device).manual_seed(args.seed + 28)
    k = torch.eye(3, device=device).repeat(b, 1, 1)
    k[:, 0, 0], k[:, 1, 1] = 0.8 * w, 0.8 * w
    k[:, 0, 2], k[:, 1, 2] = w / 2.0, h / 2.0
    batch = {"rgb": torch.rand(b, h, w, 3, device=device, generator=gen),
             "depth": 0.5 + 9.0 * torch.rand(b, h, w, 1, device=device,
                                             generator=gen),
             "intrinsics": k}
    batch["k4"] = torch.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2],
                               k[:, 1, 2]], -1)
    for _ in range(3):
        logs = step(batch)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps = DAV2_STEPS if cuda else 2
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = step(batch)
    loss = float(logs["total_loss"])
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    if not math.isfinite(loss):
        raise AssertionError(f"DA-V2's training loss is {loss}")
    log(f"  DA-V2-L ({params:,} parameters) at batch {b}, {h}x{w}, bf16: "
        f"step {step_ms:.2f} ms ({1e3 * b / step_ms:.2f} images/s), peak "
        f"{peak:.2f} GiB, loss {loss:.4f}")

    profiling.clear_spans()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        step(batch)
        if cuda:
            torch.cuda.synchronize()
    spans = profiling.recorded_spans()
    span_ms = {n: sum(s["device_ms"] or 0.0 for s in spans if s["name"] == n)
               for n in ("attn.fwd", "attn.bwd", "vit.encoder",
                         "vit.encoder.bwd", "dpt.head", "dpt.head.bwd",
                         "train.step")}
    profiling.clear_spans()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() * 1e-3
    backend, attn_ms, names = None, 0.0, []
    for name, keys in SDPA_BACKENDS:
        hits = {n: t for n, t in kernels.items()
                if any(key in n for key in keys)}
        if hits:
            backend = backend or name
            attn_ms += sum(hits.values())
            names += sorted(hits)
    if cuda and backend is None:
        top = sorted(kernels.items(), key=lambda x: -x[1])[:12]
        raise AssertionError(f"no SDPA kernel found among {top}")
    log(f"  SDPA backend: {backend} ({names}); attention kernels "
        f"{attn_ms:.2f} ms a step; spans (card ms): "
        + ", ".join(f"{n} {v:.2f}" for n, v in span_ms.items()))
    del opt, step, logs
    gc.collect()

    # the port against the reference, float32 (TF32 off) and bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = DepthAnythingV2Ref(max_depth=20.0, **widths).to(device)
    ref.load_state_dict(model.state_dict())
    rgb = batch["rgb"][:2]
    with torch.no_grad():
        want = ref(rgb).double()
        got16 = model(rgb).double()
        f32 = factory.DepthAnythingV2(max_depth=20.0, dtype=torch.float32,
                                      **widths).to(device)
        f32.load_state_dict(model.state_dict())
        got32 = f32(rgb).double()
    rel = float(((got32 - want).abs() / want.abs()).max())
    flat_w, flat_g = want.reshape(2, -1), got16.reshape(2, -1)
    dev = ((flat_g - flat_w).norm(dim=1)
           / (flat_w - flat_w.mean(1, keepdim=True)).norm(dim=1)).tolist()
    log(f"  port against the reference at batch 2: float32 max relative "
        f"{rel:.3e} (limit {DAV2_F32_RTOL}), bf16 deviation {dev} (limit "
        f"{DAV2_BF16_DEV}); reference depth {float(want.mean()):.3f} +- "
        f"{float(want.std()):.3f} m")
    if not rel < DAV2_F32_RTOL or not max(dev) < DAV2_BF16_DEV:
        raise AssertionError("DA-V2's port is off the reference")
    del ref, f32, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"params": params, "batch": b, "size": [h, w], "step_ms": step_ms,
            "images_per_s": 1e3 * b / step_ms, "peak_gib": peak,
            "sdpa_backend": backend, "sdpa_kernels": names,
            "attention_kernel_ms": attn_ms, "span_ms": span_ms,
            "f32_max_rel": rel, "bf16_dev": dev}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at a tiny size with the "
                         "plain warp; prints no result")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", type=int, choices=(28,),
                    help="run phases 1, 2 and this one alone")
    ap.add_argument("--dp-worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--sp-worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.dp_worker:
        sys.path.insert(0, str(ROOT))
        rank, port, work = args.dp_worker
        return dp_worker(int(rank), int(port), pathlib.Path(work),
                         args.cpu_rehearsal)
    if args.sp_worker:
        sys.path.insert(0, str(ROOT))
        rank, port, work = args.sp_worker
        return sp_worker(int(rank), int(port), pathlib.Path(work),
                         args.cpu_rehearsal)

    rehearsal = args.cpu_rehearsal
    if rehearsal:
        device = torch.device("cpu")
        args.init_features, args.height, args.width, args.batch = 8, 64, 64, 4
        args.timing_iters, args.bench_iters, args.mode_bench_iters = 4, 3, 3
        args.train_batch, args.train_steps, args.train_time_steps = 4, 3, 3
        args.loop_scenes, args.loop_val = 4, 8
        args.feed_scenes, args.feed_batch, args.feed_val = 4, 4, 8
        args.feed_chunk, args.feed_iters = 4, 3
        # phase 26: the production file at f=8, 64x64 (its batch of 8)
        args.prod_batch, args.prod_f, args.prod_h, args.prod_w = 8, 8, 64, 64
        args.prod_iters, args.prod_steps = 3, 3
        # phase 28: the tiny DA-V2 at 28x42
        args.dav2_batch, args.dav2_h, args.dav2_w = 2, 28, 42
        card = "cpu rehearsal"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; this "
                  "script needs an NVIDIA card", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        args.init_features, args.height, args.width, args.batch = \
            64, 240, 320, 8
        args.timing_iters, args.bench_iters, args.mode_bench_iters = \
            100, 50, 20
        args.train_batch, args.train_steps, args.train_time_steps = 4, 10, 20
        # phase 19: 96 scenes (24 a sensor), validation capped at 32
        args.loop_scenes, args.loop_val = 24, 32
        # phase 20: 512 scenes (128 a sensor), batch 32 as the flagship's
        # b32 config ships it, validation capped at 64, chunks of 128
        args.feed_scenes, args.feed_batch, args.feed_val = 128, 32, 64
        args.feed_chunk, args.feed_iters = 128, 20
        # phase 26: configs/train_config_production.yaml as it ships
        # (f=96, 480x640) at 8 images a card (its global 32 over four)
        args.prod_batch, args.prod_f, args.prod_h, args.prod_w = \
            8, 96, 480, 640
        args.prod_iters, args.prod_steps = 20, PROD_TIMED_STEPS
        # phase 28: DA-V2-L at a card's 8 of 518x686 frames
        args.dav2_batch, args.dav2_h, args.dav2_w = 8, 518, 686
        card = card_info()
    sys.path.insert(0, str(ROOT))
    import cadepth_tpu_torch  # noqa: F401  (fails outside a checkout)
    from cadepth_tpu_torch.ops import _build

    phase(f"1. card: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("  TF32 off for cuDNN convolutions and matmuls "
        "(the f32 comparisons need full f32)")

    phase("2. build")
    if rehearsal:
        log("  skipped: no nvcc in a CPU rehearsal")
    else:
        t0 = time.perf_counter()
        libs = _build.build_all()
        log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
            f"into {_build.BUILD_DIR.relative_to(ROOT)}/")

    if args.phase == 28:
        phase("28. Depth Anything V2-Large (metric) at the cell's batch")
        dav2 = depth_anything(device, args, card)
        log(card_info() if not rehearsal else card)
        print(json.dumps({"ok": True, "depth_anything_v2": dav2}),
              flush=True)
        return 0

    # serving runs without autograd, as Predictor does
    with torch.no_grad():
        phase("3. kernel against plain")
        shapes = decoder_shapes(args.batch, args.height, args.width,
                                args.init_features)
        worst = check_kernel(device, shapes, args.seed)

        phase("4. serving")
        from cadepth_tpu_torch.ops import two_pass_warp as warp
        warp.bwd_launches = 0
        pred, launches, per_forward, serve_err, request = serve(device, args)
        cross_err = cross_device(device, args)
        if warp.bwd_launches:
            raise AssertionError("serving launched the backward kernels")

        phase("5. times")
        rows, total, bench, one, peak, prof = times(device, args, pred, card)
    # phase 11 serves these weights with pcl_warp fused
    weights = {k: v.cpu() for k, v in pred.model.state_dict().items()}
    del pred

    phase("6. backward kernels against plain")
    bwd_worst = check_backward(
        device, decoder_shapes(args.train_batch, args.height, args.width,
                               args.init_features), args.seed + 8)

    phase("7. training")
    tr = train(device, args)
    metrics_err = metrics_card_vs_cpu(tr)

    phase("8. training, card against CPU")
    cross_train = cross_device_train(device, args)

    phase("9. training times")
    bwd_rows = bwd_times(device, args, card)
    log(f"  [{card}] two_pass_warp over the five levels per train step: "
        + ", ".join(f"{k} {v:.4f} ms" for k in (
            "train_fwd_ms", "train_fwd_bound_ms", "kernel_ms", "passes_ms",
            "bound_ms", "kernel_host_ms")
            if (v := level_sum(bwd_rows, k)) is not None))
    train_out = train_times(device, args, card, tr)
    del tr["model"], tr["step"]

    with torch.no_grad():
        phase("10. fused warp kernels against plain")
        fwd_worst, fbwd_worst = check_fused(
            device, decoder_shapes(args.batch, args.height, args.width,
                                   args.init_features),
            decoder_shapes(args.train_batch, args.height, args.width,
                           args.init_features), args.seed + 10)

        phase("11. serving with pcl_warp fused")
        fused, f_launches, f_per_forward, f_errs = serve_fused(
            device, args, weights, request)
        f_rows, f_total, f_bench, f_prof = fused_serve_times(device, args,
                                                             card, fused)
    del fused

    phase("12. training with pcl_warp fused")
    ftr = train(device, args, "fused")

    phase("13. the fused depth loss")
    floss = fused_loss_phase(device, args, ftr)

    phase("14. fused times")
    f_bwd_rows = bwd_times(device, args, card, "fused_warp")
    log(f"  [{card}] fused_warp over the five levels per train step: "
        + ", ".join(f"{k} {v:.4f} ms" for k in (
            "train_fwd_ms", "train_fwd_bound_ms", "kernel_ms", "passes_ms",
            "bound_ms", "kernel_host_ms")
            if (v := level_sum(f_bwd_rows, k)) is not None))
    loss_rows = loss_times(device, args, card, floss["inputs"])
    f_train_out = train_times(device, args, card, ftr,
                              steps=args.train_steps)
    del ftr["model"], ftr["step"]

    with torch.no_grad():
        phase("15. banded affine warp kernel against plain")
        banded_worst = check_banded(
            device, decoder_shapes(args.batch, args.height, args.width,
                                   args.init_features), args.seed + 13)

        phase("16. serving with pcl_warp gather, auto and separable")
        modes, banded = serve_modes(device, args, card, weights, request)

    phase("17. training with pcl_warp gather, auto and separable; remat; "
          "norm group and decoder_upsample resize")
    mode_train = {"gather": train_mode(device, args, card, "gather",
                                       args.train_steps)}
    remat = train_mode(device, args, card, "gather", args.train_steps,
                       remat="highres")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(remat["losses"], mode_train["gather"]["losses"]))
    log(f"  remat highres against no remat: losses max rel diff {rel:.3g} "
        f"(rtol {TRAIN_RTOL})" + (
            f"; peak {remat['peak_bytes'] / 2**30:.3f} GiB against "
            f"{mode_train['gather']['peak_bytes'] / 2**30:.3f} GiB"
            if remat["peak_bytes"] else ""))
    if not rel <= TRAIN_RTOL:
        raise AssertionError(f"remat changed the losses by {rel}")
    remat["vs_no_remat_max_rel"] = rel
    mode_train["gather_remat_highres"] = remat
    for mode in ("auto", "separable"):
        mode_train[mode] = train_mode(device, args, card, mode, 3)
    mode_train["group_resize"] = train_mode(
        device, args, card, "two_pass", 3, norm="group",
        decoder_upsample="resize")
    with torch.no_grad():
        group_serve = serve_options(device, args, card)

        phase("18. banded affine warp and gather warp times")
        from cadepth_tpu_torch.ops import banded_affine_warp as baw
        b_rows, b_total = level_times(
            device, args, card, "banded_affine_warp", baw.banded_affine_warp,
            baw.banded_affine_warp_plain, baw, ("banded_affine_kernel",),
            flops_per_elem=8)
        b_floor = launch_floor_ms(args) if not rehearsal else None
        if b_floor is not None:
            log(f"  [{card}] the floor: an empty kernel's launch "
                f"{b_floor * 1e3:.2f} us device")
    g_rows, g_total = gather_times(device, args, card)

    # phases 19-22 work under one directory: phase 21 trains from phase
    # 19's pack, phase 22 serves phase 20's checkpoints
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="smoke_", dir=ROOT / "build"))
    roots = {k: work / f"phase{k}" for k in (19, 20, 21, 22, 23, 25, 26)}
    for r in roots.values():
        r.mkdir()
    try:
        phase("19. the trainer loop on host data")
        loop = trainer_loop(device, args, card, train_out["p50_ms"],
                            roots[19])

        phase("20. the GPU-resident feed")
        feed = device_feed(device, args, card, roots[20])

        phase("21. the other model families")
        families = other_families(device, args, card, roots[21],
                                  roots[19] / "pack")

        phase("22. serving from a checkpoint")
        served = serve_checkpoint(device, args, card, roots[22], roots[20],
                                  weights)

        phase("23. data parallel on the card; memory analysis; the data "
              "tools")
        dp = data_parallel(device, args, card, roots)

        phase("25. spatial parallelism: the windowed kernels, two bands "
              "of the flagship, the Trainer's spatial branch")
        spatial = spatial_parallel(device, args, card, roots)

        phase("26. the production configuration: geometry_aware f=96 at "
              "480x640, 8 images a card, its capacity check and the "
              "conditioning probe")
        prod = production(device, args, card, roots[26])

        phase("27. the training batch norm's kernels at the training "
              "cells' norm maps")
        norms = batch_norm_kernels(device, args, card)

        phase("28. Depth Anything V2-Large (metric) at the cell's batch")
        depth_anything(device, args, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del weights
    log(f"  wall time of the whole script: "
        f"{time.perf_counter() - START:.1f} s")

    if rehearsal:
        log("== rehearsal done: every phase ran on the CPU; no result "
            "is printed")
        return 0

    from cadepth_tpu_torch.ops import batch_norm as bn
    from cadepth_tpu_torch.ops import fused_loss as fl

    bn_launches = bn.LAUNCHES_PER_CALL + bn.BWD_LAUNCHES_PER_CALL
    dec1, bwd_dec1 = rows["dec1"], bwd_rows["dec1"]
    sp_counts = spatial["ranks"]["rank_counts"][0]
    sp_times = spatial["window_times"]

    def windowed(kind: str, launches: int, err: float) -> dict:
        t = sp_times[kind]
        return {
            "launches": launches, "max_abs_err": err,
            "ms": t["kernel_ms"], "wall_ms": t["kernel_wall_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "bound_bytes": t["bytes"],
            "library_ms": t["library_ms"],
            "library": "F.grid_sample on the window's rows of "
                       "F.affine_grid(theta)" + (
                           ", backward" if kind == "backward" else ""),
            "at": f"dec1 {t['shape']} bf16, output rows {t['window'][0]}.."
                  f"{sum(t['window']) - 1} (rank 0 of two bands)",
            "launches_how": f"phase 25b, rank 0 over {SP_STEPS} f32 steps "
                            f"on two bands ({spatial['ranks']['windowed_pcls']}"
                            " of the 5 PCLs on windows)"}
    pk, ptrain = prod["kernels"], prod["train"]
    pd1, pb1 = pk["fwd_levels"]["dec1"], pk["bwd_levels"]["dec1"]
    prod_at = (f"dec1 {pd1['shape']} bf16 (configs/train_config_production"
               ".yaml at 8 images a card)")
    b32_rows = feed["two_pass_b32"]["levels"]
    b32_dec1, feed_counts = b32_rows["dec1"], feed["train"]["warp_counts"]
    f_dec1, f_bwd_dec1 = f_rows["dec1"], f_bwd_rows["dec1"]
    light = families["geometry_aware_lightweight"]
    fam_keys = ("kernel_ms", "kernel_wall_ms", "plain_ms", "library_ms",
                "bound_ms")
    bwd_keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "train_fwd_ms", "train_fwd_bound_ms")
    kernels = {"kernels": [{
        "name": "two_pass_warp",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/two_pass_warp.cu",
        "replaces": f"{TPU_KERNEL}:80",
        "replaces_all": [f"{TPU_KERNEL}:80 _pass_v_kernel",
                         f"{TPU_KERNEL}:125 _pass_h_kernel"],
        "launches": launches,
        "launches_per_forward": per_forward,
        "launches_in_training": tr["launches"],
        "v_stores_in_training": tr["v_stores"],
        "launches_in_trainer_loop": loop["warp_counts"]["launches"],
        "v_stores_in_trainer_loop": loop["warp_counts"]["v_stores"],
        "launches_in_device_feed": feed_counts["launches"],
        "v_stores_in_device_feed": feed_counts["v_stores"],
        "launches_in_data_parallel":
            dp["group_of_one"]["warp_counts"]["launches"],
        "v_stores_in_data_parallel":
            dp["group_of_one"]["warp_counts"]["v_stores"],
        "lightweight": {
            "launches_in_training": light["train_counts"]["launches"],
            "v_stores_in_training": light["train_counts"]["v_stores"],
            "launches_per_forward":
                light[f"predictor_b{light['batch']}"]["warp_counts"]
                ["launches"],
            "max_abs_err_by_dtype": light["fwd_max_abs_err"],
            "levels": {k: {m: r[m] for m in fam_keys}
                       for k, r in light["fwd_levels"].items()},
            "at": "B=8, 240x320, f=32, bf16"},
        "launches_from_checkpoint": {
            k: v["warp_counts"]["launches"] for k, v in served.items()
            if k.startswith(("best", "latest"))},
        "launches_in_exported_program": {
            k: v["warp_counts"]["launches"] for k, v in served.items()
            if k.startswith("exported_b")},
        "at_batch_32": {
            "train_fwd_ms": b32_dec1["train_fwd_ms"],
            "train_fwd_bound_ms": b32_dec1["train_fwd_bound_ms"],
            "at": f"dec1 {b32_dec1['shape']} bf16, V stored",
            "per_step_ms": level_sum(b32_rows, "train_fwd_ms"),
            "max_abs_err_by_dtype": feed["two_pass_b32"]["fwd_max_abs_err"]},
        "windowed": windowed("forward", sp_counts["window_launches"],
                             spatial["windowed"]["fwd"]),
        "launches_in_spatial": sp_counts["launches"],
        "v_stores_in_spatial": sp_counts["v_stores"],
        "production": {
            "launches_in_training": ptrain["warp_counts"]["launches"],
            "v_stores_in_training": ptrain["warp_counts"]["v_stores"],
            "train_steps": ptrain["steps"],
            "launches_in_probe": prod["probe"]["warp_counts"]["launches"],
            "max_abs_err": pk["fwd_max_abs_err"]["bfloat16"],
            "ms": pd1["kernel_ms"], "wall_ms": pd1["kernel_wall_ms"],
            "bound_ms": pd1["bound_ms"], "bound_by": pd1["bound_by"],
            "plain_ms": pd1["plain_ms"], "library_ms": pd1["library_ms"],
            "train_fwd_ms": pb1["train_fwd_ms"],
            "train_fwd_bound_ms": pb1["train_fwd_bound_ms"],
            "per_forward_ms": pk["fwd_per_forward"]["kernel_ms"],
            "per_forward_bound_ms": pk["fwd_per_forward"]["bound_ms"],
            "at": prod_at,
            "levels": {k: {m: r[m] for m in ("kernel_ms", "kernel_wall_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms")}
                       for k, r in pk["fwd_levels"].items()},
            "train_fwd_levels": {
                k: {m: r[m] for m in ("train_fwd_ms", "train_fwd_bound_ms")}
                for k, r in pk["bwd_levels"].items()}},
        "max_abs_err": max(worst.values()),
        "max_abs_err_by_dtype": worst,
        "ms": dec1["kernel_ms"],
        "ms_how": "torch.profiler device time of the one launch per call, "
                  "as served (V kept in shared memory, none stored)",
        "train_fwd_ms": bwd_dec1["train_fwd_ms"],
        "train_fwd_at": f"dec1 {bwd_dec1['shape']} bf16, V stored",
        "train_fwd_bound_ms": bwd_dec1["train_fwd_bound_ms"],
        "wall_ms": dec1["kernel_wall_ms"],
        "plain_ms": dec1["plain_ms"],
        "bound_ms": dec1["bound_ms"],
        "bound_by": dec1["bound_by"],
        "library_ms": dec1["library_ms"],
        "library": "F.grid_sample(F.affine_grid(theta))",
        "at": f"dec1 {dec1['shape']} bf16",
        "per_forward_ms": total["kernel_ms"],
        "per_forward_wall_ms": total["kernel_wall_ms"],
        "per_forward_bound_ms": total["bound_ms"],
        "levels": {k: {m: r[m] for m in ("kernel_ms", "kernel_wall_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms")}
                   for k, r in rows.items()},
    }, {
        "name": "two_pass_warp_bwd",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/two_pass_warp.cu",
        "replaces": f"{TPU_KERNEL}:194",
        "replaces_all": [f"{TPU_KERNEL}:194 _bwd_h_kernel",
                         f"{TPU_KERNEL}:246 _bwd_v_kernel"],
        "launches": tr["bwd_launches"],
        "launches_per_step": tr["bwd_per_step"],
        "launches_in_trainer_loop": loop["warp_counts"]["bwd_launches"],
        "launches_in_device_feed": feed_counts["bwd_launches"],
        "launches_in_data_parallel":
            dp["group_of_one"]["warp_counts"]["bwd_launches"],
        "lightweight": {
            "launches_in_training": light["train_counts"]["bwd_launches"],
            "max_abs_err_by_dtype": light["bwd_max_abs_err"],
            "levels": {k: {m: r[m] for m in bwd_keys}
                       for k, r in light["bwd_levels"].items()},
            "at": "B=8, 240x320, f=32, bf16"},
        "at_batch_32": {
            "ms": b32_dec1["kernel_ms"], "bound_ms": b32_dec1["bound_ms"],
            "plain_ms": b32_dec1["plain_ms"],
            "library_ms": b32_dec1["library_ms"],
            "at": f"dec1 {b32_dec1['shape']} bf16",
            "per_step_ms": level_sum(b32_rows, "kernel_ms"),
            "per_step_bound_ms": level_sum(b32_rows, "bound_ms"),
            "max_abs_err_by_dtype": feed["two_pass_b32"]["bwd_max_abs_err"]},
        "windowed": dict(windowed(
            "backward", sp_counts["window_bwd_launches"],
            max(spatial["windowed"]["float32"],
                spatial["windowed"]["bfloat16"])),
            max_abs_err_how="the windows' d_img summed against the whole "
                            "backward's, over max(1, max|d_img|)",
            d_theta_rel_err=spatial["windowed"]["d_theta"]),
        "launches_in_spatial": sp_counts["bwd_launches"],
        "production": {
            "launches_in_training": ptrain["warp_counts"]["bwd_launches"],
            "train_steps": ptrain["steps"],
            "max_abs_err": pk["bwd_max_abs_err"]["bfloat16"],
            "max_abs_err_how": "d_img against the plain backward, limit "
                               "2e-2 x max(1, max|d_img|)",
            "d_theta_rel_err": pk["bwd_max_abs_err"]["d_theta"],
            "ms": pb1["kernel_ms"], "passes_ms": pb1["passes_ms"],
            "bound_ms": pb1["bound_ms"], "bound_by": pb1["bound_by"],
            "plain_ms": pb1["plain_ms"], "library_ms": pb1["library_ms"],
            "per_step_ms": level_sum(pk["bwd_levels"], "kernel_ms"),
            "per_step_bound_ms": level_sum(pk["bwd_levels"], "bound_ms"),
            "at": prod_at,
            "levels": {k: {m: r[m] for m in ("kernel_ms", "passes_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms")}
                       for k, r in pk["bwd_levels"].items()}},
        "max_abs_err": max(bwd_worst["float32"], bwd_worst["bfloat16"]),
        "max_abs_err_by_dtype": bwd_worst,
        "ms": bwd_dec1["kernel_ms"],
        "ms_how": "torch.profiler device time of the three backward "
                  "launches per call: both transposed passes, and the sum "
                  "of their theta partials with the chain to d_theta",
        "passes_ms": bwd_dec1["passes_ms"],
        "per_step_ms": level_sum(bwd_rows, "kernel_ms"),
        "per_step_passes_ms": level_sum(bwd_rows, "passes_ms"),
        "per_step_bound_ms": level_sum(bwd_rows, "bound_ms"),
        "per_step_train_fwd_ms": level_sum(bwd_rows, "train_fwd_ms"),
        "per_step_host_ms": level_sum(bwd_rows, "kernel_host_ms"),
        "call_ms": bwd_dec1["kernel_call_ms"],
        "host_ms": bwd_dec1["kernel_host_ms"],
        "wall_ms": bwd_dec1["kernel_wall_ms"],
        "plain_ms": bwd_dec1["plain_ms"],
        "bound_ms": bwd_dec1["bound_ms"],
        "bound_by": bwd_dec1["bound_by"],
        "bound_bytes": bwd_dec1["bytes"],
        "two_launch_bytes": bwd_dec1["two_launch_bytes"],
        "library_ms": bwd_dec1["library_ms"],
        "library": "backward of F.grid_sample(F.affine_grid(theta))",
        "at": f"dec1 {bwd_dec1['shape']} bf16",
        "levels": {k: {m: r[m] for m in ("kernel_ms", "passes_ms",
                                         "kernel_call_ms", "kernel_host_ms",
                                         "kernel_wall_ms", "train_fwd_ms",
                                         "train_fwd_bound_ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                   for k, r in bwd_rows.items()},
    }, {
        "name": "fused_warp",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/fused_warp.cu",
        "replaces": f"{FUSED_KERNEL}:110",
        "replaces_all": [f"{FUSED_KERNEL}:110 _fwd_v_banded_kernel",
                         f"{TPU_KERNEL}:125 _pass_h_kernel (pass H)"],
        "launches": f_launches,
        "launches_per_forward": f_per_forward,
        "launches_in_training": ftr["launches"],
        "v_stores_in_training": ftr["v_stores"],
        "launches_in_exported_program": served["exported_fused"]["launches"],
        "max_abs_err": max(fwd_worst.values()),
        "max_abs_err_by_dtype": fwd_worst,
        "ms": f_dec1["kernel_ms"],
        "ms_how": "torch.profiler device time of the one launch per call, "
                  "as served (V kept in shared memory, none stored)",
        "train_fwd_ms": f_bwd_dec1["train_fwd_ms"],
        "train_fwd_at": f"dec1 {f_bwd_dec1['shape']} bf16, V stored",
        "train_fwd_bound_ms": f_bwd_dec1["train_fwd_bound_ms"],
        "wall_ms": f_dec1["kernel_wall_ms"],
        "plain_ms": f_dec1["plain_ms"],
        "bound_ms": f_dec1["bound_ms"],
        "bound_by": f_dec1["bound_by"],
        "library_ms": f_dec1["library_ms"],
        "library": "F.grid_sample(F.affine_grid(theta))",
        "at": f"dec1 {f_dec1['shape']} bf16",
        "per_forward_ms": f_total["kernel_ms"],
        "per_forward_bound_ms": f_total["bound_ms"],
        "levels": {k: {m: r[m] for m in ("kernel_ms", "kernel_wall_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms")}
                   for k, r in f_rows.items()},
    }, {
        "name": "fused_warp_bwd",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/fused_warp.cu",
        "replaces": f"{FUSED_KERNEL}:150",
        "replaces_all": [f"{FUSED_KERNEL}:150 _bwd_v_banded_kernel",
                         f"{TPU_KERNEL}:194 _bwd_h_kernel (transposed "
                         "pass H)"],
        "launches": ftr["bwd_launches"],
        "launches_per_step": ftr["bwd_per_step"],
        "max_abs_err": max(fbwd_worst["float32"], fbwd_worst["bfloat16"]),
        "max_abs_err_by_dtype": fbwd_worst,
        "ms": f_bwd_dec1["kernel_ms"],
        "ms_how": "torch.profiler device time of the three backward "
                  "launches per call: both transposed passes, and the sum "
                  "of their theta partials with the chain to d_theta",
        "passes_ms": f_bwd_dec1["passes_ms"],
        "per_step_ms": level_sum(f_bwd_rows, "kernel_ms"),
        "per_step_passes_ms": level_sum(f_bwd_rows, "passes_ms"),
        "per_step_bound_ms": level_sum(f_bwd_rows, "bound_ms"),
        "per_step_train_fwd_ms": level_sum(f_bwd_rows, "train_fwd_ms"),
        "per_step_host_ms": level_sum(f_bwd_rows, "kernel_host_ms"),
        "call_ms": f_bwd_dec1["kernel_call_ms"],
        "host_ms": f_bwd_dec1["kernel_host_ms"],
        "wall_ms": f_bwd_dec1["kernel_wall_ms"],
        "plain_ms": f_bwd_dec1["plain_ms"],
        "bound_ms": f_bwd_dec1["bound_ms"],
        "bound_by": f_bwd_dec1["bound_by"],
        "bound_bytes": f_bwd_dec1["bytes"],
        "two_launch_bytes": f_bwd_dec1["two_launch_bytes"],
        "library_ms": f_bwd_dec1["library_ms"],
        "library": "backward of F.grid_sample(F.affine_grid(theta))",
        "at": f"dec1 {f_bwd_dec1['shape']} bf16",
        "levels": {k: {m: r[m] for m in ("kernel_ms", "passes_ms",
                                         "kernel_call_ms", "kernel_host_ms",
                                         "kernel_wall_ms", "train_fwd_ms",
                                         "train_fwd_bound_ms", "plain_ms",
                                         "library_ms", "bound_ms")}
                   for k, r in f_bwd_rows.items()},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/fused_loss.cu",
        "replaces": f"{LOSS_KERNEL}:{line}",
        "launches": floss[count],
        "max_abs_err": floss[err],
        "max_rel_err": floss[rel],
        "ms": loss_rows[name]["kernel_ms"],
        "ms_how": "torch.profiler device time of the launch",
        "call_ms": loss_rows[name]["kernel_call_ms"],
        "floor_ms": loss_rows[name]["floor_ms"],
        "floor_how": "torch.profiler device time of one launch of "
                     "torch.cuda._sleep(0)",
        "wall_ms": loss_rows[name]["kernel_wall_ms"],
        "plain_ms": loss_rows[name]["plain_ms"],
        "bound_ms": loss_rows[name]["bound_ms"],
        "bound_by": loss_rows[name]["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes these masked "
                   "sums (or their gradient)",
        "at": f"{loss_rows[name]['shape']} f32",
        "plan": (fl.stats_plan if name == "fused_loss_stats"
                 else fl.grad_plan)(*loss_rows[name]["shape"])._asdict(),
        **({key: loss_rows[name][key] for key in (
            "backward_call_ms", "backward_call_kernels",
            "backward_call_wall_ms", "same_bytes_ms", "same_bytes_how")}
           if name == "fused_loss_grad" else {}),
    } for name, line, count, err, rel in (
        ("fused_loss_stats", 49, "launches", "stats_abs", "stats_err"),
        ("fused_loss_grad", 91, "bwd_launches", "grad_abs", "grad_err"))] + [{
        "name": "banded_affine_warp",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/banded_affine_warp.cu",
        "replaces": f"{AFFINE_KERNEL}:76",
        "replaces_all": [f"{AFFINE_KERNEL}:76 _warp_kernel",
                         f"{AFFINE_KERNEL}:153 pallas_affine_warp"],
        "launches": banded["launches"],
        "launches_per_forward": banded["per_forward"],
        "max_abs_err": max(max(banded_worst.values()),
                           banded["max_abs_err"]),
        "max_abs_err_by_dtype": banded_worst,
        "vs_gather_max_rel_err": banded["vs_gather_max_rel_err"],
        "ms": b_rows["dec1"]["kernel_ms"],
        "ms_how": "torch.profiler device time of every kernel the call "
                  "runs (its one launch, checked)",
        "floor_ms": b_floor,
        "floor_how": "torch.profiler device time of one launch of "
                     "torch.cuda._sleep(0)",
        "plan": baw.affine_plan(*b_rows["dec1"]["shape"],
                                torch.bfloat16)._asdict(),
        "wall_ms": b_rows["dec1"]["kernel_wall_ms"],
        "plain_ms": b_rows["dec1"]["plain_ms"],
        "bound_ms": b_rows["dec1"]["bound_ms"],
        "bound_by": b_rows["dec1"]["bound_by"],
        "library_ms": b_rows["dec1"]["library_ms"],
        "library": "F.grid_sample(F.affine_grid(theta))",
        "at": f"dec1 {b_rows['dec1']['shape']} bf16",
        "per_forward_ms": b_total["kernel_ms"],
        "per_forward_bound_ms": b_total["bound_ms"],
        "levels": {k: {m: r[m] for m in ("kernel_ms", "kernel_wall_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms")}
                   for k, r in b_rows.items()},
    }],
        "train": dict(
        train_out, steps=len(tr["logs"]),
        forward_launches=tr["launches"], grad_copies=tr["grad_copies"],
        last_logs=tr["logs"][-1], eval=tr["eval"],
        kernel_vs_plain_max_rel=tr["kernel_vs_plain_rel"],
        kernel_vs_kernel_max_rel=tr["kernel_vs_kernel_rel"],
        card_vs_cpu_f32=cross_train, metrics_card_vs_cpu=metrics_err),
        "predictor": {
        "batch": args.batch, "p50_ms": bench["p50_ms"],
        "p95_ms": bench["p95_ms"], "images_per_sec": bench["images_per_sec"],
        "batch1_p50_ms": one["p50_ms"], "peak_bytes": peak,
        "served_vs_plain_max_err_m": serve_err,
        "card_vs_cpu_f32_max_err_m": cross_err, "profile": prof,
    }, "fused_predictor": {
        "batch": args.batch, "p50_ms": f_bench["p50_ms"],
        "p95_ms": f_bench["p95_ms"],
        "images_per_sec": f_bench["images_per_sec"], "max_err_m": f_errs,
        "profile": f_prof,
    }, "fused_train": dict(
        f_train_out, steps=len(ftr["logs"]), grad_copies=ftr["grad_copies"],
        last_logs=ftr["logs"][-1], eval=ftr["eval"],
        kernel_vs_plain_max_rel=ftr["kernel_vs_plain_rel"],
        kernel_vs_kernel_max_rel=ftr["kernel_vs_kernel_rel"]),
        "fused_loss": {k: v for k, v in floss.items() if k != "inputs"},
        "trainer_loop": loop,
        "device_feed": feed,
        "families": families,
        "serving_from_checkpoint": served,
        "data_parallel": dp,
        "spatial_parallel": spatial,
        "production": {"train": ptrain,
                       "capacity": prod["capacity"],
                       "probe": prod["probe"]},
        "pcl_modes": {"serve": modes, "train": mode_train,
                      "group_resize_serve": group_serve,
                      "gather_warp": {"levels": g_rows,
                                      "per_forward_ms": g_total["fwd_ms"],
                                      "per_step_ms": g_total["fwd_bwd_ms"]}},
        "card": card}
    kernels["kernels"].append({
        "name": "batch_norm",
        "route": "cuda",
        "source": "cadepth_tpu_torch/csrc/batch_norm.cu",
        "replaces": "none: flax's nn.BatchNorm, which XLA fuses",
        "launches_per_call": bn_launches,
        # calls that ran the kernels (each launches_per_call launches) on
        # the main paths, forward and backward
        "calls_per_training_step": tr["norm_calls_per_step"],
        "calls_in_training": bn_calls(tr["norm_counts"]),
        "calls_in_trainer_loop": bn_calls(loop["warp_counts"]),
        "calls_in_device_feed": bn_calls(feed_counts),
        "calls_in_families": {
            case: bn_calls(families[case]["train_counts"])
            for case, _ in FAMILY_CASES},
        "calls_in_data_parallel": bn_calls(dp["group_of_one"]["warp_counts"]),
        "calls_in_two_ranks": dp["two_ranks"]["rank_norm_launches"],
        "calls_in_spatial": bn_calls(sp_counts),
        "calls_from_checkpoint": {
            k: bn_calls(v["warp_counts"]) for k, v in served.items()
            if k.startswith(("best", "latest"))},
        "production": {"calls_in_training": bn_calls(ptrain["warp_counts"]),
                       "train_steps": ptrain["steps"],
                       "calls_in_probe": bn_calls(prod["probe"]
                                                  ["warp_counts"])},
        "levels": {config: {name: {k: r[k] for k in (
            "shape", "kernel_ms", "kernel_wall_ms", "plain_ms", "library_ms",
            "bound_ms", "err_vs_float64")}
            for name, r in found["levels"].items()}
            for config, found in norms.items()},
        "per_step": {config: found["step"]
                     for config, found in norms.items()},
        "library": "F.batch_norm(training=True), forward and backward",
        "at": "bf16 channels_last, the flagship at batch 32, the "
              "production network at 8"})
    log(json.dumps(kernels))
    log(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
