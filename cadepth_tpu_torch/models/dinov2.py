"""DINOv2's vision transformer, the encoder of Depth Anything V2 (no JAX
counterpart: the JAX package has no transformer).

Written from DINOv2 (arXiv:2304.07193) as Depth Anything V2's
``metric_depth/depth_anything_v2/dinov2.py`` builds it for ``vitl``:
patch size 14, width 1024, 24 blocks of 16 heads of 64, MLP 4096, no
register tokens. The module and parameter names are upstream's
(``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.N.norm1``, ``blocks.N.attn.qkv``, ``blocks.N.attn.proj``,
``blocks.N.ls1.gamma``, ``blocks.N.mlp.fc1``, ``norm``), so an upstream
checkpoint maps onto them by its prefix ``pretrained.``; upstream also
holds ``mask_token``, used only in masked pre-training, which a
converter drops.

A block is ``x = x + ls1 * attn(LN1(x))``, then ``x = x + ls2 *
mlp(LN2(x))``, LayerNorm epsilon 1e-6, exact GELU. The learned position
table holds a 37 x 37 patch grid (518 / 14) and one cls entry; for an
input of h x w patches other than 37 x 37 its patch entries are
resampled in float32 by a bicubic resize with scale factors ((h + 0.1) /
37, (w + 0.1) / 37), no antialiasing, as upstream's
``interpolate_pos_encoding`` does (at 37 x 37 the table is used as it
is, as there).

Precision: the matrix products (patch embedding, qkv, projections, MLP)
and the attention compute in ``dtype`` (bf16 on the card) over float32
parameters; the residual stream, the LayerNorms' statistics and the
LayerScales are float32. Attention is
``torch.nn.functional.scaled_dot_product_attention`` on q, k and v in
``dtype``, whose kernels keep the softmax in float32.

SDPA backend on the H100 (torch 2.11, CUDA 12.8; bf16, head size 64, no
mask, no dropout): cuDNN's fused flash attention
(``cudnn_generated_fort_native_sdpa_sm90_flash_fprop`` and ``_bprop``
kernels), which PyTorch's dispatcher tries ahead of FlashAttention-2, the
memory-efficient kernel and the math backend for these inputs on sm90
(``chip_smoke.py`` phase 28 names the kernels that ran). It keeps the
scores in on-chip memory and the softmax in float32, and stores only
the output and the softmax's log-sum-exp for the backward.

While a profiler records (``utils/profiling.py``), the encoder's forward
is span ``vit.encoder`` and its backward ``vit.encoder.bwd``; inside
them each block's SDPA call is span ``attn.fwd`` (attributes ``tokens``
and ``heads``) and its backward ``attn.bwd``, all with the card's time.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.layers import Linear
from cadepth_tpu_torch.utils.profiling import backward_span, span

PATCH = 14
# the learned position table's patch grid (upstream's img_size 518 / 14)
TABLE_GRID = 37
LN_EPS = 1e-6
# upstream's interpolate_offset
POS_OFFSET = 0.1


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in float32, epsilon 1e-6; float32 out."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class LayerScale(nn.Module):
    """Per-channel scale ``gamma`` (float32; the product is float32)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class PatchEmbed(nn.Module):
    """``proj``: Conv2d(3, dim, 14, stride 14) in ``dtype``; NCHW in,
    (B, h * w, dim) tokens out."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=PATCH)
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention: ``qkv`` Linear(dim, 3 dim), softmax(q
    k^T / sqrt(d)) v per head, ``proj`` Linear(dim, dim)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        with span("attn.fwd", device=x.device, tokens=n, heads=h) as fwd:
            qkv, mark = backward_span("attn.bwd", qkv, fwd)
            q, k, v = qkv.view(b, n, 3, h, c // h).permute(2, 0, 3, 1,
                                                           4).unbind(0)
            out = mark(F.scaled_dot_product_attention(q, k, v))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    """fc1 (dim -> 4 dim), exact GELU, fc2 (4 dim -> dim)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A pre-norm transformer block with LayerScale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim, dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):
    """The ViT: patch embedding, cls token, interpolated position table,
    ``depth`` blocks and the final LayerNorm ``norm``.

    :meth:`get_intermediate_layers` takes an NCHW image (H and W
    multiples of 14) and returns the patch tokens (B, h * w, dim) after
    each block of ``taps`` (0-based), each through ``norm``, the cls token
    dropped: float32."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, TABLE_GRID * TABLE_GRID + 1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio,
                                           dtype) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim)

    def interpolate_pos_encoding(self, h: int, w: int) -> torch.Tensor:
        """The position table (1, 1 + h * w, dim) of an h x w patch grid,
        float32."""
        table = self.pos_embed.float()
        if (h, w) == (TABLE_GRID, TABLE_GRID):
            return table
        grid = table[:, 1:].reshape(1, TABLE_GRID, TABLE_GRID, -1)
        patch = F.interpolate(
            grid.permute(0, 3, 1, 2),
            scale_factor=((h + POS_OFFSET) / TABLE_GRID,
                          (w + POS_OFFSET) / TABLE_GRID),
            mode="bicubic", antialias=False)
        if patch.shape[-2:] != (h, w):
            raise ValueError(f"the position table resized to "
                             f"{tuple(patch.shape[-2:])}, not ({h}, {w})")
        patch = patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)
        return torch.cat([table[:, :1], patch], dim=1)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[cls; patch embeddings] plus the position table, float32."""
        h, w = x.shape[2] // PATCH, x.shape[3] // PATCH
        patches = self.patch_embed(x).float()
        cls = self.cls_token.expand(patches.shape[0], -1, -1)
        return torch.cat([cls, patches], dim=1) + \
            self.interpolate_pos_encoding(h, w)

    def get_intermediate_layers(self, x: torch.Tensor,
                                taps: Sequence[int]) -> List[torch.Tensor]:
        """While a profiler records: span ``vit.encoder``, its backward
        ``vit.encoder.bwd`` (from the outputs' gradients down to the
        tokens', the patch embedding's weight gradient outside)."""
        with span("vit.encoder", device=x.device) as enc:
            t = self.tokens(x)
            t, mark = backward_span("vit.encoder.bwd", t, enc)
            out = []
            for i, block in enumerate(self.blocks):
                t = block(t)
                if i in taps:
                    out.append(self.norm(t)[:, 1:])
            return mark(out)
