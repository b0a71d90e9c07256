"""The baseline U-Net (port of ``cadepth_tpu.models.baseline_unet``).

RGB (B, H, W, 3) -> depth (B, H, W, 1) in (0, max_depth) through
sigmoid * max_depth: a DoubleConv and three encoder blocks (f .. 8f), a
bottleneck at 16f and four decoder blocks with skip connections. It
takes no camera.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from cadepth_tpu_torch.models.layers import (Conv2d, DecoderBlock,
                                             DepthUNet, DoubleConv,
                                             EncoderBlock)


class BaselineUNet(DepthUNet):
    """``forward(rgb, intermediates=None)``: NHWC rgb in [0, 1] ->
    (B, H, W, 1) float32 depth in metres. ``intermediates`` is taken so
    every family has one call signature; nothing is written to it. Any H
    and W of at least 16 work (the decoder pads a pooled odd row or column
    back, ``layers.pad_to_match``); under spatial parallelism the input
    is a band of H / S rows, with the band rule of ``models/layers.py``."""

    def __init__(self, in_channels: int = 3, init_features: int = 64,
                 max_depth: float = 10.0, remat=False,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 decoder_upsample: str = "transpose"):
        super().__init__(dtype, max_depth, remat)
        f = init_features
        self.enc1 = DoubleConv(in_channels, f, dtype, norm)
        for i in (2, 3, 4):
            setattr(self, f"enc{i}",
                    EncoderBlock(f << (i - 2), f << (i - 1), dtype, norm))
        self.bottleneck = EncoderBlock(f * 8, f * 16, dtype, norm)
        for i in (4, 3, 2, 1):
            setattr(self, f"dec{i}", DecoderBlock(
                f << i, f << (i - 1), dtype, norm, decoder_upsample))
        self.out_conv = Conv2d(f, 1, 1, dtype=torch.float32)

    def forward(self, rgb: torch.Tensor,
                intermediates: Optional[Dict[str, List[torch.Tensor]]] = None
                ) -> torch.Tensor:
        banded = [self.space is not None]
        with self._on(banded[0]):
            skips = [self._block("enc1", self._nchw(rgb, self.dtype))]
        for i in (2, 3, 4):
            x, b = self._encode(f"enc{i}", skips[-1], banded[-1])
            skips.append(x)
            banded.append(b)
        x, b = self._encode("bottleneck", skips[-1], banded[-1])
        for i in (4, 3, 2, 1):
            x, b = self._decode(f"dec{i}", x, b, skips[i - 1], banded[i - 1])
        return self._depth(x)
