"""The ViT encoder's share of the training steps' card time: the port's
spans ``vit.encoder`` (patch tokens, the blocks, the tapped outputs'
LayerNorms) and ``vit.encoder.bwd`` (its backward, from the taps'
gradients down to the tokens') over its spans ``train.step``, summed
over the profiled stretch, in %. None without those spans (a network
with no ViT, or a port that records none)."""

from benchmark.metrics.lib.step_share import share_pct


def read(run):
    return share_pct(("vit.encoder", "vit.encoder.bwd"))
