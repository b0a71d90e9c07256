"""The FLOPs of a transformer's attention, counted from its shapes: per
layer 4 B h N^2 d forward (q k^T and the probabilities times v, 2 B h
N^2 d each) and 8 B h N^2 d backward (the gradients of q, k, the
probabilities and v), with no recomputation counted, so that the count
is the same whatever implements the attention (a fused kernel that
recomputes the scores in its backward does more work than counted)."""

from __future__ import annotations


def attention_flops(batch: int, tokens: int, heads: int, head_dim: int,
                    layers: int, train: bool = True) -> float:
    """FLOPs of ``layers`` attentions of ``heads`` heads of ``head_dim``
    over ``tokens`` tokens, a batch of ``batch``; ``train`` adds the
    backward."""
    forward = 4.0 * batch * heads * tokens * tokens * head_dim
    return layers * forward * (3.0 if train else 1.0)


def dav2_step_flops(conf: dict) -> float:
    """A training step's attention FLOPs in a Depth Anything V2
    configuration file (its ``config`` and its ``reference`` widths)."""
    c, ref = conf["config"], conf["reference"]
    patch = int(ref["patch_size"])
    tokens = 1 + (c["data"]["input_height"] // patch) * \
        (c["data"]["input_width"] // patch)
    heads = int(ref["num_heads"])
    return attention_flops(int(c["training"]["batch_size"]), tokens, heads,
                           int(ref["embed_dim"]) // heads, int(ref["depth"]))
