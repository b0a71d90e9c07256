"""The attention's share of its compute roofline in training: a step's
attention FLOPs (4 B h N^2 d forward and 8 B h N^2 d backward a layer,
no recomputation counted; ``lib/attention_flops.py``, from the
configuration's widths and size) at 989 TFLOP/s (bf16, dense), over the
card's time of the port's spans ``attn.fwd`` and ``attn.bwd`` in a
training step (median over the profiled stretch's steps), in %. It
counts the same work whatever implements the attention; None without
those spans or outside a configuration with a ViT's widths."""

from benchmark.metrics.lib import program_spans, roofline
from benchmark.metrics.lib.attention_flops import dav2_step_flops


def read(run):
    device_ms = program_spans.step_median_ms(("attn.fwd", "attn.bwd"))
    conf = getattr(run, "conf", None)
    if not device_ms or "embed_dim" not in (conf or {}).get("reference", {}):
        return None
    bound_s = dav2_step_flops(conf) / roofline.peak_flops(run.use_amp)
    return 100.0 * bound_s * 1e3 / device_ms
