"""Depth metrics of the eval step (port of ``cadepth_tpu.metrics``)."""
