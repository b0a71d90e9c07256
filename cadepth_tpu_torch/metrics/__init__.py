"""Depth metrics of the eval step, and the statistics and tables that
compare evaluated models (port of ``cadepth_tpu.metrics``)."""
