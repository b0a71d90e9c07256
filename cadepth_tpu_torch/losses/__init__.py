"""The depth losses of the train step (port of ``cadepth_tpu.losses``)."""
