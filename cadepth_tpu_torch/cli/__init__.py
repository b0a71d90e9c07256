"""Command-line entry points, ``python -m cadepth_tpu_torch.cli.<name>``:
``train``, ``evaluate`` and ``infer``; the data tools ``validate_sunrgbd``,
``preprocess_rays`` and ``pack_dataset``; and ``compare_models``."""
