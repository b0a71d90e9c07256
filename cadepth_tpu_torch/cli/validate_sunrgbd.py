"""Dataset validation CLI (the twin of ``cli/validate_sunrgbd.py``):

    python -m cadepth_tpu_torch.cli.validate_sunrgbd [data_dir] [manifest]

Walks the SUN RGB-D tree (default ``./data/sunrgbd``), prints the
per-sensor summary and writes the manifest JSON (default
``./data/sunrgbd_manifest.json``) through ``data/manifest.py``.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    data_dir = argv[0] if len(argv) > 0 else "./data/sunrgbd"
    manifest_path = argv[1] if len(argv) > 1 else "./data/sunrgbd_manifest.json"

    from cadepth_tpu_torch.data.manifest import (
        SunRGBDValidator,
        print_summary,
        save_manifest,
    )

    print("=== SUN RGB-D Data Validation Tool ===")
    print(f"Data directory: {data_dir}")
    print(f"Manifest output: {manifest_path}")

    validator = SunRGBDValidator(data_dir)
    results = validator.validate_all_images()
    print_summary(results)
    save_manifest(results, manifest_path)
    print("\n=== Validation complete ===")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
