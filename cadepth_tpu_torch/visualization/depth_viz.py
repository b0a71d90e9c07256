"""Depth visualization: colormaps, comparison strips, error maps, grids.

A copy of ``cadepth_tpu.visualization.depth_viz``, which imports no JAX:
the port keeps its own so that it never imports the JAX package. Only
the package name changes.

Covers both reference visualizers (`src/visualization/depth_viz.h` —
trainer-side [RGB | GT | Pred | Error] strips with per-image min/max
normalization — and `src/visualization/depth_visualizer.h` — eval-side
9-colormap rendering, error maps, histograms, batch grids). Host-side
numpy/cv2; everything returns RGB uint8 arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# 9 colormaps, parity with the eval-side enum (`depth_visualizer.h:15-25`).
COLORMAPS = ("viridis", "jet", "hot", "plasma", "inferno", "magma",
             "turbo", "rainbow", "bone")


def _cv2_colormap(name: str):
    import cv2

    table = {
        "viridis": cv2.COLORMAP_VIRIDIS,
        "jet": cv2.COLORMAP_JET,
        "hot": cv2.COLORMAP_HOT,
        "plasma": cv2.COLORMAP_PLASMA,
        "inferno": cv2.COLORMAP_INFERNO,
        "magma": cv2.COLORMAP_MAGMA,
        "turbo": cv2.COLORMAP_TURBO,
        "rainbow": cv2.COLORMAP_RAINBOW,
        "bone": cv2.COLORMAP_BONE,
    }
    if name not in table:
        raise ValueError(f"Unknown colormap '{name}'; choose from {COLORMAPS}")
    return table[name]


def apply_colormap(depth: np.ndarray, colormap: str = "viridis",
                   min_depth: Optional[float] = None,
                   max_depth: Optional[float] = None) -> np.ndarray:
    """(H, W[,1]) depth -> (H, W, 3) RGB uint8.

    Per-image min/max normalization by default (`depth_viz.h:88-107`), or
    fixed range scaling (`depth_visualizer.h:53-87`).
    """
    import cv2

    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    lo = float(np.min(d)) if min_depth is None else min_depth
    hi = float(np.max(d)) if max_depth is None else max_depth
    scale = hi - lo if hi > lo else 1.0
    norm = np.clip((d - lo) / scale, 0.0, 1.0)
    u8 = (norm * 255.0).astype(np.uint8)
    bgr = cv2.applyColorMap(u8, _cv2_colormap(colormap))
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def create_error_map(pred: np.ndarray, gt: np.ndarray,
                     max_error: float = 2.0,
                     colormap: str = "hot") -> np.ndarray:
    """|pred - gt| / max_error under a hot colormap (`depth_visualizer.h:97-121`)."""
    p = np.asarray(pred, np.float32)
    g = np.asarray(gt, np.float32)
    if p.ndim == 3:
        p = p[..., 0]
    if g.ndim == 3:
        g = g[..., 0]
    err = np.abs(p - g)
    return apply_colormap(err, colormap, min_depth=0.0, max_depth=max_error)


def _to_rgb_u8(rgb: np.ndarray) -> np.ndarray:
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    return arr


def create_comparison(rgb: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                      colormap: str = "viridis",
                      max_error: float = 2.0) -> np.ndarray:
    """[RGB | GT | Pred | Error] horizontal strip (`depth_viz.h:23-56`)."""
    panels = [
        _to_rgb_u8(rgb),
        apply_colormap(gt, colormap),
        apply_colormap(pred, colormap),
        create_error_map(pred, gt, max_error=max_error),
    ]
    h = min(p.shape[0] for p in panels)
    panels = [p[:h] for p in panels]
    return np.concatenate(panels, axis=1)


def create_depth_histogram(depth: np.ndarray, bins: int = 50,
                           width: int = 400, height: int = 200,
                           max_depth: float = 10.0) -> np.ndarray:
    """Depth distribution bar plot (`depth_visualizer.h:177-...`)."""
    d = np.asarray(depth, np.float32).reshape(-1)
    d = d[(d > 0) & (d <= max_depth)]
    img = np.full((height, width, 3), 255, np.uint8)
    if d.size == 0:
        return img
    counts, _ = np.histogram(d, bins=bins, range=(0, max_depth))
    peak = counts.max() if counts.max() > 0 else 1
    bar_w = max(width // bins, 1)
    for i, c in enumerate(counts):
        bar_h = int((c / peak) * (height - 10))
        if bar_h > 0:
            img[height - bar_h:, i * bar_w:(i + 1) * bar_w] = (70, 130, 180)
    return img


def add_label(img: np.ndarray, label: str) -> np.ndarray:
    """Stamp a white-on-black outlined label (`depth_visualizer.h:324-331`)."""
    import cv2

    out = np.ascontiguousarray(img)
    cv2.putText(out, label, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (255, 255, 255), 2)
    cv2.putText(out, label, (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 0, 0), 1)
    return out


def create_labeled_comparison(rgb: np.ndarray, gt: np.ndarray,
                              pred: np.ndarray,
                              min_depth: float = 0.1,
                              max_depth: float = 10.0,
                              colormap: str = "viridis") -> np.ndarray:
    """Eval-side labeled 4-panel strip (`depth_visualizer.h:133-166`):
    fixed-range colormaps, error map capped at 1 m, per-panel text labels."""
    panels = [
        add_label(_to_rgb_u8(rgb), "Input RGB"),
        add_label(apply_colormap(gt, colormap, min_depth, max_depth),
                  "Ground Truth"),
        add_label(apply_colormap(pred, colormap, min_depth, max_depth),
                  "Prediction"),
        add_label(create_error_map(pred, gt, max_error=1.0), "Error Map"),
    ]
    h = min(p.shape[0] for p in panels)
    return np.concatenate([p[:h] for p in panels], axis=1)


def create_histogram(depth: np.ndarray, min_depth: float = 0.1,
                     max_depth: float = 10.0,
                     num_bins: int = 50) -> np.ndarray:
    """Eval-side 512x300 depth histogram with axis line, title, and range
    labels (`depth_visualizer.h:177-250`)."""
    import cv2

    width, height = 512, 300
    img = np.full((height, width, 3), 255, np.uint8)
    d = np.asarray(depth, np.float32).reshape(-1)
    d = d[(d >= min_depth) & (d <= max_depth)]
    if d.size:
        counts, _ = np.histogram(d, bins=num_bins, range=(min_depth, max_depth))
        peak = max(int(counts.max()), 1)
        bar_w = width // num_bins
        for i, c in enumerate(counts):
            bar_h = int(c / peak * (height - 50))
            pt1 = (i * bar_w, height - 30 - bar_h)
            pt2 = ((i + 1) * bar_w - 1, height - 30)
            cv2.rectangle(img, pt1, pt2, (180, 130, 70), -1)
            cv2.rectangle(img, pt1, pt2, (0, 0, 0), 1)
        cv2.line(img, (0, height - 30), (width, height - 30), (0, 0, 0), 2)
        cv2.putText(img, "Depth Distribution", (10, 25),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 2)
        cv2.putText(img, f"{min_depth:g}m", (5, height - 5),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1)
        cv2.putText(img, f"{max_depth:g}m", (width - 50, height - 5),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1)
    return img


def create_metrics_panel(metrics: dict, width: int,
                         height: int = 200) -> np.ndarray:
    """Grey text panel listing the key metrics (`depth_visualizer.h:336-374`)."""
    import cv2

    panel = np.full((height, width, 3), 240, np.uint8)
    y = 40
    line_height = 25
    cv2.putText(panel, "Metrics:", (20, y), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (0, 0, 0), 2)
    y += line_height + 10
    display = [("abs_rel", "AbsRel"), ("rmse", "RMSE"),
               ("rmse_log", "RMSElog"), ("delta_1.25", "delta < 1.25")]
    for key, label in display:
        if key in metrics:
            text = f"{label}: {metrics[key]:.4f}"
            if "delta" in key:
                text += f" ({metrics[key] * 100:.2f}%)"
            cv2.putText(panel, text, (40, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        (0, 0, 0), 1)
            y += line_height
    return panel


def create_comprehensive_visualization(
    rgb: np.ndarray, gt: np.ndarray, pred: np.ndarray, metrics: dict,
    min_depth: float = 0.1, max_depth: float = 10.0,
    colormap: str = "viridis",
) -> np.ndarray:
    """Full per-sample report image (`depth_visualizer.h:259-290`):
    labeled comparison strip on top, [pred histogram | gt histogram]
    resized to its width, and a metrics text panel at the bottom."""
    import cv2

    comparison = create_labeled_comparison(rgb, gt, pred, min_depth,
                                           max_depth, colormap)
    hists = np.concatenate([create_histogram(pred, min_depth, max_depth),
                            create_histogram(gt, min_depth, max_depth)],
                           axis=1)
    hists = cv2.resize(hists, (comparison.shape[1], hists.shape[0]))
    panel = create_metrics_panel(metrics, comparison.shape[1], 200)
    return np.concatenate([comparison, hists, panel], axis=0)


def create_comparison_grid(rgbs: Sequence[np.ndarray],
                           gts: Sequence[np.ndarray],
                           preds: Sequence[np.ndarray],
                           colormap: str = "viridis") -> np.ndarray:
    """Stack per-sample comparison strips vertically
    (`depth_visualizer.h:382-455`, `BatchVisualizer::createComparisonGrid`)."""
    rows = [create_comparison(r, g, p, colormap)
            for r, g, p in zip(rgbs, gts, preds)]
    w = min(r.shape[1] for r in rows)
    return np.concatenate([r[:, :w] for r in rows], axis=0)


def save_depth_image(path: str, depth: np.ndarray,
                     colormap: str = "viridis",
                     min_depth: Optional[float] = None,
                     max_depth: Optional[float] = None) -> None:
    """Write a colormapped depth PNG (`depth_viz.h:61-82`)."""
    import cv2

    rgb = apply_colormap(depth, colormap, min_depth, max_depth)
    cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
