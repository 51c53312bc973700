"""Quadtree visualization + stage timing report (reference AQuadTree parity:
test/analysis/quad_tree.py:31-103).

Saves, for a given image: the luminance/chroma layers, their edge maps, and
the quadtree partition overlays; prints per-stage timings (edge stack, plan
build)."""

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..codec import quadtree as qt
from ..config import CodecConfig
from ..io.image import ImageData
from ..ops.canny import canny
from ..parallel.batch import color_and_downsample


def _overlay(layer: np.ndarray, plan: qt.QuadPlan) -> np.ndarray:
    """Draw green 1px block borders over a grayscale layer."""
    img = np.stack([layer] * 3, axis=-1)
    img = np.clip(img, 0, 1)
    h, w = layer.shape
    for s, y, x in zip(plan.leaf_sizes, plan.leaf_y, plan.leaf_x):
        y2, x2 = min(y + s, h) - 1, min(x + s, w) - 1
        img[y:y2 + 1, x, 1] = 1.0
        img[y:y2 + 1, x, 0] = 0.0
        img[y, x:x2 + 1, 1] = 1.0
        img[y, x:x2 + 1, 0] = 0.0
    return img


def visualize(img_path: str, out_dir: str,
              config: Optional[CodecConfig] = None, device=None) -> dict:
    """device: None means CUDA (raises when CUDA is absent)."""
    cfg = config or CodecConfig()
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    img = ImageData.load(img_path)
    h, w = img.original_shape[:2]
    layers = color_and_downsample(torch.as_tensor(img.data, device=dev),
                                  cfg.color_space, cfg.layer_shapes((h, w)))

    timings = {}
    names = ["luminance", "chroma1", "chroma2"]
    for i, name in enumerate(names):
        layer = layers[i].cpu().numpy()
        t0 = time.perf_counter()
        edge = canny(layers[i][None])[0].cpu().numpy()
        timings[f"{name}_edge_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = qt.build_plan(edge, cfg.block_size_range[1],
                             cfg.block_size_range[0])
        timings[f"{name}_plan_s"] = time.perf_counter() - t0
        timings[f"{name}_leaves"] = len(plan.leaf_sizes)

        norm = np.clip((layer - layer.min())
                       / max(layer.max() - layer.min(), 1e-9), 0, 1)
        ImageData.from_array(np.stack([norm] * 3, -1)).save(
            os.path.join(out_dir, f"{name}.png"))
        ImageData.from_array(np.stack([edge] * 3, -1)).save(
            os.path.join(out_dir, f"{name}_edges.png"))
        ImageData.from_array(_overlay(norm, plan)).save(
            os.path.join(out_dir, f"{name}_quadtree.png"))

    for k, v in timings.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return timings
