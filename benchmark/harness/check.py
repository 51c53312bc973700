"""Whether what the timed path produced is correct: a comparison with the
plain reference (`benchmark/reference/`), which works everything out again
from the same seeded images.

What is judged, per sampled output:
  containers  parsed plainly (framing, 2-bit quadtree states, zlib stream
              of levels); a container that does not parse, or whose
              metadata is not the deployment's, is a failed output.  The
              reference's leaves and levels are held against it:
      leaf_mismatch   share of the layers' area not covered by leaves that
                      both hold (same origin, same size)
      level_mismatch  share of the levels of those common leaves that differ
  images      shape (H, W, 3) and finite, else a failed output; then
      decode_gap      largest |codec - reference| over every value, the
                      reference decoding in float64 the very container
                      the codec decoded
      pixel_gap       99th percentile of |codec - reference| over every
                      value, the reference decoding its own containers in
                      float64 (so it also holds the containers the codec
                      decoded, which its set-up made, to the reference's)
Each number has its limit in `limits/<workload>.json`; a number that a
cell's limits name and its outputs cannot give fails the check.
"""

import math
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..reference import codec as ref
from ..reference import container


def codec_settings(config: dict) -> dict:
    c = config["codec"]
    return {"color_space": c["color_space"],
            "quality_range": tuple(c["quality_range"]),
            "block_size_range": tuple(c["block_size_range"])}


def _area(ys, xs, s, h, w) -> np.ndarray:
    return (np.minimum(s, h - ys) * np.minimum(s, w - xs)).astype(np.int64)


class Tally:
    """Sums over the sampled outputs."""

    def __init__(self):
        self.area = self.area_off = 0
        self.levels = self.levels_off = 0
        self.gaps: List[np.ndarray] = []
        self.decode_gap = -1.0
        self.failed = 0
        self.judged = 0
        self.bytes = 0
        self.raw_bytes = 0
        self.leaves: Dict[int, int] = {}
        self.sq_err = 0.0
        self.values = 0

    def numbers(self) -> Dict[str, float]:
        out = {}
        if self.area:
            out["leaf_mismatch"] = self.area_off / self.area
        if self.levels:
            out["level_mismatch"] = self.levels_off / self.levels
        if self.gaps:
            out["pixel_gap"] = float(np.percentile(
                np.concatenate(self.gaps), 99))
            out["decode_gap"] = self.decode_gap
        return out

    def stats(self) -> dict:
        out = {"judged": self.judged, "failed": self.failed,
               "leaves_by_size": dict(sorted(self.leaves.items()))}
        if self.bytes:
            out["ratio"] = self.raw_bytes / self.bytes
        if self.values:
            mse = self.sq_err / self.values
            out["psnr_db"] = 10 * math.log10(1.0 / mse) if mse else math.inf
        return out


def compare_leaves(got: Sequence[dict], want: Sequence[dict], shapes,
                   tally: Tally) -> None:
    """Add one image's layers (each {s: (ys, xs, levels)}) to the tally."""
    for (h, w), g, r in zip(shapes, got, want):
        tally.area += h * w
        common = 0
        for s in set(g) & set(r):
            kg = g[s][0] * (1 << 20) + g[s][1]
            kr = r[s][0] * (1 << 20) + r[s][1]
            _, ig, ir = np.intersect1d(kg, kr, return_indices=True)
            common += int(_area(g[s][0][ig], g[s][1][ig], s, h, w).sum())
            a, b = g[s][2][ig], r[s][2][ir]
            tally.levels += a.size
            tally.levels_off += int((a != b).sum())
        tally.area_off += h * w - common


def add_pixels(img, want: torch.Tensor, own: torch.Tensor,
               original: torch.Tensor, tally: Tally) -> bool:
    """Hold one decoded image against the reference's decode of its own
    containers (`want`) and of the container the image was decoded from
    (`own`); False if it is no image of the right shape."""
    data = img if isinstance(img, np.ndarray) else getattr(img, "data",
                                                              None)
    h, w = want.shape[:2]
    if not isinstance(data, np.ndarray) or data.shape != (h, w, 3) \
            or not np.isfinite(data).all():
        return False
    got = torch.as_tensor(data, device=want.device).to(torch.float64)
    tally.gaps.append((got - want).abs().reshape(-1).cpu().numpy())
    tally.decode_gap = max(tally.decode_gap,
                           float((got - own).abs().max()))
    err = got - original
    tally.sq_err += float((err * err).sum())
    tally.values += err.numel()
    return True


def parsed_leaves(blob, config: dict):
    """A container -> its layers, or None when it does not parse or its
    metadata is not the deployment's."""
    c = config["codec"]
    img = config["images"]
    try:
        meta, layers, _ = container.parse(blob)
    except (ValueError, KeyError, TypeError, zlib.error):
        return None
    want = {"height": img["height"], "width": img["width"], "num_layers": 3,
            "color_space": c["color_space"],
            "quality_min": c["quality_range"][0],
            "quality_max": c["quality_range"][1],
            "block_size_min": c["block_size_range"][0],
            "block_size_max": c["block_size_range"][1]}
    if any(meta.get(k) != v for k, v in want.items()):
        return None
    return layers


def _count(blob, config, shape, tally: Tally, layers=None) -> None:
    """Add a container's bytes and leaves to the log's statistics."""
    layers = layers or parsed_leaves(blob, config) or []
    tally.bytes += len(blob)
    tally.raw_bytes += shape[0] * shape[1] * 3
    for lay in layers:
        for s, (ys, _, _) in lay.items():
            tally.leaves[s] = tally.leaves.get(s, 0) + len(ys)


def judge(produces, config: dict, u8: torch.Tensor, samples: dict,
          device, control: Optional[str] = None) -> Tally:
    """samples: {image index: output as the traffic's `judged` gives it}
    ("container", "image", "source": the container the image was decoded
    from).  produces: what the traffic's outputs carry.  u8: the
    deployment's (N, H, W, 3) uint8 images.  control="tf32" puts the
    reference, at TF32, in the codec's place: its containers replace the
    outputs' containers, and it decodes the containers the outputs' images
    came from (its own, or a sample's "source")."""
    cfg = codec_settings(config)
    shape = (config["images"]["height"], config["images"]["width"])
    shapes = ref.layer_shapes(cfg, shape)
    keys = sorted(samples)
    tally = Tally()
    imgs = u8[keys].to(device)
    want = ref.encode(imgs, cfg)
    made = (ref.encode(imgs, cfg, control)
            if control and "container" in produces else None)
    for j, k in enumerate(keys):
        out = samples[k]
        tally.judged += 1
        original = ref.unit(imgs[j]).to(torch.float64)
        layers = None
        if "container" in produces:
            if made is not None:
                layers = made[j]
            else:
                layers = parsed_leaves(out.get("container"), config)
                if layers is None:
                    tally.failed += 1
                    continue
                _count(out["container"], config, shape, tally, layers)
            compare_leaves(layers, want[j], shapes, tally)
        if "image" in produces:
            if made is not None:
                src = made[j]
            elif layers is not None and out.get("source") is \
                    out.get("container"):
                src = layers
            else:
                src = parsed_leaves(out.get("source"), config)
                if src is None:
                    tally.failed += 1
                    continue
                if layers is None and not control:
                    _count(out["source"], config, shape, tally, src)
            own = ref.decode(src, cfg, shape, device)
            got = (ref.decode(src, cfg, shape, device, control).cpu().numpy()
                   if control else out.get("image"))
            rec = ref.decode(want[j], cfg, shape, device)
            if not add_pixels(got, rec, own, original, tally):
                tally.failed += 1
        elif layers is not None and not control:
            rec = ref.decode(layers, cfg, shape, device)
            err = rec - original
            tally.sq_err += float((err * err).sum())
            tally.values += err.numel()
    return tally


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """Correct: no failed output, and every limited number present and
    within its limit."""
    if failed:
        return False
    return all(k in numbers and numbers[k] <= lim
               for k, lim in limits.items())


def timed_judge(*args, **kwargs):
    t0 = time.perf_counter()
    tally = judge(*args, **kwargs)
    return tally, time.perf_counter() - t0
