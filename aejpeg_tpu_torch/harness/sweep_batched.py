"""Batched metric sweep: the production-pipeline version of the reference
sweep harness (reference: test/analysis/metrics_computation.py:297-334).

Counterpart of the JAX package's harness/sweep_batched.py.  It runs a
(color_space, quality_range, block_size_range) grid over an image set
through the batched device pipeline:

 - Images are grouped by shape and pushed to the device once (uint8).
 - Stage A (color convert, downsample, Canny, pooled has-edge pyramid) runs
   once per (shape, space) at the WIDEST level band (blocks 4..128); every
   combo's quadtree plans read bit-subranges of that one packed row.
 - Stage B is batch_encode's own, over the wide planes, with each combo's
   quantization tables and only the combo's block sizes (eager PyTorch
   compiles nothing, so nothing forces the JAX package's all-sizes pass).
 - Reconstruction is batch_decode's own stage D on the stage-B tables
   (each boundary cell's reflect-padded slow row scattered into its dense
   row, as the decoder's parse would), gated by the combo's leaf masks:
   the decoder's arithmetic without the container round trip.  PSNR, SSIM,
   MS-SSIM and LPIPS are computed batched on the device against the
   device-resident originals.
 - Compression ratios come from real container bytes: the tables come to
   the host in one copy and feed the batched C++ assembler, so the blobs
   are what `encode_batch` produces for the combo.

CSV schema matches the reference (metrics_computation.py:189-201):
image_name,color_space,min_quality,max_quality,min_block_size,
max_block_size,psnr,ssim,ms_ssim,lpips,compression_ratio — 4-decimal
strings, lpips '' unless LPIPS weights are supplied (metrics/lpips.py).
"""

import csv
import dataclasses
import functools
import math
import time
from itertools import product
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..codec import batch_decode as bd
from ..codec import batch_encode as be
from ..codec.dense import BatchSpec, boundary_positions
from ..codec.tables import device_tables, spec_for
from ..config import CodecConfig
from ..io.container import ContainerMetadata, ContainerWriter, LayerPayload
from ..io.image import ImageData, image_size
from ..metrics.quality import (ms_ssim_batch, psnr_batch, rgb_to_gray_u8,
                               ssim_batch)
from ..ops import kernels

WIDE_BLOCKS = (4, 128)   # widest reference block band; combos use subsets
WIDE_BAND = (3, 7)       # pooled-level ks for WIDE_BLOCKS


# ------------------------------------------------------------ device stages


@functools.lru_cache(maxsize=64)
def _boundary_cells(spec: BatchSpec, device: torch.device):
    """{(group, size): dense-table rows of the layer's boundary cells} for
    every size with partial blocks, in the slow table's rank order."""
    out = {}
    for gi, g in enumerate(spec.groups):
        lh, lw = g.shape
        for s in g.sizes:
            by, bx = boundary_positions(lh, lw, s)
            if len(by):
                rows = ((by.astype(np.int64) // s) * (g.pw // s)
                        + bx.astype(np.int64) // s)
                out[(gi, s)] = torch.as_tensor(rows, device=device)
    return out


def _combo_geometry(cfg: CodecConfig, shape: Tuple[int, int], b: int,
                    device: torch.device):
    """(spec, tables) of one combo over the WIDE planes: the wide groups
    (shapes and padding) carrying the combo's own block sizes, and the
    combo's own tables (none of them depends on the padding)."""
    wide = spec_for(CodecConfig(cfg.color_space, (50, 50), WIDE_BLOCKS),
                    shape)
    own = spec_for(cfg, shape)
    spec = BatchSpec(
        groups=tuple(dataclasses.replace(g, sizes=o.sizes)
                     for g, o in zip(wide.groups, own.groups)),
        layer_pos=wide.layer_pos)
    return spec, device_tables(cfg, shape, b, device)


def _split(flat, shapes):
    """A flat array or tensor -> [[view of shape shapes[gi][si]]]."""
    out, off = [], 0
    for per in shapes:
        row = []
        for shp in per:
            n = int(np.prod(shp))
            row.append(flat[off:off + n].reshape(shp))
            off += n
        out.append(row)
    return out


def _leaf_masks(plans, spec: BatchSpec, b: int, device: torch.device):
    """masks[gi][si] = (b * n_l, gh * gw) uint8: 1 where the combo's plan
    puts a leaf of size s at that grid cell; built in one host arena and
    moved to the device in one copy."""
    shapes = [[(b * g.n_l, (g.ph // s) * (g.pw // s)) for s in g.sizes]
              for g in spec.groups]
    arena = np.zeros(sum(int(np.prod(shp)) for per in shapes
                         for shp in per), np.uint8)
    views = _split(arena, shapes)
    for bi in range(b):
        for li, (gi, j) in enumerate(spec.layer_pos):
            g = spec.groups[gi]
            plan = plans[bi][li]
            sizes64 = plan.leaf_sizes.astype(np.int64)
            for si, s in enumerate(g.sizes):
                idx = sizes64 == s
                rows = ((plan.leaf_y[idx].astype(np.int64) // s)
                        * (g.pw // s) + plan.leaf_x[idx].astype(np.int64) // s)
                views[gi][si][bi * g.n_l + j, rows] = 1
    return _split(torch.from_numpy(arena).to(device), shapes)


def _reconstruct(cfg: CodecConfig, spec: BatchSpec, tables, dense, slow,
                 masks, shape: Tuple[int, int], b: int) -> torch.Tensor:
    """batch_decode's stage D on the stage-B tables: (B, H, W, 3) sRGB."""
    bcells = _boundary_cells(spec, dense[0][0].device)
    recon_tables = []
    for gi, g in enumerate(spec.groups):
        row = []
        for si, s in enumerate(g.sizes):
            tab = dense[gi][si]
            if slow[gi][si] is not None:
                # the decoder scatters a boundary leaf's row, which is the
                # reflect-padded slow block, not the zero-padded dense row
                rows = bcells[(gi, s)]
                tab = tab.index_copy(1, rows, slow[gi][si].reshape(
                    tab.shape[0], len(rows), s * s))
            row.append(tab)
        recon_tables.append(row)
    return bd._stage_d(recon_tables, masks, spec, tables, cfg, shape, b)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


# ------------------------------------------------------------- host helpers


def _assemble_blobs(cfg: CodecConfig, spec: BatchSpec, plans, flat_host,
                    extensions, shape) -> List[bytes]:
    """Real .ajpg containers from the pulled tables (batch_encode's C++
    batch assembly and container writer)."""
    b = len(plans)
    h, w = shape
    arena, arena_offs, out_sizes = be.assemble_native(
        cfg, spec, plans, [be.carve_tables(flat_host, spec, b)], b)
    mn, mx = cfg.block_size_range
    blobs = []
    for bi in range(b):
        writer = ContainerWriter(ContainerMetadata(
            height=h, width=w, num_layers=3, color_space=cfg.color_space,
            quality_min=cfg.quality_range[0],
            quality_max=cfg.quality_range[1],
            block_size_min=mn, block_size_max=mx,
            extension=extensions[bi]))
        for li in range(3):
            t = bi * 3 + li
            plan = plans[bi][li]
            sb, bl = plan.packed()
            off = int(arena_offs[t])
            writer.add_layer(LayerPayload(
                bl, plan.root_size, sb, coeffs=None,
                compressed=arena[off:off + int(out_sizes[t])].tobytes()))
        blobs.append(writer.tobytes())
    return blobs


# ---------------------------------------------------------------- the sweep


def default_quality_ranges(values=(10, 25, 50, 75, 90)):
    return [(a, b) for a in values for b in values if a <= b]


def default_block_ranges(values=(4, 8, 16, 32, 64, 128)):
    return [(a, b) for a in values for b in values if a <= b]


class BatchedMetricsSweep:
    """Full-grid sweep over an image database through the batched device
    pipeline.  Writes rows incrementally and resumes: a combo is redone
    for a shape group only when a row of one of its images is missing,
    and only the missing rows are written.

    device: None means CUDA (raises when CUDA is absent); pass "cpu" for
    the plain PyTorch path.  `timings`, when given, collects per-stage wall
    seconds (the device synchronized at each stage's end): 'load' (image
    files), 'push', 'stage_a <h>x<w> <space>', 'stage_b', 'plans',
    'stage_d' (leaf masks and reconstruction), 'psnr', 'ssim', 'ms_ssim',
    'lpips', 'pull', 'assemble'."""

    def __init__(self, img_files: Sequence, result_file,
                 color_spaces: Sequence[str] = ("YCbCr",),
                 quality_ranges: Optional[List[Tuple[int, int]]] = None,
                 block_size_ranges: Optional[List[Tuple[int, int]]] = None,
                 entropy_level: int = -1,
                 progress_every: int = 10,
                 with_lpips: bool = False,
                 lpips_weights: Optional[str] = None,
                 device=None,
                 timings: Optional[Dict[str, float]] = None):
        self.device = resolve_device(device)
        self.img_files = [Path(p) for p in img_files]
        self.result_file = Path(result_file)
        self.color_spaces = list(color_spaces)
        self.quality_ranges = quality_ranges or default_quality_ranges()
        self.block_size_ranges = (block_size_ranges
                                  or default_block_ranges())
        self.entropy_level = entropy_level
        self.progress_every = progress_every
        self.timings = timings
        self.errors: List[str] = []
        self.lpips_path: Optional[str] = None
        if with_lpips:
            from ..metrics.lpips import default_weights_path
            self.lpips_path = lpips_weights or default_weights_path()
            if self.lpips_path is None:
                print("[sweep] LPIPS requested but no weights found "
                      "(AEJPEG_LPIPS_WEIGHTS / metrics/lpips_alex.npz); "
                      "the lpips column will be EMPTY.  Export weights via "
                      "aejpeg_tpu_torch.metrics.lpips.convert_torch_checkpoint"
                      " on a machine with torchvision+lpips.", flush=True)
            else:
                print(f"[sweep] LPIPS enabled (weights: {self.lpips_path})",
                      flush=True)

    COLUMNS = ["image_name", "color_space", "min_quality", "max_quality",
               "min_block_size", "max_block_size", "psnr", "ssim",
               "ms_ssim", "lpips", "compression_ratio"]

    @staticmethod
    def _key(path, combo):
        space, qr, br = combo
        return (str(path), space, str(qr[0]), str(qr[1]), str(br[0]),
                str(br[1]))

    def _existing_keys(self):
        if not self.result_file.exists():
            return set()
        with open(self.result_file) as f:
            return {(row["image_name"], row["color_space"],
                     row["min_quality"], row["max_quality"],
                     row["min_block_size"], row["max_block_size"])
                    for row in csv.DictReader(f)}

    def _mark(self, name: str, t0: float) -> float:
        """Add the seconds since t0 to timings[name] (device synchronized
        first); returns the new start."""
        if self.timings is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + t1 - t0
        return t1

    def run(self):
        combos = list(product(self.color_spaces, self.quality_ranges,
                              self.block_size_ranges))
        existing = self._existing_keys()
        self.result_file.parent.mkdir(parents=True, exist_ok=True)
        fresh = not self.result_file.exists()
        out = open(self.result_file, "a", buffering=1)
        if fresh:
            out.write(",".join(self.COLUMNS) + "\n")

        groups: Dict[Tuple[int, int], List[Path]] = {}
        for p in self.img_files:
            groups.setdefault(image_size(str(p)), []).append(p)

        total = len(self.img_files) * len(combos)
        done = len(existing)
        t0 = time.perf_counter()
        for shape, paths in groups.items():
            self._run_shape_group(shape, paths, combos, existing, out,
                                  lambda n: self._progress(
                                      done + n, total, t0))
            done += len(paths) * len(combos)
        out.close()
        if self.errors:
            print(f"[sweep] {len(self.errors)} errors; first: "
                  f"{self.errors[0]}")
        return self.result_file

    def _progress(self, done, total, t0):
        if done % self.progress_every:
            return
        dt = time.perf_counter() - t0
        eta = dt / max(done, 1) * (total - done)
        print(f"[sweep] {done}/{total} ({dt:.0f}s, ETA {eta:.0f}s)",
              flush=True)

    def _run_shape_group(self, shape, paths, combos, existing, out,
                         progress):
        h, w = shape
        b = len(paths)
        space_combos = {sp: [c for c in combos if c[0] == sp]
                        for sp in self.color_spaces}
        if all(self._key(p, c) in existing for c in combos for p in paths):
            progress(b * len(combos))
            return
        t0 = time.perf_counter()
        imgs = [ImageData.load(str(p)) for p in paths]
        t0 = self._mark("load", t0)
        batch = torch.from_numpy(be._host_batch(imgs)).to(self.device)
        if batch.dtype == torch.uint8:
            orig_u8, orig = batch, kernels.u8_to_unit(batch)
        else:
            orig = batch
            orig_u8 = (orig * 255.0).to(torch.uint8)
        orig_feats = None
        t0 = self._mark("push", t0)

        n_done = 0
        for space in self.color_spaces:
            # resume fast path: every row of this (shape, space) present
            if all(self._key(p, c) in existing
                   for c in space_combos[space] for p in paths):
                n_done += b * len(space_combos[space])
                progress(n_done)
                continue
            t0 = time.perf_counter()
            cfg0 = CodecConfig(space, (50, 50), WIDE_BLOCKS)
            group_planes, packed_bits = be._stage_a(
                batch, space, WIDE_BAND, spec_for(cfg0, shape))
            levels_bits = packed_bits.cpu().numpy()
            t0 = self._mark(f"stage_a {h}x{w} {space}", t0)
            if self.lpips_path and orig_feats is None:
                from ..metrics.lpips import _load_model
                with torch.no_grad():
                    orig_feats = _load_model(
                        self.lpips_path, self.device).unit_features(
                            _nchw(orig))
                t0 = self._mark("lpips", t0)

            for combo in space_combos[space]:
                n_done += b
                missing = [bi for bi, p in enumerate(paths)
                           if self._key(p, combo) not in existing]
                if not missing:
                    continue
                try:
                    rows = self._run_combo(
                        combo, shape, paths, imgs, orig_u8, orig, orig_feats,
                        batch.shape[0], group_planes, levels_bits)
                    for bi in missing:
                        out.write(",".join(rows[bi]) + "\n")
                        existing.add(self._key(paths[bi], combo))
                except Exception as e:  # noqa: BLE001 - combo isolation
                    self.errors.append(
                        f"{shape} {combo[0]} {combo[1]} {combo[2]}: "
                        f"{type(e).__name__}: {e}")
                progress(n_done)

    def _run_combo(self, combo, shape, paths, imgs, orig_u8, orig,
                   orig_feats, b, group_planes, levels_bits):
        space, qr, br = combo
        cfg = CodecConfig(space, qr, br, entropy_level=self.entropy_level)
        layer_shapes = cfg.layer_shapes(shape)
        mn, mx = br
        band = (None if mn == mx
                else (int(math.log2(mn)) + 1, int(math.log2(mx))))
        spec, tables = _combo_geometry(cfg, shape, b, self.device)
        t0 = time.perf_counter()
        flat = be._stage_b(group_planes, spec, tables, b)
        t0 = self._mark("stage_b", t0)
        plans = be._build_plans(cfg, layer_shapes, levels_bits, band, b,
                                packed_band=WIDE_BAND)
        t0 = self._mark("plans", t0)

        dense, slow = be.carve_tables(flat, spec, b)
        masks = _leaf_masks(plans, spec, b, self.device)
        recon = _reconstruct(cfg, spec, tables, dense, slow, masks, shape, b)
        t0 = self._mark("stage_d", t0)
        # EvaluationMetrics' psnr, ssim and ms_ssim of every image.  The
        # reconstruction is clipped to [0, 1] by the sRGB conversion, so
        # truncating r * 255 to uint8 is the host's astype(uint8).
        psnr_v = psnr_batch(orig, recon)
        t0 = self._mark("psnr", t0)
        ssim_v = ssim_batch(
            rgb_to_gray_u8(orig_u8).to(torch.float32),
            rgb_to_gray_u8((recon * 255.0).to(torch.uint8)).to(torch.float32),
            255.0)
        t0 = self._mark("ssim", t0)
        ms_v = ms_ssim_batch(orig, recon, 1.0)
        t0 = self._mark("ms_ssim", t0)
        lpips_v = None
        if orig_feats is not None:
            from ..metrics.lpips import _load_model
            model = _load_model(self.lpips_path, self.device)
            with torch.no_grad():
                lpips_v = model.distances(
                    orig_feats, model.unit_features(_nchw(recon))).cpu()
            t0 = self._mark("lpips", t0)
        vals = torch.stack([psnr_v, ssim_v, ms_v]).cpu().numpy()

        flat_host = be.to_host(flat, "sweep_tables")
        t0 = self._mark("pull", t0)
        blobs = _assemble_blobs(cfg, spec, plans, flat_host,
                                [im.extension for im in imgs], shape)
        self._mark("assemble", t0)

        raw_bytes = shape[0] * shape[1] * 3
        rows = []
        for bi, p in enumerate(paths):
            lp = (f"{float(lpips_v[bi]):.4f}" if lpips_v is not None
                  else "")
            rows.append([
                str(p), space, str(qr[0]), str(qr[1]), str(br[0]),
                str(br[1]), f"{float(vals[0, bi]):.4f}",
                f"{float(vals[1, bi]):.4f}", f"{float(vals[2, bi]):.4f}", lp,
                f"{raw_bytes / len(blobs[bi]):.4f}"])
        return rows
