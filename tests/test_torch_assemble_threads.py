"""The native assembler's chunk threads, on the CPU: one image's three
layers are fewer tasks than the host has threads, so each task deflates
its 1 MiB chunks on the threads left idle.  The containers of encode_batch
and of the per-image Codec carry, layer by layer, the bytes that one
thread writes from the same dense tables (native/entropy.py
layer_payload), at entropy levels 9, 6 and -1."""

import ctypes
import os

import numpy as np
import pytest
import torch

import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.codec import batch_encode as be
from aejpeg_tpu_torch.codec.tables import spec_for
from aejpeg_tpu_torch.io.container import ContainerReader
from aejpeg_tpu_torch.native import entropy as ne

from test_torch_codec import _arrays

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(512, 768), (37, 53)],
                ids=["512x768", "37x53"])
def image(request):
    """One image and encode_batch's own plans and dense tables of it (the
    same at every entropy level)."""
    shape = request.param
    img = at.ImageData.from_array(_arrays(*shape, 1, seed=shape[1])[0],
                                  extension=".png")
    cfg = at.CodecConfig("YCoCg", (40, 80), (4, 64))
    spec = spec_for(cfg, shape)
    levels, flat = be._device_shard(be._host_batch([img]), cfg, shape, 1,
                                    torch.device("cpu"))
    plans = be._build_plans(cfg, cfg.layer_shapes(shape), levels,
                            be.level_band(cfg), 1)[0]
    return img, cfg, spec, plans, be.carve_tables(flat.numpy(), spec, 1)


def _one_thread_layers(spec, plans, tables, level, sparse16):
    """Each layer's payload from one thread's layer_payload call."""
    dense, slow = tables
    out = []
    for li, plan in enumerate(plans):
        gi, j = spec.layer_pos[li]
        g = spec.groups[gi]
        tbl, slw = (ctypes.c_void_p * 8)(), (ctypes.c_void_p * 8)()
        for si, s in enumerate(g.sizes):
            k = s.bit_length() - 1
            arr = dense[gi][si]
            tbl[k] = arr.ctypes.data + j * arr.shape[1] * arr.shape[2] * 2
            nb = g.n_boundary(s)
            if nb:
                slw[k] = slow[gi][si].ctypes.data + j * nb * s * s * 2
        out.append(ne.layer_payload(plan.leaf_sizes, plan.leaf_y,
                                    plan.leaf_x, plan.height, plan.width,
                                    g.pw, tbl, slw, level, threads=1,
                                    sparse16=sparse16))
    return out


@pytest.mark.parametrize("level", [9, 6, -1])
def test_chunk_threads_write_one_threads_bytes(image, level):
    img, cfg, spec, plans, tables = image
    assert (os.cpu_count() or 1) >= 2
    cfg = at.CodecConfig(cfg.color_space, cfg.quality_range,
                         cfg.block_size_range, entropy_level=level)
    for blob, sparse16 in ((at.encode_batch([img], cfg, device="cpu")[0],
                            True),
                           (at.Codec(cfg, device="cpu").compress(img),
                            False)):
        reader = ContainerReader(blob)
        got = [reader.read_layer_raw().compressed for _ in range(3)]
        assert got == _one_thread_layers(spec, plans, tables, level,
                                         sparse16)
    if img.original_shape[0] == 512:              # luma: two chunks
        assert (plans[0].leaf_sizes.astype(np.int64) ** 2).sum() * 4 \
            > 1 << 20
