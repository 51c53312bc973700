"""codec/tables.py and the port's host table builders against the JAX
package's own numpy tables, bit for bit.

Stage B's and stage D's (group, size) constants are read out of the JAX
package's compiled stage closures, passed through the port's `to_device`
and compared with the port's own `host_tables`."""

import inspect

import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec import dense as jdense
from aejpeg_tpu.codec.batch_decode import _stage_d_fn
from aejpeg_tpu.codec.batch_encode import _quant_tables_np, _stage_b_fn
from aejpeg_tpu.color import constants as jconst
from aejpeg_tpu.ops import canny as jcanny
from aejpeg_tpu.ops import dct as jdct
from aejpeg_tpu.ops import resize as jresize
from aejpeg_tpu_torch import CodecConfig
from aejpeg_tpu_torch.codec import dense, tables
from aejpeg_tpu_torch.color import constants
from aejpeg_tpu_torch.ops import canny, dct, resize

torch.set_num_threads(1)

CASES = [("YCoCg", (20, 80), (4, 128), (128, 192)),
         ("YCoCg", (20, 80), (4, 32), (37, 53)),
         ("YCbCr", (50, 50), (8, 8), (100, 120))]
IDS = ["ycocg-4-128", "ycocg-boundary", "ycbcr-uniform"]


def _equal(a: torch.Tensor, b: torch.Tensor):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def _closure_consts(jit_fn):
    return inspect.getclosurevars(jit_fn.__wrapped__).nonlocals["consts"]


@pytest.mark.parametrize("space,q,blocks,shape", CASES, ids=IDS)
def test_stage_b_tables_match_jax(space, q, blocks, shape):
    b = 2
    jfn, jspec = _stage_b_fn(JConfig(space, q, blocks), shape, b)
    jconsts = _closure_consts(jfn)
    cfg = CodecConfig(space, q, blocks)
    assert tables.spec_for(cfg, shape) == dense.batch_spec(
        cfg.layer_shapes(shape), *blocks)
    assert [g.sizes for g in tables.spec_for(cfg, shape).groups] == \
        [g.sizes for g in jspec.groups]
    ours = tables.to_device(tables.host_tables(cfg, shape, b), "cpu")
    theirs = {}
    for key, (hi, lo, zz, slow) in jconsts.items():
        t = {"hi": hi, "lo": lo, "zz": zz}
        if slow is not None:
            (t["pidx"], t["rows"], t["cols"], t["hi_rows"],
             t["lo_rows"]) = slow
        theirs[key] = t
    theirs = tables.to_device(theirs, "cpu")
    assert set(theirs) == set(ours)
    per_row = ("hi_rows", "lo_rows")
    for key, t in theirs.items():
        assert set(t) - set(per_row) <= set(ours[key])
        assert ("pidx" in t) == ("pidx" in ours[key])
        for name, arr in t.items():
            if name in per_row:
                # the slow blocks, plane-major, each take its plane's
                # layer's table (the group of dct.dct2_quantize)
                layers = ours[key][name[:2]]
                n_l = layers.shape[0]
                nb = arr.shape[0] // (b * n_l)
                rows = torch.arange(arr.shape[0]) // nb % n_l
                _equal(arr, layers[rows])
                continue
            _equal(arr, ours[key][name])


@pytest.mark.parametrize("space,q,blocks,shape", CASES, ids=IDS)
def test_stage_d_tables_match_jax(space, q, blocks, shape):
    jfn, _ = _stage_d_fn(JConfig(space, q, blocks), shape, 2)
    cfg = CodecConfig(space, q, blocks)
    ours = tables.to_device(tables.host_tables(cfg, shape), "cpu")
    for key, (q_g, inv) in _closure_consts(jfn).items():
        theirs = tables.to_device({key: {"q": q_g, "inv_zz": inv}},
                                  "cpu")[key]
        _equal(theirs["q"], ours[key]["q"])
        _equal(theirs["inv_zz"], ours[key]["inv_zz"])
        assert "pidx" not in ours[key]


@pytest.mark.parametrize("s", [4, 8, 16, 32, 64, 128])
def test_quant_and_dct_tables(s):
    for cfg_args in [("YCoCg", (20, 80), (4, 128)), ("OKLAB", (30, 70),
                                                     (8, 64))]:
        for mine, theirs in zip(
                tables.quant_tables_np(CodecConfig(*cfg_args), s),
                _quant_tables_np(JConfig(*cfg_args), s)):
            _equal(torch.as_tensor(mine), torch.as_tensor(theirs))
    _equal(torch.as_tensor(dct.dct_matrix(s)),
           torch.as_tensor(jdct.dct_matrix(s)))


@pytest.mark.parametrize("src,dst", [(768, 384), (53, 26), (64, 128),
                                     (8, 128)])
def test_resize_weight_tables(src, dst):
    _equal(torch.as_tensor(resize.linear_weights(src, dst)),
           torch.as_tensor(jresize.linear_weights(src, dst)))
    if dst <= src:
        _equal(torch.as_tensor(resize.area_weights(src, dst)),
               torch.as_tensor(jresize.area_weights(src, dst)))


@pytest.mark.parametrize("h,w", [(512, 768), (256, 384), (37, 53)])
def test_clahe_tables(h, w):
    th, tw = -(-h // 4), -(-w // 4)
    ours = canny._clahe_interp_vectors(h, w, th, tw, 4, 4)
    theirs = jcanny._clahe_interp_vectors(h, w, th, tw, 4, 4)
    for a, b in zip(ours, theirs):
        _equal(torch.as_tensor(a), torch.as_tensor(b.reshape(-1)))
    _equal(torch.as_tensor(canny._clahe_tile_weights(h, w, th, tw, 4, 4)),
           torch.as_tensor(jcanny._clahe_tile_weights(h, w, th, tw, 4, 4)))
    np.testing.assert_array_equal(canny._gaussian_kernel_u8(3),
                                  jcanny._gaussian_kernel_u8(3))


def test_color_constants_and_geometry():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(getattr(constants, n),
                                      getattr(jconst, n))
    for lh, lw, s in [(37, 53, 8), (100, 120, 32), (256, 384, 128)]:
        for a, b in zip(dense.boundary_positions(lh, lw, s),
                        jdense.boundary_positions(lh, lw, s)):
            np.testing.assert_array_equal(a, b)
