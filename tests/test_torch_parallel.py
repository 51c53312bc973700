"""The port's data parallelism on the CPU (parallel/mesh.py, the sharded
batch steps, encode_batch / decode_batch with mesh=), held to its own
single-device path and to the JAX package's sharded path on its 8 virtual
CPU devices (tests/conftest.py), on the inputs of tests/test_sharding.py.
The port's mesh names the CPU eight times: one shard per entry."""

import cv2 as cv
import jax
import numpy as np
import pytest
import torch

from aejpeg_tpu import CodecConfig as JConfig
from aejpeg_tpu.codec.batch_decode import decode_batch as j_decode_batch
from aejpeg_tpu.codec.batch_encode import encode_batch as j_encode_batch
from aejpeg_tpu.io.image import ImageData as JImage
from aejpeg_tpu.parallel import mesh as jmesh
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.parallel import (make_mesh, sharded_dense_decode_fn,
                                       sharded_dense_device_fn)
from aejpeg_tpu_torch.parallel.mesh import Mesh, shard_devices

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def _pair(arrays, extension=".png"):
    """The same float32 images as port and JAX ImageData."""
    return ([at.ImageData.from_array(a, extension=extension) for a in arrays],
            [JImage.from_array(a, extension=extension) for a in arrays])


@pytest.fixture(scope="module")
def quadtree_images():
    """tests/test_sharding.py's 8 images of 100x120 (seed 3)."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(8):
        small = rng.random((10, 12, 3), np.float32)
        out.append(np.clip(cv.resize(small, (120, 100),
                                     interpolation=cv.INTER_CUBIC),
                           0, 1).astype(np.float32))
    return _pair(out)


QT_CFG = ("YCoCg", (20, 80), (4, 32))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_default_shape_matches_jax(n):
    ours = make_mesh(devices=["cpu"] * n)
    theirs = jmesh.make_mesh(devices=jax.devices()[:n])
    assert list(ours.shape.items()) == list(theirs.shape.items())
    assert ours.axis_names == tuple(theirs.axis_names)
    assert ours.size == n and ours.devices.shape == theirs.devices.shape
    assert all(d == torch.device("cpu") for d in ours.devices.ravel())


@pytest.mark.parametrize("shape", [(3, 2), (8, 2), (2, 2)])
def test_mesh_wrong_shape_raises(shape):
    with pytest.raises(ValueError):
        make_mesh(shape, devices=CPU8)
    with pytest.raises(ValueError):
        jmesh.make_mesh(shape)


def test_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((2, 1), devices=["cuda:0"] * 2)


def test_shard_devices_follow_the_data_axes():
    """Shards enumerate the data axes row-major in the order given, each at
    index 0 of the other axes (the first device of its group)."""
    labels = np.array([["a", "b"], ["c", "d"], ["e", "f"], ["g", "h"]],
                      dtype=object)
    mesh = Mesh(labels, ("data", "block"))
    assert shard_devices(mesh) == list("abcdefgh")
    assert shard_devices(mesh, ("data",)) == list("aceg")
    assert shard_devices(mesh, ("block",)) == list("ab")
    assert shard_devices(mesh, ("block", "data")) == list("acegbdfh")
    with pytest.raises(ValueError):
        shard_devices(mesh, ("model",))


def test_sharded_encode_byte_identical(quadtree_images):
    ours, theirs = quadtree_images
    single = at.encode_batch(ours, at.CodecConfig(*QT_CFG), device="cpu")
    sharded = at.encode_batch(ours, at.CodecConfig(*QT_CFG),
                              mesh=make_mesh((4, 2), devices=CPU8))
    jax_sharded = j_encode_batch(theirs, JConfig(*QT_CFG),
                                 mesh=jmesh.make_mesh((4, 2)))
    assert sharded == single
    assert sharded == jax_sharded


def test_uniform_grid_and_divisibility():
    """tests/test_sharding.py's uniform-grid case (seed 4, 64x64, YCbCr
    q50 8x8), and 3 images on 8 shards raise as in the JAX package."""
    rng = np.random.default_rng(4)
    ours, theirs = _pair([rng.random((64, 64, 3)).astype(np.float32)
                          for _ in range(8)], extension=None)
    cfg = at.CodecConfig("YCbCr", (50, 50), (8, 8))
    mesh = make_mesh((4, 2), devices=CPU8)
    sharded = at.encode_batch(ours, cfg, mesh=mesh)
    assert sharded == at.encode_batch(ours, cfg, device="cpu")
    assert sharded == j_encode_batch(theirs, JConfig("YCbCr", (50, 50),
                                                     (8, 8)),
                                     mesh=jmesh.make_mesh((4, 2)))
    with pytest.raises(ValueError, match="not divisible by 8"):
        at.encode_batch(ours[:3], cfg, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by 8"):
        sharded_dense_device_fn(cfg, (64, 64), 3, mesh)
    with pytest.raises(ValueError, match="not divisible by 8"):
        sharded_dense_decode_fn(cfg, (64, 64), 3, mesh)


def test_mesh_and_device_are_exclusive(quadtree_images):
    ours, _ = quadtree_images
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        at.encode_batch(ours[:2], at.CodecConfig(*QT_CFG), device="cpu",
                        mesh=mesh)


def test_sharded_decode(quadtree_images):
    """Exactly the port's single-device decode; within 3e-6 of the JAX
    package's sharded decode (its own bound, tests/test_sharding.py)."""
    ours, _ = quadtree_images
    blobs = at.encode_batch(ours, at.CodecConfig(*QT_CFG), device="cpu")
    mesh = make_mesh((4, 2), devices=CPU8)
    single = at.decode_batch(blobs, device="cpu")
    sharded = at.decode_batch(blobs, mesh=mesh)
    theirs = j_decode_batch(blobs, mesh=jmesh.make_mesh((4, 2)))
    assert len(sharded) == len(single) == len(theirs) == 8
    for a, b, c in zip(sharded, single, theirs):
        assert a.extension == b.extension == ".png"
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_allclose(a.data, c.data, rtol=0, atol=3e-6)
    with pytest.raises(ValueError, match="not divisible by 8"):
        at.decode_batch(blobs[:3], mesh=mesh)


def test_subset_of_axes_splits_over_data_only(quadtree_images):
    ours, _ = quadtree_images
    cfg = at.CodecConfig(*QT_CFG)
    mesh = make_mesh((4, 2), devices=CPU8)
    fn = sharded_dense_device_fn(cfg, (100, 120), 8, mesh, ("data",))
    from aejpeg_tpu_torch.codec.batch_encode import _host_batch
    levels, flats = fn(_host_batch(ours))
    assert len(levels) == len(flats) == 4
    assert all(lv.shape[0] == 2 for lv in levels)
    single = at.encode_batch(ours, cfg, device="cpu")
    assert at.encode_batch(ours, cfg, mesh=mesh,
                           data_axes=("data",)) == single
    blobs = single
    dfn, devs = sharded_dense_decode_fn(cfg, (100, 120), 8, mesh, ("data",))
    assert len(devs) == 4
    a = at.decode_batch(blobs, mesh=mesh, data_axes=("data",))
    b = at.decode_batch(blobs, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data, y.data)


def test_materialize_false(quadtree_images):
    ours, _ = quadtree_images
    blobs = at.encode_batch(ours, at.CodecConfig(*QT_CFG), device="cpu")
    images = at.decode_batch(blobs, device="cpu")
    out, metas = at.decode_batch(blobs, device="cpu", materialize=False)
    assert isinstance(out, torch.Tensor) and out.shape == (8, 100, 120, 3)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  np.stack([im.data for im in images]))
    assert [m.extension for m in metas] == [".png"] * 8
    assert (metas[0].height, metas[0].width) == (100, 120)
    mesh_out, _ = at.decode_batch(blobs, mesh=make_mesh((4, 2), devices=CPU8),
                                  materialize=False)
    assert torch.equal(mesh_out, out)
    jout, jmetas = j_decode_batch(blobs, materialize=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert [m.extension for m in jmetas] == [m.extension for m in metas]
