"""The port's multi-process data parallelism on the CPU
(parallel/multihost.py): the same process shards as the JAX package's, and
two real gloo ranks whose union is byte-identical to the single-process
stream of the port and of the JAX package (as tests/test_multihost.py
checks the JAX package's two jax.distributed processes)."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from aejpeg_tpu.codec.stream import decode_stream as j_decode_stream
from aejpeg_tpu.codec.stream import encode_stream as j_encode_stream
from aejpeg_tpu.config import CodecConfig as JConfig
from aejpeg_tpu.io.image import ImageData as JImage
from aejpeg_tpu.parallel.multihost import process_shard as j_process_shard
import aejpeg_tpu_torch as at
from aejpeg_tpu_torch.parallel.multihost import process_shard

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES = 5

_WORKER = r"""
import pickle, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from aejpeg_tpu_torch.parallel import multihost as mh
mh.initialize(%(coord)r, 2, %(pid)d)
assert dist.get_world_size() == 2 and dist.get_rank() == %(pid)d
from aejpeg_tpu_torch.config import CodecConfig
from aejpeg_tpu_torch.io.image import ImageData
yy, xx = np.mgrid[0:96, 0:64] / 16.0
images = []
for i in range(%(n)d):
    img = np.stack([0.5 + 0.4 * np.sin(yy * (1 + 0.1 * i) + c)
                    * np.cos(xx + c) for c in range(3)], axis=-1)
    images.append(ImageData.from_array(img.astype(np.float32),
                                       extension=".png"))
cfg = CodecConfig("YCoCg", (20, 80), (4, 32))
idxs, blobs = mh.encode_stream_sharded(images, cfg, batch_size=4,
                                       device="cpu")
# the test's own exchange of the shards; the library needs no collective
parts = [None, None]
dist.all_gather_object(parts, (idxs, blobs))
merged = dict(kv for p in parts for kv in zip(*p))
everything = [merged[i] for i in range(%(n)d)]
didxs, decoded = mh.decode_stream_sharded(everything, batch_size=4,
                                          device="cpu")
with open(%(out)r, "wb") as f:
    pickle.dump((dist.get_rank(), idxs, blobs, didxs,
                 [im.data for im in decoded]), f)
dist.destroy_process_group()
"""


def _images(cls):
    """tests/test_multihost.py's 5 images of 96x64."""
    yy, xx = np.mgrid[0:96, 0:64] / 16.0
    out = []
    for i in range(N_IMAGES):
        img = np.stack([0.5 + 0.4 * np.sin(yy * (1 + 0.1 * i) + c)
                        * np.cos(xx + c) for c in range(3)], axis=-1)
        out.append(cls.from_array(img.astype(np.float32), extension=".png"))
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17])
@pytest.mark.parametrize("num_processes", [1, 2, 3, 8])
def test_process_shard_matches_jax(n, num_processes):
    ours = [process_shard(n, num_processes, p) for p in range(num_processes)]
    theirs = [j_process_shard(n, num_processes, p)
              for p in range(num_processes)]
    assert ours == theirs
    assert [i for s in ours for i in range(s.start, s.stop)] == list(range(n))


def test_process_shard_outside_a_group():
    """Without a process group the process is rank 0 of 1."""
    assert process_shard(7) == slice(0, 7)


def test_two_gloo_ranks_match_single_process(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    procs, outs = [], []
    for pid in range(2):
        out = str(tmp_path / f"rank{pid}.pkl")
        outs.append(out)
        code = _WORKER % {"repo": REPO, "coord": coord, "pid": pid,
                          "out": out, "n": N_IMAGES}
        env = dict(os.environ, PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    try:
        for p in procs:
            try:
                _, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                pytest.fail("gloo rank hung")
            if p.returncode != 0:
                pytest.fail("rank failed:\n"
                            + err.decode(errors="replace")[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    merged, decoded, ranks, shards = {}, {}, [], []
    for out in outs:
        with open(out, "rb") as f:
            rank, idxs, blobs, didxs, dec = pickle.load(f)
        ranks.append(rank)
        merged.update(zip(idxs, blobs))
        decoded.update(zip(didxs, dec))
        shards.append(list(didxs))
    assert ranks == [0, 1]
    assert sorted(merged) == sorted(decoded) == list(range(N_IMAGES))

    union = [merged[i] for i in range(N_IMAGES)]
    cfg = at.CodecConfig("YCoCg", (20, 80), (4, 32))
    assert union == at.encode_stream(_images(at.ImageData), cfg,
                                     batch_size=4, device="cpu")
    assert union == j_encode_stream(_images(JImage),
                                    JConfig("YCoCg", (20, 80), (4, 32)),
                                    batch_size=4)

    ours = at.decode_stream(union, batch_size=4, device="cpu")
    theirs = j_decode_stream(union, batch_size=4)
    for i in range(N_IMAGES):
        np.testing.assert_allclose(decoded[i], ours[i].data, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(decoded[i], theirs[i].data, rtol=0,
                                   atol=1e-5)

    # a rank decodes its shard in batches of other sizes than the single
    # process's (3 and 2 images against 4 and 1), so its dots have other
    # rows and XLA's order differs (hence 1e-5 above); against both
    # packages' streams of the same shard, every bit is equal
    def bits(x):
        return np.ascontiguousarray(x, np.float32).view(np.uint32)
    for didxs in shards:
        shard = [union[i] for i in didxs]
        ours = at.decode_stream(shard, batch_size=4, device="cpu")
        theirs = j_decode_stream(shard, batch_size=4)
        for i, a, b in zip(didxs, ours, theirs):
            np.testing.assert_array_equal(bits(decoded[i]), bits(a.data))
            np.testing.assert_array_equal(bits(decoded[i]), bits(b.data))
