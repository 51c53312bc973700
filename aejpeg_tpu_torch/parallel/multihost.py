"""Multi-process (multi-host) data parallelism for the batched codec.

Counterpart of the JAX package's parallel/multihost.py.  The codec carries
no cross-image state, so the multi-host story is pure data parallelism over
processes: every process runs the single-process pipeline (codec/stream.py)
on its contiguous shard of the image stream, on its own card.  No
collective is needed; the process group only tells each process its rank
and the world size.

Launch recipe (one process per host, or per card on one host):

    # rank 0                                   # rank 1
    from aejpeg_tpu_torch.parallel import multihost as mh
    mh.initialize("host0:29500", 2, 0)         # mh.initialize(..., 2, 1)
    idxs, blobs = mh.encode_stream_sharded(images, cfg, device="cuda:0")

With no arguments, `initialize` reads torch.distributed's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
"""

from typing import List, Optional, Sequence, Tuple

from ..config import CodecConfig
from ..io.image import ImageData


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kwargs) -> None:
    """Join the process group over gloo: `coordinator_address` is
    "host:port" of rank 0 (None: from the environment).  Call once per
    process."""
    import torch.distributed as dist
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def _group() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_shard(n_items: int, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> slice:
    """Contiguous, balanced shard of [0, n_items) for this process."""
    world, rank = _group()
    np_ = world if num_processes is None else num_processes
    pid = rank if process_id is None else process_id
    base, rem = divmod(n_items, np_)
    start = pid * base + min(pid, rem)
    return slice(start, start + base + (1 if pid < rem else 0))


def encode_stream_sharded(images: Sequence[ImageData], config: CodecConfig,
                          batch_size: int = 16,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, device=None
                          ) -> Tuple[List[int], List[bytes]]:
    """Encode THIS process's shard of a global image list on `device`
    (None: CUDA); returns (global indices, blobs).  Every process must pass
    the same `images` order; concatenating all processes' outputs by index
    reproduces the single-process `encode_stream` byte-for-byte."""
    from ..codec.stream import encode_stream
    sh = process_shard(len(images), num_processes, process_id)
    blobs = encode_stream(list(images[sh]), config, batch_size=batch_size,
                          device=device)
    return list(range(sh.start, sh.stop)), blobs


def decode_stream_sharded(blobs: Sequence[bytes], batch_size: int = 16,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, device=None
                          ) -> Tuple[List[int], List[ImageData]]:
    """Decode THIS process's shard of a global blob list on `device`."""
    from ..codec.stream import decode_stream
    sh = process_shard(len(blobs), num_processes, process_id)
    return list(range(sh.start, sh.stop)), decode_stream(
        list(blobs[sh]), batch_size=batch_size, device=device)
