"""Data parallelism over cards and processes: meshes, the sharded batch
steps, the uniform-grid device step (multihost.py: one process per host)."""

from .mesh import make_mesh
from .batch import (device_encode_uniform, sharded_dense_device_fn,
                    sharded_dense_decode_fn)

__all__ = ["make_mesh", "device_encode_uniform",
           "sharded_dense_device_fn", "sharded_dense_decode_fn"]
