"""The uniform-grid device encode step (the multi-GPU batch steps are not
ported yet)."""

from .batch import device_encode_uniform

__all__ = ["device_encode_uniform"]
