"""Image IO and the .ajpg container."""

from .image import ImageData
from .container import ContainerWriter, ContainerReader, LayerPayload

__all__ = ["ImageData", "ContainerWriter", "ContainerReader", "LayerPayload"]
