"""Native (C++) runtime components, loaded via ctypes.

Build on first import if the shared object is missing (g++ + zlib are part
of the base image); falls back to Python zlib transparently if the build
fails, so the pure-Python path always works.
"""

from .entropy import (deflate_parallel, inflate, native_available,
                      build_native)

__all__ = ["deflate_parallel", "inflate", "native_available", "build_native"]
