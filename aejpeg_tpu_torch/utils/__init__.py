"""Small math/structure helpers shared across the codec.

Reference parity notes cite fevzibabaoglu/adaptive-edge-aware-jpeg.
"""

from .mathutils import (largest_power_of_2, root_size_for,
                        block_sizes_in_range, quality_factor)

__all__ = ["largest_power_of_2", "root_size_for", "block_sizes_in_range",
           "quality_factor"]
