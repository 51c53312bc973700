"""Codec core: quadtree planning, dense batch geometry, constant tables,
batched encode/decode and the streams over them."""
