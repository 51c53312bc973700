"""Offline analysis harness: metric sweeps, comparison against standard
JPEG anchors, aggregation and plots, normalization-constant derivation,
quadtree visualization and the speed table (the reference's test/analysis
suite).  compare and analyze need pandas, imported by those modules only,
so the package imports where pandas is absent."""
