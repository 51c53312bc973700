"""A plain reference of the codec: PyTorch and NumPy only, nothing of the
codec under test."""
