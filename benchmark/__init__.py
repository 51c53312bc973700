"""The benchmark of aejpeg_tpu_torch (see README.md)."""
