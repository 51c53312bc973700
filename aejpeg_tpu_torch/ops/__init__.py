"""Device ops: DCT, quantization, zigzag, resize, the Canny stack and the
hand-written CUDA kernels."""
