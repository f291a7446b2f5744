"""Device ops: binarizer trial grid and its CUDA kernel, deinterleave + ECC,
the seam sweep and the steady round."""
