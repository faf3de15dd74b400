"""Pallas kernels (Triton route on the GPU) for the hot sparse ops."""
