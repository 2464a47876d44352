"""Hand-written Pallas kernels (Triton route, for the GPU)."""
