"""Build helper for the hand-written CUDA kernels in `fairdiff_torch/csrc`."""
