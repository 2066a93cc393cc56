"""The benchmark's plain reference: frozen copies of fairdiff_torch's models,
sampler and trainer arithmetic, with plain PyTorch operations in place of
the kernels. Imports nothing of fairdiff_torch, fairdiff or jax."""
