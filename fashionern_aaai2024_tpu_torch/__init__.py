"""PyTorch / CUDA port of fashionern_aaai2024_tpu for NVIDIA Hopper.

The JAX package `fashionern_aaai2024_tpu` is the reference this port is
held against; nothing here imports it, JAX or flax.
"""
