"""Offline tools of the port (JAX counterpart: fashionern_aaai2024_tpu/tools/)."""
