"""Meters and logging (JAX counterpart: fashionern_aaai2024_tpu/utils/)."""
