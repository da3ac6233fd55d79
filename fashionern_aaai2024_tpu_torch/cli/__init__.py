"""The port's command line (JAX counterpart: fashionern_aaai2024_tpu/cli/)."""
