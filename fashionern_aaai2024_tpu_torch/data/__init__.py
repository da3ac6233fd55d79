"""Host-side data pieces of the train path (JAX counterpart: fashionern_aaai2024_tpu/data/)."""
