"""Gallery embedding, search and serving (JAX counterpart: fashionern_aaai2024_tpu/retrieval/)."""
