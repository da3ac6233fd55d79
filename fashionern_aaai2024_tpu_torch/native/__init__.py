"""Host-side native code of the port (JAX counterpart: fashionern_aaai2024_tpu/native/)."""
