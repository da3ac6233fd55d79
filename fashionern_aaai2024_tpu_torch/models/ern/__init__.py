"""ERN fusion stack of the port (JAX counterpart: fashionern_aaai2024_tpu/models/ern/)."""
