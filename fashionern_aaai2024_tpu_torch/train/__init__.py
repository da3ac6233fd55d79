"""The train path: schedule, state, step, checkpoints, Trainer (JAX counterpart: fashionern_aaai2024_tpu/train/)."""
