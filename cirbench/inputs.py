"""Inputs the drivers make from the seed, and the comparisons they share."""

from __future__ import annotations

import torch


def make_pool(config: dict, n: int, seed: int, device: torch.device):
    """(uint8 images [n, H, W, 3], fp32 patches [n, P, d]) in host memory,
    drawn on `device` from the seed."""
    side, d = config["vision"]["image_size"], config["vision"]["embed_dim"]
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    images = torch.randint(0, 256, (n, side, side, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    patches = torch.randn((n, config["patch_num"], d), generator=gen, device=device)
    return images.cpu(), patches.cpu()


def relative_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """‖got − want‖ / ‖want‖ of every row."""
    got, want = got.float().to(want.device), want.float()
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30))
