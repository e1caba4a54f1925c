"""Seeded images: 1 to ``max_objects`` filled boxes of random colours on a
noisy, smoothly shaded background, rendered on the device in one pass per
image size, as uint8 (H, W, 3)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def render(gen: torch.Generator, n: int, h: int, w: int, max_objects: int = 6) -> torch.Tensor:
    """(n, h, w, 3) uint8 on ``gen``'s device."""
    dev = gen.device
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    coarse = rand(n, 3, max(h // 32, 2), max(w // 32, 2)) * 170.0 + 30.0
    img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    img = img + (rand(n, 3, h, w) - 0.5) * 40.0
    count = 1 + (rand(n) * max_objects).long()
    size = 0.08 + rand(n, max_objects, 2) * 0.6  # (w, h) as a share of the image
    corner = rand(n, max_objects, 2) * (1.0 - size)
    colour = rand(n, max_objects, 3, 1, 1) * 255.0
    ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    for k in range(max_objects):
        x0, y0 = corner[:, k, 0, None, None], corner[:, k, 1, None, None]
        x1, y1 = x0 + size[:, k, 0, None, None], y0 + size[:, k, 1, None, None]
        inside = ((xs[None, None, :] >= x0) & (xs[None, None, :] < x1)
                  & (ys[None, :, None] >= y0) & (ys[None, :, None] < y1)
                  & (count[:, None, None] > k))
        img = torch.where(inside[:, None], colour[:, k] + (img - 110.0) * 0.2, img)
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
