"""Lanczos3 resize of [B, h, w] plane batches (plain PyTorch).

Counterpart of the JAX package's output resize: `jax.image.resize(...,
method="lanczos3")` in models/filter_graph._apply_resize, whose weights
amatsukaze_tpu/ops/resize.py mirrors in numpy. The weights here are that
copy (the same sample grid, kernel support, normalisation and edge
zeroing, in float32); the resize is two products, over H and then over W,
which agree with jax.image.resize to float rounding (another order of the
sums). Not a Pallas kernel in the JAX package, so not a hand-written
kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

_RADIUS = 3.0
_weight_cache: dict[tuple[int, int], np.ndarray] = {}


def _lanczos3_kernel(x: np.ndarray) -> np.ndarray:
    y = _RADIUS * np.sin(np.pi * x) * np.sin(np.pi * x / _RADIUS)
    denom = np.where(x != 0, (np.pi ** 2 * x ** 2).astype(np.float32), 1)
    out = np.where(x > 1e-3, y / denom, np.float32(1.0))
    return np.where(x > _RADIUS, np.float32(0.0), out)


def lanczos3_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 contraction matrix: antialiased when
    downscaling (the kernel stretched by the inverse scale), interpolating
    when upscaling, as jax.image.resize does."""
    key = (in_size, out_size)
    w = _weight_cache.get(key)
    if w is not None:
        return w
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale
                - 0.5)
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _lanczos3_kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= in_size - 0.5))[None, :],
                 w, 0).astype(np.float32)
    _weight_cache[key] = w
    return w


def resize_lanczos3(batch: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Resize a [B, h, w] batch to float32 [B, out_h, out_w]. On the card
    the products are full float32 as long as TF32 stays off (PyTorch's
    default, torch.backends.cuda.matmul.allow_tf32)."""
    x = batch.to(torch.float32)
    _, h, w = x.shape
    if h != out_h:
        wh = torch.from_numpy(lanczos3_weights(h, out_h)).to(x.device)
        x = torch.matmul(wh.T, x)  # [out_h, h] @ [B, h, w]
    if w != out_w:
        ww = torch.from_numpy(lanczos3_weights(w, out_w)).to(x.device)
        x = torch.matmul(x, ww)  # [B, out_h, w] @ [w, out_w]
    return x

