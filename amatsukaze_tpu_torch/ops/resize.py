"""Lanczos3 resize of [B, h, w] plane batches (plain PyTorch).

Counterpart of the JAX package's output resize: `jax.image.resize(...,
method="lanczos3")` in models/filter_graph._apply_resize, whose weights
amatsukaze_tpu/ops/resize.py mirrors in numpy. The weights here are that
copy (the same sample grid, kernel support, normalisation and edge
zeroing, in float32). The resize runs over H, then over W; each output
sample sums the taps of its Lanczos3 window in one fixed order, from the
lowest input index up, a separate multiply and add per tap, so the card
gives the CPU's bits. It agrees with jax.image.resize to float rounding:
XLA on the CPU sums the dense weight matrix in blocks whose order no fixed
tap order tried here reproduces. Not a Pallas kernel in the JAX package,
so not a hand-written kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

_RADIUS = 3.0
_weight_cache: dict[tuple[int, int], np.ndarray] = {}
_taps_cache: dict[tuple[int, int], tuple] = {}


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


def lanczos3_taps(in_size: int, out_size: int):
    """(index, weight): int64 [T, out_size] input rows and float32
    [T, out_size] weights of each output sample's T taps, lowest input
    index first. T is the widest window of lanczos3_weights' columns;
    a narrower window (at the edges) starts earlier and takes zero
    weights for the taps it does not have."""
    key = (in_size, out_size)
    got = _taps_cache.get(key)
    if got is not None:
        return got
    w = lanczos3_weights(in_size, out_size)
    nz = w != 0
    has = nz.any(axis=0)
    first = np.where(has, nz.argmax(axis=0), 0)
    last = np.where(has, in_size - 1 - nz[::-1].argmax(axis=0), 0)
    n_taps = int((last - first).max()) + 1
    start = np.minimum(first, in_size - n_taps)
    idx = start[None, :] + np.arange(n_taps)[:, None]
    got = idx, np.take_along_axis(w, idx, axis=0)
    _taps_cache[key] = got
    return got


def _resize_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    idx, wt = lanczos3_taps(x.shape[dim], out_size)
    idx = torch.from_numpy(idx).to(x.device)
    wt = torch.from_numpy(wt).to(x.device)
    shape = [1, 1, 1]
    shape[dim] = out_size
    acc = None
    for t in range(idx.shape[0]):
        term = x.index_select(dim, idx[t]) * wt[t].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize_lanczos3(batch: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Resize a [B, h, w] batch to float32 [B, out_h, out_w]."""
    x = batch.to(torch.float32)
    _, h, w = x.shape
    if h != out_h:
        x = _resize_axis(x, 1, out_h)
    if w != out_w:
        x = _resize_axis(x, 2, out_w)
    return x
