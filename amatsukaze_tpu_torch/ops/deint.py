"""Deinterlace / telecine-detection tensor ops (plain PyTorch).

Counterpart of amatsukaze_tpu/ops/deint.py, cut to what the slice runs:
field split / weave, yadif, the field-match costs and the per-cycle
pattern aggregation. The same math as the JAX functions, on [B, H, W]
tensors. ops.fused_filter's plain version is built from these; its CUDA
kernel computes the same function in one pass.

The combing sums follow the dtype they are given: float32 frames sum in
float32 as the JAX package does, int64 frames sum exactly (the products are
integers below 2^16), which is what the kernel's integer sums reproduce.
"""

from __future__ import annotations

import numpy as np
import torch


def field_split(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, W] -> (top fields [..., H/2, W], bottom fields)."""
    return frames[..., 0::2, :], frames[..., 1::2, :]


def weave(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """Interleave two fields back into a frame."""
    out = torch.stack([top, bottom], dim=-2)  # [..., H/2, 2, W]
    return out.reshape(*top.shape[:-2], top.shape[-2] * 2, top.shape[-1])


def _shift_cols(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., clamp(col + d)]: horizontal shift with edge replication."""
    if d == 0:
        return x
    w = x.shape[-1]
    idx = (torch.arange(w, device=x.device) + d).clamp(0, w - 1)
    return x[..., idx]


def _spatial_pred(above: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
    """Edge-directed spatial prediction from the kept field's line above
    and below: 5 directions, lowest absolute difference wins (yadif's
    spatial check)."""
    best_pred = (above + below) * 0.5
    best_score = (above - below).abs()
    for d in (1, 2):
        for sgn in (1, -1):
            pa = _shift_cols(above, sgn * d)
            pc = _shift_cols(below, -sgn * d)
            score = (pa - pc).abs()
            better = score < best_score
            best_pred = torch.where(better, (pa + pc) * 0.5, best_pred)
            best_score = torch.where(better, score, best_score)
    return best_pred


def yadif_deinterlace(prev: torch.Tensor, cur: torch.Tensor,
                      nxt: torch.Tensor, parity_top: bool) -> torch.Tensor:
    """Yadif-class deinterlace of the middle frame (float32 [B, H, W]):
    keeps the `parity_top` field of `cur` and rebuilds the other with an
    edge-directed spatial prediction clamped by the temporal neighbours."""
    cur_t, cur_b = field_split(cur)
    prev_t, prev_b = field_split(prev)
    nxt_t, nxt_b = field_split(nxt)
    keep = cur_t if parity_top else cur_b
    tp = prev_b if parity_top else prev_t
    tn = nxt_b if parity_top else nxt_t
    if parity_top:
        above = keep
        below = torch.cat([keep[:, 1:], keep[:, -1:]], dim=1)
    else:
        above = torch.cat([keep[:, :1], keep[:, :-1]], dim=1)
        below = keep
    spatial = _spatial_pred(above, below)
    temporal = (tp + tn) * 0.5
    diff = (tp - tn).abs() * 0.5
    recon = torch.minimum(torch.maximum(spatial, temporal - diff),
                          temporal + diff)
    return weave(keep, recon) if parity_top else weave(recon, keep)


def combing_metric_fields(top: torch.Tensor,
                          bottom: torch.Tensor) -> torch.Tensor:
    """Combing energy of weave(top, bottom) per frame, computed in field
    space: mean over woven rows r=1..H-2 of relu((W[r-1]-W[r])*(W[r+1]-W[r])).
    Returns float32 [B]."""
    t, b = top, bottom
    odd = (t[:, :-1] - b[:, :-1]) * (t[:, 1:] - b[:, :-1])
    even = (b[:, :-1] - t[:, 1:]) * (b[:, 1:] - t[:, 1:])
    total = (odd.clamp_min(0).sum(dim=(-2, -1))
             + even.clamp_min(0).sum(dim=(-2, -1)))
    return comb_mean(total, top.shape[-2] * 2, top.shape[-1])


def comb_mean(total: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Combing sums of H x W frames -> float32 means over the H-2 rows
    that have both neighbours."""
    return (total.double() / ((h - 2) * w)).float()


def field_match_costs(frames: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 3] field-pairing costs for telecine matching:
    comb(t(n), b(n)), comb(t(n), b(n-1)), comb(t(n-1), b(n)). The first
    frame pairs with itself, so its costs 1 and 2 duplicate cost 0."""
    top, bot = field_split(frames)
    prev_top = torch.cat([top[:1], top[:-1]], dim=0)
    prev_bot = torch.cat([bot[:1], bot[:-1]], dim=0)
    return torch.stack([combing_metric_fields(top, bot),
                        combing_metric_fields(top, prev_bot),
                        combing_metric_fields(prev_top, bot)], dim=-1)


# 3:2 pulldown: for each of the 5 phases of a cycle, which frames must
# field-match with their predecessor (1) vs stand alone (0)
_PULLDOWN_MERGE_NP = np.array(
    [
        [0, 0, 1, 1, 0],
        [0, 0, 0, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 0, 0, 0],
        [0, 1, 1, 0, 0],
    ],
    np.float32,
)


def telecine_pattern_costs_host(costs: np.ndarray) -> np.ndarray:
    """Aggregate [N, 3] field-match costs per 5-frame cycle into [N/5, 7]
    pattern costs: 5 pulldown phases, the 30p cost, the 60p indicator. The
    table is tiny and already on the host, so this is numpy."""
    costs = np.asarray(costs, np.float32)
    n = costs.shape[0] // 5
    c = costs[: n * 5].reshape(n, 5, 3)
    as_is = c[:, :, 0]
    merged = np.minimum(c[:, :, 1], c[:, :, 2])
    phase_costs = merged @ _PULLDOWN_MERGE_NP.T \
        + as_is @ (1.0 - _PULLDOWN_MERGE_NP).T
    cost_30p = np.sum(as_is, axis=1)
    cost_60p = np.sum(np.minimum(as_is, merged), axis=1)
    return np.concatenate(
        [phase_costs, cost_30p[:, None], cost_60p[:, None]], axis=1
    ).astype(np.float32)
