"""Deinterlace / telecine-detection tensor ops (plain PyTorch).

Counterpart of amatsukaze_tpu/ops/deint.py, cut to what the port runs:
field split / weave, bob, yadif (either field kept), the motion-adaptive
double-rate bob of the qtgmc mode, the motion-compensated frame
interpolation of the svp mode, the field-match costs and the per-cycle
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


def bob_field(field: torch.Tensor, parity_top: bool) -> torch.Tensor:
    """Linear bob of one field [B, H/2, W] to a frame [B, H, W]: the field
    on the even lines (parity_top) or the odd ones, each missing line the
    average of the field lines around it (edge replicated)."""
    nxt = torch.cat([field[:, 1:], field[:, -1:]], dim=1)
    prv = torch.cat([field[:, :1], field[:, :-1]], dim=1)
    if parity_top:
        return weave(field, (field + nxt) * 0.5)
    return weave((field + prv) * 0.5, field)


# ---------------------------------------------------------------------------
# motion-adaptive double-rate deinterlace (the qtgmc mode)
# ---------------------------------------------------------------------------

def _dilate3x3(m: torch.Tensor) -> torch.Tensor:
    """3x3 max filter over [B, H, W] (edge replicated)."""
    mh = torch.maximum(m, torch.maximum(_shift_cols(m, 1), _shift_cols(m, -1)))
    up = torch.cat([mh[:, :1], mh[:, :-1]], dim=1)
    dn = torch.cat([mh[:, 1:], mh[:, -1:]], dim=1)
    return torch.maximum(mh, torch.maximum(up, dn))


def _mc_temporal(tp: torch.Tensor, tn: torch.Tensor,
                 max_shift: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Motion-compensated temporal candidate from the same-parity fields
    before (tp) and after (tn): for each symmetric horizontal shift s, tp
    shifted +s averaged with tn shifted -s; the shift with the lowest
    match error wins (strict '<', in the JAX package's order). Returns
    (candidate, match error)."""
    best = (tp + tn) * 0.5
    best_err = (tp - tn).abs()
    for s in range(1, max_shift + 1):
        for sgn in (1, -1):
            a = _shift_cols(tp, sgn * s)
            c = _shift_cols(tn, -sgn * s)
            err = (a - c).abs()
            better = err < best_err
            best = torch.where(better, (a + c) * 0.5, best)
            best_err = torch.where(better, err, best_err)
    return best, best_err


def motion_adaptive_bob(prev: torch.Tensor, cur: torch.Tensor,
                        nxt: torch.Tensor, tff: bool = True,
                        thresh_low: float = 4.0,
                        thresh_high: float = 12.0) -> torch.Tensor:
    """Double-rate deinterlace: [B, H, W] interlaced frames -> [2B, H, W]
    progressive frames, one per field in field order. Static areas weave
    the temporally bracketing opposite field; moving areas take the
    edge-directed spatial prediction clamped to the motion-compensated
    temporal candidate; a dilated per-pixel motion measure blends the two.
    (XLA on the CPU contracts the blend into fused multiply-adds, so the
    JAX package's values differ from these in the last float bits.)"""
    cur_t, cur_b = field_split(cur)
    prev_t, prev_b = field_split(prev)
    nxt_t, nxt_b = field_split(nxt)

    def recon(keep, weave_cand, tp, tn, motion, parity_top):
        if parity_top:
            above = keep
            below = torch.cat([keep[:, 1:], keep[:, -1:]], dim=1)
        else:
            above = torch.cat([keep[:, :1], keep[:, :-1]], dim=1)
            below = keep
        spatial = _spatial_pred(above, below)
        mc, err = _mc_temporal(tp, tn)
        moving = torch.minimum(torch.maximum(spatial, mc - err), mc + err)
        m = _dilate3x3(motion)
        w = ((thresh_high - m) / (thresh_high - thresh_low)).clamp(0.0, 1.0)
        return w * weave_cand + (1.0 - w) * moving

    if tff:
        # field order: top (time k), then bottom (time k + 0.5)
        first = weave(cur_t, recon(cur_t, cur_b, prev_b, cur_b,
                                   (prev_b - cur_b).abs(), True))
        second = weave(recon(cur_b, (cur_t + nxt_t) * 0.5, cur_t, nxt_t,
                             (cur_t - nxt_t).abs(), False), cur_b)
    else:
        first = weave(recon(cur_b, cur_t, prev_t, cur_t,
                            (prev_t - cur_t).abs(), False), cur_b)
        second = weave(cur_t, recon(cur_t, (cur_b + nxt_b) * 0.5, cur_b,
                                    nxt_b, (cur_b - nxt_b).abs(), True))
    b, h, w = cur.shape
    return torch.stack([first, second], dim=1).reshape(2 * b, h, w)


def mc_frame_interp(a: torch.Tensor, b: torch.Tensor, frac: float,
                    max_shift: int = 4) -> torch.Tensor:
    """Motion-compensated intermediate frame between a (t=0) and b (t=1) at
    the time fraction `frac` (a Python float), for the svp mode: per pixel,
    the horizontal displacement dd in [-max_shift, max_shift] that best
    fits b(x) = a(x - dd) picks the cross-fade of a(x - frac*dd) with
    b(x + (1-frac)*dd) (shifts rounded half to even, as Python's round);
    where even the best fit is off by more than 24, the plain cross-fade.
    Every product and sum is its own operation, so the card gives the
    CPU's bits. XLA on the CPU fuses some of the cross-fades into
    multiply-adds, choosing the product to fuse per site (no fixed choice
    reproduces it), so the JAX package's values differ from these in the
    last bit, and its frames by one code value at rounding ties."""
    blend0 = (1.0 - frac) * a + frac * b
    best = blend0
    best_err = (a - b).abs()
    for d in range(1, max_shift + 1):
        for sgn in (1, -1):
            dd = sgn * d
            # match error in b's frame, moved to the output pixel (output x
            # samples b at x + (1-frac)*dd)
            err_b = (_shift_cols(a, -dd) - b).abs()
            err = _shift_cols(err_b, int(round((1.0 - frac) * dd)))
            cand = ((1.0 - frac) * _shift_cols(a, -int(round(frac * dd)))
                    + frac * _shift_cols(b, int(round((1.0 - frac) * dd))))
            better = err < best_err
            best = torch.where(better, cand, best)
            best_err = torch.where(better, err, best_err)
    return torch.where(best_err > 24.0, blend0, best)


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


def field_match_costs_from_prev(frames: torch.Tensor,
                                prev_frame: torch.Tensor) -> torch.Tensor:
    """field_match_costs with an explicit previous frame [H, W] (the frame
    before frames[0]; frames[0] itself at the sequence head): equal row by
    row to field_match_costs(cat([prev_frame[None], frames]))[1:]."""
    top, bot = field_split(frames)
    ptop, pbot = field_split(prev_frame[None])
    prev_top = torch.cat([ptop, top[:-1]], dim=0)
    prev_bot = torch.cat([pbot, bot[:-1]], dim=0)
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
