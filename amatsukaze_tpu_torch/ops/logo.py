"""Batched logo ops (plain PyTorch).

Counterpart of amatsukaze_tpu/ops/logo.py: the dense per-pixel evaluation
operands of one logo, the 5x5 per-pixel-kernel correlation score over a
batch of frames x fade steps, the DeintY/DeintLogo field merges and the
erase (ref LogoScan.hpp:24-318, :734-781, :1248-1261). The score here is
the plain version of the CUDA kernel in ops/logo_eval.py and runs the same
per-pixel arithmetic in the same order.

Layouts: the public tensors are the JAX package's ([B, H, W] frames,
[B, F] scores), except the per-pixel tables, which are stored tap-major
([25, H, W]) and bucket-major ([32, H, W]). The kernel reads none of the
dense tables: beside them the operands hold the masked pixels alone,
compacted (compact_operands), one entry per thread of the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

KSIZE = 5
KLEN = 25
CSHIFT = 3
CLEN = 32
# entries of the compacted list per chunk = threads of one block of the
# kernel (tune_logo_eval sweeps it)
ITEMS_PER_BLOCK = 128
# most rows of the window one chunk's tile holds, its 4 halo rows included
MAX_TILE_ROWS = 16
# the tile pair (source and background, float32) should fit the 48 KB of
# shared memory a block gets without asking for more
TILE_BYTES = 48 * 1024


@dataclass
class LogoEvalParams:
    """Dense per-pixel evaluation operands for one logo, on one device.

    a_y, b_y      : [H, W] logo A/B planes (deinterlaced for matching)
    mask          : [H, W] float32 0/1, interior masked pixels only
    kernels       : [25, H, W] zero-mean 5x5 kernels, tap-major (0 off-mask)
    scale         : [32, H, W] 1/|corr| per background bucket, bucket-major
    scale2        : [32, H, W] low-correlation cap per background bucket
    black_score   : baseline score (logo on black)

    The masked pixels alone, as the kernel reads them (compact_operands):
    pos           : [M] int32 y*W + x, row-major, in chunks of `chunk`
    weight        : [M] float32 the pixel's mask value; 0 on padding
    kernels_c     : [25, M] the pixels' columns of `kernels`
    scale_c       : [32, M] of `scale`
    scale2_c      : [32, M] of `scale2`
    boxes         : [M / chunk, 4] int32 per chunk: first row, rows, first
                    column, columns of the window that hold its pixels' taps
    n_items       : masked pixels (M less the padding)
    chunk         : entries per chunk; M is a multiple of it
    tile_elems    : most window pixels a chunk's box holds
    """

    a_y: torch.Tensor
    b_y: torch.Tensor
    mask: torch.Tensor
    kernels: torch.Tensor
    scale: torch.Tensor
    scale2: torch.Tensor
    black_score: float
    pos: torch.Tensor
    weight: torch.Tensor
    kernels_c: torch.Tensor
    scale_c: torch.Tensor
    scale2_c: torch.Tensor
    boxes: torch.Tensor
    n_items: int
    chunk: int
    tile_elems: int

    @classmethod
    def from_numpy(cls, d: dict, device,
                   chunk: int = ITEMS_PER_BLOCK) -> "LogoEvalParams":
        """From the JAX package's dense layout (kernels [H, W, 25], scales
        [H, W, 32]; see dense_operands_from_ref)."""

        def last_to_first(x):
            return np.ascontiguousarray(
                np.moveaxis(np.asarray(x, np.float32), -1, 0))

        dense = dict(
            a_y=np.array(d["a_y"], np.float32, order="C"),  # writable copies
            b_y=np.array(d["b_y"], np.float32, order="C"),
            mask=np.array(d["mask"], np.float32, order="C"),
            kernels=last_to_first(d["kernels"]),
            scale=last_to_first(d["scale"]),
            scale2=last_to_first(d["scale2"]))
        compact = compact_operands(dense["mask"], dense["kernels"],
                                   dense["scale"], dense["scale2"], chunk)
        counts = {k: compact.pop(k) for k in ("n_items", "chunk", "tile_elems")}
        return cls(
            black_score=float(np.float32(d["black_score"])), **counts,
            **{k: torch.from_numpy(v).to(device)
               for k, v in {**dense, **compact}.items()})

    @classmethod
    def from_ref(cls, ref, device,
                 chunk: int = ITEMS_PER_BLOCK) -> "LogoEvalParams":
        """Build the operands from the host-side LogoEvalRef oracle."""
        return cls.from_numpy(dense_operands_from_ref(ref), device, chunk)


def dense_operands_from_ref(ref) -> dict:
    """Dense numpy evaluation operands from the LogoEvalRef oracle, in the
    JAX package's layout: kernels [H, W, 25], scale/scale2 [H, W, 32]."""
    h, w = ref.h, ref.w
    mask2d = ref.mask.reshape(h, w).astype(bool)
    interior = np.zeros((h, w), bool)
    interior[2 : h - 2, 2 : w - 2] = True
    eff = mask2d & interior
    kernels = np.zeros((h, w, KLEN), np.float32)
    scale = np.zeros((h, w, CLEN), np.float32)
    scale2 = np.zeros((h, w, CLEN), np.float32)
    # ref.kernels/scales are ordered by the interior row-major walk
    ys, xs = np.nonzero(eff)
    kernels[ys, xs] = ref.kernels[: len(ys)]
    scale[ys, xs] = ref.scales[: len(ys), :, 0]
    scale2[ys, xs] = ref.scales[: len(ys), :, 1]
    return dict(
        a_y=np.asarray(ref.a_y, np.float32),
        b_y=np.asarray(ref.b_y, np.float32),
        mask=eff.astype(np.float32),
        kernels=kernels,
        scale=scale,
        scale2=scale2,
        black_score=np.float32(ref.black_score),
    )


def compact_operands(mask: np.ndarray, kernels: np.ndarray, scale: np.ndarray,
                     scale2: np.ndarray, chunk: int = ITEMS_PER_BLOCK) -> dict:
    """The masked pixels of the dense operands (mask [H, W], kernels
    [25, H, W], scale/scale2 [32, H, W]) as the kernel reads them: their
    positions y*W + x in row-major order and their columns of the three
    tables, cut into chunks of `chunk` entries (a multiple of the warp
    size), one chunk per block. A chunk ends early where its pixels would
    span more rows than a block's tile holds, and is filled up with
    padding: the chunk's last position again, weight 0 and zero tables.
    Each chunk comes with the box of the window that holds its pixels'
    taps (columns on multiples of 4, for 16-byte loads). Every masked
    pixel must have its 25 taps inside the window."""
    if chunk < 32 or chunk % 32:
        raise ValueError(f"chunk must be a multiple of 32, got {chunk}")
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    if len(ys) and (ys.min() < 2 or ys.max() > h - 3 or xs.min() < 2
                    or xs.max() > w - 3):
        raise ValueError("the logo mask touches the window's border: a "
                         "masked pixel needs its 5x5 neighbourhood inside")
    most_rows = max(5, min(MAX_TILE_ROWS, TILE_BYTES // (8 * w)))
    index, real, boxes = [], [], []
    i = 0
    while i < len(ys):
        # ys ascends: the first entry a tile starting 2 rows above ys[i]
        # no longer holds
        stop = int(np.searchsorted(ys, ys[i] + most_rows - 4))
        j = min(i + chunk, stop)
        index.append(np.r_[i:j, np.full(chunk - (j - i), j - 1)])
        real.append(np.arange(chunk) < j - i)
        col0 = (int(xs[i:j].min()) - 2) // 4 * 4
        col1 = min(w, -(-(int(xs[i:j].max()) + 3) // 4) * 4)
        boxes.append((ys[i] - 2, ys[j - 1] - ys[i] + 5, col0, col1 - col0))
        i = j
    boxes = np.array(boxes, np.int32).reshape(-1, 4)
    index = np.concatenate(index) if index else np.zeros(0, np.int64)
    real = np.concatenate(real) if real else np.zeros(0, bool)
    ys, xs = ys[index], xs[index]
    weight = np.where(real, mask[ys, xs], 0.0).astype(np.float32)

    def gather(table):
        return np.ascontiguousarray(
            np.where(real, table[:, ys, xs], 0.0).astype(np.float32))

    return dict(pos=(ys * w + xs).astype(np.int32), weight=weight,
                kernels_c=gather(kernels), scale_c=gather(scale),
                scale2_c=gather(scale2), boxes=boxes, n_items=int(real.sum()),
                chunk=chunk,
                tile_elems=int((boxes[:, 1] * boxes[:, 3]).max(initial=0)))


def correlation_values(params: LogoEvalParams,
                       work: torch.Tensor) -> torch.Tensor:
    """Masked, normalised 5x5 correlation of `work` [..., H, W] with the
    per-pixel kernels -> each pixel's share of the raw score
    [..., H, W], 0 off the mask (ref CorrelationScore's loop body)."""
    h, w = work.shape[-2:]
    p = F.pad(work, (2, 2, 2, 2))  # zero fill; borders are masked anyway
    taps = [p[..., dy:dy + h, dx:dx + w]
            for dy in range(KSIZE) for dx in range(KSIZE)]
    total = taps[0]
    for t in taps[1:]:
        total = total + t
    avg = total / 25.0
    corr = torch.zeros_like(avg)
    for k, t in enumerate(taps):
        corr = corr + (t - avg) * params.kernels[k]
    # truncating cast, as XLA's convert
    bucket = (avg.to(torch.int32).clamp(0, 255) >> CSHIFT).long()
    yy = torch.arange(h, device=work.device)[:, None]
    xx = torch.arange(w, device=work.device)
    s1 = params.scale[bucket, yy, xx]
    s2 = params.scale2[bucket, yy, xx]
    normalized = (corr * s1).clamp(-1.0, 1.0)
    return normalized * s2 * params.mask


def correlation_scores(params: LogoEvalParams,
                       work: torch.Tensor) -> torch.Tensor:
    """The raw scores [...] of `work` [..., H, W]: correlation_values
    summed over the window (ref CorrelationScore)."""
    return correlation_values(params, work).sum(dim=(-2, -1))


def blend(params: LogoEvalParams, src: torch.Tensor, maxv: float,
          fades: torch.Tensor) -> torch.Tensor:
    """The window erased at every fade step: src [B, H, W] x fades [F] ->
    [B, F, H, W]."""
    f = fades.reshape(1, -1, 1, 1)
    s = src[:, None]
    bg = params.a_y * s + params.b_y * maxv
    return f * bg + (1.0 - f) * s


def batched_evaluate_logo(params: LogoEvalParams, src: torch.Tensor,
                          maxv: float, fades: torch.Tensor) -> torch.Tensor:
    """EvaluateLogo for a batch of frames x fade steps: src [B, H, W]
    float32 (deinterlaced Y window), fades [F] -> [B, F] scores normalised
    by the black-background baseline (ref LogoScan.hpp:231-255)."""
    work = blend(params, src, maxv, fades)
    return correlation_scores(params, work) / params.black_score


def batched_deint_evaluate_logo(params: LogoEvalParams, window: torch.Tensor,
                                maxv: float,
                                fades: torch.Tensor) -> torch.Tensor:
    """DeintY, then EvaluateLogo: the raw uint8 window [B, H, W] of a batch
    of frames x fades [F] -> [B, F] scores."""
    return batched_evaluate_logo(params, batched_deint_y(window.float()),
                                 maxv, fades)


def batched_deint_y(src: torch.Tensor) -> torch.Tensor:
    """(a + 2b + c + 2)/4 vertical field merge over [..., H, W]
    (ref DeintY LogoScan.hpp:763-781)."""
    mid = (src[..., :-2, :] + 2.0 * src[..., 1:-1, :] + src[..., 2:, :]
           + 2.0) / 4.0
    return torch.cat([src[..., :1, :], mid, src[..., -1:, :]], dim=-2)


def batched_deint_logo(plane: torch.Tensor) -> torch.Tensor:
    """(a + 2b + c)/4 merge for logo A/B planes (ref DeintLogo :734-761)."""
    mid = (plane[..., :-2, :] + 2.0 * plane[..., 1:-1, :]
           + plane[..., 2:, :]) / 4.0
    return torch.cat([plane[..., :1, :], mid, plane[..., -1:, :]], dim=-2)


def batched_delogo(src: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   maxv: float, fades: torch.Tensor) -> torch.Tensor:
    """dst = clamp(floor(fade*(a*src + b*maxv) + (1-fade)*src + 0.5), 0,
    maxv) (ref Delogo LogoScan.hpp:1248-1261) over src [B, H, W] float32
    with per-frame fades [B]. Every operation rounds on its own, as the
    reference's and the numpy oracle's float code does. Returns float32."""
    fade = fades[:, None, None]
    bg = a * src + b * maxv
    tmp = fade * bg + (1.0 - fade) * src
    return torch.floor(tmp + 0.5).clamp(0.0, maxv)


# ---------------------------------------------------------------------------
# logo generation: per-pixel regression sums and their closed-form solve
# ---------------------------------------------------------------------------

def field_fades(fade_t: torch.Tensor, fade_b: torch.Tensor,
                height: int) -> torch.Tensor:
    """Expand per-frame top/bottom fades [B] to per-row fades [B, H]."""
    rows = torch.arange(height, device=fade_t.device) % 2
    return torch.where(rows[None, :] == 0, fade_t[:, None], fade_b[:, None])


def logo_sums_update(sums: torch.Tensor, frames: torch.Tensor,
                     bgs: torch.Tensor) -> torch.Tensor:
    """Accumulate the per-pixel regression sums over a batch of frames.

    sums   : [5, H, W] (sumF, sumB, sumF2, sumB2, sumFB) - ref LogoColor::Add
    frames : [N, H, W] pixel values
    bgs    : [N] per-frame background level

    In float32, 8-bit frames and the integer background levels that the
    scan's border test gives (med_average) keep every sum an integer below
    2^24 for batches of at most 256 frames: exact in any order, so the card
    and the CPU (and XLA) give the same sums."""
    f = frames.double() if sums.dtype == torch.float64 else frames.float()
    b = bgs.to(f.dtype)
    sum_f = f.sum(dim=0)
    ones = torch.ones_like(sum_f)
    sum_b = b.sum() * ones
    sum_f2 = (f * f).sum(dim=0)
    sum_b2 = (b * b).sum() * ones
    sum_fb = (f * b[:, None, None]).sum(dim=0)
    return sums + torch.stack([sum_f, sum_b, sum_f2, sum_b2, sum_fb])


def logo_ab_from_sums(sums: torch.Tensor, n):
    """Closed-form GetAB per pixel (ref approxim_line/GetAB :336-396).

    Returns (A, B, valid) with A/B float32 [H, W]."""
    sum_f, sum_b, sum_f2, sum_b2, sum_fb = sums
    t1 = n * sum_f2 - sum_f * sum_f
    a1 = (n * sum_fb - sum_f * sum_b) / t1
    b1 = (sum_f2 * sum_b - sum_f * sum_fb) / t1
    t2 = n * sum_b2 - sum_b * sum_b
    a2 = (n * sum_fb - sum_b * sum_f) / t2
    b2 = (sum_b2 * sum_f - sum_b * sum_fb) / t2
    a = (a1 + 1.0 / a2) / 2.0
    b = (b1 + (-b2 / a2)) / 2.0
    valid = torch.isfinite(a) & torch.isfinite(b) & (a != 0)
    return a.float(), b.float(), valid
