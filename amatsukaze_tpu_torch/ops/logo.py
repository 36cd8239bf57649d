"""Batched logo ops (plain PyTorch).

Counterpart of amatsukaze_tpu/ops/logo.py: the dense per-pixel evaluation
operands of one logo, the 5x5 per-pixel-kernel correlation score over a
batch of frames x fade steps, the DeintY/DeintLogo field merges and the
erase (ref LogoScan.hpp:24-318, :734-781, :1248-1261). The score here is
the plain version of the CUDA kernel in ops/logo_eval.py and runs the same
per-pixel arithmetic in the same order.

Layouts: the public tensors are the JAX package's ([B, H, W] frames,
[B, F] scores), except the per-pixel tables, which are stored tap-major
([25, H, W]) and bucket-major ([32, H, W]) as the kernel reads them.
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


@dataclass
class LogoEvalParams:
    """Dense per-pixel evaluation operands for one logo, on one device.

    a_y, b_y      : [H, W] logo A/B planes (deinterlaced for matching)
    mask          : [H, W] float32 0/1, interior masked pixels only
    kernels       : [25, H, W] zero-mean 5x5 kernels, tap-major (0 off-mask)
    scale         : [32, H, W] 1/|corr| per background bucket, bucket-major
    scale2        : [32, H, W] low-correlation cap per background bucket
    black_score   : baseline score (logo on black)
    """

    a_y: torch.Tensor
    b_y: torch.Tensor
    mask: torch.Tensor
    kernels: torch.Tensor
    scale: torch.Tensor
    scale2: torch.Tensor
    black_score: float

    @classmethod
    def from_numpy(cls, d: dict, device) -> "LogoEvalParams":
        """From the JAX package's dense layout (kernels [H, W, 25], scales
        [H, W, 32]; see dense_operands_from_ref)."""

        def t(x):
            x = np.array(x, np.float32, order="C")  # a writable copy
            return torch.from_numpy(x).to(device)

        def last_to_first(x):
            return np.moveaxis(np.asarray(x, np.float32), -1, 0)

        return cls(
            a_y=t(d["a_y"]), b_y=t(d["b_y"]), mask=t(d["mask"]),
            kernels=t(last_to_first(d["kernels"])),
            scale=t(last_to_first(d["scale"])),
            scale2=t(last_to_first(d["scale2"])),
            black_score=float(np.float32(d["black_score"])),
        )

    @classmethod
    def from_ref(cls, ref, device) -> "LogoEvalParams":
        """Build the operands from the host-side LogoEvalRef oracle."""
        return cls.from_numpy(dense_operands_from_ref(ref), device)


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


def correlation_scores(params: LogoEvalParams,
                       work: torch.Tensor) -> torch.Tensor:
    """Masked, normalised 5x5 correlation of `work` [..., H, W] with the
    per-pixel kernels -> raw scores [...] (ref CorrelationScore)."""
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
    return (normalized * s2 * params.mask).sum(dim=(-2, -1))


def batched_evaluate_logo(params: LogoEvalParams, src: torch.Tensor,
                          maxv: float, fades: torch.Tensor) -> torch.Tensor:
    """EvaluateLogo for a batch of frames x fade steps: src [B, H, W]
    float32 (deinterlaced Y window), fades [F] -> [B, F] scores normalised
    by the black-background baseline (ref LogoScan.hpp:231-255)."""
    f = fades.reshape(1, -1, 1, 1)
    s = src[:, None]
    bg = params.a_y * s + params.b_y * maxv
    work = f * bg + (1.0 - f) * s  # [B, F, H, W]
    return correlation_scores(params, work) / params.black_score


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
