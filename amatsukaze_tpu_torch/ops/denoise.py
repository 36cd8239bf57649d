"""The post-filter chain (plain PyTorch): QP-map deblocking, temporal NR,
deband, edge-level sharpening and the bit-depth staging around them.

Counterpart of amatsukaze_tpu/ops/denoise.py, the same math on [B, H, W]
float32 tensors in the 14-bit value domain (0..16383) unless noted. None of
these is a Pallas kernel in the JAX package (XLA fuses them there), so none
is a hand-written kernel here.

What is bit-equal to the JAX package and what is not: temporal_nr, deband
(its random offsets and selection come from ops.threefry, JAX's own
stream), to_14bit and to_10bit use only exact operations or the same
single roundings in the same order. deblock_qp sums each 8-tap DCT product
in the order of XLA's einsum on the CPU (dct8_sum), and edge_level takes
`c - lap * k` as the fused multiply-add that XLA on the CPU contracts it
into (fma_f32), so both are bit-equal to the JAX package there too.

Every sum here is a fixed sequence of separate elementwise operations, so
the card and the CPU give the same bits: no matrix product whose order a
BLAS picks, nothing that a compiler could contract into an FMA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import threefry

# deband's draws (denoise.py:150-167 of the JAX package)
DEBAND_CANDIDATES = 8
DEBAND_OFFSET_SALT = 0x9E3779B9
# frames whose selection field is hashed at once: bounds the int64
# temporaries of the hash (about ten of 4 x 8.3 M values at 3840x2160)
SELECTION_FRAMES_PER_DRAW = 4


def _dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (float64; rounded to float32 as
    the JAX package rounds it)."""
    k = np.arange(8)
    n = np.arange(8)
    m = np.cos(np.pi / 8 * (n[None, :] + 0.5) * k[:, None])
    m[0] *= 1 / np.sqrt(2)
    m *= np.sqrt(2 / 8)
    return m.astype(np.float32)


_DCT8 = _dct8_matrix()


def fma_f32(prod: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 fma(x, y, acc) from prod = x * y taken in float64 (exact for
    float32 x, y): the sum rounds to float64 and then to float32, which is
    the fused multiply-add's single rounding unless the float64 sum lands
    exactly on a float32 tie (a chance of about 2^-29 a sum)."""
    return (prod + acc.double()).float()


def dct8_sum(terms: list) -> torch.Tensor:
    """The float32 sum of 8 exact float64 products t_0..t_7 in the order of
    XLA's 8-deep dot on the CPU: four accumulators a_r = fma(t_{r+4},
    round(t_r)), then (a_0 + a_1) + (a_2 + a_3). Reproduces jnp.einsum's
    DCT products in amatsukaze_tpu/ops/denoise.py bit for bit (tested)."""
    acc = [fma_f32(terms[r + 4], terms[r].float()) for r in range(4)]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _dct_left(m: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """m @ y per block: m float64 [8, 8], y float64 [..., 8, 8]."""
    return dct8_sum([m[:, j, None] * y[..., j, None, :] for j in range(8)])


def _dct_right(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """y @ m.T per block."""
    return dct8_sum([y[..., :, k, None] * m[:, k] for k in range(8)])


def deblock_qp(frames: torch.Tensor, qp_map: torch.Tensor,
               strength: float = 1.0, qp_block_scale: int = 2) -> torch.Tensor:
    """Soft-threshold 8x8 DCT coefficients by the macroblock's quantiser.

    frames: [B, H, W] (H, W multiples of 8); qp_map: [B, mb_h, mb_w].
    Coefficients below qp*strength shrink toward zero, those below twice
    it are soft-thresholded, larger ones and the DC pass. qp_block_scale:
    8-pixel blocks per QP cell along each axis (2 for luma, 1 for 4:2:0
    chroma). The DCT products take their taps in the order of the JAX
    package's einsums: D X first, then (D X) D^T, and for the inverse
    D^T C first (dct8_sum)."""
    b, h, w = frames.shape
    hb, wb = h // 8, w // 8
    d = torch.from_numpy(_DCT8).to(frames.device, torch.float64)
    blocks = frames.reshape(b, hb, 8, wb, 8).permute(0, 1, 3, 2, 4)
    # D X D^T per block
    coef = _dct_right(_dct_left(d, blocks.double()).double(), d)
    s = qp_block_scale
    qp8 = qp_map.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
    thresh = (qp8[:, :hb, :wb] * strength)[..., None, None]
    mag = coef.abs()
    shrunk = torch.sign(coef) * torch.clamp_min(mag - thresh, 0.0)
    soft = torch.where(mag < 2.0 * thresh, shrunk, coef)
    keep_dc = torch.zeros((8, 8), dtype=torch.bool, device=frames.device)
    keep_dc[0, 0] = True
    coef = torch.where(keep_dc, coef, soft)
    dt = d.T.contiguous()
    out = _dct_right(_dct_left(dt, coef.double()).double(), dt)  # inverse
    return out.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def temporal_nr(frames: torch.Tensor, threshold: float = 64.0,
                radius: int = 2) -> torch.Tensor:
    """Average each pixel with its temporal neighbours within +-radius
    frames of the batch whose value differs by less than `threshold`.

    As in the JAX package, the neighbour at offset sgn*d is
    roll(frames, sgn*d) (frame i - sgn*d, wrapping around the batch) while
    the mask admits it when i + sgn*d lies inside the batch: the two
    disagree at the ends of the batch, and the port keeps that."""
    b = frames.shape[0]
    acc = frames
    cnt = torch.ones_like(frames)
    idx = torch.arange(b, device=frames.device)
    for d in range(1, radius + 1):
        for sgn in (-1, 1):
            shifted = torch.roll(frames, sgn * d, dims=0)
            j = idx + sgn * d
            valid = ((j >= 0) & (j < b))[:, None, None]
            ok = ((shifted - frames).abs() < threshold) & valid
            acc = acc + torch.where(ok, shifted, 0.0)
            cnt = cnt + ok.to(frames.dtype)
    return acc / cnt


def deband_offsets(seed: int, step: int, range_: int = 15) -> list:
    """The 8 candidate (dy, dx) offsets of one sample step: they depend on
    the seed alone, so they are drawn once, on the host."""
    key = threefry.fold_in(threefry.prng_key(seed ^ DEBAND_OFFSET_SALT), step)
    offs = threefry.randint(key, (DEBAND_CANDIDATES, 2), -range_, range_ + 1)
    return [tuple(int(v) for v in o) for o in offs.tolist()]


def deband_selection(keys: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The per-pixel candidate index [B, h, w] (int64) of one sample step
    from per-frame keys [B, 2]: jax.random.randint(k, (h, w), 0, 8) for
    each frame, SELECTION_FRAMES_PER_DRAW frames at a time."""
    out = torch.empty((keys.shape[0], h, w), dtype=torch.int64,
                      device=keys.device)
    n = SELECTION_FRAMES_PER_DRAW
    for i in range(0, keys.shape[0], n):
        out[i:i + n] = threefry.randint(keys[i:i + n], (h, w), 0,
                                        DEBAND_CANDIDATES)
    return out


def deband(frames: torch.Tensor, seed: int = 0, threshold: float = 96.0,
           range_: int = 15, sample: int = 2,
           frame_offset: int = 0) -> torch.Tensor:
    """Blur flat gradients: per sample step, every pixel averages with the
    symmetric pair of pixels at +-(dy, dx), when both lie within
    `threshold` of it. Each step draws 8 candidate offsets from the seed
    and a per-frame random field picks one per pixel; frame i of the batch
    draws from fold_in(PRNGKey(seed), frame_offset + i)."""
    b, h, w = frames.shape
    keys = threefry.fold_in(
        threefry.prng_key(seed, frames.device),
        torch.arange(b, device=frames.device) + frame_offset)
    acc = frames
    cnt = torch.ones_like(frames)
    pad = range_
    padded = F.pad(frames[:, None], (pad, pad, pad, pad),
                   mode="replicate")[:, 0]
    for s in range(sample):
        offs = deband_offsets(seed, s, range_)
        halves = threefry.split(keys)
        keys, ksel = halves[:, 0], halves[:, 1]
        sel = deband_selection(ksel, h, w)
        n1 = torch.zeros_like(frames)
        n2 = torch.zeros_like(frames)
        for j, (dy, dx) in enumerate(offs):
            c1 = padded[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            c2 = padded[:, pad - dy:pad - dy + h, pad - dx:pad - dx + w]
            m = sel == j
            n1 = torch.where(m, c1, n1)
            n2 = torch.where(m, c2, n2)
        ok = ((n1 - frames).abs() < threshold) & (
            (n2 - frames).abs() < threshold)
        acc = acc + torch.where(ok, n1 + n2, 0.0)
        cnt = cnt + 2.0 * ok.to(frames.dtype)
    return acc / cnt


def edge_level(frames: torch.Tensor, strength: float = 10.0,
               lower_thresh: float = 128.0,
               upper_thresh: float = 2048.0) -> torch.Tensor:
    """Sharpen medium-strength edges only: gradients above upper_thresh
    (already sharp) and below lower_thresh (intentional blur) pass
    unchanged; the result is clamped into the 4-neighbour min/max."""
    p = F.pad(frames[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    c = p[:, 1:-1, 1:-1]
    up = p[:, :-2, 1:-1]
    dn = p[:, 2:, 1:-1]
    lf = p[:, 1:-1, :-2]
    rt = p[:, 1:-1, 2:]
    grad = (rt - lf).abs() + (dn - up).abs()
    lap = (up + dn + lf + rt) * 0.25 - c
    apply = (grad > lower_thresh) & (grad < upper_thresh)
    sharp = fma_f32(lap.double() * -(strength / 16.0), c)  # as XLA fuses it
    nmin = torch.minimum(torch.minimum(up, dn), torch.minimum(lf, rt))
    nmax = torch.maximum(torch.maximum(up, dn), torch.maximum(lf, rt))
    repaired = torch.minimum(torch.maximum(sharp, torch.minimum(nmin, c)),
                             torch.maximum(nmax, c))
    return torch.where(apply, repaired, c)


def to_14bit(frames_8bit: torch.Tensor) -> torch.Tensor:
    return frames_8bit.to(torch.float32) * 64.0


def to_10bit(frames_14bit: torch.Tensor) -> torch.Tensor:
    # a division by 16, exact as a product with 1/16
    return torch.floor(frames_14bit * (1.0 / 16.0) + 0.5).clamp(0.0, 1023.0)


def hbd_filter_chain(frames_8bit: torch.Tensor, seed: int = 0,
                     enable_tnr: bool = True, enable_deband: bool = True,
                     enable_edge: bool = False) -> torch.Tensor:
    """8 -> 14 bit, temporal NR, deband, edge level, -> 10 bit."""
    x = to_14bit(frames_8bit)
    if enable_tnr:
        x = temporal_nr(x)
    if enable_deband:
        x = deband(x, seed)
    if enable_edge:
        x = edge_level(x)
    return to_10bit(x)
