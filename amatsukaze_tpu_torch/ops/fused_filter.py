"""yadif + field-match costs (+ optional box erase) over uint8 frame batches.

Counterpart of amatsukaze_tpu/ops/fused_filter.py. The JAX package has two
Pallas kernels for one function (make_fused_filter in frame layout,
make_fused_filter_field in a lane-merged field layout with costs-only and
logo-box modes); the TPU's (8, 128) tiling chose between them. Here one
hand-written CUDA kernel, csrc/yadif_fieldmatch.cu, takes the logical frame
through its row stride, with flags for what to write:

- ``write_frames``: the yadif output (top field kept, bottom rebuilt);
- ``with_costs``: the three field-match costs per frame, [B, 3];
- ``erase``: a logo box erased as the pixels are loaded (fused_logo).

On a CUDA tensor `yadif_fieldmatch` launches the kernel; on a CPU tensor it
runs `yadif_fieldmatch_plain`, the same function from ops.deint and
ops.logo. Frame 0's previous frame and the last frame's next frame are the
frames themselves, as in the Pallas kernels' batch-edge clamping.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass

import torch

from . import cuda_lib
from . import deint
from .logo import batched_delogo

MAXV = 255.0  # 8-bit samples

# field rows per block: 68 tiles x 32 frames = 2176 blocks for a 1080-row
# luma batch, enough to fill the card's 132 SMs many times over
TILE_FIELD_ROWS = 8


@dataclass
class EraseBox:
    """Logo erase over one box of 8-bit frames: a, b float32 [h, w] (the
    logo's A/B planes over the box), per-frame fades float32 [B], box
    origin (y0, x0) in frame coordinates."""

    a: torch.Tensor
    b: torch.Tensor
    fades: torch.Tensor
    y0: int
    x0: int


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = cuda_lib.load("yadif_fieldmatch")
        fn = lib.amt_yadif_fieldmatch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, i, i, i, p, p, i, p, p, p, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def mode_name(write_frames: bool, with_costs: bool, erase) -> str:
    """Launch-count key: 'yadif', 'costs' or 'yadif+costs', '+erase'."""
    parts = [n for n, on in (("yadif", write_frames), ("costs", with_costs),
                             ("erase", erase is not None)) if on]
    return "+".join(parts)


def _check(frames: torch.Tensor, write_frames: bool, with_costs: bool,
           erase: EraseBox | None) -> None:
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8 [B, H, W], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    b, h, w = frames.shape
    if b < 1 or h < 2 or h % 2 or w < 1:
        raise ValueError(f"need B >= 1, an even H >= 2 and W >= 1, got "
                         f"{tuple(frames.shape)}")
    if frames.stride(-1) != 1:
        raise ValueError("frames rows must be contiguous (stride 1 along W)")
    if not (write_frames or with_costs):
        raise ValueError("nothing to compute: write_frames and with_costs "
                         "are both off")
    if erase is None:
        return
    bh, bw = erase.a.shape
    if (erase.a.dtype != torch.float32 or erase.b.dtype != torch.float32
            or tuple(erase.b.shape) != (bh, bw)):
        raise ValueError("erase a/b must be float32 planes of one shape")
    if erase.fades.dtype != torch.float32 or tuple(erase.fades.shape) != (b,):
        raise ValueError(f"erase fades must be float32 [{b}]")
    if not (0 <= erase.y0 and erase.y0 + bh <= h and 0 <= erase.x0
            and erase.x0 + bw <= w):
        raise ValueError("erase box lies outside the frame")
    for t in (erase.a, erase.b, erase.fades):
        if t.device != frames.device:
            raise ValueError("erase tensors and frames must share a device")


def yadif_fieldmatch(frames: torch.Tensor, *, write_frames: bool = True,
                     with_costs: bool = False, erase: EraseBox | None = None):
    """frames uint8 [B, H, W] (H even; rows may be strided) ->
    (filtered uint8 [B, H, W] or None, costs float32 [B, 3] or None)."""
    _check(frames, write_frames, with_costs, erase)
    if not frames.is_cuda:
        return yadif_fieldmatch_plain(frames, write_frames=write_frames,
                                      with_costs=with_costs, erase=erase)
    b, h, w = frames.shape
    dev = frames.device
    out = (torch.empty((b, h, w), dtype=torch.uint8, device=dev)
           if write_frames else None)
    n_tiles = -(-(h // 2) // TILE_FIELD_ROWS)
    partials = (torch.empty((n_tiles, b, 3), dtype=torch.int64, device=dev)
                if with_costs else None)
    box = (None, None, None, 0, 0, 0, 0, MAXV)
    if erase is not None:
        ea, eb, ef = (erase.a.contiguous(), erase.b.contiguous(),
                      erase.fades.contiguous())
        box = (ea.data_ptr(), eb.data_ptr(), ef.data_ptr(), erase.y0,
               erase.x0, ea.shape[0], ea.shape[1], MAXV)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(frames.data_ptr(), frames.stride(0), frames.stride(1),
                       b, h, w,
                       None if out is None else out.data_ptr(),
                       None if partials is None else partials.data_ptr(),
                       TILE_FIELD_ROWS, *box, stream)
    if rc != 0:
        raise RuntimeError(
            f"yadif_fieldmatch kernel launch failed (CUDA error {rc})")
    yadif_fieldmatch.launches[mode_name(write_frames, with_costs, erase)] += 1
    costs = deint.comb_mean(partials.sum(dim=0), h, w) if with_costs else None
    return out, costs


yadif_fieldmatch.launches = Counter()


def yadif_fieldmatch_plain(frames: torch.Tensor, *, write_frames: bool = True,
                           with_costs: bool = False,
                           erase: EraseBox | None = None):
    """The plain PyTorch version of the kernel (same arguments, same
    results): box erase with ops.logo.batched_delogo, yadif with
    ops.deint.yadif_deinterlace, costs with ops.deint.field_match_costs
    summed exactly in int64."""
    x = frames
    if erase is not None:
        bh, bw = erase.a.shape
        ys = slice(erase.y0, erase.y0 + bh)
        xs = slice(erase.x0, erase.x0 + bw)
        x = frames.clone()
        x[:, ys, xs] = batched_delogo(frames[:, ys, xs].float(), erase.a,
                                      erase.b, MAXV,
                                      erase.fades).to(torch.uint8)
    out = costs = None
    if write_frames:
        cur = x.float()
        prev = torch.cat([cur[:1], cur[:-1]])
        nxt = torch.cat([cur[1:], cur[-1:]])
        y = deint.yadif_deinterlace(prev, cur, nxt, True)
        out = torch.floor(y + 0.5).clamp(0, MAXV).to(torch.uint8)
    if with_costs:
        costs = deint.field_match_costs(x.to(torch.int64))
    return out, costs
