"""yadif + field-match costs (+ optional box erase) over uint8 frame batches.

Counterpart of amatsukaze_tpu/ops/fused_filter.py. The JAX package has two
Pallas kernels for one function (make_fused_filter in frame layout,
make_fused_filter_field in a lane-merged field layout with costs-only and
logo-box modes); the TPU's (8, 128) tiling chose between them. Here one
hand-written CUDA kernel, csrc/yadif_fieldmatch.cu, takes the logical frame
through its row stride (16-byte accesses where the pointers and strides
allow them, byte accesses otherwise), with flags for what to write:

- ``write_frames``: the yadif output (top field kept, bottom rebuilt; or,
  with ``parity_top=False``, the bottom field kept and the top rebuilt,
  frames only: the field-match costs are defined on the top field);
- ``with_costs``: the three field-match costs per frame, [B, 3];
- ``erase``: a logo box erased as the pixels are loaded (fused_logo).

On a CUDA tensor `yadif_fieldmatch` launches the kernel; on a CPU tensor it
runs `yadif_fieldmatch_plain`, the same function from ops.deint and
ops.logo. Frame 0's previous frame and the last frame's next frame are the
frames themselves, as in the Pallas kernels' batch-edge clamping.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from dataclasses import dataclass

import torch

from . import cuda_lib
from . import deint
from .logo import batched_delogo

MAXV = 255.0  # 8-bit samples

# field rows per block. Frames only: 68 tiles x 34 frames = 2312 blocks for a
# 1080-row luma batch, 34 x 34 = 1156 for 540-row chroma (8.8 per SM on 132
# SMs). With cost sums a taller tile is faster (fewer halo rows and block
# reductions), and 24 rows make the analysis pass 23 x 33 = 759 blocks, just
# under two full rounds of the 396 that are resident at once (16 rows: 1122
# blocks, 2.8 rounds, 5% slower). Measured on the H100 against 4 to 32 rows
# (PERF.md).
TILE_FIELD_ROWS = 8
TILE_FIELD_ROWS_COSTS = 24
WORD = 16  # pixels a thread loads at once (one 16-byte access)
MAX_THREADS = 256  # per block
MAX_THREADS_ALL = 192  # frames, costs and erase at once (more registers)
# products of at most 255^2 that a uint32 holds: the kernel keeps a thread's
# cost sums in 32 bits
MAX_U32_PRODUCTS = (2 ** 32 - 1) // (255 * 255)


def tile_rows_for(with_costs: bool) -> int:
    """Field rows per block for a mode of the kernel."""
    return TILE_FIELD_ROWS_COSTS if with_costs else TILE_FIELD_ROWS


def max_threads_for(write_frames: bool, with_costs: bool, erase: bool) -> int:
    """Threads a block may have in a mode of the kernel."""
    if write_frames and with_costs and erase:
        return MAX_THREADS_ALL
    return MAX_THREADS


def tile_count(height: int, tile_rows: int) -> int:
    """Blocks along the field rows of H-row frames: one partial cost sum
    each, partials [tile_count, B, 3]."""
    return -(-(height // 2) // tile_rows)


def launch_geometry(width: int, tile_rows: int,
                    max_threads: int = MAX_THREADS):
    """(strips, threads) of a block: its tile of `tile_rows` field rows is
    cut into `strips` row strips of ceil(width / 16) threads, each thread
    walking its strip's rows over its own 16 columns. strips is the largest
    power of two that fits max_threads (1 for rows wider than
    16 * max_threads, whose threads then loop over column chunks)."""
    n_words = -(-width // WORD)
    strips = 1
    while strips * 2 * n_words <= max_threads and strips * 2 <= tile_rows:
        strips *= 2
    threads = min(max_threads, -(-(n_words * strips) // 32) * 32)
    return strips, threads


def products_per_thread(width: int, tile_rows: int,
                        max_threads: int = MAX_THREADS) -> int:
    """The most products one thread adds into one of its uint32 cost sums:
    six per pixel of every word and field row it walks (three sums of
    products for each of the two woven rows). Must stay below
    MAX_U32_PRODUCTS."""
    strips, threads = launch_geometry(width, tile_rows, max_threads)
    rows = -(-tile_rows // strips)
    chunks = -(-(-(-width // WORD) * strips) // threads)
    return 6 * WORD * rows * chunks


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
# pipelines on several threads (the server's jobs) may make the first call
# at once: one of them binds, and _fn is set only once the signature is
_bind_lock = threading.Lock()


def _kernel():
    global _fn
    if _fn is None:
        with _bind_lock:
            if _fn is None:
                lib = cuda_lib.load("yadif_fieldmatch")
                fn = lib.amt_yadif_fieldmatch
                p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                fn.argtypes = [p, ll, ll, i, i, i, p, p, i, i, i, p, p, p, i,
                               i, i, i, ctypes.c_float, i, p]
                fn.restype = ctypes.c_int
                _fn = fn
    return _fn


def mode_name(write_frames: bool, with_costs: bool, erase,
              parity_top: bool = True) -> str:
    """Launch-count key: 'yadif', 'costs' or 'yadif+costs', '+erase';
    'yadif_bottom' with the bottom field kept."""
    if not parity_top:
        return "yadif_bottom"
    parts = [n for n, on in (("yadif", write_frames), ("costs", with_costs),
                             ("erase", erase is not None)) if on]
    return "+".join(parts)


def _check(frames: torch.Tensor, write_frames: bool, with_costs: bool,
           erase: EraseBox | None, parity_top: bool = True) -> None:
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
    if not parity_top and (with_costs or erase is not None
                           or not write_frames):
        raise ValueError("parity_top=False is the frames-only mode: no "
                         "costs and no erase")
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


def launch_kernel(frames: torch.Tensor, out: torch.Tensor | None,
                  partials: torch.Tensor | None,
                  erase: EraseBox | None, parity_top: bool = True) -> None:
    """Enqueue the CUDA kernel on the current stream: `out` contiguous uint8
    [B, H, W] or None, `partials` contiguous int64
    [tile_count(H, tile_rows_for(True)), B, 3] or None (already checked
    arguments; yadif_fieldmatch is the entry point)."""
    b, h, w = frames.shape
    tile_rows = tile_rows_for(partials is not None)
    max_threads = max_threads_for(out is not None, partials is not None,
                                  erase is not None)
    strips, threads = launch_geometry(w, tile_rows, max_threads)
    if partials is not None and (
            products_per_thread(w, tile_rows, max_threads) > MAX_U32_PRODUCTS):
        raise ValueError(f"frames {w} wide overflow the kernel's 32-bit "
                         f"cost sums")
    box = (None, None, None, 0, 0, 0, 0, MAXV)
    if erase is not None:
        ea, eb, ef = (erase.a.contiguous(), erase.b.contiguous(),
                      erase.fades.contiguous())
        box = (ea.data_ptr(), eb.data_ptr(), ef.data_ptr(), erase.y0,
               erase.x0, ea.shape[0], ea.shape[1], MAXV)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(frames.data_ptr(), frames.stride(0), frames.stride(1),
                       b, h, w,
                       None if out is None else out.data_ptr(),
                       None if partials is None else partials.data_ptr(),
                       tile_rows, strips, threads, *box, int(parity_top),
                       stream)
    if rc != 0:
        raise RuntimeError(
            f"yadif_fieldmatch kernel launch failed (CUDA error {rc})")


def yadif_fieldmatch(frames: torch.Tensor, *, write_frames: bool = True,
                     with_costs: bool = False, erase: EraseBox | None = None,
                     parity_top: bool = True):
    """frames uint8 [B, H, W] (H even; rows may be strided) ->
    (filtered uint8 [B, H, W] or None, costs float32 [B, 3] or None).
    parity_top=False keeps the bottom field (frames only)."""
    _check(frames, write_frames, with_costs, erase, parity_top)
    if not frames.is_cuda:
        return yadif_fieldmatch_plain(frames, write_frames=write_frames,
                                      with_costs=with_costs, erase=erase,
                                      parity_top=parity_top)
    b, h, w = frames.shape
    dev = frames.device
    out = (torch.empty((b, h, w), dtype=torch.uint8, device=dev)
           if write_frames else None)
    n_tiles = tile_count(h, tile_rows_for(with_costs))
    partials = (torch.empty((n_tiles, b, 3), dtype=torch.int64, device=dev)
                if with_costs else None)
    launch_kernel(frames, out, partials, erase, parity_top)
    count_launch(mode_name(write_frames, with_costs, erase, parity_top))
    costs = None
    if with_costs:
        # the tiles' integer sums, exact in float64 (far below 2^53), then
        # deint.comb_mean's division and rounding in one call
        total = partials.sum(dim=0, dtype=torch.float64)
        costs = torch.empty((b, 3), dtype=torch.float32, device=dev)
        torch.div(total, (h - 2) * w, out=costs)
    return out, costs


yadif_fieldmatch.launches = Counter()
_count_lock = threading.Lock()


def count_launch(mode: str) -> None:
    """One more launch in `mode` (yadif_fieldmatch.launches). Under a lock:
    the autovfr analysis launches from several threads, and a Counter's
    += is a read-modify-write."""
    with _count_lock:
        yadif_fieldmatch.launches[mode] += 1


def yadif_fieldmatch_plain(frames: torch.Tensor, *, write_frames: bool = True,
                           with_costs: bool = False,
                           erase: EraseBox | None = None,
                           parity_top: bool = True):
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
        y = deint.yadif_deinterlace(prev, cur, nxt, parity_top)
        out = torch.floor(y + 0.5).clamp(0, MAXV).to(torch.uint8)
    if with_costs:
        costs = deint.field_match_costs(x.to(torch.int64))
    return out, costs
