"""Logo evaluation kernel wrapper, full-frame erase and logo-plane padding.

Counterpart of amatsukaze_tpu/ops/logo_pallas.py. `evaluate_logo` is the
drop-in for ops.logo.batched_evaluate_logo (deinterlaced float32 windows,
the TPU kernel's contract) and `evaluate_logo_u8` for
ops.logo.batched_deint_evaluate_logo (the raw uint8 windows as the matcher
cuts them; DeintY happens while the kernel loads them). On a CUDA tensor
either is one launch of the hand-written kernel csrc/logo_eval.cu (which
replaces the Pallas kernel evaluate_logo_pallas), on a CPU tensor they run
the plain versions.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_lib
from .logo import (LogoEvalParams, batched_deint_evaluate_logo,
                   batched_delogo, batched_evaluate_logo)

# fades one block walks; more fades are split over blocks (the kernel's
# limit is 16). tune_logo_eval sweeps this beside LogoEvalParams.chunk:
# splitting the 11 fades of the main path only repeats the tile fill
FADES_PER_BLOCK = 16
# threads of the kernel an SM holds at once when each keeps its pixel's 25
# kernel values in registers (at most 128 registers a thread); with the
# values in shared memory it holds 640, for one load more per tap and fade.
# A launch that fits in one round of the first kind takes it; a larger one
# would need a second round and takes the second kind (tune_logo_eval on an
# NVIDIA H100 80GB HBM3 at 700 W, 11 fades of a 96x256 logo: 24 frames take
# 0.0129 ms from registers and 0.0139 from shared memory, 32 frames 0.0183
# and 0.0161)
THREADS_PER_SM_IN_REGISTERS = 512
SHARED_BYTES_MAX = 227 * 1024

_fn = None
_tickets: dict[tuple, torch.Tensor] = {}
# guards _tickets and the launch count: callers may launch from threads
_lock = threading.Lock()
# the first calls of several threads bind once, and _fn is set only once
# the signature is
_bind_lock = threading.Lock()


def bind(lib: ctypes.CDLL):
    """The launch function of a built csrc/logo_eval.cu."""
    fn = lib.amt_logo_eval
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, f, f, i, i, i, i, i, i, i,
                   i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        with _bind_lock:
            if _fn is None:
                _fn = bind(cuda_lib.load("logo_eval"))
    return _fn


def _check(params: LogoEvalParams, src: torch.Tensor, fades: torch.Tensor,
           dtype: torch.dtype) -> None:
    if src.dim() != 3 or src.dtype != dtype:
        raise ValueError(f"src must be {dtype} [B, H, W], got "
                         f"{src.dtype} {tuple(src.shape)}")
    if fades.dim() != 1 or fades.dtype != torch.float32:
        raise ValueError("fades must be float32 [F]")
    h, w = src.shape[1:]
    m = params.pos.shape[0]
    tables = {"a_y": (h, w), "b_y": (h, w), "mask": (h, w),
              "kernels": (25, h, w), "scale": (32, h, w), "scale2": (32, h, w),
              "weight": (m,), "kernels_c": (25, m), "scale_c": (32, m),
              "scale2_c": (32, m), "pos": (m,),
              "boxes": (m // params.chunk, 4)}
    for name, shape in tables.items():
        t = getattr(params, name)
        want = torch.int32 if name in ("pos", "boxes") else torch.float32
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"params.{name} must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != src.device:
            raise ValueError(f"params.{name} is on {t.device}, src on "
                             f"{src.device}")
    if fades.device != src.device:
        raise ValueError("fades and src must be on one device")


def _ticket_counters(batch: int, device: torch.device,
                     stream: int) -> torch.Tensor:
    """One int32 counter per frame, zero between launches (the kernel sets
    them back). Kept per device and stream: launches on one stream run one
    after the other.

    Several threads share a stream's counters (the server's concurrent
    jobs and its logo scan all launch on the device's default stream), and
    that holds only because their launches run in that stream's order: a
    launch sees the counters its predecessor set back to zero. Two
    launches that ran at once on one counter tensor would corrupt it, so
    the key holds the stream. A larger batch replaces the tensor while
    launches queued before may still read the old one: the caching
    allocator reuses the old memory only for work queued on the same
    stream after them."""
    key = (device.index, stream)
    with _lock:
        t = _tickets.get(key)
        if t is None or t.shape[0] < batch:
            t = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
            _tickets[key] = t
        return t


def launch_kernel(params: LogoEvalParams, src: torch.Tensor, maxv: float,
                  fades: torch.Tensor, values: torch.Tensor | None = None,
                  fades_per_block: int | None = None,
                  kernels_in_registers: bool | None = None) -> torch.Tensor:
    """One launch of csrc/logo_eval.cu on checked operands: src [B, H, W]
    float32 or uint8 on the card -> scores [B, F]. `values` ([B, F, M]
    float32), where given, receives every compacted entry's share of the
    raw score."""
    b, h, w = src.shape
    n_fades = fades.shape[0]
    if params.n_items == 0:  # nothing is masked: no pixel to launch for
        return torch.zeros((b, n_fades), dtype=torch.float32,
                           device=src.device) / params.black_score
    src = src.contiguous()
    fades = fades.contiguous()
    tabs = [params.a_y, params.b_y, params.pos, params.weight,
            params.kernels_c, params.scale_c, params.scale2_c, params.boxes]
    if not all(t.is_contiguous() for t in tabs):
        raise ValueError("logo params must be contiguous")
    if 8 * params.tile_elems + 100 * params.chunk > SHARED_BYTES_MAX:
        raise ValueError(f"a {w} wide logo window needs more shared memory "
                         f"than a block can have")
    m = params.pos.shape[0]
    per_block = min(FADES_PER_BLOCK if fades_per_block is None
                    else fades_per_block, n_fades)
    in_regs = kernels_in_registers
    if in_regs is None:
        n_sm = torch.cuda.get_device_properties(
            src.device).multi_processor_count
        in_regs = (b * m * -(-n_fades // per_block)
                   <= THREADS_PER_SM_IN_REGISTERS * n_sm
                   or params.chunk == 256)  # 256 threads: the one variant
    partials = torch.empty((b, n_fades, m // params.chunk),
                           dtype=torch.float32, device=src.device)
    scores = torch.empty((b, n_fades), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _ticket_counters(b, src.device, stream)
        rc = _kernel()(
            src.data_ptr(), int(src.dtype == torch.uint8), fades.data_ptr(),
            params.a_y.data_ptr(), params.b_y.data_ptr(),
            params.pos.data_ptr(), params.boxes.data_ptr(),
            params.weight.data_ptr(), params.kernels_c.data_ptr(),
            params.scale_c.data_ptr(), params.scale2_c.data_ptr(),
            float(maxv), params.black_score, b,
            n_fades, per_block, h, w, m, params.chunk, int(in_regs),
            params.tile_elems, partials.data_ptr(),
            None if values is None else values.data_ptr(),
            tickets.data_ptr(), scores.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"logo_eval kernel launch failed (CUDA error {rc})")
    count_launch()
    return scores


def evaluate_logo(params: LogoEvalParams, src: torch.Tensor, maxv: float,
                  fades: torch.Tensor) -> torch.Tensor:
    """Logo scores: src [B, H, W] float32 x fades [F] -> [B, F] float32."""
    _check(params, src, fades, torch.float32)
    if not src.is_cuda:
        return batched_evaluate_logo(params, src, maxv, fades)
    return launch_kernel(params, src, maxv, fades)


# launches of the kernel, by either entry
evaluate_logo.launches = 0


def count_launch() -> None:
    """One more launch (evaluate_logo.launches), under the lock: callers may
    launch from several threads."""
    with _lock:
        evaluate_logo.launches += 1


def evaluate_logo_u8(params: LogoEvalParams, window: torch.Tensor,
                     maxv: float, fades: torch.Tensor) -> torch.Tensor:
    """DeintY + logo scores in one launch: the raw window [B, H, W] uint8 x
    fades [F] -> [B, F] float32, bit-equal per pixel to
    evaluate_logo(params, batched_deint_y(window.float()), ...)."""
    _check(params, window, fades, torch.uint8)
    if not window.is_cuda:
        return batched_deint_evaluate_logo(params, window, maxv, fades)
    return launch_kernel(params, window, maxv, fades)


# the erase over identity-padded full-frame planes (A=1, B=0 outside the
# logo), as logo_pallas.delogo_full_frame: frames [B, H, W] float32, fades [B]
delogo_full_frame = batched_delogo


def pad_logo_planes(a, b, height: int, width: int, imgx: int, imgy: int):
    """Embed window A/B planes into identity full-frame planes (numpy)."""
    a_full = np.ones((height, width), np.float32)
    b_full = np.zeros((height, width), np.float32)
    lh, lw = a.shape
    a_full[imgy : imgy + lh, imgx : imgx + lw] = np.asarray(a)
    b_full[imgy : imgy + lh, imgx : imgx + lw] = np.asarray(b)
    return a_full, b_full
