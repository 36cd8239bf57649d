"""Logo evaluation kernel wrapper, full-frame erase and logo-plane padding.

Counterpart of amatsukaze_tpu/ops/logo_pallas.py. `evaluate_logo` is the
drop-in for ops.logo.batched_evaluate_logo: on a CUDA tensor it launches
the hand-written kernel csrc/logo_eval.cu (which replaces the Pallas
kernel evaluate_logo_pallas), on a CPU tensor it runs that plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .logo import LogoEvalParams, batched_delogo, batched_evaluate_logo

# rows of the window per block: (16 + 4) x (W + 4) floats of shared memory,
# 20.8 KB for the 256-wide broadcast logo window
BAND_ROWS = 16

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = cuda_lib.load("logo_eval")
        fn = lib.amt_logo_eval
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i,
                       p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(params: LogoEvalParams, src: torch.Tensor,
           fades: torch.Tensor) -> None:
    if src.dim() != 3 or src.dtype != torch.float32:
        raise ValueError(f"src must be float32 [B, H, W], got "
                         f"{src.dtype} {tuple(src.shape)}")
    if fades.dim() != 1 or fades.dtype != torch.float32:
        raise ValueError("fades must be float32 [F]")
    h, w = src.shape[1:]
    tables = {"a_y": (h, w), "b_y": (h, w), "mask": (h, w),
              "kernels": (25, h, w), "scale": (32, h, w), "scale2": (32, h, w)}
    for name, shape in tables.items():
        t = getattr(params, name)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"params.{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != src.device:
            raise ValueError(f"params.{name} is on {t.device}, src on "
                             f"{src.device}")
    if fades.device != src.device:
        raise ValueError("fades and src must be on one device")


def evaluate_logo(params: LogoEvalParams, src: torch.Tensor, maxv: float,
                  fades: torch.Tensor) -> torch.Tensor:
    """Logo scores: src [B, H, W] float32 x fades [F] -> [B, F] float32."""
    _check(params, src, fades)
    if not src.is_cuda:
        return batched_evaluate_logo(params, src, maxv, fades)
    src = src.contiguous()
    fades = fades.contiguous()
    b, h, w = src.shape
    n_fades = fades.shape[0]
    n_bands = -(-h // BAND_ROWS)
    partials = torch.empty((b, n_fades, n_bands), dtype=torch.float32,
                           device=src.device)
    tabs = [params.a_y, params.b_y, params.kernels, params.scale,
            params.scale2, params.mask]
    if not all(t.is_contiguous() for t in tabs):
        raise ValueError("logo params must be contiguous")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(src.data_ptr(), fades.data_ptr(),
                       params.a_y.data_ptr(), params.b_y.data_ptr(),
                       params.kernels.data_ptr(), params.scale.data_ptr(),
                       params.scale2.data_ptr(), params.mask.data_ptr(),
                       float(maxv), b, n_fades, h, w, BAND_ROWS,
                       partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"logo_eval kernel launch failed (CUDA error {rc})")
    evaluate_logo.launches += 1
    return partials.sum(dim=-1) / params.black_score


evaluate_logo.launches = 0


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
