"""Device selection for the port's entry points, and the host<->device
copies of the main path, which count their bytes into the recording's
trace (utils/perf.py): `h2d.pageable_bytes` / `h2d.pinned_bytes` and
`d2h.bytes`, only for a copy that crosses devices."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` selects the plain PyTorch
    versions of the kernels (the tests). Asking for CUDA without a card
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def to_device(x, device, trace=None) -> torch.Tensor:
    """`x` (a numpy array or a host tensor) on `device`, as `.to(device)`
    copies it."""
    src = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    out = src.to(device)
    if trace is not None and out.device != src.device:
        pinned = src.device.type == "cpu" and src.is_pinned()
        trace.add("h2d.pinned_bytes" if pinned else "h2d.pageable_bytes",
                  src.nbytes)
    return out


def to_host(t: torch.Tensor, trace=None) -> np.ndarray:
    """`t` as a numpy array, fetched with `.cpu()` when it lives on a
    device."""
    out = t.cpu()
    if trace is not None and t.device.type != "cpu":
        trace.add("d2h.bytes", out.nbytes)
    return out.numpy()
