"""Carry state across from the JAX package as plain numpy.

The port imports nothing of amatsukaze_tpu; a caller that holds the JAX
package's objects passes their fields as numpy arrays (np.asarray of a JAX
array works) and gets the port's objects, so both packages compute on the
same data.
"""

from __future__ import annotations

import numpy as np

from .models.lgd import LogoData, LogoHeader
from .ops.logo import LogoEvalParams
from .utils.device import resolve_device

_PARAM_FIELDS = ("a_y", "b_y", "mask", "kernels", "scale", "scale2",
                 "black_score")
_HEADER_FIELDS = ("w", "h", "log_uv_x", "log_uv_y", "imgw", "imgh", "imgx",
                  "imgy", "name", "service_id")
_PLANES = ("a_y", "b_y", "a_u", "b_u", "a_v", "b_v")


def _fields(obj, names) -> dict:
    return {n: getattr(obj, n) for n in names}


def logo_params_from_numpy(d, device=None) -> LogoEvalParams:
    """JAX LogoEvalParams (any object with its fields as attributes):
    kernels [H, W, 25], scale/scale2 [H, W, 32], a_y/b_y/mask [H, W],
    black_score -> the port's params in the kernel's tap-major and
    bucket-major layout, on `device`."""
    return LogoEvalParams.from_numpy(
        {k: np.asarray(v) for k, v in _fields(d, _PARAM_FIELDS).items()},
        resolve_device(device))


def logo_data_from_numpy(logo) -> LogoData:
    """JAX LogoData (header + float32 A/B planes) -> the port's LogoData."""
    header = LogoHeader(**_fields(logo.header, _HEADER_FIELDS))
    planes = {k: np.array(v, np.float32)
              for k, v in _fields(logo, _PLANES).items()}
    return LogoData(header=header, **planes)
