"""Helpers of the port's front-end tests: values of the JAX package and of
the port as comparable primitives, and both packages' native libraries
loaded alike."""

import dataclasses
import enum

import numpy as np


def plain(x):
    """A value as comparable primitives: class names and fields of
    dataclasses and objects, enum names and values, bytes, arrays."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if hasattr(x, "__slots__") or hasattr(x, "__dict__"):
        names = list(getattr(x, "__slots__", ())) + list(
            getattr(x, "__dict__", {}))
        return (type(x).__name__, {k: plain(getattr(x, k)) for k in names})
    return x


def load_both_native() -> bool:
    """Load native/libamatsukaze_native.so in both packages (each runs
    `make` first); True when both have it. Another test process may be
    rebuilding the library while one of them loads it: that one tries
    again, so that both sides run the same engines."""
    from amatsukaze_tpu.ts import native as jnative
    from amatsukaze_tpu_torch.ts import native as tnative

    have = (False, False)
    for _ in range(3):
        have = (tnative.load_native() is not None,
                jnative.load_native() is not None)
        if have[0] == have[1]:
            break
        for ok, mod in zip(have, (tnative, jnative)):
            if not ok:
                mod._load_attempted = False
    return all(have)
