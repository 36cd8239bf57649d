"""Device-batch helper.

`pad_tail` pads a short final batch to the steady shape by repeating the
last element; callers slice the outputs back to the true length. Correct
whenever the op is local along the batch axis (per-frame maps, stencil
filters): appended copies cannot influence earlier outputs. Keeping one
batch shape keeps every kernel launch at the geometry it is measured at.
"""

from __future__ import annotations

import numpy as np


def pad_tail(items: list, batch: int):
    """(stacked_array, true_count): stack `items` and pad to `batch`
    rows by repeating the last item. No-op stack when already full."""
    n = len(items)
    arr = np.stack(items)
    if n >= batch:
        return arr, n
    pad = np.repeat(arr[-1:], batch - n, axis=0)
    return np.concatenate([arr, pad], axis=0), n
