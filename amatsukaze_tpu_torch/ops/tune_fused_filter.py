"""Sweep the tile height of csrc/yadif_fieldmatch.cu on one CUDA card.

    python -m amatsukaze_tpu_torch.ops.tune_fused_filter

Times the kernel alone (fused_filter.launch_kernel, no wrapper) at the
broadcast shapes in every mode, for each tile height, with the inputs
rotating over more batches than the L2 holds: frames only on 34x1080x1440
and 34x540x720, costs only on 33x1080x1440, frames+costs on 32x1080x1440
without and with the 96x256 erase box, costs+erase. Prints the card's name
and power limit, the ptxas register counts, the time of a device-to-device
copy of the luma batch (the same bytes as yadif moves) and one line of
milliseconds per tile height (median of 7 windows of 20 launches). The
constants TILE_FIELD_ROWS and TILE_FIELD_ROWS_COSTS of ops/fused_filter.py
are the heights this sweep found fastest.
"""

from __future__ import annotations

import itertools
import statistics
import subprocess
import sys

import torch

from . import cuda_lib
from . import fused_filter as ff
from ..utils.synth_clip import logo_alpha

TILE_HEIGHTS = (4, 6, 8, 10, 12, 16, 20, 24, 32)


def time_ms(fn, iters: int = 20, repeats: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # the window is enqueued meanwhile
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return round(statistics.median(windows), 4)


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_fused_filter: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def frames(b, h, w):
        return torch.randint(0, 256, (b, h, w), generator=gen, device=dev,
                             dtype=torch.uint8)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    cuda_lib.build(["yadif_fieldmatch"])
    log = (cuda_lib.BUILD_DIR / "yadif_fieldmatch.log").read_text()
    print("registers per variant:",
          [ln.split("Used ")[1].split(" reg")[0]
           for ln in log.splitlines() if "Used " in ln])

    luma = [frames(34, 1080, 1440) for _ in range(4)]  # 212 MB
    chroma = [frames(34, 540, 720) for _ in range(10)]  # 132 MB
    out_y, out_uv = torch.empty_like(luma[0]), torch.empty_like(chroma[0])
    alpha = torch.from_numpy(logo_alpha(96, 256)).to(dev)
    box = ff.EraseBox(1.0 / (1.0 - alpha),
                      -alpha * 200.0 / (1.0 - alpha) / 255.0,
                      torch.rand(32, generator=gen, device=dev), 40, 1120)
    turn = itertools.count()

    def y(n):
        return luma[next(turn) % len(luma)][:n]

    def uv():
        return chroma[next(turn) % len(chroma)]

    print("device-to-device copy of 34x1080x1440:",
          time_ms(lambda: out_y.copy_(y(34))), "ms")
    saved = ff.TILE_FIELD_ROWS, ff.TILE_FIELD_ROWS_COSTS
    try:
        for rows in TILE_HEIGHTS:
            ff.TILE_FIELD_ROWS = ff.TILE_FIELD_ROWS_COSTS = rows
            parts = torch.empty((ff.tile_count(1080, rows), 34, 3),
                                dtype=torch.int64, device=dev)
            print(rows, dict(
                yadif_y=time_ms(lambda: ff.launch_kernel(
                    y(34), out_y, None, None)),
                yadif_uv=time_ms(lambda: ff.launch_kernel(
                    uv(), out_uv, None, None)),
                costs_y=time_ms(lambda: ff.launch_kernel(
                    y(33), None, parts, None)),
                yadif_costs_y=time_ms(lambda: ff.launch_kernel(
                    y(32), out_y, parts, None)),
                yadif_costs_erase_y=time_ms(lambda: ff.launch_kernel(
                    y(32), out_y, parts, box)),
                costs_erase_y=time_ms(lambda: ff.launch_kernel(
                    y(32), None, parts, box))), flush=True)
    finally:
        ff.TILE_FIELD_ROWS, ff.TILE_FIELD_ROWS_COSTS = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
