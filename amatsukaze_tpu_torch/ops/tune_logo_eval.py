"""Sweep the launch shape of csrc/logo_eval.cu on one CUDA card.

    python -m amatsukaze_tpu_torch.ops.tune_logo_eval [--chain-only]

At the broadcast shape (32 frames, a 96x256 logo window, 2 and 11 fade
steps) it times one launch of the kernel (logo_eval.launch_kernel: the
kernel with the allocation of its outputs) for every threads-per-block =
entries per compacted chunk (64, 128, 256), fades per block (1..11) and
place of a pixel's 25 kernel values (registers, or shared memory
for a fifth block per SM), through the float32 entry and the
uint8 entry (DeintY inside). Prints the card's name and power limit, the
ptxas register counts, and one line of milliseconds per setting (median
of 7 windows of 40 launches, the card kept busy while a window is
enqueued). The constants ITEMS_PER_BLOCK of ops/logo.py and
FADES_PER_BLOCK of ops/logo_eval.py are what this sweep found fastest,
and its rule for where the kernel values live is what the 24-frame and
32-frame lines show.

Last it times the unfused chain that the uint8 entry replaces, upload
excluded: window.float(), batched_deint_y, evaluate_logo. With
--chain-only it does nothing else and uses only calls that the kernel's
earlier design had too, so the same file times that design's chain when
it is run from a checkout of it.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from . import cuda_lib
from . import logo as lops
from . import logo_eval
from ..utils.synth_clip import logo_alpha
from .logo_ref import LogoEvalRef
from .tune_fused_filter import time_ms

BATCH, LOGO_H, LOGO_W = 32, 96, 256
THREADS = (64, 128, 256)
FADES_PER_BLOCK = (1, 2, 3, 4, 6, 11)


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_logo_eval: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    a = logo_alpha(LOGO_H, LOGO_W)
    ref = LogoEvalRef((1.0 / (1.0 - a)).astype(np.float32),
                      (-a * 200.0 / (1.0 - a) / 255.0).astype(np.float32))
    raw = torch.randint(0, 256, (BATCH, LOGO_H, LOGO_W), generator=gen,
                        device=dev, dtype=torch.uint8)
    all_fades = {n: torch.linspace(0, 1, n, device=dev) for n in (2, 11)}

    params = lops.LogoEvalParams.from_ref(ref, dev)
    for n, fades in all_fades.items():
        ms = time_ms(lambda: logo_eval.evaluate_logo(
            params, lops.batched_deint_y(raw.float()), 255.0, fades), 8)
        print(f"unfused chain (float, batched_deint_y, evaluate_logo) "
              f"F={n}: {ms} ms", flush=True)
    if "--chain-only" in sys.argv[1:]:
        return 0

    log = (cuda_lib.BUILD_DIR / "logo_eval.log").read_text()
    print("registers per variant:",
          [ln.split("Used ")[1].split(" reg")[0]
           for ln in log.splitlines() if "Used " in ln])
    deint = lops.batched_deint_y(raw.float())
    for n, fades in all_fades.items():
        ms = time_ms(lambda: logo_eval.launch_kernel(
            params, raw[:1], 255.0, fades, fades_per_block=n), 40)
        print(f"one frame alone (a launch and one block's chain of work) "
              f"F={n}: {ms} ms")
    # 24 frames are 480 blocks of 128 threads: four blocks per SM take them
    # at once, so the kernel values can stay in registers
    for in_regs in (True, False):
        line = {n: time_ms(lambda: logo_eval.launch_kernel(
            params, raw[:24], 255.0, fades, fades_per_block=n,
            kernels_in_registers=in_regs), 40)
            for n, fades in all_fades.items()}
        print(f"24 frames, threads {params.chunk}, kernel values "
              f"{'in registers' if in_regs else 'in shared memory'}, uint8 "
              f"entry, by fades: {line}")
    for threads in THREADS:
        params = lops.LogoEvalParams.from_ref(ref, dev, threads)
        print(f"threads {threads}: {params.n_items} masked pixels in "
              f"{params.pos.shape[0] // threads} chunks, the largest box "
              f"{params.tile_elems} pixels, all boxes "
              f"{int((params.boxes[:, 1] * params.boxes[:, 3]).sum())}")
        for in_regs in (True, False):
            if threads == 256 and not in_regs:
                continue  # no such variant: 3 blocks of 256 leave 85 registers
            for n, fades in all_fades.items():
                for per_block in FADES_PER_BLOCK:
                    if per_block > n:
                        continue
                    line = {
                        name: time_ms(lambda: logo_eval.launch_kernel(
                            params, x, 255.0, fades,
                            fades_per_block=per_block,
                            kernels_in_registers=in_regs), 40)
                        for name, x in (("float32", deint), ("uint8", raw))}
                    print(f"threads {threads} kernel values "
                          f"{'in registers' if in_regs else 'in shared memory'} "
                          f"F={n} fades/block {per_block}: {line}",
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
