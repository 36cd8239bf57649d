"""Where the time of one csrc/logo_eval.cu launch goes, on one CUDA card.

    python -m amatsukaze_tpu_torch.ops.profile_logo_eval

Builds the kernel with -DAMT_LOGO_EVAL_STAMPS (thread 0 of every block
notes the card's nanosecond timer at its begin and end, its SM's clock
after each phase and the SM's number) and launches it through the uint8
entry at the broadcast shape (32 frames, a 96x256 logo window) at 2 and
11 fades, with the kernel values in shared memory and in registers.
Prints the card's name and power limit and, per setting: when the blocks
began and ended after the first one began (percentiles, ns), the mean and
the largest count of SM clocks per phase (begin -> tiles filled -> taps
gathered and fades walked -> partials written and ticket drawn), how many
blocks each SM ran and when the SMs of each count were done. The stamps
cost a few stores per block; time the kernel with tune_logo_eval, not
with this.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import cuda_lib
from . import logo as lops
from . import logo_eval
from ..utils.synth_clip import logo_alpha
from .logo_ref import LogoEvalRef

BATCH, LOGO_H, LOGO_W = 32, 96, 256
STAMP_BLOCKS, STAMP_SLOTS = 4096, 8
PHASES = ("fill", "gather+fades", "ticket")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_logo_eval: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    lib = cuda_lib.load("logo_eval", ("-DAMT_LOGO_EVAL_STAMPS",))
    lib.amt_logo_eval_stamps.argtypes = [ctypes.c_void_p]
    logo_eval._fn = logo_eval.bind(lib)  # launch_kernel goes through it

    a = logo_alpha(LOGO_H, LOGO_W)
    ref = LogoEvalRef((1.0 / (1.0 - a)).astype(np.float32),
                      (-a * 200.0 / (1.0 - a) / 255.0).astype(np.float32))
    params = lops.LogoEvalParams.from_ref(ref, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    raw = torch.randint(0, 256, (BATCH, LOGO_H, LOGO_W), generator=gen,
                        device=dev, dtype=torch.uint8)
    n_blocks = BATCH * (params.pos.shape[0] // params.chunk)
    if n_blocks > STAMP_BLOCKS:
        raise ValueError("more blocks than the kernel keeps stamps for")
    for in_regs in (False, True):
        for n_fades in (2, 11):
            fades = torch.linspace(0, 1, n_fades, device=dev)
            for _ in range(5):
                logo_eval.launch_kernel(params, raw, 255.0, fades,
                                        kernels_in_registers=in_regs)
            torch.cuda.synchronize()
            out = np.zeros((STAMP_BLOCKS, STAMP_SLOTS), np.int64)
            if lib.amt_logo_eval_stamps(out.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            st = out[:n_blocks]
            begin = st[:, 0] - st[:, 0].min()
            end = st[:, 7] - st[:, 0].min()
            clocks = np.diff(st[:, [1, 3, 4, 5]], axis=1)
            print(f"kernel values in "
                  f"{'registers' if in_regs else 'shared memory'}, "
                  f"F={n_fades}, {n_blocks} blocks of {params.chunk}: "
                  f"began [0, 50, 90, 100%] "
                  f"{np.percentile(begin, [0, 50, 90, 100]).tolist()} ns, "
                  f"ended {np.percentile(end, [0, 50, 90, 100]).tolist()} ns;"
                  f" SM clocks per phase "
                  + ", ".join(f"{name} mean {clocks[:, k].mean():.0f} max "
                              f"{clocks[:, k].max()}"
                              for k, name in enumerate(PHASES))
                  + f"; clocks per ns "
                    f"{clocks.sum(1).mean() / (st[:, 7] - st[:, 0]).mean():.2f}"
                    f" (blocks that add a frame up end later)")
            per_sm = np.bincount(st[:, 6].astype(np.int64))
            for count in np.unique(per_sm[per_sm > 0]):
                sms = np.flatnonzero(per_sm == count)
                done = [end[st[:, 6] == sm].max() for sm in sms]
                print(f"    {len(sms)} SMs ran {count} blocks: done at "
                      f"{np.mean(done):.0f} ns on average, "
                      f"{min(done)}-{max(done)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
