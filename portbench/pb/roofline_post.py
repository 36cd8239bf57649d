"""The least time the card could take for the work of the post chain and
the resize of a cell (the configuration's `--post-filter` tokens and
`--resize`), counted from the cell's shapes and frame counts, not from
launches, so that it reads the same work whatever implements a stage:
each stage reads its planes once and writes them once in float32 (the
resize reads the source size and writes the output size), and deband
also hashes one threefry2x32-20 draw a pixel and sample step (its
candidate index: randint(0, 8) needs only the low draw). A draw is 20
rounds of an add, a rotate and an xor plus the five key injections (two
adds each): 70 integer operations, at a quarter of the float32 peak (64
INT32 lanes a Hopper SM against 128 FP32 ones, an FMA counting two). The
other arithmetic of each stage (the DCTs, the compares and sums) is left
out: a lower bound of the work, so the share can only read low."""

from __future__ import annotations

from . import roofline

INT32_OPS_PER_S = roofline.FP32_OPS_PER_S / 4
THREEFRY_OPS = 20 * 3 + 5 * 2
DEBAND_SAMPLE = 2
STAGES = ("deblock", "nr", "deband", "edge", "resize")


def chain_of(config: dict) -> tuple:
    """(post-filter tokens, (width, height) of the resize or None) of a
    configuration's CLI flags."""
    args = config.get("cli_args", [])
    tokens, size = set(), None
    for flag, value in zip(args, args[1:]):
        if flag == "--post-filter":
            tokens = {t.strip() for t in value.split(",") if t.strip()}
        elif flag == "--resize":
            size = tuple(int(v) for v in value.lower().split("x"))
    return tokens, size


def chain_seconds(n_frames: int, h: int, w: int, tokens, size) -> float:
    """Least seconds for n_frames 4:2:0 frames of h x w through the
    stages `tokens` and a resize to `size` (width, height; None: none)."""
    px = n_frames * h * w * 3 // 2
    total = 0.0
    for stage in ("deblock", "nr", "deband", "edge"):
        if stage not in tokens:
            continue
        ops = DEBAND_SAMPLE * THREEFRY_OPS * px if stage == "deband" else 0
        total += max(8 * px / roofline.HBM_BYTES_PER_S,
                     ops / INT32_OPS_PER_S)
    if size is not None and tuple(size) != (w, h):
        out_px = n_frames * size[0] * size[1] * 3 // 2
        total += 4 * (px + out_px) / roofline.HBM_BYTES_PER_S
    return total
