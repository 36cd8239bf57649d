"""The control of `correct`: the reference put in the program's place,
computed one precision below the configuration's (bfloat16 where it states
float32), and judged by the same numbers and limits. Where a cell's path
holds no arithmetic that a lower precision changes (no logo: the frames are
woven bytes), the control breaks the guarantee the configuration states
instead, as its family gives it (`guarantee_control`; kfm_vfr: the coded
frames go out as they are, at 30p, with no telecine removed). Both are
worked out for every cell.

    python3 portbench/pb/control.py --workload <cell> --seeds 1,2,3

prints, per seed, the numbers and whether they are judged correct (they
must not be). Runs on the card; --device cpu rehearses it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "pb"

from . import compare, harness, traffic  # noqa: E402
from .spec import load_cell, load_family  # noqa: E402

LOWER = torch.bfloat16


def served(frames: dict, n_out: int) -> dict:
    return dict(header="", n_frames=n_out, digests=[], frames=frames)


def control_numbers(cell, seed: int, device="cuda", geometry=None) -> dict:
    """{"lower": numbers of the bfloat16 reference, "guarantee": numbers of
    the family's guarantee-breaking program} against the float32
    reference."""
    geometry = geometry or cell.config["geometry"]
    family = load_family(cell)
    rec = traffic.ensure_recording(cell.traffic_name, cell.traffic, geometry,
                                   seed)
    ref = harness.reference_for(cell, rec, geometry, device=device)
    low = harness.reference_for(cell, rec, geometry, dtype=LOWER,
                                device=device)
    keep = harness.sample_for(ref, seed)
    expected = ref.frames(keep)
    truth = rec["truth"]
    cm = [dict(trims=truth["trims"], cm_zones=truth["cm_zones"],
               logo_file=truth["painted_logo_file"])]
    got = {i: v[0][0] for i, v in low.frames(keep).items()}
    out = {"lower": family.numbers(ref, expected,
                                   [served(got, ref.num_out)],
                                   cm, [ref.filter_result()])}
    frames, n, filt = family.guarantee_control(ref, keep)
    out["guarantee"] = family.numbers(ref, expected, [served(frames, n)], cm,
                                      filt)
    return out


def judged(nums: dict, limits: dict) -> bool:
    return compare.judge(nums, limits, 0)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of correct")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = control_numbers(cell, seed, args.device)
        for kind, nums in res.items():
            print(json.dumps(dict(workload=cell.name, seed=seed, control=kind,
                                  numbers=nums, correct=judged(
                                      nums, cell.limits))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
