"""Every compared number of both cells, held to a record: on the CPU
rehearsal's seeds, under the faults planted under the timed path, and of
both controls. A change to the reference or the comparison that is meant
to move no number (a move of the code, a new layout of the harness) shows
here as equal or not. `PYTHONPATH=portbench:. python
portbench/tests/test_portbench_compared_record.py --write` records them
anew (portbench/tests/kfm_vfr_compared.json)."""

import json
import sys
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import pytest
import torch

from pb.spec import load_cell, load_json
from test_portbench_rehearsal import (  # noqa: F401 (fixtures)
    BENCH, SMALL, altered_output, bob_everything, drop_half, few_threads,
    flip_a_pixel, no_erase, own_cache, rehearse,
    second_recording_altered_off_the_sample, shifted_trims)

RECORDED = Path(__file__).with_name("kfm_vfr_compared.json")
CELLS = ("kfm_vfr.cm_logo", "kfm_vfr.nologo")
FAULTS = dict(flip_a_pixel=lambda: altered_output(flip_a_pixel),
              drop_half=lambda: altered_output(drop_half),
              shifted_trims=shifted_trims, no_erase=no_erase,
              bob_everything=bob_everything,
              second_recording=second_recording_altered_off_the_sample)
# case: (cell, seed, fault or None, recordings in the window)
CASES = {f"{cell}.seed{seed}": (cell, seed, None, 2)
         for cell in CELLS for seed in (5, 6, 7)}
CASES.update({
    "kfm_vfr.cm_logo.flip_a_pixel": ("kfm_vfr.cm_logo", 5, "flip_a_pixel", 1),
    "kfm_vfr.nologo.flip_a_pixel": ("kfm_vfr.nologo", 5, "flip_a_pixel", 1),
    "kfm_vfr.cm_logo.drop_half": ("kfm_vfr.cm_logo", 5, "drop_half", 1),
    "kfm_vfr.cm_logo.shifted_trims": ("kfm_vfr.cm_logo", 5, "shifted_trims",
                                      1),
    "kfm_vfr.cm_logo.no_erase": ("kfm_vfr.cm_logo", 5, "no_erase", 1),
    "kfm_vfr.nologo.bob_everything": ("kfm_vfr.nologo", 5, "bob_everything",
                                      1),
    "kfm_vfr.nologo.second_recording": ("kfm_vfr.nologo", 5,
                                        "second_recording", 2)})
CONTROL_SEED = 17


def exactly(n: int):
    """The window runs exactly n recordings, however fast they go."""
    from pb import window

    orig = window.run_sequential

    def run(run_one, frames, seconds, clock, minimum=1):
        return orig(run_one, frames, 0.0, clock, minimum=n)

    return mock.patch.object(window, "run_sequential", run)


def case_numbers(case: str) -> dict:
    cell, seed, fault, n = CASES[case]
    with exactly(n), (FAULTS[fault]() if fault else nullcontext()):
        out = rehearse(load_cell(cell, BENCH), seed=seed)
    return {k: v["value"] for k, v in out["compared"].items()}


def control_case(cell: str) -> dict:
    from pb import control

    return control.control_numbers(load_cell(cell, BENCH), CONTROL_SEED,
                                   "cpu", SMALL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compared_numbers_as_recorded(case):
    assert case_numbers(case) == load_json(RECORDED)["runs"][case]


@pytest.mark.parametrize("cell", CELLS)
def test_control_numbers_as_recorded(cell):
    assert control_case(cell) == load_json(RECORDED)["controls"][cell]


def write_recorded(tmp: Path) -> None:
    """The record, made with the recordings and work directories under
    tmp, as the tests' fixtures make them."""
    import tempfile

    from pb import traffic

    orig = traffic.ensure_recording

    def ensure(*a, **kw):
        kw.setdefault("cache_dir", tmp / "cache")
        return orig(*a, **kw)

    traffic.CACHE_DIR = tmp / "cache"
    traffic.ensure_recording = ensure
    (tmp / "tmp").mkdir(parents=True, exist_ok=True)
    tempfile.tempdir = str(tmp / "tmp")
    torch.set_num_threads(2)
    out = dict(runs={c: case_numbers(c) for c in sorted(CASES)},
               controls={c: control_case(c) for c in CELLS})
    RECORDED.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__" and "--write" in sys.argv:
    import tempfile as _tf

    with _tf.TemporaryDirectory() as d:
        write_recorded(Path(d))
