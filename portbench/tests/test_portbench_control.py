"""The control of `correct` (pb/control.py): the reference put in the
program's place one precision below the configuration's, and, where the
path holds no arithmetic a lower precision changes, with the telecine left
in. It must come out not correct under each cell's limits: on the CPU at
96x128, and on the card at the cell's own size on three seeds
(`python -m pytest portbench/tests -m card`)."""

import pytest
import torch

from pb import control
from pb.spec import REPO_DIR, load_cell, load_json

SMALL = dict(width=128, height=96, logo_box=[96, 8, 24, 16])
CELLS = [w["name"] for w in load_json(REPO_DIR / "BENCHMARK.json")
         ["workloads"]]


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    from pb import traffic

    orig = traffic.ensure_recording

    def ensure(*a, **kw):
        kw.setdefault("cache_dir", tmp_path / "cache")
        return orig(*a, **kw)

    monkeypatch.setattr(traffic, "ensure_recording", ensure)


def judged_correct(cell, res: dict) -> dict:
    return {kind: control.judged(nums, cell.limits)
            for kind, nums in res.items()}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_cpu(name):
    torch.set_num_threads(2)
    cell = load_cell(name)
    res = control.control_numbers(cell, 17, "cpu", SMALL)
    got = judged_correct(cell, res)
    # the lower precision fails wherever the path computes (the erase);
    # the woven 30p fails every cell
    assert got["guarantee"] is False
    if cell.traffic["logos_given"]:
        assert got["lower"] is False, res["lower"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2147484101, 2147484102, 2147484103])
def test_control_fails_on_the_card(card, name, seed):
    cell = load_cell(name)
    res = control.control_numbers(cell, seed, "cuda")
    got = judged_correct(cell, res)
    assert not all(got.values()), res
    if cell.traffic["logos_given"]:
        assert got["lower"] is False, res["lower"]
