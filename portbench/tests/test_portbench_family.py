"""A configuration of a new family brought as new files only: in a copy of
portbench/, a configuration whose family is `toy_plain` (Amatsukaze's
filter mode none: every source frame goes to the encoder as it is, the
logo erased), its family module, a cell over the cm_logo mix and its
limits. The rehearsal judges it correct, a planted fault wrong, and no
file that the copy had changes. A family with no module fails in
load_cell."""

import hashlib
import json
import shutil
from pathlib import Path

from unittest import mock

import pytest

from pb.spec import BENCH_DIR, REPO_DIR, load_cell, load_json
from test_portbench_rehearsal import (  # noqa: F401 (fixtures)
    SMALL, few_threads, flip_a_pixel, own_cache, rehearse)

TOY_FAMILY = '''"""The family toy_plain: every source frame, once and in order, the
logo erased off nothing but the logo box."""

from pb import compare, delogo


class Reference:
    REACH = 2

    def __init__(self, rec, truth, geometry, planes, dtype, device):
        self.rec, self.truth, self.geometry = rec, truth, geometry
        self.ab = (delogo.logo_planes(planes, geometry)
                   if planes is not None else None)
        self.fade = delogo.fade_curve(truth) if self.ab is not None else None
        self.dtype, self.device = dtype, device

    @property
    def num_out(self):
        return self.truth["frames"]

    def seams(self):
        return [p["first"] for p in self.truth["parts"][1:]]

    def filter_result(self):
        return dict(num_out=self.num_out)

    def frames(self, indices):
        out = {}
        for i in indices:
            f = self.rec.reconstruct(i)
            if self.ab is not None:
                f = delogo.erase(f, self.ab, float(self.fade[i]), self.dtype,
                                 self.device)
            out[i] = [(f, ("frame", i))]
        return out


def reference(config, rec, truth, geometry, logo_planes, dtype, device):
    return Reference(rec, truth, geometry, logo_planes, dtype, device)


def numbers(ref, expected, served, cm_results, filter_results):
    out = dict(count_wrong=0, samples_missing=0, outside_gap=0,
               recordings_differ=compare.recordings_differ(served))
    off = [~m for m in compare.box_masks(ref.geometry, ref.REACH)]
    for enc in served:
        if enc is None or enc["n_frames"] != ref.num_out:
            out["count_wrong"] += 1
        if enc is None:
            out["samples_missing"] += len(expected)
            continue
        for k, allowed in expected.items():
            got = enc["frames"].get(k)
            if got is None:
                out["samples_missing"] += 1
                continue
            out["outside_gap"] = max(out["outside_gap"], compare.outside_gap(
                got, allowed[0][0], off))
    return out


def guarantee_control(ref, keep):
    """Every second source frame left out."""
    n = ref.num_out
    frames = {i: ref.frames([2 * i])[2 * i][0][0] for i in keep if 2 * i < n}
    return frames, n // 2, [dict(num_out=n // 2)]
'''
LIMITS = dict(count_wrong=0, samples_missing=0, outside_gap=0,
              recordings_differ=0)


def altered_sink(sink_fn):
    """Mode none hands each frame to the encoder's sink unfiltered: the
    fault goes between them."""
    from amatsukaze_tpu_torch.pipeline import transcode

    orig = transcode.pump_output

    def pump(st, frames, sink):
        return orig(st, frames, sink_fn(sink))

    return mock.patch.object(transcode, "pump_output", pump)


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def toy(tmp_path):
    """(the cell, the copy's root, its files' digests before the toy's
    files were added)."""
    repo = tmp_path / "repo"
    shutil.copytree(BENCH_DIR, repo / "portbench", ignore=shutil.ignore_patterns(
        "cache", "__pycache__", "tests"))
    before = digests(repo)
    bench_dir = repo / "portbench"
    conf = load_json(BENCH_DIR / "configs" / "isdb-mpeg2-kfm_vfr.json")
    conf.update(family="toy_plain", cli_args=["--filter-mode", "none"],
                server_profile={"filter_mode": "none"})
    (bench_dir / "configs" / "toy-plain.json").write_text(json.dumps(conf))
    (bench_dir / "families" / "toy_plain.py").write_text(TOY_FAMILY)
    (bench_dir / "cells" / "toy.cm_logo.json").write_text(
        json.dumps(dict(limits=LIMITS)))
    bench = load_json(REPO_DIR / "BENCHMARK.json")
    bench["configs"].append(dict(
        name="toy-plain", source="the kfm_vfr source, filter mode none",
        file="portbench/configs/toy-plain.json", reduced=[],
        why="a family added as files"))
    bench["workloads"].append(dict(
        name="toy.cm_logo", config="toy-plain", traffic="cm_logo", chips=1,
        why="the cm_logo mix through filter mode none"))
    cell = load_cell("toy.cm_logo", bench, repo=repo, bench_dir=bench_dir)
    return cell, repo, before


def test_toy_family_added_as_files(toy):
    cell, repo, before = toy
    out = rehearse(cell)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == set(LIMITS)
    with altered_sink(flip_a_pixel):
        bad = rehearse(cell)
    assert not bad["correct"]
    assert bad["compared"]["outside_gap"]["value"] > 0
    after = digests(repo)
    assert {k: after.get(k) for k in before} == before


def test_toy_family_control_is_wrong(toy):
    from pb import control

    cell, _, _ = toy
    res = control.control_numbers(cell, 5, "cpu", SMALL)
    assert not control.judged(res["guarantee"], cell.limits)
    assert res["guarantee"]["count_wrong"] == 1


def test_family_without_a_module_fails_in_load_cell(tmp_path):
    repo = tmp_path / "repo"
    shutil.copytree(BENCH_DIR / "configs", repo / "portbench" / "configs")
    conf = load_json(BENCH_DIR / "configs" / "isdb-mpeg2-kfm_vfr.json")
    (repo / "portbench" / "configs" / "isdb-mpeg2-kfm_vfr.json").write_text(
        json.dumps(dict(conf, family="no_such_family")))
    for sub in ("cells", "traffic", "families"):
        shutil.copytree(BENCH_DIR / sub, repo / "portbench" / sub)
    bench = load_json(REPO_DIR / "BENCHMARK.json")
    with pytest.raises(FileNotFoundError) as e:
        load_cell("kfm_vfr.cm_logo", bench, repo=repo,
                  bench_dir=repo / "portbench")
    msg = str(e.value)
    assert "no_such_family" in msg
    assert str(repo / "portbench" / "families" / "no_such_family.py") in msg
