"""Every cell rehearsed on the CPU at 96x128 through the same code as on
the card (the kernels' plain versions), a cell added from data alone, and
faults planted under the timed path that `correct` must catch."""

import json
import shutil
import time
from unittest import mock

import numpy as np
import pytest
import torch

from pb import harness
from pb.spec import BENCH_DIR, REPO_DIR, load_cell, load_json

SMALL = dict(width=128, height=96, logo_box=[96, 8, 24, 16])
# the queue cell waits for a later change to BENCHMARK.json (PERF.md §7):
# its files are here, and it is rehearsed from them as data alone
QUEUE = dict(name="kfm_vfr.queue2", config="isdb-mpeg2-kfm_vfr",
             traffic="cm_logo_queue2", chips=1,
             why="cm_logo recordings through EncodeServer, num_parallel 2")
OVERLAP = dict(name="server.overlap_share", unit="%", better="higher",
               source="program_span", layer="server", moves="device_memory_gb",
               workloads=["kfm_vfr.queue2"])
BENCH = load_json(REPO_DIR / "BENCHMARK.json")
BENCH = dict(BENCH, workloads=BENCH["workloads"] + [QUEUE],
             per_layer=BENCH["per_layer"] + [OVERLAP])


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Recordings and work directories of the rehearsal under tmp_path."""
    from pb import traffic

    monkeypatch.setattr(traffic, "CACHE_DIR", tmp_path / "cache")
    orig = traffic.ensure_recording

    def ensure(*a, **kw):
        kw.setdefault("cache_dir", tmp_path / "cache")
        return orig(*a, **kw)

    monkeypatch.setattr(traffic, "ensure_recording", ensure)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)


def rehearse(cell, seed=5, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", geometry=SMALL, log=lambda m: None)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_rehearsal_is_correct(name):
    cell = load_cell(name, BENCH)
    out = rehearse(cell, trace=True)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= cell.traffic["clients"]
    per_layer = {m["name"] for m in cell.per_layer}
    # the span and counter readers read something on the CPU; the device
    # trace's readers need the card
    spans = {"entry.feed_starved_share", "parse.decode_fps",
             "stage.cm_pass_fps", "stage.filter_encode_fps",
             "server.overlap_share"} & per_layer
    assert spans <= set(out["metrics"])
    assert not set(out["metrics"]) & {"device.idle_share",
                                      "ops.device_ms_per_frame"}
    assert list(out)[-2:] == ["compared", "compared_lines"]


def test_end_to_end_metrics_of_a_run():
    out = rehearse(load_cell("kfm_vfr.nologo", BENCH), trace=False)
    assert set(out["metrics"]) == {"setup_s", "device_memory_gb"}
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["device"]["count"] == 1


def test_cell_added_from_data_alone(tmp_path):
    """A new traffic mix, cell file and per-layer metric as files, and
    their entries: nothing of the harness changes."""
    d = tmp_path / "bench"
    for sub in ("cells", "traffic", "metrics", "families"):
        shutil.copytree(BENCH_DIR / sub, d / sub)
    mix = load_json(BENCH_DIR / "traffic" / "cm_logo.json")
    mix["parts"][0]["scenes"] = [[150, 0], [150, 1]]
    mix["parts"][2]["scenes"] = [[150, 2]]
    (d / "traffic" / "cm_logo_late.json").write_text(json.dumps(mix))
    (d / "cells" / "kfm_vfr.cm_logo_late.json").write_text(
        (BENCH_DIR / "cells" / "kfm_vfr.cm_logo.json").read_text())
    (d / "metrics" / "stage.split_share.py").write_text(
        "def read(run):\n"
        "    s = run.spans_of('split')\n"
        "    return 100 * sum(x.t1 - x.t0 for x in s) / (run.t1 - run.t0) "
        "if s else None\n")
    bench = json.loads(json.dumps(load_json(REPO_DIR / "BENCHMARK.json")))
    bench["workloads"].append(dict(
        name="kfm_vfr.cm_logo_late", config="isdb-mpeg2-kfm_vfr",
        traffic="cm_logo_late", chips=1, why="the CM break later"))
    bench["per_layer"].append(dict(
        name="stage.split_share", unit="%", better="lower",
        source="program_span", layer="stages", moves="device_memory_gb",
        workloads=["kfm_vfr.cm_logo_late"]))
    cell = load_cell("kfm_vfr.cm_logo_late", bench, bench_dir=d)
    out = rehearse(cell, trace=True)
    assert out["correct"], out["compared"]
    assert out["metrics"]["stage.split_share"]["value"] > 0


# -- faults under the timed path ----------------------------------------------

def altered_output(sink_fn):
    from amatsukaze_tpu_torch.pipeline import filter_stage

    orig = filter_stage.pump_filtered

    def pump(fg, frames, sink, batch):
        return orig(fg, frames, sink_fn(sink), batch)

    return mock.patch.object(filter_stage, "pump_filtered", pump)


def flip_a_pixel(sink):
    def s(planes):
        y = planes[0].copy()
        y[0, 0] ^= 1
        sink((y,) + tuple(planes[1:]))
    return s


def drop_half(sink):
    n = [0]

    def s(planes):
        n[0] += 1
        if n[0] % 2:
            sink(planes)
    return s


def second_recording_altered_off_the_sample():
    """A pixel flipped in one frame that the encoder does not keep whole,
    in the window's second recording alone: only the digests see it."""
    import os

    from amatsukaze_tpu_torch.pipeline import filter_stage

    orig = filter_stage.pump_filtered
    calls = []

    def pump(fg, frames, sink, batch):
        keep = os.environ.get("PORTBENCH_KEEP_FRAMES")
        if keep is not None:
            calls.append(1)
        if len(calls) != 2:
            return orig(fg, frames, sink, batch)
        kept = {int(k) for k in keep.split(",")}
        off = min(set(range(len(kept) + 1)) - kept)
        n = [0]

        def s(planes):
            if n[0] == off:
                planes = (planes[0].copy(),) + tuple(planes[1:])
                planes[0][0, 0] ^= 1
            n[0] += 1
            sink(planes)
        return orig(fg, frames, s, batch)

    return mock.patch.object(filter_stage, "pump_filtered", pump)


def shifted_trims():
    from amatsukaze_tpu_torch.pipeline import cm_stage

    orig = cm_stage.decide

    def decide(analyzer, cma, files):
        out = orig(analyzer, cma, files)
        if len(analyzer.result.trims) > 1:
            analyzer.result.trims[1] += 5
        return out

    return mock.patch.object(cm_stage, "decide", decide)


def no_erase():
    from amatsukaze_tpu_torch.models.logo_erase import LogoEraser

    def erase_batch(self, ys, us, vs, start):
        return np.asarray(ys), np.asarray(us), np.asarray(vs)

    return mock.patch.object(LogoEraser, "erase_batch", erase_batch)


def bob_everything():
    """Every film frame replaced by the bob of its top field."""
    from amatsukaze_tpu_torch.models import filter_graph
    from amatsukaze_tpu_torch.models.kfm import VFRPlan

    orig = filter_graph.build_vfr_plan

    def build(*a, **kw):
        plan = orig(*a, **kw)
        plan.source_frames = [(f, VFRPlan.BOB_T) if d == 5 else (f, op)
                              for (f, op), d in zip(plan.source_frames,
                                                    plan.durations)]
        return plan

    return mock.patch.object(filter_graph, "build_vfr_plan", build)


@pytest.mark.parametrize("name, fault, caught_by, seconds", [
    ("kfm_vfr.cm_logo", lambda: altered_output(flip_a_pixel), "outside_gap",
     1.0),
    ("kfm_vfr.nologo", lambda: altered_output(flip_a_pixel), "outside_gap",
     1.0),
    ("kfm_vfr.cm_logo", lambda: altered_output(drop_half), "count_wrong",
     1.0),
    ("kfm_vfr.queue2", lambda: altered_output(drop_half), "count_wrong",
     1.0),
    ("kfm_vfr.cm_logo", shifted_trims, "cm_wrong", 1.0),
    ("kfm_vfr.cm_logo", no_erase, "fade_flips", 1.0),
    ("kfm_vfr.nologo", bob_everything, "whole_bobbed", 1.0),
    # two recordings or more in the window
    ("kfm_vfr.nologo", second_recording_altered_off_the_sample,
     "recordings_differ", 8.0),
])
def test_fault_makes_correct_false(name, fault, caught_by, seconds):
    with fault():
        out = rehearse(load_cell(name, BENCH), seconds=seconds)
    assert not out["correct"]
    c = out["compared"][caught_by]
    assert c["value"] > c["limit"], out["compared"]
