"""The port's trace (utils/perf.py): the recorder, the copy helpers of
utils/device.py, and one `--mode ts` CLI run on the CPU whose report
carries the recording's trace.

The CLI run is over utils/synth_ts.py's 96-frame 96x128 broadcast layout
(program with the logo, CM, program; its logo as an .lgd file) in kfm_vfr,
with a fake encoder that copies its y4m stdin to `-o`, as in
tests/test_torch_transcode.py.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from amatsukaze_tpu_torch import cli
from amatsukaze_tpu_torch.audio.aac_native import make_decoder
from amatsukaze_tpu_torch.models.lgd import save_lgd
from amatsukaze_tpu_torch.pipeline import decoders
from amatsukaze_tpu_torch.pipeline.cm_stage import run_cm_analysis
from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
from amatsukaze_tpu_torch.pipeline.splitter import AMTSplitter
from amatsukaze_tpu_torch.pipeline.transcode import TranscodePipeline
from amatsukaze_tpu_torch.ts import native as tnative
from amatsukaze_tpu_torch.types import VideoFormat
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.utils.batching import batched
from amatsukaze_tpu_torch.utils.context import AMTContext
from amatsukaze_tpu_torch.utils.device import to_device, to_host
from amatsukaze_tpu_torch.utils.perf import Trace

FAKE_ENCODER = """#!/bin/bash
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    *) shift;;
  esac
done
cat > "$out"
"""

# the root's children of a kfm_vfr recording with a logo, in order, and
# those of the CM analysis and of the filter + encode
PHASES = ["pipeline.init", "gate", "split", "reform.prepare", "gate", "cm",
          "audio", "captions", "encode", "gate", "mux"]
CM_PHASES = ["cm.pass", "cm.silence", "cm.decide"]
ENCODE_PHASES = ["gate", "gate", "filter.logo_match", "filter.analysis",
                 "encode.spawn", "filter.output", "encode.drain"]
MAX_EVENTS = 400


# -- the recorder -------------------------------------------------------------

def test_span_parents_per_thread_and_explicit():
    tr = Trace()
    root = tr.open_root()
    with tr.span("a") as a:
        with tr.span("b") as b:
            pass
        seen = {}

        def worker():
            # a thread with no span open: the root; or the one handed over
            with tr.span("w") as w:
                seen["w"] = w
            with tr.span("x", parent=a) as x:
                with tr.span("y") as y:
                    seen["x"], seen["y"] = x, y

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with tr.span("c") as c:
            pass
    tr.close_root()
    assert b.parent == a.id and c.parent == a.id and a.parent == root.id
    assert seen["w"].parent == root.id
    assert seen["x"].parent == a.id and seen["y"].parent == seen["x"].id
    assert root.parent is None and root.t1 >= c.t1 >= c.t0 >= a.t0
    assert tr.current() is root


def test_begin_end_and_seconds():
    tr = Trace()
    s = tr.begin("p", frames=3, phase="x")
    assert tr.current() is s and s.seconds >= 0
    tr.end(s)
    t1 = s.t1
    tr.end(s)  # once
    assert s.t1 == t1 and tr.current() is None
    assert s.seconds == t1 - s.t0
    with tr.span("q") as q:
        q.add("sink_s", 0.25)
        q.add("sink_s", 0.5)
    assert tr.spans == [s, q]
    assert s.frames == 3 and s.attrs == {"phase": "x"}
    assert q.attrs == {"sink_s": 0.75}


def test_recording_ids_differ():
    a, b = AMTContext().trace, AMTContext().trace
    assert a.recording != b.recording
    a.open_root()
    with a.span("s"):
        pass
    assert {d["recording"] for d in a.to_json()["spans"]} == {a.recording}


def test_counters_under_concurrent_adds():
    """More threads than cores, switching often: no add is lost."""
    tr = Trace()
    tr.ADD_EVERY = 7
    n, k = 2 * (os.cpu_count() or 4), 2000

    def adder():
        for _ in range(k):
            tr.add("bytes", 3)
            tr.add("seconds", 0.5)
        for _ in tr.timed_iter(iter(range(k)), "decode"):
            pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=adder) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    c = tr.counters
    assert (c["bytes"], c["seconds"], c["decode.frames"]) == (
        3 * n * k, 0.5 * n * k, n * k)


def test_timed_iter_counts_items_and_time():
    tr = Trace()
    assert list(tr.timed_iter(iter(range(7)), "decode")) == list(range(7))
    assert tr.counters["decode.frames"] == 7
    assert tr.counters["decode.busy_s"] >= 0
    # added every 4 items, and what is left when the iteration is closed
    tr.ADD_EVERY = 4
    it = tr.timed_iter(iter(range(40)), "x")
    got = [next(it) for _ in range(10)]
    assert got == list(range(10)) and tr.counters["x.frames"] == 8
    it.close()
    assert tr.counters["x.frames"] == 10


def test_batched_records_input_wait():
    """waited() sums the source's next() calls into the span open where
    the iteration starts, which need not be where it was made, and passes
    the items on one at a time."""
    tr = Trace()

    def slow(n):
        for i in range(n):
            time.sleep(0.002)
            yield i

    src = tr.waited(slow(10))
    with tr.span("pass") as p:
        assert next(src) == 0 and p.attrs is None  # one item, no batching
        chunks = [[0]] + list(batched(src, 4))
    assert chunks == [[0], [1, 2, 3, 4], [5, 6, 7, 8], [9]]
    assert 0.02 <= p.attrs["input_wait_s"] <= p.seconds
    assert [s.name for s in tr.spans] == ["pass"]
    assert list(batched(range(5), 2)) == [[0, 1], [2, 3], [4]]


def test_report_json_form():
    tr = Trace()
    tr.open_root()
    with tr.span("split", frames=96):
        pass
    with tr.span("gate", phase="Mux"):
        pass
    tr.add("split.ts_bytes", 188)
    tr.close_root()
    got = json.loads(json.dumps(tr.to_json()))
    assert set(got) == {"clock", "spans", "counters"}
    assert got["clock"] == "perf_counter"
    assert got["counters"] == {"split.ts_bytes": 188}
    root, split, gate = got["spans"]
    assert root["name"] == "recording" and root["parent"] is None
    assert split == dict(id=1, name="split", t0=split["t0"], t1=split["t1"],
                         parent=0, recording=tr.recording, frames=96)
    assert gate["attrs"] == {"phase": "Mux"} and "frames" not in gate
    assert root["t0"] <= split["t0"] <= split["t1"] <= root["t1"]


@pytest.mark.parametrize("frames", [40, 200])
def test_spans_do_not_grow_with_the_frames(frames):
    """The CM pass over 40 or 200 frames in batches of 8: the same spans,
    the waits summed into the pass's span."""
    fmt = VideoFormat(width=128, height=96, frame_rate_num=30000,
                      frame_rate_denom=1001, progressive=True)
    rng = np.random.default_rng(5)
    clip = [tuple(rng.integers(0, 255, (h, w), dtype=np.uint8)
                  for h, w in ((96, 128), (48, 64), (48, 64)))
            for _ in range(frames)]
    ctx = AMTContext(level="warn")
    ctx.trace.open_root()
    cm = run_cm_analysis(ctx, lambda: iter(clip), frames, fmt, [],
                         batch=8, device="cpu")
    ctx.trace.close_root()
    assert cm.num_frames == frames
    assert [s.name for s in ctx.trace.spans] == [
        "recording", "cm.pass", "cm.silence", "cm.decide"]
    assert cm.pass_span.attrs["input_wait_s"] >= 0
    assert cm.silence_span is ctx.trace.spans[2]


# -- the copy helpers ---------------------------------------------------------

def test_copies_count_bytes_when_they_cross():
    tr = Trace()
    host = np.arange(24, dtype=np.uint8).reshape(4, 6)
    on_meta = to_device(host, "meta", tr)
    assert on_meta.device.type == "meta"
    to_device(torch.zeros(5, dtype=torch.float32), "meta", tr)
    assert tr.counters == {"h2d.pageable_bytes": 24 + 20}
    # CPU to CPU crosses nothing
    tr2 = Trace()
    t = to_device(host, "cpu", tr2)
    np.testing.assert_array_equal(to_host(t, tr2), host)
    assert tr2.counters == {}


def test_fetch_counts_the_bytes_of_a_device_tensor():
    class OnDevice:
        """A tensor that says it lives on a device (the CPU has none)."""

        def __init__(self, t):
            self.t = t
            self.device = torch.device("cuda")

        def cpu(self):
            return self.t

    tr = Trace()
    out = to_host(OnDevice(torch.ones(3, 4, dtype=torch.int16)), tr)
    assert out.shape == (3, 4) and tr.counters == {"d2h.bytes": 24}


def test_copies_without_a_trace():
    t = to_device(np.ones(3, np.float32), "cpu")
    assert to_host(t).tolist() == [1.0, 1.0, 1.0]


# -- one recording through the CLI --------------------------------------------

@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tnative.load_native()
    base = tmp_path_factory.mktemp("trace")
    ts, _, logos = synth_ts.ts_clip("small", str(base / "synth.ts"))
    lgd = str(base / "logo0.lgd")
    save_lgd(lgd, logos[0])
    enc = base / "fake_x264"
    enc.write_text(FAKE_ENCODER)
    enc.chmod(0o755)
    (base / "work").mkdir()
    argv = ["-i", ts.path, "-o", str(base / "out"), "-w", str(base / "work"),
            "-e", str(enc), "-j", str(base / "report.json"), "--logo", lgd,
            "--filter-mode", "kfm_vfr", "--mode", "ts"]
    assert cli.main(argv, device="cpu") == 0
    with open(base / "report.json") as f:
        return dict(json.load(f), frames=len(ts.recon))


def test_cli_report_has_the_trace(report):
    tr = report["trace"]
    assert tr["clock"] == "perf_counter"
    assert len(tr["spans"]) <= MAX_EVENTS
    (root,) = [s for s in tr["spans"] if s["parent"] is None]
    assert root["name"] == "recording"

    def kids(parent):
        got = sorted((s for s in tr["spans"] if s["parent"] == parent["id"]),
                     key=lambda s: s["t0"])
        for a, b in zip(got, got[1:]):
            assert parent["t0"] <= a["t0"] <= a["t1"] <= b["t0"] <= parent["t1"]
        return got

    phases = kids(root)
    assert [s["name"] for s in phases] == PHASES
    (cm,) = [s for s in phases if s["name"] == "cm"]
    (encode,) = [s for s in phases if s["name"] == "encode"]
    assert [s["name"] for s in kids(cm)] == CM_PHASES
    assert [s["name"] for s in kids(encode)] == ENCODE_PHASES
    gates = [s for s in tr["spans"] if s["name"] == "gate"]
    assert [s["attrs"]["phase"] for s in gates] == [
        "TSAnalyze", "CMAnalyze", "Filter", "Encode", "Mux"]
    # the phases cover the recording: the root's own time under 1% of it
    total = root["t1"] - root["t0"]
    own = total - sum(s["t1"] - s["t0"] for s in phases)
    assert 0 <= own < 0.01 * total, (own, total)


def test_cli_trace_inside_the_passes(report):
    tr, n = report["trace"], report["frames"]
    by_id = {s["id"]: s for s in tr["spans"]}

    def named(name):
        return [s for s in tr["spans"] if s["name"] == name]

    (split,) = named("split")
    assert split["frames"] == n
    for name in ("cm.pass", "filter.analysis", "filter.output"):
        (s,) = named(name)
        assert s["frames"] == n, name
    # the waits on the decoder's queue, summed in the passes that read it:
    # the CM pass and the analysis (the output pass reads the spill); the
    # output pass's calls of the sink
    waits = {s["name"]: s["attrs"]["input_wait_s"] for s in tr["spans"]
             if "input_wait_s" in (s.get("attrs") or {})}
    assert set(waits) == {"cm.pass", "filter.analysis"}
    for name, w in waits.items():
        (s,) = named(name)
        assert 0 < w < s["t1"] - s["t0"], name
    (out,) = named("filter.output")
    assert 0 < out["attrs"]["sink_s"] < out["t1"] - out["t0"]
    assert not named("input_wait") and not named("sink")
    assert by_id[out["parent"]]["name"] == "encode"
    c = tr["counters"]
    # one decode: the analysis and the output pass read the frame cache
    assert c["decode.frames"] == n and c["decode.busy_s"] > 0
    assert c["split.ts_bytes"] > 0
    for k in ("split.ps_write_s", "split.audio_s"):
        assert 0 < c[k] < split["t1"] - split["t0"], k
    assert c["split.caption_s"] == 0  # no caption decoder without --subtitles
    # the plain versions on the CPU: no copy crosses devices
    assert not any(k.startswith(("h2d.", "d2h.")) for k in c)


def test_cli_encodewaits_from_the_spans(report):
    tr = report["trace"]
    (out,) = [s for s in tr["spans"] if s["name"] == "filter.output"]
    (drain,) = [s for s in tr["spans"] if s["name"] == "encode.drain"]
    (waits,) = report["encodewaits"]
    assert set(waits) == {"total", "filter_wait", "encoder_wait"}
    assert waits["total"] == round(drain["t1"] - out["t0"], 3)


def test_mpeg2_factory_counts_its_segments(tmp_path, monkeypatch):
    """The pipeline's MPEG-2 factory over the small TS's intermediate, as a
    pass opens it (prefetched, through the frame cache): three segments of
    a 16-frame batch on two workers (a sequence header every 15 frames:
    cuts at 30 and 60), every frame counted on both sides."""
    tnative.load_native()
    ts, _, _ = synth_ts.ts_clip("small", str(tmp_path / "synth.ts"))
    conf = Config()
    conf.src_file_path = ts.path
    conf.work_dir = str(tmp_path / "work")
    conf.out_video_path = str(tmp_path / "out")
    conf.device_batch_frames = 16
    os.makedirs(conf.work_dir)
    ctx = AMTContext(level="error")
    st = Settings(ctx, conf)
    pipe = TranscodePipeline(ctx, st, device="cpu",
                             decoder_factory=decoders.mpeg2_decoder_factory)
    pipe._reform = AMTSplitter(ctx, st,
                               audio_decoder_factory=make_decoder).split()
    pipe._reform.prepare(conf.split_sub, False)
    monkeypatch.setattr(decoders, "decode_worker_budget", lambda: 2)
    got = [f[0].copy() for f in pipe._open_frames(0)()]
    assert len(got) == len(ts.recon)
    assert all(np.array_equal(a, b[0]) for a, b in zip(got, ts.recon))
    c = ctx.trace.counters
    assert c["decode.segments"] == 3
    assert c["decode.segment_frames"] == c["decode.frames"] == len(got)
    assert c["decode.busy_s"] > 0 and "decode.serial_files" not in c
