"""The readers of the program's own trace (pb/program_trace.py and the
metrics that read it) over made-up runs whose traces give known values."""

import pytest

from pb.spec import load_metric_reader
from pb.trace import DeviceEvent


def span(sid, name, t0, t1, parent=None, frames=None, **attrs):
    s = dict(id=sid, name=name, t0=t0, t1=t1, parent=parent,
             recording="r")
    if frames is not None:
        s["frames"] = frames
    if attrs:
        s["attrs"] = attrs
    return s


def recording(at: float, counters=None) -> dict:
    """A report whose trace starts at `at`: a 1.5 s split of 900 frames,
    a 6 s CM pass that waits 4 s on the decoder's queue, a 3 s analysis
    that waits 1 s on it, a 2 s output pass from the spill that spends
    0.5 s in the sink."""
    t = at
    spans = [
        span(0, "recording", t, t + 13),
        span(1, "split", t, t + 1.5, 0, frames=900),
        span(2, "cm", t + 1.5, t + 8, 0),
        span(3, "cm.pass", t + 1.5, t + 7.5, 2, frames=900, input_wait_s=4.0),
        span(4, "encode", t + 8, t + 13, 0),
        span(5, "filter.analysis", t + 8, t + 11, 4, frames=900,
             input_wait_s=1.0),
        span(6, "filter.output", t + 11, t + 13, 4, frames=900, sink_s=0.5),
    ]
    return dict(trace=dict(clock="perf_counter", spans=spans,
                           counters=counters or {}))


class Run:
    def __init__(self, reports, t0, t1, events=None):
        self._reports, self.t0, self.t1 = reports, t0, t1
        self.events = events

    def reports(self):
        return self._reports


def read(name, run):
    return load_metric_reader(name).read(run)


def test_span_readers():
    run = Run([recording(100.0), recording(113.0)], 100.0, 126.0)
    assert read("parse.split_fps", run) == pytest.approx(600.0)
    assert read("stage.kfm_analysis_fps", run) == pytest.approx(300.0)
    assert read("stage.output_pass_fps", run) == pytest.approx(450.0)
    # (4 + 1) s of waits over the (6 + 3) s of the passes that wait
    assert read("parse.decode_wait_share", run) == pytest.approx(
        100 * 5 / 9)


def test_spans_clipped_to_the_window():
    """A recording that ends inside the window counts its time there, and
    each span's frames in proportion."""
    # half the split inside: 450 frames in 0.75 s
    run = Run([recording(100.0)], 100.75, 126.0)
    assert read("parse.split_fps", run) == pytest.approx(600.0)
    # a quarter of the analysis inside, none of the output pass
    run = Run([recording(100.0)], 100.0, 108.75)
    assert read("stage.kfm_analysis_fps", run) == pytest.approx(300.0)
    assert read("stage.output_pass_fps", run) is None
    # each pass's waits in proportion to its time inside: the whole CM
    # pass, 0.75 s of the analysis (0.25 s of its waits)
    assert read("parse.decode_wait_share", run) == pytest.approx(
        100 * (4 + 0.25) / (6 + 0.75))


def test_link_bandwidth():
    counters = {"h2d.pageable_bytes": 3e9, "h2d.pinned_bytes": 1e9,
                "d2h.bytes": 2e9, "decode.frames": 900}
    events = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                          101.0, 102.0),
              DeviceEvent("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                          103.0, 103.5),
              DeviceEvent("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
                          104.0, 105.0),
              DeviceEvent("void k()", "kernel", 105.0, 109.0),
              # half outside the window
              DeviceEvent("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                          125.5, 126.5)]
    run = Run([recording(100.0, counters)], 100.0, 126.0, events)
    assert read("copy.link_gbps", run) == pytest.approx(6.0 / 2.0)
    assert read("copy.link_gbps", Run(run.reports(), 100.0, 126.0)) is None


@pytest.mark.parametrize("name", [
    "parse.split_fps", "parse.decode_wait_share", "stage.kfm_analysis_fps",
    "stage.output_pass_fps", "copy.link_gbps"])
def test_reports_without_a_trace_read_nothing(name):
    """A program that records no trace (the parent of the change that
    brought it): None, not an error."""
    events = [DeviceEvent("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                          101.0, 102.0)]
    run = Run([dict(encodewaits=[])], 100.0, 126.0, events)
    assert read(name, run) is None
    assert read(name, Run([], 100.0, 126.0, events)) is None


# -- the rehearsal: each cell at 96x128 on the CPU ----------------------------

SMALL = dict(width=128, height=96, logo_box=[96, 8, 24, 16])
NEW = ("parse.split_fps", "parse.decode_wait_share", "stage.kfm_analysis_fps",
       "stage.output_pass_fps", "copy.link_gbps")


@pytest.fixture
def own_cache(tmp_path, monkeypatch):
    """Recordings and work directories of the rehearsal under tmp_path."""
    import tempfile

    from pb import traffic

    orig = traffic.ensure_recording

    def ensure(*a, **kw):
        kw.setdefault("cache_dir", tmp_path / "cache")
        return orig(*a, **kw)

    monkeypatch.setattr(traffic, "ensure_recording", ensure)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", None)


@pytest.mark.parametrize("name", ["kfm_vfr.cm_logo", "kfm_vfr.nologo"])
def test_rehearsal_reads_the_program_trace(own_cache, name):
    """A traced run of the cell on the CPU (the kernels' plain versions):
    every new reader the cell lists reads a value but copy.link_gbps,
    which needs the device trace."""
    import time

    import torch

    from pb import harness
    from pb.spec import load_cell

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = load_cell(name)
        out = harness.run_cell(cell, 5, 1.0, True, time.perf_counter(),
                               device="cpu", geometry=SMALL,
                               log=lambda m: None)
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["compared"]
    listed = {m["name"] for m in cell.per_layer} & set(NEW)
    assert listed == set(NEW)
    got = out["metrics"]
    for m in listed - {"copy.link_gbps"}:
        assert got[m]["value"] > 0, m
    assert "copy.link_gbps" not in got
    assert 0 < got["parse.decode_wait_share"]["value"] < 100
