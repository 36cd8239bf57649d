"""One run of one cell: set-up (the recording, the kernels and libraries,
a warm-up recording of the same geometry), the measured window, the
per-layer readers (with a trace), then the comparison with the reference.
Returns the result object that run.py prints.

`setup_s` is the time from the process's start to the window's, less the
seconds spent writing the seed's recordings when they were not cached: they
are the benchmark's inputs, as the reference is its judge, and a check's
second set of runs finds the first set's recordings cached.
`device_memory_gb` is the card's peak of allocated memory over the window.
The window's rate of source frames is a per-layer metric
(`metrics/entry.transcode_fps.py`) and is logged on every run."""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from . import compare, entries, traffic
from .probes import Recorder
from .spec import Cell, load_family

WARMUP_FRAMES = 60
WARMUP_SEED = 1
SAMPLE_FRAMES = 10


def warmup_traffic(mix: dict) -> dict:
    """The mix cut to one scene of WARMUP_FRAMES frames like its first
    part's first: the same geometry and the same paths through the
    program."""
    part = mix["parts"][0]
    first = dict(part, scenes=[[WARMUP_FRAMES, part["scenes"][0][1]]],
                 cm=False)
    return dict(mix, parts=[first])


def work_dir(cell: str) -> Path:
    return Path(tempfile.gettempdir()) / "portbench" / cell


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             setup_t0: float, device=None, geometry=None, log=print) -> dict:
    """device None: the CUDA card (as a user runs the program); "cpu":
    the kernels' plain versions (the CPU rehearsal). geometry overrides the
    configuration's (the rehearsal's small frames)."""
    import torch

    geometry = geometry or cell.config["geometry"]
    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    work = work_dir(cell.name)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        rec = traffic.ensure_recording(cell.traffic_name, cell.traffic,
                                       geometry, seed)
        warm = traffic.ensure_recording(
            cell.traffic_name + "-warmup", warmup_traffic(cell.traffic),
            geometry, WARMUP_SEED)
        wrote = rec["wrote_seconds"] + warm["wrote_seconds"]
        log(f"recording: {rec['truth']['frames']} frames, "
            f"{rec['truth']['ts_bytes'] / 1e6:.1f} MB; recordings written "
            f"in {wrote:.2f} s (0: cached), not counted in setup_s")
        encoder = entries.write_encoder(work / "fake_x264")
        recorder = Recorder()
        with recorder.patched(), entries.native_decoders_only():
            t_w = time.perf_counter()
            res = entries.CliEntry(cell.config, warm, work, encoder,
                                   device).run_one(0, tag="warmup")
            log(f"warm-up: {WARMUP_FRAMES} frames in "
                f"{time.perf_counter() - t_w:.2f} s ({res.get('error')})")
            if cell.traffic["entry"] == "server":
                import amatsukaze_tpu_torch.server.rpc  # noqa: F401
                import amatsukaze_tpu_torch.server.server  # noqa: F401
            shutil.rmtree(work / "warmup0", ignore_errors=True)
            recorder.spans.clear()
            recorder.decisions.clear()
            ref = reference_for(cell, rec, geometry)
            keep = sample_for(ref, seed)
            os.environ["PORTBENCH_KEEP_FRAMES"] = ",".join(map(str, keep))
            entry = entries.make_entry(cell, rec, work, encoder, device)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            tracer = None
            if trace and on_card:
                from .trace import Tracer

                tracer = Tracer(str(work / "trace.json"))
                tracer.start(dev)
            t0 = time.perf_counter()
            setup_s = t0 - setup_t0 - wrote
            win = entry.run_window(seconds)
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            if tracer is not None:
                tracer.stop()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        failed = sum(1 for r in win.recordings if not r.result.get("ok"))
        for r in win.recordings:
            if not r.result.get("ok"):
                log(f"recording {r.index} failed: {r.result.get('error')}")
        out = dict(correct=False, attempted=len(win.recordings),
                   failed=failed)
        out["metrics"] = {}
        e2e = dict(setup_s=setup_s, device_memory_gb=peak / 1e9)
        log(f"window: {len(win.recordings)} recordings of "
            f"{rec['truth']['frames']} frames in {win.seconds:.3f} s = "
            f"{win.fps:.3f} frames/s; each "
            f"{[round(r.seconds, 3) for r in win.recordings]} s")
        run = RunData(cell, rec, geometry, win, recorder, t0, t1)
        if tracer is not None:
            from . import trace as tr

            run.events = tracer.events()
            busy = tr.busy_seconds(run.events, t0, t1)
            out["breakdown"] = tr.breakdown(run.events, recorder.spans, t0, t1)
        from .spec import load_metric_reader

        if trace:
            for m in cell.per_layer:
                v = load_metric_reader(m["name"], cell.bench_dir).read(run)
                if v is not None:
                    out["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
        else:
            for m in cell.end_to_end:
                out["metrics"][m["name"]] = dict(value=e2e[m["name"]],
                                                 unit=m["unit"])
        out["device"] = dict(
            platform="gpu" if on_card else "cpu",
            kind=torch.cuda.get_device_name() if on_card else "cpu",
            count=1, memory_peak_bytes=int(peak))
        if tracer is not None:
            out["device"].update(busy_s=busy, window_s=t1 - t0)
        # the program's state goes before the reference runs
        del entry
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        nums = check(cell, ref, keep, win, recorder, dev)
        log(f"reference and comparison: {time.perf_counter() - t_ref:.2f} s")
        ok, lines = compare.judge(nums, cell.limits, failed)
        out["correct"] = ok
        out["compared"] = {k: dict(value=v, limit=cell.limits[k])
                           for k, v in nums.items()}
        out["compared_lines"] = lines
        return out
    finally:
        os.environ.pop("PORTBENCH_KEEP_FRAMES", None)
        shutil.rmtree(work, ignore_errors=True)


def reference_for(cell: Cell, rec: dict, geometry: dict, dtype=None,
                  device="cpu"):
    """The reference of the cell's configuration's family for the seed's
    recording."""
    import torch

    truth = rec["truth"]
    planes = None
    if truth["logos_given"]:
        planes = read_lgd_planes(rec["logos"][truth["painted_logo_file"]])
    return load_family(cell).reference(
        cell.config, traffic.recording_from_truth(truth, geometry,
                                                  truth["seed"]),
        truth, geometry, planes, dtype or torch.float32, device)


def sample_for(ref, seed: int) -> list:
    """The output frames the encoder keeps whole for the comparison."""
    return compare.sample_indices(ref.num_out, seed, SAMPLE_FRAMES,
                                  ref.seams())


def read_lgd_planes(path: str) -> list:
    """The six A/B window planes of a logo file written by write_lgd."""
    with open(path, "rb") as f:
        data = f.read()
    at = traffic._LGD_FILE_HEADER.size
    base = traffic._LGD_BASE_HEADER.unpack_from(data, at)
    at += traffic._LGD_BASE_HEADER.size + base[3] * base[4] * \
        traffic.LGD_PIXEL_BYTES
    hdr = traffic._LGD_AMT_HEADER.unpack_from(data, at)
    at += traffic._LGD_AMT_HEADER.size
    w, h = hdr[2], hdr[3]
    out = []
    for ph, pw in ((h, w),) * 2 + ((h // 2, w // 2),) * 4:
        out.append(np.frombuffer(data, "<f4", ph * pw, at).reshape(ph, pw))
        at += ph * pw * 4
    return out


def check(cell: Cell, ref, keep: list, win, recorder: Recorder,
          dev) -> dict:
    """The compared numbers of the window's recordings, by the cell's
    family."""
    ref.device = dev
    expected = ref.frames(keep)
    by_src = {}
    for d in recorder.decisions.values():
        by_src[Path(d["src"]).parent.name] = d
    served, cms, filters = [], [], []
    for r in win.recordings:
        d = by_src.get(f"rec{r.index}", {})
        cm = d.get("cm")
        if cm is not None:
            cm = dict(cm, logo_file=logo_index(cm["logo_path"]))
        cms.append(cm)
        filters.append(d.get("filter"))
        served.append(compare.load_served(r.result.get("report"))
                      if r.result.get("ok") else None)
    return load_family(cell).numbers(ref, expected, served, cms, filters)


def logo_index(path) -> int | None:
    name = Path(path or "").name
    if name.startswith("logo") and name.endswith(".lgd"):
        return int(name[4:-4])
    return None


class RunData:
    """What a per-layer reader reads: the cell, the recording's truth, the
    window, the spans and, with a trace, the device events on the host
    clock."""

    def __init__(self, cell, rec, geometry, win, recorder, t0, t1):
        self.cell, self.rec, self.geometry = cell, rec, geometry
        self.truth = rec["truth"]
        self.window = win
        self.spans = recorder.spans
        self.t0, self.t1 = t0, t1
        self.events = None

    def reports(self) -> list:
        return [r.result["report"] for r in self.window.recordings
                if r.result.get("ok")]

    def spans_of(self, name: str) -> list:
        return [s for s in self.spans if s.name == name
                and s.t1 > self.t0 and s.t0 < self.t1]

    @property
    def source_frames(self) -> int:
        return self.window.frames
