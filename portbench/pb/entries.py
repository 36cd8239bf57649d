"""The entries the window drives: `amatsukaze_tpu_torch.cli.main` in this
process, one recording after another, or the port's EncodeServer with its
jobs queued over its RPC. Each recording gets its own path to the TS (a
hard link to the cached recording, or a copy where links fail), its own
work and output directories under TMPDIR, and nothing else carries from
one recording to the next but the process's built kernels and libraries.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

from . import fake_encoder, window


class _NoOracle:
    """Stands in for a pure-Python decoder: the native engine must decode,
    with no hidden fallback."""

    def __init__(self, *a, **kw):
        raise AssertionError("decode fell back to a pure-Python decoder: "
                             "the native engine did not run")


@contextmanager
def native_decoders_only():
    import amatsukaze_tpu_torch.video as video
    from amatsukaze_tpu_torch.video import h264_ref, h265_ref

    with mock.patch.object(video, "Mpeg2RefDecoder", _NoOracle), \
            mock.patch.object(h264_ref, "H264RefDecoder", _NoOracle), \
            mock.patch.object(h265_ref, "H265RefDecoder", _NoOracle):
        yield


def write_encoder(path: Path) -> str:
    """A launcher for fake_encoder.py with this interpreter."""
    script = Path(fake_encoder.__file__).resolve()
    path.write_text(f"#!/bin/sh\nexec '{sys.executable}' '{script}' \"$@\"\n")
    path.chmod(0o755)
    return str(path)


def place_source(src: str, dst: Path) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def cli_args(config: dict, rec: dict) -> list:
    args = list(config["cli_args"])
    if rec["truth"]["logos_given"]:
        for lgd in rec["logos"]:
            args += ["--logo", lgd]
    return args


class CliEntry:
    """cli.main(argv, device) over each recording, in this process."""

    def __init__(self, config: dict, rec: dict, work: Path, encoder: str,
                 device=None):
        self.config, self.rec, self.work = config, rec, work
        self.encoder, self.device = encoder, device

    def run_one(self, index: int, tag: str = "rec") -> dict:
        from amatsukaze_tpu_torch import cli

        d = self.work / f"{tag}{index}"
        shutil.rmtree(d, ignore_errors=True)
        (d / "work").mkdir(parents=True)
        src = d / "src.ts"
        place_source(self.rec["ts"], src)
        argv = ["-i", str(src), "-o", str(d / "out"), "-w", str(d / "work"),
                "-e", self.encoder, "-j", str(d / "report.json"),
                "--mpeg2decoder", "native", "--mode", "ts"]
        argv += cli_args(self.config, self.rec)
        try:
            rc = cli.main(argv, device=self.device)
        except Exception as e:  # noqa: BLE001 - a failed recording counts
            return dict(ok=False, error=repr(e))
        finally:
            src.unlink(missing_ok=True)
            shutil.rmtree(d / "work", ignore_errors=True)
        if rc != 0:
            return dict(ok=False, error=f"cli returned {rc}")
        with open(d / "report.json") as f:
            report = json.load(f)
        return dict(ok=True, report=report)

    def run_window(self, seconds: float, clock=time.perf_counter):
        return window.run_sequential(
            self.run_one, self.rec["truth"]["frames"], seconds, clock)


class ServerEntry:
    """The EncodeServer with `parallel` jobs at a time: each slot queues a
    recording over the AddQueue RPC and queues the next only while the last
    one's duration still fits in the window."""

    POLL_SECONDS = 0.02
    TIMEOUT = 300.0

    def __init__(self, config: dict, rec: dict, work: Path, encoder: str,
                 parallel: int, device=None):
        self.config, self.rec, self.work = config, rec, work
        self.encoder, self.parallel, self.device = encoder, parallel, device

    def run_window(self, seconds: float, clock=time.perf_counter):
        return asyncio.run(self._drive(seconds, clock))

    async def _drive(self, seconds: float, clock):
        from amatsukaze_tpu_torch.server.rpc import RpcClient
        from amatsukaze_tpu_torch.server.server import EncodeServer
        from amatsukaze_tpu_torch.utils.context import AMTContext

        data = self.work / "server"
        shutil.rmtree(data, ignore_errors=True)
        (data / "logo").mkdir(parents=True)
        if self.rec["truth"]["logos_given"]:
            for lgd in self.rec["logos"]:
                shutil.copyfile(lgd, data / "logo" / Path(lgd).name)
        server = EncodeServer(AMTContext(level="warn"), data_dir=str(data),
                              device=self.device)
        server.setting.num_parallel = self.parallel
        server.setting.work_dir = str(self.work / "server_work")
        port = await server.start(port=0)
        client = await RpcClient.connect("127.0.0.1", port)
        try:
            r = await client.call("SetProfile", dict(
                name="bench", encoder_path=self.encoder,
                **self.config["server_profile"]))
            if r != {"ok": True}:
                raise RuntimeError(f"SetProfile: {r}")
            return await self._loop(client, seconds, clock)
        finally:
            client.close()
            await server.stop()
            shutil.rmtree(self.work / "server_work", ignore_errors=True)

    async def _queue(self, client, index: int) -> int:
        d = self.work / f"rec{index}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        place_source(self.rec["ts"], d / "src.ts")
        r = await client.call("AddQueue", {
            "src": str(d / "src.ts"), "out": str(d / "out"),
            "profile": "bench"})
        if "item_id" not in r:
            raise RuntimeError(f"AddQueue: {r}")
        return r["item_id"]

    async def _loop(self, client, seconds: float, clock):
        frames = self.rec["truth"]["frames"]
        t0 = clock()
        live = {}  # item_id -> window.Recording
        done = []
        for slot in range(self.parallel):
            live[await self._queue(client, slot)] = window.Recording(
                slot, frames, clock())
        started = self.parallel
        while live:
            if clock() - t0 > self.TIMEOUT:
                raise RuntimeError(f"server: jobs not done in "
                                   f"{self.TIMEOUT} s")
            await asyncio.sleep(self.POLL_SECONDS)
            queue = {e["item_id"]: e for e in await client.call("GetQueue")}
            for item, r in list(live.items()):
                e = queue.get(item)
                if e is None or e["state"] in ("queue", "encoding"):
                    continue
                r.end = clock()
                ok = e["state"] == "complete" and e.get("last_report")
                r.result = dict(ok=bool(ok), report=e.get("last_report"),
                                error=None if ok else
                                f"{e['state']}: {e['console'][-5:]}")
                (self.work / f"rec{r.index}" / "src.ts").unlink(
                    missing_ok=True)
                done.append(r)
                del live[item]
                if window.may_start(clock() - t0, r.seconds, seconds,
                                    started, self.parallel):
                    live[await self._queue(client, started)] = \
                        window.Recording(started, frames, clock())
                    started += 1
        done.sort(key=lambda r: r.index)
        return window.Window(t0, done)


def make_entry(cell, rec: dict, work: Path, encoder: str, device=None):
    mix = cell.traffic
    if mix["entry"] == "cli" and mix["clients"] == 1:
        return CliEntry(cell.config, rec, work, encoder, device)
    if mix["entry"] == "server":
        return ServerEntry(cell.config, rec, work, encoder, mix["clients"],
                           device)
    raise ValueError(f"unknown arrivals {mix['entry']!r} x {mix['clients']}")
