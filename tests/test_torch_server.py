"""The port's encode server (parallel/scheduler.py, server/) against the JAX
package's.

- Scheduler: one numpy-seeded sequence of acquire, release, wait, cancel,
  queue, pause, force-start and phase operations drives both packages'
  ResourceManager, ScheduledQueue, WorkerPool and PhaseScheduler; the
  traces (admission order, costs, gpu_index, encoder_index, worker states)
  are equal.
- RPC: one script that calls every RPC method over TCP goes to a JAX
  EncodeServer and to a port EncodeServer(device="cpu"), both with the
  same fake run-item; every response and the saved app data are equal
  once the wall times and the run's own directory are normalised.
- Argv: make_cli_args over profiles, filter settings, service settings and
  logo files gives the same argv, which both CLIs parse to equal configs.
- End to end: the 96x128 short broadcast layout of utils/synth_ts.py (96
  frames, its two logos as .lgd files under the TS's service id in the
  server's logo directory) queued twice, in kfm_vfr and in yadif +
  deblock, with num_parallel 2 and a fake encoder: the JAX server runs its
  default pipeline on JAX on the CPU (its device path, Pallas in interpret
  mode, its TPU composition of yadif before the post chain, as
  tests/test_torch_transcode.py runs it), the port's on its plain PyTorch
  versions. The output files are byte-equal and the logs' reports equal
  apart from wall times and paths.
- ScanLogo through the server's logo_frame_source hook: the .lgd is the
  JAX server's byte for byte (tests/test_torch_logo_gen.py's equality).
- Without a card EncodeServer(ctx, dir) and server.cli.main raise.
- The binders that the server's concurrent pipelines may reach at once
  bind one at a time.

Tolerance: none; every compared value is equal.
"""

import asyncio
import ctypes
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_transcode import _yadif_as_on_tpu
from torch_compare import load_both_native, plain
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.cli as jcli
import amatsukaze_tpu.models.filter_graph as jfg_mod
import amatsukaze_tpu.models.logo as jlogo_model
import amatsukaze_tpu.parallel.scheduler as jsch
import amatsukaze_tpu.server.rpc as jrpc
import amatsukaze_tpu.server.server as jserver
from amatsukaze_tpu.utils.context import AMTContext as JContext

import amatsukaze_tpu_torch.cli as tcli
import amatsukaze_tpu_torch.parallel.scheduler as tsch
import amatsukaze_tpu_torch.server.rpc as trpc
import amatsukaze_tpu_torch.server.server as tserver
from amatsukaze_tpu_torch.models.lgd import save_lgd
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.utils.context import AMTContext

SIDES = {"jax": dict(sch=jsch, server=jserver, rpc=jrpc, cli=jcli,
                     ctx=JContext, kw={}),
         "port": dict(sch=tsch, server=tserver, rpc=trpc, cli=tcli,
                      ctx=AMTContext, kw={"device": "cpu"})}


def make_server(side, data_dir, **kw):
    s = SIDES[side]
    return s["server"].EncodeServer(s["ctx"](level="error"),
                                    data_dir=str(data_dir), **kw,
                                    **s["kw"])


def normalise(x, root):
    """A response with the run's directory written as <root>."""
    if isinstance(x, str):
        return x.replace(str(root), "<root>")
    if isinstance(x, list):
        return [normalise(v, root) for v in x]
    if isinstance(x, tuple):
        return tuple(normalise(v, root) for v in x)
    if isinstance(x, dict):
        return {normalise(k, root): normalise(v, root) for k, v in x.items()}
    return x


WALL_TIME_KEYS = {"added", "finished", "encode_seconds", "total", "free"}


def drop_times(x):
    if isinstance(x, (list, tuple)):
        return [drop_times(v) for v in x]
    if isinstance(x, dict):
        return {k: ("<t>" if k in WALL_TIME_KEYS else drop_times(v))
                for k, v in x.items()}
    return x


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _rm_state(rm):
    return (rm.cur_cpu, rm.cur_hdd, list(rm.cur_gpu[:3]),
            [w["cost"] for w in rm._waiting], sorted(rm._encode_ids))


async def _resource_trace(sch, seed):
    """ResourceManager: try/force/awaited acquires, releases, cancelled
    waiters and device caps in one seeded order."""
    rng = np.random.default_rng(seed)
    rm = sch.ResourceManager()
    rm.set_gpu_resources(2, [100, 60])
    out, held, tasks, admitted = [], [], [], []

    async def waiter(k, req, enc):
        res = await rm.get_resource(req, enc)
        admitted.append((k, res.gpu_index, res.encoder_index))
        held.append(res)

    for step in range(80):
        op = int(rng.integers(0, 7))
        req = sch.ReqResource(*(int(v) for v in rng.integers(0, 70, 3)))
        enc = bool(rng.integers(0, 2))
        if op == 0:
            res = rm.try_get_resource(req, enc)
            out.append(("try", None if res is None
                        else (res.gpu_index, res.encoder_index)))
            if res is not None:
                held.append(res)
        elif op in (1, 2):
            tasks.append(asyncio.ensure_future(waiter(step, req, enc)))
        elif op == 3 and held:
            rm.release_resource(held.pop(int(rng.integers(0, len(held)))))
        elif op == 4:
            out.append(("cost", rm.resource_cost(req)))
        elif op == 5:
            live = [t for t in tasks if not t.done()]
            if live:
                live[int(rng.integers(0, len(live)))].cancel()
        elif op == 6 and step % 20 == 6:
            rm.set_gpu_resources(int(rng.integers(1, 3)),
                                 [int(v) for v in rng.integers(40, 101, 2)])
        for _ in range(3):
            await asyncio.sleep(0)
        out.append((step, op, _rm_state(rm), list(admitted)))
    while held or any(not t.done() for t in tasks):
        if held:
            rm.release_resource(held.pop(0))
        await asyncio.sleep(0)
    await asyncio.gather(*tasks, return_exceptions=True)
    out.append(("end", _rm_state(rm), admitted))
    return out


async def _pool_trace(sch, seed):
    """ScheduledQueue + WorkerPool: items of five priorities and their
    Encode requests, parallel slots, user and scheduled pauses, ForceStart
    and finishing items in one seeded order."""
    rng = np.random.default_rng(seed)
    q = sch.ScheduledQueue(enable_resource_scheduling=bool(seed % 3))
    started, gates, items = [], {}, {}
    errors = []

    async def run_item(wid, item, force):
        started.append((wid, item.item_id, force))
        gates[item.item_id] = asyncio.Event()
        await gates[item.item_id].wait()
        if item.item_id % 7 == 0:
            raise RuntimeError("item failed")

    async def on_error(wid, msg, exc):
        errors.append((wid, msg, str(exc)))

    pool = sch.WorkerPool(q, run_item, on_error=on_error)
    pool.set_num_parallel(int(rng.integers(1, 4)))
    out = []
    for step in range(70):
        op = int(rng.integers(0, 8))
        if op in (0, 1):
            k = len(items) + 1
            req = {"Encode": sch.ReqResource(
                *(int(v) for v in rng.integers(0, 60, 3)))}
            items[k] = sch.QueueItem(item_id=k,
                                     priority=int(rng.integers(0, 7)),
                                     order=k, req_resources=req)
            q.add_queue(items[k])
        elif op == 2:
            live = sorted(k for k, g in gates.items() if not g.is_set())
            if live:
                gates[live[int(rng.integers(0, len(live)))]].set()
        elif op == 3:
            pool.set_pause(bool(rng.integers(0, 2)),
                           scheduled=bool(rng.integers(0, 2)))
        elif op == 4:
            pending = [it for level in q.levels for its in level.values()
                       for it in its]
            if pending:
                it = pending[int(rng.integers(0, len(pending)))]
                q.remove_queue(it)
                pool.force_start(it)
        elif op == 5:
            pool.set_num_parallel(int(rng.integers(0, 4)))
        elif op == 6:
            q.resource_manager.force_get_resource(sch.ReqResource(
                *(int(v) for v in rng.integers(0, 30, 3))))
        elif op == 7:
            pending = [it for level in q.levels for its in level.values()
                       for it in its]
            if pending:
                it = pending[int(rng.integers(0, len(pending)))]
                it.order = -step if rng.integers(0, 2) else 1000 + step
                it.priority = int(rng.integers(1, 6))
                q.make_dirty()
        for _ in range(3):
            await asyncio.sleep(0)
        out.append((step, op, list(started), list(pool.worker_states),
                    sorted(pool.parking), pool.num_running, pool.is_paused,
                    [(it.item_id, r.canonical()) for it, r in q.actives],
                    (q._acpu, q._ahdd, q._agpu), list(errors)))
    pool.set_pause(False)
    pool.set_pause(False, scheduled=True)
    pool.set_num_parallel(3)
    for _ in range(200):
        for g in gates.values():
            g.set()
        await asyncio.sleep(0)
    out.append(("end", list(started), pool.num_running, q.actives,
                list(errors)))
    return out


async def _phase_trace(sch, seed):
    """PhaseScheduler: jobs walking the five phases with seeded requests on
    one ResourceManager; each phase entry's resources and the manager's
    state, in the order they happen."""
    rng = np.random.default_rng(seed)
    rm = sch.ResourceManager()
    rm.set_gpu_resources(1, [100])
    log = []

    async def job(k):
        res = {p: sch.ReqResource(*(int(v) for v in rng.integers(0, 60, 3)))
               for p in sch.PHASES}
        ps = sch.PhaseScheduler(rm, res)
        for p in sch.PHASES:
            r = await ps.wait_async(p)
            log.append((k, p, r.gpu_index, r.encoder_index, _rm_state(rm)))
            for _ in range(int(rng.integers(0, 4))):
                await asyncio.sleep(0)
        ps.release()
        log.append((k, "released", _rm_state(rm)))

    await asyncio.gather(*(job(k) for k in range(6)))
    with pytest.raises(ValueError):
        await sch.PhaseScheduler(rm, {}).wait_async("Unknown")
    return log


TRACES = {"resources": _resource_trace, "pool": _pool_trace,
          "phases": _phase_trace}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("what", list(TRACES))
def test_scheduler_trace_equals_jax(what, seed):
    jax, port = (plain(asyncio.run(TRACES[what](SIDES[s]["sch"], seed)))
                 for s in ("jax", "port"))
    assert port == jax
    assert len(port) > 1


def test_phase_scheduler_sync_bridge():
    """PhaseScheduler.wait from a thread with the loop given (the
    pipeline's thread) and without one (its own asyncio.run): the same
    resources in both packages."""
    def run(sch):
        async def main():
            rm = sch.ResourceManager()
            res = {p: sch.ReqResource(10, 10, 20) for p in sch.PHASES}
            ps = sch.PhaseScheduler(rm, res, loop=asyncio.get_running_loop())
            loop = asyncio.get_running_loop()
            got = []
            for p in sch.PHASES:
                r = await loop.run_in_executor(None, ps.wait, p)
                got.append((p, r.gpu_index, r.encoder_index, _rm_state(rm)))
            ps.release()
            return got, _rm_state(rm)

        threaded = asyncio.run(main())
        rm = sch.ResourceManager()
        ps = sch.PhaseScheduler(rm, {"Encode": sch.ReqResource(1, 2, 3)})
        r = ps.wait("Encode")
        return threaded, (r.gpu_index, r.encoder_index, _rm_state(rm))

    assert plain(run(tsch)) == plain(run(jsch))


# ---------------------------------------------------------------------------
# the RPC surface
# ---------------------------------------------------------------------------

async def fake_run(server, wid, entry, phase):
    """The same stand-in for a transcode in both packages: two phases, a
    console line, an output name; sources named bad*.ts fail."""
    await phase.wait_async("TSAnalyze")
    await phase.wait_async("Encode")
    server.append_console(entry, f"ran item {entry.item_id} on {wid}")
    entry.out_files = [entry.out_path + ".mp4"]
    return not os.path.basename(entry.src_path).startswith("bad")


def _rpc_root(root):
    """Sources, a directory of recordings, a logo file and a DRCS bitmap."""
    root.mkdir(parents=True)
    for name in ("a.ts", "b.ts", "bad.ts"):
        (root / name).write_bytes(b"\x47" + bytes(187))
    (root / "dir").mkdir()
    for name in ("c.ts", "d.m2ts", "notes.txt"):
        (root / "dir" / name).write_bytes(b"\x47" + bytes(187))
    from amatsukaze_tpu_torch.models.lgd import LogoData, LogoHeader

    lg = LogoData.create(LogoHeader(16, 8, 1, 1, 1440, 1080, 100, 60,
                                    "chan", 1024))
    (root / "data" / "logo").mkdir(parents=True)
    save_lgd(str(root / "data" / "logo" / "chan.lgd"), lg)
    (root / "data" / "drcs").mkdir()
    (root / "data" / "drcs" / ("ab" * 16 + ".bmp")).write_bytes(b"BM fake")


def _rpc_script(root):
    """(method, payload) in order; "@settle" steps wait for the queue to
    drain and record nothing."""
    r = str(root)
    fs = {"enable_deinterlace": True, "deinterlace_algorithm": "Yadif",
          "enable_deblock": True, "enable_resize": True}
    return [
        ("GetSetting", None),
        ("SetSetting", {"pause_windows": "bad"}),
        ("SetSetting", {"max_retries": 1, "finish_action": "rm -rf /",
                        "num_parallel": 0, "unknown": 1}),
        ("SetProfile", {"name": "anime", "encoder_type": "x265",
                        "filter_setting": fs, "rename_format": "$title$"}),
        ("GetProfiles", None),
        ("PreviewFilter", fs),
        ("RemoveProfile", {"name": "none-such"}),
        ("AddQueue", {"src": f"{r}/a.ts", "out": f"{r}/out/a"}),
        ("AddQueue", {"src": f"{r}/b.ts", "profile": "anime",
                      "priority": 5, "service_id": 1024}),
        ("AddQueue", {"src": f"{r}/bad.ts", "out": f"{r}/out/bad"}),
        ("AddQueue", {"src": f"{r}/dir", "out": f"{r}/out"}),
        ("@scan", None),
        ("GetQueue", None),
        ("ChangeItem", {"item_id": 1, "type": "priority", "priority": 9}),
        ("ChangeItem", {"item_id": 2, "type": "move_top"}),
        ("ChangeItem", {"item_id": 1, "type": "move_bottom"}),
        ("ChangeItem", {"item_id": 1, "type": "duplicate"}),
        ("ChangeItem", {"item_id": 2, "type": "profile",
                        "profile": "default"}),
        ("ChangeItem", {"item_id": 1, "type": "reset"}),
        ("ChangeItem", {"item_id": 1, "type": "no-such-type"}),
        ("ChangeItem", {"item_id": 99, "type": "priority"}),
        ("AddTag", {"item_id": 1, "tag": "news"}),
        ("AddTag", {"item_id": 1, "tag": "news"}),
        ("SetPriority", {"item_id": 2, "priority": 4}),
        ("GetOutFiles", {"item_id": 1}),
        ("GetConsole", {"item_id": 3}),
        ("CancelItem", {"item_id": 5}),
        ("CancelItem", {"item_id": 5}),
        ("PauseEncode", {"pause": True}),
        ("SetNumParallel", {"n": 1}),
        ("GetState", None),
        ("PauseEncode", {"pause": False}),
        ("@settle", None),
        ("GetQueue", None),
        ("GetLogs", None),
        ("GetLogFile", {"id": 1}),
        ("GetLogFile", {"file": "item3_try1.txt"}),
        ("GetLogFile", {"file": "../setting.json"}),
        ("GetLogFile", {"id": 12345}),
        ("GetConsole", {"item_id": 3}),
        ("RetryItem", {"item_id": 3}),
        ("RetryItem", {"item_id": 1}),
        ("@settle", None),
        ("ChangeItem", {"item_id": 2, "type": "update_profile",
                        "profile": "anime"}),
        ("@settle", None),
        ("SetNumParallel", {"n": 0}),
        ("ChangeItem", {"item_id": 1, "type": "reset"}),
        ("ChangeItem", {"item_id": 1, "type": "force_start"}),
        ("@settle", None),
        ("ChangeItem", {"item_id": 4, "type": "remove_source"}),
        ("ChangeItem", {"item_id": 6, "type": "remove"}),
        ("ChangeItem", {"item_id": 0, "type": "remove_completed"}),
        ("GetQueue", None),
        ("SetFinishAction", {"command": "reboot-everything"}),
        ("SetFinishAction", {"command": "suspend", "seconds": 600}),
        ("CancelSleep", None),
        ("SetFinishAction", {"command": ""}),
        ("CancelAddQueue", None),
        ("GetServices", None),
        ("SetServiceSetting", {"service_id": 0}),
        ("SetServiceSetting", {
            "service_id": 1024, "service_name": "NHK",
            "disable_cm_check": False, "jls_command": "JL_std.txt",
            "logo_settings": [{"file_name": "chan.lgd", "enabled": False},
                              "junk"]}),
        ("GetServices", None),
        ("SetAutoSelect", {"rules": [{"service_id": 1024,
                                      "profile": "anime", "priority": 5}]}),
        ("GetAutoSelect", None),
        ("GetDrcsImages", None),
        ("AddDrcsMapping", {"md5": "ab" * 16, "text": "〓"}),
        ("AddDrcsMapping", {"md5": "short", "text": "x"}),
        ("GetDrcsImages", None),
        ("GetLogoFiles", None),
        ("RenameLogo", {"file": "chan.lgd", "name": "renamed"}),
        ("RenameLogo", {"file": "none.lgd", "name": "x"}),
        ("GetLogoFiles", None),
        ("ScanLogo", {"src": f"{r}/missing.ts", "rect": [0, 0, 8, 8]}),
        ("ScanLogo", {"src": f"{r}/a.ts"}),
        ("GetGenreTable", None),
        ("GetDiskSpace", None),
        ("NoSuchMethod", {}),
        ("GetState", None),
        ("EndServer", None),
    ]


async def _drive_rpc(side, root):
    server = make_server(side, root / "data", run_item=fake_run)
    server.setting.num_parallel = 0
    server.setting.work_dir = str(root / "work")
    port = await server.start(port=0)
    client = await SIDES[side]["rpc"].RpcClient.connect("127.0.0.1", port)
    out = []
    try:
        for method, payload in _rpc_script(root):
            if method == "@scan":
                while server._add_scan["state"] == "scanning":
                    await asyncio.sleep(0.01)
                continue
            if method == "@settle":
                for _ in range(500):
                    await asyncio.sleep(0.01)
                    if not any(e.state in ("queue", "encoding")
                               for e in server.entries.values()) \
                            and not server.queue.actives:
                        break
                continue
            out.append((method, await client.call(method, payload)))
        ended = server.end_requested.is_set()
    finally:
        client.close()
        await server.stop()
    saved = {}
    for dirpath, _, files in os.walk(root / "data"):
        for f in files:
            if f == "server.lock":
                continue
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                data = fh.read()
            if f.endswith(".json"):
                data = json.loads(data)
            saved[os.path.relpath(p, root)] = data
    return dict(responses=normalise(drop_times(out), root),
                saved=normalise(drop_times(saved), root), ended=ended,
                sources=sorted(os.listdir(root)))


@pytest.fixture(scope="module")
def rpc_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("rpc")
    runs = {}
    for side in SIDES:
        _rpc_root(base / side)
        runs[side] = asyncio.run(_drive_rpc(side, base / side))
    return runs


def _steps():
    return [m for m, _ in _rpc_script("/r") if not m.startswith("@")]


@pytest.mark.parametrize("k", range(len(_steps())),
                         ids=[f"{k}-{m}" for k, m in enumerate(_steps())])
def test_rpc_response_equals_jax(rpc_runs, k):
    jax, port = rpc_runs["jax"]["responses"][k], rpc_runs["port"][
        "responses"][k]
    assert port[0] == jax[0] == _steps()[k]
    assert port == jax


def test_rpc_app_data_equal_jax(rpc_runs):
    jax, port = rpc_runs["jax"], rpc_runs["port"]
    assert port["ended"] and jax["ended"]
    assert port["sources"] == jax["sources"]
    assert sorted(port["saved"]) == sorted(jax["saved"])
    for name in port["saved"]:
        assert port["saved"][name] == jax["saved"][name], name
    states = {e["state"] for e in port["saved"]["data/queue.json"]}
    assert {"failed", "canceled"} <= states
    logged = {x["state"] for x in port["saved"]["data/logs.json"]}
    assert {"complete", "failed", "queue"} == logged  # "queue": retried


# ---------------------------------------------------------------------------
# the CLI line
# ---------------------------------------------------------------------------

ARGV_PROFILES = [
    dict(),
    dict(encoder_type="x265", encoder_path="/usr/local/bin/x265", chapter=True,
         logo_paths=["/l/a.lgd"], cm_out_mask=6, auto_bitrate=True,
         bitrate_a=0.2, bitrate_b=300, bitrate_h264=1.2, two_pass=True,
         split_sub=True, subtitles=True, ignore_no_logo=False),
    dict(filter_mode="kfm_vfr", encoder_options="--crf 20",
         loose_logo_detection=True, ignore_no_drcs_map=True,
         audio_encoder_type="neroAac", audio_encoder_path="/usr/local/bin/neroAacEnc",
         output_format="mkv", jls_command_file="JL_prof.txt",
         jls_option="prof-opt", enable_jls_option=True),
    dict(filter_setting=dict(enable_deinterlace=True,
                             deinterlace_algorithm="Yadif",
                             enable_deblock=True)),
    dict(filter_setting=dict(enable_deinterlace=True,
                             deinterlace_algorithm="AutoVfr",
                             auto_vfr_parallel=3, kfm_enable_ucf=False,
                             enable_temporal_nr=True, enable_deband=True,
                             enable_edge_level=True, enable_resize=True)),
    dict(filter_setting=dict(enable_deinterlace=True,
                             deinterlace_algorithm="KFM", kfm_fps="SVP",
                             kfm_enable_nr=True), filter_mode="yadif"),
    dict(filter_mode="qtgmc", output_format="m2ts", bitrate_cm=0.3),
]
ARGV_ENTRIES = [  # (service_id, service setting)
    (-1, None),
    (1024, None),
    (1024, {"disable_cm_check": False, "jls_command": "JL_svc.txt",
            "jls_option": "svc-opt", "logo_settings": [
                {"file_name": "a1024.lgd", "enabled": False},
                {"file_name": "### NO LOGO ###", "enabled": True}]}),
    (2048, {"disable_cm_check": True, "logo_settings": [
        {"file_name": "b2048.lgd", "enabled": True,
         "from": "2026-01-01T00:00:00", "to": "2026-02-01T00:00:00"}]}),
]


def _argv_run(side, root, k):
    from amatsukaze_tpu_torch.models.lgd import LogoData, LogoHeader

    server = make_server(side, root)
    for name, sid in (("a1024.lgd", 1024), ("c1024.lgd", 1024),
                      ("b2048.lgd", 2048)):
        save_lgd(os.path.join(server.logo_dir(), name), LogoData.create(
            LogoHeader(16, 8, 1, 1, 1440, 1080, 0, 0, name, sid)))
    mod = SIDES[side]
    profile = mod["server"].ProfileSetting(name="p", **ARGV_PROFILES[k])
    out = []
    for sid, svc in ARGV_ENTRIES:
        if svc is not None:
            server.service_settings[sid] = svc
        entry = mod["server"].QueueEntry(
            item_id=1, src_path="/rec/in.ts", out_path="/out/x",
            service_id=sid, ts_time="2026-01-15T12:00:00")
        argv = server.make_cli_args(entry, profile)
        conf = mod["cli"].args_to_config(mod["cli"].build_parser()
                                         .parse_args(argv))
        out.append((argv, plain(conf)))
    return normalise(out, root)


@pytest.mark.parametrize("k", range(len(ARGV_PROFILES)))
def test_make_cli_args_equal_jax(tmp_path, k):
    jax, port = (_argv_run(side, tmp_path / side, k) for side in SIDES)
    assert [a for a, _ in port] == [a for a, _ in jax]
    for (_, got), (_, want) in zip(port, jax):
        assert got[1] == want[1]  # Config's fields, enums by name
    assert all("--drcs" in a for a, _ in port)


# ---------------------------------------------------------------------------
# end to end: two queued transcodes at once, and the logo scan
# ---------------------------------------------------------------------------

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
E2E_PROFILES = {
    "kfm": dict(filter_mode="kfm_vfr"),
    "yadif": dict(filter_setting=dict(
        enable_deinterlace=True, deinterlace_algorithm="Yadif",
        yadif_fps="CFR30", enable_deblock=True)),
}


@pytest.fixture(scope="module")
def e2e_source(tmp_path_factory):
    load_both_native()
    base = tmp_path_factory.mktemp("server_e2e")
    ts, _, logos = synth_ts.ts_clip("small", str(base / "rec.ts"))
    from amatsukaze_tpu_torch.ts.info import TsInfo

    info = TsInfo(AMTContext(level="error"))
    info.read_file(ts.path)
    sid = info.programs[0].service_id
    enc = base / "fake_x264"
    enc.write_text(FAKE_ENCODER)
    enc.chmod(0o755)
    return dict(base=base, ts=ts.path, logos=logos, sid=sid, enc=str(enc))


async def _drive_e2e(side, root, src):
    server = make_server(side, root / "data")
    server.setting.num_parallel = 2
    server.setting.work_dir = str(root / "work")
    for k, lg in enumerate(src["logos"]):
        save_lgd(os.path.join(server.logo_dir(), f"logo{k}.lgd"),
                 dataclasses.replace(lg, header=dataclasses.replace(
                     lg.header, service_id=src["sid"])))
    port = await server.start(port=0)
    client = await SIDES[side]["rpc"].RpcClient.connect("127.0.0.1", port)
    try:
        for name, prof in E2E_PROFILES.items():
            await client.call("SetProfile", dict(name=name,
                                                 encoder_path=src["enc"],
                                                 **prof))
        for name in E2E_PROFILES:
            await client.call("AddQueue", {
                "src": src["ts"], "out": str(root / "out" / name),
                "profile": name})
        peak = 0
        for _ in range(3000):
            await asyncio.sleep(0.02)
            peak = max(peak, sum(e.state == "encoding"
                                 for e in server.entries.values()))
            if all(e.state not in ("queue", "encoding")
                   for e in server.entries.values()):
                break
        queue = await client.call("GetQueue")
        logs = await client.call("GetLogs")
        rm = server.queue.resource_manager
        idle = (rm.cur_cpu, rm.cur_hdd, rm.cur_gpu[0], rm._encode_ids)
    finally:
        client.close()
        await server.stop()
    outs = {}
    for e in queue:
        for path in e["out_files"]:
            with open(path, "rb") as f:
                outs[os.path.relpath(path, root)] = f.read()
    return dict(queue=queue, logs=logs, outs=outs, peak=peak, idle=idle)


@pytest.fixture(scope="module")
def e2e_runs(e2e_source):
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlogo_model, "_HOST_OPS", False)  # the device path
        mp.setenv("AMATSUKAZE_SCENE_METRICS", "device")
        mp.setenv("AMATSUKAZE_FILTER_BACKEND", "device")
        mp.setattr(jfg_mod.FilterGraph, "_fused_yadif", _yadif_as_on_tpu)
        for side in SIDES:
            root = e2e_source["base"] / side
            runs[side] = asyncio.run(_drive_e2e(side, root, e2e_source))
            runs[side]["root"] = root
    return runs


def test_e2e_both_jobs_complete_at_once(e2e_runs):
    for side, run in e2e_runs.items():
        assert [(e["profile_name"], e["state"], e["retry_count"])
                for e in run["queue"]] == [("kfm", "complete", 0),
                                           ("yadif", "complete", 0)], side
        assert run["peak"] == 2, side  # num_parallel 2: both at once
        assert run["idle"] == (0, 0, 0, set()), side


@pytest.mark.parametrize("name", list(E2E_PROFILES))
def test_e2e_outputs_byte_equal_jax(e2e_runs, name):
    jax, port = e2e_runs["jax"]["outs"], e2e_runs["port"]["outs"]
    assert sorted(port) == sorted(jax)
    (path,) = [p for p in port if p.startswith(f"out/{name}")]
    assert port[path][:9] == b"YUV4MPEG2" and len(port[path]) > 10 ** 5
    assert port[path] == jax[path]


@pytest.mark.parametrize("name", list(E2E_PROFILES))
def test_e2e_reports_equal_jax(e2e_runs, e2e_source, name):
    def report(side):
        run = e2e_runs[side]
        (log,) = [x for x in run["logs"] if x["profile"] == name]
        rep = normalise(dict(log["report"]), run["root"])
        waits = rep.pop("encodewaits")
        logofiles = rep.pop("logofiles")
        return rep, len(waits), [os.path.basename(p) for p in logofiles], \
            normalise(log["out_files"], run["root"])

    assert report("port") == report("jax")
    rep, n_waits, logofiles, outs = report("port")
    assert n_waits == 1 and logofiles == ["logo0.lgd"]
    assert outs == [f"<root>/out/{name}.mp4"]


def test_scan_logo_equals_jax(tmp_path):
    """ScanLogo over 300 frames of test_models_logo's recovery clip, fed
    through the logo_frame_source hook: done, and the .lgd is the JAX
    server's byte for byte."""
    from test_models_logo import IMGH, IMGW, LH, LW, frame_with_logo, \
        synth_logo_ab

    _, _, alpha = synth_logo_ab()
    rng = np.random.default_rng(0)
    clip = []  # made once: frame_with_logo draws from a shared generator
    for _ in range(300):
        bg = float(rng.uniform(30, 140))
        clip.append(frame_with_logo(bg, alpha, on=rng.random() < 0.8))

    def frames(src):
        return iter(clip), IMGW, IMGH

    async def scan(side):
        server = make_server(side, tmp_path / side)
        server.logo_frame_source = frames
        await server.start(port=0)
        (tmp_path / "src.ts").write_bytes(b"\x47" * 188)
        r = await server.handle_request("ScanLogo", {
            "src": str(tmp_path / "src.ts"), "rect": [8, 8, LW, LH],
            "name": "scanned", "service_id": 5})
        for _ in range(3000):
            await asyncio.sleep(0.02)
            if server._logo_scan["state"] != "running":
                break
        state = dict(server._logo_scan)
        files = await server.handle_request("GetLogoFiles", None)
        await server.stop()
        with open(r["out"], "rb") as f:
            return normalise((r, state, files), tmp_path / side), f.read()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlogo_model, "_HOST_OPS", False)
        (jr, jdata), (tr, tdata) = (asyncio.run(scan(s)) for s in SIDES)
    assert tr == jr
    assert tr[1]["state"] == "done" and tr[2][0]["name"] == "scanned"
    assert tdata == jdata


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_server_needs_a_card_unless_given_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ctx = AMTContext(level="error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver.EncodeServer(ctx, str(tmp_path / "d"))
    from amatsukaze_tpu_torch.server import cli as server_cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server_cli.main(["--data", str(tmp_path / "d2"), "--port", "0",
                         "--web-port", "-1"])
    assert not (tmp_path / "d2" / "server.lock").exists()
    s = tserver.EncodeServer(ctx, str(tmp_path / "d3"), device="cpu")
    assert s.device == torch.device("cpu")


def test_jobs_and_scans_get_the_servers_device(tmp_path, monkeypatch):
    """_default_run_item hands the server's device to TranscodePipeline and
    _start_logo_scan to LogoAnalyzer."""
    import amatsukaze_tpu_torch.models.logo as tlogo
    import amatsukaze_tpu_torch.pipeline.transcode as ttrans

    seen = []

    class Pipe:
        def __init__(self, ctx, settings, **kw):
            seen.append(("pipeline", kw["device"], kw["phase_scheduler"]))

        def run(self):
            return {"outfiles": [{"path": "x.mp4"}]}

    class Analyzer:
        def __init__(self, ctx, region, **kw):
            seen.append(("analyzer", kw["device"]))

        def scan(self, *a, **kw):
            pass

        def save(self, path):
            open(path, "wb").close()

    monkeypatch.setattr(ttrans, "TranscodePipeline", Pipe)
    monkeypatch.setattr(tlogo, "LogoAnalyzer", Analyzer)
    server = tserver.EncodeServer(AMTContext(level="error"),
                                  str(tmp_path / "d"), device="cpu")
    server.setting.work_dir = str(tmp_path / "w")
    entry = tserver.QueueEntry(item_id=1, src_path=str(tmp_path / "a.ts"),
                               out_path=str(tmp_path / "o" / "a"))

    async def main():
        ok = await server._default_run_item(server, 0, entry, "phases")
        server.logo_frame_source = lambda src: (iter(()), 16, 16)
        (tmp_path / "a.ts").write_bytes(b"")
        r = await server._start_logo_scan({"src": str(tmp_path / "a.ts"),
                                           "rect": [0, 0, 8, 8]})
        for _ in range(500):
            await asyncio.sleep(0.01)
            if server._logo_scan["state"] != "running":
                break
        return ok, r

    ok, r = asyncio.run(main())
    assert ok and r["ok"] and server._logo_scan["state"] == "done"
    assert seen == [("pipeline", torch.device("cpu"), "phases"),
                    ("analyzer", torch.device("cpu"))]
    assert entry.out_files == ["x.mp4"]


# ---------------------------------------------------------------------------
# binders reached by several pipelines at once
# ---------------------------------------------------------------------------

def _hammer(fn, n_threads=32):
    """fn() from n_threads threads released together, the interpreter
    switching threads as often as it can; the exceptions raised."""
    barrier = threading.Barrier(n_threads)
    errors = []

    def body():
        barrier.wait()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return errors


def test_mpeg2_binder_binds_once_per_library(monkeypatch):
    """video/native.py's _bind from 32 threads on a fresh library handle:
    every thread finds every signature set once it returns."""
    from amatsukaze_tpu_torch.ts.native import load_native
    from amatsukaze_tpu_torch.video import native as vnative

    lib = load_native()
    if lib is None:
        pytest.skip("native/libamatsukaze_native.so did not build")
    for _ in range(20):
        fresh = ctypes.CDLL(lib._name)
        monkeypatch.setattr(vnative, "_sigs_done", False)

        def bind_and_check():
            vnative._bind(fresh)
            assert fresh.M2V_Create.restype is ctypes.c_void_p
            assert fresh.M2V_PopFrame.argtypes is not None
            assert fresh.M2V_Errors.restype is ctypes.c_longlong

        assert _hammer(bind_and_check) == []


@pytest.mark.parametrize("module", ["fused_filter", "logo_eval"])
def test_kernel_binders_bind_once(monkeypatch, module):
    """The kernels' _kernel() from 32 threads at once: the library is
    loaded and the launch function bound by one of them, and every thread
    gets that function with its signature set."""
    import importlib
    import time

    mod = importlib.import_module(f"amatsukaze_tpu_torch.ops.{module}")
    loads = []

    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):  # a new function object per lookup
            time.sleep(0.001)
            return Fn()

    def load(name, extra_flags=()):
        loads.append(name)
        time.sleep(0.01)
        return Lib()

    monkeypatch.setattr(mod.cuda_lib, "load", load)
    monkeypatch.setattr(mod, "_fn", None)
    got = []

    def call():
        fn = mod._kernel()
        assert fn.restype is ctypes.c_int and fn.argtypes
        got.append(fn)

    assert _hammer(call) == []
    assert len(loads) == 1 and len({id(f) for f in got}) == 1
