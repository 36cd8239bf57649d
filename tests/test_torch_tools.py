"""The port's copies of the server's helpers (server/genre.py, rename.py,
drcs.py, filter_setting.py, rpc.py) and of the side tools (tools/
hash_check.py, file_cutter.py, add_task.py, user_script.py,
script_command.py) against the JAX package's, over tables of inputs.

Tolerance: none. Every output is equal (names, argument lists, files and
hash lists byte for byte, the RPC frames byte for byte), and the two
packages' AddTask tools each queue a recording on the other's server.
"""

import asyncio
import dataclasses
import os

import numpy as np
import pytest
from torch_compare import plain
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.server.drcs as jdrcs
import amatsukaze_tpu.server.filter_setting as jfs
import amatsukaze_tpu.server.genre as jgenre
import amatsukaze_tpu.server.rename as jrename
import amatsukaze_tpu.server.rpc as jrpc
import amatsukaze_tpu.server.server as jserver
import amatsukaze_tpu.tools.add_task as jadd
import amatsukaze_tpu.tools.file_cutter as jcut
import amatsukaze_tpu.tools.hash_check as jhash
import amatsukaze_tpu.tools.user_script as juser
from amatsukaze_tpu.utils.context import AMTContext as JContext

import amatsukaze_tpu_torch.server.drcs as tdrcs
import amatsukaze_tpu_torch.server.filter_setting as tfs
import amatsukaze_tpu_torch.server.genre as tgenre
import amatsukaze_tpu_torch.server.rename as trename
import amatsukaze_tpu_torch.server.rpc as trpc
import amatsukaze_tpu_torch.server.server as tserver
import amatsukaze_tpu_torch.tools.add_task as tadd
import amatsukaze_tpu_torch.tools.file_cutter as tcut
import amatsukaze_tpu_torch.tools.hash_check as thash
import amatsukaze_tpu_torch.tools.user_script as tuser
from amatsukaze_tpu_torch.utils.context import AMTContext

BOTH = (("jax", dict(genre=jgenre, rename=jrename, drcs=jdrcs, fs=jfs,
                     rpc=jrpc, hash=jhash, cut=jcut, user=juser, add=jadd,
                     server=jserver, ctx=JContext)),
        ("port", dict(genre=tgenre, rename=trename, drcs=tdrcs, fs=tfs,
                      rpc=trpc, hash=thash, cut=tcut, user=tuser, add=tadd,
                      server=tserver, ctx=AMTContext)))


def both(fn):
    """fn(modules) for the JAX package and for the port."""
    return [fn(mods) for _, mods in BOTH]


# -- genre -------------------------------------------------------------------

def _genre_table(g):
    rows = []
    for space in (g.SPACE_ARIB, g.SPACE_CS):
        for l1 in range(-1, 17):
            for l2 in range(-1, 17):
                item = g.GenreItem(space, l1, l2)
                rows.append((g.main_genre_name(item), g.sub_genre_name(item),
                             g.unknown_name(item)))
    return rows, plain(g.ARIB_GENRES)


def test_genre_names_equal_jax():
    jax, port = both(lambda m: _genre_table(m["genre"]))
    assert port == jax


@pytest.mark.parametrize("seed", range(4))
def test_content_descriptor_equal_jax(seed):
    payload = np.random.default_rng(seed).integers(
        0, 256, 2 * seed + 7, dtype=np.uint8).tobytes()
    jax, port = both(lambda m: [
        (i.space, i.level1, i.level2)
        for i in m["genre"].parse_content_descriptor(payload)])
    assert port == jax and len(port) == (2 * seed + 7) // 2


# -- rename ------------------------------------------------------------------

RENAME_FORMATS = ["$title$", "$service$_$title$", "$time$ $title$",
                  "$time:%Y-%m-%d$ $event$ [$service$]", "$file$-$title$",
                  "$unknown$ $title$", "", "__$title$__", "$title$.$time$"]
RENAME_EVENTS = [("アニメ: 新番組/第1話?", "ＮＨＫ総合", "2026-04-01T21:30:00"),
                 ("", "BS", ""),
                 ('a<b>c|d"e*f', "", "2026-12-31T23:59:00"),
                 ("Live http://example.org/x now", "CS", "")]


@pytest.mark.parametrize("fmt", RENAME_FORMATS)
def test_rename_equal_jax(fmt):
    def run(m):
        r = m["rename"]
        out = []
        for event, service, t in RENAME_EVENTS:
            item = m["server"].QueueEntry(
                item_id=1, src_path="/rec/20260401_show.ts", out_path="o",
                event_name=event, service_name=service, ts_time=t)
            out.append((r.rename_output(item, fmt),
                        r.format_output_name(fmt, event_name=event,
                                             service_name=service,
                                             time=t or None,
                                             src_name=item.src_path),
                        r.escape_filename(event, True),
                        r.escape_filename(event)))
        return out

    jax, port = both(run)
    assert port == jax


# -- filter settings ---------------------------------------------------------

def _filter_settings():
    """Every deinterlacer x fps pair, and seeded draws of the other
    fields."""
    out = [dict()]
    for alg in ("KFM", "D3DVP", "QTGMC", "Yadif", "AutoVfr"):
        for fps in ("VFR", "CFR24", "CFR30", "CFR60", "SVP", "VFR30"):
            out.append(dict(enable_deinterlace=True, deinterlace_algorithm=alg,
                            kfm_fps=fps, yadif_fps=fps))
    rng = np.random.default_rng(3)
    flags = ("enable_deblock", "kfm_enable_nr", "kfm_enable_ucf",
             "enable_resize", "enable_temporal_nr", "enable_deband",
             "enable_edge_level", "enable_deinterlace")
    for _ in range(24):
        d = {f: bool(rng.integers(0, 2)) for f in flags}
        d.update(deinterlace_algorithm=str(rng.choice(
            ["KFM", "Yadif", "AutoVfr", "QTGMC"])),
            kfm_fps=str(rng.choice(["VFR", "SVP", "CFR24"])),
            auto_vfr_parallel=int(rng.integers(0, 4)),
            resize_width=int(rng.choice([0, 1280])), resize_height=720,
            unknown_key=1)
        out.append(d)
    return out


@pytest.mark.parametrize("case", range(len(_filter_settings())))
def test_filter_setting_equal_jax(case):
    d = _filter_settings()[case]

    def run(m):
        fs = m["fs"].FilterSetting.from_dict(d)
        return (fs.to_dict(), m["fs"].filter_mode_of(fs),
                m["fs"].filter_setting_args(fs))

    jax, port = both(run)
    assert port == jax


# -- DRCS manager ------------------------------------------------------------

def _drcs_run(m, root):
    d = root / "drcs"
    d.mkdir(parents=True)
    md5s = ["0" * 31 + "a", "ab" * 16, "c" * 32]
    for k in md5s[:2]:
        (d / f"{k}.bmp").write_bytes(b"BM fake")
    (d / "short.bmp").write_bytes(b"BM")
    (d / "drcs_map.txt").write_text(f"{md5s[1].upper()}=〓\n\nbad line\n",
                                    encoding="utf-8")
    log = root / "enc.log"
    log.write_text(f"unmapped DRCS {md5s[2]} ... DRCS {md5s[0].upper()}\n")
    ctx = m["ctx"]()
    mgr = m["drcs"].DRCSManager(ctx, str(d))
    seen = []
    mgr.add_listener(lambda imgs: seen.append([i.md5 for i in imgs]))
    first = [(i.md5, i.map_str, os.path.basename(i.bmp_path))
             for i in mgr.update()]
    mgr.add_log_file(str(log), "src.ts", 12.5)
    mgr.add_log_file(str(root / "missing.log"), "x.ts", 0)
    mgr.add_mapping(md5s[0].upper(), "〒")
    after = [(i.md5, i.map_str, os.path.basename(i.bmp_path), i.sources)
             for i in mgr.update()]
    unmapped = [i.md5 for i in mgr.unmapped()]
    return (first, after, unmapped, seen, mgr.load_map(),
            dict(ctx.drcs_map), (d / "drcs_map.txt").read_bytes())


def test_drcs_manager_equal_jax(tmp_path):
    jax, port = (_drcs_run(mods, tmp_path / side) for side, mods in BOTH)
    assert port == jax


# -- hash lists and file cuts ------------------------------------------------

def _files(root):
    root.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for k, n in enumerate((0, 5, 4096, 3 * 1024 * 1024 + 7)):
        (root / f"f{k}.bin").write_bytes(rng.integers(
            0, 256, n, dtype=np.uint8).tobytes())
    return root


def _hash_run(m, root):
    h = m["hash"]
    d = _files(root / "files")
    listed = h.make_hash_list(str(d))
    ok = h.check_hash_list(listed)
    (d / "f1.bin").write_bytes(b"HELLO")
    os.remove(d / "f2.bin")
    bad = h.check_hash_list(listed)
    digest = h.copy_with_hash(str(d / "f3.bin"), str(root / "copy.bin"))
    h.append_hash(str(root / "out.hash"), "copy.bin", digest)
    with open(root / "out.hash", "a") as f:
        f.write("short\n")  # a trailing short line is a clean end
    return (open(listed, "rb").read(), ok, bad, digest,
            h.file_hash(str(root / "copy.bin")),
            h.read_hash_file(str(root / "out.hash")),
            (root / "copy.bin").read_bytes() == (d / "f3.bin").read_bytes())


def test_hash_check_equal_jax(tmp_path):
    jax, port = (_hash_run(mods, tmp_path / side) for side, mods in BOTH)
    assert port == jax
    assert port[1] == (True, []) and port[-1]


def test_corrupt_hash_file_raises_in_both(tmp_path):
    p = tmp_path / "bad.hash"
    p.write_text("tooshort\n" + "0" * 128 + "  a.bin\n")
    for _, mods in BOTH:
        with pytest.raises(IOError):
            mods["hash"].read_hash_file(str(p))


@pytest.mark.parametrize("start,end", [(0, None), (188, 188 * 5), (7, 7),
                                       (4 * 1024 * 1024 - 3, None),
                                       (10, 10 ** 9), (10 ** 8, None)])
def test_file_cutter_equal_jax(tmp_path, start, end):
    src = tmp_path / "src.bin"
    src.write_bytes(np.random.default_rng(5).integers(
        0, 256, 4 * 1024 * 1024 + 100, dtype=np.uint8).tobytes())

    def run(m):
        dst = tmp_path / f"cut_{m['cut'].__name__.split('.')[0]}.bin"
        n = m["cut"].cut_file(str(src), str(dst), start, end)
        return n, dst.read_bytes()

    jax, port = both(run)
    assert port == jax
    for _, mods in BOTH:
        with pytest.raises(ValueError):
            mods["cut"].cut_file(str(src), str(tmp_path / "x"), -1)


# -- user scripts ------------------------------------------------------------

@pytest.mark.parametrize("with_result", [False, True])
def test_user_script_environment_equal_jax(with_result):
    def run(m):
        entry = m["server"].QueueEntry(
            item_id=7, src_path="/rec/a.ts", out_path="/out/a",
            service_id=1024, priority=4, tags=["x", "y"],
            profile_name="anime")
        res = (dict(ok=False, error="boom", out_files=["/out/a.mp4"])
               if with_result else None)
        env = m["user"].item_environment(entry, "post", "127.0.0.1", 4321,
                                         res)
        return {k: v for k, v in env.items() if k not in os.environ}

    jax, port = both(run)
    assert port == jax and port["ITEM_ID"] == "7"


def test_user_script_runs_with_item_env(tmp_path):
    """run_user_script: the script's lines land in the log, its exit code
    comes back, and a missing script is skipped the same way."""
    script = tmp_path / "s.sh"
    script.write_text("#!/bin/bash\necho \"$ITEM_ID $ITEM_MODE $TAG\"\n"
                      "exit 3\n")
    script.chmod(0o755)

    def run(m):
        lines = []

        class Out:
            def write(self, s):
                lines.append(s)

            def flush(self):
                pass

        ctx = m["ctx"](level="info", out=Out())
        entry = m["server"].QueueEntry(item_id=2, src_path="a.ts",
                                       out_path="a", tags=["t"])
        rcs = [asyncio.run(m["user"].run_user_script(
            ctx, p, entry, "pre", server_port=1))
            for p in (str(script), str(tmp_path / "missing.sh"), "")]
        return rcs, "".join(lines).replace(str(tmp_path), "<tmp>")

    jax, port = both(run)
    assert port == jax and port[0] == [3, 0, 0]
    assert "2 pre t" in port[1]


# -- the RPC wire ------------------------------------------------------------

MESSAGES = [
    {"method": "AddQueue", "id": 1, "payload": {"src": "/rec/a.ts",
                                                "priority": 3}},
    {"method": "GetQueueResult", "id": 2, "payload": [
        {"item_id": 1, "event_name": "ニュース", "genres": [[0, 1]],
         "added": 1.5e9, "ok": True, "none": None}]},
    {"method": "OnQueueUpdate", "payload": {"console": ["x" * 1000]}},
    {"method": "Empty", "id": None, "payload": None},
]


@pytest.mark.parametrize("k", range(len(MESSAGES)))
def test_rpc_frames_byte_equal(k):
    msg = MESSAGES[k]
    jframe, tframe = (mods["rpc"].encode_frame(msg) for _, mods in BOTH)
    assert tframe == jframe

    async def read_back(rpc, data):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await rpc.read_frame(reader), await rpc.read_frame(reader)

    for _, mods in BOTH:
        assert asyncio.run(read_back(mods["rpc"], tframe)) == (msg, None)


def test_rpc_oversized_frame_raises():
    async def read(rpc):
        reader = asyncio.StreamReader()
        reader.feed_data(rpc._HEADER.pack(rpc.MAX_FRAME + 1))
        return await rpc.read_frame(reader)

    for _, mods in BOTH:
        with pytest.raises(ValueError):
            asyncio.run(read(mods["rpc"]))
    assert trpc.CLIENT_METHODS == jrpc.CLIENT_METHODS
    assert trpc.SERVER_NOTIFICATIONS == jrpc.SERVER_NOTIFICATIONS


def test_wol_packets_equal_jax():
    for mac in ("00:11:22:33:44:55", "aa-bb-cc-dd-ee-ff"):
        jax, port = both(lambda m: m["add"].wol_magic_packet(mac))
        assert port == jax and len(port) == 102
    for _, mods in BOTH:
        with pytest.raises(ValueError):
            mods["add"].wol_magic_packet("00:11")


@pytest.mark.parametrize("tool,server", [("port", "jax"), ("jax", "port")])
def test_add_task_talks_to_the_other_server(tmp_path, tool, server, capsys):
    """Each package's AddTask (its main, over TCP, with a NAS copy and its
    hash list) queues a recording on the other package's server: the
    queued entries, the copies and the hash lists are the same."""
    mods = dict(BOTH)

    async def fake_run(srv, wid, entry, phase):
        return True

    async def main():
        s = dict(BOTH)[server]
        srv = s["server"].EncodeServer(
            s["ctx"](level="error"), data_dir=str(tmp_path / "data"),
            run_item=fake_run,
            **({"device": "cpu"} if server == "port" else {}))
        srv.setting.num_parallel = 0  # keep the entries queued
        port = await srv.start(port=0)
        src = tmp_path / "rec.ts"
        src.write_bytes(b"\x47" + bytes(187))
        loop = asyncio.get_running_loop()
        rc = await loop.run_in_executor(None, mods[tool]["add"].main, [
            str(src), "--port", str(port), "-s", "anime", "--priority", "4",
            "--service-id", "1024", "--nas-dir", str(tmp_path / "nas")])
        entries = [dataclasses.asdict(e) for e in srv.entries.values()]
        await srv.stop()
        return rc, entries

    rc, entries = asyncio.run(main())
    out = capsys.readouterr().out
    assert rc == 0 and '"item_id": 1' in out
    (e,) = entries
    assert (e["src_path"], e["profile_name"], e["priority"],
            e["service_id"], e["out_path"]) == (
        str(tmp_path / "nas" / "rec.ts"), "anime", 4, 1024,
        str(tmp_path / "nas" / "rec.out"))
    # the NAS dir's hash.txt names the copy, and the server verified it
    # into the entry (its hash-dir lookup)
    listed = jhash.read_hash_file(str(tmp_path / "nas" / "hash.txt"))
    assert listed == {"rec.ts": jhash.file_hash(str(tmp_path / "rec.ts"))}
    assert e["hash"] == listed["rec.ts"].hex()


def test_script_command_needs_a_user_script(monkeypatch, capsys):
    """Outside a user script (no AMT_SERVER_PORT/ITEM_ID) both tools refuse
    with exit code 2 before connecting."""
    import amatsukaze_tpu.tools.script_command as jcmd
    import amatsukaze_tpu_torch.tools.script_command as tcmd

    monkeypatch.delenv("AMT_SERVER_PORT", raising=False)
    monkeypatch.delenv("ITEM_ID", raising=False)
    assert jcmd.main(["AddTag", "x"]) == tcmd.main(["AddTag", "x"]) == 2
    assert jcmd.main([]) == tcmd.main([]) == 2
