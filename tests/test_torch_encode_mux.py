"""The port's encode/mux side against the JAX package: the modules it
copied (io/y4m.py, io/wave.py, io/process.py, io/muxer.py,
pipeline/encoder_options.py, captions/formatters.py, captions/nicojk.py,
captions/nicojk18.py, tools/x264_shim.py, tools/aac_shim.py,
pipeline/simple.py), the CLI's argument handling, and the device rules of
the entry points.

Every comparison is exact: the same bytes, the same text, the same
command lines (paths relative to each run's directory), the same fields.
The HTTP client of nicojk18 runs against an injected request function,
never the network. Where this host has the FFmpeg bridge, the in-build
x264 shim encodes for real: in process and as a subprocess the port's
output is byte-equal, and equal to the JAX package's.
"""

import io
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
import ts_gen
from torch_compare import plain
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.cli as jcli
from amatsukaze_tpu.captions import formatters as jform
from amatsukaze_tpu.captions import nicojk as jnicojk
from amatsukaze_tpu.captions import nicojk18 as jnicojk18
from amatsukaze_tpu.captions.b24 import CaptionFormat as JCaptionFormat
from amatsukaze_tpu.captions.b24 import CaptionLine as JCaptionLine
from amatsukaze_tpu.io import muxer as jmuxer
from amatsukaze_tpu.io import process as jprocess
from amatsukaze_tpu.io import wave as jwave
from amatsukaze_tpu.io import y4m as jy4m
from amatsukaze_tpu.pipeline import decoders as jdec
from amatsukaze_tpu.pipeline import encoder_options as jeo
from amatsukaze_tpu.pipeline import settings as jsettings
from amatsukaze_tpu.pipeline import simple as jsimple
from amatsukaze_tpu.pipeline import transcode as jtrans
from amatsukaze_tpu.reform import stream_reform as jreform
from amatsukaze_tpu.tools import aac_shim as jaac_shim
from amatsukaze_tpu.tools import x264_shim as jx264_shim
from amatsukaze_tpu import types as jtypes
from amatsukaze_tpu.utils.context import AMTContext as JContext

import amatsukaze_tpu_torch.cli as tcli
from amatsukaze_tpu_torch.captions import formatters as tform
from amatsukaze_tpu_torch.captions import nicojk as tnicojk
from amatsukaze_tpu_torch.captions import nicojk18 as tnicojk18
from amatsukaze_tpu_torch.captions.b24 import CaptionFormat, CaptionLine
from amatsukaze_tpu_torch.io import muxer as tmuxer
from amatsukaze_tpu_torch.io import process as tprocess
from amatsukaze_tpu_torch.io import wave as twave
from amatsukaze_tpu_torch.io import y4m as ty4m
from amatsukaze_tpu_torch.pipeline import decoders as tdec
from amatsukaze_tpu_torch.pipeline import encoder_options as teo
from amatsukaze_tpu_torch.pipeline import settings as tsettings
from amatsukaze_tpu_torch.pipeline import simple as tsimple
from amatsukaze_tpu_torch.pipeline import transcode as ttrans
from amatsukaze_tpu_torch.reform import stream_reform as treform
from amatsukaze_tpu_torch.tools import aac_shim as taac_shim
from amatsukaze_tpu_torch.tools import x264_shim as tx264_shim
from amatsukaze_tpu_torch import types as ttypes
from amatsukaze_tpu_torch.utils.context import AMTContext

# both packages' modules, by side
SIDES = {
    "port": dict(y4m=ty4m, wave=twave, process=tprocess, muxer=tmuxer,
                 eo=teo, settings=tsettings, form=tform, nicojk=tnicojk,
                 nicojk18=tnicojk18, reform=treform, types=ttypes,
                 simple=tsimple, dec=tdec, trans=ttrans, cli=tcli,
                 ctx=AMTContext, CaptionFormat=CaptionFormat,
                 CaptionLine=CaptionLine),
    "jax": dict(y4m=jy4m, wave=jwave, process=jprocess, muxer=jmuxer,
                eo=jeo, settings=jsettings, form=jform, nicojk=jnicojk,
                nicojk18=jnicojk18, reform=jreform, types=jtypes,
                simple=jsimple, dec=jdec, trans=jtrans, cli=jcli,
                ctx=JContext, CaptionFormat=JCaptionFormat,
                CaptionLine=JCaptionLine),
}


def _both(fn):
    """fn(side modules) for the port and the JAX package."""
    return fn(SIDES["port"]), fn(SIDES["jax"])


def _relative(text: str, root) -> str:
    """Paths of a run relative to its directory, the temp directory's
    random name (TempDirectory) replaced."""
    return re.sub(r"amt[a-z0-9]{8}", "amt<tmp>",
                  text.replace(str(root), "<run>"))


# ---------------------------------------------------------------------------
# y4m and wave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("colorspace,interlaced,tff", [
    ("420mpeg2", True, True), ("420mpeg2", False, True),
    ("420mpeg2", True, False), ("420p10", False, True)])
def test_y4m_writer_bytes_and_reader_round_trip(colorspace, interlaced, tff):
    rng = np.random.default_rng(3)
    dt, hi = (np.uint16, 1024) if colorspace.endswith("p10") else (np.uint8,
                                                                  256)
    frames = [tuple(rng.integers(0, hi, s, dtype=dt)
                    for s in ((16, 32), (8, 16), (8, 16))) for _ in range(3)]

    def write(m):
        buf = io.BytesIO()
        w = m["y4m"].Y4MWriter(buf, m["y4m"].Y4MFormat(
            width=32, height=16, fps_num=60000, fps_den=1001,
            interlaced=interlaced, tff=tff, sar_num=4, sar_den=3,
            colorspace=colorspace))
        for f in frames:
            w.write_frame(*f)
        return buf.getvalue()

    got, want = _both(write)
    assert got == want
    for m in (SIDES["port"], SIDES["jax"]):
        r = m["y4m"].Y4MReader(io.BytesIO(got))
        assert (r.fmt.colorspace, r.fmt.interlaced, r.fmt.tff) == (
            colorspace, interlaced, tff if interlaced else True)
        back = list(r.frames())
        assert len(back) == len(frames)
        for a, b in zip(back, frames):
            for p, q in zip(a, b):
                assert p.dtype == dt
                np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("channels,rate,bits,size", [
    (2, 48000, 16, 1000), (1, 44100, 16, 0), (6, 48000, 24, 12)])
def test_wave_header_and_writer_equal_jax(channels, rate, bits, size):
    def run(m):
        head = m["wave"].wave_header(channels, rate, bits, size)
        buf = io.BytesIO()
        w = m["wave"].WaveWriter(buf, channels, rate, data_size=size)
        w.write(b"\x01" * size)
        return head, buf.getvalue(), m["wave"].parse_wave_header(head)

    got, want = _both(run)
    assert got == want
    assert got[2][:3] == (channels, rate, bits)


# ---------------------------------------------------------------------------
# the data pump and the decode prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 4, 64])
def test_data_pump_order_and_wait_counters(depth):
    def run(m):
        seen = []
        pump = m["process"].DataPumpThread(seen.append, max_items=depth)
        for i in range(200):
            pump.put(i)
        pump.join()
        return seen, pump

    (got, pump), (want, jpump) = _both(run)
    assert got == want == list(range(200))
    for p in (pump, jpump):
        assert p.consumer_wait >= 0 and p.producer_wait >= 0
        assert p.error is None


@pytest.mark.parametrize("side", list(SIDES))
def test_data_pump_surfaces_the_consumers_error(side):
    def bad(item):
        raise ValueError("boom")

    pump = SIDES[side]["process"].DataPumpThread(bad, max_items=2)
    with pytest.raises(RuntimeError, match="consumer failed"):
        for i in range(50):
            pump.put(i)
        pump.join()


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_iter_order_and_errors_equal_jax(depth):
    def source():
        yield from range(10)
        raise KeyError("decoder")

    def run(m):
        out = []
        with pytest.raises(KeyError):
            for x in m["process"].prefetch_iter(source(), depth=depth):
                out.append(x)
        return out

    got, want = _both(run)
    assert got == want == list(range(10))


def test_subprocess_keeps_the_last_lines():
    code = "import sys; [print(i) for i in range(30)]; sys.exit(3)"

    def run(m):
        p = m["process"].SubProcess([sys.executable, "-c", code])
        return p.join(), list(p.last_lines)

    got, want = _both(run)
    assert got == want == (3, [str(i) for i in range(20, 30)])


# ---------------------------------------------------------------------------
# encoder options, shims, encoder command resolution
# ---------------------------------------------------------------------------

OPTIONS = [
    ("X264", "--preset slow --crf 20"),
    ("X265", "--preset medium"),
    ("QSVENC", "--vpp-deinterlace bob"),
    ("QSVENC", "--vpp-deinterlace normal -c hevc"),
    ("NVENC", "--vpp-afs 24fps=true,drop=true,timecode=true"),
    ("NVENC", "--vpp-afs 24fps=true,drop=false"),
    ("NVENC", "--vpp-select-every 2 -c hevc"),
    ("VCEENC", '--vpp-afs "preset=24fps" -c av1'),
    ("SVTAV1", "--preset 8"),
]


@pytest.mark.parametrize("encoder,options", OPTIONS)
def test_parse_encoder_option_equals_jax(encoder, options):
    def run(m):
        try:
            return plain(m["eo"].parse_encoder_option(
                m["settings"].Encoder[encoder], options))
        except ValueError as e:
            return ("ValueError", str(e))

    got, want = _both(run)
    assert got == want
    assert teo.split_options(options) == jeo.split_options(options)


SHIM_ARGS = [
    ["--crf", "20", "--preset", "fast", "-o", "out.264"],
    ["--bitrate", "4000", "--tff", "-o", "o.264", "--shim-codec", "libx265"],
    ["--bff", "--fps", "30000/1001", "--unknown", "x", "-o", "a"],
    ["--qp", "18", "--output", "b.mp4"],
]


@pytest.mark.parametrize("argv", SHIM_ARGS)
def test_x264_shim_arguments_equal_jax(argv):
    assert tx264_shim.parse_args(list(argv)) == jx264_shim.parse_args(
        list(argv))


@pytest.mark.parametrize("argv", [
    ["-", "-o", "out.aac"], ["--abr", "192", "-", "out.m4a"],
    ["-ignorelength", "-if", "-", "-of", "x.m4a", "-br", "128000"]])
def test_aac_shim_arguments_equal_jax(argv):
    assert taac_shim.parse_args(list(argv)) == jaac_shim.parse_args(
        list(argv))


def test_resolve_encoder_command_uses_the_ports_shims(monkeypatch):
    """A missing x264 binary resolves to this package's shim (with the
    FFmpeg bridge present), which the in-process sink recognises; the JAX
    package's shim module is not this package's."""
    from amatsukaze_tpu_torch.video import avdec

    monkeypatch.setattr(avdec, "avdec_available", lambda: True)
    cmd = tsettings.resolve_encoder_command(
        '"/nonexistent/x264" --crf 20 -o "out dir/v.264"',
        tsettings.Encoder.X264)
    assert " -m amatsukaze_tpu_torch.tools.x264_shim --shim-codec libx264 " \
        in cmd
    assert ttrans._inprocess_encoder_argv(cmd) == [
        "--shim-codec", "libx264", "--crf", "20", "-o", "out dir/v.264"]
    jcmd = cmd.replace("amatsukaze_tpu_torch.", "amatsukaze_tpu.")
    assert ttrans._inprocess_encoder_argv(jcmd) is None
    assert jtrans._inprocess_encoder_argv(cmd) is None
    x265 = tsettings.resolve_encoder_command("/nonexistent/x265 -o v",
                                             tsettings.Encoder.X265)
    assert "--shim-codec libx265" in x265
    nvenc = "/nonexistent/nvencc -o v"
    assert tsettings.resolve_encoder_command(
        nvenc, tsettings.Encoder.NVENC) == nvenc
    audio = tsettings.resolve_audio_encoder_command(
        "/nonexistent/qaac --tvbr 90 - -o a.m4a")
    assert " -m amatsukaze_tpu_torch.tools.aac_shim " in audio
    monkeypatch.setattr(avdec, "avdec_available", lambda: False)
    plain_cmd = '"/nonexistent/x264" --crf 20'
    assert tsettings.resolve_encoder_command(
        plain_cmd, tsettings.Encoder.X264) == plain_cmd


@pytest.mark.parametrize("encoder", ["X264", "X265", "QSVENC", "NVENC"])
def test_bitrate_zones_equal_jax(encoder):
    """make_bitrate_zones over a VFR plan with two CM zones."""
    tc = [0.0]
    for i in range(2400):
        tc.append(tc[-1] + (1001 / 24 if (i // 500) % 2 else 1001 / 30))

    def run(m):
        conf = m["settings"].Config()
        conf.encoder = m["settings"].Encoder[encoder]
        st = m["settings"].Settings(m["ctx"](level="error"), conf)
        from importlib import import_module

        zone = import_module(m["trans"].__name__.replace(
            "pipeline.transcode", "models.cm_analyze")).EncoderZone
        zones = [zone(100, 700), zone(1500, 1900)]
        return plain(m["trans"].make_bitrate_zones(tc, zones, st, 30000,
                                                   1001))

    got, want = _both(run)
    assert got == want and got


# ---------------------------------------------------------------------------
# captions: formatters, NicoJK, NicoJK18
# ---------------------------------------------------------------------------

def _caption_lines(m):
    fm = m["CaptionFormat"]
    rows = [
        ("こんにちは", [fm(pos=0)], 0.0, 90000.0, 0.0),
        ("second line", [fm(pos=0, char_w=18, char_h=30, width=20,
                            height=36, text_color=(255, 255, 0, 255),
                            style=3)], 90000.0, 180000.0, 12.0),
        ("small and large", [fm(pos=0, size_mode=0),
                             fm(pos=6, size_mode=2,
                                back_color=(0, 0, 255, 64))], 180000.0,
         270000.0, 30.0),
        ("\nleading newline", [fm(pos=0)], 300000.0, 390000.0, 0.0),
    ]
    return [m["reform"].OutCaptionLine(
        start=s, end=e, line=m["CaptionLine"](text=t, plane_w=960,
                                              plane_h=540, pos_y=y,
                                              formats=f))
        for t, f, s, e, y in rows]


@pytest.mark.parametrize("kind", ["CaptionASSFormatter",
                                  "CaptionSRTFormatter"])
def test_caption_formatters_equal_jax(kind):
    got, want = _both(lambda m: getattr(m["form"], kind)(
        m["ctx"](level="error")).generate(_caption_lines(m)))
    assert got == want
    assert "second line" in got


SAMPLE_ASS = """[Script Info]
ScriptType: v4.00+
PlayResX: 1280
PlayResY: 720

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding
Style: white,MS PGothic,28,&H00ffffff,&H00ffffff,&H00000000,&H00000000,-1,0,0,0,200,200,0,0.00,1,0,4,7,20,20,40,1

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:01.50,0:00:05.50,white,,0000,0000,0000,,hello comment
Dialogue: 0,0:01:00.00,0:01:04.00,white,,0000,0000,0000,,second
"""
CH_SID = "jk1\tnhk\t1024\t1\tNHK\njk2\tetv\t0x408\t2\tETV\nbad line\n"


@pytest.mark.parametrize("mask", [0b0001, 0b0011, 0b1111])
def test_nicojk_with_injected_fetchers_equals_jax(mask):
    def run(m):
        nj = m["nicojk"]
        ctx = m["ctx"](level="error")
        calls = []

        def fetcher(sid, start, dur):
            calls.append((sid, start, dur))
            return SAMPLE_ASS

        jk = nj.NicoJK(ctx, nj.parse_ch_sid(CH_SID), fetchers=[fetcher],
                       mask=mask)
        ok = jk.make_ass(1024, 1500000000, 1800)
        out = [nj.NicoJKFormatter().generate(jk.headers.get(t, []), d)
               for t, d in enumerate(jk.get_dialogues())]
        failed = nj.NicoJK(ctx, {}, fetchers=[lambda *a: 1 / 0])
        return (ok, calls, plain(jk.get_dialogues()), out,
                nj.make_transparent_variant(SAMPLE_ASS),
                plain(nj.parse_ass(SAMPLE_ASS)),
                failed.make_ass(1024, 0, 100), failed.failed)

    got, want = _both(run)
    assert got == want
    assert got[0] and got[1] == [(1024, 1500000000, 1800)]


def _chat_xml(date, no, text):
    return (f'<chat thread="1234" no="{no}" vpos="{(date % 300) * 100}"'
            f' date="{date}" user_id="u1">{text}</chat>')


def _http_get(comments_by_slot, urls):
    """An injected request function serving the comment server's wire
    format (length-prefixed zlib blobs, one per slot)."""
    from urllib.parse import parse_qs, urlparse

    def get(url):
        urls.append(url)
        q = parse_qs(urlparse(url).query)
        if q["jknum"][0] == "jk2":
            return 406, b""
        slot, num = int(q["slot"][0]), int(q["num"][0])
        body = b""
        for k in range(num):
            blob = zlib.compress("\n".join(
                comments_by_slot.get(slot + k, [])).encode("utf-8"))
            body += struct.pack("<i", len(blob)) + blob
        return 200, body

    return get


def test_nicojk18_fetcher_with_an_injected_client_equals_jax(tmp_path):
    base = 1500000000
    by_slot = {}
    for k, d in enumerate(range(base, base + 2400, 37)):
        by_slot.setdefault(d // 300, []).append(
            _chat_xml(d, k + 1, f"c{d} &amp;&lt;&gt;"))
    ch_sid = tmp_path / "ch_sid.txt"
    ch_sid.write_text(CH_SID)

    def run(m):
        urls = []
        f = m["nicojk18"].make_fetcher(str(ch_sid), base_url="http://x",
                                       http_get=_http_get(by_slot, urls),
                                       sleep=lambda s: None)
        return (f(1024, base + 100, 1500), f(0x408, base, 100),
                f(999, base, 100), urls)

    got, want = _both(run)
    assert got == want
    ass, no_thread, unknown, urls = got
    assert ass.count("Dialogue:") > 30
    assert no_thread is None and unknown is None
    assert len(urls) == 2  # jk1 in one request of 6 slots, jk2's 406


# ---------------------------------------------------------------------------
# the muxers
# ---------------------------------------------------------------------------

def _mux_env(m, root, fmt_name, audio_tracks=1, captions=False):
    """Settings, a reform stand-in and a demuxed audio blob, as the JAX
    package's muxer tests build them."""
    S, T, R = m["settings"], m["types"], m["reform"]
    conf = S.Config(work_dir=str(root), out_video_path=str(root / "out"),
                    format=S.OutputFormat(fmt_name))
    st = S.Settings(m["ctx"](level="error"), conf,
                    S.TempDirectory(str(root), keep=True))
    key = T.EncodeFileKey()
    file = R.EncodeFileOutput(key=key, out_key=key, key_max=key)
    fmt = R.OutVideoFormat(video_format=T.VideoFormat(
        format=T.VideoStreamFormat.H264, width=1440, height=1080,
        frame_rate_num=30000, frame_rate_denom=1001, fixed_frame_rate=True,
        progressive=False))
    blob, offsets, lists = b"", [0], []
    for t in range(audio_tracks):
        frames = []
        for i in range(3):
            frames.append(len(offsets) - 1)
            blob += bytes([t * 16 + i]) * 8
            offsets.append(len(blob))
        lists.append(frames)
        fmt.audio_format.append(T.AudioFormat(T.AudioChannels.STEREO, 48000))
    with open(st.audio_file_path(), "wb") as f:
        f.write(blob)
    file.audio_frames = lists
    if captions:
        file.caption_list = [[object()]]
        for path in (st.tmp_ass_path(key, 0), st.tmp_srt_path(key, 0)):
            with open(path, "w") as f:
                f.write("caption")

    class Reform:
        def get_encode_file(self, k):
            return file

        def get_format(self, k):
            return fmt

        def get_audio_file_offsets(self):
            return offsets

    return st, key, fmt, Reform()


@pytest.mark.parametrize("fmt_name,tracks,captions,timecode", [
    ("mp4", 1, False, False), ("mp4", 2, True, True),
    ("mkv", 1, True, False), ("m2ts", 2, False, False),
    ("ts", 1, False, True)])
def test_muxer_command_lines_equal_jax(tmp_path, fmt_name, tracks, captions,
                                       timecode):
    def run(m):
        root = tmp_path / m["trans"].__name__.split(".")[0]
        root.mkdir()
        st, key, fmt, reform = _mux_env(m, root, fmt_name, tracks, captions)
        cmds = []

        def runner(cmd, show):
            cmds.append(_relative(cmd, root))
            with open(st.out_file_path(key, key), "wb") as f:
                f.write(b"x" * 77)
            return 0

        mux = m["muxer"].Muxer(st.ctx, st, reform, runner=runner)
        if timecode:
            fmt.video_format.fixed_frame_rate = False
        res = mux.mux(key, m["eo"].EncoderOptionInfo(), False,
                      fmt.video_format, vfr_timing_fps=120,
                      timecode_path=str(root / "tc.txt") if timecode else "")
        files = sorted(_relative(os.path.join(d, f), root)
                       for d, _, fs in os.walk(root) for f in fs)
        return (cmds, [_relative(p, root) for p in res.out_subs],
                res.file_size, files)

    got, want = _both(run)
    assert got == want
    assert got[0] and got[2] == 77


def test_muxer_through_a_fake_muxer_binary_equals_jax(tmp_path):
    """The default runner: the muxer binary is started as a subprocess,
    which records its arguments and writes the output file."""
    fake = tmp_path / "fake_muxer"
    fake.write_text("#!/bin/bash\nprintf '%s\\n' \"$@\" > \"$0.args\"\n"
                    "out=''; prev=''\nfor a in \"$@\"; do "
                    "[ \"$prev\" = \"-o\" ] && out=\"$a\"; prev=\"$a\"; done\n"
                    "echo MUXED > \"$out\"\n")
    fake.chmod(0o755)

    def run(m):
        root = tmp_path / m["trans"].__name__.split(".")[0]
        root.mkdir()
        st, key, fmt, reform = _mux_env(m, root, "mkv", 2, True)
        st.conf.muxer_path = str(fake)
        res = m["muxer"].Muxer(st.ctx, st, reform).mux(
            key, m["eo"].EncoderOptionInfo(), False, fmt.video_format)
        args = _relative((tmp_path / "fake_muxer.args").read_text(), root)
        simple = m["muxer"].SimpleMuxer(st.ctx, st)
        simple.mux(fmt.video_format, 2)
        args2 = _relative((tmp_path / "fake_muxer.args").read_text(), root)
        return args, res.file_size, args2, simple.total_out_size

    got, want = _both(run)
    assert got == want
    assert "-o" in got[0] and got[1] == len(b"MUXED\n")


def test_audio_cache_and_video_format_adjustment_equal_jax(tmp_path):
    path = tmp_path / "a.aac"
    path.write_bytes(b"aaabbcccc")

    def run(m):
        cache = m["muxer"].AudioCache(str(path), [0, 3, 5, 9])
        T, E = m["types"], m["eo"]
        out = [cache[i] for i in range(3)]
        for deint in E.EncoderDeint:
            for prog in (False, True):
                for every in (1, 2):
                    v = T.VideoFormat(frame_rate_num=30000,
                                      frame_rate_denom=1001,
                                      progressive=prog)
                    out.append(plain(m["muxer"].adjust_video_format(
                        v, E.EncoderOptionInfo(deint=deint,
                                               select_every=every))))
        return out

    got, want = _both(run)
    assert got == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGVS = [
    ["-i", "in.ts"],
    ["-i", "in.ts", "-o", "out", "-w", "/w", "-et", "x265", "-e", "x265",
     "-eo", "--crf 22", "-b", "1:2:0.5", "-bcm", "0.4", "--2pass",
     "--splitsub", "-fmt", "mkv", "-m", "mkvmerge", "--chapter",
     "--subtitles", "--logo", "a.lgd", "--logo", "b.lgd",
     "--erase-logo", "c.lgd", "--no-delogo", "-om", "6", "-s", "0x5c38"],
    ["-i", "in.ts", "-aet", "qaac", "-ae", "qaac64", "-aeo", "--tvbr 90",
     "-abk", "192", "--nicojk", "--nicojkmask", "3", "--nicojk18",
     "--pmt-cut", "0.1:0.2", "--mode", "cm", "--trimavs", "t.avs",
     "--jls-cmd", "JL.txt", "--jls-option=-flags fullframe"],
    ["-i", "in.ts", "--filter-mode", "kfm_vfr", "--post-filter",
     "deblock,nr", "--resize", "1280x720", "--devices", "4",
     "--device-batch", "16", "--frame-cache-mb", "0", "--kfm-no-ucf",
     "--autovfr-parallel", "3", "--encoder-process", "0", "--eb", "8",
     "--mpeg2decoder", "CUVID", "--h264decoder", "QSV", "-s", "1024",
     "--chapter-exe", "chapter_exe", "--jls", "join_logo_scp",
     "--nicoass", "NicoConvASS", "--max-frames", "100", "--dump",
     "--dump-filter", "--print-prefix", "--ignore-no-logo"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_cli_args_to_config_equals_jax(argv):
    got, want = _both(lambda m: m["cli"].args_to_config(
        m["cli"].build_parser().parse_args(list(argv))))
    # field by field, enums by name and value
    assert plain(got) == plain(want)


@pytest.mark.parametrize("argv", [["-i", "x", "--devices", "0"],
                                  ["-i", "x", "--resize", "1281x720"],
                                  ["-i", "x", "--resize", "big"],
                                  ["-i", "x", "-et", "bogus"]])
def test_cli_rejects_what_jax_rejects(argv):
    for m in (SIDES["port"], SIDES["jax"]):
        with pytest.raises(SystemExit):
            m["cli"].args_to_config(m["cli"].build_parser().parse_args(argv))


def test_cli_main_without_input_prints_help_and_returns_1(capsys):
    assert tcli.main([]) == 1 == jcli.main([])
    out = capsys.readouterr().out
    assert "--filter-mode" in out and "--devices" in out
    assert tcli.EXIT_NO_LOGO == 100 and tcli.EXIT_NO_DRCS == 101


# ---------------------------------------------------------------------------
# the device rules of the entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _conf(tmp_path):
    src = tmp_path / "src.ts"
    src.write_bytes(ts_gen.build_simple_ts(num_frames=20, width=96,
                                           height=64))
    conf = tsettings.Config()
    conf.src_file_path = str(src)
    conf.work_dir = str(tmp_path)
    conf.out_video_path = str(tmp_path / "out")
    return conf


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    """The JAX entry points fall back to the CPU backend; the port's raise
    RuntimeError, before any work, unless the caller passes device="cpu"."""
    ctx = AMTContext(level="error")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrans.ensure_cuda_backend(ctx)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrans.ensure_cuda_backend(ctx, "cuda")
    assert ttrans.ensure_cuda_backend(ctx, "cpu") == torch.device("cpu")
    conf = _conf(tmp_path)
    st = tsettings.Settings(ctx, conf)
    pipe = ttrans.TranscodePipeline(ctx, st,
                                    decoder_factory=tdec.NullDecoderFactory())
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.run()
    assert os.listdir(st.tmp.path) == []  # nothing split, nothing written
    argv = ["-i", conf.src_file_path, "-w", str(tmp_path), "-o",
            str(tmp_path / "cli")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv + ["--mode", "g"])
    assert not os.path.exists(str(tmp_path / "cli.mp4"))


def test_cli_main_runs_on_the_cpu_when_asked(no_card, tmp_path):
    """device="cpu": the whole --mode ts run on the plain versions, with
    the CLI's exit code 0 and its report."""
    conf = _conf(tmp_path)
    fake = tmp_path / "fake_x264"
    fake.write_text("#!/bin/bash\nout=''\nwhile [ $# -gt 0 ]; do case "
                    "\"$1\" in -o) out=\"$2\"; shift 2;; *) shift;; esac; "
                    "done\ncat > \"$out\"\n")
    fake.chmod(0o755)
    report = tmp_path / "r.json"
    argv = ["-i", conf.src_file_path, "-w", str(tmp_path), "-o",
            str(tmp_path / "out"), "-e", str(fake), "-j", str(report),
            "--mpeg2decoder", "native"]
    # the in-build decoder cannot decode ts_gen's placeholder slices: the
    # frames come from the packages' NullDecoderFactory
    from unittest import mock

    with mock.patch.object(tdec, "default_decoder_factory",
                           lambda: tdec.NullDecoderFactory()):
        assert tcli.main(argv, device="cpu") == 0
    import json

    rep = json.loads(report.read_text())
    assert len(rep["outfiles"]) == 1
    data = open(rep["outfiles"][0]["path"], "rb").read()
    assert data.startswith(b"YUV4MPEG2 W96 H64 ")
    assert data.count(b"FRAME\n") == 19  # 20 coded, the last lost at EOF


# ---------------------------------------------------------------------------
# whole runs of the encode and mux side
# ---------------------------------------------------------------------------

def _dual_mono_adts():
    import aac_gen

    from amatsukaze_tpu_torch.audio import aac_tables as T

    swb = T.SWB_OFFSETS[(1024, 48000)]
    sfb = 8
    width = swb[sfb + 1] - swb[sfb]
    v0 = [0] * width
    v0[0] = 30
    v1 = [0] * width
    v1[1] = 50

    def payload(w):
        aac_gen.make_sce(w, {sfb: v0}, global_gain=160)
        aac_gen.make_sce(w, {sfb: v1}, global_gain=160)

    return aac_gen.make_adts_frame(payload, channel_config=0)


NICO_ASS = SAMPLE_ASS.replace("0:00:01.50", "0:00:00.50").replace(
    "0:00:05.50", "0:00:02.00")


def test_captions_nicojk_and_mux_pipeline_equals_jax(tmp_path):
    """A multi-service TS with ARIB captions and dual-mono AAC, NicoJK from
    an injected fetcher and a fake muxer binary, through both pipelines:
    the caption and NicoJK files, the split mono tracks, the muxer's
    arguments and the report are the JAX package's."""
    src = tmp_path / "cap.ts"
    src.write_bytes(ts_gen.build_simple_ts(
        num_frames=90, width=96, height=64, si=True,
        caption_groups=[
            (3, ts_gen.caption_management_group()),
            (5, ts_gen.caption_statement_group(
                b"\x0c" + b"\x1c" + bytes([0x40 + 12, 0x40])
                + ts_gen.arib_ascii("HELLO CAPTION"))),
            (60, ts_gen.caption_statement_group(b"\x0c"))],
        audio_es_frames=[_dual_mono_adts()] * 200,
        extra_services=[(0x0401, 0x01F1), (0x0402, 0x01F2)],
        extra_services_first=True))
    # the muxer, the timeline editor and mp4box: -o's file, else the last
    fake = tmp_path / "fake_muxer"
    fake.write_text("#!/bin/bash\nprintf '%s\\n' \"$@\" >> \"$0.args\"\n"
                    "out=''; prev=''\nfor a in \"$@\"; do "
                    "[ \"$prev\" = \"-o\" ] && out=\"$a\"; prev=\"$a\"; done\n"
                    "[ -z \"$out\" ] && out=\"$prev\"\n"
                    "echo MUXED > \"$out\"\n")
    fake.chmod(0o755)
    enc = tmp_path / "fake_x264"
    enc.write_text("#!/bin/bash\nout=''\nwhile [ $# -gt 0 ]; do case "
                   "\"$1\" in -o) out=\"$2\"; shift 2;; *) shift;; esac; "
                   "done\ncat > \"$out\"\n")
    enc.chmod(0o755)

    def run(m):
        side = m["trans"].__name__.split(".")[0]
        root = tmp_path / side
        root.mkdir()
        S = m["settings"]
        conf = S.Config()
        conf.src_file_path = str(src)
        conf.work_dir = str(root)
        conf.out_video_path = str(root / "out")
        conf.encoder_path = str(enc)
        conf.muxer_path = conf.mp4box_path = str(fake)
        conf.timelineeditor_path = str(fake)
        conf.subtitles = True
        conf.service_id = ts_gen.SERVICE_ID
        conf.nicojk_mask = 0b0011
        conf.no_remove_tmp = True
        ctx = m["ctx"](level="error")
        st = S.Settings(ctx, conf)
        kw = {"device": "cpu"} if side == "amatsukaze_tpu_torch" else {}
        pipe = m["trans"].TranscodePipeline(
            ctx, st, decoder_factory=m["dec"].NullDecoderFactory(),
            nicojk_fetchers=[lambda sid, t, dur: NICO_ASS], **kw)
        report = pipe.run()
        report.pop("encodewaits")
        report.pop("trace", None)  # the port's alone
        args = (tmp_path / "fake_muxer.args").read_text()
        (tmp_path / "fake_muxer.args").unlink()
        tmp = {}
        for f in sorted(os.listdir(st.tmp.path)):
            with open(os.path.join(st.tmp.path, f), "rb") as fh:
                tmp[f] = fh.read()
        return (_relative(repr(report), root), _relative(args, root),
                pipe.actual_service_id, tmp)

    got, want = _both(run)
    assert got == want
    report, args, sid, tmp = got
    assert sid == ts_gen.SERVICE_ID
    assert b"HELLO CAPTION" in tmp["c0-0-0-0.ass"]
    assert b"HELLO CAPTION" in tmp["c0-0-0-0.srt"]
    assert any(f.startswith("nicojk") or "nicojk" in f for f in tmp)
    assert "-nicojk720S.ass" in report and "-nicojk720T.ass" in report
    assert args.count("\n") > 4


def test_inbuild_x264_in_process_equals_subprocess_and_jax(tmp_path):
    """No x264 binary: the command resolves to the in-build shim. The port
    encodes in process (the shim's sink) and as a subprocess (python -m
    amatsukaze_tpu_torch.tools.x264_shim) to the same bytes, which are
    the JAX package's. Whether the FFmpeg bridge builds is decided here,
    not at collection (its build runs make)."""
    from amatsukaze_tpu.video import avdec as javdec
    from amatsukaze_tpu_torch.video import avdec

    if not (avdec.avdec_available() and javdec.avdec_available()):
        pytest.skip("FFmpeg bridge unavailable")
    src = tmp_path / "src.ts"
    src.write_bytes(ts_gen.build_simple_ts(num_frames=30, width=96,
                                           height=64))

    def run(m, mode):
        side = m["trans"].__name__.split(".")[0]
        root = tmp_path / f"{side}{mode}"
        root.mkdir()
        S = m["settings"]
        conf = S.Config()
        conf.src_file_path = str(src)
        conf.work_dir = str(root)
        conf.out_video_path = str(root / "out")
        conf.encoder_path = "x264"  # absent: the in-build shim
        conf.encoder_options = "--preset ultrafast --crf 20"
        conf.encoder_process = mode
        ctx = m["ctx"](level="error")
        kw = {"device": "cpu"} if side == "amatsukaze_tpu_torch" else {}
        pipe = m["trans"].TranscodePipeline(
            ctx, S.Settings(ctx, conf),
            decoder_factory=m["dec"].NullDecoderFactory(), **kw)
        with open(pipe.run()["outfiles"][0]["path"], "rb") as f:
            return f.read()

    inproc = run(SIDES["port"], 0)
    assert len(inproc) > 1000 and not inproc.startswith(b"YUV4MPEG2")
    assert run(SIDES["port"], 1) == inproc
    assert run(SIDES["jax"], 0) == inproc


def test_generic_mode_equals_jax(tmp_path):
    """--mode g (pipeline/simple.py): the y4m to the encoder, the audio
    tracks and the report."""
    enc = tmp_path / "fake_x264"
    enc.write_text("#!/bin/bash\nout=''\nwhile [ $# -gt 0 ]; do case "
                   "\"$1\" in -o) out=\"$2\"; shift 2;; *) shift;; esac; "
                   "done\ncat > \"$out\"\n")
    enc.chmod(0o755)
    src = tmp_path / "in.avi"
    src.write_bytes(b"fake container bytes")
    aud = tmp_path / "track0.aac"
    aud.write_bytes(b"\xff\xf1AAC")

    def run(m):
        side = m["trans"].__name__.split(".")[0]
        root = tmp_path / side
        root.mkdir()
        S, T = m["settings"], m["types"]
        conf = S.Config()
        conf.src_file_path = str(src)
        conf.work_dir = str(root)
        conf.out_video_path = str(root / "out")
        conf.encoder_path = str(enc)
        conf.no_remove_tmp = True
        st = S.Settings(m["ctx"](level="error"), conf)

        def decoder(path):
            fmt = T.VideoFormat(width=64, height=48, frame_rate_num=30000,
                                frame_rate_denom=1001, progressive=True,
                                fixed_frame_rate=True)
            rng = np.random.default_rng(2)
            frames = [(rng.integers(0, 256, (48, 64), dtype=np.uint8),
                       rng.integers(0, 256, (24, 32), dtype=np.uint8),
                       rng.integers(0, 256, (24, 32), dtype=np.uint8))
                      for _ in range(12)]
            return fmt, iter(frames), [str(aud)]

        cmds = []

        def muxer_runner(cmd, show):
            cmds.append(_relative(cmd, root))
            key = T.EncodeFileKey()
            with open(st.out_file_path(key, key), "wb") as f:
                f.write(b"m" * 9)
            return 0

        report = m["simple"].SimpleTranscode(
            st.ctx, st, decoder=decoder, muxer_runner=muxer_runner).run()
        key = T.EncodeFileKey()
        with open(st.enc_video_file_path(key), "rb") as f:
            video = f.read()
        with open(st.int_audio_file_path(key, 0), "rb") as f:
            audio = f.read()
        return _relative(repr(report), root), cmds, video, audio

    got, want = _both(run)
    assert got == want
    assert got[2].count(b"FRAME\n") == 12
