"""The port's TS front end as a whole, and its decoders and frame sources
(copies of amatsukaze_tpu/pipeline/decoders.py and frame_source.py),
against the JAX package.

A small MPEG-2 TS from utils/synth_ts.py (the short broadcast layout at
96x128: program with the logo, CM, program; silent audio around the cuts)
goes through the JAX TranscodePipeline in mode "cm" with the in-build
MPEG-2 decoder, and through the port's AMTSplitter, decode_mpeg2_ps_file
and run_cm_analysis(out_dir=...). The PS and wave files, the decoded
frames (also equal to the writer's reconstruction), the scene-change,
logo-frame, trim, div and JLS files and the CMAnalyzer results are equal;
the result's logo path differs by design (the JAX pipeline names the
.lgd file it was given, the port the logo's header name). Then
run_filter_stage(cm=...) in kfm_vfr on those frames against the JAX
FilterGraph: decisions and plan identical, frames bit-equal but at erase
rounding ties (pixels of the logo box, one code value apart; ROADMAP Queue
3 item 1); and yadif + deblock with the QP maps read from the
intermediate PS against the same stage fed the writer's quantiser scales.
"""

import os

import numpy as np
import pytest
from test_torch_filter_stage import jax_format, jax_stage
from torch_compare import load_both_native, plain
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu.pipeline import decoders as jdec
from amatsukaze_tpu.pipeline import frame_source as jfs
from amatsukaze_tpu.pipeline.settings import Config as JConfig
from amatsukaze_tpu.pipeline.settings import Settings as JSettings
from amatsukaze_tpu.pipeline.transcode import TranscodePipeline
from amatsukaze_tpu.utils.context import AMTContext as JContext

from amatsukaze_tpu_torch.audio.aac_native import make_decoder
from amatsukaze_tpu_torch.models.lgd import save_lgd
from amatsukaze_tpu_torch.pipeline import cm_stage
from amatsukaze_tpu_torch.pipeline import decoders as tdec
from amatsukaze_tpu_torch.pipeline import frame_source as tfs
from amatsukaze_tpu_torch.pipeline.cm_stage import (filter_source_pcm,
                                                    run_cm_analysis)
from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
from amatsukaze_tpu_torch.pipeline.splitter import AMTSplitter
from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.utils.context import AMTContext
from amatsukaze_tpu_torch.video import native as tnative

BATCH = 32


def _planes_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def front(tmp_path_factory):
    """The slice over the small synth TS: the writer's record, the port's
    split / decode / CM pass, and the JAX pipeline's run in mode cm."""
    load_both_native()
    base = tmp_path_factory.mktemp("front_end")
    ts, _, logos = synth_ts.ts_clip("small", str(base / "src.ts"))

    # the port
    conf = Config()
    conf.src_file_path = ts.path
    conf.work_dir = str(base / "port")
    conf.out_video_path = str(base / "port" / "out")
    conf.no_remove_tmp = True
    os.makedirs(conf.work_dir)
    ctx = AMTContext(level="error")
    st = Settings(ctx, conf)
    sp = AMTSplitter(ctx, st, audio_decoder_factory=make_decoder)
    reform = sp.split()
    reform.prepare(conf.split_sub, False)
    ps = st.int_video_file_path(0)
    frames = list(tdec.decode_mpeg2_ps_file(ps))
    fmt = reform.formats[reform.format_start_index[0]].video_format
    pcm = filter_source_pcm(reform, 0, st.wave_file_path())
    out_dir = base / "port_cm"
    out_dir.mkdir()
    cm = run_cm_analysis(ctx, lambda: iter(frames), len(frames), fmt, logos,
                         pcm_s16=pcm, batch=BATCH, device="cpu",
                         out_dir=str(out_dir))

    # the JAX pipeline, mode cm, the in-build MPEG-2 decoder
    lgd = []
    for k, lg in enumerate(logos):
        lgd.append(str(base / f"logo{k}.lgd"))
        save_lgd(lgd[-1], lg)
    jconf = JConfig()
    jconf.mode = "cm"
    jconf.src_file_path = ts.path
    jconf.work_dir = str(base / "jax")
    jconf.out_video_path = str(base / "jax" / "out")
    jconf.out_info_json_path = str(base / "jax" / "result.json")
    jconf.logo_path = lgd
    jconf.no_remove_tmp = True
    os.makedirs(jconf.work_dir)
    jctx = JContext(level="error")
    jst = JSettings(jctx, jconf)
    pipe = TranscodePipeline(jctx, jst,
                             decoder_factory=jdec.mpeg2_decoder_factory)
    results = []
    analyze = TranscodePipeline._analyze_video_file
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlogo_model, "_HOST_OPS", False)  # the device path
        mp.setenv("AMATSUKAZE_SCENE_METRICS", "device")
        mp.setattr(TranscodePipeline, "_analyze_video_file",
                   lambda self, r, v: results.append(analyze(self, r, v))
                   or results[-1])
        pipe.run()
        jcma = results[0]
        pipe._jls_elements(pipe._reform, 0, jcma)
        jsilence = pipe._detect_silence(pipe._reform, 0, fmt.frame_rate)
    return dict(ts=ts, logos=logos, st=st, reform=reform, ps=ps,
                frames=frames, fmt=fmt, pcm=pcm, cm=cm, out_dir=out_dir,
                jst=jst, jreform=pipe._reform, jcma=jcma,
                jsilence=jsilence)


def test_split_lays_down_what_the_writer_wrote(front):
    ts, reform = front["ts"], front["reform"]
    src = reform.get_filter_source_frames(0)
    assert len(src) == ts.num_frames == synth_ts.TS_FRAMES
    assert [f.frame_pts for f in src] == ts.pts
    assert [f.frame_index for f in src] == list(range(ts.num_frames))
    assert plain(src) == plain(front["jreform"].get_filter_source_frames(0))
    assert plain(reform.get_filter_source_audio_frames(0)) == plain(
        front["jreform"].get_filter_source_audio_frames(0))
    jst = front["jst"]
    for a, b in ((front["ps"], jst.int_video_file_path(0)),
                 (front["st"].wave_file_path(), jst.wave_file_path())):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_decode_equals_the_writers_reconstruction(front):
    frames, recon = front["frames"], front["ts"].recon
    assert len(frames) == len(recon)
    for k, (got, want) in enumerate(zip(frames, recon)):
        assert _planes_equal(got, want), k


def test_audio_is_the_writers(front):
    """The wave file holds the oracle's PCM of the writer's AAC frames;
    silence is found around both cuts."""
    from amatsukaze_tpu_torch.audio.aac import AacLcDecoder

    dec = AacLcDecoder()
    want = b"".join(dec.decode(f).pcm for f in front["ts"].audio_frames)
    assert front["pcm"].tobytes() == want[:front["pcm"].nbytes]
    spans = front["cm"].silence
    assert spans == front["jsilence"]
    for cut in synth_ts.TS_CUTS:
        assert any(a <= cut <= b for a, b in spans), (cut, spans)


@pytest.mark.parametrize("name", list(cm_stage.FILES))
def test_cm_files_equal_jax(front, name):
    jst = front["jst"]
    jpath = {"scpos": jst.tmp_chapter_exe_out_path(0),
             "logo_frames": jst.tmp_logo_frame_path(0),
             "trim": jst.tmp_trim_avs_path(0),
             "div": jst.tmp_div_path(0),
             "jls": jst.tmp_jls_path(0)}[name]
    got = (front["out_dir"] / cm_stage.FILES[name]).read_text()
    with open(jpath) as f:
        assert got == f.read()
    assert got.strip() or name == "div"


def test_cm_result_equals_jax(front):
    got, want = plain(front["cm"].result), plain(front["jcma"])
    assert got[1].pop("logopath") == front["logos"][0].header.name
    assert want[1].pop("logopath").endswith("logo0.lgd")
    assert got == want
    assert front["cm"].best_logo == 0
    assert front["cm"].scene_changes


@pytest.fixture(scope="module")
def kfm_stage(front):
    outs = []
    res = run_filter_stage(AMTContext(level="error"),
                           lambda: iter(front["frames"]),
                           len(front["frames"]), front["fmt"],
                           front["logos"], "kfm_vfr", outs.append,
                           batch=BATCH, device="cpu", cm=front["cm"])
    return res, outs


def test_kfm_vfr_stage_equals_jax(front, kfm_stage, monkeypatch):
    res, outs = kfm_stage
    fmt = front["fmt"]
    lg = front["logos"][0].header
    best, _, jfg, _, jouts = jax_stage(
        front["frames"], jax_format(fmt.height, fmt.width), front["logos"],
        "kfm_vfr", BATCH, monkeypatch)
    assert best == res.best_logo == 0
    fg = res.graph
    assert ([(int(d.mode), d.phase) for d in fg.decisions]
            == [(int(d.mode), d.phase) for d in jfg.decisions])
    assert fg.vfr_plan.durations == jfg.vfr_plan.durations
    assert fg.vfr_plan.source_frames == jfg.vfr_plan.source_frames
    assert len(outs) == len(jouts) > 0
    ties = 0
    for k, (got, want) in enumerate(zip(outs, jouts)):
        for p, sub in enumerate((1, 2, 2)):
            d = got[p].astype(np.int16) - want[p].astype(np.int16)
            ys, xs = np.nonzero(d)
            assert np.all(np.abs(d[ys, xs]) == 1), (k, p)
            assert np.all((ys >= lg.imgy // sub)
                          & (ys < (lg.imgy + lg.h) // sub)
                          & (xs >= lg.imgx // sub)
                          & (xs < (lg.imgx + lg.w) // sub)), (k, p)
            ties += len(ys)
    assert ties <= 1e-3 * sum(p.size for o in outs for p in o)


def test_deblock_from_the_ps_equals_the_writers_scales(front):
    ps, ts = front["ps"], front["ts"]
    src = QpMapSource.from_file(ps)
    assert len(src.results) == len(ts.qp_maps)
    for got, want in zip(src.results, ts.qp_maps):
        assert np.array_equal(got.qp, want)
    runs = []
    for qp in (src, QpMapSource.from_maps(ts.qp_maps)):
        outs = []
        run_filter_stage(AMTContext(level="error"),
                         lambda: iter(front["frames"]), len(front["frames"]),
                         front["fmt"], front["logos"], "yadif", outs.append,
                         batch=BATCH, device="cpu", cm=front["cm"],
                         post_filter="deblock", qp_source=qp)
        runs.append(outs)
    assert len(runs[0]) == len(front["frames"])
    for a, b in zip(*runs):
        assert _planes_equal(a, b)


# ---------------------------------------------------------------------------
# decoders and frame sources
# ---------------------------------------------------------------------------

def _frames(it):
    return [tuple(p.tobytes() for p in f) for f in it]


@pytest.mark.parametrize("engine", ["native", "oracle"])
def test_decode_mpeg2_ps_file_equals_jax(front, engine, monkeypatch):
    if engine == "native" and not tnative.native_available():
        pytest.skip("native library not buildable here")
    if engine == "oracle":
        def missing():
            raise RuntimeError("no native engine")

        from amatsukaze_tpu.video import native as jnative
        monkeypatch.setattr(tnative, "NativeMpeg2Decoder", missing)
        monkeypatch.setattr(jnative, "NativeMpeg2Decoder", missing)
    ps = front["ps"]
    got = _frames(tdec.decode_mpeg2_ps_file(ps))
    assert got == _frames(jdec.decode_mpeg2_ps_file(ps))
    assert got == _frames(front["ts"].recon)


def test_decode_ts_and_generic_equal_jax(front):
    path = front["ts"].path
    got = _frames(tdec.decode_ts_video_file(path))
    assert got == _frames(jdec.decode_ts_video_file(path))
    assert got == _frames(front["ts"].recon)
    fmt, it, audio = tdec.inbuild_generic_decoder(path)
    jfmt, jit, jaudio = jdec.inbuild_generic_decoder(path)
    assert plain(fmt) == plain(jfmt) and audio == jaudio == []
    assert _frames(it) == got
    fmt, it, _ = tdec.inbuild_generic_decoder(front["ps"])
    assert (fmt.width, fmt.height) == (128, 96)
    assert _frames(it) == got


def test_seek_opener_and_cached_frame_source_equal_jax(front):
    ps, reform = front["ps"], front["reform"]
    meta = reform.get_filter_source_frames(0)
    keys = sorted({m.key_frame for m in meta})
    assert len(keys) > 2
    recon = _frames(front["ts"].recon)
    for key in keys:
        off = meta[key].file_offset
        got = _frames(tdec.mpeg2_ps_seek_opener(ps)(key, off))
        assert got == _frames(jdec.mpeg2_ps_seek_opener(ps)(key, off))
        assert got == recon[key:]

    def source(mod, dec, ctx):
        return mod.CachedFrameSource(
            lambda: dec.decode_mpeg2_ps_file(ps), cache_frames=4,
            frames_meta=meta, open_at=dec.mpeg2_ps_seek_opener(ps), ctx=ctx)

    mine = source(tfs, tdec, AMTContext(level="error"))
    theirs = source(jfs, jdec, JContext(level="error"))
    for idx in (40, 3, 80, 17, 95, 0, 41):
        got = tuple(p.tobytes() for p in mine.get_frame(idx))
        assert got == tuple(p.tobytes() for p in theirs.get_frame(idx))
        assert got == recon[idx]
    for k in ("num_seeks", "num_restarts", "num_decoded", "failed"):
        assert getattr(mine, k) == getattr(theirs, k), k


@pytest.mark.parametrize("budget", [0, 10_000, 1 << 30])
def test_sweep_frame_cache_equals_jax(front, budget):
    frames = front["frames"][:12]
    mine, theirs = tfs.SweepFrameCache(budget), jfs.SweepFrameCache(budget)
    opened = {"port": 0, "jax": 0}

    def opener(side):
        def open_stream():
            opened[side] += 1
            return iter(frames)
        return open_stream

    for _ in range(3):
        got = _frames(mine.stream(0, opener("port")))
        assert got == _frames(theirs.stream(0, opener("jax")))
        assert got == _frames(frames)
    assert mine.hits == theirs.hits and opened["port"] == opened["jax"]
    assert opened["port"] == (1 if budget == 1 << 30 else 3)
    mine.drop(0)
    theirs.drop(0)
    assert mine._bytes == theirs._bytes == 0


@pytest.mark.parametrize("codec", ["H.264", "H.265"])
def test_missing_native_engine_falls_back_to_the_oracle(codec, monkeypatch):
    """Without the native engine the in-build H.264/H.265 decoders are the
    port's pure-Python oracles, as the JAX package's are its own; each
    decodes a small crafted stream (tests/paff_gen.py's B fields,
    tests/h265_craft.py's PCM pictures with tiles) to the JAX fallback's
    frames."""
    from amatsukaze_tpu.video import native as jnative

    if codec == "H.264":
        import paff_gen

        from amatsukaze_tpu_torch.video.h264_ref import H264RefDecoder

        name, oracle = "h264_native_available", H264RefDecoder
        opens = (tdec._open_h264_inbuild, jdec._open_h264_inbuild)
        es = paff_gen.crafted_b_field_stream(0)
    else:
        import h265_craft

        from amatsukaze_tpu_torch.video.h265_ref import H265RefDecoder

        name, oracle = "h265_native_available", H265RefDecoder
        opens = (tdec._open_h265_inbuild, jdec._open_h265_inbuild)
        es = h265_craft.pcm_stream(96, 64, 2, tiles=(2, 2))[0]
    monkeypatch.setattr(tnative, name, lambda: False)
    monkeypatch.setattr(jnative, name, lambda: False)
    mine, theirs = (open_inbuild(es) for open_inbuild in opens)
    assert type(mine) is oracle
    assert type(theirs).__name__ == oracle.__name__
    got = mine.decode(es) + mine.flush()
    want = theirs.decode(es) + theirs.flush()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert _planes_equal(a[:3], b[:3])


def test_auto_decoder_factory_routes_mpeg2_to_the_inbuild_decoder(front):
    class Pipeline:
        settings = front["st"]
        _reform = front["reform"]
        ctx = AMTContext(level="error")

    front["st"].conf.mpeg2_decoder = "native"
    got = _frames(tdec.auto_decoder_factory(Pipeline(), 0))
    assert got == _frames(front["ts"].recon)
    assert plain(tdec.pipeline_format(Pipeline(), 0)) == plain(front["fmt"])
    null = _frames(tdec.NullDecoderFactory(level=7)(Pipeline(), 0))
    assert len(null) == len(got) and null[0][0] == bytes([7]) * 96 * 128
