"""The port's stream reform, settings, PS writer and splitter (copies of
amatsukaze_tpu/reform, pipeline/settings.py, io/ps_writer.py and
pipeline/splitter.py) against the JAX package's over the same
tests/ts_gen.py streams: RFF and field-picture patterns, a PMT version
change that moves two audio PIDs, an audio channel change, a geometry
change, ARIB captions, and real AAC frames decoded into the wave file.

Exactly equal: the intermediate PS, audio and wave files AMTSplitter
writes, the splitter's counts, `StreamReformInfo.serialize()` bytes, the
filter-source frames and audio frames of every video file, and the
reform's CM-zone, audio and output-file plan.
"""

import os

import numpy as np
import pytest
from torch_compare import load_both_native, plain
from torch_threads import one_torch_thread  # noqa: F401

import ts_gen
from amatsukaze_tpu.audio.aac_native import make_decoder as j_make_decoder
from amatsukaze_tpu.pipeline import probe as jprobe
from amatsukaze_tpu.pipeline.settings import Config as JConfig
from amatsukaze_tpu.pipeline.settings import Settings as JSettings
from amatsukaze_tpu.pipeline.splitter import AMTSplitter as JSplitter
from amatsukaze_tpu.types import CMType as JCMType
from amatsukaze_tpu.utils.context import AMTContext as JContext

from amatsukaze_tpu_torch.audio.aac_native import make_decoder
from amatsukaze_tpu_torch.pipeline import probe
from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
from amatsukaze_tpu_torch.pipeline.splitter import AMTSplitter
from amatsukaze_tpu_torch.reform import StreamReformInfo
from amatsukaze_tpu_torch.types import CMType
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.utils.context import AMTContext

W, H = 96, 64


def _aac_frames(n):
    rng = np.random.default_rng(11)
    return [synth_ts.aac_frame(None if 20 <= k < 30 else rng)
            for k in range(n)]


def _captions():
    return [
        (3, ts_gen.caption_management_group()),
        (5, ts_gen.caption_statement_group(
            b"\x0c" + b"\x1c" + bytes([0x40 + 12, 0x40])
            + ts_gen.arib_ascii("HELLO CAPTION"))),
        (40, ts_gen.caption_statement_group(b"\x0c")),
    ]


# name -> (stream, conf overrides, decode the audio)
STREAMS = {
    "plain": (lambda: ts_gen.build_simple_ts(num_frames=60, width=W,
                                             height=H), {}, False),
    "rff": (lambda: ts_gen.build_simple_ts(
        num_frames=60, width=W, height=H,
        pic_pattern="TFF,TFF_RFF,BFF,BFF_RFF"), {}, False),
    "fields": (lambda: ts_gen.build_simple_ts(
        num_frames=45, width=W, height=H,
        pic_pattern="FIELDS_TFF,TFF,FIELDS_BFF,BFF"), {}, False),
    "pmt_switch": (lambda: ts_gen.build_simple_ts(
        num_frames=90, width=W, height=H, num_audio=2, pmt_switch=40),
        {}, False),
    "audio_change": (lambda: ts_gen.build_simple_ts(
        num_frames=300, width=W, height=H, audio_change=(150, 1)),
        {}, False),
    "geometry": (lambda: ts_gen.build_simple_ts(
        num_frames=300, width=W, height=H,
        geometry_change=(150, W * 2, H * 2)), {"split_sub": True}, False),
    "captions": (lambda: ts_gen.build_simple_ts(
        num_frames=90, width=W, height=H, si=True,
        caption_groups=_captions()), {"subtitles": True}, False),
    "aac": (lambda: ts_gen.build_simple_ts(
        num_frames=60, width=W, height=H,
        audio_es_frames=_aac_frames(100)), {}, True),
}


def _split(side, data, conf_kw, decode_audio, work):
    """AMTSplitter of one package over `data`: (splitter, settings,
    prepared reform)."""
    if side == "jax":
        Conf, Sett, Split, Ctx, dec, cap = (JConfig, JSettings, JSplitter,
                                            JContext, j_make_decoder,
                                            jprobe.default_caption_decoder)
    else:
        Conf, Sett, Split, Ctx, dec, cap = (Config, Settings, AMTSplitter,
                                            AMTContext, make_decoder,
                                            probe.default_caption_decoder)
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "src.ts")
    with open(src, "wb") as f:
        f.write(data)
    conf = Conf()
    conf.src_file_path = src
    conf.work_dir = work
    conf.out_video_path = os.path.join(work, "out")
    conf.no_remove_tmp = True
    for k, v in conf_kw.items():
        setattr(conf, k, v)
    ctx = Ctx(level="error")
    st = Sett(ctx, conf)
    sp = Split(ctx, st, audio_decoder_factory=dec if decode_audio else None,
               caption_decoder=cap(ctx, st) if conf.subtitles else None)
    reform = sp.split()
    reform.prepare(conf.split_sub, False)
    return sp, st, reform


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    load_both_native()
    cache = {}

    def get(name):
        if name not in cache:
            make, conf_kw, decode = STREAMS[name]
            data = make()
            base = tmp_path_factory.mktemp(name)
            cache[name] = {side: _split(side, data, conf_kw, decode,
                                        str(base / side))
                           for side in ("jax", "port")}
        return cache[name]

    return get


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(STREAMS))
def test_split_files_equal(split, name):
    (jsp, jst, _), (tsp, tst, _) = split(name)["jax"], split(name)["port"]
    assert tsp.video_file_count == jsp.video_file_count >= 1
    for attr in ("total_int_video_size", "src_file_size",
                 "num_total_packets", "num_scramble_packets"):
        assert getattr(tsp, attr) == getattr(jsp, attr), attr
    for v in range(tsp.video_file_count):
        assert _read(tst.int_video_file_path(v)) == \
            _read(jst.int_video_file_path(v))
    assert _read(tst.audio_file_path()) == _read(jst.audio_file_path())
    assert _read(tst.wave_file_path()) == _read(jst.wave_file_path())
    if name == "aac":
        assert os.path.getsize(tst.wave_file_path()) > 0
    if name == "captions":
        assert tsp.caption_list
    assert plain(tsp.caption_list) == plain(jsp.caption_list)
    assert plain(tsp.time_list) == plain(jsp.time_list)


@pytest.mark.parametrize("name", list(STREAMS))
def test_serialize_equal(split, name, tmp_path):
    (_, _, jr), (_, _, tr) = split(name)["jax"], split(name)["port"]
    jr.serialize(str(tmp_path / "jax.dat"))
    tr.serialize(str(tmp_path / "port.dat"))
    data = _read(tmp_path / "port.dat")
    assert data == _read(tmp_path / "jax.dat")
    back = StreamReformInfo.deserialize(AMTContext(level="error"),
                                        str(tmp_path / "port.dat"))
    back.serialize(str(tmp_path / "again.dat"))
    assert _read(tmp_path / "again.dat") == data


@pytest.mark.parametrize("name", list(STREAMS))
def test_filter_source_frames_equal(split, name):
    (_, _, jr), (_, _, tr) = split(name)["jax"], split(name)["port"]
    assert tr.num_video_file == jr.num_video_file
    for v in range(tr.num_video_file):
        frames = tr.get_filter_source_frames(v)
        assert frames
        assert plain(frames) == plain(jr.get_filter_source_frames(v))
        assert plain(tr.get_filter_source_audio_frames(v)) == \
            plain(jr.get_filter_source_audio_frames(v))
    assert plain(tr.formats) == plain(jr.formats)
    assert tr.format_start_index == jr.format_start_index
    assert plain(tr.get_in_out_duration()) == plain(jr.get_in_out_duration())


@pytest.mark.parametrize("name", list(STREAMS))
def test_cm_zones_and_output_plan_equal(split, name):
    """After the CM decision: zones applied per video file, the audio
    plan, and the output files' keys and timing."""
    (_, _, jr), (_, _, tr) = split(name)["jax"], split(name)["port"]
    for v in range(tr.num_video_file):
        n = len(tr.get_filter_source_frames(v))
        zones, divs = [(n // 4, n // 2)], [0, n // 3]
        tr.apply_cm_zones(v, zones, divs)
        jr.apply_cm_zones(v, zones, divs)
    assert plain(tr.gen_audio(list(CMType))) == \
        plain(jr.gen_audio(list(JCMType)))
    keys = tr.get_out_file_keys()
    assert keys
    assert plain(keys) == plain(jr.get_out_file_keys())


@pytest.mark.parametrize("name", ["captions", "audio_change", "pmt_switch",
                                  "aac"])
def test_probes_and_ps_verifier_equal(split, name):
    """The subtitle and audio probes (pipeline/probe.py) over the source,
    and PsStreamVerifier over the intermediate PS, as in the JAX package."""
    from amatsukaze_tpu.io.ps_writer import PsStreamVerifier as JVerifier

    from amatsukaze_tpu_torch.io.ps_writer import PsStreamVerifier

    (_, jst, _), (_, tst, _) = split(name)["jax"], split(name)["port"]
    assert probe.probe_subtitles(tst.ctx, tst) == \
        jprobe.probe_subtitles(jst.ctx, jst)
    audio = probe.probe_audio(tst.ctx, tst)
    assert audio and audio == jprobe.probe_audio(jst.ctx, jst)
    data = _read(tst.int_video_file_path(0))
    mine, theirs = PsStreamVerifier(tst.ctx), JVerifier(jst.ctx)
    assert mine.verify(data) == theirs.verify(data) is True
    assert (mine.n_video, mine.n_audio, mine.n_psm) == \
        (theirs.n_video, theirs.n_audio, theirs.n_psm)
    assert mine.n_video > 0 and mine.n_psm > 0
