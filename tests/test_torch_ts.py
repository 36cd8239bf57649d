"""The port's transport-stream layer (copies of amatsukaze_tpu/ts) against
the JAX package's modules over the same tests/ts_gen.py streams: MPEG-2 and
H.264 video, ADTS and LATM audio, a PMT version change that moves the audio
PID, an audio format change and a geometry change, and MPEG-2 pictures with
a real macroblock layer (`real_slices`, per-row quantisers).

Field by field equal: the packets, the PES packets, the PSI tables, the
splitter's video and audio frames and its format and time events (with its
native engine and with the pure-Python path), and the QP maps through the
native and the slice-level extractors, from the ES, from a file and from a
PS. Then the deblock post filter fed by the port's QpMapSource(es) through
run_filter_stage: frames bit-equal to the JAX FilterGraph fed by the JAX
QpMapSource of the same stream.
"""

import numpy as np
import pytest
from torch_compare import plain
from torch_threads import one_torch_thread  # noqa: F401

import h264_gen
import latm_gen
import ts_gen
from amatsukaze_tpu import ts as jts
from amatsukaze_tpu.models import filter_graph as jfg_mod
from amatsukaze_tpu.pipeline.transcode import _pump_filtered
from amatsukaze_tpu.ts import pes as jpes
from amatsukaze_tpu.ts import psi as jpsi
from amatsukaze_tpu.ts import qp_extract as jqp
from amatsukaze_tpu.utils.context import AMTContext as JContext
from amatsukaze_tpu.utils.context import ErrorCounter as JErrorCounter

from amatsukaze_tpu_torch import ts as tts
from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
from amatsukaze_tpu_torch.ts import pes as tpes
from amatsukaze_tpu_torch.ts import psi as tpsi
from amatsukaze_tpu_torch.ts import qp_extract as tqp
from amatsukaze_tpu_torch.utils import synth_clip
from amatsukaze_tpu_torch.utils.bits import BitWriter
from amatsukaze_tpu_torch.utils.context import AMTContext
from amatsukaze_tpu_torch.utils.context import ErrorCounter as TErrorCounter

W, H = 96, 64
ROW_QS = [8, 12, 20, 30]


def _loas_chunks(n):
    """One LOAS mux element per AAC frame (for the TS muxer)."""
    adts = b"".join(ts_gen.adts_frame() for _ in range(n))
    loas = latm_gen.loas_from_adts(adts)
    chunks, i = [], 0
    while i + 3 <= len(loas):
        ln = ((loas[i + 1] & 0x1F) << 8) | loas[i + 2]
        chunks.append(loas[i:i + 3 + ln])
        i += 3 + ln
    return chunks


def _h264_access_units(n):
    """H.264 access units that the splitter's parser turns into frames: an
    AU delimiter (I, then P), SPS with VUI timing at 30000/1001 and
    pic_struct_present, PPS, a pic_timing SEI cycling TFF / BFF / TFF_RFF /
    FRAME, and an intra slice."""
    w = BitWriter()
    w.write(66, 8)
    w.write(0xC0, 8)
    w.write(30, 8)
    for v in (0, 0, 2, 1):  # sps id, log2_max_frame_num-4, poc type, refs
        h264_gen._ue(w, v)
    w.write(0, 1)
    h264_gen._ue(w, W // 16 - 1)
    h264_gen._ue(w, H // 16 - 1)
    w.write(0b110, 3)  # frame_mbs_only, direct_8x8, no cropping
    w.write(1, 1)  # VUI
    w.write(0, 4)  # no aspect ratio, overscan, signal type, chroma loc
    w.write(1, 1)  # timing info
    w.write(1001, 32)
    w.write(60000, 32)
    w.write(1, 1)  # fixed frame rate
    w.write(0, 2)  # no NAL / VCL HRD
    w.write(1, 1)  # pic_struct_present
    w.write(0, 1)  # no bitstream restriction
    h264_gen._trailing(w)
    sps = h264_gen._nal(w.getvalue(), 3, 7)
    pps = h264_gen.pps_nal()
    slice_ = h264_gen.islice_nal(W // 16, H // 16, 26, {})
    aus = []
    for i in range(n):
        # pic_timing of 1 byte: pic_struct, then clock_timestamp_flags of 0
        sei = bytes([1, 1, (3, 4, 5, 0)[i % 4] << 4, 0x80])
        aud = h264_gen._nal(bytes([(0 if i % 8 == 0 else 1) << 5 | 0x10]),
                            0, 9)
        aus.append(aud + sps + pps + h264_gen._nal(sei, 0, 6) + slice_)
    return aus


STREAMS = {
    "mpeg2_adts": lambda: ts_gen.build_simple_ts(
        num_frames=40, width=W, height=H, num_audio=2, psi_interval=10,
        pic_pattern="TFF,TFF_RFF,BFF,BFF_RFF,FIELDS_TFF", pmt_switch=18,
        audio_change=(25, 1)),
    "mpeg2_geometry": lambda: ts_gen.build_simple_ts(
        num_frames=30, width=W, height=H, geometry_change=(16, 64, 48)),
    "h264": lambda: ts_gen.build_simple_ts(
        width=W, height=H, video_stream_type=0x1B,
        video_es_frames=_h264_access_units(20)),
    "latm": lambda: ts_gen.build_simple_ts(
        num_frames=30, width=W, height=H, audio_stream_type=0x11,
        audio_es_frames=_loas_chunks(60)),
    "real_slices": lambda: ts_gen.build_simple_ts(
        num_frames=30, width=W, height=H, real_slices=True, row_qs=ROW_QS),
}


@pytest.fixture(scope="module", autouse=True)
def one_native_library():
    """Both packages load native/libamatsukaze_native.so (running `make`
    first). Another test process may be rebuilding it while one of them
    loads it; that one then tries again, so that both compare the same
    extractors."""
    from amatsukaze_tpu.ts import native as jnative
    from amatsukaze_tpu_torch.ts import native as tnative

    for _ in range(3):
        have = (tqp.native_available(), jqp.native_available())
        if have[0] == have[1]:
            return
        for ok, mods in zip(have, ((tnative, tqp), (jnative, jqp))):
            if not ok:
                for m in mods:
                    m._load_attempted = False


@pytest.fixture(scope="module")
def streams():
    return {k: make() for k, make in STREAMS.items()}


# ---------------------------------------------------------------------------
# packets, PES, PSI
# ---------------------------------------------------------------------------

def _packets(mod, data):
    """Every packet the parser delivers, as its header fields, PCR and
    payload, over a feed in odd-sized chunks after some garbage."""
    out = []

    class Collect(mod.TsPacketParser):
        def on_ts_packets(self, batch):
            for k in range(batch.count):
                p = mod.TsPacket(batch.data[k * 188:(k + 1) * 188])
                p.parse()
                out.append((p.pid, p.payload_unit_start_indicator,
                            p.continuity_counter, p.adaptation_field_control,
                            p.transport_scrambling_control, p.check(),
                            p.get_pcr(), bytes(p.payload())))

    parser = Collect()
    feed = b"\x47\x00garbage" + data
    for i in range(0, len(feed), 1000):
        parser.input_ts(feed[i:i + 1000])
    parser.flush()
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_packets_equal(streams, name):
    t, j = _packets(tts, streams[name]), _packets(jts, streams[name])
    assert len(t) == len(streams[name]) // 188
    assert t == j


def _pes_and_psi(mod, pes_mod, psi_mod, data):
    """PES packets of the video and audio PIDs and the PAT / PMT sections,
    each parsed, in order."""
    got = []

    class Pes(pes_mod.PesParser):
        def on_pes_packet(self, clock, packet):
            got.append(("pes", packet.stream_id, packet.pts, packet.dts,
                        packet.check(), bytes(packet.payload())))

    class Psi(psi_mod.PsiParser):
        def on_psi_section(self, clock, section):
            table = (psi_mod.PAT if section.table_id == 0 else psi_mod.PMT)(
                section)
            ok = table.check() and table.parse()
            got.append(("psi", section.table_id, section.version_number,
                        section.id, ok, plain(getattr(table, "elems", None)),
                        getattr(table, "pcr_pid", None)))

    parsers = {}
    for k in range(len(data) // 188):
        p = mod.TsPacket(memoryview(data)[k * 188:(k + 1) * 188])
        p.parse()
        if p.pid in (0, ts_gen.PMT_PID):
            parsers.setdefault(p.pid, Psi())
        elif p.pid in (ts_gen.VIDEO_PID, ts_gen.AUDIO_PID,
                       ts_gen.AUDIO_PID + 8):
            parsers.setdefault(p.pid, Pes())
        if p.pid in parsers:
            parsers[p.pid].on_ts_packet(k, p)
    for parser in parsers.values():
        if hasattr(parser, "flush"):
            parser.flush()
    return got


@pytest.mark.parametrize("name", ["mpeg2_adts", "h264", "latm"])
def test_pes_and_psi_equal(streams, name):
    t = _pes_and_psi(tts, tpes, tpsi, streams[name])
    j = _pes_and_psi(jts, jpes, jpsi, streams[name])
    assert t == j
    versions = {v for kind, tid, v, *_ in t if kind == "psi" and tid == 2}
    assert versions == ({0, 1} if name == "mpeg2_adts" else {0})


# ---------------------------------------------------------------------------
# the splitter and its ES parsers
# ---------------------------------------------------------------------------

def _split(mod, data):
    events = []

    class Events(mod.TsSplitter):
        def on_video_pes_packet(self, clock, frames, packet):
            events.append(("video", clock, plain(frames),
                           bytes(packet.payload())))

        def on_video_format_changed(self, fmt):
            events.append(("video_format", plain(fmt)))

        def on_audio_pes_packet(self, audio_idx, clock, frames, packet):
            events.append(("audio", audio_idx, clock, plain(frames)))

        def on_audio_format_changed(self, audio_idx, fmt):
            events.append(("audio_format", audio_idx, plain(fmt)))

        def on_time(self, clock, jst):
            events.append(("time", clock, plain(jst)))

    ctx = (AMTContext if mod is tts else JContext)(level="error")
    sp = Events(ctx)
    for i in range(0, len(data), 4096):
        sp.input_ts_data(data[i:i + 4096])
    sp.flush()
    return events, plain(ctx.counters)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_splitter_events_equal(streams, name, engine, monkeypatch):
    if engine == "python":
        monkeypatch.setenv("AMATSUKAZE_NO_NATIVE", "1")
    t, j = _split(tts, streams[name]), _split(jts, streams[name])
    kinds = {e[0] for e in t[0]}
    assert {"video", "video_format", "audio", "audio_format"} <= kinds
    assert t == j


# ---------------------------------------------------------------------------
# QP maps
# ---------------------------------------------------------------------------

def _video_es(data):
    out = []

    class Pes(tpes.PesParser):
        def on_pes_packet(self, clock, packet):
            out.append(bytes(packet.payload()))

    parser = Pes()
    for k in range(len(data) // 188):
        p = tts.TsPacket(memoryview(data)[k * 188:(k + 1) * 188])
        p.parse()
        if p.pid == ts_gen.VIDEO_PID:
            parser.on_ts_packet(k, p)
    parser.flush()
    return b"".join(out)


def _to_ps(es):
    """The ES in minimal MPEG-2 PS video packets (pack header + PES)."""
    ps = bytearray()
    for off in range(0, len(es), 100):
        chunk = es[off:off + 100]
        ps += b"\x00\x00\x01\xba" + b"\x44" + b"\x00" * 8 + b"\xf8"
        hdr = b"\x80\x00\x00"
        ln = len(chunk) + len(hdr)
        ps += b"\x00\x00\x01\xe0" + bytes([ln >> 8, ln & 0xFF]) + hdr + chunk
    return bytes(ps)


@pytest.fixture(scope="module")
def qp_es(streams):
    return _video_es(streams["real_slices"])


def test_picture_chunks_and_extractors_equal(qp_es):
    chunks = list(tqp.iter_picture_chunks(qp_es))
    assert chunks == list(jqp.iter_picture_chunks(qp_es))
    assert len(chunks) == 30
    assert tqp.native_available() == jqp.native_available()
    kinds = [(tqp.SliceQpExtractor, jqp.SliceQpExtractor)]
    if jqp.native_available():
        kinds.append((tqp.NativeQpExtractor, jqp.NativeQpExtractor))
    for tk, jk in kinds:
        te, je = tk(), jk()
        for c in chunks:
            a, b = te.parse_picture(c), je.parse_picture(c)
            assert plain(a)[1] == plain(b)[1]
        # the rows' quantisers of ts_gen's macroblock layer
        assert [int(q) for q in a.qp[:, 0]] == ROW_QS


@pytest.mark.parametrize("where", ["es", "ps", "file_es", "file_ps"])
def test_qp_map_source_equal(qp_es, where, tmp_path):
    is_ps = where.endswith("ps")
    data = _to_ps(qp_es) if is_ps else qp_es
    if where.startswith("file"):
        path = tmp_path / "video"
        path.write_bytes(data)
        t = tqp.QpMapSource.from_file(str(path), is_ps, read_chunk=333)
        j = jqp.QpMapSource.from_file(str(path), is_ps, read_chunk=333)
    else:
        t, j = tqp.QpMapSource(data, is_ps), jqp.QpMapSource(data, is_ps)
    assert len(t) == len(j) == 30
    assert (t.full_parse, t.slices_ok, t.slices_fallback) == \
        (j.full_parse, j.slices_ok, j.slices_fallback)
    assert plain(t.results) == plain(j.results)
    idx = [0, 3, 29, 31, -2]
    np.testing.assert_array_equal(t.maps_for(idx), j.maps_for(idx))
    sel_t, sel_j = t.select([5, 1, 40]), j.select([5, 1, 40])
    np.testing.assert_array_equal(sel_t.maps(0, 3), sel_j.maps(0, 3))
    if is_ps:
        assert tqp.extract_ps_video_es(data) == qp_es


def test_from_maps_matches_parsed_maps(qp_es):
    parsed = tqp.QpMapSource(qp_es, is_ps=False)
    built = tqp.QpMapSource.from_maps([r.qp for r in parsed.results])
    np.testing.assert_array_equal(built.maps(0, 32), parsed.maps(0, 32))


def test_deblock_from_stream_equals_jax(qp_es):
    """run_filter_stage(mode none, post_filter "deblock", qp_source=
    QpMapSource(es)) against the JAX FilterGraph with the JAX QpMapSource
    of the same ES, batched by `_pump_filtered`: every plane bit-equal, and
    deblock changed the frames."""
    rng = np.random.default_rng(3)
    frames = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                    for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
              for _ in range(30)]
    outs = []
    run_filter_stage(AMTContext(level="error"), lambda: iter(frames), 30,
                     synth_clip.video_format(H, W), [], "none", outs.append,
                     batch=8, device="cpu", post_filter="deblock",
                     qp_source=tqp.QpMapSource(qp_es, is_ps=False))
    fg = jfg_mod.FilterGraph(JContext(level="error"), mode="none", batch=8,
                             post_chain=jfg_mod.build_post_chain("deblock"),
                             qp_source=jqp.QpMapSource(qp_es, is_ps=False))
    fg._host_backend = False
    fg.quantize_output = True
    jouts = []

    class Pump:
        put = jouts.append

    _pump_filtered(fg, iter(frames), Pump(), 8)
    assert len(outs) == len(jouts) == 30
    for a, b in zip(outs, jouts):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, np.asarray(pb))
    assert any(not np.array_equal(a[0], f[0]) for a, f in zip(outs, frames))


# ---------------------------------------------------------------------------
# the utils and types copies under the ts layer
# ---------------------------------------------------------------------------

def test_bits_crc_context_and_types_copies(tmp_path):
    from amatsukaze_tpu import types as jtypes
    from amatsukaze_tpu.utils import bits as jbits
    from amatsukaze_tpu.utils import crc as jcrc

    from amatsukaze_tpu_torch import types as ttypes
    from amatsukaze_tpu_torch.utils import bits as tbits
    from amatsukaze_tpu_torch.utils import crc as tcrc

    data = np.random.default_rng(2).integers(0, 256, 4096).astype(
        np.uint8).tobytes()
    assert tcrc.crc32_mpeg2(data) == jcrc.crc32_mpeg2(data)
    np.testing.assert_array_equal(tcrc.CRC32_TABLE, jcrc.CRC32_TABLE)
    reads = []
    for mod in (tbits, jbits):
        r = mod.BitReader(data, 3)
        got = [r.read(5), r.ue(), r.se(), r.peek(11), r.byte_pos()]
        w = mod.BitWriter()
        for v, nb in ((5, 3), (1023, 10), (0, 7)):
            w.write(v, nb)
        w.byte_align(1)
        reads.append(got + [w.getvalue()])
    assert reads[0] == reads[1]
    drcs = tmp_path / "drcs_map.txt"
    drcs.write_text("ABCD=x\n\nbad line\nEF01 = y\n", encoding="utf-8")
    ctxs = [AMTContext(level="error"), JContext(level="error")]
    for ctx, counter in zip(ctxs, (TErrorCounter, JErrorCounter)):
        ctx.incr(counter.NON_CONTINUOUS_PTS, 3)
        ctx.load_drcs_mapping(str(drcs))
    assert ctxs[0].error_json() == ctxs[1].error_json()
    assert ctxs[0].drcs_map == ctxs[1].drcs_map
    for cm in range(3):
        keys = [mod.EncodeFileKey(2, 3, 4, mod.CMType(cm)).key()
                for mod in (ttypes, jtypes)]
        assert keys[0] == keys[1]
    for pic in range(7):
        assert ttypes.presenting_time(ttypes.PictureType(pic), 29.97) == \
            jtypes.presenting_time(jtypes.PictureType(pic), 29.97)
