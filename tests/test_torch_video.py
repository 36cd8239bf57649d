"""The port's video decoders (copies of amatsukaze_tpu/video: the MPEG-2
oracle, the native engines' bindings, the FFmpeg bridge) against the JAX
package's.

MPEG-2 streams from tests/mpeg2_enc.py (frame and field pictures, I/P/B,
the coding options, 4:2:2) decode with the port's oracle and native
engine to the JAX decoders' frames and to the encoder's reconstruction,
exactly. utils/synth_ts.py's intra pictures decode to the writer's
reconstruction. The native H.264 and H.265 engines decode the crafted
streams of tests/h264_gen.py and tests/h265_craft.py to the JAX engines'
and oracles' frames. Where the FFmpeg bridge is present, its frames and
`qp_map_source_from_avdec`'s maps equal the JAX package's. Availability
of the native engines and of the bridge is decided inside the tests.
"""

import numpy as np
import pytest
from torch_compare import load_both_native, plain
from torch_threads import one_torch_thread  # noqa: F401

import h264_gen
import h265_craft
from mpeg2_enc import EncConfig, Mpeg2TestEncoder, synth_frames
from amatsukaze_tpu.ts import qp_extract as jqp
from amatsukaze_tpu.video import avdec as javdec
from amatsukaze_tpu.video import decode_es as j_decode_es
from amatsukaze_tpu.video import native as jnative

from amatsukaze_tpu_torch import video
from amatsukaze_tpu_torch.ts import qp_extract as tqp
from amatsukaze_tpu_torch.utils import synth_clip, synth_ts
from amatsukaze_tpu_torch.video import avdec, mpeg2_ref, native

# name -> (EncConfig, GOP letters in display order)
MPEG2 = {
    "ipb_frame": (EncConfig(64, 48, qs=4, progressive=False,
                            frame_pred_frame_dct=False, search=2,
                            picture_opts={1: {"motion": "field"},
                                          3: {"motion": "field"}}),
                  "IBPBP"),
    "progressive": (EncConfig(64, 48, qs=4, search=2), "IPBBP"),
    "field_pictures": (EncConfig(64, 64, qs=4, progressive=False,
                                 search=2, picture_opts={
                                     i: {"structure": "tb",
                                         "motion": "field"}
                                     for i in range(4)}), "IPPP"),
    "dual_prime": (EncConfig(64, 48, qs=8, progressive=False,
                             frame_pred_frame_dct=False, search=2,
                             picture_opts={1: {"motion": "dp"},
                                           2: {"motion": "dp"}}), "IPP"),
    "intra_tools": (EncConfig(48, 32, qs=2, progressive=True,
                              intra_vlc_format=True, alternate_scan=True,
                              intra_dc_precision=2, q_scale_type=True),
                    "IIP"),
    "custom_matrices": (EncConfig(64, 48, qs=6, custom_matrices=True,
                                  intra_q=(8,) + tuple(range(16, 79)),
                                  non_intra_q=tuple(range(16, 80))),
                        "IPB" + "P"),
    "chroma_422": (EncConfig(64, 48, qs=4, chroma_format=2), "IPBP"),
}


def _frames_plain(frames):
    return [(f.y.tobytes(), f.u.tobytes(), f.v.tobytes(), f.coding_type,
             f.temporal_reference, bool(f.top_field_first),
             bool(f.progressive_frame), bool(f.repeat_first_field))
            for f in frames]


@pytest.fixture(scope="module")
def mpeg2():
    cache = {}

    def get(name):
        if name not in cache:
            cfg, gop = MPEG2[name]
            frames = synth_frames(cfg.width, cfg.height, len(gop), seed=7,
                                  chroma_format=cfg.chroma_format)
            enc = Mpeg2TestEncoder(cfg)
            cache[name] = (enc.encode(frames, gop), enc.recon)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(MPEG2))
def test_mpeg2_oracle_equals_jax_and_encoder(mpeg2, name):
    es, recon = mpeg2(name)
    got = video.decode_es(es)
    assert _frames_plain(got) == _frames_plain(j_decode_es(es))
    assert len(got) == len(recon)
    for f, r in zip(got, recon):
        for p in "yuv":
            assert np.array_equal(getattr(f, p), getattr(r, p)), p


@pytest.mark.parametrize("name", list(MPEG2))
def test_mpeg2_native_equals_jax_native_and_oracle(mpeg2, name):
    if not load_both_native() or not native.native_available():
        pytest.skip("native library not buildable here")
    es, _ = mpeg2(name)
    got = _frames_plain(native.decode_es_native(es))
    assert got == _frames_plain(jnative.decode_es_native(es))
    assert got == _frames_plain(video.decode_es(es))
    # the streaming interface, one picture at a time
    dec = native.NativeMpeg2Decoder()
    frames = []
    for chunk in tqp.iter_picture_chunks(es):
        frames += dec.decode_picture(chunk)
    frames += dec.flush()
    assert _frames_plain(frames) == got
    assert dec.errors == 0


@pytest.mark.parametrize("engine", ["oracle", "native"])
def test_synth_ts_pictures_decode_to_the_writers_reconstruction(engine):
    if engine == "native" and not native.native_available():
        pytest.skip("native library not buildable here")
    spec = synth_clip.BROADCAST_CLIPS["small"]
    frames = synth_clip.make_broadcast_clip(
        **spec, scenes=synth_ts.TS_SCENES, num_frames=synth_ts.TS_FRAMES)
    rng = np.random.default_rng(1)
    es, recon, qmaps = b"", [], []
    for k in range(4):
        qs = rng.choice([2, 8, 16, 30, 62], 6)
        data, rec, qmap = synth_ts.encode_intra_picture(next(frames), qs, k,
                                                        k == 0)
        es += data
        recon.append(rec)
        qmaps.append(qmap)
        assert np.array_equal(qmap[:, 0], qs) and qmap.shape == (6, 8)
    dec = mpeg2_ref.Mpeg2RefDecoder() if engine == "oracle" else \
        native.NativeMpeg2Decoder()
    out = []
    for chunk in tqp.iter_picture_chunks(es + b"\x00\x00\x01\xb7"):
        out += dec.decode_picture(chunk)
    out += dec.flush()
    assert len(out) == 4
    for f, rec in zip(out, recon):
        assert (f.y.shape, f.u.shape) == ((96, 128), (48, 64))
        for got, want in zip((f.y, f.u, f.v), rec):
            assert np.array_equal(got, want)
    # the JAX oracle reads the same pictures
    assert _frames_plain(j_decode_es(es)) == _frames_plain(
        video.decode_es(es))


def test_synth_ts_idct_is_the_decoders():
    rng = np.random.default_rng(2)
    coef = rng.integers(-2048, 2048, (300, 8, 8))
    coef[:100] //= 64  # the magnitudes of coarse intra pictures too
    zigzag = np.asarray(mpeg2_ref.ZIGZAG_SCAN)
    got = synth_ts.idct_blocks(coef.reshape(-1, 64)[:, zigzag])
    got = got.reshape(-1, 8, 8)
    want = np.stack([mpeg2_ref.idct8x8(c) for c in coef])
    assert np.array_equal(got, want)


def _h264_streams():
    co = [0] * 16
    co[5] = 4
    return {
        "cavlc_luma": h264_gen.make_stream(2, 2, 23, {"luma_blocks": {
            0: [-4, -1, 1] + [0] * 13, 5: co}}),
        "cavlc_i16_dc": h264_gen.make_stream(2, 2, 37,
                                             {"i16_dc": [4, 3] + [0] * 14}),
        "cavlc_chroma": h264_gen.make_stream(
            2, 2, 17, {"chroma_dc": ([4, 2, 0, 1], [-3, 0, 0, 0])}),
        "cabac_p": h264_gen.cabac_pslice_stream(
            26, {0: {"skip": True}, 5: {"type": 0, "refs": [0],
                                        "mvds": [(4, -2)]}}),
    }


def _h265_streams():
    return {
        "pcm": h265_craft.pcm_stream(64, 48, 2)[0],
        "pcm_tiles": h265_craft.pcm_stream(96, 64, 1, tiles=(2, 2))[0],
    }


def _annexb_frames(dec, es):
    out = dec.decode(es) + dec.flush()
    return [(y.tobytes(), u.tobytes(), v.tobytes()) + tuple(rest)
            for y, u, v, *rest in out]


@pytest.mark.parametrize("codec,name", [("h264", n) for n in (
    "cavlc_luma", "cavlc_i16_dc", "cavlc_chroma", "cabac_p")] + [
    ("h265", n) for n in ("pcm", "pcm_tiles")])
def test_native_h264_h265_equal_jax(codec, name):
    if not load_both_native():
        pytest.skip("native library not buildable here")
    avail = (native.h264_native_available if codec == "h264"
             else native.h265_native_available)()
    if not avail:
        pytest.skip(f"native {codec} engine not built")
    es = (_h264_streams() if codec == "h264" else _h265_streams())[name]
    mine = native.NativeH264Decoder if codec == "h264" else \
        native.NativeH265Decoder
    theirs = jnative.NativeH264Decoder if codec == "h264" else \
        jnative.NativeH265Decoder
    got = _annexb_frames(mine(), es)
    assert got
    assert got == _annexb_frames(theirs(), es)
    if codec == "h264":
        from amatsukaze_tpu.video.h264_ref import H264RefDecoder as Oracle
    else:
        from amatsukaze_tpu.video.h265_ref import H265RefDecoder as Oracle
    ref = _annexb_frames(Oracle(), es)
    assert [g[:3] for g in got] == [r[:3] for r in ref]


@pytest.fixture(scope="module")
def mpeg2_ps(tmp_path_factory):
    """The "ipb_frame" stream in a minimal MPEG-2 PS file."""
    cfg, gop = MPEG2["ipb_frame"]
    frames = synth_frames(cfg.width, cfg.height, len(gop), seed=7)
    es = Mpeg2TestEncoder(cfg).encode(frames, gop)
    ps = bytearray()
    for off in range(0, len(es), 2000):
        chunk = es[off:off + 2000]
        ps += b"\x00\x00\x01\xba\x44" + b"\x00" * 8 + b"\xf8"
        ps += b"\x00\x00\x01\xe0" + (len(chunk) + 3).to_bytes(2, "big") \
            + b"\x80\x00\x00" + chunk
    path = tmp_path_factory.mktemp("avdec") / "v.mpg"
    path.write_bytes(bytes(ps))
    return str(path)


def _bridge_or_skip():
    if not (avdec.avdec_available() and javdec.avdec_available()):
        pytest.skip("FFmpeg bridge unavailable")


def test_avdec_frames_equal_jax(mpeg2_ps):
    _bridge_or_skip()
    got = [tuple(p.tobytes() for p in f)
           for f in avdec.decode_file_av(mpeg2_ps)]
    assert got
    assert got == [tuple(p.tobytes() for p in f)
                   for f in javdec.decode_file_av(mpeg2_ps)]
    dec = avdec.AvVideoDecoder(mpeg2_ps)
    ref = javdec.AvVideoDecoder(mpeg2_ps)
    for k in ("width", "height", "fps_num", "fps_den", "interlaced",
              "codec_id", "chroma_class", "sar", "bit_depth"):
        assert getattr(dec, k) == getattr(ref, k), k


def test_qp_map_source_from_avdec_equals_jax(mpeg2_ps):
    _bridge_or_skip()
    mine = tqp.qp_map_source_from_avdec(mpeg2_ps)
    theirs = jqp.qp_map_source_from_avdec(mpeg2_ps)
    assert (mine is None) == (theirs is None)
    if mine is None:
        return
    assert plain(mine.results) == plain(theirs.results)
    assert (mine.slices_ok, mine.slices_fallback) == \
        (theirs.slices_ok, theirs.slices_fallback)


def test_qp_map_source_from_avdec_without_bridge(monkeypatch, tmp_path):
    """No bridge: None, as in the JAX package."""
    monkeypatch.setattr(avdec, "avdec_available", lambda: False)
    assert tqp.qp_map_source_from_avdec(str(tmp_path / "none.mpg")) is None
