"""The port's pure-Python H.264/H.265 decoders (copies of the JAX package's
video/h264_tables.py, h264_cabac.py, h264_ref.py, h264_paff.py,
h264_mbaff.py, h265_tables.py and h265_ref.py) against the JAX oracles.

- The two table modules equal the JAX ones name by name.
- The CABAC engine decodes the same bins as the JAX one from seeded bytes
  under seeded context states.
- Each oracle decodes the streams of the JAX tests, at their small sizes,
  to frames bit-equal to the JAX oracle's and, where the native engines
  build, to theirs: tests/h264_gen.py's CAVLC, CABAC I8 and CABAC P
  streams, tests/paff_gen.py's crafted B-field stream, x264's interlaced
  MBAFF and QCIF streams and x265's QCIF stream (where the FFmpeg bridge
  builds; each encoded once), tests/h265_craft.py's PCM streams with tiles
  and slice segments and its long-term reference stream, and the PCM
  pictures of utils/synth_ts.py at a size that the SPS crops.
- decode_h264_ps_file crops the in-build decoders' frames to the SPS's
  frame cropping rectangle.

Whether the native engines or the bridge build is decided inside the tests
(their loaders run make).
"""

import h264_gen
import h265_craft
import numpy as np
import paff_gen
import pytest
from torch_compare import load_both_native
from torch_threads import one_torch_thread  # noqa: F401

from amatsukaze_tpu.video import h264_cabac as jcabac
from amatsukaze_tpu.video import h264_ref as jh264
from amatsukaze_tpu.video import h264_tables as jt264
from amatsukaze_tpu.video import h265_ref as jh265
from amatsukaze_tpu.video import h265_tables as jt265

from amatsukaze_tpu_torch.pipeline import decoders as tdec
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.video import h264_cabac as tcabac
from amatsukaze_tpu_torch.video import h264_ref as th264
from amatsukaze_tpu_torch.video import h264_tables as tt264
from amatsukaze_tpu_torch.video import h265_ref as th265
from amatsukaze_tpu_torch.video import h265_tables as tt265
from amatsukaze_tpu_torch.video import native as tnative


@pytest.mark.parametrize("mine,theirs", [(tt264, jt264), (tt265, jt265)],
                         ids=["h264_tables", "h265_tables"])
def test_tables_equal_jax(mine, theirs):
    names = sorted(n for n in vars(theirs) if not n.startswith("_")
                   and not callable(vars(theirs)[n])
                   and type(vars(theirs)[n]).__name__ != "module")
    assert names == sorted(
        n for n in vars(mine) if not n.startswith("_")
        and not callable(vars(mine)[n])
        and type(vars(mine)[n]).__name__ != "module")
    assert names
    for n in names:
        a, b = getattr(mine, n), getattr(theirs, n)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        else:
            assert a == b, n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cabac_engine_equals_jax(seed):
    """Decisions over 24 seeded context states, bypass and terminate bins
    in a seeded order from seeded bytes: the same bins, context states and
    read positions."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    states = [[int(rng.integers(0, 63)), int(rng.integers(0, 2))]
              for _ in range(24)]
    start = int(rng.integers(0, 40))
    mine = tcabac.CabacEngine(data, start, [list(s) for s in states])
    theirs = jcabac.CabacEngine(data, start, [list(s) for s in states])
    assert mine.offset == theirs.offset
    ops = rng.integers(0, 26, 20000)
    got, want = [], []
    for op in ops:
        if op < 24:
            got.append(mine.decision(int(op)))
            want.append(theirs.decision(int(op)))
        elif op == 24:
            got.append(mine.bypass())
            want.append(theirs.bypass())
        else:
            got.append(mine.terminate())
            want.append(theirs.terminate())
    assert got == want
    assert 0 < sum(got) < len(got)
    assert (mine.ctx, mine.pos, mine.range_, mine.offset) == \
        (theirs.ctx, theirs.pos, theirs.range_, theirs.offset)


# --- streams ---------------------------------------------------------------


def _bridge_or_skip():
    from amatsukaze_tpu.video.avdec import avdec_available

    if not avdec_available():
        pytest.skip("FFmpeg bridge unavailable")


def _motion_frames(n, w, h, seed=7):
    """A panning crop over a smooth noise field (what x264's inter tools
    need to choose motion vectors), test_h264_decode.py's kind."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = [ndi.gaussian_filter(rng.uniform(0, 255, (h * 2 // s, w * 2 // s)),
                                3 - s) for s in (1, 2, 2)]
    out = []
    for i in range(n):
        dx, dy = (3 * i) % (w // 2), (2 * i) % (h // 2)
        planes = []
        for s, b in zip((1, 2, 2), base):
            p = b[dy // s:dy // s + h // s, dx // s:dx // s + w // s]
            if s == 1:
                p = p + rng.normal(0, 2, p.shape)
            planes.append(np.clip(p, 0, 255).astype(np.uint8))
        out.append(tuple(planes))
    return out


def _mixed_interlaced_frames(n, w, h):
    """test_h264_mbaff.py's mixed pictures: the right half woven from two
    motion phases (x264 codes it as field pairs), the left half static
    (frame pairs)."""
    src = _motion_frames(2 * n + 1, w, h)
    out = []
    for i in range(n):
        planes = []
        for a, b, still in zip(src[2 * i], src[2 * i + 1], src[-1]):
            p = a.copy()
            p[1::2] = b[1::2]
            p[:, :p.shape[1] // 2] = still[:, :p.shape[1] // 2]
            planes.append(p)
        out.append(tuple(planes))
    return out


def _encode(frames, w, h, params, codec="libx264", bframes=0):
    from amatsukaze_tpu.video.avdec import AvVideoEncoder

    enc = AvVideoEncoder(w, h, 30, 1, crf=26, preset="veryfast",
                         bframes=bframes, x264_params=params, codec=codec)
    out = []
    for y, u, v in frames:
        out += enc.encode(y, u, v)
    out += enc.flush()
    return b"".join(out)


def _pcm_frames(n, w, h, seed=3):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, (h // s, w // s), dtype=np.uint8)
                  for s in (1, 2, 2)) for _ in range(n)]


def _cabac_p():
    blk = [5, 0, -3, 1] + [0] * 12
    b8 = [0] * 64
    b8[0], b8[20] = 5, -3
    return h264_gen.cabac_pslice_stream(26, {
        0: {"type": 0, "mvds": [(1, 1)]},
        1: {"type": 1, "mvds": [(0, 0), (2, -3)]},
        5: {"type": 2, "mvds": [(1, 2), (0, 1)], "blocks": {0: blk}},
        6: {"type": 3, "sub": [0, 0, 0, 0], "mvds": [(0, 0)] * 4,
            "blocks8": {1: b8}},
        10: {"type": 0, "mvds": [(2, 2)], "blocks8": {0: b8}},
        11: {"type": 3, "sub": [1, 2, 3, 0],
             "mvds": [(1, 0), (1, 1), (2, 1), (0, 1), (-1, 3), (1, 1),
                      (-2, 0), (1, -1), (0, 0)]},
    })


# name -> (needs the bridge, what makes the stream); the x264/x265 ones
# encode on first use and are kept for the module
H264_STREAMS = {
    "cavlc": (False, lambda: h264_gen.make_stream(2, 2, 23, {
        "luma_blocks": {0: [-4, -1, 1] + [0] * 13,
                        5: [7, 0, 0, -3, 0, 1, -1] + [0] * 9},
        "chroma_dc": ([4, 2, 0, 1], [-3, 0, 0, 0])})),
    "cabac_i8": (False, lambda: h264_gen.make_cabac_stream(
        23, {0: [40, 9, -7] + [0] * 61, 3: [11, 5] + [0] * 62},
        modes=[2, 2, 2, 4])),
    "cabac_p": (False, _cabac_p),
    "paff_b_spatial": (False, lambda: paff_gen.crafted_b_field_stream(0)),
    "paff_b_temporal_implicit_deblock": (
        False, lambda: paff_gen.crafted_b_field_stream(
            1, direct_spatial=0, implicit=True, deblock=True,
            parity0=1)),
    "synth_pcm_cropped": (False, lambda: b"".join(
        synth_ts.h264_access_unit(f, i)
        for i, f in enumerate(_pcm_frames(3, 120, 88)))),
    "x264_mbaff_cavlc": (True, lambda: _encode(
        _mixed_interlaced_frames(4, 128, 96), 128, 96,
        "keyint=50:cabac=0:8x8dct=0:interlaced=1:tff=1:scenecut=0:"
        "b-adapt=0:ref=2:qp=28", bframes=2)),
    "x264_mbaff_cabac": (True, lambda: _encode(
        _mixed_interlaced_frames(4, 128, 96), 128, 96,
        "keyint=50:cabac=1:8x8dct=1:interlaced=1:tff=1:scenecut=0:"
        "b-adapt=0:ref=2:qp=26", bframes=2)),
    "x264_qcif": (True, lambda: _encode(
        _motion_frames(8, 176, 144), 176, 144,
        "cabac=1:8x8dct=1:keyint=12:ref=4:subme=7:crf=27", bframes=3)),
}
H265_STREAMS = {
    "pcm_tiles_dep_segments": (False, lambda: h265_craft.pcm_stream(
        96, 64, 1, tiles=(2, 2), segments=[6, 3], dep_segments=True)[0]),
    "pcm_segments_two_frames": (False, lambda: h265_craft.pcm_stream(
        48, 48, 2, segments=[4], dep_segments=True)[0]),
    "long_term_retention": (False, lambda: h265_craft.lt_stream(
        64, 48, retention=True)),
    "long_term_msb": (False, lambda: h265_craft.lt_stream(64, 48, msb=True)),
    "synth_pcm_cropped": (False, lambda: b"".join(
        synth_ts.h265_access_unit(f, i)
        for i, f in enumerate(_pcm_frames(3, 120, 88)))),
    "x265_qcif": (True, lambda: _encode(
        _motion_frames(8, 176, 144), 176, 144,
        "keyint=8:no-wpp=1:frame-threads=1:ref=2:qp=30", codec="libx265",
        bframes=2)),
}


@pytest.fixture(scope="module")
def streams():
    made = {}

    def get(codec, name):
        bridge, build = (H264_STREAMS if codec == "h264"
                         else H265_STREAMS)[name]
        if bridge:
            _bridge_or_skip()
        if (codec, name) not in made:
            made[codec, name] = build()
        return made[codec, name]

    return get


def _decode(decoder, es):
    return [tuple(np.asarray(p) for p in f[:3])
            for f in decoder.decode(es) + decoder.flush()]


def _assert_frames_equal(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        for name, p, q in zip("YUV", a, b):
            assert p.shape == q.shape and np.array_equal(p, q), \
                (what, i, name)


@pytest.mark.parametrize("name", list(H264_STREAMS))
def test_h264_oracle_equals_jax_and_native(streams, name):
    es = streams("h264", name)
    got = _decode(th264.H264RefDecoder(), es)
    _assert_frames_equal(got, _decode(jh264.H264RefDecoder(), es), name)
    if load_both_native() and tnative.h264_native_available():
        _assert_frames_equal(got, _decode(tnative.NativeH264Decoder(), es),
                             name)


@pytest.mark.parametrize("name", list(H265_STREAMS))
def test_h265_oracle_equals_jax_and_native(streams, name):
    es = streams("h265", name)
    got = _decode(th265.H265RefDecoder(), es)
    _assert_frames_equal(got, _decode(jh265.H265RefDecoder(), es), name)
    if load_both_native() and tnative.h265_native_available():
        _assert_frames_equal(got, _decode(tnative.NativeH265Decoder(), es),
                             name)


@pytest.mark.parametrize("native", [True, False], ids=["native", "oracle"])
@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_pcm_pictures_decode_to_the_frames(tmp_path, monkeypatch, codec,
                                           native):
    """synth_ts's PCM pictures at 88x120 (H.264 codes 96x128, HEVC 96x128,
    both cropped back) through decode_h26x_ps_file as an Annex B file:
    exactly the frames written, with the native engine and with the
    oracle behind it."""
    frames = _pcm_frames(17, 120, 88, seed=11)
    au = synth_ts.h264_access_unit if codec == "h264" \
        else synth_ts.h265_access_unit
    path = tmp_path / f"pcm.{codec}"
    path.write_bytes(b"".join(au(f, i) for i, f in enumerate(frames)))
    if native:
        if not (load_both_native()
                and getattr(tnative, f"{codec}_native_available")()):
            pytest.skip(f"native {codec} engine unavailable")
    else:
        monkeypatch.setattr(tnative, f"{codec}_native_available",
                            lambda: False)
    decode = tdec.decode_h264_ps_file if codec == "h264" \
        else tdec.decode_h265_ps_file
    got = [tuple(np.asarray(p) for p in f)
           for f in decode(str(path), is_ps=False)]
    _assert_frames_equal(got, frames, codec)


def test_emulation_prevention_follows_the_scalar_rule():
    """The vectorised 0x03 insertion equals the byte-by-byte rule (two
    zeros, then a byte <= 3: insert and count again) on runs of zeros of
    every length, before every kind of byte and at the end."""
    def scalar(data):
        out, zeros = bytearray(), 0
        for b in data:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(out)

    rng = np.random.default_rng(0)
    for _ in range(400):
        a = rng.choice(np.array([0, 0, 0, 1, 2, 3, 4, 255], np.uint8),
                       int(rng.integers(0, 64)))
        assert synth_ts.emulation_prevention(a).tobytes() == \
            scalar(a.tobytes())
