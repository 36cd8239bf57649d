"""The in-build MPEG-2 factory's decode in key-frame segments
(pipeline/decoders.py: mpeg2_segment_plan, decode_mpeg2_segments and the
process's budget of workers and frames) against the one-stream
decode_mpeg2_ps_file.

The streams: tests/mpeg2_enc.py's closed-GOP IPPP, open-GOP IBBP (leading
B pictures at every join) and field pictures in closed and open GOPs, and
an intra-only stream from portbench/pb/synth.py's writer like the
benchmark's, each a raw ES with a sequence header before every I picture;
the open-GOP streams cut to start at their second I frame, so that they
open with leading B pictures; and the small broadcast TS of utils/synth_ts.py
through the port's splitter, whose PS and filter source frames are the
pipeline's own. The ES streams' frames metadata is made the way
reform/stream_reform.py makes it: display order, a key frame at each I
picture that follows a sequence header, the frames before the first key
frame dropped.
"""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import mpeg2_enc as E
from amatsukaze_tpu_torch.audio.aac_native import make_decoder
from amatsukaze_tpu_torch.pipeline import decoders as dec
from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
from amatsukaze_tpu_torch.pipeline.splitter import AMTSplitter
from amatsukaze_tpu_torch.ts.qp_extract import iter_picture_chunks
from amatsukaze_tpu_torch.utils import synth_ts
from amatsukaze_tpu_torch.utils.context import AMTContext
from amatsukaze_tpu_torch.utils.perf import Trace
from amatsukaze_tpu_torch.video import native as tnative

W, H = 64, 64  # field pictures need a height of 32k


def _need_native():
    if not tnative.native_available():
        pytest.skip("native MPEG-2 engine not buildable here")


def _structure(chunk: bytes) -> int:
    """picture_structure of a picture's coding extension (3: a frame)."""
    pic = chunk.find(b"\x00\x00\x01\x00")
    at = chunk.find(b"\x00\x00\x01\xb5", pic)
    return chunk[at + 6] & 3 if at >= 0 and chunk[at + 4] >> 4 == 8 else 3


def _es_meta(es: bytes):
    """(frames metadata, coded frames) of an ES, as the reform makes them:
    one entry per frame (a field pair is one frame) in display order, with
    its picture's byte offset and the filter index of its key frame. The
    display order is the temporal references' within each stretch that
    starts at a sequence header."""
    frames = []  # coded order: [(stretch, temporal_reference), offset, key]
    pos = stretch = 0
    second_field = False
    for chunk in iter_picture_chunks(es):
        pos = es.index(chunk, pos)
        if second_field:
            second_field = False
        else:
            second_field = _structure(chunk) != 3
            tr, ctype = dec._picture_header(chunk)
            seq = chunk.find(b"\x00\x00\x01\xb3")
            seq = 0 <= seq < chunk.find(b"\x00\x00\x01\x00")
            stretch += seq
            frames.append([(stretch, tr), pos, ctype == 1 and seq])
        pos += len(chunk)
    meta = []
    key_frame = -1
    for j, (_, off, key) in enumerate(sorted(frames, key=lambda f: f[0])):
        if key:
            key_frame = len(meta)
        if key_frame < 0:
            continue
        meta.append(SimpleNamespace(frame_index=j, key_frame=key_frame,
                                    file_offset=off))
    return meta, len(frames)


def _intra_es(n: int) -> bytes:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "portbench"))
    from pb.synth import encode_intra_picture

    rng = np.random.default_rng(5)
    out = []
    for k in range(n):
        y = rng.integers(16, 235, (H, W)).astype(np.uint8)
        c = rng.integers(64, 192, (2, H // 2, W // 2)).astype(np.uint8)
        qs = 2 * rng.integers(4, 7, H // 16)
        out.append(encode_intra_picture((y, c[0], c[1]), qs,
                                        temporal_reference=k % 5,
                                        with_sequence=k % 5 == 0))
    return b"".join(out) + b"\x00\x00\x01\xb7"


def _enc_es(gop: str, **cfg) -> bytes:
    enc = E.Mpeg2TestEncoder(E.EncConfig(W, H, qs=4, search=1,
                                         seq_every_i=True, **cfg))
    return enc.encode(E.synth_frames(W, H, len(gop)), gop)


def _fields(gop: str) -> bytes:
    return _enc_es(gop, progressive=False, picture_opts={
        i: {"structure": "tb"} for i in range(len(gop))})


def _from_picture(es: bytes, coding_type: int, nth: int) -> bytes:
    """The ES from its nth picture of the coding type on (the pictures
    before it cut away, as a recording cut mid-stream)."""
    chunks = list(iter_picture_chunks(es))
    at = [j for j, c in enumerate(chunks)
          if dec._picture_header(c)[1] == coding_type][nth]
    return b"".join(chunks[at:])


OPEN_GOP = "IBBPBB" * 4 + "IBBP"

STREAMS = {
    "ippp_closed": lambda: _enc_es("IPPPP" * 5),
    "ibbp_open": lambda: _enc_es(OPEN_GOP),
    "fields": lambda: _fields("IPPP" * 5),
    "fields_open": lambda: _fields(OPEN_GOP),
    "intra": lambda: _intra_es(30),
    "leading_b": lambda: _from_picture(_enc_es(OPEN_GOP), 1, 1),
    "fields_leading_b": lambda: _from_picture(_fields(OPEN_GOP), 1, 2),
    "starts_at_p": lambda: _from_picture(_enc_es(OPEN_GOP), 2, 0),
}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    base = tmp_path_factory.mktemp("segments")
    out = {}
    for name, make in STREAMS.items():
        path = str(base / f"{name}.m2v")
        with open(path, "wb") as f:
            f.write(make())
        out[name] = path
    return out


@pytest.fixture(scope="module")
def broadcast(tmp_path_factory):
    """The small broadcast TS split by the port: (PS path, reform)."""
    tnative.load_native()
    base = tmp_path_factory.mktemp("segments_ts")
    ts, _, _ = synth_ts.ts_clip("small", str(base / "src.ts"))
    conf = Config()
    conf.src_file_path = ts.path
    conf.work_dir = str(base / "work")
    conf.out_video_path = str(base / "out")
    os.makedirs(conf.work_dir)
    ctx = AMTContext(level="error")
    st = Settings(ctx, conf)
    reform = AMTSplitter(ctx, st, audio_decoder_factory=make_decoder).split()
    reform.prepare(conf.split_sub, False)
    return st.int_video_file_path(0), reform


def _bytes(it):
    return [tuple(p.tobytes() for p in f) for f in it]


def _meta(path):
    return _es_meta(open(path, "rb").read())[0]


def _serial(path):
    return _bytes(dec.decode_mpeg2_ps_file(path, is_ps=False))


@pytest.fixture
def budget(monkeypatch):
    """Fix the process's worker budget (the host's cores and the slice
    threads decide it otherwise); returns the high-water marks of the
    workers and the frames in use."""
    seen = {"max": 0, "frames": 0}
    take0 = dec._BUDGET.take

    def take(segments, longest):
        n = take0(segments, longest)
        seen["max"] = max(seen["max"], dec._BUDGET.workers)
        seen["frames"] = max(seen["frames"], dec._BUDGET.frames)
        return n

    def fix(n):
        monkeypatch.setattr(dec, "decode_worker_budget", lambda: n)
        return seen

    monkeypatch.setattr(dec._BUDGET, "take", take)
    return fix


def _segment_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mpeg2-segment")]


def _idle():
    return (dec._BUDGET.workers == dec._BUDGET.frames == 0
            and not _segment_threads())


def _shift(meta, by):
    """The metadata of a second video file: display indices that start
    after the first file's frames."""
    return [SimpleNamespace(**{**vars(m), "frame_index": m.frame_index + by})
            for m in meta]


def _repeat(meta, j):
    """Frame j shown twice, as a repeat_first_field flag makes the reform
    list it: a second entry of the same frame, the later key frames one
    filter index on."""
    out = [SimpleNamespace(**vars(m)) for m in meta]
    out.insert(j + 1, SimpleNamespace(**vars(meta[j])))
    for m in out[j + 2:]:
        m.key_frame += m.key_frame > j
    return out


@pytest.mark.parametrize("name,min_frames", [
    ("ippp_closed", 5), ("ippp_closed", 8), ("ibbp_open", 6),
    ("ibbp_open", 4), ("fields", 4), ("fields_open", 4), ("intra", 5),
    ("intra", 10), ("leading_b", 4), ("leading_b", 6),
    ("fields_leading_b", 4)])
@pytest.mark.parametrize("workers", [2, 3])
def test_segments_equal_one_stream(streams, budget, name, min_frames,
                                   workers):
    _need_native()
    budget(workers)
    path = streams[name]
    segs = dec.mpeg2_segment_plan(path, _meta(path), min_frames,
                                  is_ps=False)
    assert segs is not None and len(segs) >= 2, segs
    assert segs[0][0] == 0 and [o for o, _ in segs] == sorted(
        {o for o, _ in segs})
    tr = Trace()
    got = _bytes(dec.decode_mpeg2_segments(path, segs, is_ps=False,
                                           trace=tr))
    want = _serial(path)
    assert len(got) == len(want) == sum(n for _, n in segs)
    assert got == want
    assert tr.counters == {"decode.segments": len(segs),
                           "decode.segment_frames": len(want)}
    assert _idle()


def test_open_gop_joins_drop_leading_b(streams):
    # the plan cuts at I pictures whose GOP opens with B pictures that
    # display before them: the segment before decodes those
    meta = _meta(streams["ibbp_open"])
    keys = sorted({m.key_frame for m in meta})
    assert keys == [0, 6, 12, 18, 24]
    assert [m.key_frame for m in meta[4:6]] == [0, 0]


def test_leading_b_count_the_first_segment(streams):
    """A file that opens with an open GOP: the reform drops the two B
    pictures that display before its first I picture, the one-stream
    decode yields them, and so does the first segment."""
    path = streams["leading_b"]
    meta = _meta(path)
    assert meta[0].frame_index == 2
    assert dec._leading_frames(path, False) == 2
    assert dec._leading_frames(streams["fields_open"], False) == 0
    assert dec._leading_frames(streams["fields_leading_b"], False) == 2
    segs = dec.mpeg2_segment_plan(path, meta, 6, is_ps=False)
    assert [n for _, n in segs] == [8, 6, 10]
    assert len(_serial(path)) == len(meta) + 2


@pytest.mark.parametrize("case", ["second_file", "repeated"])
def test_plan_follows_frame_index(streams, budget, case):
    """Filter frames that are not the decode's frames one for one: a
    second video file's (display indices after the first file's) and a
    frame listed twice (repeat_first_field). The segments count decoded
    frames, and the decode equals the one stream."""
    _need_native()
    budget(3)
    path = streams["ibbp_open"]
    meta = _meta(path)
    meta = _shift(meta, 900) if case == "second_file" else _repeat(meta, 8)
    segs = dec.mpeg2_segment_plan(path, meta, 4, is_ps=False)
    assert [n for _, n in segs] == [6, 6, 6, 6, 4]
    got = _bytes(dec.decode_mpeg2_segments(path, segs, is_ps=False))
    assert got == _serial(path)


def test_broadcast_ps_segments_equal_one_stream(broadcast, budget):
    _need_native()
    budget(4)
    ps, reform = broadcast
    meta = reform.get_filter_source_frames(0)
    want = _bytes(dec.decode_mpeg2_ps_file(ps))
    # a sequence header every 15 frames: cut at the first key frame at
    # least min_frames after the last cut, min_frames left
    for min_frames, cuts, frames in ((32, [45], [45, 51]),
                                     (3, range(15, 91, 15), [15] * 6 + [6])):
        segs = dec.mpeg2_segment_plan(ps, meta, min_frames)
        assert [n for _, n in segs] == frames
        assert [o for o, _ in segs] == [0] + [meta[k].file_offset
                                              for k in cuts]
        assert _bytes(dec.decode_mpeg2_segments(ps, segs)) == want


def _drop(meta, j):
    return meta[:j] + meta[j + 1:]


def _backwards(meta, j):
    return meta[:j] + [meta[j + 1], meta[j]] + meta[j + 2:]


@pytest.mark.parametrize("case", ["short", "dropped", "backwards",
                                  "starts_at_p", "empty"])
def test_fallbacks_equal_one_stream(streams, budget, case):
    """No plan where it cannot be proven; the decode is then the one
    stream's, on no worker, and counted as a serial file."""
    _need_native()
    budget(4)
    path = streams["starts_at_p" if case == "starts_at_p" else "ibbp_open"]
    meta = _meta(path)
    min_frames = len(meta) // 2 + 1 if case == "short" else 4
    if case == "dropped":
        meta = _drop(meta, 8)
    elif case == "backwards":
        meta = _backwards(meta, 8)
    elif case == "starts_at_p":
        # the file opens with a P picture: the decode drops the pictures
        # before its first I picture
        assert dec._leading_frames(path, False) is None
    elif case == "empty":
        meta = []
    assert dec.mpeg2_segment_plan(path, meta, min_frames,
                                  is_ps=False) is None
    tr = Trace()
    got = _bytes(dec.decode_mpeg2_segments(path, None, is_ps=False,
                                           trace=tr))
    assert got == _serial(path)
    assert tr.counters == {"decode.serial_files": 1}


def test_plan_needs_an_mpeg_file(tmp_path, streams):
    path = streams["intra"]
    meta = _meta(path)
    assert dec.mpeg2_segment_plan(path, meta, 5, is_ps=False) is not None
    other = tmp_path / "not_mpeg.bin"
    other.write_bytes(bytes(range(256)) * 64)
    assert dec.mpeg2_segment_plan(str(other), meta, 5, is_ps=False) is None
    assert dec.mpeg2_segment_plan(str(tmp_path / "missing.m2v"), meta, 5,
                                  is_ps=False) is None


def _wrap_opener(monkeypatch, wrap):
    """Route every joined segment's frames through wrap(offset, frames)."""
    opener0 = dec.mpeg2_ps_seek_opener

    def opener(path, is_ps=True, read_chunk=8 << 20):
        inner = opener0(path, is_ps, read_chunk)
        return lambda key, offset: wrap(offset, inner(key, offset))

    monkeypatch.setattr(dec, "mpeg2_ps_seek_opener", opener)


def test_short_segment_finishes_as_one_stream(streams, budget, monkeypatch):
    """A segment that gives fewer frames than planned (a join the plan
    could not see) stops the workers; one stream decodes the rest."""
    _need_native()
    budget(2)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 5, is_ps=False)

    def short(offset, frames):
        for j, planes in enumerate(frames):
            if offset == segs[2][0] and j == 3:
                return
            yield planes

    _wrap_opener(monkeypatch, short)
    tr = Trace()
    got = _bytes(dec.decode_mpeg2_segments(path, segs, is_ps=False,
                                           trace=tr))
    assert got == _serial(path)
    c = tr.counters
    assert c["decode.segments"] == 2 and c["decode.serial_files"] == 1
    assert c["decode.segment_frames"] == segs[0][1] + segs[1][1]
    assert _idle()


def test_close_early_stops_every_worker(streams, budget):
    _need_native()
    budget(3)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 3, is_ps=False)
    it = dec.decode_mpeg2_segments(path, segs, is_ps=False)
    for _ in range(4):
        next(it)
    assert len(_segment_threads()) == 3 and dec._BUDGET.workers == 3
    it.close()
    assert _idle()


def test_worker_exception_reaches_the_consumer(streams, budget,
                                               monkeypatch):
    _need_native()
    budget(2)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 5, is_ps=False)

    def failing(offset, frames):
        if offset == segs[3][0]:
            raise ValueError("broken segment")
        yield from frames

    _wrap_opener(monkeypatch, failing)
    got = 0
    with pytest.raises(ValueError, match="broken segment"):
        for _ in dec.decode_mpeg2_segments(path, segs, is_ps=False):
            got += 1
    assert got == sum(n for _, n in segs[:3])
    assert _idle()


def test_two_decodes_share_the_budget(streams, budget):
    """Two decodes at once: the first takes what the budget has, the
    second the rest or, with fewer than two left, one stream."""
    _need_native()
    seen = budget(5)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 3, is_ps=False)
    want = _serial(path)
    trs = [Trace() for _ in range(3)]
    # a plan cut short: its last segment decodes to the file's end
    its = [dec.decode_mpeg2_segments(path, segs[:n], is_ps=False,
                                     trace=tr)
           for n, tr in zip((3, 5, 5), trs)]
    outs = [[] for _ in its]
    live = list(range(len(its)))
    while live:  # one frame of each in turn
        for i in list(live):
            try:
                outs[i].append(tuple(p.tobytes() for p in next(its[i])))
            except StopIteration:
                live.remove(i)
            assert dec._BUDGET.workers <= 5
    assert seen["max"] == 5
    assert all(o == want for o in outs)
    # 3 workers for the first (three segments), 2 for the second, the
    # third decodes as one stream
    assert "decode.serial_files" not in trs[0].counters
    assert "decode.serial_files" not in trs[1].counters
    assert trs[2].counters == {"decode.serial_files": 1}
    assert _idle()


@pytest.mark.parametrize("held,want", [(256, 4), (25, 4), (24, 3),
                                       (15, 2), (14, 0)])
def test_frames_held_bound_the_workers(streams, budget, monkeypatch, held,
                                       want):
    """A decode of W workers on segments of at most L frames holds
    (W + 1) x L of them: the process's frame budget caps W like its
    worker budget, and below two workers the file decodes as one
    stream."""
    _need_native()
    seen = budget(4)
    monkeypatch.setattr(dec, "_HELD_FRAMES", held)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 5, is_ps=False)
    assert max(n for _, n in segs) == 5 and len(segs) == 6
    tr = Trace()
    assert _bytes(dec.decode_mpeg2_segments(path, segs, is_ps=False,
                                            trace=tr)) == _serial(path)
    assert seen["max"] == want and seen["frames"] == (want + 1) * 5 * (
        want > 0)
    assert ("decode.serial_files" in tr.counters) == (want == 0)
    assert _idle()


@pytest.mark.parametrize("cores,env,cpus,want", [
    (8, "4", 8, 4), (8, "", 8, 2), (8, "1", 8, 16), (2, "4", 8, 1),
    (4, "4", 8, 2), (8, "3x", 8, 5), (8, "junk", 8, 16), (8, "0", 8, 16)])
def test_worker_budget_from_cores_and_slice_threads(monkeypatch, cores, env,
                                                    cpus, want):
    monkeypatch.setattr(dec.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    monkeypatch.setattr(dec.os, "cpu_count", lambda: cpus)
    monkeypatch.setenv("AMATSUKAZE_DECODE_THREADS", env)
    assert dec.decode_worker_budget() == want


def test_budget_holds_under_many_concurrent_decodes(streams, budget):
    """Twelve decodes on twelve threads, more workers wanted than the host
    has cores, with the interpreter switching threads often: the workers
    in use never pass the budget, every decode gives the one stream's
    frames, and every place is given back."""
    _need_native()
    seen = budget(6)
    path = streams["intra"]
    segs = dec.mpeg2_segment_plan(path, _meta(path), 5, is_ps=False)
    want = _serial(path)

    def run(_):
        return _bytes(dec.decode_mpeg2_segments(path, segs, is_ps=False))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(12) as pool:
            outs = list(pool.map(run, range(12), timeout=60))
    finally:
        sys.setswitchinterval(switch)
    assert all(o == want for o in outs)
    assert 2 <= seen["max"] <= 6
    assert seen["frames"] <= dec._HELD_FRAMES
    assert _idle()
