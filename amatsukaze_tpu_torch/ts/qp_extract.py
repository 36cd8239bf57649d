"""Per-macroblock QP-map extraction from MPEG-2 elementary streams.

The reference drives its KDeblock QP-aware deblocker with quantiser
tables exported by a patched FFmpeg (av_frame_get_qp_table /
AV_FRAME_DATA_MB_DC_TABLE_DATA, reference Amatsukaze/AMTSource.hpp:371-404).
Here the tables come straight from the ES macroblock layer:

- native engine (native/mpeg2qp.cpp): full slice/macroblock parse, per-MB
  quantiser_scale + intra luma DC differential; VLC desync inside a slice
  degrades to the slice-header QP for that slice's remainder.
- pure-Python fallback: slice-header QP only (one value per MB row) -
  header-level parse, no VLC, always available.

QP maps feed ops.denoise.deblock_qp ([B, H/16, W/16] quantiser scales).

The port's copy of amatsukaze_tpu/ts/qp_extract.py, with
`QpMapSource.from_maps` for maps the caller already has.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .native import load_native

_lock = threading.Lock()
_lib = None
_load_attempted = False

# q_scale_type == 1 mapping (ISO 13818-2 table 7-6)
NONLINEAR_QSCALE = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
    24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112,
]


def _load():
    """Attach the QP-extractor prototypes to the shared native library."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        lib = load_native()
        if lib is None:
            return None
        try:
            lib.Mpeg2Qp_Create.restype = ctypes.c_void_p
            lib.Mpeg2Qp_Destroy.argtypes = [ctypes.c_void_p]
            lib.Mpeg2Qp_Parse.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.Mpeg2Qp_Parse.restype = ctypes.c_int
        except AttributeError:  # stale .so without the QP entry points
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class QpResult:
    __slots__ = ("qp", "dc", "coding_type", "picture_structure",
                 "temporal_reference", "slices_ok", "slices_fallback")

    def __init__(self, qp, dc, coding_type, picture_structure,
                 temporal_reference, slices_ok, slices_fallback):
        self.qp = qp  # [mb_h, mb_w] uint8 quantiser_scale
        self.dc = dc  # [mb_h, mb_w] int16 mean intra luma DC differential
        self.coding_type = coding_type  # 1 I, 2 P, 3 B
        self.picture_structure = picture_structure  # 1 top, 2 bottom, 3 frame
        self.temporal_reference = temporal_reference
        self.slices_ok = slices_ok
        self.slices_fallback = slices_fallback


_MAX_MBS = 36864  # up to 4096x2304 (256x144 macroblocks)


class NativeQpExtractor:
    """Full macroblock-layer extractor backed by the C++ engine."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native QP extractor unavailable")
        self._lib = lib
        self._h = lib.Mpeg2Qp_Create()
        self._qp = (ctypes.c_uint8 * _MAX_MBS)()
        self._dc = (ctypes.c_int16 * _MAX_MBS)()
        self._info = (ctypes.c_int * 8)()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.Mpeg2Qp_Destroy(self._h)
                self._h = None
        except (AttributeError, TypeError):
            pass

    def parse_picture(self, es: bytes) -> QpResult | None:
        """es: one coded picture's ES bytes (with any preceding sequence/
        GOP headers attached)."""
        es = bytes(es)
        n = self._lib.Mpeg2Qp_Parse(self._h, es, len(es), self._qp,
                                    self._dc, self._info, _MAX_MBS)
        if n <= 0:
            return None
        mw, mh = self._info[0], self._info[1]
        qp = np.ctypeslib.as_array(self._qp)[:n].reshape(mh, mw).copy()
        dc = np.ctypeslib.as_array(self._dc)[:n].reshape(mh, mw).copy()
        return QpResult(qp, dc, self._info[2], self._info[3], self._info[4],
                        self._info[5], self._info[6])


class SliceQpExtractor:
    """Header-only fallback: slice quantiser_scale per MB row (no VLC)."""

    def __init__(self):
        self._seq = None  # (width, height) retained across pictures

    def parse_picture(self, es: bytes) -> QpResult | None:
        from ..utils.bits import BitReader, EOFError_

        es = bytes(es)
        width, height = self._seq if self._seq else (None, None)
        q_scale_type = False
        coding_type = 0
        structure = 3
        tref = 0
        rows = {}
        i = 0
        n = len(es)
        saw_picture = False
        while i + 4 <= n:
            if not (es[i] == 0 and es[i + 1] == 0 and es[i + 2] == 1):
                i = es.find(b"\x00\x00\x01", i)  # C-speed resync
                if i == -1 or i + 4 > n:
                    break
                continue
            code = es[i + 3]
            r = BitReader(es, (i + 4) * 8)
            try:
                if code == 0xB3:
                    width = r.read(12)
                    height = r.read(12)
                    self._seq = (width, height)
                elif code == 0xB5:
                    ext = r.read(4)
                    if ext == 1:  # sequence extension
                        r.skip(8 + 1 + 2)
                        if width is not None:
                            width |= r.read(2) << 12
                            height |= r.read(2) << 12
                            self._seq = (width, height)
                    elif ext == 8:  # picture coding extension
                        r.skip(16 + 2)
                        structure = r.read(2)
                        r.skip(3)
                        q_scale_type = bool(r.read(1))
                elif code == 0x00:
                    if saw_picture:
                        break
                    saw_picture = True
                    tref = r.read(10)
                    coding_type = r.read(3)
                elif 0x01 <= code <= 0xAF and saw_picture and width:
                    row = code - 1
                    if height and height > 2800:
                        row += r.read(3) << 7
                    qsc = r.read(5)
                    qs = (NONLINEAR_QSCALE[qsc] if q_scale_type
                          else qsc * 2)
                    rows[row] = qs
            except (EOFError_, IndexError):
                pass
            i += 4
        if not saw_picture or not width or not rows:
            return None
        mw = (width + 15) // 16
        fh = height if structure == 3 else height // 2
        mh = (fh + 15) // 16
        qp = np.zeros((mh, mw), np.uint8)
        last = None
        for row in range(mh):
            if row in rows:
                last = rows[row]
            if last is not None:
                qp[row, :] = last
        # fill leading rows from the first known one
        first = next((rows[r] for r in sorted(rows)), 0)
        for row in range(mh):
            if qp[row, 0] == 0:
                qp[row, :] = first
        return QpResult(qp, np.zeros((mh, mw), np.int16), coding_type,
                        structure, tref, 0, len(rows))


def make_extractor():
    """Fastest available extractor: native full-MB parse, else slice-level."""
    if native_available():
        return NativeQpExtractor()
    return SliceQpExtractor()


def iter_picture_chunks(es: bytes):
    """Split an ES byte stream into per-coded-picture chunks, each with its
    preceding sequence/GOP/extension headers attached (the unit
    Mpeg2Qp_Parse consumes)."""
    es = bytes(es)
    n = len(es)
    starts = []  # (offset, code)
    # bytes.find runs at C speed — a per-byte Python loop here costs
    # more than the native decode of the pictures being split
    i = es.find(b"\x00\x00\x01")
    while i != -1 and i + 4 <= n:
        starts.append((i, es[i + 3]))
        i = es.find(b"\x00\x00\x01", i + 4)
    pic_indices = [k for k, (_, c) in enumerate(starts) if c == 0x00]
    for pi, k in enumerate(pic_indices):
        # attach leading headers back to the previous slice/picture end
        lead = k
        while lead > 0 and starts[lead - 1][1] in (0xB3, 0xB5, 0xB8):
            lead -= 1
        begin = starts[lead][0]
        end = starts[pic_indices[pi + 1]][0] if pi + 1 < len(pic_indices) \
            else n
        # trim trailing headers that belong to the NEXT picture
        kk = pic_indices[pi + 1] - 1 if pi + 1 < len(pic_indices) else None
        if kk is not None:
            while kk > k and starts[kk][1] in (0xB3, 0xB5, 0xB8):
                end = starts[kk][0]
                kk -= 1
        yield es[begin:end]


def _pes_payload_start(data: bytes, i: int, end: int) -> int:
    """Offset of the PES payload for a packet whose header starts at
    i (the 00 00 01 sid position). Handles both header flavours:
    MPEG-2 PES ('10' marker in the flags byte) and MPEG-1 PES
    (stuffing FFs, optional STD, PTS/DTS markers)."""
    p = i + 6
    if p >= end:
        return end
    if (data[p] >> 6) == 0b10:  # MPEG-2: flags + header_data_length
        if i + 9 > end:
            return end
        return min(i + 9 + data[i + 8], end)
    # MPEG-1 (ISO 11172-1 2.4.3.3)
    while p < end and data[p] == 0xFF:  # stuffing
        p += 1
    if p < end and (data[p] >> 6) == 0b01:  # STD buffer fields
        p += 2
    if p >= end:
        return end
    top = data[p] >> 4
    if top == 0b0010:  # PTS only
        p += 5
    elif top == 0b0011:  # PTS + DTS
        p += 10
    else:  # '0000 1111' no timestamps
        p += 1
    return min(p, end)


def extract_ps_video_es(data: bytes, return_consumed: bool = False):
    """Pull the video elementary stream out of an MPEG program/system
    stream (the i{n}.mpg intermediate written by io.ps_writer, but also
    MPEG-1 system streams such as FFmpeg's 'mpeg' muxer output).

    With return_consumed, returns (es_bytes, consumed_offset): bytes past
    consumed_offset belong to an incomplete trailing packet and must be
    re-fed with the next chunk (streaming use)."""
    out = bytearray()
    i = 0
    consumed = 0
    n = len(data)
    while i + 4 <= n:
        if not (data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1):
            nxt = data.find(b"\x00\x00\x01", i)  # C-speed resync
            if nxt == -1 or nxt + 4 > n:
                # keep up to 3 tail bytes: a start code may straddle
                # the chunk boundary (same retention as the byte loop)
                consumed = max(consumed, max(i, n - 3))
                break
            i = nxt
            consumed = i
            continue
        code = data[i + 3]
        if code == 0xBA:  # pack header
            if i + 5 > n:
                break
            if (data[i + 4] >> 6) == 0b01:  # MPEG-2: 14 bytes + stuffing
                if i + 14 > n:
                    break
                stuffing = data[i + 13] & 7
                i += 14 + stuffing
            else:  # MPEG-1 ('0010' marker): fixed 12 bytes
                if i + 12 > n:
                    break
                i += 12
            consumed = min(i, n)
        elif code == 0xB9:  # program end
            i += 4
            consumed = i
        elif code in (0xBB, 0xBC) or 0xBD <= code <= 0xFF:
            if i + 6 > n:
                break
            length = (data[i + 4] << 8) | data[i + 5]
            end = i + 6 + length
            if end > n:
                break  # incomplete trailing packet
            if 0xE0 <= code <= 0xEF:  # video PES
                payload = _pes_payload_start(data, i, end)
                out += data[payload:end]
            i = end
            consumed = i
        else:
            i += 4
            consumed = i
    if return_consumed:
        return bytes(out), consumed
    return bytes(out)


def iter_picture_chunks_stream(es_iter):
    """Streaming per-picture chunker over an iterator of ES byte
    chunks: bounded memory, one picture held at a time. The single
    home of the tail-retention logic (a picture may continue into the
    next chunk)."""
    buf = b""
    for data in es_iter:
        buf += data
        chunks = list(iter_picture_chunks(buf))
        if len(chunks) > 1:
            tail_start = len(buf) - len(chunks[-1])
            yield from chunks[:-1]
            buf = buf[tail_start:]
    yield from iter_picture_chunks(buf)


def iter_picture_chunks_file(path: str, is_ps: bool = True,
                             read_chunk: int = 8 << 20,
                             start_offset: int = 0):
    """Streaming per-picture chunker over an intermediate file (PS or
    raw ES). Shared by the QP-map source and the in-build video
    decoder. `start_offset` byte-seeks before parsing (keyframe random
    access, ref AMTSource's AVSEEK_FLAG_BYTE seek): the PS/ES scanners
    resynchronise on the next start code."""

    def es_chunks():
        ps_tail = b""
        with open(path, "rb") as f:
            if start_offset:
                f.seek(start_offset)
            while True:
                data = f.read(read_chunk)
                if not data:
                    break
                if is_ps:
                    es, consumed = extract_ps_video_es(
                        ps_tail + data, return_consumed=True)
                    ps_tail = (ps_tail + data)[consumed:]
                    yield es
                else:
                    yield data
        if is_ps and ps_tail:
            yield extract_ps_video_es(ps_tail)

    yield from iter_picture_chunks_stream(es_chunks())


class QpMapSource:
    """Display-order per-frame QP maps for one intermediate video file.

    Parses the PS/ES once with the best available extractor, pairs field
    pictures, and applies the standard MPEG2 reorder rule (B pictures
    emit immediately, I/P pictures emit the previously held reference)."""

    def __init__(self, ps_or_es: bytes, is_ps: bool = True):
        es = extract_ps_video_es(ps_or_es) if is_ps else bytes(ps_or_es)
        self._build(iter_picture_chunks(es))

    @classmethod
    def from_file(cls, path: str, is_ps: bool = True,
                  read_chunk: int = 8 << 20) -> "QpMapSource":
        """Streaming constructor: parses the intermediate file in bounded
        chunks (files can be GBs; only one picture is held at a time)."""
        out = cls.__new__(cls)
        out._build(iter_picture_chunks_file(path, is_ps, read_chunk))
        return out

    @classmethod
    def from_maps(cls, maps) -> "QpMapSource":
        """A source of display-order [mb_h, mb_w] maps (uint8 quantiser
        scales) that the caller has, one per frame."""
        out = cls.__new__(cls)
        out.results = [QpResult(np.asarray(m), None, 0, 3, i, 1, 0)
                       for i, m in enumerate(maps)]
        out.full_parse = True
        out.slices_ok = len(out.results)
        out.slices_fallback = 0
        return out

    def _build(self, chunks) -> None:
        ex = make_extractor()
        # slice-level extractor reports everything as fallback by design;
        # parse-health stats are only meaningful for the full-MB parser
        self.full_parse = isinstance(ex, NativeQpExtractor)
        coded = []  # frame-level results in coded order
        pending_field = None
        for chunk in chunks:
            res = ex.parse_picture(chunk)
            if res is None:
                continue
            if res.picture_structure in (1, 2):
                if pending_field is None:
                    pending_field = res
                    continue
                # weave the two field maps row-interleaved; a mismatched
                # pair still gets expanded to frame height so every map in
                # `results` has the same geometry (deblock_qp batches them)
                a, b = pending_field, res
                qp = np.repeat(a.qp, 2, axis=0)
                if a.qp.shape == b.qp.shape:
                    qp[1::2] = b.qp
                a.qp = qp
                coded.append(a)
                pending_field = None
            else:
                coded.append(res)
        if pending_field is not None:
            # trailing unpaired field: expand to frame height
            pending_field.qp = np.repeat(pending_field.qp, 2, axis=0)
            coded.append(pending_field)
        # decode order -> display order
        display = []
        held = None
        for res in coded:
            if res.coding_type == 3:  # B: output immediately
                display.append(res)
            else:  # I/P: output the held reference first
                if held is not None:
                    display.append(held)
                held = res
        if held is not None:
            display.append(held)
        self.results = display
        # aggregate parse health (a high fallback share on intra slices
        # would indicate a DCT-table defect; see mpeg2_tables notes)
        self.slices_ok = sum(r.slices_ok for r in display)
        self.slices_fallback = sum(r.slices_fallback for r in display)

    def __len__(self) -> int:
        return len(self.results)

    def select(self, indices) -> "QpMapSource":
        """Restrict to the given display-order frame indices (the encode
        file's video_frames selection), clamping out-of-range."""
        out = QpMapSource.__new__(QpMapSource)
        n = len(self.results)
        out.results = [self.results[min(i, n - 1)] for i in indices] \
            if n else []
        out.full_parse = getattr(self, "full_parse", True)
        out.slices_ok = self.slices_ok
        out.slices_fallback = self.slices_fallback
        return out

    def maps(self, start: int, count: int) -> np.ndarray | None:
        """[count, mb_h, mb_w] float32 QP maps for display frames
        [start, start+count), repeating edge frames when out of range."""
        return self.maps_for(range(start, start + count))

    def maps_for(self, indices) -> np.ndarray | None:
        """[len(indices), mb_h, mb_w] float32 QP maps, clamped."""
        if not self.results:
            return None
        n = len(self.results)
        sel = [self.results[min(max(i, 0), n - 1)].qp for i in indices]
        if not sel:
            return None
        shape = sel[0].shape
        if any(q.shape != shape for q in sel):
            sel = [q if q.shape == shape else
                   np.full(shape, int(np.median(q)) or 8, np.uint8)
                   for q in sel]
        return np.stack(sel).astype(np.float32)


def qp_map_source_from_avdec(path: str) -> "QpMapSource | None":
    """QP maps via FFmpeg's per-block video-enc-params export (the
    modern form of the patched av_frame_get_qp_table the reference
    uses, AMTSource.hpp:371-404). Covers codecs the ES-layer extractor
    does not (H.264); returns None when the bridge or the codec's
    export is unavailable. QP values are passed through in the codec's
    own scale, exactly like the reference's frame props."""
    try:
        from ..video.avdec import avdec_available, decode_with_qp
    except Exception:  # noqa: BLE001
        return None
    if not avdec_available():
        return None
    results = []
    try:
        for i, (y, u, v, qp) in enumerate(decode_with_qp(path)):
            h, w = y.shape
            mbw, mbh = (w + 15) // 16, (h + 15) // 16
            grid = np.full((mbh, mbw), 26, np.uint8)
            ok = 0
            if len(qp):
                xs = np.clip(qp[:, 0] // 16, 0, mbw - 1)
                ys = np.clip(qp[:, 1] // 16, 0, mbh - 1)
                grid[ys, xs] = np.clip(qp[:, 2], 1, 255).astype(np.uint8)
                ok = 1
            results.append(QpResult(grid, None, 0, 3, i, ok, 1 - ok))
    except RuntimeError:
        return None
    if not results or not any(r.slices_ok for r in results):
        return None
    out = QpMapSource.__new__(QpMapSource)
    out.results = results
    out.full_parse = True
    out.slices_ok = sum(r.slices_ok for r in results)
    out.slices_fallback = sum(r.slices_fallback for r in results)
    return out
