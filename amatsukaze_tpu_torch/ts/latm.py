"""LOAS/LATM-framed MPEG-4 AAC (ISO/IEC 14496-3 sub 1, 1.7.3).

4K broadcast (ARIB STD-B32 part 2) carries AAC in LATM/LOAS under
stream_type 0x11 instead of ADTS under 0x0F. The reference's TS layer
accepts only 0x0F (Mpeg2TsParser.hpp isAudio) — LATM ingest goes beyond
parity. Strategy: demultiplex AudioSyncStream/AudioMuxElement here and
re-wrap the raw AAC payloads as ADTS so the whole existing audio chain
(AdtsParser, dual-mono split, the in-build AAC decoder, audio reform)
runs untouched.

Validated three ways in tests/test_latm.py: the fixture writer's LOAS
decodes in libavcodec's aac_latm; the rewrap decodes bit-identically to
the original ADTS through the in-build engine; and a 0x11-typed TS runs
the full pipeline.

The port's copy of amatsukaze_tpu/ts/latm.py.
"""

from __future__ import annotations

from ..utils.bits import BitReader, EOFError_

_SYNC = 0x2B7  # 11-bit AudioSyncStream syncword


class LatmError(ValueError):
    pass


def parse_audio_specific_config(r: BitReader) -> dict:
    """AudioSpecificConfig (1.6.2.1) — the subset ADTS can express.

    Returns the CORE coder config (for HE-AAC explicit signalling the
    ADTS rewrap carries the core LC layer; SBR stays implicit, which is
    how ADTS broadcast signals it anyway)."""
    def get_aot():
        aot = r.read(5)
        if aot == 31:
            aot = 32 + r.read(6)
        return aot

    aot = get_aot()
    sfi = r.read(4)
    if sfi == 0xF:
        r.read(24)  # explicit samplingFrequency
    chan = r.read(4)
    ext_sfi = -1
    if aot in (5, 29):  # explicit SBR/PS: read extension, then the core
        ext_sfi = r.read(4)
        if ext_sfi == 0xF:
            r.read(24)
        aot = get_aot()
        if aot == 22:
            raise LatmError("ER BSAC unsupported")
    if aot not in (1, 2, 3, 4):  # AAC main/LC/SSR/LTP fit ADTS profiles
        raise LatmError(f"unsupported audioObjectType {aot}")
    # GASpecificConfig (4.4.1)
    frame_len_flag = r.read(1)
    if frame_len_flag:
        raise LatmError("960-sample frames unsupported")
    if r.read(1):  # dependsOnCoreCoder
        r.read(14)
    ext_flag = r.read(1)
    if chan == 0:
        raise LatmError("PCE channel configs unsupported")
    if chan > 7:
        raise LatmError("channel config beyond ADTS range")
    if sfi == 0xF:
        raise LatmError("explicit sampling frequency unsupported")
    if ext_flag:
        raise LatmError("GASpecificConfig extension unsupported")
    return {"aot": aot, "sfi": sfi, "channels": chan, "ext_sfi": ext_sfi}


def adts_header(asc: dict, payload_len: int) -> bytes:
    """7-byte ADTS header (no CRC) for one raw_data_block."""
    profile = asc["aot"] - 1  # ADTS profile = AOT-1 (LC=1)
    length = 7 + payload_len
    b = bytearray(7)
    b[0] = 0xFF
    b[1] = 0xF1  # MPEG-4, layer 0, protection_absent
    b[2] = (profile << 6) | (asc["sfi"] << 2) | ((asc["channels"] >> 2) & 1)
    b[3] = ((asc["channels"] & 3) << 6) | ((length >> 11) & 3)
    b[4] = (length >> 3) & 0xFF
    b[5] = ((length & 7) << 5) | 0x1F  # buffer fullness 0x7FF
    b[6] = 0xFC
    return bytes(b)


class LatmToAdts:
    """Streaming LOAS AudioSyncStream -> ADTS rewrapper.

    Feed PES payload bytes (LOAS frames may span PES packets); get ADTS
    bytes out. The last in-band StreamMuxConfig is retained for frames
    sent with useSameStreamMux."""

    def __init__(self):
        self._pend = b""
        self._asc: dict | None = None
        self.errors = 0

    def feed(self, data: bytes) -> bytes:
        buf = self._pend + bytes(data)
        out = bytearray()
        pos = 0
        n = len(buf)
        while True:
            # resync to the 11-bit 0x2B7 syncword at a byte boundary
            start = -1
            i = pos
            while i + 3 <= n:
                if buf[i] == 0x56 and (buf[i + 1] & 0xE0) == 0xE0:
                    start = i
                    break
                i += 1
            if start < 0:
                self._pend = buf[max(pos, n - 2):]
                return bytes(out)
            length = ((buf[start + 1] & 0x1F) << 8) | buf[start + 2]
            end = start + 3 + length
            if end > n:
                self._pend = buf[start:]
                return bytes(out)
            try:
                out += self._mux_element(buf[start + 3:end])
            except (LatmError, EOFError_, IndexError):
                self.errors += 1
            pos = end

    def _mux_element(self, payload: bytes) -> bytes:
        """AudioMuxElement(muxConfigPresent=1) (1.7.3.1)."""
        r = BitReader(payload)
        if not r.read(1):  # useSameStreamMux == 0: StreamMuxConfig inline
            self._parse_smc(r)
        if self._asc is None:
            raise LatmError("no StreamMuxConfig yet")
        out = bytearray()
        for _ in range(self._num_sub_frames + 1):
            # PayloadLengthInfo (frameLengthType 0)
            ln = 0
            while True:
                tmp = r.read(8)
                ln += tmp
                if tmp != 255:
                    break
            if not r.is_byte_aligned():
                # payloads are bit-packed; gather byte-by-byte
                frame = bytes(r.read(8) for _ in range(ln))
            else:
                p0 = r.byte_pos()
                frame = bytes(payload[p0:p0 + ln])
                r.skip(8 * ln)
            out += adts_header(self._asc, len(frame)) + frame
        return bytes(out)

    def _parse_smc(self, r: BitReader) -> None:
        """StreamMuxConfig (1.7.3.2), single program/layer. State is
        applied only after the whole config validates: a rejected SMC
        must not leave later useSameStreamMux frames half-configured."""
        if r.read(1):  # audioMuxVersion
            raise LatmError("audioMuxVersion 1 unsupported")
        if not r.read(1):  # allStreamsSameTimeFraming
            raise LatmError("per-stream time framing unsupported")
        num_sub = r.read(6)
        if r.read(4):  # numProgram
            raise LatmError("multi-program LATM unsupported")
        if r.read(3):  # numLayer
            raise LatmError("multi-layer LATM unsupported")
        asc = parse_audio_specific_config(r)
        flt = r.read(3)  # frameLengthType
        if flt != 0:
            raise LatmError(f"frameLengthType {flt} unsupported")
        r.read(8)  # latmBufferFullness
        if r.read(1):  # otherDataPresent
            # otherDataLenBits as escaped 8-bit chunks
            while True:
                esc = r.read(1)
                r.read(8)
                if not esc:
                    break
        if r.read(1):  # crcCheckPresent
            r.read(8)
        self._asc = asc
        self._num_sub_frames = num_sub
