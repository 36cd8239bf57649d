"""ADTS AAC frame parser, PTS interpolation, and dual-mono splitter.

Parity: AdtsParser / DualMonoSplitter in the reference
(Amatsukaze/AdtsParser.hpp:31-540): syncword scan with carry-over buffering,
header parse, channel layout from channel_configuration or the canonical
syntax-element map (incl. 22.2ch), PTS interpolation across PES boundaries,
and the bit-exact dual-mono split (header rewrite + raw element bit copy).

The reference decodes to PCM via its libfaad fork; here PCM decoding is a
pluggable ``AacDecoder``. When none is supplied, frames still carry exact
sample counts / formats / PTS (enough for the timeline + reform layers) but
``decoded_data`` is empty.

The port's copy of amatsukaze_tpu/ts/adts.py.
"""

from __future__ import annotations

from ..types import AudioChannels, AudioFormat, AudioFrameData
from ..utils.bits import BitReader, BitWriter, EOFError_
from ..utils.context import ErrorCounter

# syntax element ids (ISO 13818-7 / 14496-3)
ID_SCE = 0x0
ID_CPE = 0x1
ID_CCE = 0x2
ID_LFE = 0x3
ID_DSE = 0x4
ID_PCE = 0x5
ID_FIL = 0x6
ID_END = 0x7

SAMPLE_RATES = {
    0: 96000, 1: 88200, 2: 64000, 3: 48000, 4: 44100, 5: 32000,
    6: 24000, 7: 22050, 8: 16000, 9: 12000, 0xA: 11025, 0xB: 8000,
}

SAMPLES_PER_BLOCK = 1024  # AAC-LC frame length per channel


class AdtsHeader:
    """Fixed+variable ADTS header (ref AdtsParser.hpp:31-106)."""

    def parse(self, data) -> bool:
        if len(data) < 7:
            return False
        r = BitReader(data)
        try:
            if r.read(12) != 0xFFF:
                return False
            # ID bit: 1 = MPEG-2 style (broadcast), 0 = MPEG-4 — both
            # carry identical AAC payloads; libfaad/FFmpeg accept either
            self.mpeg2_id = r.read(1)
            if r.read(2) != 0:  # layer
                return False
            self.protection_absent = r.read(1)
            self.profile = r.read(2)
            self.sampling_frequency_index = r.read(4)
            if self.sampling_frequency_index >= 12:
                # 13-15 are reserved (a corrupted-bit sync mimic —
                # propagating sample_rate 0 into PTS math crashed, found
                # by stream soak); 12 (7350 Hz) is spec-valid but no
                # decoder in the stack carries its tables (nor does the
                # reference's libfaad path ever see it: broadcasts don't
                # use 7350 Hz) — accepting the header would produce a
                # silently PCM-less audio track, so resync instead.
                return False
            r.read(1)  # private
            self.channel_configuration = r.read(3)
            r.read(2)  # original/copy + home
            r.read(2)  # copyright id bit/start
            self.frame_length = r.read(13)
            r.read(11)  # buffer fullness
            self.number_of_raw_data_blocks_in_frame = r.read(2)
            self.num_bytes_read = (r.pos + 7) // 8
            if self.frame_length < self.num_bytes_read:
                return False
        except EOFError_:
            return False
        return True

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATES.get(self.sampling_frequency_index, 0)

    @property
    def header_bytes(self) -> int:
        return 7 if self.protection_absent else 9


_CHANNEL_CONFIG_MAP = {
    1: AudioChannels.MONO,
    2: AudioChannels.STEREO,
    3: AudioChannels.CH_30,
    4: AudioChannels.CH_31,
    5: AudioChannels.CH_32,
    6: AudioChannels.CH_32_LFE,
    7: AudioChannels.CH_52_LFE,
}


def make_channels_map() -> dict:
    """Canonical element-sequence -> layout (ref AdtsParser.hpp:352-424)."""
    table = [
        (AudioChannels.CH_21, [ID_CPE, ID_SCE]),
        (AudioChannels.CH_22, [ID_CPE, ID_CPE]),
        (AudioChannels.CH_2LANG, [ID_SCE, ID_SCE]),
        (AudioChannels.CH_33_LFE, [ID_SCE, ID_CPE, ID_CPE, ID_SCE, ID_LFE]),
        (AudioChannels.CH_2_22_LFE, [ID_CPE, ID_CPE, ID_LFE, ID_CPE]),
        (AudioChannels.CH_322_LFE, [ID_SCE, ID_CPE, ID_CPE, ID_CPE, ID_LFE]),
        (AudioChannels.CH_2_32_LFE, [ID_SCE, ID_CPE, ID_CPE, ID_LFE, ID_CPE]),
        (
            AudioChannels.CH_2_323_2LFE,
            [ID_SCE, ID_CPE, ID_CPE, ID_CPE, ID_SCE, ID_LFE, ID_LFE, ID_CPE],
        ),
        (
            AudioChannels.CH_333_523_3_2LFE,
            [ID_SCE, ID_CPE, ID_CPE, ID_CPE, ID_CPE, ID_SCE, ID_LFE, ID_LFE,
             ID_SCE, ID_CPE, ID_CPE, ID_SCE, ID_CPE, ID_SCE, ID_SCE, ID_CPE],
        ),
    ]
    return {canonical_elements(elems): ch for ch, elems in table}


def canonical_elements(elems) -> int:
    c = -1
    for e in elems[:20]:
        c = (c << 3) | e
    return c


CHANNELS_MAP = make_channels_map()


class AacDecoder:
    """Pluggable PCM decoder interface (replaces the libfaad dependency)."""

    def decode(self, frame: bytes) -> "AacDecodeResult | None":
        raise NotImplementedError


class AacDecodeResult:
    __slots__ = ("pcm", "num_channels", "sample_rate", "elements", "element_bits")

    def __init__(self, pcm: bytes, num_channels: int, sample_rate: int,
                 elements=None, element_bits=None):
        self.pcm = pcm  # interleaved s16le (downmixed to 2ch like the ref)
        self.num_channels = num_channels
        self.sample_rate = sample_rate
        self.elements = elements or []  # syntax element ids
        self.element_bits = element_bits or []  # (start_bit, end_bit) per element


class AdtsParser:
    """Extract ADTS frames from PES payloads (ref AdtsParser.hpp:109-425)."""

    def __init__(self, ctx, decoder: AacDecoder | None = None):
        self.ctx = ctx
        self.decoder = decoder
        self._buf = bytearray()
        self._bytes_consumed = 0
        self._last_pts = -1
        self._sync_ok = False
        self._last_decoded_format = None

    def reset(self) -> None:
        pass

    def input_frame(self, frame, pts: int) -> list[AudioFrameData]:
        info: list[AudioFrameData] = []
        del self._buf[: self._bytes_consumed]
        if len(self._buf) >= (1 << 13):
            # frame_length is 13 bits; anything larger is garbage
            self._buf.clear()
        prev_size = len(self._buf)
        self._buf.extend(bytes(frame))
        data = bytes(self._buf)
        self._bytes_consumed = 0
        if len(data) < 7:
            return info

        if self._last_pts == -1 and pts >= 0:
            self._last_pts = pts
            pts = -1

        i = 0
        n = len(data)
        while i < n - 1:
            if data[i] != 0xFF or (data[i + 1] & 0xF0) != 0xF0:
                self._sync_ok = False
                i += 1
                continue
            header = AdtsHeader()
            if not (header.parse(data[i:]) and header.frame_length <= n - i):
                # incomplete frame: wait for the next packet if we were in sync
                if self._sync_ok:
                    break
                i += 1
                continue

            raw = data[i : i + header.frame_length]
            fd = self._make_frame(header, raw)
            duration = 90000 * fd.num_samples // fd.format.sample_rate

            if i < prev_size:
                # frame started in the previous PES packet: its PTS belongs
                # to the carried-over data, not this packet's stamp
                fd.pts = self._last_pts
                self._last_pts += duration
                if pts >= 0:
                    self._last_pts = pts
                    pts = -1
            else:
                if pts >= 0:
                    self._last_pts = pts
                    pts = -1
                fd.pts = self._last_pts
                self._last_pts += duration

            info.append(fd)
            i += header.frame_length
            self._bytes_consumed = i
            self._sync_ok = True

        return info

    def _make_frame(self, header: AdtsHeader, raw: bytes) -> AudioFrameData:
        nblocks = header.number_of_raw_data_blocks_in_frame + 1
        num_samples = SAMPLES_PER_BLOCK * nblocks
        sample_rate = header.sample_rate
        channels = _CHANNEL_CONFIG_MAP.get(header.channel_configuration, AudioChannels.NONE)
        pcm = b""
        if self.decoder is not None:
            res = self.decoder.decode(raw)
            if res is None:
                self.ctx.incr(ErrorCounter.DECODE_AUDIO)
                self.ctx.warn("audio frame decode failed")
                # keep the stream's decoded format stable across a corrupt
                # frame: with SBR/PS active the header says core-rate mono
                # while the stream is 2x-rate (and possibly stereo), and a
                # header-derived fallback would fire a spurious
                # format-change on every damaged frame
                cached = self._last_decoded_format
                if cached is not None and cached[0] == header.sample_rate:
                    _, sample_rate, num_samples, channels = cached
            else:
                pcm = res.pcm
                if res.sample_rate > sample_rate:
                    # HE-AAC: SBR doubles the output rate and sample count
                    # (the reference takes both from libfaad's frameInfo)
                    num_samples = num_samples * res.sample_rate // sample_rate
                    sample_rate = res.sample_rate
                if channels == AudioChannels.NONE and res.elements:
                    channels = CHANNELS_MAP.get(
                        canonical_elements(res.elements), AudioChannels.NONE
                    )
                if (res.num_channels == 2
                        and channels == AudioChannels.MONO):
                    # parametric stereo: one SCE decodes to two channels
                    channels = AudioChannels.STEREO
                self._last_decoded_format = (
                    header.sample_rate, sample_rate, num_samples, channels)
        return AudioFrameData(
            pts=-1,
            num_samples=num_samples,
            format=AudioFormat(channels=channels, sample_rate=sample_rate),
            coded_data=raw,
            decoded_data=pcm,
        )


class DualMonoSplitter:
    """Bit-exact split of 2xSCE dual-mono AAC into two mono ADTS streams
    (ref AdtsParser.hpp:428-540). Element bit positions come from the
    pluggable decoder (the reference patches libfaad to export them)."""

    def __init__(self, ctx, decoder: AacDecoder):
        self.ctx = ctx
        self.decoder = decoder

    def input_packet(self, frame: bytes) -> None:
        header = AdtsHeader()
        if not header.parse(frame):
            raise ValueError("[DualMonoSplitter] bad ADTS header")
        res = self.decoder.decode(bytes(frame))
        if res is None or len(res.element_bits) < 2:
            raise ValueError("[DualMonoSplitter] cannot locate dual-mono elements")
        if len(res.element_bits) != 2:
            raise ValueError(
                f"[DualMonoSplitter] element count {len(res.element_bits)} != 2"
            )
        for idx, (start_bits, end_bits) in enumerate(res.element_bits):
            w = BitWriter()
            frame_length = (end_bits - start_bits + 3 + 7) // 8 + 7
            w.write(0xFFF, 12)
            w.write(1, 1)  # ID
            w.write(0, 2)  # layer
            w.write(1, 1)  # protection_absent
            w.write(header.profile, 2)
            w.write(header.sampling_frequency_index, 4)
            w.write(0, 1)  # private
            w.write(1, 3)  # channel_configuration = mono
            w.write(0, 4)  # original/home/copyright bits
            w.write(frame_length, 13)
            w.write((1 << 11) - 1, 11)  # fullness: VBR
            w.write(0, 2)  # raw data blocks - 1
            r = BitReader(frame, start_bits)
            nbits = end_bits - start_bits
            full, rem = divmod(nbits, 32)
            for _ in range(full):
                w.write(r.read(32), 32)
            if rem:
                w.write(r.read(rem), rem)
            w.write(ID_END, 3)
            w.byte_align(fill=0)
            out = w.getvalue()
            if len(out) != frame_length:
                raise RuntimeError("[DualMonoSplitter] size mismatch")
            self.on_out_frame(idx, out)

    # -- override ---------------------------------------------------------------
    def on_out_frame(self, index: int, data: bytes) -> None:
        raise NotImplementedError
