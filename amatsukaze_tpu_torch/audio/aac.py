"""In-build AAC-LC decoder (replaces the reference's vendored libfaad).

Scope: MPEG-2/MPEG-4 AAC-LC ADTS frames as used by Japanese broadcast —
SCE/CPE/LFE elements, long/start/short/stop window sequences, sine + KBD
windows, TNS, M/S and intensity stereo, pulse data. Outputs interleaved
int16 PCM plus the per-element bit ranges the dual-mono splitter needs
(the reference patches libfaad to export element_start/element_end,
AdtsParser.hpp:465-467; here it is native).

Syntax per ISO/IEC 14496-3 subpart 4; huffman/SWB constants live in
aac_tables (normative spec data).

The port's copy of amatsukaze_tpu/audio/aac.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ts.adts import AacDecodeResult, AacDecoder, AdtsHeader
from ..utils.bits import BitReader, EOFError_
from . import aac_tables as T

ONLY_LONG = 0
LONG_START = 1
EIGHT_SHORT = 2
LONG_STOP = 3

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)

ZERO_HCB = 0
FIRST_PAIR_HCB = 5
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15

# (long, short) TNS sfb limits per sample-rate index for Main/LC
# (ISO/IEC 13818-7 Table 8.9)
TNS_MAX_SFB = [
    (31, 9), (31, 9), (34, 10), (40, 14), (42, 14), (51, 14),
    (46, 14), (46, 14), (42, 14), (42, 14), (42, 14), (39, 14),
]
SAMPLE_RATES = [96000, 88200, 64000, 48000, 44100, 32000,
                24000, 22050, 16000, 12000, 11025, 8000]


# ---------------------------------------------------------------------------
# huffman decode (incremental dict lookup per code length)
# ---------------------------------------------------------------------------

def _build(book):
    m = {}
    for length, code, vals in book:
        m[(length, code)] = vals
    return m

_BOOKS = {
    1: _build(T.HCB_1), 2: _build(T.HCB_2), 3: _build(T.HCB_3),
    4: _build(T.HCB_4), 5: _build(T.HCB_5), 6: _build(T.HCB_6),
    7: _build(T.HCB_7), 8: _build(T.HCB_8), 9: _build(T.HCB_9),
    10: _build(T.HCB_10), 11: _build(T.HCB_11),
}
_SF_BOOK = _build(T.HCB_SF)
_MAXLEN = {cb: max(L for L, _, _ in book) for cb, book in
           [(1, T.HCB_1), (2, T.HCB_2), (3, T.HCB_3), (4, T.HCB_4),
            (5, T.HCB_5), (6, T.HCB_6), (7, T.HCB_7), (8, T.HCB_8),
            (9, T.HCB_9), (10, T.HCB_10), (11, T.HCB_11)]}
_SF_MAXLEN = max(L for L, _, _ in T.HCB_SF)

QUAD_BOOKS = {1, 2, 3, 4}
SIGNED_BOOKS = {1, 2, 5, 6}


_LUT8: dict[int, list] = {}


def _make_lut8(table) -> list:
    """First-level 8-bit LUT: lut[word8] = (vals, length) for codes with
    length <= 8 (the overwhelmingly common case), None otherwise."""
    lut = [None] * 256
    for (length, code), vals in table.items():
        if length <= 8:
            base = code << (8 - length)
            for pad in range(1 << (8 - length)):
                lut[base | pad] = (vals, length)
    return lut


def _huff(r: BitReader, table, maxlen) -> tuple:
    lut = _LUT8.get(id(table))
    if lut is None:
        lut = _LUT8[id(table)] = _make_lut8(table)
    avail = min(maxlen, len(r.data) * 8 - r.pos)
    word = r.peek(avail)
    if avail >= 8:
        hit = lut[word >> (avail - 8)]
        if hit is not None:
            vals, length = hit
            r.pos += length
            return vals
        start = 9
    else:
        start = 1
    get = table.get
    for length in range(start, avail + 1):
        v = get((length, word >> (avail - length)))
        if v is not None:
            r.pos += length
            return v
    raise ValueError("invalid huffman code")


def _sf_huff(r: BitReader) -> int:
    return _huff(r, _SF_BOOK, _SF_MAXLEN)[0]


# ---------------------------------------------------------------------------
# windows / IMDCT
# ---------------------------------------------------------------------------

def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    half = n // 2
    j = np.arange(half + 1)
    arg = np.pi * alpha * np.sqrt(np.clip(1.0 - (2.0 * j / half - 1.0) ** 2,
                                          0.0, 1.0))
    v = np.i0(arg)
    cum = np.cumsum(v)
    left = np.sqrt(cum[:half] / cum[half])
    return np.concatenate([left, left[::-1]])


def imdct_matrix(n: int) -> np.ndarray:
    """Direct O(N^2) IMDCT (definition; kept for validation)."""
    k = np.arange(n // 2)
    t = np.arange(n)
    n0 = (n / 2 + 1) / 2
    return (2.0 / n) * np.cos(2.0 * np.pi / n * np.outer(t + n0, k + 0.5))


class _Transforms:
    """FFT-based IMDCT + windows for one frame size (built lazily).

    The IMDCT reduces to a DCT-IV (x[n] = (2/N) D[n + M/2] with the
    even/odd symmetry extensions) computed via a 2M-point FFT with pre/post
    twiddles — machine-precision equal to the direct matrix."""

    _cache: dict[int, "_Transforms"] = {}

    def __init__(self, n_long: int = 2048):
        self._tw = {}
        for n in (n_long, n_long // 8):
            m = n // 2
            pre = np.exp(-1j * np.pi * np.arange(m) / (2 * m))
            post = np.exp(-1j * np.pi * (2 * np.arange(m) + 1) / (4 * m))
            idx = np.arange(n) + m // 2
            sel_b = (idx >= m) & (idx < 2 * m)
            sel_c = idx >= 2 * m
            gather = idx.copy()
            gather[sel_b] = 2 * m - 1 - idx[sel_b]
            gather[sel_c] = idx[sel_c] - 2 * m
            sign = np.ones(n)
            sign[sel_b | sel_c] = -1.0
            self._tw[n] = (pre, post, gather, sign * (2.0 / n))
        self.win = {
            (n_long, 0): _sine_window(n_long),
            (n_long, 1): _kbd_window(n_long, 4.0),
            (n_long // 8, 0): _sine_window(n_long // 8),
            (n_long // 8, 1): _kbd_window(n_long // 8, 6.0),
        }

    def imdct(self, spec: np.ndarray, n: int) -> np.ndarray:
        pre, post, gather, scale = self._tw[n]
        m = n // 2
        buf = np.zeros(2 * m, np.complex128)
        buf[:m] = spec * pre
        d = np.real(post * np.fft.fft(buf)[:m])
        return d[gather] * scale

    @classmethod
    def get(cls, n_long: int = 2048) -> "_Transforms":
        if n_long not in cls._cache:
            cls._cache[n_long] = cls(n_long)
        return cls._cache[n_long]


# ---------------------------------------------------------------------------
# per-channel stream state
# ---------------------------------------------------------------------------

@dataclass
class ICSInfo:
    window_sequence: int = ONLY_LONG
    window_shape: int = 0
    max_sfb: int = 0
    scale_factor_grouping: int = 0
    num_window_groups: int = 1
    group_lens: list = field(default_factory=lambda: [1])
    num_windows: int = 1
    swb_offset: list = field(default_factory=list)
    num_swb: int = 0


@dataclass
class ChannelData:
    ics: ICSInfo = None
    global_gain: int = 0
    sect_cb: list = None  # per group: list of cb per sfb
    scale_factors: list = None  # per group: per sfb
    spec: np.ndarray = None  # [num_windows, 128] or [1, 1024] dequantized
    quant: list = None  # grouped quantized coeffs (for pulse)
    tns: dict = None
    pulse: dict = None


class AacLcDecoder(AacDecoder):
    """ADTS AAC-LC frame decoder. decode(frame_bytes) -> DecodeResult."""

    def __init__(self, frame_length: int = 1024, enable_sbr: bool = True):
        self.n_long = 2 * frame_length
        self.tr = _Transforms.get(self.n_long)
        self.overlap: dict[int, np.ndarray] = {}  # per output channel
        self.prev_shape: dict[int, int] = {}
        # SBR decoders keyed by (element id, per-frame element ordinal);
        # populated lazily when an SBR fill element follows an SCE/CPE
        self.enable_sbr = enable_sbr
        self.sbr: dict = {}
        self.sbr_active = False

    # -------------------------------------------------------------- syntax
    def _ics_info(self, r: BitReader, sr_index: int) -> ICSInfo:
        ics = ICSInfo()
        r.read(1)  # ics_reserved_bit
        ics.window_sequence = r.read(2)
        ics.window_shape = r.read(1)
        if ics.window_sequence == EIGHT_SHORT:
            ics.max_sfb = r.read(4)
            ics.scale_factor_grouping = r.read(7)
            ics.num_windows = 8
            ics.group_lens = [1]
            for b in range(6, -1, -1):
                if (ics.scale_factor_grouping >> b) & 1:
                    ics.group_lens[-1] += 1
                else:
                    ics.group_lens.append(1)
            ics.num_window_groups = len(ics.group_lens)
            ics.swb_offset = T.SWB_OFFSETS[(self.n_long // 16,
                                            SAMPLE_RATES[sr_index])]
        else:
            ics.max_sfb = r.read(6)
            if r.read(1):  # predictor_data_present: illegal for LC
                raise ValueError("predictor data in an LC stream")
            ics.num_windows = 1
            ics.num_window_groups = 1
            ics.group_lens = [1]
            ics.swb_offset = T.SWB_OFFSETS[(self.n_long // 2,
                                            SAMPLE_RATES[sr_index])]
        ics.num_swb = len(ics.swb_offset) - 1
        if ics.max_sfb > ics.num_swb:
            raise ValueError("max_sfb > num_swb")
        return ics

    def _section_data(self, r: BitReader, ics: ICSInfo) -> list:
        bits = 3 if ics.window_sequence == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        out = []
        for _ in range(ics.num_window_groups):
            cbs = [ZERO_HCB] * ics.max_sfb
            k = 0
            while k < ics.max_sfb:
                cb = r.read(4)
                length = 0
                while True:
                    inc = r.read(bits)
                    length += inc
                    if inc != esc:
                        break
                if k + length > ics.max_sfb:
                    raise ValueError("section overruns max_sfb")
                for sfb in range(k, k + length):
                    cbs[sfb] = cb
                k += length
            out.append(cbs)
        return out

    def _scale_factors(self, r: BitReader, ch: ChannelData) -> list:
        sf = ch.global_gain
        is_pos = 0
        noise_nrg = ch.global_gain - 90
        noise_first = True
        out = []
        for g in range(ch.ics.num_window_groups):
            sfs = [0] * ch.ics.max_sfb
            for sfb in range(ch.ics.max_sfb):
                cb = ch.sect_cb[g][sfb]
                if cb == ZERO_HCB:
                    continue
                if cb in (INTENSITY_HCB, INTENSITY_HCB2):
                    is_pos += _sf_huff(r) - 60
                    sfs[sfb] = is_pos
                elif cb == NOISE_HCB:
                    if noise_first:
                        noise_nrg += r.read(9) - 256
                        noise_first = False
                    else:
                        noise_nrg += _sf_huff(r) - 60
                    sfs[sfb] = noise_nrg
                else:
                    sf += _sf_huff(r) - 60
                    sfs[sfb] = sf
            out.append(sfs)
        return out

    def _pulse_data(self, r: BitReader) -> dict:
        n = r.read(2) + 1
        start_sfb = r.read(6)
        offsets = []
        amps = []
        for _ in range(n):
            offsets.append(r.read(5))
            amps.append(r.read(4))
        return {"start_sfb": start_sfb, "offsets": offsets, "amps": amps}

    def _tns_data(self, r: BitReader, ics: ICSInfo) -> dict:
        short = ics.window_sequence == EIGHT_SHORT
        n_filt_bits = 1 if short else 2
        len_bits = 4 if short else 6
        order_bits = 3 if short else 5
        tns = {"n_filt": [], "coef_res": [], "filt": []}
        for w in range(ics.num_windows):
            n_filt = r.read(n_filt_bits)
            tns["n_filt"].append(n_filt)
            filts = []
            coef_res = 0
            if n_filt:
                coef_res = r.read(1)
            tns["coef_res"].append(coef_res)
            for _ in range(n_filt):
                length = r.read(len_bits)
                order = r.read(order_bits)
                f = {"length": length, "order": order, "direction": 0,
                     "coef": []}
                if order:
                    f["direction"] = r.read(1)
                    compress = r.read(1)
                    coef_bits = coef_res + 3 - compress
                    f["coef_compress"] = compress
                    for _ in range(order):
                        f["coef"].append(r.read(coef_bits))
                filts.append(f)
            tns["filt"].append(filts)
        return tns

    def _spectral_data(self, r: BitReader, ch: ChannelData) -> list:
        """Returns grouped quantized coefficients: per group, a flat list
        over [sfb][window-in-group][width]."""
        ics = ch.ics
        groups = []
        for g in range(ics.num_window_groups):
            glen = ics.group_lens[g]
            bands = []
            for sfb in range(ics.max_sfb):
                cb = ch.sect_cb[g][sfb]
                width = (ics.swb_offset[sfb + 1] - ics.swb_offset[sfb])
                total = width * glen
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    bands.append([0] * total)
                    continue
                vals = []
                table = _BOOKS[cb]
                maxlen = _MAXLEN[cb]
                signed = cb in SIGNED_BOOKS
                while len(vals) < total:
                    tup = list(_huff(r, table, maxlen))
                    if not signed:
                        nz = sum(1 for v in tup if v)
                        if nz:
                            bits = r.read(nz)
                            k = nz
                            for idx, v in enumerate(tup):
                                if v:
                                    k -= 1
                                    if (bits >> k) & 1:
                                        tup[idx] = -v
                    if cb == ESC_HCB:
                        for idx, v in enumerate(tup):
                            if v == 16 or v == -16:
                                n = 4
                                while r.read(1):
                                    n += 1
                                mag = (1 << n) + r.read(n)
                                tup[idx] = -mag if v < 0 else mag
                    vals.extend(tup)
                if len(vals) != total:
                    raise ValueError("spectral data length mismatch")
                bands.append(vals)
            groups.append(bands)
        return groups

    # ------------------------------------------------------------- decode
    def _individual_channel_stream(self, r: BitReader, sr_index: int,
                                   common_ics: ICSInfo | None) -> ChannelData:
        ch = ChannelData()
        ch.global_gain = r.read(8)
        ch.ics = common_ics or self._ics_info(r, sr_index)
        ch.sect_cb = self._section_data(r, ch.ics)
        ch.scale_factors = self._scale_factors(r, ch)
        if r.read(1):  # pulse_data_present
            if ch.ics.window_sequence == EIGHT_SHORT:
                raise ValueError("pulse data with short windows")
            ch.pulse = self._pulse_data(r)
        if r.read(1):  # tns_data_present
            ch.tns = self._tns_data(r, ch.ics)
        if r.read(1):  # gain_control_data_present
            raise ValueError("gain control in an LC stream")
        ch.quant = self._spectral_data(r, ch)
        return ch

    def _dequantize(self, ch: ChannelData, sr_index: int) -> None:
        """Grouped quantized -> per-window dequantized spectra."""
        ics = ch.ics
        nw = ics.num_windows
        size = self.n_long // 2 if nw == 1 else self.n_long // 16
        spec = np.zeros((nw, size), np.float32)
        win0 = 0
        for g in range(ics.num_window_groups):
            glen = ics.group_lens[g]
            for sfb in range(ics.max_sfb):
                cb = ch.sect_cb[g][sfb]
                lo = ics.swb_offset[sfb]
                hi = ics.swb_offset[sfb + 1]
                width = hi - lo
                vals = ch.quant[g][sfb]
                if ch.pulse is not None and g == 0 \
                        and sfb >= ch.pulse["start_sfb"]:
                    pass  # pulses applied below on the flat long window
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                gain = 2.0 ** (0.25 * (ch.scale_factors[g][sfb] - 100))
                arr = np.asarray(vals, np.float64)
                deq = np.sign(arr) * np.abs(arr) ** (4.0 / 3.0) * gain
                for wi in range(glen):
                    spec[win0 + wi, lo:hi] = deq[wi * width:(wi + 1) * width]
            win0 += glen
        # pulse data (long windows only): added to the QUANTIZED values, so
        # redo the affected coefficients exactly
        if ch.pulse is not None:
            k = ics.swb_offset[ch.pulse["start_sfb"]]
            for off, amp in zip(ch.pulse["offsets"], ch.pulse["amps"]):
                k += off
                # find this coefficient's band + scale factor
                sfb = 0
                while sfb + 1 < len(ics.swb_offset) and \
                        ics.swb_offset[sfb + 1] <= k:
                    sfb += 1
                if sfb >= ics.max_sfb:
                    continue
                cb = ch.sect_cb[0][sfb]
                if cb == ZERO_HCB or cb >= NOISE_HCB:
                    continue
                lo = ics.swb_offset[sfb]
                q = ch.quant[0][sfb][k - lo]
                q = q + amp if q >= 0 else q - amp
                gain = 2.0 ** (0.25 * (ch.scale_factors[0][sfb] - 100))
                spec[0, k] = math.copysign(abs(q) ** (4.0 / 3.0), q) * gain
        ch.spec = spec

    def _apply_tns(self, ch: ChannelData, sr_index: int) -> None:
        if ch.tns is None:
            return
        ics = ch.ics
        short = ics.window_sequence == EIGHT_SHORT
        tns_max = TNS_MAX_SFB[sr_index][1 if short else 0]
        for w in range(ics.num_windows):
            bottom = ics.num_swb
            for f in ch.tns["filt"][w]:
                top = bottom
                bottom = max(top - f["length"], 0)
                order = f["order"]
                if order == 0:
                    continue
                # decode coefficients -> reflection -> LPC (ISO 14496-3
                # 4.6.9.3)
                coef_res = ch.tns["coef_res"][w]
                compress = f.get("coef_compress", 0)
                coef_bits = coef_res + 3 - compress
                rng = 1 << (coef_bits - 1)
                iqfac = ((rng - 0.5) / (np.pi / 2.0))
                iqfac_m = ((rng + 0.5) / (np.pi / 2.0))
                refl = []
                for c in f["coef"]:
                    if c >= rng:
                        c -= 1 << coef_bits
                    refl.append(np.sin(c / (iqfac if c >= 0 else iqfac_m)))
                lpc = np.zeros(order + 1)
                lpc[0] = 1.0
                for m in range(1, order + 1):
                    b = np.zeros(m + 1)
                    b[:m] = lpc[:m]
                    for i in range(1, m):
                        b[i] += refl[m - 1] * lpc[m - i]
                    b[m] = refl[m - 1]
                    lpc[:m + 1] = b
                start = ics.swb_offset[min(bottom, min(tns_max, ics.max_sfb))]
                end = ics.swb_offset[min(top, min(tns_max, ics.max_sfb))]
                size = end - start
                if size <= 0:
                    continue
                spec = ch.spec[w]
                if f["direction"]:
                    rng_idx = range(end - 1, start - 1, -1)
                    inc = -1
                else:
                    rng_idx = range(start, end)
                    inc = 1
                for i in rng_idx:
                    acc = spec[i]
                    for j in range(1, order + 1):
                        k = i - inc * j
                        if f["direction"]:
                            if k > end - 1:
                                continue
                        elif k < start:
                            continue
                        acc -= lpc[j] * spec[k]
                    spec[i] = acc
        # note: spec modified in place

    def _filterbank(self, out_ch: int, ch: ChannelData) -> np.ndarray:
        """IMDCT + window + overlap-add -> frame_length PCM samples."""
        ics = ch.ics
        nl = self.n_long
        ns = nl // 8
        half = nl // 2
        shape = ics.window_shape
        prev_shape = self.prev_shape.get(out_ch, shape)
        overlap = self.overlap.get(out_ch)
        if overlap is None:
            overlap = np.zeros(half)

        def w_long(s):
            return self.tr.win[(nl, s)]

        def w_short(s):
            return self.tr.win[(ns, s)]

        seq = ics.window_sequence
        if seq == EIGHT_SHORT:
            buf = np.zeros(nl + ns)
            offset = (half - ns) // 2  # 448 for 2048
            for w in range(8):
                x = self.tr.imdct(ch.spec[w], ns)
                wl = w_short(prev_shape if w == 0 else shape)
                wr = w_short(shape)
                x = x * np.concatenate([wl[:ns // 2], wr[ns // 2:]])
                buf[offset + w * (ns // 2): offset + w * (ns // 2) + ns] += x
            first = buf[:half] + overlap
            new_overlap = buf[half:half + half]
        else:
            x = self.tr.imdct(ch.spec[0], nl)
            if seq == ONLY_LONG:
                wl = w_long(prev_shape)
                wr = w_long(shape)
                x = x * np.concatenate([wl[:half], wr[half:]])
            elif seq == LONG_START:
                wl = w_long(prev_shape)
                ws = w_short(shape)
                offset = (half - ns) // 2
                rwin = np.empty(half)
                rwin[:offset] = 1.0
                rwin[offset:offset + ns // 2] = ws[ns // 2:]
                rwin[offset + ns // 2:] = 0.0
                x = x * np.concatenate([wl[:half], rwin])
            elif seq == LONG_STOP:
                ws = w_short(prev_shape)
                wr = w_long(shape)
                offset = (half - ns) // 2
                lwin = np.empty(half)
                lwin[:offset] = 0.0
                lwin[offset:offset + ns // 2] = ws[:ns // 2]
                lwin[offset + ns // 2:] = 1.0
                x = x * np.concatenate([lwin, wr[half:]])
            first = x[:half] + overlap
            new_overlap = x[half:]

        self.overlap[out_ch] = np.array(new_overlap)
        self.prev_shape[out_ch] = shape
        return first

    # ---------------------------------------------------------------- API
    def decode(self, frame: bytes) -> AacDecodeResult | None:
        try:
            return self._decode(frame)
        except (ValueError, IndexError, KeyError, EOFError_):
            return None

    def _decode(self, frame: bytes) -> AacDecodeResult | None:
        header = AdtsHeader()
        if not header.parse(frame):
            return None
        sr_index = header.sampling_frequency_index
        hdr_bytes = 7 if header.protection_absent else 9
        r = BitReader(frame, hdr_bytes * 8)

        elements = []
        element_bits = []
        channels: list[np.ndarray] = []
        frame_elems: list = []  # (ide, ordinal, ch_start, ch_count)
        while True:
            start_bit = r.pos
            ide = r.read(3)
            if ide == ID_END:
                break
            if ide in (ID_SCE, ID_LFE):
                r.read(4)  # element_instance_tag
                ch = self._individual_channel_stream(r, sr_index, None)
                self._dequantize(ch, sr_index)
                self._apply_tns(ch, sr_index)
                pcm = self._filterbank(len(channels), ch)
                frame_elems.append((ide, len(frame_elems), len(channels), 1))
                channels.append(pcm)
                elements.append(ide)
                element_bits.append((start_bit, r.pos))
            elif ide == ID_CPE:
                r.read(4)
                common = r.read(1)
                ms_mask = 0
                ms_used = None
                shared = None
                if common:
                    shared = self._ics_info(r, sr_index)
                    ms_mask = r.read(2)
                    if ms_mask == 1:
                        ms_used = [
                            [r.read(1) for _ in range(shared.max_sfb)]
                            for _ in range(shared.num_window_groups)
                        ]
                ch1 = self._individual_channel_stream(r, sr_index, shared)
                ch2 = self._individual_channel_stream(r, sr_index, shared)
                self._dequantize(ch1, sr_index)
                self._dequantize(ch2, sr_index)
                self._stereo_tools(ch1, ch2, ms_mask, ms_used)
                self._apply_tns(ch1, sr_index)
                self._apply_tns(ch2, sr_index)
                base = len(channels)
                frame_elems.append((ide, len(frame_elems), base, 2))
                channels.append(self._filterbank(base, ch1))
                channels.append(self._filterbank(base + 1, ch2))
                elements.append(ide)
                element_bits.append((start_bit, r.pos))
            elif ide == ID_DSE:
                r.read(4)
                align = r.read(1)
                cnt = r.read(8)
                if cnt == 255:
                    cnt += r.read(8)
                if align:
                    r.pos += (-r.pos) % 8
                r.pos += 8 * cnt
            elif ide == ID_FIL:
                cnt = r.read(4)
                if cnt == 15:
                    cnt += r.read(8) - 1
                if (self.enable_sbr and cnt > 0 and frame_elems
                        and frame_elems[-1][0] in (ID_SCE, ID_CPE)
                        and r.peek(4) in (13, 14)):  # EXT_SBR_DATA(_CRC)
                    payload = bytes(r.read(8) for _ in range(cnt))
                    self._feed_sbr(frame_elems[-1], payload, sr_index)
                else:
                    r.pos += 8 * cnt
            elif ide == ID_PCE:
                self._skip_pce(r)
            else:  # CCE unsupported
                return None

        if not channels:
            return None
        rate = SAMPLE_RATES[sr_index]
        if self.sbr_active:
            channels = self._apply_sbr(frame_elems, channels, sr_index)
            rate *= 2
        pcm = np.stack(channels, axis=1)  # [n, ch] interleaved
        pcm16 = np.clip(np.rint(pcm), -32768, 32767).astype("<i2")
        return AacDecodeResult(
            pcm=pcm16.tobytes(),
            num_channels=len(channels),
            sample_rate=rate,
            elements=elements,
            element_bits=element_bits,
        )

    # ------------------------------------------------------------- SBR
    def _get_sbr(self, elem, sr_index: int):
        from .sbr import SbrDecoder
        ide, ordinal, _, ch_count = elem
        key = (ide, ordinal)
        dec = self.sbr.get(key)
        if dec is None:
            dec = self.sbr[key] = SbrDecoder(SAMPLE_RATES[sr_index],
                                             is_cpe=(ch_count == 2))
        return dec

    def _feed_sbr(self, elem, payload: bytes, sr_index: int) -> None:
        self._get_sbr(elem, sr_index).parse(payload)
        self.sbr_active = True

    def _apply_sbr(self, frame_elems, channels, sr_index: int):
        """Replace each element's channels with its SBR-processed (or
        plain-upsampled, for elements without SBR data) 2x output. An SCE
        with parametric stereo yields two channels from one."""
        out = []
        for elem in frame_elems:
            _, _, ch_start, ch_count = elem
            dec = self._get_sbr(elem, sr_index)
            out.extend(dec.process(
                [channels[ch_start + i] for i in range(ch_count)]))
        return out

    def _stereo_tools(self, ch1, ch2, ms_mask, ms_used) -> None:
        ics = ch1.ics
        win0 = 0
        for g in range(ics.num_window_groups):
            glen = ics.group_lens[g]
            for sfb in range(min(ics.max_sfb, ch2.ics.max_sfb)):
                lo = ics.swb_offset[sfb]
                hi = ics.swb_offset[sfb + 1]
                cb2 = ch2.sect_cb[g][sfb]
                ms_on = (ms_mask == 2) or (
                    ms_mask == 1 and ms_used and ms_used[g][sfb])
                if cb2 in (INTENSITY_HCB, INTENSITY_HCB2):
                    # intensity: right = left * 2^(-is_pos/4); phase from the
                    # codebook, inverted by ms_used (ISO 14496-3 4.6.8.2)
                    sign = 1.0 if cb2 == INTENSITY_HCB else -1.0
                    if ms_on:
                        sign = -sign
                    scale = sign * 2.0 ** (
                        -0.25 * ch2.scale_factors[g][sfb])
                    for wi in range(glen):
                        ch2.spec[win0 + wi, lo:hi] = \
                            ch1.spec[win0 + wi, lo:hi] * scale
                elif ms_on and cb2 != NOISE_HCB:
                    for wi in range(glen):
                        ls = ch1.spec[win0 + wi, lo:hi].copy()
                        rs = ch2.spec[win0 + wi, lo:hi]
                        ch1.spec[win0 + wi, lo:hi] = ls + rs
                        ch2.spec[win0 + wi, lo:hi] = ls - rs
            win0 += glen

    def _skip_pce(self, r: BitReader) -> None:
        r.read(4)  # instance tag
        r.read(2)  # object type
        r.read(4)  # sr index
        nf = r.read(4)
        ns = r.read(4)
        nb = r.read(4)
        nl = r.read(2)
        na = r.read(3)
        nv = r.read(4)
        if r.read(1):
            r.read(4)
        if r.read(1):
            r.read(4)
        if r.read(1):
            r.read(3)
        for _ in range(nf + ns):
            r.read(1 + 4)
        for _ in range(nb):
            r.read(1 + 4)
        for _ in range(nl):
            r.read(4)
        for _ in range(na + nv):
            r.read(1 + 4)
        r.pos += (-r.pos) % 8
        n = r.read(8)
        r.pos += 8 * n
