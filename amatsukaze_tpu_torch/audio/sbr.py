"""Spectral Band Replication (HE-AAC v1) decoder.

Completes the in-build AAC decoder's parity with the reference's vendored
libfaad (SBR_DEC build, libfaad/sbr_*.c — the reference
consumes it through ``NeAACDecDecode``, AdtsParser.hpp:174-207).  Japanese
broadcast audio is AAC-LC, so this path exists for capability parity and
for off-air HE-AAC sources.

Implements ISO/IEC 14496-3 §4.6.18: SBR bitstream parsing (header, time/
frequency grids, delta-coded envelopes/noise floors, inverse-filtering
modes, sinusoidal coding), frequency band table derivation, the 32-band
complex QMF analysis / 64-band synthesis pair, HF generation by patching
with 2nd-order LPC inverse filtering (covariance method), and HF adjustment
(envelope gains with limiter, noise floor and sinusoid injection with
cross-frame gain smoothing).  Normative data tables live in
``sbr_tables``.  One ``SbrDecoder`` instance per SCE/CPE element; output is
2048 samples/frame at twice the core sample rate.

The port's copy of amatsukaze_tpu/audio/sbr.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitReader, EOFError_
from . import sbr_tables as T

EXT_SBR_DATA = 13
EXT_SBR_DATA_CRC = 14

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
LO_RES, HI_RES = 0, 1

RATE = 2
NUM_TIME_SLOTS = 16
T_HFGEN = 8
T_HFADJ = 2
NTSR = NUM_TIME_SLOTS * RATE  # 32 QMF subsamples per frame
BUF_SLOTS = NTSR + T_HFGEN  # 40

EPS = 1e-12

_SR_TABLE = [96000, 88200, 64000, 48000, 44100, 32000,
             24000, 22050, 16000, 12000, 11025, 8000]


def _sr_index(rate: int) -> int:
    return _SR_TABLE.index(rate)


# ---------------------------------------------------------------------------
# huffman decode over the canonical (length, code, value) tables
# ---------------------------------------------------------------------------

class _Huff:
    def __init__(self, table):
        self.map = {(length, code): v for length, code, v in table}
        self.maxlen = max(length for length, _, _ in table)

    def decode(self, r: BitReader) -> int:
        avail = min(self.maxlen, len(r.data) * 8 - r.pos)
        word = r.peek(avail)
        get = self.map.get
        for length in range(1, avail + 1):
            v = get((length, word >> (avail - length)))
            if v is not None:
                r.pos += length
                return v
        raise ValueError("invalid SBR huffman code")


T_ENV_15 = _Huff(T.T_HUFFMAN_ENV_1_5DB)
F_ENV_15 = _Huff(T.F_HUFFMAN_ENV_1_5DB)
T_ENV_BAL_15 = _Huff(T.T_HUFFMAN_ENV_BAL_1_5DB)
F_ENV_BAL_15 = _Huff(T.F_HUFFMAN_ENV_BAL_1_5DB)
T_ENV_30 = _Huff(T.T_HUFFMAN_ENV_3_0DB)
F_ENV_30 = _Huff(T.F_HUFFMAN_ENV_3_0DB)
T_ENV_BAL_30 = _Huff(T.T_HUFFMAN_ENV_BAL_3_0DB)
F_ENV_BAL_30 = _Huff(T.F_HUFFMAN_ENV_BAL_3_0DB)
T_NOISE_30 = _Huff(T.T_HUFFMAN_NOISE_3_0DB)
T_NOISE_BAL_30 = _Huff(T.T_HUFFMAN_NOISE_BAL_3_0DB)


# ---------------------------------------------------------------------------
# frequency band tables (ISO 14496-3 4.6.18.3.2)
# ---------------------------------------------------------------------------

_START_MIN = [7, 7, 10, 11, 12, 16, 16, 17, 24, 32, 35, 48]
_START_OFFSET_INDEX = [5, 5, 4, 4, 4, 3, 2, 1, 0, 6, 6, 6]
_START_OFFSET = [
    [-8, -7, -6, -5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7],
    [-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13],
    [-5, -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16],
    [-6, -4, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16],
    [-4, -2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 20],
    [-2, -1, 0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 20, 24],
    [0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 16, 20, 24, 28, 33],
]
_STOP_MIN = [13, 15, 20, 21, 23, 32, 32, 35, 48, 64, 70, 96]
_STOP_OFFSET = [
    [0, 2, 4, 6, 8, 11, 14, 18, 22, 26, 31, 37, 44, 51],
    [0, 2, 4, 6, 8, 11, 14, 18, 22, 26, 31, 36, 42, 49],
    [0, 2, 4, 6, 8, 11, 14, 17, 21, 25, 29, 34, 39, 44],
    [0, 2, 4, 6, 8, 11, 14, 17, 20, 24, 28, 33, 38, 43],
    [0, 2, 4, 6, 8, 11, 14, 17, 20, 24, 28, 32, 36, 41],
    [0, 2, 4, 6, 8, 10, 12, 14, 17, 20, 23, 26, 29, 32],
    [0, 2, 4, 6, 8, 10, 12, 14, 17, 20, 23, 26, 29, 32],
    [0, 1, 3, 5, 7, 9, 11, 13, 15, 17, 20, 23, 26, 29],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, -1, -2, -3, -4, -5, -6, -6, -6, -6, -6, -6, -6, -6],
    [0, -3, -6, -9, -12, -15, -18, -20, -22, -24, -26, -28, -30, -32],
]
_GOAL_SB = [21, 23, 32, 43, 46, 64, 85, 93, 128, 0, 0, 0]


def qmf_start_channel(bs_start_freq: int, bs_samplerate_mode: int,
                      sample_rate: int) -> int:
    idx = _sr_index(sample_rate)
    start_min = _START_MIN[idx]
    if bs_samplerate_mode:
        return start_min + _START_OFFSET[_START_OFFSET_INDEX[idx]][bs_start_freq]
    return start_min + _START_OFFSET[6][bs_start_freq]


def qmf_stop_channel(bs_stop_freq: int, sample_rate: int, k0: int) -> int:
    if bs_stop_freq == 15:
        return min(64, k0 * 3)
    if bs_stop_freq == 14:
        return min(64, k0 * 2)
    idx = _sr_index(sample_rate)
    return min(64, _STOP_MIN[idx] + _STOP_OFFSET[idx][min(bs_stop_freq, 13)])


def _find_bands(warp: bool, bands: int, a0: int, a1: int) -> int:
    div = np.log(2.0) * (1.3 if warp else 1.0)
    return int(bands * np.log(a1 / a0) / div + 0.5)


def master_frequency_table(k0: int, k2: int, freq_scale: int,
                           alter_scale: int) -> list[int] | None:
    """f_master border list; None on an invalid parameter combination."""
    if k2 <= k0:
        return None
    if freq_scale == 0:
        dk = 2 if alter_scale else 1
        if alter_scale:
            nr_bands = ((k2 - k0 + 2) >> 2) << 1
        else:
            nr_bands = ((k2 - k0) >> 1) << 1
        nr_bands = min(nr_bands, 63)
        if nr_bands <= 0:
            return None
        k2_achieved = k0 + nr_bands * dk
        k2_diff = k2 - k2_achieved
        v_dk = [dk] * nr_bands
        if k2_diff:
            incr = -1 if k2_diff > 0 else 1
            k = nr_bands - 1 if k2_diff > 0 else 0
            while k2_diff != 0:
                v_dk[k] -= incr
                k += incr
                k2_diff += incr
        out = [k0]
        for d in v_dk:
            out.append(out[-1] + d)
        return out

    bands = [6, 5, 4][freq_scale - 1]
    if k2 / k0 > 2.2449:
        two_regions = True
        k1 = k0 * 2
    else:
        two_regions = False
        k1 = k2

    nr_band0 = min(2 * _find_bands(False, bands, k0, k1), 63)
    if nr_band0 <= 0:
        return None
    q = (k1 / k0) ** (1.0 / nr_band0)
    v_dk0 = []
    qk = float(k0)
    a_1 = int(qk + 0.5)
    for _ in range(nr_band0 + 1):
        a_0 = a_1
        qk *= q
        a_1 = int(qk + 0.5)
        v_dk0.append(a_1 - a_0)
    v_dk0 = sorted(v_dk0[:nr_band0])
    if any(d == 0 for d in v_dk0):
        return None
    vk0 = [k0]
    for d in v_dk0:
        vk0.append(vk0[-1] + d)
    if not two_regions:
        return vk0

    nr_band1 = min(2 * _find_bands(True, bands, k1, k2), 63)
    q = (k2 / k1) ** (1.0 / nr_band1)
    v_dk1 = []
    qk = float(k1)
    a_1 = int(qk + 0.5)
    for _ in range(nr_band1):
        a_0 = a_1
        qk *= q
        a_1 = int(qk + 0.5)
        v_dk1.append(a_1 - a_0)
    v_dk1 += [0] * (nr_band1 + 1 - len(v_dk1))
    if v_dk1[0] < v_dk0[-1]:
        v_dk1 = sorted(v_dk1[:nr_band1 + 1])
        change = v_dk0[-1] - v_dk1[0]
        v_dk1[0] = v_dk0[-1]
        v_dk1[nr_band1 - 1] -= change
    v_dk1 = sorted(v_dk1[:nr_band1])
    if any(d == 0 for d in v_dk1):
        return None
    vk1 = [k1]
    for d in v_dk1:
        vk1.append(vk1[-1] + d)
    out = vk0 + vk1[1:]
    # degenerate headers (e.g. tiny second regions) can push a negative
    # band width through the boundary adjustment above; the reference
    # decoder lets the non-monotone table through, we reject the header
    if any(b <= a for a, b in zip(out, out[1:])):
        return None
    return out


class FreqTables:
    """Derived band tables for one header (4.6.18.3.2.2)."""

    def __init__(self, f_master: list[int], xover: int, k0: int, k2: int,
                 noise_bands: int, sample_rate: int):
        if len(f_master) - 1 <= xover:
            raise ValueError("bs_xover_band >= N_master")
        self.f_master = f_master
        self.n_master = len(f_master) - 1
        self.k0 = k0
        self.k2 = k2
        self.n_high = self.n_master - xover
        self.n_low = (self.n_high >> 1) + (self.n_high & 1)
        self.f_high = f_master[xover:]
        self.kx = self.f_high[0]
        self.m = self.f_high[-1] - self.f_high[0]
        if self.kx > 32 or self.kx + self.m > 64:
            raise ValueError("invalid kx/M")
        minus = 1 if (self.n_high & 1) else 0
        self.f_low = [self.f_high[0]] + [
            self.f_high[2 * k - minus] for k in range(1, self.n_low + 1)]
        if noise_bands == 0:
            self.n_q = 1
        else:
            self.n_q = min(5, max(1, _find_bands(False, noise_bands,
                                                 self.kx, k2)))
        self.f_noise = [self.f_low[0]]
        i = 0
        for k in range(1, self.n_q + 1):
            i = i + (self.n_low - i) // (self.n_q + 1 - k)
            self.f_noise.append(self.f_low[i])
        # map QMF channel -> noise band
        self.k_to_g = [0] * 64
        for k in range(64):
            for g in range(self.n_q):
                if self.f_noise[g] <= k < self.f_noise[g + 1]:
                    self.k_to_g[k] = g
                    break
        self.n = [self.n_low, self.n_high]
        self.f_res = [self.f_low, self.f_high]
        # patches (4.6.18.6.3) — depends only on the header
        self._patch_construction(sample_rate)
        self._limiter_tables()

    def _patch_construction(self, sample_rate: int) -> None:
        k0, kx = self.k0, self.kx
        msb, usb = k0, kx
        goal_sb = _GOAL_SB[_sr_index(sample_rate)]
        self.patch_no_subbands: list[int] = []
        self.patch_start_subband: list[int] = []
        if goal_sb < kx + self.m:
            k = 0
            for i in range(len(self.f_master)):
                if self.f_master[i] >= goal_sb:
                    break
                k = i + 1
        else:
            k = self.n_master
        if self.n_master == 0:
            return
        sb = 0
        while True:
            j = k + 1
            while True:
                j -= 1
                sb = self.f_master[j]
                odd = (sb - 2 + k0) % 2
                if sb <= k0 - 1 + msb - odd:
                    break
            no_sub = max(sb - usb, 0)
            start = k0 - odd - no_sub
            if no_sub > 0:
                self.patch_no_subbands.append(no_sub)
                self.patch_start_subband.append(start)
                usb = sb
                msb = sb
            else:
                msb = kx
            if self.f_master[k] - sb < 3:
                k = self.n_master
            if sb == kx + self.m:
                break
        if len(self.patch_no_subbands) > 1 and self.patch_no_subbands[-1] < 3:
            self.patch_no_subbands.pop()
            self.patch_start_subband.pop()
        self.patch_no_subbands = self.patch_no_subbands[:5]
        self.patch_start_subband = self.patch_start_subband[:5]

    def _limiter_tables(self) -> None:
        """f_table_lim for all 4 bs_limiter_bands settings (4.6.18.3.2.3)."""
        compare = [None, 1.327152, 1.185093, 1.119872]
        self.f_lim = [[f - self.kx for f in (self.f_low[0], self.f_low[-1])]]
        patch_borders = [self.kx]
        for n in self.patch_no_subbands:
            patch_borders.append(patch_borders[-1] + n)
        top = self.f_low[-1]
        for s in (1, 2, 3):
            lim = sorted(set(self.f_low) | set(patch_borders[1:-1]))
            k = 1
            while k < len(lim):
                if lim[k - 1] != 0:
                    n_oct = lim[k] / lim[k - 1]
                else:
                    n_oct = 0
                if n_oct < compare[s]:
                    # patch borders are protected; additionally the first
                    # and last borders are always kept so every SBR band
                    # stays inside a limiter band (the reference decoder
                    # can drop the top border when the trailing patch was
                    # discarded, leaving bands with uncontrolled gain)
                    keep_k = lim[k] in patch_borders or lim[k] == top
                    keep_k1 = (lim[k - 1] in patch_borders
                               or lim[k - 1] == self.f_low[0])
                    if keep_k and keep_k1:
                        k += 1
                    elif keep_k:
                        del lim[k - 1]
                    else:
                        del lim[k]
                    continue
                k += 1
            self.f_lim.append([f - self.kx for f in lim])


# ---------------------------------------------------------------------------
# QMF banks
# ---------------------------------------------------------------------------

_C640 = T.QMF_PROTO
_C320 = _C640[::2]

# analysis exponentials: exp(j*pi/64*(k+1/2)*(2n-1/2)), k=0..31, n=0..63
# (derived numerically from the normative DCT-IV factorization; the n-offset
# is -0.25 samples in u-index terms)
_n = np.arange(64)
_k = np.arange(32)
_ANA = 2.0 * np.exp(1j * np.pi / 64.0 *
                    np.outer(2.0 * _n - 0.5, _k + 0.5))  # [64, 32]
# synthesis exponentials: exp(j*pi/128*(k+1/2)*(2n-255)), k=0..63, n=0..127
_n2 = np.arange(128)
_k2 = np.arange(64)
_SYN = (1.0 / 64.0) * np.exp(1j * np.pi / 128.0 *
                             np.outer(_k2 + 0.5, 2.0 * _n2 - 255.0))  # [64,128]


class QmfAnalysis32:
    """32-band complex analysis bank over 1024-sample frames."""

    def __init__(self):
        self.x = np.zeros(320)

    def analyze(self, samples: np.ndarray) -> np.ndarray:
        """[1024] -> X[32 slots, 32 bands] complex."""
        out = np.empty((NTSR, 32), complex)
        x = self.x
        for sl in range(NTSR):
            x[32:] = x[:-32]
            x[:32] = samples[sl * 32:sl * 32 + 32][::-1]
            z = x * _C320
            u = z.reshape(5, 64).sum(axis=0)
            out[sl] = u @ _ANA
        return out


class QmfSynthesis64:
    """64-band synthesis bank producing 2048 samples per frame."""

    def __init__(self):
        self.v = np.zeros(1280)

    def synthesize(self, X: np.ndarray) -> np.ndarray:
        """X[32 slots, 64 bands] complex -> [2048] samples."""
        out = np.empty(NTSR * 64)
        v = self.v
        idx = (np.arange(5)[:, None] * 256 +
               np.concatenate([np.arange(64), 192 + np.arange(64)])).ravel()
        for sl in range(NTSR):
            v[128:] = v[:-128]
            v[:128] = np.real(X[sl] @ _SYN)
            w = v[idx] * _C640
            out[sl * 64:(sl + 1) * 64] = w.reshape(10, 64).sum(axis=0)
        return out


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class _ChState:
    """Per-output-channel persistent state."""

    def __init__(self):
        self.qmfa = QmfAnalysis32()
        self.qmfs = QmfSynthesis64()
        self.xsbr = np.zeros((BUF_SLOTS, 64), complex)
        self.e_prev = np.zeros(64, int)
        self.q_prev = np.zeros(5, int)
        self.f_prev = 1
        self.add_harmonic_prev = np.zeros(64, int)
        self.add_harmonic_flag_prev = 0
        self.bw_prev = np.zeros(5)
        self.invf_prev = np.zeros(5, int)
        self.g_temp = [np.zeros(64) for _ in range(5)]
        self.q_temp = [np.zeros(64) for _ in range(5)]
        self.gq_index = 0
        self.index_noise = 0
        self.psi_is = 0
        self.prev_env_is_short = -1


class _ChFrame:
    """Per-channel per-frame decoded data."""

    def __init__(self):
        self.frame_class = FIXFIX
        self.L_E = 1
        self.L_Q = 1
        self.t_E: list[int] = [0, NUM_TIME_SLOTS]
        self.t_Q: list[int] = [0, NUM_TIME_SLOTS]
        self.f: list[int] = [1]
        self.pointer = 0
        self.df_env: list[int] = []
        self.df_noise: list[int] = []
        self.invf = np.zeros(5, int)
        self.E = np.zeros((64, 5), int)
        self.Q = np.zeros((5, 2), int)
        self.E_orig = np.zeros((64, 5))
        self.q_div = np.zeros((5, 2))
        self.q_div2 = np.zeros((5, 2))
        self.add_harmonic = np.zeros(64, int)
        self.add_harmonic_flag = 0
        self.amp_res = 0
        self.l_A = -1
        self.abs_bord_lead = 0
        self.abs_bord_trail = NUM_TIME_SLOTS
        self.n_rel = ([], [])


class SbrDecoder:
    """One SBR element decoder (attach one per SCE/CPE).

    ``parse(payload)`` consumes one fill-element extension payload;
    ``process(channels)`` runs the frame and returns 2048-sample channels.
    """

    def __init__(self, sample_rate: int, is_cpe: bool):
        self.sample_rate = sample_rate  # core (input) rate
        self.is_cpe = is_cpe
        nch = 2 if is_cpe else 1
        self.state = [_ChState() for _ in range(nch)]
        self.frame = [_ChFrame() for _ in range(nch)]
        self.header_count = 0
        self.reset_flag = True
        # header defaults (4.6.18.3.1)
        self.amp_res = 1
        self.start_freq = 5
        self.stop_freq = 0
        self.xover_band = 0
        self.freq_scale = 2
        self.alter_scale = 1
        self.noise_bands = 2
        self.limiter_bands = 2
        self.limiter_gains = 2
        self.interpol_freq = 1
        self.smoothing_mode = 1
        self._prev_header = None
        self.tables: FreqTables | None = None
        self.coupling = 0
        self.kx_prev = 32
        self.m_prev = 0
        self.frame_error = True  # no data yet -> upsample only
        self.ps = None  # PsDecoder once a PS extension is seen (SCE only)
        self.ps_used = False
        self._qmfs_right: QmfSynthesis64 | None = None

    # ------------------------------------------------------------- parsing
    def parse(self, payload: bytes) -> None:
        try:
            self._parse(payload)
            self.frame_error = False
        except (ValueError, IndexError, EOFError_):
            self.frame_error = True

    def _parse(self, payload: bytes) -> None:
        r = BitReader(payload, 0)
        ext_type = r.read(4)
        if ext_type == EXT_SBR_DATA_CRC:
            r.read(10)
        elif ext_type != EXT_SBR_DATA:
            raise ValueError("not SBR payload")
        if r.read(1):
            self._parse_header(r)
        header = (self.start_freq, self.stop_freq, self.freq_scale,
                  self.alter_scale, self.xover_band, self.noise_bands)
        self.reset_flag = header != self._prev_header
        self._prev_header = header
        if self.header_count == 0:
            raise ValueError("no header yet")
        if self.reset_flag or self.tables is None:
            k0 = qmf_start_channel(self.start_freq, 1, self.sample_rate * 2)
            k2 = qmf_stop_channel(self.stop_freq, self.sample_rate * 2, k0)
            lim = 32 if self.sample_rate * 2 >= 48000 else (
                48 if self.sample_rate * 2 <= 32000 else 45)
            if k2 - k0 > lim:
                raise ValueError("k2-k0 out of range")
            fm = master_frequency_table(k0, k2, self.freq_scale,
                                        self.alter_scale)
            if fm is None:
                raise ValueError("bad master table")
            self.tables = FreqTables(fm, self.xover_band, k0, k2,
                                     self.noise_bands, self.sample_rate * 2)
        self._sbr_data(r)

    def _parse_header(self, r: BitReader) -> None:
        self.header_count += 1
        self.amp_res = r.read(1)
        self.start_freq = r.read(4)
        self.stop_freq = r.read(4)
        self.xover_band = r.read(3)
        r.read(2)  # reserved
        extra1 = r.read(1)
        extra2 = r.read(1)
        if extra1:
            self.freq_scale = r.read(2)
            self.alter_scale = r.read(1)
            self.noise_bands = r.read(2)
        else:
            self.freq_scale, self.alter_scale, self.noise_bands = 2, 1, 2
        if extra2:
            self.limiter_bands = r.read(2)
            self.limiter_gains = r.read(2)
            self.interpol_freq = r.read(1)
            self.smoothing_mode = r.read(1)
        else:
            self.limiter_bands = 2
            self.limiter_gains = 2
            self.interpol_freq = 1
            self.smoothing_mode = 1

    def _sbr_data(self, r: BitReader) -> None:
        t = self.tables
        if not self.is_cpe:
            if r.read(1):
                r.read(4)
            self.coupling = 0
            self._grid(r, 0)
            self._dtdf(r, 0)
            self._invf(r, 0)
            self._envelope(r, 0)
            self._noise(r, 0)
            self._dequant(0)
            f = self.frame[0]
            f.add_harmonic = np.zeros(64, int)
            f.add_harmonic_flag = r.read(1)
            if f.add_harmonic_flag:
                for n in range(t.n_high):
                    f.add_harmonic[n] = r.read(1)
            self._extended_data(r)
        else:
            if r.read(1):
                r.read(8)
            self.coupling = r.read(1)
            if self.coupling:
                self._grid(r, 0)
                self._copy_grid(0, 1)
                self._dtdf(r, 0)
                self._dtdf(r, 1)
                self._invf(r, 0)
                self.frame[1].invf = self.frame[0].invf.copy()
                self._envelope(r, 0)
                self._noise(r, 0)
                self._envelope(r, 1)
                self._noise(r, 1)
            else:
                self._grid(r, 0)
                self._grid(r, 1)
                self._dtdf(r, 0)
                self._dtdf(r, 1)
                self._invf(r, 0)
                self._invf(r, 1)
                self._envelope(r, 0)
                self._envelope(r, 1)
                self._noise(r, 0)
                self._noise(r, 1)
            for ch in (0, 1):
                f = self.frame[ch]
                f.add_harmonic = np.zeros(64, int)
                f.add_harmonic_flag = r.read(1)
                if f.add_harmonic_flag:
                    for n in range(t.n_high):
                        f.add_harmonic[n] = r.read(1)
            if self.coupling:
                self._unmap_coupled()
            else:
                self._dequant(0)
                self._dequant(1)
            self._extended_data(r)

    def _extended_data(self, r: BitReader) -> None:
        if not r.read(1):
            return
        cnt = r.read(4)
        if cnt == 15:
            cnt += r.read(8)
        nr_bits = 8 * cnt
        while nr_bits > 7:
            start = r.pos
            ext_id = r.read(2)
            if ext_id == 2 and not self.is_cpe:  # EXTENSION_ID_PS
                from .ps import PsDecoder

                if self.ps is None:
                    self.ps = PsDecoder()
                self.ps.parse(r)
                if self.ps.header_read:
                    self.ps_used = True
            else:
                r.read(6)
            nr_bits -= r.pos - start
        if nr_bits > 0:
            r.read(nr_bits)

    @staticmethod
    def _log2i(val: int) -> int:
        tab = [0, 0, 1, 2, 2, 3, 3, 3, 3, 4]
        return tab[val] if 0 <= val < 10 else 0

    def _grid(self, r: BitReader, ch: int) -> None:
        f = self.frame[ch]
        f.frame_class = r.read(2)
        if f.frame_class == FIXFIX:
            num_env = min(1 << r.read(2), 5)
            res = r.read(1)
            f.f = [res] * num_env
            f.abs_bord_lead = 0
            f.abs_bord_trail = NUM_TIME_SLOTS
            rel0, rel1 = [NUM_TIME_SLOTS // num_env] * (num_env - 1), []
        elif f.frame_class == FIXVAR:
            abs_bord = r.read(2) + NUM_TIME_SLOTS
            num_env = r.read(2) + 1
            rel1 = [2 * r.read(2) + 2 for _ in range(num_env - 1)]
            f.pointer = r.read(self._log2i(num_env + 1))
            f.f = [0] * num_env
            for env in range(num_env):
                f.f[num_env - 1 - env] = r.read(1)
            f.abs_bord_lead = 0
            f.abs_bord_trail = abs_bord
            rel0 = []
        elif f.frame_class == VARFIX:
            f.abs_bord_lead = r.read(2)
            num_env = r.read(2) + 1
            rel0 = [2 * r.read(2) + 2 for _ in range(num_env - 1)]
            f.pointer = r.read(self._log2i(num_env + 1))
            f.f = [r.read(1) for _ in range(num_env)]
            f.abs_bord_trail = NUM_TIME_SLOTS
            rel1 = []
        else:  # VARVAR
            f.abs_bord_lead = r.read(2)
            f.abs_bord_trail = r.read(2) + NUM_TIME_SLOTS
            n0 = r.read(2)
            n1 = r.read(2)
            num_env = min(5, n0 + n1 + 1)
            rel0 = [2 * r.read(2) + 2 for _ in range(n0)]
            rel1 = [2 * r.read(2) + 2 for _ in range(n1)]
            f.pointer = r.read(self._log2i(n0 + n1 + 2))
            f.f = [r.read(1) for _ in range(num_env)]
        f.L_E = min(num_env, 5 if f.frame_class == VARVAR else 4)
        if f.L_E <= 0:
            raise ValueError("L_E <= 0")
        f.L_Q = 2 if f.L_E > 1 else 1
        f.n_rel = (rel0, rel1)
        self._time_borders(ch)
        self._noise_borders(ch)

    def _time_borders(self, ch: int) -> None:
        f = self.frame[ch]
        t_e = [0] * (f.L_E + 1)
        t_e[0] = RATE * f.abs_bord_lead
        t_e[f.L_E] = RATE * f.abs_bord_trail
        rel0, rel1 = f.n_rel
        if f.frame_class == FIXFIX:
            if f.L_E in (2, 4):
                step = NUM_TIME_SLOTS // f.L_E
                for i in range(1, f.L_E):
                    t_e[i] = RATE * i * step
        elif f.frame_class == FIXVAR:
            border = f.abs_bord_trail
            i = f.L_E
            for rel in rel1:
                if border < rel:
                    raise ValueError("bad rel border")
                border -= rel
                i -= 1
                t_e[i] = RATE * border
        elif f.frame_class == VARFIX:
            border = f.abs_bord_lead
            i = 1
            for rel in rel0:
                border += rel
                if RATE * border + T_HFADJ > NTSR + T_HFGEN:
                    raise ValueError("bad rel border")
                t_e[i] = RATE * border
                i += 1
        else:
            border = f.abs_bord_lead
            i = 1
            for rel in rel0:
                border += rel
                if RATE * border + T_HFADJ > NTSR + T_HFGEN:
                    raise ValueError("bad rel border")
                t_e[i] = RATE * border
                i += 1
            border = f.abs_bord_trail
            i = f.L_E
            for rel in rel1:
                if border < rel:
                    raise ValueError("bad rel border")
                border -= rel
                i -= 1
                t_e[i] = RATE * border
        # a VARVAR grid can pass every relative-border check yet yield
        # crossing borders (lead+rel0 overrunning trail-rel1); the
        # envelope walk assumes monotone t_E, so reject the frame here
        # (caught as frame_error -> upsample-only)
        if any(b < a for a, b in zip(t_e[:f.L_E], t_e[1:f.L_E + 1])):
            raise ValueError("non-monotone envelope borders")
        f.t_E = t_e

    def _middle_border(self, ch: int) -> int:
        f = self.frame[ch]
        if f.frame_class == FIXFIX:
            ret = f.L_E // 2
        elif f.frame_class == VARFIX:
            if f.pointer == 0:
                ret = 1
            elif f.pointer == 1:
                ret = f.L_E - 1
            else:
                ret = f.pointer - 1
        else:
            if f.pointer > 1:
                ret = f.L_E + 1 - f.pointer
            else:
                ret = f.L_E - 1
        return max(ret, 0)

    def _noise_borders(self, ch: int) -> None:
        f = self.frame[ch]
        if f.L_E == 1:
            f.t_Q = [f.t_E[0], f.t_E[1]]
        else:
            mid = self._middle_border(ch)
            f.t_Q = [f.t_E[0], f.t_E[mid], f.t_E[f.L_E]]

    def _copy_grid(self, src: int, dst: int) -> None:
        fs, fd = self.frame[src], self.frame[dst]
        fd.frame_class = fs.frame_class
        fd.L_E, fd.L_Q = fs.L_E, fs.L_Q
        fd.pointer = fs.pointer
        fd.t_E = list(fs.t_E)
        fd.t_Q = list(fs.t_Q)
        fd.f = list(fs.f)

    def _dtdf(self, r: BitReader, ch: int) -> None:
        f = self.frame[ch]
        f.df_env = [r.read(1) for _ in range(f.L_E)]
        f.df_noise = [r.read(1) for _ in range(f.L_Q)]

    def _invf(self, r: BitReader, ch: int) -> None:
        f = self.frame[ch]
        f.invf = np.array([r.read(2) for _ in range(self.tables.n_q)]
                          + [0] * (5 - self.tables.n_q))

    def _envelope(self, r: BitReader, ch: int) -> None:
        f = self.frame[ch]
        t = self.tables
        if f.L_E == 1 and f.frame_class == FIXFIX:
            f.amp_res = 0
        else:
            f.amp_res = self.amp_res
        balance = self.coupling and ch == 1
        if balance:
            delta = 1
            if f.amp_res:
                t_h, f_h, bits = T_ENV_BAL_30, F_ENV_BAL_30, 5
            else:
                t_h, f_h, bits = T_ENV_BAL_15, F_ENV_BAL_15, 6
        else:
            delta = 0
            if f.amp_res:
                t_h, f_h, bits = T_ENV_30, F_ENV_30, 6
            else:
                t_h, f_h, bits = T_ENV_15, F_ENV_15, 7
        f.E = np.zeros((64, 5), int)
        for env in range(f.L_E):
            n = t.n[f.f[env]]
            if f.df_env[env] == 0:
                f.E[0, env] = r.read(bits) << delta
                for band in range(1, n):
                    f.E[band, env] = f_h.decode(r) << delta
            else:
                for band in range(n):
                    f.E[band, env] = t_h.decode(r) << delta
        self._extract_envelope(ch)

    def _extract_envelope(self, ch: int) -> None:
        """Resolve delta-time/delta-freq coding (sbr_e_nf semantics)."""
        f = self.frame[ch]
        st = self.state[min(ch, len(self.state) - 1)]
        t = self.tables
        for env in range(f.L_E):
            if f.df_env[env] == 0:
                for k in range(1, t.n[f.f[env]]):
                    f.E[k, env] += f.E[k - 1, env]
                    if f.E[k, env] < 0:
                        f.E[k, env] = 0
            else:
                g = st.f_prev if env == 0 else f.f[env - 1]
                prev = st.e_prev if env == 0 else f.E[:, env - 1]
                if f.f[env] == g:
                    for k in range(t.n[f.f[env]]):
                        f.E[k, env] += prev[k]
                elif g == HI_RES and f.f[env] == LO_RES:
                    for k in range(t.n[LO_RES]):
                        for i in range(t.n_high):
                            if t.f_high[i] == t.f_low[k]:
                                f.E[k, env] += prev[i]
                else:
                    for k in range(t.n[HI_RES]):
                        for i in range(t.n_low):
                            if t.f_low[i] <= t.f_high[k] < t.f_low[i + 1]:
                                f.E[k, env] += prev[i]

    def _noise(self, r: BitReader, ch: int) -> None:
        f = self.frame[ch]
        t = self.tables
        balance = self.coupling and ch == 1
        if balance:
            delta, t_h, f_h = 1, T_NOISE_BAL_30, F_ENV_BAL_30
        else:
            delta, t_h, f_h = 0, T_NOISE_30, F_ENV_30
        f.Q = np.zeros((5, 2), int)
        for nf in range(f.L_Q):
            if f.df_noise[nf] == 0:
                f.Q[0, nf] = r.read(5) << delta
                for band in range(1, t.n_q):
                    f.Q[band, nf] = f_h.decode(r) << delta
            else:
                for band in range(t.n_q):
                    f.Q[band, nf] = t_h.decode(r) << delta
        # resolve deltas
        st = self.state[min(ch, len(self.state) - 1)]
        for nf in range(f.L_Q):
            if f.df_noise[nf] == 0:
                for k in range(1, t.n_q):
                    f.Q[k, nf] += f.Q[k - 1, nf]
            else:
                prev = st.q_prev if nf == 0 else f.Q[:, nf - 1]
                for k in range(t.n_q):
                    f.Q[k, nf] += prev[k]

    # -------------------------------------------------------- dequantise
    def _dequant(self, ch: int) -> None:
        f = self.frame[ch]
        t = self.tables
        amp = 0 if f.amp_res else 1
        f.E_orig = np.zeros((64, 5))
        for env in range(f.L_E):
            for k in range(t.n[f.f[env]]):
                exp = f.E[k, env] >> amp
                if 0 <= exp < 64:
                    val = float(2.0 ** (exp + 6))
                    if amp and (f.E[k, env] & 1):
                        val *= 1.414213562
                    f.E_orig[k, env] = val
        f.q_div = np.zeros((5, 2))
        f.q_div2 = np.zeros((5, 2))
        for nf in range(f.L_Q):
            for k in range(t.n_q):
                q = f.Q[k, nf]
                if 0 <= q <= 30:
                    q_orig = 2.0 ** (6 - q)
                    f.q_div[k, nf] = 1.0 / (1.0 + q_orig)
                    f.q_div2[k, nf] = q_orig / (1.0 + q_orig)

    def _unmap_coupled(self) -> None:
        f0, f1 = self.frame
        t = self.tables
        amp0 = 0 if f0.amp_res else 1
        amp1 = 0 if f1.amp_res else 1
        f0.E_orig = np.zeros((64, 5))
        f1.E_orig = np.zeros((64, 5))
        for env in range(f0.L_E):
            for k in range(t.n[f0.f[env]]):
                exp0 = (f0.E[k, env] >> amp0) + 1
                exp1 = f1.E[k, env] >> amp1
                if 0 <= exp0 < 64 and 0 <= exp1 <= 24:
                    tmp = float(2.0 ** (exp0 + 6))
                    if amp0 and (f0.E[k, env] & 1):
                        tmp *= 1.414213562
                    pan = 1.0 / (1.0 + 2.0 ** (12.0 - exp1))
                    f0.E_orig[k, env] = tmp * pan
                    f1.E_orig[k, env] = tmp * (1.0 - pan)
        for f in (f0, f1):
            f.q_div = np.zeros((5, 2))
            f.q_div2 = np.zeros((5, 2))
        for nf in range(f0.L_Q):
            for k in range(t.n_q):
                q0, q1 = f0.Q[k, nf], f1.Q[k, nf]
                if 0 <= q0 <= 30 and 0 <= q1 <= 24:
                    q_orig = 2.0 ** (7 - q0)
                    pan = 1.0 / (1.0 + 2.0 ** (12.0 - q1))
                    ql = q_orig * pan
                    qr = q_orig * (1.0 - pan)
                    f0.q_div[k, nf] = 1.0 / (1.0 + ql)
                    f1.q_div[k, nf] = 1.0 / (1.0 + qr)
                    f0.q_div2[k, nf] = ql / (1.0 + ql)
                    f1.q_div2[k, nf] = qr / (1.0 + qr)

    # ----------------------------------------------------------- process
    def process(self, channels: list[np.ndarray]) -> list[np.ndarray]:
        """Run one frame. channels: per-channel 1024 float samples (int16
        scale). Returns per-channel 2048 samples at 2x rate (two channels
        from one when parametric stereo is active)."""
        out = []
        dont_process = self.frame_error or self.header_count == 0
        for ch, pcm in enumerate(channels):
            st = self.state[ch]
            # shift analysis history
            st.xsbr[:T_HFGEN] = st.xsbr[NTSR:NTSR + T_HFGEN]
            st.xsbr[T_HFGEN:] = 0.0
            X32 = st.qmfa.analyze(np.asarray(pcm, float))
            kx = 32 if dont_process else self.tables.kx
            st.xsbr[T_HFGEN:T_HFGEN + NTSR, :kx] = X32[:, :kx]
            if not dont_process:
                self._hf_generation(ch)
                self._hf_adjustment(ch)
            X = np.zeros((NTSR, 64), complex)
            if dont_process:
                X[:, :32] = st.xsbr[T_HFADJ:T_HFADJ + NTSR, :32]
            else:
                f = self.frame[ch]
                t0 = f.t_E[0]
                for sl in range(NTSR):
                    if sl < t0:
                        kx_b, m_b = self.kx_prev, self.m_prev
                    else:
                        kx_b, m_b = self.tables.kx, self.tables.m
                    X[sl, :kx_b + m_b] = st.xsbr[sl + T_HFADJ, :kx_b + m_b]
            if self.ps_used and not self.is_cpe:
                # parametric stereo: 6 lookahead slots of the lowest 5
                # bands feed the hybrid filter delay (ref
                # sbrDecodeSingleFramePS)
                X38 = np.zeros((NTSR + 6, 64), complex)
                X38[:NTSR] = X
                X38[NTSR:, :5] = st.xsbr[T_HFADJ + NTSR:T_HFADJ + NTSR + 6,
                                         :5]
                x_left, x_right = self.ps.decode(X38)
                if self._qmfs_right is None:
                    self._qmfs_right = QmfSynthesis64()
                out.append(st.qmfs.synthesize(x_left))
                out.append(self._qmfs_right.synthesize(x_right))
            else:
                out.append(st.qmfs.synthesize(X))
        # save prev data
        if not dont_process:
            t = self.tables
            self.kx_prev = t.kx
            self.m_prev = t.m
            for ch in range(len(channels)):
                st, f = self.state[ch], self.frame[ch]
                st.f_prev = f.f[f.L_E - 1]
                st.e_prev = f.E[:, f.L_E - 1].copy()
                st.q_prev = f.Q[:, f.L_Q - 1].copy()
                st.add_harmonic_prev = f.add_harmonic.copy()
                st.add_harmonic_flag_prev = f.add_harmonic_flag
                st.prev_env_is_short = 0 if f.l_A == f.L_E else -1
        self.frame_error = True  # needs a fresh parse() for the next frame
        return out

    # ----------------------------------------------------- HF generation
    _BW_TABLE = {1: 0.75, 2: 0.9, 3: 0.98}

    def _map_new_bw(self, invf: int, invf_prev: int) -> float:
        if invf == 1:
            return 0.6 if invf_prev == 0 else 0.75
        if invf in (2, 3):
            return self._BW_TABLE[invf]
        return 0.6 if invf_prev == 1 else 0.0

    def _chirp_factors(self, ch: int) -> np.ndarray:
        st = self.state[ch]
        f = self.frame[ch]
        bw_arr = np.zeros(5)
        for i in range(self.tables.n_q):
            bw = self._map_new_bw(f.invf[i], st.invf_prev[i])
            if bw < st.bw_prev[i]:
                bw = 0.75 * bw + 0.25 * st.bw_prev[i]
            else:
                bw = 0.90625 * bw + 0.09375 * st.bw_prev[i]
            if bw < 0.015625:
                bw = 0.0
            if bw >= 0.99609375:
                bw = 0.99609375
            bw_arr[i] = bw
            st.bw_prev[i] = bw
            st.invf_prev[i] = f.invf[i]
        return bw_arr

    def _pred_coef(self, x: np.ndarray) -> tuple[complex, complex]:
        """2nd-order covariance LPC over one subband's time samples
        x[T_HFADJ-2 : T_HFADJ+len] (len = NTSR+6)."""
        off = T_HFADJ
        n = NTSR + 6
        xj = x[off:off + n]
        xj1 = x[off - 1:off + n - 1]
        xj2 = x[off - 2:off + n - 2]
        r01 = np.sum(xj * np.conj(xj1))
        r02 = np.sum(xj * np.conj(xj2))
        r11 = np.sum(xj1 * np.conj(xj1)).real
        r12 = r01 - xj[-1] * np.conj(xj1[-1]) + x[off - 1] * np.conj(x[off - 2])
        r22 = r11 - (xj1[-1] * np.conj(xj1[-1])).real \
            + (x[off - 2] * np.conj(x[off - 2])).real
        det = r11 * r22 - (abs(r12) ** 2) / (1.0 + 1e-6)
        if det == 0:
            a1 = 0j
        else:
            a1 = (r01 * r12 - r02 * r11) / det
        if r11 == 0:
            a0 = 0j
        else:
            a0 = -(r01 + a1 * np.conj(r12)) / r11
        if abs(a0) ** 2 >= 16 or abs(a1) ** 2 >= 16:
            return 0j, 0j
        return a0, a1

    def _hf_generation(self, ch: int) -> None:
        st = self.state[ch]
        f = self.frame[ch]
        t = self.tables
        bw_arr = self._chirp_factors(ch)
        first = f.t_E[0]
        last = f.t_E[f.L_E]
        xsbr = st.xsbr
        k = t.kx
        for i, (n_sub, start_sub) in enumerate(
                zip(t.patch_no_subbands, t.patch_start_subband)):
            for x in range(n_sub):
                p = start_sub + x
                g = t.k_to_g[k]
                bw = bw_arr[g]
                if bw * bw > 0:
                    a0, a1 = self._pred_coef(xsbr[:, p])
                    a0 *= bw
                    a1 *= bw * bw
                    src = xsbr[:, p]
                    sl = np.arange(first + T_HFADJ, last + T_HFADJ)
                    xsbr[sl, k] = (src[sl] + a0 * src[sl - 1]
                                   + a1 * src[sl - 2])
                else:
                    xsbr[first + T_HFADJ:last + T_HFADJ, k] = \
                        xsbr[first + T_HFADJ:last + T_HFADJ, p]
                k += 1

    # ----------------------------------------------------- HF adjustment
    def _get_s_mapped(self, ch: int, env: int, band: int) -> int:
        f = self.frame[ch]
        st = self.state[ch]
        t = self.tables
        if f.f[env] == HI_RES:
            if env >= f.l_A or (st.add_harmonic_prev[band]
                                and st.add_harmonic_flag_prev):
                return int(f.add_harmonic[band])
            return 0
        minus = 1 if (t.n_high & 1) else 0
        lb = 2 * band - minus
        ub = 2 * (band + 1) - minus
        for b in range(lb, ub):
            if env >= f.l_A or (st.add_harmonic_prev[b]
                                and st.add_harmonic_flag_prev):
                if f.add_harmonic[b] == 1:
                    return 1
        return 0

    def _hf_adjustment(self, ch: int) -> None:
        f = self.frame[ch]
        # transient envelope index l_A (4.6.18.7.1)
        if f.frame_class == FIXFIX:
            f.l_A = -1
        elif f.frame_class == VARFIX:
            f.l_A = f.pointer - 1 if f.pointer > 1 else -1
        else:
            f.l_A = -1 if f.pointer == 0 else f.L_E + 1 - f.pointer
        e_curr = self._estimate_current_envelope(ch)
        g_lim, q_m_lim, s_m = self._calculate_gain(ch, e_curr)
        self._hf_assembly(ch, g_lim, q_m_lim, s_m)

    def _estimate_current_envelope(self, ch: int) -> np.ndarray:
        st = self.state[ch]
        f = self.frame[ch]
        t = self.tables
        m_count = t.m
        e_curr = np.zeros((m_count, f.L_E))
        mag2 = (np.abs(st.xsbr) ** 2)
        if self.interpol_freq:
            for env in range(f.L_E):
                lo, hi = f.t_E[env], f.t_E[env + 1]
                div = max(hi - lo, 1)
                e_curr[:, env] = mag2[lo + T_HFADJ:hi + T_HFADJ,
                                      t.kx:t.kx + m_count].sum(axis=0) / div
        else:
            for env in range(f.L_E):
                lo, hi = f.t_E[env], f.t_E[env + 1]
                res = t.f_res[f.f[env]]
                for p in range(t.n[f.f[env]]):
                    k_l, k_h = res[p], res[p + 1]
                    div = max((hi - lo) * (k_h - k_l), 1)
                    nrg = mag2[lo + T_HFADJ:hi + T_HFADJ, k_l:k_h].sum() / div
                    e_curr[k_l - t.kx:k_h - t.kx, env] = nrg
        return e_curr

    def _calculate_gain(self, ch: int, e_curr: np.ndarray):
        lim_gain_tab = [0.5, 1.0, 2.0, 1e10]
        f = self.frame[ch]
        st = self.state[ch]
        t = self.tables
        m_count = t.m
        g_lim = np.zeros((f.L_E, m_count))
        q_m_lim = np.zeros((f.L_E, m_count))
        s_m = np.zeros((f.L_E, m_count))
        f_lim = t.f_lim[self.limiter_bands]
        current_t_noise_band = 0
        for env in range(f.L_E):
            delta = 0 if (env == f.l_A or env == st.prev_env_is_short) else 1
            if (current_t_noise_band + 1 < f.L_Q
                    and f.t_E[env + 1] > f.t_Q[current_t_noise_band + 1]):
                current_t_noise_band += 1
            res = t.f_res[f.f[env]]
            current_f_noise_band = 0
            current_res_band = 0
            current_res_band2 = 0
            current_hi_res_band = 0
            s_mapped = self._get_s_mapped(ch, env, current_res_band2)
            for k in range(len(f_lim) - 1):
                ml1, ml2 = f_lim[k], f_lim[k + 1]
                acc1 = 0.0
                acc2 = 0.0
                crb = current_res_band
                for m in range(ml1, ml2):
                    if (m + t.kx) == res[crb + 1]:
                        crb += 1
                    acc1 += f.E_orig[crb, env]
                    acc2 += e_curr[m, env]
                current_res_band = crb
                g_max = min((EPS + acc1) / (EPS + acc2)
                            * lim_gain_tab[self.limiter_gains], 1e10)
                den = 0.0
                for m in range(ml1, ml2):
                    if (m + t.kx) == t.f_noise[current_f_noise_band + 1]:
                        current_f_noise_band += 1
                    if (m + t.kx) == res[current_res_band2 + 1]:
                        current_res_band2 += 1
                        s_mapped = self._get_s_mapped(ch, env,
                                                      current_res_band2)
                    if (m + t.kx) == t.f_high[current_hi_res_band + 1]:
                        current_hi_res_band += 1
                    s_index_mapped = 0
                    if (env >= f.l_A
                            or (st.add_harmonic_prev[current_hi_res_band]
                                and st.add_harmonic_flag_prev)):
                        mid = (t.f_high[current_hi_res_band + 1]
                               + t.f_high[current_hi_res_band]) >> 1
                        if (m + t.kx) == mid:
                            s_index_mapped = int(
                                f.add_harmonic[current_hi_res_band])
                    q_div = f.q_div[current_f_noise_band,
                                    current_t_noise_band]
                    q_div2 = f.q_div2[current_f_noise_band,
                                      current_t_noise_band]
                    e_orig = f.E_orig[current_res_band2, env]
                    q_m = e_orig * q_div2
                    if s_index_mapped == 0:
                        s_m[env, m] = 0.0
                    else:
                        s_m[env, m] = e_orig * q_div
                        den += s_m[env, m]
                    g = e_orig / (1.0 + e_curr[m, env])
                    if s_mapped == 0 and delta == 1:
                        g *= q_div
                    elif s_mapped == 1:
                        g *= q_div2
                    if g_max > g:
                        q_m_lim[env, m] = q_m
                        g_lim[env, m] = g
                    else:
                        q_m_lim[env, m] = q_m * g_max / g
                        g_lim[env, m] = g_max
                    den += e_curr[m, env] * g_lim[env, m]
                    if s_index_mapped == 0 and env != f.l_A:
                        den += q_m_lim[env, m]
                g_boost = min((acc1 + EPS) / (den + EPS), 2.51188643)
                for m in range(ml1, ml2):
                    g_lim[env, m] = np.sqrt(g_lim[env, m] * g_boost)
                    q_m_lim[env, m] = np.sqrt(q_m_lim[env, m] * g_boost)
                    if s_m[env, m] != 0:
                        s_m[env, m] = np.sqrt(s_m[env, m] * g_boost)
        return g_lim, q_m_lim, s_m

    _PHI = np.array([1 + 0j, 0 + 1j, -1 + 0j, 0 - 1j])
    _H_SMOOTH = np.array([0.03183050093751, 0.11516383427084,
                          0.21816949906249, 0.30150283239582,
                          0.33333333333333])

    def _hf_assembly(self, ch: int, g_lim, q_m_lim, s_m) -> None:
        st = self.state[ch]
        f = self.frame[ch]
        t = self.tables
        m_count = t.m
        if self.reset_flag:
            for n in range(4):
                st.g_temp[n][:m_count] = g_lim[0]
                st.q_temp[n][:m_count] = q_m_lim[0]
            st.gq_index = 4
            st.index_noise = 0
        f_index_noise = st.index_noise
        f_index_sine = st.psi_is
        V = T.NOISE_TABLE
        kx = t.kx
        rev = np.where(((np.arange(m_count) + kx) & 1) == 1, -1.0, 1.0)
        for env in range(f.L_E):
            no_noise = (env == f.l_A or env == st.prev_env_is_short)
            h_sl = 0 if (self.smoothing_mode == 1 or no_noise) else 4
            for sl in range(f.t_E[env], f.t_E[env + 1]):
                st.g_temp[st.gq_index][:m_count] = g_lim[env]
                st.q_temp[st.gq_index][:m_count] = q_m_lim[env]
                if h_sl != 0:
                    g_filt = np.zeros(m_count)
                    q_filt = np.zeros(m_count)
                    ri = st.gq_index
                    for n in range(5):
                        ri += 1
                        if ri >= 5:
                            ri -= 5
                        g_filt += st.g_temp[ri][:m_count] * self._H_SMOOTH[n]
                        q_filt += st.q_temp[ri][:m_count] * self._H_SMOOTH[n]
                else:
                    g_filt = st.g_temp[st.gq_index][:m_count].copy()
                    q_filt = st.q_temp[st.gq_index][:m_count].copy()
                q_filt = np.where((s_m[env] != 0) | no_noise, 0.0, q_filt)
                noise_idx = (f_index_noise + 1 + np.arange(m_count)) & 511
                f_index_noise = (f_index_noise + m_count) & 511
                row = st.xsbr[sl + T_HFADJ]
                row[kx:kx + m_count] = (g_filt * row[kx:kx + m_count]
                                        + q_filt * V[noise_idx])
                psi = s_m[env] * (self._PHI[f_index_sine].real
                                  + 1j * rev
                                  * self._PHI[f_index_sine].imag)
                row[kx:kx + m_count] += psi
                f_index_sine = (f_index_sine + 1) & 3
                st.gq_index += 1
                if st.gq_index >= 5:
                    st.gq_index = 0
        st.index_noise = f_index_noise
        st.psi_is = f_index_sine
