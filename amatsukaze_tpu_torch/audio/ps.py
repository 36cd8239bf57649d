"""Parametric Stereo (HE-AAC v2) decoder.

Completes the in-build AAC stack's parity with the reference's vendored
libfaad (PS_DEC build, libfaad/ps_dec.c, ps_syntax.c).
Implements ISO/IEC 14496-3 §8.6.4: PS bitstream parsing (IID/ICC/IPD/OPD
envelopes, delta decoding in time/frequency), the hybrid analysis
filterbank (13-tap modulated sub-subband split of the lowest QMF bands),
the transient-aware allpass decorrelator, and the 2x2 mixing/phase
synthesis producing a stereo QMF pair from the mono SBR output.

Normative data lives in ``ps_tables``. One ``PsDecoder`` per SBR element;
``decode(X)`` consumes the 38-slot x 64-band mono QMF matrix (32 frame
slots + 6 lookahead slots for the hybrid filter delay) and returns the
(X_left, X_right) pair for synthesis.

The port's copy of amatsukaze_tpu/audio/ps.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitReader
from . import ps_tables as T
from .sbr import _Huff

EXTENSION_ID_PS = 2

F_IID_DEF = _Huff(T.F_HUFF_IID_DEF)
T_IID_DEF = _Huff(T.T_HUFF_IID_DEF)
F_IID_FINE = _Huff(T.F_HUFF_IID_FINE)
T_IID_FINE = _Huff(T.T_HUFF_IID_FINE)
F_ICC = _Huff(T.F_HUFF_ICC)
T_ICC = _Huff(T.T_HUFF_ICC)
F_IPD = _Huff(T.F_HUFF_IPD)
T_IPD = _Huff(T.T_HUFF_IPD)
F_OPD = _Huff(T.F_HUFF_OPD)
T_OPD = _Huff(T.T_HUFF_OPD)

NR_IID_PAR = [10, 20, 34, 10, 20, 34, 0, 0]
NR_IPDOPD_PAR = [5, 11, 17, 5, 11, 17, 0, 0]
NR_ICC_PAR = [10, 20, 34, 10, 20, 34, 0, 0]
NUM_ENV_TAB = [[0, 1, 2, 4], [1, 2, 3, 4]]

NTSR = 32  # QMF subsamples per frame
HYBRID_DELAY = 6


# ---------------------------------------------------------------------------
# hybrid filterbank (8.6.4.6.1): 13-tap modulated FIR matrices
# ---------------------------------------------------------------------------

def _mirror(p7: np.ndarray) -> np.ndarray:
    """7 stored taps -> full symmetric 13-tap prototype."""
    return np.concatenate([p7, p7[-2::-1]])


def _complex_bank(p7: np.ndarray, nsub: int) -> np.ndarray:
    """Type-A bank: W[q, n] = p(n) * exp(j*2pi/nsub*(q+0.5)*(n-6))."""
    p = _mirror(p7)
    n = np.arange(13)
    q = np.arange(nsub)
    return p * np.exp(1j * 2.0 * np.pi / nsub
                      * np.outer(q + 0.5, n - 6.0))


def _real_bank2(p7: np.ndarray) -> np.ndarray:
    """Type-B 2-band real bank: W[0] = p(n), W[1] = p(n)*(-1)^(n-6)."""
    p = _mirror(p7)
    n = np.arange(13)
    return np.stack([p, p * ((-1.0) ** (n - 6))]).astype(complex)


W8_20 = _complex_bank(T.P8_13_20, 8)
W2_20 = _real_bank2(T.P2_13_20)
W12_34 = _complex_bank(T.P12_13_34, 12)
W8_34 = _complex_bank(T.P8_13_34, 8)
W4_34 = _complex_bank(T.P4_13_34, 4)

# per-QMF-band (bank, first hybrid channel) for both modes
HYBRID_BANKS_20 = [(W8_20, 0), (W2_20, 8), (W2_20, 10)]
HYBRID_BANKS_34 = [(W12_34, 0), (W8_34, 12), (W4_34, 20), (W4_34, 24),
                   (W4_34, 28)]


class _Hybrid:
    """Stateful hybrid analysis over the lowest QMF bands."""

    def __init__(self, use34: bool):
        self.banks = HYBRID_BANKS_34 if use34 else HYBRID_BANKS_20
        self.nbands = len(self.banks)
        self.nch = 32
        self.state = np.zeros((self.nbands, 12), complex)

    def analyze(self, X: np.ndarray) -> np.ndarray:
        """X[38, 64] -> X_hybrid[32, 32] (sub-subbands of bands 0..n)."""
        out = np.zeros((NTSR, self.nch), complex)
        for b, (W, ch0) in enumerate(self.banks):
            work = np.concatenate([
                self.state[b],
                X[HYBRID_DELAY:HYBRID_DELAY + NTSR, b],
            ])
            self.state[b] = work[NTSR:NTSR + 12]
            # sliding 13-tap windows: win[i, n] = work[i + n]
            win = np.lib.stride_tricks.sliding_window_view(work, 13)
            out[:, ch0:ch0 + W.shape[0]] = win[:NTSR] @ W.T
        return out

    def synthesize(self, X: np.ndarray, X_hybrid: np.ndarray) -> None:
        """Collapse sub-subbands back into X's low QMF bands (in place)."""
        for b, (W, ch0) in enumerate(self.banks):
            X[:NTSR, b] = X_hybrid[:, ch0:ch0 + W.shape[0]].sum(axis=1)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class PsDecoder:
    def __init__(self):
        self.header_read = False
        self.ps_data_available = False
        self.enable_iid = 0
        self.enable_icc = 0
        self.enable_ext = 0
        self.enable_ipdopd = 0
        self.iid_mode = 0
        self.icc_mode = 0
        self.ipd_mode = 0
        self.nr_iid_par = 0
        self.nr_icc_par = 0
        self.nr_ipdopd_par = 0
        self.use34 = False
        self.frame_class = 0
        self.num_env = 0
        self.border_position = [0] * 6
        self.iid_dt = [0] * 4
        self.icc_dt = [0] * 4
        self.ipd_dt = [0] * 4
        self.opd_dt = [0] * 4
        self.iid_index = np.zeros((5, 34), int)
        self.icc_index = np.zeros((5, 34), int)
        self.ipd_index = np.zeros((5, 17), int)
        self.opd_index = np.zeros((5, 17), int)
        self.iid_index_prev = np.zeros(34, int)
        self.icc_index_prev = np.zeros(34, int)
        self.ipd_index_prev = np.zeros(17, int)
        self.opd_index_prev = np.zeros(17, int)
        # runtime state
        self._hyb: _Hybrid | None = None
        self._hyb34 = None
        self.saved_delay = 0
        self.delay_ser_idx = [0, 0, 0]
        self.delay_subqmf = np.zeros((2, 32), complex)
        self.delay_qmf = np.zeros((2, 64), complex)
        self.delay_qmf_d = np.zeros((14, 64), complex)
        self.delay_d_idx = np.zeros(64, int)
        self.delay_subqmf_ser = [np.zeros((d, 32), complex)
                                 for d in T.DELAY_LENGTH_D]
        self.delay_qmf_ser = [np.zeros((d, 64), complex)
                              for d in T.DELAY_LENGTH_D]
        self.peak_decay_nrg = np.zeros(34)
        self.smooth_peak_decay_diff_nrg = np.zeros(34)
        self.p_prev = np.zeros(34)
        self.h_prev = np.zeros((4, 50), complex)  # h11, h12, h21, h22
        self.h_prev[0] = 1.0
        self.h_prev[1] = 1.0
        self.phase_hist = 0
        self.ipd_prev = np.zeros((20, 2), complex)
        self.opd_prev = np.zeros((20, 2), complex)

    # ------------------------------------------------------------- parsing
    def parse(self, r: BitReader) -> None:
        """ps_data() (8.6.4.2, ref ps_syntax.c:66-230)."""
        if r.read(1):  # header
            self.header_read = True
            self.use34 = False
            self.enable_iid = r.read(1)
            if self.enable_iid:
                self.iid_mode = r.read(3)
                self.nr_iid_par = NR_IID_PAR[self.iid_mode]
                self.nr_ipdopd_par = NR_IPDOPD_PAR[self.iid_mode]
                if self.iid_mode in (2, 5):
                    self.use34 = True
                self.ipd_mode = self.iid_mode
            self.enable_icc = r.read(1)
            if self.enable_icc:
                self.icc_mode = r.read(3)
                self.nr_icc_par = NR_ICC_PAR[self.icc_mode]
                if self.icc_mode in (2, 5):
                    self.use34 = True
            self.enable_ext = r.read(1)
        if not self.header_read:
            self.ps_data_available = False
            return
        self.frame_class = r.read(1)
        self.num_env = NUM_ENV_TAB[self.frame_class][r.read(2)]
        if self.frame_class:
            for n in range(1, self.num_env + 1):
                self.border_position[n] = r.read(5)
        if self.enable_iid:
            fine = self.iid_mode >= 3
            for n in range(self.num_env):
                self.iid_dt[n] = r.read(1)
                self._huff_data(r, self.iid_dt[n], self.nr_iid_par,
                                T_IID_FINE if fine else T_IID_DEF,
                                F_IID_FINE if fine else F_IID_DEF,
                                self.iid_index[n])
        if self.enable_icc:
            for n in range(self.num_env):
                self.icc_dt[n] = r.read(1)
                self._huff_data(r, self.icc_dt[n], self.nr_icc_par,
                                T_ICC, F_ICC, self.icc_index[n])
        if self.enable_ext:
            cnt = r.read(4)
            if cnt == 15:
                cnt += r.read(8)
            bits_left = 8 * cnt
            while bits_left > 7:
                start = r.pos
                ext_id = r.read(2)
                if ext_id == 0:
                    self.enable_ipdopd = r.read(1)
                    if self.enable_ipdopd:
                        for n in range(self.num_env):
                            self.ipd_dt[n] = r.read(1)
                            self._huff_data(r, self.ipd_dt[n],
                                            self.nr_ipdopd_par, T_IPD,
                                            F_IPD, self.ipd_index[n])
                            self.opd_dt[n] = r.read(1)
                            self._huff_data(r, self.opd_dt[n],
                                            self.nr_ipdopd_par, T_OPD,
                                            F_OPD, self.opd_index[n])
                    r.read(1)
                bits_left -= r.pos - start
            if bits_left > 0:
                r.read(bits_left)
        self.ps_data_available = True

    @staticmethod
    def _huff_data(r, dt, nr_par, t_huff, f_huff, out) -> None:
        huff = t_huff if dt else f_huff
        for n in range(nr_par):
            out[n] = huff.decode(r)

    # --------------------------------------------------------- data decode
    def _data_decode(self) -> None:
        """Delta decoding + envelope border fixup (ref ps_data_decode)."""
        if not self.ps_data_available:
            self.num_env = 0
        num_iid_steps = 15 if self.iid_mode >= 3 else 7
        for env in range(self.num_env):
            iid_prev = (self.iid_index_prev if env == 0
                        else self.iid_index[env - 1])
            icc_prev = (self.icc_index_prev if env == 0
                        else self.icc_index[env - 1])
            ipd_prev = (self.ipd_index_prev if env == 0
                        else self.ipd_index[env - 1])
            opd_prev = (self.opd_index_prev if env == 0
                        else self.opd_index[env - 1])
            self._delta_decode(
                self.enable_iid, self.iid_index[env], iid_prev,
                self.iid_dt[env], self.nr_iid_par,
                2 if self.iid_mode in (0, 3) else 1,
                -num_iid_steps, num_iid_steps)
            self._delta_decode(
                self.enable_icc, self.icc_index[env], icc_prev,
                self.icc_dt[env], self.nr_icc_par,
                2 if self.icc_mode in (0, 3) else 1, 0, 7)
            self._delta_modulo(
                self.enable_ipdopd, self.ipd_index[env], ipd_prev,
                self.ipd_dt[env], self.nr_ipdopd_par)
            self._delta_modulo(
                self.enable_ipdopd, self.opd_index[env], opd_prev,
                self.opd_dt[env], self.nr_ipdopd_par)
        if self.num_env == 0:
            self.num_env = 1
            self.iid_index[0] = (self.iid_index_prev if self.enable_iid
                                 else 0)
            self.icc_index[0] = (self.icc_index_prev if self.enable_icc
                                 else 0)
            self.ipd_index[0] = (self.ipd_index_prev if self.enable_ipdopd
                                 else 0)
            self.opd_index[0] = (self.opd_index_prev if self.enable_ipdopd
                                 else 0)
        self.iid_index_prev = self.iid_index[self.num_env - 1].copy()
        self.icc_index_prev = self.icc_index[self.num_env - 1].copy()
        self.ipd_index_prev = self.ipd_index[self.num_env - 1].copy()
        self.opd_index_prev = self.opd_index[self.num_env - 1].copy()
        self.ps_data_available = False

        if self.frame_class == 0:
            self.border_position[0] = 0
            for env in range(1, self.num_env):
                self.border_position[env] = (env * NTSR) // self.num_env
            self.border_position[self.num_env] = NTSR
        else:
            self.border_position[0] = 0
            if self.border_position[self.num_env] < NTSR:
                self.iid_index[self.num_env] = self.iid_index[
                    self.num_env - 1]
                self.icc_index[self.num_env] = self.icc_index[
                    self.num_env - 1]
                self.ipd_index[self.num_env] = self.ipd_index[
                    self.num_env - 1]
                self.opd_index[self.num_env] = self.opd_index[
                    self.num_env - 1]
                self.num_env += 1
                self.border_position[self.num_env] = NTSR
            for env in range(1, self.num_env):
                thr = NTSR - (self.num_env - env)
                if self.border_position[env] > thr:
                    self.border_position[env] = thr
                else:
                    thr = self.border_position[env - 1] + 1
                    if self.border_position[env] < thr:
                        self.border_position[env] = thr

        if self.use34:
            for env in range(self.num_env):
                if self.iid_mode not in (2, 5):
                    _map20to34(self.iid_index[env], 34)
                if self.icc_mode not in (2, 5):
                    _map20to34(self.icc_index[env], 34)
                if self.ipd_mode not in (2, 5):
                    _map20to34(self.ipd_index[env], 17)
                    _map20to34(self.opd_index[env], 17)

    @staticmethod
    def _delta_decode(enable, index, index_prev, dt, nr_par, stride,
                      min_i, max_i) -> None:
        if enable:
            if dt == 0:
                index[0] = np.clip(index[0], min_i, max_i)
                for i in range(1, nr_par):
                    index[i] = np.clip(index[i - 1] + index[i], min_i, max_i)
            else:
                for i in range(nr_par):
                    index[i] = np.clip(index_prev[i * stride] + index[i],
                                       min_i, max_i)
        else:
            index[:nr_par] = 0
        if stride == 2:
            for i in range(2 * nr_par - 1, 0, -1):
                index[i] = index[i >> 1]

    @staticmethod
    def _delta_modulo(enable, index, index_prev, dt, nr_par) -> None:
        if enable:
            if dt == 0:
                index[0] &= 7
                for i in range(1, nr_par):
                    index[i] = (index[i - 1] + index[i]) & 7
            else:
                for i in range(nr_par):
                    index[i] = (index_prev[i] + index[i]) & 7
        else:
            index[:nr_par] = 0

    # -------------------------------------------------------------- decode
    def decode(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """X[38, 64] mono -> (X_left[32, 64], X_right[32, 64])."""
        self._data_decode()
        if self.use34:
            group_border = T.GROUP_BORDER_34
            map_g2bk = T.MAP_GROUP2BK_34
            num_hybrid_groups = 32
            nr_par_bands = 34
            decay_cutoff = 5
        else:
            group_border = T.GROUP_BORDER_20
            map_g2bk = T.MAP_GROUP2BK_20
            num_hybrid_groups = 10
            nr_par_bands = 20
            decay_cutoff = 3
        num_groups = len(map_g2bk)
        if self._hyb is None or self._hyb34 != self.use34:
            self._hyb = _Hybrid(self.use34)
            self._hyb34 = self.use34

        Xh_left = self._hyb.analyze(X)
        if not self.use34:
            # group hybrid channels (8.6.4.6.1): fold 4->3, 5->2
            Xh_left[:, 3] += Xh_left[:, 4]
            Xh_left[:, 4] = 0
            Xh_left[:, 2] += Xh_left[:, 5]
            Xh_left[:, 5] = 0

        X_left = X[:NTSR].copy()
        X_right = np.zeros_like(X_left)
        Xh_right = np.zeros_like(Xh_left)

        phi_sub = (T.PHI_FRACT_SUBQMF34 if self.use34
                   else T.PHI_FRACT_SUBQMF20)
        q_sub = (T.Q_FRACT_ALLPASS_SUBQMF34 if self.use34
                 else T.Q_FRACT_ALLPASS_SUBQMF20)

        # ---- transient energy per parameter band ------------------------
        P = np.zeros((NTSR, 34))
        for gr in range(num_groups):
            bk = map_g2bk[gr] & ~T.NEGATE_IPD_MASK
            if gr < num_hybrid_groups:
                sbs = [group_border[gr]]
                src = Xh_left
            else:
                sbs = range(group_border[gr], group_border[gr + 1])
                src = X_left
            for sb in sbs:
                P[:, bk] += np.abs(src[:, sb].real) ** 2 \
                    + np.abs(src[:, sb].imag) ** 2
        g_transient = np.ones((NTSR, 34))
        gamma = 1.5
        for bk in range(nr_par_bands):
            for n in range(NTSR):
                self.peak_decay_nrg[bk] *= T.ALPHA_DECAY
                if self.peak_decay_nrg[bk] < P[n, bk]:
                    self.peak_decay_nrg[bk] = P[n, bk]
                sm = self.smooth_peak_decay_diff_nrg[bk]
                sm += (self.peak_decay_nrg[bk] - P[n, bk] - sm) \
                    * T.ALPHA_SMOOTH
                self.smooth_peak_decay_diff_nrg[bk] = sm
                nrg = self.p_prev[bk]
                nrg += (P[n, bk] - nrg) * T.ALPHA_SMOOTH
                self.p_prev[bk] = nrg
                if sm * gamma > nrg:
                    g_transient[n, bk] = nrg / (sm * gamma)

        # ---- decorrelator ------------------------------------------------
        self._decorrelate(Xh_left, Xh_right, X_left, X_right,
                          group_border, map_g2bk, num_hybrid_groups,
                          num_groups, decay_cutoff, phi_sub, q_sub,
                          g_transient)

        # ---- mixing / phase ----------------------------------------------
        self._mix_phase(Xh_left, Xh_right, X_left, X_right, group_border,
                        map_g2bk, num_hybrid_groups, num_groups)

        self._hyb.synthesize(X_left, Xh_left)
        self._hyb.synthesize(X_right, Xh_right)
        return X_left, X_right

    def _decorrelate(self, Xh_left, Xh_right, X_left, X_right,
                     group_border, map_g2bk, num_hybrid_groups, num_groups,
                     decay_cutoff, phi_sub, q_sub, g_transient) -> None:
        na = T.NR_ALLPASS_BANDS
        for gr in range(num_groups):
            bk = map_g2bk[gr] & ~T.NEGATE_IPD_MASK
            hybrid = gr < num_hybrid_groups
            if hybrid:
                sbs = [group_border[gr]]
            else:
                sbs = range(group_border[gr], group_border[gr + 1])
            for sb in sbs:
                if hybrid or sb <= decay_cutoff:
                    g_decay = 1.0
                else:
                    decay = decay_cutoff - sb
                    g_decay = max(0.0, 1.0 + T.DECAY_SLOPE * decay)
                ga = g_decay * T.FILTER_A
                temp_delay = self.saved_delay
                temp_ser = list(self.delay_ser_idx)
                if not hybrid and sb > na:
                    # plain delay of D(sb) slots
                    d = 14 if sb < T.SHORT_DELAY_BAND else 1
                    for n in range(NTSR):
                        idx = self.delay_d_idx[sb]
                        r0 = self.delay_qmf_d[idx, sb]
                        self.delay_qmf_d[idx, sb] = X_left[n, sb]
                        self.delay_d_idx[sb] = (idx + 1) % d
                        X_right[n, sb] = g_transient[n, bk] * r0
                    continue
                if hybrid:
                    delay2 = self.delay_subqmf
                    sers = self.delay_subqmf_ser
                    phi = phi_sub[sb]
                    qf = q_sub[sb]
                else:
                    delay2 = self.delay_qmf
                    sers = self.delay_qmf_ser
                    phi = T.PHI_FRACT_QMF[sb]
                    qf = T.Q_FRACT_ALLPASS_QMF[sb]
                for n in range(NTSR):
                    x_in = (Xh_left if hybrid else X_left)[n, sb]
                    tmp0 = delay2[temp_delay, sb]
                    delay2[temp_delay, sb] = x_in
                    r0 = tmp0 * phi
                    for m in range(3):
                        tmp0 = sers[m][temp_ser[m], sb]
                        tmp = tmp0 * qf[m] - ga[m] * r0
                        sers[m][temp_ser[m], sb] = r0 + ga[m] * tmp
                        r0 = tmp
                    r0 *= g_transient[n, bk]
                    if hybrid:
                        Xh_right[n, sb] = r0
                    else:
                        X_right[n, sb] = r0
                    temp_delay = (temp_delay + 1) % 2
                    for m in range(3):
                        temp_ser[m] = (temp_ser[m] + 1) \
                            % T.DELAY_LENGTH_D[m]
        self.saved_delay = (self.saved_delay + NTSR) % 2
        for m in range(3):
            self.delay_ser_idx[m] = (self.delay_ser_idx[m] + NTSR) \
                % T.DELAY_LENGTH_D[m]

    def _mixing_matrix(self, env: int, bk: int):
        """h11, h12, h21, h22 (real parts; 8.6.4.6.2)."""
        fine = self.iid_mode >= 3
        steps = 15 if fine else 7
        iid = int(self.iid_index[env][bk])
        icc = int(self.icc_index[env][bk])
        if self.icc_mode < 3:
            sf = T.SF_IID_FINE if fine else T.SF_IID_NORMAL
            c_1 = sf[steps + iid]
            c_2 = sf[steps - iid]
            cosa = np.cos(T.ALPHAS[icc])
            sina = np.sin(T.ALPHAS[icc])
            betas = T.BETAS_FINE if fine else T.BETAS_NORMAL
            beta = betas[abs(iid)][icc] * (1 if iid >= 0 else -1)
            cosb = np.cos(beta)
            sinb = np.sin(beta)
            h11 = c_2 * (cosb * cosa - sinb * sina)
            h12 = c_1 * (cosb * cosa + sinb * sina)
            h21 = c_2 * (sinb * cosa + cosb * sina)
            h22 = c_1 * (sinb * cosa - cosb * sina)
        else:
            alphas = T.ALPHAS_B_FINE if fine else T.ALPHAS_B_NORMAL
            gammas = T.GAMMAS_B_FINE if fine else T.GAMMAS_B_NORMAL
            alpha = alphas[steps + iid][icc]
            gamma = gammas[steps + iid][icc]
            rt2 = np.sqrt(2.0)
            h11 = rt2 * np.cos(alpha) * np.cos(gamma)
            h12 = rt2 * np.sin(alpha) * np.cos(gamma)
            h21 = -rt2 * np.cos(alpha) * np.sin(gamma)
            h22 = rt2 * np.sin(alpha) * np.sin(gamma)
        return h11, h12, h21, h22

    def _mix_phase(self, Xh_left, Xh_right, X_left, X_right, group_border,
                   map_g2bk, num_hybrid_groups, num_groups) -> None:
        if self.ipd_mode in (0, 3):
            nr_ipdopd_par = 11
        else:
            nr_ipdopd_par = self.nr_ipdopd_par
        for gr in range(num_groups):
            bk = map_g2bk[gr] & ~T.NEGATE_IPD_MASK
            negate_ipd = bool(map_g2bk[gr] & T.NEGATE_IPD_MASK)
            hybrid = gr < num_hybrid_groups
            if hybrid:
                sbs = slice(group_border[gr], group_border[gr] + 1)
            else:
                sbs = slice(group_border[gr], group_border[gr + 1])
            phase_hist = self.phase_hist
            for env in range(self.num_env):
                h = np.array(self._mixing_matrix(env, bk), complex)
                use_ipd = self.enable_ipdopd and bk < nr_ipdopd_par
                if use_ipd:
                    i = phase_hist
                    temp_l = 0.25 * self.ipd_prev[bk][i]
                    temp_r = 0.25 * self.opd_prev[bk][i]
                    cur_ipd = (T.IPDOPD_COS[self.ipd_index[env][bk]]
                               + 1j * T.IPDOPD_SIN[self.ipd_index[env][bk]])
                    cur_opd = (T.IPDOPD_COS[self.opd_index[env][bk]]
                               + 1j * T.IPDOPD_SIN[self.opd_index[env][bk]])
                    self.ipd_prev[bk][i] = cur_ipd
                    self.opd_prev[bk][i] = cur_opd
                    temp_l += cur_ipd
                    temp_r += cur_opd
                    i = 1 if i == 0 else i - 1
                    temp_l += 0.5 * self.ipd_prev[bk][i]
                    temp_r += 0.5 * self.opd_prev[bk][i]
                    opd = np.angle(temp_r)
                    ipd = np.angle(temp_l)
                    phase_left = np.exp(1j * opd)
                    phase_right = np.exp(1j * (opd - ipd))
                    h = h.real * np.array([phase_left, phase_right,
                                           phase_left, phase_right])
                    if negate_ipd:
                        h = np.conj(h)
                lo = self.border_position[env]
                hi = self.border_position[env + 1]
                length = max(hi - lo, 1)
                h_prev = self.h_prev[:, gr].copy()
                delta = (h - h_prev) / length
                self.h_prev[:, gr] = h
                # interpolated H per slot: H(n) = h_prev + (n-lo+1)*delta
                steps = np.arange(1, hi - lo + 1)[:, None]
                Hn = h_prev[None, :] + steps * delta[None, :]
                src_l = (Xh_left if hybrid else X_left)[lo:hi, sbs]
                src_r = (Xh_right if hybrid else X_right)[lo:hi, sbs]
                out_l = (Hn[:, 0, None] * src_l + Hn[:, 2, None] * src_r)
                out_r = (Hn[:, 1, None] * src_l + Hn[:, 3, None] * src_r)
                if hybrid:
                    Xh_left[lo:hi, sbs] = out_l
                    Xh_right[lo:hi, sbs] = out_r
                else:
                    X_left[lo:hi, sbs] = out_l
                    X_right[lo:hi, sbs] = out_r
                phase_hist = (phase_hist + 1) % 2
        self.phase_hist = (self.phase_hist + self.num_env) % 2


def _map20to34(index: np.ndarray, bins: int) -> None:
    """Spread 20-band (or 11-band ipd) parameters over the 34-band grid
    (8.6.4.6.3). Maps from the ORIGINAL values: the reference decoder's
    in-place forward expansion reads already-overwritten entries, which
    collapses distinct parameters; the spec mapping is per source index."""
    src = index.copy()
    m = [0, -1, 1, 2, -2, 3, 4, 4, 5, 5, 6, 7, 8, 8, 9, 9, 10,
         11, 12, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 18, 18,
         19, 19]
    for i in range(min(bins, 34)):
        if m[i] == -1:
            index[i] = (src[0] + src[1]) // 2
        elif m[i] == -2:
            index[i] = (src[2] + src[3]) // 2
        else:
            index[i] = src[m[i]]
