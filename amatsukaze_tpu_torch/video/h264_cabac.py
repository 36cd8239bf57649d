"""H.264 CABAC entropy decoding (ISO/IEC 14496-10 clause 9.3).

Arithmetic decoding engine + context-model machinery + the macroblock-layer
syntax parser for I/P/B slices (frame coding).  Reconstruction is shared
with the CAVLC path in h264_ref (_SliceCtx recon helpers); this module only
produces parsed symbols (mb types, modes, motion, residual blocks).

Binarisation structures follow clause 9.3.2/9.3.3 (ctxIdx assignments per
Table 9-39); all of it is held bit-exact against libavcodec on libx264
cabac=1 streams (tests/test_h264_decode.py).

The port's copy of amatsukaze_tpu/video/h264_cabac.py.
"""

from __future__ import annotations

from . import h264_tables as T

# ---------------------------------------------------------------------------
# significance-map context increments for 8x8 blocks (frame scan),
# Table 9-43: levelListIdx -> ctxIdxInc, 63 entries each.
# ---------------------------------------------------------------------------

SIG_COEFF_8x8 = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12,
)
# pinned empirically against libavcodec with crafted single-coefficient
# CABAC streams per scan position (tests/test_h264_decode.py)
LAST_COEFF_8x8 = (
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8,
)

# ctxIdxOffset deltas per ctxBlockCat (0 I16DC, 1 I16AC, 2 luma4x4,
# 3 chromaDC, 4 chromaAC); cat 5 (luma 8x8) has dedicated bases.
_CBF_OFF = (0, 4, 8, 12, 16)
_SIG_OFF = (0, 15, 29, 44, 47)
_ABS_OFF = (0, 10, 20, 30, 39)


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def init_contexts(slice_type_i: bool, cabac_init_idc: int, qp: int):
    """9.3.1.1: 1024 context models as [pStateIdx, valMPS] lists."""
    if slice_type_i:
        tab = T.CABAC_INIT_I
    else:
        tab = T.CABAC_INIT_PB[2048 * cabac_init_idc : 2048 * (cabac_init_idc + 1)]
    q = _clip3(0, 51, qp)
    states = []
    for i in range(1024):
        m, n = tab[2 * i], tab[2 * i + 1]
        pre = _clip3(1, 126, ((m * q) >> 4) + n)
        if pre <= 63:
            states.append([63 - pre, 0])
        else:
            states.append([pre - 64, 1])
    return states


class CabacEngine:
    """9.3.3.2 arithmetic decoding engine over an RBSP byte string."""

    __slots__ = ("data", "pos", "range_", "offset", "ctx")

    def __init__(self, data: bytes, bit_pos: int, states):
        # cabac_alignment_one_bit: slice data starts byte-aligned
        if bit_pos & 7:
            bit_pos += 8 - (bit_pos & 7)
        self.data = data
        self.pos = bit_pos
        self.ctx = states
        self.range_ = 510
        off = 0
        for _ in range(9):
            off = (off << 1) | self._bit()
        self.offset = off

    def _bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        byte = p >> 3
        if byte >= len(self.data):
            return 0
        return (self.data[byte] >> (7 - (p & 7))) & 1

    def decision(self, idx: int) -> int:
        st = self.ctx[idx]
        pstate = st[0]
        rng = self.range_
        lps = T.RANGE_LPS[4 * pstate + ((rng >> 6) & 3)]
        rng -= lps
        if self.offset >= rng:
            bit = 1 - st[1]
            self.offset -= rng
            rng = lps
            if pstate == 0:
                st[1] = 1 - st[1]
            st[0] = T.TRANS_IDX_LPS[pstate]
        else:
            bit = st[1]
            st[0] = T.TRANS_IDX_MPS[pstate]
        while rng < 256:
            rng <<= 1
            self.offset = (self.offset << 1) | self._bit()
        self.range_ = rng
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range_:
            self.offset -= self.range_
            return 1
        return 0

    def terminate(self) -> int:
        self.range_ -= 2
        if self.offset >= self.range_:
            return 1
        rng = self.range_
        while rng < 256:
            rng <<= 1
            self.offset = (self.offset << 1) | self._bit()
        self.range_ = rng
        return 0


class CabacSlice:
    """Macroblock-layer CABAC parser driving a h264_ref._SliceCtx."""

    def __init__(self, sl, rbsp: bytes, h):
        from . import h264_ref as HR
        self.HR = HR
        self.sl = sl                   # _SliceCtx
        self.pic = sl.pic
        self.h = h
        st_i = h.slice_type == HR.SLICE_I
        self.e = CabacEngine(
            rbsp, h.data_bit_pos,
            init_contexts(st_i, h.cabac_init_idc, h.slice_qp))
        self.prev_qp_delta_nz = 0
        # field pictures (PAFF) use the field residual context blocks
        self.field_pic = bool(getattr(sl.pic, "is_field_pic", False))

    # -- neighbour helpers -------------------------------------------------

    def _mb_nbr(self, mbx, mby):
        """Neighbour MB coords or None (availability = same slice)."""
        if mbx < 0 or mby < 0:
            return None
        if not self.sl._mb_avail(mbx, mby):
            return None
        return (mbx, mby)

    # -- mb_skip / mb types ------------------------------------------------

    def mb_skip_flag(self, mbx, mby) -> int:
        pic = self.pic
        base = 11 if self.h.slice_type == self.HR.SLICE_P else 24
        ctx = 0
        for n in (self._mb_nbr(mbx - 1, mby), self._mb_nbr(mbx, mby - 1)):
            if n is not None and not pic.mb_skip[n[1], n[0]]:
                ctx += 1
        return self.e.decision(base + ctx)

    def _intra_mb_type(self, ctx_base: int, intra_slice: bool,
                       mbx: int, mby: int) -> int:
        e = self.e
        pic = self.pic
        HR = self.HR
        base = ctx_base
        if intra_slice:
            ctx = 0
            for n in (self._mb_nbr(mbx - 1, mby), self._mb_nbr(mbx, mby - 1)):
                if n is not None and pic.mb_class[n[1], n[0]] in (HR.MB_I16,
                                                                 HR.MB_IPCM):
                    ctx += 1
            if e.decision(base + ctx) == 0:
                return 0
            base += 2
        else:
            if e.decision(base) == 0:
                return 0
        if e.terminate():
            return 25
        t = 1
        t += 12 * e.decision(base + 1)
        if e.decision(base + 2):
            t += 4 + 4 * e.decision(base + 2 + (1 if intra_slice else 0))
        off = 3 + (1 if intra_slice else 0)
        t += 2 * e.decision(base + off)
        t += e.decision(base + 3 + (2 if intra_slice else 0))
        return t

    def mb_type_i(self, mbx, mby) -> int:
        return self._intra_mb_type(3, True, mbx, mby)

    def mb_type_p(self, mbx, mby) -> int:
        e = self.e
        if e.decision(14):
            return 5 + self._intra_mb_type(17, False, mbx, mby)
        if e.decision(15) == 0:
            return 3 * e.decision(16)      # P_L0_16x16 / P_8x8
        return 2 - e.decision(17)          # P_L0_L0_8x16 / P_L0_L0_16x8

    def mb_type_b(self, mbx, mby) -> int:
        e = self.e
        pic = self.pic
        ctx = 0
        for n in (self._mb_nbr(mbx - 1, mby), self._mb_nbr(mbx, mby - 1)):
            if n is not None and not pic.mb_bdirect[n[1], n[0]]:
                ctx += 1
        if not e.decision(27 + ctx):
            return 0  # B_Direct_16x16
        if not e.decision(27 + 3):
            return 1 + e.decision(27 + 5)
        bits = e.decision(27 + 4) << 3
        bits |= e.decision(27 + 5) << 2
        bits |= e.decision(27 + 5) << 1
        bits |= e.decision(27 + 5)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23 + self._intra_mb_type(32, False, mbx, mby)
        if bits == 14:
            return 11
        if bits == 15:
            return 22
        bits = (bits << 1) | e.decision(27 + 5)
        return bits - 4

    def sub_mb_type_p(self) -> int:
        e = self.e
        if e.decision(21):
            return 0
        if not e.decision(22):
            return 1
        return 2 if e.decision(23) else 3

    def sub_mb_type_b(self) -> int:
        e = self.e
        if not e.decision(36):
            return 0
        if not e.decision(37):
            return 1 + e.decision(39)
        t = 3
        if e.decision(38):
            if e.decision(39):
                return 11 + e.decision(39)
            t += 4
        t += 2 * e.decision(39)
        t += e.decision(39)
        return t

    # -- intra modes, cbp, qp delta ---------------------------------------

    def intra_pred_mode(self, pred: int) -> int:
        e = self.e
        if e.decision(68):
            return pred
        rem = e.decision(69)
        rem |= e.decision(69) << 1
        rem |= e.decision(69) << 2
        return rem if rem < pred else rem + 1

    def chroma_pred_mode(self, mbx, mby) -> int:
        e = self.e
        pic = self.pic
        ctx = 0
        for n in (self._mb_nbr(mbx - 1, mby), self._mb_nbr(mbx, mby - 1)):
            if n is not None and pic.mb_chroma_mode[n[1], n[0]] != 0:
                ctx += 1
        if not e.decision(64 + ctx):
            return 0
        if not e.decision(67):
            return 1
        return 3 if e.decision(67) else 2

    def transform_size_8x8(self, mbx, mby) -> int:
        ctx = 0
        for n in (self._mb_nbr(mbx - 1, mby), self._mb_nbr(mbx, mby - 1)):
            if n is not None and self.pic.mb_tf8[n[1], n[0]]:
                ctx += 1
        return self.e.decision(399 + ctx)

    def _cbp_luma_bit(self, mbx, mby, b: int, cur_bits: int) -> int:
        """condTerm for neighbour 8x8 of luma cbp bin b (9.3.3.1.1.4)."""
        pic = self.pic

        def cond(nmbx, nmby, nb, within):
            if within:
                return 1 if not (cur_bits & (1 << nb)) else 0
            n = self._mb_nbr(nmbx, nmby)
            if n is None:
                return 0
            if pic.mb_class[n[1], n[0]] == self.HR.MB_IPCM:
                return 0
            return 1 if not (int(pic.mb_cbp[n[1], n[0]]) & (1 << nb)) else 0

        # left neighbour 8x8 of block b
        if b & 1:
            ca = cond(0, 0, b - 1, True)
        else:
            ca = cond(mbx - 1, mby, b + 1, False)
        # top neighbour 8x8
        if b & 2:
            cb = cond(0, 0, b - 2, True)
        else:
            cb = cond(mbx, mby - 1, b + 2, False)
        return self.e.decision(73 + ca + 2 * cb)

    def cbp(self, mbx, mby) -> int:
        bits = 0
        for b in range(4):
            bits |= self._cbp_luma_bit(mbx, mby, b, bits) << b
        # chroma
        pic = self.pic

        def cchroma(nmbx, nmby, want2):
            n = self._mb_nbr(nmbx, nmby)
            if n is None:
                return 0
            if pic.mb_class[n[1], n[0]] == self.HR.MB_IPCM:
                return 1
            cc = int(pic.mb_cbp[n[1], n[0]]) >> 4
            return 1 if (cc == 2 if want2 else cc != 0) else 0

        ca = cchroma(mbx - 1, mby, False)
        cb = cchroma(mbx, mby - 1, False)
        if self.e.decision(77 + ca + 2 * cb):
            ca = cchroma(mbx - 1, mby, True)
            cb = cchroma(mbx, mby - 1, True)
            chroma = 2 if self.e.decision(81 + ca + 2 * cb) else 1
        else:
            chroma = 0
        return bits | (chroma << 4)

    def mb_qp_delta(self) -> int:
        e = self.e
        if not e.decision(60 + (1 if self.prev_qp_delta_nz else 0)):
            self.prev_qp_delta_nz = 0
            return 0
        k = 1
        if e.decision(62):
            k = 2
            while k < 90 and e.decision(63):
                k += 1
        self.prev_qp_delta_nz = 1
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    # -- motion ------------------------------------------------------------

    def ref_idx(self, l: int, bx4: int, by4: int) -> int:
        e = self.e
        sl = self.sl
        pic = self.pic
        is_b = self.h.slice_type == self.HR.SLICE_B
        gx0 = sl._cur_mbx * 4 + bx4
        gy0 = sl._cur_mby * 4 + by4
        ctx = 0
        A = sl._mv_ref_at(gx0 - 1, gy0, l)
        if A[0] and A[1] > 0 and not (
                is_b and pic.cell_direct[gy0, gx0 - 1]):
            ctx += 1
        B = sl._mv_ref_at(gx0, gy0 - 1, l)
        if B[0] and B[1] > 0 and not (
                is_b and pic.cell_direct[gy0 - 1, gx0]):
            ctx += 2
        ref = 0
        while e.decision(54 + ctx):
            ref += 1
            if ref > 32:
                raise ValueError("bad ref_idx")
            ctx = (ctx >> 2) + 4
        return ref

    def _mvd_nbr_abs(self, l: int, gx: int, gy: int, comp: int) -> int:
        sl = self.sl
        pic = self.pic
        if gx < 0 or gy < 0 or gx >= pic.mb_w * 4 or gy >= pic.mb_h * 4:
            return 0
        mbx, mby = gx >> 2, gy >> 2
        if mbx == sl._cur_mbx and mby == sl._cur_mby:
            if self.HR._XY_TO_Z[(gx & 3, gy & 3)] >= sl._cur_z:
                return 0
        elif pic.mb_slice[mby, mbx] != sl.sid:
            return 0
        elif not (mby < sl._cur_mby
                  or (mby == sl._cur_mby and mbx < sl._cur_mbx)):
            return 0
        return abs(int(pic.mvd[l, gy, gx, comp]))

    def mvd(self, l: int, bx4: int, by4: int, comp: int) -> int:
        e = self.e
        sl = self.sl
        gx0 = sl._cur_mbx * 4 + bx4
        gy0 = sl._cur_mby * 4 + by4
        amvd = (self._mvd_nbr_abs(l, gx0 - 1, gy0, comp)
                + self._mvd_nbr_abs(l, gx0, gy0 - 1, comp))
        base = 40 if comp == 0 else 47
        ctx = 0 if amvd < 3 else (2 if amvd > 32 else 1)
        if not e.decision(base + ctx):
            return 0
        mvd = 1
        ctx = 3
        while mvd < 9 and e.decision(base + ctx):
            if mvd < 4:
                ctx += 1
            mvd += 1
        if mvd >= 9:
            k = 3
            while e.bypass():
                mvd += 1 << k
                k += 1
                if k > 24:
                    raise ValueError("bad mvd")
            while k:
                k -= 1
                mvd += e.bypass() << k
        return -mvd if e.bypass() else mvd

    # -- residual blocks ---------------------------------------------------

    def _cbf_nbr(self, cat: int, info, side: int) -> int:
        """condTermFlagN for coded_block_flag (9.3.3.1.1.9).
        info carries the block position; side 0 = A (left), 1 = B (top)."""
        pic = self.pic
        sl = self.sl
        HR = self.HR
        cur_intra = pic.is_intra(sl._cur_mbx, sl._cur_mby)
        if cat in (0,):  # luma DC: neighbour MB's luma DC (I16 only)
            nmbx = sl._cur_mbx - (1 if side == 0 else 0)
            nmby = sl._cur_mby - (0 if side == 0 else 1)
            n = self._mb_nbr(nmbx, nmby)
            if n is None:
                return 1 if cur_intra else 0
            cls = pic.mb_class[n[1], n[0]]
            if cls == HR.MB_IPCM:
                return 1
            if cls != HR.MB_I16:
                return 0
            return 1 if (pic.mb_dc_flag[n[1], n[0]] & 1) else 0
        if cat == 3:  # chroma DC
            comp = info
            nmbx = sl._cur_mbx - (1 if side == 0 else 0)
            nmby = sl._cur_mby - (0 if side == 0 else 1)
            n = self._mb_nbr(nmbx, nmby)
            if n is None:
                return 1 if cur_intra else 0
            cls = pic.mb_class[n[1], n[0]]
            if cls == HR.MB_IPCM:
                return 1
            return 1 if (pic.mb_dc_flag[n[1], n[0]] & (2 << comp)) else 0
        if cat in (1, 2):  # luma 4x4 / I16 AC: neighbour 4x4 cell
            gx, gy = info
            ngx = gx - (1 if side == 0 else 0)
            ngy = gy - (0 if side == 0 else 1)
            if ngx < 0 or ngy < 0:
                return 1 if cur_intra else 0
            nmbx, nmby = ngx >> 2, ngy >> 2
            if not sl._mb_avail(nmbx, nmby):
                return 1 if cur_intra else 0
            cls = pic.mb_class[nmby, nmbx]
            if cls == HR.MB_IPCM:
                return 1
            return int(pic.cbf_y[ngy, ngx])
        # cat 4: chroma AC, neighbour chroma cell
        comp, cx, cy = info
        ncx = cx - (1 if side == 0 else 0)
        ncy = cy - (0 if side == 0 else 1)
        if ncx < 0 or ncy < 0:
            return 1 if cur_intra else 0
        nmbx, nmby = ncx >> 1, ncy >> 1
        if not sl._mb_avail(nmbx, nmby):
            return 1 if cur_intra else 0
        cls = pic.mb_class[nmby, nmbx]
        if cls == HR.MB_IPCM:
            return 1
        return int(pic.cbf_c[comp, ncy, ncx])

    def residual(self, cat: int, maxcoeff: int, info=None):
        """Parse one residual block.  Returns scan-order coefficient list or
        None when coded_block_flag is 0 (cat != 5).  Caller updates cbf/nnz
        state arrays."""
        e = self.e
        if cat != 5:
            inc = (self._cbf_nbr(cat, info, 0)
                   + 2 * self._cbf_nbr(cat, info, 1))
            if not e.decision(85 + _CBF_OFF[cat] + inc):
                return None
        if cat == 5:
            sig_base = 436 if self.field_pic else 402
            last_base = 451 if self.field_pic else 417
            abs_base = 426
        else:
            sig_base = (277 if self.field_pic else 105) + _SIG_OFF[cat]
            last_base = (338 if self.field_pic else 166) + _SIG_OFF[cat]
            abs_base = 227 + _ABS_OFF[cat]
        coeffs = [0] * maxcoeff
        sig = [False] * maxcoeff
        last_idx = maxcoeff - 1
        for i in range(maxcoeff - 1):
            if cat == 5:
                s_inc = (SIG_COEFF_8x8_FIELD if self.field_pic
                         else SIG_COEFF_8x8)[i]
                l_inc = LAST_COEFF_8x8[i]
            elif cat == 3:
                s_inc = l_inc = min(i, 2)
            else:
                s_inc = l_inc = i
            if e.decision(sig_base + s_inc):
                sig[i] = True
                if e.decision(last_base + l_inc):
                    last_idx = i
                    break
        else:
            sig[maxcoeff - 1] = True
        if last_idx == maxcoeff - 1 and not sig[maxcoeff - 1]:
            sig[maxcoeff - 1] = True
        num_eq1 = 0
        num_gt1 = 0
        for pos in range(last_idx, -1, -1):
            if not sig[pos]:
                continue
            ctx0 = 0 if num_gt1 else min(4, 1 + num_eq1)
            if not e.decision(abs_base + ctx0):
                level = 1
            else:
                ctxn = abs_base + 5 + min(4 - (1 if cat == 3 else 0), num_gt1)
                level = 2
                while level < 15 and e.decision(ctxn):
                    level += 1
                if level == 15:
                    # UEG0 suffix, bypass
                    k = 0
                    while e.bypass():
                        level += 1 << k
                        k += 1
                        if k > 30:
                            raise ValueError("bad coeff level")
                    while k:
                        k -= 1
                        level += e.bypass() << k
            if level > 1:
                num_gt1 += 1
            else:
                num_eq1 += 1
            coeffs[pos] = -level if e.bypass() else level
        return coeffs

    def end_of_slice(self) -> int:
        return self.e.terminate()


# significance-map context increments for 8x8 blocks in FIELD-coded
# macroblocks (Table 9-43 field column); field MBs also use the distinct
# ctxIdxOffset blocks 277/338 (4x4 cats) and 436/451 (8x8) per Table 9-40.
SIG_COEFF_8x8_FIELD = (
    0, 1, 1, 2, 2, 3, 3, 4, 5, 6, 7, 7, 7, 8, 4, 5,
    6, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 11, 12, 11,
    9, 9, 10, 10, 8, 11, 12, 11, 9, 9, 10, 10, 8, 13, 13, 9,
    9, 10, 10, 8, 13, 13, 9, 9, 10, 10, 14, 14, 14, 14, 14,
)
