"""MBAFF (macroblock-adaptive frame/field) slice decoding for the
in-build H.264 oracle (ISO/IEC 14496-10 clauses 6.4.10 neighbour
derivation, 7.3.4/7.4.4 MB-pair syntax, 8.3/8.5 with field scans).

x264's interlaced mode emits MBAFF frames (frame_mbs_only=0,
mb_adaptive_frame_field=1, field_pic_flag=0), which is how broadcast
interlaced H.264 is coded by software encoders; every stage here is
held bit-exact against libavcodec on such streams
(tests/test_h264_mbaff.py).  The reference project decodes via FFmpeg
(reference Amatsukaze/ReaderWriterFFmpeg.hpp) — this is an independent
implementation.

Core idea: the spec's Table 6-4 MBAFF neighbour derivation is exactly
the geometry of per-MB *line maps* — a frame MB covers 16 consecutive
picture lines, a field MB covers every other line of its 32-line pair
band — extended beyond the MB bounds for negative coordinates.  The
neighbour of local (xN, yN) is the macroblock whose own line map
contains the absolute line, selected inside the containing pair by that
pair's field/frame status.  All neighbour logic below (intra
availability and samples, prediction-mode inference, CAVLC nC, motion
prediction, CABAC contexts) goes through this single derivation.

State is per-mbAddr (decode order: pair raster, top then bottom) rather
than the progressive decoder's global 4x4 grids.

The port's copy of amatsukaze_tpu/video/h264_mbaff.py.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import BitReader, EOFError_
from . import h264_tables as T
from . import h264_ref as HR


class MbaffState:
    """Per-picture MBAFF side state, attached as pic.mbaff."""

    def __init__(self, pic):
        mb_w = pic.mb_w
        mb_h = pic.mb_h          # in MB rows (2 per pair)
        n = mb_w * mb_h
        self.mb_w, self.mb_h = mb_w, mb_h
        self.n_pairs = n // 2
        self.pair_rows = mb_h // 2
        self.field_flag = np.zeros(self.n_pairs, np.int8)
        self.slice_id = np.full(n, -1, np.int32)
        self.mb_class = np.zeros(n, np.int8)
        self.mb_qp = np.zeros(n, np.int32)
        self.mb_cbp = np.zeros(n, np.int32)
        self.mb_tf8 = np.zeros(n, np.int8)
        self.mb_dc_flag = np.zeros(n, np.int8)
        self.mb_skip = np.zeros(n, np.int8)
        self.mb_bdirect = np.zeros(n, np.int8)
        self.mb_chroma_mode = np.zeros(n, np.int8)
        self.mb_alpha_off = np.zeros(n, np.int32)
        self.mb_beta_off = np.zeros(n, np.int32)
        self.mb_disable = np.zeros(n, np.int32)
        # per-MB 4x4 raster cells (cell = 4*y + x)
        self.i4_modes = np.full((n, 16), 2, np.int8)
        self.nnz_y = np.zeros((n, 16), np.int8)
        self.nnz_c = np.zeros((n, 2, 4), np.int8)
        self.cbf_y = np.zeros((n, 16), np.int8)
        self.cbf_c = np.zeros((n, 2, 4), np.int8)
        # motion (P/B stages): quarter-pel in the MB's own frame/field units
        self.mv = np.zeros((n, 2, 16, 2), np.int32)
        self.ref_idx = np.full((n, 2, 16), -1, np.int32)
        self.ref_id = np.full((n, 2, 16), -1, np.int64)
        self.mvd = np.zeros((n, 2, 16, 2), np.int32)
        self.cell_direct = np.zeros((n, 16), np.int8)

    # -- addressing ---------------------------------------------------------

    def pair_of(self, addr: int) -> int:
        return addr >> 1

    def is_bottom(self, addr: int) -> bool:
        return bool(addr & 1)

    def pair_xy(self, addr: int):
        p = addr >> 1
        return p % self.mb_w, p // self.mb_w

    def is_field(self, addr: int) -> bool:
        return bool(self.field_flag[addr >> 1])

    def is_intra(self, addr: int) -> bool:
        return self.mb_class[addr] in (HR.MB_I4, HR.MB_I16, HR.MB_IPCM,
                                       HR.MB_I8)

    # -- sample line maps ---------------------------------------------------
    # luma: pair band = 32 lines at pairY*32; chroma: 16 lines at pairY*16.

    def luma_y(self, addr: int, y: int) -> int:
        """Absolute luma line of local row y (valid for negative y too)."""
        px, py = self.pair_xy(addr)
        if self.is_field(addr):
            return py * 32 + (addr & 1) + 2 * y
        return py * 32 + 16 * (addr & 1) + y

    def chroma_y(self, addr: int, y: int) -> int:
        px, py = self.pair_xy(addr)
        if self.is_field(addr):
            return py * 16 + (addr & 1) + 2 * y
        return py * 16 + 8 * (addr & 1) + y

    def luma_x0(self, addr: int) -> int:
        return (self.pair_of(addr) % self.mb_w) * 16

    def ystep(self, addr: int) -> int:
        return 2 if self.is_field(addr) else 1


class MbaffSlice:
    """Decode one MBAFF slice into pic (+ pic.mbaff state)."""

    def __init__(self, dec, pic, h, sps, pps, slice_id: int):
        self.dec = dec
        self.pic = pic
        self.h, self.sps, self.pps = h, sps, pps
        self.sid = slice_id
        if getattr(pic, "mbaff", None) is None:
            pic.mbaff = MbaffState(pic)
        self.st: MbaffState = pic.mbaff
        self.qp = h.slice_qp
        mats = pps.scaling_matrix
        if mats is None:
            self.w4 = [HR._FLAT16] * 6
            self.w8 = [HR._FLAT64] * 2
        else:
            self.w4 = [tuple(HR._zz_to_raster(mats[i], 16)) for i in range(6)]
            if len(mats) > 6:
                self.w8 = [tuple(HR._zz_to_raster(mats[i], 64))
                           for i in (6, 7)]
            else:
                self.w8 = [HR._FLAT64] * 2
        self._dq = {}
        self.cur_addr = 0
        self.cur_z = 0            # decoded-4x4 watermark within current MB
        self.ref_l0 = []          # frame reference lists (P/B stages)
        self.ref_l1 = []
        self._pred_chroma = None
        self._direct_cache = None

    # -- scan selection -----------------------------------------------------

    def scan4(self, addr: int):
        return (HR.FIELD_SCAN_4x4 if self.st.is_field(addr)
                else HR.ZIGZAG_4x4)

    def scan8(self, addr: int):
        return (HR.FIELD_SCAN_8x8 if self.st.is_field(addr)
                else HR.ZIGZAG_8x8)

    # -- dequant ------------------------------------------------------------

    def _dq4(self, qp, list_idx):
        key = (qp, list_idx)
        t = self._dq.get(key)
        if t is None:
            t = HR._dequant4_tab(qp, self.w4[list_idx])
            self._dq[key] = t
        return t

    def _dq8(self, qp, list_idx):
        key = (qp, 8, list_idx)
        t = self._dq.get(key)
        if t is None:
            t = HR._dequant8_tab(qp, self.w8[list_idx])
            self._dq[key] = t
        return t

    # -- neighbour derivation (6.4.10, geometric form) ----------------------

    def _addr_at(self, pair_x: int, pair_y: int, line: int,
                 chroma: bool) -> tuple:
        """(mbAddr, local_row) of the MB of pair (pair_x, pair_y) whose
        line map contains absolute line `line`."""
        st = self.st
        band = 16 if chroma else 32
        pair = pair_y * st.mb_w + pair_x
        local = line - pair_y * band
        if st.field_flag[pair]:
            addr = 2 * pair + (local & 1)
            return addr, local >> 1
        half = band // 2
        if local < half:
            return 2 * pair, local
        return 2 * pair + 1, local - half

    def _nbr(self, addr: int, xN: int, yN: int, chroma: bool):
        """Neighbour of local (xN, yN) of MB `addr` -> (addrN, xW, yW) or
        None when outside the picture / not yet decoded / other slice.
        Covers xN in [-1, maxW], yN in [-1, maxH-1] (A/B/C/D + in-MB)."""
        st = self.st
        maxW = 8 if chroma else 16
        px, py = st.pair_xy(addr)
        xAbs = px * maxW + xN
        if xAbs < 0 or xAbs >= st.mb_w * maxW:
            return None
        line = (st.chroma_y(addr, yN) if chroma else st.luma_y(addr, yN))
        band = 16 if chroma else 32
        if line < 0 or line >= st.pair_rows * band:
            return None
        addrN, yW = self._addr_at(xAbs // maxW, line // band, line, chroma)
        if addrN != addr:
            if addrN >= self.cur_addr:
                return None          # not yet decoded (raster/pair order)
            if st.slice_id[addrN] != self.sid:
                return None
        return addrN, xAbs % maxW, yW

    def _nbr_intra(self, addr: int, xN: int, yN: int, chroma: bool):
        """Like _nbr but with constrained_intra_pred filtering; in-MB
        locations obey the cur_z watermark (decode order of 4x4 blocks)."""
        r = self._nbr(addr, xN, yN, chroma)
        if r is None:
            return None
        addrN, xW, yW = r
        if addrN == addr:
            if not chroma and HR._XY_TO_Z[(xW >> 2, yW >> 2)] >= self.cur_z:
                return None
            return r
        if self.pps.constrained_intra_pred and not self.st.is_intra(addrN):
            return None
        return r

    # -- sample fetch through a neighbour result ---------------------------

    def _luma_sample(self, addrN: int, xW: int, yW: int) -> int:
        st = self.st
        return int(self.pic.Y[st.luma_y(addrN, yW),
                              st.luma_x0(addrN) + xW])

    def _chroma_sample(self, plane, addrN: int, xW: int, yW: int) -> int:
        st = self.st
        return int(plane[st.chroma_y(addrN, yW),
                         (st.pair_of(addrN) % st.mb_w) * 8 + xW])

    # -- CAVLC nC (9.2.1 with 6.4.10 neighbours) ---------------------------

    def _nc_luma(self, addr: int, x4: int, y4: int) -> int:
        na = nb = None
        r = self._nbr(addr, 4 * x4 - 1, 4 * y4, False)
        if r is not None:
            addrN, xW, yW = r
            na = int(self.st.nnz_y[addrN, 4 * (yW >> 2) + (xW >> 2)])
        r = self._nbr(addr, 4 * x4, 4 * y4 - 1, False)
        if r is not None:
            addrN, xW, yW = r
            nb = int(self.st.nnz_y[addrN, 4 * (yW >> 2) + (xW >> 2)])
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _nc_chroma(self, addr: int, comp: int, cx: int, cy: int) -> int:
        # cx, cy: 4x4 cell coords within the 8x8 chroma block (0..1)
        na = nb = None
        r = self._nbr(addr, 4 * cx - 1, 4 * cy, True)
        if r is not None:
            addrN, xW, yW = r
            na = int(self.st.nnz_c[addrN, comp, 2 * (yW >> 2) + (xW >> 2)])
        r = self._nbr(addr, 4 * cx, 4 * cy - 1, True)
        if r is not None:
            addrN, xW, yW = r
            nb = int(self.st.nnz_c[addrN, comp, 2 * (yW >> 2) + (xW >> 2)])
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    # -- intra mode inference (8.3.1.1 via 6.4.10) -------------------------

    def _i4_mode_nbr(self, addr: int, xN: int, yN: int):
        r = self._nbr_intra(addr, xN, yN, False)
        if r is None:
            return None
        addrN, xW, yW = r
        if addrN == addr:
            return int(self.st.i4_modes[addr, 4 * (yW >> 2) + (xW >> 2)])
        cls = self.st.mb_class[addrN]
        if cls in (HR.MB_I4, HR.MB_I8):
            return int(self.st.i4_modes[addrN, 4 * (yW >> 2) + (xW >> 2)])
        return 2

    # -- MB bookkeeping -----------------------------------------------------

    def _mark_mb(self, addr: int) -> None:
        st, h = self.st, self.h
        st.slice_id[addr] = self.sid
        st.mb_alpha_off[addr] = h.slice_alpha_c0_offset_div2 * 2
        st.mb_beta_off[addr] = h.slice_beta_offset_div2 * 2
        st.mb_disable[addr] = h.disable_deblocking_filter_idc

    # -- I macroblocks (CAVLC) ---------------------------------------------

    def decode_intra_mb_cavlc(self, r: BitReader, addr: int,
                              imb: int) -> None:
        if imb == 25:
            self._decode_ipcm(r, addr)
            return
        if imb == 0:
            self._decode_i4x4(r, addr)
        else:
            self._decode_i16x16(r, addr, imb - 1)

    def _decode_ipcm(self, r: BitReader, addr: int) -> None:
        st, pic = self.st, self.pic
        r.byte_align()
        x0 = st.luma_x0(addr)
        for yy in range(16):
            ly = st.luma_y(addr, yy)
            for xx in range(16):
                pic.Y[ly, x0 + xx] = r.read(8)
        cx0 = (st.pair_of(addr) % st.mb_w) * 8
        for plane in (pic.U, pic.V):
            for yy in range(8):
                cy = st.chroma_y(addr, yy)
                for xx in range(8):
                    plane[cy, cx0 + xx] = r.read(8)
        st.mb_class[addr] = HR.MB_IPCM
        st.nnz_y[addr, :] = 16
        st.nnz_c[addr, :, :] = 16
        st.cbf_y[addr, :] = 1
        st.cbf_c[addr, :, :] = 1
        st.mb_qp[addr] = 0
        st.mb_cbp[addr] = 0x2F

    def _read_i4x4_modes(self, r: BitReader, addr: int):
        st = self.st
        modes = [2] * 16
        for k in range(16):
            x4, y4 = HR._Z_TO_XY[k]
            self.cur_z = k
            ma = self._i4_mode_nbr(addr, 4 * x4 - 1, 4 * y4)
            mb_ = self._i4_mode_nbr(addr, 4 * x4, 4 * y4 - 1)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            if r.read(1):
                mode = pred
            else:
                rem = r.read(3)
                mode = rem if rem < pred else rem + 1
            modes[k] = mode
            st.i4_modes[addr, 4 * y4 + x4] = mode
        return modes

    def _read_i8x8_modes(self, r: BitReader, addr: int):
        st = self.st
        modes = [2] * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            self.cur_z = HR._XY_TO_Z[(bx, by)]
            ma = self._i4_mode_nbr(addr, 4 * bx - 1, 4 * by)
            mb_ = self._i4_mode_nbr(addr, 4 * bx, 4 * by - 1)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            if r.read(1):
                mode = pred
            else:
                rem = r.read(3)
                mode = rem if rem < pred else rem + 1
            modes[b] = mode
            for dy in range(2):
                for dx in range(2):
                    st.i4_modes[addr, 4 * (by + dy) + bx + dx] = mode
        return modes

    def _decode_i4x4(self, r: BitReader, addr: int) -> None:
        st, pps = self.st, self.pps
        tf8 = 0
        if pps.transform_8x8_mode:
            tf8 = r.read(1)
        if tf8:
            self._decode_i8x8_mb(r, addr)
            return
        st.mb_class[addr] = HR.MB_I4
        modes = self._read_i4x4_modes(r, addr)
        chroma_mode = r.ue()
        cbp = T.GOLOMB_TO_INTRA4X4_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = cbp
        st.mb_chroma_mode[addr] = chroma_mode
        coeffs = [None] * 16
        for k in range(16):
            if cbp_luma & (1 << (k >> 2)):
                x4, y4 = HR._Z_TO_XY[k]
                self.cur_z = k
                nc = self._nc_luma(addr, x4, y4)
                blk, tc = HR._cavlc_block(r, nc, 16)
                coeffs[k] = blk
                st.nnz_y[addr, 4 * y4 + x4] = tc
        for k in range(16):
            self.cur_z = k
            self._recon_i4_block(addr, k, modes[k], coeffs[k])
        self.cur_z = 16
        self._decode_chroma_cavlc(r, addr, chroma_mode, cbp_chroma, True)

    def _decode_i8x8_mb(self, r: BitReader, addr: int) -> None:
        st = self.st
        st.mb_class[addr] = HR.MB_I8
        st.mb_tf8[addr] = 1
        modes = self._read_i8x8_modes(r, addr)
        chroma_mode = r.ue()
        cbp = T.GOLOMB_TO_INTRA4X4_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = cbp
        st.mb_chroma_mode[addr] = chroma_mode
        coeffs = [None] * 4
        for b in range(4):
            if cbp_luma & (1 << b):
                coeffs[b] = self._parse_luma8x8_cavlc(r, addr, b)
        for b in range(4):
            self.cur_z = HR._XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
            self._recon_i8_block(addr, b, modes[b], coeffs[b])
        self.cur_z = 16
        self._decode_chroma_cavlc(r, addr, chroma_mode, cbp_chroma, True)

    def _parse_luma8x8_cavlc(self, r: BitReader, addr: int, b: int):
        st = self.st
        scan64 = [0] * 64
        for i in range(4):
            z = 4 * b + i
            x4, y4 = HR._Z_TO_XY[z]
            self.cur_z = z
            nc = self._nc_luma(addr, x4, y4)
            blk, tc = HR._cavlc_block(r, nc, 16)
            st.nnz_y[addr, 4 * y4 + x4] = tc
            for k in range(16):
                scan64[4 * k + i] = blk[k]
        return scan64

    def _decode_i16x16(self, r: BitReader, addr: int, k: int) -> None:
        st = self.st
        pred_mode = k % 4
        cbp_chroma = (k // 4) % 3
        cbp_luma = 15 if k >= 12 else 0
        chroma_mode = r.ue()
        self.qp = (self.qp + r.se() + 52) % 52
        st.mb_class[addr] = HR.MB_I16
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = cbp_luma | (cbp_chroma << 4)
        st.mb_chroma_mode[addr] = chroma_mode
        self.cur_z = 0
        nc = self._nc_luma(addr, 0, 0)
        dc_scan, dc_tc = HR._cavlc_block(r, nc, 16)
        if dc_tc:
            st.mb_dc_flag[addr] |= 1
        coeffs = [None] * 16
        for kk in range(16):
            if cbp_luma:
                x4, y4 = HR._Z_TO_XY[kk]
                self.cur_z = kk
                ncb = self._nc_luma(addr, x4, y4)
                blk, tc = HR._cavlc_block(r, ncb, 15)
                coeffs[kk] = blk
                st.nnz_y[addr, 4 * y4 + x4] = tc
        self.cur_z = 16
        self._recon_i16(addr, pred_mode, dc_scan, coeffs)
        self._decode_chroma_cavlc(r, addr, chroma_mode, cbp_chroma, True)

    # -- reconstruction -----------------------------------------------------

    def _recon_i4_block(self, addr: int, k: int, mode: int, coeffs) -> None:
        st, pic = self.st, self.pic
        x4, y4 = HR._Z_TO_XY[k]
        xN0, yN0 = 4 * x4, 4 * y4
        avail = {}
        samp = {}

        def P(x, y):
            key = (x, y)
            if key in samp:
                return samp[key]
            r = self._nbr_intra(addr, xN0 + x, yN0 + y, False)
            v = 0 if r is None else self._luma_sample(*r)
            samp[key] = v
            return v

        avail_l = self._nbr_intra(addr, xN0 - 1, yN0, False) is not None
        avail_t = self._nbr_intra(addr, xN0, yN0 - 1, False) is not None
        avail_tl = self._nbr_intra(addr, xN0 - 1, yN0 - 1, False) is not None
        avail_tr = self._nbr_intra(addr, xN0 + 4, yN0 - 1, False) is not None
        # top-right substitution (8.3.1.2): unavailable -> replicate t[3]
        t = [P(i, -1) for i in range(4)] if avail_t else [0] * 4
        if avail_tr:
            tr = [P(4 + i, -1) for i in range(4)]
        elif avail_t:
            tr = [t[3]] * 4
        else:
            tr = [0] * 4
        l = [P(-1, i) for i in range(4)] if avail_l else [0] * 4
        tl = P(-1, -1) if avail_tl else 0

        def PP(x, y):
            if y == -1:
                if x == -1:
                    return tl
                return t[x] if x < 4 else tr[x - 4]
            return l[y]

        pred = HR._pred4x4(mode, PP, avail_l, avail_t, avail_tl)
        x0 = st.luma_x0(addr) + xN0
        if coeffs is None:
            for yy in range(4):
                pic.Y[st.luma_y(addr, yN0 + yy), x0 : x0 + 4] = pred[yy]
            return
        scan = self.scan4(addr)
        dq = self._dq4(self.qp, 0)
        d = [0] * 16
        for s in range(16):
            c = coeffs[s]
            if c:
                pos = scan[s]
                d[pos] = HR._dequant4_apply(c, dq[pos], self.qp)
        res = HR._idct4x4(d)
        for yy in range(4):
            row = pic.Y[st.luma_y(addr, yN0 + yy)]
            base = 4 * yy
            for xx in range(4):
                row[x0 + xx] = HR._clip1(pred[yy][xx] + res[base + xx])

    def _recon_i8_block(self, addr: int, b: int, mode: int, scan64) -> None:
        st, pic = self.st, self.pic
        bx, by = (b & 1) * 2, (b >> 1) * 2
        xN0, yN0 = 4 * bx, 4 * by

        def S(x, y):
            r = self._nbr_intra(addr, xN0 + x, yN0 + y, False)
            return None if r is None else self._luma_sample(*r)

        avail_l = S(-1, 0) is not None
        avail_t = S(0, -1) is not None
        avail_tl = S(-1, -1) is not None
        avail_tr = S(8, -1) is not None
        left = [S(-1, i) for i in range(8)] if avail_l else None
        top = None
        if avail_t:
            top = [S(i, -1) for i in range(8)]
            if avail_tr:
                top += [S(8 + i, -1) for i in range(8)]
            else:
                top += [top[7]] * 8
        tl = S(-1, -1) if avail_tl else None
        fl, ft, ftl = HR._filter_i8_refs(left, top, tl,
                                         avail_l, avail_t, avail_tl)
        pred = HR._pred8x8(mode, fl, ft, ftl, avail_l, avail_t, avail_tl)
        x0 = st.luma_x0(addr) + xN0
        if scan64 is None:
            for yy in range(8):
                pic.Y[st.luma_y(addr, yN0 + yy), x0 : x0 + 8] = pred[yy]
            return
        scan = self.scan8(addr)
        ls = self._dq8(self.qp, 0)
        d = [0] * 64
        for s in range(64):
            c = scan64[s]
            if c:
                pos = scan[s]
                d[pos] = HR._dequant8_apply(c, ls[pos], self.qp)
        res = HR._idct8x8(d)
        for yy in range(8):
            row = pic.Y[st.luma_y(addr, yN0 + yy)]
            base = 8 * yy
            for xx in range(8):
                row[x0 + xx] = HR._clip1(pred[yy][xx] + res[base + xx])

    def _recon_i16(self, addr: int, pred_mode: int, dc_scan, coeffs) -> None:
        st, pic = self.st, self.pic

        def S(x, y):
            r = self._nbr_intra(addr, x, y, False)
            return None if r is None else self._luma_sample(*r)

        avail_l = S(-1, 0) is not None
        avail_t = S(0, -1) is not None
        left = [S(-1, i) for i in range(16)] if avail_l else [0] * 16
        top = [S(i, -1) for i in range(16)] if avail_t else [0] * 16
        tlv = S(-1, -1)
        tl = tlv if tlv is not None else 0
        pred = HR._pred16x16(pred_mode, left, top, tl, avail_l, avail_t)
        scan = self.scan4(addr)
        dcr = [0] * 16
        for s in range(16):
            dcr[scan[s]] = dc_scan[s]
        f = HR._hadamard4x4(dcr)
        dc = HR._luma_dc_dequant(f, self.qp, self.w4[0][0])
        dq = self._dq4(self.qp, 0)
        x0 = st.luma_x0(addr)
        for kk in range(16):
            x4, y4 = HR._Z_TO_XY[kk]
            d = [0] * 16
            blk = coeffs[kk]
            if blk is not None:
                for s in range(15):
                    c = blk[s]
                    if c:
                        pos = scan[s + 1]
                        d[pos] = HR._dequant4_apply(c, dq[pos], self.qp)
            d[0] = dc[4 * y4 + x4]
            res = HR._idct4x4(d)
            for yy in range(4):
                row = pic.Y[st.luma_y(addr, 4 * y4 + yy)]
                base = 4 * yy
                for xx in range(4):
                    row[x0 + 4 * x4 + xx] = HR._clip1(
                        int(pred[4 * y4 + yy, 4 * x4 + xx]) + res[base + xx])

    def _decode_chroma_cavlc(self, r: BitReader, addr: int, chroma_mode: int,
                             cbp_chroma: int, intra: bool) -> None:
        st = self.st
        dc_scan = [[0] * 4, [0] * 4]
        if cbp_chroma:
            for comp in range(2):
                blk, tc = HR._cavlc_block(r, -1, 4)
                dc_scan[comp] = blk
                if tc:
                    st.mb_dc_flag[addr] |= 2 << comp
        coeffs = [[None] * 4 for _ in range(2)]
        if cbp_chroma & 2:
            for comp in range(2):
                for b in range(4):
                    cx, cy = (b & 1), (b >> 1)
                    nc = self._nc_chroma(addr, comp, cx, cy)
                    blk, tc = HR._cavlc_block(r, nc, 15)
                    coeffs[comp][b] = blk
                    st.nnz_c[addr, comp, 2 * cy + cx] = tc
        self._recon_chroma(addr, chroma_mode, dc_scan, coeffs, intra)

    def _recon_chroma(self, addr: int, chroma_mode: int, dc_scan, coeffs,
                      intra: bool) -> None:
        st, pic, pps = self.st, self.pic, self.pps
        qpc = (HR.chroma_qp(self.qp, pps.chroma_qp_index_offset),
               HR.chroma_qp(self.qp, pps.second_chroma_qp_index_offset))
        cx0 = (st.pair_of(addr) % st.mb_w) * 8
        scan = self.scan4(addr)
        for comp, plane in ((0, pic.U), (1, pic.V)):
            if intra:
                def S(x, y):
                    r = self._nbr_intra(addr, x, y, True)
                    return (None if r is None
                            else self._chroma_sample(plane, *r))

                avail_l = S(-1, 0) is not None
                avail_t = S(0, -1) is not None
                left = ([S(-1, i) for i in range(8)] if avail_l else [0] * 8)
                top = ([S(i, -1) for i in range(8)] if avail_t else [0] * 8)
                tlv = S(-1, -1)
                tl = tlv if tlv is not None else 0
                pred = HR._pred_chroma8x8(chroma_mode, left, top, tl,
                                          avail_l, avail_t)
            else:
                pred = self._pred_chroma[comp]
            qp = qpc[comp]
            list_idx = (1 + comp) if intra else (4 + comp)
            c0, c1, c2, c3 = dc_scan[comp]
            f = (c0 + c1 + c2 + c3, c0 - c1 + c2 - c3,
                 c0 + c1 - c2 - c3, c0 - c1 - c2 + c3)
            dc = HR._chroma_dc_dequant(f, qp, self.w4[list_idx][0])
            dq = self._dq4(qp, list_idx)
            out = np.array(pred, np.int32, copy=True)
            for b in range(4):
                bx, by = 4 * (b & 1), 4 * (b >> 1)
                d = [0] * 16
                blk = coeffs[comp][b]
                if blk is not None:
                    for s in range(15):
                        c = blk[s]
                        if c:
                            pos = scan[s + 1]
                            d[pos] = HR._dequant4_apply(c, dq[pos], qp)
                d[0] = dc[b]
                if any(d):
                    res = HR._idct4x4(d)
                    for yy in range(4):
                        base = 4 * yy
                        for xx in range(4):
                            out[by + yy, bx + xx] = HR._clip1(
                                int(pred[by + yy, bx + xx]) + res[base + xx])
            for yy in range(8):
                plane[st.chroma_y(addr, yy), cx0 : cx0 + 8] = np.clip(
                    out[yy], 0, 255)

    # -- slice data loop (7.3.4), CAVLC -------------------------------------

    def infer_field_flag(self, pair: int) -> int:
        """7.4.4 inference when both MBs of a pair are skipped: copy the
        left pair's flag if that pair is in this slice, else the above
        pair's, else 0."""
        st = self.st
        px, py = pair % st.mb_w, pair // st.mb_w
        if px > 0 and st.slice_id[2 * (pair - 1)] == self.sid:
            return int(st.field_flag[pair - 1])
        if py > 0 and st.slice_id[2 * (pair - st.mb_w)] == self.sid:
            return int(st.field_flag[pair - st.mb_w])
        return 0

    def decode_cavlc(self, r: BitReader) -> None:
        h = self.h
        st = self.st
        n_mbs = st.mb_w * st.mb_h
        if h.slice_type == HR.SLICE_I:
            addr = h.first_mb * 2
            while addr < n_mbs:
                if (addr & 1) == 0:
                    st.field_flag[addr >> 1] = r.read(1)
                self._mark_mb(addr)
                self.cur_addr = addr
                mb_type = r.ue()
                self.decode_intra_mb_cavlc(r, addr, mb_type)
                addr += 1
                if not HR._more_rbsp_data(r):
                    break
            return
        # P slice (7.3.4 with MbaffFrameFlag): pairwise skip handling —
        # the pair's field flag is read at the first coded MB of the pair
        # (or inferred when both MBs are skipped, 7.4.4)
        addr = h.first_mb * 2
        more = True
        pending_top = None  # top MB of current pair skipped, flag unknown
        while more and addr < n_mbs:
            skip_run = r.ue()
            for _ in range(skip_run):
                if addr >= n_mbs:
                    break
                if (addr & 1) == 0:
                    pending_top = addr
                else:
                    if pending_top is not None:
                        st.field_flag[addr >> 1] = self.infer_field_flag(
                            addr >> 1)
                        self.decode_skip_mb(pending_top)
                        pending_top = None
                    self.decode_skip_mb(addr)
                addr += 1
            more = HR._more_rbsp_data(r)
            if more and addr < n_mbs:
                if (addr & 1) == 0:
                    st.field_flag[addr >> 1] = r.read(1)
                elif pending_top is not None:
                    st.field_flag[addr >> 1] = r.read(1)
                if pending_top is not None:
                    self.decode_skip_mb(pending_top)
                    pending_top = None
                self._mark_mb(addr)
                self.cur_addr = addr
                self.cur_z = 0
                mb_type = r.ue()
                if h.slice_type == HR.SLICE_P:
                    if mb_type < 5:
                        self._decode_p_mb(r, addr, mb_type)
                    else:
                        self.decode_intra_mb_cavlc(r, addr, mb_type - 5)
                else:
                    if mb_type < 23:
                        self._decode_b_mb(r, addr, mb_type)
                    else:
                        self.decode_intra_mb_cavlc(r, addr, mb_type - 23)
                addr += 1
                more = HR._more_rbsp_data(r)
        if pending_top is not None:
            st.field_flag[pending_top >> 1] = self.infer_field_flag(
                pending_top >> 1)
            self.decode_skip_mb(pending_top)

    def decode_cabac(self, rbsp: bytes) -> None:
        """CABAC slice data (7.3.4 with MbaffFrameFlag = 1): mb_skip per
        MB, mb_field_decoding_flag at the first coded MB of each pair
        (7.4.4 inference pre-seeds the flag for context derivation),
        end_of_slice after bottom MBs only."""
        h = self.h
        st = self.st
        cb = MbaffCabac(self, rbsp, h)
        n_mbs = st.mb_w * st.mb_h
        addr = h.first_mb * 2
        pending_top = None
        is_pb = h.slice_type in (HR.SLICE_P, HR.SLICE_B)
        while addr < n_mbs:
            if (addr & 1) == 0:
                # pre-seed the pair flag for ctx/geometry until read
                st.field_flag[addr >> 1] = self.infer_field_flag(addr >> 1)
            skipped = False
            if is_pb:
                self.cur_addr = addr
                if (addr & 1) == 0:
                    self._mark_mb(addr)  # skip ctx availability
                skipped = bool(cb.mb_skip_flag(addr))
            if skipped:
                if (addr & 1) == 0:
                    st.mb_skip[addr] = 1
                    st.slice_id[addr] = self.sid
                    if h.slice_type == HR.SLICE_B:
                        st.mb_bdirect[addr] = 1
                    pending_top = addr
                else:
                    if pending_top is not None:
                        # both skipped: inference already seeded
                        self.decode_skip_mb(pending_top)
                        pending_top = None
                    self.decode_skip_mb(addr)
                cb.prev_qp_delta_nz = 0
            else:
                if (addr & 1) == 0 or pending_top is not None:
                    st.field_flag[addr >> 1] = cb.mb_field_decoding_flag(
                        addr)
                if pending_top is not None:
                    self.decode_skip_mb(pending_top)
                    pending_top = None
                self._mark_mb(addr)
                self.cur_addr = addr
                self.cur_z = 0
                self.decode_mb_cabac(cb, addr)
            if (addr & 1) == 1:
                if pending_top is not None:
                    self.decode_skip_mb(pending_top)
                    pending_top = None
                if cb.end_of_slice():
                    break
            addr += 1
        if pending_top is not None:
            self.decode_skip_mb(pending_top)

    def decode_mb_cabac(self, cb: "MbaffCabac", addr: int) -> None:
        stp = self.h.slice_type
        if stp == HR.SLICE_P:
            mb_type = cb.mb_type_p(addr)
            if mb_type < 5:
                self._decode_p_mb_cabac(cb, addr, mb_type)
            else:
                self._decode_intra_mb_cabac(cb, addr, mb_type - 5)
        elif stp == HR.SLICE_B:
            mb_type = cb.mb_type_b(addr)
            if mb_type < 23:
                self._decode_b_mb_cabac(cb, addr, mb_type)
            else:
                self._decode_intra_mb_cabac(cb, addr, mb_type - 23)
        else:
            mb_type = cb.mb_type_i(addr)
            self._decode_intra_mb_cabac(cb, addr, mb_type)

    def _decode_intra_mb_cabac(self, cb, addr: int, imb: int) -> None:
        if imb == 25:
            self._decode_ipcm_cabac(cb, addr)
            return
        if imb == 0:
            tf8 = 0
            if self.pps.transform_8x8_mode:
                tf8 = cb.transform_size_8x8(addr)
            if tf8:
                self._decode_i8x8_cabac(cb, addr)
            else:
                self._decode_i4x4_cabac(cb, addr)
            return
        self._decode_i16_cabac(cb, addr, imb - 1)

    def _decode_ipcm_cabac(self, cb, addr: int) -> None:
        st, pic = self.st, self.pic
        e = cb.e
        if e.pos & 7:
            e.pos += 8 - (e.pos & 7)
        data = e.data
        p = e.pos >> 3
        x0 = st.luma_x0(addr)
        for yy in range(16):
            ly = st.luma_y(addr, yy)
            for xx in range(16):
                pic.Y[ly, x0 + xx] = data[p]
                p += 1
        cx0 = (st.pair_of(addr) % st.mb_w) * 8
        for plane in (pic.U, pic.V):
            for yy in range(8):
                cy = st.chroma_y(addr, yy)
                for xx in range(8):
                    plane[cy, cx0 + xx] = data[p]
                    p += 1
        e.pos = p << 3
        e.range_ = 510
        off = 0
        for _ in range(9):
            off = (off << 1) | e._bit()
        e.offset = off
        st.mb_class[addr] = HR.MB_IPCM
        st.nnz_y[addr, :] = 16
        st.nnz_c[addr, :, :] = 16
        st.cbf_y[addr, :] = 1
        st.cbf_c[addr, :, :] = 1
        st.mb_qp[addr] = 0
        st.mb_cbp[addr] = 0x2F
        cb.prev_qp_delta_nz = 0

    def _qp_delta_cabac(self, cb, addr: int, cbp: int, always: bool) -> None:
        st = self.st
        if cbp or always:
            self.qp = (self.qp + cb.mb_qp_delta() + 52) % 52
        else:
            cb.prev_qp_delta_nz = 0
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = cbp

    def _luma4_res_cabac(self, cb, addr: int, k: int, cat: int):
        st = self.st
        x4, y4 = HR._Z_TO_XY[k]
        blk = cb.residual(addr, cat, 15 if cat == 1 else 16, (x4, y4))
        cell = 4 * y4 + x4
        if blk is None:
            st.cbf_y[addr, cell] = 0
            st.nnz_y[addr, cell] = 0
            return None
        st.cbf_y[addr, cell] = 1
        st.nnz_y[addr, cell] = sum(1 for c in blk if c)
        return blk

    def _decode_i4x4_cabac(self, cb, addr: int) -> None:
        st = self.st
        st.mb_class[addr] = HR.MB_I4
        modes = [2] * 16
        for k in range(16):
            x4, y4 = HR._Z_TO_XY[k]
            self.cur_z = k
            ma = self._i4_mode_nbr(addr, 4 * x4 - 1, 4 * y4)
            mb_ = self._i4_mode_nbr(addr, 4 * x4, 4 * y4 - 1)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            mode = cb.intra_pred_mode(pred)
            modes[k] = mode
            st.i4_modes[addr, 4 * y4 + x4] = mode
        chroma_mode = cb.chroma_pred_mode(addr)
        st.mb_chroma_mode[addr] = chroma_mode
        cbp = cb.cbp(addr)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        self._qp_delta_cabac(cb, addr, cbp, False)
        coeffs = [None] * 16
        for k in range(16):
            if cbp_luma & (1 << (k >> 2)):
                self.cur_z = k
                coeffs[k] = self._luma4_res_cabac(cb, addr, k, 2)
        for k in range(16):
            self.cur_z = k
            self._recon_i4_block(addr, k, modes[k], coeffs[k])
        self.cur_z = 16
        self._decode_chroma_cabac(cb, addr, chroma_mode, cbp_chroma, True)

    def _decode_i8x8_cabac(self, cb, addr: int) -> None:
        st = self.st
        st.mb_class[addr] = HR.MB_I8
        st.mb_tf8[addr] = 1
        modes = [2] * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            self.cur_z = HR._XY_TO_Z[(bx, by)]
            ma = self._i4_mode_nbr(addr, 4 * bx - 1, 4 * by)
            mb_ = self._i4_mode_nbr(addr, 4 * bx, 4 * by - 1)
            pred = 2 if (ma is None or mb_ is None) else min(ma, mb_)
            mode = cb.intra_pred_mode(pred)
            modes[b] = mode
            for dy in range(2):
                for dx in range(2):
                    st.i4_modes[addr, 4 * (by + dy) + bx + dx] = mode
        chroma_mode = cb.chroma_pred_mode(addr)
        st.mb_chroma_mode[addr] = chroma_mode
        cbp = cb.cbp(addr)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        self._qp_delta_cabac(cb, addr, cbp, False)
        coeffs = [None] * 4
        for b in range(4):
            bx, by = (b & 1) * 2, (b >> 1) * 2
            if cbp_luma & (1 << b):
                blk = cb.residual(addr, 5, 64)
                coeffs[b] = blk
                nz = sum(1 for c in blk if c)
                for dy in range(2):
                    for dx in range(2):
                        st.cbf_y[addr, 4 * (by + dy) + bx + dx] = 1
                        st.nnz_y[addr, 4 * (by + dy) + bx + dx] = nz
        for b in range(4):
            self.cur_z = HR._XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
            self._recon_i8_block(addr, b, modes[b], coeffs[b])
        self.cur_z = 16
        self._decode_chroma_cabac(cb, addr, chroma_mode, cbp_chroma, True)

    def _decode_i16_cabac(self, cb, addr: int, k: int) -> None:
        st = self.st
        pred_mode = k % 4
        cbp_chroma = (k // 4) % 3
        cbp_luma = 15 if k >= 12 else 0
        st.mb_class[addr] = HR.MB_I16
        chroma_mode = cb.chroma_pred_mode(addr)
        st.mb_chroma_mode[addr] = chroma_mode
        self._qp_delta_cabac(cb, addr, cbp_luma | (cbp_chroma << 4), True)
        dc = cb.residual(addr, 0, 16, None)
        if dc is not None:
            st.mb_dc_flag[addr] |= 1
        dc_scan = dc if dc is not None else [0] * 16
        coeffs = [None] * 16
        if cbp_luma:
            for kk in range(16):
                self.cur_z = kk
                coeffs[kk] = self._luma4_res_cabac(cb, addr, kk, 1)
        self.cur_z = 16
        self._recon_i16(addr, pred_mode, dc_scan, coeffs)
        self._decode_chroma_cabac(cb, addr, chroma_mode, cbp_chroma, True)

    def _decode_chroma_cabac(self, cb, addr: int, chroma_mode: int,
                             cbp_chroma: int, intra: bool) -> None:
        st = self.st
        dc_scan = [[0] * 4, [0] * 4]
        if cbp_chroma:
            for comp in range(2):
                blk = cb.residual(addr, 3, 4, comp)
                if blk is not None:
                    dc_scan[comp] = blk
                    st.mb_dc_flag[addr] |= 2 << comp
        coeffs = [[None] * 4 for _ in range(2)]
        if cbp_chroma & 2:
            for comp in range(2):
                for b in range(4):
                    cx, cy = (b & 1), (b >> 1)
                    blk = cb.residual(addr, 4, 15, (comp, cx, cy))
                    coeffs[comp][b] = blk
                    cell = 2 * cy + cx
                    if blk is None:
                        st.cbf_c[addr, comp, cell] = 0
                        st.nnz_c[addr, comp, cell] = 0
                    else:
                        st.cbf_c[addr, comp, cell] = 1
                        st.nnz_c[addr, comp, cell] = sum(
                            1 for c in blk if c)
        self._recon_chroma(addr, chroma_mode, dc_scan, coeffs, intra)

    def _part_motion_cabac(self, cb, addr: int, l: int, bx4, by4, w4, h4,
                           ref_idx: int, kind: str = "", part_i: int = 0):
        self.cur_z = HR._XY_TO_Z[(bx4, by4)]
        mvdx = cb.mvd(addr, l, bx4, by4, 0)
        mvdy = cb.mvd(addr, l, bx4, by4, 1)
        px, py = self._mv_pred(addr, bx4, by4, w4, h4, ref_idx, kind,
                               part_i, l)
        mv = (px + mvdx, py + mvdy)
        self._store_part_mv(addr, bx4, by4, w4, h4, ref_idx, mv[0], mv[1], l)
        self._store_part_mvd(addr, bx4, by4, w4, h4, l, mvdx, mvdy)
        return mv

    def _decode_p_mb_cabac(self, cb, addr: int, mb_type: int) -> None:
        st = self.st
        st.mb_class[addr] = HR.MB_P
        n0 = self._n_act(addr, 0)
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        sub_types = None
        if mb_type in (0, 1, 2):
            kind, parts = HR._SliceCtx._P_PARTS[mb_type]
            refs = []
            for (bx4, by4, w4, h4) in parts:
                self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                rr = cb.ref_idx(addr, 0, bx4, by4) if n0 > 1 else 0
                refs.append(rr)
                for y in range(by4, by4 + h4):
                    for x in range(bx4, bx4 + w4):
                        st.ref_idx[addr, 0, 4 * y + x] = rr
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                mv = self._part_motion_cabac(cb, addr, 0, bx4, by4, w4, h4,
                                             refs[i], kind, i)
                self._mc_part(addr, predY, predU, predV, bx4, by4, w4, h4,
                              refs[i], mv[0], mv[1])
        else:
            sub_types = [cb.sub_mb_type_p() for _ in range(4)]
            refs = [0, 0, 0, 0]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                if mb_type == 3 and n0 > 1:
                    self.cur_z = HR._XY_TO_Z[(bx0, by0)]
                    refs[b] = cb.ref_idx(addr, 0, bx0, by0)
                for y in range(by0, by0 + 2):
                    for x in range(bx0, bx0 + 2):
                        st.ref_idx[addr, 0, 4 * y + x] = refs[b]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                for (sx, sy, w4, h4) in HR._SliceCtx._SUB_PARTS[sub_types[b]]:
                    bx4, by4 = bx0 + sx, by0 + sy
                    mv = self._part_motion_cabac(cb, addr, 0, bx4, by4,
                                                 w4, h4, refs[b])
                    self._mc_part(addr, predY, predU, predV, bx4, by4,
                                  w4, h4, refs[b], mv[0], mv[1])
        self.cur_z = 16
        tf8_ok = mb_type in (0, 1, 2) or all(stp == 0 for stp in sub_types)
        self._inter_residual_cabac(cb, addr, predY, predU, predV, tf8_ok)

    def _decode_b_mb_cabac(self, cb, addr: int, mb_type: int) -> None:
        st = self.st
        self._direct_cache = None
        st.mb_class[addr] = HR.MB_B
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        if mb_type == 0:
            st.mb_bdirect[addr] = 1
            for b in range(4):
                self._decode_direct_8x8(addr, b, predY, predU, predV)
            self.cur_z = 16
            self._inter_residual_cabac(cb, addr, predY, predU, predV,
                                       bool(self.sps.direct_8x8_inference))
            return
        tf8_ok = True
        SC = HR._SliceCtx
        if mb_type < 22:
            kind, preds = SC._B_TYPES[mb_type]
            parts = SC._PART_GEOM[kind]
            np_ = len(parts)
            refs = [[-1] * np_, [-1] * np_]
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        bx4, by4, w4, h4 = parts[i]
                        self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                        rr = (cb.ref_idx(addr, l, bx4, by4)
                              if self._n_act(addr, l) > 1 else 0)
                        refs[l][i] = rr
                        for y in range(by4, by4 + h4):
                            for x in range(bx4, bx4 + w4):
                                st.ref_idx[addr, l, 4 * y + x] = rr
            mvs = [[None] * np_, [None] * np_]
            for l in (0, 1):
                for i, (bx4, by4, w4, h4) in enumerate(parts):
                    if refs[l][i] < 0:
                        continue
                    mvs[l][i] = self._part_motion_cabac(
                        cb, addr, l, bx4, by4, w4, h4, refs[l][i], kind, i)
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                p0 = (self._fetch_pred(addr, 0, refs[0][i], bx4, by4, w4, h4,
                                       *mvs[0][i]) if refs[0][i] >= 0
                      else None)
                p1 = (self._fetch_pred(addr, 1, refs[1][i], bx4, by4, w4, h4,
                                       *mvs[1][i]) if refs[1][i] >= 0
                      else None)
                self._combine_store(addr, predY, predU, predV, bx4, by4,
                                    w4, h4, p0, p1, refs[0][i], refs[1][i])
        else:
            sub_types = [cb.sub_mb_type_b() for _ in range(4)]
            if any(stp > 12 for stp in sub_types):
                raise EOFError_(f"bad B sub_mb_type {sub_types}")
            for b in range(4):
                if SC._B_SUB[sub_types[b]][0] == -1:
                    self.cur_z = HR._XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
                    self._decode_direct_8x8(addr, b, predY, predU, predV)
            refs = [[-1] * 4, [-1] * 4]
            for l in (0, 1):
                for b in range(4):
                    pm = SC._B_SUB[sub_types[b]][0]
                    if pm == 2 or pm == l:
                        bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                        self.cur_z = HR._XY_TO_Z[(bx0, by0)]
                        rr = (cb.ref_idx(addr, l, bx0, by0)
                              if self._n_act(addr, l) > 1 else 0)
                        refs[l][b] = rr
                        for y in range(by0, by0 + 2):
                            for x in range(bx0, bx0 + 2):
                                st.ref_idx[addr, l, 4 * y + x] = rr
            submvs = {}
            for l in (0, 1):
                for b in range(4):
                    pm, sparts = SC._B_SUB[sub_types[b]]
                    if pm == -1 or not (pm == 2 or pm == l):
                        continue
                    for sp in sparts:
                        sx, sy, w4, h4 = sp
                        bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                        submvs[(l, b, sp)] = self._part_motion_cabac(
                            cb, addr, l, bx4, by4, w4, h4, refs[l][b])
            for b in range(4):
                pm, sparts = SC._B_SUB[sub_types[b]]
                if pm == -1:
                    continue
                for sp in sparts:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    p0 = p1 = None
                    if refs[0][b] >= 0:
                        p0 = self._fetch_pred(addr, 0, refs[0][b], bx4, by4,
                                              w4, h4, *submvs[(0, b, sp)])
                    if refs[1][b] >= 0:
                        p1 = self._fetch_pred(addr, 1, refs[1][b], bx4, by4,
                                              w4, h4, *submvs[(1, b, sp)])
                    self._combine_store(addr, predY, predU, predV, bx4, by4,
                                        w4, h4, p0, p1, refs[0][b],
                                        refs[1][b])
            tf8_ok = all(
                (stp == 0 and self.sps.direct_8x8_inference)
                or stp in (1, 2, 3)
                for stp in sub_types)
        self.cur_z = 16
        self._inter_residual_cabac(cb, addr, predY, predU, predV, tf8_ok)

    def _inter_residual_cabac(self, cb, addr: int, predY, predU, predV,
                              tf8_ok: bool) -> None:
        st, pic = self.st, self.pic
        cbp = cb.cbp(addr)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        tf8 = 0
        if cbp_luma and tf8_ok and self.pps.transform_8x8_mode:
            tf8 = cb.transform_size_8x8(addr)
        st.mb_tf8[addr] = tf8
        self._qp_delta_cabac(cb, addr, cbp, False)
        x0 = st.luma_x0(addr)
        if tf8:
            scan = self.scan8(addr)
            for b in range(4):
                bx, by = (b & 1) * 2, (b >> 1) * 2
                if not (cbp_luma & (1 << b)):
                    for yy in range(8):
                        pic.Y[st.luma_y(addr, by * 4 + yy),
                              x0 + bx * 4 : x0 + bx * 4 + 8] = np.clip(
                            predY[by * 4 + yy, bx * 4 : bx * 4 + 8], 0, 255)
                    continue
                scan64 = cb.residual(addr, 5, 64)
                nz = sum(1 for c in scan64 if c)
                for dy in range(2):
                    for dx in range(2):
                        st.cbf_y[addr, 4 * (by + dy) + bx + dx] = 1
                        st.nnz_y[addr, 4 * (by + dy) + bx + dx] = nz
                ls = self._dq8(self.qp, 1)
                d = [0] * 64
                for sidx in range(64):
                    c = scan64[sidx]
                    if c:
                        pos = scan[sidx]
                        d[pos] = HR._dequant8_apply(c, ls[pos], self.qp)
                res = HR._idct8x8(d)
                for yy in range(8):
                    row = pic.Y[st.luma_y(addr, by * 4 + yy)]
                    base = 8 * yy
                    for xx in range(8):
                        row[x0 + bx * 4 + xx] = HR._clip1(
                            int(predY[by * 4 + yy, bx * 4 + xx])
                            + res[base + xx])
            self._pred_chroma = (predU, predV)
            self._decode_chroma_cabac(cb, addr, 0, cbp_chroma, False)
            return
        scan = self.scan4(addr)
        dq = self._dq4(self.qp, 3)
        for k in range(16):
            x4, y4 = HR._Z_TO_XY[k]
            blk = None
            if cbp_luma & (1 << (k >> 2)):
                self.cur_z = k
                blk = self._luma4_res_cabac(cb, addr, k, 2)
            if blk is None:
                for yy in range(4):
                    pic.Y[st.luma_y(addr, y4 * 4 + yy),
                          x0 + x4 * 4 : x0 + x4 * 4 + 4] = np.clip(
                        predY[y4 * 4 + yy, x4 * 4 : x4 * 4 + 4], 0, 255)
                continue
            d = [0] * 16
            for sidx in range(16):
                c = blk[sidx]
                if c:
                    pos = scan[sidx]
                    d[pos] = HR._dequant4_apply(c, dq[pos], self.qp)
            res = HR._idct4x4(d)
            for yy in range(4):
                row = pic.Y[st.luma_y(addr, y4 * 4 + yy)]
                base = 4 * yy
                for xx in range(4):
                    row[x0 + x4 * 4 + xx] = HR._clip1(
                        int(predY[y4 * 4 + yy, x4 * 4 + xx]) + res[base + xx])
        self.cur_z = 16
        self._pred_chroma = (predU, predV)
        self._decode_chroma_cabac(cb, addr, 0, cbp_chroma, False)

    # -- inter: field reference resolution (8.4.2.1) ------------------------

    def _field_ref(self, l: int, ref_idx: int, addr: int):
        """Resolve a field-MB reference index: (frame pic, parity)."""
        frm = (self.ref_l0 if l == 0 else self.ref_l1)[ref_idx >> 1]
        cur_parity = addr & 1
        parity = cur_parity if (ref_idx & 1) == 0 else 1 - cur_parity
        return frm, parity

    def _ref_identity(self, l: int, ref_idx: int, addr: int) -> int:
        """Per-cell reference identity for deblock bS (distinguishes
        fields; frame references use a disjoint code)."""
        if self.st.is_field(addr):
            frm, parity = self._field_ref(l, ref_idx, addr)
            return 4 * frm.pic_id + parity
        frm = (self.ref_l0 if l == 0 else self.ref_l1)[ref_idx]
        return 4 * frm.pic_id + 3

    # -- neighbour motion with cross-interleave scaling (8.4.1.3.1) --------

    def _mv_nbr(self, addr: int, xN: int, yN: int, l: int):
        """(avail, refIdx, mvx, mvy) of the list-l motion at local
        (xN, yN), scaled into the CURRENT MB's frame/field units:
        neighbour field -> current frame: ref >>= 1, mvy *= 2;
        neighbour frame -> current field: ref *= 2, mvy /= 2 (truncating,
        matching the spec's '/' and libavcodec MAP_F2F)."""
        r = self._nbr(addr, xN, yN, False)
        if r is None:
            return (False, -1, 0, 0)
        addrN, xW, yW = r
        st = self.st
        if addrN == addr and HR._XY_TO_Z[(xW >> 2, yW >> 2)] >= self.cur_z:
            return (False, -1, 0, 0)
        cell = 4 * (yW >> 2) + (xW >> 2)
        ref = int(st.ref_idx[addrN, l, cell])
        mvx = int(st.mv[addrN, l, cell, 0])
        mvy = int(st.mv[addrN, l, cell, 1])
        nf = st.is_field(addrN)
        cf = st.is_field(addr)
        if nf and not cf:
            if ref >= 0:
                ref >>= 1
            mvy *= 2
        elif cf and not nf:
            if ref >= 0:
                ref *= 2
            mvy = int(mvy / 2) if mvy >= 0 else -((-mvy) // 2)
        return (True, ref, mvx, mvy)

    def _mv_pred(self, addr: int, bx4: int, by4: int, w4: int, h4: int,
                 ref_idx: int, part_kind: str = "", part_i: int = 0,
                 l: int = 0):
        """Median/directional MV prediction (8.4.1.3 with MBAFF
        neighbours; mirrors h264_ref._mv_pred)."""
        xN0, yN0 = 4 * bx4, 4 * by4
        A = self._mv_nbr(addr, xN0 - 1, yN0, l)
        B = self._mv_nbr(addr, xN0, yN0 - 1, l)
        C = self._mv_nbr(addr, xN0 + 4 * w4, yN0 - 1, l)
        if not C[0]:
            C = self._mv_nbr(addr, xN0 - 1, yN0 - 1, l)
        ra, rb, rc = A[1], B[1], C[1]
        if part_kind == "16x8":
            if part_i == 0 and rb == ref_idx:
                return (B[2], B[3])
            if part_i == 1 and ra == ref_idx:
                return (A[2], A[3])
        elif part_kind == "8x16":
            if part_i == 0 and ra == ref_idx:
                return (A[2], A[3])
            if part_i == 1 and rc == ref_idx:
                return (C[2], C[3])
        match_a = ra == ref_idx
        match_b = rb == ref_idx
        match_c = rc == ref_idx
        if match_a and not match_b and not match_c:
            return (A[2], A[3])
        if match_b and not match_a and not match_c:
            return (B[2], B[3])
        if match_c and not match_a and not match_b:
            return (C[2], C[3])
        if not B[0] and not C[0]:
            return (A[2], A[3])
        return (HR._median3(A[2], B[2], C[2]), HR._median3(A[3], B[3], C[3]))

    def _store_part_mv(self, addr: int, bx4, by4, w4, h4, ref_idx: int,
                       mvx: int, mvy: int, l: int) -> None:
        st = self.st
        rid = self._ref_identity(l, ref_idx, addr)
        for y in range(by4, by4 + h4):
            for x in range(bx4, bx4 + w4):
                cell = 4 * y + x
                st.mv[addr, l, cell] = (mvx, mvy)
                st.ref_idx[addr, l, cell] = ref_idx
                st.ref_id[addr, l, cell] = rid
    def _store_part_mvd(self, addr: int, bx4, by4, w4, h4, l, mvdx,
                        mvdy) -> None:
        st = self.st
        for y in range(by4, by4 + h4):
            for x in range(bx4, bx4 + w4):
                st.mvd[addr, l, 4 * y + x] = (mvdx, mvdy)

    # -- MC (8.4.2.2 on frame or field sample grids) ------------------------

    def _fetch_pred(self, addr: int, l: int, ref_idx: int, bx4, by4, w4, h4,
                    mvx: int, mvy: int):
        """Raw interpolated (Y, U, V) int32 blocks from list l."""
        st = self.st
        px, py = st.pair_xy(addr)
        cmvy = mvy
        if st.is_field(addr):
            frm, parity = self._field_ref(l, ref_idx, addr)
            refY = frm.Y[parity::2]
            refU = frm.U[parity::2]
            refV = frm.V[parity::2]
            y0 = py * 16 + 4 * by4
            cy0 = py * 8 + 2 * by4
            # chroma MV cross-parity adjustment (8.4.1.4): top field
            # referencing bottom -> -2; bottom referencing top -> +2
            cur_parity = addr & 1
            if cur_parity == 0 and parity == 1:
                cmvy = mvy - 2
            elif cur_parity == 1 and parity == 0:
                cmvy = mvy + 2
        else:
            frm = (self.ref_l0 if l == 0 else self.ref_l1)[ref_idx]
            refY, refU, refV = frm.Y, frm.U, frm.V
            y0 = py * 32 + 16 * (addr & 1) + 4 * by4
            cy0 = py * 16 + 8 * (addr & 1) + 2 * by4
        x0 = st.luma_x0(addr) + 4 * bx4
        cx0 = (st.pair_of(addr) % st.mb_w) * 8 + 2 * bx4
        return (HR._mc_luma(refY, x0, y0, w4 * 4, h4 * 4, mvx, mvy),
                HR._mc_chroma(refU, cx0, cy0, w4 * 2, h4 * 2, mvx, cmvy),
                HR._mc_chroma(refV, cx0, cy0, w4 * 2, h4 * 2, mvx, cmvy))

    def _wp_apply(self, blk, l: int, ref_idx: int, comp: int, addr: int):
        """Explicit weighted prediction; field MBs index the frame-list
        weight table with refIdx >> 1 (8.4.3)."""
        pw = self.h.pred_weights
        if pw is None:
            return blk
        widx = ref_idx >> 1 if self.st.is_field(addr) else ref_idx
        logwd = pw[0] if comp < 0 else pw[1]
        wt = pw[2][l][widx]
        if comp < 0:
            w, o = wt[0], wt[1]
        else:
            w, o = wt[2 + 2 * comp], wt[3 + 2 * comp]
        if logwd >= 1:
            blk = ((blk * w + (1 << (logwd - 1))) >> logwd) + o
        else:
            blk = blk * w + o
        return HR._clip255(blk)

    def _implicit_weights(self, addr: int, ref_idx0: int, ref_idx1: int):
        """8.4.2.3.1 implicit weights; field MBs use field order counts."""
        if self.st.is_field(addr):
            f0, p0 = self._field_ref(0, ref_idx0, addr)
            f1, p1 = self._field_ref(1, ref_idx1, addr)
            poc0 = f0.field_poc[p0]
            poc1 = f1.field_poc[p1]
            cur = self.pic.field_poc[addr & 1]
            lt0, lt1 = f0.long_term, f1.long_term
        else:
            pic0 = self.ref_l0[ref_idx0]
            pic1 = self.ref_l1[ref_idx1]
            poc0, poc1 = pic0.poc, pic1.poc
            cur = self.pic.poc
            lt0, lt1 = pic0.long_term, pic1.long_term
        if poc1 == poc0 or lt0 or lt1:
            return (32, 32)
        tb = min(127, max(-128, cur - poc0))
        td = min(127, max(-128, poc1 - poc0))
        tx = (16384 + abs(td) // 2) // td
        dsf = min(1023, max(-1024, (tb * tx + 32) >> 6))
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return (32, 32)
        return (64 - w1, w1)

    def _combine_store(self, addr, predY, predU, predV, bx4, by4, w4, h4,
                       p0, p1, ref_idx0: int, ref_idx1: int) -> None:
        pps, h = self.pps, self.h
        out = [None, None, None]
        if p0 is not None and p1 is not None:
            if h.slice_type == HR.SLICE_B and pps.weighted_bipred_idc == 2:
                w0, w1 = self._implicit_weights(addr, ref_idx0, ref_idx1)
                for c in range(3):
                    out[c] = HR._clip255(
                        (p0[c] * w0 + p1[c] * w1 + 32) >> 6)
            elif (h.slice_type == HR.SLICE_B
                  and pps.weighted_bipred_idc == 1
                  and h.pred_weights is not None):
                pw = h.pred_weights
                fld = self.st.is_field(addr)
                i0 = ref_idx0 >> 1 if fld else ref_idx0
                i1 = ref_idx1 >> 1 if fld else ref_idx1
                for c in range(3):
                    logwd = pw[0] if c == 0 else pw[1]
                    wt0 = pw[2][0][i0]
                    wt1 = pw[2][1][i1]
                    if c == 0:
                        w0, o0, w1, o1 = wt0[0], wt0[1], wt1[0], wt1[1]
                    else:
                        k = 2 * c
                        w0, o0 = wt0[k], wt0[k + 1]
                        w1, o1 = wt1[k], wt1[k + 1]
                    out[c] = HR._clip255(
                        ((p0[c] * w0 + p1[c] * w1 + (1 << logwd))
                         >> (logwd + 1)) + ((o0 + o1 + 1) >> 1))
            else:
                for c in range(3):
                    out[c] = (p0[c] + p1[c] + 1) >> 1
        else:
            l = 0 if p1 is None else 1
            p = p0 if p1 is None else p1
            ref_idx = ref_idx0 if p1 is None else ref_idx1
            weighted = (h.pred_weights is not None
                        and (h.slice_type != HR.SLICE_B
                             or pps.weighted_bipred_idc == 1))
            for c in range(3):
                out[c] = (self._wp_apply(p[c], l, ref_idx,
                                         c - 1 if c else -1, addr)
                          if weighted else p[c])
        predY[by4 * 4 : by4 * 4 + h4 * 4,
              bx4 * 4 : bx4 * 4 + w4 * 4] = out[0]
        predU[by4 * 2 : by4 * 2 + h4 * 2,
              bx4 * 2 : bx4 * 2 + w4 * 2] = out[1]
        predV[by4 * 2 : by4 * 2 + h4 * 2,
              bx4 * 2 : bx4 * 2 + w4 * 2] = out[2]

    def _mc_part(self, addr, predY, predU, predV, bx4, by4, w4, h4,
                 ref_idx: int, mvx: int, mvy: int) -> None:
        p0 = self._fetch_pred(addr, 0, ref_idx, bx4, by4, w4, h4, mvx, mvy)
        self._combine_store(addr, predY, predU, predV, bx4, by4, w4, h4,
                            p0, None, ref_idx, -1)

    def _store_mb(self, addr: int, predY, predU, predV) -> None:
        st, pic = self.st, self.pic
        x0 = st.luma_x0(addr)
        for yy in range(16):
            pic.Y[st.luma_y(addr, yy), x0 : x0 + 16] = np.clip(
                predY[yy], 0, 255)
        cx0 = (st.pair_of(addr) % st.mb_w) * 8
        for plane, pred in ((pic.U, predU), (pic.V, predV)):
            for yy in range(8):
                plane[st.chroma_y(addr, yy), cx0 : cx0 + 8] = np.clip(
                    pred[yy], 0, 255)

    # -- P macroblocks ------------------------------------------------------

    def _skip_mv(self, addr: int):
        """P_Skip motion (8.4.1.1 with MBAFF neighbours)."""
        A = self._mv_nbr(addr, -1, 0, 0)
        B = self._mv_nbr(addr, 0, -1, 0)
        if not A[0] or not B[0]:
            return (0, 0)
        if A[1] == 0 and A[2] == 0 and A[3] == 0:
            return (0, 0)
        if B[1] == 0 and B[2] == 0 and B[3] == 0:
            return (0, 0)
        return self._mv_pred(addr, 0, 0, 4, 4, 0)

    def decode_skip_mb(self, addr: int) -> None:
        if self.h.slice_type == HR.SLICE_B:
            self.decode_b_skip_mb(addr)
            return
        st = self.st
        self._mark_mb(addr)
        self.cur_addr = addr
        self.cur_z = 0
        st.mb_class[addr] = HR.MB_P
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = 0
        st.mb_skip[addr] = 1
        mvx, mvy = self._skip_mv(addr)
        self.cur_z = 16
        self._store_part_mv(addr, 0, 0, 4, 4, 0, mvx, mvy, 0)
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        self._mc_part(addr, predY, predU, predV, 0, 0, 4, 4, 0, mvx, mvy)
        self._store_mb(addr, predY, predU, predV)

    def _decode_p_mb(self, r: BitReader, addr: int, mb_type: int) -> None:
        st = self.st
        st.mb_class[addr] = HR.MB_P
        n0 = self.h.num_ref_idx[0]
        n0_mb = 2 * n0 if st.is_field(addr) else n0
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        sub_types = None
        if mb_type in (0, 1, 2):
            kind, parts = HR._SliceCtx._P_PARTS[mb_type]
            refs = [self._read_te(r, n0_mb - 1) for _ in parts]
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                mvdx, mvdy = r.se(), r.se()
                self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                px, py = self._mv_pred(addr, bx4, by4, w4, h4, refs[i],
                                       kind, i)
                mvx, mvy = px + mvdx, py + mvdy
                self._store_part_mv(addr, bx4, by4, w4, h4, refs[i],
                                    mvx, mvy, 0)
                self._store_part_mvd(addr, bx4, by4, w4, h4, 0, mvdx, mvdy)
                self._mc_part(addr, predY, predU, predV, bx4, by4, w4, h4,
                              refs[i], mvx, mvy)
        else:
            sub_types = [r.ue() for _ in range(4)]
            if any(stp > 3 for stp in sub_types):
                raise EOFError_(f"bad sub_mb_type {sub_types}")
            if mb_type == 3:
                refs = [self._read_te(r, n0_mb - 1) for _ in range(4)]
            else:
                refs = [0, 0, 0, 0]
            for b in range(4):
                bx0, by0 = (b & 1) * 2, (b >> 1) * 2
                for (sx, sy, w4, h4) in HR._SliceCtx._SUB_PARTS[sub_types[b]]:
                    bx4, by4 = bx0 + sx, by0 + sy
                    mvdx, mvdy = r.se(), r.se()
                    self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(addr, bx4, by4, w4, h4, refs[b])
                    mvx, mvy = px + mvdx, py + mvdy
                    self._store_part_mv(addr, bx4, by4, w4, h4, refs[b],
                                        mvx, mvy, 0)
                    self._store_part_mvd(addr, bx4, by4, w4, h4, 0,
                                         mvdx, mvdy)
                    self._mc_part(addr, predY, predU, predV, bx4, by4, w4, h4,
                                  refs[b], mvx, mvy)
        self.cur_z = 16
        tf8_ok = mb_type in (0, 1, 2) or all(stp == 0 for stp in sub_types)
        self._inter_residual(r, addr, predY, predU, predV, tf8_ok)

    @staticmethod
    def _read_te(r: BitReader, cmax: int) -> int:
        if cmax == 0:
            return 0
        if cmax == 1:
            return 1 - r.read(1)
        return r.ue()

    def _inter_residual(self, r: BitReader, addr: int, predY, predU, predV,
                        tf8_ok: bool) -> None:
        st, pic = self.st, self.pic
        cbp = T.GOLOMB_TO_INTER_CBP[r.ue()]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        tf8 = 0
        if cbp_luma and tf8_ok and self.pps.transform_8x8_mode:
            tf8 = r.read(1)
        st.mb_tf8[addr] = tf8
        if cbp:
            self.qp = (self.qp + r.se() + 52) % 52
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = cbp
        x0 = st.luma_x0(addr)
        if tf8:
            scan = self.scan8(addr)
            for b in range(4):
                bx, by = (b & 1) * 2, (b >> 1) * 2
                if not (cbp_luma & (1 << b)):
                    for yy in range(8):
                        pic.Y[st.luma_y(addr, by * 4 + yy),
                              x0 + bx * 4 : x0 + bx * 4 + 8] = np.clip(
                            predY[by * 4 + yy, bx * 4 : bx * 4 + 8], 0, 255)
                    continue
                scan64 = self._parse_luma8x8_cavlc(r, addr, b)
                ls = self._dq8(self.qp, 1)
                d = [0] * 64
                for s in range(64):
                    c = scan64[s]
                    if c:
                        pos = scan[s]
                        d[pos] = HR._dequant8_apply(c, ls[pos], self.qp)
                res = HR._idct8x8(d)
                for yy in range(8):
                    row = pic.Y[st.luma_y(addr, by * 4 + yy)]
                    base = 8 * yy
                    for xx in range(8):
                        row[x0 + bx * 4 + xx] = HR._clip1(
                            int(predY[by * 4 + yy, bx * 4 + xx])
                            + res[base + xx])
            self._pred_chroma = (predU, predV)
            self._decode_chroma_cavlc(r, addr, 0, cbp_chroma, False)
            return
        scan = self.scan4(addr)
        dq = self._dq4(self.qp, 3)
        for k in range(16):
            x4, y4 = HR._Z_TO_XY[k]
            if not (cbp_luma & (1 << (k >> 2))):
                for yy in range(4):
                    pic.Y[st.luma_y(addr, y4 * 4 + yy),
                          x0 + x4 * 4 : x0 + x4 * 4 + 4] = np.clip(
                        predY[y4 * 4 + yy, x4 * 4 : x4 * 4 + 4], 0, 255)
                continue
            self.cur_z = k
            nc = self._nc_luma(addr, x4, y4)
            blk, tc = HR._cavlc_block(r, nc, 16)
            st.nnz_y[addr, 4 * y4 + x4] = tc
            d = [0] * 16
            for s in range(16):
                c = blk[s]
                if c:
                    pos = scan[s]
                    d[pos] = HR._dequant4_apply(c, dq[pos], self.qp)
            res = HR._idct4x4(d)
            for yy in range(4):
                row = pic.Y[st.luma_y(addr, y4 * 4 + yy)]
                base = 4 * yy
                for xx in range(4):
                    row[x0 + x4 * 4 + xx] = HR._clip1(
                        int(predY[y4 * 4 + yy, x4 * 4 + xx]) + res[base + xx])
        self.cur_z = 16
        self._pred_chroma = (predU, predV)
        self._decode_chroma_cavlc(r, addr, 0, cbp_chroma, False)

    # -- B macroblocks (8.4.1.2 spatial direct with MBAFF colocated) --------

    def _n_act(self, addr: int, l: int) -> int:
        """Active reference count in the MB's own units (field MBs see a
        doubled field list, 8.4.2.1)."""
        n = self.h.num_ref_idx[l]
        return 2 * n if self.st.is_field(addr) else n

    def _col_fetch(self, addr: int, b: int):
        """Colocated corner-4x4 motion of RefPicList1[0] for the direct
        modes, with the MBAFF colocated selection + vertMvScale of
        8.4.1.2.2 applied: same structure -> same address; current
        frame MB over a field-coded col pair -> the col field whose POC
        is closer to the current picture (libavcodec col_parity), with
        field mv doubled (Fld_To_Frm); current field MB over a
        frame-coded col pair -> top/bottom col MB by band half, with
        frame mv halved (Frm_To_Fld). Returns (refIdxCol, refIdCol,
        (mvx, mvy)) preferring the col block's L0 motion, or None when
        it is intra; refIdCol uses the 4*pic_id+parity / 4*pic_id+3
        identity encoding of _ref_identity."""
        st = self.st
        if st.is_field(addr):
            col_frm, _ = self._field_ref(1, 0, addr)
        else:
            col_frm = self.ref_l1[0]
        colst = getattr(col_frm, "mbaff", None)
        px, py = st.pair_xy(addr)
        xs4 = 3 * (b & 1)
        ys4 = 3 * (b >> 1)
        cur_field = st.is_field(addr)
        scale = 1  # multiply col mvy by this ( /2 encoded via halve)
        halve = False
        if colst is None:
            # colocated picture is progressive (frame grid)
            if not cur_field:
                gy4 = py * 8 + 4 * (addr & 1) + ys4
            else:
                # current field MB over progressive col: band half
                # selects the row (Frm_To_Fld)
                gy4 = py * 8 + 2 * ys4
                halve = True
            gx4 = px * 4 + xs4
            for l in (0, 1):
                ref = int(col_frm.ref_idx[l, gy4, gx4])
                if ref >= 0:
                    mx = int(col_frm.mv[l, gy4, gx4, 0])
                    my = int(col_frm.mv[l, gy4, gx4, 1])
                    if halve:
                        my = int(my / 2) if my >= 0 else -((-my) // 2)
                    # progressive grids store plain pic_id (frame refs)
                    rid = 4 * int(col_frm.ref_id[l, gy4, gx4]) + 3
                    return ref, rid, (mx, my)
            return None
        # colocated picture is an MBAFF frame
        pair = py * st.mb_w + px
        col_field = bool(colst.field_flag[pair])
        if cur_field == col_field:
            col_addr = 2 * pair + (addr & 1)
            cell = 4 * ys4 + xs4
        elif cur_field:
            # current field, col pair frame: band half -> top/bottom MB
            line4 = 2 * ys4          # frame 4x4 row within the pair band
            col_addr = 2 * pair + (1 if line4 >= 4 else 0)
            cell = 4 * (line4 & 3) + xs4
            halve = True
        else:
            # current frame, col pair field: parity by POC distance
            cur_poc = self.pic.poc
            fp = col_frm.field_poc
            parity = 1 if abs(fp[0] - cur_poc) >= abs(fp[1] - cur_poc) else 0
            col_addr = 2 * pair + parity
            band_row = 4 * (addr & 1) + ys4
            cell = 4 * (band_row >> 1) + xs4
            scale = 2
        for l in (0, 1):
            ref = int(colst.ref_idx[col_addr, l, cell])
            if ref >= 0:
                mx = int(colst.mv[col_addr, l, cell, 0])
                my = int(colst.mv[col_addr, l, cell, 1]) * scale
                if halve:
                    my = int(my / 2) if my >= 0 else -((-my) // 2)
                return ref, int(colst.ref_id[col_addr, l, cell]), (mx, my)
        return None

    def _col_zero(self, addr: int, b: int) -> bool:
        """colZeroFlag for spatial direct (8.4.1.2.2): the colocated
        corner 4x4 of RefPicList1[0] is a zero-ish refIdx-0 motion."""
        if self.st.is_field(addr):
            col_frm, _ = self._field_ref(1, 0, addr)
        else:
            col_frm = self.ref_l1[0]
        if col_frm.long_term:
            return False
        cm = self._col_fetch(addr, b)
        if cm is None:
            return False
        ref, _, (mx, my) = cm
        return ref == 0 and abs(mx) <= 1 and abs(my) <= 1

    def _direct_spatial_cache_mbaff(self, addr: int):
        if self._direct_cache is not None:
            return self._direct_cache
        refs = [-1, -1]
        for l in (0, 1):
            A = self._mv_nbr(addr, -1, 0, l)
            B = self._mv_nbr(addr, 0, -1, l)
            C = self._mv_nbr(addr, 16, -1, l)
            if not C[0]:
                C = self._mv_nbr(addr, -1, -1, l)
            cand = [x[1] for x in (A, B, C) if x[1] >= 0]
            refs[l] = min(cand) if cand else -1
        dzp = refs[0] < 0 and refs[1] < 0
        if dzp:
            refs = [0, 0]
        mvps = [(0, 0), (0, 0)]
        for l in (0, 1):
            if refs[l] >= 0 and not dzp:
                mvps[l] = self._mv_pred(addr, 0, 0, 4, 4, refs[l], l=l)
        self._direct_cache = (refs, mvps, dzp)
        return self._direct_cache

    def _map_col_ref(self, addr: int, rid: int) -> int:
        """8.4.1.2.3 refIdxL0: lowest current-list-0 index referencing
        the frame (or the field of it) containing refPicCol.  For field
        macroblocks the index space is the relative field list; a
        frame-referencing colocated block maps to the field with the
        current macroblock's parity (libavcodec fill_colmap)."""
        pic_id, par = rid >> 2, rid & 3
        if not self.st.is_field(addr):
            for i, f in enumerate(self.ref_l0):
                if f.pic_id == pic_id:
                    return i
            return 0
        want_par = (addr & 1) if par == 3 else par
        for r in range(2 * len(self.ref_l0)):
            f, pr = self._field_ref(0, r, addr)
            if f.pic_id == pic_id and pr == want_par:
                return r
        return 0

    def _direct_temporal_8x8(self, addr: int, b: int):
        """Temporal direct (8.4.1.2.3) with the MBAFF colocated mapping:
        POC distances use the current field's parity when the macroblock
        is field-coded (currPicOrField / pic0 / pic1 are fields)."""
        cm = self._col_fetch(addr, b)
        if cm is None:
            ref0, mvcol = 0, (0, 0)
        else:
            _, rid, mvcol = cm
            ref0 = self._map_col_ref(addr, rid)
        p = addr & 1
        if self.st.is_field(addr):
            cur_poc = self.pic.field_poc[p]
            f0, p0 = self._field_ref(0, ref0, addr)
            poc0 = f0.field_poc[p0]
            f1, p1 = self._field_ref(1, 0, addr)
            poc1 = f1.field_poc[p1]
            lt0 = f0.long_term
        else:
            cur_poc = self.pic.poc
            poc0 = self.ref_l0[ref0].poc
            poc1 = self.ref_l1[0].poc
            lt0 = self.ref_l0[ref0].long_term
        tb = min(127, max(-128, cur_poc - poc0))
        td = min(127, max(-128, poc1 - poc0))
        if lt0 or td == 0:
            return [(ref0, mvcol), (0, (0, 0))]
        q = 16384 + abs(td) // 2
        tx = (q // abs(td)) * (1 if td > 0 else -1)
        dsf = min(1023, max(-1024, (tb * tx + 32) >> 6))
        mv0 = ((dsf * mvcol[0] + 128) >> 8, (dsf * mvcol[1] + 128) >> 8)
        mv1 = (mv0[0] - mvcol[0], mv0[1] - mvcol[1])
        return [(ref0, mv0), (0, mv1)]

    def _direct_mvs_8x8(self, addr: int, b: int):
        if not self.h.direct_spatial_mv_pred:
            return self._direct_temporal_8x8(addr, b)
        refs, mvps, dzp = self._direct_spatial_cache_mbaff(addr)
        cz = self._col_zero(addr, b)
        out = []
        for l in (0, 1):
            if refs[l] < 0:
                out.append((-1, (0, 0)))
            elif dzp or (cz and refs[l] == 0):
                out.append((refs[l], (0, 0)))
            else:
                out.append((refs[l], mvps[l]))
        return out

    def _decode_direct_8x8(self, addr: int, b: int, predY, predU,
                           predV) -> None:
        (r0, mv0), (r1, mv1) = self._direct_mvs_8x8(addr, b)
        bx4, by4 = (b & 1) * 2, (b >> 1) * 2
        st = self.st
        for y in range(by4, by4 + 2):
            for x in range(bx4, bx4 + 2):
                st.cell_direct[addr, 4 * y + x] = 1
        if r0 >= 0:
            self._store_part_mv(addr, bx4, by4, 2, 2, r0, mv0[0], mv0[1], 0)
        if r1 >= 0:
            self._store_part_mv(addr, bx4, by4, 2, 2, r1, mv1[0], mv1[1], 1)
        p0 = (self._fetch_pred(addr, 0, r0, bx4, by4, 2, 2, mv0[0], mv0[1])
              if r0 >= 0 else None)
        p1 = (self._fetch_pred(addr, 1, r1, bx4, by4, 2, 2, mv1[0], mv1[1])
              if r1 >= 0 else None)
        self._combine_store(addr, predY, predU, predV, bx4, by4, 2, 2,
                            p0, p1, r0, r1)

    def decode_b_skip_mb(self, addr: int) -> None:
        st = self.st
        self._mark_mb(addr)
        self.cur_addr = addr
        self.cur_z = 0
        self._direct_cache = None
        st.mb_class[addr] = HR.MB_B
        st.mb_qp[addr] = self.qp
        st.mb_cbp[addr] = 0
        st.mb_skip[addr] = 1
        st.mb_bdirect[addr] = 1
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        for b in range(4):
            self._decode_direct_8x8(addr, b, predY, predU, predV)
        self._store_mb(addr, predY, predU, predV)

    def _decode_b_mb(self, r: BitReader, addr: int, mb_type: int) -> None:
        st = self.st
        self._direct_cache = None
        st.mb_class[addr] = HR.MB_B
        predY = np.empty((16, 16), np.int32)
        predU = np.empty((8, 8), np.int32)
        predV = np.empty((8, 8), np.int32)
        if mb_type == 0:  # B_Direct_16x16
            st.mb_bdirect[addr] = 1
            for b in range(4):
                self._decode_direct_8x8(addr, b, predY, predU, predV)
            self.cur_z = 16
            self._inter_residual(r, addr, predY, predU, predV,
                                 bool(self.sps.direct_8x8_inference))
            return
        tf8_ok = True
        SC = HR._SliceCtx
        if mb_type < 22:
            kind, preds = SC._B_TYPES[mb_type]
            parts = SC._PART_GEOM[kind]
            np_ = len(parts)
            refs = [[-1] * np_, [-1] * np_]
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        refs[l][i] = self._read_te(r, self._n_act(addr, l) - 1)
            mvds = [[(0, 0)] * np_, [(0, 0)] * np_]
            for l in (0, 1):
                for i, pm in enumerate(preds):
                    if pm == 2 or pm == l:
                        mvds[l][i] = (r.se(), r.se())
            mvs = [[None] * np_, [None] * np_]
            for l in (0, 1):
                for i, (bx4, by4, w4, h4) in enumerate(parts):
                    if refs[l][i] < 0:
                        continue
                    self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(addr, bx4, by4, w4, h4,
                                           refs[l][i], kind, i, l)
                    mv = (px + mvds[l][i][0], py + mvds[l][i][1])
                    mvs[l][i] = mv
                    self._store_part_mv(addr, bx4, by4, w4, h4, refs[l][i],
                                        mv[0], mv[1], l)
                    self._store_part_mvd(addr, bx4, by4, w4, h4, l,
                                         mvds[l][i][0], mvds[l][i][1])
            for i, (bx4, by4, w4, h4) in enumerate(parts):
                p0 = (self._fetch_pred(addr, 0, refs[0][i], bx4, by4, w4, h4,
                                       *mvs[0][i]) if refs[0][i] >= 0
                      else None)
                p1 = (self._fetch_pred(addr, 1, refs[1][i], bx4, by4, w4, h4,
                                       *mvs[1][i]) if refs[1][i] >= 0
                      else None)
                self._combine_store(addr, predY, predU, predV, bx4, by4,
                                    w4, h4, p0, p1, refs[0][i], refs[1][i])
        else:  # B_8x8
            sub_types = [r.ue() for _ in range(4)]
            if any(stp > 12 for stp in sub_types):
                raise EOFError_(f"bad B sub_mb_type {sub_types}")
            for b in range(4):
                if SC._B_SUB[sub_types[b]][0] == -1:
                    self.cur_z = HR._XY_TO_Z[((b & 1) * 2, (b >> 1) * 2)]
                    self._decode_direct_8x8(addr, b, predY, predU, predV)
            refs = [[-1] * 4, [-1] * 4]
            for l in (0, 1):
                for b in range(4):
                    pm = SC._B_SUB[sub_types[b]][0]
                    if pm == 2 or pm == l:
                        refs[l][b] = self._read_te(r, self._n_act(addr, l) - 1)
            mvds = [[], []]
            for l in (0, 1):
                for b in range(4):
                    pm, sparts = SC._B_SUB[sub_types[b]]
                    if pm == -1 or not (pm == 2 or pm == l):
                        continue
                    for sp in sparts:
                        mvds[l].append((b, sp, (r.se(), r.se())))
            submvs = {}
            for l in (0, 1):
                for (b, sp, mvd) in mvds[l]:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    self.cur_z = HR._XY_TO_Z[(bx4, by4)]
                    px, py = self._mv_pred(addr, bx4, by4, w4, h4,
                                           refs[l][b], l=l)
                    mv = (px + mvd[0], py + mvd[1])
                    submvs[(l, b, sp)] = mv
                    self._store_part_mv(addr, bx4, by4, w4, h4, refs[l][b],
                                        mv[0], mv[1], l)
                    self._store_part_mvd(addr, bx4, by4, w4, h4, l,
                                         mvd[0], mvd[1])
            for b in range(4):
                pm, sparts = SC._B_SUB[sub_types[b]]
                if pm == -1:
                    continue
                for sp in sparts:
                    sx, sy, w4, h4 = sp
                    bx4, by4 = (b & 1) * 2 + sx, (b >> 1) * 2 + sy
                    p0 = p1 = None
                    if refs[0][b] >= 0:
                        p0 = self._fetch_pred(addr, 0, refs[0][b], bx4, by4,
                                              w4, h4, *submvs[(0, b, sp)])
                    if refs[1][b] >= 0:
                        p1 = self._fetch_pred(addr, 1, refs[1][b], bx4, by4,
                                              w4, h4, *submvs[(1, b, sp)])
                    self._combine_store(addr, predY, predU, predV, bx4, by4,
                                        w4, h4, p0, p1, refs[0][b],
                                        refs[1][b])
            tf8_ok = all(
                (stp == 0 and self.sps.direct_8x8_inference)
                or stp in (1, 2, 3)
                for stp in sub_types)
        self.cur_z = 16
        self._inter_residual(r, addr, predY, predU, predV, tf8_ok)


class _MbaffDeblock:
    """In-place MBAFF deblocking (8.7 with MbaffFrameFlag = 1).

    MB-address order, vertical edges then horizontal, on each MB's own
    line map.  MBAFF-specific rules (pinned against libavcodec):
    - horizontal macroblock edges cap at bS 3 for intra (bS 4 needs a
      vertical edge when MbaffFrameFlag is 1);
    - mixed frame/field edges never compare motion (bS >= 1);
    - a mixed LEFT edge is filtered as two passes of 8 lines (one per
      left-pair MB), bS per 2 lines;
    - the top edge of a frame MB below a FIELD pair is filtered as two
      field-mode passes (parity f: q rows f, f+2, f+4 against the
      parity-f field MB's last rows).
    """

    def __init__(self, pic):
        self.pic = pic
        self.st: MbaffState = pic.mbaff
        pps_coff = (pic.pps.chroma_qp_index_offset,
                    pic.pps.second_chroma_qp_index_offset)
        self.coff = pps_coff

    # -- per-cell coded flag (tf8-aware, like h264_ref._nnz_for_bs) --------

    def _coded(self, addr: int, cx: int, cy: int) -> bool:
        st = self.st
        if st.mb_tf8[addr]:
            x0, y0 = cx & ~1, cy & ~1
            return bool(st.nnz_y[addr, 4 * y0 + x0]
                        or st.nnz_y[addr, 4 * y0 + x0 + 1]
                        or st.nnz_y[addr, 4 * (y0 + 1) + x0]
                        or st.nnz_y[addr, 4 * (y0 + 1) + x0 + 1])
        return bool(st.nnz_y[addr, 4 * cy + cx])

    def _bs_mv(self, addrP, cellP, addrQ, cellQ) -> int:
        st = self.st
        # 8.7.2.1: the vertical MV-difference threshold is 4 quarter
        # FRAME samples = 2 quarter FIELD samples for field macroblocks
        vth = 2 if st.is_field(addrQ) else 4
        up, uq = [], []
        for l in range(2):
            rp = int(st.ref_id[addrP, l, cellP])
            if rp >= 0:
                up.append((rp, (int(st.mv[addrP, l, cellP, 0]),
                                int(st.mv[addrP, l, cellP, 1]))))
            rq = int(st.ref_id[addrQ, l, cellQ])
            if rq >= 0:
                uq.append((rq, (int(st.mv[addrQ, l, cellQ, 0]),
                                int(st.mv[addrQ, l, cellQ, 1]))))
        if len(up) != len(uq):
            return 1
        if sorted(r for r, _ in up) != sorted(r for r, _ in uq):
            return 1

        def far(a, b):
            return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= vth

        if len(up) == 1:
            return 1 if far(up[0][1], uq[0][1]) else 0
        if len(up) == 0:
            return 0
        if up[0][0] != up[1][0]:
            for r, mv in up:
                mv2 = next(m for rr, m in uq if rr == r)
                if far(mv, mv2):
                    return 1
            return 0
        a = not far(up[0][1], uq[0][1]) and not far(up[1][1], uq[1][1])
        b = not far(up[0][1], uq[1][1]) and not far(up[1][1], uq[0][1])
        return 0 if (a or b) else 1

    def _bs(self, addrP, cellP, addrQ, cellQ, mb_edge: bool,
            vertical: bool) -> int:
        st = self.st
        if st.is_intra(addrP) or st.is_intra(addrQ):
            # 8.7.2.1: intra MB edges are bS 4 on vertical edges and on
            # horizontal edges between two FRAME macroblocks; horizontal
            # edges involving field macroblocks cap at 3
            if mb_edge and (vertical or (not st.is_field(addrP)
                                         and not st.is_field(addrQ))):
                return 4
            return 3
        if (self._coded(addrP, cellP & 3, cellP >> 2)
                or self._coded(addrQ, cellQ & 3, cellQ >> 2)):
            return 2
        if st.is_field(addrP) != st.is_field(addrQ):
            return 1
        return self._bs_mv(addrP, cellP, addrQ, cellQ)

    def _thresholds(self, addrP, addrQ, bs, chroma_comp):
        st = self.st
        qpp = int(st.mb_qp[addrP])
        qpq = int(st.mb_qp[addrQ])
        if chroma_comp is None:
            qav = (qpp + qpq + 1) >> 1
        else:
            qav = (HR.chroma_qp(qpp, self.coff[chroma_comp])
                   + HR.chroma_qp(qpq, self.coff[chroma_comp]) + 1) >> 1
        aoff = int(st.mb_alpha_off[addrQ])
        boff = int(st.mb_beta_off[addrQ])
        ia = min(51, max(0, qav + aoff))
        ib = min(51, max(0, qav + boff))
        alpha = T.DEBLOCK_ALPHA[ia]
        beta = T.DEBLOCK_BETA[ib]
        tc0 = T.DEBLOCK_TC0[bs - 1][ia] if bs < 4 else 0
        return alpha, beta, tc0

    # -- line filters over explicit sample index lists ----------------------

    def _filter_v(self, plane, line, x, bs, alpha, beta, tc0, luma):
        HR._deblock_line(plane, line, x, 0, 1, bs, alpha, beta, tc0, luma)

    def _filter_h(self, plane, x, q_lines, p_lines, bs, alpha, beta, tc0,
                  luma):
        """Horizontal-edge filter with explicit absolute line lists:
        q_lines[k] = line of q_k, p_lines[k] = line of p_k (4 entries
        each when bS is 4 and luma — the strong filter reads p3/q3)."""
        p0 = int(plane[p_lines[0], x])
        p1 = int(plane[p_lines[1], x])
        p2 = int(plane[p_lines[2], x])
        q0 = int(plane[q_lines[0], x])
        q1 = int(plane[q_lines[1], x])
        q2 = int(plane[q_lines[2], x])
        if (abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta
                or abs(q1 - q0) >= beta):
            return
        ap = abs(p2 - p0)
        aq = abs(q2 - q0)
        if bs < 4:
            if luma:
                tc = tc0 + (1 if ap < beta else 0) + (1 if aq < beta else 0)
            else:
                tc = tc0 + 1
            delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
            delta = -tc if delta < -tc else tc if delta > tc else delta
            plane[p_lines[0], x] = HR._clip1(p0 + delta)
            plane[q_lines[0], x] = HR._clip1(q0 - delta)
            if luma and ap < beta:
                d = (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1
                d = -tc0 if d < -tc0 else tc0 if d > tc0 else d
                plane[p_lines[1], x] = p1 + d
            if luma and aq < beta:
                d = (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1
                d = -tc0 if d < -tc0 else tc0 if d > tc0 else d
                plane[q_lines[1], x] = q1 + d
            return
        if luma:
            strong = abs(p0 - q0) < (alpha >> 2) + 2
            if strong and ap < beta:
                p3 = int(plane[p_lines[3], x])
                plane[p_lines[0], x] = (
                    p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                plane[p_lines[1], x] = (p2 + p1 + p0 + q0 + 2) >> 2
                plane[p_lines[2], x] = (
                    2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
            else:
                plane[p_lines[0], x] = (2 * p1 + p0 + q1 + 2) >> 2
            if strong and aq < beta:
                q3 = int(plane[q_lines[3], x])
                plane[q_lines[0], x] = (
                    q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                plane[q_lines[1], x] = (q2 + q1 + q0 + p0 + 2) >> 2
                plane[q_lines[2], x] = (
                    2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
            else:
                plane[q_lines[0], x] = (2 * q1 + q0 + p1 + 2) >> 2
        else:
            plane[p_lines[0], x] = (2 * p1 + p0 + q1 + 2) >> 2
            plane[q_lines[0], x] = (2 * q1 + q0 + p1 + 2) >> 2

    # -- per-MB driver ------------------------------------------------------

    def _p_mb_of_line(self, line: int, pair_x: int, chroma: bool):
        band = 16 if chroma else 32
        st = self.st
        pair_y = line // band
        pair = pair_y * st.mb_w + pair_x
        local = line - pair_y * band
        if st.field_flag[pair]:
            return 2 * pair + (local & 1), local >> 1
        half = band // 2
        if local < half:
            return 2 * pair, local
        return 2 * pair + 1, local - half

    def deblock_mb(self, addr: int) -> None:
        st, pic = self.st, self.pic
        px, py = st.pair_xy(addr)
        disable = int(st.mb_disable[addr])
        tf8 = int(st.mb_tf8[addr])
        sid = int(st.slice_id[addr])
        x0 = st.luma_x0(addr)
        cx0 = px * 8
        Y = pic.Y

        def mb_ok(addrN: int) -> bool:
            if st.slice_id[addrN] < 0:
                return False
            if disable == 2 and st.slice_id[addrN] != sid:
                return False
            return True

        # ---- vertical edges ----
        for e in range(4):
            if e == 0:
                if px == 0:
                    continue
                left_pair = py * st.mb_w + px - 1
                mixed = bool(st.field_flag[left_pair]) != st.is_field(addr)
                if mixed:
                    # two passes: one per left-pair MB, 8 lines each,
                    # bS per 2 lines
                    for j in range(2):
                        addrP = 2 * left_pair + j
                        if not mb_ok(addrP):
                            continue
                        if st.is_field(addr):
                            rows = [8 * j + i for i in range(8)]
                        else:
                            rows = [j + 2 * i for i in range(8)]
                        for g in range(4):
                            r0, r1 = rows[2 * g], rows[2 * g + 1]
                            line0 = st.luma_y(addr, r0)
                            _, pr = self._p_mb_of_line(line0, px - 1, False)
                            cellQ = 4 * (r0 >> 2)
                            cellP = 4 * (pr >> 2) + 3
                            bs = self._bs(addrP, cellP, addr, cellQ,
                                          True, True)
                            if bs == 0:
                                continue
                            alpha, beta, tc0 = self._thresholds(
                                addrP, addr, bs, None)
                            if alpha == 0 or beta == 0:
                                continue
                            for rr in (r0, r1):
                                self._filter_v(Y, st.luma_y(addr, rr), x0,
                                               bs, alpha, beta, tc0, True)
                            # chroma: one line per 2 luma lines
                            # (curr field pass j: rows 4j+g; curr frame
                            # pass j: rows j + 2g)
                            if st.is_field(addr):
                                crow = 4 * j + g
                            else:
                                crow = j + 2 * g
                            cl = st.chroma_y(addr, crow)
                            for comp, plane in ((0, pic.U), (1, pic.V)):
                                ca, cbta, ctc0 = self._thresholds(
                                    addrP, addr, bs, comp)
                                if ca == 0 or cbta == 0:
                                    continue
                                HR._deblock_line(plane, cl, cx0, 0, 1, bs,
                                                 ca, cbta, ctc0, False)
                    continue
                addrP = 2 * left_pair + (addr & 1)
                if not mb_ok(addrP):
                    continue
                for seg in range(4):
                    cellQ = 4 * seg
                    cellP = 4 * seg + 3
                    bs = self._bs(addrP, cellP, addr, cellQ, True, True)
                    if bs == 0:
                        continue
                    alpha, beta, tc0 = self._thresholds(addrP, addr, bs,
                                                        None)
                    if alpha != 0 and beta != 0:
                        for i in range(4):
                            self._filter_v(Y, st.luma_y(addr, 4 * seg + i),
                                           x0, bs, alpha, beta, tc0, True)
                    for comp, plane in ((0, pic.U), (1, pic.V)):
                        ca, cb, ctc0 = self._thresholds(addrP, addr, bs,
                                                        comp)
                        if ca == 0 or cb == 0:
                            continue
                        for i in range(2):
                            HR._deblock_line(
                                plane, st.chroma_y(addr, 2 * seg + i), cx0,
                                0, 1, bs, ca, cb, ctc0, False)
                continue
            if tf8 and (e & 1):
                continue
            for seg in range(4):
                cellQ = 4 * seg + e
                cellP = 4 * seg + e - 1
                bs = self._bs(addr, cellP, addr, cellQ, False, True)
                if bs == 0:
                    continue
                alpha, beta, tc0 = self._thresholds(addr, addr, bs, None)
                if alpha != 0 and beta != 0:
                    for i in range(4):
                        self._filter_v(Y, st.luma_y(addr, 4 * seg + i),
                                       x0 + 4 * e, bs, alpha, beta, tc0,
                                       True)
                if e == 2:
                    for comp, plane in ((0, pic.U), (1, pic.V)):
                        ca, cb, ctc0 = self._thresholds(addr, addr, bs,
                                                        comp)
                        if ca == 0 or cb == 0:
                            continue
                        for i in range(2):
                            HR._deblock_line(
                                plane, st.chroma_y(addr, 2 * seg + i),
                                cx0 + 4, 0, 1, bs, ca, cb, ctc0, False)

        # ---- horizontal edges ----
        for e in range(4):
            if e == 0:
                top_line = st.luma_y(addr, -1)
                if top_line < 0:
                    continue
                # the special two-pass case applies only to the TOP MB of
                # a FRAME pair whose ABOVE pair is field-coded
                special = (not st.is_field(addr) and (addr & 1) == 0
                           and py > 0
                           and bool(st.field_flag[(py - 1) * st.mb_w + px]))
                if special:
                    above_pair = (py - 1) * st.mb_w + px
                    for f in range(2):
                        addrP = 2 * above_pair + f
                        if not mb_ok(addrP):
                            continue
                        q_lines = [st.luma_y(addr, f + 2 * k)
                                   for k in range(4)]
                        p_lines = [st.luma_y(addrP, 15 - k)
                                   for k in range(4)]
                        for seg in range(4):
                            cellQ = seg
                            cellP = 12 + seg
                            bs = self._bs(addrP, cellP, addr, cellQ,
                                          True, False)
                            if bs == 0:
                                continue
                            alpha, beta, tc0 = self._thresholds(
                                addrP, addr, bs, None)
                            if alpha != 0 and beta != 0:
                                for i in range(4):
                                    self._filter_h(Y, x0 + 4 * seg + i,
                                                   q_lines, p_lines, bs,
                                                   alpha, beta, tc0, True)
                            for comp, plane in ((0, pic.U), (1, pic.V)):
                                ca, cb, ctc0 = self._thresholds(
                                    addrP, addr, bs, comp)
                                if ca == 0 or cb == 0:
                                    continue
                                cq = [st.chroma_y(addr, f + 2 * k)
                                      for k in range(3)]
                                cp = [st.chroma_y(addrP, 7 - k)
                                      for k in range(3)]
                                for i in range(2):
                                    self._filter_h(plane,
                                                   cx0 + 2 * seg + i,
                                                   cq, cp, bs, ca, cb,
                                                   ctc0, False)
                    continue
                addrP, prow = self._p_mb_of_line(top_line, px, False)
                if not mb_ok(addrP):
                    continue
                q_lines = [st.luma_y(addr, k) for k in range(4)]
                p_lines = [st.luma_y(addr, -1 - k) for k in range(4)]
                mb_edge = addrP != addr
                for seg in range(4):
                    cellQ = seg
                    cellP = 4 * (prow >> 2) + seg
                    bs = self._bs(addrP, cellP, addr, cellQ, mb_edge,
                                  False)
                    if bs == 0:
                        continue
                    alpha, beta, tc0 = self._thresholds(addrP, addr, bs,
                                                        None)
                    if alpha != 0 and beta != 0:
                        for i in range(4):
                            self._filter_h(Y, x0 + 4 * seg + i, q_lines,
                                           p_lines, bs, alpha, beta, tc0,
                                           True)
                    for comp, plane in ((0, pic.U), (1, pic.V)):
                        ca, cb, ctc0 = self._thresholds(addrP, addr, bs,
                                                        comp)
                        if ca == 0 or cb == 0:
                            continue
                        cq = [st.chroma_y(addr, k) for k in range(3)]
                        cp = [st.chroma_y(addr, -1 - k) for k in range(3)]
                        for i in range(2):
                            self._filter_h(plane, cx0 + 2 * seg + i, cq,
                                           cp, bs, ca, cb, ctc0, False)
                continue
            if tf8 and (e & 1):
                continue
            q_lines = [st.luma_y(addr, 4 * e + k) for k in range(4)]
            p_lines = [st.luma_y(addr, 4 * e - 1 - k) for k in range(4)]
            for seg in range(4):
                cellQ = 4 * e + seg
                cellP = 4 * (e - 1) + seg
                bs = self._bs(addr, cellP, addr, cellQ, False, False)
                if bs == 0:
                    continue
                alpha, beta, tc0 = self._thresholds(addr, addr, bs, None)
                if alpha != 0 and beta != 0:
                    for i in range(4):
                        self._filter_h(Y, x0 + 4 * seg + i, q_lines,
                                       p_lines, bs, alpha, beta, tc0, True)
                if e == 2:
                    cq = [st.chroma_y(addr, 4 + k) for k in range(3)]
                    cp = [st.chroma_y(addr, 3 - k) for k in range(3)]
                    for comp, plane in ((0, pic.U), (1, pic.V)):
                        ca, cb, ctc0 = self._thresholds(addr, addr, bs,
                                                        comp)
                        if ca == 0 or cb == 0:
                            continue
                        for i in range(2):
                            self._filter_h(plane, cx0 + 2 * seg + i, cq,
                                           cp, bs, ca, cb, ctc0, False)


def deblock_picture_mbaff(pic) -> None:
    """MBAFF deblocking driver (8.7, MbaffFrameFlag = 1)."""
    st = pic.mbaff
    db = _MbaffDeblock(pic)
    n = st.mb_w * st.mb_h
    for addr in range(n):
        if st.slice_id[addr] < 0:
            continue
        if st.mb_disable[addr] == 1:
            continue
        db.deblock_mb(addr)


# ---------------------------------------------------------------------------
# CABAC MBAFF (9.3 with MbaffFrameFlag): pair-aware contexts + field
# residual context blocks (Table 9-40: field-coded MBs use sig/last
# ctxIdxOffsets 277/338 for 4x4 categories and 436/451 for 8x8).
# ---------------------------------------------------------------------------

from . import h264_cabac as HC


class MbaffCabac:
    """CABAC syntax parser driving an MbaffSlice."""

    def __init__(self, sl: MbaffSlice, rbsp: bytes, h):
        self.sl = sl
        self.st = sl.st
        self.h = h
        st_i = h.slice_type == HR.SLICE_I
        self.e = HC.CabacEngine(
            rbsp, h.data_bit_pos,
            HC.init_contexts(st_i, h.cabac_init_idc, h.slice_qp))
        self.prev_qp_delta_nz = 0

    # -- MB-level neighbours (via the line-map derivation) ------------------

    def _mb_nbr(self, addr: int, xN: int, yN: int):
        r = self.sl._nbr(addr, xN, yN, False)
        if r is None:
            return None
        return r[0]

    def mb_skip_flag(self, addr: int) -> int:
        st = self.st
        base = 11 if self.h.slice_type == HR.SLICE_P else 24
        ctx = 0
        for n in (self._mb_nbr(addr, -1, 0), self._mb_nbr(addr, 0, -1)):
            if n is not None and not st.mb_skip[n]:
                ctx += 1
        return self.e.decision(base + ctx)

    def mb_field_decoding_flag(self, addr: int) -> int:
        """9.3.3.1.1.2: ctx from the field flags of the left and above
        PAIRS (available = top MB in this slice)."""
        st, sl = self.st, self.sl
        pair = addr >> 1
        px, py = pair % st.mb_w, pair // st.mb_w
        ctx = 0
        if px > 0 and st.slice_id[2 * (pair - 1)] == sl.sid:
            ctx += int(st.field_flag[pair - 1])
        if py > 0 and st.slice_id[2 * (pair - st.mb_w)] == sl.sid:
            ctx += int(st.field_flag[pair - st.mb_w])
        return self.e.decision(70 + ctx)

    def _intra_mb_type(self, ctx_base: int, intra_slice: bool,
                       addr: int) -> int:
        e = self.e
        st = self.st
        base = ctx_base
        if intra_slice:
            ctx = 0
            for n in (self._mb_nbr(addr, -1, 0), self._mb_nbr(addr, 0, -1)):
                if n is not None and st.mb_class[n] in (HR.MB_I16,
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

    def mb_type_i(self, addr: int) -> int:
        return self._intra_mb_type(3, True, addr)

    def mb_type_p(self, addr: int) -> int:
        e = self.e
        if e.decision(14):
            return 5 + self._intra_mb_type(17, False, addr)
        if e.decision(15) == 0:
            return 3 * e.decision(16)
        return 2 - e.decision(17)

    def mb_type_b(self, addr: int) -> int:
        e = self.e
        st = self.st
        ctx = 0
        for n in (self._mb_nbr(addr, -1, 0), self._mb_nbr(addr, 0, -1)):
            if n is not None and not st.mb_bdirect[n]:
                ctx += 1
        if not e.decision(27 + ctx):
            return 0
        if not e.decision(27 + 3):
            return 1 + e.decision(27 + 5)
        bits = e.decision(27 + 4) << 3
        bits |= e.decision(27 + 5) << 2
        bits |= e.decision(27 + 5) << 1
        bits |= e.decision(27 + 5)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23 + self._intra_mb_type(32, False, addr)
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

    def intra_pred_mode(self, pred: int) -> int:
        e = self.e
        if e.decision(68):
            return pred
        rem = e.decision(69)
        rem |= e.decision(69) << 1
        rem |= e.decision(69) << 2
        return rem if rem < pred else rem + 1

    def chroma_pred_mode(self, addr: int) -> int:
        e = self.e
        st = self.st
        ctx = 0
        for n in (self._mb_nbr(addr, -1, 0), self._mb_nbr(addr, 0, -1)):
            if n is not None and st.mb_chroma_mode[n] != 0:
                ctx += 1
        if not e.decision(64 + ctx):
            return 0
        if not e.decision(67):
            return 1
        return 3 if e.decision(67) else 2

    def transform_size_8x8(self, addr: int) -> int:
        st = self.st
        ctx = 0
        for n in (self._mb_nbr(addr, -1, 0), self._mb_nbr(addr, 0, -1)):
            if n is not None and st.mb_tf8[n]:
                ctx += 1
        return self.e.decision(399 + ctx)

    def _cbp_luma_bit(self, addr: int, b: int, cur_bits: int) -> int:
        st, sl = self.st, self.sl
        x8, y8 = (b & 1), (b >> 1)

        def cond(xN, yN, nb_within):
            r = sl._nbr(addr, xN, yN, False)
            if r is None:
                return 0
            addrN, xW, yW = r
            if addrN == addr:
                nb = (xW >> 3) + 2 * (yW >> 3)
                return 1 if not (cur_bits & (1 << nb)) else 0
            if st.mb_class[addrN] == HR.MB_IPCM:
                return 0
            nb = (xW >> 3) + 2 * (yW >> 3)
            return 1 if not (int(st.mb_cbp[addrN]) & (1 << nb)) else 0

        ca = cond(8 * x8 - 1, 8 * y8, None)
        cb = cond(8 * x8, 8 * y8 - 1, None)
        return self.e.decision(73 + ca + 2 * cb)

    def cbp(self, addr: int) -> int:
        bits = 0
        for b in range(4):
            bits |= self._cbp_luma_bit(addr, b, bits) << b
        st = self.st

        def cchroma(n, want2):
            if n is None:
                return 0
            if st.mb_class[n] == HR.MB_IPCM:
                return 1
            cc = int(st.mb_cbp[n]) >> 4
            return 1 if (cc == 2 if want2 else cc != 0) else 0

        na = self._mb_nbr(addr, -1, 0)
        nb = self._mb_nbr(addr, 0, -1)
        if self.e.decision(77 + cchroma(na, False) + 2 * cchroma(nb, False)):
            chroma = 2 if self.e.decision(
                81 + cchroma(na, True) + 2 * cchroma(nb, True)) else 1
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

    # -- motion -------------------------------------------------------------

    def ref_idx(self, addr: int, l: int, bx4: int, by4: int) -> int:
        e = self.e
        st, sl = self.st, self.sl
        is_b = self.h.slice_type == HR.SLICE_B
        ctx = 0
        for side, (xN, yN) in enumerate(((4 * bx4 - 1, 4 * by4),
                                         (4 * bx4, 4 * by4 - 1))):
            r = sl._nbr(addr, xN, yN, False)
            if r is None:
                continue
            addrN, xW, yW = r
            if (addrN == addr
                    and HR._XY_TO_Z[(xW >> 2, yW >> 2)] >= sl.cur_z):
                continue
            cell = 4 * (yW >> 2) + (xW >> 2)
            ref = int(st.ref_idx[addrN, l, cell])
            if ref < 0:
                continue
            # refIdxZeroFlag scaling (9.3.3.1.1.6)
            if st.is_field(addrN) and not st.is_field(addr):
                ref >>= 1
            elif st.is_field(addr) and not st.is_field(addrN):
                ref *= 2
            if ref > 0 and not (is_b and st.cell_direct[addrN, cell]):
                ctx += 1 << side
        ref = 0
        while e.decision(54 + ctx):
            ref += 1
            if ref > 32:
                raise ValueError("bad ref_idx")
            ctx = (ctx >> 2) + 4
        return ref

    def _mvd_nbr_abs(self, addr: int, xN: int, yN: int, l: int,
                     comp: int) -> int:
        st, sl = self.st, self.sl
        r = sl._nbr(addr, xN, yN, False)
        if r is None:
            return 0
        addrN, xW, yW = r
        if addrN == addr and HR._XY_TO_Z[(xW >> 2, yW >> 2)] >= sl.cur_z:
            return 0
        cell = 4 * (yW >> 2) + (xW >> 2)
        v = abs(int(st.mvd[addrN, l, cell, comp]))
        if comp == 1:
            # vertical mvd scaling across interleaves (libavcodec
            # mvd_cache MAP_F2F: shifts)
            if st.is_field(addrN) and not st.is_field(addr):
                v <<= 1
            elif st.is_field(addr) and not st.is_field(addrN):
                v >>= 1
        return v

    def mvd(self, addr: int, l: int, bx4: int, by4: int, comp: int) -> int:
        e = self.e
        amvd = (self._mvd_nbr_abs(addr, 4 * bx4 - 1, 4 * by4, l, comp)
                + self._mvd_nbr_abs(addr, 4 * bx4, 4 * by4 - 1, l, comp))
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

    # -- residual blocks ----------------------------------------------------

    def _cbf_nbr(self, addr: int, cat: int, info, side: int) -> int:
        st, sl = self.st, self.sl
        cur_intra = st.is_intra(addr)
        if cat in (0, 3):
            n = (self._mb_nbr(addr, -1, 0) if side == 0
                 else self._mb_nbr(addr, 0, -1))
            if n is None:
                return 1 if cur_intra else 0
            cls = st.mb_class[n]
            if cls == HR.MB_IPCM:
                return 1
            if cat == 0:
                if cls != HR.MB_I16:
                    return 0
                return 1 if (st.mb_dc_flag[n] & 1) else 0
            comp = info
            return 1 if (st.mb_dc_flag[n] & (2 << comp)) else 0
        if cat in (1, 2):
            x4, y4 = info
            xN = 4 * x4 - (1 if side == 0 else 0)
            yN = 4 * y4 - (0 if side == 0 else 1)
            r = sl._nbr(addr, xN, yN, False)
            if r is None:
                return 1 if cur_intra else 0
            addrN, xW, yW = r
            if st.mb_class[addrN] == HR.MB_IPCM:
                return 1
            return int(st.cbf_y[addrN, 4 * (yW >> 2) + (xW >> 2)])
        # cat 4: chroma AC
        comp, cx, cy = info
        xN = 4 * cx - (1 if side == 0 else 0)
        yN = 4 * cy - (0 if side == 0 else 1)
        r = sl._nbr(addr, xN, yN, True)
        if r is None:
            return 1 if cur_intra else 0
        addrN, xW, yW = r
        if st.mb_class[addrN] == HR.MB_IPCM:
            return 1
        return int(st.cbf_c[addrN, comp, 2 * (yW >> 2) + (xW >> 2)])

    def residual(self, addr: int, cat: int, maxcoeff: int, info=None):
        e = self.e
        field = self.st.is_field(addr)
        if cat != 5:
            inc = (self._cbf_nbr(addr, cat, info, 0)
                   + 2 * self._cbf_nbr(addr, cat, info, 1))
            if not e.decision(85 + HC._CBF_OFF[cat] + inc):
                return None
        if cat == 5:
            sig_base = 436 if field else 402
            last_base = 451 if field else 417
            abs_base = 426
        else:
            sig_base = (277 if field else 105) + HC._SIG_OFF[cat]
            last_base = (338 if field else 166) + HC._SIG_OFF[cat]
            abs_base = 227 + HC._ABS_OFF[cat]
        sig8 = HC.SIG_COEFF_8x8_FIELD if field else HC.SIG_COEFF_8x8
        coeffs = [0] * maxcoeff
        sig = [False] * maxcoeff
        last_idx = maxcoeff - 1
        broke = False
        for i in range(maxcoeff - 1):
            if cat == 5:
                s_inc = sig8[i]
                l_inc = HC.LAST_COEFF_8x8[i]
            elif cat == 3:
                s_inc = l_inc = min(i, 2)
            else:
                s_inc = l_inc = i
            if e.decision(sig_base + s_inc):
                sig[i] = True
                if e.decision(last_base + l_inc):
                    last_idx = i
                    broke = True
                    break
        if not broke:
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
                ctxn = abs_base + 5 + min(4 - (1 if cat == 3 else 0),
                                          num_gt1)
                level = 2
                while level < 15 and e.decision(ctxn):
                    level += 1
                if level == 15:
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
