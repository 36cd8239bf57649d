"""PAFF (picture-adaptive frame/field) decoding: coded FIELD pictures
(field_pic_flag = 1) for the in-build H.264 oracle.

A coded field is decoded as an independent half-height picture whose
sample planes are numpy VIEWS into the owning frame's planes
(Y[parity::2]) — the whole progressive macroblock machinery
(h264_ref._SliceCtx / h264_cabac.CabacSlice) runs unchanged on the view,
with the field residual scans, field CABAC context blocks and field
deblocking rules selected via pic.is_field_pic.  This module adds the
picture-level semantics: field pairing into output frames, field order
counts, field reference lists derived from the frame DPB by parity
alternation (8.2.4.2.2-2.5), and field-unit reference list modification
(8.2.4.3.1).

Validation: PAFF streams are synthesized by re-heading progressive
half-height x264 encodes (tests/paff_gen.py) and libavcodec arbitrates
the field-semantics interpretation (tests/test_h264_paff.py).  CAVLC
I/P configurations validate bit-exactly; CABAC field pictures reuse the
field context machinery that the MBAFF suite pins.

The port's copy of amatsukaze_tpu/video/h264_paff.py.
"""

from __future__ import annotations

import numpy as np

from . import h264_ref as HR


class _FieldSpsShim:
    """Width/height view of an SPS for half-height field allocation."""

    def __init__(self, sps):
        self._w = sps.width
        self._h = sps.height // 2

    @property
    def width(self):
        return self._w

    @property
    def height(self):
        return self._h


def _make_field_pic(dec, frame, parity: int, sps, pps):
    fp = HR._Picture(_FieldSpsShim(sps), pps)
    # replace the allocated planes with interleaved views of the frame
    fp.Y = frame.Y[parity::2]
    fp.U = frame.U[parity::2]
    fp.V = frame.V[parity::2]
    fp.is_field_pic = True
    fp.parity = parity
    fp.frame = frame
    fp.pic_id = dec._pic_counter
    dec._pic_counter += 1
    return fp


def _wrap(frame_num: int, cur_fn: int, max_fn: int) -> int:
    return frame_num - max_fn if frame_num > cur_fn else frame_num


def _interleave_fields(frames_in_order, cur_parity: int,
                       field_of) -> list:
    """8.2.4.2.5: alternate same-parity / opposite-parity fields taken
    from the ordered frame sequence; a missing field is skipped within
    its parity sequence; a drained parity lets the other run out."""
    same = [f for f in (field_of(fr, cur_parity) for fr in frames_in_order)
            if f is not None]
    opp = [f for f in (field_of(fr, 1 - cur_parity)
                       for fr in frames_in_order) if f is not None]
    out = []
    i = j = 0
    take_same = True
    while i < len(same) or j < len(opp):
        if take_same and i < len(same):
            out.append(same[i])
            i += 1
        elif not take_same and j < len(opp):
            out.append(opp[j])
            j += 1
        elif i < len(same):
            out.append(same[i])
            i += 1
        else:
            out.append(opp[j])
            j += 1
        take_same = not take_same
    return out


def _frame_fields(frame):
    return getattr(frame, "fields", {})


def _field_of(frame, parity):
    f = _frame_fields(frame).get(parity)
    if f is not None and getattr(f, "is_ref", True):
        return f
    return None


def _candidate_frames(dec, st, short_term=True):
    """DPB frames.  A frame whose first reference field completed is
    already IN the DPB (marking runs per field, 8.2.5 — the first
    field's sliding window can evict frames before the second field
    decodes); the current field itself is excluded at lookup time."""
    del st
    return [p for p in dec.dpb if bool(p.long_term) != short_term]


def _field_of_excl(st):
    cur_fp = st["fp"]

    def fof(frame, parity):
        f = _field_of(frame, parity)
        return None if f is cur_fp else f

    return fof


def _build_field_list_p(dec, st, h, sps):
    cur_fn = h.frame_num
    max_fn = 1 << sps.log2_max_frame_num
    cur_parity = st["parity"]
    fof = _field_of_excl(st)
    frames = _candidate_frames(dec, st, short_term=True)
    frames.sort(key=lambda p: -_wrap(p.frame_num, cur_fn, max_fn))
    lst = _interleave_fields(frames, cur_parity, fof)
    longs = sorted(_candidate_frames(dec, st, short_term=False),
                   key=lambda p: p.long_term_idx)
    lst += _interleave_fields(longs, cur_parity, fof)
    lst = _modify_field_list(dec, st, lst, h.ref_list_mods[0], h, sps,
                             h.num_ref_idx[0])
    return lst


def _build_field_lists_b(dec, st, h, sps, cur_poc):
    cur_parity = st["parity"]
    shorts = _candidate_frames(dec, st, short_term=True)

    def frame_poc(p):
        fps = [f.poc for f in _frame_fields(p).values() if f is not None]
        return min(fps) if fps else p.poc

    before = sorted([p for p in shorts if frame_poc(p) <= cur_poc],
                    key=lambda p: -frame_poc(p))
    after = sorted([p for p in shorts if frame_poc(p) > cur_poc],
                   key=lambda p: frame_poc(p))
    longs = sorted(_candidate_frames(dec, st, short_term=False),
                   key=lambda p: p.long_term_idx)
    f0 = before + after + longs
    f1 = after + before + longs
    fof = _field_of_excl(st)
    l0 = _interleave_fields(f0, cur_parity, fof)
    l1 = _interleave_fields(f1, cur_parity, fof)
    if len(l1) > 1 and l0 == l1:
        l1 = [l1[1], l1[0]] + l1[2:]
    l0 = _modify_field_list(dec, st, l0, h.ref_list_mods[0], h, sps,
                            h.num_ref_idx[0])
    l1 = _modify_field_list(dec, st, l1, h.ref_list_mods[1], h, sps,
                            h.num_ref_idx[1])
    return l0, l1


def _modify_field_list(dec, st, lst, mods, h, sps, num_active):
    """8.2.4.3.1 in FIELD units: maxPicNum = 2*MaxFrameNum,
    currPicNum = 2*frame_num + 1, short-term field PicNumF =
    2*FrameNumWrap + (same parity ? 1 : 0)."""
    if not mods:
        return lst[:num_active]
    cur_fn = h.frame_num
    max_fn = 1 << sps.log2_max_frame_num
    max_pn = 2 * max_fn
    cur_pn = 2 * cur_fn + 1
    cur_parity = st["parity"]
    avail = [f for f in _all_ref_fields(dec, st) if f is not st["fp"]]
    work = list(lst[:num_active])
    pred = cur_pn
    ref_idx = 0
    for op, val in mods:
        target = None
        if op in (0, 1):
            adp = val + 1
            if op == 0:
                nw = pred - adp
                if nw < 0:
                    nw += max_pn
            else:
                nw = pred + adp
                if nw >= max_pn:
                    nw -= max_pn
            pred = nw
            pn = nw - max_pn if nw > cur_pn else nw
            for f in avail:
                if f.frame.long_term:
                    continue
                w = _wrap(f.frame.frame_num, cur_fn, max_fn)
                pnf = 2 * w + (1 if f.parity == cur_parity else 0)
                if pnf == pn:
                    target = f
                    break
        else:  # op == 2: long-term field
            for f in avail:
                if f.frame.long_term:
                    ltp = 2 * f.frame.long_term_idx + (
                        1 if f.parity == cur_parity else 0)
                    if ltp == val:
                        target = f
                        break
        if target is None:
            continue
        work.insert(ref_idx, target)
        ref_idx += 1
        i = ref_idx
        while i < len(work):
            if work[i] is target:
                del work[i]
            else:
                i += 1
    return work[:num_active]


def _all_ref_fields(dec, st):
    out = []
    for frame in _candidate_frames(dec, st, True) + _candidate_frames(
            dec, st, False):
        for par in (0, 1):
            f = _field_of(frame, par)
            if f is not None:
                out.append(f)
    return out


# ---------------------------------------------------------------------------
# Decoder hooks
# ---------------------------------------------------------------------------

def decode_field_slice(dec, rbsp: bytes, h, sps, pps) -> None:
    st = getattr(dec, "_paff_st", None)
    new_pic = (st is None or h.first_mb == 0
               or h.frame_num != st["hdr"].frame_num
               or h.bottom_field_flag != st["hdr"].bottom_field_flag
               or h.pps_id != st["hdr"].pps_id)
    if new_pic:
        _finish_field(dec)
        st = _start_field(dec, h, sps, pps)
    st["hdr"] = h
    st["slices"] += 1
    fp = st["fp"]
    ctx = HR._SliceCtx(fp, h, sps, pps, st["slices"])
    if h.slice_type == HR.SLICE_P:
        ctx.ref_l0 = _build_field_list_p(dec, st, h, sps)
    elif h.slice_type == HR.SLICE_B:
        ctx.ref_l0, ctx.ref_l1 = _build_field_lists_b(dec, st, h, sps,
                                                      fp.poc)
    HR.run_slice_data(ctx, rbsp, h, fp, pps)


def _start_field(dec, h, sps, pps):
    parity = h.bottom_field_flag
    pend = getattr(dec, "_paff_pending", None)
    # an IDR first field normally pairs with a NON-IDR second field
    # (which references it); two consecutive IDR fields pair only when
    # they share idr_pic_id (7.4.3)
    pairable = (pend is not None
                and h.frame_num == pend["fn"]
                and parity != pend["first_parity"]
                and (not (h.idr and pend["idr"])
                     or h.idr_pic_id == pend["idr_pic_id"]))
    if pend is not None and not pairable:
        _finalize_frame(dec)
        pend = None
    if pairable:
        frame = pend["frame"]
        second = True
        first_parity = pend["first_parity"]
    else:
        frame = HR._Picture(sps, pps)
        frame.fields = {}
        frame.frame_num = h.frame_num
        frame.is_idr = h.idr
        frame.pic_id = dec._pic_counter
        dec._pic_counter += 1
        if h.idr:
            dec._epoch += 1
        frame._epoch = dec._epoch
        frame._mmco = h.mmco
        frame._long_term_ref_flag = h.long_term_reference_flag
        second = False
        first_parity = parity
    fp = _make_field_pic(dec, frame, parity, sps, pps)
    fp.poc = dec._compute_poc(h, sps)
    fp.is_ref = h.nal_ref_idc != 0
    fp.frame_num = h.frame_num
    frame.fields[parity] = fp
    if fp.is_ref:
        frame.is_ref = True
    # frame order counts
    tp = frame.field_poc
    if parity == 0:
        frame.field_poc = (fp.poc, tp[1])
    else:
        frame.field_poc = (tp[0], fp.poc)
    pocs = [f.poc for f in frame.fields.values()]
    frame.poc = min(pocs)
    st = {"fp": fp, "frame": frame, "parity": parity, "hdr": h,
          "slices": 0, "second": second, "first_parity": first_parity,
          "sps": sps}
    dec._paff_st = st
    if not second:
        dec._paff_pending = {"frame": frame, "fn": h.frame_num,
                             "first_parity": parity, "idr": h.idr,
                             "idr_pic_id": h.idr_pic_id, "sps": sps}
    return st


def _finish_field(dec) -> None:
    """Deblock the just-decoded field; run reference marking when the
    frame first becomes a reference (8.2.5 applies per field — the
    first reference field enters the DPB and can evict via the sliding
    window before the second field decodes); output at pair
    completion."""
    st = getattr(dec, "_paff_st", None)
    if st is None:
        return
    dec._paff_st = None
    fp = st["fp"]
    dec._deblock_picture(fp)
    frame = st["frame"]
    if fp.is_ref and frame not in dec.dpb:
        dec._mark_references(frame)
    if st["second"]:
        _finalize_frame(dec)


def _finalize_frame(dec) -> None:
    pend = getattr(dec, "_paff_pending", None)
    if pend is None:
        return
    dec._paff_pending = None
    frame = pend["frame"]
    dec._out.append(frame)


def finalize_pending(dec) -> None:
    """Flush hook: complete any in-progress field / half-decoded frame."""
    _finish_field(dec)
    _finalize_frame(dec)
