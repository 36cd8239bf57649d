"""Per-output-file filter graph: KFM analysis + device output synthesis.

Counterpart of amatsukaze_tpu/models/filter_graph.py (parity:
AMTFilterSource, Amatsukaze/FilteredSource.hpp:136-635):

  pass 1 (analysis): field-match costs of every frame on the device
          (the yadif_fieldmatch kernel, costs only)        [KFM pass 1]
  pass 2 (decision): pattern costs -> KFMDecider -> VFR plan, on the host
          (models.kfm)                                     [KFM pass 2]
  pass 3 (output):   per-batch synthesis on the device: weave / pulldown
          repair / bob and a gather for the KFM modes, the yadif_fieldmatch
          kernel (frames only) for yadif                  [KFM pass 3]

Ported modes: none, yadif, kfm_vfr, kfm_vfr30, kfm_cfr24. The output is
uint8, rounded on the device (the encoder feed rounds to uint8 anyway).
The other modes of the JAX package (yadif60, qtgmc, svp, autovfr), the
post chain, resize and the multi-chip mesh are not ported yet.
"""

from __future__ import annotations

import bisect
import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import deint as deint_ops
from ..ops import fused_filter
from ..types import VideoFormat
from ..utils.device import resolve_device
from .kfm import CycleMode, KFMDecider, VFRPlan, build_vfr_plan, plan_is_cfr
from .vfr import EncoderZone, infer_vfr_timing_fps


class DeferredBatch:
    """A filter-output batch still resident on the device: the caller can
    enqueue the next batch's work before fetching this one."""

    def __init__(self, dev: torch.Tensor, n_valid: int):
        self.dev = dev
        self.n = n_valid

    def __len__(self) -> int:
        return self.n

    def materialize(self) -> np.ndarray:
        return self.dev[: self.n].cpu().numpy()


@dataclass
class FilterOutput:
    out_format: VideoFormat = None
    num_out_frames: int = 0
    time_codes: list = field(default_factory=list)  # ms, empty = CFR
    vfr_timing_fps: int = 60
    durations: list = field(default_factory=list)
    out_zones: list = field(default_factory=list)


class FilterGraph:
    """Deinterlace mode selection mirroring the reference's GUI matrix
    (EncodeServerData.cs:106-119; Server/Misc.cs:1290-1389):

    - none / yadif (CFR30)
    - kfm_vfr: KFM VFR with 60p fallback (mode=4, thswitch=3)
    - kfm_vfr30: KFM VFR without the 60p fallback (thswitch=-1)
    - kfm_cfr24: decimate everything to 24p (KFMDeint mode=2)
    """

    MODE_NONE = "none"
    MODE_YADIF = "yadif"
    MODE_KFM_VFR = "kfm_vfr"
    MODE_KFM_VFR30 = "kfm_vfr30"
    MODE_KFM_CFR24 = "kfm_cfr24"

    KFM_FAMILY = frozenset({MODE_KFM_VFR, MODE_KFM_VFR30, MODE_KFM_CFR24})
    ALL_MODES = (MODE_NONE, MODE_YADIF, MODE_KFM_VFR, MODE_KFM_VFR30,
                 MODE_KFM_CFR24)
    # modes of the JAX package this port does not carry yet
    NOT_PORTED = ("yadif60", "qtgmc", "svp", "autovfr")

    def __init__(self, ctx, mode: str = "none", batch: int = 32,
                 device=None):
        if mode in self.NOT_PORTED:
            raise NotImplementedError(
                f"filter mode {mode!r} is not ported to PyTorch yet")
        if mode not in self.ALL_MODES:
            raise ValueError(f"unknown filter mode {mode!r}")
        self.ctx = ctx
        self.mode = mode
        self.batch = batch
        self.device = resolve_device(device)
        # KFM's dirty-field (UCF) replacement (ref KfmEnableUcf): a FILM
        # frame whose chosen weave still combs gets bobbed instead
        self.kfm_ucf = True
        self.decisions = None
        self.frame_costs = None
        self.vfr_plan: VFRPlan | None = None

    def _make_decider(self) -> KFMDecider:
        decider = KFMDecider()
        if self.mode == self.MODE_KFM_VFR30:
            decider.allow_60 = False  # thswitch=-1 (Misc.cs:1320)
        if self.mode == self.MODE_KFM_CFR24:
            decider.force_film = True  # KFMDeint mode=2 (Misc.cs:1315)
        return decider

    def _finish_analysis(self, all_costs, num_frames: int) -> None:
        all_costs = np.asarray(all_costs)
        if len(all_costs) < 5:
            self.mode = self.MODE_NONE
            return
        # pad the trailing partial cycle with its last row so every source
        # frame gets a cycle decision (dropping the tail would desync audio)
        pad = (-len(all_costs)) % 5
        if pad:
            all_costs = np.concatenate(
                [all_costs, np.repeat(all_costs[-1:], pad, axis=0)])
        pattern = deint_ops.telecine_pattern_costs_host(all_costs)
        self.frame_costs = all_costs
        self.decisions = self._make_decider().decide(pattern)
        plan_frames = num_frames
        if self.mode == self.MODE_KFM_CFR24:
            # strict CFR output: the trailing partial cycle (<=4 frames)
            # is dropped rather than emitted at a different rate
            plan_frames = num_frames - (num_frames % 5)
        self.vfr_plan = build_vfr_plan(
            self.decisions, plan_frames,
            frame_costs=all_costs if self.kfm_ucf else None)

    # -- pass 1 + 2: analysis over the full sequence ---------------------------
    def analyze(self, frame_iter, num_frames: int) -> None:
        """Stream the sequence once, collecting the field-match costs of
        every frame on the device (fetched once, at the end), then decide.
        Used by every KFM-family mode."""
        if self.mode not in self.KFM_FAMILY:
            return
        costs = []
        carry = None  # last frame of the previous batch for cross-batch match
        for chunk in _batched(frame_iter, self.batch):
            arr = torch.from_numpy(normalize_u8(np.stack(chunk))).to(
                self.device)
            arr_in = arr if carry is None else torch.cat([carry[None], arr])
            _, c = fused_filter.yadif_fieldmatch(
                arr_in, write_frames=False, with_costs=True)
            costs.append(c if carry is None else c[1:])
            carry = arr[-1]
        if not costs:
            return
        merged = torch.cat(costs).cpu().numpy()
        self._finish_analysis(merged[:num_frames], num_frames)

    # -- pass 3: output synthesis --------------------------------------------
    def output_spec(self, num_src_frames: int,
                    in_fmt: VideoFormat) -> FilterOutput:
        out = FilterOutput(out_format=copy.deepcopy(in_fmt))
        if self.mode in self.KFM_FAMILY and self.vfr_plan is not None:
            plan = self.vfr_plan
            out.durations = plan.durations
            out.num_out_frames = len(plan.durations)
            if plan_is_cfr(self.decisions) and len(set(plan.durations)) <= 1:
                # pure 24p/30p/60p: emit CFR with the adjusted rate
                mode = (self.decisions[0].mode if self.decisions
                        else CycleMode.VIDEO_30)
                mul = {CycleMode.FILM: (4, 5), CycleMode.VIDEO_30: (1, 1),
                       CycleMode.VIDEO_60: (2, 1)}[mode]
                out.out_format.mul_div_fps(mul[0], mul[1])
            else:
                out.time_codes = plan.timecodes_ms
                out.vfr_timing_fps = infer_vfr_timing_fps(plan.timecodes_ms)
                out.out_format.mul_div_fps(2, 1)  # 120/1001-based timebase
            out.out_format.progressive = True
        elif self.mode == self.MODE_YADIF:
            out.num_out_frames = num_src_frames
            out.out_format.progressive = True
        else:
            out.num_out_frames = num_src_frames
        return out

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        # frames cross to the device at source dtype (uint8) and widen there
        return torch.from_numpy(
            np.ascontiguousarray(normalize_u8(frames))).to(self.device)

    def run_kfm_batch(self, frames: np.ndarray, prev_frame,
                      start_index: int) -> DeferredBatch:
        """Synthesize the VFR output frames whose source index falls in
        [start_index, start_index + len(frames)) (the KFM pass-3 analog).

        frames: [B, H, W] source frames (one plane); prev_frame: the source
        frame before `start_index` (None at the sequence head), needed for
        MERGE_PREV pulldown repair."""
        if self.vfr_plan is None:
            raise RuntimeError("run_kfm_batch before analyze()")
        end_index = start_index + len(frames)
        entries = [(src, op) for src, op in self.vfr_plan.source_frames
                   if start_index <= src < end_index]
        arr = self._upload(frames)
        if not entries:
            return DeferredBatch(arr[:0], 0)
        cur = arr.float()
        first = cur[:1] if prev_frame is None \
            else self._upload(prev_frame[None]).float()
        prev = torch.cat([first, cur[:-1]])
        ops_used = {op for _, op in entries}
        variants = {VFRPlan.WEAVE: cur}
        if VFRPlan.MERGE_PREV in ops_used:
            variants[VFRPlan.MERGE_PREV] = merge_prev_weave(cur, prev)
        if VFRPlan.BOB_T in ops_used:
            variants[VFRPlan.BOB_T] = bob_field(cur, top=True)
        if VFRPlan.BOB_B in ops_used:
            variants[VFRPlan.BOB_B] = bob_field(cur, top=False)
        src_idx = torch.tensor([src - start_index for src, _ in entries],
                               device=self.device)
        op_arr = np.asarray([op for _, op in entries])
        out = variants[VFRPlan.WEAVE][src_idx]
        for op in ops_used - {VFRPlan.WEAVE}:
            m = torch.from_numpy(op_arr == op).to(self.device)[:, None, None]
            out = torch.where(m, variants[op][src_idx], out)
        q = torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
        return DeferredBatch(q, len(entries))

    def run_pass3(self, frames: np.ndarray, prev_frame,
                  next_frame) -> DeferredBatch:
        """Filter one batch [B, H, W] -> its output frames (modes none and
        yadif, one output per source frame). prev/next_frame provide the
        temporal halo (None at the sequence ends)."""
        arr = self._upload(frames)
        if self.mode != self.MODE_YADIF:
            return DeferredBatch(arr, len(arr))
        # extend the batch with the halo frames so the edge frames see
        # their true temporal neighbours; the kernel's own batch-edge rule
        # (prev of frame 0 / next of the last frame is itself) reproduces
        # the sequence-edge replication
        first = arr[:1] if prev_frame is None else self._upload(prev_frame[None])
        last = arr[-1:] if next_frame is None else self._upload(next_frame[None])
        ext = torch.cat([first, arr, last])
        out, _ = fused_filter.yadif_fieldmatch(ext, write_frames=True)
        return DeferredBatch(out[1:-1], len(arr))


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    """Analysis-feed intake: the device cost/logo kernels run 8-bit math.
    Floats round; 10-bit (uint16) decoder output downshifts with rounding."""
    if arr.dtype == np.uint8:
        return arr
    if arr.dtype == np.uint16:
        return (((arr.astype(np.int32) + 2) >> 2)
                .clip(0, 255).astype(np.uint8))
    if np.issubdtype(arr.dtype, np.floating):
        return np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    return arr.astype(np.uint8)


def merge_prev_weave(frames: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Weave each frame's top field with the PREVIOUS frame's bottom field
    (3:2 pulldown repair for the split telecined frame)."""
    return deint_ops.weave(deint_ops.field_split(frames)[0],
                           deint_ops.field_split(prev)[1])


def bob_field(frames: torch.Tensor, top: bool) -> torch.Tensor:
    """Line-double one field to full height: kept lines pass through, the
    missing lines are the average of the adjacent kept lines (edge
    replicated)."""
    fld = deint_ops.field_split(frames)[0 if top else 1]
    if top:
        # missing (odd) line k sits between kept k and k+1
        nxt = torch.cat([fld[:, 1:], fld[:, -1:]], dim=1)
        return deint_ops.weave(fld, (fld + nxt) * 0.5)
    # missing (even) line k sits between kept k-1 and k
    prv = torch.cat([fld[:, :1], fld[:, :-1]], dim=1)
    return deint_ops.weave((prv + fld) * 0.5, fld)


def _batched(it, n):
    chunk = []
    for x in it:
        chunk.append(x)
        if len(chunk) >= n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


# ---------------------------------------------------------------------------
# zone/format conversion (MakeZones / MakeOutFormat)
# ---------------------------------------------------------------------------

def make_out_zones(
    zones: list[EncoderZone],
    out_frames: list[int],
    num_out_frames: int,
    time_codes: list[float],
    in_fps_num: int,
    in_fps_den: int,
) -> list[EncoderZone]:
    """Convert CM zones (filter-input frame numbers) to encoder zones in the
    output clip (ref MakeZones :546-616): map through the per-file frame
    list, drop zones <= 30 frames, then remap through VFR timecodes or scale
    by the frame-count ratio."""
    out: list[EncoderZone] = []
    n_src = len(out_frames)
    for z in zones:
        s = bisect.bisect_left(out_frames, z.start_frame)
        e = bisect.bisect_left(out_frames, z.end_frame)
        if e - s > 30:
            out.append(EncoderZone(s, e))
    if time_codes:
        tick = in_fps_den / in_fps_num
        for z in out:
            z.start_frame = bisect.bisect_left(time_codes,
                                               z.start_frame * tick * 1000)
            z.end_frame = bisect.bisect_left(time_codes,
                                             z.end_frame * tick * 1000)
    elif n_src != num_out_frames and n_src > 0:
        scale = num_out_frames / n_src
        for z in out:
            z.start_frame = max(0, min(num_out_frames,
                                       round(z.start_frame * scale)))
            z.end_frame = max(0, min(num_out_frames,
                                     round(z.end_frame * scale)))
    return out


def make_out_format(in_fmt: VideoFormat, out_width: int, out_height: int,
                    out_fps_num: int, out_fps_den: int,
                    progressive: bool) -> VideoFormat:
    """Encoder-input format from the filtered clip (ref MakeOutFormat
    :618-634): resized output resets SAR to 1:1."""
    out = copy.deepcopy(in_fmt)
    if out.width != out_width or out.height != out_height:
        out.width = out_width
        out.height = out_height
        out.sar_width = out.sar_height = 1
    out.frame_rate_num = out_fps_num
    out.frame_rate_denom = out_fps_den
    out.progressive = progressive
    return out
