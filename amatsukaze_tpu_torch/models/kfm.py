"""KFM-class telecine detection and VFR plan (host decision layer).

The reference's KFM plugin (external; driven by the generated script at
Server/Misc.cs:1300-1324 as `KFMDeint(mode=4, pass=1..3, ...)`) does
per-cycle 5-frame telecine cost matching with a 60p fallback switch
(`thswitch`) and emits duration/timecode files consumed by AMTDecimate and
the VFR bitrate machinery (FilteredSource.hpp:265-269, 637-676, 680-839).

This module is the decision half: it consumes the batched per-cycle pattern
costs from ops.deint.telecine_pattern_costs_host and produces, per 5-frame cycle,
a mode (24p phase / 30p / 60p) plus the frame-duration list and timecodes.
Multi-pass structure mirrors the reference: pass 1 = metrics (device),
pass 2 = pattern decision (this module), pass 3 = frame synthesis
(ops.deint weave/bob/yadif under the chosen pattern). The port's copy of
amatsukaze_tpu/models/kfm.py: host logic, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from .vfr import make_timecodes_from_durations


class CycleMode(IntEnum):
    FILM = 0  # 3:2 pulldown -> 4 film frames per cycle (24p)
    VIDEO_30 = 1  # weave as-is (30p)
    VIDEO_60 = 2  # bob to 60p


@dataclass
class CycleDecision:
    mode: CycleMode
    phase: int = -1  # pulldown phase for FILM


# which frames of a 5-frame TFF 3:2 cycle merge with the previous frame's
# opposite field for each phase (must match ops.deint._PULLDOWN_MERGE_NP)
_PULLDOWN_MERGE = np.array(
    [
        [0, 0, 1, 1, 0],
        [0, 0, 0, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 0, 0, 0],
        [0, 1, 1, 0, 0],
    ],
    np.int32,
)

# output durations (in 1/120s units at a 120/1001 clock) per cycle:
# FILM: 4 frames x 5/120s -> duration 5 each on a 24-frame grid? We express
# durations in units of the 60p half-frame clock (1/59.94s):
#   FILM cycle: 4 frames, total 10 units  -> durations pattern [2,3,2,3]*?
#   Actually 4 film frames over 5 video frames = 10 fields: 2.5 units each;
#   on the x2 (120Hz) clock: 5 units per film frame.
#   VIDEO_30: 5 frames x 2 units. VIDEO_60: 10 frames x 1 unit.


class KFMDecider:
    """Per-cycle mode decision with hysteresis (thswitch analog)."""

    def __init__(self, th_switch: float = 3.0, th_film: float = 0.6,
                 hysteresis: int = 2, allow_60: bool = True,
                 th_comb: float = 60.0):
        # th_film: film pattern must beat 30p by this ratio to choose FILM
        # th_switch: relative 60p fallback (30p cost vs best pairing)
        # th_comb: absolute per-frame combing floor — when even the BEST
        # field pairing combs above this, the content is true interlaced
        # video and only bobbing helps (KFM's thswitch semantics: the
        # relative rule alone can't flag content where every pairing is
        # equally bad)
        # allow_60=False reproduces the reference's VFR30 fps mode
        # (thswitch=-1 in the KFMDeint chain, Server/Misc.cs:1320: never
        # fall back to 60p bob; output is 24/30 only)
        # force_film reproduces the CFR24 fps mode (KFMDeint mode=2,
        # Server/Misc.cs:1315: decimate everything to 24p)
        self.th_switch = th_switch
        self.th_film = th_film
        self.hysteresis = hysteresis
        self.allow_60 = allow_60
        self.th_comb = th_comb
        self.force_film = False

    def decide(self, pattern_costs: np.ndarray) -> list[CycleDecision]:
        """pattern_costs: [ncycles, 7] from ops.deint.telecine_pattern_costs_host
        (5 phase costs, 30p cost, 60p min-cost)."""
        pc = np.asarray(pattern_costs)
        n = len(pc)
        decisions: list[CycleDecision] = []
        phases = pc[:, :5].argmin(axis=1)
        if self.force_film:
            # CFR24: every cycle decimates with its best phase; the
            # per-run phase smoothing below still applies
            decisions = [CycleDecision(CycleMode.FILM, int(p))
                         for p in phases]
            self._smooth_phase_run(decisions, 0, n)
            return decisions
        for i in range(n):
            best_phase = int(phases[i])
            film_cost = pc[i, best_phase]
            cost_30 = pc[i, 5]
            cost_60 = pc[i, 6]
            if film_cost < cost_30 * self.th_film:
                decisions.append(CycleDecision(CycleMode.FILM, best_phase))
            elif (self.allow_60 and cost_60 / 5.0 > self.th_comb):
                # even the best pairing combs: true interlaced video
                decisions.append(CycleDecision(CycleMode.VIDEO_60))
            elif not self.allow_60 or cost_30 <= cost_60 * self.th_switch:
                decisions.append(CycleDecision(CycleMode.VIDEO_30))
            else:
                decisions.append(CycleDecision(CycleMode.VIDEO_60))

        # hysteresis: isolated mode flips shorter than `hysteresis` cycles
        # are absorbed into their neighbours (KFM's switching stability)
        if n > 2:
            for i in range(1, n - 1):
                if (
                    decisions[i].mode != decisions[i - 1].mode
                    and decisions[i - 1].mode == decisions[i + 1].mode
                ):
                    decisions[i] = CycleDecision(
                        decisions[i - 1].mode, decisions[i - 1].phase
                    )
        # phase smoothing within FILM runs: run-length tracking that
        # allows genuine mid-file phase changes (broadcast edits shift
        # the pulldown phase at cut points). A new phase must persist
        # for >= `hysteresis` cycles to take over; shorter blips are
        # absorbed into the committed phase. (Round 1 took one global
        # majority vote, which mis-wove every section after a phase
        # flip.)
        i = 0
        while i < n:
            if decisions[i].mode != CycleMode.FILM:
                i += 1
                continue
            j = i
            while j < n and decisions[j].mode == CycleMode.FILM:
                j += 1
            self._smooth_phase_run(decisions, i, j)
            i = j
        return decisions

    def _smooth_phase_run(self, decisions: list[CycleDecision],
                          begin: int, end: int) -> None:
        """Commit-and-switch phase tracking over one contiguous FILM run
        [begin, end)."""
        if end - begin <= 1:
            return
        committed = decisions[begin].phase
        i = begin
        while i < end:
            p = decisions[i].phase
            if p == committed:
                i += 1
                continue
            # candidate switch: count how long the new phase persists
            j = i
            while j < end and decisions[j].phase == p:
                j += 1
            if j - i >= self.hysteresis:
                committed = p  # real phase change (edit point)
                i = j
            else:
                for k in range(i, j):  # measurement blip: absorb
                    decisions[k] = CycleDecision(CycleMode.FILM, committed)
                i = j


@dataclass
class VFRPlan:
    """Output plan: which source (half-)frames to emit with what durations."""

    durations: list[int]  # per output frame, in 120/1001-clock units
    source_frames: list[tuple[int, int]]  # (cycle_frame_index, field_op)
    timecodes_ms: list[float]

    # field_op values
    WEAVE = 0  # output the frame as-is
    MERGE_PREV = 1  # weave current top with previous bottom (pulldown repair)
    BOB_T = 2  # bob top field
    BOB_B = 3  # bob bottom field


def build_vfr_plan(decisions: list[CycleDecision], num_frames: int,
                   fps_num: int = 120000, fps_denom: int = 1001,
                   frame_costs=None, ucf_thresh: float = 5.0) -> VFRPlan:
    """Expand cycle decisions into output frames + durations on the 120Hz
    clock: FILM frame = 5 units, 30p frame = 4, 60p half-frame = 2.

    frame_costs ([N, 3] from ops.deint.field_match_costs) enables the UCF
    analog (KFM's dirty-field replacement): a FILM output frame whose chosen
    weave still combs far above the sequence median gets bobbed instead of
    woven — same duration, cleaner field pair (broadcast edits that break
    the pulldown phase mid-cycle)."""
    durations: list[int] = []
    source: list[tuple[int, int]] = []
    ucf_base = None
    if frame_costs is not None and len(frame_costs):
        costs = np.asarray(frame_costs)
        ucf_base = float(np.median(costs[:, 0])) + 1e-6

    def film_op(f: int, merged: bool) -> int:
        op = VFRPlan.MERGE_PREV if merged else VFRPlan.WEAVE
        if ucf_base is not None and f < len(frame_costs):
            cost = float(frame_costs[f][1 if merged else 0])
            if cost > ucf_thresh * ucf_base:
                return VFRPlan.BOB_T  # dirty field: replace, keep duration
        return op
    for ci, d in enumerate(decisions):
        base = ci * 5
        remaining = min(5, num_frames - base)
        if remaining <= 0:
            break
        if d.mode == CycleMode.FILM and remaining == 5:
            # 5 coded frames (10 fields) -> 4 film frames of 5 units
            # each. The pulldown splits one film frame X across two
            # consecutive mixed video frames: the cyclic-FIRST of the
            # flagged pair has X only in its bottom field (its
            # MERGE_PREV repair reproduces the PREVIOUS film frame — a
            # pure duplicate, dropped: the 2 in 3:2), while the
            # cyclic-second has X on top and its MERGE_PREV repair
            # recovers X itself.
            merge = _PULLDOWN_MERGE[d.phase]
            flagged = [f for f in range(5) if merge[f]]
            skip = -1
            if len(flagged) >= 2:
                skip = next(f for f in flagged if not merge[(f - 1) % 5])
            for f in range(5):
                if f == skip:
                    continue
                source.append((base + f, film_op(base + f, bool(merge[f]))))
                durations.append(5)
        elif d.mode == CycleMode.VIDEO_60:
            for f in range(remaining):
                source.append((base + f, VFRPlan.BOB_T))
                durations.append(2)
                source.append((base + f, VFRPlan.BOB_B))
                durations.append(2)
        else:  # VIDEO_30 (or partial tail cycle)
            for f in range(remaining):
                source.append((base + f, VFRPlan.WEAVE))
                durations.append(4)
    timecodes = make_timecodes_from_durations(durations, fps_num, fps_denom)
    return VFRPlan(durations=durations, source_frames=source, timecodes_ms=timecodes)


def plan_is_cfr(decisions: list[CycleDecision]) -> bool:
    modes = {d.mode for d in decisions}
    return len(modes) <= 1
