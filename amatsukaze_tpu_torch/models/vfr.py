"""VFR machinery: timecodes, bitrate zones.

Parity targets (Amatsukaze/FilteredSource.hpp):
- base-VFR-timing-fps inference 60/120/240 (:192-212)
- MakeVFRBitrateZones: greedy heap merge of per-8-frame bitrate units to
  <= (30 zones/hour, hard 1000) within a 5%-style cost budget (:680-829);
  the reference's own unit test (AmatsukazeTestImpl.hpp:632-665) is
  replicated in tests/test_vfr.py with identical expected zones.
- AdjustVFRBitrate (:833-839)

The port's copy of amatsukaze_tpu/models/vfr.py, cut to what the filter
stage and the transcode pipeline use: the decimation map and the timecode
file reader wait for the slice that needs them. EncoderZone is
cm_analyze's, as in the JAX package.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

from .cm_analyze import EncoderZone  # noqa: F401  (models.vfr.EncoderZone)


@dataclass
class BitrateZone:
    start_frame: int = 0
    end_frame: int = 0
    bitrate: float = 0.0


# ---------------------------------------------------------------------------
# timecodes
# ---------------------------------------------------------------------------

def infer_vfr_timing_fps(timecodes: list[float], default: int = 60) -> int:
    """Pick the base fps in {60, 120, 240} minimising quantisation error
    (ref readTimecode :192-212)."""
    if not timecodes:
        return default
    best_fps = default
    min_diff = timecodes[-1]
    epsilon = len(timecodes) * 10e-10
    for fps in (60, 120, 240):
        mult = fps / 1001.0
        inv = 1.0 / mult
        diff = sum(abs(inv * round(ts * mult) - ts) for ts in timecodes)
        if diff < min_diff - epsilon:
            best_fps = fps
            min_diff = diff
    return best_fps


def make_timecodes_from_durations(durations: list[int], fps_num: int,
                                  fps_denom: int) -> list[float]:
    """Output-frame start times in ms for a duration list over a base clock."""
    tick = 1000.0 * fps_denom / fps_num
    out = [0.0]
    for d in durations:
        out.append(out[-1] + d * tick)
    return out


# ---------------------------------------------------------------------------
# bitrate zones
# ---------------------------------------------------------------------------

UNIT_FRAMES = 8
HARD_ZONE_LIMIT = 1000
TARGET_ZONES_PER_HOUR = 30


def make_vfr_bitrate_zones(
    time_codes: list[float],
    cmzones: list[EncoderZone],
    bitrate_cm: float,
    fps_num: int,
    fps_denom: int,
    time_factor: float,
    cost_limit: float,
) -> list[BitrateZone]:
    """Exact port of MakeVFRBitrateZones (ref FilteredSource.hpp:680-829)."""
    if not time_codes:
        return []
    num_frames = len(time_codes) - 1

    def nblocks(n, unit):
        return (n + unit - 1) // unit

    # per-8-frame average bitrate units
    nunits = nblocks(num_frames, UNIT_FRAMES)
    units = [0.0] * nunits
    for i in range(nunits):
        start = i * UNIT_FRAMES
        end = min((i + 1) * UNIT_FRAMES, len(time_codes) - 1)
        total = (time_codes[end] - time_codes[start]) / 1000.0 * fps_num / fps_denom
        invfps = total / (end - start)
        units[i] = (invfps - 1.0) * time_factor + 1.0

    # apply CM zones, rounded inward to unit boundaries
    for z in cmzones:
        start = nblocks(z.start_frame, UNIT_FRAMES)
        end = z.end_frame // UNIT_FRAMES
        for k in range(start, end):
            units[k] *= bitrate_cm

    # merge equal-bitrate runs into blocks: [index, next, avg, cost]
    blocks: list[list] = []
    cur = units[0]
    blocks.append([0, 1, cur, 0.0])
    for i in range(1, nunits):
        if units[i] != cur:
            cur = units[i]
            blocks.append([i, len(blocks) + 1, cur, 0.0])
    blocks.append([nunits, -1, 0.0, 0.0])  # sentinel

    def sum_diff(start, end, avg):
        return sum(abs(units[i] - avg) for i in range(start, end))

    def calc_cost(cur_b, next_b):
        start = cur_b[0]
        mid = next_b[0]
        end = blocks[next_b[1]][0]
        cur_cost = sum_diff(start, mid, cur_b[2])
        next_cost = sum_diff(mid, end, next_b[2])
        avg2 = (cur_b[2] * (mid - start) + next_b[2] * (end - mid)) / (end - start)
        cost2 = sum_diff(start, end, avg2)
        cur_b[3] = cost2 - (cur_cost + next_cost)

    i = 0
    while blocks[i][0] < nunits:
        cur_b = blocks[i]
        next_b = blocks[cur_b[1]]
        if next_b[0] < nunits:
            calc_cost(cur_b, next_b)
        i = cur_b[1]

    total_hours = time_codes[-1] / 1000.0 / 3600.0
    target_zones = max(1, int(TARGET_ZONES_PER_HOUR * total_hours))
    total_cost_limit = nunits * cost_limit

    # min-heap on (cost, block index). Like the reference's std::heap of
    # indices, entries may carry stale priorities; a popped entry merges
    # using the block's CURRENT cost field (the reference adds cur.cost,
    # not the popped key), and dead blocks (next == -1) are skipped.
    heap = [(blocks[i][3], i) for i in range(len(blocks) - 2)]
    heapq.heapify(heap)
    num_zones = len(blocks) - 2
    total_cost = 0.0
    while heap and (
        (total_cost < total_cost_limit and num_zones > target_zones)
        or num_zones > HARD_ZONE_LIMIT
    ):
        cost, idx = heapq.heappop(heap)
        cur_b = blocks[idx]
        if cur_b[1] == -1:
            continue  # already merged away
        next_b = blocks[cur_b[1]]
        start, mid = cur_b[0], next_b[0]
        end = blocks[next_b[1]][0]
        total_cost += cur_b[3]
        cur_b[2] = (cur_b[2] * (mid - start) + next_b[2] * (end - mid)) / (end - start)
        cur_b[1] = next_b[1]
        next_b[1] = -1
        num_zones -= 1
        nextnext = blocks[cur_b[1]]
        if nextnext[0] < nunits:
            calc_cost(cur_b, nextnext)
            heapq.heappush(heap, (cur_b[3], idx))

    zones = []
    i = 0
    while blocks[i][0] < nunits:
        cur_b = blocks[i]
        zones.append(
            BitrateZone(
                start_frame=cur_b[0] * UNIT_FRAMES,
                end_frame=min(num_frames, blocks[cur_b[1]][0] * UNIT_FRAMES),
                bitrate=cur_b[2],
            )
        )
        i = cur_b[1]
    return zones


def adjust_vfr_bitrate(time_codes: list[float], fps_num: int, fps_denom: int) -> float:
    """Average-frame-rate bitrate correction for non-VFR-aware encoders
    (ref AdjustVFRBitrate :833-839)."""
    if not time_codes:
        return 1.0
    return (time_codes[-1] / 1000.0) / (len(time_codes) - 1) * fps_num / fps_denom
