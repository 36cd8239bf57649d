"""CM (commercial) analysis: scene/silence detection, CM decision, zones.

The port's copy of amatsukaze_tpu/models/cm_analyze.py, which holds no JAX: the
port keeps its own so that it imports nothing of the JAX package.

Parity targets (Amatsukaze/CMAnalyze.hpp):
- orchestration per intermediate video file (ctor :22-84): logo matching ->
  scene-change/silence -> CM decision -> trims/scene-changes/divs -> cmzones
- logo threshold 3% for short (<=7 min) / 10% otherwise, loose option
  (:301-309)
- Trim() parsing (:377-389), div normalisation (:391-409), `SCPos:` scene
  list (:411-439), makeCMZones from the trim list (:441-459)
- applyPmtCut: PMT-change points matched to the nearest scene change within
  +-60 frames, limited by head/tail rate budgets, then re-trimming (:107-195)
- external Trim AVS input (inputTrimAVS :197-212)

The reference delegates the actual CM decision to the external
chapter_exe/join_logo_scp tools with user-provided command files; here the
same pipeline runs in-process: device kernels (ops.cm) produce the
scene/silence metrics and a deterministic rule engine (JlsDecider) makes the
cut decision, while keeping the reference's file contracts (trim AVS, scpos
output, div file) so external tooling still interoperates.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..utils.context import FormatError


@dataclass
class EncoderZone:
    start_frame: int
    end_frame: int


# ---------------------------------------------------------------------------
# file-contract helpers (identical formats to the reference tool chain)
# ---------------------------------------------------------------------------

def parse_trim_avs(line: str, num_frames: int) -> list[int]:
    """Extract Trim(a,b) pairs -> flat [a0, b0+1, a1, b1+1, ...]
    (ref readTrimAVS :377-389: end is inclusive in AVS, exclusive here)."""
    out = []
    for m in re.finditer(r"trim\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)", line.lower()):
        out.append(int(m.group(1)))
        out.append(int(m.group(2)) + 1)
    return out


def format_trim_avs(trims: list[int]) -> str:
    parts = [
        f"Trim({trims[i]},{trims[i + 1] - 1})" for i in range(0, len(trims), 2)
    ]
    return "++".join(parts) if parts else ""


def normalize_divs(divs: list[int], num_frames: int) -> list[int]:
    """Div list normalisation (ref readDiv :391-409)."""
    out = list(divs)
    if not out:
        out = [0]
    if out[0] != 0:
        out.insert(0, 0)
    out.append(num_frames)
    return out


def parse_scene_changes_text(text: str) -> list[int]:
    """Parse chapter_exe-style output: `SCPos: n` lines after a ---- header
    (ref readSceneChanges :411-439)."""
    lines = text.splitlines()
    i = 0
    for i, line in enumerate(lines):
        if line.startswith("----"):
            break
    else:
        raise FormatError("cannot read scene-change output")
    out = []
    for line in lines[i + 1 :]:
        m = re.search(r"\s*SCPos:\s*(\d+)", line)
        if m:
            out.append(int(m.group(1)))
    return out


def format_scene_changes_text(scpos: list[int], mutes: list[tuple[int, int]]) -> str:
    """chapter_exe-compatible output file."""
    lines = ["chapter_exe compatible output", "----"]
    for i, (s, e) in enumerate(mutes):
        lines.append(f"mute{i}: {s} - {e}")
    for p in scpos:
        lines.append(f"  SCPos: {p}")
    return "\n".join(lines) + "\n"


def make_cm_zones(trims: list[int], num_frames: int) -> list[EncoderZone]:
    """Complement of the trim list = CM zones (ref makeCMZones :441-459)."""
    split = [0] + list(trims) + [num_frames]
    for a, b in zip(split, split[1:]):
        if b < a:
            raise FormatError("invalid trim list")
    zones = []
    for i in range(0, len(split), 2):
        if split[i + 1] - split[i] > 0:
            zones.append(EncoderZone(split[i], split[i + 1]))
    return zones


# ---------------------------------------------------------------------------
# the CM decision rule engine (join_logo_scp capability)
# ---------------------------------------------------------------------------

@dataclass
class JlsOptions:
    """Default ruleset approximating the standard JL command files."""

    cm_units: tuple = (5.0, 10.0, 15.0, 30.0, 60.0, 90.0, 120.0)
    unit_tolerance: float = 0.6  # seconds
    silence_scene_window: float = 1.2  # pair silence with a cut within this
    min_program_sec: float = 30.0  # shorter logo-on islands are absorbed
    div_cm_sec: float = 55.0  # CM runs at least this long split the program


class JlsDecider:
    """Rule-based CM boundary decision from logo intervals + scene/silence.

    Inputs mirror what join_logo_scp consumes (logoframe file, scpos file);
    outputs mirror what it produces (trim list, div list).
    """

    def __init__(self, num_frames: int, fps: float, opts: JlsOptions | None = None):
        self.num_frames = num_frames
        self.fps = fps
        self.opts = opts or JlsOptions()

    def decide(
        self,
        logo_spans: list[tuple[int, int]] | None,  # logo-on [start, end)
        scene_changes: list[int],
        silence_spans: list[tuple[int, int]],  # in frames
    ) -> tuple[list[int], list[int]]:
        """Returns (trims, divs)."""
        blocks, cm_flags = self.analyze_blocks(
            logo_spans, scene_changes, silence_spans)
        return self.finish(blocks, cm_flags)

    def analyze_blocks(
        self,
        logo_spans: list[tuple[int, int]] | None,
        scene_changes: list[int],
        silence_spans: list[tuple[int, int]],
    ) -> tuple[list[tuple[int, int]], list[bool]]:
        """The decision core, stopping before trims are derived: returns
        (blocks, cm_flags) where blocks partition [0, n) between candidate
        cut points and cm_flags[i] is True when block i is CM. A JL
        command script (models/jls_script.py) edits these flags before
        `finish` derives trims/divs — the same structure join_logo_scp's
        Auto commands manipulate."""
        n = self.num_frames
        fps = self.fps
        o = self.opts

        # 1. CM-candidate cut points: scene changes near a silence span
        cuts = {0, n}
        win = int(o.silence_scene_window * fps)
        silence_mids = [(s + e) // 2 for s, e in silence_spans]
        for sc in scene_changes:
            if not silence_mids:
                cuts.add(sc)
            elif any(abs(sc - m) <= win + (e - s) // 2
                     for (s, e), m in zip(silence_spans, silence_mids)):
                cuts.add(sc)
        cuts = sorted(cuts)

        # 2. blocks between cuts; CM-unit-sized blocks are CM candidates
        blocks = list(zip(cuts, cuts[1:]))

        is_cm_unit = self.is_cm_unit

        cm_flags = []
        for s, e in blocks:
            flag = is_cm_unit(e - s)
            if logo_spans is not None:
                # logo presence overrides: majority-on block = program
                on = sum(
                    max(0, min(e, le) - max(s, ls)) for ls, le in logo_spans
                )
                if on > (e - s) * 0.5:
                    flag = False
                elif logo_spans and on < (e - s) * 0.1 and is_cm_unit(e - s):
                    flag = True
                elif logo_spans and on < (e - s) * 0.1:
                    # logo absent but not unit-sized: CM only if it chains
                    # with adjacent CM-unit blocks (handled below)
                    flag = None
            cm_flags.append(flag)

        # resolve undecided blocks: absorb into neighbouring CM runs
        for i, f in enumerate(cm_flags):
            if f is None:
                prev_cm = i > 0 and cm_flags[i - 1] is True
                next_cm = i + 1 < len(cm_flags) and cm_flags[i + 1] is True
                cm_flags[i] = prev_cm or next_cm

        # 3. short program islands between CM runs are absorbed
        min_prog = int(o.min_program_sec * fps)
        for i, (s, e) in enumerate(blocks):
            if not cm_flags[i] and (e - s) < min_prog:
                prev_cm = i > 0 and cm_flags[i - 1]
                next_cm = i + 1 < len(blocks) and cm_flags[i + 1]
                if prev_cm and next_cm and is_cm_unit(e - s):
                    cm_flags[i] = True
        return blocks, cm_flags

    def is_cm_unit(self, nframes: int) -> bool:
        sec = nframes / self.fps
        return any(abs(sec - u) <= self.opts.unit_tolerance
                   for u in self.opts.cm_units)

    def finish(self, blocks: list[tuple[int, int]],
               cm_flags: list[bool]) -> tuple[list[int], list[int]]:
        """Derive (trims, divs) from the (possibly script-edited) flags."""
        n = self.num_frames
        fps = self.fps
        o = self.opts

        # 4. trims = maximal program runs
        trims: list[int] = []
        for (s, e), cm in zip(blocks, cm_flags):
            if cm:
                continue
            if trims and trims[-1] == s:
                trims[-1] = e
            else:
                trims.append(s)
                trims.append(e)

        # 5. divs: split where CM runs >= div_cm_sec separate program parts
        divs = [0]
        div_cm = int(o.div_cm_sec * fps)
        run_start = None
        for (s, e), cm in zip(blocks, cm_flags):
            if cm:
                if run_start is None:
                    run_start = s
                if e - run_start >= div_cm and e < n:
                    pass  # decided when the run ends
            else:
                if run_start is not None and s - run_start >= div_cm and run_start > 0:
                    divs.append(s)
                run_start = None
        return trims, divs


# ---------------------------------------------------------------------------
# orchestration (the CMAnalyze class equivalent)
# ---------------------------------------------------------------------------

class CMAnalyzeResult:
    def __init__(self):
        self.logopath: str = ""
        self.trims: list[int] = []
        self.cmzones: list[EncoderZone] = []
        self.scene_changes: list[int] = []
        self.divs: list[int] = []


class CMAnalyzer:
    """Per-intermediate-file CM analysis (ref CMAnalyze.hpp:22-84)."""

    def __init__(self, ctx, num_frames: int, fps: float,
                 jls_options: JlsOptions | None = None,
                 loose_logo_detection: bool = False,
                 jls_script=None):
        self.ctx = ctx
        self.num_frames = num_frames
        self.fps = fps
        self.jls_options = jls_options
        self.loose = loose_logo_detection
        self.jls_script = jls_script  # models.jls_script.JlsScript | None
        self.result = CMAnalyzeResult()

    def logo_threshold(self) -> float:
        """3% for short content (<= 7 min) or loose mode, else 10%
        (ref :301-309)."""
        duration = self.num_frames / self.fps
        if self.loose:
            return 0.03
        return 0.03 if duration <= 60 * 7 else 0.1

    def analyze(
        self,
        logo_spans: list[tuple[int, int]] | None,
        logo_ratio: float,
        logo_path: str,
        scene_changes: list[int],
        silence_spans: list[tuple[int, int]],
    ) -> CMAnalyzeResult:
        r = self.result
        r.scene_changes = list(scene_changes)
        if logo_path and logo_ratio >= self.logo_threshold():
            r.logopath = logo_path
        else:
            logo_spans = None  # no matching logo: decide from cuts alone
            if logo_path:
                self.ctx.info("no matching logo for this section")
        if self.jls_script is not None:
            # user rule script drives the decision (ref joinLogoScp with
            # the profile's JL command file, CMAnalyze.hpp:338-365)
            trims, divs = self.jls_script.run(
                self.num_frames, self.fps, logo_spans, scene_changes,
                silence_spans, base_options=self.jls_options)
        else:
            decider = JlsDecider(self.num_frames, self.fps, self.jls_options)
            trims, divs = decider.decide(
                logo_spans, scene_changes, silence_spans)
        r.trims = trims
        r.divs = normalize_divs(divs, self.num_frames)
        r.cmzones = make_cm_zones(trims, self.num_frames)
        return r

    def input_trim_avs(self, line: str) -> None:
        """External Trim AVS override (ref inputTrimAVS :197-212)."""
        self.result.trims = parse_trim_avs(line, self.num_frames)
        self.result.cmzones = make_cm_zones(self.result.trims, self.num_frames)

    def apply_pmt_cut(self, rates: tuple[float, float],
                      pid_changes: list[int]) -> None:
        """PMT-change-driven head/tail CM recognition (ref :107-195).

        rates: (head_rate, tail_rate) of the valid cut budget.
        """
        r = self.result
        n = self.num_frames
        if not r.scene_changes:
            self.ctx.info("no scene changes; cannot use PMT changes for CM cuts")
        self.ctx.info("[PMT-change CM recognition]")
        sc = r.scene_changes
        valid_start, valid_end = 0, n
        matched = []
        for pc in pid_changes[1:]:
            nxt = int(np.searchsorted(sc, pc, side="left")) if sc else 0
            prv = nxt - 1 if nxt > 0 else nxt
            if nxt == len(sc):
                nxt = prv
            if sc:
                if abs(pc - sc[nxt]) < 30 * 2:
                    matched.append(sc[nxt])
                    self.ctx.info("PMT change at %d snapped to scene change %d", pc, sc[nxt])
                elif abs(pc - sc[prv]) < 30 * 2:
                    matched.append(sc[prv])
                    self.ctx.info("PMT change at %d snapped to scene change %d", pc, sc[prv])
                else:
                    self.ctx.info("PMT change at %d has no nearby scene change; ignored", pc)
        max_cut0 = int(rates[0] * n)
        max_cut1 = n - int(rates[1] * n)
        for m in matched:
            if m < max_cut0:
                valid_start = max(valid_start, m)
            if m > max_cut1:
                valid_end = min(valid_end, m)

        new_trims = []
        for i in range(0, len(r.trims), 2):
            start, end = r.trims[i], r.trims[i + 1]
            if end <= valid_start:
                continue
            start = max(start, valid_start)
            if start >= valid_end:
                continue
            end = min(end, valid_end)
            new_trims += [start, end]
        r.trims = new_trims
        r.cmzones = make_cm_zones(r.trims, n)
