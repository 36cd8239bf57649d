"""JL command-file interpreter: user rule scripts drive the CM decision.

The port's copy of amatsukaze_tpu/models/jls_script.py, which holds no JAX: the
port keeps its own so that it imports nothing of the JAX package.

The reference delegates CM cutting to the external join_logo_scp tool,
passing a user-supplied JL command file (``-incmd`` in
Amatsukaze/CMAnalyze.hpp:338-348 ``MakeJoinLogoScpArgs``; the path comes
from TranscodeSetting's ``getJoinLogoScpCmdPath``) plus free-form extra
options (``getJoinLogoScpOptions``).  Users tune CM detection by editing
these scripts (the stock files are ``JL_標準.txt`` / ``JL_フラグ.txt``
style rule sets).  Here the same command language drives the in-process
``JlsDecider``: the script edits the decider's block/CM-flag structure
the way join_logo_scp's Auto commands edit its tentative cut frames.

Supported language (line-based, ``#`` comments):

Flow / variables
    ``Set NAME VALUE``      set a variable
    ``Default NAME VALUE``  set only if unset
    ``If EXPR`` / ``Else`` / ``ElsIf EXPR`` / ``EndIf``
                            conditional blocks; EXPR supports numbers,
                            variables, ``== != < <= > >= && || !`` and
                            parentheses
    ``Call FILE``           include another command file (path relative
                            to the including file)

Parameters (applied before the base decision)
    ``SetParam NAME VALUE`` tune the decision engine.  Names:
        ``CmUnit``            comma list of CM unit lengths in seconds
        ``UnitTolerance``     match tolerance (sec)
        ``SilenceSceneWindow`` pair silence with a cut within (sec)
        ``MinProgramSec``     shorter program islands may be absorbed
        ``DivCmSec``          CM runs this long split the program
        ``LogoMarginIn``      shift logo-span starts by this (sec, +=later)
        ``LogoMarginOut``     shift logo-span ends by this (sec, +=later)
        ``NoLogo``            1 = ignore logo periods entirely

Period edits (applied in script order after the base decision)
    ``AutoCut S|E|B [-limit SEC]``
        walk inward from the start/end/both edges, flipping CM-unit-sized
        blocks to CM until a non-unit program block is hit or ``-limit``
        seconds (default 90) have been cut — removes sponsorship/program
        spots at the edges even when the logo is lit.
    ``AutoAdd S|E|B [-sec LIST]``
        at the edges, re-add CM-flagged blocks whose length matches one
        of LIST seconds (default ``5,10,15``) and that touch the program
        body — restores sponsor screens / previews that belong to the
        program.
    ``AutoEdge S|E|B -sec N``
        unconditionally cut N seconds at the edge, snapped outward to
        block boundaries.
    ``AutoCM [-len SEC]``
        inside the program body, flip interior runs of consecutive
        CM-unit-sized blocks totalling >= SEC (default 60) to CM even
        when the logo is lit (logo-lit CM, "flag" broadcasts).
    ``AutoDel -from A -to B`` / ``AutoIns -from A -to B``
        force CM / force program over the [A, B) second range (block
        granularity, overlapping blocks are flipped).
    ``AutoUp``
        no-logo operation: equivalent to ``SetParam NoLogo 1``.
    ``MkLogo [-inmargin X] [-outmargin Y]``
        equivalent to the two LogoMargin parameters.

Variables pre-defined for ``If``: ``NOLOGO`` (1 when no logo matched),
``DURATION`` (clip length, sec), plus everything parsed from the extra
options string: ``-NAME VALUE`` pairs become variables, bare ``-flag``
tokens become ``flag=1`` (this is how the reference's free-form
JoinLogoScpOptions reach the script).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

from ..utils.context import FormatError
from .cm_analyze import JlsDecider, JlsOptions


@dataclass
class _Cmd:
    name: str
    args: list[str]
    line_no: int


def _parse_options_string(options: str) -> dict[str, str]:
    """``-NAME VALUE`` / ``-flag`` tokens -> variables dict."""
    out: dict[str, str] = {}
    toks = options.split()
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.startswith("-"):
            name = t.lstrip("-")
            if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                out[name] = toks[i + 1]
                i += 2
                continue
            out[name] = "1"
        i += 1
    return out


class _ExprEval:
    """Tiny recursive-descent evaluator for If expressions."""

    _TOK = re.compile(r"\s*(&&|\|\||==|!=|<=|>=|[!<>()]|[^\s!<>=&|()]+)")

    def __init__(self, expr: str, variables: dict[str, str]):
        self.toks = self._TOK.findall(expr)
        self.pos = 0
        self.vars = variables

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def _next(self):
        t = self._peek()
        self.pos += 1
        return t

    def _value(self, tok: str) -> float:
        if tok in self.vars:
            tok = self.vars[tok]
        try:
            return float(tok)
        except ValueError:
            # unset variable or bare word: falsy unless defined
            return 0.0

    def parse(self) -> bool:
        v = self._or()
        if self._peek() is not None:
            raise FormatError(f"trailing tokens in If expression: {self.toks[self.pos:]}")
        return bool(v)

    def _or(self):
        v = self._and()
        while self._peek() == "||":
            self._next()
            v = bool(self._and()) or bool(v)
        return v

    def _and(self):
        v = self._cmp()
        while self._peek() == "&&":
            self._next()
            rhs = self._cmp()
            v = bool(v) and bool(rhs)
        return v

    def _cmp(self):
        lhs = self._unary()
        op = self._peek()
        if op in ("==", "!=", "<", "<=", ">", ">="):
            self._next()
            rhs = self._unary()
            return {
                "==": lhs == rhs, "!=": lhs != rhs,
                "<": lhs < rhs, "<=": lhs <= rhs,
                ">": lhs > rhs, ">=": lhs >= rhs,
            }[op]
        return lhs

    def _unary(self):
        t = self._peek()
        if t == "!":
            self._next()
            return not bool(self._unary())
        if t == "(":
            self._next()
            v = self._or()
            if self._next() != ")":
                raise FormatError("unbalanced ( in If expression")
            return v
        if t is None:
            raise FormatError("truncated If expression")
        return self._value(self._next())


_EDIT_COMMANDS = {"autocut", "autoadd", "autoedge", "autocm",
                  "autodel", "autoins"}
_PARAM_NAMES = {
    "cmunit": "cm_units",
    "unittolerance": "unit_tolerance",
    "silencescenewindow": "silence_scene_window",
    "minprogramsec": "min_program_sec",
    "divcmsec": "div_cm_sec",
}


class JlsScript:
    """A parsed JL command file plus the option-string variables.

    ``run()`` executes it against one video section's analysis inputs and
    returns (trims, divs) — the same contract as ``JlsDecider.decide``.
    """

    def __init__(self, text: str, options: str = "",
                 base_dir: str = "", loader=None):
        self.text = text
        self.base_dir = base_dir
        self.loader = loader or self._default_loader
        self.option_vars = _parse_options_string(options)

    @classmethod
    def from_file(cls, path: str, options: str = "") -> "JlsScript":
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return cls(text, options, base_dir=os.path.dirname(path))

    def _default_loader(self, name: str) -> str:
        with open(os.path.join(self.base_dir, name), encoding="utf-8") as f:
            return f.read()

    # ------------------------------------------------------------- interpret
    def _interpret(self, variables: dict[str, str]):
        """Run flow control; returns (params, edit_cmds)."""
        params: dict[str, object] = {}
        edits: list[_Cmd] = []
        self._run_lines(self.text.splitlines(), variables, params, edits,
                        depth=0)
        return params, edits

    def _run_lines(self, lines, variables, params, edits, depth):
        if depth > 8:
            raise FormatError("JL Call nesting too deep")
        # condition stack: each entry is (active, taken_yet)
        stack: list[list[bool]] = []

        def active():
            return all(e[0] for e in stack)

        for ln, raw in enumerate(lines, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            cmd = parts[0].lower()
            args = parts[1:]
            if cmd == "if":
                cond = active() and _ExprEval(" ".join(args), variables).parse()
                stack.append([cond, cond])
            elif cmd == "elsif":
                if not stack:
                    raise FormatError(f"ElsIf without If (line {ln})")
                ent = stack[-1]
                outer = all(e[0] for e in stack[:-1])
                if ent[1]:
                    ent[0] = False
                else:
                    ent[0] = outer and _ExprEval(
                        " ".join(args), variables).parse()
                    ent[1] = ent[1] or ent[0]
            elif cmd == "else":
                if not stack:
                    raise FormatError(f"Else without If (line {ln})")
                ent = stack[-1]
                outer = all(e[0] for e in stack[:-1])
                ent[0] = outer and not ent[1]
                ent[1] = True
            elif cmd == "endif":
                if not stack:
                    raise FormatError(f"EndIf without If (line {ln})")
                stack.pop()
            elif not active():
                continue
            elif cmd == "set":
                if len(args) < 2:
                    raise FormatError(f"Set needs NAME VALUE (line {ln})")
                variables[args[0]] = args[1]
            elif cmd == "default":
                if len(args) < 2:
                    raise FormatError(f"Default needs NAME VALUE (line {ln})")
                variables.setdefault(args[0], args[1])
            elif cmd == "call":
                text = self.loader(args[0])
                self._run_lines(text.splitlines(), variables, params, edits,
                                depth + 1)
            elif cmd == "setparam":
                self._set_param(params, args, ln)
            elif cmd == "autoup":
                params["nologo"] = True
            elif cmd == "mklogo":
                opts = _parse_options_string(" ".join(args))
                if "inmargin" in opts:
                    params["logo_margin_in"] = float(opts["inmargin"])
                if "outmargin" in opts:
                    params["logo_margin_out"] = float(opts["outmargin"])
            elif cmd in _EDIT_COMMANDS:
                edits.append(_Cmd(cmd, args, ln))
            else:
                raise FormatError(f"unknown JL command {parts[0]} (line {ln})")
        if stack:
            raise FormatError("If without EndIf")

    def _set_param(self, params, args, ln):
        if len(args) < 2:
            raise FormatError(f"SetParam needs NAME VALUE (line {ln})")
        name = args[0].lower()
        val = args[1]
        if name == "cmunit":
            params["cm_units"] = tuple(float(x) for x in val.split(","))
        elif name == "nologo":
            params["nologo"] = float(val) != 0
        elif name == "logomarginin":
            params["logo_margin_in"] = float(val)
        elif name == "logomarginout":
            params["logo_margin_out"] = float(val)
        elif name in _PARAM_NAMES:
            params[_PARAM_NAMES[name]] = float(val)
        else:
            raise FormatError(f"unknown SetParam {args[0]} (line {ln})")

    # ------------------------------------------------------------------ run
    def run(
        self,
        num_frames: int,
        fps: float,
        logo_spans: list[tuple[int, int]] | None,
        scene_changes: list[int],
        silence_spans: list[tuple[int, int]],
        base_options: JlsOptions | None = None,
    ) -> tuple[list[int], list[int]]:
        variables = dict(self.option_vars)
        variables.setdefault("NOLOGO", "1" if logo_spans is None else "0")
        variables.setdefault("DURATION", f"{num_frames / fps:.3f}")
        params, edits = self._interpret(variables)

        opts = JlsOptions(**{
            f: getattr(base_options or JlsOptions(), f)
            for f in ("cm_units", "unit_tolerance", "silence_scene_window",
                      "min_program_sec", "div_cm_sec")
        })
        for f in ("cm_units", "unit_tolerance", "silence_scene_window",
                  "min_program_sec", "div_cm_sec"):
            if f in params:
                setattr(opts, f, params[f])

        if params.get("nologo"):
            logo_spans = None
        elif logo_spans is not None:
            din = int(params.get("logo_margin_in", 0.0) * fps)
            dout = int(params.get("logo_margin_out", 0.0) * fps)
            if din or dout:
                logo_spans = [
                    (max(0, min(s + din, num_frames)),
                     max(0, min(e + dout, num_frames)))
                    for s, e in logo_spans
                ]
                logo_spans = [(s, e) for s, e in logo_spans if e > s]

        decider = JlsDecider(num_frames, fps, opts)
        blocks, flags = decider.analyze_blocks(
            logo_spans, scene_changes, silence_spans)
        for cmd in edits:
            self._apply_edit(cmd, decider, blocks, flags, fps, num_frames)
        return decider.finish(blocks, flags)

    # ------------------------------------------------------------ period edits
    @staticmethod
    def _edge_arg(args: list[str], ln: int) -> str:
        for a in args:
            if a.upper() in ("S", "E", "B"):
                return a.upper()
        raise FormatError(f"edge command needs S|E|B (line {ln})")

    def _apply_edit(self, cmd: _Cmd, decider: JlsDecider, blocks, flags,
                    fps: float, n: int) -> None:
        opts = _parse_options_string(" ".join(cmd.args))
        name = cmd.name
        if name == "autocut":
            edge = self._edge_arg(cmd.args, cmd.line_no)
            limit = int(float(opts.get("limit", "90")) * fps)
            if edge in ("S", "B"):
                self._cut_from_edge(decider, blocks, flags, limit,
                                    range(len(blocks)))
            if edge in ("E", "B"):
                self._cut_from_edge(decider, blocks, flags, limit,
                                    range(len(blocks) - 1, -1, -1))
        elif name == "autoadd":
            edge = self._edge_arg(cmd.args, cmd.line_no)
            secs = [float(x) for x in opts.get("sec", "5,10,15").split(",")]
            tol = decider.opts.unit_tolerance
            # CM runs as (start_block, end_block) index ranges
            runs = []
            i = 0
            while i < len(flags):
                if flags[i]:
                    j = i
                    while j < len(flags) and flags[j]:
                        j += 1
                    runs.append((i, j))
                    i = j
                else:
                    i += 1

            def matches(i):
                sec_len = (blocks[i][1] - blocks[i][0]) / fps
                return any(abs(sec_len - want) <= tol for want in secs)

            if runs and edge in ("S", "B"):
                # first CM run: its last block touches the program body
                # that follows (sponsor screen before the show resumes)
                i = runs[0][1] - 1
                if runs[0][1] < len(flags) and matches(i):
                    flags[i] = False
            if runs and edge in ("E", "B"):
                # last CM run: its first block touches the preceding
                # body (preview/sponsor after the show ends)
                i = runs[-1][0]
                if runs[-1][0] > 0 and matches(i):
                    flags[i] = False
        elif name == "autoedge":
            edge = self._edge_arg(cmd.args, cmd.line_no)
            sec = float(opts.get("sec", "0"))
            cut = int(sec * fps)
            if edge in ("S", "B"):
                for i, (s, e) in enumerate(blocks):
                    if s < cut:
                        flags[i] = True
            if edge in ("E", "B"):
                for i, (s, e) in enumerate(blocks):
                    if e > n - cut:
                        flags[i] = True
        elif name == "autocm":
            min_len = int(float(opts.get("len", "60")) * fps)
            i = 0
            while i < len(blocks):
                if flags[i] or not decider.is_cm_unit(
                        blocks[i][1] - blocks[i][0]):
                    i += 1
                    continue
                j = i
                while (j < len(blocks) and not flags[j]
                       and decider.is_cm_unit(blocks[j][1] - blocks[j][0])):
                    j += 1
                run_len = blocks[j - 1][1] - blocks[i][0]
                # interior only: never flip the actual program head/tail
                if run_len >= min_len and i > 0 and j < len(blocks):
                    for k in range(i, j):
                        flags[k] = True
                i = j
        elif name in ("autodel", "autoins"):
            a = int(float(opts.get("from", "0")) * fps)
            b = int(float(opts.get("to", "0")) * fps)
            for i, (s, e) in enumerate(blocks):
                if min(e, b) - max(s, a) > 0:
                    flags[i] = name == "autodel"

    @staticmethod
    def _cut_from_edge(decider, blocks, flags, limit, order):
        cut = 0
        for i in order:
            s, e = blocks[i]
            if flags[i]:
                continue  # already CM: free to walk past
            if not decider.is_cm_unit(e - s):
                return  # hit the program body
            if cut + (e - s) > limit:
                return
            flags[i] = True
            cut += e - s

