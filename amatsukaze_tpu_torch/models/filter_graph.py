"""Per-output-file filter graph: KFM analysis + device output synthesis.

Counterpart of amatsukaze_tpu/models/filter_graph.py (parity:
AMTFilterSource, Amatsukaze/FilteredSource.hpp:136-635):

  pass 1 (analysis): field-match costs of every frame on the device
          (the yadif_fieldmatch kernel, costs only)        [KFM pass 1]
  pass 2 (decision): pattern costs -> KFMDecider -> VFR plan, on the host
          (models.kfm)                                     [KFM pass 2]
  pass 3 (output):   per-batch synthesis on the device: weave / pulldown
          repair / bob and a gather for the KFM modes, the yadif_fieldmatch
          kernel (frames only) for yadif, both fields of it for yadif60,
          the motion-adaptive bob for qtgmc; then the optional post chain
          (ops.denoise: QP-map deblock, temporal NR, deband, edge level)
          and the Lanczos3 resize                         [KFM pass 3]

All nine modes of the JAX package: none, yadif, yadif60, qtgmc, kfm_vfr,
kfm_vfr30, kfm_cfr24, svp (24p film interpolated to smooth 60p by
ops.deint.mc_frame_interp) and autovfr (the KFM analysis in cycle-aligned
sections run on host threads, parallel/ordered.py, with the AutoVfr flow's
log and .def files). The output is rounded on the device to uint8, or to
uint16 at src_bits 10 (mode none with a post chain: the Main10 path).
`set_mesh` shards the device paths over several devices
(parallel/sharded_filter.py), as `--devices N` does in the JAX package.

Where yadif feeds a post chain or a resize, the port follows the JAX
package's production (TPU) path: the kernel's rounded uint8 frames feed the
chain (the JAX package's CPU path feeds its unrounded float yadif). yadif60
and qtgmc never reach a Pallas kernel in the JAX package, so their float
frames feed the chain unrounded here too; yadif60 takes the kernel (one
launch per field parity) only when nothing but the final rounding follows.
On the mesh path yadif never reaches the kernel before a chain or a resize,
in the JAX package too: the sharded float yadif feeds them, so there a
yadif + chain output differs from the single-device one.

The post chain and the resize are timed per stage, batch and plane
(utils/perf.StageTimer: CUDA events on the card, read once per output
pass), and `record_post_counters` adds the sums to the recording's trace:
`post.deblock_s`, `post.nr_s`, `post.deband_s`, `post.edge_s`,
`post.resize_s`, `post.frames` (output frames through the chain or the
resize) and `post.deblock_skipped_frames` (frames a deblocking chain ran
without QP maps; the graph warns once when there are any). A graph with
neither a chain nor a resize records none of them.
"""

from __future__ import annotations

import bisect
import copy
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

import torch.nn.functional as F

from ..ops import deint as deint_ops
from ..ops import denoise, fused_filter
from ..ops.resize import resize_lanczos3
from ..parallel.ordered import ordered_parallel
from ..types import VideoFormat
from ..utils.batching import batched
from ..utils.device import resolve_device, to_device, to_host
from ..utils.perf import StageTimer
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

    def materialize(self, trace=None) -> np.ndarray:
        """The batch on the host; `trace` counts the fetch's bytes."""
        out = to_host(self.dev[: self.n], trace)
        # 10-bit samples travel as int16 (torch has no uint16 arithmetic)
        return out.view(np.uint16) if out.dtype == np.int16 else out


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

    - none / yadif (CFR30) / yadif60 (CFR60, Yadifmod2 mode=1)
    - qtgmc: motion-adaptive double-rate 60p bob (KFMDeint mode=1)
    - kfm_vfr: KFM VFR with 60p fallback (mode=4, thswitch=3)
    - kfm_vfr30: KFM VFR without the 60p fallback (thswitch=-1)
    - kfm_cfr24: decimate everything to 24p (KFMDeint mode=2)
    - svp: 24p reconstruction + MC interpolation to smooth 60p
      (svp=true in the KFMDeint chain -> SVPflow)
    - autovfr: section-parallel VFR analysis with Its-style def/timecode
      file contracts (the AutoVfr.exe flow, Misc.cs:1346-1389)
    """

    MODE_NONE = "none"
    MODE_YADIF = "yadif"
    MODE_YADIF60 = "yadif60"
    MODE_QTGMC = "qtgmc"
    MODE_KFM_VFR = "kfm_vfr"
    MODE_KFM_VFR30 = "kfm_vfr30"
    MODE_KFM_CFR24 = "kfm_cfr24"
    MODE_SVP = "svp"
    MODE_AUTOVFR = "autovfr"

    # modes that run the KFM analysis passes and the plan's synthesis
    KFM_FAMILY = frozenset({MODE_KFM_VFR, MODE_KFM_VFR30, MODE_KFM_CFR24,
                            MODE_SVP, MODE_AUTOVFR})
    DOUBLE_RATE = frozenset({MODE_YADIF60, MODE_QTGMC})
    ALL_MODES = (MODE_NONE, MODE_YADIF, MODE_YADIF60, MODE_QTGMC,
                 MODE_KFM_VFR, MODE_KFM_VFR30, MODE_KFM_CFR24, MODE_SVP,
                 MODE_AUTOVFR)

    def __init__(self, ctx, mode: str = "none", batch: int = 32,
                 device=None, post_chain=None, qp_source=None):
        if mode not in self.ALL_MODES:
            raise ValueError(f"unknown filter mode {mode!r}")
        self.ctx = ctx
        self.mode = mode
        self.batch = batch
        self.device = resolve_device(device)
        # callable [B, H, W] float -> [B, H, W] float (build_post_chain)
        self.post_chain = post_chain
        # ts.qp_extract.QpMapSource in output-frame selection order: the
        # deblock post filter's per-macroblock quantisers
        self.qp_source = qp_source
        # output size (width, height) of the luma plane, applied after the
        # post chain (Lanczos3); chroma gets half of it
        self.resize: tuple | None = None
        # source sample bits: 8, or 10 for the Main10 post-chain-only path
        # (mode none), which filters from/to 10 bits and outputs uint16
        self.src_bits = 8
        # KFM's dirty-field (UCF) replacement (ref KfmEnableUcf): a FILM
        # frame whose chosen weave still combs gets bobbed instead
        self.kfm_ucf = True
        self.decisions = None
        self.frame_costs = None
        self.vfr_plan: VFRPlan | None = None
        # svp: plane -> (last film frame on the device, its film index, its
        # source index), so that interpolation pairs bridge batches
        self._svp_carry: dict = {}
        # set_mesh: the device paths sharded over a parallel.mesh.Mesh
        self.mesh = None
        self._mesh_backend = None
        # the post chain's and the resize's stage timings and frame counts
        # (record_post_counters)
        self._post_timer: StageTimer | None = None
        self._post_frames = 0
        self._deblock_skipped = 0
        self._deblock_warned = False

    def set_mesh(self, mesh_or_ndevices) -> None:
        """Shard the filter pass over a mesh (the JAX package's `--devices
        N` path): costs, deinterlace and the KFM synthesis run per shard
        (parallel/sharded_filter.py); svp's synthesis stays on one device.
        Takes a parallel.mesh.Mesh, or a count n: the first n visible CUDA
        devices (raises when fewer are visible), or n logical CPU shards
        when the graph's device is the CPU."""
        from ..parallel.mesh import Mesh, make_mesh
        from ..parallel.sharded_filter import ShardedFilterBackend

        mesh = mesh_or_ndevices
        if not isinstance(mesh, Mesh):
            n = int(mesh)
            if self.device.type == "cpu":
                mesh = make_mesh([self.device] * n)
            else:
                visible = torch.cuda.device_count()
                if visible < n:
                    raise RuntimeError(f"--devices {n}: only {visible} CUDA "
                                       f"devices visible")
                mesh = make_mesh([torch.device("cuda", i) for i in range(n)])
        self.mesh = mesh
        self._mesh_backend = ShardedFilterBackend(mesh)

    def debug_dump(self, num_frames: int) -> dict:
        """JSON-able description of the configured graph and its analysis
        decisions (the reference's --dump-filter AviSynth graph analog)."""
        out = {
            "mode": self.mode,
            "batch": self.batch,
            "num_source_frames": num_frames,
            "post_chain": bool(self.post_chain),
            "post_chain_wants_qp": bool(
                getattr(self.post_chain, "wants_qp", False)),
            "qp_source_frames": (len(self.qp_source.results)
                                 if self.qp_source is not None else 0),
        }
        if self.decisions is not None:
            modes = [int(d.mode) for d in self.decisions]
            out["kfm_cycles"] = len(modes)
            out["kfm_mode_histogram"] = {
                str(m): modes.count(m) for m in sorted(set(modes))}
            out["kfm_decisions"] = [
                {"mode": int(d.mode), "phase": int(d.phase)}
                for d in self.decisions[:2000]]
        if self.vfr_plan is not None:
            out["vfr_out_frames"] = len(self.vfr_plan.durations)
            out["vfr_duration_histogram"] = {
                str(d): self.vfr_plan.durations.count(d)
                for d in sorted(set(self.vfr_plan.durations))}
        return out

    def _make_decider(self) -> KFMDecider:
        decider = KFMDecider()
        if self.mode == self.MODE_KFM_VFR30:
            decider.allow_60 = False  # thswitch=-1 (Misc.cs:1320)
        if self.mode in (self.MODE_KFM_CFR24, self.MODE_SVP):
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
        if self.mode in (self.MODE_KFM_CFR24, self.MODE_SVP):
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
        costs = list(self._section_costs(frame_iter, halo=False))
        if not costs:
            return
        merged = to_host(torch.cat(costs), self.ctx.trace)
        self._finish_analysis(merged[:num_frames], num_frames)

    def _section_costs(self, frame_iter, halo: bool):
        """Field-match costs [n, 3] float32 on the device, per batch of a
        stream of luma frames (the yadif_fieldmatch kernel, costs only;
        nothing is fetched). With `halo` the first frame only gives the
        next one its predecessor: its own row is dropped."""
        carry = None  # last frame of the previous batch for cross-batch match
        for chunk in batched(frame_iter, self.batch):
            host = normalize_u8(np.stack(chunk))
            had_carry = carry is not None
            if self._mesh_backend is not None:
                c = self._mesh_backend.field_match_costs(
                    host if carry is None
                    else np.concatenate([carry[None], host]))
                carry = host[-1]
            else:
                arr = to_device(host, self.device, self.ctx.trace)
                arr_in = arr if carry is None else torch.cat([carry[None],
                                                              arr])
                _, c = fused_filter.yadif_fieldmatch(
                    arr_in, write_frames=False, with_costs=True)
                carry = arr[-1]
            if had_carry or halo:
                c = c[1:]  # the carried frame's row, or the halo frame's
            halo = False
            yield c

    def analyze_autovfr(self, section_opener, num_frames: int,
                        parallel: int = 2, log_prefix: str | None = None,
                        sections_log: list | None = None) -> None:
        """AutoVfr-equivalent sectioned analysis: split the sequence into
        `parallel` cycle-aligned sections, compute their field-match costs
        concurrently on host threads, delivered in strict order
        (parallel/ordered.ordered_parallel, the AMTOrderedParallel analog),
        then decide once over the merged costs (ref Server/Misc.cs:1346-1389:
        N Auto_Vfr analysis clips under AMTOrderedParallel, logs
        concatenated, AutoVfr.exe emits an Its .def, Its applies it).

        section_opener(start, end) -> iterator of luma frames for source
        indices [start, end). Sections request one frame of left halo so
        that the costs across section edges equal the single-stream pass
        (identical decisions whatever `parallel` is). The costs stay on the
        device and are fetched once. A section that comes up short (decoder
        EOF, a corrupt keyframe) is padded with its last row, an empty one
        with zeros, so that the merged rows stay index-aligned.

        With log_prefix, writes `{log_prefix}.autovfr{i}.log` per section
        and `{log_prefix}.autovfr.def` (Its-style fps ranges), the
        reference flow's file contracts. sections_log, where given,
        receives the sections' (start, end)."""
        if self.mode != self.MODE_AUTOVFR:
            return
        parallel = max(1, min(parallel, max(1, num_frames // 10)))
        # cycle-aligned contiguous sections
        per = -(-num_frames // parallel)
        per += (-per) % 5
        bounds = [(s, min(s + per, num_frames))
                  for s in range(0, num_frames, per)]

        def producer(sec_start, sec_end):
            halo = sec_start > 0
            got = 0
            last = None
            frames = section_opener(sec_start - int(halo), sec_end)
            for c in self._section_costs(frames, halo):
                got += len(c)
                if len(c):
                    last = c[-1:]
                yield c
            want = sec_end - sec_start
            if got < want:
                if last is not None:
                    yield last.expand(want - got, 3)
                else:
                    yield torch.zeros((want - got, 3), dtype=torch.float32,
                                      device=self.device)

        per_section: list[list[torch.Tensor]] = [[] for _ in bounds]
        for i, item in ordered_parallel(
                [producer(s, e) for s, e in bounds]):
            per_section[i].append(item)
        if log_prefix:
            for i, chunks in enumerate(per_section):
                rows = sum(len(c) for c in chunks)
                with open(f"{log_prefix}.autovfr{i + 1}.log", "w") as f:
                    f.write(f"# section {bounds[i][0]}-{bounds[i][1]}\n"
                            f"frames={rows}\n")
        chunks = [c for section in per_section for c in section]
        if sections_log is not None:
            sections_log.extend(bounds)
        if not chunks:
            return
        merged = to_host(torch.cat(chunks), self.ctx.trace)[:num_frames]
        self._finish_analysis(merged, num_frames)
        if log_prefix and self.decisions is not None:
            self._write_its_def(f"{log_prefix}.autovfr.def")

    def _write_its_def(self, path: str) -> None:
        """Its-style definition file: one `start end fps` frame range per
        line over the source clip (the contract AutoVfr.exe's .def plays
        in the reference flow; consumed there by Its to emit VFR +
        timecodes, Misc.cs:1386)."""
        fps_of = {CycleMode.FILM: 24, CycleMode.VIDEO_30: 30,
                  CycleMode.VIDEO_60: 60}
        ranges = []
        for ci, d in enumerate(self.decisions):
            fps = fps_of[d.mode]
            if ranges and ranges[-1][2] == fps:
                ranges[-1][1] = (ci + 1) * 5
            else:
                ranges.append([ci * 5, (ci + 1) * 5, fps])
        with open(path, "w") as f:
            f.write("# Its-style fps ranges (start end fps)\n")
            for s, e, fps in ranges:
                f.write(f"{s} {e} {fps}\n")

    # -- pass 3: output synthesis --------------------------------------------
    def output_spec(self, num_src_frames: int,
                    in_fmt: VideoFormat) -> FilterOutput:
        out = FilterOutput(out_format=copy.deepcopy(in_fmt))
        if self.resize is not None:
            # resized output resets SAR to 1:1 (ref MakeOutFormat :618-634)
            out.out_format.width, out.out_format.height = self.resize
            out.out_format.sar_width = out.out_format.sar_height = 1
        if self.mode == self.MODE_SVP and self.vfr_plan is not None:
            # 24p film reconstruction interpolated to smooth CFR 60p
            n_film = len(self.vfr_plan.durations)
            out.num_out_frames = (n_film * 5 + 1) // 2
            out.out_format.mul_div_fps(2, 1)
            out.out_format.progressive = True
        elif self.mode in self.KFM_FAMILY and self.vfr_plan is not None:
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
        elif self.mode in self.DOUBLE_RATE:
            # every field becomes a progressive frame
            out.num_out_frames = 2 * num_src_frames
            out.out_format.mul_div_fps(2, 1)
            out.out_format.progressive = True
        else:
            out.num_out_frames = num_src_frames
        return out

    def _host_frames(self, frames: np.ndarray) -> np.ndarray:
        """Frames at the source dtype they cross to the device in: uint8,
        or 10-bit samples as int16."""
        if self.src_bits > 8:
            return np.ascontiguousarray(frames, np.uint16).view(np.int16)
        return np.ascontiguousarray(normalize_u8(frames))

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        # frames cross to the device at source dtype and widen there
        return to_device(self._host_frames(frames), self.device,
                         self.ctx.trace)

    def _timer(self) -> StageTimer:
        """The stage timer of the post chain and the resize."""
        if self._post_timer is None:
            self._post_timer = StageTimer(self.device)
        return self._post_timer

    def _apply_post(self, out: torch.Tensor, src_indices, plane_h: int,
                    plane: int, n_valid: int, timer) -> torch.Tensor:
        """The post chain over float frames [N, H, W], with the QP maps of
        the output frames' source indices when the chain deblocks. Frames
        that a deblocking chain gets no maps for are counted (on the luma
        plane: n_valid of them)."""
        qp = None
        if getattr(self.post_chain, "wants_qp", False):
            if self.qp_source is not None:
                qp = self.qp_source.maps_for(src_indices)
            if qp is None and plane == 0:
                self._deblock_skipped += n_valid
        if qp is not None:
            mbh = qp.shape[1]
            scale = 2 if plane_h > mbh * 12 else 1  # luma vs 4:2:0 chroma
            return self.post_chain(
                out, qp=to_device(qp, out.device, self.ctx.trace),
                qp_block_scale=scale, src_bits=self.src_bits, timer=timer)
        return self.post_chain(out, src_bits=self.src_bits, timer=timer)

    def _apply_resize(self, out: torch.Tensor, plane: int) -> torch.Tensor:
        """Lanczos3 resize to the configured size (chroma: half)."""
        if self.resize is None:
            return out
        w2, h2 = self.resize
        if plane != 0:
            w2, h2 = w2 // 2, h2 // 2
        return resize_lanczos3(out, h2, w2)

    def _finish(self, out: torch.Tensor, src_indices, plane_h: int,
                plane: int, n_valid: int) -> DeferredBatch:
        """Post chain, resize, then the rounding to the source depth:
        uint8, or uint16 (as int16) above 8 bits."""
        timer = self._timer()
        if self.post_chain is not None:
            out = self._apply_post(out, src_indices, plane_h, plane, n_valid,
                                   timer)
        if self.resize is not None:
            with timer("resize"):
                out = self._apply_resize(out, plane)
        if plane == 0 and (self.post_chain is not None
                           or self.resize is not None):
            self._post_frames += n_valid
        mx = (1 << self.src_bits) - 1
        dt = torch.int16 if self.src_bits > 8 else torch.uint8
        q = torch.floor(out + 0.5).clamp(0, mx).to(dt)
        return DeferredBatch(q, n_valid)

    def record_post_counters(self) -> None:
        """Add the post chain's and the resize's counters of the output
        pass that has just fetched its last batch to the recording's trace
        (the module's docstring), and warn once per graph if frames went
        through a deblocking chain without QP maps. Nothing without a chain
        or a resize."""
        if self.post_chain is None and self.resize is None:
            return
        trace = self.ctx.trace
        if self._post_timer is not None:
            for name, secs in self._post_timer.collect().items():
                trace.add(f"post.{name}_s", secs)
        trace.add("post.frames", self._post_frames)
        if getattr(self.post_chain, "wants_qp", False):
            trace.add("post.deblock_skipped_frames", self._deblock_skipped)
            if self._deblock_skipped and not self._deblock_warned:
                self.ctx.warn("deblock: %d of %d output frames had no QP "
                              "maps; the post chain ran without deblock on "
                              "them", self._deblock_skipped,
                              self._post_frames)
                self._deblock_warned = True
        self._post_frames = self._deblock_skipped = 0

    def run_kfm_batch(self, frames: np.ndarray, prev_frame,
                      start_index: int, plane: int = 0, final: bool = False,
                      n_real: int | None = None) -> DeferredBatch:
        """Synthesize the VFR output frames whose source index falls in
        [start_index, start_index + n_real) (the KFM pass-3 analog).

        frames: [B, H, W] source frames (one plane); prev_frame: the source
        frame before `start_index` (None at the sequence head), needed for
        MERGE_PREV pulldown repair. plane names the Y/U/V plane (svp keeps
        a carry per plane); final marks the last batch of the stream (svp
        emits its frozen tail). n_real < len(frames) marks the trailing
        rows as padding (repeats of the last frame). With a post chain the
        output entries are padded to a multiple of 8 with the last one, as
        the JAX package pads them for its executables: temporal NR then
        averages the padding into the last real entries, as there. svp
        interpolates the unpadded entries and its outputs are not padded
        (as there)."""
        if self.vfr_plan is None:
            raise RuntimeError("run_kfm_batch before analyze()")
        end_index = start_index + (len(frames) if n_real is None else n_real)
        entries = [(src, op) for src, op in self.vfr_plan.source_frames
                   if start_index <= src < end_index]
        svp = self.mode == self.MODE_SVP
        if not entries and svp and final:
            return self._svp_emit(None, [], plane, True, frames.shape[1:])
        if not entries:
            return DeferredBatch(torch.empty(
                (0, *frames.shape[1:]), dtype=torch.uint8,
                device=self.device), 0)
        if self._mesh_backend is not None and not svp:
            # per shard: its contiguous run of entries from the source slab
            # it was shipped; the chain runs over the padded entries
            out, n_entries = self._mesh_backend.kfm_synth(
                self._host_frames(frames),
                None if prev_frame is None
                else self._host_frames(prev_frame[None])[0],
                [(src - start_index, op) for src, op in entries])
            srcs = ([src for src, _ in entries]
                    + [entries[-1][0]] * (len(out) - n_entries))
            return self._finish(out, srcs, frames.shape[1], plane, n_entries)
        arr = self._upload(frames)
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
        n_entries = len(entries)
        if self.post_chain is not None and not svp:
            entries = entries + [entries[-1]] * (-n_entries % 8)
        src_idx = torch.tensor([src - start_index for src, _ in entries],
                               device=self.device)
        op_arr = np.asarray([op for _, op in entries])
        out = variants[VFRPlan.WEAVE][src_idx]
        for op in ops_used - {VFRPlan.WEAVE}:
            m = to_device(op_arr == op, self.device,
                          self.ctx.trace)[:, None, None]
            out = torch.where(m, variants[op][src_idx], out)
        srcs = [src for src, _ in entries]
        if svp:
            return self._svp_emit(out, srcs, plane, final, frames.shape[1:])
        return self._finish(out, srcs, frames.shape[1], plane, n_entries)

    def _svp_emit(self, film, film_srcs: list, plane: int, final: bool,
                  plane_hw) -> DeferredBatch:
        """MC-interpolate this batch's film frames [n, H, W] (after the
        plane's carry) to the 60p grid: output j sits at film time 2j/5,
        between film frames k = (2j)//5 and k+1 (frac in {0, .4, .8, .2,
        .6}). The last film frame carries to the next batch; `final`
        freezes it for the tail outputs. film=None: no film frame in this
        batch (only a final call emits then, from the carry). Then the
        post chain, the resize and the rounding, as for every mode."""
        carry = self._svp_carry.get(plane)
        if film is None or not film_srcs:
            if not (final and carry is not None):
                return self._svp_empty(plane_hw)
            seq = carry[0][None]
            base = carry[1]
            srcs = [carry[2]]
        else:
            # global film index of this batch's first film frame
            all_srcs = [src for src, _ in self.vfr_plan.source_frames]
            base = bisect.bisect_left(all_srcs, film_srcs[0])
            seq = film
            srcs = list(film_srcs)
            if carry is not None:
                seq = torch.cat([carry[0][None], film])
                base -= 1
                srcs = [carry[2]] + srcs
        n_seq = len(srcs)
        # pairs (k, k+1) with both ends here; `final` adds the frozen tail
        # pair (last, last)
        pair_hi = base + n_seq if final else base + n_seq - 1
        outs = []  # (frac, a_local, b_local) per output, in order
        for k in range(base, pair_hi):
            a_local = k - base
            b_local = min(a_local + 1, n_seq - 1)
            for j in range(-(-5 * k // 2), -(-5 * (k + 1) // 2)):
                outs.append((round(2 * j / 5 - k, 1), a_local, b_local))
        self._svp_carry[plane] = (seq[-1], base + n_seq - 1, srcs[-1])
        if final:
            self._svp_carry.pop(plane, None)
        if not outs:
            return self._svp_empty(plane_hw)
        ordered = torch.empty((len(outs),) + tuple(seq.shape[1:]),
                              dtype=seq.dtype, device=seq.device)
        by_frac: dict[float, list[int]] = {}
        for i, (frac, _, _) in enumerate(outs):
            by_frac.setdefault(frac, []).append(i)
        for frac, idxs in by_frac.items():
            a = seq[[outs[i][1] for i in idxs]]
            if frac == 0.0:
                interp = a
            else:
                interp = deint_ops.mc_frame_interp(
                    a, seq[[outs[i][2] for i in idxs]], frac)
            ordered[idxs] = interp
        out_srcs = [srcs[a] for _, a, _ in outs]
        return self._finish(ordered, out_srcs, plane_hw[0], plane, len(outs))

    def _svp_empty(self, plane_hw) -> DeferredBatch:
        return DeferredBatch(torch.empty((0, *plane_hw), dtype=torch.uint8,
                                         device=self.device), 0)

    def run_pass3(self, frames: np.ndarray, prev_frame, next_frame,
                  start_index: int = 0, plane: int = 0,
                  n_real: int | None = None) -> DeferredBatch:
        """Filter one batch [B, H, W] -> its output frames (one per source
        frame; two, in field order, for yadif60 and qtgmc). prev/next_frame
        provide the temporal halo (None at the sequence ends); start_index
        is the batch's first source index (the QP maps' alignment). n_real <
        len(frames) marks the trailing rows as padding: the batch's length
        (and the post counters) count only the real frames' outputs."""
        idx = list(range(start_index, start_index + len(frames)))
        after = self.post_chain is not None or self.resize is not None
        real = len(frames) if n_real is None else n_real
        if self._mesh_backend is not None:
            return self._run_pass3_mesh(frames, prev_frame, next_frame, idx,
                                        plane, after, real)
        arr = self._upload(frames)
        if self.mode == self.MODE_NONE:
            if not after:
                return DeferredBatch(arr, real)
            return self._finish(arr.float(), idx, frames.shape[1], plane,
                                real)
        first = arr[:1] if prev_frame is None \
            else self._upload(prev_frame[None])
        last = arr[-1:] if next_frame is None \
            else self._upload(next_frame[None])
        if self.mode == self.MODE_YADIF or (
                self.mode == self.MODE_YADIF60 and not after):
            # extend the batch with the halo frames so the edge frames see
            # their true temporal neighbours; the kernel's own batch-edge
            # rule (prev of frame 0 / next of the last frame is itself)
            # reproduces the sequence-edge replication
            ext = torch.cat([first, arr, last])
            out = fused_filter.yadif_fieldmatch(ext)[0][1:-1]
            if self.mode == self.MODE_YADIF60:
                bottom = fused_filter.yadif_fieldmatch(
                    ext, parity_top=False)[0][1:-1]
                out = torch.stack([out, bottom], dim=1).flatten(0, 1)
            n_out = real * (len(out) // len(arr))
            if not after:
                return DeferredBatch(out, n_out)
            return self._finish(out.float(), idx, frames.shape[1], plane,
                                n_out)
        cur = arr.float()
        prev = torch.cat([first.float(), cur[:-1]])
        nxt = torch.cat([cur[1:], last.float()])
        if self.mode == self.MODE_QTGMC:
            out = deint_ops.motion_adaptive_bob(prev, cur, nxt, True)
        else:
            # Yadifmod2 mode=1 double rate: top field first (TFF)
            out = torch.stack(
                [deint_ops.yadif_deinterlace(prev, cur, nxt, True),
                 deint_ops.yadif_deinterlace(prev, cur, nxt, False)],
                dim=1).flatten(0, 1)
        idx = [i for i in idx for _ in range(2)]  # one QP map per field pair
        return self._finish(out, idx, frames.shape[1], plane, 2 * real)

    def _run_pass3_mesh(self, frames: np.ndarray, prev_frame, next_frame,
                        idx: list, plane: int, after: bool,
                        real: int) -> DeferredBatch:
        """run_pass3 over the mesh (filter_graph.py:862-880 of the JAX
        package): the sharded deinterlace, then the chain, the resize and
        the rounding over the gathered batch. yadif and yadif60 take K1 when
        nothing but the rounding follows."""
        mb = self._mesh_backend
        host = self._host_frames(frames)
        if self.mode == self.MODE_NONE:
            out = mb.put_batch(host)
            if not after:
                return DeferredBatch(out, real)
            return self._finish(out.float(), idx, frames.shape[1], plane,
                                real)
        out = mb.deint(self.mode, host,
                       *(None if f is None else self._host_frames(f[None])[0]
                         for f in (prev_frame, next_frame)),
                       rounded=not after)
        n_out = real * (len(out) // len(frames))
        if out.dtype == torch.uint8:
            return DeferredBatch(out, n_out)
        if self.mode in self.DOUBLE_RATE:
            idx = [i for i in idx for _ in range(2)]
        return self._finish(out, idx, frames.shape[1], plane, n_out)


def _untimed(name: str):
    return nullcontext()


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


POST_TOKENS = ("deblock", "nr", "deband", "edge")


def build_post_chain(spec: str):
    """The post-filter chain of comma-separated tokens {deblock, nr,
    deband, edge} (the reference's KDeblock / KTemporalNR / KDeband /
    KEdgeLevel, Server/Misc.cs:1403-1441), or None for no tokens. Unknown
    tokens raise ValueError.

    chain(frames, qp=None, qp_block_scale=2, src_bits=8, timer=None) maps
    float [B, H, W] frames in the source domain to the same: deblock runs
    first in the 8-bit domain with per-macroblock QP maps [B, mb_h, mb_w]
    (8-bit sources only), the rest in the 14-bit domain. deband draws from
    seed 0 with the index of each frame within the batch. timer(name), where
    given, is a context manager around each filter's work (a
    utils/perf.StageTimer); the names are the tokens."""
    tokens = {t.strip() for t in (spec or "").split(",") if t.strip()}
    if not tokens:
        return None
    unknown = tokens - set(POST_TOKENS)
    if unknown:
        raise ValueError(f"unknown post-filter tokens: {sorted(unknown)}")

    def chain(frames, qp=None, qp_block_scale=2, src_bits=8, timer=None):
        t = timer or _untimed
        x = frames
        if "deblock" in tokens and qp is not None and src_bits == 8:
            with t("deblock"):
                _, h, w = x.shape
                hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
                if (hp, wp) != (h, w):
                    xp = F.pad(x[:, None], (0, wp - w, 0, hp - h),
                               mode="replicate")[:, 0]
                    x = denoise.deblock_qp(
                        xp, qp, qp_block_scale=qp_block_scale)[:, :h, :w]
                else:
                    x = denoise.deblock_qp(x, qp,
                                           qp_block_scale=qp_block_scale)
        scale = float(1 << (14 - src_bits))  # ConvertBits(14) at depth
        x = x.to(torch.float32) * scale
        if "nr" in tokens:
            with t("nr"):
                x = denoise.temporal_nr(x)
        if "deband" in tokens:
            with t("deband"):
                x = denoise.deband(x, 0)
        if "edge" in tokens:
            with t("edge"):
                x = denoise.edge_level(x)
        return x * (1.0 / scale)  # back to the source domain

    chain.wants_qp = "deblock" in tokens
    return chain


def merge_prev_weave(frames: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Weave each frame's top field with the PREVIOUS frame's bottom field
    (3:2 pulldown repair for the split telecined frame)."""
    return deint_ops.weave(deint_ops.field_split(frames)[0],
                           deint_ops.field_split(prev)[1])


def bob_field(frames: torch.Tensor, top: bool) -> torch.Tensor:
    """Line-double one field to full height: kept lines pass through, the
    missing lines are the average of the adjacent kept lines (edge
    replicated)."""
    return deint_ops.bob_field(deint_ops.field_split(frames)[0 if top else 1],
                               top)


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
