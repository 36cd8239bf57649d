#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's filter core on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build both CUDA kernels from ops/csrc (one nvcc per source, started
   together) and print the ptxas register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (and the yadif/field-match kernel also at a width
   that is no multiple of 16 and on misaligned, row-strided views), and
   time both beside the bound: CUDA events, the median of several repeats
   with min and max, once on one buffer (warm: whatever fits stays in L2)
   and once rotating over buffers that together exceed the 50 MB L2 (cold:
   what a caller sees that has just uploaded the batch);
3. the main path: a synthetic 1440x1080i clip (3:2 telecined film, then
   interlaced video, a rendered 96x256 logo) through
   pipeline.filter_stage.run_filter_stage in kfm_vfr mode, batch 32,
   Y/U/V, with every kernel launch counter set to 0 just before and read
   just after; the same stage with the plain versions patched in must give
   the same logo, fade curve, cycle decisions, VFR plan and frames. Then
   the yadif mode over the same clip, the same way;
4. one more kfm_vfr run under torch.profiler: the device busy share and
   the kernels that take the device time;
5. the same stage on a small clip on the CPU and on the card: identical;
6. the stage over the two seeded clips of utils/synth_clip.py (96x128 and
   1440x1080, 45 frames) on the card against the results recorded from the
   JAX package on the CPU (testdata/golden_stage.json, written by
   tests/test_torch_golden.py): logo, decisions, plan and every frame
   digest exact, the fade curve within 1e-5.

Output: the card's name and power limit (nvidia-smi), build and phase
times, every check and timing above, one `kernels` JSON line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
H, W = 1080, 1440
LOGO_H, LOGO_W = 96, 256
LOGO_X, LOGO_Y = 1120, 40  # top right, where broadcasters put the logo
BATCH = 32
N_FILM, N_VIDEO = 240, 60


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


L2_BYTES = 50e6  # H100


class Timing(dict):
    """Milliseconds of one call: median, min and max over the repeats."""

    def __str__(self) -> str:
        return f"{self['ms']:.4f} [{self['min']:.4f}-{self['max']:.4f}]"


def time_ms(fn, iters: int, repeats: int = 7) -> Timing:
    """Time of one `fn(i)` on the card: `repeats` windows of `iters`
    back-to-back calls between two CUDA events, after one warm-up window;
    the median window with the fastest and the slowest. `i` counts the
    calls, so that `fn` can rotate over its buffers. The device spins while
    a window is enqueued, so that it never waits for the host (a window
    whose calls the host enqueues slower than the device runs them times
    the host: that made the two-fade logo figure jump between runs)."""
    spin = getattr(torch.cuda, "_sleep", None)
    count = 0
    windows = []
    for rep in range(repeats + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin is not None:
            spin(12_000_000)  # about 6 ms: the whole window is enqueued
        start.record()
        for _ in range(iters):
            fn(count)
            count += 1
        end.record()
        end.synchronize()
        if rep:
            windows.append(start.elapsed_time(end) / iters)
    return Timing(ms=statistics.median(windows), min=min(windows),
                  max=max(windows))


def time_warm_cold(make_fn, buffers: list, iters: int) -> tuple:
    """(warm, cold) timings of make_fn(buffer)(): always on buffers[0], and
    rotating over all of them (together larger than the L2)."""
    fns = [make_fn(b) for b in buffers]
    warm = time_ms(lambda i: fns[0](), iters)
    cold = time_ms(lambda i: fns[i % len(fns)](), iters)
    return warm, cold


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# synthetic content
# ---------------------------------------------------------------------------

def make_clip(n_film, n_video, h, w, lh, lw, lx, ly, seed, device):
    """(Y, U, V) uint8 planes: n_film frames of a panning film source, 3:2
    hard-telecined, then n_video frames of true interlaced video, with the
    logo painted on from frame 20 and mild noise. Made on `device` from
    `seed`, returned as numpy (utils/synth_clip.py makes the same
    structure from numpy alone, for the clips whose results are recorded)."""
    from amatsukaze_tpu_torch.utils import synth_clip

    gen = torch.Generator(device=device).manual_seed(seed)
    geoms = [(h, w, 7.0, 80.0, 120.0, 1), (h // 2, w // 2, 5.0, 30.0, 128.0, 2),
             (h // 2, w // 2, 6.0, 30.0, 128.0, 2)]
    colors = (200.0, 90.0, 170.0)

    def film(t, gh, gw, period, amp, base, sub):
        yy = torch.arange(gh, device=device, dtype=torch.float32)[:, None]
        xx = torch.arange(gw, device=device, dtype=torch.float32)[None, :]
        pan = 6.0 / sub
        return (base + amp * torch.sin((xx + pan * t) / period)
                * torch.cos(yy / 9.0) + 0.25 * amp * torch.sin(
                    (xx * 0.37 + yy * 0.61) / period))

    def weave(top, bot):
        f = top.clone()
        f[1::2] = bot[1::2]
        return f

    # (top time, bottom time) per coded frame
    times = []
    i = 0
    while len(times) < n_film:
        a, b, c, d = i, i + 1, i + 2, i + 3
        times += [(a, a), (a, b), (b, c), (c, c), (d, d)]
        i += 4
    times = times[:n_film]
    times += [(i + 2.5 * k, i + 2.5 * k + 1.25) for k in range(n_video)]
    frames = []
    for k, (tt, tb) in enumerate(times):
        planes = []
        for p, g in enumerate(geoms):
            f = weave(film(tt, *g[:5], g[5]), film(tb, *g[:5], g[5]))
            sub = g[5]
            if k >= 20:
                al = torch.from_numpy(
                    synth_clip.logo_alpha(lh // sub, lw // sub)).to(device)
                y0, x0 = ly // sub, lx // sub
                win = f[y0:y0 + al.shape[0], x0:x0 + al.shape[1]]
                win.mul_(1 - al).add_(al * colors[p])
            f = f + 0.6 * torch.randn(f.shape, generator=gen, device=device)
            planes.append(f.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        frames.append(tuple(planes))
    return frames


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def row(shape, kernel, plain, bound, err, **extra) -> dict:
    """One kernel at one shape: `ms` is the figure its caller on the main
    path sees (cold for the frame kernels, whose batch has just been
    uploaded; warm for the 3 MB logo window), with its min and max; the
    other timing of the pair is kept beside it."""
    bd, by = bound
    return dict(shape=list(shape), ms=kernel["ms"], ms_min=kernel["min"],
                ms_max=kernel["max"], plain_ms=plain["ms"], bound_ms=bd,
                bound_by=by, max_abs_err=err, **extra)


def assert_kernel_a(ff, x, what: str, erase=None) -> float:
    """yadif_fieldmatch against its plain version on `x` in all modes:
    frames bit-equal, costs equal (both exact int64 sums). Returns the
    largest cost difference seen (0 unless the means round apart)."""
    worst = 0.0
    modes = [dict(write_frames=True), dict(write_frames=False, with_costs=True),
             dict(write_frames=True, with_costs=True)]
    if erase is not None:
        modes.append(dict(write_frames=True, with_costs=True, erase=erase))
    for kw in modes:
        got = ff.yadif_fieldmatch(x, **kw)
        torch.cuda.synchronize()
        want = ff.yadif_fieldmatch_plain(x, **kw)
        name = ff.mode_name(kw["write_frames"], kw.get("with_costs", False),
                            kw.get("erase"))
        if got[0] is not None and not torch.equal(got[0], want[0]):
            n = (got[0] != want[0]).sum().item()
            raise AssertionError(f"{what} [{name}]: {n} pixels differ")
        if got[1] is not None:
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
            worst = max(worst, (got[1] - want[1]).abs().max().item())
    return worst


def check_kernels(dev) -> dict:
    from amatsukaze_tpu_torch.ops import fused_filter as ff
    from amatsukaze_tpu_torch.ops import logo as lops
    from amatsukaze_tpu_torch.ops import logo_eval
    from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef
    from amatsukaze_tpu_torch.utils.synth_clip import logo_alpha

    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}

    def frames(b, h, w):
        return torch.randint(0, 256, (b, h, w), generator=gen, device=dev,
                             dtype=torch.uint8)

    def rotation(b, h, w):
        """Enough distinct batches to exceed the L2 twice over."""
        n = int(2 * L2_BYTES // (b * h * w)) + 2
        return [frames(b, h, w) for _ in range(n)]

    def erase_box(b, bh, bw, y0, x0):
        alpha = torch.from_numpy(logo_alpha(bh, bw)).to(dev)
        return ff.EraseBox(1.0 / (1.0 - alpha),
                           -alpha * 200.0 / (1.0 - alpha) / 255.0,
                           torch.rand(b, generator=gen, device=dev), y0, x0)

    # -- kernel A at the main path's shapes: all modes against plain --------
    luma = rotation(BATCH + 2, H, W)
    chroma = rotation(BATCH + 2, H // 2, W // 2)
    main_box = erase_box(BATCH, LOGO_H, LOGO_W, LOGO_Y, LOGO_X)
    cost_err = max(
        assert_kernel_a(ff, luma[0], "luma 34x1080x1440"),
        assert_kernel_a(ff, chroma[0], "chroma 34x540x720"),
        assert_kernel_a(ff, luma[0][:BATCH + 1], "luma 33x1080x1440"),
        assert_kernel_a(ff, luma[0][:BATCH], "luma 32x1080x1440 + box",
                        erase=main_box))
    log(f"check kernel A at 34x1080x1440, 34x540x720, 33x1080x1440 and "
        f"32x1080x1440 with the {LOGO_H}x{LOGO_W} box: frames bit-equal, "
        f"costs equal (max abs diff {cost_err:.3g}) in every mode")

    # -- kernel A off the 16-byte path: odd widths, misaligned views --------
    odd = {
        "34x1080x1434 view at column 3 (misaligned, row stride 1440)":
            (luma[0][:, :, 3:1437], erase_box(BATCH + 2, 96, 256, 40, 1117)),
        "34x1080x1434 view at column 0 (aligned, W % 16 = 10)":
            (luma[0][:, :, :1434], erase_box(BATCH + 2, 96, 256, 40, 1120)),
        "7x50x70 contiguous (row stride 70)":
            (frames(7, 50, 70), erase_box(7, 20, 33, 11, 30)),
        "5x38x333 view of 5x38x352 at column 16":
            (frames(5, 38, 352)[:, :, 16:349], erase_box(5, 9, 40, 1, 290)),
    }
    for what, (x, box) in odd.items():
        assert_kernel_a(ff, x, what, erase=box)
        log(f"check kernel A on {what}: bit-equal frames, equal costs in "
            f"yadif, costs, yadif+costs and yadif+costs+erase")

    # -- kernel A timings ----------------------------------------------------
    def timed(name, bufs, kw, n_ops_per_px, extra_bytes=0, erase=None):
        b, h, w = bufs[0].shape
        call = dict(kw, erase=erase) if erase is not None else kw
        warm, cold = time_warm_cold(
            lambda x: lambda: ff.yadif_fieldmatch(x, **call), bufs, 20)
        plain = time_ms(lambda i: ff.yadif_fieldmatch_plain(bufs[0], **call),
                        3, repeats=3)
        n_px = b * h * w
        n_bytes = n_px * (2 if kw.get("write_frames", True) else 1)
        bound = bound_ms(n_bytes + extra_bytes, n_ops_per_px * n_px / 2)
        # the CUDA kernel alone, without the wrapper's allocations and the
        # few small PyTorch kernels that turn the partial sums into means
        out = (torch.empty_like(bufs[0])
               if kw.get("write_frames", True) else None)
        n_tiles = ff.tile_count(h, ff.tile_rows_for(True))
        parts = (torch.empty((n_tiles, b, 3), dtype=torch.int64, device=dev)
                 if kw.get("with_costs") else None)
        _, alone = time_warm_cold(
            lambda x: lambda: ff.launch_kernel(x, out, parts, erase), bufs, 20)
        res[name] = row(bufs[0].shape, cold, plain, bound, 0.0,
                        warm_ms=warm["ms"], warm_min=warm["min"],
                        warm_max=warm["max"], kernel_alone_ms=alone["ms"],
                        achieved_gb_s=(n_bytes + extra_bytes) / alone["ms"]
                        / 1e6)
        log(f"time {name} {b}x{h}x{w}: cold {cold} ms, warm {warm} ms, the "
            f"kernel alone cold {alone} ms = "
            f"{res[name]['achieved_gb_s']:.0f} GB/s; plain {plain['ms']:.3f}"
            f" ms; bound {bound[0]:.4f} ms ({bound[1]})")

    timed("yadif_y", luma, dict(write_frames=True), 40)
    timed("yadif_uv", chroma, dict(write_frames=True), 40)
    costs_in = [x[:BATCH + 1] for x in luma]
    timed("costs_y", costs_in, dict(write_frames=False, with_costs=True), 30,
          extra_bytes=(BATCH + 1) * 12)
    both_in = [x[:BATCH] for x in luma]
    timed("yadif_costs_y", both_in, dict(write_frames=True, with_costs=True),
          70, extra_bytes=BATCH * 12)
    res["costs_y"]["max_abs_err"] = cost_err
    timed("yadif_costs_erase_y", both_in,
          dict(write_frames=True, with_costs=True), 70,
          extra_bytes=4 * (2 * LOGO_H * LOGO_W + BATCH) + BATCH * 12,
          erase=main_box)
    ratio = (res["yadif_costs_erase_y"]["kernel_alone_ms"]
             / res["yadif_costs_y"]["kernel_alone_ms"])
    log(f"time erase box mode / yadif+costs: {ratio:.3f}x (kernel alone)")
    del luma, chroma, costs_in, both_in

    # -- kernel B (K3: LogoFrameMatcher.scan_frames) -----------------------
    a = logo_alpha(LOGO_H, LOGO_W)
    ref = LogoEvalRef((1.0 / (1.0 - a)).astype(np.float32),
                      (-a * 200.0 / (1.0 - a) / 255.0).astype(np.float32))
    hw = LOGO_H * LOGO_W
    # one logo's tables and one batch of windows are 12 MB: six of each
    # exceed the L2
    sets = [(lops.LogoEvalParams.from_ref(ref, dev),
             lops.batched_deint_y(frames(BATCH, LOGO_H, LOGO_W).float()))
            for _ in range(6)]
    params, src = sets[0]
    n_mask = int(params.mask.sum().item())
    for n_fades in (2, 11):
        fades = torch.linspace(0, 1, n_fades, device=dev)
        got = logo_eval.evaluate_logo(params, src, 255.0, fades)
        want = lops.batched_evaluate_logo(params, src, 255.0, fades)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        warm, cold = time_warm_cold(
            lambda ps: lambda: logo_eval.evaluate_logo(ps[0], ps[1], 255.0,
                                                       fades), sets, 50)
        plain = time_ms(lambda i: lops.batched_evaluate_logo(
            params, src, 255.0, fades), 3, repeats=3)
        n_bytes = 4 * (src.numel() + 92 * hw + n_fades + BATCH * n_fades)
        n_ops = BATCH * n_fades * (6 * hw + 106 * n_mask)
        res[f"logo_eval_f{n_fades}"] = row(
            [BATCH, n_fades, LOGO_H, LOGO_W], warm, plain,
            bound_ms(n_bytes, n_ops), err, cold_ms=cold["ms"],
            cold_min=cold["min"], cold_max=cold["max"])
        r = res[f"logo_eval_f{n_fades}"]
        log(f"check logo_eval B={BATCH} F={n_fades}: max abs err {err:.3g} "
            f"(rtol/atol 1e-5: sum order); warm {warm} ms, cold {cold} ms, "
            f"plain {plain['ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Sink:
    """Counts the output frames, checks their planes and digests them."""

    def __init__(self, shapes):
        from amatsukaze_tpu_torch.utils.golden import frame_digest

        self.digest = frame_digest
        self.shapes = shapes
        self.digests = []
        self.seconds = 0.0  # spent here, inside the stage's output pass

    def __call__(self, planes):
        t0 = time.perf_counter()
        if tuple(p.shape for p in planes) != self.shapes:
            raise AssertionError(f"output planes {[p.shape for p in planes]}")
        if any(p.dtype != np.uint8 for p in planes):
            raise AssertionError("output planes must be uint8")
        self.digests.append(self.digest(planes))
        self.seconds += time.perf_counter() - t0


def reset_counts():
    from amatsukaze_tpu_torch.ops import fused_filter, logo_eval

    fused_filter.yadif_fieldmatch.launches.clear()
    logo_eval.evaluate_logo.launches = 0


def read_counts() -> dict:
    from amatsukaze_tpu_torch.ops import fused_filter, logo_eval

    c = dict(fused_filter.yadif_fieldmatch.launches)
    c["logo_eval"] = logo_eval.evaluate_logo.launches
    return c


@contextmanager
def plain_versions():
    """Route both wrappers to their plain PyTorch versions (the reference
    run on the card)."""
    from amatsukaze_tpu_torch.ops import fused_filter, logo, logo_eval

    with mock.patch.object(fused_filter, "yadif_fieldmatch",
                           fused_filter.yadif_fieldmatch_plain), \
            mock.patch.object(logo_eval, "evaluate_logo",
                              logo.batched_evaluate_logo):
        yield


def run_stage(clip, fmt, logos, mode, device, batch=BATCH):
    from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
    from amatsukaze_tpu_torch.utils.context import AMTContext

    h, w = clip[0][0].shape
    sink = Sink(((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_filter_stage(AMTContext(level="warn"), lambda: iter(clip),
                           len(clip), fmt, logos, mode, sink, batch=batch,
                           device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, sink, time.perf_counter() - t0


def stage_record(res, sink: Sink) -> dict:
    from amatsukaze_tpu_torch.utils import golden

    return golden.record(res.best_logo, res.fade, res.graph,
                         digests=sink.digests)


def same_result(a, b, sa: Sink, sb: Sink, what: str) -> None:
    """Two runs of the stage: logo, decisions, plan and frame digests
    equal, fade curves within 1e-5."""
    from amatsukaze_tpu_torch.utils import golden

    golden.assert_matches(stage_record(a, sa), stage_record(b, sb), what)


def main_clip(dev):
    """The main path's clip (made on the card from a seed), its format and
    the candidate logos."""
    from amatsukaze_tpu_torch.utils import synth_clip

    t0 = time.perf_counter()
    clip = make_clip(N_FILM, N_VIDEO, H, W, LOGO_H, LOGO_W, LOGO_X, LOGO_Y,
                     seed=1, device=dev)
    logos = synth_clip.make_logos(H, W, LOGO_H, LOGO_W, LOGO_X, LOGO_Y)
    fmt = synth_clip.video_format(H, W)
    log(f"clip: {len(clip)} frames {W}x{H} made in "
        f"{time.perf_counter() - t0:.2f} s")
    return clip, fmt, logos


def main_path(dev, clip, fmt, logos) -> dict:
    out = {"frames": len(clip)}
    for mode in ("kfm_vfr", "yadif"):
        reset_counts()
        res, sink, secs = run_stage(clip, fmt, logos, mode, dev)
        counts = read_counts()
        with plain_versions():
            ref, ref_sink, ref_secs = run_stage(clip, fmt, logos, mode, dev)
        same_result(res, ref, sink, ref_sink, f"{mode} kernels vs plain")
        if res.best_logo != 0:
            raise AssertionError(f"{mode}: picked logo {res.best_logo}")
        # logo painted on from frame 20: erased at a higher fade after it
        if not res.fade[40:].mean() > res.fade[:15].mean() + 0.2:
            raise AssertionError(f"{mode}: the fade curve misses the logo")
        if len(sink.digests) != res.spec.num_out_frames:
            raise AssertionError(f"{mode}: {len(sink.digests)} frames out, "
                                 f"spec says {res.spec.num_out_frames}")
        info = dict(seconds=secs, plain_seconds=ref_secs,
                    fps=len(clip) / secs, plain_fps=len(clip) / ref_secs,
                    fps_without_sink=len(clip) / (secs - sink.seconds),
                    sink_seconds=sink.seconds, pass_seconds=res.seconds,
                    out_frames=len(sink.digests), launches=counts)
        if mode == "kfm_vfr":
            modes = [int(d.mode) for d in res.graph.decisions]
            film = modes[:N_FILM // 5]
            if film.count(0) < 0.9 * len(film):
                raise AssertionError(f"telecine not detected: {modes}")
            info["cycle_modes"] = {str(m): modes.count(m)
                                   for m in sorted(set(modes))}
            need = ("costs", "logo_eval")
        else:
            if len(sink.digests) != len(clip):
                raise AssertionError("yadif must emit one frame per frame")
            need = ("yadif", "logo_eval")
        missing = [k for k in need if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{mode}: kernels never launched: {missing}")
        out[mode] = info
        log(f"main path {mode}: {len(clip)} frames in {secs:.3f} s = "
            f"{info['fps']:.2f} frames/s (plain versions {ref_secs:.3f} s; "
            f"passes {res.seconds}, of which the test sink "
            f"{sink.seconds:.3f} s); {len(sink.digests)} frames out; "
            f"launches {counts}"
            + (f"; cycles {info['cycle_modes']}" if mode == "kfm_vfr" else ""))
    return out


def profile_stage(dev, clip, fmt, logos) -> dict:
    """Device busy share and the kernels that take the device time, over
    one kfm_vfr run of the main path (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs = run_stage(clip, fmt, logos, "kfm_vfr", dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(wall_seconds=secs, device_busy_seconds=busy_s,
               device_busy_share=busy_s / secs if busy_s else None,
               top=[(e.key[:80], e.count, e.self_device_time_total / 1e3)
                    for e in top])
    if not busy_s:
        log("profile: the profiler recorded no device time (not measured)")
        return out
    log(f"profile kfm_vfr: wall {secs:.3f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / secs:.2f}%)")
    for name, count, ms in out["top"]:
        log(f"profile   {ms:9.3f} ms {count:6d}x  {name}")
    return out


def small_reference(dev) -> None:
    """The stage on a small clip on the CPU (plain versions) and on the
    card (kernels): identical results."""
    from amatsukaze_tpu_torch.utils import synth_clip

    h, w, lh, lw, lx, ly = 96, 128, 16, 24, 96, 8
    clip = make_clip(30, 15, h, w, lh, lw, lx, ly, seed=3, device="cpu")
    logos = synth_clip.make_logos(h, w, lh, lw, lx, ly)
    fmt = synth_clip.video_format(h, w)
    for mode in ("kfm_vfr", "yadif"):
        a, sa, _ = run_stage(clip, fmt, logos, mode, torch.device("cpu"), 8)
        b, sb, _ = run_stage(clip, fmt, logos, mode, dev, 8)
        same_result(a, b, sa, sb, f"small {mode} cpu vs card")
    log("small clip: card == CPU (kfm_vfr, yadif)")


def golden_reference(dev) -> None:
    """The stage on the card over the seeded numpy clips, against the
    results recorded from the JAX package on the CPU."""
    from amatsukaze_tpu_torch.utils import golden, synth_clip

    recorded = golden.load()
    for name in synth_clip.GOLDEN_CLIPS:
        t0 = time.perf_counter()
        clip, fmt, logos, batch = synth_clip.golden_clip(name)
        made = time.perf_counter() - t0
        for mode in golden.MODES:
            reset_counts()
            res, sink, secs = run_stage(clip, fmt, logos, mode, dev, batch)
            counts = read_counts()
            got = stage_record(res, sink)
            want = recorded[name][mode]
            golden.assert_matches(got, want, f"golden {name} {mode}")
            ties = sorted(int(k) for k in want["tie_digests"])
            on_jax = sum(a == b for a, b in zip(got["digests"],
                                                want["digests"]))
            log(f"golden {name} {mode}: {fmt.width}x{fmt.height}, "
                f"{len(clip)} frames (made in {made:.2f} s), batch {batch}:"
                f" logo, decisions, plan exact, fade within "
                f"{golden.FADE_TOL}, {on_jax} of {len(sink.digests)} frame "
                f"digests equal the JAX package's, "
                f"{len(sink.digests) - on_jax} the port's CPU digest on "
                f"the recorded erase-tie frames {ties}; {secs:.3f} s, "
                f"launches {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from amatsukaze_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_lib.build(["yadif_fieldmatch", "logo_eval"])
    log(f"build: {time.perf_counter() - t0:.2f} s ({built})")
    for name in ("yadif_fieldmatch", "logo_eval"):
        for line in (cuda_lib.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill" \
                        " loads" not in line:
                    raise AssertionError(f"{name}: ptxas reports spills")

    t0 = time.perf_counter()
    checks = check_kernels(dev)
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    clip, fmt, logos = main_clip(dev)
    main = main_path(dev, clip, fmt, logos)
    log(f"phase main path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    profile_stage(dev, clip, fmt, logos)
    log(f"phase profile: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    small_reference(dev)
    log(f"phase small reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    golden_reference(dev)
    log(f"phase golden reference: {time.perf_counter() - t0:.2f} s")

    kern = "amatsukaze_tpu_torch/ops/csrc/"
    rows = [
        ("yadif_fieldmatch[yadif]", "yadif_fieldmatch.cu",
         "amatsukaze_tpu/ops/fused_filter.py:335",
         main["yadif"]["launches"].get("yadif", 0), checks["yadif_y"]),
        ("yadif_fieldmatch[costs]", "yadif_fieldmatch.cu",
         "amatsukaze_tpu/ops/fused_filter.py:716",
         main["kfm_vfr"]["launches"].get("costs", 0), checks["costs_y"]),
        ("logo_eval", "logo_eval.cu", "amatsukaze_tpu/ops/logo_pallas.py:107",
         main["kfm_vfr"]["launches"]["logo_eval"]
         + main["yadif"]["launches"]["logo_eval"], checks["logo_eval_f11"]),
    ]
    kernels = []
    for n, src, rep, launches, c in rows:
        k = dict(name=n, route="cuda", source=kern + src, replaces=rep,
                 launches=launches, library_ms=None)
        k.update({key: val for key, val in c.items() if key != "shape"})
        kernels.append(k)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
