#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's filter core on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build both CUDA kernels from ops/csrc (one nvcc per source, started
   together) and print the ptxas register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and time both (CUDA events) beside the bound;
3. the main path: a synthetic 1440x1080i clip (3:2 telecined film, then
   interlaced video, a rendered 96x256 logo) through
   pipeline.filter_stage.run_filter_stage in kfm_vfr mode, batch 32,
   Y/U/V, with every kernel launch counter set to 0 just before and read
   just after; the same stage with the plain versions patched in must give
   the same logo, fade curve, cycle decisions, VFR plan and frames. Then
   the yadif mode over the same clip, the same way;
4. one more kfm_vfr run under torch.profiler: the device busy share and
   the kernels that take the device time;
5. the same stage on a small clip on the CPU and on the card: identical.

Output: the card's name and power limit (nvidia-smi), build and phase
times, every check and timing above, one `kernels` JSON line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
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


def time_ms(fn, iters: int) -> float:
    """Mean time of one call on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# synthetic content
# ---------------------------------------------------------------------------

def logo_alpha(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.hypot((yy - h / 2) / (h / 2), (xx - w / 2) / (w / 2))
    return (np.clip(1.2 - r, 0, 1) * 0.35).astype(np.float32)


def make_logos(h, w, lh, lw, lx, ly):
    """The logo painted on the clip and a decoy that never matches."""
    from amatsukaze_tpu_torch.models.lgd import LogoData, LogoHeader

    def ab(alpha, color):
        return ((1.0 / (1.0 - alpha)).astype(np.float32),
                (-alpha * color / (1.0 - alpha) / 255.0).astype(np.float32))

    header = LogoHeader(lw, lh, 1, 1, w, h, lx, ly, "smoke", 1)
    logo = LogoData.create(header)
    logo.a_y, logo.b_y = ab(logo_alpha(lh, lw), 200.0)
    logo.a_u, logo.b_u = ab(logo_alpha(lh // 2, lw // 2), 90.0)
    logo.a_v, logo.b_v = ab(logo_alpha(lh // 2, lw // 2), 170.0)
    decoy = LogoData.create(LogoHeader(lw, lh, 1, 1, w, h, lx, ly, "decoy", 2))
    stripes = np.zeros((lh, lw), np.float32)
    stripes[4:-4, 4:-4] = 0.3 * ((np.arange(lw - 8) // 6) % 2)
    decoy.a_y, decoy.b_y = ab(stripes, 60.0)
    return [logo, decoy]


def make_clip(n_film, n_video, h, w, lh, lw, lx, ly, seed, device):
    """(Y, U, V) uint8 planes: n_film frames of a panning film source, 3:2
    hard-telecined, then n_video frames of true interlaced video, with the
    logo painted on from frame 20 and mild noise. Made on `device` from
    `seed`, returned as numpy."""
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
                al = torch.from_numpy(logo_alpha(lh // sub, lw // sub)).to(device)
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

def check_kernels(dev) -> dict:
    from amatsukaze_tpu_torch.ops import fused_filter as ff
    from amatsukaze_tpu_torch.ops import logo as lops
    from amatsukaze_tpu_torch.ops import logo_eval
    from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef

    gen = torch.Generator(device=dev).manual_seed(7)
    res = {}

    def frames(b, h, w):
        return torch.randint(0, 256, (b, h, w), generator=gen, device=dev,
                             dtype=torch.uint8)

    # -- kernel A, yadif only (K1's use: FilterGraph.run_pass3, Y/U/V) ----
    for name, (b, h, w) in {"y": (BATCH + 2, H, W),
                            "uv": (BATCH + 2, H // 2, W // 2)}.items():
        x = frames(b, h, w)
        got, _ = ff.yadif_fieldmatch(x, write_frames=True)
        want, _ = ff.yadif_fieldmatch_plain(x, write_frames=True)
        err = (got.int() - want.int()).abs().max().item()
        if err != 0:
            raise AssertionError(f"yadif ({name}) differs from plain: {err}")
        k_ms = time_ms(lambda: ff.yadif_fieldmatch(x), 20)
        p_ms = time_ms(lambda: ff.yadif_fieldmatch_plain(x), 3)
        n_px = b * h * w
        bd, by = bound_ms(2 * n_px, 40 * n_px / 2)
        res[f"yadif_{name}"] = dict(shape=[b, h, w], ms=k_ms, plain_ms=p_ms,
                                    bound_ms=bd, bound_by=by, max_abs_err=err)
        log(f"check yadif {name} {b}x{h}x{w}: bit-equal; kernel {k_ms:.4f} ms,"
            f" plain {p_ms:.3f} ms, bound {bd:.4f} ms ({by})")

    # -- kernel A, costs only (K2's use: FilterGraph.analyze on Y) ----------
    x = frames(BATCH + 1, H, W)
    _, got = ff.yadif_fieldmatch(x, write_frames=False, with_costs=True)
    _, want = ff.yadif_fieldmatch_plain(x, write_frames=False, with_costs=True)
    cost_err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    k_ms = time_ms(lambda: ff.yadif_fieldmatch(
        x, write_frames=False, with_costs=True), 20)
    p_ms = time_ms(lambda: ff.yadif_fieldmatch_plain(
        x, write_frames=False, with_costs=True), 3)
    n_px = x.numel()
    bd, by = bound_ms(n_px + x.shape[0] * 12, 30 * n_px / 2)
    res["costs_y"] = dict(shape=list(x.shape), ms=k_ms, plain_ms=p_ms,
                          bound_ms=bd, bound_by=by, max_abs_err=cost_err)
    log(f"check costs {tuple(x.shape)}: max abs err {cost_err:.3g} "
        f"(rtol 1e-6: both sum exactly in int64); kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.3f} ms, bound {bd:.4f} ms ({by})")

    # -- kernel A, yadif + costs + erase box (K2's fused_logo mode) --------
    x = frames(BATCH, H, W)
    alpha = torch.from_numpy(logo_alpha(LOGO_H, LOGO_W)).to(dev)
    box = ff.EraseBox(1.0 / (1.0 - alpha), -alpha * 200.0 / (1.0 - alpha) / 255.0,
                      torch.rand(BATCH, generator=gen, device=dev), LOGO_Y,
                      LOGO_X)
    g_out, g_costs = ff.yadif_fieldmatch(x, with_costs=True, erase=box)
    w_out, w_costs = ff.yadif_fieldmatch_plain(x, with_costs=True, erase=box)
    err = (g_out.int() - w_out.int()).abs().max().item()
    if err != 0:
        raise AssertionError(f"yadif+costs+erase frames differ: {err}")
    torch.testing.assert_close(g_costs, w_costs, rtol=1e-6, atol=0.0)
    k_ms = time_ms(lambda: ff.yadif_fieldmatch(x, with_costs=True,
                                               erase=box), 20)
    p_ms = time_ms(lambda: ff.yadif_fieldmatch_plain(x, with_costs=True,
                                                     erase=box), 3)
    n_px = x.numel()
    bd, by = bound_ms(2 * n_px + 4 * (2 * LOGO_H * LOGO_W + BATCH),
                      70 * n_px / 2 + 8 * BATCH * LOGO_H * LOGO_W)
    res["yadif_costs_erase_y"] = dict(shape=list(x.shape), ms=k_ms,
                                      plain_ms=p_ms, bound_ms=bd, bound_by=by,
                                      max_abs_err=err)
    log(f"check yadif+costs+erase box {LOGO_H}x{LOGO_W}: bit-equal frames, "
        f"costs equal; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
        f"{bd:.4f} ms ({by})")

    # -- kernel B (K3: LogoFrameMatcher.scan_frames) -----------------------
    a = logo_alpha(LOGO_H, LOGO_W)
    ref = LogoEvalRef((1.0 / (1.0 - a)).astype(np.float32),
                      (-a * 200.0 / (1.0 - a) / 255.0).astype(np.float32))
    params = lops.LogoEvalParams.from_ref(ref, dev)
    src = lops.batched_deint_y(frames(BATCH, LOGO_H, LOGO_W).float())
    n_mask = int(params.mask.sum().item())
    for n_fades in (2, 11):
        fades = torch.linspace(0, 1, n_fades, device=dev)
        got = logo_eval.evaluate_logo(params, src, 255.0, fades)
        want = lops.batched_evaluate_logo(params, src, 255.0, fades)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        k_ms = time_ms(lambda: logo_eval.evaluate_logo(params, src, 255.0,
                                                       fades), 50)
        p_ms = time_ms(lambda: lops.batched_evaluate_logo(params, src, 255.0,
                                                          fades), 3)
        hw = LOGO_H * LOGO_W
        n_bytes = 4 * (src.numel() + 92 * hw + n_fades + BATCH * n_fades)
        n_ops = BATCH * n_fades * (6 * hw + 106 * n_mask)
        bd, by = bound_ms(n_bytes, n_ops)
        res[f"logo_eval_f{n_fades}"] = dict(
            shape=[BATCH, n_fades, LOGO_H, LOGO_W], ms=k_ms, plain_ms=p_ms,
            bound_ms=bd, bound_by=by, max_abs_err=err)
        log(f"check logo_eval B={BATCH} F={n_fades}: max abs err {err:.3g} "
            f"(rtol/atol 1e-5: sum order); kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {bd:.4f} ms ({by})")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Sink:
    """Counts the output frames, checks their planes and digests them."""

    def __init__(self, shapes):
        self.shapes = shapes
        self.digests = []
        self.seconds = 0.0  # spent here, inside the stage's output pass

    def __call__(self, planes):
        t0 = time.perf_counter()
        if tuple(p.shape for p in planes) != self.shapes:
            raise AssertionError(f"output planes {[p.shape for p in planes]}")
        if any(p.dtype != np.uint8 for p in planes):
            raise AssertionError("output planes must be uint8")
        h = hashlib.blake2b(digest_size=16)
        for p in planes:
            h.update(np.ascontiguousarray(p).data)
        self.digests.append(h.hexdigest())
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


def summary(res) -> dict:
    g = res.graph
    return dict(
        best_logo=res.best_logo,
        fade=None if res.fade is None else res.fade.tolist(),
        decisions=None if g.decisions is None else [
            (int(d.mode), int(d.phase)) for d in g.decisions],
        durations=None if g.vfr_plan is None else g.vfr_plan.durations,
        source_frames=None if g.vfr_plan is None else
        g.vfr_plan.source_frames,
        num_out=res.num_out_frames)


def same_result(a, b, sa: Sink, sb: Sink, what: str) -> None:
    x, y = summary(a), summary(b)
    fx, fy = x.pop("fade"), y.pop("fade")
    if x != y:
        diff = [k for k in x if x[k] != y[k]]
        raise AssertionError(f"{what}: results differ in {diff}")
    if (fx is None) != (fy is None) or (
            fx is not None and not np.allclose(fx, fy, rtol=0, atol=1e-5)):
        raise AssertionError(f"{what}: fade curves differ")
    bad = sum(p != q for p, q in zip(sa.digests, sb.digests))
    if len(sa.digests) != len(sb.digests) or bad:
        raise AssertionError(f"{what}: {bad} output frames differ")


def main_clip(dev):
    """The main path's clip (made on the card from a seed), its format and
    the candidate logos."""
    from amatsukaze_tpu_torch.types import VideoFormat

    t0 = time.perf_counter()
    clip = make_clip(N_FILM, N_VIDEO, H, W, LOGO_H, LOGO_W, LOGO_X, LOGO_Y,
                     seed=1, device=dev)
    logos = make_logos(H, W, LOGO_H, LOGO_W, LOGO_X, LOGO_Y)
    fmt = VideoFormat(width=W, height=H, frame_rate_num=30000,
                      frame_rate_denom=1001)
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
        s = summary(res)
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
            modes = [m for m, _ in s["decisions"]]
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
    from amatsukaze_tpu_torch.types import VideoFormat

    h, w, lh, lw, lx, ly = 96, 128, 16, 24, 96, 8
    clip = make_clip(30, 15, h, w, lh, lw, lx, ly, seed=3, device="cpu")
    logos = make_logos(h, w, lh, lw, lx, ly)
    fmt = VideoFormat(width=w, height=h, frame_rate_num=30000,
                      frame_rate_denom=1001)
    for mode in ("kfm_vfr", "yadif"):
        a, sa, _ = run_stage(clip, fmt, logos, mode, torch.device("cpu"), 8)
        b, sb, _ = run_stage(clip, fmt, logos, mode, dev, 8)
        same_result(a, b, sa, sb, f"small {mode} cpu vs card")
    log("small clip: card == CPU (kfm_vfr, yadif)")


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
    kernels = [dict(name=n, route="cuda", source=kern + src, replaces=rep,
                    launches=launches, max_abs_err=c["max_abs_err"],
                    ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                    bound_by=c["bound_by"], library_ms=None)
               for n, src, rep, launches, c in rows]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
