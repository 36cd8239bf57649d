#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's filter core on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build both CUDA kernels from ops/csrc (one nvcc per source, started
   together) and print the ptxas register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (and the yadif/field-match kernel also at a width
   that is no multiple of 16 and on misaligned, row-strided views; the
   logo kernel through its float32 and its uint8 entry at 2 and 11 fades,
   on a 50x70 window, a batch of 1 and an empty mask, every masked
   pixel's value bit-equal to the plain version on the CPU, two runs
   bit-identical), and time both beside the bound: CUDA events, the median of several repeats
   with min and max, once on one buffer (warm: whatever fits stays in L2)
   and once rotating over buffers that together exceed the 50 MB L2 (cold:
   what a caller sees that has just uploaded the batch);
3. the main path: a synthetic 1440x1080i clip of 200 frames (160 of 3:2
   telecined film, then 40 of interlaced video, a rendered 96x256 logo)
   through pipeline.filter_stage.run_filter_stage in kfm_vfr mode, batch 32,
   Y/U/V, with every kernel launch counter set to 0 just before and read
   just after; the same stage with the plain versions patched in must give
   the same logo, fade curve, cycle decisions, VFR plan and frames. Then
   the yadif mode over the same clip, the same way;
4. one more kfm_vfr run under torch.profiler, over the main clip's last
   PROFILE_FRAMES frames: the device busy share and the kernels that take
   the device time; then the logo scan pass alone:
   nothing runs on the device but the copies and one logo_eval launch per
   batch and logo;
5. the same stage on a small clip on the CPU and on the card: identical;
6. the stage over the two seeded clips of utils/synth_clip.py (96x128 and
   1440x1080, 45 frames) on the card against the results recorded from the
   JAX package on the CPU (testdata/golden_stage.json, written by
   tests/test_torch_golden.py): logo, decisions, plan and every frame
   digest exact, the fade curve within 1e-5;
7. "cm pass": the CM analysis over the seeded 1440x1080 broadcast layout of
   utils/synth_clip.py (1340 frames: program, a 15 s CM, program; batch 32,
   11 fades, two candidate logos). scene_metrics_batch on the card
   bit-equal to the CPU on three batches with their carries, and its device
   time; pipeline.cm_stage.run_cm_analysis with the counts set to 0 just
   before and read just after (two logo_eval launches per batch, nothing
   else), which must find the layout's truth exactly (scene changes at the
   cuts, two silence spans, the logo, trims [0, 450, 900, 1340], one CM
   zone), run under torch.profiler (busy share); the 96x128
   layout against testdata/golden_cm.json (written by
   tests/test_torch_cm_stage.py); run_filter_stage(cm=...) in kfm_vfr over
   the 1440x1080 layout with the frame spill usable and forced off: out
   zones, timecode text and every frame digest equal;
8. "post chain": deband's threefry selection field on the card bit-equal to
   the CPU; each post op (deblock, temporal NR, deband, edge level, the
   Lanczos3 resize, svp's mc_frame_interp: bit-equal; the motion-adaptive
   bob: within 1e-3) on the card against the port's CPU version on 4
   frames, and its time per 32x1080x1440 batch beside its bytes bound;
   five configurations through run_filter_stage at
   full width, the counts set to 0 just before each and read just after
   (yadif + deblock,nr,deband,edge + resize to 1280x720 and kfm_vfr +
   deblock,nr with seeded QP maps, yadif60 with both parities of the
   kernel, qtgmc + nr, all over 96 frames of the main clip with its logo;
   a 3840x2160 10-bit clip in mode none + nr,deband,edge, uint16 out):
   frames out, launches, seconds per pass, frames/s without the sink's
   hashing, peak device memory; one yadif + chain run over 40 frames under
   the profiler;
   the configurations of utils/golden.py over the 96x128 clip (svp and
   svp + nr among them) against testdata/golden_post.npz (written by
   tests/test_torch_post_chain.py) and bit-equal to the CPU. Kernel A's
   checks in phase 2 include the bottom parity (bit-equal, the rotation
   identity, its timings);
9. "svp, autovfr, logo generation": K3 at logo generation's shapes (64
   windows of 128x290 and of 128x291, 20 fades; both entries, both places
   of its values) against its plain version, scores and every window's
   best fade; svp over the main clip (frames out, rate, frames/s; the
   first two batches' luma bit-equal to the CPU); autovfr over the
   1440x1080 broadcast layout, the analysis at parallel 1 and the whole
   stage at parallel 2 (decisions equal to each other and to kfm_vfr's
   single stream, .def and logs, one costs launch per section batch from
   two threads, frames/s); LogoAnalyzer over the 1440x1080 logo scan clip
   (over 1000 frames kept, K3 at 20 fades, A and B against the truth,
   seconds per pass); the 96x128 records of autovfr and logo generation
   (testdata/golden_autovfr.json, golden_logo.npz);
10. "mesh": run_filter_stage over the main clip in kfm_vfr and yadif with
   filter_devices = four logical shards of the card (parallel/mesh.py):
   logo, decisions, plan and every frame digest equal to phase 3's
   one-device runs, exactly one K2 launch per shard and analysis batch and
   one K1 launch per shard, plane and output chunk, seconds per pass beside
   the one-device run; one kfm_vfr batch on make_mesh() (every visible
   card); sharded_pipeline_step and sharded_hbd_chain at 32x1080x1440 on
   the four shards against one shard; the 96x128 clip on four shards in
   kfm_vfr, yadif, yadif60, qtgmc and none + nr,deband, the card bit-equal
   to the CPU mesh;
11. "ts front end": utils/synth_ts.py writes a 96-frame 1440x1080i MPEG-2
   TS (intra pictures of a short broadcast layout with the logo, ADTS
   AAC-LC stereo silent around its two cuts); pipeline.splitter.AMTSplitter
   splits it on the native TS engine into the intermediate PS, the wave
   file and the stream reform (frames, PTS order and filter-source frames
   as written); decode_mpeg2_ps_file decodes the PS on the native MPEG-2
   engine (the pure-Python decoder raises if anything reaches it), every
   frame's digest the writer's reconstruction's; the native AAC decoder's
   PCM equals the oracle's on 24 frames, the wave file's PCM the decode of
   the stream; run_cm_analysis fed by the decoder and that PCM, and
   run_filter_stage(cm=...) in kfm_vfr and in yadif + deblock with
   QpMapSource.from_file(<the PS>), the counts set to 0 just before each
   and read just after, equal the same passes fed the reconstruction (and
   the writer's quantiser scales) from host RAM. native/ builds on a
   thread from the start (it needs g++);
12. "transcode": amatsukaze_tpu_torch.cli.main (`python -m
   amatsukaze_tpu_torch.cli --mode ts` in this process, so that the launch
   counts can be read) over the same TS with its two logos as .lgd files,
   a fake encoder that copies its y4m stdin to -o, and the native MPEG-2
   decoder: kfm_vfr, yadif + deblock, and --mode cm, the counts set to 0
   just before each and read just after. Every output frame's digest
   equals the ts phase's stage run of the same mode, the trims and the
   chosen logo equal its CM pass's; K3 runs in each CM pass, K2 in
   kfm_vfr, K1 in yadif; the mux route is logged;
13. "h264/h265": utils/synth_ts.py writes the ts phase's reconstruction
   again as an H.264 TS and as an HEVC TS (lossless PCM pictures: every
   macroblock I_PCM, every CU 16x16 IPCM; the same AAC frames, PTS, PCR
   and PIDs). Each is split on the native TS engine (MB/s; the reform's
   video format equal to the MPEG-2 TS's but for the codec), decoded on
   the native engine (decode_h264_ps_file, which crops the 1088 coded
   lines to the SPS's 1080, and decode_h265_ps_file; frames/s), every
   frame's digest the reconstruction's; the port's pure-Python decoder
   (what _open_h264_inbuild / _open_h265_inbuild return with the native
   engine reported unavailable) decodes the first ORACLE_FRAMES pictures
   at 1440x1080 to the native engine's frames (seconds per picture); then
   cli.main in kfm_vfr with the two logos, the fake encoder and
   `--h264decoder native`, the counts set to 0 just before and read just
   after: every output digest, the trims and the logo equal the transcode
   phase's kfm_vfr run over the MPEG-2 TS, K3 launched by its CM pass and
   K2 by its analysis. In this phase and in phases 11, 12 and 14 the
   pure-Python MPEG-2, H.264 and HEVC decoders raise if a decode that the
   native engines should do reaches them;
14. "server": the port's EncodeServer (server/, parallel/scheduler.py) on
   the card with num_parallel 2, the fake encoder and the two logos as
   .lgd files of the TS's service in its logo directory: the same TS
   queued twice, in kfm_vfr by tools/add_task.py's main over TCP and in
   yadif + deblock by the AddQueue RPC, and a ScanLogo RPC over the first
   SCAN_FRAMES frames of the 1440x1080 logo scan clip (the server's
   logo_frame_source hook) while both run, the counts set to 0 just
   before the first job is queued and read once all three are done. Both
   jobs complete with no retry, their output digests and trims equal the
   transcode phase's runs of the mode, the jobs launch K2 3, K1 12 and K3
   12 (the two CLI runs' sum), and the scan is done with an .lgd
   byte-equal to a direct LogoAnalyzer run on the card after the server
   stopped, whose K3 launches are the rest of the count; the jobs' wall
   seconds beside the two CLI runs', each job's phase enter times and
   decoder are logged.

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
N_FILM, N_VIDEO = 160, 40  # 200 frames: 6.7 s of video


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def step_time(name: str):
    """Log the seconds a step of a phase took."""
    t0 = time.perf_counter()
    yield
    log(f"step {name}: {time.perf_counter() - t0:.2f} s")


def sync(dev) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


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


def bound_ms(n_bytes: float, n_ops: float,
             fma: bool = True) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate: the card's peak counts a fused multiply-add as two,
    so a kernel whose contract forbids contraction (`fma=False`: every
    operation rounds on its own) can reach half of it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (FP32_OPS_PER_S if fma else FP32_OPS_PER_S / 2) * 1e3
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
             dict(write_frames=True, with_costs=True),
             dict(write_frames=True, parity_top=False)]
    if erase is not None:
        modes.append(dict(write_frames=True, with_costs=True, erase=erase))
    for kw in modes:
        got = ff.yadif_fieldmatch(x, **kw)
        torch.cuda.synchronize()
        want = ff.yadif_fieldmatch_plain(x, **kw)
        name = ff.mode_name(kw["write_frames"], kw.get("with_costs", False),
                            kw.get("erase"), kw.get("parity_top", True))
        if got[0] is not None and not torch.equal(got[0], want[0]):
            n = (got[0] != want[0]).sum().item()
            raise AssertionError(f"{what} [{name}]: {n} pixels differ")
        if got[1] is not None:
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
            worst = max(worst, (got[1] - want[1]).abs().max().item())
    return worst


def assert_logo_eval(lops, logo_eval, params, raw, fades, what: str) -> float:
    """Both entries of logo_eval against the plain chain on the card
    (rtol/atol 1e-5: the masked sum runs in another order, and PyTorch on
    the card divides by a scalar by multiplying with its reciprocal); every
    masked pixel's value bit-equal to the plain version's on the CPU, where
    each operation rounds as the kernel's does; a second run bit-identical.
    Returns the largest score difference."""
    deint = lops.batched_deint_y(raw.float())
    want = lops.batched_evaluate_logo(params, deint, 255.0, fades)
    m = params.pos.shape[0]
    worst = 0.0
    for name, fn, x in (("float32", logo_eval.evaluate_logo, deint),
                        ("uint8", logo_eval.evaluate_logo_u8, raw)):
        got = fn(params, x, 255.0, fades)
        again = fn(params, x, 255.0, fades)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{what} [{name}]: scores {got.shape}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if not torch.equal(got, again):
            raise AssertionError(f"{what} [{name}]: two runs differ")
        worst = max(worst, (got - want).abs().max().item())
        values = torch.full((*got.shape, m), float("nan"), device=raw.device)
        logo_eval.launch_kernel(params, x, 255.0, fades, values=values)
        torch.cuda.synchronize()
        cpu = lops.LogoEvalParams(**{
            k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in vars(params).items()})
        per_pixel = lops.correlation_values(
            cpu, lops.blend(cpu, deint.cpu(), 255.0, fades.cpu()))
        expect = (per_pixel.flatten(-2)[..., cpu.pos.long()] * (cpu.weight > 0))
        if not torch.equal(values.cpu(), expect):
            n = (values.cpu() != expect).sum().item()
            raise AssertionError(f"{what} [{name}]: {n} of {expect.numel()} "
                                 f"pixel values differ from the plain "
                                 f"version's bits")
    return worst


def check_logo_eval(dev, frames, res: dict) -> None:
    """Kernel B (K3: LogoFrameMatcher.scan_frames), both entries."""
    import dataclasses

    from amatsukaze_tpu_torch.ops import logo as lops
    from amatsukaze_tpu_torch.ops import logo_eval
    from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef
    from amatsukaze_tpu_torch.utils.synth_clip import logo_alpha

    def logo_params(h, w):
        a = logo_alpha(h, w)
        ref = LogoEvalRef((1.0 / (1.0 - a)).astype(np.float32),
                          (-a * 200.0 / (1.0 - a) / 255.0).astype(np.float32))
        return lops.LogoEvalParams.from_ref(ref, dev)

    params = logo_params(LOGO_H, LOGO_W)
    raw = frames(BATCH, LOGO_H, LOGO_W)
    odd = logo_params(50, 70)
    if odd.n_items % 32 == 0:
        raise AssertionError("the odd window's mask fills whole warps")
    odd_raw = frames(7, 50, 70)
    errs = {}
    for n_fades in (2, 11):
        fades = torch.linspace(0, 1, n_fades, device=dev)
        errs[n_fades] = assert_logo_eval(lops, logo_eval, params, raw, fades,
                                         f"logo_eval F={n_fades}")
        e1 = assert_logo_eval(lops, logo_eval, params, raw[:1], fades,
                              f"logo_eval batch 1 F={n_fades}")
        e2 = assert_logo_eval(lops, logo_eval, odd, odd_raw, fades,
                              f"logo_eval 7x50x70 F={n_fades}")
        log(f"check logo_eval F={n_fades}: float32 and uint8 entry against "
            f"the plain chain at {BATCH}x{LOGO_H}x{LOGO_W} (max abs err "
            f"{errs[n_fades]:.3g}), 1x{LOGO_H}x{LOGO_W} ({e1:.3g}) and "
            f"7x50x70 with {odd.n_items} masked pixels ({e2:.3g}), rtol/atol "
            f"1e-5; every masked pixel's value bit-equal to the plain "
            f"version on the CPU; two runs bit-identical")
    # a logo with nothing masked: score 0 and no launch
    h, w = 20, 36
    z = np.zeros((h, w), np.float32)
    empty = lops.LogoEvalParams.from_numpy(
        dict(a_y=z + 1.0, b_y=z, mask=z, kernels=np.zeros((h, w, 25)),
             scale=np.zeros((h, w, 32)), scale2=np.zeros((h, w, 32)),
             black_score=1.0), dev)
    got = logo_eval.evaluate_logo_u8(empty, frames(3, h, w), 255.0,
                                     torch.linspace(0, 1, 2, device=dev))
    torch.cuda.synchronize()
    if got.shape != (3, 2) or got.abs().max().item() != 0.0:
        raise AssertionError(f"empty mask: scores {got}")
    log("check logo_eval with an empty mask: scores 0")

    # timings. One set of operands is what one call reads: 0.9 MB of
    # compacted tables, A, B and the batch of windows (0.8 MB raw); 64 sets
    # exceed the L2 twice over
    near = torch.nn.functional.max_pool2d(params.mask[None, None], 5, 1, 2)
    n_near = int(near.sum().item())  # pixels that are a tap of a masked one
    n_mask = params.n_items
    hw = LOGO_H * LOGO_W
    compact = ("pos", "weight", "kernels_c", "scale_c", "scale2_c", "a_y",
               "b_y")
    sets = []
    for _ in range(64):
        ps = dataclasses.replace(
            params, **{k: getattr(params, k).clone() for k in compact})
        r = frames(BATCH, LOGO_H, LOGO_W)
        sets.append((ps, r, lops.batched_deint_y(r.float())))
    for n_fades in (2, 11):
        fades = torch.linspace(0, 1, n_fades, device=dev)
        entries = {
            "f32": lambda s: lambda: logo_eval.evaluate_logo(
                s[0], s[2], 255.0, fades),
            "u8": lambda s: lambda: logo_eval.evaluate_logo_u8(
                s[0], s[1], 255.0, fades),
            # what the uint8 entry replaces: widen, DeintY, score
            "chain": lambda s: lambda: logo_eval.evaluate_logo(
                s[0], lops.batched_deint_y(s[1].float()), 255.0, fades),
        }
        # the chain is ten launches a call: fewer calls per window, so that
        # the host still enqueues a window while the card spins
        t = {k: time_warm_cold(fn, sets, 10 if k == "chain" else 50)
             for k, fn in entries.items()}
        plain = time_ms(lambda i: lops.batched_deint_evaluate_logo(
            params, raw, 255.0, fades), 3, repeats=3)
        # the least any implementation must do: move the windows as the
        # caller holds them, A, B, the masked pixels' tables and the scores
        # once; blend the pixels that are taps (3 operations per frame for
        # the background, 3 per frame and fade) and score the masked ones
        # (106 per frame and fade), none contracted into an FMA
        n_ops = BATCH * (3 * n_near + n_fades * (3 * n_near + 106 * n_mask))
        shared_bytes = 4 * (2 * hw + 91 * n_mask + n_fades + BATCH * n_fades)
        for key, px_bytes in (("f32", 4), ("u8", 1)):
            warm, cold = t[key]
            n_bytes = BATCH * hw * px_bytes + shared_bytes
            bounds = dict(
                bound_bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                bound_operations_ms=n_ops / (FP32_OPS_PER_S / 2) * 1e3)
            name = f"logo_eval_{key}_f{n_fades}"
            res[name] = row([BATCH, n_fades, LOGO_H, LOGO_W], warm, plain,
                            bound_ms(n_bytes, n_ops, fma=False),
                            errs[n_fades], cold_ms=cold["ms"],
                            cold_min=cold["min"], cold_max=cold["max"],
                            **bounds)
            r = res[name]
            log(f"time {name}: warm {warm} ms, cold {cold} ms; plain chain "
                f"{plain['ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: bytes {r['bound_bytes_ms']:.4f}, "
                f"operations without FMA {r['bound_operations_ms']:.4f}; "
                f"{n_mask} masked pixels, {n_near} tap pixels)")
        warm, cold = t["chain"]
        res[f"logo_eval_u8_f{n_fades}"].update(
            unfused_chain_ms=warm["ms"], unfused_chain_cold_ms=cold["ms"])
        log(f"time unfused chain F={n_fades} (float, batched_deint_y, "
            f"float32 entry): warm {warm} ms, cold {cold} ms; uint8 entry / "
            f"float32 entry = {t['u8'][0]['ms'] / t['f32'][0]['ms']:.3f} warm")


def check_kernels(dev) -> dict:
    from amatsukaze_tpu_torch.ops import fused_filter as ff
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
    assert_kernel_a(ff, luma[0][:1], "luma 1x1080x1440")
    assert_kernel_a(ff, chroma[0][:1], "chroma 1x540x720")
    log(f"check kernel A at 34x1080x1440, 34x540x720, 33x1080x1440, "
        f"32x1080x1440 with the {LOGO_H}x{LOGO_W} box and at a batch of 1: "
        f"frames bit-equal, costs equal (max abs diff {cost_err:.3g}) in "
        f"every mode (yadif with either field kept)")
    # bottom field kept == top field kept on the frames turned by 180
    # degrees, turned back; values in steps of 40 make the direction
    # search tie on most pixels
    for x in (luma[1], chroma[1], frames(5, 38, 352)[:, :, 16:349]):
        ties = (x // 40) * 40
        bottom, _ = ff.yadif_fieldmatch(ties, parity_top=False)
        top, _ = ff.yadif_fieldmatch(torch.flip(ties, (1, 2)).contiguous())
        torch.cuda.synchronize()
        if not torch.equal(bottom, torch.flip(top, (1, 2))):
            raise AssertionError(f"rotation identity fails at "
                                 f"{tuple(x.shape)}")
    log("check kernel A bottom parity: the rotation identity holds bit for "
        "bit at 34x1080x1440, 34x540x720 and a 5x38x333 view")

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
            f"yadif, costs, yadif+costs, yadif+costs+erase and yadif_bottom")

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
        parity = kw.get("parity_top", True)
        _, alone = time_warm_cold(
            lambda x: lambda: ff.launch_kernel(x, out, parts, erase, parity),
            bufs, 20)
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
    timed("yadif_bottom_y", luma, dict(write_frames=True, parity_top=False),
          40)
    timed("yadif_bottom_uv", chroma,
          dict(write_frames=True, parity_top=False), 40)
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

    check_logo_eval(dev, frames, res)
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

class Sink:
    """Counts the output frames, checks their planes and digests them (or
    keeps them, with keep=True)."""

    def __init__(self, shapes, dtype=np.uint8, keep=False):
        from amatsukaze_tpu_torch.utils.golden import frame_digest, post_digests

        self.digest = (frame_digest if dtype == np.uint8
                       else lambda planes: post_digests([planes])[0])
        self.shapes = shapes
        self.dtype = dtype
        self.keep = keep
        self.frames = []
        self.digests = []
        self.seconds = 0.0  # spent here, inside the stage's output pass

    def __call__(self, planes):
        t0 = time.perf_counter()
        if tuple(p.shape for p in planes) != self.shapes:
            raise AssertionError(f"output planes {[p.shape for p in planes]}")
        if any(p.dtype != self.dtype for p in planes):
            raise AssertionError(f"output planes must be {self.dtype}")
        if self.keep:
            self.frames.append(planes)
        else:
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
                              logo.batched_evaluate_logo), \
            mock.patch.object(logo_eval, "evaluate_logo_u8",
                              logo.batched_deint_evaluate_logo):
        yield


STAGE_PASSES = ("filter.logo_match", "filter.analysis", "filter.output")


def pass_seconds(ctx, names=STAGE_PASSES) -> dict:
    """The summed seconds of the spans of ctx's trace called each name."""
    return {n: round(sum(s.seconds for s in ctx.trace.spans
                         if s.name == n), 4) for n in names}


def run_stage(clip, fmt, logos, mode, device, batch=BATCH, keep=False,
              **kw):
    """run_filter_stage over the clip into a Sink: (result, sink, seconds,
    the seconds of each pass)."""
    from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
    from amatsukaze_tpu_torch.utils.context import AMTContext

    h, w = clip[0][0].shape
    ow, oh = kw.get("resize") or (w, h)
    ten_bit = clip[0][0].dtype == np.uint16 and not logos and mode == "none"
    sink = Sink(((oh, ow), (oh // 2, ow // 2), (oh // 2, ow // 2)),
                np.uint16 if ten_bit else np.uint8, keep)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ctx = AMTContext(level="warn")
    t0 = time.perf_counter()
    res = run_filter_stage(ctx, lambda: iter(clip), len(clip), fmt, logos,
                           mode, sink, batch=batch, device=device, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, sink, time.perf_counter() - t0, pass_seconds(ctx)


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
        res, sink, secs, passes = run_stage(clip, fmt, logos, mode, dev)
        counts = read_counts()
        with plain_versions():
            ref, ref_sink, ref_secs, _ = run_stage(clip, fmt, logos, mode,
                                                   dev)
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
                    sink_seconds=sink.seconds, pass_seconds=passes,
                    out_frames=len(sink.digests), launches=counts,
                    record=stage_record(res, sink))
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
            f"passes {passes}, of which the test sink "
            f"{sink.seconds:.3f} s); {len(sink.digests)} frames out; "
            f"launches {counts}"
            + (f"; cycles {info['cycle_modes']}" if mode == "kfm_vfr" else ""))
    return out


# the main clip's last four batches (frames 72-199): 88 frames of film and
# the 40 of interlaced video, with the logo on
PROFILE_FRAMES = 128


def profile_stage(dev, clip, fmt, logos) -> dict:
    """Device busy share and the kernels that take the device time, over
    one kfm_vfr run of the main path's last PROFILE_FRAMES frames
    (torch.profiler, CUPTI; the profiler costs about three times the
    run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs, _ = run_stage(clip[-PROFILE_FRAMES:], fmt, logos,
                                  "kfm_vfr", dev)
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
    log(f"profile kfm_vfr (last {PROFILE_FRAMES} frames): wall {secs:.3f} s, "
        f"device busy {busy_s:.4f} s "
        f"({100 * busy_s / secs:.2f}%)")
    for name, count, ms in out["top"]:
        log(f"profile   {ms:9.3f} ms {count:6d}x  {name}")
    return out


def profile_scan_pass(dev, clip, fmt, logos) -> None:
    """Every device activity of the logo scan pass alone
    (LogoFrameMatcher.scan_frames at 11 fades), by name: one scoring call
    must be the upload, one logo_eval launch per logo and the download,
    with no elementwise, sum or div kernel between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from amatsukaze_tpu_torch.models.logo import LogoFrameMatcher
    from amatsukaze_tpu_torch.utils.context import AMTContext

    matcher = LogoFrameMatcher(AMTContext(level="warn"), logos, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        matcher.scan_frames((planes[0] for planes in clip), fmt.width,
                            fmt.height, fmt.frame_rate, batch=BATCH,
                            fade_steps=11)
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not sum(e.self_device_time_total for e in acts):
        log("profile scan pass: no device time recorded (not measured)")
        return
    for e in sorted(acts, key=lambda e: -e.self_device_time_total):
        log(f"profile scan pass {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")
    others = [e.key for e in acts
              if "logo_eval" not in e.key and "memcpy" not in e.key.lower()]
    if others:
        raise AssertionError(f"the scan pass ran device kernels besides "
                             f"logo_eval and the copies: {others}")
    n_batches = -(-len(clip) // BATCH)
    launches = sum(e.count for e in acts if "logo_eval" in e.key)
    if launches != n_batches * len(logos):
        raise AssertionError(f"scan pass: {launches} logo_eval launches for "
                             f"{n_batches} batches x {len(logos)} logos")


def small_reference(dev) -> None:
    """The stage on a small clip on the CPU (plain versions) and on the
    card (kernels): identical results."""
    from amatsukaze_tpu_torch.utils import synth_clip

    h, w, lh, lw, lx, ly = 96, 128, 16, 24, 96, 8
    clip = make_clip(30, 15, h, w, lh, lw, lx, ly, seed=3, device="cpu")
    logos = synth_clip.make_logos(h, w, lh, lw, lx, ly)
    fmt = synth_clip.video_format(h, w)
    for mode in ("kfm_vfr", "yadif"):
        a, sa, _, _ = run_stage(clip, fmt, logos, mode,
                                torch.device("cpu"), 8)
        b, sb, _, _ = run_stage(clip, fmt, logos, mode, dev, 8)
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
            res, sink, secs, _ = run_stage(clip, fmt, logos, mode, dev,
                                           batch)
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


# ---------------------------------------------------------------------------
# phase 7: the CM analysis pass and the filter stage it feeds
# ---------------------------------------------------------------------------

def broadcast_batches(open_frames, wanted: set, batch=BATCH) -> dict:
    """{batch index: (uint8 [batch, H, W] luma, the frame before it)} of
    the wanted batches, read from one lazy pass over the clip."""
    out = {}
    prev = None
    chunk = []
    for i, planes in enumerate(open_frames()):
        chunk.append(planes[0])
        if len(chunk) == batch:
            k = i // batch
            if k in wanted:
                out[k] = (np.stack(chunk), prev)
            prev = chunk[-1]
            chunk = []
            if len(out) == len(wanted):
                break
    return out


def check_scene_metrics(dev, open_frames) -> dict:
    """scene_metrics_batch on the card against the port on the CPU, on
    batches of the broadcast clip with their carries (the first batch
    carries its own frame 0; batch 14 holds the cut at 450): diffs and
    histograms bit-equal. Then its device time per batch, cold (the inputs
    rotate over three batches, 150 MB, as the caller has just uploaded the
    batch), beside its bytes bound."""
    from amatsukaze_tpu_torch.ops import cm as cm_ops

    got = broadcast_batches(open_frames, {0, 1, 14})
    dev_batches = []
    for k, (frames, prev) in sorted(got.items()):
        cpu = torch.from_numpy(frames)
        carry = cpu[0] if prev is None else torch.from_numpy(prev)
        want = cm_ops.scene_metrics_batch(cpu, carry)
        x = cpu.to(dev)
        card = cm_ops.scene_metrics_batch(x, carry.to(dev))
        for name, a, b in zip(("diffs", "histograms"), card, want):
            if not torch.equal(a.cpu(), b):
                n = (a.cpu() != b).sum().item()
                raise AssertionError(f"scene metrics batch {k}: {n} {name} "
                                     f"differ from the CPU")
        dev_batches.append((x, carry.to(dev)))
    b, h, w = dev_batches[0][0].shape
    t = time_ms(lambda i: cm_ops.scene_metrics_batch(
        *dev_batches[i % len(dev_batches)]), 10)
    n_bytes = b * h * w + h * w + b * (4 + 4 * cm_ops.BINS)
    out = dict(shape=[b, h, w], ms=t["ms"], ms_min=t["min"], ms_max=t["max"],
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    log(f"check scene_metrics_batch on batches 0, 1 and 14 of the broadcast "
        f"clip ({b}x{h}x{w}, with their carries): diffs and histograms "
        f"bit-equal to the CPU; device {t} ms per batch (cold), bytes bound "
        f"{out['bound_ms']:.4f} ms")
    return out


CM_PASSES = ("cm.pass", "cm.silence", "cm.decide")


def run_cm(dev, name: str, out_dir=None):
    """run_cm_analysis over a broadcast clip: (result, seconds, the seconds
    of each step)."""
    from amatsukaze_tpu_torch.pipeline.cm_stage import run_cm_analysis
    from amatsukaze_tpu_torch.utils import synth_clip
    from amatsukaze_tpu_torch.utils.context import AMTContext

    open_frames, n, fmt, logos, pcm = synth_clip.broadcast_clip(name)
    ctx = AMTContext(level="warn")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm = run_cm_analysis(ctx, open_frames, n, fmt, logos, pcm_s16=pcm,
                         batch=BATCH, device=dev, out_dir=out_dir)
    torch.cuda.synchronize()
    return cm, time.perf_counter() - t0, pass_seconds(ctx, CM_PASSES)


def cm_truth(cm, what: str) -> None:
    """The broadcast layout's constructed truth, exactly."""
    from amatsukaze_tpu_torch.utils import synth_clip

    truth = synth_clip.BROADCAST_TRUTH
    r = cm.result
    got = dict(trims=r.trims, cm_zones=[(z.start_frame, z.end_frame)
                                        for z in r.cmzones],
               scene_changes=cm.scene_changes)
    bad = [k for k in truth if got[k] != truth[k]]
    if bad or cm.best_logo != 0:
        raise AssertionError(f"{what}: {bad} {got}, logo {cm.best_logo}")
    cuts = truth["cm_zones"][0]
    if len(cm.silence) != 2 or not all(
            s < c < e for (s, e), c in zip(cm.silence, cuts)):
        raise AssertionError(f"{what}: silence {cm.silence}")


def profiled_cm_pass(dev):
    """One CM pass over the broadcast clip under torch.profiler, the counts
    set to 0 just before and read just after: (result, seconds, the seconds
    of each step, launches, the device busy share and the activities that
    take the device time).
    One pass serves the checks and the profile: the seconds include the
    profiler's cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cm, secs, passes = run_cm(dev, "broadcast")
    counts = read_counts()
    acts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in acts) / 1e6
    if not busy_s:
        log("profile cm pass: no device time recorded (not measured)")
        return cm, secs, passes, counts, dict(wall_seconds=secs,
                                              device_busy_share=None)
    log(f"profile cm pass: wall {secs:.3f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / secs:.2f}%)")
    for e in sorted(acts, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile cm pass {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")
    return cm, secs, passes, counts, dict(wall_seconds=secs,
                                          device_busy_seconds=busy_s,
                                          device_busy_share=busy_s / secs)


def cm_golden(dev) -> None:
    """The 96x128 broadcast clip's CM pass on the card against the results
    recorded from the JAX package (testdata/golden_cm.json)."""
    import tempfile
    from pathlib import Path

    from amatsukaze_tpu_torch.pipeline import cm_stage
    from amatsukaze_tpu_torch.utils import golden

    with tempfile.TemporaryDirectory() as out_dir:
        cm, secs, _ = run_cm(dev, "small", out_dir)
        files = {k: (Path(out_dir) / f).read_text()
                 for k, f in cm_stage.FILES.items()}
    golden.assert_cm_matches(golden.cm_stage_record(cm, files),
                             golden.load_cm()["small"], "golden cm small")
    log(f"golden cm small: 96x128, {cm.num_frames} frames, {secs:.3f} s: "
        f"scene changes, silence, logo, spans, trims, divs, zones, JLS "
        f"elements and the five files exact, fade within {golden.FADE_TOL}")


def cm_filter_stage(dev, cm) -> dict:
    """run_filter_stage(cm=...) in kfm_vfr over the broadcast clip, with the
    frame spill usable and forced off: out zones, timecode text and every
    output frame digest equal."""
    import tempfile
    from pathlib import Path

    from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
    from amatsukaze_tpu_torch.utils import synth_clip
    from amatsukaze_tpu_torch.utils.context import AMTContext

    open_frames, n, fmt, logos, _ = synth_clip.broadcast_clip("broadcast")
    runs = {}
    for label, cap in (("spill", None), ("no spill", 0)):
        sink = Sink(((H, W), (H // 2, W // 2), (H // 2, W // 2)))
        with tempfile.TemporaryDirectory() as d:
            tc = Path(d) / "timecode.txt"
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx = AMTContext(level="warn")
            res = run_filter_stage(ctx, open_frames, n, fmt, logos,
                                   "kfm_vfr", sink, batch=BATCH, device=dev,
                                   cm=cm, analysis_cache_bytes=cap,
                                   timecode_path=str(tc))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            text = tc.read_text() if tc.exists() else ""
        passes = pass_seconds(ctx)
        runs[label] = (res, sink, text, secs, counts, passes)
        log(f"cm filter stage kfm_vfr ({label}): {n} frames in {secs:.3f} s "
            f"= {n / secs:.2f} frames/s; passes {passes}, of which the "
            f"test sink {sink.seconds:.3f} s; {len(sink.digests)} frames out,"
            f" {res.spill_frames} from the spill; zones "
            f"{[(z.start_frame, z.end_frame) for z in res.zones]}; launches "
            f"{counts}")
    (a, sa, ta, _, ca, _), (b, sb, tb, _, _, _) = (runs["spill"],
                                                   runs["no spill"])
    if a.spill_frames != n or b.spill_frames != 0:
        raise AssertionError(f"spill frames {a.spill_frames}, "
                             f"{b.spill_frames}")
    za = [(z.start_frame, z.end_frame) for z in a.zones]
    if (len(za) != 1 or za != [(z.start_frame, z.end_frame) for z in b.zones]
            or not ta or ta != tb or sa.digests != sb.digests):
        raise AssertionError("cm filter stage: the spill changed the result")
    if ca.get("costs", 0) <= 0 or ca.get("logo_eval", 0) != 0:
        raise AssertionError(f"cm filter stage launches {ca}")
    out = {label: dict(seconds=secs, pass_seconds=passes,
                       sink_seconds=sink.seconds)
           for label, (_, sink, _, secs, _, passes) in runs.items()}
    return dict(out, launches=ca, zones=za, out_frames=len(sa.digests))


def cm_phase(dev) -> dict:
    from amatsukaze_tpu_torch.utils import synth_clip

    open_frames = synth_clip.broadcast_clip("broadcast")[0]
    out = {"scene_metrics": check_scene_metrics(dev, open_frames)}
    t0 = time.perf_counter()
    cm, secs, passes, counts, out["profile"] = profiled_cm_pass(dev)
    cm_truth(cm, "cm pass 1440x1080")
    n_batches = -(-cm.num_frames // BATCH)
    if counts.get("logo_eval") != 2 * n_batches or len(counts) != 1:
        raise AssertionError(f"cm pass launches {counts}, {n_batches} "
                             f"batches x 2 logos")
    out.update(frames=cm.num_frames, seconds=secs, fps=cm.num_frames / secs,
               pass_seconds=passes, launches=counts)
    log(f"cm pass 1440x1080 (under the profiler): {cm.num_frames} frames in "
        f"{secs:.3f} s = {out['fps']:.2f} frames/s (pass "
        f"{passes['cm.pass']:.3f} s, silence {passes['cm.silence']:.3f} s, "
        f"decision {passes['cm.decide']:.3f} s); K3 launches "
        f"{counts['logo_eval']};"
        f" scene changes {cm.scene_changes}, silence {cm.silence}, logo "
        f"{cm.best_logo}, spans {cm.logo_spans}, trims {cm.result.trims}, "
        f"zones {[(z.start_frame, z.end_frame) for z in cm.result.cmzones]}"
        f" ({time.perf_counter() - t0:.2f} s with the profile)")
    t0 = time.perf_counter()
    cm_golden(dev)
    out["stage"] = cm_filter_stage(dev, cm)
    log(f"cm phase: golden and filter stage {time.perf_counter() - t0:.2f} s")
    out["result"] = cm  # the autovfr stage of phase 9 erases its logo
    return out


# ---------------------------------------------------------------------------
# phase 8: the post chain, resize, 10-bit and double-rate paths
# ---------------------------------------------------------------------------

POST_FRAMES = 96  # of the main clip, for the 1440x1080 configurations
# the 10-bit configuration (32 frames since the svp, autovfr and logo
# generation phase came: one batch, within the run's time)
UHD_H, UHD_W, UHD_FRAMES = 2160, 3840, 32


def make_uhd_clip_10bit(n, h, w, seed, device) -> list:
    """(Y, U, V) uint16 10-bit planes of a progressive UHD source: smooth
    diagonal gradients (where banding shows) panning slowly, a sharp-edged
    box and mild noise, made on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = []
    for k in range(n):
        planes = []
        for p, (ph, pw) in enumerate(((h, w), (h // 2, w // 2),
                                      (h // 2, w // 2))):
            yy = torch.arange(ph, device=device, dtype=torch.float32)[:, None]
            xx = torch.arange(pw, device=device, dtype=torch.float32)[None]
            sub = 1 if p == 0 else 2
            f = (400.0 + 120.0 * p + 180.0 * (xx + 3.0 * k / sub) / pw
                 + 90.0 * yy / ph + 40.0 * torch.sin(yy / (97.0 / sub)))
            box = ((yy // (240 // sub)) % 2 == 0) & ((xx // (320 // sub)) % 3
                                                     == 1)
            f = torch.where(box, f + 150.0, f)
            f = f + 1.5 * torch.randn(f.shape, generator=gen, device=device)
            planes.append(f.round().clamp(0, 1023).to(torch.int16).cpu()
                          .numpy().view(np.uint16))
        frames.append(tuple(planes))
    return frames


def check_threefry(dev) -> None:
    """deband's per-pixel selection field of two 1080x1440 frames (the
    threefry hash on int64 tensors) on the card against the CPU."""
    from amatsukaze_tpu_torch.ops import denoise, threefry

    keys = threefry.fold_in(threefry.prng_key(0), torch.arange(2))
    for step in range(2):
        halves = threefry.split(keys)
        keys, ksel = halves[:, 0], halves[:, 1]
        cpu = denoise.deband_selection(ksel, H, W)
        card = denoise.deband_selection(ksel.to(dev), H, W)
        if not torch.equal(card.cpu(), cpu):
            n = (card.cpu() != cpu).sum().item()
            raise AssertionError(f"threefry selection step {step}: {n} "
                                 f"values differ from the CPU")
    log(f"check threefry: deband's selection fields of 2x{H}x{W} (both "
        f"sample steps) bit-equal to the CPU")


def post_op_bytes(b, h, w) -> dict:
    """Bytes each op must move at [b, h, w] float32: its inputs read once,
    its output written once."""
    f = 4 * b * h * w
    oh, ow = 720, 1280
    return {"deblock_qp": 2 * f + 4 * b * (-(-h // 16)) * (-(-w // 16)),
            "temporal_nr": 2 * f, "deband": 2 * f, "edge_level": 2 * f,
            "resize_lanczos3": f + 4 * b * oh * ow
            + 4 * (h * oh + w * ow),
            # B + 2 distinct frames in, 2B out
            "motion_adaptive_bob": 4 * (b + 2) * h * w + 2 * f,
            # two frames in per output frame (a and b), one out
            "mc_frame_interp": 3 * f}


def check_post_ops(dev, clip) -> dict:
    """Each post-chain op (and the resize and the motion-adaptive bob) on
    the card against the port's CPU version on 4 frames of the main clip's
    luma: bit-equal, but for the motion-adaptive bob (within 1e-3 in the
    8-bit domain and one code value after rounding). deblock's and the
    resize's sums run in one fixed order of separate operations, and
    edge level's and deblock's emulated FMAs in float64, so the card gives
    the CPU's bits. Then its time on the card per 32x1080x1440 batch (CUDA
    events, median of 3 windows) beside its bytes bound; mc_frame_interp
    (svp) at the time fraction 0.4 between consecutive frames."""
    from amatsukaze_tpu_torch.ops import deint, denoise
    from amatsukaze_tpu_torch.ops.resize import resize_lanczos3
    from amatsukaze_tpu_torch.utils import synth_clip

    luma = torch.from_numpy(np.stack([f[0] for f in clip[100:134]])).float()
    qp = torch.from_numpy(np.stack(synth_clip.qp_maps(34, 11))).float()

    def ops(x, q):
        """name -> (call on frames x [B+2, H, W] 8-bit domain, exact)."""
        mid = x[1:-1]
        return {
            "deblock_qp": (lambda: denoise.deblock_qp(mid, q[1:-1]), True),
            "temporal_nr": (lambda: denoise.temporal_nr(mid * 64.0) / 64.0,
                            True),
            "deband": (lambda: denoise.deband(mid * 64.0, 0) / 64.0, True),
            "edge_level": (lambda: denoise.edge_level(mid * 64.0) / 64.0,
                           True),
            "resize_lanczos3": (lambda: resize_lanczos3(mid, 720, 1280),
                                True),
            "motion_adaptive_bob": (lambda: deint.motion_adaptive_bob(
                x[:-2], mid, x[2:], True), False),
            "mc_frame_interp": (lambda: deint.mc_frame_interp(
                mid, x[2:], 0.4), True),
        }

    small = ops(luma[:6], qp[:6])
    card_small = ops(luma[:6].to(dev), qp[:6].to(dev))
    full = ops(luma.to(dev), qp.to(dev))
    out = {}
    n_bytes = post_op_bytes(BATCH, H, W)
    for name, (fn, exact) in small.items():
        want = fn()
        got = card_small[name][0]().cpu()
        err = (got - want).abs().max().item()
        q = lambda v: torch.floor(v + 0.5).clamp(0, 255)  # noqa: E731
        codes = (q(got) - q(want)).abs().max().item()
        if exact and err != 0.0:
            raise AssertionError(f"{name}: card differs from the CPU by {err}")
        if err > 1e-3 or codes > 1:
            raise AssertionError(f"{name}: card vs CPU max abs err {err}, "
                                 f"{codes} code values")
        t = time_ms(lambda i: full[name][0](), 2, repeats=3)
        bd = n_bytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = dict(shape=[BATCH, H, W], ms=t["ms"], ms_min=t["min"],
                         ms_max=t["max"], bound_ms=bd, bound_by="bytes",
                         max_abs_err=err)
        log(f"post op {name}: card vs CPU on 4x{H}x{W} "
            f"{'bit-equal' if exact else f'max abs err {err:.3g}'}, "
            f"rounded {codes:.0f} code values; {t} ms per {BATCH}x{H}x{W} "
            f"batch, bytes bound {bd:.4f} ms")
    return out


def post_configs(clip, logos, dev):
    """(name, frames, logos, run_filter_stage arguments, what it must
    launch: kernel -> launches per plane and output chunk, or None for at
    least one) of each configuration of the post phase."""
    from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
    from amatsukaze_tpu_torch.utils import golden, synth_clip

    part = clip[:POST_FRAMES]
    qp = QpMapSource.from_maps(synth_clip.qp_maps(POST_FRAMES, golden.QP_SEED))
    uhd = make_uhd_clip_10bit(UHD_FRAMES, UHD_H, UHD_W, 5, dev)
    return [
        ("yadif+deblock,nr,deband,edge+resize", part, logos,
         dict(mode="yadif", post_filter="deblock,nr,deband,edge",
              qp_source=qp, resize=(1280, 720)),
         {"yadif": 1, "logo_eval": None}),
        ("kfm_vfr+deblock,nr", part, logos,
         dict(mode="kfm_vfr", post_filter="deblock,nr", qp_source=qp),
         {"costs": None, "logo_eval": None}),
        ("yadif60", part, logos, dict(mode="yadif60"),
         {"yadif": 1, "yadif_bottom": 1, "logo_eval": None}),
        ("qtgmc+nr", part, logos, dict(mode="qtgmc", post_filter="nr"),
         {"logo_eval": None}),
        ("none+nr,deband,edge 10-bit 3840x2160", uhd, [],
         dict(mode="none", post_filter="nr,deband,edge"), {}),
    ]


def run_post_configs(dev, clip, logos) -> dict:
    """The five configurations through run_filter_stage at full width, the
    counts set to 0 just before each and read just after."""
    from amatsukaze_tpu_torch.pipeline.filter_stage import HEAD_RAMP
    from amatsukaze_tpu_torch.utils import synth_clip

    out = {}
    for name, frames, lg, kw, need in post_configs(clip, logos, dev):
        h, w = frames[0][0].shape
        fmt = synth_clip.video_format(h, w)
        mode = kw.pop("mode")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res, sink, secs, passes = run_stage(frames, fmt, lg, mode, dev,
                                            **kw)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        # the output pass's chunks: the 8-frame head ramp, then batches
        n_chunks = 1 + -(-(len(frames) - HEAD_RAMP) // BATCH)
        for k, per in need.items():
            want = 3 * n_chunks if per is not None else 1
            if counts.get(k, 0) < want or (per is not None
                                           and counts[k] != want):
                raise AssertionError(f"{name}: launches {counts}, {k} "
                                     f"should be {want}")
        if len(sink.digests) != res.spec.num_out_frames:
            raise AssertionError(f"{name}: {len(sink.digests)} frames out, "
                                 f"spec {res.spec.num_out_frames}")
        if mode in ("yadif60", "qtgmc") and len(sink.digests) != 2 * len(
                frames):
            raise AssertionError(f"{name}: {len(sink.digests)} frames out")
        info = dict(frames=len(frames), out_frames=len(sink.digests),
                    seconds=secs, pass_seconds=passes,
                    fps_without_sink=len(frames) / (secs - sink.seconds),
                    sink_seconds=sink.seconds, peak_bytes=peak,
                    launches=counts)
        out[name] = info
        log(f"post config {name}: {len(frames)} frames {w}x{h} -> "
            f"{len(sink.digests)} frames {sink.shapes[0][1]}x"
            f"{sink.shapes[0][0]} {np.dtype(sink.dtype).name}; {secs:.3f} s "
            f"(passes {passes}); {info['fps_without_sink']:.2f} "
            f"frames/s without the sink's hashing ({sink.seconds:.3f} s); "
            f"peak device memory {peak / 2**30:.2f} GiB; launches {counts}")
    return out


PROFILE_POST_FRAMES = 40  # the head ramp and one whole batch


def profile_post(dev, clip, logos) -> dict:
    """Device busy share of one yadif + chain + resize run over the first
    PROFILE_POST_FRAMES frames of the main clip (processing the profile
    costs about ten times the run: deband launches thousands of kernels a
    batch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
    from amatsukaze_tpu_torch.utils import golden, synth_clip

    qp = QpMapSource.from_maps(synth_clip.qp_maps(PROFILE_POST_FRAMES,
                                                  golden.QP_SEED))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs, _ = run_stage(clip[:PROFILE_POST_FRAMES],
                                  synth_clip.video_format(H, W), logos,
                                  "yadif", dev,
                                  post_filter="deblock,nr,deband,edge",
                                  qp_source=qp, resize=(1280, 720))
    acts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in acts) / 1e6
    if not busy_s:
        log("profile post chain: no device time recorded (not measured)")
        return dict(wall_seconds=secs, device_busy_share=None)
    log(f"profile yadif+chain+resize ({PROFILE_POST_FRAMES} frames): wall "
        f"{secs:.3f} s, device busy "
        f"{busy_s:.4f} s ({100 * busy_s / secs:.2f}%)")
    for e in sorted(acts, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile post {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:90]}")
    return dict(wall_seconds=secs, device_busy_seconds=busy_s,
                device_busy_share=busy_s / secs)


def post_golden(dev) -> None:
    """The configurations of utils.golden.POST_CONFIGS over the recorded
    96x128 clip on the card: against the JAX package's frames
    (testdata/golden_post.npz) by the rules of utils.golden (the count of
    samples one code value apart is printed), and bit-equal to the port on
    the CPU (every op of these paths is a fixed sequence of separate
    operations)."""
    from amatsukaze_tpu_torch.utils import golden, synth_clip

    recorded = golden.load_post()
    frames, _, logos, _ = synth_clip.golden_clip(golden.POST_CLIP)
    for name, cfg in golden.POST_CONFIGS.items():
        f, lg, kw = golden.post_stage_inputs(name, frames, logos)
        mode = kw.pop("mode")
        fmt = synth_clip.video_format(*f[0][0].shape)
        runs = []
        for where in (dev, torch.device("cpu")):
            reset_counts()
            _, sink, secs, _ = run_stage(f, fmt, lg, mode, where,
                                         golden.POST_BATCH, keep=True, **kw)
            runs.append((sink.frames, secs, read_counts()))
        (card, secs, counts), (cpu, _, _) = runs
        vs_jax = golden.assert_post_record(card, recorded[name], name)
        if golden.post_digests(card) != golden.post_digests(cpu):
            n = golden.assert_post_matches(
                golden.stack_planes(card), golden.stack_planes(cpu),
                f"{name} card vs cpu", 1.0)
            raise AssertionError(f"{name}: {n} samples of the card differ "
                                 f"from the CPU")
        log(f"golden post {name}: 96x128, {len(card)} frames out, {secs:.3f}"
            f" s, launches {counts}; bit-equal to the CPU and "
            + ("to the JAX record" if cfg.get("exact") else
               f"{vs_jax} samples one code value from the JAX record"))


def post_phase(dev, clip, logos) -> dict:
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: deblock and resize need float32 "
                             "products")
    out = {}
    with step_time("threefry"):
        check_threefry(dev)
    with step_time("post ops"):
        out["ops"] = check_post_ops(dev, clip)
    with step_time("post configs"):
        out["configs"] = run_post_configs(dev, clip, logos)
    with step_time("post profile"):
        out["profile"] = profile_post(dev, clip, logos)
    with step_time("post golden"):
        post_golden(dev)
    return out


# ---------------------------------------------------------------------------
# phase 9: the svp and autovfr modes and logo generation
# ---------------------------------------------------------------------------

GEN_FADES = 20  # LogoAnalyzer.NUM_FADE
GEN_BATCH = 64  # LogoAnalyzer's batch


def check_logo_eval_generation(dev) -> None:
    """K3 at logo generation's shapes: 64 windows of the 1440x1080 scan
    clip's 128x290 region, and the same widened to 291 columns (an odd
    width), at 20 fades (two fade groups of the kernel's blocks). Both
    entries and both places of the kernel values (registers, shared
    memory), each against the plain version on the card: scores within
    rtol/atol 1e-5 (another order of the masked sum), the best fade
    (argmin of |score|) of every window equal, two runs bit-identical."""
    from amatsukaze_tpu_torch.ops import logo as lops
    from amatsukaze_tpu_torch.ops import logo_eval
    from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef
    from amatsukaze_tpu_torch.utils import synth_clip

    open_frames, _, _, (rx, ry, rw, rh), truth = synth_clip.logo_scan_clip(
        "broadcast")
    ys = []
    for y, _, _ in open_frames():
        ys.append(y[ry:ry + rh, rx:rx + rw + 1])
        if len(ys) == GEN_BATCH:
            break
    fades = torch.from_numpy(np.arange(GEN_FADES, dtype=np.float32)
                             * np.float32(0.1)).to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for width in (rw, rw + 1):
        a = np.ones((rh, width), np.float32)
        b = np.zeros((rh, width), np.float32)
        a[:, :rw], b[:, :rw] = truth["a_y"], truth["b_y"]
        da = lops.batched_deint_logo(torch.from_numpy(a)).numpy()
        db = lops.batched_deint_logo(torch.from_numpy(b)).numpy()
        params = lops.LogoEvalParams.from_ref(LogoEvalRef(da, db, 0.1), dev)
        raw = torch.from_numpy(np.ascontiguousarray(
            np.stack(ys)[:, :, :width])).to(dev)
        deint = lops.batched_deint_y(raw.float())
        want = lops.batched_evaluate_logo(params, deint, 255.0, fades)
        best = want.abs().argmin(dim=1)
        m = params.pos.shape[0]
        blocks = GEN_BATCH * m * -(-GEN_FADES // logo_eval.FADES_PER_BLOCK)
        default_regs = blocks <= logo_eval.THREADS_PER_SM_IN_REGISTERS * n_sm
        worst = 0.0
        for in_regs in (True, False):
            for name, x in (("float32", deint), ("uint8", raw)):
                got = logo_eval.launch_kernel(params, x, 255.0, fades,
                                              kernels_in_registers=in_regs)
                again = logo_eval.launch_kernel(params, x, 255.0, fades,
                                                kernels_in_registers=in_regs)
                torch.cuda.synchronize()
                what = (f"logo_eval {GEN_BATCH}x{GEN_FADES}x{rh}x{width} "
                        f"{name}, values in "
                        f"{'registers' if in_regs else 'shared memory'}")
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two runs differ")
                if not torch.equal(got.abs().argmin(dim=1), best):
                    raise AssertionError(f"{what}: another best fade")
                worst = max(worst, (got - want).abs().max().item())
        if width == rw:  # the analyzer's shape: time it
            time_logo_eval_generation(params, raw, fades)
        log(f"check logo_eval at {GEN_BATCH}x{GEN_FADES} fades x {rh}x"
            f"{width} ({params.n_items} masked pixels, {m // params.chunk} "
            f"chunks; the wrapper picks the values in "
            f"{'registers' if default_regs else 'shared memory'}): both "
            f"entries and both places against the plain version, max abs err"
            f" {worst:.3g}, every window's best fade equal "
            f"({int((best > 8).sum())} above 8), two runs bit-identical")


def time_logo_eval_generation(params, raw, fades) -> dict:
    """K3's uint8 entry at logo generation's shape (warm: the analyzer
    uploads a 2.4 MB batch of crops), its plain version, and the bound as
    check_logo_eval counts it."""
    from amatsukaze_tpu_torch.ops import logo as lops
    from amatsukaze_tpu_torch.ops import logo_eval

    b, h, w = raw.shape
    n_fades = fades.shape[0]
    t = time_ms(lambda i: logo_eval.evaluate_logo_u8(params, raw, 255.0,
                                                     fades), 50)
    plain = time_ms(lambda i: lops.batched_deint_evaluate_logo(
        params, raw, 255.0, fades), 3, repeats=3)
    near = torch.nn.functional.max_pool2d(params.mask[None, None], 5, 1, 2)
    n_near = int(near.sum().item())
    n_mask = params.n_items
    n_ops = b * (3 * n_near + n_fades * (3 * n_near + 106 * n_mask))
    n_bytes = b * h * w + 4 * (2 * h * w + 91 * n_mask + n_fades
                               + b * n_fades)
    bd, by = bound_ms(n_bytes, n_ops, fma=False)
    log(f"time logo_eval_u8 at {b}x{n_fades}x{h}x{w}: {t} ms warm; plain "
        f"{plain['ms']:.3f} ms; bound {bd:.4f} ms ({by})")
    return dict(ms=t["ms"], plain_ms=plain["ms"], bound_ms=bd, bound_by=by)


def svp_path(dev, clip, fmt, logos) -> dict:
    """run_filter_stage in mode svp over the main clip, the counts set to 0
    just before and read just after: (n_film * 5 + 1) // 2 frames out at
    60000/1001; then the svp synthesis of the first two batches' luma (of
    16 frames, so that the CPU's share stays short) on the card and on the
    CPU with the same plan: bit-equal."""
    from amatsukaze_tpu_torch.models.filter_graph import FilterGraph
    from amatsukaze_tpu_torch.utils.context import AMTContext

    reset_counts()
    res, sink, secs, passes = run_stage(clip, fmt, logos, "svp", dev)
    counts = read_counts()
    n_film = len(res.graph.vfr_plan.durations)
    want = (n_film * 5 + 1) // 2
    if not len(sink.digests) == res.spec.num_out_frames == want:
        raise AssertionError(f"svp: {len(sink.digests)} frames out, spec "
                             f"{res.spec.num_out_frames}, want {want}")
    rate = (res.spec.out_format.frame_rate_num,
            res.spec.out_format.frame_rate_denom)
    if rate != (60000, 1001) or res.spec.time_codes:
        raise AssertionError(f"svp: output rate {rate}")
    if counts.get("costs", 0) <= 0 or counts.get("logo_eval", 0) <= 0:
        raise AssertionError(f"svp: launches {counts}")
    outs = []
    t0 = time.perf_counter()
    for where in (dev, torch.device("cpu")):
        fg = FilterGraph(AMTContext(level="warn"), mode="svp", batch=BATCH,
                         device=where)
        fg.decisions, fg.vfr_plan = res.graph.decisions, res.graph.vfr_plan
        got, prev = [], None
        for s0 in (0, BATCH // 2):
            chunk = np.stack([f[0] for f in clip[s0:s0 + BATCH // 2]])
            got.append(fg.run_kfm_batch(chunk, prev, s0, plane=0)
                       .materialize())
            prev = chunk[-1]
        outs.append(np.concatenate(got))
    if not np.array_equal(outs[0], outs[1]):
        n = int((outs[0] != outs[1]).sum())
        raise AssertionError(f"svp: {n} samples of the card differ from the "
                             f"CPU")
    info = dict(frames=len(clip), film_frames=n_film,
                out_frames=len(sink.digests), seconds=secs,
                pass_seconds=passes, fps=len(clip) / secs,
                fps_without_sink=len(clip) / (secs - sink.seconds),
                sink_seconds=sink.seconds, launches=counts)
    log(f"svp: {len(clip)} frames ({n_film} film frames) -> "
        f"{len(sink.digests)} frames at 60000/1001 in {secs:.3f} s = "
        f"{info['fps']:.2f} source frames/s ({info['fps_without_sink']:.2f} "
        f"without the sink's {sink.seconds:.3f} s; passes {passes}); "
        f"launches {counts}; the first two batches' luma ("
        f"{len(outs[0])} frames) bit-equal to the CPU "
        f"({time.perf_counter() - t0:.2f} s)")
    return info


def autovfr_path(dev, cm) -> dict:
    """The 1340-frame 1440x1080 broadcast layout in mode autovfr: its frames
    decoded once into host RAM, so that a section seeks as a real decoder
    does. The sectioned analysis alone at parallel 1, then the whole stage
    at parallel 2 (the JAX package's default; the CM pass's logo erased on
    output), each with the counts set to 0 just before and read just
    after: cycle decisions equal to each other and to kfm_vfr's
    single-stream analysis of the same frames, the .def files equal, one
    log per section, exactly one costs launch per batch of every section
    (two threads count into one counter)."""
    import tempfile
    from pathlib import Path

    from amatsukaze_tpu_torch.models.filter_graph import FilterGraph
    from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
    from amatsukaze_tpu_torch.utils import synth_clip
    from amatsukaze_tpu_torch.utils.context import AMTContext

    open_frames, n, fmt, logos, _ = synth_clip.broadcast_clip("broadcast")
    t0 = time.perf_counter()
    frames = list(open_frames())
    made = time.perf_counter() - t0
    luma = [f[0] for f in frames]

    def open_section(start, end):
        return iter(luma[max(0, start):end])

    ref = FilterGraph(AMTContext(level="warn"), mode="kfm_vfr", batch=BATCH,
                      device=dev)
    ref.analyze(iter(luma), n)
    want = [(int(d.mode), d.phase) for d in ref.decisions]
    out = {"made_seconds": made}
    defs = {}
    with tempfile.TemporaryDirectory() as d:
        for par in (1, 2):
            prefix = str(Path(d) / f"p{par}")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if par == 1:
                fg = FilterGraph(AMTContext(level="warn"), mode="autovfr",
                                 batch=BATCH, device=dev)
                fg.analyze_autovfr(open_section, n, parallel=par,
                                   log_prefix=prefix)
                sink, passes = None, None
            else:
                sink = Sink(((H, W), (H // 2, W // 2), (H // 2, W // 2)))
                ctx = AMTContext(level="warn")
                res = run_filter_stage(
                    ctx, lambda: iter(frames), n, fmt,
                    logos, "autovfr", sink, batch=BATCH, device=dev, cm=cm,
                    open_section=open_section, autovfr_parallel=par,
                    autovfr_prefix=prefix)
                fg, passes = res.graph, pass_seconds(ctx)
                if len(sink.digests) != res.spec.num_out_frames or \
                        res.spill_frames:
                    raise AssertionError(f"autovfr: {len(sink.digests)} "
                                         f"frames out, spill "
                                         f"{res.spill_frames}")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            got = [(int(x.mode), x.phase) for x in fg.decisions]
            if got != want:
                raise AssertionError(f"autovfr parallel {par}: decisions "
                                     f"differ from the single stream")
            per = -(-n // par)
            per += (-per) % 5
            sections = [(s0, min(s0 + per, n)) for s0 in range(0, n, per)]
            launches = sum(-(-(e - s0 + (s0 > 0)) // BATCH)
                           for s0, e in sections)
            if counts.get("costs") != launches or any(
                    k not in ("costs", "logo_eval") for k in counts):
                raise AssertionError(f"autovfr parallel {par}: launches "
                                     f"{counts}, want {launches} costs")
            logs = sorted(p.name for p in Path(d).glob(f"p{par}.autovfr*.log"))
            defs[par] = Path(f"{prefix}.autovfr.def").read_text()
            if len(logs) != len(sections):
                raise AssertionError(f"autovfr parallel {par}: logs {logs}")
            info = dict(seconds=secs, fps=n / secs, sections=sections,
                        launches=counts, pass_seconds=passes,
                        sink_seconds=sink.seconds if sink else None,
                        out_frames=len(sink.digests) if sink else None)
            out[f"parallel_{par}"] = info
            what = "the whole stage" if sink else "the analysis"
            log(f"autovfr parallel {par} ({what}): {n} frames in "
                f"{secs:.3f} s = {info['fps']:.2f} frames/s"
                + (f" (passes {passes}, of which the test sink "
                   f"{sink.seconds:.3f} s; {len(sink.digests)} frames out)"
                   if sink else "")
                + f"; sections {sections}, launches {counts}; decisions = "
                f"kfm_vfr's single stream ({len(want)} cycles)")
    if defs[1] != defs[2] or len(defs[1].splitlines()) < 3:
        raise AssertionError("autovfr: the .def files differ")
    log(f"autovfr: frames made in {made:.2f} s; .def equal at parallel 1 "
        f"and 2: {defs[1].splitlines()[1:]}")
    return out


def logo_generation(dev) -> dict:
    """LogoAnalyzer over the 1440x1080 logo scan clip (1280 frames, a
    96x256 logo in a 128x290 region), the counts set to 0 just before and
    read just after: over 1000 frames kept, K3 launched once per 64 kept
    frames in each refinement pass (20 fades) and nothing else, A and B on
    the logo's core within the JAX package's test bounds of the truth;
    seconds per pass."""
    from amatsukaze_tpu_torch.models.logo import LogoAnalyzer, ScanRegion
    from amatsukaze_tpu_torch.utils import synth_clip
    from amatsukaze_tpu_torch.utils.context import AMTContext

    open_frames, n, fmt, region, truth = synth_clip.logo_scan_clip(
        "broadcast")
    ctx = AMTContext(level="warn")
    an = LogoAnalyzer(ctx, ScanRegion(*region), batch=GEN_BATCH, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg = an.scan(open_frames(), fmt.width, fmt.height, name="synth")
    secs = time.perf_counter() - t0
    counts = read_counts()
    kept = len(an.frames_y)
    want = 2 * -(-kept // GEN_BATCH)
    if kept < 1000 or counts != {"logo_eval": want}:
        raise AssertionError(f"logo generation: {kept} frames kept, "
                             f"launches {counts}, want {want}")
    core = truth["alpha"] > 0.15
    err_a = float(np.abs(lg.a_y - truth["a_y"])[core].max())
    err_b = float(np.abs(lg.b_y - truth["b_y"])[core].max())
    if not (err_a < 0.08 and err_b < 0.04):
        raise AssertionError(f"logo generation: A off by {err_a}, B by "
                             f"{err_b}")
    selected = [int((m > 8).sum()) for m in an.min_fades]
    passes = pass_seconds(ctx, ("logo.scan", "logo.refine",
                                "logo.refine_final"))
    out = dict(frames=n, kept=kept, selected=selected, seconds=secs,
               pass_seconds=passes, launches=counts,
               a_err=err_a, b_err=err_b)
    log(f"logo generation: {n} frames {fmt.width}x{fmt.height}, region "
        f"{region}: {kept} "
        f"kept, {selected} selected in the refinements; {secs:.3f} s "
        f"(per pass {passes}); launches {counts}; A within {err_a:.4f} "
        f"and B within {err_b:.4f} of the truth on the logo's core")
    return out


def modes_golden(dev) -> None:
    """The 96x128 records of autovfr (testdata/golden_autovfr.json, at
    parallel 1, 2 and 3) and of logo generation (testdata/golden_logo.npz)
    on the card. svp's are in post_golden."""
    from amatsukaze_tpu_torch.models.filter_graph import FilterGraph
    from amatsukaze_tpu_torch.models.logo import LogoAnalyzer, ScanRegion
    from amatsukaze_tpu_torch.utils import golden, synth_clip
    from amatsukaze_tpu_torch.utils.context import AMTContext

    runs = golden.autovfr_runs(lambda: FilterGraph(
        AMTContext(level="warn"), mode="autovfr",
        batch=golden.AUTOVFR_BATCH, device=dev))
    for par, run in runs.items():
        if run != golden.load_autovfr()[par]:
            raise AssertionError(f"golden autovfr parallel {par}")
    log(f"golden autovfr: 96x128 broadcast layout, parallel "
        f"{golden.AUTOVFR_PARALLEL}: decisions, sections, .def and logs "
        f"equal the JAX record")
    open_frames, n, fmt, region, _ = synth_clip.logo_scan_clip(
        golden.LOGO_CLIP)
    an = LogoAnalyzer(AMTContext(level="warn"), ScanRegion(*region),
                      batch=GEN_BATCH, device=dev)
    an.scan(open_frames(), fmt.width, fmt.height, name="recovered",
            service_id=5)
    moved = golden.assert_logo_matches(golden.logo_record(an),
                                       golden.load_logo(), "golden logo")
    log(f"golden logo: 96x128 scan clip, {len(an.frames_y)} frames kept: "
        f"both refinements keep the recorded frames ({moved} best fades "
        f"moved), A and B within {golden.LOGO_AB_TOL} of the JAX record")


def modes_phase(dev, clip, fmt, logos, cm) -> dict:
    with step_time("logo_eval at generation's shapes"):
        check_logo_eval_generation(dev)
    out = {}
    with step_time("svp"):
        out["svp"] = svp_path(dev, clip, fmt, logos)
    with step_time("autovfr"):
        out["autovfr"] = autovfr_path(dev, cm)
    with step_time("logo generation"):
        out["logo"] = logo_generation(dev)
    with step_time("modes golden"):
        modes_golden(dev)
    return out


# ---------------------------------------------------------------------------
# phase 10: the mesh (FilterGraph.set_mesh, parallel/)
# ---------------------------------------------------------------------------

MESH_SHARDS = 4  # logical shards on the one card


def mesh_stage(dev, clip, fmt, logos, main, mesh) -> dict:
    """run_filter_stage over the main clip in kfm_vfr and yadif with
    filter_devices=mesh (four logical shards on the card), the counts set to
    0 just before each and read just after: logo, decisions, VFR plan and
    every output frame's digest equal to the mode's single-device run of
    the main path; exactly one K2 launch per shard and analysis batch, one
    K1 launch per shard, plane and output chunk, the logo pass's K3
    launches as there."""
    from amatsukaze_tpu_torch.pipeline.filter_stage import HEAD_RAMP
    from amatsukaze_tpu_torch.utils import golden

    n = mesh.size
    out = {}
    for mode in ("kfm_vfr", "yadif"):
        reset_counts()
        res, sink, secs, passes = run_stage(clip, fmt, logos, mode, dev,
                                            filter_devices=mesh)
        counts = read_counts()
        single = main[mode]
        golden.assert_matches(stage_record(res, sink), single["record"],
                              f"mesh {mode} vs one device")
        if mode == "kfm_vfr":
            want = {"costs": n * -(-len(clip) // BATCH)}
        else:
            chunks = 1 + -(-(len(clip) - HEAD_RAMP) // BATCH)
            want = {"yadif": n * 3 * chunks}
        want["logo_eval"] = single["launches"]["logo_eval"]
        if counts != want or res.shards != n:
            raise AssertionError(f"mesh {mode}: launches {counts}, want "
                                 f"{want}; {res.shards} shards")
        out[mode] = dict(seconds=secs, single_seconds=single["seconds"],
                         pass_seconds=passes,
                         single_pass_seconds=single["pass_seconds"],
                         sink_seconds=sink.seconds, launches=counts)
        log(f"mesh {mode}: {len(clip)} frames {fmt.width}x{fmt.height} on "
            f"{n} logical shards of one card in {secs:.3f} s (one device: "
            f"{single['seconds']:.3f} s; passes {passes}, one device "
            f"{single['pass_seconds']}); logo, decisions, plan and "
            f"{len(sink.digests)} frame digests equal to the one-device run;"
            f" launches {counts}")
    return out


def mesh_visible(dev, clip) -> dict:
    """make_mesh() over every visible device: one kfm_vfr batch (analysis
    and synthesis of the main clip's first 64 luma frames) equal to the
    same on one device, one K2 launch per device and batch."""
    from amatsukaze_tpu_torch.models.filter_graph import FilterGraph
    from amatsukaze_tpu_torch.parallel.mesh import make_mesh
    from amatsukaze_tpu_torch.utils.context import AMTContext

    mesh = make_mesh()
    luma = [f[0] for f in clip[:2 * BATCH]]
    runs = []
    for m in (None, mesh):
        fg = FilterGraph(AMTContext(level="warn"), mode="kfm_vfr",
                         batch=2 * BATCH, device=dev)
        if m is not None:
            fg.set_mesh(m)
        reset_counts()
        fg.analyze(iter(luma), len(luma))
        out = fg.run_kfm_batch(np.stack(luma), None, 0, final=True)
        runs.append((fg, out.materialize(), read_counts()))
    (one, a, _), (fg, b, counts) = runs
    if (not np.array_equal(a, b) or one.vfr_plan.source_frames
            != fg.vfr_plan.source_frames
            or counts != {"costs": mesh.size, "logo_eval": 0}):
        raise AssertionError(f"make_mesh(): {mesh} differs from one device "
                             f"(launches {counts})")
    log(f"mesh make_mesh(): {mesh} (torch.cuda.device_count() "
        f"{torch.cuda.device_count()}): one kfm_vfr batch of {len(luma)} "
        f"frames, {len(b)} frames out equal to one device; launches {counts}")
    return {"devices": [str(d) for d in mesh.devices], "launches": counts}


def mesh_steps(dev, clip, mesh) -> dict:
    """sharded_pipeline_step and sharded_hbd_chain over one batch of 32
    frames of 1080x1440 on the logical shards against the same steps on one
    shard (the single-device composition): filtered frames, presence and
    the 10-bit chain equal, the costs (float32 sums, in another order on
    another batch size) within rtol 1e-5, K3's scores within 2.4e-7 (its
    stated tolerance); one K3 launch per shard. The frames are the main
    clip's 16-47 with the top left 96x256 window (where the step reads the
    logo) made a flat, slightly noisy background of a random level, the
    logo composited on every other frame: the presence is then neither 0
    nor 1. Then the backend's deinterlace on the same frames: K1's uint8
    (rounded=True, one launch per shard and parity) equal to the rounded
    float yadif, in yadif and yadif60."""
    from amatsukaze_tpu_torch.ops.logo import LogoEvalParams
    from amatsukaze_tpu_torch.ops.logo_ref import LogoEvalRef
    from amatsukaze_tpu_torch.parallel import mesh as pmesh
    from amatsukaze_tpu_torch.parallel.sharded_filter import (
        ShardedFilterBackend)
    from amatsukaze_tpu_torch.utils import synth_clip

    one = pmesh.make_mesh([dev])
    lg = synth_clip.make_logos(H, W, LOGO_H, LOGO_W, LOGO_X, LOGO_Y)[0]
    params = LogoEvalParams.from_ref(LogoEvalRef(lg.a_y, lg.b_y), dev)
    frames = np.stack([f[0] for f in clip[16:16 + BATCH]])
    rng = np.random.default_rng(7)
    for k in range(BATCH):
        bg = rng.integers(16, 235) + rng.normal(0, 2, (LOGO_H, LOGO_W))
        if k % 2 == 0:  # the inverse of the logo's erase
            bg = (bg - lg.b_y * 255.0) / lg.a_y
        frames[k, :LOGO_H, :LOGO_W] = np.clip(np.round(bg), 0, 255)
    fades = rng.uniform(0, 1, BATCH).astype(np.float32)
    frames_f = frames.astype(np.float32)
    res = {}
    for m in (mesh, one):
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        step = pmesh.sharded_pipeline_step(m, params)(frames_f, fades)
        hbd = pmesh.sharded_hbd_chain(m)(frames, 7)
        sync(dev)
        res[m.size] = (step, hbd, time.perf_counter() - t0, read_counts())
    (sf, ss, sc, sp), sh, secs, counts = res[mesh.size]
    (of, os_, oc, op), oh, one_secs, _ = res[1]
    err = (ss - os_).abs().max().item()
    cost_ok = torch.allclose(sc, oc, rtol=1e-5, atol=1e-4)
    if not (torch.equal(sf, of) and torch.equal(sp, op) and torch.equal(
            sh, oh) and cost_ok and err <= 2.4e-7 and 0 < sp.item() < 1
            and counts == {"logo_eval": mesh.size}):
        raise AssertionError(
            f"mesh steps differ from one shard: filtered "
            f"{torch.equal(sf, of)}, presence {sp.item()} vs {op.item()}, "
            f"hbd {torch.equal(sh, oh)}, costs {cost_ok}, scores {err}; "
            f"launches {counts}")
    log(f"mesh steps: sharded_pipeline_step and sharded_hbd_chain over "
        f"{BATCH}x{H}x{W} on {mesh.size} shards in {secs:.3f} s (one shard "
        f"{one_secs:.3f} s): filtered, presence {sp.item():.4f} and the "
        f"10-bit chain equal, costs within rtol 1e-5 (max rel "
        f"{((sc - oc).abs() / oc.abs().clamp_min(1e-6)).max().item():.3g}),"
        f" scores within {err:.3g}; launches {counts}")
    backend = ShardedFilterBackend(mesh)
    for mode in ("yadif", "yadif60"):
        k1 = backend.deint(mode, frames, None, None, rounded=True)
        plain = backend.deint(mode, frames, None, None)
        if k1.dtype != torch.uint8 or not torch.equal(
                k1, torch.floor(plain + 0.5).clamp(0, 255).to(torch.uint8)):
            raise AssertionError(f"mesh deint {mode}: K1's uint8 differs "
                                 f"from the rounded float yadif")
    log(f"mesh deint: K1's uint8 on {mesh.size} shards equal to the rounded "
        f"float yadif in yadif and yadif60 ({BATCH}x{H}x{W})")
    return {"seconds": secs, "one_shard_seconds": one_secs,
            "score_err": err, "presence": sp.item(), "launches": counts}


MESH_RECORDS = {  # name: (mode, post chain)
    "kfm_vfr": ("kfm_vfr", ""), "yadif": ("yadif", ""),
    "yadif60": ("yadif60", ""), "qtgmc": ("qtgmc", ""),
    "none_nr_deband": ("none", "nr,deband"),
}


def mesh_records(dev, n) -> dict:
    """The recorded 96x128 clip on n logical shards, on the card and on the
    CPU, in the graphs of MESH_RECORDS: frames bit-equal (the CPU mesh is
    the JAX package's mesh at the same n, tests/test_torch_mesh.py)."""
    from amatsukaze_tpu_torch.parallel.mesh import make_mesh
    from amatsukaze_tpu_torch.utils import synth_clip

    frames, fmt, logos, batch = synth_clip.golden_clip("small")
    counts = {}
    for name, (mode, post) in MESH_RECORDS.items():
        outs = []
        for where in (dev, torch.device("cpu")):
            reset_counts()
            _, sink, _, _ = run_stage(frames, fmt, logos, mode, where,
                                      batch, keep=True, post_filter=post,
                                      filter_devices=make_mesh([where] * n))
            outs.append(sink.frames)
            if where == dev:
                counts[name] = read_counts()
        if len(outs[0]) != len(outs[1]) or any(
                not np.array_equal(a, b) for fa, fb in zip(*outs)
                for a, b in zip(fa, fb)):
            raise AssertionError(f"mesh record {name}: card differs from "
                                 f"the CPU mesh")
    log(f"mesh records: 96x128 clip on {n} logical shards, "
        f"{list(MESH_RECORDS)}: card bit-equal to the CPU mesh; launches "
        f"{counts}")
    return counts


def mesh_phase(dev, clip, fmt, logos, main, card: str) -> dict:
    from amatsukaze_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * MESH_SHARDS)
    log(f"mesh: {MESH_SHARDS} logical shards on one card ({card})")
    out = {"stage": mesh_stage(dev, clip, fmt, logos, main, mesh),
           "visible": mesh_visible(dev, clip),
           "steps": mesh_steps(dev, clip, mesh),
           "records": mesh_records(dev, MESH_SHARDS)}
    return out


# ---------------------------------------------------------------------------
# phase 11: the TS front end (stream reform, intermediate PS, AAC, MPEG-2
# decode) feeding the CM pass and the filter stage
# ---------------------------------------------------------------------------

def start_native_build():
    """Build and load native/libamatsukaze_native.so on a thread while the
    kernels build and the earlier phases run; ts_phase joins it."""
    import threading

    from amatsukaze_tpu_torch.ts import native

    box = {}

    def build():
        t0 = time.perf_counter()
        box["lib"] = native.load_native()
        box["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build, daemon=True)
    th.start()
    return th, box


class _NoOracle:
    """Stands in for a pure-Python decoder while a phase decodes: the native
    engine must do it, with no hidden fallback."""

    def __init__(self, *a, **kw):
        raise AssertionError("decode fell back to a pure-Python decoder: "
                             "the native engine did not run")


@contextmanager
def native_decoders_only():
    """The pure-Python MPEG-2, H.264 and HEVC decoders raise if anything
    reaches them (pipeline/decoders.py falls back to them where a native
    engine is unavailable)."""
    import amatsukaze_tpu_torch.video as video
    from amatsukaze_tpu_torch.video import h264_ref, h265_ref

    with mock.patch.object(video, "Mpeg2RefDecoder", _NoOracle), \
            mock.patch.object(h264_ref, "H264RefDecoder", _NoOracle), \
            mock.patch.object(h265_ref, "H265RefDecoder", _NoOracle):
        yield


def ts_write(work: str, name: str) -> dict:
    from amatsukaze_tpu_torch.utils import synth_ts

    path = f"{work}/src.ts"
    ts, fmt, logos = synth_ts.ts_clip(name, path)
    log(f"ts writer: {ts.num_frames} frames {fmt.width}x{fmt.height}i MPEG-2"
        f" intra + {len(ts.audio_frames)} ADTS AAC-LC stereo frames, "
        f"{ts.size / 1e6:.2f} MB in {ts.seconds:.2f} s")
    return dict(ts=ts, fmt=fmt, logos=logos, seconds=ts.seconds,
                mb=ts.size / 1e6)


def ts_split(work: str, ts) -> dict:
    """AMTSplitter.split() with the port's Settings: the intermediate PS, the
    wave file and the StreamReformInfo; the frames, their PTS order and the
    filter-source frames are the writer's."""
    from amatsukaze_tpu_torch.audio.aac_native import NativeAacDecoder
    from amatsukaze_tpu_torch.audio.aac_native import make_decoder
    from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
    from amatsukaze_tpu_torch.pipeline.splitter import AMTSplitter
    from amatsukaze_tpu_torch.utils.context import AMTContext

    if not isinstance(make_decoder(), NativeAacDecoder):
        raise AssertionError("the native AAC decoder did not build")
    conf = Config()
    conf.src_file_path = ts.path
    conf.work_dir = work
    conf.out_video_path = f"{work}/out"
    ctx = AMTContext(level="warn")
    st = Settings(ctx, conf)
    t0 = time.perf_counter()
    sp = AMTSplitter(ctx, st, audio_decoder_factory=make_decoder)
    reform = sp.split()
    reform.prepare(conf.split_sub, False)
    secs = time.perf_counter() - t0
    src = reform.get_filter_source_frames(0)
    if (sp.video_file_count != 1 or len(src) != ts.num_frames
            or [f.frame_pts for f in src] != ts.pts
            or [f.frame_index for f in src] != list(range(ts.num_frames))):
        raise AssertionError(
            f"split: {sp.video_file_count} files, {len(src)} frames against "
            f"the writer's {ts.num_frames}, or their PTS differ")
    if sp._engine is None:
        raise AssertionError("split: the native TS engine did not run")
    log(f"ts split: {ts.size / 1e6:.2f} MB in {secs:.3f} s = "
        f"{ts.size / 1e6 / secs:.1f} MB/s (native TS engine); "
        f"{len(src)} frames in PTS order as written, intermediate PS "
        f"{sp.total_int_video_size / 1e6:.2f} MB, "
        f"{len(reform.get_filter_source_audio_frames(0))} audio frames")
    return dict(st=st, reform=reform, seconds=secs,
                mb_per_s=ts.size / 1e6 / secs,
                ps=st.int_video_file_path(0))


def ts_decode(ps: str, ts) -> dict:
    """decode_mpeg2_ps_file over the intermediate PS on the native engine:
    every frame's digest equals the writer's reconstruction's."""
    from amatsukaze_tpu_torch.pipeline.decoders import decode_mpeg2_ps_file
    from amatsukaze_tpu_torch.utils.golden import frame_digest
    from amatsukaze_tpu_torch.video.native import NativeMpeg2Decoder

    NativeMpeg2Decoder()  # raises where the engine did not build
    t0 = time.perf_counter()
    with native_decoders_only():
        frames = list(decode_mpeg2_ps_file(ps))
    secs = time.perf_counter() - t0
    got = [frame_digest(f) for f in frames]
    want = [frame_digest(f) for f in ts.recon]
    bad = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"decode: {len(got)} frames against "
                             f"{len(want)}, differing {bad[:5]}")
    log(f"ts decode: {len(frames)} frames in {secs:.3f} s = "
        f"{len(frames) / secs:.1f} frames/s on the native MPEG-2 engine; "
        f"every frame digest equals the writer's reconstruction")
    return dict(seconds=secs, fps=len(frames) / secs)


def ts_audio(split: dict, ts) -> dict:
    """The native AAC decoder's PCM equals the pure-Python oracle's on the
    first frames; the wave file's PCM through
    get_filter_source_audio_frames is the native decode of every frame."""
    from amatsukaze_tpu_torch.audio.aac import AacLcDecoder
    from amatsukaze_tpu_torch.audio.aac_native import make_decoder
    from amatsukaze_tpu_torch.pipeline.cm_stage import filter_source_pcm

    n_check = 24
    nat, ref = make_decoder(), AacLcDecoder()
    t0 = time.perf_counter()
    pcm_nat = b"".join(nat.decode(f).pcm for f in ts.audio_frames[:n_check])
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm_ref = b"".join(ref.decode(f).pcm for f in ts.audio_frames[:n_check])
    t_ref = time.perf_counter() - t0
    a = np.frombuffer(pcm_nat, np.int16).astype(np.int32)
    b = np.frombuffer(pcm_ref, np.int16).astype(np.int32)
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(f"audio: native PCM differs from the oracle's "
                             f"(max {np.abs(a - b).max() if a.shape == b.shape else 'shape'})")
    pcm = filter_source_pcm(split["reform"], 0, split["st"].wave_file_path())
    dec = make_decoder()
    whole = b"".join(dec.decode(f).pcm for f in ts.audio_frames)
    if pcm is None or pcm.tobytes() != whole:
        raise AssertionError("audio: the wave file's PCM is not the decode "
                             "of the writer's frames")
    log(f"ts audio: native PCM == oracle PCM on the first {n_check} frames "
        f"(native {t_nat * 1e3:.1f} ms, oracle {t_ref * 1e3:.1f} ms); wave "
        f"file PCM through get_filter_source_audio_frames: "
        f"{pcm.size // 2} stereo samples, the native decode of the stream")
    return dict(pcm=pcm, oracle_frames=n_check)


def ts_cm(dev, ps: str, ts, fmt, logos, pcm) -> dict:
    """run_cm_analysis on the card fed by the native decoder and the wave
    file's PCM, the counts set to 0 just before and read just after; the
    same pass fed the writer's reconstruction from host RAM gives the same
    logo, fade curve, trims, divs, scene changes and silence."""
    from amatsukaze_tpu_torch.pipeline.cm_stage import run_cm_analysis
    from amatsukaze_tpu_torch.pipeline.decoders import decode_mpeg2_ps_file
    from amatsukaze_tpu_torch.utils.context import AMTContext

    n = ts.num_frames
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    with native_decoders_only():
        cm = run_cm_analysis(AMTContext(level="warn"),
                             lambda: decode_mpeg2_ps_file(ps), n, fmt, logos,
                             pcm_s16=pcm, batch=BATCH, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    ref = run_cm_analysis(AMTContext(level="warn"), lambda: iter(ts.recon), n,
                          fmt, logos, pcm_s16=pcm, batch=BATCH, device=dev)

    def key(c):
        r = c.result
        return dict(best=c.best_logo, trims=r.trims, divs=r.divs,
                    zones=[(z.start_frame, z.end_frame) for z in r.cmzones],
                    scene_changes=c.scene_changes, silence=c.silence,
                    spans=c.logo_spans, frames=c.num_frames)

    if key(cm) != key(ref) or not np.array_equal(cm.fade, ref.fade):
        raise AssertionError(f"ts cm pass: {key(cm)} against the host-RAM "
                             f"pass {key(ref)}, or the fade curves differ")
    n_batches = -(-n // BATCH)
    if (cm.best_logo != 0 or not cm.silence or not cm.scene_changes
            or counts.get("logo_eval") != len(logos) * n_batches
            or len(counts) != 1):
        raise AssertionError(f"ts cm pass: logo {cm.best_logo}, silence "
                             f"{cm.silence}, scene changes "
                             f"{cm.scene_changes}, launches {counts}")
    log(f"ts cm pass: {n} frames decoded and analysed in {secs:.3f} s = "
        f"{n / secs:.2f} frames/s; K3 launches {counts['logo_eval']}; "
        f"{key(cm)}; equal to the pass fed the reconstruction from host RAM")
    return dict(result=cm, host_result=ref, seconds=secs, fps=n / secs,
                launches=counts)


def ts_stage(dev, ps: str, ts, fmt, logos, cm, ref_cm) -> dict:
    """run_filter_stage(cm=...) in kfm_vfr, and in yadif + deblock with the
    QP maps read from the intermediate PS, fed by the native decoder: frame
    digests, decisions and plan equal to the same stage fed the writer's
    reconstruction (and, for deblock, the writer's quantiser scales)."""
    from amatsukaze_tpu_torch.pipeline.decoders import decode_mpeg2_ps_file
    from amatsukaze_tpu_torch.pipeline.filter_stage import run_filter_stage
    from amatsukaze_tpu_torch.ts.qp_extract import QpMapSource
    from amatsukaze_tpu_torch.utils.context import AMTContext

    n = ts.num_frames
    h, w = fmt.height, fmt.width
    qp_ps = QpMapSource.from_file(ps)
    if len(qp_ps.results) != n or not all(
            np.array_equal(r.qp, m) for r, m in zip(qp_ps.results,
                                                    ts.qp_maps)):
        raise AssertionError("QP maps read from the PS differ from the "
                             "writer's quantiser scales")
    out = {}
    for mode, post, qp_ref in (("kfm_vfr", "", None),
                               ("yadif", "deblock",
                                QpMapSource.from_maps(ts.qp_maps))):
        runs = {}
        for label in ("ts", "host"):
            sink = Sink(((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            with native_decoders_only():
                res = run_filter_stage(
                    AMTContext(level="warn"),
                    (lambda: decode_mpeg2_ps_file(ps)) if label == "ts"
                    else (lambda: iter(ts.recon)), n, fmt, logos, mode, sink,
                    batch=BATCH, device=dev,
                    cm=cm if label == "ts" else ref_cm, post_filter=post,
                    qp_source=(qp_ps if label == "ts" else qp_ref)
                    if post else None)
            sync(dev)
            runs[label] = (res, sink, time.perf_counter() - t0, read_counts())
        (res, sink, secs, counts), (ref, rsink, _, _) = runs["ts"], \
            runs["host"]
        same_result(res, ref, sink, rsink, f"ts stage {mode}")
        kernel = "costs" if mode == "kfm_vfr" else "yadif"
        if counts.get(kernel, 0) <= 0 or counts.get("logo_eval", 0) != 0:
            raise AssertionError(f"ts stage {mode} launches {counts}")
        name = mode + (f" + {post}" if post else "")
        log(f"ts stage {name}: {n} frames decoded and filtered in "
            f"{secs:.3f} s = {n / secs:.2f} frames/s; {len(sink.digests)} "
            f"frames out; launches {counts}; decisions, plan and every "
            f"digest equal to the stage fed from host RAM")
        out[mode] = dict(seconds=secs, fps=n / secs, launches=counts,
                         out_frames=len(sink.digests), digests=sink.digests)
    return out


def ts_phase(dev, native_build, work: str, name: str = "broadcast") -> dict:
    """The phase over the short broadcast layout of utils/synth_ts.py at one
    of its sizes ("broadcast": 1440x1080i, 96 frames), written to `work`
    (the transcode phase reads the same TS)."""
    th, box = native_build
    t0 = time.perf_counter()
    th.join()
    if box.get("lib") is None:
        raise AssertionError("native/libamatsukaze_native.so did not build "
                             "(the card's host needs g++)")
    log(f"native library: built and loaded in {box['seconds']:.2f} s (on a "
        f"thread since the start; waited {time.perf_counter() - t0:.2f} s)")
    wrote = ts_write(work, name)
    ts, fmt, logos = wrote["ts"], wrote["fmt"], wrote["logos"]
    split = ts_split(work, ts)
    out = {"writer": {k: wrote[k] for k in ("seconds", "mb")},
           "split": {k: split[k] for k in ("seconds", "mb_per_s")},
           "decode": ts_decode(split["ps"], ts)}
    audio = ts_audio(split, ts)
    cm = ts_cm(dev, split["ps"], ts, fmt, logos, audio["pcm"])
    out["cm"] = {k: cm[k] for k in ("seconds", "fps", "launches")}
    out["cm_result"] = cm["result"]
    out["stage"] = ts_stage(dev, split["ps"], ts, fmt, logos,
                            cm["result"], cm["host_result"])
    out.update(ts=ts, logos=logos, clip=name,
               video_format=split["reform"].formats[0].video_format)
    return out


# ---------------------------------------------------------------------------
# phase 12: "transcode": the CLI (pipeline/transcode.py) over the same TS
# ---------------------------------------------------------------------------

# the fake x264: the y4m of its stdin to -o (no encoder on the card's host)
FAKE_ENCODER = """#!/bin/bash
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    *) shift;;
  esac
done
cat > "$out"
"""
TRANSCODE_RUNS = (  # name, CLI arguments, the ts_stage run it equals
    ("kfm_vfr", ["--filter-mode", "kfm_vfr"], "kfm_vfr"),
    ("yadif + deblock", ["--filter-mode", "yadif", "--post-filter",
                         "deblock"], "yadif"),
    ("cm", ["--mode", "cm"], None),
)


def output_digests(report: dict) -> tuple:
    """The digests of every frame of a transcode's outputs (the bare y4m
    streams that the fake encoder wrote) and the first one's y4m header."""
    import os

    from amatsukaze_tpu_torch.io.y4m import Y4MReader
    from amatsukaze_tpu_torch.utils.golden import frame_digest

    digests, header = [], b""
    for out in report["outfiles"]:
        if not os.path.exists(out["path"]):  # --mode cm writes none
            continue
        with open(out["path"], "rb") as f:
            header = f.readline()
            f.seek(0)
            r = Y4MReader(f)
            digests += [frame_digest(p) for p in r.frames()]
    return digests, header


def transcode_run(dev, work: str, name: str, args: list, src: str,
                  lgds: list):
    """`python -m amatsukaze_tpu_torch.cli --mode ts ...` in this process
    (so that the launch counts can be read), the counts set to 0 just
    before and read just after. Returns the report, the output frames'
    digests, the trims file, the counts and the seconds."""
    import glob
    import os

    from amatsukaze_tpu_torch import cli

    run_dir = f"{work}/{name.replace(' + ', '_').replace(' ', '_')}"
    os.makedirs(run_dir)
    argv = ["-i", src, "-o", f"{run_dir}/out", "-w", run_dir, "-e",
            f"{work}/fake_x264", "-j", f"{run_dir}/report.json",
            "--mpeg2decoder", "native", "--no-remove-tmp"]
    for lgd in lgds:
        argv += ["--logo", lgd]
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    with native_decoders_only():
        # on the card as a user runs it; "cpu" only for a rehearsal here
        rc = cli.main(argv + args,
                      device=None if dev.type == "cuda" else "cpu")
    sync(dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"transcode {name}: the CLI returned {rc}")
    with open(f"{run_dir}/report.json") as f:
        report = json.load(f)
    digests, header = output_digests(report)
    (trim,) = glob.glob(f"{run_dir}/amt*/trim0.avs")
    with open(trim) as f:
        trims = f.read()
    return report, digests, header, trims, counts, secs


def transcode_phase(dev, work: str, front: dict) -> dict:
    """The CLI over the ts phase's TS with its logos and the fake encoder:
    kfm_vfr, yadif + deblock, and --mode cm. Every output frame's digest
    equals the ts phase's stage run of the same mode (run_filter_stage fed
    the native decoder and the CM pass), the trims and the chosen logo its
    CM pass's; K3 runs in every CM pass, K2 in kfm_vfr, K1 in yadif."""
    import os

    from amatsukaze_tpu_torch.models.cm_analyze import format_trim_avs
    from amatsukaze_tpu_torch.models.lgd import save_lgd
    from amatsukaze_tpu_torch.video.avdec import avdec_available

    ts, cm = front["ts"], front["cm_result"]
    n = ts.num_frames
    with open(f"{work}/fake_x264", "w") as f:
        f.write(FAKE_ENCODER)
    os.chmod(f"{work}/fake_x264", 0o755)
    lgds = []
    for k, lg in enumerate(front["logos"]):
        lgds.append(f"{work}/logo{k}.lgd")
        save_lgd(lgds[-1], lg)
    want_trims = format_trim_avs(cm.result.trims) + "\n"
    out = {}
    for name, args, stage_mode in TRANSCODE_RUNS:
        report, digests, header, trims, counts, secs = transcode_run(
            dev, work, name, args, ts.path, lgds)
        if (trims != want_trims
                or report["logofiles"] != [lgds[cm.best_logo]]):
            raise AssertionError(
                f"transcode {name}: trims {trims!r}, logo "
                f"{report['logofiles']} against the CM pass's {want_trims!r}"
                f", logo {cm.best_logo}")
        n_batches = -(-n // BATCH)
        if counts.get("logo_eval") != len(lgds) * n_batches:
            raise AssertionError(f"transcode {name}: K3 launches {counts}")
        if stage_mode is None:
            if digests or set(counts) != {"logo_eval"}:
                raise AssertionError(f"transcode {name}: {len(digests)} "
                                     f"frames out, launches {counts}")
        else:
            want = front["stage"][stage_mode]["digests"]
            kernel = "costs" if stage_mode == "kfm_vfr" else "yadif"
            if digests != want or counts.get(kernel, 0) <= 0:
                bad = [k for k, (a, b) in enumerate(zip(digests, want))
                       if a != b]
                raise AssertionError(
                    f"transcode {name}: {len(digests)} frames against the "
                    f"stage's {len(want)}, differing {bad[:5]}; launches "
                    f"{counts}")
            route = ("bare stream (no muxer binary; the in-build remux "
                     f"{'failed' if avdec_available() else 'unavailable'})"
                     if header.startswith(b"YUV4MPEG2") else "in-build remux")
            log(f"transcode {name}: mux route: {route}; y4m header "
                f"{header.decode().strip()}")
        what = ("split and CM pass, no encode" if stage_mode is None else
                f"split, CM pass, filter, y4m to the fake encoder, mux; "
                f"{len(digests)} frames out, every digest equal to the ts "
                f"phase's stage run")
        log(f"transcode {name}: {n} frames through the CLI in {secs:.3f} s "
            f"= {n / secs:.2f} frames/s ({what}); trims and logo the CM "
            f"pass's; launches {counts}")
        out[name] = dict(seconds=secs, fps=n / secs, launches=counts,
                         out_frames=len(digests), digests=digests,
                         trims=trims)
    return out


# ---------------------------------------------------------------------------
# phase 13: "h264/h265": the ts phase's frames as H.264 and HEVC broadcast
# streams, split, decoded on the native engines and by the pure-Python
# oracles, and through the CLI
# ---------------------------------------------------------------------------

ORACLE_FRAMES = 2  # pictures the pure-Python decoders decode at 1440x1080
H26X_CODECS = (  # synth_ts name, decoders.py entry, access unit delimiter
    ("h264", "decode_h264_ps_file", b"\x00\x00\x00\x01\x09"),
    ("h265", "decode_h265_ps_file", b"\x00\x00\x00\x01\x46\x01"),
)


def first_access_units(ps: str, n: int, aud: bytes) -> bytes:
    """The elementary stream of the first n access units of an
    intermediate PS (each starts with an access unit delimiter)."""
    from amatsukaze_tpu_torch.ts.qp_extract import extract_ps_video_es

    with open(ps, "rb") as f:
        es = extract_ps_video_es(f.read((n + 1) * 3_000_000))
    at = -1
    for _ in range(n + 1):
        at = es.find(aud, at + 1)
        if at < 0:
            raise AssertionError(f"fewer than {n + 1} access units in the "
                                 f"first bytes of {ps}")
    return es[:at]


def h26x_oracle(codec: str, ps: str, aud: bytes, native_frames: list,
                recon: list) -> dict:
    """The port's pure-Python decoder over the first ORACLE_FRAMES pictures
    of the intermediate at full width: its frames (cropped by the SPS for
    H.264, as decode_h264_ps_file crops) equal the native engine's and the
    writer's. _open_h26x_inbuild with the native engine reported
    unavailable returns that decoder."""
    from amatsukaze_tpu_torch.pipeline import decoders
    from amatsukaze_tpu_torch.utils.golden import frame_digest
    from amatsukaze_tpu_torch.video import h264_ref, h265_ref
    from amatsukaze_tpu_torch.video import native as native_mod

    es = first_access_units(ps, ORACLE_FRAMES, aud)
    oracle = h264_ref.H264RefDecoder if codec == "h264" \
        else h265_ref.H265RefDecoder
    with mock.patch.object(native_mod, f"{codec}_native_available",
                           lambda: False):
        dec = getattr(decoders, f"_open_{codec}_inbuild")(es)
    if type(dec) is not oracle:
        raise AssertionError(f"{codec}: without the native engine the "
                             f"in-build decoder is {type(dec).__name__}")
    t0 = time.perf_counter()
    frames = dec.decode(es) + dec.flush()
    secs = time.perf_counter() - t0
    crop = decoders.h264_crop(es) if codec == "h264" else None
    got = [frame_digest(decoders.crop_planes(f[:3], crop) if crop else f[:3])
           for f in frames]
    want = [frame_digest(f) for f in native_frames[:ORACLE_FRAMES]]
    if (len(got) != ORACLE_FRAMES or got != want
            or want != [frame_digest(f) for f in recon[:ORACLE_FRAMES]]):
        raise AssertionError(f"{codec} oracle: {len(got)} frames, digests "
                             f"{got} against the native engine's {want}")
    log(f"{codec} oracle: the port's {oracle.__name__} (what "
        f"_open_{codec}_inbuild returns without the native engine) decoded "
        f"the first {ORACLE_FRAMES} pictures at {recon[0][0].shape[1]}x"
        f"{recon[0][0].shape[0]} in {secs:.3f} s = "
        f"{secs / ORACLE_FRAMES:.3f} s per picture; frames equal to the "
        f"native engine's and the writer's")
    return dict(seconds_per_picture=secs / ORACLE_FRAMES)


def h26x_codec(dev, work: str, front: dict, trans: dict, codec: str,
               entry: str, aud: bytes) -> dict:
    """One codec: write, split, native decode, oracle, CLI in kfm_vfr."""
    import dataclasses
    import os

    from amatsukaze_tpu_torch.pipeline import decoders
    from amatsukaze_tpu_torch.utils import synth_ts
    from amatsukaze_tpu_torch.utils.golden import frame_digest

    ts = front["ts"]
    sub = f"{work}/{codec}"
    os.makedirs(sub)
    out = synth_ts.write_ts(f"{sub}/src.ts", iter(ts.recon), ts.num_frames,
                            synth_ts.silent_around_cuts,
                            synth_ts.TS_CLIPS[front["clip"]]["seed"], codec)
    if out.audio_frames != ts.audio_frames or out.pts != ts.pts:
        raise AssertionError(f"{codec} writer: audio or PTS differ from the "
                             f"MPEG-2 TS's")
    log(f"{codec} writer: {out.num_frames} PCM pictures + "
        f"{len(out.audio_frames)} ADTS frames (the MPEG-2 TS's), "
        f"{out.size / 1e6:.2f} MB in {out.seconds:.2f} s")
    split = ts_split(sub, out)
    fmt = split["reform"].formats[0].video_format
    if (dataclasses.replace(fmt, format=front["video_format"].format)
            != front["video_format"]):
        raise AssertionError(f"{codec} split: {fmt} against the MPEG-2 TS's "
                             f"{front['video_format']}")
    t0 = time.perf_counter()
    with native_decoders_only():
        frames = list(getattr(decoders, entry)(split["ps"]))
    secs = time.perf_counter() - t0
    got = [frame_digest(f) for f in frames]
    want = [frame_digest(f) for f in ts.recon]
    bad = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{codec} decode: {len(got)} frames against "
                             f"{len(want)}, differing {bad[:5]}")
    log(f"{codec} decode: {len(frames)} frames in {secs:.3f} s = "
        f"{len(frames) / secs:.1f} frames/s on the native engine ({entry}; "
        f"lossless PCM pictures, not long-GOP decode); every frame digest "
        f"equals the MPEG-2 TS's reconstruction")
    oracle = h26x_oracle(codec, split["ps"], aud, frames, ts.recon)
    del frames
    lgds = [f"{work}/logo{k}.lgd" for k in range(len(front["logos"]))]
    report, digests, _, trims, counts, cli_s = transcode_run(
        dev, work, f"{codec} kfm_vfr", ["--filter-mode", "kfm_vfr",
                                         "--h264decoder", "native"],
        out.path, lgds)
    want_run = trans["kfm_vfr"]
    n_batches = -(-ts.num_frames // BATCH)
    if (digests != want_run["digests"] or trims != want_run["trims"]
            or report["logofiles"]
            != [lgds[front["cm_result"].best_logo]]):
        bad = [k for k, (a, b) in enumerate(zip(digests,
                                                want_run["digests"]))
               if a != b]
        raise AssertionError(
            f"{codec} CLI: {len(digests)} frames against the MPEG-2 run's "
            f"{len(want_run['digests'])}, differing {bad[:5]}; trims "
            f"{trims!r}, logo {report['logofiles']}")
    if (counts.get("costs", 0) <= 0
            or counts.get("logo_eval") != len(lgds) * n_batches):
        raise AssertionError(f"{codec} CLI: launches {counts}")
    log(f"{codec} CLI kfm_vfr: {ts.num_frames} frames in {cli_s:.3f} s = "
        f"{ts.num_frames / cli_s:.2f} frames/s (--h264decoder native: "
        f"split, native decode, CM pass, filter, y4m to the fake encoder); "
        f"every digest, the trims and the logo equal to the MPEG-2 TS's "
        f"kfm_vfr run; launches {counts}")
    return dict(writer_seconds=out.seconds, mb=out.size / 1e6,
                split_mb_per_s=split["mb_per_s"], decode_fps=len(got) / secs,
                oracle=oracle, cli_seconds=cli_s,
                cli_fps=ts.num_frames / cli_s, launches=counts)


def h26x_phase(dev, work: str, front: dict, trans: dict) -> dict:
    """The ts phase's reconstruction as an H.264 and an HEVC TS (lossless
    PCM pictures, the same audio, timestamps and PIDs): each split on the
    native TS engine to the MPEG-2 TS's format, decoded on the native
    engine to the reconstruction, its first pictures by the pure-Python
    oracle to the same, and through cli.main in kfm_vfr to the transcode
    phase's kfm_vfr run digest for digest, K2 and K3 launched."""
    return {codec: h26x_codec(dev, work, front, trans, codec, entry, aud)
            for codec, entry, aud in H26X_CODECS}


# ---------------------------------------------------------------------------
# phase 14: "server": the encode server (server/, parallel/scheduler.py) runs
# two queued recordings and a logo scan on the card at once
# ---------------------------------------------------------------------------

SERVER_JOBS = (  # profile, its settings, the transcode phase's run it equals
    ("kfm", dict(filter_mode="kfm_vfr"), "kfm_vfr"),
    ("yadif", dict(filter_setting=dict(
        enable_deinterlace=True, deinterlace_algorithm="Yadif",
        yadif_fps="CFR30", enable_deblock=True)), "yadif + deblock"),
)
# frames of the 1440x1080 logo scan clip that the ScanLogo RPC reads through
# the server's logo_frame_source hook (the modes phase scans all 1280): the
# 96 frames of the TS hold too few with a flat border around the logo
SCAN_FRAMES = 384
SCAN_SERVICE_ID = 5  # not the TS's: the scanned .lgd joins no queued job
SERVER_TIMEOUT = 300  # seconds for both jobs and the scan


class _ServerWatch:
    """What each transcode of the server did, read by wrapping methods of
    the pipeline, the phase scheduler and the decoder factory (observation
    only): when it asked for each phase and when it entered it (seconds
    from when the server phase began), the CM pass's result and the
    decoder.
    Keyed by the pipeline, whose methods run on several threads."""

    def __init__(self):
        import threading

        self.jobs = {}  # id(pipeline) or id(its PhaseScheduler) -> record
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()

    @contextmanager
    def patched(self):
        from amatsukaze_tpu_torch.parallel import scheduler
        from amatsukaze_tpu_torch.pipeline import decoders, transcode

        pipe_cls = transcode.TranscodePipeline
        run0, analyze0 = pipe_cls.run, pipe_cls._analyze_video_file
        wait0, factory0 = (scheduler.PhaseScheduler.wait,
                           decoders.auto_decoder_factory)
        watch = self

        def run(pipe):
            conf = pipe.settings.conf
            rec = dict(mode=conf.filter_mode, post=conf.post_filter,
                       phases=[], cms=[], decoders=[])
            with watch.lock:
                watch.jobs[id(pipe)] = watch.jobs[id(pipe.phase)] = rec
            return run0(pipe)

        def wait(sched, phase):
            asked = time.perf_counter() - watch.t0
            out = wait0(sched, phase)
            watch.jobs[id(sched)]["phases"].append(
                (phase, asked, time.perf_counter() - watch.t0))
            return out

        def analyze(pipe, reform, v):
            cma = analyze0(pipe, reform, v)
            watch.jobs[id(pipe)]["cms"].append(cma)
            return cma

        def factory(pipe, v):
            frames = factory0(pipe, v)
            watch.jobs[id(pipe)]["decoders"].append(
                getattr(frames, "__qualname__", type(frames).__name__))
            return frames

        with mock.patch.object(pipe_cls, "run", run), \
                mock.patch.object(pipe_cls, "_analyze_video_file", analyze), \
                mock.patch.object(scheduler.PhaseScheduler, "wait", wait), \
                mock.patch.object(decoders, "auto_decoder_factory", factory):
            yield



def _scan_source(n_frames: int):
    """The logo scan clip's first n_frames, its format and its region."""
    import itertools

    from amatsukaze_tpu_torch.utils import synth_clip

    open_frames, _, fmt, region, _ = synth_clip.logo_scan_clip("broadcast")
    return (lambda: itertools.islice(open_frames(), n_frames)), fmt, region


async def _drive_server(dev, work: str, ts, scan: tuple) -> dict:
    """Start the server, give it its profiles, the two jobs (AddTask over
    TCP, then the AddQueue RPC) and the ScanLogo RPC, and wait for all
    three; the counts are set to 0 just before the first job is queued and
    read once all three are done."""
    import asyncio

    from amatsukaze_tpu_torch.server.rpc import RpcClient
    from amatsukaze_tpu_torch.server.server import EncodeServer
    from amatsukaze_tpu_torch.tools import add_task
    from amatsukaze_tpu_torch.utils.context import AMTContext

    open_scan, sfmt, region = scan
    # on the card as a user runs it; "cpu" only for a rehearsal here
    server = EncodeServer(AMTContext(level="warn"),
                          data_dir=f"{work}/server",
                          device=None if dev.type == "cuda" else "cpu")
    server.setting.num_parallel = 2
    server.setting.work_dir = f"{work}/server/work"
    server.logo_frame_source = lambda src: (open_scan(), sfmt.width,
                                            sfmt.height)
    port = await server.start(port=0)
    loop = asyncio.get_running_loop()
    client = await RpcClient.connect("127.0.0.1", port)
    try:
        for name, prof, _ in SERVER_JOBS:
            r = await client.call("SetProfile", dict(
                name=name, encoder_path=f"{work}/fake_x264", **prof))
            if r != {"ok": True}:
                raise AssertionError(f"server: SetProfile {name}: {r}")
        outs = {name: f"{work}/server_out/{name}" for name, _, _ in
                SERVER_JOBS}
        reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        # the recorder's route: AddTask's main over TCP (its own loop, on
        # a thread), then a client's AddQueue RPC and the ScanLogo RPC
        rc = await loop.run_in_executor(None, add_task.main, [
            "--port", str(port), "-s", "kfm", "-o", outs["kfm"], ts.path])
        queued = await client.call("AddQueue", {
            "src": ts.path, "out": outs["yadif"], "profile": "yadif"})
        scanned = await client.call("ScanLogo", {
            "src": ts.path, "rect": list(region), "name": "scan",
            "service_id": SCAN_SERVICE_ID})
        if rc != 0 or "item_id" not in queued or not scanned.get("ok"):
            raise AssertionError(f"server: AddTask {rc}, AddQueue {queued}, "
                                 f"ScanLogo {scanned}")
        jobs_s = scan_s = queue = state = None
        while jobs_s is None or scan_s is None:
            if time.perf_counter() - t0 > SERVER_TIMEOUT:
                raise AssertionError(f"server: not done in {SERVER_TIMEOUT} "
                                     f"s: {queue}, {state}")
            await asyncio.sleep(0.02)
            queue = await client.call("GetQueue")
            state = await client.call("GetState")
            if jobs_s is None and len(queue) == 2 and all(
                    e["state"] not in ("queue", "encoding") for e in queue):
                jobs_s = time.perf_counter() - t0
            if scan_s is None and state["logo_scan"]["state"] in ("done",
                                                                  "failed"):
                scan_s = time.perf_counter() - t0
        sync(dev)
        counts = read_counts()
        logs = await client.call("GetLogs")
    finally:
        client.close()
        await server.stop()
    return dict(queue=queue, state=state, logs=logs, counts=counts,
                jobs_seconds=jobs_s, scan_seconds=scan_s,
                scan_out=scanned["out"])


def server_phase(dev, work: str, front: dict, trans: dict, smi: str,
                 scan_frames: int = SCAN_FRAMES) -> dict:
    """The port's EncodeServer on the card, as a user deploys it: num_parallel
    2, the fake encoder, the ts phase's two logos as .lgd files under the
    TS's service id in its logo directory, the ts phase's TS queued twice
    (kfm_vfr by AddTask, yadif + deblock by the AddQueue RPC) and a ScanLogo
    RPC while both run. Both jobs complete with no retry, every output
    frame's digest and the trims equal the transcode phase's run of the
    mode, the jobs launch what the two CLI runs did (K2 3, K1 12, K3 12)
    and the scan the K3 launches of a direct LogoAnalyzer run on the card
    over the same frames after the server stopped, whose .lgd is
    byte-equal to the scan's."""
    import asyncio
    import dataclasses
    import os

    from amatsukaze_tpu_torch.models.cm_analyze import format_trim_avs
    from amatsukaze_tpu_torch.models.lgd import save_lgd
    from amatsukaze_tpu_torch.models.logo import LogoAnalyzer, ScanRegion
    from amatsukaze_tpu_torch.ts.info import TsInfo
    from amatsukaze_tpu_torch.utils.context import AMTContext

    ts, cm = front["ts"], front["cm_result"]
    info = TsInfo(AMTContext(level="warn"))
    info.read_file(ts.path)
    sid = info.programs[0].service_id
    os.makedirs(f"{work}/server/logo")
    for k, lg in enumerate(front["logos"]):
        save_lgd(f"{work}/server/logo/logo{k}.lgd", dataclasses.replace(
            lg, header=dataclasses.replace(lg.header, service_id=sid)))
    open_scan, sfmt, region = scan = _scan_source(scan_frames)
    watch = _ServerWatch()
    with native_decoders_only(), watch.patched():
        res = asyncio.run(_drive_server(dev, work, ts, scan))
    counts = res["counts"]
    jobs = {r["mode"]: r for r in watch.jobs.values()}
    want_trims = format_trim_avs(cm.result.trims) + "\n"
    out = {}
    for entry in res["queue"]:
        name = entry["profile_name"]
        _, _, cli_run = next(j for j in SERVER_JOBS if j[0] == name)
        rec = jobs[cli_run.split(" + ")[0]]  # the pipeline's filter mode
        if entry["state"] != "complete" or entry["retry_count"] != 0:
            raise AssertionError(f"server {name}: {entry['state']} after "
                                 f"{entry['retry_count']} retries: "
                                 f"{entry['console'][-5:]}")
        digests, _ = output_digests(entry["last_report"])
        want = trans[cli_run]["digests"]
        (cma,) = rec["cms"]
        trims = format_trim_avs(cma.result.trims) + "\n"
        if (digests != want or trims != trans[cli_run]["trims"]
                or trims != want_trims or cma.best_logo != cm.best_logo):
            bad = [k for k, (a, b) in enumerate(zip(digests, want)) if a != b]
            raise AssertionError(
                f"server {name}: {len(digests)} frames against the CLI "
                f"run's {len(want)}, differing {bad[:5]}; trims {trims!r}, "
                f"logo {cma.best_logo} against {cm.best_logo}")
        timeline = ", ".join(f"{p} {a:.3f}->{t:.3f}"
                             for p, a, t in rec["phases"])
        log(f"server {name} ({rec['mode']}"
            f"{' + ' + rec['post'] if rec['post'] else ''}): complete, no "
            f"retry; {len(digests)} frames, every digest and the trims equal "
            f"to the CLI's {cli_run} run; decoder {rec['decoders']}; phases "
            f"asked for -> entered at (s) {timeline}")
        out[name] = dict(phases=rec["phases"], decoders=rec["decoders"],
                         out_frames=len(digests))
    scan = res["state"]["logo_scan"]
    if scan["state"] != "done":
        raise AssertionError(f"server: logo scan {scan}")
    an = LogoAnalyzer(AMTContext(level="warn"), ScanRegion(*region), thy=12,
                      device=dev)
    reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    an.scan(open_scan(), sfmt.width, sfmt.height, name="scan",
            service_id=SCAN_SERVICE_ID)
    an.save(f"{work}/direct.lgd")
    sync(dev)
    direct_s = time.perf_counter() - t0
    direct = read_counts()
    with open(res["scan_out"], "rb") as f, open(f"{work}/direct.lgd",
                                                 "rb") as g:
        if f.read() != g.read():
            raise AssertionError("server: the scan's .lgd differs from the "
                                 "direct LogoAnalyzer run's")
    k3_scan = direct["logo_eval"]
    want_counts = {"costs": 3, "yadif": 12, "logo_eval": 12 + k3_scan}
    if ({k: v for k, v in counts.items() if v} != want_counts
            or {k: v for k, v in direct.items() if v} != {"logo_eval":
                                                          k3_scan}):
        raise AssertionError(f"server: launches {counts} (direct scan "
                             f"{direct}), want {want_counts}")
    cli_s = trans["kfm_vfr"]["seconds"] + trans["yadif + deblock"]["seconds"]
    log(f"server: both jobs in {res['jobs_seconds']:.3f} s of wall time "
        f"(the two CLI runs one after the other: {cli_s:.3f} s), with the "
        f"logo scan beside them ({scan_frames} frames "
        f"{sfmt.width}x{sfmt.height}, {len(an.frames_y)} kept, done at "
        f"{res['scan_seconds']:.3f} s; the direct run alone "
        f"{direct_s:.3f} s, its .lgd byte-equal); launches {counts} = the "
        f"two CLI runs' K2 3, K1 12, K3 12 + the scan's K3 {k3_scan}; {smi}")
    return dict(jobs=out, launches=counts, direct_launches=direct,
                jobs_seconds=res["jobs_seconds"], cli_seconds=cli_s,
                scan_seconds=res["scan_seconds"], direct_seconds=direct_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from amatsukaze_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    native_build = start_native_build()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_lib.build(["yadif_fieldmatch", "logo_eval"])
    log(f"build: {time.perf_counter() - t0:.2f} s ({built})")
    for name in ("yadif_fieldmatch", "logo_eval"):
        for line in (cuda_lib.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"ptxas {name}: {line.strip()[:160]}")
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
    with step_time("profile kfm_vfr"):
        profile_stage(dev, clip, fmt, logos)
    profile_scan_pass(dev, clip, fmt, logos)
    log(f"phase profile: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    small_reference(dev)
    log(f"phase small reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    golden_reference(dev)
    log(f"phase golden reference: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cm = cm_phase(dev)
    log(f"phase cm pass: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    post = post_phase(dev, clip, logos)
    log(f"phase post chain: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    modes = modes_phase(dev, clip, fmt, logos, cm["result"])
    log(f"phase svp, autovfr, logo generation: "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mesh = mesh_phase(dev, clip, fmt, logos, main, smi)
    log(f"phase mesh: {time.perf_counter() - t0:.2f} s")

    import tempfile

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        front = ts_phase(dev, native_build, work)
        log(f"phase ts front end: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        trans = transcode_phase(dev, work, front)
        log(f"phase transcode: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        h26x = h26x_phase(dev, work, front, trans)
        log(f"phase h264/h265: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        server = server_phase(dev, work, front, trans, smi)
        log(f"phase server: {time.perf_counter() - t0:.2f} s")

    kern = "amatsukaze_tpu_torch/ops/csrc/"
    rows = [
        ("yadif_fieldmatch[yadif]", "yadif_fieldmatch.cu",
         "amatsukaze_tpu/ops/fused_filter.py:335",
         main["yadif"]["launches"].get("yadif", 0)
         + mesh["stage"]["yadif"]["launches"]["yadif"]
         + front["stage"]["yadif"]["launches"]["yadif"]
         + trans["yadif + deblock"]["launches"]["yadif"]
         + server["launches"]["yadif"]
         + sum(c.get("yadif", 0) for c in mesh["records"].values()),
         checks["yadif_y"]),
        ("yadif_fieldmatch[yadif_bottom]", "yadif_fieldmatch.cu",
         "amatsukaze_tpu/ops/fused_filter.py:335",
         post["configs"]["yadif60"]["launches"].get("yadif_bottom", 0)
         + mesh["records"]["yadif60"].get("yadif_bottom", 0),
         checks["yadif_bottom_y"]),
        ("yadif_fieldmatch[costs]", "yadif_fieldmatch.cu",
         "amatsukaze_tpu/ops/fused_filter.py:716",
         main["kfm_vfr"]["launches"].get("costs", 0)
         + cm["stage"]["launches"]["costs"]
         + modes["svp"]["launches"]["costs"]
         + sum(modes["autovfr"][f"parallel_{p}"]["launches"]["costs"]
               for p in (1, 2))
         + mesh["stage"]["kfm_vfr"]["launches"]["costs"]
         + mesh["visible"]["launches"]["costs"]
         + mesh["records"]["kfm_vfr"].get("costs", 0)
         + front["stage"]["kfm_vfr"]["launches"]["costs"]
         + trans["kfm_vfr"]["launches"]["costs"]
         + sum(h["launches"]["costs"] for h in h26x.values())
         + server["launches"]["costs"], checks["costs_y"]),
        ("logo_eval", "logo_eval.cu", "amatsukaze_tpu/ops/logo_pallas.py:107",
         main["kfm_vfr"]["launches"]["logo_eval"]
         + main["yadif"]["launches"]["logo_eval"]
         + cm["launches"]["logo_eval"]
         + modes["svp"]["launches"]["logo_eval"]
         + modes["logo"]["launches"]["logo_eval"]
         + sum(mesh["stage"][m]["launches"]["logo_eval"]
               for m in ("kfm_vfr", "yadif"))
         + mesh["steps"]["launches"]["logo_eval"]
         + front["cm"]["launches"]["logo_eval"]
         + sum(r["launches"]["logo_eval"] for r in trans.values())
         + sum(h["launches"]["logo_eval"] for h in h26x.values())
         + server["launches"]["logo_eval"]
         + server["direct_launches"]["logo_eval"],
         checks["logo_eval_u8_f11"]),
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
