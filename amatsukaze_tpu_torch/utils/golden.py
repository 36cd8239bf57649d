"""The recorded results of the filter stage over the seeded clips of
utils.synth_clip (testdata/golden_stage.json): what is recorded of one run,
and how a run is held against the record.

The record comes from the JAX package on the CPU (written by
tests/test_torch_golden.py, which also runs the port on the CPU over the
same clips); the card is held to it by chip_smoke.py. Exact: selected logo,
cycle decisions, durations, source frames, one digest per output frame. The
fade curve within FADE_TOL (float32 sums in another order on another
device).

One difference between the packages is known and recorded, not tolerated:
XLA on the CPU contracts the erase into fused multiply-adds, the port
rounds each operation (as the reference C++ and ops.logo_ref do), and a
pixel whose blend lands within one float32 step of k + 0.5 comes out one
code value apart, about 1.5e-5 of the erased pixels. A 96x256 logo erased
on 45 frames of 1440x1080 4:2:0 has about 20 such pixels whatever the seed.
The writer checks every one (inside the logo box's reach, one code value)
and stores, for each frame that holds one, the port's CPU digest beside the
JAX one under ``tie_digests``; such a frame must equal either. The small
clip has none.

testdata/golden_cm.json holds the CM analysis pass over the 96x128
broadcast layout of utils.synth_clip in the same way (written by
tests/test_torch_cm_stage.py from a JAX composition of the same steps):
scene changes, silence, logo, logo spans, trims, divs, CM zones, JLS
elements and the text of the five files exact, the fade curve within
FADE_TOL.

testdata/golden_post.npz holds the post chain, resize, 10-bit, double-rate
and svp configurations (tests/test_torch_post_chain.py),
testdata/golden_autovfr.json autovfr's decisions, sections and files at
several widths of parallelism (tests/test_torch_fps_modes.py) and
testdata/golden_logo.npz the logo generation's selections and A/B planes
(tests/test_torch_logo_gen.py), each with its own rule below.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent.parent / "testdata" / "golden_stage.json"
MODES = ("kfm_vfr", "yadif")
FADE_TOL = 1e-5
_EXACT = ("best_logo", "decisions", "durations", "source_frames")


def frame_digest(planes) -> str:
    """blake2b-128 over the frame's Y, U, V bytes."""
    h = hashlib.blake2b(digest_size=16)
    for p in planes:
        if p.dtype != np.uint8:
            raise ValueError("output planes must be uint8")
        h.update(np.ascontiguousarray(p).data)
    return h.hexdigest()


def record(best_logo: int, fade, graph, out_frames=None,
           digests=None, tie_digests=None) -> dict:
    """One run of the stage as plain JSON types. `graph` is the run's
    FilterGraph (of either package); give the output frames or their
    digests."""
    plan = graph.vfr_plan
    if digests is None:
        digests = [frame_digest(f) for f in out_frames]
    return dict(
        best_logo=int(best_logo),
        fade=None if fade is None else [float(x) for x in fade],
        decisions=None if graph.decisions is None else [
            [int(d.mode), int(d.phase)] for d in graph.decisions],
        durations=None if plan is None else [int(d) for d in plan.durations],
        source_frames=None if plan is None else [
            [int(s), int(op)] for s, op in plan.source_frames],
        digests=list(digests),
        tie_digests=dict(tie_digests or {}))


def assert_matches(got: dict, want: dict, what: str) -> None:
    """Raise AssertionError naming what differs between two records."""
    diff = [k for k in _EXACT if got[k] != want[k]]
    if diff:
        raise AssertionError(f"{what}: results differ in {diff}")
    if (got["fade"] is None) != (want["fade"] is None) or (
            got["fade"] is not None and not (
                len(got["fade"]) == len(want["fade"]) and np.allclose(
                    got["fade"], want["fade"], rtol=0, atol=FADE_TOL))):
        raise AssertionError(f"{what}: fade curves differ")
    ties = want.get("tie_digests", {})
    bad = [k for k, (a, b) in enumerate(zip(got["digests"], want["digests"]))
           if a != b and a != ties.get(str(k))]
    if len(got["digests"]) != len(want["digests"]) or bad:
        raise AssertionError(
            f"{what}: {len(bad)} output frames differ (first {bad[:5]}; "
            f"{len(got['digests'])} frames against {len(want['digests'])})")


def load() -> dict:
    """{clip name: {mode: record}}."""
    return json.loads(PATH.read_text())["clips"]


def load_meta() -> dict:
    return json.loads(PATH.read_text())["meta"]


def save(clips: dict, meta: dict) -> None:
    PATH.parent.mkdir(parents=True, exist_ok=True)
    PATH.write_text(json.dumps({"meta": meta, "clips": clips},
                               separators=(",", ":")) + "\n")


# ---------------------------------------------------------------------------
# the CM analysis pass over the broadcast layout (testdata/golden_cm.json)
# ---------------------------------------------------------------------------

CM_PATH = PATH.parent / "golden_cm.json"
_CM_EXACT = ("scene_changes", "silence", "best_logo", "logo_spans", "trims",
             "divs", "cmzones", "jls", "files")


def cm_record(scene_changes, silence, best_logo, logo_spans, fade, trims,
              divs, cmzones, jls, files: dict) -> dict:
    """One CM pass as plain JSON types: spans and zones as [start, end]
    (cmzones: objects with start_frame / end_frame), JLS elements as
    [frame_start, frame_end, seconds], `files` as {name: text}."""
    return dict(
        scene_changes=[int(s) for s in scene_changes],
        silence=[[int(s), int(e)] for s, e in silence],
        best_logo=int(best_logo),
        logo_spans=None if logo_spans is None else [
            [int(s), int(e)] for s, e in logo_spans],
        fade=None if fade is None else [float(x) for x in fade],
        trims=[int(t) for t in trims], divs=[int(d) for d in divs],
        cmzones=[[int(z.start_frame), int(z.end_frame)] for z in cmzones],
        jls=[[int(e.frame_start), int(e.frame_end), int(e.seconds)]
             for e in jls],
        files=dict(files))


def cm_stage_record(cm, files: dict) -> dict:
    """cm_record of a pipeline.cm_stage.CMStageResult."""
    r = cm.result
    return cm_record(cm.scene_changes, cm.silence, cm.best_logo,
                     cm.logo_spans, cm.fade, r.trims, r.divs, r.cmzones,
                     cm.jls_elements, files)


def assert_cm_matches(got: dict, want: dict, what: str) -> None:
    """Raise AssertionError naming what differs between two CM records;
    the fade curve within FADE_TOL, everything else exact."""
    diff = [k for k in _CM_EXACT if got[k] != want[k]]
    if diff:
        raise AssertionError(f"{what}: CM results differ in {diff}")
    if (got["fade"] is None) != (want["fade"] is None) or (
            got["fade"] is not None and not (
                len(got["fade"]) == len(want["fade"]) and np.allclose(
                    got["fade"], want["fade"], rtol=0, atol=FADE_TOL))):
        raise AssertionError(f"{what}: fade curves differ")


def load_cm() -> dict:
    """{clip name: record}."""
    return json.loads(CM_PATH.read_text())["clips"]


def save_cm(clips: dict, meta: dict) -> None:
    CM_PATH.write_text(json.dumps({"meta": meta, "clips": clips},
                                  separators=(",", ":")) + "\n")


# ---------------------------------------------------------------------------
# the post chain, resize, 10-bit and double-rate paths of the filter stage
# (testdata/golden_post.npz)
# ---------------------------------------------------------------------------

POST_PATH = PATH.parent / "golden_post.npz"
POST_CLIP = "small"
POST_BATCH = 16  # more than the head ramp's 8 frames: that chunk is padded
QP_SEED = 5
# name -> the stage's mode and what follows it; "bits": 10 feeds the clip
# as 10-bit samples (synth_clip.to_10bit) with no logo to erase. "exact":
# the port's plain version gives the JAX package's frames bit for bit
# (every op of the path is bit-equal, and no rounding tie happens to fall
# on these frames), so the record keeps one digest per frame and a run
# must match it exactly; the others keep the frames themselves, since a
# run may differ from them by the rules below.
POST_CONFIGS = {
    "yadif_chain_resize": dict(mode="yadif",
                               post_filter="deblock,nr,deband,edge",
                               qp=True, resize=True),
    "kfm_vfr_chain": dict(mode="kfm_vfr", post_filter="deblock,nr", qp=True,
                          exact=True),
    "yadif60": dict(mode="yadif60", exact=True),
    "qtgmc_nr": dict(mode="qtgmc", post_filter="nr", exact=True),
    "none_10bit": dict(mode="none", post_filter="nr,deband,edge", bits=10,
                       exact=True),
    "svp": dict(mode="svp", exact=True),
    "svp_nr": dict(mode="svp", post_filter="nr", tie_share=1e-3),
}
# samples one code value apart may be at most this share of a
# configuration's output samples ("tie_share" where a configuration names
# its own): float rounding ties of the ops whose sums XLA on the CPU orders
# or fuses otherwise than the port (the resize, the cross-fades of svp's
# interpolation). deblock and edge level reproduce XLA's order and fusion
# (ops.denoise), so no configuration has samples further apart. svp's
# cross-fades of integer samples lie in fifths and never round at a tie;
# temporal NR's averages of them over two frames do (about 5e-4 of the
# samples of svp_nr).
POST_TIE_SHARE = 1e-4


def resize_for(h: int, w: int) -> tuple[int, int]:
    """The resize target (width, height) of an h x w source: 1440x1080 ->
    1280x720, the 720p downscale of a 1080i broadcast."""
    return (w * 8 // 9 // 2 * 2, h * 2 // 3 // 2 * 2)


def post_stage_inputs(name: str, frames: list, logos: list):
    """(frames, logos, run_filter_stage keyword arguments) of one
    configuration of POST_CONFIGS over a clip of (Y, U, V) uint8 frames."""
    from ..ts.qp_extract import QpMapSource
    from . import synth_clip

    cfg = POST_CONFIGS[name]
    h, w = frames[0][0].shape
    kw = dict(mode=cfg["mode"], post_filter=cfg.get("post_filter", ""))
    if cfg.get("qp"):
        kw["qp_source"] = QpMapSource.from_maps(synth_clip.qp_maps(
            len(frames), QP_SEED, -(-h // 16), -(-w // 16)))
    if cfg.get("resize"):
        kw["resize"] = resize_for(h, w)
    if cfg.get("bits") == 10:
        frames, logos = synth_clip.to_10bit(frames, QP_SEED), []
    return frames, logos, kw


def stack_planes(frames: list) -> list:
    """Output frames [(Y, U, V)] -> [Y [N, h, w], U, V]."""
    return [np.stack([f[p] for f in frames]) for p in range(3)]


def assert_post_matches(got: list, want: list, what: str,
                        tie_share: float = POST_TIE_SHARE) -> int:
    """Two runs' stacked planes (stack_planes): equal, or one code value
    apart on at most `tie_share` of the samples. Returns the number of
    samples one code value apart."""
    if [g.shape for g in got] != [x.shape for x in want] or any(
            g.dtype != x.dtype for g, x in zip(got, want)):
        raise AssertionError(
            f"{what}: planes {[(g.shape, g.dtype) for g in got]} against "
            f"{[(x.shape, x.dtype) for x in want]}")
    n_one = n_all = 0
    for g, x in zip(got, want):
        d = np.abs(g.astype(np.int32) - x.astype(np.int32))
        worst = int(d.max(initial=0))
        if worst > 1:
            raise AssertionError(f"{what}: a sample differs by {worst}")
        n_one += int(np.count_nonzero(d))
        n_all += d.size
    if n_one > tie_share * n_all:
        raise AssertionError(f"{what}: {n_one} of {n_all} samples one code "
                             f"value apart")
    return n_one


def post_digests(frames: list) -> list[str]:
    """blake2b-128 of each output frame's planes, uint8 or uint16."""
    out = []
    for planes in frames:
        h = hashlib.blake2b(digest_size=16)
        for p in planes:
            h.update(p.dtype.str.encode())
            h.update(np.ascontiguousarray(p).data)
        out.append(h.hexdigest())
    return out


def assert_post_record(frames: list, record, name: str) -> int:
    """A run's output frames against the recorded ones of configuration
    `name` (load_post): digests equal for an exact configuration, else
    assert_post_matches. Returns its count (0 when exact)."""
    cfg = POST_CONFIGS[name]
    if cfg.get("exact"):
        got = post_digests(frames)
        bad = [k for k, (a, b) in enumerate(zip(got, record)) if a != b]
        if len(got) != len(record) or bad:
            raise AssertionError(
                f"{name}: {len(bad)} frames differ from the record (first "
                f"{bad[:5]}; {len(got)} frames against {len(record)})")
        return 0
    return assert_post_matches(stack_planes(frames), record, name,
                               cfg.get("tie_share", POST_TIE_SHARE))


def save_post(outputs: dict) -> None:
    """{configuration: output frames} -> POST_PATH: the digests of an
    exact configuration, the stacked planes of the others, each row stored
    as its differences from the left neighbour (wrapping in the sample
    type), which compresses to two thirds of the samples themselves."""
    arrays = {}
    for name, frames in outputs.items():
        if POST_CONFIGS[name].get("exact"):
            arrays[f"{name}/digests"] = np.array(post_digests(frames))
            continue
        for p, x in enumerate(stack_planes(frames)):
            arrays[f"{name}/{p}"] = np.diff(x, axis=-1,
                                            prepend=x.dtype.type(0))
    np.savez_compressed(POST_PATH, **arrays)


def load_post() -> dict:
    """{configuration: digests (a list) or stacked planes} of POST_PATH."""
    with np.load(POST_PATH) as z:
        out = {}
        for key in sorted(z.files):
            name, part = key.split("/")
            d = z[key]
            if part == "digests":
                out[name] = [str(x) for x in d]
            else:
                out.setdefault(name, []).append(
                    np.cumsum(d, axis=-1, dtype=d.dtype))
        return out


# ---------------------------------------------------------------------------
# autovfr's sectioned analysis over the broadcast layout
# (testdata/golden_autovfr.json)
# ---------------------------------------------------------------------------

AUTOVFR_PATH = PATH.parent / "golden_autovfr.json"
AUTOVFR_CLIP = "small"  # utils.synth_clip.broadcast_clip
AUTOVFR_BATCH = 32
AUTOVFR_PARALLEL = (1, 2, 3)


def autovfr_record(graph, prefix: str, sections: list) -> dict:
    """One analyze_autovfr run as plain JSON types: the cycle decisions,
    the sections, and the texts of the .def file and the section logs it
    wrote under `prefix`."""
    logs = []
    for i in range(len(sections)):
        with open(f"{prefix}.autovfr{i + 1}.log") as f:
            logs.append(f.read())
    with open(f"{prefix}.autovfr.def") as f:
        its_def = f.read()
    return dict(decisions=[[int(d.mode), int(d.phase)]
                           for d in graph.decisions],
                sections=[[int(a), int(b)] for a, b in sections],
                its_def=its_def, logs=logs)


def autovfr_runs(make_graph) -> dict:
    """{str(parallel): autovfr_record} of analyze_autovfr over the recorded
    layout at every width of AUTOVFR_PARALLEL; make_graph() -> a fresh
    autovfr FilterGraph (of either package) with batch AUTOVFR_BATCH."""
    import tempfile

    from . import synth_clip

    open_frames, n, _, _, _ = synth_clip.broadcast_clip(AUTOVFR_CLIP)
    luma = [planes[0] for planes in open_frames()]
    runs = {}
    for par in AUTOVFR_PARALLEL:
        with tempfile.TemporaryDirectory() as d:
            prefix = str(Path(d) / "rec")
            fg = make_graph()
            sections = []
            fg.analyze_autovfr(lambda s, e: iter(luma[max(0, s):e]), n,
                               parallel=par, log_prefix=prefix,
                               sections_log=sections)
            runs[str(par)] = autovfr_record(fg, prefix, sections)
    return runs


def load_autovfr() -> dict:
    """{str(parallel): record}."""
    return json.loads(AUTOVFR_PATH.read_text())["runs"]


def save_autovfr(runs: dict, meta: dict) -> None:
    AUTOVFR_PATH.write_text(json.dumps({"meta": meta, "runs": runs},
                                       separators=(",", ":")) + "\n")


# ---------------------------------------------------------------------------
# logo generation over the small logo scan clip (testdata/golden_logo.npz)
# ---------------------------------------------------------------------------

LOGO_PATH = PATH.parent / "golden_logo.npz"
LOGO_CLIP = "small"  # utils.synth_clip.logo_scan_clip
LOGO_PLANES = ("a_y", "b_y", "a_u", "b_u", "a_v", "b_v")
# A and B against the record. The regression sums are integers below 2^24
# (ops.logo.logo_sums_update), exact on every device, and the solve runs
# in float64 on the host, so a run that keeps the recorded frames gives the
# recorded A and B; the bound leaves room for the float32 rounding of the
# solve's result only.
LOGO_AB_TOL = 1e-6


def logo_record(analyzer) -> dict:
    """A LogoAnalyzer's results: the best fade step of every kept frame in
    each refinement pass and the final logo's A and B planes."""
    out = {f"min_fades_{i}": np.asarray(m, np.int32)
           for i, m in enumerate(analyzer.min_fades)}
    out["kept"] = np.int32(len(analyzer.frames_y))
    for k in LOGO_PLANES:
        out[k] = np.asarray(getattr(analyzer.logodata, k), np.float32)
    return out


def assert_logo_matches(got: dict, want: dict, what: str) -> int:
    """The kept frames and every pass's selection (best fade above 8 of 20)
    identical, A and B within LOGO_AB_TOL. Returns the number of frames
    whose best fade differs (not their selection)."""
    if int(got["kept"]) != int(want["kept"]):
        raise AssertionError(f"{what}: {got['kept']} frames kept, recorded "
                             f"{want['kept']}")
    n_moved = 0
    for i in range(2):
        g, w = got[f"min_fades_{i}"], want[f"min_fades_{i}"]
        if not np.array_equal(g > 8, w > 8):
            raise AssertionError(f"{what}: pass {i + 2} keeps other frames")
        n_moved += int(np.count_nonzero(g != w))
    for k in LOGO_PLANES:
        err = float(np.abs(got[k] - want[k]).max())
        if got[k].shape != want[k].shape or not err <= LOGO_AB_TOL:
            raise AssertionError(f"{what}: {k} differs by {err}")
    return n_moved


def load_logo() -> dict:
    with np.load(LOGO_PATH) as z:
        return {k: z[k] for k in z.files}


def save_logo(record: dict) -> None:
    np.savez_compressed(LOGO_PATH, **record)
