"""The port's whole transcode (pipeline/transcode.py, `--mode ts` and
`--mode cm`) against the JAX package's TranscodePipeline on the same TS.

The TS is the 96x128 short broadcast layout of utils/synth_ts.py (96
frames: program with the logo, CM, program; its logo as an .lgd file), the
whole 96x128 broadcast layout of utils/synth_clip.py written by the same
writer (1340 frames with a 15 s CM, which the CM pass finds), or
tests/ts_gen.build_simple_ts with a decoder of seeded uint16 planes (the
10-bit passthrough) or of telecined film (VFR output). Both pipelines decode with their default decoder factory (the
in-build MPEG-2 decoder), encode with a fake encoder that copies its y4m
stdin to `-o` (and, with --2pass, keeps each pass's copy), and mux with
their default muxer runner (the bare stream: the in-build remux cannot
hold raw y4m). The JAX package runs its device path on the CPU (Pallas
kernels in interpret mode, as its own tests run them; the host twins off)
and its TPU composition of yadif before the post chain (the fused
kernel's uint8 output).

Tolerances:
- the report JSON equal field by field, but for the wall times
  (`encodewaits`, the port's `trace`) and the output paths, which are
  compared relative to each run's directory;
- every file in the temp directory byte-equal (the intermediate PS and
  wave file, scene changes, logo frames, trim, div, JLS, chapters, v2
  timecodes, SRT/ASS where there are captions); the per-file CM results
  equal;
- the output y4m: the same header and frame count, every sample equal but
  at the erase rounding ties (pixels inside the logo box, one code value
  apart, at most 1e-3 of the samples; ROADMAP.md Queue 3 item 1);
- the filter graph's decisions and VFR plan identical.
"""

import os

import numpy as np
import pytest
import ts_gen
from torch_compare import load_both_native, plain
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.models.filter_graph as jfg_mod
import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu.ops import deint as jdeint
from amatsukaze_tpu.pipeline import decoders as jdec
from amatsukaze_tpu.pipeline import transcode as jtrans
from amatsukaze_tpu.pipeline.settings import Config as JConfig
from amatsukaze_tpu.pipeline.settings import Settings as JSettings
from amatsukaze_tpu.utils.context import AMTContext as JContext

from amatsukaze_tpu_torch.io.y4m import Y4MReader
from amatsukaze_tpu_torch.models.lgd import save_lgd
from amatsukaze_tpu_torch.pipeline import decoders as tdec
from amatsukaze_tpu_torch.pipeline import transcode as ttrans
from amatsukaze_tpu_torch.pipeline.settings import Config, Settings
from amatsukaze_tpu_torch.utils import synth_clip, synth_ts
from amatsukaze_tpu_torch.utils.context import AMTContext

TIE_SHARE = 1e-3

# fake x264: the y4m of stdin to -o; with --pass N also a copy per pass
FAKE_ENCODER = """#!/bin/bash
out=""; pass=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    --pass) pass="$2"; shift 2;;
    *) shift;;
  esac
done
cat > "$out"
if [ -n "$pass" ]; then cp "$out" "$out.pass$pass"; fi
"""

# configuration -> (source, Config fields)
CONFIGS = {
    "kfm_vfr": ("synth", dict(filter_mode="kfm_vfr", chapter=True)),
    "kfm_vfr_cm": ("long", dict(filter_mode="kfm_vfr", chapter=True)),
    "yadif_deblock": ("synth", dict(filter_mode="yadif",
                                    post_filter="deblock")),
    "none": ("synth", dict(filter_mode="none")),
    "cm": ("long", dict(mode="cm")),
    "two_pass": ("synth", dict(filter_mode="kfm_vfr", chapter=True,
                               two_pass=True)),
    # the program and the CM to files of their own
    "cm_split": ("long", dict(filter_mode="kfm_vfr", cm_out_mask=6)),
    "ten_bit": ("simple", dict(filter_mode="none")),
    # telecined film: VFR output with its v2 timecodes; the frame spill
    # off (the output pass decodes again)
    "kfm_vfr_film": ("simple", dict(filter_mode="kfm_vfr",
                                    analysis_cache_mb=0)),
}
# the outputs are fixed by these: the temp directory's random name and the
# run's own directory are not
RUN_DIR_FIELDS = ("path",)


def _film_decoder(pipeline, video_index):
    """3:2-pulldown telecined frames of a panning pattern (hard-telecined
    film, as tests/test_pipeline_e2e.py's TelecineDecoderFactory)."""
    reform = pipeline._reform
    fmt = reform.formats[reform.format_start_index[video_index]].video_format
    n = len(reform.get_filter_source_frames(video_index))
    h, w = fmt.height, fmt.width
    yy, xx = np.mgrid[0:h, 0:w]
    film = [np.clip(128 + 80 * np.sin((xx + 8 * i) / 7.0)
                    * np.cos(yy / 9.0), 0, 255).astype(np.uint8)
            for i in range(n)]
    u = np.full((h // 2, w // 2), 128, np.uint8)

    def weave(top, bot):
        f = bot.copy()
        f[0::2] = top[0::2]
        return f

    out = []
    for i in range(0, n, 4):
        a, b, c, d = (film[i:i + 4] + film[-1:] * 3)[:4]
        out += [a, weave(a, b), weave(b, c), c, d]
    for y in out[:n]:
        yield y, u, u


def _ten_bit_decoder(pipeline, video_index):
    """Seeded 10-bit planes of every frame of the video file."""
    reform = pipeline._reform
    fmt = reform.formats[reform.format_start_index[video_index]].video_format
    n = len(reform.get_filter_source_frames(video_index))
    rng = np.random.default_rng(7)
    for _ in range(n):
        yield tuple(rng.integers(0, 1024, (h, w), dtype=np.uint16)
                    for h, w in ((fmt.height, fmt.width),
                                 (fmt.height // 2, fmt.width // 2),
                                 (fmt.height // 2, fmt.width // 2)))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The two TS files, the logo as an .lgd file and the fake encoder."""
    load_both_native()
    base = tmp_path_factory.mktemp("transcode")
    ts, _, logos = synth_ts.ts_clip("small", str(base / "synth.ts"))
    lgd = str(base / "logo0.lgd")
    save_lgd(lgd, logos[0])
    spec = synth_clip.BROADCAST_CLIPS["small"]
    cuts = (synth_clip.CM_START, synth_clip.CM_END)

    def silent(t0, t1):  # synth_ts.silent_around_cuts at the layout's cuts
        return any(t0 < c * 1001 / 30000 + synth_ts.SILENCE_SECONDS / 2
                   and t1 > c * 1001 / 30000 - synth_ts.SILENCE_SECONDS / 2
                   for c in cuts)

    long = synth_ts.write_ts(str(base / "long.ts"),
                             synth_clip.make_broadcast_clip(**spec),
                             synth_clip.BROADCAST_FRAMES, silent,
                             spec["seed"])
    simple = base / "simple.ts"
    simple.write_bytes(ts_gen.build_simple_ts(num_frames=60, width=96,
                                              height=64))
    enc = base / "fake_x264"
    enc.write_text(FAKE_ENCODER)
    enc.chmod(0o755)
    return dict(base=base, synth=ts.path, long=long.path,
                simple=str(simple), lgd=lgd,
                logo=logos[0], enc=str(enc))


def _yadif_as_on_tpu(self, frames, prev_frame, next_frame):
    """The JAX FilterGraph's fused-kernel yadif (its TPU path: uint8 frames
    out, which the post chain then reads), from its jnp yadif and the
    kernel's rounding."""
    import jax.numpy as jnp

    arr = jnp.asarray(frames).astype(jnp.float32)
    first = frames[:1] if prev_frame is None else prev_frame[None]
    last = frames[-1:] if next_frame is None else next_frame[None]
    prev = jnp.concatenate([jnp.asarray(first, jnp.float32), arr[:-1]])
    nxt = jnp.concatenate([arr[1:], jnp.asarray(last, jnp.float32)])
    out = jdeint.yadif_deinterlace(prev, arr, nxt, True)
    return jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)


def _run(side: str, name: str, src: dict) -> dict:
    """One transcode of configuration `name` by the port or the JAX
    package: the report, the temp files, the outputs, the filter graphs
    and the CM results."""
    source, fields = CONFIGS[name]
    run_dir = src["base"] / name / side
    os.makedirs(run_dir, exist_ok=True)
    conf = (Config if side == "port" else JConfig)()
    conf.src_file_path = src[source]
    conf.work_dir = str(run_dir)
    conf.out_video_path = str(run_dir / "out")
    conf.out_info_json_path = str(run_dir / "report.json")
    conf.encoder_path = src["enc"]
    conf.no_remove_tmp = True
    if source != "simple":
        conf.logo_path = [src["lgd"]]
    for k, v in fields.items():
        setattr(conf, k, v)
    mod = ttrans if side == "port" else jtrans
    ctx = (AMTContext if side == "port" else JContext)(level="error")
    st = (Settings if side == "port" else JSettings)(ctx, conf)
    graphs, cms = [], []

    def encoder_runner(pipe, reform, key, args):
        if side == "port":
            graphs.append(pipe._active_stage.graph)
        else:
            graphs.append(pipe._active_filter)
        mod._default_encoder_runner(pipe, reform, key, args)

    if source == "simple":
        decoder = (_ten_bit_decoder if name == "ten_bit"
                   else _film_decoder)
    else:
        decoder = (tdec if side == "port" else jdec).default_decoder_factory()
    kw = dict(decoder_factory=decoder, encoder_runner=encoder_runner)
    if side == "port":
        kw["device"] = "cpu"
    pipe = mod.TranscodePipeline(ctx, st, **kw)
    analyze = type(pipe)._analyze_video_file
    pipe._analyze_video_file = lambda r, v: cms.append(
        analyze(pipe, r, v)) or cms[-1]
    report = pipe.run()
    tmp, passes = {}, {}
    for f in sorted(os.listdir(st.tmp.path)):
        with open(os.path.join(st.tmp.path, f), "rb") as fh:
            (passes if ".pass" in f else tmp)[f] = fh.read()
    outs = {}
    for f in sorted(os.listdir(run_dir)):
        path = run_dir / f
        if path.is_file() and f.startswith("out"):
            outs[f] = path.read_bytes()
    return dict(report=report, tmp=tmp, passes=passes, outs=outs,
                graphs=graphs,
                cms=[c.result if side == "port" else c for c in cms],
                run_dir=str(run_dir), reform=pipe._reform)


@pytest.fixture(scope="module")
def runs(sources):
    """Both packages' run of each configuration, made on first use."""
    done = {}

    def get(name):
        if name not in done:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jlogo_model, "_HOST_OPS", False)  # device path
                mp.setenv("AMATSUKAZE_SCENE_METRICS", "device")
                mp.setenv("AMATSUKAZE_FILTER_BACKEND", "device")
                mp.setattr(jfg_mod.FilterGraph, "_fused_yadif",
                           _yadif_as_on_tpu)
                done[name] = (_run("port", name, sources),
                              _run("jax", name, sources))
        return done[name]

    return get


def _y4m_frames(data: bytes):
    import io

    r = Y4MReader(io.BytesIO(data))
    frames = []
    while True:
        f = r.read_frame()
        if f is None:
            return r.fmt, frames
        frames.append(f)


def _assert_ties_only(got: bytes, want: bytes, logo, what: str) -> None:
    """Two y4m streams: the same header and frames, but at erase rounding
    ties inside the logo box (one code value apart)."""
    assert got.split(b"\n", 1)[0] == want.split(b"\n", 1)[0], what
    gfmt, gframes = _y4m_frames(got)
    _, wframes = _y4m_frames(want)
    assert len(gframes) == len(wframes) > 0, what
    h = logo.header
    ties = total = 0
    for k, (a, b) in enumerate(zip(gframes, wframes)):
        for p, sub in enumerate((1, 2, 2)):
            d = a[p].astype(np.int32) - b[p].astype(np.int32)
            ys, xs = np.nonzero(d)
            assert np.all(np.abs(d[ys, xs]) == 1), (what, k, p)
            assert np.all((ys >= h.imgy // sub)
                          & (ys < (h.imgy + h.h) // sub)
                          & (xs >= h.imgx // sub)
                          & (xs < (h.imgx + h.w) // sub)), (what, k, p)
            ties += len(ys)
            total += d.size
    assert ties <= TIE_SHARE * total, (what, ties, total)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_report_equals_jax(runs, sources, name):
    port, jax = runs(name)
    got, want = dict(port["report"]), dict(jax["report"])
    assert len(got.pop("encodewaits")) == len(want.pop("encodewaits"))
    # the port's trace (utils/perf.py) has no counterpart in the JAX report
    assert got.pop("trace")["clock"] == "perf_counter"
    gouts, wouts = got.pop("outfiles"), want.pop("outfiles")
    assert len(gouts) == len(wouts) > (0 if name != "cm" else -1)
    for g, w in zip(gouts, wouts):
        for k in RUN_DIR_FIELDS:
            assert (os.path.relpath(g.pop(k), port["run_dir"])
                    == os.path.relpath(w.pop(k), jax["run_dir"]))
        assert g == w
    assert got == want
    logo = CONFIGS[name][0] != "simple"
    assert got["logofiles"] == [sources["lgd"] if logo else ""]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_temp_files_equal_jax(runs, name):
    port, jax = runs(name)
    assert list(port["tmp"]) == list(jax["tmp"])
    for f in port["tmp"]:
        assert port["tmp"][f] == jax["tmp"][f], f
    if CONFIGS[name][0] != "simple":
        for f in ("chapter_exe_o0.txt", "logof0.txt", "trim0.avs",
                  "div0.txt"):
            assert f in port["tmp"], f
    if name in ("kfm_vfr", "two_pass"):
        assert "jls0.txt" in port["tmp"]
    if name == "kfm_vfr_film":
        (tc,) = [f for f in port["tmp"] if f.endswith("timecode.txt")]
        assert port["tmp"][tc].startswith(b"# timecode format v2\n")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cm_results_equal_jax(runs, name):
    port, jax = runs(name)
    assert plain(port["cms"]) == plain(jax["cms"])
    r = port["cms"][0]
    if CONFIGS[name][0] != "simple":
        assert r.logopath.endswith("logo0.lgd")
    if CONFIGS[name][0] == "long":
        assert r.trims == synth_clip.BROADCAST_TRUTH["trims"]
        assert [(z.start_frame, z.end_frame) for z in r.cmzones] \
            == synth_clip.BROADCAST_TRUTH["cm_zones"]


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "cm"])
def test_outputs_equal_jax(runs, sources, name):
    port, jax = runs(name)
    assert list(port["outs"]) == list(jax["outs"])
    assert port["outs"]
    for f in port["outs"]:
        _assert_ties_only(port["outs"][f], jax["outs"][f], sources["logo"],
                          f"{name} {f}")


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "cm"])
def test_decisions_and_plan_equal_jax(runs, name):
    port, jax = runs(name)
    assert len(port["graphs"]) == len(jax["graphs"]) > 0
    for fg, jfg in zip(port["graphs"], jax["graphs"]):
        assert fg.mode == jfg.mode == CONFIGS[name][1]["filter_mode"]
        if fg.decisions is None:
            assert jfg.decisions is None
            continue
        assert ([(int(d.mode), d.phase) for d in fg.decisions]
                == [(int(d.mode), d.phase) for d in jfg.decisions])
        assert fg.vfr_plan.durations == jfg.vfr_plan.durations
        assert fg.vfr_plan.source_frames == jfg.vfr_plan.source_frames


def test_two_passes_equal_each_other_and_one_pass(runs, sources):
    """--2pass runs the encoder twice over one analysis (both passes read
    the frame spill): each pass's stream is the one-pass output, and the
    JAX package's passes within the tie tolerance."""
    port, jax = runs("two_pass")
    one, _ = runs("kfm_vfr")
    assert len(port["graphs"]) == 2
    assert port["graphs"][0] is port["graphs"][1]
    (single,) = one["outs"].values()
    assert [p.rsplit(".", 1)[1] for p in port["passes"]] == ["pass1",
                                                             "pass2"]
    assert list(port["passes"]) == list(jax["passes"])
    for name, data in port["passes"].items():
        assert data == single, name
        _assert_ties_only(data, jax["passes"][name], sources["logo"], name)
    assert list(port["outs"].values()) == [single]


def test_cm_split_selects_after_the_erase(runs):
    """cm_out_mask 6: the program and the CM go to files of their own,
    neither of which is frames 0..n-1 of the stream after the first, so
    the fades must index the source frames (erase, then select)."""
    port, jax = runs("cm_split")
    reform = port["reform"]
    keys = reform.get_out_file_keys()
    assert {k.cm.name for k in keys} == {"NONCM", "CM"}
    frames = [reform.get_encode_file(k).video_frames for k in keys]
    assert any(f != list(range(len(f))) for f in frames)
    assert sorted(i for f in frames for i in f) == list(range(
        len(reform.get_filter_source_frames(0))))
    assert len(port["outs"]) == 2


def test_ten_bit_passthrough_keeps_ten_bits(runs):
    port, _ = runs("ten_bit")
    (data,) = port["outs"].values()
    fmt, frames = _y4m_frames(data)
    assert fmt.colorspace == "420p10"
    assert frames[0][0].dtype == np.uint16
    assert len(frames) == len(port["reform"].get_filter_source_frames(0))
