"""The port's CM ops and models against the JAX package on the CPU.

Ops (amatsukaze_tpu_torch/ops/cm.py against amatsukaze_tpu/ops/cm.py, the
same seeded numpy inputs): normalised histograms bit-equal (exact integer
counts over the same float32 totals), frame differences and audio RMS
within rtol 1e-5 (the JAX package sums in float32, the port in int64 /
float32 in another order), histogram_correlation_from_hists bit-equal (the
same numpy), the host decisions equal, the carry across batches equal to
the whole-array form.

Models (cm_analyze, jls_script, chapter): the inputs that
tests/test_cm_analyze.py and tests/test_jls_script.py build, through both
packages, results equal; one parametrised case per input.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
import torch

from amatsukaze_tpu.models import chapter as jchapter
from amatsukaze_tpu.models import cm_analyze as jcma
from amatsukaze_tpu.models import jls_script as jjls
from amatsukaze_tpu.ops import cm as jcm
from amatsukaze_tpu.utils import context as jcontext
from amatsukaze_tpu_torch.models import chapter as tchapter
from amatsukaze_tpu_torch.models import cm_analyze as tcma
from amatsukaze_tpu_torch.models import jls_script as tjls
from amatsukaze_tpu_torch.ops import cm as tcm
from amatsukaze_tpu_torch.utils import context as tcontext

RTOL = 1e-5
FPS = 29.97


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 40, 56), (32, 24, 20), (1, 9, 13)])
def test_scene_metrics_batch_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    frames = _u8(rng, shape)
    prev = _u8(rng, shape[1:])
    jd, jh = jcm.scene_metrics_batch(jnp.asarray(frames), jnp.asarray(prev))
    td, th = tcm.scene_metrics_batch(torch.from_numpy(frames),
                                     torch.from_numpy(prev))
    assert th.dtype == td.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL)


def test_scene_metrics_carry_equals_whole_array():
    """Batches of 8 with the previous batch's last frame as the carry (the
    first batch carrying its own frame 0) give the whole sequence's
    metrics, in both packages."""
    rng = np.random.default_rng(11)
    frames = _u8(rng, (27, 16, 24))
    whole_d = tcm.scene_change_scores(torch.from_numpy(frames)).numpy()
    whole_h = tcm._binned_hist(torch.from_numpy(frames)).numpy()
    outs = {"jax": ([], []), "torch": ([], [])}
    for k in range(0, len(frames), 8):
        b = frames[k:k + 8]
        prev = b[0] if k == 0 else frames[k - 1]
        jd, jh = jcm.scene_metrics_batch(jnp.asarray(b), jnp.asarray(prev))
        td, th = tcm.scene_metrics_batch(torch.from_numpy(b),
                                         torch.from_numpy(prev))
        outs["jax"][0].append(np.asarray(jd))
        outs["jax"][1].append(np.asarray(jh))
        outs["torch"][0].append(td.numpy())
        outs["torch"][1].append(th.numpy())
    (jd, jh), (td, th) = ([np.concatenate(x) for x in outs[k]]
                          for k in ("jax", "torch"))
    np.testing.assert_array_equal(th, whole_h)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(td, whole_d, rtol=RTOL)
    np.testing.assert_allclose(td, jd, rtol=RTOL)
    assert td[0] == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_whole_array_forms_match_jax(dtype):
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 255, (6, 20, 28)).astype(np.float32)
    frames[3:] = frames[3:] * 0.4 + 120  # a cut at 3
    frames = frames.astype(dtype)
    jf = jnp.asarray(frames.astype(np.float32))  # JAX's uint8 difference wraps
    j_scores = np.asarray(jcm.scene_change_scores(jf))
    j_corr = np.asarray(jcm.histogram_correlation(jf))
    t_scores = tcm.scene_change_scores(torch.from_numpy(frames)).numpy()
    t_corr = tcm.histogram_correlation(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL)
    np.testing.assert_allclose(t_corr, j_corr, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(
        tcm._binned_hist(torch.from_numpy(frames)).numpy(),
        np.asarray(jcm._binned_hist(jf, 32)))
    assert (tcm.detect_scene_changes(t_scores, t_corr, 20.0, 0.9)
            == jcm.detect_scene_changes(j_scores, j_corr, 20.0, 0.9) == [3])


def test_histogram_correlation_from_hists_bit_equal():
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 50, (40, 32)).astype(np.float32)
    hists = counts / counts.sum(-1, keepdims=True)
    np.testing.assert_array_equal(tcm.histogram_correlation_from_hists(hists),
                                  jcm.histogram_correlation_from_hists(hists))
    assert len(tcm.histogram_correlation_from_hists(np.zeros((0, 32)))) == 0


@pytest.mark.parametrize("min_windows", [20, 60])
def test_audio_rms_and_silence_match_jax(min_windows):
    """The JAX package's own silence input (tests/test_ops_filters.py):
    0.5 s of near-silence in 2 s of noise."""
    rng = np.random.default_rng(0)
    sr = 48000
    pcm = rng.normal(0, 0.3, sr * 2).astype(np.float32)
    pcm[sr // 2: sr] = rng.normal(0, 0.001, sr // 2)
    j = np.asarray(jcm.audio_rms_windows(jnp.asarray(pcm), sr // 100))
    t = tcm.audio_rms_windows(torch.from_numpy(pcm), sr // 100).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL)
    spans = tcm.detect_silence(t, threshold=0.01, min_windows=min_windows)
    assert spans == jcm.detect_silence(j, threshold=0.01,
                                       min_windows=min_windows)
    assert spans == ([(50, 100)] if min_windows <= 50 else [])


def test_detect_silence_run_at_the_end():
    rms = np.array([0.5, 0.001, 0.001, 0.5, 0.001, 0.001, 0.001])
    assert (tcm.detect_silence(rms, 0.01, 2)
            == jcm.detect_silence(rms, 0.01, 2) == [(1, 3), (4, 7)])


# ---------------------------------------------------------------------------
# models: one case = a function of one package's namespace -> plain data
# ---------------------------------------------------------------------------

PKGS = {
    "jax": SimpleNamespace(cma=jcma, jls=jjls, chapter=jchapter,
                           ctx=jcontext.AMTContext,
                           FormatError=jcontext.FormatError),
    "torch": SimpleNamespace(cma=tcma, jls=tjls, chapter=tchapter,
                             ctx=tcontext.AMTContext,
                             FormatError=tcontext.FormatError),
}


def sec(s):
    return int(s * FPS)


def broadcast():
    """tests/test_cm_analyze.py TestJlsDecider.make_broadcast: 0-60 s
    program, 60-90 s CM (2x15 s), 90-300 s program, 300-360 s CM (4x15 s),
    360-420 s program."""
    total = sec(420)
    logo_spans = [(0, sec(60)), (sec(90), sec(300)), (sec(360), total)]
    cuts = [0, sec(60), sec(75), sec(90), sec(300), sec(315), sec(330),
            sec(345), sec(360), total]
    scene_changes = cuts[1:-1] + [sec(150), sec(200)]
    silence = [(c - 3, c + 3) for c in cuts[1:-1]]
    return total, logo_spans, sorted(scene_changes), silence


def layout(total_s, cut_s, logo=None):
    """A layout of tests/test_jls_script.py: cuts in seconds, silence on
    every cut, logo spans in seconds (None: logo always on)."""
    total = sec(total_s)
    cuts = [sec(c) for c in cut_s]
    spans = ([(0, total)] if logo is None
             else [(sec(a), sec(b) if b is not None else total)
                   for a, b in logo])
    return total, spans, cuts, [(c - 3, c + 3) for c in cuts]


LAYOUTS = {
    "broadcast": broadcast(),
    "units20": layout(240, [100, 120, 140], [(0, 100), (140, None)]),
    "head_sponsor": layout(300, [15, 30]),
    "tail_sponsor": layout(300, [270, 285]),
    "interior_cm": layout(420, [180, 195, 210, 225, 240]),
}


def zones(zs):
    return [(z.start_frame, z.end_frame) for z in zs]


def result_data(r):
    return dict(trims=list(r.trims), divs=list(r.divs),
                cmzones=zones(r.cmzones), scene_changes=list(r.scene_changes),
                logopath=r.logopath)


def _raises(ns, fn):
    with pytest.raises(ns.FormatError) as e:
        fn()
    return type(e.value).__name__


FILE_CASES = {
    "trim_parse": lambda ns: ns.cma.parse_trim_avs(
        "Trim(0,100)++Trim(200,399)", 500),
    "trim_parse_case": lambda ns: ns.cma.parse_trim_avs("TRIM ( 5 , 10 )",
                                                        100),
    "trim_format": lambda ns: ns.cma.format_trim_avs([0, 101, 200, 400]),
    "trim_format_empty": lambda ns: ns.cma.format_trim_avs([]),
    "divs": lambda ns: [ns.cma.normalize_divs(d, 100)
                        for d in ([], [50], [0, 50])],
    "scpos_format": lambda ns: ns.cma.format_scene_changes_text(
        [10, 20, 300], [(5, 8), (40, 44)]),
    "scpos_parse": lambda ns: ns.cma.parse_scene_changes_text(
        "head\n----\n  SCPos: 10\nmute0: 1 - 2\n  SCPos: 300\n"),
    "scpos_no_header": lambda ns: _raises(
        ns, lambda: ns.cma.parse_scene_changes_text("SCPos: 1\n")),
    "cm_zones": lambda ns: zones(ns.cma.make_cm_zones([100, 200, 300, 400],
                                                      500)),
    "cm_zones_program": lambda ns: zones(ns.cma.make_cm_zones([0, 500], 500)),
    "cm_zones_bad": lambda ns: _raises(
        ns, lambda: ns.cma.make_cm_zones([300, 200], 500)),
}


def _decide(ns, name, logo=True, opts=None):
    total, spans, scs, silence = LAYOUTS[name]
    d = ns.cma.JlsDecider(total, FPS, opts(ns) if opts else None)
    return d.decide(spans if logo else None, scs, silence)


def _analyzer(ns, total=sec(420), **kw):
    return ns.cma.CMAnalyzer(ns.ctx(level="error"), total, FPS, **kw)


def _analyze_pmt(ns):
    total = sec(420)
    an = _analyzer(ns)
    scs = [sec(30), sec(60), sec(390)]
    r = result_data(an.analyze(None, 0.0, "", scs,
                               [(s - 3, s + 3) for s in scs]))
    an.result.trims = [0, total]
    an.apply_pmt_cut((0.2, 0.2), [0, sec(30) + 10, sec(200), sec(395)])
    return r, result_data(an.result)


def _logo_threshold(ns):
    return [_analyzer(ns, sec(60 * m), loose_logo_detection=loose)
            .logo_threshold() for m in (5, 30) for loose in (False, True)]


def _analyze_logo(ns, ratio):
    total, spans, scs, silence = LAYOUTS["broadcast"]
    return result_data(_analyzer(ns).analyze(spans, ratio, "logo.lgd", scs,
                                             silence))


def _trim_input(ns):
    an = _analyzer(ns, 1000)
    an.input_trim_avs("Trim(100,499)")
    return result_data(an.result)


MODEL_CASES = {
    **{f"decide_{n}": (lambda n: lambda ns: _decide(ns, n))(n)
       for n in LAYOUTS},
    "decide_broadcast_no_logo": lambda ns: _decide(ns, "broadcast", False),
    "decide_units20_tuned": lambda ns: _decide(
        ns, "units20", opts=lambda ns: ns.cma.JlsOptions(
            cm_units=(15.0, 20.0, 30.0))),
    "decide_all_program": lambda ns: ns.cma.JlsDecider(sec(120), FPS).decide(
        [(0, sec(120))], [sec(40)], []),
    "logo_threshold": _logo_threshold,
    "analyze_pmt_cut": _analyze_pmt,
    "analyze_logo": lambda ns: _analyze_logo(ns, 0.8),
    "analyze_logo_below_threshold": lambda ns: _analyze_logo(ns, 0.01),
    "input_trim_avs": _trim_input,
}

# (script, options, layout) of tests/test_jls_script.py
SCRIPTS = {
    "empty": ("# nothing but comments\n", "", "broadcast"),
    "if_off": ("If CUT_HEAD\n  AutoEdge S -sec 60\nElse\n  Set u 1\nEndIf\n",
               "", "broadcast"),
    "if_on": ("If CUT_HEAD\n  AutoEdge S -sec 60\nElse\n  Set u 1\nEndIf\n",
              "-CUT_HEAD", "broadcast"),
    **{f"elsif_{m}": ("If MODE == 1\n  AutoEdge S -sec 60\nElsIf MODE == 2\n"
                      "  AutoEdge E -sec 60\nElse\n  Set u 1\nEndIf\n",
                      f"-MODE {m}" if m else "", "broadcast")
       for m in (0, 1, 2)},
    "nested": ("If A\n  If B\n    AutoEdge S -sec 60\n  EndIf\nEndIf\n",
               "-A -B", "broadcast"),
    "set_default": ("Set X 5\nDefault X 9\nDefault Y 2\n"
                    "If X == 5 && Y < 3\n  AutoEdge S -sec 60\nEndIf\n", "",
                    "broadcast"),
    "predefined": ("If NOLOGO || DURATION > 600\n  AutoEdge S -sec 60\n"
                   "EndIf\n", "", "broadcast"),
    "not_parens": ("If !(A || B) && C != 2\n  AutoEdge E -sec 30\nEndIf\n",
                   "-C 3", "broadcast"),
    "cm_unit": ("SetParam CmUnit 15,20,30\n", "", "units20"),
    "params": ("SetParam UnitTolerance 1.0\nSetParam SilenceSceneWindow 2\n"
               "SetParam MinProgramSec 20\nSetParam DivCmSec 40\n", "",
               "broadcast"),
    "nologo": ("SetParam NoLogo 1\n", "", "broadcast"),
    "autoup": ("AutoUp\n", "", "broadcast"),
    "mklogo": ("MkLogo -inmargin 40\n", "", "broadcast"),
    "margins": ("SetParam LogoMarginIn 2\nSetParam LogoMarginOut -3\n", "",
                "broadcast"),
    "autocut_s": ("AutoCut S\n", "", "head_sponsor"),
    "autocut_limit": ("AutoCut S -limit 20\n", "", "head_sponsor"),
    "autocut_e": ("AutoCut E\n", "", "tail_sponsor"),
    "autocut_b": ("AutoCut B\n", "", "head_sponsor"),
    "autoadd_s": ("AutoAdd S -sec 15\n", "", "broadcast"),
    "autoadd_e": ("AutoAdd E\n", "", "broadcast"),
    "autoedge_b": ("AutoEdge B -sec 20\n", "", "broadcast"),
    "autocm_60": ("AutoCM -len 60\n", "", "interior_cm"),
    "autocm_90": ("AutoCM -len 90\n", "", "interior_cm"),
    "autodel": ("AutoDel -from 90 -to 300\n", "", "broadcast"),
    "autoins": ("AutoIns -from 300 -to 360\n", "", "broadcast"),
}
BAD_SCRIPTS = ["If X\n", "Bogus 1\n", "Else\n", "Set X\n", "EndIf\n",
               "ElsIf X\n", "If (X\nEndIf\n", "If X Y\nEndIf\n",
               "SetParam Nope 1\n", "AutoCut\n"]


def _jls_run(ns, text, options, name, logo=True):
    total, spans, scs, silence = LAYOUTS[name]
    return ns.jls.JlsScript(text, options).run(
        total, FPS, spans if logo else None, scs, silence)


def _elements(ns):
    E = ns.chapter.JlsElement
    return [E(0, 450, 15, "CM"), E(450, 5000, 150, "Body"),
            E(5000, 9450, 148, "Trailer"), E(9450, 9900, 15, "CM"),
            E(9900, 9930, 1, "Tiny"), E(9930, 12000, 69, ""),
            E(12000, 13800, 60, "Body2")]


def _chapters(ns, trims):
    maker = ns.chapter.ChapterMaker(trims, _elements(ns))
    base = [vars(c) for c in maker.chapters]
    out = maker.file_chapters(list(range(0, 13800, 1)), 30.0)
    text = ns.chapter.ChapterMaker.format_chapters(out, 30000, 1001)
    return base, [vars(c) for c in out], text


CHAPTER_CASES = {
    "jls_format": lambda ns: ns.chapter.format_jls(_elements(ns)),
    "jls_parse": lambda ns: [vars(e) for e in ns.chapter.parse_jls(
        ns.chapter.format_jls(_elements(ns))
        + "   10    20    1    0    0\nnot a line\n")],
    "chapters_cut_head": lambda ns: _chapters(ns, [450, 9450]),
    "chapters_program": lambda ns: _chapters(ns, [0, 13800]),
    "chapters_many": lambda ns: _chapters(ns, [450, 9450, 9930, 12000]),
    "chapters_none": lambda ns: vars(ns.chapter.ChapterMaker([0, 10], [])),
}


def _same(case):
    want = case(PKGS["jax"])
    got = case(PKGS["torch"])
    assert got == want
    return got


@pytest.mark.parametrize("name", sorted(FILE_CASES))
def test_file_contracts_match_jax(name):
    _same(FILE_CASES[name])


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_cm_decision_matches_jax(name):
    _same(MODEL_CASES[name])


def test_cm_decision_cases_decide_something():
    """The cases are not vacuous: the broadcast layout's two CM runs are
    found, and the tuned CM unit changes the 20 s layout's decision."""
    trims, _ = _same(MODEL_CASES["decide_broadcast"])
    cms = zones(tcma.make_cm_zones(trims, sec(420)))
    assert (sec(60), sec(90)) in cms and (sec(300), sec(360)) in cms
    assert (_same(MODEL_CASES["decide_units20"])
            != _same(MODEL_CASES["decide_units20_tuned"]))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_jls_script_matches_jax(name):
    text, options, lay = SCRIPTS[name]
    for logo in (True, False):
        _same(lambda ns: _jls_run(ns, text, options, lay, logo))


@pytest.mark.parametrize("text", BAD_SCRIPTS)
def test_jls_script_errors_match_jax(text):
    _same(lambda ns: _raises(ns, lambda: _jls_run(ns, text, "", "broadcast")))


def test_jls_script_call_and_analyzer(tmp_path):
    """Call includes a file beside the script; CMAnalyzer runs the script
    in place of the decider."""
    (tmp_path / "inner.txt").write_text("AutoEdge S -sec 60\n")
    (tmp_path / "main.txt").write_text("Set Q 1\nIf Q\n  Call inner.txt\n"
                                       "EndIf\n")
    total, spans, scs, silence = LAYOUTS["broadcast"]

    def case(ns):
        script = ns.jls.JlsScript.from_file(str(tmp_path / "main.txt"),
                                            "-x 1")
        r = _analyzer(ns, jls_script=script).analyze(
            spans, 0.8, "logo.lgd", scs, silence)
        return result_data(r)

    got = _same(case)
    assert got["trims"][0] >= sec(60)


def test_options_string_matches_jax():
    s = "-flag -name value -n 3 bare"
    assert tjls._parse_options_string(s) == jjls._parse_options_string(s)


@pytest.mark.parametrize("name", sorted(CHAPTER_CASES))
def test_chapters_match_jax(name):
    _same(CHAPTER_CASES[name])


def test_format_error_is_the_ports():
    assert issubclass(tcontext.FormatError, tcontext.AMTError)
    assert tcma.FormatError is tjls.FormatError is tcontext.FormatError
