"""H.264 and HEVC broadcast streams through the port's CLI, against the JAX
package's CLI and against the same stream coded as MPEG-2.

utils/synth_ts.py writes the 96x128 short broadcast layout (program with
the logo, CM, program) as MPEG-2, then the MPEG-2 reconstruction again as
lossless H.264 and HEVC PCM pictures with the same audio, timestamps and
PIDs. Each TS goes through `cli.main` in kfm_vfr with the fake encoder,
the logo and the in-build decoders (`--h264decoder native`): with the
native engines, and with them patched off, so that the pure-Python oracles
decode. The JAX CLI runs the same argument list on its device path (its
Pallas kernels in interpret mode, as its own tests run them).

Tolerances: within one package every output file is byte-equal to its
MPEG-2 run's, and the trims equal; between the packages the temp files are
byte-equal and the output frames equal but at the erase rounding ties
(tests/test_torch_transcode.py's rule: pixels of the logo box, one code
value apart; ROADMAP.md Queue 3 item 1). An H.264 stream whose SPS crops
(80 lines coded as 96) equals its MPEG-2 run in the port. The MPEG-2 TS is
byte-equal to what the writer wrote before it learned the other codecs.
"""

import glob
import hashlib
import os

import pytest
from test_torch_transcode import (FAKE_ENCODER, _assert_ties_only,
                                  _yadif_as_on_tpu)
from torch_compare import load_both_native
from torch_threads import one_torch_thread  # noqa: F401

import amatsukaze_tpu.models.filter_graph as jfg_mod
import amatsukaze_tpu.models.logo as jlogo_model
from amatsukaze_tpu import cli as jcli
from amatsukaze_tpu.video import native as jnative

from amatsukaze_tpu_torch import cli as tcli
from amatsukaze_tpu_torch.models.lgd import save_lgd
from amatsukaze_tpu_torch.utils import synth_clip, synth_ts
from amatsukaze_tpu_torch.video import native as tnative

# sha256 of ts_clip("small") as MPEG-2, from the writer before it took a
# video codec
MPEG2_SMALL_SHA256 = \
    "9b45876e5070658b35839ebed578cfb03740c6fec3412e108103299c73208523"
CROPPED_ROWS = 80


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The MPEG-2 TS, its H.264 and HEVC twins, the same at 80x128, the
    logo as an .lgd file and the fake encoder."""
    load_both_native()
    base = tmp_path_factory.mktemp("h26x")
    seed = synth_ts.TS_CLIPS["small"]["seed"]
    ts, _, logos = synth_ts.ts_clip("small", str(base / "mpeg2.ts"))
    spec = dict(synth_ts.TS_CLIPS["small"], h=CROPPED_ROWS)
    frames = synth_clip.make_broadcast_clip(
        **spec, scenes=synth_ts.TS_SCENES, num_frames=synth_ts.TS_FRAMES)
    short = synth_ts.write_ts(str(base / "mpeg2_80.ts"), frames,
                              synth_ts.TS_FRAMES,
                              synth_ts.silent_around_cuts, seed)
    for video in ("h264", "h265"):
        for src, name in ((ts, video), (short, f"{video}_80")):
            out = synth_ts.write_ts(str(base / f"{name}.ts"), iter(src.recon),
                                    synth_ts.TS_FRAMES,
                                    synth_ts.silent_around_cuts, seed, video)
            assert out.audio_frames == src.audio_frames
            assert out.pts == src.pts
    lgd = str(base / "logo0.lgd")
    save_lgd(lgd, logos[0])
    enc = base / "fake_x264"
    enc.write_text(FAKE_ENCODER)
    enc.chmod(0o755)
    return dict(base=base, lgd=lgd, logo=logos[0], enc=str(enc))


def _run(src: dict, side: str, name: str, decoder: str) -> dict:
    """One CLI run over `name`.ts in kfm_vfr: the output files, the temp
    files and the trims. decoder "oracle" patches the native H.264/HEVC
    engines off in both packages."""
    run_dir = src["base"] / f"{name}_{decoder}_{side}"
    os.makedirs(run_dir)
    argv = ["-i", str(src["base"] / f"{name}.ts"), "-o", str(run_dir / "out"),
            "-w", str(run_dir), "-e", src["enc"], "-j",
            str(run_dir / "report.json"), "--logo", src["lgd"],
            "--filter-mode", "kfm_vfr", "--mpeg2decoder", "native",
            "--h264decoder", "native", "--no-remove-tmp"]
    with pytest.MonkeyPatch.context() as mp:
        if decoder == "oracle":
            for mod in (tnative, jnative):
                mp.setattr(mod, "h264_native_available", lambda: False)
                mp.setattr(mod, "h265_native_available", lambda: False)
        if side == "port":
            assert tcli.main(argv, device="cpu") == 0
        else:
            mp.setattr(jlogo_model, "_HOST_OPS", False)  # device path
            mp.setenv("AMATSUKAZE_SCENE_METRICS", "device")
            mp.setenv("AMATSUKAZE_FILTER_BACKEND", "device")
            mp.setattr(jfg_mod.FilterGraph, "_fused_yadif", _yadif_as_on_tpu)
            assert jcli.main(argv) == 0
    (tmp,) = glob.glob(str(run_dir / "amt*"))
    temp = {}
    for f in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, f), "rb") as fh:
            temp[f] = fh.read()
    outs = {f: (run_dir / f).read_bytes() for f in sorted(os.listdir(run_dir))
            if f.startswith("out") and (run_dir / f).is_file()}
    return dict(outs=outs, temp=temp, trims=temp["trim0.avs"])


@pytest.fixture(scope="module")
def runs(sources):
    done = {}

    def get(side, name, decoder="native"):
        key = (side, name, decoder)
        if key not in done:
            done[key] = _run(sources, side, name, decoder)
        return done[key]

    return get


@pytest.mark.parametrize("decoder", ["native", "oracle"])
@pytest.mark.parametrize("codec", ["h264", "h265"])
@pytest.mark.parametrize("side", ["port", "jax"])
def test_h26x_ts_equals_its_mpeg2_ts(runs, side, codec, decoder):
    if decoder == "native" and not getattr(
            tnative, f"{codec}_native_available")():
        pytest.skip(f"native {codec} engine unavailable")
    got, want = runs(side, codec, decoder), runs(side, "mpeg2")
    assert got["outs"] and list(got["outs"]) == list(want["outs"])
    for f, data in got["outs"].items():
        assert data == want["outs"][f], f
    assert got["trims"] == want["trims"]
    assert got["temp"]["logof0.txt"] == want["temp"]["logof0.txt"]


@pytest.mark.parametrize("decoder", ["native", "oracle"])
@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_h26x_ts_port_equals_jax(runs, sources, codec, decoder):
    if decoder == "native" and not getattr(
            tnative, f"{codec}_native_available")():
        pytest.skip(f"native {codec} engine unavailable")
    port, jax = runs("port", codec, decoder), runs("jax", codec, decoder)
    assert list(port["temp"]) == list(jax["temp"])
    for f, data in port["temp"].items():
        assert data == jax["temp"][f], f
    assert list(port["outs"]) == list(jax["outs"])
    for f in port["outs"]:
        _assert_ties_only(port["outs"][f], jax["outs"][f], sources["logo"],
                          f"{codec} {decoder} {f}")


@pytest.mark.parametrize("decoder", ["native", "oracle"])
def test_cropped_h264_ts_equals_its_mpeg2_ts(runs, decoder):
    """80 lines coded as 96 (frame_mbs_only_flag 0: whole 32-line pairs)
    and cropped by the SPS: neither in-build decoder crops, the port's
    decode does."""
    if decoder == "native" and not tnative.h264_native_available():
        pytest.skip("native h264 engine unavailable")
    got, want = runs("port", "h264_80", decoder), runs("port", "mpeg2_80")
    (data,) = got["outs"].values()
    assert data.startswith(b"YUV4MPEG2 W128 H80 ")
    assert got["outs"] == want["outs"]
    assert got["trims"] == want["trims"]


def test_mpeg2_ts_is_unchanged(sources):
    data = (sources["base"] / "mpeg2.ts").read_bytes()
    assert hashlib.sha256(data).hexdigest() == MPEG2_SMALL_SHA256
