"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and chip_smoke.py refuses to run without a CUDA card."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "amatsukaze_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_fresh_import_loads_no_jax():
    """Every module of the port in a fresh interpreter: neither jax nor
    amatsukaze_tpu ends up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import amatsukaze_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or"
        " k.startswith('jax.') or k == 'amatsukaze_tpu' or"
        " k.startswith('amatsukaze_tpu.'))\n"
        "print(len(list(pkgutil.walk_packages(pkg.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# The TS front end (copies of the JAX package's host layers) and its test
# data writer: each imports alone, without JAX.
FRONT_END = [
    "reform", "reform.stream_reform", "pipeline.settings", "io",
    "io.ps_writer", "audio", "audio.aac_tables", "audio.aac",
    "audio.sbr_tables", "audio.sbr", "audio.ps_tables", "audio.ps",
    "audio.aac_native", "captions", "captions.arib", "captions.b24",
    "ts.info", "pipeline.splitter", "pipeline.probe", "video",
    "video.mpeg2_ref", "video.native", "video.avdec", "pipeline.decoders",
    "pipeline.frame_source", "ts.qp_extract", "utils.synth_ts",
]
# The encode/mux side and the entry points (copies of the JAX package's
# host layers, and the port's own pipeline/transcode.py and cli.py).
ENCODE_SIDE = [
    "io.process", "io.y4m", "io.wave", "io.audio_encoder", "io.muxer",
    "pipeline.encoder_options", "captions.formatters", "captions.nicojk",
    "captions.nicojk18", "tools", "tools.x264_shim", "tools.aac_shim",
    "models.vfr", "pipeline.cm_stage", "pipeline.filter_stage",
    "pipeline.transcode", "pipeline.simple", "cli",
]
# The encode server and the rest of the side tools (copies of the JAX
# package's; server/__main__.py starts its host only when run).
SERVER = [
    "parallel.scheduler", "server", "server.__main__", "server.cli",
    "server.drcs", "server.filter_setting", "server.genre", "server.rename",
    "server.rpc", "server.server", "server.web", "tools.add_task",
    "tools.file_cutter", "tools.hash_check", "tools.script_command",
    "tools.user_script",
]
# The pure-Python H.264/H.265 decoders (copies of the JAX package's oracles,
# the in-build decoders' fallback where the native engines did not build).
DECODERS = [
    "video.h264_tables", "video.h264_cabac", "video.h264_ref",
    "video.h264_paff", "video.h264_mbaff", "video.h265_tables",
    "video.h265_ref",
]


@pytest.mark.parametrize("module", FRONT_END + ENCODE_SIDE + SERVER + DECODERS)
def test_front_end_module_imports_alone(module):
    code = (f"import sys, importlib\n"
            f"importlib.import_module('amatsukaze_tpu_torch.{module}')\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'amatsukaze_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (PKG / (module.replace(".", "/") + ".py")).exists() or \
        (PKG / module.replace(".", "/") / "__init__.py").exists()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "amatsukaze_tpu"), (
                f"{path.name} imports {n}")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no card: the script exits non-zero and prints no
    result line, both in the checkout and alone in an empty directory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
