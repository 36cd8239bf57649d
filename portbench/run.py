"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the CUDA card of this machine (exits 1, printing no result, without
one). The last line of standard output is the result object; the numbers
that decided `correct`, each beside its limit, are the last lines of
standard error.

The run's host threads are fixed, whatever the environment says: torch's
intra-op pool, OpenMP and BLAS pools and the native decoder's slice threads
each HOST_THREADS (half of the card's 8-core host), so that a run leaves
the program's own threads (the pump, the encoder, the pipes' drains) the
other half, and runs of one cell spread by what the host does, not by how
many threads race for it."""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "amatsukaze_tpu")
HOST_THREADS = 4
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "AMATSUKAZE_DECODE_THREADS")


def process_start() -> float:
    """The perf_counter reading at which this process started (from
    /proc; the first statement's reading where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot: amatsukaze_tpu_torch passes)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (REPO_DIR / "BENCHMARK.json").exists() or not (
            REPO_DIR / "amatsukaze_tpu_torch").is_dir():
        log("portbench: run from a checkout of the repository (BENCHMARK.json"
            " and amatsukaze_tpu_torch/ beside portbench/)")
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    for var in THREAD_VARS:
        os.environ[var] = str(HOST_THREADS)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(BENCH_DIR / "cache" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(BENCH_DIR / "cache" / "triton"))
    sys.path.insert(0, str(REPO_DIR))
    sys.path.insert(0, str(BENCH_DIR))
    import torch

    torch.set_num_threads(HOST_THREADS)
    from pb.harness import run_cell
    from pb.spec import load_cell

    cell = load_cell(args.workload)
    n = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"portbench: the cell needs {n} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                   log=log)
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"portbench: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    lines = out.pop("compared_lines")
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
