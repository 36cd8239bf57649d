"""Test configuration.

Device-kernel tests run on a virtual 8-device CPU mesh so multi-chip sharding
is exercised without TPU hardware (the driver separately dry-run-compiles the
multi-chip path via __graft_entry__.dryrun_multichip).
"""

import os

# Must be set before jax initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent XLA compile cache: kernel tests are compile-bound on this
# single-core host; caching makes re-runs ~instant.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/amatsukaze_jax_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

# A site-installed accelerator plugin may force its own platform via
# jax.config at interpreter start (overriding the env var); force CPU back.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import faulthandler  # noqa: E402

import pytest  # noqa: E402

# Hard per-test watchdog (VERDICT r4 item 2): round 4's full-suite run
# wedged inside an XLA helper thread (kernel-level spin, SIGKILL-immune)
# and poisoned the bench host for the rest of the round.  faulthandler's
# watchdog runs in a dedicated C thread that does not depend on the GIL
# or on any Python thread making progress: if ONE test exceeds the cap it
# dumps every thread's traceback to stderr and hard-exits the process,
# so a wedge costs at most TEST_HARD_TIMEOUT seconds instead of the
# whole round.
_TEST_HARD_TIMEOUT = float(os.environ.get("AMATSUKAZE_TEST_TIMEOUT", "600"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(_TEST_HARD_TIMEOUT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


# Whole-session backstop OUTSIDE the process.  Root-caused in round 5:
# the round-4/5 "SIGKILL-immune" wedge is an accelerator-plugin helper
# thread running at SCHED_FIFO priority 99 that enters a spin — a
# prio-99 RT thread preempts every CFS task (it holds exactly the 95%
# RT-throttle budget, the round-4 symptom), never deschedules, so
# pending SIGKILL/SIGSTOP are never delivered, the freezer reports
# FREEZING forever, and the in-process faulthandler watchdog's _exit
# blocks on reaping the spinner.  The antidote is scheduling-class
# demotion FROM OUTSIDE, per thread (Linux nice/chrt are per-TID):
# chrt SCHED_IDLE instantly drops the spinner to 0% CPU, the host
# unpoisons, and the pending SIGKILL lands as soon as the thread
# blocks.  A detached reaper applies that past a session wall-clock
# cap, then kills the process.
_SUITE_CAP = float(os.environ.get("AMATSUKAZE_SUITE_TIMEOUT", "1200"))
if _SUITE_CAP > 0:
    import subprocess as _sp
    import sys as _sys

    def _proc_start(pid: int) -> str:
        # /proc/<pid>/stat field 22 (starttime) — identity guard so a
        # recycled PID is never demoted/killed by a stale reaper
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[19]
        except OSError:
            return ""

    _reaper_script = (
        "import os,signal,sys,time\n"
        f"pid = {os.getpid()}\n"
        f"stamp = {_proc_start(os.getpid())!r}\n"
        "def start(p):\n"
        "    try:\n"
        "        with open(f'/proc/{p}/stat') as f:\n"
        "            return f.read().rsplit(')', 1)[1].split()[19]\n"
        "    except OSError:\n"
        "        return None\n"
        f"time.sleep({_SUITE_CAP})\n"
        "if start(pid) != stamp:\n"
        "    sys.exit(0)  # suite exited (PID free or recycled)\n"
        "for t in os.listdir(f'/proc/{pid}/task'):\n"
        "    os.system(f'chrt -i -p 0 {t} >/dev/null 2>&1')\n"
        "    os.system(f'renice -n 19 -p {t} >/dev/null 2>&1')\n"
        "if start(pid) == stamp:\n"
        "    try:\n"
        "        os.kill(pid, signal.SIGKILL)\n"
        "    except OSError:\n"
        "        pass\n"
    )
    # -I -S: isolated, no site imports — a plain interpreter sleeping,
    # not a 150+MB site-hook load per reaper
    _sp.Popen([_sys.executable, "-I", "-S", "-c", _reaper_script],
              start_new_session=True,
              stdout=_sp.DEVNULL, stderr=_sp.DEVNULL)
    # pytest subprocesses spawned BY tests inherit this env: one reaper
    # per top-level suite, not one per nested run
    os.environ["AMATSUKAZE_SUITE_TIMEOUT"] = "0"


@pytest.fixture
def ctx():
    from amatsukaze_tpu.utils import AMTContext

    return AMTContext(level="error")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: takes minutes on one core; deselect with "
        "-m 'not slow'")
