"""Pre/post/add user-script execution with item environment variables.

Parity: UserScriptExecuter (AmatsukazeServer/Server/UserScriptExecuter.cs:
1-403): runs the profile's pre_bat/post_bat/add_bat with ITEM_* env vars
describing the queue item + result, plus the connection info the
`script_command` tool uses to call back into the server (AddTag /
SetPriority / GetOutFiles / CancelItem).

The port's copy of amatsukaze_tpu/tools/user_script.py.
"""

from __future__ import annotations

import asyncio
import os


def item_environment(entry, phase: str, server_host: str = "127.0.0.1",
                     server_port: int = 0, result: dict | None = None) -> dict:
    """Environment block for a user script (ref :100-210's ITEM_* set)."""
    env = dict(os.environ)
    env.update({
        "ITEM_ID": str(entry.item_id),
        "IN_PATH": entry.src_path,
        "OUT_PATH": entry.out_path,
        "SERVICE_ID": str(entry.service_id),
        "ITEM_MODE": phase,  # add / pre / post
        "PROFILE": entry.profile_name,
        "PRIORITY": str(entry.priority),
        "TAG": ",".join(entry.tags),
        "AMT_SERVER_HOST": server_host,
        "AMT_SERVER_PORT": str(server_port),
    })
    if result is not None:
        env["SUCCESS"] = "1" if result.get("ok") else "0"
        env["ERROR_MESSAGE"] = str(result.get("error", ""))
        env["OUT_FILES"] = ";".join(result.get("out_files", []))
    return env


async def run_user_script(ctx, script_path: str, entry, phase: str,
                          server_host: str = "127.0.0.1",
                          server_port: int = 0,
                          result: dict | None = None,
                          timeout: float = 600.0) -> int:
    """Run one user script; returns the exit code (ref RunScript)."""
    if not script_path:
        return 0
    if not os.path.exists(script_path):
        # a CONFIGURED script that is missing must be loud: silently
        # skipping means the user's automation never runs and nothing
        # anywhere says why
        ctx.error("user script not found: %s (%s phase skipped)",
                  script_path, phase)
        return 0
    env = item_environment(entry, phase, server_host, server_port, result)
    ctx.info("[user script] %s (%s)", script_path, phase)
    proc = await asyncio.create_subprocess_exec(
        script_path,
        env=env,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT,
    )
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        ctx.error("user script timed out: %s", script_path)
        return -1
    for line in out.decode(errors="replace").splitlines():
        ctx.info("[script] %s", line)
    return proc.returncode
