"""ScriptCommand: call server RPCs from inside a user script.

Parity: ScriptCommand/Program.cs:15-27 — the reference talks over inherited
pipe handles; here the connection info comes from AMT_SERVER_HOST/PORT env
vars set by tools/user_script.py. Usage from a script:

  python -m amatsukaze_tpu_torch.tools.script_command AddTag mytag
  python -m amatsukaze_tpu_torch.tools.script_command SetPriority 5
  python -m amatsukaze_tpu_torch.tools.script_command GetOutFiles
  python -m amatsukaze_tpu_torch.tools.script_command CancelItem

The port's copy of amatsukaze_tpu/tools/script_command.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys

from ..server.rpc import RpcClient


async def run_command(argv) -> int:
    if not argv:
        print("usage: script_command <AddTag|SetPriority|GetOutFiles|"
              "CancelItem> [arg]", file=sys.stderr)
        return 2
    host = os.environ.get("AMT_SERVER_HOST", "127.0.0.1")
    port = int(os.environ.get("AMT_SERVER_PORT", "0"))
    item_id = int(os.environ.get("ITEM_ID", "-1"))
    if port <= 0 or item_id < 0:
        print("not running under a user script (AMT_SERVER_PORT/ITEM_ID "
              "unset)", file=sys.stderr)
        return 2
    method = argv[0]
    payload = {"item_id": item_id}
    if method == "AddTag":
        payload["tag"] = argv[1]
    elif method == "SetPriority":
        payload["priority"] = int(argv[1])
    client = await RpcClient.connect(host, port)
    res = await client.call(method, payload)
    print(json.dumps(res, ensure_ascii=False))
    return 0 if (res or {}).get("ok", True) else 1


def main(argv=None) -> int:
    return asyncio.run(run_command(argv if argv is not None
                                   else sys.argv[1:]))


if __name__ == "__main__":
    raise SystemExit(main())
