"""AddTask: submit a recording to the encode server (EDCB post-record hook).

Parity: AmatsukazeAddTask (AmatsukazeAddTask/AddTaskMain.cs:1-474): connect
to the server over TCP, AddQueue the file with profile/priority, optionally
copying to a NAS dir first (with SHA-512 recorded for the server's hash-dir
verification), waking the server host with a Wake-on-LAN magic packet
and/or autostarting a local server when nothing is listening.

The port's copy of amatsukaze_tpu/tools/add_task.py.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import sys


def wol_magic_packet(mac: str) -> bytes:
    """6x 0xFF + 16 repetitions of the MAC (AMD magic packet format)."""
    parts = mac.replace("-", ":").split(":")
    if len(parts) != 6:
        raise ValueError(f"bad MAC address: {mac}")
    raw = bytes(int(p, 16) for p in parts)
    return b"\xff" * 6 + raw * 16


def send_wol(mac: str, broadcast: str = "255.255.255.255",
             port: int = 9) -> None:
    """Wake the server host (ref AddTaskMain's WoL before connecting)."""
    pkt = wol_magic_packet(mac)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        s.sendto(pkt, (broadcast, port))


async def _connect_with_retry(host, port, wake_mac=None, autostart=False,
                              attempts=10, delay=1.0):
    from ..server.rpc import RpcClient

    spawned = False
    for attempt in range(attempts):
        try:
            return await RpcClient.connect(host, port)
        except OSError:
            if attempt == 0 and wake_mac:
                send_wol(wake_mac)
            if (autostart and not spawned
                    and host in ("127.0.0.1", "localhost")):
                # launch a local server (ref ServerSupport.LaunchLocalServer)
                await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "amatsukaze_tpu_torch.server",
                    "--port", str(port),
                    stdout=asyncio.subprocess.DEVNULL,
                    stderr=asyncio.subprocess.DEVNULL,
                )
                spawned = True
            await asyncio.sleep(delay)
    raise ConnectionError(f"server at {host}:{port} not reachable")


async def add_task(host: str, port: int, src: str, out: str | None,
                   profile: str, priority: int, service_id: int,
                   nas_dir: str | None = None, wake_mac: str | None = None,
                   autostart: bool = False) -> dict:
    from .hash_check import append_hash, copy_with_hash

    if nas_dir:
        os.makedirs(nas_dir, exist_ok=True)
        dst = os.path.join(nas_dir, os.path.basename(src))
        digest = copy_with_hash(src, dst)
        append_hash(os.path.join(nas_dir, "hash.txt"),
                    os.path.basename(src), digest)
        src = dst
    client = await _connect_with_retry(host, port, wake_mac, autostart)
    res = await client.call("AddQueue", {
        "src": src,
        "out": out or (os.path.splitext(src)[0] + ".out"),
        "profile": profile,
        "priority": priority,
        "service_id": service_id,
    })
    return res or {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="amatsukaze-addtask")
    p.add_argument("src")
    p.add_argument("-o", "--out")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=32768)
    p.add_argument("-s", "--profile", default="default")
    p.add_argument("--priority", type=int, default=3)
    p.add_argument("--service-id", type=int, default=-1)
    p.add_argument("--nas-dir")
    p.add_argument("--wake-mac", help="send a Wake-on-LAN packet to this "
                                      "MAC before connecting")
    p.add_argument("--autostart", action="store_true",
                   help="launch a local server if none is listening")
    args = p.parse_args(argv)
    res = asyncio.run(add_task(args.host, args.port, args.src, args.out,
                               args.profile, args.priority, args.service_id,
                               args.nas_dir, args.wake_mac, args.autostart))
    print(json.dumps(res, ensure_ascii=False))
    return 0 if "item_id" in res else 1


if __name__ == "__main__":
    raise SystemExit(main())
