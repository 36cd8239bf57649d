"""Headless encode-server host (ref AmatsukazeServerCLI/ServerCLI.cs:8-50)
and the GUI launch-mode analogs (ref AmatsukazeGUI/App.xaml.cs:45-57).

Launch modes:

- server/standalone (default): EncodeServer RPC endpoint + the browser
  client in one process (the reference's Standalone mode; Server mode
  is ``--web-port -1``):

      python -m amatsukaze_tpu_torch.server.cli --data ./data --port 32768 --web-port 8080

- client: only the browser client runs locally; every /api request
  rides the TCP RPC protocol to a remote EncodeServer (the reference's
  Client mode):

      python -m amatsukaze_tpu_torch.server.cli --client otherhost:32768 --web-port 8080

The port's copy of amatsukaze_tpu/server/cli.py.
"""

from __future__ import annotations

import argparse
import asyncio
import os

from ..utils.context import AMTContext
from .server import EncodeServer
from .web import WebServer


class RemoteServer:
    """RPC proxy backing the web client in ``--client`` mode.

    Exposes the same ``handle_request`` surface the in-process
    EncodeServer gives the web host, forwarded over one TCP RPC
    connection (reconnecting on failure).  File-backed extras (logo /
    DRCS images, frame scrub) use local paths when they are visible
    from this machine — the WPF client behaves the same way on shared
    network mounts — and 404 otherwise."""

    def __init__(self, host: str, port: int, data_dir: str):
        self.host = host
        self.port = port
        self.data_dir = data_dir
        self._client = None
        self._lock = asyncio.Lock()

    async def handle_request(self, method: str, payload):
        import asyncio as _asyncio

        from .rpc import RpcClient

        async with self._lock:
            for attempt in (0, 1):
                if self._client is None:
                    self._client = await RpcClient.connect(self.host,
                                                           self.port)
                try:
                    # call() returns None on EOF (clean server restart /
                    # handler that kills the connection) — that is a
                    # connection loss, not a reply; and a handler that
                    # never replies must not hang the UI forever.  A
                    # TIMEOUT surfaces without retry: the request may
                    # have been processed and re-issuing a write RPC
                    # could double-apply it.
                    reply = await _asyncio.wait_for(
                        self._client.call(method, payload), timeout=30)
                    if reply is None:
                        raise ConnectionError("RPC connection closed")
                    return reply
                except (ConnectionError, OSError,
                        _asyncio.TimeoutError) as e:
                    client, self._client = self._client, None
                    if client is not None:
                        try:
                            client.close()
                        except Exception:  # noqa: BLE001 - already broken
                            pass
                    if attempt or isinstance(e, _asyncio.TimeoutError):
                        raise

    def logo_dir(self) -> str:
        return os.path.join(self.data_dir, "logo")

    def drcs_dir(self) -> str:
        return os.path.join(self.data_dir, "drcs")

    def _default_logo_frames(self, src: str):
        # same standalone opener as the server's wizard (no self state)
        return EncodeServer._default_logo_frames(self, src)


async def serve_client(args) -> None:
    if args.web_port < 0:
        # client mode IS the web UI; a disabled web port would just idle
        raise SystemExit("--client requires --web-port >= 0")
    host, _, port = args.client.rpartition(":")
    if not host:
        host, port = args.client, "32768"
    web = WebServer(RemoteServer(host, int(port), args.data))
    wport = await web.start(host=args.host, port=args.web_port)
    print(f"Web client on http://{args.host}:{wport}/ "
          f"-> RPC {host}:{port}")
    try:
        await asyncio.Event().wait()  # until interrupted
    except asyncio.CancelledError:
        pass
    finally:
        await web.stop()


async def serve(args, device=None) -> None:
    if args.host not in ("127.0.0.1", "localhost", "::1"):
        print("WARNING: binding RPC + web UI to a non-loopback host "
              f"({args.host}). Anyone who can reach these ports can "
              "manage the encode queue and server settings — only do "
              "this on a trusted network.")
    ctx = AMTContext()
    server = EncodeServer(ctx, data_dir=args.data, device=device)
    port = await server.start(host=args.host, port=args.port)
    print(f"RPC listening on {args.host}:{port}")
    web = None
    if args.web_port >= 0:
        web = WebServer(server)
        wport = await web.start(host=args.host, port=args.web_port)
        print(f"Web client on http://{args.host}:{wport}/")
    try:
        # run until interrupted or an EndServer RPC arrives (ref
        # ServerCLI.cs finishRequested wait)
        while not server.end_requested.is_set():
            try:
                await asyncio.wait_for(server.end_requested.wait(), 60)
            except asyncio.TimeoutError:
                server.save_app_data()
    except asyncio.CancelledError:
        pass
    finally:
        if web is not None:
            await web.stop()
        await server.stop()


def main(argv=None, device=None) -> int:
    """Run the host; `device` is None for the CUDA card (RuntimeError where
    there is none), "cpu" for the plain PyTorch versions."""
    p = argparse.ArgumentParser(prog="amatsukaze-server")
    p.add_argument("--data", default="./data", help="app data directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=32768, help="RPC port")
    p.add_argument("--web-port", type=int, default=8080,
                   help="web client port (-1 disables)")
    p.add_argument("--client", metavar="HOST[:PORT]", default=None,
                   help="client launch mode: serve only the web UI "
                        "locally, RPC to a remote EncodeServer (ref "
                        "GUI launch type Client)")
    args = p.parse_args(argv)
    try:
        asyncio.run(serve_client(args) if args.client
                    else serve(args, device))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
