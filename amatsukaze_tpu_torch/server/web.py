"""Web client host for the encode server (GUI layer analog).

The reference ships a WPF GUI (AmatsukazeGUI/, SURVEY.md L7) talking RPC to
the server. The rebuild serves a browser client instead: this
module is a small asyncio HTTP/1.1 server that

- serves the single-file UI (`webui.html`) at ``/``,
- maps ``POST /api/<Method>`` (JSON body) onto ``EncodeServer.handle_request``
  — the same RPC surface the TCP protocol uses,
- renders ``.lgd`` logo files as PNG at ``/logo/<file>.png``
  (ref LogoGUISupport.hpp's LogoFile render-on-grey),
- serves unmapped DRCS bitmaps at ``/drcs/<md5>.bmp`` for the mapping UI,
- decodes REAL video frames at ``/frame?src=<path>&n=<frame>`` as PNG —
  the logo-wizard scrub + region picker works over actual decoded
  pixels (ref LogoGUISupport.hpp:160-275 MediaFile frame picker +
  LogoAnalyzeModel.cs's region selection).

stdlib only (zlib PNG writer); no external web framework.

The port's copy of amatsukaze_tpu/server/web.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import urllib.parse
import zlib

_HTML_PATH = os.path.join(os.path.dirname(__file__), "webui.html")


def encode_png(rgb) -> bytes:
    """Minimal RGB8 PNG writer (filter 0 rows, one zlib IDAT)."""
    import numpy as np

    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


class WebServer:
    """HTTP front end over an EncodeServer."""

    def __init__(self, encode_server):
        self.es = encode_server
        self._server: asyncio.AbstractServer | None = None
        # frame-scrub cache: src path -> (CachedFrameSource, w, h);
        # one source at a time (the wizard works one recording at a time)
        self._frame_src: tuple | None = None
        self._frame_lock = asyncio.Lock()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- plumbing
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _ = line.decode().split(" ", 2)
                except ValueError:
                    return
                headers = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode(errors="replace").partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    n = int(headers.get("content-length", 0) or 0)
                    body = await reader.readexactly(n) if n > 0 else b""
                except (ValueError, OverflowError):
                    status, ctype, payload = ("400 Bad Request",
                                              "text/plain", b"bad request")
                else:
                    try:
                        status, ctype, payload = await self._route(
                            method, target, body)
                    except Exception as e:  # noqa: BLE001 — a handler bug
                        # must produce a response, not kill the connection
                        status = "500 Internal Server Error"
                        ctype = "text/plain"
                        payload = str(e).encode()
                writer.write(
                    f"HTTP/1.1 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    f"Cache-Control: no-store\r\n"
                    f"Connection: keep-alive\r\n\r\n".encode())
                writer.write(payload)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _route(self, method: str, target: str,
                     body: bytes) -> tuple[str, str, bytes]:
        path = target.split("?", 1)[0]
        if path in ("/", "/index.html"):
            try:
                with open(_HTML_PATH, "rb") as f:
                    return "200 OK", "text/html; charset=utf-8", f.read()
            except OSError:
                return "500 Internal Server Error", "text/plain", b"no ui"
        if path.startswith("/api/"):
            rpc = path[5:]
            try:
                payload = json.loads(body) if body else {}
            except json.JSONDecodeError:
                return "400 Bad Request", "text/plain", b"bad json"
            try:
                result = await self.es.handle_request(rpc, payload)
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                result = {"error": str(e)}
            return ("200 OK", "application/json",
                    json.dumps(result).encode())
        if path == "/frame":
            q = urllib.parse.parse_qs(target.partition("?")[2])
            src = q.get("src", [""])[0]
            try:
                n = int(q.get("n", ["0"])[0])
            except ValueError:
                return "400 Bad Request", "text/plain", b"bad n"
            return await self._frame_png(src, n)
        if path.startswith("/logo/") and path.endswith(".png"):
            return self._logo_png(path[len("/logo/"):-len(".png")])
        if path.startswith("/drcs/") and path.endswith(".bmp"):
            name = os.path.basename(path[len("/drcs/"):])
            full = os.path.join(self.es.drcs_dir(), name)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    return "200 OK", "image/bmp", f.read()
            return "404 Not Found", "text/plain", b"not found"
        return "404 Not Found", "text/plain", b"not found"

    async def _frame_png(self, src: str, n: int) -> tuple[str, str, bytes]:
        """Decode frame `n` of `src` and serve it as PNG (the wizard's
        scrub view). Decoding runs in a worker thread; the frame source
        is cached so forward scrubbing is incremental."""
        if not src or not os.path.exists(src):
            return "404 Not Found", "text/plain", b"source not found"
        async with self._frame_lock:  # one decoder; serialize scrubs
            loop = asyncio.get_running_loop()
            try:
                rgb = await loop.run_in_executor(
                    None, self._decode_frame_rgb, src, max(0, n))
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                return ("500 Internal Server Error", "text/plain",
                        str(e).encode())
        return "200 OK", "image/png", encode_png(rgb)

    def _decode_frame_rgb(self, src: str, n: int):
        import numpy as np

        from ..pipeline.frame_source import CachedFrameSource

        cached = self._frame_src
        if cached is None or cached[0] != src:
            opener = getattr(self.es, "logo_frame_source", None) \
                or self.es._default_logo_frames

            # open once: prime the first iterator AND read the
            # dimensions from the same decode (restarts re-open)
            frames0, w, h = opener(src)
            primed = [iter(frames0)]

            def open_stream():
                if primed:
                    return primed.pop()
                frames, _w, _h = opener(src)
                return iter(frames)

            cached = (src, CachedFrameSource(open_stream, cache_frames=8),
                      w, h)
            self._frame_src = cached
        _, fsrc, w, h = cached
        y, u, v = fsrc.get_frame(n)
        y = np.asarray(y, np.float32)
        # upsample subsampled chroma planes and convert BT.601 -> RGB
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        for axis in (0, 1):
            if u.shape[axis] < y.shape[axis]:
                u = np.repeat(u, 2, axis)
                v = np.repeat(v, 2, axis)
        u = u[:y.shape[0], :y.shape[1]] - 128.0
        v = v[:y.shape[0], :y.shape[1]] - 128.0
        r = y + 1.402 * v
        g = y - 0.344136 * u - 0.714136 * v
        b = y + 1.772 * u
        return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)

    def _logo_png(self, name: str) -> tuple[str, str, bytes]:
        from ..models.logo_render import GUILogoFile

        full = os.path.join(self.es.logo_dir(), os.path.basename(name))
        if not os.path.exists(full):
            return "404 Not Found", "text/plain", b"not found"
        try:
            rgb = GUILogoFile(full).render()
        except (OSError, ValueError) as e:
            return "500 Internal Server Error", "text/plain", str(e).encode()
        return "200 OK", "image/png", encode_png(rgb)
