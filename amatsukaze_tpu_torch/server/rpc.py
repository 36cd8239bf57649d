"""Length-prefixed JSON RPC over TCP.

Replaces the reference's DataContract-serialised RPC (Server/ServerInterface.cs:
80-186 + ClientManager.cs): same shape - a method id + payload per frame,
server pushes `on*` notification frames to every client - with JSON instead
of .NET DataContract.

The port's copy of amatsukaze_tpu/server/rpc.py.
"""

from __future__ import annotations

import asyncio
import json
import struct

_HEADER = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024

# method names mirror RPCMethodId (ServerInterface.cs:80-116)
CLIENT_METHODS = [
    "SetProfile", "AddProfile", "RemoveProfile",
    "SetAutoSelect", "AddAutoSelect", "RemoveAutoSelect",
    "AddQueue", "ChangeItem", "ChangeItemTask", "PauseEncode",
    "SetCommonData", "SetServiceSetting", "AddDrcsMap",
    "EndServer", "Request",
]
SERVER_NOTIFICATIONS = [
    "OnUIData", "OnConsoleUpdate", "OnEncodeState",
    "OnQueueData", "OnQueueUpdate", "OnLogData", "OnLogUpdate",
    "OnCommonData", "OnProfile", "OnAutoSelect", "OnServiceSetting",
    "OnLogoData", "OnDrcsData", "OnAddResult", "OnOperationResult",
]


async def read_frame(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(_HEADER.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ValueError("oversized RPC frame")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return json.loads(body.decode("utf-8"))


def encode_frame(message: dict) -> bytes:
    body = json.dumps(message, ensure_ascii=False).encode("utf-8")
    return _HEADER.pack(len(body)) + body


async def write_frame(writer: asyncio.StreamWriter, message: dict) -> None:
    writer.write(encode_frame(message))
    await writer.drain()


class ClientManager:
    """Accepts clients and broadcasts notifications
    (ref Server/ClientManager.cs)."""

    def __init__(self, on_request):
        self.on_request = on_request  # async callable(method, payload) -> reply
        self.clients: set[asyncio.StreamWriter] = set()

    async def handle_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        self.clients.add(writer)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                method = frame.get("method", "")
                payload = frame.get("payload")
                reply = await self.on_request(method, payload)
                if reply is not None:
                    await write_frame(writer, {
                        "method": f"{method}Result",
                        "id": frame.get("id"),
                        "payload": reply,
                    })
        finally:
            self.clients.discard(writer)
            writer.close()

    async def broadcast(self, method: str, payload) -> None:
        dead = []
        # snapshot: write_frame awaits, and a client connecting or
        # dropping during that await mutates self.clients ("Set changed
        # size during iteration" killed the encode worker's broadcast)
        for w in list(self.clients):
            try:
                await write_frame(w, {"method": method, "payload": payload})
            except (ConnectionResetError, BrokenPipeError):
                dead.append(w)
        for w in dead:
            self.clients.discard(w)


class RpcClient:
    """Client side (used by the AddTask tool + tests)."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self._next_id = 0

    @classmethod
    async def connect(cls, host: str, port: int) -> "RpcClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def call(self, method: str, payload=None) -> dict | None:
        self._next_id += 1
        await write_frame(self.writer, {
            "method": method, "id": self._next_id, "payload": payload,
        })
        while True:
            frame = await read_frame(self.reader)
            if frame is None:
                return None
            if frame.get("id") == self._next_id:
                return frame.get("payload")
            # else: a broadcast notification; ignore in simple calls

    async def notify(self, method: str, payload=None) -> None:
        await write_frame(self.writer, {"method": method, "payload": payload})

    def close(self) -> None:
        self.writer.close()
