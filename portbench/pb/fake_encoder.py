"""The benchmark's encoder: reads the y4m that the program writes to its
stdin and writes to `-o` a small .npz, never the y4m: the header, the
number of frames, a digest of every frame (of its every DIGEST_STRIDE-th
row: the encoder must cost the host next to nothing, so that it never
sets the pace) and the whole planes of the frames whose indices the
environment variable PORTBENCH_KEEP_FRAMES lists (comma-separated). Other
arguments are the x264 options the program passes, and are ignored.

    python3 fake_encoder.py [x264 options] -o OUT < stream.y4m
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

KEEP_ENV = "PORTBENCH_KEEP_FRAMES"
DIGEST_STRIDE = 32


def parse_header(line: bytes) -> dict:
    """Width, height and chroma layout of a YUV4MPEG2 stream header."""
    tokens = line.decode().split()
    if not tokens or tokens[0] != "YUV4MPEG2":
        raise ValueError(f"not a y4m stream: {line[:40]!r}")
    out = dict(colorspace="420")
    for t in tokens[1:]:
        if t[0] == "W":
            out["width"] = int(t[1:])
        elif t[0] == "H":
            out["height"] = int(t[1:])
        elif t[0] == "C":
            out["colorspace"] = t[1:]
    if not out["colorspace"].startswith("420") or "p1" in out["colorspace"]:
        raise ValueError(f"only 8-bit 4:2:0 streams: {out['colorspace']}")
    return out


def frame_digest(planes) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for p in planes:
        h.update(np.ascontiguousarray(p[::DIGEST_STRIDE]).tobytes())
    return h.digest()


def read_stream(stream, keep: set) -> dict:
    header = stream.readline()
    fmt = parse_header(header)
    w, h = fmt["width"], fmt["height"]
    sizes = (w * h, (w // 2) * (h // 2), (w // 2) * (h // 2))
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    buf = bytearray(sum(sizes))
    view = memoryview(buf)
    arr = np.frombuffer(buf, np.uint8)
    planes, at = [], 0
    for n, shape in zip(sizes, shapes):
        planes.append(arr[at:at + n].reshape(shape))
        at += n
    digests, kept = [], {}
    while True:
        tag = stream.readline()
        if not tag:
            break
        if not tag.startswith(b"FRAME"):
            raise ValueError(f"frame {len(digests)}: bad tag {tag[:20]!r}")
        got = 0
        while got < len(buf):
            n = stream.readinto(view[got:])
            if not n:
                raise ValueError(f"frame {len(digests)}: short read")
            got += n
        if len(digests) in keep:
            kept[len(digests)] = [p.copy() for p in planes]
        digests.append(frame_digest(planes))
    return dict(header=header.decode().strip(), width=w, height=h,
                digests=digests, kept=kept)


def save(path: str, res: dict) -> None:
    idx = sorted(res["kept"])
    arrays = dict(header=np.array(res["header"]),
                  n_frames=np.array(len(res["digests"])),
                  digests=np.frombuffer(b"".join(res["digests"]),
                                        np.uint8).reshape(-1, 16),
                  kept=np.array(idx, np.int64))
    for k in idx:
        for p, name in enumerate("yuv"):
            arrays[f"{name}{k}"] = res["kept"][k][p]
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load(path: str) -> dict:
    with np.load(path) as z:
        idx = [int(k) for k in z["kept"]]
        return dict(header=str(z["header"]), n_frames=int(z["n_frames"]),
                    digests=[bytes(d) for d in z["digests"]],
                    frames={k: tuple(z[f"{n}{k}"] for n in "yuv")
                            for k in idx})


def main(argv: list) -> int:
    out = None
    for i, a in enumerate(argv):
        if a == "-o" and i + 1 < len(argv):
            out = argv[i + 1]
    if out is None:
        print("fake_encoder: no -o", file=sys.stderr)
        return 2
    keep = {int(x) for x in os.environ.get(KEEP_ENV, "").split(",") if x}
    save(out, read_stream(sys.stdin.buffer, keep))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
