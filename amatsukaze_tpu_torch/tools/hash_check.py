"""SHA-512 file hash lists: make / check / copy-with-hash.

Parity: BatchHashChecker (BatchHashChecker/*.cpp) and HashUtil
(AmatsukazeServer/Server/Misc.cs:430-588). List format is one line per
file: 128 hex chars + two spaces + the file name (sha512sum style); the
server verifies hash-dir sources before remote copies.

The port's copy of amatsukaze_tpu/tools/hash_check.py.
"""

from __future__ import annotations

import hashlib
import os

HASH_LENGTH = 64  # SHA-512 bytes
_CHUNK = 2 * 1024 * 1024


def file_hash(path: str) -> bytes:
    h = hashlib.sha512()
    with open(path, "rb") as f:
        while True:
            buf = f.read(_CHUNK)
            if not buf:
                break
            h.update(buf)
    return h.digest()


def copy_with_hash(src: str, dst: str) -> bytes:
    """Copy src -> dst computing the SHA-512 on the fly
    (ref HashUtil.CopyWithHash)."""
    h = hashlib.sha512()
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        while True:
            buf = fi.read(_CHUNK)
            if not buf:
                break
            h.update(buf)
            fo.write(buf)
    return h.digest()


def read_hash_file(path: str) -> dict[str, bytes]:
    """(ref HashUtil.ReadHashFile :554-579): a trailing short line is a
    clean EOF marker; a short line elsewhere means corruption."""
    out: dict[str, bytes] = {}
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if len(line) <= HASH_LENGTH * 2 + 2:
            if i + 1 == len(lines):
                break
            raise IOError("hash file is corrupted")
        digest = bytes.fromhex(line[: HASH_LENGTH * 2])
        name = line[HASH_LENGTH * 2 + 2:]
        out.setdefault(name, digest)
    return out


def append_hash(path: str, name: str, digest: bytes) -> None:
    with open(path, "a", encoding="utf-8") as f:
        f.write(digest.hex().upper() + "  " + name + "\n")


def make_hash_list(target_dir: str, out_path: str | None = None) -> str:
    """Mode `m`: hash every file under target_dir (non-recursive, like the
    reference's per-directory lists) into `<dir>.hash`."""
    out_path = out_path or os.path.join(
        target_dir, os.path.basename(os.path.abspath(target_dir)) + ".hash")
    if os.path.exists(out_path):
        os.remove(out_path)
    for name in sorted(os.listdir(target_dir)):
        p = os.path.join(target_dir, name)
        if os.path.isfile(p) and p != out_path:
            append_hash(out_path, name, file_hash(p))
    return out_path


def check_hash_list(hash_path: str, target_dir: str | None = None):
    """Mode `c`: verify files against the list. Returns (ok, failures)
    where failures are (name, reason) pairs."""
    target_dir = target_dir or os.path.dirname(os.path.abspath(hash_path))
    wanted = read_hash_file(hash_path)
    failures = []
    for name, digest in wanted.items():
        p = os.path.join(target_dir, name)
        if not os.path.exists(p):
            failures.append((name, "missing"))
        elif file_hash(p) != digest:
            failures.append((name, "hash mismatch"))
    return (not failures), failures
