"""The one generator of recordings: reads a traffic mix's parameters
(portbench/traffic/<name>.json) and the configuration's geometry, lays the
scenes out from the seed, writes the TS and the logo files, and keeps the
truth beside them.

A mix is a list of parts (program or CM), film or video, with or without
the logo, each a list of scenes (frames, look). The seed draws the order
of each part's scenes (so the places of the cuts), moves each look's base
levels by a few steps, and draws the noise, the quantiser scales, the
audio and the order of the candidate logo files: every seed sends the
same scenes, so the same work, in another order.

Recordings are cached in portbench/cache/, keyed by traffic, geometry,
seed and a digest of this writer's code and of the mix; the newest
CACHE_KEEP are kept."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import time
from pathlib import Path

import numpy as np

from . import synth
from .spec import BENCH_DIR

CACHE_DIR = BENCH_DIR / "cache"
CACHE_KEEP = 16  # every seed of the two sets of a check stays cached
WRITER_FILES = ("synth.py", "synth_tables.py", "traffic.py")


def layout(traffic: dict, geometry: dict, seed: int):
    """(synth.Recording, truth) of one seed. Each part's scenes (frames,
    look) are the mix's, in an order the seed draws, so that every seed
    sends the same work; the seed also moves each look's base levels by a
    few steps. truth holds the parts, the CM zones and trims a correct CM
    pass finds, the scenes, and which logo file holds the painted logo."""
    rng = np.random.default_rng((seed, 20))
    jitter = traffic["base_jitter"]
    min_step = traffic["min_base_step"]
    scenes, parts = [], []
    first = 0
    prev_base = None
    for part in traffic["parts"]:
        looks = traffic["looks"][part["look"]]
        for _ in range(1000):
            order = [part["scenes"][int(i)]
                     for i in rng.permutation(len(part["scenes"]))]
            bases = [prev_base] + [looks[k][0][0] for _, k in order]
            if all(a is None or abs(a - b) >= min_step
                   for a, b in zip(bases, bases[1:])):
                break
        else:
            raise ValueError(f"no order of {part['scenes']} keeps the looks "
                             f"{min_step} apart")
        at = first
        for n, k in order:
            look = [list(p) for p in looks[k]]
            for p in look:
                p[0] += int(rng.integers(-jitter, jitter + 1))
            scenes.append(synth.Scene(at, at + n, part["content"] == "film",
                                      part["logo"], look))
            at += n
        prev_base = looks[order[-1][1]][0][0]
        parts.append(dict(first=first, end=at, cm=part["cm"],
                          logo=part["logo"], content=part["content"]))
        first = at
    box = tuple(geometry["logo_box"])
    rec = synth.Recording(geometry["height"], geometry["width"], box, scenes,
                          seed)
    cm_zones = [[p["first"], p["end"]] for p in parts if p["cm"]]
    kept = []
    for p in parts:
        if p["cm"]:
            continue
        if kept and kept[-1][1] == p["first"]:
            kept[-1][1] = p["end"]
        else:
            kept.append([p["first"], p["end"]])
    logo_order = [0, 1] if rng.random() < 0.5 else [1, 0]
    truth = dict(
        frames=first, parts=parts, cm_zones=cm_zones,
        trims=[x for k in kept for x in k], kept=kept,
        scenes=[dict(first=s.first, end=s.end, film=s.film, logo=s.logo,
                     look=s.look) for s in scenes],
        logo_box=list(box), logos_given=traffic["logos_given"],
        logo_order=logo_order,
        painted_logo_file=logo_order.index(0) if traffic["logos_given"]
        else None, silence_seconds=traffic["silence_seconds"])
    return rec, truth


def silent_at_cm_edges(truth: dict):
    """silent_audio(t0, t1) of the writer: near-silence centred on every
    edge between a CM part and a program part."""
    half = truth["silence_seconds"] / 2
    edges = [p["first"] * 1001 / 30000 for p in truth["parts"][1:]
             if any(q["cm"] for q in truth["parts"])]

    def silent(t0: float, t1: float) -> bool:
        return any(t0 < e + half and t1 > e - half for e in edges)

    return silent


def recording_from_truth(truth: dict, geometry: dict, seed: int):
    """The synth.Recording that layout() made for this truth (the
    reference rebuilds frames from it)."""
    scenes = [synth.Scene(s["first"], s["end"], s["film"], s["logo"],
                          s["look"]) for s in truth["scenes"]]
    return synth.Recording(geometry["height"], geometry["width"],
                           tuple(geometry["logo_box"]), scenes, seed)


# .lgd layout (Amatsukaze's AMTLogo): a delogo base block, which the port
# does not read and is left zero here, then the AMT header and the float A/B
# planes of Y, U and V
_LGD_FILE_HEADER = struct.Struct("<28s4s")
_LGD_BASE_HEADER = struct.Struct("<32s8h")
_LGD_AMT_HEADER = struct.Struct("<10i255sxi60i")
LGD_PIXEL_BYTES = 12


def write_lgd(path: str, planes, geometry: dict, name: str,
              service_id: int) -> None:
    lx, ly, lw, lh = geometry["logo_box"]
    with open(path, "wb") as f:
        f.write(_LGD_FILE_HEADER.pack(b"<logo data file ver0.1>\0\0\0\0\0",
                                      (1).to_bytes(4, "big")))
        f.write(_LGD_BASE_HEADER.pack(name.encode()[:31], lx, ly, lh, lw,
                                      0, 0, 0, 0))
        f.write(bytes(lw * lh * LGD_PIXEL_BYTES))
        f.write(_LGD_AMT_HEADER.pack(
            0x12345, 1, lw, lh, 1, 1, geometry["width"], geometry["height"],
            lx, ly, name.encode()[:254], service_id, *([0] * 60)))
        for p in planes:
            f.write(np.ascontiguousarray(p, "<f4").tobytes())


ARRIVAL_KEYS = ("about", "entry", "clients")  # not the recordings' layout


def _digest(traffic: dict, geometry: dict) -> str:
    h = hashlib.sha256()
    for name in WRITER_FILES:
        h.update((Path(__file__).parent / name).read_bytes())
    layout_keys = {k: v for k, v in traffic.items() if k not in ARRIVAL_KEYS}
    h.update(json.dumps([layout_keys, geometry], sort_keys=True).encode())
    return h.hexdigest()[:12]


def ensure_recording(traffic_name: str, traffic: dict, geometry: dict,
                     seed: int, cache_dir: Path = CACHE_DIR) -> dict:
    """The cached recording of (traffic, geometry, seed), written first if
    absent: {"ts", "logos" (paths in the order given to the program),
    "truth", "wrote_seconds" (the seconds it took to write it and its
    logo files, 0 when cached)}."""
    key = (f"{traffic_name}-{geometry['width']}x{geometry['height']}-"
           f"{seed}-{_digest(traffic, geometry)}")
    d = cache_dir / key
    wrote = 0.0
    if not (d / "truth.json").exists():
        t_write = time.perf_counter()
        part = cache_dir / (key + ".partial")
        shutil.rmtree(part, ignore_errors=True)
        part.mkdir(parents=True)
        rec, truth = layout(traffic, geometry, seed)
        info = synth.write_ts(str(part / "recording.ts"), rec,
                              silent_at_cm_edges(truth), seed)
        if traffic["logos_given"]:
            made = synth.make_logos(geometry["height"], geometry["width"],
                                    tuple(geometry["logo_box"]))
            for pos, k in enumerate(truth["logo_order"]):
                write_lgd(str(part / f"logo{pos}.lgd"), made[k], geometry,
                          ("painted", "decoy")[k], synth.SERVICE_ID)
        truth.update(ts_bytes=info["bytes"], seed=seed)
        with open(part / "truth.json", "w") as f:
            json.dump(truth, f)
        # on the disk before the window opens: its write-back would
        # otherwise run beside the measured recordings
        for p in part.iterdir():
            with open(p, "rb") as f:
                os.fsync(f.fileno())
        shutil.rmtree(d, ignore_errors=True)
        os.replace(part, d)
        wrote = time.perf_counter() - t_write
    os.utime(d)
    old = sorted((p for p in cache_dir.iterdir() if p.is_dir()
                  and not p.name.endswith(".partial")),
                 key=lambda p: p.stat().st_mtime)
    for p in old[:-CACHE_KEEP]:
        shutil.rmtree(p, ignore_errors=True)
    with open(d / "truth.json") as f:
        truth = json.load(f)
    logos = sorted(str(p) for p in d.glob("logo*.lgd"))
    return dict(ts=str(d / "recording.ts"), logos=logos, truth=truth,
                wrote_seconds=wrote)
