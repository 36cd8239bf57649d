"""DRCS gaiji mapping manager.

Parity: DRCSManager (AmatsukazeServer/Server/DRCSManager.cs:11-441): watch
`drcs_map.txt` and the received-image directory, pair unmapped DRCS bitmaps
with the encode logs that hit them, surface the pending list to clients, and
append user-provided mappings back to the map file.

Layout (same as the reference):
  <drcs_dir>/drcs_map.txt          md5hex=replacement lines
  <drcs_dir>/<md5hex>.bmp          unmapped bitmap saved by the caption layer

The port's copy of amatsukaze_tpu/server/drcs.py.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


@dataclass
class DrcsImage:
    md5: str = ""
    map_str: str | None = None
    bmp_path: str = ""
    sources: list = field(default_factory=list)  # (src_file, time) pairs


_LOG_RE = re.compile(r"DRCS.*?([0-9a-f]{32})", re.IGNORECASE)


class DRCSManager:
    def __init__(self, ctx, drcs_dir: str):
        self.ctx = ctx
        self.drcs_dir = drcs_dir
        self.map_path = os.path.join(drcs_dir, "drcs_map.txt")
        self.images: dict[str, DrcsImage] = {}
        self._map_mtime = -1.0
        self._listeners: list = []  # callables(images: list[DrcsImage])

    # -- map file ------------------------------------------------------------
    def load_map(self) -> dict[str, str]:
        mapping: dict[str, str] = {}
        if os.path.exists(self.map_path):
            with open(self.map_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line and "=" in line:
                        k, _, v = line.partition("=")
                        mapping[k.strip().lower()] = v
        return mapping

    def add_mapping(self, md5: str, text: str) -> None:
        """Append one mapping and refresh (ref AddDrcsMap :395-441)."""
        md5 = md5.lower()
        os.makedirs(self.drcs_dir, exist_ok=True)
        with open(self.map_path, "a", encoding="utf-8") as f:
            f.write(f"{md5}={text}\n")
        self.ctx.drcs_map[md5] = text
        self.update()

    # -- log pairing -----------------------------------------------------------
    def add_log_file(self, log_path: str, src_file: str, time) -> None:
        """Scan an encode log for unmapped-DRCS hits and record the source
        (ref AddLogFile :58-61 + ReadLogFiles :206-241)."""
        try:
            with open(log_path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            return
        for m in _LOG_RE.finditer(text):
            md5 = m.group(1).lower()
            img = self.images.setdefault(md5, DrcsImage(md5=md5))
            img.sources.append((src_file, time))

    # -- scan ------------------------------------------------------------------
    def update(self) -> list[DrcsImage]:
        """Re-scan the map file + image dir; returns images with their
        mapping state; notifies listeners on change (ref Update :243-392)."""
        mapping = self.load_map()
        if os.path.isdir(self.drcs_dir):
            for name in os.listdir(self.drcs_dir):
                if not name.lower().endswith(".bmp"):
                    continue
                md5 = name[:-4].lower()
                if len(md5) != 32:
                    continue
                img = self.images.setdefault(md5, DrcsImage(md5=md5))
                img.bmp_path = os.path.join(self.drcs_dir, name)
        for md5, img in self.images.items():
            img.map_str = mapping.get(md5)
        result = sorted(self.images.values(), key=lambda i: i.md5)
        for fn in self._listeners:
            fn(result)
        return result

    def unmapped(self) -> list[DrcsImage]:
        return [i for i in self.update() if i.map_str is None]

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)
