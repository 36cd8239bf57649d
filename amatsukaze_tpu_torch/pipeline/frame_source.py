"""Frame-accurate random access over a decoded stream with an LRU cache.

Parity: AMTSource (Amatsukaze/AMTSource.hpp:42-941) — the reference binds
decoded frames to the reform's FilterSourceFrame list and serves AviSynth
GetFrame calls from an intrusive LRU cache, falling back to forward decode
or a keyframe byte-seek with back-off retry (GetFrame :721-780):

- forward decodes when the target is within `seek_distance` ahead
- otherwise byte-seeks the intermediate file to the target's keyframe
  offset (frames[n].keyFrame -> fileOffset), retrying up to 3 times with
  an earlier keyframe each time (back-off `keyNum -= max(5, ...)`)
- frames that stay undecodable are registered in a failed-frame map and
  served as a substitute; more than 10% failed frames is a hard error
  (registerFailedFrames :649-658)

Here the decode is a pluggable sequential iterator; the optional
`open_at(key_index, file_offset)` hook provides the byte-seek (see
pipeline/decoders.mpeg2_ps_seek_opener for the in-build MPEG2 decoder).
Without it, random access restarts the stream from zero when asked to go
backwards past the cache (the wizard/filter access patterns are mostly
monotone with small look-backs).

The port's copy of amatsukaze_tpu/pipeline/frame_source.py.
"""

from __future__ import annotations

from collections import OrderedDict

from ..utils.context import ErrorCounter, FormatError


def _available_ram_bytes() -> int:
    """MemAvailable from /proc/meminfo (0 when unknown)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class SweepFrameCache:
    """Decoded-frame reuse across sequential pipeline sweeps.

    The pipeline decodes each intermediate video several times end to
    end: the CM scene/silence sweep, the filter analysis passes, and the
    encode feed (the reference does the same — its AMTSource LRU holds
    only 32 frames, AMTSource.hpp:410-426, so every sweep re-runs
    FFmpeg). Host RAM is measured in GB here, so the first sweep records
    the decoded planes and later sweeps replay them from memory.

    All-or-nothing per video: if the clip exceeds the byte budget the
    recording is abandoned (marked too-big) and every sweep decodes as
    before — long recordings keep the streaming behaviour. A sweep
    abandoned mid-stream (e.g. a dead encoder) leaves no partial cache.
    """

    _TOO_BIG = object()

    def __init__(self, budget_bytes: int):
        self.budget = max(0, int(budget_bytes))
        self._store: dict[int, object] = {}
        self._bytes = 0
        self.hits = 0

    @staticmethod
    def auto_budget_mb() -> int:
        """Default budget: a quarter of available RAM."""
        return int(_available_ram_bytes() // 4) >> 20

    def _frame_bytes(self, planes: tuple) -> int:
        return sum(getattr(p, "nbytes", 0) for p in planes
                   if p is not None)

    def stream(self, video_index: int, open_stream):
        """Iterate the decoded stream for `video_index`, serving from the
        recording when a complete one exists and recording otherwise."""
        got = self._store.get(video_index)
        if isinstance(got, list):
            self.hits += 1
            yield from got
            return
        if got is self._TOO_BIG or self.budget <= 0:
            yield from open_stream()
            return
        rec: list[tuple] = []
        rec_bytes = 0
        complete = False
        try:
            for planes in open_stream():
                if rec is not None:
                    rec_bytes += self._frame_bytes(planes)
                    if self._bytes + rec_bytes > self.budget:
                        self._store[video_index] = self._TOO_BIG
                        rec = None
                    else:
                        rec.append(planes)
                yield planes
            complete = True
        finally:
            if complete and rec is not None:
                self._store[video_index] = rec
                self._bytes += rec_bytes

    def drop(self, video_index: int) -> None:
        got = self._store.pop(video_index, None)
        if isinstance(got, list):
            self._bytes -= sum(self._frame_bytes(p) for p in got)


class CachedFrameSource:
    """get_frame(n) -> (Y, U, V) with an LRU cache (ref PutFrame/GetFrame,
    AMTSource.hpp:410-426, 721-780)."""

    def __init__(self, open_stream, cache_frames: int = 32,
                 frames_meta=None, open_at=None, num_frames: int | None = None,
                 seek_distance: int = 10, ctx=None):
        """open_stream: callable() -> iterator of (Y, U, V) frames.
        frames_meta: optional FilterSourceFrame list (needs .key_frame and
        .file_offset) enabling keyframe byte-seek via open_at.
        open_at: callable(key_index, file_offset) -> iterator that yields
        frames starting at filter index `key_index`.
        """
        self._open = open_stream
        self.cache_frames = cache_frames
        self._cache: OrderedDict[int, tuple] = OrderedDict()
        self._it = None
        self._pos = 0  # index the iterator will yield next
        self.frames_meta = frames_meta
        self.open_at = open_at
        self.num_frames = (num_frames if num_frames is not None
                           else (len(frames_meta) if frames_meta else None))
        self.seek_distance = seek_distance
        self.ctx = ctx
        self.failed: dict[int, int] = {}  # frame -> substitute frame
        self.num_restarts = 0
        self.num_decoded = 0
        self.num_seeks = 0

    # ------------------------------------------------------------------ cache
    def _restart(self) -> None:
        self._it = self._open()
        self._pos = 0
        self.num_restarts += 1

    def _put(self, n: int, frame: tuple) -> None:
        self._cache[n] = frame
        self._cache.move_to_end(n)
        while len(self._cache) > self.cache_frames:
            self._cache.popitem(last=False)

    def _register_failed(self, begin: int, end: int, replace: int) -> None:
        """ref registerFailedFrames (AMTSource.hpp:649-658): substitute
        map + hard error past 10% undecodable frames."""
        begin = max(0, begin)
        replace = max(0, replace)
        if self.frames_meta:
            replace = min(replace, len(self.frames_meta) - 1)
        count = 0
        for f in range(begin, end):
            if f != replace and f not in self.failed:
                self.failed[f] = replace
                count += 1
        if count and self.ctx is not None:
            self.ctx.incr(ErrorCounter.DECODE_PACKET_FAILED, count)
            self.ctx.warn("frame source: %d frames undecodable "
                          "(substituting frame %d)", count, replace)
        total = self.num_frames if self.num_frames is not None else 0
        if total and len(self.failed) * 10 > total:
            raise FormatError(
                f"too many undecodable frames: {len(self.failed)} of {total}")

    # ------------------------------------------------------------- decoding
    def _decode_forward(self, n: int) -> bool:
        """Advance the live iterator until n is decoded (ref DecodeLoop).
        Returns False at EOF before reaching n."""
        while True:
            try:
                frame = next(self._it)
            except StopIteration:
                return False
            idx = self._pos
            self._pos += 1
            self.num_decoded += 1
            self._put(idx, frame)
            if idx >= n:
                return True

    def _last_decoded(self) -> int:
        return self._pos - 1

    def _seek_decode(self, n: int) -> None:
        """Keyframe byte-seek with back-off retry (ref GetFrame:736-773)."""
        meta = self.frames_meta
        key = meta[n].key_frame
        for attempt in range(3):
            error = False
            try:
                self._it = iter(self.open_at(key, meta[key].file_offset))
                self._pos = key
                self.num_seeks += 1
                self._decode_forward(n)
            except Exception as e:  # noqa: BLE001 - corrupt GOP: retry
                error = True
                self._it = None
                if self.ctx is not None:
                    self.ctx.warn("frame source: seek decode at key %d "
                                  "failed: %s", key, e)
            if n in self._cache:
                self.seek_distance = max(self.seek_distance, n - key)
                return
            if key <= 0:
                # cannot go further back: the target is undecodable
                self._register_failed(n, max(n + 1, self._pos),
                                      self._last_decoded())
                return
            if not error and self._pos > key:
                # clean EOF after decoding some frames: the tail of the
                # file is genuinely missing
                last = self._last_decoded()
                end = self.num_frames if self.num_frames else n + 1
                self._register_failed(last + 1, max(end, n + 1),
                                      max(0, last))
                return
            if attempt == 2:
                self._register_failed(n, max(n + 1, self._pos),
                                      self._last_decoded())
                return
            # back off to an earlier keyframe (ref :770), re-snapped
            # onto that frame's actual keyframe (short GOPs would
            # otherwise land mid-GOP and desync the cached indices)
            key -= max(5, key - meta[key - 1].key_frame)
            key = meta[max(0, key)].key_frame

    # ------------------------------------------------------------------- API
    def get_frame(self, n: int):
        if n < 0:
            raise IndexError(n)
        for _ in range(2):  # second pass serves a substitute frame
            hit = self._cache.get(n)
            if hit is not None:
                self._cache.move_to_end(n)
                return hit
            if n in self.failed:
                n = self.failed[n]
                continue
            can_seek = self.open_at is not None and self.frames_meta
            if can_seek and n >= len(self.frames_meta):
                # beyond the known frame list: substitute like the EOF
                # path (the reference clamps n to the frame list size)
                last = len(self.frames_meta) - 1
                if last >= 0 and last != n:
                    n = last
                    continue
                raise IndexError(n)
            if (self._it is not None and self._pos <= n
                    and (not can_seek
                         or n < self._pos + self.seek_distance)):
                if self._decode_forward(n):
                    return self._cache[n]
                # EOF: register the tail as failed and substitute
                last = self._last_decoded()
                end = self.num_frames if self.num_frames else n + 1
                self._register_failed(last + 1, max(end, n + 1),
                                      max(0, last))
                if self._cache:
                    n = self.failed.get(n, n)
                    continue
                raise IndexError(n)
            if can_seek:
                self._seek_decode(n)
                if n in self._cache:
                    return self._cache[n]
                n = self.failed.get(n, n)
                continue
            # no byte-seek available: restart from zero
            if self._it is None or n < self._pos:
                self._restart()
        hit = self._cache.get(n)
        if hit is not None:
            return hit
        if self._it is not None and self._pos <= n and self._decode_forward(n):
            return self._cache[n]
        if self._cache:
            return self._cache[next(reversed(self._cache))]
        raise IndexError(n)
