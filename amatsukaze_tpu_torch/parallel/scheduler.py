"""Resource-aware job scheduler (asyncio port of the reference C# server's
scheduling core).

Parity targets:
- ResourceManager (AmatsukazeServer/Server/ResourceManager.cs): CPU/HDD
  100-point pools + up to 16 accelerators with per-device caps; cost of a
  request = max over-budget across pools; FIFO-fair waits with re-sorted
  minimum-cost-first admission; encoder-index allocation for affinity.
  "GPU" slots model CUDA cards here.
- WorkerPool (Server/Scheduler.cs:14-209): fixed parallel slots, parking,
  pause (user/scheduled), ForceStart.
- ScheduledQueue (Server/Scheduler.cs:211-428): 5 priority levels x
  resource-key buckets; resource-aware NextItem over priority sections
  {5}, {4..2}, {1}; active resource tracking.
- The per-process phase pipe protocol (Amatsukaze/InterProcessComm.hpp:77-183
  + TranscodeWorker.cs:492-606) becomes the in-process async PhaseScheduler.

The port's copy of amatsukaze_tpu/parallel/scheduler.py.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

MAX_POOL = 100
MAX_DEVICES = 16

PHASES = ("TSAnalyze", "CMAnalyze", "Filter", "Encode", "Mux")


@dataclass(frozen=True)
class ReqResource:
    """CPU/HDD/device percentage triple (ref EncodeServerData.cs:74-92)."""

    cpu: int = 0
    hdd: int = 0
    gpu: int = 0  # device (CUDA card) percentage

    def canonical(self) -> int:
        return (self.cpu << 16) | (self.hdd << 8) | self.gpu

    @classmethod
    def from_canonical(cls, key: int) -> "ReqResource":
        return cls((key >> 16) & 0xFFFF, (key >> 8) & 0xFF, key & 0xFF)


@dataclass
class Resource:
    req: ReqResource
    gpu_index: int = 0
    encoder_index: int = -1


class ResourceManager:
    def __init__(self):
        self.cur_cpu = 0
        self.cur_hdd = 0
        self.num_gpu = MAX_DEVICES
        self.cur_gpu = [0] * MAX_DEVICES
        self.max_gpu = [MAX_POOL] * MAX_DEVICES
        self._encode_ids: set[int] = set()
        self._waiting: list[dict] = []  # {"req":, "cost":}
        self._signal = asyncio.Event()

    # -- configuration -----------------------------------------------------
    def set_gpu_resources(self, num_gpu: int, max_gpu: list[int]) -> None:
        if num_gpu > MAX_DEVICES:
            raise ValueError("too many devices")
        if num_gpu > len(max_gpu):
            raise ValueError("num_gpu > len(max_gpu)")
        self.num_gpu = num_gpu
        self.max_gpu = list(max_gpu) + [MAX_POOL] * (MAX_DEVICES - len(max_gpu))
        self._recalculate()
        self._signal_all()

    # -- internals ----------------------------------------------------------
    def _recalculate(self) -> None:
        for w in self._waiting:
            w["cost"] = self.resource_cost(w["req"])
        self._waiting.sort(key=lambda w: w["cost"])

    def _most_capable_gpu(self) -> int:
        spaces = [self.max_gpu[i] - self.cur_gpu[i] for i in range(self.num_gpu)]
        return spaces.index(max(spaces))

    def _allocate_encoder_index(self) -> int:
        i = 0
        while i in self._encode_ids:
            i += 1
        self._encode_ids.add(i)
        return i

    def _signal_all(self) -> None:
        self._signal.set()
        self._signal = asyncio.Event()

    @staticmethod
    def _remove_by_identity(lst: list, obj) -> None:
        # list.remove() compares dicts by value; equal waiters must not
        # remove each other's entries
        for i, w in enumerate(lst):
            if w is obj:
                del lst[i]
                return

    # -- public --------------------------------------------------------------
    def resource_cost(self, req: ReqResource) -> int:
        g = self._most_capable_gpu()
        return max(
            self.cur_cpu + req.cpu - MAX_POOL,
            self.cur_hdd + req.hdd - MAX_POOL,
            self.cur_gpu[g] + req.gpu - self.max_gpu[g],
        )

    def force_get_resource(self, req: ReqResource,
                           req_encoder_index: bool = False) -> Resource:
        g = self._most_capable_gpu()
        self.cur_cpu += req.cpu
        self.cur_hdd += req.hdd
        self.cur_gpu[g] += req.gpu
        self._recalculate()
        return Resource(
            req=req, gpu_index=g,
            encoder_index=self._allocate_encoder_index() if req_encoder_index else -1,
        )

    def try_get_resource(self, req: ReqResource,
                         req_encoder_index: bool = False) -> Resource | None:
        cost = self.resource_cost(req)
        if cost > 0:
            return None
        if self._waiting and cost > self._waiting[0]["cost"]:
            return None  # FIFO-fair: don't jump cheaper waiters
        return self.force_get_resource(req, req_encoder_index)

    async def get_resource(self, req: ReqResource,
                           req_encoder_index: bool = False) -> Resource:
        waiting = {"req": req, "cost": 0}
        self._waiting.append(waiting)
        self._recalculate()
        try:
            while True:
                if waiting["cost"] <= 0 and waiting["cost"] <= self._waiting[0]["cost"]:
                    self._remove_by_identity(self._waiting, waiting)
                    res = self.force_get_resource(req, req_encoder_index)
                    self._signal_all()
                    return res
                sig = self._signal
                await sig.wait()
        except asyncio.CancelledError:
            self._remove_by_identity(self._waiting, waiting)
            self._signal_all()
            raise

    def release_resource(self, res: Resource) -> None:
        self.cur_cpu -= res.req.cpu
        self.cur_hdd -= res.req.hdd
        self.cur_gpu[res.gpu_index] -= res.req.gpu
        self._encode_ids.discard(res.encoder_index)
        self._recalculate()
        self._signal_all()


# ---------------------------------------------------------------------------
# scheduled queue
# ---------------------------------------------------------------------------

ENCODE_PHASE = PHASES.index("Encode")

# resource-aware priority sections: {5}, {4,3,2}, {1} (ref Scheduler.cs:341)
_RESOURCE_SECTIONS = ((4,), (3, 2, 1), (0,))


@dataclass
class QueueItem:
    item_id: int
    priority: int = 3
    order: int = 0
    req_resources: dict = field(default_factory=dict)  # phase -> ReqResource
    state: str = "queue"
    payload: object = None

    def encode_req(self) -> ReqResource:
        return self.req_resources.get("Encode", ReqResource())


class ScheduledQueue:
    def __init__(self, enable_resource_scheduling: bool = True):
        self.levels: list[dict[int, list[QueueItem]]] = [dict() for _ in range(5)]
        self.actives: list[tuple[QueueItem, ReqResource]] = []
        self.resource_manager = ResourceManager()
        self.enable_resource_scheduling = enable_resource_scheduling
        self.worker_pool: "WorkerPool | None" = None
        self._dirty = False
        # virtual tally of active items' Encode reqs, used for ORDERING
        # only (ref Scheduler.cs:379-425 active-resource tracking). It
        # must never consume ResourceManager capacity: reserving the
        # whole job's Encode share up front starves the per-phase waits
        # (with num_parallel>=2, three parked TSAnalyze waits can then
        # never clear -> deadlock; the reference gates phases through
        # the HostThread protocol against live usage only).
        self._acpu = 0
        self._ahdd = 0
        self._agpu = 0

    def _order_cost(self, req: ReqResource) -> int:
        rm = self.resource_manager
        g = rm._most_capable_gpu()
        return max(
            rm.cur_cpu + self._acpu + req.cpu - MAX_POOL,
            rm.cur_hdd + self._ahdd + req.hdd - MAX_POOL,
            rm.cur_gpu[g] + self._agpu + req.gpu - rm.max_gpu[g],
        )

    def add_queue(self, item: QueueItem) -> None:
        item.priority = max(1, min(5, item.priority))
        key = item.encode_req().canonical()
        self.levels[item.priority - 1].setdefault(key, []).append(item)
        self._dirty = True
        if self.worker_pool:
            self.worker_pool.notify_add_queue()

    def remove_queue(self, item: QueueItem) -> bool:
        for level in self.levels:
            for key, items in list(level.items()):
                if item in items:
                    items.remove(item)
                    if not items:
                        del level[key]
                    return True
        return False

    def make_dirty(self) -> None:
        self._dirty = True

    def _clean(self) -> None:
        moved: list[QueueItem] = []
        for i, level in enumerate(self.levels):
            priority = i + 1
            for key in list(level.keys()):
                items = [s for s in level[key] if s.state == "queue"]
                ok = [s for s in items
                      if s.priority == priority
                      and s.encode_req().canonical() == key]
                moved += [s for s in items if s not in ok]
                if ok:
                    ok.sort(key=lambda s: s.order)
                    level[key] = ok
                else:
                    del level[key]
        self._dirty = False
        for item in moved:
            self.add_queue(item)

    def _next_item(self) -> QueueItem | None:
        if self.enable_resource_scheduling:
            for section in _RESOURCE_SECTIONS:
                best = None
                for pr in section:  # high priority first within a section
                    for key, items in self.levels[pr].items():
                        if not items:
                            continue
                        cost = self._order_cost(
                            ReqResource.from_canonical(key)
                        )
                        if best is None or cost < best[0]:
                            best = (cost, items[0])
                if best is not None:
                    return best[1]
            return None
        for level in reversed(self.levels):
            for items in level.values():
                if items:
                    return items[0]
        return None

    def _track_active(self, item: QueueItem) -> None:
        req = item.encode_req()
        self._acpu += req.cpu
        self._ahdd += req.hdd
        self._agpu += req.gpu
        self.actives.append((item, req))

    def pop_item(self) -> QueueItem | None:
        if self._dirty:
            self._clean()
        item = self._next_item()
        if item is None:
            return None
        self.remove_queue(item)
        self._track_active(item)
        return item

    def start_item(self, item: QueueItem) -> None:
        self._track_active(item)

    def release_item(self, item: QueueItem) -> None:
        for i, (it, req) in enumerate(self.actives):
            if it is item:
                self._acpu -= req.cpu
                self._ahdd -= req.hdd
                self._agpu -= req.gpu
                del self.actives[i]
                return
        raise ValueError("item is not active")


# ---------------------------------------------------------------------------
# worker pool
# ---------------------------------------------------------------------------

class WorkerPool:
    """Fixed worker slots with parking + ForceStart (ref Scheduler.cs:14-209).

    `run_item(worker_id, item, force_start)` is an async callable supplied by
    the server; errors are reported via `on_error`.
    """

    def __init__(self, queue: ScheduledQueue, run_item,
                 on_start=None, on_finish=None, on_error=None):
        self.queue = queue
        queue.worker_pool = self
        self.run_item_fn = run_item
        self.on_start = on_start
        self.on_finish = on_finish
        self.on_error = on_error
        self.num_parallel = 0
        self.num_running = 0
        self.worker_states: list[str] = []  # inactive / parking / running
        self.parking: set[int] = set()
        self.scheduled_paused = False
        self.user_paused = False

    @property
    def is_paused(self) -> bool:
        return self.scheduled_paused or self.user_paused

    def set_num_parallel(self, n: int) -> None:
        self.num_parallel = n
        while len(self.worker_states) < n:
            wid = len(self.worker_states)
            self.worker_states.append("inactive")
            if not self.is_paused:
                self.worker_states[wid] = "parking"
                self.parking.add(wid)
        for wid in list(self.parking):
            if wid >= n:
                self.worker_states[wid] = "inactive"
                self.parking.discard(wid)
        self.schedule_task()

    def set_pause(self, pause: bool, scheduled: bool = False) -> None:
        before = self.is_paused
        if scheduled:
            self.scheduled_paused = pause
        else:
            self.user_paused = pause
        if self.is_paused != before:
            if self.is_paused:
                for wid in self.parking:
                    self.worker_states[wid] = "inactive"
                self.parking.clear()
            else:
                for wid in range(self.num_parallel):
                    if self.worker_states[wid] == "inactive":
                        self.worker_states[wid] = "parking"
                        self.parking.add(wid)
                self.schedule_task()

    def notify_add_queue(self) -> None:
        self.schedule_task()

    def schedule_task(self) -> None:
        while self.parking:
            item = self.queue.pop_item()
            if item is None:
                return
            wid = min(self.parking)
            self.parking.discard(wid)
            asyncio.ensure_future(self._run(wid, item, False))

    def force_start(self, item: QueueItem) -> None:
        idle = next(
            (i for i, s in enumerate(self.worker_states) if s != "running"), None
        )
        if idle is None:
            idle = len(self.worker_states)
            self.worker_states.append("inactive")
        if self.worker_states[idle] == "parking":
            self.parking.discard(idle)
        self.queue.start_item(item)
        asyncio.ensure_future(self._run(idle, item, True))

    async def _run(self, wid: int, item: QueueItem, force_start: bool) -> None:
        try:
            self.worker_states[wid] = "running"
            self.num_running += 1
            if self.num_running == 1 and self.on_start:
                await self.on_start()
            try:
                await self.run_item_fn(wid, item, force_start)
            except Exception as e:  # noqa: BLE001
                if self.on_error:
                    await self.on_error(wid, "encode failed", e)
            finally:
                self.queue.release_item(item)
            self.worker_states[wid] = "inactive"
            if not self.is_paused and wid < self.num_parallel:
                self.worker_states[wid] = "parking"
                self.parking.add(wid)
                self.schedule_task()
            self.num_running -= 1
            if self.num_running == 0 and self.on_finish:
                await self.on_finish()
        except Exception as e:  # noqa: BLE001
            if self.on_error:
                await self.on_error(wid, "worker crashed", e)


# ---------------------------------------------------------------------------
# in-process phase scheduler (replaces the anonymous-pipe protocol)
# ---------------------------------------------------------------------------

class PhaseScheduler:
    """Per-job phase resource client (ref InterProcessComm.hpp:77-183 +
    the HostThread protocol, TranscodeWorker.cs:492-606).

    Each phase declares CPU/HDD/device needs; entering a phase releases the
    previous phase's resources and acquires the new ones (overlapping jobs
    pipeline through phases under the shared ResourceManager).
    """

    def __init__(self, manager: ResourceManager,
                 phase_resources: dict[str, ReqResource], loop=None):
        self.manager = manager
        self.phase_resources = phase_resources
        self.current: Resource | None = None
        self.current_phase: str | None = None
        self.loop = loop

    async def wait_async(self, phase: str) -> Resource:
        if phase not in PHASES:
            raise ValueError(f"unknown phase: {phase}")
        req = self.phase_resources.get(phase, ReqResource())
        if self.current is not None:
            self.manager.release_resource(self.current)
            self.current = None
        self.current = await self.manager.get_resource(
            req, req_encoder_index=(phase == "Encode")
        )
        self.current_phase = phase
        return self.current

    def wait(self, phase: str):
        """Synchronous bridge for the (synchronous) transcode pipeline."""
        loop = self.loop
        if loop is None:
            return asyncio.run(self.wait_async(phase))
        return asyncio.run_coroutine_threadsafe(
            self.wait_async(phase), loop
        ).result()

    def release(self) -> None:
        if self.current is not None:
            self.manager.release_resource(self.current)
            self.current = None
            self.current_phase = None
