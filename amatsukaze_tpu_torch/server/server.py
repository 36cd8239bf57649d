"""Encode server: queue persistence, profiles, auto-select, worker pool.

Parity targets (AmatsukazeServer/Server/):
- EncodeServer.cs: app data/profiles persistence, MakeAmatsukazeArgs (the
  full CLI line per item), pause/suspend, RPC request handling
- QueueManager.cs: queue persistence, AddQueue with TS probing, state
  machine, retry/reset
- EncodeServerData.cs: Setting/ProfileSetting/ReqResource data model
- PauseScheduler.cs: time-window scheduled pausing

The port's copy of amatsukaze_tpu/server/server.py. The server resolves its
device once, when it is made (`EncodeServer(..., device=None)` is the CUDA
card and raises where there is none; "cpu" runs the kernels' plain PyTorch
versions, as the tests do), and runs every queued transcode and every logo
scan there.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import asdict, dataclass, field, fields

from ..parallel.scheduler import (
    PHASES,
    PhaseScheduler,
    QueueItem,
    ReqResource,
    ScheduledQueue,
    WorkerPool,
)
from ..utils.device import resolve_device
from .rpc import ClientManager

# The fixed finish-action set settable over RPC (ref EncodeServerData
# FinishAction / FinishActionRunner: None/Suspend/Shutdown) and the
# system commands the names map to when the queue drains.
FINISH_ACTIONS = {"", "suspend", "shutdown"}

# sentinel logo entry meaning "no logo is acceptable for this service"
# (ref LogoSetting.NO_LOGO, EncodeServerData.cs:525)
NO_LOGO = "### NO LOGO ###"


def _logo_can_use(ls: dict, ts_time: str) -> bool:
    """LogoSetting.CanUse (EncodeServerData.cs:517-521): the logo must
    be enabled, and when the recording time is known it must fall in
    the [from, to] validity period (ISO strings compare correctly)."""
    if not ls.get("enabled", True):
        return False
    if not ts_time:
        return True
    frm = ls.get("from") or ""
    to = ls.get("to") or ""
    return (not frm or frm <= ts_time) and (not to or ts_time <= to)
_FINISH_ACTION_COMMANDS = {
    "suspend": "systemctl suspend",
    "shutdown": "shutdown -h now",
}


@dataclass
class ProfileSetting:
    """Encode profile (ref EncodeServerData.cs:197-353, subset that maps to
    the CLI)."""

    name: str = "default"
    encoder_type: str = "x264"
    encoder_path: str = "x264"
    encoder_options: str = ""
    audio_encoder_type: str = ""
    audio_encoder_path: str = ""
    output_format: str = "mp4"
    filter_mode: str = "none"  # none/yadif/yadif60/qtgmc/kfm_vfr/kfm_vfr30/
                               # kfm_cfr24/svp/autovfr (FilterSetting's
                               # deinterlacer x fps matrix,
                               # EncodeServerData.cs:106-119)
    filter_path: str = ""
    post_filter_path: str = ""
    # structured filter settings dict (ref FilterSetting,
    # EncodeServerData.cs:132-194; see server/filter_setting.py); empty
    # dict = use the plain filter_mode string above
    filter_setting: dict = field(default_factory=dict)
    two_pass: bool = False
    auto_bitrate: bool = False
    bitrate_a: float = 0.0
    bitrate_b: float = 0.0
    bitrate_h264: float = 1.0
    bitrate_cm: float = 0.5
    split_sub: bool = False
    chapter: bool = False
    rename_format: str = ""  # SCRename-style output naming (server/rename.py)
    subtitles: bool = False
    logo_paths: list = field(default_factory=list)
    ignore_no_logo: bool = True
    ignore_no_drcs_map: bool = False  # ref IgnoreNoDrcsMap
    loose_logo_detection: bool = False
    cm_out_mask: int = 1
    # JLS rule-script selection (ref JLSCommandFile/EnableJLSOption/
    # JLSOption, EncodeServerData.cs:244-252): the profile file wins
    # over the per-service JLSCommand; options come from the profile
    # when enable_jls_option else from the service setting
    jls_command_file: str = ""
    jls_option: str = ""
    enable_jls_option: bool = False
    disable_hash_check: bool = False  # skip hash-dir source verification
    enable_genre_folder: bool = False  # sort outputs into genre subdirs
    # user scripts around each item (ref PreBatFile/PostBatFile/
    # AddBatFile, EncodeServerData.cs + UserScriptExecuter.cs): run with
    # ITEM_* env vars and the RPC callback address used by
    # tools/script_command (AddTag / SetPriority / GetOutFiles / ...)
    pre_bat_file: str = ""
    post_bat_file: str = ""
    add_bat_file: str = ""
    # phase resources: CPU/HDD/device percent per phase (ReqResource)
    req_resources: dict = field(default_factory=lambda: {
        "TSAnalyze": {"cpu": 20, "hdd": 30, "gpu": 0},
        "CMAnalyze": {"cpu": 20, "hdd": 10, "gpu": 50},
        "Filter": {"cpu": 30, "hdd": 10, "gpu": 70},
        "Encode": {"cpu": 50, "hdd": 10, "gpu": 30},
        "Mux": {"cpu": 10, "hdd": 30, "gpu": 0},
    })


@dataclass
class ServerSetting:
    """Global setting (ref Setting in EncodeServerData.cs)."""

    num_parallel: int = 1
    work_dir: str = "./work"
    always_show_disk: str = ""
    num_devices: int = 1
    device_caps: list = field(default_factory=lambda: [100])
    max_retries: int = 1  # auto-requeue failed items (ref TranscodeWorker)
    finish_action: str = ""  # command run when the queue drains
                             # (ref FinishActionRunner suspend/shutdown)
    finish_seconds: int = 0  # countdown before the action fires; the
                             # client may CancelSleep during it (ref
                             # FinishSetting.Seconds, Misc.cs:1623-1638)
    move_after_encode: bool = False  # move sources to succeeded/failed
                                     # dirs with EDCB companions (ref
                                     # TranscodeWorker + ServerSupport)
    # scheduled pausing: [[start_hour, end_hour], ...] local-time
    # windows during which the worker pool pauses (ref
    # Server/PauseScheduler.cs); wrap-around windows (e.g. [23, 6])
    # are supported. Empty = never scheduled-paused.
    pause_windows: list = field(default_factory=list)


@dataclass
class QueueEntry:
    item_id: int
    src_path: str
    out_path: str
    profile_name: str = "default"
    priority: int = 3
    state: str = "queue"  # queue/encoding/complete/failed/canceled/pause
    service_id: int = -1
    added: float = 0.0
    console: list = field(default_factory=list)
    tags: list = field(default_factory=list)
    out_files: list = field(default_factory=list)
    event_name: str = ""
    service_name: str = ""
    ts_time: str = ""  # ISO datetime when probed
    genres: list = field(default_factory=list)  # [level1, level2] pairs (JSON-safe)
    retry_count: int = 0
    width: int = 0   # coded video size from the TS probe (for the
    height: int = 0  # video-size auto-select condition)
    hash: str = ""   # expected SHA-512 (hex) from the source dir's
                     # companion .hash list, verified before encoding
    # pipeline JSON report subset of the last run (ref LogItem's result
    # fields parsed from -enc.json, TranscodeWorker.cs:1085)
    last_report: dict = field(default_factory=dict)


CONSOLE_MAX_LINES = 400  # rolling console capture (ref RollingTextLines)


class _EntryConsole:
    """File-like sink routing a pipeline's log prints into the queue
    entry's rolling console (ref TranscodeWorker's stdout capture)."""

    def __init__(self, server: "EncodeServer", entry: "QueueEntry"):
        self._server = server
        self._entry = entry
        self._buf = ""

    def write(self, s: str) -> None:
        self._buf += s
        while "\n" in self._buf:
            line, _, self._buf = self._buf.partition("\n")
            if line:
                self._server.append_console(self._entry, line)

    def flush(self) -> None:
        if self._buf:
            self._server.append_console(self._entry, self._buf)
            self._buf = ""


class EncodeServer:
    def __init__(self, ctx, data_dir: str = "./data",
                 run_item=None, device=None):
        self.ctx = ctx
        # None is the CUDA card: raises here, before any job is taken,
        # where there is none
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.setting = ServerSetting()
        self.profiles: dict[str, ProfileSetting] = {"default": ProfileSetting()}
        self.auto_select: dict[str, list] = {}  # name -> [(service_id, profile)]
        # per-service settings (ref ServiceSettingElement,
        # EncodeServerData.cs:528-547): CM-check disable, JLS command/
        # option, and per-logo enable + validity period
        self.service_settings: dict[int, dict] = {}
        self.entries: dict[int, QueueEntry] = {}
        self.logs: list[dict] = []
        self._next_id = 1
        self._run_item_impl = run_item or self._default_run_item

        self.queue = ScheduledQueue()
        self.queue.resource_manager.set_gpu_resources(
            self.setting.num_devices, self.setting.device_caps
        )
        self.pool = WorkerPool(self.queue, self._run_item,
                               on_error=self._on_error)
        self.clients = ClientManager(self.handle_request)
        self._server: asyncio.AbstractServer | None = None
        self._pause_sched: PauseScheduler | None = None
        self._drcs: object | None = None  # lazy DRCSManager
        self._logo_scan: dict = {"state": "idle", "progress": "", "out": ""}
        # pending finish-action countdown (ref FinishActionRunner,
        # Misc.cs:1602-1650 + EncodeServer.CancelSleep :2607)
        self._finish_runner: asyncio.Task | None = None
        self._sleep_cancel: dict = {}
        # in-progress batch directory add (ref QueueManager.AddQueue dir
        # scan + EncodeServer.CancelAddQueue :2600)
        self._add_scan_task: asyncio.Task | None = None
        self._add_scan: dict = {"state": "idle", "dir": "",
                                "found": 0, "added": 0}
        # EndServer support (ref ServerInterface.cs:34, finishRequested
        # at EncodeServer.cs:3087-3091): the host awaits this event
        self.end_requested = asyncio.Event()

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 32768) -> int:
        self._acquire_instance_lock()
        self.load_app_data()
        self.pool.set_num_parallel(self.setting.num_parallel)
        self._apply_pause_windows()
        self._server = await asyncio.start_server(
            self.clients.handle_client, host, port
        )
        self._rpc_host = host
        self._rpc_port = self._server.sockets[0].getsockname()[1]
        return self._rpc_port

    @staticmethod
    def _normalize_pause_windows(value) -> list:
        """Validate [[start_hour, end_hour], ...]; raises ValueError on
        malformed input so SetSetting can reject it BEFORE it is
        committed (a bad persisted value must never brick startup)."""
        out = []
        for w in (value or []):
            if isinstance(w, (list, tuple)) and len(w) == 2:
                s, e = int(w[0]), int(w[1])
                if 0 <= s < 24 and 0 <= e <= 24:
                    out.append([s, e % 24])
                    continue
            raise ValueError(f"bad pause window: {w!r} "
                             "(expected [start_hour, end_hour])")
        return out

    def _apply_pause_windows(self) -> None:
        """(Re)start the scheduled-pause runner to match the setting."""
        if self._pause_sched is not None:
            self._pause_sched.stop()
            self._pause_sched = None
        try:
            windows = [(s, e) for s, e in
                       self._normalize_pause_windows(
                           self.setting.pause_windows)]
        except (ValueError, TypeError) as e:
            # tolerate a malformed persisted value: drop it and keep
            # the server bootable
            self.ctx.error("ignoring bad pause_windows: %s", e)
            self.setting.pause_windows = []
            windows = []
        if windows:
            self._pause_sched = PauseScheduler(self.pool, windows)
            self._pause_sched.start()
        else:
            self.pool.set_pause(False, scheduled=True)

    async def stop(self) -> None:
        if self._pause_sched is not None:
            self._pause_sched.stop()
            self._pause_sched = None
        if self._server:
            self._server.close()
            # wait_closed() (3.12+) waits for client handler tasks too, so
            # drop live connections or a connected client blocks shutdown
            for w in list(self.clients.clients):
                w.close()
            await self._server.wait_closed()
        self.save_app_data()
        self._release_instance_lock()

    def _acquire_instance_lock(self) -> None:
        """One server per data dir (ref ServerCLI.cs:20 global mutex)."""
        import fcntl

        os.makedirs(self.data_dir, exist_ok=True)
        self._lock_file = open(self._path("server.lock"), "w")
        try:
            fcntl.flock(self._lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_file.close()
            self._lock_file = None
            raise RuntimeError(
                f"another server instance already runs on {self.data_dir}")
        self._lock_file.write(str(os.getpid()))
        self._lock_file.flush()

    def _release_instance_lock(self) -> None:
        lf = getattr(self, "_lock_file", None)
        if lf is not None:
            lf.close()
            self._lock_file = None

    def disk_space(self) -> list[dict]:
        """Free/total bytes for every mount the queue touches (ref
        EncodeServer's diskMap, EncodeServer.cs:2314-2360). Paths that do
        not exist yet fall back to their nearest existing parent, and
        mounts are reported once (deduplicated by device)."""
        import shutil as _shutil

        # stable labels: configured paths outrank transient queue paths,
        # so a mount's reported identity does not churn with the queue
        ranked = [(0, self.setting.always_show_disk)] if \
            self.setting.always_show_disk else []
        ranked.append((1, self.setting.work_dir or "."))
        ranked += sorted(
            (2, os.path.dirname(e.out_path) or ".")
            for e in self.entries.values())
        out = []
        seen_dev = set()
        for _, p in ranked:
            probe = os.path.abspath(p)
            while probe and not os.path.exists(probe):
                parent = os.path.dirname(probe)
                if parent == probe:
                    break
                probe = parent
            try:
                dev = os.stat(probe).st_dev
                if dev in seen_dev:
                    continue
                seen_dev.add(dev)
                u = _shutil.disk_usage(probe)
            except OSError:
                continue
            out.append({"path": p, "total": u.total, "free": u.free})
        return out

    def _queue_drained(self) -> bool:
        # entry states, not queue.actives: the worker pool releases the
        # finishing item only after _run_item returns, and its state is
        # already terminal by the time the drain check runs
        return not any(e.state in ("queue", "encoding")
                       for e in self.entries.values())

    async def _maybe_finish_action(self) -> None:
        """Run the configured command once when the queue drains, after a
        cancellable countdown (ref FinishActionRunner: suspend/shutdown
        `Seconds` after the last item, Misc.cs:1602-1650; the client may
        CancelSleep during the wait, EncodeServer.cs:2607-2619)."""
        if not self.setting.finish_action or not self._queue_drained():
            return
        if self._finish_runner is not None and not self._finish_runner.done():
            return  # already counting down (ref :300 "2重に走るのは回避する")
        seconds = max(0, int(self.setting.finish_seconds or 0))
        self._sleep_cancel = {"command": self.setting.finish_action,
                              "seconds": seconds}
        await self.clients.broadcast("OnSleepCancel", dict(self._sleep_cancel))
        if seconds <= 0:
            await self._run_finish_action()
        else:
            self._finish_runner = asyncio.create_task(
                self._finish_countdown(seconds))

    async def _finish_countdown(self, seconds: int) -> None:
        try:
            await asyncio.sleep(seconds)
        except asyncio.CancelledError:
            return
        if self._queue_drained():  # new work during the wait re-arms later
            await self._run_finish_action()
        else:
            # countdown expired while new work arrived: clear the armed
            # banner, else the cancel button becomes a dead control until
            # the next drain rewrites the state (ADVICE r4)
            self._sleep_cancel = {}
            await self.clients.broadcast("OnSleepCancel", {})

    async def _run_finish_action(self) -> None:
        cmd = self.setting.finish_action
        if not cmd:
            return
        self.setting.finish_action = ""  # fire once
        self._sleep_cancel = {}
        await self.clients.broadcast("OnFinishAction", {"command": cmd})
        # RPC-settable names map to fixed system commands; a raw shell
        # command can only come from the locally-edited settings file.
        cmd = _FINISH_ACTION_COMMANDS.get(cmd, cmd)
        try:
            proc = await asyncio.create_subprocess_shell(cmd)
            await proc.wait()
        except OSError as e:
            self.ctx.error("finish action failed: %s", e)

    def cancel_sleep(self) -> bool:
        """Cancel a pending finish-action countdown (ref CancelSleep,
        EncodeServer.cs:2607-2619). The configured action stays armed and
        re-runs its countdown the next time the queue drains."""
        if self._finish_runner is not None and not self._finish_runner.done():
            self._finish_runner.cancel()
            self._finish_runner = None
            self._sleep_cancel = {}
            return True
        return False

    # ------------------------------------------------------------ persistence
    def _path(self, name: str) -> str:
        os.makedirs(self.data_dir, exist_ok=True)
        return os.path.join(self.data_dir, name)

    def save_app_data(self) -> None:
        with open(self._path("setting.json"), "w") as f:
            json.dump(asdict(self.setting), f)
        with open(self._path("profiles.json"), "w") as f:
            json.dump({k: asdict(v) for k, v in self.profiles.items()}, f)
        with open(self._path("autoselect.json"), "w") as f:
            json.dump(self.auto_select, f)
        with open(self._path("services.json"), "w") as f:
            json.dump({str(k): v for k, v in self.service_settings.items()},
                      f)
        with open(self._path("queue.json"), "w") as f:
            json.dump([asdict(e) for e in self.entries.values()], f)
        with open(self._path("logs.json"), "w") as f:
            json.dump(self.logs, f)

    def load_app_data(self) -> None:
        def from_dict(cls, d):
            # tolerate unknown keys so app data written by a newer
            # version still loads (the reference migrates versioned XML;
            # JSON + dataclass defaults make that a field filter)
            if not isinstance(d, dict):
                raise TypeError(f"expected object, got {type(d).__name__}")
            names = {f.name for f in fields(cls)}
            return cls(**{k: v for k, v in d.items() if k in names})

        try:
            with open(self._path("setting.json")) as f:
                self.setting = from_dict(ServerSetting, json.load(f))
        except (OSError, json.JSONDecodeError, TypeError):
            pass
        try:
            with open(self._path("profiles.json")) as f:
                self.profiles = {
                    k: from_dict(ProfileSetting, v)
                    for k, v in json.load(f).items()
                }
        except (OSError, json.JSONDecodeError, TypeError):
            pass
        try:
            with open(self._path("services.json")) as f:
                self.service_settings = {
                    int(k): v for k, v in json.load(f).items()
                    if isinstance(v, dict)
                }
        except (OSError, json.JSONDecodeError, ValueError):
            pass
        try:
            with open(self._path("queue.json")) as f:
                for e in json.load(f):
                    try:
                        entry = from_dict(QueueEntry, e)
                    except (TypeError, AttributeError):
                        continue  # one bad entry must not drop the queue
                    # encoding items found at restart go back to queued
                    # (ref: pause-on-restart, EncodeServer.cs:359-367)
                    if entry.state == "encoding":
                        entry.state = "queue"
                    self.entries[entry.item_id] = entry
                    if entry.state == "queue":
                        self._enqueue(entry)
                    self._next_id = max(self._next_id, entry.item_id + 1)
        except (OSError, json.JSONDecodeError, TypeError):
            pass

    # ------------------------------------------------------------ queue ops
    @staticmethod
    def video_size_class(width: int) -> str:
        """fullhd / hd1440 / sd / oneseg by coded width (ref
        ServerSupport.GetVideoSize, Misc.cs:916-931)."""
        if width > 1440:
            return "fullhd"
        if width > 720:
            return "hd1440"
        if width > 320:
            return "sd"
        return "oneseg"

    def profile_for(self, entry: QueueEntry,
                    apply_priority: bool = False) -> ProfileSetting:
        """Auto-select by the reference's full condition set: service id,
        ARIB genre, file-name substring, tag, and coded video size, all
        ANDed within a rule, first matching rule wins (ref
        ServerSupport.AutoSelectProfile, Misc.cs:933-977). Rules are dicts
        {service_id?|service_ids?, genre?: [l1, l2?]|genres?, file_name?,
        tag?, video_size?, profile, priority?}; legacy
        (service_id, profile) pairs still work. A matched rule's
        "priority" key overrides the item priority only when
        apply_priority is set (queue-admission time), so later lookups
        never clobber a user-set priority."""
        for rules in self.auto_select.values():
            for rule in rules:
                if isinstance(rule, (tuple, list)) and len(rule) == 2 \
                        and not isinstance(rule[0], str):
                    service_id, profile = rule
                    rule = {"service_id": service_id, "profile": profile}
                profile = rule.get("profile")
                if profile not in self.profiles:
                    continue
                conds = 0
                sid = rule.get("service_id")
                sids = rule.get("service_ids")
                if sid is not None:
                    sids = [sid] + list(sids or [])
                if sids is not None:
                    conds += 1
                    if entry.service_id not in sids:
                        continue
                genre = rule.get("genre")
                genres = ([genre] if genre is not None else []) \
                    + list(rule.get("genres") or [])
                if genres:
                    conds += 1
                    hit = any(
                        g[0] == want[0] and (len(want) < 2 or g[1] == want[1])
                        for want in map(list, genres)
                        for g in entry.genres
                    )
                    if not hit:
                        continue
                fname = rule.get("file_name")
                if fname is not None:
                    conds += 1
                    if fname not in os.path.basename(entry.src_path):
                        continue
                tag = rule.get("tag")
                if tag is not None:
                    conds += 1
                    if tag not in entry.tags:
                        continue
                vs = rule.get("video_size")
                if vs is not None:
                    conds += 1
                    if entry.width <= 0:
                        continue  # unprobed size must not match any rule
                    want_vs = [vs] if isinstance(vs, str) else list(vs)
                    if self.video_size_class(entry.width) not in want_vs:
                        continue
                if conds == 0:
                    continue  # an empty rule must not match everything
                if apply_priority and "priority" in rule:
                    entry.priority = int(rule["priority"])
                return self.profiles[profile]
        return self.profiles.get(entry.profile_name, self.profiles["default"])


    def _enqueue(self, entry: QueueEntry) -> None:
        profile = self.profile_for(entry)
        req = {
            phase: ReqResource(**res)
            for phase, res in profile.req_resources.items()
        }
        item = QueueItem(
            item_id=entry.item_id, priority=entry.priority,
            order=entry.item_id, req_resources=req, payload=entry,
        )
        self.queue.add_queue(item)

    def _pending_item(self, item_id: int):
        """The scheduler QueueItem for a still-pending entry, or None."""
        for level in self.queue.levels:
            for items in level.values():
                for it in items:
                    if it.item_id == item_id:
                        return it
        return None

    def add_queue(self, src_path: str, out_path: str, profile: str = "default",
                  priority: int = 3, service_id: int = -1) -> QueueEntry:
        entry = self._prepare_entry(src_path, out_path, profile, priority,
                                    service_id)
        return self._register_entry(entry)

    def _prepare_entry(self, src_path: str, out_path: str, profile: str,
                       priority: int, service_id: int) -> QueueEntry:
        """Probe + naming: the loop-free (and slow — TsInfo reads up to
        two 16 MB TS windows) half of add_queue, callable from a worker
        thread (ADVICE r4: batch adds froze the event loop)."""
        entry = QueueEntry(
            item_id=-1, src_path=src_path, out_path=out_path,
            profile_name=profile, priority=priority, service_id=service_id,
            added=time.time(),
        )
        self._probe_item(entry)
        self._lookup_source_hash(entry)
        # the profile that will actually encode (auto-select may redirect)
        # also drives output naming/placement
        prof = self.profile_for(entry, apply_priority=True)
        renamed = False
        if prof.rename_format:
            from .rename import rename_output

            name = rename_output(entry, prof.rename_format)
            if name:
                entry.out_path = os.path.join(
                    os.path.dirname(entry.out_path), name)
                renamed = True
        if prof.enable_genre_folder and not renamed:
            # sort into a main-genre subdir; SCRename-style renaming takes
            # precedence (ref TranscodeWorker.cs:783-806)
            from .genre import GenreItem, main_genre_name
            from .rename import escape_filename

            gname = None
            if entry.genres:
                g = list(entry.genres[0]) + [-1]
                gname = main_genre_name(
                    GenreItem(level1=g[0], level2=g[1]))
            folder = escape_filename(gname, True) if gname \
                else "_ジャンル情報なし"
            entry.out_path = os.path.join(
                os.path.dirname(entry.out_path), folder,
                os.path.basename(entry.out_path))
        return entry

    def _register_entry(self, entry: QueueEntry) -> QueueEntry:
        """Event-loop half of add_queue: assign the id and enqueue."""
        entry.item_id = self._next_id
        self._next_id += 1
        self.entries[entry.item_id] = entry
        if entry.state == "queue":  # hash-dir lookup may have failed it
            add_bat = self.profile_for(entry).add_bat_file
            if add_bat:
                # the add script runs BEFORE the item becomes
                # schedulable (ref AddBatFile): its re-tag /
                # re-prioritize / cancel callbacks need the item still
                # in "queue" state, so enqueue after it finishes
                async def _add_then_enqueue():
                    await self._run_bat(add_bat, entry, "add")
                    if entry.state == "queue":  # script may cancel
                        self._enqueue(entry)

                asyncio.ensure_future(_add_then_enqueue())
            else:
                self._enqueue(entry)
        return entry

    def add_queue_dir(self, dir_path: str, out_dir: str = "",
                      profile: str = "default", priority: int = 3) -> dict:
        """Batch-add every TS file in a directory (ref AddQueueRequest
        with DirPath, QueueManager.cs:290-320: ``.ts``/``.m2t`` files,
        skipping sources already actively queued). Runs as a background
        task — probing each file hits the disk — cancellable with
        CancelAddQueue (QueueManager.cs:545-549); progress is polled
        through GetState's ``add_scan``."""
        if self._add_scan_task is not None and not self._add_scan_task.done():
            return {"ok": False, "error": "add scan already running"}
        try:
            names = sorted(os.listdir(dir_path))
        except OSError as e:
            return {"ok": False, "error": str(e)}
        active = {e.src_path for e in self.entries.values()
                  if e.state in ("queue", "encoding")}
        targets = [os.path.join(dir_path, n) for n in names
                   if n.lower().endswith((".ts", ".m2t", ".m2ts"))]
        targets = [p for p in targets
                   if p not in active and os.path.isfile(p)]
        self._add_scan = {"state": "scanning", "dir": dir_path,
                          "found": len(targets), "added": 0}
        self._add_scan_task = asyncio.create_task(
            self._run_add_scan(targets, out_dir or dir_path,
                               profile, priority))
        return {"ok": True, "found": len(targets)}

    async def _run_add_scan(self, targets: list, out_dir: str,
                            profile: str, priority: int) -> None:
        failed = 0
        last_err = ""
        try:
            for path in targets:
                base = os.path.splitext(os.path.basename(path))[0]
                # probe off-loop: _prepare_entry reads up to two 16 MB
                # TS windows in pure Python — on the event loop it froze
                # the RPC server/web UI for the whole batch and made
                # CancelAddQueue non-prompt (the reference runs
                # TsInfo.ReadFile via Task.Run, QueueManager.cs:322);
                # _register_entry stays on the loop (it spawns worker
                # tasks)
                try:
                    entry = await asyncio.to_thread(
                        self._prepare_entry, path,
                        os.path.join(out_dir, base), profile, priority, -1)
                    self._register_entry(entry)
                    self._add_scan["added"] += 1
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - per-file failure
                    # one corrupt TS must not block the rest of the
                    # batch (the reference keeps going per file and
                    # registers the failure, QueueManager.cs:322+); the
                    # scan reports the failure count and the last error
                    failed += 1
                    last_err = f"{os.path.basename(path)}: {e}"
                    self.ctx.error(f"add-scan failed on {path}: {e}")
                    self._add_scan["failed"] = failed
                    self._add_scan["error"] = last_err
            self._add_scan["state"] = "failed" if failed and not \
                self._add_scan["added"] else "done"
        except asyncio.CancelledError:
            self._add_scan["state"] = "canceled"
            raise

    def cancel_add_queue(self) -> bool:
        """Cancel an in-progress directory scan (ref CancelAddQueue,
        EncodeServer.cs:2600-2604). Items already added stay queued."""
        if self._add_scan_task is not None and not self._add_scan_task.done():
            self._add_scan_task.cancel()
            # mark here too: a task canceled before its first await never
            # reaches the coroutine's own CancelledError handler
            self._add_scan["state"] = "canceled"
            return True
        return False

    def _probe_item(self, entry: QueueEntry) -> None:
        """Fill program info from the source TS (ref QueueManager.AddQueue's
        TsInfo probing, QueueManager.cs:273-545). Best effort."""
        entry.event_name = ""
        entry.service_name = ""
        entry.ts_time = ""
        if not os.path.exists(entry.src_path):
            return
        try:
            from ..ts.info import TsInfo

            info = TsInfo(self.ctx)
            info.read_file(entry.src_path)
            prog = (info.get_program(entry.service_id)
                    if entry.service_id > 0 else
                    (info.programs[0] if info.programs else None))
            if prog is None:
                return
            if entry.service_id <= 0:
                entry.service_id = prog.service_id
            entry.service_name = info.service_names.get(prog.service_id, "")
            ev = info.events.get(prog.service_id)
            if ev:
                entry.event_name = ev.name
                entry.genres = [list(g) for g in ev.genres]
            if prog.format_ok:
                entry.width = prog.video_format.width
                entry.height = prog.video_format.height
            if info.time is not None:
                dt = info.time.to_datetime()
                if dt is not None:
                    entry.ts_time = dt.isoformat()
        except Exception as e:  # noqa: BLE001 — probing is best-effort
            self.ctx.warn("TsInfo probe failed for %s: %s",
                          entry.src_path, e)

    def make_cli_args(self, entry: QueueEntry, profile: ProfileSetting) -> list[str]:
        """Build the CLI line for one item (ref MakeAmatsukazeArgs,
        EncodeServer.cs:1202-1459)."""
        args = [
            "-i", entry.src_path,
            "-o", entry.out_path,
            "-w", self.setting.work_dir,
            "-et", profile.encoder_type,
            "-e", profile.encoder_path,
            "-fmt", profile.output_format,
        ]
        if profile.filter_setting:
            # structured filter settings (ref FilterSetting,
            # EncodeServerData.cs:132-194) take precedence over the
            # plain filter_mode string
            from .filter_setting import FilterSetting, filter_setting_args

            args += filter_setting_args(
                FilterSetting.from_dict(profile.filter_setting))
        elif profile.filter_mode and profile.filter_mode != "none":
            args += ["--filter-mode", profile.filter_mode]
        if profile.encoder_options:
            args += ["-eo", profile.encoder_options]
        if profile.auto_bitrate:
            args += ["-b", f"{profile.bitrate_a}:{profile.bitrate_b}:"
                          f"{profile.bitrate_h264}"]
        args += ["-bcm", str(profile.bitrate_cm)]
        if profile.two_pass:
            args += ["--2pass"]
        if profile.split_sub:
            args += ["--splitsub"]
        if profile.chapter:
            args += ["--chapter"]
        if profile.subtitles:
            args += ["--subtitles"]
        # DRCS mapping always rides along (ref MakeAmatsukazeArgs,
        # EncodeServer.cs:1240-1242): encodes load the server map and
        # drop unmapped bitmaps into the dir DRCSManager watches
        os.makedirs(self.drcs_dir(), exist_ok=True)
        args += ["--drcs", os.path.join(self.drcs_dir(), "drcs_map.txt")]
        if profile.ignore_no_drcs_map:
            args += ["--ignore-no-drcsmap"]
        logo_paths = list(profile.logo_paths)
        if entry.service_id > 0:
            # per-service logo auto-selection: every .lgd in the logo
            # directory whose header carries this service id is used
            # (ref EncodeServer's ServiceSettings LogoSettings sync +
            # MakeAmatsukazeArgs logo list)
            for lp in self.logos_for_service(entry.service_id):
                if lp not in logo_paths:
                    logo_paths.append(lp)
        ignore_no_logo = profile.ignore_no_logo
        svc = self.service_settings.get(entry.service_id)
        if svc and svc.get("logo_settings"):
            # per-service logo management (ref TranscodeWorker.cs:715-732):
            # a logo listed in the service setting is passed only while
            # LogoSetting.CanUse(TsTime) holds; unlisted logos keep the
            # scan default (enabled). An enabled NO_LOGO sentinel makes
            # the logo optional for this service.
            listed = {ls.get("file_name", ""): ls
                      for ls in svc["logo_settings"]}
            usable = {name for name, ls in listed.items()
                      if _logo_can_use(ls, getattr(entry, "ts_time", ""))}
            if NO_LOGO in usable:
                ignore_no_logo = True
            logo_paths = [lp for lp in logo_paths
                          if os.path.basename(lp) not in listed
                          or os.path.basename(lp) in usable]
        for lp in logo_paths:
            args += ["--logo", lp]
        if ignore_no_logo:
            args += ["--ignore-no-logo"]
        # JLS command selection (ref TranscodeWorker.cs:884-892): the
        # per-service DisableCMCheck gates the whole JLS rule path; the
        # profile's command file wins over the service's
        if svc and not svc.get("disable_cm_check", True):
            jls_cmd = profile.jls_command_file or svc.get("jls_command", "")
            if jls_cmd:
                args += ["--jls-cmd", jls_cmd]
            jls_opt = (profile.jls_option if profile.enable_jls_option
                       else svc.get("jls_option", ""))
            if jls_opt:
                args += ["--jls-option", jls_opt]
        if profile.loose_logo_detection:
            args += ["--loose-logo-detection"]
        args += ["-om", str(profile.cm_out_mask)]
        if entry.service_id > 0:
            args += ["-s", str(entry.service_id)]
        if profile.audio_encoder_type:
            args += ["-aet", profile.audio_encoder_type,
                     "-ae", profile.audio_encoder_path]
        return args

    # ------------------------------------------------------------ execution
    async def _run_bat(self, script: str, entry, phase: str,
                       result: dict | None = None) -> None:
        """Run a profile user script with the item env (ref
        UserScriptExecuter.cs; failures are logged, never fatal)."""
        if not script:
            return
        from ..tools.user_script import run_user_script

        try:
            rc = await run_user_script(
                self.ctx, script, entry, phase,
                server_host=getattr(self, "_rpc_host", "127.0.0.1"),
                server_port=getattr(self, "_rpc_port", 0),
                result=result)
            if rc:
                self.append_console(entry,
                                    f"{phase} script exited with {rc}")
        except Exception as e:  # noqa: BLE001 - scripts must not kill items
            self.ctx.error("user script failed: %s", e)
            self.append_console(entry, f"{phase} script failed: {e}")

    async def _run_item(self, worker_id: int, item: QueueItem,
                        force_start: bool) -> None:
        entry: QueueEntry = item.payload
        entry.state = "encoding"
        start = time.time()
        await self.clients.broadcast("OnQueueUpdate", asdict(entry))
        phase = PhaseScheduler(
            self.queue.resource_manager,
            {p: item.req_resources.get(p, ReqResource()) for p in PHASES},
            loop=asyncio.get_running_loop(),
        )
        profile = self.profile_for(entry)
        await self._run_bat(profile.pre_bat_file, entry, "pre")
        try:
            ok = await self._run_item_impl(self, worker_id, entry, phase)
            entry.state = "complete" if ok else "failed"
        except Exception as e:  # noqa: BLE001
            entry.state = "failed"
            self.append_console(entry, str(e))
        finally:
            phase.release()
        if (entry.state == "failed"
                and entry.retry_count < self.setting.max_retries):
            # auto-retry (ref TranscodeWorker retry logic)
            entry.retry_count += 1
            entry.state = "queue"
            self.append_console(
                entry, f"retrying ({entry.retry_count}/"
                       f"{self.setting.max_retries})")
            self._enqueue(entry)
        if entry.state in ("complete", "failed"):
            # TERMINAL only (like _move_source below): a failure that is
            # about to auto-retry must not fire the user's post
            # automation with SUCCESS=0 and then again with SUCCESS=1
            await self._run_bat(
                profile.post_bat_file, entry, "post",
                result={"ok": entry.state == "complete",
                        "error": (entry.console or [""])[-1]
                        if entry.state == "failed" else "",
                        "out_files": list(entry.out_files)})
        if (entry.state in ("complete", "failed")
                and self.setting.move_after_encode):
            self._move_source(entry)
        self.logs.append({
            "id": entry.item_id, "src": entry.src_path,
            "state": entry.state, "retries": entry.retry_count,
            "profile": entry.profile_name,
            "out_files": list(entry.out_files),
            "encode_seconds": round(time.time() - start, 2),
            "finished": time.time(),
            # result detail (ref LogItem's parsed -enc.json fields)
            "report": dict(entry.last_report),
            # full console text on disk, retrievable after the rolling
            # in-memory console ages out (ref RequestLogFile ->
            # ReadLogFIle(EncodeStartDate), EncodeServer.cs:2986-2997)
            "log_file": self._write_log_file(entry),
        })
        await self.clients.broadcast("OnQueueUpdate", asdict(entry))
        await self.clients.broadcast("OnLogUpdate", self.logs[-1])
        await self._maybe_finish_action()

    # EDCB writes companion files beside the recording; they travel with it
    # (ref ServerSupport's EDCB file moves, TranscodeWorker succeeded/failed
    # folders)
    EDCB_COMPANIONS = (".err", ".program.txt")

    def _move_source(self, entry: QueueEntry) -> None:
        """Move the finished source (+ companions) into a succeeded/ or
        failed/ subfolder of its directory."""
        sub = "succeeded" if entry.state == "complete" else "failed"
        src = entry.src_path
        if not os.path.exists(src):
            return
        dst_dir = os.path.join(os.path.dirname(src) or ".", sub)
        try:
            os.makedirs(dst_dir, exist_ok=True)
            moved = os.path.join(dst_dir, os.path.basename(src))
            os.replace(src, moved)
            for suffix in self.EDCB_COMPANIONS:
                comp = src + suffix
                if os.path.exists(comp):
                    os.replace(comp, os.path.join(
                        dst_dir, os.path.basename(comp)))
            entry.src_path = moved
            self.append_console(entry, f"moved source to {sub}/")
        except OSError as e:
            self.append_console(entry, f"source move failed: {e}")

    def _write_log_file(self, entry: QueueEntry) -> str:
        """Persist the item's full console under <data>/logs and return
        the file name (the GetLogFile payload). One file per attempt so
        retries keep their own history, like the reference's
        per-EncodeStartDate log files (EncodeServer.cs ReadLogFIle)."""
        name = f"item{entry.item_id}_try{entry.retry_count}.txt"
        log_dir = self._path("logs")
        os.makedirs(log_dir, exist_ok=True)
        try:
            with open(os.path.join(log_dir, name), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(entry.console))
        except OSError:
            return ""
        return name

    def read_log_file(self, name: str) -> str:
        """The persisted console text for a GetLogs entry's log_file
        (ref ServerInterface RequestLogFile -> OnLogFile round trip)."""
        if not name or os.path.basename(name) != name:
            raise ValueError("bad log file name")
        with open(os.path.join(self._path("logs"), name),
                  encoding="utf-8") as f:
            return f.read()

    def append_console(self, entry: QueueEntry, line: str) -> None:
        entry.console.append(line)
        if len(entry.console) > CONSOLE_MAX_LINES:
            del entry.console[:len(entry.console) - CONSOLE_MAX_LINES]

    def _lookup_source_hash(self, entry: QueueEntry) -> None:
        """Sources added from a "hash dir" (a directory with a companion
        <dir>.hash SHA-512 list, e.g. a NAS filled by AddTask) carry their
        expected digest so the encode-time copy is verified (ref
        QueueManager.cs:578-600)."""
        src_dir = os.path.dirname(os.path.abspath(entry.src_path))
        # sibling <dir>.hash is the reference convention
        # (QueueManager.cs:580); <dir>/hash.txt is what our AddTask writes
        hash_path = next(
            (p for p in (src_dir + ".hash",
                         os.path.join(src_dir, "hash.txt"))
             if os.path.exists(p)), None)
        if hash_path is None:
            return
        from ..tools.hash_check import read_hash_file

        try:
            digests = read_hash_file(hash_path)
        except (OSError, ValueError) as e:
            self.append_console(entry, f"bad hash file {hash_path}: {e}")
            entry.state = "failed"
            return
        digest = digests.get(os.path.basename(entry.src_path))
        if digest is None:
            self.append_console(
                entry, f"no hash for {os.path.basename(entry.src_path)} "
                f"in {hash_path}")
            entry.state = "failed"
            return
        entry.hash = digest.hex()

    def _verified_local_source(self, entry: QueueEntry,
                               profile: ProfileSetting) -> str | None:
        """Copy a hash-dir source to the local work dir, verifying the
        SHA-512 during the copy (ref TranscodeWorker.cs:840-861). Returns
        the local path, or None when verification is off. Raises on
        digest mismatch."""
        if not entry.hash or profile.disable_hash_check:
            return None
        from ..tools.hash_check import copy_with_hash

        os.makedirs(self.setting.work_dir, exist_ok=True)
        local = os.path.join(
            self.setting.work_dir,
            f"item{entry.item_id}_{os.path.basename(entry.src_path)}")
        try:
            digest = copy_with_hash(entry.src_path, local)
            if digest.hex() != entry.hash:
                raise IOError(
                    f"source hash mismatch for {entry.src_path} "
                    f"(expected {entry.hash[:16]}…, got "
                    f"{digest.hex()[:16]}…)")
        except BaseException:
            try:  # no partial-copy debris on mismatch or I/O failure
                os.remove(local)
            except OSError:
                pass
            raise
        self.append_console(entry, "hash-verified local copy -> " + local)
        return local

    async def _default_run_item(self, server, worker_id, entry, phase) -> bool:
        """In-process transcode (the reference spawns Amatsukaze.exe; we run
        the pipeline in a thread on self.device, phases gated by the shared
        manager)."""
        from ..cli import args_to_config, build_parser
        from ..pipeline.settings import Settings
        from ..pipeline.transcode import TranscodePipeline
        from ..pipeline.decoders import default_decoder_factory
        from ..utils.context import AMTContext

        profile = self.profile_for(entry)
        loop = asyncio.get_running_loop()
        local_src = None
        orig_src = entry.src_path
        try:
            local_src = await loop.run_in_executor(
                None, self._verified_local_source, entry, profile)
        except (OSError, IOError) as e:
            self.append_console(entry, str(e))
            return False
        try:
            if local_src:
                entry.src_path = local_src
            # rename/genre-folder placement may point into a not-yet-
            # existing subdir (the reference calls Directory.CreateDirectory)
            out_dir = os.path.dirname(entry.out_path)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
            argv = self.make_cli_args(entry, profile)
            args = build_parser().parse_args(argv)
            conf = args_to_config(args)
            # per-item context: the pipeline's log lines land in the
            # item's rolling console and hence its persisted log file —
            # the reference's TranscodeWorker captures Amatsukaze.exe's
            # stdout the same way (TranscodeWorker.cs rolling console)
            # always capture at info: the persisted log must hold the
            # full run transcript even when the server itself is quiet
            item_ctx = AMTContext(
                level="debug" if self.ctx.level == "debug" else "info",
                time_prefix=True, out=_EntryConsole(self, entry))
            # the job's trace: its root span, and the pipeline's set-up
            trace = item_ctx.trace
            trace.open_root()
            init = trace.begin("pipeline.init")
            item_ctx.drcs_map.update(self.ctx.drcs_map)
            settings = Settings(item_ctx, conf)
            # every job runs on self.device: the gpu_index that the
            # ResourceManager assigns to a phase is not passed on (one card)
            pipe = TranscodePipeline(
                item_ctx, settings,
                decoder_factory=default_decoder_factory(),
                phase_scheduler=phase, device=self.device,
            )
            trace.end(init)
            report = await loop.run_in_executor(None, pipe.run)
            if report:
                entry.out_files = [
                    of.get("path", "") for of in report.get("outfiles", [])]
                entry.last_report = {
                    k: report.get(k) for k in (
                        "srcfilesize", "intvideofilesize", "outfilesize",
                        "srcduration", "outduration", "audiodiff", "error",
                        "encodewaits", "logofiles", "cmanalyze",
                        "outfiles")}
                if entry.hash and not profile.disable_hash_check:
                    await loop.run_in_executor(
                        None, self._record_output_hashes, entry)
            return bool(report)
        finally:
            entry.src_path = orig_src
            if local_src:
                try:
                    os.remove(local_src)
                except OSError:
                    pass

    def _record_output_hashes(self, entry: QueueEntry) -> None:
        """Append SHA-512s of the outputs to _encoded.hash beside them
        (ref TranscodeWorker.cs:1105-1110)."""
        from ..tools.hash_check import append_hash, file_hash

        for path in entry.out_files:
            if not path or not os.path.exists(path):
                continue
            try:
                append_hash(
                    os.path.join(os.path.dirname(path), "_encoded.hash"),
                    os.path.basename(path), file_hash(path))
            except OSError as e:
                self.append_console(entry, f"output hash failed: {e}")

    async def _on_error(self, worker_id: int, message: str, exc) -> None:
        self.ctx.error("worker %d: %s: %s", worker_id, message, exc)

    # ------------------------------------------------------------ RPC surface
    async def handle_request(self, method: str, payload):
        if method == "AddQueue":
            if os.path.isdir(payload["src"]):
                # a directory: batch-scan it like the reference's
                # AddQueueRequest.DirPath (QueueManager.cs:290-320)
                return self.add_queue_dir(
                    payload["src"], payload.get("out", ""),
                    payload.get("profile", "default"),
                    payload.get("priority", 3))
            entry = self.add_queue(
                payload["src"], payload.get("out", payload["src"] + ".out"),
                payload.get("profile", "default"),
                payload.get("priority", 3),
                payload.get("service_id", -1),
            )
            return {"item_id": entry.item_id}
        if method == "GetQueue":
            return [asdict(e) for e in self.entries.values()]
        if method == "GetGenreTable":
            # ARIB EIT genre nibble map for client-side genre browsing
            # (ref GenreData-driven displays, AmatsukazeServer GenreData)
            from .genre import ARIB_GENRES

            return {str(l1): {"name": name,
                              "subs": {str(l2): sub
                                       for l2, sub in subs.items()}}
                    for l1, (name, subs) in ARIB_GENRES.items()}
        if method == "GetLogs":
            return self.logs
        if method == "GetLogFile":
            # full persisted console text of a finished encode (ref
            # RequestLogFile, ServerInterface.cs:38/531). Accepts the
            # log entry's log_file name or an item id (latest attempt).
            name = payload.get("file", "")
            if not name:
                wanted = payload.get("id")
                for log in reversed(self.logs):
                    if log["id"] == wanted and log.get("log_file"):
                        name = log["log_file"]
                        break
            if not name:
                return {"text": "", "file": ""}
            try:
                return {"text": self.read_log_file(name), "file": name}
            except (OSError, ValueError):
                return {"text": "", "file": name}
        if method == "PauseEncode":
            self.pool.set_pause(bool(payload.get("pause", True)))
            return {"paused": self.pool.is_paused}
        if method == "SetProfile":
            p = ProfileSetting(**payload)
            self.profiles[p.name] = p
            return {"ok": True}
        if method == "GetProfiles":
            return {k: asdict(v) for k, v in self.profiles.items()}
        if method == "PreviewFilter":
            # compiled filter-graph mode + CLI flags for a FilterSetting
            # dict (the web filter editor's live preview; the WPF client
            # shows the generated AVS script the same way)
            from .filter_setting import (FilterSetting, filter_mode_of,
                                         filter_setting_args)
            fs = FilterSetting.from_dict(payload or {})
            return {"mode": filter_mode_of(fs),
                    "args": filter_setting_args(fs)}
        if method == "RemoveProfile":
            self.profiles.pop(payload.get("name", ""), None)
            return {"ok": True}
        if method == "SetNumParallel":
            self.setting.num_parallel = int(payload["n"])
            self.pool.set_num_parallel(self.setting.num_parallel)
            return {"ok": True}
        if method == "CancelItem":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry and entry.state == "queue":
                entry.state = "canceled"
                for item, _ in list(self.queue.actives):
                    pass
                # remove from pending queue
                for level in self.queue.levels:
                    for items in level.values():
                        for it in list(items):
                            if it.item_id == entry.item_id:
                                items.remove(it)
                return {"ok": True}
            return {"ok": False}
        if method == "ChangeItem":
            # queue item operations (ref ChangeItemType,
            # EncodeServerData.cs:782-795 + QueueManager.ChangeItem)
            typ = payload.get("type", "")
            if typ == "remove_completed":
                done = [i for i, e in self.entries.items()
                        if e.state == "complete"]
                for i in done:
                    del self.entries[i]
                return {"ok": True, "removed": len(done)}
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None:
                return {"ok": False, "error": "no such item"}
            item = self._pending_item(entry.item_id)
            if typ in ("reset", "update_profile"):
                # ResetState / UpdateProfile: requeue from any finished
                # state (UpdateProfile re-runs auto profile selection)
                if entry.state not in ("failed", "canceled", "complete"):
                    return {"ok": False}
                if typ == "update_profile" and payload.get("profile"):
                    entry.profile_name = str(payload["profile"])
                entry.state = "queue"
                entry.retry_count = 0
                self._enqueue(entry)
                return {"ok": True}
            if typ == "duplicate":
                dup = self.add_queue(entry.src_path, entry.out_path,
                                     entry.profile_name, entry.priority,
                                     entry.service_id)
                return {"ok": True, "item_id": dup.item_id}
            if typ == "priority":
                pr = max(1, min(5, int(payload.get("priority",
                                                   entry.priority))))
                entry.priority = pr
                if item is not None:
                    self.queue.remove_queue(item)
                    item.priority = pr
                    self.queue.add_queue(item)
                return {"ok": True}
            if typ == "profile":
                if entry.state != "queue":
                    return {"ok": False}
                entry.profile_name = str(payload.get("profile",
                                                     entry.profile_name))
                if item is not None:
                    # resource requirements come from the profile:
                    # rebuild the scheduler item
                    self.queue.remove_queue(item)
                    self._enqueue(entry)
                return {"ok": True}
            if typ == "remove":
                if entry.state == "encoding":
                    return {"ok": False, "error": "item is encoding"}
                if item is not None:
                    self.queue.remove_queue(item)
                del self.entries[entry.item_id]
                return {"ok": True}
            if typ == "force_start":
                if item is None or entry.state != "queue":
                    return {"ok": False}
                self.queue.remove_queue(item)
                self.pool.force_start(item)
                return {"ok": True}
            if typ == "remove_source":
                # only for finished items (ref: 通常/自動追加の完了item)
                if entry.state != "complete":
                    return {"ok": False}
                try:
                    os.remove(entry.src_path)
                except OSError as e:
                    return {"ok": False, "error": str(e)}
                return {"ok": True}
            if typ in ("move_top", "move_bottom"):
                if item is None:
                    return {"ok": False}
                orders = [it.order for level in self.queue.levels
                          for items in level.values() for it in items]
                item.order = (min(orders) - 1 if typ == "move_top"
                              else max(orders) + 1)
                self.queue.make_dirty()
                return {"ok": True}
            return {"ok": False, "error": f"unknown type {typ!r}"}
        # ScriptCommand RPCs (ref ServerInterface.cs:111-115 ids 300+,
        # used by pre/post user scripts via tools/script_command.py)
        if method == "AddTag":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None:
                return {"ok": False}
            tag = payload.get("tag", "")
            if tag and tag not in entry.tags:
                entry.tags.append(tag)
            return {"ok": True, "tags": entry.tags}
        if method == "SetPriority":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None or entry.state != "queue":
                return {"ok": False}
            entry.priority = int(payload.get("priority", entry.priority))
            return {"ok": True}
        if method == "GetOutFiles":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None:
                return {"ok": False}
            return {"ok": True, "out_files": entry.out_files}
        if method == "RetryItem":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None or entry.state not in ("failed", "canceled"):
                return {"ok": False}
            entry.state = "queue"
            self._enqueue(entry)
            return {"ok": True}
        if method == "GetDiskSpace":
            return self.disk_space()
        if method == "GetConsole":
            entry = self.entries.get(payload.get("item_id", -1))
            if entry is None:
                return {"ok": False}
            return {"ok": True, "console": entry.console}
        if method == "SetFinishAction":
            # Over RPC only the reference's fixed action set is accepted
            # (ref FinishActionRunner: None/Suspend/Shutdown) — an
            # arbitrary shell command may still be configured via the
            # locally-persisted settings file, but not by a remote
            # client, so exposing the port never exposes command exec.
            cmd = str(payload.get("command", ""))
            if cmd not in FINISH_ACTIONS:
                return {"ok": False,
                        "error": f"finish action must be one of "
                                 f"{sorted(FINISH_ACTIONS)}"}
            self.setting.finish_action = cmd
            if "seconds" in payload:
                self.setting.finish_seconds = max(
                    0, int(payload.get("seconds", 0)))
            if not cmd:
                self.cancel_sleep()
            return {"ok": True}
        if method == "CancelSleep":
            # cancel a pending finish-action countdown (ref
            # ServerInterface.cs:29/71, EncodeServer.cs:2607-2619)
            return {"ok": True, "canceled": self.cancel_sleep()}
        if method == "CancelAddQueue":
            # cancel an in-progress directory scan (ref
            # ServerInterface.cs:28, EncodeServer.cs:2600-2604)
            return {"ok": True, "canceled": self.cancel_add_queue()}
        if method == "EndServer":
            # graceful shutdown request (ref ServerInterface.cs:34,
            # EncodeServer.cs:3087-3091 finishRequested) — the host
            # (server/cli.py) awaits end_requested and tears down
            self.end_requested.set()
            return {"ok": True}
        # ---- GUI-backing RPCs (the reference exposes these to the WPF
        # client via ServerInterface.cs; the web client uses them) --------
        if method == "GetSetting":
            return asdict(self.setting)
        if method == "SetSetting":
            cur = asdict(self.setting)
            # same RPC restriction as SetFinishAction: no remote client
            # may configure an arbitrary shell command
            if str(payload.get("finish_action", "")) not in FINISH_ACTIONS:
                payload = dict(payload)
                payload.pop("finish_action", None)
            if "pause_windows" in payload:
                # validate BEFORE committing: a malformed value must not
                # reach self.setting (it would persist and then crash
                # every subsequent startup)
                try:
                    payload = dict(payload)
                    payload["pause_windows"] = \
                        self._normalize_pause_windows(
                            payload["pause_windows"])
                except (ValueError, TypeError) as e:
                    return {"ok": False, "error": str(e)}
            cur.update({k: v for k, v in payload.items() if k in cur})
            self.setting = ServerSetting(**cur)
            self.pool.set_num_parallel(self.setting.num_parallel)
            self.queue.resource_manager.set_gpu_resources(
                self.setting.num_devices, self.setting.device_caps)
            if "pause_windows" in payload:
                self._apply_pause_windows()
            return {"ok": True}
        if method == "GetServices":
            # service list aggregated from probed queue items + the logo
            # directory's per-service .lgd files (ref the GUI's service
            # management pane over ServiceSettings)
            services: dict[int, dict] = {}
            for e in self.entries.values():
                if e.service_id > 0:
                    svc = services.setdefault(
                        e.service_id, {"service_id": e.service_id,
                                       "name": "", "logos": []})
                    if e.service_name:
                        svc["name"] = e.service_name
            from ..models.lgd import load_lgd

            for name in sorted(os.listdir(self.logo_dir())):
                if not name.endswith(".lgd"):
                    continue
                try:
                    logo = load_lgd(os.path.join(self.logo_dir(), name))
                except (OSError, ValueError):
                    continue
                sid = getattr(logo.header, "service_id", -1)
                if sid > 0:
                    svc = services.setdefault(
                        sid, {"service_id": sid, "name": "", "logos": []})
                    svc["logos"].append(name)
                    if not svc["name"] and logo.header.name != "No Name":
                        svc["name"] = logo.header.name
            for sid, svc in services.items():
                svc["setting"] = self.service_settings.get(sid, {})
            return sorted(services.values(),
                          key=lambda s_: s_["service_id"])
        if method == "SetServiceSetting":
            # per-service settings update (ref SetServiceSetting RPC,
            # ClientManager.cs:279-280 -> ServiceSettingElement)
            sid = int(payload.get("service_id", 0))
            if sid <= 0:
                return {"ok": False, "error": "service_id required"}
            elem = {
                "service_id": sid,
                "service_name": str(payload.get("service_name", "")),
                "disable_cm_check": bool(
                    payload.get("disable_cm_check", True)),
                "jls_command": str(payload.get("jls_command", "")),
                "jls_option": str(payload.get("jls_option", "")),
                "logo_settings": [
                    {"file_name": str(ls.get("file_name", "")),
                     "enabled": bool(ls.get("enabled", True)),
                     "from": str(ls.get("from", "") or ""),
                     "to": str(ls.get("to", "") or "")}
                    for ls in payload.get("logo_settings", [])
                    if isinstance(ls, dict)
                ],
            }
            self.service_settings[sid] = elem
            self.save_app_data()
            await self.clients.broadcast("OnServiceSetting", elem)
            return {"ok": True}
        if method == "GetAutoSelect":
            return self.auto_select
        if method == "SetAutoSelect":
            self.auto_select = dict(payload)
            return {"ok": True}
        if method == "GetState":
            states: dict[str, int] = {}
            for e in self.entries.values():
                states[e.state] = states.get(e.state, 0) + 1
            return {
                "paused": self.pool.is_paused,
                "scheduled_paused": self.pool.scheduled_paused,
                "num_parallel": self.setting.num_parallel,
                "states": states,
                "logo_scan": dict(self._logo_scan),
                "add_scan": dict(self._add_scan),
                "sleep_cancel": dict(self._sleep_cancel),
            }
        if method == "GetDrcsImages":
            mgr = self._drcs_manager()
            return [{"md5": i.md5, "map": i.map_str,
                     "has_image": bool(i.bmp_path),
                     "sources": [list(s) for s in i.sources]}
                    for i in mgr.update()]
        if method == "AddDrcsMapping":
            mgr = self._drcs_manager()
            md5 = str(payload.get("md5", ""))
            text = str(payload.get("text", ""))
            if len(md5) != 32 or not text:
                return {"ok": False}
            mgr.add_mapping(md5, text)
            return {"ok": True}
        if method == "GetLogoFiles":
            return self._logo_files()
        if method == "RenameLogo":
            from ..models.logo_render import GUILogoFile
            path = os.path.join(self.logo_dir(),
                                os.path.basename(str(payload.get("file", ""))))
            if not os.path.exists(path):
                return {"ok": False}
            lf = GUILogoFile(path)
            lf.set_name(str(payload.get("name", "")))
            lf.save()
            return {"ok": True}
        if method == "ScanLogo":
            return await self._start_logo_scan(payload)
        return {"error": f"unknown method {method}"}

    # ------------------------------------------------------- GUI helpers
    def logo_dir(self) -> str:
        d = os.path.join(self.data_dir, "logo")
        os.makedirs(d, exist_ok=True)
        return d

    def drcs_dir(self) -> str:
        return os.path.join(self.data_dir, "drcs")

    def _drcs_manager(self):
        if self._drcs is None:
            from .drcs import DRCSManager
            self._drcs = DRCSManager(self.ctx, self.drcs_dir())
        return self._drcs

    def logos_for_service(self, service_id: int) -> list[str]:
        """Paths of logo files registered for a service (scanned from
        the logo directory's .lgd headers; cached by directory mtime —
        the reference's WatchFileThread keeps the same mapping hot)."""
        from ..models.lgd import load_lgd

        d = self.logo_dir()
        try:
            mtime = os.path.getmtime(d)
        except OSError:
            return []
        cache = getattr(self, "_logo_service_cache", None)
        if cache is None or cache[0] != mtime:
            mapping: dict[int, list] = {}
            for name in sorted(os.listdir(d)):
                if not name.endswith(".lgd"):
                    continue
                path = os.path.join(d, name)
                try:
                    logo = load_lgd(path)
                except (OSError, ValueError):
                    continue
                sid = getattr(logo.header, "service_id", -1)
                if sid > 0:
                    mapping.setdefault(sid, []).append(path)
            cache = (mtime, mapping)
            self._logo_service_cache = cache
        return list(cache[1].get(service_id, []))

    def _logo_files(self) -> list[dict]:
        from ..models.logo_render import GUILogoFile
        out = []
        for name in sorted(os.listdir(self.logo_dir())):
            if not name.endswith(".lgd"):
                continue
            try:
                lf = GUILogoFile(os.path.join(self.logo_dir(), name))
                out.append({"file": name, "name": lf.name,
                            "width": lf.width, "height": lf.height})
            except (OSError, ValueError):
                continue
        return out

    def _default_logo_frames(self, src: str):
        """(frame_iter, imgw, imgh) for a logo scan; frames are (Y, U, V)
        planes. ffmpeg when a binary exists (any codec), else the
        in-build demux + MPEG decoder — the wizard is standalone for
        broadcast TS."""
        import shutil as _sh

        if _sh.which("ffmpeg"):
            from ..pipeline.decoders import ffmpeg_generic_decoder

            fmt, frames, _audio = ffmpeg_generic_decoder(src)
        else:
            from ..pipeline.decoders import inbuild_generic_decoder

            fmt, frames, _audio = inbuild_generic_decoder(src)
        return frames, fmt.width, fmt.height

    async def _start_logo_scan(self, payload) -> dict:
        """Logo-generation wizard backend (ref the ScanLogo DLL export +
        LogoAnalyzeModel.cs:288). Runs in a worker thread; progress is
        polled through GetState's `logo_scan`."""
        if self._logo_scan["state"] == "running":
            return {"ok": False, "error": "scan already running"}
        src = str(payload.get("src", ""))
        if not os.path.exists(src):
            return {"ok": False, "error": "source not found"}
        service_id = int(payload.get("service_id", -1))
        rect = payload.get("rect")  # [x, y, w, h] logo region
        if not rect or len(rect) != 4:
            return {"ok": False, "error": "rect [x,y,w,h] required"}
        name = str(payload.get("name", os.path.basename(src)))
        out_name = os.path.basename(str(payload.get("out", name + ".lgd")))
        out_path = os.path.join(self.logo_dir(), out_name)
        thy = int(payload.get("thy", 12))

        self._logo_scan = {"state": "running", "progress": "starting",
                           "out": out_path}

        def work():
            try:
                from ..models.logo import LogoAnalyzer, ScanRegion

                frame_source = getattr(self, "logo_frame_source",
                                       self._default_logo_frames)
                frame_iter, imgw, imgh = frame_source(src)
                analyzer = LogoAnalyzer(
                    self.ctx, ScanRegion(*rect), thy=thy, device=self.device,
                    progress_cb=lambda *a: not self._logo_scan.update(
                        progress=" ".join(str(x) for x in a)),
                )
                analyzer.scan(frame_iter, imgw, imgh, name=name,
                              service_id=service_id)
                analyzer.save(out_path)
                self._logo_scan.update(state="done", progress="complete")
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._logo_scan.update(state="failed", progress=str(e))

        loop = asyncio.get_running_loop()
        loop.run_in_executor(None, work)
        return {"ok": True, "out": out_path}


class PauseScheduler:
    """Time-window scheduled pausing (ref Server/PauseScheduler.cs)."""

    def __init__(self, pool: WorkerPool, windows: list[tuple[int, int]]):
        self.pool = pool
        self.windows = windows  # [(start_hour, end_hour)]
        self._task: asyncio.Task | None = None

    def _in_window(self, hour: int) -> bool:
        for s, e in self.windows:
            if s <= e:
                if s <= hour < e:
                    return True
            elif hour >= s or hour < e:
                return True
        return False

    async def run(self, interval: float = 60.0) -> None:
        while True:
            hour = time.localtime().tm_hour
            self.pool.set_pause(self._in_window(hour), scheduled=True)
            await asyncio.sleep(interval)

    def start(self) -> None:
        self._task = asyncio.ensure_future(self.run())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
