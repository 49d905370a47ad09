"""Incident blackbox: edge-triggered postmortem bundles.

The port's copy of ``client_tpu/observability/blackbox.py``. The event
journal, the 1 Hz flight recorder, the HBM census, the cost ledger, the
QoS table and the profiler each live in a bounded in-memory ring: by the
time an operator asks why a tenant was throttled, the samples and the
journal tail that explain it have rotated out. A
:class:`BlackboxRecorder` subscribes to the journal as a sink and, on
configured trigger *edges*, snapshots the correlated state into an
on-disk bundle:

- ``journal``: the journal tail (``journal_tail`` newest events);
- ``timeseries``: the flight-recorder ring windowed around the trigger
  (``window_s`` before, ``post_window_s`` after);
- ``profile``: the efficiency profiler snapshot (roofline, autotune and
  selfdrive sections included);
- ``memory``: the HBM census (owners, drift, pressure);
- ``costs`` / ``qos`` / ``slo``: tenant ledger, class table, burn rates;
- ``traces``: Chrome traces of the ``worst_requests`` newest finished
  traced requests;
- ``fingerprint``: env, library versions, git and process identity
  (the CUDA version and the card's name on a CUDA build), so that a
  bundle pulled off a dead machine still says what was running.

Trigger vocabulary (journal ``category.name`` edges): ``slo.fast_burn``
(health flips DEGRADED with burning models), ``qos.throttle``,
``admission.tighten``, ``fleet.rebalance``, ``memory.pressure``,
``breaker.storm`` (>= ``storm_count`` breaker-opens in
``storm_window_s``), ``deadline.burst`` (the same for deadline
expiries), plus ``manual`` (``POST /v2/debug/capture``) and ``crash``
(unhandled-exception and atexit hooks, :func:`install_crash_hooks`).

One bundle per *incident*, not one per tick: a global ``debounce_s`` and
a per-trigger ``cooldown_s`` suppress repeat edges, and the bundle ring
is capped by count and bytes with oldest-first eviction. Trigger
matching runs on the emitting thread (journal sinks run outside the
journal lock) and only enqueues; the snapshot runs on a capture thread
of its own, so no data-plane lock order is crossed.

A crash bundle touches no CUDA call: after an illegal address or a
device-side assert the context is unusable, and a device query or a
synchronize in a crash hook could raise or hang. It holds the journal
tail and the fingerprint, whose device name is the one cached when the
engine started.

``CLIENT_TPU_BLACKBOX`` follows the flight recorder's grammar and
defaults ON: unset/``1``/``on`` takes the defaults, ``0``/``off``
disables, else inline JSON or ``@/path.json``. Served as ``GET
/v2/debug/bundles``, ``GET /v2/debug/bundles/{id}`` and ``POST
/v2/debug/capture`` (and the ``BlackboxBundles`` / ``BlackboxCapture``
RPCs); ``tools/blackbox_report.py`` renders a bundle.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import os
import re
import sys
import tempfile
import threading
import time
import uuid
import weakref
from collections import deque
from dataclasses import dataclass, fields

from client_tpu_torch import config as envcfg
from client_tpu_torch.utils import lockdep

__all__ = [
    "ENV_VAR",
    "DEFAULT_TRIGGERS",
    "BlackboxConfig",
    "BundleStore",
    "BlackboxRecorder",
    "match_trigger",
    "install_crash_hooks",
]

ENV_VAR = "CLIENT_TPU_BLACKBOX"

_log = logging.getLogger("client_tpu_torch.blackbox")

# Single-event edges: (category, name) -> trigger. lifecycle.health is
# special-cased in match_trigger (only DEGRADED-with-burning-models
# transitions count, not every health flip).
_EDGE_TRIGGERS = {
    ("qos", "throttle"): "qos.throttle",
    ("admission", "tighten"): "admission.tighten",
    ("fleet", "rebalance"): "fleet.rebalance",
    ("memory", "pressure"): "memory.pressure",
}

# Rate edges: a single breaker-open or deadline-expiry is routine; a
# storm/burst of them inside storm_window_s is an incident.
_STORM_TRIGGERS = {
    ("breaker", "open"): "breaker.storm",
    ("deadline", "expired"): "deadline.burst",
}

DEFAULT_TRIGGERS = (
    "slo.fast_burn",
    "qos.throttle",
    "admission.tighten",
    "fleet.rebalance",
    "memory.pressure",
    "breaker.storm",
    "deadline.burst",
)

# Always-valid trigger names for the manual surface (anything in the
# automatic vocabulary is also accepted so a fleet coordinator can fan out the
# edge it observed).
MANUAL_TRIGGERS = ("manual", "crash", "fleet")

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# Bundle ids embed a process-global sequence (not per-recorder): multiple
# engines in one process share a bundle directory, and per-recorder
# counters would collide on bb-<pid>-0001-... and silently overwrite.
_seq_lock = lockdep.Lock("observability.blackbox.seq")
_seq_counter = 0


def _next_seq() -> int:
    global _seq_counter
    with _seq_lock:
        _seq_counter += 1
        return _seq_counter


def match_trigger(category: str, name: str, detail: dict | None) -> str | None:
    """The trigger this journal edge maps to, or None. Pure function so
    the vocabulary is unit-testable without a recorder."""
    if category == "lifecycle" and name == "health":
        if detail and detail.get("slo_fast_burn"):
            return "slo.fast_burn"
        return None
    return (_EDGE_TRIGGERS.get((category, name))
            or _STORM_TRIGGERS.get((category, name)))


@dataclass
class BlackboxConfig:
    """``CLIENT_TPU_BLACKBOX`` knobs. Defaults ON (like the flight
    recorder): unset takes defaults, ``0``/``off`` disables."""

    dir: str = ""              # bundle directory ("" = per-pid tmp dir)
    window_s: float = 60.0     # flight-recorder window before the trigger
    post_window_s: float = 2.0  # settle time after the trigger edge
    debounce_s: float = 30.0   # global min gap between automatic captures
    cooldown_s: float = 300.0  # per-trigger min gap
    storm_count: int = 5       # breaker/deadline edges to call it a storm
    storm_window_s: float = 10.0
    journal_tail: int = 256    # newest journal events per bundle
    worst_requests: int = 3    # stitched traces of the slowest requests
    max_bundles: int = 12      # bundle-ring count cap
    max_bundle_bytes: int = 4 * 1024 * 1024    # per-bundle size cap
    max_total_bytes: int = 48 * 1024 * 1024    # ring byte cap (eviction)
    triggers: tuple = DEFAULT_TRIGGERS
    enabled: bool = True

    _NUMS = ("window_s", "post_window_s", "debounce_s", "cooldown_s",
             "storm_window_s")
    _INTS = ("storm_count", "journal_tail", "worst_requests",
             "max_bundles", "max_bundle_bytes", "max_total_bytes")

    @classmethod
    def from_dict(cls, data: dict) -> "BlackboxConfig":
        known = {f.name for f in fields(cls) if f.name != "enabled"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{ENV_VAR}: unknown key(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}")
        cfg = cls()
        if "dir" in data:
            if not isinstance(data["dir"], str) or not data["dir"]:
                raise ValueError(
                    f"{ENV_VAR}: key 'dir' expects a non-empty path")
            cfg.dir = data["dir"]
        for key in cls._NUMS:
            if key in data:
                try:
                    setattr(cfg, key, float(data[key]))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{ENV_VAR}: key {key!r} expects a number, "
                        f"got {data[key]!r}") from None
        for key in cls._INTS:
            if key in data:
                try:
                    setattr(cfg, key, int(data[key]))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{ENV_VAR}: key {key!r} expects an integer, "
                        f"got {data[key]!r}") from None
        if "triggers" in data:
            trigs = data["triggers"]
            if not isinstance(trigs, (list, tuple)):
                raise ValueError(
                    f"{ENV_VAR}: key 'triggers' expects a list of "
                    "trigger names")
            bad = [t for t in trigs if t not in DEFAULT_TRIGGERS]
            if bad:
                raise ValueError(
                    f"{ENV_VAR}: unknown trigger(s) {bad}; "
                    f"valid: {list(DEFAULT_TRIGGERS)}")
            cfg.triggers = tuple(trigs)
        if cfg.window_s <= 0:
            raise ValueError(f"{ENV_VAR}: window_s must be > 0")
        if cfg.post_window_s < 0:
            raise ValueError(f"{ENV_VAR}: post_window_s must be >= 0")
        if cfg.debounce_s < 0 or cfg.cooldown_s < 0:
            raise ValueError(
                f"{ENV_VAR}: debounce_s/cooldown_s must be >= 0")
        if cfg.storm_count < 1 or cfg.storm_window_s <= 0:
            raise ValueError(
                f"{ENV_VAR}: storm_count >= 1 and storm_window_s > 0 "
                "required")
        if cfg.max_bundles < 1 or cfg.max_bundle_bytes < 4096 \
                or cfg.max_total_bytes < cfg.max_bundle_bytes:
            raise ValueError(
                f"{ENV_VAR}: max_bundles >= 1, max_bundle_bytes >= 4096 "
                "and max_total_bytes >= max_bundle_bytes required")
        if cfg.journal_tail < 1 or cfg.worst_requests < 0:
            raise ValueError(
                f"{ENV_VAR}: journal_tail >= 1 and worst_requests >= 0 "
                "required")
        return cfg

    @classmethod
    def from_env(cls, environ=os.environ) -> "BlackboxConfig":
        raw = envcfg.env_text(ENV_VAR, environ)
        if raw.lower() in ("0", "false", "off"):
            return cls(enabled=False)
        if not raw or raw.lower() in ("1", "true", "on"):
            return cls()
        if raw.startswith("@"):
            try:
                with open(raw[1:]) as f:
                    raw = f.read()
            except OSError as exc:
                raise ValueError(
                    f"{ENV_VAR}: cannot read '{raw[1:]}': {exc}") from None
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{ENV_VAR}: invalid JSON ({exc})") from None
        if not isinstance(data, dict):
            raise ValueError(f"{ENV_VAR}: expected a JSON object")
        return cls.from_dict(data)

    def resolved_dir(self) -> str:
        """The bundle directory: configured, else a per-pid tmp dir —
        files survive the process (that is the point of a blackbox);
        the pid scoping keeps concurrent test processes apart."""
        if self.dir:
            return self.dir
        return os.path.join(tempfile.gettempdir(),
                            f"client_tpu_torch_blackbox_{os.getpid()}")


def fingerprint(device_name: str | None = None) -> dict:
    """Env/config/git/process identity for a bundle: enough to say what
    was running without the machine it ran on. Best-effort everywhere:
    a fingerprint must never fail a capture. ``device_name`` is the
    card's name as the engine read it at start; nothing here calls
    into CUDA."""
    info: dict = {
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "ts_wall": time.time(),
    }
    try:
        import platform

        info["platform"] = platform.platform()
    except Exception as exc:  # noqa: BLE001 — best-effort identity
        info["platform"] = f"unknown ({exc})"
    # Registered CLIENT_TPU_* env (values as set; the registry owns the
    # defaults, the bundle records the overrides).
    env = {}
    for key, value in os.environ.items():
        if key.startswith("CLIENT_TPU_"):
            env[key] = value
    info["env"] = dict(sorted(env.items()))
    # Library versions, only of libraries already imported: a crash
    # bundle must not pay for (or risk) an import.
    versions = {}
    for mod in ("torch", "numpy", "grpc"):
        m = sys.modules.get(mod)
        ver = getattr(m, "__version__", None) if m is not None else None
        if ver:
            versions[mod] = str(ver)
    torch = sys.modules.get("torch")
    if torch is not None:
        # is_initialized() and the build's version string start nothing.
        cuda = getattr(getattr(torch, "version", None), "cuda", None)
        try:
            initialised = bool(cuda) and torch.cuda.is_initialized()
        except Exception:  # noqa: BLE001 — best-effort identity
            initialised = False
        if initialised:
            versions["cuda"] = str(cuda)
    info["versions"] = versions
    if device_name:
        info["device"] = device_name
    info["git"] = _git_identity()
    return info


def _git_identity() -> dict:
    """Commit hash via .git plumbing files (no subprocess: capture can
    run in a crashing process)."""
    out: dict = {}
    try:
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        head_path = os.path.join(root, ".git", "HEAD")
        with open(head_path) as f:
            head = f.read().strip()
        if head.startswith("ref: "):
            ref = head[5:]
            out["ref"] = ref
            ref_path = os.path.join(root, ".git", *ref.split("/"))
            try:
                with open(ref_path) as f:
                    out["commit"] = f.read().strip()
            except OSError:
                # packed refs: one "hash ref" line each
                with open(os.path.join(root, ".git",
                                       "packed-refs")) as f:
                    for line in f:
                        if line.strip().endswith(ref):
                            out["commit"] = line.split()[0]
                            break
        else:
            out["commit"] = head
    except Exception as exc:  # noqa: BLE001 — identity is best-effort
        out["error"] = str(exc)
    return out


class BundleStore:
    """Size/count-capped ring of bundle files in one directory.

    One JSON file per bundle (``<id>.json``), written atomically
    (tmp + rename) so a reader — or a crash — never sees a torn
    bundle. Eviction is oldest-first by mtime whenever the count or
    total-byte cap is exceeded. Thread-safe."""

    def __init__(self, directory: str, *, max_bundles: int = 12,
                 max_total_bytes: int = 48 * 1024 * 1024):
        self.directory = directory
        self.max_bundles = max_bundles
        self.max_total_bytes = max_total_bytes
        self._lock = lockdep.Lock("observability.blackbox.store")
        self._metas: dict[str, dict] = {}  # id -> meta for our writes

    def _path(self, bundle_id: str) -> str:
        return os.path.join(self.directory, f"{bundle_id}.json")

    def write(self, bundle_id: str, payload: bytes, meta: dict) -> dict:
        """Atomically persist one serialized bundle, evict past the
        caps, and return the enriched meta."""
        if not _ID_RE.match(bundle_id):
            raise ValueError(f"invalid bundle id {bundle_id!r}")
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(bundle_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        meta = dict(meta, id=bundle_id, bytes=len(payload))
        with self._lock:
            self._metas[bundle_id] = meta
        self._evict()
        return meta

    def _scan(self) -> list[tuple[str, int, float]]:
        """(id, bytes, mtime) for every bundle file on disk."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                st = os.stat(os.path.join(self.directory, name))
            except OSError:
                continue
            out.append((name[:-5], st.st_size, st.st_mtime))
        return out

    def _evict(self) -> None:
        entries = sorted(self._scan(), key=lambda e: (e[2], e[0]))
        total = sum(e[1] for e in entries)
        while entries and (len(entries) > self.max_bundles
                           or total > self.max_total_bytes):
            victim, nbytes, _ = entries.pop(0)
            try:
                os.remove(self._path(victim))
            except OSError:
                _log.warning("blackbox: could not evict bundle %s",
                             victim)
            total -= nbytes
            with self._lock:
                self._metas.pop(victim, None)

    def total_bytes(self) -> int:
        return sum(e[1] for e in self._scan())

    def list(self) -> list[dict]:
        """Bundle metas, newest first. Bundles written by this process
        carry their full meta; files found on disk from an earlier
        process carry id/bytes/mtime only."""
        with self._lock:
            metas = dict(self._metas)
        out = []
        for bundle_id, nbytes, mtime in sorted(
                self._scan(), key=lambda e: (e[2], e[0]), reverse=True):
            meta = metas.get(bundle_id)
            if meta is None:
                meta = {"id": bundle_id, "bytes": nbytes,
                        "mtime": mtime}
            else:
                meta = dict(meta, bytes=nbytes)
            out.append(meta)
        return out

    def load(self, bundle_id: str) -> dict:
        """Parse one bundle. Raises KeyError (unknown — read surfaces
        map it to 404) or ValueError (malformed id / corrupt file —
        400, never 500)."""
        if not _ID_RE.match(bundle_id or ""):
            raise ValueError(f"invalid bundle id {bundle_id!r}")
        path = self._path(bundle_id)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise KeyError(bundle_id) from None
        except OSError as exc:
            raise ValueError(
                f"unreadable bundle {bundle_id}: {exc}") from None
        try:
            bundle = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise ValueError(
                f"corrupt bundle {bundle_id}: {exc}") from None
        if not isinstance(bundle, dict):
            raise ValueError(
                f"corrupt bundle {bundle_id}: expected a JSON object")
        return bundle


class BlackboxRecorder:
    """Journal-triggered incident capture for one engine.

    Holds the engine weakly (a shut-down engine must be collectable);
    trigger matching runs on the emitting thread and only enqueues,
    capture runs on a lazily started daemon thread with a stop event.
    ``clock``/``mono`` are injectable for fake-clock debounce tests;
    ``device_name`` is the card's name, read by the engine at start, for
    the fingerprint of every bundle (the crash path's included)."""

    def __init__(self, engine, config: BlackboxConfig | None = None, *,
                 registry=None, clock=time.time, mono=time.monotonic,
                 store: BundleStore | None = None,
                 device_name: str | None = None):
        self.config = config or BlackboxConfig()
        self.device_name = device_name
        self._engine_ref = weakref.ref(engine)
        self._clock = clock
        self._mono = mono
        self.store = store or BundleStore(
            self.config.resolved_dir(),
            max_bundles=self.config.max_bundles,
            max_total_bytes=self.config.max_total_bytes)
        self._lock = lockdep.Lock("observability.blackbox")
        self._pending: deque = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_capture = float("-inf")      # mono, automatic only
        self._cooldowns: dict[str, float] = {}  # trigger -> mono stamp
        self._last_bundle: dict[str, str] = {}  # trigger -> bundle id
        self._storms: dict[str, deque] = {}
        self.captures = 0
        self.suppressed = 0
        self.failures = 0
        self.last_capture_ms: float | None = None
        self._captures_total = None
        self._bundle_bytes = None
        self._failures_total = None
        if registry is not None:
            self.bind_metrics(registry)

    def bind_metrics(self, registry) -> None:
        self._captures_total = registry.counter(
            "tpu_blackbox_captures_total",
            "Incident bundles captured, by trigger edge",
            ("trigger",))
        self._bundle_bytes = registry.gauge(
            "tpu_blackbox_bundle_bytes",
            "Total bytes of incident bundles currently retained on disk")
        self._failures_total = registry.counter(
            "tpu_blackbox_capture_failures_total",
            "Incident captures that failed (snapshot or write error)")

    # -- lifecycle ------------------------------------------------------------

    def install(self) -> "BlackboxRecorder":
        """Subscribe to the process journal and arm the crash hooks.
        No-op when disabled."""
        if not self.config.enabled:
            return self
        from client_tpu_torch.observability.events import journal

        journal().add_sink(self._on_event)
        install_crash_hooks(self)
        return self

    def close(self) -> None:
        """Unsubscribe and stop the capture thread (pending captures
        are abandoned — the engine is going away with their state)."""
        from client_tpu_torch.observability.events import journal

        journal().remove_sink(self._on_event)
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
        self._thread = None

    def _ensure_thread(self) -> None:
        if self._stop.is_set():
            return
        thread = self._thread
        if thread is not None and thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="blackbox-capture", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            if self._stop.is_set():
                return
            # Let the post-trigger window fill before snapshotting so
            # the bundle shows the edge with context on both sides.
            if self._pending and self.config.post_window_s > 0:
                self._stop.wait(self.config.post_window_s)
            self.drain()

    # -- trigger path ---------------------------------------------------------

    def _on_event(self, event) -> None:
        """Journal sink: match, debounce, enqueue. Runs on the emitting
        thread — must stay cheap and take only the blackbox lock."""
        if not self.config.enabled:
            return
        if event.category == "blackbox":
            return  # our own captured edges must not re-trigger
        if self._engine_ref() is None:
            # The engine died without close(); detach ourselves.
            from client_tpu_torch.observability.events import journal

            journal().remove_sink(self._on_event)
            return
        trigger = match_trigger(event.category, event.name, event.detail)
        if trigger is None or trigger not in self.config.triggers:
            return
        now = self._mono()
        with self._lock:
            if trigger in _STORM_TRIGGERS.values():
                ring = self._storms.setdefault(
                    trigger, deque(maxlen=max(self.config.storm_count,
                                              64)))
                ring.append(now)
                while ring and now - ring[0] > self.config.storm_window_s:
                    ring.popleft()
                if len(ring) < self.config.storm_count:
                    return
                ring.clear()
            if not self._admit_locked(trigger, now):
                self.suppressed += 1
                return
            self._pending.append((trigger, event.to_dict(),
                                  event.ts_wall))
        self._wake.set()
        self._ensure_thread()

    def _admit_locked(self, trigger: str, now: float) -> bool:
        """Debounce + per-trigger cooldown; stamps on admit so the next
        edge in the same incident is suppressed at enqueue time."""
        if now - self._last_capture < self.config.debounce_s:
            return False
        last = self._cooldowns.get(trigger)
        if last is not None and now - last < self.config.cooldown_s:
            return False
        self._last_capture = now
        self._cooldowns[trigger] = now
        return True

    def drain(self) -> int:
        """Capture everything pending (the capture thread's body; also
        the deterministic test entry point). Returns bundles written."""
        written = 0
        while True:
            with self._lock:
                if not self._pending:
                    return written
                trigger, event_dict, wall = self._pending.popleft()
            try:
                self.capture(trigger, trigger_event=event_dict,
                             trigger_wall=wall)
                written += 1
            except Exception:  # noqa: BLE001 — capture must not wedge
                self.failures += 1
                if self._failures_total is not None:
                    self._failures_total.inc()
                if self.failures == 1:
                    _log.exception(
                        "blackbox capture failed (logged once; further "
                        "failures only counted)")

    # -- capture --------------------------------------------------------------

    def capture(self, trigger: str = "manual", *, incident: str | None = None,
                note: str | None = None, trigger_event: dict | None = None,
                trigger_wall: float | None = None,
                respect_cooldown: bool = False) -> dict:
        """Snapshot one bundle now (synchronous; the manual surface and
        the capture thread both land here). With ``respect_cooldown``
        a non-manual trigger inside its debounce/cooldown window
        returns ``{"deduped": True, ...}`` instead of writing a second
        bundle for the same incident (a fleet fan-out)."""
        engine = self._engine_ref()
        if engine is None:
            raise RuntimeError("engine is gone")
        if trigger not in DEFAULT_TRIGGERS \
                and trigger not in MANUAL_TRIGGERS:
            raise ValueError(
                f"unknown trigger {trigger!r}; valid: "
                f"{list(DEFAULT_TRIGGERS) + list(MANUAL_TRIGGERS)}")
        auto = trigger in DEFAULT_TRIGGERS
        if respect_cooldown and auto:
            now = self._mono()
            with self._lock:
                admitted = self._admit_locked(trigger, now)
                last_id = self._last_bundle.get(trigger)
            if not admitted:
                self.suppressed += 1
                return {"deduped": True, "trigger": trigger,
                        "incident": incident, "bundle": last_id}
        t0 = time.perf_counter()
        wall = trigger_wall if trigger_wall is not None else self._clock()
        bundle_id = (f"bb-{os.getpid()}-{_next_seq():04d}-"
                     + trigger.replace(".", "-"))
        incident = incident or f"inc-{uuid.uuid4().hex[:12]}"
        cfg = self.config
        sections: dict = {}

        def section(name, fn):
            try:
                sections[name] = fn()
            except Exception as exc:  # noqa: BLE001 — partial bundles
                sections[name] = {"error": f"{type(exc).__name__}: {exc}"}

        from client_tpu_torch.observability.events import journal

        section("journal", lambda: journal().export(
            limit=cfg.journal_tail))
        section("timeseries", lambda: engine.timeseries_export(
            since_wall=wall - cfg.window_s))
        section("profile", engine.profile_snapshot)
        section("memory", engine.memory_census)
        section("costs", engine.costs_snapshot)
        section("qos", engine.qos_snapshot)
        section("slo", engine.slo_snapshot)
        section("traces", lambda: self._worst_traces(engine))
        section("fingerprint", lambda: fingerprint(self.device_name))

        bundle = {
            "schema": 1,
            "id": bundle_id,
            "incident": incident,
            "trigger": trigger,
            "trigger_event": trigger_event,
            "note": note or "",
            "ts_wall": wall,
            "window_s": cfg.window_s,
            "post_window_s": cfg.post_window_s,
            "truncated": [],
            "sections": sections,
        }
        payload = self._bounded_payload(bundle)
        capture_ms = round((time.perf_counter() - t0) * 1e3, 3)
        meta = self.store.write(bundle_id, payload, {
            "incident": incident,
            "trigger": trigger,
            "ts_wall": wall,
            "capture_ms": capture_ms,
            "note": note or "",
            "truncated": bundle["truncated"],
        })
        total = self.store.total_bytes()
        with self._lock:
            self.captures += 1
            self.last_capture_ms = capture_ms
            self._last_bundle[trigger] = bundle_id
        if self._captures_total is not None:
            self._captures_total.inc(trigger=trigger)
        if self._bundle_bytes is not None:
            self._bundle_bytes.set(total)
        journal().emit(
            "blackbox", "captured",
            severity="WARNING" if auto else "INFO",
            trigger=trigger, bundle=bundle_id, incident=incident,
            bytes=meta["bytes"], capture_ms=capture_ms)
        return meta

    def _bounded_payload(self, bundle: dict) -> bytes:
        """Serialize under max_bundle_bytes, trimming the bulky
        sections (timeseries samples, journal tail, traces) before
        giving up on whole sections."""
        cap = self.config.max_bundle_bytes
        payload = json.dumps(bundle).encode("utf-8")
        trims = ("timeseries", "journal", "traces", "profile")
        for name in trims:
            if len(payload) <= cap:
                return payload
            sec = bundle["sections"].get(name)
            if isinstance(sec, dict):
                for key in ("samples", "events", "worst"):
                    if isinstance(sec.get(key), list) and sec[key]:
                        sec[key] = sec[key][-max(
                            1, len(sec[key]) // 4):]
            if name not in bundle["truncated"]:
                bundle["truncated"].append(name)
            payload = json.dumps(bundle).encode("utf-8")
        while len(payload) > cap and any(
                not isinstance(v, str)
                for v in bundle["sections"].values()):
            # Still over: drop the largest section wholesale.
            largest = max(
                (k for k, v in bundle["sections"].items()
                 if not isinstance(v, str)),
                key=lambda k: len(json.dumps(bundle["sections"][k])))
            bundle["sections"][largest] = "truncated"
            if largest not in bundle["truncated"]:
                bundle["truncated"].append(largest)
            payload = json.dumps(bundle).encode("utf-8")
        return payload

    def _worst_traces(self, engine) -> dict:
        """Stitched Chrome traces of the slowest recently completed
        requests (the requests an incident postmortem asks about)."""
        k = self.config.worst_requests
        if k <= 0:
            return {"worst": []}
        traces = engine.request_traces.snapshot()
        traces.sort(key=lambda t: t.wall_time_ms, reverse=True)
        worst = []
        for t in traces[:k]:
            entry = {
                "trace_id": t.trace_id,
                "model": t.model_name,
                "request_id": t.request_id,
                "wall_time_ms": t.wall_time_ms,
                "ok": t.ok,
            }
            if t.error:
                entry["error"] = t.error
            try:
                entry["chrome"] = engine.request_trace_export(t.trace_id)
            except Exception as exc:  # noqa: BLE001 — partial is fine
                entry["chrome"] = {"error": str(exc)}
            worst.append(entry)
        return {"worst": worst}

    # -- crash path -----------------------------------------------------------

    def crash_capture(self, error: str = "",
                      kind: str = "crash") -> dict | None:
        """Best-effort mini-bundle for a dying process: journal tail +
        fingerprint only (engine state, or the CUDA context, may be the
        thing that broke: no engine or CUDA call is made). Never
        raises."""
        try:
            from client_tpu_torch.observability.events import journal

            bundle_id = f"bb-{os.getpid()}-{_next_seq():04d}-{kind}"
            bundle = {
                "schema": 1,
                "id": bundle_id,
                "incident": f"inc-{uuid.uuid4().hex[:12]}",
                "trigger": "crash",
                "trigger_event": None,
                "note": error,
                "ts_wall": time.time(),
                "truncated": [],
                "sections": {
                    "journal": journal().export(
                        limit=self.config.journal_tail),
                    "fingerprint": fingerprint(self.device_name),
                },
            }
            payload = self._bounded_payload(bundle)
            return self.store.write(bundle_id, payload, {
                "incident": bundle["incident"],
                "trigger": "crash",
                "ts_wall": bundle["ts_wall"],
                "note": error,
                "truncated": bundle["truncated"],
            })
        except Exception:  # noqa: BLE001 — the process is dying; the
            _log.debug("blackbox crash capture failed", exc_info=True)
            return None     # hook chain must continue regardless

    # -- read surface ---------------------------------------------------------

    def bundles(self, bundle_id: str | None = None) -> dict:
        """``GET /v2/debug/bundles[/{id}]`` body. Raises KeyError for
        an unknown id, ValueError for a malformed id or corrupt file."""
        if bundle_id:
            return self.store.load(bundle_id)
        with self._lock:
            stats = {"captures": self.captures,
                     "suppressed": self.suppressed,
                     "failures": self.failures,
                     "last_capture_ms": self.last_capture_ms}
        return {
            "enabled": self.config.enabled,
            "dir": self.store.directory,
            "triggers": list(self.config.triggers),
            "bundles": self.store.list(),
            "total_bytes": self.store.total_bytes(),
            **stats,
        }

    def snapshot(self) -> dict:
        """Config + counters for debug surfaces and tests."""
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "dir": self.store.directory,
                "triggers": list(self.config.triggers),
                "captures": self.captures,
                "suppressed": self.suppressed,
                "failures": self.failures,
                "pending": len(self._pending),
                "last_capture_ms": self.last_capture_ms,
            }


# -- crash hooks ---------------------------------------------------------------

_hooks_lock = lockdep.Lock("observability.blackbox.hooks")
_hooks_installed = False
_hook_recorders: list = []  # weakrefs to installed recorders
_atexit_done = False


def install_crash_hooks(recorder: BlackboxRecorder | None = None) -> None:
    """Arm the crash evidence path (idempotent):

    - ``faulthandler`` — fatal signals (SIGSEGV/SIGABRT/...) dump every
      thread's stack to stderr;
    - ``sys.excepthook`` — an unhandled exception writes the journal
      tail to stderr as one JSON line plus a best-effort mini-bundle to
      every live recorder's store, then chains to the previous hook;
    - ``atexit`` — a final journal tail lands on disk when the process
      exits with a recorder still armed, so even a quiet death leaves
      evidence.
    """
    global _hooks_installed
    with _hooks_lock:
        if recorder is not None:
            _hook_recorders.append(weakref.ref(recorder))
        if _hooks_installed:
            return
        _hooks_installed = True
    try:
        if not faulthandler.is_enabled():
            faulthandler.enable(file=sys.stderr)
    except Exception:  # noqa: BLE001 — stderr may be closed/invalid
        _log.debug("faulthandler.enable failed", exc_info=True)
    previous = sys.excepthook

    def _blackbox_excepthook(etype, value, tb):
        _crash_flush(f"{etype.__name__}: {value}", to_stderr=True)
        previous(etype, value, tb)

    sys.excepthook = _blackbox_excepthook
    atexit.register(_atexit_flush)


def _live_recorders() -> list:
    with _hooks_lock:
        refs = list(_hook_recorders)
    return [r for r in (ref() for ref in refs) if r is not None]


def _crash_flush(error: str, *, to_stderr: bool) -> None:
    """Write the final journal tail to stderr (one JSON line) and a
    mini-bundle per live recorder. Never raises."""
    tail = None
    try:
        from client_tpu_torch.observability.events import journal

        tail = journal().export(limit=64)
    except Exception:  # noqa: BLE001 — dying process
        _log.debug("crash flush: journal export failed", exc_info=True)
    if to_stderr:
        try:
            line = json.dumps({
                "blackbox": "crash",
                "error": error,
                "journal_tail": (tail or {}).get("events", []),
            })
            print(line, file=sys.stderr, flush=True)
        except Exception:  # noqa: BLE001 — stderr may be gone
            _log.debug("crash flush: stderr write failed",
                       exc_info=True)
    for rec in _live_recorders():
        rec.crash_capture(error)


def _atexit_flush() -> None:
    """One final journal tail per recorder at interpreter exit (normal
    or post-exception). Never raises; runs at most once."""
    global _atexit_done
    with _hooks_lock:
        if _atexit_done:
            return
        _atexit_done = True
    recorders = _live_recorders()
    if not recorders:
        return
    try:
        from client_tpu_torch.observability.events import journal

        tail = journal().export(limit=64)
    except Exception:  # noqa: BLE001 — dying process
        return
    if not tail.get("events"):
        return
    payload = json.dumps({
        "blackbox": "final",
        "journal_tail": tail,
        "fingerprint": fingerprint(recorders[0].device_name),
    }).encode("utf-8")
    for rec in recorders:
        try:
            os.makedirs(rec.store.directory, exist_ok=True)
            path = os.path.join(rec.store.directory,
                                f"final_journal_{os.getpid()}.jsonl")
            with open(path, "wb") as f:
                f.write(payload + b"\n")
        except Exception:  # noqa: BLE001 — exit path stays silent
            _log.debug("atexit journal flush failed", exc_info=True)
