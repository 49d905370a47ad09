"""TorchEngine: the in-process serving façade.

Counterpart of ``TpuEngine`` (``client_tpu/engine/engine.py``) with the
method surface the HTTP frontend calls: health, server and model metadata,
model config and statistics, ``infer`` / ``async_infer`` and ``shutdown``.
A decoupled (streaming) model answers only through ``async_infer``, once
per response; a blocking ``infer`` on one is a 400. Each model gets the
scheduler its config asks for (``scheduler.make_scheduler``): dynamic
batching, ragged (lookups-axis) batching, sequence batching, generative
or other decoupled streaming, or an ensemble. Two shared-memory
managers serve both frontends and in-process callers: ``system_shm``
(regions by shm key) and ``cuda_shm`` (host-staged regions by handle, and
in-process regions of tensors on the card; ``engine/shm.py``).
Models load, reload and unload at run time (:meth:`TorchEngine.load_model`,
:meth:`TorchEngine.unload_model`), each loaded version with its own
scheduler and statistics.

The observability planes: each engine has its own metric registry
(``metrics``: the legacy ``tpu_inference_*`` block and the histograms and
gauges of :meth:`prometheus_metrics`), binds it to the process-global
fault registry (``faults``), efficiency profiler (``profiler``,
``GET /v2/profile``) and event journal (``events``, ``GET /v2/events``),
keeps a ring of finished request traces (``request_traces``,
``GET /v2/trace/requests``) and drives the device trace of
``/v2/trace/setting`` (``trace``). The shm slot ring and staged
datasets, the HBM census, and the admission, QoS, SLO and cost planes
are not ported yet.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

import torch

import client_tpu_torch
from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.engine.scheduler import Scheduler, make_scheduler
from client_tpu_torch.engine.shm import CudaShmManager, SystemShmManager
from client_tpu_torch.engine.stats import ModelStats
from client_tpu_torch.config import env_int
from client_tpu_torch.engine.trace import TraceManager
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    now_ns,
)
from client_tpu_torch.observability import roofline
from client_tpu_torch.observability.events import journal
from client_tpu_torch.observability.metrics import EngineMetrics
from client_tpu_torch.observability.profiler import profiler
from client_tpu_torch.observability.tracing import (
    MAX_CHUNK_EVENTS,
    TraceStore,
    build_request_trace,
)

_log = logging.getLogger("client_tpu_torch")

SERVER_NAME = "client_tpu_torch"
# The device regions answer on the tpu and cuda routes alike, as in the
# JAX package.
SERVER_EXTENSIONS = ["model_configuration", "binary_tensor_data",
                     "statistics", "generate", "system_shared_memory",
                     "tpu_shared_memory", "cuda_shared_memory"]


class TorchEngine:
    def __init__(self, repository: ModelRepository | None = None, *,
                 device: str | torch.device | None = None):
        """Loads every registered model on ``device`` and starts its
        schedulers; a model that fails to load stays in the repository
        index with its reason, and the rest load. ``device=None`` means
        cuda, and raises when CUDA is unavailable; pass ``device="cpu"``
        to serve on the CPU. The engine's metrics go into a registry of
        its own."""
        self.device = resolve_device(device)
        # A malformed CLIENT_TPU_ROOFLINE fails the boot here; the capture
        # and the snapshot read it again and degrade instead.
        roofline.roofline_config()
        self.metrics = EngineMetrics()
        from client_tpu_torch import faults

        self.faults = faults.registry()
        self.faults.bind_metrics(self.metrics.registry)
        self.profiler = profiler()
        self.profiler.bind_metrics(self.metrics.registry)
        self.events = journal()
        self.trace = TraceManager()
        self.request_traces = TraceStore(
            capacity=env_int("CLIENT_TPU_TRACE_BUFFER"))
        self.repository = repository or ModelRepository()
        # 'name:v' per loaded version, and 'name' as the alias of the
        # latest one (the same scheduler and stats objects).
        self._schedulers: dict[str, Scheduler] = {}
        self._stats: dict[str, ModelStats] = {}
        self._lock = threading.Lock()
        self._live = True
        self.system_shm = SystemShmManager()
        # A region's device_id indexes the visible cards (the engine's own
        # device alone on the CPU).
        self.cuda_shm = CudaShmManager(devices=(
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if self.device.type == "cuda" else [self.device]))
        # The JAX engine's detail keys, with the port's values: it has no
        # SLO tracker, autotuner, self-drive governor or blackbox.
        self.events.emit("lifecycle", "server_start",
                         models=len(self.repository.names()),
                         slo_enabled=False, autotune=False, selfdrive=False,
                         blackbox=False)
        for name in self.repository.names():
            try:
                self.load_model(name)
            except Exception as exc:  # noqa: BLE001 — load the rest
                _log.error("model '%s' failed to load: %s", name, exc)
                self.events.emit("lifecycle", "model_load_failed",
                                 severity="ERROR", model=name, error=str(exc))

    # -- health / metadata ---------------------------------------------------

    def is_live(self) -> bool:
        return self._live

    def is_ready(self) -> bool:
        return self._live

    def server_metadata(self) -> dict:
        return {"name": SERVER_NAME, "version": client_tpu_torch.__version__,
                "extensions": list(SERVER_EXTENSIONS)}

    @staticmethod
    def _vkey(name: str, version: str | int = "") -> str:
        """Scheduler and stats key: the bare name is the latest version's
        alias, 'name:v' one version."""
        v = str(version).strip()
        return f"{name}:{int(v)}" if v else name

    def _model(self, name: str, version: str | int = ""):
        """The model serving ``name`` at ``version`` ('' = latest), with
        the reference's order of checks: the version's form (400), the
        name (404), readiness (400), then the version (404)."""
        model = self.repository.get(name, version)
        if model is None:
            if name in self.repository.names():
                v = str(version).strip()
                if v and self.repository.is_ready(name):
                    raise EngineError(
                        f"model '{name}' has no version '{v}'", 404)
                raise EngineError(f"model '{name}' is not ready", 400)
            raise EngineError(f"unknown model '{name}'", 404)
        return model

    def model_is_ready(self, name: str, version: str = "") -> bool:
        return self.repository.is_ready(name, version)

    def model_metadata(self, name: str, version: str = "") -> dict:
        model = self._model(name, version)
        versions = [str(v) for v in
                    sorted(self.repository.loaded_versions(name))]
        return model.config.metadata_dict(versions=versions or None)

    def model_config(self, name: str, version: str = "") -> dict:
        return self._model(name, version).config.config_dict()

    def model_statistics(self, name: str = "", version: str = "") -> dict:
        """One entry per version ('name:v' keys only: the bare alias shares
        the latest version's object), filtered by name and version."""
        with self._lock:
            items = sorted((k, s) for k, s in self._stats.items() if ":" in k)
        if name:
            self._model(name, version)
            vfilter = str(version).strip()
            stats = [s.to_dict() for k, s in items
                     if k.rsplit(":", 1)[0] == name
                     and (not vfilter
                          or k.rsplit(":", 1)[1] == str(int(vfilter)))]
        else:
            stats = [s.to_dict() for _, s in items]
        return {"model_stats": stats}

    def repository_index(self) -> list[dict]:
        return self.repository.index()

    # -- repository control --------------------------------------------------

    def load_model(self, name: str) -> None:
        """Load (or reload) a model. A reload re-polls the repository: a
        version it keeps keeps its scheduler, a new one gets a scheduler,
        a retired one's scheduler stops, and the bare-name alias moves to
        the latest. Every load clears a backend's row cache: the
        repository was read again, and a cached row is a correctness
        hazard."""
        self.repository.load(name, self.device)
        versions = self.repository.loaded_versions(name)
        retired: list[Scheduler] = []
        new_models = []
        with self._lock:
            for v, model in sorted(versions.items()):
                key = self._vkey(name, v)
                sched = self._schedulers.get(key)
                if sched is not None and sched.model is model:
                    continue  # an unchanged version keeps its scheduler
                if sched is not None:
                    retired.append(sched)
                stats = self._stats.get(key)
                if stats is None:
                    stats = ModelStats(
                        name, str(v),
                        instruments=self.metrics.model_instruments(
                            name, str(v)))
                    self._stats[key] = stats
                self._schedulers[key] = make_scheduler(model, stats,
                                                       engine=self)
                new_models.append(model)
            valid = {self._vkey(name, v) for v in versions}
            for key in [k for k in self._schedulers
                        if ":" in k and k.rsplit(":", 1)[0] == name
                        and k not in valid]:
                retired.append(self._schedulers.pop(key))
            latest = self._vkey(name, max(versions))
            self._schedulers[name] = self._schedulers[latest]
            self._stats[name] = self._stats[latest]
            live = {id(s) for s in self._schedulers.values()}
        for sched in retired:
            if id(sched) not in live:
                sched.stop()
        for model in versions.values():
            cache = getattr(model.backend, "row_cache", None)
            if cache is not None:
                cache.clear()
        for model in new_models:
            self.events.emit("model", "load", model=name,
                             version=model.config.version)

    def unload_model(self, name: str, unload_dependents: bool = False) -> None:
        """Stop every version's scheduler and drop the model, so nothing of
        it keeps its tensors alive. With ``unload_dependents`` an
        ensemble's composing models unload too, except one that another
        loaded ensemble still names."""
        dependents: list[str] = []
        if unload_dependents:
            model = self.repository.get(name)
            if model is not None and model.config.ensemble_scheduling:
                dependents = [s.model_name
                              for s in model.config.ensemble_scheduling]
        with self._lock:
            keys = [k for k in self._schedulers
                    if k == name or k.rsplit(":", 1)[0] == name]
            popped = [self._schedulers.pop(k) for k in keys]
        seen: set[int] = set()
        for sched in popped:
            if id(sched) not in seen:
                seen.add(id(sched))
                sched.stop()
                cache = getattr(sched.model.backend, "row_cache", None)
                if cache is not None:
                    cache.clear()
        if popped:
            self.events.emit("model", "unload", model=name, versions=sorted(
                k.rsplit(":", 1)[1] for k in keys if ":" in k))
        self.repository.unload(name)
        for dep in dependents:
            if dep != name and not self._referenced_by_loaded_ensemble(dep):
                self.unload_model(dep, unload_dependents=True)

    def _referenced_by_loaded_ensemble(self, name: str) -> bool:
        """A composing model shared by several ensembles stays until the
        last ensemble that names it unloads."""
        with self._lock:
            scheds = list(self._schedulers.values())
        return any(step.model_name == name
                   for sched in scheds
                   for step in sched.model.config.ensemble_scheduling)

    def scheduler_for(self, name: str,
                      version: str | int = "") -> Scheduler | None:
        """The live scheduler of one model version ('' = the latest's
        alias); None when it is not loaded."""
        with self._lock:
            try:
                return self._schedulers.get(self._vkey(name, version))
            except ValueError:
                return None

    # -- inference -----------------------------------------------------------

    def async_infer(self, req: InferRequest,
                    callback: Callable[[InferResponse], None] | None = None
                    ) -> None:
        """Submit; the response arrives on ``callback`` (or
        ``req.response_callback``), errors included."""
        if callback is not None:
            req.response_callback = callback
        if req.response_callback is None:
            raise EngineError("async_infer requires a response callback", 400)
        req.times.received = now_ns()
        try:
            self._model(req.model_name, req.model_version)
            with self._lock:
                sched = self._schedulers.get(
                    self._vkey(req.model_name, req.model_version))
            if sched is None:
                # In the repository but without a scheduler: mid-load or
                # mid-unload.
                raise EngineError(
                    f"model '{req.model_name}' is not ready", 400)
            sched.model.validate_inputs(req.inputs)
        except EngineError as exc:
            req.response_callback(InferResponse.make_error(req, exc))
            return
        if req.trace is not None:
            self._attach_trace_recorder(req)
        sched.submit(req)

    def _attach_trace_recorder(self, req: InferRequest) -> None:
        """Wrap the response callback so that the final response snapshots
        the request's spans into the trace ring; a stream's other
        responses are its chunk marks. Only a request with a trace context
        pays for this."""
        inner = req.response_callback
        chunks: list[int] = []

        def _traced(resp: InferResponse) -> None:
            if not resp.final:
                if len(chunks) < MAX_CHUNK_EVENTS:
                    chunks.append(now_ns())
            else:
                self.request_traces.add(build_request_trace(
                    req.trace, req.model_name, req.request_id, req.times,
                    ok=resp.error is None, chunks=chunks,
                    error=str(resp.error) if resp.error is not None else ""))
            inner(resp)

        req.response_callback = _traced

    def infer(self, req: InferRequest,
              timeout_s: float | None = None) -> InferResponse:
        """Blocking inference; raises EngineError on failure. A decoupled
        model is refused with 400, as Triton refuses it over HTTP infer:
        its responses stream through :meth:`async_infer` (``/generate``,
        ``/generate_stream``)."""
        try:
            model = self._model(req.model_name, req.model_version)
        except EngineError:
            model = None  # async_infer answers with the lookup's error
        if model is not None and model.config.decoupled:
            raise EngineError(
                f"model '{req.model_name}' is decoupled; use streaming "
                "(async_infer / gRPC stream) to receive its responses",
                400)
        done = threading.Event()
        box: list[InferResponse] = []

        def _cb(resp: InferResponse) -> None:
            box.append(resp)
            done.set()

        self.async_infer(req, _cb)
        if not done.wait(timeout=timeout_s):
            raise EngineError(
                f"inference timed out after {timeout_s}s "
                f"(model '{req.model_name}')", 504)
        resp = box[0]
        if resp.error is not None:
            raise resp.error
        return resp

    # -- shared-memory data plane --------------------------------------------

    def read_shm_tensor(self, region: str, offset: int, byte_size: int,
                        datatype: str, shape):
        """An input tensor named by region: a host view, or a device
        region's tensor. A device region shadows a system one of the same
        name. Both frontends and in-process callers read through here."""
        for mgr in (self.cuda_shm, self.system_shm):
            if mgr.has_region(region):
                return mgr.read_tensor(region, offset, byte_size, datatype,
                                       shape)
        raise EngineError(
            f"shared memory region '{region}' not registered", 400)

    def write_shm_tensor(self, region: str, offset: int, byte_size: int,
                         arr) -> int:
        """Place an output tensor into a registered region; returns the
        bytes written."""
        for mgr in (self.cuda_shm, self.system_shm):
            if mgr.has_region(region):
                return mgr.write_tensor(region, offset, byte_size, arr)
        raise EngineError(
            f"shared memory region '{region}' not registered", 400)

    # -- observability -------------------------------------------------------

    def prometheus_metrics(self, openmetrics: bool = False) -> str:
        """The ``/metrics`` body. The text format 0.0.4 has the legacy
        cumulative ``tpu_inference_*`` block (the per-model statistics)
        followed by the registry's histograms, gauges and counters;
        ``openmetrics=True`` renders the registry alone in OpenMetrics
        1.0 (the legacy counter names do not meet its naming rules).
        Gauges are sampled here: queue depth and batches in flight per
        model version, the card's memory, the duty cycle, MFU and MBU."""
        stats = self.model_statistics()["model_stats"]
        lines: list[str] = []

        def metric(name, kind, help_text, getter):
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for st in stats:
                labels = (f'model="{_esc(st["name"])}",'
                          f'version="{_esc(st["version"])}"')
                lines.append(f"{name}{{{labels}}} {getter(st)}")

        metric("tpu_inference_request_success", "counter",
               "Successful inference requests",
               lambda st: st["inference_stats"]["success"]["count"])
        metric("tpu_inference_request_failure", "counter",
               "Failed inference requests",
               lambda st: st["inference_stats"]["fail"]["count"])
        metric("tpu_inference_count", "counter",
               "Inferences performed (batched requests count each)",
               lambda st: st["inference_count"])
        metric("tpu_inference_exec_count", "counter",
               "Model executions (batches)",
               lambda st: st["execution_count"])
        for phase, help_text in (
                ("success", "Cumulative end-to-end request duration"),
                ("queue", "Cumulative queue duration"),
                ("compute_input", "Cumulative input staging duration"),
                ("compute_infer", "Cumulative executable duration"),
                ("compute_output", "Cumulative output fetch duration")):
            name = ("tpu_inference_request_duration_us" if phase == "success"
                    else f"tpu_inference_{phase}_duration_us")
            metric(name, "counter", help_text + " (microseconds)",
                   lambda st, p=phase:
                   st["inference_stats"][p]["ns"] // 1000)
        with self._lock:
            scheds = [(k, s) for k, s in self._schedulers.items() if ":" in k]
        for key, sched in scheds:
            model_name, version = key.rsplit(":", 1)
            self.metrics.queue_depth.set(sched.queue.qsize(),
                                         model=model_name, version=version)
            self.metrics.inflight_batches.set(
                sched.active_batches, model=model_name, version=version)
        self.metrics.update_device_gauges()
        self.profiler.update_gauges()
        if openmetrics:
            return self.metrics.render(openmetrics=True)
        return "\n".join(lines) + "\n" + self.metrics.render()

    def events_export(self, *, model=None, severity=None, since_seq=None,
                      since_ts=None, until_ts=None, category=None,
                      limit=None) -> dict:
        """The ``GET /v2/events`` body: the journal filtered by model,
        minimum severity, exclusive ``since`` cursors, category, an
        inclusive wall ``until_ts`` and the newest ``limit``."""
        return self.events.export(
            model=model, severity=severity, since_seq=since_seq,
            since_ts=since_ts, until_ts=until_ts, category=category,
            limit=limit)

    def profile_snapshot(self, model: str | None = None) -> dict:
        """The ``GET /v2/profile`` body: the per-model, per-bucket cost
        table (executions, real and padded rows, device seconds, cold
        first executions, roofline) and the duty cycle."""
        return self.profiler.snapshot(model=model)

    def trace_setting(self) -> dict:
        return self.trace.setting()

    def update_trace_setting(self, d: dict) -> dict:
        return self.trace.update(d or {})

    def request_trace_export(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON of recently finished traced requests
        (``GET /v2/trace/requests``), optionally of one trace id."""
        return self.request_traces.to_chrome_trace(trace_id)

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        if self._live:
            self.events.emit("lifecycle", "server_shutdown", draining=False)
        self.trace.shutdown()
        self._live = False
        with self._lock:
            # The bare-name aliases share their latest version's object.
            scheds = list({id(s): s for s in self._schedulers.values()}
                          .values())
            self._schedulers.clear()
        for s in scheds:
            s.stop()
        # After the work in flight: a request with outputs placed in a
        # region may still complete during the stop above.
        self.system_shm.unregister(None)
        self.cuda_shm.unregister(None)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')
