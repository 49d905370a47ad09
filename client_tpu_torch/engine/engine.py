"""TorchEngine: the in-process serving façade.

Counterpart of ``TpuEngine`` (``client_tpu/engine/engine.py``) with the
method surface the HTTP frontend calls: health, server and model metadata,
model config and statistics, ``infer`` / ``async_infer`` and ``shutdown``.
A decoupled (streaming) model answers only through ``async_infer``, once
per response; a blocking ``infer`` on one is a 400. Each model gets the
scheduler its config asks for (``scheduler.make_scheduler``): dynamic
batching, ragged (lookups-axis) batching, sequence batching, generative
or other decoupled streaming, or an ensemble. Four shared-memory
managers serve both frontends and in-process callers: ``system_shm``
(regions by shm key) and ``cuda_shm`` (host-staged regions by handle, and
in-process regions of tensors on the card; ``engine/shm.py``), the slot
ring ``ring_shm`` (``engine/shmring.py``: producers fill slots of a
segment and ring a doorbell, or leave a reaped ring to the engine's
reaper thread; answers land in the slots) and the staged datasets
``staged_shm`` (``engine/staged.py``: read-only segments whose rows ring
slots reference by descriptor).
Models load, reload and unload at run time (:meth:`TorchEngine.load_model`,
:meth:`TorchEngine.unload_model`), each loaded version with its own
scheduler and statistics.

The observability planes: each engine has its own metric registry
(``metrics``: the legacy ``tpu_inference_*`` block and the histograms and
gauges of :meth:`prometheus_metrics`), binds it to the process-global
fault registry (``faults``), efficiency profiler (``profiler``,
``GET /v2/profile``), event journal (``events``, ``GET /v2/events``) and
cost ledger (``costs``, ``GET /v2/costs``), keeps a ring of finished
request traces (``request_traces``, ``GET /v2/trace/requests``), drives
the device trace of ``/v2/trace/setting`` (``trace``), scores the SLO
objectives (``slo``, ``GET /v2/slo``), reads the process-global HBM
census (``hbm_census``, ``GET /v2/memory``) and feeds the 1 Hz flight
recorder (``recorder``, ``GET /v2/timeseries``), whose thread stops at
:meth:`TorchEngine.shutdown`.

Overload protection: every request passes the admission controller
(``admission``: rate and concurrency caps, queue-depth and estimated-wait
shedding with ``Retry-After`` pushback, the shadow class) and its
end-to-end deadline is checked on the way in; the controller counts the
requests in flight exactly once each, which :meth:`begin_drain` and
``admission/drain.py`` wait on. :meth:`health_state` reads DRAINING,
then DEGRADED (a recent shed, or an SLO fast burn), then READY.

Tuning: ``warmup=True`` (or ``CLIENT_TPU_WARMUP``) runs every bucket of
each model it loads once on zeros, and the scheduler's own shapes (the
generative prefill and decode), before the load returns, so that no
bucket is cold under traffic. ``qos`` (``CLIENT_TPU_QOS``) classifies
each request into a tenant class: its lane in the schedulers' weighted
fair queue, its per-class admission gates, a class's implied priority
level, and the SLO-burn governor (``GET /v2/qos``). ``autotuner``
(``CLIENT_TPU_AUTOTUNE``) promotes and retires buckets against the
planning arena; ``selfdrive`` (``CLIENT_TPU_SELFDRIVE``) retunes dispatch
and tightens the admission of a model burning its SLO.

The incident blackbox (``blackbox``, ``CLIENT_TPU_BLACKBOX``, on by
default) listens to the journal and, on a trigger edge (an SLO fast
burn, a QoS throttle, an admission tightening, memory pressure, a storm
of breaker opens or a burst of deadline expiries), writes a bundle of
the planes above to disk (``GET /v2/debug/bundles``, ``POST
/v2/debug/capture``); its capture thread stops at :meth:`shutdown`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Callable

import torch

import client_tpu_torch
from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.engine.scheduler import Scheduler, make_scheduler
from client_tpu_torch.engine.shm import CudaShmManager, SystemShmManager
from client_tpu_torch.engine.stats import ModelStats
from client_tpu_torch.config import env_flag, env_int
from client_tpu_torch.engine.trace import TraceManager
from client_tpu_torch.engine.types import (
    DeadlineExpired,
    EngineError,
    InferRequest,
    InferResponse,
    now_ns,
)
from client_tpu_torch.observability import roofline
from client_tpu_torch.observability.costs import ledger
from client_tpu_torch.observability.events import journal
from client_tpu_torch.observability.memory import hbm_census
from client_tpu_torch.observability.metrics import EngineMetrics
from client_tpu_torch.observability.profiler import profiler
from client_tpu_torch.observability.slo import SloTracker
from client_tpu_torch.observability.timeseries import recorder
from client_tpu_torch.observability.tracing import (
    MAX_CHUNK_EVENTS,
    TraceStore,
    build_request_trace,
)
from client_tpu_torch.protocol.loadreport import LoadReport
from client_tpu_torch.utils import lockdep

if TYPE_CHECKING:
    from client_tpu_torch.admission import AdmissionController
    from client_tpu_torch.admission.qos import QosController

_log = logging.getLogger("client_tpu_torch")

SERVER_NAME = "client_tpu_torch"
# The device regions answer on the tpu and cuda routes alike, as in the
# JAX package.
SERVER_EXTENSIONS = ["model_configuration", "binary_tensor_data",
                     "statistics", "generate", "system_shared_memory",
                     "tpu_shared_memory", "cuda_shared_memory", "shm_ring",
                     "staged_dataset"]


class TorchEngine:
    def __init__(self, repository: ModelRepository | None = None, *,
                 device: str | torch.device | None = None,
                 admission: AdmissionController | None = None,
                 qos: QosController | None = None,
                 warmup: bool | None = None):
        """Loads every registered model on ``device`` and starts its
        schedulers; a model that fails to load stays in the repository
        index with its reason, and the rest load. ``device=None`` means
        cuda, and raises when CUDA is unavailable; pass ``device="cpu"``
        to serve on the CPU. The engine's metrics go into a registry of
        its own. ``admission`` defaults to a controller configured from
        ``CLIENT_TPU_ADMISSION`` (unset: everything admitted, requests in
        flight counted), ``qos`` to one from ``CLIENT_TPU_QOS`` (unset:
        off). ``warmup`` (None: ``CLIENT_TPU_WARMUP``) warms each model
        as it loads; on the card a warm execution that fails fails the
        load, and the model is left unloaded, UNAVAILABLE with the
        error as its reason."""
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
        # The slot ring and the staged datasets it references, on this
        # engine's registry and the journal; the ring manager resolves
        # staged descriptors through the dataset manager and admits a
        # reaped ring's slots through async_infer.
        from client_tpu_torch.engine.shmring import RingShmManager
        from client_tpu_torch.engine.staged import StagedDatasetManager

        self.staged_shm = StagedDatasetManager(
            registry=self.metrics.registry, events=self.events)
        self.ring_shm = RingShmManager(registry=self.metrics.registry,
                                       events=self.events,
                                       datasets=self.staged_shm,
                                       submit=self.async_infer)
        # SLO objectives (CLIENT_TPU_SLO; off when unset), their gauges on
        # this engine's registry.
        self.slo = SloTracker.from_env(registry=self.metrics.registry)
        # The process-global cost ledger: the schedulers charge it from
        # below; this registry gets its tpu_cost_* counters.
        self.costs = ledger()
        self.costs.bind_metrics(self.metrics.registry)
        self.hbm_census = hbm_census()
        # Imported here: the admission package imports engine.types, whose
        # package imports this module.
        from client_tpu_torch.admission import AdmissionController

        self.admission = admission or AdmissionController.from_env(
            metrics=self.metrics)
        if self.admission._metrics is None:
            self.admission._metrics = self.metrics
        # Tenant QoS; disabled (env unset, no controller given) everything
        # it touches is inert: schedulers keep their priority heap and
        # admission runs only the shared gates.
        from client_tpu_torch.admission.qos import QosController

        self.qos = qos or QosController.from_env(metrics=self.metrics)
        if self.qos._metrics is None:
            self.qos._metrics = self.metrics
        self.admission.attach_qos(self.qos)
        self._warmup = env_flag("CLIENT_TPU_WARMUP") if warmup is None \
            else bool(warmup)
        self._draining = False
        self._last_health: str | None = None
        # (monotonic stamp, LoadReport) of the last load report built.
        self._load_report_cache: tuple | None = None
        # The flight recorder's per-signal state (the fill EWMA, counter
        # deltas), touched only from its thread.
        self._ts_state: dict = {"fill": {}, "shed": {}, "tenant_cost": {},
                                "mono": None}
        self.trace = TraceManager()
        self.request_traces = TraceStore(
            capacity=env_int("CLIENT_TPU_TRACE_BUFFER"))
        self.repository = repository or ModelRepository()
        # 'name:v' per loaded version, and 'name' as the alias of the
        # latest one (the same scheduler and stats objects).
        self._schedulers: dict[str, Scheduler] = {}
        self._stats: dict[str, ModelStats] = {}
        self._lock = lockdep.Lock("engine.engine")
        self._live = True
        self.system_shm = SystemShmManager()
        # A region's device_id indexes the visible cards (the engine's own
        # device alone on the CPU).
        self.cuda_shm = CudaShmManager(devices=(
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if self.device.type == "cuda" else [self.device]))
        # The bucket autotuner and its planning arena
        # (CLIENT_TPU_AUTOTUNE) and the self-drive governor
        # (CLIENT_TPU_SELFDRIVE); unset, neither exists and no thread runs.
        from client_tpu_torch.engine.autotune import (
            Autotuner,
            AutotuneConfig,
        )
        from client_tpu_torch.engine.selfdrive import (
            SelfDriveConfig,
            SelfDriveGovernor,
        )

        tune_cfg = AutotuneConfig.from_env()
        self.autotuner = (Autotuner(self, tune_cfg,
                                    registry=self.metrics.registry)
                          if tune_cfg is not None else None)
        drive_cfg = SelfDriveConfig.from_env()
        self.selfdrive = (SelfDriveGovernor(self, drive_cfg)
                          if drive_cfg is not None else None)
        # The incident blackbox (CLIENT_TPU_BLACKBOX; `0`/`off` leaves it
        # None). The card's name is read here, once: a crash bundle must
        # make no CUDA call.
        from client_tpu_torch.observability.blackbox import (
            BlackboxConfig,
            BlackboxRecorder,
        )

        self.blackbox: BlackboxRecorder | None = None
        bb_cfg = BlackboxConfig.from_env()
        if bb_cfg.enabled:
            self.blackbox = BlackboxRecorder(
                self, bb_cfg, registry=self.metrics.registry,
                device_name=(torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else None)
            ).install()
        self.events.emit("lifecycle", "server_start",
                         models=len(self.repository.names()),
                         slo_enabled=self.slo.enabled,
                         autotune=self.autotuner is not None,
                         selfdrive=self.selfdrive is not None,
                         blackbox=self.blackbox is not None)
        for name in self.repository.names():
            try:
                self.load_model(name)
            except Exception as exc:  # noqa: BLE001 — load the rest
                _log.error("model '%s' failed to load: %s", name, exc)
                self.events.emit("lifecycle", "model_load_failed",
                                 severity="ERROR", model=name, error=str(exc))
        # Held weakly: the recorder samples timeseries_sample() at 1 Hz
        # until shutdown() detaches this engine.
        self.recorder = recorder()
        self.recorder.attach(self)
        if self.autotuner is not None:
            self.autotuner.start()
        if self.selfdrive is not None:
            self.selfdrive.start()
        # The QoS governor needs the alarm (SLO fast burn) and an actuator
        # (a throttleable class bucket); start_governor checks the latter.
        if self.qos.enabled and self.slo.enabled:
            self.qos.start_governor(self.slo, self.costs)

    # -- health / metadata ---------------------------------------------------

    def is_live(self) -> bool:
        return self._live

    def is_ready(self) -> bool:
        # A draining server is still live (in-flight work finishes) but
        # not ready (no new work should come here).
        return self._live and not self._draining

    def health_state(self) -> str:
        """Readiness with nuance (``/v2/health/ready``'s body and the
        ``X-Health-State`` header): DRAINING while refusing new work,
        DEGRADED while the admission controller shed recently or a model
        burns its SLO budget fast, else READY. Each change is journalled
        (``lifecycle.health``)."""
        fast_burn: list[str] = []
        if self._draining or not self._live:
            state = "DRAINING"
        elif self.admission.degraded():
            state = "DEGRADED"
        else:
            fast_burn = self.slo.fast_burn()
            state = "DEGRADED" if fast_burn else "READY"
        prev = self._last_health
        if state != prev:
            self._last_health = state
            detail = {"state": state}
            if prev is not None:
                detail["previous"] = prev
            if fast_burn:
                detail["slo_fast_burn"] = fast_burn
            self.events.emit(
                "lifecycle", "health",
                severity="INFO" if state == "READY" else "WARNING",
                **detail)
        return state

    def begin_drain(self) -> None:
        """Turn readiness off and refuse new requests with 503 and
        ``Retry-After`` pushback; work in flight and queued goes on.
        ``admission.drain.drain`` runs the whole sequence."""
        self._draining = True

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
        new_scheds: list[Scheduler] = []
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
                            name, str(v)),
                        slo=self.slo, events=self.events)
                    self._stats[key] = stats
                self._schedulers[key] = make_scheduler(
                    model, stats, engine=self,
                    qos=self.qos if self.qos.enabled else None)
                new_models.append(model)
                new_scheds.append(self._schedulers[key])
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
                if model in new_models:
                    cache.bind_metrics(self.metrics.registry, name,
                                       model.config.version)
                cache.clear()
        for model in new_models:
            self.events.emit("model", "load", model=name,
                             version=model.config.version)
        if self.autotuner is not None:
            # Retired versions first: their cooldowns, applied marks and
            # reservations go before the new ones reserve.
            for v in sorted({str(s.model.config.version) for s in retired}):
                self.autotuner.on_version_retired(name, v)
            for model, sched in zip(new_models, new_scheds):
                self.autotuner.on_model_loaded(model, sched)
        if self._warmup:
            try:
                for model in new_models:
                    model.warmup()
                for sched in new_scheds:
                    sched.warmup()
            except Exception as exc:
                # A warm-up that raised fails the model: no version of it
                # serves, and the index says why.
                self.unload_model(name)
                self.repository.unload(name, reason=f"warmup failed: {exc}")
                raise

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
        if self.autotuner is not None:
            self.autotuner.on_model_unloaded(name)
        self.repository.unload(name)
        # Its census rows go now, not when the collector frees them.
        self.hbm_census.untag(name)
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

    def schedulers(self) -> list[Scheduler]:
        """The distinct live schedulers (a bare-name alias shares its
        latest version's); the drain polls their queues."""
        with self._lock:
            return list({id(s): s for s in self._schedulers.values()}
                        .values())

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
        # Overload protection: these raise, as a scheduler's refusal does,
        # so that every frontend answers them on one path.
        from client_tpu_torch.admission import AdmissionError

        trace_id = req.trace.trace_id if req.trace is not None else None
        # The tenant is resolved before any shed, so a shed is
        # attributable: untagged requests fold to the shadow class's
        # tenant or "default".
        if not req.tenant:
            req.tenant = "shadow" if self.admission.is_shadow(
                req.model_name, req.priority) else "default"
        else:
            req.tenant = self.costs.canonical_tenant(req.tenant)
        # QoS: the class (the request's lane) from the tenant table or the
        # priority band; a class may imply the priority of a request that
        # came without one.
        if self.qos.enabled:
            req.qos_class = self.qos.classify(req.tenant, req.priority)
            if req.priority <= 0:
                level = self.qos.priority_level(req.qos_class)
                if level > 0:
                    req.priority = level
        if self._draining or not self._live:
            self.admission.record_rejection(
                req.model_name, req.model_version, reason="draining",
                trace_id=trace_id, tenant=req.tenant)
            raise AdmissionError(
                "server is draining; retry against another replica",
                retry_after_s=1.0, reason="draining", status=503)
        if req.deadline_expired():
            # The client's budget lapsed in transit or in parsing.
            sched.stats.record_deadline_expired("admission",
                                                trace_id=trace_id)
            raise DeadlineExpired(
                "end-to-end deadline expired before admission")
        class_depth = sched.queue.class_qsize(req.qos_class) \
            if req.qos_class and hasattr(sched.queue, "class_qsize") else 0
        self.admission.admit(
            req.model_name, req.model_version,
            queue_depth=sched.queue.qsize(), instances=len(sched.workers),
            trace_id=trace_id, priority=req.priority, tenant=req.tenant,
            qos_class=req.qos_class, class_queue_depth=class_depth)
        self._submit_accounted(sched, req)

    def _submit_accounted(self, sched: Scheduler, req: InferRequest) -> None:
        """Submit with exactly-once in-flight accounting: the count rises
        before the submit and falls on the final response (feeding the
        service-time EWMA), or at once when the submit itself refuses the
        request, which then gets no response through its callback."""
        model_name = req.model_name
        shadow = self.admission.is_shadow(model_name, req.priority)
        qos_class = req.qos_class if self.qos.enabled else ""
        self.admission.on_request_start(model_name, shadow=shadow)
        if qos_class:
            self.qos.on_request_start(qos_class)
        inner = req.response_callback
        ended = [False]

        def _end(service_s: float | None = None) -> None:
            ended[0] = True
            self.admission.on_request_end(model_name, service_s,
                                          shadow=shadow)
            if qos_class:
                self.qos.on_request_end(qos_class)

        def _accounted(resp: InferResponse) -> None:
            if resp.final and not ended[0]:
                service_s = None
                t = req.times
                if resp.error is None and t.compute_start:
                    service_s = max(
                        0.0, (t.compute_output_end - t.compute_start) / 1e9)
                _end(service_s)
            inner(resp)

        req.response_callback = _accounted
        try:
            sched.submit(req)
        except BaseException:
            if not ended[0]:
                _end()
            raise

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

    def ring_doorbell(self, name: str, spec: dict) -> dict:
        """Admit a span of FILLED ring slots (``engine/shmring.py``); each
        slot's answer lands in its response region."""
        return self.ring_shm.doorbell(name, spec)

    def resolve_staged_input(self, dataset: str, tensor_index: int,
                             row_start: int, row_count: int):
        """A 24-byte staged-input descriptor as a zero-copy row slice of a
        registered staged dataset (``engine/staged.py``)."""
        return self.staged_shm.resolve(dataset, tensor_index, row_start,
                                       row_count)

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
        self.metrics.update_device_gauges(census=self.hbm_census)
        self.metrics.update_census_gauges(self.memory_census())
        # Duty-cycle and SLO burn gauges refresh at scrape time, so that a
        # quiet period still reads current windows.
        self.profiler.update_gauges()
        self.ring_shm.update_gauges()
        if self.slo.enabled:
            self.slo.snapshot()
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
        first executions, roofline) and the duty cycle; each model's
        ``hbm_bytes`` reservation and ``row_cache`` where its backend has
        them; the autotuner's ``autotune`` section and the suggestions'
        ``state``, and self-drive's ``selfdrive`` section, when they run;
        the attached rings' (``shm_rings``) and staged datasets'
        (``shm_datasets``) tables, when there are any; and the census's
        headline (``memory``)."""
        snap = self.profiler.snapshot(model=model)
        for entry in snap.get("models", {}).values():
            sched = self.scheduler_for(entry["model"], entry["version"])
            if sched is None:
                continue
            backend = sched.model.backend
            hbm = getattr(backend, "hbm_reservation_bytes", None)
            if callable(hbm):
                entry["hbm_bytes"] = int(hbm())
            cache = getattr(backend, "row_cache", None)
            if cache is not None:
                entry["row_cache"] = cache.snapshot()
        if self.autotuner is not None:
            self.autotuner.annotate(snap)
        if self.selfdrive is not None:
            snap["selfdrive"] = self.selfdrive.snapshot()
        rings = self.ring_shm.profile_table()
        if rings:
            snap["shm_rings"] = rings
        datasets = self.staged_shm.profile_table()
        if datasets:
            snap["shm_datasets"] = datasets
        census = self.memory_census()
        snap["memory"] = {
            "bytes_limit": census["totals"].get("bytes_limit", 0),
            "bytes_in_use": census["totals"].get("bytes_in_use", 0),
            "committed_bytes": census["totals"]["committed_bytes"],
            "attributed_bytes": census["attributed_bytes"],
            "unattributed_bytes": census["unattributed_bytes"],
            "attributed_fraction": census["attributed_fraction"],
            "watermark_bytes": census["watermark_bytes"],
            "owners": census["owners"],
        }
        return snap

    def qos_snapshot(self, model: str | None = None) -> dict:
        """The ``GET /v2/qos`` body: the controller's class table
        (weights, quotas, throttle ratios, in flight, sheds and
        preemptions) and each model's lane depths from the live
        schedulers (versions summed)."""
        snap = self.qos.snapshot()
        queues: dict[str, dict[str, int]] = {}
        if self.qos.enabled:
            with self._lock:
                scheds = dict(self._schedulers)
            seen: set[int] = set()
            for key, sched in sorted(scheds.items()):
                name = key.split(":", 1)[0]
                if model and name != model:
                    continue
                q = sched.queue
                if id(sched) in seen or not hasattr(q, "class_qsize"):
                    continue
                seen.add(id(sched))
                depths = queues.setdefault(name, {})
                for cls in self.qos.class_names():
                    depths[cls] = depths.get(cls, 0) + q.class_qsize(cls)
        snap["queues"] = queues
        return snap

    def slo_snapshot(self) -> dict:
        """The ``GET /v2/slo`` body: per-model window counts and burn
        rates."""
        return self.slo.snapshot()

    def costs_snapshot(self, model: str | None = None) -> dict:
        """The ``GET /v2/costs`` body: the per-tenant cost ledger and a
        ``reconciliation`` section holding its totals against the
        profiler's device seconds and the census's live KV-arena bytes,
        the independent meters conservation is audited against."""
        snap = self.costs.snapshot(model=model)
        prof = self.profiler.snapshot(model=model)
        prof_device = sum(e["device_s"]
                          for e in prof.get("models", {}).values())
        census = self.memory_census()
        kv_bytes = sum(o["bytes"] for o in census.get("owners", ())
                       if o.get("component") == "kv_arena"
                       and (model is None or o.get("model") == model))
        ledger_device = snap.get("totals", {}).get("device_s", 0.0)
        snap["reconciliation"] = {
            "profiler_device_s": round(prof_device, 6),
            "profiler_window_s": prof.get("window_s"),
            "ledger_device_s": round(ledger_device, 6),
            "device_s_ratio": round(ledger_device / prof_device, 4)
            if prof_device > 0 else None,
            "census_kv_arena_bytes": int(kv_bytes),
        }
        return snap

    def memory_census(self) -> dict:
        """The ``GET /v2/memory`` body: live card bytes per (model,
        component) owner, drift against the backends' reservations,
        per-card memory counters and the unattributed remainder."""
        extra_plans: dict = {}
        for sched in self.schedulers():
            backend = sched.model.backend
            hbm = getattr(backend, "hbm_reservation_bytes", None)
            if callable(hbm):
                component = ("rowcache" if getattr(backend, "host_tables",
                                                   False) else "embedding")
                extra_plans[(sched.model.config.name, component)] = \
                    int(hbm())
        return self.hbm_census.report(extra_plans=extra_plans,
                                      events=self.events)

    def timeseries_sample(self) -> dict:
        """One flight-recorder sample (the recorder's thread calls this
        at 1 Hz; ``observability/timeseries.py`` names the signals).
        Scalars are engine-wide; per-model signals are {model: value}
        maps, and ``tenant_cost_rate``'s keys are tenants."""
        state = self._ts_state
        now = time.monotonic()
        elapsed = (now - state["mono"]) if state["mono"] else None
        state["mono"] = now
        sample: dict = {"duty_cycle": round(self.profiler.duty_cycle(), 6)}
        queue_depth: dict[str, int] = {}
        in_flight: dict[str, int] = {}
        for sched in self.schedulers():
            name = sched.model.config.name
            queue_depth[name] = queue_depth.get(name, 0) + sched.queue.qsize()
            in_flight[name] = in_flight.get(name, 0) + sched.active_batches
        sample["queue_depth"] = queue_depth
        sample["in_flight"] = in_flight
        # The fill ratio smoothed across ticks (alpha 0.3: about a
        # 3-sample memory at 1 Hz), the wave p50 and the MFU, all read off
        # the /v2/profile table.
        fill: dict[str, float] = {}
        wave: dict[str, float] = {}
        mfu: dict[str, float] = {}
        for entry in self.profiler.snapshot().get("models", {}).values():
            name = entry["model"]
            model_mfu = (entry.get("roofline") or {}).get("mfu")
            if model_mfu is not None:
                mfu[name] = round(float(model_mfu), 6)
            rows = sum(b["rows"] for b in entry.get("buckets", ()))
            padded = sum(b["padded_rows"] for b in entry.get("buckets", ()))
            if rows + padded:
                current = rows / (rows + padded)
                prev = state["fill"].get(name)
                fill[name] = round(current if prev is None
                                   else 0.3 * current + 0.7 * prev, 6)
            waves_total = wave_weighted = 0.0
            for w in entry.get("decode_waves", ()):
                n = float(w.get("waves", 0) or 0)
                if n > 0:
                    waves_total += n
                    wave_weighted += n * float(w["wave_ms_p50"])
            if waves_total > 0:
                wave[name] = round(wave_weighted / waves_total, 3)
        state["fill"].update(fill)
        for key, value in (("batch_fill", fill), ("wave_p50_ms", wave),
                           ("mfu", mfu)):
            if value:
                sample[key] = value
        # Counter deltas over the tick gap: admission sheds per model
        # (versions and reasons summed) and device seconds per tenant.
        shed_totals: dict[str, float] = {}
        for labels, child in list(
                self.metrics.admission_rejections._children.items()):
            shed_totals[labels[0]] = shed_totals.get(labels[0], 0.0) + child.v
        cost_totals = {t: row["device_s"] + row["padding_s"]
                       for t, row in
                       self.costs.snapshot().get("tenants", {}).items()}
        for key, totals, prev_key, digits in (
                ("shed_rate", shed_totals, "shed", 4),
                ("tenant_cost_rate", cost_totals, "tenant_cost", 6)):
            rate = {}
            if elapsed and elapsed > 0:
                for name, total in totals.items():
                    prev = state[prev_key].get(name, 0.0)
                    rate[name] = round(max(0.0, total - prev) / elapsed,
                                       digits)
            state[prev_key] = totals
            if rate:
                sample[key] = rate
        # The census's card bytes in use (the allocator's live bytes).
        sample["hbm_used"] = sum(d["bytes_in_use"]
                                 for d in self.hbm_census.device_stats())
        if self.autotuner is not None:
            sample["hbm_reserved"] = int(
                self.autotuner.arena.reserved_bytes())
        if self.slo.enabled:
            burn = {name: float(report["windows"]["5m"]
                                ["availability_burn_rate"])
                    for name, report in self.slo.snapshot()["models"].items()}
            if burn:
                sample["slo_burn"] = burn
        # The QoS governor's actuation: classes held below their rate (0:
        # the loop is quiet).
        if self.qos.enabled:
            sample["qos_throttled"] = len(self.qos.throttled_classes())
        return sample

    def timeseries_export(self, *, signal=None, model=None,
                          since_seq=None, since_wall=None,
                          until_wall=None, limit=None) -> dict:
        """The ``GET /v2/timeseries`` body: the recorder's ring, narrowed
        by signal, model, an exclusive seq cursor or a wall window
        (exclusive lower, inclusive upper)."""
        return self.recorder.export(signal=signal, model=model,
                                    since_seq=since_seq,
                                    since_wall=since_wall,
                                    until_wall=until_wall, limit=limit)

    # -- incident blackbox ----------------------------------------------------

    def blackbox_bundles(self, bundle_id: str | None = None) -> dict:
        """The ``GET /v2/debug/bundles[/{id}]`` body: the bundle ring's
        index, or one whole bundle. 400 when the blackbox is disabled,
        the id malformed or the file corrupt; 404 for an unknown id."""
        if self.blackbox is None:
            raise EngineError(
                "blackbox disabled (CLIENT_TPU_BLACKBOX=off)", 400)
        try:
            return self.blackbox.bundles(bundle_id)
        except KeyError:
            raise EngineError(
                f"unknown bundle {bundle_id!r}", 404) from None
        except ValueError as exc:
            raise EngineError(str(exc), 400) from None

    def blackbox_capture(self, trigger: str = "manual", *,
                         incident: str | None = None,
                         note: str | None = None) -> dict:
        """The ``POST /v2/debug/capture`` body: a bundle written now.
        ``manual``, ``crash`` and ``fleet`` always capture; an automatic
        trigger's name respects the debounce and cooldown, and answers
        ``{"deduped": true}`` with the earlier bundle's id instead of a
        second bundle of one incident."""
        if self.blackbox is None:
            raise EngineError(
                "blackbox disabled (CLIENT_TPU_BLACKBOX=off)", 400)
        try:
            return self.blackbox.capture(
                trigger, incident=incident, note=note,
                respect_cooldown=True)
        except ValueError as exc:
            raise EngineError(str(exc), 400) from None

    # -- load report -----------------------------------------------------------

    # Staleness bound on the cached load report: every inference response
    # carries it, so it must cost less than a response; 50 ms is far below
    # any change of load a router acts on.
    LOAD_REPORT_TTL_S = 0.05

    def load_report(self, max_age_s: float | None = None) -> LoadReport:
        """The replica's load report (``GET /v2/load`` and the
        ``X-Tpu-Load`` piggyback): health state, in flight, queue depth,
        active batches, the admission EWMA's wait estimate and SLO fast
        burn, which the router scores replicas by. Cached for
        :data:`LOAD_REPORT_TTL_S` (``max_age_s=0`` rebuilds it). It reads
        the queues' depths without their locks, so a response never waits
        on a worker gathering a batch."""
        ttl = self.LOAD_REPORT_TTL_S if max_age_s is None else max_age_s
        now = time.monotonic()
        cached = self._load_report_cache
        if cached is not None and now - cached[0] <= ttl:
            return cached[1]
        snap = self.admission.load_snapshot()
        inflight = sum(g["inflight"] for g in snap.values())
        queue_depth = active_batches = 0
        wait_s = 0.0
        models: list[str] = []
        for sched in self.schedulers():
            cfg = sched.model.config
            models.append(cfg.name)
            depth = sched.queue.depth()  # no wait on a batch being formed
            queue_depth += depth
            active_batches += sched.active_batches
            service = snap.get(cfg.name, {}).get("ewma_service_s", 0.0)
            if depth and service > 0:
                wait_s += depth * service / max(1, cfg.instance_count)
        report = LoadReport(
            state=self.health_state(), inflight=inflight,
            queue_depth=queue_depth, active_batches=active_batches,
            wait_s=wait_s, slo_fast_burn=bool(self.slo.fast_burn()),
            models=tuple(sorted(models)))
        self._load_report_cache = (now, report)
        return report

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
            self.events.emit("lifecycle", "server_shutdown",
                             draining=self._draining)
        self._live = False
        if self.blackbox is not None:
            # First: off the journal before the state its capture thread
            # snapshots is torn down.
            self.blackbox.close()
        self.qos.stop_governor()
        self.recorder.detach(self)
        if self.selfdrive is not None:
            self.selfdrive.stop()
        if self.autotuner is not None:
            self.autotuner.stop()
        self.trace.shutdown()
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
        # The reaper stops before the segments unmap beneath it.
        self.ring_shm.shutdown()
        self.staged_shm.unregister(None)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')
