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
Load/unload at run time, the shm slot ring and staged datasets, and the
admission, QoS, tracing, profiling and cost planes are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

import client_tpu_torch
from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.repository import ModelRepository, _parse_version
from client_tpu_torch.engine.scheduler import Scheduler, make_scheduler
from client_tpu_torch.engine.shm import CudaShmManager, SystemShmManager
from client_tpu_torch.engine.stats import ModelStats
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
)

SERVER_NAME = "client_tpu_torch"
# The device regions answer on the tpu and cuda routes alike, as in the
# JAX package.
SERVER_EXTENSIONS = ["model_configuration", "binary_tensor_data",
                     "statistics", "generate", "system_shared_memory",
                     "tpu_shared_memory", "cuda_shared_memory"]


class TorchEngine:
    def __init__(self, repository: ModelRepository | None = None, *,
                 device: str | torch.device | None = None):
        """Builds every registered model on ``device`` and starts its
        scheduler. ``device=None`` means cuda, and raises when CUDA is
        unavailable; pass ``device="cpu"`` to serve on the CPU."""
        self.device = resolve_device(device)
        self.repository = repository or ModelRepository()
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
        for name in self.repository.names():
            model = self.repository.load(name, self.device)
            stats = ModelStats(name, str(model.config.version))
            with self._lock:
                self._stats[name] = stats
                self._schedulers[name] = make_scheduler(model, stats,
                                                        engine=self)

    # -- health / metadata ---------------------------------------------------

    def is_live(self) -> bool:
        return self._live

    def is_ready(self) -> bool:
        return self._live

    def server_metadata(self) -> dict:
        return {"name": SERVER_NAME, "version": client_tpu_torch.__version__,
                "extensions": list(SERVER_EXTENSIONS)}

    def _model(self, name: str, version: str = ""):
        """The model serving ``name`` at ``version`` ('' = latest), with
        the reference's order of checks: the version's form (400), the
        name (404), readiness (400), then the version (404)."""
        wanted = _parse_version(version)
        model = self.repository.get(name)
        if model is None:
            if name in self.repository.names():
                raise EngineError(f"model '{name}' is not ready", 400)
            raise EngineError(f"unknown model '{name}'", 404)
        if wanted is not None and wanted != int(model.config.version):
            raise EngineError(
                f"model '{name}' has no version '{str(version).strip()}'",
                404)
        return model

    def model_is_ready(self, name: str, version: str = "") -> bool:
        try:
            self._model(name, version)
        except EngineError:
            return False
        return True

    def model_metadata(self, name: str, version: str = "") -> dict:
        return self._model(name, version).config.metadata_dict()

    def model_config(self, name: str, version: str = "") -> dict:
        return self._model(name, version).config.config_dict()

    def model_statistics(self, name: str = "", version: str = "") -> dict:
        if name:
            self._model(name, version)
        with self._lock:
            stats = [s.to_dict() for n, s in sorted(self._stats.items())
                     if not name or n == name]
        return {"model_stats": stats}

    def repository_index(self) -> list[dict]:
        return self.repository.index()

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
        try:
            model = self._model(req.model_name, req.model_version)
            with self._lock:
                sched = self._schedulers.get(req.model_name)
            if sched is None:
                raise EngineError(
                    f"model '{req.model_name}' is not ready", 400)
            model.validate_inputs(req.inputs)
        except EngineError as exc:
            req.response_callback(InferResponse.make_error(req, exc))
            return
        sched.submit(req)

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

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        self._live = False
        with self._lock:
            scheds = list(self._schedulers.values())
            self._schedulers.clear()
        for s in scheds:
            s.stop()
        # After the work in flight: a request with outputs placed in a
        # region may still complete during the stop above.
        self.system_shm.unregister(None)
        self.cuda_shm.unregister(None)
