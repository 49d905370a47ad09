"""Ensemble scheduler: a DAG of composing models with tensor-name mapping.

Counterpart of ``client_tpu/engine/ensemble.py``. Steps declare
``input_map`` / ``output_map`` between ensemble-level tensor names and
composing-model tensor names; execution walks the steps in dependency
order and feeds each composing model through the engine, so each runs on
its own scheduler (never on the ensemble's worker) and its statistics
accumulate as if a client had called it.
"""

from __future__ import annotations

from client_tpu_torch.engine.scheduler import _SHUTDOWN, Scheduler
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    OutputRequest,
    now_ns,
)


class EnsembleScheduler(Scheduler):
    def __init__(self, model, stats, engine):
        if engine is None:
            raise EngineError("ensemble scheduler needs the engine", 500)
        self.engine = engine
        super().__init__(model, stats)

    def _worker_loop(self) -> None:
        while True:
            item = self.queue.get_many(1)[0]
            if item is _SHUTDOWN:
                return
            req: InferRequest = item
            if self._check_timeout(req) or self._check_cancelled(req):
                continue
            try:
                self._run_dag(req)
            except Exception as exc:  # noqa: BLE001 — the worker must live
                self._fail(req, exc)

    def _run_dag(self, req: InferRequest) -> None:
        cfg = self.model.config
        req.times.compute_start = now_ns()
        # The tensor pool starts with the ensemble-level inputs.
        pool = dict(req.inputs)
        pending = list(cfg.ensemble_scheduling)
        # Dependency order: run every step whose mapped inputs are all
        # present; repeat. A pass that runs nothing means underfeeding or
        # a cycle.
        while pending:
            still = []
            for step in pending:
                if all(n in pool for n in step.input_map.values()):
                    self._run_step(req, step, pool)
                else:
                    still.append(step)
            if len(still) == len(pending):
                missing = {n for s in still for n in s.input_map.values()
                           if n not in pool}
                raise EngineError(
                    f"ensemble '{cfg.name}': unsatisfiable steps; missing "
                    f"tensors {sorted(missing)}", 500)
            pending = still

        outputs = {}
        for tc in cfg.output:
            if tc.name not in pool:
                raise EngineError(
                    f"ensemble '{cfg.name}': no step produced output "
                    f"'{tc.name}'", 500)
            outputs[tc.name] = pool[tc.name]
        if req.outputs:
            requested = {o.name for o in req.outputs}
            outputs = {k: v for k, v in outputs.items() if k in requested}

        req.times.compute_input_end = req.times.compute_start
        req.times.compute_infer_end = now_ns()
        req.times.compute_output_end = req.times.compute_infer_end
        self.stats.record_execution(
            1, compute_ns=req.times.compute_infer_end - req.times.compute_start)
        self.stats.record_request(req.times, success=True)
        self._respond(req, InferResponse(
            model_name=req.model_name,
            model_version=req.model_version or str(cfg.version),
            request_id=req.request_id, outputs=outputs, times=req.times))

    def _run_step(self, req: InferRequest, step, pool: dict) -> None:
        sub = InferRequest(
            model_name=step.model_name,
            model_version="" if step.model_version < 0
            else str(step.model_version),
            request_id=req.request_id,
            inputs={mi: pool[et] for mi, et in step.input_map.items()},
            outputs=[OutputRequest(name=mo) for mo in step.output_map],
            timeout_us=req.timeout_us)
        resp = self.engine.infer(sub)
        for model_out, ensemble_name in step.output_map.items():
            if model_out not in resp.outputs:
                raise EngineError(
                    f"ensemble step '{step.model_name}' did not produce "
                    f"'{model_out}'", 500)
            pool[ensemble_name] = resp.outputs[model_out]
