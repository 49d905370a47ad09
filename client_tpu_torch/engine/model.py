"""Model execution: an ``nn.Module`` backend run per padded batch bucket.

Counterpart of ``client_tpu/engine/model.py``. A backend is an
``nn.Module`` whose ``forward`` maps a dict of input tensors to a dict of
output tensors; its weights live on the model's device. PyTorch runs
eagerly, so there is no jit and nothing compiles on a first call. A batch
still pads up to a bucket of the model's ladder, which keeps the shapes
the kernels see to a small set.

Each scheduler worker thread runs its batches on its own CUDA stream, so
two instances of one model overlap on the card, and every phase boundary
waits on that stream alone, never on the whole device. The stream is the
one of the thread's cuBLAS handle (:func:`worker_stream`), so the workers
of a reloaded model reuse their predecessors' streams. An input may be a
tensor already on the card (a device shared-memory region): it is padded
there and never staged through the host, and a batch whose requests all
keep their outputs on the device skips the fetch (``fetch_outputs``).

Each execution feeds the efficiency profiler: its CUDA-event device time
(``ExecPhases.device_ns``), rows and padding. The first execution of an
input signature is the port's "compile" (a kernel's first-use build,
cuBLAS's handles and workspaces): it is recorded as cold, kept out of
device time, and counted once for the roofline
(``observability.roofline.CostCapture``), as JAX keeps XLA's compile
out and reads XLA's cost model. The ``model.execute`` fault site fires
before any work.

Three hooks a backend may define, as in the JAX package: a ragged backend
(DLRM) checks the structure of its CSR tensors in ``validate_ragged`` and
stages them itself in ``pre_stage`` (no generic row padding then); a
stateful backend (sequence batching) defines ``initial_state()`` and
``step(state, inputs) -> (state, outputs)``, run by
:meth:`Model.execute_stateful`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from client_tpu_torch import faults
from client_tpu_torch.engine.backend_init import resolve_device
from client_tpu_torch.engine.checkpoint import load_params
from client_tpu_torch.engine.config import ModelConfig
from client_tpu_torch.engine.shm import wait_for_writer
from client_tpu_torch.engine.types import EngineError, now_ns
from client_tpu_torch.observability.profiler import profiler
from client_tpu_torch.observability.roofline import CostCapture
from client_tpu_torch.protocol.dtypes import wire_to_np_dtype


def np_dtype_of(arr) -> np.dtype | None:
    """The numpy dtype of a host array, or of a tensor read from a device
    region (None for bfloat16 without ``ml_dtypes``)."""
    if not isinstance(arr, torch.Tensor):
        return arr.dtype
    if arr.dtype == torch.bfloat16:
        return wire_to_np_dtype("BF16")
    return torch.empty(0, dtype=arr.dtype).numpy().dtype


@dataclass
class ExecPhases:
    """Absolute-ns boundaries of one execution's three phases.

    ``input_end`` bounds the host work (pad, pin, enqueue of the H2D
    copies); ``infer_end`` waits on a CUDA event recorded after the forward
    pass on the executing stream; ``output_end`` follows the D2H copies.
    ``device_ns`` is the forward's time on the card, between CUDA events
    recorded on the stream before and after it (on the CPU, the host's
    ``infer_end - input_end``). ``compile_ns`` is the cold first
    execution's ``infer_end - input_end`` (0 on a warm one).
    """

    start: int = 0
    input_end: int = 0
    infer_end: int = 0
    output_end: int = 0
    device_ns: int = 0
    compile_ns: int = 0


# cuBLAS keeps a workspace (32 MiB on Hopper) for each (handle, stream)
# pair it has run on, for the life of the process, and cuBLASLt one of
# 1 MiB per (its own handle, stream). A handle belongs to one live thread
# and passes to a later thread when its own ends, so a stream kept per
# cuBLAS handle bounds those pairs by the threads alive at once: a model's
# reload starts new workers, which reuse the old pairs.
_HANDLE_STREAMS: dict[tuple[int, int], torch.cuda.Stream] = {}
_HANDLE_STREAMS_LOCK = threading.Lock()
_THREAD = threading.local()


def worker_stream(device: torch.device) -> torch.cuda.Stream:
    """The calling thread's CUDA stream on ``device``: the stream kept for
    the thread's cuBLAS handle there, which no other live thread holds.
    The first call in a thread makes cuBLAS's workspaces for the pair."""
    streams = getattr(_THREAD, "streams", None)
    if streams is None:
        streams = _THREAD.streams = {}
    stream = streams.get(device)
    if stream is None:
        with torch.cuda.device(device):
            # A runtime call first makes the card's context current in this
            # thread, as cuBLAS expects.
            torch.cuda.current_stream().query()
            key = (torch.cuda.current_device(),
                   torch.cuda.current_blas_handle())
            with _HANDLE_STREAMS_LOCK:
                stream = _HANDLE_STREAMS.get(key)
                if stream is None:
                    stream = _HANDLE_STREAMS[key] = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                # cuBLAS and cuBLASLt each keep a workspace for the pair:
                # one small GEMM with a bias makes both now.
                x = torch.ones(8, 8, device=device)
                torch.nn.functional.linear(x, x, x[0])
        streams[device] = stream
    return stream


_RESTORE_FROM: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "restore_from", default=None)


@contextlib.contextmanager
def restoring(weights_path: str | None):
    """Backends constructed inside take their weights from the JAX
    package's checkpoint at ``weights_path`` (``engine/checkpoint.py``)
    instead of their seeded init; ``None`` changes nothing."""
    token = _RESTORE_FROM.set(weights_path)
    try:
        yield
    finally:
        _RESTORE_FROM.reset(token)


class ModelBackend(nn.Module):
    """A servable model: a ``config`` attribute and a ``forward(inputs)``
    from a dict of batched tensors on the model's device to a dict of
    output tensors.

    A backend with ``host_side = True`` is a pre/post-process model that
    is host-side in the JAX package too (its ``jittable = False``): its
    ``forward`` maps numpy arrays to numpy arrays, BYTES included, on the
    host whatever the model's device, and its batch is neither padded to
    a bucket nor staged to the card. An ensemble's backend carries only
    its config and is never executed.

    A backend with weights keeps them convertible to the JAX package's
    params pytree and back (``params_to_jax`` / ``load_jax_params``), so
    both packages share checkpoints. ``weights_path`` is the checkpoint
    of a backend constructed inside :func:`restoring`."""

    config: ModelConfig
    host_side = False
    weights_path: str | None = None

    def __init__(self):
        super().__init__()
        self.weights_path = _RESTORE_FROM.get()

    def restore(self, like):
        """The checkpoint at ``weights_path`` as a tree of CPU tensors
        shaped like ``like``, whose leaves may be ``meta`` tensors; a
        checkpoint that is missing or does not match fails with the JAX
        package's words (400)."""
        return load_params(self.weights_path, like)

    def load_or_init_params(self, init_fn) -> None:
        """Give a module built on the ``meta`` device its storage on the
        CPU and its weights: ``init_fn()`` fills the seeded init, or, with
        ``weights_path`` set, the checkpoint is checked against
        ``params_to_jax()`` of the module as built (shapes and dtypes,
        before any storage exists) and loaded, and the seeded fill never
        runs. Counterpart of the JAX package's ``load_or_init_params``."""
        tree = self.restore(self.params_to_jax()) if self.weights_path \
            else None
        self.to_empty(device="cpu")
        if tree is None:
            init_fn()
        else:
            self.load_jax_params(tree)


class Model:
    """A loaded model: backend on its device, bucket padding, timed
    execution."""

    def __init__(self, backend: ModelBackend,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.backend = backend.to(self.device).eval()
        self.config = backend.config
        # Per-input validation metadata, built once: the config is fixed
        # after load.
        self._input_meta = {
            t.name: (t, np.dtype(wire_to_np_dtype(t.data_type)), tuple(t.dims))
            for t in self.config.input
        }
        # Input signatures (names, shapes, dtypes) executed once already:
        # the next execution of one is warm.
        self._seen: set = set()
        self._seen_lock = threading.Lock()

    def _stream(self) -> torch.cuda.Stream:
        return worker_stream(self.device)

    def _on_stream(self):
        """The calling worker's own stream as the current one (nothing on
        the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream())

    def concat_rows(self, tensors: list[torch.Tensor]) -> torch.Tensor:
        """Request tensors joined along the batch axis on the device, on
        the worker's stream, each after the write that filled it."""
        with self._on_stream():
            for t in tensors:
                wait_for_writer(t)
            return torch.cat(tensors, dim=0)

    def validate_inputs(self, inputs: dict[str, np.ndarray]) -> int:
        """Check names, dtypes and shapes; returns the request's batch size
        (1 when the model is unbatched)."""
        cfg = self.config
        batch = 1
        for name, (tc, _, _) in self._input_meta.items():
            if name not in inputs and not tc.optional:
                raise EngineError(
                    f"missing input '{name}' for model '{cfg.name}'")
        for name, arr in inputs.items():
            entry = self._input_meta.get(name)
            if entry is None:
                raise EngineError(
                    f"unexpected input '{name}' for model '{cfg.name}'")
            tc, np_dt, dims = entry
            got = np_dtype_of(arr)
            if np_dt != got:
                raise EngineError(
                    f"input '{name}': dtype {got} != declared "
                    f"{tc.data_type}")
            shape = list(arr.shape)
            if cfg.max_batch_size > 0 and not tc.ragged:
                if len(shape) != len(dims) + 1:
                    raise EngineError(
                        f"input '{name}': expected batched rank "
                        f"{len(dims) + 1}, got shape {shape}")
                batch = shape[0]
                shape = shape[1:]
            # The JAX package's words, so both frontends answer as the JAX
            # package's frontends do.
            if len(shape) != len(dims):
                raise EngineError(
                    f"input '{name}': rank mismatch, {shape} vs dims {dims}")
            if any(want != -1 and got != want
                   for got, want in zip(shape, dims)):
                raise EngineError(
                    f"input '{name}': shape {shape} incompatible with "
                    f"dims {dims}")
        if cfg.max_batch_size > 0 and batch > cfg.max_batch_size:
            raise EngineError(
                f"batch size {batch} exceeds max_batch_size "
                f"{cfg.max_batch_size} for '{cfg.name}'")
        if cfg.max_batch_size > 0 and batch < 1:
            raise EngineError(f"batch size {batch} is below 1 for "
                              f"'{cfg.name}'")
        # A ragged backend checks what the per-tensor loop cannot see:
        # offsets against indices, the lookup ceiling, the id range.
        check = getattr(self.backend, "validate_ragged", None)
        if check is not None and cfg.max_batch_size > 0:
            check(inputs, batch)
        return batch

    def pick_bucket(self, batch: int) -> int:
        """Smallest ladder bucket that holds ``batch`` units of the padding
        axis (rows, or summed lookups for a ragged DLRM batch)."""
        for b in self.config.effective_buckets():
            if b >= batch:
                return b
        return self.config.axis_capacity()

    def execute_timed(self, inputs: dict,
                      batch_size: int | None = None,
                      fetch_outputs: bool = True) -> tuple[dict, ExecPhases]:
        """Pad to the bucket, stage to the device, run the forward pass,
        fetch to the host and slice back to ``batch_size`` rows. Returns
        the outputs and the measured :class:`ExecPhases`. A backend with a
        ``pre_stage`` hook pads for itself (a lookups-axis model: indices
        to the lookup bucket, rows to ``max_batch_size``), and its outputs
        keep their rows.

        An input may be a tensor read from a device region: it is padded
        on its device and never goes through the host. With
        ``fetch_outputs=False`` (every output of the batch goes into a
        device region) the outputs stay on the device, untrimmed: the
        caller takes each request's rows as a slice, and the padding rows
        lie past every request's."""
        try:
            faults.fire("model.execute")
        except faults.FaultInjected as exc:
            raise EngineError(str(exc), exc.status or 503) from None
        cfg = self.config
        phases = ExecPhases(start=now_ns())
        pad_to = (self.pick_bucket(batch_size)
                  if cfg.axis_capacity() > 0 and batch_size is not None
                  else None)
        if self.backend.host_side:
            # Unpadded, never cold; its bucket is recorded as the JAX
            # package records a host-side model's.
            outputs, phases = self._execute_host(inputs, phases)
            self._record(phases, pad_to, batch_size)
            return outputs, phases
        pre_stage = getattr(self.backend, "pre_stage", None)
        if pre_stage is not None:
            inputs = pre_stage(inputs, pad_to)
        trim = pad_to is not None and pre_stage is None
        cuda = self.device.type == "cuda"
        with self._on_stream():
            staged = {}
            for name, arr in inputs.items():
                if isinstance(arr, torch.Tensor):
                    wait_for_writer(arr)
                    t = arr.to(self.device, non_blocking=True)
                    if trim and t.shape[0] < pad_to:
                        t = torch.cat([t, t.new_zeros(
                            (pad_to - t.shape[0],) + tuple(t.shape[1:]))])
                    staged[name] = t
                    continue
                if trim and arr.shape[0] < pad_to:
                    arr = np.pad(arr, [(0, pad_to - arr.shape[0])]
                                 + [(0, 0)] * (arr.ndim - 1))
                t = torch.from_numpy(arr if arr.flags.writeable
                                     else arr.copy())
                if cuda:
                    t = t.pin_memory().to(self.device, non_blocking=True)
                staged[name] = t
            phases.input_end = now_ns()
            first = self._first_execution(staged)
            if cuda:
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(self._stream())
            capture = CostCapture(self.backend) if first else None
            with torch.inference_mode(), \
                    capture or contextlib.nullcontext():
                outputs = self.backend(staged)
            if not isinstance(outputs, dict):
                raise EngineError(
                    f"model '{cfg.name}' returned {type(outputs)}, "
                    "expected dict", 500)
            if cuda:
                done = torch.cuda.Event(enable_timing=True)
                done.record(self._stream())
                done.synchronize()
            phases.infer_end = now_ns()
            phases.device_ns = (int(begin.elapsed_time(done) * 1e6) if cuda
                                else phases.infer_end - phases.input_end)
            if first:
                phases.compile_ns = phases.infer_end - phases.input_end
                self._record_first(phases, pad_to, capture, staged, outputs)
            if not fetch_outputs:
                phases.output_end = now_ns()
                self._record(phases, pad_to, batch_size)
                return outputs, phases
            host: dict[str, np.ndarray] = {}
            for name, val in outputs.items():
                arr = val.cpu().numpy()  # waits on this stream only
                if trim and arr.ndim >= 1 and arr.shape[0] == pad_to:
                    arr = arr[:batch_size]
                host[name] = arr
        phases.output_end = now_ns()
        self._record(phases, pad_to, batch_size)
        return host, phases

    def _first_execution(self, staged: dict) -> bool:
        """True the first time this input signature runs (and marks it
        seen): the execution is then cold, as a JAX bucket's first call
        compiles."""
        sig = tuple(sorted((name, tuple(t.shape), str(t.dtype))
                           for name, t in staged.items()))
        with self._seen_lock:
            if sig in self._seen:
                return False
            self._seen.add(sig)
            return True

    def _record_first(self, phases: ExecPhases, pad_to, capture,
                      staged: dict, outputs: dict) -> None:
        """A cold first execution: its duration as the bucket's compile,
        and the counted cost of the bucket."""
        cfg = self.config
        prof = profiler()
        prof.record_compile(cfg.name, cfg.version, pad_to, phases.compile_ns,
                            axis=cfg.padding_axis)
        io_bytes = sum(t.numel() * t.element_size()
                       for t in list(staged.values()) + list(outputs.values())
                       if isinstance(t, torch.Tensor))
        prof.record_cost_model(cfg.name, cfg.version, pad_to,
                               capture.result(io_bytes),
                               axis=cfg.padding_axis)

    def _record(self, phases: ExecPhases, pad_to, batch_size) -> None:
        """One profiler record per execution (not per request)."""
        cfg = self.config
        profiler().record_execution(
            cfg.name, cfg.version, pad_to,
            rows=batch_size if batch_size is not None else 1,
            device_ns=phases.device_ns,
            host_ns=(phases.input_end - phases.start)
            + (phases.output_end - phases.infer_end),
            cold=bool(phases.compile_ns), axis=cfg.padding_axis)

    def execute_stateful(self, state, inputs: dict[str, np.ndarray]):
        """One sequence step, the backend's ``step(state, staged_inputs)
        -> (state, outputs)``, on the worker's stream. The state stays on
        the device; the outputs come back as host arrays. Returns
        ``(new_state, outputs)``."""
        cuda = self.device.type == "cuda"
        with self._on_stream():
            staged = {}
            for name, arr in inputs.items():
                t = torch.from_numpy(arr if arr.flags.writeable
                                     else arr.copy())
                if cuda:
                    t = t.pin_memory().to(self.device, non_blocking=True)
                staged[name] = t
            with torch.inference_mode():
                new_state, outputs = self.backend.step(state, staged)
            if not isinstance(outputs, dict):
                raise EngineError(
                    f"model '{self.config.name}' returned {type(outputs)}, "
                    "expected dict", 500)
            host = {name: val.cpu().numpy() for name, val in outputs.items()}
        return new_state, host

    def _execute_host(self, inputs: dict[str, np.ndarray],
                      phases: ExecPhases
                      ) -> tuple[dict[str, np.ndarray], ExecPhases]:
        """A host-side backend's execution: numpy in, numpy out, no
        padding and no staging, so ``input_end`` is ``start``."""
        phases.input_end = phases.start
        outputs = self.backend(inputs)
        if not isinstance(outputs, dict):
            raise EngineError(
                f"model '{self.config.name}' returned {type(outputs)}, "
                "expected dict", 500)
        phases.infer_end = phases.output_end = now_ns()
        phases.device_ns = phases.infer_end - phases.input_end
        return outputs, phases
