"""Continuous (iteration-level) batching for generative models.

Counterpart of ``client_tpu/engine/generative.py``, with the same
behaviour: every decode step is shared by all live generation streams.

- One worker owns the KV arena (``backend.init_arena``; the +1 dummy row
  absorbs padded lanes), which is updated in place and carries each row's
  latest token on the device, so consecutive decode waves chain with no
  host round trip between them.
- **Prefill** admits a batch of prompts, grouped by prompt bucket and
  padded to one admit lane count, writes their K/V into their arena rows
  and emits each prompt's first token.
- **Decode waves** (padded to a power-of-two wave bucket) advance every
  live stream one token; ``CLIENT_TPU_GEN_CHUNK`` > 1 chains K waves per
  dispatch.
- **Pipelined dispatch**: prefills and waves are dispatched without
  waiting for their results. Each dispatch's tokens come back through a
  ``non_blocking`` copy into pinned memory and a recorded CUDA event; the
  worker consumes them in dispatch order when the event has fired, or
  blocks on the oldest once ``CLIENT_TPU_GEN_PIPELINE`` waves are in
  flight. Emission, stop tokens and retirement happen at fetch time;
  tokens generated past a stop are discarded.
- Streams are admitted whenever a row is free: a new request joins the
  next wave and never waits for a running stream to finish.

Every arena operation (prefill, waves, re-init after a failure) runs on
the worker's CUDA stream (``worker_stream``), but the first arena's
making, which the load does and the worker waits for. That stream's order
is what makes a row safe to reuse the moment its stream retires: work
already dispatched with the row runs before any later prefill into it. A
row-sharded arena (``kv_shards > 1``) keeps every shard on the scheduler's
card, so its per-shard work is ordered on that one stream too; the free
rows then skip each shard's junk row, and nothing here assumes that a row
is its lane's number.

Each decode dispatch is timed on the card between CUDA events recorded
around it on the worker's stream (on the CPU, the host time of the
synchronous call) and recorded at fetch time
(``EfficiencyProfiler.record_wave``); the first dispatch of each (wave
bucket, chunk) shape is counted for the roofline
(``record_wave_cost_model``), K2's arena reads, and K3's combine on a
sharded arena, included, and kept out of the device time as cold: the
counter slows its launches, and a shape's first use is slow anyway.

The arena is in the HBM census as the model's ``kv_arena`` (a provider
read at walk time, since a failed step rebuilds it; a sharded arena's
row sums its shards). The cost ledger gets each stream's queue wait at
admission, each decode dispatch's device time split evenly over its
live streams (component ``wave``, padded lanes to the dominant tenant,
a cold dispatch left out as the profiler leaves it), and each stream's
arena row-seconds when it releases its row.

Warm-up (:meth:`GenerativeScheduler.warmup`, run at load when the
engine warms its models): on the worker thread, between requests, one
greedy prefill per prompt bucket into the dummy row and one decode
dispatch per (wave bucket, chunk) shape, each of the latter counted for
the roofline as a first dispatch is; so no dispatch under traffic is
cold, and the kernels' first launches, cuBLAS's and the allocator's
blocks on the worker's stream are taken before any request.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import math
import os
import queue as _queue
import threading
import time

import numpy as np
import torch

from client_tpu_torch.config import env_int
from client_tpu_torch.engine.model import worker_stream
from client_tpu_torch.engine.scheduler import (
    _SHUTDOWN,
    Scheduler,
    _backpressured,
    power_buckets,
)
from client_tpu_torch.engine.types import (
    EngineError,
    InferRequest,
    InferResponse,
    now_ns,
)
from client_tpu_torch.observability.costs import ledger
from client_tpu_torch.observability.memory import (
    hbm_census,
    storage_bytes,
    tensor_leaves,
)
from client_tpu_torch.observability.profiler import profiler
from client_tpu_torch.observability.roofline import CostCapture
from client_tpu_torch.ops.decode_attention import stage

_log = logging.getLogger("client_tpu_torch")


class _Stream:
    __slots__ = ("req", "row", "disp_len", "disp_tokens", "f_len",
                 "emitted", "max_new", "seed", "temp", "top_k", "top_p",
                 "stop", "dead", "throttled_since")

    def __init__(self, req, row, plen, max_new,
                 seed=0, temp=0.0, top_k=0, top_p=1.0, stop=frozenset()):
        self.req = req
        self.row = row
        self.disp_len = plen      # context length at the next dispatch
        self.disp_tokens = 1      # tokens whose generation is dispatched
        self.f_len = plen         # fetch-side context length mirror
        self.emitted = 0
        self.max_new = max_new
        self.seed = seed          # per-request PRNG seed
        self.temp = temp          # 0 = greedy
        self.top_k = top_k        # 0 = off
        self.top_p = top_p        # 1.0 = off
        self.stop = stop          # token ids terminating the stream
        self.dead = False         # retired/cancelled (skip pending lanes)
        self.throttled_since = None  # monotonic mark while backpressured


class _Inflight:
    """One dispatched execution whose token fetch is pending."""

    __slots__ = ("kind", "streams", "tokens", "event", "waves", "staged",
                 "bucket", "timing", "cold")

    def __init__(self, kind, streams, tokens, event, staged, waves=1,
                 bucket=0, timing=None, cold=False):
        self.kind = kind          # 'prefill' | 'wave' | 'chunk'
        self.streams = streams    # lane order, real lanes only
        self.tokens = tokens      # host tensor the tokens are copied into
        self.event = event        # fires when the copy is done (None: CPU)
        # The dispatch's staged inputs, pinned host copies included: kept
        # referenced until the fetch, after which the stream has read them.
        self.staged = staged
        self.waves = waves        # logical waves this dispatch advances
        self.bucket = bucket      # wave lane bucket (0: a prefill)
        # A decode dispatch's (begin, end) CUDA events, or its host ns on
        # the CPU.
        self.timing = timing
        self.cold = cold          # a shape's first dispatch, run counted

    def device_ns(self) -> int:
        """The dispatch's device time; call once the fetch has landed."""
        if isinstance(self.timing, tuple):
            begin, end = self.timing
            return int(begin.elapsed_time(end) * 1e6)
        return int(self.timing or 0)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.tokens.numpy()


class _WarmupReq:
    """A queue item asking the worker to warm its shapes: the warm-up
    runs on the worker's thread and stream, between requests (from the
    caller's thread it would race the arena)."""

    def __init__(self):
        self.done = threading.Event()
        self.error: Exception | None = None


def _parse_sampling(req: InferRequest, vocab: int):
    """(seed, temp, top_k, top_p, stop_set) from request parameters.

    Defaults are greedy (temperature 0). ``stop_token_ids`` accepts an int
    or a comma-separated string (wire parameters are scalar); ``eos_id`` is
    its single-token alias."""
    p = req.parameters

    def num(key, default, cast, lo=None, hi=None):
        try:
            v = cast(p.get(key, default))
        except (TypeError, ValueError, OverflowError):
            # OverflowError: int(float('inf')) — json accepts Infinity.
            raise EngineError(
                f"{key} must be {cast.__name__}, got {p.get(key)!r}",
                400) from None
        if cast is float and not math.isfinite(v):
            # NaN passes every range comparison and would poison the
            # sampled logits.
            raise EngineError(f"{key} must be finite, got {v!r}", 400)
        if (lo is not None and v < lo) or (hi is not None and v > hi):
            raise EngineError(
                f"{key} must be in [{lo}, {hi}], got {v}", 400)
        return v

    # Unseeded sampling draws a fresh per-request seed: retries of the same
    # prompt get different samples. An explicit seed keeps full
    # determinism; batch invariance holds either way (fold_in(seed,
    # position) per lane).
    if "seed" in p:
        seed = num("seed", 0, int)
    else:
        seed = int.from_bytes(os.urandom(4), "little")
    temp = num("temperature", 0.0, float, lo=0.0)
    top_k = num("top_k", 0, int, lo=0)
    top_p = num("top_p", 1.0, float, lo=0.0, hi=1.0)
    if top_p == 0.0:
        raise EngineError("top_p must be in (0, 1]", 400)
    stop: set[int] = set()
    raw_stop = p.get("stop_token_ids", None)
    if raw_stop is None:
        raw_stop = p.get("eos_id", None)
    if raw_stop is not None:
        parts = (str(raw_stop).split(",")
                 if isinstance(raw_stop, str) else [raw_stop])
        for part in parts:
            try:
                tok = int(part)
            except (TypeError, ValueError):
                raise EngineError(
                    f"stop_token_ids must be ints, got {part!r}",
                    400) from None
            if not 0 <= tok < vocab:
                raise EngineError(
                    f"stop token {tok} outside vocab [0, {vocab})", 400)
            stop.add(tok)
    return seed, temp, top_k, top_p, frozenset(stop)


def _wave_io_bytes(bucket: int, tokens: torch.Tensor, *lane_arrays) -> int:
    """A decode dispatch's own inputs and outputs: rows and lens, the
    lanes' sampling parameters, and the tokens."""
    return 2 * bucket * 4 + tokens.numel() * tokens.element_size() \
        + sum(a.nbytes for a in lane_arrays)


def _census_arena(sched) -> list:
    """The census provider: the arena's tensors now. A plain function
    taking the scheduler, never a closure over it (the census holds the
    scheduler weakly)."""
    return tensor_leaves(sched._arena)


class GenerativeScheduler(Scheduler):
    """Arena-owned single worker; batching provides the parallelism."""

    single_instance = True
    # How long a stream may stay continuously transport-throttled before
    # its arena row is reclaimed (see the worker loop's flow control).
    BACKPRESSURE_TIMEOUT_S = 60.0

    def __init__(self, model, stats):
        backend = model.backend
        self._backend = backend
        self._device = model.device
        self._cuda = self._device.type == "cuda"
        self._cap = int(backend.max_streams)
        self._max_seq = int(backend.max_seq_len)
        free_rows, dummy = backend.arena_rows(self._cap)
        self._rows_init = [int(r) for r in free_rows]
        self._dummy = int(dummy)
        # The arena is made here, on the loading thread's stream, so that a
        # load which cannot hold it fails; the worker runs on its own
        # stream (``worker_stream``) once that work is done.
        self._arena = backend.init_arena(self._cap)
        hbm_census().register_provider(model.config.name, "kv_arena", self,
                                       _census_arena)
        # Arena bytes a row (usable rows + the dummy lane), for the cost
        # ledger's row-second charges; the arena's shapes are fixed.
        self._row_bytes = storage_bytes(tensor_leaves(self._arena)) / (
            len(self._rows_init) + 1)
        self._stream = self._loaded = None
        if self._cuda:
            self._loaded = torch.cuda.Event()
            self._loaded.record(torch.cuda.current_stream(self._device))
        # Chunked decode (CLIENT_TPU_GEN_CHUNK > 1): K waves per dispatch.
        # Tokens are still emitted per wave at fetch time; admits join at
        # chunk boundaries.
        self._chunk = max(1, env_int("CLIENT_TPU_GEN_CHUNK"))
        self._prompt_buckets = power_buckets(self._max_seq)
        self._wave_buckets = power_buckets(self._cap)
        # One admit lane count: every prefill chunk pads to it.
        self._admit_lane = min(self._cap, 8)
        # Dispatch-ahead bound, in waves, before the worker blocks on the
        # oldest fetch.
        self._depth = max(1, env_int("CLIENT_TPU_GEN_PIPELINE"))
        self._streams: list[_Stream] = []
        # (wave bucket, chunk) shapes whose first dispatch was counted.
        self._wave_cost_captured: set[tuple[int, int]] = set()
        self._inflight: collections.deque[_Inflight] = collections.deque()
        # Depth is counted in WAVES: a K-chunk counts K, so the knob bounds
        # the same amount of dispatched-ahead work in either mode.
        self._inflight_waves = 0
        self._free = list(self._rows_init)
        super().__init__(model, stats)

    def arena_shards(self) -> int:
        """KV arena shard count (1 = one device): how many ways the
        backend splits the arena's rows (``kv_shards``)."""
        return int(getattr(self._backend, "kv_shards", 1) or 1)

    def arena_nbytes(self) -> int:
        """The KV arena's bytes, every shard's: the autotuner's planning
        arena reserves them (one card's share) against the budget, so
        the tuner's promotions plan around them."""
        return int(storage_bytes(tensor_leaves(self._arena)))

    def _on_stream(self):
        """The context every arena operation runs in: this scheduler's
        CUDA stream on the card, nothing on the CPU."""
        return (torch.cuda.stream(self._stream) if self._cuda
                else contextlib.nullcontext())

    # -- warm-up --------------------------------------------------------------

    def warmup(self) -> None:
        """Warm every prompt bucket's prefill and every (wave bucket,
        chunk) decode shape on the worker (see the module docstring);
        raises when the worker failed it, or stays busy for 600 s."""
        req = _WarmupReq()
        self.queue.put(req)
        if not req.done.wait(600):
            raise EngineError(
                "generative warmup timed out (worker busy for 600s)", 500)
        if req.error is not None:
            raise EngineError(f"generative warmup failed: {req.error}", 500)

    def _run_warmup(self, req: _WarmupReq) -> None:
        try:
            self._precompile()
        except Exception as exc:  # noqa: BLE001 — the caller raises it
            req.error = exc
        finally:
            req.done.set()

    def _precompile(self) -> None:
        lane = self._admit_lane
        zeros_i = np.zeros(lane, np.int32)
        lanes = self._backend.lane_params(
            zeros_i, np.zeros(lane, np.float32), zeros_i,
            np.ones(lane, np.float32))
        rows = [self._dummy] * lane
        for pb in self._prompt_buckets:
            index = self._backend.wave_index(self._arena, rows,
                                             np.ones(lane, np.int32))
            _pinned, ids_dev = stage(np.zeros((lane, pb), np.int32),
                                     self._device)
            self._backend.prefill(self._arena, index, ids_dev, lanes, False)
        for wb in self._wave_buckets:
            for k in sorted({1, self._chunk}):
                if (wb, k) not in self._wave_cost_captured:
                    self._warm_wave(wb, k)
        if self._cuda:
            self._stream.synchronize()

    def _warm_wave(self, bucket: int, k: int) -> None:
        """One greedy decode dispatch of ``bucket`` dummy lanes and ``k``
        chained waves, counted for the roofline as a shape's first
        dispatch is, and kept out of the wave statistics."""
        zeros_i = np.zeros(bucket, np.int32)
        temps = np.zeros(bucket, np.float32)
        top_ps = np.ones(bucket, np.float32)
        index = self._backend.wave_index(
            self._arena, [self._dummy] * bucket, [0] * bucket)
        lanes = self._backend.lane_params(zeros_i, temps, zeros_i, top_ps)
        self._wave_cost_captured.add((bucket, k))
        capture = CostCapture(self._backend)
        with capture:
            if k > 1:
                nxt = self._backend.decode_chunk(self._arena, index, lanes,
                                                 False, k)
            else:
                nxt = self._backend.decode(self._arena, index, lanes, False)
        profiler().record_wave_cost_model(
            self.model.config.name, self.model.config.version, bucket, k,
            capture.result(_wave_io_bytes(bucket, nxt, zeros_i, temps,
                                          zeros_i, top_ps)))

    # -- worker ---------------------------------------------------------------

    def _get(self, timeout: float | None = None):
        return self.queue.get_many(1, timeout=timeout)[0]

    def _worker_loop(self) -> None:
        if self._cuda:
            self._stream = worker_stream(self._device)
            self._stream.wait_event(self._loaded)
        try:
            with self._on_stream():
                self._run()
        finally:
            if self._cuda:
                # The first arena's blocks go back to the loading thread's
                # stream when they are freed: this stream must be done.
                self._stream.synchronize()

    def _run(self) -> None:
        while True:
            if self._stopping:
                # Unloaded (or shut down) with streams open: end each with
                # an error now, not after its last token.
                self._abort_streams("server shutting down")
                return
            pending = []
            shutdown = False
            # Blocking admit only when fully idle; otherwise opportunistic:
            # a new request joins the next wave.
            if not self._streams and not self._inflight:
                item = self._get()
                if item is _SHUTDOWN:
                    return
                if isinstance(item, _WarmupReq):
                    self._run_warmup(item)
                    continue
                pending.append(item)
            while len(self._free) > len(pending):
                try:
                    item = self._get(timeout=0)
                except _queue.Empty:
                    break
                if item is _SHUTDOWN:
                    shutdown = True
                    break
                if isinstance(item, _WarmupReq):
                    self._run_warmup(item)
                    continue
                pending.append(item)
            if pending:
                try:
                    self._admit_batch(pending)
                except Exception as exc:  # noqa: BLE001 — sole worker: an
                    # escape would kill it and hang the model for good.
                    self._reset_arena(exc)
            if shutdown:
                self._abort_streams("server shutting down")
                return
            # Client-abandoned streams stop taking decode slots at the next
            # wave boundary (frontends set `cancelled` on disconnect).
            for s in list(self._streams):
                if s.req.cancelled:
                    self._drop(s)
                    self._fail(s.req, EngineError("request cancelled", 499))
            # Transport flow control: a stream whose frontend reports a
            # backlog sits out this wave and rejoins once the writer
            # drains; one throttled continuously past the timeout holds a
            # row for a consumer that stopped reading, and is dropped.
            live = []
            now_mono = time.monotonic()
            for s in list(self._streams):
                if not self._has_budget(s):
                    continue
                if _backpressured(s.req):
                    if s.throttled_since is None:
                        s.throttled_since = now_mono
                    elif (now_mono - s.throttled_since
                          > self.BACKPRESSURE_TIMEOUT_S):
                        self._drop(s)
                        self._fail(s.req, EngineError(
                            "request cancelled (stream backpressured "
                            f"beyond {self.BACKPRESSURE_TIMEOUT_S:.0f}s)",
                            499))
                    continue
                s.throttled_since = None
                live.append(s)
            if live:
                try:
                    self._dispatch_wave(live)
                except Exception as exc:  # noqa: BLE001
                    self._reset_arena(exc)
            # Consume fetches: non-blocking while results are ready or the
            # pipeline is over depth; forced (blocking on the oldest) when
            # nothing was dispatched, so the loop always makes progress.
            self._drain_fetches(force_one=not live and not pending)
            if (not live and not pending and not self._inflight
                    and self._streams):
                # Every stream is throttled: park briefly on a timed queue
                # poll, so a shutdown is not starved for the whole
                # backpressure timeout.
                try:
                    item = self._get(timeout=0.001)
                except _queue.Empty:
                    continue
                if item is _SHUTDOWN:
                    self._abort_streams("server shutting down")
                    return
                if isinstance(item, _WarmupReq):
                    self._run_warmup(item)
                    continue
                # A new admit while every stream is throttled: back to the
                # front (no reordering); the loop-top admit takes it as
                # soon as a row is free.
                self.queue.put_front(item)
                time.sleep(0.001)

    def _has_budget(self, s: _Stream) -> bool:
        return (not s.dead and s.disp_tokens < s.max_new
                and s.disp_len + 1 < self._max_seq)

    def _validate(self, req: InferRequest):
        """Parse and validate one admit; returns (ids, max_new,
        sampling)."""
        ids = np.ravel(np.asarray(req.inputs["INPUT_IDS"])).astype(np.int32)
        try:
            max_new = int(req.parameters.get(
                "max_tokens", self._backend.default_max_tokens))
        except (TypeError, ValueError, OverflowError):
            raise EngineError(
                f"max_tokens must be an integer, got "
                f"{req.parameters.get('max_tokens')!r}", 400) from None
        if max_new < 1:
            raise EngineError("max_tokens must be >= 1", 400)
        if len(ids) < 1:
            raise EngineError("INPUT_IDS must contain at least one id", 400)
        if len(ids) + max_new > self._max_seq:
            raise EngineError(
                f"prompt ({len(ids)}) + max_tokens ({max_new}) exceeds "
                f"max_seq_len ({self._max_seq})", 400)
        vocab = self._backend.vocab
        if (ids < 0).any() or (ids >= vocab).any():
            raise EngineError(f"token ids must be in [0, {vocab})", 400)
        return ids, max_new, _parse_sampling(req, vocab)

    def _admit_batch(self, items: list) -> None:
        """Validate, group by prompt bucket, one batched prefill per chunk
        of at most one admit lane count; prefills are dispatched without
        waiting (their tokens are fetched asynchronously)."""
        ready = []  # (req, ids, max_new, sampling)
        for req in items:
            if self._check_timeout(req) or self._check_cancelled(req):
                continue
            try:
                ids, max_new, sampling = self._validate(req)
            except EngineError as exc:
                self._fail(req, exc)
                continue
            except Exception as exc:  # noqa: BLE001 — a malformed request
                # fails alone, not the admit batch (let alone the worker).
                self._fail(req, EngineError(f"invalid request: {exc}", 400))
                continue
            req.times.compute_start = now_ns()
            ledger().charge_queue(
                self.model.config.name, str(self.model.config.version),
                req.tenant, req.times.queue_ns / 1e9,
                trace_id=self._trace_id(req))
            ready.append((req, ids, max_new, sampling))
        by_bucket: dict[int, list] = {}
        for entry in ready:
            bucket = next(b for b in self._prompt_buckets
                          if b >= len(entry[1]))
            by_bucket.setdefault(bucket, []).append(entry)
        chunks = []
        for bucket, entries in sorted(by_bucket.items()):
            cap = self._admit_lane
            chunks += [(bucket, entries[i:i + cap])
                       for i in range(0, len(entries), cap)]
        for ci, (bucket, chunk) in enumerate(chunks):
            try:
                self._prefill_chunk(bucket, chunk)
            except EngineError as exc:
                for req, *_ in chunk:
                    self._fail(req, exc)
            except Exception as exc:  # noqa: BLE001
                # The arena may be half written: everything queued behind
                # this chunk fails too while the arena is rebuilt.
                for _, later in chunks[ci + 1:]:
                    for req, *_ in later:
                        self._fail(req, EngineError(
                            f"generation aborted: {exc}", 500))
                for req, *_ in chunk[1:]:
                    self._fail(req, EngineError(
                        f"generation aborted: {exc}", 500))
                self._reset_arena(exc, failing=chunk[0][0])
                return

    def _start_fetch(self, tokens: torch.Tensor):
        """Start the token copy to the host; returns (host tensor, event)."""
        if not self._cuda:
            return tokens, None
        host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
        host.copy_(tokens, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return host, event

    def _prefill_chunk(self, prompt_bucket: int, chunk: list) -> None:
        """One batched prefill dispatch: B admits, one pass on the device,
        no host sync (the first tokens arrive through the fetch queue)."""
        n = len(chunk)
        lane = self._admit_lane
        pad = lane - n
        rows = [self._free.pop() for _ in range(n)]
        try:
            ids_mat = np.zeros((lane, prompt_bucket), np.int32)
            lens = np.ones(lane, np.int32)
            seeds = np.zeros(lane, np.uint32)
            temps = np.zeros(lane, np.float32)
            top_ks = np.zeros(lane, np.int32)
            top_ps = np.ones(lane, np.float32)
            for i, (req, ids, max_new, (seed, temp, top_k, top_p,
                                        stop)) in enumerate(chunk):
                ids_mat[i, :len(ids)] = ids
                lens[i] = len(ids)
                seeds[i] = seed & 0xFFFFFFFF
                temps[i] = temp
                top_ks[i] = top_k
                top_ps[i] = top_p
            index = self._backend.wave_index(
                self._arena, rows + [self._dummy] * pad, lens)
            lanes = self._backend.lane_params(seeds.astype(np.int32), temps,
                                              top_ks, top_ps)
            ids_pinned, ids_dev = stage(ids_mat, self._device)
            tokens = self._backend.prefill(self._arena, index, ids_dev, lanes,
                                           bool((temps > 0.0).any()))
            host, event = self._start_fetch(tokens)
        except Exception:
            self._free.extend(rows)
            raise
        streams = []
        for i, (req, ids, max_new, (seed, temp, top_k, top_p,
                                    stop)) in enumerate(chunk):
            stream = _Stream(req, rows[i], len(ids), max_new,
                             seed=seed, temp=temp, top_k=top_k, top_p=top_p,
                             stop=stop)
            streams.append(stream)
            self._streams.append(stream)
        # Executions are counted at dispatch: fetch-time counting would
        # miss dispatches whose lanes all retired before the fetch.
        self.stats.record_execution(n)
        self._inflight.append(_Inflight("prefill", streams, host, event,
                                        (index, lanes, ids_pinned)))
        self._inflight_waves += 1

    def _dispatch_wave(self, live: list) -> None:
        """Dispatch decode wave(s) for the live lanes, split into several
        when they exceed the largest wave bucket."""
        max_bucket = self._wave_buckets[-1]
        for i in range(0, len(live), max_bucket):
            self._dispatch_one_wave(live[i:i + max_bucket])

    def _dispatch_one_wave(self, live: list) -> None:
        """Dispatch one decode wave; the input tokens come from the
        arena's token slots on the device, so no host value is needed."""
        bucket = next(b for b in self._wave_buckets if b >= len(live))
        pad = bucket - len(live)
        rows = [s.row for s in live] + [self._dummy] * pad
        lens = [s.disp_len for s in live] + [0] * pad
        seeds = np.asarray([s.seed & 0xFFFFFFFF for s in live] + [0] * pad,
                           np.uint32).astype(np.int32)
        temps = np.asarray([s.temp for s in live] + [0.0] * pad, np.float32)
        top_ks = np.asarray([s.top_k for s in live] + [0] * pad, np.int32)
        top_ps = np.asarray([s.top_p for s in live] + [1.0] * pad,
                            np.float32)
        # Chunk only when every live lane has K steps of sequence headroom
        # (a step past max_seq has no slot to write) and wants >= K more
        # tokens (overshoot is discarded at fetch, but wasted).
        k = self._chunk
        if k > 1 and not all(
                s.disp_len + k < self._max_seq
                and s.max_new - s.disp_tokens >= k for s in live):
            k = 1
        sample = bool((temps > 0.0).any())
        index = self._backend.wave_index(self._arena, rows, lens)
        lanes = self._backend.lane_params(seeds, temps, top_ks, top_ps)
        capture = None
        if (bucket, k) not in self._wave_cost_captured:
            self._wave_cost_captured.add((bucket, k))
            capture = CostCapture(self._backend)
        if self._cuda:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(self._stream)
        t0 = time.monotonic_ns()
        with capture or contextlib.nullcontext():
            if k > 1:
                nxt = self._backend.decode_chunk(self._arena, index, lanes,
                                                 sample, k)
            else:
                nxt = self._backend.decode(self._arena, index, lanes, sample)
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            timing = (begin, end)
        else:
            timing = time.monotonic_ns() - t0  # the call ran synchronously
        if capture is not None:
            profiler().record_wave_cost_model(
                self.model.config.name, self.model.config.version, bucket,
                k, capture.result(_wave_io_bytes(bucket, nxt, seeds, temps,
                                                 top_ks, top_ps)))
        host, event = self._start_fetch(nxt)
        for s in live:
            s.disp_len += k
            s.disp_tokens += k
        # One dispatch is one execution in the public stats, chunked or
        # not: fewer executions per token is what chunking buys.
        self.stats.record_execution(len(live))
        self._inflight.append(_Inflight("chunk" if k > 1 else "wave", live,
                                        host, event, (index, lanes),
                                        waves=k, bucket=bucket,
                                        timing=timing,
                                        cold=capture is not None))
        self._inflight_waves += k

    def _drain_fetches(self, force_one: bool = False) -> None:
        """Consume completed token fetches in dispatch order; emission,
        stop-token checks and retirement happen here, a few waves behind
        dispatch."""
        while self._inflight:
            head = self._inflight[0]
            if not (force_one or self._inflight_waves > self._depth
                    or head.ready()):
                return
            force_one = False
            self._inflight.popleft()
            self._inflight_waves -= head.waves
            try:
                toks = head.result()
            except Exception as exc:  # noqa: BLE001 — the execution failed
                self._reset_arena(exc)
                return
            if head.kind != "prefill":
                busy_ns = head.device_ns()
                profiler().record_wave(
                    self.model.config.name, self.model.config.version,
                    bucket=head.bucket, chunk=head.waves,
                    duration_ns=busy_ns, waves=head.waves,
                    cold=head.cold)
                # The dispatch's device time splits evenly over its live
                # lanes (each advances one token whatever its context);
                # a wave whose every lane retired in flight bills the
                # streams it was dispatched for, so every recorded wave is
                # charged.
                live = [s for s in head.streams if not s.dead] \
                    or list(head.streams)
                if live and not head.cold:
                    ledger().charge_batch(
                        self.model.config.name,
                        str(self.model.config.version),
                        [(s.req.tenant, 1, None) for s in live],
                        busy_ns / 1e9,
                        padded=max(0, head.bucket - len(live)),
                        component="wave")
            # A chunked fetch is K stacked waves [K, B]; emit them in wave
            # order so a stop or the budget retires a stream mid-chunk
            # exactly where per-wave dispatch would have.
            waves = toks if head.kind == "chunk" else toks[None]
            for kk in range(waves.shape[0]):
                for i, s in enumerate(head.streams):
                    if s.dead:
                        continue  # retired or cancelled: discard junk
                    tok = int(waves[kk, i])
                    if head.kind != "prefill":
                        s.f_len += 1
                    if tok in s.stop:
                        # Stop tokens end the stream without being emitted.
                        self._retire(s)
                        continue
                    self._emit_token(s, tok)
                    if (s.emitted >= s.max_new
                            or s.f_len + 1 >= self._max_seq):
                        self._retire(s)

    # -- stream lifecycle -----------------------------------------------------

    def _response(self, s: _Stream, outputs: dict, final: bool
                  ) -> InferResponse:
        return InferResponse(
            model_name=s.req.model_name,
            model_version=(s.req.model_version
                           or str(self.model.config.version)),
            request_id=s.req.request_id, outputs=outputs,
            parameters={"triton_final_response": final}, final=final,
            times=s.req.times)

    def _emit_token(self, s: _Stream, token: int) -> None:
        self._respond(s.req, self._response(
            s, {"TOKEN": np.array([token], np.int32),
                "INDEX": np.array([s.emitted], np.uint32)}, final=False))
        s.emitted += 1

    def _drop(self, s: _Stream) -> None:
        """Remove from the active set and release the row. The row is safe
        to reuse at once: executions already dispatched with it run before
        any later prefill into it (one CUDA stream, dispatch order), and
        their lanes are discarded at fetch."""
        s.dead = True
        if s in self._streams:
            self._streams.remove(s)
        self._free.append(s.row)
        # The row's residency: held from admission until now.
        held_ns = now_ns() - s.req.times.compute_start
        if held_ns > 0 and s.req.times.compute_start:
            ledger().charge_hbm(
                self.model.config.name, str(self.model.config.version),
                s.req.tenant, held_ns / 1e9 * self._row_bytes,
                trace_id=self._trace_id(s.req))

    def _retire(self, s: _Stream) -> None:
        self._drop(s)
        s.req.times.compute_input_end = s.req.times.compute_start
        s.req.times.compute_infer_end = now_ns()
        s.req.times.compute_output_end = s.req.times.compute_infer_end
        self.stats.record_request(s.req.times, success=True,
                                  trace_id=self._trace_id(s.req),
                                  tenant=s.req.tenant)
        self._respond(s.req, self._response(s, {}, final=True))

    def _all_tracked_streams(self) -> list:
        """Active streams plus any referenced only by in-flight fetches."""
        seen: dict[int, _Stream] = {id(s): s for s in self._streams}
        for inf in self._inflight:
            for s in inf.streams:
                if not s.dead:
                    seen.setdefault(id(s), s)
        return list(seen.values())

    def _clear(self) -> None:
        self._streams.clear()
        self._inflight.clear()
        self._inflight_waves = 0
        self._free = list(self._rows_init)

    def _abort_streams(self, why: str) -> None:
        for s in self._all_tracked_streams():
            s.dead = True
            self._fail(s.req, EngineError(why, 503))
        self._clear()

    def _release(self) -> None:
        self._clear()
        self._arena = None

    def _reset_arena(self, exc: Exception, failing=None) -> None:
        """A failed step may have left the arena half written, and every
        execution behind it with it: rebuild the arena and fail every live
        stream."""
        _log.exception(
            "model '%s': generative step failed; resetting KV arena "
            "(%d live streams dropped)", self.model.config.name,
            len(self._streams), exc_info=exc)
        if failing is not None:
            self._fail(failing, exc)
        for s in self._all_tracked_streams():
            s.dead = True
            self._fail(s.req, EngineError(f"generation aborted: {exc}", 500))
        self._clear()
        if self._cuda:
            self._stream.synchronize()  # as at the worker's end
        self._arena = self._backend.init_arena(self._cap)
