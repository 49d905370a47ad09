#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card
    python3 chip_smoke.py --kernels  # steps 1 to 3 and the wave split only

1. Prints the card (``torch.cuda.get_device_name``) and its power limit.
2. Builds every kernel of the path from ``client_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
   Counts the flash-attention kernels' instructions (``cuobjdump -sass``)
   and fails unless the bf16 kernel runs on wgmma fed by TMA and the fp32
   one on TF32 mma.sync.
3. Kernel phases: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, plus its edge cases, with the
   tolerance stated below; then time kernel, plain version and the one
   PyTorch call that computes the same function (flash attention: kernel
   and call in turns, and the call's own kernels named from one
   ``torch.profiler`` pass), and work out the least time the card could
   take (the bound). The kernels: flash attention in bf16 (BERT) and in
   fp32 causal (the generative prefill), the fused decode wave (its split
   and tile edges, repeated calls bit for bit), and the ring all-reduce of
   the row-sharded KV arena (2 to 8 shards on the one card, bit for bit
   against its plain version) and of DLRM's pooled bags ([832, 128], 2
   and 4 shards). The decode wave and the all-reduce are a
   few microseconds of device work behind tens of host work, so their
   device time is taken with calls queued back to back behind a sleeping
   kernel, in turns with the library call, and the decode wave cycles
   over the 4 layers as a decode step does; a call alone, host included,
   is printed beside it. Each prints its launch plan and the registers
   and shared memory of its build (``cuobjdump -res-usage``).
4. Serve phase: starts ``client_tpu_torch``'s HTTP server with ``bert_base``
   and ``bert_long`` on the card (full BERT-base width and depth, random
   weights from a fixed seed), sets every kernel's launch count to 0, sends
   concurrent v2 requests (JSON and binary tensors) so dynamic batching
   forms batches, and checks status, shapes, finite values, agreement with
   the same module run directly with its attention swapped for the plain
   version, that each ``bert_long`` batch launched the flash kernel once per
   layer, and the 404 / 400 error paths. Then every other request again
   over gRPC ``ModelInfer`` on the same engine (a ``GrpcInferenceServer``),
   raw and typed ``int_contents``, held as the HTTP answers are; the flash
   kernel's count must rise by one per layer for each gRPC ``bert_long``
   batch; NOT_FOUND and INVALID_ARGUMENT for an unknown model and a
   wrong shape.
5. Generate phase: an engine and HTTP server with ``tiny_gpt`` and
   ``tiny_gpt_long`` at their registered sizes (decode waves through the
   fused kernel, ``tiny_gpt_long``'s prefill through the fp32 flash kernel),
   one short warm-up round, then launch counts set to 0 and concurrent
   ``/generate_stream`` requests over several prompt buckets, greedy and
   seeded sampled. Every stream must
   equal, token for token, the same model run directly on the card one
   stream at a time on the plain path (einsum prefill, reference decode);
   the launch counts must show the kernels ran; ``/generate`` must match
   the stream; the 400s and a stop token are checked. The same 20 streams
   then go over gRPC ``ModelStreamInfer`` on the same engine (5 RPCs side
   by side, 4 requests multiplexed on each, every third with
   ``response_coalesce``), every token against the plain path, and the
   counts must rise. Wall time, tokens/s and the median inter-token gap
   are printed, not claimed, and so is one observation line: the same 8
   greedy streams over SSE and over gRPC, with and without
   ``response_coalesce``, their median inter-token gap, messages and
   tokens/s.
6. Sharded generate phase: ``tiny_gpt_long`` at its registered size with
   its KV arena split by rows over 2 shards on the card (``kv_shards=2``),
   served over HTTP as ``tiny_gpt_long_kv2``; launch counts set to 0, then
   8 concurrent ``/generate_stream`` streams of 32 tokens (prompts of 3 to
   1,500 tokens, two sampled). Every stream must equal the same prompt run
   directly on the plain unsharded path; every decode step must have
   launched the ring all-reduce once per layer and the decode kernel once
   per layer and shard. Then 4 of the streams over gRPC (2 RPCs of 2),
   with the same checks.
7. Vision phase: ``resnet50``, ``densenet_onnx``,
   ``ssd_mobilenet_v2_coco_quantized``, ``ssd_mobilenet_v2_tpu``,
   ``image_preprocess``, ``ensemble_image``, ``bert_preprocess``,
   ``bert_base``, ``bert_postprocess`` and ``ensemble_bert`` (10 models)
   at their registered full size, random weights from the
   port's seeds, and the four ``simple`` models, served over HTTP and
   gRPC from one engine; 98 concurrent HTTP requests, JSON and
   binary, two of them asking ``resnet50`` for ``classification: 3``,
   built and parsed by the phase's own wire code, not the server's.
   Checks every status, shape and dtype; that dynamic batching put more
   than one request in an execution of ``resnet50`` and of
   ``ssd_mobilenet_v2_tpu``; every SSD output bit for bit against the
   same module run directly on the request's rows at a bucket of its
   ladder; classifier logits within ``CLASSIFIER_RTOL`` (exactness
   printed); the classification strings against the direct top 3; each
   ensemble bit for bit against its steps run by hand; the 400 for a
   shared-memory output. Over gRPC, one request at a time, each answer
   against the same request's HTTP answer: the ``simple`` models byte for
   byte (and against numpy), raw and typed, ``resnet50``'s classification
   strings, ``ensemble_image`` and ``ensemble_bert``; INVALID_ARGUMENT for
   an input that names a shared-memory region. Then prints each model's device time for one
   forward at its largest bucket (queued behind a sleeping kernel, so the
   card never waits on the host), images/s and the share of the bf16 peak
   from it, the wall time of one forward with the card waiting on the
   host's launches, and the
   batched NMS alone at B=16 (host, device, launches). No hand-written
   kernel runs on this path: convolutions and matmuls are cuDNN's and
   cuBLAS's.
8. Stateful phase: one engine behind HTTP and gRPC with ``dlrm``,
   ``dlrm_cached``, ``simple_sequence``, ``simple_sequence_oldest``,
   ``simple_repeat`` at their registered sizes and an MLPerf-shaped DLRM
   (``MLPERF_DLRM``: 26 tables of 65,536 rows x 128, 2 shards on the one
   card combined by the ring all-reduce). Launch counts set to 0, then 96
   concurrent one-row CSR requests (Zipf ids, bags of 1 to 4) over HTTP,
   JSON and binary, and gRPC: the ragged scheduler must batch them, the
   ring all-reduce must launch once per execution, every score must equal
   the request run alone (``DLRM_ATOL``; exactness printed). Then sharded
   against unsharded bag sums bit for bit, ``dlrm`` against its direct run
   and ``dlrm_cached`` (hit rate above 0), the 400s of malformed CSR on
   both transports, and an observation: requests/s and p50/p99 at
   concurrency 32, rows and lookups per execution, the /stats split, and
   one execution's device time at the 4,096-lookup bucket. 64 sequences of
   8 steps on each sequence model (half over HTTP, half on gRPC streams),
   every running sum exact, the oldest strategy's waves wider than one;
   a restart; the 400s; ``simple_repeat`` over SSE and ``ModelStreamInfer``.
9. Shm phase: one engine behind HTTP and gRPC with ``simple``,
   ``simple_string``, ``bert_base``, ``bert_long`` and ``resnet50`` at
   full size, K1's count set to 0. Over the system plane (regions by shm
   key) and the device planes (host-staged regions by handle, on the
   ``cudasharedmemory`` and ``tpusharedmemory`` routes and the ``Cuda*``
   and ``Tpu*`` RPCs), on both frontends: a ``simple``,
   ``simple_string`` (BYTES), ``bert_long`` and ``resnet50`` request
   with its inputs and outputs in a region, every output bit for bit
   against the same request sent inline as binary; status,
   unregister-one and unregister-all; 400 / INVALID_ARGUMENT for an
   unregistered region, a double register and an offset past the region.
   The segments are made and read by the script's own ``mmap`` code and
   handle JSON, not the port's. Then regions made with the port's client
   utilities, served and read back; then, in process, 4 ``bert_long``
   and 16 ``resnet50`` requests at once on device regions of tensors on
   the card with ``keep_outputs_on_device``: every output bit for bit
   against the same rows through the host path at the bucket its batch
   used, each region sharing its batch's output storage, no ``Memcpy
   HtoD`` or ``DtoH`` in a ``torch.profiler`` window around them, K1
   launched 12 times a ``bert_long`` batch; a region filled on a side
   stream just before its request; and one observation line
   (``resnet50``, 64 one-image requests at concurrency 16 over binary
   HTTP, system shm over HTTP and host-staged regions over gRPC:
   requests/s, p50, bytes on the wire and ``compute_input`` a request;
   ``bert_long`` in process on device regions against host arrays).
10. Clients phase: one engine behind HTTP and gRPC with ``bert_base``,
   ``bert_long``, ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards, K3) and
   ``simple``; every launch count set to 0, then a child process (this
   script with ``--clients-child``) drives them through the port's own
   clients, ``client_tpu_torch.http`` and ``client_tpu_torch.grpc``, and
   must load no torch, jax or ``client_tpu`` module: health, metadata and
   config of every model on both; 4 ``bert_long`` requests one at a time
   and 8 at once over HTTP, 4 over gRPC; 8 greedy ``tiny_gpt_long``
   streams of 32 tokens on one gRPC stream; 16 one-row ``dlrm_mlperf``
   requests over HTTP, every other one with its inputs in system shm; a
   bad model version on each frontend. The counts are read when the child
   exits and each kernel's must have risen (K1 bf16 12 a ``bert_long``
   batch, K3 one a ``dlrm_mlperf`` execution). Then the script holds the
   answers: one at a time bit for bit against the same requests built by
   its own wire code, the 8 at once within ``KERNEL_ATOL``, the streams
   token for token against the plain path, DLRM bit for bit, the
   reference's 400 words. An observation line: ``bert_base``, 64
   requests at concurrency 16 from the child (requests/s, p50, p99, the
   client's ``InferStat`` against the server's ``/stats`` split).
11. Repository phase: a directory repository written for the phase
   (removed at the end): ``config.json`` files from the zoo's configs for
   ``bert_long`` (``version_policy: all``, versions 1 and 2),
   ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards, K3), ``dlrm_cached``,
   ``ensemble_bert`` with its steps and ``ensemble_bert_logits`` (its
   first two steps), and a copy of ``models/``, served at full size by
   one engine behind HTTP and gRPC, every launch count set to 0. Both
   ``bert_long`` versions over ``/versions/<v>`` and gRPC, bit for bit
   alike and within ``SERVED_ATOL`` of the plain path (K1 bf16 once a
   layer a batch; the serve phase's tolerance for the same comparison, a
   whole 12-layer forward against the module with plain attention); an
   unload over HTTP (400 "not ready", and the raw
   ``torch.cuda.memory_allocated`` falls by at least ``REPO_FREED`` of
   both versions' parameter and buffer bytes), a load over gRPC, a
   ``3/`` under ``latest`` 2 (version 2 kept, 3 served, 1 a 404), then
   ``REPO_CYCLES`` unload/load cycles whose raw memory, cuBLAS's
   workspaces included, may grow at most ``REPO_LEAK``.
   ``tiny_gpt_long`` unloaded with ``REPO_STREAMS``
   streams open (each ends with an error within
   ``REPO_STREAM_WAIT_S``), reloaded, 8 greedy streams token for token
   against the plain path (K1 fp32, K2); ``dlrm_mlperf`` reloaded bit for
   bit, K3 once an execution, and the reloaded model's sharded bag sums
   (K3) bit for bit the unsharded table's; ``dlrm_cached``'s row cache
   emptied by a
   reload; ``ensemble_bert`` unloaded with ``unload_dependents`` (its own
   step goes, the two it shares stay); the SSDs; the index equal on the
   engine, HTTP and gRPC. Memory readings are printed beside the card's
   name and power limit.
12. Observability phase: one engine behind HTTP and gRPC with
   ``bert_long``, ``tiny_gpt_long`` and ``dlrm_mlperf`` (2 shards, K3),
   every launch count set to 0 just before the traffic. ``/metrics`` is
   scraped in both formats (0.0.4 and OpenMetrics) before and after:
   ``tpu_inference_request_success``, ``tpu_inference_exec_count`` and
   the ``tpu_batch_size`` count rise by what was sent and executed, and
   each kernel's launches equal its launches per execution times the
   executions read there (K1 bf16 12 a ``bert_long`` batch; K1 fp32 4 a
   prefill chunk and K2 4 a decode wave, the waves from ``/v2/profile``;
   K3 one a ``dlrm_mlperf`` execution). ``bert_long`` one request at a
   time with a ``traceparent`` over HTTP and gRPC (as a parameter and as
   metadata): the trace id comes back, and the request's spans from
   ``/v2/trace/requests`` agree with its ``Server-Timing`` (or
   ``server_*_us``) within ``OBS_TIMING_MS``. ``model.execute`` armed at
   probability 0.5, seed ``OBS_FAULT_SEED``, over ``OBS_FAULTED``
   requests: the failures are the seed's ``random.Random`` draws,
   counted on ``tpu_fault_injections_total`` and in ``/v2/events``; one
   ``http.pre_read`` drop and one ``grpc.pre_infer`` error; disarmed,
   ``bert_long`` within ``SERVED_ATOL`` of the plain path.
   ``/v2/profile``: each bucket used with its executions, rows, one cold
   first execution and a counted roofline, every MFU and MBU in (0,
   ``OBS_SHARE_MAX``]; ``bert_long``'s bucket 1 FLOPs counted on the card
   within ``OBS_FLOPS_RTOL`` of the same bucket counted on the CPU plain
   path; the decode waves' bytes above the model's parameter bytes (K2's
   arena reads). One ``observability observation:`` JSON line with the
   table, the peaks and ``tpu_device_duty_cycle``.
13. Weights phase: checkpoints written by the port's ``save_params`` from
   in-process twins on the card (``bert_long`` v1 seeded and v2 with
   layer 0's ``w1`` halved, ``bert_base`` with its pooler halved,
   ``tiny_gpt_long`` with layer 0's ``w1`` halved, served again as
   ``tiny_gpt_long_kv2`` over 2 shards), and the JAX-written fixture
   ``tests/torch_data/jax_gpt_ckpt`` (orbax's zstd frames), served from a
   directory repository (``<v>/weights`` and ``weights_path``) by one
   engine behind HTTP and gRPC, every launch count set to 0 just before
   the traffic. One row per request: each BERT answer bit for bit its
   twin's forward, the two versions apart; each greedy stream token for
   token its twin's direct stream (K1 bf16, K1 fp32, K2, K3); the
   fixture's leaves' SHA-256 and greedy streams JAX's, with no JAX or
   ``zstandard`` on the machine. Prints ``bert_base``'s ``save_params``
   and ``load_params`` seconds and MB/s, the fixture's decode rate, each
   restore's ``max_memory_allocated`` peak against its weights' bytes
   (at most ``WEIGHTS_PEAK_MAX``), and a ``weights observation:`` line;
   an unload of the restored ``bert_long`` frees its memory.
14. Prints one ``{"kernels": [...]}`` line (each kernel's ``launches`` over
   HTTP and gRPC, beside ``http_launches`` over HTTP alone, which must be
   fewer; the ring all-reduce's include the stateful phase's, and its
   entry carries ``dlrm_shape``, its times at [832, 128]; flash
   attention's include the shm phase's, also given as ``shm_launches``;
   every kernel's include the clients, repository, observability and
   weights phases', also given as ``clients_launches``,
   ``repository_launches``, ``observability_launches`` and
   ``weights_launches``), the ``nvidia-smi`` name and power limit line,
   and last ``{"ok": true, "device": {...}}``.

The gRPC client code of steps 4 to 9 and 11 to 13 is the script's own
(tensors as ``tobytes`` and ``np.frombuffer``, BYTES with a hand-written
length prefix); it uses the port's ``grpc_service_pb2`` and ``grpc_stub``
only, the wire schema. Without ``grpc`` the script fails. Step 10 holds the
port's clients against that code.

``--kernels`` stops after step 3, prints the per-wave host/device split of
``tiny_gpt_long`` over one arena and over 2 shards (built directly, no
engine), then the ``{"kernels": [...]}`` line (launches null) and the
``nvidia-smi`` line, and no ``ok`` line. Copied into an older checkout, it
times that checkout's kernels by the same method, so that two commits can
be compared in one call.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero as well without CUDA, or outside a checkout of the repo.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import http.client
from pathlib import Path

import numpy as np

# Tolerances, each with its reason.
# Kernel vs plain version, bf16 output: both accumulate in fp32, but the
# kernel rounds P to bf16 under a running (tile) max and sums in another
# order, so outputs of magnitude <= ~2 may differ by a couple of bf16 ulps
# (1 ulp = 7.8e-3 at 1.0).
KERNEL_ATOL = 2e-2
# Served BERT vs the same module with plain attention, fp32 outputs of
# magnitude <= ~1.5: a one-ulp difference in an attention output propagates
# through 12 bf16 layers; the batch it ran in also changes the GEMM shapes.
SERVED_ATOL = 6e-2
# fp32 flash kernel vs plain version: fp32 throughout, outputs of
# magnitude <= ~3, sums over up to 2048 keys in another order.
FP32_ATOL = 1e-4
# fp32 flash kernel vs attention in float64, inputs scaled x8 (scores up to
# a few hundred, outputs up to ~35): the fp32 plain version itself misses
# by ~6e-4 there, plain TF32 products by ~0.5 (both printed beside it).
FP32_F64_ATOL = 2e-3
# Decode-wave kernel vs plain version: fp32 throughout, one query over up
# to 2048 keys, sums in another order; the scatter is compared exactly.
DECODE_ATOL = 2e-5
# Ring all-reduce vs plain version: none. Both add in the ring's order, so
# every shard's sum must be equal bit for bit.
RING_SHAPES = ((1, 4, 64), (3, 4, 64), (16, 4, 64))  # decode wave buckets
DLRM_POOLED = (832, 128)  # 32 rows x 26 tables of 128: the DLRM partials

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 on the tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

N_TIMED = 25


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _samples_ms(torch, fn) -> list[float]:
    """N_TIMED launches after a warm-up, each bracketed by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _time_ms(torch, fn) -> float:
    """Median over N_TIMED launches, each bracketed by CUDA events."""
    return float(np.median(_samples_ms(torch, fn)))


def _time_turns(torch, kernel, library) -> tuple[float, float]:
    """Medians of a kernel and its library call timed in turns (kernel,
    library, library, kernel; N_TIMED launches a turn), so that drift in
    the card's clocks falls on both alike."""
    samples = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        samples[name] += _samples_ms(
            torch, kernel if name == "kernel" else library)
    return (float(np.median(samples["kernel"])),
            float(np.median(samples["library"])))


def _device_kernels(torch, fn) -> str:
    """The kernels one call of ``fn`` ran on the card, longest first, from
    one ``torch.profiler`` pass; "not measured" where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key for e in kernels) or "not measured"


def _queued_samples(torch, fn, reps: int = 20) -> list[float]:
    """Device time per call of a call too short to time alone: ``reps``
    calls queued back to back behind a sleeping kernel, so the device never
    waits on the host between them, over one pair of CUDA events; five such
    runs. ``reps`` stays small enough that the launches of the plain ring
    at 4 shards (~28 a call) do not fill the launch queue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def _queued_ms(torch, fn, reps: int = 20) -> float:
    """Median of :func:`_queued_samples`."""
    return float(np.median(_queued_samples(torch, fn, reps)))


def _queued_turns(torch, kernel: list, library: list) -> tuple[float, float]:
    """Device ms per call of a kernel and its library call, each given as a
    list of calls that are cycled through (one per layer), queued back to
    back (:func:`_queued_samples`) in turns: kernel, library, library,
    kernel. Medians of the ten runs of each."""
    samples = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        calls = itertools.cycle(kernel if name == "kernel" else library)
        samples[name] += _queued_samples(torch, lambda: next(calls)())
    return (float(np.median(samples["kernel"])),
            float(np.median(samples["library"])))


def _resource_usage(cuda_build, name: str) -> str:
    """Registers, static shared memory and local memory of each kernel in
    the library built from ``csrc/<name>.cu`` (``cuobjdump -res-usage``,
    the figures ``ptxas`` reports)."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run(
        [str(tool), "-res-usage", str(cuda_build.library_path(name))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    usage, kernel = [], None
    for line in out.splitlines():
        found = re.search(r"Function (\S+):", line)
        if found:
            short = re.search(r"\d+([a-z][a-z0-9_]*_kernel)(?:ILi(\d+)E)?",
                              found.group(1))
            kernel = (short.group(1) + (f"<{short.group(2)}>"
                                        if short.group(2) else "")
                      if short else found.group(1))
            continue
        fields = re.findall(r"(REG|SHARED|LOCAL|STACK):(\d+)", line)
        if kernel and fields:
            usage.append(f"{kernel} " + " ".join(f"{k}:{v}" for k, v in fields))
            kernel = None
    return "; ".join(usage) or "no resource usage found"


def _sass_census(cuda_build) -> dict:
    """Instruction counts of the two flash-attention kernels in the built
    library, from ``cuobjdump -sass``: wgmma (HGMMA), TMA loads (UTMALDG)
    and mma.sync (HMMA, and those with TF32 operands). Fails unless the
    bf16 kernel runs its products on wgmma, loads with TMA and has no
    mma.sync, and every HMMA of the fp32 kernel is TF32."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(cuda_build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    census, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(
            r"Function : \S*(flash_fwd_f32_kernel|flash_fwd_kernel)", line)
        if found:
            kernel = "fp32" if "f32" in found.group(1) else "bf16"
            census[kernel] = collections.Counter(
                {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0, "HMMA_TF32": 0})
            continue
        op = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if kernel is None or op is None:
            continue
        for family in ("HGMMA", "UTMALDG", "HMMA"):
            if op.group(1).startswith(family):
                census[kernel][family] += 1
        if op.group(1).startswith("HMMA") and "TF32" in op.group(1):
            census[kernel]["HMMA_TF32"] += 1
    census = {k: dict(c) for k, c in census.items()}
    print(f"set-up: SASS census of flash_attention (cuobjdump -sass): "
          f"{census}", flush=True)
    _check(set(census) == {"bf16", "fp32"}, f"kernels in the library: {census}")
    bf16, fp32 = census["bf16"], census["fp32"]
    _check(bf16["HGMMA"] > 0 and bf16["UTMALDG"] > 0 and bf16["HMMA"] == 0,
           f"bf16 kernel is not wgmma fed by TMA: {bf16}")
    _check(fp32["HMMA_TF32"] > 0 and fp32["HMMA_TF32"] == fp32["HMMA"],
           f"fp32 kernel is not TF32 mma.sync: {fp32}")
    return census


# -- kernel phase -----------------------------------------------------------

def kernel_phase(torch) -> dict:
    from client_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)

    def qkv(b, s, h):
        # As BERT hands them over: slices of one fused [b, s, 3, h, 64].
        fused = torch.randn(b, s, 3, h, 64, generator=gen).to(
            torch.bfloat16).cuda()
        return fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]

    def tail_bias(b, s):
        # BERT's additive mask: -1e9 past each row's length.
        lengths = [s, s * 3 // 4, s // 2, 17][:b]
        mask = torch.ones(b, s)
        for i, n in enumerate(lengths):
            mask[i, n:] = 0
        return ((mask - 1.0) * 1e9).cuda()

    errors = {}

    def compare(label, q, k, v, bias, causal=False):
        out = fa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
        _check(out.shape == q.shape and out.dtype == torch.bfloat16,
               f"{label}: output {out.dtype} {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        print(f"kernel case {label}: max_abs_err {err} (tolerance "
              f"{KERNEL_ATOL})", flush=True)
        _check(err <= KERNEL_ATOL, f"{label}: max_abs_err {err}")
        errors[label] = err
        return out

    B, S, H, D = 4, 2048, 12, 64  # bert_long at its max batch
    q, k, v = qkv(B, S, H)
    bias = tail_bias(B, S)
    compare("bert_long B4 S2048 H12 tail-masked", q, k, v, bias)
    compare("causal B4 S2048 H12", q, k, v, bias, causal=True)
    inf_bias = torch.zeros(2, 256, device="cuda")
    inf_bias[:, ::3] = -math.inf
    inf_bias[1] = -math.inf  # every key masked: the row must be exactly 0
    qi, ki, vi = qkv(2, 256, 4)
    out = compare("-inf bias, one row fully masked", qi, ki, vi, inf_bias)
    _check(bool((out[1] == 0).all()), "fully masked row is not 0")
    qr, kr, vr = qkv(3, 200, 12)
    compare("ragged S=200", qr, kr, vr, tail_bias(3, 200))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=bias[:, None, None, :].to(q.dtype))

    ms, library_ms = _time_turns(
        torch, lambda: fa.flash_attention(q, k, v, bias), library)
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, bias))
    library_kernel = _device_kernels(torch, library)
    flops = 4.0 * B * H * S * S * D       # QK^T and PV, 2 FLOP per MAC
    nbytes = 4 * B * S * H * D * 2 + B * S * 4  # q, k, v, out (bf16), bias
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"flash_attention at B{B} S{S} H{H} D{D}: kernel {ms} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms (timed in turns "
          f"with the kernel; it ran {library_kernel}); bound "
          f"{max(flop_ms, byte_ms)} ms ({flops:.3e} FLOP, {nbytes} bytes)",
          flush=True)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:31",
        "launches": None,  # from the serve phase
        "max_abs_err": max(errors.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention, float mask",
        "library_kernel": library_kernel,
    }


def _fp32_accuracy(torch, fa) -> None:
    """The fp32 kernel against attention computed in float64, with inputs
    scaled x8 so that the rounding of each product shows; the plain
    version in fp32 and with TF32 products, and the library call, beside
    it. TF32 is switched on for that one call only."""
    for causal in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(7)
        fused = torch.randn(2, 512, 3, 2, 64, device="cuda",
                            generator=gen) * 8
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / 8
        if causal:
            keep = torch.ones(512, 512, dtype=torch.bool,
                              device="cuda").tril()
            scores = scores.masked_fill(~keep, -math.inf)
        ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1),
                           v.double())
        errs = {"kernel": fa.flash_attention(q, k, v, causal=causal),
                "plain fp32": fa.flash_attention_plain(q, k, v,
                                                       causal=causal),
                "library": torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal).transpose(1, 2)}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            errs["plain TF32"] = fa.flash_attention_plain(q, k, v,
                                                          causal=causal)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        errs = {name: float((out.double() - ref).abs().max())
                for name, out in errs.items()}
        print(f"kernel case fp32 x8 inputs {'causal' if causal else 'full'} "
              f"B2 S512 H2 against float64 (|out| up to "
              f"{float(ref.abs().max()):.1f}): max_abs_err {errs} "
              f"(kernel tolerance {FP32_F64_ATOL})", flush=True)
        _check(errs["kernel"] <= FP32_F64_ATOL,
               f"fp32 x8 against float64: {errs}")


def kernel_phase_fp32(torch) -> dict:
    """The fp32 instantiation, at tiny_gpt_long's prefill shape."""
    from client_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)

    def qkv(b, s, h):
        return [torch.randn(b, s, h, 64, device="cuda", generator=gen)
                for _ in range(3)]

    errors = []

    def compare(label, q, k, v, bias, causal):
        out = fa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, bias, causal=causal)
        _check(out.shape == q.shape and out.dtype == torch.float32,
               f"{label}: output {out.dtype} {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = float((out - ref).abs().max())
        print(f"kernel case fp32 {label}: max_abs_err {err} (tolerance "
              f"{FP32_ATOL})", flush=True)
        _check(err <= FP32_ATOL, f"fp32 {label}: max_abs_err {err}")
        errors.append(err)

    B, S, H, D = 8, 2048, 4, 64  # tiny_gpt_long: admit lanes, max bucket
    q, k, v = qkv(B, S, H)
    compare("causal B8 S2048 H4", q, k, v, None, True)
    qr, kr, vr = qkv(3, 200, 4)
    compare("causal ragged S=200", qr, kr, vr, None, True)
    tail = torch.zeros(3, 200, device="cuda")
    tail[1, 150:] = -1e9
    tail[2, :] = -math.inf  # every key masked: the row must be exactly 0
    compare("tail-masked ragged S=200", qr, kr, vr, tail, False)
    out = fa.flash_attention(qr, kr, vr, tail)
    _check(bool((out[2] == 0).all()), "fp32: fully masked row is not 0")
    _fp32_accuracy(torch, fa)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    ms, library_ms = _time_turns(
        torch, lambda: fa.flash_attention(q, k, v, causal=True), library)
    plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    library_kernel = _device_kernels(torch, library)
    # Causal: only the S(S+1)/2 (query, key) pairs on or below the diagonal.
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 4 * B * S * H * D * 4  # q, k, v read, out written (fp32)
    # The faster of the two fp32-accurate routes: SIMT FMAs, or three TF32
    # products per product on the tensor cores (the 3xTF32 split).
    simt_ms = flops / PEAK_FP32_FLOPS * 1e3
    tf32x3_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    flop_ms = min(simt_ms, tf32x3_ms)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    route = ("3xTF32 on the tensor cores: 3 x FLOP / 495 TFLOP/s"
             if tf32x3_ms <= simt_ms else "SIMT fp32: FLOP / 67 TFLOP/s")
    print(f"flash_attention fp32 causal at B{B} S{S} H{H} D{D}: kernel {ms} "
          f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms (timed in turns "
          f"with the kernel; it ran {library_kernel}); bound "
          f"{max(flop_ms, byte_ms)} ms "
          f"({flops:.3e} FLOP, {nbytes} bytes; {route}; SIMT alone "
          f"{simt_ms} ms)", flush=True)
    return {
        "name": "flash_attention_fp32",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/flash_attention.cu",
        "replaces": "client_tpu/ops/flash_attention.py:31",
        "launches": None,  # from the generate phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "bound_route": route,
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention, is_causal",
        "library_kernel": library_kernel,
    }


def _decode_occupancy(cuda_build, b: int, h: int, n_split: int) -> str:
    """The decode kernel's dynamic shared memory per CTA and the clusters
    of ``n_split`` CTAs the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    lib = cuda_build.load("decode_attention")
    fn = getattr(lib, "client_tpu_decode_wave_occupancy", None)
    if fn is None:  # a tree from before the clustered kernel
        return "occupancy not reported by this build"
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(b, h, n_split, ctypes.byref(smem), ctypes.byref(clusters))
    _check(err == 0, f"cudaOccupancyMaxActiveClusters failed: error {err}")
    return (f"{smem.value} bytes of dynamic shared memory a CTA, at most "
            f"{clusters.value} clusters of {n_split} resident at once")


def kernel_phase_decode(torch, cuda_build) -> dict:
    """The fused decode wave at tiny_gpt_long's arena shape."""
    from client_tpu_torch.ops import decode_attention as da

    L, R, S, H, D = 4, 17, 2048, 4, 64  # 16 stream rows + the dummy row 16
    dummy = R - 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    k_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    v_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    rng = np.random.default_rng(2)
    cases = {  # label: (rows, lens); lanes on the dummy row are padding
        "B1": ([5], [2047]),
        "B3": ([2, 9, dummy], [1, 777, 0]),
        "B16": (list(range(12)) + [dummy] * 4,
                [0, 1, 2047] + rng.integers(2, 1600, 9).tolist() + [0] * 4),
        # Split and tile edges: 32-key tiles, a new CTA every 256 keys.
        "edges": (list(range(16)),
                  [1, 31, 32, 33, 255, 256, 257, 511, 512, 513, 1791, 1792,
                   1793, 2046, 2047, 0]),
        "B16 all 2047": (list(range(16)), [2047] * 16),
    }
    errors = []
    for layer, (label, (rows, lens)) in enumerate(cases.items()):
        layer %= L
        rows_np = np.asarray(rows, np.int32)
        lens_np = np.asarray(lens, np.int32)
        b = len(rows_np)
        real = rows_np != dummy
        q, kn, vn = (torch.randn(b, H, D, device="cuda", generator=gen)
                     for _ in range(3))
        index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
        k_ref, v_ref = k_arena.clone(), v_arena.clone()
        o = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                     layer=layer)
        torch.cuda.synchronize()
        o_ref = da.decode_wave_attention_plain(k_ref, v_ref, q, kn, vn,
                                               index, layer=layer)
        err = float((o[real] - o_ref[real]).abs().max())
        print(f"kernel case decode {label} lens {lens}: max_abs_err {err} "
              f"(tolerance {DECODE_ATOL})", flush=True)
        _check(err <= DECODE_ATOL, f"decode {label}: max_abs_err {err}")
        _check(bool(torch.isfinite(o).all()), f"decode {label}: non-finite")
        errors.append(err)
        for i in np.flatnonzero(real & (lens_np == 0)):
            _check(bool(torch.equal(o[i], vn[i])),
                   f"decode {label} lane {i}: lens 0 is not exactly v_new")
        # Untouched rows bit-identical, scattered slots equal to the
        # inputs: every row but the dummy equals the plain version's.
        _check(bool(torch.equal(k_arena[:, :dummy], k_ref[:, :dummy])
                    and torch.equal(v_arena[:, :dummy], v_ref[:, :dummy])),
               f"decode {label}: arena differs from the plain scatter")
        r = torch.from_numpy(rows_np[real]).long().cuda()
        n = torch.from_numpy(lens_np[real]).long().cuda()
        _check(bool(torch.equal(k_arena[layer, r, n], kn[real])
                    and torch.equal(v_arena[layer, r, n], vn[real])),
               f"decode {label}: scattered slots differ from the inputs")
        # The merge runs in a fixed order: a second call gives the same bits.
        again = da.decode_wave_attention(k_arena, v_arena, q, kn, vn, index,
                                         layer=layer)
        _check(bool(torch.equal(again, o)),
               f"decode {label}: two identical calls differ")
        del k_ref, v_ref
    print("decode kernel: lens 0 gives exactly v_new; untouched rows and "
          "scattered slots bit-identical; repeated calls bit-identical",
          flush=True)

    # Timing at B=16, the largest wave bucket of tiny_gpt_long, over all 4
    # layers in turn, as a decode step walks them: one layer's valid
    # prefix (16 MB) fits the 50 MB L2, four do not.
    rows_np = np.asarray(cases["B16"][0], np.int32)
    lens_np = np.asarray(cases["B16"][1], np.int32)
    index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
    b = len(rows_np)
    # A tree from before the split plan launches one CTA per (lane, head).
    n_split = getattr(index, "n_split", 1)
    longest = int(lens_np.max())
    share = min(longest, (-(-longest // n_split) + 31) // 32 * 32)  # tiles
    print(f"decode split plan at B{b}: n_split {n_split}, {n_split * H * b} "
          f"CTAs, at most {share} keys per CTA (longest lane {longest}); "
          f"{_decode_occupancy(cuda_build, b, H, n_split)}; "
          f"{_resource_usage(cuda_build, 'decode_attention')}", flush=True)
    q, kn, vn = (torch.randn(b, H, D, device="cuda", generator=gen)
                 for _ in range(3))
    k_ref, v_ref = k_arena.clone(), v_arena.clone()
    rows_t = index.rows.long()
    lens_t = index.lens.long()
    gathered = [(k_ref[layer, rows_t].transpose(1, 2),  # beforehand
                 v_ref[layer, rows_t].transpose(1, 2)) for layer in range(L)]
    mask = (torch.arange(S, device="cuda")[None, :] <= lens_t[:, None])
    kernel = [lambda layer=layer: da.decode_wave_attention(
        k_arena, v_arena, q, kn, vn, index, layer=layer) for layer in range(L)]
    library = [lambda ck=ck, cv=cv: torch.nn.functional
               .scaled_dot_product_attention(q[:, :, None], ck, cv,
                                             attn_mask=mask[:, None, None, :])
               for ck, cv in gathered]
    ms, library_ms = _queued_turns(torch, kernel, library)
    alone_ms = _time_ms(torch, kernel[0])
    plain_ms = _queued_ms(torch, lambda: da.decode_wave_attention_plain(
        k_ref, v_ref, q, kn, vn, index, layer=0))
    library_kernel = _device_kernels(torch, library[0])
    lane_bytes = H * D * 4
    nbytes = (2 * int(lens_np.sum()) * lane_bytes  # valid K/V prefix
              + 4 * b * lane_bytes                 # q, k_new, v_new, o
              + 2 * b * lane_bytes                 # the scattered slots
              + 2 * b * 4)                         # rows, lens
    flops = 4.0 * H * D * (int(lens_np.sum()) + b)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(byte_ms, flop_ms)
    print(f"decode_wave_attention at B{b} (sum of lens {int(lens_np.sum())}"
          f"), device ms per call queued back to back over the {L} layers, "
          f"in turns with the library call: kernel {ms} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of the "
          f"bound), scaled_dot_product_attention {library_ms} ms (it ran "
          f"{library_kernel}); one kernel call alone, host included, "
          f"{alone_ms} ms; plain {plain_ms} ms; bound {bound_ms} ms "
          f"({nbytes} bytes)", flush=True)
    return {
        "name": "decode_wave_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_kernel.py:58",
        "launches": None,  # from the generate phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention over rows gathered "
                        "beforehand, boolean mask; no scatter, no gather",
        "library_kernel": library_kernel,
        "alone_ms": alone_ms,
        "n_split": n_split,
    }


def kernel_phase_ring(torch, cuda_build) -> dict:
    """The ring all-reduce at the decode wave's partial outputs [B, 4, 64]
    (and an odd element count), 2 to 8 shards on the one card."""
    from client_tpu_torch.parallel import kv_shard as ks

    gen = torch.Generator(device="cuda").manual_seed(5)

    def partials(n, shape):
        return [torch.randn(shape, device="cuda", generator=gen) * 4
                for _ in range(n)]

    for n in (2, 3, 4, 8):
        for shape in RING_SHAPES + ((5,),):
            parts = partials(n, shape)
            got = ks.ring_all_reduce(parts)
            torch.cuda.synchronize()
            want = ks.ring_all_reduce_plain(parts)
            _check(len(got) == n, f"ring n={n}: {len(got)} outputs")
            for i, (g, w) in enumerate(zip(got, want)):
                _check(g.shape == shape and bool(torch.equal(g, w)),
                       f"ring n={n} {shape} shard {i}: differs from the "
                       f"plain version by {float((g - w).abs().max())}")
            print(f"kernel case ring n={n} {list(shape)}: every shard's sum "
                  "equals the plain version bit for bit", flush=True)
    one = partials(1, RING_SHAPES[0])
    before = ks.launches
    _check(ks.ring_all_reduce(one)[0] is one[0] and ks.launches == before,
           "ring n=1 launched or copied")
    if torch.cuda.device_count() >= 2:
        try:
            ks.kv_mesh(2)
        except NotImplementedError as exc:
            print(f"ring on distinct cards: not run ({exc})", flush=True)
    else:
        print("ring on distinct cards: not run (1 card visible)", flush=True)

    # Each call is a few microseconds of device work behind tens of host
    # work, so a call timed alone measures the host: the device time is
    # taken with calls queued back to back, kernel and library call in
    # turns (_queued_turns), and the time of a call alone, the host's
    # included (_time_ms), is printed beside it.
    numel = math.prod(RING_SHAPES[-1])
    print(f"ring plan at {list(RING_SHAPES[-1])}: one launch of "
          f"{-(-numel // 4 // 128)} CTAs of 128 threads, one 16-byte group of "
          f"every partial a thread; {_resource_usage(cuda_build, 'ring_all_reduce')}",
          flush=True)
    timed = {}
    for n in (2, 4):
        parts = partials(n, RING_SHAPES[-1])
        calls = {"kernel": lambda: ks.ring_all_reduce(parts),
                 "plain": lambda: ks.ring_all_reduce_plain(parts),
                 "torch.stack(...).sum(0)": lambda: torch.stack(parts).sum(0)}
        kernel_ms, library_ms = _queued_turns(
            torch, [calls["kernel"]], [calls["torch.stack(...).sum(0)"]])
        queued = {"kernel": kernel_ms,
                  "plain": _queued_ms(torch, calls["plain"]),
                  "torch.stack(...).sum(0)": library_ms}
        alone = {k: _time_ms(torch, f) for k, f in calls.items()}
        timed[n] = tuple(queued.values())
        nbytes = 2 * n * numel * 4  # n partials read, n sums written
        flops = (n - 1) * n * numel
        print(f"ring_all_reduce n={n} at {list(RING_SHAPES[-1])} fp32, device "
              f"ms per call queued back to back {queued}, one call alone "
              f"{alone}; bound "
              f"{max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3}"
              f" ms ({nbytes} bytes, {flops} additions)", flush=True)
    dlrm_shape = _ring_dlrm_shape(torch, ks, partials)
    ms, plain_ms, library_ms = timed[2]  # the main path: 2 shards
    nbytes, flops = 2 * 2 * numel * 4, 2 * numel
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "name": "ring_all_reduce",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/ring_all_reduce.cu",
        "replaces": "client_tpu/parallel/kv_shard.py:84",
        "launches": None,  # from the sharded generate phase
        "max_abs_err": 0.0,  # checked bit for bit above
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.stack(partials).sum(0) on the one card",
        # The second call site: the pooled bags of the row-sharded DLRM
        # tables (stateful phase), 2 shards on the one card.
        "dlrm_shape": dlrm_shape,
    }


def _ring_bound(n: int, numel: int) -> tuple[float, str]:
    """(ms, what bounds it) for an all-reduce of ``n`` fp32 partials of
    ``numel``: each partial read once and each of the ``n`` sums written
    once, against ``(n - 1) * n * numel`` additions."""
    nbytes, flops = 2 * n * numel * 4, (n - 1) * n * numel
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms
                                   else "operations")


def _ring_dlrm_shape(torch, ks, partials) -> dict:
    """K3 at DLRM's pooled shape, ``[max_batch_size * num_tables,
    emb_dim]`` = [832, 128] of the MLPerf-shaped model: 2 and 4 shards,
    every shard's sum bit for bit against the plain version, then timed
    queued in turns with ``torch.stack(partials).sum(0)``."""
    shape = DLRM_POOLED
    out = {}
    for n in (2, 4):
        parts = partials(n, shape)
        got = ks.ring_all_reduce(parts)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, ks.ring_all_reduce_plain(parts))):
            _check(g.shape == shape and bool(torch.equal(g, w)),
                   f"ring n={n} {list(shape)} shard {i} differs from the plain "
                   f"version by {float((g - w).abs().max())}")
        ms, library_ms = _queued_turns(
            torch, [lambda: ks.ring_all_reduce(parts)],
            [lambda: torch.stack(parts).sum(0)])
        plain_ms = _queued_ms(torch, lambda: ks.ring_all_reduce_plain(parts))
        bound_ms, bound_by = _ring_bound(n, math.prod(shape))
        print(f"ring_all_reduce n={n} at {list(shape)} fp32 (DLRM's pooled "
              f"bags): every shard's sum equals the plain version bit for "
              f"bit; device ms per call queued back to back: kernel {ms}, "
              f"plain {plain_ms}, torch.stack(...).sum(0) {library_ms}; "
              f"bound {bound_ms} ms ({bound_by})", flush=True)
        out[f"n{n}"] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "max_abs_err": 0.0}
    return out


# -- gRPC client ------------------------------------------------------------
# The phases' own gRPC tensor code, built from the protocol's text as the
# vision phase's HTTP wire code is: raw contents are little-endian
# ``arr.tobytes()``, a BYTES element a 4-byte little-endian length and then
# its bytes, read back with ``np.frombuffer``; never the server's codec, so
# that a fault shared by the server's encoder and decoder cannot pass. The
# messages are the port's ``grpc_service_pb2``: the wire schema itself.

# The wire dtypes of both clients, HTTP's and gRPC's.
_WIRE_DTYPES = {"FP32": np.float32, "INT32": np.int32, "UINT32": np.uint32,
                "INT8": np.int8, "UINT8": np.uint8}
GRPC_TIMEOUT_S = 600


def _grpc_channel(url: str):
    """(channel, stub) for the server at ``url``; close the channel."""
    import grpc

    from client_tpu_torch.protocol.grpc_stub import GRPCInferenceServiceStub

    channel = grpc.insecure_channel(url)
    return channel, GRPCInferenceServiceStub(channel)


def _set_param(param_map, key: str, value) -> None:
    p = param_map[key]
    if isinstance(value, bool):
        p.bool_param = value
    elif isinstance(value, int):
        p.int64_param = value
    elif isinstance(value, float):
        p.double_param = value
    else:
        p.string_param = str(value)


def _grpc_request(model: str, inputs: dict[str, np.ndarray],
                  outputs: list | None = None, typed: bool = False,
                  request_id: str = "", parameters: dict | None = None):
    """A ModelInferRequest: every input as raw contents, or when ``typed``
    with the INT32 and INT8 ones as ``int_contents`` and the BYTES ones as
    ``bytes_contents``."""
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    req = pb.ModelInferRequest(model_name=model, id=request_id)
    for name, arr in inputs.items():
        wire = "BYTES" if arr.dtype == np.object_ else names[arr.dtype]
        tensor = req.inputs.add(name=name, datatype=wire,
                                shape=list(arr.shape))
        if typed and wire in ("INT32", "INT8"):
            tensor.contents.int_contents.extend(int(x) for x in arr.ravel())
        elif typed and wire == "BYTES":
            tensor.contents.bytes_contents.extend(arr.ravel().tolist())
        else:
            req.raw_input_contents.append(_wire_bytes(arr))
    for o in outputs or []:
        out = req.outputs.add(name=o["name"])
        for k, v in (o.get("parameters") or {}).items():
            _set_param(out.parameters, k, v)
    for k, v in (parameters or {}).items():
        _set_param(req.parameters, k, v)
    return req


def _grpc_outputs(resp) -> dict[str, np.ndarray]:
    """Every output of a ModelInferResponse from its raw contents."""
    _check(len(resp.outputs) == len(resp.raw_output_contents),
           f"{len(resp.outputs)} outputs, {len(resp.raw_output_contents)} "
           "raw contents")
    out = {}
    for tensor, raw in zip(resp.outputs, resp.raw_output_contents):
        if tensor.datatype == "BYTES":
            arr = _bytes_elements(raw)
        else:
            dtype = np.dtype(_WIRE_DTYPES[tensor.datatype])
            arr = np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype)
        out[tensor.name] = arr.reshape([int(d) for d in tensor.shape])
    return out


def _grpc_final(resp) -> bool:
    p = resp.parameters
    return ("triton_final_response" in p
            and p["triton_final_response"].bool_param)


def _grpc_streams(url: str, streams: list) -> dict[str, tuple]:
    """One ModelStreamInfer RPC carrying every ``(request_id, model,
    prompt, parameters)`` of ``streams``, multiplexed. Per request: its
    tokens, the arrival time of each (monotonic seconds; the tokens of one
    coalesced message share it) and its count of messages. Checks that no
    message is an error, that INDEX runs on without a gap, and that each
    request ends with one final message that carries no tokens."""
    channel, stub = _grpc_channel(url)
    try:
        requests = [_grpc_request(model, {"INPUT_IDS": np.asarray(
            prompt, np.int32)}, request_id=rid, parameters=params)
            for rid, model, prompt, params in streams]
        got = {rid: ([], [], [0]) for rid, *_ in streams}
        finals = set()
        for msg in stub.ModelStreamInfer(iter(requests),
                                         timeout=GRPC_TIMEOUT_S):
            t = time.monotonic()
            resp = msg.infer_response
            _check(not msg.error_message,
                   f"stream {resp.id}: {msg.error_message}")
            _check(resp.id in got and resp.id not in finals,
                   f"stream message for {resp.id!r} after its final")
            tokens, times, count = got[resp.id]
            if _grpc_final(resp):
                _check(not resp.outputs, f"{resp.id}: final with tokens")
                finals.add(resp.id)
                continue
            outs = _grpc_outputs(resp)
            k = len(outs["TOKEN"])
            _check(outs["INDEX"].tolist()
                   == list(range(len(tokens), len(tokens) + k)),
                   f"{resp.id}: INDEX {outs['INDEX']} after {len(tokens)}")
            tokens += outs["TOKEN"].tolist()
            times += [t] * k
            count[0] += 1
        _check(finals == set(got), f"no final for {set(got) - finals}")
        return {rid: (tokens, times, count[0])
                for rid, (tokens, times, count) in got.items()}
    finally:
        channel.close()


def _grpc_stream_rpcs(url: str, rpcs: list[list]) -> dict[str, tuple]:
    """Several ModelStreamInfer RPCs side by side (:func:`_grpc_streams`
    on each), their results merged."""
    with concurrent.futures.ThreadPoolExecutor(len(rpcs)) as pool:
        parts = list(pool.map(lambda streams: _grpc_streams(url, streams),
                              rpcs))
    return {rid: res for part in parts for rid, res in part.items()}


# -- serve phase ------------------------------------------------------------

def _post(port: int, path: str, body: bytes, headers: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _json_request(ids: np.ndarray, mask: np.ndarray) -> bytes:
    return json.dumps({"inputs": [
        {"name": "input_ids", "datatype": "INT32", "shape": list(ids.shape),
         "data": ids.ravel().tolist()},
        {"name": "attention_mask", "datatype": "INT32",
         "shape": list(mask.shape), "data": mask.ravel().tolist()},
    ]}).encode()


def _binary_request(ids: np.ndarray, mask: np.ndarray) -> tuple[bytes, dict]:
    head = json.dumps({
        "inputs": [
            {"name": "input_ids", "datatype": "INT32",
             "shape": list(ids.shape),
             "parameters": {"binary_data_size": ids.nbytes}},
            {"name": "attention_mask", "datatype": "INT32",
             "shape": list(mask.shape),
             "parameters": {"binary_data_size": mask.nbytes}},
        ],
        "parameters": {"binary_data_output": True},
    }).encode()
    return (head + ids.tobytes() + mask.tobytes(),
            {"Inference-Header-Content-Length": str(len(head))})


def _parse_response(headers: dict, data: bytes) -> dict[str, np.ndarray]:
    jlen = headers.get("Inference-Header-Content-Length")
    head = json.loads(data[:int(jlen)] if jlen else data)
    tail = data[int(jlen):] if jlen else b""
    out, offset = {}, 0
    for o in head["outputs"]:
        _check(o["datatype"] == "FP32", f"{o['name']} is {o['datatype']}")
        size = (o.get("parameters") or {}).get("binary_data_size")
        if size is not None:
            arr = np.frombuffer(tail[offset:offset + size], np.float32)
            offset += size
        else:
            arr = np.array(o["data"], np.float32)
        out[o["name"]] = arr.reshape(o["shape"])
    return out


def serve_phase(torch) -> dict:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["bert_base", "bert_long"]))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    print(f"serve: engine and server up in {time.monotonic() - t0:.1f} s "
          f"on {engine.device}", flush=True)
    rng = np.random.default_rng(0)
    try:
        requests = []  # (model, ids, mask, binary)
        for model, seq, count in (("bert_base", 128, 16),
                                  ("bert_long", 2048, 8)):
            for i in range(count):
                rows = 2 if i == 0 else 1
                ids = rng.integers(0, 30522, (rows, seq)).astype(np.int32)
                mask = np.ones((rows, seq), np.int32)
                for r in range(rows):
                    mask[r, rng.integers(seq // 4, seq + 1):] = 0
                requests.append((model, ids, mask, i == 0))

        def send(item):
            model, ids, mask, binary = item
            if binary:
                body, headers = _binary_request(ids, mask)
            else:
                body, headers = _json_request(ids, mask), {}
            t = time.monotonic()
            status, rheaders, data = _post(
                server.port, f"/v2/models/{model}/infer", body, headers)
            _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
            return _parse_response(rheaders, data), time.monotonic() - t

        fa.launches = 0  # count only the main path's launches
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(send, requests))
        wall = time.monotonic() - t0
        launches = fa.launches
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        for model in ("bert_base", "bert_long"):
            n_req = sum(1 for r in requests if r[0] == model)
            print(f"serve: {model}: {n_req} requests in "
                  f"{stats[model]['execution_count']} executions, batch "
                  f"sizes {[b['batch_size'] for b in stats[model]['batch_stats']]}",
                  flush=True)
        print(f"serve: {len(requests)} concurrent requests in {wall:.3f} s; "
              f"latency max {max(t for _, t in results):.3f} s", flush=True)
        long_batches = stats["bert_long"]["execution_count"]
        n_layers = len(engine.repository.get("bert_long").backend.layers)
        _check(launches == n_layers * long_batches,
               f"flash launches {launches} != {n_layers} x {long_batches} "
               "bert_long batches")
        _check(any(stats[m]["execution_count"]
                   < sum(1 for r in requests if r[0] == m)
                   for m in stats), "dynamic batching formed no batch > 1")

        # The same engine over gRPC ModelInfer: every other request again,
        # concurrently, half as raw contents and half as typed int_contents.
        grpc_requests = requests[::2]
        channel, stub = _grpc_channel(grpc_server.url)

        def send_grpc(item):
            i, (model, ids, mask, _) = item
            resp = stub.ModelInfer(_grpc_request(
                model, {"input_ids": ids, "attention_mask": mask},
                typed=i % 2 == 1), timeout=GRPC_TIMEOUT_S)
            return _grpc_outputs(resp)

        try:
            with concurrent.futures.ThreadPoolExecutor(
                    len(grpc_requests)) as pool:
                grpc_results = list(pool.map(send_grpc,
                                             enumerate(grpc_requests)))
        finally:
            channel.close()
        total = fa.launches
        grpc_batches = engine.model_statistics("bert_long")["model_stats"][
            0]["execution_count"] - long_batches
        print(f"serve: gRPC ModelInfer: {len(grpc_requests)} concurrent "
              f"requests ({sum(1 for r in grpc_requests if r[0] == 'bert_long')}"
              f" bert_long in {grpc_batches} batches), raw and typed "
              f"contents; flash launches {launches} over HTTP, {total} "
              "with gRPC", flush=True)
        _check(grpc_batches >= 1 and total - launches == n_layers
               * grpc_batches, f"flash launches {total - launches} over "
               f"gRPC != {n_layers} x {grpc_batches} bert_long batches")

        # Served outputs against the same module run directly on the card,
        # its attention swapped for the plain version (bert_long) or as is.
        errs = {"bert_base": 0.0, "bert_long": 0.0}
        served = [(r, out) for r, (out, _) in zip(requests, results)]
        served += list(zip(grpc_requests, grpc_results))
        with torch.inference_mode():
            for (model, ids, mask, _), out in served:
                backend = engine.repository.get(model).backend
                inputs = {"input_ids": torch.from_numpy(ids).cuda(),
                          "attention_mask": torch.from_numpy(mask).cuda()}
                attend = (fa.flash_attention_plain if model == "bert_long"
                          else backend.attend)
                ref = backend.encode(inputs, attend)
                for tc in backend.config.output:
                    name, got = tc.name, out[tc.name]
                    _check(got.shape == (ids.shape[0], *tc.dims),
                           f"{model} {name} shape {got.shape}")
                    _check(bool(np.isfinite(got).all()),
                           f"{model} {name} not finite")
                    err = float(np.abs(got - ref[name].cpu().numpy()).max())
                    errs[model] = max(errs[model], err)
        print(f"serve: max |served - direct| over HTTP and gRPC {errs} "
              f"(tolerance {SERVED_ATOL})", flush=True)
        _check(max(errs.values()) <= SERVED_ATOL, f"served outputs off: {errs}")
        _check(total == fa.launches, "the reference run launched the kernel")

        ids = np.zeros((1, 128), np.int32)
        mask = np.ones((1, 128), np.int32)
        status, _, _ = _post(server.port, "/v2/models/no_such_model/infer",
                             _json_request(ids, mask))
        _check(status == 404, f"unknown model answered {status}")
        status, _, _ = _post(server.port, "/v2/models/bert_base/infer",
                             b'{"inputs": [')
        _check(status == 400, f"malformed body answered {status}")
        status, _, _ = _post(server.port, "/v2/models/bert_base/infer",
                             _json_request(ids[:, :100], mask[:, :100]))
        _check(status == 400, f"wrong input shape answered {status}")
        import grpc

        channel, stub = _grpc_channel(grpc_server.url)
        try:
            for model, inputs, want in (
                    ("no_such_model", {"input_ids": ids},
                     grpc.StatusCode.NOT_FOUND),
                    ("bert_base", {"input_ids": ids[:, :100],
                                   "attention_mask": mask[:, :100]},
                     grpc.StatusCode.INVALID_ARGUMENT)):
                try:
                    stub.ModelInfer(_grpc_request(model, inputs),
                                    timeout=GRPC_TIMEOUT_S)
                    code = None
                except grpc.RpcError as exc:
                    code = exc.code()
                _check(code == want, f"gRPC {model}: {code}, not {want}")
        finally:
            channel.close()
        print("serve: 404 for an unknown model, 400 for a malformed body "
              "and a wrong shape; over gRPC NOT_FOUND and INVALID_ARGUMENT",
              flush=True)
        return {"launches": total, "http_launches": launches, "errs": errs}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- generate phase ---------------------------------------------------------

def _stream(port: int, model: str, body: dict
            ) -> tuple[list[int], list[float], int]:
    """One /generate_stream request: its tokens, the arrival time of each
    (monotonic seconds; the tokens of one coalesced event share it) and
    its count of events, read event by event as they come."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", f"/v2/models/{model}/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"{model}: generate_stream HTTP "
               f"{resp.status}")
        _check(resp.getheader("Content-Type") == "text/event-stream",
               f"{model}: not an event stream")
        tokens, times, events, buf = [], [], 0, b""
        while True:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                _check(event.startswith(b"data: "), f"bad event {event!r}")
                head = json.loads(event[len(b"data: "):])
                _check("error" not in head, f"{model}: {head}")
                outs = {o["name"]: o["data"] for o in head["outputs"]}
                k = len(outs["TOKEN"])
                _check(outs["INDEX"] == list(range(len(tokens),
                                                   len(tokens) + k)),
                       f"{model}: INDEX {outs['INDEX']} after {len(tokens)} "
                       "tokens")
                tokens += outs["TOKEN"]
                times += [time.monotonic()] * k
                events += 1
        _check(not buf, f"{model}: trailing bytes {buf[:80]!r}")
        return tokens, times, events
    finally:
        conn.close()


def _direct_stream(torch, backend, arena, prompt, n, params,
                   device: str = "cuda") -> list[int]:
    """The same model run directly, one stream alone in arena row 0."""
    lanes = backend.lane_params([params.get("seed", 0)],
                                [params.get("temperature", 0.0)],
                                [params.get("top_k", 0)],
                                [params.get("top_p", 1.0)])
    sample = params.get("temperature", 0.0) > 0
    ids = torch.tensor([prompt], dtype=torch.int32, device=device)
    tokens = [int(backend.prefill(
        arena, backend.wave_index(arena, [0], [len(prompt)]), ids, lanes,
        sample)[0])]
    for i in range(n - 1):
        index = backend.wave_index(arena, [0], [len(prompt) + i])
        tokens.append(int(backend.decode(arena, index, lanes, sample)[0]))
    return tokens


def _wave_split(torch, backend, smi: str) -> None:
    """Where one decode wave's time goes: the host's dispatch (Python and
    kernel launches, no sync) against the device's time for the same wave,
    at 12 live lanes in a 16-lane bucket, greedy and with a sampled lane.
    The device time is taken with the wave queued behind a sleeping
    kernel, so the device runs it with no wait on the host (one wave at a
    time: a sampled wave's ~500 launches fill most of the launch queue)."""
    arena = backend.init_arena(backend.max_streams)
    rng = np.random.default_rng(4)
    free, dummy = backend.arena_rows()
    rows = free[:12] + [dummy] * 4
    lens = rng.integers(100, 1600, 12).tolist() + [0] * 4
    index = backend.wave_index(arena, rows, lens)
    for label, temps in (("greedy", [0.0] * 16),
                         ("sampled", [0.8] + [0.0] * 15)):
        lanes = backend.lane_params(list(range(16)), temps, [24] * 16,
                                    [0.9] * 16)
        sample = label == "sampled"
        for _ in range(3):
            backend.decode(arena, index, lanes, sample)
        torch.cuda.synchronize()
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            backend.decode(arena, index, lanes, sample)
            host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
            start.record()
            backend.decode(arena, index, lanes, sample)
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        print(f"generate: {backend.config.name} wave, 12 lanes in a 16 "
              f"bucket, {label}: host dispatch {1e3 * float(np.median(host)):.3f} "
              f"ms (median of {N_TIMED}), device "
              f"{float(np.median(device)):.3f} ms (median of 5); {smi}",
              flush=True)


def _frontend_observation(port: int, grpc_url: str, streams: list,
                          max_tokens: int, smi: str) -> None:
    """The same greedy streams (``(model, prompt)``, all at once, one
    connection or RPC each) over SSE and over gRPC on one engine, with and
    without ``response_coalesce``: the median inter-token gap (tokens of
    one coalesced message arrive together), the messages sent and the
    tokens/s. Printed as an observation, not a cell; every run must carry
    the same tokens."""
    parts, first = [], None
    for frontend in ("sse", "grpc"):
        for coalesce in (False, True):
            params = {"max_tokens": max_tokens,
                      **({"response_coalesce": True} if coalesce else {})}
            t0 = time.monotonic()
            if frontend == "sse":
                with concurrent.futures.ThreadPoolExecutor(
                        len(streams)) as pool:
                    res = list(pool.map(lambda r: _stream(port, r[0], {
                        "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                    "shape": [len(r[1])], "data": r[1]}],
                        "parameters": params}), streams))
            else:
                got = _grpc_stream_rpcs(grpc_url, [
                    [(f"o{i}", model, prompt, params)]
                    for i, (model, prompt) in enumerate(streams)])
                res = [got[f"o{i}"] for i in range(len(streams))]
            wall = time.monotonic() - t0
            tokens = [r[0] for r in res]
            first = tokens if first is None else first
            _check(tokens == first, f"{frontend} coalesce={coalesce}: other "
                   "tokens than the first run")
            gaps = [b - a for _, times, _ in res
                    for a, b in zip(times, times[1:])]
            n_tok = sum(len(t) for t in tokens)
            parts.append(
                f"{frontend}{' coalesced' if coalesce else ''}: median "
                f"inter-token gap {1e3 * float(np.median(gaps)):.3f} ms, "
                f"{sum(r[2] for r in res)} messages for {n_tok} tokens, "
                f"{n_tok / wall:.1f} tokens/s")
    print(f"frontends: {len(streams)} greedy tiny_gpt_long streams of "
          f"{max_tokens} tokens, one engine (observation, not a cell): "
          + "; ".join(parts) + f"; {smi}", flush=True)


def generate_phase(torch, smi: str) -> dict:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmuls are on: fp32 parity needs them off")
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["tiny_gpt", "tiny_gpt_long"]))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    print(f"generate: engine and both servers up in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(3)
    sampled = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}
    requests = []  # (model, prompt, params)
    for i, n in enumerate((3, 17, 60, 130, 200, 300, 450, 700, 900, 1100,
                           1300, 1500)):
        params = {**sampled, "seed": 100 + i} if i in (4, 9) else {}
        requests.append(("tiny_gpt_long",
                         rng.integers(0, 512, n).tolist(), params))
    for i, n in enumerate((1, 5, 9, 20, 33, 50, 70, 96)):
        params = {**sampled, "seed": 200 + i} if i == 3 else {}
        requests.append(("tiny_gpt", rng.integers(0, 512, n).tolist(),
                         params))
    max_tokens = 32

    def send_all(n_tokens):
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            return list(pool.map(lambda r: _stream(
                server.port, r[0], {
                    "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                "shape": [len(r[1])], "data": r[1]}],
                    "parameters": {"max_tokens": n_tokens, **r[2]}}),
                requests))

    try:
        # One short round first, so the timed round does not carry the
        # first use of each shape, stream and library handle.
        t0 = time.monotonic()
        send_all(4)
        print(f"generate: warm-up round (4 tokens a stream) in "
              f"{time.monotonic() - t0:.3f} s", flush=True)
        fa.launches_fp32 = 0  # count only the main path's launches
        da.launches = 0
        t0 = time.monotonic()
        results = send_all(max_tokens)
        wall = time.monotonic() - t0
        k1, k2 = fa.launches_fp32, da.launches
        n_tokens = sum(len(toks) for toks, _, _ in results)
        gaps = [b - a for _, times, _ in results
                for a, b in zip(times, times[1:])]
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        print(f"generate: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms, "
              f"p90 {1e3 * float(np.percentile(gaps, 90)):.2f} ms; "
              f"executions {[(m, s['execution_count']) for m, s in sorted(stats.items())]}; "
              f"{smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _, _ in results),
               f"stream lengths {[len(t) for t, _, _ in results]}")
        n_layers = 4
        _check(k2 % n_layers == 0 and k2 >= n_layers * (max_tokens - 1),
               f"decode kernel launches {k2}: not a multiple of {n_layers} "
               f"or fewer than {n_layers * (max_tokens - 1)}")
        _check(k1 % n_layers == 0 and k1 >= n_layers,
               f"fp32 flash launches {k1}: not a multiple of {n_layers}")
        print(f"generate: decode kernel launched {k2} times, fp32 flash "
              f"{k1} times ({k1 // n_layers} tiny_gpt_long prefill chunks) "
              "over HTTP", flush=True)

        # The same streams over gRPC ModelStreamInfer on the same engine:
        # 5 RPCs side by side, 4 requests multiplexed on each, every third
        # with response_coalesce.
        streams = [(f"s{i}", model, prompt, {
            "max_tokens": max_tokens, **params,
            **({"response_coalesce": True} if i % 3 == 0 else {})})
            for i, (model, prompt, params) in enumerate(requests)]
        t0 = time.monotonic()
        by_id = _grpc_stream_rpcs(grpc_server.url,
                                  [streams[i::5] for i in range(5)])
        grpc_wall = time.monotonic() - t0
        grpc_results = [by_id[rid] for rid, *_ in streams]
        k1_all, k2_all = fa.launches_fp32, da.launches
        _check(all(len(toks) == max_tokens for toks, _, _ in grpc_results),
               f"gRPC stream lengths {[len(t) for t, _, _ in grpc_results]}")
        _check(k2_all - k2 >= n_layers * (max_tokens - 1)
               and (k2_all - k2) % n_layers == 0,
               f"decode kernel launches over gRPC {k2_all - k2}")
        _check(k1_all - k1 >= n_layers and (k1_all - k1) % n_layers == 0,
               f"fp32 flash launches over gRPC {k1_all - k1}")
        print(f"generate: gRPC: {len(streams)} streams on 5 RPCs in "
              f"{grpc_wall:.3f} s, {sum(r[2] for r in grpc_results)} "
              f"messages for {sum(len(r[0]) for r in grpc_results)} tokens; "
              f"decode kernel launched {k2_all} times ({k2} over HTTP), fp32 "
              f"flash {k1_all} ({k1} over HTTP)", flush=True)

        # Oracle: the same weights on the plain path, one stream at a time.
        oracles = {}
        for model in ("tiny_gpt", "tiny_gpt_long"):
            served = engine.repository.get(model).backend
            oracle = TinyGptBackend(
                name=model, max_seq_len=served.max_seq_len,
                max_streams=served.max_streams, attention_impl="einsum",
                attn_impl="reference", device="cuda")
            oracles[model] = (oracle, oracle.init_arena(1))
        t0 = time.monotonic()
        for (model, prompt, params), (toks, _, _), (grpc_toks, _, _) in zip(
                requests, results, grpc_results):
            oracle, arena = oracles[model]
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{model} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
            _check(grpc_toks == want, f"{model} prompt of {len(prompt)} "
                   f"{params or 'greedy'} over gRPC: {grpc_toks} != direct "
                   f"{want}")
        _check((fa.launches_fp32, da.launches) == (k1_all, k2_all),
               "the plain-path oracle launched a kernel")
        print(f"generate: all {len(requests)} streams over HTTP and all "
              f"{len(streams)} over gRPC equal the plain path run directly, "
              f"token for token ({time.monotonic() - t0:.1f} s)", flush=True)

        # /generate collects what the stream sent.
        model, prompt, _ = requests[5]
        body = {"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(prompt)], "data": prompt}],
                "parameters": {"max_tokens": max_tokens}}
        status, _, data = _post(server.port, f"/v2/models/{model}/generate",
                                json.dumps(body).encode())
        _check(status == 200, f"/generate HTTP {status}: {data[:200]!r}")
        collected = [{o["name"]: o["data"] for o in r["outputs"]}["TOKEN"][0]
                     for r in json.loads(data)["responses"]]
        _check(collected == results[5][0], "/generate differs from the stream")
        # A stop token ends the stream without being emitted.
        full = results[5][0]
        stop = full[4]
        stopped, _, _ = _stream(server.port, model, {
            **body, "parameters": {"max_tokens": max_tokens,
                                   "stop_token_ids": stop}})
        _check(stopped == full[:full.index(stop)],
               f"stop token {stop}: got {stopped}")
        # The 400s: prompt + max_tokens over max_seq; sync infer.
        long_body = {**body, "parameters": {"max_tokens": 200}}
        long_body["inputs"] = [{**body["inputs"][0], "shape": [2000],
                                "data": [1] * 2000}]
        status, _, _ = _post(server.port, "/v2/models/tiny_gpt_long/generate",
                             json.dumps(long_body).encode())
        _check(status == 400, f"prompt + max_tokens > max_seq: HTTP {status}")
        status, _, _ = _post(server.port, "/v2/models/tiny_gpt/infer",
                             json.dumps(body).encode())
        _check(status == 400, f"sync infer on tiny_gpt: HTTP {status}")
        print("generate: /generate equals the stream; a stop token ends it "
              "unemitted; 400 for prompt + max_tokens > max_seq and for a "
              "sync infer", flush=True)
        _frontend_observation(
            server.port, grpc_server.url,
            [(m, p) for m, p, params in requests
             if m == "tiny_gpt_long" and not params][:8], max_tokens, smi)
        _wave_split(torch, engine.repository.get("tiny_gpt_long").backend,
                    smi)
        return {"flash_attention_fp32": k1_all, "decode_wave_attention": k2_all,
                "http_launches": {"flash_attention_fp32": k1,
                                  "decode_wave_attention": k2},
                "wall_s": wall, "tokens": n_tokens,
                "median_gap_ms": 1e3 * float(np.median(gaps))}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


def sharded_phase(torch, smi: str) -> dict:
    """tiny_gpt_long with its arena split over 2 shards on the one card,
    served over HTTP, every stream checked against the plain unsharded
    path run directly."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    name, shards, n_layers, max_tokens = "tiny_gpt_long_kv2", 2, 4, 32

    def build(device):
        # tiny_gpt_long's registered size; every shard on this card.
        backend = TinyGptBackend(name=name, max_seq_len=2048, max_streams=16,
                                 attention_impl="flash", attn_impl="fused",
                                 kv_shards=shards, device=device)
        backend._kv_mesh = ks.kv_mesh(shards, [device] * shards)
        return backend

    repo = ModelRepository()
    repo.register(name, build)
    t0 = time.monotonic()
    engine = TorchEngine(repo)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    sched = engine._schedulers[name]
    backend = engine.repository.get(name).backend
    _check(sched.arena_shards() == shards and sched._chunk == 1,
           f"scheduler: {sched.arena_shards()} shards, chunk {sched._chunk}")
    arena_mb = sum(t.numel() * 4 for t in sched._arena.k + sched._arena.v) / 1e6
    print(f"sharded: engine and server up in {time.monotonic() - t0:.1f} s; "
          f"arena {arena_mb:.1f} MB in {shards} shards of "
          f"{list(sched._arena.k[0].shape)} on "
          f"{[str(d) for d in backend._mesh().devices]}", flush=True)
    rng = np.random.default_rng(6)
    sampled = {"temperature": 0.8, "top_k": 24, "top_p": 0.9}
    requests = []  # (prompt, params)
    for i, n in enumerate((3, 40, 150, 400, 700, 1000, 1300, 1500)):
        params = {**sampled, "seed": 300 + i} if i in (2, 5) else {}
        requests.append((rng.integers(0, 512, n).tolist(), params))
    try:
        fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(lambda r: _stream(server.port, name, {
                "inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                            "shape": [len(r[0])], "data": r[0]}],
                "parameters": {"max_tokens": max_tokens, **r[1]}}),
                requests))
        wall = time.monotonic() - t0
        k1, k2, k3 = fa.launches_fp32, da.launches, ks.launches
        executions = engine.model_statistics(name)["model_stats"][0][
            "execution_count"]
        prefills = k1 // n_layers
        steps = executions - prefills  # wave dispatches of one step each
        n_tokens = sum(len(toks) for toks, _, _ in results)
        gaps = [b - a for _, times, _ in results
                for a, b in zip(times, times[1:])]
        print(f"sharded: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms; "
              f"{executions} executions: {prefills} prefill chunks, {steps} "
              f"decode steps; {smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _, _ in results),
               f"stream lengths {[len(t) for t, _, _ in results]}")
        _check(k1 == n_layers * prefills and prefills >= 1,
               f"fp32 flash launches {k1}: not {n_layers} per prefill chunk")
        _check(steps >= max_tokens - 1, f"{steps} decode steps")
        _check(k3 == n_layers * steps,
               f"ring launches {k3} != {n_layers} x {steps} decode steps")
        _check(k2 == shards * n_layers * steps,
               f"decode launches {k2} != {shards} x {n_layers} x {steps}")
        print(f"sharded: ring all-reduce launched {k3} = {n_layers} x {steps} "
              f"times, decode kernel {k2} = {shards} x {n_layers} x {steps}, "
              f"fp32 flash {k1} = {n_layers} x {prefills} over HTTP",
              flush=True)

        # Four of the streams again over gRPC: 2 RPCs, 2 requests each.
        streams = [(f"k{i}", name, prompt, {"max_tokens": max_tokens,
                                            **params})
                   for i, (prompt, params) in enumerate(requests[2:6])]
        by_id = _grpc_stream_rpcs(grpc_server.url, [streams[0::2],
                                                    streams[1::2]])
        grpc_results = [by_id[rid] for rid, *_ in streams]
        g1, g2, g3 = (fa.launches_fp32 - k1, da.launches - k2,
                      ks.launches - k3)
        g_prefills = g1 // n_layers
        g_steps = (engine.model_statistics(name)["model_stats"][0][
            "execution_count"] - executions - g_prefills)
        _check(g1 == n_layers * g_prefills and g_prefills >= 1,
               f"fp32 flash launches over gRPC {g1}")
        _check(g_steps >= max_tokens - 1 and g3 == n_layers * g_steps
               and g2 == shards * n_layers * g_steps,
               f"over gRPC: ring {g3}, decode {g2}, {g_steps} decode steps")
        print(f"sharded: gRPC: {len(streams)} streams on 2 RPCs; ring "
              f"all-reduce launched {k3 + g3} times ({k3} over HTTP), decode "
              f"kernel {k2 + g2} ({k2} over HTTP)", flush=True)

        oracle = TinyGptBackend(name=name, max_seq_len=2048, max_streams=16,
                                attention_impl="einsum",
                                attn_impl="reference", device="cuda")
        arena = oracle.init_arena(1)
        t0 = time.monotonic()
        served = list(zip(requests, results))
        served += list(zip(requests[2:6], grpc_results))
        for (prompt, params), (toks, _, _) in served:
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{name} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
        _check((fa.launches_fp32, da.launches, ks.launches)
               == (k1 + g1, k2 + g2, k3 + g3),
               "the plain-path oracle launched a kernel")
        print(f"sharded: all {len(requests)} streams over HTTP and "
              f"{len(streams)} over gRPC equal the plain unsharded path run "
              f"directly, token for token ({time.monotonic() - t0:.1f} s)",
              flush=True)
        _wave_split(torch, backend, smi)
        return {"ring_all_reduce": k3 + g3, "http_launches": k3,
                "wall_s": wall, "tokens": n_tokens}
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- vision phase -------------------------------------------------------------

SIMPLE_MODELS = ("simple", "simple_int8", "simple_string", "simple_identity")
VISION_MODELS = ("resnet50", "densenet_onnx", "ssd_mobilenet_v2_coco_quantized",
                 "ssd_mobilenet_v2_tpu", "image_preprocess", "ensemble_image",
                 "bert_preprocess", "bert_base", "bert_postprocess",
                 "ensemble_bert") + SIMPLE_MODELS
SSD_MODELS = ("ssd_mobilenet_v2_coco_quantized", "ssd_mobilenet_v2_tpu")
# Served classifier logits vs the same module run directly on the request's
# rows padded to a ladder bucket, relative to the request's max |logit|:
# the served rows sat elsewhere in their batch, which cuDNN need not sum
# alike in bf16 (a few bf16 ulps). Whether they were exact is printed; on
# the H100 every request was (PERF.md).
CLASSIFIER_RTOL = 2e-2


# The vision phase's own v2 wire client: built from the protocol's text
# (little-endian tensors; a BYTES element is a 4-byte little-endian length,
# then its bytes), never from the server's codec, so that a fault shared by
# the server's encoder and decoder cannot pass unseen. Its dtypes are
# ``_WIRE_DTYPES``, the gRPC client's.
def _wire_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype == np.object_:
        return b"".join(len(x).to_bytes(4, "little") + x for x in arr.ravel())
    return arr.astype(arr.dtype.newbyteorder("<")).tobytes()


def _infer_body(inputs: dict[str, np.ndarray], outputs: list | None,
                binary: bool) -> tuple[bytes, dict]:
    """A v2 infer body with every input as JSON data or as binary."""
    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    entries, tails = [], []
    for name, arr in inputs.items():
        entry = {"name": name, "shape": list(arr.shape),
                 "datatype": ("BYTES" if arr.dtype == np.object_
                              else names[arr.dtype])}
        if binary:
            raw = _wire_bytes(arr)
            entry["parameters"] = {"binary_data_size": len(raw)}
            tails.append(raw)
        elif arr.dtype == np.object_:
            entry["data"] = [x.decode() for x in arr.ravel()]
        else:
            entry["data"] = arr.ravel().tolist()
        entries.append(entry)
    head = {"inputs": entries}
    if outputs is not None:
        head["outputs"] = outputs
    if binary:
        head["parameters"] = {"binary_data_output": True}
    data = json.dumps(head).encode()
    if not binary:
        return data, {}
    return data + b"".join(tails), {
        "Inference-Header-Content-Length": str(len(data))}


def _bytes_elements(raw: bytes) -> np.ndarray:
    """The elements of a BYTES tensor's raw bytes, as a 1-D object array."""
    items, i = [], 0
    while i < len(raw):
        n = int.from_bytes(raw[i:i + 4], "little")
        _check(i + 4 + n <= len(raw), "BYTES element overruns its tensor")
        items.append(raw[i + 4:i + 4 + n])
        i += 4 + n
    arr = np.empty(len(items), np.object_)
    arr[:] = items
    return arr


def _any_outputs(headers: dict, data: bytes) -> dict[str, np.ndarray]:
    """Every output of a v2 infer response, FP32, INT32, UINT8 or BYTES,
    from JSON data or from the binary tail."""
    jlen = headers.get("Inference-Header-Content-Length")
    head = json.loads(data[:int(jlen)] if jlen else data)
    tail = data[int(jlen):] if jlen else b""
    out, offset = {}, 0
    for o in head["outputs"]:
        size = (o.get("parameters") or {}).get("binary_data_size")
        raw = None
        if size is not None:
            raw = tail[offset:offset + size]
            offset += size
        if o["datatype"] == "BYTES":
            if raw is None:
                arr = np.empty(len(o["data"]), np.object_)
                arr[:] = [x.encode() for x in o["data"]]
            else:
                arr = _bytes_elements(raw)
        else:
            dtype = np.dtype(_WIRE_DTYPES[o["datatype"]])
            arr = (np.array(o["data"], dtype) if raw is None else
                   np.frombuffer(raw, dtype.newbyteorder("<")).astype(dtype))
        out[o["name"]] = arr.reshape(o["shape"])
    return out


def _vision_requests(rng) -> list[tuple[str, dict, list | None, bool]]:
    """(model, inputs, requested outputs, binary) for the vision phase."""
    reqs = []

    def images(n, size):
        return rng.standard_normal((n, size, size, 3)).astype(np.float32)

    def uint8(n, h, w):
        return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)

    for i in range(40):
        rows = 1 if i % 4 == 0 else int(rng.integers(1, 5))
        reqs.append(("resnet50", {"INPUT": images(rows, 224)}, None,
                     i % 4 != 0))
    for i in range(16):
        rows = 1 + i % 2
        reqs.append(("densenet_onnx", {"INPUT": images(rows, 224)}, None,
                     i % 3 != 0))
    for i in range(8):
        reqs.append(("ssd_mobilenet_v2_coco_quantized",
                     {"normalized_input_image_tensor": uint8(1, 300, 300)},
                     None, i % 2 == 0))
    for i in range(24):
        reqs.append(("ssd_mobilenet_v2_tpu",
                     {"normalized_input_image_tensor": uint8(1 + i % 2, 300,
                                                             300)},
                     None, i % 3 != 0))
    for i, (h, w) in enumerate(((480, 640), (333, 500), (480, 640),
                                (333, 500))):
        reqs.append(("ensemble_image", {"RAW_IMAGE": uint8(1, h, w)}, None,
                     i % 2 == 0))
    texts = [b"a great movie", b"the plot falls apart in the last act",
             b"i would watch it again", b"not for me"]
    for i, text in enumerate(texts):
        reqs.append(("ensemble_bert",
                     {"TEXT": np.array([[text]] * (1 + i % 2),
                                       dtype=np.object_)}, None, i % 2 == 1))
    for i in range(2):
        reqs.append(("resnet50", {"INPUT": images(2, 224)},
                     [{"name": "OUTPUT", "parameters": {"classification": 3}}],
                     i == 0))
    return reqs


def _direct_buckets(torch, model, inputs: dict[str, np.ndarray]):
    """The module run directly on the card on the request's rows padded to
    each bucket of the model's ladder that holds them, smallest first."""
    rows = next(iter(inputs.values())).shape[0]
    with torch.inference_mode():
        for bucket in model.config.effective_buckets():
            if bucket < rows:
                continue
            staged = {k: torch.from_numpy(np.pad(
                v, [(0, bucket - rows)] + [(0, 0)] * (v.ndim - 1))).cuda()
                for k, v in inputs.items()}
            out = model.backend(staged)
            yield bucket, {k: v[:rows].cpu().numpy() for k, v in out.items()}


def _match_logits(torch, model, inputs, got: np.ndarray
                  ) -> tuple[float, int | None]:
    """(smallest max |served - direct| over the ladder, the first bucket
    where it is 0, else None)."""
    best = math.inf
    for bucket, out in _direct_buckets(torch, model, inputs):
        best = min(best, float(np.abs(got - next(iter(out.values()))).max()))
        if best == 0:
            return 0.0, bucket
    return best, None


def _forward_profile(torch, backend, inputs) -> dict:
    """One forward pass at a bucket: its wall ms (median of N_TIMED calls
    bracketed by CUDA events, after a warm-up, the card waiting on the
    host's launches), the host's ms to launch it (no sync; median of
    N_TIMED), its device ms (median of N_TIMED calls, each queued behind a
    sleeping kernel that outlasts twice the host's launch time, so the
    card never waits on the host), the card's busy ms (the sum of its
    kernels' device time in one ``torch.profiler`` pass), the three
    kernels that take longest, and the FLOPs ``torch.utils.flop_counter``
    counts."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    def forward():
        return backend(inputs)

    with torch.inference_mode():
        wall = _time_ms(torch, forward)
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            forward()
            host.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        host_ms = 1e3 * float(np.median(host))
        # ~2e6 sleep cycles per ms at the H100's clocks.
        cycles = int(max(20e6, 4e6 * host_ms))
        device = []
        for _ in range(N_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            forward()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        counter = FlopCounterMode(display=False)
        with counter:
            forward()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    return {"ms": float(np.median(device)), "wall_ms": wall, "host_ms": host_ms,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                    for e in kernels[:3]],
            "launches": sum(e.count for e in kernels),
            "flops": float(counter.get_total_flops())}


def _nms_split(torch, smi: str) -> None:
    """The batched NMS alone at B=16: host time per call (enqueue, no
    sync), device time (CUDA events, the call queued behind a sleeping
    kernel), and the kernels it launches (one ``torch.profiler`` pass)."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.models import ssd

    gen = torch.Generator(device="cuda").manual_seed(5)
    enc = torch.randn(16, 1917, 4, device="cuda", generator=gen)
    scores = torch.rand(16, 1917, 91, device="cuda", generator=gen)
    anchors = torch.from_numpy(ssd.make_anchors()).cuda()

    def call():
        return ssd.decode_and_nms(enc, scores, anchors)

    with torch.inference_mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        host = []
        for _ in range(N_TIMED):
            t = time.perf_counter()
            call()
            host.append(time.perf_counter() - t)
            torch.cuda.synchronize()
        device = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            call()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"vision: batched NMS at B=16 (1,917 anchors, 91 classes, 10 "
          f"steps): host {1e3 * float(np.median(host)):.3f} ms per call "
          f"(median of {N_TIMED}), device {float(np.median(device)):.3f} ms "
          f"(median of 5, queued), {launches} kernel launches; {smi}",
          flush=True)


def _simple_requests(rng) -> dict[str, dict[str, np.ndarray]]:
    """One request's inputs for each ``simple`` model: integers over their
    whole range (sums wrap), decimal strings, arbitrary bytes."""
    def ints(dtype, rows):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (rows, 16),
                            dtype=np.int64).astype(dtype)

    def decimal():
        arr = np.empty((1, 16), np.object_)
        arr[0] = [str(v).encode() for v in rng.integers(-10**6, 10**6, 16)]
        return arr

    raw = np.empty((2, 3), np.object_)
    raw[:] = [[b"", b"\x00\xffz", b"abc"], ["\u00e9".encode(), b"1", b"22"]]
    return {"simple": {"INPUT0": ints(np.int32, 3),
                       "INPUT1": ints(np.int32, 3)},
            "simple_int8": {"INPUT0": ints(np.int8, 2),
                            "INPUT1": ints(np.int8, 2)},
            "simple_string": {"INPUT0": decimal(), "INPUT1": decimal()},
            "simple_identity": {"INPUT0": raw}}


def _simple_expected(name: str, inputs: dict) -> dict[str, np.ndarray]:
    """What each ``simple`` model must answer, in numpy."""
    if name == "simple_identity":
        return {"OUTPUT0": inputs["INPUT0"]}
    a, b = inputs["INPUT0"], inputs["INPUT1"]
    if name == "simple_string":
        a, b = (np.array([[int(x) for x in row] for row in t])
                for t in (a, b))
        out = {}
        for key, val in (("OUTPUT0", a + b), ("OUTPUT1", a - b)):
            arr = np.empty(val.shape, np.object_)
            arr[:] = [[str(int(v)).encode() for v in row] for row in val]
            out[key] = arr
        return out
    return {"OUTPUT0": a + b, "OUTPUT1": a - b}  # wrapping, as on the card


def _same_tensor(a: np.ndarray, b: np.ndarray) -> bool:
    """Byte-identical: dtype, shape and every element's bytes."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.object_:
        return a.tolist() == b.tolist()
    return a.tobytes() == b.tobytes()


def _grpc_vision_checks(http_port: int, grpc_url: str) -> None:
    """The vision phase's engine over gRPC, each answer held against the
    same request's HTTP answer: the four ``simple`` models byte for byte
    (raw and typed contents) and against numpy, ``resnet50``'s
    classification strings, both ensembles (a UINT8 and a BYTES input),
    and INVALID_ARGUMENT for an input that names a shared-memory
    region. Requests go one at a time, so each runs alone in its batch."""
    import grpc

    channel, stub = _grpc_channel(grpc_url)
    rng = np.random.default_rng(8)

    def both(model, inputs, outputs=None, typed=False):
        body, headers = _infer_body(inputs, outputs, binary=True)
        status, rh, data = _post(http_port, f"/v2/models/{model}/infer",
                                 body, headers)
        _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
        resp = stub.ModelInfer(_grpc_request(model, inputs, outputs, typed),
                               timeout=GRPC_TIMEOUT_S)
        return _any_outputs(rh, data), _grpc_outputs(resp)

    try:
        for name, inputs in _simple_requests(rng).items():
            want = _simple_expected(name, inputs)
            for typed in (False, True):
                http_out, grpc_out = both(name, inputs, typed=typed)
                for key, arr in want.items():
                    _check(_same_tensor(grpc_out[key], http_out[key]),
                           f"{name} {key}: gRPC {grpc_out[key]} != HTTP "
                           f"{http_out[key]}")
                    _check(_same_tensor(grpc_out[key], arr),
                           f"{name} {key}: {grpc_out[key]} != {arr}")
        images = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        http_out, grpc_out = both(
            "resnet50", {"INPUT": images},
            [{"name": "OUTPUT", "parameters": {"classification": 3}}])
        _check(grpc_out["OUTPUT"].shape == (2, 3)
               and _same_tensor(grpc_out["OUTPUT"], http_out["OUTPUT"]),
               f"classification: gRPC {grpc_out['OUTPUT']} != HTTP "
               f"{http_out['OUTPUT']}")
        raw = rng.integers(0, 256, (1, 333, 500, 3)).astype(np.uint8)
        http_out, grpc_out = both("ensemble_image", {"RAW_IMAGE": raw})
        _check(_same_tensor(grpc_out["CLASS_LOGITS"],
                            http_out["CLASS_LOGITS"]),
               "ensemble_image: gRPC logits differ from HTTP's")
        text = np.empty((2, 1), np.object_)
        text[:, 0] = [b"a great movie", b"not for me"]
        for typed in (False, True):
            http_out, grpc_out = both("ensemble_bert", {"TEXT": text},
                                      typed=typed)
            _check(all(_same_tensor(grpc_out[k], http_out[k])
                       for k in ("LABEL", "SCORE")),
                   f"ensemble_bert: gRPC {grpc_out} != HTTP {http_out}")
        req = _grpc_request("resnet50", {"INPUT": images[:1]})
        _set_param(req.inputs[0].parameters, "shared_memory_region", "r0")
        _set_param(req.inputs[0].parameters, "shared_memory_byte_size",
                   images[:1].nbytes)
        try:
            stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
            code, details = None, ""
        except grpc.RpcError as exc:
            code, details = exc.code(), exc.details()
        _check(code == grpc.StatusCode.INVALID_ARGUMENT
               and "not registered" in details,
               f"shared-memory input over gRPC answered {code} {details!r}")
    finally:
        channel.close()
    print(f"vision: gRPC answers equal HTTP's: {', '.join(SIMPLE_MODELS)} "
          "byte for byte over raw and typed contents (and equal to numpy), "
          "resnet50 classification strings, ensemble_image and "
          "ensemble_bert; a shared-memory input answered INVALID_ARGUMENT: "
          f"{details}", flush=True)


def vision_phase(torch, smi: str) -> None:
    """resnet50, densenet_onnx, both SSDs and both ensembles with their
    composing models, all ten at full size, and the four ``simple``
    models, served over HTTP and gRPC on the card; every output checked
    against the same modules run directly, and the gRPC answers against
    the HTTP ones."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.ensembles import (
        BertPostprocessBackend,
        BertPreprocessBackend,
        ImagePreprocessBackend,
    )
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    _check(not torch.backends.cudnn.benchmark,
           "cuDNN benchmark mode is on: served-vs-direct needs the same "
           "algorithm for a shape every time")
    print(f"vision: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(every convolution on this path is bf16)", flush=True)
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(list(VISION_MODELS)))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    served = engine.repository.names()
    print(f"vision: {len(served)} models up in "
          f"{time.monotonic() - t0:.1f} s: {served}", flush=True)
    _check(len(served) == 14, f"served {served}")
    try:
        requests = _vision_requests(np.random.default_rng(6))

        def send(item):
            model, inputs, outputs, binary = item
            body, headers = _infer_body(inputs, outputs, binary)
            t = time.monotonic()
            status, rheaders, data = _post(
                server.port, f"/v2/models/{model}/infer", body, headers)
            _check(status == 200, f"{model}: HTTP {status}: {data[:300]!r}")
            return _any_outputs(rheaders, data), time.monotonic() - t

        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(send, requests))
        wall = time.monotonic() - t0
        n_images = sum(next(iter(r[1].values())).shape[0] for r in requests)
        print(f"vision: {len(requests)} concurrent requests ({n_images} "
              f"images or texts) in {wall:.3f} s; latency max "
              f"{max(t for _, t in results):.3f} s", flush=True)
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        for name in served:
            st = stats[name]
            print(f"vision: {name}: {st['inference_count']} requests in "
                  f"{st['execution_count']} executions, batch sizes "
                  f"{[(b['batch_size'], b['compute_infer']['count']) for b in st['batch_stats']]}",
                  flush=True)
        for name in ("resnet50", "ssd_mobilenet_v2_tpu"):
            _check(stats[name]["execution_count"]
                   < stats[name]["inference_count"],
                   f"{name}: dynamic batching formed no batch of more than "
                   "one request")

        # Every output: status, declared shape and dtype, then against the
        # same module run directly on the card.
        errs = {"resnet50": 0.0, "densenet_onnx": 0.0}
        exact = {"resnet50": [], "densenet_onnx": [], "ssd": [],
                 "ensemble_image": [], "ensemble_bert": []}
        image_pre = ImagePreprocessBackend()
        for (model, inputs, outputs, _), (out, _) in zip(requests, results):
            cfg = engine.repository.get(model).config
            rows = next(iter(inputs.values())).shape[0]
            for tc in cfg.output:
                got = out[tc.name]
                if outputs is not None:  # classification: [rows, 3] BYTES
                    _check(got.shape == (rows, 3) and got.dtype == np.object_,
                           f"{model} classification {got.shape} {got.dtype}")
                    continue
                want_dt = np.object_ if tc.data_type == "BYTES" else np.float32
                _check(got.shape == (rows, *tc.dims) and got.dtype == want_dt,
                       f"{model} {tc.name}: {got.shape} {got.dtype}")
                _check(want_dt == np.object_ or bool(np.isfinite(got).all()),
                       f"{model} {tc.name} not finite")
            if model in SSD_MODELS:
                m = engine.repository.get(model)
                hit = None
                for bucket, ref in _direct_buckets(torch, m, inputs):
                    if all(out[k].tobytes() == ref[k].tobytes() for k in ref):
                        hit = bucket
                        break
                _check(hit is not None, f"{model}: served outputs equal the "
                       "direct run at no bucket of the ladder")
                exact["ssd"].append(hit)
            elif model in ("resnet50", "densenet_onnx"):
                m = engine.repository.get(model)
                if outputs is None:
                    err, hit = _match_logits(torch, m, inputs, out["OUTPUT"])
                    scale = float(np.abs(out["OUTPUT"]).max())
                    errs[model] = max(errs[model], err / scale)
                    exact[model].append(hit)
                    continue
                # Classification: "score:idx" strings, the direct top 3.
                logits = next(_direct_buckets(torch, m, inputs))[1]["OUTPUT"]
                top3 = np.argsort(-logits, axis=1)[:, :3]
                for r in range(rows):
                    parts = [e.decode().split(":") for e in out["OUTPUT"][r]]
                    _check(all(len(p) == 2 for p in parts),
                           f"classification entries {out['OUTPUT'][r]}")
                    _check([int(p[1]) for p in parts] == top3[r].tolist(),
                           f"classification {parts} != top 3 {top3[r]}")
                    _check(all(abs(float(p[0]) - logits[r, int(p[1])])
                               <= CLASSIFIER_RTOL * np.abs(logits[r]).max()
                               for p in parts), f"classification {parts}")
            elif model == "ensemble_image":
                image = image_pre(inputs)["IMAGE"]
                err, hit = _match_logits(
                    torch, engine.repository.get("resnet50"),
                    {"INPUT": image}, out["CLASS_LOGITS"])
                _check(hit is not None,
                       f"ensemble_image off its steps by {err}")
                exact["ensemble_image"].append(hit)
            elif model == "ensemble_bert":
                pre = BertPreprocessBackend()(inputs)
                hit = None
                for bucket, logits in _direct_buckets(
                        torch, engine.repository.get("bert_base"), pre):
                    post = BertPostprocessBackend()(
                        {"logits": logits["logits"]})
                    if post["LABEL"].tolist() == out["LABEL"].tolist() \
                            and post["SCORE"].tobytes() == \
                            out["SCORE"].tobytes():
                        hit = bucket
                        break
                _check(hit is not None, "ensemble_bert equals its steps run "
                       "by hand at no bucket of bert_base's ladder")
                exact["ensemble_bert"].append(hit)
        print(f"vision: classifier logits, max |served - direct| / max|logit| "
              f"{errs} (tolerance {CLASSIFIER_RTOL}); exact at a ladder "
              f"bucket: resnet50 {sum(h is not None for h in exact['resnet50'])}"
              f"/{len(exact['resnet50'])}, densenet_onnx "
              f"{sum(h is not None for h in exact['densenet_onnx'])}/"
              f"{len(exact['densenet_onnx'])}", flush=True)
        _check(max(errs.values()) <= CLASSIFIER_RTOL,
               f"served logits off: {errs}")
        print(f"vision: SSD outputs bit for bit at buckets {exact['ssd']}; "
              f"ensembles equal to their steps run by hand (at a "
              f"bucket, bit for bit: ensemble_image "
              f"{exact['ensemble_image']}, ensemble_bert "
              f"{exact['ensemble_bert']}); classification "
              "strings parse as score:idx with the direct top 3", flush=True)

        body, _ = _infer_body(
            {"INPUT": np.zeros((1, 224, 224, 3), np.float32)},
            [{"name": "OUTPUT", "parameters": {
                "shared_memory_region": "r0",
                "shared_memory_byte_size": 4000}}], binary=False)
        status, _, data = _post(server.port, "/v2/models/resnet50/infer", body)
        _check(status == 400 and b"not registered" in data,
               f"shared-memory output answered {status} {data!r}")
        print(f"vision: shared-memory output answered 400: "
              f"{json.loads(data)['error']}", flush=True)
        _grpc_vision_checks(server.port, grpc_server.url)
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()

    # Device time of one forward of each model at its largest bucket, on the
    # modules the engine served (random inputs, no engine).
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, bucket in (("resnet50", 32), ("densenet_onnx", 16),
                         ("ssd_mobilenet_v2_tpu", 16),
                         ("ssd_mobilenet_v2_coco_quantized", 1)):
        backend = engine.repository.get(name).backend
        if name in SSD_MODELS:
            inputs = {"normalized_input_image_tensor": torch.randint(
                0, 256, (bucket, 300, 300, 3), dtype=torch.uint8,
                device="cuda", generator=gen)}
        else:
            inputs = {"INPUT": torch.randn(bucket, 224, 224, 3,
                                           device="cuda", generator=gen)}
        f = _forward_profile(torch, backend, inputs)
        ms = f["ms"]
        print(f"vision: {name} forward at batch {bucket}: device "
              f"{ms:.3f} ms (median of {N_TIMED}, CUDA events, queued "
              f"behind a sleeping kernel), {bucket / ms * 1e3:.1f} images/s, "
              f"{f['flops'] / 1e9:.1f} GFLOP "
              f"({f['flops'] / (ms / 1e3) / PEAK_BF16_FLOPS * 100:.2f}% of "
              f"the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak); "
              f"card busy {f['busy_ms']:.3f} ms in {f['launches']} kernels "
              f"({f['busy_ms'] / ms * 100:.1f}% of the device time); wall "
              f"{f['wall_ms']:.3f} ms with the card waiting on the host, "
              f"which launches it in {f['host_ms']:.3f} ms; longest kernels "
              f"(name, ms, calls) {f['top']}; {smi}", flush=True)
    _nms_split(torch, smi)


# -- stateful phase -----------------------------------------------------------

STATEFUL_MODELS = ("dlrm", "dlrm_cached", "simple_sequence",
                   "simple_sequence_oldest", "simple_repeat")
DLRM_MODEL = "dlrm_mlperf"
# MLPerf Inference's DLRM (Criteo) shape: 26 tables of 128, 13 dense
# features, bottom MLP 512-256, top MLP 1024-1024-512-256; the tables cut
# to 65,536 rows each (0.87 GB stacked, fp32). Row-sharded over 2 shards on
# the one card, combined by K3. Not a registered model: the JAX zoo has no
# such entry; the arguments are the JAX DlrmBackend's.
MLPERF_DLRM = dict(num_tables=26, table_rows=65_536, emb_dim=128,
                   dense_dim=13, bottom_units=(512, 256),
                   top_units=(1024, 1024, 512, 256), max_batch_size=32,
                   max_lookups=4096, emb_shards=2, combine="ring", seed=26)
# Served DLRM scores vs the same request run alone through
# Model.execute_timed: rows always pad to max_batch_size, so both run the
# same products on the same shapes and should agree bit for bit; where
# cuBLAS picks another order of additions, fp32 scores of magnitude ~1 may
# differ by a few ulps. Whether they were exact is printed.
DLRM_ATOL = 1e-5
DLRM_CONCURRENCY = 32
SEQ_MODELS = ("simple_sequence", "simple_sequence_oldest")
N_SEQ, SEQ_STEPS = 64, 8


def _mlperf_csr(rng, rows: int = 1) -> dict[str, np.ndarray]:
    """One CSR request of ``rows`` rows: bags of 1 to 4 ids in each of the
    26 tables, Zipf(1.3)-skewed ids (bench.py's DLRM traffic)."""
    t, table_rows = MLPERF_DLRM["num_tables"], MLPERF_DLRM["table_rows"]
    counts = rng.integers(1, 5, size=rows * t)
    nnz = int(counts.sum())
    idx = ((rng.zipf(1.3, size=nnz) - 1) % table_rows).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dense = rng.standard_normal((rows, MLPERF_DLRM["dense_dim"])).astype(
        np.float32)
    return {"DENSE": dense, "INDICES": idx, "OFFSETS": off}


def _small_csr(rng, rows: int = 1) -> dict[str, np.ndarray]:
    """A CSR request for the registered ``dlrm`` / ``dlrm_cached`` (4
    tables of 64 rows, 8 dense features), Zipf-skewed ids."""
    counts = rng.integers(0, 5, size=rows * 4)
    idx = ((rng.zipf(1.3, size=int(counts.sum())) - 1) % 64).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return {"DENSE": rng.standard_normal((rows, 8)).astype(np.float32),
            "INDICES": idx, "OFFSETS": off}


def _http_infer(port: int, model: str, inputs: dict, binary: bool,
                parameters: dict | None = None):
    """(status, outputs or error words) of one /infer request."""
    body, headers = _infer_body(inputs, None, binary)
    if parameters:
        head_len = headers.get("Inference-Header-Content-Length")
        head = json.loads(body[:int(head_len)] if head_len else body)
        head.setdefault("parameters", {}).update(parameters)
        new = json.dumps(head).encode()
        if head_len:
            body = new + body[int(head_len):]
            headers = {"Inference-Header-Content-Length": str(len(new))}
        else:
            body = new
    status, rheaders, data = _post(port, f"/v2/models/{model}/infer", body,
                                   headers)
    if status != 200:
        return status, json.loads(data)["error"]
    return status, _any_outputs(rheaders, data)


def _grpc_infer(stub, model: str, inputs: dict, parameters=None,
                request_id: str = ""):
    """(code, outputs or error words) of one ModelInfer call."""
    import grpc

    try:
        resp = stub.ModelInfer(_grpc_request(
            model, inputs, request_id=request_id, parameters=parameters),
            timeout=GRPC_TIMEOUT_S)
    except grpc.RpcError as exc:
        return exc.code(), exc.details()
    return grpc.StatusCode.OK, _grpc_outputs(resp)


def _dlrm_checks(torch, engine, http_port: int, grpc_url: str,
                 smi: str, device) -> dict:
    """The MLPerf-shaped DLRM (and the registered two) over HTTP and gRPC;
    returns K3's launches over HTTP and over both."""
    import grpc

    from client_tpu_torch.parallel import emb_shard as es
    from client_tpu_torch.parallel import kv_shard as ks

    model = engine.repository.get(DLRM_MODEL)
    backend = model.backend

    def executions(name):
        return engine.model_statistics(name)["model_stats"][0][
            "execution_count"]

    rng = np.random.default_rng(26)
    reqs = [_mlperf_csr(rng) for _ in range(96)]
    http_reqs, grpc_reqs = reqs[:64], reqs[64:]
    channel, stub = _grpc_channel(grpc_url)
    try:
        # Counted: K3 launches once per sharded execution.
        e0 = executions(DLRM_MODEL)
        ks.launches = 0
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            http_out = list(pool.map(
                lambda ir: _http_infer(http_port, DLRM_MODEL, ir[1],
                                       binary=ir[0] % 2 == 1),
                enumerate(http_reqs)))
        http_launches, http_execs = ks.launches, executions(DLRM_MODEL) - e0
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            grpc_out = list(pool.map(
                lambda r: _grpc_infer(stub, DLRM_MODEL, r), grpc_reqs))
        launches, execs = ks.launches, executions(DLRM_MODEL) - e0
        for status, out in http_out:
            _check(status == 200, f"{DLRM_MODEL}: HTTP {status}: {out}")
        for code, out in grpc_out:
            _check(code == grpc.StatusCode.OK, f"{DLRM_MODEL}: gRPC {code}: "
                   f"{out}")
        on_card = device.type == "cuda"  # the CPU wrapper launches nothing
        _check((http_launches, launches) == ((http_execs, execs) if on_card
                                             else (0, 0)),
               f"K3 launched {http_launches} / {launches} times for "
               f"{http_execs} / {execs} sharded executions")
        _check(execs < len(reqs), f"{execs} executions for {len(reqs)} "
               "requests: the ragged scheduler batched nothing")
        print(f"stateful: {DLRM_MODEL}: {len(reqs)} one-row CSR requests "
              f"(64 over HTTP, JSON and binary, 32 over gRPC; "
              f"{DLRM_CONCURRENCY} at a time) in {execs} executions; K3 "
              f"launched {launches} times ({http_launches} over HTTP), one "
              "per execution", flush=True)

        # Every score against the same request run alone.
        exact, worst = 0, 0.0
        for r, out in zip(reqs, [o for _, o in http_out + grpc_out]):
            got = out["OUTPUT0"]
            _check(got.shape == (1, 1) and got.dtype == np.float32
                   and bool(np.isfinite(got).all()),
                   f"{DLRM_MODEL}: {got.shape} {got.dtype}")
            want, _ = model.execute_timed(dict(r), batch_size=int(
                r["INDICES"].shape[0]))
            want = want["OUTPUT0"][:1]
            exact += got.tobytes() == want.tobytes()
            worst = max(worst, float(np.abs(got - want).max()))
        _check(worst <= DLRM_ATOL, f"served scores off the direct run by "
               f"{worst} (tolerance {DLRM_ATOL})")
        print(f"stateful: {DLRM_MODEL}: every score equals the request run "
              f"alone through Model.execute_timed: {exact}/{len(reqs)} bit "
              f"for bit, max |served - direct| {worst} (tolerance "
              f"{DLRM_ATOL})", flush=True)

        # Sharded against unsharded bag sums, a full batch of 32 rows at
        # the largest lookup bucket.
        batch = _mlperf_csr(np.random.default_rng(27), rows=32)
        staged = {k: torch.from_numpy(v).to(device) for k, v in
                  backend.pre_stage(batch, MLPERF_DLRM["max_lookups"]).items()}
        num_seg = MLPERF_DLRM["max_batch_size"] * MLPERF_DLRM["num_tables"]
        with torch.inference_mode():
            sharded = backend.pooled(staged)
            whole = torch.from_numpy(backend.table_host).to(device)
            oracle = es.bag_sum_oracle(whole, staged["INDICES"],
                                       staged["SEG_IDS"], num_seg)
        _check(bool(torch.equal(sharded, oracle)),
               "sharded bag sums differ from the unsharded ones by "
               f"{float((sharded - oracle).abs().max())}")
        del whole, oracle
        print(f"stateful: {DLRM_MODEL}: pooled {list(sharded.shape)} over 2 "
              f"shards (ring) equals the unsharded table's bit for bit, "
              f"{int(batch['INDICES'].shape[0])} lookups in a bucket of "
              f"{MLPERF_DLRM['max_lookups']}", flush=True)

        # The registered two: dlrm over both transports against the direct
        # run, dlrm_cached until its row cache hits.
        small = engine.repository.get("dlrm")
        srng = np.random.default_rng(4)
        for i in range(6):
            r = _small_csr(srng, rows=1 + i % 3)
            status, out = _http_infer(http_port, "dlrm", r, binary=i % 2 == 0)
            code, gout = _grpc_infer(stub, "dlrm", r)
            _check(status == 200 and code == grpc.StatusCode.OK,
                   f"dlrm: {status} {out} / {code} {gout}")
            want, _ = small.execute_timed(dict(r), batch_size=int(
                r["INDICES"].shape[0]))
            for got in (out["OUTPUT0"], gout["OUTPUT0"]):
                _check(got.tobytes() == want["OUTPUT0"][:len(got)].tobytes(),
                       "dlrm: served score differs from the direct run")
            status, out = _http_infer(http_port, "dlrm_cached", r, True)
            _check(status == 200 and out["OUTPUT0"].tobytes()
                   == want["OUTPUT0"][:len(got)].tobytes(),
                   f"dlrm_cached: {status}, not equal to dlrm's score")
        cache = engine.repository.get("dlrm_cached").backend.row_cache
        snap = cache.snapshot()
        _check(snap["hit_rate"] > 0, f"dlrm_cached row cache: {snap}")
        print(f"stateful: dlrm over HTTP and gRPC bit for bit against the "
              f"direct run; dlrm_cached equal to dlrm, row cache {snap}",
              flush=True)

        # validate_ragged's 400s on both transports.
        r = _mlperf_csr(np.random.default_rng(5))
        over = {"DENSE": r["DENSE"], "INDICES": np.zeros(4097, np.int32),
                "OFFSETS": np.array([0] + [4097] * 26, np.int32)}
        cases = {
            "OFFSETS[-1]": {**r, "OFFSETS": np.concatenate(
                [r["OFFSETS"][:-1], [r["OFFSETS"][-1] + 1]]).astype(
                    np.int32)},
            "OFFSETS length": {**r, "OFFSETS": r["OFFSETS"][:-1]},
            "exceeding max_lookups": over,
            "out of range": {**r, "INDICES": np.full_like(
                r["INDICES"], MLPERF_DLRM["table_rows"])},
        }
        for words, bad in cases.items():
            status, err = _http_infer(http_port, DLRM_MODEL, bad, True)
            code, gerr = _grpc_infer(stub, DLRM_MODEL, bad)
            _check(status == 400 and words in err and err == gerr
                   and code == grpc.StatusCode.INVALID_ARGUMENT,
                   f"{words}: HTTP {status} {err!r}, gRPC {code} {gerr!r}")
        print(f"stateful: {len(cases)} malformed CSR requests answered 400 "
              "and INVALID_ARGUMENT with the same words", flush=True)

        # Printed, not claimed: throughput at a fixed concurrency, fill, and
        # one execution's device time at the largest lookup bucket.
        obs_rng = np.random.default_rng(28)
        pool_reqs = [_mlperf_csr(obs_rng) for _ in range(256)]
        e1 = executions(DLRM_MODEL)
        st1 = engine.model_statistics(DLRM_MODEL)["model_stats"][0]

        def client(k):
            lat = []
            for r in pool_reqs[k::DLRM_CONCURRENCY]:
                t = time.monotonic()
                status, out = _http_infer(http_port, DLRM_MODEL, r, True)
                _check(status == 200, f"{DLRM_MODEL}: {status} {out}")
                lat.append(time.monotonic() - t)
            return lat

        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(DLRM_CONCURRENCY) as pool:
            lats = [x for part in pool.map(client, range(DLRM_CONCURRENCY))
                    for x in part]
        wall = time.monotonic() - t0
        n_exec = executions(DLRM_MODEL) - e1
        split = _stats_split(
            st1, engine.model_statistics(DLRM_MODEL)["model_stats"][0])
        nnz = sum(int(r["INDICES"].shape[0]) for r in pool_reqs)
        device_ms = None
        if device.type == "cuda":
            with torch.inference_mode():
                device_ms = _queued_ms(torch, lambda: backend(staged),
                                       reps=10)
        print(f"stateful: {DLRM_MODEL} at concurrency {DLRM_CONCURRENCY} over "
              f"HTTP (binary, client threads in this process): "
              f"{len(pool_reqs) / wall} requests/s, latency p50 "
              f"{1e3 * float(np.percentile(lats, 50))} ms, p99 "
              f"{1e3 * float(np.percentile(lats, 99))} ms; {n_exec} "
              f"executions, {len(pool_reqs) / n_exec} rows and {nnz / n_exec}"
              f" lookups per execution; server-side ms per request "
              f"{split}; one execution of 32 rows at the "
              f"{MLPERF_DLRM['max_lookups']}-lookup bucket: device "
              f"{device_ms} ms (queued behind a sleeping kernel); {smi} "
              "(printed, not claimed)", flush=True)
        return {"ring_all_reduce": launches, "http_launches": http_launches}
    finally:
        channel.close()


def _stats_split(before: dict, after: dict) -> dict:
    """Mean server-side ms per request of each /stats phase between two
    snapshots of one model's statistics."""
    b, a = before["inference_stats"], after["inference_stats"]
    n = max(1, a["success"]["count"] - b["success"]["count"])
    return {k: (a[k]["ns"] - b[k]["ns"]) / n / 1e6
            for k in ("success", "queue", "compute_input", "compute_infer",
                      "compute_output")}


def _seq_expected(sid: int) -> list[int]:
    return np.cumsum([sid * 100 + i for i in range(SEQ_STEPS)]).tolist()


def _seq_over_http(port: int, model: str, sid: int) -> list:
    sums = []
    for i in range(SEQ_STEPS):
        status, out = _http_infer(
            port, model, {"INPUT": np.array([sid * 100 + i], np.int32)},
            binary=i % 2 == 1, parameters={
                "sequence_id": sid, "sequence_start": i == 0,
                "sequence_end": i == SEQ_STEPS - 1})
        _check(status == 200, f"{model} sequence {sid}: {status} {out}")
        sums.append(int(out["OUTPUT"][0]))
    return sums


def _seq_over_stream(url: str, model: str, sids: list[int]) -> dict:
    """Every step of ``sids`` on one ModelStreamInfer RPC, interleaved and
    sent at once; each sequence's sums by request id."""
    channel, stub = _grpc_channel(url)
    try:
        reqs = [_grpc_request(
            model, {"INPUT": np.array([sid * 100 + i], np.int32)},
            request_id=f"{sid}:{i}", parameters={
                "sequence_id": sid, "sequence_start": i == 0,
                "sequence_end": i == SEQ_STEPS - 1})
            for i in range(SEQ_STEPS) for sid in sids]
        got = {sid: [None] * SEQ_STEPS for sid in sids}
        for msg in stub.ModelStreamInfer(iter(reqs), timeout=GRPC_TIMEOUT_S):
            _check(not msg.error_message, f"{model}: {msg.error_message}")
            sid, i = map(int, msg.infer_response.id.split(":"))
            got[sid][i] = int(_grpc_outputs(msg.infer_response)["OUTPUT"][0])
        return got
    finally:
        channel.close()


def _sequence_checks(engine, http_port: int, grpc_url: str) -> None:
    """64 sequences of 8 steps side by side on each sequence model, half
    over HTTP and half over gRPC streams; restarts and the 400s."""
    import grpc

    for model in SEQ_MODELS:
        st0 = engine.model_statistics(model)["model_stats"][0]
        sids = list(range(1, N_SEQ + 1))
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(N_SEQ // 2 + 8) as pool:
            http_f = {sid: pool.submit(_seq_over_http, http_port, model, sid)
                      for sid in sids[:N_SEQ // 2]}
            groups = [sids[N_SEQ // 2 + k::8] for k in range(8)]
            grpc_f = [pool.submit(_seq_over_stream, grpc_url, model, g)
                      for g in groups]
            got = {sid: f.result() for sid, f in http_f.items()}
            for f in grpc_f:
                got.update(f.result())
        wall = time.monotonic() - t0
        for sid in sids:
            _check(got[sid] == _seq_expected(sid),
                   f"{model} sequence {sid}: {got[sid]} != "
                   f"{_seq_expected(sid)}")
        st = engine.model_statistics(model)["model_stats"][0]
        steps = st["inference_count"] - st0["inference_count"]
        execs = st["execution_count"] - st0["execution_count"]
        widest = max(b["batch_size"] for b in st["batch_stats"])
        _check(steps == N_SEQ * SEQ_STEPS, f"{model}: {steps} steps")
        if model == "simple_sequence_oldest":
            _check(widest > 1, f"{model}: no wave held two sequences")
        print(f"stateful: {model}: {N_SEQ} sequences of {SEQ_STEPS} steps "
              f"({N_SEQ // 2} over HTTP, {N_SEQ // 2} on 8 gRPC streams), "
              f"every running sum exact; {steps} steps in {execs} executions "
              f"({steps / execs} sequences per execution, widest {widest}), "
              f"{steps / wall} steps/s, server-side ms per step "
              f"{_stats_split(st0, st)} (printed, not claimed)", flush=True)

        # A restart resets the sum; the 400s on both transports.
        sid = 9001
        sums = []
        for value, params in ((5, {"sequence_start": True}), (3, {}),
                              (10, {"sequence_start": True}),
                              (1, {"sequence_end": True})):
            status, out = _http_infer(http_port, model, {"INPUT": np.array(
                [value], np.int32)}, False, {"sequence_id": sid, **params})
            _check(status == 200, f"{model} restart: {status} {out}")
            sums.append(int(out["OUTPUT"][0]))
        _check(sums == [5, 8, 10, 11], f"{model} restart: {sums}")
        channel, stub = _grpc_channel(grpc_url)
        try:
            for params, words in (
                    ({"sequence_id": 0, "sequence_start": True},
                     "non-zero sequence id"),
                    ({"sequence_id": 9002}, "without start flag")):
                one = {"INPUT": np.array([1], np.int32)}
                status, err = _http_infer(http_port, model, one, False,
                                          params)
                code, gerr = _grpc_infer(stub, model, one, params)
                _check(status == 400 and words in err and err == gerr
                       and code == grpc.StatusCode.INVALID_ARGUMENT,
                       f"{model} {params}: HTTP {status} {err!r}, gRPC "
                       f"{code} {gerr!r}")
        finally:
            channel.close()
    print("stateful: a restart resets the sum; sequence id 0 and a step "
          "without a start answer 400 and INVALID_ARGUMENT on both "
          "sequence models", flush=True)


def _repeat_checks(http_port: int, grpc_url: str) -> None:
    """simple_repeat over /generate_stream and ModelStreamInfer: every OUT
    and IDX in order, then the end (SSE) or the final flag (gRPC)."""
    values = list(range(100, 124))
    body = {"inputs": [{"name": "IN", "datatype": "INT32",
                        "shape": [len(values)], "data": values}]}
    conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=600)
    try:
        conn.request("POST", "/v2/models/simple_repeat/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"simple_repeat SSE: {resp.status}")
        events = [json.loads(e[len(b"data: "):])
                  for e in resp.read().split(b"\n\n") if e]
    finally:
        conn.close()
    outs = [{o["name"]: o["data"] for o in e["outputs"]} for e in events]
    _check([o["OUT"] for o in outs] == [[v] for v in values]
           and [o["IDX"] for o in outs] == [[i] for i in range(len(values))]
           and all(e["parameters"] == {"triton_final_response": False}
                   for e in events),
           f"simple_repeat SSE events {events[:3]}...")
    channel, stub = _grpc_channel(grpc_url)
    try:
        reqs = [_grpc_request("simple_repeat", {"IN": np.array(
            values[k::2], np.int32)}, request_id=f"r{k}") for k in (0, 1)]
        got = {"r0": [], "r1": []}
        finals = set()
        for msg in stub.ModelStreamInfer(iter(reqs), timeout=GRPC_TIMEOUT_S):
            r = msg.infer_response
            _check(not msg.error_message and r.id not in finals,
                   f"simple_repeat stream: {msg.error_message or r.id}")
            if _grpc_final(r):
                _check(not r.outputs, "final message with outputs")
                finals.add(r.id)
                continue
            o = _grpc_outputs(r)
            got[r.id].append((int(o["OUT"][0]), int(o["IDX"][0])))
        _check(finals == {"r0", "r1"}, f"finals {finals}")
        for k in (0, 1):
            want = list(zip(values[k::2], range(len(values[k::2]))))
            _check(got[f"r{k}"] == want, f"simple_repeat r{k}: {got}")
    finally:
        channel.close()
    print(f"stateful: simple_repeat: {len(values)} responses over SSE and "
          "2 requests multiplexed on one ModelStreamInfer RPC, OUT and IDX "
          "in order, each gRPC request ended by its final flag", flush=True)


def stateful_phase(torch, smi: str, device: str = "cuda") -> dict:
    """DLRM (ragged batching, the row cache, row-sharded tables combined
    by K3), both sequence strategies and the decoupled simple_repeat, on
    one engine behind HTTP and gRPC. ``device`` is for a dry run of the
    phase's logic on the CPU at a cut size; the script runs it on cuda."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    device = torch.device(device)
    repo = build_repository(list(STATEFUL_MODELS))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    t0 = time.monotonic()
    engine = TorchEngine(repo, device=device)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    served = engine.repository.names()
    table_gb = engine.repository.get(DLRM_MODEL).backend.table_host.nbytes / 1e9
    print(f"stateful: {len(served)} models up in {time.monotonic() - t0:.1f}"
          f" s: {served}; {DLRM_MODEL}'s stacked table {table_gb:.2f} GB in "
          f"2 shards on {device}", flush=True)
    try:
        counts = _dlrm_checks(torch, engine, server.port, grpc_server.url,
                              smi, device)
        _sequence_checks(engine, server.port, grpc_server.url)
        _repeat_checks(server.port, grpc_server.url)
        return counts
    finally:
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- shm phase ----------------------------------------------------------------

SHM_MODELS = ("simple", "simple_string", "bert_base", "bert_long",
              "resnet50")
SHM_BYTES_ROOM = 512  # placement bytes of a BYTES output
SHM_PLANES = ("system", "cuda", "tpu")
OBS_REQUESTS, OBS_CONCURRENCY = 64, 16


class _Segment:
    """A POSIX shm segment made, written and read by the script's own
    ``mmap`` code (not the port's utilities), unlinked on close."""

    def __init__(self, key: str, size: int):
        import mmap

        self.key, self.size = key, size
        self.path = "/dev/shm/" + key.lstrip("/")
        fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            self.map = mmap.mmap(fd, size)
        finally:
            os.close(fd)

    def write(self, offset: int, raw: bytes) -> None:
        self.map[offset:offset + len(raw)] = raw

    def read(self, offset: int, size: int) -> bytes:
        return bytes(self.map[offset:offset + size])

    def close(self) -> None:
        self.map.close()
        os.unlink(self.path)


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _handle(key: str, size: int) -> bytes:
    """A host-staged device region's handle, written by the script from
    the protocol: JSON with the kind, shm key, byte size and device id."""
    return json.dumps({"kind": "host_staged", "key": key, "byte_size": size,
                       "device_id": 0}).encode()


class _Plane:
    """Register, status and unregister of one shm plane ("system", "cuda"
    or "tpu") over one transport ("http" or "grpc")."""

    def __init__(self, plane: str, wire: str, http_port: int, stub):
        self.plane, self.wire = plane, wire
        self.port, self.stub = http_port, stub
        self.rpc = {"system": "SystemSharedMemory", "cuda":
                    "CudaSharedMemory", "tpu": "TpuSharedMemory"}[plane]

    def _call(self, verb: str, **fields):
        """(ok, answer): the RPC's response, or its code and words."""
        import grpc

        from client_tpu_torch.protocol import grpc_service_pb2 as pb

        request = getattr(pb, f"{self.rpc}{verb}Request")(**fields)
        try:
            return True, getattr(self.stub, f"{self.rpc}{verb}")(
                request, timeout=GRPC_TIMEOUT_S)
        except grpc.RpcError as exc:
            return False, (exc.code(), exc.details())

    def register(self, name: str, seg: _Segment):
        """(ok, error answer or None)."""
        if self.wire == "grpc":
            if self.plane == "system":
                ok, ans = self._call("Register", name=name, key=seg.key,
                                     offset=0, byte_size=seg.size)
            else:
                ok, ans = self._call(
                    "Register", name=name, raw_handle=_handle(
                        seg.key, seg.size), device_id=0, byte_size=seg.size)
            return ok, None if ok else ans
        import base64

        body = ({"key": seg.key, "offset": 0, "byte_size": seg.size}
                if self.plane == "system" else
                {"raw_handle": {"b64": base64.b64encode(_handle(
                    seg.key, seg.size)).decode()}, "device_id": 0,
                 "byte_size": seg.size})
        status, _, data = _post(
            self.port, f"/v2/{self.plane}sharedmemory/region/{name}/register",
            json.dumps(body).encode())
        return status == 200, None if status == 200 else (
            status, json.loads(data)["error"])

    def status(self) -> set[str]:
        if self.wire == "grpc":
            ok, resp = self._call("Status")
            _check(ok, f"{self.rpc}Status: {resp}")
            return set(resp.regions)
        status, body = _get(self.port, f"/v2/{self.plane}sharedmemory/status")
        _check(status == 200, f"{self.plane} status: HTTP {status}")
        return set(body)

    def unregister(self, name: str | None = None) -> None:
        if self.wire == "grpc":
            ok, resp = self._call("Unregister", name=name or "")
            _check(ok, f"{self.rpc}Unregister: {resp}")
            return
        path = (f"/v2/{self.plane}sharedmemory"
                + (f"/region/{name}" if name else "") + "/unregister")
        status, _, data = _post(self.port, path, b"{}")
        _check(status == 200, f"{path}: HTTP {status}: {data!r}")


def _wire_dtype(arr: np.ndarray) -> str:
    names = {np.dtype(v): k for k, v in _WIRE_DTYPES.items()}
    return "BYTES" if arr.dtype == np.object_ else names[arr.dtype]


def _shm_params(region: str, offset: int, size: int) -> dict:
    return {"shared_memory_region": region, "shared_memory_offset": offset,
            "shared_memory_byte_size": size}


def _out_rooms(config, rows: int) -> tuple:
    """(output, placement bytes) of one request of ``rows`` rows: the exact
    size of a fixed-size output, room to spare for a BYTES one."""
    return tuple(
        (t.name, SHM_BYTES_ROOM if t.data_type == "BYTES" else
         rows * int(np.prod(t.dims)) * np.dtype(
             _WIRE_DTYPES[t.data_type]).itemsize)
        for t in config.output)


def _shm_layout(inputs: dict, outputs) -> tuple[dict, dict, int]:
    """Offsets of the inputs (back to back) and then of the outputs in one
    segment, and its size."""
    at, pos = {}, 0
    for name, arr in inputs.items():
        at[name] = (pos, len(_wire_bytes(arr)))
        pos += len(_wire_bytes(arr))
    out_at = {}
    for name, size in outputs:
        out_at[name] = (pos, size)
        pos += size
    return at, out_at, pos


def _shm_infer(plane: _Plane, model: str, region: str, seg: _Segment,
               inputs: dict, rooms: tuple, offsets: dict | None = None):
    """One request with every input read from ``region`` and every output
    written into it; (ok, outputs read back from the segment, or the error
    answer). ``offsets`` overrides input offsets (the 400 cases)."""
    import grpc

    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    at, out_at, _ = _shm_layout(inputs, rooms)
    for name, arr in inputs.items():
        seg.write(at[name][0], _wire_bytes(arr))
    if offsets:
        at = {**at, **offsets}
    if plane.wire == "http":
        head = {"inputs": [{
            "name": name, "datatype": _wire_dtype(arr),
            "shape": list(arr.shape),
            "parameters": _shm_params(region, *at[name])}
            for name, arr in inputs.items()],
            "outputs": [{"name": name, "parameters": _shm_params(
                region, *out_at[name])} for name in out_at]}
        status, headers, data = _post(
            plane.port, f"/v2/models/{model}/infer", json.dumps(head).encode())
        if status != 200:
            return False, (status, json.loads(data)["error"])
        _check("Inference-Header-Content-Length" not in headers,
               f"{model}: a binary tail beside shm outputs")
        entries = [(o["name"], o["datatype"], o["shape"], o["parameters"])
                   for o in json.loads(data)["outputs"]]
    else:
        req = pb.ModelInferRequest(model_name=model)
        for name, arr in inputs.items():
            t = req.inputs.add(name=name, datatype=_wire_dtype(arr),
                               shape=list(arr.shape))
            for k, v in _shm_params(region, *at[name]).items():
                _set_param(t.parameters, k, v)
        for name in out_at:
            o = req.outputs.add(name=name)
            for k, v in _shm_params(region, *out_at[name]).items():
                _set_param(o.parameters, k, v)
        try:
            resp = plane.stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
        except grpc.RpcError as exc:
            return False, (exc.code(), exc.details())
        _check(not resp.raw_output_contents,
               f"{model}: raw contents beside shm outputs")
        entries = [(t.name, t.datatype, list(t.shape), {
            k: (v.string_param or v.int64_param)
            for k, v in t.parameters.items()}) for t in resp.outputs]
    out = {}
    for name, dtype, shape, params in entries:
        offset, room = out_at[name]
        written = int(params["shared_memory_byte_size"])
        _check(params["shared_memory_region"] == region
               and int(params.get("shared_memory_offset", 0)) == offset
               and 0 < written <= room, f"{model} {name}: {params}")
        raw = seg.read(offset, written)
        if dtype == "BYTES":
            arr = _bytes_elements(raw)
        else:
            arr = np.frombuffer(raw, np.dtype(_WIRE_DTYPES[dtype])
                                .newbyteorder("<")).astype(_WIRE_DTYPES[dtype])
        out[name] = arr.reshape(shape)
    return True, out


def _bert_feed(rng, seq: int, valid: int) -> dict[str, np.ndarray]:
    """One ``bert_long`` row: random ids, ``valid`` tokens attended."""
    mask = np.zeros((1, seq), np.int32)
    mask[0, :valid] = 1
    return {"input_ids": rng.integers(0, 512, (1, seq)).astype(np.int32),
            "attention_mask": mask}


def _shm_requests(rng, seq: int) -> dict[str, dict[str, np.ndarray]]:
    """One request's inputs for each model the planes carry."""
    simple = _simple_requests(rng)
    return {
        "simple": {k: v[:2] for k, v in simple["simple"].items()},
        "simple_string": simple["simple_string"],
        "bert_long": _bert_feed(rng, seq, seq * 3 // 4),
        "resnet50": {"INPUT": rng.standard_normal((1, 224, 224, 3)).astype(
            np.float32)},
    }


def _planes_checks(http_port: int, stub, requests: dict, rooms: dict,
                   inline: dict, tag: str) -> int:
    """Every plane over both transports: register the four models' regions,
    status, each request with inputs and outputs in its region (bit for bit
    against the same request inline), unregister one, unregister all, and
    the 400s. Returns the requests sent."""
    import grpc

    sent = 0
    bad_arg = {"http": 400, "grpc": grpc.StatusCode.INVALID_ARGUMENT}
    for plane_name in SHM_PLANES:
        for wire in ("http", "grpc"):
            plane = _Plane(plane_name, wire, http_port, stub)
            segs = {}
            try:
                for model, inputs in requests.items():
                    size = _shm_layout(inputs, rooms[model])[2]
                    segs[model] = _Segment(
                        f"/{tag}_{plane_name}_{wire}_{model}", size)
                    ok, err = plane.register(model, segs[model])
                    _check(ok, f"{plane_name}/{wire} register {model}: {err}")
                _check(plane.status() == set(requests),
                       f"{plane_name}/{wire} status {plane.status()}")
                for model, inputs in requests.items():
                    ok, got = _shm_infer(plane, model, model, segs[model],
                                         inputs, rooms[model])
                    _check(ok, f"{plane_name}/{wire} {model}: {got}")
                    sent += 1
                    for name, want in inline[model].items():
                        _check(_same_tensor(got[name], want),
                               f"{plane_name}/{wire} {model} {name}: shm "
                               "output differs from the inline answer")
                # The 400s: an unregistered region, a double register, an
                # input offset past the region.
                simple = requests["simple"]
                ok, ans = _shm_infer(plane, "simple", "no_such_region",
                                     segs["simple"], simple, rooms["simple"])
                _check(not ok and ans == (
                    bad_arg[wire],
                    "shared memory region 'no_such_region' not registered"),
                    f"{plane_name}/{wire} unregistered: {ans}")
                ok, ans = plane.register("simple", segs["simple"])
                _check(not ok and ans == (
                    bad_arg[wire],
                    "shared memory region 'simple' already registered"),
                    f"{plane_name}/{wire} double register: {ans}")
                size = segs["simple"].size
                ok, ans = _shm_infer(plane, "simple", "simple",
                                     segs["simple"], simple, rooms["simple"],
                                     offsets={"INPUT1": (size + 64, 128)})
                _check(not ok and ans == (
                    bad_arg[wire],
                    f"offset {size + 64} outside region 'simple' "
                    f"({size}B)"), f"{plane_name}/{wire} offset: {ans}")
                plane.unregister("simple")
                _check(plane.status() == set(requests) - {"simple"},
                       f"{plane_name}/{wire} after unregister-one: "
                       f"{plane.status()}")
                plane.unregister()
                _check(plane.status() == set(),
                       f"{plane_name}/{wire} after unregister-all")
            finally:
                plane.unregister()
                for seg in segs.values():
                    seg.close()
    return sent


def _utils_checks(http_port: int, stub) -> None:
    """Regions made with the port's client utilities, one of each kind,
    registered over HTTP and gRPC and served; the outputs read back with
    ``get_contents_as_numpy``."""
    from client_tpu_torch.protocol import grpc_service_pb2 as pb
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.utils import shared_memory as sysshm

    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 7, np.int32)
    key = f"/chip_smoke_utils_{os.getpid()}"
    sys_h = sysshm.create_shared_memory_region("u_sys", key, 192)
    dev_h = cudashm.create_shared_memory_region("u_dev", 64)
    try:
        sysshm.set_shared_memory_region(sys_h, [a, b])
        status, _, data = _post(
            http_port, "/v2/systemsharedmemory/region/u_sys/register",
            json.dumps({"key": key, "byte_size": 192}).encode())
        _check(status == 200, f"utils register: {data!r}")
        stub.CudaSharedMemoryRegister(pb.CudaSharedMemoryRegisterRequest(
            name="u_dev", raw_handle=cudashm.get_raw_handle(dev_h),
            device_id=0, byte_size=64), timeout=GRPC_TIMEOUT_S)
        head = {"inputs": [
            {"name": f"INPUT{i}", "datatype": "INT32", "shape": [1, 16],
             "parameters": _shm_params("u_sys", 64 * i, 64)}
            for i in range(2)], "outputs": [
            {"name": "OUTPUT0", "parameters": _shm_params("u_sys", 128, 64)},
            {"name": "OUTPUT1", "parameters": _shm_params("u_dev", 0, 64)}]}
        status, _, data = _post(http_port, "/v2/models/simple/infer",
                                json.dumps(head).encode())
        _check(status == 200, f"utils infer: {data!r}")
        got0 = sysshm.get_contents_as_numpy(sys_h, np.int32, (1, 16), 128)
        got1 = cudashm.get_contents_as_numpy(dev_h, np.int32, (1, 16))
        _check(got0.tolist() == (a + b).tolist()
               and got1.tolist() == (a - b).tolist(),
               f"utils: {got0} {got1}")
        for path in ("/v2/systemsharedmemory/unregister",
                     "/v2/cudasharedmemory/unregister"):
            _post(http_port, path, b"{}")
    finally:
        sysshm.destroy_shared_memory_region(sys_h)
        cudashm.destroy_shared_memory_region(dev_h)
    print("shm: the port's client utilities: a system region and a device "
          "region served, outputs read back with get_contents_as_numpy",
          flush=True)


def _group_batches(resps: list, name: str) -> list[tuple[int, list]]:
    """The executions behind ``resps`` (keep_outputs_on_device): requests
    whose output ``name`` shares one storage ran in one batch. Per batch,
    its bucket and its requests in row order."""
    groups = collections.defaultdict(list)
    for i, resp in enumerate(resps):
        t = resp.outputs[name]
        groups[t.untyped_storage().data_ptr()].append(i)
    batches = []
    for ptr, members in groups.items():
        t = resps[members[0]].outputs[name]
        row = t[0].nbytes
        nbytes = t.untyped_storage().nbytes()
        _check(nbytes % row == 0, f"{name}: storage of {nbytes} B")
        rows = {(resps[i].outputs[name].data_ptr() - ptr) // row: i
                for i in members}
        _check(sorted(rows) == list(range(len(members))),
               f"{name}: request rows {sorted(rows)}")
        batches.append((nbytes // row, [rows[k] for k in sorted(rows)]))
    return batches


def _inline_rows(model, feeds: list[dict], bucket: int) -> dict:
    """The same rows through the host path at the same bucket: a lone
    request padded with zeros (as the executor pads it), several with the
    first repeated (as the device concatenation pads them)."""
    rows = feeds + ([feeds[0]] * (bucket - len(feeds)) if len(feeds) > 1
                    else [])
    host = {name: np.concatenate([f[name] for f in rows])
            for name in feeds[0]}
    out, _ = model.execute_timed(host, batch_size=len(rows))
    return out


def _device_region_checks(torch, engine, rng) -> dict:
    """In process, on the card: 4 ``bert_long`` and 16 ``resnet50``
    requests at once, inputs and outputs in device regions of tensors on
    the card, with ``keep_outputs_on_device``. Returns K1's launches and
    the ``bert_long`` batches."""
    from torch.profiler import ProfilerActivity, profile

    from client_tpu_torch.engine import InferRequest, OutputRequest
    from client_tpu_torch.ops import flash_attention as fa

    device = engine.device
    cuda = device.type == "cuda"
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feeds = {"bert_long": [_bert_feed(rng, seq, seq // 2 + k * seq // 8)
                           for k in range(4)],
             "resnet50": [{"INPUT": rng.standard_normal(
                 (1, 224, 224, 3)).astype(np.float32)} for _ in range(16)]}
    out_shapes = {model: {t.name: (1, *t.dims) for t in
                          engine.repository.get(model).config.output}
                  for model in feeds}
    reqs = []
    for model, rows in feeds.items():
        for k, feed in enumerate(rows):
            for name, arr in feed.items():
                engine.cuda_shm.register_device_tensor(
                    f"{model}_{k}_{name}", torch.from_numpy(arr).to(device))
            for name, shape in out_shapes[model].items():
                engine.cuda_shm.register_device_tensor(
                    f"{model}_{k}_out_{name}",
                    torch.zeros(shape, device=device))
            reqs.append((model, k))
    if cuda:
        torch.cuda.synchronize()
    done = threading.Event()
    resps, lock = {}, threading.Lock()

    def submit():
        for model, k in reqs:
            def cb(resp, key=(model, k)):
                with lock:
                    resps[key] = resp
                    if len(resps) == len(reqs):
                        done.set()
            engine.async_infer(InferRequest(
                model_name=model, inputs={
                    name: engine.read_shm_tensor(
                        f"{model}_{k}_{name}", 0, arr.nbytes,
                        _wire_dtype(arr), arr.shape)
                    for name, arr in feeds[model][k].items()},
                outputs=[OutputRequest(name=n) for n in out_shapes[model]],
                keep_outputs_on_device=True), cb)
        _check(done.wait(600), "device-region requests timed out")
        for (model, k), resp in resps.items():
            _check(resp.error is None, f"{model} {k}: {resp.error}")
            for name, t in resp.outputs.items():
                engine.write_shm_tensor(f"{model}_{k}_out_{name}", 0, 0, t)
        if cuda:
            torch.cuda.synchronize()

    before = fa.launches
    t0 = time.monotonic()
    if cuda:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            submit()
        names = collections.Counter()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.key] += e.count
        copies = {k: n for k, n in names.items()
                  if "Memcpy HtoD" in k or "Memcpy DtoH" in k}
        _check(sum(names.values()) > 0, "the profiler saw no device work")
        _check(not copies, f"host/card copies on the device-region path: "
                           f"{copies}")
        print(f"shm: device regions: {sum(names.values())} device events "
              f"in the profiler window, no Memcpy HtoD / DtoH "
              f"({len(names)} kinds)", flush=True)
    else:
        submit()
    wall = time.monotonic() - t0
    launches = fa.launches - before
    batches = {}
    for model in feeds:
        model_resps = [resps[(model, k)] for k in range(len(feeds[model]))]
        first = next(iter(out_shapes[model]))
        batches[model] = _group_batches(model_resps, first)
        served = engine.repository.get(model)
        for bucket, members in batches[model]:
            want = _inline_rows(served, [feeds[model][k] for k in members],
                                bucket)
            for row, k in enumerate(members):
                for name, t in model_resps[k].outputs.items():
                    _check(t.device.type == device.type,
                           f"{model} {k} {name} on {t.device}")
                    back = engine.cuda_shm.read_back(f"{model}_{k}_out_{name}")
                    _check(back.untyped_storage().data_ptr()
                           == model_resps[members[0]].outputs[name]
                           .untyped_storage().data_ptr(),
                           f"{model} {k} {name}: the region does not share "
                           "its batch's output storage")
                    _check(back.cpu().numpy().tobytes()
                           == want[name][row:row + 1].tobytes(),
                           f"{model} {k} {name}: device-region output "
                           "differs from the inline run at bucket "
                           f"{bucket}")
    n_bert = len(batches["bert_long"])
    if cuda:
        _check(launches == 12 * n_bert,
               f"K1 launched {launches} times for {n_bert} bert_long "
               "batches (12 a batch)")
    print(f"shm: device regions: 4 bert_long in {n_bert} batches "
          f"{batches['bert_long']}, 16 resnet50 in "
          f"{len(batches['resnet50'])} batches (buckets "
          f"{sorted(b for b, _ in batches['resnet50'])}), in {wall:.2f} s; "
          f"every output bit for bit against the inline run at its bucket; "
          f"K1 launches {launches}", flush=True)
    engine.cuda_shm.unregister(None)
    return {"launches": launches, "bert_batches": n_bert}


def _side_stream_check(torch, engine, rng) -> None:
    """A ``bert_long`` input region filled on a side stream behind a
    ~10 ms sleep and registered there: the request reads the filled rows
    (the batch's stream waits on the region's event)."""
    from client_tpu_torch.engine import InferRequest

    device = engine.device
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feed = _bert_feed(rng, seq, seq // 3)
    side = torch.cuda.Stream(device=device)
    inputs = {}
    for name, arr in feed.items():
        t = torch.zeros(arr.shape, dtype=torch.int32, device=device)
        src = torch.from_numpy(arr).to(device)
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(20_000_000)
            t.copy_(src)
            engine.cuda_shm.register_device_tensor(f"side_{name}", t)
        inputs[name] = engine.read_shm_tensor(f"side_{name}", 0, arr.nbytes,
                                              "INT32", arr.shape)
    resp = engine.infer(InferRequest(
        model_name="bert_long", inputs=inputs, keep_outputs_on_device=True),
        timeout_s=600)
    want = _inline_rows(engine.repository.get("bert_long"), [feed], 1)
    for name, t in resp.outputs.items():
        _check(t.cpu().numpy().tobytes() == want[name].tobytes(),
               f"side stream: {name} differs from the filled rows' answer")
    engine.cuda_shm.unregister(None)
    print("shm: a device region filled on a side stream just before its "
          "request: answered from the filled rows", flush=True)


def _shm_observation(torch, engine, http_port: int, stub, smi: str,
                     rng) -> None:
    """One observation line: ``resnet50``, 64 one-image requests at
    concurrency 16 over binary HTTP, system shm over HTTP and host-staged
    regions over gRPC (requests/s, p50, bytes on the wire per request,
    compute_input per request from /stats); and ``bert_long`` in process,
    compute_input and compute_output on device regions against host
    arrays. Observations, not claims."""
    import queue as queue_mod

    from client_tpu_torch.engine import InferRequest
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
              for _ in range(8)]
    in_size, out_size = images[0].nbytes, 4000
    slots = queue_mod.Queue()
    segs = [_Segment(f"/chip_smoke_obs_{os.getpid()}_{i}", in_size + out_size)
            for i in range(OBS_CONCURRENCY)]
    try:
        for i, seg in enumerate(segs):
            status, _, data = _post(
                http_port, f"/v2/systemsharedmemory/region/obs{i}/register",
                json.dumps({"key": seg.key, "byte_size": seg.size}).encode())
            _check(status == 200, f"obs register: {data!r}")
            stub.CudaSharedMemoryRegister(pb.CudaSharedMemoryRegisterRequest(
                name=f"obs{i}", raw_handle=_handle(seg.key, seg.size),
                device_id=0, byte_size=seg.size), timeout=GRPC_TIMEOUT_S)
            slots.put(i)

        def binary_http(img):
            body, headers = _infer_body({"INPUT": img}, None, True)
            status, rh, data = _post(http_port, "/v2/models/resnet50/infer",
                                     body, headers)
            _check(status == 200, f"binary: {data[:200]!r}")
            out = _any_outputs(rh, data)["OUTPUT"]
            return out, len(body) + len(data)

        def shm_http(img):
            i = slots.get()
            try:
                segs[i].write(0, img.tobytes())
                head = {"inputs": [{
                    "name": "INPUT", "datatype": "FP32", "shape": [1, 224,
                                                                   224, 3],
                    "parameters": _shm_params(f"obs{i}", 0, in_size)}],
                    "outputs": [{"name": "OUTPUT", "parameters": _shm_params(
                        f"obs{i}", in_size, out_size)}]}
                body = json.dumps(head).encode()
                status, _, data = _post(
                    http_port, "/v2/models/resnet50/infer", body)
                _check(status == 200, f"shm: {data[:200]!r}")
                out = np.frombuffer(segs[i].read(in_size, out_size),
                                    np.float32).reshape(1, 1000)
                return out, len(body) + len(data)
            finally:
                slots.put(i)

        def staged_grpc(img):
            i = slots.get()
            try:
                segs[i].write(0, img.tobytes())
                req = pb.ModelInferRequest(model_name="resnet50")
                t = req.inputs.add(name="INPUT", datatype="FP32",
                                   shape=[1, 224, 224, 3])
                for k, v in _shm_params(f"obs{i}", 0, in_size).items():
                    _set_param(t.parameters, k, v)
                o = req.outputs.add(name="OUTPUT")
                for k, v in _shm_params(f"obs{i}", in_size,
                                        out_size).items():
                    _set_param(o.parameters, k, v)
                resp = stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S)
                out = np.frombuffer(segs[i].read(in_size, out_size),
                                    np.float32).reshape(1, 1000)
                return out, req.ByteSize() + resp.ByteSize()
            finally:
                slots.put(i)

        def stats(model):
            status, body = _get(http_port, f"/v2/models/{model}/stats")
            _check(status == 200, f"{model} stats: HTTP {status}")
            return body["model_stats"][0]

        routes = {}
        for route, fn in (("binary_http", binary_http),
                          ("system_shm_http", shm_http),
                          ("host_staged_grpc", staged_grpc)):
            def timed(img, fn=fn):
                t = time.monotonic()
                out, wire = fn(img)
                return out, wire, time.monotonic() - t

            before = stats("resnet50")
            t0 = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(
                    OBS_CONCURRENCY) as pool:
                results = list(pool.map(
                    timed, [images[k % len(images)]
                            for k in range(OBS_REQUESTS)]))
            wall = time.monotonic() - t0
            split = _stats_split(before, stats("resnet50"))
            for out, _, _ in results:
                _check(out.shape == (1, 1000) and np.isfinite(out).all(),
                       f"{route}: resnet50 output {out.shape}")
            routes[route] = {
                "requests_per_s": OBS_REQUESTS / wall,
                "p50_ms": float(np.median([r[2] for r in results])) * 1e3,
                "wire_bytes_per_request": float(np.mean(
                    [r[1] for r in results])),
                "compute_input_ms": split["compute_input"]}
    finally:
        _post(http_port, "/v2/systemsharedmemory/unregister", b"{}")
        _post(http_port, "/v2/cudasharedmemory/unregister", b"{}")
        for seg in segs:
            seg.close()

    # bert_long in process: device regions against host arrays, 4 at once.
    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    feeds = [_bert_feed(rng, seq, seq // 2 + k * seq // 8) for k in range(4)]
    bert = {}
    for path in ("device_regions", "host_arrays"):
        reqs = []
        for k, feed in enumerate(feeds):
            if path == "host_arrays":
                inputs = dict(feed)
            else:
                inputs = {}
                for name, arr in feed.items():
                    engine.cuda_shm.register_device_tensor(
                        f"obs_{k}_{name}",
                        torch.from_numpy(arr).to(engine.device))
                    inputs[name] = engine.read_shm_tensor(
                        f"obs_{k}_{name}", 0, arr.nbytes, "INT32", arr.shape)
            reqs.append(InferRequest(
                model_name="bert_long", inputs=inputs,
                keep_outputs_on_device=path == "device_regions"))
        before = stats("bert_long")
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda r: engine.infer(r, timeout_s=600), reqs))
        split = _stats_split(before, stats("bert_long"))
        bert[path] = {"compute_input_ms": split["compute_input"],
                      "compute_output_ms": split["compute_output"]}
        engine.cuda_shm.unregister(None)
    print("shm observation: " + json.dumps({
        "card": smi, "resnet50": {
            "requests": OBS_REQUESTS, "concurrency": OBS_CONCURRENCY,
            **routes}, "bert_long_in_process": bert}), flush=True)


def shm_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The shared-memory data planes: system regions and host-staged device
    regions over HTTP and gRPC for ``simple``, ``simple_string``,
    ``bert_long`` and ``resnet50``, every output bit for bit against the
    same request inline; in-process device regions of tensors on the card;
    the port's client utilities; an observation line. ``device`` is for a
    dry run of the phase's logic on the CPU; the script runs it on
    cuda."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    usage = shutil.disk_usage("/dev/shm")
    print(f"shm: /dev/shm {usage.total / 2**20:.0f} MiB, "
          f"{usage.free / 2**20:.0f} MiB free", flush=True)
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(list(SHM_MODELS)),
                         device=torch.device(device))
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    print(f"shm: {engine.repository.names()} up in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(10)
    try:
        status, md = _get(server.port, "/v2")
        _check({"system_shared_memory", "cuda_shared_memory",
                "tpu_shared_memory"} <= set(md["extensions"]),
               f"server metadata: {md}")
        fa.launches = 0
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        requests = _shm_requests(rng, seq)
        rooms = {model: _out_rooms(engine.repository.get(model).config,
                                   len(next(iter(inputs.values()))))
                 for model, inputs in requests.items()}
        t0 = time.monotonic()
        inline = {}
        for model, inputs in requests.items():
            status, got = _http_infer(server.port, model, inputs, True)
            _check(status == 200, f"inline {model}: {got}")
            code, via_grpc = _grpc_infer(stub, model, inputs)
            _check(all(_same_tensor(via_grpc[n], got[n]) for n in got),
                   f"inline {model}: gRPC and HTTP differ")
            inline[model] = got
        want = _simple_expected("simple", requests["simple"])
        _check(all(_same_tensor(inline["simple"][n], want[n]) for n in want),
               "simple: inline answer against numpy")
        sent = _planes_checks(server.port, stub, requests, rooms, inline,
                              f"chip_smoke_{os.getpid()}")
        print(f"shm: system, cuda and tpu planes over HTTP and gRPC: {sent} "
              "requests with inputs and outputs in regions, each bit for "
              "bit against the inline answer; status, unregister-one and "
              "-all, and the 400s / INVALID_ARGUMENTs, in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        _utils_checks(server.port, stub)
        region = _device_region_checks(torch, engine, rng)
        if engine.device.type == "cuda":
            _side_stream_check(torch, engine, rng)
        _shm_observation(torch, engine, server.port, stub, smi, rng)
        launches = fa.launches
        if engine.device.type == "cuda":
            _check(launches > region["launches"] > 0,
                   f"K1 in the shm phase: {launches} launches, "
                   f"{region['launches']} in process")
        print(f"shm: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"K1 launches {launches}", flush=True)
        return {"launches": launches}
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- clients phase -------------------------------------------------------------

CLIENT_MODELS = ("simple", "bert_base", "bert_long", "tiny_gpt_long")
CLIENT_PROMPTS = (3, 17, 60, 130, 300, 700, 1100, 1500)
CLIENT_TOKENS = 32
CLIENT_DLRM = 16  # one-row requests, every other one with inputs in shm
CLIENT_OBSERVED, CLIENT_CONCURRENCY = 64, 16  # bert_base, the observation
CHILD_TIMEOUT_S = 900
# The client process may load none of these.
CHILD_FORBIDDEN = ("jax", "jaxlib", "client_tpu", "torch")
BERT_OUTPUTS = ("pooled_output", "logits")


def _client_inputs(seq: int) -> dict[str, np.ndarray]:
    """Every request of the clients phase, from fixed seeds: 8 one-row
    ``bert_long`` requests of ``seq`` tokens, the stream prompts, the
    one-row ``dlrm_mlperf`` requests and a ``bert_base`` request."""
    rng = np.random.default_rng(11)
    arrays = {}
    for i in range(8):
        arrays[f"ids{i}"] = rng.integers(0, 30522, (1, seq)).astype(np.int32)
        mask = np.ones((1, seq), np.int32)
        mask[0, rng.integers(seq // 4, seq + 1):] = 0
        arrays[f"mask{i}"] = mask
    for i, n in enumerate(CLIENT_PROMPTS):
        arrays[f"prompt{i}"] = rng.integers(0, 512, n).astype(np.int32)
    dlrm_rng = np.random.default_rng(36)
    for i in range(CLIENT_DLRM):
        for k, v in _mlperf_csr(dlrm_rng).items():
            arrays[f"dlrm{i}_{k}"] = v
    arrays["base_ids"] = rng.integers(0, 30522, (1, 128)).astype(np.int32)
    arrays["base_mask"] = np.ones((1, 128), np.int32)
    return arrays


def clients_child(argv: list[str]) -> int:
    """The clients phase's other process (``--clients-child WORKDIR
    HTTP_URL GRPC_URL``): drives the servers through the port's own
    clients, ``client_tpu_torch.http`` and ``client_tpu_torch.grpc``, with
    system shm from ``client_tpu_torch.utils.shared_memory``, and writes
    every answer to WORKDIR. It loads neither torch nor jax nor the JAX
    package, and says which modules it loaded."""
    workdir, http_url, grpc_url = argv
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient
    import client_tpu_torch.utils.shared_memory as shm
    from client_tpu_torch.utils import InferenceServerException

    data = dict(np.load(os.path.join(workdir, "inputs.npz")))
    models = json.loads(Path(workdir, "models.json").read_text())
    out: dict[str, np.ndarray] = {}
    summary: dict = {}
    hc = httpclient.InferenceServerClient(
        http_url, concurrency=8, connection_timeout=CHILD_TIMEOUT_S,
        network_timeout=CHILD_TIMEOUT_S)
    gc = grpcclient.InferenceServerClient(grpc_url)

    def bert(mod, i):
        """A BERT request's inputs: ``bert_long``'s ``i``-th, or, for
        ``i == "base"``, the ``bert_base`` one."""
        ids = data["base_ids" if i == "base" else f"ids{i}"]
        mask = data["base_mask" if i == "base" else f"mask{i}"]
        inputs = [mod.InferInput("input_ids", list(ids.shape), "INT32"),
                  mod.InferInput("attention_mask", list(mask.shape),
                                 "INT32")]
        inputs[0].set_data_from_numpy(ids)
        inputs[1].set_data_from_numpy(mask)
        return inputs

    try:
        # Health, metadata and config of every model over both clients.
        summary["health"] = [hc.is_server_live(), hc.is_server_ready(),
                             gc.is_server_live(), gc.is_server_ready()]
        summary["models"] = {}
        for m in models:
            hmd, gmd = hc.get_model_metadata(m), gc.get_model_metadata(m)
            summary["models"][m] = [
                hc.is_model_ready(m), gc.is_model_ready(m), hmd["name"],
                hc.get_model_config(m)["name"], gmd.name,
                gc.get_model_config(m).config.name,
                [t["name"] for t in hmd["inputs"]],
                [t.name for t in gmd.inputs]]

        # bert_long: 4 one at a time over HTTP, 8 at once, 4 over gRPC.
        t0 = time.monotonic()
        for i in range(4):
            r = hc.infer("bert_long", bert(httpclient, i))
            for n in BERT_OUTPUTS:
                out[f"http_one{i}_{n}"] = r.as_numpy(n)
        handles = [hc.async_infer("bert_long", bert(httpclient, i))
                   for i in range(8)]
        for i, h in enumerate(handles):
            r = h.get_result(timeout=CHILD_TIMEOUT_S)
            for n in BERT_OUTPUTS:
                out[f"http_many{i}_{n}"] = r.as_numpy(n)
        for i in range(4):
            r = gc.infer("bert_long", bert(grpcclient, i),
                         client_timeout=CHILD_TIMEOUT_S)
            for n in BERT_OUTPUTS:
                out[f"grpc_one{i}_{n}"] = r.as_numpy(n)
        summary["bert_long_s"] = time.monotonic() - t0

        # tiny_gpt_long: 8 greedy streams multiplexed on one gRPC stream.
        got: dict[str, list] = {}
        finals, errors = set(), []
        cond = threading.Condition()

        def on_message(result, error):
            with cond:
                if error is not None:
                    errors.append(str(error))
                else:
                    resp = result.get_response()
                    p = resp.parameters
                    if resp.outputs:
                        tokens, index = got.setdefault(resp.id, ([], []))
                        tokens += result.as_numpy("TOKEN").tolist()
                        index += result.as_numpy("INDEX").tolist()
                    if ("triton_final_response" in p
                            and p["triton_final_response"].bool_param):
                        finals.add(resp.id)
                cond.notify_all()

        t0 = time.monotonic()
        gc.start_stream(on_message)
        for i in range(len(CLIENT_PROMPTS)):
            prompt = data[f"prompt{i}"]
            inp = grpcclient.InferInput("INPUT_IDS", [len(prompt)], "INT32")
            inp.set_data_from_numpy(prompt)
            gc.async_stream_infer("tiny_gpt_long", [inp], request_id=f"s{i}",
                                  parameters={"max_tokens": CLIENT_TOKENS})
        with cond:
            done = cond.wait_for(
                lambda: errors or len(finals) == len(CLIENT_PROMPTS),
                timeout=CHILD_TIMEOUT_S)
        gc.stop_stream()
        if errors or not done:
            raise RuntimeError(f"streams: errors {errors}, finals {finals}")
        for i in range(len(CLIENT_PROMPTS)):
            tokens, index = got[f"s{i}"]
            if index != list(range(len(tokens))):
                raise RuntimeError(f"stream s{i}: INDEX {index}")
            out[f"stream{i}"] = np.asarray(tokens, np.int64)
        summary["streams_s"] = time.monotonic() - t0

        # dlrm_mlperf: one-row requests, every other one from system shm.
        order = ("DENSE", "INDICES", "OFFSETS")
        wire = {"DENSE": "FP32", "INDICES": "INT32", "OFFSETS": "INT32"}
        size = max(sum(data[f"dlrm{i}_{k}"].nbytes for k in order)
                   for i in range(CLIENT_DLRM))
        region, key = "clients_dlrm", f"/chip_smoke_clients_{os.getpid()}"
        handle = shm.create_shared_memory_region(region, key, size)
        try:
            hc.register_system_shared_memory(region, key, size)
            summary["shm_status"] = hc.get_system_shared_memory_status(
                region)
            for i in range(CLIENT_DLRM):
                arrs = {k: data[f"dlrm{i}_{k}"] for k in order}
                inputs, offset = [], 0
                if i % 2:
                    shm.set_shared_memory_region(
                        handle, [arrs[k] for k in order])
                for k in order:
                    inp = httpclient.InferInput(k, list(arrs[k].shape),
                                                wire[k])
                    if i % 2:
                        inp.set_shared_memory(region, arrs[k].nbytes,
                                              offset=offset)
                        offset += arrs[k].nbytes
                    else:
                        inp.set_data_from_numpy(arrs[k])
                    inputs.append(inp)
                r = hc.infer(DLRM_MODEL, inputs)
                out[f"dlrm{i}"] = r.as_numpy("OUTPUT0")
            hc.unregister_system_shared_memory(region)
        finally:
            shm.destroy_shared_memory_region(handle)

        # A model version that is not a positive integer, on both frontends.
        simple = {"INPUT0": np.arange(16, dtype=np.int32).reshape(1, 16),
                  "INPUT1": np.ones((1, 16), np.int32)}

        def simple_inputs(mod):
            inputs = [mod.InferInput(k, [1, 16], "INT32") for k in simple]
            for inp, v in zip(inputs, simple.values()):
                inp.set_data_from_numpy(v)
            return inputs

        summary["versions"] = []
        for call in (lambda: hc.get_model_metadata("simple", "abc"),
                     lambda: gc.get_model_metadata("simple", "abc"),
                     lambda: hc.infer("simple", simple_inputs(httpclient),
                                      model_version="0"),
                     lambda: gc.infer("simple", simple_inputs(grpcclient),
                                      model_version="0")):
            try:
                call()
                summary["versions"].append(None)
            except InferenceServerException as exc:
                summary["versions"].append([str(exc.status()),
                                            exc.message()])
        summary["version_01"] = [hc.is_model_ready("simple", "01"),
                                 gc.is_model_ready("simple", "01")]

        # The observation: bert_base at concurrency 16 over HTTP.
        oc = httpclient.InferenceServerClient(
            http_url, concurrency=CLIENT_CONCURRENCY,
            network_timeout=CHILD_TIMEOUT_S)
        try:
            def one(_):
                t = time.monotonic()
                oc.infer("bert_base", bert(httpclient, "base"))
                return time.monotonic() - t

            with concurrent.futures.ThreadPoolExecutor(
                    CLIENT_CONCURRENCY) as pool:
                list(pool.map(one, range(CLIENT_CONCURRENCY)))  # warm-up
                before = hc.get_inference_statistics("bert_base")[
                    "model_stats"][0]
                stat0 = oc.get_infer_stat()
                t0 = time.monotonic()
                lat = list(pool.map(one, range(CLIENT_OBSERVED)))
                wall = time.monotonic() - t0
            after = hc.get_inference_statistics("bert_base")["model_stats"][0]
            stat1 = oc.get_infer_stat()
            n = (stat1["completed_request_count"]
                 - stat0["completed_request_count"])
            summary["observation"] = {
                "model": "bert_base", "requests": CLIENT_OBSERVED,
                "concurrency": CLIENT_CONCURRENCY,
                "requests_per_s": CLIENT_OBSERVED / wall,
                "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "client_round_trip_ms": (
                    stat1["cumulative_total_request_time_us"]
                    - stat0["cumulative_total_request_time_us"]) / n / 1e3,
                "client_requests": n,
                "client_server_timed": (stat1["reported_request_count"]
                                        - stat0["reported_request_count"]),
                "server_ms": _stats_split(before, after),
                "server_executions": (after["execution_count"]
                                      - before["execution_count"])}
        finally:
            oc.close()
    finally:
        gc.close()
        hc.close()
    summary["modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in CHILD_FORBIDDEN)
    np.savez(os.path.join(workdir, "outputs.npz"), **out)
    Path(workdir, "summary.json").write_text(json.dumps(summary))
    print(f"{len(out)} answers, modules of torch / jax / client_tpu "
          f"loaded: {summary['modules']}", flush=True)
    return 0


def clients_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The port's own clients in another process against the port's
    servers: one engine with ``bert_base``, ``bert_long``,
    ``tiny_gpt_long``, ``dlrm_mlperf`` (2 shards on the card, K3) and
    ``simple`` behind HTTP and gRPC, launch counts set to 0 just before the
    child starts and read just after it exits. Every answer is held against
    the same request through the script's own wire code or the plain path.
    ``device`` is for a dry run of the phase's logic on the CPU."""
    import tempfile

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    repo = build_repository(list(CLIENT_MODELS))
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    names = engine.repository.names()
    print(f"clients: {names} up in {time.monotonic() - t_phase:.1f} s on "
          f"{device}", flush=True)
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_clients_",
                                    dir=root / "build"))
    channel, stub = _grpc_channel(grpc_server.url)

    def executions(name):
        return engine.model_statistics(name)["model_stats"][0][
            "execution_count"]

    try:
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        arrays = _client_inputs(seq)
        np.savez(workdir / "inputs.npz", **arrays)
        (workdir / "models.json").write_text(json.dumps(names))

        # Counted: what the child's requests launch, and nothing else.
        e_long, e_dlrm = executions("bert_long"), executions(DLRM_MODEL)
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, str(root / "chip_smoke.py"), "--clients-child",
             str(workdir), server.url, grpc_server.url], cwd=root,
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
        child_s = time.monotonic() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        long_execs = executions("bert_long") - e_long
        dlrm_execs = executions(DLRM_MODEL) - e_dlrm
        for line in proc.stdout.splitlines():
            print(f"clients: child: {line}", flush=True)
        _check(proc.returncode == 0, f"the client process exited "
               f"{proc.returncode}: {proc.stderr[-4000:]}")
        out = dict(np.load(workdir / "outputs.npz"))
        summary = json.loads((workdir / "summary.json").read_text())
        _check(summary["modules"] == [], "the client process loaded "
               f"{summary['modules']}")
        print(f"clients: the child ran {child_s:.1f} s with the port's "
              "clients alone (no torch, jax or client_tpu module loaded); "
              f"launches {launches}; bert_long {long_execs} executions, "
              f"{DLRM_MODEL} {dlrm_execs}", flush=True)

        # Health, metadata and config of every model, over both.
        _check(summary["health"] == [True] * 4, f"health {summary['health']}")
        for m in names:
            got = summary["models"][m]
            want_inputs = [t.name for t in engine.repository.get(m)
                           .config.input]
            _check(got == [True, True, m, m, m, m, want_inputs, want_inputs],
                   f"{m}: metadata / config over the clients: {got}")

        # bert_long one at a time: bit for bit against the script's own
        # wire code at the same bucket (one row alone).
        hand = []
        for i in range(8):
            ids, mask = arrays[f"ids{i}"], arrays[f"mask{i}"]
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                server.port, "/v2/models/bert_long/infer", body, headers)
            _check(status == 200, f"bert_long: HTTP {status}")
            hand.append(_parse_response(rheaders, data))
            if i < 4:
                via_grpc = _grpc_outputs(stub.ModelInfer(_grpc_request(
                    "bert_long", {"input_ids": ids, "attention_mask": mask}),
                    timeout=GRPC_TIMEOUT_S))
                for n in BERT_OUTPUTS:
                    _check(out[f"http_one{i}_{n}"].tobytes()
                           == hand[i][n].tobytes(),
                           f"bert_long {i} {n}: HTTP client differs from "
                           "the hand-built request")
                    _check(out[f"grpc_one{i}_{n}"].tobytes()
                           == via_grpc[n].tobytes(),
                           f"bert_long {i} {n}: gRPC client differs from "
                           "the hand-built request")
        errs = [float(np.abs(out[f"http_many{i}_{n}"] - hand[i][n]).max())
                for i in range(8) for n in BERT_OUTPUTS]
        exact = sum(out[f"http_many{i}_{n}"].tobytes() == hand[i][n].tobytes()
                    for i in range(8) for n in BERT_OUTPUTS)
        _check(max(errs) <= KERNEL_ATOL, f"bert_long at once: max error "
               f"{max(errs)} against one at a time (tolerance {KERNEL_ATOL})")
        print(f"clients: bert_long: 4 one at a time over each client bit for "
              f"bit against the hand-built requests; 8 at once "
              f"(async_infer) within {max(errs):.3g} of one at a time "
              f"(tolerance {KERNEL_ATOL}), {exact}/16 outputs exact",
              flush=True)

        # Streams: token for token against the plain path run directly.
        served = engine.repository.get("tiny_gpt_long").backend
        oracle = TinyGptBackend(
            name="tiny_gpt_long", max_seq_len=served.max_seq_len,
            max_streams=served.max_streams, attention_impl="einsum",
            attn_impl="reference", device=device)
        arena = oracle.init_arena(1)
        for i in range(len(CLIENT_PROMPTS)):
            want = _direct_stream(torch, oracle, arena,
                                  arrays[f"prompt{i}"].tolist(),
                                  CLIENT_TOKENS, {}, device=device.type)
            _check(out[f"stream{i}"].tolist() == want,
                   f"stream {i} (prompt of {CLIENT_PROMPTS[i]}): "
                   f"{out[f'stream{i}'].tolist()} != direct {want}")
        del oracle, arena
        print(f"clients: {len(CLIENT_PROMPTS)} greedy tiny_gpt_long streams "
              f"of {CLIENT_TOKENS} tokens (prompts {CLIENT_PROMPTS}) on one "
              "gRPC stream equal the plain path, token for token", flush=True)

        # dlrm_mlperf: bit for bit against the hand-built request.
        for i in range(CLIENT_DLRM):
            arrs = {k: arrays[f"dlrm{i}_{k}"]
                    for k in ("DENSE", "INDICES", "OFFSETS")}
            status, want = _http_infer(server.port, DLRM_MODEL, arrs, True)
            _check(status == 200, f"{DLRM_MODEL}: HTTP {status}: {want}")
            _check(out[f"dlrm{i}"].tobytes() == want["OUTPUT0"].tobytes(),
                   f"{DLRM_MODEL} request {i} ({'shm' if i % 2 else 'inline'}"
                   f"): {out[f'dlrm{i}']} != {want['OUTPUT0']}")
        _check(list(summary["shm_status"]) == ["clients_dlrm"],
               f"shm status {summary['shm_status']}")
        print(f"clients: {DLRM_MODEL}: {CLIENT_DLRM} one-row requests, half "
              "with inputs in system shm, bit for bit against the hand-built "
              "request", flush=True)

        words = "invalid model version '{}'"
        want = [["400", words.format("abc")],
                ["StatusCode.INVALID_ARGUMENT", words.format("abc")],
                ["400", words.format("0")],
                ["StatusCode.INVALID_ARGUMENT", words.format("0")]]
        _check(summary["versions"] == want, f"bad versions: "
               f"{summary['versions']}")
        _check(summary["version_01"] == [True, True],
               f"version '01': {summary['version_01']}")
        print("clients: a bad model version answers 400 / INVALID_ARGUMENT "
              "with the reference's words on both frontends; '01' serves "
              "version 1", flush=True)

        if device.type == "cuda":
            n_layers = len(engine.repository.get("bert_long").backend.layers)
            _check(launches["flash_attention"] == n_layers * long_execs > 0,
                   f"K1 bf16: {launches['flash_attention']} launches for "
                   f"{long_execs} bert_long batches")
            _check(launches["ring_all_reduce"] == dlrm_execs > 0,
                   f"K3: {launches['ring_all_reduce']} launches for "
                   f"{dlrm_execs} {DLRM_MODEL} executions")
            _check(launches["flash_attention_fp32"] > 0
                   and launches["flash_attention_fp32"] % 4 == 0,
                   f"K1 fp32 launches {launches['flash_attention_fp32']}")
            _check(launches["decode_wave_attention"]
                   >= 4 * (CLIENT_TOKENS - 1)
                   and launches["decode_wave_attention"] % 4 == 0,
                   f"K2 launches {launches['decode_wave_attention']}")
        observation = {**summary["observation"], "card": smi}
        print(f"clients observation: {json.dumps(observation)}", flush=True)
        print(f"clients: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"launches {launches}", flush=True)
        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- repository phase ----------------------------------------------------------

REPO_STREAMS = 4      # tiny_gpt_long streams open when it unloads
REPO_STREAM_WAIT_S = 10.0  # each must end with an error within this
REPO_CYCLES = 5       # bert_long unload/load cycles of the leak check
REPO_FREED = 0.9      # share of bert_long's bytes an unload must free
REPO_LEAK = 0.01      # memory growth allowed over the cycles
REPO_TOKENS = 16      # tokens of each stream after the reload


def _write_config(root: Path, name: str, cfg: dict,
                  versions: tuple = ()) -> None:
    mdir = root / name
    mdir.mkdir(exist_ok=True)
    (mdir / "config.json").write_text(json.dumps(cfg))
    for v in versions:
        (mdir / str(v)).mkdir(exist_ok=True)


def _repository_dir(root: Path, torch) -> None:
    """The phase's directory repository: ``config.json`` files from the
    zoo's own configs (``bert_long`` with ``version_policy: all`` and
    versions 1 and 2), a second ensemble sharing ``ensemble_bert``'s first
    two steps, and a copy of the repo's ``models/``."""
    from client_tpu_torch.models import _REGISTRY, _import_all
    from client_tpu_torch.models.dlrm import DlrmBackend

    _import_all()
    cpu = torch.device("cpu")
    for name in ("tiny_gpt_long", "dlrm_cached", "bert_preprocess",
                 "bert_base", "bert_postprocess", "ensemble_bert"):
        _write_config(root, name,
                      _REGISTRY[name](cpu).config.config_dict())
    cfg = _REGISTRY["bert_long"](cpu).config.config_dict()
    _write_config(root, "bert_long", {**cfg, "version_policy": {"all": {}}},
                  versions=(1, 2))
    # Only the config of the MLPerf DLRM: a one-row table builds it.
    small = DlrmBackend(name=DLRM_MODEL, device=cpu, **{
        **MLPERF_DLRM, "table_rows": 1, "emb_shards": 0})
    _write_config(root, DLRM_MODEL, small.config.config_dict())
    ens = _REGISTRY["ensemble_bert"](cpu).config.config_dict()
    steps = ens["ensemble_scheduling"]["step"]
    _write_config(root, "ensemble_bert_logits", {
        **ens, "name": "ensemble_bert_logits",
        "output": [{"name": "LOGITS", "data_type": "TYPE_FP32",
                    "dims": [2]}],
        "ensemble_scheduling": {"step": [
            steps[0], {**steps[1], "output_map": {"logits": "LOGITS"}}]}})
    for entry in (Path(__file__).resolve().parent / "models").iterdir():
        shutil.copytree(entry, root / entry.name)


def _device_bytes(model) -> int:
    backend = model.backend
    return sum(t.numel() * t.element_size()
               for t in (*backend.parameters(), *backend.buffers()))


def _allocated(torch, device) -> int:
    """``torch.cuda.memory_allocated`` once nothing refers to the dropped
    tensors (0 on the CPU). It counts cuBLAS's workspaces, one for each
    (handle, stream) pair that has run, which no unload gives back: a
    reload that made new pairs would show here as growth."""
    import gc

    gc.collect()
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _repo_post(port: int, path: str, body: dict | None = None):
    status, _, data = _post(port, path,
                            json.dumps(body).encode() if body else b"")
    return status, (json.loads(data) if data else None)


def _open_stream(port: int, prompt: list, max_tokens: int,
                 first: threading.Event) -> dict:
    """A ``tiny_gpt_long`` /generate_stream read in this thread until it
    ends; ``first`` is set on its first token. Returns its tokens, the
    error event's words and the monotonic time it ended."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    out = {"tokens": [], "error": None, "end": None}
    try:
        conn.request("POST", "/v2/models/tiny_gpt_long/generate_stream",
                     json.dumps({"inputs": [{
                         "name": "INPUT_IDS", "datatype": "INT32",
                         "shape": [len(prompt)], "data": prompt}],
                         "parameters": {"max_tokens": max_tokens}}).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"stream: HTTP {resp.status}")
        buf = b""
        while True:
            data = resp.read1(65536)
            if not data:
                break
            buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                head = json.loads(event[len(b"data: "):])
                if "error" in head:
                    out["error"] = head["error"]
                    continue
                outs = {o["name"]: o["data"] for o in head["outputs"]}
                out["tokens"] += outs["TOKEN"]
                first.set()
    finally:
        out["end"] = time.monotonic()
        first.set()
        conn.close()
    return out


def _bert_long_checks(torch, engine, port: int, stub, device) -> dict:
    """Both versions over both frontends, bit for bit alike and within
    ``SERVED_ATOL`` of the plain path (a whole 12-layer forward against
    the module with plain attention, as the serve phase holds it); K1
    bf16's launches per batch."""
    from client_tpu_torch.ops import flash_attention as fa

    seq = engine.repository.get("bert_long").config.input[0].dims[0]
    rng = np.random.default_rng(12)
    feeds = []
    for _ in range(2):
        ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
        mask = np.ones((1, seq), np.int32)
        mask[0, rng.integers(seq // 4, seq + 1):] = 0
        feeds.append((ids, mask))

    def executions(version):
        return engine.model_statistics("bert_long", version)["model_stats"][
            0]["execution_count"]

    e0 = {v: executions(v) for v in ("1", "2")}
    k0 = fa.launches
    answers = {}
    for v in ("1", "2"):
        for i, (ids, mask) in enumerate(feeds):
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                port, f"/v2/models/bert_long/versions/{v}/infer", body,
                headers)
            _check(status == 200, f"bert_long v{v}: HTTP {status}: "
                   f"{data[:300]!r}")
            answers[("http", v, i)] = _parse_response(rheaders, data)
            req = _grpc_request("bert_long", {"input_ids": ids,
                                              "attention_mask": mask})
            req.model_version = v
            answers[("grpc", v, i)] = _grpc_outputs(
                stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S))
    batches = sum(executions(v) - e0[v] for v in ("1", "2"))
    launches = fa.launches - k0
    n_layers = len(engine.repository.get("bert_long").backend.layers)
    if device.type == "cuda":
        _check(batches == 8 and launches == n_layers * batches,
               f"K1 bf16: {launches} launches for {batches} bert_long "
               f"batches of two versions ({n_layers} a batch)")
    names = [tc.name for tc in engine.repository.get("bert_long")
             .config.output]
    for (wire, v, i), out in answers.items():
        for n in names:
            _check(out[n].tobytes() == answers[("http", "1", i)][n]
                   .tobytes(), f"bert_long {wire} v{v} request {i} {n}: "
                   "not bit for bit the HTTP v1 answer")
    errs = []
    with torch.inference_mode():
        for i, (ids, mask) in enumerate(feeds):
            model = engine.repository.get("bert_long", "2")
            ref = model.backend.encode(
                {"input_ids": torch.from_numpy(ids).to(device),
                 "attention_mask": torch.from_numpy(mask).to(device)},
                fa.flash_attention_plain)
            errs += [float(np.abs(answers[("http", "2", i)][n]
                                  - ref[n].float().cpu().numpy()).max())
                     for n in names]
    _check(fa.launches - k0 == launches, "the plain path launched K1")
    # The serve phase's comparison and tolerance: a whole 12-layer forward
    # through K1 against the same module with plain attention.
    _check(max(errs) <= SERVED_ATOL, f"bert_long against the plain path: "
           f"{max(errs)} (tolerance {SERVED_ATOL})")
    print(f"repository: bert_long versions 1 and 2 over /versions/<v> and "
          f"gRPC model_version: 8 batches, K1 bf16 {launches} launches; "
          f"every answer bit for bit alike across versions and frontends, "
          f"within {max(errs):.3g} of the plain path (tolerance "
          f"{SERVED_ATOL})", flush=True)
    return {"feed": feeds[0], "answer": answers[("http", "1", 0)]}


def repository_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Repository control on one engine behind HTTP and gRPC, serving a
    directory repository written for the phase: ``bert_long`` (versions 1
    and 2, K1 bf16), ``tiny_gpt_long`` (K1 fp32, K2), ``dlrm_mlperf`` (2
    shards, K3), ``dlrm_cached``, ``ensemble_bert`` with its steps, a
    second ensemble sharing two of them, and both SSDs of ``models/``,
    at their registered sizes. Models are unloaded, loaded and reloaded
    over both frontends while every kernel is counted; the card memory an
    unload gives back and the growth over ``REPO_CYCLES`` unload/load
    cycles are read with ``torch.cuda.memory_allocated``. ``device`` is
    for a dry run of the phase's logic on the CPU."""
    import tempfile

    import grpc

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY, register_model
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.protocol import grpc_service_pb2 as pb
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"
    register_model(DLRM_MODEL, default=False)(lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_repository_"))
    engine = server = grpc_server = channel = None
    try:
        _repository_dir(root, torch)
        engine = TorchEngine(ModelRepository.from_directory(str(root)),
                             device=device)
        server = HttpInferenceServer(engine, port=0).start()
        grpc_server = GrpcInferenceServer(engine, port=0).start()
        channel, stub = _grpc_channel(grpc_server.url)
        index = engine.repository_index()
        _check(all(e["state"] == "READY" for e in index),
               f"a model of the directory did not load: {index}")
        print(f"repository: {len(index)} rows READY from {root} in "
              f"{time.monotonic() - t_phase:.1f} s on {device}: "
              f"{[(e['name'], e['version']) for e in index]}", flush=True)
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0

        # bert_long: two versions, then an unload over HTTP.
        first = _bert_long_checks(torch, engine, server.port, stub, device)
        freed_bytes = sum(_device_bytes(m) for m in
                          engine.repository.loaded_versions(
                              "bert_long").values())
        before = _allocated(torch, device)
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/unload")
        _check(status == 200, f"unload bert_long: HTTP {status}")
        after = _allocated(torch, device)
        body, headers = _binary_request(*first["feed"])
        status, _, data = _post(server.port, "/v2/models/bert_long/infer",
                                body, headers)
        _check(status == 400 and json.loads(data)["error"]
               == "model 'bert_long' is not ready",
               f"bert_long unloaded: HTTP {status} {data[:200]!r}")
        if cuda:
            _check(before - after >= REPO_FREED * freed_bytes,
                   f"unloading bert_long freed {before - after} bytes of "
                   f"its {freed_bytes}")
        print(f"repository: bert_long unloaded over HTTP (then 400 'not "
              f"ready'): memory_allocated {before} -> {after} bytes, "
              f"{before - after} freed of its 2 versions' {freed_bytes} "
              f"parameter and buffer bytes (at least {REPO_FREED:.0%} "
              f"required); {smi}", flush=True)

        # Load over gRPC; then 3/ under latest-2: 2 and 3 serve, 1 retires.
        stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
            model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
        status, rheaders, data = _post(
            server.port, "/v2/models/bert_long/versions/1/infer", body,
            headers)
        _check(status == 200, f"bert_long reloaded: HTTP {status}")
        for n, got in _parse_response(rheaders, data).items():
            _check(got.tobytes() == first["answer"][n].tobytes(),
                   f"bert_long {n} after the reload differs")
        kept = engine.repository.get("bert_long", "2")
        (root / "bert_long" / "3").mkdir()
        cfg = json.loads((root / "bert_long" / "config.json").read_text())
        cfg["version_policy"] = {"latest": {"num_versions": 2}}
        (root / "bert_long" / "config.json").write_text(json.dumps(cfg))
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/load")
        _check(status == 200, f"load bert_long with 3/: HTTP {status}")
        versions = engine.model_metadata("bert_long")["versions"]
        _check(versions == ["2", "3"] and engine.repository.get(
            "bert_long", "2") is kept, f"after 3/: versions {versions}")
        status, _, data = _post(
            server.port, "/v2/models/bert_long/versions/1/infer", body,
            headers)
        _check(status == 404 and json.loads(data)["error"]
               == "model 'bert_long' has no version '1'",
               f"retired version 1: HTTP {status} {data[:200]!r}")
        for v in ("3", ""):
            path = f"/v2/models/bert_long{'/versions/' + v if v else ''}/infer"
            status, rheaders, data = _post(server.port, path, body, headers)
            _check(status == 200, f"bert_long {path}: HTTP {status}")
            for n, got in _parse_response(rheaders, data).items():
                _check(got.tobytes() == first["answer"][n].tobytes(),
                       f"bert_long v{v or 'latest'} {n} differs")
        del kept
        print("repository: bert_long loaded over gRPC serves v1 bit for bit "
              "as before; with 3/ and latest-2 a load serves 2 (kept, not "
              "rebuilt) and 3, and v1 answers 404 'has no version'",
              flush=True)

        # The leak check: unload/load cycles over both frontends.
        readings = []
        for cycle in range(REPO_CYCLES):
            if cycle % 2:
                stub.RepositoryModelUnload(pb.RepositoryModelUnloadRequest(
                    model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
                stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
                    model_name="bert_long"), timeout=GRPC_TIMEOUT_S)
            else:
                for op in ("unload", "load"):
                    status, _ = _repo_post(
                        server.port, f"/v2/repository/models/bert_long/{op}")
                    _check(status == 200, f"{op} bert_long: HTTP {status}")
            status, rheaders, data = _post(
                server.port, "/v2/models/bert_long/infer", body, headers)
            _check(status == 200, f"bert_long cycle {cycle}: HTTP {status}")
            readings.append(_allocated(torch, device))
        growth = (readings[-1] - readings[0]) / max(1, readings[0])
        if cuda:
            _check(abs(growth) <= REPO_LEAK,
                   f"memory over {REPO_CYCLES} unload/load cycles: "
                   f"{readings}")
        print(f"repository: {REPO_CYCLES} unload/load cycles of bert_long "
              f"(HTTP and gRPC, one request each): memory_allocated "
              f"{readings} bytes, {growth:+.4%} from the first to the last "
              f"(at most {REPO_LEAK:.0%}); {smi}", flush=True)

        _gpt_checks(torch, engine, server.port, grpc_server.url, device,
                    TinyGptBackend)
        _repo_dlrm_checks(torch, engine, server.port, stub)

        # Ensembles: ensemble_bert's own step goes, the shared ones stay.
        text = np.array([[b"a chip check"]], dtype=np.object_)
        want = _http_infer(server.port, "ensemble_bert_logits",
                           {"TEXT": text}, True)
        _check(want[0] == 200, f"ensemble_bert_logits: {want}")
        status, _ = _repo_post(
            server.port, "/v2/repository/models/ensemble_bert/unload",
            {"parameters": {"unload_dependents": True}})
        _check(status == 200, f"unload ensemble_bert: HTTP {status}")
        states = {e["name"]: e["state"] for e in engine.repository_index()}
        _check([states[m] for m in (
            "ensemble_bert", "bert_postprocess", "bert_preprocess",
            "bert_base", "ensemble_bert_logits")] == [
            "UNAVAILABLE", "UNAVAILABLE", "READY", "READY", "READY"],
            f"after unload_dependents: {states}")
        got = _http_infer(server.port, "ensemble_bert_logits",
                          {"TEXT": text}, True)
        _check(got[0] == 200 and got[1]["LOGITS"].tobytes()
               == want[1]["LOGITS"].tobytes(),
               f"ensemble_bert_logits after the unload: {got}")
        print("repository: ensemble_bert unloaded with unload_dependents "
              "took bert_postprocess and left bert_preprocess and bert_base,"
              " which ensemble_bert_logits still names (it serves bit for "
              "bit as before)", flush=True)

        # The directory's SSDs, and the index on both frontends.
        img = np.random.default_rng(9).integers(
            0, 255, (1, 300, 300, 3)).astype(np.uint8)
        for name in SSD_MODELS:
            status, out = _http_infer(
                server.port, name, {"normalized_input_image_tensor": img},
                True)
            _check(status == 200 and out["TFLite_Detection_PostProcess"]
                   .shape == (1, 1, 10, 4), f"{name}: {status} {out}")
        index = engine.repository_index()
        status, over_http = _repo_post(server.port, "/v2/repository/index")
        over_grpc = [{k: v for k, v in (
            ("name", m.name), ("version", m.version), ("state", m.state),
            ("reason", m.reason)) if v} for m in stub.RepositoryIndex(
                pb.RepositoryIndexRequest(), timeout=GRPC_TIMEOUT_S).models]
        _check(status == 200 and over_http == index == over_grpc,
               f"index: engine {index}, HTTP {over_http}, gRPC {over_grpc}")
        try:
            stub.RepositoryModelLoad(pb.RepositoryModelLoadRequest(
                model_name="no_such_model"), timeout=GRPC_TIMEOUT_S)
            code = None
        except grpc.RpcError as exc:
            code = exc.code()
        _check(code == grpc.StatusCode.NOT_FOUND, f"unknown load: {code}")
        print(f"repository: both SSDs of models/ serve; the index ({len(index)}"
              " rows) is the engine's over HTTP and gRPC", flush=True)

        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        if cuda:
            _check(all(launches.values()),
                   f"a kernel did not run in the phase: {launches}")
        print(f"repository: phase passed in {time.monotonic() - t_phase:.1f}"
              f" s; launches {launches}; {smi}", flush=True)
        return launches
    finally:
        if channel is not None:
            channel.close()
        for srv in (grpc_server, server):
            if srv is not None:
                srv.stop()
        if engine is not None:
            engine.shutdown()
        _REGISTRY.pop(DLRM_MODEL, None)
        shutil.rmtree(root, ignore_errors=True)


def _gpt_checks(torch, engine, port: int, grpc_url: str, device,
                gpt_cls) -> None:
    """``tiny_gpt_long``: unloaded with ``REPO_STREAMS`` streams open (each
    ends with an error), then reloaded: greedy streams over HTTP and gRPC
    token for token against the plain path (K1 fp32, K2)."""
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(14)
    firsts = [threading.Event() for _ in range(REPO_STREAMS)]
    with concurrent.futures.ThreadPoolExecutor(REPO_STREAMS) as pool:
        futures = [pool.submit(_open_stream, port,
                               rng.integers(0, 512, 5).tolist(), 2000, f)
                   for f in firsts]
        for f in firsts:
            _check(f.wait(120), "a stream sent no first token")
        t0 = time.monotonic()
        status, _ = _repo_post(port,
                               "/v2/repository/models/tiny_gpt_long/unload")
        _check(status == 200, f"unload tiny_gpt_long: HTTP {status}")
        ended = [fut.result(timeout=120) for fut in futures]
    for out in ended:
        _check(out["error"] == "server shutting down"
               and out["end"] - t0 <= REPO_STREAM_WAIT_S
               and len(out["tokens"]) < 2000,
               f"an open stream at unload: {len(out['tokens'])} tokens, "
               f"error {out['error']!r}, ended {out['end'] - t0:.2f} s "
               "after the unload began")
    print(f"repository: tiny_gpt_long unloaded with {REPO_STREAMS} streams "
          f"open ({[len(o['tokens']) for o in ended]} tokens in): each "
          f"ended with 'server shutting down' within "
          f"{max(o['end'] for o in ended) - t0:.2f} s", flush=True)

    status, _ = _repo_post(port, "/v2/repository/models/tiny_gpt_long/load")
    _check(status == 200, f"load tiny_gpt_long: HTTP {status}")
    k1, k2 = fa.launches_fp32, da.launches
    prompts = [rng.integers(0, 512, n).tolist() for n in CLIENT_PROMPTS]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        http_toks = list(pool.map(lambda p: _stream(
            port, "tiny_gpt_long", {"inputs": [{
                "name": "INPUT_IDS", "datatype": "INT32", "shape": [len(p)],
                "data": p}], "parameters": {"max_tokens": REPO_TOKENS}})[0],
            prompts[:4]))
    by_id = _grpc_streams(grpc_url, [
        (f"r{i}", "tiny_gpt_long", p, {"max_tokens": REPO_TOKENS})
        for i, p in enumerate(prompts[4:])])
    served = http_toks + [by_id[f"r{i}"][0] for i in range(4)]
    backend = engine.repository.get("tiny_gpt_long").backend
    oracle = gpt_cls(name="tiny_gpt_long", max_seq_len=backend.max_seq_len,
                     max_streams=backend.max_streams,
                     attention_impl="einsum", attn_impl="reference",
                     device=device)
    arena = oracle.init_arena(1)
    for prompt, toks in zip(prompts, served):
        want = _direct_stream(torch, oracle, arena, prompt, REPO_TOKENS, {},
                              device=device.type)
        _check(toks == want, f"reloaded tiny_gpt_long, prompt of "
               f"{len(prompt)}: {toks} != direct {want}")
    del oracle, arena
    n_layers = backend.n_layers
    if device.type == "cuda":
        _check(fa.launches_fp32 - k1 >= n_layers
               and (fa.launches_fp32 - k1) % n_layers == 0
               and da.launches - k2 >= n_layers * (REPO_TOKENS - 1)
               and (da.launches - k2) % n_layers == 0,
               f"reloaded tiny_gpt_long: K1 fp32 {fa.launches_fp32 - k1}, "
               f"K2 {da.launches - k2} launches")
    print(f"repository: tiny_gpt_long reloaded: 8 greedy streams of "
          f"{REPO_TOKENS} tokens (prompts {CLIENT_PROMPTS}; 4 over SSE, 4 on"
          f" one gRPC stream) equal the plain path token for token; K1 fp32 "
          f"{fa.launches_fp32 - k1}, K2 {da.launches - k2} launches",
          flush=True)


def _repo_dlrm_checks(torch, engine, port: int, stub) -> None:
    """``dlrm_mlperf`` reloaded answers bit for bit as before, K3 once an
    execution, and its sharded bag sums (K3) equal the unsharded table's
    bit for bit; a reload of ``dlrm_cached`` empties its row cache."""
    from client_tpu_torch.parallel import emb_shard as es
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.protocol import grpc_service_pb2 as pb

    def executions():
        return engine.model_statistics(DLRM_MODEL)["model_stats"][0][
            "execution_count"]

    rng = np.random.default_rng(27)
    reqs = [_mlperf_csr(rng, rows=1 + i % 3) for i in range(6)]
    k0, e0 = ks.launches, executions()
    before = []
    for r in reqs:
        status, out = _http_infer(port, DLRM_MODEL, r, True)
        _check(status == 200, f"{DLRM_MODEL}: {status} {out}")
        before.append(out["OUTPUT0"])
    stub.RepositoryModelUnload(pb.RepositoryModelUnloadRequest(
        model_name=DLRM_MODEL), timeout=GRPC_TIMEOUT_S)
    status, _ = _repo_post(port, f"/v2/repository/models/{DLRM_MODEL}/load")
    _check(status == 200, f"load {DLRM_MODEL}: HTTP {status}")
    e1 = executions()
    for r, want in zip(reqs, before):
        code, out = _grpc_infer(stub, DLRM_MODEL, r)
        _check(out["OUTPUT0"].tobytes() == want.tobytes(),
               f"{DLRM_MODEL} after the reload: {out['OUTPUT0']} != {want}")
    execs = (e1 - e0) + (executions() - e1)
    if engine.device.type == "cuda":
        _check(ks.launches - k0 == execs == 2 * len(reqs),
               f"K3: {ks.launches - k0} launches for {execs} executions")
    launches = ks.launches - k0

    # The reloaded model against its plain version: sharded bag sums of a
    # full batch against the unsharded table's (this launch is not the
    # phase's).
    backend = engine.repository.get(DLRM_MODEL).backend
    device = engine.device
    batch = _mlperf_csr(np.random.default_rng(28), rows=32)
    staged = {k: torch.from_numpy(v).to(device) for k, v in
              backend.pre_stage(batch, MLPERF_DLRM["max_lookups"]).items()}
    num_seg = MLPERF_DLRM["max_batch_size"] * MLPERF_DLRM["num_tables"]
    with torch.inference_mode():
        sharded = backend.pooled(staged)
        whole = torch.from_numpy(backend.table_host).to(device)
        oracle = es.bag_sum_oracle(whole, staged["INDICES"],
                                   staged["SEG_IDS"], num_seg)
    ks.launches = k0 + launches
    _check(bool(torch.equal(sharded, oracle)),
           f"{DLRM_MODEL} after the reload: sharded bag sums differ from "
           f"the unsharded ones by {float((sharded - oracle).abs().max())}")
    del backend, staged, sharded, whole, oracle
    print(f"repository: {DLRM_MODEL} unloaded over gRPC, loaded over HTTP: "
          f"{len(reqs)} requests bit for bit as before the reload; K3 "
          f"{launches} launches for {execs} executions; pooled over 2 "
          "shards (ring) bit for bit the unsharded table's", flush=True)

    r = _small_csr(np.random.default_rng(8), rows=2)
    cache = engine.repository.get("dlrm_cached").backend.row_cache
    for _ in range(2):
        status, want = _http_infer(port, "dlrm_cached", r, True)
    hits = cache.hits
    status, again = _http_infer(port, "dlrm_cached", r, True)
    _check(cache.hits - hits == int(r["INDICES"].shape[0]) > 0,
           f"dlrm_cached: {cache.hits - hits} hits of a resident request")
    status, _ = _repo_post(port, "/v2/repository/models/dlrm_cached/load")
    _check(status == 200 and cache.snapshot()["resident_rows"] == 0,
           f"dlrm_cached reload: {status} {cache.snapshot()}")
    hits = cache.hits
    status, after = _http_infer(port, "dlrm_cached", r, True)
    _check(cache.hits - hits == 0 and after["OUTPUT0"].tobytes()
           == want["OUTPUT0"].tobytes(),
           f"dlrm_cached after the reload: {cache.hits - hits} hits")
    print(f"repository: dlrm_cached reload emptied its row cache: the same "
          f"request hit {int(r['INDICES'].shape[0])} rows before and 0 "
          "after, the same score", flush=True)


# -- observability phase -------------------------------------------------------

OBS_LONG_HTTP = 4     # bert_long requests over HTTP with a traceparent
OBS_LONG_GRPC = 2     # and over gRPC (one as a parameter, one as metadata)
OBS_STREAMS = 16      # tiny_gpt_long streams: 8 over SSE, 8 on one RPC
OBS_TOKENS = 16
OBS_DLRM = 8          # one-row dlrm_mlperf requests over HTTP
OBS_FAULT_SEED = 5    # model.execute armed at probability 0.5 ...
OBS_FAULTED = 16      # ... over this many bert_long requests
# A phase duration from the span store against Server-Timing (or the
# gRPC server_*_us parameters) of the same request: both are formatted
# from the same stamps, ms to 3 decimals and us floored.
OBS_TIMING_MS = 1.0
# A bucket's counted FLOPs on the card against the same bucket counted
# on the CPU plain path (the kernel's formula against the plain version's
# counted matmuls).
OBS_FLOPS_RTOL = 0.01
OBS_SHARE_MAX = 1.05  # MFU and MBU must lie in (0, this]


def _scrape(port: int, openmetrics: bool = False) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", "/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"}
            if openmetrics else {})
        resp = conn.getresponse()
        body = resp.read().decode()
        _check(resp.status == 200, f"/metrics: HTTP {resp.status}")
        want = ("application/openmetrics-text" if openmetrics
                else "text/plain; version=0.0.4")
        _check(resp.getheader("Content-Type").startswith(want),
               f"/metrics content type {resp.getheader('Content-Type')}")
        _check(body.endswith("# EOF\n") == openmetrics,
               "/metrics: # EOF where it does not belong, or missing")
        return body
    finally:
        conn.close()


def _samples(text: str) -> dict[tuple, float]:
    """{(name, ((label, value), ...)): value} of an exposition, parsed by
    the script itself (an exemplar's ' # ' tail dropped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$",
                     line)
        _check(m is not None, f"/metrics: unparsed line {line!r}")
        labels = tuple(sorted(re.findall(
            r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
            m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _sample_sum(samples: dict, name: str, **labels) -> float:
    want = set(labels.items())
    return sum(v for (n, lab), v in samples.items()
               if n == name and want <= set(lab))


def _trace_spans(port: int, trace_id: str) -> dict[str, float]:
    """{phase: duration ms} of one traced request, from
    ``/v2/trace/requests``."""
    status, data = _get(port, f"/v2/trace/requests?trace_id={trace_id}")
    _check(status == 200, f"/v2/trace/requests: HTTP {status}")
    spans = {e["name"]: e["dur"] / 1e3 for e in data["traceEvents"]
             if e["ph"] == "X"}
    _check(all(e["args"]["trace_id"] == trace_id
               for e in data["traceEvents"]),
           f"trace {trace_id}: another request's spans")
    _check({"queue", "compute_input", "compute_infer",
            "compute_output"} <= set(spans), f"trace {trace_id}: {spans}")
    return spans


def _check_timing(what: str, spans: dict, timing: dict) -> float:
    """The largest gap (ms) between the spans and the response's own
    phase timings; fails past ``OBS_TIMING_MS``."""
    worst = 0.0
    for phase in ("queue", "compute_input", "compute_infer",
                  "compute_output"):
        worst = max(worst, abs(spans[phase] - timing[phase]))
    _check(worst <= OBS_TIMING_MS, f"{what}: spans {spans} against the "
           f"response's timings {timing}")
    return worst


def _obs_bert_inputs(seq: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
    mask = np.ones((1, seq), np.int32)
    mask[0, rng.integers(seq // 4, seq + 1):] = 0
    return ids, mask


def _obs_traffic(port: int, stub, grpc_url: str, seq: int) -> dict:
    """The phase's traced traffic: ``bert_long`` one request at a time
    over HTTP and gRPC with a ``traceparent``, ``tiny_gpt_long`` streams
    over SSE and one RPC, ``dlrm_mlperf`` one request at a time; each
    trace round trip and span set checked. Returns the timing gaps."""
    gaps = []
    for i in range(OBS_LONG_HTTP + OBS_LONG_GRPC):
        trace_id = f"{0xB0 + i:02x}" + "5e" * 15
        tp = f"00-{trace_id}-{i + 1:016x}-01"
        ids, mask = _obs_bert_inputs(seq, i)
        if i < OBS_LONG_HTTP:
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                port, "/v2/models/bert_long/infer", body,
                dict(headers, traceparent=tp))
            _check(status == 200, f"bert_long: HTTP {status}: {data[:200]}")
            echo = rheaders.get("traceparent", "")
            timing = {}
            for entry in rheaders["Server-Timing"].split(","):
                name, _, dur = entry.strip().partition(";dur=")
                timing[name] = float(dur)
        else:
            metadata = (("traceparent", tp),) if i % 2 else ()
            resp = stub.ModelInfer(_grpc_request(
                "bert_long", {"input_ids": ids, "attention_mask": mask},
                parameters=None if i % 2 else {"traceparent": tp}),
                metadata=metadata, timeout=GRPC_TIMEOUT_S)
            params = {k: getattr(v, v.WhichOneof("parameter_choice"))
                      for k, v in resp.parameters.items()}
            echo = params.get("traceparent", "")
            timing = {p: params[f"server_{p}_us"] / 1e3 for p in (
                "queue", "compute_input", "compute_infer",
                "compute_output")}
        _check(echo.split("-")[1:2] == [trace_id] and echo.endswith("-01"),
               f"traceparent {tp} came back as {echo!r}")
        gaps.append(_check_timing(f"bert_long request {i}",
                                  _trace_spans(port, trace_id), timing))
    # At once, so that waves reach the 16-lane bucket.
    rng = np.random.default_rng(41)
    half = OBS_STREAMS // 2
    prompts = [rng.integers(0, 512, CLIENT_PROMPTS[i % len(CLIENT_PROMPTS)])
               .tolist() for i in range(OBS_STREAMS)]
    body = {"parameters": {"max_tokens": OBS_TOKENS}}
    with concurrent.futures.ThreadPoolExecutor(half + 1) as pool:
        sse = [pool.submit(_stream, port, "tiny_gpt_long", dict(
            body, inputs=[{"name": "INPUT_IDS", "datatype": "INT32",
                           "shape": [len(p)], "data": p}]))
               for p in prompts[:half]]
        rpc = pool.submit(_grpc_streams, grpc_url, [
            (f"s{i}", "tiny_gpt_long", p, {"max_tokens": OBS_TOKENS})
            for i, p in enumerate(prompts[half:])])
        toks = [f.result()[0] for f in sse] + [
            rpc.result()[f"s{i}"][0] for i in range(half)]
    _check(all(len(t) == OBS_TOKENS for t in toks),
           f"streams of {[len(t) for t in toks]} tokens")
    rng = np.random.default_rng(42)
    for _ in range(OBS_DLRM):
        status, out = _http_infer(port, DLRM_MODEL, _mlperf_csr(rng), True)
        _check(status == 200 and np.isfinite(out["OUTPUT0"]).all(),
               f"{DLRM_MODEL}: {status} {out}")
    return {"timing_gap_ms": max(gaps)}


def _obs_faults(port: int, stub, seq: int) -> dict:
    """A seeded ``model.execute`` fault fails exactly the requests the
    seed's draws predict; counted on ``/metrics`` and journalled. Then one
    ``http.pre_read`` drop and one ``grpc.pre_infer`` error."""
    import random

    import grpc

    from client_tpu_torch import faults

    before = _samples(_scrape(port))
    cursor = _get(port, "/v2/events?category=fault")[1]["next_seq"]
    rng = random.Random(OBS_FAULT_SEED)
    want = [rng.random() < 0.5 for _ in range(OBS_FAULTED)]
    ids, mask = _obs_bert_inputs(seq, 99)
    body, headers = _binary_request(ids, mask)
    faults.configure({"model.execute": {
        "probability": 0.5, "seed": OBS_FAULT_SEED, "error_status": 503}})
    try:
        got = [_post(port, "/v2/models/bert_long/infer", body, headers)
               for _ in range(OBS_FAULTED)]
    finally:
        faults.reset()
    failed = [g[0] == 503 for g in got]
    _check(failed == want, f"faulted requests {failed}, the seed's draws "
           f"{want}")
    _check(all(g[0] in (200, 503) for g in got), "another status")
    _check(all(json.loads(g[2])["error"] == "injected fault at "
               "model.execute (error, status 503)" for g in got
               if g[0] == 503), "the fault's words")
    n = sum(want)

    # One http.pre_read drop (the connection closes with no answer) and one
    # grpc.pre_infer error; the next request on each answers.
    faults.configure({"http.pre_read": {"drop": True, "max_injections": 1},
                      "grpc.pre_infer": {"error_status": 503,
                                         "max_injections": 1}})
    try:
        try:
            _get(port, "/v2")
            dropped = False
        except (http.client.HTTPException, ConnectionError):
            dropped = True
        try:
            stub.ModelInfer(_grpc_request(
                "bert_long", {"input_ids": ids, "attention_mask": mask}),
                timeout=GRPC_TIMEOUT_S)
            code = None
        except grpc.RpcError as exc:
            code = (exc.code(), exc.details())
    finally:
        faults.reset()
    _check(dropped, "http.pre_read drop: the request was answered")
    _check(code == (grpc.StatusCode.UNAVAILABLE, "injected fault at "
                    "grpc.pre_infer (error, status 503)"),
           f"grpc.pre_infer: {code}")
    _check(_get(port, "/v2")[0] == 200, "HTTP after the drop")

    after = _samples(_scrape(port))
    for site, kind, count in (("model.execute", "error", n),
                              ("http.pre_read", "drop", 1),
                              ("grpc.pre_infer", "error", 1)):
        delta = (_sample_sum(after, "tpu_fault_injections_total",
                             site=site, kind=kind)
                 - _sample_sum(before, "tpu_fault_injections_total",
                               site=site, kind=kind))
        _check(delta == count, f"tpu_fault_injections_total{{{site},{kind}}}"
               f" rose by {delta}, not {count}")
    events = _get(port, f"/v2/events?category=fault&since={cursor}")[1]
    _check(len(events["events"]) == n + 2
           and all(e["name"] == "injected" for e in events["events"]),
           f"/v2/events: {events['events']}")
    return {"failed": n, "pattern": "".join("x" if f else "."
                                            for f in failed)}


def _obs_profile(engine, port: int, cpu_flops: float) -> dict:
    """``/v2/profile``: every bucket used has its executions, rows, one cold
    first execution and a counted roofline; every MFU and MBU on the card
    lies in (0, ``OBS_SHARE_MAX``]; ``bert_long``'s bucket 1 FLOPs equal
    the CPU count; the kernels' share of the counted costs."""
    status, snap = _get(port, "/v2/profile")
    _check(status == 200, f"/v2/profile: HTTP {status}")
    cuda = engine.device.type == "cuda"
    out = {"duty_cycle": snap["duty_cycle"],
           "peaks": snap["roofline"]["peaks"], "buckets": {}}
    shares = []
    for key in ("bert_long:1", DLRM_MODEL + ":1", "tiny_gpt_long:1"):
        entry = snap["models"].get(key)
        _check(entry is not None, f"/v2/profile has no {key}: "
               f"{list(snap['models'])}")
        for b in entry["buckets"]:
            rl = b["roofline"]
            warm = b["executions"] - b["cold_executions"]
            _check(b["cold_executions"] == 1 and b["compilations"] == 1
                   and b["rows"] > 0 and rl["cost_model"] == "counted"
                   and rl["flops_per_call"] > 0 and rl["bytes_per_call"] > 0,
                   f"{key} bucket {b['bucket']}: {b}")
            _check((b["device_s"] > 0) == (warm > 0),
                   f"{key} bucket {b['bucket']}: device_s {b['device_s']} "
                   f"over {warm} warm executions")
            row = {k: b[k] for k in ("executions", "cold_executions", "rows",
                                     "padded_rows", "device_s")}
            row.update({k: rl[k] for k in (
                "flops_per_call", "bytes_per_call", "achieved_flops_per_s",
                "mfu", "mbu")})
            out["buckets"][f"{key}/{b['bucket']}"] = row
            if cuda and warm > 0:
                shares += [(f"{key}/{b['bucket']}", rl["mfu"], rl["mbu"])]
        for w in entry.get("decode_waves", ()):
            rl = w["roofline"]
            row = {k: w[k] for k in ("waves", "dispatches", "device_s",
                                     "wave_ms_p50")}
            row.update({k: rl[k] for k in ("flops_per_call", "bytes_per_call",
                                           "mfu", "mbu")})
            out["buckets"][f"{key}/wave{w['bucket']}"] = row
            # A wave shape's first dispatch is cold (counted, its time kept
            # out): a shape used once has no device time.
            _check(rl["cost_model"] == "counted"
                   and (w["device_s"] > 0) == (w["dispatches"] > 1),
                   f"{key} wave bucket {w['bucket']}: {w}")
            if cuda and w["dispatches"] > 1:
                shares += [(f"{key}/wave{w['bucket']}", rl["mfu"], rl["mbu"])]
    for what, mfu, mbu in shares:
        _check(mfu is not None and mbu is not None
               and 0 < mfu <= OBS_SHARE_MAX and 0 < mbu <= OBS_SHARE_MAX,
               f"{what}: MFU {mfu}, MBU {mbu} outside (0, {OBS_SHARE_MAX}]")
    _check(not cuda or shares, "no bucket with a warm execution")

    # bert_long, bucket 1: the card's count (counter + K1's report) against
    # the CPU plain path's (counter over the plain attention's matmuls).
    card = out["buckets"]["bert_long:1/1"]["flops_per_call"]
    _check(abs(card - cpu_flops) <= OBS_FLOPS_RTOL * cpu_flops,
           f"bert_long bucket 1: {card:.6e} FLOPs counted on "
           f"{engine.device}, {cpu_flops:.6e} on the CPU")
    out["bert_long_flops"] = {"device": card, "cpu": cpu_flops}

    # The hand-written kernels' share of the counted costs: K2's arena
    # reads in every wave shape's bytes, and on the card K1's and K2's
    # FLOPs, which the FLOP counter cannot see through ctypes.
    costs = engine.profiler.cost_models()
    waves = {k: c for k, c in costs.items()
             if k[0] == "tiny_gpt_long" and len(k) == 4}
    long_cost = costs[("bert_long", "1", 1)]
    _check(waves and all(c["kernel_bytes"] > 0 and (
        not cuda or c["kernel_flops"] > 0) for c in waves.values()),
           f"tiny_gpt_long wave costs {waves}")
    _check(long_cost["kernel_bytes"] > 0
           and (not cuda or long_cost["kernel_flops"] > 0),
           f"bert_long bucket 1 cost {long_cost}")
    out["kernel_share"] = {
        "bert_long/1": {k: long_cost[k] for k in (
            "kernel_flops", "kernel_bytes", "flops", "bytes_accessed")},
        **{f"tiny_gpt_long/wave{k[2]}": {n: c[n] for n in (
            "kernel_flops", "kernel_bytes", "flops", "bytes_accessed")}
           for k, c in waves.items()}}
    return out


def _trace_cost_us(n: int = 20_000) -> float:
    """Host microseconds the tracing of one HTTP request costs the
    server, timed on this host: adopting its ``traceparent``, snapshotting
    its spans into the ring, and writing its ``traceparent`` and
    ``Server-Timing`` headers."""
    from client_tpu_torch.engine.types import RequestTimes
    from client_tpu_torch.observability.tracing import (
        TraceContext,
        TraceStore,
        build_request_trace,
        server_timing_header,
    )

    store = TraceStore(512)
    times = RequestTimes(received=1, queue_start=2, compute_start=3,
                         compute_input_end=4, compute_infer_end=5,
                         compute_output_end=6)
    header = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    t0 = time.perf_counter()
    for _ in range(n):
        ctx = TraceContext.from_traceparent(header)
        store.add(build_request_trace(ctx, "bert_long", "", times, True))
        ctx.to_traceparent()
        server_timing_header(times)
    return (time.perf_counter() - t0) / n * 1e6


def _cpu_bucket_flops(torch, served, seq: int) -> float:
    """``bert_long``'s FLOPs for one row counted on the CPU: the same
    model (dims read from the served one), its attention the plain
    version's torch ops."""
    from client_tpu_torch.models.bert import BertBackend
    from client_tpu_torch.observability.roofline import CostCapture

    cpu = BertBackend(
        name="bert_long_cpu", seq_len=seq,
        hidden=served.pooler.in_features, n_layers=len(served.layers),
        n_heads=served.n_heads, ffn=served.layers[0].w1.out_features,
        vocab=served.tok_embed.shape[0], attention_impl="flash",
        device="cpu")
    ids, mask = _obs_bert_inputs(seq, 0)
    with torch.inference_mode(), CostCapture(cpu) as cap:
        cpu({"input_ids": torch.from_numpy(ids),
             "attention_mask": torch.from_numpy(mask)})
    return cap.result()["flops"]


def observability_phase(torch, smi: str, device: str = "cuda") -> dict:
    """The metrics, tracing, fault and efficiency planes on one engine with
    ``bert_long`` (K1 bf16), ``tiny_gpt_long`` (K1 fp32, K2) and
    ``dlrm_mlperf`` (2 shards, K3) behind HTTP and gRPC. ``/metrics`` in
    both formats before and after the traffic: its deltas are what was
    sent, and each kernel launched its count per execution read there.
    ``device`` is for a dry run of the phase's logic on the CPU."""
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.dlrm import DlrmBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    repo = build_repository(["bert_long", "tiny_gpt_long"])
    repo.register(DLRM_MODEL, lambda dev: DlrmBackend(
        name=DLRM_MODEL, device=dev, emb_devices=[dev] * 2, **MLPERF_DLRM))
    engine = TorchEngine(repo, device=device)
    # The profiler is process-global, and the earlier phases' engines
    # recorded into it: this phase reads its own records only, as a fresh
    # server process would.
    engine.profiler.reset()
    server = HttpInferenceServer(engine, port=0).start()
    grpc_server = GrpcInferenceServer(engine, port=0).start()
    channel, stub = _grpc_channel(grpc_server.url)
    models = ("bert_long", "tiny_gpt_long", DLRM_MODEL)
    print(f"observability: {list(models)} up in "
          f"{time.monotonic() - t_phase:.1f} s on {device}", flush=True)
    try:
        backend = engine.repository.get("bert_long").backend
        seq = engine.repository.get("bert_long").config.input[0].dims[0]
        t0 = time.monotonic()
        cpu_flops = _cpu_bucket_flops(torch, backend, seq)
        print(f"observability: bert_long, one row counted on the CPU in "
              f"{time.monotonic() - t0:.1f} s: {cpu_flops:.6e} FLOPs",
              flush=True)
        before = {om: _scrape(server.port, om) for om in (False, True)}
        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        t0 = time.monotonic()
        traffic = _obs_traffic(server.port, stub, grpc_server.url, seq)
        mid = _samples(_scrape(server.port))
        faulted = _obs_faults(server.port, stub, seq)
        # Disarmed: bert_long answers within the serve phase's tolerance of
        # the same module with its attention the plain version.
        ids, mask = _obs_bert_inputs(seq, 7)
        status, rheaders, data = _post(
            server.port, "/v2/models/bert_long/infer",
            *_binary_request(ids, mask))
        _check(status == 200, f"bert_long after the faults: HTTP {status}")
        got = _parse_response(rheaders, data)
        with torch.inference_mode():
            ref = backend.encode({
                "input_ids": torch.from_numpy(ids).to(device),
                "attention_mask": torch.from_numpy(mask).to(device)},
                fa.flash_attention_plain)
        err = max(float(np.abs(got[n] - ref[n].float().cpu().numpy()).max())
                  for n in BERT_OUTPUTS)
        _check(err <= SERVED_ATOL, f"bert_long after the faults: {err} off "
               f"the plain path (tolerance {SERVED_ATOL})")
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}
        traffic_s = time.monotonic() - t0
        after = {om: _scrape(server.port, om) for om in (False, True)}

        # /metrics: the deltas are what was sent and executed.
        b, a = _samples(before[False]), _samples(after[False])

        def delta(name, model, samples=a):
            return (_sample_sum(samples, name, model=model)
                    - _sample_sum(b, name, model=model))

        sent = {"bert_long": OBS_LONG_HTTP + OBS_LONG_GRPC,
                "tiny_gpt_long": OBS_STREAMS, DLRM_MODEL: OBS_DLRM}
        execs = {}
        for m in models:
            ok = delta("tpu_inference_request_success", m, mid)
            _check(ok == sent[m], f"{m}: {ok} successes on /metrics after "
                   f"the traffic, {sent[m]} sent")
            execs[m] = delta("tpu_inference_exec_count", m)
            _check(execs[m] == delta("tpu_batch_size_count", m) > 0,
                   f"{m}: {execs[m]} executions, "
                   f"{delta('tpu_batch_size_count', m)} batch sizes")
        ok = delta("tpu_inference_request_success", "bert_long")
        _check(ok == sent["bert_long"] + OBS_FAULTED - faulted["failed"] + 1,
               f"bert_long: {ok} successes over the phase")
        fails = delta("tpu_inference_request_failure", "bert_long")
        _check(fails == faulted["failed"], f"bert_long: {fails} failures, "
               f"{faulted['failed']} injected")
        _check(execs["bert_long"] == ok and execs[DLRM_MODEL] == OBS_DLRM,
               f"executions {execs}: one a request, one at a time")
        om_after = _samples(after[True])
        _check(_sample_sum(om_after, "tpu_inference_exec_count") == 0
               and _sample_sum(om_after, "tpu_batch_size_count",
                               model="bert_long")
               == _sample_sum(a, "tpu_batch_size_count", model="bert_long"),
               "OpenMetrics: the legacy block is 0.0.4 only; the "
               "histograms agree")

        # Each kernel's launches: its count per execution read on /metrics.
        status, snap = _get(server.port, "/v2/profile?model=tiny_gpt_long")
        waves = sum(w["dispatches"] for w in snap["models"][
            "tiny_gpt_long:1"]["decode_waves"])
        gpt = engine.repository.get("tiny_gpt_long").backend
        per = {"flash_attention": (len(backend.layers), execs["bert_long"]),
               "flash_attention_fp32": (gpt.n_layers,
                                        execs["tiny_gpt_long"] - waves),
               "decode_wave_attention": (gpt.n_layers, waves),
               "ring_all_reduce": (1, execs[DLRM_MODEL])}
        if device.type == "cuda":
            for name, (k, n) in per.items():
                _check(launches[name] == k * n > 0,
                       f"{name}: {launches[name]} launches, {k} x {n} "
                       "executions read on /metrics")
        print(f"observability: /metrics deltas: successes {sent} (bert_long "
              f"{ok} over the phase, {fails} failed), executions {execs}, "
              f"{waves} of tiny_gpt_long's decode waves; launches {launches}"
              f" = per-execution counts x executions {per}", flush=True)
        print(f"observability: traceparent round trips over HTTP and gRPC "
              f"(parameter and metadata); spans against Server-Timing / "
              f"server_*_us within {traffic['timing_gap_ms']:.4f} ms "
              f"(limit {OBS_TIMING_MS})", flush=True)
        print(f"observability: model.execute at p=0.5, seed "
              f"{OBS_FAULT_SEED}: {faulted['pattern']} ({faulted['failed']}"
              f" of {OBS_FAULTED} failed, the seed's draws exactly); "
              "tpu_fault_injections_total and /v2/events counted them; an "
              "http.pre_read drop and a grpc.pre_infer error once each; "
              f"then bert_long within {err:.4g} of the plain path "
              f"(tolerance {SERVED_ATOL})", flush=True)
        profile = _obs_profile(engine, server.port, cpu_flops)
        duty = _sample_sum(_samples(_scrape(server.port)),
                           "tpu_device_duty_cycle")
        observation = {"card": smi, "traffic_s": round(traffic_s, 3),
                       "tpu_device_duty_cycle": duty,
                       "trace_us_per_request": _trace_cost_us(), **profile}
        print(f"observability observation: {json.dumps(observation)}",
              flush=True)
        print(f"observability: phase passed in "
              f"{time.monotonic() - t_phase:.1f} s; launches {launches}; "
              f"{smi}", flush=True)
        return launches
    finally:
        channel.close()
        grpc_server.stop()
        server.stop()
        engine.shutdown()


# -- weights phase ------------------------------------------------------------

FIXTURE = (Path(__file__).resolve().parent / "tests" / "torch_data"
           / "jax_gpt_ckpt")
WEIGHTS_KV2 = "tiny_gpt_long_kv2"
# tiny_gpt_long's registered size; a dry run on the CPU may shrink it.
WEIGHTS_GPT = dict(max_seq_len=2048, max_streams=16)
WEIGHTS_TOKENS = 16   # tokens of each restored GPT stream
# Card memory a restore may reach above what was allocated before it, in
# the weights' bytes: one copy of them (the module is filled on the host
# and moved one tensor at a time), and the caching allocator's rounding.
WEIGHTS_PEAK_MAX = 1.05


def _tree_bytes(tree) -> int:
    from client_tpu_torch.engine.checkpoint import flatten

    return sum(leaf.numel() * leaf.element_size()
               for _, _, leaf in flatten(tree))


def _restore_on_card(torch, build, path, device) -> tuple:
    """``build(device)`` inside ``restoring(path)``: (backend, seconds,
    peak bytes above the memory allocated before, weights' bytes)."""
    import gc

    from client_tpu_torch.engine.model import restoring

    gc.collect()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    with restoring(str(path)):
        backend = build(device)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) - base if cuda else 0
    return backend, seconds, peak, _tree_bytes(backend.params_to_jax())


def weights_phase(torch, smi: str, device: str = "cuda") -> dict:
    """Checkpoints restored and served: a directory repository whose
    weights the port's ``save_params`` wrote from in-process twins on the
    card (``bert_long`` v1 seeded and v2 with layer 0's ``w1`` halved, K1
    bf16; ``tiny_gpt_long`` with the same perturbation, K1 fp32 and K2,
    and again as ``tiny_gpt_long_kv2`` over 2 shards, K3; ``bert_base``
    with its pooler halved), plus the JAX-written fixture
    ``tests/torch_data/jax_gpt_ckpt`` (zstd-compressed by orbax), served
    by one engine behind HTTP and gRPC, every launch count set to 0 just
    before the traffic and read just after it. One row per request, so
    each BERT answer is bit for bit its twin's forward at batch 1; every
    greedy stream token for token its twin's direct stream, and the
    fixture's the tokens JAX recorded, its leaves' SHA-256 JAX's. Prints
    ``bert_base``'s save and restore seconds and MB/s, the fixture's
    decode rate, and each restore's peak card memory against its
    weights' bytes. ``device`` is for a dry run on the CPU."""
    import gc
    import hashlib
    import tempfile

    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.engine.checkpoint import (
        flatten,
        load_params,
        save_params,
    )
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY, _import_all, register_model
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.parallel import kv_shard as ks
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    t_phase = time.monotonic()
    device = torch.device(device)
    cuda = device.type == "cuda"
    _import_all()
    expect = json.loads((FIXTURE / "expect.json").read_text())
    fixture = expect["name"]
    cpu = torch.device("cpu")

    def gpt_long(dev, name="tiny_gpt_long", shards=1):
        backend = TinyGptBackend(name=name, attention_impl="flash",
                                 attn_impl="fused", kv_shards=shards,
                                 device=dev, **WEIGHTS_GPT)
        if shards > 1:  # every shard on this card
            backend._kv_mesh = ks.kv_mesh(shards, [dev] * shards)
        return backend

    def fixture_gpt(dev):
        return TinyGptBackend(name=fixture, device=dev, **expect["model"])

    register_model(WEIGHTS_KV2, default=False)(
        lambda dev: gpt_long(dev, WEIGHTS_KV2, 2))
    register_model(fixture, default=False)(fixture_gpt)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    engine = server = grpc_server = channel = None
    try:
        # The twins: each served model's weights, given directly.
        twins = {}
        with torch.no_grad():
            twins["bert_long", "1"] = _REGISTRY["bert_long"](device)
            twins["bert_long", "2"] = _REGISTRY["bert_long"](device)
            twins["bert_long", "2"].layers[0].w1.weight.mul_(0.5)
            twins["bert_base", "1"] = _REGISTRY["bert_base"](device)
            twins["bert_base", "1"].pooler.weight.mul_(0.5)
            gpt = gpt_long(device)
            gpt.layers[0].w1.weight.mul_(0.5)
        for (name, v), twin in twins.items():
            _write_config(root, name, {**twin.config.config_dict(),
                                       "version_policy": {"all": {}}},
                          versions=(v,))
        saved = {}
        for (name, v), twin in twins.items():
            tree = twin.params_to_jax()
            t0 = time.monotonic()
            save_params(str(root / name / v / "weights"), tree)
            saved[name, v] = (_tree_bytes(tree), time.monotonic() - t0)
        gcfg = gpt.config.config_dict()
        _write_config(root, "tiny_gpt_long",
                      {**gcfg, "parameters": {"weights_path": "ckpt"}})
        save_params(str(root / "tiny_gpt_long" / "ckpt"), gpt.params_to_jax())
        _write_config(root, WEIGHTS_KV2, {**gcfg, "name": WEIGHTS_KV2,
                                          "parameters": {"weights_path": str(
                                              root / "tiny_gpt_long" /
                                              "ckpt")}})
        _write_config(root, fixture, {
            **fixture_gpt(cpu).config.config_dict(),
            "parameters": {"weights_path": str(FIXTURE / "ckpt")}})
        nbytes, seconds = saved["bert_base", "1"]
        print(f"weights: save_params wrote bert_base ({nbytes / 1e6:.1f} MB "
              f"of weights on {device}) in {seconds:.2f} s, "
              f"{nbytes / 1e6 / seconds:.1f} MB/s; bert_long v1 and v2 in "
              f"{saved['bert_long', '1'][1]:.2f} and "
              f"{saved['bert_long', '2'][1]:.2f} s", flush=True)

        # Restores, each alone: seconds, rate and peak card memory.
        ckpt = root / "bert_base" / "1" / "weights"
        like = twins["bert_base", "1"].params_to_jax()
        t0 = time.monotonic()
        host = load_params(str(ckpt), like)
        host_s = time.monotonic() - t0
        del host
        observed = {"bert_base_save_s": seconds,
                    "bert_base_save_mb_s": nbytes / 1e6 / seconds,
                    "bert_base_load_params_s": host_s,
                    "bert_base_load_params_mb_s": nbytes / 1e6 / host_s}
        t0 = time.monotonic()
        load_params(str(FIXTURE / "ckpt"),
                    fixture_gpt(cpu).params_to_jax())
        fixture_s = time.monotonic() - t0
        frames = sum(p.stat().st_size for p in (FIXTURE / "ckpt").rglob("*")
                     if p.is_file())
        fixture_bytes = _tree_bytes(
            fixture_gpt(cpu).params_to_jax())
        observed.update(fixture_decode_s=fixture_s,
                        fixture_decode_mb_s=fixture_bytes / 1e6 / fixture_s,
                        fixture_frames_mb_s=frames / 1e6 / fixture_s)
        print(f"weights: the JAX-written fixture ({frames / 1e6:.2f} MB of "
              f"orbax files, {fixture_bytes / 1e6:.2f} MB of weights) "
              f"decoded in {fixture_s:.2f} s: "
              f"{fixture_bytes / 1e6 / fixture_s:.2f} MB/s of weights out, "
              f"{frames / 1e6 / fixture_s:.2f} MB/s of files in", flush=True)
        peaks = {}
        for label, build, path in (
                ("bert_base", _REGISTRY["bert_base"], ckpt),
                ("bert_long", _REGISTRY["bert_long"],
                 root / "bert_long" / "2" / "weights"),
                ("tiny_gpt_long", gpt_long, root / "tiny_gpt_long" / "ckpt"),
                (fixture, fixture_gpt, FIXTURE / "ckpt")):
            backend, secs, peak, wbytes = _restore_on_card(
                torch, build, path, device)
            del backend
            peaks[label] = {"seconds": secs, "peak_bytes": peak,
                            "weights_bytes": wbytes,
                            "mb_s": wbytes / 1e6 / secs}
            if cuda:
                _check(peak <= WEIGHTS_PEAK_MAX * wbytes,
                       f"restoring {label}: the card's memory peaked "
                       f"{peak} bytes above its start for {wbytes} bytes "
                       "of weights")
            print(f"weights: {label} restored to {device} in {secs:.2f} s "
                  f"({wbytes / 1e6 / secs:.1f} MB/s of weights); "
                  f"max_memory_allocated {peak} bytes above the start for "
                  f"{wbytes} bytes of weights ({peak / wbytes:.3f}x)",
                  flush=True)
        observed["restores"] = peaks
        gc.collect()

        engine = TorchEngine(ModelRepository.from_directory(str(root)),
                             device=device)
        server = HttpInferenceServer(engine, port=0).start()
        grpc_server = GrpcInferenceServer(engine, port=0).start()
        channel, stub = _grpc_channel(grpc_server.url)
        index = engine.repository_index()
        _check(all(e["state"] == "READY" for e in index),
               f"a restored model did not load: {index}")
        print(f"weights: {len(index)} rows READY from {root}: "
              f"{[(e['name'], e['version']) for e in index]}", flush=True)

        rng = np.random.default_rng(13)
        feeds = {}
        for name, v in twins:
            seq = twins[name, v].config.input[0].dims[0]
            for i in range(2):
                ids = rng.integers(0, 30522, (1, seq)).astype(np.int32)
                mask = np.ones((1, seq), np.int32)
                mask[0, rng.integers(seq // 4, seq + 1):] = 0
                feeds[name, v, i] = (ids, mask)
        prompts = [rng.integers(0, 512, n).tolist() for n in CLIENT_PROMPTS]
        gpt_prompts = [p for p in prompts if len(p) < gpt.max_seq_len
                       - WEIGHTS_TOKENS]

        def gen(model, prompt_list, n):
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                over_http = list(pool.map(lambda p: _stream(
                    server.port, model, {"inputs": [{
                        "name": "INPUT_IDS", "datatype": "INT32",
                        "shape": [len(p)], "data": p}],
                        "parameters": {"max_tokens": n}})[0], prompt_list))
            by_id = _grpc_streams(grpc_server.url, [
                (f"w{i}", model, p, {"max_tokens": n})
                for i, p in enumerate(prompt_list)])
            return over_http, [by_id[f"w{i}"][0]
                               for i in range(len(prompt_list))]

        fa.launches = fa.launches_fp32 = da.launches = ks.launches = 0
        answers = {}
        for (name, v, i), (ids, mask) in feeds.items():
            body, headers = _binary_request(ids, mask)
            status, rheaders, data = _post(
                server.port, f"/v2/models/{name}/versions/{v}/infer", body,
                headers)
            _check(status == 200, f"{name} v{v}: HTTP {status}: "
                   f"{data[:300]!r}")
            answers["http", name, v, i] = _parse_response(rheaders, data)
            req = _grpc_request(name, {"input_ids": ids,
                                       "attention_mask": mask})
            req.model_version = v
            answers["grpc", name, v, i] = _grpc_outputs(
                stub.ModelInfer(req, timeout=GRPC_TIMEOUT_S))
        streams = {model: gen(model, gpt_prompts, WEIGHTS_TOKENS)
                   for model in ("tiny_gpt_long", WEIGHTS_KV2)}
        streams[fixture] = gen(fixture, expect["prompts"],
                               expect["max_tokens"])
        launches = {"flash_attention": fa.launches,
                    "flash_attention_fp32": fa.launches_fp32,
                    "decode_wave_attention": da.launches,
                    "ring_all_reduce": ks.launches}

        # The twins, after the count is read.
        names = [tc.name for tc in twins["bert_base", "1"].config.output]
        with torch.inference_mode():
            for (wire, name, v, i), out in answers.items():
                ids, mask = feeds[name, v, i]
                want = twins[name, v]({
                    "input_ids": torch.from_numpy(ids).to(device),
                    "attention_mask": torch.from_numpy(mask).to(device)})
                for n in names:
                    _check(out[n].tobytes() == want[n].cpu().numpy()
                           .tobytes(), f"{name} v{v} over {wire}, request "
                           f"{i}: {n} is not bit for bit its twin's")
        _check(not np.array_equal(answers["http", "bert_long", "1", 0][
            "logits"], answers["http", "bert_long", "2", 0]["logits"]),
            "bert_long versions 1 and 2 answer alike")
        arena = gpt.init_arena(1)
        for model in ("tiny_gpt_long", WEIGHTS_KV2):
            for wire, got in zip(("SSE", "gRPC"), streams[model]):
                for prompt, toks in zip(gpt_prompts, got):
                    want = _direct_stream(torch, gpt, arena, prompt,
                                          WEIGHTS_TOKENS, {},
                                          device=device.type)
                    _check(toks == want, f"{model} over {wire}, prompt of "
                           f"{len(prompt)}: {toks} != its twin's {want}")
        del arena
        for wire, got in zip(("SSE", "gRPC"), streams[fixture]):
            _check(got == expect["greedy_tokens"],
                   f"the JAX-written {fixture} over {wire}: {got} != JAX's "
                   f"{expect['greedy_tokens']}")
        served = engine.repository.get(fixture).backend
        digests = {}
        for path, _, leaf in flatten(served.params_to_jax()):
            arr = leaf.detach().contiguous().cpu().numpy()
            digests[".".join(path)] = {
                "dtype": arr.dtype.name, "shape": list(arr.shape),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        _check(digests == expect["leaves"], "the JAX-written fixture's "
               "leaves on the card are not the SHA-256 JAX recorded")
        print(f"weights: bert_long v1/v2 and bert_base over HTTP and gRPC, "
              f"{len(answers)} answers bit for bit their twins' (v1 and v2 "
              f"differ); tiny_gpt_long and {WEIGHTS_KV2} "
              f"{len(gpt_prompts)} greedy streams each over SSE and gRPC "
              f"token for token their twin's; {fixture} restored with no "
              f"JAX: {len(digests)} leaves' SHA-256 and "
              f"{len(expect['prompts'])} greedy streams over SSE and gRPC "
              f"equal JAX's; launches {launches}", flush=True)
        if cuda:
            _check(all(launches.values()),
                   f"a kernel did not run in the phase: {launches}")

        # An unload gives the restored weights' card memory back.
        freed_bytes = sum(_device_bytes(m) for m in
                          engine.repository.loaded_versions(
                              "bert_long").values())
        before = _allocated(torch, device)
        status, _ = _repo_post(server.port,
                               "/v2/repository/models/bert_long/unload")
        _check(status == 200, f"unload bert_long: HTTP {status}")
        after = _allocated(torch, device)
        if cuda:
            _check(before - after >= REPO_FREED * freed_bytes,
                   f"unloading the restored bert_long freed "
                   f"{before - after} bytes of its {freed_bytes}")
        observed.update(unload_freed_bytes=before - after,
                        bert_long_bytes=freed_bytes, launches=launches)
        print(f"weights observation: {json.dumps(observed)}", flush=True)
        print(f"weights: phase passed in {time.monotonic() - t_phase:.1f} s; "
              f"{smi}", flush=True)
        return launches
    finally:
        if channel is not None:
            channel.close()
        for srv in (grpc_server, server):
            if srv is not None:
                srv.stop()
        if engine is not None:
            engine.shutdown()
        for name in (WEIGHTS_KV2, fixture):
            _REGISTRY.pop(name, None)
        shutil.rmtree(root, ignore_errors=True)


def wave_phase(torch, smi: str) -> None:
    """``--kernels``: the per-wave host/device split (:func:`_wave_split`)
    of ``tiny_gpt_long`` at its registered size, built directly, over one
    arena and over 2 shards on the card, without the engine."""
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.parallel import kv_shard as ks

    for shards in (1, 2):
        backend = TinyGptBackend(
            name="tiny_gpt_long" if shards == 1 else "tiny_gpt_long_kv2",
            max_seq_len=2048, max_streams=16, attention_impl="flash",
            attn_impl="fused", kv_shards=shards, device="cuda")
        if shards > 1:
            backend._kv_mesh = ks.kv_mesh(shards, ["cuda"] * shards)
        _wave_split(torch, backend, smi)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--clients-child"]:  # the clients phase's other process
        return clients_child(argv[1:])
    import torch

    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        print("usage: python3 chip_smoke.py [--kernels]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from client_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 1

    t_start = time.monotonic()
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.monotonic()
    built = cuda_build.build(["flash_attention", "decode_attention",
                              "ring_all_reduce"])
    print(f"set-up: kernels built in {time.monotonic() - t0:.1f} s {built}",
          flush=True)
    census = _sass_census(cuda_build)

    kernels = [kernel_phase(torch), kernel_phase_fp32(torch),
               kernel_phase_decode(torch, cuda_build),
               kernel_phase_ring(torch, cuda_build)]
    kernels[0]["sass"], kernels[1]["sass"] = census["bf16"], census["fp32"]
    torch.cuda.empty_cache()
    if kernels_only:
        wave_phase(torch, smi)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(smi, flush=True)
        return 0
    # Each path's counts: the HTTP requests alone ("http_launches"), then
    # with the same path's gRPC requests on the same engine ("launches").
    served = serve_phase(torch)
    kernels[0]["launches"] = served["launches"]
    kernels[0]["http_launches"] = served["http_launches"]
    generated = generate_phase(torch, smi)
    kernels[1]["launches"] = generated["flash_attention_fp32"]
    kernels[2]["launches"] = generated["decode_wave_attention"]
    kernels[1]["http_launches"] = generated["http_launches"][
        "flash_attention_fp32"]
    kernels[2]["http_launches"] = generated["http_launches"][
        "decode_wave_attention"]
    sharded = sharded_phase(torch, smi)
    kernels[3]["launches"] = sharded["ring_all_reduce"]
    kernels[3]["http_launches"] = sharded["http_launches"]
    for kernel in kernels:
        _check(kernel["launches"] > kernel["http_launches"] > 0,
               f"{kernel['name']}: {kernel['launches']} launches with gRPC, "
               f"{kernel['http_launches']} over HTTP alone")
    torch.cuda.empty_cache()
    vision_phase(torch, smi)
    torch.cuda.empty_cache()
    # K3's second call site: the row-sharded DLRM's pooled bags.
    stateful = stateful_phase(torch, smi)
    kernels[3]["launches"] += stateful["ring_all_reduce"]
    kernels[3]["http_launches"] += stateful["http_launches"]
    _check(stateful["ring_all_reduce"] > stateful["http_launches"] > 0,
           f"ring_all_reduce in the stateful phase: {stateful}")
    torch.cuda.empty_cache()
    # K1 again: bert_long with its inputs and outputs in shm regions.
    shm = shm_phase(torch, smi)
    kernels[0]["launches"] += shm["launches"]
    kernels[0]["shm_launches"] = shm["launches"]
    torch.cuda.empty_cache()
    # Every kernel again, from the port's own clients in another process.
    clients = clients_phase(torch, smi)
    for kernel in kernels:
        kernel["clients_launches"] = clients[kernel["name"]]
        kernel["launches"] += clients[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, through models loaded, unloaded and reloaded.
    repository = repository_phase(torch, smi)
    for kernel in kernels:
        kernel["repository_launches"] = repository[kernel["name"]]
        kernel["launches"] += repository[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, its launches held against the executions that
    # /metrics reports, with the tracing, fault and profiler planes.
    observed = observability_phase(torch, smi)
    for kernel in kernels:
        kernel["observability_launches"] = observed[kernel["name"]]
        kernel["launches"] += observed[kernel["name"]]
    torch.cuda.empty_cache()
    # Every kernel again, through models restored from checkpoints.
    weights = weights_phase(torch, smi)
    for kernel in kernels:
        kernel["weights_launches"] = weights[kernel["name"]]
        kernel["launches"] += weights[kernel["name"]]
    for kernel in kernels:
        # Shorter aliases of the two keys above.
        kernel["launched"] = kernel["launches"]
        kernel["max_err"] = kernel["max_abs_err"]
    print(f"chip_smoke: all phases passed in "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
