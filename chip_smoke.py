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
   against its plain version). The decode wave and the all-reduce are a
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
   layer, and the 404 / 400 error paths.
5. Generate phase: an engine and HTTP server with ``tiny_gpt`` and
   ``tiny_gpt_long`` at their registered sizes (decode waves through the
   fused kernel, ``tiny_gpt_long``'s prefill through the fp32 flash kernel),
   one short warm-up round, then launch counts set to 0 and concurrent
   ``/generate_stream`` requests over several prompt buckets, greedy and
   seeded sampled. Every stream must
   equal, token for token, the same model run directly on the card one
   stream at a time on the plain path (einsum prefill, reference decode);
   the launch counts must show the kernels ran; ``/generate`` must match
   the stream; the 400s and a stop token are checked. Wall time, tokens/s
   and the median inter-token gap are printed, not claimed.
6. Sharded generate phase: ``tiny_gpt_long`` at its registered size with
   its KV arena split by rows over 2 shards on the card (``kv_shards=2``),
   served over HTTP as ``tiny_gpt_long_kv2``; launch counts set to 0, then
   8 concurrent ``/generate_stream`` streams of 32 tokens (prompts of 3 to
   1,500 tokens, two sampled). Every stream must equal the same prompt run
   directly on the plain unsharded path; every decode step must have
   launched the ring all-reduce once per layer and the decode kernel once
   per layer and shard.
7. Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
   limit line, and last ``{"ok": true, "device": {...}}``.

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
import subprocess
import sys
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
    }


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


def serve_phase(torch) -> tuple[int, dict]:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import HttpInferenceServer

    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["bert_base", "bert_long"]))
    server = HttpInferenceServer(engine, port=0).start()
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

        # Served outputs against the same module run directly on the card,
        # its attention swapped for the plain version (bert_long) or as is.
        errs = {"bert_base": 0.0, "bert_long": 0.0}
        with torch.inference_mode():
            for (model, ids, mask, _), (out, _) in zip(requests, results):
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
        print(f"serve: max |served - direct| {errs} (tolerance "
              f"{SERVED_ATOL})", flush=True)
        _check(max(errs.values()) <= SERVED_ATOL, f"served outputs off: {errs}")
        _check(launches == fa.launches, "the reference run launched the kernel")

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
        print("serve: 404 for an unknown model, 400 for a malformed body "
              "and a wrong shape", flush=True)
        return launches, errs
    finally:
        server.stop()
        engine.shutdown()


# -- generate phase ---------------------------------------------------------

def _stream(port: int, model: str, body: dict) -> tuple[list[int], list[float]]:
    """One /generate_stream request: its tokens and the arrival time of
    each (monotonic seconds), read event by event as they come."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", f"/v2/models/{model}/generate_stream",
                     json.dumps(body).encode())
        resp = conn.getresponse()
        _check(resp.status == 200, f"{model}: generate_stream HTTP "
               f"{resp.status}")
        _check(resp.getheader("Content-Type") == "text/event-stream",
               f"{model}: not an event stream")
        tokens, times, buf = [], [], b""
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
                _check(outs["INDEX"] == [len(tokens)], f"{model}: INDEX "
                       f"{outs['INDEX']} after {len(tokens)} tokens")
                tokens.append(outs["TOKEN"][0])
                times.append(time.monotonic())
        _check(not buf, f"{model}: trailing bytes {buf[:80]!r}")
        return tokens, times
    finally:
        conn.close()


def _direct_stream(torch, backend, arena, prompt, n, params) -> list[int]:
    """The same model run directly, one stream alone in arena row 0."""
    lanes = backend.lane_params([params.get("seed", 0)],
                                [params.get("temperature", 0.0)],
                                [params.get("top_k", 0)],
                                [params.get("top_p", 1.0)])
    sample = params.get("temperature", 0.0) > 0
    ids = torch.tensor([prompt], dtype=torch.int32, device="cuda")
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


def generate_phase(torch, smi: str) -> dict:
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.generate import TinyGptBackend
    from client_tpu_torch.ops import decode_attention as da
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.server import HttpInferenceServer

    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 matmuls are on: fp32 parity needs them off")
    t0 = time.monotonic()
    engine = TorchEngine(build_repository(["tiny_gpt", "tiny_gpt_long"]))
    server = HttpInferenceServer(engine, port=0).start()
    print(f"generate: engine and server up in {time.monotonic() - t0:.1f} s",
          flush=True)
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
        n_tokens = sum(len(toks) for toks, _ in results)
        gaps = [b - a for _, times in results
                for a, b in zip(times, times[1:])]
        stats = {s["name"]: s for s in engine.model_statistics()["model_stats"]}
        print(f"generate: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms, "
              f"p90 {1e3 * float(np.percentile(gaps, 90)):.2f} ms; "
              f"executions {[(m, s['execution_count']) for m, s in sorted(stats.items())]}; "
              f"{smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _ in results),
               f"stream lengths {[len(t) for t, _ in results]}")
        n_layers = 4
        _check(k2 % n_layers == 0 and k2 >= n_layers * (max_tokens - 1),
               f"decode kernel launches {k2}: not a multiple of {n_layers} "
               f"or fewer than {n_layers * (max_tokens - 1)}")
        _check(k1 % n_layers == 0 and k1 >= n_layers,
               f"fp32 flash launches {k1}: not a multiple of {n_layers}")
        print(f"generate: decode kernel launched {k2} times, fp32 flash "
              f"{k1} times ({k1 // n_layers} tiny_gpt_long prefill chunks)",
              flush=True)

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
        for (model, prompt, params), (toks, _) in zip(requests, results):
            oracle, arena = oracles[model]
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{model} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
        _check((fa.launches_fp32, da.launches) == (k1, k2),
               "the plain-path oracle launched a kernel")
        print(f"generate: all {len(requests)} streams equal the plain path "
              f"run directly, token for token ({time.monotonic() - t0:.1f} "
              "s)", flush=True)

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
        stopped, _ = _stream(server.port, model, {
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
        _wave_split(torch, engine.repository.get("tiny_gpt_long").backend,
                    smi)
        return {"flash_attention_fp32": k1, "decode_wave_attention": k2,
                "wall_s": wall, "tokens": n_tokens,
                "median_gap_ms": 1e3 * float(np.median(gaps))}
    finally:
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
    from client_tpu_torch.server import HttpInferenceServer

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
        n_tokens = sum(len(toks) for toks, _ in results)
        gaps = [b - a for _, times in results
                for a, b in zip(times, times[1:])]
        print(f"sharded: {len(requests)} concurrent streams, {n_tokens} "
              f"tokens in {wall:.3f} s ({n_tokens / wall:.1f} tokens/s), "
              f"median inter-token gap {1e3 * float(np.median(gaps)):.2f} ms; "
              f"{executions} executions: {prefills} prefill chunks, {steps} "
              f"decode steps; {smi} (printed, not claimed)", flush=True)
        _check(all(len(toks) == max_tokens for toks, _ in results),
               f"stream lengths {[len(t) for t, _ in results]}")
        _check(k1 == n_layers * prefills and prefills >= 1,
               f"fp32 flash launches {k1}: not {n_layers} per prefill chunk")
        _check(steps >= max_tokens - 1, f"{steps} decode steps")
        _check(k3 == n_layers * steps,
               f"ring launches {k3} != {n_layers} x {steps} decode steps")
        _check(k2 == shards * n_layers * steps,
               f"decode launches {k2} != {shards} x {n_layers} x {steps}")
        print(f"sharded: ring all-reduce launched {k3} = {n_layers} x {steps} "
              f"times, decode kernel {k2} = {shards} x {n_layers} x {steps}, "
              f"fp32 flash {k1} = {n_layers} x {prefills}", flush=True)

        oracle = TinyGptBackend(name=name, max_seq_len=2048, max_streams=16,
                                attention_impl="einsum",
                                attn_impl="reference", device="cuda")
        arena = oracle.init_arena(1)
        t0 = time.monotonic()
        for (prompt, params), (toks, _) in zip(requests, results):
            want = _direct_stream(torch, oracle, arena, prompt, max_tokens,
                                  params)
            _check(toks == want, f"{name} prompt of {len(prompt)} "
                   f"{params or 'greedy'}: served {toks} != direct {want}")
        _check((fa.launches_fp32, da.launches, ks.launches) == (k1, k2, k3),
               "the plain-path oracle launched a kernel")
        print(f"sharded: all {len(requests)} streams equal the plain "
              f"unsharded path run directly, token for token "
              f"({time.monotonic() - t0:.1f} s)", flush=True)
        _wave_split(torch, backend, smi)
        return {"ring_all_reduce": k3, "decode_wave_attention": k2,
                "wall_s": wall, "tokens": n_tokens}
    finally:
        server.stop()
        engine.shutdown()


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
    kernels[0]["launches"], _ = serve_phase(torch)
    generated = generate_phase(torch, smi)
    kernels[1]["launches"] = generated["flash_attention_fp32"]
    kernels[2]["launches"] = generated["decode_wave_attention"]
    kernels[3]["launches"] = sharded_phase(torch, smi)["ring_all_reduce"]
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
