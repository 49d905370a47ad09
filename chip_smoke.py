#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

1. Prints the card (``torch.cuda.get_device_name``) and its power limit.
2. Builds every kernel of the path from ``client_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
3. Kernel phases: hold each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, plus its edge cases, with the
   tolerance stated below; then time kernel, plain version and the one
   PyTorch call that computes the same function, and work out the least
   time the card could take (the bound). The kernels: flash attention in
   bf16 (BERT) and in fp32 causal (the generative prefill), and the fused
   decode wave.
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
6. Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
   limit line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero as well without CUDA, or outside a checkout of the repo.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time
import http.client

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
# Decode-wave kernel vs plain version: fp32 throughout, one query over up
# to 2048 keys, sums in another order; the scatter is compared exactly.
DECODE_ATOL = 2e-5

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
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


def _time_ms(torch, fn) -> float:
    """Median over N_TIMED launches, each bracketed by CUDA events."""
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
    return float(np.median(times))


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

    ms = _time_ms(torch, lambda: fa.flash_attention(q, k, v, bias))
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, bias))
    library_ms = _time_ms(torch, library)
    flops = 4.0 * B * H * S * S * D       # QK^T and PV, 2 FLOP per MAC
    nbytes = 4 * B * S * H * D * 2 + B * S * 4  # q, k, v, out (bf16), bias
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"flash_attention at B{B} S{S} H{H} D{D}: kernel {ms} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms; bound "
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
    }


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

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    ms = _time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    library_ms = _time_ms(torch, library)
    # Causal: only the S(S+1)/2 (query, key) pairs on or below the diagonal.
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = 4 * B * S * H * D * 4  # q, k, v read, out written (fp32)
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"flash_attention fp32 causal at B{B} S{S} H{H} D{D}: kernel {ms} "
          f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms} ms, "
          f"scaled_dot_product_attention {library_ms} ms; bound "
          f"{max(flop_ms, byte_ms)} ms ({flops:.3e} FLOP, {nbytes} bytes)",
          flush=True)
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
        "library_ms": library_ms,
    }


def kernel_phase_decode(torch) -> dict:
    """The fused decode wave at tiny_gpt_long's arena shape."""
    from client_tpu_torch.ops import decode_attention as da

    L, R, S, H, D = 4, 17, 2048, 4, 64  # 16 stream rows + the dummy row 16
    dummy = R - 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    k_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    v_arena = torch.randn(L, R, S, H, D, device="cuda", generator=gen)
    rng = np.random.default_rng(2)
    cases = {  # B: (rows, lens); lanes on the dummy row are padding
        1: ([5], [2047]),
        3: ([2, 9, dummy], [1, 777, 0]),
        16: (list(range(12)) + [dummy] * 4,
             [0, 1, 2047] + rng.integers(2, 1600, 9).tolist() + [0] * 4),
    }
    errors = []
    for layer, (b, (rows, lens)) in enumerate(sorted(cases.items())):
        rows_np = np.asarray(rows, np.int32)
        lens_np = np.asarray(lens, np.int32)
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
        print(f"kernel case decode B{b} lens {lens}: max_abs_err {err} "
              f"(tolerance {DECODE_ATOL})", flush=True)
        _check(err <= DECODE_ATOL, f"decode B{b}: max_abs_err {err}")
        _check(bool(torch.isfinite(o).all()), f"decode B{b}: non-finite")
        errors.append(err)
        for i in np.flatnonzero(real & (lens_np == 0)):
            _check(bool(torch.equal(o[i], vn[i])),
                   f"decode B{b} lane {i}: lens 0 is not exactly v_new")
        # Untouched rows bit-identical, scattered slots equal to the
        # inputs: every row but the dummy equals the plain version's.
        _check(bool(torch.equal(k_arena[:, :dummy], k_ref[:, :dummy])
                    and torch.equal(v_arena[:, :dummy], v_ref[:, :dummy])),
               f"decode B{b}: arena differs from the plain scatter")
        r = torch.from_numpy(rows_np[real]).long().cuda()
        n = torch.from_numpy(lens_np[real]).long().cuda()
        _check(bool(torch.equal(k_arena[layer, r, n], kn[real])
                    and torch.equal(v_arena[layer, r, n], vn[real])),
               f"decode B{b}: scattered slots differ from the inputs")
        del k_ref, v_ref
    print("decode kernel: lens 0 gives exactly v_new; untouched rows and "
          "scattered slots bit-identical", flush=True)

    # Timing at B=16, the largest wave bucket of tiny_gpt_long.
    rows_np = np.asarray(cases[16][0], np.int32)
    lens_np = np.asarray(cases[16][1], np.int32)
    index = da.WaveIndex(rows_np, lens_np, R, S, "cuda")
    b = len(rows_np)
    q, kn, vn = (torch.randn(b, H, D, device="cuda", generator=gen)
                 for _ in range(3))
    k_ref, v_ref = k_arena.clone(), v_arena.clone()
    rows_t = index.rows.long()
    lens_t = index.lens.long()
    ck, cv = k_ref[0, rows_t], v_ref[0, rows_t]  # gathered beforehand
    mask = (torch.arange(S, device="cuda")[None, :] <= lens_t[:, None])

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2),
            attn_mask=mask[:, None, None, :])

    ms = _time_ms(torch, lambda: da.decode_wave_attention(
        k_arena, v_arena, q, kn, vn, index, layer=0))
    plain_ms = _time_ms(torch, lambda: da.decode_wave_attention_plain(
        k_ref, v_ref, q, kn, vn, index, layer=0))
    library_ms = _time_ms(torch, library)
    lane_bytes = H * D * 4
    nbytes = (2 * int(lens_np.sum()) * lane_bytes  # valid K/V prefix
              + 4 * b * lane_bytes                 # q, k_new, v_new, o
              + 2 * b * lane_bytes                 # the scattered slots
              + 2 * b * 4)                         # rows, lens
    flops = 4.0 * H * D * (int(lens_np.sum()) + b)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"decode_wave_attention at B{b} (sum of lens {int(lens_np.sum())}"
          f"): kernel {ms} ms ({nbytes / ms / 1e6:.1f} GB/s), plain "
          f"{plain_ms} ms, scaled_dot_product_attention {library_ms} ms; "
          f"bound {max(byte_ms, flop_ms)} ms ({nbytes} bytes)", flush=True)
    return {
        "name": "decode_wave_attention",
        "route": "cuda",
        "source": "client_tpu_torch/csrc/decode_attention.cu",
        "replaces": "client_tpu/ops/decode_kernel.py:58",
        "launches": None,  # from the generate phase
        "max_abs_err": max(errors),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, flop_ms),
        "bound_by": "bytes" if byte_ms >= flop_ms else "operations",
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention over rows gathered "
                        "beforehand, boolean mask; no scatter, no gather",
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
    rows = list(range(12)) + [backend.max_streams] * 4
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
        print(f"generate: tiny_gpt_long wave, 12 lanes in a 16 bucket, "
              f"{label}: host dispatch {1e3 * float(np.median(host)):.3f} "
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


def main() -> int:
    import torch

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
    built = cuda_build.build(["flash_attention", "decode_attention"])
    print(f"set-up: kernels built in {time.monotonic() - t0:.1f} s {built}",
          flush=True)

    kernels = [kernel_phase(torch), kernel_phase_fp32(torch),
               kernel_phase_decode(torch)]
    torch.cuda.empty_cache()
    kernels[0]["launches"], _ = serve_phase(torch)
    generated = generate_phase(torch, smi)
    kernels[1]["launches"] = generated["flash_attention_fp32"]
    kernels[2]["launches"] = generated["decode_wave_attention"]
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
    sys.exit(main())
