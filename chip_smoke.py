#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

1. Prints the card (``torch.cuda.get_device_name``) and its power limit.
2. Builds every kernel of the path from ``client_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and prints the seconds.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes the main path gives it, plus its edge cases, with the
   tolerance stated below; then times kernel, plain version and the one
   PyTorch call that computes the same function, and works out the least
   time the card could take (the bound).
4. Serve phase: starts ``client_tpu_torch``'s HTTP server with ``bert_base``
   and ``bert_long`` on the card (full BERT-base width and depth, random
   weights from a fixed seed), sets every kernel's launch count to 0, sends
   concurrent v2 requests (JSON and binary tensors) so dynamic batching
   forms batches, and checks status, shapes, finite values, agreement with
   the same module run directly with its attention swapped for the plain
   version, that each ``bert_long`` batch launched the flash kernel once per
   layer, and the 404 / 400 error paths.
5. Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
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

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
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
    built = cuda_build.build(["flash_attention"])
    print(f"set-up: kernels built in {time.monotonic() - t0:.1f} s {built}",
          flush=True)

    kernel = kernel_phase(torch)
    launches, _ = serve_phase(torch)
    kernel["launches"] = launches
    # Shorter aliases of the two keys above.
    kernel["launched"] = launches
    kernel["max_err"] = kernel["max_abs_err"]
    print(f"chip_smoke: all phases passed in "
          f"{time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
