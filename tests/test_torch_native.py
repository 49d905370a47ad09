"""The native C++ clients and ``tpu_perf_analyzer`` against the port's
servers.

The same binaries ``tests/test_native.py`` runs against the JAX servers,
built by the same recipe, here against one port engine on the CPU
(``simple``, ``simple_string``, ``simple_sequence``, ``simple_repeat`` and
the registered ``tiny_gpt``) behind its HTTP and gRPC servers. Each example
binary hard-asserts its values and prints PASS. ``tpu_perf_analyzer`` runs
in concurrency mode over both protocols, with system and device
shared-memory inputs, on the streaming sequence path and with the
generative profile on ``tiny_gpt``; each run must report a positive
throughput. The perf runs assert no rate or latency bound: they show the
port serves another process's load, not how fast.

The model-control binaries and ``simple_http_health_metadata`` unload
and reload ``simple`` over the port's ``POST
/v2/repository/models/<m>/{load,unload}`` and its ``RepositoryModelLoad``
/ ``RepositoryModelUnload``.

Left out: ``--num-of-sequences`` in request-rate mode, whose JAX test is
load-timed.
"""

import json
import os
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "native")
# A build tree of its own: tests/test_native.py builds native/build, often
# at the same moment on another worker.
BUILD = os.path.join(NATIVE, "build-torch")

HTTP_EXAMPLES = [
    "simple_http_infer_client",
    "simple_http_async_infer_client",
    "simple_http_string_infer_client",
    "simple_http_shm_client",
    "simple_http_sequence_client",
    "simple_http_tpushm_client",
    "simple_http_health_metadata",
    "simple_http_model_control",
]
GRPC_EXAMPLES = [
    "simple_grpc_infer_client",
    "simple_grpc_async_infer_client",
    "simple_grpc_string_infer_client",
    "simple_grpc_shm_client",
    "simple_grpc_tpushm_client",
    "simple_grpc_sequence_sync_client",
    "simple_grpc_sequence_stream_client",
    "simple_grpc_custom_repeat_client",
    "grpc_generate_client",
    "simple_grpc_health_metadata",
    "simple_grpc_keepalive_client",
    "simple_grpc_model_control",
]


@pytest.fixture(scope="module")
def native_build():
    """Configure and build the native tree (a no-op when up to date), by
    the recipe of ``tests/test_native.py``, in its own build tree."""
    subprocess.run(
        ["cmake", "-B", BUILD, "-G", "Ninja", "-DCMAKE_BUILD_TYPE=Release"],
        cwd=NATIVE, check=True, capture_output=True)
    proc = subprocess.run(["ninja", "-C", BUILD], cwd=NATIVE,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return BUILD


@pytest.fixture(scope="module")
def port_servers():
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    engine = TorchEngine(build_repository(
        ["simple", "simple_string", "simple_sequence", "simple_repeat",
         "tiny_gpt"]), device="cpu")
    http = HttpInferenceServer(engine, port=0).start()
    grpc = GrpcInferenceServer(engine, port=0).start()
    yield http, f"127.0.0.1:{grpc.port}"
    grpc.stop()
    http.stop()
    engine.shutdown()


def _run(args, timeout=180):
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("example", HTTP_EXAMPLES)
def test_http_example_against_the_port(native_build, port_servers, example):
    http, _ = port_servers
    out = _run([os.path.join(native_build, example), "-u", http.url])
    assert "PASS" in out


@pytest.mark.parametrize("example", GRPC_EXAMPLES)
def test_grpc_example_against_the_port(native_build, port_servers, example):
    _, grpc_url = port_servers
    out = _run([os.path.join(native_build, example), "-u", grpc_url])
    assert "PASS" in out


@pytest.mark.parametrize("binary,extra", [
    ("client_timeout_test", []),
    ("memory_leak_test", ["-r", "300"]),
    ("reuse_infer_objects_client", ["-n", "8"]),
])
def test_test_binaries_against_the_port(native_build, port_servers, binary,
                                        extra):
    http, grpc_url = port_servers
    out = _run([os.path.join(native_build, binary), "-u", http.url,
                "-g", grpc_url, *extra], timeout=600)
    assert "PASS" in out


def _throughput(csv_path) -> float:
    lines = csv_path.read_text().strip().splitlines()
    header, row = lines[0].split(","), lines[1].split(",")
    return float(row[header.index("Inferences/Second")])


PERF_RUNS = {
    "http_concurrency": (["-m", "simple", "--concurrency-range", "2:2"],
                         "http"),
    "grpc_concurrency_async": (["-m", "simple", "-i", "grpc", "-a",
                                "--concurrency-range", "4:4"], "grpc"),
    "http_shm_system": (["-m", "simple", "--concurrency-range", "2:2",
                         "--shared-memory", "system"], "http"),
    "http_shm_tpu": (["-m", "simple", "--concurrency-range", "2:2",
                      "--shared-memory", "tpu"], "http"),
    "grpc_streaming_sequence": (["-m", "simple_sequence",
                                 "--service-kind", "tpu_grpc", "--streaming",
                                 "--sequence-length", "4",
                                 "--concurrency-range", "4:4"], "grpc"),
}


@pytest.mark.parametrize("run", sorted(PERF_RUNS))
def test_perf_analyzer_against_the_port(native_build, port_servers, tmp_path,
                                        run):
    http, grpc_url = port_servers
    args, wire = PERF_RUNS[run]
    csv = tmp_path / f"{run}.csv"
    out = _run([os.path.join(native_build, "tpu_perf_analyzer"),
                "-u", http.url if wire == "http" else grpc_url,
                "-p", "600", "-r", "6", "-s", "70", *args, "-f", str(csv)])
    assert "Throughput" in out
    assert "Inference count" in out  # the server's statistics
    assert _throughput(csv) > 0


def test_perf_analyzer_generative_profile(native_build, port_servers):
    """Token streams from the port's ``tiny_gpt`` over the gRPC stream:
    time to first token, inter-token gap and tokens/s."""
    _, grpc_url = port_servers
    out = _run([os.path.join(native_build, "tpu_perf_analyzer"),
                "-m", "tiny_gpt", "-u", grpc_url, "--service-kind",
                "tpu_grpc", "--generative", "--generative-max-tokens", "6",
                "--shape", "INPUT_IDS:4", "-p", "1500",
                "--concurrency-range", "4:4"], timeout=300)
    assert "tok/s" in out and "TTFT" in out
    rep = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert rep["tok_s"] > 0
    assert rep["ttft_us_p50"] > 0 and rep["itl_us_p50"] >= 0
