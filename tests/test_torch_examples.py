"""The Python example scripts against the port's servers.

One port engine on the CPU (``simple``, ``simple_string``,
``simple_identity``, a small ``resnet50`` and the registered
``ssd_mobilenet_v2_coco_quantized``) behind its HTTP and gRPC servers.
Each script in ``examples/python`` listed below runs in a subprocess and
must exit 0 and print its PASS line, twice: as written, with the JAX
package's clients, and with the port's own clients put in their place
(``client_tpu.http`` -> ``client_tpu_torch.http``, ``client_tpu.grpc`` ->
``client_tpu_torch.grpc``, the shm utilities, the gRPC schema and stub),
in a process where no module of the JAX package is loaded. In both runs
each system-shm key the script names is made unique to its process.

``simple_{http,grpc}_model_control.py`` unload and reload ``simple``
over the port's repository routes and RPCs.

``simple_shm_ring_client.py`` stages requests into a slot ring, rings
one doorbell over HTTP and reads the answers from the slots; the runners
append the pid to its ring's key as they do to the system-shm keys.

``moe_lm_client.py`` (HTTP) and ``moe_gpt_stream_client.py`` (a gRPC
stream) run against ``python -m client_tpu_torch.server --zoo
moe_lm_mc,moe_gpt_mc --device cpu``, the registered MoE families on a
degree-1 mesh of the CPU, with both client sets.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(REPO, "examples", "python")
RESNET = dict(stages=((1, 8), (1, 16)))

# (script, arguments after the URL flags, which server(s) it talks to)
SCRIPTS = [
    ("simple_http_shm_client.py", [], "http"),
    ("simple_grpc_shm_client.py", [], "grpc"),
    ("simple_http_shm_string_client.py", [], "http"),
    ("simple_grpc_shm_string_client.py", [], "grpc"),
    ("simple_http_tpushm_client.py", [], "http"),
    ("simple_grpc_tpushm_client.py", [], "grpc"),
    ("simple_http_infer_client.py", [], "http"),
    ("simple_http_string_infer_client.py", [], "http"),
    ("simple_http_async_infer_client.py", ["-n", "16"], "http"),
    ("simple_grpc_async_infer_client.py", ["-n", "16"], "grpc"),
    ("simple_http_health_metadata.py", [], "http"),
    ("simple_grpc_health_metadata.py", [], "grpc"),
    ("simple_grpc_keepalive_client.py", [], "grpc"),
    ("reuse_infer_objects_client.py", ["-n", "4"], "both"),
    ("grpc_explicit_byte_content_client.py", [], "grpc"),
    ("grpc_explicit_int_content_client.py", [], "grpc"),
    ("grpc_client.py", [], "grpc"),
    ("grpc_image_client.py", ["--synthetic", "-c", "3", "-b", "2"], "grpc"),
    ("grpc_image_ssd_client.py", [], "grpc"),
    ("simple_http_model_control.py", [], "http"),
    ("simple_grpc_model_control.py", [], "grpc"),
    ("simple_shm_ring_client.py", [], "http"),
]

# Both runs go through a runner. It appends the process id to every
# system-shm and ring key a script creates or registers: the scripts' keys
# are fixed, and tests/test_examples.py runs the same scripts, at the same
# moment on another worker, against the JAX server.
REKEY = r"""
import os, runpy, sys


def rekey(shm, *clients):
    def unique(key):
        return f"{key}_{os.getpid()}"
    create = shm.create_shared_memory_region
    shm.create_shared_memory_region = (
        lambda name, key, size, *a, **k: create(name, unique(key), size,
                                                *a, **k))
    for cls in clients:
        def register(self, name, key, size, *a,
                     _register=cls.register_system_shared_memory, **k):
            return _register(self, name, unique(key), size, *a, **k)
        cls.register_system_shared_memory = register


def rekey_ring(producer):
    init = producer.__init__

    def __init__(self, client, name, shm_key, *a, **k):
        init(self, client, name, f"{shm_key}_{os.getpid()}", *a, **k)
    producer.__init__ = __init__
"""

# The script as written, with the JAX package's clients.
JAX_CLIENTS = REKEY + r"""
import client_tpu.grpc, client_tpu.http, client_tpu.utils.shared_memory
rekey(client_tpu.utils.shared_memory, client_tpu.http.InferenceServerClient,
      client_tpu.grpc.InferenceServerClient)
rekey_ring(client_tpu.http.RingProducer)
script, *args = sys.argv[1:]
sys.argv = [script, *args]
runpy.run_path(script, run_name="__main__")
"""

# The script with the port's clients in the place of the JAX package's:
# every ``client_tpu`` module a script imports is the port's.
PORT_CLIENTS = REKEY + r"""
import types
import client_tpu_torch.grpc, client_tpu_torch.http, client_tpu_torch.utils
import client_tpu_torch.utils.shared_memory
import client_tpu_torch.protocol.codec
import client_tpu_torch.protocol.grpc_service_pb2
import client_tpu_torch.protocol.grpc_stub
port = client_tpu_torch
root = types.ModuleType("client_tpu")
root.__path__ = []
root.http, root.grpc, root.utils = port.http, port.grpc, port.utils
root.protocol = port.protocol
sys.modules.update({
    "client_tpu": root,
    "client_tpu.http": port.http,
    "client_tpu.grpc": port.grpc,
    "client_tpu.utils": port.utils,
    "client_tpu.utils.shared_memory": port.utils.shared_memory,
    "client_tpu.protocol": port.protocol,
    "client_tpu.protocol.codec": port.protocol.codec,
    "client_tpu.protocol.grpc_service_pb2": port.protocol.grpc_service_pb2,
    "client_tpu.protocol.grpc_stub": port.protocol.grpc_stub,
})
rekey(port.utils.shared_memory, port.http.InferenceServerClient,
      port.grpc.InferenceServerClient)
rekey_ring(port.http.RingProducer)
script, *args = sys.argv[1:]
if "tpushm" in script:  # the device-region utilities load torch
    import client_tpu_torch.utils.cuda_shared_memory as devshm
    port.utils.tpu_shared_memory = devshm
    sys.modules["client_tpu.utils.tpu_shared_memory"] = devshm
sys.argv = [script, *args]
try:
    runpy.run_path(script, run_name="__main__")
finally:
    real = sorted(m for m, mod in sys.modules.items()
                  if m.split(".")[0] in ("client_tpu", "jax")
                  and not getattr(mod, "__name__", "").startswith(
                      "client_tpu_torch") and mod is not root)
    assert not real, f"the JAX package was loaded: {real}"
"""


@pytest.fixture(scope="module")
def served():
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository
    from client_tpu_torch.models.vision import ResNet50Backend
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    repo = build_repository(["simple", "simple_string", "simple_identity",
                             "ssd_mobilenet_v2_coco_quantized"])
    repo.register("resnet50", lambda device: ResNet50Backend(
        device=device, **RESNET))
    engine = TorchEngine(repo, device="cpu")
    http = HttpInferenceServer(engine, port=0).start()
    grpc = GrpcInferenceServer(engine, port=0).start()
    yield http, grpc
    grpc.stop()
    http.stop()
    engine.shutdown()


def _command(script, extra, wire, served, clients):
    http, grpc = served
    if wire == "both":
        urls = ["-u", http.url, "-g", grpc.url]
    else:
        urls = ["-u", http.url if wire == "http" else grpc.url]
    runner = JAX_CLIENTS if clients == "jax" else PORT_CLIENTS
    return [sys.executable, "-c", runner, os.path.join(EXAMPLES, script),
            *urls, *extra]


@pytest.mark.parametrize("clients", ["jax", "port"])
@pytest.mark.parametrize("script,extra,wire", SCRIPTS,
                         ids=[s[0] for s in SCRIPTS])
def test_example_passes_against_the_port(served, script, extra, wire,
                                         clients):
    proc = subprocess.run(
        _command(script, extra, wire, served, clients), capture_output=True,
        text=True, timeout=180, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout, proc.stdout + proc.stderr


MOE_SCRIPTS = [("moe_lm_client.py", "http"),
               ("moe_gpt_stream_client.py", "grpc")]


@pytest.fixture(scope="module")
def moe_server():
    """The port's launcher serving the registered moe_lm_mc and moe_gpt_mc
    on the CPU; yields {"http": url, "grpc": url}."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "client_tpu_torch.server", "--zoo",
         "moe_lm_mc,moe_gpt_mc", "--device", "cpu", "--host", "127.0.0.1",
         "--http-port", "0", "--grpc-port", "0"], cwd=REPO,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    try:
        urls = {}
        while len(urls) < 2:
            line = proc.stderr.readline()
            assert line, f"launcher exited: {proc.wait(timeout=30)}"
            m = re.match(r"serving (http|grpc) at (\S+)", line)
            if m:
                urls[m.group(1)] = m.group(2)
        yield urls
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stderr.close()


@pytest.mark.parametrize("clients", ["jax", "port"])
@pytest.mark.parametrize("script,wire", MOE_SCRIPTS,
                         ids=[s[0] for s in MOE_SCRIPTS])
def test_moe_example_passes_against_the_port_launcher(moe_server, script,
                                                      wire, clients):
    runner = JAX_CLIENTS if clients == "jax" else PORT_CLIENTS
    proc = subprocess.run(
        [sys.executable, "-c", runner, os.path.join(EXAMPLES, script), "-u",
         moe_server[wire]], capture_output=True, text=True, timeout=180,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASS" in proc.stdout, proc.stdout + proc.stderr
