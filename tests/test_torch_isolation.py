"""The port stands alone: no file of ``client_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and ``chip_smoke.py``
refuses to run (and prints no result) without a card or outside a
checkout."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "client_tpu_torch").rglob("*.py"))
# A GPU host need not have JAX, zstandard, orbax or tensorstore: the port
# reads and writes the JAX package's checkpoints without them.
FORBIDDEN = ("jax", "jaxlib", "client_tpu", "zstandard", "orbax",
             "tensorstore")


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_port_has_files():
    assert "client_tpu_torch/ops/flash_attention.py" in PORT_FILES
    assert len(PORT_FILES) >= 15


@pytest.mark.parametrize("relpath", PORT_FILES + ["chip_smoke.py"])
def test_imports_neither_jax_nor_the_jax_package(relpath):
    bad = [n for n in _imported_modules(REPO / relpath) if _forbidden(n)]
    assert not bad, f"{relpath} imports {bad}"


def test_importing_the_server_loads_no_jax():
    code = (
        "import sys\n"
        "import client_tpu_torch.server, client_tpu_torch.server.__main__\n"
        "import client_tpu_torch.models.bert, client_tpu_torch.engine\n"
        "import client_tpu_torch.models.generate\n"
        "import client_tpu_torch.engine.generative\n"
        "import client_tpu_torch.models.vision, client_tpu_torch.models.ssd\n"
        "import client_tpu_torch.models.ensembles\n"
        "import client_tpu_torch.engine.ensemble\n"
        "import client_tpu_torch.server.classification\n"
        "import client_tpu_torch.server.grpc_server\n"
        "import client_tpu_torch.server.coalesce\n"
        "import client_tpu_torch.engine.shm\n"
        "import client_tpu_torch.utils\n"
        "import client_tpu_torch.utils.shared_memory\n"
        "import client_tpu_torch.utils.cuda_shared_memory\n"
        "import client_tpu_torch.protocol.grpc_service_pb2\n"
        "import client_tpu_torch.protocol.grpc_stub\n"
        "import client_tpu_torch.protocol.grpc_codec\n"
        "import client_tpu_torch.protocol.model_config\n"
        "import client_tpu_torch.models.simple\n"
        "import client_tpu_torch.models.dlrm\n"
        "import client_tpu_torch.engine.rowcache\n"
        "import client_tpu_torch.engine.ragged\n"
        "import client_tpu_torch.engine.sequence\n"
        "import client_tpu_torch.parallel.emb_shard\n"
        "import client_tpu_torch.http, client_tpu_torch.grpc\n"
        "import client_tpu_torch.resilience, client_tpu_torch.router.core\n"
        "import client_tpu_torch.engine.repository\n"
        "import client_tpu_torch.engine.config\n"
        "import client_tpu_torch.engine.trace, client_tpu_torch.faults\n"
        "import client_tpu_torch.observability.events\n"
        "import client_tpu_torch.observability.metrics\n"
        "import client_tpu_torch.observability.profiler\n"
        "import client_tpu_torch.observability.roofline\n"
        "import client_tpu_torch.engine.checkpoint\n"
        "import client_tpu_torch.engine.shmring\n"
        "import client_tpu_torch.engine.staged\n"
        "import client_tpu_torch.observability.blackbox\n"
        "import client_tpu_torch.utils.lockdep\n"
        "import client_tpu_torch.utils.shm_ring.staged\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_directory_repository_loads_no_jax():
    """Reading ``models/`` (both pbtxt files through the port's own
    ``load_pbtxt``), building its configs and the repository index, and
    the server's ``--model-repository`` flag load nothing of JAX or the
    JAX package."""
    code = (
        "import sys\n"
        "from client_tpu_torch.engine.config import ModelConfig\n"
        "from client_tpu_torch.engine.repository import ModelRepository\n"
        "from client_tpu_torch.protocol.model_config import load_pbtxt\n"
        "from client_tpu_torch.server.__main__ import main\n"
        "repo = ModelRepository.from_directory('models')\n"
        "assert [e['name'] for e in repo.index()] == [\n"
        "    'ssd_mobilenet_v2_coco_quantized', 'ssd_mobilenet_v2_tpu']\n"
        "for n in repo.names():\n"
        "    ModelConfig.from_dict(load_pbtxt(f'models/{n}/config.pbtxt'))\n"
        "try:\n"
        "    main(['--model-repository', 'no_such_dir', '--device', 'cpu'])\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 2, exc.code\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "model repository 'no_such_dir' is not a directory" in proc.stderr


def test_the_jax_written_fixture_restores_without_them():
    """With JAX, zstandard, orbax, tensorstore and ml_dtypes unimportable,
    the port restores the JAX-written checkpoint and every leaf's SHA-256
    is the one JAX recorded."""
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN + ('ml_dtypes',)}:\n"
        "    sys.modules[name] = None\n"
        "import hashlib, json\n"
        "from client_tpu_torch.engine.model import restoring\n"
        "from client_tpu_torch.engine.checkpoint import flatten\n"
        "from client_tpu_torch.models.generate import TinyGptBackend\n"
        "d = 'tests/torch_data/jax_gpt_ckpt'\n"
        "expect = json.load(open(d + '/expect.json'))\n"
        "with restoring(d + '/ckpt'):\n"
        "    m = TinyGptBackend(device='cpu', **expect['model'])\n"
        "for path, _, leaf in flatten(m.params_to_jax()):\n"
        "    want = expect['leaves']['.'.join(path)]['sha256']\n"
        "    got = hashlib.sha256(leaf.contiguous().numpy().tobytes())\n"
        "    assert got.hexdigest() == want, path\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


CLIENT_MODULES = [
    "client_tpu_torch.http", "client_tpu_torch.grpc",
    "client_tpu_torch.resilience",
    "client_tpu_torch.observability.client_stats",
    "client_tpu_torch.observability.tracing",
    "client_tpu_torch.observability.events", "client_tpu_torch.faults",
    "client_tpu_torch.observability.metrics",
    "client_tpu_torch.protocol.pushback",
    "client_tpu_torch.protocol.loadreport", "client_tpu_torch.router.core",
    "client_tpu_torch.utils.shared_memory",
    "client_tpu_torch.utils.lockdep",
    "client_tpu_torch.utils.shm_ring",
    "client_tpu_torch.utils.shm_ring.staged",
    "client_tpu_torch.observability.blackbox",
    "client_tpu_torch.router", "client_tpu_torch.router.__main__",
    "client_tpu_torch.router.server", "client_tpu_torch.router.fleet",
    "client_tpu_torch.observability.fleet",
    "client_tpu_torch.observability.scrape",
]


@pytest.mark.parametrize("module", CLIENT_MODULES)
def test_clients_load_no_torch(module):
    """The clients, like the JAX package's, need no framework: importing
    one loads neither torch, nor jax, nor the JAX package. Nor do the
    journal, the fault registry and the metric registry, which the
    clients' resilience layer may write to, nor the router and its fleet
    planes, which need no card."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'client_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _chip_smoke(cwd, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    proc = _chip_smoke(REPO, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    if torch.cuda.is_available():  # then it got past the card check
        assert "checkout" in proc.stderr
