"""Directory repositories on the port, held against the JAX package's.

Each case of ``tests/test_repository_dir.py`` runs on both packages from
the same directory: ``ModelRepository.from_directory`` behind each
package's engine (the port on ``device="cpu"``), then the repository
index (rows, states, versions, reasons), metadata (with ``versions``),
config and answers are compared. Integer models answer bit for bit;
BERT carries the JAX package's weights across (``load_jax_params``) and
answers within 2e-2 (bf16 weights and activations, as in
``tests/test_torch_bert.py``), and two versions of one file are equal bit
for bit within one package (the same seeded init). The files say
``platform: "jax"``, and both packages echo the file, so configs compare
whole. The one word that differs on purpose: the port names its own
registry, ``client_tpu_torch.models.register_model``, in a missing
backend's reason.

Weights named by a directory: as in the JAX
``test_two_versions_serve_distinct_weights``, each version restores its
own ``<v>/weights`` checkpoint (written by JAX's ``save_params``) on both
engines; a ``weights_path`` parameter resolves against the version
directory first, then the model directory, on both; a checkpoint that is
missing, broken or of another model fails that model alone, with the
JAX package's words and status.

Also here: the repository index of a model whose build raises and of an
unloaded one (version, state and reason, as the reference gives them),
the name checks, a file that asks for priority levels or queue policies
(refused per model), and the config round trips of every zoo model.
"""

import json
import os

import jax
import numpy as np
import pytest

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu_torch.engine import EngineError, InferRequest, TorchEngine
from client_tpu_torch.engine.config import ModelConfig
from client_tpu_torch.engine.repository import ModelRepository

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS_DIR = os.path.join(REPO_ROOT, "models")
TIMEOUT = 120  # seconds, every request
BERT_ATOL = 2e-2
TINY = dict(seq_len=16, hidden=32, n_layers=2, n_heads=2, ffn=64,
            vocab=128, max_batch_size=4)
VNAME = "vtest_bert_port"

SIMPLE_IO = {
    "input": [{"name": "INPUT0", "data_type": "TYPE_INT32", "dims": [16]},
              {"name": "INPUT1", "data_type": "TYPE_INT32", "dims": [16]}],
    "output": [{"name": "OUTPUT0", "data_type": "TYPE_INT32", "dims": [16]},
               {"name": "OUTPUT1", "data_type": "TYPE_INT32", "dims": [16]}],
}


def _norm_reason(entry: dict) -> dict:
    """The port's index row with its registry's module name read as the
    JAX package's."""
    out = dict(entry)
    if "reason" in out:
        out["reason"] = out["reason"].replace(
            "client_tpu_torch.models.", "client_tpu.models.")
    return out


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 — either package's EngineError
        return ("error", getattr(exc, "status", None), str(exc))


def _view(engine, names) -> dict:
    """Index, metadata and config of ``names``, answers or errors."""
    return {
        "index": [_norm_reason(e) for e in engine.repository_index()],
        **{f"{n}/metadata": _call(engine.model_metadata, n) for n in names},
        **{f"{n}/config": _call(engine.model_config, n) for n in names},
    }


class Sides:
    """The same directory served by each package's engine."""

    def __init__(self, root: str):
        self.port = TorchEngine(ModelRepository.from_directory(root),
                                device="cpu")
        self.jax = TpuEngine(JaxRepository.from_directory(root))

    def view(self, names):
        return _view(self.port, names), _view(self.jax, names)

    def infer(self, name, inputs, version=""):
        out = []
        for engine, req_cls in ((self.port, InferRequest),
                                (self.jax, JaxRequest)):
            out.append(_call(lambda: {
                k: np.asarray(v) for k, v in engine.infer(
                    req_cls(model_name=name, model_version=str(version),
                            inputs=dict(inputs)),
                    timeout_s=TIMEOUT).outputs.items()}))
        return out

    def close(self):
        self.port.shutdown()
        self.jax.shutdown()


@pytest.fixture
def sides_of():
    made = []

    def make(root):
        made.append(Sides(str(root)))
        return made[-1]

    yield make
    for s in made:
        s.close()


def _write_json(mdir, cfg: dict) -> None:
    mdir.mkdir(exist_ok=True)
    (mdir / "config.json").write_text(json.dumps(cfg))


def _simple_pair(seed=0):
    rng = np.random.default_rng(seed)
    return {"INPUT0": rng.integers(-99, 99, (2, 16)).astype(np.int32),
            "INPUT1": rng.integers(-99, 99, (2, 16)).astype(np.int32)}


# -- the in-tree models/ -------------------------------------------------------

@pytest.fixture(scope="module")
def in_tree():
    """The port serving the repo's ``models/``; the JAX repository read
    from it (not loaded: a JAX SSD's init alone is ~26 s here)."""
    port = TorchEngine(ModelRepository.from_directory(MODELS_DIR),
                       device="cpu")
    yield port, JaxRepository.from_directory(MODELS_DIR)
    port.shutdown()


def test_in_tree_models_register(in_tree):
    port, jax_repo = in_tree
    names = [e["name"] for e in port.repository_index()]
    assert names == jax_repo.names() == [
        "ssd_mobilenet_v2_coco_quantized", "ssd_mobilenet_v2_tpu"]
    assert port.repository_index() == [
        {"name": n, "version": "1", "state": "READY"} for n in names]


def test_in_tree_ssd_serves_as_the_zoo_model(in_tree):
    """The directory's SSD is the port's zoo SSD under the file's
    contract: the same answer bit for bit as the zoo model registered in
    code, with the JAX engine's output shapes."""
    from client_tpu_torch.models import build_repository

    port, _ = in_tree
    name = "ssd_mobilenet_v2_coco_quantized"
    img = np.random.default_rng(3).integers(
        0, 255, (1, 300, 300, 3)).astype(np.uint8)
    got = port.infer(InferRequest(
        model_name=name, inputs={"normalized_input_image_tensor": img}),
        timeout_s=TIMEOUT).outputs
    zoo = TorchEngine(build_repository([name]), device="cpu")
    try:
        want = zoo.infer(InferRequest(
            model_name=name, inputs={"normalized_input_image_tensor": img}),
            timeout_s=TIMEOUT).outputs
    finally:
        zoo.shutdown()
    assert {k: v.shape for k, v in got.items()} == {
        "TFLite_Detection_PostProcess": (1, 1, 10, 4),
        "TFLite_Detection_PostProcess:1": (1, 1, 10),
        "TFLite_Detection_PostProcess:2": (1, 1, 10),
        "TFLite_Detection_PostProcess:3": (1, 1)}
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_pbtxt_config_is_authoritative(in_tree):
    """Both SSDs' configs are the files', as the JAX package reads them;
    the in-tree files name no ``label_filename``, so neither package
    attaches the ``labels.txt`` beside one."""
    from client_tpu.engine.config import ModelConfig as JaxConfig
    from client_tpu.protocol.model_config import load_pbtxt as jax_load

    port, _ = in_tree
    for name in ("ssd_mobilenet_v2_coco_quantized", "ssd_mobilenet_v2_tpu"):
        path = os.path.join(MODELS_DIR, name, "config.pbtxt")
        want = JaxConfig.from_dict(jax_load(path))
        assert port.model_config(name) == want.config_dict()
        model = port.repository.get(name)
        assert model.config.parameters == want.parameters == {}
    cfg = port.model_config("ssd_mobilenet_v2_tpu")
    assert cfg["max_batch_size"] == 16
    assert cfg["instance_group"] == [{"count": 2}]
    assert cfg["platform"] == "jax"


def test_load_pbtxt_equals_jax():
    """``load_pbtxt`` of every in-tree file gives the JAX package's dict."""
    from client_tpu.protocol.model_config import load_pbtxt as jax_load
    from client_tpu_torch.protocol.model_config import load_pbtxt

    for name in sorted(os.listdir(MODELS_DIR)):
        path = os.path.join(MODELS_DIR, name, "config.pbtxt")
        assert load_pbtxt(path) == jax_load(path)


# -- config files ---------------------------------------------------------------

def test_config_json_and_zoo_builder(tmp_path, sides_of):
    """A ``config.json`` naming its backend with ``zoo_builder``, with a
    ``max_batch_size`` other than the zoo's: it serves as the JAX package
    serves it, bit for bit, and refuses the same batch with the same
    words."""
    _write_json(tmp_path / "aliased_simple", {
        "name": "aliased_simple", "platform": "jax", "max_batch_size": 4,
        **SIMPLE_IO, "parameters": {"zoo_builder": "simple"}})
    sides = sides_of(tmp_path)
    port, ref = sides.view(["aliased_simple"])
    assert port == ref
    assert port["aliased_simple/config"][1]["max_batch_size"] == 4
    got, want = sides.infer("aliased_simple", _simple_pair())
    assert got[0] == want[0] == "ok"
    for k in want[1]:
        assert got[1][k].tobytes() == want[1][k].tobytes()
    rng = np.random.default_rng(1)
    five = {k: rng.integers(0, 9, (5, 16)).astype(np.int32)
            for k in ("INPUT0", "INPUT1")}
    got, want = sides.infer("aliased_simple", five)
    assert got == want and got[0] == "error"


def test_dlrm_with_a_smaller_batch_limit(tmp_path, sides_of):
    """Device state sized at build (DLRM's padded rows) follows the
    file's ``max_batch_size``, not the zoo's."""
    from client_tpu.models import _REGISTRY as JAX_REGISTRY
    from client_tpu_torch.models import dlrm as torch_dlrm

    jax_cfg = JAX_REGISTRY["dlrm"]().config.config_dict()
    cfg = dict(jax_cfg, max_batch_size=2)
    cfg.pop("backend")
    _write_json(tmp_path / "dlrm", cfg)
    sides = sides_of(tmp_path)
    port, ref = sides.view(["dlrm"])
    assert port == ref
    # The same weights: the JAX backend's seeded init in both.
    ref_model = sides.jax.repository.get("dlrm")
    port_backend = sides.port.repository.get("dlrm").backend
    port_backend.load_state_dict(
        torch_dlrm.params_from_jax(ref_model.backend.make_apply_params()[1]),
        strict=False)
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 4, 2 * 4)
    inputs = {"DENSE": rng.standard_normal((2, 8)).astype(np.float32),
              "INDICES": rng.integers(0, 64, counts.sum()).astype(np.int32),
              "OFFSETS": np.concatenate([[0], np.cumsum(counts)])
              .astype(np.int32)}
    got, want = sides.infer("dlrm", inputs)
    assert got[0] == want[0] == "ok"
    np.testing.assert_allclose(got[1]["OUTPUT0"], want[1]["OUTPUT0"],
                               atol=1e-5)


def test_missing_backend_surfaces_reason(tmp_path, sides_of):
    mdir = tmp_path / "no_such_backend"
    mdir.mkdir()
    (mdir / "config.pbtxt").write_text(
        'name: "no_such_backend"\nplatform: "jax"\n'
        'input [ { name: "X" data_type: TYPE_FP32 dims: [ 4 ] } ]\n'
        'output [ { name: "Y" data_type: TYPE_FP32 dims: [ 4 ] } ]\n')
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 8, **SIMPLE_IO})
    sides = sides_of(tmp_path)
    port, ref = sides.view(["no_such_backend", "simple"])
    assert port == ref
    row = port["index"][0]
    assert row["state"] == "UNAVAILABLE"
    assert "no executable backend" in row["reason"]
    reason = sides.port.repository_index()[0]["reason"]
    assert "client_tpu_torch.models.register_model('no_such_backend')" \
        in reason and "zoo_builder" in reason
    assert port["index"][1] == {"name": "simple", "version": "1",
                                "state": "READY"}


def test_label_filename_resolution(tmp_path):
    """Labels read from ``label_filename`` land where the classification
    extension reads them; the answers of both servers equal."""
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import HttpInferenceServer

    mdir = tmp_path / "labeled"
    mdir.mkdir()
    (mdir / "labels.txt").write_text(
        "".join(f"class{i}\n" for i in range(16)))
    (mdir / "config.pbtxt").write_text(
        'name: "labeled"\nplatform: "jax"\nmax_batch_size: 4\n'
        'input [ { name: "INPUT0" data_type: TYPE_INT32 dims: [ 16 ] },\n'
        '        { name: "INPUT1" data_type: TYPE_INT32 dims: [ 16 ] } ]\n'
        'output [ { name: "OUTPUT0" data_type: TYPE_INT32 dims: [ 16 ]\n'
        '           label_filename: "labels.txt" },\n'
        '         { name: "OUTPUT1" data_type: TYPE_INT32 dims: [ 16 ] } ]\n'
        'parameters [ { key: "zoo_builder" value: { string_value: "simple" } } ]\n')
    repo = ModelRepository.from_directory(str(tmp_path))
    model = repo.load("labeled", "cpu")
    labels = [f"class{i}" for i in range(16)]
    assert model.config.parameters["labels"]["OUTPUT0"] == labels
    assert JaxRepository.from_directory(str(tmp_path)).load(
        "labeled").config.parameters["labels"]["OUTPUT0"] == labels

    body = json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "data": list(range(16)) if n == "INPUT0" else [3] * 16}
        for n in ("INPUT0", "INPUT1")],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"classification": 3}}]})
    answers = []
    for engine, server_cls in (
            (TorchEngine(ModelRepository.from_directory(str(tmp_path)),
                         device="cpu"), HttpInferenceServer),
            (TpuEngine(JaxRepository.from_directory(str(tmp_path))),
             JaxHttp)):
        server = server_cls(engine, port=0).start()
        try:
            answers.append(_post(server.url, "/v2/models/labeled/infer",
                                 body))
        finally:
            server.stop()
            engine.shutdown()
    assert answers[0] == answers[1]
    assert answers[0][0] == 200
    assert answers[0][1]["outputs"][0]["data"] == [
        "18.000000:15:class15", "17.000000:14:class14",
        "16.000000:13:class13"]


def _post(url, path, body):
    import http.client

    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, json.loads(data) if data else None


SEQ_PBTXT = '''
name: "seqmodel"
platform: "jax"
sequence_batching {
  max_sequence_idle_microseconds: 5000000
  oldest { max_candidate_sequences: 12 max_queue_delay_microseconds: 500 }
}
input [ { name: "INPUT" data_type: TYPE_INT32 dims: [ 1 ] } ]
output [ { name: "OUTPUT" data_type: TYPE_INT32 dims: [ 1 ] } ]
parameters [ { key: "zoo_builder"
               value: { string_value: "simple_sequence_oldest" } } ]
'''


def test_pbtxt_sequence_oldest_knobs(tmp_path, sides_of):
    """The oldest strategy's knobs from a pbtxt reach the engine's config
    as the JAX package reads them, and size the state arena the port
    allocates when the scheduler starts; a sequence's running sums are
    the JAX engine's."""
    from client_tpu.engine.config import ModelConfig as JaxConfig
    from client_tpu.protocol.model_config import load_pbtxt as jax_load
    from client_tpu_torch.protocol.model_config import load_pbtxt

    mdir = tmp_path / "seqmodel"
    mdir.mkdir()
    (mdir / "config.pbtxt").write_text(SEQ_PBTXT)
    path = str(mdir / "config.pbtxt")
    cfg = ModelConfig.from_dict(load_pbtxt(path))
    ref = JaxConfig.from_dict(jax_load(path))
    sb = cfg.sequence_batching
    assert (sb.strategy, sb.max_candidate_sequences,
            sb.max_queue_delay_microseconds,
            sb.max_sequence_idle_microseconds) == ("oldest", 12, 500,
                                                   5_000_000)
    assert vars(sb) == vars(ref.sequence_batching)

    sides = sides_of(tmp_path)
    sched = sides.port._schedulers["seqmodel"]
    assert sched._cap == 12 and sched._arena.shape[0] == 13
    sums = []
    for engine, req_cls in ((sides.port, InferRequest),
                            (sides.jax, JaxRequest)):
        run = []
        for step, x in enumerate((5, 7, -2)):
            resp = engine.infer(req_cls(
                model_name="seqmodel", sequence_id=41,
                sequence_start=step == 0, sequence_end=step == 2,
                inputs={"INPUT": np.array([x], np.int32)}),
                timeout_s=TIMEOUT)
            run.append(np.asarray(resp.outputs["OUTPUT"]).tolist())
        sums.append(run)
    assert sums[0] == sums[1] == [[5], [12], [10]]


def test_priority_and_queue_policies_are_refused_per_model(tmp_path,
                                                           sides_of):
    """A priority or queue-policy field that is not a number fails its
    own model in both packages; the other models load."""
    asks = {
        "prio": {"priority_levels": "two"},
        "policy": {"default_queue_policy": {"max_queue_size": "many"}},
        "levels": {"priority_levels": 2, "priority_queue_policy": {
            "first": {"timeout_action": "DELAY"}}},
    }
    for name, extra in asks.items():
        _write_json(tmp_path / name, {
            "name": name, "platform": "jax", "max_batch_size": 8,
            **SIMPLE_IO, "parameters": {"zoo_builder": "simple"},
            "dynamic_batching": {"max_queue_delay_microseconds": 100,
                                 **extra}})
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 8, **SIMPLE_IO})
    sides = sides_of(tmp_path)
    rows = {e["name"]: e for e in sides.port.repository_index()}
    for name in asks:
        assert rows[name]["state"] == "UNAVAILABLE", rows[name]
        assert rows[name].get("reason"), rows[name]
        assert not sides.jax.model_is_ready(name)
    assert rows["simple"]["state"] == "READY"
    assert sides.jax.model_is_ready("simple")


def test_priority_and_queue_policies_load_as_jax(tmp_path, sides_of):
    """A file with priority levels, a queue policy or
    ``preserve_ordering`` loads in the port as in the JAX package, with
    the same config round trip, and serves."""
    asks = {
        "prio": {"priority_levels": 2, "default_priority_level": 1},
        "policy": {"default_queue_policy": {"max_queue_size": 4}},
        "levels": {"priority_levels": 2, "priority_queue_policy": {
            "1": {"timeout_action": "DELAY"}}},
        "ordered": {"preserve_ordering": True},
    }
    for name, extra in asks.items():
        _write_json(tmp_path / name, {
            "name": name, "platform": "jax", "max_batch_size": 8,
            **SIMPLE_IO, "parameters": {"zoo_builder": "simple"},
            "dynamic_batching": {"max_queue_delay_microseconds": 100,
                                 **extra}})
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 8, **SIMPLE_IO})
    sides = sides_of(tmp_path)
    rows = {e["name"]: e for e in sides.port.repository_index()}
    for name in list(asks) + ["simple"]:
        assert rows[name]["state"] == "READY", rows[name]
        assert sides.jax.model_is_ready(name)
        got = sides.port.model_config(name)["dynamic_batching"] \
            if name != "simple" else None
        want = sides.jax.model_config(name)["dynamic_batching"] \
            if name != "simple" else None
        assert got == want
        out, ref = sides.infer(name, _simple_pair())
        assert out[0] == ref[0] == "ok", (name, out, ref)
        assert {k: v.tolist() for k, v in out[1].items()} \
            == {k: v.tolist() for k, v in ref[1].items()}


# -- versions ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vbert():
    """``VNAME`` in both zoos: a tiny BERT, the port's with the JAX
    backend's seeded weights."""
    import client_tpu.models as jax_zoo
    import client_tpu_torch.models as torch_zoo
    from client_tpu.models.bert import BertBackend as JaxBert
    from client_tpu_torch.models.bert import BertBackend as TorchBert

    params = jax.tree_util.tree_map(
        np.asarray, JaxBert(name=VNAME, **TINY)._init_params())

    def port_builder(device):
        backend = TorchBert(name=VNAME, device=device, **TINY)
        if backend.weights_path is None:  # no checkpoint named: JAX's init
            backend.load_jax_params(params)
        return backend

    jax_zoo._import_all()
    torch_zoo._import_all()
    jax_zoo.register_model(VNAME, default=False)(
        lambda: JaxBert(name=VNAME, **TINY))
    torch_zoo.register_model(VNAME, default=False)(port_builder)
    yield
    for zoo in (jax_zoo, torch_zoo):
        zoo._REGISTRY.pop(VNAME, None)
        zoo._NON_DEFAULT.discard(VNAME)


def _vbert_config(name=VNAME) -> dict:
    return {"name": name, "platform": "jax", "max_batch_size": 4,
            "input": [{"name": "input_ids", "data_type": "TYPE_INT32",
                       "dims": [16]},
                      {"name": "attention_mask", "data_type": "TYPE_INT32",
                       "dims": [16]}],
            "output": [{"name": "logits", "data_type": "TYPE_FP32",
                        "dims": [2]}]}


def _versioned(root, policy, versions=(1, 2)):
    mdir = root / VNAME
    cfg = _vbert_config()
    if policy is not None:
        cfg["version_policy"] = policy
    _write_json(mdir, cfg)
    for v in versions:
        (mdir / str(v)).mkdir()
    return mdir


def _bert_inputs():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 128, (1, 16)).astype(np.int32),
            "attention_mask": np.ones((1, 16), np.int32)}


def _bert_answers(sides, version=""):
    got, want = sides.infer(VNAME, _bert_inputs(), version)
    assert got[0] == want[0]
    if got[0] == "ok":
        np.testing.assert_allclose(got[1]["logits"], want[1]["logits"],
                                   atol=BERT_ATOL)
    else:
        assert got == want
    return got


def test_two_versions_serve_alike(tmp_path, sides_of, vbert):
    _versioned(tmp_path, {"all": {}})
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME])
    assert port == ref
    assert port[f"{VNAME}/metadata"][1]["versions"] == ["1", "2"]
    assert [e["version"] for e in port["index"]] == ["1", "2"]
    v1 = _bert_answers(sides, 1)[1]["logits"]
    v2 = _bert_answers(sides, 2)[1]["logits"]
    latest = _bert_answers(sides)[1]["logits"]
    # One seeded init: two versions of one file are the same weights.
    assert v1.tobytes() == v2.tobytes() == latest.tobytes()
    for engine in (sides.port, sides.jax):
        s1 = engine.model_statistics(VNAME, "1")["model_stats"]
        s2 = engine.model_statistics(VNAME, "2")["model_stats"]
        assert [(s["version"], s["inference_count"]) for s in s1] == [("1", 1)]
        assert [(s["version"], s["inference_count"]) for s in s2] == [("2", 2)]
        assert [s["version"] for s in
                engine.model_statistics(VNAME)["model_stats"]] == ["1", "2"]
    got = _bert_answers(sides, 9)
    assert got[:2] == ("error", 404)


def test_default_policy_serves_latest_only(tmp_path, sides_of, vbert):
    _versioned(tmp_path, None)
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME])
    assert port == ref
    assert port[f"{VNAME}/metadata"][1]["versions"] == ["2"]
    _bert_answers(sides)
    assert _bert_answers(sides, 1)[:2] == ("error", 404)


def test_specific_policy(tmp_path, sides_of, vbert):
    _versioned(tmp_path, {"specific": {"versions": [1]}})
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME])
    assert port == ref
    assert port[f"{VNAME}/metadata"][1]["versions"] == ["1"]
    _bert_answers(sides, 1)


def test_specific_policy_without_its_directory(tmp_path, sides_of, vbert):
    """A specific version with no directory is a 400 for that model."""
    _versioned(tmp_path, {"specific": {"versions": [3]}})
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 8, **SIMPLE_IO})
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME, "simple"])
    assert port == ref
    row = port["index"][1]
    assert row["state"] == "UNAVAILABLE" and "[3]" in row["reason"]


def _save_bert(path, scale):
    """A checkpoint of ``VNAME``'s JAX init with the pooler scaled, written
    by JAX's ``save_params``."""
    from client_tpu.engine.checkpoint import save_params
    from client_tpu.models.bert import BertBackend as JaxBert

    params = jax.tree_util.tree_map(
        np.copy, JaxBert(name=VNAME, **TINY)._init_params())
    params["pooler"]["w"] = np.asarray(params["pooler"]["w"]) * scale
    save_params(str(path), params)


def test_two_versions_serve_distinct_weights(tmp_path, sides_of, vbert):
    """Counterpart of the JAX test of this name: each version restores its
    own ``<v>/weights``, on both engines, with the same answers."""
    mdir = _versioned(tmp_path, {"all": {}})
    # Scales below 1: the logits stay at the unscaled model's size, where
    # the packages' bf16 roundings differ by less than BERT_ATOL.
    for v, scale in ((1, 0.5), (2, 0.25)):
        _save_bert(mdir / str(v) / "weights", scale)
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME])
    assert port == ref
    assert port[f"{VNAME}/metadata"][1]["versions"] == ["1", "2"]
    v1 = _bert_answers(sides, 1)[1]["logits"]
    v2 = _bert_answers(sides, 2)[1]["logits"]
    latest = _bert_answers(sides)[1]["logits"]
    assert not np.allclose(v1, v2)
    assert latest.tobytes() == v2.tobytes()
    for engine in (sides.port, sides.jax):
        assert [s["inference_count"] for s in engine.model_statistics(
            VNAME)["model_stats"]] == [1, 2]
    assert _bert_answers(sides, 9)[:2] == ("error", 404)


def test_weights_path_resolves_version_directory_first(tmp_path, sides_of,
                                                      vbert):
    """``weights_path: "ckpt"`` names ``<v>/ckpt`` where version ``v`` has
    one and ``<model>/ckpt`` where it does not, on both engines."""
    mdir = _versioned(tmp_path, {"all": {}})
    cfg = json.loads((mdir / "config.json").read_text())
    cfg["parameters"] = {"weights_path": "ckpt"}
    (mdir / "config.json").write_text(json.dumps(cfg))
    _save_bert(mdir / "ckpt", 0.25)
    _save_bert(mdir / "2" / "ckpt", 0.75)
    sides = sides_of(tmp_path)
    port, ref = sides.view([VNAME])
    assert port == ref
    v1 = _bert_answers(sides, 1)[1]["logits"]
    v2 = _bert_answers(sides, 2)[1]["logits"]
    assert not np.allclose(v1, v2)
    # v1 is the model directory's checkpoint: the same weights as a
    # version that names it by its absolute path.
    other = tmp_path / "other"
    other.mkdir()
    odir = _versioned(other, None, versions=(1,))
    ocfg = json.loads((odir / "config.json").read_text())
    ocfg["parameters"] = {"weights_path": str(mdir / "ckpt")}
    (odir / "config.json").write_text(json.dumps(ocfg))
    again = sides_of(other)
    assert _bert_answers(again)[1]["logits"].tobytes() == v1.tobytes()


def test_a_broken_checkpoint_fails_only_its_model(tmp_path, sides_of, vbert):
    """A checkpoint that is truncated, one of another architecture and one
    that is missing each fail their own model with the JAX package's
    status and words; a model with a good checkpoint and ``simple``
    beside them load."""
    from client_tpu.engine.checkpoint import save_params
    from client_tpu.models.bert import BertBackend as JaxBert

    weights = {}
    for name in ("good", "truncated", "other", "gone"):
        _write_json(tmp_path / name, {
            **_vbert_config(name), "parameters": {
                "zoo_builder": VNAME,
                **({"weights_path": "nowhere"} if name == "gone" else {})}})
        (tmp_path / name / "1").mkdir()
        weights[name] = tmp_path / name / "1" / "weights"
    _save_bert(weights["good"], 0.5)
    _save_bert(weights["truncated"], 0.5)
    manifest = weights["truncated"] / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:40])
    save_params(str(weights["other"]), JaxBert(
        name=VNAME, **{**TINY, "n_layers": 3})._init_params())
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 8, **SIMPLE_IO})
    sides = sides_of(tmp_path)
    port, ref = sides.view(["simple"])
    rows = {e["name"]: e for e in port["index"]}
    ref_rows = {e["name"]: e for e in ref["index"]}
    assert rows.keys() == ref_rows.keys()
    for name in ("good", "simple"):
        assert rows[name]["state"] == ref_rows[name]["state"] == "READY"
    nowhere = tmp_path / "gone" / "nowhere"
    assert rows["gone"] == ref_rows["gone"] == {
        "name": "gone", "version": "1", "state": "UNAVAILABLE",
        "reason": f"weights checkpoint '{nowhere}' not found"}
    for name in ("truncated", "other"):
        prefix = (f"weights checkpoint '{weights[name]}' does not match "
                  "the model's parameter tree: ")
        for row in (rows[name], ref_rows[name]):
            assert row["state"] == "UNAVAILABLE"
            assert row["reason"].startswith(prefix)
    got, want = sides.infer("good", _bert_inputs())
    np.testing.assert_allclose(got[1]["logits"], want[1]["logits"],
                               atol=BERT_ATOL)
    for engine in (sides.port, sides.jax):
        with pytest.raises(Exception) as exc:
            engine.load_model("gone")
        assert exc.value.status == 400


class TestReloadRepolls:
    """A load of a loaded model re-polls its directory: a version directory
    added since is served, a version that left the policy retires, an
    unchanged version keeps its model and scheduler."""

    def _v1_only(self, tmp_path, policy):
        _versioned(tmp_path, policy, versions=(1,))
        return tmp_path / VNAME

    def test_new_version_dir_served_after_reload(self, tmp_path, sides_of,
                                                 vbert):
        mdir = self._v1_only(tmp_path, {"all": {}})
        sides = sides_of(tmp_path)
        v1_model = sides.port.repository.get(VNAME, 1)
        (mdir / "2").mkdir()
        for engine in (sides.port, sides.jax):
            engine.load_model(VNAME)
        port, ref = sides.view([VNAME])
        assert port == ref
        assert port[f"{VNAME}/metadata"][1]["versions"] == ["1", "2"]
        assert sides.port.repository.get(VNAME, 1) is v1_model
        assert sides.port.scheduler_for(VNAME) is \
            sides.port.scheduler_for(VNAME, 2)
        _bert_answers(sides, 2)
        _bert_answers(sides)

    def test_latest_policy_retires_old_version_on_reload(
            self, tmp_path, sides_of, vbert):
        mdir = self._v1_only(tmp_path, None)
        sides = sides_of(tmp_path)
        v1_sched = sides.port.scheduler_for(VNAME, 1)
        (mdir / "2").mkdir()
        for engine in (sides.port, sides.jax):
            engine.load_model(VNAME)
        port, ref = sides.view([VNAME])
        assert port == ref
        assert port[f"{VNAME}/metadata"][1]["versions"] == ["2"]
        assert _bert_answers(sides, 1)[:2] == ("error", 404)
        _bert_answers(sides, 2)
        assert sides.port.scheduler_for(VNAME, 1) is None
        assert not any(t.is_alive() for t in v1_sched.workers)

    def test_reload_without_changes_is_noop(self, tmp_path, sides_of,
                                            vbert):
        _versioned(tmp_path, {"all": {}})
        sides = sides_of(tmp_path)
        repo = sides.port.repository
        m1, m2 = repo.get(VNAME, 1), repo.get(VNAME, 2)
        s = sides.port.scheduler_for(VNAME, 1)
        sides.port.load_model(VNAME)
        assert repo.get(VNAME, 1) is m1 and repo.get(VNAME, 2) is m2
        assert sides.port.scheduler_for(VNAME, 1) is s


def test_colon_model_name_contained_per_model(tmp_path, sides_of):
    _write_json(tmp_path / "simple", {"name": "simple", "platform": "jax",
                                      "max_batch_size": 4, **SIMPLE_IO})
    _write_json(tmp_path / "badname", {"name": "m:1", "platform": "jax",
                                       "max_batch_size": 1, "input": [],
                                       "output": []})
    sides = sides_of(tmp_path)
    port, ref = sides.view(["badname", "simple"])
    assert port == ref
    assert port["index"][0] == {
        "name": "badname", "version": "1", "state": "UNAVAILABLE",
        "reason": "invalid model name 'm:1': ':' is reserved"}
    for repo in (ModelRepository.from_directory(str(tmp_path)),
                 JaxRepository.from_directory(str(tmp_path))):
        with pytest.raises(Exception) as exc:
            repo.load("badname", "cpu") if isinstance(
                repo, ModelRepository) else repo.load("badname")
        assert exc.value.status == 400
        assert "reserved" in str(exc.value)


# -- the index of a failed and of an unloaded model ------------------------------

def _boom_port(device):
    raise EngineError("boom: the build failed", 400)


def _boom_jax():
    from client_tpu.engine.types import EngineError as JaxError

    raise JaxError("boom: the build failed", 400)


def test_index_of_a_failed_and_an_unloaded_model_equals_jax():
    """A model whose build raises, numbered or not, and an unloaded one:
    the same rows, states, versions and reasons as the JAX package's, and
    the rest of the repository loads."""
    from client_tpu.models import _REGISTRY as JAX_REGISTRY
    from client_tpu_torch.models import _REGISTRY, _import_all

    _import_all()
    port_repo, jax_repo = ModelRepository(), JaxRepository()
    port_repo.register("simple", _REGISTRY["simple"])
    jax_repo.register("simple", JAX_REGISTRY["simple"])
    port_repo.register("boom", _boom_port)
    jax_repo.register("boom", _boom_jax)
    port_repo.register("boom_v", _boom_port, version=3)
    jax_repo.register("boom_v", _boom_jax, version=3)
    port, ref = TorchEngine(port_repo, device="cpu"), TpuEngine(jax_repo)
    try:
        assert port.repository_index() == ref.repository_index() == [
            {"name": "boom", "version": "1", "state": "UNAVAILABLE",
             "reason": "boom: the build failed"},
            {"name": "boom_v", "version": "3", "state": "UNAVAILABLE",
             "reason": "boom: the build failed"},
            {"name": "simple", "version": "1", "state": "READY"}]
        for engine in (port, ref):
            engine.unload_model("simple")
        assert port.repository_index() == ref.repository_index()
        assert port.repository_index()[2] == {
            "name": "simple", "version": "1", "state": "UNAVAILABLE",
            "reason": "unloaded"}
    finally:
        port.shutdown()
        ref.shutdown()


def test_colon_in_a_registered_name_has_the_reference_words():
    from client_tpu.engine.types import EngineError as JaxError

    words = []
    for repo, err in ((ModelRepository(), EngineError),
                      (JaxRepository(), JaxError)):
        with pytest.raises(err) as exc:
            repo.register("m:1", lambda *a: None)
        words.append((exc.value.status, str(exc.value)))
    assert words[0] == words[1] == (
        400, "invalid model name 'm:1': ':' is reserved")


def test_slash_in_a_name_is_refused_because_no_route_reaches_it():
    """Every HTTP route takes the model name as one path segment
    (``/v2/models/<m>/...``), so a model named ``a/b`` could be served
    to no one; the port refuses the name (the JAX package registers it)."""
    from client_tpu_torch.models import _REGISTRY, _import_all
    from client_tpu_torch.server.http_server import _ROUTES

    path = "/v2/models/a/b/infer"
    matches = [name for method, pat, name in _ROUTES
               if method == "POST" and (m := pat.match(path))
               and m.group(1) == "a/b"]
    assert matches == []
    _import_all()
    with pytest.raises(EngineError) as exc:
        ModelRepository().register("a/b", _REGISTRY["simple"])
    assert (exc.value.status, str(exc.value)) == (
        400, "invalid model name 'a/b': '/' is reserved")


# -- config round trips ------------------------------------------------------------

def _zoo_configs():
    import torch

    from client_tpu.models import _REGISTRY as JAX_REGISTRY
    from client_tpu_torch.models import _REGISTRY, _import_all

    _import_all()
    names = sorted(_REGISTRY)
    assert set(names) <= set(JAX_REGISTRY)
    cpu = torch.device("cpu")
    return {n: (_REGISTRY[n](cpu).config, JAX_REGISTRY[n]().config)
            for n in names}


@pytest.fixture(scope="module")
def zoo_configs():
    return _zoo_configs()


def test_config_round_trip_of_every_zoo_model(zoo_configs):
    """``ModelConfig.from_dict(cfg.config_dict())`` is ``cfg`` for every
    zoo model but for ``optional``, which the config JSON does not carry
    in either package: ``simple_repeat``'s optional ``DELAY`` comes back
    required from both."""
    from client_tpu.engine.config import ModelConfig as JaxConfig

    assert len(zoo_configs) >= 20
    for name, (cfg, ref) in zoo_configs.items():
        back = ModelConfig.from_dict(cfg.config_dict())
        ref_back = JaxConfig.from_dict(ref.config_dict())
        dropped = [t.name for t in cfg.input if t.optional]
        assert dropped == [t.name for t in ref.input if t.optional]
        for t in back.input + ref_back.input:
            if t.name in dropped:
                assert not t.optional
                t.optional = True
        assert back == cfg, name
        assert dropped == (["DELAY"] if name == "simple_repeat" else [])


def test_config_dict_of_every_zoo_model_equals_jax(zoo_configs):
    """The port's ``config_dict()`` is the JAX package's, but the
    platform (``pytorch`` against ``jax``) for the models that run one."""
    for name, (cfg, ref) in zoo_configs.items():
        got, want = cfg.config_dict(), ref.config_dict()
        if cfg.platform != "ensemble":
            assert (got.pop("platform"), got.pop("backend")) == (
                "pytorch", "pytorch"), name
            want.pop("platform"), want.pop("backend")
        assert got == want, name


def test_proto_round_trip_of_every_zoo_model_equals_jax(zoo_configs):
    """``config_dict_to_proto`` then ``proto_to_config_dict`` gives the
    JAX package's round trip. A BYTES tensor, which the JAX package's
    ``config_dict_to_proto`` refuses in its ``TYPE_BYTES`` spelling,
    goes through it as ``BYTES``."""
    from client_tpu.protocol import model_config as jax_mc
    from client_tpu_torch.protocol import model_config as torch_mc

    for name, (cfg, ref) in zoo_configs.items():
        d = ref.config_dict()
        for t in d["input"] + d["output"]:
            if t["data_type"] == "TYPE_BYTES":
                t["data_type"] = "BYTES"
        want = jax_mc.proto_to_config_dict(jax_mc.config_dict_to_proto(d))
        got = torch_mc.proto_to_config_dict(
            torch_mc.config_dict_to_proto(cfg.config_dict()))
        if cfg.platform != "ensemble":
            got["platform"] = want["platform"]
        assert got == want, name


def test_metadata_lists_the_loaded_versions():
    cfg = ModelConfig(name="m", version=2)
    assert cfg.metadata_dict()["versions"] == ["2"]
    assert cfg.metadata_dict(versions=["1", "2"])["versions"] == ["1", "2"]

