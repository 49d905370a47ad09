"""``moe_lm_mc`` and ``pipelined_lm_mc`` against the JAX package's, on the
CPU, and the six ``*_mc`` families served over HTTP and gRPC.

Each LM runs through the port's ``TorchEngine`` on a mesh of ``["cpu"] *
8`` and through the JAX ``TpuEngine`` on the 8 virtual CPU devices of
``tests/conftest.py`` (the same mesh shape), on the JAX init's parameters
carried across. Tolerance: logits within 1e-4 absolute (fp32 throughout;
the tp partials and the expert outputs are summed in another order, and
logits are of magnitude ~1). The MoE capacity is the JAX formula on the
padded bucket, so the same tokens overflow in both.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.parallel import mesh as jmesh
from client_tpu.parallel import serving as jserving
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.model import restoring
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models import build_repository
from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import pipeline as tpipe
from client_tpu_torch.parallel import serving as tserving
from client_tpu_torch.parallel.training import _rms_norm

CPU8 = ["cpu"] * 8
ATOL = 1e-4
FAMILIES = {"moe_lm_mc": ("MoeLmBackend", ("dp", "ep", "tp")),
            "pipelined_lm_mc": ("PipelinedLmBackend", ("dp", "pp"))}


def _ids(batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(batch, 32)).astype(np.int32)


def _jax_params(name):
    cls, axes = FAMILIES[name]
    backend = getattr(jserving, cls)(mesh=jmesh.make_mesh(8, axes=axes))
    return jax.tree.map(np.asarray, backend._init_params())


def _port(name, device="cpu", params=None, axes=None, **kw):
    cls, default_axes = FAMILIES[name]
    backend = getattr(tserving, cls)(
        tmesh.make_mesh(8, axes=axes or default_axes, devices=CPU8),
        device=device, **kw)
    if params is not None:
        backend.load_jax_params(params)
    return backend


@pytest.fixture(scope="module")
def engines():
    jrepo = JaxRepository()
    repo = ModelRepository()
    for name, (cls, axes) in FAMILIES.items():
        jrepo.register_backend(getattr(jserving, cls)(
            mesh=jmesh.make_mesh(8, axes=axes)))
        params = _jax_params(name)
        repo.register(name, lambda device, name=name, params=params: _port(
            name, device, params))
    jeng, teng = TpuEngine(jrepo), TorchEngine(repo, device="cpu")
    yield jeng, teng
    teng.shutdown()
    jeng.shutdown()


@pytest.mark.parametrize("batch", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_lm_equals_jax_through_the_engine(engines, name, batch):
    jeng, teng = engines
    ids = _ids(batch, seed=batch)
    want = jeng.infer(JaxRequest(model_name=name, inputs={"INPUT_IDS": ids}),
                      timeout_s=300).outputs["LOGITS"]
    got = teng.infer(InferRequest(model_name=name, inputs={"INPUT_IDS": ids}),
                     timeout_s=300).outputs["LOGITS"]
    assert got.shape == (batch, 32, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_repeat_calls_are_deterministic(engines, name):
    _jeng, teng = engines
    ids = _ids(2, seed=9)
    out = [teng.infer(InferRequest(model_name=name, inputs={"INPUT_IDS": ids}),
                      timeout_s=300).outputs["LOGITS"] for _ in range(2)]
    np.testing.assert_array_equal(out[0], out[1])


def test_odd_batch_pads_to_a_dp_bucket(engines):
    _jeng, teng = engines
    model = teng._schedulers["moe_lm_mc"].model
    assert model.config.effective_buckets() == [2, 4, 8]
    assert model.pick_bucket(3) == 4


def test_moe_capacity_is_the_jax_formula_on_the_bucket():
    backend = _port("moe_lm_mc")
    for rows in (2, 4, 8):
        assert backend.capacity(rows) == int(np.ceil(rows * 32 / 2 * 1.25))


def test_moe_lm_overflow_drops_as_jax_does():
    """A bucket whose tokens all route to one expert overflows its
    capacity in both packages alike (capacity factor 0.5)."""
    params = _jax_params("moe_lm_mc")
    for lp in params["layers"]:
        lp["router"] = np.zeros_like(lp["router"])
        lp["router"][:, 0] = 1.0
    ids = _ids(2, seed=4)
    jb = jserving.MoeLmBackend(mesh=jmesh.make_mesh(8, axes=("dp", "ep", "tp")),
                               capacity_factor=0.5)
    apply, _ = jb.make_apply_params()
    want = np.asarray(apply(jb.place_params(params),
                            {"INPUT_IDS": jnp.asarray(ids)})["LOGITS"])
    got = _port("moe_lm_mc", params=params, capacity_factor=0.5)(
        {"INPUT_IDS": torch.from_numpy(ids)})["LOGITS"].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_moe_lm_loads_on_an_ep_less_mesh():
    """A mesh without an ep axis replicates the expert stacks instead of
    failing at placement (specs drop mesh-absent axes)."""
    params = _jax_params("moe_lm_mc")
    backend = _port("moe_lm_mc", params=params, axes=("dp", "tp"))
    assert backend.placed()["layers"][0]["w1e"].axes == ("tp",)
    ids = _ids(2, seed=5)
    got = backend({"INPUT_IDS": torch.from_numpy(ids)})["LOGITS"]
    assert got.shape == (2, 32, 256)
    jb = jserving.MoeLmBackend(mesh=jmesh.make_mesh(8, axes=("dp", "tp")))
    apply, _ = jb.make_apply_params()
    want = apply(jb.place_params(params), {"INPUT_IDS": jnp.asarray(ids)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want["LOGITS"]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["ShardedBertBackend",
                                    "LongContextBertBackend",
                                    "ShardedTinyGptBackend", "MoeGptBackend",
                                    "MoeLmBackend", "PipelinedLmBackend"])
def test_entry_points_run_on_the_card_unless_asked(family):
    """``device=None`` means cuda: without a card a family raises, with or
    without a mesh, and a mesh on another device than the backend's is
    refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cls = getattr(tserving, family)
    axes = {"ShardedBertBackend": ("dp", "tp"),
            "LongContextBertBackend": ("dp", "sp"),
            "ShardedTinyGptBackend": ("tp",), "MoeGptBackend": ("ep", "tp"),
            "MoeLmBackend": ("dp", "ep", "tp"),
            "PipelinedLmBackend": ("dp", "pp")}[family]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(tmesh.make_mesh(8, axes=axes, devices=CPU8))
    with pytest.raises(ValueError, match="the mesh is on meta"):
        cls(tmesh.make_mesh(8, axes=axes, devices=["meta"] * 8),
            device="cpu")


def test_lm_checks():
    with pytest.raises(ValueError, match="n_experts"):
        _port("moe_lm_mc", n_experts=3)
    with pytest.raises(ValueError, match="pp"):
        tserving.PipelinedLmBackend(
            tmesh.make_mesh(8, axes=("dp", "tp"), devices=CPU8), device="cpu")
    with pytest.raises(ValueError, match=r"n_layers \(6\)"):
        _port("pipelined_lm_mc", n_layers=6)


def test_pipelined_lm_equals_the_sequential_oracle():
    """Stages pp-split, the output is the blocks applied in order on one
    device (``reference_forward``)."""
    backend = _port("pipelined_lm_mc")
    assert backend.n_layers == 4
    assert backend.placed()["wq"].part(pp=3).shape == (1, 64, 64)
    ids = torch.from_numpy(_ids(2, seed=6))
    got = backend({"INPUT_IDS": ids})["LOGITS"]
    tree = backend.params_to_jax()
    mask = torch.ones(32, 32, dtype=torch.bool).tril()
    x = tpipe.reference_forward(
        {k: tree[k] for k in tpipe.BLOCK_KEYS}, tree["embed"][ids.long()], 4,
        mask)
    want = _rms_norm(x) @ tree["unembed"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_config_equals_jax_on_the_same_mesh(name):
    cls, axes = FAMILIES[name]
    want = getattr(jserving, cls)(mesh=jmesh.make_mesh(8, axes=axes)).config
    got = _port(name).config
    g, w = got.config_dict(), want.config_dict()
    for d in (g, w):
        d.pop("platform"), d.pop("backend")
    assert g == w
    assert got.effective_buckets() == want.effective_buckets()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_weights_path_round_trip(tmp_path, name):
    """A perturbed checkpoint written by the JAX package restores onto the
    mesh, changes the outputs, and equals the same tree fed directly."""
    from client_tpu.engine.checkpoint import save_params

    params = _jax_params(name)
    if name == "moe_lm_mc":
        params["layers"][0]["w1e"] = params["layers"][0]["w1e"] * 0.25
    else:
        params["w1"] = params["w1"] * 0.25
    path = save_params(str(tmp_path / name), params)
    ids = {"INPUT_IDS": torch.from_numpy(_ids(2, seed=7))}
    rand = _port(name)(ids)["LOGITS"]
    with restoring(path):
        ckpt = _port(name)
    got = ckpt(ids)["LOGITS"]
    assert not torch.allclose(rand, got)
    want = _port(name, params=params)(ids)["LOGITS"]
    assert torch.equal(got, want)
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(ckpt.params_to_jax())):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", list(FAMILIES))
def test_registered_builder_is_the_jax_zoos(name):
    from client_tpu.models import _REGISTRY as jax_registry

    got = build_repository([name])._builders[name][None](torch.device("cpu"))
    want = jax_registry[name]()
    assert got.mesh.size == 1
    for attr in ("seq_len", "d_model", "d_ff", "n_layers", "n_heads",
                 "vocab"):
        assert getattr(got, attr) == getattr(want, attr), attr
    g, w = got.config.config_dict(), want.config.config_dict()
    for d in (g, w):
        d.pop("platform"), d.pop("backend")
    assert g == w


# -- the six families over HTTP and gRPC --------------------------------------------

SMALL_BERT = dict(hidden=64, n_layers=2, n_heads=4, ffn=128, vocab=512)
SMALL_GPT = dict(n_layers=2, max_seq_len=32, max_streams=4)


@pytest.fixture(scope="module")
def served():
    """One port engine with the six families (their JAX zoo widths, cut to
    2 layers where that is cheap on the CPU; meshes of ["cpu"] * 8) behind
    the port's HTTP and gRPC servers."""
    from client_tpu_torch.server import GrpcInferenceServer, HttpInferenceServer

    def mesh(*axes):
        return tmesh.make_mesh(8, axes=axes, devices=CPU8)

    builders = {
        "bert_base_mc": lambda device: tserving.ShardedBertBackend(
            mesh("dp", "tp"), max_batch_size=4, device=device, **SMALL_BERT),
        "bert_long_mc": lambda device: tserving.LongContextBertBackend(
            mesh("dp", "sp"), seq_len=256, device=device, **SMALL_BERT),
        "tiny_gpt_mc": lambda device: tserving.ShardedTinyGptBackend(
            mesh("tp"), device=device, **SMALL_GPT),
        "moe_gpt_mc": lambda device: tserving.MoeGptBackend(
            mesh("ep", "tp"), device=device, **SMALL_GPT),
        "moe_lm_mc": lambda device: _port("moe_lm_mc", device),
        "pipelined_lm_mc": lambda device: _port("pipelined_lm_mc", device),
    }
    repo = ModelRepository()
    for name, build in builders.items():
        repo.register(name, build)
    engine = TorchEngine(repo, device="cpu")
    http = HttpInferenceServer(engine, port=0).start()
    grpc = GrpcInferenceServer(engine, port=0).start()
    yield engine, http, grpc
    grpc.stop()
    http.stop()
    engine.shutdown()


def _requests():
    rng = np.random.default_rng(11)

    def bert(seq):
        return {"input_ids": rng.integers(0, 512, (2, seq)).astype(np.int32),
                "attention_mask": np.ones((2, seq), np.int32)}

    return {"bert_base_mc": bert(128), "bert_long_mc": bert(256),
            "moe_lm_mc": {"INPUT_IDS": _ids(2, seed=12)},
            "pipelined_lm_mc": {"INPUT_IDS": _ids(2, seed=13)}}


def _infer_both(client_mod, url, model, inputs):
    with client_mod.InferenceServerClient(url) as client:
        ins = []
        for name, arr in inputs.items():
            inp = client_mod.InferInput(name, list(arr.shape), "INT32")
            inp.set_data_from_numpy(arr)
            ins.append(inp)
        result = client.infer(model, ins)
        names = ("LOGITS",) if "INPUT_IDS" in inputs else (
            "logits", "pooled_output")
        return {n: result.as_numpy(n) for n in names}


@pytest.mark.parametrize("model", ["bert_base_mc", "bert_long_mc",
                                   "moe_lm_mc", "pipelined_lm_mc"])
def test_forward_families_over_http_and_grpc(served, model):
    import client_tpu_torch.grpc as grpcclient
    import client_tpu_torch.http as httpclient

    engine, http, grpc = served
    inputs = _requests()[model]
    want = engine.infer(InferRequest(model_name=model, inputs=dict(inputs)),
                        timeout_s=300).outputs
    for mod, url in ((httpclient, http.url), (grpcclient, grpc.url)):
        got = _infer_both(mod, url, model, inputs)
        for name, arr in got.items():
            np.testing.assert_array_equal(arr, want[name])


@pytest.mark.parametrize("model", ["tiny_gpt_mc", "moe_gpt_mc"])
def test_generative_families_stream_over_http_and_grpc(served, model):
    import json
    import urllib.request

    import client_tpu_torch.grpc as grpcclient

    engine, http, grpc = served
    prompt = [3, 1, 4, 1]
    join = _stream(engine, model, prompt, 6)
    want = join()
    body = json.dumps({"inputs": [{"name": "INPUT_IDS", "datatype": "INT32",
                                   "shape": [4], "data": prompt}],
                       "parameters": {"max_tokens": 6}}).encode()
    req = urllib.request.Request(
        f"http://{http.url}/v2/models/{model}/generate_stream", data=body)
    tokens = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data:"):
                event = json.loads(line[5:])
                outs = {o["name"]: o["data"] for o in event["outputs"]}
                tokens += [int(t) for t in outs["TOKEN"]]
    assert tokens == want

    got, done = [], threading.Event()

    def cb(result, error):
        assert error is None, error
        r = result.get_response()
        if r.outputs:
            got.extend(int(t) for t in result.as_numpy("TOKEN"))
        p = r.parameters
        if "triton_final_response" in p and \
                p["triton_final_response"].bool_param:
            done.set()

    c = grpcclient.InferenceServerClient(grpc.url)
    c.start_stream(cb)
    inp = grpcclient.InferInput("INPUT_IDS", [4], "INT32")
    inp.set_data_from_numpy(np.asarray(prompt, np.int32))
    c.async_stream_infer(model, [inp], request_id="s1",
                         parameters={"max_tokens": 6})
    assert done.wait(120)
    c.stop_stream()
    c.close()
    assert got == want


def _stream(engine, model, prompt, n):
    toks, errs, done = [], [], threading.Event()

    def cb(resp):
        if resp.error is not None:
            errs.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            toks.append(int(resp.outputs["TOKEN"][0]))

    engine.async_infer(InferRequest(
        model_name=model, inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
        parameters={"max_tokens": n}), cb)

    def join():
        assert done.wait(120)
        assert not errs, errs
        return toks

    return join
