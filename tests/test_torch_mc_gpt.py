"""``tiny_gpt_mc`` and ``moe_gpt_mc`` against the JAX package's, on the CPU.

Each generative family is served by the port's ``TorchEngine`` on a mesh
of ``["cpu"] * 8`` and by the JAX ``TpuEngine`` on the 8 virtual CPU
devices of ``tests/conftest.py`` (the same mesh shape: tp8, and ep2 x tp4),
with the same seeded weights (the port draws them in the JAX order, bit
for bit). Streams compare token for token, greedy and seeded-sampled: on
the CPU K2's wrapper runs its plain version, once per tp shard and layer
of every wave, on the head-sharded arena. The port's sharded streams also
equal its unsharded ``TinyGptBackend``'s.
"""

import threading

import jax
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
from client_tpu_torch.models.generate import TinyGptBackend
from client_tpu_torch.observability.memory import storage_bytes, tensor_leaves
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import serving as tserving

# tiny_gpt_mc's head dim (32) at 2 layers, a short arena and 8 streams.
GPT = dict(n_layers=2, d_model=256, n_heads=8, d_ff=256, vocab=256,
           max_seq_len=32, max_streams=8)
CPU8 = ["cpu"] * 8

# Greedy over three prompt lengths, then two seeded sampled streams.
SUITE = [([3, 1, 4], 6, {}), ([1, 5, 9, 2], 6, {}), ([6, 5], 6, {}),
         ([7] * 9, 5, {}), ([4, 4], 8, dict(temperature=1.0, seed=42)),
         ([4, 4], 8, dict(temperature=0.8, seed=7, top_k=24, top_p=0.9))]
MOE_SUITE = [([5, 6, 7], 8, {}), ([8, 1, 6], 11, {}), ([9, 9, 2], 12, {}),
             ([1, 2, 3], 8, dict(temperature=1.0, seed=3))]


def _collect(eng, model, prompt, n, request_cls=InferRequest, **params):
    """Start one stream; returns join() -> its tokens."""
    toks, errs, done = [], [], threading.Event()

    def cb(resp):
        if resp.error is not None:
            errs.append(resp.error)
            done.set()
        elif resp.final:
            done.set()
        else:
            toks.append(int(resp.outputs["TOKEN"][0]))

    eng.async_infer(request_cls(
        model_name=model, inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
        parameters={"max_tokens": n, **params}), cb)

    def join():
        assert done.wait(300), "stream stalled"
        if errs:
            raise errs[0]
        return toks

    return join


def _jax_streams(backend, suite):
    repo = JaxRepository()
    repo.register_backend(backend)
    eng = TpuEngine(repo)
    try:
        return [_collect(eng, backend.config.name, p, n, JaxRequest, **kw)()
                for p, n, kw in suite]
    finally:
        eng.shutdown()


def _port_engine(name, build):
    repo = ModelRepository()
    repo.register(name, build)
    return TorchEngine(repo, device="cpu")


def _tp8():
    return tmesh.make_mesh(8, axes=("tp",), devices=CPU8)


def _ep2tp4():
    return tmesh.make_mesh(8, axes=("ep", "tp"), devices=CPU8)


@pytest.fixture(scope="module")
def jax_gpt_streams():
    return _jax_streams(jserving.ShardedTinyGptBackend(
        jmesh.make_mesh(8, axes=("tp",)), name="gpt_mc", **GPT), SUITE)


@pytest.fixture(scope="module")
def jax_moe_streams():
    return _jax_streams(jserving.MoeGptBackend(), MOE_SUITE)


@pytest.fixture
def counted_waves(monkeypatch):
    """Every K2 call of the decode waves, as (layer, heads, head dim)."""
    calls = []
    wrapped = da.decode_wave_attention

    def count(k_arena, v_arena, q, *args, layer, **kw):
        calls.append((layer, q.shape[1], q.shape[2]))
        return wrapped(k_arena, v_arena, q, *args, layer=layer, **kw)

    monkeypatch.setattr(da, "decode_wave_attention", count)
    return calls


# -- tiny_gpt_mc ----------------------------------------------------------------


def test_tiny_gpt_mc_streams_equal_jax(jax_gpt_streams, counted_waves):
    eng = _port_engine("gpt_mc", lambda device: tserving.ShardedTinyGptBackend(
        _tp8(), name="gpt_mc", device=device, **GPT))
    try:
        solo = [_collect(eng, "gpt_mc", p, n, **kw)() for p, n, kw in SUITE]
        joins = [_collect(eng, "gpt_mc", p, n, **kw) for p, n, kw in SUITE]
        together = [j() for j in joins]
    finally:
        eng.shutdown()
    assert solo == jax_gpt_streams
    assert together == jax_gpt_streams
    # K2 per tp shard and layer of every wave: 8 one-head calls at head
    # dim 32 per layer, both layers each wave.
    assert counted_waves and len(counted_waves) % 16 == 0
    assert {(h, d) for _, h, d in counted_waves} == {(1, 32)}
    per_layer = [sum(1 for li, _, _ in counted_waves if li == layer)
                 for layer in (0, 1)]
    assert per_layer[0] == per_layer[1]


def test_tiny_gpt_mc_equals_the_ports_unsharded_gpt():
    """Sharded tp8 streams equal the port's plain TinyGptBackend on the
    same seed, greedy and sampled."""
    plain = _port_engine("g", lambda device: TinyGptBackend(
        name="g", device=device, **GPT))
    try:
        want = [_collect(plain, "g", p, n, **kw)() for p, n, kw in SUITE]
    finally:
        plain.shutdown()
    mesh = tmesh.make_mesh(4, axes=("tp",), devices=["cpu"] * 4)
    eng = _port_engine("g", lambda device: tserving.ShardedTinyGptBackend(
        mesh, name="g", device=device, **GPT))
    try:
        got = [_collect(eng, "g", p, n, **kw)() for p, n, kw in SUITE]
    finally:
        eng.shutdown()
    assert got == want


def test_tiny_gpt_mc_params_equal_jax_and_the_plain_gpt():
    mc = tserving.ShardedTinyGptBackend(_tp8(), name="g", device="cpu", **GPT)
    plain = TinyGptBackend(name="g", device="cpu", **GPT)
    want = jserving.ShardedTinyGptBackend(
        jmesh.make_mesh(8, axes=("tp",)), name="g", **GPT)._init_params()
    for a, b, c in zip(jax.tree.leaves(mc.params_to_jax()),
                       jax.tree.leaves(plain.params_to_jax()),
                       jax.tree.leaves(want)):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))


def test_head_sharded_arena():
    """k / v per tp shard, ``[L, R, S, H / tp, D]``, contiguous, holding
    the unsharded arena's heads in order; ``tok`` once; every tensor in
    the census's leaves."""
    mc = tserving.ShardedTinyGptBackend(
        tmesh.make_mesh(4, axes=("tp",), devices=["cpu"] * 4), name="g",
        device="cpu", **GPT)
    arena = mc.init_arena(8)
    assert len(arena.k) == len(arena.v) == 4
    assert all(t.shape == (2, 9, 32, 2, 32) and t.is_contiguous()
               for t in arena.k + arena.v)
    assert arena.tok.shape == (9,)
    leaves = tensor_leaves(arena)
    assert len(leaves) == 9
    assert storage_bytes(leaves) == 2 * 4 * (2 * 9 * 32 * 2 * 32 * 4) + 9 * 4
    free, dummy = mc.arena_rows(8)
    assert free == list(range(8)) and dummy == 8


def test_the_engine_counts_the_head_sharded_arena():
    from client_tpu_torch.observability.memory import hbm_census

    eng = _port_engine("g_census", lambda device: tserving.ShardedTinyGptBackend(
        _tp8(), name="g_census", device=device, **GPT))
    try:
        sched = eng._schedulers["g_census"]
        assert sched.arena_shards() == 1
        want = 2 * 8 * (2 * 9 * 32 * 1 * 32 * 4) + 9 * 4
        assert sched.arena_nbytes() == want
        rows = [r for r in hbm_census().report()["owners"]
                if (r["model"], r["component"]) == ("g_census", "kv_arena")]
        assert len(rows) == 1 and rows[0]["bytes"] == want
        assert rows[0]["buffers"] == 17
    finally:
        eng.shutdown()


def test_tiny_gpt_mc_checks():
    with pytest.raises(ValueError, match=r"n_heads \(6\) must divide by tp"):
        tserving.ShardedTinyGptBackend(_tp8(), device="cpu",
                                       **dict(GPT, n_heads=6, d_model=192))
    with pytest.raises(ValueError, match="kv_shards"):
        tserving.ShardedTinyGptBackend(_tp8(), device="cpu", kv_shards=2,
                                       **GPT)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tserving.ShardedTinyGptBackend(
            tmesh.make_mesh(2, axes=("tp",), devices=["cpu", "meta"]),
            device="cpu", **GPT)


# -- moe_gpt_mc -------------------------------------------------------------------


def _moe_engine(name="moe_gpt_mc", **kw):
    return _port_engine(name, lambda device: tserving.MoeGptBackend(
        _ep2tp4(), name=name, device=device, **kw))


def test_moe_gpt_mc_streams_equal_jax(jax_moe_streams, counted_waves):
    eng = _moe_engine()
    try:
        got = [_collect(eng, "moe_gpt_mc", p, n, **kw)()
               for p, n, kw in MOE_SUITE]
    finally:
        eng.shutdown()
    assert got == jax_moe_streams
    assert {(h, d) for _, h, d in counted_waves} == {(1, 32)}


def test_moe_gpt_mc_params_equal_jax_bit_for_bit():
    got = tserving.MoeGptBackend(_ep2tp4(), device="cpu").params_to_jax()
    want = jserving.MoeGptBackend()._init_params()
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_moe_gpt_mc_batch_invariance():
    """Dropless routing: tokens generated while sharing decode waves (and
    expert queues) with other streams equal solo generation."""
    eng = _moe_engine()
    try:
        prompts = [[3 + i, 40 + i, 100 + i] for i in range(6)]
        solo = [_collect(eng, "moe_gpt_mc", p, 10)() for p in prompts]
        joins = [_collect(eng, "moe_gpt_mc", p, 10) for p in prompts]
        assert [j() for j in joins] == solo
    finally:
        eng.shutdown()


def test_moe_gpt_mc_chunked_decode_identical(monkeypatch):
    monkeypatch.delenv("CLIENT_TPU_GEN_CHUNK", raising=False)
    eng = _moe_engine()
    try:
        want = _collect(eng, "moe_gpt_mc", [8, 1, 6], 11)()
    finally:
        eng.shutdown()
    monkeypatch.setenv("CLIENT_TPU_GEN_CHUNK", "4")
    eng = _moe_engine()
    try:
        assert eng._schedulers["moe_gpt_mc"]._chunk == 4
        got = _collect(eng, "moe_gpt_mc", [8, 1, 6], 11)()
    finally:
        eng.shutdown()
    assert got == want


def test_moe_gpt_mc_decode_matches_the_cacheless_forward():
    """The arena'd expert-routed decode chain reproduces the same model's
    cacheless full-context greedy chain, token for token."""
    eng = _moe_engine()
    try:
        got = _collect(eng, "moe_gpt_mc", [5, 6, 7], 8)()
        backend = eng._schedulers["moe_gpt_mc"].model.backend
        ids = [5, 6, 7]
        for _ in range(8):
            logits = backend.forward_full(torch.tensor(ids, dtype=torch.int32))
            ids.append(int(torch.argmax(logits[-1])))
    finally:
        eng.shutdown()
    assert got == ids[3:]


def test_moe_gpt_mc_sharded_equals_unsharded():
    """ep2 x tp4 streams equal a degree-1 mesh's on the same seed."""
    eng = _port_engine("m1", lambda device: tserving.MoeGptBackend(
        tmesh.make_mesh(axes=("ep", "tp"), devices=["cpu"]), name="m1",
        device=device))
    try:
        want = [_collect(eng, "m1", p, n, **kw)() for p, n, kw in MOE_SUITE]
    finally:
        eng.shutdown()
    eng = _moe_engine("m8")
    try:
        got = [_collect(eng, "m8", p, n, **kw)() for p, n, kw in MOE_SUITE]
    finally:
        eng.shutdown()
    assert got == want


def test_moe_gpt_mc_weights_path_round_trip(tmp_path):
    """A perturbed checkpoint, written by the JAX package, restores onto the
    ep x tp mesh and changes what the arena decodes; the same tree fed
    directly decodes the same tokens."""
    from client_tpu.engine.checkpoint import save_params

    params = jserving.MoeGptBackend()._init_params()
    params["layers"][0]["w2e"] = np.asarray(params["layers"][0]["w2e"]) * -0.5
    path = save_params(str(tmp_path / "moe_gpt_w"), params)

    def run(build):
        eng = _port_engine("mg", build)
        try:
            return _collect(eng, "mg", [1, 2, 3], 8)()
        finally:
            eng.shutdown()

    rand = run(lambda device: tserving.MoeGptBackend(
        _ep2tp4(), name="mg", device=device))

    def restored(device):
        with restoring(path):
            return tserving.MoeGptBackend(_ep2tp4(), name="mg", device=device)

    def direct(device):
        b = tserving.MoeGptBackend(_ep2tp4(), name="mg", device=device)
        b.load_jax_params(params)
        return b

    ckpt = run(restored)
    assert ckpt != rand
    assert ckpt == run(direct)


def test_moe_gpt_mc_checks():
    with pytest.raises(ValueError, match="n_experts"):
        tserving.MoeGptBackend(_ep2tp4(), n_experts=3, device="cpu")
    with pytest.raises(ValueError, match=r"d_ff \(250\)"):
        tserving.MoeGptBackend(_ep2tp4(), d_ff=250, device="cpu")
    with pytest.raises(ValueError, match="n_heads"):
        tserving.MoeGptBackend(
            tmesh.make_mesh(8, axes=("tp",), devices=CPU8), device="cpu")


@pytest.mark.parametrize("name", ["tiny_gpt_mc", "moe_gpt_mc"])
def test_registered_builder_is_the_jax_zoos(name):
    from client_tpu.models import _REGISTRY as jax_registry

    got = build_repository([name])._builders[name][None](torch.device("cpu"))
    want = jax_registry[name]()
    assert got.mesh.size == 1 and got.attn_impl == "fused"
    for attr in ("n_layers", "d_model", "n_heads", "d_ff", "vocab",
                 "max_seq_len", "max_streams"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.head_dim == 32
    g, w = got.config.config_dict(), want.config.config_dict()
    for d in (g, w):
        d.pop("platform"), d.pop("backend")
    assert g == w
