"""``bert_base_mc`` and ``bert_long_mc`` against the JAX package's, on the
CPU.

Each family runs through the port's ``TorchEngine`` on a mesh of
``["cpu"] * 8`` and through the JAX ``TpuEngine`` on the 8 virtual CPU
devices of ``tests/conftest.py`` (the same mesh shape), on the same
parameters (the JAX init carried across). Tolerances: logits within
2e-2 absolute, as ``tests/test_torch_bert.py`` holds BERT; the 64-wide
tanh pooled output within 4e-2 absolute. In bf16 (matmuls rounded to
bf16, the tp partials bf16 and added in another order) the JAX package's
own sharded and single-device runs of these models differ on the pooled
output by up to 0.025 (and on the logits by up to 0.013) over six seeded
batches, and the port against JAX by as much. The port's sharded forward
also equals its own unsharded ``BertBackend`` on the same weights at these
tolerances; configs equal JAX's ``config_dict()`` exactly.
"""

import jax
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models.bert import BertBackend as JaxBert
from client_tpu.parallel import mesh as jmesh
from client_tpu.parallel import serving as jserving
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.model import Model
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models import build_repository
from client_tpu_torch.models.bert import BertBackend, head_major_perm
from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import serving as tserving

TINY = dict(seq_len=16, hidden=64, n_layers=2, n_heads=4, ffn=128, vocab=512)
LONG = dict(hidden=64, n_layers=2, n_heads=4, ffn=128, vocab=512)
LONG_SEQ = 64
CPU8 = ["cpu"] * 8
ATOL = {"logits": 2e-2, "pooled_output": 4e-2}


def _inputs(batch, seq=16, seed=0, pad_from=None):
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, seq), dtype=np.int32)
    if pad_from is not None:
        mask[:, pad_from:] = 0
    return {"input_ids": rng.integers(0, 512, size=(batch, seq)).astype(
        np.int32), "attention_mask": mask}


def _canonical(seq_len=16):
    """The JAX BERT's seeded params (qkv-major), as numpy."""
    kw = dict(TINY, seq_len=seq_len)
    return jax.tree.map(np.asarray, JaxBert(name="x", **kw)._init_params())


@pytest.fixture(scope="module")
def engines():
    """bert_tiny_mc on dp2 x tp4 and bert_long_tiny_mc on dp2 x sp4, in
    both packages, on the JAX init's params."""
    jrepo = JaxRepository()
    jrepo.register_backend(jserving.ShardedBertBackend(
        jmesh.make_mesh(8, axes=("dp", "tp")), name="bert_tiny_mc",
        max_batch_size=8, **TINY))
    jrepo.register_backend(jserving.LongContextBertBackend(
        jmesh.make_mesh(8, axes=("dp", "sp")), name="bert_long_tiny_mc",
        seq_len=LONG_SEQ, **LONG))
    jeng = TpuEngine(jrepo)

    base, long = _canonical(), _canonical(LONG_SEQ)

    def sharded(device):
        b = tserving.ShardedBertBackend(
            tmesh.make_mesh(8, axes=("dp", "tp"), devices=CPU8),
            name="bert_tiny_mc", max_batch_size=8, device=device, **TINY)
        b.load_jax_params(base)
        return b

    def ring(device):
        b = tserving.LongContextBertBackend(
            tmesh.make_mesh(8, axes=("dp", "sp"), devices=CPU8),
            name="bert_long_tiny_mc", seq_len=LONG_SEQ, device=device, **LONG)
        b.load_jax_params(long)
        return b

    repo = ModelRepository()
    repo.register("bert_tiny_mc", sharded)
    repo.register("bert_long_tiny_mc", ring)
    teng = TorchEngine(repo, device="cpu")
    yield jeng, teng
    teng.shutdown()
    jeng.shutdown()


def _both(engines, model, inputs):
    jeng, teng = engines
    want = jeng.infer(JaxRequest(model_name=model, inputs=dict(inputs)),
                      timeout_s=300).outputs
    got = teng.infer(InferRequest(model_name=model, inputs=dict(inputs)),
                     timeout_s=300).outputs
    return got, want


@pytest.mark.parametrize("batch", [1, 3, 4, 8])
def test_bert_base_mc_equals_jax_through_the_engine(engines, batch):
    got, want = _both(engines, "bert_tiny_mc",
                      _inputs(batch, seed=batch, pad_from=12))
    assert got["logits"].shape == (batch, 2)
    assert got["pooled_output"].shape == (batch, 64)
    for name in ("logits", "pooled_output"):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL[name], rtol=0)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_bert_long_mc_equals_jax_through_the_engine(engines, batch):
    got, want = _both(engines, "bert_long_tiny_mc",
                      _inputs(batch, seq=LONG_SEQ, seed=10 + batch,
                              pad_from=40))
    assert got["logits"].shape == (batch, 2)
    for name in ("logits", "pooled_output"):
        np.testing.assert_allclose(got[name], want[name], atol=ATOL[name], rtol=0)


def test_odd_batch_pads_to_a_dp_bucket(engines):
    _jeng, teng = engines
    sched = teng._schedulers["bert_tiny_mc"]
    assert sched.model.pick_bucket(3) == 4
    resp = teng.infer(InferRequest(model_name="bert_tiny_mc",
                                   inputs=_inputs(3)), timeout_s=300)
    assert resp.outputs["logits"].shape == (3, 2)


@pytest.mark.parametrize("family,axes,kw", [
    ("ShardedBertBackend", ("dp", "tp"), dict(max_batch_size=16, **TINY)),
    ("ShardedBertBackend", ("dp", "tp"), dict(max_batch_size=7, **TINY)),
    ("LongContextBertBackend", ("dp", "sp"), dict(seq_len=LONG_SEQ, **LONG)),
])
def test_config_equals_jax_on_the_same_mesh(family, axes, kw):
    want = getattr(jserving, family)(jmesh.make_mesh(8, axes=axes),
                                     name="m", **kw).config
    got = getattr(tserving, family)(
        tmesh.make_mesh(8, axes=axes, devices=CPU8), name="m", device="cpu",
        **kw).config
    g, w = got.config_dict(), want.config_dict()
    g.pop("platform"), g.pop("backend"), w.pop("platform"), w.pop("backend")
    assert g == w
    assert got.effective_buckets() == want.effective_buckets()
    assert all(b % 2 == 0 for b in got.effective_buckets())


def test_sharded_equals_the_ports_unsharded_bert():
    """The dp2 x tp4 forward against the plain BertBackend on the same
    weights (``params_to_jax`` undoes the head-major layout)."""
    mc = tserving.ShardedBertBackend(
        tmesh.make_mesh(8, axes=("dp", "tp"), devices=CPU8), name="m",
        max_batch_size=8, device="cpu", **TINY)
    plain = BertBackend(name="p", max_batch_size=8, device="cpu", **TINY)
    plain.load_jax_params(mc.params_to_jax())
    inputs = {k: torch.from_numpy(v) for k, v in
              _inputs(4, seed=5, pad_from=9).items()}
    with torch.inference_mode():
        got, want = mc(inputs), plain(inputs)
    for name in ("logits", "pooled_output"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=ATOL[name], rtol=0)


def test_head_major_layout_round_trips():
    """The module keeps wqkv head-major (a tp shard holds whole heads);
    params_to_jax gives back the canonical qkv-major tree bit for bit, and
    the layout is JAX's permutation."""
    canon = _canonical()
    mc = tserving.ShardedBertBackend(
        tmesh.make_mesh(8, axes=("dp", "tp"), devices=CPU8), name="m",
        max_batch_size=8, device="cpu", **TINY)
    mc.load_jax_params(canon)
    back = mc.params_to_jax()
    for a, b in zip(jax.tree.leaves(canon), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    perm = head_major_perm(64, 4).numpy()
    h, hd = 64, 16
    want = np.empty(3 * h, np.int64)
    for i in range(3 * h):  # the JAX package's loop
        head, rem = divmod(i, 3 * hd)
        which, d = divmod(rem, hd)
        want[i] = which * h + head * hd + d
    assert np.array_equal(perm, want)
    w = mc.layers[0].wqkv.weight.float().numpy()
    assert np.array_equal(w, np.asarray(canon["layers"][0]["wqkv"]["w"],
                                        np.float32).T[perm])
    placed = mc.placed()[id(mc.layers[0])]
    assert placed["wqkv"]["w"].part(tp=3).shape == (64, 48)  # one head's qkv


def test_shards_are_views_of_the_weights():
    mc = tserving.ShardedBertBackend(
        tmesh.make_mesh(8, axes=("dp", "tp"), devices=CPU8), name="m",
        max_batch_size=8, device="cpu", **TINY)
    lp = mc.layers[1]
    sh = mc.placed()[id(lp)]
    assert sh["wo"]["w"].part(tp=2).data_ptr() == \
        lp.wo.weight.data_ptr() + 2 * 16 * lp.wo.weight.element_size()
    assert sh["w1"]["w"].part(tp=0).untyped_storage().data_ptr() == \
        lp.w1.weight.untyped_storage().data_ptr()


def test_bert_long_mc_is_the_ports_bert_with_ring_attention():
    mc = tserving.LongContextBertBackend(
        tmesh.make_mesh(8, axes=("dp", "sp"), devices=CPU8), name="m",
        seq_len=LONG_SEQ, device="cpu", **LONG)
    plain = BertBackend(name="p", seq_len=LONG_SEQ, device="cpu", **LONG)
    plain.load_state_dict(mc.state_dict())
    inputs = {k: torch.from_numpy(v) for k, v in
              _inputs(2, seq=LONG_SEQ, seed=3, pad_from=50).items()}
    with torch.inference_mode():
        got, want = mc(inputs), plain(inputs)
    for name in ("logits", "pooled_output"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=ATOL[name], rtol=0)


def test_mesh_checks():
    with pytest.raises(ValueError, match="multiple of the sp"):
        tserving.LongContextBertBackend(
            tmesh.make_mesh(8, axes=("dp", "sp"), devices=CPU8), seq_len=66,
            device="cpu", **LONG)
    with pytest.raises(ValueError, match="divide by tp"):
        tserving.ShardedBertBackend(
            tmesh.make_mesh(8, axes=("tp",), devices=CPU8), device="cpu",
            **TINY)
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tserving.ShardedBertBackend(
            tmesh.make_mesh(2, axes=("dp",), devices=["cpu", "meta"]),
            device="cpu", **TINY)


@pytest.mark.parametrize("name", ["bert_base_mc", "bert_long_mc"])
def test_registered_builder_is_the_jax_zoos(name):
    """The registered builder on the CPU: a degree-1 mesh, the JAX zoo's
    widths (BERT-base; seq 128 or 2048) and a config equal to JAX's."""
    from client_tpu.models import _REGISTRY as jax_registry

    got = build_repository([name])._builders[name][None](torch.device("cpu"))
    want = jax_registry[name]()
    assert got.mesh.size == 1
    assert len(got.layers) == 12 and got.tok_embed.shape == (30522, 768)
    g, w = got.config.config_dict(), want.config.config_dict()
    for d in (g, w):
        d.pop("platform"), d.pop("backend")
    assert g == w


def test_engine_loads_the_registered_builder_through_model():
    """A Model on the registered bert_long_mc serves one request (seq
    2048 on a degree-1 mesh: the ring is one block)."""
    backend = build_repository(["bert_long_mc"])._builders["bert_long_mc"][
        None](torch.device("cpu"))
    model = Model(backend, device="cpu")
    out, _phases = model.execute_timed(
        _inputs(1, seq=2048, seed=1, pad_from=1500), batch_size=1)
    assert out["logits"].shape == (1, 2) and np.isfinite(out["logits"]).all()
