"""The port's mesh, ring attention, MoE, pipeline and training forward
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``client_tpu.parallel`` (on the 8 virtual CPU devices of
``tests/conftest.py``, under GSPMD or ``shard_map``) and
``client_tpu_torch.parallel`` (a mesh of ``["cpu"] * 8``). Tolerances, all
fp32: ring attention and the MoE FFN (y and aux) within 1e-5, the
pipeline, the MoE and the training forwards within 1e-5: the same math in
another summation order. The mesh helpers, the placement of each shard and
the capacity drops compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from client_tpu.parallel import mesh as jmesh
from client_tpu.parallel import moe as jmoe
from client_tpu.parallel import pipeline as jpipe
from client_tpu.parallel import ring_attention as jring
from client_tpu.parallel import training as jtrain
from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import moe as tmoe
from client_tpu_torch.parallel import pipeline as tpipe
from client_tpu_torch.parallel import ring_attention as tring
from client_tpu_torch.parallel import training as ttrain

CPU8 = ["cpu"] * 8
AXES = [("dp", "sp", "tp"), ("dp", "tp"), ("dp", "ep", "tp"), ("dp", "sp"),
        ("tp",), ("ep", "tp"), ("dp", "pp"), ("pp",), ("sp",)]


def _meshes(axes):
    return (jmesh.make_mesh(8, axes=axes),
            tmesh.make_mesh(8, axes=axes, devices=CPU8))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- the mesh -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("axes", AXES, ids=["-".join(a) for a in AXES])
def test_mesh_axes_equal_jax(n, axes):
    assert tmesh.mesh_axes(n, axes) == jmesh.mesh_axes(n, axes)
    assert tmesh._factor(n, len(axes)) == jmesh._factor(n, len(axes))


def test_mesh_axes_of_eight():
    assert tmesh.mesh_axes(8, ("dp", "tp")) == {"dp": 2, "tp": 4}
    assert tmesh.mesh_axes(8, ("dp", "ep", "tp")) == {"dp": 2, "ep": 2,
                                                      "tp": 2}


@pytest.mark.parametrize("axes", AXES, ids=["-".join(a) for a in AXES])
def test_make_mesh_shape_equals_jax(axes):
    jm, tm = _meshes(axes)
    assert tm.shape == dict(jm.shape)
    assert list(tm.shape) == list(jm.shape)
    assert tm.size == 8 and tm.device == torch.device("cpu")


def test_make_mesh_takes_sizes_and_counts():
    tm = tmesh.make_mesh(8, axes=("dp", "tp"), axis_sizes={"dp": 4, "tp": 2},
                         devices=CPU8)
    assert tm.shape == {"dp": 4, "tp": 2}
    assert tmesh.make_mesh(4, axes=("tp",), devices=CPU8).shape == {"tp": 4}
    assert tmesh.make_mesh(axes=("dp", "tp"), devices=["cpu"]).shape == {
        "dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="requested 9 devices"):
        tmesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="multiply"):
        tmesh.make_mesh(8, axes=("dp", "tp"), axis_sizes={"dp": 2, "tp": 2},
                        devices=CPU8)


def test_a_mesh_over_distinct_devices_raises():
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tmesh.make_mesh(2, axes=("tp",), devices=["cpu", "meta"])


def test_the_default_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default mesh is its cards")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(axes=("tp",))


@pytest.mark.parametrize("spec", [None, "tp", "pp", ("dp", "tp"), ("pp",),
                                  ("pp", "ep")])
def test_drop_absent_equals_jax(spec):
    jm, tm = _meshes(("dp", "tp"))
    assert tmesh.drop_absent(tm, spec) == jmesh.drop_absent(jm, spec)


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp"), ("dp", "tp"),
                                  ("tp", "dp"), (None, None), ("ep", "tp"),
                                  ("pp", None)])
def test_place_with_specs_gives_jax_shards(spec):
    """Each shard of a placed leaf is the block the JAX device at the same
    mesh coordinates holds under the same ``NamedSharding``."""
    jm, tm = _meshes(("dp", "tp"))
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    jspec = JP(*(jmesh.drop_absent(jm, a) for a in spec))
    placed = jax.device_put(x, NamedSharding(jm, jspec))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    leaf = tmesh.place_with_specs(tm, {"w": _t(x)}, {"w": tmesh.P(*spec)})["w"]
    for (i, j), dev in np.ndenumerate(jm.devices):
        got = leaf.part(dp=i, tp=j).numpy()
        np.testing.assert_array_equal(got, by_device[dev])


def test_collectives():
    tm = tmesh.make_mesh(4, axes=("tp",), devices=["cpu"] * 4)
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert tmesh.psum(tm, parts, "tp").tolist() == [6.0, 6.0]
    assert tmesh.all_gather(tm, parts, "tp").tolist() == [
        0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
    assert [p[0].item() for p in tmesh.ppermute(tm, parts, "tp")] == [
        3.0, 0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="3 shards"):
        tmesh.psum(tm, parts[:3], "tp")
    assert [p.tolist() for p in tmesh.split(tm, torch.arange(8.0), 0, "tp")] \
        == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.split(tm, torch.arange(6.0), 0, "tp")


def test_ppermute_equals_jax():
    jm, tm = _meshes(("sp",))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)

    def rot(v):
        return jax.lax.ppermute(v, "sp", [(j, (j + 1) % 8) for j in range(8)])

    try:
        from jax import shard_map
    except ImportError:  # older jax spells it experimental
        from jax.experimental.shard_map import shard_map
    want = np.asarray(shard_map(rot, mesh=jm, in_specs=JP("sp"),
                                out_specs=JP("sp"))(x))
    got = torch.cat(tmesh.ppermute(tm, tmesh.split(tm, _t(x), 0, "sp"), "sp"))
    np.testing.assert_array_equal(got.numpy(), want)


# -- ring attention ---------------------------------------------------------------


def _qkv(b, s, h, d, seed, masked=0.2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    bias = np.where(rng.random((b, s)) < masked, -1e9, 0.0).astype(np.float32)
    return q, k, v, bias


RING = [(("dp", "sp"), 4, 32), (("sp",), 2, 64), (("dp", "sp", "tp"), 2, 16)]


@pytest.mark.parametrize("axes,b,s", RING,
                         ids=["dp2-sp4", "sp8", "dp2-sp2-tp2"])
@pytest.mark.parametrize("mask", ["none", "random", "all_of_a_row"])
def test_sequence_parallel_attention_equals_jax(axes, b, s, mask):
    jm, tm = _meshes(axes)
    q, k, v, bias = _qkv(b, s, 2, 8, seed=s, masked=0.0 if mask == "none"
                         else 0.3)
    if mask == "all_of_a_row":
        bias[0] = -1e30  # every key masked: the -1e30 guards
    want = np.asarray(jax.jit(
        lambda *a: jring.sequence_parallel_attention(jm, *a))(
        *(jnp.asarray(a) for a in (q, k, v, bias))))
    got = tring.sequence_parallel_attention(tm, *(_t(a) for a in
                                                  (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_ring_attention_equals_dense_attention():
    """Over shards, the ring's output is the plain softmax attention."""
    tm = tmesh.make_mesh(4, axes=("sp",), devices=["cpu"] * 4)
    q, k, v, bias = (_t(a) for a in _qkv(2, 32, 2, 8, seed=3))
    got = tring.sequence_parallel_attention(tm, q, k, v, bias)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    p = torch.softmax(s + bias[:, None, None, :], dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_ring_attention_folds_blocks_in_the_jax_order():
    """At step i shard j holds block (j - i) mod n: each shard's state
    after the ring equals the blocks folded in that order by hand."""
    tm = tmesh.make_mesh(4, axes=("sp",), devices=["cpu"] * 4)
    q, k, v, bias = (_t(a) for a in _qkv(1, 16, 1, 4, seed=5))
    qs, ks, vs, bs = (tmesh.split(tm, t, 1, "sp") for t in (q, k, v, bias))
    bs = tmesh.split(tm, bias, 1, "sp")
    got = tring.ring_attention(tm, qs, ks, vs, bs, "sp")
    for j in range(4):
        m = torch.full((1, 4, 1, 1), -1e30)
        l, acc = torch.zeros(1, 4, 1, 1), torch.zeros(1, 4, 1, 4)
        for i in range(4):
            blk = (j - i) % 4
            m, l, acc = tring._block_attend(qs[j], ks[blk], vs[blk], bs[blk],
                                            m, l, acc, 0.5)
        assert torch.equal(got[j], acc / l)


# -- MoE --------------------------------------------------------------------------


def _moe_inputs(T=64, D=16, E=4, F=32, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    w1 = (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    return x, router, w1, w2


@pytest.mark.parametrize("capacity", [24, 64, 8])
@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "ep-tp"])
def test_moe_ffn_equals_jax(capacity, sharded):
    x, router, w1, w2 = _moe_inputs()
    want_y, want_aux = jmoe.moe_ffn(*(jnp.asarray(a) for a in
                                      (x, router, w1, w2)), capacity)
    tw1, tw2 = _t(w1), _t(w2)
    if sharded:
        tm = tmesh.make_mesh(8, axes=("dp", "ep", "tp"), devices=CPU8)
        tw1 = tmesh.place(tm, tw1, ("ep", None, "tp"))
        tw2 = tmesh.place(tm, tw2, ("ep", "tp", None))
        assert tw1.part(ep=1, tp=1).shape == (2, 16, 16)
    y, aux = tmoe.moe_ffn(_t(x), _t(router), tw1, tw2, capacity)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-5


def test_capacity_overflow_drops_tokens():
    """Tokens past an expert's capacity produce zero output (they ride the
    residual path), matching Switch semantics and the JAX version."""
    D, E, T = 8, 2, 16
    x = torch.ones(1, T, D)
    router = torch.zeros(D, E)
    router[:, 0] = 1.0  # every token to expert 0
    w1 = torch.ones(E, D, 2 * D) * 0.1
    w2 = torch.ones(E, 2 * D, D) * 0.1
    y, _ = tmoe.moe_ffn(x, router, w1, w2, capacity=4)
    y = y.reshape(T, D).numpy()
    assert np.all(np.abs(y[:4]) > 0)
    assert np.all(y[4:] == 0.0)
    want, _ = jmoe.moe_ffn(jnp.ones((1, T, D)), jnp.asarray(router.numpy()),
                           jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()),
                           capacity=4)
    np.testing.assert_allclose(y, np.asarray(want).reshape(T, D), atol=1e-6)


def test_moe_groups_route_each_group_alone():
    """G groups through moe_groups equal G separate moe_ffn calls."""
    x, router, w1, w2 = (_t(a) for a in _moe_inputs())
    y, aux = tmoe.moe_groups(x, router, w1, w2, capacity=10)
    for g in range(2):
        yg, ag = tmoe.moe_ffn(x[g:g + 1], router, w1, w2, capacity=10)
        assert torch.equal(y[g], yg[0]) and torch.equal(aux[g], ag)


def test_default_n_experts_equals_jax():
    for axes in AXES:
        jm, tm = _meshes(axes)
        assert tmoe.default_n_experts(tm) == jmoe.default_n_experts(jm)


@pytest.fixture(scope="module")
def moe_params():
    return jax.tree.map(np.asarray, jmoe._init_moe_params(
        jax.random.PRNGKey(4), 64, 32, 64, 2, 4))


@pytest.mark.parametrize("axes", [("dp", "ep", "tp"), ("dp", "tp"),
                                  ("ep", "tp")])
def test_moe_forward_equals_jax(moe_params, axes):
    jm, tm = _meshes(axes)
    tokens = np.random.default_rng(7).integers(0, 64, (4, 8)).astype(np.int32)
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(
            jm, JP(*(jmesh.drop_absent(jm, e) for e in s)))),
        moe_params, jmoe._moe_specs(JP, 2))
    want, want_aux = jax.jit(lambda p, t: jmoe._moe_forward(
        p, t, 4, 10, jmesh.make_constrain(jm)))(placed, jnp.asarray(tokens))
    tree = jax.tree.map(_t, moe_params)
    got, aux = tmoe._moe_forward(
        tmesh.place_with_specs(tm, tree, tmoe._moe_specs(tmesh.P, 2)),
        torch.from_numpy(tokens), 4, 10, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-5


# -- pipeline -------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacked():
    params = jax.tree.map(np.asarray, jpipe._init_stacked_params(
        jax.random.PRNGKey(1), vocab=64, d_model=32, d_ff=64, n_layers=8))
    return {k: params[k] for k in tpipe.BLOCK_KEYS}


@pytest.mark.parametrize("axes,m", [(("dp", "pp"), 3), (("dp", "pp"), 1),
                                    (("dp", "pp"), 2)])
def test_pipeline_apply_equals_reference_and_jax(stacked, axes, m):
    jm, tm = _meshes(axes)
    n_stages = jm.shape["pp"]
    blocks = {k: v[:2 * n_stages] for k, v in stacked.items()}
    x = np.random.default_rng(2).standard_normal((m, 4, 8, 32)).astype(
        np.float32)
    mask = np.tril(np.ones((8, 8), bool))
    want = np.asarray(jpipe.pipeline_apply(
        jm, {k: jnp.asarray(v) for k, v in blocks.items()}, jnp.asarray(x), 4,
        jnp.asarray(mask)))
    tblocks = {k: _t(v) for k, v in blocks.items()}
    got = tpipe.pipeline_apply(tm, tblocks, _t(x), 4, torch.from_numpy(mask))
    ref = torch.stack([tpipe.reference_forward(tblocks, _t(x)[i], 4,
                                               torch.from_numpy(mask))
                       for i in range(m)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_reference_forward_equals_jax(stacked):
    x = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(
        np.float32)
    mask = np.tril(np.ones((8, 8), bool))
    want = np.asarray(jpipe.reference_forward(
        {k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(x), 4,
        jnp.asarray(mask)))
    got = tpipe.reference_forward({k: _t(v) for k, v in stacked.items()},
                                  _t(x), 4, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -- the training forward -----------------------------------------------------------


@pytest.mark.parametrize("axes", [("dp", "sp", "tp"), ("dp", "tp"), ("tp",)])
def test_training_forward_equals_jax(axes):
    jm, tm = _meshes(axes)
    params = jax.tree.map(np.asarray, jtrain._init_params(
        jax.random.PRNGKey(0), 64, 32, 64, 2))
    tokens = np.random.default_rng(1).integers(0, 64, (4, 8)).astype(np.int32)
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(
            jm, JP(*(jmesh.drop_absent(jm, e) for e in s)))),
        params, jtrain._param_specs(JP, 2))
    want = jax.jit(lambda p, t: jtrain._forward(
        p, t, 4, jmesh.make_constrain(jm)))(placed, jnp.asarray(tokens))
    got = ttrain._forward(
        tmesh.place_with_specs(tm, jax.tree.map(_t, params),
                               ttrain._param_specs(tmesh.P, 2)),
        torch.from_numpy(tokens), 4, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_init_draws_the_jax_scales():
    """The seeded torch init has the JAX init's shapes and scale (0.02)."""
    gen = torch.Generator().manual_seed(0)
    got = tmoe._init_moe_params(gen, 256, 64, 128, 2, 2)
    want = jax.eval_shape(lambda: jmoe._init_moe_params(
        jax.random.PRNGKey(0), 256, 64, 128, 2, 2))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == jax.tree.map(
        lambda a: tuple(a.shape), got)
    assert abs(float(got["layers"][0]["w1e"].std()) - 0.02) < 1e-3
    again = tmoe._init_moe_params(torch.Generator().manual_seed(0), 256, 64,
                                  128, 2, 2)
    assert torch.equal(again["embed"], got["embed"])
