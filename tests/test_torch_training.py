"""The port's three train steps against the JAX package's, on the CPU.

Each of ``make_train_step`` (dp x sp x tp), ``make_pipeline_train_step``
(dp x pp) and ``make_moe_train_step`` (dp x ep x tp) runs in JAX on the 8
virtual CPU devices of ``tests/conftest.py`` and in the port on a mesh of
``["cpu"] * 8`` of the same shape, from the same weights (JAX's init,
carried over with ``params_from_jax``), on the same seeded numpy tokens,
with AdamW's state at zero on both sides.

Tolerances, all fp32:

- the first loss and every leaf's gradient within 1e-5 of the leaf's
  largest magnitude (relative): the same math in another summation order;
- every parameter after 3 steps within ``PARAM_ATOL`` = 2 x lr x steps
  absolute (6e-3 at lr 1e-3), and within 1e-5 of JAX's for all but a
  few elements: Adam divides each moment by its square root, so an
  element whose gradient is near 0 (a rounding difference apart in the
  two frameworks) can take a step of up to lr in either direction.

The weight-decay case holds the elements with no gradient (embedding rows
of tokens the batch does not use), whose step is the decay alone, within
1e-6 relative of JAX's: optax's 1e-4 matches, torch's own AdamW default of
0.01 does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from client_tpu.parallel import mesh as jmesh
from client_tpu.parallel import moe as jmoe
from client_tpu.parallel import pipeline as jpipe
from client_tpu.parallel import training as jtrain
from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import moe as tmoe
from client_tpu_torch.parallel import pipeline as tpipe
from client_tpu_torch.parallel import training as ttrain

CPU8 = ["cpu"] * 8
LR = 1e-3
STEPS = 3
PARAM_ATOL = 2 * LR * STEPS
REL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _nll(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return jnp.mean(-jnp.take_along_axis(logp, targets[..., None], axis=-1))


def _jax_train():
    jm = jmesh.make_mesh(8, axes=("dp", "sp", "tp"))
    params, opt, step, sharding = jtrain.make_train_step(jm, lr=LR)
    constrain = jmesh.make_constrain(jm)
    tokens = np.random.default_rng(0).integers(0, 256, (8, 33)).astype(
        np.int32)

    def loss_fn(p, toks):
        return _nll(jtrain._forward(p, toks[:, :-1], 4, constrain),
                    toks[:, 1:])

    def port(params_np, **kw):
        tm = tmesh.make_mesh(8, axes=("dp", "sp", "tp"), devices=CPU8)
        return ttrain.make_train_step(
            tm, lr=LR, params=ttrain.params_from_jax(params_np, "cpu"), **kw)

    return (params, opt, step, loss_fn, jax.device_put(tokens, sharding),
            tokens, port)


def _jax_pipeline():
    jm = jmesh.make_mesh(8, axes=("dp", "pp"))
    n_layers = jm.shape["pp"] * 2
    params, opt, step, shard_fn = jpipe.make_pipeline_train_step(
        jm, n_layers=n_layers, lr=LR)
    tokens = np.random.default_rng(1).integers(0, 256, (3, 4, 17)).astype(
        np.int32)

    def loss_fn(p, toks):
        inp, tgt = toks[..., :-1], toks[..., 1:]
        mask = jnp.tril(jnp.ones((inp.shape[-1],) * 2, dtype=bool))
        x = jpipe.pipeline_apply(jm, {k: p[k] for k in tpipe.BLOCK_KEYS},
                                 p["embed"][inp], 4, mask)
        return _nll(jtrain._rms_norm(x) @ p["unembed"], tgt)

    def port(params_np, **kw):
        tm = tmesh.make_mesh(8, axes=("dp", "pp"), devices=CPU8)
        out = tpipe.make_pipeline_train_step(
            tm, n_layers=n_layers, lr=LR,
            params=ttrain.params_from_jax(params_np, "cpu"), **kw)
        return out[:3] + (None,)

    return params, opt, step, loss_fn, shard_fn(tokens), tokens, port


def _jax_moe():
    jm = jmesh.make_mesh(8, axes=("dp", "ep", "tp"))
    params, opt, step, sharding = jmoe.make_moe_train_step(
        jm, batch=8, seq=16, lr=LR)
    constrain = jmesh.make_constrain(jm)
    capacity = int(np.ceil(8 * 15 / jmoe.default_n_experts(jm) * 1.25))
    tokens = np.random.default_rng(2).integers(0, 256, (8, 16)).astype(
        np.int32)

    def loss_fn(p, toks):
        logits, aux = jmoe._moe_forward(p, toks[:, :-1], 4, capacity,
                                        constrain)
        return _nll(logits, toks[:, 1:]) + 1e-2 * aux

    def port(params_np, **kw):
        tm = tmesh.make_mesh(8, axes=("dp", "ep", "tp"), devices=CPU8)
        return tmoe.make_moe_train_step(
            tm, batch=8, seq=16, lr=LR,
            params=ttrain.params_from_jax(params_np, "cpu"), **kw)

    return (params, opt, step, loss_fn, jax.device_put(tokens, sharding),
            tokens, port)


STEP_CASES = {"train": _jax_train, "pipeline": _jax_pipeline,
              "moe": _jax_moe}


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both frameworks' first loss, gradients and parameters after each of
    STEPS steps, from the same weights and tokens."""
    params, opt, step, loss_fn, jtokens, tokens, port = STEP_CASES[name]()
    start = _np(params)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, jtokens)
    jgrads = _np(jgrads)
    jparams, jlosses = [], []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jtokens)
        jlosses.append(float(loss))
        jparams.append(_np(params))
    assert abs(jlosses[0] - float(jloss)) <= REL * abs(float(jloss))

    tparams, topt, tstep, _ = port(start)
    tlosses, tparams_each, tgrads = [], [], None
    for i in range(STEPS):
        tparams, topt, loss = tstep(tparams, topt, torch.from_numpy(tokens))
        if i == 0:
            tgrads = ttrain.tree_map(lambda g: g.numpy(), tstep.last_grads)
        tlosses.append(float(loss))
        tparams_each.append(ttrain.tree_map(lambda x: x.numpy(), tparams))
    return dict(name=name, start=start, port=port, tokens=tokens,
                jlosses=jlosses, jgrads=jgrads, jparams=jparams,
                tlosses=tlosses, tgrads=tgrads, tparams=tparams_each)


@pytest.fixture(scope="module", params=list(STEP_CASES))
def run(request):
    return _run(request.param)


def _pairs(a, b, path=""):
    """(path, a leaf, b leaf) over two trees of the same structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def test_first_loss_equals_jax(run):
    assert abs(run["tlosses"][0] - run["jlosses"][0]) <= REL * abs(
        run["jlosses"][0]), (run["tlosses"], run["jlosses"])


def test_every_gradient_equals_jax(run):
    for path, want, got in _pairs(run["jgrads"], run["tgrads"]):
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= REL * scale, f"{run['name']} {path}: {err} vs {scale}"


def test_params_after_three_steps_equal_jax(run):
    close = total = 0
    for step in range(STEPS):
        for path, want, got in _pairs(run["jparams"][step],
                                      run["tparams"][step]):
            err = np.abs(got - want)
            assert float(err.max()) <= PARAM_ATOL, (
                f"{run['name']} step {step + 1} {path}: {float(err.max())}")
            if step == STEPS - 1:
                close += int((err <= REL * max(float(np.abs(want).max()),
                                                1e-30)).sum())
                total += err.size
    # All but a few near-zero-gradient elements agree to 1e-5 relative.
    assert close >= 0.999 * total, (close, total)


def test_losses_track_jax(run):
    np.testing.assert_allclose(run["tlosses"], run["jlosses"], rtol=1e-4)


@pytest.mark.parametrize("decay,matches", [(1e-4, True), (1e-2, False)],
                         ids=["optax_1e-4", "torch_default_1e-2"])
def test_weight_decay_is_optax_default(decay, matches):
    """The embedding rows of tokens the batch never reads have no gradient:
    one step moves them by the decay alone, ``p (1 - lr wd)``. (The three
    steps share the optimizer; the dp x sp x tp one is checked.)"""
    run = _run("train")
    params, opt, step, _ = run["port"](run["start"], weight_decay=decay)
    params, _, _ = step(params, opt, torch.from_numpy(run["tokens"]))
    used = np.unique(run["tokens"][:, :-1])
    unused = np.setdiff1d(np.arange(256), used)
    assert len(unused) > 50
    got = params["embed"].numpy()[unused]
    want = run["jparams"][0]["embed"][unused]
    start = run["start"]["embed"][unused]
    np.testing.assert_allclose(want, start * (1 - LR * 1e-4), rtol=1e-6)
    assert np.allclose(got, want, rtol=1e-6, atol=0) is matches


def test_adamw_update_equals_optax():
    """One AdamW update on a random tree, from zero and then from a
    nonzero state, against ``optax.adamw`` with its defaults."""
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    tx = optax.adamw(3e-3)
    jstate = tx.init(p)
    tp = ttrain.tree_map(torch.from_numpy, p)
    tstate = ttrain.adamw_init(tp)
    jp = p
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2)
                         .astype(np.float32), p)
        updates, jstate = tx.update(g, jstate, jp)
        jp = _np(optax.apply_updates(jp, updates))
        tp, tstate = ttrain.adamw_update(
            tp, ttrain.tree_map(torch.from_numpy, g), tstate, 3e-3)
        for path, want, got in _pairs(jp, ttrain.tree_map(
                lambda x: x.numpy(), tp)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8,
                                       err_msg=path)
    assert tstate["count"] == 3


@pytest.mark.parametrize("init", ["train", "moe", "stacked"])
def test_params_from_jax_keeps_the_tree(init):
    key = jax.random.PRNGKey(3)
    tree = _np({"train": lambda: jtrain._init_params(key, 64, 32, 64, 2),
                "moe": lambda: jmoe._init_moe_params(key, 64, 32, 64, 2, 4),
                "stacked": lambda: jpipe._init_stacked_params(
                    key, 64, 32, 64, 4)}[init]())
    got = ttrain.params_from_jax(tree, "cpu")
    for path, want, have in _pairs(tree, ttrain.tree_map(
            lambda x: x.numpy(), got)):
        np.testing.assert_array_equal(have, want, err_msg=path)
    gen = torch.Generator().manual_seed(0)
    torch_init = {"train": lambda: ttrain._init_params(gen, 64, 32, 64, 2),
                  "moe": lambda: tmoe._init_moe_params(gen, 64, 32, 64, 2, 4),
                  "stacked": lambda: tpipe._init_stacked_params(
                      gen, 64, 32, 64, 4)}[init]()
    for path, want, have in _pairs(tree, torch_init):
        assert tuple(have.shape) == want.shape, path


# -- the JAX package's own cases, on the port ---------------------------------


class TestTraining:
    def test_dryrun_step_8dev(self):
        assert np.isfinite(ttrain.dryrun_training_step(8, device="cpu"))

    def test_dryrun_step_2dev(self):
        assert np.isfinite(ttrain.dryrun_training_step(2, device="cpu"))


class TestPipeline:
    def test_train_step_runs(self):
        assert np.isfinite(tpipe.dryrun_pipeline_step(8, device="cpu"))

    def test_train_step_learns(self):
        """Loss drops over a few steps on a fixed batch (grads flow through
        the ppermute ring and the broadcast of the last stage)."""
        tm = tmesh.make_mesh(8, axes=("dp", "pp"), devices=CPU8)
        params, opt, step, shard_fn = tpipe.make_pipeline_train_step(
            tm, n_layers=tm.shape["pp"], lr=1e-2)
        tokens = shard_fn(np.random.default_rng(0).integers(
            0, 256, size=(4, 2, 17)))
        losses = []
        for _ in range(4):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses

    def test_rejects_layers_not_dividing_by_pp(self):
        jm = jmesh.make_mesh(8, axes=("dp", "pp"))
        with pytest.raises(ValueError) as want:
            jpipe.make_pipeline_train_step(jm, n_layers=3)
        tm = tmesh.make_mesh(8, axes=("dp", "pp"), devices=CPU8)
        with pytest.raises(ValueError) as got:
            tpipe.make_pipeline_train_step(tm, n_layers=3)
        assert str(got.value) == str(want.value)

    def test_rejects_a_microbatch_not_dividing_by_dp(self):
        jm = jmesh.make_mesh(8, axes=("dp", "pp"))
        *_, jshard = jpipe.make_pipeline_train_step(jm, n_layers=4)
        tm = tmesh.make_mesh(8, axes=("dp", "pp"), devices=CPU8)
        *_, tshard = tpipe.make_pipeline_train_step(tm, n_layers=4)
        bad = np.zeros((2, 3, 17), np.int32)
        with pytest.raises(ValueError) as want:
            jshard(bad)
        with pytest.raises(ValueError) as got:
            tshard(bad)
        assert str(got.value) == str(want.value)


class TestMoe:
    def test_train_step_runs(self):
        assert np.isfinite(tmoe.dryrun_moe_step(8, device="cpu"))

    def test_train_step_learns(self):
        tm = tmesh.make_mesh(8, axes=("dp", "ep", "tp"), devices=CPU8)
        params, opt, step, _ = tmoe.make_moe_train_step(tm, lr=1e-2)
        tokens = np.random.default_rng(0).integers(0, 256, (8, 16))
        losses = []
        for _ in range(4):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
        assert losses[-1] < losses[0], losses

    def test_capacity_comes_from_batch_and_seq(self):
        """Tokens of another shape than (batch, seq) keep the capacity of
        (batch, seq), as JAX's step does: the losses agree on a 4 x 16
        batch under batch=8."""
        jm = jmesh.make_mesh(8, axes=("dp", "ep", "tp"))
        params, opt, step, sharding = jmoe.make_moe_train_step(
            jm, batch=8, seq=16, lr=LR)
        start = _np(params)
        tokens = np.random.default_rng(4).integers(0, 256, (4, 16)).astype(
            np.int32)
        _, _, jloss = step(params, opt, jax.device_put(tokens, sharding))
        tm = tmesh.make_mesh(8, axes=("dp", "ep", "tp"), devices=CPU8)
        tparams, topt, tstep, _ = tmoe.make_moe_train_step(
            tm, batch=8, seq=16, lr=LR,
            params=ttrain.params_from_jax(start, "cpu"))
        _, _, tloss = tstep(tparams, topt, tokens)
        assert abs(float(tloss) - float(jloss)) <= REL * abs(float(jloss))

    def test_router_gradient_comes_through_the_gate(self):
        """argmax carries no gradient: the router's gradient is nonzero
        (through ``gate``), and equals JAX's (``test_every_gradient``)."""
        tm = tmesh.make_mesh(8, axes=("dp", "ep", "tp"), devices=CPU8)
        params, opt, step, _ = tmoe.make_moe_train_step(tm)
        step(params, opt, np.random.default_rng(0).integers(0, 256, (8, 16)))
        router = step.last_grads["layers"][0]["router"]
        assert float(router.abs().max()) > 0
