"""The port's row-sharded KV arena against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``client_tpu.parallel.kv_shard`` (Pallas in interpret mode under
``shard_map`` on the virtual CPU devices of ``tests/conftest.py``) and
``client_tpu_torch.parallel.kv_shard`` (shards on ``cpu``, so every wrapper
is its plain version). Tolerances: the ring's sums within ``rtol=1e-6`` and
in fact equal, since both add in the ring's order; the sharded decode
wave's output within 2e-5 and the arena's free rows within 1e-6 (fp32, the
same math in another summation order; junk rows are not compared); token
streams equal the JAX engine's token for token.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models.generate import TinyGptBackend as JaxGpt
from client_tpu.parallel import kv_shard as jks
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models.generate import KvArena, TinyGptBackend
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.parallel import kv_shard as ks

KW = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
          max_seq_len=32, max_streams=4)

# tests/test_generative.py TestFusedDecode._stream_suite: greedy over three
# prompt lengths, then the seed-42 and seed-7 sampled streams.
SUITE = [([1, 2, 3], 6, {}), ([7] * 9, 6, {}), ([5], 6, {}),
         ([4, 4], 8, dict(temperature=1.0, seed=42)),
         ([4, 4], 8, dict(temperature=0.8, seed=7, top_k=24, top_p=0.9))]


def _cpu_mesh(n):
    return ks.kv_mesh(n, ["cpu"] * n)


# -- row layout and mesh ------------------------------------------------------


@pytest.mark.parametrize("cap,n", [(4, 1), (4, 2), (16, 2), (16, 4), (8, 8),
                                   (64, 4), (6, 3), (1, 1), (5, 2), (16, 3),
                                   (4, 8)])
def test_arena_row_layout_equals_jax(cap, n):
    try:
        want = jks.arena_row_layout(cap, n)
    except ValueError as exc:
        assert "divisible" in str(exc)
        with pytest.raises(ValueError, match="divisible"):
            ks.arena_row_layout(cap, n)
        return
    assert ks.arena_row_layout(cap, n) == want


def test_kv_mesh_raises_past_the_device_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"kv_shards=2 but runtime has 1 "
                                         r"device\(s\)"):
        ks.kv_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="0 device"):
        ks.kv_mesh(1)


def test_kv_mesh_repeats_one_device_and_refuses_distinct_ones():
    mesh = _cpu_mesh(4)
    assert mesh.size == 4
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(NotImplementedError, match="distinct"):
        ks.kv_mesh(2, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="2 device"):
        ks.kv_mesh(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        ks.kv_mesh(0)


# -- K3's plain version --------------------------------------------------------


def _jax_ring(x: np.ndarray) -> np.ndarray:
    """JAX's ring_all_reduce over the first axis of ``x`` (one slice per
    virtual device), as tests/test_ops.py runs it."""
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    n = x.shape[0]

    def body(x_sh):
        return jks.ring_all_reduce(x_sh[0], "kv", n, interpret=True)[None]

    kwargs = dict(mesh=jks.kv_mesh(n), in_specs=(P("kv"),),
                  out_specs=P("kv"))
    try:
        fn = shard_map(body, check_vma=False, **kwargs)
    except TypeError:
        fn = shard_map(body, check_rep=False, **kwargs)
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("n,shape", [(4, (3, 4, 64)), (2, (1, 4, 64)),
                                     (3, (2, 2, 8))])
def test_ring_plain_equals_jax_ring(n, shape):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, *shape)) * 10).astype(np.float32)
    want = _jax_ring(x)
    got = ks.ring_all_reduce_plain([torch.from_numpy(p) for p in x])
    assert len(got) == n
    for i in range(n):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-6)
        # The same additions in the same order: equal, not only close.
        np.testing.assert_array_equal(got[i].numpy(), want[i])
    # Shard i's order differs from shard j's: the plain version keeps it.
    order = x[0].copy()
    for j in range(1, n):
        order += x[-j]
    np.testing.assert_array_equal(got[0].numpy(), order)


def test_ring_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((16, 4, 64))
                              .astype(np.float32)) for _ in range(2)]
    before = ks.launches
    got = ks.ring_all_reduce(parts)
    assert ks.launches == before  # the CPU path launches no kernel
    for g, w in zip(got, ks.ring_all_reduce_plain(parts)):
        assert torch.equal(g, w)
    alone = ks.ring_all_reduce(parts[:1])
    assert alone[0] is parts[0]  # n == 1: the input, untouched
    with pytest.raises(ValueError, match="partial 1"):
        ks.ring_all_reduce([parts[0], parts[1][:3]])
    with pytest.raises(ValueError, match="at least one"):
        ks.ring_all_reduce([])


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(1, 4, 64), (16, 4, 64), (5,)])
def test_ring_wrapper_on_the_cpu_sums_in_ring_order(n, shape):
    """The CPU wrapper returns the plain version's sums, each shard's in
    its own ring order ((x_i + x_{i-1}) + ...) + x_{i+1}, the order the
    card's one-shot kernel adds in, bit for bit."""
    rng = np.random.default_rng(10 + n)
    parts = [torch.from_numpy((rng.standard_normal(shape) * 10)
                              .astype(np.float32)) for _ in range(n)]
    got = ks.ring_all_reduce(parts)
    assert len(got) == n
    for i, (g, w) in enumerate(zip(got, ks.ring_all_reduce_plain(parts))):
        want = parts[i].clone()
        for j in range(1, n):
            want += parts[(i - j) % n]
        assert torch.equal(g, w) and torch.equal(g, want)


# -- the sharded decode wave ---------------------------------------------------

CAP, N = 4, 2
TOTAL, FREE, DUMMY = ks.arena_row_layout(CAP, N)
LAYERS, S, H, D = 2, 16, 2, 8

WAVES = {
    # tests/test_ops.py test_sharded_matches_single_chip: global rows 0
    # (shard 0), 3 and 4 (shard 1).
    "both_shards": ([FREE[0], FREE[2], FREE[3]], [5, 0, S - 1]),
    "padded": ([FREE[3], FREE[1], DUMMY, DUMMY], [9, 3, 0, 0]),
    "one_shard": ([FREE[2]], [12]),
}


def _wave_inputs(b, seed=3):
    rng = np.random.default_rng(seed)
    k_a, v_a = (rng.standard_normal((LAYERS, TOTAL, S, H, D))
                .astype(np.float32) for _ in range(2))
    q, kn, vn = (rng.standard_normal((b, H, D)).astype(np.float32)
                 for _ in range(3))
    return k_a, v_a, q, kn, vn


@pytest.mark.parametrize("combine", ["ring", "psum"])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_sharded_decode_matches_jax(wave, combine):
    rows, lens = WAVES[wave]
    k_a, v_a, q, kn, vn = _wave_inputs(len(rows))
    sk, sv, so = jks.sharded_decode_attention(
        jks.kv_mesh(N), jnp.asarray(k_a), jnp.asarray(v_a), jnp.asarray(q),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(rows, jnp.int32),
        jnp.asarray(lens, jnp.int32), layer=1, interpret=True,
        combine=combine)

    mesh = _cpu_mesh(N)
    arena = ks.shard_arena(KvArena(k=torch.from_numpy(k_a),
                                   v=torch.from_numpy(v_a),
                                   tok=torch.zeros(TOTAL, dtype=torch.int32)),
                           mesh)
    index = ks.ShardedWaveIndex(da.WaveIndex(rows, lens, TOTAL, S), mesh)
    before = ks.launches
    o = ks.sharded_decode_attention(
        mesh, arena, torch.from_numpy(q), torch.from_numpy(kn),
        torch.from_numpy(vn), index, layer=1, combine=combine)
    assert ks.launches == before

    real = np.asarray(rows) != DUMMY
    err = np.abs(o.numpy()[real] - np.asarray(so)[real]).max()
    assert err < 2e-5, err
    for mine, theirs in ((arena.k, sk), (arena.v, sv)):
        np.testing.assert_allclose(torch.cat(mine, dim=1)[:, FREE].numpy(),
                                   np.asarray(theirs)[:, FREE], rtol=1e-6)
    # The shards' untouched input arena is the JAX one's: only the wave's
    # slots moved, and only on the owning shard.
    whole_k = torch.cat(arena.k, dim=1).numpy()
    for r, n in zip(rows, lens):
        if r != DUMMY:
            np.testing.assert_array_equal(whole_k[1, r, n], kn[rows.index(r)])


def test_sharded_decode_refuses_another_mesh_or_combine():
    rows, lens = WAVES["one_shard"]
    k_a, v_a, q, kn, vn = _wave_inputs(1)
    mesh = _cpu_mesh(N)
    arena = ks.shard_arena(KvArena(k=torch.from_numpy(k_a),
                                   v=torch.from_numpy(v_a),
                                   tok=torch.zeros(TOTAL, dtype=torch.int32)),
                           mesh)
    index = ks.ShardedWaveIndex(da.WaveIndex(rows, lens, TOTAL, S), mesh)
    args = (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn))
    with pytest.raises(ValueError, match="combine"):
        ks.sharded_decode_attention(mesh, arena, *args, index, layer=0,
                                    combine="allgather")
    with pytest.raises(ValueError, match="mesh"):
        ks.sharded_decode_attention(_cpu_mesh(N), arena, *args, index,
                                    layer=0)


def test_sharded_index_maps_rows_per_shard_and_shifts_owned_lanes():
    # 4 streams over 2 shards: 3 local rows each, local row 2 the junk row.
    rows, lens = [0, 4, 2, 3], [5, 7, 0, 1]
    index = ks.ShardedWaveIndex(da.WaveIndex(rows, lens, TOTAL, S),
                                _cpu_mesh(N))
    s0, s1 = index.shards
    assert s0.rows.tolist() == [0, 2, 2, 2] and s0.lens.tolist() == [5, 0, 0, 0]
    assert s0.owned.tolist() == [True, False, True, False]
    assert s1.rows.tolist() == [2, 1, 2, 0] and s1.lens.tolist() == [0, 7, 0, 1]
    assert s1.owned.tolist() == [False, True, False, True]
    assert (s0.n_rows, s0.seq) == (3, S)
    moved = index.shifted(2)
    assert moved.lens.tolist() == [7, 9, 2, 3]
    assert moved.shards[0].lens.tolist() == [7, 0, 2, 0]
    assert moved.shards[1].lens.tolist() == [0, 9, 0, 3]
    with pytest.raises(ValueError, match="outside"):
        index.shifted(S - 7)  # lane 1 would pass the last position
    with pytest.raises(ValueError, match="do not split"):
        ks.ShardedWaveIndex(da.WaveIndex([TOTAL], [0], TOTAL + 1, S),
                            _cpu_mesh(N))


# -- the backend and the engine ------------------------------------------------


def test_sharded_backend_equals_the_unsharded_one():
    """Prefill, a wave and a 3-wave chunk give the same tokens, and the
    same K/V in every stream row, over 2 shards as over one arena."""
    one = TinyGptBackend(name="tg", attn_impl="fused", device="cpu", **KW)
    two = TinyGptBackend(name="tg", attn_impl="fused", kv_shards=2,
                         device="cpu", **KW)
    free2, dummy2 = two.arena_rows()
    free1, dummy1 = one.arena_rows()
    assert (free2, dummy2) == (FREE, DUMMY)
    rng = np.random.default_rng(2)
    plens = np.array([11, 5, 1, 1], np.int32)
    ids = np.zeros((4, 16), np.int32)
    for i in range(2):
        ids[i, :plens[i]] = rng.integers(0, 128, plens[i])
    lanes = ([3, -7, 0, 0], [0.0, 0.8, 0.0, 0.0], [0, 24, 0, 0],
             [1.0, 0.9, 1.0, 1.0])
    got = {}
    for backend, free, dummy in ((one, free1, dummy1), (two, free2, dummy2)):
        rows = np.array([free[3], free[0], dummy, dummy], np.int32)
        arena = backend.init_arena(CAP)
        lp = backend.lane_params(*lanes)
        first = backend.prefill(arena, backend.wave_index(arena, rows, plens),
                                torch.from_numpy(ids), lp, True)
        wave_lens = np.where(rows == dummy, 0, plens).astype(np.int32)
        nxt = backend.decode(arena, backend.wave_index(arena, rows,
                                                       wave_lens), lp, True)
        chunk_lens = np.where(rows == dummy, 0, plens + 1).astype(np.int32)
        chunk = backend.decode_chunk(
            arena, backend.wave_index(arena, rows, chunk_lens), lp, True, 3)
        k = (torch.cat(arena.k, dim=1) if isinstance(arena.k, list)
             else arena.k)[:, rows[:2]]
        got[backend.kv_shards] = (first[:2], nxt[:2], chunk[:, :2], k)
    for a, b in zip(got[1], got[2]):
        assert torch.equal(a, b)


def test_backend_checks_its_mesh():
    backend = TinyGptBackend(name="tg", attn_impl="fused", kv_shards=2,
                             device="cpu", **KW)
    backend._kv_mesh = _cpu_mesh(4)
    with pytest.raises(ValueError, match="2 shards"):
        backend.init_arena(CAP)


def _collect(eng, prompt, n, request_cls=InferRequest, **params):
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
        model_name="tg", inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
        parameters={"max_tokens": n, **params}), cb)

    def join():
        assert done.wait(120), "stream stalled"
        if errs:
            raise errs[0]
        return toks

    return join


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX engine's suite streams on its reference decode path (the
    JAX suite holds its sharded path equal to that one)."""
    repo = JaxRepository()
    repo.register_backend(JaxGpt(name="tg", attn_impl="reference", **KW))
    eng = TpuEngine(repo)
    try:
        return [_collect(eng, p, n, JaxRequest, **kw)()
                for p, n, kw in SUITE]
    finally:
        eng.shutdown()


def _sharded_engine(combine="ring"):
    def build(device):
        backend = TinyGptBackend(name="tg", attn_impl="fused", kv_shards=2,
                                 device=device, **KW)
        backend.kv_combine = combine
        return backend

    repo = ModelRepository()
    repo.register("tg", build)
    return TorchEngine(repo, device="cpu")


@pytest.mark.parametrize("combine", ["ring", "psum"])
def test_sharded_streams_equal_the_jax_engine(jax_streams, combine):
    eng = _sharded_engine(combine)
    try:
        sched = eng._schedulers["tg"]
        assert sched.arena_shards() == 2
        assert sched.model.backend._mesh().size == 2
        assert sched._dummy == DUMMY and sorted(sched._free) == FREE
        solo = [_collect(eng, p, n, **kw)() for p, n, kw in SUITE]
        joins = [_collect(eng, p, n, **kw) for p, n, kw in SUITE]
        together = [j() for j in joins]
    finally:
        eng.shutdown()
    assert solo == jax_streams
    assert together == jax_streams


def test_sharded_chunked_decode_equals_the_jax_engine(jax_streams,
                                                      monkeypatch):
    monkeypatch.setenv("CLIENT_TPU_GEN_CHUNK", "4")
    eng = _sharded_engine()
    try:
        assert eng._schedulers["tg"]._chunk == 4
        got = [_collect(eng, p, n, **kw)() for p, n, kw in SUITE]
    finally:
        eng.shutdown()
    assert got == jax_streams
