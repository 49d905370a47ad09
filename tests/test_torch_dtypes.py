"""K1, K2 and K3 in the dtypes the reference kernels take, against the JAX
package, on the CPU.

The Pallas kernels follow their inputs' dtype: ``flash_attention`` writes
q's dtype and rounds P to v's, ``decode_wave_attention`` writes the arena in
its own dtype (fp32 scratch), ``ring_all_reduce`` sums in x's dtype hop by
hop. The same numpy inputs, made from a seed and rounded once to bf16 or
fp16, go through the JAX functions (Pallas in interpret mode, as
``tests/test_ops.py`` runs them; the ring and the sharded paths under
``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``) and
through the port's CPU wrappers, which are the plain versions. The Hopper
kernels themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py --dtypes``).

Tolerances, each with its reason:

- K1 fp16: 5e-3. Both accumulate in fp32 and round P to fp16 (1 ulp =
  9.8e-4 at 1.0), the Pallas kernel under a per-block max.
- K2: 1e-2 in bf16, 1.25e-3 in fp16. The Pallas kernel rounds each score
  to the arena's dtype before the softmax; the port keeps fp32 scores, as
  the card's kernel does; both round o once. That moves o by up to about
  an ulp of outputs in [1, 2) (measured at these seeds: 7.8e-3 in bf16,
  9.8e-4 in fp16). The port's plain version is a dense einsum, so it cannot
  drop a key or a tile; the card's kernel is held to it far closer
  (two ulps of each output, ``tests/test_torch_cuda.py``). The arenas are
  bit for bit.
- K3: none. Both add in the ring's order and round each hop's sum to the
  partials' dtype, so every shard's sum is equal bit for bit.
- The sharded paths in bf16: K2's 1e-2 on the decode wave's output
  (measured 3.9e-3); the bag sums are bit for bit (multiples of 2^-6
  under 4 in magnitude add exactly in bf16 in any order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.ops.decode_kernel import decode_wave_attention as jax_decode
from client_tpu.ops.flash_attention import flash_attention as jax_flash
from client_tpu.parallel import emb_shard as jes
from client_tpu.parallel import kv_shard as jks
from client_tpu_torch.models.generate import KvArena
from client_tpu_torch.ops import decode_attention as da
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.parallel import emb_shard as es
from client_tpu_torch.parallel import kv_shard as ks

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}
K2_ATOL = {"bfloat16": 1e-2, "float16": 1.25e-3}
K1_FP16_ATOL = 5e-3


def _round(x: np.ndarray, name: str) -> np.ndarray:
    """fp32 numpy ``x`` rounded to the dtype ``name`` (round to nearest
    even), as numpy (``ml_dtypes``' bfloat16 for bf16)."""
    return np.asarray(x, np.float32).astype(DTYPES[name][0])


def _torch(x: np.ndarray) -> torch.Tensor:
    """A numpy array of float32, float16 or bfloat16 as a torch tensor of
    the same dtype and bits."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(t) -> np.ndarray:
    """The bits of a 2-byte tensor or array, as int16."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


# -- K2: the decode wave over bf16 and fp16 arenas -----------------------------

L, R, S, H = 2, 5, 64, 2   # 4 stream rows + the dummy row 4
DUMMY = R - 1
BLOCK_S = 16               # the Pallas kernel's key blocks: 4 a row
WAVES = {
    # Block edges of 16 keys and the row's last position.
    "edges": ([0, 1, 2, 3], [15, 16, 17, S - 1]),
    # Padded lanes on the dummy row (lens 0), a lane at length 0.
    "padded": ([0, 2, DUMMY, DUMMY], [33, 0, 0, 0]),
}


@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("d", [8, 32, 50, 64, 128])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_plain_matches_pallas_kernel(name, d, wave):
    rows, lens = WAVES[wave]
    rng = np.random.default_rng(d)
    k_a, v_a = (_round(rng.standard_normal((L, R, S, H, d)), name)
                for _ in range(2))
    q, kn, vn = (_round(rng.standard_normal((len(rows), H, d)), name)
                 for _ in range(3))
    jk, jv, jo = jax_decode(
        *[jnp.asarray(x) for x in (k_a, v_a, q, kn, vn)],
        jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32),
        layer=1, block_s=BLOCK_S, interpret=True)
    pk, pv = _torch(k_a), _torch(v_a)
    index = da.WaveIndex(rows, lens, R, S)
    before = da.launches
    po = da.decode_wave_attention(pk, pv, _torch(q), _torch(kn), _torch(vn),
                                  index, layer=1)
    assert da.launches == before  # the CPU wrapper is the plain version
    assert po.dtype == DTYPES[name][1] and pk.dtype == DTYPES[name][1]
    real = np.asarray(rows) != DUMMY  # padded lanes are junk everywhere
    err = np.abs(_f32(po)[real] - _f32(jo)[real]).max()
    assert err <= K2_ATOL[name], err
    # The arena: every row but the dummy equals the Pallas kernel's, bit
    # for bit (the scatter copies k_new's and v_new's bits).
    np.testing.assert_array_equal(_bits(pk)[:, :DUMMY],
                                  _bits(jk)[:, :DUMMY])
    np.testing.assert_array_equal(_bits(pv)[:, :DUMMY],
                                  _bits(jv)[:, :DUMMY])
    for b in np.flatnonzero(real & (np.asarray(lens) == 0)):
        np.testing.assert_array_equal(_bits(po[b]), _bits(vn[b]))


def test_decode_work_counts_two_byte_elements():
    """``work()``'s bytes follow the arena's element size: a bf16 wave
    moves half an fp32 one's K/V, q, k_new, v_new and o bytes (rows and
    lens stay int32); the FLOPs do not change."""
    index = da.WaveIndex([0, 1, 2], [7, 0, 40], R, S)
    b, keys = 3, 47
    flops4, bytes4 = da.work(index, H, 64)
    flops2, bytes2 = da.work(index, H, 64, 2)
    lane = H * 64
    assert bytes2 == (2 * keys + 6 * b) * lane * 2 + 2 * b * 4
    assert bytes4 == (2 * keys + 6 * b) * lane * 4 + 2 * b * 4
    assert flops2 == flops4 == 4.0 * H * 64 * (keys + b)


# -- K3: the ring in bf16 and fp16 ---------------------------------------------


def _jax_ring(x) -> np.ndarray:
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


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_ring_plain_matches_jax_ring_bit_for_bit(name, n):
    rng = np.random.default_rng(n)
    x = _round(rng.standard_normal((n, 3, 4, 64)) * 10, name)
    want = _jax_ring(x)
    assert want.dtype == x.dtype
    parts = [_torch(p) for p in x]
    before = ks.launches
    got = ks.ring_all_reduce(parts)
    assert ks.launches == before  # the CPU wrapper is the plain version
    for i in range(n):
        assert got[i].dtype == DTYPES[name][1]
        np.testing.assert_array_equal(_bits(got[i]), _bits(want[i]))
    # Each hop rounds: shard 0's sum is ((x_0 + x_{n-1}) + ...) in the
    # dtype, not the fp32 sum rounded once.
    order = parts[0].clone()
    for j in range(1, n):
        order += parts[-j]
    np.testing.assert_array_equal(_bits(got[0]), _bits(order))


def test_ring_work_counts_two_byte_elements():
    assert ks.ring_work(4, 1000, 2) == (12000.0, 2 * 4 * 1000 * 2)
    assert ks.ring_work(4, 1000) == (12000.0, 2 * 4 * 1000 * 4)


# -- K1 in fp16 ----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["causal", "fp32_bias", "fp16_bias"])
@pytest.mark.parametrize("d", [32, 64, 100, 128])
def test_flash_fp16_plain_matches_pallas_kernel(d, variant):
    b, s, h = 2, 128, 2
    rng = np.random.default_rng(d)
    q, k, v = (_round(rng.standard_normal((b, s, h, d)), "float16")
               for _ in range(3))
    bias = None
    if variant != "causal":
        bias = np.zeros((b, s), np.float32)
        bias[0, s - s // 4:] = -1e9   # BERT's padding mask
        bias[1, ::7] = -np.inf
        if variant == "fp16_bias":  # -1e9 is past fp16's range: -inf
            bias = np.where(bias < -65504, -np.inf, bias).astype(np.float16)
    causal = variant == "causal"
    want = jax_flash(*[jnp.asarray(x) for x in (q, k, v)],
                     None if bias is None else jnp.asarray(bias),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    assert want.dtype == jnp.float16
    got = fa.flash_attention(*[_torch(x) for x in (q, k, v)],
                             None if bias is None else _torch(bias),
                             causal=causal)
    assert got.dtype == torch.float16 and got.shape == q.shape
    assert np.isfinite(_f32(got)).all()
    np.testing.assert_allclose(_f32(got), _f32(want), atol=K1_FP16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("s, block", [(96, 32), (192, 64)])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_fp16_causal_plain_matches_pallas_kernel(d, s, block):
    """K1 fp16 causal at the head dims whose schedule the card's kernel
    redesigned (64, 128, 256 and 80, run there by the 96 instantiation),
    at lengths the Pallas kernel takes in blocks of 32 and 64, with
    BERT's padding mask and a row of dropped keys."""
    b, h = 2, 2
    rng = np.random.default_rng(d + s)
    q, k, v = (_round(rng.standard_normal((b, s, h, d)), "float16")
               for _ in range(3))
    bias = np.zeros((b, s), np.float32)
    bias[0, s - s // 4:] = -1e9
    bias[1, 1::5] = -np.inf
    want = jax_flash(*[jnp.asarray(x) for x in (q, k, v)], jnp.asarray(bias),
                     causal=True, block_q=block, block_k=block,
                     interpret=True)
    got = fa.flash_attention(*[_torch(x) for x in (q, k, v)], _torch(bias),
                             causal=True)
    assert got.dtype == torch.float16 and got.shape == q.shape
    assert np.isfinite(_f32(got)).all()
    np.testing.assert_allclose(_f32(got), _f32(want), atol=K1_FP16_ATOL,
                               rtol=0)


# -- the sharded paths in bf16 -------------------------------------------------

CAP, SL, SH, SD = 8, 16, 2, 8


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_decode_bf16_matches_jax(n):
    """K2 per shard over a row-sharded bf16 arena, then K3 in bf16: the
    output stays bf16 and within K2's bf16 tolerance of the JAX
    package's; the shards' stream rows are its arena's bit for bit."""
    total, free, dummy = ks.arena_row_layout(CAP, n)
    rows = [free[0], free[-1], free[len(free) // 2], dummy]
    lens = [5, SL - 1, 0, 0]
    rng = np.random.default_rng(30 + n)
    k_a, v_a = (_round(rng.standard_normal((2, total, SL, SH, SD)),
                       "bfloat16") for _ in range(2))
    q, kn, vn = (_round(rng.standard_normal((len(rows), SH, SD)), "bfloat16")
                 for _ in range(3))
    jk, jv, jo = jks.sharded_decode_attention(
        jks.kv_mesh(n), *[jnp.asarray(x) for x in (k_a, v_a, q, kn, vn)],
        jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32),
        layer=1, interpret=True, combine="ring")
    mesh = ks.kv_mesh(n, ["cpu"] * n)
    arena = ks.shard_arena(KvArena(k=_torch(k_a), v=_torch(v_a),
                                   tok=torch.zeros(total, dtype=torch.int32)),
                           mesh)
    index = ks.ShardedWaveIndex(da.WaveIndex(rows, lens, total, SL), mesh)
    o = ks.sharded_decode_attention(mesh, arena, _torch(q), _torch(kn),
                                    _torch(vn), index, layer=1,
                                    combine="ring")
    assert o.dtype == torch.bfloat16
    real = np.asarray(rows) != dummy
    err = np.abs(_f32(o)[real] - _f32(jo)[real]).max()
    assert err <= K2_ATOL["bfloat16"], err
    for mine, theirs in ((arena.k, jk), (arena.v, jv)):
        np.testing.assert_array_equal(
            _bits(torch.cat(mine, dim=1))[:, free], _bits(theirs)[:, free])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bag_sum_bf16_matches_jax(n):
    """The ring combine over a row-sharded bf16 table: bf16 pooled bags
    equal to the JAX package's and to the one-device oracle."""
    rng = np.random.default_rng(40 + n)
    rows, dim, segs = 64, 16, 12
    table = _round(rng.integers(-32, 33, (rows, dim)) / 64.0, "bfloat16")
    seg = np.concatenate([np.repeat(np.arange(segs), 5),
                          np.full(6, segs)]).astype(np.int32)  # + padding
    idx = rng.integers(0, rows, seg.size).astype(np.int32)
    mesh = jes.emb_mesh(n)
    want = np.asarray(jes.sharded_bag_sum(
        mesh, jes.shard_table(jnp.asarray(table), mesh), jnp.asarray(idx),
        jnp.asarray(seg), segs, combine="ring", interpret=True))
    assert want.dtype == jnp.bfloat16
    cpu = es.emb_mesh(n, ["cpu"] * n)
    got = es.sharded_bag_sum(cpu, es.shard_table(_torch(table), cpu),
                             torch.from_numpy(idx), torch.from_numpy(seg),
                             segs, combine="ring")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    oracle = es.bag_sum_oracle(_torch(table), torch.from_numpy(idx),
                               torch.from_numpy(seg), segs)
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


# -- what the kernels refuse ---------------------------------------------------


def _k2_args(arena_dtype, lane_dtype):
    z = torch.zeros
    return (z(L, R, S, H, 64, dtype=arena_dtype),
            z(L, R, S, H, 64, dtype=arena_dtype),
            *[z(2, H, 64, dtype=lane_dtype)] * 3,
            da.WaveIndex([0, 1], [3, 4], R, S), 0)


@pytest.mark.parametrize("case", [
    "k1_mixed", "k1_float64", "k2_mixed", "k2_float64", "k3_mixed",
])
def test_mixed_and_unsupported_dtypes_raise(case):
    """The kernels take one dtype at a time (the reference promotes mixed
    dtypes; that is still to port) and only fp32, bf16 and fp16: the
    wrappers' checks refuse anything else with a ValueError naming the
    rule (read on CPU tensors: the checks read only shapes and dtypes)."""
    if case.startswith("k1"):
        dt = torch.float64 if case == "k1_float64" else torch.float16
        q = torch.zeros(2, 64, 4, 64, dtype=dt)
        kv = torch.zeros(2, 64, 4, 64, dtype=(
            torch.float64 if case == "k1_float64" else torch.bfloat16))
        with pytest.raises(ValueError, match="one dtype|float16 or float32"):
            fa.check_kernel_args(q, kv, kv, None)
    elif case.startswith("k2"):
        args = (_k2_args(torch.float64, torch.float64)
                if case == "k2_float64"
                else _k2_args(torch.bfloat16, torch.float32))
        with pytest.raises(ValueError, match="one dtype|or float16 arenas"):
            da.check_kernel_args(*args)
    else:
        with pytest.raises(ValueError, match="partial 1"):
            ks.ring_all_reduce([torch.zeros(4, dtype=torch.bfloat16),
                                torch.zeros(4, dtype=torch.float16)])


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_two_byte_kernel_arguments_pass_the_checks(name):
    """bf16 and fp16 calls of every kernel pass the wrappers' checks (the
    kernels take them); a bias of any float dtype reaches K1 cast to a
    contiguous fp32 copy."""
    dt = DTYPES[name][1]
    q = torch.zeros(2, 64, 4, 64, dtype=dt)
    fa.check_kernel_args(q, q, q, torch.zeros(2, 64))
    da.check_kernel_args(*_k2_args(dt, dt))
    assert ks._DTYPES[dt] in (1, 2) and da._DTYPES[dt] in (1, 2)
