"""The port's fused decode wave against the JAX package's.

The same numpy inputs, made from a seed, go through the Pallas kernel (in
interpret mode, as the JAX package's own tests run it on the CPU), its
oracle ``reference_decode_attention`` and the port's CPU wrapper, which is
the plain version ``decode_wave_attention_plain``. The Hopper kernel runs
only on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
it against the plain version there.

Tolerance 1e-5 on the attention output (fp32, the same math in another
summation order); the arena scatter is compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.ops.decode_kernel import (
    decode_wave_attention as jax_decode,
    reference_decode_attention,
)
from client_tpu_torch.ops import decode_attention as da

L, R, S, H = 2, 5, 32, 2   # 4 stream rows + the dummy row 4
DUMMY = R - 1

CASES = {
    # name: (rows, lens); lanes on the dummy row are padding
    "ragged": ([0, 2, 1], [7, 13, 20]),
    "len_zero": ([1], [0]),
    "len_one": ([3], [1]),
    "len_last": ([2], [S - 1]),
    "dummy_duplicates": ([0, 1, DUMMY, DUMMY, DUMMY], [5, S - 1, 0, 0, 0]),
}


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    k_a, v_a = (rng.standard_normal((L, R, S, H, d)).astype(np.float32)
                for _ in range(2))
    q, kn, vn = (rng.standard_normal((len(rows), H, d)).astype(np.float32)
                 for _ in range(3))
    return k_a, v_a, q, kn, vn


def _port(k_a, v_a, q, kn, vn, rows, lens, layer):
    k_t, v_t = torch.from_numpy(k_a.copy()), torch.from_numpy(v_a.copy())
    index = da.WaveIndex(rows, lens, R, S)
    o = da.decode_wave_attention(k_t, v_t, torch.from_numpy(q),
                                 torch.from_numpy(kn), torch.from_numpy(vn),
                                 index, layer=layer)
    return k_t.numpy(), v_t.numpy(), o.numpy()


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel_and_reference(case, d):
    rows, lens = CASES[case]
    k_a, v_a, q, kn, vn = _inputs(rows, d)
    layer = 1
    pk, pv, po = _port(k_a, v_a, q, kn, vn, rows, lens, layer)
    jargs = [jnp.asarray(x) for x in (k_a, v_a, q, kn, vn)] + [
        jnp.asarray(rows, jnp.int32), jnp.asarray(lens, jnp.int32)]
    _, _, fo = jax_decode(*jargs, layer=layer, block_s=8, interpret=True)
    rk, rv, ro = reference_decode_attention(*jargs, layer=layer)
    real = np.asarray(rows) != DUMMY  # padded lanes are junk everywhere
    np.testing.assert_allclose(po[real], np.asarray(fo)[real], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(po[real], np.asarray(ro)[real], atol=1e-5,
                               rtol=0)
    # The arena: every row but the dummy equals the reference, bit for bit.
    np.testing.assert_array_equal(pk[:, :DUMMY], np.asarray(rk)[:, :DUMMY])
    np.testing.assert_array_equal(pv[:, :DUMMY], np.asarray(rv)[:, :DUMMY])


def test_len_zero_gives_exactly_v_new():
    rows, lens = CASES["len_zero"]
    k_a, v_a, q, kn, vn = _inputs(rows, 64, seed=1)
    _, _, o = _port(k_a, v_a, q, kn, vn, rows, lens, layer=0)
    np.testing.assert_array_equal(o, vn)


def test_scatter_writes_one_slot_and_leaves_the_rest():
    rows, lens = CASES["ragged"]
    k_a, v_a, q, kn, vn = _inputs(rows, 64, seed=2)
    pk, pv, _ = _port(k_a, v_a, q, kn, vn, rows, lens, layer=1)
    want_k, want_v = k_a.copy(), v_a.copy()
    for b, (r, n) in enumerate(zip(rows, lens)):
        want_k[1, r, n], want_v[1, r, n] = kn[b], vn[b]
    np.testing.assert_array_equal(pk, want_k)  # untouched rows identical
    np.testing.assert_array_equal(pv, want_v)


def test_cpu_wrapper_launches_nothing():
    rows, lens = CASES["ragged"]
    k_a, v_a, q, kn, vn = _inputs(rows, 64)
    before = da.launches
    _port(k_a, v_a, q, kn, vn, rows, lens, layer=0)
    assert da.launches == before


@pytest.mark.parametrize("rows,lens", [
    ([R], [0]), ([-1], [0]), ([0], [S]), ([0], [-1]), ([0, 1], [0]),
])
def test_wave_index_refuses_out_of_range(rows, lens):
    with pytest.raises(ValueError):
        da.WaveIndex(rows, lens, R, S)


def test_shifted_index_is_checked_again():
    index = da.WaveIndex([0, 1], [S - 3, 4], R, S)
    assert index.shifted(2).lens.tolist() == [S - 1, 6]
    with pytest.raises(ValueError):
        index.shifted(3)


def _kernel_args(**change):
    args = dict(k_arena=torch.zeros(L, R, S, H, 64),
                v_arena=torch.zeros(L, R, S, H, 64),
                q=torch.zeros(2, H, 64), k_new=torch.zeros(2, H, 64),
                v_new=torch.zeros(2, H, 64),
                index=da.WaveIndex([0, 1], [3, 4], R, S), layer=0)
    args.update(change)
    return args


def _head_dim(d: int) -> dict:
    return dict(k_arena=torch.zeros(L, R, S, H, d),
                v_arena=torch.zeros(L, R, S, H, d), q=torch.zeros(2, H, d),
                k_new=torch.zeros(2, H, d), v_new=torch.zeros(2, H, d))


@pytest.mark.parametrize("case", [
    "float64_arena", "float64_q", "head_dim_32", "head_dim_48",
    "head_dim_128", "lane_shape", "index_for_another_arena", "layer",
    "not_contiguous", "head_dim_272",
])
def test_kernel_argument_checks(case):
    """What the kernel wrapper refuses before a launch (checked on CPU
    tensors: the checks read only shapes, dtypes and strides). The kernel
    takes every head dim from 1 to 256 (instantiated at 8, 16, 32, 64, 128
    and 256, the real head dim passed at run time), so head dims 32, 48
    and 128 pass the checks and head dim 272 is refused."""
    if case in ("head_dim_32", "head_dim_48", "head_dim_128"):
        args = _kernel_args(**_head_dim(int(case.rsplit("_", 1)[1])))
        da.check_kernel_args(args["k_arena"], args["v_arena"], args["q"],
                             args["k_new"], args["v_new"], args["index"], 0)
        return
    change = {
        "float64_arena": dict(k_arena=torch.zeros(L, R, S, H, 64,
                                                  dtype=torch.float64)),
        "float64_q": dict(q=torch.zeros(2, H, 64, dtype=torch.float64)),
        "lane_shape": dict(q=torch.zeros(3, H, 64)),
        "index_for_another_arena": dict(
            index=da.WaveIndex([0, 1], [3, 4], R, S + 1)),
        "layer": dict(layer=L),
        "not_contiguous": dict(q=torch.zeros(2, 64, H).transpose(1, 2)),
        "head_dim_272": _head_dim(272),
    }[case]
    args = _kernel_args(**change)
    with pytest.raises(ValueError):
        da.check_kernel_args(args["k_arena"], args["v_arena"], args["q"],
                             args["k_new"], args["v_new"], args["index"],
                             args["layer"])
    _ok = _kernel_args()
    da.check_kernel_args(_ok["k_arena"], _ok["v_arena"], _ok["q"],
                         _ok["k_new"], _ok["v_new"], _ok["index"], 0)


def test_other_devices_raise():
    k_a = torch.empty(L, R, S, H, 64, device="meta")
    q = torch.empty(1, H, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.decode_wave_attention(k_a, k_a, q, q, q,
                                 da.WaveIndex([0], [0], R, S), layer=0)


@pytest.mark.parametrize("lens,want", [
    ([], 1), ([0, 0, 0], 1), ([1], 1), ([256], 1), ([257], 2),
    ([2047], 8), ([5, 300, 0, 513], 3), ([2047, 0, 0, 1], 8),
    ([100_000], 8),
])
def test_split_plan_is_a_function_of_the_lengths(lens, want):
    """CTAs per (lane, head): ceil(longest / 256), at least 1, at most 8
    (the portable cluster size), whatever the other lanes hold."""
    assert da.split_plan(np.asarray(lens, np.int32)) == want
    assert da.split_plan(lens) == want


def test_wave_index_carries_its_split_plan():
    seq = 2048
    index = da.WaveIndex([0, 1, 2], [250, 3, 0], 4, seq)
    assert index.n_split == 1
    assert index.shifted(10).n_split == 2  # 260 keys: a second CTA
    assert da.WaveIndex([0], [2047], 4, seq).n_split == 8
    assert da.WaveIndex([], [], 4, seq).n_split == 1


def test_local_index_plans_for_its_own_lanes():
    """A shard's view keeps only the lengths of the lanes it owns, so its
    plan follows them, not the wave's longest lane."""
    index = da.WaveIndex([0, 5, 6], [1800, 100, 600], 8, 2048)
    assert index.n_split == 8
    low, high = index.local(0, 4, "cpu"), index.local(4, 4, "cpu")
    assert low.lens_host.tolist() == [1800, 0, 0] and low.n_split == 8
    assert high.lens_host.tolist() == [0, 100, 600] and high.n_split == 3
    assert high.shifted(2).n_split == 3  # unowned lanes stay at 0
    assert high.shifted(170).n_split == 4  # 770 keys


def test_kernel_argument_checks_refuse_a_misaligned_arena():
    """The kernel's bulk copies need a 16-byte aligned arena: a view that
    starts one float in is refused before any launch."""
    args = _kernel_args()
    numel = args["k_arena"].numel()
    shifted = torch.zeros(numel + 1)[1:].view(args["k_arena"].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.check_kernel_args(shifted, args["v_arena"], args["q"],
                             args["k_new"], args["v_new"], args["index"], 0)
