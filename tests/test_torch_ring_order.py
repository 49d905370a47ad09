"""K3's order of additions, held bit for bit on the CPU.

The port's ``ring_all_reduce_plain`` against JAX on adversarial values in
fp32, bf16 and fp16: exact ties at half an ulp, exponent spreads wider than
fp32's significand, subnormals, +-0, sums that overflow to +-inf, and
cancellation. JAX's side is ``client_tpu.parallel.kv_shard.ring_all_reduce``
under ``shard_map`` in interpret mode at 2 to 8 shards (the 8 virtual CPU
devices of ``tests/conftest.py``), and above 8 a re-enactment of its kernel
``_ring_kernel`` hop by hop in eager ``jnp``, one dispatched add per hop
(no ``jit``, which could fuse the hops and keep excess precision). The
kernel itself cannot run here, so its schedule is emulated: for every
walk the kernel can launch (R chains a thread, W warps a CTA, streamed
through a ring of shared-memory rows or every row staged at once, or the
direct walk from registers), each chain adds the partials in its shard's
ring order, and sums formed in that order from -0.0 equal the plain
version's. Tolerance everywhere: none, bit patterns compared (NaN where,
and only where, the other side has NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.parallel import kv_shard as jks
from client_tpu_torch.parallel import kv_shard as ks

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16)}


def _adversarial(n: int, numel: int, name: str, seed: int) -> np.ndarray:
    """``n`` partials of ``numel`` elements of the dtype: a third of the
    elements draw every shard's value from a pool of edge values (+-0,
    +-1, 1 + ulp, half and quarter ulps, the smallest normal and
    subnormals, the largest finite values, powers of two 2^30 apart,
    +-1000 for cancellation), a third hold one +-1 among +-half-ulps and
    zeros (a tie at every hop), and a third hold large values whose sums
    overflow (and a few infinities, so that inf - inf makes NaN)."""
    np_dt = DTYPES[name][0]
    fi = jnp.finfo(np_dt)
    eps, tiny, big = float(fi.eps), float(fi.tiny), float(fi.max)
    sub = tiny * eps  # the smallest subnormal
    far = min(2.0 ** 30, big / 4)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 1 + eps, -(1 + eps), eps / 2,
                     -eps / 2, 1.5 * eps, eps / 4, 1.5, -1.5, tiny, -tiny,
                     sub, -sub, 3 * sub, tiny - sub, big, -big, big / 2,
                     -big / 2, far, -far, 1 / far, -1 / far, 1000.0,
                     -1000.0])
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 3, numel)
    x = pool[rng.integers(0, len(pool), (n, numel))]
    ties = rng.choice([eps / 2, -eps / 2, 0.0, -0.0], (n, numel))
    ties[rng.integers(0, n, numel), np.arange(numel)] = rng.choice(
        [1.0, 1 + eps, -1.0], numel)
    large = rng.choice([big, big / 2, -big / 2, big / 4, -big, np.inf,
                        -np.inf], (n, numel), p=[.2, .2, .2, .15, .2, .025,
                                                 .025])
    x = np.where(mode == 1, ties, np.where(mode == 2, large, x))
    return x.astype(np_dt)


def _bits(a) -> np.ndarray:
    """Bit patterns of a numpy array or CPU tensor, every NaN as -1."""
    if isinstance(a, torch.Tensor):
        nan = torch.isnan(a.float()).numpy()
        bits = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
        bits = bits.numpy().astype(np.int64)
    else:
        a = np.asarray(a)
        nan = np.isnan(a.astype(np.float32))
        bits = a.view({2: np.int16, 4: np.int32}[a.itemsize]).astype(
            np.int64)
    bits[nan] = -1
    return bits


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


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


def _jax_hops(x: np.ndarray) -> np.ndarray:
    """``_ring_kernel`` (client_tpu/parallel/kv_shard.py:96-108) hop by
    hop over the first axis of ``x``: each device's output starts as its
    own partial, and at every hop the buffer moves one device to the right
    and is added, one eager add (in x's dtype) per hop."""
    o = jnp.asarray(x)
    buf = o
    for _ in range(x.shape[0] - 1):
        buf = jnp.roll(buf, 1, axis=0)  # device i receives device i-1's
        o = o + buf
    return np.asarray(o)


def _hops(x: np.ndarray, flush: bool) -> np.ndarray:
    """The ring's hops in numpy: each hop's sum in fp32, rounded to x's
    dtype (for bf16 and fp16 the correctly rounded sum: fp32 holds at
    least 2p + 2 bits). ``flush``: as XLA's CPU backend runs, every fp32
    subnormal operand and result taken as a zero of its sign (DAZ and
    FTZ); fp16's subnormals are fp32 normals and stay."""
    def ftz(a):
        if not flush:
            return a
        tiny = np.finfo(np.float32).tiny
        return np.where(np.abs(a) < tiny, np.copysign(np.float32(0), a), a)

    with np.errstate(over="ignore", invalid="ignore"):
        f = ftz(x.astype(np.float32))
        o, buf = f, f
        for _ in range(x.shape[0] - 1):
            buf = np.roll(buf, 1, axis=0)
            o = ftz(ftz(o) + buf).astype(x.dtype).astype(np.float32)
    return o.astype(x.dtype)


def _plain(x: np.ndarray) -> list[torch.Tensor]:
    return ks.ring_all_reduce_plain([_torch(p) for p in x])


def _assert_same_bits(got, want, what: str) -> None:
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _check_against_jax(x: np.ndarray, want: np.ndarray) -> None:
    """The plain version against JAX's sums ``want`` of ``x``: the plain
    version is the IEEE ring bit for bit; JAX's CPU backend flushes fp32
    and bf16 subnormals (DAZ/FTZ), and is that flushed ring bit for bit;
    the two agree bit for bit at every element where no subnormal shows."""
    got = np.stack([_bits(g) for g in _plain(x)])
    ieee, ftz = _bits(_hops(x, False)), _bits(_hops(x, True))
    np.testing.assert_array_equal(got, ieee, err_msg="plain vs IEEE hops")
    np.testing.assert_array_equal(_bits(want), ftz,
                                  err_msg="JAX vs flushed hops")
    same = ieee == ftz
    np.testing.assert_array_equal(got[same], _bits(want)[same],
                                  err_msg="plain vs JAX")
    assert same.mean() > 0.9  # the difference is the subnormals' alone
    if x.dtype == np.float16:
        assert same.all()  # fp16's subnormals are fp32 normals


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_equals_jax_ring_on_adversarial_values(name, n):
    x = _adversarial(n, 192, name, seed=n)
    want = _jax_ring(x.reshape(n, 3, 64)).reshape(n, -1)
    _check_against_jax(x, want)
    # The re-enactment used above 8 shards is JAX's ring, bit for bit.
    np.testing.assert_array_equal(_bits(_jax_hops(x)), _bits(want))


@pytest.mark.parametrize("n", [9, 16, 64])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_plain_equals_jax_hops_on_adversarial_values(name, n):
    x = _adversarial(n, 256, name, seed=100 + n)
    assert all(g.dtype == DTYPES[name][1] for g in _plain(x[:2]))
    _check_against_jax(x, _jax_hops(x))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_adversarial_values_reach_every_edge(name):
    """The values hold what they are for: ties, subnormals, both zeros,
    overflow to +-inf and NaN (inf - inf) in the plain version's sums."""
    x = _adversarial(16, 512, name, seed=7)
    xf = x.astype(np.float32)
    fi = jnp.finfo(x.dtype)
    assert ((xf != 0) & (np.abs(xf) < float(fi.tiny))).any()
    assert (np.signbit(xf) & (xf == 0)).any() and \
        (~np.signbit(xf) & (xf == 0)).any()
    sums = np.stack([g.float().numpy() for g in _plain(x)])
    assert np.isposinf(sums).any() and np.isneginf(sums).any()
    assert np.isnan(sums).any()
    # Rounding each hop differs from one rounding of the exact sum.
    with np.errstate(invalid="ignore"):
        exact = xf.astype(np.float64).sum(0)
    finite = np.isfinite(exact) & np.isfinite(sums[0])
    assert (sums[0][finite] != exact[finite].astype(x.dtype)
            .astype(np.float32)).any()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_negative_zero_is_a_chains_start(name):
    """Each chain of the walk starts from -0.0 and adds its first partial
    like the rest: -0 + x is x, bits and all, for every x but NaN."""
    x = torch.cat([_torch(_adversarial(1, 4096, name, seed=3)[0]),
                   torch.tensor([0.0, -0.0, float("inf"), -float("inf")])
                   .to(DTYPES[name][1])])
    start = torch.full_like(x, -0.0)
    _assert_same_bits(start + x, x, "-0 + x")


# -- the kernel's schedule ------------------------------------------------------
# The constants and rules of client_tpu_torch/csrc/ring_all_reduce.cu.

LANES, MAX_WARPS, RING_BYTES, DIRECT_SHARDS = 32, 4, 48 * 1024, 16


def _chunk_rows(r: int) -> int:
    return 4 if r == 4 else 8


def _ahead_chunks(r: int) -> int:
    return 32 // _chunk_rows(r)


def _ring_rows(n: int, r: int, w: int, lane_bytes: int) -> int | None:
    """The shared-memory rows of a walk of R ``r`` and ``w`` warps: every
    row staged at once when that fits 48 KB, else a streaming ring (R >= 4
    only); None where the kernel does not run that walk."""
    c = _chunk_rows(r)
    chunks = -(-(n + r - 1) // c)
    whole = chunks * c + (w - 1) * r
    if whole * LANES * lane_bytes <= RING_BYTES:
        return whole
    return (_ahead_chunks(r) + 1) * c + (w - 1) * r if r >= 4 else None


def _walk_orders(n: int, r: int, w: int, block: int, ring: int) -> dict:
    """{shard: [the partials its chain adds, in order]} for one CTA of
    ``walk_kernel``: each warp stages its rows into ring slots in the
    kernel's order (row pointers read 32 rows ahead and handed out by
    lane), a batch of copies a chunk, ``_ahead_chunks`` batches ahead;
    every copy lands only when the kernel's wait and barrier say so, no
    slot is overwritten while a warp still needs it, and each warp reads
    its C rows a chunk from its own slots."""
    c, ahead = _chunk_rows(r), _ahead_chunks(r)
    s = w * r
    b0 = block * s
    rows, lead, steps = n + s - 1, (w - 1) * r, n + r - 1
    chunks = -(-steps // c)
    whole = ring >= rows
    slots = [None] * ring

    def pointers(k, i0):  # lane j's pointer: warp k's row i0 + j
        out = []
        for j in range(LANES):
            t = min(k + w * (i0 + j), rows - 1)
            out.append((b0 + s - 1 - t + n) % n)
        return out

    warps = [dict(i=0, slot=k, cur=pointers(k, 0), nxt=pointers(k, LANES))
             for k in range(w)]

    def stage(hi):  # one batch of copies: (slot, row, partial)
        batch, hi = [], min(hi, rows)
        for k, st in enumerate(warps):
            t = k + w * st["i"]
            while t < hi:
                j = st["i"] % LANES
                batch.append((st["slot"], t, st["cur"][j]))
                st["slot"] = (st["slot"] + w) % ring
                if j == LANES - 1:
                    st["cur"] = st["nxt"]
                    st["nxt"] = pointers(k, st["i"] + 1 + LANES)
                st["i"] += 1
                t += w
        return batch

    pending = []
    if whole:
        for slot, row, part in stage(rows):
            assert slots[slot] is None
            slots[slot] = (row, part)
    else:
        pending = [stage((j + 1) * c + lead) for j in range(ahead)]
    seq = [[] for _ in range(w)]  # warp k's partial at each step
    base = [(w - 1 - k) * r for k in range(w)]
    for ch in range(chunks):
        if not whole:
            while len(pending) > ahead - 1:  # cp.async.wait_group ahead - 1
                for slot, row, part in pending.pop(0):
                    slots[slot] = (row, part)
            # After the barrier: no warp reads chunk ch - 1 any more.
            batch = stage((ch + ahead + 1) * c + lead)
            in_flight = {slot for b in pending for slot, _, _ in b}
            for slot, _, _ in batch:
                old = slots[slot]
                assert old is None or old[0] < ch * c, (n, r, w, ch, old)
                assert slot not in in_flight
            pending.append(batch)
        t0 = ch * c
        for k in range(w):
            for u in range(c):
                slot, t = base[k] + u, t0 + u
                assert slot < ring
                if t <= n + r - 2:  # some chain adds at step t
                    got = slots[slot]
                    assert got is not None and got[0] == t + (w - 1 - k) * r
                    seq[k].append(got[1])
            base[k] = (base[k] + c) % ring
    # Chain q adds at steps r - 1 - q to n + r - 2 - q.
    return {b0 + k * r + q: seq[k][r - 1 - q:n + r - 1 - q]
            for k in range(w) for q in range(r) if b0 + k * r + q < n}


def _direct_orders(n: int, r: int, w: int, block: int) -> dict:
    """{shard: [partials in order]} for one CTA of ``direct_kernel``."""
    out = {}
    for k in range(w):
        i0 = r * (block * w + k)
        if i0 >= n:
            continue
        m, parts = (i0 + r - 1) % n, []
        for _ in range(n + r - 1):
            parts.append(m)
            m = n - 1 if m == 0 else m - 1
        for q in range(r):
            if i0 + q < n:
                out[i0 + q] = [parts[t] for t in range(n + r - 1)
                               if r - 1 - t <= q <= n + r - 2 - t]
    return out


def _walks(n: int):
    """Every (kind, R, W, lane bytes, ring rows) the kernel may launch for
    ``n`` shards, W as the kernel plans it for R."""
    if n <= DIRECT_SHARDS:
        yield "direct", 2, MAX_WARPS, 4, 0
        return
    for r in (2, 4, 8, 16):
        w = min(-(-n // r), MAX_WARPS)  # no more warps than the shards need
        for lane_bytes in (16, 8, 4, 2):
            ring = _ring_rows(n, r, w, lane_bytes)
            if ring is not None:
                yield "walk", r, w, lane_bytes, ring


def _sums_in_order(x: torch.Tensor, order: list[list[int]]) -> torch.Tensor:
    """Each chain's sum, from -0.0, adding ``x[order[i][0]]``,
    ``x[order[i][1]]``, ... in x's dtype (the chains side by side)."""
    idx = torch.tensor(order)
    s = torch.full((len(order), *x.shape[1:]), -0.0, dtype=x.dtype)
    for step in range(idx.shape[1]):
        s += x[idx[:, step]]
    return s


@pytest.mark.parametrize("n", [9, 10, 15, 16, 17, 31, 33, 64, 65, 255, 256,
                               257, 1024, 1816])
def test_every_walk_adds_in_ring_order(n):
    ring_order = [[(i - j) % n for j in range(n)] for i in range(n)]
    seen = set()
    for kind, r, w, lane_bytes, ring in _walks(n):
        key = (kind, r, w, ring)
        if key in seen:
            continue
        seen.add(key)
        got = {}
        for block in range(-(-n // (w * r))):
            orders = (_direct_orders(n, r, w, block) if kind == "direct"
                      else _walk_orders(n, r, w, block, ring))
            assert not set(orders) & set(got)
            got.update(orders)
        assert sorted(got) == list(range(n)), (kind, r, w)
        for i in range(n):
            assert got[i] == ring_order[i], (kind, r, w, ring, i)
    assert seen
    if n > 300:
        return  # the sums below take the plain version's n - 1 rolls
    # Sums in that order, each chain from -0.0, are the plain version's.
    for name in DTYPES:
        x = _adversarial(n, 24, name, seed=n)
        want = _plain(x)
        got = _sums_in_order(torch.stack([_torch(p) for p in x]),
                             ring_order)
        for i in range(n):
            _assert_same_bits(got[i], want[i], f"{name} shard {i}")
