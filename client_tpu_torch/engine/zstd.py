"""Zstandard frames (RFC 8878), read and written with numpy and the
standard library.

The JAX package's checkpoints store every array chunk and b-tree node as a
zstd frame (orbax over tensorstore), and the port reads them on machines
that have no ``zstandard`` module. :func:`decompress` reads:

- frames, one after another, skipping skippable frames;
- Raw, RLE and Compressed blocks;
- literals that are raw, RLE, Huffman-coded in 1 or 4 streams, or
  treeless (the previous block's Huffman table);
- Huffman tree descriptions with direct or FSE-compressed weights;
- sequences in predefined, RLE, FSE and repeat modes, with the three
  repeat offsets;
- the XXH64 content checksum, when the frame carries one.

Decoding runs in three passes over a frame. The first walks the blocks in
order: it parses each literals header and Huffman table, and decodes the
sequences (they depend on earlier tables and repeat offsets, never on
literals). The second decodes the Huffman streams of many blocks at once
with numpy (:func:`_huffman_batch`). The third copies literals and matches
into the output.

:func:`compress_raw` writes one frame of Raw blocks with the content size
set: valid zstd that any decoder reads, without compression.
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE = 0x184D2A50
BLOCK_MAX = 128 * 1024          # Block_Maximum_Size
_HUF_LOG_MAX = 11               # Huffman codes are at most 11 bits
_HUF_BATCH_BITS = 1 << 21       # Huffman stream bits decoded per batch
_SEGMENT = 512                  # bits per lockstep segment


class ZstdError(ValueError):
    """The input is not a well-formed zstd frame."""


# -- XXH64 ------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0: the hash a zstd content checksum
    keeps the low 32 bits of."""
    n = len(data)
    mv = memoryview(data)
    i = 0
    if n >= 32:
        v1, v2, v3, v4 = (_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(mv[:stripes * 32], "<u8").tolist()
        for j in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for lane in (v1, v2, v3, v4):
            h = ((h ^ _round(0, lane)) * _P1 + _P4) & _M64
        i = stripes * 32
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        k = _round(0, int.from_bytes(mv[i:i + 8], "little"))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(mv[i:i + 4], "little") * _P1 & _M64),
                   23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (mv[i] * _P5 & _M64), 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# -- bit streams -------------------------------------------------------------

class _ForwardBits:
    """Little-endian bits read from the low end up (FSE table headers)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.start, self.pos = data, start, 0

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def peek(self, n: int) -> int:
        lo = self.start * 8 + self.pos
        chunk = self.data[lo >> 3:(lo + n + 7) >> 3]
        return (int.from_bytes(chunk, "little") >> (lo & 7)) & ((1 << n) - 1)

    def end(self) -> int:
        """Byte offset just past the bits read."""
        return self.start + (self.pos + 7) // 8


class _BackwardBits:
    """A zstd backward bit stream: bits read from the last byte's marker
    down to the first byte, each read's first bit its most significant.
    Bits below the stream read as zeros; ``pos`` goes negative then."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without an end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        hi, lo = self.pos, self.pos - n
        self.pos = lo
        if hi <= 0:
            return 0
        base = max(lo, 0)
        chunk = self.data[base >> 3:(hi + 7) >> 3]
        v = (int.from_bytes(chunk, "little") >> (base & 7)) & (
            (1 << (hi - base)) - 1)
        return v << (base - lo)


# -- FSE ---------------------------------------------------------------------

def _read_ncount(data: bytes, start: int, max_symbol: int, max_log: int
                 ) -> tuple[list[int], int, int]:
    """An FSE table description: (normalized counts, accuracy log, byte
    offset after it)."""
    bits = _ForwardBits(data, start)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        maxv = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < maxv:
            value = low
            bits.pos += nbits - 1
        else:
            value = bits.peek(nbits)
            if value >= threshold:
                value -= maxv
            bits.pos += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, bits.end()


def _fse_table(counts: list[int], log: int) -> tuple[list, list, list]:
    """Decoding table of normalized ``counts``: per state, (symbol,
    bits to read, base of the next state)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupt FSE distribution")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        nbits[u] = nb
        base[u] = (state << nb) - size
    return symbols, nbits, base


def _rle_table(symbol: int) -> tuple[list, list, list]:
    return [symbol], [0], [0]


_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67,
                                         83, 99, 131, 259, 515, 1027, 2051,
                                         4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]

# (max symbol, max accuracy log, predefined table) per sequence field
_SEQ_FIELDS = {
    "ll": (35, 9, _fse_table(*_LL_DEFAULT)),
    "of": (31, 8, _fse_table(*_OF_DEFAULT)),
    "ml": (52, 9, _fse_table(*_ML_DEFAULT)),
}


# -- Huffman -----------------------------------------------------------------

class _Huffman:
    """A literals decoding table, widened to 11-bit lookups: ``sym[v]`` and
    ``nbits[v]`` for the next 11 bits ``v`` of a stream."""

    def __init__(self, weights: list[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        log = total.bit_length()
        rest = (1 << log) - total
        if rest & (rest - 1) or log > _HUF_LOG_MAX:
            raise ZstdError("corrupt Huffman weights")
        weights = weights + [rest.bit_length()]
        sym = np.zeros(1 << log, np.uint8)
        nbits = np.zeros(1 << log, np.uint8)
        pos = 0
        for w in range(1, log + 1):
            span = 1 << (w - 1)
            for s, ws in enumerate(weights):
                if ws == w:
                    sym[pos:pos + span] = s
                    nbits[pos:pos + span] = log + 1 - w
                    pos += span
        widen = 1 << (_HUF_LOG_MAX - log)
        self.sym = np.repeat(sym, widen)
        self.nbits = np.repeat(nbits, widen)


def _huffman_weights(data: bytes, start: int) -> tuple[list[int], int]:
    """A Huffman tree description: (weights of every symbol but the last,
    byte offset after it)."""
    head = data[start]
    if head >= 128:
        n = head - 127
        raw = data[start + 1:start + 1 + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], start + 1 + (n + 1) // 2
    end = start + 1 + head
    counts, log, p = _read_ncount(data, start + 1, 255, 6)
    symbols, nbits, base = _fse_table(counts, log)
    bits = _BackwardBits(data[p:end])
    s1, s2 = bits.read(log), bits.read(log)
    weights: list[int] = []
    while True:
        weights.append(symbols[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(symbols[s2])
            break
        weights.append(symbols[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(symbols[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return weights, end


def _huffman_batch(streams: list[tuple[bytes, int, _Huffman]]
                   ) -> list[np.ndarray]:
    """Decode Huffman streams ``(bytes, symbol count, table)`` at once.

    Each stream is cut into segments of ``_SEGMENT`` bits, and every
    segment is decoded from its top bit at once (numpy lockstep over all
    segments), as if a code started there. That guess is right for a
    stream's first segment; elsewhere the true path enters a few bits
    lower, where the previous segment's decode left it, and a prefix code
    falls back in step with the guessed path within a few codes. A second
    lockstep walk from each true entry repairs the codes up to the first
    position both paths share; a segment whose repair reaches its end
    without meeting the guess hands its exit on to the next segment, and
    the repairs repeat until nothing changes. A stream must end exactly
    on its first bit."""
    pad = 2  # zero bytes below each stream: 11-bit reads stay inside
    parts, bases, starts, tids = [], [], [], []
    tables: list[_Huffman] = []
    offset = 0
    for data, _n, table in streams:
        if not data or data[-1] == 0:
            raise ZstdError("Huffman stream without an end marker")
        parts += [b"\0" * pad, data]
        offset += pad
        bases.append(8 * offset)
        starts.append(8 * (offset + len(data) - 1) + data[-1].bit_length() - 1)
        if not tables or tables[-1] is not table:
            tables.append(table)
        tids.append((len(tables) - 1) << _HUF_LOG_MAX)
        offset += len(data)
    parts.append(b"\0" * 4)
    buf = np.frombuffer(b"".join(parts), np.uint8).astype(np.uint32)
    win = buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16) | (buf[3:] << 24)
    all_sym = np.concatenate([t.sym for t in tables])
    all_len = np.concatenate([t.nbits for t in tables]).astype(np.int64)

    def lookup(pos, tbase, table):
        q = pos - _HUF_LOG_MAX
        v = (win[q >> 3] >> (q & 7).astype(np.uint32)) & 0x7FF
        return table[tbase + v]

    # Segments, stream by stream from each stream's top bit down.
    his, los, seg_tb, first = [], [], [], []
    for base, start, tb in zip(bases, starts, tids):
        hi = np.arange(start, base, -_SEGMENT, dtype=np.int64)
        his.append(hi)
        los.append(np.maximum(hi - _SEGMENT, base))
        seg_tb.append(np.full(len(hi), tb, np.int64))
        first.append(len(hi))
    hi, lo, tb = (np.concatenate(a) if a else np.zeros(0, np.int64)
                  for a in (his, los, seg_tb))
    n_seg = len(hi)
    firsts = np.cumsum([0] + first[:-1])
    is_first = np.zeros(n_seg, bool)
    is_first[firsts[np.asarray(first) > 0]] = True

    def walk(cur, lo_, tb_, stop=None):
        """Lockstep decode from ``cur`` while above ``lo_`` (and, with
        ``stop``, until a position marked there): (positions per step,
        exits)."""
        rows = []
        cur = cur.copy()
        live = cur > lo_
        if stop is not None:
            live &= ~stop[np.where(live, cur, 0)]
        while live.any():
            rows.append(np.where(live, cur, -1))
            cur = np.where(live, cur - lookup(cur, tb_, all_len), cur)
            live = cur > lo_
            if stop is not None:
                live &= ~stop[np.where(live, cur, 0)]
        return (np.stack(rows) if rows
                else np.full((0, len(cur)), -1, np.int64)), cur

    guess, guess_exit = walk(hi, lo, tb)
    exit_ = guess_exit.copy()
    on_guess = np.zeros(8 * len(buf), bool)
    on_guess[guess[guess >= 0]] = True
    # Repairs: entry = the true exit of the segment before.
    entry = hi.copy()
    entry[~is_first] = guess_exit[np.flatnonzero(~is_first) - 1]
    rep_cols = np.zeros((0, n_seg), np.int64)
    keep_from = np.zeros(n_seg, np.int64)   # first guessed row kept
    todo = np.flatnonzero(entry != hi)
    while len(todo):
        rows, out = walk(entry[todo], lo[todo], tb[todo], on_guess)
        if len(rows) > len(rep_cols):
            rep_cols = np.vstack([rep_cols, np.full(
                (len(rows) - len(rep_cols), n_seg), -1, np.int64)])
        rep_cols[:, todo] = -1
        rep_cols[:len(rows), todo] = rows
        synced = out > lo[todo]
        # Rows of the guess at or below the meeting point stay.
        col = guess[:, todo]
        keep_from[todo] = np.where(
            synced, (col > out[None, :]).sum(0), (col >= 0).sum(0))
        new_exit = np.where(synced, guess_exit[todo], out)
        nxt = todo[new_exit != exit_[todo]] + 1
        exit_[todo] = new_exit
        todo = nxt[(nxt < n_seg) & ~is_first[np.minimum(nxt, n_seg - 1)]]
        entry[todo] = exit_[todo - 1]
    kept = np.where(np.arange(len(guess))[:, None] >= keep_from[None, :],
                    guess, -1)
    flat = np.vstack([rep_cols, kept]).T.ravel()
    per_seg = (rep_cols >= 0).sum(0) + (kept >= 0).sum(0)
    path = flat[flat >= 0]
    out, p0 = [], 0
    for s, (data, n, _t) in enumerate(streams):
        segs = slice(firsts[s], firsts[s] + first[s])
        got = int(per_seg[segs].sum())
        end = exit_[firsts[s] + first[s] - 1] if first[s] else starts[s]
        if got != n or end != bases[s]:
            raise ZstdError("Huffman stream does not decode to its size")
        pos = path[p0:p0 + n]
        out.append(lookup(pos, tids[s], all_sym))
        p0 += n
    return out


# -- blocks ------------------------------------------------------------------

class _FrameState:
    """What carries from block to block within a frame."""

    def __init__(self):
        self.huffman: _Huffman | None = None
        self.tables = {f: None for f in _SEQ_FIELDS}
        self.reps = [1, 4, 8]


def _literals(block: bytes, st: _FrameState):
    """Parse a literals section: (literals, or a pending Huffman job
    ``[(stream bytes, symbol count)]`` with its table, offset after)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw / RLE
        if fmt in (0, 2):
            size, p = b0 >> 3, 1
        elif fmt == 1:
            size, p = (b0 >> 4) | (block[1] << 4), 2
        else:
            size, p = (b0 >> 4) | (block[1] << 4) | (block[2] << 12), 3
        if kind == 0:
            if p + size > len(block):
                raise ZstdError("raw literals run past the block")
            return block[p:p + size], None, p + size
        return bytes([block[p]]) * size, None, p + 1
    hsize = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    head = int.from_bytes(block[:hsize], "little")
    width = {3: 10, 4: 14, 5: 18}[hsize]
    regen = (head >> 4) & ((1 << width) - 1)
    csize = (head >> (4 + width)) & ((1 << width) - 1)
    end = hsize + csize
    if end > len(block):
        raise ZstdError("compressed literals run past the block")
    p = hsize
    if kind == 2:
        weights, p = _huffman_weights(block, p)
        st.huffman = _Huffman(weights)
    elif st.huffman is None:
        raise ZstdError("treeless literals without an earlier table")
    if fmt == 0:
        return None, ([(block[p:end], regen)], st.huffman), end
    s1, s2, s3 = (int.from_bytes(block[p + 2 * i:p + 2 * i + 2], "little")
                  for i in range(3))
    p += 6
    seg = (regen + 3) // 4
    sizes = [s1, s2, s3, end - p - s1 - s2 - s3]
    ns = [seg, seg, seg, regen - 3 * seg]
    if sizes[3] < 0 or ns[3] < 0:
        raise ZstdError("corrupt Huffman jump table")
    jobs = []
    for size, n in zip(sizes, ns):
        jobs.append((block[p:p + size], n))
        p += size
    return None, (jobs, st.huffman), end


def _seq_table(field: str, mode: int, block: bytes, p: int,
               st: _FrameState) -> int:
    max_sym, max_log, predefined = _SEQ_FIELDS[field]
    if mode == 0:
        st.tables[field] = predefined
    elif mode == 1:
        st.tables[field] = _rle_table(block[p])
        p += 1
    elif mode == 2:
        counts, log, p = _read_ncount(block, p, max_sym, max_log)
        st.tables[field] = _fse_table(counts, log)
    elif st.tables[field] is None:
        raise ZstdError(f"repeat mode for {field} without an earlier table")
    return p


def _offset(offv: int, ll: int, reps: list[int]) -> tuple[int, list[int]]:
    """A sequence's match offset from its ``Offset_Value`` and the three
    repeat offsets, with the repeat offsets after it. Values 1-3 name a
    repeat offset, shifted by one when the literal length is 0 (then 3
    means the first repeat offset minus one)."""
    if offv > 3:
        off = offv - 3
        return off, [off, reps[0], reps[1]]
    idx = offv if ll else offv + 1
    if idx == 1:
        return reps[0], reps
    if idx == 2:
        return reps[1], [reps[1], reps[0], reps[2]]
    off = reps[2] if idx == 3 else reps[0] - 1
    return off, [off, reps[0], reps[1]]


def _sequences(block: bytes, p: int, st: _FrameState) -> list:
    """Decode a sequences section into (literal length, match length,
    offset) triples."""
    if p >= len(block):
        raise ZstdError("block ends before its sequences section")
    b0 = block[p]
    if b0 == 0:
        return []
    if b0 < 128:
        n, p = b0, p + 1
    elif b0 < 255:
        n, p = ((b0 - 128) << 8) + block[p + 1], p + 2
    else:
        n, p = block[p + 1] + (block[p + 2] << 8) + 0x7F00, p + 3
    modes = block[p]
    p += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    p = _seq_table("ll", modes >> 6, block, p, st)
    p = _seq_table("of", (modes >> 4) & 3, block, p, st)
    p = _seq_table("ml", (modes >> 2) & 3, block, p, st)
    ll_sym, ll_nb, ll_base = st.tables["ll"]
    of_sym, of_nb, of_base = st.tables["of"]
    ml_sym, ml_nb, ml_base = st.tables["ml"]
    bits = _BackwardBits(block[p:])
    read = bits.read
    ll_s = read(len(ll_sym).bit_length() - 1)
    of_s = read(len(of_sym).bit_length() - 1)
    ml_s = read(len(ml_sym).bit_length() - 1)
    reps = st.reps
    out = []
    for i in range(n):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("sequence code out of range")
        offv = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        off, reps = _offset(offv, ll, reps)
        out.append((ll, ml, off))
        if i + 1 < n:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if bits.pos != 0:
        raise ZstdError("sequences bit stream not consumed exactly")
    st.reps = reps
    return out


def _execute(out: bytearray, lits: bytes, seqs: list) -> None:
    """Append a block's literals and matches to ``out``."""
    lp = 0
    for ll, ml, off in seqs:
        if ll:
            if lp + ll > len(lits):
                raise ZstdError("sequences use more literals than the "
                                "block has")
            out += lits[lp:lp + ll]
            lp += ll
        if off <= 0 or off > len(out):
            raise ZstdError("match offset reaches before the frame")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
    out += lits[lp:]


# -- frames ------------------------------------------------------------------

def _frame(data: memoryview, p: int) -> tuple[bytearray, int]:
    """Decode the frame at ``p`` (magic already checked): (content,
    offset after the frame)."""
    fhd = data[p + 4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    p += 5
    if not single:
        exp = (data[p] >> 3) + 10
        window = (1 << exp) + ((1 << exp) >> 3) * (data[p] & 7)
        p += 1
    if dict_flag:
        size = (0, 1, 2, 4)[dict_flag]
        if int.from_bytes(data[p:p + size], "little"):
            raise ZstdError("frames with a dictionary are not supported")
        p += size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        p += fcs_size
    if single:
        window = content_size
    block_max = min(window, BLOCK_MAX)
    st = _FrameState()
    # Pass 1: blocks in order; Huffman literals are left as jobs.
    plan = []
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        head = int.from_bytes(data[p:p + 3], "little")
        last, btype, bsize = head & 1, (head >> 1) & 3, head >> 3
        p += 3
        if btype == 3:
            raise ZstdError("reserved block type")
        if btype == 1:
            if bsize > block_max:
                raise ZstdError("block larger than Block_Maximum_Size")
            plan.append((bytes([data[p]]) * bsize, None, None))
            p += 1
        else:
            if bsize > block_max or p + bsize > len(data):
                raise ZstdError("block larger than its frame or maximum")
            body = data[p:p + bsize]
            p += bsize
            if btype == 0:
                plan.append((body, None, None))
            else:
                lits, job, q = _literals(body, st)
                plan.append((lits, job, _sequences(body, q, st)))
        if last:
            break
    # Pass 2: Huffman streams, batched.
    jobs = [(i, j) for i, (_l, j, _s) in enumerate(plan) if j is not None]
    decoded: dict[int, bytes] = {}
    batch, bits = [], 0
    for n, (i, (streams, table)) in enumerate(jobs):
        batch.append((i, streams, table))
        bits += sum(8 * len(s) for s, _ in streams)
        if bits >= _HUF_BATCH_BITS or n == len(jobs) - 1:
            flat = [(s, cnt, t) for _i, ss, t in batch for s, cnt in ss]
            res = iter(_huffman_batch(flat))
            for i2, ss, _t in batch:
                decoded[i2] = b"".join(next(res).tobytes() for _ in ss)
            batch, bits = [], 0
    # Pass 3: literals and matches.
    out = bytearray()
    for i, (lits, _job, seqs) in enumerate(plan):
        if lits is None:
            lits = decoded[i]
        if seqs is None:
            out += lits
        else:
            _execute(out, lits, seqs)
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame content is {len(out)} bytes, header says "
                        f"{content_size}")
    if checksum:
        want = int.from_bytes(data[p:p + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        p += 4
    return out, p


def decompress(data) -> bytearray:
    """The content of every zstd frame in ``data`` (bytes-like), in order;
    skippable frames are skipped."""
    data = memoryview(data).cast("B")
    out = []
    p = 0
    while p < len(data):
        if p + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic & _SKIPPABLE_MASK == _SKIPPABLE:
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad zstd magic {magic:#010x}")
        content, p = _frame(data, p)
        out.append(content)
    if p != len(data):
        raise ZstdError("skippable frame runs past the input")
    return out[0] if len(out) == 1 else bytearray(b"".join(out))


def compress_raw(data) -> bytes:
    """One zstd frame holding ``data`` in Raw blocks of at most 128 KiB,
    with ``Single_Segment`` and the content size set."""
    mv = memoryview(data).cast("B")
    n = len(mv)
    if n < 256:
        fcs = bytes([0x20]) + n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fcs = bytes([0x60]) + (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fcs = bytes([0xA0]) + n.to_bytes(4, "little")
    else:
        fcs = bytes([0xE0]) + n.to_bytes(8, "little")
    parts = [MAGIC.to_bytes(4, "little"), fcs]
    p = 0
    while True:
        size = min(BLOCK_MAX, n - p)
        last = p + size == n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(mv[p:p + size])
        p += size
        if last:
            break
    return b"".join(parts)
