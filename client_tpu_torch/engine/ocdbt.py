"""OCDBT key-value stores, the on-disk format tensorstore's ``ocdbt``
kvstore keeps and orbax writes checkpoints through, read and written with
numpy and the standard library.

A store is a directory. Its ``manifest.ocdbt`` names the versions of one
b-tree; each version's root is a node at ``(file, offset, length)``.
Manifest and node files share one frame:

- a 14-byte header: a big-endian magic (``0x0cdb3a2a`` manifest,
  ``0x0cdb20de`` b-tree node), the file's length (uint64 LE), the format
  version (varint 0) and the body's compression (varint: 0 none, 1 zstd);
- the body;
- a CRC-32C of everything before it (uint32 LE).

Bodies use LEB128 varints and column-major arrays. A node is interior
(children with their key ranges) or a leaf (keys and values). Keys are
prefix-compressed against the previous key, and an interior entry's
``subtree_common_prefix_length`` bytes are dropped from every key below it.
A value is inline or an indirect ``(data file, offset, length)``. Data
files are named in a table of ``(base path, relative path)`` pairs: a path
resolves against the base path of the file that holds the node naming it,
so a checkpoint's top-level tree can point into ``ocdbt.process_0/d/``.

:func:`write_store` writes one version of a single-leaf tree under one
manifest, large values packed into one data file.
"""

from __future__ import annotations

import os
import time
import uuid

import numpy as np

from client_tpu_torch.engine import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 14
MAX_INLINE_VALUE_BYTES = 1024       # orbax's setting
_MAX_DECODED_NODE_BYTES = 100_000_000


class OcdbtError(ValueError):
    """A store file that is not well formed."""


# -- CRC-32C -----------------------------------------------------------------

def _crc_table() -> list[int]:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t.astype(np.uint32).tolist()


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT footer holds it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- varints and the file frame --------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.p = data, 0

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.p >= len(self.data):
                raise OcdbtError("truncated varint")
            b = self.data[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            raise OcdbtError("truncated body")
        out = self.data[self.p:self.p + n]
        self.p += n
        return out

    def u8s(self, n: int) -> list[int]:
        return list(self.take(n))


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, header and CRC checked."""
    if len(data) < _HEADER + 4:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what}: header says {length} bytes, file has "
                         f"{len(data)}")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[12:-4])
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[12 + r.p:-4]
    if compression == 1:
        return bytes(zstd.decompress(body))
    if compression != 0:
        raise OcdbtError(f"{what}: unknown compression {compression}")
    return body


def frame(body: bytes, magic: int) -> bytes:
    """A manifest or node file around an uncompressed ``body``."""
    head = magic.to_bytes(4, "big")
    rest = _varint(0) + _varint(0) + body
    data = head + (4 + 8 + len(rest) + 4).to_bytes(8, "little") + rest
    return data + crc32c(data).to_bytes(4, "little")


# -- data file tables --------------------------------------------------------

def _read_files(r: _Reader) -> list[tuple[str, str]]:
    """A data file table: ``(base path, full path)`` per file."""
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        full = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        if base[i] > len(full):
            raise OcdbtError("data file base path longer than its path")
        files.append((full[:base[i]].decode(), full.decode()))
        prev = full
    return files


def _write_files(paths: list[str]) -> bytes:
    """A data file table of paths with empty base paths (no prefix
    sharing)."""
    enc = [p.encode() for p in paths]
    return (_varint(len(enc)) + _varints([0] * max(len(enc) - 1, 0))
            + _varints(len(e) for e in enc) + _varints([0] * len(enc))
            + b"".join(enc))


def _keys(r: _Reader, n: int, common: bool) -> tuple[list[bytes], list[int]]:
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    sub = r.varints(n) if common else []
    keys, prev = [], b""
    for i in range(n):
        key = (prev[:prefix[i - 1]] if i else b"") + r.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, sub


# -- reading -----------------------------------------------------------------

class Store:
    """A read-only view of the latest version of the store at ``root``:
    ``keys()`` and ``read(key)``."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = unframe(f.read(), MANIFEST_MAGIC, path)
        r = _Reader(body)
        r.take(16)                               # uuid
        if r.varint() != 0:
            raise OcdbtError(f"{path}: only single-file manifests are read")
        r.varint()                               # max_inline_value_bytes
        r.varint()                               # max_decoded_node_bytes
        r.take(1)                                # version_tree_arity_log2
        if r.varint() == 1:                      # compression: zstd + level
            r.take(4)
        files = _read_files(r)
        n = r.varint()
        gens = r.varints(n)
        heights = r.u8s(n)
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        if not n:
            raise OcdbtError(f"{path}: no version")
        i = gens.index(max(gens))
        # Every key in order: value (inline bytes) or (path, offset, length).
        self._values: dict[bytes, object] = {}
        self._node("", files, fids[i], offs[i], lens[i], heights[i], b"")

    def _node(self, base: str, files, fid: int, off: int, length: int,
              height: int, prefix: bytes) -> None:
        if fid >= len(files):
            raise OcdbtError("node reference past its data file table")
        fbase, fpath = files[fid]
        path = os.path.join(self.root, base + fpath)
        with open(path, "rb") as f:
            f.seek(off)
            data = f.read(length)
        body = unframe(data, NODE_MAGIC, path)
        r = _Reader(body)
        if r.u8s(1)[0] != height:
            raise OcdbtError(f"{path}: node height does not match its parent")
        child_base = base + fbase
        node_files = _read_files(r)
        n = r.varint()
        if height:
            keys, common = _keys(r, n, True)
            cfid, coff, clen = r.varints(n), r.varints(n), r.varints(n)
            for i, key in enumerate(keys):
                self._node(child_base, node_files, cfid[i], coff[i], clen[i],
                           height - 1, prefix + key[:common[i]])
            return
        keys, _ = _keys(r, n, False)
        vlen = r.varints(n)
        kinds = r.u8s(n)
        n_ind = sum(1 for k in kinds if k == 1)
        vfid, voff = r.varints(n_ind), r.varints(n_ind)
        ind = 0
        for key, size, kind in zip(keys, vlen, kinds):
            if kind == 0:
                self._values[prefix + key] = r.take(size)
            elif kind == 1:
                if vfid[ind] >= len(node_files):
                    raise OcdbtError("value reference past its file table")
                vbase, vpath = node_files[vfid[ind]]
                self._values[prefix + key] = (
                    os.path.join(self.root, child_base + vpath), voff[ind],
                    size)
                ind += 1
            else:
                raise OcdbtError(f"{path}: value kind {kind}")

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        v = self._values[key.encode()]
        if isinstance(v, bytes):
            return v
        path, off, size = v
        with open(path, "rb") as f:
            f.seek(off)
            data = f.read(size)
        if len(data) != size:
            raise OcdbtError(f"{path}: value at {off} runs past the file")
        return data


# -- writing -----------------------------------------------------------------

def write_store(root: str, items: dict[str, bytes]) -> None:
    """Write ``items`` as a new store at ``root`` (created): one leaf node,
    values above ``MAX_INLINE_VALUE_BYTES`` packed into one data file, one
    version under a single-file manifest."""
    os.makedirs(os.path.join(root, "d"), exist_ok=False)
    keys = sorted((k.encode(), k) for k in items)
    data_name = f"d/{uuid.uuid4().hex}"
    node_name = f"d/{uuid.uuid4().hex}"
    inline, kinds, lens, offs = [], [], [], []
    indirect = 0
    with open(os.path.join(root, data_name), "wb") as f:
        for _kb, k in keys:
            v = items[k]
            lens.append(len(v))
            if len(v) > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offs.append(indirect)
                f.write(v)
                indirect += len(v)
            else:
                kinds.append(0)
                inline.append(v)
    prefix, suffix = [], []
    prev = b""
    for i, (kb, _k) in enumerate(keys):
        common = os.path.commonprefix([prev, kb]) if i else b""
        if i:
            prefix.append(len(common))
        suffix.append(kb[len(common):])
        prev = kb
    n_ind = len(offs)
    body = (bytes([0]) + _write_files([data_name]) + _varint(len(keys))
            + _varints(prefix) + _varints(len(s) for s in suffix)
            + b"".join(suffix) + _varints(lens) + bytes(kinds)
            + _varints([0] * n_ind) + _varints(offs) + b"".join(inline))
    node = frame(body, NODE_MAGIC)
    with open(os.path.join(root, node_name), "wb") as f:
        f.write(node)
    manifest = (
        uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
        + _varint(_MAX_DECODED_NODE_BYTES) + bytes([4]) + _varint(0)
        + _write_files([node_name]) + _varint(1)   # one version
        + _varint(1) + bytes([0])                  # generation, height 0
        + _varint(0) + _varint(0) + _varint(len(node))
        + _varint(len(keys)) + _varint(len(node)) + _varint(indirect)
        + time.time_ns().to_bytes(8, "little")
        + _varint(0))                              # no version tree nodes
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(frame(manifest, MANIFEST_MAGIC))
