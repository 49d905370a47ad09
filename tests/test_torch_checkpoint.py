"""The port's checkpoints against the JAX package's, on the CPU.

- ``engine/zstd.py`` decodes what ``zstandard`` (a test-only dependency)
  writes, byte for byte: levels 1, 3, 9 and 19 over a corpus whose frames
  hold every block, literals, Huffman-weight and sequence mode and every
  repeat-offset case (``test_corpus_exercises_every_decoder_path`` checks
  that), checksummed frames, frames without a content size, skippable
  frames; ``compress_raw`` frames read back by ``zstandard``.
- ``engine/ocdbt.py`` reads a multi-level tree tensorstore writes, and
  tensorstore reads the single-leaf tree the port writes.
- ``engine/checkpoint.py`` against ``client_tpu.engine.checkpoint``: the
  port restores what JAX's ``save_params`` writes, and JAX's
  ``load_params`` restores what the port writes, bit for bit, for BERT
  (bf16), the GPT (fp32), ResNet, DenseNet and the SSD; every family's
  ``params_to_jax`` gives back the JAX tree it was loaded from; a missing
  checkpoint and each mismatch (a missing key, an extra key, a wrong
  shape, a wrong dtype) answer as JAX's ``load_params`` does: 400 with
  its words, or a cast; models restored from one checkpoint answer as the
  JAX backends restored from it (BERT within 2e-2, greedy tokens token
  for token, ResNet/DenseNet within 1e-2 of the logits' scale, the SSD's
  top score within 2e-2, as in their own parity tests).
- The committed JAX-written fixture ``tests/torch_data/jax_gpt_ckpt``:
  ``expect.json`` against JAX's own restore and engine, and the port's
  restore and engine against ``expect.json``.
"""

import hashlib
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from client_tpu.engine import InferRequest as JaxRequest
from client_tpu.engine import TpuEngine
from client_tpu.engine import checkpoint as jax_ckpt
from client_tpu.engine.repository import ModelRepository as JaxRepository
from client_tpu.models import bert as jax_bert
from client_tpu.models import generate as jax_gpt
from client_tpu.models import ssd as jax_ssd
from client_tpu.models import vision as jax_vision
from client_tpu_torch.engine import EngineError, InferRequest, TorchEngine
from client_tpu_torch.engine import checkpoint, ocdbt, zstd
from client_tpu_torch.engine.model import restoring
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.models import bert as torch_bert
from client_tpu_torch.models import generate as torch_gpt
from client_tpu_torch.models import ssd as torch_ssd
from client_tpu_torch.models import vision as torch_vision

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_data", "jax_gpt_ckpt")
LEVELS = (1, 3, 9, 19)


# -- zstd ---------------------------------------------------------------------

def _corpus() -> dict[str, bytes]:
    """Inputs whose frames, over ``LEVELS``, reach every decoder path."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(150_000).astype(np.float32)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[i] for i in rng.integers(0, 300, 20_000))
    shifted = bytearray(rng.bytes(2000))  # matches at the last offset - 1
    off = 500
    for _ in range(3000):
        for _ in range(int(rng.integers(4, 40))):
            shifted.append(shifted[-off])
        off = off - 1 if rng.random() < 0.5 else int(rng.integers(100, 1900))
        if rng.random() < 0.3:
            shifted += rng.bytes(int(rng.integers(1, 4)))
    runs = b"".join(b"\x07" * int(rng.integers(1, 5)) + b"abcdefgh" * 3
                    for _ in range(20_000))
    return {
        "empty": b"",
        "byte": b"a",
        "bf16": (w.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "f32": w[:60_000].tobytes(),
        "ints": np.arange(100_000, dtype=np.int32).tobytes(),
        "zeros": bytes(300_000),
        "random": rng.bytes(200_000),
        "text": text,
        "shifted": bytes(shifted),
        "runs": runs,
        "treeless": text + b"".join(text[i:i + 3000] + b"xyz"
                                    for i in range(0, 60_000, 4000)),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_decoder_equals_zstandard(name, level):
    data = CORPUS[name]
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame) == data


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_checksummed_frames(name):
    data = CORPUS[name]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    assert frame[4] & 4  # Content_Checksum_flag
    assert zstd.decompress(frame) == data


def test_a_wrong_checksum_is_refused():
    data = CORPUS["random"]
    frame = bytearray(zstandard.ZstdCompressor(
        level=1, write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("name", ["text", "bf16", "zeros"])
def test_frames_without_a_content_size(name):
    data = CORPUS[name]
    cobj = zstandard.ZstdCompressor(level=3).compressobj()
    frame = cobj.compress(data) + cobj.flush()
    assert not frame[4] & 0xE0  # no content size, a window descriptor
    assert zstd.decompress(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = CORPUS["text"], CORPUS["ints"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
    data = (skip + b"12345" + zstandard.ZstdCompressor(level=1).compress(a)
            + zstandard.ZstdCompressor(level=9).compress(b) + skip + b"abcde")
    assert zstd.decompress(data) == a + b


@pytest.mark.parametrize("bad", ["magic", "reserved", "truncated"])
def test_malformed_frames_are_refused(bad):
    frame = bytearray(zstandard.ZstdCompressor(level=3).compress(
        CORPUS["text"]))
    if bad == "magic":
        frame[0] ^= 0xFF
    elif bad == "reserved":
        frame[4] |= 8
    else:
        frame = frame[:len(frame) // 2]
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame))


def test_corpus_exercises_every_decoder_path(monkeypatch):
    """Every block type, literals mode (1- and 4-stream Huffman, treeless
    in both), Huffman weight coding, sequence table mode per field and
    repeat-offset case is met by ``test_decoder_equals_zstandard``."""
    seen = set()
    wrap = {
        "_literals": lambda f: lambda block, st: (
            seen.add(("literals", block[0] & 3,
                      (block[0] >> 2) & 3 == 0 and block[0] & 2 > 0)),
            f(block, st))[1],
        "_huffman_weights": lambda f: lambda data, p: (
            seen.add(("weights", data[p] >= 128)), f(data, p))[1],
        "_seq_table": lambda f: lambda field, mode, block, p, st: (
            seen.add(("table", field, mode)), f(field, mode, block, p, st))[1],
        "_offset": lambda f: lambda offv, ll, reps: (
            seen.add(("offset", min(offv, 4), ll == 0)), f(offv, ll, reps))[1],
    }
    for name, make in wrap.items():
        monkeypatch.setattr(zstd, name, make(getattr(zstd, name)))
    for data in CORPUS.values():
        for level in LEVELS:
            frame = zstandard.ZstdCompressor(level=level).compress(data)
            p = 6 if frame[4] & 0x20 == 0 else 5
            p += (0, 2, 4, 8)[frame[4] >> 6] or (1 if frame[4] & 0x20 else 0)
            while True:  # block types, from the block headers
                head = int.from_bytes(frame[p:p + 3], "little")
                seen.add(("block", (head >> 1) & 3))
                p += 3 + (1 if (head >> 1) & 3 == 1 else head >> 3)
                if head & 1:
                    break
            assert zstd.decompress(frame) == data
    want = ({("block", t) for t in (0, 1, 2)}
            | {("literals", k, one) for k in (2, 3) for one in (True, False)}
            | {("literals", 0, False), ("literals", 1, False)}
            | {("weights", direct) for direct in (True, False)}
            | {("table", f, m) for f in ("ll", "of", "ml") for m in range(4)}
            | {("offset", v, z) for v in (1, 2, 3, 4) for z in (True, False)
               if v < 4 or not z})
    assert want <= seen, sorted(want - seen)


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792, 131_072,
                                  131_073, 300_000])
def test_raw_writer_is_read_by_zstandard(size):
    data = np.random.default_rng(size).bytes(size)
    frame = zstd.compress_raw(data)
    assert frame[4] & 0x20  # Single_Segment, with the content size
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    p = 5 + (1, 2, 4, 8)[frame[4] >> 6]
    while True:
        head = int.from_bytes(frame[p:p + 3], "little")
        assert (head >> 1) & 3 == 0 and head >> 3 <= zstd.BLOCK_MAX
        p += 3 + (head >> 3)
        if head & 1:
            break
    assert p == len(frame)


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


# -- OCDBT --------------------------------------------------------------------

def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


def _ts_store(root, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            "config": config}).result()


def test_reads_a_multi_level_tree_tensorstore_writes(tmp_path):
    """Small nodes force interior levels and several versions; large
    values go to data files."""
    kv = _ts_store(tmp_path, max_decoded_node_bytes=300,
                   max_inline_value_bytes=16, compression={"id": "zstd"})
    want = {f"key/{i:03d}/val": (b"v%d" % i) * (1 + i % 10)
            for i in range(40)}
    for k, v in want.items():
        kv.write(k, v).result()
    store = ocdbt.Store(str(tmp_path))
    assert store.keys() == sorted(want)
    assert {k: store.read(k) for k in want} == want


def test_tensorstore_reads_the_port_writer(tmp_path):
    items = {f"leaf{i}/x": bytes([i]) * (i * 100) for i in range(30)}
    items["empty"] = b""
    ocdbt.write_store(str(tmp_path / "s"), items)
    kv = _ts_store(tmp_path / "s")
    assert {k.decode(): kv.read(k).result().value
            for k in kv.list().result()} == items
    store = ocdbt.Store(str(tmp_path / "s"))
    assert {k: store.read(k) for k in store.keys()} == items


def test_a_corrupt_manifest_is_refused(tmp_path):
    ocdbt.write_store(str(tmp_path / "s"), {"a": b"1"})
    path = tmp_path / "s" / "manifest.ocdbt"
    data = bytearray(path.read_bytes())
    data[20] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.Store(str(tmp_path / "s"))


@pytest.mark.parametrize("dtype,fill", [("<f4", 7.5), ("<i4", None),
                                        ("bfloat16", "NaN")])
def test_chunk_assembly_equals_tensorstore(tmp_path, dtype, fill):
    """A zarr v2 array in several chunks, edge chunks stored whole and one
    chunk missing (the fill value there), read as tensorstore's zarr
    reader reads it from the same OCDBT store."""
    shape, chunks = [6, 5], [4, 3]
    np_dt = np.dtype(jnp.bfloat16 if dtype == "bfloat16" else dtype)
    rng = np.random.default_rng(0)
    items = {"x/.zarray": json.dumps({
        "chunks": chunks, "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": dtype, "fill_value": fill,
        "filters": None, "order": "C", "shape": shape,
        "zarr_format": 2}).encode()}
    for key in ("0.0", "0.1", "1.0"):  # "1.1" is missing
        chunk = (rng.standard_normal(chunks) * 100).astype(np_dt)
        items[f"x/{key}"] = zstandard.ZstdCompressor(level=3).compress(
            chunk.tobytes())
    ocdbt.write_store(str(tmp_path / "s"), items)
    want = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{tmp_path / 's'}/",
        "path": "x/"}}).result().read().result()
    got = _np(checkpoint._read_array(ocdbt.Store(str(tmp_path / "s")), "x"))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# -- checkpoints: the families ------------------------------------------------

BERT = dict(seq_len=16, hidden=32, n_layers=2, n_heads=2, ffn=64, vocab=128,
            max_batch_size=4)
GPT = dict(n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=128,
           max_seq_len=32, max_streams=4)
RESNET = dict(stages=((1, 8), (1, 16)), num_classes=10, image_size=32)
DENSENET = dict(blocks=(2, 2), growth=8, num_classes=10, image_size=32)
FAMILIES = {
    "bert": (jax_bert.BertBackend, torch_bert.BertBackend, BERT),
    "gpt": (jax_gpt.TinyGptBackend, torch_gpt.TinyGptBackend, GPT),
    "resnet": (jax_vision.ResNet50Backend, torch_vision.ResNet50Backend,
               RESNET),
    "densenet": (jax_vision.DenseNet121Backend,
                 torch_vision.DenseNet121Backend, DENSENET),
}
BERT_ATOL = 2e-2        # tests/test_torch_bert.py
VISION_RTOL = 1e-2      # tests/test_torch_vision.py, bf16 route
SSD_SCORE_ATOL = 2e-2   # tests/test_torch_ssd.py, bf16 route


def _np(leaf) -> np.ndarray:
    """A leaf of either package as numpy, bfloat16 as ``ml_dtypes``'."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    return np.asarray(leaf)


def _assert_trees_equal(got, want):
    """Same paths, dtypes, shapes and bits."""
    flat_got = checkpoint.flatten(got)
    flat_want = checkpoint.flatten(want)
    assert [p for p, _, _ in flat_got] == [p for p, _, _ in flat_want]
    for (path, _, g), (_, _, w) in zip(flat_got, flat_want):
        g, w = _np(g), _np(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        assert g.tobytes() == w.tobytes(), path


def _jax_params(family):
    jax_cls, _, kw = FAMILIES[family]
    return jax.tree_util.tree_map(np.asarray, jax_cls(**kw)._init_params())


def _port(family, **kw):
    return FAMILIES[family][1](device="cpu", **{**FAMILIES[family][2], **kw})


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """Per family: (JAX params, the checkpoint JAX's save_params wrote)."""
    root = tmp_path_factory.mktemp("jax_written")
    return {f: (p, jax_ckpt.save_params(str(root / f), p))
            for f in FAMILIES for p in [_jax_params(f)]}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_restores_what_jax_writes(family, jax_written):
    params, path = jax_written[family]
    got = checkpoint.load_params(path, _port(family).params_to_jax())
    _assert_trees_equal(got, params)
    _assert_trees_equal(got, jax_ckpt.load_params(path, params))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_restores_what_the_port_writes(family, tmp_path):
    tree = _port(family).params_to_jax()
    path = checkpoint.save_params(str(tmp_path / "ckpt"), tree)
    like = _jax_params(family)
    _assert_trees_equal(jax_ckpt.load_params(path, like), tree)
    # JAX's own load path restores into jax.eval_shape's structures.
    abstract = jax.eval_shape(lambda: like)
    _assert_trees_equal(jax_ckpt.load_params(path, abstract), tree)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_to_jax_inverts_params_from_jax(family, jax_written):
    params, _ = jax_written[family]
    port = _port(family)
    port.load_jax_params(params)
    _assert_trees_equal(port.params_to_jax(), params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_restore_skips_the_seeded_fill(family, jax_written, monkeypatch):
    """The checkpoint is checked against the meta-built module and loaded;
    the seeded init never runs."""
    _, path = jax_written[family]
    cls = FAMILIES[family][1]

    def refuse(*args, **kwargs):
        raise AssertionError("seeded init ran")

    if hasattr(cls, "_init_params"):
        monkeypatch.setattr(cls, "_init_params", refuse)
    else:
        monkeypatch.setattr(torch, "randn", refuse)
    with restoring(path):
        port = _port(family)
    assert port.weights_path == path
    _assert_trees_equal(port.params_to_jax(), jax_written[family][0])


def _bert_inputs():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 128, (3, 16)).astype(np.int32),
            "attention_mask": np.ones((3, 16), np.int32)}


def _greedy(step, prompt, n=6):
    ids = list(prompt)
    for _ in range(n):
        ids.append(int(np.argmax(step(np.asarray(ids, np.int32))[-1])))
    return ids[len(prompt):]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_restored_models_answer_as_jax(family, jax_written):
    _, path = jax_written[family]
    jax_cls, _, kw = FAMILIES[family]
    jb = jax_cls(**kw)
    jb.weights_path = path
    fn, params = jb.make_apply_params()
    with restoring(path):
        port = _port(family)
    with torch.inference_mode():
        if family == "bert":
            x = _bert_inputs()
            want = np.asarray(jax.jit(fn)(params, x)["logits"])
            got = port({k: torch.from_numpy(v) for k, v in x.items()})
            np.testing.assert_allclose(got["logits"].numpy(), want,
                                       atol=BERT_ATOL)
        elif family == "gpt":
            jit = jax.jit(fn)
            for prompt in ([1, 2, 3], [7] * 9):
                want = _greedy(lambda ids: np.asarray(
                    jit(params, {"INPUT_IDS": ids})["logits"]), prompt)
                got = _greedy(lambda ids: port.forward_full(
                    torch.from_numpy(ids)).numpy(), prompt)
                assert got == want
        else:
            x = np.random.default_rng(1).standard_normal(
                (3, 32, 32, 3)).astype(np.float32)
            want = np.asarray(jax.jit(fn)(params, {"INPUT": x})["OUTPUT"])
            got = port({"INPUT": torch.from_numpy(x)})["OUTPUT"].numpy()
            np.testing.assert_allclose(
                got, want, atol=VISION_RTOL * float(np.abs(want).max()),
                rtol=0)


def test_ssd_checkpoints_both_ways(tmp_path):
    """The SSD (fixed at 300x300): a checkpoint JAX writes from the port's
    seeded weights restores bit for bit on both sides, the port's restores
    on JAX, and both restored models give the same top detections."""
    port = torch_ssd.SsdMobileNetV2Backend(name="t", device="cpu")
    tree = port.params_to_jax()
    jax_tree = jax.tree_util.tree_map(_np, tree)
    path = jax_ckpt.save_params(str(tmp_path / "jax"), jax_tree)
    _assert_trees_equal(checkpoint.load_params(path, tree), jax_tree)
    ported = checkpoint.save_params(str(tmp_path / "port"), tree)
    _assert_trees_equal(jax_ckpt.load_params(ported, jax_tree), tree)

    jb = jax_ssd.SsdMobileNetV2Backend(name="j")
    jb.weights_path = path
    fn, params = jb.make_apply_params()
    with restoring(path):
        restored = torch_ssd.SsdMobileNetV2Backend(name="t", device="cpu")
    _assert_trees_equal(restored.params_to_jax(), jax_tree)
    x = np.random.default_rng(0).integers(0, 256, (2, 300, 300, 3)).astype(
        np.uint8)
    key = "normalized_input_image_tensor"
    want = jax.jit(fn)(params, {key: x})
    with torch.inference_mode():
        got = restored({key: torch.from_numpy(x)})
    out = "TFLite_Detection_PostProcess"
    for name in (out, out + ":1", out + ":2", out + ":3"):
        assert tuple(got[name].shape) == np.asarray(want[name]).shape
    np.testing.assert_allclose(got[out + ":2"].numpy()[:, 0, 0],
                               np.asarray(want[out + ":2"])[:, 0, 0],
                               atol=SSD_SCORE_ATOL, rtol=0)


# -- checkpoints: the words ---------------------------------------------------

@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    rng = np.random.default_rng(0)
    # ``w`` a jax.Array (orbax checks its shape), ``b`` a numpy array.
    tree = {"a": {"w": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16),
                  "b": rng.standard_normal(4).astype(np.float32)}}
    path = jax_ckpt.save_params(
        str(tmp_path_factory.mktemp("small") / "ckpt"), tree)
    return tree, path


def _both(path, like):
    """Each package's load_params of ``path`` into ``like`` (the port's
    as ``meta`` tensors): the tree, or (status, message)."""
    out = []
    for load, target in (
            (checkpoint.load_params,
             lambda: jax.tree_util.tree_map(_torch_like, like)),
            (jax_ckpt.load_params, lambda: like)):
        try:
            out.append(load(path, target()))
        except Exception as exc:  # noqa: BLE001 — either package's error
            out.append((getattr(exc, "status", None), str(exc)))
    return out


def _torch_like(x):
    dtype = (torch.bfloat16 if x.dtype == jnp.bfloat16
             else torch.from_numpy(np.zeros(0, x.dtype)).dtype)
    return torch.empty(x.shape, dtype=dtype, device="meta")


MISMATCHES = {
    "missing_key": lambda t: {"a": {**t["a"], "c": np.zeros(3, np.float32)}},
    "extra_key": lambda t: {"a": {"w": t["a"]["w"]}},
    "wrong_shape": lambda t: {"a": {"w": jnp.zeros((6, 5), jnp.bfloat16),
                                    "b": t["a"]["b"]}},
    "list_for_dict": lambda t: {"a": [t["a"]["b"], t["a"]["w"]]},
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_mismatches_fail_with_the_jax_words(case, small_ckpt):
    tree, path = small_ckpt
    got, want = _both(path, MISMATCHES[case](tree))
    prefix = (f"weights checkpoint '{path}' does not match the model's "
              "parameter tree: ")
    assert got[0] == want[0] == 400
    assert got[1].startswith(prefix) and want[1].startswith(prefix)


@pytest.mark.parametrize("leaf", ["numpy_saved", "eval_shape"])
def test_a_leaf_of_another_shape_is_refused_where_jax_is_lax(leaf,
                                                             small_ckpt):
    """orbax checks a stored shape only for a leaf saved as a jax.Array
    and restored into a concrete array (``wrong_shape`` above). A leaf
    saved from a numpy array, or restored into ``jax.eval_shape``'s
    structures as the JAX model load does, comes back at its stored
    shape, whatever the model asks for. The port refuses every case, as
    the JAX package's checkpoint module promises ("structure-checked ...
    shapes")."""
    tree, path = small_ckpt
    if leaf == "numpy_saved":
        like = {"a": {"w": tree["a"]["w"], "b": np.zeros(5, np.float32)}}
        name, stored = "b", (4,)
    else:
        like = jax.eval_shape(lambda: {
            "a": {"w": jnp.zeros((6, 5), jnp.bfloat16), "b": tree["a"]["b"]}})
        name, stored = "w", (6, 4)
    got, want = _both(path, like)
    assert got[0] == 400 and "does not match" in got[1]
    assert want["a"][name].shape == stored


def test_a_wrong_dtype_is_cast_as_jax_casts(small_ckpt):
    """orbax restores bf16 leaves into an f32 model (and f32 into i32 /
    bf16) by casting, not refusing: the port does the same."""
    tree, path = small_ckpt
    like = {"a": {"w": np.zeros((6, 4), np.float32),
                  "b": np.zeros(4, jnp.bfloat16)}}
    got, want = _both(path, like)
    _assert_trees_equal(got, want)
    assert got["a"]["w"].dtype == torch.float32
    assert got["a"]["b"].dtype == torch.bfloat16


def test_a_missing_checkpoint_has_the_jax_words(tmp_path, small_ckpt):
    tree, _ = small_ckpt
    path = str(tmp_path / "nowhere")
    got, want = _both(path, tree)
    assert got == want == (400, f"weights checkpoint '{path}' not found")


def test_save_refuses_an_existing_destination(tmp_path):
    with pytest.raises(FileExistsError):
        checkpoint.save_params(str(tmp_path), {"x": torch.zeros(2)})


# -- the JAX-written fixture --------------------------------------------------

def _fixture():
    with open(os.path.join(FIXTURE, "expect.json")) as f:
        return json.load(f)


def _digests(tree) -> dict:
    out = {}
    for p, _, leaf in checkpoint.flatten(tree):
        arr = np.ascontiguousarray(_np(leaf))
        digest = hashlib.sha256(arr.tobytes()).hexdigest()
        out[".".join(p)] = {"dtype": arr.dtype.name,
                            "shape": list(arr.shape), "sha256": digest}
    return out


def _greedy_streams(engine, request_cls, name, expect):
    streams = []
    for prompt in expect["prompts"]:
        toks, done = [], threading.Event()

        def on_response(resp, toks=toks, done=done):
            if resp.error is not None or resp.final:
                toks.append(resp.error)  # None after the last token
                done.set()
            else:
                toks.append(int(resp.outputs["TOKEN"][0]))

        engine.async_infer(request_cls(
            model_name=name,
            inputs={"INPUT_IDS": np.asarray(prompt, np.int32)},
            parameters={"max_tokens": expect["max_tokens"]}), on_response)
        assert done.wait(300)
        assert toks.pop() is None, toks  # the stream's error, if any
        streams.append(toks)
    return streams


def test_fixture_expectations_equal_jax_own_restore():
    """``expect.json`` cannot drift from the checkpoint beside it."""
    expect = _fixture()
    ckpt = os.path.join(FIXTURE, "ckpt")
    backend = jax_gpt.TinyGptBackend(name=expect["name"], **expect["model"])
    like = jax.eval_shape(backend._init_params)
    assert _digests(jax_ckpt.load_params(ckpt, like)) == expect["leaves"]
    backend.weights_path = ckpt
    repo = JaxRepository()
    repo.register_backend(backend)
    engine = TpuEngine(repo)
    try:
        assert _greedy_streams(engine, JaxRequest, expect["name"],
                               expect) == expect["greedy_tokens"]
    finally:
        engine.shutdown()


def test_port_restores_the_fixture(tmp_path):
    """No JAX on the port's side: its digests and its engine's greedy
    streams equal what JAX recorded."""
    expect = _fixture()
    ckpt = shutil.copytree(os.path.join(FIXTURE, "ckpt"), tmp_path / "ckpt")
    repo = ModelRepository()

    def build(device):
        with restoring(str(ckpt)):
            return torch_gpt.TinyGptBackend(name=expect["name"], device=device,
                                            **expect["model"])

    repo.register(expect["name"], build)
    engine = TorchEngine(repo, device="cpu")
    try:
        backend = engine.repository.get(expect["name"]).backend
        assert _digests(backend.params_to_jax()) == expect["leaves"]
        assert _greedy_streams(engine, InferRequest, expect["name"],
                               expect) == expect["greedy_tokens"]
    finally:
        engine.shutdown()


def test_a_truncated_fixture_copy_fails_its_load(tmp_path):
    expect = _fixture()
    ckpt = shutil.copytree(os.path.join(FIXTURE, "ckpt"), tmp_path / "ckpt")
    big = max((p for p in ckpt.rglob("*") if p.is_file()),
              key=lambda p: p.stat().st_size)
    big.write_bytes(big.read_bytes()[:big.stat().st_size // 2])
    with pytest.raises(EngineError) as exc, restoring(str(ckpt)):
        torch_gpt.TinyGptBackend(name="x", device="cpu", **expect["model"])
    assert exc.value.status == 400 and "does not match" in str(exc.value)
