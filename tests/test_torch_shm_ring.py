"""The port's shm slot ring and staged datasets against the JAX
package's.

Each package's engine serves ``simple`` behind HTTP and gRPC. The
segment layout is the wire: the port's producer utilities
(``client_tpu_torch.utils.shm_ring``) write the JAX package's bytes, so a
producer of either package feeds a server of either package, and every
slot's answer is byte-identical to the same request over binary HTTP.
Then the cases of ``tests/test_shm_ring.py`` and ``tests/test_shm_fanin.py``
on the port: per-slot errors and skips, staged segments, the dataset
surface, reaped rings (four producer processes of the port's own),
dead-producer reclaim, detach in flight, the ``shmring.doorbell`` fault
site and shadow admission, each answer held against the JAX server's.
Shared-memory keys carry the test process's pid.
"""

import json
import os
import signal
import subprocess
import sys
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

import client_tpu.grpc as jax_grpcclient
import client_tpu.http as jax_httpclient
import client_tpu.utils.shm_ring as jax_ring
import client_tpu.utils.shm_ring.staged as jax_staged
from client_tpu import faults as jax_faults
from client_tpu.admission import AdmissionConfig as JaxAdmissionConfig
from client_tpu.admission import AdmissionController as JaxAdmission
from client_tpu.engine.shmring import RingShmManager as JaxRingManager
from client_tpu.observability.events import EventJournal as JaxJournal
from client_tpu.protocol import pushback as jax_pushback
import client_tpu_torch.grpc as grpcclient
import client_tpu_torch.http as httpclient
import client_tpu_torch.utils.shm_ring as ring
import client_tpu_torch.utils.shm_ring.staged as staged
from client_tpu_torch import faults
from client_tpu_torch.admission import AdmissionConfig, AdmissionController
from client_tpu_torch.engine import TorchEngine
from client_tpu_torch.engine.shmring import RingShmManager
from client_tpu_torch.models import build_repository
from client_tpu_torch.observability.events import EventJournal
from client_tpu_torch.protocol import pushback
from client_tpu_torch.utils import InferenceServerException

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
PID = os.getpid()


def _key(tag: str) -> str:
    return f"/tshr_{tag}_{PID}"


def _unlink(key: str) -> None:
    try:
        os.unlink("/dev/shm/" + key.lstrip("/"))
    except FileNotFoundError:
        pass


def _inputs(i: int = 0):
    a = (np.arange(16, dtype=np.int32) + i).reshape(1, 16)
    return a, np.full((1, 16), 3, dtype=np.int32)


def _simple_tensors(rows: int = 16) -> dict:
    base = np.arange(16, dtype=np.int32)
    return {"INPUT0": np.stack([base + r for r in range(rows)]),
            "INPUT1": np.full((rows, 16), 3, dtype=np.int32)}


def _refs(row: int) -> dict:
    return {"INPUT0": ("INPUT0", row, 1), "INPUT1": ("INPUT1", row, 1)}


def _serve(engine_port, engine_jax):
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    return {
        "port": SimpleNamespace(
            engine=engine_port, http=HttpInferenceServer(
                engine_port, port=0).start(),
            grpc=GrpcInferenceServer(engine_port, port=0).start(),
            httpclient=httpclient, grpcclient=grpcclient, ring=ring,
            staged=staged),
        "jax": SimpleNamespace(
            engine=engine_jax, http=JaxHttp(engine_jax, port=0).start(),
            grpc=JaxGrpc(engine_jax, port=0).start(),
            httpclient=jax_httpclient, grpcclient=jax_grpcclient,
            ring=jax_ring, staged=jax_staged),
    }


def _stop(sides):
    for side in sides.values():
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


@pytest.fixture(scope="module")
def servers():
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build

    sides = _serve(TorchEngine(build_repository(["simple"]), device="cpu"),
                   TpuEngine(jax_build(["simple"])))
    yield sides
    _stop(sides)


def _client(side, wire, pkg=None):
    """A client of ``pkg``'s (default: the side's own package) for the
    side's server over ``wire``."""
    mods = {"port": (httpclient, grpcclient),
            "jax": (jax_httpclient, jax_grpcclient)}[pkg or (
                "port" if side.httpclient is httpclient else "jax")]
    if wire == "http":
        return mods[0].InferenceServerClient(side.http.url)
    return mods[1].InferenceServerClient(side.grpc.url)


def _http_answer(side, a, b) -> dict:
    """The binary HTTP path's answer (the port's client) on ``side``."""
    c = httpclient.InferenceServerClient(side.http.url)
    ins = []
    for name, arr in (("INPUT0", a), ("INPUT1", b)):
        inp = httpclient.InferInput(name, list(arr.shape), "INT32")
        inp.set_data_from_numpy(np.ascontiguousarray(arr))
        ins.append(inp)
    res = c.infer("simple", ins)
    c.close()
    return {n: res.as_numpy(n) for n in ("OUTPUT0", "OUTPUT1")}


# -- the wire: layout constants and segment bytes ---------------------------

RING_NAMES = ["RING_MAGIC", "RING_VERSION", "HEADER_BYTES", "STATE_STRIDE",
              "OFF_MAGIC", "OFF_VERSION", "OFF_SLOT_COUNT", "OFF_SLOT_BYTES",
              "OFF_RESP_BYTES", "OFF_PRODUCER_PID", "OFF_HEAD", "OFF_TAIL",
              "OFF_HEARTBEAT", "SLOT_FREE", "SLOT_FILLED", "SLOT_IN_FLIGHT",
              "SLOT_DONE", "STATE_NAMES"]
STAGED_NAMES = ["DSET_MAGIC", "DSET_VERSION", "DSET_MANIFEST_OFF",
                "OFF_DSET_MAGIC", "OFF_DSET_VERSION", "OFF_DSET_TENSOR_COUNT",
                "OFF_DSET_MANIFEST_BYTES", "OFF_DSET_PAYLOAD_BASE",
                "OFF_DSET_TOTAL_BYTES", "DESCRIPTOR_BYTES"]


@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_layout_equals_jax(name):
    assert getattr(ring, name) == getattr(jax_ring, name)


@pytest.mark.parametrize("name", STAGED_NAMES)
def test_staged_layout_equals_jax(name):
    assert getattr(staged, name) == getattr(jax_staged, name)


def test_magic_words_spell_the_wire():
    assert ring.RING_MAGIC.to_bytes(8, "little") == b"TPURING1"
    assert staged.DSET_MAGIC.to_bytes(8, "little") == b"TPUDSET1"
    for geometry in ((1, 64, 64), (8, 4096, 8192), (64, 1 << 20, 1 << 20)):
        assert ring.ring_total_bytes(*geometry) \
            == jax_ring.ring_total_bytes(*geometry)
    assert staged.pack_descriptor(3, 7, 2) \
        == jax_staged.pack_descriptor(3, 7, 2)
    assert staged.unpack_descriptor(staged.pack_descriptor(3, 7, 2)) \
        == (3, 7, 2)


def test_segments_are_byte_identical():
    """The same fills through either package's producer utilities leave
    the same bytes in the segment; so does the same staged dataset."""
    raws = []
    for tag, mod, smod in (("p", ring, staged), ("j", jax_ring, jax_staged)):
        key, dkey = _key(f"seg{tag}"), _key(f"dseg{tag}")
        buf = mod.RingBuffer.create(key, 4, 4096, 8192)
        ds = smod.build_staged_dataset(dkey, _simple_tensors(5))
        try:
            for i in range(3):
                a, b = _inputs(i)
                buf.fill({"INPUT0": a, "INPUT1": b})
            buf.fill_staged(ds, _refs(4))
            buf.beat()
            with open("/dev/shm/" + key.lstrip("/"), "rb") as f:
                ring_bytes = f.read()
            with open("/dev/shm/" + dkey.lstrip("/"), "rb") as f:
                ds_bytes = f.read()
            raws.append((ring_bytes, ds_bytes))
        finally:
            buf.close(unlink=True)
            ds.close(unlink=True)
    assert raws[0] == raws[1]


SLOT_ERRORS = [("shed", 0.25), ("shed", None), ("model gone", 1.5),
               ("x", 0.0004)]


@pytest.mark.parametrize("message,retry", SLOT_ERRORS)
def test_slot_error_pushback_equals_jax(message, retry):
    text = pushback.format_slot_error(message, retry)
    assert text == jax_pushback.format_slot_error(message, retry)
    assert pushback.parse_slot_error_retry_after(text) \
        == jax_pushback.parse_slot_error_retry_after(text)


# -- the ring across packages ------------------------------------------------

FEEDS = [(p, s, w) for p in ("port", "jax") for s in ("port", "jax")
         for w in ("http", "grpc")]


@pytest.mark.parametrize("producer,server,wire", FEEDS)
def test_either_producer_feeds_either_server(servers, producer, server,
                                             wire):
    """A producer of either package on a server of either package: every
    answer is byte-identical to the binary HTTP path on the port's
    server and on the JAX server."""
    side = servers[server]
    mod = ring if producer == "port" else jax_ring
    c = _client(side, wire, producer)
    try:
        with mod.RingProducer(c, "feed", _key(f"feed{producer}{server}"),
                              slot_count=8, slot_bytes=4096) as prod:
            for i in range(8):
                a, b = _inputs(i)
                assert prod.fill({"INPUT0": a, "INPUT1": b}) is not None
            assert prod.doorbell("simple") == {
                "admitted": 8, "rejected": 0, "skipped": 0}
            for i in range(8):
                _, outs, err = prod.reap(timeout_s=TIMEOUT)
                assert err is None
                a, b = _inputs(i)
                for s in servers.values():
                    expect = _http_answer(s, a, b)
                    for name in expect:
                        assert outs[name].dtype == expect[name].dtype
                        assert outs[name].tobytes() \
                            == expect[name].tobytes()
            status = c.get_shm_ring_status("feed")["feed"]
            assert (status["slots_ok"], status["doorbells"]) == (8, 1)
        assert c.get_shm_ring_status() == {}
    finally:
        c.close()


def test_per_slot_errors_and_skips_equal_jax(servers):
    """One bad slot never voids the span: an unknown model lands as a
    per-slot error, an unfilled slot is skipped; the port's words and
    counts are the JAX server's."""
    seen = []
    for name, side in servers.items():
        c = _client(side, "http", "port")
        with ring.RingProducer(c, "errs", _key(f"errs{name}"), slot_count=4,
                               slot_bytes=2048) as prod:
            a, b = _inputs()
            prod.fill({"INPUT0": a, "INPUT1": b})
            prod.fill({"INPUT0": a, "INPUT1": b})
            spec = {"start": 0, "count": 3, "model_name": "no_such",
                    "inputs": prod._meta}
            prod._pending, prod._meta = [], None
            result = c.ring_doorbell("errs", spec)
            errors = [prod.reap(timeout_s=TIMEOUT)[2] for _ in range(2)]
            status = c.get_shm_ring_status("errs")["errs"]
            bad = []
            for body in ({}, {"start": 0, "count": 0, "model_name": "m",
                              "inputs": [{}]},
                         {"start": 9, "count": 1, "model_name": "m",
                          "inputs": [{}]},
                         {"start": 0, "count": 1, "model_name": "m",
                          "inputs": []}):
                try:
                    c.ring_doorbell("errs", body)
                except InferenceServerException as exc:
                    bad.append((exc.status(), exc.message()))
        c.close()
        seen.append((result, errors, status["slots_error"],
                     status["slots_skipped"], sorted(status), bad))
    assert seen[0] == seen[1]
    assert seen[0][0]["skipped"] == 1 and len(seen[0][5]) == 4


def test_ring_observability_equals_jax(servers):
    """``tpu_shm_ring_*`` families, the ``/v2/profile`` ring table, the
    journal's attach/detach and the extensions, on both servers."""
    seen = []
    for name, side in servers.items():
        c = _client(side, "http", "port")
        with ring.RingProducer(c, "obs", _key(f"obs{name}"), slot_count=4,
                               slot_bytes=2048) as prod:
            a, b = _inputs()
            prod.fill({"INPUT0": a, "INPUT1": b})
            assert prod.doorbell("simple")["admitted"] == 1
            assert prod.reap(timeout_s=TIMEOUT)[2] is None
            classic = side.engine.prometheus_metrics()
            prof = c.get_profile()
        events = [e["name"] for e in side.engine.events_export(
            category="shm_ring")["events"]]
        after = side.engine.prometheus_metrics()
        seen.append((
            sorted({line.split("{")[0].split(" ")[0]
                    for line in classic.splitlines()
                    if line.startswith("tpu_shm_")}),
            'tpu_shm_ring_doorbells_total{ring="obs"} 1' in classic,
            'tpu_shm_ring_slots_total{ring="obs",outcome="ok"} 1' in classic,
            sorted(prof["shm_rings"]["obs"]),
            "attach" in events and "detach" in events,
            'tpu_shm_ring_occupancy{ring="obs"}' in after,
            [e for e in c.get_server_metadata()["extensions"]
             if e in ("shm_ring", "staged_dataset")]))
        c.close()
    assert seen[0] == seen[1]
    assert seen[0][1] and seen[0][2] and not seen[0][5]


def test_register_bad_bodies_are_400_on_both(servers):
    import urllib.error
    import urllib.request

    got = []
    for side in servers.values():
        codes = []
        for route in ("ring", "dataset"):
            for body in (b"", b"[]", b"{}", b'{"key": 7}',
                         b'{"key": "/k", "spec": 3}'):
                req = urllib.request.Request(
                    f"http://{side.http.url}/v2/shm/{route}/bad/register",
                    data=body, method="POST")
                try:
                    urllib.request.urlopen(req, timeout=TIMEOUT)
                    codes.append(200)
                except urllib.error.HTTPError as exc:
                    codes.append((exc.code, json.loads(exc.read())))
        got.append(codes)
    assert got[0] == got[1]
    assert all(code[0] == 400 for code in got[0])


def test_ring_manager_register_words_equal_jax():
    bad = _key("mgrbad")
    with open("/dev/shm/" + bad.lstrip("/"), "wb") as f:
        f.write(b"\0" * 8192)
    ok = ring.RingBuffer.create(_key("mgrok"), 4, 128, 128)
    try:
        seen = []
        for mgr in (RingShmManager(), JaxRingManager()):
            out = []
            for name, key in (("bad", bad), ("gone", _key("nothere")),
                              ("ok", _key("mgrok")), ("ok", _key("mgrok"))):
                try:
                    mgr.register(name, key)
                    out.append("ok")
                except Exception as exc:  # noqa: BLE001 — compared
                    out.append((exc.status, str(exc)))
            out.append(mgr.status("ok")["ok"]["slot_count"])
            mgr.shutdown()
            out.append(mgr.status())
            seen.append(out)
        assert seen[0] == seen[1]
    finally:
        ok.close(unlink=True)
        _unlink(bad)


def test_a_manager_without_a_submit_path_refuses_doorbells():
    """A standalone manager registers rings but has nowhere to send a
    slot: a doorbell is a 400 and leaves the FILLED slot as it was."""
    key = _key("nosubmit")
    buf = ring.RingBuffer.create(key, 2, 4096, 8192)
    mgr = RingShmManager()
    try:
        mgr.register("n", key)
        a, b = _inputs(3)
        _, meta = buf.fill({"INPUT0": a, "INPUT1": b})
        with pytest.raises(Exception) as exc:
            mgr.doorbell("n", {"start": 0, "count": 1,
                               "model_name": "simple", "inputs": meta})
        assert exc.value.status == 400 and "no submit path" in str(exc.value)
        assert buf.state(0) == ring.SLOT_FILLED
    finally:
        mgr.shutdown()
        buf.close(unlink=True)

# -- staged segments -------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared
        return (type(exc).__name__, str(exc).replace("_j_", "_x_")
                .replace("_p_", "_x_"))


def test_staged_segment_equals_jax():
    seen = []
    for tag, smod in (("p", staged), ("j", jax_staged)):
        key = _key(f"rt_{tag}_")
        ds = smod.build_staged_dataset(key, _simple_tensors(8))
        try:
            peer = smod.StagedDataset.attach(key)
            seen.append((
                peer.names, peer.rows("INPUT0"),
                peer.tensor("INPUT0").tobytes(),
                peer.descriptor("INPUT1", 7, 1),
                _outcome(lambda: peer.descriptor("INPUT0", 7, 2)),
                _outcome(lambda: peer.descriptor("NOPE", 0, 1)),
                _outcome(lambda: smod.build_staged_dataset(
                    _key(f"obj_{tag}_"),
                    {"B": np.array([b"x", b"yy"], dtype=object)})),
                _outcome(lambda: smod.build_staged_dataset(
                    _key(f"empty_{tag}_"), {})),
                _outcome(lambda: (lambda d: (d.names, d.close(unlink=True))[0])(
                    smod.build_staged_dataset(_key(f"rank_{tag}_"),
                                              {"S": np.int32(3)}))),
                _outcome(lambda: smod.StagedDataset.attach(
                    _key(f"missing_{tag}_")))))
            peer.close()
        finally:
            ds.close(unlink=True)
            for t in ("obj", "empty", "rank"):
                _unlink(_key(f"{t}_{tag}_"))
    assert seen[0] == seen[1]


def test_dataset_surface_equals_jax(servers):
    """Register over HTTP, status over gRPC, a duplicate name 400,
    unregister: the same bodies from both servers (one segment, so the
    key in each status is the same)."""
    key = _key("surf")
    ds = staged.build_staged_dataset(key, _simple_tensors(4))
    try:
        seen = []
        for side in servers.values():
            hc, gc = _client(side, "http", "port"), _client(side, "grpc",
                                                            "port")
            hc.register_staged_dataset("surf", key)
            status = gc.get_staged_dataset_status("surf")
            prof = hc.get_profile()["shm_datasets"]
            try:
                gc.register_staged_dataset("surf", key)
                dup = None
            except InferenceServerException as exc:
                dup = (exc.status(), exc.message())
            gc.unregister_staged_dataset("surf")
            seen.append((status, prof, dup,
                         hc.get_staged_dataset_status()))
            hc.close()
            gc.close()
        assert seen[0] == seen[1]
        assert seen[0][0]["surf"]["payload_bytes"] == 2 * 4 * 16 * 4
    finally:
        ds.close(unlink=True)


def _corruptions():
    def bad_magic(raw):
        raw[0:8] = b"NOTADSET"

    def bad_version(raw):
        raw[staged.OFF_DSET_VERSION] = 99

    def bad_manifest_json(raw):
        raw[staged.DSET_MANIFEST_OFF] = ord("{")

    def lying_byte_size(raw):
        at = raw.index(b'"byte_size"')
        j = raw.index(b":", at) + 1
        while raw[j:j + 1] == b" ":
            j += 1
        k = j
        while raw[k:k + 1].isdigit():
            k += 1
        raw[j:k] = b"9" * (k - j)

    def truncated(raw):
        del raw[32:]

    return [bad_magic, bad_version, bad_manifest_json, lying_byte_size,
            truncated]


@pytest.mark.parametrize("mutate", _corruptions(),
                         ids=lambda f: f.__name__)
def test_corrupt_dataset_is_400_with_jaxs_words(servers, mutate):
    key = _key(f"mut_{mutate.__name__}")
    staged.build_staged_dataset(key, _simple_tensors(4)).close()
    path = "/dev/shm/" + key.lstrip("/")
    try:
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        mutate(raw)
        with open(path, "wb") as f:
            f.write(raw)
        seen = []
        for side in servers.values():
            c = _client(side, "http", "port")
            with pytest.raises(InferenceServerException) as ei:
                c.register_staged_dataset("bad", key)
            seen.append((ei.value.status(), ei.value.message()))
            c.close()
        assert seen[0] == seen[1] and seen[0][0] == 400
    finally:
        _unlink(key)


# -- reaped rings ------------------------------------------------------------------


def test_reaped_staged_ring_equals_http_and_jax(servers):
    """A reaped ring replays every dataset row with no doorbell; answers
    byte-identical to binary HTTP, and to the JAX server's reaped ring."""
    rows = 12
    dkey = _key("par")
    ds = staged.build_staged_dataset(dkey, _simple_tensors(rows))
    answers = {}
    try:
        for name, side in servers.items():
            c = _client(side, "http", "port")
            c.register_staged_dataset("par", dkey)
            spec = {"model_name": "simple",
                    "inputs": ring.staged_inputs_meta(_refs(0)),
                    "dataset": "par"}
            try:
                with ring.RingProducer(c, "par_ring", _key(f"parr{name}"),
                                       slot_count=8, slot_bytes=4096,
                                       dataset=ds, dataset_name="par",
                                       spec=spec) as prod:
                    assert c.get_shm_ring_status(
                        "par_ring")["par_ring"]["reaped"] is True
                    got, sent = [], 0
                    while len(got) < rows:
                        if sent < rows and \
                                prod.fill_staged(_refs(sent)) is not None:
                            sent += 1
                            continue
                        _, outs, err = prod.reap(timeout_s=TIMEOUT)
                        assert err is None, err
                        got.append({k: v.tobytes() for k, v in outs.items()})
                    with pytest.raises(InferenceServerException) as ei:
                        c.ring_doorbell("par_ring", {
                            "start": 0, "count": 1, "model_name": "simple",
                            "inputs": ring.staged_inputs_meta(_refs(0))})
                    assert ei.value.status() == 400
            finally:
                c.unregister_staged_dataset("par")
                c.close()
            answers[name] = got
            text = side.engine.prometheus_metrics()
            assert 'tpu_shm_reaper_slots_total{ring="par_ring"}' in text
            assert "tpu_shm_reaper_rings 0" in text
        assert answers["port"] == answers["jax"]
        t = ds.tensor
        for r in range(rows):
            expect = _http_answer(servers["port"], t("INPUT0")[r:r + 1],
                                  t("INPUT1")[r:r + 1])
            assert answers["port"][r] == {k: v.tobytes()
                                          for k, v in expect.items()}
    finally:
        ds.close(unlink=True)


_PRODUCER = r"""
import json, sys, time, zlib
import client_tpu_torch.http as httpclient
from client_tpu_torch.utils.shm_ring import RingProducer, staged_inputs_meta
from client_tpu_torch.utils.shm_ring.staged import StagedDataset

url, dkey, dname, key, worker, per, rows = sys.argv[1:8]
worker, per, rows = int(worker), int(per), int(rows)
refs = lambda r: {"INPUT0": ("INPUT0", r, 1), "INPUT1": ("INPUT1", r, 1)}
ds = StagedDataset.attach(dkey)
c = httpclient.InferenceServerClient(url)
spec = {"model_name": "simple", "inputs": staged_inputs_meta(refs(0)),
        "dataset": dname}
crc = done = errors = 0
with RingProducer(c, f"w{worker}", key, slot_count=4, slot_bytes=4096,
                  dataset=ds, dataset_name=dname, spec=spec) as prod:
    sent = 0
    while done < per:
        if sent < per and prod.fill_staged(refs((worker + sent) % rows)) \
                is not None:
            sent += 1
            continue
        _, outs, err = prod.reap(timeout_s=60)
        if err:
            errors += 1
        else:
            for name in sorted(outs):
                crc += zlib.crc32(outs[name].tobytes())
        done += 1
ds.close()
print(json.dumps({"completions": done, "errors": errors, "crc": crc}))
"""


def test_four_producer_processes_equal_http(servers):
    """Four producer processes of the port's own, each with a reaped ring
    into one staged dataset: their summed output CRCs equal the binary
    HTTP path's on the same rows."""
    side = servers["port"]
    rows, producers, per = 16, 4, 6
    dkey = _key("fan")
    ds = staged.build_staged_dataset(dkey, _simple_tensors(rows))
    c = _client(side, "http", "port")
    c.register_staged_dataset("fan", dkey)
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PRODUCER, side.http.url, dkey, "fan",
             _key(f"fanr{i}"), str(i), str(per), str(rows)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))
            for i in range(producers)]
        stats = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
            stats.append(json.loads(out.decode().strip().splitlines()[-1]))
        assert sum(s["completions"] for s in stats) == producers * per
        assert sum(s["errors"] for s in stats) == 0
        expect = 0
        t = ds.tensor
        for i in range(producers):
            for k in range(per):
                r = (i + k) % rows
                answer = _http_answer(side, t("INPUT0")[r:r + 1],
                                      t("INPUT1")[r:r + 1])
                for name in sorted(answer):
                    expect += zlib.crc32(answer[name].tobytes())
        assert sum(s["crc"] for s in stats) == expect
    finally:
        c.unregister_staged_dataset("fan")
        c.close()
        ds.close(unlink=True)
        for i in range(producers):
            _unlink(_key(f"fanr{i}"))


_DEAD = r"""
import sys, time
import client_tpu_torch.http as httpclient
from client_tpu_torch.utils.shm_ring import RingBuffer

url, name, key = sys.argv[1:4]
RingBuffer.create(key, 8, 4096, 8192)
httpclient.InferenceServerClient(url).register_shm_ring(name, key, spec={
    "model_name": "simple",
    "inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "offset": 0, "byte_size": 64},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "offset": 64, "byte_size": 64}]})
print("ready", flush=True)
time.sleep(600)
"""


def test_dead_producer_is_reclaimed(servers):
    eng, url = servers["port"].engine, servers["port"].http.url
    key = _key("dead")
    proc = subprocess.Popen(
        [sys.executable, "-c", _DEAD, url, "deadring", key],
        stdout=subprocess.PIPE, cwd=REPO, env=dict(os.environ,
                                                   PYTHONPATH=REPO))
    try:
        assert proc.stdout.readline().strip() == b"ready"
        status = eng.ring_shm.status("deadring")["deadring"]
        assert status["reaped"] is True and status["producer_pid"] == proc.pid
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        deadline = time.monotonic() + 15
        while "deadring" in eng.ring_shm.status() \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "deadring" not in eng.ring_shm.status()
        dead = [e for e in eng.events_export(category="shm_ring")["events"]
                if e["name"] == "producer_dead"]
        assert dead and dead[-1]["detail"]["pid"] == proc.pid
        assert 'tpu_shm_reaper_dead_producers_total{ring="deadring"}' \
            in eng.prometheus_metrics()
    finally:
        if proc.poll() is None:
            proc.kill()
        _unlink(key)


def test_detach_fails_inflight_slots_as_jax():
    seen = []
    for tag, mgr_cls, journal_cls, rmod in (
            ("p", RingShmManager, EventJournal, ring),
            ("j", JaxRingManager, JaxJournal, jax_ring)):
        events, held = journal_cls(), []

        def submit(req, cb):
            held.append((req, cb))

        # The port's manager takes its submit path once, at construction;
        # the JAX package's doorbell takes it per call.
        mgr = (mgr_cls(events=events, submit=submit) if tag == "p"
               else mgr_cls(events=events))
        key = _key(f"dif{tag}")
        buf = rmod.RingBuffer.create(key, 4, 4096, 8192)
        try:
            mgr.register("dif", key)
            a, _ = _inputs()
            _, meta = buf.fill({"INPUT0": a, "INPUT1": a})
            buf.fill({"INPUT0": a, "INPUT1": a})
            spec = {"start": 0, "count": 2, "model_name": "simple",
                    "inputs": meta}
            res = (mgr.doorbell("dif", spec) if tag == "p"
                   else mgr.doorbell("dif", spec, submit=submit))
            requests = [(r.request_id, sorted(r.inputs),
                         r.inputs["INPUT0"].flags.writeable)
                        for r, _ in held]
            mgr.unregister("dif")
            slots = [(buf.state(s), buf.read_response(s)) for s in (0, 1)]
            ev = [(e.name, e.severity, e.detail.get("slots"))
                  for e in events.snapshot(category="shm_ring")
                  if e.name == "detach_inflight"]
            seen.append((res, requests, slots, ev))
        finally:
            mgr.shutdown()
            buf.close(unlink=True)
    assert seen[0] == seen[1]
    assert seen[0][2][0][0] == ring.SLOT_DONE
    assert "detached" in seen[0][2][0][1][1]


def test_a_tensor_output_lands_as_host_bytes():
    """An output the engine hands over as a tensor (as it does with
    ``keep_outputs_on_device``) is fetched to the host before the slot's
    DONE store: the producer reads the array's bytes."""
    import torch

    from client_tpu_torch.engine.shmring import _Ring

    key = _key("tensor")
    buf = ring.RingBuffer.create(key, 2, 256, 1024)
    r = None
    try:
        r = _Ring("t", key)
        out = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert r.write_response(0, {"OUT": out}, None)
        assert buf.state(0) == ring.SLOT_DONE
        outs, err = buf.read_response(0)
        assert err is None and outs["OUT"].tobytes() == out.numpy().tobytes()
    finally:
        if r is not None:
            r.close()
        buf.close(unlink=True)


def test_doorbell_fault_site_equals_jax(servers):
    assert "shmring.doorbell" in faults.SITES
    seen = []
    for (name, side), fmod in zip(servers.items(), (faults, jax_faults)):
        c = _client(side, "http", "port")
        key = _key(f"flt{name}")
        buf = ring.RingBuffer.create(key, 4, 4096, 8192)
        try:
            c.register_shm_ring("flt", key)
            a, _ = _inputs()
            _, meta = buf.fill({"INPUT0": a, "INPUT1": a})
            fmod.configure({"shmring.doorbell": {
                "probability": 1.0, "seed": 3, "error_status": 503}})
            try:
                with pytest.raises(InferenceServerException) as ei:
                    c.ring_doorbell("flt", {"start": 0, "count": 1,
                                            "model_name": "simple",
                                            "inputs": meta})
            finally:
                fmod.reset()
            text = side.engine.prometheus_metrics()
            seen.append((ei.value.status(), ei.value.message(),
                         'site="shmring.doorbell"' in text))
            c.unregister_shm_ring("flt")
        finally:
            buf.close(unlink=True)
            c.close()
    assert seen[0] == seen[1] and seen[0][0] == 503 and seen[0][2]


# -- shadow admission ------------------------------------------------------------


def _controller_cases(cfg_cls, ctrl_cls):
    out = []
    ctrl = ctrl_cls(cfg_cls(shadow_priority=4))
    out.append([ctrl.is_shadow("m", p) for p in (0, 3, 4, 8)])
    out.append(ctrl_cls(cfg_cls()).is_shadow("m", 99))
    ctrl = ctrl_cls(cfg_cls(shadow_priority=4, shadow_max_inflight=1))
    ctrl.admit("m", priority=8)
    ctrl.on_request_start("m", shadow=True)
    try:
        ctrl.admit("m", priority=8)
        out.append("admitted")
    except Exception as exc:  # noqa: BLE001 — compared
        out.append((exc.reason, exc.status))
    ctrl.admit("m", priority=0)
    ctrl.on_request_end("m", shadow=True)
    ctrl.admit("m", priority=8)
    ctrl = ctrl_cls(cfg_cls(shadow_priority=4, shadow_max_queue_depth=2))
    ctrl.admit("m", queue_depth=1, priority=4)
    try:
        ctrl.admit("m", queue_depth=2, priority=4)
        out.append("admitted")
    except Exception as exc:  # noqa: BLE001 — compared
        out.append((exc.reason, exc.status))
    ctrl.admit("m", queue_depth=2, priority=0)
    ctrl = ctrl_cls(cfg_cls(shadow_priority=4))
    ctrl.on_request_start("m", shadow=True)
    ctrl.on_request_start("m", shadow=False)
    snap = ctrl.load_snapshot()["m"]
    out.append((snap["inflight"], snap["shadow_inflight"]))
    return out


def test_shadow_controller_cases_equal_jax():
    assert _controller_cases(AdmissionConfig, AdmissionController) \
        == _controller_cases(JaxAdmissionConfig, JaxAdmission)


def test_ring_slots_take_the_shadow_class():
    """A ring's slots are admitted as the spec's priority and tenant say:
    with one shadow request held in flight, the shadow slots shed (the
    pushback folded into the slot's error) while the live ones are
    served, on both engines."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build

    sides = _serve(
        TorchEngine(build_repository(["simple"]), device="cpu",
                    admission=AdmissionController(AdmissionConfig(
                        shadow_priority=4, shadow_max_inflight=1))),
        TpuEngine(jax_build(["simple"]), admission=JaxAdmission(
            JaxAdmissionConfig(shadow_priority=4, shadow_max_inflight=1))))
    try:
        seen = []
        for name, side in sides.items():
            c = _client(side, "http", "port")
            side.engine.admission.on_request_start("simple", shadow=True)
            with ring.RingProducer(c, "sh", _key(f"sh{name}"), slot_count=8,
                                   slot_bytes=4096) as prod:
                outcomes = []
                for priority, tenant in ((8, "replay"), (0, "live"),
                                         (8, "replay"), (0, "live")):
                    a, b = _inputs(priority)
                    prod.fill({"INPUT0": a, "INPUT1": b})
                    result = prod.doorbell("simple", priority=priority,
                                           tenant=tenant)
                    _, outs, err = prod.reap(timeout_s=TIMEOUT)
                    outcomes.append((
                        result, err is None,
                        err is not None and "shadow" in err,
                        pushback.parse_slot_error_retry_after(err)
                        is not None))
            side.engine.admission.on_request_end("simple", shadow=True)
            sheds = [e["detail"].get("tenant") for e in
                     side.engine.events_export(category="admission")[
                         "events"] if e["name"] == "shed"]
            seen.append((outcomes, sheds[-2:]))
            c.close()
        assert seen[0] == seen[1]
        assert [o[1] for o in seen[0][0]] == [False, True, False, True]
    finally:
        _stop(sides)


def test_slot_inputs_are_views_of_the_slot_and_stage(servers):
    """A slot's inputs reach the model as views of the mapped slot (no
    copy on the way in); the port's staging takes such a view, and a
    read-only one, without ``torch.from_numpy`` of a read-only array (no
    warning), with the slot's bytes."""
    import warnings

    from client_tpu_torch.engine.model import _stage_host

    device = servers["port"].engine.device
    held = []
    mgr = RingShmManager(submit=lambda req, cb: held.append((req, cb)))
    key = _key("ro")
    buf = ring.RingBuffer.create(key, 2, 4096, 8192)
    try:
        mgr.register("ro", key)
        a, b = _inputs(9)
        _, meta = buf.fill({"INPUT0": a, "INPUT1": b})
        res = mgr.doorbell(
            "ro", {"start": 0, "count": 1, "model_name": "simple",
                   "inputs": meta})
        assert res["admitted"] == 1
        view = held[0][0].inputs["INPUT0"]
        assert not view.flags.owndata
        frozen = view.view()
        frozen.setflags(write=False)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            staged_in = [_stage_host(v, device) for v in (view, frozen)]
        for t in staged_in:
            assert t.numpy().tobytes() == a.tobytes()
        del view, frozen, held, staged_in
    finally:
        mgr.shutdown()
        buf.close(unlink=True)
