"""The port's incident blackbox (``client_tpu_torch/observability/
blackbox.py``) against the JAX package's.

* ``match_trigger`` and ``BlackboxConfig.from_dict`` / ``from_env`` give
  the same answers over one table of inputs, errors included.
* The same journal event sequence, under one fake monotonic clock, makes
  both recorders enqueue, suppress and write the same captures.
* ``BundleStore`` keeps and evicts the same bundles.
* Both engines, behind HTTP and gRPC, answer the bundle routes and RPCs
  with the same keys and sections and the same codes for an unknown,
  malformed or corrupt bundle and a disabled blackbox.
* The crash hooks leave the same evidence, chain to the hook installed
  before them, and stop writing bundles once the recorder is gone.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from types import SimpleNamespace

import grpc
import pytest

from client_tpu.observability import blackbox as jax_bb
from client_tpu.observability import events as jax_events
from client_tpu_torch.engine import EngineError, TorchEngine
from client_tpu_torch.models import build_repository
from client_tpu_torch.observability import blackbox as bb
from client_tpu_torch.observability import events as port_events
from client_tpu_torch.protocol import grpc_stub
from client_tpu_torch.protocol import ops_pb2 as ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60


def _both(fn):
    """fn(module) for the port's and the JAX package's blackbox, each as
    its value or its error's class name and words."""
    out = []
    for mod in (bb, jax_bb):
        try:
            out.append(("ok", fn(mod)))
        except Exception as exc:  # noqa: BLE001 — compared, not hidden
            out.append(("error", type(exc).__name__, str(exc)))
    return out


# -- the trigger vocabulary and the config grammar ----------------------------

TRIGGER_TABLE = [
    ("qos", "throttle", None), ("admission", "tighten", {"model": "m"}),
    ("fleet", "rebalance", None), ("memory", "pressure", None),
    ("breaker", "open", None), ("deadline", "expired", {"model": "m"}),
    ("lifecycle", "health", None), ("lifecycle", "health",
                                    {"state": "DEGRADED"}),
    ("lifecycle", "health", {"slo_fast_burn": ["m"]}),
    ("lifecycle", "server_start", None), ("admission", "restore", None),
    ("autotune", "dispatch_tighten", None), ("blackbox", "captured", None),
    ("shm_ring", "producer_dead", None),
]


@pytest.mark.parametrize("category,name,detail", TRIGGER_TABLE)
def test_match_trigger_equals_jax(category, name, detail):
    port, ref = _both(lambda m: m.match_trigger(category, name, detail))
    assert port == ref


def test_vocabulary_equals_jax():
    assert bb.DEFAULT_TRIGGERS == jax_bb.DEFAULT_TRIGGERS
    assert bb.MANUAL_TRIGGERS == jax_bb.MANUAL_TRIGGERS
    assert bb.ENV_VAR == jax_bb.ENV_VAR
    assert [f.name for f in dataclasses.fields(bb.BlackboxConfig)] \
        == [f.name for f in dataclasses.fields(jax_bb.BlackboxConfig)]


CONFIG_DICTS = [
    {}, {"debounce_s": 1, "triggers": ["qos.throttle"]},
    {"dir": "/x/y", "window_s": 5.5, "storm_count": "7"},
    {"windoze_s": 5}, {"triggers": ["qos.oops"]}, {"triggers": "qos"},
    {"window_s": 0}, {"post_window_s": -1}, {"debounce_s": -1},
    {"storm_count": 0}, {"storm_window_s": 0},
    {"max_bundle_bytes": 10}, {"max_bundles": 0},
    {"max_total_bytes": 5000, "max_bundle_bytes": 8000},
    {"journal_tail": 0}, {"worst_requests": -1},
    {"debounce_s": "soon"}, {"max_bundles": "many"}, {"dir": ""},
    {"dir": 7},
]


@pytest.mark.parametrize("data", CONFIG_DICTS,
                         ids=[json.dumps(d) for d in CONFIG_DICTS])
def test_config_from_dict_equals_jax(data):
    port, ref = _both(lambda m: dataclasses.asdict(
        m.BlackboxConfig.from_dict(data)))
    assert port == ref


CONFIG_ENVS = ["", "1", "on", "true", "0", "off", "false", "OFF",
               '{"debounce_s": 2, "cooldown_s": 4}', "{nope", "[1, 2]",
               "@/no/such/file.json", "@FILE"]


@pytest.mark.parametrize("raw", CONFIG_ENVS)
def test_config_from_env_equals_jax(raw, tmp_path):
    if raw == "@FILE":
        path = tmp_path / "bb.json"
        path.write_text(json.dumps({"dir": str(tmp_path),
                                    "triggers": ["memory.pressure"]}))
        raw = f"@{path}"
    environ = {"CLIENT_TPU_BLACKBOX": raw} if raw else {}
    port, ref = _both(lambda m: dataclasses.asdict(
        m.BlackboxConfig.from_env(environ=environ)))
    assert port == ref


def test_resolved_dir_is_per_process():
    assert str(os.getpid()) in bb.BlackboxConfig().resolved_dir()
    assert bb.BlackboxConfig().resolved_dir() \
        != jax_bb.BlackboxConfig().resolved_dir()
    assert bb.BlackboxConfig(dir="/x/y").resolved_dir() == "/x/y"


# -- the bundle store -----------------------------------------------------------

STORE_CASES = {
    "count_cap": (dict(max_bundles=2), [None] * 4),
    "byte_cap": (dict(max_total_bytes=2048), [700] * 4),
    "mixed": (dict(max_bundles=3, max_total_bytes=3000),
              [100, 1500, 200, 900, 50]),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_bundle_store_evicts_as_jax(case, tmp_path):
    caps, pads = STORE_CASES[case]
    kept = []
    for side, mod in (("port", bb), ("jax", jax_bb)):
        store = mod.BundleStore(str(tmp_path / side), **caps)
        for i, pad in enumerate(pads):
            bundle_id = f"bb-1-{i:04d}-manual"
            body = json.dumps({"id": bundle_id, "pad": "x" * (pad or 0)})
            store.write(bundle_id, body.encode(), {"trigger": "manual"})
            # distinct mtimes make the eviction order deterministic
            os.utime(store._path(bundle_id), (i + 1.0, i + 1.0))
        kept.append(([m["id"] for m in store.list()], store.total_bytes()))
    assert kept[0] == kept[1]


def test_bundle_store_errors_equal_jax(tmp_path):
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "bb-9-0002-manual.json").write_bytes(b"{torn")
        (tmp_path / side / "bb-9-0003-manual.json").write_bytes(b"[1, 2]")
    for bundle_id in ("bb-9-0001-manual", "bb-9-0002-manual",
                      "bb-9-0003-manual", "../etc/passwd", "", ".hidden",
                      "a/b", "a b"):
        got = []
        for side, mod in (("port", bb), ("jax", jax_bb)):
            store = mod.BundleStore(str(tmp_path / side))
            try:
                got.append(("ok", store.load(bundle_id)))
            except (KeyError, ValueError) as exc:
                got.append((type(exc).__name__, str(exc).replace(
                    str(tmp_path / side), "DIR")))
        assert got[0] == got[1], bundle_id


# -- recorders under a fake clock ----------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """One engine of each package serving ``simple``, built with the
    blackbox off: the tests make their own recorders."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build

    old = os.environ.get("CLIENT_TPU_BLACKBOX")
    os.environ["CLIENT_TPU_BLACKBOX"] = "off"
    try:
        port = TorchEngine(build_repository(["simple"]), device="cpu")
        ref = TpuEngine(jax_build(["simple"]), warmup=False)
    finally:
        if old is None:
            os.environ.pop("CLIENT_TPU_BLACKBOX", None)
        else:
            os.environ["CLIENT_TPU_BLACKBOX"] = old
    yield SimpleNamespace(port=port, jax=ref)
    port.shutdown()
    ref.shutdown()


class _FakeMono:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


# (config, [(seconds to advance, category, name, detail), ...])
SEQUENCES = {
    "edge": ({}, [(0, "qos", "throttle", {"ratio": 0.5})]),
    "debounce": (dict(debounce_s=30.0), [
        (0, "qos", "throttle", {}), (10, "memory", "pressure", {}),
        (25, "memory", "pressure", {})]),
    "cooldown": (dict(debounce_s=1.0, cooldown_s=300.0), [
        (0, "qos", "throttle", {}), (100, "qos", "throttle", {}),
        (300, "qos", "throttle", {})]),
    "storm": (dict(storm_count=3, storm_window_s=10.0), [
        (0, "breaker", "open", {"model": "m"}),
        (1, "breaker", "open", {"model": "m"}),
        (1, "breaker", "open", {"model": "m"})]),
    "storm_expiry": (dict(storm_count=3, storm_window_s=10.0), [
        (0, "deadline", "expired", {}), (1, "deadline", "expired", {}),
        (61, "deadline", "expired", {})]),
    "burst_then_cooldown": (dict(storm_count=5, storm_window_s=10.0,
                                 debounce_s=1.0, cooldown_s=60.0), [
        (0.1, "deadline", "expired", {"model": "bert"})] * 5
        + [(2.0, "deadline", "expired", {"model": "bert"})] * 5
        + [(61.0, "deadline", "expired", {"model": "bert"})] * 5),
    "unconfigured": (dict(triggers=("fleet.rebalance",)), [
        (0, "qos", "throttle", {}), (0, "blackbox", "captured", {}),
        (0, "lifecycle", "server_start", {}),
        (0, "fleet", "rebalance", {})]),
    "fast_burn": ({}, [
        (0, "lifecycle", "health", {"state": "DEGRADED"}),
        (1, "lifecycle", "health", {"slo_fast_burn": ["simple"]}),
        (40, "lifecycle", "health", {"slo_fast_burn": ["simple"]})]),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_recorders_capture_and_suppress_as_jax(case, engines, tmp_path):
    cfg_kwargs, steps = SEQUENCES[case]
    trails, written = [], []
    for side, mod, journal, engine in (
            ("port", bb, port_events.journal(), engines.port),
            ("jax", jax_bb, jax_events.journal(), engines.jax)):
        mono = _FakeMono()
        rec = mod.BlackboxRecorder(
            engine, mod.BlackboxConfig(dir=str(tmp_path / side),
                                       post_window_s=0.0, **cfg_kwargs),
            mono=mono)
        rec._stop.set()  # synchronous: drain() is the capture
        trail = []
        for dt, category, name, detail in steps:
            mono.now += dt
            rec._on_event(journal.emit(category, name, **detail))
            trail.append((len(rec._pending), rec.suppressed,
                          [p[0] for p in rec._pending]))
        trails.append(trail)
        n = rec.drain()
        written.append((n, sorted(m["trigger"] for m in rec.store.list()),
                        rec.captures, rec.failures))
    assert trails[0] == trails[1]
    assert written[0] == written[1]


def test_capture_sections_equal_jax(engines, tmp_path):
    keys = []
    for side, mod, engine in (("port", bb, engines.port),
                              ("jax", jax_bb, engines.jax)):
        rec = mod.BlackboxRecorder(engine, mod.BlackboxConfig(
            dir=str(tmp_path / side), post_window_s=0.0))
        rec._stop.set()
        meta = rec.capture("manual", note="unit capture")
        bundle = rec.store.load(meta["id"])
        for name, sec in bundle["sections"].items():
            assert isinstance(sec, dict) and "error" not in sec, (side, name)
        keys.append((sorted(meta), sorted(bundle), sorted(bundle["sections"]),
                     sorted(bundle["sections"]["fingerprint"])))
        deduped = rec.capture("fleet.rebalance", respect_cooldown=True)
        again = rec.capture("fleet.rebalance", respect_cooldown=True)
        assert "deduped" not in deduped and again["deduped"]
        assert again["bundle"] == deduped["id"]
    assert keys[0] == keys[1]
    fp = rec.store.load(meta["id"])["sections"]["fingerprint"]
    assert "jax" in fp["versions"]
    port_fp = bb.fingerprint()
    assert "torch" in port_fp["versions"] and "jax" not in port_fp["versions"]
    assert "device" not in port_fp and bb.fingerprint("X")["device"] == "X"


def test_byte_cap_trims_as_jax(engines, tmp_path):
    got = []
    for side, mod, journal, engine in (
            ("port", bb, port_events.journal(), engines.port),
            ("jax", jax_bb, jax_events.journal(), engines.jax)):
        for i in range(80):
            journal.emit("lifecycle", "health", pad="x" * 120, i=i)
        rec = mod.BlackboxRecorder(engine, mod.BlackboxConfig(
            dir=str(tmp_path / side), post_window_s=0.0,
            max_bundle_bytes=4096, max_total_bytes=8192))
        meta = rec.capture("manual")
        assert meta["bytes"] <= 4096
        got.append("journal" in meta["truncated"])
    assert got == [True, True]


def test_engine_accessors_map_errors(engines, tmp_path):
    eng = engines.port
    rec = bb.BlackboxRecorder(eng, bb.BlackboxConfig(dir=str(tmp_path)))
    assert eng.blackbox is None
    for call in (eng.blackbox_bundles, eng.blackbox_capture):
        with pytest.raises(EngineError) as ei:
            call()
        assert ei.value.status == 400
    eng.blackbox = rec
    try:
        for bundle_id, status in (("bb-0-9999-none", 404),
                                  ("../etc/passwd", 400)):
            with pytest.raises(EngineError) as ei:
                eng.blackbox_bundles(bundle_id)
            assert ei.value.status == status
        with pytest.raises(EngineError) as ei:
            eng.blackbox_capture("qos.oops")
        assert ei.value.status == 400
    finally:
        eng.blackbox = None


def test_dead_engine_detaches_sink(tmp_path):
    class Husk:
        pass

    husk = Husk()
    rec = bb.BlackboxRecorder(husk, bb.BlackboxConfig(dir=str(tmp_path)))
    rec._stop.set()
    rec.install()
    journal = port_events.journal()
    assert rec._on_event in journal._sinks
    del husk
    gc.collect()
    journal.emit("qos", "throttle")
    assert rec._on_event not in journal._sinks and not rec._pending


# -- both servers -----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each package's engine with the blackbox on (a directory of its
    own) behind HTTP and gRPC."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu.server import GrpcInferenceServer as JaxGrpc
    from client_tpu.server import HttpInferenceServer as JaxHttp
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    root = tmp_path_factory.mktemp("bundles")
    sides = {}
    old = os.environ.get("CLIENT_TPU_BLACKBOX")
    try:
        for name, make, http_cls, grpc_cls in (
                ("port", lambda: TorchEngine(build_repository(["simple"]),
                                             device="cpu"),
                 HttpInferenceServer, GrpcInferenceServer),
                ("jax", lambda: TpuEngine(jax_build(["simple"]),
                                          warmup=False), JaxHttp, JaxGrpc)):
            os.environ["CLIENT_TPU_BLACKBOX"] = json.dumps(
                {"dir": str(root / name)})
            engine = make()
            sides[name] = SimpleNamespace(
                engine=engine, dir=root / name,
                http=http_cls(engine, port=0).start(),
                grpc=grpc_cls(engine, port=0).start())
    finally:
        if old is None:
            os.environ.pop("CLIENT_TPU_BLACKBOX", None)
        else:
            os.environ["CLIENT_TPU_BLACKBOX"] = old
    yield sides
    for side in sides.values():
        side.grpc.stop()
        side.http.stop()
        side.engine.shutdown()


def _http(side, method, path, body=None):
    req = urllib.request.Request(
        f"http://{side.http.url}{path}", method=method,
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _rpc(side, name, request):
    stub = grpc_stub.GRPCInferenceServiceStub(
        grpc.insecure_channel(side.grpc.url))
    try:
        return "OK", getattr(stub, name)(request, timeout=TIMEOUT)
    except grpc.RpcError as exc:
        return exc.code().name, exc.details()


def test_server_start_says_blackbox_on(served):
    for side in served.values():
        starts = [e for e in side.engine.events_export(
            category="lifecycle")["events"] if e["name"] == "server_start"]
        assert starts[-1]["detail"]["blackbox"] is True


def test_routes_and_rpcs_answer_as_jax(served):
    shapes = {}
    for name, side in served.items():
        status, meta = _http(side, "POST", "/v2/debug/capture",
                             {"note": "over http", "incident": "inc-x"})
        assert status == 200 and meta["incident"] == "inc-x"
        code, reply = _rpc(side, "BlackboxCapture",
                           ops.BlackboxCaptureRequest(note="over grpc"))
        assert code == "OK"
        gmeta = json.loads(reply.bundle_json)
        status, index = _http(side, "GET", "/v2/debug/bundles")
        code, reply = _rpc(side, "BlackboxBundles",
                           ops.BlackboxBundlesRequest())
        assert code == "OK"
        assert json.loads(reply.bundles_json)["bundles"] == index["bundles"]
        assert [b["id"] for b in index["bundles"]][:2] \
            == [gmeta["id"], meta["id"]]
        status, bundle = _http(side, "GET",
                               f"/v2/debug/bundles/{meta['id']}")
        code, reply = _rpc(side, "BlackboxBundles",
                           ops.BlackboxBundlesRequest(bundle_id=meta["id"]))
        assert json.loads(reply.bundles_json) == bundle
        for sec_name, sec in bundle["sections"].items():
            assert "error" not in sec, (name, sec_name)
        # an automatic trigger's name respects the cooldown
        first = _http(side, "POST", "/v2/debug/capture",
                      {"trigger": "memory.pressure"})[1]
        second = _http(side, "POST", "/v2/debug/capture",
                       {"trigger": "memory.pressure"})[1]
        (side.dir / "bb-1-0001-manual.json").write_bytes(b"{torn")
        errors = [
            _http(side, "GET", "/v2/debug/bundles/bb-0-9999-none")[0],
            _http(side, "GET", "/v2/debug/bundles/..bad")[0],
            _http(side, "GET", "/v2/debug/bundles/bb-1-0001-manual")[0],
            _http(side, "POST", "/v2/debug/capture",
                  {"trigger": "qos.oops"})[0],
            _http(side, "POST", "/v2/debug/capture", [1])[0],
            _rpc(side, "BlackboxBundles", ops.BlackboxBundlesRequest(
                bundle_id="bb-0-9999-none"))[0],
            _rpc(side, "BlackboxCapture", ops.BlackboxCaptureRequest(
                trigger="qos.oops"))[0],
        ]
        metrics = urllib.request.urlopen(
            f"http://{side.http.url}/metrics", timeout=TIMEOUT).read().decode()
        shapes[name] = (sorted(meta), sorted(index), sorted(bundle),
                        sorted(bundle["sections"]), "deduped" in first,
                        second.get("deduped"), errors,
                        sorted({line.split("{")[0].split(" ")[0]
                                for line in metrics.splitlines()
                                if line.startswith("tpu_blackbox")}))
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][6] == [404, 400, 400, 400, 400, "NOT_FOUND",
                                 "INVALID_ARGUMENT"]


def test_shutdown_removes_the_sink(tmp_path):
    old = os.environ.get("CLIENT_TPU_BLACKBOX")
    os.environ["CLIENT_TPU_BLACKBOX"] = json.dumps({"dir": str(tmp_path)})
    try:
        eng = TorchEngine(build_repository(["simple"]), device="cpu")
    finally:
        if old is None:
            os.environ.pop("CLIENT_TPU_BLACKBOX", None)
        else:
            os.environ["CLIENT_TPU_BLACKBOX"] = old
    rec = eng.blackbox
    assert rec._on_event in port_events.journal()._sinks
    eng.shutdown()
    assert rec._on_event not in port_events.journal()._sinks
    assert rec._thread is None or not rec._thread.is_alive()


# -- the crash hooks -----------------------------------------------------------

_CRASH = """
import gc, sys

from {pkg}.observability import blackbox
from {pkg}.observability.events import journal


def earlier(etype, value, tb):
    print("earlier hook ran", file=sys.stderr, flush=True)


sys.excepthook = earlier


class Husk:
    pass


eng = Husk()
rec = blackbox.BlackboxRecorder(
    eng, blackbox.BlackboxConfig.from_dict({{"dir": sys.argv[1]}}))
rec.install()
journal().emit("lifecycle", "server_start", models=0)
journal().emit("admission", "shed", severity="WARNING", model="m")
if sys.argv[2] == "gone":
    rec.close()
    del rec, eng
    gc.collect()
raise RuntimeError("boom for the blackbox")
"""


@pytest.mark.parametrize("recorder", ["live", "gone"])
def test_crash_hooks_as_jax(recorder, tmp_path):
    seen = []
    for pkg in ("client_tpu_torch", "client_tpu"):
        out = tmp_path / pkg
        proc = subprocess.run(
            [sys.executable, "-c", _CRASH.format(pkg=pkg), str(out),
             recorder], capture_output=True, text=True, timeout=120,
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode != 0
        crash_lines = [json.loads(line) for line in proc.stderr.splitlines()
                       if line.startswith('{"blackbox": "crash"')]
        files = sorted(os.listdir(out)) if out.exists() else []
        crash = [n for n in files if n.endswith("-crash.json")]
        bundle = (json.loads((out / crash[0]).read_bytes())
                  if crash else None)
        seen.append((
            "earlier hook ran" in proc.stderr,
            [(line["error"], [e["category"] for e in line["journal_tail"]
                              if e["category"] == "admission"])
             for line in crash_lines],
            len(crash), bundle["trigger"] if bundle else None,
            sorted(bundle["sections"]) if bundle else None,
            len([n for n in files if n.startswith("final_journal_")])))
    assert seen[0] == seen[1]
    chained, lines, n_crash, *_ = seen[0]
    assert chained and len(lines) == 1
    assert n_crash == (1 if recorder == "live" else 0)
