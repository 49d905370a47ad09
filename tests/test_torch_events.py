"""The port's event journal held against the JAX package's.

The same emits, on journals with the same injected clocks, give equal
snapshots and exports under every filter (exact: the journal copies
values, it computes nothing), the same errors, the same capacity
handling and the same JSON log lines. Both engines' journals record the
same model lifecycle events for the same load and unload.
"""

import io
import json

import numpy as np
import pytest

from client_tpu.observability import events as jax_events
from client_tpu_torch.observability import events as port_events

# (category, name, severity, model, version, trace_id, detail)
SCRIPT = [
    ("lifecycle", "server_start", "INFO", None, None, None, {"models": 3}),
    ("model", "load", "INFO", "simple", 1, None, {}),
    ("model", "load", "INFO", "bert", 2, None, {}),
    ("fault", "injected", "WARNING", None, None, None,
     {"site": "model.execute", "kind": "error"}),
    ("compile", "finished", "INFO", "bert", "2", "a" * 32,
     {"bucket": 4, "compile_s": 0.25}),
    ("deadline", "expired", "WARNING", "simple", "1", "b" * 32,
     {"stage": "queue"}),
    ("lifecycle", "model_load_failed", "ERROR", "ssd", None, None,
     {"error": "no weights"}),
    ("model", "unload", "INFO", "simple", None, None,
     {"versions": ["1"]}),
    ("debug", "note", "DEBUG", "bert", "2", None, {"x": 1}),
]


def _journal(mod, capacity=16):
    ticks = iter(range(1000))
    wall = iter(np.arange(1000) * 0.5 + 100.0)
    j = mod.EventJournal(capacity=capacity, clock=lambda: float(next(wall)),
                         mono_ns=lambda: next(ticks) * 1000)
    for cat, name, sev, model, version, trace_id, detail in SCRIPT:
        j.emit(cat, name, severity=sev, model=model, version=version,
               trace_id=trace_id, **detail)
    return j


FILTERS = [
    {}, {"model": "bert"}, {"model": "simple"}, {"model": "none"},
    {"severity": "debug"}, {"severity": "INFO"}, {"severity": "warning"},
    {"severity": "ERROR"}, {"category": "model"}, {"category": "fault"},
    {"since_seq": 3}, {"since_seq": 9}, {"since_ts": 101.0},
    {"until_ts": 101.5}, {"since_ts": 100.5, "until_ts": 102.0},
    {"limit": 2}, {"limit": 0}, {"limit": -1},
    {"model": "bert", "severity": "INFO", "limit": 1},
    {"category": "model", "since_seq": 2, "until_ts": 103.0},
]


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: json.dumps(f))
def test_export_under_each_filter_equals_jax(filters):
    assert _journal(port_events).export(**filters) \
        == _journal(jax_events).export(**filters)


@pytest.mark.parametrize("filters", FILTERS[:8], ids=lambda f: json.dumps(f))
def test_snapshot_events_equal_jax(filters):
    port = [e.to_dict() for e in _journal(port_events).snapshot(**filters)]
    ref = [e.to_dict() for e in _journal(jax_events).snapshot(**filters)]
    assert port == ref


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared below
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("call", [
    lambda j: j.emit("x", "y", severity="LOUD"),
    lambda j: j.snapshot(severity="verbose"),
    lambda j: j.export(severity=""),
], ids=["emit", "snapshot", "export"])
def test_unknown_severity_words_equal_jax(call):
    port = _error(lambda: call(_journal(port_events)))
    assert port is not None and port == _error(
        lambda: call(_journal(jax_events)))


@pytest.mark.parametrize("capacity", [1, 3, 9, 100])
def test_overflow_and_clear_equal_jax(capacity):
    def run(mod):
        j = _journal(mod, capacity)
        before = (len(j), j.dropped(), j.export())
        j.clear()
        j.emit("model", "load", model="m")
        return before, len(j), j.dropped(), j.export()["next_seq"]

    assert run(port_events) == run(jax_events)


@pytest.mark.parametrize("raw", [None, "", "5", " 7 ", "0", "-3", "bad"])
def test_capacity_from_the_environment_equals_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("CLIENT_TPU_EVENT_BUFFER", raising=False)
    else:
        monkeypatch.setenv("CLIENT_TPU_EVENT_BUFFER", raw)
    assert port_events.EventJournal().capacity \
        == jax_events.EventJournal().capacity


def test_json_log_sink_lines_equal_jax():
    """``CLIENT_TPU_LOG=json``: the event lines on the stream are the
    same objects (the handler goes on each package's own logger)."""
    lines = []
    for mod in (port_events, jax_events):
        out = io.StringIO()
        j = mod.EventJournal(capacity=8, clock=lambda: 5.0,
                             mono_ns=lambda: 7)
        assert mod.configure_logging({"CLIENT_TPU_LOG": "json"}, out, j)
        j.emit("fault", "injected", site="http.pre_read", kind="drop")
        j.emit("model", "load", model="m", version=3, trace_id="c" * 32)
        lines.append([json.loads(x) for x in out.getvalue().splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 2


@pytest.mark.parametrize("value", ["", "text", "JSON2"])
def test_log_sink_off_unless_json_as_in_jax(value):
    env = {"CLIENT_TPU_LOG": value}
    assert port_events.configure_logging(env, io.StringIO()) \
        == jax_events.configure_logging(env, io.StringIO()) is False


def test_global_journal_is_one_object_until_reset():
    j = port_events.journal()
    assert port_events.journal() is j
    port_events.reset_journal()
    assert port_events.journal() is not j


def test_engine_lifecycle_events_equal_jax():
    """Both engines journal ``model.load`` with the version and
    ``model.unload`` with the versions for the same load and unload, and
    ``lifecycle.server_start`` with the same detail keys."""
    from client_tpu.engine import TpuEngine
    from client_tpu.models import build_repository as jax_build
    from client_tpu_torch.engine import TorchEngine
    from client_tpu_torch.models import build_repository

    seen = []
    for journal_of, make in (
            (port_events.journal,
             lambda: TorchEngine(build_repository(["simple"]),
                                 device="cpu")),
            (jax_events.journal,
             lambda: TpuEngine(jax_build(["simple"])))):
        cursor = journal_of().export()["next_seq"]
        engine = make()
        try:
            engine.unload_model("simple")
            engine.load_model("simple")
        finally:
            engine.shutdown()
        got = journal_of().export(since_seq=cursor)["events"]
        seen.append([
            (e["category"], e["name"], e.get("model"), e.get("version"),
             sorted(e.get("detail", {})))
            for e in got if e["category"] in ("model", "lifecycle")
            and e["name"] != "health"])
    assert seen[0] == seen[1]
    assert [s[:2] for s in seen[0]] == [
        ("lifecycle", "server_start"), ("model", "load"),
        ("model", "unload"), ("model", "load"),
        ("lifecycle", "server_shutdown")]
