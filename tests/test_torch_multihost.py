"""The port's multihost module and meshes that span processes, on the CPU.

The single-process cases of ``tests/test_parallel.py``'s ``TestMultihost``
run on ``client_tpu_torch.parallel.multihost``. Then two OS processes join
one gloo group (4 CPU shards each) and run ``tests/test_multihost.py``'s
worker step for step: the cross-process reduction, the dp x sp x tp train
step with dp across the processes, the pipeline with pp across them, the
MoE step with ep across them, served BERT with dp across them, and
expert-parallel decode of 4 tokens with ep across them. A third process
runs the same sequence on a one-process mesh of ``["cpu"] * 8`` with the
same axis sizes. The results are held to it:

- losses, served logits and token streams bit for bit, in both processes;
- every gradient within 1e-5 of the leaf's largest magnitude (relative),
  so a gradient scaled by the process count fails, and the parameters
  after the step within 2 x lr: Adam's step from a gradient that
  differs by a rounding (``tests/test_torch_training.py``);
- both processes end the step with the same parameters, bit for bit.

The group's collectives time out after 120 s and each process after
300 s, so a process out of lockstep fails the test instead of holding the
suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from client_tpu_torch.parallel import mesh as tmesh
from client_tpu_torch.parallel import multihost

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
LR = 1e-3
REL = 1e-5

_WORKER = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
mode, outdir = sys.argv[1], sys.argv[2]

from client_tpu_torch.parallel import mesh as mm
from client_tpu_torch.parallel import multihost
from client_tpu_torch.parallel.training import tree_leaves

if mode == "proc":
    pid, port = int(sys.argv[3]), sys.argv[4]
    got = multihost.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu",
                               timeout_s=120)
    assert got == pid, (got, pid)
    assert multihost.process_count() == 2
    per_proc = 4
else:
    pid, per_proc = 0, 8
tag = f"{mode} {pid}"


def gmesh(axes, shape):
    return multihost.global_mesh(axes=axes, shape=shape,
                                 devices=["cpu"] * per_proc)


saved = {}

# -- cross-process sharded reduction ------------------------------------------
mesh = gmesh(("dp", "tp"), {"dp": 2})
assert mesh.shape == {"dp": 2, "tp": 4}, mesh.shape
if mode == "proc":
    local = np.full((8, 4), pid + 1, np.float32)  # each process its own rows
else:
    local = np.concatenate([np.full((8, 4), 1, np.float32),
                            np.full((8, 4), 2, np.float32)])
arr = multihost.host_local_array((16, 4), mm.P("dp", None), local, mesh)
total = mm.psum(mesh, [p.sum() for p in arr.along("dp")], "dp")
assert float(total) == 8 * 4 * 1 + 8 * 4 * 2, float(total)
print(f"{tag}: reduction OK", flush=True)


def keep(name, loss, params, grads):
    saved[f"{name}/loss"] = np.float32(loss)
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        saved[f"{name}/param{i}"] = p.numpy()
        saved[f"{name}/grad{i}"] = g.numpy()


# -- the train step, dp across the processes ----------------------------------
from client_tpu_torch.parallel.training import make_train_step

train_mesh = gmesh(("dp", "sp", "tp"), {"dp": 2, "sp": 2})
params, opt, step, _ = make_train_step(train_mesh)
tokens = np.random.default_rng(0).integers(0, 256, size=(8, 32))
params, opt, loss = step(params, opt, tokens)
assert np.isfinite(float(loss))
keep("train", loss, params, step.last_grads)
print(f"{tag}: train step OK", flush=True)

# -- pipeline stages split across the processes -------------------------------
from client_tpu_torch.parallel.pipeline import make_pipeline_train_step

pp_mesh = gmesh(("pp", "dp"), {"pp": 2})
assert pp_mesh.shape == {"pp": 2, "dp": 4}
pparams, popt, pstep, pshard = make_pipeline_train_step(pp_mesh, n_layers=2)
ptokens = pshard(np.random.default_rng(0).integers(0, 256, size=(3, 4, 17)))
pparams, popt, ploss = pstep(pparams, popt, ptokens)
assert np.isfinite(float(ploss))
keep("pipeline", ploss, pparams, pstep.last_grads)
print(f"{tag}: cross-host pipeline step OK", flush=True)

# -- experts split across the processes ---------------------------------------
from client_tpu_torch.parallel.moe import make_moe_train_step

ep_mesh = gmesh(("ep", "dp", "tp"), {"ep": 2, "dp": 2})
assert ep_mesh.shape["ep"] == 2
mparams, mopt, mstep, _ = make_moe_train_step(ep_mesh, batch=8, seq=16)
mtokens = np.random.default_rng(1).integers(0, 256, size=(8, 16))
mparams, mopt, mloss = mstep(mparams, mopt, mtokens)
assert np.isfinite(float(mloss))
keep("moe", mloss, mparams, mstep.last_grads)
print(f"{tag}: cross-host MoE step OK", flush=True)

# -- served inference through the engine, dp across the processes -------------
from client_tpu_torch.engine import InferRequest, TorchEngine
from client_tpu_torch.engine.repository import ModelRepository
from client_tpu_torch.graft_entry import stream
from client_tpu_torch.parallel.serving import MoeGptBackend, ShardedBertBackend


def engine_of(backend):
    repo = ModelRepository()
    repo.register(backend.config.name, lambda _dev: backend)
    return TorchEngine(repo, device="cpu")


backend = ShardedBertBackend(
    mesh, name="bert_mh", seq_len=16, hidden=64, n_layers=2, n_heads=4,
    ffn=128, vocab=512, max_batch_size=8, device="cpu")
engine = engine_of(backend)
try:
    ids = np.ones((2, 16), dtype=np.int32) * 3  # the same in every process
    mask = np.ones((2, 16), dtype=np.int32)
    resp = engine.infer(InferRequest(
        model_name="bert_mh",
        inputs={"input_ids": ids, "attention_mask": mask}), timeout_s=300)
    logits = np.asarray(resp.outputs["logits"])
    assert logits.shape == (2, 2) and np.isfinite(logits).all()
    saved["bert/logits"] = logits
finally:
    engine.shutdown()
print(f"{tag}: served inference OK", flush=True)

# -- expert-parallel generative decode across the processes -------------------
# One stream, a fixed budget, greedy: both processes dispatch the same
# prefill and waves in the same order, each engine on its own process.
gen_mesh = gmesh(("ep", "tp"), {"ep": 2})
assert gen_mesh.shape["ep"] == 2
gbackend = MoeGptBackend(gen_mesh, name="moe_gpt_mh", n_layers=2,
                         d_model=64, n_heads=4, d_ff=128, vocab=256,
                         max_seq_len=32, max_streams=1, device="cpu")
gengine = engine_of(gbackend)
try:
    toks = stream(gengine, "moe_gpt_mh", [1, 2, 3], 4)
    assert len(toks) == 4, toks
finally:
    gengine.shutdown()
saved["decode/tokens"] = np.asarray(toks, np.int64)
print(f"{tag}: cross-host expert decode OK tokens={toks}", flush=True)
np.savez(f"{outdir}/{mode}{pid}.npz", **saved)
print(f"{tag}: ALL OK", flush=True)
"""


def _free_port() -> str:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return str(sk.getsockname()[1])


def _env():
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1",
               CLIENT_TPU_BLACKBOX="off")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(key, None)
    return env


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """The worker in two gloo processes and on the one-process mesh, all
    three at once; their outputs and saved arrays."""
    out = tmp_path_factory.mktemp("multihost")
    port = _free_port()
    cmds = [[sys.executable, "-c", _WORKER, "proc", str(out), str(pid), port]
            for pid in (0, 1)]
    cmds.append([sys.executable, "-c", _WORKER, "single", str(out)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=_env(),
                              cwd=REPO_ROOT) for c in cmds]
    logs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=300)
            logs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    saved = [dict(np.load(out / f"{n}.npz"))
             for n in ("proc0", "proc1", "single0")]
    return logs, saved


def test_two_processes_run_the_worker(two_process_run):
    logs, _ = two_process_run
    for tag, text in zip(("proc 0", "proc 1", "single 0"), logs):
        for step in ("reduction", "train step", "cross-host pipeline step",
                     "cross-host MoE step", "served inference",
                     "cross-host expert decode", "ALL"):
            assert f"{tag}: {step} OK" in text, text[-3000:]


@pytest.mark.parametrize("key", ["train/loss", "pipeline/loss", "moe/loss",
                                 "bert/logits", "decode/tokens"])
def test_results_equal_the_one_process_mesh_bit_for_bit(two_process_run,
                                                        key):
    _, (p0, p1, single) = two_process_run
    np.testing.assert_array_equal(p0[key], single[key])
    np.testing.assert_array_equal(p1[key], single[key])


@pytest.mark.parametrize("name", ["train", "pipeline", "moe"])
def test_gradients_are_not_scaled_by_the_process_count(two_process_run,
                                                       name):
    _, (p0, p1, single) = two_process_run
    grads = sorted(k for k in single if k.startswith(f"{name}/grad"))
    assert grads
    for key in grads:
        want = single[key]
        scale = max(float(np.abs(want).max()), 1e-30)
        for got in (p0[key], p1[key]):
            err = float(np.abs(got - want).max())
            assert err <= REL * scale, f"{key}: {err} vs {scale}"


@pytest.mark.parametrize("name", ["train", "pipeline", "moe"])
def test_one_step_parameters(two_process_run, name):
    """Both processes hold the same whole parameters after the step, within
    the training tolerance of the one-process step."""
    _, (p0, p1, single) = two_process_run
    params = sorted(k for k in single if k.startswith(f"{name}/param"))
    assert params
    for key in params:
        np.testing.assert_array_equal(p0[key], p1[key])
        assert float(np.abs(p0[key] - single[key]).max()) <= 2 * LR, key


# -- the single-process cases of tests/test_parallel.py -----------------------


class TestMultihost:
    def test_global_mesh_and_host_local_array(self):
        """Single-process instance of the multi-host pattern: global mesh
        over all devices, per-process batch assembly, a reduction."""
        assert multihost.process_count() == 1
        mesh = multihost.global_mesh(axes=("dp", "tp"), devices=CPU8)
        assert set(mesh.shape) == {"dp", "tp"}
        local = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
        arr = multihost.host_local_array((16, 4), tmesh.P("dp", None), local,
                                         mesh)
        assert [tuple(p.shape) for p in arr.along("dp")] == [
            (16 // mesh.shape["dp"], 4)] * mesh.shape["dp"]
        total = tmesh.psum(mesh, [p.sum() for p in arr.along("dp")], "dp")
        assert float(total) == float(local.sum())

    def test_global_mesh_pinned_shape(self):
        mesh = multihost.global_mesh(axes=("dp", "tp"),
                                     shape={"dp": 4, "tp": 2}, devices=CPU8)
        assert mesh.shape["dp"] == 4 and mesh.shape["tp"] == 2
        # Partial pin: the free axis size is inferred from the device count.
        mesh = multihost.global_mesh(axes=("dp", "tp"), shape={"dp": 2},
                                     devices=CPU8)
        assert mesh.shape["dp"] == 2 and mesh.shape["tp"] == 4

    def test_global_mesh_raises_as_jax_does(self):
        with pytest.raises(ValueError, match="do not divide 8 devices"):
            multihost.global_mesh(axes=("dp", "tp"), shape={"dp": 3},
                                  devices=CPU8)
        with pytest.raises(ValueError, match="at most one axis may be left"):
            multihost.global_mesh(axes=("dp", "sp", "tp"), shape={"dp": 2},
                                  devices=CPU8)

    def test_host_local_array_refuses_a_wrong_block(self):
        mesh = multihost.global_mesh(axes=("dp", "tp"), devices=CPU8)
        with pytest.raises(ValueError, match="owns a"):
            multihost.host_local_array((16, 4), tmesh.P("dp", None),
                                       np.zeros((8, 4)), mesh)

    def test_initialize_single_process(self):
        """The process group's single-process bring-up in a clean
        interpreter; a second call is idempotent."""
        code = (
            "from client_tpu_torch.parallel import multihost\n"
            f"pid = multihost.initialize('127.0.0.1:{_free_port()}', 1, 0,"
            " device='cpu', timeout_s=60)\n"
            "assert pid == 0, pid\n"
            "assert multihost.process_count() == 1\n"
            "pid2 = multihost.initialize()\n"
            "assert pid2 == 0  # idempotent\n"
            "print('MULTIHOST-OK')\n"
        )
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120,
                              env=_env(), cwd=REPO_ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "MULTIHOST-OK" in proc.stdout

    def test_initialize_reads_torch_environment(self):
        code = (
            "from client_tpu_torch.parallel import multihost\n"
            "assert multihost.initialize(device='cpu', timeout_s=60) == 0\n"
            "assert multihost.process_count() == 1\n"
            "print('ENV-OK')\n"
        )
        env = dict(_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=_free_port(),
                   WORLD_SIZE="1", RANK="0")
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120,
                              env=env, cwd=REPO_ROOT)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "ENV-OK" in proc.stdout

    def test_initialize_without_arguments_raises(self):
        code = (
            "from client_tpu_torch.parallel import multihost\n"
            "try:\n"
            "    multihost.initialize(device='cpu')\n"
            "except ValueError as exc:\n"
            "    print('RAISED', exc)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120,
                              env=_env(), cwd=REPO_ROOT)
        assert "RAISED initialize needs" in proc.stdout, proc.stderr

    def test_initialize_on_the_card_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a card")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.initialize("127.0.0.1:1", 1, 0)


def test_a_mesh_spans_processes_along_one_axis():
    grid = np.empty((2, 4), dtype=object)
    grid[:] = torch.device("cpu")
    ranks = np.repeat([[0], [1]], 4, axis=1)
    m = tmesh.Mesh(grid, ("dp", "tp"), ranks, rank=1)
    assert m.process_axis == "dp" and m.local("dp") == range(1, 2)
    assert m.local("tp") == range(4) and m.crosses("dp")
    with pytest.raises(NotImplementedError, match="along 'dp'|not 'dp'"):
        m.check_crossing(("ep",), "a family")
    with pytest.raises(NotImplementedError, match="one axis only"):
        tmesh.Mesh(grid, ("dp", "tp"), np.arange(8).reshape(2, 4) % 2, 0)
    placed = tmesh.place(m, torch.arange(16.0).reshape(8, 2), ("dp", None))
    assert [p.tolist() for p in placed.along("dp")] == [
        [[8.0, 9.0], [10.0, 11.0], [12.0, 13.0], [14.0, 15.0]]]
    assert tmesh.split(m, torch.arange(8.0), 0, "dp")[0].tolist() == [
        4.0, 5.0, 6.0, 7.0]


def test_families_refuse_an_axis_they_cannot_span():
    grid = np.empty((2, 4), dtype=object)
    grid[:] = torch.device("cpu")
    ranks = np.repeat([[0], [1]], 4, axis=1)
    from client_tpu_torch.parallel import serving as sv
    from client_tpu_torch.parallel.training import make_train_step

    m = tmesh.Mesh(grid, ("tp", "dp"), ranks, rank=0)
    with pytest.raises(NotImplementedError, match="across processes"):
        sv.ShardedTinyGptBackend(m, n_layers=1, d_model=32, n_heads=4,
                                 d_ff=64, vocab=32, max_seq_len=16,
                                 max_streams=2, device="cpu")
    with pytest.raises(NotImplementedError, match="across processes"):
        make_train_step(m)
