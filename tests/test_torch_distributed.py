"""The port's multi-process worlds (dba_mod_tpu_torch/parallel/
distributed.py) on the CPU, through real processes.

- initialize_distributed: a no-op without torchrun's environment,
  idempotent, explicit arguments beat the environment; the backend rule;
- a real 2-rank gloo world through ``python -m dba_mod_tpu_torch.main train
  --device cpu`` (MNIST, four rounds from the JAX package's initial model):
  both ranks end with bitwise the same model (their logged digests), only
  rank 0 writes the run folder, and the world's first round is held to
  the JAX package's single-device round at the ROADMAP bounds;
- the elastic harness (tests/test_elastic_harness.py's counterpart, with
  tight knobs): SIGKILL rank 1 once two rounds are committed; the survivor
  exits 77 well inside watchdog_hard_s, a verified snapshot is on disk,
  one relaunched process (``--resume auto``) finishes in the same folder
  with every round once, and the rows through the resume point are
  bitwise the uninterrupted world's. The uninterrupted world is run once a
  session and shared by both tests (a file of the session's shared temp
  directory under xdist, behind a lock);
- the host-loss fault lane across processes: the rank the lane draws
  SIGKILLs itself at the boundary, and the survivor exits 77.

The JAX package's own multi-process tests fail on this tree (ROADMAP
queue C), so the oracle is its single-device round.
"""
import fcntl
import json
import os
import pickle
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.models import build_model
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.parallel import distributed
from dba_mod_tpu_torch.utils.run_guard import EXIT_PEER_LOST

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 4
BASE_CFG = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=EPOCHS, no_models=4,
    number_of_total_participants=8, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=256, synthetic_test_size=128, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=True,
    random_seed=5, num_devices=-1, run_name="elastic", save_model=True,
    save_on_epochs=[1], graceful_shutdown=True, heartbeat_interval_s=0.2,
    heartbeat_timeout_s=1.2, watchdog_soft_s=10, watchdog_hard_s=20,
    resumed_model=True, resumed_model_name="init/model.pt.tar")
VOLATILE = {"time", "round_time", "dispatch_time", "finalize_time"}
_WORLD: dict = {}


# ------------------------------------------------- initialize_distributed
@pytest.fixture
def fake_dist(monkeypatch):
    """Isolate the module's init guard and torchrun's environment; record
    init_process_group calls instead of joining a group."""
    monkeypatch.setattr(distributed, "_initialized", False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            dict(kw, backend=backend)))
    monkeypatch.setattr(distributed.dist, "is_initialized",
                        lambda: bool(calls))
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda: calls[0]["world_size"])
    monkeypatch.setattr(distributed.dist, "get_rank",
                        lambda: calls[0]["rank"])
    return calls


def test_initialize_distributed_noop_without_env(fake_dist):
    assert distributed.initialize_distributed() is False
    assert fake_dist == [] and distributed._initialized is False
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_initialize_distributed_idempotent(fake_dist, monkeypatch):
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="1234",
                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    for _ in range(3):
        assert distributed.initialize_distributed(timeout_s=80.0) is True
    assert len(fake_dist) == 1
    call = fake_dist[0]
    assert call["init_method"] == "tcp://127.0.0.1:1234"
    assert (call["world_size"], call["rank"]) == (2, 1)
    assert call["backend"] == "gloo"
    assert call["timeout"].total_seconds() == 80.0
    assert distributed.world_size() == 2 and distributed.rank() == 1


def test_initialize_distributed_explicit_args_beat_env(fake_dist,
                                                        monkeypatch):
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="1111",
                     WORLD_SIZE="4", RANK="3").items():
        monkeypatch.setenv(k, v)
    distributed.initialize_distributed("tcp://10.0.0.1:2222", 2, 1)
    call = fake_dist[0]
    assert call["init_method"] == "tcp://10.0.0.1:2222"
    assert (call["world_size"], call["rank"]) == (2, 1)


def test_backend_rule_and_timeout():
    """NCCL only when every rank on the host has a card of its own; gloo
    on the CPU and when ranks share a card. The collectives' timeout sits
    above the watchdog's hard limit."""
    assert distributed.choose_backend("cpu", 2, 0)[0] == "gloo"
    assert distributed.choose_backend("cuda", 2, 1)[0] == "gloo"
    assert distributed.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert distributed.choose_backend("cuda", 4, 8)[0] == "nccl"
    assert distributed.process_group_timeout_s(0.0) is None
    assert distributed.process_group_timeout_s(20.0) > 20.0
    assert distributed.process_group_timeout_s(600.0) > 600.0


# --------------------------------------------------------------- worlds
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank=None, world=None, port=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if world is not None:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank))
    return env


def _write_cfg(root: Path, name: str) -> Path:
    """A world's YAML under `root`, resuming the JAX package's initial
    MNIST model (written once into root/ckpt/init)."""
    init = root / "ckpt" / "init" / "model.pt.tar"
    if not init.exists():
        jexp = JExperiment(JParams.from_dict(dict(
            BASE_CFG, resumed_model=False, num_devices=0)),
            save_results=False)
        jmv = jax.device_get(jexp.global_vars)
        tvars = convert.from_jax_numpy("MnistNet", jmv.params,
                                       jmv.batch_stats)
        ckpt.save_checkpoint(init, tvars, 0, float(BASE_CFG["lr"]))
    cfg = dict(BASE_CFG, run_dir=str(root / name),
               checkpoint_dir=str(root / "ckpt"))
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _launch(cfg_path, world, *extra):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "dba_mod_tpu_torch.main", "train",
         "--params", str(cfg_path), "--device", "cpu", *extra],
        cwd=REPO, env=_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _rows(run_dir: Path):
    with open(run_dir / "elastic" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def _strip(row):
    return {k: v for k, v in row.items() if k not in VOLATILE}


def _run_world(root: Path, during=None) -> dict:
    """The uninterrupted 2-rank world: rcs, outputs, the run folder's
    files, rows and the epoch-1 model; `during()` runs here while the
    ranks train, its result under "during"."""
    cfg_path = _write_cfg(root, "ref")
    t0 = time.monotonic()
    procs = _launch(cfg_path, 2)
    done = during() if during is not None else None
    outs = [p.communicate(timeout=600)[0] for p in procs]
    folder = root / "ref" / "elastic"
    like = build_model(Params.from_yaml(cfg_path)).init_vars(0, "cpu")
    return dict(
        rcs=[p.returncode for p in procs], outs=outs,
        seconds=time.monotonic() - t0,
        files=sorted(str(p.relative_to(folder)) for p in folder.rglob("*")
                     if "_peers" not in p.parts),
        rows=_rows(root / "ref"),
        epoch1=ckpt.load_checkpoint(
            folder / "model_last.pt.tar.epoch_1", like)[0],
        root=str(root), during=done)


def uninterrupted_world(tmp_path_factory, during=None) -> dict:
    """_run_world once a session: in the process, and under xdist in a
    file of the session's shared temp directory, behind a lock. The caller
    that launches the world runs `during()` while it trains; another gets
    "during": None."""
    if "world" in _WORLD:
        return dict(_WORLD["world"], during=None)
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _WORLD["world"] = _run_world(tmp_path_factory.mktemp("world"),
                                     during)
        return _WORLD["world"]
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / "torch_world.pkl"
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            root = shared / "torch_world"
            root.mkdir(exist_ok=True)
            world = _run_world(root, during)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(dict(world, during=None)))
            tmp.rename(path)
            _WORLD["world"] = world
            return world
        _WORLD["world"] = pickle.loads(path.read_bytes())
    return _WORLD["world"]


def _digests(out: str):
    return re.findall(r"global model sha256 ([0-9a-f]{64})", out)


def _jax_rounds(root: Path):
    """The JAX package's single-device run of the world's config from the
    same initial model: its global model after round 1, and each round's
    agents and accuracy."""
    jexp = JExperiment(JParams.from_dict(dict(
        BASE_CFG, resumed_model=False, save_model=False, num_devices=0,
        heartbeat_interval_s=0.0, run_dir=str(root / "jax"))),
        save_results=False)
    rounds = [jexp.run_round(1)]
    jg = jax.device_get(jexp.global_vars)
    rounds += [jexp.run_round(r) for r in range(2, EPOCHS + 1)]
    return jg, [([str(a) for a in r["agents"]], r["global_acc"])
                for r in rounds]


def test_two_rank_gloo_world_matches_jax_single_device(tmp_path_factory):
    """The JAX package's run goes on while the world trains, when this
    test launches the world."""
    root = tmp_path_factory.mktemp("jax")
    w = uninterrupted_world(tmp_path_factory,
                            during=lambda: _jax_rounds(root))
    for r, (rc, out) in enumerate(zip(w["rcs"], w["outs"])):
        assert rc == 0, f"rank {r} rc={rc}\n{out[-4000:]}"
        assert "backend gloo" in out
        assert f"final: epoch={EPOCHS}" in out
    # both ranks end with bitwise the same model, and log the same
    # per-round accuracies
    d0, d1 = (_digests(o) for o in w["outs"])
    assert len(d0) == 1 and d0 == d1
    acc = [re.findall(r"epoch (\d+) done in [\d.]+s acc=([\d.]+)", o)
           for o in w["outs"]]
    assert acc[0] == acc[1] and len(acc[0]) == EPOCHS
    # only rank 0 writes: the run folder holds one writer's files and
    # rank 1 logs no save
    assert "saved" not in w["outs"][1] and "saved" in w["outs"][0]
    assert {"metrics.jsonl", "round_result.csv", "train_result.csv",
            "model_last.pt.tar", "log.txt"} <= set(w["files"])
    assert [r["epoch"] for r in w["rows"]] == list(range(1, EPOCHS + 1))
    # the JAX package's single-device round from the same initial model
    jg, jrounds = w["during"] or _jax_rounds(root)
    tg = convert.to_jax_numpy("MnistNet", w["epoch1"])
    diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree_util.tree_leaves(tg),
                               jax.tree_util.tree_leaves(
                                   (jg.params, jg.batch_stats))))
    assert diff <= 1e-6, diff
    for (agents, acc), row in zip(jrounds, w["rows"]):
        assert agents == row["agents"]
        assert abs(acc - row["global_acc"]) <= 1.0


def test_peer_loss_exit77_then_shrunk_resume_bit_identical(
        tmp_path, tmp_path_factory):
    cfg_path = _write_cfg(tmp_path, "crash")
    run_dir = tmp_path / "crash"
    procs = _launch(cfg_path, 2)
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            ep = ckpt.manifest_epoch(run_dir / "elastic" /
                                     "model_last.pt.tar")
            if (ep or 0) >= 2:
                break
            if any(p.poll() is not None for p in procs):
                outs = [p.communicate(timeout=10)[0] for p in procs]
                pytest.fail("a rank died before the kill landed:\n"
                            + "\n".join(o[-2000:] for o in outs))
            time.sleep(0.05)
        procs[1].kill()    # SIGKILL: no handlers, no cleanup
        procs[1].wait(timeout=60)
        assert procs[1].returncode == -signal.SIGKILL
        t_kill = time.monotonic()
        out0, _ = procs[0].communicate(
            timeout=BASE_CFG["watchdog_hard_s"] + 40)
        waited = time.monotonic() - t_kill
        assert procs[0].returncode == EXIT_PEER_LOST, \
            f"survivor rc={procs[0].returncode}\n{out0[-4000:]}"
        assert "peer lost" in out0
        assert waited < BASE_CFG["watchdog_hard_s"] + 10, waited
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    resume_pt = ckpt.latest_verified_checkpoint(run_dir / "elastic",
                                                quarantine=False)
    assert resume_pt is not None, "no verified checkpoint survived"
    resume_epoch = ckpt.manifest_epoch(resume_pt)
    assert resume_epoch and resume_epoch >= 2

    # the survivors relaunched shrunk: one process
    proc = subprocess.run(
        [sys.executable, "-m", "dba_mod_tpu_torch.main", "train",
         "--params", str(cfg_path), "--device", "cpu", "--resume", "auto"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"final: epoch={EPOCHS}" in proc.stdout
    rows = _rows(run_dir)
    assert [r["epoch"] for r in rows] == list(range(1, EPOCHS + 1))
    ok, reason = ckpt.verify_checkpoint(run_dir / "elastic" /
                                        "model_last.pt.tar")
    assert ok, reason
    # the rows through the resume point are the uninterrupted world's
    ref = uninterrupted_world(tmp_path_factory)
    assert ref["rcs"] == [0, 0]
    for want, got in zip(ref["rows"][:resume_epoch], rows[:resume_epoch]):
        assert _strip(want) == _strip(got), want["epoch"]


def test_host_loss_lane_kills_its_victim_rank(tmp_path):
    """fault_host_loss_prob in a 2-rank world: at the epoch-1 boundary the
    rank the lane draws SIGKILLs itself (fl/experiment.py::
    _maybe_kill_self), and the survivor classifies the loss and exits
    77."""
    from dba_mod_tpu_torch.fl import faults as flt
    cfg = dict(BASE_CFG, resumed_model=False, save_model=False,
               local_eval=False, synthetic_train_size=64,
               synthetic_test_size=32, fault_injection=True,
               fault_host_loss_prob=1.0, fault_seed=3,
               run_dir=str(tmp_path / "runs"))
    path = tmp_path / "lane.yaml"
    path.write_text(yaml.safe_dump(cfg))
    fcfg = flt.FaultConfig(
        enabled=True, dropout_prob=0.0, corrupt_prob=0.0, blowup_prob=0.0,
        blowup_factor=1e8, stale_prob=0.0, seed=3, host_loss_prob=1.0,
        num_hosts=2, host_loss_in_program=False)
    victim = flt.host_loss_victim(fcfg, flt.fault_generator(3, 1))
    procs = _launch(path, 2, "--no-save")
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert procs[victim].returncode == -signal.SIGKILL, outs[victim][-3000:]
    assert "host-loss lane kills rank" in outs[victim]
    survivor = 1 - victim
    assert procs[survivor].returncode == EXIT_PEER_LOST, \
        outs[survivor][-3000:]
    assert "peer lost" in outs[survivor]
