"""The port's elastic layer units (tests/test_elastic.py's counterparts):
PeerHealth liveness and barrier, the watchdog's peer-lost verdict (77 vs
76), the guard's attach/detach, the host-loss fault lane (a victim per
epoch, its slice, counted padding, no reshuffle of the client lanes, knob
validation, the single-process warning), the knobs' no-op contract in one
process, and a single-process host-loss round held to the JAX package's
round with the JAX package's fault plan handed to the port.

Heartbeat intervals here are at most 0.2 s.
"""
import json
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl import faults as jflt
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl import faults as flt
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.parallel.distributed import PeerHealth, PeerLostError
from dba_mod_tpu_torch.utils.run_guard import (EXIT_PEER_LOST, EXIT_WATCHDOG,
                                               RunGuard, Watchdog)

torch.set_num_threads(1)


# ------------------------------------------------------------- PeerHealth
def _pair(tmp_path, interval=0.05, timeout=0.2):
    a = PeerHealth(tmp_path, 0, 2, interval_s=interval, timeout_s=timeout)
    b = PeerHealth(tmp_path, 1, 2, interval_s=interval, timeout_s=timeout)
    return a, b


def test_peer_health_beats_and_sees_live_peer(tmp_path):
    a, b = _pair(tmp_path)
    a.start(), b.start()
    try:
        assert a.lost_peers() == [] and b.lost_peers() == []
        assert (tmp_path / "host_0.json").exists()
        assert (tmp_path / "host_1.json").exists()
    finally:
        a.stop(), b.stop()


def test_peer_health_detects_stale_peer_past_grace(tmp_path):
    a, b = _pair(tmp_path, interval=0.05, timeout=0.15)
    a.start(), b.start()
    try:
        b._stop.set()            # b's beat thread dies (the "kill")
        b._thread.join(1.0)
        assert a.lost_peers(now=time.time() + 10.0) == [1]
        a._started_wall -= 10.0  # past the startup grace in real time too
        time.sleep(0.3)          # real staleness
        with pytest.raises(PeerLostError, match=r"\[1\]"):
            a.check(3)
    finally:
        a._stop.set()
        b._started_wall = None
        a.stop(), b.stop()


def test_peer_health_stopped_beat_is_not_a_loss(tmp_path):
    a, b = _pair(tmp_path, timeout=0.15)
    a.start(), b.start()
    b.stop()                     # clean exit: final beat marked stopped
    try:
        assert a.lost_peers(now=time.time() + 10.0) == []
    finally:
        a.stop()


def test_peer_health_ignores_other_generation_files(tmp_path):
    stale = {"pid": 1, "gen": 2, "time": time.time(),
             "boundary_epoch": 5, "ospid": 1, "stopped": False}
    (tmp_path / "host_1.json").write_text(json.dumps(stale))
    a = PeerHealth(tmp_path, 0, 3, interval_s=0.05, timeout_s=0.2)
    a.start()
    try:
        assert a._read(1) is None          # another generation
        assert a.lost_peers() == []        # inside the startup grace
        assert 1 in a.lost_peers(now=time.time() + 10.0)
    finally:
        a.stop()


def test_peer_health_barrier_reaches_and_times_out(tmp_path):
    a, b = _pair(tmp_path, interval=0.05, timeout=5.0)
    a.start(), b.start()
    try:
        b.beat(boundary_epoch=4)
        assert a.barrier(4, timeout=2.0) is True
        t0 = time.monotonic()
        assert a.barrier(5, timeout=0.2) is False   # slow, not gone
        assert time.monotonic() - t0 < 2.0
    finally:
        a.stop(), b.stop()


def test_peer_health_barrier_raises_on_dead_peer(tmp_path):
    a, b = _pair(tmp_path, interval=0.05, timeout=0.15)
    a.start(), b.start()
    b._stop.set()
    b._thread.join(1.0)
    try:
        time.sleep(0.3)
        a._started_wall -= 10.0
        with pytest.raises(PeerLostError):
            a.barrier(5, timeout=3.0)
    finally:
        b._started_wall = None
        a.stop(), b.stop()


def test_lost_peer_counts_heartbeat_missed_once(tmp_path):
    """peer/heartbeat_missed counts each newly lost peer once."""
    from dba_mod_tpu_torch.utils import telemetry
    t = telemetry.configure(enabled=True, folder=None)
    a, b = _pair(tmp_path, interval=0.05, timeout=0.15)
    a.start(), b.start()
    b._stop.set()
    b._thread.join(1.0)
    try:
        future = time.time() + 10.0
        assert a.lost_peers(now=future) == [1]
        assert a.lost_peers(now=future) == [1]
        assert t.counter("peer/heartbeat_missed").value == 1
    finally:
        b._started_wall = None
        a.stop(), b.stop()
        telemetry.configure(enabled=False, folder=None)


# ------------------------------------------------- the watchdog's verdict
def test_watchdog_verdict_peer_lost_vs_generic():
    wd = Watchdog(soft_s=0.1, hard_s=0.2)
    assert wd.abort_verdict() == (EXIT_WATCHDOG, [])
    wd.peer_probe = lambda: [1]
    assert wd.abort_verdict() == (EXIT_PEER_LOST, [1])
    wd.peer_probe = lambda: []
    assert wd.abort_verdict() == (EXIT_WATCHDOG, [])

    def boom():
        raise RuntimeError("probe broke")
    wd.peer_probe = boom          # a probe failure never masks the abort
    assert wd.abort_verdict() == (EXIT_WATCHDOG, [])


def test_watchdog_hard_stall_with_stale_peer_aborts_77():
    """A zone stalled past hard_s while the probe reports a lost peer:
    the abort is called once, with the verdict (77, [1]) recorded."""
    fired = []
    wd = Watchdog(soft_s=0.05, hard_s=0.1, on_hard=lambda: fired.append(
        wd._verdict))
    wd.peer_probe = lambda: [1]
    with wd.zone("round/all_gather"):
        time.sleep(0.6)
    assert fired == [(EXIT_PEER_LOST, [1])]
    assert wd.hard_aborts == 1


def test_runguard_attach_detach_peer_health(tmp_path):
    guard = RunGuard(watchdog_soft_s=1.0, watchdog_hard_s=2.0)
    ph = PeerHealth(tmp_path, 0, 2, interval_s=0.05, timeout_s=0.2)
    guard.attach_peer_health(ph)
    assert guard.watchdog.peer_probe == ph.lost_peers
    guard.attach_peer_health(None)
    assert guard.watchdog.peer_probe is None


# ------------------------------------------------------ host-loss lane
def _fcfg(**kw):
    base = dict(enabled=True, dropout_prob=0.0, corrupt_prob=0.0,
                blowup_prob=0.0, blowup_factor=1e8, stale_prob=0.0,
                seed=7, host_loss_prob=1.0, num_hosts=4,
                host_loss_in_program=True)
    base.update(kw)
    return flt.FaultConfig(**base)


def test_host_loss_victim_is_deterministic_per_epoch():
    fcfg = _fcfg(host_loss_prob=0.5)
    victims = [flt.host_loss_victim(fcfg, flt.fault_generator(7, e))
               for e in range(1, 30)]
    again = [flt.host_loss_victim(fcfg, flt.fault_generator(7, e))
             for e in range(1, 30)]
    assert victims == again                   # pure f(fault_seed, epoch)
    assert any(v == -1 for v in victims)      # some rounds lose no host
    assert any(v >= 0 for v in victims)
    assert all(-1 <= v < 4 for v in victims)
    # the draw consumes nothing of the round's client-lane stream
    g = flt.fault_generator(7, 3)
    flt.host_loss_victim(fcfg, g)
    assert torch.equal(torch.rand(5, generator=g),
                       torch.rand(5, generator=flt.fault_generator(7, 3)))


def test_host_loss_drops_exactly_the_victims_slice():
    fcfg = _fcfg(num_hosts=2, host_loss_prob=1.0, corrupt_prob=0.5)
    counted = torch.ones(8, dtype=torch.bool)
    plan = flt.make_fault_plan(fcfg, flt.fault_generator(7, 3), counted)
    victim = flt.host_loss_victim(fcfg, flt.fault_generator(7, 3))
    hosts = flt.host_of_lane(8, 2)
    assert torch.equal(plan.dropped, hosts == victim)
    assert int(plan.dropped.sum()) == 4
    # the other lanes never double-book a host-dropped client
    assert not bool((plan.corrupt & plan.dropped).any())


def test_host_loss_respects_counted_padding():
    fcfg = _fcfg(num_hosts=2, host_loss_prob=1.0)
    counted = torch.tensor([True] * 6 + [False] * 2)   # 2 inert pad lanes
    for e in range(1, 8):
        plan = flt.make_fault_plan(fcfg, flt.fault_generator(7, e), counted)
        assert not bool((plan.dropped & ~counted).any())
        # the victim's slice is the host_of_lane partition of the PADDED
        # axis (the partition the ranks own), cut to the counted lanes
        v = flt.host_loss_victim(fcfg, flt.fault_generator(7, e))
        want = (np.asarray(jflt.host_of_lane(8, 2)) == v) & \
            counted.numpy()
        np.testing.assert_array_equal(plan.dropped.numpy(), want)


def test_host_loss_off_leaves_existing_plans_unchanged():
    counted = torch.ones(16, dtype=torch.bool)
    legacy = flt.FaultConfig(enabled=True, dropout_prob=0.3,
                             corrupt_prob=0.2, blowup_prob=0.1,
                             blowup_factor=1e8, stale_prob=0.2, seed=11)
    with_lane = flt.FaultConfig(enabled=True, dropout_prob=0.3,
                                corrupt_prob=0.2, blowup_prob=0.1,
                                blowup_factor=1e8, stale_prob=0.2, seed=11,
                                host_loss_prob=0.0, num_hosts=4,
                                host_loss_in_program=True)
    p1 = flt.make_fault_plan(legacy, flt.fault_generator(11, 2), counted)
    p2 = flt.make_fault_plan(with_lane, flt.fault_generator(11, 2),
                             counted)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)


def test_host_of_lane_matches_jax():
    """On the grid tests/test_torch_mesh.py partitions: every lane count
    (and its double, for two devices a rank) over one to four hosts."""
    for c in (1, 5, 6, 7, 10, 16, 17):
        for h in (1, 2, 3, 4):
            for n in (c, 2 * c):
                np.testing.assert_array_equal(
                    flt.host_of_lane(n, h).numpy(),
                    np.asarray(jflt.host_of_lane(n, h)), err_msg=(n, h))


# ------------------------------------------------------ config contracts
_BASE = dict(type="mnist", lr=0.1, batch_size=16, epochs=2, no_models=4,
             number_of_total_participants=8, eta=0.8,
             aggregation_methods="mean", synthetic_data=True)


def test_config_rejects_bad_heartbeat_knobs():
    with pytest.raises(ValueError, match="heartbeat"):
        Params.from_dict(dict(_BASE, heartbeat_interval_s=-1))
    with pytest.raises(ValueError, match="must exceed"):
        Params.from_dict(dict(_BASE, heartbeat_interval_s=0.2,
                              heartbeat_timeout_s=0.1))
    Params.from_dict(dict(_BASE, heartbeat_interval_s=0.2))


def test_config_rejects_bad_host_loss_knobs():
    with pytest.raises(ValueError, match="fault_host_loss_prob"):
        flt.FaultConfig.from_params(
            Params.from_dict(dict(_BASE, fault_host_loss_prob=1.5)))
    with pytest.raises(ValueError, match="fault_num_hosts"):
        Params.from_dict(dict(_BASE, fault_num_hosts=-1))


def test_single_process_host_loss_without_num_hosts_disables_lane(caplog):
    """A shrunk-to-1 elastic relaunch keeps the dead world's YAML (lane on,
    no fault_num_hosts) and must start: the lane turns off with a
    warning."""
    p = Params.from_dict(dict(_BASE, fault_injection=True,
                              fault_host_loss_prob=0.5))
    with caplog.at_level("WARNING", logger="dba_mod_tpu_torch"):
        fcfg = flt.FaultConfig.from_params(p)
    assert not fcfg.host_loss_enabled
    assert any("fault_num_hosts" in r.message for r in caplog.records)
    ok = Params.from_dict(dict(_BASE, fault_injection=True,
                               fault_host_loss_prob=0.5,
                               fault_num_hosts=2))
    fcfg = flt.FaultConfig.from_params(ok)
    assert fcfg.host_loss_enabled and fcfg.host_loss_in_program


def test_elastic_knobs_are_noop_single_process(tmp_path):
    """Heartbeat and host-count knobs change nothing in one process: no
    peers object, no files, the same round bit for bit."""
    cfg = dict(_BASE, synthetic_train_size=256, synthetic_test_size=128,
               sampling_dirichlet=False, local_eval=False, random_seed=1,
               run_dir=str(tmp_path / "runs"))
    base = Experiment(Params.from_dict(cfg), save_results=False,
                      device="cpu")
    base.run_round(1)
    knobbed = Experiment(
        Params.from_dict(dict(cfg, heartbeat_interval_s=0.2,
                              heartbeat_timeout_s=30.0,
                              heartbeat_barrier_s=2.0, fault_num_hosts=4,
                              num_devices=0)),
        save_results=False, device="cpu")
    assert knobbed.peers is None and knobbed.world_size == 1
    knobbed.run_round(1)
    for k, v in base.global_vars.params.items():
        assert torch.equal(v, knobbed.global_vars.params[k]), k
    assert not (tmp_path / "runs").exists()


def test_host_loss_round_matches_jax_with_the_jax_plan(monkeypatch):
    """fault_host_loss_prob=1 with 2 virtual hosts: each round drops one
    host's half of the cohort through the survivor mask. The JAX
    package's plan for each round (jax.random draws other numbers than
    the port's stream) is handed to the port, both rounds start from the
    JAX package's initial model, and the port's global model is held to
    the JAX package's at the MNIST bound (1e-6) after each of two
    rounds."""
    cfg = dict(_BASE, no_models=8, synthetic_train_size=256,
               synthetic_test_size=128, sampling_dirichlet=False,
               local_eval=False, random_seed=1, fault_injection=True,
               fault_host_loss_prob=1.0, fault_num_hosts=2)
    jexp = JExperiment(JParams.from_dict(cfg), save_results=False)
    texp = Experiment(Params.from_dict(cfg), save_results=False,
                      device="cpu")
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(
        texp.model_def.name, jmv.params, jmv.batch_stats)
    jcfg = jexp.engine.fault_cfg
    assert jcfg.host_loss_in_program and texp.engine.fault_cfg.num_hosts == 2
    plans = []

    def jax_plan(fcfg, gen, counted):
        epoch = texp._epoch_in_flight
        p = jflt.make_fault_plan(
            jcfg, jax.random.fold_in(jax.random.key(jcfg.seed), epoch),
            jax.numpy.asarray(counted.numpy()))
        plans.append(np.asarray(p.dropped))
        return flt.FaultPlan(*(torch.from_numpy(np.array(x))
                               for x in p))

    monkeypatch.setattr(flt, "make_fault_plan", jax_plan)
    for ep in (1, 2):
        texp._epoch_in_flight = ep
        # the JAX round on a worker thread beside the port's
        with ThreadPoolExecutor(max_workers=1) as pool:
            jround = pool.submit(jexp.run_round, ep)
            tr = texp.run_round(ep)
            jr = jround.result()
        assert jr["agents"] == tr["agents"]
        assert jr["n_dropped"] == tr["n_dropped"] == 4, (jr, tr)
        assert not tr["degraded"]
        jg = jax.device_get(jexp.global_vars)
        tg = convert.to_jax_numpy(texp.model_def.name, texp.global_vars)
        diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                   for a, b in zip(jax.tree_util.tree_leaves(tg),
                                   jax.tree_util.tree_leaves(
                                       (jg.params, jg.batch_stats))))
        assert diff <= 1e-6, (ep, diff)
        assert abs(jr["global_acc"] - tr["global_acc"]) <= 1.0
    assert len(plans) == 2 and all(int(p.sum()) == 4 for p in plans)
