"""The port's clients mesh (dba_mod_tpu_torch/parallel/mesh.py and the
sharded round of fl/rounds.py) against the JAX package.

- pad_clients, the shard partition and the ranks' slices against the JAX
  package's pad_clients, its GSPMD device slices (tests/test_mesh_edges.py's
  cases) and its host-loss lane partition (fl/faults.py::host_of_lane);
- a 2-shard CPU mesh round (``cpu, cpu``: the JAX package's virtual CPU
  devices' counterpart) of MNIST_AB_R1 against the JAX single-device round
  at the ROADMAP bounds, and against the port's unsharded round: on the CPU
  a vmapped step over 2 lanes gives each client bitwise what one over 4
  lanes gives, so sharded and unsharded runs are held bitwise equal
  (model and every recorded row, the local battery's included). A padded
  mesh adds inert zero lanes to FedAvg's sum, and torch.sum over 8 lanes
  groups its float32 additions otherwise than over 6: the clients stay
  bitwise, the global model moves by an ulp (measured 1.9e-9);
- shards on distinct devices train on a thread each, bitwise the
  unsharded round;
- 6 clients on 4 shards record 6 clients; padding raises under
  geom_median; the grouped, async and sequential_debug gates.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from benchmarks.parity_ab import MNIST_AB_R1
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu.parallel import mesh as jmesh
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl import faults
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.parallel import mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
STREAMS = ("train_result", "test_result", "posiontest_result",
           "poisontriggertest_result", "weight_result", "scale_result")

BASE = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=2, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, internal_poison_epochs=2, is_poison=True,
    synthetic_data=True, synthetic_train_size=320,
    synthetic_test_size=128, momentum=0.9, decay=0.0005,
    sampling_dirichlet=False, local_eval=True, poison_label_swap=2,
    poisoning_per_batch=4, poison_lr=0.05, scale_weights_poison=3.0,
    adversary_list=[0], trigger_num=1, alpha_loss=1.0, random_seed=3,
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2], [0, 3]],
       "0_poison_epochs": [1, 2]})


def _mesh(n):
    return mesh.ClientsMesh((CPU,) * n)


# ------------------------------------------------------------ partitions
def test_pad_clients_matches_jax_for_every_mesh_size():
    assert jax.device_count() >= 8
    for d in range(1, 9):
        jm = jmesh.make_mesh(d)
        for c in (1, 5, 8, 10, 100):
            assert mesh.pad_clients(c, _mesh(d)) == jmesh.pad_clients(c, jm)
            # ranks of one device each pad for the whole world
            assert mesh.pad_clients(c, mesh.ClientsMesh((CPU,), 0, d)) == \
                jmesh.pad_clients(c, jm)
    assert mesh.pad_clients(10, None) == 10


@pytest.mark.parametrize("ndev,c", [(8, 16), (4, 16), (8, 8), (2, 6),
                                    (4, 12), (3, 12)])
def test_shard_bounds_are_the_gspmd_device_slices(ndev, c):
    """On a padded axis (the count tiles the mesh) each shard's slice is
    the slice GSPMD assigns the JAX package's device, in device order, and
    a one-process mesh owns the whole axis (local_slice_bounds)."""
    jm = jmesh.make_mesh(ndev)
    index_map = jmesh.client_sharding(jm).addressable_devices_indices_map(
        (c,))
    want = [(sl[0].start or 0, sl[0].stop if sl[0].stop is not None else c)
            for sl in (index_map[d] for d in jm.devices.flat)]
    assert mesh.shard_bounds(_mesh(ndev), c) == want
    assert mesh.local_slice_bounds(_mesh(ndev), c) == (0, c) == \
        jmesh.local_slice_bounds(jmesh.client_sharding(jm), (c,), 0)


@pytest.mark.parametrize("c", [1, 5, 6, 7, 10, 16, 17])
@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_rank_slices_are_the_host_loss_partition(c, hosts):
    """A rank's slice (every device of it) is the host_of_lane slice of
    its host — also where the world does not divide the count (a shrunk
    relaunch) — and the ranks' slices tile [0, c) without gaps or
    overlaps. (The port's host_of_lane is held to the JAX package's on
    this grid by tests/test_torch_elastic.py::test_host_of_lane_matches_
    jax.)"""
    bounds = []
    for r in range(hosts):
        for d in (1, 2):
            lo, hi = mesh.local_slice_bounds(
                mesh.ClientsMesh((CPU,) * d, r, hosts), c * d)
            lanes = np.nonzero(
                faults.host_of_lane(c * d, hosts).numpy() == r)[0]
            assert (lo, hi) == ((int(lanes[0]), int(lanes[-1]) + 1)
                                if len(lanes) else (lo, lo))
        bounds.append(mesh.local_slice_bounds(
            mesh.ClientsMesh((CPU,), r, hosts), c))
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_make_mesh_rules():
    assert mesh.make_mesh(0, device="cpu") is None
    assert mesh.make_mesh(1, device="cpu") is None      # JAX: nd > 1 only
    assert mesh.make_mesh(-1, device="cpu").devices == (CPU,)
    with pytest.raises(ValueError, match="one device"):
        mesh.make_mesh(2, device="cpu")
    m = mesh.make_mesh(devices=["cpu", "cpu"])
    assert m.devices == (CPU, CPU) and m.size == 2
    assert m.distinct_devices() == [CPU]
    w = mesh.make_mesh(-1, device="cpu", rank=1, world_size=2)
    assert (w.devices, w.rank, w.size) == ((CPU,), 1, 2)
    with pytest.raises(ValueError, match="each rank drives one device"):
        mesh.make_mesh(3, device="cpu", rank=0, world_size=2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cards"):
            mesh.make_mesh(2, device="cuda")


def test_shard_round_inputs_cut_and_copy():
    from dba_mod_tpu_torch.fl.state import ClientTask
    rng = np.random.RandomState(0)
    C = 6
    idx = rng.randint(0, 50, (2, C, 1, 3, 4)).astype(np.int32)
    msk = rng.rand(2, C, 1, 3, 4) > 0.3
    task = ClientTask(*(np.arange(C) + k for k in range(8)),
                      np.arange(C))
    shards = mesh.shard_round_inputs(_mesh(4), [task, task], idx, msk)
    assert [(s.lo, s.hi) for s in shards] == [(0, 2), (2, 3), (3, 5),
                                              (5, 6)]
    for s in shards:
        for i in range(2):
            np.testing.assert_array_equal(s.idx_seq[i].numpy(),
                                          idx[i, s.lo:s.hi])
            np.testing.assert_array_equal(s.active_seq[i],
                                          msk[i, s.lo:s.hi].any(axis=(0, 3)))
        np.testing.assert_array_equal(s.tasks_seq[1].slot,
                                      task.slot[s.lo:s.hi])


# ------------------------------------------------------------ the round
def test_two_shard_round_matches_jax_single_device(tmp_path):
    """A 2-shard CPU mesh round of MNIST_AB_R1 against the JAX package's
    single-device round on the same inputs, at the ROADMAP bounds (per
    client and global ≤ 1e-6; benign participant 3's max-pool near-tie,
    ROADMAP queue C, is held as the lane tests hold it)."""
    from test_torch_slice import _check_acc, _engine_round
    raw = dict(MNIST_AB_R1)
    jexp = JExperiment(JParams.from_dict(dict(
        raw, run_dir=str(tmp_path / "jax"))), save_results=False)
    texp = Experiment(Params.from_dict(dict(
        raw, run_dir=str(tmp_path / "torch"))), save_results=False,
        device="cpu", mesh_devices=["cpu", "cpu"])
    assert texp.engine.mesh.size == 2
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(
        texp.model_def.name, jmv.params, jmv.batch_stats)
    per_client, g_diff, jev, tev = _engine_round(jexp, texp, 1,
                                                 flip_client=3)
    assert all(d <= 1e-6 for d in per_client[:3]), per_client
    assert abs(per_client[3] - 1.509e-3) < 1e-5, per_client
    assert g_diff <= 1e-6, g_diff
    _check_acc(jev, tev)


def _run(cfg, devs, epochs=2):
    e = Experiment(Params.from_dict(cfg), save_results=False, device="cpu",
                   mesh_devices=devs)
    last = e.run(epochs)
    return e, last


def _same_run(a, b, global_tol=0.0):
    """The same model (bitwise, or within `global_tol` for a padded mesh)
    and the same recorded rows."""
    for k, v in {**a.global_vars.params,
                 **a.global_vars.batch_stats}.items():
        w = {**b.global_vars.params, **b.global_vars.batch_stats}[k]
        if global_tol == 0.0:
            assert torch.equal(v, w), k
        else:
            assert float((v - w).abs().max()) <= global_tol, k
    for s in STREAMS:
        assert getattr(a.recorder, s) == getattr(b.recorder, s), s
    strip = lambda rows: [{k: v for k, v in r.items() if not k.endswith(
        "time")} for r in rows]
    assert strip(a.recorder._jsonl_rows) == strip(b.recorder._jsonl_rows)


@pytest.mark.parametrize("devs,tol", [(["cpu", "cpu"], 0.0),
                                      (["cpu"] * 3, 1e-8)],
                         ids=["2shards", "3shards_padded"])
def test_sharded_round_is_bitwise_the_unsharded_round(devs, tol):
    """Two poisoned rounds with the local battery: 2 shards of 2 lanes,
    and 3 shards over 6 lanes (4 clients padded with 2 inert ones under
    FedAvg), against the unsharded port run: the same model bit for bit
    (the padded mesh to FedAvg's ulp, module docstring) and the same
    recorded rows (the shards' local-battery rows gathered in client
    order)."""
    plain, _ = _run(dict(BASE), None)
    sharded, _ = _run(dict(BASE), devs)
    _same_run(plain, sharded, tol)
    assert [len(r["agents"]) for r in sharded.recorder._jsonl_rows] == \
        [4, 4]


def test_distinct_devices_train_on_threads_bitwise(monkeypatch):
    """Shards on distinct devices run on a thread each (fl/rounds.py::
    _per_device), shards of one device inline. ``cpu`` and ``cpu:0`` are
    two devices to the mesh, so a round over them takes the threaded path
    on the CPU: each shard's work ran on its own thread, and the round is
    bitwise the unsharded one."""
    import threading
    from dba_mod_tpu_torch.fl import rounds
    seen = []
    real = rounds._per_device

    def spy(shards, fn):
        def wrapped(sh):
            seen.append((str(sh.device), threading.current_thread().name))
            return fn(sh)
        return real(shards, wrapped)
    monkeypatch.setattr(rounds, "_per_device", spy)
    cfg = dict(BASE, local_eval=False)
    plain, _ = _run(cfg, None, epochs=1)
    assert seen == []
    threaded, _ = _run(cfg, ["cpu", "cpu:0"], epochs=1)
    _same_run(plain, threaded)
    assert [d for d, _ in seen] == ["cpu", "cpu:0"]
    assert len({t for _, t in seen}) == 2
    assert threading.main_thread().name not in {t for _, t in seen}


def test_six_clients_on_four_shards_record_six():
    """tests/test_parallel.py:52's counterpart: 6 clients pad to 8 on 4
    shards; only the 6 real clients are recorded, and the round is the
    unsharded one."""
    cfg = dict(BASE, no_models=6, local_eval=False)
    e, last = _run(cfg, ["cpu"] * 4, epochs=1)
    assert np.isfinite(last["global_acc"])
    assert len({row[0] for row in e.recorder.train_result}) == 6
    assert len(last["agents"]) == 6
    plain, _ = _run(cfg, None, epochs=1)
    _same_run(plain, e, global_tol=1e-8)


def test_padding_rejected_for_defenses():
    """tests/test_parallel.py:61's counterpart: padding is sound only
    under FedAvg; any other rule raises the ValueError naming 'tile'."""
    cfg = dict(BASE, no_models=6, aggregation_methods="geom_median")
    e = Experiment(Params.from_dict(cfg), save_results=False, device="cpu",
                   mesh_devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="tile"):
        e.run_round(1)


def test_mesh_gates(caplog):
    """The JAX package's refusals: the grouped layout with a sharded axis
    (fl/rounds.py:361-370), mode: async with a mesh
    (fl/async_rounds.py:240-247); sequential_debug ignores the mesh with
    a warning (fl/experiment.py:327-331)."""
    cifar = dict(BASE, type="cifar", grouped_clients=True, is_poison=False,
                 synthetic_train_size=64, synthetic_test_size=32)
    with pytest.raises(ValueError, match="unsharded clients axis"):
        Experiment(Params.from_dict(cifar), save_results=False,
                   device="cpu", mesh_devices=["cpu", "cpu"])
    e = Experiment(Params.from_dict(dict(BASE, mode="async", buffer_k=2,
                                         async_steps=1)),
                   save_results=False, device="cpu",
                   mesh_devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="sharded clients mesh"):
        e.run()
    with caplog.at_level(logging.WARNING, logger="dba_mod_tpu_torch"):
        s = Experiment(Params.from_dict(dict(BASE, sequential_debug=True)),
                       save_results=False, device="cpu",
                       mesh_devices=["cpu", "cpu"])
    assert s.mesh is None and s.engine.mesh is None
    assert "sequential_debug forces single-device" in caplog.text
