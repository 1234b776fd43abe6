"""The port's numeric ops, data layer and config against the JAX package's,
on the same numpy-made inputs: losses (float32 sums in another order:
1e-6), LR schedules (exactly equal), trigger stamping, device-data fetches,
selection, partitions and batch plans (bitwise / exactly equal), FedAvg
(1e-7: summation order), plus the port's config guards and checkpoint
manifests."""
import random

import jax.numpy as jnp
from pathlib import Path

import numpy as np
import pytest
import torch

from dba_mod_tpu import config as jcfg
from dba_mod_tpu.data import batching as jbatching
from dba_mod_tpu.data import datasets as jdatasets
from dba_mod_tpu.data import partition as jpartition
from dba_mod_tpu.fl import device_data as jdd
from dba_mod_tpu.fl import selection as jsel
from dba_mod_tpu.fl import state as jstate
from dba_mod_tpu.ops import aggregation as jagg
from dba_mod_tpu.ops import losses as jlosses
from dba_mod_tpu.ops import sgd as jsgd
from dba_mod_tpu.ops import triggers as jtriggers
from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.data import batching, datasets, partition
from dba_mod_tpu_torch.fl import device_data, selection, state
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops import aggregation, losses, sgd, triggers


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CIFAR = CONFIGS / "cifar_params.yaml"
SMOKE = CONFIGS / "smoke_params.yaml"


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 16, 10).astype(np.float32) * 3
    labels = rng.randint(0, 10, (2, 16)).astype(np.int32)
    mask = rng.rand(2, 16) > 0.3
    for b in range(2):
        tl, tb, tm = (torch.from_numpy(a[b]) for a in (logits, labels, mask))
        for fn_t, fn_j in ((losses.cross_entropy, jlosses.cross_entropy),
                           (losses.cross_entropy_sum,
                            jlosses.cross_entropy_sum)):
            for m in (None, tm):
                got = float(fn_t(tl, tb, m))
                want = float(fn_j(jnp.asarray(logits[b]),
                                  jnp.asarray(labels[b]),
                                  None if m is None else jnp.asarray(mask[b])))
                assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    p = {"a": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    q = {k: v + rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tq = {k: torch.from_numpy(v) for k, v in q.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    assert float(losses.tree_global_norm(tp)) == pytest.approx(
        float(jlosses.tree_global_norm(jp)), rel=1e-6)
    assert float(losses.tree_dist_norm(tp, tq)) == pytest.approx(
        float(jlosses.tree_dist_norm(jp, jq)), rel=1e-6)
    # gradient-safe at zero distance
    tz = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    losses.tree_dist_norm(tz, tp).backward()
    assert all(float(v.grad.abs().max()) == 0.0 for v in tz.values())


@pytest.mark.parametrize("e", [1, 2, 5, 6, 10])
@pytest.mark.parametrize("step_before", [False, True])
def test_lr_schedules_exactly_equal(e, step_before):
    np.testing.assert_array_equal(
        sgd.poison_multistep_lr_array(e, step_before=step_before),
        jsgd.poison_multistep_lr_array(e, step_before=step_before))
    ms = [0.5 * e, 2.0, 3]
    np.testing.assert_array_equal(
        sgd.multistep_lr_array(e, ms, 0.5, step_before),
        jsgd.multistep_lr_array(e, ms, 0.5, step_before))


def test_client_tasks_and_selection_equal():
    tp, jp = cfg.Params.from_yaml(CIFAR), jcfg.Params.from_yaml(CIFAR)
    parts = list(range(100))
    benign = sorted(set(parts) - set(tp.adversary_list))
    r_t, r_j = random.Random(4), random.Random(4)
    for epoch in (1, 203, 205, 206):
        names_t = selection.select_agents(tp, epoch, parts, benign, r_t)
        names_j = jsel.select_agents(jp, epoch, parts, benign, r_j)
        assert names_t == names_j
        slots = np.zeros(len(names_t[0]), np.int64)
        t = state.build_client_tasks(tp, names_t[0], epoch, slots, 6)
        j = jstate.build_client_tasks(jp, names_j[0], epoch, slots, 6, None)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, np.asarray(b))
    th, jh = (state.RoundHyper.from_params(tp),
              jstate.RoundHyper.from_params(jp))
    for f in th.__dict__:
        assert getattr(th, f) == getattr(jh, f), f


def test_data_partition_and_plans_equal():
    d_t = datasets.synthetic_image_dataset("cifar", 600, 64, seed=3)
    d_j = jdatasets.synthetic_image_dataset("cifar", 600, 64, seed=3)
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(d_t, f), getattr(d_j, f))
    pt = partition.sample_dirichlet_indices(
        d_t.train_labels, 20, 0.5, py_rng=random.Random(3),
        np_rng=np.random.RandomState(3))
    pj = jpartition.sample_dirichlet_indices(
        d_j.train_labels, 20, 0.5, py_rng=random.Random(3),
        np_rng=np.random.RandomState(3))
    assert pt == pj
    assert partition.equal_split_indices(600, 7, random.Random(2)) == \
        jpartition.equal_split_indices(600, 7, random.Random(2))
    clients = [pt[i] for i in range(5)]
    bt = batching.build_batch_plan(clients, [2, 1, 6, 2, 0], 16,
                                   np.random.RandomState(9), min_steps=3)
    bj = jbatching.build_batch_plan(clients, [2, 1, 6, 2, 0], 16,
                                    np.random.RandomState(9), min_steps=3)
    for f in ("idx", "mask", "num_samples", "num_epochs"):
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
    et = batching.build_eval_plan(np.arange(37), 8)
    ej = jbatching.build_eval_plan(np.arange(37), 8)
    np.testing.assert_array_equal(et.idx, ej.idx)
    np.testing.assert_array_equal(et.mask, ej.mask)


def test_fetch_and_stamp_bitwise_equal():
    tp, jp = cfg.Params.from_yaml(CIFAR), jcfg.Params.from_yaml(CIFAR)
    data = datasets.synthetic_image_dataset("cifar", 200, 64, seed=1)
    dt = device_data.make_image_device_data(data, tp, torch.device("cpu"))
    dj = jdd.make_image_device_data(data, jp)
    np.testing.assert_array_equal(
        triggers.build_pixel_pattern_bank(tp, 32, 32),
        jtriggers.build_pixel_pattern_bank(jp, 32, 32))
    idx = np.random.RandomState(0).randint(0, 200, (3, 8)).astype(np.int32)
    adv = np.array([-1, 0, 3], np.int32)
    k = np.array([5, 0, 8], np.int32)
    xt, yt = dt.fetch_train(None, torch.from_numpy(idx))
    xt, yt, st = dt.stamp(xt, yt, torch.from_numpy(adv), torch.from_numpy(k))
    for c in range(3):
        xj, yj = dj.fetch_train(0, jnp.asarray(idx[c]))
        xj, yj, sj = dj.stamp(xj, yj, jnp.int32(adv[c]), jnp.int32(k[c]))
        np.testing.assert_array_equal(xt[c].numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt[c].numpy(), np.asarray(yj))
        np.testing.assert_array_equal(st[c].numpy(), np.asarray(sj))
    # evaluation mode: every sample, one trigger row per call
    tidx = idx[0] % 64
    xt, yt = dt.fetch_test(None, torch.from_numpy(tidx))
    xj, yj = dj.fetch_test(0, jnp.asarray(tidx))
    xt, yt, _ = dt.stamp(xt, yt, torch.tensor(2), None, poison_all=True)
    xj, yj, _ = dj.stamp(xj, yj, jnp.int32(2), 0, poison_all=True)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_fedavg_matches_jax():
    rng = np.random.RandomState(0)
    g = {"w": rng.randn(5, 3).astype(np.float32),
         "m": rng.randn(4).astype(np.float32)}
    d = {k: rng.randn(3, *v.shape).astype(np.float32) for k, v in g.items()}
    noise = {k: rng.randn(*v.shape).astype(np.float32) * 0.01
             for k, v in g.items()}
    got = aggregation.fedavg_update(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in d.items()}, 0.8, 10, 0.01,
        noise={k: torch.from_numpy(v) for k, v in noise.items()})
    want = jagg.fedavg_update({k: jnp.asarray(v) for k, v in g.items()},
                              {k: jnp.asarray(v) for k, v in d.items()},
                              0.8, 10)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k]) + noise[k],
                                   rtol=0, atol=1e-7)
    gen = torch.Generator().manual_seed(0)
    n = aggregation.dp_noise_like(gen, {"w": torch.zeros(1000)}, 0.5)["w"]
    assert abs(float(n.std()) - 0.5) < 0.05


@pytest.mark.parametrize("override,bad", [
    pytest.param({"fault_injection": True, "fault_host_loss_prob": 0.1,
                  "fault_num_hosts": 2}, {"fault_num_hosts": -1},
                 id="override0-A18"),
    pytest.param({"num_devices": 4, "heartbeat_interval_s": 0.5},
                 {"heartbeat_timeout_s": -1.0}, id="override4-A18"),
])
def test_unported_knobs_raise(override, bad):
    """The A18 knobs the port refused before the multi-device layer was
    ported (num_devices, heartbeats, the host-loss lane) now parse as the
    reference's config parses them, and their invalid values raise the
    reference's ValueError."""
    import yaml
    raw = yaml.safe_load(open(SMOKE))
    raw.update(override)
    assert cfg.Params.from_dict(raw).raw == jcfg.Params.from_dict(raw).raw
    assert not hasattr(cfg, "check_ported")
    raw.update(bad)
    with pytest.raises(ValueError, match=next(iter(bad))):
        cfg.Params.from_dict(raw)
    with pytest.raises(ValueError, match=next(iter(bad))):
        jcfg.Params.from_dict(raw)


@pytest.mark.parametrize("override", [
    {"compute_dtype": "bfloat16"}, {"forensics": True},
    {"model_health_check": True, "health_norm_band": 3.0},
    {"resumed_model": "auto"}, {"graceful_shutdown": True},
    {"watchdog_soft_s": 60.0, "watchdog_hard_s": 600.0},
    {"keep_last_n": 2},
    {"mode": "async", "buffer_k": 2, "staleness_weighting": "polynomial",
     "merge_timeout_v": 1.0, "max_outstanding_waves": 3},
    {"telemetry": True, "telemetry_dir": "tel"}, {"tensorboard": True},
    {"profile_dir": "prof"}, {"overlap_eval": True},
    {"pipeline_rounds": True}, {"sequential_debug": True},
    {"grouped_clients": True}],
    ids=["A20-bf16", "A14-forensics", "A14-health", "A15-auto",
         "A15-graceful", "A15-watchdog", "A15-keep_last_n", "A16-async",
         "A17-telemetry", "A17-tensorboard", "A17-profile_dir",
         "A17-overlap_eval", "A17-pipeline_rounds", "A19-sequential_debug",
         "A19-grouped_clients"])
def test_ported_knobs_pass(override):
    """The knobs of ROADMAP A14-A17, A19 and A20 are ported: the config
    accepts them, as the reference's config does."""
    import yaml
    raw = yaml.safe_load(open(SMOKE))
    raw.update(override)
    assert cfg.Params.from_dict(raw).raw == jcfg.Params.from_dict(raw).raw


def test_config_reads_reference_yaml_unchanged():
    for path in (CIFAR, SMOKE, CONFIGS / "mnist_params.yaml"):
        assert cfg.Params.from_yaml(path).raw == \
            jcfg.Params.from_yaml(path).raw


def test_checkpoint_round_trip_and_manifest(tmp_path):
    mv = ModelVars({"w": torch.arange(6.0).reshape(2, 3)},
                   {"s": torch.ones(4)})
    path = tmp_path / "model_last.pt.tar"
    ckpt.save_checkpoint(path, mv, 7, 0.05)
    assert ckpt.verify_checkpoint(path) == (False, ckpt.VERIFY_NO_MANIFEST)
    assert ckpt.resolve_verified(path) == path.absolute()
    ckpt.write_manifest(path, 7)
    assert ckpt.verify_checkpoint(path) == (True, ckpt.VERIFY_OK)
    like = ModelVars({"w": torch.zeros(2, 3)}, {"s": torch.zeros(4)})
    got, epoch, lr = ckpt.load_checkpoint(path, like)
    assert (epoch, lr) == (7, 0.05)
    assert torch.equal(got.params["w"], mv.params["w"])
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, ModelVars({"w": torch.zeros(3, 2)},
                                             {"s": torch.zeros(4)}))
    # a verified same-name sibling stands in for a corrupted snapshot
    sib = tmp_path / "model_last.pt.tar.epoch_6"
    ckpt.save_checkpoint(sib, mv, 6, 0.05)
    ckpt.write_manifest(sib, 6)
    state = path / ckpt.STATE_FILE
    state.write_bytes(state.read_bytes()[:-3] + b"xyz")
    ok, why = ckpt.verify_checkpoint(path)
    assert not ok and "checksum" in why
    assert ckpt.resolve_verified(path) == sib.absolute()
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_verified(tmp_path / "missing")
