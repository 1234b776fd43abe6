"""The LOAN workload of the port (dba_mod_tpu_torch) against the JAX package.

Bounds: the repo's LOAN bound, 5e-6 per client and on the global model
(tests/test_parity_ab.py; the MLP's float32 sums differ only in order), and
1e-6 on one forward pass. jax.random and torch draw different dropout
masks, so the JAX package's own masks are a shared input: the flax module's
masks are read back with benchmarks/parity_ab.py's probe and handed to the
port, whose dropout takes its masks as an input (models/loan.py)."""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from pathlib import Path

from benchmarks.parity_ab import (LOAN_AB, _loan_mask_probe,
                                  extract_loan_dropout_masks)
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.data import batching as jbatching
from dba_mod_tpu.data import datasets as jdatasets
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu.fl.selection import select_agents as jselect
from dba_mod_tpu.fl.state import build_client_tasks as jtasks
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu.ops import sgd as jsgd
from dba_mod_tpu.ops import triggers as jtriggers
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.data import batching, datasets
from dba_mod_tpu_torch.data.batching import build_batch_plan
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import build_client_tasks
from dba_mod_tpu_torch.models import ModelVars, build_model, loan
from dba_mod_tpu_torch.ops import sgd, triggers

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _loan_pair(seed=3):
    raw = yaml.safe_load(open(CONFIGS / "loan_params.yaml"))
    jdef = jbuild(JParams.from_dict(raw))
    jmv = jax.device_get(jdef.init_vars(jax.random.key(seed)))
    tdef = build_model(Params.from_dict(raw))
    return jdef, jmv, tdef, convert.from_jax_numpy(tdef.name, jmv.params, {})


def test_loan_net_with_flax_dropout_masks_matches():
    jdef, jmv, tdef, tmv = _loan_pair()
    B = 32
    x = np.random.RandomState(1).randn(B, 91).astype(np.float32)
    key = jax.random.key(5)
    m0, m1 = _loan_mask_probe(jdef.module, B)(key[None])
    drop = tuple(torch.from_numpy(np.asarray(m)[0] > 0.5) for m in (m0, m1))
    assert 0.3 < float(drop[0].float().mean()) < 0.7
    jl, _ = jdef.apply(jmv, x, train=True, dropout_rng=key)
    tl, _ = tdef.apply(tmv, torch.from_numpy(x), train=True, dropout=drop)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-6)
    jl, _ = jdef.apply(jmv, x, train=False)
    tl, _ = tdef.apply(tmv, torch.from_numpy(x), train=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="dropout masks"):
        tdef.apply(tmv, torch.from_numpy(x), train=True)
    # the state layout and the convert round trip
    assert sum(v.numel() for v in tmv.params.values()) == 5529
    assert len(tmv.params) == 6 and not tmv.batch_stats
    p, _ = convert.to_jax_numpy(tdef.name, tmv)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(jmv.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        tdef.similarity_param(tmv.params).numpy().T,
        np.asarray(jdef.similarity_param(jmv.params)))


def test_feature_triggers_and_adaptive_lr_equal_jax():
    raw = yaml.safe_load(open(CONFIGS / "loan_params.yaml"))
    jp, tp = JParams.from_dict(raw), Params.from_dict(raw)
    data = datasets.synthetic_loan_dataset(seed=1)
    fd = data.feature_dict
    jv, jm = jtriggers.build_feature_trigger_bank(jp, fd, 91)
    tv, tm = triggers.build_feature_trigger_bank(tp, fd, 91)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm, jm)
    assert tm.shape == (4, 91) and tm[3].sum() == 6
    rng = np.random.RandomState(2)
    rows = rng.randn(3, 8, 91).astype(np.float32)
    labels = rng.randint(0, 9, size=(3, 8)).astype(np.int32)
    for adv in (-1, 0, 2):
        want = jtriggers.stamp_feature_trigger(jnp.asarray(rows), jv, jm,
                                               adv)
        got = triggers.stamp_feature_trigger(
            torch.from_numpy(rows), torch.from_numpy(tv),
            torch.from_numpy(tm), torch.tensor(adv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # per-client selectors against [C, B, F] rows: client c poisons its
    # first k[c] samples with trigger adv[c]; the eval mode poisons all
    adv, k = np.array([-1, 1, 0]), np.array([3, 0, 8])
    for poison_all in (False, True):
        got = triggers.poison_batch_features(
            torch.from_numpy(rows), torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(tv), torch.from_numpy(tm), torch.from_numpy(adv),
            7, torch.from_numpy(k), poison_all)
        for c in range(3):
            want = jtriggers.poison_batch_features(
                jnp.asarray(rows[c]), jnp.asarray(labels[c]), jv, jm,
                int(adv[c]), 7, int(k[c]), poison_all)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))
    for acc in (0.0, 20.0, 20.001, 59.9, 60.0, 60.5, 100.0):
        for baseline in (False, True):
            assert sgd.loan_adaptive_poison_lr(0.05, acc, baseline) == \
                float(jsgd.loan_adaptive_poison_lr(0.05, np.float32(acc),
                                                   baseline))
    assert sgd.loan_adaptive_poison_lr(0.05, 61.0, False) == \
        pytest.approx(0.001)


def test_synthetic_loan_dataset_equals_jax():
    j = jdatasets.synthetic_loan_dataset(num_states=51, seed=1)
    t = datasets.synthetic_loan_dataset(num_states=51, seed=1)
    assert t.state_names == j.state_names
    assert t.feature_names == j.feature_names
    assert t.feature_dict == j.feature_dict
    for a, b in zip(t.train_x + t.train_y + t.test_x + t.test_y,
                    j.train_x + j.train_y + j.test_x + j.test_y):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(batching.stack_ragged(t.train_x),
                                  jbatching.stack_ragged(j.train_x))
    sizes = [len(y) + len(ty) for y, ty in zip(t.train_y, t.test_y)]
    assert min(sizes) == 800 and max(sizes) <= 1199


def test_loan_csv_reader_equals_jax(tmp_path):
    """Three state CSVs of 7, 100 and 1003 rows (row counts whose 20%
    split rounds differently), one with an empty cell: the port's
    csv+numpy reader against the JAX package's pandas+sklearn one."""
    root = tmp_path / "loan"
    root.mkdir()
    rng = np.random.RandomState(0)
    cols = ["loan_amnt", "pub_rec", "loan_status", "int_rate"]
    for state, n in (("CA", 7), ("NY", 100), ("TX", 1003)):
        with open(root / f"loan_{state}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for i in range(n):
                row = [f"{rng.uniform(500, 40000):.2f}", rng.randint(0, 4),
                       rng.randint(0, 9), f"{rng.uniform(5, 30):.4f}"]
                if state == "NY" and i == 3:
                    row[0] = ""
                w.writerow(row)
    j = jdatasets.load_loan_csvs(str(tmp_path))
    t = datasets.load_loan_csvs(str(tmp_path))
    assert t.state_names == j.state_names == ["CA", "NY", "TX"]
    assert t.feature_names == j.feature_names
    for a, b in zip(t.train_x + t.train_y + t.test_x + t.test_y,
                    j.train_x + j.train_y + j.test_x + j.test_y):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert datasets.load_loan_csvs(str(tmp_path / "none")) is None


def _loan_round(jexp, texp, epoch):
    """One LOAN train + FedAvg round through each engine: the same agents,
    plans and adaptive-LR probe (each side probes its own global model),
    the JAX step's dropout masks fed to the port. Returns (per-client max
    abs delta diffs, global max abs diff, JAX and port poison LR or
    None)."""
    jp, tp = jexp.params, texp.params
    jnames, _ = jselect(jp, epoch, jexp.participants, jexp.benign_names,
                        jexp.select_rng)
    tnames, _ = select_agents(tp, epoch, texp.participants,
                              texp.benign_names, texp.select_rng)
    assert jnames == tnames
    slots = np.array([jexp.client_slots[n] for n in jnames], np.int64)
    assert [texp.client_slots[n] for n in tnames] == list(slots)
    poisons = any(jp.adversary_slot_of(n) >= 0 and epoch in
                  jp.poison_epochs_for(jp.adversary_slot_of(n))
                  for n in jnames)
    jacc = (float(jexp.engine.backdoor_acc_fn(jexp.global_vars))
            if poisons else None)
    tacc = texp._poison_probe(epoch, tnames)
    assert (jacc is None) == (tacc is None)
    jt = jtasks(jp, jnames, epoch, slots, jexp.epochs_max, jacc)
    tt = build_client_tasks(tp, tnames, epoch, slots, texp.epochs_max, tacc)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    plans = [build_batch_plan([e.client_indices[n] for n in jnames],
                              [int(x) for x in tasks.num_epochs],
                              int(jp["batch_size"]), e.plan_rng,
                              min_steps=e.steps_per_epoch,
                              min_epochs=e.epochs_max)
             for e, tasks in ((jexp, jt), (texp, tt))]
    np.testing.assert_array_equal(plans[0].idx, plans[1].idx)
    np.testing.assert_array_equal(plans[0].mask, plans[1].mask)
    plan = plans[0]
    C, E, S, B = plan.idx.shape
    rng_t, rng_a = jax.random.split(jax.random.key(epoch))
    drop = extract_loan_dropout_masks(jexp.model_def.module, rng_t, C, E, S,
                                      B)
    train = jexp.engine.train_fn(
        jexp.global_vars,
        jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], jt),
        jnp.asarray(plan.idx[None]), jnp.asarray(plan.mask[None]),
        jnp.arange(C, dtype=jnp.int32), rng_t)
    jagg = jexp.engine.aggregate_fn(
        jexp.global_vars, jexp.fg_state, train.deltas, train.fg_grads,
        train.fg_feature, jnp.asarray(jt.participant_id),
        jnp.asarray(plan.num_samples.astype(np.float32)), rng_a)
    ttrain = texp.engine.train_fn(
        texp.global_vars, [tt], plan.idx[None], plan.mask[None],
        [tuple(torch.from_numpy(m > 0.5) for m in drop)])
    tagg = texp.engine.aggregate_fn(texp.global_vars, ttrain.deltas)
    jd = jax.device_get(train.deltas.params)
    per_client = []
    for c in range(C):
        got, _ = convert.to_jax_numpy("LoanNet", ModelVars(
            {k: v[c] for k, v in ttrain.deltas.params.items()}, {}))
        per_client.append(max(
            float(np.abs(a - np.asarray(b)[c]).max()) for a, b in zip(
                jax.tree_util.tree_leaves(got),
                jax.tree_util.tree_leaves(jd))))
    tg, _ = convert.to_jax_numpy("LoanNet", tagg.new_vars)
    g_diff = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(tg),
        jax.tree_util.tree_leaves(jax.device_get(jagg.new_vars.params))))
    jexp.global_vars, texp.global_vars = jagg.new_vars, tagg.new_vars
    base, baseline = float(jp["poison_lr"]), bool(jp["baseline"])
    lrs = (None if jacc is None else
           (float(jsgd.loan_adaptive_poison_lr(base, np.float32(jacc),
                                               baseline)),
            sgd.loan_adaptive_poison_lr(base, tacc, baseline)))
    return per_client, g_diff, lrs


def test_three_loan_rounds_match_jax(tmp_path):
    """benchmarks/parity_ab.py::LOAN_AB: round 1 from identical state with
    both adversaries' feature triggers, benign clients and ×3 scaling;
    rounds 2 and 3 poison again after the probe has read the planted
    backdoor, so the poison LR decays on both sides."""
    raw = dict(LOAN_AB)
    jexp = JExperiment(JParams.from_dict(dict(raw, run_dir=str(
        tmp_path / "jax"))), save_results=False)
    texp = Experiment(Params.from_dict(dict(raw, run_dir=str(
        tmp_path / "torch"))), save_results=False, device="cpu")
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy("LoanNet", jmv.params, {})
    lrs = []
    for epoch in (1, 2, 3):
        per_client, g_diff, lr = _loan_round(jexp, texp, epoch)
        assert max(per_client) <= 5e-6, (epoch, per_client)
        assert g_diff <= 5e-6, (epoch, g_diff)
        lrs.append(lr)
    assert all(lr is None or lr[0] == lr[1] for lr in lrs), lrs
    assert lrs[0][0] == pytest.approx(LOAN_AB["poison_lr"])
    assert any(lr is not None and lr[0] < LOAN_AB["poison_lr"] / 10
               for lr in lrs[1:]), lrs


def test_dropout_masks_are_drawn_the_same_from_one_seed():
    lead = (4, 2, 3, 16)
    a = loan.draw_dropout_masks(loan.dropout_generator(1, 3, 0), lead)
    b = loan.draw_dropout_masks(loan.dropout_generator(1, 3, 0), lead)
    c = loan.draw_dropout_masks(loan.dropout_generator(1, 4, 0), lead)
    assert [m.shape for m in a] == [lead + (46,), lead + (23,)]
    assert all(m.dtype == torch.bool for m in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert 0.45 < float(a[0].float().mean()) < 0.55
    # a whole CPU round, twice from one seed: the same global model
    outs = []
    for _ in range(2):
        e = Experiment(Params.from_dict(dict(LOAN_AB)), save_results=False,
                       device="cpu")
        e.run_round(1)
        outs.append(e.global_vars.params)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_loan_and_tiny_are_ported():
    for name in ("loan_params.yaml", "tiny_params.yaml"):
        raw = yaml.safe_load(open(CONFIGS / name))
        assert Params.from_dict(raw).raw == JParams.from_dict(raw).raw


def test_stale_poison_probe_reads_the_last_finalized_round():
    """stale_poison_probe: the adaptive-LR probe takes the last finalized
    round's backdoor accuracy instead of evaluating the current model; it
    evaluates only before any round was finalized, and only in a round
    where a selected adversary poisons."""
    e = Experiment(Params.from_dict(dict(LOAN_AB, stale_poison_probe=True)),
                   save_results=False, device="cpu")
    fresh = e._poison_probe(1, ["AK", "CA"])
    assert fresh == float(e.engine.backdoor_acc(e.global_vars))
    e.last_backdoor_acc = 70.0
    assert e._poison_probe(1, ["AK", "CA"]) == 70.0
    assert e._poison_probe(4, ["AK", "CA"]) is None   # AK idle in round 4
    assert e._poison_probe(1, ["CA", "CO"]) is None   # no adversary
