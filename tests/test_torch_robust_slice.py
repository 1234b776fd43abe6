"""The robust server end to end: FoolsGold and RFA rounds of the port
against the JAX package's, and the port's fault / screen / retry layer.

Parity (configs/smoke_params.yaml, MNIST, from the same converted weights,
the same agents and batch plans): per-client deltas ≤ 1e-6 as in
tests/test_parity_ab.py's MNIST round; the global model ≤ 1e-5 after a
FoolsGold round, ≤ 1e-4 after a second one whose memory the JAX run hands
to the port through convert.py (two rounds of the drift FoolsGold's
cosine weights amplify), ≤ 2e-5 after an RFA round (Weiszfeld's float32
reductions sum in another order); `weight_result.csv` rows within 1e-5;
accuracies within 1 point; the same recorder files and columns.

The fault tests run the port alone (its fault plans come from its own
stream): a NaN round is quarantined and recovered, a non-finite aggregate
is retried with the escalated norm screen and degraded when retries run
out, too few survivors skip the aggregate and carry the model, and the
stale lane replays what the server received the round before."""
import csv
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu.fl.selection import select_agents as jselect
from dba_mod_tpu.fl.state import build_client_tasks as jtasks
from dba_mod_tpu.utils.recorder import \
    canonical_run_outputs as j_canonical
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.data.batching import build_batch_plan
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import build_client_tasks
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops.aggregation import FoolsGoldState
from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SMOKE = yaml.safe_load(open(CONFIGS / "smoke_params.yaml"))


def _experiments(raw, tmp_path):
    jexp = JExperiment(JParams.from_dict(dict(raw, run_dir=str(
        tmp_path / "jax"))))
    texp = Experiment(Params.from_dict(dict(raw, run_dir=str(
        tmp_path / "torch"))), device="cpu")
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(
        texp.model_def.name, jmv.params, jmv.batch_stats)
    return jexp, texp


def _flat(name, mv):
    return jax.tree_util.tree_leaves(convert.to_jax_numpy(name, mv))


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _engine_round(jexp, texp, epoch):
    """One train + aggregate round through each engine on the same agents
    and plans; commits each side's new model and FoolsGold state. Returns
    (per-client delta diffs, global diff, JAX result, port result)."""
    jp, tp = jexp.params, texp.params
    names, _ = jselect(jp, epoch, jexp.participants, jexp.benign_names,
                       jexp.select_rng)
    tnames, _ = select_agents(tp, epoch, texp.participants,
                              texp.benign_names, texp.select_rng)
    assert names == tnames
    slots = np.zeros(len(names), np.int64)
    jt = jtasks(jp, names, epoch, slots, jexp.epochs_max, None)
    tt = build_client_tasks(tp, names, epoch, slots, texp.epochs_max)
    plans = [build_batch_plan([e.client_indices[n] for n in names],
                              [int(x) for x in t.num_epochs],
                              int(jp["batch_size"]), e.plan_rng,
                              min_steps=e.steps_per_epoch,
                              min_epochs=e.epochs_max)
             for e, t in ((jexp, jt), (texp, tt))]
    np.testing.assert_array_equal(plans[0].idx, plans[1].idx)
    plan, C = plans[1], len(names)
    ns = plan.num_samples.astype(np.float32)
    rng_t, rng_a = jax.random.split(jax.random.key(0))
    jtrain = jexp.engine.train_fn(
        jexp.global_vars,
        jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], jt),
        jnp.asarray(plan.idx[None]), jnp.asarray(plan.mask[None]),
        jnp.arange(C, dtype=jnp.int32), rng_t)
    jres = jexp.engine.aggregate_fn(
        jexp.global_vars, jexp.fg_state, jtrain.deltas, jtrain.fg_grads,
        jtrain.fg_feature, jnp.asarray(jt.participant_id), jnp.asarray(ns),
        rng_a)
    ttrain = texp.engine.train_fn(texp.global_vars, [tt], plan.idx[None],
                                  plan.mask[None])
    tres = texp.engine.aggregate_fn(
        texp.global_vars, ttrain.deltas, fg_state=texp.fg_state,
        fg_grads=ttrain.fg_grads, fg_feature=ttrain.fg_feature,
        participant_ids=torch.from_numpy(tt.participant_id.astype(np.int64)),
        num_samples=torch.from_numpy(ns))
    name = texp.model_def.name
    jd = jax.device_get(jtrain.deltas)
    per_client = [_max_diff(
        _flat(name, ModelVars({k: v[c] for k, v in
                               ttrain.deltas.params.items()}, {})),
        jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda l: l[c], (jd.params, jd.batch_stats))))
        for c in range(C)]
    jg = jax.device_get(jres.new_vars)
    g_diff = _max_diff(_flat(name, tres.new_vars), jax.tree_util.tree_leaves(
        (jg.params, jg.batch_stats)))
    jexp.global_vars, jexp.fg_state = jres.new_vars, jres.new_fg_state
    texp.global_vars, texp.fg_state = tres.new_vars, tres.new_fg_state
    return per_client, g_diff, jax.device_get(jres), tres


def _csv(blob):
    return list(csv.reader(io.StringIO(blob.decode())))


def test_mnist_foolsgold_two_rounds_match_jax(tmp_path):
    jexp, texp = _experiments(dict(SMOKE, aggregation_methods="foolsgold"),
                              tmp_path)
    shape = tuple(texp.model_def.similarity_param(
        texp.global_vars.params).shape)
    per_client, g_diff, jres, tres = _engine_round(jexp, texp, 3)
    assert max(per_client) <= 1e-6, per_client
    assert g_diff <= 1e-5, g_diff
    for a, b in ((tres.wv, jres.wv), (tres.alpha, jres.alpha)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    # the memory rows this round wrote, in the JAX layout
    tmem = convert.fg_memory_to_jax(texp.fg_state.memory, shape)
    jmem = np.asarray(jres.new_fg_state.memory)
    assert np.abs(jmem).max() > 0
    np.testing.assert_allclose(tmem, jmem, rtol=0,
                               atol=1e-5 * np.abs(jmem).max())

    # round 2: the JAX run's memory, chained into the port
    texp.fg_state = FoolsGoldState(convert.fg_memory_from_jax(
        jmem, shape))
    jr, tr = jexp.run_round(4), texp.run_round(4)
    assert jr["agents"] == tr["agents"]
    jg = jax.device_get(jexp.global_vars)
    assert _max_diff(_flat(texp.model_def.name, texp.global_vars),
                     jax.tree_util.tree_leaves(
                         (jg.params, jg.batch_stats))) <= 1e-4
    for k in ("global_acc", "backdoor_acc"):
        assert abs(jr[k] - tr[k]) <= 1.0, k
    jo, to = j_canonical(jexp.folder), canonical_run_outputs(texp.folder)
    assert sorted(jo) == sorted(to)
    assert jo["round_result.csv"][0] == to["round_result.csv"][0]
    assert [sorted(r) for r in jo["metrics.jsonl"]] == \
        [sorted(r) for r in to["metrics.jsonl"]]
    for name in jo:
        if name.endswith(".csv") and name != "round_result.csv":
            assert [len(r) for r in _csv(jo[name])] == \
                [len(r) for r in _csv(to[name])], name
    jw, tw = _csv(jo["weight_result.csv"]), _csv(to["weight_result.csv"])
    assert len(jw) == len(tw) == 3 and jw[0] == tw[0]   # names, wv, alpha
    np.testing.assert_allclose(np.array(tw[1:], float),
                               np.array(jw[1:], float), rtol=0, atol=1e-5)
    assert all(np.isfinite(np.array(tw[1:], float)).ravel())


def test_mnist_rfa_round_matches_jax(tmp_path):
    jexp, texp = _experiments(dict(SMOKE, aggregation_methods="geom_median"),
                              tmp_path)
    per_client, g_diff, jres, tres = _engine_round(jexp, texp, 3)
    assert max(per_client) <= 1e-6, per_client
    assert g_diff <= 2e-5, g_diff
    assert int(tres.num_oracle_calls) == int(jres.num_oracle_calls)
    assert bool(tres.is_updated) == bool(jres.is_updated)
    for a, b in ((tres.wv, jres.wv), (tres.alpha, jres.alpha)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ the port's fault layer
BASE = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=6, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=600, synthetic_test_size=256, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False, random_seed=1)


def _exp(**over):
    return Experiment(Params.from_dict(dict(BASE, **over)),
                      save_results=False, device="cpu")


def _state(e):
    return {k: v.clone() for k, v in
            list(e.global_vars.params.items())
            + list(e.global_vars.batch_stats.items())}


def _finite(e):
    return all(bool(torch.isfinite(v).all()) for v in _state(e).values())


@pytest.mark.parametrize("aggregation", ["mean", "foolsgold"])
def test_injected_nan_is_quarantined_and_model_stays_finite(aggregation):
    e = _exp(aggregation_methods=aggregation, fault_injection=True,
             fault_corrupt_prob=0.4, fault_seed=3)
    results = [e.run_round(i) for i in (1, 2)]
    assert sum(r["n_quarantined"] for r in results) > 0
    assert not any(r["degraded"] for r in results)
    assert _finite(e) and all(np.isfinite(r["global_acc"]) for r in results)


def _corrupting(real_fn, fail_times, seen):
    """The engine's round with a NaN global model and global_finite False on
    its first `fail_times` calls: an aggregate overflow the screen could
    not prevent. Records each call's norm multiplier in `seen`."""
    def wrapped(*args, **kw):
        new_vars, new_fg, payload, deltas_out = real_fn(*args, **kw)
        seen.append(kw["norm_mult"])
        if len(seen) <= fail_times:
            new_vars = ModelVars(
                {k: v * float("nan") for k, v in new_vars.params.items()},
                new_vars.batch_stats)
            stats = payload[9]._replace(global_finite=torch.tensor(False))
            payload = payload[:9] + (stats,) + payload[10:]
        return new_vars, new_fg, payload, deltas_out
    return wrapped


@pytest.mark.parametrize("fail_times", [1, 99], ids=["recovers", "exhausted"])
def test_retry_escalates_the_norm_screen_then_degrades(fail_times):
    e = _exp(screen_updates=True, max_round_retries=2)
    before = _state(e)
    seen = []
    e.engine.round_fn = _corrupting(e.engine.round_fn, fail_times, seen)
    r = e.run_round(1)
    assert _finite(e) and np.isfinite(r["global_acc"])
    if fail_times == 1:
        assert seen == [0.0, 10.0]            # screen on at 10× the median
        assert r["n_retries"] == 1 and not r["degraded"]
    else:
        assert seen == [0.0, 10.0, 5.0]       # then halved per retry
        assert r["n_retries"] == 2 and r["degraded"]
        for k, v in _state(e).items():         # the pre-round model
            assert torch.equal(v, before[k]), k


def test_too_few_survivors_skip_and_carry():
    e = _exp(fault_injection=True, fault_dropout_prob=1.0)
    before = _state(e)
    r = e.run_round(1)
    assert r["degraded"] and r["n_dropped"] == 4
    for k, v in _state(e).items():
        assert torch.equal(v, before[k]), k
    row = dict(zip(["epoch", "global_acc", "global_loss", "backdoor_acc",
                    "n_quarantined", "n_dropped", "n_retries", "degraded",
                    "round_time"], e.recorder.round_result[-1]))
    assert row["degraded"] == 1 and row["n_dropped"] == 4


def test_stale_lane_replays_what_the_server_received():
    e = _exp(fault_injection=True, fault_stale_prob=1.0)
    before = _state(e)
    e.run_round(1)    # replays the empty history: the model stays put
    for k, v in _state(e).items():
        assert torch.equal(v, before[k]), k
    # half the clients replay: round 2 receives round 1's payload rows
    e = _exp(fault_injection=True, fault_stale_prob=0.5, fault_seed=1)
    e.run_round(1)
    got = []
    real = e.engine.round_fn

    def spy(*args, **kw):
        got.append((kw["prev_deltas"], kw["fault_plan"]))
        out = real(*args, **kw)
        got.append(out[3])
        return out

    e.engine.round_fn = spy
    prev = e._prev_deltas
    assert any(float(v.abs().sum()) > 0 for v in prev.params.values())
    e.run_round(2)
    (replayed, plan), received = got
    assert replayed is prev and bool(plan.stale.any())
    for k, v in received.params.items():
        rows = plan.stale
        assert torch.equal(v[rows], prev.params[k][rows]), k
    assert _finite(e)
