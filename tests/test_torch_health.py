"""The health sentinel and the defense forensics of the port against the JAX
package (dba_mod_tpu/fl/rounds.py, dba_mod_tpu/utils/forensics.py), on the
CPU.

- forensic_stats and model_health_stats on the same inputs, with a NaN
  client row and a dropped client: norms and cosines within 1e-6, verdict,
  reason and oracle calls equal; HealthSentinel fed the same merges gives
  the same decisions and EMA.
- ForensicsWriter: the same add_round calls write byte-identical
  forensics.jsonl and client_forensics.csv, render_report the same HTML,
  and the CSV keeps the JAX package's column schema
  (tests/test_forensics.py::test_schema_golden).
- The sync rollback: an MNIST run whose round 2 carries a ×100 adversary,
  with a band of 3 armed after one merge — both packages roll back that
  round and carry the round-1 model, to 1e-5 of each other
  (tests/test_self_healing.py::test_sync_health_rollback_degrades_round);
  a health check with no band changes no recorded value
  (::test_sync_health_check_with_no_band_is_value_identical).
- End to end in the port: injected NaN payloads get verdict 0 with reason
  'nonfinite', consistent with the round's quarantine count."""
import csv
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dba_mod_tpu.fl import rounds as jrounds
from dba_mod_tpu.models import ModelVars as JModelVars
from dba_mod_tpu.utils import forensics as jforensics
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl import rounds
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.utils import forensics
from test_torch_slice import _experiments

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
VOLATILE = {"time", "round_time", "dispatch_time", "finalize_time"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHAPES = {"w": (6, 5), "b": (6,), "v": (4, 3, 2)}


def _trees(rng, C=5):
    """(global, new, stacked received deltas) as numpy dicts; client 2's
    row is NaN-corrupted."""
    g = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    n = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32)
         for k, v in g.items()}
    d = {k: rng.randn(C, *s).astype(np.float32) for k, s in SHAPES.items()}
    d["w"][2, 1, 1] = np.nan
    return g, n, d


def _pair(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def test_forensic_and_health_stats_match_jax():
    rng = np.random.RandomState(0)
    g, n, d = _trees(rng)
    (jg, tg), (jn, tn), (jd, td) = _pair(g), _pair(n), _pair(d)
    # client 3 dropped, client 2 screened out as non-finite
    mask = np.array([1, 1, 0, 0, 1], bool)
    reason = np.array([rounds.REASON_OK, rounds.REASON_OK,
                       rounds.REASON_NONFINITE, rounds.REASON_DROPPED,
                       rounds.REASON_OK], np.int32)
    assert rounds.REASON_NAMES == jrounds.REASON_NAMES
    jf = jax.device_get(jrounds.forensic_stats(
        JModelVars(jg, {}), JModelVars(jn, {}), JModelVars(jd, {}),
        jnp.asarray(mask), jnp.asarray(reason), 7))
    tf = rounds.forensic_stats(
        ModelVars(tg, {}), ModelVars(tn, {}), ModelVars(td, {}),
        torch.from_numpy(mask), torch.from_numpy(reason), 7)
    for name in ("recv_norms", "cosine_to_agg"):
        got, want = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        assert np.isnan(got[2])          # the corrupted row, honestly
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tf.verdict.numpy(), np.asarray(jf.verdict))
    np.testing.assert_array_equal(tf.reason.numpy(), np.asarray(jf.reason))
    assert tf.reason.dtype == torch.int32
    assert int(tf.oracle_calls) == int(jf.oracle_calls) == 7

    # model_health_stats over the full state, a NaN leaf included
    jfin, jnorm = jax.device_get(jrounds.model_health_stats(
        JModelVars(jg, {}), JModelVars(jn, {})))
    tfin, tnorm = rounds.model_health_stats(ModelVars(tg, {}),
                                            ModelVars(tn, {}))
    assert bool(tfin) == bool(jfin) is True
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6
    bad = dict(n, b=n["b"].copy())
    bad["b"][0] = np.inf
    jb, tb = _pair(bad)
    assert not bool(rounds.model_health_stats(ModelVars(tg, {}),
                                              ModelVars(tb, {}))[0])
    assert not bool(jrounds.model_health_stats(JModelVars(jg, {}),
                                               JModelVars(jb, {}))[0])


def test_sentinel_same_merges_same_decisions_and_ema():
    """Both sentinels fed one sequence of merges: a warm-up, ordinary
    merges, a blow-up outside the band, a non-finite merge and a merge
    back inside the band."""
    rng = np.random.RandomState(1)
    g, _, _ = _trees(rng)
    jsent = jrounds.HealthSentinel(band=2.0, ema_alpha=0.3, warmup=2,
                                   ring_size=2)
    tsent = rounds.HealthSentinel(band=2.0, ema_alpha=0.3, warmup=2,
                                  ring_size=2)
    decisions = []
    for step, scale in enumerate((0.1, 0.12, 0.09, 5.0, np.nan, 0.11)):
        n = {k: v + scale * rng.randn(*v.shape).astype(np.float32)
             for k, v in g.items()}
        (jg, tg), (jn, tn) = _pair(g), _pair(n)
        jh, jnorm = jsent.check(JModelVars(jg, {}), JModelVars(jn, {}))
        th, tnorm = tsent.check(ModelVars(tg, {}), ModelVars(tn, {}))
        assert th == jh, step
        if math.isnan(jnorm):
            assert math.isnan(tnorm)
        else:
            assert abs(tnorm - jnorm) <= 1e-6 * max(1.0, jnorm)
        if th:
            jsent.commit(step, JModelVars(jn, {}), jnorm)
            tsent.commit(step, ModelVars(tn, {}), tnorm)
            g = n
        decisions.append(th)
        assert abs(tsent.ema - jsent.ema) <= 1e-6 * max(1.0, jsent.ema)
        assert tsent.merges == jsent.merges
    assert decisions == [True, True, True, False, False, True]
    assert [v for v, _ in tsent.ring] == [v for v, _ in jsent.ring] == [2, 5]
    st = tsent.state()
    assert st == {"ema": pytest.approx(jsent.ema, abs=1e-6),
                  "merges": jsent.merges}
    fresh = rounds.HealthSentinel(2.0, 0.3, 2, 0)
    fresh.load_state(st)
    assert (fresh.ema, fresh.merges) == (st["ema"], st["merges"])


def _add_rounds(writer):
    nan, inf = float("nan"), float("inf")
    writer.add_round(
        epoch=3, aggregation="foolsgold", names=[7, 0, "a/b", 4],
        participant_ids=[7, 0, 11, 4], adversary_flags=[0, 1, 0, 1],
        delta_norms=np.array([0.5, 12.25, nan, 1e-9], np.float32),
        recv_norms=np.array([0.5, 12.25, nan, inf], np.float32),
        cosine=np.array([0.25, -0.5, nan, 0.0], np.float32),
        verdict=np.array([1, 1, 0, 0], bool),
        reason_codes=np.array([0, 0, 2, 1], np.int32),
        reason_names=rounds.REASON_NAMES,
        weights=np.array([1.0, 0.0, 0.5, 0.75], np.float32),
        alpha=np.array([0.1, 0.99, 0.3, 0.2], np.float32),
        poison_acc=np.array([10.0, 95.5, 0.0, 12.5], np.float32),
        oracle_calls=1, n_retries=2, degraded=False)
    writer.add_round(
        epoch=4, aggregation="mean", names=[1, 2],
        participant_ids=[1, 2], adversary_flags=[0, 0],
        delta_norms=np.array([0.3, 0.4]), recv_norms=np.array([0.3, 0.4]),
        cosine=np.array([0.9, 0.8]), verdict=np.array([1, 1], bool),
        reason_codes=np.array([0, 0]), reason_names=rounds.REASON_NAMES,
        degraded=True)


def test_forensics_writer_and_report_byte_identical(tmp_path):
    # one run-folder name (the report's title carries it)
    jdir, tdir = tmp_path / "jax" / "run", tmp_path / "torch" / "run"
    jw = jforensics.ForensicsWriter(jdir)
    tw = forensics.ForensicsWriter(tdir)
    for w in (jw, tw):
        _add_rounds(w)
        w.save()
    for name in ("forensics.jsonl", "client_forensics.csv"):
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    assert forensics.FORENSICS_HEADER == jforensics.FORENSICS_HEADER
    html = forensics.render_report(tdir)
    assert html == jforensics.render_report(jdir)
    assert html.startswith("<!DOCTYPE html>") and "<svg" in html
    # the schema golden: int columns are ints, float columns blank or
    # parseable, reasons from REASON_NAMES
    with open(tdir / "client_forensics.csv") as f:
        header, *rows = list(csv.reader(f))
    assert len(rows) == 6
    for row in rows:
        rec = dict(zip(header, row))
        for c in ("epoch", "client", "participant_id", "adversary",
                  "verdict"):
            assert rec[c] == str(int(rec[c])), (c, rec[c])
        for c in ("delta_norm", "recv_norm", "cosine_to_agg", "agg_weight",
                  "fg_max_sim", "rfa_distance", "poison_acc"):
            if rec[c] != "":
                float(rec[c])
        assert rec["reason"] in rounds.REASON_NAMES.values()
    # truncate-and-continue on resume
    tw2 = forensics.ForensicsWriter(tdir)
    assert tw2.load_from_folder(3) == 1 and len(tw2.rows) == 4


def _rows(exp):
    return [{k: v for k, v in r.items() if k not in VOLATILE}
            for r in exp.recorder._jsonl_rows]


def _health_cfg(**kw):
    raw = yaml.safe_load(open(CONFIGS / "smoke_params.yaml"))
    raw.update(local_eval=False, scale_weights_poison=100.0, **kw)
    return raw


def test_sync_health_rollback_degrades_the_x100_round_in_both(tmp_path):
    # adversary 0 poisons round 2 only, ×100
    raw = _health_cfg(model_health_check=True, health_norm_band=3.0,
                      health_warmup_merges=1,
                      **{"0_poison_epochs": [2], "1_poison_epochs": []})
    jexp, texp = _experiments(raw, tmp_path, save=False)
    models = {}
    for ep in (1, 2):
        jr, tr = jexp.run_round(ep), texp.run_round(ep)
        assert jr["agents"] == tr["agents"]
        models[ep] = {k: v.clone() for k, v in texp.global_vars.params.items()}
    jdeg = [r["degraded"] for r in jexp.recorder._jsonl_rows]
    tdeg = [r["degraded"] for r in texp.recorder._jsonl_rows]
    assert [r["adversaries"] for r in texp.recorder._jsonl_rows] == [[], ["0"]]
    assert jdeg == tdeg == [False, True]
    assert texp._sentinel.merges == jexp._sentinel.merges == 1
    assert abs(texp._sentinel.ema - jexp._sentinel.ema) <= 1e-5
    # the rolled-back round carries the round-1 model (no ring: the
    # pre-merge fallback), bitwise, and the packages agree on it
    for k, v in texp.global_vars.params.items():
        assert torch.equal(v, models[1][k]), k
    jg = jax.device_get(jexp.global_vars)
    got = jax.tree_util.tree_leaves(convert.to_jax_numpy(
        texp.model_def.name, texp.global_vars))
    want = jax.tree_util.tree_leaves((jg.params, jg.batch_stats))
    assert max(float(np.abs(a - np.asarray(b)).max())
               for a, b in zip(got, want)) <= 1e-5
    assert all(math.isfinite(r["global_acc"])
               for r in texp.recorder._jsonl_rows)


def test_sync_health_check_with_no_band_is_value_identical():
    raw = _health_cfg(epochs=2)
    ref = Experiment(Params.from_dict(raw), save_results=False, device="cpu")
    ref.run(2)
    chk = Experiment(Params.from_dict(dict(raw, model_health_check=True)),
                     save_results=False, device="cpu")
    chk.run(2)
    assert _rows(ref) == _rows(chk)
    for k, v in ref.global_vars.params.items():
        assert torch.equal(v, chk.global_vars.params[k]), k


def test_quarantined_clients_marked_in_forensic_rows(tmp_path):
    raw = _health_cfg(epochs=2, forensics=True, fault_injection=True,
                      fault_corrupt_prob=0.5, fault_seed=0,
                      run_dir=str(tmp_path / "runs"))
    e = Experiment(Params.from_dict(raw), save_results=True, device="cpu")
    results = [e.run_round(ep) for ep in (1, 2)]
    recs = [json.loads(line) for line in
            (e.folder / "forensics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert sum(r["n_quarantined"] for r in recs) >= 1
    for res, rec in zip(results, recs):
        assert rec["n_quarantined"] == res["n_quarantined"]
        assert len(rec["clients"]) == 4
        for v, why, norm in zip(rec["verdict"], rec["reason"],
                                rec["recv_norm"]):
            assert (v == 0) == (why == "nonfinite")
            if why == "nonfinite":
                assert norm is None     # non-finite → null in the JSONL
