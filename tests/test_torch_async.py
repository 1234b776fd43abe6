"""The buffered-async engine of the port (dba_mod_tpu_torch/fl/async_rounds.py)
against the JAX package's (dba_mod_tpu/fl/async_rounds.py), at the JAX
tests' MNIST size (tests/test_async_rounds.py::BASE).

- staleness weights and arrival plans: the JAX package's numbers, the
  delays bitwise;
- the keystone: at buffer_k == no_models the port's async run is bitwise
  its own sync run (rows less wall times and async-only keys, every CSV,
  the global model), under FedAvg, DP noise, every robust rule, the screen
  and a poisoned run with the local battery;
- the port against the JAX package: from the same initial weights
  (convert.py), K = 2 and K = 3 polynomial-weighted runs with jitter and a
  straggler tail match merge for merge (async extras identical, the global
  model within 1e-6, accuracies within 1 point);
- the padded partial merge, kill-between-merges and graceful-stop resumes
  (bitwise against the straight run), the model-only resume;
- the self-healing knobs: deadline merges and TTL expiry against JAX runs
  that share their arrival draws, the rest against the JAX tests' own
  assertions (tests/test_self_healing.py), and the inert defaults;
- the config: what async rejects, and that it runs on the card by
  default."""
import json
import logging
from concurrent.futures import ThreadPoolExecutor
import signal
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl import async_rounds
from dba_mod_tpu_torch.fl.async_rounds import (AsyncDriver, ArrivalProcess,
                                               staleness_weights)
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs

REPO = Path(__file__).resolve().parent.parent
BASE = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=3, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=600, synthetic_test_size=256, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False, random_seed=1)
VOLATILE = {"time", "round_time", "dispatch_time", "finalize_time"}
ASYNC_ONLY = {"mode", "buffer_occupancy", "staleness_mean", "staleness_max",
              "waves_dispatched", "arrivals_total", "virtual_time"}
ARRIVALS = dict(arrival_rate=3.0, arrival_jitter=0.7, straggler_tail=0.25,
                straggler_factor=6.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exp(cfg, save=False, **kw):
    return Experiment(Params.from_dict(dict(cfg, **kw)), save_results=save,
                      device="cpu")


def _rows(exp, drop=()):
    return [{k: v for k, v in r.items() if k not in VOLATILE | set(drop)}
            for r in exp.recorder._jsonl_rows]


def _leaves(mv):
    return {**mv.params, **mv.batch_stats}


def _same_model(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k])
                                          for k in la)


def _file_rows(folder, drop=()):
    with open(Path(folder) / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in VOLATILE | set(drop)} for line in f
                if line.strip()]


# ------------------------------------------------ weights and arrival plans
@pytest.mark.parametrize("weighting,alpha", [
    ("none", 0.5), ("polynomial", 0.5), ("polynomial", 1.3),
    ("exponential", 0.7)])
def test_staleness_weights_match_jax(weighting, alpha):
    from dba_mod_tpu.fl.async_rounds import staleness_weights as jweights
    s = np.array([0, 1, 2, 5, 17], np.float32)
    got = staleness_weights(s, weighting, alpha)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jweights(s, weighting, alpha))
    assert staleness_weights(np.zeros(1), weighting, alpha)[0] == 1.0
    with pytest.raises(ValueError):
        staleness_weights(s, "inverse", alpha)


@pytest.mark.parametrize("seed,knobs", [
    (0, (1.0, 0.0, 0.0, 10.0)), (7, (2.0, 0.5, 0.3, 10.0)),
    (123, (0.5, 0.8, 0.2, 8.0)), (5, (2.0, 0.6, 0.25, 4.0))])
def test_arrival_delays_match_jax_bitwise(seed, knobs):
    from dba_mod_tpu.fl.async_rounds import ArrivalProcess as JArrivals
    rate, jitter, tail, factor = knobs
    mine = ArrivalProcess(seed, rate, jitter, tail, factor)
    theirs = JArrivals(seed, rate, jitter, tail, factor)
    for wave in (0, 1, 5, 37, 1000):
        for n in (4, 10, 16):
            np.testing.assert_array_equal(mine.delays(wave, n),
                                          theirs.delays(wave, n))
    assert not np.array_equal(mine.delays(0, 16), mine.delays(1, 16))
    with pytest.raises(ValueError):
        ArrivalProcess(seed, 0.0, jitter, tail, factor)


# ------------------------------------------------- keystone: sync reduction
SMOKE = dict(yaml.safe_load(open(REPO / "configs" / "smoke_params.yaml")),
             epochs=4)
KEYSTONE = {
    "fedavg": BASE,
    "dp": dict(BASE, diff_privacy=True, sigma=0.01),
    "rfa": dict(BASE, aggregation_methods="geom_median"),
    "krum": dict(BASE, aggregation_methods="krum"),
    "trimmed_mean": dict(BASE, aggregation_methods="trimmed_mean"),
    "median": dict(BASE, aggregation_methods="median"),
    "screen": dict(BASE, screen_updates=True, screen_norm_mult=3.0),
    "poisoned_local_eval": SMOKE,
}


@pytest.mark.parametrize("lane", sorted(KEYSTONE))
def test_k_equals_c_reduces_bitwise_to_sync(lane, tmp_path):
    """buffer_k == no_models: the port's async run is its sync run bit for
    bit (metrics rows less wall times and async-only keys, every recorder
    CSV, the global model, the DP stream's position) for any arrival
    knobs, since the merge sorts its buffer by (wave, lane)."""
    cfg = dict(KEYSTONE[lane], save_model=False)
    es = _exp(cfg, True, run_dir=str(tmp_path / "sync"))
    es.run()
    ea = _exp(dict(cfg, mode="async", **ARRIVALS), True,
              run_dir=str(tmp_path / "async"))
    ra = ea.run()
    assert ra["staleness_max"] == 0.0 and ra["buffer_occupancy"] == 4
    assert _rows(es) == _rows(ea, drop=ASYNC_ONLY)
    assert len(_rows(es)) == int(cfg["epochs"])
    want, got = (canonical_run_outputs(e.folder) for e in (es, ea))
    got["metrics.jsonl"] = [{k: v for k, v in r.items()
                             if k not in ASYNC_ONLY}
                            for r in got["metrics.jsonl"]]
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k] == got[k], k
    assert _same_model(es.global_vars, ea.global_vars)
    assert torch.equal(es.noise_gen.get_state(), ea.noise_gen.get_state())


# --------------------------------------------- the port against the JAX one
def _jax_pair(cfg):
    import jax
    from dba_mod_tpu.config import Params as JParams
    from dba_mod_tpu.fl.async_rounds import AsyncDriver as JDriver
    from dba_mod_tpu.fl.experiment import Experiment as JExperiment
    from dba_mod_tpu_torch import convert
    jexp = JExperiment(JParams.from_dict(cfg), save_results=False)
    texp = _exp(cfg)
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(texp.model_def.name,
                                              jmv.params, jmv.batch_stats)
    return jexp, JDriver(jexp), texp, AsyncDriver(texp)


def _global_gap(jexp, texp) -> float:
    import jax
    from dba_mod_tpu_torch import convert
    jmv = jax.device_get(jexp.global_vars)
    back = convert.from_jax_numpy(texp.model_def.name, jmv.params,
                                  jmv.batch_stats)
    mine = _leaves(texp.global_vars)
    return max(float((v - mine[k]).abs().max())
               for k, v in _leaves(back).items())


@pytest.mark.parametrize("k", [2, 3])
def test_polynomial_run_matches_jax_merge_for_merge(k):
    """K = 2 and 3 of 4-client cohorts (at 3 a merge takes lanes of two
    waves, so waves overlap), polynomial weighting, jitter and a heavy
    straggler tail (stale merges), no faults and no DP (which draw
    different streams in the two packages)."""
    cfg = dict(BASE, mode="async", buffer_k=k,
               staleness_weighting="polynomial", staleness_alpha=0.5,
               arrival_rate=2.0, arrival_jitter=0.6, straggler_tail=0.4,
               straggler_factor=12.0, random_seed=3)
    jexp, jd, texp, td = _jax_pair(cfg)
    gaps = []
    for _ in range(8):
        jr, tr = jd.run_steps(1), td.run_steps(1)
        for k in ASYNC_ONLY:
            assert jr[k] == tr[k], (k, jr[k], tr[k])
        assert jr["agents"] == tr["agents"]
        assert abs(jr["global_acc"] - tr["global_acc"]) <= 1.0
        gaps.append(_global_gap(jexp, texp))
    assert max(gaps) <= 1e-6, gaps
    stats = td.stats()
    assert stats == {k: v for k, v in jd.stats().items() if k in stats}
    if k == 3:
        assert stats["outstanding_waves_highwater"] >= 2
    assert max(r["staleness_max"] for r in texp.recorder._jsonl_rows) >= 1


# ------------------------------------------- partial buffer padded to K
def test_partial_buffer_merges_padded_to_k():
    """Occupancy < K (the graceful-stop flush) goes through the same merge:
    zero padding lanes, the occupancy mask, the divisor = the present
    updates — so a one-update merge moves the model by eta x that update."""
    e = _exp(BASE, mode="async", buffer_k=4, async_steps=2)
    d = AsyncDriver(e)
    d._fill_buffer()
    (wid, lane), *_ = sorted(d._buffer)
    d._buffer = sorted(d._buffer)[:1]        # strand 3 arrivals in flight
    delta = {k: v[lane].clone() for k, v in
             _leaves(d._waves[wid].deltas).items()}
    before = {k: v.clone() for k, v in _leaves(e.global_vars).items()}
    r1 = d._merge_and_record()
    assert r1["buffer_occupancy"] == 1
    after = _leaves(e.global_vars)
    for k, v in before.items():
        torch.testing.assert_close(after[k], v + 0.8 * delta[k], rtol=0,
                                   atol=1e-6)
    d._fill_buffer()
    r2 = d._merge_and_record()
    assert r2["buffer_occupancy"] == 4
    rows = e.recorder._jsonl_rows
    assert [r["epoch"] for r in rows] == [1, 2]
    assert np.isfinite([r["global_acc"] for r in rows]).all()


# ------------------------------------------------------ checkpoint / resume
RESUME_CFG = dict(BASE, epochs=6, save_model=True, mode="async", buffer_k=2,
                  arrival_rate=2.0, arrival_jitter=0.6, straggler_tail=0.25,
                  straggler_factor=4.0, staleness_weighting="polynomial",
                  async_steps=8, random_seed=3)
RESUME_LANES = {
    "k2": RESUME_CFG,
    # K > C with heavy dropout: waves outnumber merges, so resolved waves'
    # rows carry epochs past the committed merge step
    "dropout": dict(RESUME_CFG, buffer_k=5, fault_injection=True,
                    fault_dropout_prob=0.5, fault_seed=5, local_eval=True,
                    async_steps=6),
}


def _all_outputs(folder):
    out = canonical_run_outputs(folder)
    out["metrics.jsonl"] = _file_rows(folder)
    return out


@pytest.mark.parametrize("lane", sorted(RESUME_LANES))
def test_kill_between_merges_resume_is_bitwise(lane, tmp_path):
    """A run dropped after half its merges committed (the process dies
    between merges), resumed with resumed_model: auto: the sidecar's
    async_state restores the heap, buffer and live cohorts, and the run
    ends bitwise the straight run — every recorded row and the global
    model. The dropout lane's waves outrun its merges, so its per-client
    rows carry epochs past the committed step."""
    cfg = RESUME_LANES[lane]
    steps = int(cfg["async_steps"])
    ref = _exp(cfg, True, run_dir=str(tmp_path / "ref"))
    ref.run()
    a = _exp(cfg, True, run_dir=str(tmp_path / "ab"), async_steps=steps // 2)
    a.run()
    folder = a.folder
    del a
    b = _exp(cfg, True, run_dir=str(tmp_path / "ab"), resumed_model="auto")
    assert b.folder == folder
    assert (b._resume_aux or {}).get("async_state") is not None
    b.run()
    assert [r["epoch"] for r in _file_rows(folder)] == list(
        range(1, steps + 1))
    want, got = _all_outputs(ref.folder), _all_outputs(folder)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k] == got[k], k
    assert _same_model(ref.global_vars, b.global_vars)


def test_kill_inside_a_save_resumes_from_the_prev_clone(tmp_path,
                                                       monkeypatch):
    """The process dies inside merge 5's save, after model_last's state and
    sidecar were rewritten but before its manifest: model_last no longer
    verifies, auto-resume takes its .prev clone (merge 4) with that
    merge's streaming state and recorder row counts, and the run ends
    bitwise the straight run."""
    ref = _exp(RESUME_CFG, True, run_dir=str(tmp_path / "ref"))
    ref.run()
    a = _exp(RESUME_CFG, True, run_dir=str(tmp_path / "ab"))

    class Died(Exception):
        pass

    real = ckpt.CheckpointManager.note_saved

    def die_at_5(self, paths, epoch):
        if epoch == 5:
            raise Died
        real(self, paths, epoch)

    monkeypatch.setattr(ckpt.CheckpointManager, "note_saved", die_at_5)
    with pytest.raises(Died):
        a.run()
    monkeypatch.setattr(ckpt.CheckpointManager, "note_saved", real)
    folder = a.folder
    del a
    assert not ckpt.verify_checkpoint(folder / "model_last.pt.tar")[0]
    b = _exp(RESUME_CFG, True, run_dir=str(tmp_path / "ab"),
             resumed_model="auto")
    assert b.folder == folder and b.start_epoch == 5
    b.run()
    want, got = _all_outputs(ref.folder), _all_outputs(folder)
    for k in want:
        assert want[k] == got[k], k
    assert _same_model(ref.global_vars, b.global_vars)


def test_model_only_resume_restarts_stream_with_warning(tmp_path, caplog):
    """A checkpoint without the async_state sidecar resumes model-only:
    empty buffer, the "buffer state lost" warning, no duplicate steps."""
    cfg = dict(BASE, save_model=True, mode="async", buffer_k=2,
               async_steps=4, run_dir=str(tmp_path / "runs"))
    a = _exp(cfg, True, async_steps=2)
    a.run()
    folder = a.folder
    del a
    for snap in (folder / "model_last.pt.tar",
                 folder / "model_last.pt.tar.best"):
        aux = ckpt.load_aux_state(snap)
        if aux is not None:
            aux.pop("async_state", None)
            ckpt.save_aux_state(snap, aux)
            ckpt.write_manifest(snap, int(aux["epoch"]))
    with caplog.at_level(logging.WARNING,
                         logger="dba_mod_tpu_torch.async_rounds"):
        b = _exp(cfg, True, resumed_model="auto")
        d = AsyncDriver(b)
        assert (d.version, d.wave) == (2, 1)   # version·K // C
        b.run()
    assert any("buffer state lost" in r.getMessage()
               for r in caplog.records)
    assert [r["epoch"] for r in _file_rows(folder)] == [1, 2, 3, 4]


def test_model_only_resume_from_a_sync_pretrain_moves_the_counters(
        tmp_path):
    """Resuming an async config from a sync snapshot of epoch N (no
    sidecar): version = N, wave = N·K // C, and the run goes on until
    version reaches async_steps — the waves carry epochs N·K//C + 1, ..."""
    pre = _exp(BASE, save_model=False)
    pre.run(4)
    path = tmp_path / "pre" / "model.pt.tar"
    ckpt.save_checkpoint(path, pre.global_vars, 4, float(pre.params["lr"]))
    e = _exp(BASE, mode="async", buffer_k=2, async_steps=6,
             resumed_model=True, checkpoint_dir=str(tmp_path / "pre"),
             resumed_model_name="model.pt.tar")
    assert e.start_epoch == 5
    r = e.run()
    assert [row["epoch"] for row in e.recorder._jsonl_rows] == [5, 6]
    assert r["waves_dispatched"] == 4 // 2 + 1
    assert {row[2] for row in e.recorder.train_result} == {3}


def test_graceful_stop_flushes_partial_buffer_then_resumes(tmp_path,
                                                           monkeypatch):
    """The guard's stop flag (what SIGTERM sets; simulated in process)
    lands while the third wave trains: the fill dispatches nothing more,
    the run flushes what the buffer holds as one padded merge, checkpoints
    it and stops (the CLI's exit 75); --resume auto then runs the
    remaining merges, every step exactly once."""
    cfg = dict(RESUME_CFG, graceful_shutdown=True, buffer_k=3)
    a = _exp(cfg, True, run_dir=str(tmp_path / "run"))
    real = AsyncDriver._dispatch_wave

    def dispatch_then_stop(self):
        real(self)
        if self.wave == 3:
            self.exp.guard.shutdown._handler(signal.SIGTERM, None)

    monkeypatch.setattr(AsyncDriver, "_dispatch_wave", dispatch_then_stop)
    last = a.run()
    monkeypatch.setattr(AsyncDriver, "_dispatch_wave", real)
    step = last["epoch"]
    assert a.interrupted and 1 < step < 8
    assert 0 < last["buffer_occupancy"] < 3     # the partial flush
    assert last["waves_dispatched"] == 3
    folder = a.folder
    assert ckpt.manifest_epoch(folder / "model_last.pt.tar") == step
    assert [r["epoch"] for r in _file_rows(folder)] == list(
        range(1, step + 1))
    del a
    b = _exp(cfg, True, run_dir=str(tmp_path / "run"), resumed_model="auto")
    assert b.folder == folder and b.start_epoch == step + 1
    b.run()
    assert not b.interrupted
    assert [r["epoch"] for r in _file_rows(folder)] == list(range(1, 9))
    assert ckpt.verify_checkpoint(folder / "model_last.pt.tar")[0]


def test_sigkill_between_merges_then_auto_resume_through_the_cli(tmp_path):
    """crash_smoke's launcher (as chip_smoke phase 10c uses it): a
    ``main train`` process at configs/async_smoke_params.yaml's knobs is
    SIGKILLed once merge 3's checkpoint is committed — possibly inside a
    later save, when the resume falls back to model_last's .prev clone —
    then relaunched with --resume auto: the run ends bitwise the straight
    run, every step recorded once. The straight run goes on a worker
    thread beside the killed process."""
    import os
    from dba_mod_tpu_torch import crash_smoke
    cfg = dict(yaml.safe_load(open(REPO / "configs" /
                                   "async_smoke_params.yaml")),
               async_steps=12)
    ref = _exp(cfg, True, run_dir=str(tmp_path / "ref"))
    pool = ThreadPoolExecutor(max_workers=1)
    ref_done = pool.submit(ref.run)
    cfg_path = tmp_path / "async.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(cfg,
                                            run_dir=str(tmp_path / "run"))))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    info = crash_smoke.interrupted_run(cfg_path, "cpu", 3, env=env,
                                       timeout=240, sig=signal.SIGKILL)
    assert info["epochs"] == list(range(1, 13))
    assert info["resumed_from"][1] >= 3
    ref_done.result()
    pool.shutdown()
    like = ref.global_vars
    got, epoch, _ = ckpt.load_checkpoint(
        info["folder"] / "model_last.pt.tar", like)
    assert epoch == 12 and _same_model(ref.global_vars, got)
    assert _file_rows(info["folder"]) == _file_rows(ref.folder)


# ---------------------------------------------------- self-healing knobs
def _run_steps(cfg, n):
    e = _exp(cfg)
    d = AsyncDriver(e)
    d.run_steps(n)
    return e, d


def _jax_steps(cfg, n):
    from dba_mod_tpu.config import Params as JParams
    from dba_mod_tpu.fl.async_rounds import AsyncDriver as JDriver
    from dba_mod_tpu.fl.experiment import Experiment as JExperiment
    e = JExperiment(JParams.from_dict(cfg), save_results=False)
    d = JDriver(e)
    d.run_steps(n)
    return e, d


def _stream(exp):
    return [{k: r[k] for k in ("epoch", "agents", "buffer_occupancy",
                               "staleness_mean", "staleness_max",
                               "waves_dispatched", "arrivals_total",
                               "virtual_time", "n_dropped", "degraded")}
            for r in exp.recorder._jsonl_rows]


def test_deadline_merges_match_jax():
    """A tight merge_timeout_v fires partial merges before K arrivals; the
    arrival draws are shared, so the merge stream (occupancy, staleness,
    virtual time) and the counters are the JAX package's."""
    cfg = dict(BASE, mode="async", buffer_k=4, async_steps=6,
               arrival_rate=0.5, arrival_jitter=0.8, straggler_tail=0.3,
               straggler_factor=20.0, merge_timeout_v=0.05, merge_min_k=1)
    e, d = _run_steps(cfg, 6)
    je, jd = _jax_steps(cfg, 6)
    assert d.stats()["deadline_merges"] > 0
    assert any(r["buffer_occupancy"] < 4 for r in e.recorder._jsonl_rows)
    assert _stream(e) == _stream(je)
    stats = d.stats()
    assert stats == {k: v for k, v in jd.stats().items() if k in stats}
    e2, d2 = _run_steps(cfg, 6)
    assert _rows(e) == _rows(e2) and d.stats() == d2.stats()
    assert _same_model(e.global_vars, e2.global_vars)


def test_arrival_ttl_matches_jax():
    """arrival_ttl_v expires stragglers whose delay exceeded the TTL: they
    never reach the buffer; the same expiries as the JAX package's."""
    cfg = dict(BASE, mode="async", buffer_k=2, async_steps=4,
               straggler_tail=0.5, straggler_factor=1000.0,
               arrival_ttl_v=20.0)
    e, d = _run_steps(cfg, 4)
    je, jd = _jax_steps(cfg, 4)
    assert d.stats()["expired_arrivals"] > 0
    assert d.stats()["expired_arrivals"] == jd.stats()["expired_arrivals"]
    assert _stream(e) == _stream(je)
    rows = e.recorder._jsonl_rows
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4]
    assert np.isfinite([r["global_acc"] for r in rows]).all()


def test_backpressure_caps_outstanding_waves():
    """K above the per-cohort yield (heavy dropout) piles up resident
    waves; max_outstanding_waves flushes partial merges at the watermark
    instead."""
    cfg = dict(BASE, mode="async", buffer_k=8, async_steps=4,
               fault_injection=True, fault_dropout_prob=0.7, fault_seed=5)
    _, d0 = _run_steps(cfg, 4)
    assert d0.stats()["outstanding_waves_highwater"] > 3
    e1, d1 = _run_steps(dict(cfg, max_outstanding_waves=3), 4)
    s1 = d1.stats()
    assert s1["outstanding_waves_highwater"] <= 3
    assert s1["backpressure_hits"] > 0
    rows = e1.recorder._jsonl_rows
    assert any(r["buffer_occupancy"] < 8 for r in rows)
    assert np.isfinite([r["global_acc"] for r in rows]).all()


def test_starvation_carry_records_degraded_noop_steps(monkeypatch):
    """fault_dropout_prob 1.0 starves the queue: "abort" raises; "carry"
    spends the budget as recorded degraded no-op steps, model untouched."""
    monkeypatch.setattr(async_rounds, "STARVATION_LIMIT", 5)
    cfg = dict(BASE, mode="async", buffer_k=2, async_steps=1,
               fault_injection=True, fault_dropout_prob=1.0, fault_seed=7)
    with pytest.raises(RuntimeError, match="starved"):
        _exp(cfg).run()
    e = _exp(cfg, starvation_policy="carry")
    before = {k: v.clone() for k, v in _leaves(e.global_vars).items()}
    e.run()
    rows = e.recorder._jsonl_rows
    assert [r["epoch"] for r in rows] == [1]
    assert rows[0]["degraded"] and rows[0]["buffer_occupancy"] == 0
    assert rows[0]["n_dropped"] == 4 * 6
    assert np.isfinite(rows[0]["global_acc"])
    assert all(torch.equal(v, _leaves(e.global_vars)[k])
               for k, v in before.items())


def test_min_surviving_clients_skips_and_carries():
    """Every payload NaN-corrupted in transit → screened out → zero
    survivors → the merge is skipped and the model carried."""
    cfg = dict(BASE, mode="async", buffer_k=4, async_steps=2,
               fault_injection=True, fault_corrupt_prob=1.0, fault_seed=3,
               min_surviving_clients=1)
    e = _exp(cfg)
    before = {k: v.clone() for k, v in _leaves(e.global_vars).items()}
    e.run()
    rows = e.recorder._jsonl_rows
    assert all(r["degraded"] for r in rows)
    assert all(r["n_quarantined"] == 4 for r in rows)
    assert all(torch.equal(v, _leaves(e.global_vars)[k])
               for k, v in before.items())
    assert np.isfinite([r["global_acc"] for r in rows]).all()


def test_health_rollback_restores_premerge_model():
    """Merges outside a microscopic health band roll back to the last-good
    ring: the model after them is bitwise the one merge 1 committed, the
    steps are recorded degraded, and the stream keeps going."""
    cfg = dict(BASE, mode="async", buffer_k=4, async_steps=3,
               model_health_check=True, health_norm_band=1e-9,
               health_warmup_merges=1, rollback_ring=2)
    e, d = _run_steps(cfg, 1)
    good = {k: v.clone() for k, v in _leaves(e.global_vars).items()}
    d.run_steps(2)
    assert d.stats()["health_rollbacks"] == 2
    assert all(torch.equal(v, _leaves(e.global_vars)[k])
               for k, v in good.items())
    rows = e.recorder._jsonl_rows
    assert [r["degraded"] for r in rows] == [False, True, True]
    assert np.isfinite([r["global_acc"] for r in rows]).all()


def test_health_rollback_lane_matches_jax_merge_for_merge():
    """The rollback lane draws no random numbers, so the JAX driver checks
    it as it stands: from the same initial weights, merge for merge, the
    same arrivals and sentinel decisions (degraded steps, rollbacks), the
    sentinel's EMA and merge count, the global model within 1e-6."""
    cfg = dict(BASE, mode="async", buffer_k=2, async_steps=4,
               model_health_check=True, health_norm_band=1e-9,
               health_warmup_merges=1, rollback_ring=2, **ARRIVALS)
    jexp, jd, texp, td = _jax_pair(cfg)
    for _ in range(4):
        jr, tr = jd.run_steps(1), td.run_steps(1)
        for k in ASYNC_ONLY | {"agents", "degraded", "n_retries"}:
            assert jr[k] == tr[k], (k, jr[k], tr[k])
        assert abs(jr["global_acc"] - tr["global_acc"]) <= 1.0
        assert _global_gap(jexp, texp) <= 1e-6
        js, ts = jexp._sentinel, texp._sentinel
        assert js.merges == ts.merges
        assert ts.ema == pytest.approx(js.ema, rel=1e-5)
    assert td.stats()["health_rollbacks"] == jd.stats()["health_rollbacks"]
    assert [r["degraded"] for r in texp.recorder._jsonl_rows] == \
        [False, True, True, True]


def test_health_remerge_escalates_the_screen():
    """A blown-up payload passes the finite-only screen, so the merge
    leaves the health band; the sentinel re-merges the same buffer with the
    norm screen escalated to 10x the median, which quarantines it, and the
    step commits healthy with its retry counted."""
    cfg = dict(BASE, mode="async", buffer_k=4, async_steps=4,
               fault_injection=True, fault_blowup_prob=0.2,
               fault_blowup_factor=1e3, fault_seed=1, screen_updates=True,
               screen_norm_mult=0.0, model_health_check=True,
               health_norm_band=3.0, health_warmup_merges=1)
    e, d = _run_steps(cfg, 4)
    rows = e.recorder._jsonl_rows
    healed = [r for r in rows if r["n_retries"] > 0 and not r["degraded"]]
    assert healed and all(r["n_quarantined"] >= 1 for r in healed)
    # a merge the escalation cannot heal rolls back, recorded degraded
    assert d.stats()["health_rollbacks"] == sum(r["degraded"] for r in rows)
    assert all(torch.isfinite(v).all() for v in _leaves(e.global_vars)
               .values())


def test_inert_knobs_are_a_bitwise_noop():
    """Every self-healing knob at a value that cannot fire leaves the run
    bitwise the all-defaults run."""
    cfg = dict(BASE, mode="async", buffer_k=2, async_steps=4,
               arrival_rate=2.0, arrival_jitter=0.5, straggler_tail=0.2,
               straggler_factor=5.0)
    ref = _exp(cfg)
    ref.run()
    loud = _exp(dict(cfg, merge_timeout_v=1e9, merge_min_k=2,
                     starvation_policy="wait", max_outstanding_waves=1000,
                     arrival_ttl_v=1e9, model_health_check=True,
                     health_norm_band=0.0, rollback_ring=3))
    loud.run()
    assert _rows(ref) == _rows(loud)
    assert _same_model(ref.global_vars, loud.global_vars)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("bad,match", [
    (dict(aggregation_methods="foolsgold"), "foolsgold"),
    (dict(aggr_epoch_interval=2), "aggr_epoch_interval"),
    pytest.param(dict(fault_num_hosts=-1), "fault_num_hosts",
                 id="bad2-A18")])
def test_async_config_rejections(bad, match):
    """The async engine's config rejections are the reference's (the A18
    case: the host-loss lane's host count is validated as there)."""
    from dba_mod_tpu.config import Params as JParams
    for P in (Params, JParams):
        with pytest.raises(ValueError, match=match):
            P.from_dict(dict(BASE, mode="async", **bad))


@pytest.mark.parametrize("knob", ["overlap_eval", "telemetry"])
def test_async_config_accepts_the_a17_knobs(knob):
    """overlap_eval (the merge pipeline) and telemetry are ported in
    async mode too: the config takes them as the reference's does."""
    from dba_mod_tpu.config import Params as JParams
    raw = dict(BASE, mode="async", **{knob: True})
    assert Params.from_dict(raw).raw == JParams.from_dict(raw).raw


def test_async_config_is_ported_and_runs_on_the_card_by_default(
        monkeypatch, tmp_path):
    """The config accepts mode: async; the CLI runs it
    on the card unless --device cpu is given, and without a card asking
    for it raises."""
    from dba_mod_tpu_torch.main import main
    p = Params.from_dict(dict(BASE, mode="async"))
    assert p["mode"] == "async"
    cfg_path = tmp_path / "async.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        BASE, mode="async", buffer_k=2, async_steps=2,
        run_dir=str(tmp_path / "runs"))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["train", "--params", str(cfg_path), "--no-save"])
    assert main(["train", "--params", str(cfg_path), "--device", "cpu"]) == 0
    (folder,) = (tmp_path / "runs").iterdir()
    rows = _file_rows(folder)
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(r["mode"] == "async" for r in rows)
