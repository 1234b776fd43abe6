"""Round pipelining in the port (``overlap_eval``, ``pipeline_rounds``), after
the JAX package's tests/test_overlap.py and tests/test_async_checkpoint.py:
with the knob on, the recorded outputs (metrics rows less wall clocks, every
recorder list) and the final model are bitwise the serial run's, on every
lane — sync plain, ``pipeline_rounds`` alone, robust retry, sentinel
rollback, poison (with an aggr_epoch_interval-2 round's per-epoch
batteries), resume mid-overlap, telemetry forcing the loop sequential; and
in the async engine plain, self-healing (faults, deadlines, TTL,
backpressure, starvation carry; the sentinel's rollbacks), resume
mid-overlap and the pipeline's gates. Pipelined checkpoints land in program
order and the best-val one works pipelined. On the CPU there is no second
stream: these hold the scheduling and its captures; the card's streams are
held by chip_smoke.py phase 11."""
import numpy as np
import pytest
import torch

from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.async_rounds import AsyncDriver
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.utils import telemetry as tel
from dba_mod_tpu_torch.utils.recorder import (VOLATILE_KEYS,
                                              canonical_run_outputs)

BASE = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=3, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=240, synthetic_test_size=96, test_batch_size=32,
    momentum=0.9, decay=0.0005, sampling_dirichlet=False, local_eval=True,
    random_seed=1)
RECORDER_LISTS = ("train_result", "test_result", "posiontest_result",
                  "poisontriggertest_result", "weight_result",
                  "scale_temp_one_row", "scale_result")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores), and
    the process-wide telemetry cleared afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    tel.configure(enabled=False)


def _exp(cfg, **kw):
    return Experiment(Params.from_dict(dict(cfg, **kw)),
                      save_results="run_dir" in kw, device="cpu")


def _run(cfg, **kw):
    e = _exp(cfg, **kw)
    e.run()
    return e


def _rows(e):
    return [{k: v for k, v in r.items() if k not in VOLATILE_KEYS}
            for r in e.recorder._jsonl_rows]


def _same_model(a, b) -> bool:
    la = {**a.params, **a.batch_stats}
    lb = {**b.params, **b.batch_stats}
    return la.keys() == lb.keys() and all(
        torch.equal(la[k], lb[k]) for k in la)


def _assert_ab(off, on):
    assert _rows(off) == _rows(on)
    for name in RECORDER_LISTS:
        assert getattr(off.recorder, name) == getattr(on.recorder, name), \
            f"recorder.{name} differs under overlap"
    assert _same_model(off.global_vars, on.global_vars)


# ------------------------------------------------------------ sync engine
SYNC_LANES = {
    "plain": (BASE, dict(overlap_eval=True)),
    "pipeline_rounds": (BASE, dict(pipeline_rounds=True)),
    # fault-injected and screened rounds retry inside the core; the
    # batteries are enqueued once, for the accepted attempt
    "robust_retry": (dict(BASE, fault_injection=True, fault_corrupt_prob=0.4,
                          screen_updates=True, fault_seed=7),
                     dict(overlap_eval=True)),
    # a microscopic band rolls every checked merge back: the sentinel
    # observes round N before round N+1 commits
    "sentinel_rollback": (dict(BASE, model_health_check=True,
                               health_norm_band=1e-9, rollback_ring=2,
                               health_warmup_merges=1),
                          dict(overlap_eval=True)),
    # poison and trigger rows, the scale stream, and an interval-2 round's
    # per-epoch batteries on the overlapped path
    "poison": (dict(BASE, epochs=4, aggr_epoch_interval=2,
                    internal_poison_epochs=2, is_poison=True,
                    poison_label_swap=2, poisoning_per_batch=8,
                    poison_lr=0.05, scale_weights_poison=4.0,
                    adversary_list=[0, 1], trigger_num=2, alpha_loss=1.0,
                    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2], [0, 3]],
                       "1_poison_pattern": [[3, 0], [3, 1], [3, 2], [3, 3]],
                       "0_poison_epochs": [1, 2], "1_poison_epochs": [3]}),
               dict(overlap_eval=True)),
}


@pytest.mark.parametrize("lane", sorted(SYNC_LANES))
def test_sync_overlap_is_bitwise_the_serial_run(lane):
    cfg, knobs = SYNC_LANES[lane]
    off, on = _run(cfg), _run(cfg, **knobs)
    _assert_ab(off, on)
    if lane == "sentinel_rollback":
        assert any(r["degraded"] for r in off.recorder._jsonl_rows)
    if lane == "robust_retry":
        assert any(r["n_quarantined"] for r in off.recorder._jsonl_rows)
    rounds = len(off.recorder._jsonl_rows)
    assert on._overlap_rounds == (rounds if "overlap_eval" in knobs else 0)


def test_sync_overlap_resume_mid_overlap(tmp_path):
    """An overlapped run stopped after round 3, resumed with --resume auto
    to round 5: its checkpoints were written from dispatch-time captures,
    and the folder's outputs equal an uninterrupted serial run's."""
    cfg = dict(BASE, epochs=5, save_model=True)
    ref = _run(cfg, run_dir=str(tmp_path / "ref"))
    a = _run(cfg, overlap_eval=True, epochs=3, run_dir=str(tmp_path / "ab"))
    folder = a.folder
    del a
    b = _exp(cfg, overlap_eval=True, resumed_model="auto",
             run_dir=str(tmp_path / "ab"))
    assert b.folder == folder and b.start_epoch == 4
    b.run()
    assert canonical_run_outputs(folder) == canonical_run_outputs(ref.folder)
    assert _same_model(ref.global_vars, b.global_vars)


def test_sync_overlap_telemetry_forces_sequential(tmp_path):
    """Telemetry on: the loop runs sequentially (honest spans), still
    bitwise, with the overlap/ family from the serial clocks."""
    off = _run(BASE, epochs=2)
    on = _run(BASE, epochs=2, overlap_eval=True, telemetry=True,
              telemetry_dir=str(tmp_path / "t"))
    _assert_ab(off, on)
    t = on.telemetry
    assert t.enabled and t.counter("overlap/rounds").value == 2
    assert t.gauge("overlap/dispatch_ahead_depth").value == 1.0


# ------------------------------------------------ pipelined checkpoints
CKPT = dict(BASE, epochs=4, local_eval=False, random_seed=3,
            save_model=True, save_on_epochs=[1, 2, 3, 4],
            pipeline_rounds=True)


def test_pipelined_checkpoints_land_in_program_order(tmp_path):
    """Every per-epoch snapshot holds its own round's state (captured at
    dispatch, while the live attributes already belong to the next round),
    model_last the final round's, every one verified with its sidecar."""
    e = _exp(CKPT, run_dir=str(tmp_path / "p"))
    assert e.run()["epoch"] == 4
    like = e.model_def.init_vars(0, torch.device("cpu"))
    seq = _exp(dict(CKPT, pipeline_rounds=False))
    for ep in (1, 2, 3, 4):
        path = e.folder / f"model_last.pt.tar.epoch_{ep}"
        assert ckpt.verify_checkpoint(path)[0]
        mv, saved_ep, _ = ckpt.load_checkpoint(path, like)
        assert saved_ep == ep
        seq.run_round(ep)
        assert _same_model(mv, seq.global_vars)
        aux = ckpt.load_aux_state(path)
        assert aux is not None and aux["epoch"] == ep
    last, saved_ep, _ = ckpt.load_checkpoint(e.folder / "model_last.pt.tar",
                                             like)
    assert saved_ep == 4 and _same_model(last, seq.global_vars)
    assert ckpt.verify_checkpoint(e.folder / "model_last.pt.tar")[0]
    assert not ckpt._pending_manifests


def test_best_val_checkpoint_works_pipelined(tmp_path):
    e = _exp(CKPT, run_dir=str(tmp_path / "p"))
    e.run()
    assert ckpt.verify_checkpoint(e.folder / "model_last.pt.tar.best")[0]
    assert np.isfinite(e.best_loss)


# ----------------------------------------------------------- async engine
ASYNC = dict(BASE, mode="async", buffer_k=3,
             staleness_weighting="polynomial", staleness_alpha=0.5,
             arrival_rate=3.0, arrival_jitter=0.7, straggler_tail=0.25,
             straggler_factor=6.0, async_steps=4)
ASYNC_LANES = {
    "plain": ASYNC,
    # deadline merges, TTL expiry, backpressure flushes and fault retries;
    # deferred wave rows replay in resolution order
    "selfhealing": dict(BASE, mode="async", buffer_k=3, async_steps=5,
                        arrival_jitter=0.5, fault_injection=True,
                        fault_dropout_prob=0.2, fault_corrupt_prob=0.3,
                        screen_updates=True, fault_seed=7,
                        arrival_ttl_v=2.0, merge_timeout_v=1.5,
                        merge_min_k=1, max_outstanding_waves=3,
                        starvation_policy="carry"),
    # the sentinel's ring commits at dispatch
    "sentinel": dict(BASE, mode="async", buffer_k=3, async_steps=5,
                     model_health_check=True, health_norm_band=1.5,
                     rollback_ring=2, health_warmup_merges=1),
}


@pytest.mark.parametrize("lane", sorted(ASYNC_LANES))
def test_async_overlap_is_bitwise_the_serial_run(lane):
    cfg = ASYNC_LANES[lane]
    off, on = _run(cfg), _run(cfg, overlap_eval=True)
    _assert_ab(off, on)


def test_async_overlap_resume_mid_overlap(tmp_path):
    """Stopped between pipelined merges, --resume auto: the dispatch-time
    snapshot restores heap, buffer and cohorts into a stream identical to
    the uninterrupted serial run."""
    cfg = dict(BASE, epochs=6, save_model=True, mode="async", buffer_k=2,
               arrival_rate=2.0, arrival_jitter=0.6, straggler_tail=0.25,
               straggler_factor=4.0, staleness_weighting="polynomial",
               async_steps=8, random_seed=3)
    ref = _run(cfg, run_dir=str(tmp_path / "ref"))
    a = _run(cfg, overlap_eval=True, async_steps=4,
             run_dir=str(tmp_path / "ab"))
    folder = a.folder
    del a
    b = _exp(cfg, overlap_eval=True, resumed_model="auto",
             run_dir=str(tmp_path / "ab"))
    assert b.folder == folder
    assert (b._resume_aux or {}).get("async_state") is not None
    b.run()
    assert canonical_run_outputs(folder) == canonical_run_outputs(ref.folder)
    assert _same_model(ref.global_vars, b.global_vars)


def test_async_pipeline_gates(tmp_path):
    """The pipeline stands down under telemetry and for a poisoned LOAN
    run; otherwise run_steps pipelines and drains its own last merge."""
    cfg = dict(ASYNC, async_steps=2, overlap_eval=True)
    assert AsyncDriver(_exp(cfg, telemetry=True,
                            telemetry_dir=str(tmp_path / "t")))._pipeline \
        is False
    e = _exp(cfg)
    d = AsyncDriver(e)
    assert d._pipeline is True
    d.run_steps(2)
    stats = d.stats()
    assert stats["pipelined_merges"] == 2 and stats["hidden_finalize_s"] >= 0
    assert [r["epoch"] for r in e.recorder._jsonl_rows] == [1, 2]
    # the gate reads the run's type and poison flag (a LOAN data set is
    # not needed to see it)
    e.params.raw["type"] = "loan"
    e.is_poison_run = True
    assert AsyncDriver(e)._pipeline is False
