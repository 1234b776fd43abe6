"""The port's telemetry (dba_mod_tpu_torch/utils/telemetry.py), after the JAX
package's tests/test_telemetry.py: span nesting and the Chrome-trace
schema, counter/histogram flush with a window reset, mark_warm, memory
gauges on the CPU, the no-op mode, instrument's passthrough, the idempotent
logging setup, the kernel-build counter (load_library with nvcc stubbed),
the watchdog's span stack; and the Experiment end to end: its files, spans
and TensorBoard events, none with the knob off, the split path's rows
bitwise the fused path's, the takeover fallback, a profile_dir trace, and
one MNIST smoke round's span names and counter keys against the JAX
package's (less xla/*, plus cuda/*)."""
import json
import logging
import sys
import time
import types
from pathlib import Path

import pytest
import torch
import yaml

from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.utils import cuda_build
from dba_mod_tpu_torch.utils import telemetry as tel
from dba_mod_tpu_torch.utils.recorder import (VOLATILE_KEYS,
                                              canonical_run_outputs)
from dba_mod_tpu_torch.utils.run_guard import Watchdog

REPO = Path(__file__).resolve().parent.parent
SMOKE = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=2, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=240, synthetic_test_size=96, test_batch_size=32,
    momentum=0.9, decay=0.0005, sampling_dirichlet=False, local_eval=True,
    random_seed=1)
PHASE_SPANS = {"engine/build", "engine/warm_buckets", "round/dispatch",
               "round/train", "round/aggregate", "eval/local", "eval/global",
               "round/finalize", "round/checkpoint"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores), and
    the process-wide telemetry cleared afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    tel.configure(enabled=False)


@pytest.fixture
def enabled_tel(tmp_path):
    return tel.configure(enabled=True, folder=tmp_path)


def _exp(cfg, **kw):
    return Experiment(Params.from_dict(dict(cfg, **kw)),
                      save_results="run_dir" in kw, device="cpu")


# ------------------------------------------------------------------- spans
def test_span_nesting_and_timing_monotonicity(enabled_tel):
    with tel.span("outer"):
        time.sleep(0.01)
        with tel.span("inner"):
            time.sleep(0.01)
    events = {e["name"]: e for e in enabled_tel._trace_events}
    outer, inner = events["outer"], events["inner"]
    assert inner["dur"] > 0 and outer["dur"] >= inner["dur"]
    assert inner["ts"] >= outer["ts"]
    assert (inner["ts"] + inner["dur"]
            <= outer["ts"] + outer["dur"] + 1.0)
    assert enabled_tel.histogram("span/outer").total_count == 1
    assert enabled_tel.histogram("span/inner").total_count == 1


def test_span_stack_feeds_phase_context(enabled_tel):
    assert enabled_tel.phase() == "-"
    with tel.span("round/dispatch"):
        with tel.span("round/train"):
            assert enabled_tel.span_stack() == ["round/dispatch",
                                                "round/train"]
            assert enabled_tel.phase() == "round/train"
    assert enabled_tel.span_stack() == []


def test_chrome_trace_schema(enabled_tel, tmp_path):
    with tel.span("a"):
        pass
    enabled_tel.write_trace()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["displayTimeUnit"] == "ms"
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert xs and {"name", "ph", "ts", "dur", "pid", "tid"} <= set(xs[0])
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    assert meta[0]["args"]["name"] == "dba_mod_tpu_torch"


def test_sync_returns_payload_and_is_a_noop_on_the_cpu(enabled_tel):
    x = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert tel.sync(x) is x
    assert tel.cuda_device_of(x) is None


def test_counter_histogram_flush_and_window_reset(enabled_tel, tmp_path):
    enabled_tel.counter("rounds").inc()
    enabled_tel.counter("rounds").inc(2)
    enabled_tel.gauge("g").set(1.5)
    for v in (1.0, 2.0, 3.0):
        enabled_tel.histogram("h").observe(v)
    enabled_tel.flush_round(1)
    enabled_tel.counter("rounds").inc()
    enabled_tel.histogram("h").observe(10.0)
    enabled_tel.flush_round(2)
    rows = [json.loads(line) for line in
            (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    # counters are cumulative, histograms windowed between flushes
    assert rows[0]["counters"]["rounds"] == 3
    assert rows[1]["counters"]["rounds"] == 4
    assert rows[0]["histograms"]["h"]["count"] == 3
    assert rows[0]["histograms"]["h"]["p50"] == 2.0
    assert rows[1]["histograms"]["h"] == {"count": 1, "sum": 10.0,
                                          "min": 10.0, "max": 10.0,
                                          "p50": 10.0, "p95": 10.0}
    assert rows[1]["gauges"]["g"] == 1.5
    assert rows[0]["counters"]["cuda/kernel_builds"] == 0
    assert enabled_tel.histogram("h").total_count == 4


def test_mark_warm_is_idempotent(enabled_tel):
    enabled_tel.mark_warm()
    enabled_tel.mark_warm()
    assert enabled_tel._warm
    assert enabled_tel.counter("cuda/kernel_builds_after_warmup").value == 0


def test_record_memory_sets_no_gauge_on_the_cpu():
    t = tel.configure(enabled=True, device=torch.device("cpu"))
    t.record_memory()
    t.flush_round(1)
    assert not any(k.startswith("memory/") for k in t._gauges)
    assert "n/a" in t.summary_table()


def test_noop_mode_adds_no_files_and_no_state(tmp_path):
    t = tel.configure(enabled=False, folder=tmp_path)
    assert t is tel.NULL and not t.enabled
    with tel.span("x"):
        tel.count("c")
        tel.observe("h", 1.0)
        tel.set_gauge("g", 2.0)
    t.flush_round(1)
    t.mark_warm()
    t.close()
    tel.kernel_built("x.cu", 1.0)
    assert list(tmp_path.iterdir()) == []
    assert t.summary_table() == "telemetry disabled"


def test_instrument_is_passthrough_when_disabled(enabled_tel):
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    wrapped = tel.instrument(fn, "eval/test", batches=5)
    assert wrapped.__wrapped__ is fn
    assert wrapped(torch.tensor(3.0)).item() == 6.0
    assert enabled_tel.counter("eval/batches").value == 5
    assert enabled_tel.histogram("span/eval/test").total_count == 1
    tel.configure(enabled=False)
    assert wrapped(torch.tensor(1.0)).item() == 2.0 and len(calls) == 2


def test_logging_setup_is_idempotent_and_replaces_run_file(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    lg = tel.setup_logging(a)
    tel.setup_logging(a)
    files = [h for h in lg.handlers if getattr(h, "_dba_run_file", False)]
    assert len(files) == 1
    tel.setup_logging(b)
    files = [h for h in lg.handlers if getattr(h, "_dba_run_file", False)]
    assert len(files) == 1 and files[0].baseFilename == str(b / "log.txt")
    lg.warning("to b only")
    files[0].flush()
    assert "to b only" in (b / "log.txt").read_text()
    assert "to b only" not in (a / "log.txt").read_text()
    assert tel.setup_logging(None) is lg
    for h in files:
        lg.removeHandler(h)
        h.close()


def test_kernel_build_counter_with_load_library_stubbed(monkeypatch,
                                                        tmp_path, caplog):
    """load_library reports each nvcc build; a build after mark_warm is
    counted apart and logged. nvcc and the library load are stubbed (the
    CPU tests run without the CUDA toolkit)."""
    def fake_run(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return type("P", (), {"returncode": 0, "stdout": "", "stderr": ""})

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    t = tel.configure(enabled=True)
    cuda_build.load_library("fused_update.cu")
    cuda_build.load_library("fused_update.cu")     # loaded: no build
    assert t.counter("cuda/kernel_builds").value == 1
    assert t.histogram("cuda/kernel_build_secs").total_count == 1
    t.mark_warm()
    monkeypatch.setattr(cuda_build, "_loaded", {})
    cuda_build.library_path("fused_update.cu").unlink()
    with caplog.at_level(logging.WARNING, logger="dba_mod_tpu_torch"):
        cuda_build.load_library("fused_update.cu")
    assert t.counter("cuda/kernel_builds").value == 2
    assert t.counter("cuda/kernel_builds_after_warmup").value == 1
    assert any("AFTER warm-up" in r.getMessage() for r in caplog.records)


def test_watchdog_diagnostic_carries_the_span_stack(enabled_tel, caplog):
    wd = Watchdog(soft_s=0.05, hard_s=0.0)
    with caplog.at_level("ERROR", logger="dba_mod_tpu_torch"):
        with tel.span("round/finalize"):
            with wd.zone("round/finalize"):
                deadline = time.monotonic() + 5.0
                while not wd.soft_stalls and time.monotonic() < deadline:
                    time.sleep(0.01)
    msgs = [r.getMessage() for r in caplog.records if "stalled" in
            r.getMessage()]
    assert msgs and "['round/finalize']" in msgs[0]
    assert enabled_tel.counter("watchdog/soft_stalls").value == 1


# -------------------------------------------------------------- end to end
def _trace_spans(folder) -> set:
    doc = json.loads((Path(folder) / "trace.json").read_text())
    return {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}


def test_experiment_telemetry_end_to_end(tmp_path, monkeypatch):
    """Telemetry on: trace.json with every phase span, one telemetry.jsonl
    row per round, no kernel build after warm-up, the TensorBoard events
    under tb/, the split times in round_result.csv, the summary table — and
    the recorded outputs bitwise a run with the knobs off."""
    # TensorBoard's own switch to its file-system stub: without it the
    # writer imports TensorFlow where that is installed (seconds of start)
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    on = _exp(SMOKE, telemetry=True, tensorboard=True, save_model=True,
              run_dir=str(tmp_path / "on"))
    on.run()
    folder = on.folder
    assert PHASE_SPANS <= _trace_spans(folder)
    rows = [json.loads(line) for line in
            (folder / "telemetry.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    last = rows[-1]
    for span in ("span/round/dispatch", "span/round/finalize",
                 "span/eval/global", "span/round/checkpoint"):
        assert last["histograms"][span]["count"] >= 1
    assert last["counters"]["rounds"] == 2
    assert last["counters"]["eval/batches"] > 0
    assert last["counters"]["checkpoint/saves"] >= 2
    assert last["counters"]["cuda/kernel_builds_after_warmup"] == 0
    assert list((folder / "tb").glob("events.out.tfevents.*"))
    assert (folder / "log.txt").exists()
    summary = on.telemetry.summary_table()
    assert "round/dispatch" in summary and "cuda kernel builds" in summary
    off = _exp(SMOKE, save_model=True, run_dir=str(tmp_path / "off"))
    off.run()
    assert canonical_run_outputs(off.folder) == \
        canonical_run_outputs(folder)
    for k, v in {**off.global_vars.params,
                 **off.global_vars.batch_stats}.items():
        mine = {**on.global_vars.params, **on.global_vars.batch_stats}[k]
        assert torch.equal(v, mine), k


def test_experiment_telemetry_off_writes_no_files(tmp_path):
    e = _exp(SMOKE, epochs=1, run_dir=str(tmp_path))
    e.run()
    for name in ("telemetry.jsonl", "trace.json", "tb"):
        assert not (e.folder / name).exists()
    assert e.telemetry is tel.NULL


def test_split_path_falls_back_after_takeover(tmp_path):
    """A later configure() (another Experiment taking over the process-wide
    instance) drops this one's per-phase syncs; its own rows still flush."""
    e = _exp(SMOKE, telemetry=True, telemetry_dir=str(tmp_path / "t"))
    assert e._telemetry_split
    tel.configure(enabled=False)
    assert not e._telemetry_split
    r = e.run_round(1)
    assert r["dispatch_time"] > 0
    lines = [json.loads(line) for line in
             (tmp_path / "t" / "telemetry.jsonl").read_text().splitlines()]
    assert lines and lines[-1]["counters"]["rounds"] == 1


def test_profile_dir_traces_the_first_round_after_warm_up(tmp_path):
    e = _exp(SMOKE, profile_dir=str(tmp_path / "prof"))
    e.run()
    traces = list((tmp_path / "prof").glob("round_2.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_one_smoke_round_keys_match_the_jax_package(tmp_path):
    """configs/smoke_params.yaml, one round with telemetry on, both
    packages: the same span names, and the same counter keys less the JAX
    package's xla/* plus the port's cuda/*."""
    from dba_mod_tpu.config import Params as JParams
    from dba_mod_tpu.fl.experiment import Experiment as JExperiment
    from dba_mod_tpu.utils import telemetry as jtel
    raw = dict(yaml.safe_load(open(REPO / "configs" / "smoke_params.yaml")),
               epochs=1, telemetry=True)
    keys = {}
    for name, make in (
            ("jax", lambda r: JExperiment(JParams.from_dict(r))),
            ("port", lambda r: Experiment(Params.from_dict(r),
                                          device="cpu"))):
        e = make(dict(raw, run_dir=str(tmp_path / name)))
        try:
            e.run()
        finally:
            jtel.configure(enabled=False)
        row = json.loads((e.folder / "telemetry.jsonl").read_text()
                         .splitlines()[-1])
        keys[name] = (_trace_spans(e.folder), set(row["counters"]))
    (jspans, jcounters), (spans, counters) = keys["jax"], keys["port"]
    # the wait for async saves is a span in either package once the process
    # has made an async save (another test in this worker may have)
    wait = {"checkpoint/wait_async"}
    assert spans - wait == jspans - wait
    assert {k for k in counters if not k.startswith("cuda/")} == \
        {k for k in jcounters if not k.startswith("xla/")}
    assert any(k.startswith("cuda/") for k in counters)
    rows = [{k: v for k, v in r.items() if k not in VOLATILE_KEYS}
            for r in e.recorder._jsonl_rows]
    assert [r["epoch"] for r in rows] == [1]
