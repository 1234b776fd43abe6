"""Result recording with column-schema parity to the reference's CSVs
(utils/csv_record.py), plus a JSONL metrics stream — the PyTorch port's own
copy of dba_mod_tpu/utils/recorder.py: the same files, columns and rows.
``tensorboard: true`` mirrors every row as TensorBoard scalars into
``<run>/tb`` (``torch.utils.tensorboard``), with the JAX package's tags and
steps.
`load_from_folder` continues a run folder's streams on an auto-resume, and
`reload_rows` at the row counts an async checkpoint recorded. An async run's
rows carry its extras (``mode``, ``buffer_occupancy``, ``staleness_mean``,
``staleness_max``, ``waves_dispatched``, ``arrivals_total``,
``virtual_time``) in metrics.jsonl, keyed by merge step.

Like the reference, `save()` rewrites every CSV each round
(csv_record.py:21-59); every rewrite is atomic (tempfile in the run folder +
os.replace), and state lives on an instance, not module globals. The
per-batch channels (train_batch/distance) land in CSVs of their own — the
reference only plotted them.
"""
from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Any, List, Optional

TRAIN_HEADER = ["local_model", "round", "epoch", "internal_epoch",
                "average_loss", "accuracy", "correct_data", "total_data"]
TEST_HEADER = ["model", "epoch", "average_loss", "accuracy", "correct_data",
               "total_data"]
TRIGGER_HEADER = ["model", "trigger_name", "trigger_value", "epoch",
                  "average_loss", "accuracy", "correct_data", "total_data"]
BATCH_HEADER = ["local_model", "round", "epoch", "internal_epoch", "batch",
                "value"]
# per-round robustness columns (fl/faults.py + the quarantine pass in
# fl/rounds.py) so PARITY/trajectory harnesses can plot attack success
# under faults; all-zero when the fault layer is off. dispatch_time /
# finalize_time split round_time into host-planning+enqueue vs the round's
# blocking fetch (perf_counter durations; under pipeline_rounds round_time
# spans the overlap with the next round's dispatch — the split columns are
# the honest per-phase numbers)
ROUND_HEADER = ["epoch", "global_acc", "global_loss", "backdoor_acc",
                "n_quarantined", "n_dropped", "n_retries", "degraded",
                "round_time", "dispatch_time", "finalize_time"]

# wall-clock columns/keys: the ONLY recorded values allowed to differ
# between a serial run and the same run under overlap_eval /
# pipeline_rounds. Everything else is covered by the bit-identity
# contract (README "Round pipelining"; tests/test_overlap.py)
VOLATILE_KEYS = frozenset(
    {"time", "round_time", "dispatch_time", "finalize_time"})


def canonical_run_outputs(folder) -> dict:
    """Wall-clock-free view of a run folder's recorded outputs, for
    byte-level A/B comparison of two runs (the overlap_eval bit-identity
    contract). metrics.jsonl rows and round_result.csv drop the
    VOLATILE_KEYS columns; every other CSV is compared as raw bytes."""
    folder = Path(folder)
    out: dict = {}
    mj = folder / "metrics.jsonl"
    if mj.exists():
        out["metrics.jsonl"] = [
            {k: v for k, v in json.loads(line).items()
             if k not in VOLATILE_KEYS}
            for line in mj.read_text().splitlines() if line.strip()]
    rr = folder / "round_result.csv"
    if rr.exists():
        with open(rr, newline="") as f:
            rows = list(csv.reader(f))
        keep = [i for i, c in enumerate(rows[0])
                if c not in VOLATILE_KEYS] if rows else []
        out["round_result.csv"] = [[r[i] for i in keep] for r in rows]
    for name in ("train_result.csv", "test_result.csv",
                 "posiontest_result.csv", "poisontriggertest_result.csv",
                 "weight_result.csv", "scale_result.csv",
                 "train_batch_result.csv", "distance_result.csv"):
        p = folder / name
        if p.exists():
            out[name] = p.read_bytes()
    return out


def _tag(name: Any) -> str:
    return str(name).replace("/", "_")


# the in-memory streams save() writes, in the order it writes them
STREAMS = ("train_result", "test_result", "weight_result", "scale_result",
           "batch_loss_result", "batch_distance_result", "round_result",
           "posiontest_result", "poisontriggertest_result", "_jsonl_rows")


class Recorder:
    def __init__(self, folder: Optional[Path] = None,
                 tensorboard: bool = False):
        """`tensorboard` is opt-in (the config key of the same name); it
        writes nothing without a run folder."""
        self.folder = Path(folder) if folder else None
        self._tb = None
        if self.folder is not None and tensorboard:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.folder / "tb"))
        self.train_result: List[list] = []
        self.test_result: List[list] = []
        self.posiontest_result: List[list] = []   # (sic) reference file name
        self.poisontriggertest_result: List[list] = []
        self.weight_result: List[list] = []
        self.scale_result: List[list] = []
        self.scale_temp_one_row: List[Any] = []
        self.batch_loss_result: List[list] = []
        self.batch_distance_result: List[list] = []
        self.round_result: List[list] = []
        self._jsonl_rows: List[dict] = []

    def _scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    # ------------------------------------------------------------------ adds
    def add_train(self, name, temp_local_epoch, epoch, internal_epoch, loss,
                  acc, correct, total):
        self.train_result.append([name, temp_local_epoch, epoch,
                                  internal_epoch, loss, acc, correct, total])
        # train_vis (models/simple.py:18-31): x = temp_local_epoch
        self._scalar(f"train/acc/{_tag(name)}", acc, temp_local_epoch)
        self._scalar(f"train/loss/{_tag(name)}", loss, temp_local_epoch)

    def add_test(self, name, epoch, loss, acc, correct, total):
        self.test_result.append([name, epoch, loss, acc, correct, total])
        # test_vis (models/simple.py:178-200, test.py:47)
        self._scalar(f"test/acc/{_tag(name)}", acc, epoch)
        self._scalar(f"test/loss/{_tag(name)}", loss, epoch)

    def add_poisontest(self, name, epoch, loss, acc, correct, total):
        self.posiontest_result.append([name, epoch, loss, acc, correct,
                                       total])
        # poison_test_vis (models/simple.py:131-153, test.py:112)
        self._scalar(f"poison_test/acc/{_tag(name)}", acc, epoch)
        self._scalar(f"poison_test/loss/{_tag(name)}", loss, epoch)

    def add_triggertest(self, model, trigger_name, trigger_value, epoch, loss,
                        acc, correct, total):
        self.poisontriggertest_result.append(
            [model, trigger_name, trigger_value, epoch, loss, acc, correct,
             total])
        # trigger_test_vis / trigger_agent_test_vis (models/simple.py:
        # 88-129, main.py:39-58, image_train.py:287-297)
        tag = f"{_tag(model)}.{_tag(trigger_name)}"
        self._scalar(f"trigger_test/acc/{tag}", acc, epoch)
        self._scalar(f"trigger_test/loss/{tag}", loss, epoch)

    def add_weight_result(self, names, weights, alphas, epoch=None):
        # reference appends three rows per round (csv_record.py:61-64)
        self.weight_result.append(list(names))
        self.weight_result.append(list(weights))
        self.weight_result.append(list(alphas))
        # weight_vis / alpha_vis (models/simple.py:62-87, main.py:60-83)
        if epoch is not None:
            for n, w, a in zip(names, weights, alphas):
                self._scalar(f"aggregation/weight/{_tag(n)}", w, epoch)
                self._scalar(f"aggregation/alpha/{_tag(n)}", a, epoch)

    def add_batch_loss(self, name, temp_local_epoch, epoch, internal_epoch,
                       batch, steps_per_epoch, loss):
        """Per-batch train loss (vis_train_batch_loss,
        image_train.py:225-235; train_batch_vis models/simple.py:32-42)."""
        self.batch_loss_result.append(
            [name, temp_local_epoch, epoch, internal_epoch, batch, loss])
        step = (temp_local_epoch - 1) * steps_per_epoch + batch
        self._scalar(f"train_batch/loss/{_tag(name)}", loss, step)

    def add_batch_distance(self, name, temp_local_epoch, epoch,
                           internal_epoch, batch, steps_per_epoch, dist):
        """Per-batch post-step distance to the round anchor
        (batch_track_distance, image_train.py:236-245;
        track_distance_batch_vis models/simple.py:43-61)."""
        self.batch_distance_result.append(
            [name, temp_local_epoch, epoch, internal_epoch, batch, dist])
        step = (temp_local_epoch - 1) * steps_per_epoch + batch
        self._scalar(f"distance_to_global/{_tag(name)}", dist, step)

    def add_round_json(self, **kwargs):
        kwargs.setdefault("time", time.time())
        self._jsonl_rows.append(kwargs)
        if "epoch" in kwargs:
            self.round_result.append(
                [kwargs["epoch"], kwargs.get("global_acc"),
                 kwargs.get("global_loss"), kwargs.get("backdoor_acc"),
                 int(kwargs.get("n_quarantined", 0) or 0),
                 int(kwargs.get("n_dropped", 0) or 0),
                 int(kwargs.get("n_retries", 0) or 0),
                 int(bool(kwargs.get("degraded", False))),
                 kwargs.get("round_time"),
                 kwargs.get("dispatch_time"),
                 kwargs.get("finalize_time")])
        if self._tb is not None and "epoch" in kwargs:
            step = int(kwargs["epoch"])
            for k, v in kwargs.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "time"):
                    self._tb.add_scalar(k, float(v), step)
            self._tb.flush()

    # ---------------------------------------------------------- resume/load
    def load_from_folder(self, keep_until_epoch: int) -> int:
        """Auto-resume continuation: reload this run folder's previously
        saved CSV/JSONL streams, truncated to rows at or before
        `keep_until_epoch` (a kill can land after round N recorded but
        before round N's checkpoint verified — the resumed run replays N,
        and duplicate rows would corrupt every downstream curve). Because
        `save()` rewrites every file from these in-memory lists each
        round, reloading + truncating here is exactly "continue the stream
        past the resume epoch". CSV cells reload as the strings the writer
        emitted, so the kept prefix round-trips byte-identically. Returns
        the number of metrics.jsonl rows kept."""
        if self.folder is None:
            return 0
        cut = int(keep_until_epoch)

        def rows_of(name):
            path = self.folder / name
            if not path.exists():
                return None
            with open(path, newline="") as f:
                return list(csv.reader(f))

        def load_csv(name, target, epoch_col, has_header=True):
            rows = rows_of(name)
            if rows is None:
                return
            body = rows[1:] if has_header and rows else rows
            for row in body:
                try:
                    if int(float(row[epoch_col])) > cut:
                        continue
                except (IndexError, ValueError):
                    continue  # malformed row: drop rather than crash resume
                target.append(row)

        load_csv("train_result.csv", self.train_result, 2)
        load_csv("test_result.csv", self.test_result, 1)
        load_csv("posiontest_result.csv", self.posiontest_result, 1)
        load_csv("poisontriggertest_result.csv",
                 self.poisontriggertest_result, 3)
        load_csv("train_batch_result.csv", self.batch_loss_result, 2)
        load_csv("distance_result.csv", self.batch_distance_result, 2)
        load_csv("round_result.csv", self.round_result, 0)
        # scale rows start with (epoch, norm) pairs — filter on the first
        # cell; weight rows are epochless [names, wv, alpha] triplets, one
        # per recorded round, so keep one triplet per kept round row
        load_csv("scale_result.csv", self.scale_result, 0, has_header=False)
        wrows = rows_of("weight_result.csv")
        if wrows is not None:
            n_triplets = min(len(wrows) // 3, len(self.round_result))
            self.weight_result.extend(wrows[:3 * n_triplets])

        jsonl = self.folder / "metrics.jsonl"
        if jsonl.exists():
            with open(jsonl) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                        keep = int(row.get("epoch", 0)) <= cut
                    except (ValueError, TypeError, AttributeError):
                        continue  # malformed line (truncated write, bit
                                  # rot): drop rather than crash resume,
                                  # like the CSV loader above
                    if keep:
                        self._jsonl_rows.append(row)
        return len(self._jsonl_rows)

    def row_counts(self) -> dict:
        """Rows held in each stream (the async engine's sidecar records
        them at every checkpoint)."""
        return {name: len(getattr(self, name)) for name in STREAMS}

    def reload_rows(self, counts: dict) -> None:
        """Continue this run folder's streams at exactly `counts` rows
        each (what :meth:`row_counts` gave when the resumed checkpoint was
        taken): every file's rows reloaded, then each stream cut to its
        count. For streams whose epoch column is not the checkpoint's step
        (the async engine's per-client rows carry wave epochs), where the
        epoch cut of :meth:`load_from_folder` does not apply."""
        for name in STREAMS:
            getattr(self, name).clear()
        self.load_from_folder(2 ** 62)
        for name, n in counts.items():
            del getattr(self, name)[int(n):]

    # ------------------------------------------------------------------ save
    def _atomic_write(self, name: str, emit) -> None:
        """Crash-safe full rewrite: `emit(file)` writes into a tempfile in
        the run folder, which is `os.replace`d over the target only on
        success — a crash (or an exception) mid-save leaves the previously
        saved file intact, where the old rewrite-in-place truncated it."""
        path = self.folder / name
        tmp = self.folder / (name + ".tmp")
        try:
            with open(tmp, "w", newline="") as f:
                emit(f)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()

    def save(self, is_poison: bool):
        # the scale row closes at save time whether or not files are written
        # (csv_record.py:44-50 semantics)
        if self.scale_temp_one_row:
            self.scale_result.append(list(self.scale_temp_one_row))
            self.scale_temp_one_row.clear()
        if self.folder is None:
            return
        self.folder.mkdir(parents=True, exist_ok=True)

        def write(name, header, rows):
            def emit(f):
                w = csv.writer(f)
                if header:
                    w.writerow(header)
                w.writerows(rows)
            self._atomic_write(name, emit)

        write("train_result.csv", TRAIN_HEADER, self.train_result)
        write("test_result.csv", TEST_HEADER, self.test_result)
        if self.weight_result:
            write("weight_result.csv", None, self.weight_result)
        if self.scale_result:
            write("scale_result.csv", None, self.scale_result)
        if self.batch_loss_result:
            write("train_batch_result.csv", BATCH_HEADER,
                  self.batch_loss_result)
        if self.batch_distance_result:
            write("distance_result.csv", BATCH_HEADER,
                  self.batch_distance_result)
        if self.round_result:
            write("round_result.csv", ROUND_HEADER, self.round_result)
        if is_poison:
            write("posiontest_result.csv", TEST_HEADER,
                  self.posiontest_result)
            write("poisontriggertest_result.csv", TRIGGER_HEADER,
                  self.poisontriggertest_result)

        def emit_jsonl(f):
            for row in self._jsonl_rows:
                f.write(json.dumps(row) + "\n")
        self._atomic_write("metrics.jsonl", emit_jsonl)
