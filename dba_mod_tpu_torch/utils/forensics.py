"""Defense forensics: per-client aggregation-introspection artifacts (the
port's own copy of dba_mod_tpu/utils/forensics.py: the same files, columns
and rows).

The paper's central question — can an aggregation defense *see* a
distributed backdoor — needs per-round, per-client evidence: what each
client submitted (norms), how aligned it was with what the server applied
(cosine), what the screening pass decided (verdict + reason), and how the
defense weighted it (FoolsGold wv/alpha, RFA Weiszfeld weights/distances).
`fl/rounds.py` computes these on the device inside the round
(ForensicStats rides the payload's one device-to-host transfer at
finalize); this module is the host side: `ForensicsWriter` streams the rows to two run-folder files and
mirrors them to TensorBoard, and `render_report` turns them into a
standalone HTML round-audit for the `report` CLI subcommand.

Files (written atomically, recorder-style full rewrites — crash-safe):

  forensics.jsonl       one line per round: the full per-client vectors
                        plus round-level defense outcomes (quarantine
                        count, retries, degradation, RFA oracle calls)
  client_forensics.csv  one row per (round, client) with the stable
                        FORENSICS_HEADER schema

Everything here is inert unless `forensics: true` — the Experiment never
constructs a writer otherwise.
"""
from __future__ import annotations

import csv
import json
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from dba_mod_tpu_torch.utils.html import html_doc, svg_timeline, table_html

# Column schema of client_forensics.csv — STABLE: downstream notebooks and
# the schema golden test parse by name. Ints: epoch/client/participant_id/
# adversary/verdict; floats (or blank when not applicable): delta_norm/
# recv_norm/cosine_to_agg/agg_weight/fg_max_sim/rfa_distance/poison_acc;
# strings: name, reason.
FORENSICS_HEADER = [
    "epoch", "client", "name", "participant_id", "adversary",
    "delta_norm", "recv_norm", "cosine_to_agg", "verdict", "reason",
    "agg_weight", "fg_max_sim", "rfa_distance", "poison_acc"]


def _fmt(v: Optional[float]) -> str:
    """Float cell: blank for not-applicable, 'nan'/'inf' kept verbatim
    (a corrupted payload's norm IS the forensic signal)."""
    if v is None:
        return ""
    return format(float(v), ".6g")


def _jsonable(vals) -> Optional[List[Optional[float]]]:
    """JSON-safe float list: non-finite → None (json.dumps would otherwise
    emit bare NaN tokens, which are not valid JSON)."""
    if vals is None:
        return None
    return [float(v) if math.isfinite(float(v)) else None for v in vals]


class ForensicsWriter:
    """Accumulates per-round forensic rows; saves after every round.

    `folder=None` keeps everything in memory (bench runs with
    save_results=False still exercise the full row-building path).
    `tb_sink(tag, value, step)` mirrors per-client scalars under
    `forensics/...` — wired to the recorder's TensorBoard writer when
    `tensorboard: true`."""

    def __init__(self, folder: Optional[Path] = None, tb_sink=None):
        self.folder = Path(folder) if folder else None
        self.tb_sink = tb_sink
        self.rows: List[list] = []          # client_forensics.csv data rows
        self.round_rows: List[dict] = []    # forensics.jsonl lines

    def add_round(self, *, epoch: int, aggregation: str,
                  names: Sequence[Any], participant_ids: Sequence[int],
                  adversary_flags: Sequence[int], delta_norms, recv_norms,
                  cosine, verdict, reason_codes,
                  reason_names: Dict[int, str], weights=None, alpha=None,
                  poison_acc=None, oracle_calls: int = 1,
                  n_retries: int = 0, degraded: bool = False) -> None:
        """One round's forensic record. Vector args are length-C host
        arrays (C = real clients; padded mesh lanes already sliced off by
        the caller). `weights`/`alpha` are None for FedAvg, whose rule
        defines no per-client weight; `poison_acc` is None on benign runs
        or when the local battery is off."""
        is_fg = aggregation == "foolsgold"
        reasons = [reason_names.get(int(r), str(int(r)))
                   for r in reason_codes]
        for c, name in enumerate(names):
            w = None if weights is None else float(weights[c])
            a = None if alpha is None else float(alpha[c])
            self.rows.append([
                int(epoch), c, str(name), int(participant_ids[c]),
                int(adversary_flags[c]),
                _fmt(float(delta_norms[c])), _fmt(float(recv_norms[c])),
                _fmt(float(cosine[c])), int(bool(verdict[c])), reasons[c],
                _fmt(w),
                _fmt(a if is_fg else None),        # FoolsGold max pairwise
                _fmt(None if is_fg else a),        # cos-sim vs RFA distance
                _fmt(None if poison_acc is None else float(poison_acc[c])),
            ])
        self.round_rows.append({
            "epoch": int(epoch), "aggregation": str(aggregation),
            "oracle_calls": int(oracle_calls),
            "n_quarantined": int(sum(1 for v in verdict if not bool(v))),
            "n_retries": int(n_retries), "degraded": bool(degraded),
            "clients": [str(n) for n in names],
            "adversaries": [str(n) for n, f in zip(names, adversary_flags)
                            if int(f)],
            "delta_norm": _jsonable(delta_norms),
            "recv_norm": _jsonable(recv_norms),
            "cosine_to_agg": _jsonable(cosine),
            "verdict": [int(bool(v)) for v in verdict],
            "reason": reasons,
            "agg_weight": _jsonable(weights),
            "alpha": _jsonable(alpha),
            "poison_acc": _jsonable(poison_acc)})
        if self.tb_sink is not None:
            for c, name in enumerate(names):
                tag = str(name).replace("/", "_")
                for sub, vals in (("delta_norm", delta_norms),
                                  ("cosine", cosine),
                                  ("weight", weights)):
                    if vals is not None and math.isfinite(float(vals[c])):
                        self.tb_sink(f"forensics/{sub}/{tag}",
                                     float(vals[c]), int(epoch))
            self.tb_sink("forensics/quarantined",
                         float(self.round_rows[-1]["n_quarantined"]),
                         int(epoch))

    # ------------------------------------------------------------------ save
    def _atomic_write(self, name: str, emit) -> None:
        """Crash-safe full rewrite — same contract as Recorder's."""
        path = self.folder / name
        tmp = self.folder / (name + ".tmp")
        try:
            with open(tmp, "w", newline="") as f:
                emit(f)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()

    def save(self) -> None:
        if self.folder is None:
            return
        self.folder.mkdir(parents=True, exist_ok=True)

        def emit_csv(f):
            w = csv.writer(f)
            w.writerow(FORENSICS_HEADER)
            w.writerows(self.rows)

        def emit_jsonl(f):
            for row in self.round_rows:
                f.write(json.dumps(row) + "\n")

        self._atomic_write("client_forensics.csv", emit_csv)
        self._atomic_write("forensics.jsonl", emit_jsonl)

    def load_from_folder(self, keep_until_epoch: int) -> int:
        """Auto-resume: continue the killed run's forensic streams, keeping
        rows through `keep_until_epoch` and dropping later ones — the same
        truncate-and-continue contract as Recorder.load_from_folder (a
        replayed round must not appear twice). Returns kept round count."""
        self.rows, self.round_rows = [], []
        if self.folder is None:
            return 0
        fcsv = self.folder / "client_forensics.csv"
        if fcsv.exists():
            with open(fcsv, newline="") as f:
                data = list(csv.reader(f))
            for row in data[1:]:
                if row and int(row[0]) <= keep_until_epoch:
                    self.rows.append(row)
        fjs = self.folder / "forensics.jsonl"
        if fjs.exists():
            for line in fjs.read_text().splitlines():
                if not line.strip():
                    continue
                rec = json.loads(line)
                if int(rec["epoch"]) <= keep_until_epoch:
                    self.round_rows.append(rec)
        return len(self.round_rows)


# ------------------------------------------------------------------- report
_ATT_COLOR, _BEN_COLOR, _Q_COLOR = "#d62728", "#1f77b4", "#ff7f0e"


def _mean(vals: List[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None and math.isfinite(v)]
    return sum(vals) / len(vals) if vals else None


def _split_series(rounds: List[dict], key: str):
    """(attacker_points, benign_points) — per-epoch means of `key`, split
    by the round's recorded adversary set."""
    att, ben = [], []
    for r in rounds:
        vals = r.get(key)
        if vals is None:
            continue
        adv = set(r.get("adversaries", []))
        a = _mean([v for n, v in zip(r["clients"], vals) if n in adv])
        b = _mean([v for n, v in zip(r["clients"], vals) if n not in adv])
        if a is not None:
            att.append((r["epoch"], a))
        if b is not None:
            ben.append((r["epoch"], b))
    return att, ben


def _timeline(rounds: List[dict], key: str, title: str) -> str:
    att, ben = _split_series(rounds, key)
    series = []
    if att:
        series.append({"label": "attacker mean", "color": _ATT_COLOR,
                       "points": att})
    if ben:
        series.append({"label": "benign mean", "color": _BEN_COLOR,
                       "points": ben, "dash": not att})
    svg = svg_timeline(series, title=title)
    return f"<figure>{svg}</figure>" if svg else ""


def _suspicion(r: dict, c: int) -> float:
    """Per-client suspicion score for the ranking table: quarantined
    clients outrank everything; otherwise low defense weight (FoolsGold/
    RFA) or — for weightless FedAvg — a large received norm is suspicious.
    A display-ranking heuristic, not a detector."""
    if not r["verdict"][c]:
        return 2.0
    w = r.get("agg_weight")
    if w is not None and w[c] is not None:
        finite = [v for v in w if v is not None]
        top = max(finite) if finite else 0.0
        return 1.0 - (w[c] / top if top > 0 else 0.0)
    norms = [v for v in (r.get("recv_norm") or []) if v is not None]
    top = max(norms) if norms else 0.0
    rn = (r.get("recv_norm") or [None])[c]
    if rn is None:
        return 1.0  # non-finite norm: maximally suspicious short of a drop
    return rn / top if top > 0 else 0.0


def render_report(run_folder: Path) -> str:
    """Self-contained HTML round-audit from a run folder's forensics.jsonl:
    attacker-vs-benign timelines (norms / defense weights / cosine), the
    per-round suspicion ranking, and every defense decision (quarantines,
    retries, degraded rounds) as an annotated table."""
    run_folder = Path(run_folder)
    src = run_folder / "forensics.jsonl"
    if not src.exists():
        raise FileNotFoundError(
            f"{src} not found — run with `forensics: true` first")
    rounds = [json.loads(l) for l in src.read_text().splitlines()
              if l.strip()]
    if not rounds:
        raise ValueError(f"{src} is empty")
    rounds.sort(key=lambda r: r["epoch"])
    agg = rounds[-1]["aggregation"]
    all_adv = sorted({n for r in rounds for n in r.get("adversaries", [])})
    n_quar = sum(r["n_quarantined"] for r in rounds)
    n_deg = sum(1 for r in rounds if r.get("degraded"))

    body = [
        "<p class='note'>",
        f"run <b>{run_folder.name}</b> · aggregation <b>{agg}</b> · "
        f"{len(rounds)} rounds (epochs {rounds[0]['epoch']}–"
        f"{rounds[-1]['epoch']}) · adversaries: "
        f"{', '.join(all_adv) if all_adv else 'none recorded'} · "
        f"{n_quar} quarantines · {n_deg} degraded rounds</p>"]

    body.append("<h2>Attacker vs benign timelines</h2>")
    body.append(_timeline(rounds, "delta_norm",
                          "per-client update norm (mean)"))
    if any(r.get("agg_weight") for r in rounds):
        body.append(_timeline(rounds, "agg_weight",
                              "defense aggregation weight (mean)"))
    body.append(_timeline(rounds, "cosine_to_agg",
                          "cosine to the applied update (mean)"))
    if any(r.get("poison_acc") for r in rounds):
        body.append(_timeline(rounds, "poison_acc",
                              "local poison-battery accuracy (mean)"))

    body.append("<h2>Suspicion ranking (top 3 per round)</h2>")
    body.append("<p class='note'>suspicion score: quarantined &gt; low defense "
                "weight (or, for FedAvg, large received norm). Adversaries "
                "are marked *.</p>")
    sus_rows = []
    for r in rounds:
        adv = set(r.get("adversaries", []))
        ranked = sorted(range(len(r["clients"])),
                        key=lambda c: -_suspicion(r, c))[:3]
        cells = [f"{r['clients'][c]}{'*' if r['clients'][c] in adv else ''}"
                 f" ({_suspicion(r, c):.2f})" for c in ranked]
        sus_rows.append([r["epoch"]] + cells + [""] * (3 - len(cells)))
    body.append(table_html(["epoch", "1st", "2nd", "3rd"], sus_rows))

    body.append("<h2>Defense decisions</h2>")
    dec_rows, dec_flags = [], []
    for r in rounds:
        for c, name in enumerate(r["clients"]):
            if not r["verdict"][c]:
                rn = (r.get("recv_norm") or [None])[c]
                dec_rows.append([r["epoch"], name, r["reason"][c],
                                 "quarantined",
                                 "" if rn is None else format(rn, ".4g")])
                dec_flags.append(True)
        if r.get("n_retries"):
            dec_rows.append([r["epoch"], "—", "non-finite aggregate",
                             f"{r['n_retries']} retr"
                             f"{'y' if r['n_retries'] == 1 else 'ies'}", ""])
            dec_flags.append(False)
        if r.get("degraded"):
            dec_rows.append([r["epoch"], "—", "too few survivors",
                             "degraded (model carried)", ""])
            dec_flags.append(True)
    if dec_rows:
        body.append(table_html(
            ["epoch", "client", "reason", "decision", "recv ‖Δ‖"],
            dec_rows, dec_flags))
    else:
        body.append("<p class='note'>no quarantines, retries, or degraded "
                    "rounds — every client entered every aggregate.</p>")

    return html_doc(f"Defense forensics — {run_folder.name}",
                    "".join(body))


def write_report(run_folder: Path, out: Optional[Path] = None) -> Path:
    out = Path(out) if out else Path(run_folder) / "forensics_report.html"
    out.write_text(render_report(run_folder))
    return out
