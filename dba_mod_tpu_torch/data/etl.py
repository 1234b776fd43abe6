"""Offline data-prep tooling (reference L9: utils/loan_preprocess.py,
utils/tinyimagenet_reformat.py, run via the process_*.sh scripts; the
port's own copy of dba_mod_tpu/data/etl.py).

`preprocess_loan` reproduces the reference pipeline semantics
(loan_preprocess.py:8-56): drop the two fixed column lists, fillna(0),
first-appearance ordinal-encode object columns (except addr_state),
magnitude-bucket scale numeric columns by their mean (>10→/10, >100→/100,
>1000→/10000), then split into one CSV per `addr_state` — the natural 51-way
client sharding.

`reformat_tiny_imagenet_val` reproduces tinyimagenet_reformat.py: move val
images into per-wnid folders using val_annotations.txt.
"""
from __future__ import annotations

from pathlib import Path

_DROP_COLS_A = ["id", "member_id", "emp_title", "issue_d", "zip_code",
                "emp_length", "title", "earliest_cr_line", "last_pymnt_d",
                "hardship_start_date", "desc", "hardship_end_date",
                "payment_plan_start_date", "next_pymnt_d", "settlement_date",
                "last_credit_pull_d", "debt_settlement_flag_date",
                "sec_app_earliest_cr_line"]
_DROP_COLS_B = ["url", "mths_since_last_delinq", "mths_since_last_major_derog",
                "mths_since_last_record", "annual_inc_joint", "dti_joint",
                "verification_status_joint", "mths_since_recent_bc_dlq",
                "mths_since_recent_revol_delinq", "revol_bal_joint",
                "sec_app_inq_last_6mths", "sec_app_mort_acc",
                "sec_app_open_acc", "sec_app_revol_util",
                "sec_app_open_act_il", "sec_app_num_rev_accts",
                "sec_app_chargeoff_within_12_mths",
                "sec_app_collections_12_mths_ex_med",
                "sec_app_mths_since_last_major_derog", "hardship_type",
                "hardship_reason", "hardship_status", "deferral_term",
                "hardship_amount", "hardship_length", "hardship_dpd",
                "hardship_loan_status",
                "orig_projected_additional_accrued_interest",
                "hardship_payoff_balance_amount",
                "hardship_last_payment_amount", "settlement_status",
                "settlement_amount", "settlement_percentage",
                "settlement_term"]


def preprocess_loan(input_csv: str | Path, out_dir: str | Path) -> int:
    """Raw Kaggle lending-club CSV → per-state CSVs. Returns shard count."""
    import pandas as pd

    df = pd.read_csv(input_csv)
    df = df.drop(columns=[c for c in _DROP_COLS_A if c in df.columns])
    df = df.drop(columns=[c for c in _DROP_COLS_B if c in df.columns])
    df = df.fillna(0)

    for col in df.columns:
        # reference checks dtype == 'object' (loan_preprocess.py:22); newer
        # pandas may infer a dedicated string dtype for the same columns
        is_texty = (df[col].dtype == object
                    or pd.api.types.is_string_dtype(df[col]))
        if is_texty and col != "addr_state":
            # first-appearance ordinal encoding (loan_preprocess.py:22-27)
            values = list(df.drop_duplicates(col)[col])
            mapping = {v: j for j, v in enumerate(values)}
            df[col] = df[col].map(mapping)
        elif pd.api.types.is_numeric_dtype(df[col]):
            mean = df[col].mean()
            if 10.0 < mean <= 100.0:
                df[col] = df[col] / 10
            elif 100.0 < mean <= 1000.0:
                df[col] = df[col] / 100
            elif mean > 1000.0:
                df[col] = df[col] / 10000

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    states = sorted(set(df["addr_state"]))
    for state in states:
        shard = df.loc[df["addr_state"] == state].drop(columns=["addr_state"])
        shard.to_csv(out_dir / f"loan_{state}.csv", index=False)
    return len(states)


def reformat_tiny_imagenet_val(root: str | Path) -> int:
    """Move <root>/val/images/* into <root>/val/<wnid>/ per
    val_annotations.txt. Returns moved-image count."""
    import shutil

    root = Path(root)
    val = root / "val"
    ann = val / "val_annotations.txt"
    if not ann.exists():
        return 0
    val_dict = {}
    with open(ann) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) >= 2:
                val_dict[parts[0]] = parts[1]
    moved = 0
    img_dir = val / "images"
    for path in sorted(img_dir.glob("*")):
        wnid = val_dict.get(path.name)
        if wnid is None:
            continue
        dest = val / wnid
        dest.mkdir(exist_ok=True)
        shutil.move(str(path), str(dest / path.name))
        moved += 1
    if moved:
        ann.unlink()
        try:
            img_dir.rmdir()
        except OSError:
            pass
    return moved
