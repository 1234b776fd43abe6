"""The port's CLI and its less-travelled round paths, on the CPU.

1. pretrain → named resume → attack through dba_mod_tpu_torch.main, the
   reference's canonical flow (image_helper.py:56-67: restore the clean
   model, take its lr, continue at saved epoch + 1), with verified
   checkpoints from save_model.
2. One round with aggr_epoch_interval=2 (segment chaining + the per-segment
   local battery), per-batch loss/distance tracking and dynamic_steps,
   recorded by the port and by the JAX package from the same weights: same
   files, same rows, numbers within 1e-2 relative. Most clients agree to
   ~1e-7 in the weights, but on this round one benign client meets a
   max-pool window whose top two values are 1.5e-8 apart (measured) — the
   two frameworks' float32 summation orders pick different winners, and
   that client's weights then drift to ~1.5e-3 of 0.16 by the round's end
   (each step ×2-4: lr 0.1 SGD amplifies it, the CIFAR test's ReLU-gate
   chaos in miniature); its recorded loss moves ~1e-3 relative."""
import csv
import io
import json

import jax
import pytest
import torch
import yaml

from benchmarks.parity_ab import MNIST_AB_I2
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu.utils.recorder import \
    canonical_run_outputs as j_canonical
from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.main import main
from dba_mod_tpu_torch.utils.recorder import canonical_run_outputs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CLEAN = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=2, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=240, synthetic_test_size=64, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False, random_seed=1)
ATTACK = dict(
    CLEAN, epochs=4, lr=0.9, resumed_model=True, is_poison=True,
    local_eval=True, internal_poison_epochs=3, poison_label_swap=2,
    poisoning_per_batch=8, poison_lr=0.05, scale_weights_poison=4.0,
    adversary_list=[0, 1], trigger_num=2, alpha_loss=1.0, save_model=True,
    save_on_epochs=[4],
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2], [0, 3]],
       "1_poison_pattern": [[3, 0], [3, 1], [3, 2], [3, 3]],
       "0_poison_epochs": [3, 4], "1_poison_epochs": [4]})


def test_cli_pretrain_resume_attack(tmp_path, capsys):
    ckdir = tmp_path / "ckpts"
    clean_yaml = tmp_path / "clean.yaml"
    clean_yaml.write_text(yaml.safe_dump(dict(CLEAN,
                                              checkpoint_dir=str(ckdir))))
    assert main(["pretrain", "--params", str(clean_yaml), "--device", "cpu",
                 "--out", "clean/model.pt.tar"]) == 0
    saved = ckdir / "clean" / "model.pt.tar"
    assert (saved / ckpt.STATE_FILE).is_file()

    attack = dict(ATTACK, checkpoint_dir=str(ckdir),
                  run_dir=str(tmp_path / "runs"))
    attack_yaml = tmp_path / "attack.yaml"
    attack_yaml.write_text(yaml.safe_dump(attack))
    e = Experiment(Params.from_dict(dict(attack, resumed_model_name=
                                         "clean/model.pt.tar")),
                   save_results=False, device="cpu")
    assert e.start_epoch == 3                         # saved epoch 2 + 1
    assert e.params["lr"] == pytest.approx(0.1)       # checkpoint lr wins
    restored, epoch, _ = ckpt.load_checkpoint(saved, e.global_vars)
    assert epoch == 2
    assert torch.equal(restored.params["fc1.weight"],
                       e.global_vars.params["fc1.weight"])

    assert main(["train", "--params", str(attack_yaml), "--device", "cpu",
                 "--resume", "clean/model.pt.tar"]) == 0
    assert "final: epoch=4" in capsys.readouterr().out
    (folder,) = (tmp_path / "runs").iterdir()
    rows = [json.loads(l) for l in
            (folder / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [3, 4]
    for name in ("model_last.pt.tar", "model_last.pt.tar.epoch_4"):
        assert ckpt.verify_checkpoint(folder / name) == (True, "verified")
    assert ckpt.manifest_epoch(folder / "model_last.pt.tar") == 4


def _cells(blob):
    return list(csv.reader(io.StringIO(blob.decode())))


def _close(a, b):
    try:
        return abs(float(a) - float(b)) <= 1e-2 * max(1.0, abs(float(b)))
    except ValueError:
        return a == b


def test_interval2_tracking_round_recorded_like_jax(tmp_path):
    # benchmarks/parity_ab.py's interval-2 round (adversary 0 poisons
    # segment 1 then trains benign, adversary 1 poisons both), with the
    # local battery, batch tracking and dynamic_steps switched on
    raw = dict(MNIST_AB_I2, local_eval=True, vis_train_batch_loss=True,
               batch_track_distance=True, dynamic_steps=True)
    jexp = JExperiment(JParams.from_dict(dict(raw, run_dir=str(
        tmp_path / "jax"))), save_results=True)
    texp = Experiment(Params.from_dict(dict(raw, run_dir=str(
        tmp_path / "torch"))), save_results=True, device="cpu")
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(texp.model_def.name,
                                              jmv.params, jmv.batch_stats)
    jr, tr = jexp.run_round(1), texp.run_round(1)
    assert jr["agents"] == tr["agents"]
    jo, to = j_canonical(jexp.folder), canonical_run_outputs(texp.folder)
    assert sorted(jo) == sorted(to)
    assert "train_batch_result.csv" in to and "distance_result.csv" in to
    for jrow, trow in zip(jo["metrics.jsonl"], to["metrics.jsonl"]):
        assert sorted(jrow) == sorted(trow)
        for k in jrow:
            assert _close(str(jrow[k]), str(trow[k])) or jrow[k] == trow[k], k
    for name in jo:
        if name == "metrics.jsonl":
            continue
        jrows = jo[name] if name == "round_result.csv" else _cells(jo[name])
        trows = to[name] if name == "round_result.csv" else _cells(to[name])
        assert len(jrows) == len(trows), name
        for a, b in zip(jrows, trows):
            assert len(a) == len(b) and all(
                _close(x, y) for x, y in zip(b, a)), (name, a, b)
