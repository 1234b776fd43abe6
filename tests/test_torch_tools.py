"""The port's measurement tools, on the CPU at a tiny size.

- profile_round times one poisoned round phase by phase; the phases add up
  to the round, the fused kernel is never launched on the CPU, and no
  device number is reported for a CPU run.
- repeatability runs the pretrain → resume → two poisoned rounds path twice
  from the same seed: on the CPU the two runs give bitwise the same models,
  and the process-wide determinism switches are left as they were found."""
import json

import pytest
import torch
import yaml

from dba_mod_tpu_torch import profile_round, repeatability


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TINY = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=3, no_models=3,
    number_of_total_participants=6, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, internal_poison_epochs=2, is_poison=True,
    synthetic_data=True, synthetic_train_size=120, synthetic_test_size=48,
    momentum=0.9, decay=0.0005, sampling_dirichlet=False, local_eval=True,
    random_seed=3, poison_label_swap=2, poisoning_per_batch=4,
    poison_lr=0.05, scale_weights_poison=4.0, adversary_list=[0, 1],
    trigger_num=2, alpha_loss=1.0,
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2]],
       "1_poison_pattern": [[3, 0], [3, 1], [3, 2]]})


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_profile_round_phases_add_up_on_cpu(tmp_path, capsys):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY))
    assert profile_round.main(["--params", str(cfg), "--device", "cpu"]) == 0
    rep = _last_json(capsys.readouterr().out)
    assert rep["device"] == "cpu"
    assert rep["device_busy_s"] is None and rep["device_busy_share"] is None
    for run in (rep["timed"], rep["traced"]):
        assert run["active_steps"] > 0
        assert run["fused_launches"] == 0          # no kernel on the CPU
        assert run["round_s"] == pytest.approx(sum(
            run[k] for k in ("train_s", "aggregate_s", "local_evals_s",
                             "global_evals_s")))


def test_repeatability_same_seed_same_models_on_cpu(tmp_path, capsys):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY))
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic)
    assert repeatability.main(["--params", str(cfg), "--device", "cpu",
                               "--runs", "2", "--deterministic"]) == 0
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic) == before
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    runs, summary = lines[:-1], lines[-1]
    assert [r["epochs"] for r in runs] == [[2, 3], [2, 3]]
    assert summary["pretrain_identical"] and summary["final_identical"]
    assert summary["device"] == "cpu" and summary["runs"] == 2
