"""A run with its timed path broken underneath comes out not correct, once
for each fault a round of one card can have. (No exchange between cards
exists on one card.)"""
from __future__ import annotations

import pytest

from perfbench.cell import run_cell
from perfbench.tests.conftest import ROOT, SMALL


def _unchanged(monkeypatch):
    # every client's step returns its state unchanged
    import dba_mod_tpu_torch.ops.fused_update as fu
    monkeypatch.setattr(fu, "plain_update_", lambda *a, **k: None)


def _half_batch(monkeypatch):
    # the loss of each step over the first half of the batch only
    import dba_mod_tpu_torch.fl.client as client
    real = client.cross_entropy

    def half(logits, labels, mask=None):
        m = mask.clone()
        m[..., m.shape[-1] // 2:] = False
        return real(logits, labels, m)
    monkeypatch.setattr(client, "cross_entropy", half)


def _answer(monkeypatch):
    # the global battery's main-task accuracy one point higher where it is
    # produced
    from dba_mod_tpu_torch.fl import rounds
    real = rounds.RoundEngine._global_evals

    def altered(self, model_vars):
        g = real(self, model_vars)
        return g._replace(clean=g.clean._replace(acc=g.clean.acc + 1.0))
    monkeypatch.setattr(rounds.RoundEngine, "_global_evals", altered)


def _server_unchanged(monkeypatch):
    # the server's FedAvg step returns the global model unchanged
    from dba_mod_tpu_torch.ops import aggregation as agg
    monkeypatch.setattr(agg, "fedavg_update",
                        lambda g, *a, **k: dict(g))
    monkeypatch.setattr(agg, "fedavg_update_masked",
                        lambda g, *a, **k: dict(g))


@pytest.mark.parametrize(
    "plant", [_unchanged, _half_batch, _answer, _server_unchanged],
    ids=["unchanged", "half_batch", "answer", "server_unchanged"])
def test_a_broken_round_is_not_correct(plant, monkeypatch, cpu_threads,
                                       small_cache):
    plant(monkeypatch)
    w = "cifar10_resnet18.as_local"
    res, lines = run_cell(ROOT, w, 11, 0.1, False, device="cpu",
                          overrides=SMALL[w], cache=small_cache)
    assert res["correct"] is False, lines
