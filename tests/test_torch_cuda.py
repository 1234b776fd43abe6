"""Checks of the port that need NVIDIA cards (marker ``cuda``); without
enough cards they skip. This file imports no JAX: it holds the port
against its own plain version. On a machine with cards, run it without the
suite's JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

- the fused update kernel launched on a card that is not the current one
  (a mesh over distinct cards, or ranks that share a host's cards), bitwise
  its plain version;
- a 2-shard MNIST mesh over two cards against the same mesh on one card,
  under deterministic kernels: the same model and rows bit for bit, with
  the shards' launches counted.
"""
import numpy as np
import pytest
import torch

from dba_mod_tpu_torch.ops import fused_update as fu

pytestmark = pytest.mark.cuda

MNIST = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=2, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, internal_poison_epochs=2, is_poison=True,
    synthetic_data=True, synthetic_train_size=320,
    synthetic_test_size=128, momentum=0.9, decay=0.0005,
    sampling_dirichlet=False, local_eval=True, poison_label_swap=2,
    poisoning_per_batch=4, poison_lr=0.05, scale_weights_poison=3.0,
    adversary_list=[0], trigger_num=1, alpha_loss=1.0, random_seed=3,
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2], [0, 3]],
       "0_poison_epochs": [1, 2]})


def _cards(n: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


def test_kernel_launches_on_a_card_that_is_not_current():
    _cards(2)
    rng = np.random.RandomState(0)
    dev = torch.device("cuda", 1)
    C = 3

    def tree(*shapes):
        return {f"l{i}": torch.from_numpy(
            rng.randn(C, *s).astype(np.float32)).to(dev)
            for i, s in enumerate(shapes)}

    params, grads, mom, fg = (tree((7,), (5, 9)) for _ in range(4))
    bn_new, bn_old = tree((11,)), tree((11,))
    lr = torch.tensor([0.1, 0.2, 0.3], device=dev)
    valid = torch.tensor([1.0, 0.0, 1.0], device=dev)
    kw = dict(momentum=0.9, weight_decay=5e-4)
    want = fu.fused_step_update_reference(lr, valid, params, grads, mom, fg,
                                          bn_new, bn_old, **kw)
    fu.fused_step_update.launches = 0
    with torch.cuda.device(0):
        fu.fused_step_update(lr, valid, params, grads, mom, fg, bn_new,
                             bn_old, **kw)
        torch.cuda.synchronize(dev)
    assert fu.fused_step_update.launches == 1
    for got, ref in zip((params, mom, fg, bn_old), want):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_mesh_over_two_cards_is_the_one_card_mesh():
    _cards(2)
    from dba_mod_tpu_torch.config import Params
    from dba_mod_tpu_torch.fl.experiment import Experiment
    from dba_mod_tpu_torch.utils.device import use_deterministic_kernels
    use_deterministic_kernels()
    runs = {}
    for name, devs in (("one_card", ["cuda:0", "cuda:0"]),
                       ("two_cards", ["cuda:0", "cuda:1"])):
        fu.fused_step_update.launches = 0
        e = Experiment(Params.from_dict(dict(MNIST)), save_results=False,
                       device="cuda", mesh_devices=devs)
        e.run(2)
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        runs[name] = (e, fu.fused_step_update.launches)
    (a, na), (b, nb) = runs["one_card"], runs["two_cards"]
    assert na == nb > 0
    for part in ("params", "batch_stats"):
        for k, v in getattr(a.global_vars, part).items():
            assert torch.equal(v, getattr(b.global_vars, part)[k]), k
    strip = lambda rows: [{k: v for k, v in r.items()
                           if not k.endswith("time")} for r in rows]
    assert strip(a.recorder._jsonl_rows) == strip(b.recorder._jsonl_rows)
