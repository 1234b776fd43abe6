"""The benchmark's counts against hand counts of the layer shapes."""
from __future__ import annotations

import json

import pytest

from perfbench import counting
from perfbench.tests.conftest import ROOT

# multiply-adds of one forward pass, by stage, counted by hand:
# CIFAR (32x32, widths 32-256): stem 32*3*9*32*32; stage 1 four 32->32 3x3
# convolutions at 32x32; stages 2-4 each a strided 3x3, three 3x3 and a
# 1x1 shortcut (33,554,432 MACs each); the 256->10 head
CIFAR_MACS = (32 * 3 * 9 * 1024 + 4 * 32 * 32 * 9 * 1024 + 3 * 33_554_432
              + 10 * 256)
# Tiny (64x64, widths 64-512): 7x7/s2 stem to 32x32, max pool to 16x16,
# stage 1 four 64->64 3x3 at 16x16, stages 2-4 33,554,432 MACs each, the
# 512->200 head
TINY_MACS = (64 * 3 * 49 * 1024 + 4 * 64 * 64 * 9 * 256 + 3 * 33_554_432
             + 200 * 512)


def _arch(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json"
                       ).read_text())["arch"]


@pytest.mark.parametrize("name,macs", [("cifar10_resnet18", CIFAR_MACS),
                                       ("tiny_resnet18", TINY_MACS)])
def test_forward_flops_match_a_hand_count(name, macs):
    arch = _arch(name)
    assert counting.forward_flops(arch) == 2 * macs
    stem = counting.conv_layers(arch)[0]
    stem_flops = 2 * stem[1] * stem[2] * stem[3] ** 2 * stem[4] * stem[5]
    assert counting.train_flops(arch) == 3 * 2 * macs - stem_flops


@pytest.mark.parametrize("name,bound_ms", [("cifar10_resnet18", 0.1671),
                                           ("tiny_resnet18", 0.6736)])
def test_fused_update_bytes_match_the_kernel_bound(name, bound_ms):
    # PERF.md's bound of one launch with all 10 clients valid, 3.35 TB/s
    per = counting.update_bytes_per_client(_arch(name))
    assert round(10 * per / 3.35e12 * 1e3, 4) == bound_ms


def test_update_bytes_count_only_valid_clients():
    from perfbench.plan import ClientRow
    import numpy as np
    arch = _arch("cifar10_resnet18")
    rows = [ClientRow(0, -1, -1, 0, 1.0, 1.0, 2, np.zeros(6)),
            ClientRow(1, 0, 0, 5, 1.0, 1.0, 6, np.zeros(6))]
    plan = {"sizes": [130, 64], "rows": rows}
    per = counting.update_bytes_per_client(arch)
    # epochs 0-1: 3 steps, the first with both clients; epochs 2-5: one
    assert counting.update_bytes(arch, plan, 64) == (
        [2 * per, per, per] * 2 + [per] * 4)
    f = counting.round_flops(arch, {"adversary_list": [9, 8], "trigger_num": 2,
                                    "is_poison": True, "no_models": 2},
                             plan, 100, 90, local_eval=False)
    assert f["train"] == (130 * 2 + 64 * 6) * counting.train_flops(arch)
    assert f["eval"] == (100 + 3 * 90) * counting.forward_flops(arch)
