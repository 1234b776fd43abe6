"""The benchmark's counts of useful work, from layer shapes and the round's
plan alone.

FLOPs: 2 per multiply-add of every convolution and of the head. Forward of a
sample is the sum over layers; its backward is twice the forward, less the
stem's input gradient, which nothing asks for (the images do not require a
gradient). BatchNorm, activations and pooling are not counted. A round's
useful FLOPs are forward and backward of every valid client sample trained
(each client's own samples times its own epochs: padded lanes, padded rows
and skipped steps are not useful work), plus the forward of every battery
sample.

Bytes of the fused update (mirrors chip_smoke.py's bound of the kernel in
dba_mod_tpu_torch/csrc/fused_update.cu): each input read once and each
output written once, for the clients that are valid at the step (the kernel
returns early for the others): 20 B a parameter value for momentum SGD
(reads w, g, m; writes w, m), 28 B with the FoolsGold accumulator, 8 B a
BatchNorm statistic (reads the new one, writes the old one).
"""
from __future__ import annotations

from typing import Dict, List

from perfbench.reference import block_plan, state_shapes


def conv_layers(arch: dict) -> List[tuple]:
    """(name, cout, cin, k, out_h, out_w) of every convolution and the head
    (k = 1, 1x1 output), in forward order."""
    hw = int(arch["image_size"])
    layers = []
    w0 = arch["widths"][0]
    if arch["stem"] == "cifar":
        layers.append(("stem", w0, 3, 3, hw, hw))
    else:
        hw = (hw + 2 * 3 - 7) // 2 + 1
        layers.append(("stem", w0, 3, 7, hw, hw))
        hw = (hw + 2 * 1 - 3) // 2 + 1
    for i, (cin, planes, stride) in enumerate(block_plan(arch)):
        out = (hw + 2 - 3) // stride + 1
        layers.append((f"b{i}.conv1", planes, cin, 3, out, out))
        layers.append((f"b{i}.conv2", planes, planes, 3, out, out))
        if stride != 1 or cin != planes:
            layers.append((f"b{i}.sc", planes, cin, 1, out, out))
        hw = out
    layers.append(("fc", arch["classes"], arch["widths"][-1], 1, 1, 1))
    return layers


def forward_flops(arch: dict) -> int:
    return sum(2 * co * ci * k * k * h * w
               for _, co, ci, k, h, w in conv_layers(arch))


def train_flops(arch: dict) -> int:
    """Forward and backward of one training sample."""
    layers = conv_layers(arch)
    fwd = [2 * co * ci * k * k * h * w for _, co, ci, k, h, w in layers]
    return sum(fwd) + 2 * sum(fwd) - fwd[0]


def battery_samples(cfg: dict, n_test: int, n_poison: int,
                    local_eval: bool) -> int:
    """Samples the round's batteries run forward: the global battery (main
    task, combined trigger, each sub-trigger) and, when on, the local
    battery of every client (main task before scaling, the combined trigger
    before and after, its own trigger)."""
    n_adv = len(cfg["adversary_list"])
    triggers = int(cfg["trigger_num"]) if n_adv == 1 else n_adv
    poison = bool(cfg["is_poison"])
    glob = n_test + ((1 + triggers) * n_poison if poison else 0)
    loc = n_test + (3 * n_poison if poison else 0)
    return glob + (int(cfg["no_models"]) * loc if local_eval else 0)


def round_flops(arch: dict, cfg: dict, plan: dict, n_test: int,
                n_poison: int, local_eval: bool) -> Dict[str, float]:
    """Useful FLOPs of one planned round: {"train", "eval", "total"}."""
    trained = sum(n * r.epochs for n, r in zip(plan["sizes"], plan["rows"]))
    tr = float(trained) * train_flops(arch)
    ev = float(battery_samples(cfg, n_test, n_poison, local_eval)) * \
        forward_flops(arch)
    return {"train": tr, "eval": ev, "total": tr + ev}


def update_bytes_per_client(arch: dict, foolsgold: bool = False) -> int:
    shapes, stats, _ = state_shapes(arch)
    n_p = sum(_numel(s) for s in shapes.values())
    n_b = sum(_numel(s) for s in stats.values())
    return (28 if foolsgold else 20) * n_p + 8 * n_b


def update_bytes(arch: dict, plan: dict, batch: int) -> List[int]:
    """Bytes each fused-update launch of a planned round needs, in launch
    order: one launch per step at which any client is valid."""
    per = update_bytes_per_client(arch)
    steps = [-(-n // batch) for n in plan["sizes"]]
    e_max = max(r.epochs for r in plan["rows"])
    s_max = max(steps)
    out = []
    for e in range(e_max):
        for s in range(s_max):
            valid = sum(1 for c, r in enumerate(plan["rows"])
                        if e < r.epochs and s < steps[c])
            if valid:
                out.append(valid * per)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
