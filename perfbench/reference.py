"""The plain reference of one federated round, in plain PyTorch.

It imports nothing of the program. Each selected client trains on its own,
one batch at a time, as the DBA reference's image_train.py does: a ResNet of
torch.nn.functional ops (cuDNN convolutions, F.batch_norm with torch's
running statistics), cross entropy over the batch's valid samples, and a
momentum-SGD step with weight decay written out. No vmap, no stacked
clients, no fused kernel. The server is FedAvg over the full state, and the
batteries evaluate in eval mode in large batches. The pattern is that of
benchmarks/torch_reference.py (a sequential per-client round), rewritten for
the card and for the port's semantics: batch plans padded with the client's
own samples (which BatchNorm sees and the loss masks out), the first
``poisoning_per_batch`` rows of an adversary's batch stamped with its
sub-trigger, the model-replacement epilogue, and the per-client battery on
the models before and after scaling.

``precision`` is "float32" (TF32 off, as the configurations state) or
"tf32" (the control: the same arithmetic with TF32 convolutions and matrix
products). ``half_batch`` plants the fault in which the loss is taken over
the first half of each batch only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- the model
def block_plan(arch: dict):
    """(in_planes, planes, stride) of every BasicBlock."""
    plan, cin = [], arch["widths"][0]
    for stage, (planes, n) in enumerate(zip(arch["widths"], arch["blocks"])):
        for i in range(n):
            plan.append((cin, planes, 2 if stage > 0 and i == 0 else 1))
            cin = planes
    return plan


def state_shapes(arch: dict):
    """(params {key: shape}, BN stats {key: shape}) under the checkpoint's
    key names, with the fan-in of every weight that has one."""
    params, stats, fan = {}, {}, {}

    def conv(name, cout, cin, k):
        params[f"{name}.weight"] = (cout, cin, k, k)
        fan[f"{name}.weight"] = cin * k * k

    def bn(name, c):
        params[f"{name}.weight"] = (c,)
        params[f"{name}.bias"] = (c,)
        stats[f"{name}.running_mean"] = (c,)
        stats[f"{name}.running_var"] = (c,)

    w0 = arch["widths"][0]
    conv("stem_conv", w0, 3, 3 if arch["stem"] == "cifar" else 7)
    bn("stem_bn", w0)
    for i, (cin, planes, stride) in enumerate(block_plan(arch)):
        conv(f"blocks.{i}.conv1", planes, cin, 3)
        bn(f"blocks.{i}.bn1", planes)
        conv(f"blocks.{i}.conv2", planes, planes, 3)
        bn(f"blocks.{i}.bn2", planes)
        if stride != 1 or cin != planes:
            conv(f"blocks.{i}.sc_conv", planes, cin, 1)
            bn(f"blocks.{i}.sc_bn", planes)
    feat = arch["widths"][-1]
    params["fc.weight"] = (arch["classes"], feat)
    fan["fc.weight"] = feat
    params["fc.bias"] = (arch["classes"],)
    fan["fc.bias"] = feat
    return params, stats, fan


def forward(p: Tree, s: Tree, x: torch.Tensor, arch: dict, train: bool,
            new_stats: Optional[Tree] = None) -> torch.Tensor:
    """x: [N, H, W, 3] float32 in [0, 1] -> logits [N, classes]. In train
    mode the batch's statistics normalise and the updated running stats go
    into `new_stats`."""
    y = x.permute(0, 3, 1, 2)

    def bn(name, t):
        rm, rv = s[f"{name}.running_mean"], s[f"{name}.running_var"]
        if train:
            rm, rv = rm.clone(), rv.clone()
        out = F.batch_norm(t, rm, rv, p[f"{name}.weight"], p[f"{name}.bias"],
                           training=train, momentum=0.1, eps=1e-5)
        if train:
            new_stats[f"{name}.running_mean"] = rm
            new_stats[f"{name}.running_var"] = rv
        return out

    if arch["stem"] == "cifar":
        y = F.relu(bn("stem_bn", F.conv2d(y, p["stem_conv.weight"],
                                          padding=1)))
    else:
        y = F.relu(bn("stem_bn", F.conv2d(y, p["stem_conv.weight"], stride=2,
                                          padding=3)))
        y = F.max_pool2d(y, 3, 2, padding=1)
    for i, (cin, planes, stride) in enumerate(block_plan(arch)):
        b = f"blocks.{i}"
        h = F.relu(bn(f"{b}.bn1", F.conv2d(y, p[f"{b}.conv1.weight"],
                                           stride=stride, padding=1)))
        h = bn(f"{b}.bn2", F.conv2d(h, p[f"{b}.conv2.weight"], padding=1))
        r = y
        if stride != 1 or cin != planes:
            r = bn(f"{b}.sc_bn", F.conv2d(y, p[f"{b}.sc_conv.weight"],
                                          stride=stride))
        y = F.relu(h + r)
    if arch["pool"] == "avg4":
        y = F.avg_pool2d(y, 4, 4).flatten(1)
    else:
        y = y.mean(dim=(2, 3))
    return F.linear(y, p["fc.weight"], p["fc.bias"])


@contextlib.contextmanager
def precision(mode: str):
    """float32 with TF32 off, or the TF32 control."""
    on = mode == "tf32"
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


# ------------------------------------------------------------------- data
class Images:
    """The benchmark's images on the device: uint8 NHWC, int64 labels."""

    def __init__(self, train_x, train_y, test_x, test_y, device):
        self.train_x = torch.as_tensor(train_x).to(device)
        self.train_y = torch.as_tensor(train_y).long().to(device)
        self.test_x = torch.as_tensor(test_x).to(device)
        self.test_y = torch.as_tensor(test_y).long().to(device)


def _stamp(x: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Trigger pixels set to 1.0 in every channel."""
    m = pattern[None, :, :, None]
    return torch.where(m > 0, torch.ones_like(x), x)


# ---------------------------------------------------------------- training
def train_client(start: tuple, row, idx: np.ndarray, mask: np.ndarray,
                 active: np.ndarray, data: Images, bank: torch.Tensor,
                 cfg: dict, arch: dict, steps_k: int,
                 half_batch: bool = False) -> dict:
    """One client's round. start: (params, stats) of the global model;
    idx/mask: its [E, S, B] plan; active: [E, S], the steps at which any
    client of the round is valid (the stacked loop's steps). Returns the
    delta (params and stats), the per-epoch sums of the batch losses, the
    per-leaf norms of the first gradient the optimizer was given, and the
    change of the state after the round's first `steps_k` steps."""
    p0, s0 = start
    dev = next(iter(p0.values())).device
    p = {k: v.clone() for k, v in p0.items()}
    s = {k: v.clone() for k, v in s0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    mu, wd = float(cfg["momentum"]), float(cfg["decay"])
    swap = int(cfg["poison_label_swap"])
    E, S, B = idx.shape
    losses = torch.zeros((E,), dtype=torch.float64, device=dev)
    grad0, change_k, step = None, None, 0
    keys = list(p)
    pattern = bank[row.adv_index] if row.adv_index >= 0 else bank[-1]
    for e in range(E):
        lr = float(row.lr[e])
        for st in range(S):
            if not active[e, st]:
                continue
            m = mask[e, st]
            if m.any():
                bi = torch.from_numpy(idx[e, st]).to(dev)
                x = data.train_x[bi].float() / 255.0
                y = data.train_y[bi].clone()
                if row.poison_k > 0:
                    k = row.poison_k
                    x = torch.cat([_stamp(x[:k], pattern), x[k:]])
                    y[:k] = swap
                mf = torch.from_numpy(m.astype(np.float32)).to(dev)
                if half_batch:
                    mf[B // 2:] = 0.0
                leaves = [p[k].requires_grad_(True) for k in keys]
                new_s: Tree = {}
                logits = forward(p, s, x, arch, True, new_s)
                nll = F.cross_entropy(logits, y, reduction="none")
                loss = (nll * mf).sum() / mf.sum().clamp_min(1.0)
                alpha = float(row.alpha)
                if alpha != 1.0:
                    dist = torch.sqrt(sum(((p[k] - p0[k]) ** 2).sum()
                                          for k in keys))
                    loss = alpha * loss + (1.0 - alpha) * dist
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    if grad0 is None:
                        grad0 = {k: g.norm() for k, g in zip(keys, grads)}
                    for k, g in zip(keys, grads):
                        w = p[k].detach()
                        mom[k] = mu * mom[k] + (g + wd * w)
                        p[k] = w - lr * mom[k]
                    s = new_s
                    losses[e] += loss.detach()
            step += 1
            if step == steps_k:
                change_k = ({k: p[k].detach() - p0[k] for k in p},
                            {k: s[k] - s0[k] for k in s})
    with torch.no_grad():
        sc = float(row.scale)
        dp = {k: (p0[k] + sc * (p[k].detach() - p0[k])) - p0[k] for k in p}
        ds = {k: (s0[k] + sc * (s[k] - s0[k])) - s0[k] for k in s}
    return {"delta": (dp, ds), "losses": losses, "grad0": grad0,
            "change_k": change_k}


def fedavg(start: tuple, deltas: List[tuple], cfg: dict) -> tuple:
    """g + eta/no_models * sum of the deltas, params and BN stats."""
    scale = float(cfg["eta"]) / int(cfg["no_models"])
    out = []
    for part, tree in enumerate(start):
        out.append({k: g + scale * torch.stack([d[part][k] for d in deltas]
                                               ).sum(0)
                    for k, g in tree.items()})
    return tuple(out)


# --------------------------------------------------------------- batteries
@torch.no_grad()
def evaluate(model: tuple, data: Images, indices: np.ndarray, arch: dict,
             pattern: Optional[torch.Tensor] = None, swap: int = 0,
             chunk: int = 1000) -> tuple:
    """(mean loss, accuracy %) over test `indices`; with a trigger
    `pattern` every sample is stamped and relabelled to `swap`."""
    p, s = model
    dev = data.test_x.device
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    ix = torch.from_numpy(np.asarray(indices, np.int64)).to(dev)
    for a in range(0, len(ix), chunk):
        bi = ix[a:a + chunk]
        x = data.test_x[bi].float() / 255.0
        y = data.test_y[bi]
        if pattern is not None:
            x = _stamp(x, pattern)
            y = torch.full_like(y, swap)
        logits = forward(p, s, x, arch, False)
        loss += F.cross_entropy(logits, y, reduction="sum").double()
        correct += (logits.argmax(-1) == y).sum()
    n = max(len(ix), 1)
    return float(loss) / n, 100.0 * float(correct) / n


def global_battery(model: tuple, data: Images, sets: tuple, bank, cfg: dict,
                   arch: dict) -> Dict[str, tuple]:
    """main task, the combined trigger, and each adversary's sub-trigger."""
    clean, poison = sets
    swap = int(cfg["poison_label_swap"])
    n_adv = len(cfg["adversary_list"])
    triggers = (int(cfg["trigger_num"]) if n_adv == 1 else n_adv)
    out = {"global.clean": evaluate(model, data, clean, arch)}
    if bool(cfg["is_poison"]):
        out["global.poison"] = evaluate(model, data, poison, arch, bank[-1],
                                        swap)
        for t in range(triggers):
            out[f"global.trigger{t}"] = evaluate(model, data, poison, arch,
                                                 bank[t], swap)
    return out


def local_battery(start: tuple, delta: tuple, row, data: Images, sets: tuple,
                  bank, cfg: dict, arch: dict, c: int) -> Dict[str, tuple]:
    """One client's rows: clean and poison before scaling, poison and its
    own trigger on the submitted model."""
    clean, poison = sets
    swap = int(cfg["poison_label_swap"])
    sc = float(row.scale)
    unscaled = tuple({k: g + d[k] / sc for k, g in t.items()}
                     for t, d in zip(start, delta))
    scaled = tuple({k: g + d[k] for k, g in t.items()}
                   for t, d in zip(start, delta))
    own = bank[row.adv_slot] if row.adv_slot >= 0 else bank[-1]
    out = {f"local{c}.clean": evaluate(unscaled, data, clean, arch)}
    if bool(cfg["is_poison"]):
        out[f"local{c}.pre"] = evaluate(unscaled, data, poison, arch,
                                        bank[-1], swap)
        out[f"local{c}.post"] = evaluate(scaled, data, poison, arch,
                                         bank[-1], swap)
        out[f"local{c}.agent"] = evaluate(scaled, data, poison, arch, own,
                                          swap)
    return out


def reference_round(start: tuple, plan: dict, data: Images, cfg: dict,
                    arch: dict, local_eval: bool, judged: dict,
                    steps_k: int, mode: str = "float32",
                    half_batch: bool = False, battery: bool = True) -> dict:
    """The round from `start` on the planned clients, in the structure the
    comparison reads. `judged` holds the program's outputs that the
    batteries are run on (its client deltas and its new global model): the
    battery is judged on the models the program produced, and the server
    rule on the deltas the program submitted (``rule_global``)."""
    dev = next(iter(start[0].values())).device
    bank = torch.from_numpy(pattern_bank_from(cfg, data)).to(dev)
    sets = eval_sets(cfg, data)
    out = {"grad0": [], "losses": [], "deltas": [], "change_k": [],
           "battery": {}}
    active = plan["mask"].any(axis=(0, 3))
    with precision(mode):
        for c, row in enumerate(plan["rows"]):
            r = train_client(start, row, plan["idx"][c], plan["mask"][c],
                             active, data, bank, cfg, arch, steps_k,
                             half_batch)
            out["change_k"].append(r["change_k"])
            out["grad0"].append(r["grad0"])
            out["losses"].append(r["losses"])
            out["deltas"].append(r["delta"])
        out["new_global"] = fedavg(start, out["deltas"], cfg)
        # the server rule on its own: FedAvg, in float64, over the deltas
        # the program submitted, which the program's new model is held to
        out["rule_global"] = fedavg(_double(start), [
            _double(d) for d in judged["deltas"]], cfg)
        if not battery:
            return out
        out["battery"].update(global_battery(judged["new_global"], data,
                                             sets, bank, cfg, arch))
        if local_eval:
            for c, row in enumerate(plan["rows"]):
                out["battery"].update(local_battery(
                    start, judged["deltas"][c], row, data, sets, bank, cfg,
                    arch, c))
    return out


def _double(pair: tuple) -> tuple:
    return tuple({k: v.double() for k, v in t.items()} for t in pair)


def pattern_bank_from(cfg: dict, data: Images) -> np.ndarray:
    from perfbench.plan import pattern_bank
    return pattern_bank(cfg, data.test_x.shape[1], data.test_x.shape[2])


def eval_sets(cfg: dict, data: Images) -> tuple:
    from perfbench.plan import eval_indices
    return eval_indices(data.test_y.cpu().numpy(),
                        int(cfg["poison_label_swap"]))
