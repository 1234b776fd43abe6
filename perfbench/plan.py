"""Frozen copies of the round-planning arithmetic the port derives on the host.

The plain reference and the counting functions work a round out again from
the configuration alone, so they need the partition, the agent selection,
the client task rows and the batch plans as the port makes them, with the
same random streams consumed in the same order. These are copies, kept here
so that a later change to the port cannot move the yardstick:

- ``dirichlet_partition``  mirrors dba_mod_tpu_torch/data/partition.py
  (sample_dirichlet_indices);
- ``select_agents``        mirrors dba_mod_tpu_torch/fl/selection.py;
- ``client_rows``          mirrors dba_mod_tpu_torch/fl/state.py
  (build_client_tasks) with ops/sgd.py's poison MultiStepLR;
- ``batch_plan``           mirrors dba_mod_tpu_torch/data/batching.py
  (build_batch_plan), and ``eval_indices`` its eval plans' index sets;
- ``pattern_bank``         mirrors dba_mod_tpu_torch/ops/triggers.py
  (build_pixel_pattern_bank).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

import numpy as np


def dirichlet_partition(labels: np.ndarray, participants: int, alpha: float,
                        seed: int) -> Dict[int, List[int]]:
    """Per class in label order: shuffle the class's pool with
    random.Random(seed), draw one Dirichlet vector over the participants
    from RandomState(seed), and hand out int(round(.)) of the pool in
    participant order, scaled by the size of class 0."""
    py_rng, np_rng = random.Random(seed), np.random.RandomState(seed)
    classes: Dict[int, List[int]] = {}
    for i, y in enumerate(labels):
        classes.setdefault(int(y), []).append(i)
    class_size = len(classes[0])
    out: Dict[int, List[int]] = {u: [] for u in range(participants)}
    for n in range(len(classes)):
        pool = classes[n]
        py_rng.shuffle(pool)
        probs = class_size * np_rng.dirichlet(np.array(participants * [alpha]))
        for user in range(participants):
            take = min(len(pool), int(round(probs[user])))
            out[user].extend(pool[:take])
            pool = pool[take:]
    return out


def poison_epochs(cfg: dict, slot: int) -> List[int]:
    return list(cfg[f"{slot}_poison_epochs"]) if slot >= 0 else list(
        cfg["poison_epochs"])


def select_agents(cfg: dict, epoch: int, benign: List[int],
                  rng: random.Random):
    """(agents, adversaries) of one round: random namelist with the fixed
    adversaries whose schedule covers the round forced in first, the rest a
    sample of the benign and the off-schedule adversaries."""
    advs = list(cfg["adversary_list"])
    ongoing = range(epoch, epoch + int(cfg["aggr_epoch_interval"]))
    on = [a for i, a in enumerate(advs)
          if any(e in poison_epochs(cfg, i) for e in ongoing)]
    off = [a for a in advs if a not in on]
    fill = rng.sample(benign + off, int(cfg["no_models"]) - len(on))
    return on + fill, on


def poison_lr_multipliers(epochs: int) -> np.ndarray:
    """torch MultiStepLR at milestones {0.2, 0.8}*E, gamma 0.1, stepped
    after each epoch; a milestone fires only when it is an exact integer."""
    hits = [int(m) for m in (0.2 * epochs, 0.8 * epochs) if float(m) == int(m)]
    return np.array([0.1 ** sum(1 for m in hits if m <= i - 1)
                     for i in range(1, epochs + 1)], np.float32)


@dataclasses.dataclass
class ClientRow:
    name: int
    adv_slot: int          # position in adversary_list, -1 benign
    adv_index: int         # trigger row while poisoning, -1 otherwise
    poison_k: int          # poisoned samples at the head of each batch
    alpha: float
    scale: float
    epochs: int
    lr: np.ndarray         # [E] per internal epoch (0 past its epochs)


def client_rows(cfg: dict, agents: Sequence[int], epoch: int,
                e_max: int) -> List[ClientRow]:
    advs = list(cfg["adversary_list"])
    lr, plr = float(cfg["lr"]), float(cfg["poison_lr"])
    ip = int(cfg["internal_poison_epochs"])
    mult = (poison_lr_multipliers(ip) if bool(cfg["poison_step_lr"])
            else np.ones((ip,), np.float32))
    rows = []
    for name in agents:
        slot = advs.index(name) if name in advs else -1
        now = bool(cfg["is_poison"]) and slot >= 0 and epoch in poison_epochs(
            cfg, slot)
        lrow = np.full((e_max,), lr, np.float32)
        if now:
            lrow[:] = 0.0
            lrow[:min(e_max, ip)] = (np.float32(plr) * mult)[:e_max]
            centralized = len(advs) == 1
            rows.append(ClientRow(
                name, slot, -1 if centralized else slot,
                int(cfg["poisoning_per_batch"]), float(cfg["alpha_loss"]),
                1.0 if bool(cfg["baseline"]) else float(
                    cfg["scale_weights_poison"]), ip, lrow))
        else:
            rows.append(ClientRow(name, slot, -1, 0, 1.0, 1.0,
                                  int(cfg["internal_epochs"]), lrow))
    return rows


def batch_plan(client_indices: Sequence[Sequence[int]],
               client_epochs: Sequence[int], batch: int,
               rng: np.random.RandomState, steps: int, e_max: int):
    """([C, E, S, B] int64 indices, [C, E, S, B] bool mask): each epoch a
    fresh permutation of the client's samples, tiled to S*B so the padded
    rows are the client's own samples; empty clients stay masked and draw
    nothing."""
    C = len(client_indices)
    E = max(e_max, max(client_epochs, default=1), 1)
    sizes = [len(ix) for ix in client_indices]
    S = max(steps, -(-max(sizes) // batch) if max(sizes) else steps)
    idx = np.zeros((C, E, S, batch), np.int64)
    mask = np.zeros((C, E, S, batch), bool)
    for c, ix in enumerate(client_indices):
        n = len(ix)
        if n == 0:
            continue
        arr = np.asarray(ix, np.int64)
        for e in range(min(int(client_epochs[c]), E)):
            shuffled = arr[rng.permutation(n)]
            reps = -(-S * batch // n)
            idx[c, e] = np.tile(shuffled, reps)[:S * batch].reshape(S, batch)
            m = np.zeros((S * batch,), bool)
            m[:n] = True
            mask[c, e] = m.reshape(S, batch)
    return idx, mask


def eval_indices(test_labels: np.ndarray, swap: int):
    """(clean, poison) test index sets: every test sample, and those whose
    label is not the backdoor's target."""
    return (np.arange(len(test_labels)),
            np.nonzero(test_labels != swap)[0])


def pattern_bank(cfg: dict, h: int, w: int) -> np.ndarray:
    """[trigger_num + 1, H, W] {0, 1}: each adversary's sub-pattern, the
    last row their union."""
    n = int(cfg["trigger_num"])
    bank = np.zeros((n + 1, h, w), np.float32)
    for i in range(n):
        for r, c in cfg[f"{i}_poison_pattern"]:
            bank[i, r, c] = 1.0
            bank[n, r, c] = 1.0
    return bank


class RoundPlanner:
    """The port's host plan of consecutive rounds from the configuration:
    partition once, then per round the agents, their task rows and their
    batch plans, consuming one selection and one plan stream as the port
    does from its first round on."""

    def __init__(self, cfg: dict, train_labels: np.ndarray):
        self.cfg = cfg
        seed = int(cfg["random_seed"])
        P = int(cfg["number_of_total_participants"])
        self.parts = dirichlet_partition(train_labels, P,
                                         float(cfg["dirichlet_alpha"]), seed)
        self.benign = sorted(set(range(P)) - set(cfg["adversary_list"]))
        self.select_rng = random.Random(seed)
        self.plan_rng = np.random.RandomState(seed)
        b = int(cfg["batch_size"])
        self.steps = max(1, -(-max(len(v) for v in self.parts.values()) // b))
        ie, ip = int(cfg["internal_epochs"]), int(cfg["internal_poison_epochs"])
        self.e_max = max(ie, ip) if bool(cfg["is_poison"]) else ie

    def next_round(self, epoch: int, with_plan: bool = True) -> dict:
        agents, advs = select_agents(self.cfg, epoch, self.benign,
                                     self.select_rng)
        rows = client_rows(self.cfg, agents, epoch, self.e_max)
        out = {"epoch": epoch, "agents": agents, "advs": advs, "rows": rows,
               "sizes": [len(self.parts[a]) for a in agents]}
        if with_plan:
            out["idx"], out["mask"] = batch_plan(
                [self.parts[a] for a in agents], [r.epochs for r in rows],
                int(self.cfg["batch_size"]), self.plan_rng, self.steps,
                self.e_max)
        return out
