"""Deterministic fault injection for the round path (port of
dba_mod_tpu/fl/faults.py).

Faults perturb what the server RECEIVES from each client in a round, never
the local training: they model the uplink. Per client and round, mutually
exclusive, resolved in the order dropout > corrupt > blowup > stale:

  dropout — the client never reports: its payload is zeroed and it leaves
            the survivor mask, with or without screening;
  corrupt — the payload arrives NaN (caught by the finite screen);
  blowup  — the payload is scaled by ``fault_blowup_factor`` (caught by
            the norm screen when it is on; otherwise the round-level retry
            handles a non-finite aggregate);
  stale   — the client replays the delta it submitted the round before
            (finite and plausible, so deliberately not screenable). Deltas
            only: under FoolsGold a stale client's accumulators pass as
            they are.

The plan is a pure function of ``(fault_seed, epoch)``: a
``torch.Generator`` seeded from both draws it on the CPU, so a fault
schedule reproduces across runs, retries and devices, and is independent of
every other random stream. jax.random draws other numbers, so the JAX
package's plan for the same seed differs; tests hand one plan to both. The
host-loss lane (``fault_host_loss_prob``) belongs to the multi-host layer
(ROADMAP A18) and is rejected by config.check_ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops.aggregation import _bc_mask as _bc
from dba_mod_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs."""
    enabled: bool
    dropout_prob: float
    corrupt_prob: float
    blowup_prob: float
    blowup_factor: float
    stale_prob: float
    seed: int

    @property
    def stale_enabled(self) -> bool:
        return self.enabled and self.stale_prob > 0.0

    @classmethod
    def from_params(cls, p: cfg.Params) -> "FaultConfig":
        probs = {k: float(p.get(f"fault_{k}_prob", 0.0))
                 for k in ("dropout", "corrupt", "blowup", "stale")}
        for k, v in probs.items():
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault_{k}_prob={v} not in [0, 1]")
        return cls(enabled=bool(p.get("fault_injection", False)),
                   dropout_prob=probs["dropout"],
                   corrupt_prob=probs["corrupt"],
                   blowup_prob=probs["blowup"],
                   blowup_factor=float(p.get("fault_blowup_factor", 1e8)),
                   stale_prob=probs["stale"],
                   seed=int(p.get("fault_seed", 0)))


class FaultPlan(NamedTuple):
    """Per-client fault assignment for one round (all [C] bool)."""
    dropped: torch.Tensor
    corrupt: torch.Tensor
    blowup: torch.Tensor
    stale: torch.Tensor

    def to(self, device: torch.device) -> "FaultPlan":
        return FaultPlan(*(to_device(t, device) for t in self))


def fault_generator(seed: int, epoch: int) -> torch.Generator:
    """The round's fault stream: a CPU generator keyed by (seed, epoch)."""
    key = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(key))


def make_fault_plan(fcfg: FaultConfig, gen: torch.Generator,
                    counted: torch.Tensor) -> FaultPlan:
    """Draw one round's fault assignment on the CPU. ``counted`` ([C] bool)
    marks real clients; a lane that is not counted never faults."""
    counted = counted.cpu()
    u = torch.rand((4, counted.shape[0]), generator=gen)
    free = counted
    hits = []
    for row, p in zip(u, (fcfg.dropout_prob, fcfg.corrupt_prob,
                          fcfg.blowup_prob, fcfg.stale_prob)):
        hit = (row < p) & free
        free = free & ~hit
        hits.append(hit)
    return FaultPlan(*hits)


def perturb_tree(tree: Any, plan: FaultPlan, fcfg: FaultConfig,
                 stale_tree: Optional[Any] = None) -> Any:
    """Apply one round's faults to a client-stacked payload: a tensor, a
    dict of tensors or a ModelVars. Non-float leaves pass through. Without
    ``stale_tree`` the stale lane is a no-op."""
    def f(leaf, stale_leaf):
        if not leaf.is_floating_point():
            return leaf
        zero = torch.zeros((), dtype=leaf.dtype, device=leaf.device)
        x = torch.where(_bc(plan.corrupt, leaf),
                        torch.full((), float("nan"), dtype=leaf.dtype,
                                   device=leaf.device), leaf)
        x = torch.where(_bc(plan.blowup, leaf), leaf * fcfg.blowup_factor, x)
        if stale_leaf is not None:
            x = torch.where(_bc(plan.stale, leaf), stale_leaf.to(leaf.dtype),
                            x)
        return torch.where(_bc(plan.dropped, leaf), zero, x)

    if isinstance(tree, torch.Tensor):
        return f(tree, stale_tree)
    if isinstance(tree, ModelVars):
        st = stale_tree if stale_tree is not None else ModelVars(None, None)
        return ModelVars(perturb_tree(tree.params, plan, fcfg, st.params),
                         perturb_tree(tree.batch_stats, plan, fcfg,
                                      st.batch_stats))
    return {k: f(v, None if stale_tree is None else stale_tree[k])
            for k, v in tree.items()}
