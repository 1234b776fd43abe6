"""Deterministic fault injection for the round path (port of
dba_mod_tpu/fl/faults.py).

Faults perturb what the server RECEIVES from each client in a round, never
the local training: they model the uplink. Per client and round, mutually
exclusive, resolved in the order host-loss > dropout > corrupt > blowup >
stale:

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

Host-level lane (``fault_host_loss_prob``): a whole host vanishes at a
round boundary, the failure the elastic layer (parallel/distributed.py)
exists to survive. The victim is a pure function of the round's fault
stream (:func:`host_loss_victim`), so both enactments agree on who dies
and when: in a multi-process run the victim rank SIGKILLs itself at the
boundary (fl/experiment.py) and the survivors take the detect → exit 77 →
shrunk relaunch path; in a single process (``fault_num_hosts`` virtual
hosts) the victim host's contiguous client slice is dropped through the
survivor mask.

The plan is a pure function of ``(fault_seed, epoch)``: a
``torch.Generator`` seeded from both draws it on the CPU, so a fault
schedule reproduces across runs, retries and devices, and is independent of
every other random stream. jax.random draws other numbers, so the JAX
package's plan for the same seed differs; tests hand one plan to both.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from dba_mod_tpu_torch import config as cfg
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops.aggregation import _bc_mask as _bc
from dba_mod_tpu_torch.utils.device import to_device

logger = logging.getLogger("dba_mod_tpu_torch")


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
    # host-level lane: P(the round loses one whole host) and the host count
    # the client axis is partitioned into. `host_loss_in_program` is the
    # enactment switch: True (one process) masks the victim's client slice
    # inside the round; False (several processes) leaves the round alone
    # and the experiment kills the victim rank at the boundary instead
    host_loss_prob: float = 0.0
    num_hosts: int = 0
    host_loss_in_program: bool = True

    @property
    def stale_enabled(self) -> bool:
        return self.enabled and self.stale_prob > 0.0

    @property
    def host_loss_enabled(self) -> bool:
        return self.enabled and self.host_loss_prob > 0.0

    @classmethod
    def from_params(cls, p: cfg.Params) -> "FaultConfig":
        from dba_mod_tpu_torch.parallel.distributed import world_size
        probs = {k: float(p.get(f"fault_{k}_prob", 0.0))
                 for k in ("dropout", "corrupt", "blowup", "stale",
                           "host_loss")}
        for k, v in probs.items():
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault_{k}_prob={v} not in [0, 1]")
        enabled = bool(p.get("fault_injection", False))
        ws = world_size()
        if ws > 1:
            # real hosts: the experiment kills the victim rank at the round
            # boundary; the round sees only the consequences
            num_hosts, in_program = ws, False
        else:
            num_hosts, in_program = int(p.get("fault_num_hosts", 0)), True
            if enabled and probs["host_loss"] > 0.0 and num_hosts < 2:
                # not an error: a 2-rank run with the lane on loses its
                # victim by design, and the supervisor relaunches ONE
                # process with the same YAML, which must start. A single
                # process simulates host loss only with fault_num_hosts >= 2
                logger.warning(
                    "fault_host_loss_prob=%s ignored: single-process run "
                    "with fault_num_hosts=%d — set fault_num_hosts >= 2 "
                    "to simulate host loss through the survivor mask "
                    "(a shrunk-to-1 elastic relaunch lands here by "
                    "design and must start)", probs["host_loss"],
                    num_hosts)
                probs["host_loss"] = 0.0
        return cls(enabled=enabled,
                   dropout_prob=probs["dropout"],
                   corrupt_prob=probs["corrupt"],
                   blowup_prob=probs["blowup"],
                   blowup_factor=float(p.get("fault_blowup_factor", 1e8)),
                   stale_prob=probs["stale"],
                   seed=int(p.get("fault_seed", 0)),
                   host_loss_prob=probs["host_loss"],
                   num_hosts=num_hosts,
                   host_loss_in_program=in_program)


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


# tag isolating the host-loss stream from the per-client draws: turning the
# host lane on must not reshuffle the client lanes an existing fault_seed
# gives (and the other way round)
_HOST_LANE_TAG = 0x4057


def host_loss_victim(fcfg: FaultConfig, gen: torch.Generator) -> int:
    """The host the round loses, or -1 for none. Drawn from a stream of its
    own, keyed by the round's fault generator's seed and consuming nothing
    of it, so the experiment (the multi-process boundary kill) and the
    round (the single-process survivor mask) derive the same victim."""
    key = np.random.SeedSequence(
        [int(gen.initial_seed()), _HOST_LANE_TAG]).generate_state(
            1, np.uint64)[0]
    hg = torch.Generator().manual_seed(int(key))
    lost = float(torch.rand((), generator=hg)) < fcfg.host_loss_prob
    v = int(torch.randint(0, max(fcfg.num_hosts, 1), (), generator=hg))
    return v if lost else -1


def host_of_lane(num_lanes: int, num_hosts: int) -> torch.Tensor:
    """[C] host index per client lane: contiguous proportional slices, the
    partition parallel/mesh.py hands each rank of a multi-process run."""
    return (torch.arange(num_lanes) * num_hosts) // max(num_lanes, 1)


def make_fault_plan(fcfg: FaultConfig, gen: torch.Generator,
                    counted: torch.Tensor) -> FaultPlan:
    """Draw one round's fault assignment on the CPU. ``counted`` ([C] bool)
    marks real clients; a lane that is not counted (mesh padding) never
    faults. The host-loss lane resolves first (a vanished host's clients
    cannot corrupt or straggle on their own) and folds into ``dropped``."""
    counted = counted.cpu()
    u = torch.rand((4, counted.shape[0]), generator=gen)
    free = counted
    host_dropped = torch.zeros_like(counted)
    if fcfg.host_loss_enabled and fcfg.host_loss_in_program:
        victim = host_loss_victim(fcfg, gen)
        hosts = host_of_lane(counted.shape[0], fcfg.num_hosts)
        host_dropped = (hosts == victim) & counted
        free = free & ~host_dropped
    hits = []
    for row, p in zip(u, (fcfg.dropout_prob, fcfg.corrupt_prob,
                          fcfg.blowup_prob, fcfg.stale_prob)):
        hit = (row < p) & free
        free = free & ~hit
        hits.append(hit)
    hits[0] = hits[0] | host_dropped
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
