"""The clients mesh (port of dba_mod_tpu/parallel/mesh.py).

A :class:`ClientsMesh` is the ordered list of torch devices this process
drives, with the process's rank and the world's size. The round's stacked
client axis is padded to a multiple of the mesh's shard count (every
device of every rank) and cut into contiguous, proportional slices: shard
``k`` of ``n`` owns the lanes ``c`` with ``c * n // C == k``, the partition
the host-loss fault lane uses too (fl/faults.py::host_of_lane), so a rank's
slice is the union of its devices' slices. A mesh may repeat a device
(``cpu, cpu`` in the tests, ``cuda:0, cuda:0`` on one card): the shards
then run one after the other on it, which is how the sharded path is held
to the unsharded one without a second card.

The JAX package expresses the same layout as GSPMD shardings; here the
round engine (fl/rounds.py) walks the shards itself, driving each distinct
card from a thread of its own with that card current, so the cards train
at once, and gathers the per-client stacks with
:func:`dba_mod_tpu_torch.parallel.distributed.gather_clients`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from dba_mod_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class ClientsMesh:
    """The devices this process drives, in shard order, with its rank and
    the world's size (1 for a single process)."""
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """Shards in the world: every device of every rank."""
        return len(self.devices) * self.world_size

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(num_devices: int = 0, devices: Optional[Sequence] = None,
              device: str | torch.device = "cuda", rank: int = 0,
              world_size: int = 1) -> Optional[ClientsMesh]:
    """The clients mesh of one process (experiment.py:292-297's rule):
    `devices` given → that list (it may repeat a device); in a world of
    more than one rank → the rank's one `device` (``num_devices`` must be
    0, -1 or the world size); else 0 or 1 → no mesh (as the JAX package
    reads them), -1 → every visible card, n → the first n cards, raising
    when fewer are visible. The CPU is one device: -1 gives a mesh of one
    shard, n > 1 raises."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh: an empty device list")
        return ClientsMesh(devs, rank, world_size)
    nd = int(num_devices)
    dev = torch.device(device)
    if world_size > 1:
        if nd not in (0, -1, world_size):
            raise ValueError(
                f"num_devices: {nd} in a world of {world_size} ranks: each "
                "rank drives one device, so set -1 (or the world size)")
        return ClientsMesh((dev,), rank, world_size)
    if nd in (0, 1):
        return None
    if dev.type == "cpu":
        if nd > 1:
            raise ValueError(
                f"num_devices: {nd} on the CPU: the CPU is one device "
                "(pass an explicit device list to shard over it)")
        return ClientsMesh((dev,))
    visible = torch.cuda.device_count()
    want = visible if nd == -1 else nd
    if want < 1 or visible < want:
        raise ValueError(f"num_devices: {nd} needs {want} cards, "
                         f"{visible} visible")
    return ClientsMesh(tuple(torch.device("cuda", i) for i in range(want)))


def slice_bounds(num_clients: int, num_parts: int,
                 part: int) -> Tuple[int, int]:
    """[lo, hi) of part `part` of `num_parts` contiguous proportional
    slices of [0, num_clients): the lanes c with c * num_parts //
    num_clients == part (fl/faults.py::host_of_lane). Holds for counts the
    parts do not divide (a shrunk world); a part may be empty."""
    c, n = int(num_clients), max(int(num_parts), 1)
    return (-(-part * c // n), -(-(part + 1) * c // n))


def local_slice_bounds(mesh: ClientsMesh, num_clients: int
                       ) -> Tuple[int, int]:
    """[lo, hi) of the clients axis this process owns: the union of its
    devices' shards."""
    d = len(mesh.devices)
    lo = slice_bounds(num_clients, mesh.size, mesh.rank * d)[0]
    hi = slice_bounds(num_clients, mesh.size, mesh.rank * d + d - 1)[1]
    return lo, hi


def shard_bounds(mesh: ClientsMesh, num_clients: int
                 ) -> List[Tuple[int, int]]:
    """[lo, hi) of each of this process's shards, in device order."""
    d = len(mesh.devices)
    return [slice_bounds(num_clients, mesh.size, mesh.rank * d + k)
            for k in range(d)]


class RoundShard(NamedTuple):
    """One shard's cut of a round's inputs: its device and lanes, the
    segment stacks on the device, the host plans' active-step masks and
    the host task rows. (The server rule runs on the gathered stack, so
    the sample counts stay whole.)"""
    device: torch.device
    lo: int
    hi: int
    tasks_seq: List[Any]          # one host ClientTask per segment
    idx_seq: List[torch.Tensor]   # per segment [c, E, S, B] on `device`
    mask_seq: List[torch.Tensor]
    active_seq: List[np.ndarray]  # per segment [E, S] host bool


def shard_round_inputs(mesh: ClientsMesh, tasks_seq: List[Any],
                       idx_seq: np.ndarray, mask_seq: np.ndarray
                       ) -> List[RoundShard]:
    """Cut one round's segment-stacked host inputs ([I, C, ...] plans, one
    ClientTask per segment) into this process's shards, the plans copied
    to the shard's device with the pinned non-blocking copy of
    utils/device.py:to_device."""
    out = []
    for dev, (lo, hi) in zip(mesh.devices,
                             shard_bounds(mesh, idx_seq.shape[1])):
        idx = np.ascontiguousarray(idx_seq[:, lo:hi])
        mask = np.ascontiguousarray(mask_seq[:, lo:hi])
        out.append(RoundShard(
            dev, lo, hi,
            [type(t)(*(np.asarray(f)[lo:hi] for f in t)) for t in tasks_seq],
            [to_device(i, dev) for i in idx], [to_device(m, dev) for m in mask],
            [m.any(axis=(0, 3)) for m in mask]))
    return out


def replicate_for_mesh(mesh: ClientsMesh, tree: Any) -> dict:
    """{device: a copy of `tree` on it} for each distinct device of the
    mesh (the tree itself where it already lies there)."""
    def put(d):
        return pytree.tree_map(
            lambda t: t.to(d) if isinstance(t, torch.Tensor)
            and t.device != d else t, tree)
    return {d: put(d) for d in mesh.distinct_devices()}


def pad_clients(n_clients: int, mesh: Optional[ClientsMesh]) -> int:
    """Smallest padded client count that tiles the mesh. An elastic
    relaunch pads for its own (smaller) world from scratch."""
    if mesh is None:
        return n_clients
    d = mesh.size
    return int(-(-n_clients // d) * d)
