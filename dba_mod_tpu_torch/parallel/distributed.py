"""Multi-process worlds and the elastic peer-health layer (port of
dba_mod_tpu/parallel/distributed.py).

A multi-process run is a ``torch.distributed`` process group: every rank
runs the same driver on its own device and trains its slice of the round's
clients (parallel/mesh.py); :func:`gather_clients` all-gathers the
per-client stacks, and every rank then runs the server rule on the same
full stack, so the global models stay bitwise equal across ranks without a
broadcast. :func:`initialize_distributed` reads torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``); explicit arguments win, and without either it does
nothing. The backend follows from the topology at init
(:func:`choose_backend`): NCCL when every rank on the host has a card of
its own, gloo on the CPU and when ranks share a card (NCCL refuses two
ranks on one device).

Elasticity (:class:`PeerHealth`): a collective cannot survive a peer
vanishing mid-program, so elastic rounds mean detect → classify → restart
shrunk, never in-flight recovery. Every rank writes a heartbeat file into
a shared directory every ``heartbeat_interval_s``; at round boundaries the
driver beats with the round's epoch and checks its peers (or waits at a
bounded barrier), so a lost peer is told from a slow one outside any
collective; a stall inside a collective is classified by the watchdog's
verdict at its hard deadline (exit 77, utils/run_guard.py), and an error
raised by a collective by the experiment's classifier. The supervisor then
relaunches the survivors with ``WORLD_SIZE`` shrunk and ``--resume auto``.
Heartbeats carry a membership generation (the world size unless
``DBA_ELASTIC_GEN`` says otherwise), so a shrunk world never reads the old
world's files as its own. Everything here is a no-op unless
``heartbeat_interval_s > 0`` in a multi-process run.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from dba_mod_tpu_torch.utils import telemetry

logger = logging.getLogger("dba_mod_tpu_torch")

_initialized = False


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and (
        dist.get_world_size() > 1)


def world_size() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def rank() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def choose_backend(device_type: str, local_world_size: int,
                   num_cards: int) -> Tuple[str, str]:
    """(backend, reason): NCCL when every rank on the host has a card of
    its own, gloo on the CPU and when ranks share a card."""
    if device_type != "cuda":
        return "gloo", "ranks run on the CPU"
    if local_world_size <= num_cards:
        return "nccl", (f"{local_world_size} rank(s) on this host, "
                        f"{num_cards} card(s): one card each")
    return "gloo", (f"{local_world_size} ranks share {num_cards} card(s); "
                    "NCCL refuses two ranks on one device")


def rank_device(device_type: str) -> torch.device:
    """The one device this rank drives: ``cuda:LOCAL_RANK`` (modulo the
    visible cards, when ranks share a card), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % max(
        torch.cuda.device_count(), 1))


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device_type: str = "cpu",
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group of a multi-process run. Explicit arguments
    win over torchrun's environment; without either this is a no-op
    (False). Idempotent: later calls return whether the world has more
    than one rank. `timeout_s` bounds every collective (torch's default
    when None); set it above ``watchdog_hard_s`` so the watchdog classifies
    a wedged collective before the backend gives up."""
    global _initialized
    env = os.environ
    if (init_method is None and "MASTER_ADDR" in env
            and "MASTER_PORT" in env):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None and world_size is None:
        return False
    if _initialized or dist.is_initialized():
        return is_multiprocess()
    if rank is None:
        rank = int(env.get("RANK", "0"))
    world_size = int(world_size if world_size is not None else 1)
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend, why = choose_backend(
        device_type, local_world,
        torch.cuda.device_count() if device_type == "cuda" else 0)
    kw: Dict[str, Any] = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if device_type == "cuda":        # the rank's card, whatever the backend
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=int(rank), **kw)
    _initialized = True
    logger.info("torch.distributed initialized: rank %d/%d, backend %s "
                "(%s)", dist.get_rank(), dist.get_world_size(), backend, why)
    return is_multiprocess()


def process_group_timeout_s(watchdog_hard_s: float) -> Optional[float]:
    """The collectives' timeout for a run: above the watchdog's hard limit
    (so the watchdog's verdict comes first), torch's default when the
    watchdog is off."""
    hard = float(watchdog_hard_s)
    return None if hard <= 0 else hard + max(60.0, hard)


def state_digest(model_vars) -> str:
    """sha256 over a model's state, key by key: equal digests on two ranks
    mean bitwise-equal models."""
    import hashlib
    h = hashlib.sha256()
    for part in model_vars:
        for k in sorted(part):
            h.update(k.encode())
            h.update(part[k].detach().cpu().reshape(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def barrier() -> None:
    """Every rank waits here (a no-op in a single process)."""
    if is_multiprocess():
        dist.barrier()


def gather_clients(items: Sequence[Tuple[Any, int]],
                   device: torch.device) -> List[Any]:
    """All-gather per-client stacks from every rank into the full stacks,
    in client order (rank 0's lanes first). `items`: (tree, client axis)
    pairs; every tensor of a tree has this rank's slice on that axis, and
    every rank holds the same number of lanes (the padded axis tiles the
    world). The tensors travel as the bytes of one buffer per rank, so the
    gather is exact and costs one collective. Gloo gathers host tensors,
    so a card's buffer goes through a pinned host buffer; NCCL gathers on
    the card. Returns the trees with full stacks on `device`."""
    flat = []
    for tree, axis in items:
        leaves, spec = pytree.tree_flatten(tree)
        flat.append((leaves, spec, axis))
    parts, metas = [], []
    for leaves, _, axis in flat:
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                metas.append(None)
                continue
            m = torch.movedim(t, axis, 0).contiguous()
            parts.append(m.reshape(-1).view(torch.uint8))
            metas.append((m.shape, m.dtype, m.numel() * m.element_size()))
    buf = (torch.cat(parts) if parts
           else torch.zeros((0,), dtype=torch.uint8, device=device))
    on_card = dist.get_backend() == "nccl"
    if not on_card and buf.is_cuda:
        # the copy to the host waits for the card anyway: wait first, so
        # the logged seconds are the gather's own
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    if not on_card and buf.is_cuda:
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf)
        buf = host
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, buf)
    outs = [o.to(device, non_blocking=True) for o in outs]
    logger.info("all-gather of the round's client stacks: %d bytes a rank "
                "in %.4fs", buf.numel(), time.perf_counter() - t0)
    offset, k, result = 0, 0, []
    for leaves, spec, axis in flat:
        new = []
        for t in leaves:
            meta = metas[k]
            k += 1
            if meta is None:
                new.append(t)
                continue
            shape, dtype, nbytes = meta
            rows = [o[offset:offset + nbytes].clone().view(dtype)
                    .reshape(shape)
                    for o in outs]
            offset += nbytes
            new.append(torch.movedim(torch.cat(rows, 0), 0, axis))
        result.append(pytree.tree_unflatten(new, spec))
    return result


class PeerLostError(RuntimeError):
    """A peer process is gone (heartbeat stale past the timeout), not
    slow. Raised at round boundaries (and made from collective failures by
    Experiment.run's classifier); the CLI maps it to
    ``run_guard.EXIT_PEER_LOST`` (77) so a supervisor relaunches the
    survivors shrunk instead of reporting a crash."""

    def __init__(self, lost: List[int], detail: str = ""):
        self.lost = sorted(lost)
        msg = (f"peer host(s) {self.lost} lost — heartbeat stale past the "
               f"timeout")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class PeerHealth:
    """File-based peer liveness for one multi-process run (the JAX
    package's PeerHealth, dba_mod_tpu/parallel/distributed.py:117-294).

    One instance per process. :meth:`start` writes the first heartbeat and
    starts a daemon beat thread; :meth:`beat` (also called at round
    boundaries with the boundary epoch) rewrites this rank's file
    atomically; :meth:`lost_peers` returns the ranks whose heartbeat is
    stale past ``timeout_s`` — the primitive the round boundary, the
    failure classifier and the watchdog's verdict share. :meth:`barrier`
    waits (never past its timeout) for every peer to reach a boundary
    epoch, raising :class:`PeerLostError` the moment a peer's heartbeat
    goes stale: a slow peer times it out (False: proceed, the watchdog
    owns in-collective stalls), a dead one is reported before the program
    can wedge."""

    def __init__(self, folder: str | Path, process_id: int, world_size: int,
                 interval_s: float, timeout_s: float = 0.0,
                 gen: Optional[int] = None):
        self.folder = Path(folder)
        self.process_id = int(process_id)
        self.world_size = int(world_size)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s) if timeout_s > 0 else (
            6.0 * self.interval_s)
        # membership generation: the world size unless the supervisor says
        # otherwise — a 2→1 shrink restart must not read the dead world's
        # heartbeat files as current-generation peers
        env_gen = os.environ.get("DBA_ELASTIC_GEN")
        self.gen = int(gen if gen is not None else
                       env_gen if env_gen is not None else self.world_size)
        self.boundary_epoch = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_wall: Optional[float] = None
        self._known_lost: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self.folder.mkdir(parents=True, exist_ok=True)
        self._started_wall = time.time()
        self._stop.clear()
        self.beat()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="dba-heartbeat")
            self._thread.start()
        logger.info("peer health: process %d/%d gen=%d beating every %.2fs "
                    "into %s (timeout %.2fs)", self.process_id,
                    self.world_size, self.gen, self.interval_s, self.folder,
                    self.timeout_s)

    def stop(self) -> None:
        """Clean shutdown: a final beat marked ``stopped``, so peers
        draining at another instant do not read it as a loss."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.interval_s))
        if self._started_wall is not None:
            try:
                self.beat(stopped=True)
            except OSError:  # pragma: no cover — fs went away at teardown
                pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError as exc:  # pragma: no cover — transient fs error
                logger.warning("peer health: heartbeat write failed (%r)",
                               exc)

    # ------------------------------------------------------------------ beat
    def _path(self, pid: int) -> Path:
        return self.folder / f"host_{pid}.json"

    def beat(self, boundary_epoch: Optional[int] = None,
             stopped: bool = False) -> None:
        # the whole write-then-rename stays under the lock: the beat thread
        # and the main thread's boundary beat share one tmp path, and a torn
        # tmp renamed into place would read as a missing peer
        with self._lock:
            if boundary_epoch is not None:
                self.boundary_epoch = int(boundary_epoch)
            payload = {"pid": self.process_id, "gen": self.gen,
                       "time": time.time(),
                       "boundary_epoch": self.boundary_epoch,
                       "ospid": os.getpid(), "stopped": bool(stopped)}
            path = self._path(self.process_id)
            tmp = path.with_suffix(f".tmp{self.process_id}")
            tmp.write_text(json.dumps(payload))
            tmp.replace(path)  # atomic: peers never read a torn heartbeat

    def _read(self, pid: int) -> Optional[Dict]:
        try:
            d = json.loads(self._path(pid).read_text())
        except (OSError, ValueError):
            return None
        return d if d.get("gen") == self.gen else None

    # ------------------------------------------------------------ liveness
    @property
    def peer_ids(self) -> List[int]:
        return [p for p in range(self.world_size) if p != self.process_id]

    def lost_peers(self, now: Optional[float] = None) -> List[int]:
        """Peer ids whose heartbeat is stale past ``timeout_s``. A peer
        with no current-generation file is lost only after the startup
        grace window (3 × timeout from :meth:`start`); a peer whose final
        beat is marked ``stopped`` exited cleanly and is never reported."""
        if self._started_wall is None:
            return []
        now = time.time() if now is None else now
        in_grace = (now - self._started_wall) < 3.0 * self.timeout_s
        lost = []
        for pid in self.peer_ids:
            d = self._read(pid)
            if d is None:
                if not in_grace:
                    lost.append(pid)
                continue
            if d.get("stopped"):
                continue
            if now - float(d["time"]) > self.timeout_s:
                lost.append(pid)
        new = set(lost) - self._known_lost
        if new:
            self._known_lost |= new
            telemetry.count("peer/heartbeat_missed", len(new))
            logger.error(
                "peer health: heartbeat from peer(s) %s stale past %.2fs — "
                "peer lost (slow peers keep beating; a silent one is gone)",
                sorted(new), self.timeout_s)
        return lost

    def check(self, epoch: int) -> None:
        """Non-blocking round-boundary check: beat with the boundary epoch,
        then raise :class:`PeerLostError` if any peer's heartbeat is
        stale (one file write and one directory read)."""
        self.beat(boundary_epoch=epoch)
        lost = self.lost_peers()
        if lost:
            raise PeerLostError(lost, detail=f"epoch {epoch} boundary")

    def barrier(self, epoch: int, timeout: float) -> bool:
        """Bounded boundary barrier: True when every peer reported a
        boundary epoch >= ``epoch`` within ``timeout`` seconds, False on
        timeout (a slow peer: proceed). Raises :class:`PeerLostError` if a
        peer dies while we wait."""
        self.beat(boundary_epoch=epoch)
        deadline = time.monotonic() + float(timeout)
        poll = max(min(self.interval_s / 2.0, 0.25), 0.02)
        while True:
            lost = self.lost_peers()
            if lost:
                raise PeerLostError(lost, detail=f"epoch {epoch} barrier")
            behind = []
            for pid in self.peer_ids:
                d = self._read(pid)
                if d is None or int(d.get("boundary_epoch", 0)) < epoch:
                    behind.append(pid)
            if not behind:
                return True
            if time.monotonic() >= deadline:
                logger.warning(
                    "peer health: barrier for epoch %d timed out after "
                    "%.2fs waiting on peer(s) %s — peers are slow, not "
                    "gone; proceeding", epoch, timeout, behind)
                return False
            time.sleep(poll)
