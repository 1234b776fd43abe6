"""Fused per-step state update: torch-SGD + validity select + FoolsGold
accumulation + BN select, as ONE kernel launch over the whole stacked client
state.

Counterpart of ``dba_mod_tpu/ops/fused_update.py``. Every local step of the
client loop (fl/client.py) ends in one call of :func:`fused_step_update` over
all C clients' leaves:

    g'  = g + weight_decay * w
    m'  = momentum * m + g'
    w'  = w - lr[c] * m'                   (per-client lr)
    out = where(valid[c], new, old)        for w, m, fg (+= g), bn (new)

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_update.cu`` (built at first use, see utils/cuda_build.py); it
updates w, m, fg and bn_old IN PLACE, where the JAX op is functional — the
port saves writing a second copy of the client state every step. On a CPU
tensor the wrapper runs the plain PyTorch version in place
(:func:`plain_update_`, bitwise the functional
:func:`fused_step_update_reference` the kernel is held to). There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]

_SOURCE = "fused_update.cu"
_MAX_LEAVES = 120        # csrc/fused_update.cu kMaxLeaves
_MAX_PTRS = 336          # csrc/fused_update.cu kMaxPtrs
_TILE = 4096             # csrc/fused_update.cu kTile
_KIND = {"sgd": 0, "sgd_acc": 1, "sel": 2}

_lib = None
_Table = None
_count_lock = threading.Lock()


# ---------------------------------------------------------------- plain version
def plain_update_(lr: torch.Tensor, valid: torch.Tensor, params: Tree,
                  grads: Tree, mom: Tree, fg: Tree, bn_new: Tree,
                  bn_old: Tree, *, momentum: float,
                  weight_decay: float) -> None:
    """The wrapper's CPU path: :func:`fused_step_update_reference` in
    place, the same order of operations, each product its own op, so every
    row is bitwise what the functional form computes
    (tests/test_torch_fused_update.py holds the two equal). The rows of
    clients that are not valid are saved before and written back after
    (nothing is done when none is valid). Updates params, mom, fg and
    bn_old; `fg` empty = FoolsGold off."""
    keep = valid != 0
    if not bool(keep.any()):
        return
    drop = None if bool(keep.all()) else ~keep

    def in_place(tensors, update):
        saved = ([t[drop].clone() for t in tensors] if drop is not None
                 else [])
        update()
        for t, old in zip(tensors, saved):
            t[drop] = old

    for k, w in params.items():
        g, m = grads[k], mom[k]
        lr_c = lr.reshape((lr.shape[0],) + (1,) * (w.dim() - 1))

        def step(w=w, g=g, m=m, lr_c=lr_c):
            g2 = g + weight_decay * w
            m.mul_(momentum).add_(g2)
            w.sub_(lr_c * m)
        in_place((w, m), step)
    for k, f in fg.items():
        in_place((f,), lambda f=f, g=grads[k]: f.add_(g))
    for k, b in bn_old.items():
        in_place((b,), lambda b=b, n=bn_new[k]: b.copy_(n))


def fused_step_update_reference(lr: torch.Tensor, valid: torch.Tensor,
                                params: Tree, grads: Tree, mom: Tree,
                                fg: Tree, bn_new: Tree, bn_old: Tree, *,
                                momentum: float, weight_decay: float
                                ) -> Tuple[Dict, Dict, Dict, Dict]:
    """The JAX ``reference`` (dba_mod_tpu/ops/fused_update.py:166-179) in
    torch ops, functional, same order of operations, each product its own
    op: the yardstick the kernel is held to and timed against. Returns
    (new_params, new_mom, new_fg, new_bn); `fg` empty = FoolsGold off.
    :func:`plain_update_` computes the same values in place."""
    keep0 = valid != 0

    def per_client(v, like):
        return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))

    new_p, new_m, new_f, new_b = {}, {}, {}, {}
    for k, w in params.items():
        g, m = grads[k], mom[k]
        keep = per_client(keep0, w)
        g2 = g + weight_decay * w
        m2 = momentum * m + g2
        w2 = w - per_client(lr, w) * m2
        new_p[k] = torch.where(keep, w2, w)
        new_m[k] = torch.where(keep, m2, m)
    for k, f in fg.items():
        new_f[k] = torch.where(per_client(keep0, f), f + grads[k], f)
    for k, b in bn_old.items():
        new_b[k] = torch.where(per_client(keep0, b), bn_new[k], b)
    return new_p, new_m, new_f, new_b


# ---------------------------------------------------------------- the kernel
def _load():
    """Build + load the kernel library and define the ctypes mirror of its
    by-value leaf table (at first CUDA use, never at import)."""
    global _lib, _Table
    if _lib is not None:
        return _lib
    from dba_mod_tpu_torch.utils.cuda_build import load_library
    lib = load_library(_SOURCE)
    vp = ctypes.c_void_p

    class LeafTable(ctypes.Structure):
        _fields_ = [("ptr", vp * _MAX_PTRS),
                    ("n", ctypes.c_int * _MAX_LEAVES),
                    ("tile_start", ctypes.c_int * (_MAX_LEAVES + 1)),
                    ("first", ctypes.c_ushort * _MAX_LEAVES),
                    ("kind", ctypes.c_ubyte * _MAX_LEAVES),
                    ("num_leaves", ctypes.c_int)]

    for fn in ("fused_update_max_leaves", "fused_update_max_ptrs",
               "fused_update_tile", "fused_update_table_bytes"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = []
    if (lib.fused_update_max_leaves() != _MAX_LEAVES
            or lib.fused_update_max_ptrs() != _MAX_PTRS
            or lib.fused_update_tile() != _TILE
            or lib.fused_update_table_bytes() != ctypes.sizeof(LeafTable)):
        raise RuntimeError("csrc/fused_update.cu and ops/fused_update.py "
                           "disagree on the leaf-table layout")
    lib.fused_step_update_launch.restype = ctypes.c_int
    lib.fused_step_update_launch.argtypes = [
        vp, vp, vp, ctypes.c_int, ctypes.c_float, ctypes.c_float, vp]
    _Table = LeafTable
    _lib = lib
    return lib


def _chunks(entries) -> list:
    """Split entries [(kind, tensors)] into runs that fit one leaf table:
    at most _MAX_LEAVES leaves and _MAX_PTRS pointers each. The CIFAR and
    Tiny-ImageNet ResNet-18 states fit one table: 62 sgd + 40 sel leaves
    (266 pointers), or 62 sgd_acc + 40 sel leaves (328 pointers) with
    FoolsGold on; LoanNet's is 6 sgd leaves."""
    chunks, cur, nptr = [], [], 0
    for e in entries:
        if cur and (len(cur) == _MAX_LEAVES or nptr + len(e[1]) > _MAX_PTRS):
            chunks.append(cur)
            cur, nptr = [], 0
        cur.append(e)
        nptr += len(e[1])
    if cur:
        chunks.append(cur)
    return chunks


_INT_MAX = 2 ** 31 - 1


def _layout(sizes, C) -> list:
    """Per-client element counts of one table's leaves -> the tiles'
    prefix sums (the kernel's tile_start, one launch of tile_start[-1]
    blocks). The kernel indexes with 32-bit ints: a leaf's per-client count
    plus one tile, and the grid's block count, must fit; client * n is
    taken in size_t. At the full Tiny-ImageNet ResNet-18 (2,359,296
    elements per client in its largest leaf, about 28.5 k tiles at C = 10)
    that leaves three orders of magnitude of headroom."""
    starts, tiles = [], 0
    for n in sizes:
        if n + _TILE > _INT_MAX:
            raise ValueError(f"fused_step_update: a leaf of {n} elements "
                             f"per client overflows the kernel's int32 "
                             f"indices")
        starts.append(tiles)
        tiles += C * -(-n // _TILE)
    if tiles > _INT_MAX:
        raise ValueError(f"fused_step_update: {tiles} tiles exceed one "
                         f"launch's grid")
    return starts + [tiles]


def _tables(entries, C) -> list:
    """entries: [(kind, tensors)] of [C, ...] tensors, in the order the
    kernel reads them (sgd: w, g, m; sgd_acc: w, g, m, fg; sel: bn_old,
    bn_new) -> the kernel's leaf tables, one launch each."""
    _load()
    tables = []
    for chunk in _chunks(entries):
        t = _Table()
        sizes = [ts[0].numel() // C for _, ts in chunk]
        starts = _layout(sizes, C)
        nptr = 0
        for i, ((kind, ts), n) in enumerate(zip(chunk, sizes)):
            t.first[i] = nptr
            for x in ts:
                t.ptr[nptr] = x.data_ptr()
                nptr += 1
            t.n[i] = n
            t.kind[i] = _KIND[kind]
            t.tile_start[i] = starts[i]
        t.tile_start[len(chunk)] = starts[-1]
        t.num_leaves = len(chunk)
        tables.append(t)
    return tables


def _launch(tables, lr, valid, C, momentum, weight_decay) -> None:
    """One kernel launch per table, on the tensors' card's current stream,
    with that card made current for the launch (a stream of one card
    cannot take a launch made while another card is current)."""
    with torch.cuda.device(lr.device):
        stream = torch.cuda.current_stream(lr.device).cuda_stream
        for t in tables:
            err = _lib.fused_step_update_launch(
                ctypes.byref(t), lr.data_ptr(), valid.data_ptr(), C,
                float(momentum), float(weight_decay), stream)
            if err != 0:
                raise RuntimeError(f"fused_step_update launch failed: "
                                   f"CUDA error {err}")
            with _count_lock:       # a mesh drives its cards from threads
                fused_step_update.launches += 1


def _check(lr, valid, groups) -> int:
    if lr.dim() != 1 or valid.shape != lr.shape:
        raise ValueError(f"lr and valid must both be [C]; got "
                         f"{tuple(lr.shape)} and {tuple(valid.shape)}")
    C = lr.shape[0]
    dev = lr.device
    for name, ts in groups:
        for t in ts:
            if t.device != dev:
                raise ValueError(f"{name}: tensor on {t.device}, lr on {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: dtype {t.dtype}, need float32")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensor is not contiguous")
            if t.dim() < 1 or t.shape[0] != C:
                raise ValueError(f"{name}: leading dim of {tuple(t.shape)} "
                                 f"is not the client count {C}")
    return C


def _validated(lr, valid, params, grads, mom, fg, bn_new, bn_old):
    """Checks the trees and pairs their leaves by key, never by position.
    Returns (C, params, grads, mom, fg, bn_new, bn_old) as lists."""
    if set(grads) != set(params) or set(mom) != set(params) or (
            fg and set(fg) != set(params)) or set(bn_new) != set(bn_old):
        raise ValueError("fused_step_update: the trees' keys differ")
    pl = list(params.values())
    gl, ml = [grads[k] for k in params], [mom[k] for k in params]
    fl = [fg[k] for k in params] if fg else []
    bol = list(bn_old.values())
    bnl = [bn_new[k] for k in bn_old]
    C = _check(lr, valid, [("lr", [lr]), ("valid", [valid]), ("params", pl),
                           ("grads", gl), ("mom", ml), ("fg", fl),
                           ("bn_new", bnl), ("bn_old", bol)])
    for a, b in list(zip(pl, gl)) + list(zip(pl, ml)) + list(zip(fl, pl)) + \
            list(zip(bnl, bol)):
        if a.shape != b.shape:
            raise ValueError(f"fused_step_update: shape {tuple(a.shape)} "
                             f"vs {tuple(b.shape)}")
    return C, pl, gl, ml, fl, bnl, bol


def prepare_launch(lr: torch.Tensor, valid: torch.Tensor, params: Tree,
                   grads: Tree, mom: Tree, fg: Tree, bn_new: Tree,
                   bn_old: Tree, *, momentum: float,
                   weight_decay: float) -> Callable[[], None]:
    """The wrapper's host work on CUDA tensors (checks, leaf tables), done
    once: the returned function launches the kernel over the same tensors.
    fused_step_update is prepare_launch(...)(); the split lets the kernel's
    device time be measured apart from the wrapper's host time."""
    if lr.device.type != "cuda":
        raise ValueError(f"prepare_launch: tensors on {lr.device}, the "
                         f"kernel needs CUDA tensors")
    # The config keys fused_updates / fused_interpret are not read here:
    # on the card the kernel is the only update path, and interpret mode is
    # a Pallas notion with no CUDA counterpart.
    C, pl, gl, ml, fl, bnl, bol = _validated(lr, valid, params, grads, mom,
                                             fg, bn_new, bn_old)
    if fl:
        entries = [("sgd_acc", (w, g, m, f))
                   for w, g, m, f in zip(pl, gl, ml, fl)]
    else:
        entries = [("sgd", (w, g, m)) for w, g, m in zip(pl, gl, ml)]
    entries += [("sel", (bo, bn)) for bn, bo in zip(bnl, bol)]
    tables = _tables(entries, C)
    return lambda: _launch(tables, lr, valid, C, momentum, weight_decay)


def fused_step_update(lr: torch.Tensor, valid: torch.Tensor, params: Tree,
                      grads: Tree, mom: Tree, fg: Tree, bn_new: Tree,
                      bn_old: Tree, *, momentum: float,
                      weight_decay: float) -> None:
    """Apply one step's state update to every client IN PLACE.

    lr, valid: float32 [C] (valid is 1.0 / 0.0). params/grads/mom: same-keyed
    dicts of [C, ...] float32 leaves; fg: the FoolsGold accumulators or an
    empty dict; bn_new/bn_old: the BN running stats (empty for a model
    without BN). params, mom, fg and bn_old are updated in place."""
    if lr.device.type == "cuda":
        prepare_launch(lr, valid, params, grads, mom, fg, bn_new, bn_old,
                       momentum=momentum, weight_decay=weight_decay)()
        return
    if lr.device.type != "cpu":
        raise ValueError(f"fused_step_update: unsupported device {lr.device}")
    _validated(lr, valid, params, grads, mom, fg, bn_new, bn_old)
    plain_update_(lr, valid, params, grads, mom, fg, bn_new, bn_old,
                  momentum=momentum, weight_decay=weight_decay)


fused_step_update.launches = 0
