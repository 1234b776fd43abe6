"""Server aggregation rules over stacked client updates (port of
dba_mod_tpu/ops/aggregation.py).

A tree is a flat dict of tensors; a stacked tree has a leading clients axis
[C, ...]. The round engine hands a rule the full state (parameters and BN
running stats in one dict, their keys are disjoint) or the parameters alone
(FoolsGold). The rules:

- FedAvg (`average_shrink_models`, helper.py:240-257): global += η/no_models ·
  Σ_c Δ_c over every state entry, with optional DP Gaussian noise
  (helper.py:186-191, :253-254). The divisor is the static `no_models`, not
  Σ samples — unweighted, kept for parity.
- RFA geometric median (helper.py:295-373): Weiszfeld iterations with
  sample-count alphas, the ftol stop, the oracle-call count and the
  optional update-norm reject.
- FoolsGold (helper.py:259-293, class FoolsGold :527-607): cosine-similarity
  reweighting of the similarity layer's accumulated gradient, id-keyed
  memory, pardoning and the logit, applied through one torch-SGD step on
  the parameters only.
- Krum / multi-Krum, the coordinate-wise trimmed mean and the
  coordinate-wise median (no reference counterpart; the JAX package's wider
  defense grid).

Every rule takes a survivor `mask` ([C]) from the server's quarantine pass
(fl/rounds.py). Excluded rows are where-zeroed first (`survivor_sanitize`):
exclusion selects and never multiplies, since 0 · NaN = NaN. With an
all-ones mask the masked FedAvg is bitwise the dense rule. DP noise is
either an explicit `noise` tree (tests pass the JAX package's draw in) or
drawn from a `torch.Generator`; jax.random and torch draw different
numbers. Everything here is ordinary PyTorch ops: no Pallas kernel of the
JAX package computes any of it. The two matmuls (Weiszfeld's weighted
average, Krum's Gram matrix) must run in full float32 on the card, as the
JAX reference does: the entry points call utils/device.pin_float32_math.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from dba_mod_tpu_torch.ops.sgd import sgd_step

Tree = Mapping[str, torch.Tensor]


# ------------------------------------------------------------------- utilities
def flatten_stacked(tree: Tree) -> torch.Tensor:
    """A stacked tree ([C, ...] leaves) as one [C, P] float32 matrix, in the
    tree's own key order (the JAX package's follows the flax tree order, so
    the columns are permuted between the two)."""
    return torch.cat([v.reshape(v.shape[0], -1).to(torch.float32)
                      for v in tree.values()], dim=1)


def unflatten_like(vec: torch.Tensor, tree: Tree) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_stacked` for one [P] vector, shaped like one
    (un-stacked) element of `tree`."""
    out, off = {}, 0
    for k, v in tree.items():
        shape = v.shape[1:]
        size = math.prod(shape)
        out[k] = vec[off:off + size].reshape(shape).to(v.dtype)
        off += size
    return out


def _bc_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """[C] → [C, 1, ...] against a client-stacked leaf."""
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


def survivor_sanitize(tree: Tree, mask: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Where-zero the masked-out clients' rows of a stacked payload. With an
    all-ones mask the values come back bitwise unchanged."""
    keep = mask > 0
    return {k: torch.where(_bc_mask(keep, v), v, torch.zeros((), dtype=v.dtype,
                                                              device=v.device))
            for k, v in tree.items()}


def dp_noise_like(gen: torch.Generator, tree: Tree,
                  sigma: float) -> Dict[str, torch.Tensor]:
    """Gaussian DP noise per state entry (helper.py:186-191), drawn from an
    explicit generator on the tree's device."""
    return {k: torch.randn(v.shape, generator=gen, dtype=torch.float32,
                           device=v.device) * sigma
            for k, v in tree.items()}


def _noised(tree: Dict[str, torch.Tensor], dp_sigma: float,
            noise: Optional[Tree], gen: Optional[torch.Generator]
            ) -> Dict[str, torch.Tensor]:
    """`tree` + DP noise when `dp_sigma` is set: `noise` if given, else a
    draw from `gen`."""
    if not dp_sigma:
        return tree
    if noise is None:
        if gen is None:
            raise ValueError("DP noise needs `noise` or a generator")
        noise = dp_noise_like(gen, tree, dp_sigma)
    return {k: s + noise[k].to(s.dtype) for k, s in tree.items()}


def _ones_mask(tree: Tree) -> torch.Tensor:
    leaf = next(iter(tree.values()))
    return torch.ones((leaf.shape[0],), dtype=torch.float32,
                      device=leaf.device)


# --------------------------------------------------------------------- FedAvg
def fedavg_update(global_state: Tree, stacked_deltas: Tree, eta: float,
                  no_models: int, dp_sigma: float = 0.0,
                  noise: Optional[Tree] = None,
                  gen: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """`global_state`: one flat dict of state entries; `stacked_deltas`: the
    same keys with a leading clients axis."""
    scale = eta / no_models
    new_state = {k: g + scale * torch.sum(stacked_deltas[k], dim=0)
                 for k, g in global_state.items()}
    return _noised(new_state, dp_sigma, noise, gen)


def fedavg_update_masked(global_state: Tree, stacked_deltas: Tree,
                         eta: float, no_models: int, mask: torch.Tensor,
                         counted: torch.Tensor, dp_sigma: float = 0.0,
                         noise: Optional[Tree] = None,
                         gen: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
    """FedAvg renormalized over the survivor mask: the divisor drops one for
    every *counted* client the mask excludes. The scale is
    `(eta/no_models) · (no_models/divisor)`, so an all-ones mask gives the
    dense rule's float32 scale exactly — bitwise the dense result."""
    deltas = survivor_sanitize(stacked_deltas, mask)
    excluded = torch.sum((counted > 0) & ~(mask > 0))
    # scalars made by fills: a host→device copy would block the host
    nm = torch.full((), float(no_models), dtype=torch.float32,
                    device=mask.device)
    divisor = torch.clamp(nm - excluded, min=1.0)
    scale = torch.full((), eta / no_models, dtype=torch.float32,
                       device=mask.device) * (nm / divisor)
    new_state = {k: g + scale * torch.sum(deltas[k], dim=0)
                 for k, g in global_state.items()}
    return _noised(new_state, dp_sigma, noise, gen)


# ------------------------------------------------------------- RFA / Weiszfeld
class RfaResult(NamedTuple):
    new_state: Dict[str, torch.Tensor]
    num_oracle_calls: torch.Tensor   # int32
    is_updated: torch.Tensor         # bool (norm rejection)
    wv: torch.Tensor                 # [C] final Weiszfeld weights
    distances: torch.Tensor          # [C] ‖median - Δ_c‖
    nbt_median: torch.Tensor         # the `num_batches_tracked` entry


def geometric_median_update(global_state: Tree, stacked_deltas: Tree,
                            num_samples: torch.Tensor, eta: float,
                            maxiter: int = 10, eps: float = 1e-5,
                            ftol: float = 1e-6,
                            max_update_norm: Optional[float] = None,
                            dp_sigma: float = 0.0,
                            noise: Optional[Tree] = None,
                            gen: Optional[torch.Generator] = None,
                            nbt_deltas: Optional[torch.Tensor] = None,
                            n_bn: int = 0,
                            mask: Optional[torch.Tensor] = None
                            ) -> RfaResult:
    """Weiszfeld geometric median of the client deltas (helper.py:295-373).

    All `maxiter` iterations run under a `done` mask that stands for the
    reference's ftol break, as in the JAX version, so the oracle count
    agrees and no iteration waits on the host. `nbt_deltas` [C] / `n_bn`:
    the per-client `num_batches_tracked` deltas and the number of BN layers;
    the counters enter every Weiszfeld distance (helper.py:376-392), each
    client's contribution to the median's counter is truncated
    (helper.py:410-415), and the counter is reported, never applied.
    `mask`: excluded clients get zero weight and where-zeroed points. DP
    noise is added to the median and discarded with it on a reject."""
    if mask is not None:
        stacked_deltas = survivor_sanitize(stacked_deltas, mask)
    points = flatten_stacked(stacked_deltas)                    # [C, P]
    alphas = num_samples.to(torch.float32)
    if mask is not None:
        alphas = alphas * mask.to(torch.float32)
    alphas = alphas / torch.sum(alphas)
    nbt = (nbt_deltas.to(torch.float32) if nbt_deltas is not None
           else torch.zeros((points.shape[0],), dtype=torch.float32,
                            device=points.device))
    if mask is not None:
        nbt = nbt * mask.to(torch.float32)
    nbf = float(n_bn) if nbt_deltas is not None else 0.0

    def wavg(w):
        wn = w / torch.sum(w)
        return wn @ points, torch.sum(torch.trunc(wn * nbt))   # [P], scalar

    def dists(m, mn):
        sq = torch.sum(torch.square(points - m[None, :]), dim=1)
        return torch.sqrt(sq + nbf * torch.square(nbt - mn))

    def objective(m, mn):
        return torch.sum(alphas * dists(m, mn))

    median, nbt_med = wavg(alphas)
    obj = objective(median, nbt_med)
    wv = alphas
    done = torch.zeros((), dtype=torch.bool, device=points.device)
    calls = torch.ones((), dtype=torch.int32, device=points.device)
    for _ in range(maxiter):
        weights = alphas / torch.clamp(dists(median, nbt_med), min=eps)
        weights = weights / torch.sum(weights)
        new_median, new_nbt = wavg(weights)
        new_obj = objective(new_median, new_nbt)
        converged = torch.abs(obj - new_obj) < ftol * new_obj
        # the reference records wv only on non-breaking iterations
        # (helper.py:352) and crashes when none ran; the latest weights are
        # kept instead, as in the JAX version
        median = torch.where(done, median, new_median)
        nbt_med = torch.where(done, nbt_med, new_nbt)
        obj = torch.where(done, obj, new_obj)
        wv = torch.where(done, wv, weights)
        calls = calls + (~done).to(torch.int32)
        done = done | converged

    distances = dists(median, nbt_med)
    update_norm = torch.sqrt(torch.sum(torch.square(median))
                             + nbf * torch.square(nbt_med))
    is_updated = (torch.ones((), dtype=torch.bool, device=points.device)
                  if max_update_norm is None
                  else update_norm < max_update_norm)
    median_tree = _noised(unflatten_like(median * eta, stacked_deltas),
                          dp_sigma, noise, gen)
    new_state = {k: torch.where(is_updated, g + median_tree[k].to(g.dtype), g)
                 for k, g in global_state.items()}
    return RfaResult(new_state, calls, is_updated, wv, distances, nbt_med)


# ----------------------------------------------------------------- FoolsGold
class FoolsGoldState(NamedTuple):
    """Cross-round per-participant gradient memory (helper.py:545-549), keyed
    by participant id. A row is the flattened similarity-layer gradient in
    the port's layout (a torch [out, in] weight); convert.py transposes rows
    to and from the JAX package's flax [in, out] kernel."""
    memory: torch.Tensor  # [num_participants, grad_len] float32


def foolsgold_init(num_participants: int, grad_len: int,
                   device: torch.device | str = "cpu") -> FoolsGoldState:
    return FoolsGoldState(memory=torch.zeros(
        (num_participants, grad_len), dtype=torch.float32, device=device))


def foolsgold_weights(feature_grads: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FoolsGold reweighting (helper.py:574-607) of a [C, L] gradient
    matrix. Returns (wv [C], alpha [C]). Masked rows are where-zeroed before
    the cosines and their wv zeroed before the max-normalization."""
    eps = 1e-12
    if mask is not None:
        feature_grads = torch.where(mask[:, None] > 0, feature_grads,
                                    torch.zeros((), dtype=feature_grads.dtype,
                                                device=feature_grads.device))
    n = feature_grads.shape[0]
    eye = torch.eye(n, dtype=feature_grads.dtype, device=feature_grads.device)
    norms = torch.linalg.vector_norm(feature_grads, dim=1)
    normed = feature_grads / torch.clamp(norms, min=eps)[:, None]
    cs = normed @ normed.T - eye

    maxcs = torch.max(cs, dim=1).values
    # pardoning (helper.py:584-589): cs[i,j] *= maxcs[i]/maxcs[j] when
    # maxcs[i] < maxcs[j]
    ratio = maxcs[:, None] / maxcs[None, :]
    pardon = torch.where(maxcs[:, None] < maxcs[None, :], ratio,
                         torch.ones_like(ratio))
    pardon = pardon * (1.0 - eye) + eye
    cs = cs * pardon

    row_max = torch.max(cs, dim=1).values
    wv = torch.clamp(1.0 - row_max, 0.0, 1.0)
    alpha = row_max
    if mask is not None:
        wv = wv * mask.to(wv.dtype)
    wv = wv / torch.max(wv)
    wv = torch.where(wv == 1.0, torch.full_like(wv, 0.99), wv)
    logit = torch.log(wv / (1.0 - wv)) + 0.5
    # reference: wv[(np.isinf(wv) + wv > 1)] = 1; wv[wv < 0] = 0 — the
    # bool-add precedence quirk (isinf + wv) > 1 (helper.py:603)
    inf_mask = torch.isinf(logit).to(logit.dtype)
    logit = torch.where(inf_mask + logit > 1.0, torch.ones_like(logit), logit)
    logit = torch.where(logit < 0.0, torch.zeros_like(logit), logit)
    return logit, alpha


class FoolsGoldResult(NamedTuple):
    new_params: Dict[str, torch.Tensor]
    new_fg_state: FoolsGoldState
    wv: torch.Tensor
    alpha: torch.Tensor


def foolsgold_update(global_params: Tree, stacked_grads: Tree,
                     feature_grads: torch.Tensor,
                     participant_ids: torch.Tensor, fg_state: FoolsGoldState,
                     eta: float, lr: float, momentum: float,
                     weight_decay: float, use_memory: bool = True,
                     mask: Optional[torch.Tensor] = None) -> FoolsGoldResult:
    """helper.py:259-293 + FoolsGold.aggregate_gradients (:534-572).

    `stacked_grads`: per-client gradients accumulated over the round
    (the fused update's `sgd_acc` leaves); `feature_grads`: [C, L], the
    similarity layer's part of them, flattened. Only the parameters move;
    BN stats are the caller's to keep (the reference steps an optimizer over
    named_parameters only). `mask`: excluded clients' grads are where-zeroed
    and their rows of the memory are never written."""
    if mask is not None:
        stacked_grads = survivor_sanitize(stacked_grads, mask)
        feature_grads = torch.where(
            mask[:, None] > 0, feature_grads,
            torch.zeros((), dtype=feature_grads.dtype,
                        device=feature_grads.device))
    ids = participant_ids.to(torch.long)
    memory = fg_state.memory.index_add(0, ids, feature_grads)
    current = memory[ids] if use_memory else feature_grads
    wv, alpha = foolsgold_weights(current, mask=mask)

    num_clients = feature_grads.shape[0]
    # applied through one fresh torch-SGD step with grad = η·agg
    # (helper.py:278-290): zero momentum buffers, weight decay applied
    scaled = {k: eta * (torch.sum(_bc_mask(wv, g) * g.to(torch.float32),
                                  dim=0) / num_clients)
              for k, g in stacked_grads.items()}
    zeros = {k: torch.zeros_like(v) for k, v in global_params.items()}
    new_params, _ = sgd_step(global_params, scaled, zeros, lr, momentum,
                             weight_decay)
    return FoolsGoldResult(new_params, FoolsGoldState(memory), wv, alpha)


# ------------------------------------------------------- Krum / multi-Krum
# Finite sentinels, so a degenerate survivor set still sorts the same way: an
# excluded client's score (_EXCLUDED) exceeds any survivor's, even that of a
# single survivor whose score is a sum of _FAR pair distances.
_FAR = 1e30        # pair distance to/from an excluded client
_EXCLUDED = 1e35   # score of an excluded client


class KrumResult(NamedTuple):
    new_state: Dict[str, torch.Tensor]
    wv: torch.Tensor      # [C] applied weights: 1/m_eff if selected, else 0
    scores: torch.Tensor  # [C] Krum scores (_EXCLUDED for masked clients)


def krum_update(global_state: Tree, stacked_deltas: Tree, eta: float,
                num_selected: int, byz_f: int,
                mask: Optional[torch.Tensor] = None, dp_sigma: float = 0.0,
                noise: Optional[Tree] = None,
                gen: Optional[torch.Generator] = None) -> KrumResult:
    """Krum / multi-Krum (Blanchard et al., NeurIPS 2017) over survivors:
    score_i = Σ of the n−f−2 smallest squared distances to the other
    survivors (clipped to [1, n−1]); η · mean of the `num_selected`
    lowest-scoring survivors is applied. Distances keep the JAX form
    ‖a‖² + ‖b‖² − 2ab over a full-float32 Gram matrix, so selections agree."""
    if mask is None:
        mask_f = _ones_mask(stacked_deltas)
    else:
        mask_f = (mask > 0).to(torch.float32)
        stacked_deltas = survivor_sanitize(stacked_deltas, mask)
    pts = flatten_stacked(stacked_deltas)                        # [C, P]
    C, dev = pts.shape[0], pts.device
    sq_norms = torch.sum(torch.square(pts), dim=1)
    gram = pts @ pts.T
    d2 = torch.clamp(sq_norms[:, None] + sq_norms[None, :] - 2.0 * gram,
                     min=0.0)
    alive = mask_f > 0
    eye = torch.eye(C, dtype=torch.bool, device=dev)
    valid_pair = alive[:, None] & alive[None, :] & ~eye
    d2 = torch.where(valid_pair, d2, torch.full_like(d2, _FAR))
    n_alive = torch.sum(mask_f)
    one = torch.ones((), dtype=torch.float32, device=dev)
    nb = torch.minimum(torch.maximum(n_alive - byz_f - 2.0, one),
                       torch.maximum(n_alive - 1.0, one)).to(torch.int32)
    d2_sorted = torch.sort(d2, dim=1).values
    near = torch.arange(C, device=dev)[None, :] < nb
    scores = torch.sum(torch.where(near, d2_sorted, torch.zeros_like(d2)),
                       dim=1)
    scores = torch.where(alive, scores, torch.full_like(scores, _EXCLUDED))
    # clip(num_selected, 1, max(n, 1))
    m_eff = torch.clamp(n_alive.to(torch.int32), min=1).clamp(
        max=max(num_selected, 1))
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    sel = (rank < m_eff) & alive
    wv = sel.to(torch.float32) / m_eff.to(torch.float32)
    new_state = {k: g + eta * torch.sum(_bc_mask(wv, stacked_deltas[k])
                                        * stacked_deltas[k].to(torch.float32),
                                        dim=0).to(g.dtype)
                 for k, g in global_state.items()}
    return KrumResult(_noised(new_state, dp_sigma, noise, gen), wv, scores)


# ------------------------------------- coordinate-wise trimmed mean / median
class CoordwiseResult(NamedTuple):
    new_state: Dict[str, torch.Tensor]
    wv: torch.Tensor  # [C] uniform survivor weights (the recorded weight; a
                      # coordinate-wise rule has no per-client scalar)


def _sorted_survivor_columns(stacked_deltas: Tree, mask_f: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [C, P] survivor matrix sorted ascending per column, excluded rows
    pushed past the survivors (+inf); rows [0, n) hold the survivors'
    values. Returns it and the survivor count."""
    pts = flatten_stacked(stacked_deltas)
    pts = torch.where(mask_f[:, None] > 0, pts,
                      torch.full((), float("inf"), device=pts.device))
    return torch.sort(pts, dim=0).values, torch.sum(mask_f)


def _apply_vector(global_state: Tree, vec: torch.Tensor, stacked: Tree
                  ) -> Dict[str, torch.Tensor]:
    upd = unflatten_like(vec, stacked)
    return {k: g + upd[k].to(g.dtype) for k, g in global_state.items()}


def trimmed_mean_update(global_state: Tree, stacked_deltas: Tree, eta: float,
                        beta: float, mask: Optional[torch.Tensor] = None,
                        dp_sigma: float = 0.0, noise: Optional[Tree] = None,
                        gen: Optional[torch.Generator] = None
                        ) -> CoordwiseResult:
    """Coordinate-wise β-trimmed mean (Yin et al., ICML 2018): per
    coordinate, drop the k = ⌊β·n⌋ smallest and largest survivor values
    (k clipped so one value remains), average the rest, apply with η."""
    if mask is None:
        mask_f = _ones_mask(stacked_deltas)
    else:
        mask_f = (mask > 0).to(torch.float32)
        stacked_deltas = survivor_sanitize(stacked_deltas, mask)
    pts_sorted, n_alive = _sorted_survivor_columns(stacked_deltas, mask_f)
    n_i = n_alive.to(torch.int32)
    k = torch.minimum(torch.floor(beta * n_alive).to(torch.int32),
                      torch.div(n_i - 1, 2, rounding_mode="floor"))
    row = torch.arange(pts_sorted.shape[0], device=pts_sorted.device)[:, None]
    keep = (row >= k) & (row < n_i - k)
    kept = torch.sum(torch.where(keep, pts_sorted,
                                 torch.zeros_like(pts_sorted)), dim=0)
    count = torch.clamp(n_alive - 2.0 * k.to(torch.float32), min=1.0)
    new_state = _apply_vector(global_state, kept / count * eta,
                              stacked_deltas)
    return CoordwiseResult(_noised(new_state, dp_sigma, noise, gen),
                           mask_f / torch.clamp(n_alive, min=1.0))


def coordinate_median_update(global_state: Tree, stacked_deltas: Tree,
                             eta: float, mask: Optional[torch.Tensor] = None,
                             dp_sigma: float = 0.0,
                             noise: Optional[Tree] = None,
                             gen: Optional[torch.Generator] = None
                             ) -> CoordwiseResult:
    """Coordinate-wise survivor median (Yin et al., ICML 2018), an even
    count averaging the two central values (numpy's convention; torch.median
    would return the lower one), applied with η."""
    if mask is None:
        mask_f = _ones_mask(stacked_deltas)
    else:
        mask_f = (mask > 0).to(torch.float32)
        stacked_deltas = survivor_sanitize(stacked_deltas, mask)
    pts_sorted, n_alive = _sorted_survivor_columns(stacked_deltas, mask_f)
    n_i = torch.clamp(n_alive.to(torch.int64), min=1)
    lo = torch.div(n_i - 1, 2, rounding_mode="floor").reshape(1)
    hi = torch.div(n_i, 2, rounding_mode="floor").reshape(1)
    med = 0.5 * (pts_sorted.index_select(0, lo)[0]
                 + pts_sorted.index_select(0, hi)[0])
    new_state = _apply_vector(global_state, med * eta, stacked_deltas)
    return CoordwiseResult(_noised(new_state, dp_sigma, noise, gen),
                           mask_f / torch.clamp(n_alive, min=1.0))
