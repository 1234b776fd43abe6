"""The grouped client layout (dba_mod_tpu_torch/models/grouped.py,
fl/grouped_client.py) and ``sequential_debug`` (RoundEngine.train_sequential)
against the port's vmapped path and the JAX package.

Bounds, from tests/test_grouped_clients.py: one train-mode forward ≤ 5e-5
(grouped and vmapped convolutions sum in different orders); a CIFAR round's
global params < 5e-4 and BN stats < 1e-4 with equal accuracies; the
FoolsGold + α = 0.9 lane's weight rows and memory within 2e-2. A grouped
segment of the port matches the JAX package's in float64 to 1e-12, and in
float32 sits within 1e-5 of the JAX float64 pass and within 1.25× the JAX
package's own distance from it (the test says why).
``sequential_debug``: tests/test_fl_integration.py's bounds (global ≤
2e-3, accuracy within 0.5) against the port's stacked run, and the MNIST
lane bounds (per client ≤ 1e-6, participant 3's max-pool near-tie as in
tests/test_torch_slice.py) against the JAX package's round. No JAX CIFAR
round program runs here: the segment test covers the JAX side."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from benchmarks.parity_ab import LOAN_AB, MNIST_AB_R1
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.device_data import make_image_device_data as jdevdata
from dba_mod_tpu.fl.experiment import Experiment as JExperiment
from dba_mod_tpu.fl import grouped_client as jgrouped_client_mod
from dba_mod_tpu.fl.grouped_client import make_grouped_client_step as jgmake
from dba_mod_tpu.fl.selection import select_agents as jselect
from dba_mod_tpu.fl.state import RoundHyper as JHyper
from dba_mod_tpu.fl.state import build_client_tasks as jtasks
from dba_mod_tpu.models import ModelVars as JModelVars
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu.models import grouped as jgrouped_model_mod
from dba_mod_tpu.models.grouped import conv_layout_in
from dba_mod_tpu.models.grouped import grouped_train_apply as jgrouped
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.data.batching import build_batch_plan
from dba_mod_tpu_torch.data.datasets import synthetic_image_dataset
from dba_mod_tpu_torch.fl import client as client_mod
from dba_mod_tpu_torch.fl import device_data as device_data_mod
from dba_mod_tpu_torch.fl.device_data import make_image_device_data
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.fl.grouped_client import make_grouped_client_step
from dba_mod_tpu_torch.fl.rounds import RoundEngine
from dba_mod_tpu_torch.fl.selection import select_agents
from dba_mod_tpu_torch.fl.state import RoundHyper, build_client_tasks
from dba_mod_tpu_torch.models import ModelVars, build_model, cifar_resnet50
from dba_mod_tpu_torch.models import grouped as grouped_mod
from dba_mod_tpu_torch.models.grouped import (grouped_train_apply,
                                              supports_grouped)
from dba_mod_tpu_torch.ops.fused_update import fused_step_update_reference

CPU = torch.device("cpu")

CIFAR_CFG = dict(
    type="cifar", lr=0.1, batch_size=8, epochs=2, no_models=4,
    number_of_total_participants=8, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, internal_poison_epochs=2, is_poison=True,
    synthetic_data=True, synthetic_train_size=128, synthetic_test_size=64,
    momentum=0.9, decay=0.0005, sampling_dirichlet=False, local_eval=True,
    poison_label_swap=2, poisoning_per_batch=4, poison_lr=0.05,
    scale_weights_poison=2.0, adversary_list=[0], trigger_num=1,
    alpha_loss=1.0, random_seed=1,
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2]],
       "0_poison_epochs": [1, 2]})

# tests/test_fl_integration.py's POISON config
POISON = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=8, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, internal_poison_epochs=4, is_poison=True,
    synthetic_data=True, synthetic_train_size=600, synthetic_test_size=256,
    momentum=0.9, decay=0.0005, sampling_dirichlet=False, local_eval=True,
    random_seed=1, poison_label_swap=2, poisoning_per_batch=8,
    poison_lr=0.05, scale_weights_poison=4.0, adversary_list=[0, 1],
    trigger_num=2, alpha_loss=1.0,
    **{"0_poison_pattern": [[0, 0], [0, 1], [0, 2], [0, 3]],
       "1_poison_pattern": [[3, 0], [3, 1], [3, 2], [3, 3]],
       "0_poison_epochs": [3, 4, 5, 6], "1_poison_epochs": [4, 5, 6]})


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _client(tree, c):
    return {k: v[c] for k, v in tree.items()}


def _jax_clients(name, jtree_params, jtree_stats, C):
    """A JAX [C, ...] stacked (params, stats) pair → the port's per-client
    ModelVars list, in the JAX leaves' dtype."""
    dtype = np.asarray(jax.tree_util.tree_leaves(jtree_params)[0]).dtype
    return [convert.from_jax_numpy(
        name, jax.tree_util.tree_map(lambda l: np.asarray(l)[c],
                                     jtree_params),
        jax.tree_util.tree_map(lambda l: np.asarray(l)[c], jtree_stats),
        dtype) for c in range(C)]


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("mtype", ["cifar", "tiny-imagenet-200"])
def test_grouped_forward_matches_vmapped_and_jax(mtype):
    """One train-mode batch, C = 3, B = 4, both stems (the 7×7/s2 stem and
    its max pool too): grouped_train_apply against the port's vmapped
    model_def.apply and against the JAX grouped_train_apply, logits and new
    BN stats ≤ 5e-5."""
    cfg = dict(CIFAR_CFG, type=mtype)
    jdef = jbuild(JParams.from_dict(cfg))
    tdef = build_model(Params.from_dict(cfg))
    assert supports_grouped(tdef)
    C, B = 3, 4
    tmvs = [tdef.init_vars(c, CPU) for c in range(C)]
    p = _stack([m.params for m in tmvs])
    s = _stack([m.batch_stats for m in tmvs])
    hw = tdef.input_shape[0]
    x = np.random.RandomState(1).rand(C, B, hw, hw, 3).astype(np.float32)

    lv, sv = torch.func.vmap(lambda pp, ss, xx: tdef.apply(
        ModelVars(pp, ss), xx, train=True))(p, s, torch.from_numpy(x))
    lg, sg = grouped_train_apply(tdef, p, s, torch.from_numpy(x))
    assert float((lv - lg).abs().max()) <= 5e-5
    assert _max_diff(sv, sg) <= 5e-5

    jp, js = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *[
        convert.to_jax_numpy(tdef.name, m) for m in tmvs])
    jl, jstats = jax.jit(lambda pp, ss, xx: jgrouped(
        jdef, conv_layout_in(pp), ss, xx))(jp, js, jnp.asarray(x))
    assert float(np.abs(lg.numpy() - np.asarray(jl)).max()) <= 5e-5
    want = _stack([m.batch_stats for m in _jax_clients(
        tdef.name, jp, jstats, C)])
    assert _max_diff(sg, want) <= 5e-5


# ------------------------------------------------------------------ segment
def _plain_update(lr, valid, params, grads, mom, fg, bn_new, bn_old, *,
                  momentum, weight_decay):
    """The fused update's plain version in the state's own dtype (the
    wrapper takes float32 only): the float64 pass's update."""
    new = fused_step_update_reference(
        lr.to(next(iter(params.values())).dtype), valid, params, grads, mom,
        fg, bn_new, bn_old, momentum=momentum, weight_decay=weight_decay)
    for dst, src in zip((params, mom, fg, bn_old), new):
        for k, t in src.items():
            dst[k].copy_(t)


class _Wide:
    """jax.numpy with ``float32`` read as float64. The JAX grouped step casts
    to a fixed float32 in places (its BatchNorm statistics and
    normalization, the logits, the metrics); with this in their modules'
    ``jnp`` and x64 on, the step runs as a float64 pass."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# Bounds of the grouped segment, max |Δ| over the leaves of each part:
# float64 port vs float64 JAX (read: ≤ 4.2e-15); float32 port vs float64
# JAX (read: 1.1e-7 to 1.1e-6); float32 port vs float32 JAX, each part
# about 1.5x its reading (6.5e-3, 1.1e-3, 6.4e-3, 6.5e-2)
SEG_F64 = 1e-12
SEG_PORT_F32 = 1e-5
SEG_PORT_VS_JAX = {"params": 1e-2, "stats": 2e-3, "mom": 1e-2, "fg": 1e-1}


def test_grouped_segment_matches_jax(monkeypatch):
    """One grouped client segment at CIFAR_CFG's size with FoolsGold on and
    alpha_loss 0.9 (four clients of one batch each; adversary 0 poisons two
    internal epochs from zero momentum, its second step with the blended
    loss's distance term and its zero-gradient-safe norm; the benign
    clients carry a momentum): the port's grouped step against the JAX
    package's grouped step on the same inputs, end state, BN stats, benign
    momentum and FoolsGold accumulators.

    Both steps also run as float64 passes (the JAX step's fixed float32
    casts widened, the port's with the plain update, the images in float64
    in both), and there the packages agree to SEG_F64. The float64 JAX pass
    is the anchor for the float32 runs: the port's is within SEG_PORT_F32
    of it and within 1.25x the JAX package's own distance from it (the rule
    test_torch_tiny.py holds Tiny's BN stats to). The JAX package's float32
    step on XLA:CPU sits 1e-3 to 6.5e-2 from that pass, so the two float32
    runs are held to each other only by SEG_PORT_VS_JAX. The counting
    metrics are equal; the loss sums agree to 1% in float32, to float32
    rounding in float64 (the port's metrics accumulate in float32), and the
    port's float32 ones to 1e-5 of the float64 pass."""
    cfg = dict(CIFAR_CFG, aggregation_methods="foolsgold", alpha_loss=0.9)
    tp, jp = Params.from_dict(cfg), JParams.from_dict(cfg)
    data = synthetic_image_dataset("cifar", 128, 64, seed=1)
    names, epoch, E, B = [0, 3, 5, 6], 1, 2, 8
    slots = np.zeros(4, np.int64)
    tasks = build_client_tasks(tp, names, epoch, slots, E)
    jt = jtasks(jp, names, epoch, slots, E, None)
    assert int(tasks.poisoning_per_batch[0]) > 0
    # one batch a client: the adversary's two poison epochs are two steps
    clients = [list(range(8 * i, 8 * i + 8)) for i in range(4)]
    plan = build_batch_plan(clients, [int(e) for e in tasks.num_epochs], B,
                            np.random.RandomState(0), min_epochs=E)

    tdef = build_model(tp)
    tmv = tdef.init_vars(0, CPU)
    jmv = JModelVars(*convert.to_jax_numpy(tdef.name, tmv))
    rng = np.random.RandomState(1)
    mom = {k: torch.from_numpy((rng.randn(4, *v.shape) * 0.01)
                               .astype(np.float32))
           for k, v in tmv.params.items()}
    jmom = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *[
        convert.to_jax_numpy(tdef.name, ModelVars(_client(mom, c),
                                                  tmv.batch_stats))[0]
        for c in range(4)])

    def jax_pass(dtype):
        jdef = jbuild(jp)
        jdef = dataclasses.replace(jdef, module=jdef.module.clone(
            dtype=dtype))
        cast = lambda l: jnp.asarray(l, dtype)
        task = jt._replace(**{f: cast(getattr(jt, f))
                              for f in ("alpha", "scale", "lr_row")})
        res = jax.jit(jgmake(jdef, jdevdata(data, jp, compute_dtype=dtype),
                             JHyper.from_params(jp), True))(
            jax.tree_util.tree_map(
                lambda l: jnp.broadcast_to(cast(l), (4,) + l.shape), jmv),
            jax.tree_util.tree_map(cast, jmom),
            jax.tree_util.tree_map(jnp.asarray, task), jnp.asarray(plan.idx),
            jnp.asarray(plan.mask), jax.random.split(jax.random.key(0), 4))
        return jax.device_get(res)

    def port(dtype):
        with monkeypatch.context() as m:  # images in the pass's dtype
            m.setattr(device_data_mod, "compute_dtype_of", lambda _: dtype)
            step_data = make_image_device_data(data, tp, CPU)
        step = make_grouped_client_step(
            dataclasses.replace(tdef, dtype=dtype), step_data,
            RoundHyper.from_params(tp), True)
        task = tasks.to_device(CPU)
        task = task._replace(**{f: getattr(task, f).to(dtype)
                                for f in ("alpha", "scale", "lr_row")})
        return step(ModelVars(*({k: v.to(dtype).expand((4,) + v.shape)
                                 .clone() for k, v in tree.items()}
                                for tree in tmv)),
                    {k: v.to(dtype) for k, v in mom.items()}, task,
                    torch.from_numpy(plan.idx), torch.from_numpy(plan.mask),
                    plan.mask.any(axis=(0, 3)))

    jres = jax_pass(jnp.float32)
    res = port(torch.float32)
    with monkeypatch.context() as m, jax.enable_x64(True):
        for mod in (jgrouped_model_mod, jgrouped_client_mod):
            m.setattr(mod, "jnp", _Wide())
        jres64 = jax_pass(jnp.float64)
        m.setattr(client_mod, "fused_step_update", _plain_update)
        res64 = port(torch.float64)

    def parts(r, j):
        if j:
            stats = r.end_vars.batch_stats
            ends = _jax_clients(tdef.name, r.end_vars.params, stats, 4)
            r = types.SimpleNamespace(
                end_vars=ModelVars(_stack([m.params for m in ends]),
                                   _stack([m.batch_stats for m in ends])),
                benign_mom=_stack([m.params for m in _jax_clients(
                    tdef.name, r.benign_mom, stats, 4)]),
                fg_grads=_stack([m.params for m in _jax_clients(
                    tdef.name, r.fg_grads, stats, 4)]))
        return {"params": r.end_vars.params,
                "stats": r.end_vars.batch_stats, "mom": r.benign_mom,
                "fg": r.fg_grads}

    def dist(a, b):
        return _max_diff({k: v.double() for k, v in a.items()},
                         {k: v.double() for k, v in b.items()})

    port32, port64 = parts(res, False), parts(res64, False)
    jax32, jax64 = parts(jres, True), parts(jres64, True)
    readings = {}
    for part in port32:
        assert all(v.dtype == torch.float64 for tree in (
            port64[part], jax64[part]) for v in tree.values())
        readings[part] = (dist(port64[part], jax64[part]),
                          dist(port32[part], jax64[part]),
                          dist(jax32[part], jax64[part]),
                          dist(port32[part], jax32[part]))
        print(part, "float64 port vs JAX {:.3g}; from the JAX float64 pass: "
              "port {:.3g}, JAX {:.3g}; float32 port vs JAX {:.3g}".format(
                  *readings[part]))
    for part, (d64, d_port, d_jax, d32) in readings.items():
        assert d64 <= SEG_F64, (part, d64)
        assert 0 < d_port <= min(SEG_PORT_F32, 1.25 * d_jax), (
            part, d_port, d_jax)
        assert d32 <= SEG_PORT_VS_JAX[part], (part, d32)
    for r, j in ((res, jres), (res64, jres64)):
        for f in ("correct", "count", "poison_count"):
            np.testing.assert_array_equal(getattr(r.metrics, f).numpy(),
                                          np.asarray(getattr(j.metrics, f)))
    loss32, loss64 = (np.asarray(j.metrics.loss_sum) for j in (jres, jres64))
    np.testing.assert_allclose(res.metrics.loss_sum.numpy(), loss32,
                               rtol=1e-2)
    np.testing.assert_allclose(res64.metrics.loss_sum.numpy(), loss64,
                               rtol=1e-7)
    np.testing.assert_allclose(res.metrics.loss_sum.numpy(), loss64,
                               rtol=1e-5)


# ------------------------------------------------------------------ rounds
def _round_pair(cfg):
    ev = Experiment(Params.from_dict(dict(cfg, grouped_clients=False)),
                    save_results=False, device="cpu")
    eg = Experiment(Params.from_dict(dict(cfg, grouped_clients=True)),
                    save_results=False, device="cpu")
    assert eg.engine.use_grouped and not ev.engine.use_grouped
    return ev, eg


def test_grouped_round_matches_vmapped_cifar():
    """A CIFAR_CFG round (its local battery off: the layouts share it),
    grouped against the port's vmapped round."""
    ev, eg = _round_pair(dict(CIFAR_CFG, local_eval=False))
    rv, rg = ev.run_round(1), eg.run_round(1)
    assert rv["global_acc"] == rg["global_acc"]
    assert rv["backdoor_acc"] == rg["backdoor_acc"]
    assert _max_diff(ev.global_vars.params, eg.global_vars.params) < 5e-4
    assert _max_diff(ev.global_vars.batch_stats,
                     eg.global_vars.batch_stats) < 1e-4


def test_grouped_round_foolsgold_blended_loss():
    """FoolsGold's accumulators and the α < 1 distance term through the
    grouped round: weight rows and the FoolsGold memory within 2e-2."""
    ev, eg = _round_pair(dict(CIFAR_CFG, aggregation_methods="foolsgold",
                              alpha_loss=0.9, local_eval=False))
    rv, rg = ev.run_round(1), eg.run_round(1)
    assert rv["global_acc"] == rg["global_acc"]
    np.testing.assert_allclose(np.asarray(ev.recorder.weight_result[1],
                                          float),
                               np.asarray(eg.recorder.weight_result[1],
                                          float), atol=2e-2)
    assert float((ev.fg_state.memory - eg.fg_state.memory).abs().max()) \
        < 2e-2


def test_fused_update_once_per_step_and_the_grouped_views_are_free(
        monkeypatch):
    """The grouped step ends each active local step in exactly one
    fused_step_update call over the client-leading state (contiguous
    leaves: the wrapper raises on any other), and every grouped
    convolution's weight is a view of the stacked leaf: same storage, no
    copy."""
    tp = Params.from_dict(dict(CIFAR_CFG, aggregation_methods="foolsgold"))
    tdef = build_model(tp)
    data = synthetic_image_dataset("cifar", 128, 64, seed=1)
    names = [0, 3, 5, 6]
    tasks = build_client_tasks(tp, names, 1, np.zeros(4, np.int64), 2)
    # client 3 has one batch only: its other steps are invalid lanes
    clients = [list(range(0, 16)), list(range(16, 24)),
               list(range(32, 48)), list(range(48, 64))]
    plan = build_batch_plan(clients, [int(e) for e in tasks.num_epochs], 8,
                            np.random.RandomState(0), min_epochs=2)
    calls = []
    real = client_mod.fused_step_update

    def spy(lr, valid, params, grads, mom, fg, bn_new, bn_old, **kw):
        calls.append((valid.clone(), bool(fg), len(bn_old)))
        return real(lr, valid, params, grads, mom, fg, bn_new, bn_old, **kw)

    monkeypatch.setattr(client_mod, "fused_step_update", spy)
    step = make_grouped_client_step(tdef, make_image_device_data(
        data, tp, CPU), RoundHyper.from_params(tp), True)
    mv = tdef.init_vars(0, CPU)
    start = ModelVars(
        {k: v.expand((4,) + v.shape).clone() for k, v in mv.params.items()},
        {k: v.expand((4,) + v.shape).clone()
         for k, v in mv.batch_stats.items()})
    active = plan.mask.any(axis=(0, 3))
    step(start, {k: torch.zeros_like(v) for k, v in start.params.items()},
         tasks.to_device(CPU), torch.from_numpy(plan.idx),
         torch.from_numpy(plan.mask), active)
    assert len(calls) == int(active.sum()) == 4
    assert all(fg and n == len(mv.batch_stats) for _, fg, n in calls)
    # adversary 0 poisons two internal epochs, the benign clients train one
    assert [v.tolist() for v, _, _ in calls] == [
        [1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0], [1.0, 0.0, 0.0, 0.0],
        [1.0, 0.0, 0.0, 0.0]]

    ptrs = []
    real_conv = F.conv2d

    def conv(x, w, *a, **kw):
        ptrs.append((w.data_ptr(), w.is_contiguous(), kw.get("groups")))
        return real_conv(x, w, *a, **kw)

    monkeypatch.setattr(grouped_mod, "F", types.SimpleNamespace(conv2d=conv))
    grouped_train_apply(tdef, start.params, start.batch_stats,
                        torch.rand(4, 2, 32, 32, 3))
    leaves = {v.data_ptr() for k, v in start.params.items()
              if v.dim() == 5}
    assert len(ptrs) == len(leaves)
    assert {p for p, _, _ in ptrs} == leaves
    assert all(c and g == 4 for _, c, g in ptrs)


# ------------------------------------------------------------------ gating
def test_grouped_gating():
    """Off by default; MnistNet, LoanNet and a Bottleneck ResNet (CIFAR50)
    raise the JAX package's ValueError; an async run trains its waves
    through the grouped step."""
    e = Experiment(Params.from_dict(dict(CIFAR_CFG)), save_results=False,
                   device="cpu")
    assert not e.engine.use_grouped
    for raw in (dict(CIFAR_CFG, type="mnist", synthetic_train_size=64),
                dict(LOAN_AB)):
        with pytest.raises(ValueError, match="grouped_clients"):
            Experiment(Params.from_dict(dict(raw, grouped_clients=True)),
                       save_results=False, device="cpu")
    p = Params.from_dict(dict(CIFAR_CFG, grouped_clients=True))
    assert not supports_grouped(cifar_resnet50())
    with pytest.raises(ValueError, match="grouped_clients"):
        RoundEngine(p, cifar_resnet50(), e.device_data, e.eval_plans)


def test_async_waves_train_grouped(monkeypatch):
    calls = []
    real = grouped_mod.grouped_train_apply

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    from dba_mod_tpu_torch.fl import grouped_client
    monkeypatch.setattr(grouped_client, "grouped_train_apply", spy)
    raw = dict(CIFAR_CFG, grouped_clients=True, mode="async", buffer_k=2,
               epochs=2, local_eval=False, synthetic_train_size=32,
               synthetic_test_size=16, is_poison=False)
    exp = Experiment(Params.from_dict(raw), save_results=False,
                     device="cpu")
    assert exp.engine.use_grouped
    before = {k: v.clone() for k, v in exp.global_vars.params.items()}
    exp.run()
    assert calls
    assert _max_diff(before, exp.global_vars.params) > 0


# ------------------------------------------------------------ sequential
def test_sequential_matches_stacked_mnist():
    """tests/test_fl_integration.py::test_sequential_debug_matches_vmapped
    in the port: three POISON rounds, clients one at a time against the
    stacked run."""
    cfg = dict(POISON, epochs=2, local_eval=False)
    e_v = Experiment(Params.from_dict(cfg), save_results=False, device="cpu")
    e_s = Experiment(Params.from_dict(dict(cfg, sequential_debug=True)),
                     save_results=False, device="cpu")
    assert e_s.engine.sequential and not e_v.engine.sequential
    for i in (1, 2, 3):
        rv, rs = e_v.run_round(i), e_s.run_round(i)
    assert abs(rv["global_acc"] - rs["global_acc"]) < 0.5
    assert _max_diff(e_v.global_vars.params, e_s.global_vars.params) <= 2e-3


def test_sequential_round_matches_jax_mnist_ab_r1(tmp_path):
    """One MNIST_AB_R1 round, the port's clients one at a time against the
    JAX package's round on the same weights and plans: every client's delta
    ≤ 1e-6 but benign participant 3, whose max-pool near-tie at its third
    step leaves it 1.509e-3 apart (tests/test_torch_slice.py); the global
    model less that client's FedAvg share ≤ 1e-6."""
    raw = dict(MNIST_AB_R1)
    jexp = JExperiment(JParams.from_dict(dict(raw, run_dir=str(
        tmp_path / "jax"))), save_results=False)
    texp = Experiment(Params.from_dict(dict(raw, sequential_debug=True,
                                            run_dir=str(tmp_path / "t"))),
                      save_results=False, device="cpu")
    jmv = jax.device_get(jexp.global_vars)
    texp.global_vars = convert.from_jax_numpy(texp.model_def.name,
                                              jmv.params, jmv.batch_stats)
    jp, tp = jexp.params, texp.params
    names, _ = jselect(jp, 1, jexp.participants, jexp.benign_names,
                       jexp.select_rng)
    tnames, _ = select_agents(tp, 1, texp.participants, texp.benign_names,
                              texp.select_rng)
    assert names == tnames
    slots = np.zeros(len(names), np.int64)
    jt = jtasks(jp, names, 1, slots, jexp.epochs_max, None)
    tt = build_client_tasks(tp, names, 1, slots, texp.epochs_max)
    plan = build_batch_plan([texp.client_indices[n] for n in names],
                            [int(e) for e in tt.num_epochs],
                            int(tp["batch_size"]), texp.plan_rng,
                            min_steps=texp.steps_per_epoch,
                            min_epochs=texp.epochs_max)
    C = len(names)
    rng_t, rng_a = jax.random.split(jax.random.key(0))
    jtrain = jexp.engine.train_fn(
        jexp.global_vars,
        jax.tree_util.tree_map(lambda l: jnp.asarray(l)[None], jt),
        jnp.asarray(plan.idx[None]), jnp.asarray(plan.mask[None]),
        jnp.arange(C, dtype=jnp.int32), rng_t)
    jagg = jexp.engine.aggregate_fn(
        jexp.global_vars, jexp.fg_state, jtrain.deltas, jtrain.fg_grads,
        jtrain.fg_feature, jnp.asarray(jt.participant_id),
        jnp.asarray(plan.num_samples.astype(np.float32)), rng_a)
    ttrain = texp.engine.train_sequential(texp.global_vars, [tt],
                                          plan.idx[None], plan.mask[None])
    tagg = texp.engine.aggregate_fn(texp.global_vars, ttrain.deltas)
    name = texp.model_def.name
    jd = jax.device_get(jtrain.deltas)
    diffs = {}
    for c in range(C):
        want = _jax_clients(name, jax.tree_util.tree_map(
            lambda l: l[c:c + 1], jd.params), {}, 1)[0].params  # no BN
        diffs[c] = {k: ttrain.deltas.params[k][c] - want[k] for k in want}
    per_client = [max(float(d.abs().max()) for d in diffs[c].values())
                  for c in range(C)]
    assert all(d <= 1e-6 for d in per_client[:3]), per_client
    assert abs(per_client[3] - 1.509e-3) < 1e-5, per_client
    jg = convert.from_jax_numpy(name, *jax.device_get(
        (jagg.new_vars.params, jagg.new_vars.batch_stats))).params
    w = float(jp["eta"]) / float(jp["no_models"])
    g_diff = max(float((tagg.new_vars.params[k] - jg[k] - w * diffs[3][k])
                       .abs().max()) for k in jg)
    assert g_diff <= 1e-6, g_diff


def test_sequential_matches_stacked_loan():
    """One poisoned LOAN_AB round with dropout: each client's width-1 call
    takes its own slice of the round's keep masks, so the sequential round
    is the stacked one."""
    e_v = Experiment(Params.from_dict(dict(LOAN_AB)), save_results=False,
                     device="cpu")
    e_s = Experiment(Params.from_dict(dict(LOAN_AB, sequential_debug=True)),
                     save_results=False, device="cpu")
    rv, rs = e_v.run_round(1), e_s.run_round(1)
    assert {"AK", "AL"} <= set(rv["agents"]) and e_v.model_def.has_dropout
    assert abs(rv["global_acc"] - rs["global_acc"]) < 0.5
    assert _max_diff(e_v.global_vars.params, e_s.global_vars.params) <= 1e-6


def test_sequential_refusals():
    """As in the JAX package: the fault layer with sequential_debug raises
    at the experiment, async with sequential_debug at validation."""
    with pytest.raises(ValueError, match="sequential_debug"):
        Experiment(Params.from_dict(dict(POISON, sequential_debug=True,
                                         screen_updates=True)),
                   save_results=False, device="cpu")
    with pytest.raises(ValueError, match="sequential_debug"):
        Params.from_dict(dict(POISON, sequential_debug=True, mode="async"))
