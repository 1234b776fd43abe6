"""The port's robust server rules (dba_mod_tpu_torch/ops/aggregation.py), its
quarantine screen and its fault perturbation against the JAX package's, on
the same numpy-made inputs: C = 6 clients, a small tree with a dense layer
(a flax [in, out] kernel against a torch [out, in] weight), a bias and a
BN-like running mean.

One parametrised test covers every rule, each dense and masked, with a NaN
row in the masked-out client. Bounds: new state within 1e-6 max abs (1e-5
for the geometric median: Weiszfeld iterates ten float32 reductions whose
summation order differs); Krum selections, the oracle count, is_updated
and survivor masks exactly equal; FoolsGold wv / alpha and its memory
(after the layout conversion of convert.py) within 1e-6; masked FedAvg
with an all-ones mask bitwise the dense rule; a NaN in an excluded row
leaves every result finite."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl import faults as jflt
from dba_mod_tpu.fl.rounds import screen_client_updates as jscreen
from dba_mod_tpu.models import ModelVars as JModelVars
from dba_mod_tpu.ops import aggregation as jagg
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl import faults as flt
from dba_mod_tpu_torch.fl.rounds import _nanmedian, screen_client_updates
from dba_mod_tpu_torch.models import ModelVars
from dba_mod_tpu_torch.ops import aggregation as agg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SMOKE = Path(__file__).resolve().parent.parent / "configs" / \
    "smoke_params.yaml"
C, IN, OUT = 6, 4, 3
MASK = np.array([1, 0, 1, 1, 1, 1], np.float32)   # client 1 is excluded
ETA = 0.8


def _jtree(rng, lead=()):
    """A JAX-layout tree: params {dense: {kernel [in, out], bias}} and a
    BN-like batch_stats {bn: {mean}}."""
    f = lambda *s: rng.randn(*(lead + s)).astype(np.float32)
    return JModelVars({"dense": {"kernel": f(IN, OUT), "bias": f(OUT)}},
                      {"bn": {"mean": f(OUT)}})


def _port(jt):
    """The same values in the port's flat layout (fc.weight is [out, in])."""
    k = np.asarray(jt.params["dense"]["kernel"])
    return ModelVars({"fc.weight": torch.from_numpy(
        np.ascontiguousarray(np.swapaxes(k, -1, -2))),
        "fc.bias": torch.from_numpy(np.array(jt.params["dense"]["bias"]))},
        {"bn.running_mean": torch.from_numpy(
            np.array(jt.batch_stats["bn"]["mean"]))})


def _merged(mv):
    return {**mv.params, **mv.batch_stats}


def _jdev(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(port_flat, jax_mv, atol):
    """Port flat dict vs JAX ModelVars (or params dict), per key."""
    want = _port(jax.device_get(jax_mv) if isinstance(jax_mv, JModelVars)
                 else JModelVars(jax.device_get(jax_mv),
                                 {"bn": {"mean": np.zeros(OUT, np.float32)}}))
    for k, w in _merged(want).items():
        if k not in port_flat:
            continue
        got = port_flat[k].numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def _inputs(seed, nan_row=True):
    rng = np.random.RandomState(seed)
    g, d = _jtree(rng), _jtree(rng, (C,))
    if nan_row:   # the excluded client's payload is corrupt
        d = jax.tree_util.tree_map(lambda l: l.copy(), d)
        d.params["dense"]["kernel"][1, 0, 0] = np.nan
        d.batch_stats["bn"]["mean"][1, 0] = np.inf
    return g, d, rng


def _case_fedavg():
    g, d_clean, _ = _inputs(0, nan_row=False)
    tg, td = _merged(_port(g)), _merged(_port(d_clean))
    counted = torch.ones(C, dtype=torch.bool)
    dense = agg.fedavg_update(tg, td, ETA, C)
    ones = agg.fedavg_update_masked(tg, td, ETA, C, torch.ones(C), counted)
    for k in dense:   # all-ones mask: bitwise the dense rule
        assert torch.equal(dense[k], ones[k]), k
    _close(dense, jagg.fedavg_update(_jdev(g), _jdev(d_clean), ETA, C), 1e-6)
    g, d, _ = _inputs(0)
    got = agg.fedavg_update_masked(_merged(_port(g)), _merged(_port(d)), ETA,
                                   C, torch.from_numpy(MASK), counted)
    want = jagg.fedavg_update_masked(_jdev(g), _jdev(d), ETA, C,
                                     jnp.asarray(MASK), jnp.ones(C, bool))
    _close(got, want, 1e-6)


def _case_geom_median():
    for masked, sigma, max_norm in ((False, 0.0, None), (True, 0.01, None),
                                    (True, 0.01, 1e-3)):
        g, d, rng = _inputs(1, nan_row=masked)
        ns = rng.randint(5, 50, C).astype(np.float32)
        nbt = rng.randint(1, 20, C).astype(np.float32)
        key = jax.random.key(3)
        m = jnp.asarray(MASK) if masked else None
        want = jagg.geometric_median_update(
            _jdev(g), _jdev(d), jnp.asarray(ns), ETA, maxiter=10,
            max_update_norm=max_norm, dp_sigma=sigma,
            rng=key if sigma else None, nbt_deltas=jnp.asarray(nbt), n_bn=1,
            mask=m)
        # the JAX rule draws its noise from `key` over the median's tree:
        # the same draw is handed to the port
        noise = (_merged(_port(jax.device_get(jagg.dp_noise_like(
            key, _jdev(g), sigma)))) if sigma else None)
        got = agg.geometric_median_update(
            _merged(_port(g)), _merged(_port(d)), torch.from_numpy(ns), ETA,
            maxiter=10, max_update_norm=max_norm, dp_sigma=sigma,
            noise=noise, nbt_deltas=torch.from_numpy(nbt), n_bn=1,
            mask=torch.from_numpy(MASK) if masked else None)
        assert int(got.num_oracle_calls) == int(want.num_oracle_calls)
        assert bool(got.is_updated) == bool(want.is_updated)
        _close(got.new_state, want.new_state, 1e-5)
        for a, b in ((got.wv, want.wv), (got.distances, want.distances)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        assert float(got.nbt_median) == float(want.nbt_median)
        if max_norm is not None:   # rejected: the global state, noise gone
            assert not bool(got.is_updated)
            for k, v in _merged(_port(g)).items():
                assert torch.equal(got.new_state[k], v), k


def _case_foolsgold():
    g, d, rng = _inputs(2)
    n_part = 10
    mem0 = rng.randn(n_part, IN * OUT).astype(np.float32)   # JAX layout
    jstate = jagg.FoolsGoldState(jnp.asarray(mem0))
    tstate = agg.FoolsGoldState(convert.fg_memory_from_jax(mem0, (OUT, IN)))
    kw = dict(eta=ETA, lr=0.1, momentum=0.9, weight_decay=5e-4)
    for call, (ids, masked) in enumerate((([5, 2, 7, 0, 9, 3], False),
                                          ([2, 5, 8, 1, 0, 4], True))):
        grads = _jtree(rng, (C,))
        if masked:
            grads.params["dense"]["kernel"][1, 0, 0] = np.nan
        jfeat = grads.params["dense"]["kernel"].reshape(C, -1)
        tgrads = _port(grads).params
        tfeat = tgrads["fc.weight"].reshape(C, -1)
        m = MASK if masked else None
        want = jagg.foolsgold_update(
            _jdev(g.params), _jdev(grads.params), jnp.asarray(jfeat),
            jnp.asarray(ids, jnp.int32), jstate, **kw,
            mask=None if m is None else jnp.asarray(m))
        got = agg.foolsgold_update(
            _port(g).params, tgrads, tfeat, torch.tensor(ids), tstate, **kw,
            mask=None if m is None else torch.from_numpy(m))
        _close(got.new_params, want.new_params, 1e-6)
        for a, b in ((got.wv, want.wv), (got.alpha, want.alpha)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        jmem = np.asarray(want.new_fg_state.memory)
        tmem = convert.fg_memory_to_jax(got.new_fg_state.memory, (OUT, IN))
        np.testing.assert_allclose(tmem, jmem, rtol=0, atol=1e-6)
        if masked:   # the excluded client's memory row is never written
            row = ids[1]
            assert torch.equal(got.new_fg_state.memory[row],
                               tstate.memory[row])
            assert np.isfinite(tmem).all()
        # chained: each side carries its own memory into the next call
        jstate, tstate = want.new_fg_state, got.new_fg_state


def _case_krum():
    for masked in (False, True):
        g, d, _ = _inputs(4, nan_row=masked)
        m = MASK if masked else None
        want = jagg.krum_update(_jdev(g), _jdev(d), ETA, 2, 1,
                                mask=None if m is None else jnp.asarray(m))
        got = agg.krum_update(_merged(_port(g)), _merged(_port(d)), ETA, 2,
                              1, mask=None if m is None
                              else torch.from_numpy(m))
        np.testing.assert_array_equal(got.wv.numpy(), np.asarray(want.wv))
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), rtol=1e-5)
        _close(got.new_state, want.new_state, 1e-6)


def _case_coordwise(rule):
    for masked in (False, True):
        g, d, _ = _inputs(5, nan_row=masked)
        jm = jnp.asarray(MASK) if masked else None
        tm = torch.from_numpy(MASK) if masked else None
        if rule == "trimmed_mean":
            want = jagg.trimmed_mean_update(_jdev(g), _jdev(d), ETA, 0.25,
                                            mask=jm)
            got = agg.trimmed_mean_update(_merged(_port(g)),
                                          _merged(_port(d)), ETA, 0.25,
                                          mask=tm)
        else:
            want = jagg.coordinate_median_update(_jdev(g), _jdev(d), ETA,
                                                 mask=jm)
            got = agg.coordinate_median_update(_merged(_port(g)),
                                               _merged(_port(d)), ETA,
                                               mask=tm)
        np.testing.assert_array_equal(got.wv.numpy(), np.asarray(want.wv))
        _close(got.new_state, want.new_state, 1e-6)


def _case_screen():
    _, d, _ = _inputs(6)
    d.params["dense"]["bias"][4] *= 1e4         # a blown-up client
    reported = np.array([1, 1, 1, 0, 1, 1], bool)
    fg = _jtree(np.random.RandomState(7), (C,)).params
    fg["dense"]["bias"][2, 1] = np.nan            # its accumulator is bad
    for norm_mult in (0.0, 3.0):
        for extra in (False, True):
            jm, jn = jscreen(_jdev(d), jnp.asarray(reported),
                             jnp.ones(C, bool), jnp.float32(norm_mult),
                             (_jdev(fg),) if extra else ())
            tm, tn = screen_client_updates(
                _port(d), torch.from_numpy(reported),
                torch.ones(C, dtype=torch.bool), norm_mult,
                (_port(JModelVars(fg, d.batch_stats)).params,) if extra
                else ())
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    # the corrupt, the silent and (with the norm screen) the blown-up client
    assert tm.tolist() == [True, False, False, False, False, True]
    # the norm screen's median is numpy's: two central values averaged
    for x in ([1.0, np.nan, 8.0, 2.0, 4.0], [3.0, np.nan, 1.0],
              [np.nan, np.nan]):
        x = np.array(x, np.float32)
        got = float(_nanmedian(torch.from_numpy(x)))
        want = float(np.nanmedian(x)) if np.isfinite(x).any() else np.nan
        np.testing.assert_equal(got, want)


def _case_perturb():
    fj = jflt.FaultConfig(enabled=True, dropout_prob=0.2, corrupt_prob=0.2,
                          blowup_prob=0.2, blowup_factor=1e3, stale_prob=0.2,
                          seed=0)
    fp = flt.FaultConfig(enabled=True, dropout_prob=0.2, corrupt_prob=0.2,
                         blowup_prob=0.2, blowup_factor=1e3, stale_prob=0.2,
                         seed=0)
    lanes = np.zeros((4, C), bool)   # dropped, corrupt, blowup, stale
    for lane, c in ((0, 0), (1, 2), (2, 3), (3, 5)):
        lanes[lane, c] = True
    _, d, rng = _inputs(8, nan_row=False)
    stale = _jtree(rng, (C,))
    want = jax.device_get(jflt.perturb_tree(
        _jdev(d), jflt.FaultPlan(*map(jnp.asarray, lanes)), fj,
        _jdev(stale)))
    got = flt.perturb_tree(_port(d), flt.FaultPlan(
        *map(torch.from_numpy, lanes)), fp, _port(stale))
    for k, w in _merged(_port(want)).items():   # bitwise, NaN where NaN
        np.testing.assert_array_equal(_merged(got)[k].numpy(), w.numpy())
    # the port's own plan: a pure function of (seed, epoch), lanes exclusive
    counted = torch.tensor([True] * 5 + [False])
    p1 = flt.make_fault_plan(fp, flt.fault_generator(0, 3), counted)
    p2 = flt.make_fault_plan(fp, flt.fault_generator(0, 3), counted)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    hits = torch.stack(list(p1)).to(torch.int32)
    assert int(hits.sum(0).max()) <= 1 and not bool(hits[:, 5].any())


CASES = {"fedavg_masked": _case_fedavg, "geom_median": _case_geom_median,
         "foolsgold": _case_foolsgold, "krum": _case_krum,
         "trimmed_mean": lambda: _case_coordwise("trimmed_mean"),
         "median": lambda: _case_coordwise("median"),
         "screen": _case_screen, "fault_perturb": _case_perturb}


@pytest.mark.parametrize("case", list(CASES))
def test_robust_rule_matches_jax(case):
    CASES[case]()


@pytest.mark.parametrize("override", [
    {"aggregation_methods": rule} for rule in
    ("geom_median", "foolsgold", "krum", "trimmed_mean", "median")] + [
    {"fault_injection": True, "fault_corrupt_prob": 0.2,
     "screen_updates": True, "max_round_retries": 1, "retry_backoff_s": 0.5,
     "min_surviving_clients": 2}])
def test_robust_knobs_are_ported(override):
    """config.check_ported lets the robust server's knobs through."""
    raw = yaml.safe_load(open(SMOKE))
    assert Params.from_dict(dict(raw, **override)).raw == \
        JParams.from_dict(dict(raw, **override)).raw


def test_fused_leaf_tables_fit_the_cifar_state_in_one_launch():
    """The fused kernel's leaf tables (ops/fused_update.py::_chunks): the
    CIFAR ResNet-18 state (62 parameter leaves, 40 BN leaves) is one table,
    so one launch a step, with FoolsGold's sgd_acc leaves (4 pointers each)
    or without; longer lists split at 120 leaves or 336 pointers."""
    from dba_mod_tpu_torch.ops import fused_update as fu
    sel = [("sel", (0, 0))] * 40
    for kind, n_ptr in (("sgd", 3), ("sgd_acc", 4)):
        assert len(fu._chunks([(kind, (0,) * n_ptr)] * 62 + sel)) == 1
    chunks = fu._chunks([("sgd_acc", (0,) * 4)] * 100)   # 400 pointers
    assert [len(c) for c in chunks] == [84, 16]
    chunks = fu._chunks([("sel", (0, 0))] * 130)         # 260 pointers
    assert [len(c) for c in chunks] == [120, 10]
