"""The port's fused per-step update (dba_mod_tpu_torch/ops/fused_update.py)
against the JAX package's, on the same numpy-made inputs.

The JAX side runs `make_fused_step_update(use_pallas=True, interpret=True)`
vmapped over the C clients, as tests/test_fused_update.py runs it on the
CPU: the Pallas kernel body in interpret mode for the rank-2 stacked leaves
and the jnp path for the rest. Against the jnp path (`use_pallas=False`) the
port's plain version is BITWISE equal: both evaluate g + wd·w, μ·m + g',
w - lr·m' as separately rounded float32 operations in the same order.
Against the Pallas interpret path the bound is 2 ulp of the element's
largest operand: XLA:CPU contracts the interpret-mode kernel body's
multiply-adds into fused multiply-adds, dropping the product's rounding
(half an ulp of the product each, on the two multiply-adds that lead to
w'). Measured in ulps of the RESULT that can be large where w - lr·m'
cancels (45 ulp seen), so the bound is stated in ulps of the operands; the
add and select lanes (fg, BN) stay bitwise. On the CPU the port's wrapper
takes the plain version and writes it into the given tensors in place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dba_mod_tpu.ops.fused_update import make_fused_step_update
from dba_mod_tpu_torch.ops import fused_update as fu


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

C = 4
MOMENTUM, DECAY = 0.9, 5e-4
# per-client leaf shapes of rank 0-4 (stacked rank 1-5)
SHAPES = {"r0": (), "r1": (33,), "r1b": (257,), "r2": (9, 130),
          "r3": (3, 5, 7), "r4": (2, 3, 4, 5)}
BN_SHAPES = {"mean": (18,), "var": (31,)}


def _inputs(seed, fg_on, bn_on):
    rng = np.random.RandomState(seed)

    def tree(shapes):
        return {k: rng.randn(C, *s).astype(np.float32)
                for k, s in shapes.items()}

    params, grads, mom = tree(SHAPES), tree(SHAPES), tree(SHAPES)
    fg = tree(SHAPES) if fg_on else {}
    bn_new = tree(BN_SHAPES) if bn_on else {}
    bn_old = tree(BN_SHAPES) if bn_on else {}
    lr = rng.uniform(0.01, 0.5, size=C).astype(np.float32)
    valid = np.array([1, 0, 1, 1], np.float32)   # client 1 is padding
    return lr, valid, params, grads, mom, fg, bn_new, bn_old


def _jax(inputs, fg_on, use_pallas=True):
    lr, valid, params, grads, mom, fg, bn_new, bn_old = inputs
    fused = make_fused_step_update(MOMENTUM, DECAY, fg_on,
                                   use_pallas=use_pallas, interpret=True)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    out = jax.vmap(fused)(jnp.asarray(lr), jnp.asarray(valid > 0), j(params),
                          j(grads), j(mom), j(fg), j(bn_new), j(bn_old))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "jnp"])
@pytest.mark.parametrize("fg_on", [False, True])
@pytest.mark.parametrize("bn_on", [False, True])
def test_plain_version_matches_jax_fused_update(use_pallas, fg_on, bn_on):
    inputs = _inputs(0, fg_on, bn_on)
    want = _jax(inputs, fg_on, use_pallas)
    lr, valid, params, grads, mom, fg, bn_new, bn_old = inputs
    got = fu.fused_step_update_reference(
        torch.from_numpy(lr), torch.from_numpy(valid), _t(params), _t(grads),
        _t(mom), _t(fg), _t(bn_new), _t(bn_old), momentum=MOMENTUM,
        weight_decay=DECAY)
    for i, (g_tree, w_tree) in enumerate(zip(got, want)):
        assert set(g_tree) == set(w_tree)
        for k in w_tree:
            if use_pallas and i < 2:   # the sgd outputs w', m'
                ops = [params[k], grads[k], mom[k], want[0][k], want[1][k]]
                scale = np.max(np.abs(np.stack(ops)), axis=0)
                bound = 2 * np.spacing(scale.astype(np.float32))
                diff = np.abs(g_tree[k].numpy() - w_tree[k])
                assert np.all(diff <= bound), (k, float(diff.max()))
            else:
                np.testing.assert_array_equal(g_tree[k].numpy(), w_tree[k],
                                              err_msg=k)


@pytest.mark.parametrize("fg_on", [False, True])
def test_cpu_wrapper_updates_in_place_and_skips_invalid_lanes(fg_on):
    inputs = _inputs(1, fg_on, True)
    lr, valid, params, grads, mom, fg, bn_new, bn_old = inputs
    tp, tm, tf, tbo = _t(params), _t(mom), _t(fg), _t(bn_old)
    before = {k: v.clone() for k, v in tp.items()}
    # grads arrive in another key order: leaves pair by key
    rev = {k: grads[k] for k in reversed(list(grads))}
    fu.fused_step_update(torch.from_numpy(lr), torch.from_numpy(valid), tp,
                         _t(rev), tm, tf, _t(bn_new), tbo,
                         momentum=MOMENTUM, weight_decay=DECAY)
    want = _jax(inputs, fg_on, use_pallas=False)
    for got, ref in zip((tp, tm, tf, tbo), want):
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])
    for k, v in tp.items():       # client 1 is invalid: bit-untouched
        assert torch.equal(v[1], before[k][1])
        assert not torch.equal(v[0], before[k][0])
    assert fu.fused_step_update.launches == 0   # no kernel on the CPU


def test_wrapper_rejects_what_the_kernel_does_not_take():
    lr, valid = torch.ones(2), torch.ones(2)
    w = {"a": torch.zeros(2, 3)}

    def call(params, grads, mom, lr=lr, valid=valid):
        fu.fused_step_update(lr, valid, params, grads, mom, {}, {}, {},
                             momentum=0.9, weight_decay=0.0)

    with pytest.raises(TypeError):
        call({"a": torch.zeros(2, 3, dtype=torch.float64)}, w, w)
    with pytest.raises(ValueError):
        call({"a": torch.zeros(3, 2).t()}, w, w)          # non-contiguous
    with pytest.raises(ValueError):
        call({"a": torch.zeros(3, 3)}, w, w)              # wrong C
    with pytest.raises(ValueError):
        call(w, {"a": torch.zeros(2, 4)}, w)              # shape mismatch
    with pytest.raises(ValueError):
        call(w, w, w, valid=torch.ones(3))                # lr/valid shapes
    with pytest.raises(ValueError):
        call(w, {"b": torch.zeros(2, 3)}, w)              # keys differ
