"""The port's models (dba_mod_tpu_torch/models) against the JAX package's
flax modules, from the same weights carried across by
dba_mod_tpu_torch/convert.py.

Bounds: 1e-5 on logits and 1e-6 on BN running stats — the two frameworks sum
convolutions and batch means in different orders in float32 (measured in
ROADMAP: about 2e-6 on CIFAR logits and 6e-8 on BN stats)."""
import jax
from pathlib import Path

import numpy as np
import pytest
import torch

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.models import ModelVars as JModelVars
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.models import build_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CFG = {"mnist": CONFIGS / "smoke_params.yaml",
       "cifar": CONFIGS / "cifar_params.yaml"}


def _pair(kind, seed=3):
    jdef = jbuild(JParams.from_yaml(CFG[kind]))
    jmv = jax.device_get(jdef.init_vars(jax.random.key(seed)))
    tdef = build_model(Params.from_yaml(CFG[kind]))
    tmv = convert.from_jax_numpy(tdef.name, jmv.params, jmv.batch_stats)
    return jdef, jmv, tdef, tmv


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax(kind, train):
    jdef, jmv, tdef, tmv = _pair(kind)
    # perturb the BN stats so eval mode exercises them: the means by
    # N(0, 0.1) (a shift of +0.1..0.5 silences every ReLU, and the eval
    # logits were then the head's bias alone), the variances by U(0.1, 0.5)
    if tmv.batch_stats:
        rng = np.random.RandomState(0)
        for k, v in tmv.batch_stats.items():
            v.add_(torch.from_numpy(
                (rng.randn(*v.shape) * 0.1 if k.endswith("mean")
                 else rng.uniform(0.1, 0.5, v.shape)).astype(np.float32)))
        _, stats = convert.to_jax_numpy(tdef.name, tmv)
        jmv = JModelVars(jmv.params, stats)
    x = np.random.RandomState(1).rand(6, *tdef.input_shape).astype(
        np.float32)
    jl, jstats = jdef.apply(jmv, x, train=train)
    tl, tstats = tdef.apply(tmv, torch.from_numpy(x), train=train)
    if tdef.has_batch_stats:
        assert float((tl - tmv.params["fc.bias"]).abs().max()) > 1e-3
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    if tdef.has_batch_stats:
        _, want = convert.to_jax_numpy(
            tdef.name, type(tmv)(tmv.params, tstats))
        for got, ref in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(jstats)):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("kind,n_params,n_leaves,n_bn",
                         [("mnist", 431080, 8, 0),
                          ("cifar", 2797610, 62, 40)])
def test_state_layout_and_round_trip(kind, n_params, n_leaves, n_bn):
    jdef, jmv, tdef, tmv = _pair(kind)
    own = tdef.init_vars(1, torch.device("cpu"))
    for mv in (tmv, own):
        assert len(mv.params) == n_leaves and len(mv.batch_stats) == n_bn
        assert sum(v.numel() for v in mv.params.values()) == n_params
    assert {k: v.shape for k, v in own.params.items()} == \
        {k: v.shape for k, v in tmv.params.items()}
    p, s = convert.to_jax_numpy(tdef.name, tmv)
    for a, b in zip(jax.tree_util.tree_leaves((p, s)),
                    jax.tree_util.tree_leaves((jmv.params,
                                               jmv.batch_stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    sim = tdef.similarity_param(tmv.params).numpy()
    np.testing.assert_array_equal(
        sim.T, np.asarray(jdef.similarity_param(jmv.params)))


def test_own_init_is_torch_default_and_seeded():
    tdef = build_model(Params.from_yaml(CFG["cifar"]))
    a = tdef.init_vars(5, torch.device("cpu"))
    b = tdef.init_vars(5, torch.device("cpu"))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    w = a.params["blocks.3.conv2.weight"]          # 64·3·3 fan-in
    bound = 1.0 / (64 * 9) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound
    assert torch.equal(a.params["stem_bn.weight"], torch.ones(32))
    assert torch.equal(a.batch_stats["stem_bn.running_var"], torch.ones(32))
