"""The deeper CIFAR ResNets (dba_mod_tpu_torch/models/resnet.py CIFAR34,
CIFAR50, CIFAR101, CIFAR152; the JAX package's cifar_resnet34/50/101/152)
against the flax modules, from the same weights carried across by
dba_mod_tpu_torch/convert.py.

Bounds are tests/test_torch_models.py's: logits 1e-5 and BN running stats
1e-6 at batch 2. Eval mode holds them at every depth. In train mode the
port's and flax's float64 passes agree to 1e-10, and where depth's float32
accumulation takes the float32 pass past the flax bounds (ResNet-50 on:
each package alone is 2e-5 to 4e-4 from flax's float64 pass), the port is
held within a cap of flax (CAP) and to the rule test_torch_tiny.py holds
Tiny-ImageNet's BatchNorm to: no further from flax's float64 pass than
1.25x flax's own float32 pass is. The parameter count is the flax tree's,
and the port → flax → port trip is bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dba_mod_tpu.models import norm as jnorm
from dba_mod_tpu.models import resnet as jresnet
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.models import (ModelVars, cifar_resnet34,
                                      cifar_resnet50, cifar_resnet101,
                                      cifar_resnet152, resnet)

# float64 port vs float64 flax, train mode (read: 5e-15 for ResNet-34 up to
# 1.3e-12 for -152); and where the float32 pass exceeds the flax bounds,
# its cap against flax's float32 pass, 2.5x to 4x the readings (logits /
# stats: ResNet-50 1.8e-5 to 2.9e-5 / 3.8e-6, -101 9.9e-5 to 1.7e-4 /
# 6.3e-5 to 8.5e-5, -152 4.2e-4 to 4.8e-4 / 3.9e-4; ResNet-34 holds the
# flax bounds)
F64 = 1e-10
CAP = {"34": {"logits": 1e-5, "stats": 1e-6},
       "50": {"logits": 1e-4, "stats": 1.5e-5},
       "101": {"logits": 5e-4, "stats": 2e-4},
       "152": {"logits": 1.5e-3, "stats": 1.2e-3}}
NETS = {"34": (jresnet.cifar_resnet34, cifar_resnet34),
        "50": (jresnet.cifar_resnet50, cifar_resnet50),
        "101": (jresnet.cifar_resnet101, cifar_resnet101),
        "152": (jresnet.cifar_resnet152, cifar_resnet152)}


def _pair(depth):
    """The flax module, its variables, the port's ModelDef and the input;
    the weights are the port's own init carried to flax (flax's own init
    is slow at these depths; test_layout_count_and_round_trip holds the
    trees to flax's)."""
    jmod_fn, tdef_fn = NETS[depth]
    jmod, tdef = jmod_fn(), tdef_fn()
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    p, s = convert.to_jax_numpy(tdef.name,
                                tdef.init_vars(3, torch.device("cpu")))
    return jmod, {"params": p, "batch_stats": s}, tdef, x


class _Wide:
    """jax.numpy with ``float32`` read as float64. The flax ResNet casts to
    a fixed float32 in places (its BatchNorm statistics and normalization,
    the logits); with this in their modules' ``jnp``, x64 on and the
    module's dtype float64, the forward runs as a float64 pass."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _flax64(jmod, jv, stats, x, monkeypatch):
    """flax's train-mode forward as a float64 pass: (logits, new stats).
    Jitted: one program compiles faster than eager flax's op by op."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        for mod in (jresnet, jnorm):
            m.setattr(mod, "jnp", _Wide())
        wide = lambda t: jax.tree_util.tree_map(
            lambda l: jnp.asarray(l, jnp.float64), t)
        jl, upd = jax.jit(lambda v, xx: jmod.clone(dtype=jnp.float64).apply(
            v, xx, train=True, mutable=["batch_stats"]))(
            {"params": wide(jv["params"]), "batch_stats": wide(stats)},
            jnp.asarray(x, jnp.float64))
        return jax.device_get((jl, upd["batch_stats"]))


def _dist(a, b):
    return max(float(np.abs(np.asarray(u, np.float64) - v).max())
               for u, v in zip(a, b))


@pytest.mark.parametrize("depth", list(NETS))
def test_forward_matches_flax(depth, monkeypatch):
    """Train mode (batch statistics, updated running stats) and eval mode
    (running stats moved off their init: means by N(0, 0.1), variances by
    U(0.1, 0.5)) through each net, against flax. Eval mode holds the flax
    bounds. Train mode: the port's and flax's float64 passes (flax's fixed
    float32 casts widened) agree to F64; the float32 logits and stats hold
    the flax bounds, or, where depth's float32 accumulation takes them past
    (ResNet-50 on), stay within CAP of flax's and no further from flax's
    float64 pass than 1.25x flax's own float32 pass is."""
    jmod, jv, tdef, x = _pair(depth)
    tmv = convert.from_jax_numpy(tdef.name, jv["params"], jv["batch_stats"])
    rng = np.random.RandomState(0)
    for k, v in tmv.batch_stats.items():
        v.add_(torch.from_numpy(
            (rng.randn(*v.shape) * 0.1 if k.endswith("mean")
             else rng.uniform(0.1, 0.5, v.shape)).astype(np.float32)))
    stats = convert.to_jax_numpy(tdef.name, tmv)[1]
    leaves = jax.tree_util.tree_leaves
    variables = {"params": jv["params"], "batch_stats": stats}

    jl = jmod.apply(variables, x, train=False)
    tl, _ = tdef.apply(tmv, torch.from_numpy(x), train=False)
    # eval mode must see live features, not a head fed zeros
    assert float((tl - tmv.params["fc.bias"]).abs().max()) > 1e-3
    assert _dist([tl.numpy()], [jl]) <= 1e-5

    jl, upd = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    tl, tstats = tdef.apply(tmv, torch.from_numpy(x), train=True)
    with torch.no_grad():
        l64, s64 = resnet.apply(
            {k: v.double() for k, v in tmv.params.items()},
            {k: v.double() for k, v in tmv.batch_stats.items()},
            torch.from_numpy(x).double(), True, tdef.resnet_spec,
            torch.float64)
    jl64, jstats64 = _flax64(jmod, jv, stats, x, monkeypatch)
    port_stats = lambda st: leaves(convert.to_jax_numpy(
        tdef.name, ModelVars(tmv.params, st))[1])
    for what, port, port64, flax, flax64, bound in (
            ("logits", [tl.numpy()], [l64.numpy()], [jl], [jl64], 1e-5),
            ("stats", port_stats(tstats), port_stats(s64),
             leaves(upd["batch_stats"]), leaves(jstats64), 1e-6)):
        d64 = _dist(port64, flax64)
        diff = _dist(port, flax)
        d_port, d_jax = _dist(port, flax64), _dist(flax, flax64)
        print(f"{what}: float64 port vs flax {d64:.3g}; port vs flax "
              f"{diff:.3g}; from flax's float64 pass: port {d_port:.3g}, "
              f"flax {d_jax:.3g}")
        assert d64 <= F64, (what, d64)
        if diff > bound:
            assert diff <= CAP[depth][what], (what, diff)
            assert d_port <= 1.25 * d_jax, (what, d_port, d_jax)


@pytest.mark.parametrize("depth", list(NETS))
def test_layout_count_and_round_trip(depth):
    """convert.py maps the port's init onto flax's tree: the same module
    paths and shapes as flax's own init (taken abstractly), the flax
    parameter count; the port → flax → port trip is bitwise and the
    similarity layer is the head's kernel."""
    jmod, jv, tdef, x = _pair(depth)
    want = jax.eval_shape(lambda: jmod.init(jax.random.key(3), x,
                                            train=False))
    for part in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(jv[part]) == \
            jax.tree_util.tree_structure(dict(want[part]))
        assert [np.shape(l) for l in jax.tree_util.tree_leaves(jv[part])] \
            == [l.shape for l in jax.tree_util.tree_leaves(want[part])]
    own = tdef.init_vars(3, torch.device("cpu"))
    assert sum(v.numel() for v in own.params.values()) == sum(
        l.size for l in jax.tree_util.tree_leaves(want["params"]))
    back = convert.from_jax_numpy(tdef.name, jv["params"],
                                  jv["batch_stats"])
    for a, b in ((own.params, back.params),
                 (own.batch_stats, back.batch_stats)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(
        tdef.similarity_param(own.params).numpy().T,
        jv["params"]["Dense_0"]["kernel"])
