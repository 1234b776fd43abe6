"""The Tiny-ImageNet workload of the port (dba_mod_tpu_torch) against the JAX
package, from the same weights carried across by convert.py.

Bounds: one full-width forward pass 1e-5 on logits and 1e-6 on BN running
stats (tests/test_torch_models.py's for CIFAR); one identical-state round
of benchmarks/parity_ab.py::TINY_AB 0.4 per client and 0.15 on the global
model, accuracies within 1 point (tests/test_parity_ab.py's: float32
convolutions sum in another order in XLA and in torch, and activations
within that band of zero flip ReLU gates)."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from pathlib import Path

from benchmarks.parity_ab import TINY_AB
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.data import datasets as jdatasets
from dba_mod_tpu.fl.state import build_client_tasks as jtasks
from dba_mod_tpu.models import ModelVars as JModelVars
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu.models.norm import TorchBatchNorm
from dba_mod_tpu.ops import triggers as jtriggers
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.data import datasets
from dba_mod_tpu_torch.fl.state import build_client_tasks
from dba_mod_tpu_torch.models import _resnet, build_model, resnet
from dba_mod_tpu_torch.models.resnet import TINY18
from dba_mod_tpu_torch.ops import triggers
from test_torch_slice import (_check_acc, _engine_round, _experiments,
                              shared_cache)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny_pair():
    """The full-width Tiny ResNet-18 in both packages, the same weights."""
    raw = yaml.safe_load(open(CONFIGS / "tiny_params.yaml"))
    jdef = jbuild(JParams.from_dict(raw))
    jmv = jax.device_get(jdef.init_vars(jax.random.key(3)))
    tdef = build_model(Params.from_dict(raw))
    tmv = convert.from_jax_numpy(tdef.name, jmv.params, jmv.batch_stats)
    return jdef, jmv, tdef, tmv


def _tiny_forward(tiny_pair, train, tmv=None):
    """(JAX logits, JAX stats, port logits, port stats in the flax layout)
    of one forward pass at batch 2 of 64×64."""
    jdef, jmv, tdef, own = tiny_pair
    tmv = own if tmv is None else tmv
    jmv = JModelVars(jmv.params, convert.to_jax_numpy(tdef.name, tmv)[1])
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    jl, jstats = jdef.apply(jmv, x, train=train)
    with torch.no_grad():
        tl, tstats = tdef.apply(tmv, torch.from_numpy(x), train=train)
    _, tstats = convert.to_jax_numpy(tdef.name, type(tmv)(tmv.params,
                                                          tstats))
    return np.asarray(jl), jstats, tl.numpy(), tstats


@pytest.mark.parametrize("train", [False, True])
def test_tiny_forward_matches_flax(tiny_pair, train):
    tmv = tiny_pair[3]
    if not train:
        # perturbed BN stats, so eval mode exercises them
        rng = np.random.RandomState(0)
        tmv = type(tmv)(tmv.params, {k: v + torch.from_numpy(
            rng.uniform(0.1, 0.5, v.shape).astype(np.float32))
            for k, v in tmv.batch_stats.items()})
    jl, jstats, tl, tstats = _tiny_forward(tiny_pair, train, tmv)
    assert tl.shape == (2, 200)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    if not train:       # eval mode returns the running stats unchanged
        for got, ref in zip(jax.tree_util.tree_leaves(tstats),
                            jax.tree_util.tree_leaves(jstats)):
            np.testing.assert_array_equal(got, np.asarray(ref))


def _f64_stats(tiny_pair):
    """The running stats after the same train-mode pass in float64: the
    port's model built to compute in float64, on float64 copies of the
    weights and the input."""
    _, _, tdef, tmv = tiny_pair
    _, apply64 = _resnet(TINY18, 200, torch.float64)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        _, s64 = apply64({k: v.double() for k, v in tmv.params.items()},
                         {k: v.double() for k, v in tmv.batch_stats.items()},
                         torch.from_numpy(x).double(), True, None)
    return jax.tree_util.tree_leaves(convert.to_jax_numpy(
        tdef.name, type(tmv)(tmv.params, s64))[1])


def test_tiny_train_bn_stats_match_flax(tiny_pair):
    """The running stats after one train-mode pass from the init stats,
    each package held against the same pass in float64: the port must be
    no further from it than 1.25 × the JAX package is, and within 2e-6.
    The two packages differ by up to 1.8e-6 from each other, above 1e-6,
    but each BatchNorm layer fed the same input agrees to 1e-6
    (test_tiny_bn_layers_match_flax_on_the_same_input): the gap is the
    float32 accumulation of the convolutions upstream (XLA and cuDNN/oneDNN
    sum in other orders), and layer 4 averages 8 values a channel."""
    _, jstats, _, tstats = _tiny_forward(tiny_pair, True)
    got = jax.tree_util.tree_leaves(tstats)
    ref = [np.asarray(r) for r in jax.tree_util.tree_leaves(jstats)]
    f64 = _f64_stats(tiny_pair)
    errs = {side: max(float(np.abs(a - b).max()) for a, b in zip(v, f64))
            for side, v in (("jax", ref), ("port", got))}
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    print(f"BN running stats: port vs JAX {diff:.3g}; distance from "
          f"float64: {errs}")
    assert errs["port"] <= 1.25 * errs["jax"], errs
    assert errs["port"] <= 2e-6, errs


def test_tiny_bn_layers_match_flax_on_the_same_input(tiny_pair):
    """Every BatchNorm layer of the full Tiny ResNet-18, fed the SAME
    float32 input — its real input in one train-mode pass, captured from
    the port's forward — in both packages. The running stats agree to
    1e-6. The outputs (|y| up to 5) are held against the same layer in
    float64: neither package is within 1e-6 of it (the JAX package is
    7.0e-6 from it at the stem, float32's E[x²]−E[x]² at ~6 ulp), so the
    port's worst distance from float64 must be at most 1.25 × the JAX
    package's, and the two within 1e-5 of each other. The BN function adds
    nothing to the whole-net gap."""
    _, _, tdef, tmv = tiny_pair
    seen = []
    real = resnet.batch_norm

    def capture(x, scale, bias, ra_mean, ra_var, train):
        seen.append((x, scale, bias, ra_mean, ra_var))
        return real(x, scale, bias, ra_mean, ra_var, train)

    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    resnet.batch_norm = capture
    try:
        with torch.no_grad():
            tdef.apply(tmv, torch.from_numpy(x), train=True)
    finally:
        resnet.batch_norm = real
    assert len(seen) == 20            # stem + 16 in blocks + 3 shortcuts
    worst = {"mean": 0.0, "var": 0.0, "y": 0.0, "port_y_f64": 0.0,
             "jax_y_f64": 0.0}
    for xin, scale, bias, mean, var in seen:
        y, m, v = real(xin, scale, bias, mean, var, True)
        y64, _, _ = real(xin.double(), scale.double(), bias.double(),
                         mean.double(), var.double(), True)
        variables = {"params": {"scale": scale.numpy(), "bias": bias.numpy()},
                     "batch_stats": {"mean": mean.numpy(),
                                     "var": var.numpy()}}
        jy, upd = TorchBatchNorm(use_running_average=False).apply(
            variables, jnp.asarray(xin.permute(0, 2, 3, 1).numpy()),
            mutable=["batch_stats"])
        y, y64 = y.permute(0, 2, 3, 1).numpy(), y64.permute(0, 2, 3, 1)
        for k, got, want in (
                ("mean", m.numpy(), upd["batch_stats"]["mean"]),
                ("var", v.numpy(), upd["batch_stats"]["var"]), ("y", y, jy),
                ("port_y_f64", y, y64.numpy()),
                ("jax_y_f64", np.asarray(jy), y64.numpy())):
            worst[k] = max(worst[k], float(np.abs(
                got - np.asarray(want)).max()))
    print(f"per-layer BN on the same input: {worst}")
    assert worst["mean"] <= 1e-6 and worst["var"] <= 1e-6, worst
    assert worst["port_y_f64"] <= 1.25 * worst["jax_y_f64"], worst
    assert worst["y"] <= 1e-5, worst


def test_stem_max_pool_pads_with_minus_inf():
    """The imagenet stem's 3×3/s2 max pool, padding 1, on all-negative
    input: a zero-padded pool would put 0 on the border; both packages pad
    with -inf."""
    x = -1.0 - np.random.RandomState(2).rand(2, 9, 9, 4).astype(np.float32)
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding=((1, 1), (1, 1)))
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                       padding=1).permute(0, 2, 3, 1)
    assert float(got.max()) < -1.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiny_init_statistics_and_convert_round_trip(tiny_pair):
    jdef, jmv, tdef, tmv = tiny_pair
    own = tdef.init_vars(1, torch.device("cpu"))
    for mv in (tmv, own):
        assert len(mv.params) == 62 and len(mv.batch_stats) == 40
        assert sum(v.numel() for v in mv.params.values()) == 11_279_112
        assert sum(v.numel() for v in mv.batch_stats.values()) == 9_600
    assert {k: v.shape for k, v in own.params.items()} == \
        {k: v.shape for k, v in tmv.params.items()}
    assert own.params["stem_conv.weight"].shape == (64, 3, 7, 7)
    # kaiming_normal(fan_out): layer4's 3×3 conv, fan_out 512·9
    want_std = (2.0 / (512 * 9)) ** 0.5
    for w in (own.params["blocks.7.conv2.weight"],
              tmv.params["blocks.7.conv2.weight"]):
        assert abs(float(w.std()) / want_std - 1.0) < 0.05
        assert abs(float(w.mean())) < 0.05 * want_std
    # the head keeps the torch-default uniform init (head_init None)
    bound = 1.0 / 512 ** 0.5
    assert float(own.params["fc.weight"].abs().max()) <= bound
    assert torch.equal(own.params["blocks.7.bn2.weight"], torch.ones(512))
    a, b = tdef.init_vars(5, torch.device("cpu")), tdef.init_vars(
        5, torch.device("cpu"))
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    p, s = convert.to_jax_numpy(tdef.name, tmv)
    for x, y in zip(jax.tree_util.tree_leaves((p, s)),
                    jax.tree_util.tree_leaves((jmv.params,
                                               jmv.batch_stats))):
        np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(
        tdef.similarity_param(tmv.params).numpy().T,
        np.asarray(jdef.similarity_param(jmv.params)))


def test_tiny_data_triggers_and_tasks_equal_jax(tmp_path):
    """The synthetic Tiny set (several of the port's noise chunks), the
    npz cache reader, and configs/tiny_params.yaml's 4 adversaries with
    2×10-pixel sub-triggers: not centralized, the combined row is the
    union, and a poisoning round's task rows are the JAX package's."""
    j = jdatasets.synthetic_image_dataset("tiny-imagenet-200", 700, 120,
                                          seed=1)
    t = datasets.synthetic_image_dataset("tiny-imagenet-200", 700, 120,
                                         seed=1)
    for name in ("train_images", "train_labels", "test_images",
                 "test_labels"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.savez(tmp_path / "tiny-imagenet-200.npz", train_x=t.train_images,
             train_y=t.train_labels, test_x=t.test_images,
             test_y=t.test_labels)
    cached = datasets.load_tiny_imagenet(str(tmp_path))
    np.testing.assert_array_equal(cached.train_images, t.train_images)
    assert cached.num_classes == 200 and not cached.synthetic
    assert datasets.load_tiny_imagenet(str(tmp_path / "none")) is None

    raw = yaml.safe_load(open(CONFIGS / "tiny_params.yaml"))
    jp, tp = JParams.from_dict(raw), Params.from_dict(raw)
    assert not tp.is_centralized_attack and tp.num_adversaries == 4
    bank = triggers.build_pixel_pattern_bank(tp, 64, 64)
    np.testing.assert_array_equal(
        bank, jtriggers.build_pixel_pattern_bank(jp, 64, 64))
    assert bank.shape == (5, 64, 64) and bank[4].sum() == 80
    np.testing.assert_array_equal(bank[4], bank[:4].max(axis=0))
    names = [0, 20, 5, 74, 9]
    slots = np.zeros(len(names), np.int64)
    for epoch in (21, 23, 24):
        got = build_client_tasks(tp, names, epoch, slots, 10)
        want = jtasks(jp, names, epoch, slots, 10, None)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert list(build_client_tasks(tp, names, 23, slots, 10).adv_index) \
        == [-1, 1, -1, -1, -1]


def test_tiny_round_matches_jax(tmp_path, tmp_path_factory):
    """benchmarks/parity_ab.py::TINY_AB: one identical-state round with
    its lone (centralized, combined-trigger) adversary poisoning."""
    jexp, texp = _experiments(dict(TINY_AB), tmp_path, save=False)
    assert texp.params.is_centralized_attack
    per_client, g_diff, jev, tev = _engine_round(
        jexp, texp, 1, share=("TINY_AB", TINY_AB["scale_weights_poison"],
                              shared_cache(tmp_path_factory)))
    assert max(per_client) <= 0.4, per_client
    assert g_diff <= 0.15, g_diff
    _check_acc(jev, tev)


def test_tiny_model_replacement_drives_running_var_negative_in_both(
        tmp_path, tmp_path_factory):
    """configs/tiny_params.yaml scales the adversary ×100, as CIFAR's does,
    and FedAvg averages the BN running stats with the scaled delta: on the
    card the first poisoned Tiny round's global eval loss is NaN (PERF.md).
    The JAX package does the same from the same weights: TINY_AB at
    γ = 100 leaves the least running variance negative on both sides, in
    the same layer and channel, and both global eval losses NaN. The two
    agree to 1e-4 relative (measured -12.770258 JAX, -12.770022 port, 1.8e-5:
    γ = 100 multiplies the per-client differences of the γ = 2 round by
    50)."""
    jexp, texp = _experiments(dict(TINY_AB, scale_weights_poison=100.0),
                              tmp_path, save=False)
    _, _, jev, tev = _engine_round(
        jexp, texp, 1, share=("TINY_AB", TINY_AB["scale_weights_poison"],
                              shared_cache(tmp_path_factory)))
    assert np.isnan(float(jev.clean.loss)) and np.isnan(float(tev.clean.loss))
    jg = jax.device_get(jexp.global_vars)
    tvars = convert.to_jax_numpy(texp.model_def.name, texp.global_vars)[1]
    leaves = []
    for side in (jg.batch_stats, tvars):
        flat = jax.tree_util.tree_flatten_with_path(side)[0]
        var = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat
               if jax.tree_util.keystr(k).endswith("['var']")}
        name = min(var, key=lambda k: var[k].min())
        leaves.append((name, int(var[name].argmin()),
                       float(var[name].min())))
    (jname, jch, jmin), (tname, tch, tmin) = leaves
    assert jmin < 0 and tmin < 0, leaves
    assert (jname, jch) == (tname, tch), leaves
    assert abs(tmin - jmin) <= 1e-4 * abs(jmin), leaves


def test_fused_leaf_tables_cover_tiny_and_loan_in_one_launch():
    """The fused kernel's leaf table at the two new sizes: the Tiny
    ResNet-18's 62 + 40 leaves and LoanNet's 6 are one table each (one
    launch a step, FoolsGold on or off), and the tile layout of the Tiny
    state stays far inside the kernel's int32 indices."""
    from dba_mod_tpu_torch.ops import fused_update as fu
    C = 10
    for config, n_sel in (("tiny_params.yaml", 40), ("loan_params.yaml", 0)):
        mv = build_model(Params.from_yaml(CONFIGS / config)).init_vars(
            0, torch.device("cpu"))
        assert len(mv.batch_stats) == n_sel
        for kind, n_ptr in (("sgd", 3), ("sgd_acc", 4)):
            entries = ([(kind, (0,) * n_ptr)] * len(mv.params)
                       + [("sel", (0, 0))] * n_sel)
            assert len(fu._chunks(entries)) == 1
        sizes = [v.numel() for v in list(mv.params.values())
                 + list(mv.batch_stats.values())]
        starts = fu._layout(sizes, C)
        assert starts[-1] == C * sum(-(-n // fu._TILE) for n in sizes)
    assert max(sizes) == 46 * 91 and starts[-1] == 70
    tiny = build_model(Params.from_yaml(CONFIGS / "tiny_params.yaml"))
    sizes = [v.numel() for v in tiny.init_vars(0, torch.device("cpu"))
             .params.values()]
    assert max(sizes) == 512 * 512 * 9
    assert fu._layout(sizes, C)[-1] < 30_000
    with pytest.raises(ValueError, match="int32"):
        fu._layout([2 ** 31 - 100], C)
    with pytest.raises(ValueError, match="grid"):
        fu._layout([2 ** 30] * 900, C)
