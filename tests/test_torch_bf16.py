"""bf16 compute (compute_dtype: bfloat16) in the port against the JAX
package, on the CPU from the same weights (convert.py).

Forward and backward run in bf16 while the parameters, the gradients, the
BN running stats and the logits stay float32, in both packages. For each of
the four models (MNIST, the narrow CIFAR ResNet-18, a narrowed Tiny
ResNet-18 — the imagenet stem at widths 16-128 on 32×32 inputs — and LOAN
with the flax module's own dropout masks), from the same inputs:

- bf16 logits agree to 2e-2 × max|logit|, or, where bf16 itself moves the
  JAX package's logits further than that from its float32 ones (the
  narrowed Tiny net: 0.155 at max|logit| 2.87), to 1.5 × that move — two
  bf16 roundings of one computation sit about √2 of one rounding's error
  apart;
- the port's bf16 logits are no further from its own float32 logits than
  1.5 × the JAX package's bf16 logits are from its float32 ones (the port
  rounds at the places flax rounds, so it is no less accurate);
- the one-step gradient (float32, of the float32 params) over all leaves:
  the two packages' bf16 gradients are no further apart, in relative norm,
  than 1.5 × the JAX package's bf16 gradient is from its own float32 one,
  and the port's bf16 gradient is no further from its float32 gradient
  than 1.5 × the JAX package's. A fixed 2e-2 per leaf cannot hold: at
  init, bf16 moves the JAX package's own gradient 3% (MNIST, LOAN 9%) to
  31% (CIFAR) and 52% (narrow Tiny) in relative norm from its float32
  gradient — BatchNorm's backward cancels, and bf16 keeps 8 bits — and
  the port's moves as far.

One MNIST_AB round (the identical-state lane of benchmarks/parity_ab.py,
both adversaries poisoning) in bf16 through each engine: the same plans,
accuracies within 1 point; the global-model distance is printed. The fused
update runs on float32 leaves under bf16 too (asserted on the gradients)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from benchmarks.parity_ab import MNIST_AB_R1, _loan_mask_probe
from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu.models.resnet import ResNet, kaiming_normal_fan_out
from dba_mod_tpu.ops.losses import cross_entropy as jce
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.models import (ModelVars, _resnet, build_model,
                                      compute_dtype_of)
from dba_mod_tpu_torch.models.resnet import ResNetSpec
from dba_mod_tpu_torch.ops.losses import cross_entropy
from test_torch_slice import _check_acc, _engine_round, _experiments

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
YAML = {"mnist": "smoke_params.yaml", "cifar": "cifar_params.yaml",
        "tiny": "tiny_params.yaml", "loan": "loan_params.yaml"}
NARROW_TINY = (16, 32, 64, 128)
INPUT = {"mnist": (28, 28, 1), "cifar": (32, 32, 3), "tiny": (32, 32, 3),
         "loan": (91,)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _defs(kind, dtype):
    raw = dict(yaml.safe_load(open(CONFIGS / YAML[kind])),
               compute_dtype=dtype)
    jdef = jbuild(JParams.from_dict(raw))
    tdef = build_model(Params.from_dict(raw))
    if kind == "tiny":
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jdef = dataclasses.replace(jdef, module=ResNet(
            num_classes=200, widths=NARROW_TINY, stem="imagenet",
            pool="global", kernel_init=kaiming_normal_fan_out, dtype=jdt),
            input_shape=INPUT["tiny"])
        spec = ResNetSpec(widths=NARROW_TINY, stem="imagenet", pool="global",
                          conv_init="kaiming_normal_fan_out")
        init, apply = _resnet(spec, 200, tdef.dtype)
        tdef = dataclasses.replace(tdef, _init=init, _apply=apply,
                                   input_shape=INPUT["tiny"])
    return jdef, tdef


def test_compute_dtype_of():
    raw = yaml.safe_load(open(CONFIGS / "smoke_params.yaml"))
    for name, want in (("float32", torch.float32), ("f32", torch.float32),
                       ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16)):
        assert compute_dtype_of(Params.from_dict(
            dict(raw, compute_dtype=name))) == want
    with pytest.raises(ValueError, match="compute_dtype"):
        compute_dtype_of(Params.from_dict(dict(raw, compute_dtype="f16")))


@pytest.mark.parametrize("kind", ["mnist", "cifar", "tiny", "loan"])
def test_bf16_forward_and_grad_match_jax(kind):
    j16, t16 = _defs(kind, "bfloat16")
    j32, t32 = _defs(kind, "float32")
    jmv = jax.device_get(j32.init_vars(jax.random.key(3)))
    tmv = convert.from_jax_numpy(t32.name, jmv.params, jmv.batch_stats)
    B = 8 if kind != "loan" else 32
    rng = np.random.RandomState(1)
    x = rng.rand(B, *INPUT[kind]).astype(np.float32)
    y = rng.randint(0, t32.num_classes, B)
    train = kind != "loan"
    jkw, tkw = {}, {}
    if kind == "loan":
        # train mode with the flax module's own dropout masks
        train, key = True, jax.random.key(5)
        m0, m1 = _loan_mask_probe(j32.module, B)(key[None])
        jkw = {"dropout_rng": key}
        tkw = {"dropout": tuple(torch.from_numpy(np.asarray(m)[0] > 0.5)
                                for m in (m0, m1))}

    def jloss(params, jdef):
        logits, _ = jdef.apply(type(jmv)(params, jmv.batch_stats),
                               jnp.asarray(x), train=train, **jkw)
        return jce(logits, jnp.asarray(y)), logits

    def tloss(params, tdef):
        logits, _ = tdef.apply(ModelVars(params, tmv.batch_stats),
                               torch.from_numpy(x), train=train, **tkw)
        return cross_entropy(logits, torch.from_numpy(y)), logits

    jlog, grads = {}, {}
    for name, jdef in (("bf16", j16), ("f32", j32)):
        (_, jl), jg = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, jdef), has_aux=True))(jmv.params)
        jlog[name] = np.asarray(jl)
        grads["jax", name] = [np.asarray(g) for g in
                              jax.tree_util.tree_leaves(jg)]
    tlog = {}
    for name, tdef in (("bf16", t16), ("f32", t32)):
        tparams = {k: v.clone().requires_grad_(True)
                   for k, v in tmv.params.items()}
        loss, tl = tloss(tparams, tdef)
        tg = torch.autograd.grad(loss, list(tparams.values()))
        # the fused kernel's leaves: float32 gradients of float32 params
        assert all(g.dtype == torch.float32 for g in tg)
        tlog[name] = tl.detach().numpy()
        grads["port", name] = jax.tree_util.tree_leaves(convert.to_jax_numpy(
            t32.name, ModelVars(dict(zip(tparams, tg)), tmv.batch_stats))[0])
    tl16, tl32 = tlog["bf16"], tlog["f32"]
    assert tl16.dtype == np.float32 and jlog["bf16"].dtype == np.float32

    scale = float(np.abs(jlog["bf16"]).max())
    diff = float(np.abs(tl16 - jlog["bf16"]).max())
    port_err = float(np.abs(tl16 - tl32).max())
    jax_err = float(np.abs(jlog["bf16"] - jlog["f32"]).max())
    assert diff <= max(2e-2 * scale, 1.5 * jax_err), (diff, scale, jax_err)
    assert port_err <= 1.5 * jax_err, (port_err, jax_err)

    def rel(a, b):
        va, vb = (np.concatenate([g.ravel() for g in grads[k]])
                  for k in (a, b))
        assert va.dtype == vb.dtype == np.float32
        return float(np.linalg.norm(va - vb) / np.linalg.norm(vb))

    between = rel(("port", "bf16"), ("jax", "bf16"))
    jax_g = rel(("jax", "bf16"), ("jax", "f32"))
    port_g = rel(("port", "bf16"), ("port", "f32"))
    assert between <= 1.5 * jax_g, (between, jax_g)
    assert port_g <= 1.5 * jax_g, (port_g, jax_g)
    print(f"{kind}: bf16 logits port vs JAX {diff:.3g} (max|logit| "
          f"{scale:.3g}), from float32: port {port_err:.3g}, JAX "
          f"{jax_err:.3g}; gradient port vs JAX {between:.3g}, from "
          f"float32: port {port_g:.3g}, JAX {jax_g:.3g}")


def test_mnist_bf16_round_matches_jax(tmp_path):
    jexp, texp = _experiments(dict(MNIST_AB_R1, compute_dtype="bfloat16"),
                              tmp_path, save=False)
    assert texp.device_data.compute_dtype == torch.bfloat16
    per_client, g_diff, jev, tev = _engine_round(jexp, texp, 1)
    _check_acc(jev, tev)
    for p in texp.global_vars.params.values():
        assert p.dtype == torch.float32
    print(f"MNIST_AB bf16 round: per-client delta diffs {per_client}, "
          f"global-model distance {g_diff:.3g}; clean acc JAX "
          f"{float(jev.clean.acc):.2f} port {float(tev.clean.acc):.2f}")
