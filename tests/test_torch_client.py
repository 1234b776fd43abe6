"""One stacked MNIST client-step segment of the port (fl/client.py) against
the JAX package's vmapped client step, on the same weights (convert.py),
the same task rows and the same batch plans.

Covers a poison lane (MultiStepLR row, stamping, fresh momentum, ×scale
epilogue), benign lanes continuing a carried momentum, a client with fewer
samples than the plan width (masked steps) and an all-padding epoch. MNIST
has no BatchNorm and no ReLU-gate chaos at this size: deltas agree to
float roundoff (bound 1e-6, as tests/test_parity_ab.py's MNIST round).
With FoolsGold on, the step's gradient accumulators (the fused update's
`sgd_acc` leaves) agree with the JAX client step's `fg_grads` to 1e-5
relative to the largest accumulated value: they are sums of raw gradients
over the segment's steps, not lr-scaled like the deltas."""
import jax
import jax.numpy as jnp
from pathlib import Path

import numpy as np
import pytest
import torch

from dba_mod_tpu.config import Params as JParams
from dba_mod_tpu.fl.client import make_client_step as jmake
from dba_mod_tpu.fl.device_data import make_image_device_data as jdevdata
from dba_mod_tpu.fl.state import RoundHyper as JHyper
from dba_mod_tpu.fl.state import build_client_tasks as jtasks
from dba_mod_tpu.models import build_model as jbuild
from dba_mod_tpu_torch import convert
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.data.batching import build_batch_plan
from dba_mod_tpu_torch.data.datasets import synthetic_image_dataset
from dba_mod_tpu_torch.fl.client import make_client_step
from dba_mod_tpu_torch.fl.device_data import make_image_device_data
from dba_mod_tpu_torch.fl.state import RoundHyper, build_client_tasks
from dba_mod_tpu_torch.models import ModelVars, build_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


@pytest.mark.parametrize("fg_on", [False, True], ids=["fg_off", "fg_on"])
def test_mnist_client_segment_matches_jax(fg_on):
    import yaml
    raw = yaml.safe_load(open(CONFIGS / "smoke_params.yaml"))
    raw.update(internal_epochs=2, internal_poison_epochs=5)  # milestones fire
    tp, jp = Params.from_dict(raw), JParams.from_dict(raw)
    data = synthetic_image_dataset("mnist", 120, 32, seed=2)
    names, epoch = [0, 5, 7], 3            # adversary 0 poisons at epoch 3
    E, B = 5, 16
    tasks = build_client_tasks(tp, names, epoch, np.zeros(3, np.int64), E)
    jt = jtasks(jp, names, epoch, np.zeros(3, np.int64), E, None)
    assert int(tasks.poisoning_per_batch[0]) > 0
    clients = [list(range(0, 40)), list(range(40, 70)), list(range(70, 75))]
    plan = build_batch_plan(clients, [int(e) for e in tasks.num_epochs], B,
                            np.random.RandomState(0), min_epochs=E)

    jdef = jbuild(jp)
    jmv = jax.device_get(jdef.init_vars(jax.random.key(0)))
    tdef = build_model(tp)
    tmv = convert.from_jax_numpy(tdef.name, jmv.params, jmv.batch_stats)
    rng = np.random.RandomState(1)
    mom_np = {k: (rng.randn(3, *v.shape) * 0.01).astype(np.float32)
              for k, v in tmv.params.items()}

    # JAX: vmapped client step
    jstep = jmake(jdef, jdevdata(data, jp), JHyper.from_params(jp), fg_on)
    stack = lambda l: jnp.broadcast_to(jnp.asarray(l), (3,) + l.shape)
    start = jax.tree_util.tree_map(stack, jmv)
    per_client = [convert.to_jax_numpy(tdef.name, ModelVars(
        {k: torch.from_numpy(v[c]) for k, v in mom_np.items()}, {}))[0]
        for c in range(3)]
    jmom = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *per_client)
    jres = jax.vmap(jstep)(
        start, jax.tree_util.tree_map(jnp.asarray, jmom),
        jax.tree_util.tree_map(jnp.asarray, jt), jnp.asarray(plan.idx),
        jnp.asarray(plan.mask), jax.random.split(jax.random.key(0), 3))
    jres = jax.device_get(jres)

    # port
    step = make_client_step(tdef, make_image_device_data(
        data, tp, torch.device("cpu")), RoundHyper.from_params(tp), fg_on)
    start_t = ModelVars({k: v.unsqueeze(0).expand((3,) + v.shape).clone()
                         for k, v in tmv.params.items()}, {})
    res = step(start_t, {k: torch.from_numpy(v) for k, v in mom_np.items()},
               tasks.to_device(torch.device("cpu")),
               torch.from_numpy(plan.idx), torch.from_numpy(plan.mask),
               plan.mask.any(axis=(0, 3)))

    for c in range(3):
        want, _ = convert.to_jax_numpy(tdef.name, ModelVars(
            {k: v[c] for k, v in res.end_vars.params.items()}, {}))
        got_mom, _ = convert.to_jax_numpy(tdef.name, ModelVars(
            {k: v[c] for k, v in res.benign_mom.items()}, {}))
        j_end = jax.tree_util.tree_map(lambda l: l[c], jres.end_vars.params)
        j_mom = jax.tree_util.tree_map(lambda l: l[c], jres.benign_mom)
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(j_end)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(got_mom),
                        jax.tree_util.tree_leaves(j_mom)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert bool(res.fg_grads) == fg_on
    for c in range(3 if fg_on else 0):
        got_fg, _ = convert.to_jax_numpy(tdef.name, ModelVars(
            {k: v[c] for k, v in res.fg_grads.items()}, {}))
        j_fg = jax.tree_util.tree_map(lambda l: l[c], jres.fg_grads)
        for a, b in zip(jax.tree_util.tree_leaves(got_fg),
                        jax.tree_util.tree_leaves(j_fg)):
            assert np.abs(b).max() > 0
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    for f in ("correct", "count", "poison_count"):
        np.testing.assert_array_equal(getattr(res.metrics, f).numpy(),
                                      np.asarray(getattr(jres.metrics, f)))
    np.testing.assert_allclose(res.metrics.loss_sum.numpy(),
                               np.asarray(jres.metrics.loss_sum),
                               rtol=1e-5, atol=1e-5)
    # the poison lane moved by the ×scale epilogue, the tiny client's
    # padded steps were no-ops only past its own batches
    assert float(res.metrics.poison_count[0].sum()) > 0
    assert float(res.metrics.count[2, 0]) == 5.0
