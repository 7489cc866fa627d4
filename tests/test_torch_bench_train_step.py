"""``tools/bench_train_step_torch.py`` against ``tools/bench_train_step_tpu.py``
at the tiny shape, on the CPU in f32.

For every remat mode the JAX tool runs at tiny, the port tool's first-step
loss equals the JAX tool's (``_build("tiny", mode)``, its jitted step): the
same batch from ``np.random.default_rng(0)`` (checked equal), JAX's params
carried across with ``params_from_jax`` and JAX's initial ``(icv, alpha)``
loaded into the port's encoder (the two tools draw their random weights
from different generators).  Loss to 1e-5 relative; the FLOPs model and
the meta keys are the same.  The JAX tool is imported by path and stays as
it is.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from licv_vqa_tpu_torch.models.weights import params_from_jax

REPO = Path(__file__).resolve().parent.parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JX = _load("bench_train_step_tpu")
PT = _load("bench_train_step_torch")


def _flat(batch, prefix=""):
    for k, v in batch.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("mode", ["inner", "policy", "outer", "both"])
def test_tiny_first_step_loss_matches_the_jax_tool(mode):
    jstep, jstate, jparams, jbatch, jmeta = JX._build("tiny", mode)
    _, jmetrics = jax.jit(jstep)(jstate, jparams, jbatch)

    step, state, _, batch, meta = PT._build("tiny", mode, "cpu")
    assert meta == jmeta
    jflat, pflat = dict(_flat(jbatch)), dict(_flat(batch))
    assert sorted(jflat) == sorted(pflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(pflat[k], v, err_msg=k)

    state.encoder.load_params(jax.tree.map(np.asarray, jstate.params["encoder"]))
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), torch.float32)
    metrics = step(state, pparams, batch)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    for k in ("kl_loss", "ce_loss"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), k
