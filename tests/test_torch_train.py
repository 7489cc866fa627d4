"""Port vs JAX: ICV training on tiny-idefics (CPU, f32).

The JAX params and the JAX initial trainable state are carried across
(``models.weights.params_from_jax``, ``GlobalICVEncoder.load_params``);
the same numpy batch goes through both sides.

- ``icv_loss_fn``: the loss to 1e-5 relative and the (icv, alpha) gradients
  to 1e-4 relative (max-abs error over max-abs value), with and without the
  gather-before-head teacher, with hard CE, a padding row, and under every
  ``remat_mode`` (recompute changes no number), ``policy`` (the selective
  checkpoint that keeps the weight matmuls) included.
- The train step: four micro-batches (accumulation 2, warmup, the joint clip
  active, temperature decay; alpha learnable or frozen) give the same
  (icv, alpha) and temperature as JAX ``make_train_step``, to 1e-5
  absolute on values of order 1e-1.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from licv_vqa_tpu.icv import encoder as jx_encoder
from licv_vqa_tpu.icv import module as jx_module
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu_torch.icv import module as pt_module
from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
from licv_vqa_tpu_torch.models import decoder as pt_decoder
from licv_vqa_tpu_torch.models import idefics as pt_idefics
from tests.test_torch_idefics import tiny_pair

EOS, PAD, IMG = 2, 0, 108
L_TINY, D_TINY = 4, 64


def make_batch(rng, bs=3, s_stu=12, s_tea=24, pad_row=True):
    """Right-padded student (query + answer) and teacher (shot + query +
    answer) views with one image each per segment; the last row is an
    all-pad row (a batch filler) when ``pad_row``."""
    stu = np.full((bs, s_stu), PAD, np.int32)
    tea = np.full((bs, s_tea), PAD, np.int32)
    qx = np.zeros(bs, np.int32)
    icl = np.zeros(bs, np.int32)
    for b in range(bs - int(pad_row)):
        shot = [IMG] + list(rng.integers(3, 100, size=rng.integers(4, 9)))
        query = [IMG] + list(rng.integers(3, 100, size=rng.integers(3, 6)))
        ans = list(rng.integers(3, 100, size=rng.integers(1, 3))) + [EOS]
        stu[b, : len(query) + len(ans)] = query + ans
        full = shot + query + ans
        tea[b, : len(full)] = full
        qx[b], icl[b] = len(query), len(shot) + len(query)

    def view(ids, n_img):
        return {
            "input_ids": ids,
            "attention_mask": (ids != PAD).astype(np.int32),
            "pixel_values": rng.normal(size=(bs, n_img, 28, 28, 3)).astype(np.float32),
            "pixel_valid": np.ones((bs, n_img), bool),
        }

    return {
        "query_inputs": view(stu, 1),
        "inputs": view(tea, 2),
        "query_x_length": qx,
        "in_context_length": icl,
    }


def to_jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def to_torch(batch):
    if isinstance(batch, dict):
        return {k: to_torch(v) for k, v in batch.items()}
    return torch.from_numpy(np.array(batch))


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, pcfg, pparams = tiny_pair()
    jfwd = jx_idefics.make_idefics_forward_fns(jcfg, EOS)[0]
    jhead = lambda p, h: jx_decoder.logits_from_hidden(jcfg.text, p, h)  # noqa: E731
    phead = lambda p, h: pt_decoder.logits_from_hidden(pcfg.text, p, h)  # noqa: E731
    return jcfg, jparams, jfwd, jhead, pcfg, pparams, phead


def _icv_params(rng, alpha=0.3):
    return {
        "icv": (rng.normal(size=(L_TINY, D_TINY)) * 0.5).astype(np.float32),
        "alpha": np.full((L_TINY,), alpha, np.float32),
    }


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


LOSS_CASES = {"kl_head": (True, 0.0), "kl_ce": (False, 0.5)}


@pytest.fixture(scope="module")
def jax_losses(models):
    """JAX loss and (icv, alpha) gradients per case (remat does not change
    them, so each runs once)."""
    jcfg, jparams, jfwd, jhead, *_ = models
    out = {}
    for name, (use_head, hard) in LOSS_CASES.items():
        rng = np.random.default_rng(0)
        batch, icv = make_batch(rng), _icv_params(rng)
        enc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, alpha_init_value=0.3)
        mcfg = jx_module.ICVModuleConfig(hard_loss_weight=hard, init_temperature=1.5)

        def loss(enc_params):
            trainable = {"encoder": enc_params, "temperature": jnp.float32(1.5)}
            return jx_module.icv_loss_fn(
                trainable, jparams, to_jax(batch), jfwd, enc, mcfg, PAD,
                jhead if use_head else None,
            )

        (val, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, icv)
        )
        out[name] = (float(val), {k: float(v) for k, v in metrics.items()},
                     {k: np.asarray(v) for k, v in grads.items()})
    return out


@pytest.mark.parametrize("remat_mode", ["both", "inner", "outer", "policy", "none"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_icv_loss_and_grads_match_jax(models, jax_losses, case, remat_mode):
    *_, pcfg, pparams, phead = models
    use_head, hard = LOSS_CASES[case]
    rng = np.random.default_rng(0)
    batch, icv = make_batch(rng), _icv_params(rng)
    cfg = dataclasses.replace(pcfg, remat_mode=remat_mode)
    pfwd = pt_idefics.make_idefics_forward_fns(cfg, EOS)[0]
    enc = GlobalICVEncoder(D_TINY, L_TINY, alpha_init_value=0.3)
    enc.load_params(icv)
    mcfg = pt_module.ICVModuleConfig(hard_loss_weight=hard, init_temperature=1.5)
    loss, metrics = pt_module.icv_loss_fn(
        enc, torch.tensor(1.5), pparams, to_torch(batch), pfwd, mcfg, PAD,
        phead if use_head else None,
    )
    d_icv, d_alpha = torch.autograd.grad(loss, (enc.icv, enc.alpha))
    want_loss, want_metrics, want_grads = jax_losses[case]
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    for k in ("kl_loss", "ce_loss"):
        if k in want_metrics:
            assert float(metrics[k]) == pytest.approx(want_metrics[k], rel=1e-5), k
    assert _rel(d_icv.numpy(), want_grads["icv"]) <= 1e-4
    assert _rel(d_alpha.numpy(), want_grads["alpha"]) <= 1e-4


def test_icv_loss_only_hard_and_frozen_weights(models):
    """``only_hard_loss`` returns the CE alone; the frozen LMM weights never
    get a gradient."""
    *_, pcfg, pparams, _ = models
    rng = np.random.default_rng(1)
    batch, icv = make_batch(rng), _icv_params(rng)
    enc = GlobalICVEncoder(D_TINY, L_TINY)
    enc.load_params(icv)
    pfwd = pt_idefics.make_idefics_forward_fns(pcfg, EOS)[0]
    mcfg = pt_module.ICVModuleConfig(only_hard_loss=True)
    loss, metrics = pt_module.icv_loss_fn(
        enc, torch.tensor(1.0), pparams, to_torch(batch), pfwd, mcfg, PAD
    )
    assert set(metrics) == {"ce_loss", "loss"} and float(loss.detach()) == float(metrics["ce_loss"])
    loss.backward()
    assert enc.icv.grad is not None
    assert all(not t.requires_grad for t in jax.tree_util.tree_leaves(pparams))


@pytest.mark.parametrize("remat_mode,want", [
    ("both", 10), ("inner", 8), ("outer", 8), ("policy", 8), ("none", 4),
])
def test_icv_forward_count_under_remat(models, monkeypatch, remat_mode, want):
    """Injections per student forward+backward: 4 in the forward; "inner"
    recomputes each layer once (2·L), "outer" each group whole (2·L);
    "both" recomputes each group but stops before the group's last layer,
    whose input the inner checkpoint already saved (``torch.utils.checkpoint``
    ends a recompute once the tensors the backward needs are rebuilt:
    L − G), then each layer (L).  So "both" is 3·L − G: 88 at Idefics-9B's
    32 layers in 8 groups, the count ``chip_smoke.py`` holds the card to.
    "policy" checkpoints each layer as "inner" does (2·L): the selective
    policy keeps the weight matmuls' outputs, but the injection is not one
    and its saved input is rebuilt by running the layer again."""
    *_, pcfg, pparams, _ = models
    calls = []
    real = pt_decoder.icv_inject
    monkeypatch.setattr(pt_decoder, "icv_inject", lambda h, v: calls.append(1) or real(h, v))
    rng = np.random.default_rng(2)
    batch = to_torch(make_batch(rng, pad_row=False))
    cfg = dataclasses.replace(pcfg, remat_mode=remat_mode)
    pfwd = pt_idefics.make_idefics_forward_fns(cfg, EOS)[0]
    icv = torch.randn((L_TINY, D_TINY), requires_grad=True)
    pfwd(pparams, batch["query_inputs"], icv).sum().backward()
    groups = L_TINY // pcfg.cross_layer_interval
    assert len(calls) == want
    if remat_mode == "both":
        assert want == 3 * L_TINY - groups


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that reach the kernels below the checkpoint's
    own dispatch mode (an output the selective policy kept never does)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policy_recomputes_all_but_the_weight_matmuls(models):
    """Under ``policy`` the backward's recompute runs no weight matmul (mm)
    again and reruns the batched attention products (bmm), as
    ``dots_with_no_batch_dims_saveable`` does in JAX; ``inner`` reruns both.
    The gradients are the same."""
    *_, pcfg, pparams, _ = models
    batch = to_torch(make_batch(np.random.default_rng(3), pad_row=False))
    icv = torch.randn((L_TINY, D_TINY), generator=torch.Generator().manual_seed(3))
    counts, grads = {}, {}
    for mode in ("inner", "policy"):
        cfg = dataclasses.replace(pcfg, remat_mode=mode)
        pfwd = pt_idefics.make_idefics_forward_fns(cfg, EOS)[0]
        leaf = icv.clone().requires_grad_(True)
        out = pfwd(pparams, batch["query_inputs"], leaf).sum()
        with _CountOps() as ops:
            (grads[mode],) = torch.autograd.grad(out, leaf)
        counts[mode] = ops.counts
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # each decoder layer runs 7 weight matmuls (wq wk wv wo gate up down);
    # the backward's own products are the same under both modes, so the
    # difference is the recompute
    assert counts["inner"][mm] - counts["policy"][mm] == 7 * L_TINY
    assert counts["policy"][bmm] == counts["inner"][bmm] > 0
    torch.testing.assert_close(grads["policy"], grads["inner"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("alpha_learnable", [True, False])
def test_train_steps_match_jax_make_train_step(models, alpha_learnable):
    jcfg, jparams, jfwd, jhead, pcfg, pparams, phead = models
    kw = dict(
        icv_lr=5e-2, alpha_lr=5e-2, warm_steps=1.0, accumulate_grad_batches=2,
        gradient_clip_val=0.05, init_temperature=2.0, decay_ratio=0.5,
        decay_per_step=1.0, min_temperature=0.7, hard_loss_weight=0.3,
    )
    total_steps = 6
    enc_kw = dict(alpha_learnable=alpha_learnable, alpha_init_value=0.2, use_sigmoid=True)

    jenc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, **enc_kw)
    jm = jx_module.ICVModuleConfig(**kw)
    tx = jx_module.make_optimizer(jm, total_steps)
    jstate = jx_module.init_train_state(jax.random.PRNGKey(1), jenc, jm, tx)
    jstep = jax.jit(jx_module.make_train_step(
        jfwd, jenc, jm, tx, PAD, jx_module.make_lr_schedules(jm, total_steps), jhead,
    ))

    penc = GlobalICVEncoder(D_TINY, L_TINY, **enc_kw)
    penc.load_params(jax.tree.map(np.asarray, jstate.params["encoder"]))
    pm = pt_module.ICVModuleConfig(**kw)
    pstate = pt_module.init_train_state(penc, pm, total_steps)
    pstep = pt_module.make_train_step(
        pt_idefics.make_idefics_forward_fns(pcfg, EOS)[0], pm, PAD, phead
    )

    rng = np.random.default_rng(4)
    norms = []
    for i in range(4):
        batch = make_batch(rng, pad_row=i % 2 == 0)
        jstate, jmet = jstep(jstate, jparams, to_jax(batch))
        pmet = pstep(pstate, pparams, to_torch(batch))
        norms.append(float(pmet["grad_norm"]))
        assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5), i
        assert float(pmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4), i
        for k in ("lr-icv", "lr-alpha", "temperature", "alpha/alpha-0"):
            assert float(pmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6, abs=1e-9), (i, k)
        want = jax.tree.map(np.asarray, jstate.params["encoder"])
        np.testing.assert_allclose(penc.icv.detach().numpy(), want["icv"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(penc.alpha.detach().numpy(), want["alpha"], atol=1e-5, rtol=0)
    assert min(norms) > kw["gradient_clip_val"]  # the clip was active
    assert float(pstate.temperature) == pytest.approx(1.0)  # one decay, 2.0 → 1.0
    moved = np.abs(penc.alpha.detach().numpy() - 0.2).max()
    assert (moved > 0) == alpha_learnable
