"""Port vs JAX: training under sequence parallelism (CPU, f32, tiny models).

- The trainer: JAX's ``Trainer`` runs two micro-steps on four of its
  virtual devices at ``strategy=dp_sp`` (dp 2 × sp 2) and ``dp_tp_sp``
  (tp 2 × sp 2) over global batches of four rows, the dp halves holding
  different numbers of answer tokens, the student 13 and the teacher 25
  tokens long (sp divides neither: the trainers pad both), the temperature
  learnt (``learnable_t``, no decay), accumulated into one optimizer step.
  The port's ``Trainer`` runs the same batches in four spawned gloo ranks
  (``tests/torch_dist_common.py``).  The losses and the final ``(icv,
  alpha, temperature)`` must agree within 1e-5; a resume of the ``dp_sp``
  run from its first step checkpoint must reach the same state; rank 0
  alone writes the artifact.
- The families: JAX's ``icv_loss_fn`` on one device against the port's at
  sp = 2 in two ranks (each rank its half of every row's tokens, the batch
  padded by the trainer's ``_pad_seq_to_multiple``): tiny Idefics-9B under
  ``remat_mode`` inner, both and policy (the ring's shifts rerun in the
  recompute), Idefics2 (GQA: the ring moves two KV heads) and OpenFlamingo
  (ALiBi: the ring makes the bias per chunk).  The loss within 1e-5
  relative and the ``(icv, alpha)`` gradients within 1e-4 relative
  (max-abs error over max-abs value), the tolerances of the one-process
  family tests.  The temperature's gradient is the small difference of
  two terms of size ``2·KL/T`` (``T²``'s derivative times the KL, and the
  KL's own), so its f32 error is one of those terms': it is held within
  1e-4 of ``2·KL/T`` (the one-process port reads 2e-4 to 2e-2 relative to
  the gradient itself on these batches, 2e-6 to 3e-5 of the scale).  The rows are
  right-padded and their real tokens end in the first or the second chunk;
  the query's ``<image>`` of a teacher row may sit in the chunk before the
  tokens that attend it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from licv_vqa_tpu.icv import encoder as jx_encoder
from licv_vqa_tpu.icv import module as jx_module
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.models import idefics2 as jx_idefics2
from licv_vqa_tpu.models import openflamingo as jx_flamingo
from licv_vqa_tpu.train import trainer as jx_trainer
from tests import test_torch_idefics2 as T2
from tests import test_torch_openflamingo as T3
from tests.test_torch_idefics import tiny_pair
from tests.test_torch_train import D_TINY, EOS, L_TINY, PAD, make_batch
from tests.torch_dist_common import ListLoader, Ranks, sp_losses, sp_train

ATOL = 1e-5
S_STU, S_TEA = 13, 25
# the two micro-steps accumulate into one optimizer step with no warmup:
# Adam's first step moves the temperature by icv_lr times the sign of its
# mean gradient.  Two optimizer steps would move it by m/sqrt(v) of two
# gradients of about 1e-5 and opposite signs on these batches, a ratio
# whose f32 noise reaches 3e-5 (JAX's own dp_sp and one-device runs differ
# by 1.1e-4 there)
MODULE_KW = dict(icv_lr=1e-2, alpha_lr=5e-2, warm_steps=0.0, hard_loss_weight=0.3,
                 init_temperature=1.5, learnable_t=True)
ENC_KW = dict(alpha_learnable=True, alpha_init_value=0.2, use_sigmoid=True)
TRAINER_KW = dict(devices=-1, max_epochs=1, log_every_n_steps=1, accumulate_grad_batches=2,
                  checkpoint_every_n_steps=1, preempt_sync_every_n_steps=1,
                  gradient_clip_val=1.0)
STRATEGIES = {"dp_sp": dict(tp=1, sp=2), "dp_tp_sp": dict(tp=2, sp=2)}


def _batches():
    """Two global batches of four rows; the answer-token counts of the two
    halves (each dp rank's rows) differ in both."""
    rng = np.random.default_rng(22)
    out = []
    while len(out) < 2:
        b = make_batch(rng, bs=4, s_stu=S_STU, s_tea=S_TEA, pad_row=False)
        ids, qx = b["query_inputs"]["input_ids"], b["query_x_length"]
        n = [int(((np.arange(ids.shape[1]) >= qx[r]) & (ids[r] != PAD)).sum()) for r in range(4)]
        if n[0] + n[1] != n[2] + n[3]:
            out.append(b)
    return out


def _jax_init():
    enc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, **ENC_KW)
    mcfg = jx_module.ICVModuleConfig(**MODULE_KW)
    init = jx_module.init_train_state(jax.random.PRNGKey(0), enc, mcfg,
                                      jx_module.make_optimizer(mcfg, 2))
    return jax.tree.map(np.asarray, init.params["encoder"])


def _jax_run(jcfg, jparams, batches, run_dir, strategy):
    enc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, **ENC_KW)
    tcfg = jx_trainer.TrainerConfig(strategy=strategy, **STRATEGIES[strategy], **{
        **TRAINER_KW, "devices": 4, "checkpoint_every_n_steps": 0})
    log = []
    trainer = jx_trainer.Trainer(
        tcfg, jx_module.ICVModuleConfig(**MODULE_KW), enc,
        jx_idefics.make_idefics_forward_fns(jcfg, EOS)[0], jparams, PAD,
        metrics_hook=lambda step, m: log.append((step, m["loss"])),
        head_fn=lambda p, h: jx_decoder.logits_from_hidden(jcfg.text, p, h),
    )
    state = trainer.fit(ListLoader(batches), run_dir / strategy)
    enc_params = jax.tree.map(np.asarray, state.params["encoder"])
    return {"icv": enc_params["icv"], "alpha": enc_params["alpha"],
            "temperature": float(np.asarray(state.params["temperature"])), "losses": log}


def _odd(batch):
    """The batch with the last (all-pad) column of both views dropped: odd
    lengths, which the port pads back to an sp multiple."""
    out = dict(batch)
    for view in ("query_inputs", "inputs"):
        v = dict(batch[view])
        assert (v["attention_mask"][:, -1] == 0).all()
        for key in ("input_ids", "attention_mask"):
            v[key] = np.ascontiguousarray(v[key][:, :-1])
        out[view] = v
    return out


def _family_cases():
    """``name -> (family, remat_mode)``."""
    return {"idefics-inner": ("idefics", "inner"), "idefics-both": ("idefics", "both"),
            "idefics-policy": ("idefics", "policy"), "idefics2": ("idefics2", None),
            "openflamingo": ("openflamingo", None)}


def _family_setup(family):
    """(jax cfg, jax params, port cfg, odd batch, jax train forward)."""
    rng = np.random.default_rng(7)
    if family == "idefics":
        jcfg, jparams, pcfg, _ = tiny_pair()
        batch = make_batch(rng, bs=3, s_stu=S_STU, s_tea=S_TEA)
        fwd = jx_idefics.make_idefics_forward_fns(jcfg, EOS)[0]
    elif family == "idefics2":
        jcfg, jparams, pcfg, _ = T2.tiny_pair()
        batch = _odd(T2._train_batch(rng, navit=False))
        fwd = jx_idefics2.make_idefics2_forward_fns(jcfg, EOS)[0]
    else:
        jcfg, jparams, pcfg, _ = T3.tiny_pair()
        batch = _odd(T3._train_batch(rng))
        fwd = jx_flamingo.make_openflamingo_forward_fns(jcfg, EOS)[0]
    return jcfg, jparams, pcfg, batch, fwd


FAMILY_MODULE_KW = dict(hard_loss_weight=0.5, init_temperature=1.5)
FAMILY_ENC_KW = dict(alpha_init_value=0.3)


def _jax_family(jcfg, jparams, batch, fwd, icv):
    enc = jx_encoder.GlobalICVEncoder(64, 4, **FAMILY_ENC_KW)
    mcfg = jx_module.ICVModuleConfig(**FAMILY_MODULE_KW)

    def loss(trainable):
        return jx_module.icv_loss_fn(
            trainable, jparams, jax.tree.map(jnp.asarray, batch), fwd, enc, mcfg, PAD,
            lambda p, h: jx_decoder.logits_from_hidden(jcfg.text, p, h))

    trainable = {"encoder": jax.tree.map(jnp.asarray, icv), "temperature": jnp.float32(1.5)}
    (value, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(trainable)
    return {"loss": float(value), "kl": float(metrics["kl_loss"]),
            "icv": np.asarray(grads["encoder"]["icv"]),
            "alpha": np.asarray(grads["encoder"]["alpha"]),
            "temperature": np.asarray(grads["temperature"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_train")
    jcfg, jparams, pcfg, _ = tiny_pair()
    batches = _batches()
    setup = {"cfg": pcfg, "params": jax.tree.map(np.asarray, jparams), "batches": batches,
             "enc_kw": ENC_KW, "enc_init": _jax_init(), "module_kw": MODULE_KW,
             "trainer_kw": TRAINER_KW, "eos": EOS, "pad": PAD}
    (tmp / "port").mkdir()
    trainer_ranks = Ranks(sp_train, 4, tmp, setup, str(tmp / "port"))

    rng = np.random.default_rng(9)
    icv = {"icv": (rng.normal(size=(L_TINY, D_TINY)) * 0.5).astype(np.float32),
           "alpha": np.full((L_TINY,), 0.3, np.float32)}
    setups = {f: _family_setup(f) for f in ("idefics", "idefics2", "openflamingo")}
    cases = {}
    for name, (family, mode) in _family_cases().items():
        _, fjparams, fpcfg, batch, _ = setups[family]
        cases[name] = {"family": family, "remat_mode": mode, "cfg": fpcfg, "eos": EOS,
                       "params": jax.tree.map(np.asarray, fjparams), "enc_kw": FAMILY_ENC_KW,
                       "enc": icv, "temperature": 1.5, "batch": batch, "pad": PAD,
                       "module_kw": FAMILY_MODULE_KW}
    family_ranks = Ranks(sp_losses, 2, tmp, cases)

    want_train = {s: _jax_run(jcfg, jparams, batches, tmp / "jax", s) for s in STRATEGIES}
    want_family = {f: _jax_family(s[0], s[1], s[3], s[4], icv) for f, s in setups.items()}
    return want_train, trainer_ranks.wait(), want_family, family_ranks.wait()


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_losses_icv_and_temperature_match_jax_trainer(runs, strategy):
    want, ranks = runs[0][strategy], runs[1]
    got0 = ranks[0][strategy]
    assert [s for s, _ in got0["losses"]] == [1, 2]
    for (_, lg), (_, lw) in zip(got0["losses"], want["losses"], strict=True):
        assert lg == pytest.approx(float(lw), rel=1e-5, abs=1e-6)
    assert all(r[strategy]["losses"] == [] for r in ranks[1:])  # rank 0 alone logs
    assert want["temperature"] != pytest.approx(1.5, abs=1e-4)  # the temperature learnt
    for r in ranks:  # every rank holds the same state
        np.testing.assert_allclose(r[strategy]["icv"], want["icv"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(r[strategy]["alpha"], want["alpha"], atol=ATOL, rtol=0)
        assert r[strategy]["temperature"] == pytest.approx(want["temperature"], abs=ATOL)
    assert got0["artifact"] == ["icv_cpk.pth"]


def test_sp_resume_reaches_the_same_state(runs):
    ranks = runs[1]
    for r in ranks:
        for key in ("icv", "alpha"):
            np.testing.assert_allclose(r["resumed"][key], r["dp_sp"][key], atol=1e-6, rtol=0)
        assert r["resumed"]["temperature"] == pytest.approx(r["dp_sp"]["temperature"], abs=1e-6)
    assert [s for s, _ in ranks[0]["resumed"]["losses"]] == [2]  # only the second step reran


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(_family_cases()))
def test_family_loss_and_gradients_at_sp2_match_jax(runs, name):
    family = _family_cases()[name][0]
    want, ranks = runs[2][family], runs[3]
    for r in ranks:
        got = r[name]
        assert all(n % 2 == 0 for n in got["lengths"])  # padded to the sp multiple
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for key in ("icv", "alpha"):
            assert _rel(got[key], want[key]) <= 1e-4, (key, _rel(got[key], want[key]))
        scale = 2 * want["kl"] / FAMILY_MODULE_KW["init_temperature"]
        assert abs(float(got["temperature"]) - float(want["temperature"])) <= 1e-4 * scale


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_sequence_padding_equals_jax(sp):
    """The trainer's ``_pad_seq_to_multiple`` pads exactly JAX's leaves:
    each view's ids (with the pad id) and mask (with 0) to its own sp
    multiple, after the dp padding; the pixel leaves and lengths stay."""
    from licv_vqa_tpu_torch.train import trainer as pt_trainer

    batch = jx_trainer._pad_batch_to_multiple(_batches()[0], 3)
    want = jx_trainer._pad_seq_to_multiple(batch, sp, PAD)
    got = pt_trainer._pad_seq_to_multiple(pt_trainer._pad_batch_to_multiple(
        _batches()[0], 3), sp, PAD)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for view in ("query_inputs", "inputs"):
        assert got[view]["input_ids"].shape[1] % sp == 0
