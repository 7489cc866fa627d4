"""Port vs JAX: training over dp and dp x tp ranks (CPU, f32, tiny-idefics).

JAX's ``Trainer`` runs two micro-steps on its virtual devices (``devices=2``,
dp = 2) over global batches of four rows whose halves hold different
numbers of answer tokens.  The port's ``Trainer`` runs the same batches in
two spawned gloo ranks (``tests/torch_dist_common.py``), once as
``strategy=dp`` (dp = 2: each rank its two rows, the losses over the global
denominators, the gradients summed) and once as ``dp_tp`` with ``tp=2`` (dp
= 1: the Megatron shards).  Both must reach JAX's losses and ``(icv,
alpha)`` within 1e-5; a resume from the first step checkpoint must reach
the same ``(icv, alpha)``; a preemption flag raised on rank 1 alone must
stop both ranks at the same micro-step, with rank 0 the only writer.
"""

import jax
import numpy as np
import pytest

from licv_vqa_tpu.icv import encoder as jx_encoder
from licv_vqa_tpu.icv import module as jx_module
from licv_vqa_tpu.models import decoder as jx_decoder
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu.train import trainer as jx_trainer
from tests.test_torch_idefics import tiny_pair
from tests.test_torch_train import D_TINY, EOS, L_TINY, PAD, make_batch
from tests.torch_dist_common import ListLoader, Ranks, dp_train

ATOL = 1e-5
MODULE_KW = dict(icv_lr=5e-2, alpha_lr=5e-2, warm_steps=1.0, hard_loss_weight=0.3,
                 init_temperature=1.5)
ENC_KW = dict(alpha_learnable=True, alpha_init_value=0.2, use_sigmoid=True)
TRAINER_KW = dict(devices=-1, max_epochs=1, log_every_n_steps=1, accumulate_grad_batches=1,
                  checkpoint_every_n_steps=1, preempt_sync_every_n_steps=1,
                  gradient_clip_val=1.0)


def _batches():
    """Two global batches of four rows; the answer-token counts of the two
    halves (each dp rank's rows) differ in both."""
    rng = np.random.default_rng(21)
    out = []
    while len(out) < 2:
        b = make_batch(rng, bs=4, pad_row=False)
        ids, qx = b["query_inputs"]["input_ids"], b["query_x_length"]
        n = [int(((np.arange(ids.shape[1]) >= qx[r]) & (ids[r] != PAD)).sum()) for r in range(4)]
        if n[0] + n[1] != n[2] + n[3]:
            out.append(b)
    return out


def _jax_init():
    """The encoder params JAX's ``Trainer`` starts from (``PRNGKey(0)``)."""
    enc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, **ENC_KW)
    mcfg = jx_module.ICVModuleConfig(**MODULE_KW)
    init = jx_module.init_train_state(jax.random.PRNGKey(0), enc, mcfg,
                                      jx_module.make_optimizer(mcfg, 2))
    return jax.tree.map(np.asarray, init.params["encoder"])


def _jax_run(jcfg, jparams, batches, run_dir):
    enc = jx_encoder.GlobalICVEncoder(D_TINY, L_TINY, **ENC_KW)
    tcfg = jx_trainer.TrainerConfig(strategy="dp", **{**TRAINER_KW, "devices": 2,
                                                      "checkpoint_every_n_steps": 0})
    log = []
    trainer = jx_trainer.Trainer(
        tcfg, jx_module.ICVModuleConfig(**MODULE_KW), enc,
        jx_idefics.make_idefics_forward_fns(jcfg, EOS)[0], jparams, PAD,
        metrics_hook=lambda step, m: log.append((step, m["loss"])),
        head_fn=lambda p, h: jx_decoder.logits_from_hidden(jcfg.text, p, h),
    )
    state = trainer.fit(ListLoader(batches), run_dir)
    enc_params = jax.tree.map(np.asarray, state.params["encoder"])
    return {"icv": enc_params["icv"], "alpha": enc_params["alpha"], "losses": log}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, jparams, pcfg, _ = tiny_pair()
    batches = _batches()
    tmp = tmp_path_factory.mktemp("dp_train")
    setup = {"cfg": pcfg, "params": jax.tree.map(np.asarray, jparams), "batches": batches,
             "enc_kw": ENC_KW, "enc_init": _jax_init(), "module_kw": MODULE_KW,
             "trainer_kw": TRAINER_KW, "eos": EOS, "pad": PAD}
    (tmp / "port").mkdir()
    port = Ranks(dp_train, 2, tmp, setup, str(tmp / "port"))  # runs beside JAX
    want = _jax_run(jcfg, jparams, batches, tmp / "jax")
    return want, port.wait()


@pytest.mark.parametrize("strategy", ["dp", "dp_tp"])
def test_losses_and_icv_match_jax_trainer(runs, strategy):
    want, ranks = runs
    got0 = ranks[0][strategy]
    assert [s for s, _ in got0["losses"]] == [1, 2]
    for (_, lg), (_, lw) in zip(got0["losses"], want["losses"]):
        assert lg == pytest.approx(float(lw), rel=1e-5, abs=1e-6)
    assert ranks[1][strategy]["losses"] == []  # rank 0 alone logs
    for r in ranks:  # every rank holds the same (icv, alpha)
        np.testing.assert_allclose(r[strategy]["icv"], want["icv"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(r[strategy]["alpha"], want["alpha"], atol=ATOL, rtol=0)
    assert got0["artifact"] == ["icv_cpk.pth"]


def test_resume_reaches_the_same_icv(runs):
    _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["resumed"]["icv"], r["dp"]["icv"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["resumed"]["alpha"], r["dp"]["alpha"], atol=1e-6, rtol=0)
    assert [s for s, _ in ranks[0]["resumed"]["losses"]] == [2]  # only the second step reran


def test_preemption_on_one_rank_stops_both_at_the_same_step(runs):
    _, ranks = runs
    assert [r["preempted"]["step"] for r in ranks] == [1, 1]
    assert ranks[0]["preempted"]["steps"] == ["step_1.pt"]
