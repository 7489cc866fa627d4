"""Port vs JAX: the grain-backed loader (CPU, ``num_workers=0``).

The port's ``GrainDataLoader`` and JAX's read the same dataset on the same
seeds and must hand out the same batches: without and with shuffle, two
epochs (the per-epoch reseed), each ``shard_index`` of ``shard_count``
(the common-length truncation), the same ``len``, and a ``get_state``
taken mid-epoch and restored on a fresh loader, which must continue in
JAX's order.  The port's ``Trainer`` over the grain loader, stopped after
two micro-steps and resumed from its step checkpoint, must train JAX's
loader's order over two epochs, each batch once.  Without ``grain`` the
loader raises the import error.
"""

import sys

import numpy as np
import pytest
import torch

gp = pytest.importorskip("grain.python")

from licv_vqa_tpu.train.grain_loader import GrainDataLoader as JxGrainDataLoader  # noqa: E402
from licv_vqa_tpu_torch.train.grain_loader import GrainDataLoader  # noqa: E402


class DS:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": int(i)}


def collate(items):
    return np.asarray([d["x"] for d in items])


def _pair(*args, **kw):
    return GrainDataLoader(*args, **kw), JxGrainDataLoader(*args, **kw)


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 5), (True, 7)])
def test_batches_equal_jax(shuffle, seed):
    port, jx = _pair(DS(), 3, collate, shuffle=shuffle, seed=seed, num_workers=0, num_epochs=1)
    got, want = list(port), list(jx)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_two_epochs_equal_jax():
    port, jx = _pair(DS(), 3, collate, shuffle=True, seed=5, num_workers=0, num_epochs=1)
    epochs = [(np.concatenate(list(port)), np.concatenate(list(jx))) for _ in range(2)]
    for a, b in epochs:
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(epochs[0][0], epochs[1][0])  # reshuffled each epoch


@pytest.mark.parametrize("shard_index", [0, 1, 2])
def test_shards_equal_jax(shard_index):
    port, jx = _pair(DS(), 1, collate, shuffle=True, seed=3, num_workers=0, num_epochs=1,
                     shard_index=shard_index, shard_count=3)
    got, want = np.concatenate(list(port)), np.concatenate(list(jx))
    np.testing.assert_array_equal(got, want)
    assert len(got) == len(port) == len(jx) == 11 // 3  # the common length


@pytest.mark.parametrize("kw", [
    {"batch_size": 3}, {"batch_size": 3, "drop_last": False}, {"batch_size": 2, "num_epochs": 2},
    {"batch_size": 2, "shard_count": 2, "shard_index": 1}, {"batch_size": 4, "num_epochs": None},
])
def test_len_equals_jax(kw):
    kw = {"num_epochs": 1, **kw}
    port, jx = _pair(DS(), collate_fn=collate, shuffle=True, seed=1, num_workers=0, **kw)
    assert len(port) == len(jx)


def test_mid_epoch_state_restores_jax_remaining_order():
    """A state taken after one batch, restored on a fresh port loader,
    continues where JAX's loader goes on."""
    kw = dict(shuffle=True, seed=7, num_workers=0, num_epochs=2)
    port = GrainDataLoader(DS(), 3, collate, **kw)
    it = port.iterator()
    next(it)
    state = port.get_state()
    jx = JxGrainDataLoader(DS(), 3, collate, **kw)
    jx_it = jx.iterator()
    next(jx_it)
    want = list(jx_it)

    fresh = GrainDataLoader(DS(), 3, collate, **kw)
    fresh.iterator()
    fresh.set_state(state)
    got = list(iter(fresh))
    assert len(got) == len(want) == 6  # 22 samples of two epochs, 7 batches, one taken
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_missing_grain_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "grain.python", None)
    with pytest.raises(ImportError):
        GrainDataLoader(DS(), 3, collate, num_workers=0)


class PromptDS:
    """Prompt dicts the collator reads, each carrying its index."""

    def __init__(self, n: int = 8):
        self.n = n
        self.img = np.random.default_rng(0).integers(0, 255, size=(28, 28, 3), dtype=np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": int(i),
                "ice_prompt": [self.img, f"Question:shot {i}? Short answer:a{i}.\n\n"],
                "query_prompt": [self.img, f"Question:q {i}? Short answer:b{i}"],
                "query_x": [self.img, f"Question:q {i}? Short answer:"]}


def test_trainer_resume_replays_jax_order(tmp_path, monkeypatch):
    from licv_vqa_tpu_torch.data.collator import collate_icv_batch
    from licv_vqa_tpu_torch.data.processor import ImageTransform, PromptProcessor
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig
    from licv_vqa_tpu_torch.models import idefics
    from licv_vqa_tpu_torch.train import trainer as T
    from tests.test_torch_idefics import tiny_pair

    _, _, pcfg, pparams = tiny_pair()
    proc = PromptProcessor(WhitespaceTokenizer(), ImageTransform(28), family="idefics",
                           pad_to_multiple=8)

    def collate_icv(items):  # the batch carries its samples' indices
        idx = np.asarray([it.pop("idx") for it in items])
        return dict(collate_icv_batch(items, proc), idx=idx)

    trained = []
    make_step = T.make_train_step

    def recording_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, params, batch):
            trained.append(batch["idx"].tolist())
            return step(state, params, batch)

        return run

    def fit():
        loader = GrainDataLoader(PromptDS(), 2, collate_icv, shuffle=True, seed=4,
                                 num_workers=0, num_epochs=1)
        tcfg = T.TrainerConfig(max_epochs=2, checkpoint_every_n_steps=0, log_every_n_steps=1)
        return T.Trainer(tcfg, ICVModuleConfig(icv_lr=1e-2, warm_steps=0),
                         GlobalICVEncoder(64, 4), idefics.make_idefics_forward_fns(pcfg, 2)[0],
                         pparams, pad_token_id=0).fit(loader, tmp_path / "run")

    class StopAtTwo(T.PreemptionGuard):
        @property
        def should_stop(self):
            return len(trained) == 2

    monkeypatch.setattr(T, "make_train_step", recording_step)
    monkeypatch.setattr(T, "PreemptionGuard", StopAtTwo)
    assert fit().step == 2
    monkeypatch.setattr(T, "PreemptionGuard", T.PreemptionGuard.__mro__[1])
    state = fit()  # resumes from the preemption's step checkpoint
    assert state.step == 8

    jx = JxGrainDataLoader(PromptDS(), 2, lambda items: [it["idx"] for it in items],
                           shuffle=True, seed=4, num_workers=0, num_epochs=1)
    want = [b for _ in range(2) for b in jx]
    assert trained == want
    assert torch.isfinite(state.encoder.icv).all()
