"""The port's train CLI on the synthetic VQAv2 split (CPU, tiny-idefics).

``train_torch`` writes the reference artifact (keys and shapes as
``tests/test_cli_e2e.py`` checks them for ``train.py``), exits early on a
rerun, resumes from its step checkpoint to the same ICV as an uninterrupted
run, and its ``icv_cpk.pth`` is evaluated by the JAX ``inference.py``.  With
``data_cfg.loader=grain`` it writes ``train.py``'s artifact.
"""

import json
import shutil

import numpy as np

import pytest
import torch

from tests.test_cli_e2e import COMMON, env  # noqa: F401  (fixture)
from tests.test_torch_dist_cli import checkpoint, jax_initial_icv  # noqa: F401  (fixture)

TRAIN = COMMON + [
    "trainer=debug",
    "trainer.checkpoint_every_n_steps=2",
    "trainer.log_every_n_steps=1",
    "data_cfg.bs=2",
    "data_cfg.num_workers=1",
    "icv_module.icv_lr=1e-2",
    "icv_module.kl_impl=pallas",
    "trainer.profile_steps=1",
    "device=cpu",
]


def test_port_train_cli_artifact_rerun_resume_and_jax_eval(env):  # noqa: F811
    import inference as jax_infer
    import train_torch
    from licv_vqa_tpu_torch.train.checkpoint import load_icv_checkpoint

    save_path = train_torch.main(TRAIN)
    state = torch.load(save_path / "icv_cpk.pth", weights_only=False)
    assert state["icv_encoder.icv"].shape == (1, 4, 64)
    assert state["icv_encoder.alpha"].shape == (1, 4)
    assert state["lmm_args"]["total_layers"] == 4
    assert state["use_sigmoid"] is True
    lines = (save_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4]
    assert all(json.loads(x)["loss"] >= 0 for x in lines)
    steps = save_path / "steps"
    assert sorted(p.name for p in steps.glob("step_*.pt")) == ["step_2.pt", "step_4.pt"]
    loaded = load_icv_checkpoint(save_path)
    assert torch.equal(loaded["alpha"], torch.sigmoid(state["icv_encoder.alpha"][0]))
    assert (save_path / "profile" / "trace.json").stat().st_size > 0  # torch.profiler

    # an existing artifact: exit early, untouched
    mtime = (save_path / "icv_cpk.pth").stat().st_mtime_ns
    assert train_torch.main(TRAIN) == save_path
    assert (save_path / "icv_cpk.pth").stat().st_mtime_ns == mtime

    # resume: drop the artifact and the last step checkpoint; the run picks
    # up at micro step 2 and reaches the same ICV
    (save_path / "icv_cpk.pth").unlink()
    (steps / "step_4.pt").unlink()
    shutil.move(save_path / "metrics.jsonl", save_path / "metrics_first.jsonl")
    train_torch.main(TRAIN)
    resumed = torch.load(save_path / "icv_cpk.pth", weights_only=False)
    lines = (save_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [3, 4]
    for key in ("icv_encoder.icv", "icv_encoder.alpha"):
        torch.testing.assert_close(resumed[key], state[key], rtol=0, atol=1e-6)

    # the JAX CLI evaluates the port's artifact
    result = jax_infer.main(COMMON + [
        "test_icv=true", "test_num=2", "bs=2", "generate_kwargs.max_new_tokens=2",
        "generate_kwargs.num_beams=1",
    ])
    acc = [v for k, v in result.items() if "icv result" in k]
    assert len(acc) == 1 and 0.0 <= acc[0]["overall"] <= 100.0


def test_port_train_cli_grain_matches_jax(checkpoint, monkeypatch):  # noqa: F811
    """``data_cfg.loader=grain``: the port's artifact is ``train.py``'s
    within 1e-5, from the same converted checkpoint and JAX's initial ICV.
    Grain collates batches in its read-ahead threads and the whitespace
    tokenizer numbers words in the order it meets them, so both runs read
    with one thread (grain's order of batches does not hang on its
    threads; the ids would)."""
    import grain.python as gp

    import train as jax_train
    import train_torch
    from licv_vqa_tpu_torch.cli import train as port_train
    from tests.torch_train_from_init import patch_icv_init

    to_iter = gp.MapDataset.to_iter_dataset

    def one_thread(self, read_options=None, **kw):
        return to_iter(self, read_options or gp.ReadOptions(num_threads=1), **kw)

    monkeypatch.setattr(gp.MapDataset, "to_iter_dataset", one_thread)
    env = checkpoint
    jax_initial_icv(env / "icv_init.npy")
    init = np.load(env / "icv_init.npy")
    monkeypatch.setattr(port_train, "GlobalICVEncoder", port_train.GlobalICVEncoder)
    patch_icv_init(port_train, init)
    args = [a for a in TRAIN if not a.startswith(("icv_module.kl_impl", "trainer.profile",
                                                   "device"))] + ["data_cfg.loader=grain"]
    port = torch.load(train_torch.main(args + ["run_name=grain_port", "device=cpu"])
                      / "icv_cpk.pth", weights_only=False)
    # one device: at its default eight JAX pads the batch of two with six
    # empty rows, and with this checkpoint its loss reads NaN from the
    # second micro-step on
    want = torch.load(jax_train.main(args + ["run_name=grain_jax", "trainer.devices=1"])
                      / "icv_cpk.pth", weights_only=False)
    for key in ("icv_encoder.icv", "icv_encoder.alpha"):
        torch.testing.assert_close(torch.as_tensor(port[key]), torch.as_tensor(want[key]),
                                   rtol=0, atol=1e-5)
    assert (torch.as_tensor(port["icv_encoder.icv"])[0] - torch.from_numpy(init)).abs().max() > 1e-3


def test_port_train_cli_preemption_saves_a_step_checkpoint(env, monkeypatch):  # noqa: F811
    """A stop request (SIGTERM/SIGINT in a real run) lands after the first
    micro-step: the trainer checkpoints that step and stops."""
    import train_torch
    from licv_vqa_tpu_torch.core.distributed import PreemptionGuard
    from licv_vqa_tpu_torch.train import trainer as trainer_mod

    class StopAfterOneStep(PreemptionGuard):
        checks = 0

        @property
        def should_stop(self):
            StopAfterOneStep.checks += 1
            return StopAfterOneStep.checks > 1

    monkeypatch.setattr(trainer_mod, "PreemptionGuard", StopAfterOneStep)
    save_path = train_torch.main(TRAIN + ["run_name=preempted", "trainer.profile_steps=0"])
    assert sorted(p.name for p in (save_path / "steps").glob("step_*.pt")) == ["step_1.pt"]
    assert len((save_path / "metrics.jsonl").read_text().splitlines()) == 1
