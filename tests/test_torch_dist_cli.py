"""The port's CLIs over ranks: ``python -m torch.distributed.run`` on the CPU.

``inference_torch.py`` at ``infer_dp=2`` and at ``infer_tp=2`` (two gloo
ranks each) must give the predictions of JAX's ``inference.py`` at
``infer_dp=-1`` (its 8 virtual devices, as ``tests/test_cli_e2e.py`` runs
it) and of the port's single process, on the synthetic VQAv2 split, with
one tiny HF-layout Idefics checkpoint under ``MODEL_CPK_DIR`` that every
run converts (as ``tests/test_torch_cli.py`` writes it);
``train_torch.py`` at ``trainer.strategy=dp_tp trainer.tp=2`` must write
one ``icv_cpk.pth`` and one line of metrics a step, from rank 0.  The three
launches run at once, beside the in-process runs.  The serving engines over
ranks: ``infer_engine=continuous`` beam-3 at ``infer_dp=2 infer_tp=2``
(four ranks) must write the static beam path's predictions and JAX's
``inference.py``'s at the same mesh, and ``infer_engine=pooled`` at
``infer_dp=2`` one process's.  ``train_torch.py`` at
``trainer.strategy=dp_sp trainer.sp=2`` (two ranks, each half of every
row's tokens) must write the ``icv_cpk.pth`` of ``train.py`` at the same
strategy (its two virtual devices) within 1e-5, from the same converted
checkpoint and JAX's initial ICV (``tests/torch_train_from_init.py``), with
one writer.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_cli_e2e import COMMON, REPO, env  # noqa: F401  (fixture)

ICL = [
    "test_icv=false", "test_icl=true", "few_shot_list=[2]", "test_num=5", "train_num=4", "bs=2",
    "generate_kwargs.max_new_tokens=3", "generate_kwargs.num_beams=1",
]


def write_tiny_checkpoint(env) -> None:
    """One tiny HF-layout Idefics checkpoint under ``MODEL_CPK_DIR``."""
    from safetensors.torch import save_file

    from tests.test_idefics_parity import _tiny_hf_idefics

    model_dir = env / "cpk" / "tiny-idefics"
    model_dir.mkdir(parents=True)
    sd = _tiny_hf_idefics().state_dict()
    save_file({k: v.detach().clone().contiguous() for k, v in sd.items()},
              str(model_dir / "model.safetensors"))


@pytest.fixture()
def checkpoint(env):  # noqa: F811
    write_tiny_checkpoint(env)
    return env


@pytest.fixture()
def weights(env):  # noqa: F811
    # every question carries words of its own, so the whitespace tokenizer
    # (whose vocab grows as it encodes) holds a word for each of the model's
    # 110 ids before the first answer is decoded, in every process alike
    for f in (env / "vqav2").glob("*questions.json"):
        qs = json.loads(f.read_text())
        for q in qs["questions"]:
            q["question"] += " " + " ".join(f"{f.stem[-10:]}{q['question_id']}w{j}"
                                            for j in range(40))
        f.write_text(json.dumps(qs))
    write_tiny_checkpoint(env)
    return env


def _launch(script: str, args: list, log, nproc: int = 2, **env):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(REPO / script), *args, "device=cpu"]
    return subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", **env),
                            stdout=log, stderr=subprocess.STDOUT)


def _preds(env, run):  # noqa: F811
    p = json.loads((env / "results" / "inference" / "tiny-idefics" / "vqav2" / run
                    / "meta_info" / "icl_shot2.json").read_text())
    return [p[k]["prediction"] for k in sorted(p, key=int)]


def test_multi_process_clis_match_jax_and_one_process(weights):
    env = weights
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    cache = env / "ice_idx.json"
    cache.write_text(json.dumps([[0, 1]] * 5))
    args = COMMON + ICL + [f"ice_idx_list_cache={cache}"]
    train = COMMON + ["trainer=debug", "data_cfg.bs=2", "data_cfg.num_workers=1",
                      "trainer.log_every_n_steps=1", "trainer.strategy=dp_tp", "trainer.tp=2",
                      "run_name=dp_tp_train"]
    logs = {name: open(env / f"{name}.log", "w") for name in ("dp2", "tp2", "train")}
    procs = {
        "dp2": _launch("inference_torch.py", args + ["run_name=dp2", "infer_dp=2"], logs["dp2"]),
        "tp2": _launch("inference_torch.py", args + ["run_name=tp2", "infer_tp=2"], logs["tp2"]),
        "train": _launch("train_torch.py", train, logs["train"]),
    }
    try:
        jax_cli.main(args + ["run_name=jax_dp", "infer_dp=-1"])
        torch_main(args + ["run_name=one", "device=cpu"])
        for name, p in procs.items():
            assert p.wait(timeout=300) == 0, (env / f"{name}.log").read_text()[-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for f in logs.values():
            f.close()

    want = _preds(env, "jax_dp")
    assert len(want) == 5 and all(want), want
    assert _preds(env, "one") == want
    assert _preds(env, "dp2") == want
    assert _preds(env, "tp2") == want

    run = env / "results" / "model_cpk" / "vqav2" / "tiny-idefics" / "dp_tp_train"
    assert sorted(p.name for p in run.glob("*.pth")) == ["icv_cpk.pth"]
    steps = [json.loads(x)["step"] for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4]  # one writer
    state = torch.load(run / "icv_cpk.pth", weights_only=False)
    assert state["icv_encoder.icv"].shape == (1, 4, 64)


def test_serving_engines_over_ranks_match_the_static_beam_and_jax(weights):
    """``infer_engine=continuous`` beam-3 at ``infer_dp=2 infer_tp=2`` (four
    ranks: the group pool over dp, the weights over tp) writes the static
    beam path's predictions and JAX's ``inference.py`` at the same mesh
    (``tests/test_cli_e2e.py:206-248``); ``infer_engine=pooled`` at
    ``infer_dp=2`` (each rank whole chunks of 2) writes one process's
    pooled predictions, which are the static beam's.  One ``result.json``
    and ``meta_info`` each, from rank 0."""
    env = weights
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    cache = env / "ice_idx.json"
    cache.write_text(json.dumps([[0, 1]] * 5))
    args = COMMON + ICL + [f"ice_idx_list_cache={cache}", "generate_kwargs.num_beams=3"]
    cont = ["infer_engine=continuous", "infer_dp=2", "infer_tp=2"]
    pooled = ["infer_engine=pooled", "infer_pool=2"]
    logs = {name: open(env / f"{name}.log", "w") for name in ("cont", "pooled")}
    procs = {
        "cont": _launch("inference_torch.py", args + cont + ["run_name=cont_dp2tp2"],
                        logs["cont"], nproc=4),
        "pooled": _launch("inference_torch.py", args + pooled + ["run_name=pooled_dp2",
                                                                 "infer_dp=2"], logs["pooled"]),
    }
    try:
        jax_cli.main(args + cont + ["run_name=jax_cont"])
        torch_main(args + ["run_name=static_beam", "device=cpu"])
        torch_main(args + pooled + ["run_name=pooled_one", "device=cpu"])
        for name, p in procs.items():
            assert p.wait(timeout=300) == 0, (env / f"{name}.log").read_text()[-4000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for f in logs.values():
            f.close()

    want = _preds(env, "static_beam")
    assert len(want) == 5 and all(want), want
    assert _preds(env, "jax_cont") == want
    assert _preds(env, "cont_dp2tp2") == want
    assert _preds(env, "pooled_one") == want
    assert _preds(env, "pooled_dp2") == want
    for run in ("cont_dp2tp2", "pooled_dp2"):
        d = env / "results" / "inference" / "tiny-idefics" / "vqav2" / run
        assert (d / "result.json").exists()
        assert sorted(p.name for p in (d / "meta_info").iterdir()) == ["icl_shot2.json"]


@pytest.mark.parametrize("extra", [["infer_dp=3"], ["infer_dp=2", "infer_tp=2"]])
def test_a_mesh_the_launcher_did_not_start_raises(env, extra):  # noqa: F811
    """One process asked for a mesh of more ranks: no fallback to one."""
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    with pytest.raises(ValueError, match="ranks, the launcher started 1"):
        torch_main(COMMON + ICL + ["run_name=refused", "device=cpu", *extra])


def test_train_devices_the_launcher_did_not_start_raises(env):  # noqa: F811
    import train_torch

    with pytest.raises(ValueError, match="launcher started 1"):
        train_torch.main(COMMON + ["trainer=debug", "trainer.devices=2", "device=cpu",
                                   "run_name=refused"])


def jax_initial_icv(path) -> None:
    """JAX's initial ICV of tiny-idefics (4 x 64: ``encoder.init`` on
    ``PRNGKey(0)``, as its ``Trainer`` draws it) saved to ``path``."""
    import jax

    from licv_vqa_tpu.icv.encoder import GlobalICVEncoder

    np.save(path, np.asarray(GlobalICVEncoder(64, 4).init(jax.random.PRNGKey(0))["icv"]))


def test_sp_train_cli_matches_jax(checkpoint):
    env = checkpoint
    import train as jax_train

    init = env / "icv_init.npy"
    jax_initial_icv(init)
    train = COMMON + ["trainer=debug", "data_cfg.bs=2", "data_cfg.num_workers=1",
                      "trainer.log_every_n_steps=1", "icv_module.icv_lr=1e-2",
                      "trainer.strategy=dp_sp", "trainer.sp=2"]
    with open(env / "sp_train.log", "w") as log:
        proc = _launch("tests/torch_train_from_init.py", train + ["run_name=sp_port"], log,
                       ICV_INIT=str(init))
        try:
            jax_train.main(train + ["run_name=sp_jax", "trainer.devices=2"])
            assert proc.wait(timeout=300) == 0, (env / "sp_train.log").read_text()[-4000:]
        finally:
            if proc.poll() is None:
                proc.kill()

    runs = env / "results" / "model_cpk" / "vqav2" / "tiny-idefics"
    port = torch.load(runs / "sp_port" / "icv_cpk.pth", weights_only=False)
    want = torch.load(runs / "sp_jax" / "icv_cpk.pth", weights_only=False)
    for key in ("icv_encoder.icv", "icv_encoder.alpha"):
        torch.testing.assert_close(torch.as_tensor(port[key]), torch.as_tensor(want[key]),
                                   rtol=0, atol=1e-5)
    moved = (torch.as_tensor(port["icv_encoder.icv"])[0] - torch.from_numpy(np.load(init)))
    assert moved.abs().max() > 1e-3  # trained, not the initial rows
    assert sorted(p.name for p in (runs / "sp_port").glob("*.pth")) == ["icv_cpk.pth"]
    lines = (runs / "sp_port" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3, 4]  # one writer
