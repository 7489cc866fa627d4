"""The port's CLIs on ``lmm=tiny-flamingo`` against the JAX package's (CPU,
f32).

One tiny full-model open_flamingo ``checkpoint.pt`` (the MPT base, the gated
cross-attention layers, the perceiver and the open_clip tower, built
locally by ``tests/test_torch_openflamingo.flamingo_state_dict``, so
nothing is downloaded) is handed to both registries through
``lmm.flamingo_checkpoint_dir``, and one ``icv_cpk.pth`` is written by the
JAX ``save_icv_checkpoint``.

- ``inference_torch.py`` and ``inference.py`` run ``test_icv`` (beam-3, the
  ICV at every block output) and ``test_icl``: predictions and accuracy
  equal.
- ``train_torch.py trainer=debug`` and ``train.py`` train from the same
  initial ICV (JAX's ``PRNGKey(0)`` draw, loaded into the port's encoder):
  the three micro-steps' losses (six training rows at bs=2) within 1e-4
  relative (f32, summation order through the AdamW updates).
"""

import json

import numpy as np
import pytest
import torch

from tests.test_cli_e2e import REPO, _write_vqa_split
from tests.test_torch_openflamingo import flamingo_state_dict

MODEL = "tiny-flamingo"
VOCAB = 130
ARGS = [
    f"lmm={MODEL}",
    "data_cfg.task.datasets.few_shot_num=1",
    "data_cfg.task.datasets.max_train_size=-1",
    "test_icv=true",
    "test_icl=true",
    "few_shot_list=[2]",
    "test_num=3",
    "train_num=4",
    "bs=2",
    "generate_kwargs.max_new_tokens=3",
    "generate_kwargs.num_beams=3",
]


@pytest.fixture()
def env(tmp_path, monkeypatch):
    from licv_vqa_tpu.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu.train.checkpoint import save_icv_checkpoint
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer as PortTokenizer
    from licv_vqa_tpu_torch.models.openflamingo import OpenFlamingoConfig

    vqa_root = tmp_path / "vqav2"
    coco = tmp_path / "coco" / "mscoco2014"
    _write_vqa_split(vqa_root, coco / "train2014", "train2014", 6)
    _write_vqa_split(vqa_root, coco / "val2014", "val2014", 4)
    for key, sub in (("VQAV2_PATH", "vqav2"), ("COCO_PATH", "coco"),
                     ("RESULT_DIR", "results"), ("MODEL_CPK_DIR", "cpk"),
                     ("OKVQA_PATH", "okvqa")):
        monkeypatch.setenv(key, str(tmp_path / sub))
    monkeypatch.chdir(REPO)
    # both CLIs fall back to WhitespaceTokenizer, whose vocab grows as it
    # encodes: seed it with the prompts' words and fillers up to the tiny
    # model's vocabulary, so equal predictions mean equal tokens
    seed_tok = WhitespaceTokenizer()
    seed_tok.encode("Provide an answer to the question. Use the image to answer.\n")
    for i in range(6):
        for ans in ("red", "blue", "two", "cat", "yes", "no", ""):
            seed_tok.encode(f"Question:What thing {i}? Short answer:{ans}.\n\n")
            seed_tok.encode(f"Question:What thing {i}? Short answer:")
    words = seed_tok._id_to_tok[len(WhitespaceTokenizer.SPECIALS):]
    words += [f"w{i}" for i in range(VOCAB - len(seed_tok._id_to_tok))]
    for cls in (WhitespaceTokenizer, PortTokenizer):  # the port has its own copy
        monkeypatch.setattr(
            cls, "__init__",
            lambda self, vocab=(), _init=cls.__init__: _init(self, vocab or words),
        )

    fdir = tmp_path / "flamingo"
    fdir.mkdir()
    torch.save(flamingo_state_dict(OpenFlamingoConfig.tiny(), np.random.default_rng(0)),
               fdir / "checkpoint.pt")
    rng = np.random.default_rng(1)
    icv = {"icv": rng.normal(size=(4, 64)).astype(np.float32),
           "alpha": np.full((4,), 0.5, np.float32)}
    for run in ("jax", "torch"):
        save_icv_checkpoint(
            tmp_path / "results" / "model_cpk" / "vqav2" / MODEL / run, icv,
            use_sigmoid=False, lmm_args={"total_layers": 4, "intervention_layer": -1},
        )
    (tmp_path / "ice.json").write_text(json.dumps([[0, 1], [2, 3], [1, 2]]))
    return tmp_path


def _preds(env, run, name):
    d = env / "results" / "inference" / MODEL / "vqav2" / run / "meta_info"
    p = json.loads(next(d.glob(f"*{name}")).read_text())
    return [p[k]["prediction"] for k in sorted(p, key=int)]


def test_port_cli_matches_inference_py_on_openflamingo(env):
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    extra = [f"ice_idx_list_cache={env / 'ice.json'}",
             f"lmm.flamingo_checkpoint_dir={env / 'flamingo'}"]
    want = jax_cli.main(ARGS + extra + ["run_name=jax"])
    got = torch_main(ARGS + extra + ["run_name=torch", "device=cpu"])
    for name in ("icv.json", "icl_shot2.json"):
        want_preds = _preds(env, "jax", name)
        assert len(want_preds) == 3 and any(want_preds), want_preds
        assert _preds(env, "torch", name) == want_preds, name
    for tag in ("icv result", "ICL shot_num: 2 ACC result"):
        w = [v for k, v in want.items() if k.endswith(tag)]
        g = [v for k, v in got.items() if k.endswith(tag)]
        assert len(w) == len(g) == 1, tag
        assert g[0] == w[0], tag


def test_port_train_cli_losses_match_train_py_on_openflamingo(env, monkeypatch):
    import jax

    import train as jax_train
    import train_torch
    from licv_vqa_tpu.icv.encoder import GlobalICVEncoder as JaxEncoder
    from licv_vqa_tpu_torch.cli import train as port_train_cli

    # the JAX trainer draws the ICV from PRNGKey(0) (train/trainer.py:273);
    # the port's encoder starts from the same rows
    start = JaxEncoder(64, 4).init(jax.random.PRNGKey(0))

    class SameStart(port_train_cli.GlobalICVEncoder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            with torch.no_grad():
                self.load_params({"icv": np.asarray(start["icv"]),
                                  "alpha": self.alpha.detach().cpu().numpy()})

    monkeypatch.setattr(port_train_cli, "GlobalICVEncoder", SameStart)
    common = [f"lmm={MODEL}", "data_cfg.task.datasets.few_shot_num=1",
              "data_cfg.task.datasets.max_train_size=-1", "trainer=debug",
              "trainer.log_every_n_steps=1", "data_cfg.bs=2", "data_cfg.num_workers=1",
              f"lmm.flamingo_checkpoint_dir={env / 'flamingo'}"]
    runs = {
        "jax": jax_train.main(common + ["run_name=tr_jax"]),
        "torch": train_torch.main(common + ["run_name=tr_torch", "device=cpu"]),
    }
    losses = {}
    for run, path in runs.items():
        rows = [json.loads(x) for x in (path / "metrics.jsonl").read_text().splitlines()]
        losses[run] = [r["loss"] for r in rows]
    state = torch.load(runs["torch"] / "icv_cpk.pth", weights_only=False)
    assert state["icv_encoder.icv"].shape == (1, 4, 64)
    assert "blocks" in state["lmm_args"]["layer_format"]  # the MPT block output
    assert len(losses["jax"]) == 3 and all(np.isfinite(losses["jax"]))  # 6 rows, bs=2
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4, atol=0)
