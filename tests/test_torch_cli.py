"""Port CLI vs ``inference.py`` on the synthetic VQAv2 split (CPU, f32).

One tiny HF-layout Idefics checkpoint is written under
``MODEL_CPK_DIR/tiny-idefics`` (built locally as ``tests/test_idefics_parity``
builds it, so nothing is downloaded) and one ``icv_cpk.pth`` by the JAX
``save_icv_checkpoint``.  Both CLIs load them through their converters and
run ``test_icv`` (beam-3) and ``test_icl``; predictions and accuracy must be
equal.  A subprocess checks that the port imports no jax.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from tests.test_cli_e2e import REPO, _write_vqa_split

MODEL = "tiny-idefics"
ARGS = [
    f"lmm={MODEL}",
    "data_cfg.task.datasets.few_shot_num=2",
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
    from safetensors.torch import save_file

    from licv_vqa_tpu.train.checkpoint import save_icv_checkpoint
    from tests.test_idefics_parity import _tiny_hf_idefics

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
    # model's 110 ids, so every generated id decodes to a word and equal
    # predictions mean equal tokens
    from licv_vqa_tpu.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer as PortTokenizer

    seed_tok = WhitespaceTokenizer()
    seed_tok.encode("Provide an answer to the question. Use the image to answer.\n")
    for i in range(6):
        for ans in ("red", "blue", "two", "cat", "yes", "no", ""):
            seed_tok.encode(f"Question:What thing {i}? Short answer:{ans}.\n\n")
            seed_tok.encode(f"Question:What thing {i}? Short answer:")
    words = seed_tok._id_to_tok[len(WhitespaceTokenizer.SPECIALS):]
    words += [f"w{i}" for i in range(110 - len(seed_tok._id_to_tok))]
    for cls in (WhitespaceTokenizer, PortTokenizer):  # the port has its own copy
        monkeypatch.setattr(
            cls, "__init__",
            lambda self, vocab=(), _init=cls.__init__: _init(self, vocab or words),
        )

    model_dir = tmp_path / "cpk" / MODEL
    model_dir.mkdir(parents=True)
    sd = _tiny_hf_idefics().state_dict()
    save_file({k: v.detach().clone().contiguous() for k, v in sd.items()},
              str(model_dir / "model.safetensors"))

    rng = np.random.default_rng(0)
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


def test_port_cli_matches_inference_py(env):
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = f"ice_idx_list_cache={env / 'ice.json'}"
    want = jax_cli.main(ARGS + [ice, "run_name=jax"])
    got = torch_main(ARGS + [ice, "run_name=torch", "device=cpu"])

    for name in ("icv.json", "icl_shot2.json"):
        want_preds = _preds(env, "jax", name)
        assert len(want_preds) == 3 and any(want_preds), want_preds
        assert _preds(env, "torch", name) == want_preds, name
    for tag in ("icv result", "ICL shot_num: 2 ACC result"):
        w = [v for k, v in want.items() if k.endswith(tag)]
        g = [v for k, v in got.items() if k.endswith(tag)]
        assert len(w) == len(g) == 1, tag
        assert g[0] == w[0], tag

    # same on-disk layout, and an existing result.json exits early
    res = env / "results" / "inference" / MODEL / "vqav2" / "torch" / "result.json"
    assert json.loads(res.read_text()) == got
    assert torch_main(ARGS + [ice, "run_name=torch", "device=cpu"]) == got


def test_port_cli_cuda_without_gpu_raises(env):
    import torch

    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(ARGS + ["run_name=torch", "device=cuda"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import licv_vqa_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'licv_vqa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import inference_torch, chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
