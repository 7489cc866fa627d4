"""The port's CLIs and registry on ``lmm=tiny-idefics2`` against the JAX
package's (CPU, f32).

One tiny HF-layout Idefics2 checkpoint is written under
``MODEL_CPK_DIR/tiny-idefics2`` (built locally as
``tests/test_idefics2_parity`` builds it, so nothing is downloaded) and one
``icv_cpk.pth`` by the JAX ``save_icv_checkpoint``.

- ``inference_torch.py`` and ``inference.py`` run ``test_icv`` (beam-3, the
  ICV at every layer's MLP output) and ``test_icl``: predictions and
  accuracy equal.
- ``train_torch.py trainer=debug`` writes an ``icv_cpk.pth`` whose
  ``layer_format`` names the MLP site, and ``inference.py`` evaluates it.
- ``lmm.quantize=int8`` with the int8 vision tower, perceiver and connector
  builds through both registries: prefill logits within 1e-4 (f32).
"""

import json

import numpy as np
import pytest
import torch

from tests.test_cli_e2e import REPO, _write_vqa_split

MODEL = "tiny-idefics2"
VOCAB = 120
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

    from licv_vqa_tpu.data.tokenizer import WhitespaceTokenizer
    from licv_vqa_tpu.train.checkpoint import save_icv_checkpoint
    from licv_vqa_tpu_torch.data.tokenizer import WhitespaceTokenizer as PortTokenizer
    from tests.test_idefics2_parity import _tiny_hf_idefics2

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

    model_dir = tmp_path / "cpk" / MODEL
    model_dir.mkdir(parents=True)
    sd = _tiny_hf_idefics2().state_dict()
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


def test_port_cli_matches_inference_py_on_idefics2(env):
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


def test_port_train_cli_writes_an_mlp_site_checkpoint_jax_evaluates(env):
    import inference as jax_cli
    import train_torch

    common = [f"lmm={MODEL}", "run_name=e2e2", "data_cfg.task.datasets.few_shot_num=1",
              "data_cfg.task.datasets.max_train_size=-1"]
    save_path = train_torch.main(common + [
        "trainer=debug", "trainer.log_every_n_steps=1", "data_cfg.bs=2",
        "data_cfg.num_workers=1", "device=cpu",
    ])
    state = torch.load(save_path / "icv_cpk.pth", weights_only=False)
    assert "mlp" in state["lmm_args"]["layer_format"]
    assert state["icv_encoder.icv"].shape == (1, 4, 64)
    losses = [json.loads(x)["loss"] for x in (save_path / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))  # 6 training rows, bs=2
    result = jax_cli.main(common + [
        "test_icv=true", "test_num=2", "bs=2", "generate_kwargs.max_new_tokens=2",
        "generate_kwargs.num_beams=1",
    ])
    assert any("icv result" in k for k in result)


def test_quantized_idefics2_registry_logits_match_jax(env):
    """``_maybe_quantize`` on a family with no cross-attention stack and a
    perceiver ``layers`` stack plus a connector (int8 weights, head and
    vision): both registries build, the same leaves are quantized, and the
    prefill logits agree."""
    import jax.numpy as jnp

    from licv_vqa_tpu.models.registry import build_model as jx_build
    from licv_vqa_tpu.utils import compose as jx_compose
    from licv_vqa_tpu_torch.models.registry import build_model as pt_build
    from licv_vqa_tpu_torch.utils import compose as pt_compose

    over = [f"lmm={MODEL}", "lmm.quantize=int8", "lmm.quantize_head=true",
            "lmm.quantize_vision=true", "lmm.remat_mode=inner"]
    jb = jx_build(jx_compose(str(REPO / "config"), "inference", over))
    pb = pt_build(pt_compose(str(REPO / "config"), "inference", over + ["device=cpu"]),
                  device="cpu")
    assert not hasattr(pb.model_cfg, "remat_mode")
    for key in ("w_gate", "w_up", "w_down"):
        assert set(pb.params["connector"][key]) == {"q", "s"}
        assert set(pb.params["perceiver"]["layers"]["mlp"][key]) == {"q", "s"}
    assert set(pb.params["vision"]["layers"]["attn"]["wq"]) == {"q", "s"}

    rng = np.random.default_rng(1)
    prompts = [[rng.integers(0, 255, size=(28, 28, 3), dtype=np.uint8),
                "Question:What thing 1? Short answer:"]] * 2
    enc = pb.processor.prepare_input(prompts, padding=True, padding_side="left")
    ids, mask = enc["input_ids"], enc["attention_mask"]
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    icv = rng.normal(size=(4, 64)).astype(np.float32) * 0.1
    jf = jb.bind_decode(jb.params, jnp.asarray(enc["pixel_values"]),
                        jnp.asarray(enc["pixel_valid"]), jnp.asarray(ids), jnp.asarray(icv),
                        ids.shape[1] + 2)
    want, _ = jf(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pos), None)
    t = torch.from_numpy
    with torch.no_grad():
        pf = pb.bind_decode(pb.params, t(enc["pixel_values"]), t(enc["pixel_valid"]), t(ids),
                            t(icv), ids.shape[1] + 2)
        got, _ = pf(t(ids), t(mask), t(pos), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
