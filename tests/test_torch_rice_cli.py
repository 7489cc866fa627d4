"""Port CLI vs ``inference.py``: RICE shot retrieval (``use_rice=true``,
``tests/test_cli_e2e.py:353``) and speculative greedy decoding
(``generate_kwargs.speculative_draft_layers``, ``tests/test_cli_e2e.py:498``)
on the synthetic VQAv2 split, CPU, f32.

The tiny HF-layout Idefics checkpoint, the seeded whitespace vocabulary and
the split come from ``tests/test_torch_cli.py``'s fixture.  With no
``$CLIP_CPK_DIR`` both CLIs retrieve with ``HashEncoder``: the same
features bit for bit, so the same cache file (name and contents), the same
shots, predictions and accuracies.  Speculative decoding must give
``inference.py``'s predictions, and under ``lmm.quantize=int8`` the port's
own int8 greedy predictions.
"""

import json

import numpy as np
import torch

from tests.test_torch_cli import MODEL, _preds, env  # noqa: F401  (the fixture)

COMMON = [
    f"lmm={MODEL}",
    "data_cfg.task.datasets.few_shot_num=2",
    "data_cfg.task.datasets.max_train_size=-1",
    "test_icv=false",
    "test_icl=true",
    "test_num=3",
    "train_num=6",
    "bs=2",
    "generate_kwargs.max_new_tokens=3",
    "generate_kwargs.num_beams=1",
]


def _acc(result, shot):
    vals = [v for k, v in result.items() if k.endswith(f"ICL shot_num: {shot} ACC result")]
    assert len(vals) == 1, result
    return vals[0]


def test_port_cli_rice_matches_inference_py(env, monkeypatch):  # noqa: F811
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    monkeypatch.delenv("CLIP_CPK_DIR", raising=False)
    args = COMMON + ["use_rice=true", "few_shot_list=[1,2]"]
    cache = env / "results" / "cache" / "vqav2_3_rice_imgemb.pkl"
    want = jax_cli.main(args + ["run_name=jax"])
    assert cache.exists()
    jax_cache = torch.load(cache, weights_only=False)
    cache.unlink()  # the port encodes its own features
    got = torch_main(args + ["run_name=torch", "device=cpu"])
    assert [p.name for p in cache.parent.iterdir()] == [cache.name]
    port_cache = torch.load(cache, weights_only=False)
    assert port_cache["mode"] == jax_cache["mode"] == "i2i"
    for key in ("index", "test"):
        np.testing.assert_array_equal(port_cache[key], jax_cache[key])
    for shot in (1, 2):
        want_preds = _preds(env, "jax", f"icl_shot{shot}.json")
        assert len(want_preds) == 3 and any(want_preds)
        assert _preds(env, "torch", f"icl_shot{shot}.json") == want_preds, shot
        assert _acc(got, shot) == _acc(want, shot)
    # the results carry the "-RICE" suffix in their keys, as inference.py's
    assert all("-RICE" in k for k in got) and all("-RICE" in k for k in want)


def test_port_cli_speculative_matches_inference_py(env):  # noqa: F811
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = f"ice_idx_list_cache={env / 'ice.json'}"
    spec = ["few_shot_list=[2]", ice, "generate_kwargs.speculative_draft_layers=2",
            "generate_kwargs.speculative_gamma=2"]
    want = jax_cli.main(COMMON + spec + ["run_name=jax"])
    got = torch_main(COMMON + spec + ["run_name=torch", "device=cpu"])
    greedy = torch_main(COMMON + ["few_shot_list=[2]", ice, "run_name=greedy", "device=cpu"])
    want_preds = _preds(env, "jax", "icl_shot2.json")
    assert _preds(env, "torch", "icl_shot2.json") == want_preds
    assert _preds(env, "greedy", "icl_shot2.json") == want_preds
    assert _acc(got, 2) == _acc(want, 2) == _acc(greedy, 2)


def test_port_cli_int8_speculative_equals_int8_greedy(env):  # noqa: F811
    """``lmm.quantize=int8`` with a draft (its layers are slices of the
    quantized leaves): the same predictions as int8 greedy
    (``tests/test_quantize.py:133`` composes the two in JAX)."""
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = f"ice_idx_list_cache={env / 'ice.json'}"
    base = COMMON + ["few_shot_list=[2]", ice, "lmm.quantize=int8", "device=cpu"]
    torch_main(base + ["run_name=q8", ])
    torch_main(base + ["run_name=q8spec", "generate_kwargs.speculative_draft_layers=2",
                       "generate_kwargs.speculative_gamma=2"])
    preds = _preds(env, "q8", "icl_shot2.json")
    assert len(preds) == 3 and _preds(env, "q8spec", "icl_shot2.json") == preds
    meta = env / "results" / "inference" / MODEL / "vqav2" / "q8spec" / "meta_info"
    assert json.loads(next(meta.glob("icl_shot2.json")).read_text())
