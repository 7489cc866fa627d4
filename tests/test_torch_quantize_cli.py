"""Port CLI vs ``inference.py`` with quantized weights (CPU, f32).

The tiny HF-layout Idefics checkpoint and ICV checkpoint of
``tests/test_torch_cli.py`` go through both CLIs, each quantizing in its own
registry: the options of ``tests/test_quantize.py:110-129`` (int8 weights,
int8 head, int8 KV cache, w8a8 prefill, int8 vision tower) on ``test_icl``,
and ``lmm.quantize=int4`` on ``test_icv`` (beam-3).  Predictions and
accuracy must be equal.
"""

import pytest

from tests.test_torch_cli import MODEL, _preds, env  # noqa: F401  (env: the fixture)

INT8_ALL = [
    f"lmm={MODEL}",
    "lmm.quantize=int8",
    "lmm.quantize_head=true",
    "lmm.kv_cache=int8",
    "lmm.w8a8_prefill=true",
    "lmm.quantize_vision=true",
    "test_icv=false",
    "test_icl=true",
    "few_shot_list=[1]",
    "test_num=2",
    "train_num=3",
    "bs=2",
    "data_cfg.task.datasets.max_train_size=-1",
    "generate_kwargs.max_new_tokens=2",
    "generate_kwargs.num_beams=1",
]
INT4_ICV = [
    f"lmm={MODEL}",
    "lmm.quantize=int4",
    "data_cfg.task.datasets.max_train_size=-1",
    "test_icv=true",
    "test_icl=false",
    "test_num=3",
    "bs=2",
    "generate_kwargs.max_new_tokens=3",
    "generate_kwargs.num_beams=3",
]


@pytest.mark.parametrize("args,files,tags", [
    (INT8_ALL, ("icl_shot1.json",), ("ICL shot_num: 1 ACC result",)),
    (INT4_ICV, ("icv.json",), ("icv result",)),
], ids=["int8_head_kv8_w8a8_vision_icl", "int4_icv_beam3"])
def test_port_cli_matches_inference_py_quantized(env, args, files, tags):  # noqa: F811
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    want = jax_cli.main(args + ["run_name=jax"])
    got = torch_main(args + ["run_name=torch", "device=cpu"])
    for name in files:
        want_preds = _preds(env, "jax", name)
        assert want_preds and any(want_preds), want_preds
        assert _preds(env, "torch", name) == want_preds, name
    for tag in tags:
        w = [v for k, v in want.items() if k.endswith(tag)]
        g = [v for k, v in got.items() if k.endswith(tag)]
        assert len(w) == len(g) == 1, tag
        assert g[0] == w[0], tag
