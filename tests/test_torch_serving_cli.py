"""``infer_engine=continuous`` through the port CLI (CPU, tiny-idefics).

On ``tests/test_torch_cli.py``'s synthetic VQAv2 split, HF-layout
checkpoint, ICV checkpoint and seeded tokenizer (equal predictions mean
equal tokens): the continuous engines write the static path's predictions
for ``test_icv`` and for ``test_icl`` with ``few_shot_list=[1,3]`` over a
fixed ice-index cache whose rows mix 1 and 3 shots (mixed buckets and image
counts), greedy and beam-3 (``tests/test_cli_e2e.py:191`` and ``:298``),
and JAX's ``inference.py`` writes the same on the same split.  So does
``infer_engine=pooled`` (beam-3, chunks of ``infer_pool`` = 3 questions over
buckets of mixed shot counts: the last chunk of a bucket padded;
``tests/test_cli_e2e.py:251``).  The same three routes on ``lmm=tiny-idefics2``
(``tests/test_torch_idefics2_cli.py``'s checkpoint and split) and on
``lmm=tiny-flamingo`` (``tests/test_torch_openflamingo_cli.py``'s
``checkpoint.pt`` and split) write the static path's predictions, which are
``inference.py``'s; so does tiny-flamingo's greedy engine with int8 weights
and the int8 KV cache under ALiBi.  The pooled runner refuses greedy
decoding and NaViT images.  The engines over ranks (``infer_dp`` /
``infer_tp``) are ``tests/test_torch_dist_cli.py``'s.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_cli import MODEL, _preds, env  # noqa: F401  (fixture)
from tests.test_torch_idefics2_cli import MODEL as MODEL2
from tests.test_torch_idefics2_cli import _preds as _preds2
from tests.test_torch_idefics2_cli import env as env2  # noqa: F401  (fixture)
from tests.test_torch_openflamingo_cli import MODEL as MODEL3
from tests.test_torch_openflamingo_cli import _preds as _preds3
from tests.test_torch_openflamingo_cli import env as env3  # noqa: F401  (fixture)
from tests.test_torch_serving import _one_thread  # noqa: F401  (autouse fixture)

ICE = [[0], [1, 2, 0], [2], [0, 1, 2]]
ARGS = [
    f"lmm={MODEL}",
    "data_cfg.task.datasets.few_shot_num=2",
    "data_cfg.task.datasets.max_train_size=-1",
    "test_icv=true",
    "test_icl=true",
    "few_shot_list=[1,3]",
    "test_num=4",
    "train_num=4",
    "bs=2",
    "generate_kwargs.max_new_tokens=3",
]


def _runs(env, names, model=MODEL):
    """An ICV checkpoint under each run name (a copy of the fixture's)."""
    cpk = env / "results" / "model_cpk" / "vqav2" / model
    for name in names:
        shutil.copytree(cpk / "torch", cpk / name)


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_continuous_cli_writes_the_static_predictions(env, beams):  # noqa: F811
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = env / "ice_mixed.json"
    ice.write_text(json.dumps(ICE))
    args = ARGS + [f"ice_idx_list_cache={ice}", f"generate_kwargs.num_beams={beams}"]
    static, cont, jax_run = f"static{beams}", f"cont{beams}", f"jax{beams}"
    _runs(env, (static, cont, jax_run))
    torch_main(args + [f"run_name={static}", "device=cpu"])
    torch_main(args + [f"run_name={cont}", "device=cpu", "infer_engine=continuous"])
    jax_cli.main(args + [f"run_name={jax_run}"])
    for name in ("icv.json", "icl_shot1.json", "icl_shot3.json"):
        want = _preds(env, static, name)
        assert len(want) == 4 and any(want), (name, want)
        assert _preds(env, cont, name) == want, name
        assert _preds(env, jax_run, name) == want, name


def test_pooled_cli_writes_the_static_beam_predictions(env):  # noqa: F811
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = env / "ice_mixed.json"
    ice.write_text(json.dumps(ICE))
    args = ARGS + [f"ice_idx_list_cache={ice}", "generate_kwargs.num_beams=3", "infer_pool=3"]
    _runs(env, ("static_pl", "pooled", "jax_pl"))
    torch_main(args + ["run_name=static_pl", "device=cpu"])
    torch_main(args + ["run_name=pooled", "device=cpu", "infer_engine=pooled"])
    jax_cli.main(args + ["run_name=jax_pl"])
    for name in ("icv.json", "icl_shot1.json", "icl_shot3.json"):
        want = _preds(env, "static_pl", name)
        assert len(want) == 4 and any(want), (name, want)
        assert _preds(env, "pooled", name) == want, name
        assert _preds(env, "jax_pl", name) == want, name


def test_pooled_cli_with_sampled_shots(env):  # noqa: F811
    """Without an ice-index cache the CLI samples the shots from its seed:
    the pooled route gets the static route's shots and predictions."""
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    args = [a for a in ARGS if not a.startswith(("few_shot_list", "test_icv"))] + [
        "test_icv=false", "few_shot_list=[2]", "generate_kwargs.num_beams=3", "device=cpu"]
    torch_main(args + ["run_name=sampled_static"])
    torch_main(args + ["run_name=sampled_pooled", "infer_engine=pooled"])
    want = _preds(env, "sampled_static", "icl_shot2.json")
    assert len(want) == 4 and _preds(env, "sampled_pooled", "icl_shot2.json") == want


def test_pooled_runner_hands_its_chain_the_binds_pixels(env, monkeypatch):  # noqa: F811
    """The chain gets the processor's raw uint8 pixels normalised on the
    device as the bundle's bind normalises them (tiny-idefics's
    cross-attention gates start at 0, so the CLI runs above cannot see the
    images), and with the gates opened its answers are the static
    runner's."""
    from licv_vqa_tpu_torch.api import init_dataset, init_prompt_manager
    from licv_vqa_tpu_torch.data.processor import CLIP_MEAN, CLIP_STD
    from licv_vqa_tpu_torch.infer import eval_chain
    from licv_vqa_tpu_torch.infer.runner import icv_inference, icv_inference_pooled
    from licv_vqa_tpu_torch.models.registry import build_model, normalize_pixels
    from licv_vqa_tpu_torch.utils import compose

    cfg = compose("config", "inference", ARGS + ["device=cpu"])
    bundle = build_model(cfg, device="cpu")
    for key in ("alpha_xattn", "alpha_dense"):
        bundle.params["xattn"][key].fill_(0.7)
    pm = init_prompt_manager(cfg)
    rows = init_dataset(cfg, "validation")[0].select(range(4))
    seen = []
    make = eval_chain.make_idefics_pooled_eval_chain

    def recording(*a, **kw):
        chain = make(*a, **kw)

        def run(params, ids, mask, pixels, valid, icv):
            seen.append(pixels)
            return chain(params, ids, mask, pixels, valid, icv)

        return run

    monkeypatch.setattr(eval_chain, "make_idefics_pooled_eval_chain", recording)
    kw = {"num_beams": 3, "max_new_tokens": 3}
    pooled = icv_inference_pooled(rows, bundle, pm, kw, progress=False, pool_questions=4)
    static = icv_inference(rows, bundle, pm, 1, kw, progress=False)
    assert [r["prediction"] for r in pooled.values()] == [
        r["prediction"] for r in static.values()]
    raw = np.stack([bundle.processor.prepare_input(
        [[r["image"], pm.gen_query_text_without_label(r)]])["pixel_values"][0] for r in rows])
    want = normalize_pixels(torch.from_numpy(raw[:, None]), CLIP_MEAN, CLIP_STD)
    (got,) = seen
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pooled_runner_refuses_greedy_and_navit(env, monkeypatch):  # noqa: F811
    """JAX runner.py:530-548: the pooled schedule is beam search over
    prompts of one image size."""
    from licv_vqa_tpu_torch.api import init_dataset, init_prompt_manager
    from licv_vqa_tpu_torch.infer.runner import icv_inference_pooled
    from licv_vqa_tpu_torch.models.registry import build_model
    from licv_vqa_tpu_torch.utils import compose

    cfg = compose("config", "inference", ARGS + ["device=cpu"])
    bundle = build_model(cfg, device="cpu")
    pm = init_prompt_manager(cfg)
    rows = init_dataset(cfg, "validation")[0].select(range(1))
    with pytest.raises(ValueError, match="num_beams >= 2"):
        icv_inference_pooled(rows, bundle, pm, {"num_beams": 1, "max_new_tokens": 3},
                             progress=False)
    prepare = bundle.processor.prepare_input

    def navit(*a, **kw):
        enc = dict(prepare(*a, **kw))
        enc["pixel_attention_mask"] = np.ones(enc["pixel_values"].shape[:-1], np.int32)
        return enc

    monkeypatch.setattr(bundle.processor, "prepare_input", navit)
    with pytest.raises(ValueError, match="NaViT"):
        icv_inference_pooled(rows, bundle, pm, {"num_beams": 3, "max_new_tokens": 3},
                             progress=False)


@pytest.mark.parametrize("engine,beams", [("continuous", 1), ("continuous", 3), ("pooled", 3)],
                         ids=["continuous_greedy", "continuous_beam3", "pooled_beam3"])
def test_idefics2_served_cli_writes_the_static_predictions(env2, engine, beams):  # noqa: F811
    """``lmm=tiny-idefics2`` (fixed squares at this size) through the
    continuous engines and the pooled schedule, on 1- and 3-shot prompts
    of mixed buckets and image counts: the static path's predictions, and
    ``inference.py``'s."""
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = env2 / "ice_mixed.json"
    ice.write_text(json.dumps(ICE))
    args = [f"lmm={MODEL2}" if a.startswith("lmm=") else a for a in ARGS] + [
        f"ice_idx_list_cache={ice}", f"generate_kwargs.num_beams={beams}", "infer_pool=3"]
    static, served, jax_run = f"static{beams}", f"{engine}{beams}", f"jax{beams}"
    _runs(env2, (static, served, jax_run), MODEL2)
    torch_main(args + [f"run_name={static}", "device=cpu"])
    torch_main(args + [f"run_name={served}", "device=cpu", f"infer_engine={engine}"])
    jax_cli.main(args + [f"run_name={jax_run}"])
    for name in ("icv.json", "icl_shot1.json", "icl_shot3.json"):
        want = _preds2(env2, static, name)
        assert len(want) == 4 and any(want), (name, want)
        assert _preds2(env2, served, name) == want, name
        assert _preds2(env2, jax_run, name) == want, name


@pytest.mark.parametrize("engine,beams,quantized", [
    ("continuous", 1, False), ("continuous", 3, False), ("pooled", 3, False),
    ("continuous", 1, True),
], ids=["continuous_greedy", "continuous_beam3", "pooled_beam3", "int8_kv8_continuous_greedy"])
def test_openflamingo_served_cli_writes_the_static_predictions(env3, engine, beams,  # noqa: F811
                                                               quantized):
    """``lmm=tiny-flamingo`` (ALiBi, per-slot media, the cross-attention
    before each group's last layer) through the continuous engines and the
    pooled schedule on 1- and 3-shot prompts of mixed buckets and image
    counts, and the greedy engine with ``lmm.quantize=int8
    lmm.kv_cache=int8``: the static path's predictions, and
    ``inference.py``'s under the same options."""
    import inference as jax_cli
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    ice = env3 / "ice_mixed.json"
    ice.write_text(json.dumps(ICE))
    args = [f"lmm={MODEL3}" if a.startswith("lmm=") else a for a in ARGS] + [
        f"ice_idx_list_cache={ice}", f"generate_kwargs.num_beams={beams}", "infer_pool=3",
        f"lmm.flamingo_checkpoint_dir={env3 / 'flamingo'}"]
    if quantized:
        args += ["lmm.quantize=int8", "lmm.kv_cache=int8"]
    static, served, jax_run = f"static{beams}", f"{engine}{beams}", f"jax{beams}"
    _runs(env3, (static, served, jax_run), MODEL3)
    torch_main(args + [f"run_name={static}", "device=cpu"])
    torch_main(args + [f"run_name={served}", "device=cpu", f"infer_engine={engine}"])
    jax_cli.main(args + [f"run_name={jax_run}"])
    for name in ("icv.json", "icl_shot1.json", "icl_shot3.json"):
        want = _preds3(env3, static, name)
        assert len(want) == 4 and any(want), (name, want)
        assert _preds3(env3, served, name) == want, name
        assert _preds3(env3, jax_run, name) == want, name
