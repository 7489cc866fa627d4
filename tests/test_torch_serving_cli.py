"""``infer_engine=continuous`` through the port CLI (CPU, tiny-idefics).

On ``tests/test_torch_cli.py``'s synthetic VQAv2 split, HF-layout
checkpoint, ICV checkpoint and seeded tokenizer (equal predictions mean
equal tokens): the continuous engines write the static path's predictions
for ``test_icv`` and for ``test_icl`` with ``few_shot_list=[1,3]`` over a
fixed ice-index cache whose rows mix 1 and 3 shots (mixed buckets and image
counts), greedy and beam-3 (``tests/test_cli_e2e.py:191`` and ``:298``),
and JAX's ``inference.py`` writes the same on the same split.  The pooled
engine, the serving mesh and continuous serving of another family raise
with their ROADMAP item.
"""

import json
import shutil

import pytest

from tests.test_torch_cli import MODEL, _preds, env  # noqa: F401  (fixture)
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


def _runs(env, names):
    """An ICV checkpoint under each run name (a copy of the fixture's)."""
    cpk = env / "results" / "model_cpk" / "vqav2" / MODEL
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


@pytest.mark.parametrize("extra,item", [
    (["infer_engine=pooled"], "item 14"),
    (["infer_engine=continuous", "infer_dp=2"], "item 16"),
    (["infer_engine=continuous", "lmm=tiny-idefics2"], "item 13b"),
    (["infer_engine=continuous", "lmm=tiny-flamingo"], "item 22"),
])
def test_what_the_cli_does_not_serve_raises_with_its_roadmap_item(env, extra, item):  # noqa: F811
    from licv_vqa_tpu_torch.cli.inference import main as torch_main

    with pytest.raises(NotImplementedError, match=item):
        torch_main(ARGS + ["run_name=refused", "device=cpu", *extra])
