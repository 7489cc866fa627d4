"""The port stands alone: no ``jax`` and no ``licv_vqa_tpu`` module is
imported by ``licv_vqa_tpu_torch``, ``inference_torch.py``, ``train_torch.py``
or ``chip_smoke.py``; and the host modules the port copied give the JAX
package's outputs on the same inputs."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ("inference_torch.py", "train_torch.py", "chip_smoke.py")


def test_port_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import licv_vqa_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'licv_vqa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import inference_torch, train_torch, chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'licv_vqa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in (REPO / "licv_vqa_tpu_torch").rglob("*.py"))
    + list(SCRIPTS),
)
def test_no_import_statement_names_jax_or_the_jax_package(path):
    """Also the imports inside functions, which an import sweep never runs."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "licv_vqa_tpu"), (path, name)


# ---------------------------------------------------------------------------
# The host copies against their originals
# ---------------------------------------------------------------------------

GOLDENS = json.loads((REPO / "tests" / "fixtures" / "metric_goldens.json").read_text())


def _vqa_files(tmp_path):
    answers = ["two", "2", "red", "a cat", "yes", "no", "blue", "Dogs"]
    anns, ques, preds = [], [], []
    for i, ans in enumerate(answers):
        gts = [ans] * (i % 4) + ["other"] * (10 - i % 4)
        anns.append({
            "question_id": i, "image_id": i, "question_type": f"t{i % 2}",
            "answer_type": "other", "multiple_choice_answer": ans,
            "answers": [{"answer": a, "answer_id": j} for j, a in enumerate(gts)],
        })
        ques.append({"question_id": i, "image_id": i, "question": "q?"})
        preds.append({"question_id": i, "answer": answers[(i * 3) % len(answers)] + "."})
    (tmp_path / "a.json").write_text(json.dumps({"annotations": anns}))
    (tmp_path / "q.json").write_text(json.dumps({"questions": ques}))
    return preds, str(tmp_path / "q.json"), str(tmp_path / "a.json")


def test_metric_copies_match(tmp_path):
    from licv_vqa_tpu import metrics as jx
    from licv_vqa_tpu_torch import metrics as pt

    preds, q, a = _vqa_files(tmp_path)
    assert pt.compute_vqa_accuracy(preds, q, a) == jx.compute_vqa_accuracy(preds, q, a)

    for corpus in GOLDENS["cider_corpora"]:
        path = tmp_path / f"{corpus['name']}.json"
        refs = corpus["references"]
        path.write_text(json.dumps({
            "images": [{"id": int(k)} for k in refs],
            "annotations": [
                {"image_id": int(k), "id": i * 100 + j, "caption": c}
                for i, (k, caps) in enumerate(refs.items()) for j, c in enumerate(caps)
            ],
        }))
        hyps = [{"image_id": int(k), "caption": v} for k, v in corpus["hypotheses"].items()]
        assert pt.compute_cider(hyps, str(path)) == jx.compute_cider(hyps, str(path))

    texts = [c["input"] for c in GOLDENS["okvqa_postprocess"]] + [
        "Two dogs. Question: x", "yes\nno", "A red bus, Answer: blue", "skiing",
    ]
    for fn in ("vqa_postprocess", "ok_vq_postprocess", "caption_postprocess"):
        for model in ("idefics-9b", "idefics2-8b-base", "open_flamingo"):
            for text in texts:
                assert getattr(pt, fn)(text, model) == getattr(jx, fn)(text, model), (fn, text)


def _processor(pkg):
    proc_mod = __import__(f"{pkg}.data.processor", fromlist=["x"])
    tok_mod = __import__(f"{pkg}.data.tokenizer", fromlist=["x"])
    return proc_mod.PromptProcessor(
        tok_mod.WhitespaceTokenizer(),
        proc_mod.ImageTransform(28, proc_mod.CLIP_MEAN, proc_mod.CLIP_STD),
        family="idefics", max_length=256,
    )


def test_processor_and_collator_copies_match():
    from licv_vqa_tpu.data.collator import collate_icv_batch as jx_collate
    from licv_vqa_tpu_torch.data.collator import collate_icv_batch as pt_collate

    rng = np.random.default_rng(0)
    img = [rng.integers(0, 255, size=(20 + 4 * i, 24, 3), dtype=np.uint8) for i in range(4)]
    prompts = [
        ["Answer briefly.", img[0], "Question: what is it? Short answer: a cat"],
        [img[1], "Question: how many? Short answer:", img[2], "two"],
    ]
    jp, pp = _processor("licv_vqa_tpu"), _processor("licv_vqa_tpu_torch")
    for side in ("left", "right"):
        want = jp.prepare_input(prompts, padding=True, padding_side=side, add_eos_token=True)
        got = pp.prepare_input(prompts, padding=True, padding_side=side, add_eos_token=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    items = [
        {
            "query_prompt": [img[i], f"Question: q{i}? Short answer: a{i}"],
            "query_x": [img[i], f"Question: q{i}? Short answer:"],
            "ice_prompt": [img[3 - i], f"Question: s{i}? Short answer: b{i}\n"],
        }
        for i in range(3)
    ]
    want = jx_collate(items, _processor("licv_vqa_tpu"))
    got = pt_collate(items, _processor("licv_vqa_tpu_torch"))
    for k in ("in_context_length", "query_x_length"):
        np.testing.assert_array_equal(got[k], want[k])
    for view in ("query_inputs", "inputs"):
        for k in want[view]:
            np.testing.assert_array_equal(got[view][k], want[view][k], err_msg=(view, k))
