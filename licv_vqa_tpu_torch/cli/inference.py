"""ICV / ICL evaluation CLI of the port (counterpart of ``inference.py``).

Same contract as the JAX CLI: ``key=val`` overrides against
``config/inference.yaml``; ``test_icv`` (zero-shot + trained ICV) and
``test_icl`` (few-shot ICL over ``few_shot_list``); ``result.json`` +
``meta_info/*.json`` under ``result_dir/inference/<model>/<dataset>/<run>``;
an existing ``result.json`` exits early unless ``re_eval=true``.

``device`` selects the torch device: ``cuda`` by default (the shared config's
``tpu`` also means the accelerator), ``cpu`` for tests.  ``device=cuda``
without a GPU raises: the port never falls back to the CPU.  The JAX CLI's
mesh (``infer_dp``/``infer_tp``), engines (``infer_engine``) and RICE
retrieval (``use_rice``) are not ported yet and raise.

Examples:
    python inference_torch.py run_name=vqav2_idefics9b test_icv=true
    python inference_torch.py test_icl=true few_shot_list='[4,8]' device=cpu
"""

from __future__ import annotations

import datetime
import json
import random
import sys
from pathlib import Path

import torch

from ..api import init_dataset, init_prompt_manager
from ..infer.runner import icl_inference, icv_inference
from ..metrics import compute_cider, compute_vqa_accuracy
from ..models.registry import build_model
from ..train.checkpoint import load_icv_checkpoint
from ..utils import compose, get_icv_cpk_path, get_inference_paths, get_logger

logger = get_logger("inference_torch_cli")


def resolve_device(name) -> torch.device:
    """``cuda`` (also for the shared config's accelerator name ``tpu``) or
    ``cpu``.  A CUDA device that is not there raises."""
    name = str(name or "cuda").lower()
    if name in ("tpu", "gpu"):
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=cuda but torch.cuda.is_available() is False; pass device=cpu "
            "to run on the CPU"
        )
    return dev


def _not_ported(cfg) -> None:
    checks = (
        (int(cfg.get("infer_dp", 1)) != 1 or int(cfg.get("infer_tp", 1)) != 1,
         "infer_dp/infer_tp (the serving mesh)", "Queue 1 item 16"),
        (str(cfg.get("infer_engine", "static")) != "static",
         "infer_engine=continuous|pooled", "Queue 1 items 13-14"),
        (bool(cfg.get("use_rice", False)), "use_rice (RICE retrieval)", "Queue 1 item 15"),
    )
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to licv_vqa_tpu_torch yet (ROADMAP.md {item})"
            )


def evaluate_vqa(results_dict, model_name, val_ques_path, val_ann_path, post_fn):
    preds = [
        {
            "answer": post_fn(r["prediction"], model_name).replace("\n", "").strip(),
            "question_id": r["question_id"],
        }
        for r in results_dict.values()
    ]
    return compute_vqa_accuracy(preds, val_ques_path, val_ann_path)


def evaluate_caption(results_dict, model_name, val_ann_path, post_fn):
    preds = [
        {"image_id": r["image_id"], "caption": post_fn(r["prediction"], model_name)}
        for r in results_dict.values()
    ]
    return compute_cider(preds, val_ann_path) * 100


def main(argv: list[str] | None = None):
    cfg = compose("config", "inference", list(sys.argv[1:] if argv is None else argv))
    # reproducible ICL shot sampling (random.sample below)
    random.seed(int(cfg.get("seed", 42)))
    device = resolve_device(cfg.get("device"))
    _not_ported(cfg)
    model_name = str(cfg.lmm.model_name)
    result_dir = Path(str(cfg.result_dir))
    dataset_name = cfg.data_cfg.task.datasets.name

    save_dir, meta_info_dir, metric_file_path = get_inference_paths(
        result_dir=result_dir, model_name=model_name, dataset_name=dataset_name,
        run_name=cfg.run_name,
    )
    save_dir.mkdir(parents=True, exist_ok=True)
    meta_info_dir.mkdir(exist_ok=True)

    if not metric_file_path.exists():
        result_dict = {}
    elif cfg.re_eval:
        result_dict = json.loads(metric_file_path.read_text())
        logger.info("%s exists — re-evaluating", metric_file_path)
    else:
        logger.info("%s exists — exiting", metric_file_path)
        return json.loads(metric_file_path.read_text())

    icv_scaled = None
    if cfg.test_icv:
        cpk_dir = get_icv_cpk_path(
            result_dir, model_name=model_name, dataset_name=dataset_name,
            run_name=cfg.run_name,
        )
        loaded = load_icv_checkpoint(cpk_dir, device=device)
        icv_scaled = loaded["alpha"][:, None] * loaded["icv"]
        # the CHECKPOINT's lmm_args drive the intervention layers (reference
        # inference.py:102-108)
        ckpt_layers = loaded.get("lmm_args", {}).get("intervention_layer")
        if ckpt_layers is not None:
            cfg.lmm["intervention_layer"] = ckpt_layers
        logger.info("ICV loaded from %s", cpk_dir)

    bundle = build_model(cfg, device=device)
    prompt_manager = init_prompt_manager(cfg)
    task_name = str(cfg.data_cfg.task.task_name)
    base_info = f"{datetime.datetime.now()}-cfg.test_num={cfg.test_num}-"

    ds, post_fn = init_dataset(cfg, None if cfg.test_icl else "validation")
    if cfg.test_icl:
        val_ds, train_ds = ds["validation"], ds["train"]
        if cfg.train_num != -1:
            train_ds = train_ds.select(random.sample(range(len(train_ds)), int(cfg.train_num)))
    else:
        val_ds = ds
    if cfg.test_num != -1:
        val_ds = val_ds.select(range(int(cfg.test_num)))
    gen_kwargs = cfg.generate_kwargs.to_dict()

    def evaluate_and_store(results_dict, tag: str):
        if task_name == "vqa":
            acc = evaluate_vqa(
                results_dict, str(cfg.lmm.name),
                str(cfg.data_cfg.task.datasets.val_ques_path),
                str(cfg.data_cfg.task.datasets.val_ann_path), post_fn,
            )
            acc.pop("perQuestion", None)
            logger.info("%s ACC: %s", cfg.run_name, acc["overall"])
            result_dict[base_info + tag] = acc
        else:
            cider = evaluate_caption(
                results_dict, str(cfg.lmm.name),
                str(cfg.data_cfg.task.datasets.val_coco_annotation_file), post_fn,
            )
            logger.info("%s CIDEr: %s", cfg.run_name, cider)
            result_dict[base_info + tag] = cider
        metric_file_path.write_text(json.dumps(result_dict, indent=4))

    if cfg.test_icv:
        results = icv_inference(
            val_ds, bundle, prompt_manager, bs=int(cfg.bs), generate_kwargs=gen_kwargs,
            instruction=str(cfg.prompt.instruction), icv_scaled=icv_scaled,
        )
        evaluate_and_store(results, "icv result")
        (meta_info_dir / f"{base_info}icv.json").write_text(json.dumps(results, indent=4))

    if cfg.test_icl:
        for shot_num in list(cfg.few_shot_list):
            if cfg.ice_idx_list_cache is not None:
                ice_idx_list = json.loads(Path(str(cfg.ice_idx_list_cache)).read_text())
            else:
                pool = list(range(len(train_ds)))
                ice_idx_list = [random.sample(pool, int(shot_num)) for _ in range(len(val_ds))]
            results = icl_inference(
                train_ds, val_ds, ice_idx_list, bundle, prompt_manager, bs=int(cfg.bs),
                generate_kwargs=gen_kwargs, instruction=str(cfg.prompt.instruction),
            )
            metric_word = "ACC" if task_name == "vqa" else "CIDEr"
            evaluate_and_store(results, f"ICL shot_num: {shot_num} {metric_word} result")
            (meta_info_dir / f"icl_shot{shot_num}.json").write_text(json.dumps(results, indent=4))

    return result_dict
