"""ICV / ICL evaluation CLI of the port (counterpart of ``inference.py``).

Same contract as the JAX CLI: ``key=val`` overrides against
``config/inference.yaml``; ``test_icv`` (zero-shot + trained ICV) and
``test_icl`` (few-shot ICL over ``few_shot_list``); ``result.json`` +
``meta_info/*.json`` under ``result_dir/inference/<model>/<dataset>/<run>``;
an existing ``result.json`` exits early unless ``re_eval=true``.

``device`` selects the torch device: ``cuda`` by default (the shared config's
``tpu`` also means the accelerator), ``cpu`` for tests.  ``device=cuda``
without a GPU raises: the port never falls back to the CPU.  ``use_rice``
picks the ICL shots by CLIP image similarity (``retrieval/rice.py``; the
encoder under ``$CLIP_CPK_DIR``, else ``HashEncoder``), and
``generate_kwargs.speculative_draft_layers`` decodes greedily with a
layer-truncated draft (``infer/speculative.py``).
``infer_engine=continuous`` runs ``test_icv`` and ``test_icl`` through the
continuous-batching engines (``infer/serving.py``: greedy, or beam groups;
``bs`` slots; every family, Idefics2's NaViT images included);
``infer_engine=pooled`` through the pooled beam schedule
(``infer/eval_chain.py``: chunks of ``infer_pool`` questions, default 32;
beam search only; Idefics2 at uniform resolution).  ``infer_dp`` /
``infer_tp`` (the JAX CLI's mesh; -1 dp = every rank over tp) run the
static runner with one process per rank under
``python -m torch.distributed.run``: each rank on ``cuda:LOCAL_RANK`` (or
the CPU), over ``nccl`` (``gloo`` on the CPU),
the eval batches split over dp and the frozen weights over tp; rank 0
writes ``result.json`` and ``meta_info``.  The engines and the pooled chain
under a mesh are ROADMAP.md Queue 1 item 16b and raise.

Examples:
    python inference_torch.py run_name=vqav2_idefics9b test_icv=true
    python inference_torch.py test_icl=true few_shot_list='[4,8]' device=cpu
    python inference_torch.py test_icl=true use_rice=true few_shot_list='[4]'
    python inference_torch.py test_icv=true infer_engine=continuous bs=8
    python inference_torch.py test_icv=true test_icl=true infer_engine=pooled infer_pool=32
    python -m torch.distributed.run --standalone --nproc_per_node=2 inference_torch.py \
        test_icv=true infer_tp=2
"""

from __future__ import annotations

import datetime
import json
import random
import sys
from pathlib import Path

import torch

from ..api import init_dataset, init_prompt_manager
from ..core.distributed import is_main_process, maybe_initialize_distributed, shutdown_distributed
from ..core.mesh import MeshConfig, create_mesh, using_mesh
from ..infer.runner import (
    icl_inference,
    icl_inference_continuous,
    icl_inference_pooled,
    icv_inference,
    icv_inference_continuous,
    icv_inference_pooled,
)
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


def mesh_config(infer_dp: int, infer_tp: int, world_size: int) -> MeshConfig:
    """The serving mesh of ``infer_dp`` x ``infer_tp`` over the launcher's
    ranks (JAX inference.py:78-95): ``infer_dp=-1`` takes every rank over
    tp; the product must be the world size (one process per device)."""
    tp = max(infer_tp, 1)
    dp = world_size // tp if infer_dp == -1 else max(infer_dp, 1)
    if dp * tp != world_size:
        raise ValueError(
            f"infer_dp={infer_dp} x infer_tp={infer_tp} needs {dp * tp} ranks, the launcher "
            f"started {world_size} (python -m torch.distributed.run --nproc_per_node={dp * tp})")
    return MeshConfig(dp=dp, tp=tp, sp=1)


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
    infer_dp, infer_tp = int(cfg.get("infer_dp", 1)), int(cfg.get("infer_tp", 1))
    engine = str(cfg.get("infer_engine", "static"))
    if (infer_dp, infer_tp) != (1, 1) and engine != "static":
        raise NotImplementedError(
            f"infer_engine={engine} under infer_dp/infer_tp (a slot pool sharded over dp) is "
            "not ported to licv_vqa_tpu_torch yet (ROADMAP.md Queue 1 item 16b)")
    launched = maybe_initialize_distributed(device.type)
    try:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        with using_mesh(create_mesh(mesh_config(infer_dp, infer_tp, world))) as mesh:
            return _main(cfg, launched or device, mesh, engine)
    finally:
        if launched is not None:
            shutdown_distributed()


def _main(cfg, device, mesh, engine: str):
    main_rank = is_main_process()
    model_name = str(cfg.lmm.model_name)
    result_dir = Path(str(cfg.result_dir))
    dataset_name = cfg.data_cfg.task.datasets.name

    save_dir, meta_info_dir, metric_file_path = get_inference_paths(
        result_dir=result_dir, model_name=model_name, dataset_name=dataset_name,
        run_name=cfg.run_name,
    )
    if main_rank:
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

    bundle = build_model(cfg, device=device, mesh=mesh)
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
        if main_rank:
            metric_file_path.write_text(json.dumps(result_dict, indent=4))

    # infer_engine=continuous: the slot-based engines (greedy pools, beam
    # group pools; ``bs`` slots); pooled: the pooled beam schedule
    # (``infer_pool`` questions a chunk); the default stays static
    continuous, pooled = engine == "continuous", engine == "pooled"
    pool_questions = int(cfg.get("infer_pool", 32))

    if (continuous or pooled) and int(gen_kwargs.get("num_beams", 1)) > 1 and float(
            gen_kwargs.get("length_penalty", 0.0)) != 0.0:
        logger.warning(
            "infer_engine=%s with num_beams>1 and length_penalty=%s: the lp divisor "
            "counts the true prompt length (continuous: an unpadded bs=1 HF run) or its "
            "64-multiple bucket (pooled); the static path uses the padded batch length — "
            "predictions may differ between engines", engine, gen_kwargs.get("length_penalty"),
        )

    if cfg.test_icv:
        if pooled:
            results = icv_inference_pooled(
                val_ds, bundle, prompt_manager, generate_kwargs=gen_kwargs,
                instruction=str(cfg.prompt.instruction), icv_scaled=icv_scaled,
                pool_questions=pool_questions,
            )
        elif continuous:
            results = icv_inference_continuous(
                val_ds, bundle, prompt_manager, generate_kwargs=gen_kwargs,
                instruction=str(cfg.prompt.instruction), icv_scaled=icv_scaled,
                n_slots=int(cfg.bs),
            )
        else:
            results = icv_inference(
                val_ds, bundle, prompt_manager, bs=int(cfg.bs), generate_kwargs=gen_kwargs,
                instruction=str(cfg.prompt.instruction), icv_scaled=icv_scaled,
            )
        evaluate_and_store(results, "icv result")
        if main_rank:
            (meta_info_dir / f"{base_info}icv.json").write_text(json.dumps(results, indent=4))

    if cfg.test_icl:
        if cfg.use_rice:
            from ..retrieval.rice import MMTopkRetriever

            cache_dir = result_dir / "cache"
            cache_dir.mkdir(parents=True, exist_ok=True)
            base_info += "-RICE"
            retriever = MMTopkRetriever(
                index_ds=train_ds, test_ds=val_ds, mode="i2i", index_field="image",
                batch_size=8, device=device,
                cache_file=str(cache_dir / f"{dataset_name}_{cfg.test_num}_rice_imgemb.pkl"),
            )
        for shot_num in list(cfg.few_shot_list):
            if cfg.use_rice:
                ice_idx_list = retriever.retrieve(int(shot_num))
            elif cfg.ice_idx_list_cache is not None:
                ice_idx_list = json.loads(Path(str(cfg.ice_idx_list_cache)).read_text())
            else:
                pool = list(range(len(train_ds)))
                ice_idx_list = [random.sample(pool, int(shot_num)) for _ in range(len(val_ds))]
            if pooled:
                results = icl_inference_pooled(
                    train_ds, val_ds, ice_idx_list, bundle, prompt_manager,
                    generate_kwargs=gen_kwargs, instruction=str(cfg.prompt.instruction),
                    pool_questions=pool_questions,
                )
            elif continuous:
                results = icl_inference_continuous(
                    train_ds, val_ds, ice_idx_list, bundle, prompt_manager,
                    generate_kwargs=gen_kwargs, instruction=str(cfg.prompt.instruction),
                    n_slots=int(cfg.bs),
                )
            else:
                results = icl_inference(
                    train_ds, val_ds, ice_idx_list, bundle, prompt_manager, bs=int(cfg.bs),
                    generate_kwargs=gen_kwargs, instruction=str(cfg.prompt.instruction),
                )
            metric_word = "ACC" if task_name == "vqa" else "CIDEr"
            evaluate_and_store(results, f"ICL shot_num: {shot_num} {metric_word} result")
            if main_rank:
                (meta_info_dir / f"icl_shot{shot_num}.json").write_text(
                    json.dumps(results, indent=4))

    return result_dict
