"""Run-directory layout, kept identical to the reference.

Checkpoints: ``result_dir/model_cpk/<dataset>/<model>/<run_name>``
(reference: utils.py:17-20); inference results:
``result_dir/inference/<model>/<dataset>/<run_name>`` with ``meta_info/`` and
``result.json`` inside (reference: utils.py:23-28).
"""

from __future__ import annotations

from pathlib import Path


def get_icv_cpk_path(
    result_dir: str | Path, model_name: str, dataset_name: str, run_name: str
) -> Path:
    return Path(result_dir) / "model_cpk" / dataset_name / model_name / run_name


def get_inference_paths(
    result_dir: str | Path, model_name: str, dataset_name: str, run_name: str
) -> tuple[Path, Path, Path]:
    save_dir = Path(result_dir) / "inference" / model_name / dataset_name / run_name
    return save_dir, save_dir / "meta_info", save_dir / "result.json"
