#!/usr/bin/env python
"""ICV training CLI on PyTorch + CUDA (the port of ``train.py``).

Same ``key=val`` contract and on-disk layout as ``train.py``; see
``licv_vqa_tpu_torch/cli/train.py``.

Examples:
    python train_torch.py run_name=vqav2_idefics9b icv_module.icv_lr=1e-3
    python train_torch.py lmm=tiny-idefics trainer=debug data_cfg.bs=2 device=cpu
"""

from licv_vqa_tpu_torch.cli.train import main
from licv_vqa_tpu_torch.utils import load_dotenv

if __name__ == "__main__":
    load_dotenv()
    main()
