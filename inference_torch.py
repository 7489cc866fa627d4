#!/usr/bin/env python
"""ICV / ICL evaluation CLI on PyTorch + CUDA (the port of ``inference.py``).

Same ``key=val`` contract and on-disk layout as ``inference.py``; see
``licv_vqa_tpu_torch/cli/inference.py``.

Examples:
    python inference_torch.py run_name=vqav2_idefics9b test_icv=true
    python inference_torch.py lmm=tiny-idefics test_icl=true device=cpu
"""

from licv_vqa_tpu_torch.cli.inference import main
from licv_vqa_tpu_torch.utils import load_dotenv

if __name__ == "__main__":
    load_dotenv()
    main()
