"""Tensor and data parallelism on ``torch.distributed`` (counterpart of
``licv_vqa_tpu/parallel``; the ring attention of ``parallel/ring.py`` is
ROADMAP.md Queue 1 item 16b)."""
