"""Tensor, data and sequence parallelism on ``torch.distributed``
(counterpart of ``licv_vqa_tpu/parallel``): the sharding rules and the
Megatron collectives (``sharding.py``), the ring attention over the sp axis
(``ring.py``)."""
