"""LICV-VQA on PyTorch and CUDA: the port of ``licv_vqa_tpu`` to one NVIDIA H100.

The module layout and names mirror ``licv_vqa_tpu`` so each module's JAX
counterpart is found under the same path.  Parameters keep the JAX layout at
every public function (nested dicts, ``(in, out)`` kernels, layer-stacked
``(L, ...)`` leaves), so JAX params carry across without renaming
(``models.weights.params_from_jax``).

This package imports ``torch``, numpy and the standard library, never
``jax`` and nothing of ``licv_vqa_tpu``: the host modules it shares with the
JAX package (``api``, ``data``, ``metrics``, ``utils``) are its own copies,
held against the originals by ``tests/test_torch_imports.py``.

Kernels written by hand for Hopper (each beside its plain PyTorch version,
which runs only for CPU tensors):

- ``ops.icv_inject.icv_inject`` — the ICV residual edit, forward in
  Triton, backward in CUDA C++ (``csrc/icv_inject_bwd.cu``);
- ``models.layers.flash_attention`` — the causal flash-attention forward, in
  CUDA C++ (``csrc/flash_attn_fwd.cu``);
- ``ops.masked_kl_kernel.masked_kl_pallas`` — the masked temperature-KL,
  forward and fused backward, in Triton;
- ``ops.int8_matmul.int8_matmul`` and ``ops.int4_matmul.int4_matmul`` — the
  quantized decode matmuls, in CUDA C++ (``csrc/int8_matmul.cu``,
  ``csrc/int4_matmul.cu``);
- ``models.layers.flash_attention_bidir`` — the vision towers' long-sequence
  attention, in CUDA C++ (``csrc/flash_attn_bidir.cu``);
- ``ops.flash_alibi.flash_alibi_attention`` — MPT's causal attention with
  the ALiBi bias made in the kernel, in CUDA C++ (``csrc/flash_alibi.cu``);
- ``models.layers.vit_attention`` — the CLIP towers' fused short-sequence
  attention, in CUDA C++ (``csrc/vit_attention.cu``).
"""

__version__ = "0.2.0"
