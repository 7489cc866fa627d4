"""LICV-VQA on PyTorch and CUDA: the port of ``licv_vqa_tpu`` to one NVIDIA H100.

The module layout and names mirror ``licv_vqa_tpu`` so each module's JAX
counterpart is found under the same path.  Parameters keep the JAX layout at
every public function (nested dicts, ``(in, out)`` kernels, layer-stacked
``(L, ...)`` leaves), so JAX params carry across without renaming
(``models.weights.params_from_jax``).

This package imports ``torch`` and never ``jax``.  Of the JAX package it uses
only the host modules that are free of jax: ``licv_vqa_tpu.api``, ``.data``,
``.metrics`` and ``.utils``.

Kernels written by hand for Hopper (each beside its plain PyTorch version,
which runs only for CPU tensors):

- ``ops.icv_inject.icv_inject`` — the ICV residual edit, in Triton;
- ``models.layers.flash_attention`` — the causal flash-attention forward, in
  CUDA C++ (``csrc/flash_attn_fwd.cu``).
"""

__version__ = "0.1.0"
