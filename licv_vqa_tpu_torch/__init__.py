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

- ``ops.icv_inject.icv_inject`` — the ICV residual edit, forward and
  backward, in Triton;
- ``models.layers.flash_attention`` — the causal flash-attention forward, in
  CUDA C++ (``csrc/flash_attn_fwd.cu``);
- ``ops.masked_kl_kernel.masked_kl_pallas`` — the masked temperature-KL,
  forward and fused backward, in Triton.
"""

__version__ = "0.2.0"
