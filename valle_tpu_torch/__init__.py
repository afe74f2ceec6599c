"""VALL-E zero-shot TTS in PyTorch with hand-written Hopper kernels.

A port of the ``valle_tpu`` JAX package. Module paths mirror the JAX
package (``valle_tpu/models/inference.py`` -> ``valle_tpu_torch/models/
inference.py``), public functions keep its layouts (attention
``(B, H, T, Dh)``, sequences ``(B, T, D)``, codes ``(B, T, Q)``), and the
``nn.Module`` parameter names are the upstream reference's ``state_dict``
names. Nothing here imports JAX.

The CUDA kernels (``csrc/``) build at first use on a CUDA device; a CPU
tensor runs each kernel's plain PyTorch version instead.
"""
