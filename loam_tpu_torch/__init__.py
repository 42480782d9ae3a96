"""PyTorch + CUDA port of loam_tpu for one NVIDIA H100.

Same module names as ``loam_tpu`` so each counterpart is easy to find;
plain functions on tensors, dataclasses of tensors for the containers,
and hand-written CUDA kernels (``csrc/*.cu``, wrapped in ``ops/cuda/``)
where the JAX package runs Pallas kernels on the TPU.  The package
imports ``torch`` and never ``jax``; of ``loam_tpu`` it uses only the
framework-free ``config`` and ``io.synth`` modules.
"""

from __future__ import annotations

import torch


def configure_numerics() -> None:
    """Pin every float32 contraction to IEEE fp32.

    The neighbour searches and residuals resolve centimetre gaps at
    tens of metres; TF32 keeps ~3 decimal digits and would swamp them
    (the same reason the JAX package asks for Precision.HIGHEST)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
