"""PyTorch + CUDA port of loam_tpu for one NVIDIA H100.

Same module names as ``loam_tpu`` so each counterpart is easy to find;
plain functions on tensors, dataclasses of tensors for the containers,
and hand-written CUDA kernels (``csrc/*.cu``, wrapped in ``ops/cuda/``)
where the JAX package runs Pallas kernels on the TPU.  The package
imports ``torch``, never ``jax`` and nothing of ``loam_tpu``: it keeps
its own ``config`` and ``io.synth``.  Its entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
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


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA
    device.  A CUDA device raises where there is none (never a silent
    CPU run)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "loam_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" "
            "(--device cpu on the command line) to run on the CPU")
    return device
