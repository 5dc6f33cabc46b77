"""Device and numeric-precision policy of the port, in one place.

Every entry point takes an explicit ``device``; the default is CUDA and
there is no silent CPU fallback (`resolve_device`). The fp32 serving path
runs with both TF32 switches **off** (`set_tf32(False)`), so a float32
convolution on the card keeps float32 products like the matmuls do.
`card_name_and_power` reads the card's name and power limit, which every
measurement is written beside.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. Raises when a CUDA device is asked for (or
    defaulted to) and there is none; the CPU is used only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "detectax_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def set_tf32(enabled: bool = False) -> dict:
    """Set the matmul and cuDNN TF32 switches together; returns the state."""
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    return tf32_state()


def tf32_state() -> dict:
    return {
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }


def card_name_and_power() -> str:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (the card's name and power limit as it prints
    them), or what went wrong instead: a measurement never carries a
    figure that was not read on the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=60,
        ).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {type(e).__name__}: {e}"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave nothing"
