"""Device selection for the port.

Entry points run on the card. The CPU is used only when the caller asks
for it, by passing `device="cpu"` to a library function or by setting
`COVERM_TPU_TORCH_DEVICE=cpu` (the counterpart of the JAX package's
`COVERM_TPU_PLATFORM`). Without a card and without that request the
package raises: it never runs on the CPU quietly.
"""

from __future__ import annotations

import os

import torch

ENV_VAR = "COVERM_TPU_TORCH_DEVICE"


def default_device() -> torch.device:
    """`cuda`, or `cpu` when COVERM_TPU_TORCH_DEVICE=cpu is set."""
    want = os.environ.get(ENV_VAR, "").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise ValueError(f"{ENV_VAR} must be 'cuda' or 'cpu', not {want!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "coverm_tpu_torch needs a CUDA device and none is available; "
            f"set {ENV_VAR}=cpu to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """An explicit device argument, or default_device() when None."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coverm_tpu_torch was asked for a CUDA device and none is "
            "available")
    return device
