"""Device selection for the port.

Every entry point takes ``device=None``, which means the CUDA card.  The port
is written for Hopper (sm_90a kernels), so the card must report compute
capability 9.0; anything else raises instead of falling back.  The CPU runs
only when the caller asks for it with ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import subprocess

import torch

HOPPER = (9, 0)


def resolve_device(device=None) -> torch.device:
    """`device` (None, a string or a torch.device) -> the torch.device to
    run on.  None means ``cuda:0``; a CUDA device must be an sm_90 card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a (Hopper)")
    return dev


def card_name_and_power_limit() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"): every time the port reports is
    labelled with it, since a card set below its maximum power runs slower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
