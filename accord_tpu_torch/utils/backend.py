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
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no card {dev}: {torch.cuda.device_count()} "
                           f"visible")
    cap =torch.cuda.get_device_capability(dev)
    if cap != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a (Hopper)")
    return dev


def resolve_devices(devices) -> list:
    """`devices` (a list of devices, or "all" for every visible card) ->
    the list of torch.devices that a sharded step or a mesh store spreads
    its shards over, in order.  Each CUDA entry is checked as
    ``resolve_device`` checks it (a visible sm_90 card; None means
    ``cuda:0``); a card named twice, an empty list, or CUDA entries mixed
    with the CPU raise.  "cpu" entries may repeat: the tests stand several
    CPU "devices" in for the cards."""
    if isinstance(devices, str):
        if devices != "all":
            raise ValueError(f"devices must be a list or 'all', got "
                             f"{devices!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("devices='all': no CUDA device is available")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("an empty list of devices")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"CUDA cards mixed with the CPU: {out}")
    cards = [d for d in out if d.type == "cuda"]
    if len(set(cards)) != len(cards):
        raise ValueError(f"a card is named twice: {out}")
    return out


def resolve_spread(device, devices):
    """The `device` and `devices` of a step or store that may spread its
    shards over several devices -> (the torch.device of its one-device
    work, the resolved `devices` or None).  With `devices` that is
    devices[0], which `device`, if given too, must be."""
    if devices is None:
        return resolve_device(device), None
    devices = resolve_devices(devices)
    if device is not None and resolve_device(device) != devices[0]:
        raise ValueError(f"device {device} is not devices[0] {devices[0]}")
    return devices[0], devices


def card_name_and_power_limit() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"): every time the port reports is
    labelled with it, since a card set below its maximum power runs slower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
