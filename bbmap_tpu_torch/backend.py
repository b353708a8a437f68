"""Device checks for the port. Every entry point takes ``device``
explicitly; asking for CUDA where there is no card raises, and nothing
moves to the CPU on its own."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


# Share of the card's free memory that one fill launch's prev codes may
# take. A quarter: the fill's block of the chunk in flight and the next
# chunk's (the allocator hands the first back only when the stream has
# walked it) are then half of what is free, and the other half stays for
# the index, the batches, the band mapping's edge rows and the symbol
# rows that wait to be fetched. On an NVIDIA H100 80GB HBM3 with the 4.6 Mbp
# bench index resident that is about 19 GB a launch.
PREV_CODE_SHARE = 0.25
CPU_PREV_CODE_BUDGET = 2 << 30


def prev_code_budget(device: DeviceLike) -> int:
    """Bytes of prev codes one fill launch may allocate on ``device``: on a
    card ``PREV_CODE_SHARE`` of the memory free now
    (``torch.cuda.mem_get_info``), on the CPU 2 GiB."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free * PREV_CODE_SHARE)
    return CPU_PREV_CODE_BUDGET


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a torch.device, checked: 'cuda' needs a card."""
    if device is None:
        raise ValueError("device must be given explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
