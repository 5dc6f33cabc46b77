"""What the measurement programs share: the device check that starts
them, the synchronise that closes a timed window, the label of the device
a line ran on, the kernel launches counted since a point, a line printed
and the environment an arm runs under."""
from __future__ import annotations

import contextlib
import json
import os
import sys

import torch

from detectax_torch.kernels import _common as kcommon


def probe_cuda() -> str | None:
    """None when a CUDA device answers a first tiny operation, else the
    reason it does not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: no CUDA device"
    try:
        float(torch.ones((), device="cuda") + 1.0)
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    return None


def require_cuda(program: str) -> torch.device:
    """The CUDA device, or exit 1 with the reason on standard error: the
    programs have no CPU branch."""
    reason = probe_cuda()
    if reason is not None:
        sys.stderr.write(f"{program} needs a CUDA device: {reason}\n")
        sys.exit(1)
    return torch.device("cuda", torch.cuda.current_device())


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        return f"cuda:{index} {torch.cuda.get_device_name(index)}"
    return str(device)


def launches_since(before: dict) -> dict:
    """Kernel launches counted since ``before`` (`_common.launch_counts`)."""
    now = kcommon.launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def emit(line: dict) -> dict:
    """Print ``line`` as one JSON line, at once."""
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def scoped_env(env: dict, clear=()):
    """``env`` set, and the ``clear`` keys unset, inside; every key as it
    was after (the programs also run inside `chip_smoke.py`, whose later
    phases must not see an arm's switches)."""
    keys = set(env) | set(clear)
    old = {k: os.environ.get(k) for k in keys}
    for k in clear:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
