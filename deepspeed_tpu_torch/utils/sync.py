"""The one named host-sync choke point.

Counterpart of deepspeed_tpu/utils/sync.py. Benchmarks and profiling
scripts synchronise with the card at end-of-run or per-trial boundaries;
hot paths must not. Every deliberate blocking point of the port goes
through these functions, so each one is findable by name.

`serving_readback` is the serving scheduler's one host readback a step.
Where JAX's device_get of step N's tokens waits only for the program that
made them, a plain `.cpu()` in PyTorch waits for everything queued on the
stream, step N+1 included. So the scheduler starts the readback of each
step's sampled tokens as it is dispatched (`start_readback`: an async
device-to-host copy into pinned memory and an event behind it), and
`serving_readback` later waits on that event alone.
"""

from typing import Any, Optional

import numpy as np
import torch

__all__ = ["host_sync", "serving_readback", "start_readback", "Readback"]


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def host_sync(tree: Any) -> Any:
    """Block until every CUDA tensor of `tree` has been computed, then
    return it. For trial and run boundaries, never inside a step loop."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class Readback:
    """A device tensor's copy to the host, started but not waited on: on
    a CUDA tensor a non-blocking copy into pinned memory with an event
    recorded behind it; on a CPU tensor the tensor itself."""

    __slots__ = ("host", "event")

    def __init__(self, x: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = x

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def start_readback(x: torch.Tensor) -> Readback:
    """Queue the host copy of `x` on the current stream (see Readback)."""
    return Readback(x.detach())


def serving_readback(x: Any) -> np.ndarray:
    """The serving scheduler's one host readback a step: the sampled token
    ids ([bucket] or [chunk, bucket] int32) of a dispatched step. Given a
    Readback it waits for that copy only; given a tensor it copies and
    waits for the stream."""
    if isinstance(x, Readback):
        return x.wait()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

