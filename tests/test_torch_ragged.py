"""The allocator / hash-chain / copy-on-write cases of
tests/test_prefix_cache.py, re-run against the port's copy of the control
plane (deepspeed_tpu_torch/inference/ragged.py).

The case file is compiled here with its one import rebound from
`deepspeed_tpu.inference.ragged` to `deepspeed_tpu_torch.inference.ragged`,
and its test classes are collected from this module, so every case runs
unchanged against the port (and a case added there runs here too)."""

from pathlib import Path

import deepspeed_tpu_torch.inference.ragged as port_ragged

_SRC = Path(__file__).with_name("test_prefix_cache.py")
_REF = "from deepspeed_tpu.inference.ragged import ("
_PORT = "from deepspeed_tpu_torch.inference.ragged import ("


def _load_cases():
    text = _SRC.read_text()
    if text.count(_REF) != 1:
        raise RuntimeError(f"{_SRC.name}: expected one import of the JAX ragged module")
    ns = {"__name__": "test_prefix_cache_on_port", "__file__": str(_SRC)}
    exec(compile(text.replace(_REF, _PORT), str(_SRC), "exec"), ns)
    return {k: v for k, v in ns.items() if k.startswith("Test") and isinstance(v, type)}


globals().update(_load_cases())


def test_cases_bound_to_the_port():
    cases = _load_cases()
    assert len(cases) >= 6
    for cls in cases.values():
        for name in ("BlockedAllocator", "StateManager"):
            fn = next(v for k, v in vars(cls).items() if k.startswith("test_"))
            if name in fn.__globals__:
                assert fn.__globals__[name] is getattr(port_ragged, name)
