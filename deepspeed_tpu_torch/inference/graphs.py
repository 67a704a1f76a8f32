"""The serving engine's decode programs captured as CUDA graphs.

Where the JAX engine compiles a decode program once and dispatches it
with one host call (decode_multi is one `lax.scan`), eager PyTorch issues
every op of every layer of every step from the host, and the card waits on
it. `InferenceEngine.warmup` therefore captures each decode program it
warms as one CUDA graph, and later calls replay it: one host call for a
whole decode_multi of n steps.

A program is keyed by `GraphKey`: batch width, steps (0 = the single
decode step of put()'s decode rows), whether its rows are distinct
sequences (the fused write+attend kernel), the block-table width, the
sampling config's key and whether it carries a presence bitmap.

- Inputs (tokens, tables, ctx, and for the sampled programs keys, step0,
  presence) live in static device buffers allocated before the capture; a
  replay copies the caller's values into them, so a replay after the
  block tables change reads the new blocks.
- The weights and the KV pools are the engine's own tensors, read and
  written in place by the graph. `InferenceEngine.refresh_params` makes
  new weight tensors, so it drops every graph; a replay never reads stale
  weights.
- A replay returns clones of the graph's outputs (tokens, logits,
  presence): the next replay overwrites the static outputs, not what a
  caller holds.
- All of an engine's graphs share one memory pool and one capture stream;
  they replay in turn on the caller's stream, and each rewrites its
  intermediates before it reads them, so sharing the pool is safe.
- Capture: `capture` first runs the program eagerly on the capture stream,
  which builds the kernels at first use (nvcc must not run inside a
  capture), sets each kernel's shared-memory attribute for the sizes it
  meets, sizes that stream's decode workspace (ops/cuda/paged_attention.py
  `_workspace`, which refuses to allocate under a capture and never frees
  a workspace a graph may hold) and cuBLAS's, and then captures the same
  call. A failed capture raises; nothing falls back to eager.
- Host-side state runs only at capture: the kernel wrappers' launch
  counters count the captured launches once, and a launch error of a
  replay surfaces at the next synchronisation.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch


class GraphKey(NamedTuple):
    width: int
    n_steps: int  # 0: one decode step returning its logits
    unique_rows: bool
    table_width: int
    sampling: Optional[Tuple[Any, ...]]  # SamplingConfig.key(), None = greedy
    with_presence: bool


class CapturedProgram:
    """One captured program: `run(*static_inputs)` -> a tuple of tensors
    (or None), recorded into a CUDA graph over static input buffers."""

    def __init__(self, key: GraphKey, run: Callable, inputs: Sequence[torch.Tensor],
                 pool, stream: torch.cuda.Stream):
        self.key = key
        self.static = [x.clone() for x in inputs]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = run(*self.static)

    def load(self, inputs: Sequence[torch.Tensor]) -> None:
        """Copy the caller's inputs (host or device tensors) into the
        static buffers, on the current stream."""
        for buf, x in zip(self.static, inputs):
            # from pinned host memory the copy is queued without waiting
            buf.copy_(x if x.is_cuda else x.pin_memory(), non_blocking=True)

    def results(self) -> Tuple[Optional[torch.Tensor], ...]:
        return tuple(None if o is None else o.clone() for o in self.outputs)

    def __call__(self, *inputs: torch.Tensor):
        self.load(inputs)
        self.graph.replay()
        return self.results()


class DecodeGraphs:
    """An engine's captured programs, their shared pool and capture
    stream, and the counts of replays, eager runs and captures."""

    def __init__(self, device: torch.device):
        self.device = device
        self.enabled = device.type == "cuda"  # the CPU has no graphs
        self.programs: Dict[GraphKey, CapturedProgram] = {}
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.replays = 0
        self.eager_runs = 0
        self.captures = 0

    def __len__(self) -> int:
        return len(self.programs)

    def get(self, key: GraphKey) -> Optional[CapturedProgram]:
        return self.programs.get(key)

    def capture(self, key: GraphKey, run: Callable, inputs: Sequence[torch.Tensor]):
        """Run `run(*inputs)` once eagerly on the capture stream, then
        capture it (see the module docstring). Returns the eager run's
        outputs."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = run(*inputs)
        caller.wait_stream(self.stream)
        try:
            self.programs[key] = CapturedProgram(key, run, inputs, self.pool, self.stream)
        except Exception as e:
            raise RuntimeError(f"capturing the decode program {key} as a CUDA graph "
                               f"failed: {e}") from e
        self.captures += 1
        return out

    def clear(self) -> int:
        """Drop every graph and the pool; returns how many there were."""
        n = len(self.programs)
        self.programs.clear()
        self.pool = None
        return n
