"""A frozen, grad-free pass in one CUDA graph per input shape.

`FrozenGraphs` runs `fn(*inputs)`, a pass that returns a tuple of tensors
and reads the weights of modules that do not train (blip24cir's bank
encode, `Blip2CIR.fusion_bank_features`). A call runs `fn` eagerly unless
grad is disabled, no module of the pass is in training mode (dropout draws
from a generator) or carries `tp` (a tensor-parallel layer, `parallel.tp`:
no collective is captured), and every input is a CUDA tensor of one device.
Otherwise, for each key (every input's shape and dtype, the device):

  - the first call runs eagerly: the kernels load and the allocator warms;
  - the second captures `fn` over static copies of the inputs;
  - every call from then on copies its inputs into those buffers, replays
    the graph and returns fresh copies of its outputs, so no two calls
    alias and a caller may keep what it got.

The weights are read at their addresses: an in-place update reaches the
next replay. Each call compares the addresses of the modules' own
parameters and buffers with those at capture and captures again when one
has moved (`load_state_dict(..., assign=True)`, `p.data = ...`, a new
`nn.Parameter`, a tensor-parallel cut put back on other tensors).

Launch counters follow `ops/cuda_build`'s rule: the capture runs under
`capturing()` and every replay counts its launches with `replayed`, so the
`ops/` wrappers' `.launches` count what is put on the device.

The keys of one `FrozenGraphs` share one memory pool. Every graph keeps its
outputs alive, so no later capture reuses their blocks and the keys may
replay in any order. A recapture keeps the old graph until the new one is
made, so the pool is never left without a graph; `drop()` frees a pass's
graphs and its pool, `drop_all()` those of every pass in the process (the
bank extraction's end).

Counters of the `counter` given (an object with int attributes, e.g. the
public function): `.eager_calls`, `.captures` and `.replays`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from spn4cir_tpu_torch.ops.cuda_build import Launches, capturing, replayed

_LIVE: "weakref.WeakSet[FrozenGraphs]" = weakref.WeakSet()


def on_one_cuda_device(inputs: Sequence[torch.Tensor]) -> bool:
    dev = inputs[0].device
    return dev.type == "cuda" and all(x.device == dev for x in inputs)


def capture_graph(fn: Callable, inputs: Sequence[torch.Tensor], pool
                  ) -> Tuple[torch.cuda.CUDAGraph, Tuple[torch.Tensor, ...]]:
    """`fn(*inputs)` captured (nothing runs) into a new graph in `pool`;
    the graph and its outputs."""
    graph = torch.cuda.CUDAGraph()
    # the capture stream is the current device's; other threads (a
    # loader's) may touch CUDA meanwhile: only this thread's calls are
    # checked against the capture
    with torch.cuda.device(inputs[0].device), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        outputs = tuple(fn(*inputs))
    return graph, outputs


@dataclasses.dataclass
class _Graph:
    inputs: Tuple[torch.Tensor, ...]     # the static buffers it reads
    graph: torch.cuda.CUDAGraph
    outputs: Tuple[torch.Tensor, ...]    # the buffers it writes
    launches: Launches
    addresses: Tuple[int, ...]           # the weights', at capture


class FrozenGraphs:
    """The graphs of one pass, by key; see the module doc."""

    def __init__(self, counter):
        self.counter = counter
        self.pool = None
        # key -> None after the key's eager first call, then its graph
        self.graphs: Dict[tuple, Optional[_Graph]] = {}
        _LIVE.add(self)

    @staticmethod
    def check(reads: Sequence, inputs: Sequence[torch.Tensor]
              ) -> Tuple[Optional[str], Tuple[int, ...]]:
        """(why the call runs eagerly: "grad", "training", "tp" or
        "device"; None to graph it, with the addresses of what the pass
        reads in place: each tensor of `reads`, and the parameters and
        buffers of each module of `reads` and every module under it)."""
        if torch.is_grad_enabled():
            return "grad", ()
        addresses = []
        stack = list(reads)
        # a plain walk over the modules' own dicts, kept to what it must
        # read: ~640 modules and ~840 tensors a blip24cir batch, on the
        # host while the card waits (`nn.Module.modules()` would build
        # every module's name)
        while stack:
            m = stack.pop()
            if m is None:
                continue
            if isinstance(m, torch.Tensor):
                addresses.append(m.data_ptr())
                continue
            d = m.__dict__
            if d["training"]:
                return "training", ()
            if d.get("tp") is not None:
                return "tp", ()
            for t in d["_parameters"].values():
                if t is not None:
                    addresses.append(t.data_ptr())
            if d["_buffers"]:
                for t in d["_buffers"].values():
                    if t is not None:
                        addresses.append(t.data_ptr())
            stack.extend(d["_modules"].values())
        if not on_one_cuda_device(inputs):
            return "device", ()
        return None, tuple(addresses)

    def __call__(self, fn: Callable, reads: Sequence,
                 *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """`fn(*inputs)`, eagerly or through the key's graph. `reads` holds
        the modules (with every module under them) and the loose tensors
        whose weights `fn` reads."""
        why, addresses = self.check(reads, inputs)
        key = (*((tuple(x.shape), x.dtype) for x in inputs), inputs[0].device)
        if why is None and key not in self.graphs:
            self.graphs[key] = None
            why = "first call"
        if why is not None:
            self.counter.eager_calls += 1
            return fn(*inputs)
        entry = self.graphs[key]
        if entry is None or entry.addresses != addresses:
            # a moved weight's old graph is freed once the new one is made
            entry = self.graphs[key] = self._capture(fn, inputs, addresses)
        for buf, x in zip(entry.inputs, inputs):
            buf.copy_(x)
        entry.graph.replay()
        replayed(entry.launches)
        self.counter.replays += 1
        return tuple(t.clone() for t in entry.outputs)

    def _capture(self, fn, inputs, addresses) -> _Graph:
        # normal tensors, written in place under inference mode or not
        with torch.inference_mode(False):
            statics = tuple(torch.empty_like(
                x, memory_format=torch.contiguous_format) for x in inputs)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        with capturing() as launches:
            graph, outputs = capture_graph(fn, statics, self.pool)
        self.counter.captures += 1
        return _Graph(statics, graph, outputs, launches, addresses)

    def drop(self) -> None:
        """Free every graph, and with them the pool: the allocator refuses
        a capture into a pool whose graphs are all gone, so the next
        capture takes a new one. A later call starts eagerly again."""
        self.graphs.clear()
        self.pool = None


def drop_all() -> None:
    """Free the graphs of every `FrozenGraphs` in the process."""
    for graphs in list(_LIVE):
        graphs.drop()
