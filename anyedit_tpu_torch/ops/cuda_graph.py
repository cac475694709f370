"""A module's inference call replayed from a CUDA graph.

At batch 1 the Flux transformer enqueues about 8,000 small kernels a call
(the fp32 modulations, the per-head norms, RoPE, the plain attention), and
the host takes about as long to launch them as the card takes to run them,
so the call's time follows the host's speed. `Graphed(module)` captures
`module(*tensors)` once for each signature (the shapes, dtypes and device
of the arguments) and replays that graph on later calls: one launch a call.

The arguments are copied into the graph's static inputs and the output is
cloned out of its static output, so a caller sees the module's own
results. The graph reads the module's parameters where they lie: weights
copied into them in place (`copy_`, `load_state_dict`) reach the replays,
parameters replaced by new tensors do not. Calls on CPU tensors, and calls
while autograd records, go to the module directly.
"""

from __future__ import annotations

import torch


class Graphed:
    """`Graphed(module)(*tensors)`: `module(*tensors)`, from a CUDA graph
    where the tensors are on a CUDA device and no gradient is recorded.
    Other attributes (`cfg`, `k6_launches`) are read from the module."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.graphs: dict = {}

    def __getattr__(self, name: str):
        if name == "module":    # not set yet: no module to read from
            raise AttributeError(name)
        return getattr(self.module, name)

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() or not all(isinstance(a, torch.Tensor) and a.is_cuda
                                              for a in args):
            return self.module(*args)
        key = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        if key not in self.graphs:
            self.graphs[key] = self._capture(args)
        graph, inputs, output = self.graphs[key]
        for dst, src in zip(inputs, args):
            dst.copy_(src)
        graph.replay()
        return output.clone()

    def _capture(self, args):
        dev = args[0].device
        inputs = [a.clone() for a in args]
        with torch.cuda.device(dev):
            # one eager call on a side stream first, as the capture needs:
            # the libraries' handles and workspaces and the module's cached
            # constants are made there, outside the graph
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.module(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: a loader thread's copies do not break the capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                output = self.module(*inputs)
        return graph, inputs, output
