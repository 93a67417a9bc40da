"""One pipeline call at one input shape, captured as a CUDA graph.

The port's counterpart of the JAX package's jit cache: where ``jax.jit``
compiles one XLA program per input shape, a :class:`GraphedCall` captures one
call of a function at one input shape and replays all of its kernel launches
with one host call. A batch-1 call of the detector is some thousand small
launches, so on the card its latency is the host's launch rate unless it is
replayed as a graph.

Capture rules the functions of the serving path keep: no host sync and no
shape that depends on data (``.item()``, boolean indexing, ``.nonzero()``),
and no host-to-device copy: a constant vector is made on the device by
fills (:func:`capturable_constant`). Capture failure raises; nothing falls
back to eager.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# calls before the capture: the first builds the kernels and fills the
# caches, the second runs as every later call will
WARMUP_CALLS = 2


def capturable_constant(values: Sequence[float], device) -> torch.Tensor:
    """A float32 vector of ``values`` made on ``device`` by fills.

    ``torch.tensor(values, device="cuda")`` copies from pageable host memory
    and synchronises, which a stream under capture refuses; a fill takes the
    value as a kernel argument. The float32 rounding of each value is the
    same either way.
    """
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out.narrow(0, i, 1).fill_(float(v))
    return out


class GraphedCall:
    """``fn(static_input)`` captured once; each call copies its input in and replays.

    :data:`WARMUP_CALLS` calls run first on a side stream: they build the
    CUDA kernels with nvcc, create the cuDNN and cuBLAS handles and fill the
    model's anchor cache, none of which may happen under capture. The
    capture runs under ``torch.inference_mode`` on the same side stream,
    with errors checked for the capturing thread only (other threads may
    synchronise meanwhile). The graphs given one ``pool``
    (``torch.cuda.graph_pool_handle()``) share their memory.

    :attr:`outputs` are the graph's own tensors: a replay overwrites them,
    and so may a replay of another graph of the same pool (it reuses the
    memory this graph freed during its capture). Copy them out before the
    next replay of any graph of the pool, in stream order.
    """

    def __init__(self, fn: Callable, example: torch.Tensor, pool):
        if example.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA input, got one on {example.device}")
        device = example.device
        # made outside the capture, so its memory is not the pool's
        self.static_input = example.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARMUP_CALLS):
                fn(self.static_input)
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
            self.graph, pool=pool, stream=side, capture_error_mode="thread_local"
        ):
            self.outputs = fn(self.static_input)
        # the input's clone and the warm-up calls are done before a replay,
        # whatever stream the replays run on
        torch.cuda.synchronize(device)

    def __call__(self, x: torch.Tensor):
        """Copy ``x`` into the static input and replay on the current stream."""
        with torch.inference_mode():
            self.static_input.copy_(x, non_blocking=True)
        self.graph.replay()
        return self.outputs
