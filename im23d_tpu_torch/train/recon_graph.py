"""The mesh estimator's train-mode forward and backward replayed from two
CUDA graphs, for ``ReconTrainer.train_step``.

``ReconstructionNetwork`` holds only plain PyTorch and cuDNN ops (no
hand-written kernel, no RNG, no host read) at the fixed shapes of a
training batch, yet its forward issues ~600 launches and its backward
~1,000, which the host queues more slowly than the card runs them.  So
the forward is captured as one graph (input: the image; outputs: texture
and mesh map; the batch norms' running statistics moved in place) and
the backward as a second (input: the outputs' gradients; outputs: the
parameters' gradients), sharing one memory pool.  ``_Replay`` ties them
into autograd: ``loss.backward()`` runs the render's and the loss's
backward eagerly, then replays the network's, and the parameters'
gradients reach ``p.grad`` as they would eagerly.  The kernels and their
order are the eager ones, so the results are too, bit for bit wherever
the step's kernels are deterministic (K5 backward's atomicAdd order
varies from run to run, eager or replayed).

``graph_action`` decides, from what the call can observe: a CUDA device,
no data group (one card) and train mode, else eager; with those, replay
at the captured input's shape and dtype against the captured parameter
and buffer storages, capture again where the storages changed, and run
eagerly at any other shape (a tail batch).  ``NetworkGraphs.engaged``
applies it around ``model(image)``, so the module's hooks still see each
call's outputs.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from im23d_tpu_torch.core.profiler import COUNTERS, span

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
# forward and backward passes before a capture, so that cuDNN and cuBLAS
# set up their handles, plans and workspaces outside it
WARMUP_PASSES = 2


def input_spec(image: torch.Tensor) -> tuple:
    return tuple(image.shape), image.dtype, image.device


def storages(model: nn.Module) -> tuple:
    """Where each parameter and buffer lives, and which take gradients."""
    return tuple((t.data_ptr(), t.dtype, t.shape, t.requires_grad)
                 for t in (*model.parameters(), *model.buffers()))


def graph_action(device_type: str, data_group, training: bool, spec: tuple,
                 stores: tuple, captured: tuple | None) -> str:
    """EAGER, CAPTURE or REPLAY for one call of the network.  ``captured``
    is the (spec, stores) the graphs held were captured at, or None."""
    if device_type != "cuda" or data_group is not None or not training:
        return EAGER
    if captured is None:
        return CAPTURE
    if spec != captured[0]:
        return EAGER
    return REPLAY if stores == captured[1] else CAPTURE


class _Replay(torch.autograd.Function):
    """The forward graph's replay; its backward, the backward graph's."""

    @staticmethod
    def forward(ctx, graphs, image, *params):
        ctx.graphs = graphs
        graphs.image.copy_(image)
        graphs.forward_graph.replay()
        return tuple(o.detach() for o in graphs.outputs)

    @staticmethod
    def backward(ctx, *grad_outputs):
        graphs = ctx.graphs
        for buf, g in zip(graphs.grad_outputs, grad_outputs):
            buf.copy_(g)
        graphs.backward_graph.replay()
        return (None, None, *(None if g is None else g.detach()
                               for g in graphs.grads))


class NetworkGraphs:
    """The captured graphs of one network, with what they were captured
    at.  The outputs of a replay are the graph's own buffers: the next
    replay overwrites them."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.captured = None  # (spec, stores) of the graphs below

    @contextlib.contextmanager
    def engaged(self, image: torch.Tensor, data_group):
        """Within the block, ``model(image)`` replays the graphs where
        ``graph_action`` allows, capturing them first where it asks;
        counts the call in ``COUNTERS``."""
        model = self.model
        spec, stores = input_spec(image), storages(model)
        action = graph_action(image.device.type, data_group, model.training,
                              spec, stores, self.captured)
        if action == EAGER:
            COUNTERS["recon_eager_steps"] += 1
            yield
            return
        if action == CAPTURE:
            with span("train.capture"):
                self._capture(image)
            self.captured = spec, stores
        COUNTERS["recon_graph_steps"] += 1
        params = self.params
        model.forward = lambda x: _Replay.apply(self, x, *params)
        try:
            yield
        finally:
            del model.forward

    def _capture(self, image: torch.Tensor) -> None:
        model = self.model
        # drop the graphs held and their pool's buffers before a new pool
        self.captured = None
        self.forward_graph = self.backward_graph = None
        self.outputs = self.grads = ()
        self.params = [p for p in model.parameters() if p.requires_grad]
        buffers = list(model.buffers())
        # the captured tensors stay alive while the graphs may write them,
        # whatever replaces them in the module
        self._held = [t.detach() for t in (*self.params, *buffers)]
        self.image = image.detach().clone()
        saved = [b.clone() for b in buffers]
        stream = torch.cuda.Stream(image.device)
        stream.wait_stream(torch.cuda.current_stream(image.device))
        with torch.enable_grad(), torch.cuda.stream(stream):
            for _ in range(WARMUP_PASSES):
                outputs = model.forward(self.image)
                torch.autograd.grad(outputs, self.params,
                                    [torch.ones_like(o) for o in outputs],
                                    allow_unused=True)
            del outputs
            for b, s in zip(buffers, saved):  # the warm-up moved them
                b.copy_(s)
        torch.cuda.current_stream(image.device).wait_stream(stream)
        self.forward_graph = torch.cuda.CUDAGraph()
        with torch.enable_grad(), torch.cuda.graph(self.forward_graph,
                                                   stream=stream):
            self.outputs = model.forward(self.image)
        self.grad_outputs = [torch.zeros_like(o) for o in self.outputs]
        self.backward_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.backward_graph,
                              pool=self.forward_graph.pool(), stream=stream):
            self.grads = torch.autograd.grad(self.outputs, self.params,
                                             self.grad_outputs,
                                             allow_unused=True)
        # without the captured autograd graph: its parameters' gradient
        # accumulators, made on the capture stream, would outlive it
        self.outputs = [o.detach() for o in self.outputs]
