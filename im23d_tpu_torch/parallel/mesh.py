"""Process groups for data and tensor parallelism (counterpart of
``im23d_tpu/parallel/mesh.py``).

JAX shards one program over a device mesh and XLA inserts the collectives;
here every process drives one device and the collectives are explicit:

* ``init_multihost`` joins the process group that a launcher (``torchrun``)
  describes in the environment: NCCL for CUDA devices, gloo for the CPU;
  the rank's device is ``cuda:LOCAL_RANK``;
* ``make_2d_mesh(tp)`` lays the ranks out as (world / tp) x tp, rank
  ``d * tp + m``: the batch splits over the data axis ``d``, the wide
  ``nn.Linear``s that ``dense_tp_layers`` selects split column-wise over
  the model axis ``m`` (``ColumnParallelLinear``);
* ``all_reduce_grads`` averages gradients over the data group before each
  optimizer step (the JAX gradient all-reduce, by hand: the GAN trainer
  runs three forwards, two optimizers and an EMA generator a group, which
  ``DistributedDataParallel`` does not model);
* ``batch_norm_group`` hands the data group to ``bn_stats``
  (``models/reconstruction.py``), whose train-mode moments are then
  global, as flax's ``nn.BatchNorm`` over a sharded batch axis (a scope
  around the trainers' forwards, not an attribute of the modules, so that
  copies and exported programs of a model carry no process group);
* ``shard_rows`` gives a rank its rows of a global batch, so that the
  N-rank run is the one-process run at N times the batch;
* ``full_state`` / ``load_full_state`` move a tensor-parallel model and its
  optimizer state to and from the one-process checkpoint layout;
* ``barrier`` is where the other ranks wait while rank 0 alone evaluates,
  writes pseudo-GT or exports: on a gloo group of its own whose timeout,
  ``RANK0_PASS_TIMEOUT``, covers such passes, so that NCCL's watchdog (10
  minutes on the training group) does not end the waiting ranks.

``--batch_size`` is per process, as in the JAX CLIs under ``--multihost``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TORCHRUN = ("torchrun --nproc_per_node=N -m im23d_tpu_torch.cli.<cli> "
            "--multihost ...")
TP_MATCH = ("decoder", "Dense")  # the JAX rule's path fragments
# how long ranks wait at ``Mesh.barrier`` for rank 0's passes (an FID or
# pseudo-GT pass over a training set takes minutes on one GPU)
RANK0_PASS_TIMEOUT = datetime.timedelta(hours=4)


def multihost_requested(flag: bool) -> bool:
    """``--multihost`` or ``IM23D_MULTIHOST=1``."""
    return bool(flag) or os.environ.get("IM23D_MULTIHOST") == "1"


def init_multihost(requested: bool, device: str | torch.device = "cuda"
                   ) -> torch.device:
    """Join the launcher's process group when ``requested`` and return the
    rank's device (``cuda:LOCAL_RANK``, or the CPU); without a request,
    return ``device`` as it is.

    Raises ``ValueError`` for a request without the launcher's environment
    (a lone process would use one of N devices) and for a launcher's
    environment of more than one process without a request (each process
    would train alone)."""
    env = os.environ
    launched = all(k in env for k in LAUNCHER_ENV)
    world = int(env.get("WORLD_SIZE", "1"))
    if not requested:
        if launched and world > 1:
            raise ValueError(
                f"a launcher started {world} processes but --multihost was "
                f"not given: run {TORCHRUN}")
        return torch.device(device)
    if not launched:
        raise ValueError(
            "--multihost needs the launcher's environment ("
            + ", ".join(LAUNCHER_ENV) + f"): run {TORCHRUN}")
    if dist.is_initialized():
        raise ValueError("the process group is already initialised")
    rank = int(env["RANK"])
    local = int(env.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in the (data x model) layout and its two groups
    (None where that axis has one rank), and the gloo group of all ranks
    that ``barrier`` waits on (None for one process)."""

    rank: int
    world: int
    tp: int
    data_group: object
    model_group: object
    wait_group: object = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def data_size(self) -> int:
        return self.world // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank, up to ``RANK0_PASS_TIMEOUT``."""
        if self.wait_group is not None:
            dist.barrier(group=self.wait_group)


def make_2d_mesh(tp: int = 1) -> Mesh:
    """The (world / tp) x tp layout over the initialised process group (or
    one process).  Raises ``ValueError`` when ``tp`` does not divide the
    world size.  Every rank must call it: it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp < 1 or world % tp:
        raise ValueError(f"{world} processes not divisible by tp={tp}")
    dp = world // tp
    data_group = model_group = None
    if dp > 1:
        for m in range(tp):
            ranks = [d * tp + m for d in range(dp)]
            group = dist.new_group(ranks)
            if rank in ranks:
                data_group = group
    if tp > 1:
        for d in range(dp):
            ranks = [d * tp + m for m in range(tp)]
            group = dist.new_group(ranks)
            if rank in ranks:
                model_group = group
    wait_group = (dist.new_group(backend="gloo", timeout=RANK0_PASS_TIMEOUT)
                  if world > 1 else None)
    return Mesh(rank, world, tp, data_group, model_group, wait_group)


def data_position(mesh: Mesh | None) -> tuple[int, int]:
    """(data rank, data size) of ``mesh``; (0, 1) for one process."""
    return (0, 1) if mesh is None else (mesh.data_rank, mesh.data_size)


def is_main(mesh: Mesh | None) -> bool:
    return mesh is None or mesh.is_main


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        mesh.barrier()


# -- rows of a global batch ---------------------------------------------------


def shard_rows(batch, rank: int, world: int):
    """Rows ``[rank * b, (rank + 1) * b)`` of every leaf of a global batch
    of ``world * b`` rows (a dict of arrays, tensors or lists, or one of
    them).  Raises ``ValueError`` when ``world`` does not divide it."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, rank, world) for k, v in batch.items()}
    n = len(batch)
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} "
                         "ranks")
    b = n // world
    return batch[rank * b:(rank + 1) * b]


# -- cross-replica batch norm -------------------------------------------------

_BN_GROUP = None


@contextlib.contextmanager
def batch_norm_group(group):
    """Within the block, train-mode batch norm (``bn_stats``) takes its
    moments over ``group``'s ranks (None: this rank's batch alone)."""
    global _BN_GROUP
    prev, _BN_GROUP = _BN_GROUP, group
    try:
        yield
    finally:
        _BN_GROUP = prev


def current_batch_norm_group():
    return _BN_GROUP


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: each
    rank's loss depends on every rank's summand."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sums(sums: torch.Tensor, group) -> torch.Tensor:
    """``sums`` summed over ``group``'s ranks, differentiably."""
    return _SumOverRanks.apply(sums, group)


# -- gradients and losses -----------------------------------------------------


def all_reduce_grads(params, group) -> None:
    """Average the gradients of ``params`` over ``group``'s ranks in place,
    one flat buffer per dtype.  Parameters without a gradient are left so
    (every rank runs the same code, so the same ones have none)."""
    if group is None:
        return
    size = dist.get_world_size(group)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def mean_over(values: dict, group) -> dict:
    """The mean over ``group``'s ranks of a dict of scalar tensors."""
    if group is None or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return dict(zip(keys, flat.unbind()))


def sum_over(array: np.ndarray, group, device) -> np.ndarray:
    """``array`` (float64 host values) summed over ``group``'s ranks."""
    if group is None:
        return array
    t = torch.as_tensor(array, dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


# -- tensor parallelism -------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the model group's partial input
    gradients (each rank's slice of the columns contributes its share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """All-gather of the model group's column slices along the last axis;
    the backward takes this rank's slice of the gradient and reduces
    nothing: downstream of the gather every rank of the group computes the
    same, so their gradients are equal, not partial."""

    @staticmethod
    def forward(ctx, y, group, rank, tp):
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(tp)]
        dist.all_gather(parts, y, group=group)
        ctx.rank, ctx.width = rank, y.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` whose rows (output features) split over the model
    group: this rank holds rows ``[m * out / tp, (m + 1) * out / tp)`` of
    the weight and bias, computes its slice of the output in the input's
    dtype, and all-gathers the full output.  No output element's
    reduction changes, only which rank computes it."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        out = linear.out_features
        if out % mesh.tp:
            raise ValueError(f"{out} features do not split over "
                             f"tp={mesh.tp}")
        self.in_features, self.out_features = linear.in_features, out
        self.group, self.rank, self.tp = (mesh.model_group, mesh.model_rank,
                                          mesh.tp)
        rows = slice(self.rank * out // self.tp,
                     (self.rank + 1) * out // self.tp)
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = (None if linear.bias is None else
                     nn.Parameter(linear.bias.detach()[rows].clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.linear(x, self.weight.to(x.dtype), bias)
        return _GatherColumns.apply(y, self.group, self.rank, self.tp)


def dense_tp_layers(model: nn.Module, tp: int,
                    match: tuple[str, ...] = TP_MATCH) -> dict:
    """The ``nn.Linear``s of an ``UnsupervisedPart`` that the JAX rule
    ``dense_tp_shardings(tp)`` splits, by module name: its flax param path
    (``core/convert.py``'s names) holds one of ``match`` and its 2-D kernel's
    output width divides by ``tp``."""
    from im23d_tpu_torch.core.convert import unsupervised_part_layers

    layers = unsupervised_part_layers(len(model.pose_decoder.heads),
                                      len(model.encoder.conv))
    out = {}
    for name, flax_path in layers:
        module = model.get_submodule(name)
        path = ("['params']" + "".join(f"['{k}']" for k in
                                       flax_path.split("/")) + "['kernel']")
        w = module.weight
        if (w.dim() == 2 and w.shape[0] % tp == 0
                and any(m in path for m in match)):
            out[name] = module
    return out


def parallelize_columns(model: nn.Module, names, mesh: Mesh) -> None:
    """Replace the named ``nn.Linear``s of ``model`` by their
    ``ColumnParallelLinear`` slices, in place (parameter order kept)."""
    for name in names:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, child, ColumnParallelLinear(
            model.get_submodule(name), mesh))


def sharded_params(model: nn.Module) -> set:
    """Names of ``model``'s column-parallel parameters."""
    return {f"{name}.{p}" for name, m in model.named_modules()
            if isinstance(m, ColumnParallelLinear)
            for p in ("weight", "bias") if getattr(m, p) is not None}


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model group's slices of ``t`` (rows of a column-parallel
    parameter, its gradient or optimizer state) at full width."""
    parts = [torch.empty_like(t) for _ in range(mesh.tp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=0)


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[0] // mesh.tp
    return t[mesh.model_rank * n:(mesh.model_rank + 1) * n].clone()


def full_state(model: nn.Module, optimizer, mesh: Mesh | None
               ) -> tuple[dict, dict]:
    """(state dict, optimizer state dict) at full width on the CPU: the
    model group's slices gathered (every rank of it must call this)."""
    sharded = set() if mesh is None else sharded_params(model)
    params = {}
    for k, v in model.state_dict().items():
        v = v.detach()
        params[k] = (gather_rows(v, mesh) if k in sharded else v).cpu()
    opt = optimizer.state_dict()  # its state dicts are the live ones
    if sharded:
        names = [n for n, _ in model.named_parameters()]
        opt["state"] = {
            i: ({key: (gather_rows(t, mesh).cpu() if torch.is_tensor(t)
                       and t.dim() > 0 else t) for key, t in st.items()}
                if names[i] in sharded else st)
            for i, st in opt["state"].items()}
    return params, opt


def load_full_state(model: nn.Module, optimizer, mesh: Mesh | None,
                    params: dict, opt_state: dict | None) -> None:
    """Load a full-width state dict (and optimizer state) into a model whose
    column-parallel layers hold this rank's rows."""
    sharded = set() if mesh is None else sharded_params(model)
    model.load_state_dict({k: _rows(v, mesh) if k in sharded else v
                           for k, v in params.items()})
    if opt_state is None:
        return
    if sharded:
        names = [n for n, _ in model.named_parameters()]
        state = {}
        for i, st in opt_state["state"].items():
            if names[int(i)] in sharded:
                st = {key: (_rows(t, mesh) if torch.is_tensor(t)
                            and t.dim() > 0 else t)
                      for key, t in st.items()}
            state[i] = st
        opt_state = {**opt_state, "state": state}
    optimizer.load_state_dict(opt_state)
