"""Data and tensor parallelism over ``torch.distributed`` process groups.

Counterpart of multispectral_object_detection_tpu/parallel/mesh.py, where
one jitted program runs over a ``jax.sharding.Mesh`` of shape (data,
model). Here each rank is a process, and the mesh is a grid of process
groups: rank = d * n_model + m, with a data group per m (the ranks that
hold the same model shard) and a model group per d (the ranks that share a
batch slice). The train step on N data ranks computes the single-process
step on the global batch, as the JAX step does:

- the loss (train/loss.py) all-reduces its denominators over the data
  group and scales by the global batch, so the ranks' losses sum to the
  global loss and the gradient is the SUM of the ranks' gradients
  (``reduce_gradients``: coalesced buckets, no DDP wrapper, because the
  step takes its gradients with ``torch.autograd.grad``);
- BatchNorm (models/layers.py) normalises with global-batch statistics,
  all-reduced in fp32 forward and backward (SyncBN, always on);
- CFT dropout (models/fusion.py) draws the global batch's mask from the
  step's seed on every rank and keeps the rank's rows (and heads);
- optimizer and EMA stay replicated, after ``broadcast_module`` of rank
  0's initial weights.

Tensor parallelism (``n_model`` > 1) splits the CFT blocks' q, k, v and
fc1 by output (whole heads) and proj and fc2 by input, Megatron's f/g pair
around each block (``copy_to_model``, ``reduce_from_model``). Each rank
stores only its shards of those weights, their optimizer state and EMA;
``TrainState.state_dict`` (train/trainer.py) gathers them into the full
layout, and the eval forward runs on the gathered EMA, whole.

``init_distributed`` joins a launcher's group (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, e.g. ``torchrun --nproc-per-node N``); ``spawn`` starts N
ranks itself (``test_cli --data-parallel N``). One process without a
launcher has no group and runs as before.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

BUCKET_BYTES = 25 << 20  # gradient all-reduce bucket


class Mesh:
    """This rank's place on the (n_data, n_model) grid and its groups
    (None for an axis of size 1, or the group of all ranks)."""

    def __init__(self, n_data: int = 1, n_model: int = 1, rank: int = 0,
                 data_group=None, model_group=None):
        self.n_data, self.n_model, self.rank = n_data, n_model, rank
        self.data_rank, self.model_rank = divmod(rank, n_model)
        self.data_group, self.model_group = data_group, model_group

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh(data={self.n_data}, model={self.n_model}, "
                f"rank={self.rank})")

    def __deepcopy__(self, memo):
        return self  # a handle on the groups (an EMA copy shares it)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The grid over the initialised world (n_data * n_model ranks; n_data
    defaults to world / n_model). Every rank creates every group, in the
    same order. Without a process group: the 1 x 1 mesh."""
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise RuntimeError(f"a {n_data} x {n_model} mesh needs "
                               f"{(n_data or 1) * n_model} ranks: start them "
                               f"with torchrun --nproc-per-node or spawn()")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world of "
                         f"{world} ranks")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover the "
                         f"world of {world} ranks")
    data_group = model_group = None
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks) if n_model > 1 else dist.group.WORLD
        if rank in ranks:
            data_group = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks) if n_data > 1 else dist.group.WORLD
        if rank in ranks and n_model > 1:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def resolve_data_axis(batch_size: int, n_devices: int,
                      n_model: int = 1) -> tuple:
    """Pick the data-parallel axis size and a compatible global batch.

    The reference asserts `batch_size % world_size == 0`
    (utils/torch_utils.py:83-86) and dies; silently idling devices (the
    round-2 behavior) hides throughput loss. Policy: use every available
    device group and ROUND THE BATCH UP to the next multiple — unless the
    batch is smaller than the device count, in which case the data axis
    shrinks to the batch (a 2-image debug run should not be inflated 4x).

    Returns (n_data, batch_size, changed: bool).
    """
    avail = max(n_devices // max(n_model, 1), 1)
    n_data = min(avail, batch_size)
    if batch_size % n_data:
        new_bs = ((batch_size + n_data - 1) // n_data) * n_data
        return n_data, new_bs, True
    return n_data, batch_size, False


# ---- launch -----------------------------------------------------------------

def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    return int(v) if v.strip() else default


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` on the card, else ``device``."""
    if device.type != "cuda":
        return device
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def init_distributed(device: torch.device, local_rank: int = -1):
    """Join the launcher's process group when there is one (``WORLD_SIZE``
    > 1, or the reference's ``--local_rank``): NCCL on CUDA, gloo on the
    CPU, through the launcher's ``MASTER_ADDR``/``MASTER_PORT``. Returns
    (world size, this rank's device); (1, device) without a launcher. An
    initialised group (a ``spawn`` child) is taken as it is."""
    if dist.is_initialized():
        return dist.get_world_size(), rank_device(
            device, _env_int("LOCAL_RANK", dist.get_rank()))
    world = _env_int("WORLD_SIZE", 1)
    local = _env_int("LOCAL_RANK", max(local_rank, 0))
    if world <= 1:
        return 1, rank_device(device, local) if local_rank >= 0 else device
    device = rank_device(device, local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", world_size=world,
                            rank=_env_int("RANK", local))
    return world, device


def _child(rank: int, world: int, store_path: str, backend: str,
           threads: int, fn: Callable, args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank, world_size=world)
        out = fn(*args)
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(n: int, fn: Callable, *args, backend: str = "gloo",
          timeout: float = 1800.0, store_dir: Optional[str] = None,
          threads: Optional[int] = None):
    """Run ``fn(*args)`` on n new ranks (processes started with 'spawn',
    joined through a FileStore in ``store_dir``, default a new temporary
    directory) and return rank 0's result. ``fn`` must be importable by
    name. Each child takes ``threads`` torch threads (default: this
    process's share, at least 1). A rank that raises, or a run past
    ``timeout`` seconds, kills every child and raises RuntimeError."""
    ctx = multiprocessing.get_context("spawn")
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="msod_dist_")
    store = os.path.join(store_dir, f"store_{os.getpid()}_{id(fn)}")
    if os.path.exists(store):
        os.remove(store)
    threads = threads or max(1, torch.get_num_threads() // n)
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, n, store, backend, threads,
                                              fn, args, results),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    out, errors, done = None, [], 0
    try:
        while done < n:
            try:
                rank, kind, value = results.get(timeout=timeout)
            except queue.Empty:
                raise RuntimeError(f"spawn: {n - done} of {n} ranks still "
                                   f"running after {timeout:.0f} s") from None
            done += 1
            if kind == "error":
                errors.append(f"rank {rank}:\n{value}")
                break  # the others may wait on it in a collective
            if rank == 0:
                out = value
        if errors:
            raise RuntimeError("spawn: " + "\n".join(errors))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return out


# ---- collectives --------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over a group, forward and backward (SyncBN's statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_autograd(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


@torch.no_grad()
def reduce_gradients(grads: Sequence[torch.Tensor], group) -> None:
    """Sum the gradients over ``group`` in place, coalesced into flat
    buckets of one dtype of about ``BUCKET_BYTES`` each."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for ts in by_dtype.values():
        bucket, size = [], 0
        for i, t in enumerate(ts):
            bucket.append(t)
            size += t.numel() * t.element_size()
            if size >= BUCKET_BYTES or i == len(ts) - 1:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                torch._foreach_copy_(bucket, [
                    v.view_as(b) for v, b in zip(
                        flat.split([b.numel() for b in bucket]), bucket)])
                bucket, size = [], 0


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Every parameter and buffer from rank ``src`` to all ranks."""
    if not dist.is_initialized():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=src)


# ---- tensor parallelism of the CFT blocks -------------------------------------

def tp_dims(model: nn.Module) -> Dict[str, int]:
    """{parameter name: the dim it is split along} of every CFT block:
    q, k, v and fc1 (weight and bias) by output rows, proj and fc2
    weights by input columns (their biases and the LayerNorms are
    replicated)."""
    from ..models.fusion import CrossModalFusion

    dims = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, CrossModalFusion) or mod.packed:
            continue
        for j in range(len(mod.trans_blocks)):
            p = f"{name}.trans_blocks.{j}" if name else f"trans_blocks.{j}"
            for proj in ("que_proj", "key_proj", "val_proj"):
                dims[f"{p}.sa.{proj}.weight"] = 0
                dims[f"{p}.sa.{proj}.bias"] = 0
            dims[f"{p}.mlp.0.weight"] = 0
            dims[f"{p}.mlp.0.bias"] = 0
            dims[f"{p}.sa.out_proj.weight"] = 1
            dims[f"{p}.mlp.2.weight"] = 1
    return dims


def shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's contiguous part of ``t`` along ``dim``."""
    n = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * n, n)


def parallelize(model: nn.Module, mesh: Mesh) -> None:
    """Hand the BatchNorms (SyncBN) and CFT stages (global dropout masks,
    tensor parallelism) the mesh, and keep only this rank's shards of the
    CFT blocks' split weights (whole heads: n_model must divide them)."""
    from ..models.fusion import CrossModalFusion
    from ..models.layers import ConvBnAct

    for mod in model.modules():
        if isinstance(mod, CrossModalFusion) and \
                mod.num_heads % mesh.n_model:
            raise ValueError(f"--n-model {mesh.n_model} must divide the "
                             f"{mod.num_heads} heads")
        if isinstance(mod, (CrossModalFusion, ConvBnAct)):
            mod.mesh = mesh
    if mesh.n_model == 1:
        return
    for name, dim in tp_dims(model).items():
        owner, _, pname = name.rpartition(".")
        m = model.get_submodule(owner)
        p = getattr(m, pname)
        setattr(m, pname, nn.Parameter(shard(p.data, dim, mesh).clone(),
                                       requires_grad=p.requires_grad))


def gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's shards of ``t`` concatenated along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def gather_state(sd: Dict[str, torch.Tensor], dims: Dict[str, int],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A state dict with its split entries gathered to the full layout
    (collective over the model group)."""
    return {k: gather(v, dims[k], mesh) if k in dims else v
            for k, v in sd.items()}


def shard_state(sd: Dict[str, torch.Tensor], dims: Dict[str, int],
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A full-layout state dict cut to this rank's shards."""
    return {k: shard(v, dims[k], mesh) if k in dims else v
            for k, v in sd.items()}


# ---- data-parallel eval ---------------------------------------------------------

class EvalShard:
    """The data-parallel eval of one rank: a batch padded to ``batch_size``
    (one shape for every batch), the rank's rows of it through the
    forward and NMS, the results gathered over the data group in batch
    order with the padding cut off (mesh.py's make_parallel_eval_forward
    of the JAX package)."""

    def __init__(self, mesh: Mesh, batch_size: int):
        if batch_size % mesh.n_data:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{mesh.n_data} data ranks")
        self.mesh, self.batch_size = mesh, batch_size
        self.rows_per_rank = batch_size // mesh.n_data

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` (B, ...) padded with zeros to the
        batch size."""
        if t.shape[0] < self.batch_size:
            pad = t.new_zeros((self.batch_size - t.shape[0],) + t.shape[1:])
            t = torch.cat([t, pad])
        b = self.rows_per_rank
        return t[self.mesh.data_rank * b:(self.mesh.data_rank + 1) * b]

    def gather(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The ranks' rows of a per-row result in batch order, cut to the
        batch's ``n`` real rows."""
        if self.mesh.data_group is None:
            return t[:n]
        u = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(u) for _ in range(self.mesh.n_data)]
        dist.all_gather(parts, u, group=self.mesh.data_group)
        return torch.cat(parts)[:n].to(t.dtype)
