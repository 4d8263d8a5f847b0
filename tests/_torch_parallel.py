"""Rank functions of tests/test_torch_parallel.py, run by
``parallel.mesh.spawn`` in new processes (no JAX here: each rank imports
only torch, numpy and the port).

A parallel step on the mini model (n-scale two-stream CFT, nc=2, fp32) is
held against the port's single-process step on the global batch, both
built from the same ``random_state_dict`` weights; the test process runs
the single-process step once for both grids."""

import contextlib

import numpy as np
import torch

from multispectral_object_detection_tpu_torch.models import configs, layers
from multispectral_object_detection_tpu_torch.models.detect import (
    anchor_arrays)
from multispectral_object_detection_tpu_torch.models.model import (
    build_model)
from multispectral_object_detection_tpu_torch.parallel import mesh as pm
from multispectral_object_detection_tpu_torch.train.loss import DetectionLoss
from multispectral_object_detection_tpu_torch.train.optim import (
    OptHyp, build_optimizer)
from multispectral_object_detection_tpu_torch.train.trainer import (
    TrainState, make_train_step)
from tests._torch_port import (TRAJECTORY_HYP, load, port_without_dropout,
                               random_state_dict, train_batch)

IMG, BATCH, SEED = 64, 4, 3  # the global batch; the step's dropout seed


def mini_step(mesh=None, dropout: bool = True, x64: bool = False):
    """(state, step, the gradients the step hands its optimizer)."""
    cfg = configs.yolov5_two_stream("n", nc=2, fusion="transformerx3")
    model = build_model(cfg)
    model = load(model, random_state_dict(model, 0)).train()
    if x64:
        model.double().dtype = torch.float64
    if not dropout:
        port_without_dropout(model)
    if mesh is not None:
        pm.broadcast_module(model)
        pm.parallelize(model, mesh)
    opt = build_optimizer(model, OptHyp(**TRAJECTORY_HYP), 4, 3, 1, 64,
                          warmup_min_iters=1)
    state = TrainState(model, opt, mesh)
    spec = model.spec
    loss = DetectionLoss(2, anchor_arrays(spec.anchors), spec.strides,
                         mesh=mesh)
    seen = []
    update = opt.update
    opt.update = lambda g: (seen.append(dict(zip(opt.names, g))),
                            update(g))[1]
    return state, make_train_step(state, loss), seen


def rows(batch, mesh):
    """The data rank's images of ``train_batch``'s global batch, targets
    re-indexed to them (8 target rows per image)."""
    rgb, ir, targets, tmask = batch
    b = rgb.shape[0] // mesh.n_data
    r = mesh.data_rank
    t = targets[r * b * 8:(r + 1) * b * 8].copy()
    t[:, 0] -= r * b
    return rgb[r * b:(r + 1) * b], ir[r * b:(r + 1) * b], t, \
        tmask[r * b * 8:(r + 1) * b * 8]


@contextlib.contextmanager
def port_float64():
    """Within: the port computes in float64 wherever it names float32
    (test-side, restored on exit): its modules' ``torch`` reads
    ``float32`` as ``float64``, ``Tensor.float()`` gives float64 and
    float64 is torch's default dtype (tests/_torch_port.
    float32_read_as_float64 without the JAX side)."""
    import sys
    from types import SimpleNamespace

    torch64 = SimpleNamespace(**{**vars(torch), "float32": torch.float64})
    swapped = []
    for name, mod in list(sys.modules.items()):
        if name.startswith("multispectral_object_detection_tpu_torch.") \
                and getattr(mod, "torch", None) is torch:
            mod.torch = torch64
            swapped.append(mod)
    orig_float, orig_default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig_float
        torch.set_default_dtype(orig_default)
        for mod in swapped:
            mod.torch = torch


def errors(got, ref) -> dict:
    """Loss relative error; gradients and BatchNorm statistics as max |diff|
    over the largest reference value (gradients over all tensors,
    statistics per tensor), of one step's (losses, gradients, statistics)
    against another's."""
    (m, g, st), (m1, g1, st1) = got[:3], ref[:3]
    top = max(np.abs(v).max() for v in g1.values())
    return {"loss": abs(m["total"] - m1["total"]) / abs(m1["total"]),
            "grads": max(np.abs(g[k] - g1[k]).max() for k in g1) / top,
            "stats": max(np.abs(st[k] - st1[k]).max() / np.abs(st1[k]).max()
                         for k in st1),
            "comps": {k: (m[k], m1[k]) for k in ("box", "obj", "cls",
                                                 "grad_norm")}}


def run_step(mesh, dropout: bool, x64: bool = False):
    """One step of the mini model on ``train_batch``'s global batch (the
    mesh's rows of it): (losses, gradients, statistics, state, gathered
    state dict)."""
    with port_float64() if x64 else contextlib.nullcontext():
        return _step(mesh, dropout, x64)


def _step(mesh, dropout: bool, x64: bool):
    batch = train_batch(BATCH, IMG, seed=0)
    state, step, seen = mini_step(mesh, dropout, x64)
    part = batch if mesh is None else rows(batch, mesh)
    m = step(*(torch.from_numpy(a) for a in part), seed=SEED)
    grads = seen[0]
    sd = state.state_dict()  # gathered under tensor parallelism
    if mesh is not None and mesh.n_model > 1:
        grads = pm.gather_state(grads, pm.tp_dims(state.model), mesh)
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().numpy().copy() for k, v in grads.items()},
            {k: v.numpy().copy() for k, v in sd["model"].items()
             if "running" in k}, state, sd)


def grid_steps(n_data: int, n_model: int) -> dict:
    """On an n_data x n_model grid, rank 0's results of the parallel step
    with dropout on, in fp32 and in float64 (for the single-process step,
    which the caller runs once for every grid), and with dropout off (for
    the JAX mesh step); the shards' shapes."""
    mesh = pm.make_mesh(n_data, n_model)
    fp32 = run_step(mesh, dropout=True)
    state = fp32[3]
    shapes = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    opt_shapes = [tuple(t.shape) for t in state.opt.state["m"]]
    ema_shapes = {k: tuple(v.shape)
                  for k, v in state.ema_model.state_dict().items()}
    nodrop = run_step(mesh, dropout=False)[:3]
    fp64 = run_step(mesh, dropout=True, x64=True)[:3]
    if not mesh.is_main:
        return None
    return {"fp32": fp32[:3], "fp64": fp64, "shapes": shapes,
            "opt_shapes": opt_shapes, "ema_shapes": ema_shapes,
            "names": state.opt.names, "nodrop": nodrop}


CFG = "yolov5n_fusion_transformerx3"


def train_cli_run(data: dict, project: str, argv) -> dict:
    """The train CLI on this rank (the mini config at 64 px, batch 4,
    fp32, on the CPU)."""
    from multispectral_object_detection_tpu_torch.cli import train_cli

    args = train_cli.parse_args(
        ["--data", "unused", "--cfg", CFG, "--batch-size", "4",
         "--img-size", "64", "--fp32", "--device", "cpu", "--project",
         project, "--noautoanchor"] + list(argv))
    args.data = data
    return train_cli.run(args)


GRIDS = {"data_grid": (2, 1, ["--epochs", "1", "--device-aug", "--sync-bn",
                             "--local_rank", "0"]),
         "model_grid": (1, 2, ["--epochs", "1", "--n-model", "2"])}


def suite(data: dict, project: str) -> dict:
    """On two ranks, each grid of GRIDS in turn: ``grid_steps``, then the
    train CLI with the grid's flags (run directory ``project``/grid)."""
    out = {}
    for name, (n_data, n_model, argv) in GRIDS.items():
        res = grid_steps(n_data, n_model)
        cli = train_cli_run(data, f"{project}/{name}", argv)
        if res is not None:
            out[name] = dict(res, cli=cli)
    return out or None
