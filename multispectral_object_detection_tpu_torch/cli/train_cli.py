"""Training CLI of the port, the counterpart of ``train.py``
(multispectral_object_detection_tpu/cli/train_cli.py): the same flags,
defaults and run directory, on the GPU.

    python -m multispectral_object_detection_tpu_torch.cli.train_cli \\
        --data data.yaml [--cfg yolov5l_fusion_transformerx3] [...]

Per epoch: augmented, shuffled batches (data/datasets.py) through the train
step (train/trainer.py: bf16 compute unless ``--fp32``, fp32 loss, the
recipe's SGD or Adam with warmup and accumulation to 64, the EMA), the loss
sums kept on the device and read once per epoch; then the EMA model's eval
(train/evaluator.py, its CFT stages through the CUDA kernels on the card).
A run directory holds ``hyp.yaml``, ``opt.yaml``, ``results.txt``,
``final.json`` and the checkpoints ``last/``, ``best/`` and ``epoch{N}/``
(utils/checkpoint.py; ``last`` and ``best`` are stripped to ``model.pt`` at
the end). ``--weights`` warm-starts from a port or JAX checkpoint directory
or a ``.pt`` state dict (shape-matched); ``--resume`` continues a run from
its ``last`` (bare: the newest under ``--project`` or ``runs/``).
``--device`` defaults to CUDA and fails without a GPU; ``--device cpu``
runs on the CPU. ``run`` takes the parsed arguments, where ``data`` may
also be a dict.

``--device-aug`` moves the mosaic, scale/translate warp, flip and HSV
jitter onto the device (ops/augment_device.py; the host only decodes and
letterboxes tiles); ``--quad`` trains on 2S canvases of 4 samples with the
loss x4; ``--evolve N`` runs N generations of hyperparameter evolution
into ``<project>/<name>_evolve/evolve.txt``.

Parallel (parallel/mesh.py): under ``torchrun --nproc-per-node N`` (or the
reference's launcher and ``--local_rank``) the N ranks train one model on
the global batch, split n_data x n_model with ``--n-model`` (tensor
parallelism of the CFT blocks); NCCL on CUDA (``cuda:LOCAL_RANK``), gloo
with ``--device cpu``. The batch is rounded up to a multiple of the data
ranks, BatchNorm is synchronised (``--sync-bn`` is always on), the
per-epoch eval is split over the data ranks, and only rank 0 writes.

Observability (utils/loggers.py, utils/plots.py): TensorBoard scalars in
``<run>/tb`` (unless ``--nosave``; where the tensorboard package imports),
W&B with ``--wandb`` (``--entity``, ``--upload-dataset`` logs the dataset
as an artifact, ``--bbox-interval N`` the val detections every N epochs,
``--save-period`` the checkpoints; ``--resume wandb-artifact://...``
fetches a checkpoint; without wandb it warns and logs nothing), and the
plots of labels, LR schedule, the first 3 batches and the results, and
``evolve.png`` after ``--evolve``; without matplotlib the run says once
that plots are skipped. ``--data`` and a ``--cfg`` YAML are found by
``check_file``; ``check_dataset`` checks the val paths (and runs the
data's ``download`` recipe where they are missing).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.cli.train_cli")
    ap.add_argument("--cfg", type=str, default="yolov5l_fusion_transformerx3",
                    help="model name (configs.get_config) or model YAML path")
    ap.add_argument("--data", type=str, required=True,
                    help="dataset YAML: {train_rgb, train_ir, val_rgb, val_ir,"
                         " nc, names} or single-stream {train, val, nc, names}")
    ap.add_argument("--hyp", type=str, default="scratch",
                    help="scratch, finetune or a hyp YAML path")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--img-size", type=int, nargs="+", default=[640],
                    help="[train, val] image sizes (one value: both)")
    ap.add_argument("--weights", type=str, default="",
                    help="warm start: a checkpoint dir (the port's or the "
                         "JAX package's; its EMA weights) or a .pt state "
                         "dict, shape-matched")
    ap.add_argument("--resume", nargs="?", const=True, default="",
                    help="checkpoint dir to resume (model, EMA, optimizer, "
                         "epoch); bare: the newest 'last' under --project "
                         "or runs/")
    ap.add_argument("--project", type=str, default="runs/train")
    ap.add_argument("--name", type=str, default="exp")
    ap.add_argument("--exist-ok", action="store_true")
    ap.add_argument("--adam", action="store_true")
    ap.add_argument("--linear-lr", action="store_true")
    ap.add_argument("--remat", type=str, default="none",
                    choices=["none", "dots", "full", "blocks"],
                    help="activation recompute: 'blocks' checkpoints each "
                         "graph node, 'full' the whole forward, 'dots' the "
                         "forward keeping conv and matmul outputs; less "
                         "activation memory for recompute (chip_smoke.py "
                         "phase 8 measures none and blocks)")
    ap.add_argument("--label-smoothing", type=float, default=0.0)
    ap.add_argument("--single-cls", action="store_true")
    ap.add_argument("--noval", "--notest", action="store_true",
                    help="skip the per-epoch eval")
    ap.add_argument("--nosave", action="store_true")
    ap.add_argument("--max-labels", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--save-period", "--save_period", type=int, default=-1)
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="save the rolling 'last' checkpoint every N epochs")
    ap.add_argument("--fp32", action="store_true", help="fp32 compute")
    ap.add_argument("--noautoanchor", action="store_true",
                    help="skip the anchor BPR audit / re-clustering")
    ap.add_argument("--cache-images", action="store_true",
                    help="keep decoded, scaled images in RAM")
    ap.add_argument("--compute-val-loss", action="store_true",
                    help="also report box/obj/cls loss on the val split")
    ap.add_argument("--rect", action="store_true",
                    help="rectangular training: aspect-bucketed batches, "
                         "mosaic off")
    ap.add_argument("--image-weights", action="store_true",
                    help="class-frequency-weighted image sampling per epoch")
    ap.add_argument("--multi-scale", action="store_true",
                    help="resize each train batch to 0.5x-1.5x the size "
                         "on a 64 px ladder")
    ap.add_argument("--freeze", type=str, nargs="*", default=None,
                    help="freeze parameters whose name contains any of "
                         "these substrings (e.g. model.0. model.1.)")
    ap.add_argument("--device", type=str, default="",
                    help="'' = cuda (fails without a GPU), 'cpu', 'cuda:N' "
                         "or a CUDA index N")
    ap.add_argument("--workers", type=int, default=8,
                    help="accepted for compatibility; one thread assembles "
                         "the batches ahead")
    ap.add_argument("--device-aug", action="store_true",
                    help="mosaic, scale/translate, flip and HSV on the "
                         "device (the default hyps' separable warp only); "
                         "the host decodes and letterboxes tiles")
    ap.add_argument("--quad", action="store_true",
                    help="4 samples per 2S canvas, loss x4 (batch rounded "
                         "to a multiple of 4)")
    ap.add_argument("--evolve", type=int, default=0, metavar="N",
                    help="evolve the hyperparameters for N generations")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel ranks per CFT block (divides the "
                         "launched ranks and the 8 heads)")
    ap.add_argument("--sync-bn", action="store_true",
                    help="accepted: BatchNorm statistics are the global "
                         "batch's under data parallelism (always on)")
    ap.add_argument("--local_rank", type=int, default=-1,
                    help="the reference launcher's rank on this host "
                         "(torchrun sets LOCAL_RANK instead)")
    ap.add_argument("--wandb", action="store_true",
                    help="W&B logging (warns and skips without wandb)")
    ap.add_argument("--upload-dataset", "--upload_dataset",
                    action="store_true",
                    help="log the dataset as a W&B artifact")
    ap.add_argument("--entity", type=str, default=None, help="W&B entity")
    ap.add_argument("--bbox-interval", "--bbox_interval", type=int,
                    default=-1,
                    help="log W&B bbox-debug panels of the val set every N "
                         "epochs; -1 = off")
    ap.add_argument("--artifact-alias", "--artifact_alias", type=str,
                    default="latest",
                    help="accepted for compatibility; dataset artifact "
                         "versioning rides --upload-dataset")
    return ap.parse_args(argv)


def _flat(d: dict) -> dict:
    """Values that are not scalars or lists of scalars as strings (a data
    dict passed to ``run``)."""
    def ok(v):
        return v is None or isinstance(v, (bool, int, float, str))

    return {k: v if ok(v) or (isinstance(v, (list, tuple))
                              and all(ok(x) for x in v)) else str(v)
            for k, v in d.items()}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch array on the device; through pinned memory on a GPU, so
    the copy does not wait for the steps already queued."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _resize_u8(t: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3), bilinear, rounded."""
    if t.shape[1] == size:
        return t
    x = torch.nn.functional.interpolate(
        t.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear",
        align_corners=False)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def run(args) -> dict:
    """Train; returns the last eval's metrics (numbers) plus ``save_dir``
    and ``eval_forwards`` (EMA forwards of the per-epoch evals)."""
    import random

    from ..data.datasets import BatchLoader, PairedDetectionDataset
    from ..data.hyps import dump_flat_yaml, load_hyp
    from ..models.configs import get_config
    from ..models.detect import anchor_arrays
    from ..models.fusion import mix_seed
    from ..models.model import build_model, init_weights
    from ..models.parser import parse_model_config
    from ..ops.augment_device import (device_mosaic_batch, draw_mosaic,
                                      image_targets, take_rows)
    from ..parallel import mesh as pm
    from ..train.eval_forward import make_eval_forward as model_forward
    from ..train.evaluator import evaluate
    from ..train.loss import DetectionLoss, LossHyp, scale_gains
    from ..train.optim import OptHyp, build_optimizer
    from ..train.trainer import TrainState, make_eval_forward, make_train_step
    from ..utils.checkpoint import (CheckpointWriter, load_checkpoint,
                                    load_inference_params, partial_load,
                                    save_checkpoint, strip_checkpoint)
    from ..utils import plots
    from ..utils.general import (check_dataset, check_file, check_img_size,
                                 device_from_arg, get_latest_run,
                                 increment_path, init_seeds)
    from ..utils.loggers import ExperimentLogger
    from ..utils.metrics import fitness
    from .test_cli import _load_data, _with_panels

    device = device_from_arg(args.device)
    world, device = pm.init_distributed(device, args.local_rank)
    if args.n_model > 1 and world == 1:
        raise SystemExit(f"--n-model {args.n_model} needs {args.n_model} "
                         f"ranks: launch with torchrun --nproc-per-node "
                         f"{args.n_model}")
    if world % args.n_model:
        raise SystemExit(f"--n-model {args.n_model} must divide the "
                         f"{world} launched ranks")
    mesh = pm.make_mesh(world // args.n_model, args.n_model) \
        if world > 1 else None
    n_data = mesh.n_data if mesh else 1
    main = mesh is None or mesh.is_main
    if args.sync_bn:
        logger.info("--sync-bn: always on, BatchNorm statistics are the "
                    "global batch's under data parallelism "
                    "(parallel/mesh.py)")
    init_seeds(args.seed)
    save_dir = None
    if main:
        save_dir = increment_path(Path(args.project) / args.name,
                                  exist_ok=args.exist_ok)
        save_dir.mkdir(parents=True, exist_ok=True)
    if mesh is not None:  # rank 0's run directory
        box = [save_dir]
        torch.distributed.broadcast_object_list(box, src=0)
        save_dir = box[0]
    logger.info(f"run dir: {save_dir} ({device}"
                f"{f', {mesh}' if mesh else ''})")
    if isinstance(args.data, str):
        args.data = check_file(args.data)  # a recursive search
    if str(args.cfg).endswith((".yaml", ".yml")):
        args.cfg = check_file(args.cfg)
    data = _load_data(args.data)
    check_dataset(data)  # the val paths, or the data's download recipe
    nc = 1 if args.single_cls else int(data["nc"])
    two_stream = "train_ir" in data
    sizes = (args.img_size if isinstance(args.img_size, (list, tuple))
             else [args.img_size])
    img_size = check_img_size(sizes[0], 32)
    val_img_size = check_img_size(sizes[-1], 32)
    # use every data rank: round the batch up (the train step of --quad
    # sees the canvas batch, a quarter of it)
    if args.quad:
        if args.device_aug or args.rect:
            raise SystemExit("--quad is exclusive with --device-aug/--rect")
        if args.batch_size % 4:
            args.batch_size = ((args.batch_size + 3) // 4) * 4
            logger.warning(f"--quad: batch rounded up to {args.batch_size}")
        nd, cbs, changed = pm.resolve_data_axis(args.batch_size // 4, world,
                                                args.n_model)
        if changed:
            args.batch_size = cbs * 4
            logger.warning(f"--quad: canvas batch not divisible by the "
                           f"{nd}-way data axis; batch rounded up to "
                           f"{args.batch_size}")
    else:
        nd, bs, changed = pm.resolve_data_axis(args.batch_size, world,
                                               args.n_model)
        if changed:
            logger.warning(f"--batch-size {args.batch_size} is not divisible "
                           f"by the {nd}-way data axis; rounding up to {bs} "
                           f"so no rank idles")
            args.batch_size = bs
    if nd < n_data:
        raise SystemExit(f"--batch-size {args.batch_size} leaves some of the "
                         f"{n_data} data ranks without images")
    hyp = load_hyp(args.hyp)
    hyp["label_smoothing"] = args.label_smoothing
    if main:
        (save_dir / "hyp.yaml").write_text(dump_flat_yaml(hyp))
        (save_dir / "opt.yaml").write_text(dump_flat_yaml(_flat(vars(args))))
    if args.device_aug and (hyp.get("degrees", 0) or hyp.get("shear", 0)
                            or hyp.get("perspective", 0)):
        raise SystemExit("--device-aug supports the separable (scale/"
                         "translate) affine only: degrees, shear and "
                         "perspective must be 0")
    cache_dir = str(save_dir / "cache") if main else None

    # ---- data
    train_ds = PairedDetectionDataset.from_sources(
        data["train_rgb"] if two_stream else data["train"],
        data.get("train_ir"), img_size=img_size, augment=True, hyp=hyp,
        nc=None if args.single_cls else nc, rect=args.rect,
        cache_dir=cache_dir, cache_images=args.cache_images)
    if args.single_cls:
        for lab in train_ds.labels:
            if len(lab):
                lab[:, 0] = 0

    # ---- model
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    cfg = args.cfg if str(args.cfg).endswith((".yaml", ".yml")) else \
        get_config(args.cfg, nc=nc)
    anchors = None
    if not args.noautoanchor:
        from ..utils.autoanchor import check_anchors

        spec0 = parse_model_config(cfg, nc=nc)
        anc0 = np.asarray(spec0.anchors, np.float32).reshape(spec0.nl, -1, 2)
        anc1 = check_anchors(train_ds.labels, anc0, img_size,
                             thr=hyp["anchor_t"])
        if not np.allclose(anc0, anc1):
            anchors = [[float(v) for v in a.reshape(-1)] for a in anc1]
            logger.info("autoanchor: anchors updated")
    model = build_model(cfg, nc=nc, anchors=anchors, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    spec = model.spec
    if spec.two_stream != two_stream:
        raise SystemExit(f"model two_stream={spec.two_stream} but the data "
                         f"{'has' if two_stream else 'lacks'} an IR split")

    loader = BatchLoader(train_ds, args.batch_size, shuffle=True,
                         seed=args.seed, max_labels=args.max_labels,
                         drop_last=True, image_weights=args.image_weights,
                         device_aug=args.device_aug, quad=args.quad,
                         max_labels_per_tile=max(args.max_labels // 4, 10),
                         rank=mesh.data_rank if mesh else 0, world=n_data)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise SystemExit("the training set is smaller than one batch")
    val_loader = None
    if not args.noval:
        val_ds = PairedDetectionDataset.from_sources(
            data["val_rgb"] if two_stream else data["val"],
            data.get("val_ir"), img_size=val_img_size,
            nc=None if args.single_cls else nc, cache_dir=cache_dir)
        if args.single_cls:
            for lab in val_ds.labels:
                if len(lab):
                    lab[:, 0] = 0
        val_loader = BatchLoader(val_ds, args.batch_size,
                                 max_labels=args.max_labels)

    # ---- loss, optimizer, state
    accumulate = max(round(64 / args.batch_size), 1)
    ohyp = OptHyp(lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
                  weight_decay=hyp["weight_decay"],
                  warmup_epochs=hyp["warmup_epochs"],
                  warmup_momentum=hyp["warmup_momentum"],
                  warmup_bias_lr=hyp["warmup_bias_lr"], adam=args.adam)
    lhyp = LossHyp(box=hyp["box"], obj=hyp["obj"], cls=hyp["cls"],
                   cls_pw=hyp["cls_pw"], obj_pw=hyp["obj_pw"],
                   anchor_t=hyp["anchor_t"], fl_gamma=hyp["fl_gamma"],
                   label_smoothing=hyp["label_smoothing"])
    lhyp = scale_gains(lhyp, nc=nc, img_size=img_size, nl=len(spec.strides))
    loss_fn = DetectionLoss(nc, anchor_arrays(spec.anchors), spec.strides,
                            lhyp, loss_mult=4.0 if args.quad else 1.0,
                            mesh=mesh)
    # val batches are whole and never quadded: the x1 loss of one process
    val_loss_fn = loss_fn if mesh is None and not args.quad else \
        DetectionLoss(nc, anchor_arrays(spec.anchors), spec.strides, lhyp)

    if args.weights and not args.resume:
        n_c, n_t = partial_load(model, load_inference_params(args.weights))
        logger.info(f"warm start: {n_c}/{n_t} tensors from {args.weights}")
    model = model.to(device).to(memory_format=torch.channels_last)
    eval_model = None
    if mesh is not None:
        pm.broadcast_module(model)  # rank 0's initial weights everywhere
        if mesh.n_model > 1:  # the per-epoch eval runs whole
            eval_model = build_model(cfg, nc=nc, anchors=anchors,
                                     dtype=dtype).to(device).to(
                memory_format=torch.channels_last).eval()
        pm.parallelize(model, mesh)
    opt = build_optimizer(model, ohyp, steps_per_epoch, args.epochs,
                          accumulate, args.batch_size,
                          linear_lr=args.linear_lr,
                          freeze=tuple(args.freeze or ()))
    if args.freeze:
        n_frozen = sum(p.numel() for n, p in model.named_parameters()
                       if opt.roles[n] == "frozen")
        logger.info(f"--freeze {args.freeze}: {n_frozen:,} params frozen")
    state = TrainState(model, opt, mesh)
    n_par = sum(p.numel() for p in model.parameters())
    logger.info(f"model: {len(spec.nodes)} layers, {n_par:,} params"
                f"{' on this rank' if eval_model is not None else ''}, "
                f"accumulate={accumulate}")

    start_epoch, best_fitness = 0, 0.0
    if args.resume is True:
        found = get_latest_run(args.project) or get_latest_run("runs")
        if not found:
            raise SystemExit(f"--resume: no 'last' checkpoint found under "
                             f"{args.project} or runs/")
        args.resume = found
        logger.info(f"--resume: found {found}")
    if str(args.resume).startswith("wandb-artifact://"):
        local = ExperimentLogger(
            str(save_dir), enable_tb=False, enable_wandb=True,
            run_name=args.name).resume_from_artifact(
                args.resume, str(save_dir / "artifact"))
        if local is None:
            raise RuntimeError(f"could not fetch artifact {args.resume}")
        args.resume = local
    if args.resume:
        state, meta = load_checkpoint(args.resume, state)
        start_epoch = meta.get("epoch", -1) + 1
        best_fitness = meta.get("best_fitness", 0.0)
        loader.epoch = start_epoch  # the resumed epoch's shuffle and draws
        logger.info(f"resumed from {args.resume} at epoch {start_epoch}")
    if mesh is not None:
        torch.distributed.barrier()

    step = make_train_step(state, loss_fn, remat=args.remat)
    if eval_model is None:
        ema_forward = make_eval_forward(state)
    else:
        ema_forward = model_forward(eval_model)
    shard = pm.EvalShard(mesh, args.batch_size) if mesh else None
    eval_forwards = 0

    def fwd(rgb, ir):
        nonlocal eval_forwards
        eval_forwards += 1
        return ema_forward(rgb, ir)

    ms_rng = random.Random(args.seed + 7)
    ladder = None
    if args.multi_scale:
        lo = max(64, (int(img_size * 0.5) // 64) * 64)
        ladder = list(range(lo, (int(img_size * 1.5) // 64) * 64 + 1, 64))
    aug_gen = torch.Generator().manual_seed(args.seed + 1)  # --device-aug
    rows = args.batch_size // n_data
    row0 = (mesh.data_rank if mesh else 0) * rows

    def save(path, epoch, best, writer=None):
        # under tensor parallelism gathering is collective; rank 0 writes
        if main or eval_model is not None:
            sd = state.state_dict()
            if main:
                save_checkpoint(path, sd, epoch=epoch, best_fitness=best,
                                writer=writer)

    # ---- observability: TensorBoard, W&B, plots (rank 0)
    xlog = ExperimentLogger(str(save_dir), enable_tb=not args.nosave and main,
                            enable_wandb=args.wandb and main,
                            config=_flat(vars(args)), run_name=args.name,
                            entity=args.entity)
    if args.upload_dataset:
        xlog.log_dataset_artifact(data, name=Path(str(args.data)).stem if
                                  isinstance(args.data, str) else "dataset")
    draw = not args.nosave and main and plots.available()
    if not args.nosave and main and not draw:
        logger.info(f"plots skipped: {plots.MISSING}")
    if draw:
        try:
            plots.plot_labels(train_ds.labels, data.get("names", []),
                              str(save_dir))
            plots.plot_label_correlogram(train_ds.labels, str(save_dir))
            plots.plot_lr_schedule(ohyp, steps_per_epoch, args.epochs,
                                   args.batch_size, str(save_dir),
                                   linear_lr=args.linear_lr)
        except Exception as e:
            logger.warning(f"label plot failed: {e}")
    plotted = 0
    names = data.get("names", [str(i) for i in range(nc)])

    results_file = save_dir / "results.txt"
    writer = CheckpointWriter()
    final: dict = {}
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            agg = torch.zeros(4, device=device)  # loss sums, on the device
            nb = 0
            for batch in loader:
                if args.device_aug:
                    draws = take_rows(draw_mosaic(aug_gen, args.batch_size,
                                                  img_size, hyp),
                                      row0, row0 + rows)
                    rgb, ir, tg, tm = device_mosaic_batch(
                        _to_device(batch["tiles_rgb"], device),
                        _to_device(batch["tiles_ir"], device),
                        _to_device(batch["tile_labels"], device),
                        _to_device(batch["tile_lmask"], device), draws,
                        img_size)
                    targets, tmask = image_targets(tg, tm)
                else:
                    rgb = _to_device(batch["rgb"], device)
                    ir = _to_device(batch["ir"], device) if "ir" in batch \
                        else rgb
                    targets = _to_device(batch["targets"], device)
                    tmask = _to_device(batch["tmask"], device)
                if ladder is not None:
                    sz = ms_rng.choice(ladder)
                    rgb, ir = _resize_u8(rgb, sz), _resize_u8(ir, sz)
                if draw and plotted < 3:  # the first batches, as trained
                    plots.plot_batch(rgb.cpu().numpy(),
                                     targets.cpu().numpy(),
                                     tmask.cpu().numpy(),
                                     str(save_dir /
                                         f"train_batch{plotted}.jpg"), names)
                    plotted += 1
                m = step(rgb, ir, targets, tmask,
                         seed=mix_seed(args.seed + 1, state.step))
                agg += torch.stack([m["box"], m["obj"], m["cls"],
                                    m["total"]])
                nb += 1
            box, obj, cls, total = (agg / max(nb, 1)).tolist()  # one read
            line = (f"epoch {epoch}/{args.epochs - 1} box {box:.4f} "
                    f"obj {obj:.4f} cls {cls:.4f} total {total:.4f} "
                    f"({time.time() - t0:.1f}s)")
            fi = 0.0
            if val_loader is not None and (epoch % args.eval_every == 0
                                           or epoch == args.epochs - 1):
                if eval_model is not None:  # the EMA's shards gathered
                    eval_model.load_state_dict(pm.gather_state(
                        state.ema_model.state_dict(), pm.tp_dims(model),
                        mesh))
                panels = []
                hook = None
                if (xlog.wandb_run is not None and args.bbox_interval > 0
                        and epoch % args.bbox_interval == 0):
                    hook = _with_panels(None, panels, val_loader.ds)
                res = evaluate(fwd, val_loader, nc, device=device,
                               conf_thres=0.001, iou_thres=0.6,
                               single_cls=args.single_cls, per_image=hook,
                               loss_fn=val_loss_fn if args.compute_val_loss
                               else None, shard=shard)
                if panels:
                    xlog.log_bbox_debug_images([p[0] for p in panels],
                                               [p[1] for p in panels], names)
                fi = fitness(res["mp"], res["mr"], res["map50"], res["map"])
                line += (f" | P {res['mp']:.3f} R {res['mr']:.3f} "
                         f"mAP50 {res['map50']:.3f} mAP75 "
                         f"{res['map75']:.3f} mAP {res['map']:.3f}")
                if "val_loss" in res:
                    line += (" | val box {:.4f} obj {:.4f} cls {:.4f}"
                             .format(*res["val_loss"]))
                final = res
            logger.info(line)
            if main:
                with open(results_file, "a") as f:
                    f.write(line + "\n")
            xlog.log_epoch(epoch, [box, obj, cls], final if fi else {})
            if args.nosave:
                continue
            if epoch % max(args.ckpt_every, 1) == 0 or \
                    epoch == args.epochs - 1:
                save(save_dir / "last", epoch, max(best_fitness, fi), writer)
            if fi > best_fitness:
                best_fitness = fi
                save(save_dir / "best", epoch, best_fitness, writer)
            if args.save_period > 0 and epoch % args.save_period == 0:
                save(save_dir / f"epoch{epoch}", epoch, best_fitness)
                xlog.log_model(save_dir / f"epoch{epoch}", epoch, fi,
                               best=fi >= best_fitness,
                               save_period=args.save_period)
            if mesh is not None:
                torch.distributed.barrier()
    finally:
        writer.wait()  # background writes land before the strip
        xlog.close()
    if not args.nosave and main:
        for tag in ("last", "best"):
            if (save_dir / tag / "state.pt").is_file():
                strip_checkpoint(save_dir / tag)
    if draw:
        try:
            plots.plot_results(str(results_file),
                               str(save_dir / "results.png"))
        except Exception as e:
            logger.warning(f"results plot failed: {e}")
    out = {k: v for k, v in final.items() if isinstance(v, (int, float))}
    if "val_loss" in final:
        out["val_loss"] = final["val_loss"]
    if main:
        (save_dir / "final.json").write_text(json.dumps(out, indent=1))
    if mesh is not None:
        torch.distributed.barrier()
    out["save_dir"] = str(save_dir)
    out["eval_forwards"] = eval_forwards
    return out


def evolve(args) -> dict:
    """Genetic hyperparameter evolution (the reference's train.py
    --evolve): each generation mutates a parent drawn from the best 5
    rows of ``evolve.txt`` by fitness (80 % of the keys, sigma 0.2, gains
    from ``EVOLVE_META``), clips to its bounds, trains a run without
    checkpoints and appends ``fitness hyp...`` to ``evolve.txt``; the best
    hyperparameters go to ``hyp_evolved.yaml``. Draws from
    ``np.random.default_rng(seed)``. Under a launcher every rank evolves
    alike and rank 0 writes."""
    from ..data.hyps import EVOLVE_META, dump_flat_yaml, load_hyp
    from ..parallel import mesh as pm
    from ..utils.general import device_from_arg
    from ..utils.metrics import fitness as fitness_fn

    world, _ = pm.init_distributed(device_from_arg(args.device),
                                   args.local_rank)
    main = world == 1 or torch.distributed.get_rank() == 0
    base_dir = Path(args.project) / f"{args.name}_evolve"
    base_dir.mkdir(parents=True, exist_ok=True)
    evolve_file = base_dir / "evolve.txt"
    hyp = load_hyp(args.hyp)
    rng = np.random.default_rng(args.seed)
    keys = [k for k in EVOLVE_META if k in hyp]

    best = None
    for gen in range(args.evolve):
        if evolve_file.exists() and evolve_file.stat().st_size:
            rows = np.atleast_2d(np.loadtxt(evolve_file))
            n = min(5, len(rows))
            top = rows[np.argsort(-rows[:, 0])][:n]
            w = top[:, 0] - top[:, 0].min() + 1e-6
            parent = top[rng.choice(n, p=w / w.sum())]
            for _ in range(100):  # mutate until some key moves
                v = np.ones(len(keys))
                while all(v == 1):
                    g = np.array([EVOLVE_META[k][0] for k in keys])
                    v = (g * (rng.random(len(keys)) < 0.8)
                         * rng.standard_normal(len(keys)) * rng.random()
                         * 0.2 + 1).clip(0.3, 3.0)
                if not all(v == 1):
                    break
            for i, k in enumerate(keys):
                hyp[k] = float(parent[i + 1] * v[i])
        for k in keys:  # clip to the bounds
            hyp[k] = float(np.clip(hyp[k], EVOLVE_META[k][1],
                                   EVOLVE_META[k][2]))
        sub = argparse.Namespace(**vars(args))
        sub.hyp = dict(hyp)
        sub.evolve = 0
        sub.name = f"{args.name}_evolve/gen{gen}"
        sub.nosave = True
        sub.exist_ok = True
        res = run(sub)
        fi = fitness_fn(res.get("mp", 0), res.get("mr", 0),
                        res.get("map50", 0), res.get("map", 0))
        if main:
            with open(evolve_file, "a") as f:
                f.write(" ".join([f"{fi:.6f}"]
                                 + [f"{hyp[k]:.6g}" for k in keys]) + "\n")
        if world > 1:  # the next generation reads the file
            torch.distributed.barrier()
        logger.info(f"evolve gen {gen}: fitness {fi:.4f}")
        if best is None or fi > best[0]:
            best = (fi, dict(hyp))
            if main:
                (base_dir / "hyp_evolved.yaml").write_text(
                    dump_flat_yaml(hyp))
    if main and evolve_file.exists() and evolve_file.stat().st_size:
        from ..utils import plots

        if not plots.available():
            logger.info(f"evolve plot skipped: {plots.MISSING}")
        else:
            try:  # fitness against each evolved hyperparameter
                plots.plot_evolution(str(evolve_file), keys,
                                     str(base_dir / "evolve.png"))
            except Exception as e:
                logger.warning(f"evolve plot failed: {e}")
    return {"best_fitness": best[0] if best else 0.0,
            "hyp": best[1] if best else hyp}


def main(argv=None) -> int:
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"train_cli: {e}", file=sys.stderr)
        return 1
    if args.evolve > 0:
        evolve(args)
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
