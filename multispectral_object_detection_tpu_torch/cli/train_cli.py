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

Flags whose modules are not ported yet exit with a message naming the
ROADMAP item that brings them. Plots and TensorBoard are not ported
(ROADMAP queue 1, item 7); the run says so once.
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

_ITEM5 = "ROADMAP queue 1, item 5, its remainder"
_ITEM6 = "ROADMAP queue 1, item 6"
_ITEM7 = "ROADMAP queue 1, item 7"
# flag -> (its default, why it stops here: the ROADMAP item that ports it)
DEFERRED = {
    "device_aug": (False, "--device-aug needs ops/augment_device.py and the "
                          f"device HSV jitter ({_ITEM5})"),
    "quad": (False, f"--quad needs quad collation ({_ITEM5})"),
    "evolve": (0, f"--evolve (hyperparameter evolution) is not ported yet "
                  f"({_ITEM5})"),
    "n_model": (1, f"--n-model (tensor parallel) comes with the parallel "
                   f"port ({_ITEM6})"),
    "sync_bn": (False, f"--sync-bn comes with the parallel port ({_ITEM6})"),
    "local_rank": (-1, f"--local_rank comes with the parallel port "
                       f"({_ITEM6})"),
    "wandb": (False, f"--wandb needs utils/loggers.py ({_ITEM7})"),
    "upload_dataset": (False, f"--upload-dataset needs utils/loggers.py "
                              f"({_ITEM7})"),
    "entity": (None, f"--entity needs utils/loggers.py ({_ITEM7})"),
    "bbox_interval": (-1, f"--bbox-interval needs utils/loggers.py "
                          f"({_ITEM7})"),
    "artifact_alias": ("latest", f"--artifact-alias needs utils/loggers.py "
                                 f"({_ITEM7})"),
}


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
    # flags of modules not ported yet (DEFERRED)
    ap.add_argument("--device-aug", action="store_true", help="not ported")
    ap.add_argument("--quad", action="store_true", help="not ported")
    ap.add_argument("--evolve", type=int, default=0, metavar="N",
                    help="not ported")
    ap.add_argument("--n-model", type=int, default=1, help="not ported")
    ap.add_argument("--sync-bn", action="store_true", help="not ported")
    ap.add_argument("--local_rank", type=int, default=-1, help="not ported")
    ap.add_argument("--wandb", action="store_true", help="not ported")
    ap.add_argument("--upload-dataset", "--upload_dataset",
                    action="store_true", help="not ported")
    ap.add_argument("--entity", type=str, default=None, help="not ported")
    ap.add_argument("--bbox-interval", "--bbox_interval", type=int,
                    default=-1, help="not ported")
    ap.add_argument("--artifact-alias", "--artifact_alias", type=str,
                    default="latest", help="not ported")
    return ap.parse_args(argv)


def _check_flags(args) -> None:
    for flag, (default, msg) in DEFERRED.items():
        if getattr(args, flag, default) != default:
            raise SystemExit(f"train_cli: {msg}")


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
    from ..train.evaluator import evaluate
    from ..train.loss import DetectionLoss, LossHyp, scale_gains
    from ..train.optim import OptHyp, build_optimizer
    from ..train.trainer import TrainState, make_eval_forward, make_train_step
    from ..utils.checkpoint import (CheckpointWriter, load_checkpoint,
                                    load_inference_params, partial_load,
                                    save_checkpoint, strip_checkpoint)
    from ..utils.general import (check_img_size, device_from_arg,
                                 get_latest_run, increment_path, init_seeds)
    from ..utils.metrics import fitness
    from .test_cli import _load_data

    _check_flags(args)
    device = device_from_arg(args.device)
    init_seeds(args.seed)
    save_dir = increment_path(Path(args.project) / args.name,
                              exist_ok=args.exist_ok)
    save_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f"run dir: {save_dir} ({device})")
    if not args.nosave:
        logger.info("plots and TensorBoard are not ported yet (ROADMAP "
                    "queue 1, item 7): results.txt and final.json only")

    data = _load_data(args.data)
    nc = 1 if args.single_cls else int(data["nc"])
    two_stream = "train_ir" in data
    sizes = (args.img_size if isinstance(args.img_size, (list, tuple))
             else [args.img_size])
    img_size = check_img_size(sizes[0], 32)
    val_img_size = check_img_size(sizes[-1], 32)
    hyp = load_hyp(args.hyp)
    hyp["label_smoothing"] = args.label_smoothing
    (save_dir / "hyp.yaml").write_text(dump_flat_yaml(hyp))
    (save_dir / "opt.yaml").write_text(dump_flat_yaml(_flat(vars(args))))

    # ---- data
    train_ds = PairedDetectionDataset.from_sources(
        data["train_rgb"] if two_stream else data["train"],
        data.get("train_ir"), img_size=img_size, augment=True, hyp=hyp,
        nc=None if args.single_cls else nc, rect=args.rect,
        cache_dir=str(save_dir / "cache"), cache_images=args.cache_images)
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
                         drop_last=True, image_weights=args.image_weights)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise SystemExit("the training set is smaller than one batch")
    val_loader = None
    if not args.noval:
        val_ds = PairedDetectionDataset.from_sources(
            data["val_rgb"] if two_stream else data["val"],
            data.get("val_ir"), img_size=val_img_size,
            nc=None if args.single_cls else nc,
            cache_dir=str(save_dir / "cache"))
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
                            lhyp)

    if args.weights and not args.resume:
        n_c, n_t = partial_load(model, load_inference_params(args.weights))
        logger.info(f"warm start: {n_c}/{n_t} tensors from {args.weights}")
    model = model.to(device).to(memory_format=torch.channels_last)
    opt = build_optimizer(model, ohyp, steps_per_epoch, args.epochs,
                          accumulate, args.batch_size,
                          linear_lr=args.linear_lr,
                          freeze=tuple(args.freeze or ()))
    if args.freeze:
        n_frozen = sum(p.numel() for n, p in model.named_parameters()
                       if opt.roles[n] == "frozen")
        logger.info(f"--freeze {args.freeze}: {n_frozen:,} params frozen")
    state = TrainState(model, opt)
    n_par = sum(p.numel() for p in model.parameters())
    logger.info(f"model: {len(spec.nodes)} layers, {n_par:,} params, "
                f"accumulate={accumulate}")

    start_epoch, best_fitness = 0, 0.0
    if args.resume is True:
        found = get_latest_run(args.project) or get_latest_run("runs")
        if not found:
            raise SystemExit(f"--resume: no 'last' checkpoint found under "
                             f"{args.project} or runs/")
        args.resume = found
        logger.info(f"--resume: found {found}")
    if args.resume:
        state, meta = load_checkpoint(args.resume, state)
        start_epoch = meta.get("epoch", -1) + 1
        best_fitness = meta.get("best_fitness", 0.0)
        loader.epoch = start_epoch  # the resumed epoch's shuffle and draws
        logger.info(f"resumed from {args.resume} at epoch {start_epoch}")

    step = make_train_step(state, loss_fn, remat=args.remat)
    ema_forward = make_eval_forward(state)
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

    results_file = save_dir / "results.txt"
    writer = CheckpointWriter()
    final: dict = {}
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            agg = torch.zeros(4, device=device)  # loss sums, on the device
            nb = 0
            for batch in loader:
                rgb = _to_device(batch["rgb"], device)
                ir = _to_device(batch["ir"], device) if "ir" in batch else rgb
                if ladder is not None:
                    sz = ms_rng.choice(ladder)
                    rgb, ir = _resize_u8(rgb, sz), _resize_u8(ir, sz)
                m = step(rgb, ir, _to_device(batch["targets"], device),
                         _to_device(batch["tmask"], device),
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
                res = evaluate(fwd, val_loader, nc, device=device,
                               conf_thres=0.001, iou_thres=0.6,
                               single_cls=args.single_cls,
                               loss_fn=loss_fn if args.compute_val_loss
                               else None)
                fi = fitness(res["mp"], res["mr"], res["map50"], res["map"])
                line += (f" | P {res['mp']:.3f} R {res['mr']:.3f} "
                         f"mAP50 {res['map50']:.3f} mAP75 "
                         f"{res['map75']:.3f} mAP {res['map']:.3f}")
                if "val_loss" in res:
                    line += (" | val box {:.4f} obj {:.4f} cls {:.4f}"
                             .format(*res["val_loss"]))
                final = res
            logger.info(line)
            with open(results_file, "a") as f:
                f.write(line + "\n")
            if args.nosave:
                continue
            if epoch % max(args.ckpt_every, 1) == 0 or \
                    epoch == args.epochs - 1:
                save_checkpoint(save_dir / "last", state, epoch=epoch,
                                best_fitness=max(best_fitness, fi),
                                writer=writer)
            if fi > best_fitness:
                best_fitness = fi
                save_checkpoint(save_dir / "best", state, epoch=epoch,
                                best_fitness=best_fitness, writer=writer)
            if args.save_period > 0 and epoch % args.save_period == 0:
                save_checkpoint(save_dir / f"epoch{epoch}", state,
                                epoch=epoch, best_fitness=best_fitness)
    finally:
        writer.wait()  # background writes land before the strip
    if not args.nosave:
        for tag in ("last", "best"):
            if (save_dir / tag / "state.pt").is_file():
                strip_checkpoint(save_dir / tag)
    out = {k: v for k, v in final.items() if isinstance(v, (int, float))}
    if "val_loss" in final:
        out["val_loss"] = final["val_loss"]
    (save_dir / "final.json").write_text(json.dumps(out, indent=1))
    out["save_dir"] = str(save_dir)
    out["eval_forwards"] = eval_forwards
    return out


def main(argv=None) -> int:
    from ..utils.general import device_from_arg

    logging.basicConfig(format="%(message)s", level=logging.INFO)
    args = parse_args(argv)
    try:
        device_from_arg(args.device)
    except RuntimeError as e:
        print(f"train_cli: {e}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
