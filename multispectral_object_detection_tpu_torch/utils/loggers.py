"""Experiment logging, the counterpart of multispectral_object_detection_tpu/
utils/loggers.py: TensorBoard scalars (``torch.utils.tensorboard``, where
the ``tensorboard`` package imports) and optional W&B (imported at first
use). Where either is missing the logger warns once and that part does
nothing, with the same interface.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

TB_TAGS = [
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
    "metrics/mAP_0.75", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss",
    "x/lr0", "x/lr1", "x/momentum",
]


class ExperimentLogger:
    """Unified scalar logger: TensorBoard + (optional) W&B + results.txt."""

    def __init__(self, save_dir: str, enable_tb: bool = True,
                 enable_wandb: bool = False, config: Optional[dict] = None,
                 run_name: str = "exp", entity: Optional[str] = None):
        self.save_dir = Path(save_dir)
        self.tb = None
        self.wandb_run = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.save_dir / "tb"))
            except Exception as e:
                logger.warning(f"tensorboard unavailable: {e}")
        if enable_wandb:
            try:
                import wandb

                self.save_dir.mkdir(parents=True, exist_ok=True)

                self.wandb_run = wandb.init(dir=str(self.save_dir),
                                            name=run_name, config=config,
                                            entity=entity)
            except Exception as e:
                logger.warning(f"wandb unavailable: {e}")

    def log_scalars(self, scalars: Dict[str, float], step: int):
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb_run is not None:
            self.wandb_run.log(scalars, step=step)

    def log_epoch(self, epoch: int, train_losses, eval_results: dict,
                  lrs: Optional[dict] = None):
        s = {
            "train/box_loss": train_losses[0],
            "train/obj_loss": train_losses[1],
            "train/cls_loss": train_losses[2],
        }
        if eval_results:
            s.update({
                "metrics/precision": eval_results.get("mp", 0.0),
                "metrics/recall": eval_results.get("mr", 0.0),
                "metrics/mAP_0.5": eval_results.get("map50", 0.0),
                "metrics/mAP_0.75": eval_results.get("map75", 0.0),
                "metrics/mAP_0.5:0.95": eval_results.get("map", 0.0),
            })
            if "val_loss" in eval_results:
                vb, vo, vc = eval_results["val_loss"]
                s.update({"val/box_loss": vb, "val/obj_loss": vo,
                          "val/cls_loss": vc})
        if lrs:
            s.update({f"x/{k}": v for k, v in lrs.items()})
        self.log_scalars(s, epoch)

    # ---- W&B artifact surface (utils/wandb_logging/wandb_utils.py:80-306) --
    # Every method no-ops without an active wandb run.

    def log_dataset_artifact(self, data: dict, name: str = "dataset"):
        """Dataset-as-artifact (wandb_utils.py:166-201): the dataset YAML
        plus per-split image directory references."""
        if self.wandb_run is None:
            return None
        import wandb

        art = wandb.Artifact(name, type="dataset",
                             metadata={k: v for k, v in data.items()
                                       if isinstance(v, (int, str, list))})
        for key in ("train_rgb", "train_ir", "val_rgb", "val_ir", "train",
                    "val"):
            d = data.get(key)
            if d and Path(str(d)).is_dir():
                art.add_reference("file://" + str(Path(d).resolve()),
                                  name=key)
        self.wandb_run.log_artifact(art)
        return art

    def log_model(self, ckpt_dir: str, epoch: int, fitness: float,
                  best: bool = False, save_period: int = -1):
        """Model checkpoint artifact per save_period + aliases
        (wandb_utils.py:203-215)."""
        if self.wandb_run is None:
            return None
        if save_period > 0 and epoch % save_period != 0 and not best:
            return None
        import wandb

        art = wandb.Artifact(f"run_{self.wandb_run.id}_model", type="model",
                             metadata={"epoch": epoch, "fitness": fitness})
        art.add_dir(str(ckpt_dir))
        aliases = ["latest", f"epoch{epoch}"] + (["best"] if best else [])
        self.wandb_run.log_artifact(art, aliases=aliases)
        return art

    def log_bbox_debug_images(self, images, detections, names,
                              key: str = "Bounding Box Debugger/Images",
                              max_images: int = 16):
        """Validation bbox debug panels (wandb_utils.py:226-244,
        test.py:160-170). images: (B, H, W, 3) uint8; detections: list of
        (boxes xyxy, scores, classes) per image."""
        if self.wandb_run is None:
            return
        import wandb

        panels = []
        for i, (img, det) in enumerate(zip(images, detections)):
            if i >= max_images:
                break
            boxes, scores, classes = det
            box_data = [{
                "position": {"minX": float(b[0]), "minY": float(b[1]),
                             "maxX": float(b[2]), "maxY": float(b[3])},
                "class_id": int(c),
                "box_caption": f"{names[int(c)]} {s:.3f}",
                "scores": {"class_score": float(s)},
                "domain": "pixel",
            } for b, s, c in zip(boxes, scores, classes)]
            panels.append(wandb.Image(img, boxes={
                "predictions": {"box_data": box_data,
                                "class_labels": dict(enumerate(names))}}))
        self.wandb_run.log({key: panels})

    def resume_from_artifact(self, path: str, out_dir: str) -> Optional[str]:
        """Download a `wandb-artifact://` model for --resume
        (wandb_utils.py:110-135). Returns the local checkpoint dir."""
        if not str(path).startswith("wandb-artifact://"):
            return None
        import wandb

        api_path = str(path)[len("wandb-artifact://"):]
        art = (self.wandb_run.use_artifact(api_path)
               if self.wandb_run is not None
               else wandb.Api().artifact(api_path))
        return art.download(root=str(out_dir))

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()
