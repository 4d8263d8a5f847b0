"""A pickled reference checkpoint's weights as a state dict: the port's
counterpart of ``tools/export_torch_ckpt.py``, with its flags.

The reference saves pickled modules (``{'model': Model, 'ema': Model}``,
half precision; train.py:850-866), which ``utils/checkpoint.py``'s
``load_inference_params`` refuses to unpickle. Unpickling needs the
reference repository's classes (``--repo``) and runs code from the file,
so only export checkpoints you trust:

    python -m multispectral_object_detection_tpu_torch.tools.export_torch_ckpt \\
        --pt best.pt --repo /path/to/reference --out best_sd.pt [--ema]

``--out *.pt`` writes the fp32 state dict as a ``.pt`` of tensors, which
``load_inference_params`` (and so ``--weights`` of every CLI and hub
entry point) reads as it is; ``--out *.npz`` writes what the JAX tool
writes (the same keys and arrays through ``np.savez``), which the JAX
package imports.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "python -m multispectral_object_detection_tpu_torch.tools."
        "export_torch_ckpt",
        description="Unpickles a reference checkpoint: a pickle runs code "
                    "from the file, so export only checkpoints you trust.")
    ap.add_argument("--pt", required=True,
                    help="the pickled checkpoint (unpickling runs its code)")
    ap.add_argument("--repo", default="",
                    help="path to the repo defining the pickled classes")
    ap.add_argument("--out", required=True,
                    help="*.pt: a state dict of fp32 tensors; *.npz: numpy "
                         "arrays (the JAX tool's output)")
    ap.add_argument("--ema", action="store_true",
                    help="export the EMA weights instead of the raw model")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.repo:
        sys.path.insert(0, args.repo)
    try:
        ckpt = torch.load(args.pt, map_location="cpu", weights_only=False)
    finally:
        if args.repo:
            sys.path.remove(args.repo)
    key = "ema" if args.ema else "model"
    model = ckpt.get(key, ckpt) if isinstance(ckpt, dict) else ckpt
    if model is None:
        print(f"export_torch_ckpt: {args.pt} holds no {key!r} weights "
              f"(None)", file=sys.stderr)
        return 1
    sd = model.float().state_dict() if hasattr(model, "state_dict") else model
    if args.out.endswith(".npz"):
        np.savez(args.out, **{k: v.numpy() if hasattr(v, "numpy") else v
                              for k, v in sd.items()})
    else:
        sd = {k: torch.as_tensor(v).detach() for k, v in sd.items()}
        torch.save({k: v.float() if v.is_floating_point() else v.clone()
                    for k, v in sd.items()}, args.out)
    print(f"wrote {len(sd)} tensors -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
