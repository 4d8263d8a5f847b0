"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import numpy as np
import torch


def random_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """Random numpy values for every entry of ``module.state_dict()``:
    conv/linear weights ~ N(0, 1/fan_in), BatchNorm scales and running
    variances in [0.5, 1.5], biases, means and position embeddings small."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros((), np.int64)
        elif k.endswith(("running_var",)) or (
                k.endswith(".weight") and len(shape) == 1):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith(".weight"):
            fan_in = int(np.prod(shape[1:]))
            out[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        else:  # biases, running means, pos_emb
            out[k] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return out


def load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in sd.items()})
    return module.eval()


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()
