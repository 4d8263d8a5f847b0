"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import functools
import os

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_torch_threads():
    """Under pytest-xdist, a share of the machine's intra-op threads for a
    test module's torch CPU work (import this fixture into the module):
    one thread each at 6 workers on 8 cores. With more threads than cores
    across the worker processes, OpenMP's waiting threads slow torch's CPU
    kernels by orders of magnitude (on 8 cores, a CLI test of this suite
    took 4 s alone and 160 s beside one other process running 8 threads).
    A single process keeps its threads."""
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, n // workers))
    yield
    torch.set_num_threads(n)


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


@functools.lru_cache(maxsize=None)
def _jax_fold():
    """The JAX package's BN folding as one compiled function (made once, so
    every seed's same-shaped tree reuses its compilation)."""
    import jax

    from multispectral_object_detection_tpu.models.model import (
        fuse_conv_bn_params)

    return jax.jit(fuse_conv_bn_params)


@functools.lru_cache(maxsize=None)
def mini_weights(seed: int) -> dict:
    """The n-scale two-stream CFT model (nc=2) with ``random_state_dict``
    weights from ``seed``, built once per process for every test module
    that uses it: ``cfg``, the reference-layout state dict ``sd``, the
    JAX trees ``params``/``stats`` and the BN-folded JAX ``fparams`` (one
    compiled program). Callers must not modify them."""
    from multispectral_object_detection_tpu.utils.torch_import import (
        convert_state_dict)
    from multispectral_object_detection_tpu_torch.models import configs
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model)

    cfg = configs.yolov5_two_stream("n", nc=2, fusion="transformerx3")
    sd = random_state_dict(build_model(cfg), seed)
    params, stats = convert_state_dict(sd)
    return dict(cfg=cfg, sd=sd, params=params, stats=stats,
                fparams=_jax_fold()(params, stats))


@functools.lru_cache(maxsize=None)
def jax_fused_forward():
    """The JAX package's eval forward of the ``mini_weights`` model, BN
    folded, with the Pallas CFT stack (interpret mode on the CPU):
    (fparams, rgb, ir uint8 NHWC) -> (raw head outputs, decoded
    detections), inputs / 255 as its ``make_eval_forward`` does. One
    compilation per input shape for every test module that calls it."""
    import jax
    import jax.numpy as jnp

    from multispectral_object_detection_tpu.models import build_model

    model = build_model(mini_weights(0)["cfg"], fused=True, use_pallas=True)

    @jax.jit
    def fwd(fparams, rgb, ir):
        x, x2 = (a.astype(jnp.float32) / 255.0 for a in (rgb, ir))
        raw = model.apply({"params": fparams, "batch_stats": {}}, x, x2,
                          train=False)
        return raw, model.decode(raw)

    return fwd


@functools.lru_cache(maxsize=None)
def mini_single_weights(seed: int) -> dict:
    """The n-scale single-stream YOLOv5 (nc=2) with ``random_state_dict``
    weights from ``seed``: ``cfg``, ``sd`` and the JAX trees
    ``params``/``stats`` (unfused). Callers must not modify them."""
    from multispectral_object_detection_tpu.utils.torch_import import (
        convert_state_dict)
    from multispectral_object_detection_tpu_torch.models import configs
    from multispectral_object_detection_tpu_torch.models.model import (
        build_model)

    cfg = configs.yolov5("n", nc=2)
    sd = random_state_dict(build_model(cfg), seed)
    params, stats = convert_state_dict(sd)
    return dict(cfg=cfg, sd=sd, params=params, stats=stats)


def write_jax_checkpoint(directory, params, stats) -> str:
    """A stripped JAX checkpoint directory (``model.msgpack``)."""
    from pathlib import Path

    from flax import serialization

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "model.msgpack").write_bytes(serialization.msgpack_serialize(
        {"params": params, "batch_stats": stats}))
    return str(d)
