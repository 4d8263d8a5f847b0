"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py)."""

import contextlib
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


@contextlib.contextmanager
def jax_training_as_port(two_pass_variance: bool = True):
    """Within: the JAX package trains the function the port's tests train,
    through test-side substitutions, restored on exit (its files stay
    untouched):

    - its CFT stages build with dropout 0 (``CrossModalFusion`` in its
      models/model.py wrapped in a partial), as the port's tests turn
      dropout off (``port_without_dropout``);
    - with ``two_pass_variance``, its BatchNorm computes the batch variance
      in two passes, E[(x-mean)^2] (``use_fast_variance=False``), as the
      port's (ATen's) does, instead of flax's default E[x^2] - mean^2,
      which loses about mean^2/var ulps (the float64 run keeps flax's).

    A flax module builds its submodules at every apply (and a jitted
    function at every trace), so each call runs inside."""
    from types import SimpleNamespace

    import flax.linen as nn

    from multispectral_object_detection_tpu.models import layers as jl
    from multispectral_object_detection_tpu.models import model as jm

    class TwoPassBatchNorm(nn.BatchNorm):
        use_fast_variance: bool = False

    orig_fusion, orig_nn = jm.CrossModalFusion, jl.nn
    jm.CrossModalFusion = functools.partial(orig_fusion, embd_drop=0.0,
                                            attn_drop=0.0, resid_drop=0.0)
    if two_pass_variance:
        jl.nn = SimpleNamespace(**{**vars(nn), "BatchNorm": TwoPassBatchNorm})
    try:
        yield
    finally:
        jm.CrossModalFusion, jl.nn = orig_fusion, orig_nn


@contextlib.contextmanager
def float32_read_as_float64():
    """Within: both packages compute in float64 wherever they name float32
    (their statistics, logits and loss dtype), through test-side
    substitutions restored on exit: each module's ``jnp`` (JAX package) or
    ``torch`` (port) name reads ``float32`` as ``float64``, the port's
    host-side float32 schedules (``_F32``) run in float64, and
    ``Tensor.float()`` gives float64; JAX runs with x64 enabled and torch
    with float64 as its default dtype. Constants
    the packages round through numpy's float32 (anchors) stay so on both
    sides. With the rounding noise of float32 gone, two implementations of
    the same function agree to about 1e-12 even where the function is
    ill-conditioned, so a residual difference there is a fault."""
    import importlib
    import sys
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    for pkg in ("multispectral_object_detection_tpu",
                "multispectral_object_detection_tpu_torch"):
        for mod in ("models.model", "train.loss", "train.optim",
                    "train.trainer"):
            importlib.import_module(f"{pkg}.{mod}")
    jnp64 = SimpleNamespace(**{**vars(jnp), "float32": jnp.float64})
    torch64 = SimpleNamespace(**{**vars(torch), "float32": torch.float64})
    swapped = []
    for name, mod in list(sys.modules.items()):
        for pkg, attr, orig, proxy in (
                ("multispectral_object_detection_tpu.", "jnp", jnp, jnp64),
                ("multispectral_object_detection_tpu_torch.", "torch", torch,
                 torch64),
                ("multispectral_object_detection_tpu_torch.", "_F32",
                 np.float32, np.float64)):
            if name.startswith(pkg) and getattr(mod, attr, None) is orig:
                setattr(mod, attr, proxy)
                swapped.append((mod, attr, orig))
    orig_float, orig_default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)  # as x64 makes JAX's default
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.Tensor.float = orig_float
        torch.set_default_dtype(orig_default)
        for mod, attr, orig in swapped:
            setattr(mod, attr, orig)


def port_without_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """The port's CFT stages with dropout 0, in place."""
    from multispectral_object_detection_tpu_torch.models.fusion import (
        CrossModalFusion)

    for m in model.modules():
        if isinstance(m, CrossModalFusion):
            m.embd_drop = m.attn_drop = m.resid_drop = 0.0
    return model


def train_batch(n_img: int = 2, img: int = 64, seed: int = 0):
    """A fixed training batch: uint8 NHWC RGB and IR (n_img, img, img, 3)
    and padded targets (n_img * 8, 6) with their mask (3 boxes per image,
    classes 0 and 1)."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n_img, img, img, 3), dtype=np.uint8)
    ir = rng.integers(0, 256, (n_img, img, img, 3), dtype=np.uint8)
    targets = np.zeros((n_img * 8, 6), np.float32)
    tmask = np.zeros((n_img * 8,), np.float32)
    for b in range(n_img):
        for j in range(3):
            r = b * 8 + j
            wh = rng.uniform(0.1, 0.5, 2)
            xy = rng.uniform(wh / 2, 1 - wh / 2)
            targets[r] = [b, (b + j) % 2, *xy, *wh]
            tmask[r] = 1.0
    return rgb, ir, targets, tmask


# the learning rates of the 10-step trajectory tests: at the scratch hyps
# (bias lr 0.1, batch 2) the mini model's training is chaotic on the CPU: a
# change of its fp32 weights by one part in 1e7 moves its parameters by 5e-2
# within 8 steps, on either side alone. At 1e-3 the same change moves them
# by less than 2e-5 in 10 steps, so a 1e-3 bound there compares the recipes
TRAJECTORY_HYP = dict(lr0=1e-3, warmup_bias_lr=1e-3)


@functools.lru_cache(maxsize=None)
def jax_train_fns(x64: bool = False):
    """The JAX package's train step for the ``mini_weights`` model in fp32
    (call it inside ``jax_training_as_port``), compiled once per process:

    - ``step(state, rgb, ir, targets, tmask, rng)``, its
      ``make_train_step`` with SGD at ``TRAJECTORY_HYP`` (the scratch
      hyps at lr0 = warmup_bias_lr = 1e-3), 4 steps per epoch, 3 epochs,
      batch 64 (so every micro-batch emits), whose warmup then spans 12
      micro-batches;
    - ``state(params, stats)``, a fresh TrainState for ``step``;
    - ``wd``, the optimizer's scaled weight decay (the momentum buffer
      after the first step is the gradient, plus ``wd`` times the
      parameter for the decayed role).

    With ``x64`` the model computes in float64 and ``state`` makes float64
    parameters (build and call it inside ``float32_read_as_float64`` too)."""
    import jax
    import jax.numpy as jnp

    from multispectral_object_detection_tpu.models import build_model
    from multispectral_object_detection_tpu.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu.train.loss import (
        DetectionLoss, LossHyp)
    from multispectral_object_detection_tpu.train.optim import (
        OptHyp, build_optimizer)
    from multispectral_object_detection_tpu.train.trainer import (
        TrainState, make_train_step)

    dtype = jnp.float64 if x64 else jnp.float32
    model = build_model(mini_weights(0)["cfg"], dtype=dtype)
    spec = model.spec
    loss_fn = DetectionLoss(nc=2, anchors_px=anchor_arrays(spec.anchors),
                            strides=spec.strides, hyp=LossHyp())
    hyp = OptHyp(**TRAJECTORY_HYP)
    tx, _ = build_optimizer(mini_weights(0)["params"], hyp, 4, 3, 1, 64,
                            warmup_min_iters=1)
    step = make_train_step(model, loss_fn, tx, two_stream=True,
                           donate=False)

    def state(params, stats):
        copy = functools.partial(jax.tree.map,
                                 lambda a: jnp.array(a, dtype=dtype))
        return TrainState(params=copy(params), batch_stats=copy(stats),
                          opt_state=tx.init(copy(params)),
                          ema_params=copy(params), ema_stats=copy(stats),
                          step=jnp.zeros((), jnp.int32),
                          ema_updates=jnp.zeros((), jnp.int32))

    return dict(step=step, state=state, wd=hyp.weight_decay * 64 * 1 / 64)


class FakeArtifact:
    """A stand-in for ``wandb.Artifact`` that records what is added."""

    def __init__(self, name, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, metadata
        self.refs, self.dirs, self.aliases = [], [], []

    def add_reference(self, uri, name=None):
        self.refs.append((uri, name))

    def add_dir(self, d):
        self.dirs.append(d)

    def download(self, root=None):
        return str(root)


class FakeRun:
    """A stand-in for a W&B run: records logged payloads and artifacts."""

    def __init__(self):
        self.id = "fake123"
        self.logged, self.artifacts, self.used = [], [], []
        self.finished = False

    def log(self, payload, step=None):
        self.logged.append((payload, step))

    def log_artifact(self, art, aliases=None):
        art.aliases = aliases or []
        self.artifacts.append(art)

    def use_artifact(self, path):
        self.used.append(path)
        return FakeArtifact(path)

    def finish(self):
        self.finished = True


def install_fake_wandb(monkeypatch) -> FakeRun:
    """A fake ``wandb`` module in ``sys.modules`` for the test; returns the
    run its ``init`` hands out (``init``'s keywords in ``run.init_kw``)."""
    import sys
    import types

    run = FakeRun()
    mod = types.ModuleType("wandb")

    def init(**kw):
        run.init_kw = kw
        return run

    mod.init = init
    mod.Artifact = FakeArtifact
    mod.Image = lambda img, boxes=None: ("image", np.asarray(img).shape,
                                         boxes)
    mod.Api = lambda: types.SimpleNamespace(
        artifact=lambda p: FakeArtifact(p))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return run
