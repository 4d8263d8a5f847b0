"""PyTorch port, data and tensor parallelism (parallel/mesh.py) on the CPU:
ranks are processes joined over gloo through a FileStore, started by
``parallel.mesh.spawn`` (two process groups in this module, each with a
time limit after which its ranks are killed).

- on one pair of ranks (started with the module, so that they run while
  this process compiles the JAX mesh step), a 2 x 1 (data) and then a
  1 x 2 (tensor) grid each run one train step of the mini model (n-scale
  two-stream CFT, nc=2, 64 px, global batch 4, fp32, dropout on) that
  must equal the port's single-process step on the global batch (run
  once, in this process), and in float64
  (tests/_torch_parallel.port_float64) to rounding;
  the same steps with dropout off match the JAX package's
  ``make_parallel_train_step`` on the conftest's virtual devices;
- each grid then runs the train CLI (``--device-aug --sync-bn`` on the
  data grid, ``--n-model 2`` on the tensor grid), and the tensor grid's
  gathered checkpoint resumes in one process and evaluates there;
- ``test_cli --data-parallel 2`` gives the single-process port's metrics
  and the JAX CLI's ``--data-parallel 2`` ones.
"""

import concurrent.futures
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multispectral_object_detection_tpu_torch.cli import test_cli, train_cli
from multispectral_object_detection_tpu_torch.data.synthetic import (
    make_paired_dataset)
from multispectral_object_detection_tpu_torch.parallel import mesh as pm
from tests import _torch_parallel as W
from tests._torch_port import (  # noqa: F401
    TRAJECTORY_HYP, jax_training_as_port, mini_weights, share_torch_threads,
    train_batch, write_jax_checkpoint)
from tests.test_torch_train import _bridged, _decayed, _leaves, _tensor_errors

SPAWN_S = 180  # each process group's time limit (one torch thread a rank)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    rgb, ir = make_paired_dataset(str(root / "data"), n_images=6,
                                  img_size=64, nc=2, seed=5)
    data = {"train_rgb": rgb, "train_ir": ir, "val_rgb": rgb, "val_ir": ir,
            "nc": 2, "names": ["red", "blue"]}
    return dict(root=root, data=data)


@pytest.fixture(scope="module", autouse=True)
def grids_started(ws):
    """Both grids of W.GRIDS on one pair of ranks, started with the module
    so that the ranks run while this process computes the JAX mesh step
    (the first test) and the single-process step; waited for at the end."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(pm.spawn, 2, W.suite, ws["data"],
                          str(ws["root"] / "runs"), timeout=SPAWN_S,
                          store_dir=str(ws["root"]), threads=1)


@pytest.fixture(scope="module")
def grids(grids_started):
    return grids_started.result()


@pytest.fixture(scope="module")
def data_grid(grids):
    return grids["data_grid"]


@pytest.fixture(scope="module")
def model_grid(grids):
    return grids["model_grid"]


@pytest.fixture(scope="module")
def single_process():
    """The single-process step on the global batch, fp32 and float64."""
    return {"fp32": W.run_step(None, dropout=True)[:3],
            "fp64": W.run_step(None, dropout=True, x64=True)[:3]}


def test_resolve_data_axis():
    assert pm.resolve_data_axis(16, 8) == (8, 16, False)
    assert pm.resolve_data_axis(12, 8) == (8, 16, True)
    assert pm.resolve_data_axis(4, 8) == (4, 4, False)
    assert pm.resolve_data_axis(6, 8, n_model=2) == (4, 8, True)
    assert pm.resolve_data_axis(2, 8, n_model=4) == (2, 2, False)
    assert pm.resolve_data_axis(5, 1) == (1, 5, False)


def _jax_mesh_step(n_data: int, n_model: int):
    """The JAX package's parallel step on the mini weights (dropout off,
    the two-pass BatchNorm variance), global batch ``train_batch(4, 64)``: (loss
    components, gradients read from the momentum buffer, statistics)."""
    from multispectral_object_detection_tpu.models import build_model
    from multispectral_object_detection_tpu.models.detect import (
        anchor_arrays)
    from multispectral_object_detection_tpu.parallel.mesh import (
        make_mesh, make_parallel_train_step, param_shardings, shard_state)
    from multispectral_object_detection_tpu.train.loss import (
        DetectionLoss, LossHyp)
    from multispectral_object_detection_tpu.train.optim import (
        OptHyp, build_optimizer)
    from multispectral_object_detection_tpu.train.trainer import TrainState

    import jax.numpy as jnp

    w = mini_weights(0)
    model = build_model(w["cfg"])
    spec = model.spec
    loss_fn = DetectionLoss(nc=2, anchors_px=anchor_arrays(spec.anchors),
                            strides=spec.strides, hyp=LossHyp())
    hyp = OptHyp(**TRAJECTORY_HYP)
    tx, _ = build_optimizer(w["params"], hyp, 4, 3, 1, 64,
                            warmup_min_iters=1)
    mesh = make_mesh(n_data, n_model, devices=jax.devices()[:n_data
                                                            * n_model])
    copy = functools.partial(jax.tree.map, jnp.array)
    params = copy(w["params"])
    state = TrainState(params=params, batch_stats=copy(w["stats"]),
                       opt_state=tx.init(params), ema_params=copy(params),
                       ema_stats=copy(w["stats"]),
                       step=jnp.zeros((), jnp.int32),
                       ema_updates=jnp.zeros((), jnp.int32))
    state = shard_state(state, param_shardings(params, mesh,
                                               tensor_parallel=n_model > 1),
                        mesh)
    step = make_parallel_train_step(model, loss_fn, tx, True, mesh,
                                    tensor_parallel=n_model > 1,
                                    donate=False)
    with jax_training_as_port():
        new, m = step(state, *train_batch(W.BATCH, W.IMG, seed=0),
                      jax.random.PRNGKey(0))
    grads = _leaves(jax.tree_util.tree_map_with_path(
        lambda path, b, p: np.asarray(b) - hyp.weight_decay * _decayed(
            path, p), new.opt_state.momentum_buf, w["params"]))
    return ({k: float(v) for k, v in m.items()}, grads,
            _leaves(new.batch_stats))


@pytest.fixture(scope="module")
def jax_mesh_step():
    return _jax_mesh_step(2, 1)


@pytest.mark.parametrize("grid", ["data_grid", "model_grid"])
def test_parallel_step_matches_the_jax_mesh_step(grid, jax_mesh_step,
                                                 request):
    """Dropout off on both sides, the JAX package's BatchNorm variance in
    two passes (as SyncBN and one process compute it; test-side), one JAX
    mesh program (2 x 1) for both grids: the bounds that
    tests/test_torch_train.py holds one step to against JAX (loss 1e-5;
    gradients 3e-4 of each tensor's largest value, median 1e-4;
    statistics 1e-5)."""
    m, g, st = request.getfixturevalue(grid)["nodrop"]
    jm, jg, jst = jax_mesh_step
    for k in ("box", "obj", "cls", "total"):
        assert abs(m[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, m[k], jm[k])
    got = {k: v for k, v in _bridged({k: torch.from_numpy(v)
                                      for k, v in g.items()}).items()
           if not k.endswith("['pos_emb']")}
    want = {k: v for k, v in jg.items() if not k.endswith("['pos_emb']")}
    floor = 1e-3 * max(np.abs(v).max() for v in want.values())
    err = _tensor_errors(got, want, floor)
    assert max(err.values()) <= 3e-4, max(err.items(), key=lambda kv: kv[1])
    assert np.median(list(err.values())) <= 1e-4
    got = _bridged({k: torch.from_numpy(v) for k, v in st.items()},
                   stats=True)
    err = {k: float(np.abs(got[k] - jst[k]).max()) for k in jst}
    assert len(err) > 50 and max(err.values()) <= 1e-5, max(err.values())


@pytest.mark.parametrize("grid", ["data_grid", "model_grid"])
def test_parallel_step_equals_the_single_process_step(grid, request,
                                                      single_process):
    """fp32: loss within 1e-6 relative; gradients within 1e-4 of the
    largest gradient and BatchNorm running statistics within 1e-5 of each
    tensor's largest value (measured 2.6e-5 and 3.4e-6 on the data grid:
    the ranks' partial sums round differently from one process's, and
    this random-weight network amplifies rounding, tests/test_torch_train.
    py). float64: the same step to 1e-10 (measured 9e-14), so the fp32
    gap is rounding."""
    out = request.getfixturevalue(grid)
    assert sorted(out["fp32"][1]) == sorted(out["fp64"][1])
    e32 = W.errors(out["fp32"], single_process["fp32"])
    e64 = W.errors(out["fp64"], single_process["fp64"])
    assert e32["loss"] <= 1e-6, e32
    assert e32["grads"] <= 1e-4 and e32["stats"] <= 1e-5, e32
    for k, (got, want) in e32["comps"].items():
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    assert e64["loss"] <= 1e-12 and e64["grads"] <= 1e-10 \
        and e64["stats"] <= 1e-10, e64


def test_tensor_parallel_ranks_store_only_their_shards(model_grid):
    out = model_grid
    split = pm.tp_dims(W.mini_step()[0].model)
    assert len(split) == 3 * 8 * 10  # 3 stages x 8 layers x 10 tensors
    for i, n in enumerate(out["names"]):
        want = list(_full_shapes()[n])
        if n in split:
            want[split[n]] //= 2
        assert out["shapes"][n] == tuple(want), n
        assert out["opt_shapes"][i] == tuple(want), n
        assert out["ema_shapes"][n] == tuple(want), n


@functools.lru_cache(maxsize=None)
def _full_shapes():
    state = W.mini_step()[0]
    return {k: tuple(v.shape) for k, v in state.model.state_dict().items()}


def test_train_cli_on_the_data_grid(data_grid, ws):
    r = data_grid["cli"]
    run = Path(r["save_dir"])
    lines = (run / "results.txt").read_text().splitlines()
    assert len(lines) == 1 and "mAP50" in lines[0]  # rank 0 writes once
    assert r["seen"] == 6 and np.isfinite(r["map"])
    assert (run / "last" / "model.pt").is_file()


def test_tensor_parallel_checkpoint_resumes_in_one_process(model_grid, ws,
                                                           caplog):
    caplog.set_level("INFO")
    run = Path(model_grid["cli"]["save_dir"])
    sd = torch.load(run / "last" / "state.pt", weights_only=True)
    full = _full_shapes()
    assert {k: tuple(v.shape) for k, v in sd["model"].items()} == full
    assert {k: tuple(v.shape) for k, v in sd["ema"].items()} == full
    r = W.train_cli_run(ws["data"], str(ws["root"] / "resumed"),
                        ["--epochs", "2", "--resume", str(run / "last"),
                         "--noval"])
    assert f"resumed from {run / 'last'} at epoch 1" in caplog.text
    assert len((Path(r["save_dir"]) / "results.txt").read_text()
               .splitlines()) == 1
    args = test_cli.parse_args(["--data", "unused", "--cfg", W.CFG,
                                "--weights", str(run / "last" / "model.pt"),
                                "--img-size", "64", "--batch-size", "4",
                                "--fp32", "--device", "cpu"])
    args.data = ws["data"]
    assert test_cli.run(args)["seen"] == 6


def test_test_cli_data_parallel_matches_one_process_and_jax(ws, tmp_path,
                                                            monkeypatch):
    import yaml

    from multispectral_object_detection_tpu.cli import test_cli as jax_cli

    w = mini_weights(1)
    ckpt = write_jax_checkpoint(tmp_path / "jax", w["params"], w["stats"])
    dy = tmp_path / "data.yaml"
    dy.write_text(yaml.safe_dump(ws["data"]))
    argv = ["--data", str(dy), "--cfg", W.CFG, "--weights", ckpt,
            "--img-size", "64", "--batch-size", "4", "--fp32"]
    monkeypatch.setattr(pm, "spawn", functools.partial(
        pm.spawn, timeout=SPAWN_S, store_dir=str(tmp_path), threads=1))
    port = {}
    for n in (0, 2):
        args = test_cli.parse_args(argv + ["--device", "cpu",
                                           "--data-parallel", str(n)])
        port[n] = test_cli.run(args)
    jres = jax_cli.main(argv + ["--data-parallel", "2"])
    assert port[2]["seen"] == port[0]["seen"] == 6
    for k in ("mp", "mr", "map50", "map"):
        assert abs(port[2][k] - port[0][k]) <= 1e-6, k
        assert abs(port[2][k] - jres[k]) <= 1e-3, k


def test_data_parallel_guards(ws):
    base = ["--data", "unused", "--weights", "w.pt", "--device", "cpu"]
    for extra, msg in (
            (["--augment"], "--augment is single-device"),
            (["--int8"], "--int8 is single-device"),
            (["--weights", "a.pt", "b.pt"], "--data-parallel is single-"),
            (["--batch-size", "5"], "must be divisible by --data-parallel")):
        with pytest.raises(SystemExit, match=msg):
            test_cli.run(test_cli.parse_args(base + extra
                                             + ["--data-parallel", "2"]))
    with pytest.raises(SystemExit, match="--n-model 2 needs 2 ranks"):
        W.train_cli_run(ws["data"], str(ws["root"] / "g"),
                        ["--n-model", "2"])
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        pm.make_mesh(2, 1)
    assert pm.make_mesh().world == 1
