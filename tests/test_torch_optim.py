"""PyTorch port, the training recipe's optimizer against the JAX package:
the warmup schedules over micro-batches 0-1200 (lr, bias lr and momentum
within 1e-6, the accumulation equal), SGD and Adam over 40 micro-batches
at batch 4 (the accumulation ramps from 1 to 16 and steps are emitted on
the same micro-batches; parameters within 1e-6), the EMA within 1e-6, and
the parameter count of each role on the mini model equal to JAX's
``param_role`` (its stacked LayerNorm leaves split into their scale and
bias halves). Both sides compute the schedule in float32 and the updates
in fp32 with the same formulas; 1e-6 is a few ulps of the values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from multispectral_object_detection_tpu.train import optim as jopt
from multispectral_object_detection_tpu_torch.models.model import (
    build_model)
from multispectral_object_detection_tpu_torch.train import optim
from tests._torch_port import mini_weights, share_torch_threads  # noqa: F401

TOL = 1e-6


@pytest.mark.parametrize("linear", [False, True])
def test_warmup_schedules_match_jax(linear):
    hyp = optim.OptHyp()
    jhyp = jopt.OptHyp()
    sched = optim.warmup_schedules(hyp, 100, 5, 4, linear_lr=linear)
    jsched = jax.jit(jax.vmap(jopt.warmup_schedules(jhyp, 100, 5, 4,
                                                    linear_lr=linear)))
    ni = np.arange(1201)
    want = [np.asarray(v) for v in jsched(jnp.asarray(ni, jnp.int32))]
    got = np.array([sched(int(i)) for i in ni], dtype=np.float64)
    for j, name in enumerate(("lr", "bias lr", "momentum")):
        np.testing.assert_allclose(got[:, j], want[j], rtol=0, atol=TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[:, 3].astype(int), want[3])
    assert want[3].min() == 1 and want[3].max() == 16
    if linear:  # JAX divides by zero here (nan rates); the port refuses
        with pytest.raises(ValueError, match="2 epochs"):
            optim.warmup_schedules(hyp, 100, 1, 4, linear_lr=True)


class _Tiny(nn.Module):
    """One parameter of each role: conv and linear kernels, BatchNorm
    scale and bias, LayerNorm weight and bias, a frozen pos_emb."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, bias=False)
        self.bn = nn.BatchNorm2d(4)
        self.fc = nn.Linear(4, 5)
        self.ln = nn.LayerNorm(5)
        self.pos_emb = nn.Parameter(torch.zeros(1, 2, 5))


def _jax_updates(tx, params, grads_seq):
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g in grads_seq:
        upd, state = update(g, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        out.append((params, bool(state.emitted)))
    return out


@pytest.mark.parametrize("adam", [False, True])
def test_sgd_and_adam_over_40_micro_batches_match_jax(adam):
    torch.manual_seed(0)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    hyp = optim.OptHyp(adam=adam)
    # batch 4: nominal accumulation 16; a warmup of 30 micro-batches
    opt = optim.build_optimizer(model, hyp, 10, 4, accumulate=16,
                                total_batch_size=4, warmup_min_iters=20)
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in model.named_parameters()}
    pos0 = model.pos_emb.detach().clone()
    roles = {n: opt.roles[n] for n in params}
    tx = (jopt.yolo_adam if adam else jopt.yolo_sgd)(
        roles, jopt.OptHyp(adam=adam), 10, 4, 16, 4, warmup_min_iters=20)
    rng = np.random.default_rng(1)
    grads_seq = [{n: rng.normal(size=p.shape).astype(np.float32)
                  for n, p in params.items()} for _ in range(40)]
    want = _jax_updates(tx, params, grads_seq)
    emitted = []
    for (wp, wemit), g in zip(want, grads_seq):
        emitted.append(opt.update([torch.from_numpy(g[n])
                                   for n in opt.names]))
        assert emitted[-1] == wemit
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(wp[n]),
                                       rtol=TOL, atol=TOL, err_msg=n)
    assert 3 < sum(emitted) < 40  # the accumulation ramped
    assert torch.equal(model.pos_emb.detach(), pos0)  # frozen
    assert opt.gradient_steps == sum(emitted) and opt.ni == 40


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    src, ema = _Tiny(), _Tiny()
    for m in (src, ema):
        with torch.no_grad():
            for t in optim.ema_tensors(m):
                t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                    np.float32)))
    e = {k: jnp.asarray(v.numpy()) for k, v in ema.state_dict().items()
         if v.is_floating_point()}
    for updates in (1, 2, 500, 5000):
        new = {k: v.numpy() for k, v in src.state_dict().items()
               if v.is_floating_point()}
        e = jopt.ema_update(e, new, jnp.asarray(updates))
        optim.ema_update(ema, src, updates)
        for k, v in ema.state_dict().items():
            if v.is_floating_point():
                np.testing.assert_allclose(v.numpy(), np.asarray(e[k]),
                                           rtol=TOL, atol=TOL, err_msg=k)
        with torch.no_grad():
            for t in optim.ema_tensors(src):
                t.add_(1.0)
    assert optim.ema_decay(5000) == pytest.approx(
        float(jopt.ema_decay_schedule(jnp.asarray(5000))), abs=1e-7)


def test_role_counts_match_jax_param_role():
    w = mini_weights(0)
    model = build_model(w["cfg"])
    roles = optim.param_roles(model)
    got = {r: 0 for r in optim.ROLES}
    named = dict(model.named_parameters())
    for n, r in roles.items():
        got[r] += named[n].numel()
    want = {r: 0 for r in optim.ROLES}
    for path, leaf in jax.tree_util.tree_leaves_with_path(w["params"]):
        r = jopt.param_role(path, leaf)
        if r == "ln_stacked":  # [scale | bias] halves: decayed | bias
            want["kernel"] += leaf.size // 2
            want["bias"] += leaf.size // 2
        else:
            want[r] += leaf.size
    assert got == want
    assert got["frozen"] == sum(named[n].numel() for n in named
                                if n.endswith("pos_emb")) > 0
