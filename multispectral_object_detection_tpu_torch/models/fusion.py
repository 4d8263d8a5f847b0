"""Cross-Modality Fusion Transformer (CFT): the fusion stage of the paper.

Counterpart of ``CrossModalFusion`` in multispectral_object_detection_tpu/
models/fusion.py. Both modality maps are average-pooled
to an 8x8 grid, flattened and concatenated into 128 tokens of width C, given
a learned position embedding, run through L pre-LN transformer layers
(ops/cft_stack.fused_cft_stack, the CUDA kernels on the GPU), layer-normed,
split back into two 8x8 maps and bilinearly resized to the input size.

Parameters carry the reference GPT names (``pos_emb``,
``trans_blocks.{j}.ln_input/ln_output``, ``sa.que_proj/key_proj/val_proj/
out_proj``, ``mlp.0``, ``mlp.2``, ``ln_f``), so reference state dicts load as
they are. ``pack`` stacks the layer weights once into the kernels' (L, ...)
layout (weights as (in, out)) and drops the per-layer modules; an unpacked
module stacks them at every call.

In training mode (``module.train()``) the stack runs ``cft_stack_train``
on weights stacked from ``trans_blocks`` with autograd through the stack,
with dropout (p = 0.1) on the tokens + position embedding, on the attention
probabilities and on both residual branches, as the JAX module trains. The
masks come from the ``seed`` that the forward is given: one generator per
(layer, slot), so a recomputed forward (``torch.utils.checkpoint``) draws
the same masks. A packed module does not train.

On a parallel mesh (``mesh``, set by parallel/mesh.parallelize) each rank
draws the masks of the global batch and keeps its rows, so N ranks train
as one process; with tensor parallelism its ``trans_blocks`` hold this
rank's heads and MLP columns, and the stack sums the split products over
the model group.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import adaptive_avg_pool_2d, bilinear_resize_2d
from ..ops.cft_stack import cft_stack_train, fused_cft_stack

_STACKED = ("wqkv", "bqkv", "wp", "bp", "w1", "b1", "w2", "b2", "ln1", "ln2")
_MASK64 = (1 << 64) - 1
DROPOUT = 0.1  # embedding, attention and residual dropout in training


def mix_seed(*values: int) -> int:
    """A 63-bit seed from integers (splitmix64 finalisers): the key of one
    dropout mask, from the step's seed and the mask's place."""
    h = 0x9E3779B97F4A7C15
    for v in values:
        h = ((h ^ (v & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


def dropout_mask(y: torch.Tensor, p: float, seed: int, full_shape=None,
                 part=()) -> torch.Tensor:
    """y with dropout at rate p: kept values scaled by 1/(1-p), the mask
    drawn from a generator seeded with ``seed`` on y's device. A rank of a
    parallel step draws the mask of the whole tensor, ``full_shape``, and
    keeps ``part`` (a tuple of slices: its rows, its heads)."""
    g = torch.Generator(device=y.device)
    g.manual_seed(seed)
    keep = torch.rand(full_shape or y.shape, generator=g,
                      device=y.device) < 1.0 - p
    if part:
        keep = keep[part]
    return torch.where(keep, y / (1.0 - p), torch.zeros_like(y))


class SelfAttention(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.que_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model)
        self.val_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)


class TransformerBlock(nn.Module):
    """Weights of one pre-LN layer (reference myTransformerBlock)."""

    def __init__(self, d_model: int, block_exp: int = 4):
        super().__init__()
        self.ln_input = nn.LayerNorm(d_model)
        self.ln_output = nn.LayerNorm(d_model)
        self.sa = SelfAttention(d_model)
        self.mlp = nn.Sequential(nn.Linear(d_model, block_exp * d_model),
                                 nn.GELU(),
                                 nn.Linear(block_exp * d_model, d_model))


def _stack_layers(blocks) -> dict:
    """Per-layer torch Linear/LayerNorm weights -> the stacked layout."""
    def st(f):
        return torch.stack([f(b) for b in blocks])

    def ln(m):
        return torch.stack([m.weight, m.bias])

    return {
        "wqkv": st(lambda b: torch.cat([b.sa.que_proj.weight,
                                        b.sa.key_proj.weight,
                                        b.sa.val_proj.weight]).t()),
        "bqkv": st(lambda b: torch.cat([b.sa.que_proj.bias, b.sa.key_proj.bias,
                                        b.sa.val_proj.bias])),
        "wp": st(lambda b: b.sa.out_proj.weight.t()),
        "bp": st(lambda b: b.sa.out_proj.bias),
        "w1": st(lambda b: b.mlp[0].weight.t()),
        "b1": st(lambda b: b.mlp[0].bias),
        "w2": st(lambda b: b.mlp[2].weight.t()),
        "b2": st(lambda b: b.mlp[2].bias),
        "ln1": st(lambda b: ln(b.ln_input)),
        "ln2": st(lambda b: ln(b.ln_output)),
    }


class CrossModalFusion(nn.Module):
    """The CFT `GPT` stage: (rgb, ir) NCHW maps of equal shape in, a pair of
    maps of the same shape out."""

    def __init__(self, d_model: int, num_heads: int = 8, block_exp: int = 4,
                 n_layer: int = 8, vert_anchors: int = 8,
                 horz_anchors: int = 8):
        super().__init__()
        self.d_model = d_model
        self.embd_drop = self.attn_drop = self.resid_drop = DROPOUT
        self.num_heads = num_heads
        self.grid = (vert_anchors, horz_anchors)
        self.pos_emb = nn.Parameter(
            torch.zeros(1, 2 * vert_anchors * horz_anchors, d_model))
        self.trans_blocks = nn.Sequential(*(TransformerBlock(d_model, block_exp)
                                            for _ in range(n_layer)))
        self.ln_f = nn.LayerNorm(d_model)
        # the stack implementation; a caller may swap in its plain twin
        self.stack_fn = fused_cft_stack
        self.mesh = None  # parallel/mesh.Mesh of a parallel train step

    @property
    def packed(self) -> bool:
        return self.trans_blocks is None

    @torch.no_grad()
    def pack(self) -> None:
        """Stack the layer weights once into the kernels' layout as buffers
        (their dtype follows the parameters'; models.model.
        cast_inference_params keeps ``ln*`` in fp32) and drop the per-layer
        modules."""
        if self.packed:
            return
        for name, t in _stack_layers(self.trans_blocks).items():
            self.register_buffer(name, t.contiguous())
        self.trans_blocks = None

    def stacked_weights(self, dtype) -> list:
        """The stack's ten weight arguments: weights and biases in ``dtype``,
        LayerNorm parameters in fp32."""
        if self.packed:
            w = {k: getattr(self, k) for k in _STACKED}
        else:
            w = _stack_layers(self.trans_blocks)
        return [w[k].to(torch.float32 if k.startswith("ln") else dtype)
                .contiguous() for k in _STACKED]

    def forward(self, xs, seed: int = 0):
        """``seed`` keys the dropout masks in training mode (the model
        passes one per stage and step); unused in eval mode."""
        rgb, ir = xs[0], xs[1]
        b, c, h, w = rgb.shape
        dt = rgb.dtype
        gv, gh = self.grid
        tokens = torch.cat([adaptive_avg_pool_2d(rgb, (gv, gh)).flatten(2),
                            adaptive_avg_pool_2d(ir, (gv, gh)).flatten(2)],
                           dim=2).transpose(1, 2)               # (B, 128, C)
        x = (tokens + self.pos_emb.to(dt)).contiguous()
        if self.training:
            x = self._train_stack(x, seed)
        else:
            x = self.stack_fn(x, *self.stacked_weights(dt),
                              num_heads=self.num_heads)
        x = F.layer_norm(x.float(), (c,), self.ln_f.weight.float(),
                         self.ln_f.bias.float(), self.ln_f.eps).to(dt)
        n = gv * gh
        rgb_t = x[:, :n].transpose(1, 2).reshape(b, c, gv, gh)
        ir_t = x[:, n:].transpose(1, 2).reshape(b, c, gv, gh)
        return tuple(bilinear_resize_2d(t, (h, w)).contiguous(
            memory_format=torch.channels_last) for t in (rgb_t, ir_t))

    def _train_stack(self, x, seed: int):
        if self.packed:
            raise RuntimeError("a packed (fused) CFT stage cannot train: "
                               "build the model unfused")
        rates = (self.attn_drop, self.resid_drop, self.resid_drop)
        mesh = self.mesh
        b = x.shape[0]
        rows, full, heads, tp = (), {}, (), None
        if mesh is not None and mesh.world > 1:
            from ..parallel.mesh import copy_to_model, reduce_from_model

            n, r = b * mesh.n_data, mesh.data_rank
            rows = (slice(r * b, (r + 1) * b),)
            h = self.num_heads // mesh.n_model
            heads = (slice(mesh.model_rank * h, (mesh.model_rank + 1) * h),)
            full = {0: (n, self.num_heads) + (x.shape[1],) * 2,
                    1: (n,) + x.shape[1:], 2: (n,) + x.shape[1:]}
            if mesh.n_model > 1:
                g = mesh.model_group
                tp = (lambda t: copy_to_model(t, g),
                      lambda t: reduce_from_model(t, g))

        def drop(t, layer: int, slot: int):
            p = rates[slot]
            if p <= 0:
                return t
            return dropout_mask(t, p, mix_seed(seed, 1 + layer * 3 + slot),
                                full.get(slot),
                                rows + heads if slot == 0 else rows)

        if self.embd_drop > 0:
            x = dropout_mask(x, self.embd_drop, mix_seed(seed, 0),
                             full.get(1), rows)
        w = _stack_layers(self.trans_blocks)
        return cft_stack_train(x, *(w[k] for k in _STACKED),
                               num_heads=self.num_heads, dropout=drop, tp=tp)
