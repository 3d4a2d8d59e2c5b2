"""The fused bf16 MLP trunk's plain twins (kernels 5 and 6 of the program).

Written as the JAX package's ``ops/mlp_pallas.py`` kernels compute: the trunk packed
as (depth+1,256,256) bf16 weights and (depth,256) float32 biases, products
of bf16 operands summed in float32.  ``PRODUCT_DTYPE`` is the precision the
operands are rounded to before each product: bf16, as the configuration
states; the control sets float8 (e4m3) to show that the comparison fails a
lower precision.
"""

from __future__ import annotations

import torch

PRODUCT_DTYPE = torch.bfloat16
FP8_MAX = 448.0

WIDTH = 256
DEPTH = 8
SKIP = DEPTH // 2


def pack_trunk(weights, biases, din: int):
    """The trunk's layers, weights (out,in) and biases, packed as the JAX
    package's fused branch packs them: (wpack (depth+1,256,256),
    bpack (depth,256)), the pack holding (in,out), the first layer's rows
    padded to 256, the skip layer's hidden rows in its slot and its input
    rows last.  Built from differentiable ops, so the gradient of the packs
    reaches each layer's weight and bias."""
    pad = WIDTH - din
    ks = [w.t() for w in weights]
    mats = []
    for i, k in enumerate(ks):
        if i == 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        elif i == SKIP + 1:
            k = k[din:]
        mats.append(k)
    wx = torch.nn.functional.pad(ks[SKIP + 1][:din], (0, 0, 0, pad))
    return torch.stack(mats + [wx]), torch.stack(list(biases))


def _round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to PRODUCT_DTYPE (bf16 values pass unchanged)."""
    if PRODUCT_DTYPE == torch.bfloat16:
        return t.float()
    return t.float().clamp(-FP8_MAX, FP8_MAX).to(PRODUCT_DTYPE).float()


def _layer(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 h (N,k) times bf16 w (k,256): exact products, float32 sums."""
    return _round(h) @ _round(w)


def _forward_acts(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor):
    """x rounded to bf16, and every layer's bf16 post-ReLU activation."""
    din = x.shape[1]
    xb = x.to(torch.bfloat16)
    acts = []
    h = xb
    for i in range(DEPTH):
        y = _layer(h, wpack[i][:din] if i == 0 else wpack[i])
        if i == SKIP + 1:
            y = y + _layer(xb, wpack[DEPTH][:din])
        h = torch.relu(y + bpack[i]).to(torch.bfloat16)
        acts.append(h)
    return xb, acts


def trunk_fwd_ref(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of kernel 5, after ``_fwd_kernel``
    (dgmesh_tpu/ops/mlp_pallas.py:36-59): x (N,din) f32 → (N,256) f32."""
    return _forward_acts(x, wpack, bpack)[1][-1].float()


def trunk_bwd_ref(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor,
                  g: torch.Tensor):
    """Plain PyTorch twin of kernel 6, after ``_bwd_kernel``
    (dgmesh_tpu/ops/mlp_pallas.py:62-119), over all rows at once.

    Recomputes the bf16 activations, then walks back: gm = g where the
    layer's bf16 activation is > 0, else 0; gmb = bf16(gm);
    dW[i] = h_inᵀ·gmb, db[i] = Σ gm (the unrounded float32 gm), at the skip
    dW[depth] = xᵀ·gmb and dx += gmb·W[depth]ᵀ; g = gmb·W[i]ᵀ (float32).
    Returns dx (N,din), dW (9,256,256) and db (8,256), float32."""
    din = x.shape[1]
    xb, acts = _forward_acts(x, wpack, bpack)
    xp = torch.nn.functional.pad(xb, (0, WIDTH - din))
    dw = x.new_zeros((DEPTH + 1, WIDTH, WIDTH))
    db = x.new_zeros((DEPTH, WIDTH))
    dx = x.new_zeros((x.shape[0], WIDTH))
    for i in range(DEPTH - 1, -1, -1):
        gm = torch.where(acts[i] > 0, g, 0.0)
        gmb = gm.to(torch.bfloat16)
        h_in = xp if i == 0 else acts[i - 1]
        dw[i] = _layer(h_in.t(), gmb)
        db[i] = gm.sum(0)
        if i == SKIP + 1:
            dw[DEPTH] = _layer(xp.t(), gmb)
            dx = dx + _layer(gmb, wpack[DEPTH].t())
        g = _layer(gmb, wpack[i].t())
    dx = dx + g
    return dx[:, :din].contiguous(), dw, db


class FusedTrunk(torch.autograd.Function):
    """The fused trunk as one autograd Function: forward ``trunk_fwd_ref``,
    backward ``trunk_bwd_ref`` on the bf16-rounded weights."""

    @staticmethod
    def forward(ctx, x, wpack, bpack):
        wb = wpack.detach().to(torch.bfloat16)
        x, bpack = x.detach(), bpack.detach()
        ctx.save_for_backward(x, wb, bpack)
        return trunk_fwd_ref(x, wb, bpack)

    @staticmethod
    def backward(ctx, g):
        x, wb, bpack = ctx.saved_tensors
        return trunk_bwd_ref(x, wb, bpack, g.contiguous())
