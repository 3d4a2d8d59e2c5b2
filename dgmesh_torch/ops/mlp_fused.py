"""The fused bf16 MLP trunk: the CUDA kernels' wrappers and their plain twins.

Counterpart of dgmesh_tpu/ops/mlp_pallas.py.  The whole depth-8 × 256 ReLU
trunk of a row runs in one kernel: ``trunk_fwd`` launches ``csrc/mlp_fwd.cu``
(kernel 5) and ``trunk_bwd`` launches ``csrc/mlp_bwd.cu`` (kernel 6, its
backward) for a CUDA tensor; each runs its plain PyTorch twin
(``trunk_fwd_ref``, ``trunk_bwd_ref``) only for a CPU tensor; there is no
fallback.  ``FusedTrunk`` pairs the two as one ``torch.autograd.Function``
that saves only the trunk's input and its packed parameters.

Layout, as in JAX: every layer is a (256,256) product.  The input x (N,din),
din <= 256, acts as if zero-padded to 256 lanes; ``wpack`` (depth+1,256,256)
holds each layer's (in,out) kernel, with W0's rows padded to 256, the skip
layer's h-part at index skip+1 and its x-part (padded) at index depth;
``bpack`` (depth,256).  Arithmetic: bf16 operands (x and the weights rounded
to nearest even), exact products summed in float32, a float32 bias, ReLU,
and the result rounded to bf16 after every layer; the output is that last
bf16 activation as float32.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

WIDTH = 256
DEPTH = 8
SKIP = DEPTH // 2


def pack_trunk(trunk, din: int):
    """The trunk's ``nn.Linear``s → (wpack (depth+1,256,256), bpack (depth,256)),
    as JAX's fused branch packs them (dgmesh_tpu/models/mlp.py:71-83).

    Built from differentiable ops (transpose, pad, slice, stack), so the
    gradient of ``wpack``/``bpack`` reaches each layer's weight and bias as
    JAX's autodiff of the same stack/pad/slice does.  ``nn.Linear`` keeps
    (out,in); the pack holds (in,out)."""
    layers = list(trunk.layers)
    skip = len(layers) // 2
    pad = WIDTH - din
    ks = [layer.weight.t() for layer in layers]                  # (in,out)
    mats = []
    for i, k in enumerate(ks):
        if i == 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        elif i == skip + 1:
            k = k[din:]
        mats.append(k)
    wx = torch.nn.functional.pad(ks[skip + 1][:din], (0, 0, 0, pad))
    return torch.stack(mats + [wx]), torch.stack([layer.bias for layer in layers])


def _check(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor, what: str) -> None:
    """Raise unless x (N,din<=256) f32, wpack (9,256,256) bf16, bpack (8,256)
    f32 lie on one device (the CPU or a GPU)."""
    if x.dim() != 2 or not 0 < x.shape[1] <= WIDTH:
        raise ValueError(f"{what}: x must be (N, din<=256), got {tuple(x.shape)}")
    if tuple(wpack.shape) != (DEPTH + 1, WIDTH, WIDTH) or tuple(bpack.shape) != (DEPTH, WIDTH):
        raise ValueError(f"{what}: wpack must be (9,256,256) and bpack (8,256), got "
                         f"{tuple(wpack.shape)} and {tuple(bpack.shape)}")
    if x.dtype != torch.float32 or wpack.dtype != torch.bfloat16 or bpack.dtype != torch.float32:
        raise TypeError(f"{what}: x f32, wpack bf16, bpack f32 expected, got "
                        f"{x.dtype}, {wpack.dtype}, {bpack.dtype}")
    if x.device.type not in ("cpu", "cuda") or len({x.device, wpack.device, bpack.device}) != 1:
        raise ValueError(f"{what}: x, wpack and bpack must share one cpu or cuda device")


def _check_derived(packed, shape, wpack, what: str) -> None:
    """Raise unless ``packed`` can be a layout of wpack (``transpose_pack``,
    ``stage_pack``) of this shape."""
    if (tuple(packed.shape) != shape or packed.dtype != wpack.dtype
            or packed.device != wpack.device or not packed.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous {shape} {wpack.dtype} on "
                         f"{wpack.device}, got {tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")


def _layer(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 h (N,k) times bf16 w (k,256): exact products, float32 sums."""
    return h.float() @ w.float()


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


def _launch(name: str, fn_name: str, argtypes, *args) -> None:
    fn = getattr(cuda_build.library(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    cuda_build.check(fn(*args), fn_name)


def trunk_fwd(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor,
              wpacks: torch.Tensor | None = None) -> torch.Tensor:
    """x (N,din) f32, wpack (9,256,256) bf16, bpack (8,256) f32 → (N,256) f32.

    A CUDA tensor goes to kernel 5 (``trunk_fwd.launches`` counts each
    launch), which reads the weights from the stage pack ``wpacks``
    (``stage_pack(transpose_pack(wpack))``, made here when not given); a CPU
    tensor takes the plain twin."""
    _check(x, wpack, bpack, "trunk_fwd")
    if wpacks is not None:
        _check_derived(wpacks, STAGE_PACK_SHAPE, wpack, "trunk_fwd: wpacks")
    if x.device.type == "cpu":
        return trunk_fwd_ref(x, wpack, bpack)
    x, bpack = x.contiguous(), bpack.contiguous()
    wpacks = stage_pack(transpose_pack(wpack)) if wpacks is None else wpacks
    n, din = x.shape
    out = torch.empty((n, WIDTH), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _launch("mlp_fwd", "mlp_fwd_launch",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
                x.data_ptr(), wpacks.data_ptr(), bpack.data_ptr(), out.data_ptr(),
                n, din, stream)
    trunk_fwd.launches += 1
    return out


trunk_fwd.launches = 0

# rows per CTA of the backward's row pass (csrc/mlp_bwd.cu; it fixes the
# workspace's size)
BWD_ROWS = 128
BWD_BUFFERS = 2 * DEPTH         # bf16 x, activations 0..6, the 8 masked gradients


def transpose_pack(wpack: torch.Tensor) -> torch.Tensor:
    """Each (256,256) matrix of the pack transposed, contiguous: kernel 6's
    row pass reads the forward's W[k][n] from it as rows n, so that the
    forward's and the backward's weight stages are both K-major slices."""
    return wpack.transpose(1, 2).contiguous()


STAGE_K = 64                                            # reduction steps of a weight stage
STAGE_PACK_SHAPE = ((DEPTH + 1) * WIDTH // STAGE_K, WIDTH, STAGE_K)


def stage_pack(wpackt: torch.Tensor) -> torch.Tensor:
    """The forward's weight stages as kernel 5 holds them in shared memory,
    from the transposed pack: (36,256,64) bf16, stage 4·m + k being rows n,
    columns 64k..64k+63 of W[m]ᵀ, with the 16-byte granule g of row n
    stored at granule g ^ (n % 8) (the 128-byte swizzle of the kernel's
    K-major tiles), so that one contiguous copy fills a stage."""
    m = wpackt.shape[0]
    st = wpackt.reshape(m, WIDTH, WIDTH // STAGE_K, STAGE_K).transpose(1, 2)   # (m,4,n,64)
    st = st.reshape(m * WIDTH // STAGE_K, WIDTH, STAGE_K // 8, 8)               # granules
    n = torch.arange(WIDTH, device=wpackt.device)[:, None]
    src = torch.arange(STAGE_K // 8, device=wpackt.device)[None, :] ^ (n % 8)  # granule at g
    return st[:, n, src].reshape(STAGE_PACK_SHAPE).contiguous()


def wgrad_splits(din: int, sms: int) -> int:
    """Row splits of kernel 6's weight-gradient pass at input width din on
    a card of sms SMs: as many as fit one wave beside its jobs, at least 1.
    Its jobs (csrc/mlp_bwd.cu's wgrad_jobs) are the 128-row dW tiles of the
    9 matrices, two each but one of dW[0] and dW[8] at din <= 128 (x's lanes
    past din are zero): 16 or 18."""
    jobs = 2 * (DEPTH - 1) + 2 * (1 if din <= 128 else 2)
    return max(1, sms // jobs)


def _bwd_buffers(n: int, din: int, dev: torch.device):
    """Kernel 6's scratch for n rows at input width din on the CUDA device
    dev: the workspace (16, rows padded to 128, 256) bf16, the row blocks'
    bias-gradient sums and the weight-gradient pass's partials (splits, 9,
    256, 256), float32."""
    blocks = -(-n // BWD_ROWS)
    splits = wgrad_splits(din, torch.cuda.get_device_properties(dev).multi_processor_count)
    return (torch.empty((BWD_BUFFERS, blocks * BWD_ROWS, WIDTH), dtype=torch.bfloat16, device=dev),
            torch.empty((blocks, DEPTH, WIDTH), dtype=torch.float32, device=dev),
            torch.empty((splits, DEPTH + 1, WIDTH, WIDTH), dtype=torch.float32, device=dev))


def _bwd_rows(x, wpack, wpackt, bpack, g, dx, ws, db_part) -> None:
    """Kernel 6's row pass on the current stream: dx, the workspace and the
    row blocks' bias-gradient sums."""
    n, din = x.shape
    _launch("mlp_bwd", "mlp_bwd_rows_launch",
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
            x.data_ptr(), wpack.data_ptr(), wpackt.data_ptr(), bpack.data_ptr(), g.data_ptr(),
            dx.data_ptr(), ws.data_ptr(), db_part.data_ptr(), n, din,
            torch.cuda.current_stream(x.device).cuda_stream)


def _bwd_wgrad(ws, db_part, dw_part, dw, db, din: int) -> None:
    """Kernel 6's weight-gradient pass and both reductions, on the current
    stream: dW and db from the row pass's workspace and sums at input width
    din, over as many row splits as dw_part holds."""
    _launch("mlp_bwd", "mlp_bwd_wgrad_launch",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            ws.data_ptr(), db_part.data_ptr(), dw_part.data_ptr(), dw.data_ptr(), db.data_ptr(),
            db_part.shape[0], dw_part.shape[0], din,
            torch.cuda.current_stream(ws.device).cuda_stream)


def trunk_bwd(x: torch.Tensor, wpack: torch.Tensor, bpack: torch.Tensor,
              g: torch.Tensor, wpackt: torch.Tensor | None = None):
    """x (N,din) f32, wpack bf16, bpack f32, g (N,256) f32 → dx (N,din),
    dW (9,256,256), db (8,256), all f32 (dW and db summed over the rows).

    A CUDA tensor goes to kernel 6, its row pass and then its weight-gradient
    pass (``trunk_bwd.launches`` counts each call that launches it), with
    the transposed pack ``wpackt`` as in ``trunk_fwd``; a CPU tensor takes
    the plain twin."""
    _check(x, wpack, bpack, "trunk_bwd")
    if wpackt is not None:
        _check_derived(wpackt, tuple(wpack.shape), wpack, "trunk_bwd: wpackt")
    if tuple(g.shape) != (x.shape[0], WIDTH) or g.dtype != torch.float32:
        raise ValueError(f"trunk_bwd: g must be ({x.shape[0]},256) float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if x.device.type == "cpu":
        return trunk_bwd_ref(x, wpack, bpack, g)
    x, wpack, bpack, g = x.contiguous(), wpack.contiguous(), bpack.contiguous(), g.contiguous()
    n, din = x.shape
    dev = x.device
    dx = torch.empty((n, din), dtype=torch.float32, device=dev)
    dw = torch.empty((DEPTH + 1, WIDTH, WIDTH), dtype=torch.float32, device=dev)
    db = torch.empty((DEPTH, WIDTH), dtype=torch.float32, device=dev)
    if n == 0:
        return dx, dw.zero_(), db.zero_()
    ws, db_part, dw_part = _bwd_buffers(n, din, dev)
    with torch.cuda.device(dev):
        _bwd_rows(x, wpack, transpose_pack(wpack) if wpackt is None else wpackt, bpack, g, dx,
                  ws, db_part)
        _bwd_wgrad(ws, db_part, dw_part, dw, db, din)
    trunk_bwd.launches += 1
    return dx, dw, db


trunk_bwd.launches = 0


class FusedTrunk(torch.autograd.Function):
    """Forward kernel 5, backward kernel 6.  Transposes the bf16 weights
    once: kernel 5 reads them as the stage pack made from that, kernel 6 as
    the transposed pack itself.  Saves only x, the bf16 weights, their
    transposed pack and the biases, and recomputes the activations in the
    backward, as JAX's
    ``fused_trunk`` custom_vjp does (dgmesh_tpu/ops/mlp_pallas.py:132-215).
    wpack's gradient comes back in float32, like the parameters it is
    packed from."""

    @staticmethod
    def forward(ctx, x, wpack, bpack):
        wb = wpack.detach().to(torch.bfloat16)
        wt = transpose_pack(wb)
        x, bpack = x.detach(), bpack.detach()
        ctx.save_for_backward(x, wb, wt, bpack)
        return trunk_fwd(x, wb, bpack, stage_pack(wt))

    @staticmethod
    def backward(ctx, g):
        x, wb, wt, bpack = ctx.saved_tensors
        dx, dw, db = trunk_bwd(x, wb, bpack, g.contiguous(), wt)
        return dx, dw, db
