"""The multi-device layer: a 1-D mesh of ranks over ``torch.distributed``,
the state's sharding, a launcher, and collectives that differentiate.

Counterpart of dgmesh_tpu/parallel/sharding.py (``make_mesh``,
``state_shardings``, ``shard_state``) and of what ``jax.shard_map`` gives
the sharded modules there: the collectives and their transposes.  Each rank
is a process; ``spawn`` starts n of them and gathers what each returns.

Sharding (``state_shardings``' rule): every per-Gaussian leaf (the
parameters and their Adam moments except the scalar ``density_thres``, and
the statistics ``alive``, ``max_radii2d``, ``xyz_grad_accum``, ``denom``) is
split on axis 0 into n equal blocks of rows, rank r holding block r; every
other leaf (the nets, their optimizer state, the scene centre and scale,
the counts) is replicated.

Backend and device are explicit (``DeviceMesh``): ``gloo`` on the CPU, or
with CUDA tensors for ranks that share one card; ``nccl`` for one card a
rank (two ranks on one card raise: NCCL refuses them).  Gloo's own CUDA
paths are not used: on an H100 with torch 2.11 a gloo collective given CUDA
tensors killed both ranks (a TCP write of a device pointer, "Bad address"),
which no exception reports, so nothing can probe them.  Every collective of
a gloo mesh on CUDA tensors therefore copies its operands through the host,
in one place, ``_host_staged``, which counts them in
``DeviceMesh.host_copies``.

Gradient convention.  A replicated tensor's gradient on a rank is that
rank's part of it: what its own computation contributed.  The true gradient
is the sum over the ranks.  So:
  * ``all_gather`` (sharded → replicated) transposes to ``psum_scatter``
    (sum); ``psum_scatter`` to ``all_gather``; ``all_to_all`` to itself;
    ``ppermute`` to the reverse ``ppermute``; ``psum`` to ``psum``;
    ``pmin``/``pmax`` carry no gradient;
  * a loss that every rank computes in full is seeded with 1/n on each rank
    (``replicated_backward_scale``), or it would count n times;
  * a replicated parameter's gradient (the nets, ``density_thres``) is
    summed over the ranks (``psum``) before its optimizer step.
"""

from __future__ import annotations

import io
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.gaussians import GaussianParams, GaussianStats
from ..train.state import TrainState

BACKENDS = ("gloo", "nccl")
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "send_recv")
ROW_STATS = ("alive", "max_radii2d", "xyz_grad_accum", "denom")


class DeviceMesh:
    """One rank's view of the 1-D mesh: its rank, the world size, the process
    group, the backend and the rank's device.

    ``host_staged`` names the collectives whose operands go through the host
    (every one, for gloo on CUDA tensors); ``host_copies`` counts the
    tensors copied so; with ``timing`` on, each collective is bracketed by
    synchronisations and its wall time added to ``collective_ms``."""

    def __init__(self, rank: int, world: int, backend: str, device: torch.device,
                 group=None):
        self.rank, self.world = rank, world
        self.backend, self.device, self.group = backend, torch.device(device), group
        self.host_staged: set = set()
        self.host_copies = 0
        self.timing = False
        self.collective_ms = 0.0
        self.collective_calls = 0


def _check_placement(n: int, backend: str, device: str) -> None:
    """Raise unless ``backend`` can put n ranks on ``device``.  ``device`` is
    ``"cpu"``, ``"cuda"`` (rank r on card r) or ``"cuda:K"`` (every rank on
    card K)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices only; use gloo on the CPU")
        return
    if dev.type != "cuda":
        raise ValueError(f"ranks run on cpu or cuda, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' explicitly")
    cards = torch.cuda.device_count()
    if dev.index is None and n > cards:
        raise ValueError(f"device 'cuda' puts rank r on card r: {n} ranks, {cards} cards")
    if dev.index is not None and dev.index >= cards:
        raise ValueError(f"no card {dev.index}: {cards} cards")
    if backend == "nccl" and dev.index is not None and n > 1:
        raise ValueError(f"nccl cannot put {n} ranks on one card ({device}); use gloo with "
                         "CUDA tensors, or device='cuda' for one card a rank")


def rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def init_mesh(rank: int, world: int, backend: str, device: str, init_method: str) -> DeviceMesh:
    """Join the process group as ``rank`` of ``world`` and make the mesh."""
    _check_placement(world, backend, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kw)
    mesh = DeviceMesh(rank, world, backend, dev, dist.group.WORLD)
    if backend == "gloo" and dev.type == "cuda":
        mesh.host_staged = set(OPS)     # see the module docstring
    return mesh


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# --- the raw collectives ------------------------------------------------------

def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of a type every backend carries (bool as uint8,
    complex as its real pairs)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    elif x.is_complex():
        x = torch.view_as_real(x)
    return x.contiguous()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return y.bool()
    if like.is_complex():
        return torch.view_as_complex(y)
    return y


def _host_staged(mesh: DeviceMesh, name: str, run: Callable, out: torch.Tensor,
                 *ins: torch.Tensor) -> None:
    """Run ``run(out, *ins)``; where gloo does not take CUDA tensors for the
    collective ``name``, through host copies of the operands (counted)."""
    t0 = None
    if mesh.timing:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
    if name in mesh.host_staged and out.device.type == "cuda":
        h_out = out.cpu()
        run(h_out, *[x.cpu() for x in ins])
        out.copy_(h_out)
        mesh.host_copies += 1 + len(ins)
    else:
        run(out, *ins)
    if t0 is not None:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.collective_ms += (time.perf_counter() - t0) * 1e3
        mesh.collective_calls += 1


def _all_reduce(mesh: DeviceMesh, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if mesh.world == 1:
        return x.clone()
    w = _wire(x).clone()
    _host_staged(mesh, "all_reduce", lambda o: dist.all_reduce(o, op=op, group=mesh.group), w)
    return _unwire(w, x)


def _all_gather(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.world == 1:
        return x.clone()
    w = _wire(x)
    out = w.new_empty((mesh.world * w.shape[0],) + w.shape[1:])
    _host_staged(mesh, "all_gather",
                 lambda o, i: dist.all_gather_into_tensor(o, i, group=mesh.group), out, w)
    return _unwire(out, x)


def _reduce_scatter(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.world == 1:
        return x.clone()
    if x.shape[0] % mesh.world:
        raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split over {mesh.world} ranks")
    w = _wire(x)
    out = w.new_empty((w.shape[0] // mesh.world,) + w.shape[1:])
    _host_staged(mesh, "reduce_scatter",
                 lambda o, i: dist.reduce_scatter_tensor(o, i, group=mesh.group), out, w)
    return _unwire(out, x)


def _all_to_all(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.world == 1:
        return x.clone()
    if x.shape[0] % mesh.world:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over {mesh.world} ranks")
    w = _wire(x)
    out = torch.empty_like(w)
    _host_staged(mesh, "all_to_all",
                 lambda o, i: dist.all_to_all_single(o, i, group=mesh.group), out, w)
    return _unwire(out, x)


def _send_recv(mesh: DeviceMesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rank r sends x to rank (r + shift) % n and returns what rank
    (r − shift) % n sent."""
    n = mesh.world
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (mesh.rank + shift) % n, group=mesh.group),
           dist.P2POp(dist.irecv, out, (mesh.rank - shift) % n, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ppermute(mesh: DeviceMesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    if mesh.world == 1 or shift % mesh.world == 0:
        return x.clone()
    w = _wire(x)
    out = torch.empty_like(w)
    _host_staged(mesh, "send_recv", lambda o, i: o.copy_(_send_recv(mesh, i, shift)), out, w)
    return _unwire(out, x)


# --- differentiable collectives (the transposes of shard_map) -----------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.mesh, g.contiguous()), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, g.contiguous()), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g.contiguous()), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return _ppermute(mesh, x, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(ctx.mesh, g.contiguous(), -ctx.shift), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g.contiguous()), None


def all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The ranks' x (m,…) concatenated in rank order, (n·m,…) on every rank."""
    return _AllGather.apply(x, mesh) if x.requires_grad else _all_gather(mesh, x)


def psum_scatter(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Block r (rows r·m/n …) of the sum over the ranks of x (m,…), on rank r."""
    return _PsumScatter.apply(x, mesh) if x.requires_grad else _reduce_scatter(mesh, x)


def all_to_all(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """x (n·m,…) in n blocks: block j goes to rank j; block i of the result
    came from rank i."""
    return _AllToAll.apply(x, mesh) if x.requires_grad else _all_to_all(mesh, x)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, shift: int) -> torch.Tensor:
    """Rank r's x goes to rank (r + shift) mod n."""
    return _Ppermute.apply(x, mesh, shift) if x.requires_grad else _ppermute(mesh, x, shift)


def psum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of x over the ranks, on every rank."""
    return _Psum.apply(x, mesh) if x.requires_grad else _all_reduce(mesh, x)


def pmin(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    return _all_reduce(mesh, x.detach(), dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    return _all_reduce(mesh, x.detach(), dist.ReduceOp.MAX)


def replicated_backward_scale(mesh: Optional[DeviceMesh]) -> float:
    """The seed of a loss every rank computes in full: 1/n."""
    return 1.0 if mesh is None else 1.0 / mesh.world


# --- the state's sharding -------------------------------------------------------

def _is_row_leaf(name: str, x: torch.Tensor) -> bool:
    return x.dim() >= 1 and name != "density_thres"


def rows_of(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rank ``mesh.rank``'s block of rows of a per-Gaussian leaf."""
    if x.shape[0] % mesh.world:
        raise ValueError(f"{x.shape[0]} rows are not divisible by the {mesh.world}-rank mesh")
    m = x.shape[0] // mesh.world
    return x[mesh.rank * m:(mesh.rank + 1) * m]


def shard_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """The rank's part of ``state`` on its device: its rows of every
    per-Gaussian leaf, a copy of every replicated one (``state_to``'s copy of
    the nets)."""
    from ..train.state import state_to
    st = state_to(state, mesh.device)

    def gp_rows(gp):
        return GaussianParams(*[rows_of(x, mesh).clone() if _is_row_leaf(n, x) else x
                                for n, x in zip(GaussianParams._fields, gp)])

    gs = GaussianStats(*[rows_of(x, mesh).clone() if n in ROW_STATS else x
                         for n, x in zip(GaussianStats._fields, st.gs)])
    return st._replace(gp=gp_rows(st.gp), gs=gs, g_mu=gp_rows(st.g_mu), g_nu=gp_rows(st.g_nu))


def gather_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """The whole state on every rank: the per-Gaussian leaves gathered in
    rank order (no gradient), the replicated ones as they are."""
    def gp_all(gp):
        return GaussianParams(*[_all_gather(mesh, x) if _is_row_leaf(n, x) else x
                                for n, x in zip(GaussianParams._fields, gp)])

    gs = GaussianStats(*[_all_gather(mesh, x) if n in ROW_STATS else x
                         for n, x in zip(GaussianStats._fields, state.gs)])
    return state._replace(gp=gp_all(state.gp), gs=gs, g_mu=gp_all(state.g_mu),
                          g_nu=gp_all(state.g_nu))


# --- the launcher ----------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU (and detached)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        import copy
        return copy.deepcopy(obj).cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_cpu(x) for x in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    return obj


def _worker(rank: int, n: int, backend: str, device: str, init_method: str, fn: Callable,
            args: Sequence, threads: Optional[int], results) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        mesh = init_mesh(rank, n, backend, device, init_method)
        out = to_cpu(fn(mesh, *args))
    except BaseException:
        # report the failure and leave at once: the other ranks may wait in a
        # collective, where tearing down the group would wait with them
        results.put((rank, "error", traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    # as bytes: a tensor put on the queue would be shared through a handle
    # that dies with this process
    buf = io.BytesIO()
    torch.save(out, buf)
    results.put((rank, "ok", buf.getvalue()))
    destroy()


def spawn(fn: Callable, n: int, backend: str, device: str, args: Sequence = (),
          threads: Optional[int] = None, timeout: float = 3600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on n ranks, each a process started by
    ``torch.multiprocessing`` with the spawn method; returns the ranks'
    results in rank order, their tensors on the CPU.  ``fn`` must be a
    module-level function (the spawn method pickles it).  ``threads`` pins
    torch's threads in every rank.  Raises if any rank fails; every process
    is joined (or killed) before it returns."""
    import torch.multiprocessing as mp
    _check_placement(n, backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_worker, daemon=False,
                         args=(r, n, backend, device, init_method, fn, tuple(args), threads,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < n:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"a rank exited with code {dead[0].exitcode} "
                                  "without reporting")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"ranks did not finish within {timeout} s")
                    break
                continue
            if status == "ok":
                got[rank] = torch.load(io.BytesIO(payload), weights_only=False)
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break
    finally:
        for p in procs:
            p.join(timeout=None if not errors else 5.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn: " + "\n".join(errors))
    return [got[r] for r in range(n)]

