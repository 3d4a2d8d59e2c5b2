"""What the ranks of the port's multi-device tests run (spawned processes
import this module by name, so it holds module-level functions only).

``ops_rank`` runs each sharded op of dgmesh_torch/parallel on the rank's
part of the inputs that tests/test_torch_parallel.py builds, takes the
gradient of a fixed linear function of each op's outputs (every rank
computes the whole of it, so it is seeded with 1/n), and returns the
outputs and gradients whole.  ``step_rank`` runs the sharded training step
from a carried-in state and returns the new state, the metrics and the
gradients whole."""

import torch

from dgmesh_torch.models import gaussians as G
from dgmesh_torch.parallel import sharding as SH
from dgmesh_torch.parallel.sharded_dpsr import dpsr_sharded
from dgmesh_torch.parallel.sharded_mr import render_mesh_sharded
from dgmesh_torch.parallel.sharded_mt import marching_tets_sharded, stitch
from dgmesh_torch.parallel.sharded_splat import (exchange_and_merge, local_bins,
                                                 render_sharded)
from dgmesh_torch.ops.splat import _pack_attrs, preprocess
from dgmesh_torch.ops.splat_kernels import LANES


def _rows(x, mesh, grad=False):
    return SH.rows_of(x, mesh).clone().requires_grad_(grad)


def _seed(mesh):
    return SH.replicated_backward_scale(mesh)


def splat_part(mesh, s):
    names = ("means3d", "scales", "quats", "opacities", "shs")
    leaves = {k: _rows(s[k], mesh, True) for k in names}
    alive = _rows(s["alive"], mesh)
    cfg = s["cfg"]
    out = render_sharded(mesh, *[leaves[k] for k in names], alive, s["cam"], s["bg"], cfg,
                         s["sh_degree"])
    loss = (out["render"] * s["g_img"]).sum() + (out["alpha"] * s["g_alpha"]).sum()
    (loss * _seed(mesh)).backward()
    # the merged tile lists, on their own
    with torch.no_grad():
        pre = preprocess(*[leaves[k].detach() for k in names], alive, s["cam"], cfg,
                         s["sh_degree"])
        tile_idx, dq, _ = local_bins(pre, cfg, mesh)
        packed = _pack_attrs(pre)
        rows = torch.cat([packed, packed.new_ones((packed.shape[0], 1)),
                          packed.new_zeros((packed.shape[0], LANES - 10))], -1)
        _, gid = exchange_and_merge(tile_idx, dq, rows, LANES, cfg.num_tiles,
                                    cfg.max_per_tile, mesh)
    return dict(render=out["render"].detach(), alpha=out["alpha"].detach(),
                radii=SH.all_gather(out["radii"].detach(), mesh),
                visibility=SH.all_gather(out["visibility"], mesh),
                aux={k: v for k, v in out["aux"].items()},
                tile_idx=SH.all_gather(gid, mesh)[:cfg.num_tiles],
                grads={k: SH.all_gather(leaves[k].grad, mesh) for k in names})


def mr_part(mesh, m):
    verts = m["verts"].clone().requires_grad_(True)
    color = m["vtx_color"].clone().requires_grad_(True)
    out = render_mesh_sharded(mesh, verts, SH.rows_of(m["faces"], mesh),
                              SH.rows_of(m["face_valid"], mesh), color, m["pose"], m["proj"],
                              m["bg"], m["cfg"], want_soft=True)
    loss = (out["rgb"] * m["g_rgb"]).sum() + (out["soft_mask"] * m["g_soft"]).sum()
    (loss * _seed(mesh)).backward()
    return dict(rgb=out["rgb"].detach(), mask=out["mask"], soft=out["soft_mask"].detach(),
                face_id=out["face_id"], aux=out["aux"],
                g_verts=SH.psum(verts.grad, mesh), g_color=SH.psum(color.grad, mesh))


def dpsr_part(mesh, d):
    pts = _rows(d["points"], mesh, True)
    nrm = _rows(d["normals"], mesh, True)
    phi = dpsr_sharded(mesh, d["op"], pts, nrm, _rows(d["valid"], mesh))
    ((phi * d["g_phi"]).sum() * _seed(mesh)).backward()
    return dict(phi=phi.detach(), g_points=SH.all_gather(pts.grad, mesh),
                g_normals=SH.all_gather(nrm.grad, mesh))


def mt_part(mesh, t):
    phi = t["phi"].clone().requires_grad_(True)
    m = marching_tets_sharded(mesh, phi, t["cfg"])
    whole = stitch(m, mesh)
    nv = int(whole.n_verts)
    loss = (whole.verts[whole.vert_valid] * t["g_verts"][:nv]).sum()
    (loss * _seed(mesh)).backward()
    return dict(block=m._replace(verts=m.verts.detach()),
                whole=whole._replace(verts=whole.verts.detach()),
                g_phi=SH.psum(phi.grad, mesh))


def collectives_part(mesh):
    """Each differentiable collective on a rank-specific x (m rows a rank)
    under a rank-specific linear function Σ <op(x), w_r>; returns x's
    gradient and the w of every rank, gathered."""
    n, r = mesh.world, mesh.rank
    g = torch.Generator().manual_seed(100 + r)
    out = {}
    for name, op in (("all_gather", SH.all_gather), ("psum_scatter", SH.psum_scatter),
                     ("all_to_all", SH.all_to_all), ("ppermute", lambda x, m: SH.ppermute(x, m, 1)),
                     ("psum", SH.psum)):
        x = torch.randn(2 * n, 3, generator=g).requires_grad_(True)
        y = op(x, mesh)
        w = torch.randn(y.shape, generator=g)
        (y * w).sum().backward()
        out[name] = dict(x=SH.all_gather(x.detach(), mesh), grad=SH.all_gather(x.grad, mesh),
                         w=SH.all_gather(w, mesh), y=SH.all_gather(y.detach(), mesh))
    return out


def ops_rank(mesh, inputs):
    return dict(splat=splat_part(mesh, inputs["splat"]), mr=mr_part(mesh, inputs["mr"]),
                dpsr=dpsr_part(mesh, inputs["dpsr"]), mt=mt_part(mesh, inputs["mt"]),
                collectives=collectives_part(mesh))


def mt16_rank(mesh, t):
    return marching_tets_sharded(mesh, t["phi"], t["cfg"])


def step_rank(mesh, cfg, img, state, batch, flags):
    """One sharded step from ``state`` (whole, on the CPU): the rank's
    gradients (their replicated leaves summed over the ranks by
    ``sanitize``) and new state, gathered."""
    from dgmesh_torch.train.step import StepContext, loss_and_grads, sanitize, train_step
    ctx = StepContext(cfg, img, img, device="cpu", device_mesh=mesh)
    part = SH.shard_state(state, mesh)
    loss, aux, grads = loss_and_grads(ctx, part, batch, flags)
    grads, bad = sanitize(grads, mesh)
    row = [SH.all_gather(g, mesh) if n != "density_thres" else g
           for n, g in zip(G.GaussianParams._fields, grads.gp)]
    new, metrics = train_step(ctx, part, batch, flags)
    return dict(loss=loss, g_gp=G.GaussianParams(*row), g_nets=grads.nets,
                g_screen=SH.all_gather(grads.screen, mesh), bad=bad,
                new=SH.gather_state(new, mesh), metrics=metrics,
                host_copies=mesh.host_copies)

