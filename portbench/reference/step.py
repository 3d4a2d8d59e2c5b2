"""A DG-Mesh training iteration and its inference render, in plain PyTorch.

Upstream's ``train.py`` (DG-Mesh, Liu et al. 2024) as the JAX package's
``train/step.py``, ``train/loop.py``, ``train/state.py`` and
``train/densify.py::anchor_step`` state it, for the iterations the cells
run (mesh phase, past the densification):

- the deform nets at the view's time (with the non-Blender time noise,
  two normal draws from the iteration's stream), the splat, the cycle
  consistency of the back-deformation (L1 over the live Gaussians, the
  normal net's at the canonical points);
- the mesh: DPSR of the deformed points and normals, marching tetrahedra,
  the vertices' colours from the appearance net at the back-deformed
  points, the raster; mask loss 100 L1 of the straight-through mask, mesh
  image loss, uniform Laplacian ×1000 × (1 − step/iterations);
- on an anchor iteration the anchoring of ``anchor`` and its loss;
- the image loss (1 − λ) L1 + λ (1 − SSIM), SSIM on an 11-tap σ 1.5
  window with zero padding;
- one backward, every gradient leaf holding a non-finite value zeroed,
  Adam (β 0.9, 0.999, ε 1e-15) on the live Gaussians with the
  per-group schedules (skipped on an anchor iteration) and on each net the
  phase trains; ``density_thres`` kept in [−1, 1].

The state is plain tensors: ``State``.  Everything random comes from the
iteration's generator, in the program's order: the anchoring's draws, then
the time noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import nets as N
from . import render as Rr
from . import surface as S

GP = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity", "normal", "density_thres")
PER_ROW = GP[:-1]
B1, B2, EPS = 0.9, 0.999, 1e-15


@dataclass
class State:
    gp: Dict[str, torch.Tensor]
    alive: torch.Tensor
    center: torch.Tensor
    scale: torch.Tensor
    nets: Dict[str, Dict[str, torch.Tensor]]
    g_mu: Dict[str, torch.Tensor]
    g_nu: Dict[str, torch.Tensor]
    g_count: int
    net_count: Dict[str, int]
    net_mu: Dict[str, Dict[str, torch.Tensor]]
    net_nu: Dict[str, Dict[str, torch.Tensor]]
    step: int


class View(NamedTuple):
    cam: Rr.Cam
    gt: torch.Tensor          # (3,H,W)
    mask: torch.Tensor        # (H,W)
    fid: float
    time_interval: float


class Flags(NamedTuple):
    warm: bool
    mesh: bool
    freeze_pos: bool
    use_normal: bool
    anchor: bool
    sh_degree: int


def full_float32(on: bool = True) -> None:
    """Float32 products in full float32 (no TF32), in matmuls and the SSIM's
    convolutions: the configurations' float32.  Set before the reference
    runs; the control turns it off."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


class Ctx:
    """A configuration's constants: ``conf`` is its frozen groups (model,
    optimization, tpu); ``mode`` the training nets' arithmetic."""

    def __init__(self, conf: dict, device):
        self.m, self.o, self.t = conf["model"], conf["optimization"], conf["tpu"]
        self.blender = bool(self.m["is_blender"])
        self.mode = "fused" if self.t["mlp_bf16"] and self.t["mlp_fused"] else (
            "f32" if not self.t["mlp_bf16"] else "bf16")
        if self.mode == "bf16":
            raise ValueError("the reference has the float32 and the fused trunk")
        self.device = device
        self.bg = torch.tensor([1.0, 1.0, 1.0] if self.m["white_background"] else [0.0] * 3,
                               device=device)

    def net(self, st: State, name: str, xyz, t, mode: Optional[str] = None):
        rows = xyz.shape[0]
        tt = torch.as_tensor(t, dtype=torch.float32, device=xyz.device).reshape(1, 1)
        return N.apply(name, st.nets[name], xyz, tt.expand(rows, 1), self.blender,
                       mode or self.mode)

    def mesh(self, st: State, xyz, normals, freeze_pos=False) -> S.Mesh:
        t = self.t
        return S.mesh_of(xyz, normals, st.alive, st.gp["density_thres"], st.center, st.scale,
                         self.m["grid_res"], self.o["dpsr_sig"], t["max_verts"],
                         t["max_faces"], freeze_pos)

    def colours(self, st: State, verts, fid, mode: Optional[str] = None):
        back = self.net(st, "deform_back", verts.detach(), fid, mode)[0]
        return self.net(st, "appearance", verts + back, fid, mode)

    def raster(self, verts, faces, colours, cam):
        t = self.t
        valid = torch.ones(faces.shape[0], dtype=torch.bool, device=faces.device)
        return Rr.raster(verts, faces, valid, colours, cam, self.bg, t["mask_sigma"],
                         t["max_faces_per_tile"], t["max_face_dup"])

    def splat(self, gp, d_xyz, d_rot, d_scale, alive, cam, sh_degree):
        rot = gp["rotation"] / (torch.linalg.norm(gp["rotation"], dim=-1, keepdim=True) + 1e-12)
        shs = torch.cat([gp["f_dc"], gp["f_rest"]], 1)
        return Rr.splat(gp["xyz"] + d_xyz, torch.exp(gp["scaling"]) + d_scale, rot + d_rot,
                        torch.sigmoid(gp["opacity"]), shs, alive, cam, self.bg, sh_degree,
                        self.t["max_gaussians_per_tile"], self.t["max_dup"])


def flags(ctx: Ctx, it: int) -> Flags:
    o = ctx.o
    mesh = it >= o["dpsr_iter"]
    if it == o["dpsr_iter"] or it < o["densify_until_iter"]:
        raise ValueError(f"iteration {it}: the reference runs mesh-phase iterations past "
                         "the densification and the normal initialisation")
    return Flags(warm=it < o["warm_up"], mesh=mesh,
                 freeze_pos=it < o["dpsr_iter"] + o["normal_warm_up"],
                 use_normal=it >= o["dpsr_iter"] + o["normal_net_warmup"],
                 anchor=(mesh and it > o["anchor_iter"] and it % o["anchor_interval"] == 0
                         and ctx.m["use_anchor"] > 0),
                 sh_degree=min(it // 1000, ctx.m["sh_degree"]))


# --- schedules ------------------------------------------------------------

def expon(step: float, init: float, final: float, max_steps: int) -> float:
    """Log-linear from ``init`` to ``final`` over ``max_steps``."""
    if step < 0 or init == 0.0:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(max(final, 1e-30)) * t)


def gaussian_lrs(ctx: Ctx, step: int) -> Dict[str, float]:
    """Per group, with the reference's spatial scale 5 on xyz and the
    scales, and its rotation and normal schedules as it sets them."""
    o = ctx.o
    mx = o["position_lr_max_steps"]
    return dict(xyz=expon(step, o["position_lr_init"] * 5, o["position_lr_final"] * 5, mx),
                f_dc=o["feature_lr"], f_rest=o["feature_lr"] / 20.0,
                scaling=o["scaling_lr"] * 5,
                rotation=expon(step, o["rotation_lr"] * 100, o["rotation_lr"] * 10, mx),
                opacity=o["opacity_lr"],
                normal=expon(step, o["rotation_lr"], o["rotation_lr"] * 0.1, mx),
                density_thres=expon(step, 0.01, 1e-4, mx))


def net_lrs(ctx: Ctx, step: int) -> Dict[str, float]:
    o = ctx.o
    mx = o["deform_lr_max_steps"]
    pos = expon(step, o["position_lr_init"] * 5, o["position_lr_final"], mx)
    nrm = expon(step, o["position_lr_init"] * 10, o["position_lr_final"] * 10, mx)
    return dict(deform=pos, deform_back=pos, deform_normal=nrm, deform_back_normal=nrm,
                appearance=expon(step, o["apperance_lr_init"], o["apperance_lr_final"],
                                 o["apperance_lr_max_steps"]))


def time_noise(step: int, device) -> torch.Tensor:
    """The time noise's scale, in float32: 0.1 → 0 over 20,000 steps under
    a sine delay."""
    t = torch.clamp(torch.tensor(float(step), device=device) / 20000, 0.0, 1.0)
    return (0.01 + 0.99 * torch.sin(0.5 * math.pi * t)) * (0.1 * (1 - t) + 1e-15 * t)


# --- losses -----------------------------------------------------------------

def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float32, device=a.device) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = g / g.sum()
    c = a.shape[0]

    def blur(img):
        y = F.conv2d(img[None], g.reshape(1, 1, 11, 1).repeat(c, 1, 1, 1), padding=(5, 0),
                     groups=c)
        return F.conv2d(y, g.reshape(1, 1, 1, 11).repeat(c, 1, 1, 1), padding=(0, 5),
                        groups=c)[0]
    ma, mb = blur(a), blur(b)
    va, vb, cov = blur(a * a) - ma * ma, blur(b * b) - mb * mb, blur(a * b) - ma * mb
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * ma * mb + c1) * (2 * cov + c2))
            / ((ma * ma + mb * mb + c1) * (va + vb + c2))).mean()


def image_loss(img, gt, lam: float):
    return (1.0 - lam) * (img - gt).abs().mean() + lam * (1.0 - ssim(img, gt))


def laplacian(verts, faces):
    """Σ_v ‖mean of v's neighbours over its faces' corners − v‖² over the
    vertices that have a face, divided by their number."""
    tri = verts[faces]
    nb = torch.zeros_like(verts).index_add_(0, faces.reshape(-1),
                                            (tri.sum(1, keepdim=True) - tri).reshape(-1, 3))
    deg = 2.0 * torch.bincount(faces.reshape(-1), minlength=verts.shape[0]).float()
    has = deg > 0
    lap = torch.where(has[:, None], nb / deg.clamp_min(1.0)[:, None] - verts, 0.0)
    return (lap * lap).sum() / has.sum().clamp_min(1)


def abs_l1(a, b, alive):
    """Σ|a − b| over live rows / (rows · lanes); |x|'s gradient is +1 at 0."""
    d = torch.where(alive[:, None], a - b, 0.0)
    return torch.where(d >= 0, d, -d).sum() / (alive.sum() * a.shape[1]).clamp_min(1)


# --- the iteration ------------------------------------------------------------

class Anchored(NamedTuple):
    gp: Dict[str, torch.Tensor]
    alive: torch.Tensor
    g_mu: Dict[str, torch.Tensor]
    g_nu: Dict[str, torch.Tensor]
    centroid: torch.Tensor      # (M,3) each Gaussian's nearest face centroid
    one_to_one: torch.Tensor    # (M,) the Gaussians alone on their face
    loss_n_1: torch.Tensor


def loss_of(ctx: Ctx, st: State, gp, nets, view: View, fl: Flags, gen,
            anchored: Optional[Anchored]):
    """The total loss and its terms, with gradients to ``gp`` and ``nets``."""
    o = ctx.o
    st = replace(st, nets=nets, gp=gp)
    alive = st.alive
    n1 = n2 = 0.0
    if not ctx.blender:
        z = torch.randn((2,), generator=gen, device=gen.device)
        mag = (torch.tensor(view.time_interval, device=gen.device)
               * time_noise(st.step, gen.device))
        n1, n2 = z[0] * mag, z[1] * mag
    t1 = view.fid + n1
    xyz = gp["xyz"]
    zeros3 = xyz.new_zeros(xyz.shape)
    if fl.warm:
        d_xyz, d_rot, d_scale = zeros3, xyz.new_zeros((xyz.shape[0], 4)), zeros3
    else:
        d_xyz, d_rot, d_scale, _ = ctx.net(st, "deform", xyz.detach(), t1)
    d_normal = ctx.net(st, "deform_normal", xyz.detach(), t1) if fl.use_normal else zeros3
    image, _ = ctx.splat(gp, d_xyz, d_rot, d_scale, alive, view.cam, fl.sh_degree)
    means = xyz + d_xyz
    terms = {}
    if not fl.warm:
        t2 = view.fid + n2
        back, rot_back, scale_back, _ = ctx.net(st, "deform_back", means.detach(), t2)
        cyc = [abs_l1(-back, d_xyz, alive), abs_l1(-rot_back, d_rot, alive),
               abs_l1(-scale_back, d_scale, alive)]
        if fl.use_normal:
            cyc.append(abs_l1(-ctx.net(st, "deform_back_normal", xyz.detach(), t2), d_normal,
                              alive))
        terms["cycle"] = sum(cyc[1:], cyc[0]) / len(cyc)
    overflow = 0
    if fl.mesh:
        m = ctx.mesh(st, means, gp["normal"] + d_normal, fl.freeze_pos)
        overflow = m.overflow
        rgb, mask, _ = ctx.raster(m.verts, m.faces, ctx.colours(st, m.verts, view.fid),
                                  view.cam)
        terms["mask"] = (mask - view.mask).abs().mean() * 100.0 * o["mask_loss_weight"]
        terms["mesh_img"] = image_loss(rgb.permute(2, 0, 1), view.gt,
                                       o["lambda_dssim"]) * o["mesh_img_loss_weight"]
        terms["laplacian"] = (laplacian(m.verts, m.faces) * 1000.0
                              * ctx.m["laplacian_loss_weight"]
                              * (1.0 - st.step / o["iterations"]))
    if fl.anchor and anchored is not None:
        w = anchored.one_to_one
        d2 = ((means - anchored.centroid) ** 2).sum(-1)
        terms["anchor"] = (torch.where(w, d2, 0.0).sum() / w.sum().clamp_min(1)
                           + anchored.loss_n_1) * 0.1
    terms["img"] = image_loss(image, view.gt, o["lambda_dssim"])
    total = sum(list(terms.values())[1:], list(terms.values())[0])
    return total, overflow


def gradients(ctx: Ctx, st: State, view: View, fl: Flags, gen, anchored=None):
    """(loss, {leaf: gradient} with every non-finite leaf zeroed, mesh
    overflow); Gaussian leaves under ``gp.``, net weights under
    ``<net>.``."""
    gp = {k: v.detach().requires_grad_(True) for k, v in st.gp.items()}
    nets = {n: {k: v.detach().requires_grad_(True) for k, v in w.items()}
            for n, w in st.nets.items()}
    loss, overflow = loss_of(ctx, st, gp, nets, view, fl, gen, anchored)
    names = [f"gp.{k}" for k in gp] + [f"{n}.{k}" for n, w in nets.items() for k in w]
    leaves = list(gp.values()) + [v for w in nets.values() for v in w.values()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    out = {}
    for name, x, g in zip(names, leaves, grads):
        g = torch.zeros_like(x) if g is None else g
        out[name] = torch.where(torch.isfinite(g).all(), g, torch.zeros_like(g))
    return loss.detach(), out, overflow


@torch.no_grad()
def adam(p, g, m, v, lr: float, count: int):
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    return p - lr * (m / (1 - B1 ** count)) / (torch.sqrt(v / (1 - B2 ** count)) + EPS), m, v


@torch.no_grad()
def update(ctx: Ctx, st: State, grads, fl: Flags, skip_gaussians: bool) -> State:
    gp, mu, nu, count = dict(st.gp), dict(st.g_mu), dict(st.g_nu), st.g_count
    if not skip_gaussians:
        count += 1
        lrs = gaussian_lrs(ctx, st.step)
        for k in GP:
            p, m, v = adam(st.gp[k], grads[f"gp.{k}"], st.g_mu[k], st.g_nu[k], lrs[k], count)
            if k == "density_thres":
                gp[k], mu[k], nu[k] = p.clamp(-1.0, 1.0), m, v
            else:
                live = st.alive.reshape((-1,) + (1,) * (p.dim() - 1))
                gp[k] = torch.where(live, p, st.gp[k])
                mu[k], nu[k] = torch.where(live, m, 0.0), torch.where(live, v, 0.0)
    active = dict(deform=not fl.warm, deform_back=not fl.warm, deform_normal=fl.use_normal,
                  deform_back_normal=fl.use_normal, appearance=fl.mesh)
    lrs = net_lrs(ctx, st.step)
    nets, nmu, nnu, ncount = dict(st.nets), dict(st.net_mu), dict(st.net_nu), dict(st.net_count)
    for n in N.NETS:
        if not active[n]:
            continue
        ncount[n] += 1
        w, m2, v2 = {}, {}, {}
        for k, p in st.nets[n].items():
            w[k], m2[k], v2[k] = adam(p, grads[f"{n}.{k}"], st.net_mu[n][k], st.net_nu[n][k],
                                      lrs[n], ncount[n])
        nets[n], nmu[n], nnu[n] = w, m2, v2
    return replace(st, gp=gp, g_mu=mu, g_nu=nu, g_count=count, nets=nets, net_mu=nmu,
                   net_nu=nnu, net_count=ncount, step=st.step + 1)


def iteration(ctx: Ctx, st: State, view: View, it: int, gen):
    """One training iteration: (new state, loss, mesh overflow)."""
    fl = flags(ctx, it)
    anchored = anchor(ctx, st, view, gen) if fl.anchor else None
    loss, grads, overflow = gradients(ctx, st, view, fl, gen, anchored)
    new = update(ctx, st, grads, fl, skip_gaussians=fl.anchor)
    if anchored is not None:
        new = replace(new, gp=anchored.gp, alive=anchored.alive, g_mu=anchored.g_mu,
                      g_nu=anchored.g_nu)
    return new, float(loss), overflow


# --- the anchoring --------------------------------------------------------------

def nearest(q: torch.Tensor, r: torch.Tensor, block_bytes: int = 1 << 30):
    """Squared distance and index of each query's nearest reference, as
    ‖q‖² + ‖r‖² − 2 q·r clamped at 0, ties to the lower index."""
    r2 = (r * r).sum(-1)
    rows = max(1, block_bytes // (4 * max(r.shape[0], 1)))
    d, i = [], []
    for s in range(0, q.shape[0], rows):
        qq = q[s:s + rows]
        d2 = ((qq * qq).sum(-1, keepdim=True) + r2).sub_(qq @ r.T, alpha=2.0).clamp_min_(0.0)
        v, j = torch.min(d2, dim=1)
        d.append(v)
        i.append(j)
    return torch.cat(d), torch.cat(i)


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _unit(v):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


@torch.no_grad()
def anchor(ctx: Ctx, st: State, view: View, gen) -> Anchored:
    """DG-Mesh's ``anchor_mesh``: the mesh of the Gaussians at the view's
    time (float32 nets, positions frozen); each live Gaussian's nearest face
    centroid, those farther than the search radius (squared distance
    against the radius) pruned; of the faces with more than one, a random
    batch merges its first two (slot order) into one, averaged where they
    are deformed and deformed back, the rest of the face's deleted; of the
    faces with none, a random batch spawns a Gaussian at its centroid.
    Every touched slot's moments are zeroed."""
    o, dev = ctx.o, st.alive.device
    F_cap = ctx.t["max_faces"]
    bs, inc = o["anchor_n_1_bs"], o["anchor_0_1_bs"]
    topn = max(2, int(o["anchor_topn"]))
    draw_n1 = torch.rand((F_cap,), generator=gen, device=dev)
    draw_01 = torch.rand((F_cap,), generator=gen, device=dev)
    angle = torch.randn((inc, 1), generator=gen, device=dev)
    gp, alive, M = st.gp, st.alive, st.alive.shape[0]
    fid = view.fid
    d_xyz, d_rot, d_scale, d_norm = ctx.net(st, "deform", gp["xyz"], fid, "f32")
    m = ctx.mesh(st, gp["xyz"] + d_xyz,
                 gp["normal"] + ctx.net(st, "deform_normal", gp["xyz"], fid, "f32"),
                 freeze_pos=True)
    nF = m.faces.shape[0]
    tri = m.verts[m.faces]
    cent = tri.mean(1)
    fnorm = _unit(torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1))
    pts = gp["xyz"] + d_xyz
    d2, nn = nearest(pts, cent)
    alive1 = alive & (d2 < st.scale * o["anchor_search_radius"])
    count = torch.bincount(nn[alive1], minlength=nF)
    one, many, none = count == 1, count > 1, count == 0

    def padded(mask, draw):
        return torch.where(torch.cat([mask, mask.new_zeros(F_cap - nF)]), draw, -math.inf)
    # faces with many: merge the first topn of each of a random batch
    sel = _top(padded(many, draw_n1), bs)
    sel = sel[sel < nF][many[sel[sel < nF]]]
    key = torch.where(alive1, nn, nF)
    order = torch.sort(key, stable=True).indices
    start = torch.searchsorted(key[order], torch.arange(nF + 1, device=dev))
    rank = torch.empty(M, dtype=torch.long, device=dev)
    rank[order] = torch.arange(M, device=dev) - start[key[order]]
    chosen = torch.zeros(nF + 1, dtype=torch.bool, device=dev)
    chosen[sel] = True
    delete = alive1 & chosen[key] & (rank >= topn)
    members = order[(start[sel][:, None] + torch.arange(topn, device=dev)).clamp_max(M - 1)]
    ok = torch.arange(topn, device=dev) < count[sel][:, None]
    w = ok.float() / ok.float().sum(1, keepdim=True).clamp_min(1.0)

    def mean_of(x):
        v = x[members]
        return (v * w.reshape(w.shape + (1,) * (v.dim() - 2))).sum(1)
    mx = mean_of(pts)
    b_xyz, b_rot, b_scale, b_norm = ctx.net(st, "deform_back", mx, fid, "f32")
    loss_n_1 = (torch.linalg.norm(cent[sel] - mx, dim=-1).sum()
                / max(sel.numel(), 1))
    new = {k: v.clone() for k, v in gp.items()}
    head = members[:, 0]
    merged = dict(xyz=mx + b_xyz, scaling=mean_of(gp["scaling"] + d_scale) + b_scale,
                  rotation=mean_of(gp["rotation"] + d_rot) + b_rot,
                  normal=_unit(mean_of(gp["normal"] + d_norm) + b_norm),
                  f_dc=mean_of(gp["f_dc"]), f_rest=mean_of(gp["f_rest"]),
                  opacity=mean_of(gp["opacity"]))
    for k, v in merged.items():
        new[k][head] = v
    killed = torch.zeros(M, dtype=torch.bool, device=dev)
    killed[members[:, 1:][ok[:, 1:]]] = True
    alive2 = alive1 & ~delete & ~killed
    # faces with none: spawn at the centroids of a random batch
    pick = _top(padded(none, draw_01), inc)
    good = (pick < nF) & none[pick.clamp_max(max(nF - 1, 0))]
    p_sp = cent[pick.clamp_max(max(nF - 1, 0))]
    n_sp = fnorm[pick.clamp_max(max(nF - 1, 0))]
    idx = torch.nonzero(good).squeeze(1)
    near = torch.zeros(inc, 3, device=dev)
    if idx.numel():
        q = p_sp[idx]
        dd = ((q * q).sum(-1, keepdim=True) + (q * q).sum(-1)).sub_(q @ q.T, alpha=2.0) \
            .clamp_min_(0.0)
        dd.fill_diagonal_(math.inf)
        k = min(3, idx.numel())
        v = torch.topk(dd, k, dim=1, largest=False).values
        near[idx, :k] = torch.where(torch.isfinite(v), v, 0.0)
    scale_sp = torch.log(torch.sqrt(near.mean(1).clamp_min(1e-7)))[:, None].expand(inc, 3)
    half = angle * math.pi
    rot_sp = torch.cat([torch.cos(half), _unit(n_sp) * torch.sin(half)], -1)
    s_xyz, s_rot, s_scale, s_norm = ctx.net(st, "deform_back", p_sp, fid, "f32")
    spawn = dict(xyz=p_sp + s_xyz, scaling=scale_sp + s_scale, rotation=rot_sp + s_rot,
                 normal=_unit(n_sp + s_norm),
                 f_dc=torch.ones((inc, 1, 3), device=dev),
                 f_rest=torch.zeros((inc,) + tuple(gp["f_rest"].shape[1:]), device=dev),
                 opacity=torch.full((inc, 1), math.log(0.1 / 0.9), device=dev))
    free = torch.nonzero(~alive2).squeeze(1)
    n = min(idx.numel(), free.numel())
    dst = free[:n]
    for k, v in spawn.items():
        new[k][dst] = v[idx[:n]]
    alive3 = alive2.clone()
    alive3[dst] = True
    touched = killed | delete | (alive1 & ~alive2) | (alive & ~alive1)
    touched[head] = True
    touched[dst] = True
    mu, nu = dict(st.g_mu), dict(st.g_nu)
    for k in PER_ROW:
        t = touched.reshape((-1,) + (1,) * (mu[k].dim() - 1))
        mu[k], nu[k] = torch.where(t, 0.0, mu[k]), torch.where(t, 0.0, nu[k])
    return Anchored(new, alive3, mu, nu, cent[nn], alive1 & one[nn], loss_n_1)


# --- the inference render ------------------------------------------------------

@torch.no_grad()
def render_view(ctx: Ctx, st: State, view: View, sh_degree: int) -> dict:
    """The splat image, the mesh image and coverage and the mesh's size,
    every net in float32: the program's ``render_frame`` with the mesh."""
    gp = st.gp
    d_xyz, d_rot, d_scale, _ = ctx.net(st, "deform", gp["xyz"], view.fid, "f32")
    d_normal = ctx.net(st, "deform_normal", gp["xyz"], view.fid, "f32")
    image, _ = ctx.splat(gp, d_xyz, d_rot, d_scale, st.alive, view.cam, sh_degree)
    m = ctx.mesh(st, gp["xyz"] + d_xyz, gp["normal"] + d_normal)
    rgb, mask, _ = ctx.raster(m.verts, m.faces, ctx.colours(st, m.verts, view.fid, "f32"),
                              view.cam)
    return dict(render=image, mesh_image=rgb.permute(2, 0, 1), mask=mask,
                n_verts=m.n_verts, n_faces=m.n_faces, overflow=m.overflow)
