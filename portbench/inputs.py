"""The benchmark's inputs, made from the seed: the deforming object, its
cameras and ground-truth images, and the training state.

Nothing here imports the program.  Both sides get the same raw inputs (poses,
intrinsics, images, masks, times, parameter tensors) and build their own
objects from them: the program through its own types (``dgmesh_torch``,
passed in as ``P``), the plain reference (``portbench.reference``) from the
tensors themselves.

The object is an elongated ellipsoid, about as long, wide and high as a
beagle standing, with a smooth albedo pattern on its surface and
Lambertian shading, the same at every time: the nets' zero deformation is
then the fitted answer, and the state stays near a fitted one over a
window.  (With a moving object the fresh nets chase the motion and the
mesh leaves the configuration's caps within tens of iterations.)  Its
surface is what sizes the mesh: at the published DPSR frames (the
Gaussians' extent × 1.2 for beagle, × 1.0 for tail, on a 288 grid) it gives
about 290,000 and 415,000 vertices, inside the 524,288 cap.  The plain
renderer below casts one ray per pixel against it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from portbench.reference import nets as RN
from portbench.reference import render as RR
from portbench.reference import step as RS

AXES = (0.7, 0.32, 0.28)          # semi-axes of the ellipsoid
CENTRE = (0.02, -0.03, 0.01)
LIGHT = (0.3, -0.5, 0.8)


def albedo(u: torch.Tensor) -> torch.Tensor:
    """Colour (N,3) of canonical unit-sphere directions u (N,3)."""
    r = 0.55 + 0.35 * torch.sin(5.0 * u[:, 0] + 1.0) * torch.cos(3.0 * u[:, 1])
    g = 0.5 + 0.3 * torch.sin(4.0 * u[:, 1] - 2.0 * u[:, 2])
    b = 0.45 + 0.35 * torch.cos(6.0 * u[:, 2] + u[:, 0])
    return torch.stack([r, g, b], -1).clamp(0.0, 1.0)


def look_at_blender(eye: np.ndarray) -> np.ndarray:
    """Blender/OpenGL camera-to-world pose at ``eye`` looking at the origin."""
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right) + 1e-12
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -forward, eye
    return c2w


@dataclass
class View:
    """One camera and time: the raw input both sides build a camera from."""
    uid: int
    c2w: np.ndarray          # (4,4) Blender/OpenGL camera-to-world
    K: np.ndarray            # (3,3) pinhole intrinsics
    width: int
    height: int
    fid: float
    image: np.ndarray = None     # (H,W,3) float32, background composited
    mask: np.ndarray = None      # (H,W,1) float32


def make_views(cam: dict, n: int, seed: int, test: bool = False) -> List[View]:
    """``n`` views on an orbit: azimuths spaced by the golden angle from a
    seeded start, elevations alternating within the camera spec's band,
    times i/(n-1) (test views sit between the training times)."""
    rng = np.random.default_rng(seed + (7 if test else 0))
    az0 = rng.uniform(0.0, 2.0 * math.pi)
    W, H = cam["width"], cam["height"]
    focal = 0.5 * W / math.tan(0.5 * cam["fovx"])
    K = np.array([[focal, 0.0, cam["cx"] * W], [0.0, focal, cam["cy"] * H], [0.0, 0.0, 1.0]])
    lo, hi = cam["elevation"]
    views = []
    for i in range(n):
        az = az0 + i * math.pi * (3.0 - math.sqrt(5.0))
        el = lo + (hi - lo) * ((i * 0.618034) % 1.0)
        r = cam["radius"]
        eye = np.array([r * math.cos(el) * math.cos(az), r * math.cos(el) * math.sin(az),
                        r * math.sin(el)])
        fid = (i + 0.5) / n if test else i / max(n - 1, 1)
        views.append(View(uid=i, c2w=look_at_blender(eye), K=K.astype(np.float32),
                          width=W, height=H, fid=float(fid)))
    return views


@torch.no_grad()
def render_gt(views: List[View], white: bool, device) -> None:
    """Fill each view's image and mask by casting one ray per pixel at the
    object at the view's time (pixel centres, OpenCV intrinsics)."""
    light = torch.tensor(LIGHT, device=device)
    light = light / light.norm()
    bg = 1.0 if white else 0.0
    for v in views:
        W, H = v.width, v.height
        K = torch.as_tensor(v.K, dtype=torch.float64, device=device)
        c2w = torch.as_tensor(v.c2w, dtype=torch.float64, device=device)
        ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float64) + 0.5,
                                torch.arange(W, device=device, dtype=torch.float64) + 0.5,
                                indexing="ij")
        d_cv = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                            torch.ones_like(xs)], -1)
        d_gl = d_cv * torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64, device=device)
        d = d_gl @ c2w[:3, :3].T
        o = c2w[:3, 3].expand_as(d)
        a = torch.tensor(AXES, dtype=torch.float64, device=device)
        c = torch.tensor(CENTRE, dtype=torch.float64, device=device)
        oo, dd = (o - c) / a, d / a
        qa = (dd * dd).sum(-1)
        qb = 2.0 * (oo * dd).sum(-1)
        qc = (oo * oo).sum(-1) - 1.0
        disc = qb * qb - 4.0 * qa * qc
        hit = disc > 0
        tt = (-qb - torch.sqrt(disc.clamp_min(0.0))) / (2.0 * qa)
        hit &= tt > 0
        u = oo + tt[..., None] * dd                     # unit-sphere point
        n = u / a
        n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        shade = 0.35 + 0.65 * (n.float() @ light).clamp_min(0.0)
        rgb = albedo(u.reshape(-1, 3).float()).reshape(H, W, 3) * shade[..., None]
        m = hit.float()[..., None]
        img = rgb * m + bg * (1.0 - m)
        v.image = img.cpu().numpy().astype(np.float32)
        v.mask = m.cpu().numpy().astype(np.float32)


def camera(P, v: View, blender: bool):
    """The view as a camera of the program, built as its readers do: the
    Blender loader from the pose and FoV, the Nerfies loader from R, T and
    K with the pose kept for the mesh rasterizer."""
    C = P.cameras
    fovx = 2.0 * math.atan(0.5 * v.width / float(v.K[0, 0]))
    if blender:
        return C.camera_from_c2w_blender(v.uid, v.c2w.astype(np.float32), fovx, v.width,
                                         v.height, v.fid, image=v.image, alpha_mask=v.mask)
    c2w_cv = v.c2w.copy()
    c2w_cv[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w_cv)
    return C.Camera(uid=v.uid, R=w2c[:3, :3].T.copy(), T=w2c[:3, 3].copy(), fovx=fovx,
                    fovy=2.0 * math.atan(0.5 * v.height / float(v.K[1, 1])), image=v.image,
                    alpha_mask=v.mask, fid=v.fid, width=v.width, height=v.height,
                    K=v.K.copy(), orig_transform=v.c2w.astype(np.float32))


def cameras_extent(views: List[View]) -> float:
    """The scene radius the readers derive: 1.1 × the largest distance of a
    camera centre from their mean."""
    centres = np.stack([v.c2w[:3, 3] for v in views])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max() * 1.1)


# --- the state ----------------------------------------------------------------

HEAD_NOISE = 1e-4


def surface_points(n: int, gen: torch.Generator, device):
    """n points (n,3) on the object's surface, their outward normals and
    albedo, from ``gen`` in one draw."""
    z = torch.randn((n, 3), generator=gen, device=device, dtype=torch.float64)
    u = z / z.norm(dim=-1, keepdim=True)
    a = torch.tensor(AXES, dtype=torch.float64, device=device)
    pts = u * a + torch.tensor(CENTRE, dtype=torch.float64, device=device)
    nrm = u / a
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    return pts.float(), nrm.float(), albedo(u.float())


def net_weights(blender: bool, gen: torch.Generator, device):
    """Every net's weights in one draw: lecun-scaled truncated normals for
    the kernels, zero biases, and 1e-4 noise on the zero-initialised heads.
    {net: {name: tensor}}, the names and shapes of the reference's
    ``param_spec``, which the program's modules load by name."""
    spec = {n: RN.param_spec(blender, n) for n in RN.NETS}
    total = sum(math.prod(s) for net in spec.values() for _, s in net)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, i = {}, 0
    for net, shapes in spec.items():
        d = {}
        for k, s in shapes:
            m = math.prod(s)
            x = z[i:i + m].view(s)
            i += m
            if k.endswith("bias"):
                d[k] = torch.zeros(s, device=device)
            elif k.split(".")[0] in RN.ZERO_HEADS:
                d[k] = x * HEAD_NOISE
            else:
                d[k] = x * (math.sqrt(1.0 / s[1]) / 0.87962566103423978)
        out[net] = d
    return out


def raw_state(conf: dict, seed: int, device) -> dict:
    """The state's tensors from the seed: ``n_live`` Gaussians on the
    object's canonical surface in ``max_gaussians`` slots, outward normals,
    scale 0.01, opacity 0.1, colours from the albedo, identity rotations,
    random nets."""
    cfg = conf["config"]
    gen = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    M, n = cfg["tpu"]["max_gaussians"], conf["n_live"]
    f32 = dict(dtype=torch.float32, device=device)
    pts, nrm, col = surface_points(n, gen, device)
    alive = torch.zeros(M, dtype=torch.bool, device=device)
    alive[:n] = True

    def pad(x, width):
        out = torch.zeros((M,) + width, **f32)
        out[:n] = x.reshape((n,) + width)
        return out
    rotation = torch.zeros((M, 4), **f32)
    rotation[:, 0] = 1.0
    gp = dict(xyz=pad(pts, (3,)), f_dc=pad((col - 0.5) / RR.SH_C0, (1, 3)),
              f_rest=torch.zeros((M, 15, 3), **f32),
              scaling=torch.where(alive[:, None], math.log(0.01), 0.0).expand(M, 3).contiguous(),
              rotation=rotation, opacity=torch.full((M, 1), math.log(0.1 / 0.9), **f32),
              normal=pad(nrm, (3,)),
              density_thres=torch.tensor(float(cfg["optimization"]["init_density_threshold"]),
                                         **f32))
    return dict(gp=gp, alive=alive, nets=net_weights(bool(cfg["model"]["is_blender"]), gen,
                                                     device))


def optimizer_counts(cfg: dict, it: int) -> dict:
    """The steps each optimizer has taken before iteration ``it`` on the
    published schedule: the Gaussians' every iteration, the deform and
    cycle nets' since warm_up, the normal nets' since dpsr_iter +
    normal_net_warmup, the appearance net's since dpsr_iter."""
    o = cfg["optimization"]
    nets = {"deform": o["warm_up"], "deform_back": o["warm_up"],
            "deform_normal": o["dpsr_iter"] + o["normal_net_warmup"],
            "deform_back_normal": o["dpsr_iter"] + o["normal_net_warmup"],
            "appearance": o["dpsr_iter"]}
    out = {k: max(it - 1 - v, 0) for k, v in nets.items()}
    out["gaussians"] = it - 1
    return out


def program_state(P, cfg, raw: dict, step: int, scales=None, counts=None):
    """The program's TrainState of the raw state after ``step`` iterations:
    the DPSR frame fitted by the program, Adam's first moments zero, its
    second moments each leaf's squared gradient scale (live rows only; zero
    without ``scales``) and its counts ``counts`` (a net that has not
    started keeps a fresh Adam)."""
    G, St = P.gaussians, P.state
    dev = raw["alive"].device
    gp = G.GaussianParams(**{k: v.clone() for k, v in raw["gp"].items()})
    z = torch.zeros(gp.xyz.shape[0], dtype=torch.float32, device=dev)
    gs = G.GaussianStats(alive=raw["alive"].clone(), max_radii2d=z, xyz_grad_accum=z.clone(),
                         denom=z.clone(), gaussian_center=torch.zeros(3, device=dev),
                         gaussian_scale=torch.tensor(1.0, device=dev))
    fixed = (cfg.model.gaussian_center
             if cfg.model.data_type in ("iPhone", "NeuralActor") else None)
    gs = G.update_scale_center(gp, gs, cfg.model.gaussian_ratio, fixed_center=fixed)
    nets = St.build_nets(cfg, device="meta")
    nets = St.NetParams(*[n.to_empty(device=dev) for n in nets])
    for name, net in zip(St.NetParams._fields, nets):
        net.load_state_dict(raw["nets"][name], strict=True)
    live = gs.alive
    scales = scales or {}
    counts = counts or dict.fromkeys(["gaussians", *St.NetParams._fields], 0)
    nu = []
    for k, p in zip(G.GaussianParams._fields, gp):
        s = scales.get(f"gp.{k}", 0.0)
        if p.dim() == 0:
            nu.append(torch.full_like(p, s * s))
        else:
            nu.append(torch.where(live.reshape((-1,) + (1,) * (p.dim() - 1)), s * s, 0.0)
                      .expand_as(p).contiguous())
    opts = []
    for name, net in zip(St.NetParams._fields, nets):
        c = counts[name]
        ps = list(net.named_parameters())
        opts.append(St.NetAdam(
            count=torch.tensor(c, dtype=torch.int32, device=dev),
            mu=tuple(torch.zeros_like(p) for _, p in ps),
            nu=tuple(torch.full_like(p, scales.get(f"{name}.{k}", 0.0) ** 2 if c else 0.0)
                     for k, p in ps)))
    return St.TrainState(gp=gp, gs=gs, nets=nets,
                         g_mu=G.GaussianParams(*[torch.zeros_like(x) for x in gp]),
                         g_nu=G.GaussianParams(*nu),
                         g_count=torch.tensor(counts["gaussians"], dtype=torch.int32, device=dev),
                         net_opt=St.NetParams(*opts),
                         step=torch.tensor(step, dtype=torch.int32, device=dev))


def reference_state(conf: dict, raw: dict, step: int, scales=None, counts=None) -> RS.State:
    """The reference's State of the raw state: its own DPSR frame (the live
    points' box centre, the largest half extent × gaussian_ratio), Adam's
    moments as ``program_state`` sets them (none without ``scales``)."""
    m = conf["config"]["model"]
    gp = {k: v.clone() for k, v in raw["gp"].items()}
    alive = raw["alive"].clone()
    pts = gp["xyz"][alive]
    lo, hi = pts.amin(0), pts.amax(0)
    if m["data_type"] in ("iPhone", "NeuralActor"):
        center = torch.tensor(m["gaussian_center"], dtype=torch.float32, device=pts.device)
    else:
        center = (lo + hi) / 2.0
    half = torch.maximum((hi - center).abs(), (center - lo).abs()).max()
    nets = {n: {k: v.clone() for k, v in w.items()} for n, w in raw["nets"].items()}
    zero = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}  # noqa: E731
    g_nu, net_nu = zero(gp), {n: zero(w) for n, w in nets.items()}
    counts = counts or dict.fromkeys(list(RN.NETS) + ["gaussians"], 0)
    if scales is not None:
        for k, p in gp.items():
            s2 = scales[f"gp.{k}"] ** 2
            g_nu[k] = (torch.full_like(p, s2) if p.dim() == 0 else torch.where(
                alive.reshape((-1,) + (1,) * (p.dim() - 1)), s2, 0.0).expand_as(p).contiguous())
        for n, w in nets.items():
            if counts[n]:
                net_nu[n] = {k: torch.full_like(p, scales[f"{n}.{k}"] ** 2) for k, p in w.items()}
    return RS.State(gp=gp, alive=alive, center=center, scale=half * m["gaussian_ratio"],
                    nets=nets, g_mu=zero(gp), g_nu=g_nu, g_count=counts["gaussians"],
                    net_count={n: counts[n] for n in RN.NETS},
                    net_mu={n: zero(w) for n, w in nets.items()}, net_nu=net_nu, step=step)


def reference_view(v: View, n_views: int, blender: bool, device) -> RS.View:
    """The view for the reference: its matrices, and its ground truth where
    it has one."""
    gt = None if v.image is None else torch.as_tensor(np.transpose(v.image, (2, 0, 1)),
                                                      device=device)
    mask = None if v.mask is None else torch.as_tensor(v.mask[..., 0], device=device)
    return RS.View(cam=RR.make_cam(v, not blender, device), gt=gt, mask=mask, fid=v.fid,
                   time_interval=1.0 / n_views)


def gradient_scales(ctx: RS.Ctx, st: RS.State, view: RS.View, it: int, gen) -> dict:
    """The root mean square of each leaf's gradient (live rows for the
    Gaussian leaves) at ``st`` on ``view``, by the reference: the scale
    Adam's second moments hold in a run that has trained this far."""
    _, grads, _ = RS.gradients(ctx, st, view, RS.flags(ctx, it), gen)
    out = {}
    for k, g in grads.items():
        if k.startswith("gp.") and g.dim() > 0:
            g = g[st.alive]
        out[k] = float(g.double().pow(2).mean().sqrt()) if g.numel() else 0.0
    return out


@torch.no_grad()
def mesh_gt(ctx: RS.Ctx, st: RS.State, views: List[View], it: int) -> None:
    """Fill each view's image and mask with the reference's mesh render of
    ``st``: the mesh extracted once at mid-time (the nets' deformation is
    near zero), its colours by the appearance net at the view's time, the
    raster's hard coverage as the mask."""
    fl = RS.flags(ctx, it)
    xyz = st.gp["xyz"]
    d_xyz = ctx.net(st, "deform", xyz, 0.5, "f32")[0]
    d_normal = (ctx.net(st, "deform_normal", xyz, 0.5, "f32") if fl.use_normal
                else torch.zeros_like(xyz))
    m = ctx.mesh(st, xyz + d_xyz, st.gp["normal"] + d_normal)
    for v in views:
        cam = RR.make_cam(v, not ctx.blender, xyz.device)
        rgb, mask, _ = ctx.raster(m.verts, m.faces, ctx.colours(st, m.verts, v.fid, "f32"), cam)
        v.image = rgb.clamp(0.0, 1.0).cpu().numpy().astype(np.float32)
        v.mask = mask[..., None].float().cpu().numpy().astype(np.float32)
