"""Configuration system.

Mirrors the reference's three reflection-generated argparse groups
(reference: dgmesh/arguments/__init__.py:21-154) as plain dataclasses, and the
YAML-over-CLI merge semantics of dgmesh/utils/system_utils.py:33-51 (YAML wins).

A copy of ``dgmesh_tpu/config.py``: the same fields, so every shipped YAML
loads unchanged.  The capacity knobs in ``TpuParams`` keep their name: the
port keeps the padded layout (fixed capacities plus alive/valid masks), so a
JAX state carries across leaf by leaf.  Knobs that only exist for the TPU are
read and ignored; each says so where it is declared.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import yaml


@dataclass
class ModelParams:
    # reference: arguments/__init__.py:50-92
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    is_blender: bool = False
    is_6dof: bool = False
    data_type: str = ""  # "", "Nerfies", "iPhone", "NeuralActor", "finetune-nerf", "DTU", "PlenopticVideo"
    nerfies_ratio: float = 0.5
    downsample: float = 1.0   # image downsample ratio (arguments/__init__.py:66)
    pretrain_mesh_path: str = ""        # finetune-nerf GT mesh dirs (:83-84)
    pretrain_mesh_path_test: str = ""
    load2gpu_on_the_fly: bool = False
    grid_res: int = 256
    gaussian_ratio: float = 1.5
    gaussian_center: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    prune_threshold: float = 0.005
    laplacian_loss_weight: float = 1.0
    use_anchor: float = 1.0


@dataclass
class PipelineParams:
    # reference: arguments/__init__.py:95-100
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationParams:
    # reference: arguments/__init__.py:103-154
    iterations: int = 40_000
    first_iter: int = -1
    warm_up: int = 3_000
    normal_warm_up: int = 1_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    deform_lr_max_steps: int = 40_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 1e-3
    rotation_lr: float = 1e-3
    normal_lr: float = 1e-3
    density_thres_lr: float = 0.01
    # appearance-MLP LR schedule; the "apperance" spelling matches the
    # reference's field names (arguments/__init__.py:115-118) so reference
    # YAMLs (e.g. iphone/tiger.yaml) apply unchanged
    apperance_lr_init: float = 1.6e-4
    apperance_lr_final: float = 1.6e-6
    apperance_lr_delay_mult: float = 0.01
    apperance_lr_max_steps: int = 40_000
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    # Mesh branch
    dpsr_iter: int = 5_000
    dpsr_sig: float = 0.5
    # d_normal activation delay after dpsr_iter (reference hardcodes
    # NORMAL_WARMUP_ITER=2000 at train.py:127; configurable here)
    normal_net_warmup: int = 2_000
    anchor_iter: int = 8_000
    anchor_interval: int = 100
    anchor_search_radius: float = 5e-4
    anchor_topn: int = 2
    anchor_n_1_bs: int = 512
    anchor_0_1_bs: int = 1024
    mask_loss_weight: float = 10.0
    mesh_img_loss_weight: float = 1.0
    init_density_threshold: float = 0.05
    # logging cadence (reference: train.py kwargs)
    log_every: int = 1_000


@dataclass
class TpuParams:
    """Static capacities and backend knobs (no reference equivalent).

    The group keeps the JAX name so YAMLs load unchanged.  Tensors are padded
    to these capacities with explicit alive/valid masks.  Knobs marked
    "TPU only" are read and ignored by the port.
    """

    max_gaussians: int = 262_144          # padded Gaussian capacity
    max_verts: int = 262_144              # padded mesh-vertex capacity
    max_faces: int = 524_288              # padded mesh-face capacity
    tile_h: int = 16                      # rasterizer tile height (pixels)
    tile_w: int = 16                      # rasterizer tile width (pixels)
    max_gaussians_per_tile: int = 1024    # depth-sorted splat capacity per tile
    max_dup: int = 4_194_304              # capacity of (gaussian, tile) pairs
    max_faces_per_tile: int = 256         # mesh-raster capacity per tile
    max_face_dup: int = 2_097_152         # capacity of (face, tile) pairs
    mask_sigma: float = 1.0               # soft-silhouette bandwidth in pixels
    tile_chunk: int = 64                  # TPU only: tiles per lax.map step
    occ_res: int = 128                    # one-shot normal-init occupancy grid
    dtype: str = "float32"                # compute dtype for geometry math
    mesh_axis: str = "dev"                # device-mesh axis name for sharding
    donate: bool = True                   # donate state buffers in train_step
    use_pallas: bool = False              # TPU only: the port always runs its
                                          # CUDA compositing/shading kernels
    mr_use_pallas: bool = True            # TPU only (see use_pallas)
    dpsr_div_splat: bool = False          # 2-FFT divergence-splat DPSR path
                                          # (vs 4-FFT spectral; same surface
                                          # under the Gaussian low-pass)
    mlp_bf16: bool = False                # bf16 trunk matmuls (training only;
                                          # the render path is f32)
    mlp_fused: bool = False               # with mlp_bf16: the fused trunk
                                          # kernels (ops/mlp_fused.py)
    mlp_chunk: int = 0                    # TPU only: rows per lax.map MLP chunk
    dpsr_fft_matmul: bool = False         # TPU only: matmul-DFT Poisson solve
                                          # (the port uses torch.fft)
    mr_cull_backface: bool = False        # drop back-facing mesh triangles
                                          # before binning (marching-tets
                                          # meshes are closed with consistent
                                          # outward winding)
    mt_narrow_band: bool = False          # TPU only: narrow-band cube
                                          # compaction (the port compacts
                                          # with torch.nonzero)
    scoped_vmem_kib: int = 0              # TPU only: scoped-VMEM budget
    scan_steps: int = 1                   # TPU only: iterations per lax.scan
                                          # dispatch


_GROUPS = {
    "model": ModelParams,
    "pipeline": PipelineParams,
    "optimization": OptimizationParams,
    "tpu": TpuParams,
}


@dataclass
class Config:
    model: ModelParams = field(default_factory=ModelParams)
    pipeline: PipelineParams = field(default_factory=PipelineParams)
    optimization: OptimizationParams = field(default_factory=OptimizationParams)
    tpu: TpuParams = field(default_factory=TpuParams)

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        cfg = Config()
        for gname, gcls in _GROUPS.items():
            if gname in d and d[gname] is not None:
                grp = getattr(cfg, gname)
                for k, v in d[gname].items():
                    if hasattr(grp, k):
                        setattr(grp, k, v)
        return cfg


def _field_names(gcls) -> dict:
    return {f.name: f for f in dataclasses.fields(gcls)}


def load_yaml_config(path: str) -> dict:
    """reference: utils/system_utils.py:33-41."""
    with open(path) as f:
        return yaml.safe_load(f) or {}


def config_from_args(args: argparse.Namespace, yaml_path: Optional[str] = None) -> Config:
    """Build a Config from parsed CLI args, then apply YAML overrides on top.

    YAML values take precedence over CLI values, matching the reference's
    merge_config (utils/system_utils.py:44-51).  The YAML is flat (key: value),
    like the reference's configs/**/*.yaml.
    """
    cfg = Config()
    for gname, gcls in _GROUPS.items():
        grp = getattr(cfg, gname)
        for f in dataclasses.fields(gcls):
            if hasattr(args, f.name):
                setattr(grp, f.name, getattr(args, f.name))
    if yaml_path:
        flat = load_yaml_config(yaml_path)
        for k, v in flat.items():
            for gname, gcls in _GROUPS.items():
                if k in _field_names(gcls):
                    setattr(getattr(cfg, gname), k, v)
    return cfg
