"""Typed configuration, the port's own copy of ``waldo_tpu/config.py``.

Field names and defaults match the JAX package one for one (a test holds
them equal), so a config converts across with ``to_dict``/``from_dict``.
``parse_cli`` reads the launch scripts' flags (``--s_num_obj 16``,
``--data.vid_len 14``, ...) as the JAX package's parser does;
``flagship_cfg`` builds the flagship Cityscapes predict configuration
directly and ``flagship_mat_cfg`` the same with the MAT inpainting flags of
scripts/cityscapes/test_mat.sh.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DataConfig:
    dataroot: str = "datasets"
    dataset: str = "synthetic"
    num_lyt: int = 20
    lyt_model: str = "deeplabv3"
    flow_model: str = "raft"
    fg_idx: List[int] = field(default_factory=list)
    bg_idx: List[int] = field(default_factory=list)
    other_idx: List[int] = field(default_factory=list)
    palette: Optional[List[int]] = None
    remap_lyt: List[int] = field(default_factory=list)  # src1 tgt1 src2 tgt2 ...
    vid_len: int = 14
    load_vid_len: Optional[int] = None
    load_n_plus_1: bool = False
    max_vid_step: int = 1000
    skip_first: bool = False
    load_lyt: bool = True
    load_flow: bool = True
    load_all: bool = False
    one_every_n: int = 1
    # video-file branch + dataset caches (reference base_dataset.py:29-70)
    from_vid: bool = False
    vid_skip: int = 1
    load_data: bool = False
    save_data: bool = False
    data_specs: Optional[str] = None
    force_compute_metadata: bool = False
    # augmentation
    no_h_flip: bool = True
    no_v_flip: bool = True
    min_zoom: float = 1.0
    max_zoom: float = 1.0
    colorjitter: Optional[float] = None
    colorjitter_no_contrast: bool = False
    shuffle_valid: bool = False
    num_workers: int = 8
    eval_phase: str = "valid"  # train | valid | test
    # fold mechanism for huge datasets (reference helpers/__init__.py:5-27):
    # the clip index is split into num_folds interleaved shards and training
    # cycles to the next fold at each epoch boundary
    num_folds_train: Optional[int] = None
    init_fold_train: int = 0


@dataclass
class ModelConfig:
    """The `s_*` namespace (tools/options.py:193-603), reference flag names."""

    patch_size: int = 16
    latent_shape: Tuple[int, int] = (8, 16)
    obj_shape: Tuple[int, int] = (4, 4)
    embed_dim: int = 512
    num_heads: int = 8
    num_obj: int = 16
    num_timesteps: int = 16
    norm_layer: str = "ln"
    norm_layer_patch: str = "ln2d"
    dropout: float = 0.0
    scale_factor: int = 1

    # module toggles
    use_pe: bool = True
    use_pg: bool = False
    use_ii: bool = False
    use_id: bool = False
    use_inpainter: bool = False

    # LVD
    oe_depth: int = 2
    oe_num_timesteps: int = 5
    pe_depth: int = 2
    pe_pts_mode: str = "prior"
    pe_estimator_init_mode: str = "zero"
    pe_decoder_init_mode: str = "five"
    pe_decoder_use_prior: bool = False
    decompose_embed_oe: bool = False
    pred_cls: bool = True
    weight_cls: bool = True
    min_cls: float = 0.1
    has_bg: bool = True
    fix_bg: bool = False
    fix_bg1: bool = False
    bg_mul: float = 1.2
    pad_obj_alpha: int = 3
    pad_bg_alpha: int = 3
    bound_rest: bool = True
    soft_bound_rest: bool = True
    min_scale_bound: float = -0.5
    max_scale_bound: float = 0.5
    max_translate_bound: float = 0.5
    norm_scale: bool = False
    bound_scale: bool = False
    min_scale: float = 0.0
    max_scale: float = 2.0
    tgt_scale: float = 1.0
    use_delta: bool = True
    init_scale_obj: float = 0.25
    mul_scale_obj: float = 0.25
    mul_delta_obj: float = 0.2
    circle_translate_bias: bool = True
    circle_translate_radius: float = 0.2
    rd_translate_bias: bool = False
    translate_bias_mul: float = 1.0
    occ_mode: str = ""  # "" | bias | normalize | freeze
    time_dropout: bool = False
    freeze_obj: bool = False
    remove_obj: bool = False
    use_disocc: bool = False
    include_self: bool = True
    restrict_to_ctx: bool = False
    no_filter: bool = False
    allow_ghost: bool = False
    # opt-in iterative (gather-based) warp-grid inversion: a documented
    # deviation from the reference's scatter+dilate inversion
    fast_inverse_warp: bool = False
    # precision of the big alpha/fusion maps: "fast" stores the alpha and
    # warped-context maps in bf16 (the flagship setting) or "float32"
    sample_precision: str = "fast"
    use_lyt_filtering: bool = True
    use_lyt_opacity: bool = True
    swap_flt: bool = True
    ctx_mode: str = "prev"  # full | prev | prev_rd
    rd_ctx_num: int = 1
    ctx_len: int = 4
    last_n_ctx: int = 0

    # inputs
    input_rgb: bool = False
    input_lyt: bool = True
    input_flow: bool = True
    drop_input_p: float = 0.0

    # FLP
    pg_com_depth: int = 2
    pg_enc_depth: int = 4
    pg_dec_depth: int = 4
    pg_num_timesteps: int = 14
    pg_embed_noise: bool = False
    pg_inject_noise: bool = False
    pg_modulate_noise: bool = False
    cat_z: bool = True
    zero_init_dec: bool = True
    use_last_pose_decoder: bool = True
    unconstrained_pose_decoder: bool = True
    bg_mul_pose_decoder: float = 1.2
    min_ctx_length_vid: int = 4
    max_ctx_length_vid: int = 4

    # WIF
    ii_depth: int = 6
    ii_embed_dim: int = 512
    ii_score: bool = True
    ii_ab: bool = True
    # reproduce the reference's gate-from-input-channel defect (wif.py:53)
    # exactly — needed when running converted reference checkpoints, since
    # those were *trained* with that gate. Default: our fixed gate (UNet's
    # 5th output channel, the evident intent of wif.py:22).
    ii_ref_gate: bool = False
    loop_ii: bool = False
    no_future: bool = False

    # losses (per released mode)
    vid_object_extractor_losses: List[str] = field(
        default_factory=lambda: ["ent_flt_edge", "l1_flow", "cell_dis", "reg_mov"]
    )
    vid_pose_generator_losses: List[str] = field(
        default_factory=lambda: ["rec_obj_pose", "rec_bg_pose", "rec_occ_score"]
    )
    vid_inpainting_losses: List[str] = field(default_factory=lambda: ["sharp_vid", "lpips_vid"])

    # loss hyperparameters
    lambda_obj_flow: float = 1.0
    lambda_activity: float = 1.0
    lambda_ent: float = 1.0
    lambda_ent_flt: float = 1.0
    lambda_ent_flt_edge: float = 1.0
    lambda_reg_mov: float = 10.0
    lambda_reg_fg: float = 1.0
    lambda_abs_mov: float = 1.0
    lambda_cell_dis: float = 10.0
    lambda_center_dis: float = 1.0
    lambda_l1_flow: float = 1000.0
    lambda_ce_lyt: float = 1.0
    lambda_ce_lyt_obj: float = 1.0
    lambda_soft_ce_lyt: float = 1.0
    lambda_pxl_vid: float = 1.0
    lambda_sharp_vid: float = 1.0
    lambda_lpips_vid: float = 1.0
    lambda_pts_reg: float = 1.0
    lambda_pts_rest: float = 20.0
    lambda_rec_obj_pose: float = 1.0
    lambda_rec_bg_pose: float = 1.0
    lambda_rec_occ_score: float = 0.01
    lambda_adv: float = 1.0
    lambda_dis: float = 1.0
    use_adaptive_lambda: bool = False
    cell_dis_eps: float = 0.0
    reg_bg_mul: float = 0.25
    img_mul_act_reg: float = 1.0
    warmup_reg_mov_iter: int = 0
    warmup_reg_mov_mul: int = 100
    warmup_l1_flow_iter: int = 0
    warmup_l1_flow_mul: int = 100
    warmup_pxl_vid_iter: int = 0
    warmup_sharp_vid_iter: int = 0
    cosine_warmup_pxl_vid: bool = False
    ada_pts_rest: bool = False
    ada_pts_rest_detach: bool = False

    # loss-shaping toggles
    blur_pxl: bool = True
    blur_alpha: bool = False
    blur_sigma: float = 2.0
    l1_pxl: bool = True
    edge_size: int = 15
    flow_thresh: float = 0.02
    mov_obj_thresh: float = 0.005
    use_dominant_flow_other: bool = True
    use_flow_nobg: bool = False
    use_fg: bool = True
    use_nobg: bool = False
    use_nobg_edge: bool = False
    nobg_edge_mul: float = 0.0

    # optimizer
    optimizer: str = "adam"
    lr: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.99
    wd: float = 0.0
    clip_value: float = 0.0
    use_amp: bool = False

    # checkpoint loading
    load_path: Optional[str] = None
    which_iter: Optional[str] = None
    pg_load_path: Optional[str] = None
    pg_iter: Optional[str] = None
    ii_load_path: Optional[str] = None
    ii_iter: Optional[str] = None
    inpainter_path: Optional[str] = None

    # MAT / test_mat.sh path
    inpaint_obj: bool = False
    propagate_unique: bool = False
    use_shadows: bool = False
    use_expansion: bool = False
    soft_shadow: bool = False
    propagate_obj: bool = False
    use_mat_inpainter: bool = False
    ii_last_only: bool = False
    fix_thresh: bool = False
    fix_mask: bool = False
    num_expansion: int = 2


@dataclass
class Config:
    name: str = "exp"
    datetime: str = ""
    save_path: str = "./"
    seed: int = 0

    # image geometry
    dim: int = 128
    load_dim: int = 0
    true_dim: int = 128
    flow_dim: int = 0
    aspect_ratio: float = 2.0

    # training cadence
    num_iter: int = 1000
    batch_size_vid: int = 1
    batch_size_img: int = 1
    vid_modes: List[str] = field(default_factory=lambda: ["vid_object_extractor"])
    img_modes: List[str] = field(default_factory=list)
    num_iter_eval: Optional[int] = None
    max_batch_eval_vid: Optional[int] = None
    save_latest_freq: int = 1000
    save_freq: int = -1
    log_freq: Optional[int] = None
    vid_metric: str = ""
    cont_train: bool = False

    # parallelism fields, kept for config round-trips with the JAX package:
    # the port's world size comes from the launcher, and the shape's product
    # must equal it (check_mesh; parallel/mesh.py)
    mesh_shape: Optional[List[int]] = None  # default: all devices on "data"
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    compute_dtype: str = "float32"  # or "bfloat16"

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    # ---- derived ----
    @property
    def signature(self) -> str:
        return f"{self.datetime}-{self.name}" if self.datetime else self.name

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.save_path, "checkpoints", self.signature)

    @property
    def log_path(self) -> str:
        return os.path.join(self.save_path, "logs", self.signature)

    @property
    def result_path(self) -> str:
        return os.path.join(self.save_path, "results", self.signature)

    @property
    def width_size(self) -> int:
        return int(self.dim * self.aspect_ratio)

    @property
    def height_size(self) -> int:
        return self.dim

    @property
    def scale_hd(self) -> float:
        return self.load_dim / self.dim if self.load_dim > 0 else 1.0

    def finalize(self) -> "Config":
        if self.dim & (self.dim - 1):
            raise ValueError(f"dim {self.dim} must be a power of two")
        if not self.datetime:
            self.datetime = time.strftime("%Y-%m-%d-%H:%M:%S")
        return self


_DATASET_DEFAULTS = {
    "cityscapes": dict(
        dataroot="datasets/cityscapes",
        num_lyt=20,
        fg_idx=[0, 4, 5, 6, 7, 8, 12, 13, 14, 15, 16, 17, 18, 19],
        bg_idx=[1, 2, 3, 10, 11],
        other_idx=[9],
    ),
    "kitti": dict(
        dataroot="datasets/kitti",
        num_lyt=19,
        fg_idx=[3, 4, 5, 6, 7, 11, 12, 13, 14, 15, 16, 17, 18],
        bg_idx=[0, 1, 2, 9, 10],
        other_idx=[8],
    ),
}

_DATASET_BASE_DEFAULTS = {
    "cityscapes": dict(aspect_ratio=2.0, true_dim=1024),
    "kitti": dict(aspect_ratio=3.25, true_dim=375),
}


def apply_dataset_defaults(cfg: Config) -> Config:
    """Dataset-conditional defaults (reference tools/options.py:605-647)."""
    name = cfg.data.dataset
    for k, v in _DATASET_DEFAULTS.get(name, {}).items():
        setattr(cfg.data, k, v)
    for k, v in _DATASET_BASE_DEFAULTS.get(name, {}).items():
        setattr(cfg, k, v)
    return cfg



def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(d: dict) -> Config:
    d = dict(d)
    data = DataConfig(**d.pop("data", {}))
    model_d = dict(d.pop("model", {}))
    for k in ("latent_shape", "obj_shape"):
        if k in model_d and model_d[k] is not None:
            model_d[k] = tuple(model_d[k])
    model = ModelConfig(**model_d)
    return Config(data=data, model=model, **d)


def save_config(cfg: Config, path: Optional[str] = None) -> str:
    path = path or os.path.join(cfg.checkpoint_path, "config.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    return path


def load_config(path: str) -> Config:
    with open(path) as f:
        return from_dict(json.load(f))


def _auto(raw: str):
    """Best-effort scalar coercion for untyped (None / empty-list) defaults."""
    for typ in (int, float):
        try:
            return typ(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    if raw.lower() in ("none", "null"):
        return None
    return raw


def _coerce(current, raw: str):
    """``raw`` in the type of the field's current value."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (list, tuple)):
        parts = raw.split(",") if "," in raw else raw.split()
        if len(current):
            typ = type(current[0])
            out = [typ(p) for p in parts]
        else:
            out = [_auto(p) for p in parts]
        return tuple(out) if isinstance(current, tuple) else out
    if current is None:
        return _auto(raw)
    return raw


def _truthy(raw: Optional[str]) -> bool:
    return raw is not None and raw.lower() in ("1", "true", "yes")


def _find_run_config(save_path: str, name: str) -> Optional[str]:
    """A run's saved config.json by name, the newest first."""
    hits = glob.glob(os.path.join(save_path, "checkpoints", f"*-{name}", "config.json"))
    hits += glob.glob(os.path.join(save_path, "checkpoints", name, "config.json"))
    hits = [h for h in hits if os.path.isfile(h)]
    return max(hits, key=os.path.getmtime) if hits else None


def parse_cli(argv: Optional[List[str]] = None, base: Optional[Config] = None) -> Config:
    """Parse ``--key value`` overrides onto a Config.

    Nested fields are addressed as ``--data.dataset cityscapes`` or
    ``--model.num_obj 16``; model fields may also use the reference's
    ``--s_`` prefix (``--s_num_obj 16``); a bare name is looked up on the
    Config, then its model, then its data. ``--config path.json`` loads a
    snapshot first; ``--cont_train`` with ``--name`` reloads that run's
    newest snapshot; ``--dataset name`` applies the dataset's defaults before
    the other overrides. A flag with no value is true."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = base or Config()

    kv = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --key, got {tok!r}")
        key = tok[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            val = argv[i + 1]
            i += 2
        else:
            val = "true"
            i += 1
        kv[key] = val

    if "config" in kv:
        cfg = load_config(kv.pop("config"))
    elif _truthy(kv.get("cont_train")):
        snap = _find_run_config(kv.get("save_path", cfg.save_path), kv.get("name", cfg.name))
        if snap:
            cfg = load_config(snap)
    if "dataset" in kv:
        cfg.data.dataset = kv.pop("dataset")
        apply_dataset_defaults(cfg)

    for key, raw in kv.items():
        if key.startswith("s_"):
            key = "model." + key[2:]
        parts = key.split(".")
        if len(parts) == 1:
            for target in (cfg, cfg.model, cfg.data):
                if hasattr(target, parts[0]):
                    break
            else:
                raise KeyError(f"unknown config key: {key}")
        else:
            target = cfg
            for part in parts[:-1]:
                target = getattr(target, part)
            if not hasattr(target, parts[-1]):
                raise KeyError(f"unknown config key: {key}")
        attr = parts[-1]
        if attr == "mesh_shape":  # a list of ints in a field whose default is None
            setattr(target, attr, None if raw.lower() in ("none", "null") else
                    [int(p) for p in raw.replace(",", " ").split()])
            continue
        setattr(target, attr, _coerce(getattr(target, attr), raw))
    return cfg.finalize()
