"""Training loop (counterpart of waldo_tpu/train/trainer.py).

Iteration-based: one step per active mode per iteration, periodic eval with
a metric-gated "best_vid" checkpoint, periodic "latest" and numbered
checkpoints, ``cont_train`` resume. Modes: vid_object_extractor and
img_object_extractor (LVD), vid_pose_generator (FLP), vid_inpainting (WIF,
with the adversarial term when ``adv`` is among its losses) and, when
``dis`` is, vid_inpainting_dis (the discriminator "id"), which steps after
vid_inpainting in every iteration, as in the JAX package. Each mode's step
takes a loader batch of its own, so a GAN iteration pulls two. Only the
nets of the run's modes take optimizer steps; the others (FLP's and WIF's
LVD teacher, restored from ``--s_load_path``) are frozen: their parameters
ask for no gradient. Every net is saved; a resume restores "pe", "pg" and
"ii" but not "id", as the JAX trainer does, so a resumed GAN run starts its
discriminator anew. The batches come from the prefetching loader,
``cfg.data.num_workers`` threads making the clips. The TensorBoard logger
(train/logger.py) writes under ``cfg.log_path``: each logged iteration's
training metrics under "<mode>/train", the eval means under "vid/eval" and,
when ``cfg.log_freq`` is set, ``Synthesizer.visuals`` of the first two clips
(never for img_object_extractor, nor for vid_inpainting_dis, whose visuals
the JAX package's ``Synthesizer.visuals`` refuses). The visuals run on the
device outside any ``try``, so a fault there raises; only their rendering on
the host is caught.

Under torchrun (cli/train.py) it runs data-parallel, one process per card
(parallel/mesh.py): each rank steps on its rows of the global batch
``cfg.batch_size_vid`` and the step reduces the gradients over the ranks
(train_state.py). Rank 0's ``cfg.datetime`` names the run on every rank;
rank 0 alone builds the logger, saves the config and the checkpoints, and
prints, and the ranks wait for each save. Logged training metrics and the
eval means are means over the ranks, so every rank takes the same
"best_vid" decision; ``nancount`` is the same on every rank, so the abort
after 10 skipped steps is too.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, save_config
from ..convert import from_jax, to_jax
from ..data import DataLoader, InfiniteLoader, create_dataset
from ..models import Synthesizer
from ..parallel import mesh
from ..utils.heartbeat import beat
from .checkpoint import CheckpointManager, normalize_which
from .logger import Logger
from .train_state import NetState

MODE_TO_NET = {
    "vid_object_extractor": "pe",
    "img_object_extractor": "pe",
    "vid_pose_generator": "pg",
    "vid_inpainting": "ii",
    "vid_inpainting_dis": "id",
}


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        device = mesh.setup(cfg, device)
        self.is_main = mesh.is_main()
        if self.is_main and mesh.distributed():
            print(f"[dist] {mesh.backend()} process group of {mesh.world_size()}; global batch "
                  f"{cfg.batch_size_vid}", flush=True)
        self.cfg = cfg
        self._train_modes = list(cfg.vid_modes) + list(cfg.img_modes)
        for mode in self._train_modes:
            if mode not in MODE_TO_NET:
                raise ValueError(f"unknown training mode {mode!r}")
        # the discriminator's step follows the generator's
        if "vid_inpainting" in self._train_modes and "dis" in cfg.model.vid_inpainting_losses:
            self._train_modes.append("vid_inpainting_dis")
        self.syn = Synthesizer(cfg, device=device, seed=cfg.seed)
        self.device = self.syn.device
        self.ckpt = CheckpointManager(cfg.checkpoint_path)
        self.logger = Logger(cfg.log_path) if self.is_main else None
        if self.is_main:
            save_config(cfg)
        self._maybe_restore()
        trained = {MODE_TO_NET[mode] for mode in self._train_modes}
        self.states: Dict[str, NetState] = {}
        for net, module in self.syn.nets().items():
            if net in trained:
                self.states[net] = NetState(module, cfg.model)
            else:
                module.requires_grad_(False)
        # the losses' random draws (input dropout, "prev_rd" contexts, FLP's
        # context lengths and training noise), made alike on every rank at
        # the global batch's shape
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.train_loader = None
        self.valid_loader = None
        self._best_vid = None

    # -- checkpoint wiring --

    def _maybe_restore(self):
        # "id" is not restored, as in the JAX trainer
        m = self.cfg.model
        specs = [("pe", m.load_path, m.which_iter), ("pg", m.pg_load_path, m.pg_iter),
                 ("ii", m.ii_load_path, m.ii_iter)]
        trees = to_jax(self.syn)
        restored = False
        for label, load_path, which in specs:
            if label not in trees or not (load_path or self.cfg.cont_train):
                continue
            which = normalize_which(which)
            try:
                trees[label] = self.ckpt.restore(label, trees[label], which=which,
                                                 load_path=load_path)
                restored = True
                if self.is_main:
                    print(f"[ckpt] restored {label} ({which}) from "
                          f"{load_path or self.cfg.checkpoint_path}")
            except FileNotFoundError:
                if self.is_main:
                    print(f"[ckpt] no checkpoint for {label}, training from scratch")
        if restored:
            from_jax(trees, self.syn)

    def save(self, it, name=None):
        """Rank 0 writes every net's slot; every rank waits for it."""
        if self.is_main:
            for net, tree in to_jax(self.syn).items():
                self.ckpt.save(net, tree, it, name=name)
        mesh.barrier()

    # -- steps --

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def _loss(self, mode, batch, it, generator, train=False):
        # the batch is this rank's rows of the global batch
        shard = mesh.BatchShard.of_rank(batch["vid"].shape[0])
        if mode == "vid_pose_generator":
            return self.syn.generate_pose_loss(batch, it, generator=generator, shard=shard)
        if mode == "vid_inpainting":  # the adversarial term in training only
            return self.syn.inpaint_loss(batch, it, generator=generator, shard=shard, adv=train)
        if mode == "vid_inpainting_dis":
            return self.syn.discriminate_loss(batch, it, generator=generator, shard=shard)
        return self.syn.extract_object_loss(batch, it, is_img=mode.startswith("img"),
                                            generator=generator, shard=shard)

    def step(self, mode, batch, it):
        """One optimizer step of ``mode``'s net on a batch of device tensors
        (the rank's rows). Returns its metrics, the rank's, as 0-d device
        tensors, with ``nancount``."""
        state = self.states[MODE_TO_NET[mode]]
        state.zero_grad()
        loss, metrics = self._loss(mode, batch, it, self.generator, train=True)
        loss.backward()
        state.apply(loss)
        metrics["nancount"] = state.nancount.clone()
        return metrics

    @torch.no_grad()
    def _eval_metrics(self, mode, batch, generator):
        return self._loss(mode, batch, 0, generator)[1]

    # -- loop --

    def run(self, num_iter: Optional[int] = None):
        cfg = self.cfg
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        fold_kw = {}
        if cfg.data.num_folds_train:
            fold_kw = dict(num_folds=cfg.data.num_folds_train, fold=cfg.data.init_fold_train)
        train_ds = create_dataset(cfg, phase="train", **fold_kw)
        self.train_loader = InfiniteLoader(
            DataLoader(train_ds, cfg.batch_size_vid, shuffle=True, seed=cfg.seed,
                       num_workers=cfg.data.num_workers))
        eval_every = cfg.num_iter_eval
        self._best_vid = None
        start_iter = 0
        if cfg.cont_train:
            nets = [MODE_TO_NET[m] for m in self._train_modes]
            it = self.ckpt.latest_iter(nets[0] if nets else "pe")
            start_iter = (it + 1) if it is not None else 0

        t_start = time.time()
        try:
            for it in range(start_iter, num_iter):
                if self.is_main:
                    beat(it)  # liveness signal for a supervisor's stall watchdog
                log = (cfg.log_freq and it % cfg.log_freq == 0) or it < 10 or (
                    it < 1000 and it % 100 == 0)
                for mode in self._train_modes:
                    batch = self._to_device(self.train_loader.next())
                    metrics = self.step(mode, batch, it)
                    # nancount is read only now and then: a read waits for the
                    # card. It resets only on a finite step, so a run of
                    # non-finite losses is still caught (and skipped meanwhile)
                    if (log or it % 25 == 0) and int(metrics["nancount"]) > 10:
                        raise ValueError(f"loss NaN for >10 consecutive steps in {mode}")
                    if log:
                        metrics = mesh.mean_over_ranks(metrics, self.device)
                    if log and self.logger:
                        self.log_iteration(mode, batch, metrics, it)
                if log and self.is_main:
                    print(f"Iteration {it:05d}/{num_iter:05d} ({time.time() - t_start:.1f}s)",
                          flush=True)
                if eval_every and it > 0 and it % eval_every == 0:
                    self.evaluate(it)
                if cfg.save_latest_freq > 0 and it % cfg.save_latest_freq == 0:
                    self.save(it, name="latest")
                if cfg.save_freq > 0 and it % cfg.save_freq == 0:
                    self.save(it)
        finally:
            self.train_loader.close()  # stops the producer thread
        self.save(num_iter - 1, name="latest")
        if self.is_main:
            print("Training was successfully finished.")

    def evaluate(self, it):
        """Mean metrics of the vid modes over the eval phase (at most
        max_batch_eval_vid global batches), over the ranks too; a lower
        ``vid_metric`` than the best so far saves the "best_vid" slot."""
        cfg = self.cfg
        if self.valid_loader is None:
            ds = create_dataset(cfg, phase=cfg.data.eval_phase)
            self.valid_loader = DataLoader(ds, cfg.batch_size_vid, shuffle=False,
                                           num_workers=cfg.data.num_workers)
        agg = {}
        generator = torch.Generator(device=self.device).manual_seed(0)
        for i, batch in enumerate(self.valid_loader):
            batch = self._to_device(batch)
            for mode in cfg.vid_modes:
                for k, v in self._eval_metrics(mode, batch, generator).items():
                    agg.setdefault(k, []).append(float(v))
            if cfg.max_batch_eval_vid is not None and i + 1 >= cfg.max_batch_eval_vid:
                break
        means = {k: float(np.mean(v)) for k, v in agg.items()}
        means = {k: float(v) for k, v in mesh.mean_over_ranks(means, self.device).items()}
        if self.logger:
            self.logger.log_scalars("vid/eval", means, it)
        if self.is_main:
            print(f"[EVAL] iter {it}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
        metric = cfg.vid_metric
        if metric and metric in means:
            score = means[metric]
            if self._best_vid is None or score < self._best_vid:
                self._best_vid = score
                self.save(it, name="best_vid")
                if self.is_main:
                    print(f"[EVAL] new best_vid ({metric}={score:.4f})")
        return means

    # -- logging --

    def log_iteration(self, mode, batch, metrics, it):
        """A logged iteration of ``mode``: its metrics as scalars and, at
        the explicit log cadence (``cfg.log_freq`` set), its visuals."""
        self.logger.log_scalars(f"{mode}/train", {k: float(v) for k, v in metrics.items()}, it)
        if self.cfg.log_freq:
            self.log_visuals(mode, batch, it)

    def log_visuals(self, mode, batch, it, max_items=2):
        """``Synthesizer.visuals`` of the batch, its first ``max_items``
        clips copied to the host and rendered by the logger. The contexts of
        "prev_rd" come from a generator of their own, seeded by the
        iteration, so logging does not move the training draws."""
        if mode in ("img_object_extractor", "vid_inpainting_dis"):
            # image batches lack the video shapes the renderers expect; the
            # discriminator's mode has no visuals (the JAX trainer's call
            # raises ValueError inside its try and prints a line)
            return
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed + it)
        arrays, pts = self.syn.visuals(mode, batch, generator=generator)
        host = lambda d: {k: v[:max_items].float().cpu().numpy() for k, v in d.items()}
        cfg = self.cfg
        self.logger.log_visuals(f"{mode}/train", host(arrays), host(pts), it,
                                palette=cfg.data.palette, max_items=max_items,
                                pts_geometry=(cfg.dim, cfg.width_size),
                                ctx_len=cfg.model.ctx_len)
