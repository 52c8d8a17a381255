"""Training loop (counterpart of waldo_tpu/train/trainer.py).

Iteration-based: one step per active mode per iteration, periodic eval with
a metric-gated "best_vid" checkpoint, periodic "latest" and numbered
checkpoints, ``cont_train`` resume. Ported modes: vid_object_extractor and
img_object_extractor (LVD), vid_pose_generator (FLP) and vid_inpainting (WIF,
without the GAN losses ``adv`` and ``dis``). Only the nets of the run's
modes take optimizer steps; the others (FLP's and WIF's LVD teacher,
restored from ``--s_load_path``) are frozen: their parameters ask for no
gradient. Every net is saved. The batches come from the prefetching loader,
``cfg.data.num_workers`` threads making the clips. The TensorBoard logger and
its visuals are not ported yet: ``logger`` is None, as on a JAX process
other than the first.
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
from ..utils.heartbeat import beat
from .checkpoint import CheckpointManager, normalize_which
from .train_state import NetState

MODE_TO_NET = {
    "vid_object_extractor": "pe",
    "img_object_extractor": "pe",
    "vid_pose_generator": "pg",
    "vid_inpainting": "ii",
}


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self._train_modes = list(cfg.vid_modes) + list(cfg.img_modes)
        for mode in self._train_modes:
            if mode not in MODE_TO_NET:
                raise ValueError(f"unknown training mode {mode!r}")
        gan = sorted({"adv", "dis"} & set(cfg.model.vid_inpainting_losses))
        if "vid_inpainting" in self._train_modes and gan:
            raise NotImplementedError(f"the GAN losses {gan} of vid_inpainting are not ported "
                                      f"yet (ROADMAP.md queue 1 item 7)")
        self.syn = Synthesizer(cfg, device=device, seed=cfg.seed)
        self.device = self.syn.device
        self.ckpt = CheckpointManager(cfg.checkpoint_path)
        self.logger = None
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
        # context lengths and training noise)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.train_loader = None
        self.valid_loader = None
        self._best_vid = None

    # -- checkpoint wiring --

    def _maybe_restore(self):
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
                print(f"[ckpt] restored {label} ({which}) from "
                      f"{load_path or self.cfg.checkpoint_path}")
            except FileNotFoundError:
                print(f"[ckpt] no checkpoint for {label}, training from scratch")
        if restored:
            from_jax(trees, self.syn)

    def save(self, it, name=None):
        for net, tree in to_jax(self.syn).items():
            self.ckpt.save(net, tree, it, name=name)

    # -- steps --

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

    def _loss(self, mode, batch, it, generator):
        if mode == "vid_pose_generator":
            return self.syn.generate_pose_loss(batch, it, generator=generator)
        if mode == "vid_inpainting":
            return self.syn.inpaint_loss(batch, it, generator=generator)
        return self.syn.extract_object_loss(batch, it, is_img=mode.startswith("img"),
                                            generator=generator)

    def step(self, mode, batch, it):
        """One optimizer step of ``mode``'s net on a batch of device tensors.
        Returns its metrics as 0-d device tensors, with ``nancount``."""
        state = self.states[MODE_TO_NET[mode]]
        state.zero_grad()
        loss, metrics = self._loss(mode, batch, it, self.generator)
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
        print("Training was successfully finished.")

    def evaluate(self, it):
        """Mean metrics of the vid modes over the eval phase (at most
        max_batch_eval_vid batches); a lower ``vid_metric`` than the best so
        far saves the "best_vid" slot."""
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
        print(f"[EVAL] iter {it}: " + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
        metric = cfg.vid_metric
        if metric and metric in means:
            score = means[metric]
            if self._best_vid is None or score < self._best_vid:
                self._best_vid = score
                self.save(it, name="best_vid")
                print(f"[EVAL] new best_vid ({metric}={score:.4f})")
        return means
