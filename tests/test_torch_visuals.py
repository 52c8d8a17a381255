"""``Synthesizer.visuals``, what the trainer logs of each mode, against the
JAX package's, on the CPU, and the port's trainer writing them.

tests/test_torch_nets.py's tiny config as the training scripts run it: no
HD load, the scatter inversion, ctx_mode "prev" (the scripts' context, so
no context is drawn at random), B=2, every parameter leaf perturbed with
seeded noise and carried across by ``from_jax``. Both packages get the
same numpy batch.

Tolerances are the predict's (tests/test_torch_predict.py), absolute on
videos in [-1, 1], flows in normalized units, alpha maps in [-1, 1] and
poses: 1e-3 with float32 sampling, 2e-2 under "fast" (one bf16 step may
round differently on each side and be carried through a few products).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from waldo_tpu.config import to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.convert import from_jax
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.train import Logger, Trainer

from test_torch_nets import perturbed_params, tiny_cfg
from test_torch_train import train_cfg

ATOL = {"float32": 1e-3, "fast": 2e-2}
MODES = ("vid_object_extractor", "vid_pose_generator", "vid_inpainting")
# what tests/test_train.py::test_trainer_emits_visuals asks of the JAX trainer
JAX_TAGS = ("rec_vid", "real_vid", "rec_flow", "rec_obj_lyt")


def visuals_cfg(precision="float32"):
    cfg = tiny_cfg()
    cfg.load_dim = 0
    cfg.model.fast_inverse_warp = False
    cfg.model.ctx_mode = "prev"
    cfg.model.sample_precision = precision
    return cfg


def batch_np(cfg, b=2, seed=0):
    rng = np.random.RandomState(seed)
    t, nl = cfg.data.vid_len, cfg.data.num_lyt
    h, w = cfg.dim, int(cfg.dim * cfg.aspect_ratio)
    lyt = 5.0 * (2 * np.eye(nl, dtype=np.float32)[rng.randint(0, nl, (b, t, h, w))] - 1)
    return {"vid": (rng.rand(b, t, h, w, 3) * 2 - 1).astype(np.float32),
            "lyt": lyt.astype(np.float32),
            "flow": (rng.randn(b, t, h, w, 2) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def params():
    return perturbed_params(JaxSynthesizer(visuals_cfg()))


@pytest.fixture(scope="module", params=["float32", "fast"])
def visuals(request, params):
    """{mode: (JAX (arrays, pts), port (arrays, pts))} at one precision."""
    cfg = visuals_cfg(request.param)
    batch = batch_np(cfg)
    jsyn = JaxSynthesizer(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tsyn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, tsyn)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for mode in MODES:
        want = jax.jit(lambda p, b: jsyn.visuals(mode, p, b, jax.random.PRNGKey(1)))(
            jparams, jbatch)
        out[mode] = (jax.device_get(want), tsyn.visuals(mode, tbatch))
    return request.param, out


@pytest.mark.parametrize("mode", MODES)
def test_visuals_match_jax(visuals, mode):
    precision, out = visuals
    (jarr, jpts), (tarr, tpts) = out[mode]
    assert sorted(tarr) == sorted(jarr) and sorted(tpts) == sorted(jpts)  # jit sorts keys
    for kind, got, want in [("arrays", tarr, jarr), ("pts", tpts, jpts)]:
        for key in want:
            w = np.asarray(want[key], np.float32)
            g = got[key].float().numpy()
            assert g.shape == w.shape, (key, g.shape, w.shape)
            assert np.isfinite(g).all(), key
            err = float(np.abs(g - w).max())
            assert err <= ATOL[precision], f"{mode} {key} ({precision}): max|err| {err:.3g}"


def test_visuals_render_every_tag(params, tmp_path):
    """The port's payload of each mode through the port's Logger, as the
    trainer hands it over: every array and the points are images."""
    cfg = visuals_cfg()
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, syn)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    out = {mode: syn.visuals(mode, batch) for mode in MODES}
    lg = Logger(str(tmp_path))
    for mode, (arrays, pts) in out.items():
        host = lambda d: {k: v[:2].float().numpy() for k, v in d.items()}
        lg.log_visuals(f"{mode}/train", host(arrays), host(pts), 0, palette=cfg.data.palette,
                       pts_geometry=(cfg.dim, cfg.width_size), ctx_len=cfg.model.ctx_len)
    lg.close()
    acc = EventAccumulator(str(tmp_path), size_guidance={"images": 0})
    acc.Reload()
    tags = set(acc.Tags()["images"])
    for mode, (arrays, pts) in out.items():
        want = {f"{mode}/train/{k.split('/', 1)[1]}" for k in arrays}
        want |= {f"{mode}/train/{p}{r}" for p in ("", "pred_") if f"{p}obj_pts" in pts
                 for r in ("pts", "mot")}
        assert want <= tags, sorted(want - tags)
    assert {"vid_pose_generator/train/pred_pts", "vid_inpainting/train/coverage",
            "vid_inpainting/train/inp_vid"} <= tags


def test_trainer_emits_visuals(tmp_path, capsys):
    """tests/test_train.py::test_trainer_emits_visuals for the port: one
    logged iteration writes the visual tags and the training scalars."""
    cfg = train_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    tr.run(num_iter=1)
    tr.logger.close()
    assert "could not render" not in capsys.readouterr().out
    acc = EventAccumulator(cfg.log_path, size_guidance={"images": 0})
    acc.Reload()
    img_tags = acc.Tags().get("images", [])
    for name in JAX_TAGS:
        assert any(name in t for t in img_tags), (name, img_tags)
    assert any("/pts" in t or "/mot" in t for t in img_tags), img_tags
    scalars = acc.Tags()["scalars"]
    assert "vid_object_extractor/train/loss" in scalars, scalars
    assert [e.step for e in acc.Scalars("vid_object_extractor/train/loss")] == [0]


def test_trainer_logs_eval_means_without_visuals(tmp_path):
    """Without log_freq a logged iteration writes scalars only; an eval
    writes its means under "vid/eval"."""
    cfg = train_cfg(tmp_path, log_freq=None, num_iter_eval=1, max_batch_eval_vid=1)
    tr = Trainer(cfg, device="cpu")
    tr.run(num_iter=2)
    tr.logger.close()
    acc = EventAccumulator(cfg.log_path, size_guidance={"images": 0})
    acc.Reload()
    assert acc.Tags()["images"] == []
    assert [e.step for e in acc.Scalars("vid/eval/loss")] == [1]
    assert [e.step for e in acc.Scalars("vid_object_extractor/train/loss")] == [0, 1]
