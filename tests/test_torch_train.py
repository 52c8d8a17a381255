"""The LVD training slice, the port against the JAX package, on the CPU: the
loss ``extract_object_loss`` (metrics and per-leaf gradients), the
optimizer step, the checkpoints, the trainer, the config parser and the
synthetic data, at tests/test_models_smoke.tiny_config()'s scale.

The JAX side's gradients run under ``set_impl("gather")``: the MXU VJP,
which the JAX package takes by default on the CPU, differentiates another
way where a sample sits exactly on a texel centre, as the per-layer grids
of a zero flow do (ROADMAP.md section 3); the port and the gather path take
torch's one-sided derivative there.

Tolerances:
  metrics, float32: 1e-6 + 2e-4 x |value|. The scatter inversion's fill and
           the samplers sum in another order (~1e-6 on a grid), which the
           entropies' logs and the layout softmaxes carry to ~5e-5 relative.
  metrics, "fast": 1e-5 + 2e-3 x |value|: both sides store the alpha maps
           and the warped frames in bf16 at the same places, and one bf16
           step (2^-8) may round differently on each side.
  gradients: per leaf, 5e-3 x max|JAX leaf| + 1e-6 x max over all leaves,
           in float32 and "fast" (a leaf whose gradient is ~1e-8, the alpha
           decoder's norms, is held to the second term).
  two Adam steps: 2e-6 on 99.9 % of each leaf's elements, and on every
           element at most the 4e-4 two steps can move it. An update is lr =
           1e-4 times g / (|g| + eps) at step 1 (betas (0, 0.99)), so a
           gradient's relative error enters at ~1e-4 x 5e-3, but an element
           whose gradient is near 0 (~eps) may take another direction.
The loss's hard thresholds (the blurred layout's edge mask, the flow-edge
and moving-object masks) read only the data, which both sides share; at
these seeds no pixel of them falls on the other side.
"""
import importlib
import json
import os
import random
import shlex

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import waldo_tpu.config as jconfig
from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.config import from_dict, parse_cli, to_dict
from waldo_tpu_torch.convert import from_jax, to_jax
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.train import CheckpointManager, NetState, Trainer, normalize_which
from waldo_tpu_torch.train.checkpoint import _flatten

from test_models_smoke import tiny_batch, tiny_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

jgs = importlib.import_module("waldo_tpu.ops.grid_sample")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_losses.json")
with open(GOLDEN) as _fh:
    GOLDEN_KEYS = sorted(json.load(_fh)["extract_object"])
METRICS = ("abs_mov", "activity", "ce_lyt", "ce_lyt_obj", "cell_dis", "center_dis", "ent",
           "ent_flt", "ent_flt_edge", "l1_flow", "loss", "obj_flow", "pts_reg_bg", "pts_reg_obj",
           "pts_rest_bg", "pts_rest_obj", "pxl_vid", "reg_fg", "reg_mov", "sharp_vid",
           "soft_ce_lyt", "topactivity")
METRIC_TOL = {"float32": (1e-6, 2e-4), "fast": (1e-5, 2e-3)}



def lvd_cfg(precision="float32"):
    cfg = tiny_config(use_pg=False, use_ii=False)
    cfg.model.sample_precision = precision
    return cfg


@pytest.fixture(scope="module")
def lvd_params():
    """LVD parameters from JAX's init, every leaf perturbed with seeded noise
    (the zero-initialized heads would hide layers), and a batch."""
    cfg = lvd_cfg()
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.02).astype(np.float32), params)
    batch = {k: np.asarray(v) for k, v in tiny_batch(cfg).items()}
    return params, batch


def port_synthesizer(cfg, params):
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, syn)
    return syn


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["float32", "fast"])
def loss_pair(request, lvd_params):
    """(precision, JAX (loss, metrics, grads), port (loss, metrics, grads by
    flax path)) on one batch."""
    params, batch = lvd_params
    cfg = lvd_cfg(request.param)
    js = JaxSynthesizer(cfg)
    jgs.set_impl("gather")
    try:
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: js.extract_object_loss(p, b, jax.random.PRNGKey(1), 0), has_aux=True))
        (jl, jm), jg = fn(params["pe"], {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jgs.set_impl("auto")
    syn = port_synthesizer(cfg, params)
    tl, tm = syn.extract_object_loss(_tb(batch))
    tl.backward()
    jflat = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jg)).items()}
    return (request.param, (float(jl), {k: float(v) for k, v in jm.items()}, jflat),
            (float(tl.detach()), {k: float(v) for k, v in tm.items()},
             _flatten(to_jax(syn, grads=True)["pe"])))


@pytest.mark.parametrize("name", METRICS)
def test_extract_object_metric_matches_jax(loss_pair, name):
    precision, (_, jm, _), (_, tm, _) = loss_pair
    atol, rtol = METRIC_TOL[precision]
    assert set(tm) == set(jm)
    assert np.isfinite(tm[name])
    assert abs(tm[name] - jm[name]) <= atol + rtol * abs(jm[name]), (name, tm[name], jm[name])


def test_lvd_gradients_match_jax(loss_pair):
    _, (_, _, jg), (_, _, tg) = loss_pair
    assert set(tg) == set(jg)
    top = max(float(np.abs(g).max()) for g in jg.values())
    assert top > 0
    for k, want in jg.items():
        err = float(np.abs(tg[k] - want).max())
        tol = 5e-3 * float(np.abs(want).max()) + 1e-6 * top
        assert err <= tol, f"{k}: max|err| {err:.3g} > {tol:.3g}"


def test_two_adam_steps_match_jax_train_step(lvd_params):
    """Two steps of train_step_fn (optax Adam, lr 1e-4, betas (0, 0.99)) and
    two of the port's NetState, from the same parameters and batch."""
    from waldo_tpu.train.train_state import NetState as JNetState, make_optimizer, train_step_fn

    params, batch = lvd_params
    cfg = lvd_cfg()
    js = JaxSynthesizer(cfg)
    jgs.set_impl("gather")
    try:
        step = jax.jit(train_step_fn(
            lambda p, b, r, i: js.extract_object_loss(p, b, r, i)))
        state = JNetState.create(jax.tree.map(jnp.asarray, params["pe"]), make_optimizer(cfg.model))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jmetrics = []
        for it in range(2):
            state, m = step(state, jb, jax.random.PRNGKey(1), jnp.float32(it))
            jmetrics.append(m)
    finally:
        jgs.set_impl("auto")
    syn = port_synthesizer(cfg, params)
    st = NetState(syn.lvd, syn.cfg.model)
    for it in range(2):
        st.zero_grad()
        loss, tm = syn.extract_object_loss(_tb(batch), it)
        loss.backward()
        st.apply(loss)
        assert abs(float(tm["loss"]) - float(jmetrics[it]["loss"])) <= 2e-4 * abs(float(tm["loss"]))
    assert int(st.count) == 2 and int(st.nancount) == 0 == int(jmetrics[-1]["nancount"])
    want = _flatten(jax.tree.map(np.asarray, state.params))
    got = _flatten(to_jax(syn)["pe"])
    start = _flatten(params["pe"])
    moved = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert float(diff.max()) <= 4e-4 and (diff > 2e-6).mean() <= 1e-3, (k, float(diff.max()))
        moved += int(np.abs(w - start[k]).max() > 1e-5)
    assert moved > len(want) // 2


def _linear_net():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    return net


def test_nan_loss_skips_the_step():
    """A non-finite loss leaves parameters, moments and step count as they
    were and counts up nancount on the device; a finite one resets it."""
    from waldo_tpu_torch.config import ModelConfig

    net = _linear_net()
    st = NetState(net, ModelConfig())
    x = torch.randn(5, 3)
    before = [p.detach().clone() for p in net.parameters()]
    for n_bad in (1, 2):
        st.zero_grad()
        loss = net(x).sum() * float("nan")
        loss.backward()
        st.apply(loss)
        assert int(st.nancount) == n_bad and int(st.count) == 0
        assert all(torch.equal(a, b) for a, b in zip(before, net.parameters()))
        assert all(not m.any() for m in st.mu + st.nu)
    st.zero_grad()
    loss = net(x).sum()
    loss.backward()
    st.apply(loss)
    assert int(st.nancount) == 0 and int(st.count) == 1
    assert not torch.equal(before[0], net[0].weight)


def test_adamw_decays_only_matrices():
    """AdamW as the JAX package means it (train_state.py's mask): weight
    decay on the leaves of more than one dimension that are not biases,
    plain Adam on the others. Step 1 from known gradients, against numpy."""
    from waldo_tpu_torch.config import ModelConfig

    net = _linear_net()
    mcfg = ModelConfig(optimizer="adamw", wd=0.1, lr=1e-2)
    st = NetState(net, mcfg)
    before = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    rng = np.random.RandomState(2)
    grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in net.named_parameters()}
    for n, p in net.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    st.apply(torch.zeros(()))
    for n, p in net.named_parameters():
        g = grads[n]
        adam = g / (np.abs(g) + 1e-8)  # betas (0, 0.99), step 1: |g| / sqrt(g^2)
        wd = 0.1 if (p.dim() > 1 and not n.endswith("bias")) else 0.0
        want = before[n] - 1e-2 * (adam + wd * before[n])
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-6, err_msg=n)


def test_jax_masked_adamw_passes_the_raw_gradient():
    """Pins the JAX package's AdamW defect (ROADMAP.md section 3): with
    weight decay, optax.masked hands the raw gradient through as the update
    of every leaf outside the mask, so a bias climbs its gradient at no
    learning rate."""
    from waldo_tpu.config import ModelConfig
    from waldo_tpu.train.train_state import make_optimizer

    tx = make_optimizer(ModelConfig(optimizer="adamw", wd=0.1))
    params = {"Dense_0": {"kernel": jnp.ones((3, 4)), "bias": jnp.ones((4,))}}
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    updates, _ = tx.update(grads, tx.init(params), params)
    np.testing.assert_allclose(np.asarray(updates["Dense_0"]["bias"]), 0.5)
    assert float(np.abs(np.asarray(updates["Dense_0"]["kernel"])).max()) < 1e-3


@pytest.fixture(scope="module")
def golden_metrics():
    """The port's loss on JAX init_params(PRNGKey(0)) at the goldens'
    config and batch (tests/test_golden_losses.py)."""
    cfg = tiny_config()
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0)))
    cfg.model.use_pg = cfg.model.use_ii = False
    syn = port_synthesizer(cfg, {"pe": params["pe"]})
    batch = {k: np.asarray(v) for k, v in tiny_batch(cfg).items()}
    with torch.no_grad():
        _, metrics = syn.extract_object_loss(_tb(batch))
    with open(GOLDEN) as fh:
        return {k: float(v) for k, v in metrics.items()}, json.load(fh)["extract_object"]


@pytest.mark.parametrize("name", GOLDEN_KEYS)
def test_loss_matches_golden(golden_metrics, name):
    """At tests/test_golden_losses.py's tolerance, 1e-3 + 1e-2 x |golden|."""
    got, golden = golden_metrics
    assert np.isfinite(got[name])
    assert abs(got[name] - golden[name]) <= 1e-3 + 1e-2 * abs(golden[name]), (name, got[name])


def test_nonstrict_restore_changed_head(tmp_path):
    """As tests/test_train.py's: a changed head is pruned, new leaves keep
    their init, a missing "latest" falls back to the highest numbered slot,
    and a strict restore of an exact template round-trips."""
    ckpt = CheckpointManager(str(tmp_path))
    saved = {"enc": {"kernel": np.ones((3, 3, 4, 8), np.float32),
                     "bias": np.zeros((8,), np.float32)},
             "head": {"kernel": np.full((8, 5), 2.0, np.float32)}}
    ckpt.save("pe", saved, it=7)
    template = {"enc": {"kernel": np.zeros((3, 3, 4, 8), np.float32),
                        "bias": np.ones((8,), np.float32)},
                "head": {"kernel": np.full((8, 9), -1.0, np.float32)},
                "new_block": {"w": np.full((2,), 3.0, np.float32)}}
    out = ckpt.restore("pe", template, which="latest")
    np.testing.assert_array_equal(out["enc"]["kernel"], saved["enc"]["kernel"])
    np.testing.assert_array_equal(out["enc"]["bias"], saved["enc"]["bias"])
    np.testing.assert_array_equal(out["head"]["kernel"], np.full((8, 9), -1.0, np.float32))
    np.testing.assert_array_equal(out["new_block"]["w"], np.full((2,), 3.0, np.float32))
    exact = jax.tree.map(np.zeros_like, saved)
    out2 = ckpt.restore("pe", exact, which="7", strict=True)
    np.testing.assert_array_equal(out2["head"]["kernel"], saved["head"]["kernel"])
    with pytest.raises(ValueError):
        ckpt.restore("pe", template, which="7", strict=True)
    with pytest.raises(FileNotFoundError):
        ckpt.restore("pe", template, which="best_vid")


def test_checkpoint_iter_zero_is_not_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("pe", {"w": np.zeros(3, np.float32)}, 0)
    ckpt.save("pe", {"w": np.ones(3, np.float32)}, 5, name="latest")
    for which, expect in [("0", 0.0), (0, 0.0), (None, 1.0), ("", 1.0), ("latest", 1.0)]:
        out = ckpt.restore("pe", {"w": np.full(3, -1, np.float32)}, which=normalize_which(which))
        assert float(out["w"][0]) == expect, (which, out)
    assert ckpt.latest_iter("pe") == 5


def test_to_jax_inverts_from_jax(lvd_params):
    params, _ = lvd_params
    syn = port_synthesizer(lvd_cfg(), params)
    got, want = _flatten(to_jax(syn)), _flatten(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def train_cfg(tmp, **over):
    """tests/test_train.py's trainer config with 2 clips a batch."""
    from waldo_tpu_torch.config import Config, DataConfig, ModelConfig

    cfg = Config(name="t", datetime="now", save_path=str(tmp), dim=32, aspect_ratio=2.0,
                 batch_size_vid=2, num_iter=3, save_latest_freq=2, log_freq=1,
                 data=DataConfig(num_lyt=6, fg_idx=[1, 4], bg_idx=[0], other_idx=[2], vid_len=5,
                                 dataset="synthetic"),
                 model=ModelConfig(patch_size=8, latent_shape=(4, 8), obj_shape=(2, 2),
                                   embed_dim=32, num_heads=4, num_obj=4, oe_depth=1, pe_depth=1,
                                   oe_num_timesteps=5, ctx_len=2, edge_size=3, use_pe=True,
                                   use_pg=False, use_ii=False))
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def test_trainer_runs_saves_and_resumes(tmp_path, capsys):
    """Trainer.run on synthetic clips: every step applied, parameters moved,
    "latest" restores equal, metric-gated "best_vid" after an eval; a
    cont_train run resumes from "latest" at the next iteration."""
    cfg = train_cfg(tmp_path, num_iter_eval=2, vid_metric="loss", max_batch_eval_vid=1)
    tr = Trainer(cfg, device="cpu")
    before = [p.detach().clone() for p in tr.syn.lvd.parameters()]
    tr.run(num_iter=3)
    out = capsys.readouterr().out
    assert "Iteration 00002/00003" in out and "new best_vid" in out
    assert int(tr.states["pe"].count) == 3 and int(tr.states["pe"].nancount) == 0
    assert all(not torch.equal(a, b) for a, b in zip(before, tr.syn.lvd.parameters()))
    assert tr.ckpt.exists("pe", "latest") and tr.ckpt.exists("pe", "best_vid")
    assert tr.ckpt.latest_iter("pe") == 2
    now = _flatten(to_jax(tr.syn)["pe"])
    back = _flatten(tr.ckpt.restore("pe", to_jax(tr.syn)["pe"], "latest", strict=True))
    assert all(np.array_equal(now[k], back[k]) for k in now)

    tr2 = Trainer(train_cfg(tmp_path, cont_train=True), device="cpu")
    resumed = _flatten(to_jax(tr2.syn)["pe"])
    assert all(np.array_equal(now[k], resumed[k]) for k in now)
    tr2.run(num_iter=4)
    assert int(tr2.states["pe"].count) == 1 and tr2.ckpt.latest_iter("pe") == 3


@pytest.mark.parametrize("mode", ["adv", "dis"])
def test_trainer_refuses_modes_not_ported(tmp_path, mode):
    """vid_inpainting's GAN losses, once refused (the name is kept), now
    step: with adv the generator's step carries the adversarial term
    against a discriminator that does not train; with dis the
    discriminator's step follows it."""
    cfg = train_cfg(tmp_path, vid_modes=["vid_inpainting"])
    cfg.model.use_ii, cfg.model.ii_depth, cfg.model.ii_embed_dim = True, 2, 16
    cfg.model.vid_inpainting_losses = ["sharp_vid", mode]
    tr = Trainer(cfg, device="cpu")
    trained = {"adv": ["ii"], "dis": ["id", "ii"]}[mode]
    assert sorted(tr.states) == trained and tr.syn.disc is not None
    seen = {}
    step = tr.step
    tr.step = lambda m, b, it: seen.setdefault(m, step(m, b, it))
    tr.run(num_iter=1)
    assert ("adv" in seen["vid_inpainting"]) == (mode == "adv")
    assert ("vid_inpainting_dis" in seen) == (mode == "dis")
    for net in trained:
        assert int(tr.states[net].count) == 1 and int(tr.states[net].nancount) == 0
    if mode == "adv":
        assert all(not p.requires_grad and p.grad is None for p in tr.syn.disc.parameters())


def test_cli_train_asks_for_the_card(tmp_path):
    from waldo_tpu_torch.cli.train import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--dataset", "synthetic", "--save_path", str(tmp_path), "--dim", "32"])


def train_lvd_flags():
    with open(os.path.join(ROOT, "scripts", "cityscapes", "train_lvd.sh")) as fh:
        text = fh.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "cli.train" in ln)
    return [a for a in shlex.split(line.split("cli.train", 1)[1]) if a != "$@"]


def test_parse_cli_train_lvd_matches_jax():
    """scripts/cityscapes/train_lvd.sh's flags through both parsers (the
    stamp of the run's start aside), with the settings the slice depends on."""
    flags = train_lvd_flags() + ["--datetime", "fixed"]
    got, want = to_dict(parse_cli(flags)), jconfig.to_dict(jconfig.parse_cli(flags))
    assert got == want
    m = got["model"]
    assert (got["batch_size_vid"], got["data"]["vid_len"], got["dim"],
            got["load_dim"]) == (8, 14, 128, 0)
    assert (m["embed_dim"], m["num_obj"], m["pe_estimator_init_mode"], m["fast_inverse_warp"],
            m["ctx_mode"], m["include_self"]) == (512, 16, "", False, "prev", True)
    no_stamp = to_dict(parse_cli(train_lvd_flags()))
    assert no_stamp["datetime"] and no_stamp["datetime"] != "fixed"


def test_parse_cli_rejects_unknown_keys():
    with pytest.raises(KeyError):
        parse_cli(["--no_such_flag", "1"])
    with pytest.raises(ValueError):
        parse_cli(["dim", "64"])


class _Seeded:
    """A random stream whose every draw is ``seed``: a JAX training dataset
    built on it makes the clip of that seed."""

    def __init__(self, seed):
        self.seed = seed

    def randrange(self, n):
        return self.seed


def _jax_clip(jcfg, index, seed):
    """The JAX package's synthetic clip at ``index`` made from ``seed`` (its
    training phase takes a clip's seed from the stream; the clip depends on
    the phase through the seed alone)."""
    from waldo_tpu.data.synthetic import SyntheticDataset as JSynthetic

    return JSynthetic(jcfg, phase="train", rng=_Seeded(seed))[index]


def test_synthetic_clips_match_jax():
    """The port's synthetic clips equal the JAX package's for the same index
    and seed, and so do the loaders' first batches. A training clip's seed
    is the stream's next draw in both; a valid or test clip's is the port's
    ``eval_seed``, the same in every process, where the JAX package takes
    Python's string hash, stable within one process only (ROADMAP.md
    section 3)."""
    from waldo_tpu.data import DataLoader as JLoader
    from waldo_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from waldo_tpu_torch.data import DataLoader, SyntheticDataset, create_dataset

    jcfg = tiny_config()
    jcfg.data.dataset = "synthetic"
    tcfg = from_dict(jconfig.to_dict(jcfg))
    for phase, idx in (("valid", 0), ("valid", 3), ("test", 1), ("train", 5)):
        ds = create_dataset(tcfg, phase=phase, rng=random.Random(7))
        seed = ds.draw(idx) if phase == "train" else SyntheticDataset.eval_seed(phase, idx)
        if phase != "train":
            assert ds.draw(idx) == seed
        got = create_dataset(tcfg, phase=phase, rng=random.Random(7))[idx]
        want = (JSynthetic(jcfg, phase=phase, rng=random.Random(7))[idx] if phase == "train"
                else _jax_clip(jcfg, idx, seed))
        assert set(got) == set(want)
        assert got["path"] == f"synthetic_{phase}_{idx}"
        for k in ("vid", "lyt", "flow"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{phase} {idx} {k}")
    want = next(iter(JLoader(JSynthetic(jcfg, phase="valid"), 4, shuffle=True, seed=3,
                             num_workers=1, num_hosts=1, host_id=0)))
    got = next(iter(DataLoader(create_dataset(tcfg, phase="valid"), 4, shuffle=True, seed=3)))
    assert got["path"] == want["path"]
    idx = [int(path.rsplit("_", 1)[1]) for path in got["path"]]
    np.testing.assert_array_equal(
        got["vid"], np.stack([_jax_clip(jcfg, i, SyntheticDataset.eval_seed("valid", i))["vid"]
                              for i in idx]))


def test_datasets_not_ported_raise():
    """Every dataset of the JAX package's registry is ported; a name outside
    it raises, naming them."""
    from waldo_tpu_torch.data import create_dataset

    cfg = from_dict(jconfig.to_dict(tiny_config()))
    cfg.data.dataset = "moving_mnist"
    with pytest.raises(KeyError, match="cityscapes.*kitti.*synthetic.*video_folder"):
        create_dataset(cfg)
