"""WIF's adversarial training, the port against the JAX package, on the CPU:
``inpaint_loss`` with ``adv`` and the adaptive lambda, ``discriminate_loss``
and two discriminator steps against ``train_step_fn``, and the trainer's
GAN run (checkpoints, resume, visuals, two batches an iteration).

The config is tests/test_models_smoke.tiny_config() with WIF at
train_wif.sh's depth (``ii_depth`` 6, so that the adaptive lambda's leaf is
the JAX package's "_ConvBlock_9", not the 6th deconv block), loaded at 64x128
over a 32x64 model, float32 sampling; the JAX side samples through its
gather path.

Two comparisons:
  the whole chain (JAX's decode and the port's): the metrics at
      tests/test_torch_flp_train.py's float32 tolerance (1e-6 + 2e-4 x
      |value|). The decode's float32 sums run in other orders, and the
      discriminator's LeakyReLU and the hinge turn the ~5e-5 that the frames
      differ by into gradients of its first layers ~2 % apart (JAX alone,
      on the two packages' frames, differs by as much), so gradients are
      not compared there;
  on the port's own decode (JAX's ``decode_output`` and ``_fused_frame``
      handed the port's outputs, the rest JAX's own code, the adaptive
      lambda's leaf choice included): every metric 1e-4 relative, WIF's
      and the discriminator's gradients per leaf 2e-3 x the leaf's largest
      plus 1e-6 x the largest of all leaves (WIF's encoder convolutions sum
      over every pixel of the batch's frames and land up to 7.3e-4 of their
      largest, 2e-5 of the largest of all leaves, apart; the biases before
      a per-channel norm, 0 in exact arithmetic, 1e-6 of it), and the
      parameters after two
      Adam steps as tests/test_torch_train.py holds them, but for the
      biases of the discriminator's convolutions that a per-channel norm
      follows: their gradient is 0 in exact arithmetic, so Adam moves them
      by ~lr in the direction the rounding picks (within 2 lr a step).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.convert import to_jax, wif_port_key
from waldo_tpu_torch.train import NetState, Trainer
from waldo_tpu_torch.train.checkpoint import _flatten

from test_models_smoke import tiny_batch, tiny_config
from test_torch_flp_train import (_check_metrics, _jax_loss_and_grads, _jax_metrics,
                                  _perturbed_params, _port, _tb, jgs)
from test_torch_train import train_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

G_METRICS = ("adaptive_lambda", "adv", "loss", "sharp_delta", "sharp_rec", "sharp_vid")
D_METRICS = ("dis", "fake_score", "loss", "real_score")
# the discriminator's biases whose gradient is 0 in exact arithmetic
NORMED_BIASES = ("params/Conv_1/bias", "params/Conv_2/bias", "params/Conv_3/bias")


def gan_cfg():
    cfg = tiny_config(use_pg=False, use_ii=True)
    cfg.load_dim = 64
    cfg.model.ii_depth = 6
    cfg.model.sample_precision = "float32"
    cfg.model.vid_inpainting_losses = ["sharp_vid", "adv", "dis"]
    cfg.model.use_adaptive_lambda = True
    return cfg


def gan_batch(cfg, b=2, seed=0):
    """Frames and layouts at the load resolution, flows at the model's."""
    hd = copy.deepcopy(cfg)
    hd.dim = cfg.load_dim
    big, small = tiny_batch(hd, b, seed), tiny_batch(cfg, b, seed)
    return {"vid": np.asarray(big["vid"]), "lyt": np.asarray(big["lyt"]),
            "flow": np.asarray(small["flow"])}


@pytest.fixture(scope="module")
def setup():
    cfg = gan_cfg()
    return cfg, _perturbed_params(cfg, 3), gan_batch(cfg), JaxSynthesizer(cfg)


def _rel_close(got, want, names, rtol=1e-4):
    for name in names:
        assert abs(got[name] - want[name]) <= rtol * abs(want[name]) + 1e-7, \
            (name, got[name], want[name])


def _grads_close(got, want):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert top > 0 and sorted(got) == sorted(want)
    for k, w in want.items():
        if k in NORMED_BIASES:  # rounding on both sides
            assert max(float(np.abs(got[k]).max()), float(np.abs(w).max())) <= 1e-5 * top, k
            continue
        err = float(np.abs(got[k] - w).max())
        assert err <= 2e-3 * float(np.abs(w).max()) + 1e-6 * top, (k, err)


def test_adaptive_leaf_is_jax_last_conv_leaf(setup):
    """The JAX package's leaf: the last of tree_flatten_with_path's leaves
    whose path names "from_emb" or "Conv" (sorted keys: _ConvBlock_10 and
    _11 before _2), here the 4th deconv block's GroupNorm scale."""
    cfg, params, _, _ = setup
    leaves = [p for p, _ in jax.tree_util.tree_flatten_with_path(params["ii"])[0]
              if "from_emb" in str(p) or "Conv" in str(p)]
    path = "/".join(k.key for k in leaves[-1])
    assert path == "params/UNet_0/_ConvBlock_9/CustomNorm_0/GroupNorm_0/scale"
    syn = _port(cfg, params)
    assert syn.adaptive_leaf == wif_port_key(cfg, path[len("params/"):]) \
        == "unet.deconv_layers.3.norm.weight"


@pytest.fixture(scope="module")
def g_pair(setup):
    """The generator step: the port's metrics, WIF gradients and the other
    nets' gradients; JAX's metrics on its own chain; JAX's metrics and WIF
    gradients on the port's decode."""
    cfg, params, batch, js = setup
    syn = _port(cfg, params)
    seen = []
    decode = syn._inpaint_decode
    syn._inpaint_decode = lambda b: seen.append(decode(b)) or seen[-1]
    loss, tm = syn.inpaint_loss(_tb(batch), adv=True)
    loss.backward()
    port = ({k: float(v) for k, v in tm.items()}, _flatten(to_jax(syn, grads=False)["ii"]),
            _flatten(to_jax(syn, grads=True)["ii"]),
            [p.grad for p in list(syn.disc.parameters()) + list(syn.lvd.parameters())])
    fn = lambda p, b: js.inpaint_loss(p, params["pe"], b, jax.random.PRNGKey(1), 0,
                                      id_params=params["id"])
    chain = _jax_metrics(fn, params["ii"], batch)
    rec, raw = (jnp.asarray(t.numpy()) for t in seen[0])
    mp = pytest.MonkeyPatch()
    mp.setattr(js, "decode_output", lambda *a, **k: (rec, None, None, None, None, raw, None))
    try:
        own = _jax_loss_and_grads(fn, params["ii"], batch)
    finally:
        mp.undo()
    return port, chain, own


def test_inpaint_adv_metrics_match_jax(g_pair):
    (tm, _, _, _), chain, (own, _) = g_pair
    assert sorted(tm) == sorted(chain) == sorted(G_METRICS)
    _check_metrics("float32", tm, chain, G_METRICS)
    _rel_close(tm, own, G_METRICS)
    assert 0 < tm["adaptive_lambda"] < 1e4


def test_inpaint_adv_gradients_match_jax(g_pair):
    """WIF's per-leaf gradients of L1 + lambda adv on the port's decode; the
    discriminator and the LVD teacher get none."""
    (_, _, tg, others), _, (_, jg) = g_pair
    _grads_close(tg, jg)
    assert all(g is None for g in others)


def test_eval_metrics_have_no_adv(setup):
    """Without ``adv`` (eval) the loss is L1 alone, as JAX's without
    id_params."""
    cfg, params, batch, js = setup
    syn = _port(cfg, params)
    with torch.no_grad():
        _, tm = syn.inpaint_loss(_tb(batch))
    want = _jax_metrics(lambda p, b: js.inpaint_loss(p, params["pe"], b, jax.random.PRNGKey(1),
                                                     0), params["ii"], batch)
    assert "adv" not in tm and sorted(tm) == sorted(want)
    _check_metrics("float32", {k: float(v) for k, v in tm.items()}, want, list(want))


@pytest.fixture(scope="module")
def d_pair(setup):
    """Two discriminator steps: the port's (NetState) and JAX's
    train_step_fn on the port's fused frame; the first step's gradients of
    both, and JAX's metrics on its own chain."""
    from waldo_tpu.train.train_state import NetState as JNetState, make_optimizer, train_step_fn

    cfg, params, batch, js = setup
    syn = _port(cfg, params)
    frames = []
    fused = syn._fused_frame
    syn._fused_frame = lambda b: frames.append(fused(b)) or frames[-1]
    st = NetState(syn.disc, syn.cfg.model)
    port_metrics, port_grads = [], None
    for it in range(2):
        st.zero_grad()
        loss, tm = syn.discriminate_loss(_tb(batch), it)
        loss.backward()
        if it == 0:
            port_grads = _flatten(to_jax(syn, grads=True)["id"])
            wif_grads = [p.grad for p in syn.wif.parameters()]
        st.apply(loss)
        port_metrics.append({k: float(v) for k, v in tm.items()})
    assert torch.equal(frames[0], frames[1])
    key = jax.random.PRNGKey(1)
    loss_fn = lambda p, b, r, i: js.discriminate_loss(p, params["ii"], params["pe"], b, r, i)
    chain = _jax_metrics(lambda p, b: loss_fn(p, b, key, 0), params["id"], batch)
    frame = jnp.asarray(frames[0].numpy())
    mp = pytest.MonkeyPatch()
    mp.setattr(js, "_fused_frame", lambda *a: frame)
    jgs.set_impl("gather")
    try:
        _, jg = _jax_loss_and_grads(lambda p, b: loss_fn(p, b, key, 0), params["id"], batch)
        step = jax.jit(train_step_fn(loss_fn))
        state = JNetState.create(jax.tree.map(jnp.asarray, params["id"]),
                                 make_optimizer(cfg.model))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jax_metrics = []
        for it in range(2):
            state, m = step(state, jb, key, jnp.float32(it))
            jax_metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jgs.set_impl("auto")
        mp.undo()
    return dict(port_metrics=port_metrics, port_grads=port_grads, wif_grads=wif_grads,
                port_params=_flatten(to_jax(syn)["id"]), count=int(st.count), chain=chain,
                jax_metrics=jax_metrics, jax_grads=jg,
                jax_params=_flatten(jax.tree.map(np.asarray, state.params)),
                start=_flatten(params["id"]))


def test_discriminate_loss_matches_jax(d_pair):
    got, chain = d_pair["port_metrics"][0], d_pair["chain"]
    assert sorted(got) == sorted(chain) == sorted(D_METRICS)
    _check_metrics("float32", got, chain, D_METRICS)
    for it in range(2):
        _rel_close(d_pair["port_metrics"][it], d_pair["jax_metrics"][it], D_METRICS)
    assert d_pair["jax_metrics"][-1]["nancount"] == 0


def test_discriminator_gradients_match_jax(d_pair):
    """The first D step's per-leaf gradients on the same fused frame; WIF
    gets none."""
    _grads_close(d_pair["port_grads"], d_pair["jax_grads"])
    assert all(g is None for g in d_pair["wif_grads"])


def test_two_discriminator_steps_match_train_step(setup, d_pair):
    """The parameters after two Adam steps; a bias before a per-channel norm
    within the most two steps can move it either way: lr (1 + sqrt((1 -
    b2^2) / (1 - b2))) a side, the second step's bias-corrected ratio at
    its largest."""
    m = setup[0].model
    assert d_pair["count"] == 2
    got, want, start = d_pair["port_params"], d_pair["jax_params"], d_pair["start"]
    assert sorted(got) == sorted(want)
    reach = 2 * m.lr * (1 + np.sqrt((1 - m.beta2 ** 2) / (1 - m.beta2)))
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        if k in NORMED_BIASES:
            assert float(diff.max()) <= reach, (k, float(diff.max()))
            continue
        assert float(diff.max()) <= 4e-4 and (diff > 2e-6).mean() <= 1e-3, (k, float(diff.max()))
    assert sum(int(np.abs(want[k] - start[k]).max() > 1e-5) for k in want) == len(want)


def gan_train_cfg(tmp, **over):
    cfg = train_cfg(tmp, vid_modes=["vid_inpainting"], **over)
    m = cfg.model
    m.use_ii, m.ii_depth, m.ii_embed_dim = True, 2, 16
    m.vid_inpainting_losses = ["sharp_vid", "adv", "dis"]
    m.use_adaptive_lambda = True
    return cfg


def test_trainer_gan_run_saves_resumes_and_logs(tmp_path, monkeypatch):
    """Trainer.run(2) with adv and dis: the D step follows the G step on a
    batch of its own (four loader batches), both nets step, the slots hold
    "id", the visuals run for vid_inpainting only; a cont_train rerun
    restores "ii" but not "id", as the JAX trainer does."""
    import waldo_tpu_torch.train.trainer as trainer_mod

    pulls, visual_modes = [], []
    nxt = trainer_mod.InfiniteLoader.next
    monkeypatch.setattr(trainer_mod.InfiniteLoader, "next",
                        lambda self: pulls.append(1) or nxt(self))
    cfg = gan_train_cfg(tmp_path)
    tr = Trainer(cfg, device="cpu")
    assert tr._train_modes == ["vid_inpainting", "vid_inpainting_dis"]
    assert sorted(tr.states) == ["id", "ii"]
    visuals = tr.syn.visuals
    tr.syn.visuals = lambda mode, *a, **k: visual_modes.append(mode) or visuals(mode, *a, **k)
    fresh_d = _flatten(to_jax(tr.syn)["id"])
    tr.run(num_iter=2)
    assert len(pulls) == 4 and visual_modes == ["vid_inpainting"] * 2
    for net in ("ii", "id"):
        assert int(tr.states[net].count) == 2 and int(tr.states[net].nancount) == 0
        assert tr.ckpt.exists(net, "latest")
    saved = {net: _flatten(to_jax(tr.syn)[net]) for net in ("ii", "id")}
    assert any(not np.array_equal(saved["id"][k], fresh_d[k]) for k in fresh_d)
    tr2 = Trainer(gan_train_cfg(tmp_path, cont_train=True), device="cpu")
    now = {net: _flatten(to_jax(tr2.syn)[net]) for net in ("ii", "id")}
    assert all(np.array_equal(now["ii"][k], saved["ii"][k]) for k in saved["ii"])
    assert all(np.array_equal(now["id"][k], fresh_d[k]) for k in fresh_d)
    tr2.run(num_iter=3)
    assert int(tr2.states["id"].count) == 1 and tr2.ckpt.latest_iter("ii") == 2
