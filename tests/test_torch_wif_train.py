"""The WIF training loss, the port against the JAX package, on the CPU at
tests/test_models_smoke.tiny_config()'s scale: ``inpaint_loss`` with and
without LPIPS weights (metrics and WIF's per-leaf gradients) against the
frozen LVD teacher, at tests/test_torch_flp_train.py's tolerances. LPIPS
weights are seeded random arrays in an npz under tmp_path, read by both
packages' ``maybe_load``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.convert import to_jax
from waldo_tpu_torch.train.checkpoint import _flatten

from test_models_smoke import tiny_batch, tiny_config
from test_torch_flp_train import (_check_grads, _check_metrics, _jax_loss_and_grads,
                                  _jax_metrics, _perturbed_params, _port, _tb)
from test_torch_lpips import write_random_lpips

INPAINT_METRICS = ("loss", "lpips_vid", "sharp_delta", "sharp_rec", "sharp_vid")


def inpaint_cfg(precision):
    cfg = tiny_config(use_pg=False, use_ii=True)
    cfg.model.sample_precision = precision
    cfg.model.vid_inpainting_losses = ["sharp_vid", "lpips_vid"]
    return cfg


@pytest.fixture(scope="module")
def lpips_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips")
    write_random_lpips(str(root / "lpips_vgg.npz"), "vgg", seed=6)
    return str(root)


@pytest.fixture(scope="module", params=["float32", "fast"])
def inpaint_pair(request, lpips_dir):
    """(precision, JAX (metrics, WIF grads), port (metrics, WIF grads, LVD
    grads)) with the LPIPS weights in place.

    In float32 the JAX gradients are those of the whole ``inpaint_loss``.
    Under "fast" both sides store the decoded context frames in bf16, and at
    these seeds 1.4 % of them round one bf16 step apart (the nets' float32
    sums run in another order); L1's sign at the pixels where WIF's output
    meets its target turns that into up to ~6x the gradient tolerance. So
    there the JAX gradients are those of the same loss terms (WIF, L1,
    LPIPS) on the port's own decode, which the metrics hold to JAX's."""
    precision = request.param
    cfg = inpaint_cfg(precision)
    params = _perturbed_params(cfg, 3)
    batch = {k: np.asarray(v) for k, v in tiny_batch(cfg).items()}
    mp = pytest.MonkeyPatch()
    mp.setenv("WALDO_LPIPS_WEIGHTS", lpips_dir)
    try:
        js = JaxSynthesizer(cfg)
        syn = _port(cfg, params)
    finally:
        mp.undo()
    assert js.lpips is not None and syn.lpips is not None
    seen = []
    hook = syn.wif.register_forward_pre_hook(lambda _, args: seen.append(args[0]))
    loss, tm = syn.inpaint_loss(_tb(batch))
    hook.remove()
    loss.backward()
    fn = lambda p, b: js.inpaint_loss(p, params["pe"], b, jax.random.PRNGKey(1), 0)
    if precision == "float32":
        jm, jg = _jax_loss_and_grads(fn, params["ii"], batch)
    else:
        jm = _jax_metrics(fn, params["ii"], batch)
        raw = jnp.asarray(seen[0].float().numpy()).astype(jnp.bfloat16)
        tgt = jnp.asarray(batch["vid"][:, cfg.model.ctx_len:])
        m = cfg.model

        def tail(p):
            inp = js.wif.apply(p, raw)
            return (jnp.abs(inp - tgt).mean() * m.lambda_sharp_vid
                    + js.lpips(inp, tgt).mean() * m.lambda_lpips_vid)

        jg = jax.grad(tail)(params["ii"])
        jg = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jg)).items()}
    return precision, (jm, jg), ({k: float(v) for k, v in tm.items()},
                                 _flatten(to_jax(syn, grads=True)["ii"]),
                                 [p.grad for p in syn.lvd.parameters()])


@pytest.mark.parametrize("name", INPAINT_METRICS)
def test_inpaint_loss_metric_matches_jax(inpaint_pair, name):
    precision, (jm, _), (tm, _, _) = inpaint_pair
    assert "lpips_vid" in jm
    _check_metrics(precision, tm, jm, [name])


def test_inpaint_loss_gradients_match_jax(inpaint_pair):
    """WIF's per-leaf gradients, L1 and LPIPS; the LVD teacher gets none."""
    _, (_, jg), (_, tg, lvd_grads) = inpaint_pair
    _check_grads(tg, jg)
    assert all(g is None for g in lvd_grads)


def test_inpaint_loss_without_lpips_weights_is_l1_and_warns(tmp_path, monkeypatch, capsys):
    """No weights file: both packages warn and train L1 only, to the same
    metrics (no JAX gradient here: the L1 term's is held above)."""
    monkeypatch.setenv("WALDO_LPIPS_WEIGHTS", str(tmp_path))
    cfg = inpaint_cfg("float32")
    params = _perturbed_params(cfg, 3)
    batch = {k: np.asarray(v) for k, v in tiny_batch(cfg).items()}
    js = JaxSynthesizer(cfg)
    want_warning = capsys.readouterr().err
    syn = _port(cfg, params)
    got_warning = capsys.readouterr().err
    assert js.lpips is None and syn.lpips is None
    for err in (want_warning, got_warning):
        assert "WARNING: lpips_vid" in err and "L1 ONLY" in err
        assert str(tmp_path / "lpips_vgg.npz") in err
    jm = _jax_metrics(lambda p, b: js.inpaint_loss(p, params["pe"], b, jax.random.PRNGKey(1), 0),
                      params["ii"], batch)
    with torch.no_grad():
        _, tm = syn.inpaint_loss(_tb(batch))
    _check_metrics("float32", {k: float(v) for k, v in tm.items()}, jm, INPAINT_METRICS)
    assert "lpips_vid" not in tm
    assert abs(float(tm["loss"]) - float(tm["sharp_vid"]) * cfg.model.lambda_sharp_vid) < 1e-7
