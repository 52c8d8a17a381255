"""The GAN's modules (waldo_tpu_torch/nn/gan.py) against the JAX package's
(waldo_tpu/nn/gan.py) on the CPU: the five losses on logits and on lists of
multi-scale logits, the WGAN gradient penalty with JAX's draw of eps, the
two spectral norms (outputs, gradients and the updated stats after one
call), the discriminator (output and parameter gradients) and its "id"
converter round trip, through the synthesizer and through
scripts/jax_slots_to_torch.py.

Tolerance: 1e-4 relative (ROADMAP.md's nets), on every value and, per
leaf, on the gradients (1e-4 x the leaf's largest plus 1e-6 x the largest
of all leaves, tests/test_torch_flp_train.py's floor: the biases of the
convolutions a per-channel norm follows have a gradient of 0 in exact
arithmetic, so theirs is the rounding of the whole backward, ~3e-7 of the
largest leaf).
"""
import os
import sys

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from waldo_tpu.nn import gan as jgan
from waldo_tpu_torch.convert import disc_rules, from_jax, load_from_jax, to_jax
from waldo_tpu_torch.nn import gan
from waldo_tpu_torch.train.checkpoint import _flatten
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4
NAMES = ("original", "hinge", "logistic", "wgan", "wgan-eps")


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + 1e-7, (what, err, float(np.abs(want).max()))


def _grads_close(got, want, what=""):
    top = max(float(np.abs(w).max()) for w in want.values())
    assert top > 0
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(np.abs(np.asarray(got[k]) - w).max())
        assert err <= RTOL * float(np.abs(w).max()) + 1e-6 * top, (what, k, err)


def _logits(seed, multi):
    rng = np.random.RandomState(seed)
    shapes = [(2, 5, 7, 1), (2, 3, 3, 1)] if multi else [(2, 5, 7, 1)]
    arrs = [(rng.randn(*s) * 2).astype(np.float32) for s in shapes]
    return arrs if multi else arrs[0]


def _torch(x):
    return [torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)


def _jnp(x):
    return [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)


@pytest.mark.parametrize("multi", [False, True], ids=["one", "multiscale"])
@pytest.mark.parametrize("name", NAMES)
def test_losses_match_jax(name, multi):
    """Each loss pair on logits, or on a list of two scales' logits (the
    mean of the per-scale losses), and the generator loss's gradient."""
    real, fake = _logits(0, multi), _logits(1, multi)
    jg, jd = jgan.get_gan_loss(name)
    tg, td = gan.get_gan_loss(name)
    _close(float(td(_torch(real), _torch(fake))), float(jd(_jnp(real), _jnp(fake))), what="d")
    _close(float(tg(_torch(fake))), float(jg(_jnp(fake))), what="g")
    t = _torch(fake)
    for x in (t if multi else [t]):
        x.requires_grad_(True)
    tg(t).backward()
    want = jax.grad(lambda f: jg(f))(_jnp(fake))
    for x, w in zip(t if multi else [t], want if multi else [want]):
        _close(x.grad.numpy(), np.asarray(w), what="grad")


def test_wgan_d_loss_terms_and_loss_table():
    real, fake = _logits(2, False), _logits(3, False)
    want = jgan.wgan_d_loss(jnp.asarray(real), jnp.asarray(fake), gradient_penalty=0.3,
                            lambda_gp=7.0, eps_penalty=0.01)
    got = gan.wgan_d_loss(torch.from_numpy(real), torch.from_numpy(fake), gradient_penalty=0.3,
                          lambda_gp=7.0, eps_penalty=0.01)
    _close(float(got), float(want))
    assert sorted(gan.GAN_LOSSES) == sorted(jgan.GAN_LOSSES)
    with pytest.raises(KeyError):
        gan.get_gan_loss("lsgan")


@pytest.fixture(scope="module")
def disc_pair():
    """The JAX Discriminator's seeded parameters, every leaf moved by seeded
    noise (its norms start at unit scale and zero bias), and the port's
    Discriminator loaded from them."""
    rng = np.random.RandomState(4)
    jd = jgan.Discriminator()
    params = jax.tree.map(np.asarray,
                          jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3))))
    params = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.02).astype(np.float32), params)
    d = gan.Discriminator()
    load_from_jax(params, d, disc_rules(), "id")
    return jd, params, d


def _port_grads(module):
    """The module's parameter gradients in the flax tree's layout."""
    from waldo_tpu_torch.convert import _unconvert_leaf

    own = dict(module.named_parameters())
    grad = lambda p: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
    return {f"params/{f}": _unconvert_leaf(grad(own[k]), kind) for k, f, kind in disc_rules()}


def test_discriminator_matches_jax(disc_pair):
    """Logits (B, H/16 - 1, W/16 - 1, 1) and the parameters' gradients of a
    seeded weighting of them."""
    jd, params, d = disc_pair
    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 64, 3).astype(np.float32)
    r = rng.randn(2, 1, 3, 1).astype(np.float32)
    want = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x)))
    d.zero_grad()
    got = d(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 1, 3, 1)
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(r)).sum().backward()
    jg = jax.jit(jax.grad(lambda p: (jd.apply(p, jnp.asarray(x)) * r).sum()))(params)
    _grads_close(_port_grads(d), _flatten(jax.tree.map(np.asarray, jg)))


def test_gradient_penalty_matches_jax(disc_pair):
    """WGAN-GP with JAX's draw of eps handed to the port: the penalty and
    its gradient in the discriminator's parameters (a second-order
    gradient)."""
    jd, params, d = disc_pair
    rng = np.random.RandomState(6)
    real = rng.randn(2, 32, 64, 3).astype(np.float32)
    fake = rng.randn(2, 32, 64, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))
    fn = lambda p: jgan.wgan_gradient_penalty(jd.apply, p, jnp.asarray(real), jnp.asarray(fake),
                                              key)
    want, jg = jax.jit(jax.value_and_grad(fn))(params)
    d.zero_grad()
    got = gan.wgan_gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                    eps=torch.from_numpy(eps))
    _close(float(got), float(want))
    got.backward()
    _grads_close(_port_grads(d), _flatten(jax.tree.map(np.asarray, jg)))
    # drawn from a generator: one eps per sample, the same again from the seed
    pen = [float(gan.wgan_gradient_penalty(d, torch.from_numpy(real), torch.from_numpy(fake),
                                           generator=torch.Generator().manual_seed(s)))
           for s in (0, 0, 1)]
    assert pen[0] == pen[1] != pen[2]


def _isn_pair(update):
    """ImprovedSpectralDense (8 -> 6) in both packages: the JAX one
    initialized and called once (``update_stats``), the port's loaded with
    its initial parameters and stats and called once. Returns the outputs,
    the stats after the call and the kernel gradients of a weighted sum."""
    rng = np.random.RandomState(7)
    x = rng.randn(5, 8).astype(np.float32)
    r = rng.randn(5, 6).astype(np.float32)
    jm = jgan.ImprovedSpectralDense(6)
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    var["params"] = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.05).astype(np.float32),
                                 var["params"])

    def f(p):
        y, st = jm.apply({"params": p, "spectral": var["spectral"]}, jnp.asarray(x),
                         update_stats=update, mutable=["spectral"])
        return (y * r).sum(), (y, st)

    (_, (want, jst)), jg = jax.value_and_grad(f, has_aux=True)(var["params"])
    m = gan.ImprovedSpectralDense(8, 6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(var["params"]["kernel"].T.copy()))
        m.bias.copy_(torch.from_numpy(var["params"]["bias"]))
        m.u.copy_(torch.from_numpy(var["spectral"]["u"]))
        m.sigma_init.copy_(torch.from_numpy(var["spectral"]["sigma_init"]))
    got = m(torch.from_numpy(x), update_stats=update)
    (got * torch.from_numpy(r)).sum().backward()
    return (got.detach().numpy(), np.asarray(want), m.u.numpy(), np.asarray(jst["spectral"]["u"]),
            m.weight.grad.numpy().T, np.asarray(jg["kernel"]))


@pytest.mark.parametrize("update", [True, False])
def test_improved_spectral_dense_matches_jax(update):
    got, want, u, ju, g, jg = _isn_pair(update)
    _close(got, want, what="out")
    _close(u, ju, what="u")
    _close(g, jg, what="kernel grad")


def test_improved_spectral_dense_init_sets_sigma_init():
    """At init sigma_init is the kernel's norm estimate from the drawn u, so
    a first call without an update returns the plain dense product."""
    m = gan.ImprovedSpectralDense(8, 6)
    m.init_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    u0 = m.u.clone()
    y = m(x, update_stats=False)
    assert torch.equal(m.u, u0)
    torch.testing.assert_close(y, x @ m.weight.t() + m.bias, rtol=1e-5, atol=1e-6)
    m(x)
    assert not torch.equal(m.u, u0)


def test_spectral_norm_dense_matches_flax():
    """"sn": flax's nn.SpectralNorm(nn.Dense(6)) initialized and called once
    with update_stats, against the port's SpectralNormDense: outputs, the
    new u and sigma, and the kernel gradient."""
    rng = np.random.RandomState(8)
    x = rng.randn(5, 8).astype(np.float32)
    r = rng.randn(5, 6).astype(np.float32)
    jm = fnn.SpectralNorm(fnn.Dense(6))
    var = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                           update_stats=False))
    var["params"] = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.05).astype(np.float32),
                                 var["params"])
    stats = var["batch_stats"]["layer_instance/kernel/u"], var["batch_stats"]["layer_instance/kernel/sigma"]

    def f(p):
        y, st = jm.apply({"params": p, "batch_stats": var["batch_stats"]}, jnp.asarray(x),
                         update_stats=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, st)

    (_, (want, jst)), jg = jax.value_and_grad(f, has_aux=True)(var["params"])
    m = gan.spectral_dense("sn", 8, 6)
    assert isinstance(m, gan.SpectralNormDense)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(var["params"]["layer_instance"]["kernel"].T.copy()))
        m.bias.copy_(torch.from_numpy(var["params"]["layer_instance"]["bias"]))
        m.u.copy_(torch.from_numpy(stats[0]))
        m.sigma.copy_(torch.from_numpy(stats[1]))
    got = m(torch.from_numpy(x), update_stats=True)
    (got * torch.from_numpy(r)).sum().backward()
    _close(got.detach().numpy(), np.asarray(want), what="out")
    _close(m.u.numpy(), np.asarray(jst["batch_stats"]["layer_instance/kernel/u"]), what="u")
    _close(float(m.sigma), float(jst["batch_stats"]["layer_instance/kernel/sigma"]), what="sigma")
    _close(m.weight.grad.numpy().T, np.asarray(jg["layer_instance"]["kernel"]), what="grad")


def test_spectral_dense_factory():
    assert isinstance(gan.spectral_dense("isn", 4, 3), gan.ImprovedSpectralDense)
    plain = gan.spectral_dense("none", 4, 3)
    assert type(plain).__name__ == "Dense" and tuple(plain.weight.shape) == (3, 4)


def gan_tiny_cfg():
    from test_models_smoke import tiny_config

    cfg = tiny_config(use_pg=False, use_ii=True)
    cfg.model.vid_inpainting_losses = ["sharp_vid", "adv", "dis"]
    return cfg


def test_synthesizer_id_round_trip():
    """A synthesizer with the GAN holds "id"; JAX's init_params tree loads
    into it (from_jax) and comes back equal (to_jax), every leaf."""
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.config import from_dict, to_dict
    from waldo_tpu_torch.models import Synthesizer

    cfg = gan_tiny_cfg()
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0)))
    assert sorted(params) == ["id", "ii", "pe"]
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    assert sorted(syn.nets()) == ["id", "ii", "pe"]
    from_jax(params, syn)
    back = _flatten(to_jax(syn)["id"])
    want = _flatten(params["id"])
    assert sorted(back) == sorted(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    # without the GAN losses there is no discriminator
    cfg.model.vid_inpainting_losses = ["sharp_vid"]
    assert "id" not in Synthesizer(from_dict(to_dict(cfg)), device="cpu").nets()


def test_jax_id_slot_converts(tmp_path):
    """scripts/jax_slots_to_torch.py carries a JAX run's "id" slot, which
    the port's checkpoint manager restores leaf for leaf."""
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from waldo_tpu_torch.config import from_dict, to_dict
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.train import CheckpointManager

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import jax_slots_to_torch

    cfg = gan_tiny_cfg()
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(1)))
    src = str(tmp_path / "jax")
    JaxCheckpointManager(src).save("id", params["id"], 5, name="latest")
    JaxCheckpointManager(src).save("ii", params["ii"], 5, name="latest")
    dst = str(tmp_path / "port")
    written = jax_slots_to_torch.main([src, dst, "--which", "latest"])
    assert sorted(os.path.basename(p) for p in written) == ["id_latest.npz", "ii_latest.npz"]
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    got = _flatten(CheckpointManager(dst).restore("id", to_jax(syn)["id"], "latest", strict=True))
    want = _flatten(params["id"])
    assert all(np.array_equal(got[k], want[k]) for k in want)
