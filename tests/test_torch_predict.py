"""The whole slice: the port's ``Synthesizer.predict`` against the JAX
package's, on the CPU.

Tiny config in the shape of tests/test_models_smoke.py with load_dim 64, so
the HD resize path runs, the iterative grid inversion, B=1, and every
parameter leaf perturbed with seeded noise before it is carried across by
``from_jax``. Both pipelines get the same numpy batch.

Tolerances (absolute, on videos in [-1, 1] and flows in normalized units):
  "float32" sampling: 1e-3. The nets agree to ~1e-6; what is left is the
            fixed-point inversion and the samplers, summed in another order.
  "fast":   2e-2. Both sides store the alpha and warped-context maps in
            bf16 at the same places (warper.py:288-291, 365-366, 457-461), so
            one bf16 step (~4e-3 on a value near 1) may round differently on
            each side and be carried through a few products.
The inverse warp's hole mask is a hard threshold; at this seed no pixel
falls on the other side of it, so no pixel is exempt from the tolerance.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.config import to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.convert import from_jax
from waldo_tpu_torch.models import Synthesizer

from test_torch_nets import perturbed_params, tiny_cfg

ATOL = {"float32": 1e-3, "fast": 2e-2}
KEYS = ("rec_vid", "inp_rec_vid", "pred_vid", "inp_pred_vid", "pred_flow")


def tiny_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    t, nl = cfg.data.vid_len, cfg.data.num_lyt
    hd, wd = cfg.load_dim, int(cfg.load_dim * cfg.aspect_ratio)
    h, w = cfg.dim, int(cfg.dim * cfg.aspect_ratio)
    lyt = 5.0 * (2 * np.eye(nl, dtype=np.float32)[rng.randint(0, nl, (1, t, hd, wd))] - 1)
    return {"vid": (rng.rand(1, t, hd, wd, 3) * 2 - 1).astype(np.float32),
            "lyt": lyt.astype(np.float32),
            "flow": (rng.randn(1, t, h, w, 2) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def params():
    return perturbed_params(JaxSynthesizer(tiny_cfg()))


@pytest.fixture(scope="module", params=["float32", "fast"])
def outputs(request, params):
    cfg = tiny_cfg()
    cfg.model.sample_precision = request.param
    batch = tiny_batch(cfg)
    jsyn = JaxSynthesizer(cfg)
    want = jax.jit(jsyn.predict)(jax.tree.map(jnp.asarray, params),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    tsyn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    from_jax(params, tsyn)
    got = tsyn.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    return request.param, batch, want, got


@pytest.mark.parametrize("key", KEYS)
def test_predict_matches_jax(outputs, key):
    precision, batch, want, got = outputs
    w = np.asarray(want[key], np.float32)
    g = got[key].float().numpy()
    assert g.shape == w.shape, (key, g.shape, w.shape)
    assert np.isfinite(g).all()
    err = float(np.abs(g - w).max())
    assert err <= ATOL[precision], f"{key} ({precision}): max|err| {err:.3g}"
    if key in ("pred_vid", "inp_pred_vid"):
        ctx = tiny_cfg().model.ctx_len
        np.testing.assert_array_equal(g[:, :ctx], batch["vid"][:, :ctx])
