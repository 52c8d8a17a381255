"""scripts/jax_slots_to_torch.py on the CPU: a JAX training run's orbax
slots (numbered and named, for LVD, FLP and WIF) at tests/test_torch_nets.py's
tiny config, converted to the port's .npz slots, restore in the port's
CheckpointManager with every leaf equal to the saved one, and the port's
predict from them equals the JAX predict from the saved parameters at the
predict's float32 tolerance (1e-3, tests/test_torch_predict.py).
"""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from waldo_tpu.config import save_config as jax_save_config, to_dict
from waldo_tpu.models import Synthesizer as JaxSynthesizer
from waldo_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager

from waldo_tpu_torch.config import from_dict, load_config
from waldo_tpu_torch.convert import from_jax, to_jax
from waldo_tpu_torch.models import Synthesizer
from waldo_tpu_torch.train import CheckpointManager
from waldo_tpu_torch.train.checkpoint import _flatten

from test_torch_nets import perturbed_params, tiny_cfg
from test_torch_predict import tiny_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import jax_slots_to_torch  # noqa: E402

NETS = ("pe", "pg", "ii")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """JAX slots (iteration 3, "latest" at iteration 4, "best_vid" at 2) of
    perturbed parameters, and the port's directory converted from them."""
    cfg = tiny_cfg()
    cfg.model.sample_precision = "float32"
    src = tmp_path_factory.mktemp("jax_run")
    cfg.save_path, cfg.name = str(src), "run"
    params = perturbed_params(JaxSynthesizer(cfg))
    mgr = JaxCheckpointManager(cfg.checkpoint_path)
    jax_save_config(cfg)
    older = jax.tree.map(lambda a: a * 0.5, params)
    for net in NETS:
        mgr.save(net, older[net], 3)
        mgr.save(net, params[net], 4, name="latest")
        mgr.save(net, older[net], 2, name="best_vid")
    dst = str(tmp_path_factory.mktemp("port_run"))
    written = jax_slots_to_torch.main([cfg.checkpoint_path, dst])
    return cfg, params, older, dst, written


def test_every_slot_is_written(converted):
    cfg, _, _, dst, written = converted
    want = {f"{net}_{tag}.npz" for net in NETS for tag in ("3", "latest", "best_vid")}
    assert {os.path.basename(p) for p in written} == want
    assert want <= set(os.listdir(dst))
    for net in NETS:
        with open(os.path.join(dst, f"{net}_latest.iter")) as f:
            assert f.read().strip() == "4"
        with open(os.path.join(dst, f"{net}_best_vid.iter")) as f:
            assert f.read().strip() == "2"
        assert not os.path.exists(os.path.join(dst, f"{net}_3.iter"))
    assert to_dict(load_config(os.path.join(dst, "config.json"))) == to_dict(
        from_dict(to_dict(cfg)))
    assert CheckpointManager(dst).latest_iter("pe") == 4


@pytest.mark.parametrize("which", ["latest", "3", "best_vid"])
def test_port_restores_equal_leaves(converted, which):
    cfg, params, older, dst, _ = converted
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    template = to_jax(syn)
    src = params if which == "latest" else older
    mgr = CheckpointManager(dst)
    for net in NETS:
        got = _flatten(mgr.restore(net, template[net], which=which, strict=True))
        want = _flatten(jax.tree.map(np.asarray, src[net]))
        assert sorted(got) == sorted(want), net
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{net} {k}")


def test_one_slot_by_name(converted, tmp_path):
    cfg, params, _, _, _ = converted
    written = jax_slots_to_torch.main([cfg.checkpoint_path, str(tmp_path), "--nets", "pg",
                                       "--which", "latest"])
    assert [os.path.basename(p) for p in written] == ["pg_latest.npz"]


def test_port_predict_from_converted_slots_equals_jax(converted):
    cfg, params, _, dst, _ = converted
    syn = Synthesizer(from_dict(to_dict(cfg)), device="cpu")
    mgr = CheckpointManager(dst)
    template = to_jax(syn)
    from_jax({net: mgr.restore(net, template[net], strict=True) for net in NETS}, syn)
    batch = tiny_batch(cfg)
    want = jax.jit(JaxSynthesizer(cfg).predict)(jax.tree.map(jnp.asarray, params),
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    got = syn.predict({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("rec_vid", "inp_rec_vid", "pred_vid", "inp_pred_vid"):
        err = float(np.abs(got[key].float().numpy() - np.asarray(want[key], np.float32)).max())
        assert err <= 1e-3, (key, err)
