"""Package-level contracts of the port, on the CPU: it imports nothing of
JAX or of the JAX package, its config mirrors the JAX one, its entry points
ask for CUDA unless told otherwise, the kernel wrappers refuse CPU tensors,
and the parameter converter is strict."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import waldo_tpu.config as jcfg
import waldo_tpu_torch.config as tcfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "waldo_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "waldo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {f.relative_to(ROOT / "waldo_tpu_torch").parts[0] for f in files[:-1]}
    assert {"train", "data", "cli", "ops", "models", "utils"} <= scanned, scanned
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("cls", ["Config", "DataConfig", "ModelConfig"])
def test_config_fields_and_defaults_match_jax(cls):
    def table(mod):
        out = {}
        for f in dataclasses.fields(getattr(mod, cls)):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
            else:
                out[f.name] = dataclasses.MISSING
        return out

    jt, tt = table(jcfg), table(tcfg)
    assert list(jt) == list(tt)
    for name in jt:
        if cls == "Config" and name in ("data", "model"):
            assert jcfg.to_dict(jcfg.Config())[name] == tcfg.to_dict(tcfg.Config())[name]
        else:
            assert jt[name] == tt[name], name


def test_flagship_cfg_matches_bench_config():
    from __graft_entry__ import _flagship_cfg

    want = _flagship_cfg(load_dim=256)
    want.compute_dtype = "bfloat16"
    want.model.fast_inverse_warp = True
    assert jcfg.to_dict(want) == tcfg.to_dict(tcfg.flagship_cfg())


def test_synthesizer_asks_for_cuda_by_default():
    from waldo_tpu_torch.models import Synthesizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(tcfg.Config())


def test_mat_inpainter_asks_for_cuda_by_default():
    from waldo_tpu_torch.models.mat import MatInpainter

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MatInpainter(resolution=128)


def test_flagship_mat_cfg_is_flagship_plus_test_mat_flags():
    want = tcfg.to_dict(tcfg.flagship_cfg())
    flags = ("loop_ii", "inpaint_obj", "propagate_unique", "use_shadows", "use_expansion",
             "soft_shadow", "propagate_obj", "use_inpainter", "use_mat_inpainter",
             "restrict_to_ctx")
    for f in flags:
        want["model"][f] = True
    assert tcfg.to_dict(tcfg.flagship_mat_cfg()) == want


def test_kernel_wrappers_refuse_cpu_tensors():
    from waldo_tpu_torch.ops.kernels import (KERNELS, bias_act_cuda, grid_sample_cuda,
                                             warp_alpha_ctx_cuda)

    img = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        grid_sample_cuda(img, torch.zeros(1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        warp_alpha_ctx_cuda(img, torch.zeros(1, 3, 4, 4, 2), torch.zeros(1, 3, 3), None, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        bias_act_cuda(img, torch.zeros(3), "lrelu", 1.0, None)
    assert all(k.launches == 0 for k in KERNELS.values())


@pytest.fixture(scope="module")
def lvd_only():
    import jax
    from waldo_tpu.config import to_dict
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.models import Synthesizer
    from test_torch_nets import tiny_cfg

    cfg = tiny_cfg()
    cfg.model.use_pg = cfg.model.use_ii = False
    params = jax.tree.map(np.asarray, JaxSynthesizer(cfg).init_params(jax.random.PRNGKey(0)))
    return params, Synthesizer(tcfg.from_dict(to_dict(cfg)), device="cpu")


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def test_from_jax_loads_a_full_tree(lvd_only):
    from waldo_tpu_torch.convert import from_jax

    params, syn = lvd_only
    from_jax(params, syn)
    want = params["pe"]["params"]["pose_estimator"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(syn.lvd.pose_estimator.head.weight.detach().numpy(), want.T)


@pytest.mark.parametrize("edit,err", [
    ("missing_leaf", KeyError), ("extra_leaf", ValueError),
    ("extra_net", ValueError), ("bad_shape", ValueError)])
def test_from_jax_is_strict(lvd_only, edit, err):
    from waldo_tpu_torch.convert import from_jax

    params, syn = lvd_only
    p = _copy(params)
    head = p["pe"]["params"]["pose_estimator"]["Dense_0"]
    if edit == "missing_leaf":
        del head["bias"]
    elif edit == "extra_leaf":
        head["scale"] = np.ones(3, np.float32)
    elif edit == "extra_net":
        p["id"] = {"params": {"w": np.ones(2, np.float32)}}
    else:
        head["kernel"] = head["kernel"][:, :-1]
    with pytest.raises(err):
        from_jax(p, syn)
