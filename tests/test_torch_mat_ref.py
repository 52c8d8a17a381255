"""The port's MAT against the benchmark's plain reference
(``benchmark/plainref``: ``models/mat.py``, ``models/mat_pipeline.py``), on
the CPU, where the port runs no kernel; nothing of the JAX package runs.

- The generator at ``img_resolution`` 128 on the benchmark's seeded MAT
  state (``wbench/weights_mat.py``: the published MAT's initialisation) and
  a random hole mask.
- ``inpaint_with_mat`` at a small Cityscapes-shaped configuration (the
  benchmark's ``cityscapes_mat`` flags with 64x128 frames, 3 of them after 2
  of context; MAT at 128, so a frame runs as 3 crops of 128x128), with
  ``propagate_obj`` on and off. Both chains take the port's predict of one
  clip, MAT's one state and one z state; the reference warps and fuses with
  its own warper and WIF on the same weights.
- The generator's spans: ``mat/transformer`` and ``mat/decoder`` once each a
  forward, inside ``mat/generator``, as many as ``MatInpainter.calls``.
"""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

SEED = 2 ** 31 + 21
MAT_RES = 128
# a small Cityscapes geometry: the nets cut as the benchmark's own CPU tests
# cut them, 64x128 frames with flows at 32x64, 2 frames of context and 1
# predicted
SMALL = ["--dim", "32", "--s_patch_size", "8", "--s_latent_shape", "4,8", "--s_embed_dim", "64",
         "--s_num_heads", "4", "--s_num_obj", "4", "--s_oe_depth", "1", "--s_pe_depth", "1",
         "--s_pg_com_depth", "1", "--s_pg_enc_depth", "1", "--s_pg_dec_depth", "1",
         "--s_pg_num_timesteps", "5", "--s_oe_num_timesteps", "5", "--s_ii_depth", "2",
         "--s_ii_embed_dim", "32", "--s_ctx_len", "2", "--data.vid_len", "3",
         "--load_dim", "64", "--flow_dim", "32", "--batch_size_vid", "1"]


def mat_state():
    from wbench import weights_mat

    return weights_mat.make(SEED, "cpu", MAT_RES)


def port_inpainter(state):
    from waldo_tpu_torch.models.mat import MatInpainter

    inp = MatInpainter(None, resolution=MAT_RES, device="cpu")
    inp.net.load_state_dict(state)
    return inp


def ref_inpainter(state):
    from plainref.models.mat_pipeline import MatInpainter

    inp = MatInpainter("cpu", MAT_RES)
    inp.load(state)
    return inp


def test_generator_matches_the_reference():
    """Tolerance: the two nets run the same float32 operations in the same
    order on the CPU, so they agree to the last bit; 1e-5 of max|ref| leaves
    room for the rounding of a summation order that differs (about 1e-6
    relative a layer, over the generator's ~40 layers; random weights do not
    bound the output to [-1, 1])."""
    state = mat_state()
    port, ref = port_inpainter(state), ref_inpainter(state)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand(1, MAT_RES, MAT_RES, 3, generator=gen) * 2 - 1
    holes = torch.rand(1, MAT_RES // 16, MAT_RES // 16, 1, generator=gen) < 0.4
    keep = (~holes).float().repeat_interleave(16, 1).repeat_interleave(16, 2)
    z = torch.randn(1, 512, generator=gen)
    with torch.inference_mode():
        got = port.net(x, keep, z, truncation_psi=0.5, noise_mode="const")
        want = ref.net(x, keep, z, truncation_psi=0.5)
    assert torch.isfinite(want).all()
    assert float((want - x).abs().amax()) > 0.1  # the holes were filled
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.fixture(scope="module")
def clip():
    """The configuration, the port's synthesizer, the reference and the port's
    predict of one seeded clip."""
    from plainref.config import parse_cli as ref_parse
    from waldo_tpu_torch.config import parse_cli
    from waldo_tpu_torch.models import Synthesizer
    from wbench import check, traffic, weights
    from wbench.spec import load_cell, run_flags
    from plainref.synthesizer import Reference

    cell = load_cell("cityscapes_mat.eval")
    cell.config["changed"] = list(cell.config["changed"]) + SMALL
    flags = run_flags(cell, "/nonexistent", SEED)
    cfg, rcfg = parse_cli(list(flags)), ref_parse(list(flags))
    made = weights.make(Reference(rcfg, "cpu", meta=True).nets(), SEED, "cpu",
                        cell.traffic["weights"])
    batch = traffic.batches(cfg, dict(cell.traffic, loop="eval", pool=1), SEED, "cpu",
                            host=False)[0]
    syn = Synthesizer(cfg, device="cpu")
    weights.load_into(syn.nets(), made)
    with torch.inference_mode():
        out = syn.predict(batch)
    return cfg, syn, check.reference(rcfg, made, "cpu"), batch, out


_CHAINS = {}


def chains(clip, propagate_obj):
    """inp_pred_vid of the port's chain (traced) and of the reference's, from
    one MAT state and one z state; the trace and the port's MAT calls. With
    ``propagate_obj`` the context alphas hold an object on the last predicted
    frame's left border columns and another on its right ones, so that both
    off-screen completions run."""
    from plainref.models.mat_pipeline import inpaint_with_mat as ref_chain
    from waldo_tpu_torch.models.mat_pipeline import inpaint_with_mat

    if propagate_obj in _CHAINS:
        return _CHAINS[propagate_obj]
    cfg, syn, ref, batch, out = clip
    state = mat_state()
    port, plain = port_inpainter(state), ref_inpainter(state)
    plain.generator.set_state(port.generator.get_state())
    cfg.model.propagate_obj = ref.cfg.model.propagate_obj = propagate_obj
    alpha_ctx = out["pred_alpha_ctx"]
    if propagate_obj:
        alpha_ctx = alpha_ctx.clone()
        alpha_ctx[:, :, -1, :, :3, 1] = 1.0
        alpha_ctx[:, :, -1, :, -3:, 2] = 1.0
    args = (out["pred_raw_output"], out["pred_alpha"], alpha_ctx, batch["vid"],
            out["pred_flow"], cfg.model.ctx_len, out["pred_grids"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = inpaint_with_mat(cfg, syn.warper, syn.wif, port, *args)
    want = ref_chain(ref.cfg, ref.warper, ref.wif, plain, *args)
    assert port.calls == plain.calls
    _CHAINS[propagate_obj] = got, want, prof, port.calls
    return _CHAINS[propagate_obj]


@pytest.mark.parametrize("propagate_obj", [False, True])
def test_inpaint_with_mat_matches_the_reference(clip, propagate_obj):
    """Compared as the benchmark's check compares videos: the mean gap and the
    share of elements more than 1e-3 apart (a pixel on a mask's threshold may
    flip on either side; on the CPU none does)."""
    got, want, _, calls = chains(clip, propagate_obj)
    tp = got.shape[1] - clip[0].model.ctx_len
    # 3 crops for the reference frame and for each predicted one, and 3 for
    # each border an object leaves by
    assert calls == 3 * (tp + 1) + (6 if propagate_obj else 0)
    assert got.shape == want.shape and torch.isfinite(want).all()
    gap = (got - want).abs()
    assert float(gap.mean()) <= 1e-6 * max(float(want.abs().max()), 1.0)
    assert float((gap > 1e-3).float().mean()) <= 1e-3


def test_generator_spans_once_a_forward(clip):
    """Each forward opens ``mat/generator`` once, and inside it
    ``mat/transformer`` then ``mat/decoder`` once each; as many forwards as
    ``MatInpainter.calls``."""
    _, _, prof, calls = chains(clip, False)
    rows = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("mat/")), key=lambda r: r[1])
    gens = [r for r in rows if r[0] == "mat/generator"]
    assert len(gens) == calls > 0
    for _, s, e in gens:
        inner = [r for r in rows if r[0] in ("mat/transformer", "mat/decoder")
                 and s <= r[1] and r[2] <= e]
        assert [r[0] for r in inner] == ["mat/transformer", "mat/decoder"]
        assert inner[0][2] <= inner[1][1]
    assert sum(r[0] == "mat/transformer" for r in rows) == calls
    assert sum(r[0] == "mat/decoder" for r in rows) == calls
