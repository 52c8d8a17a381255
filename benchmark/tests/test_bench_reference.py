"""The frozen reference against the port's plain path (the CPU, where the
port runs no kernel) at a tiny geometry of each configuration, on the
benchmark's own weights and inputs; and the weights' laws."""
import pytest
import torch
from tiny import tiny_cell

SEED = 2 ** 31 + 99


def build(workload):
    from plainref.config import parse_cli as ref_parse
    from plainref.synthesizer import Reference
    from waldo_tpu_torch.config import parse_cli
    from wbench import traffic, weights
    from wbench.spec import run_flags

    cell = tiny_cell(workload)
    flags = run_flags(cell, "/nonexistent", SEED)
    cfg, rcfg = parse_cli(list(flags)), ref_parse(list(flags))
    made = weights.make(Reference(rcfg, "cpu", meta=True).nets(), SEED, "cpu",
                        cell.traffic["weights"])
    pool = traffic.batches(cfg, cell.traffic, SEED, "cpu", host=False)
    return cell, cfg, rcfg, made, pool


@pytest.mark.parametrize("config", ["cityscapes", "kitti"])
def test_predict_matches_the_port(config):
    from waldo_tpu_torch.models import Synthesizer
    from wbench import check
    from wbench.weights import load_into

    cell, cfg, rcfg, made, pool = build(f"{config}.eval")
    syn = Synthesizer(cfg, device="cpu")
    load_into(syn.nets(), made)
    got = syn.predict(pool[0])
    want, _, _ = check.reference_clip(check.reference(rcfg, made, "cpu"), pool[0],
                                      "cpu")
    for k, v in want.items():
        assert torch.equal(got[k].float(), v), k


@pytest.mark.parametrize("config", ["cityscapes", "kitti"])
def test_lvd_steps_match_the_port(config):
    from waldo_tpu_torch.train.train_state import NetState
    from waldo_tpu_torch.models import Synthesizer
    from wbench import check
    from wbench.weights import load_into

    cell, cfg, rcfg, made, pool = build(f"{config}.train_lvd")
    syn = Synthesizer(cfg, device="cpu", seed=cfg.seed)
    load_into({"pe": syn.lvd}, {"pe": made["pe"]})
    state = NetState(syn.lvd, cfg.model)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    losses = []
    for k in range(2):
        state.zero_grad()
        loss, _ = syn.extract_object_loss(pool[k], k, generator=gen)
        loss.backward()
        state.apply(loss)
        losses.append(float(loss))
    want = check.reference_steps(rcfg, made, pool, 2, "cpu", "pe", "extract_object_loss")
    assert losses == want["losses"]
    for p, q in zip(state.params, want["params"]):
        assert torch.equal(p.detach(), q)


def test_weights_follow_the_flags_and_the_seed():
    from plainref.synthesizer import Reference
    from wbench import weights

    cell, cfg, rcfg, made, pool = build("cityscapes.eval")
    nets = Reference(rcfg, "cpu", meta=True).nets()
    init = weights.make(nets, SEED, "cpu", "initialized")
    # test.sh's pe_estimator_init_mode zero: an initialised pose head is 0,
    # a trained one (the eval cells' weights) is drawn like any dense kernel
    head = "pose_estimator.head.weight"
    assert float(init["pe"][head].abs().max()) == 0.0
    assert cell.traffic["weights"] == "trained" and float(made["pe"][head].abs().max()) > 0
    norm = [n for n in made["pe"] if n.endswith("norm.weight")][0]
    assert torch.equal(made["pe"][norm], torch.ones_like(made["pe"][norm]))
    dense = made["pe"]["pose_estimator.blocks.layers.0.mlp.fc1.weight"]
    assert 0.015 < float(dense.std()) < 0.02 and float(dense.abs().max()) <= 0.04 + 1e-6
    again = weights.make(nets, SEED, "cpu", "trained")
    other = weights.make(nets, SEED + 1, "cpu", "trained")
    conv = "encoder.proj.conv_in.weight"
    assert torch.equal(again["pe"][conv], made["pe"][conv])
    assert not torch.equal(other["pe"][conv], made["pe"][conv])


def test_traffic_keeps_the_loaders_contract():
    cell, cfg, rcfg, made, pool = build("cityscapes.eval")
    b = pool[0]
    t, h, w = cfg.data.vid_len, cfg.load_dim, int(cfg.load_dim * cfg.aspect_ratio)
    assert b["vid"].shape == (1, t, h, w, 3) and b["lyt"].shape == (1, t, h, w, cfg.data.num_lyt)
    assert b["flow"].shape == (1, t, cfg.flow_dim, int(cfg.flow_dim * cfg.aspect_ratio), 2)
    assert float(b["vid"].min()) >= -1 and float(b["vid"].max()) <= 1
    assert set(b["lyt"].unique().tolist()) == {-5.0, 5.0}
    assert float(b["flow"][:, 0].abs().max()) == 0.0
    assert not torch.equal(pool[0]["vid"], pool[1]["vid"])
