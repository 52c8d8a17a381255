"""Data parallelism over processes (waldo_tpu_torch/parallel/ and the
rank-aware loader, step, losses, trainer and evaluator) on the CPU.

The contract: a run at world size W gives world 1's batches, draws, losses,
gradients and parameters on the same global batch, to summation order.

The loader's rows are checked without processes. The rest runs in W = 2
gloo ranks, spawned once for the module (``ranks``): each rank runs every
job below and writes what it saw; the parent computes world 1 meanwhile.
The children import the port and the test module only, whose top level
imports no JAX (they report what they imported); the parent imports the
JAX package for its references inside the fixtures. A rendezvous file under
the test's tmp dir keeps xdist workers apart; the process group's timeout
and the join's are short, so a hang fails the module instead of eating the
suite's clock.

Tolerances:
  two LVD Adam steps: those of tests/test_torch_train.py's
      test_two_adam_steps_match_jax_train_step, against both world 1 and
      the JAX train_step_fn (2e-4 relative on the loss; on each leaf 2e-6
      on 99.9 % of the elements and 4e-4, what two steps can move one, on
      all); the ranks' parameters bitwise equal after each step.
  one step's reduced gradients (FLP, the activity terms): per leaf 1e-4 x
      the leaf's largest plus 1e-7 x the largest of all leaves; the ranks'
      mean metrics 1e-5 relative (the sum over two ranks' rows against one
      sum over the batch, in float32).
  Trainer.run (two steps, then an eval): eval means 1e-4 relative, the
      parameters after an Adam step differing as above.
  Evaluator.run: the videos that FLP's rollout makes (pred_vid,
      inp_pred_vid) within the float32-sampling predict's 1e-3, their
      metric means within 1e-3 (PSNR relative): FLP's products round
      differently at 1 and 2 clips a call (~1e-7; a clip's outputs do not
      depend on the other clips of its batch) and the fusion carries that
      through its hard decisions, as tests/test_torch_evaluator.py records;
      the other videos bitwise equal, their means 1e-6 relative.
"""
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.data import DataLoader, create_dataset
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W = 2
TIMEOUT_S = 60  # the children's process-group timeout, and the join's after the parent's work
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "waldo_tpu")
VID_TOL = 1e-3  # the float32-sampling predict's (tests/test_torch_predict.py)



# ---------------------------------------------------------------------------
# the jobs, run by every rank and, at world 1, by the parent
# ---------------------------------------------------------------------------


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _perturbed(cfg, seed=0):
    """A synthesizer of seeded weights, every parameter moved by seeded noise
    (the zero-initialized heads would hide layers)."""
    from waldo_tpu_torch.models import Synthesizer

    syn = Synthesizer(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for net in syn.nets().values():
            for p in net.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
    return syn


def _named(module, values):
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    return {n: v.detach().numpy().copy() for n, v in zip(names, values)}


def job_lvd_steps(job, shard):
    """Two Adam steps of LVD on the shard's rows (the parameters after each;
    the other ranks start from moved parameters, which the optimizer state's
    broadcast replaces), then the NaN vote: the last rank's rows made
    non-finite, one step."""
    from waldo_tpu_torch.convert import from_jax
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.train import NetState

    cfg = from_dict(job["lvd_cfg"])
    syn = Synthesizer(cfg, device="cpu")
    from_jax(job["lvd_params"], syn)
    if shard.offset:  # NetState broadcasts rank 0's parameters, as DDP does
        with torch.no_grad():
            for p in syn.lvd.parameters():
                p.add_(1.0)
    st = NetState(syn.lvd, cfg.model)
    batch = {k: shard.rows(v) for k, v in _tensors(job["lvd_batch"]).items()}
    out = {"loss": [], "params": []}
    for it in range(2):
        st.zero_grad()
        loss, _ = syn.extract_object_loss(batch, it, generator=torch.Generator().manual_seed(1),
                                          shard=shard)
        loss.backward()
        st.apply(loss)
        out["loss"].append(float(loss.detach()))
        out["params"].append(_named(syn.lvd, st.params))
    last = shard.offset + shard.size == shard.total
    bad = {k: v * float("nan") if last else v for k, v in batch.items()}
    before = [t.clone() for t in st.params + st.mu + st.nu + [st.count]]
    st.zero_grad()
    loss, _ = syn.extract_object_loss(bad, 2, generator=torch.Generator().manual_seed(1),
                                      shard=shard)
    loss.backward()
    st.apply(loss)
    after = st.params + st.mu + st.nu + [st.count]
    out["nan"] = dict(loss_finite=bool(torch.isfinite(loss)),
                      unchanged=all(torch.equal(a, b) for a, b in zip(before, after)),
                      count=int(st.count), nancount=int(st.nancount))
    return out


def job_one_step(job, shard, key):
    """One loss (``job[key]``: config, batch, loss, trained net) and its
    gradient reduced over the ranks, with the rank's metrics."""
    from waldo_tpu_torch.train import NetState

    spec = job[key]
    cfg = from_dict(spec["cfg"])
    syn = _perturbed(cfg)
    for name, net in syn.nets().items():
        net.requires_grad_(name == spec["net"])
    module = syn.nets()[spec["net"]]
    st = NetState(module, cfg.model)
    batch = {k: shard.rows(v) for k, v in _tensors(spec["batch"]).items()}
    loss, metrics = getattr(syn, spec["loss"])(
        batch, 0, generator=torch.Generator().manual_seed(5), shard=shard)
    loss.backward()
    grads, finite = st.gradients(loss)
    return {"grads": _named(module, grads), "finite": bool(finite),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def job_gan_steps(job, shard):
    """One WIF step with adv and the adaptive lambda, then one
    discriminator step, each applied, on the shard's rows: the rank's
    metrics and the nets' parameters after each."""
    from waldo_tpu_torch.train import NetState

    cfg = from_dict(job["gan"]["cfg"])
    syn = _perturbed(cfg)
    syn.lvd.requires_grad_(False)
    batch = {k: shard.rows(v) for k, v in _tensors(job["gan"]["batch"]).items()}
    out = {}
    for key, net, loss_fn in (
            ("g", "ii", lambda: syn.inpaint_loss(batch, 0, shard=shard, adv=True)),
            ("d", "id", lambda: syn.discriminate_loss(batch, 0, shard=shard))):
        module = syn.nets()[net]
        st = NetState(module, cfg.model)
        st.zero_grad()
        loss, metrics = loss_fn()
        loss.backward()
        st.apply(loss)
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": _named(module, st.params)}
    return out


def job_trainer(job, rank):
    """Trainer.run(2) with an eval after the second step, then a cont_train
    rerun to 3; every rank names the run after itself before the trainer
    broadcasts rank 0's name. Records the eval means and, on the other
    ranks, every write the trainer attempted."""
    import waldo_tpu_torch.train.trainer as trainer_mod
    from waldo_tpu_torch.train import CheckpointManager, Trainer

    writes = []
    if rank:
        for name in ("save_config", "Logger"):
            orig = getattr(trainer_mod, name)
            setattr(trainer_mod, name,
                    lambda *a, _n=name, _o=orig, **k: (writes.append(_n), _o(*a, **k))[1])
        orig_save = CheckpointManager.save
        CheckpointManager.save = lambda self, *a, **k: (writes.append("save"),
                                                        orig_save(self, *a, **k))[1]
    cfg = from_dict(job["trainer_cfg"])
    cfg.datetime = f"rank{rank}"
    tr = Trainer(cfg, device="cpu")
    evals = []
    orig_eval = tr.evaluate
    tr.evaluate = lambda it: evals.append(orig_eval(it)) or evals[-1]
    tr.run(num_iter=2)
    out = {"datetime": cfg.datetime, "evals": evals, "count": int(tr.states["pe"].count),
           "params": _named(tr.syn.lvd, tr.states["pe"].params)}
    cfg2 = from_dict(job["trainer_cfg"])
    cfg2.datetime, cfg2.cont_train = f"rank{rank}", True
    tr2 = Trainer(cfg2, device="cpu")
    tr2.run(num_iter=3)
    out.update(resumed_count=int(tr2.states["pe"].count),
               resumed_latest=tr2.ckpt.latest_iter("pe"), writes=writes)
    return out


def job_evaluator(job):
    """Evaluator.run() with every dumped video captured by (folder, file)."""
    import waldo_tpu_torch.train.evaluator as evaluator_mod
    from waldo_tpu_torch.train import Evaluator

    vids = {}
    orig = evaluator_mod.save_video_frames

    def save(vid, path, fps=4):
        vids[os.path.basename(os.path.dirname(path)), os.path.basename(path)] = np.array(vid)
        return orig(vid, path, fps=fps)

    evaluator_mod.save_video_frames = save
    try:
        metrics = Evaluator(from_dict(job["eval_cfg"]), device="cpu").run()
    finally:
        evaluator_mod.save_video_frames = orig
    return {"metrics": metrics, "vids": vids}


def run_jobs(job, rank, save_path):
    """Every job at this process's world size (world 1 without a process
    group), ``save_path`` replacing the trainer's and evaluator's."""
    from waldo_tpu_torch.parallel import BatchShard

    job = dict(job, trainer_cfg=dict(job["trainer_cfg"], save_path=save_path),
               eval_cfg=dict(job["eval_cfg"], save_path=os.path.join(save_path, "eval")))
    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["lvd"] = job_lvd_steps(job, BatchShard.of_rank(len(job["lvd_batch"]["vid"]) // _world()))
    seconds["lvd"] = time.perf_counter() - t0
    for key in ("flp", "activity"):
        b = len(job[key]["batch"]["vid"]) // _world()
        out[key] = job_one_step(job, BatchShard.of_rank(b), key)
        seconds[key] = time.perf_counter() - t0 - sum(seconds.values())
    b = len(job["gan"]["batch"]["vid"]) // _world()
    out["gan"] = job_gan_steps(job, BatchShard.of_rank(b))
    seconds["gan"] = time.perf_counter() - t0 - sum(seconds.values())
    out["trainer"] = job_trainer(job, rank)
    seconds["trainer"] = time.perf_counter() - t0 - sum(seconds.values())
    out["evaluator"] = job_evaluator(job)
    seconds["evaluator"] = time.perf_counter() - t0 - sum(seconds.values())
    out["seconds"] = seconds
    return out


def _world():
    from waldo_tpu_torch.parallel import world_size

    return world_size()


def rank_main(index, world, rdzv, out_dir, job):
    """One spawned rank: the process group over ``rdzv``, every job, what it
    saw written to ``out_dir``/rank<index>.pt."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(index), LOCAL_RANK=str(index))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from waldo_tpu_torch.parallel import init_distributed, mesh

    init_distributed("cpu", timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}")
    out = run_jobs(job, index, os.path.join(out_dir, "w2"))
    out["backend"] = dist.get_backend()
    out["world"] = mesh.world_size()
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    torch.save(out, os.path.join(out_dir, f"rank{index}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the spawned ranks and world 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' results, world 1's, the job, the JAX steps, the root)."""
    import jax

    import waldo_tpu.config as jconfig
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu_torch.config import to_dict
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.train import CheckpointManager

    from chip_smoke import write_cityscapes_tree
    from test_models_smoke import tiny_batch, tiny_config
    from test_torch_evaluator import eval_cfg
    from test_torch_train import lvd_cfg, train_cfg

    root = tmp_path_factory.mktemp("dist")
    # LVD: test_torch_train.lvd_params's parameters and batch (B = 2)
    jcfg = lvd_cfg()
    params = jax.tree.map(np.asarray, JaxSynthesizer(jcfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.02).astype(np.float32), params)
    lvd_batch = {k: np.asarray(v) for k, v in tiny_batch(jcfg).items()}
    # FLP with random context lengths and both training noises (B = 4)
    fcfg = tiny_config(use_ii=False)
    fcfg.model.max_ctx_length_vid = 4
    fcfg.model.pg_embed_noise = fcfg.model.pg_inject_noise = True
    # the activity terms with random contexts and input dropout (B = 4)
    acfg = tiny_config(use_pg=False, use_ii=False)
    acfg.model.vid_object_extractor_losses = (list(acfg.model.vid_object_extractor_losses)
                                              + ["activity", "topactivity"])
    acfg.model.ctx_mode, acfg.model.drop_input_p = "prev_rd", 0.3
    # WIF with adv and the adaptive lambda, and the discriminator (B = 4)
    gcfg = tiny_config(use_pg=False, use_ii=True)
    gcfg.model.vid_inpainting_losses = ["sharp_vid", "adv", "dis"]
    gcfg.model.use_adaptive_lambda = True
    # the trainer: test_torch_train.train_cfg with an eval after the second step
    tcfg = train_cfg(root, num_iter_eval=1, vid_metric="loss", max_batch_eval_vid=1,
                     log_freq=None)
    # the evaluator: test_torch_evaluator's tree and config at B = 2, slots of
    # seeded weights
    data_root = str(root / "cityscapes")
    write_cityscapes_tree(data_root, 64, 32, 2, num_cls=6)
    ecfg = from_dict(jconfig.to_dict(eval_cfg(data_root, str(root), "ev")))
    ecfg.batch_size_vid, ecfg.mesh_shape, ecfg.mesh_axes = 2, None, ["data"]
    for net, tree in to_jax(_perturbed(ecfg, seed=3)).items():
        run = str(root / "slots" / net)
        CheckpointManager(run).save(net, tree, 7, name="latest")
        setattr(ecfg.model, {"pe": "load_path", "pg": "pg_load_path",
                             "ii": "ii_load_path"}[net], run)
    job = {
        "lvd_cfg": jconfig.to_dict(jcfg), "lvd_params": params, "lvd_batch": lvd_batch,
        "flp": {"cfg": jconfig.to_dict(fcfg), "batch": _np(tiny_batch(fcfg, b=4, seed=2)),
                "loss": "generate_pose_loss", "net": "pg"},
        "activity": {"cfg": jconfig.to_dict(acfg), "batch": _np(tiny_batch(acfg, b=4, seed=3)),
                     "loss": "extract_object_loss", "net": "pe"},
        "gan": {"cfg": jconfig.to_dict(gcfg), "batch": _np(tiny_batch(gcfg, b=4, seed=4))},
        "trainer_cfg": to_dict(tcfg), "eval_cfg": to_dict(ecfg),
    }
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        rank_main, args=(W, str(root / "rdzv"), str(root), job), nprocs=W, join=False,
        start_method="spawn")
    try:
        world1 = run_jobs(job, 0, str(root / "w1"))
        t1 = time.perf_counter()
        jax_steps = _jax_two_steps(jcfg, params, lvd_batch)
        jax_s = time.perf_counter() - t1
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {W} ranks did not finish within {TIMEOUT_S} s of world 1")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(W)]
    print(f"[dist] world 1 jobs {world1['seconds']} s, JAX steps {jax_s:.1f} s, ranks "
          f"{[r['seconds'] for r in res]} s, all {time.perf_counter() - t0:.1f} s")
    return res, world1, job, jax_steps, root


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _jax_two_steps(cfg, params, batch):
    """test_torch_train.test_two_adam_steps_match_jax_train_step's JAX
    program (the persistent cache serves its compile): the losses and the
    parameters after two steps."""
    import importlib

    import jax
    import jax.numpy as jnp

    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu.train.train_state import NetState as JNetState, make_optimizer, train_step_fn
    from waldo_tpu_torch.train.checkpoint import _flatten

    jgs = importlib.import_module("waldo_tpu.ops.grid_sample")
    js = JaxSynthesizer(cfg)
    jgs.set_impl("gather")
    try:
        step = jax.jit(train_step_fn(
            lambda p, b, r, i: js.extract_object_loss(p, b, r, i)))
        state = JNetState.create(jax.tree.map(jnp.asarray, params["pe"]), make_optimizer(cfg.model))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = []
        for it in range(2):
            state, m = step(state, jb, jax.random.PRNGKey(1), jnp.float32(it))
            losses.append(float(m["loss"]))
    finally:
        jgs.set_impl("auto")
    return losses, _flatten(jax.tree.map(np.asarray, state.params)), _flatten(params["pe"])


# ---------------------------------------------------------------------------
# the checks on the spawned ranks
# ---------------------------------------------------------------------------


def test_ranks_run_gloo_and_import_no_jax(ranks):
    res, *_ = ranks
    for r in res:
        assert r["backend"] == "gloo" and r["world"] == W
        assert r["imported"] == [], r["imported"]


def _adam_close(got, want):
    """test_two_adam_steps_match_jax_train_step's tolerance, per leaf."""
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert float(diff.max()) <= 4e-4 and (diff > 2e-6).mean() <= 1e-3, (k, float(diff.max()))


def test_lvd_steps_bitwise_across_ranks_and_match_world_one_and_jax(ranks):
    """Two Adam steps at W = 2, B = 1 a rank: the ranks' parameters bitwise
    equal after each step; the ranks' mean loss and the parameters match
    world 1's steps on the B = 2 batch and the JAX train_step_fn's."""
    from waldo_tpu_torch.config import from_dict as _fd
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.train.checkpoint import _flatten

    res, world1, job, (jlosses, jparams, start), _ = ranks
    for step in range(2):
        a, b = (r["lvd"]["params"][step] for r in res)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a), f"ranks differ after step {step}"
    for it in range(2):
        mean = float(np.mean([r["lvd"]["loss"][it] for r in res]))
        for want in (world1["lvd"]["loss"][it], jlosses[it]):
            assert abs(mean - want) <= 2e-4 * abs(want), (it, mean, want)
    got, w1 = res[0]["lvd"]["params"][1], world1["lvd"]["params"][1]
    _adam_close(got, w1)
    # the flax paths of the JAX parameters, through the port's converter
    syn = Synthesizer(_fd(job["lvd_cfg"]), device="cpu")
    with torch.no_grad():
        for n, p in syn.lvd.named_parameters():
            p.copy_(torch.from_numpy(got[n]))
    got_flax = _flatten(to_jax(syn)["pe"])
    assert sorted(got_flax) == sorted(jparams)
    _adam_close(got_flax, jparams)
    moved = sum(int(np.abs(jparams[k] - start[k]).max() > 1e-5) for k in jparams)
    assert moved > len(jparams) // 2


def test_nan_vote_skips_the_step_on_every_rank(ranks):
    """The last rank's clips made non-finite: its loss is NaN, the others'
    finite, and every rank skips: parameters, moments and count unchanged,
    nancount 1 on each."""
    res, *_ = ranks
    finite = [r["lvd"]["nan"]["loss_finite"] for r in res]
    assert finite == [True] * (W - 1) + [False]
    for r in res:
        assert r["lvd"]["nan"]["unchanged"] and r["lvd"]["nan"]["count"] == 2
        assert r["lvd"]["nan"]["nancount"] == 1


def _grads_close(res, world1, key):
    g1 = world1[key]["grads"]
    top = max(float(np.abs(v).max()) for v in g1.values())
    assert top > 0
    for r in res:
        assert r[key]["finite"] and sorted(r[key]["grads"]) == sorted(g1)
        for k, want in g1.items():
            err = float(np.abs(r[key]["grads"][k] - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()) + 1e-7 * top, (key, k, err)
    a, b = res[0][key]["grads"], res[1][key]["grads"]
    assert all(np.array_equal(a[k], b[k]) for k in a)  # one all-reduce, the same sum
    for name, want in world1[key]["metrics"].items():
        mean = float(np.mean([r[key]["metrics"][name] for r in res]))
        assert abs(mean - want) <= 1e-5 * abs(want) + 1e-7, (key, name, mean, want)


def test_flp_step_matches_world_one(ranks):
    """One FLP step at W = 2 with random context lengths and both training
    noises: the draws are made at the global batch's shape, and the masked
    means divide by the global batch's count, so the ranks' mean loss and
    the reduced gradient are world 1's."""
    res, world1, job, *_ = ranks
    sizes = torch.randint(2, 5, (4, 1), generator=torch.Generator().manual_seed(5))
    assert len(set(sizes.flatten().tolist())) > 1  # the counts differ between rows
    _grads_close(res, world1, "flp")
    noise = [k for k in world1["flp"]["grads"] if k.endswith("noise_strength")]
    assert noise and all(np.abs(world1["flp"]["grads"][k]).max() > 0 for k in noise)


def test_activity_terms_match_world_one(ranks):
    """activity and topactivity (top-k over the batch's mean and over the
    batch) in the LVD loss, with random contexts and input dropout, at
    W = 2: the per-clip activities are all-gathered, so the metrics, the
    ranks' mean loss and the reduced gradients are world 1's."""
    res, world1, *_ = ranks
    for r in res:
        for name in ("activity", "topactivity"):
            want = world1["activity"]["metrics"][name]
            assert abs(r["activity"]["metrics"][name] - want) <= 1e-5 * abs(want), name
    _grads_close(res, world1, "activity")


def test_gan_steps_match_world_one(ranks):
    """A WIF step with adv and the adaptive lambda, then a discriminator
    step, at W = 2: lambda's two gradients are averaged over the ranks
    before their norms, so every rank takes world 1's lambda; the ranks'
    mean losses are world 1's, and the parameters after each step bitwise
    equal across the ranks and world 1's after an Adam step (as for the LVD
    steps, but for the discriminator's biases before a per-channel norm,
    whose gradient is 0 in exact arithmetic: within the lr an Adam step can
    move them either way)."""
    res, world1, job, *_ = ranks
    lr = from_dict(job["gan"]["cfg"]).model.lr
    normed = {f"convs.{i}.bias" for i in (1, 2, 3)}
    lam = world1["gan"]["g"]["metrics"]["adaptive_lambda"]
    assert lam > 0
    for r in res:
        assert abs(r["gan"]["g"]["metrics"]["adaptive_lambda"] - lam) <= 1e-5 * lam
    for key in ("g", "d"):
        for name, want in world1["gan"][key]["metrics"].items():
            if name in ("adaptive_lambda", "sharp_delta"):
                continue
            mean = float(np.mean([r["gan"][key]["metrics"][name] for r in res]))
            assert abs(mean - want) <= 1e-5 * abs(want) + 1e-7, (key, name, mean, want)
        a, b = (r["gan"][key]["params"] for r in res)
        assert all(np.array_equal(a[k], b[k]) for k in a), key
        for k, w in world1["gan"][key]["params"].items():
            diff = np.abs(a[k] - w)
            if key == "d" and k in normed:
                assert float(diff.max()) <= 2.0 * lr, k
            else:
                assert float(diff.max()) <= 4e-4 and (diff > 2e-6).mean() <= 1e-3, (key, k)


def test_trainer_run_two_ranks(ranks):
    """Trainer.run(2) at W = 2: one run directory (rank 0's name), files
    written by rank 0 only and the same files as world 1's, the eval means
    and the parameters world 1's, and a cont_train rerun resumes from the
    latest slot on every rank."""
    res, world1, _, _, root = ranks
    w1, w2 = world1["trainer"], [r["trainer"] for r in res]
    assert [t["datetime"] for t in w2] == ["rank0"] * W
    runs = sorted(os.listdir(root / "w2" / "checkpoints"))
    assert runs == ["rank0-t"], runs
    assert sorted(os.listdir(root / "w2" / "logs")) == ["rank0-t"]
    files = lambda d: sorted(os.path.relpath(os.path.join(p, f), d)
                             for p, _, fs in os.walk(d) for f in fs
                             if not f.startswith("events.out"))
    assert files(root / "w2" / "checkpoints" / "rank0-t") == files(
        root / "w1" / "checkpoints" / "rank0-t")
    assert all(t["writes"] == [] for t in w2[1:]), [t["writes"] for t in w2]
    for t in w2:
        assert t["count"] == 2 and t["resumed_count"] == 1 and t["resumed_latest"] == 2
        assert len(t["evals"]) == len(w1["evals"]) == 1
        for k, want in w1["evals"][0].items():
            assert abs(t["evals"][0][k] - want) <= 1e-4 * abs(want) + 1e-7, (k, want)
    _adam_close(w2[0]["params"], w1["params"])
    assert all(np.array_equal(w2[0]["params"][k], w2[1]["params"][k]) for k in w1["params"])


def test_evaluator_two_ranks(ranks):
    """Evaluator.run() at W = 2, B = 2: each rank dumps its clip under world
    1's id, the videos are world 1's, and every rank returns world 1's
    metric means."""
    res, world1, *_ = ranks
    want = world1["evaluator"]["vids"]
    got = {}
    for r in res:
        got.update(r["evaluator"]["vids"])
    folders = {k[0] for k in want}
    assert sorted(got) == sorted(want) and len(want) == 2 * len(folders) >= 6
    assert sorted(res[0]["evaluator"]["vids"]) != sorted(res[1]["evaluator"]["vids"])
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= (VID_TOL if "pred" in k[0] else 0.0), (k, err)
    for r in res:
        assert sorted(r["evaluator"]["metrics"]) == sorted(world1["evaluator"]["metrics"])
        for k, v in world1["evaluator"]["metrics"].items():
            tol = (VID_TOL * (abs(v) if k.startswith("psnr") else 1.0) if "pred" in k
                   else 1e-6 * abs(v))
            assert abs(r["evaluator"]["metrics"][k] - v) <= tol, (k, r["evaluator"]["metrics"][k], v)


# ---------------------------------------------------------------------------
# the loader's rows, without processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loader_cfgs(tmp_path_factory):
    """The synthetic training set and a Cityscapes-format training set with
    flips, zoom and colour jitter, each with eight clips or more."""
    from waldo_tpu_torch.config import parse_cli

    from chip_smoke import write_cityscapes_tree

    root = str(tmp_path_factory.mktemp("cityscapes_rows"))
    write_cityscapes_tree(root, 64, 32, 10, split="train", num_cls=6, seed=30)
    common = ["--dim", "32", "--data.vid_len", "5", "--data.num_lyt", "6", "--datetime", "x"]
    return {
        "synthetic": parse_cli(common + ["--dataset", "synthetic"]),
        "cityscapes": parse_cli(common + [
            "--dataset", "cityscapes", "--data.dataroot", root, "--load_dim", "64",
            "--true_dim", "64", "--flow_dim", "32", "--data.skip_first", "true",
            "--data.remap_lyt", "3 5 4 5", "--data.no_v_flip", "false", "--data.no_h_flip",
            "false", "--data.max_zoom", "1.6", "--data.colorjitter", "0.3"]),
    }


def _epoch(cfg, workers, world=1, rank=0, bs=4):
    loader = DataLoader(create_dataset(cfg, "train", rng=random.Random(7)), bs, seed=3,
                        num_workers=workers, world_size=world, rank=rank)
    return len(loader), list(loader)


@pytest.mark.parametrize("dataset", ["synthetic", "cityscapes"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("world", [2, 4])
def test_loader_ranks_hold_world_one_rows(loader_cfgs, dataset, workers, world):
    """Batch i of rank r is rows [r B/W, (r+1) B/W) of world 1's batch i:
    the synthetic clips' seeds and the Cityscapes clips' augmentation and
    frames are drawn for every row on every rank, in order."""
    cfg = loader_cfgs[dataset]
    n1, want = _epoch(cfg, 1)
    assert n1 >= 2 and len(want) == n1
    for r in range(world):
        n, got = _epoch(cfg, workers, world, r)
        assert n == n1 and len(got) == n1
        rows = slice(r * 4 // world, (r + 1) * 4 // world)
        for g, w in zip(got, want):
            assert g["path"] == w["path"][rows]
            for k in ("vid", "lyt", "flow"):
                np.testing.assert_array_equal(g[k], w[k][rows], err_msg=f"rank {r} {k}")


def test_loader_len_is_global_and_refuses_an_unsplit_batch(loader_cfgs):
    ds = create_dataset(loader_cfgs["synthetic"], "train", rng=random.Random(7))
    for world in (1, 2, 4):
        assert len(DataLoader(ds, 4, world_size=world, rank=0)) == len(ds) // 4
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(ds, 6, world_size=4, rank=0)


def test_jax_hosts_repeat_the_synthetic_clips():
    """A fault of the JAX reference, pinned (ROADMAP.md section 3): its
    loader gives each host a slab of the epoch, but every host seeds the
    same stream and a synthetic training clip is made from the stream's next
    draw alone, so two hosts train on the same clips."""
    import waldo_tpu.config as jconfig
    from waldo_tpu.data import DataLoader as JLoader
    from waldo_tpu.data.synthetic import SyntheticDataset as JSynthetic

    from test_models_smoke import tiny_config

    jcfg = tiny_config()
    jcfg.data.dataset = "synthetic"
    batches = []
    for host in (0, 1):
        loader = JLoader(JSynthetic(jcfg, phase="train", rng=random.Random(jcfg.seed)), 4,
                         seed=3, num_workers=1, num_hosts=2, host_id=host)
        it = iter(loader)
        try:
            batches.append(next(it))
        finally:
            it.close()
    a, b = batches
    assert a["path"] != b["path"]  # other indices of the epoch
    for k in ("vid", "lyt", "flow"):
        np.testing.assert_array_equal(a[k], b[k])  # the same clips
    del jconfig


# ---------------------------------------------------------------------------
# the process group's entry points and the mesh fields
# ---------------------------------------------------------------------------


def test_init_distributed_without_world_size_is_world_one(monkeypatch):
    from waldo_tpu_torch.parallel import (BatchShard, all_gather, broadcast_object,
                                          distributed, init_distributed, local_device,
                                          mean_over_ranks, rank, world_size)

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("cpu") is False and not distributed()
    assert world_size() == 1 and rank() == 0 and broadcast_object("x") == "x"
    x = torch.arange(6.0).reshape(3, 2)
    assert all_gather(x) is x and BatchShard.of_rank(3) == BatchShard.whole(3)
    assert mean_over_ranks({"a": 1.0}, "cpu") == {"a": 1.0}
    assert local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_device("cuda") == torch.device("cuda", 3)
    assert local_device("cuda:0") == torch.device("cuda", 0)


@pytest.mark.parametrize("shape,axes,raises", [
    ([1, 8], ["data", "model"], False), (None, ["data"], False), ([2, 1], ["data", "seq"], False),
    ([1, 2], ["data", "seq"], True), (None, ["seq"], True), (None, ["data", "seq"], False)])
def test_seq_axis_is_refused(tmp_path, shape, axes, raises):
    """A "seq" axis of size > 1 raises in the config check and before the
    trainer builds anything; the world size comes from the launcher."""
    from waldo_tpu_torch.config import Config, check_mesh
    from waldo_tpu_torch.train import Trainer

    cfg = Config(mesh_shape=shape, mesh_axes=axes, save_path=str(tmp_path))
    if raises:
        with pytest.raises(NotImplementedError, match="queue 1 item 15"):
            check_mesh(cfg)
        with pytest.raises(NotImplementedError, match="sharding"):
            Trainer(cfg, device="cpu")
        assert not os.listdir(tmp_path)
    else:
        check_mesh(cfg)
