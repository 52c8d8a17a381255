"""Sequence sharding over a (data, seq) process grid (waldo_tpu_torch/
parallel/sharding.py and the grid of parallel/mesh.py) on the CPU.

The contract: at a D x S grid every leaf's reduced gradient, the parameters
after Adam steps and the losses are world 1's on the same global batch, to
summation order, for LVD, FLP and WIF (the seq ranks split the tokens of
LVD's pose estimator, its layer estimator's context and FLP's pose encoder,
as the JAX package's "seq" mesh axis does); the seq ranks of a line hold
bitwise equal parameters.

Both grids' gloo ranks (2 + 4 processes) are spawned at once for the module
(``spawned``), run every job below and write what they saw; the parent makes
the job, which they wait for, and computes world 1 and the JAX package's
step under a (2, 2) ("data", "seq") Mesh meanwhile. The children import the port and the
test modules only (no JAX).

Tolerances:
  the loss (the mean over the data coordinates): 2e-4 relative, as
      tests/test_torch_distributed.py;
  one step's reduced gradient: per leaf 1e-4 x the leaf's largest plus
      1e-7 x the largest of all leaves, as there;
  the parameters after two Adam steps: tests/test_torch_distributed.py's
      ``_adam_close`` (4e-4 on all elements, what two steps at lr 1e-4 can
      move one whose gradient sits near 0, and 2e-6 on 99.9 %);
  a stack's forward at S = 2 against S = 1, and a noisy block's: 1e-6 (the
      same sums; the keys and values gathered exactly).
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

from waldo_tpu_torch.config import from_dict
from test_torch_distributed import FORBIDDEN, _adam_close, _named, _np, _perturbed, _tensors
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRIDS = {"1x2": [1, 2], "2x2": [2, 2]}
TIMEOUT_S = 60  # the children's process-group timeout, and the join's after the parent's work
STACK_TOL = 1e-6


# ---------------------------------------------------------------------------
# the jobs, run by every rank and, at world 1, by the parent
# ---------------------------------------------------------------------------


def job_net_steps(spec, shard):
    """Two Adam steps of ``spec["net"]`` on the shard's rows, the
    synthesizer's stacks sharded over the seq axis: the losses, the first
    step's reduced gradient and the parameters after each step."""
    from waldo_tpu_torch.convert import from_jax
    from waldo_tpu_torch.train import NetState

    cfg = from_dict(spec["cfg"])
    syn = _perturbed(cfg)
    if "params" in spec:
        from_jax(spec["params"], syn)
    syn.shard_sequence()
    for name, net in syn.nets().items():
        net.requires_grad_(name == spec["net"])
    module = syn.nets()[spec["net"]]
    st = NetState(module, cfg.model)
    batch = {k: shard.rows(v) for k, v in _tensors(spec["batch"]).items()}
    out = {"loss": [], "params": []}
    for it in range(2):
        st.zero_grad()
        loss, _ = getattr(syn, spec["loss"])(
            batch, it, generator=torch.Generator().manual_seed(spec["seed"]), shard=shard)
        loss.backward()
        if it == 0:
            out["grads"] = _named(module, st.gradients(loss)[0])
        st.apply(loss)
        out["loss"].append(float(loss.detach()))
        out["params"].append(_named(module, st.params))
    return out


def _stacks(seed=0):
    """A "full" stack with a key mask, an "obj" stack and a "full" block with
    token noise (its strength 0.5), seeded."""
    from waldo_tpu_torch.nn import Block, MultiBlocks
    from waldo_tpu_torch.nn.init import init_module

    full = MultiBlocks(2, 32, 4, "full")
    obj = MultiBlocks(2, 32, 4, "obj")
    noisy = Block(32, 4, "full", noise=True)
    g = torch.Generator().manual_seed(seed)
    for m in (full, obj, noisy):
        init_module(m, g)
    with torch.no_grad():
        noisy.attn.noise_strength.fill_(0.5)
    return full, obj, noisy


def job_stacks():
    """A "full" stack (key mask) and an "obj" stack (sharded context) on
    sharded tokens, their outputs gathered, beside the same stacks on whole
    streams; shard_tokens / gather_tokens on streams that S does and does
    not divide; a noisy block's draws on sharded tokens, made at the whole
    stream's shape."""
    from waldo_tpu_torch.parallel import (BatchShard, RowStream, TokenShard, gather_tokens,
                                          shard_tokens)

    full, obj, noisy = _stacks()
    stream = lambda: RowStream(torch.Generator().manual_seed(9), BatchShard.whole(2))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 32, generator=g)
    x_obj = torch.randn(2, 6, 32, generator=g)
    key_mask = torch.rand(2, 16, generator=g) > 0.3
    tokens = TokenShard.of_rank(16)
    with torch.no_grad():
        out = {
            "full": (tokens.gather(full(tokens.shard(x), key_mask=key_mask, tokens=tokens)),
                     full(x, key_mask=key_mask)),
            "obj": (obj(x_obj, x_ctx=tokens.shard(x), tokens=tokens), obj(x_obj, x_ctx=x)),
            "noise": (tokens.gather(noisy(tokens.shard(x), noise=stream(), tokens=tokens)),
                      noisy(x, noise=stream())),
        }
    odd = torch.randn(2, 15, 3, generator=g)
    out.update(tokens=tokens, local=shard_tokens(x),
               odd_whole=shard_tokens(odd) is odd,
               round_trip=torch.equal(gather_tokens(shard_tokens(x), 16), x))
    return out


def run_jobs(job):
    """Every job at this process's grid (world 1 without a process group)."""
    from waldo_tpu_torch.parallel import BatchShard, data_world

    out, seconds = {}, {}
    t0 = time.perf_counter()
    for key in ("lvd", "flp", "wif"):
        b = len(job[key]["batch"]["vid"]) // data_world()
        out[key] = job_net_steps(job[key], BatchShard.of_rank(b))
        seconds[key] = time.perf_counter() - t0 - sum(seconds.values())
    out["stacks"] = job_stacks()
    out["seconds"] = seconds
    return out


def rank_main(index, root):
    """One spawned process: rank r of a grid (the first two processes form
    the (1, 2) grid, the next four the (2, 2) one), its process group over
    a rendezvous file of the grid's, the grid, every job of ``root``/job.pt
    (waited for: the parent writes it while the ranks start), what it saw
    written to ``root``/<grid>/rank<r>.pt."""
    name, r = ("1x2", index) if index < 2 else ("2x2", index - 2)
    shape = GRIDS[name]
    world = int(np.prod(shape))
    os.environ.update(WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from waldo_tpu_torch.parallel import grid, init_distributed, init_grid

    job_path = os.path.join(root, "job.pt")
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(job_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {job_path} within {TIMEOUT_S} s")
        time.sleep(0.05)
    job = torch.load(job_path, weights_only=False)
    out_dir = os.path.join(root, name)
    init_distributed("cpu", timeout_s=TIMEOUT_S,
                     init_method=f"file://{os.path.join(out_dir, 'rdzv')}")
    init_grid(shape, ["data", "seq"])
    out = run_jobs(job)
    g = grid()
    out["grid"] = (g.data_rank, g.data_world, g.seq_rank, g.seq_world)
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# world 1, the JAX step under a (2, 2) mesh, and the spawned grids
# ---------------------------------------------------------------------------


def make_job():
    """LVD from JAX's init with every leaf perturbed (tests/test_torch_train.py's
    lvd_params), B = 2; FLP with random context lengths and both training
    noises, B = 4; WIF (sharp_vid), B = 4."""
    import jax

    import waldo_tpu.config as jconfig
    from waldo_tpu.models import Synthesizer as JaxSynthesizer

    from test_models_smoke import tiny_batch, tiny_config
    from test_torch_train import lvd_cfg

    jcfg = lvd_cfg()
    params = jax.tree.map(np.asarray, JaxSynthesizer(jcfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + (rng.randn(*a.shape) * 0.02).astype(np.float32), params)
    fcfg = tiny_config(use_ii=False)
    fcfg.model.max_ctx_length_vid = 4
    fcfg.model.pg_embed_noise = fcfg.model.pg_inject_noise = True
    wcfg = tiny_config(use_pg=False, use_ii=True)
    wcfg.model.vid_inpainting_losses = ["sharp_vid"]
    return {
        "lvd": {"cfg": jconfig.to_dict(jcfg), "params": params, "batch": _np(tiny_batch(jcfg)),
                "loss": "extract_object_loss", "net": "pe", "seed": 1},
        "flp": {"cfg": jconfig.to_dict(fcfg), "batch": _np(tiny_batch(fcfg, b=4, seed=2)),
                "loss": "generate_pose_loss", "net": "pg", "seed": 5},
        "wif": {"cfg": jconfig.to_dict(wcfg), "batch": _np(tiny_batch(wcfg, b=4, seed=4)),
                "loss": "inpaint_loss", "net": "ii", "seed": 5},
    }


def _jax_mesh_step(spec):
    """One LVD step of the JAX train_step_fn under a (2, 2) ("data", "seq")
    Mesh, built as tests/test_sharding.py builds it: the loss and the
    parameters after the step, by flax path."""
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import waldo_tpu.config as jconfig
    from waldo_tpu.models import Synthesizer as JaxSynthesizer
    from waldo_tpu.parallel import replicate, set_active_mesh, shard_batch
    from waldo_tpu.train.train_state import NetState as JNetState, make_optimizer, train_step_fn
    from waldo_tpu_torch.train.checkpoint import _flatten

    cfg = jconfig.from_dict(spec["cfg"])
    jgs = importlib.import_module("waldo_tpu.ops.grid_sample")
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ("data", "seq"))
    set_active_mesh(mesh)
    jgs.set_impl("gather")
    try:
        js = JaxSynthesizer(cfg)
        state = replicate(JNetState.create(jax.tree.map(jnp.asarray, spec["params"]["pe"]),
                                           make_optimizer(cfg.model)), mesh)
        batch = shard_batch(dict(spec["batch"]), mesh)
        step = jax.jit(train_step_fn(lambda p, b, r, i: js.extract_object_loss(p, b, r, i)))
        state, m = step(state, batch, jax.random.PRNGKey(1), jnp.float32(0))
        return float(m["loss"]), _flatten(jax.tree.map(np.asarray, jax.device_get(state.params)))
    finally:
        jgs.set_impl("auto")
        set_active_mesh(None)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both grids' ranks, spawned first; meanwhile the parent makes the job
    (which the ranks wait for), world 1's results and the JAX mesh step.
    Returns {"job", "world1", "jax", "1x2": ranks' results, "2x2": ...}."""
    root = tmp_path_factory.mktemp("seq")
    for name in GRIDS:
        os.makedirs(root / name)
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        rank_main, args=(str(root),), nprocs=sum(int(np.prod(s)) for s in GRIDS.values()),
        join=False, start_method="spawn")
    out = {}
    try:
        out["job"] = make_job()
        torch.save(out["job"], root / "job.tmp")
        os.replace(root / "job.tmp", root / "job.pt")
        out["world1"] = run_jobs(out["job"])
        t1 = time.perf_counter()
        out["jax"] = _jax_mesh_step(out["job"]["lvd"])
        jax_s = time.perf_counter() - t1
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s of world 1")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for name, shape in GRIDS.items():
        out[name] = (shape, [torch.load(root / name / f"rank{r}.pt", weights_only=False)
                             for r in range(int(np.prod(shape)))])
    print(f"[seq] world 1 {out['world1']['seconds']} s, JAX mesh step {jax_s:.1f} s, ranks "
          f"{[[r['seconds'] for r in out[n][1]] for n in GRIDS]} s, all "
          f"{time.perf_counter() - t0:.1f} s")
    return out


@pytest.fixture(scope="module")
def world1(spawned):
    return spawned["world1"]


@pytest.fixture(params=sorted(GRIDS))
def ranks(request, spawned):
    return spawned[request.param]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def test_ranks_sit_on_the_grid_and_import_no_jax(ranks):
    shape, res = ranks
    d, s = shape
    for r, out in enumerate(res):
        assert out["grid"] == (r // s, d, r % s, s)
        assert out["imported"] == [], out["imported"]
        tokens = out["stacks"]["tokens"]
        assert (tokens.offset, tokens.size, tokens.total, tokens.world) == (r % s * 16 // s,
                                                                            16 // s, 16, s)


@pytest.mark.parametrize("net", ["lvd", "flp", "wif"])
def test_steps_match_world_one(ranks, world1, net):
    """Two Adam steps on the grid: the mean over the data coordinates loss is world 1's,
    every leaf's reduced gradient is world 1's, the parameters after each
    step are bitwise equal on every rank and Adam-close to world 1's."""
    shape, res = ranks
    d, s = shape
    w1 = world1[net]
    for it in range(2):
        mean = float(np.mean([res[k * s][net]["loss"][it] for k in range(d)]))
        want = w1["loss"][it]
        assert abs(mean - want) <= 2e-4 * abs(want), (it, mean, want)
        for r in range(1, d * s):  # a data coordinate's ranks hold the same loss
            if r % s:
                assert res[r][net]["loss"][it] == res[r - 1][net]["loss"][it]
        first = res[0][net]["params"][it]
        for out in res[1:]:
            assert all(np.array_equal(out[net]["params"][it][k], v) for k, v in first.items())
    g1 = w1["grads"]
    top = max(float(np.abs(v).max()) for v in g1.values())
    assert top > 0 and sorted(res[0][net]["grads"]) == sorted(g1)
    for k, want in g1.items():
        err = float(np.abs(res[0][net]["grads"][k] - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()) + 1e-7 * top, (k, err)
    _adam_close(res[0][net]["params"][1], w1["params"][1])


def test_stacks_on_sharded_tokens_equal_whole_streams(ranks):
    """A "full" stack with a key mask and an "obj" stack at S = 2: the
    gathered output equals the whole stream's within 1e-6; shard_tokens
    keeps its seq rank's contiguous part, leaves a stream S does not divide
    whole, and gather_tokens inverts it."""
    shape, res = ranks
    s = shape[1]
    for r, out in enumerate(res):
        st = out["stacks"]
        for key in ("full", "obj", "noise"):
            got, want = st[key]
            assert float((got - want).abs().max()) <= STACK_TOL, key
        assert st["odd_whole"] and st["round_trip"]
        part = 16 // s
        assert st["local"].shape[1] == part


def test_a_block_the_jax_package_does_not_shard_refuses_tokens():
    """Only "full" (x) and "obj" (x_ctx) run on sharded tokens."""
    from waldo_tpu_torch.nn import Block
    from waldo_tpu_torch.parallel import TokenShard

    blk = Block(32, 4, "cls")
    with pytest.raises(ValueError, match="sharded tokens"):
        blk(torch.zeros(2, 1, 32), x_ctx=torch.zeros(2, 4, 32), tokens=TokenShard.whole(4))


def test_lvd_step_on_a_2x2_grid_matches_jax_mesh(spawned):
    """The ranks' first LVD step at (2, 2) against the JAX package's
    train_step_fn under a (2, 2) ("data", "seq") Mesh: the mean over the data coordinates
    loss within 2e-4 relative and the parameters Adam-close."""
    from waldo_tpu_torch.convert import to_jax
    from waldo_tpu_torch.models import Synthesizer
    from waldo_tpu_torch.train.checkpoint import _flatten

    _, res = spawned["2x2"]
    jloss, jparams = spawned["jax"]
    job = spawned["job"]
    mean = float(np.mean([res[0]["lvd"]["loss"][0], res[2]["lvd"]["loss"][0]]))
    assert abs(mean - jloss) <= 2e-4 * abs(jloss), (mean, jloss)
    syn = Synthesizer(from_dict(job["lvd"]["cfg"]), device="cpu")
    with torch.no_grad():
        for n, p in syn.lvd.named_parameters():
            p.copy_(torch.from_numpy(res[0]["lvd"]["params"][0][n]))
    got = _flatten(to_jax(syn)["pe"])
    assert sorted(got) == sorted(jparams)
    _adam_close(got, jparams)
