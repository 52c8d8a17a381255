"""The port's prefetching loader (waldo_tpu_torch/data/loader.py) on the CPU:
its batches do not depend on the number of workers and equal the clips made
one by one in order and the JAX package's loader's with one worker; a
worker's exception reaches the consumer without a hang; leaving the
iterator early stops the producer; the trainer hands it the config's
workers.
"""
import random
import sys
import threading
import time

import numpy as np
import pytest

import waldo_tpu.config as jconfig
from waldo_tpu.data import DataLoader as JLoader
from waldo_tpu.data.synthetic import SyntheticDataset as JSynthetic

from waldo_tpu_torch.config import from_dict
from waldo_tpu_torch.data import DataLoader, InfiniteLoader, collate, create_dataset

from test_models_smoke import tiny_config

TIMEOUT_S = 30


def _cfgs():
    jcfg = tiny_config()
    jcfg.data.dataset = "synthetic"
    return jcfg, from_dict(jconfig.to_dict(jcfg))


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _producers():
    return [t for t in threading.enumerate() if t.name == "DataLoader producer" and t.is_alive()]


def _wait_for_no_producer():
    deadline = time.time() + TIMEOUT_S
    while _producers() and time.time() < deadline:
        time.sleep(0.05)
    return not _producers()


def test_batches_do_not_depend_on_workers():
    """Training clips draw their seeds from the dataset's shared stream; the
    loader draws them on its producer in batch order, so 1, 2 and 4 workers
    (threads switching every microsecond) give the clips made one by one in
    order, and the JAX loader's with one worker."""
    jcfg, tcfg = _cfgs()
    bs, n = 4, 3
    idx = DataLoader(create_dataset(tcfg, "train", rng=random.Random(7)), bs, seed=3)
    order = idx._epoch_indices()
    ds = create_dataset(tcfg, "train", rng=random.Random(7))
    want = [collate([ds[j] for j in order[i * bs:(i + 1) * bs]]) for i in range(n)]
    jax_batches = _batches(JLoader(JSynthetic(jcfg, phase="train", rng=random.Random(7)), bs,
                                   seed=3, num_workers=1, num_hosts=1, host_id=0), n)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for workers in (1, 2, 4):
            got = _batches(DataLoader(create_dataset(tcfg, "train", rng=random.Random(7)), bs,
                                      seed=3, num_workers=workers), n)
            for g, w, j in zip(got, want, jax_batches):
                assert g["path"] == w["path"] == j["path"], workers
                for k in ("vid", "lyt", "flow"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{workers} {k}")
                    np.testing.assert_array_equal(g[k], j[k], err_msg=f"{workers} {k} jax")
    finally:
        sys.setswitchinterval(old)
    assert _wait_for_no_producer()


class _NoDraws:
    """The loader's dataset protocol for a dataset that draws nothing."""

    def draw(self, i):
        return None


class _Failing(_NoDraws):
    """Clips 0-4 are fine; clip 5 raises."""

    def __len__(self):
        return 12

    def make_clip(self, i, draws):
        if i == 5:
            raise OSError("truncated clip file")
        return {"x": np.full((2,), i, np.float32)}


def test_worker_failure_reaches_the_consumer():
    out = {}

    def consume():
        try:
            for _ in DataLoader(_Failing(), 2, shuffle=False, num_workers=3):
                out["n"] = out.get("n", 0) + 1
        except RuntimeError as e:
            out["err"] = e

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    assert not th.is_alive(), "the consumer hung on a failed worker"
    assert out.get("n") == 2  # the batches before the failing one
    assert "data loader worker failed" in str(out["err"])
    assert isinstance(out["err"].__cause__, OSError)
    assert _wait_for_no_producer()


class _Slow(_NoDraws):
    def __init__(self, n=40):
        self.n = n

    def __len__(self):
        return self.n

    def make_clip(self, i, draws):
        time.sleep(0.01)
        return {"x": np.full((2,), i, np.float32)}


def test_leaving_early_stops_the_producer():
    """A consumer that takes one batch of ten and leaves (the generator
    closed, as a ``break`` out of a for loop does) stops the producer,
    which would otherwise wait on its full queue for ever."""
    loader = DataLoader(_Slow(), 4, shuffle=False, num_workers=2, prefetch=1)
    it = iter(loader)
    first = next(it)
    np.testing.assert_array_equal(first["x"][:, 0], [0, 1, 2, 3])
    time.sleep(0.2)  # the producer fills the queue and blocks on it
    assert len(_producers()) == 1
    it.close()
    assert _wait_for_no_producer()
    inf = InfiniteLoader(DataLoader(_Slow(), 4, shuffle=False, num_workers=2))
    for _ in range(12):  # across an epoch's end
        inf.next()
    inf.close()
    assert _wait_for_no_producer()


def test_trainer_passes_the_config_workers(tmp_path, monkeypatch):
    """Trainer.run builds its loader with cfg.data.num_workers and stops
    its producer when the run ends."""
    from test_torch_train import train_cfg
    from waldo_tpu_torch.data import loader as loader_mod
    from waldo_tpu_torch.train import Trainer

    seen = []
    orig = loader_mod.DataLoader.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("num_workers"))
        orig(self, *a, **kw)

    monkeypatch.setattr(loader_mod.DataLoader, "__init__", spy)
    cfg = train_cfg(tmp_path)
    cfg.data.num_workers = 3
    tr = Trainer(cfg, device="cpu")
    tr.run(num_iter=1)
    assert seen == [3]
    assert _wait_for_no_producer()


@pytest.mark.parametrize("workers", [1, 3])
def test_epoch_takes_each_clip_once(workers):
    """A shuffled epoch of 14 clips in batches of 4: drop_last keeps 3
    batches of distinct clips, with any number of workers."""
    got = list(DataLoader(_Slow(14), 4, shuffle=True, seed=1, num_workers=workers))
    assert len(got) == 3
    xs = np.concatenate([b["x"][:, 0] for b in got]).tolist()
    assert len(set(xs)) == 12 and set(xs) <= set(range(14))
