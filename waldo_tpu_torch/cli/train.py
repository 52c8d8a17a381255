"""Training CLI, on the card:

  python -m waldo_tpu_torch.cli.train --dataset synthetic --name train_lvd ...

and data-parallel over N cards of one host, one process per card (NCCL; the
port's counterpart of the reference's torchrun launch):

  python -m torch.distributed.run --standalone --nproc_per_node N \\
      -m waldo_tpu_torch.cli.train <the same flags>

``--batch_size_vid`` is the global batch, which N must divide; rank 0 logs,
prints and saves (train/trainer.py). Flags are the JAX package's (``--s_*``
model flags accepted; see waldo_tpu_torch/config.py), so the flags of
scripts/cityscapes/train_lvd.sh, train_flp.sh and train_wif.sh run here
with ``--data.dataset synthetic`` until the Cityscapes loader is ported. FLP
and WIF restore their frozen LVD teacher from an LVD run's checkpoint dir
(``--s_load_path``); WIF's ``lpips_vid`` reads VGG16 LPIPS weights from
``$WALDO_LPIPS_WEIGHTS`` (default checkpoints/lpips) and trains L1 only
without them.
"""
from __future__ import annotations

from ..config import parse_cli
from ..train import Trainer


def main(argv=None):
    Trainer(parse_cli(argv)).run()


if __name__ == "__main__":
    main()
