"""Training CLI, on the card:

  python -m waldo_tpu_torch.cli.train --dataset synthetic --name train_lvd ...

Flags are the JAX package's (``--s_*`` model flags accepted; see
waldo_tpu_torch/config.py), so scripts/cityscapes/train_lvd.sh's flags run
here with ``--dataset synthetic`` until the Cityscapes loader is ported.
"""
from __future__ import annotations

from ..config import parse_cli
from ..train import Trainer


def main(argv=None):
    Trainer(parse_cli(argv)).run()


if __name__ == "__main__":
    main()
