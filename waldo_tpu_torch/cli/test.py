"""Inference and evaluation CLI, on the card:

  python -m waldo_tpu_torch.cli.test --dataset cityscapes --data.eval_phase test \
      --s_load_path checkpoints/LVD_TAG --s_pg_load_path checkpoints/FLP_TAG \
      --s_ii_load_path checkpoints/WIF_TAG ...

Flags are the JAX package's, so scripts/cityscapes/test.sh and test_mat.sh
run here with the module name changed; the load paths name the port's
checkpoint dirs (``.npz`` slots). Dumps the real, reconstructed and
predicted videos under results/<signature>/ for the metrics CLI
(``python -m waldo_tpu_torch.eval.metrics TAG LEN CTX``) and prints the
mean L1, PSNR and SSIM. ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import sys

from ..config import parse_cli
from ..train import Evaluator


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i: i + 2]
    metrics = Evaluator(parse_cli(argv), device=device).run(dump=True)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
