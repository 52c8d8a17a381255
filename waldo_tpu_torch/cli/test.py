"""Inference and evaluation CLI, on the card:

  python -m waldo_tpu_torch.cli.test --dataset cityscapes --data.eval_phase test \
      --s_load_path checkpoints/LVD_TAG --s_pg_load_path checkpoints/FLP_TAG \
      --s_ii_load_path checkpoints/WIF_TAG ...

Flags are the JAX package's, so scripts/cityscapes/test.sh and test_mat.sh
run here with the module name changed; the load paths name the port's
checkpoint dirs (``.npz`` slots). Dumps the real, reconstructed and
predicted videos under results/<signature>/ for the metrics CLI
(``python -m waldo_tpu_torch.eval.metrics TAG LEN CTX``) and prints the
mean L1, PSNR and SSIM. ``--device cpu`` runs it on the CPU. Data-parallel
over N cards of one host, one process per card (NCCL), each predicting and
dumping its rows of every global batch of ``--batch_size_vid`` clips (N
must divide it), the metrics averaged over the ranks (train/evaluator.py):

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m waldo_tpu_torch.cli.test <the same flags>
"""
from __future__ import annotations

import sys

from ..config import parse_cli
from ..parallel import is_main
from ..train import Evaluator


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i: i + 2]
    metrics = Evaluator(parse_cli(argv), device=device).run(dump=True)
    if is_main():
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
