"""The benchmark's plain reference: a frozen copy of the plain PyTorch path
of ``waldo_tpu_torch`` (config parser, LVD, FLP, WIF, the Warper and its
ops, the LVD training loss, Adam, the evaluator's L1 / PSNR / SSIM).

It imports nothing of the program. The modules under ``ops/``, ``nn/``,
``models/`` and ``config.py`` are the port's files as they stood when the
benchmark was written, with two changes: every sample goes through the
plain ``F.grid_sample`` compositions (``ops/grid_sample.py``; the port
sends CUDA tensors to its hand kernels), and sequence sharding, spans and
the process group are gone (one process, whole token streams). Later
changes to the program do not reach this copy, so the benchmark keeps
judging the program against the same arithmetic.
"""
