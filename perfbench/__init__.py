"""The benchmark of plass_tpu_torch: one cell per run of `perfbench/run.py`.

Everything that decides a measurement lives here and nowhere in the
program: the traffic generator, the plain reference and the comparison
that decides `correct`, the byte and operation counts of the kernels, the
card's peaks, and the readers of the per-layer metrics. The program under
test is the port's device step (`plass_tpu_torch.ops.backend`).
"""
