"""The port's own measurement programs, the counterparts of the JAX
package's `bench.py`, `benchmarks/serving_bench.py` and
`benchmarks/profile_step.py`.

- `train`: the flagship training step (FCOS-R50, 384 px, batch 16, bf16),
  its synthetic batch, the min-of-windows step time and the step's count
  of convolution and matmul operations (`bench_torch.py`'s training lines);
- `decode`: the decode + NMS latency inputs and call (its last line);
- `serving`: serving images/s a batch bucket (``python -m
  detectax_torch.bench.serving``);
- `profile_step`: one flagship step under `torch.profiler`, its device time
  by kernel category, by phase and by kernel (``python -m
  detectax_torch.bench.profile_step``).

The programs run on a CUDA device and never fall back to the CPU; the
functions they are built from take ``device="cpu"`` for the tests.
"""
