"""detectax_torch — the PyTorch / CUDA (NVIDIA H100) port of detectax.

A second package beside `detectax/` (the JAX reference, which stays as it
is). Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a kernel written by hand for Hopper under `kernels/`. The port
imports `torch` and numpy only — never `jax`, `flax` or anything under
`detectax`.

Ported so far: the FCOS serving path (`infer.serving.Predictor` →
`infer.export.make_serving_fn` → `ops.nms`) and its two NMS kernels.
"""

__version__ = "0.1.0"
