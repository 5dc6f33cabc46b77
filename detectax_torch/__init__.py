"""detectax_torch — the PyTorch / CUDA (NVIDIA H100) port of detectax.

A second package beside `detectax/` (the JAX reference, which stays as it
is). Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a kernel written by hand for Hopper under `kernels/`. The port
imports `torch` and numpy only — never `jax`, `flax` or anything under
`detectax`.

Ported so far: the FCOS serving path (`infer.serving.Predictor` →
`infer.export.make_serving_fn` → `ops.nms`) with its two NMS kernels, the
FCOS training path (all three assignment variants) with the focal-loss
kernel, the serving and training paths of the ResNet-backbone CenterNet
family with the peak-decode kernel, and DetBench with the evaluation CLI
(`cli.evaluate`, `eval.detection_metrics`).
"""

__version__ = "0.1.0"
