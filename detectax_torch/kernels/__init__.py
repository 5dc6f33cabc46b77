# registers the operators of the serving kernels (detectax_torch::*), so
# that every kernel module, and torch.export.load, finds them
from detectax_torch.kernels import ops  # noqa: F401
