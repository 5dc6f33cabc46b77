"""Detection metrics: a copy of `detectax/eval` (numpy only)."""
from detectax_torch.eval.detection_metrics import MeanAPEvaluator  # noqa: F401
