from kvzip_tpu_torch.eval.evaluator import Evaluator
from kvzip_tpu_torch.eval.metrics import evaluate_answer

__all__ = ["Evaluator", "evaluate_answer"]
