"""The port's evaluation harness: per-task masked-field scores
(``python -m flexdm_tpu_torch.evaluation``)."""

from .harness import evaluate_all, evaluate_task, main, merge_results

__all__ = ["evaluate_all", "evaluate_task", "main", "merge_results"]
