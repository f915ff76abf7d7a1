"""DAVIS J&F metrics and the evaluation command (the JAX package's
``eval``, every name it exports)."""

from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl  # noqa: F401
from semi_supervised_vos_tpu_torch.eval.metrics import eval_f, eval_j, evaluate_segmentation  # noqa: F401
