"""Evaluation of the port (org/nd4j/evaluation): host numpy accumulators
over a network's outputs."""

from deeplearning4j_tpu_torch.eval.evaluation import (
    ROC, Evaluation, EvaluationBinary, EvaluationCalibration, ROCBinary,
    ROCMultiClass, RegressionEvaluation,
)

__all__ = ["ROC", "Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "ROCBinary", "ROCMultiClass", "RegressionEvaluation"]
