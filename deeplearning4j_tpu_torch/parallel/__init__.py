"""Checkpointed, supervised training.

Counterpart of the part of ``deeplearning4j_tpu/parallel`` that one card
runs: :class:`TrainingCheckpointer` and :class:`CheckpointTrainingListener`
(``checkpoint.py``) and :class:`TrainingSupervisor` (``supervisor.py``).
The device mesh, pipeline, mixture-of-experts, ring/Ulysses attention and
multi-host launch modules are not ported yet (ROADMAP Queue 1 item 9).
"""

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    CheckpointTrainingListener,
    CheckpointWriteError,
    TrainingCheckpointer,
)
from deeplearning4j_tpu_torch.parallel.supervisor import TrainingSupervisor

__all__ = ["CheckpointTrainingListener", "CheckpointWriteError",
           "TrainingCheckpointer", "TrainingSupervisor"]
