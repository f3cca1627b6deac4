"""Distributed training and serving: the device mesh and its sharding
rules, data / tensor / expert / pipeline / sequence parallelism, the
multi-process launcher, checkpointing and the training supervisor.

Counterpart of ``deeplearning4j_tpu/parallel`` (deeplearning4j-scaleout's
ParallelWrapper and ParallelInference, the Spark masters' roles). The JAX
package drives a ``jax.sharding.Mesh`` from one process; the port runs one
process a device, joined by ``torch.distributed`` (NCCL on the card, gloo
on the CPU): :mod:`.mesh` (``make_mesh``, the rules, ``ParallelWrapper``,
``ParallelInference``), :mod:`.launch`, :mod:`.moe`, :mod:`.pipeline`,
:mod:`.ring_attention`, :mod:`.ulysses`, :mod:`.checkpoint` and
:mod:`.supervisor`. One card is a world of one, where nothing is
exchanged.
"""

from deeplearning4j_tpu_torch.parallel.checkpoint import (
    CheckpointTrainingListener,
    CheckpointWriteError,
    TrainingCheckpointer,
)
from deeplearning4j_tpu_torch.parallel.launch import (
    ShardedDataSetIterator,
    distributed_evaluate,
    host_shard,
    initialize_distributed,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    ParallelInference,
    ParallelWrapper,
    PartitionSpec,
    make_mesh,
    moe_ep_rules,
    shard_params,
)
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    RingSelfAttention,
    ring_attention,
)
from deeplearning4j_tpu_torch.parallel.supervisor import TrainingSupervisor
from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["CheckpointTrainingListener", "CheckpointWriteError",
           "TrainingCheckpointer", "TrainingSupervisor", "make_mesh",
           "shard_params", "ParallelWrapper", "ParallelInference",
           "DEFAULT_TP_RULES", "moe_ep_rules", "PartitionSpec",
           "initialize_distributed", "host_shard", "ShardedDataSetIterator",
           "distributed_evaluate", "ring_attention", "RingSelfAttention",
           "ulysses_attention"]
