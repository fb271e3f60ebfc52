"""Parallel tree learners over a ``torch.distributed`` process group.

Counterpart of ``lightgbm_tpu/parallel`` (the reference's parallel tree
learners and its socket/MPI Network layer, src/treelearner/
{data,feature,voting}_parallel_tree_learner.cpp, src/network/): one process
per rank, the collectives in :mod:`.comm`.  See
``lightgbm_tpu_torch/core/tree_learner.py`` ``Comm`` for the modes.
"""
from .comm import ProcessComm, default_group
from .learners import (DataParallelTreeLearner, FeatureParallelTreeLearner,
                       PartitionedDataParallelTreeLearner,
                       VotingParallelTreeLearner, create_tree_learner,
                       is_write_leader, sharded_predict,
                       sharded_predict_contrib)

__all__ = [
    "DataParallelTreeLearner",
    "FeatureParallelTreeLearner", "PartitionedDataParallelTreeLearner",
    "VotingParallelTreeLearner", "create_tree_learner", "default_group",
    "is_write_leader", "ProcessComm", "sharded_predict",
    "sharded_predict_contrib",
]
