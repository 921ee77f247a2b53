from llm_consensus_tpu_torch.consensus.coordinator import (
    ConsensusResult,
    Coordinator,
    CoordinatorConfig,
)
from llm_consensus_tpu_torch.consensus.messages import (
    AnswerEvaluation,
    AnswerRefinement,
    Feedback,
)
from llm_consensus_tpu_torch.consensus.personas import (
    Persona,
    default_panel,
    load_panel,
    save_panel,
)
from llm_consensus_tpu_torch.consensus.voting import (
    VoteResult,
    logit_pool,
    majority_vote,
    self_consistency,
    weighted_vote,
)

__all__ = [
    "AnswerEvaluation",
    "AnswerRefinement",
    "ConsensusResult",
    "Coordinator",
    "CoordinatorConfig",
    "Feedback",
    "Persona",
    "VoteResult",
    "default_panel",
    "load_panel",
    "logit_pool",
    "majority_vote",
    "save_panel",
    "self_consistency",
    "weighted_vote",
]
