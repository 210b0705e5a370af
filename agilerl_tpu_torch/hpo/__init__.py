from agilerl_tpu_torch.hpo.mutation import Mutations
from agilerl_tpu_torch.hpo.tournament import TournamentSelection

__all__ = ["Mutations", "TournamentSelection"]
