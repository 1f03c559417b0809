"""Topology search: successive-halving tournaments that optimize the
communication graph (DESIGN.md §10), each cohort of candidates rolled out
as one batch.

    from repro_torch.search import SearchConfig, run_search
    result = run_search("landscape:rastrigin@2.5", SearchConfig(n_agents=64))
    tc = TrainConfig.from_search_result(result, iters=200)
"""
from .candidates import (CandidateSpec, make_grid, prior_scores,  # noqa: F401
                         seed_pool)
from .tournament import (SearchConfig, SearchResult,  # noqa: F401
                         run_search)

__all__ = [
    "CandidateSpec", "make_grid", "prior_scores", "seed_pool",
    "SearchConfig", "SearchResult", "run_search",
]
