"""azoom_torch.pipelines: the learned, oracle, heuristic, autosteered,
tracked and causal enhancement paths, with the names of azoom.pipelines."""

from azoom_torch.pipelines.oracle import heuristic_enhance, oracle_enhance

__all__ = ["heuristic_enhance", "oracle_enhance"]
