"""repro_torch.data — deterministic sharded token pipeline (numpy)."""

from repro_torch.data.pipeline import MemmapTokens, SyntheticLM, make_batches

__all__ = ["MemmapTokens", "SyntheticLM", "make_batches"]
