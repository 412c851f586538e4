from repro_torch.core.coopt import COOPT, MODES, ORIGINAL, CoOptConfig

__all__ = ["COOPT", "MODES", "ORIGINAL", "CoOptConfig"]
