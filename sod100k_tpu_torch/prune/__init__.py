"""Channel pruning: gamma thresholding -> slim config -> channel gathers."""

from .finetune import (build_pruned_csnet, derive_pruned_config,
                       gather_pruned_params, layer_gammas, prune)

__all__ = ["build_pruned_csnet", "derive_pruned_config",
           "gather_pruned_params", "layer_gammas", "prune"]
