"""The recipe tools, run as ``python -m sod100k_tpu_torch.tools.<name>``:

    prune_trajectory  the dynamic-weight-decay -> prune -> finetune recipe on
                      a synthetic task, with its params / val-MAE table
    bf16_ab           f32 against bf16-compute training on the same seed and
                      batches: trajectories, BN-gamma and pruning agreement

Both need no dataset: the only checks of training quality that run
anywhere. They run on the card unless given ``--device cpu``.
"""
