"""The drivers, run as ``python -m sod100k_tpu_torch.cli.<name>``: train,
finetune, test, eval, csf, export, serve and smoke, with the JAX package's
flags and YAMLs (``python -m cli.<name>``), on the card."""
