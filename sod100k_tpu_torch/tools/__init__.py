"""The recipe tools, run as ``python -m sod100k_tpu_torch.tools.<name>``:

    prune_trajectory  the dynamic-weight-decay -> prune -> finetune recipe on
                      a synthetic task, with its params / val-MAE table
    bf16_ab           f32 against bf16-compute training on the same seed and
                      batches: trajectories, BN-gamma and pruning agreement
    prune_seed_spread prune_trajectory over several seeds at once, each run
                      held to the JAX slow test's invariants

Both need no dataset: the only checks of training quality that run
anywhere. They run on the card unless given ``--device cpu``.

The measurement tools, the ports of ``bench.py`` and ``tools/bench_*.py``,
``tools/perf_probe.py``:

    bench         the headline: CSNet-L-x2 at 224^2 img/s, gated on parity,
                  one JSON line on stdout
    bench_serve   served img/s through the HTTP daemon against the direct
                  ServingModel
    bench_extras  latency, CSF forwards, train steps, resident programs and
                  the drivers end to end -> bench_extras.json
    bench_check   the regression guard against bench_reference.json
    perf_probe    ablations and probes (ablate, dwlayout, scatter, trainb,
                  csf)

They time on the card (``timing``) unless given ``--device cpu``;
``bench_check`` runs on the card only.
"""
