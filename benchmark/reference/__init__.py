"""The plain PyTorch reference the benchmark judges the port against.

Written from the published architectures (SOD100K's CSNet and
CSF+Res2Net) in plain ``torch`` operations, on a flat state dict whose
keys are the port's parameter names. It imports nothing of the port: it
works out again every layer plan, every folded norm and every resize.

- ``csnet``: the CSNet architecture plan (``init_layers``), its parameter
  spec, and its forward in eval mode, in train mode (batch statistics, the
  dynamic-weight-decay signal) and in calibration mode;
- ``csf``: CSF+Res2Net (Res2Net v1b 26w4s under the GroupNorm CSF head);
- ``train``: the losses (BCE, the BN-gamma penalty, the CSF Solver's sum)
  and the Adam updates with coupled L2 decay.
"""
