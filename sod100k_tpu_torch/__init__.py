"""sod100k_tpu_torch — the PyTorch/CUDA port of ``sod100k_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It imports
``torch`` and never ``jax`` or ``sod100k_tpu``; the JAX package is the
reference that the port's tests compare against on the same weights.

Layout follows the JAX package:
    arch/      layer_config (carried over, pure numpy) + the CSNet nn.Module
    interop/   JAX parameter pytree / reference .pth.tar -> state_dict
    ops/       conv / norm / resample / gOctConv family (stock PyTorch ops),
               and the fused depthwise tail (hand-written CUDA kernel)
    csrc/      CUDA C++ sources, built with nvcc at first use
    data/      u8 wire math (ImageNet normalize, sigmoid quantize)
    train/     train and eval steps, the dynamic-weight-decay penalty,
               optimizers and LR schedules, .pth.tar checkpoints
    prune/     channel pruning on the state_dict, the slim-model builder
    parallel/  data parallelism over torch.distributed, one process per
               card (the SOD100K_* variables or torchrun's)
    tools/     the recipe tools: prune trajectory, bf16-vs-f32 A/B
    serve.py, serve_http.py   artifacts, bucketed ServingModel, HTTP daemon

Tensors inside the model are NCHW; the public edges (model forward, train
and eval steps, ServingModel) keep the JAX package's NHWC layout. Models
and checkpoints load onto the card unless the caller names another device.
"""

__version__ = "0.1.0"
