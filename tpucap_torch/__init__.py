"""tpucap_torch — the captioning framework on PyTorch and CUDA for NVIDIA Hopper.

A port of ``tpucap`` (JAX/XLA/Pallas for a TPU), laid out module for module
like it so each counterpart is easy to find: ``tpucap/models/layers.py`` ->
``tpucap_torch/models/layers.py`` and so on. Params keep the JAX package's
layout and Keras names (``{"kernel": (in, out), "bias"}``,
``conv2_block1_1_conv``, ``cells/0/kernel``); only convolution kernels change
to PyTorch's OIHW (``tpucap_torch.convert``).

Every Pallas kernel on the serving path is a hand-written CUDA kernel here
(``csrc/``, built by ``_build.py``) beside a plain PyTorch version of the
same function. A kernel wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.

Modules, as tpucap's are laid out:

- ``tpucap_torch.text``, ``data``, ``models``, ``decode``, ``train``, ``ops``
  (the kernels' wrappers; ``csrc/`` holds their sources), ``checkpoint``,
  ``cli`` (extract / train / caption / score / evaluate / compare / export /
  serve), ``pipeline``, ``convert``
- ``tpucap_torch.serve`` / ``tpucap_torch.serve_http`` — the micro-batching
  caption server and its HTTP front end
- ``tpucap_torch.client`` — stdlib Python client of the HTTP serving layer

The package imports torch and numpy, never jax and nothing of ``tpucap``.
"""

__version__ = "0.1.0"
