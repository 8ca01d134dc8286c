"""PyTorch + CUDA port of the learned wavelet image codec.

Mirrors the module layout of the JAX package
``imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu`` (the
reference, which this package never imports) with PyTorch idiom inside:
``nn.Module``s with NCHW tensors at module boundaries, explicit ``device``
arguments, and parameter names that follow the flax tree
(``codecs.0.entropymodel.plc_0.Conv_1.weight`` for
``['codecs_0']['entropymodel']['plc_0']['Conv_1']['kernel']``).

The dense 3x3 convolutions of the main path run through a hand-written
CUDA kernel (``ops/conv3x3_halo.py``, ``csrc/conv3x3_halo.cu``) on the GPU,
forward and backward, and through its plain PyTorch version on the CPU.

- ``config``    the JSON config schema and the flagship configuration
- ``ops``       color, GDN, masked convs, learned lifting, scaling AEs,
                the 3x3 conv kernel
- ``entropy``   conditional Gaussian and the ZTsep subband entropy model
- ``models``    the learned lifting transform and the codec graph
- ``train``     the rate-distortion loss, the eval and train steps, the
                data loader, checkpoints and the training agent
- ``cli``       ``python -m ..._torch.cli config.json``: run an experiment
- ``utils``     heartbeat, phase timers, device trace
- ``tools``     carrying weights between the flax tree and the port
"""

__version__ = "0.1.0"
