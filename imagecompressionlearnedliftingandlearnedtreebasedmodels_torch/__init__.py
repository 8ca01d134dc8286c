"""PyTorch + CUDA port of the learned wavelet image codec.

Mirrors the module layout of the JAX package
``imagecompressionlearnedliftingandlearnedtreebasedmodels_tpu`` (the
reference, which this package never imports) with PyTorch idiom inside:
``nn.Module``s with NCHW tensors at module boundaries, explicit ``device``
arguments, and parameter names that follow the flax tree
(``codecs.0.entropymodel.plc_0.Conv_1.weight`` for
``['codecs_0']['entropymodel']['plc_0']['Conv_1']['kernel']``).

The dense 3x3 convolutions of the main path run through hand-written CUDA
kernels on the GPU, forward and backward (``ops/conv3x3_halo.py``: fp32
operands in ``csrc/conv3x3_halo.cu``, bf16 operands in the tensor-core
``csrc/conv_v2.cu``), and through their plain PyTorch versions on the CPU.
The real bitstream codes with the host C++ of ``csrc/*.cpp``.

- ``config``    the JSON config schema and the flagship configuration
- ``ops``       color, GDN, masked convs, learned lifting, scaling AEs,
                the 3x3 conv kernels, the 9/7 ladder kernels
- ``entropy``   conditional Gaussian and the ZTsep subband entropy model
- ``models``    the learned lifting transform and the codec graph
- ``train``     the rate-distortion loss, the eval and train steps, the
                data loader, checkpoints and the training agent
- ``coding``    the real bitstream: rANS, the context walkers, the codec
                coder (the agent's ``test`` mode)
- ``cli``       ``python -m ..._torch.cli config.json``: run an experiment
- ``utils``     heartbeat, phase timers, device trace
- ``tools``     carrying weights between the flax tree and the port
"""

__version__ = "0.1.0"
