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
operands in the register-tiled CUDA-core ``csrc/conv3x3_halo.cu``, exact
fp32 FFMAs fed by a ``cp.async`` ring; bf16 operands in the tensor-core
``csrc/conv_v2.cu``), and through their plain PyTorch versions on the CPU.
The real bitstream codes with the host C++ of ``csrc/*.cpp``.

- ``config``    the JSON config schema and the flagship configuration
- ``ops``       color, GDN, masked convs, learned lifting, scaling AEs,
                the learned x2 upscaler, the 3x3 conv kernels, the 9/7
                ladder kernels
- ``entropy``   conditional Gaussian, learned-CDF bottleneck and the subband
                entropy models (factorized, onlyEZWT, ZTsep, ZTBlock)
- ``models``    the transforms, the codec graph and the restoration nets
- ``train``     the rate-distortion loss, the eval and train steps, the
                data loader, checkpoints, the training agent and the
                postprocess stage
- ``coding``    the real bitstream: rANS, the context walkers, the codec
                coder (the agent's ``test`` mode) and its tiled form
- ``parallel``  overlapped tiling of a high-resolution image
- ``cli``       ``python -m ..._torch.cli config.json``: run an experiment
- ``utils``     heartbeat, phase timers, device trace, image plots, mailer
- ``tools``     carrying weights between the flax tree and the port, the
                RD sweep and RD plots, original-checkpoint import,
                montages and patches
"""

__version__ = "0.1.0"
