"""dfu_multimodal_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``dfu_multimodal_tpu``.

The JAX package stays the reference; this package mirrors its module
names.  Ported so far: the serving path of the three reference models,
their train steps and ``Trainer.fit`` with the reference's checkpoint
contract (JAX checkpoints load too), and the thermal_only int8 serving
path (dynamic and calibrated static activation scales).

- ``ops``      hand-written Hopper kernels (``ops/csrc/*.cu``, built with
               nvcc at first use) beside their plain PyTorch versions;
               a CPU tensor takes the plain version, a CUDA tensor the
               kernel; the ViT blocks' autograd Functions
- ``models``   ResNet50 (torchvision layout), ViT-B/16 (timm layout) with
               bf16/fp32 or int8 encoder blocks and the int8 converters,
               the ViT and fusion classifiers and the model registry
- ``data``     the eval and train transforms, the in-memory dataset and
               batching
- ``eval``     confusion counts, accuracy and F1
- ``train``    the Trainer (eval and train steps, epochs, ``fit``,
               ``restore``) and AdamW with its learning-rate schedules
- ``utils``    checkpoints (``.pt`` files, the JAX package's msgpack ones
               read without flax), throughput meter and profiler trace
- ``serve``    the micro-batching ServingEngine and the int8 rebuild
               (``quantize_for_serving``)
- ``tools``    the JAX -> port weight and optimizer-state bridge
- ``config``   the port's copy of the configuration dataclasses

No module imports jax, flax or the JAX package.
"""

__version__ = "0.3.0"
