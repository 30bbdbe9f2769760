"""dfu_multimodal_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``dfu_multimodal_tpu``.

The JAX package stays the reference; this package mirrors its module
names.  Ported so far: the multimodal serving path.

- ``ops``      hand-written Hopper kernels (``ops/csrc/*.cu``, built with
               nvcc at first use) beside their plain PyTorch versions;
               a CPU tensor takes the plain version, a CUDA tensor the kernel
- ``models``   ResNet50 (torchvision layout), ViT-B/16 (timm layout), the
               fusion classifier and the model registry
- ``data``     the eval transform
- ``train``    the eval half of the Trainer
- ``serve``    the micro-batching ServingEngine
- ``tools``    the JAX -> port weight bridge

No module imports jax or flax; ``dfu_multimodal_tpu.config`` (host-only)
is shared.
"""

__version__ = "0.1.0"
