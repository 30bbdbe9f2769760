"""dfu_multimodal_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
``dfu_multimodal_tpu``.

The JAX package stays the reference; this package mirrors its module
names.  Ported so far: the serving path of the three reference models,
their train steps and ``Trainer.fit`` with the reference's checkpoint
contract (JAX checkpoints load too), the three train CLIs reading the
reference's image tree from disk, the dataset tools that build that tree
from the raw downloads, the evaluation CLIs (extended metrics, TTA, the
ablation harness), Grad-CAM and transformer attribution, the serving
daemon with per-request explanations and the batch predict CLI, and the
thermal_only int8 serving path (dynamic and calibrated static activation
scales).

- ``ops``      hand-written Hopper kernels (``ops/csrc/*.cu``, built with
               nvcc at first use) beside their plain PyTorch versions;
               a CPU tensor takes the plain version, a CUDA tensor the
               kernel; the ViT blocks' autograd Functions
- ``models``   ResNet50 (torchvision layout), ViT-B/16 (timm layout) with
               bf16/fp32 or int8 encoder blocks and the int8 converters,
               the ViT and fusion classifiers and the model registry, each
               forward's Grad-CAM tap points
- ``native``   the JPEG decoder / encoder and the PIL-exact resize
               (``decode.cpp``, built with g++ at first use; libjpeg, or
               nvJPEG on a GPU host without libjpeg)
- ``data``     decoding from disk (JPEG natively, PNG in numpy), the
               layout scan, pairings, leakage gate, decode cache and
               synthetic trees, the eval and train transforms, the
               in-memory dataset and batching
- ``eval``     confusion counts, accuracy and F1; the host metrics; the
               drift baseline; operating points, bootstrap CIs,
               calibration, deployment.json, TTA and the evaluation
               figures (drawn by the port); the drift monitor; Grad-CAM,
               attention rollout and Chefer relevance
- ``train``    the Trainer (eval and train steps, epochs, ``fit``,
               ``restore``) and AdamW with its learning-rate schedules
- ``utils``    checkpoints (``.pt`` files, the JAX package's msgpack ones
               read without flax), result artifacts (``test_results.pt``),
               throughput meter and profiler trace
- ``serve``    the micro-batching ServingEngine, the model router, the
               int8 rebuild (``quantize_for_serving``), the explainer,
               the HTTP daemon and its Prometheus text
- ``tools``    the JAX -> port weight and optimizer-state bridge; the
               dataset tools (organize, splits, verify, analyze,
               standardize, the legacy split)
- ``config``   the port's copy of the configuration dataclasses and the
               CLIs' argparse glue
- ``cli``      ``train_rgb_only``, ``train_thermal_only``,
               ``train_multimodal_fusion``, ``organize_clean_dataset``,
               ``dataset_tools``, ``extended_metrics``,
               ``test_time_augmentation``, ``ablation_study``,
               ``grad_cam_visualization``, ``serve``, ``predict``

No module imports jax, flax, PIL, torchvision, matplotlib, scikit-learn,
OpenCV or the JAX package.
"""

__version__ = "0.3.0"
