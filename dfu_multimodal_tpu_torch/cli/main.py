"""Umbrella ``dfu-torch`` command: one entry point for every CLI of the
port (counterpart of the JAX package's ``dfu``, ``cli/main.py``)::

    dfu-torch train-rgb-only --data-dir data
    dfu-torch check-gpu
    torchrun --nproc-per-node 2 -m dfu_multimodal_tpu_torch.cli.main \
        train-thermal-only --data-dir data

``dfu-torch <sub> ...`` is ``python -m dfu_multimodal_tpu_torch.cli.
<module> ...``: this module only dispatches, so each subcommand keeps its
own argparse surface and ``--help``.  The subcommands are the JAX
package's, with ``check-gpu`` in place of ``check-tpu``.
"""

from __future__ import annotations

import importlib
import sys
from typing import List, Optional

# subcommand -> (module under dfu_multimodal_tpu_torch.cli, one-line help)
COMMANDS = {
    "train-rgb-only": ("train_rgb_only", "train the ResNet50 RGB classifier"),
    "train-thermal-only": ("train_thermal_only",
                           "train the ViT-B/16 thermal classifier"),
    "train-multimodal-fusion": ("train_multimodal_fusion",
                                "train the late-fusion multimodal model"),
    "train-legacy": ("train_legacy",
                     "EfficientNet/gated-fusion legacy variants"),
    "pretrain": ("pretrain",
                 "self-supervised trunk pretraining (SimCLR / MAE)"),
    "self-train": ("self_train",
                   "semi-supervised pseudo-labeling over an unlabeled "
                   "pool"),
    "distill": ("distill",
                "compress a trained teacher into a smaller student"),
    "soup": ("soup",
             "average same-architecture checkpoints into one model"),
    "robustness": ("robustness",
                   "F1 under parametric corruptions x severity levels"),
    "compare": ("compare",
                "paired statistical comparison of two checkpoints "
                "(McNemar + bootstrap deltas)"),
    "cross-validate": ("cross_validate",
                       "k-fold CV with patient-level grouping"),
    "sweep": ("sweep", "hyperparameter grid / random search"),
    "extended-metrics": ("extended_metrics",
                         "medical metrics suite + ROC/PR/confusion plots"),
    "grad-cam": ("grad_cam_visualization", "Grad-CAM visualizations"),
    "tta": ("test_time_augmentation", "test-time-augmentation robustness"),
    "ablation": ("ablation_study", "RGB vs thermal vs multimodal ablation"),
    "predict": ("predict", "batch inference on an image directory"),
    "embed": ("embed", "trunk embeddings: retrieval + uncertainty triage"),
    "model-card": ("model_card",
                   "audit-ready markdown card from checkpoint artifacts"),
    "serve": ("serve", "online micro-batching HTTP daemon"),
    "export-model": ("export_model", "freeze a checkpoint to torch.export"),
    "organize-dataset": ("organize_clean_dataset",
                         "dedup + split raw datasets (canonical L0)"),
    "dataset-tools": ("dataset_tools",
                      "verify/analyze/standardize/patient-split/prepare"),
    "download-datasets": ("download_datasets", "fetch the Kaggle datasets"),
    "convert-checkpoint": ("convert_checkpoint",
                           "torch checkpoint -> native format"),
    "fix-checkpoint-keys": ("fix_checkpoint_keys",
                            "rewrite backbone.* keys in torch checkpoints"),
    "check-gpu": ("check_gpu", "device/process-group/compute smoke check"),
}


def _usage() -> str:
    width = max(len(name) for name in COMMANDS)
    lines = [f"  {name:<{width}}  {help_}"
             for name, help_ in sorted(
                 (n, h) for n, (_, h) in COMMANDS.items())]
    return ("usage: dfu-torch <command> [args...]\n\n"
            "DFU multimodal classification on PyTorch and CUDA.\n"
            "Commands (each supports --help):\n" + "\n".join(lines) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage(), end="")
        return 0
    name = argv[0]
    if name not in COMMANDS:
        print(f"dfu-torch: unknown command {name!r}\n\n{_usage()}",
              end="", file=sys.stderr)
        return 2
    module = importlib.import_module(
        f"dfu_multimodal_tpu_torch.cli.{COMMANDS[name][0]}")
    # present the subcommand as the program name so --help prints sensibly
    sys.argv[0] = f"dfu-torch {name}"
    result = module.main(argv[1:])
    # several mains return result dicts for programmatic use, not rcs
    return result if isinstance(result, int) else 0


if __name__ == "__main__":
    sys.exit(main())
