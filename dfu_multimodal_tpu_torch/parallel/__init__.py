"""Data, tensor and pipeline parallelism on ``torch.distributed``
(counterpart of ``dfu_multimodal_tpu/parallel``)."""

from dfu_multimodal_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, init_from_env, make_mesh, pad_batch_to_mesh,
    process_shard)
from dfu_multimodal_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS, gpipe, make_pp_mesh, vit_pipeline_fn)
