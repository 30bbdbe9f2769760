"""Online serving daemon: dynamic-batching HTTP inference on checkpoints
(the port's counterpart of ``dfu_multimodal_tpu/cli/serve.py``).

    # one model
    python -m dfu_multimodal_tpu_torch.cli.serve \
        --checkpoint logs/checkpoints_multimodal --port 8000 \
        [--explain] [--max-batch 64] [--max-wait-ms 2]

    # the clinical router: every checkpoints_* under logs/ is served, and
    # each request goes to the model matching its modalities
    python -m dfu_multimodal_tpu_torch.cli.serve --checkpoint-root logs

Then:

    curl -X POST --data-binary @foot.jpg -H 'Content-Type: image/jpeg' \
        http://localhost:8000/v1/predict
    curl http://localhost:8000/metrics

The models run on ``--device`` (default ``cuda``).  Each checkpoint
directory's ``deployment.json`` (threshold, temperature) and
``drift_baseline.json`` are loaded unless switched off.  ``--int8``
serves ``thermal_only`` on the int8 blocks; ``--explain`` differentiates
the full-fidelity model captured before quantisation.  Not ported yet,
refused with the missing module named: ``--exported``
(``serve/export.py``), ``--shadow`` (``serve/shadow.py``),
``--token-merge`` (``ops/token_merge.py``), ``--pipeline-depth > 1`` and
``--int8`` for a ResNet trunk (``models/resnet_q8.py``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.eval import drift as drift_mod
from dfu_multimodal_tpu_torch.eval import vit_attribution as va
from dfu_multimodal_tpu_torch.eval.deployment import resolve_deployment
from dfu_multimodal_tpu_torch.serve.engine import (ModelRouter,
                                                   ServingEngine,
                                                   quantize_for_serving)
from dfu_multimodal_tpu_torch.serve.explain import Explainer
from dfu_multimodal_tpu_torch.serve.http import make_server
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

# flags of the JAX daemon whose modules the port has not ported yet
UNPORTED = {"exported": "serve/export.py (exported bundles)",
            "shadow": "serve/shadow.py (shadow traffic)",
            "token_merge": "ops/token_merge.py (ToMe)"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Serving daemon")
    parser.add_argument("--checkpoint", type=Path, action="append",
                        default=None,
                        help="checkpoint dir; repeat to serve several "
                             "models behind one modality router")
    parser.add_argument("--checkpoint-root", type=Path, default=None,
                        help="serve every checkpoints_* directory under "
                             "this root (the trainers' layout)")
    parser.add_argument("--model", default=None,
                        help="zoo name for a SINGLE --checkpoint; "
                             "default: checkpoint metadata")
    parser.add_argument("--threshold", type=float, default=None,
                        help="clinical operating point: respond "
                             "prediction=1 (ulcer) when prob_ulcer >= "
                             "this value instead of argmax")
    parser.add_argument("--temperature", type=float, default=None,
                        help="temperature-scale responded probabilities "
                             "(sigmoid(logit(p)/T)); an explicit "
                             "--threshold applies to the scaled probs")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="bound the request queue; submissions beyond "
                             "it get HTTP 503 + Retry-After")
    parser.add_argument("--ignore-deployment", action="store_true",
                        help="do not auto-load each model's "
                             "deployment.json")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--max-batch", type=int, default=64,
                        help="largest coalesced batch (top bucket)")
    parser.add_argument("--max-wait-ms", type=float, default=2.0,
                        help="batching window after the first queued "
                             "request")
    parser.add_argument("--pipeline-depth", type=int, default=1,
                        help="1 only: the overlapped pipeline is not "
                             "ported yet")
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--int8", action="store_true",
                        help="serve thermal_only on the int8 blocks "
                             "(dynamic activation scales)")
    parser.add_argument("--explain", action="store_true",
                        help="enable POST /v1/explain: per-request "
                             "Grad-CAM evidence heatmaps of the "
                             "full-fidelity model (serve/explain.py)")
    parser.add_argument("--explain-class", default="pred",
                        choices=["pred", "0", "1"],
                        help="which class logit the CAM explains: the "
                             "served decision ('pred') or a fixed class")
    parser.add_argument("--cam-method", default="saliency",
                        choices=["saliency", "rollout", "chefer"],
                        help="ViT-branch attribution for /v1/explain; "
                             "ResNet branches always use true Grad-CAM")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running every bucket before start-up "
                             "on the calling thread (the batcher still "
                             "runs them once)")
    parser.add_argument("--no-drift-monitor", action="store_true",
                        help="do not score live inputs against each "
                             "model's drift_baseline.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, the card); "
                             "'cpu' serves on the host")
    # refused: their modules are not ported yet
    parser.add_argument("--exported", type=Path, action="append",
                        default=None, help=argparse.SUPPRESS)
    parser.add_argument("--shadow", type=Path, action="append",
                        default=None, help=argparse.SUPPRESS)
    parser.add_argument("--token-merge", default=None, help=argparse.SUPPRESS)
    return parser


def refuse_unported(args) -> None:
    """Exit with the missing module named for a flag whose module the
    port has not ported yet."""
    for flag, module in UNPORTED.items():
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag.replace('_', '-')} needs {module}, "
                             "which is not ported yet")
    if getattr(args, "pipeline_depth", 1) > 1:
        raise SystemExit("--pipeline-depth > 1 needs the overlapped "
                         "pipeline of serve/engine.py, which is not ported "
                         "yet")


def restore_trainer(ckpt: Path, model_name: Optional[str], args, cfg,
                    modalities, device) -> Tuple[str, Trainer, Trainer]:
    """(model name, the serving trainer, the full-fidelity trainer) from a
    checkpoint dir: with ``--int8`` the serving trainer is the int8
    rebuild and the second is the restore it was quantised from (the one
    an explainer differentiates)."""
    model_name = model_name or ckpt_mod.load_meta(ckpt).get(
        "model", "rgb_only")
    kwargs = ({"attention_impl": args.attention_impl}
              if model_name in VIT_MODELS else {})
    base = Trainer(model_name, cfg, modalities, device=device,
                   image_size=args.image_size, **kwargs)
    base.restore(ckpt)
    trainer = base
    if args.int8:
        try:
            trainer = quantize_for_serving(base, image_size=args.image_size)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--int8 {ckpt}: {e}")
    return model_name, trainer, base


def _resolve_deployment(directory: Path, args):
    threshold, temperature, note = resolve_deployment(
        directory, args.threshold, args.temperature,
        getattr(args, "ignore_deployment", False))
    if note:
        print(f"{directory.name}: loaded {note}")
    return threshold, temperature


def _drift_monitor(directory: Path, args):
    """A DriftMonitor over <dir>/drift_baseline.json unless
    --no-drift-monitor; no file, no monitoring for that model."""
    if getattr(args, "no_drift_monitor", False):
        return None
    baseline = drift_mod.load_baseline(
        Path(directory) / drift_mod.BASELINE_FILENAME)
    if baseline is None:
        return None
    print(f"{Path(directory).name}: drift monitoring on "
          f"(baseline: {sorted(baseline['modalities'])})")
    return drift_mod.DriftMonitor(baseline)


def _load_engine(ckpt: Path, model_name, args, cfg, modalities, device):
    model_name, trainer, base = restore_trainer(ckpt, model_name, args, cfg,
                                                modalities, device)
    explainer = None
    if args.explain:
        cls = args.explain_class
        method = args.cam_method
        if (method != "saliency"
                and not va.supports_transformer_attribution(model_name)):
            print(f"{ckpt.name}: --cam-method {method} {va.DOWNGRADE_NOTE}")
            method = "saliency"
        explainer = Explainer(base, class_index=cls, cam_method=method)
        print(f"{ckpt.name}: /v1/explain on (class={cls}, "
              f"method={method})")
    threshold, temperature = _resolve_deployment(ckpt, args)
    return model_name, ServingEngine(
        trainer, image_size=args.image_size, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, threshold=threshold,
        temperature=temperature, max_queue=args.max_queue,
        drift_monitor=_drift_monitor(ckpt, args), explainer=explainer)


def build_daemon(argv=None):
    """Parse ``argv``, restore every model, warm and start the engines and
    bind the HTTP server (not yet serving).  Returns ``(server, router,
    args)``; ``server.serve_forever()`` serves, ``server.shutdown()`` and
    ``router.stop()`` end it.  :func:`main` is this plus the loop."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    ckpts = list(args.checkpoint or [])
    if args.checkpoint_root is not None:
        ckpts += sorted(p for p in args.checkpoint_root.glob("checkpoints_*")
                        if p.is_dir())
    if not ckpts:
        raise SystemExit("need --checkpoint (repeatable) and/or "
                         "--checkpoint-root")
    if args.model and len(ckpts) > 1:
        raise SystemExit("--model only applies to a single --checkpoint")
    cfg = TrainConfig(batch_size=args.max_batch,
                      eval_batch_size=args.max_batch,
                      compute_dtype=args.compute_dtype)
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    engines = {}
    for ckpt in ckpts:
        name, engine = _load_engine(ckpt, args.model, args, cfg, modalities,
                                    device)
        if name in engines:
            raise SystemExit(f"model {name!r} served twice ({ckpt})")
        engines[name] = engine
    router = ModelRouter(engines)
    if not args.no_warmup:
        for name, engine in engines.items():
            print(f"warming {name}: buckets {list(engine.buckets)} ...",
                  flush=True)
        router.warmup()
    router.start()
    server = make_server(router, args.host, args.port)
    mode = "int8" if args.int8 else args.compute_dtype
    served = ", ".join(f"{n}{list(e.inputs)}" for n, e in engines.items())
    print(f"serving {served} ({mode}) on "
          f"http://{args.host}:{server.server_address[1]}  "
          f"[max_batch={args.max_batch}, wait={args.max_wait_ms}ms]",
          flush=True)
    return server, router, args


def main(argv=None):
    server, router, _ = build_daemon(argv)
    # SIGTERM (an orchestrator's stop signal) drains like Ctrl-C: stop
    # accepting, finish in-flight batches, then exit 0.  shutdown() must
    # run off the serve_forever thread, hence the helper thread.
    import signal
    import threading

    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=server.shutdown,
                                              daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        router.stop()
        print(f"shutdown: {router.stats()}", flush=True)
    return router.stats()


if __name__ == "__main__":
    main()
