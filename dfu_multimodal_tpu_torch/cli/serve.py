"""Online serving daemon: dynamic-batching HTTP inference on checkpoints
(the port's counterpart of ``dfu_multimodal_tpu/cli/serve.py``).

    # one model
    python -m dfu_multimodal_tpu_torch.cli.serve \
        --checkpoint logs/checkpoints_multimodal --port 8000 \
        [--explain] [--int8 --calib-images <dir>] [--max-batch 64] \
        [--max-wait-ms 2] [--pipeline-depth 2] [--shadow <ckpt>] \
        [--token-merge 4:128 [--tome-prop-attn]] \
        [--resnet-block-impl fused]

    # the clinical router: every checkpoints_* under logs/ is served, and
    # each request goes to the model matching its modalities
    python -m dfu_multimodal_tpu_torch.cli.serve --checkpoint-root logs

    # a frozen bundle (cli/export_model.py), with no model source
    python -m dfu_multimodal_tpu_torch.cli.serve --exported export/multimodal

Then:

    curl -X POST --data-binary @foot.jpg -H 'Content-Type: image/jpeg' \
        http://localhost:8000/v1/predict
    curl http://localhost:8000/metrics

The models run on ``--device`` (default ``cuda``).  Each checkpoint
directory's ``deployment.json`` (threshold, temperature) and
``drift_baseline.json`` are loaded unless switched off.  ``--int8``
serves every model on its int8 paths (the int8 ViT blocks, the
calibrated int8 ResNet trunk, which needs ``--calib-images``);
``--explain`` differentiates the full-fidelity model captured before
quantisation.  ``--shadow <ckpt>`` scores a candidate on the live
traffic of the primary that takes its inputs, full-fidelity with its
own ``deployment.json`` whatever the primary's ``--int8`` (an int8
primary beside its full-fidelity shadow asks whether int8 may replace
it), and ``/metrics`` reports the agreement; ``--pipeline-depth 2``
dispatches the next batch before the last one's results are fetched.
``--token-merge L:K`` serves every ViT-trunk model (thermal_only,
multimodal) token-merged (``serve/engine.py::tome_for_serving``; after
``--int8`` where both are given), ``--tome-prop-attn`` with proportional
attention; other models are served as they are, with a line that says
so; shadows and explanations use the model without merging.
``--resnet-block-impl fused`` runs a ResNet-50 trunk's stride-1
bottlenecks on the fused kernel (K11, a port option shared with predict
and export_model, so a live engine runs the trunk a bundle froze).
``--exported <bundle>`` (repeatable) serves a frozen bundle
(``serve/export.py``) at its own buckets, with the ``deployment.json``
and drift baseline it carries; bundles carry no model source, so
``--explain`` refuses them.
"""

from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Optional, Tuple

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.layout import list_images
from dfu_multimodal_tpu_torch.data.loader import decode_all
from dfu_multimodal_tpu_torch.eval import drift as drift_mod
from dfu_multimodal_tpu_torch.eval import vit_attribution as va
from dfu_multimodal_tpu_torch.eval.deployment import resolve_deployment
from dfu_multimodal_tpu_torch.models.zoo import VIT_TRUNK_MODELS
from dfu_multimodal_tpu_torch.serve.engine import (RESNET_TRUNK_MODELS,
                                                   RGB_IMPL_ARG,
                                                   ModelRouter,
                                                   ServingEngine,
                                                   parse_token_merge,
                                                   quantize_for_serving,
                                                   tome_for_serving)
from dfu_multimodal_tpu_torch.serve.explain import Explainer
from dfu_multimodal_tpu_torch.serve.export import load_bundle
from dfu_multimodal_tpu_torch.serve.http import make_server
from dfu_multimodal_tpu_torch.serve.shadow import attach_shadow
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

# calibration images the int8 ResNet trunk takes (the first of them)
CALIB_IMAGES = 32
# models whose ResNet-50 trunk --resnet-block-impl picks
FUSED_TRUNK_MODELS = ("rgb_only", "multimodal")


def add_resnet_block_impl(parser: argparse.ArgumentParser) -> None:
    """``--resnet-block-impl``, which serve, predict and export_model
    share (read by :func:`model_impl_kwargs`)."""
    parser.add_argument("--resnet-block-impl", default="auto",
                        choices=["auto", "fused"],
                        help="the ResNet-50 trunks' blocks (rgb_only, "
                             "multimodal): cuDNN ('auto') or the fused "
                             "bottleneck kernel ('fused'; a port option)")


def model_impl_kwargs(model_name: str, args) -> dict:
    """The model kwargs that ``--attention-impl`` and
    ``--resnet-block-impl`` give ``model_name``."""
    kwargs = ({"attention_impl": args.attention_impl}
              if model_name in VIT_MODELS else {})
    if args.resnet_block_impl != "auto" and model_name in FUSED_TRUNK_MODELS:
        kwargs[RGB_IMPL_ARG[model_name]] = args.resnet_block_impl
    return kwargs


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
                        help="2 dispatches the next batch (its pinned "
                             "upload and eval step) before fetching the "
                             "previous batch's results")
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    add_resnet_block_impl(parser)
    parser.add_argument("--int8", action="store_true",
                        help="serve the int8 paths (the int8 ViT blocks, "
                             "dynamic activation scales; the calibrated "
                             "int8 ResNet trunk)")
    parser.add_argument("--calib-images", type=Path, default=None,
                        help="REQUIRED with --int8 for models with a "
                             "ResNet trunk: a directory of images (the "
                             "first 32, sorted) fixing the static int8 "
                             "activation scales")
    parser.add_argument("--token-merge", default=None, metavar="L:K",
                        help="ViT-trunk token merging for thermal_only/"
                             "multimodal models: L full-token encoder "
                             "blocks, bipartite-merge to K tokens, rest "
                             "reduced (validate accuracy on real data "
                             "first). Non-ViT models in a --checkpoint-root "
                             "router are served unmodified; composes with "
                             "--int8")
    parser.add_argument("--tome-prop-attn", action="store_true",
                        help="with --token-merge: ToMe proportional "
                             "attention (full Bolya et al. recipe) — "
                             "post-merge blocks bias each key's scores "
                             "by log(token size)")
    parser.add_argument("--shadow", type=Path, action="append",
                        default=None,
                        help="shadow-deploy a candidate checkpoint: it "
                             "scores every request its matching primary "
                             "answers (matched by input modalities) but "
                             "never responds; /metrics reports live "
                             "decision agreement, flips and probability "
                             "deltas (serve/shadow.py). Repeatable, one "
                             "shadow per primary, with its OWN "
                             "deployment.json; served full-fidelity")
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
    parser.add_argument("--exported", type=Path, action="append",
                        default=None,
                        help="serve a frozen bundle (cli/export_model.py); "
                             "repeatable, beside checkpoints or alone")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, the card); "
                             "'cpu' serves on the host")
    return parser


def calibration_images(directory: Optional[Path], image_size: int):
    """The first CALIB_IMAGES images (sorted) under ``directory``, decoded
    at ``image_size``; exits without a directory or images."""
    if directory is None:
        raise SystemExit("--int8 with a ResNet trunk requires "
                         "--calib-images (static activation-scale "
                         "calibration set)")
    paths = list_images(directory)[:CALIB_IMAGES]
    if not paths:
        raise SystemExit(f"No calibration images under {directory}")
    return decode_all(paths, image_size)


def restore_trainer(ckpt: Path, model_name: Optional[str], args, cfg,
                    modalities, device) -> Tuple[str, Trainer, Trainer]:
    """(model name, the serving trainer, the full-fidelity trainer) from a
    checkpoint dir: with ``--int8`` the serving trainer is the int8
    rebuild (a ResNet trunk calibrated on ``--calib-images``), with
    ``--token-merge`` the token-merged rebuild of that (a model without a
    ViT trunk is skipped with a line that says so), and the second is the
    restore they were built from (the one an explainer differentiates)."""
    model_name = model_name or ckpt_mod.load_meta(ckpt).get(
        "model", "rgb_only")
    base = Trainer(model_name, cfg, modalities, device=device,
                   image_size=args.image_size,
                   **model_impl_kwargs(model_name, args))
    base.restore(ckpt)
    trainer = base
    if args.int8:
        calib_u8 = (calibration_images(args.calib_images, args.image_size)
                    if model_name in RESNET_TRUNK_MODELS else None)
        try:
            trainer = quantize_for_serving(base, image_size=args.image_size,
                                           calib_u8=calib_u8)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--int8 {ckpt}: {e}")
    if args.token_merge:
        if model_name in VIT_TRUNK_MODELS:
            merge_at, keep = parse_token_merge(args.token_merge)
            trainer = tome_for_serving(
                trainer, merge_at, keep, image_size=args.image_size,
                prop_attn=args.tome_prop_attn)
            print(f"{ckpt.name}: token merging ({merge_at} full-token "
                  f"blocks, then {keep} tokens)")
        else:
            print(f"{ckpt.name}: --token-merge skipped "
                  f"({model_name} has no ViT trunk)")
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
        drift_monitor=_drift_monitor(ckpt, args), explainer=explainer,
        pipeline_depth=args.pipeline_depth)


def _load_bundle_engine(bundle: Path, args, device):
    """(model name, engine) of an exported bundle: served at the bundle's
    buckets with the deployment config and drift baseline it carries."""
    servable = load_bundle(bundle, device)
    threshold, temperature = _resolve_deployment(bundle, args)
    print(f"{bundle.name}: exported {servable.spec.name}, buckets "
          f"{list(servable.buckets)}")
    return servable.spec.name, ServingEngine(
        servable, image_size=servable.image_size, buckets=servable.buckets,
        max_wait_ms=args.max_wait_ms, threshold=threshold,
        temperature=temperature, max_queue=args.max_queue,
        drift_monitor=_drift_monitor(bundle, args),
        pipeline_depth=args.pipeline_depth)


def _attach_shadows(router: ModelRouter, args, cfg, modalities, device):
    """Restore each ``--shadow`` candidate full-fidelity with its own
    deployment.json behind a small bounded queue and attach it to the
    primary that takes its inputs."""
    for sh in args.shadow or []:
        # the comparison is the candidate as it would deploy against the
        # live primary, independent of the primary's --int8 and threshold
        sh_args = copy.copy(args)
        sh_args.int8 = False
        sh_args.token_merge = None
        sh_args.threshold = sh_args.temperature = None
        name, trainer, _ = restore_trainer(sh, None, sh_args, cfg,
                                           modalities, device)
        threshold, temperature = _resolve_deployment(sh, sh_args)
        # shadow traffic has no client backpressure: bound its queue small
        # (overflow counts as sampling, ShadowTracker's dropped_overloaded)
        engine = ServingEngine(
            trainer, image_size=args.image_size, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, threshold=threshold,
            temperature=temperature, max_queue=max(32, 4 * args.max_batch),
            pipeline_depth=args.pipeline_depth)
        try:
            tracker = attach_shadow(router, engine)
        except KeyError as exc:
            raise SystemExit(f"--shadow {sh}: {exc}")
        print(f"{sh.name}: {name} ({args.compute_dtype}) shadowing "
              f"{tracker.primary_name}")


def build_daemon(argv=None):
    """Parse ``argv``, restore every model, warm and start the engines and
    bind the HTTP server (not yet serving).  Returns ``(server, router,
    args)``; ``server.serve_forever()`` serves, ``server.shutdown()`` and
    ``router.stop()`` end it.  :func:`main` is this plus the loop."""
    args = build_parser().parse_args(argv)
    ckpts = list(args.checkpoint or [])
    if args.checkpoint_root is not None:
        ckpts += sorted(p for p in args.checkpoint_root.glob("checkpoints_*")
                        if p.is_dir())
    bundles = list(args.exported or [])
    if not ckpts and not bundles:
        raise SystemExit("need --checkpoint (repeatable), --checkpoint-root "
                         "and/or --exported")
    if args.explain and bundles:
        raise SystemExit("--explain differentiates a checkpoint's model; an "
                         "exported bundle carries no model source (serve "
                         "--exported without --explain)")
    device = resolve_device(args.device)
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
    for bundle in bundles:
        name, engine = _load_bundle_engine(bundle, args, device)
        if name in engines:
            raise SystemExit(f"model {name!r} served twice ({bundle})")
        engines[name] = engine
    router = ModelRouter(engines)
    _attach_shadows(router, args, cfg, modalities, device)
    if not args.no_warmup:
        for name, engine in engines.items():
            print(f"warming {name}: buckets {list(engine.buckets)} ...",
                  flush=True)
        router.warmup()             # the shadows too
    router.start()
    server = make_server(router, args.host, args.port)
    mode = "int8" if args.int8 else args.compute_dtype
    served = ", ".join(f"{n}{list(e.inputs)}" for n, e in engines.items())
    print(f"serving {served} ({mode}) on "
          f"http://{args.host}:{server.server_address[1]}  "
          f"[max_batch={args.max_batch}, wait={args.max_wait_ms}ms, "
          f"pipeline_depth={args.pipeline_depth}]", flush=True)
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
