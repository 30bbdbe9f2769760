"""Two-rank jobs of the port's distributed tests, on gloo over the CPU.

``Job(job, directory)`` starts two processes (the ``spawn`` start
method), each joining a gloo group through a file under ``directory``
(no TCP port, so parallel test workers cannot collide) with a 60 s
collective timeout, one intra-op thread each.  The parent waits with a
deadline and kills the ranks when it passes, so a hung collective fails
the test instead of the run.  A job reads its inputs from
``directory/inputs.pt`` and rank r writes its results to
``directory/out{r}.pt``.  This module imports torch and the port only:
the JAX references are computed by the tests, in the parent.
"""

from __future__ import annotations

import dataclasses
import datetime
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
DEADLINE = 240.0                    # seconds for a whole job
IMAGE = 32
TINY = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
RESNET = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))


class Job:
    """Two ranks running ``job`` (a function of this module); :meth:`wait`
    joins them by the deadline or kills them."""

    def __init__(self, job: str, directory: Path,
                 deadline: float = DEADLINE):
        self.job, self.end = job, time.monotonic() + deadline
        self.ctx = mp.start_processes(_rank_main, args=(job, str(directory)),
                                      nprocs=WORLD, join=False,
                                      start_method="spawn")

    def wait(self) -> None:
        try:
            while not self.ctx.join(
                    timeout=max(0.1, self.end - time.monotonic())):
                if time.monotonic() > self.end:
                    raise TimeoutError(f"{self.job}: the ranks did not "
                                       "finish by the deadline")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()


def _rank_main(rank: int, job: str, directory: str) -> None:
    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        out = globals()[job](rank, torch.load(Path(directory) / "inputs.pt",
                                              weights_only=False))
        torch.save(out, Path(directory) / f"out{rank}.pt")
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _np(t):
    t = t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    return t.float().cpu().numpy()


# ------------------------------------------------------------- the steps


def _modalities(names, neutral=True):
    from dfu_multimodal_tpu_torch import config as cfg

    aug = cfg.AugmentConfig(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                            rotation_degrees=0.0, aug_prob=0.0,
                            affine_degrees=0.0)
    make = {"rgb": cfg.rgb_modality,
            "thermal": lambda: cfg.thermal_modality(blur=False)}
    out = {}
    for m in names:
        mod = make[m]()
        out[m] = dataclasses.replace(mod, augment=aug) if neutral else mod
    return out


def _trainer(name, inp, mesh, neutral=True, **overrides):
    """A port Trainer of the test's tiny models at ``inp``'s weights."""
    from dfu_multimodal_tpu_torch import config as cfg
    from dfu_multimodal_tpu_torch.train import engine

    block_impl = overrides.pop("block_impl", "auto")
    tcfg = cfg.TrainConfig(**{**inp["cfg"], **overrides}, mesh=mesh)
    kwargs = dict(TINY, block_impl=block_impl) if name == "thermal_only" else {}
    pt = engine.Trainer(name, tcfg, _modalities(
        ("thermal",) if name == "thermal_only" else ("rgb", "thermal"),
        neutral), class_weights=inp["class_weights"], device="cpu",
        image_size=IMAGE, **kwargs)
    if name == "multimodal":
        _tiny_multimodal(pt)
    pt.module.load_state_dict(inp[f"{name}_state"])
    return pt


def _tiny_multimodal(pt) -> None:
    from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
    from dfu_multimodal_tpu_torch.models.resnet import ResNet
    from dfu_multimodal_tpu_torch.models.vit import ViT

    m, dt = pt.module, pt.compute_dtype
    m.rgb_branch = ResNet(dtype=dt, **RESNET)
    m.thermal_branch = ViT(image_size=IMAGE, dtype=dt, **TINY)
    m.fusion = FusionMLP(4 * RESNET["widths"][-1] + TINY["hidden_dim"], 2,
                         pt.cfg.drop_rate, dt)


def _result(pt, metrics):
    model, opt, _ = pt._checkpoint_state()
    return {"loss": float(metrics["loss"]), "counts": _np(metrics["counts"]),
            "state": {k: _np(v) for k, v in model.items()},
            "mu": {k: _np(v) for k, v in opt["mu"].items()}}


def _step(pt, batch, seed=0):
    return _result(pt, pt.train_step(batch, torch.Generator().manual_seed(
        seed)))


def train_job(rank, inp):
    """Every step mode on the 2-rank mesh and, for reference, on this
    rank alone (``MeshConfig(data=1)``)."""
    from dfu_multimodal_tpu_torch.config import MeshConfig
    from dfu_multimodal_tpu_torch.data.loader import ArrayDataset

    dp, one = MeshConfig(), MeshConfig(data=1)
    batch = inp["thermal_batch"]
    out = {}
    # thermal_only on the fused blocks, class weights, one padded row
    pts = {k: _trainer("thermal_only", inp, m, block_impl="fused")
           for k, m in (("2", dp), ("1", one))}
    out["dp"] = {k: _step(pt, batch) for k, pt in pts.items()}
    ds = ArrayDataset({"thermal": inp["eval_images"]}, inp["eval_labels"])
    for k, pt in pts.items():
        m, arrays = pt.run_eval_epoch(ds)
        out["dp"][k]["eval"] = {"loss": m.loss, "f1": m.f1,
                                "probs": arrays["y_probs"],
                                "preds": arrays["y_pred"]}
    # the same step with the default (random) augmentation: each rank's
    # views are its rows of the single device's
    out["dp_aug"] = {k: _step(_trainer("thermal_only", inp, m, neutral=False,
                                       block_impl="fused"), batch, seed=3)
                     for k, m in (("2", dp), ("1", one))}
    out["accum"] = {k: _step(_trainer("thermal_only", inp, m, grad_accum=3,
                                      block_impl="fused"), batch)
                    for k, m in (("2", dp), ("1", one))}
    out["fsdp"] = {k: _step(_trainer("thermal_only", inp, m), batch)
                   for k, m in (("2", MeshConfig(fsdp=True)), ("1", one))}
    tp = _trainer("thermal_only", inp, MeshConfig(data=1, model=2))
    out["tp"] = {"2": _step(tp, batch), "1": out["fsdp"]["1"],
                 "plan": dict(tp._tp_plan)}
    out["mm"] = {k: _step(_trainer("multimodal", inp, m), inp["mm_batch"])
                 for k, m in (("2", dp), ("1", one))}
    out["simclr"] = _simclr(inp, dp, one)
    out["kd"] = _kd(inp, dp, one)
    out["fit"] = _fit(rank, inp, dp, one)
    out["refusals"] = _refusals(inp)
    return out


def _simclr(inp, dp, one):
    from dfu_multimodal_tpu_torch import config as cfg
    from dfu_multimodal_tpu_torch.data.loader import shard_batch
    from dfu_multimodal_tpu_torch.train import ssl

    out = {}
    v1, v2, valid = (torch.from_numpy(inp["simclr"][k])
                     for k in ("v1", "v2", "valid"))
    for key, mesh in (("2", dp), ("1", one)):
        pt = ssl.SSLTrainer("tiny", ssl.PretrainConfig(
            method="simclr", mesh=mesh, **inp["ssl_cfg"]),
            cfg.rgb_modality(), image_size=IMAGE, device="cpu")
        pt.build_optimizer(1)
        pt.module.load_state_dict(inp["simclr_state"])
        rows = None
        views = {"v1": v1, "v2": v2, "valid": valid}
        if pt.mesh is not None:
            views, lo, n = shard_batch(views, *pt._data[:2])
            rows = (lo, n)
        loss = pt.step_on_views((views["v1"], views["v2"]), views["valid"],
                                rows=rows)
        out[key] = {"loss": float(loss),
                    "state": {k: _np(v) for k, v in
                              pt.module.state_dict().items()},
                    "mu": {k: _np(v) for k, v in
                           pt.optimizer.state_dict()["mu"].items()}}
    return out


def _kd(inp, dp, one):
    from dfu_multimodal_tpu_torch import config as cfg
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train import distill

    out = {}
    for key, mesh in (("2", dp), ("1", one)):
        teacher, _ = zoo.build("tiny_fusion", drop_rate=0.0)
        teacher.load_state_dict(inp["teacher_state"])
        pt = distill.DistillTrainer(
            "tiny_rgb", "tiny_fusion", teacher, distill.DistillConfig(),
            cfg.TrainConfig(**inp["cfg"], mesh=mesh),
            _modalities(("rgb", "thermal")),
            class_weights=inp["class_weights"], device="cpu",
            image_size=IMAGE)
        pt.module.load_state_dict(inp["student_state"])
        out[key] = _step(pt, inp["kd_batch"])
    return out


def _fit(rank, inp, dp, one):
    """Two epochs of ``fit`` on the mesh (rank 0 writes) and by rank 0
    alone; returns what each rank saw of the files."""
    from dfu_multimodal_tpu_torch.config import MeshConfig
    from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
    from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt

    tr = ArrayDataset({"thermal": inp["fit"]["train"]}, inp["fit"]["ty"])
    va = ArrayDataset({"thermal": inp["fit"]["val"]}, inp["fit"]["vy"])
    root = Path(inp["fit_dir"])
    out = {}
    runs = [("2", dp)] + ([("1", one)] if rank == 0 else [])
    for key, mesh in runs:
        pt = _trainer("thermal_only", inp, mesh, block_impl="fused",
                      **inp["fit_cfg"])
        logs = []
        history, best = pt.fit(tr, va, root / key, log=logs.append,
                               metrics_jsonl=root / f"{key}.jsonl")
        files = sorted(p.name for p in (root / key).iterdir())
        payload, _ = ckpt.load_checkpoint(root / key, ckpt.LAST_BASENAME)
        out[key] = {"history": history, "best": best, "logs": logs,
                    "files": files,
                    "jsonl": (root / f"{key}.jsonl").read_text(),
                    "state": {k: _np(v) for k, v in
                              payload["model_state_dict"].items()}}
    # the mesh run's last checkpoint restored into sharded trainers
    # (model and moments resharded), gathered back whole
    payload, _ = ckpt.load_checkpoint(root / "2", ckpt.LAST_BASENAME)
    saved = {"state": payload["model_state_dict"],
             "mu": payload["optimizer_state_dict"]["mu"]}
    for key, mesh in (("fsdp", MeshConfig(fsdp=True)),
                      ("tp", MeshConfig(data=1, model=2))):
        pt = _trainer("thermal_only", inp, mesh)
        pt.restore(root / "2", with_opt_state=True,
                   basename=ckpt.LAST_BASENAME)
        model, opt, _ = pt._checkpoint_state()
        out[f"restore_{key}"] = max(
            float((model[k] - saved["state"][k]).abs().max())
            for k in saved["state"]) + max(
            float((opt["mu"][k] - saved["mu"][k]).abs().max())
            for k in saved["mu"])
    return out


def _refusals(inp):
    """The configurations the data-parallel step refuses: (name, error)."""
    from dfu_multimodal_tpu_torch.config import MeshConfig

    cases = {
        "mixup": ("thermal_only", MeshConfig(), dict(mixup_alpha=0.2)),
        "bn_accum": ("multimodal", MeshConfig(),
                     dict(grad_accum=3, batch_size=6)),
        "accum_split": ("thermal_only", MeshConfig(), dict(grad_accum=2)),
        "fsdp_tp": ("thermal_only", MeshConfig(data=1, model=2, fsdp=True),
                    {}),
        "fused_tp": ("thermal_only", MeshConfig(data=1, model=2),
                     dict(block_impl="fused")),
        "fused_fsdp": ("thermal_only", MeshConfig(fsdp=True),
                       dict(block_impl="fused")),
    }
    out = {}
    try:
        from dfu_multimodal_tpu_torch.config import rgb_modality
        from dfu_multimodal_tpu_torch.train import ssl
        ssl.SSLTrainer("tiny", ssl.PretrainConfig(
            mesh=MeshConfig(data=1, model=2)), rgb_modality(), device="cpu")
        out["ssl_tp"] = ""
    except ValueError as e:
        out["ssl_tp"] = str(e)
    for case, (name, mesh, over) in cases.items():
        try:
            pt = _trainer(name, inp, mesh, **over)
            pt.train_step(inp["thermal_batch"] if name == "thermal_only"
                          else inp["mm_batch"],
                          torch.Generator().manual_seed(0))
            out[case] = ""
        except ValueError as e:
            out[case] = str(e)
    return out


# -------------------------------------------------- mesh, TP, pipeline


def parallel_job(rank, inp):
    """The pipeline over two stages against the ViT's own forward, and
    the tensor-parallel qkv split of a 4-head block."""
    from dfu_multimodal_tpu_torch.config import MeshConfig
    from dfu_multimodal_tpu_torch.models.vit import ViT
    from dfu_multimodal_tpu_torch.parallel import mesh as mesh_mod
    from dfu_multimodal_tpu_torch.parallel import pipeline, sharding

    out = {}
    vit = ViT(image_size=IMAGE, block_impl="flax", attention_impl="xla",
              **TINY)
    vit.load_state_dict(inp["vit_state"])
    images = torch.from_numpy(inp["images"])
    pp = pipeline.make_pp_mesh(1, WORLD, "cpu")
    fn = pipeline.vit_pipeline_fn(pp, depth=TINY["depth"],
                                  num_microbatches=2)
    feats = fn(vit, images)
    (feats.square().sum() * 0.5).backward()
    pipeline.sync_pipeline_grads(vit, pp)
    out["pipeline"] = {"feats": _np(feats),
                       "grads": {k: _np(p.grad)
                                 for k, p in vit.named_parameters()}}
    for bad in (dict(depth=3), dict(depth=2, num_microbatches=3)):
        try:
            pipeline.vit_pipeline_fn(pp, **bad)(vit, images)
            out.setdefault("pipeline_errors", []).append("")
        except ValueError as e:
            out.setdefault("pipeline_errors", []).append(str(e))

    # tensor parallelism of one flax block: whole heads on each rank
    tp_vit = ViT(image_size=IMAGE, block_impl="flax", attention_impl="xla",
                 **TINY)
    tp_vit.load_state_dict(inp["vit_state"])
    with torch.no_grad():
        plain = tp_vit(images)
    mesh = mesh_mod.make_mesh(MeshConfig(data=1, model=WORLD), "cpu")
    plan = sharding.apply_tp(tp_vit, mesh)
    qkv = tp_vit.blocks[0].attn.qkv
    feats = tp_vit(images)
    (feats.square().sum() * 0.5).backward()
    out["tp"] = {"plan": plan, "plain": _np(plain), "feats": _np(feats),
                 "local_qkv": _np(qkv.weight.to_local()),
                 "local_qkv_bias": _np(qkv.bias.to_local()),
                 "grads": sharding.full_state(
                     {k: p.grad for k, p in tp_vit.named_parameters()},
                     tp_vit, plan),
                 "state": sharding.full_state(tp_vit.state_dict(), tp_vit,
                                              plan)}
    out["tp"]["grads"] = {k: _np(v) for k, v in out["tp"]["grads"].items()}
    out["tp"]["state"] = {k: _np(v) for k, v in out["tp"]["state"].items()}
    out["shard"] = mesh_mod.process_shard(7)
    out["rank"] = rank
    return out


