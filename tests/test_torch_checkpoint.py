"""Checkpoints and ``Trainer.fit`` of the port against the JAX package, on
the CPU: the flax msgpack reader, a JAX checkpoint restored into the port
(and trained on), and ``fit``'s files, meta keys, resume, early stopping,
metrics JSONL and asynchronous save.

The tiny thermal_only ViT of ``test_torch_train.py`` (fp32, no dropout,
identity augmentation) keeps every JAX program small.  Budgets, stated at
each comparison, are those of ``test_train_steps_match_jax_trainer``.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.data import loader as jax_loader
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt
from dfu_multimodal_tpu_torch.utils.flax_msgpack import (MsgpackError,
                                                         msgpack_restore)
from test_torch_train import (CFG, CLASS_WEIGHTS, IMAGE, _batches, _neutral,
                              _port_trainer, _tiny_variables,
                              _TinyJaxViTClassifier)

torch.set_num_threads(1)


def _jax_trainer(**overrides):
    cfg = jax_config.TrainConfig(**{**CFG, **overrides},
                                 mesh=jax_config.MeshConfig(data=1))
    mod = _neutral(jax_config.thermal_modality, jax_config.AugmentConfig)
    jt = JaxTrainer("thermal_only", cfg, {"thermal": mod},
                    class_weights=CLASS_WEIGHTS, attention_impl="xla",
                    block_impl="flax")
    jt.module = _TinyJaxViTClassifier()
    return jt


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX package's ``save_checkpoint`` wrote after one
    step of the JAX Trainer (bf16 first moment, the default), the state
    it holds, the trainer, and the batch of the next step."""
    jt = _jax_trainer(optimizer_mu_dtype="bfloat16")
    variables = _tiny_variables()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    state = state.replace(params=jax.tree.map(jnp.asarray,
                                              variables["params"]),
                          opt_state=jt.tx.init(variables["params"]))
    first, second = _batches()
    state, _ = jt.train_step(state, jax.device_put(first, jt.batch_sharding),
                             jax.random.PRNGKey(1))
    directory = tmp_path_factory.mktemp("jax_ckpt")
    jax_ckpt.save_checkpoint(directory, epoch=4, model_state=jt.variables(
        state), opt_state=state.opt_state, val_f1=0.5,
        history={"val_f1": [0.5]}, extra_meta={"model": "thermal_only"})
    return directory, jt, state, second


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_msgpack_reader_matches_flax(jax_checkpoint):
    """Every leaf of a JAX checkpoint, as flax reads it: the same paths,
    dtype names (the bf16 first moment included) and bits."""
    directory = jax_checkpoint[0]
    data = (directory / "best_model.msgpack").read_bytes()
    ref = dict(_leaves(serialization.msgpack_restore(data)))
    ours = dict(_leaves(msgpack_restore(data)))
    assert ours.keys() == ref.keys()
    dtypes = set()
    for path, r in ref.items():
        o = ours[path]
        r = np.asarray(r)
        assert str(o.dtype).removeprefix("torch.") == r.dtype.name, path
        dtypes.add(r.dtype.name)
        assert tuple(o.shape) == r.shape, path
        if r.dtype.name == "bfloat16":
            np.testing.assert_array_equal(o.view(torch.int16).numpy(),
                                          r.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(o.numpy(), r, err_msg=path)
    assert {"bfloat16", "float32", "int32"} <= dtypes
    with pytest.raises(MsgpackError, match="chunked"):
        msgpack_restore(serialization.msgpack_serialize(
            {"a": {"__msgpack_chunked_array__": True}}))
    with pytest.raises(MsgpackError, match="truncated"):
        msgpack_restore(data[:-3])


def test_jax_checkpoint_restores_into_port(jax_checkpoint):
    """The port restores the JAX directory (weights and optax state):
    eval logits within 1e-5 of JAX's; then one more train step matches
    JAX's next step (loss 1e-5 relative, parameters within 2·lr, the bf16
    first moments within one bf16 step at each leaf's largest entry,
    2^-7 of it: a sum an ulp apart in fp32 may round to either neighbour;
    count 2)."""
    directory, jt, state, second = jax_checkpoint
    state = jax.tree.map(jnp.copy, state)      # the step donates its state
    pt = _port_trainer(optimizer_mu_dtype="bfloat16")
    pt.restore(directory, with_opt_state=True)
    assert pt.optimizer.count == 1
    assert pt.optimizer.mu[0].dtype == torch.bfloat16

    inputs = jt._preprocess_eval({"thermal": jnp.asarray(second["thermal"])})
    ref = np.asarray(jt.module.apply(jt.variables(state), *inputs,
                                     train=False))
    pt.module.eval()
    with torch.no_grad():
        ours = pt.module(*pt._preprocess_eval(
            {"thermal": torch.from_numpy(second["thermal"])})).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)

    state, jm = jt.train_step(state, jax.device_put(second,
                                                    jt.batch_sharding),
                              jax.random.PRNGKey(1))
    pm = pt.train_step(second, torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    lr = CFG["learning_rate"]
    ref = variables_to_state_dict("thermal_only", {
        "params": jax.tree.map(np.asarray, state.params)})
    params = pt.module.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0,
                                   atol=2 * lr, err_msg=k)
    ref_mu = variables_to_state_dict("thermal_only", {"params": jax.tree.map(
        lambda a: np.asarray(a, np.float32), state.opt_state[0].mu)})
    mu = pt.optimizer.state_dict()["mu"]
    for k, v in ref_mu.items():
        np.testing.assert_allclose(mu[k].float().numpy(), v.numpy(), rtol=0,
                                   atol=2 ** -7 * float(v.abs().max()),
                                   err_msg=k)
    assert pt.optimizer.count == 2


def test_fit_resumes_from_a_jax_directory(jax_checkpoint):
    """``fit(resume_from=<JAX dir>)`` picks up its epoch, history, best F1
    and optimizer count; ``init_from`` takes the weights only."""
    directory, jt, state, _ = jax_checkpoint
    logs = []
    pt = _port_trainer(num_epochs=4)
    history, best = pt.fit(None, None, resume_from=directory,
                           log=logs.append)
    assert "at epoch 5" in logs[-1] and best == 0.5
    assert history["val_f1"] == [0.5] and pt.optimizer.count == 1
    ref = variables_to_state_dict("thermal_only", {
        "params": jax.tree.map(np.asarray, state.params)})
    params = pt.module.state_dict()
    for k, v in ref.items():
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)
    pt = _port_trainer(num_epochs=0)
    pt.fit(None, None, init_from=directory, log=logs.append)
    assert pt.optimizer.count == 0
    torch.testing.assert_close(pt.module.state_dict()["head.weight"],
                               ref["head.weight"], rtol=0, atol=0)


def _datasets(n_train=8, n_val=4, seed=11):
    rng = np.random.default_rng(seed)
    arrays = {"thermal": rng.integers(0, 256, (n_train + n_val, IMAGE, IMAGE,
                                               3), dtype=np.uint8)}
    labels = np.arange(n_train + n_val, dtype=np.int32) % 2
    return ({k: v[:n_train] for k, v in arrays.items()}, labels[:n_train],
            {k: v[n_train:] for k, v in arrays.items()}, labels[n_train:])


FIT = dict(num_epochs=3, save_best_after_epoch=2, save_last=True,
           batch_size=4, eval_batch_size=3, learning_rate=1e-3)


def test_fit_files_meta_and_jsonl_match_jax(tmp_path, jax_checkpoint):
    """Three epochs of the port's ``fit`` (async saves) beside the JAX
    ``fit``, both warm-started (``init_from``) from the JAX checkpoint, on
    the same data in the same epoch orders: the same files (``.pt`` for
    ``.msgpack``), meta and metrics-JSONL keys, the same val F1 per epoch
    (predictions equal) and losses within 1e-4; the best checkpoint no
    earlier than ``save_best_after_epoch``."""
    tr_x, tr_y, va_x, va_y = _datasets()
    jt = _jax_trainer(**FIT)
    _, ref_history, ref_best = jt.fit(
        jax_loader.ArrayDataset(tr_x, tr_y),
        jax_loader.ArrayDataset(va_x, va_y), tmp_path / "jax",
        image_size=IMAGE, log=lambda s: None, init_from=jax_checkpoint[0],
        metrics_jsonl=tmp_path / "jax.jsonl")
    pt = _port_trainer(**FIT, async_checkpoint=True)
    history, best = pt.fit(ArrayDataset(tr_x, tr_y), ArrayDataset(va_x, va_y),
                           tmp_path / "port", log=lambda s: None,
                           init_from=jax_checkpoint[0],
                           metrics_jsonl=tmp_path / "port.jsonl")
    assert history["val_f1"] == ref_history["val_f1"] and best == ref_best
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(history[key], ref_history[key], rtol=1e-4)

    def files(d):
        return sorted(p.name.replace(".msgpack", ".pt") for p in d.iterdir())

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert "last_model.pt" in files(tmp_path / "port")
    for base in ("best_model", "last_model"):
        if not ckpt.best_checkpoint_exists(tmp_path / "port", base):
            continue
        ours = ckpt.load_meta(tmp_path / "port", base)
        theirs = jax_ckpt.load_meta(tmp_path / "jax", base)
        assert ours.keys() == theirs.keys(), base
        assert ours["history"].keys() == theirs["history"].keys()
    last = ckpt.load_meta(tmp_path / "port", "last_model")
    assert last["epoch"] == 3 and last["model"] == "thermal_only"
    assert [len(v) for v in history.values()] == [3] * 6
    if ckpt.best_checkpoint_exists(tmp_path / "port"):
        assert ckpt.load_meta(tmp_path / "port")["epoch"] >= 2
        assert best == ckpt.load_meta(tmp_path / "port")["val_f1"]
    else:
        assert best == 0.0
    rows = [json.loads(line) for line in
            (tmp_path / "port.jsonl").read_text().splitlines()]
    ref_rows = [json.loads(line) for line in
                (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [r.keys() for r in rows] == [r.keys() for r in ref_rows]
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    payload, _ = ckpt.load_checkpoint(tmp_path / "port", "last_model")
    assert set(payload) == {"epoch", "model_state_dict",
                            "optimizer_state_dict", "val_f1", "history"}
    assert payload["optimizer_state_dict"]["count"] == 3 * 2


def test_fit_resume_continues_at_the_next_epoch(tmp_path):
    """``save_last`` and resume: a second trainer continues at epoch 3
    from ``last_model`` with the optimizer count restored, and its
    restored weights are the saved ones bit for bit."""
    tr_x, tr_y, va_x, va_y = _datasets()
    train, val = ArrayDataset(tr_x, tr_y), ArrayDataset(va_x, va_y)
    first = _port_trainer(**{**FIT, "num_epochs": 2})
    first.fit(train, val, tmp_path, log=lambda s: None)
    saved = {k: v.clone() for k, v in first.module.state_dict().items()}
    assert ckpt.resume_basename(tmp_path) == ckpt.LAST_BASENAME

    second = _port_trainer(**FIT)
    second.restore(tmp_path, with_opt_state=True,
                   basename=ckpt.LAST_BASENAME)
    assert second.optimizer.count == 2 * 2
    for k, v in second.module.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    logs = []
    history, _ = second.fit(train, val, tmp_path, log=logs.append,
                            resume_from=tmp_path)
    assert "at epoch 3" in logs[0]
    assert [len(v) for v in history.values()] == [3] * 6
    assert second.optimizer.count == 3 * 2
    assert ckpt.load_meta(tmp_path, ckpt.LAST_BASENAME)["epoch"] == 3


def test_fit_early_stopping_and_ema_checkpoints(tmp_path):
    """At lr 0 the val F1 never improves: patience 1 stops after epoch 2
    (whose profiler trace is written).
    With EMA the checkpoint's model is the EMA, ``raw_params`` the live
    weights, and a restore puts each back where it was."""
    tr_x, tr_y, va_x, va_y = _datasets()
    train, val = ArrayDataset(tr_x, tr_y), ArrayDataset(va_x, va_y)
    logs = []
    pt = _port_trainer(**{**FIT, "num_epochs": 5, "learning_rate": 0.0,
                          "early_stop_patience": 1})
    history, _ = pt.fit(train, val, log=logs.append,
                        profile_dir=tmp_path / "trace")
    assert len(history["val_f1"]) == 2 and "Early stopping" in logs[-1]
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

    pt = _port_trainer(**{**FIT, "num_epochs": 1, "ema_decay": 0.5,
                          "save_best_after_epoch": 1})
    pt.fit(train, val, tmp_path, log=lambda s: None)
    payload, meta = ckpt.load_checkpoint(tmp_path, ckpt.LAST_BASENAME)
    assert meta["ema_decay"] == 0.5
    live = dict(pt.module.named_parameters())
    for k, v in pt.ema_params.items():
        torch.testing.assert_close(payload["model_state_dict"][k], v)
        torch.testing.assert_close(payload["raw_params"][k], live[k].detach())
    assert not all(torch.equal(v, live[k]) for k, v in pt.ema_params.items())
    again = _port_trainer(**{**FIT, "ema_decay": 0.5})
    again.restore(tmp_path, with_opt_state=True, basename=ckpt.LAST_BASENAME)
    for k, p in again.module.named_parameters():
        torch.testing.assert_close(p.detach(), live[k].detach())
        torch.testing.assert_close(again.ema_params[k], pt.ema_params[k])


def test_async_save_holds_the_snapshot_before_the_next_step(tmp_path,
                                                            monkeypatch):
    """The writer thread is held until the state has been changed in
    place (as the next step changes it): the file has the values of the
    moment ``save`` was called."""
    release = threading.Event()
    real = ckpt.save_checkpoint

    def held(*args, **kwargs):
        assert release.wait(timeout=30)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    w = torch.arange(6, dtype=torch.float32)
    mu = torch.ones(3, dtype=torch.bfloat16)
    saver = ckpt.AsyncCheckpointer()
    saver.save(tmp_path, epoch=1, model_state={"w": w},
               opt_state={"count": 1, "mu": {"w": mu}}, val_f1=0.25,
               history={"val_f1": [0.25]})
    w.add_(100.0)
    mu.mul_(3.0)
    release.set()
    saver.wait()
    payload, meta = ckpt.load_checkpoint(tmp_path)
    torch.testing.assert_close(payload["model_state_dict"]["w"],
                               torch.arange(6, dtype=torch.float32))
    torch.testing.assert_close(payload["optimizer_state_dict"]["mu"]["w"],
                               torch.ones(3, dtype=torch.bfloat16))
    assert meta == {"epoch": 1, "val_f1": 0.25, "history": {"val_f1": [0.25]}}

    def failing(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_checkpoint", failing)
    saver.save(tmp_path, epoch=2, model_state={"w": w}, opt_state=None,
               val_f1=0.5, history={})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        saver.wait()


NO_FLAX_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "msgpack",
             "dfu_multimodal_tpu"):
    sys.modules[name] = None            # any import of them now fails
import torch
torch.set_num_threads(1)
from dfu_multimodal_tpu_torch.train.engine import (
    Trainer, TrainConfig, thermal_modality)
trainer = Trainer("thermal_only", TrainConfig(compute_dtype="float32",
                                              num_epochs=4),
                  {"thermal": thermal_modality()}, device="cpu",
                  image_size=32, depth=2, hidden_dim=64, num_heads=4,
                  patch_size=8)
history, best = trainer.fit(None, None, resume_from=sys.argv[1],
                            log=lambda s: None)
assert trainer.optimizer.count == 1 and best == 0.5, (trainer.optimizer.count,
                                                      best)
print("ok")
"""


def test_jax_checkpoint_loads_without_flax_or_msgpack(jax_checkpoint):
    """The JAX directory resumes in a process where jax, flax, optax,
    msgpack and the JAX package cannot be imported."""
    import subprocess
    import sys
    from pathlib import Path
    proc = subprocess.run(
        [sys.executable, "-c", NO_FLAX_SCRIPT, str(jax_checkpoint[0])],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
