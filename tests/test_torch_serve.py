"""The port's ServingEngine on the CPU: bucketing, results equal to a
direct eval step, backpressure and stop semantics.  A full-width
multimodal model at image 32 with seeded random weights."""

import numpy as np
import pytest
import torch

from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.serve.engine import (EngineOverloaded,
                                                   ServingEngine)
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   rgb_modality,
                                                   thermal_modality)

torch.set_num_threads(1)

IMAGE = 32


@pytest.fixture(scope="module")
def trainer():
    tr = Trainer("multimodal", TrainConfig(compute_dtype="float32"),
                 {"rgb": rgb_modality(), "thermal": thermal_modality()},
                 device="cpu", image_size=IMAGE)
    zoo.init_model(tr.module, torch.Generator().manual_seed(0))
    return tr


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    return [{m: rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
             for m in ("rgb", "thermal")} for _ in range(n)]


def _spy(monkeypatch, trainer):
    """Record the batch size of every eval step the engine runs."""
    sizes = []
    real = trainer.eval_step

    def eval_step(batch):
        sizes.append(len(batch["rgb"]))
        return real(batch)

    monkeypatch.setattr(trainer, "eval_step", eval_step)
    return sizes


def test_requests_coalesce_into_a_padded_bucket(trainer, monkeypatch):
    sizes = _spy(monkeypatch, trainer)
    eng = ServingEngine(trainer, image_size=IMAGE, max_batch=4,
                        max_wait_ms=200.0)
    assert eng.buckets == (1, 2, 4)
    futs = [eng.submit(s) for s in _samples(3, seed=1)]   # queued first
    with eng:
        results = [f.result(timeout=60) for f in futs]
    # start() runs every bucket on the batcher thread, then the 3 queued
    # requests go as one bucket-4 forward
    assert sizes == [1, 2, 4, 4]
    stats = eng.stats()
    assert stats["requests"] == 3 and stats["errors"] == 0
    assert stats["batch_size_hist"] == {3: 1}
    assert all(0.0 <= p <= 1.0 and pred in (0, 1) for p, pred in results)


def test_predict_equals_direct_eval_step(trainer):
    samples = _samples(3, seed=2)
    with ServingEngine(trainer, image_size=IMAGE, max_batch=4) as eng:
        served = eng.predict(samples)
    direct = trainer.eval_step(
        {m: np.stack([s[m] for s in samples]) for m in ("rgb", "thermal")})
    np.testing.assert_allclose([p for p, _ in served],
                               direct["probs"].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert [pred for _, pred in served] == direct["preds"].tolist()


def test_warmup_runs_every_bucket_unrecorded(trainer, monkeypatch):
    sizes = _spy(monkeypatch, trainer)
    eng = ServingEngine(trainer, image_size=IMAGE, max_batch=4)
    eng.warmup()
    assert sizes == [1, 2, 4]
    assert eng.stats()["requests"] == 0


def test_full_queue_raises_overloaded(trainer):
    eng = ServingEngine(trainer, image_size=IMAGE, max_batch=4, max_queue=2)
    samples = _samples(3, seed=3)
    queued = [eng.submit(s) for s in samples[:2]]     # no batcher running
    with pytest.raises(EngineOverloaded):
        eng.submit(samples[2])
    assert eng.stats()["rejected"] == 1
    eng.stop()                          # fails the queued stragglers
    for f in queued:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=0)


def test_submit_after_stop_raises(trainer):
    eng = ServingEngine(trainer, image_size=IMAGE, max_batch=2).start()
    eng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_samples(1, seed=4)[0])


def test_malformed_samples_raise_to_their_caller(trainer):
    eng = ServingEngine(trainer, image_size=IMAGE, max_batch=2)
    good = _samples(1, seed=5)[0]
    with pytest.raises(ValueError, match="uint8"):
        eng.submit({"rgb": good["rgb"].astype(np.float32)})
    with pytest.raises(ValueError, match="unknown modality"):
        eng.submit({"depth": good["rgb"]})
    with pytest.raises(ValueError, match="at least one"):
        eng.submit({})


def test_multimodal_flax_blocks_equal_fused(trainer):
    """``multimodal`` hands ``block_impl`` / ``attention_impl`` to its
    thermal branch: the flax blocks with the packed-qkv attention give
    the fused blocks' eval step on the same weights, within the fp32
    budget of the model tests (1e-4; the same math summed in another
    order)."""
    flax = Trainer("multimodal", TrainConfig(compute_dtype="float32"),
                   {"rgb": rgb_modality(), "thermal": thermal_modality()},
                   device="cpu", image_size=IMAGE, block_impl="flax",
                   attention_impl="pallas")
    assert type(flax.module.thermal_branch.blocks[0]).__name__ == \
        "EncoderBlock"
    flax.module.load_state_dict(trainer.variables(), strict=True)
    samples = _samples(3, seed=6)
    batch = {m: np.stack([s[m] for s in samples]) for m in ("rgb", "thermal")}
    ref, out = trainer.eval_step(batch), flax.eval_step(batch)
    np.testing.assert_allclose(out["probs"].numpy(), ref["probs"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert out["preds"].tolist() == ref["preds"].tolist()


def test_flax_thermal_trainer_serves_and_quantises():
    """A tiny flax/``pallas`` thermal_only trainer behind the engine
    returns its eval step's probabilities; ``quantize_for_serving`` of it
    builds the ``fused_q8`` trainer (the blocks share their keys)."""
    from dfu_multimodal_tpu_torch.models.vit import QuantizedEncoderBlock
    from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving

    tr = Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                 {"thermal": thermal_modality()}, device="cpu",
                 image_size=IMAGE, depth=2, hidden_dim=64, num_heads=4,
                 patch_size=8, block_impl="flax", attention_impl="pallas")
    zoo.init_model(tr.module, torch.Generator().manual_seed(0))
    samples = [{"thermal": s["thermal"]} for s in _samples(3, seed=7)]
    with ServingEngine(tr, image_size=IMAGE, max_batch=4) as eng:
        served = eng.predict(samples)
    direct = tr.eval_step({"thermal": np.stack([s["thermal"]
                                                for s in samples])})
    np.testing.assert_allclose([p for p, _ in served],
                               direct["probs"].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert [pred for _, pred in served] == direct["preds"].tolist()

    q = quantize_for_serving(tr, image_size=IMAGE)
    assert q.model_kwargs["block_impl"] == "fused_q8"
    assert all(type(b) is QuantizedEncoderBlock for b in q.module.vit.blocks)
    probs = q.eval_step({"thermal": np.stack([s["thermal"]
                                              for s in samples])})["probs"]
    assert bool(torch.isfinite(probs).all())
