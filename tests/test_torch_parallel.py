"""The port's ``parallel/`` package and its small CLIs against the JAX
package, on the CPU.

Pure functions are held against JAX's without any process: the batch
split (``process_shard``, ``pad_batch_to_mesh``) over a grid of sizes,
the tensor-parallel and FSDP layouts of the tiny multimodal model (the
same leaves, matched through ``tools/convert_jax.py``), the umbrella
command's subcommands, and ``download_datasets`` with and without a
``kaggle`` on ``PATH``.  One two-rank gloo job (``torch_dist_job.
parallel_job``) pipelines a 2-block ViT over two stages, against JAX's
plain ViT forward and its gradients, and splits a 4-head block over two
tensor-parallel ranks.  Budgets: forward 1e-5 (the same fp32 math),
gradients 1e-5 of each leaf's largest entry.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ssl as tssl
import test_torch_train_bn as tbn
import torch_dist_job as job
from dfu_multimodal_tpu.cli import download_datasets as jax_download
from dfu_multimodal_tpu.cli import main as jax_main
from dfu_multimodal_tpu.models import vit as jax_vit
from dfu_multimodal_tpu.parallel import mesh as jax_mesh
from dfu_multimodal_tpu.parallel import sharding as jax_sharding
from dfu_multimodal_tpu_torch.cli import check_gpu
from dfu_multimodal_tpu_torch.cli import download_datasets as port_download
from dfu_multimodal_tpu_torch.cli import main as port_main
from dfu_multimodal_tpu_torch.parallel import mesh as port_mesh
from dfu_multimodal_tpu_torch.parallel import sharding as port_sharding
from dfu_multimodal_tpu_torch.tools.convert_jax import (variables_to_state_dict,
                                                        vit_state_dict)
from dfu_multimodal_tpu_torch.train import engine as port_engine

torch.set_num_threads(1)

IMAGE = 32
TOL = 1e-5


# ------------------------------------------------------------ the split


def test_process_shard_and_padding_match_jax(monkeypatch):
    for world in range(1, 5):
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
            for n in range(0, 21):
                assert port_mesh.process_shard(n, rank, world) == \
                    jax_mesh.process_shard(n)
    for d in range(1, 9):
        mesh = types.SimpleNamespace(shape={"data": d})
        for b in range(1, 40):
            assert port_mesh.pad_batch_to_mesh(b, d) == \
                jax_mesh.pad_batch_to_mesh(b, mesh)


def test_mesh_shape_keeps_jax_rule_and_error():
    cfg = port_engine.MeshConfig
    assert port_mesh.mesh_shape(cfg(), 8) == (8, 1)
    assert port_mesh.mesh_shape(cfg(model=2), 8) == (4, 2)
    with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 4"):
        port_mesh.mesh_shape(cfg(data=4, model=2), 4)


# ------------------------------------------------------------ the layouts


@pytest.fixture(scope="module")
def tagged():
    """The tiny multimodal model's JAX variables with every leaf the
    constant of its index, and the port's state_dict of them: a port
    tensor's value names the JAX leaf it came from."""
    module = tbn.JAX_MODULES["multimodal"]()
    x = jnp.zeros((1, IMAGE, IMAGE, 3))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, x))
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    variables = jax.tree_util.tree_unflatten(tree, [
        np.full(s.shape, i + 1, np.float32) for i, (_, s) in
        enumerate(leaves)])
    paths = {i + 1: "/".join(str(k.key) for k in p)
             for i, (p, _) in enumerate(leaves)}
    sd = variables_to_state_dict("multimodal", variables)
    return variables, paths, sd


def _jax_specs(specs):
    """path (as the ``tagged`` fixture names it) -> PartitionSpec."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {"params/" + "/".join(str(k.key) for k in p): s
            for p, s in flat[0]}


def _sharded_len(spec, shape, axis_name):
    """The length of the dimension ``spec`` shards over ``axis_name``
    (None: replicated)."""
    for i, a in enumerate(tuple(spec)):
        if a == axis_name:
            return shape[i]
    return None


def _compare(port_specs, jax_specs, tagged, axis_name, skip=()):
    variables, paths, sd = tagged
    flat = {"/".join(str(k.key) for k in p): np.shape(v) for p, v in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    checked = 0
    for name, t in sd.items():
        if name not in port_specs or name in skip:
            continue                       # buffers: FSDP shards no buffer
        path = paths[int(t.reshape(-1)[0])]
        ref = jax_specs[path]
        assert _sharded_len(port_specs[name], tuple(t.shape), axis_name) == \
            _sharded_len(ref, flat[path], axis_name), (name, path)
        checked += 1
    return checked


def test_tp_specs_match_jax_on_the_same_leaves(tagged):
    """Every parameter's TP split (which logical dimension, by its
    length) equals JAX's ``tp_param_specs`` of the leaf it came from."""
    variables, _, sd = tagged
    params = {k: v for k, v in sd.items()
              if not re.search(r"running_|num_batches", k)}
    port = port_sharding.tp_param_specs(params)
    ref = _jax_specs(jax_sharding.tp_param_specs(variables["params"]))
    assert _compare(port, ref, tagged, "model") == len(params)
    assert port["thermal_branch.blocks.0.attn.qkv.weight"] == ("model", None)
    assert port["thermal_branch.blocks.1.mlp.fc2.weight"] == (None, "model")
    # JAX's fusion rule needs a parent scope: the top-level head stays
    # replicated in both packages
    assert port["fusion.0.bias"] == () and port["fusion.3.weight"] == ()
    assert port_sharding.tp_param_specs({"m.fusion.0.bias": (512,)}) == {
        "m.fusion.0.bias": ("model",)}


@pytest.mark.parametrize("data", [2, 3])
def test_fsdp_specs_match_jax_on_the_same_leaves(tagged, data):
    """JAX's ``fsdp_param_specs`` (largest data-divisible dimension of a
    leaf of at least 1024 elements, ties in the flax order) picks the same
    dimension of every parameter but the patch embedding, which is one
    (p·p·C, hidden) kernel in JAX and a conv here (the recorded
    difference: JAX splits p·p·C = 192, which the conv has no dimension
    of)."""
    variables, _, sd = tagged
    params = {k: v for k, v in sd.items()
              if not re.search(r"running_|num_batches", k)}
    port = port_sharding.fsdp_param_specs(params, data)
    ref = _jax_specs(jax_sharding.fsdp_param_specs(
        variables["params"], types.SimpleNamespace(shape={"data": data})))
    patch = "thermal_branch.patch_embed.proj.weight"
    assert _compare(port, ref, tagged, "data", skip=(patch,)) == \
        len(params) - 1
    assert ref["params/thermal_branch/patch_embed/kernel"][0] == "data"
    assert any(port.values()) and not all(port.values())


def test_tp_guard_and_qkv_rank_order():
    shapes = {"a.attn.qkv.weight": (9, 3), "a.attn.qkv.bias": (9,),
              "a.attn.proj.weight": (3, 3)}
    assert port_sharding.tp_shardings(shapes, 2) == {
        k: () for k in shapes}
    # dim 4, two ranks: rank 0 holds q, k, v of heads 0-1, rank 1 of 2-3
    order = port_sharding.qkv_rank_order(4, 2).tolist()
    assert order == [0, 1, 4, 5, 8, 9, 2, 3, 6, 7, 10, 11]


# -------------------------------------------------------------- the CLIs


def test_commands_are_jax_s_with_check_gpu():
    ref = dict(jax_main.COMMANDS)
    ref.pop("check-tpu")
    ours = dict(port_main.COMMANDS)
    assert ours.pop("check-gpu")[0] == "check_gpu"
    assert ours.keys() == ref.keys()
    for name, (module, help_) in ours.items():
        assert module == ref[name][0]
        if name != "export-model":
            assert help_ == ref[name][1]
    assert "torch.export" in ours["export-model"][1]


def test_main_lists_every_subcommand(capsys):
    assert port_main.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in port_main.COMMANDS)
    assert port_main.main(["nope"]) == 2
    for name, (module, _) in port_main.COMMANDS.items():
        mod = __import__(f"dfu_multimodal_tpu_torch.cli.{module}",
                         fromlist=["main"])
        assert callable(mod.main), name


def test_pyproject_names_the_port_command():
    text = open(port_main.__file__.rsplit("dfu_multimodal_tpu_torch", 1)[0]
                + "pyproject.toml").read()
    assert 'dfu-torch = "dfu_multimodal_tpu_torch.cli.main:main"' in text
    assert 'dfu = "dfu_multimodal_tpu.cli.main:main"' in text


def test_download_without_kaggle_prints_jax_s_steps(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert port_download.main(["--out", "x"]) == 1
    ours = capsys.readouterr().out
    assert jax_download.main(["--out", "x"]) == 1
    assert ours == capsys.readouterr().out
    assert "laithjj/diabetic-foot-ulcer-dfu -> x/DFU_RGB" in ours


def test_download_calls_a_kaggle_on_path(tmp_path, monkeypatch, capsys):
    calls = tmp_path / "calls"
    stub = tmp_path / "bin" / "kaggle"
    stub.parent.mkdir()
    stub.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{stub.parent}")
    assert port_download.main(["--out", str(tmp_path / "d")]) == 0
    lines = calls.read_text().splitlines()
    assert lines == [f"datasets download -d {slug} -p {tmp_path}/d/{dest} "
                     "--unzip" for slug, dest in port_download.DATASETS]
    assert port_download.DATASETS == jax_download.DATASETS


def test_check_gpu(capsys):
    assert check_gpu.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"torch version: {torch.__version__}" in out
    assert "Process 0 of 1" in out and "Compute smoke: OK" in out
    if not torch.cuda.is_available():
        assert check_gpu.main([]) == 1
        assert "No CUDA device" in capsys.readouterr().out


# ---------------------------------------------------- pipeline and TP


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, rank 1's, JAX's features and gradients)."""
    d = tmp_path_factory.mktemp("parallel")
    module = jax_vit.ViT(block_impl="flax", attention_impl="xla",
                         **tssl.NARROW)
    shapes = jax.eval_shape(
        lambda x: module.init({"params": jax.random.PRNGKey(0)}, x),
        jnp.zeros((1, IMAGE, IMAGE, 3)))
    params = tssl._numpy_variables(shapes, 4)["params"]
    images = tssl._images(4, 5)
    torch.save({"vit_state": vit_state_dict(params), "images": images},
               d / "inputs.pt")
    ranks = job.Job("parallel_job", d)

    def loss(p):
        feats = module.apply({"params": p}, images)
        return 0.5 * jnp.sum(feats * feats), feats

    (_, feats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    ref = {"feats": np.asarray(feats), "grads": {
        k: v.numpy() for k, v in vit_state_dict(
            jax.tree.map(np.asarray, grads)).items()}}
    ranks.wait()
    return (torch.load(d / "out0.pt", weights_only=False),
            torch.load(d / "out1.pt", weights_only=False), ref)


def _grads_match(got, ref):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=TOL * float(np.abs(v).max()),
                                   err_msg=k)


def test_pipeline_matches_jax_forward_and_gradients(run):
    """Two stages, two microbatches: the CLS features on both stages and,
    after ``sync_pipeline_grads``, every gradient on both, as JAX's plain
    (unpipelined) ViT gives them."""
    for out in run[:2]:
        np.testing.assert_allclose(out["pipeline"]["feats"], run[2]["feats"],
                                   rtol=0, atol=TOL)
        _grads_match(out["pipeline"]["grads"], run[2]["grads"])


def test_pipeline_errors_are_jax_s(run):
    errs = run[0]["pipeline_errors"]
    assert errs[0] == "depth 3 not divisible by 2 pipeline stages"
    assert errs[1] == "local batch 4 not divisible by 3 microbatches"


def test_tp_keeps_whole_heads_on_each_rank(run):
    """A 4-head block over two ranks: rank r's qkv rows are q, k and v of
    heads 2r and 2r + 1 (not a plain split of q then k); the features
    equal the plain forward's and the gathered gradients JAX's."""
    state = run[0]["tp"]["state"]
    w, b = state["blocks.0.attn.qkv.weight"], state["blocks.0.attn.qkv.bias"]
    for rank, out in enumerate(run[:2]):
        order = port_sharding.qkv_rank_order(64, 2).numpy()
        mine = order[rank * 96:(rank + 1) * 96]
        heads = {(r % 64) // 16 for r in mine}
        assert heads == {2 * rank, 2 * rank + 1}
        assert [r // 64 for r in mine[::32]] == [0, 1, 2]
        np.testing.assert_array_equal(out["tp"]["local_qkv"], w[mine])
        np.testing.assert_array_equal(out["tp"]["local_qkv_bias"], b[mine])
        np.testing.assert_allclose(out["tp"]["feats"], out["tp"]["plain"],
                                   rtol=0, atol=TOL)
        _grads_match(out["tp"]["grads"], run[2]["grads"])
    plan = run[0]["tp"]["plan"]
    assert plan["blocks.0.attn.qkv"] == "col" and len(plan) == 8
