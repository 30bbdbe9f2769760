"""The port's dataset tools against the JAX package's, on the CPU.

- ``tools/splits.py::train_test_split`` (numpy's statement of
  scikit-learn's shuffle split) against scikit-learn itself.
- ``organize_clean_dataset`` on the same raw Kaggle-style layout (with a
  cross-class duplicate and a PNG) by both packages: the organised trees
  equal file for file and byte for byte, the manifests equal but for
  their ``created`` path, the dedupe reports and summaries equal.
- ``dataset_tools`` ``patient-split``, ``prepare`` and ``prepare-raw``:
  the same files in the same splits.  ``verify`` and ``stats`` equal.
- ``data/loader.py::image_info`` against PIL's ``(size, mode, format)``.
- ``analyze``'s stats dict equal; a BMP, counted by the JAX package
  (PIL opens it), is skipped by the port.
- ``standardize --verify`` on JPEG and PNG sources, portrait and
  landscape: the same pixels, and on the libjpeg route the same JPEG
  bytes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dfu_multimodal_tpu.cli import dataset_tools as jax_tools_cli
from dfu_multimodal_tpu.cli import organize_clean_dataset as jax_org_cli
from dfu_multimodal_tpu.tools import analyze as jax_analyze
from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.cli import dataset_tools as port_tools_cli
from dfu_multimodal_tpu_torch.cli import organize_clean_dataset as port_org_cli
from dfu_multimodal_tpu_torch.data.loader import DecodeError, image_info
from dfu_multimodal_tpu_torch.tools import analyze as port_analyze
from dfu_multimodal_tpu_torch.tools import splits as port_splits

FIXTURES = (Path(__file__).resolve().parents[1] / "dfu_multimodal_tpu_torch"
            / "data" / "fixtures")


def _write_img(path, size=(30, 20), seed=0, fmt=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (size[1], size[0], 3), np.uint8)
    Image.fromarray(arr).save(path, format=fmt)
    return path


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# ------------------------------------------------------------------ splits


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("test_size", [0.3, 0.5, 0.15])
def test_split_matches_sklearn(test_size, seed):
    from sklearn.model_selection import train_test_split
    for n in range(2, 301):
        items = [f"x{i}" for i in range(n)]
        ours = port_splits.train_test_split(items, test_size, seed)
        ref = train_test_split(items, test_size=test_size, random_state=seed)
        assert list(ours) == [list(r) for r in ref], n
    with pytest.raises(ValueError):
        port_splits.train_test_split(["a"], test_size, seed)


# --------------------------------------------------------------- organize


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """tests/test_tools.py's raw layout (a cross-class duplicate; the
    thermal train and val images share their seeds, so eight more
    duplicates), plus a PNG."""
    root = tmp_path_factory.mktemp("raw")
    rgb = root / "DFU_RGB"
    for i in range(6):
        _write_img(rgb / "Patches" / "Normal" / f"norm_{i}.jpg", seed=i)
    for i in range(6):
        _write_img(rgb / "Patches" / "Abnormal" / f"ab_{i}.jpg",
                   seed=100 + i)
    _write_img(rgb / "TestSet" / "t_0.jpg", seed=200)
    _write_img(rgb / "TestSet" / "t_1.png", size=(24, 40), seed=201)
    dup_src = rgb / "Patches" / "Normal" / "norm_0.jpg"
    (rgb / "Patches" / "Abnormal" / "dup.jpg").write_bytes(
        dup_src.read_bytes())
    th = root / "DFU_Thermal"
    for split in ("train", "val"):
        for i in range(4):
            _write_img(th / "ThermoDataBase" / split / "Control Group"
                       / f"c_{split}_{i}.jpg", seed=300 + i * 7)
            _write_img(th / "ThermoDataBase" / split / "DM Group"
                       / f"d_{split}_{i}.jpg", seed=400 + i * 7)
    return rgb, th


@pytest.fixture(scope="module")
def organized(raw_tree, tmp_path_factory):
    rgb, th = raw_tree
    out = tmp_path_factory.mktemp("organized")
    res = {}
    for name, cli in (("jax", jax_org_cli), ("port", port_org_cli)):
        res[name] = cli.main(["--rgb-source", str(rgb), "--thermal-source",
                              str(th), "--output", str(out / name)])
    return out / "jax", out / "port", res


def test_organize_matches_jax(organized):
    jax_out, port_out, res = organized
    jax_tree, port_tree = _tree(jax_out), _tree(port_out)
    manifest = "dataset_manifest.json"
    assert set(jax_tree) == set(port_tree)
    for name in jax_tree:
        if name != manifest:
            assert jax_tree[name] == port_tree[name], name
    jm = json.loads(jax_tree[manifest])
    pm = json.loads(port_tree[manifest])
    assert jm.pop("created") != pm.pop("created")
    assert jm == pm
    for modality in ("rgb", "thermal"):
        j, p = res["jax"][modality], res["port"][modality]
        assert (j.healthy, j.ulcer, j.errors, j.split_counts,
                j.dedupe_report) == (p.healthy, p.ulcer, p.errors,
                                     p.split_counts, p.dedupe_report)
    assert res["port"]["rgb"].dedupe_report["duplicates_removed"] == 1
    assert res["port"]["thermal"].dedupe_report["duplicates_removed"] == 8


@pytest.mark.parametrize("command", ["patient-split", "prepare",
                                     "prepare-raw"])
def test_split_commands_match_jax(command, raw_tree, tmp_path):
    rgb, th = raw_tree
    if command == "prepare-raw":
        args = ["--rgb-source", str(rgb), "--thermal-source", str(th)]
    else:
        src = tmp_path / "flat"
        for c, cls in enumerate(("healthy", "ulcer")):
            for i in range(24):
                _write_img(src / cls / f"img_{i}.jpg", size=(8, 8),
                           seed=100 * c + i)
        args = ["--src", str(src)]
    outs = {}
    for name, cli in (("jax", jax_tools_cli), ("port", port_tools_cli)):
        outs[name] = tmp_path / name
        res = cli.main([command] + args + ["--out", str(outs[name]),
                                           "--seed", "7"])
        outs[name + "_res"] = res
    assert outs["jax_res"] == outs["port_res"]
    assert _tree(outs["jax"]) == _tree(outs["port"])


def test_verify_and_stats_match_jax(organized, raw_tree, capsys):
    _, port_out, _ = organized
    rgb, th = raw_tree
    args = ["verify", "--rgb-source", str(rgb), "--thermal-source", str(th),
            "--organized", str(port_out)]
    res = [cli.main(args) for cli in (jax_tools_cli, port_tools_cli)]
    assert res[0] == res[1] and all(res[1]["organized"].values())
    printed = []
    for cli in (jax_tools_cli, port_tools_cli):
        capsys.readouterr()
        cli.main(["stats", "--data-dir", str(port_out)])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "rgb" in printed[1].lower()


# -------------------------------------------------------------- image_info


def _png_cases(tmp: Path):
    """A PNG of every mode PIL writes, and of each palette depth."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (9, 13, 3), np.uint8)
    gray = rgb[..., 0]
    cases = {
        "1.png": (Image.fromarray(gray > 127), {}),
        "l.png": (Image.fromarray(gray, "L"), {}),
        "i16.png": (Image.fromarray(gray.astype(np.uint16) * 257), {}),
        "rgb.png": (Image.fromarray(rgb), {}),
        "rgba.png": (Image.fromarray(np.dstack([rgb, gray]), "RGBA"), {}),
        "la.png": (Image.fromarray(np.dstack([gray, gray]), "LA"), {}),
        "p8.png": (Image.fromarray(rgb).quantize(200), {}),
        "p_trns.png": (Image.fromarray(rgb).quantize(16),
                       {"transparency": 3}),
    }
    for bits in (1, 2, 4):
        cases[f"p{bits}.png"] = (Image.fromarray(rgb).quantize(2 ** bits),
                                 {"bits": bits})
    cases["cmyk.jpg"] = (Image.fromarray(rgb).convert("CMYK"), {})
    cases["gray.jpg"] = (Image.fromarray(gray, "L"), {})
    cases["rgb.jpg"] = (Image.fromarray(rgb), {"quality": 80})
    paths = []
    for name, (img, kw) in cases.items():
        img.save(tmp / name, **kw)
        paths.append(tmp / name)
    return paths


def test_image_info_matches_pil(tmp_path):
    files = sorted(p for p in FIXTURES.iterdir() if p.suffix != ".npz")
    files += _png_cases(tmp_path)
    modes = set()
    for p in files:
        with Image.open(p) as img:
            ref = (*img.size, img.mode, img.format)
        assert image_info(p) == ref, p.name
        modes.add(ref[2])
    assert modes >= {"1", "L", "I;16", "RGB", "RGBA", "LA", "P", "CMYK"}
    for fmt in ("BMP", "GIF", "TIFF"):
        p = _write_img(tmp_path / f"x.{fmt.lower()}", fmt=fmt)
        with pytest.raises(DecodeError, match=str(p)):
            image_info(p)


# ----------------------------------------------------------------- analyze


def test_analyze_matches_jax_and_skips_a_bmp(tmp_path):
    root = tmp_path / "imgs"
    for i, size in enumerate([(30, 20), (20, 30), (64, 64), (50, 49)]):
        _write_img(root / "a" / f"{i}.jpg", size=size, seed=i)
    _write_img(root / "b" / "x.png", size=(33, 17), seed=9)
    Image.fromarray(np.zeros((8, 8), np.uint8), "L").save(root / "g.png")
    ref = jax_analyze.analyze_image_sizes(root, verbose=False)
    ours = port_analyze.analyze_image_sizes(root, verbose=False)
    assert ours == ref and ours["count"] == 6
    # the pinned difference: PIL opens a BMP, the port's headers do not
    _write_img(root / "c" / "y.bmp", size=(40, 10), seed=5, fmt="BMP")
    ref = jax_analyze.analyze_image_sizes(root, verbose=False)
    ours2 = port_analyze.analyze_image_sizes(root, verbose=False)
    assert ref["count"] == 7 and ref["formats"]["BMP"] == 1
    assert ours2 == ours


# ------------------------------------------------------------- standardize


@pytest.mark.parametrize("suffix", [".jpg", ".png"])
def test_standardize_matches_jax(suffix, tmp_path):
    src = tmp_path / "src"
    # odd margins on both axes (64 - 25 = 39): the paste's rounding shows
    for name, size in (("wide", (100, 39)), ("tall", (30, 77)),
                       ("square", (48, 48))):
        _write_img(src / "sub" / f"{name}{suffix}", size=size,
                   seed=len(name))
    res = {}
    for name, cli in (("jax", jax_tools_cli), ("port", port_tools_cli)):
        res[name] = cli.main(["standardize", "--src", str(src), "--dst",
                              str(tmp_path / name), "--target", "64",
                              "--verify"])
    assert res["jax"] == res["port"] == {"processed": 3, "errors": 0,
                                         "ok": 3, "bad": 0}
    exact_bytes = suffix == ".jpg" and native.route() == "libjpeg"
    for f in sorted((tmp_path / "jax").rglob("*.*")):
        g = tmp_path / "port" / f.relative_to(tmp_path / "jax")
        with Image.open(f) as a, Image.open(g) as b:
            assert a.format == b.format and a.size == b.size == (64, 64)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if exact_bytes:
            assert f.read_bytes() == g.read_bytes(), f.name


def test_standardize_counts_an_undecodable_file(tmp_path, capsys):
    src = tmp_path / "src"
    _write_img(src / "ok.jpg", size=(20, 10))
    _write_img(src / "bad.bmp", size=(20, 10), fmt="BMP")
    res = port_tools_cli.main(["standardize", "--src", str(src), "--dst",
                               str(tmp_path / "dst"), "--target", "16"])
    assert res == {"processed": 1, "errors": 1}
    assert "bad.bmp" in capsys.readouterr().out
