"""The port's ``evaluate`` and ``ensemble`` entries against the root
``evaluate.py`` and ``tools/ensemble.py`` on the same trees (numpy only;
the root files import the JAX package and pandas, the port's neither).

``scores.csv`` must be the same FILE, byte for byte: the columns in the
root's order under its index column, the floats as pandas writes them.
The ensemble's label and probability maps must be equal.
"""

import csv
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from fetal_mri_segmentation_tpu.utils import (  # noqa: E402
    surface_metrics as jax_surface)
from fetal_mri_segmentation_tpu_torch import (  # noqa: E402
    ensemble as port_ensemble, evaluate as port_evaluate)
from fetal_mri_segmentation_tpu_torch.utils import (  # noqa: E402
    surface_metrics as port_surface)
from fetal_mri_segmentation_tpu_torch.utils.nifti import (  # noqa: E402
    load_nifti, save_nifti)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _blobs(seed, shape=(18, 20, 16)):
    """A truth with labels 1, 2, 4 and a prediction that is off by a shift
    and some noise."""
    rng = np.random.default_rng(seed)
    grid = np.mgrid[: shape[0], : shape[1], : shape[2]]
    truth = np.zeros(shape, np.uint8)
    for lab, frac in ((1, 0.3), (2, 0.55), (4, 0.75)):
        c = np.array(shape) * frac + rng.uniform(-1, 1, 3)
        r = np.array(shape) * rng.uniform(0.12, 0.18, 3)
        truth[(sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r))
               < 1) & (truth == 0)] = lab
    pred = np.roll(truth, rng.integers(-1, 2), axis=int(rng.integers(0, 3)))
    flip = rng.random(shape) < 0.01
    pred = np.where(flip, rng.choice([0, 1, 2, 4], shape), pred).astype(
        np.uint8)
    return truth, pred


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("evaluate") / "prediction"
    affine = np.diag([0.8, 0.8, 2.0, 1.0])
    for i in range(4):
        truth, pred = _blobs(i)
        if i == 2:
            pred[pred == 4] = 0     # label 4 never predicted: inf surface
        if i == 3:
            truth[:] = 0            # empty truth: the flag
            pred[:] = 0
        case = d / f"case_{i}"
        case.mkdir(parents=True)
        save_nifti(truth, str(case / "truth.nii.gz"), affine=affine)
        save_nifti(pred, str(case / "prediction.nii.gz"), affine=affine)
    served = d / "served_only"      # a serve tree's case: no truth
    served.mkdir()
    save_nifti(_blobs(9)[1], str(served / "prediction.nii.gz"),
               affine=affine)
    (d / "stray.txt").write_text("not a case")
    return d


@pytest.mark.parametrize("labels,regions,surface", [
    ([1], None, False),
    ([1, 2, 4], None, False),
    ([1, 2, 4], ["whole:1,2,4", "core:1,4"], False),
    ([1, 2, 4], ["whole:1,2,4"], True),
    ([2], None, True),
], ids=str)
def test_scores_csv_equals_the_root_evaluate(tree, tmp_path, capsys, labels,
                                             regions, surface):
    root = _load("root_evaluate", ROOT / "evaluate.py")
    want_csv, got_csv = str(tmp_path / "want.csv"), str(tmp_path / "got.csv")
    df = root.main(str(tree), labels, want_csv, plot=False,
                   surface_metrics=surface,
                   regions=root.parse_regions(regions))
    capsys.readouterr()
    rows = port_evaluate.main(str(tree), labels, got_csv, plot=False,
                              surface_metrics=surface,
                              regions=port_evaluate.parse_regions(regions))
    out = capsys.readouterr().out
    assert open(got_csv).read() == open(want_csv).read()
    assert list(rows) == list(df.index) == [f"case_{i}" for i in range(4)]
    assert "skipped 1 case(s) without truth.nii.gz" in out
    assert "wrote" in out and "(4 cases)" in out
    with open(got_csv) as f:
        table = list(csv.reader(f))
    assert table[0][0] == "" and table[0][-1] == "empty_truth"
    assert [r[-1] for r in table[1:]] == ["0", "0", "0", "1"]
    # the printed mean / std / min / max rows are pandas' describe()
    stats = port_evaluate.summarize(rows, table[0][1:])
    desc = df.describe()
    for name in ("mean", "std", "min", "max"):
        assert out.count("\n" + name) == 1
        for col in table[0][1:]:
            a, b = stats[name][col], float(desc.loc[name, col])
            assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(
                b, rel=1e-12, abs=1e-12) or (np.isinf(a) and a == b)


def test_parse_regions_equals_the_root():
    root = _load("root_evaluate_regions", ROOT / "evaluate.py")
    for specs in (None, [], ["whole:1,2,4", "core: 1, 4 "]):
        assert (port_evaluate.parse_regions(specs)
                == root.parse_regions(specs))
    for bad in (["whole"], ["whole:"], [":1"], ["a:1", "a:2"], ["a:x"],
                ["a: ,"]):
        with pytest.raises(SystemExit):
            root.parse_regions(bad)
        with pytest.raises(SystemExit):
            port_evaluate.parse_regions(bad)


def test_probability_maps_are_refused_and_empty_trees_exit(tree, tmp_path):
    case = tmp_path / "p" / "case"
    case.mkdir(parents=True)
    truth, _ = _blobs(0)
    save_nifti(truth, str(case / "truth.nii.gz"), affine=np.eye(4))
    save_nifti(np.random.default_rng(0).random(truth.shape).astype(
        np.float32), str(case / "prediction.nii.gz"), affine=np.eye(4))
    with pytest.raises(SystemExit, match="probability map"):
        port_evaluate.main(str(tmp_path / "p"), [1],
                           str(tmp_path / "s.csv"), plot=False)
    save_nifti(np.zeros(truth.shape + (3,), np.float32),
               str(case / "prediction.nii.gz"), affine=np.eye(4))
    with pytest.raises(SystemExit, match="4-D"):
        port_evaluate.main(str(tmp_path / "p"), [1],
                           str(tmp_path / "s.csv"), plot=False)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no scorable"):
        port_evaluate.main(str(tmp_path / "empty"), [1],
                           str(tmp_path / "s.csv"), plot=False)


def test_plots_are_written_or_skipped_with_a_note(tree, tmp_path, capsys,
                                                  monkeypatch):
    log = tmp_path / "training.log"
    log.write_text("epoch,loss,val_loss\n0,-0.2,-0.1\n1,-0.4,-0.3\n")
    port_evaluate.main(str(tree), [1, 2], str(tmp_path / "scores.csv"),
                       training_log=str(log), plot=True)
    assert (tmp_path / "scores_boxplot.png").stat().st_size > 0
    assert (tmp_path / "training_curves.png").stat().st_size > 0
    # where matplotlib is absent the scores are still complete
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    port_evaluate.main(str(tree), [1], str(tmp_path / "again.csv"),
                       plot=True)
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert (tmp_path / "again.csv").exists()
    assert not (tmp_path / "again_boxplot.png").exists()


@pytest.mark.parametrize("seed", range(3))
def test_surface_metrics_copy_equals_original(seed):
    truth, pred = _blobs(seed)
    spacing = (0.8, 0.8, 2.0)
    assert (port_surface.voxel_spacing_from_affine(np.diag([0.8, -0.8, 2, 1]))
            == jax_surface.voxel_spacing_from_affine(
                np.diag([0.8, -0.8, 2, 1])))
    for lab in (1, 2, 4):
        t, p = truth == lab, pred == lab
        assert (port_surface.surface_metric_pair(t, p, spacing)
                == jax_surface.surface_metric_pair(t, p, spacing))
        assert (port_surface.hausdorff95(t, p, spacing)
                == jax_surface.hausdorff95(t, p, spacing))
        assert port_surface.assd(t, p, spacing) == jax_surface.assd(
            t, p, spacing)
        for a, b in zip(port_surface.surface_distances(t, p, spacing),
                        jax_surface.surface_distances(t, p, spacing)):
            np.testing.assert_array_equal(a, b)
    empty = np.zeros_like(truth, bool)
    for t, p in ((empty, empty), (truth == 1, empty), (empty, pred == 1)):
        got = port_surface.surface_metric_pair(t, p, spacing)
        want = jax_surface.surface_metric_pair(t, p, spacing)
        assert np.array_equal(got, want, equal_nan=True)


# --- ensemble -----------------------------------------------------------------


@pytest.fixture(scope="module")
def prob_trees(tmp_path_factory):
    d = tmp_path_factory.mktemp("ensemble")
    rng = np.random.default_rng(4)
    affine = np.diag([1.0, 1.0, 2.0, 1.0])
    for tree_i in range(3):
        for case in ("a", "b"):
            case_dir = d / f"prob_{tree_i}" / case
            case_dir.mkdir(parents=True)
            prob = rng.random((10, 12, 8)).astype(np.float32)
            save_nifti(prob, str(case_dir / "prediction.nii.gz"),
                       affine=affine)
            multi = rng.dirichlet(np.ones(3), (10, 12, 8)).astype(np.float32)
            multi_dir = d / f"multi_{tree_i}" / case
            multi_dir.mkdir(parents=True)
            save_nifti(multi, str(multi_dir / "prediction.nii.gz"),
                       affine=affine)
    only = d / "prob_2" / "only_here"
    only.mkdir()
    save_nifti(rng.random((10, 12, 8)).astype(np.float32),
               str(only / "prediction.nii.gz"), affine=affine)
    return d


@pytest.mark.parametrize("kind,kw", [
    ("prob", {}),
    ("prob", {"weights": [2.0, 1.0, 0.5], "threshold": 0.4, "labels": [4],
              "save_prob": True}),
    ("multi", {"labels": [1, 2, 4], "save_prob": True}),
    ("multi", {"threshold": 0.45}),
], ids=str)
def test_ensemble_equals_the_root_tool(prob_trees, tmp_path, kind, kw):
    root = _load("root_ensemble", ROOT / "tools" / "ensemble.py")
    inputs = [str(prob_trees / f"{kind}_{i}") for i in range(3)]
    n_want = root.main(inputs, str(tmp_path / "want"), **kw)
    n_got = port_ensemble.main(inputs, str(tmp_path / "got"), **kw)
    assert n_got == n_want == 2
    for case in ("a", "b"):
        files = sorted(os.listdir(tmp_path / "want" / case))
        assert sorted(os.listdir(tmp_path / "got" / case)) == files
        assert ("probability.nii.gz" in files) == bool(kw.get("save_prob"))
        for f in files:
            got = load_nifti(str(tmp_path / "got" / case / f))
            want = load_nifti(str(tmp_path / "want" / case / f))
            np.testing.assert_array_equal(got.get_fdata(), want.get_fdata())
            np.testing.assert_array_equal(got.affine, want.affine)
            assert got.dataobj.dtype == want.dataobj.dtype
    assert not (tmp_path / "got" / "only_here").exists()


def test_ensemble_refusals_equal_the_root_tool(prob_trees, tmp_path):
    root = _load("root_ensemble_refusals", ROOT / "tools" / "ensemble.py")
    a, b, c = (str(prob_trees / f"prob_{i}") for i in range(3))
    labels = tmp_path / "labels" / "a"
    labels.mkdir(parents=True)
    save_nifti((np.random.default_rng(0).random((10, 12, 8)) > 0.5).astype(
        np.uint8), str(labels / "prediction.nii.gz"),
        affine=np.diag([1.0, 1.0, 2.0, 1.0]))
    for module in (root, port_ensemble):
        out = str(tmp_path / module.__name__)
        with pytest.raises(ValueError, match="at least two"):
            module.main([a], out)
        with pytest.raises(ValueError, match="weights for"):
            module.main([a, b], out, weights=[1.0])
        with pytest.raises(ValueError, match="positive"):
            module.main([a, b], out, weights=[1.0, 0.0])
        with pytest.raises(ValueError, match="--strict"):
            module.main([a, c], out, strict=True)
        with pytest.raises(ValueError, match="LABEL map"):
            module.main([a, str(tmp_path / "labels")], out)
        with pytest.raises(FileNotFoundError):
            module.main([a, str(tmp_path / "absent")], out)
        assert module.main([a, str(tmp_path / "labels")], out,
                           assume_prob=True) == 1


def test_ensemble_cli_parses():
    a = port_ensemble._parser().parse_args(
        ["p1", "p2", "--output", "o", "--weights", "2", "1", "--labels", "4",
         "--save-prob", "--strict", "--assume-prob"])
    assert (a.inputs, a.output, a.weights, a.labels, a.save_prob, a.strict,
            a.assume_prob) == (["p1", "p2"], "o", [2.0, 1.0], [4], True,
                               True, True)
    e = port_evaluate._parser().parse_args(
        ["--labels", "1", "2", "--regions", "w:1,2", "--surface-metrics",
         "--no-plot"])
    assert e.labels == [1, 2] and e.surface_metrics and e.no_plot
