"""The port's eval CLI and batched harness held to the JAX package's.

- ``cli/eval.py`` in both packages over one toy NYU dataset (the split's
  first three paths as synthetic 480x640 PNGs in a tar, as
  tests/test_torch_infer_cli.py writes them) and one set of .npy
  predictions from a numpy seed, in every alignment.
- The infer -> eval chain of each package on the tiny published-layout
  checkpoint of tests/test_torch_checkpoint.py.
- ``eval/harness.py::evaluate_dataset`` of each package on tiny models in
  f32, batch 2 with a smaller final batch.
The port runs on the CPU (``--device cpu`` / ``device="cpu"``). Tolerances
are stated beside each test.
"""

import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from genpercept_tpu.cli import eval as jax_eval
from genpercept_tpu.cli import infer as jax_infer
from genpercept_tpu.eval.harness import evaluate_dataset as jax_evaluate
from genpercept_tpu_torch.cli import eval as port_eval
from genpercept_tpu_torch.cli import infer as port_infer
from genpercept_tpu_torch.data import DatasetMode, get_dataset, get_pred_name
from genpercept_tpu_torch.eval.harness import evaluate_dataset
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_infer_cli import argv as infer_argv
from test_torch_infer_cli import nyu_layout
from test_torch_train import port_models, tiny  # noqa: F401  (module-scoped fixture)

torch.set_num_threads(1)

ALIGNMENTS = ("least_square", "least_square_disparity", "none")
# JAX's silog_rmse squares an int32 count of valid pixels, which wraps past
# 46340 of them (NYU's eval crop holds 238k): it read 0 where float64 reads
# 150.4, and 60.3 where it reads 71.7. The port
# counts in int64; at 480x640 its silog is held to float64 instead.
JAX_SILOG_WRAPS = "silog_rmse"


@pytest.fixture(scope="module")
def nyu(tmp_path_factory):
    """(root, yaml) of the toy NYU test set at 480x640, and the dataset."""
    root = tmp_path_factory.mktemp("nyu")
    cfg = nyu_layout(root, hw=(480, 640))
    ds = get_dataset(yaml.safe_load(cfg.read_text())["dataset"], str(root), DatasetMode.EVAL)
    return root, cfg, ds


def pred_paths(ds) -> list:
    return [str(Path(p[0]).parent / get_pred_name(Path(p[0]).name, ds.name_mode, ".npy"))
            for p in ds.filenames]


@pytest.fixture(scope="module")
def preds(nyu, tmp_path_factory):
    """Predictions in cli/infer.py's layout: an affine map of a noisy inverse
    of each GT in [0, 1] (as a depth model's), with a few zeros so that the
    disparity alignment's pred > 0 mask bites."""
    root, _, ds = nyu
    out = tmp_path_factory.mktemp("preds")
    rng = np.random.default_rng(31)
    for i, rel in enumerate(pred_paths(ds)):
        gt = ds[i]["depth_raw_linear"]
        p = 1.0 / np.maximum(gt, 0.5) * rng.uniform(0.8, 1.2, gt.shape)
        p = (p - p.min()) / (p.max() - p.min())
        p[rng.uniform(size=gt.shape) < 0.01] = 0.0
        (out / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(out / rel, p.astype(np.float32))
    return out


def eval_argv(nyu, pred_dir, out, alignment, *extra):
    root, cfg, _ = nyu
    return ["--dataset_config", str(cfg), "--base_data_dir", str(root), "--prediction_dir",
            str(pred_dir), "--output_dir", str(out), "--alignment", alignment, *extra]


def metrics_f64(pred, gt, valid) -> dict:
    """The 10 metrics of one image in float64 numpy."""
    p, g = pred[valid].astype(np.float64), gt[valid].astype(np.float64)
    d = np.log(p) - np.log(g)
    ratio = np.maximum(p / g, g / p)
    return {"abs_relative_difference": np.mean(np.abs(p - g) / g),
            "squared_relative_difference": np.mean((p - g) ** 2 / g),
            "rmse_linear": np.sqrt(np.mean((p - g) ** 2)), "rmse_log": np.sqrt(np.mean(d**2)),
            "log10": np.mean(np.abs(np.log10(p) - np.log10(g))),
            "delta1_acc": np.mean(ratio < 1.25), "delta2_acc": np.mean(ratio < 1.25**2),
            "delta3_acc": np.mean(ratio < 1.25**3),
            "i_rmse": np.sqrt(np.mean((1 / p - 1 / g) ** 2)),
            "silog_rmse": np.sqrt(max(np.mean(d**2) - np.mean(d) ** 2, 0.0)) * 100}


def summary_f64(ds, pred_dir, alignment) -> dict:
    """cli/eval.py's protocol with the metrics in float64 (the alignment is
    the numpy one both packages share)."""
    from genpercept_tpu_torch.eval import align_depth_least_square, depth2disparity

    rows = []
    for i, rel in enumerate(pred_paths(ds)):
        item = ds[i]
        gt = np.asarray(item["depth_raw_linear"], np.float64)
        valid = item["valid_mask_raw"].astype(bool)
        pred = np.load(pred_dir / rel)
        if alignment == "least_square":
            pred, _, _ = align_depth_least_square(gt, pred, valid)
        elif alignment == "least_square_disparity":
            gt_disp, nonneg = depth2disparity(gt, return_mask=True)
            disp, _, _ = align_depth_least_square(gt_disp, pred, valid & nonneg & (pred > 0))
            pred = depth2disparity(np.clip(disp, 1e-3, None))
        pred = np.clip(np.clip(pred, ds.min_depth, ds.max_depth), 1e-6, None)
        rows.append(metrics_f64(pred.astype(np.float32), gt.astype(np.float32), valid))
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


def read_csv(path: Path) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("extra", [[], ["--alignment_max_res", "320"]], ids=["full", "max_res"])
@pytest.mark.parametrize("alignment", ALIGNMENTS)
def test_eval_cli_matches_jax(nyu, preds, tmp_path, alignment, extra):
    """Summaries to 1e-6 relative of JAX's (the same float64 alignment;
    each metric's f32 sums in another order) but silog, and every metric
    to 1e-5 relative of float64 (the delta fractions to 5e-4 absolute:
    with disparity alignment many predictions clip to exactly 10 m, and
    against a GT of 6.4 m their ratio is 1.5625 = 1.25^2 in float64 and
    either side of it in f32; reading 1.1e-4; silog to 1e-4: its
    mean(d^2) - mean(d)^2 cancels in f32, reading 3.9e-5); the CSV's rows name the same samples in the
    same order with the same metrics, each to 1e-6 of JAX's; the summary
    file's header equal and its values as the summary."""
    ref = jax_eval.main(eval_argv(nyu, preds, tmp_path / "jax", alignment, *extra))
    ours = port_eval.main(eval_argv(nyu, preds, tmp_path / "port", alignment, *extra,
                                    "--device", "cpu"))
    assert list(ours) == list(ref)
    keys = [k for k in ref if k != JAX_SILOG_WRAPS]
    np.testing.assert_allclose([ours[k] for k in keys], [ref[k] for k in keys], rtol=1e-6)
    if not extra:
        want = summary_f64(nyu[2], preds, alignment)
        for k, v in want.items():
            tol = (dict(atol=5e-4) if k.startswith("delta")
                   else dict(rtol=1e-4) if k == "silog_rmse" else dict(rtol=1e-5))
            np.testing.assert_allclose(ours[k], v, **tol, err_msg=k)
    rows, ref_rows = (read_csv(tmp_path / d / "per_sample_metrics.csv") for d in ("port", "jax"))
    assert [r["sample"] for r in rows] == [r["sample"] for r in ref_rows] == pred_paths(nyu[2])
    assert list(rows[0]) == list(ref_rows[0])
    for r, q in zip(rows, ref_rows):
        np.testing.assert_allclose([float(r[k]) for k in keys], [float(q[k]) for k in keys],
                                   rtol=1e-6)
    text, ref_text = ((tmp_path / d / "eval_metrics.txt").read_text().splitlines()
                      for d in ("port", "jax"))
    assert text[:2] == ref_text[:2]
    np.testing.assert_allclose([float(x) for x in text[2].split("|")], list(ours.values()),
                               atol=1e-6)


def test_eval_cli_checks_shapes_and_skips_missing(nyu, preds, tmp_path):
    """A prediction of another shape raises, as JAX's; a missing one is
    skipped with a warning (both packages: one row fewer)."""
    names = pred_paths(nyu[2])
    bad = tmp_path / "bad"
    for rel in names:
        (bad / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(bad / rel, np.load(preds / rel))
    np.save(bad / names[1], np.zeros((48, 64), np.float32))
    for main, extra in ((jax_eval.main, []), (port_eval.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="shape mismatch"):
            main(eval_argv(nyu, bad, tmp_path / "out", "least_square", *extra))
    (bad / names[1]).unlink()
    for main, sub, extra in ((jax_eval.main, "j", []), (port_eval.main, "p", ["--no_cuda"])):
        main(eval_argv(nyu, bad, tmp_path / sub, "least_square", *extra))
        assert [r["sample"] for r in read_csv(tmp_path / sub / "per_sample_metrics.csv")] \
            == [names[0], names[2]]


def test_eval_cli_flags_mirror_jax_and_default_to_the_card(nyu, preds, tmp_path, monkeypatch):
    ours = {a.dest: a.default for a in port_eval.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_eval.build_parser()._actions}
    assert set(ours) == set(ref) | {"device"} and ours["device"] == "cuda"
    assert {k: ours[k] for k in ref} == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--no_cuda"):
        port_eval.main(eval_argv(nyu, preds, tmp_path / "out", "least_square"))
    assert not (tmp_path / "out").exists()
    a = port_eval.main(eval_argv(nyu, preds, tmp_path / "a", "least_square", "--no_cuda"))
    b = port_eval.main(eval_argv(nyu, preds, tmp_path / "b", "least_square", "--device", "cpu"))
    assert a == b


# ------------------------------------------------------- infer -> eval chain

CHAIN_RTOL = 1e-3


@pytest.fixture(scope="module")
def chain_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    return root, nyu_layout(root)  # 48x64: the infer CLI tests' images


@pytest.mark.parametrize("alignment", ["least_square", "least_square_disparity"])
def test_infer_eval_chain_matches_jax(ckpts, chain_data, tmp_path, alignment):  # noqa: F811
    """JAX's infer -> eval and the port's on the tiny checkpoint: the npy
    within the pipeline tests' bar (mean abs 1e-4), every metric within
    CHAIN_RTOL relative (lstsq-aligned metrics of predictions within that
    bar; no delta threshold sits that close to a pixel here)."""
    ckpt = ckpts["plain"][0]
    summaries = []
    for name, infer, ev, extra in (("jax", jax_infer.main, jax_eval.main, []),
                                   ("port", port_infer.main, port_eval.main,
                                    ["--device", "cpu"])):
        infer(infer_argv(ckpt, chain_data, tmp_path / f"pred_{name}", *extra))
        root, cfg = chain_data
        summaries.append(ev(["--dataset_config", str(cfg), "--base_data_dir", str(root),
                             "--prediction_dir", str(tmp_path / f"pred_{name}"),
                             "--output_dir", str(tmp_path / f"eval_{name}"),
                             "--alignment", alignment, *extra]))
    for f in sorted(p.relative_to(tmp_path / "pred_jax")
                    for p in (tmp_path / "pred_jax").rglob("*.npy")):
        a, b = np.load(tmp_path / "pred_port" / f), np.load(tmp_path / "pred_jax" / f)
        assert float(np.mean(np.abs(a - b))) <= 1e-4
    ref, ours = summaries
    assert list(ours) == list(ref)
    np.testing.assert_allclose([ours[k] for k in ref], [ref[k] for k in ref], rtol=CHAIN_RTOL)


# --------------------------------------------------------------- the harness


class ToyEval:
    """Fixed-size eval items from a numpy seed (tests/test_harness.py's
    FakeDataset): rgb in [-1, 1], metric depth in [1, 9], an invalid block."""

    min_depth = 1e-3
    max_depth = 10.0

    def __init__(self, n=5, hw=64):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            valid = np.ones((hw, hw), bool)
            valid[:8, :16] = False
            self.items.append({
                "rgb_norm": rng.uniform(-1, 1, (hw, hw, 3)).astype(np.float32),
                "depth_raw_linear": rng.uniform(1, 9, (hw, hw)).astype(np.float32),
                "valid_mask_raw": valid})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("alignment", ["least_square", "least_square_disparity"])
def test_evaluate_dataset_matches_jax(tiny, alignment):  # noqa: F811
    """f32, batch 2 over 5 items (2 + 2 + 1): every metric within CHAIN_RTOL
    relative of JAX's (predictions within the pipeline's 1e-4 mean bar,
    then the same f32 closed form); the batches weighted by their size."""
    ds = ToyEval()
    ref = jax_evaluate(tiny[0], ds, batch_size=2, processing_res=0, dtype=jnp.float32,
                       alignment=alignment)
    ours = evaluate_dataset(port_models(tiny), ds, batch_size=2, processing_res=0,
                            dtype=torch.float32, alignment=alignment, device="cpu")
    assert list(ours) == list(ref)
    np.testing.assert_allclose([ours[k] for k in ref], [float(ref[k]) for k in ref],
                               rtol=CHAIN_RTOL)
    # the weighting: the batches of 2, 2 and 1 weighted by their size give
    # the per-item average (1e-5: the same per-item arithmetic, f32 sums);
    # not silog, whose batch value is the root of the batch's mean variance
    singles = evaluate_dataset(port_models(tiny), ds, batch_size=1, dtype=torch.float32,
                               alignment=alignment, device="cpu")
    keys = [k for k in ours if k != "silog_rmse"]
    np.testing.assert_allclose([ours[k] for k in keys], [singles[k] for k in keys], rtol=1e-5)


def test_evaluate_dataset_refuses_a_hidden_device(tiny, monkeypatch):  # noqa: F811
    """The default device is the card: without one it raises; CPU-resident
    models asked for the card raise too."""
    models = port_models(tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        evaluate_dataset(models, ToyEval(n=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="cuda"):
        evaluate_dataset(models, ToyEval(n=1))
