"""Data-parallel training across processes, on the CPU with gloo.

The sampler's shard matches the JAX package's. Then one ``mp.spawn`` of two
ranks (tests/torch_parallel_worker.py) runs the training CLI over the tiny
published-layout checkpoint of tests/test_torch_checkpoint.py and toy NYU
files whose images have different valid fractions, so that the ranks'
masks count differently:

  A  one optimizer step (a global micro-batch of 2, one image a rank, 2
     accumulation steps), a `latest` checkpoint and validation at step 1;
  B  A with --zero1, then resumed from its `latest` on both ranks to step
     2, with --zero1;
  D  two steps straight, without --zero1;

and one process runs A's recipe on the global batch (P). Bars: A's loss
within 1e-6 relative of P's, its gradient and update as the test says (f32;
a rank's calls see one image where P's see two, which round otherwise);
B's first step equal to A and its resumed second equal to D's (0.0: the
same gradients through the same element-wise Adam); the ranks' own
parameters equal each other (0.0).
"""

import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml
from PIL import Image

from genpercept_tpu.data.sampler import shard_batch_indices as jax_shard
from genpercept_tpu_torch.cli import train as port_train
from genpercept_tpu_torch.data.sampler import DataLoader, shard_batch_indices
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint, load_train_checkpoint
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from torch_parallel_worker import rank_tensors, run

torch.set_num_threads(1)

HW = 64
WORLD = 2


@pytest.mark.parametrize("n,accum,world", [(8, 1, 2), (8, 2, 2), (12, 3, 2), (16, 2, 4),
                                           (12, 1, 3), (6, 3, 1)])
def test_shard_batch_indices_match_jax(n, accum, world):
    idx = list(np.random.default_rng(n + accum).permutation(100)[:n])
    for r in range(world):
        assert shard_batch_indices(idx, accum, world, r) == jax_shard(idx, accum, world, r)
    # the ranks' slices partition each accumulation chunk
    got = sorted(i for r in range(world) for i in shard_batch_indices(idx, accum, world, r))
    assert got == sorted(idx)


class Recording:
    """A dataset that records which items were loaded and which skipped."""

    def __init__(self, n):
        self.n, self.seen, self.skipped = n, [], []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.seen.append(i)
        return {"x": np.full((2,), i, np.float32)}

    def skip(self, i):
        self.skipped.append(i)


def test_shard_loader_touches_only_its_slice():
    """A rank loads its slice and passes over the rest of each global batch
    (skip), in the batch's order."""
    batches = [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15]]
    for r in range(WORLD):
        ds = Recording(16)
        out = list(DataLoader(ds, batches, shard=(r, WORLD, 2)))
        want = [shard_batch_indices(b, 2, WORLD, r) for b in batches]
        assert sorted(ds.seen) == sorted(i for w in want for i in w)
        assert ds.skipped == [i for b in batches for i in b if i not in ds.seen]
        assert [list(o["x"][:, 0].astype(int)) for o in out] == want


@pytest.mark.parametrize("accum", [1, 2])
def test_shard_loader_draws_the_flips_of_one_process(tmp_path, accum):
    """With the flip augmentation, each rank's samples are the rows of one
    process's global batch that the shard gives it, flips included: every
    rank draws the whole global batch's flips from the dataset's seeded
    stream and keeps its own (a rank that drew only for its own samples
    would repeat rank 0's flip pattern)."""
    from genpercept_tpu_torch.data import DatasetMode, get_dataset
    from genpercept_tpu_torch.data.sampler import ConcatDataset, MixedBatchSampler
    from genpercept_tpu_torch.data.transforms import get_depth_normalizer

    split = write_nyu(tmp_path, 8, 5, "train")

    def loader(shard):
        ds = get_dataset({"name": "nyu_v2", "dir": "nyu", "filenames": split,
                          "eigen_valid_mask": False}, str(tmp_path), DatasetMode.TRAIN,
                         depth_transform=get_depth_normalizer(
                             {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
                              "norm_max": 1.0, "min_max_quantile": 0.02}),
                         augmentation_args={"lr_flip_p": 0.5})
        sampler = MixedBatchSampler([ds], batch_size=4, generator=np.random.default_rng(1))
        return list(DataLoader(ConcatDataset([ds]), sampler, shard=shard))

    one = loader(None)
    flips = 0
    for r in range(WORLD):
        ranks = loader((r, WORLD, accum))
        assert len(ranks) == len(one) == 2
        for g, b in zip(one, ranks):
            rows = _shard_rows(4, accum, WORLD, r)
            for k in ("rgb_norm", "depth_raw_norm", "valid_mask_raw"):
                np.testing.assert_array_equal(b[k], g[k][rows], err_msg=k)
    # the stream flips some samples and not others
    for g in one:
        raw = g["rgb_norm"]
        flips += sum(not np.array_equal(x, x[:, ::-1]) for x in raw)
    assert flips > 0


def _shard_rows(n, accum, world, rank):
    return shard_batch_indices(list(range(n)), accum, world, rank)


# --------------------------------------------------------- two ranks


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_nyu(root, n, seed, name):
    """n rgb / depth (mm) PNGs and their split file; image i has an invalid
    block of its own size, so each image's valid fraction differs."""
    rng = np.random.default_rng(seed)
    d = root / "nyu"
    d.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        stem = f"{name}_{i}"
        Image.fromarray(rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)).save(
            d / f"rgb_{stem}.png")
        depth = rng.integers(500, 9000, (HW, HW)).astype(np.uint16)
        depth[:8 + 7 * i, :12 + 5 * i] = 0
        Image.fromarray(depth).save(d / f"depth_{stem}.png")
        lines.append(f"rgb_{stem}.png depth_{stem}.png depth_{stem}.png")
    (root / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return str(root / f"{name}.txt")


def recipe(root, max_iter: int, micro: int = 1) -> str:
    """An effective batch of 4 in micro-batches of ``micro`` a process; f32,
    f32 moments, no augmentation (a dataset draws its flips per sample it
    loads, so a rank's flips are not the single process's), no warmup (the
    first update moves), the mse and gradient losses (the least-squares SSI
    loss's gradient at random weights is ill-conditioned: a 1e-7 change of
    the forward moves it by 5e-5), a `latest` and validation every step."""
    cfg = {
        "mode": "depth",
        "pipeline": {"name": "GenPerceptPipeline", "kwargs": {"mode": "depth"}},
        "depth_normalization": {"type": "scale_shift_depth", "clip": True, "norm_min": -1.0,
                                "norm_max": 1.0, "min_max_quantile": 0.02},
        "dataloader": {"effective_batch_size": 4, "max_train_batch_size": micro},
        "dataset": {"train": {"name": "nyu_v2", "dir": "nyu", "filenames": root["train"],
                              "eigen_valid_mask": False},
                    "val": [{"name": "nyu_v2", "dir": "nyu", "filenames": root["val"],
                             "eigen_valid_mask": False}]},
        "trainer": {"init_seed": 7, "save_period": 1, "validation_period": 1,
                    "visualization_period": 0},
        "max_iter": max_iter,
        "loss": {"customized_loss": True, "name": ["mse_loss", "grad_loss"]},
        "lr": 1e-4,
        "lr_scheduler": {"name": "IterExponential",
                         "kwargs": {"total_iter_length": 100, "final_ratio": 0.01,
                                    "warmup_steps": 0}},
        "model": {"remat_unet": False},
    }
    path = root["dir"] / f"recipe_{max_iter}_{micro}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def ranks(ckpts, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("parallel")
    data = {"dir": root, "train": write_nyu(root, 8, 80, "train"),
            "val": write_nyu(root, 2, 81, "val")}
    ckpt = str(ckpts["plain"][0])

    def argv(name, steps, *extra, micro=1):
        return ["--config", recipe(data, steps, micro), "--checkpoint", ckpt,
                "--base_data_dir", str(root), "--output_dir", str(root / name), *extra]

    jobs = [(argv("A", 1), free_port()), (argv("B", 1, "--zero1"), free_port()),
            (argv("B", 2, "--zero1", "--resume_run", "latest"), free_port()),
            (argv("D", 2), free_port())]
    mp.spawn(run, args=(WORLD, jobs, (free_port(), str(root / "reduced"))), nprocs=WORLD,
             join=True)
    # one process, the same global micro-batch: both ranks' images at once
    port_train.main(argv("P", 1, "--device", "cpu", micro=WORLD))
    init = {f"unet.{k}": v for k, v in load_genpercept_checkpoint(
        ckpt, device="cpu").unet.state_dict().items()}
    return root, init


def metrics(run_dir) -> list:
    return [yaml.safe_load(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def values(run_dir, tag) -> list:
    return [(r["step"], r[tag]) for r in metrics(run_dir) if tag in r]


def state(run_dir, name="final"):
    return load_train_checkpoint(str(run_dir / "checkpoint"), name)["trainable"]


def rel_l2(a: dict, b: dict, keys) -> float:
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in keys)
    den = sum(float(b[k].double().pow(2).sum()) for k in keys)
    assert den > 0
    return (num / den) ** 0.5


def test_two_ranks_equal_one_process_on_the_global_batch(ranks):
    """A (two ranks, unequal masks) against P (one process, both images of
    each micro-step).

    The loss and each term to 1e-6 relative (read 7.6e-8): the reduction
    over the global batch is exact, where DDP's average of the ranks' own
    means would weigh the ranks' pixels by their own mask counts.

    The gradient, Adam's first moment after one step (0.1 g), to 1e-4
    global relative L2 (read 3.7e-5): a call on one image rounds in f32
    otherwise than a call on two (the CPU's blocking follows the batch),
    ~1e-7 of the UNet's output, which the random-weight UNet's backward
    amplifies; the same gradient computed in one process image by image
    with the global counts differs from the batched one by the same
    3.7e-5. The update to 1e-2 relative L2 (read 3.3e-3): Adam's first step
    is lr g / (|g| + eps), so the 7e-4 of the elements whose gradient is
    within that noise of 0 move by up to 2 lr. Both over the parameters
    whose first moment reaches 1e-6 of the largest (a bias before a
    GroupNorm, which takes out its shift, has a gradient of rounding noise
    alone), as tests/test_torch_train_cli.py holds its update."""
    root, init = ranks
    for tag in ("train/loss", "train/mse", "train/grad"):
        (sa, a), = values(root / "A", tag)
        (sp, p), = values(root / "P", tag)
        assert sa == sp == 1
        np.testing.assert_allclose(a, p, rtol=1e-6, err_msg=tag)
    sa = load_train_checkpoint(str(root / "A" / "checkpoint"), "final")
    sp = load_train_checkpoint(str(root / "P" / "checkpoint"), "final")
    a, p = sa["trainable"], sp["trainable"]
    assert set(a) == set(p) == set(init)
    names = list(a)
    mu_a = {names[i]: st["mu"] for i, st in sa["opt_state"]["state"].items()}
    mu_p = {names[i]: st["mu"] for i, st in sp["opt_state"]["state"].items()}
    top = max(float(v.abs().max()) for v in mu_p.values())
    keep = [k for k in names if float(mu_p[k].abs().max()) >= 1e-6 * top]
    assert len(keep) > 0.9 * len(names)
    assert rel_l2(mu_a, mu_p, keep) <= 1e-4
    upd_a = {k: a[k] - init[k] for k in keep}
    upd_p = {k: p[k] - init[k] for k in keep}
    assert rel_l2(upd_a, upd_p, keep) <= 1e-2


def rank_params(run_dir, r, job):
    return torch.load(run_dir / f"rank{r}_job{job}.pt")


def test_ranks_hold_equal_parameters(ranks):
    root, _ = ranks
    for run_dir, job in (("A", 0), ("B", 1), ("B", 2), ("D", 3)):
        r0, r1 = rank_params(root / run_dir, 0, job), rank_params(root / run_dir, 1, job)
        for k in r0:
            assert torch.equal(r0[k], r1[k]), (run_dir, k)


def test_zero1_equals_plain_data_parallel(ranks):
    """B's first step (--zero1) equals A's; its checkpoint holds the whole
    consolidated Adam state (a moment for every parameter) and its count."""
    root, _ = ranks
    a, b = state(root / "A"), rank_params(root / "B", 0, 1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    opt = load_train_checkpoint(str(root / "B" / "checkpoint"), "final")["opt_state"]
    assert len(opt["state"]) == len(a)
    assert all(st["mu"].shape == a[k].shape for st, k in zip(opt["state"].values(), a))
    assert [g["count"] for g in opt["param_groups"]] == [2]


def test_resume_on_both_ranks_equals_straight(ranks):
    """B resumed from `latest` on both ranks (ZeRO-1 state read by each)
    to step 2 equals D's two straight steps, on each rank."""
    root, _ = ranks
    d = state(root / "D")
    for r in range(WORLD):
        b = rank_params(root / "B", r, 2)
        for k in d:
            assert torch.equal(b[k], d[k]), (r, k)
    assert "resumed at iter 1" in (root / "B" / "logging.log").read_text()
    (_, lb), = [v for v in values(root / "B", "train/loss") if v[0] == 2]
    (_, ld), = [v for v in values(root / "D", "train/loss") if v[0] == 2]
    assert lb == ld


def test_rank0_writes_the_run_directory_and_validates(ranks):
    """One writer: config.yaml, the code snapshot, metrics.jsonl (one record
    per step, and validation at each step, on rank 0), logging.log with
    rank 0's lines only, the checkpoints."""
    root, _ = ranks
    a = root / "A"
    for f in ("config.yaml", "code_snapshot.tar.gz", "metrics.jsonl", "logging.log",
              "checkpoint/final/state.pt", "checkpoint/latest/state.pt"):
        assert (a / f).is_file(), f
    assert [s for s, _ in values(a, "train/loss")] == [1]
    assert [s for s, _ in values(a, "val/nyu_v2/abs_relative_difference")] == [1]
    log = (a / "logging.log").read_text()
    assert "rank=0/2" in log and "rank=1/2" not in log
    assert [s for s, _ in values(root / "D", "train/loss")] == [1, 2]


def test_bucketed_gradient_sum_equals_the_sum_of_each_tensor(ranks):
    """all_reduce_sum_ in buckets of 64 bytes (several tensors a bucket, a
    larger one alone, a new bucket at each dtype change): every tensor on
    every rank is the sum of the ranks' tensors, exactly (small integers)."""
    root, _ = ranks
    want = [sum(ts) for ts in zip(*(rank_tensors(r) for r in range(WORLD)))]
    for r in range(WORLD):
        got = torch.load(root / f"reduced.rank{r}.pt")
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_train_cli_refuses_data_parallel_beyond_its_processes(ckpts, tmp_path):  # noqa: F811
    """--data_parallel N needs N processes: one process never runs it."""
    with pytest.raises(ValueError, match="one process per data-parallel rank"):
        port_train.main(["--config", "unused.yaml", "--checkpoint", str(ckpts["plain"][0]),
                         "--output_dir", str(tmp_path / "out"), "--device", "cpu",
                         "--data_parallel", "2"])
    assert not (tmp_path / "out").exists()


# ------------------------------------------------ data-parallel inference


def tiny_models(seed=0):
    from genpercept_tpu_torch.models import (AutoencoderKL, UNet2DConditionModel, UNetConfig,
                                             VAEConfig, init_params_)
    from genpercept_tpu_torch.pipeline import GenPerceptModels
    from test_torch_pipeline import TINY_UNET, TINY_VAE

    gen = torch.Generator().manual_seed(seed)
    unet, vae = UNet2DConditionModel(UNetConfig(**TINY_UNET)), AutoencoderKL(VAEConfig(**TINY_VAE))
    init_params_(unet, gen)
    init_params_(vae, gen)
    embed = torch.randn((1, 77, 48), generator=gen)
    return GenPerceptModels(unet=unet, vae=vae, text_embed=embed)


def images(n, seed=3):
    from genpercept_tpu_torch.utils.synthetic import natural_like_images

    return list(natural_like_images(seed, n, 64))


def test_pipeline_data_parallel_splits_and_pads():
    """Two CPU replicas: a batch of 3 is padded to 4, split 2 + 2 and the pad
    dropped; the predictions equal one device's within 1e-5 of the depth
    range (a replica's call sees 2 images where one device's sees 3)."""
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    cfg = PipelineConfig(mode="depth", processing_res=64)
    one = GenPerceptPipeline(tiny_models(), cfg, device="cpu")
    two = GenPerceptPipeline(tiny_models(), cfg, devices=["cpu", "cpu"])
    assert two.n_devices == 2 and two.replicas[1].unet is not two.models.unet
    imgs = images(3)
    for a, b in zip(one.batch(imgs, batch_size=3), two.batch(imgs, batch_size=3)):
        np.testing.assert_allclose(a.pred_np, b.pred_np, rtol=0, atol=1e-5)


@pytest.mark.parametrize("asymmetric,refine", [(False, False), (True, True)])
def test_pipeline_data_parallel_int8_calibrates_once_for_all(asymmetric, refine):
    """int8 over two CPU replicas: the first batch of 4 calibrates in the
    one-device chunks (4, or 2 with asymmetric stats), a chunk a replica at
    once, merged in order, so the tree (codes, scales, zero points and the
    bias correction's biases) equals one device's on the same images; every
    replica runs that one tree (copied to each device), and a single-device
    pipeline on it gives the same depth within 1e-5."""
    from genpercept_tpu_torch.ops import quant as tq
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    cfg = PipelineConfig(mode="depth", processing_res=64, int8_vae=True, int8_unet=True,
                         int8_unet_ff=True, int8_refine=refine, int8_asymmetric=asymmetric)
    two = GenPerceptPipeline(tiny_models(), cfg, devices=["cpu", "cpu"])
    chunks, replica_calls = [], []
    real, second = tq.calibrate_chunked, two._replica_calib_infers[0]
    two._replica_calib_infers[0] = lambda *a: replica_calls.append(a[0].shape[0]) or second(*a)
    try:
        tq.calibrate_chunked = lambda *a, chunk: chunks.append(chunk) or real(*a, chunk=chunk)
        first = two.batch(images(4), batch_size=4)
    finally:
        tq.calibrate_chunked = real
    chunk = 2 if asymmetric else 4
    assert chunks == [chunk] and two.int8_mean_dev is not None
    assert replica_calls == ([2] if asymmetric else [])
    one = GenPerceptPipeline(tiny_models(), cfg, device="cpu")
    one.batch(images(4), batch_size=4)
    assert set(one.vae_quant) == set(two.vae_quant)
    for g, tree in one.vae_quant.items():
        assert set(tree) == set(two.vae_quant[g])
        for k, q in tree.items():
            r = two.vae_quant[g][k]
            for f in ("w_int8", "inv_a", "o_scale", "bias", "zp"):
                x, y = getattr(q, f), getattr(r, f)
                assert (x is None and y is None) or torch.equal(x, y), (g, k, f)
    a, b = two._vq_copies
    assert a is two.vae_quant and set(a) == set(b) == {"enc", "dec", "unet"}
    for g in a:
        for k, q in a[g].items():
            assert torch.equal(q.w_int8, b[g][k].w_int8)
    one = GenPerceptPipeline(tiny_models(), cfg, device="cpu")
    one._set_quant(two.vae_quant)
    imgs = images(3, seed=4)
    for x, y in zip(one.batch(imgs, batch_size=3), two.batch(imgs, batch_size=3)):
        np.testing.assert_allclose(x.pred_np, y.pred_np, rtol=0, atol=1e-5)
    assert len(first) == 4


def test_evaluate_dataset_data_parallel_equals_one_device():
    """evaluate_dataset(devices=[cpu, cpu]) against one device: every metric
    within 1e-5 relative (the forward split between two replicas, the
    metrics over the whole batch)."""
    from genpercept_tpu_torch.eval.harness import evaluate_dataset
    from test_torch_eval_cli import ToyEval

    ds = ToyEval()
    ref = evaluate_dataset(tiny_models(), ds, batch_size=2, processing_res=0,
                           dtype=torch.float32, device="cpu")
    ours = evaluate_dataset(tiny_models(), ds, batch_size=2, processing_res=0,
                            dtype=torch.float32, devices=["cpu", "cpu"])
    assert list(ours) == list(ref)
    np.testing.assert_allclose([ours[k] for k in ref], [ref[k] for k in ref], rtol=1e-5)
