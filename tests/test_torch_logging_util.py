"""The port's logging helpers held to the JAX package's: the cases of
tests/test_utils.py (the metrics logger, the wandb helpers without wandb and
with a stub of it) run against both, and config_logging's file."""

import json
import logging
import sys
import types

import pytest

from genpercept_tpu.utils import logging_util as jlu
from genpercept_tpu_torch.utils import logging_util as tlu

BOTH = pytest.mark.parametrize("lu", [jlu, tlu], ids=["jax", "port"])


def jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@BOTH
def test_metrics_logger(lu, tmp_path):
    ml = lu.MetricsLogger(str(tmp_path), enable_tensorboard=False)
    ml.log_scalar("train/loss", 1.5, 1)
    ml.log_dict({"a": 2.0}, 2, prefix="val/")
    ml.close()
    lines = jsonl(tmp_path / "metrics.jsonl")
    assert [{k: v for k, v in r.items() if k != "t"} for r in lines] == [
        {"step": 1, "train/loss": 1.5}, {"step": 2, "val/a": 2.0}]
    assert not (tmp_path / "tensorboard").exists()
    text = lu.eval_dic_to_text({"abs_rel": 0.05}, "nyu", "split.txt")
    assert text == jlu.eval_dic_to_text({"abs_rel": 0.05}, "nyu", "split.txt")


def test_metrics_logger_mirrors_to_tensorboard(tmp_path):
    """With tensorboard importable both write an event file beside the JSONL."""
    pytest.importorskip("tensorboard")
    for lu, sub in ((jlu, "jax"), (tlu, "port")):
        ml = lu.MetricsLogger(str(tmp_path / sub))
        ml.log_scalar("train/loss", 1.5, 1)
        ml.close()
        assert list((tmp_path / sub / "tensorboard").glob("events.out.tfevents.*"))


def test_metrics_logger_without_tensorboard(tmp_path, monkeypatch):
    """Without the package the port keeps the JSONL stream alone."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    ml = tlu.MetricsLogger(str(tmp_path))
    ml.log_scalar("x", 3.0, 7)
    ml.close()
    assert jsonl(tmp_path / "metrics.jsonl")[0]["x"] == 3.0
    assert not (tmp_path / "tensorboard").exists()


@BOTH
def test_wandb_helpers_without_wandb(lu, tmp_path, monkeypatch):
    """Without the wandb package init returns None; WANDB_ID round-trips for
    resume; the SLURM job id goes through the metrics logger (-1 outside
    SLURM)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert lu.init_wandb(True, project="x") is None
    assert lu.init_wandb(False) is None
    lu.save_wandb_job_id(None, str(tmp_path))
    assert lu.load_wandb_job_id(str(tmp_path)) is None
    lu.save_wandb_job_id(types.SimpleNamespace(id="abc123"), str(tmp_path))
    assert lu.load_wandb_job_id(str(tmp_path)) == "abc123"
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    ml = lu.MetricsLogger(str(tmp_path), enable_tensorboard=False)
    lu.log_slurm_job_id(ml, step=3)
    monkeypatch.setenv("SLURM_JOB_ID", "42")
    lu.log_slurm_job_id(ml, step=4)
    ml.close()
    recs = jsonl(tmp_path / "metrics.jsonl")
    assert [(r["job_id"], r["step"]) for r in recs] == [(-1, 3), (42, 4)]


@BOTH
def test_wandb_helpers_with_a_stub(lu, tmp_path, monkeypatch):
    """With wandb present: an enabled run syncs tensorboard and takes the
    caller's arguments, a disabled one is made in mode "disabled"."""
    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(kw) or types.SimpleNamespace(id=f"run{len(calls)}")
    monkeypatch.setitem(sys.modules, "wandb", stub)
    run = lu.init_wandb(True, project="genpercept_tpu", dir=str(tmp_path), resume="allow")
    assert run.id == "run1"
    assert lu.init_wandb(False).id == "run2"
    assert calls == [{"sync_tensorboard": True, "project": "genpercept_tpu",
                      "dir": str(tmp_path), "resume": "allow"}, {"mode": "disabled"}]


@BOTH
def test_config_logging_writes_the_log_file(lu, tmp_path):
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        lu.config_logging({"level": "warning"}, out_dir=str(tmp_path / "run"))
        assert root.level == logging.WARNING
        logging.getLogger("genpercept").warning("hello from the port's logger")
        logging.getLogger("genpercept").info("below the level")
        for h in root.handlers:
            h.flush()
        text = (tmp_path / "run" / "logging.log").read_text()
        assert "WARNING - genpercept - hello from the port's logger" in text
        assert "below the level" not in text
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
