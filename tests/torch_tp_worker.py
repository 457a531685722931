"""Ranks of tests/test_torch_tensor_parallel.py's tensor-parallel runs.

Imports torch and the port only, so that a spawned rank starts in seconds.
``ranks`` runs, on gloo over the CPU: f and g on rank-dependent tensors
(``fg``), one training step of the tiny models per configuration with the
UNet split over the model group (``steps``; ``run_step`` is the same step
in one process, which the test calls), then the training CLI's jobs
(``tests/torch_parallel_worker.py::run``). Each writes
<out>.rank<r>.pt files for the test to compare.
"""

import datetime

import torch

import torch_parallel_worker


def _group(rank: int, world: int, port: int, model_parallel: int) -> None:
    from genpercept_tpu_torch import parallel

    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank,
                                         timeout=datetime.timedelta(seconds=120))
    parallel.set_model_parallel(model_parallel)


def fg(rank: int, world: int, port: int, out: str) -> None:
    """f and g over a model group of every rank: g's forward sums the
    ranks' parts (rank-dependent small integers) and adds the bias once,
    its backward passes the gradient as it is; f's forward passes x as it
    is, its backward sums the ranks' gradients."""
    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.parallel import tensor as TP

    _group(rank, world, port, world)
    x = torch.arange(6.0).reshape(2, 3).mul(rank + 1).requires_grad_(True)
    bias = torch.tensor([1.0, 2.0, 3.0])
    y = TP.reduce_from_model([x], bias)
    y.backward(torch.full_like(y, 2.0))
    g_grad = x.grad.clone()
    x.grad = None
    z = TP.copy_to_model(x)
    (z * (rank + 1)).sum().backward()
    torch.save({"y": y.detach(), "g_grad": g_grad, "z": z.detach(), "f_grad": x.grad},
               f"{out}.rank{rank}.pt")
    parallel.shutdown()


def load_models(path: str, dtype=torch.float32):
    """The tiny models of the test's file: configs and state dicts."""
    from genpercept_tpu_torch.models import (AutoencoderKL, UNet2DConditionModel, UNetConfig,
                                             VAEConfig)
    from genpercept_tpu_torch.pipeline import GenPerceptModels

    saved = torch.load(path, weights_only=False)
    unet = UNet2DConditionModel(UNetConfig(**saved["unet_cfg"]))
    unet.load_state_dict(saved["unet"])
    vae = AutoencoderKL(VAEConfig(**saved["vae_cfg"]))
    vae.load_state_dict(saved["vae"])
    return GenPerceptModels(unet=unet.to(dtype), vae=vae.to(dtype),
                            text_embed=saved["embed"].to(dtype))


def run_step(models_path: str, cfg_kw: dict, batch: dict, dtype=torch.float32) -> dict:
    """One optimizer step of the tiny models (on this process's model group
    when one is set: the UNet split over it). Returns the loss and aux, the
    gradients after the reduction and the updated trainable parameters, in
    the one-process layout (gathered over the model group), and this rank's
    own gradients of the replicated parameters before the reduction, and
    Adam's first moments."""
    from genpercept_tpu_torch import parallel
    from genpercept_tpu_torch.parallel import tensor as TP
    from genpercept_tpu_torch.train import train_step as TT

    models = load_models(models_path, dtype)
    cfg = TT.TrainConfig(**cfg_kw)
    trainable, _, opt = TT.init_train_state(models, cfg)
    splits = ({f"unet.{k}": v for k, v in TP.shard_unet_(models.unet).items()}
              if parallel.model_world() > 1 else {})
    seen = {}
    reduce = parallel.reduce_gradients_

    def spy(grads, sharded):
        grads = list(grads)
        seen["pre"] = [g.clone() for g in grads]
        reduce(grads, sharded)
        seen["post"] = grads

    parallel.reduce_gradients_ = spy
    try:
        metrics = TT.build_train_step(cfg, models, opt)(batch)
    finally:
        parallel.reduce_gradients_ = reduce
    names = list(trainable)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: TP.gather_over_model(g, splits.get(n)).float()
                      for n, g in zip(names, seen["post"])},
            "params": {n: TP.gather_over_model(p.detach(), splits.get(n)).float()
                       for n, p in trainable.items()},
            "mu": {n: TP.gather_over_model(opt._state(p)["mu"], splits.get(n)).float()
                   for n, p in trainable.items()},
            "replicated_pre": {n: g for n, g in zip(names, seen["pre"]) if n not in splits},
            "split": sorted(splits)}


def steps(rank: int, world: int, port: int, spec: dict) -> None:
    """spec: {"models", "batch", "configs": {name: (cfg_kw, dtype)}, "out"}:
    run_step of each configuration over a model group of every rank."""
    from genpercept_tpu_torch import parallel

    _group(rank, world, port, world)
    for name, (cfg_kw, dtype) in spec["configs"].items():
        out = run_step(spec["models"], cfg_kw, spec["batch"], dtype)
        if rank:  # the others' whole tensors are rank 0's; their replicated ones are compared
            out = {"split": out["split"], "replicated_pre": out["replicated_pre"],
                   "params": {k: v for k, v in out["params"].items() if k not in out["split"]}}
        torch.save(out, f"{spec['out']}.{name}.rank{rank}.pt")
    parallel.shutdown()


def ranks(rank: int, world: int, spec: dict) -> None:
    """spec: {"fg": (port, out) or None, "steps": (port, spec) or None,
    "jobs": [(argv, port), ...]}: fg, steps, then the CLI's jobs."""
    torch.set_num_threads(1)
    if spec.get("fg"):
        fg(rank, world, *spec["fg"])
    if spec.get("steps"):
        steps(rank, world, *spec["steps"])
    torch_parallel_worker.run(rank, world, spec.get("jobs", []))
