"""The port's export CLI held to the JAX package's.

One trainable state (a UNet and a VAE decoder + post_quant_conv from numpy
seeds, unlike the base's) goes into both packages: as a JAX tree into an
orbax training checkpoint, and moved with ``state_dict_from_jax`` into the
port's ``state.pt``. Each package's export CLI turns its checkpoint into
the published layout over the tiny base checkpoint of
tests/test_torch_checkpoint.py. The port runs with ``--device cpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from genpercept_tpu.cli import export as jax_export
from genpercept_tpu.io.checkpoints import save_train_checkpoint as jax_save_state
from genpercept_tpu.models import UNetConfig as JUNetConfig
from genpercept_tpu.models import VAEConfig as JVAEConfig
from genpercept_tpu.models import init_unet, init_vae
from genpercept_tpu_torch.cli import export as port_export
from genpercept_tpu_torch.io import state_dict_from_jax
from genpercept_tpu_torch.io.checkpoints import load_genpercept_checkpoint, save_train_checkpoint
from genpercept_tpu_torch.io.weights import load_safetensors
from test_torch_checkpoint import TINY_UNET, TINY_VAE, ckpts  # noqa: F401  (fixture)
from test_torch_models import numpy_params

COUNTERS = {"effective_iter": 7, "epoch": 2, "n_batch_in_epoch": 1}


@pytest.fixture(scope="module")
def trained():
    """The JAX trainable tree and the port's dotted state of the same values."""
    unet = numpy_params(init_unet, JUNetConfig(**TINY_UNET), seed=40)
    vae = numpy_params(init_vae, JVAEConfig(**TINY_VAE), seed=41)
    tree = {"unet": unet, "vae": {"decoder": vae["decoder"],
                                  "post_quant_conv": vae["post_quant_conv"]}}
    return tree, state_dict_from_jax(tree)


def files(root) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def export_argv(run, base, out, *extra):
    return ["--run_dir", str(run), "--base_checkpoint", str(base), "--name", "final",
            "--output_dir", str(out), *extra]


def port_run(root, trainable, **extra):
    save_train_checkpoint(str(root / "checkpoint"),
                          {"trainable": trainable, "opt_state": {}, "counters": COUNTERS,
                           **extra}, "final")
    return root


@pytest.mark.parametrize("parts", ["unet", "unet+vae"])
def test_export_matches_jax(ckpts, trained, tmp_path, parts):  # noqa: F811
    """The same file tree (unet/ with config.json, vae_decoder/ and
    vae_post_quant_conv/ for a decoder-trained run, empty_text_embed.npy),
    every file's tensors equal (0.0) under the same names and dtypes."""
    base = ckpts["plain"][0]
    tree, state = trained
    if parts == "unet":
        tree = {"unet": tree["unet"]}
        state = {k: v for k, v in state.items() if k.startswith("unet.")}
    jax_save_state(str(tmp_path / "jax_run" / "checkpoint"),
                   {"trainable": tree, "opt_state": {"count": np.int32(7)},
                    "counters": {k: np.int32(v) for k, v in COUNTERS.items()}}, "final")
    jax_export.main(export_argv(tmp_path / "jax_run", base, tmp_path / "jax"))
    port_export.main(export_argv(port_run(tmp_path / "port_run", state), base,
                                 tmp_path / "port", "--device", "cpu"))
    ours, ref = files(tmp_path / "port"), files(tmp_path / "jax")
    assert list(ours) == list(ref)
    want = ["empty_text_embed.npy", "unet/config.json", "unet/diffusion_pytorch_model.safetensors"]
    if parts == "unet+vae":
        want += ["vae_decoder/model.safetensors", "vae_post_quant_conv/model.safetensors"]
    assert sorted(ours) == sorted(want)
    for name in ours:
        if name.endswith(".safetensors"):
            a, b = load_safetensors(str(ours[name])), load_safetensors(str(ref[name]))
            assert set(a) == set(b), name
            for k in b:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
        else:
            assert ours[name].read_bytes() == ref[name].read_bytes(), name


def test_export_loads_through_the_port_loader(ckpts, trained, tmp_path):  # noqa: F811
    """The exported directory over the base (for the VAE's encoder): the
    trained UNet, decoder and post_quant_conv, the base's encoder."""
    base = ckpts["plain"][0]
    _, state = trained
    port_export.main(export_argv(port_run(tmp_path / "run", state), base, tmp_path / "out",
                                 "--device", "cpu"))
    models = load_genpercept_checkpoint(str(tmp_path / "out"), base_ckpt_dir=str(base),
                                        device="cpu")
    base_models = load_genpercept_checkpoint(str(base), device="cpu")
    for prefix, module in (("unet.", models.unet), ("vae.", models.vae)):
        for k, v in module.state_dict().items():
            if prefix + k in state:
                assert torch.equal(v, state[prefix + k]), k
            else:
                assert k.startswith("encoder.") or k.startswith("quant_conv."), k
                assert torch.equal(v, base_models.vae.state_dict()[k]), k
    np.testing.assert_array_equal(models.text_embed.numpy(), base_models.text_embed.numpy())


def test_export_of_bf16_masters_is_in_the_base_dtype(ckpts, trained, tmp_path):  # noqa: F811
    """A run with bf16 masters exports the base's f32, each tensor the bf16
    value widened (exactly)."""
    _, state = trained
    bf16 = {k: v.to(torch.bfloat16) for k, v in state.items() if k.startswith("unet.")}
    port_export.main(export_argv(port_run(tmp_path / "run", bf16), ckpts["plain"][0],
                                 tmp_path / "out", "--device", "cpu"))
    out = load_safetensors(str(tmp_path / "out/unet/diffusion_pytorch_model.safetensors"))
    for k, v in bf16.items():
        t = out[k[len("unet."):]]
        assert t.dtype == torch.float32 and torch.equal(t, v.float()), k


@pytest.mark.parametrize("key", ["unet_lora.down_blocks.0.lora_A", "dpt_head.neck.x.weight"])
def test_export_refuses_lora_and_dpt_head_runs(ckpts, trained, tmp_path, key):  # noqa: F811
    """LoRA and DPT-head runs export (tests/test_torch_lora.py and below);
    an adapter without its pair or a tensor no head holds is refused before
    anything is written; so is a head run that records no head config."""
    from genpercept_tpu_torch.models import DPTHeadConfig
    from test_torch_checkpoint import TINY_DPT

    _, state = trained
    head_cfg = dataclasses.asdict(DPTHeadConfig(final_act="identity", **TINY_DPT))
    run = port_run(tmp_path / "run", {**state, key: torch.zeros(2)}, dpt_head_cfg=head_cfg)
    with pytest.raises(KeyError, match="does not match" if key.startswith("dpt") else None):
        port_export.main(export_argv(run, ckpts["plain"][0], tmp_path / "out", "--device", "cpu"))
    assert not (tmp_path / "out").exists()
    run = port_run(tmp_path / "bare", {**state, "dpt_head.neck.x.weight": torch.zeros(2)})
    with pytest.raises(KeyError, match="dpt_head_cfg"):
        port_export.main(export_argv(run, ckpts["plain"][0], tmp_path / "out", "--device", "cpu"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("final_act", ["identity", "relu"])
def test_export_of_a_dpt_head_run(ckpts, trained, tmp_path, final_act):  # noqa: F811
    """A fresh head trained on the base: the port writes dpt_head_identity/
    for an identity head (the run records the head's config) and dpt_head/
    for a ReLU one, each with a config.json of the head's widths, and the
    JAX export's UNet; the export loads back with that head, bit for bit.
    JAX writes dpt_head/ whatever the head (its export takes the head's
    config from the base checkpoint, which has none), so an identity head
    reloads with a ReLU, and no config.json."""
    from genpercept_tpu.models import dpt_head as j_dpt
    from genpercept_tpu_torch.models import DPTHeadConfig
    from test_torch_checkpoint import TINY_DPT

    base = ckpts["plain"][0]
    tree, state = trained
    head = numpy_params(j_dpt.init_dpt_head,
                        j_dpt.DPTHeadConfig(final_act=final_act, **TINY_DPT), seed=42)
    jax_save_state(str(tmp_path / "jax_run" / "checkpoint"),
                   {"trainable": {"unet": tree["unet"], "dpt_head": head},
                    "opt_state": {"count": np.int32(7)},
                    "counters": {k: np.int32(v) for k, v in COUNTERS.items()}}, "final")
    jax_export.main(export_argv(tmp_path / "jax_run", base, tmp_path / "jax"))
    head_state = {f"dpt_head.{k}": v for k, v in state_dict_from_jax(head).items()}
    cfg = DPTHeadConfig(final_act=final_act, **TINY_DPT)
    unet_state = {k: v for k, v in state.items() if k.startswith("unet.")}
    save_train_checkpoint(str(tmp_path / "run" / "checkpoint"),
                          {"trainable": {**unet_state, **head_state}, "opt_state": {},
                           "counters": COUNTERS, "dpt_head_cfg": dataclasses.asdict(cfg)},
                          "final")
    port_export.main(export_argv(tmp_path / "run", base, tmp_path / "port", "--device", "cpu"))
    sub = "dpt_head_identity" if final_act == "identity" else "dpt_head"
    assert sorted(files(tmp_path / "jax")) == sorted(
        n.replace("dpt_head_identity/", "dpt_head/") for n in files(tmp_path / "port")
        if not n.endswith("dpt_head/config.json") and not n.endswith("identity/config.json"))
    assert (tmp_path / "port" / sub / "model.safetensors").is_file()
    assert (tmp_path / "port" / sub / "config.json").is_file()
    assert (tmp_path / "jax" / "dpt_head" / "model.safetensors").is_file()
    name = "unet/diffusion_pytorch_model.safetensors"
    a, b = (load_safetensors(str(tmp_path / d / name)) for d in ("port", "jax"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)
    models = load_genpercept_checkpoint(str(tmp_path / "port"), base_ckpt_dir=str(base),
                                        device="cpu")
    assert models.dpt_cfg.final_act == final_act
    for k, v in models.dpt_head.state_dict().items():
        assert torch.equal(v, head_state[f"dpt_head.{k}"]), k


def test_export_flags_mirror_jax_and_default_to_the_card(ckpts, trained, tmp_path,  # noqa: F811
                                                         monkeypatch):
    ours = {a.dest: a.default for a in port_export.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_export.build_parser()._actions}
    assert set(ours) == set(ref) | {"device"} and ours["device"] == "cuda"
    assert {k: ours[k] for k in ref} == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = port_run(tmp_path / "run", trained[1])
    with pytest.raises(RuntimeError, match="device"):
        port_export.main(export_argv(run, ckpts["plain"][0], tmp_path / "out"))
    assert not (tmp_path / "out").exists()
