"""The port's HTTP server held to the JAX server on a tiny CPU pipeline.

The round trips of tests/test_serve.py (healthz, the four formats, the JSON
endpoint, the error reply) against the port's server, with a port pipeline
injected on the CPU; its npy equals the port pipeline's own output (0.0)
and the JAX pipeline's within tests/test_torch_pipeline.py's bar (mean abs
deviation <= 1e-4) on the same weights. ``_encode_pred`` gives the JAX
server's bytes in every format. ``--data_parallel`` runs two CPU pipelines
on one queue; a marigold pipeline serves a burst one request at a time.
"""

import base64
import concurrent.futures
import copy
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from genpercept_tpu.cli import serve as jax_serve
from genpercept_tpu_torch.cli import serve
from genpercept_tpu_torch.models import UNet2DConditionModel, UNetConfig, init_params_
from genpercept_tpu_torch.pipeline import GenPerceptModels, GenPerceptPipeline, PipelineConfig
from test_torch_checkpoint import ckpts  # noqa: F401  (module-scoped fixture)
from test_torch_pipeline import MEAN_TOL, TINY_UNET, pipes  # noqa: F401  (fixture)

torch.set_num_threads(1)

# equal images give equal predictions whatever device batch they ran in, up
# to the CPU convolutions' summation order at another batch size: 1.5e-5 at
# most on 0.1% of the pixels here (tests/test_serve.py holds JAX's to 1e-5)
BATCHED_TOL = 5e-5
FORMATS = ["npy", "png16", "png", "colored"]


def png_bytes(h=100, w=80, seed=0):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue(), img


def start(pipe, *flags):
    args = serve.build_parser().parse_args(
        ["--checkpoint", "unused", "--mode", "depth", "--port", "0", "--device", "cpu", *flags])
    server = serve.make_server(args, pipe=pipe)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def stop(server):
    server.shutdown()
    server.server_close()
    server.worker.close()


def post(url, data, timeout=600):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_serve_round_trips_match_the_pipelines(pipes):  # noqa: F811
    jpipe, tpipe = pipes
    png, img = png_bytes()
    direct = tpipe(img)
    server, url = start(tpipe)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "mode": "depth", "platform": "cpu"}

        pred = np.load(io.BytesIO(post(url + "/v1/infer?format=npy", png)))
        assert pred.shape == img.shape[:2] and pred.dtype == np.float32
        assert float(np.abs(pred - direct.pred_np).max()) == 0.0
        assert float(np.mean(np.abs(pred - jpipe(img).pred_np))) <= MEAN_TOL

        p16 = np.asarray(Image.open(io.BytesIO(post(url + "/v1/infer?format=png16", png))))
        np.testing.assert_array_equal(p16.astype(np.uint16),
                                      (np.clip(pred, 0, 1) * 65535.0).astype(np.uint16))
        p8 = np.asarray(Image.open(io.BytesIO(post(url + "/v1/infer?format=png", png))))
        np.testing.assert_array_equal(p8, (np.clip(pred, 0, 1) * 255.0).astype(np.uint8))
        col = np.asarray(Image.open(io.BytesIO(post(url + "/v1/infer?format=colored", png))))
        np.testing.assert_array_equal(col, direct.pred_colored)

        body = json.dumps({"image_b64": base64.b64encode(png).decode()}).encode()
        req = urllib.request.Request(url + "/v1/infer_json", data=body)
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        assert out["dtype"] == "float32" and out["latency_ms"] > 0
        arr = np.frombuffer(base64.b64decode(out["pred_b64"]), np.float32).reshape(out["shape"])
        np.testing.assert_array_equal(arr, pred)

        for path, data in (("/v1/infer", b"not an image"), ("/v1/infer?format=tiff", png),
                           ("/v1/infer_json", b"{}")):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(url + path, data)
            assert e.value.code == 500 and "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nowhere", timeout=60)
        assert e.value.code == 404
        # the server still answers after the failures
        again = np.load(io.BytesIO(post(url + "/v1/infer?format=npy", png)))
        np.testing.assert_array_equal(again, pred)
    finally:
        stop(server)


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_pred_bytes_equal_jax(pipes, fmt):  # noqa: F811
    _, tpipe = pipes
    out = tpipe(png_bytes(seed=1)[1])
    assert serve._encode_pred(out, fmt, "depth") == jax_serve._encode_pred(out, fmt, "depth")


def test_encode_pred_refusals_match_jax(pipes):  # noqa: F811
    _, tpipe = pipes
    plain = tpipe(png_bytes(seed=1)[1], color_map=None)
    for fmt, out in (("colored", plain), ("tiff", plain)):
        with pytest.raises(ValueError) as ours:
            serve._encode_pred(out, fmt, "depth")
        with pytest.raises(ValueError) as ref:
            jax_serve._encode_pred(out, fmt, "depth")
        assert str(ours.value) == str(ref.value)


class CountingPipeline(GenPerceptPipeline):
    """Counts the images each entry point ran."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.images = {"call": 0, "batch": 0}

    def __call__(self, image, *a, **kw):
        self.images["call"] += 1
        return super().__call__(image, *a, **kw)

    def batch(self, images, *a, **kw):
        self.images["batch"] += len(images)
        return super().batch(images, *a, **kw)


def burst(url, png, n):
    with concurrent.futures.ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(lambda _: np.load(io.BytesIO(post(url + "/v1/infer?format=npy",
                                                                png))), range(n)))


def test_serve_data_parallel_two_pipelines_one_queue(pipes):  # noqa: F811
    """tests/test_serve.py::test_serve_data_parallel_micro_batching on two CPU
    pipelines, one worker each, draining one queue: 6 concurrent requests,
    every prediction equal to a lone request's."""
    _, tpipe = pipes
    two = [CountingPipeline(copy.deepcopy(tpipe.models), tpipe.cfg, device="cpu")
           for _ in range(2)]
    png, img = png_bytes(seed=2)
    lone = tpipe(img).pred_np
    server, url = start(two, "--data_parallel", "--max_batch", "8")
    try:
        assert len(server.worker.threads) == 2
        preds = burst(url, png, 6)
    finally:
        stop(server)
    assert sum(sum(p.images.values()) for p in two) == 6
    for pred in preds:
        assert pred.shape == img.shape[:2]
        np.testing.assert_allclose(pred, lone, atol=BATCHED_TOL, rtol=0)


def test_serve_marigold_burst_one_request_at_a_time(pipes):  # noqa: F811
    """The JAX worker fuses a marigold burst into .batch, which has no noise
    and raises; the port's serves each request through __call__, each the
    lone request's draw (seed 0)."""
    _, tpipe = pipes
    unet = UNet2DConditionModel(UNetConfig(**dict(TINY_UNET, in_channels=8)))
    init_params_(unet, torch.Generator().manual_seed(5))
    models = GenPerceptModels(unet=unet, vae=copy.deepcopy(tpipe.models.vae),
                              text_embed=tpipe.models.text_embed)
    pipe = CountingPipeline(models, PipelineConfig(arch="marigold", denoising_steps=2,
                                                   processing_res=64), device="cpu")
    png, img = png_bytes(seed=3)
    lone = pipe(img).pred_np
    server, url = start(pipe, "--archs", "marigold", "--max_batch", "4")
    try:
        preds = burst(url, png, 4)
    finally:
        stop(server)
    assert pipe.images == {"call": 5, "batch": 0}
    for pred in preds:
        np.testing.assert_array_equal(pred, lone)


def test_make_server_runs_on_the_card_by_default(monkeypatch):
    args = serve.build_parser().parse_args(["--checkpoint", "unused", "--port", "0"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.make_server(args)


def test_parser_flags_are_jax_and_device():
    ours = {a.dest: a.default for a in serve.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_serve.build_parser()._actions}
    assert set(ours) == set(ref) | {"device"}
    assert {k: ours[k] for k in ref} == ref


def test_chip_smoke_serve_phase_on_the_cpu(ckpts, tmp_path, monkeypatch):  # noqa: F811
    """chip_smoke.py's serve phase, its readings and checks, on a tiny
    checkpoint on the CPU at 64 pixels (no kernel launches there): the
    server in f32, a held burst fused into one batch, the hub, and the
    dataset inference CLI on NYU's layout with and without a prompt."""
    import chip_smoke as cs
    from genpercept_tpu_torch.io import checkpoints as tck
    from genpercept_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel

    for name, n in (("SERVE_WARMUPS", 1), ("SERVE_REQUESTS", 2), ("SERVE_480_REQUESTS", 1),
                    ("HUB_CALLS", 1)):
        monkeypatch.setattr(cs, name, n)
    ckpt = ckpts["plain"][0]
    zero = {k: 0 for k in cs.COUNTERS}
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)]
    rec = cs.serve_reading(ckpt, torch.float32, images, device="cpu", processing_res=64)
    cs.check_served(rec, torch.float32, {"768": zero, "480x640": zero}, "cpu",
                    [(64, 64), (40, 52)])
    assert rec["vs_direct_768"]["max"] == 0.0

    rec = cs.burst_reading(ckpt, torch.float32, images[0], device="cpu", burst=4,
                           processing_res=64, data_parallel=True)
    cs.check_burst(rec, torch.float32, zero, 4)

    rec = cs.hub_reading(ckpt, images[1], device="cpu", resolution=64, half_precision=False)
    cs.check_hub(rec, zero, [40, 52])

    tiny = dict(vocab_size=49408, hidden_size=48, num_layers=1, num_heads=4,
                intermediate_size=96)
    monkeypatch.setattr(tck, "CLIPTextModel", lambda: CLIPTextModel(CLIPTextConfig(**tiny)))
    clip = init_params_(CLIPTextModel(CLIPTextConfig(**tiny)), torch.Generator().manual_seed(1))
    prompt_ckpt = cs.write_prompt_checkpoint(tmp_path / "ckpt_prompt", ckpt, clip)
    data = cs.write_nyu_layout(tmp_path / "nyu", hw=(48, 64))
    npys = {}
    for name, ck, prompt in (("f32", ckpt, ""), ("prompt", prompt_ckpt, cs.SERVE_PROMPT)):
        rec = cs.infer_reading(name, ck, torch.float32, tmp_path / "nyu", data, prompt,
                               device="cpu", processing_res=64)
        npys[name] = rec.pop("npy")
        cs.check_infer(rec, zero, cs.NYU_IMAGES)
        assert rec["files"][0].startswith("test/kitchen_0004/pred_")
    assert max(float(np.abs(npys["prompt"][f] - npys["f32"][f]).max()) for f in npys["f32"]) \
        > 1e-4
