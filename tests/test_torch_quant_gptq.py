"""The port's GPTQ int8 rounding, its fake-quant attribution hooks and int8
on a DPT-head checkpoint, held to the JAX package's on the CPU.

Inputs come from numpy seeds and go to both packages (layouts as in
tests/test_torch_quant.py: the port keeps conv weights OIHW, dense weights
(out, in)).

Tolerances and why:
- input Grams: 1e-5 of max|H| (products of bf16 codes are exact in f32;
  only the order of the f32 sums differs);
- GPTQ codes: equal for H = I (round-to-nearest); otherwise at most 1e-3
  of the codes different (the sequential f32 update, taken in another order
  of operations, can move a value across .5);
- fake-quant convolutions: 1e-5 of max|y| against JAX (f32 convolutions
  summed in another order); "wa" within 1e-4 of max|y| of the port's own
  int8 convolution (the int8 path sums exact int32 products, the fake one
  rounds f32 products);
- the tiny pipelines: test_torch_quant.py's bars (trees: 1% of the scales
  beyond 1e-4 relative, 1e-3 of the codes; depth mean deviation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genpercept_tpu.ops import quant as jq
from genpercept_tpu_torch.ops import quant as tq
from test_torch_models import nchw, numpy_params
from test_torch_quant import assert_same_q, conv_params, port_w, skewed, to_port

torch.set_num_threads(1)

STATS = {"sym": jq.mse_optimal_clip, "asym": jq.mse_optimal_clip_asym}
GEOMETRY = [((1, 1), ((1, 1), (1, 1))), ((2, 2), ((0, 1), (0, 1))), ((2, 2), ((1, 1), (1, 1)))]


def torch_w(w):
    """An HWIO numpy kernel as the port's OIHW tensor."""
    return torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


def gram_close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------------ Grams


@pytest.mark.parametrize("stat", ["sym", "asym"])
@pytest.mark.parametrize("stride,padding", GEOMETRY)
def test_conv_input_hessian_matches_jax(stride, padding, stat):
    x = skewed((2, 9, 7, 8), seed=1)
    a = STATS[stat](jnp.asarray(x))
    ref = jq.conv_input_hessian(jnp.asarray(x), a, stride=stride, padding=padding)
    ours = tq.conv_input_hessian(nchw(x), torch.from_numpy(np.array(a)), stride=stride,
                                 padding=padding)
    assert ours.shape == (72, 72)
    gram_close(ours, ref)


def test_conv_input_hessian_row_chunks_change_nothing(monkeypatch):
    """Row chunks of the im2col (here one output row at a time) sum the
    same Gram."""
    x = skewed((2, 9, 7, 8), seed=2)
    a = torch.from_numpy(np.array(jq.mse_optimal_clip_asym(jnp.asarray(x))))
    whole = tq.conv_input_hessian(nchw(x), a)
    monkeypatch.setattr(tq, "_IM2COL_BYTES", 1)
    gram_close(tq.conv_input_hessian(nchw(x), a), whole)


@pytest.mark.parametrize("stat", ["sym", "asym"])
def test_dense_input_hessian_matches_jax(stat):
    x = skewed((2, 30, 24), seed=3)
    a = STATS[stat](jnp.asarray(x))
    ref = jq.dense_input_hessian(jnp.asarray(x), a)
    gram_close(tq.dense_input_hessian(torch.from_numpy(x), torch.from_numpy(np.array(a))), ref)


# ------------------------------------------------------------------- GPTQ


def gptq_case(seed=4):
    """JAX's own wf, o_scale and a correlated conv Gram."""
    x = skewed((2, 8, 8, 16), seed=seed)
    w, _ = conv_params(16, 24, seed=seed + 1)
    a_stat = jq.mse_optimal_clip_asym(jnp.asarray(x))
    _, a = jq._split_stat(a_stat, 1.0)
    wf = (jnp.asarray(w) * (a / 127.0)[None, None, :, None]).reshape(-1, 24)
    o_scale = jnp.maximum(jnp.max(jnp.abs(wf), axis=0) / 127.0, 1e-12)
    H = jq.conv_input_hessian(jnp.asarray(x), a_stat)
    return wf, o_scale, H


def test_gptq_identity_hessian_is_round_to_nearest():
    wf, o_scale, _ = gptq_case()
    eye = jnp.eye(wf.shape[0], dtype=jnp.float32)
    ours = tq.gptq_round(torch.from_numpy(np.array(wf)), torch.from_numpy(np.array(o_scale)),
                         torch.from_numpy(np.array(eye)))
    rtn = np.clip(np.round(np.asarray(wf) / np.asarray(o_scale)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(ours.numpy(), rtn)
    np.testing.assert_array_equal(np.asarray(jq.gptq_round(wf, o_scale, eye)), rtn)


def test_gptq_round_matches_jax():
    """A correlated Gram: the codes of both packages agree to 1e-3, and GPTQ
    lowers the Gram-weighted rounding error below round-to-nearest's."""
    wf, o_scale, H = gptq_case()
    ref = np.asarray(jq.gptq_round(wf, o_scale, H))
    ours = tq.gptq_round(*(torch.from_numpy(np.array(t)) for t in (wf, o_scale, H))).numpy()
    assert ours.dtype == np.int8 and ours.shape == ref.shape
    assert (ours != ref).sum() <= 1e-3 * ref.size, (ours != ref).sum()
    w, s, h = np.asarray(wf, np.float64), np.asarray(o_scale, np.float64), np.asarray(H, np.float64)
    rtn = np.clip(np.round(w / s), -127, 127)

    def err(q):
        e = w - q * s
        return float(np.einsum("ic,ij,jc->", e, h, e))

    assert err(ours.astype(np.float64)) < 0.9 * err(rtn)


@pytest.mark.parametrize("asym", [False, True])
def test_quantize_with_hess_matches_jax(asym):
    """quantize_conv (3x3, the stride-2 downsampler) and quantize_dense with
    Grams: equal trees to the bars; up4x4 ignores the Gram
    (quantize_from_stats is held to JAX's by the tiny pipeline's trees)."""
    x = skewed((2, 8, 8, 16), seed=5)
    w, b = conv_params(16, 24, seed=6)
    stat = STATS["asym" if asym else "sym"](jnp.asarray(x))
    for stride, padding in GEOMETRY[:2]:
        H = jq.conv_input_hessian(jnp.asarray(x), stat, stride=stride, padding=padding)
        ref = jq.quantize_conv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, stat,
                               stride=stride, padding=padding, margin=1.0, hess=H)
        ours = tq.quantize_conv(torch_w(w), torch.from_numpy(b), torch.from_numpy(np.array(stat)),
                                stride=stride, padding=padding, margin=1.0,
                                hess=torch.from_numpy(np.array(H)))
        codes_close(ours, ref)
    up = tq.quantize_conv(torch_w(w), torch.from_numpy(b), torch.from_numpy(np.array(stat)),
                          kind="up4x4", hess=torch.eye(144) * 3.0)
    assert_same_q(up, jq.quantize_conv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                       stat, kind="up4x4"))
    xd = skewed((2, 30, 32), seed=7)
    wd = (np.random.default_rng(8).uniform(-1, 1, (32, 40)) / np.sqrt(32)).astype(np.float32)
    sd = STATS["asym" if asym else "sym"](jnp.asarray(xd))
    Hd = jq.dense_input_hessian(jnp.asarray(xd), sd)
    ref = jq.quantize_dense({"weight": jnp.asarray(wd)}, sd, margin=1.0, hess=Hd)
    ours = tq.quantize_dense(torch.from_numpy(wd.T.copy()), None, torch.from_numpy(np.array(sd)),
                             margin=1.0, hess=torch.from_numpy(np.array(Hd)))
    codes_close(ours, ref)


def codes_close(ours, ref, frac=1e-3):
    """Codes to 1e-3, scales to 1 ulp, and the bias (which folds the
    zero-point through the codes) to 1e-6 of its largest entry plus what
    the differing codes move."""
    w, wr = port_w(ours), np.asarray(ref.w_int8)
    assert (w != wr).sum() <= max(1, frac * wr.size), ((w != wr).sum(), wr.size)
    np.testing.assert_array_max_ulp(ours.o_scale.numpy(), np.asarray(ref.o_scale), maxulp=1)
    np.testing.assert_array_max_ulp(ours.inv_a.numpy(), np.asarray(ref.inv_a), maxulp=1)
    if ref.bias is not None:
        b = np.asarray(ref.bias)
        np.testing.assert_allclose(ours.bias.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max() + 1e-3 * np.abs(b).max() * (w != wr).sum())


def test_calibrate_chunked_averages_grams_as_jax():
    """Five images in chunks of 2 (a ragged tail): the Grams average weighted
    by chunk size, apart from the range merge."""
    x = skewed((5, 6, 8), seed=9)

    def j_fn(rgb):
        a = jq.minmax_asym(rgb)
        return rgb, {"enc": {"l": a}, "hess": {"enc": {"l": jq.dense_input_hessian(rgb, a)},
                                               "dec": {}}}

    def t_fn(rgb):
        a = tq.minmax_asym(rgb)
        return rgb, {"enc": {"l": a}, "hess": {"enc": {"l": tq.dense_input_hessian(rgb, a)},
                                               "dec": {}}}

    _, jst = jq.calibrate_chunked(lambda p, r: j_fn(r), None, jnp.asarray(x), chunk=2)
    _, tst = tq.calibrate_chunked(t_fn, torch.from_numpy(x), chunk=2)
    assert set(tst) == {"enc", "hess"} and tst["hess"]["dec"] == {}
    np.testing.assert_array_max_ulp(tst["enc"]["l"].numpy(), np.asarray(jst["enc"]["l"]),
                                    maxulp=1)
    gram_close(tst["hess"]["enc"]["l"], jst["hess"]["enc"]["l"])


def test_calibration_hooks_record_grams_as_jax():
    """make_calib_conv_fn / make_calib_dense_fn with hess: the Gram of each
    layer at its own geometry; none for up4x4."""
    x = skewed((2, 8, 8, 16), seed=10)
    w, b = conv_params(16, 24, seed=11)
    jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    kw = dict(clip_search=True, asymmetric=True, margin=1.0)
    js, jh, ts, th = {}, {}, {}, {}
    jfn, tfn = jq.make_calib_conv_fn(js, hess=jh, **kw), tq.make_calib_conv_fn(ts, hess=th, **kw)
    for name, geo in (("c", dict()), ("d", dict(stride=2, padding=((0, 1), (0, 1)))),
                      ("u", dict(kind="up4x4"))):
        jfn(name, jp, jnp.asarray(x), **geo)
        tfn(name, torch_w(w), torch.from_numpy(b), nchw(x), **geo)
    assert set(th) == set(jh) == {"c", "d"}
    for k in jh:
        gram_close(th[k], jh[k])
    xd = skewed((2, 30, 16), seed=12)
    jq.make_calib_dense_fn(js, hess=jh, **kw)("l", {"weight": jnp.asarray(w[0, 0])},
                                               jnp.asarray(xd))
    tq.make_calib_dense_fn(ts, hess=th, **kw)("l", torch.from_numpy(w[0, 0].T.copy()), None,
                                               torch.from_numpy(xd))
    gram_close(th["l"], jh["l"])


# ------------------------------------------------------------ fake quant

FAKE_KINDS = [("3x3", 1, 1), ("3x3", 2, ((0, 1), (0, 1))), ("up4x4", 1, 1)]


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("kind,stride,padding", FAKE_KINDS)
@pytest.mark.parametrize("side", ["w", "a", "wa"])
def test_fakequant_conv_matches_jax(side, kind, stride, padding, asym):
    x = skewed((2, 8, 8, 16), seed=13)
    w, b = conv_params(16, 24, seed=14)
    jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    stat = STATS["asym" if asym else "sym"](jnp.asarray(x))
    jtree = {"l": jq.quantize_conv(jp, stat, kind=kind, stride=stride, padding=padding)}
    geo = dict(kind=kind, stride=stride, padding=padding)
    ref = np.asarray(jq.make_fakequant_conv_fn(jtree, side)("l", jp, jnp.asarray(x), **geo))
    ttree = {"l": to_port(jtree["l"])}
    ours = tq.make_fakequant_conv_fn(ttree, side)("l", torch_w(w), torch.from_numpy(b), nchw(x),
                                                  **geo)
    ours = ours.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if side == "wa":
        real = tq.qconv_apply(ttree["l"], nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(ours, real, rtol=0, atol=1e-4 * np.abs(real).max())
    # a layer absent from the tree runs untouched
    untouched = tq.make_fakequant_conv_fn({}, side)("m", torch_w(w), torch.from_numpy(b),
                                                    nchw(x), **geo)
    plain = tq.make_quant_conv_fn({})("m", torch_w(w), torch.from_numpy(b), nchw(x), **geo)
    np.testing.assert_array_equal(untouched.numpy(), plain.numpy())


def test_fakequant_side_is_checked():
    with pytest.raises(ValueError):
        tq.make_fakequant_conv_fn({}, "x")


# ------------------------------------------------------- tiny pipelines

# test_torch_quant.py's slice config with int8_refine off (JAX's refined
# calibration program takes minutes to compile on one core)
GPTQ = dict(mode="depth", processing_res=64, int8_vae=True, int8_unet=True,
            int8_unet_ff=True, int8_vae_attn=True, int8_refine=False, int8_gptq=True)
DPT = dict(mode="disparity_dpt_head", processing_res=64, int8_vae=True, int8_unet=True,
           int8_unet_ff=True, int8_refine=False)
SMALL_DPT = dict(neck_hidden_sizes=(32, 64, 128, 128), fusion_hidden_size=16)  # the tiny UNet's widths


def tiny(dpt: bool):
    """The tiny models of tests/test_torch_pipeline.py in both packages (with
    a small DPT head and no conv_out when ``dpt``)."""
    from genpercept_tpu.models import UNetConfig as JU, VAEConfig as JV, init_unet, init_vae
    from genpercept_tpu.models import dpt_head as j_dpt
    from genpercept_tpu.pipeline import GenPerceptModels as JModels
    from genpercept_tpu_torch.io import state_dict_from_jax
    from genpercept_tpu_torch.models import (AutoencoderKL, UNet2DConditionModel, UNetConfig,
                                             VAEConfig)
    from genpercept_tpu_torch.models import dpt_head as t_dpt
    from genpercept_tpu_torch.pipeline import GenPerceptModels
    from test_torch_pipeline import TINY_UNET, TINY_VAE

    unet_p = numpy_params(init_unet, JU(**TINY_UNET), seed=0)
    vae_p = numpy_params(init_vae, JV(**TINY_VAE), seed=1)
    embed = np.random.default_rng(2).normal(size=(1, 77, 48)).astype(np.float32)
    jm = dict(unet=unet_p, vae=vae_p, unet_cfg=JU(**TINY_UNET), vae_cfg=JV(**TINY_VAE),
              text_embed=jnp.asarray(embed))
    head_p = None
    if dpt:
        jm["unet"] = {k: v for k, v in unet_p.items() if k not in ("conv_norm_out", "conv_out")}
        jm["unet_cfg"] = JU(**TINY_UNET, with_conv_out=False)
        jm["dpt_cfg"] = j_dpt.DPTHeadConfig(**SMALL_DPT)
        head_p = numpy_params(j_dpt.init_dpt_head, jm["dpt_cfg"], seed=3)
        jm["dpt_head"] = head_p

    def tmodels():
        unet = UNet2DConditionModel(UNetConfig(**TINY_UNET, with_conv_out=not dpt))
        unet.load_state_dict(state_dict_from_jax(jm["unet"]), strict=True)
        vae = AutoencoderKL(VAEConfig(**TINY_VAE))
        vae.load_state_dict(state_dict_from_jax(vae_p), strict=True)
        head = None
        if dpt:
            head = t_dpt.DPTHead(t_dpt.DPTHeadConfig(**SMALL_DPT))
            head.load_state_dict(state_dict_from_jax(head_p), strict=True)
        return GenPerceptModels(unet=unet, vae=vae, text_embed=torch.from_numpy(embed),
                                dpt_head=head)

    return JModels(**jm), tmodels


def run_pair(jmodels, tmodels, cfg_kw, images, tmp):
    """Calibrating and quantized batches of both packages, the JAX file, the
    port pipeline on JAX's tree, a full-precision port pipeline."""
    from genpercept_tpu.pipeline import GenPerceptPipeline as JPipe
    from genpercept_tpu.pipeline import PipelineConfig as JCfg
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    jpipe = JPipe(jmodels, JCfg(**cfg_kw))
    with pltpu.force_tpu_interpret_mode():
        j_first = [o.pred_np for o in jpipe.batch(images, batch_size=2)]
        j_second = [o.pred_np for o in jpipe.batch(images, batch_size=2)]
    path = tmp / "jax.npz"
    jpipe.save_calibration(path)
    tpipe = GenPerceptPipeline(tmodels(), PipelineConfig(**cfg_kw), device="cpu")
    t_first = [o.pred_np for o in tpipe.batch(images, batch_size=2)]
    t_second = [o.pred_np for o in tpipe.batch(images, batch_size=2)]
    fp_kw = {k: v for k, v in cfg_kw.items() if not k.startswith("int8")}
    fp = GenPerceptPipeline(tmodels(), PipelineConfig(**fp_kw), device="cpu")
    t_fp = [o.pred_np for o in fp.batch(images, batch_size=2)]
    loaded = GenPerceptPipeline(tmodels(), PipelineConfig(**cfg_kw), device="cpu")
    loaded.load_calibration(path)
    t_loaded = [o.pred_np for o in loaded.batch(images, batch_size=2)]
    return dict(jpipe=jpipe, tpipe=tpipe, loaded=loaded, j_first=j_first, j_second=j_second,
                t_first=t_first, t_second=t_second, t_fp=t_fp, t_loaded=t_loaded, path=path)


@pytest.fixture(scope="module")
def gptq_pipes(tmp_path_factory):
    from genpercept_tpu_torch.utils.synthetic import natural_like_images

    jmodels, tmodels = tiny(dpt=False)
    images = list(natural_like_images(3, 2, 64))
    out = run_pair(jmodels, tmodels, GPTQ, images, tmp_path_factory.mktemp("gptq"))
    out.update(jmodels=jmodels, images=images)
    return out


@pytest.fixture(scope="module")
def dpt_pipes(tmp_path_factory):
    from genpercept_tpu_torch.utils.synthetic import natural_like_images

    jmodels, tmodels = tiny(dpt=True)
    images = list(natural_like_images(3, 2, 64))
    out = run_pair(jmodels, tmodels, DPT, images, tmp_path_factory.mktemp("dpt"))
    out.update(jmodels=jmodels, images=images)
    return out


def mean_dev(a, b):
    return max(float(np.mean(np.abs(x - y))) for x, y in zip(a, b))


def trees_close(ours, ref, groups=None):
    """test_torch_quant.py's tree bars over ``groups`` (default all): 1% of
    the scales beyond 1e-4 relative, 1e-3 of the codes."""
    assert {g: set(t) for g, t in ours.items() if t} == {g: set(t) for g, t in ref.items() if t}
    n_codes = n_diff = n_ch = n_off = 0
    for g in groups or ref:
        for k, r in ref[g].items():
            q = ours[g][k]
            assert isinstance(q, tq.QConv) == isinstance(r, jq.QConv), k
            w, wr = port_w(q), np.asarray(r.w_int8)
            n_codes += w.size
            n_diff += int((w != wr).sum())
            for a, b in ((q.o_scale, r.o_scale), (q.inv_a, r.inv_a)):
                b = np.asarray(b)
                n_ch += b.size
                n_off += int((np.abs(a.numpy() - b) > 1e-4 * np.abs(b)).sum())
    assert n_off <= 1e-2 * n_ch, (n_off, n_ch)
    assert n_diff <= 1e-3 * n_codes, (n_diff, n_codes)
    return n_codes


def gram_error(weight, q, codes, H):
    """(wf - codes * o_scale)^T H (wf - codes * o_scale) summed over output
    channels, in float64: the error GPTQ minimizes. weight OIHW or (out,
    in); codes in the JAX layout (HWIO or (in, out)); wf folds q's scale."""
    w = weight.detach().double()
    a = 127.0 / q.inv_a.double()
    if w.ndim == 2:
        wf = (w * (a / 127.0)[None, :]).t()
    else:
        wf = (w * (a / 127.0)[None, :, None, None]).permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    e = wf.numpy() - codes.reshape(wf.shape).astype(np.float64) * q.o_scale.double().numpy()
    return float(np.einsum("ic,ij,jc->", e, H.double().numpy(), e))


def _geometry(path):
    return dict(stride=2, padding=((0, 1), (0, 1))) if "downsamplers" in path else {}


def test_gptq_pipeline_trees_match_jax(gptq_pipes):
    """int8_gptq: the same groups and paths. The UNet's layers round to
    nearest, held to test_torch_quant.py's bars. The VAE's round by GPTQ,
    whose sequential compensation turns a one-ulp difference in a stat, a
    Gram or its Cholesky factor into a code across .5 and then many more
    (read at these widths: ~0.5% of the codes different on equal inputs,
    ~4% on each package's own): so each GPTQ layer is held by the error
    GPTQ minimizes, weighed by the port's calibrated Gram: the port's
    equal to JAX's within 5% summed over the layers and 25% per layer,
    below round-to-nearest's per layer and at most half of it summed, no
    code more than 4 steps from JAX's; the scales to the bars above; the upsamplers (round to
    nearest) to 1e-3 of the codes."""
    p = gptq_pipes
    ours, ref = p["tpipe"].vae_quant, p["jpipe"]._params["vae_quant"]
    assert trees_close(ours, ref, groups=("unet",)) > 1000
    x = torch.from_numpy(np.stack(p["images"][:2]).astype(np.float32))
    _, stats = tq.calibrate_chunked(p["tpipe"]._calib_infer, x, None, None, chunk=2)
    vae = p["tpipe"].models.vae
    tot_ours = tot_ref = tot_rtn = 0.0
    n_ch = n_off = n_layers = 0
    for g in ("enc", "dec"):
        for k, r in ref[g].items():
            q = ours[g][k]
            for a, b in ((q.o_scale, r.o_scale), (q.inv_a, r.inv_a)):
                b = np.asarray(b)
                n_ch += b.size
                n_off += int((np.abs(a.numpy() - b) > 1e-4 * np.abs(b)).sum())
            wr = np.asarray(r.w_int8)
            if getattr(q, "kind", None) == "up4x4":
                assert (port_w(q) != wr).sum() <= 1e-3 * wr.size, k
                continue
            weight = vae.get_submodule(k).weight
            H = stats["hess"][g][k]
            assert np.abs(port_w(q).astype(int) - wr).max() <= 4, k
            rtn = (tq.quantize_conv(weight, None, stats[g][k], margin=1.0, **_geometry(k))
                   if weight.ndim == 4 else tq.quantize_dense(weight, None, stats[g][k],
                                                              margin=1.0))
            e_ours = gram_error(weight, q, port_w(q), H)
            e_ref = gram_error(weight, q, wr, H)
            e_rtn = gram_error(weight, q, port_w(rtn), H)
            assert 0.75 <= e_ours / e_ref <= 1.25, (k, e_ours / e_ref)
            assert e_ours < e_rtn, (k, e_ours, e_rtn)
            tot_ours += e_ours
            tot_ref += e_ref
            tot_rtn += e_rtn
            n_layers += 1
    assert n_layers > 20
    assert 0.95 <= tot_ours / tot_ref <= 1.05, tot_ours / tot_ref
    assert tot_ours <= 0.5 * tot_rtn, (tot_ours, tot_rtn)
    assert n_off <= 1e-2 * n_ch, (n_off, n_ch)


def test_gptq_pipeline_matches_jax(gptq_pipes):
    """The calibrating batch is full precision (equal to the port's fp
    pipeline, and to JAX's first batch at the golden bar). The quantized
    batch on JAX's tree (its file) within 1.5e-2 mean of JAX's quantized
    batch, test_torch_quant.py's absolute bar (read 1.18e-2, against JAX's
    int8 error on that tree of 1.52e-2: at these widths an activation code
    flipped across .5 by float rounding moves a layer by a step, as on the
    round-to-nearest path). The port's own GPTQ tree: its int8 deviation
    from full precision within 25% of JAX's own (read 1.38e-2 against
    1.52e-2; its codes move as the tree test says)."""
    p = gptq_pipes
    for a, b in zip(p["t_first"], p["t_fp"]):
        np.testing.assert_array_equal(a, b)
    assert mean_dev(p["t_first"], p["j_first"]) <= 1e-4
    assert mean_dev(p["t_loaded"], p["j_second"]) <= 1.5e-2
    int8_dev = mean_dev(p["t_second"], p["t_fp"])
    j_dev = mean_dev(p["j_second"], p["j_first"])
    assert abs(int8_dev / j_dev - 1.0) <= 0.25, (int8_dev, j_dev)


def test_fake_modes_on_the_pipeline(gptq_pipes):
    """build_single_infer(..., "fake:w" | "fake:a" | "fake:wa") on JAX's
    tree. fake:w rounds no activation, so it meets JAX's fake:w to 1e-4
    mean (read 1.6e-6); fake:wa meets JAX's within the int8 path's bars (an
    activation code across .5 moves a layer by a step, as on the int8
    path: read 9.8e-3 against an int8 error of 1.41e-2), and the port's own
    int8 path within 0.75 of the int8 error (read 9.9e-3); fake:w and
    fake:a each nearer full precision than int8 (read 6.7e-3, 1.25e-2)."""
    from genpercept_tpu.pipeline import PipelineConfig as JCfg
    from genpercept_tpu.pipeline import build_single_infer as j_build
    from genpercept_tpu_torch.pipeline import PipelineConfig, build_single_infer

    p = gptq_pipes
    models = p["loaded"].models
    cfg = PipelineConfig(**GPTQ)
    vq = p["loaded"].vae_quant
    rgb = torch.from_numpy(np.stack(p["images"][:2]).astype(np.float32))
    fp = build_single_infer(models, cfg)(rgb)
    real = build_single_infer(models, cfg, "quant")(rgb, vq)
    fake = {side: build_single_infer(models, cfg, f"fake:{side}")(rgb, vq)
            for side in ("w", "a", "wa")}
    jparams = dict(p["jmodels"].params(), vae_quant=p["jpipe"]._params["vae_quant"])
    jfake = {side: np.asarray(jax.jit(j_build(p["jmodels"], JCfg(**GPTQ), f"fake:{side}"))(
        jparams, jnp.asarray(rgb.numpy()))) for side in ("w", "wa")}

    def dev(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).mean())

    int8_dev = dev(real, fp)
    for side, y in fake.items():
        assert torch.isfinite(y).all() and y.shape == fp.shape
    assert dev(fake["w"], jfake["w"]) <= 1e-4
    assert dev(fake["wa"], jfake["wa"]) <= min(1.5e-2, 0.75 * int8_dev)
    assert dev(fake["wa"], real) <= 0.75 * int8_dev
    assert dev(fake["w"], fp) < int8_dev and dev(fake["a"], fp) < int8_dev


def test_dpt_int8_pipeline_matches_jax(dpt_pipes):
    """int8 on a DPT-head checkpoint: the calibration fills enc and unet and
    leaves dec empty in both packages, through the bias correction and the
    calibration file; the trees to the bars; the self-check ran. The
    prediction on JAX's tree within 1.5e-2 mean of JAX's (read 1.20e-2;
    the per-image min-max of the head output spreads an activation code's
    flip over the image, so the deviation from JAX is as large as the int8
    error itself, 1.29e-2); fake:w, which rounds no activation, within
    1e-4 of JAX's through the same hooks."""
    from genpercept_tpu.pipeline import PipelineConfig as JCfg
    from genpercept_tpu.pipeline import build_single_infer as j_build
    from genpercept_tpu_torch.pipeline import PipelineConfig, build_single_infer

    p = dpt_pipes
    ours, ref = p["tpipe"].vae_quant, p["jpipe"]._params["vae_quant"]
    assert ours["dec"] == {} and ref["dec"] == {}
    assert ours["enc"] and ours["unet"]
    trees_close(ours, ref)
    assert "dec" not in p["loaded"].vae_quant  # the file holds no empty group
    for a, b in zip(p["t_first"], p["t_fp"]):
        np.testing.assert_array_equal(a, b)
    assert p["tpipe"].int8_mean_dev is not None and np.isfinite(p["tpipe"].int8_mean_dev)
    assert mean_dev(p["t_second"], p["t_fp"]) > 0
    assert mean_dev(p["t_loaded"], p["j_second"]) <= 1.5e-2
    rgb = torch.from_numpy(np.stack(p["images"][:2]).astype(np.float32))
    jparams = dict(p["jmodels"].params(), vae_quant=ref)
    jfake = np.asarray(jax.jit(j_build(p["jmodels"], JCfg(**DPT), "fake:w"))(
        jparams, jnp.asarray(rgb.numpy())))
    fake = build_single_infer(p["loaded"].models, PipelineConfig(**DPT), "fake:w")(
        rgb, p["loaded"].vae_quant)
    assert float(np.abs(fake.numpy() - jfake).mean()) <= 1e-4


def test_dpt_calibration_round_trip(dpt_pipes, tmp_path):
    """save_calibration -> load_calibration of a tree with an empty group
    gives the same prediction."""
    from genpercept_tpu_torch.pipeline import GenPerceptPipeline, PipelineConfig

    p = dpt_pipes
    path = tmp_path / "port.npz"
    p["tpipe"].save_calibration(path)
    again = GenPerceptPipeline(p["tpipe"].models, PipelineConfig(**DPT), device="cpu")
    again.load_calibration(path)
    from genpercept_tpu_torch.utils.synthetic import natural_like_images

    images = list(natural_like_images(3, 2, 64))
    for a, b in zip(again.batch(images, batch_size=2), p["tpipe"].batch(images, batch_size=2)):
        np.testing.assert_array_equal(a.pred_np, b.pred_np)
