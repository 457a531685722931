"""Flash attention (non-causal), forward and backward: the Hopper kernels and
their plain versions.

Counterpart of ``genpercept_tpu/ops/flash_attention.py``. Three kernels
replace the TPU's three, and in none do the (Sq x Sk) matrices reach device
memory:

- K1 ``csrc/flash_attn_fwd.cu`` (TPU ``_flash_kernel``), via ``_flash_bhsd``:
  the output and ``lse2``, the base-2 logsumexp of the scaled logits
  (``m*c + log2 l`` with ``c = scale*log2 e``), as the TPU kernel returns.
  f32 inputs take both products on the tensor cores through split TF32
  (three tf32 products each, about f32 accuracy, whatever the TF32 flags of
  ``torch.backends`` say); the plain version stays exact f32. bf16 runs both
  products on ``wgmma`` with K/V brought in by TMA, which needs
  16-byte-aligned tensors (every body reads 16 bytes a thread; the wrappers
  raise on others): at d=64 one warpgroup a 64-row q tile, at d=512 two, S
  split between them by keys and O by columns. Where a d=512 grid would
  leave its last wave of CTAs mostly idle, the key axis is split over up to
  4 CTAs, each writing an f32 partial output and lse2 into scratch that the
  wrapper allocates, and a combine pass in the same call (plain version
  ``_lse_combine_ref``) adds them;
- K3 ``flash_attn_bwd_dq`` and K4 ``flash_attn_bwd_dkv`` in
  ``csrc/flash_attn_bwd.cu`` (TPU ``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``), via ``_flash_bwd_bhsd``: dq, and dk with dv,
  from the saved ``lse2`` and ``dsum = rowsum(dO*O)``; in f32 all of their
  products run through split TF32 as K1's, and the plain version stays
  exact f32; in bf16 at d=64 they run on ``wgmma`` with their tiles (and
  K4's lse2 and dsum) brought by TMA, one warpgroup a 64-row tile;
- K6 ``csrc/flash_attn_int8.cu`` (TPU ``_flash_int8_kernel``), via
  ``_flash_int8_codes``: the inference-only W8A8 attention (section below);
- S1-S4, the profiling scripts' variants of K1 (last section): K1's function
  with a caller-chosen CTA tile (``flash_with_blocks``, ``flash_d512_blocks``),
  a bf16 softmax chain (``flash_bf16_softmax``) and no running max
  (``flash_nomax``).

``flash_attention`` is differentiable: an autograd Function whose forward is
K1 and whose backward is K3 and K4, as the JAX package's ``custom_vjp``.

``supported`` and the block table behind it are the TPU package's, kept so
that the attention routing (``ops/attention.py``) takes the same decisions,
with one narrowing: the kernel is built for the head dims SD2.1 runs (64 in
the UNet, 512 in the VAE mid block), where the TPU package also took 128
and 256. The CUDA kernel tiles on its own and handles ragged lengths by
masking.
"""

from __future__ import annotations

import ctypes

import torch

from genpercept_tpu_torch import _build
from genpercept_tpu_torch.ops import _dispatch

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_KERNEL_D = (64, 512)  # head dims with a kernel body


def _pick_block(s: int, cap: int,
                candidates=(1536, 1152, 1024, 768, 576, 512, 384, 256, 128,
                            64)) -> int | None:
    for b in candidates:
        if b <= cap and s % b == 0:
            return b
    return None


def _blocks(sq: int, sk: int, d: int):
    """The TPU kernel's (q, k) block choice; only ``supported`` reads it."""
    if d <= 128:
        if sk == 2304:
            return _pick_block(sq, 768), sk
        return _pick_block(sq, 1152), _pick_block(sk, 1536)
    return _pick_block(sq, 512), _pick_block(sk, 1536)


def supported(sq: int, sk: int, d: int) -> bool:
    """The TPU package's predicate for shapes flash_attention takes, on the
    head dims of ``_KERNEL_D``."""
    if d not in _KERNEL_D:
        return False
    q_blk, k_blk = _blocks(sq, sk, d)
    if k_blk is None:
        q_blk, k_blk = _blocks(sq, max(128, -(-sk // 128) * 128), d)
    return q_blk is not None and k_blk is not None


def _to_bhsd(x: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    if h == 1:
        return x.reshape(b, s, d)
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _from_bhsd(x: torch.Tensor, b: int, s: int, h: int, d: int) -> torch.Tensor:
    if h == 1:
        return x.reshape(b, s, 1, d)
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _flash_bhsd_ref(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    scale: float):
    """Plain version of the kernel: the same function in one softmax pass.

    Logits in f32 (bf16 products are exact in f32), the max on raw logits,
    p rounded to v's dtype, l the sum of the rounded p. Returns
    (out (BH, Sq, D) in q's dtype, lse2 (BH, Sq, 1) f32)."""
    c = scale * _LOG2E
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s * c - m * c).to(vh.dtype).float()
    del s
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vh.float()) / l).to(qh.dtype)
    return out, m * c + torch.log2(l)


def _lse_combine_ref(o_parts: torch.Tensor, lse_parts: torch.Tensor,
                     dtype: torch.dtype):
    """Plain version of K1's combine pass over key splits: o_parts (S, BH, Sq,
    D) f32, each split's output normalized by its own l, and lse_parts (S, BH,
    Sq, 1) its lse2 -> (out in dtype, lse2), lse2 = log2 sum_z 2^lse2_z and
    out = sum_z 2^(lse2_z - lse2) o_z."""
    mx = lse_parts.amax(dim=0)
    w = torch.exp2(lse_parts - mx)
    total = w.sum(dim=0)
    return ((w / total) * o_parts).sum(dim=0).to(dtype), mx + torch.log2(total)


def _check_kernel_args(name: str, qh: torch.Tensor, kh: torch.Tensor,
                       *rest: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return the dtype code. ``rest``
    holds tensors shaped as v (first) and then as q."""
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    code = _dispatch.dtype_code(qh, name)
    if d not in _KERNEL_D:
        raise ValueError(f"{name}: no kernel for head dim {d}")
    shapes = [kh.shape, rest[0].shape] + [x.shape for x in rest[1:]]
    if shapes != [(bh, sk, d)] * 2 + [(bh, sq, d)] * (len(rest) - 1):
        raise ValueError(f"{name}: shapes {qh.shape} {shapes}")
    if any(x.dtype != qh.dtype or x.device != qh.device for x in (kh, *rest)):
        raise ValueError(f"{name}: inputs differ in dtype or device")
    return code


def _check_aligned(name: str, *xs: torch.Tensor) -> None:
    """Raise unless every tensor starts on 16 bytes: the kernels read 16
    bytes a thread, and TMA (K1's bf16 body at d=64) takes no other base."""
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{name}: the kernels take 16-byte-aligned tensors only")


def _flash_bhsd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                scale: float, kv_valid: int | None = None):
    """K1. qh: (BH, Sq, D); kh/vh: (BH, Sk, D) -> (out, lse2).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if kv_valid is not None:
        raise NotImplementedError("kv_valid masking is not ported yet")
    if not _dispatch.use_kernel(qh):
        return _flash_bhsd_ref(qh, kh, vh, scale)
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    code = _check_kernel_args("flash_attention", qh, kh, vh)
    qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
    _check_aligned("flash_attention", qh, kh, vh)
    out = torch.empty_like(qh)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=qh.device)
    lib = _build.load()
    # the bf16 d=512 body's key splits keep partial outputs here
    nbytes = lib.flash_attn_fwd_scratch_bytes(bh, sq, sk, d, code)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=qh.device) if nbytes else None
    err = lib.flash_attn_fwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if scratch is None else scratch.data_ptr(), bh, sq, sk, d,
        ctypes.c_float(scale), code, _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_fwd")
    _flash_bhsd.launches += 1
    return out, lse


_flash_bhsd.launches = 0


def _flash_bwd_bhsd_ref(qh, kh, vh, do, lse, dsum, scale: float):
    """Plain version of K3 and K4: the same math in one pass over full
    matrices, with the kernels' rounding points. P and dP in f32; dS rounded
    to k's dtype for dq and to q's dtype for dk; P rounded to dO's dtype for
    dv; f32 accumulates, outputs in the input dtypes. Returns (dq, dk, dv)."""
    c = scale * _LOG2E
    qf, kf, vf, dof = qh.float(), kh.float(), vh.float(), do.float()
    p = torch.exp2(torch.matmul(qf, kf.transpose(1, 2)) * c - lse)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - dsum) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), dof).to(vh.dtype)
    del p
    dq = torch.matmul(ds.to(kh.dtype).float(), kf).to(qh.dtype)
    dk = torch.matmul(ds.to(qh.dtype).float().transpose(1, 2), qf).to(kh.dtype)
    return dq, dk, dv


def _flash_bwd_dq(qh, kh, vh, do, lse, dsum, scale: float) -> torch.Tensor:
    """K3 on CUDA tensors: dq (BH, Sq, D)."""
    bh, sq, d = qh.shape
    code = _check_kernel_args("flash_attn_bwd_dq", qh, kh, vh, do)
    _check_aligned("flash_attn_bwd_dq", qh, kh, vh, do)
    dq = torch.empty_like(qh)
    err = _build.load().flash_attn_bwd_dq(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), bh, sq, kh.shape[1], d,
        ctypes.c_float(scale), code, _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_bwd_dq")
    _flash_bwd_dq.launches += 1
    return dq


def _flash_bwd_dkv(qh, kh, vh, do, lse, dsum, scale: float):
    """K4 on CUDA tensors: (dk, dv), each (BH, Sk, D)."""
    bh, sq, d = qh.shape
    code = _check_kernel_args("flash_attn_bwd_dkv", qh, kh, vh, do)
    _check_aligned("flash_attn_bwd_dkv", qh, kh, vh, do)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    err = _build.load().flash_attn_bwd_dkv(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq, kh.shape[1], d,
        ctypes.c_float(scale), code, _dispatch.stream_handle(qh))
    _build.check(err, "flash_attn_bwd_dkv")
    _flash_bwd_dkv.launches += 1
    return dk, dv


_flash_bwd_dq.launches = 0
_flash_bwd_dkv.launches = 0


def _flash_bwd_bhsd(qh, kh, vh, oh, do, lse, scale: float):
    """Backward of ``_flash_bhsd`` from its saved output and lse2: dsum in
    f32 plain torch (as JAX computes it outside its Pallas calls), then K3
    and K4 on CUDA tensors or the plain version on CPU ones. -> (dq, dk, dv)."""
    dsum = (do.float() * oh.float()).sum(dim=-1, keepdim=True)
    if not _dispatch.use_kernel(qh):
        return _flash_bwd_bhsd_ref(qh, kh, vh, do, lse, dsum, scale)
    qh, kh, vh, do = qh.contiguous(), kh.contiguous(), vh.contiguous(), do.contiguous()
    lse = lse.contiguous()
    dq = _flash_bwd_dq(qh, kh, vh, do, lse, dsum, scale)
    dk, dv = _flash_bwd_dkv(qh, kh, vh, do, lse, dsum, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(B, S, H, D) flash attention: K1 forward, K3 and K4 backward. Saves
    q, k, v in the (BH, S, D) layout, the output and lse2."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        b, sq, h, d = q.shape
        sk = k.shape[1]
        qh, kh, vh = (_to_bhsd(x, b, s, h, d) for x, s in ((q, sq), (k, sk), (v, sk)))
        out, lse = _flash_bhsd(qh, kh, vh, scale)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.scale, ctx.dims = scale, (b, sq, sk, h, d)
        return _from_bhsd(out, b, sq, h, d)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        b, sq, sk, h, d = ctx.dims
        dq, dk, dv = _flash_bwd_bhsd(qh, kh, vh, out, _to_bhsd(g, b, sq, h, d), lse,
                                     ctx.scale)
        return (_from_bhsd(dq, b, sq, h, d), _from_bhsd(dk, b, sk, h, d),
                _from_bhsd(dv, b, sk, h, d), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) -> (B, Sq, H, D). Differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not supported(sq, sk, d):
        raise ValueError(f"flash_attention unsupported shape {(sq, sk, d)}")
    return FlashAttention.apply(q, k, v, scale)


# ------------------------------------------- int8 forward (d=512 and 64)
#
# K6 ``csrc/flash_attn_int8.cu`` replaces the TPU kernel _flash_int8_kernel
# (reached through _flash_int8_bhsd). q and k arrive as int8 with per-row f32
# scales, v as int8 with per-column scales, quantized here in torch as the
# JAX package does in XLA. Per k block of the TPU kernel's partition
# (``_blocks(sq, sk, d)[1]``): logits s32 * (qs * ks), the base-2 online
# softmax, pq = round(p * 127) as int8 against the running max at the end of
# the block, the same pq into PV (int32) and into the row sum; out =
# acc * vs / l. Because pq is rounded against the max of a whole block, the
# result depends on the block partition, and kernel and plain version take
# the TPU's. d=512 is the VAE mid block's head; d=64 is the UNet's, which
# only scripts/profile_unet_torch.py runs through K6.

# the longest k block each body takes (None: any multiple of 64 that divides
# Sk): both wgmma bodies run a max pass and a recompute per block, so no
# buffer of a block's logits bounds its length
_INT8_MAX_K_BLK = {64: None, 512: None}


def _rowq(x: torch.Tensor, dim: int):
    """Symmetric int8 along ``dim`` (per row: -1; per column of v: 1) ->
    (codes, f32 scales with ``dim`` kept)."""
    xf = x.float()
    s = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8), s


def _int8_k_block(sq: int, sk: int, d: int) -> int:
    k_blk = _blocks(sq, sk, d)[1]
    if k_blk is None:
        raise ValueError(f"flash_attention_int8: no k block for {(sq, sk, d)}")
    return k_blk


def _flash_int8_ref(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6: the TPU kernel's per-block steps on whole
    (Sq, k_blk) blocks, int32 products on torch._int_mm. q8/k8/v8 (BH, S, D)
    int8, qs (BH, Sq, 1), ks (BH, Sk, 1), vs (BH, 1, D) f32 -> (BH, Sq, D)."""
    from genpercept_tpu_torch.ops.quant import int8_matmul

    bh, sq, d = q8.shape
    c = scale * _LOG2E
    out = torch.empty((bh, sq, d), dtype=dtype, device=q8.device)
    for b in range(bh):
        m = torch.full((sq, 1), -1e30, device=q8.device)
        acc = torch.zeros((sq, d), device=q8.device)
        l = torch.zeros((sq, 1), device=q8.device)
        for k0 in range(0, k8.shape[1], k_blk):
            s32 = int8_matmul(q8[b], k8[b, k0:k0 + k_blk])
            s = s32.float() * (qs[b] * ks[b, k0:k0 + k_blk, 0][None, :])
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pq = torch.round(torch.exp2(s * c - m_new * c) * 127.0).to(torch.int8)
            alpha = torch.exp2((m - m_new) * c)
            m = m_new
            pv = int8_matmul(pq, v8[b, k0:k0 + k_blk].t().contiguous())
            acc = acc * alpha + pv.float()
            l = l * alpha + pq.float().sum(dim=-1, keepdim=True)
        out[b] = (acc * vs[b] / l).to(dtype)
    return out


def int8_operands(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor):
    """K6's operands, quantized in torch as the JAX package does in XLA:
    q and k per row, v per column -> (q8, k8, v8, qs, ks, vs)."""
    q8, qs = _rowq(qh, -1)
    k8, ks = _rowq(kh, -1)
    v8, vs = _rowq(vh, 1)
    return q8, k8, v8, qs, ks, vs


def _int8_vt(v8: torch.Tensor) -> torch.Tensor:
    """(BH, Sk, D) int8 v -> (BH, D, Sk) V^T, PV's B operand, k-major. At d=64
    each 32 keys come in the order the d=64 body holds P in its registers
    (csrc/flash_attn_int8.cu, the d = 64 note): key 16h + 8u + 2t + e at
    position 16h + 4t + 2u + e. One copy either way."""
    bh, sk, d = v8.shape
    if d != 64:
        return v8.transpose(1, 2).contiguous()
    return (v8.reshape(bh, sk // 32, 2, 2, 4, 2, d).permute(0, 6, 1, 2, 4, 3, 5)
            .reshape(bh, d, sk))


def _flash_int8_codes(q8, k8, v8, qs, ks, vs, scale: float, k_blk: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """K6 on int8 operands (see _flash_int8_ref) -> (BH, Sq, D) in dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(q8):
        return _flash_int8_ref(q8, k8, v8, qs, ks, vs, scale, k_blk, dtype)
    bh, sq, d = q8.shape
    sk = k8.shape[1]
    code = _dispatch.dtype_code(dtype, "flash_attention_int8")
    cap = _INT8_MAX_K_BLK.get(d, 0)
    if (d not in _INT8_MAX_K_BLK or k_blk <= 0 or k_blk % 64 or sk % k_blk
            or (cap is not None and k_blk > cap)
            or k8.shape != (bh, sk, d) or v8.shape != (bh, sk, d)
            or qs.shape != (bh, sq, 1) or ks.shape != (bh, sk, 1) or vs.shape != (bh, 1, d)
            or any(t.dtype != torch.int8 for t in (q8, k8, v8))
            or any(t.dtype != torch.float32 for t in (qs, ks, vs))
            or any(t.device != q8.device for t in (k8, v8, qs, ks, vs))):
        raise ValueError(f"flash_attention_int8: no kernel for q {tuple(q8.shape)}, "
                         f"k {tuple(k8.shape)}, v {tuple(v8.shape)}, k block {k_blk}")
    q8, k8, qs, ks, vs = (t.contiguous() for t in (q8, k8, qs, ks, vs))
    vt = _int8_vt(v8)
    out = torch.empty((bh, sq, d), dtype=dtype, device=q8.device)
    lib = _build.load()
    # the d=512 body parks its f32 running output here between k blocks
    # where the output is bf16 (an f32 output holds it in place)
    n = lib.flash_attn_int8_scratch_bytes(bh, sq, sk, d, k_blk, code)
    scratch = torch.empty(n, dtype=torch.uint8, device=q8.device) if n else None
    err = lib.flash_attn_int8(
        q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        bh, sq, sk, d, k_blk, ctypes.c_float(scale * _LOG2E), code,
        _dispatch.stream_handle(q8))
    _build.check(err, "flash_attn_int8")
    _flash_int8_codes.launches += 1
    return out


_flash_int8_codes.launches = 0


def _flash_int8_bhsd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """qh: (BH, Sq, D), kh/vh: (BH, Sk, D) float -> (BH, Sq, D) in qh's
    dtype: the operands quantized, then K6 with the TPU's k-block partition."""
    k_blk = _int8_k_block(qh.shape[1], kh.shape[1], qh.shape[2])
    return _flash_int8_codes(*int8_operands(qh, kh, vh), scale, k_blk, qh.dtype)


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """Inference-only int8 flash attention, (B, S, H, D) in and out: the
    VAE mid block's one head of d=512, or heads of d=64."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = _flash_int8_bhsd(_to_bhsd(q, b, sq, h, d), _to_bhsd(k, b, sk, h, d),
                           _to_bhsd(v, b, sk, h, d), scale)
    return _from_bhsd(out, b, sq, h, d)


# ------------------------------- S1-S4: the attention profiling scripts' kernels
#
# scripts/profile_unet.py and scripts/profile_attn_boundary.py run four more
# Pallas kernels, each a variant of K1's, out only, bf16. On the card all four
# run on K1's own wgmma bodies (csrc/flash_attn_fwd.cu), instantiated at the
# CTA tiles below with a softmax step and a row sum of their own:
#
# - S1 (profile_unet.py ``flash_with_blocks``) and S3 (profile_attn_boundary.py
#   part "sweep512" ``build``): K1's function with caller-chosen blocks and
#   the row sum folded into PV (an appended ones-column) or summed apart;
#   S1 folds where d <= 128, S3 takes either. ``flash_attn_fwd_tiled`` runs
#   them, ``fold`` choosing between a ones n-tile beside the PV product and
#   per-thread sums. The TPU swept VMEM blocks of 256-9216 query rows; a CTA
#   holds 64-128 (one or two consumer warpgroups of 64 rows at d=64, two
#   warpgroups on 64 rows at d=512), so the port's sweep is over the tiles its
#   bodies take, and each set holds the tile K1 launches (``K1_TILES``): at
#   d=512 without the fold, S1 and S3 there are K1's own launch, key splits
#   and combine pass included.
#   Plain version: ``_flash_bhsd_ref``, as K1's: p rounded against the row's
#   global max where the kernels round it against the running max, a
#   difference of bf16 rounding that K1's bounds already admit.
# - S2 (profile_unet.py part "bf16softmax" ``kernel_bf``): the softmax chain
#   in bf16 (csrc/flash_attn_fwd.cu ``flash_bf16_softmax``); p is
#   rounded against the running max, so the plain version takes the key
#   partition: the TPU's k block on the CPU, the CUDA key tile on the card.
# - S4 (profile_attn_boundary.py part "nomax" ``kernel``): no running max,
#   p = bf16(exp2(min(s*c, 110))) (``flash_nomax``).

D64_TILES = ((64, 32), (64, 64), (64, 128), (128, 64), (128, 128))  # (query rows, keys)
D512_TILES = ((64, 64), (64, 128))
# the tile K1 launches at each head dim (dispatch_bf16_d64, dispatch_bf16_d512)
K1_TILES = {64: (64, 128), 512: (64, 128)}


def _check_tiled(name: str, qh, kh, vh, tiles, bq: int, bk: int) -> None:
    """Raise unless the kernel takes these bf16 tensors at tile (bq, bk)."""
    if _check_kernel_args(name, qh, kh, vh) != 1:
        raise ValueError(f"{name}: the kernel is bf16 only, got {qh.dtype}")
    if (bq, bk) not in tiles:
        raise ValueError(f"{name}: no kernel at tile {(bq, bk)} for head dim "
                         f"{qh.shape[2]}; tiles {tiles}")


def _launch_tiled(entry: str, qh, kh, vh, scale: float, *tail,
                  with_lse: bool = False) -> torch.Tensor:
    """Launch a tiled bf16 entry point of the kernel library -> out; with_lse:
    the entry also writes lse2, into a buffer dropped here, and takes the
    scratch of K1's key splits (``flash_attn_fwd_tiled``)."""
    bh, sq, d = qh.shape
    sk = kh.shape[1]
    qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
    _check_aligned(entry, qh, kh, vh)
    out = torch.empty_like(qh)
    lib = _build.load()
    head = [qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr()]
    if with_lse:
        lse = torch.empty((bh, sq), dtype=torch.float32, device=qh.device)
        nbytes = lib.flash_attn_fwd_scratch_bytes(bh, sq, sk, d, 1)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=qh.device) if nbytes else None
        head += [lse.data_ptr(), None if scratch is None else scratch.data_ptr()]
    err = getattr(lib, entry)(
        *head, bh, sq, sk, d, ctypes.c_float(scale), *tail,
        _dispatch.stream_handle(qh))
    _build.check(err, entry)
    return out


def _flash_tiled(counter, qh, kh, vh, scale: float, bq: int, bk: int,
                 fold: bool) -> torch.Tensor:
    d = qh.shape[2]
    tiles = D64_TILES if d == 64 and fold else D512_TILES if d == 512 else ()
    _check_tiled(counter.__name__, qh, kh, vh, tiles, bq, bk)
    out = _launch_tiled("flash_attn_fwd_tiled", qh, kh, vh, scale, bq, bk, int(fold),
                        with_lse=True)
    counter.launches += 1
    return out


def flash_with_blocks(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      scale: float, bq: int, bk: int) -> torch.Tensor:
    """S1: K1's function at CTA tile (bq, bk), the row sum folded into PV
    where d <= 128, as the TPU script's; (BH, S, D) bf16 in, out only.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not _dispatch.use_kernel(qh):
        return _flash_bhsd_ref(qh, kh, vh, scale)[0]
    return _flash_tiled(flash_with_blocks, qh, kh, vh, scale, bq, bk, qh.shape[2] <= 128)


def flash_d512_blocks(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      scale: float, bq: int, bk: int, fold: bool) -> torch.Tensor:
    """S3: K1's function at d=512 and CTA tile (bq, bk), the row sum folded
    into PV or not; (BH, S, 512) bf16 in, out only."""
    if not _dispatch.use_kernel(qh):
        return _flash_bhsd_ref(qh, kh, vh, scale)[0]
    if qh.shape[2] != 512:
        raise ValueError(f"flash_d512_blocks: head dim {qh.shape[2]} is not 512")
    return _flash_tiled(flash_d512_blocks, qh, kh, vh, scale, bq, bk, fold)


flash_with_blocks.launches = 0
flash_d512_blocks.launches = 0


def _flash_bf16_softmax_ref(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                            scale: float, k_blk: int) -> torch.Tensor:
    """Plain version of S2 over key blocks of k_blk: logits rounded to bf16
    once, c, the running max and p = exp2((s - m) * c) in bf16, one rounding
    per operation. JAX's exp2 of a bf16 x is exp(bf16(ln 2) * x) with the
    product rounded to bf16 (ln 2 rounds to 0.6914), the exponential taken
    in f32 and rounded; so is it here. alpha = exp2 in f32 of the bf16
    (m_prev - m_new) * c; PV and the row sum of the bf16 p accumulated in
    f32."""
    bf = torch.bfloat16
    bh, sq, d = qh.shape
    dev = qh.device
    c = torch.tensor(scale * _LOG2E, dtype=bf, device=dev)
    ln2 = torch.tensor(_LN2, dtype=bf, device=dev)
    qf = qh.float()
    m = torch.full((bh, sq, 1), -1e30, dtype=bf, device=dev)
    acc = torch.zeros((bh, sq, d), device=dev)
    l = torch.zeros((bh, sq, 1), device=dev)
    for k0 in range(0, kh.shape[1], k_blk):
        s = torch.matmul(qf, kh[:, k0:k0 + k_blk].float().transpose(1, 2)).to(bf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(((s - m_new) * c * ln2).float()).to(bf).float()
        alpha = torch.exp2(((m - m_new) * c).float())
        m = m_new
        acc = acc * alpha + torch.matmul(p, vh[:, k0:k0 + k_blk].float())
        l = l * alpha + p.sum(dim=-1, keepdim=True)
    return (acc / l).to(qh.dtype)


def flash_bf16_softmax(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                       scale: float, bq: int, bk: int) -> torch.Tensor:
    """S2 at CTA tile (bq, bk) (one of D64_TILES): (BH, S, 64) bf16 -> out.
    CPU tensors take the plain version with key blocks of bk."""
    if not _dispatch.use_kernel(qh):
        return _flash_bf16_softmax_ref(qh, kh, vh, scale, bk)
    _check_tiled("flash_bf16_softmax", qh, kh, vh, D64_TILES if qh.shape[2] == 64 else (), bq, bk)
    out = _launch_tiled("flash_bf16_softmax", qh, kh, vh, scale, bq, bk)
    flash_bf16_softmax.launches += 1
    return out


def _flash_nomax_ref(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Plain version of S4: p = exp2(min(s*c, 110)) rounded to v's dtype,
    out = (p.v) / sum(p), f32 logits and sums."""
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2))
    p = torch.exp2(torch.clamp(s * (scale * _LOG2E), max=110.0)).to(vh.dtype).float()
    del s
    return (torch.matmul(p, vh.float()) / p.sum(dim=-1, keepdim=True)).to(qh.dtype)


def flash_nomax(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, scale: float,
                bq: int, bk: int) -> torch.Tensor:
    """S4 at CTA tile (bq, bk) (one of D64_TILES): (BH, S, 64) bf16 -> out.
    CPU tensors take the plain version."""
    if not _dispatch.use_kernel(qh):
        return _flash_nomax_ref(qh, kh, vh, scale)
    _check_tiled("flash_nomax", qh, kh, vh, D64_TILES if qh.shape[2] == 64 else (), bq, bk)
    out = _launch_tiled("flash_nomax", qh, kh, vh, scale, bq, bk)
    flash_nomax.launches += 1
    return out


flash_bf16_softmax.launches = 0
flash_nomax.launches = 0
