"""PyTorch port, K3 (the LinearAttention backward) against the JAX package
on the CPU: the numerics of its bf16 tensor-core body emulated in torch,
the routing of shapes past K1's and K3's limits, and a U-Net whose widths
the kernels do not take, whose gradients must match ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointreggpt_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from pointreggpt_tpu.models import DiffusionUNet as JDiffusionUNet
from pointreggpt_tpu.ops import linear_attention as JLA
from test_torch_port_generator import single_torch_thread  # noqa: F401
from pointreggpt_tpu_torch.diffusion import GaussianDiffusion
from pointreggpt_tpu_torch.models import DiffusionUNet
from pointreggpt_tpu_torch.ops import linear_attention as K1
from pointreggpt_tpu_torch.utils import jax_params

HEADS, D = 4, 32
HID = HEADS * D
NAMES = ("dx_q", "dx_kv", "dw_qkv", "dw_out", "db_out", "dg")
TM = 64  # rows per tile of the bf16 kernels


def _r(t):
    """Rounded to bf16, kept in fp32."""
    return t.to(torch.bfloat16).float()


def _blockdiag(t):
    """(b, 128, 128) -> the four 32 x 32 head blocks, zeros elsewhere."""
    return t * torch.block_diag(*[torch.ones(D, D)] * HEADS)


def _k3_tensor_core(x, dy, w_qkv, w_out, b_out, g, eps):
    """K3's bf16 body as it computes, emulated in torch on the CPU: bf16
    operands into fp32 sums; k/v statistics per split of 64-row tiles with
    a running max (K1's kernel A, exp(k - m) rounded at the tile's max);
    the q path's roundings (q, q~, core, pre + bias, dpre, dcore, dq~, dq,
    dx_q); the dC^ partial of each split summed in split order and rounded
    once; dC entering v dC^T and exp(k - m) dC as a bf16 high plus low
    part; dk, dv and dx_kv rounded; the weight gradients in fp32."""
    b, n, c = x.shape
    xf, dyf = x.float(), dy.float()
    wq, wkv = _r(w_qkv[:, :HID]), _r(w_qkv[:, HID:])
    wo = _r(w_out)
    splits, per = K1._splits(b, n, TM)
    scale = D**-0.5 / n

    kv = _r(xf @ wkv)
    k, v = kv[..., :HID], kv[..., HID:]
    # kernel A per split, merged with max-rescaling
    ms, ss, cs = [], [], []
    for sp in range(splits):
        m = torch.full((b, HID), -torch.inf)
        s, cacc = torch.zeros(b, HID), torch.zeros(b, HID, HID)
        for r0 in range(sp * per, min(n, (sp + 1) * per), TM):
            kt, vt = k[:, r0:r0 + TM], v[:, r0:r0 + TM]
            m_new = torch.maximum(m, kt.amax(1))
            al = torch.exp(m - m_new)
            ek = torch.exp(kt - m_new[:, None])
            s = s * al + ek.sum(1)
            cacc = cacc * al[..., None] + _blockdiag(
                _r(ek).transpose(1, 2) @ vt)
            m = m_new
        ms.append(m), ss.append(s), cs.append(cacc)
    m = torch.stack(ms).amax(0)
    w = [torch.exp(mi - m) for mi in ms]
    s = sum(si * wi for si, wi in zip(ss, w))
    cmat = sum(ci * wi[..., None] for ci, wi in zip(cs, w))
    chat = _r(cmat * scale / s.clamp_min(1e-30)[..., None])

    # q path
    q = _r(xf @ wq).unflatten(-1, (HEADS, D))
    qs = torch.softmax(q, -1).flatten(-2)
    core = _r(_r(qs) @ chat)
    pre = _r(_r(core @ wo) + _r(b_out))
    mean = pre.mean(-1, keepdim=True)
    inv = torch.rsqrt(((pre - mean)**2).mean(-1, keepdim=True) + eps)
    xh = (pre - mean) * inv
    dxh = dyf * g
    dpre = _r(inv * (dxh - dxh.mean(-1, keepdim=True) -
                     xh * (dxh * xh).mean(-1, keepdim=True)))
    dcore = _r(dpre @ wo.T)
    part = [_r(qs[:, sp * per:(sp + 1) * per]).transpose(1, 2)
            @ dcore[:, sp * per:(sp + 1) * per] for sp in range(splits)]
    dchat = _r(_blockdiag(sum(part)))
    dqs = _r(dcore @ chat.transpose(1, 2)).unflatten(-1, (HEADS, D))
    qsh = qs.unflatten(-1, (HEADS, D))
    dq = _r(qsh * (dqs - (dqs * qsh).sum(-1, keepdim=True))).flatten(-2)
    dx_q = _r(dq @ wq.T)

    # fold, then the kv path
    dc = dchat * scale / s[..., None]
    ds = -(dchat * cmat).sum(-1) * scale / s**2
    hi = _r(dc)
    dc2 = hi + _r(dc - hi)
    ek = torch.exp(k - m[:, None])
    dk = _r(ek * (_r(v @ dc2.transpose(1, 2)) + ds[:, None]))
    dv = _r(_r(ek) @ dc2)
    dkv = torch.cat([dk, dv], -1)
    dx_kv = _r(dkv @ wkv.T)

    rows = lambda t: t.reshape(b * n, -1)
    dw_qkv = rows(xf).T @ torch.cat([rows(dq), rows(dkv)], -1)
    dw_out = rows(core).T @ rows(dpre)
    dg = (dyf * xh).sum((0, 1))
    db = dpre.sum((0, 1))
    return dx_q, dx_kv, dw_qkv, dw_out, db, dg


def _np(t):
    """A torch tensor or JAX array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _rel(got, ref):
    """max |got - ref| / max |ref|, ref brought to got's shape."""
    got, ref = _np(got), _np(ref).reshape(np.shape(got))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# The card's K3 check bound in bf16: max |got - ref| / max |ref| per output
K3_BF16_RTOL = 3e-2


@pytest.mark.parametrize("c,n,b", [(64, 256, 2), (2048, 128, 1)])
def test_k3_tensor_core_numerics_match_pallas_and_xla(c, n, b):
    # the bf16 design's roundings and sum order against the JAX package's
    # Pallas backward (interpret mode) and XLA's vjp of _xla_fused, both
    # in bf16 on the same bf16 inputs, and against the plain version: the
    # design fits the card's bound before any card run
    args = K1.check_inputs_bwd(b, n, c, torch.bfloat16, "cpu")
    eps = 1e-3
    got = _k3_tensor_core(*args, eps)
    j = [jnp.asarray(_np(a)).astype(jnp.bfloat16 if a.dtype == torch.bfloat16
                                    else jnp.float32) for a in args]
    pallas = JLA._pallas_fused_bwd(*j, HEADS, D, eps, interpret=True)
    _, vjp = jax.vjp(lambda *a: JLA._xla_fused(*a, HEADS, D, eps),
                     j[0], *j[2:])
    xla = vjp(j[1])
    plain = K1.fused_linear_attention_bwd_plain(*args, eps=eps)
    for i, name in enumerate(NAMES):
        for ref_name, ref in (("pallas", pallas[i]), ("plain", plain[i])):
            err = _rel(got[i], ref)
            assert err <= K3_BF16_RTOL, (name, ref_name, err)
    # XLA's vjp gives dx whole
    assert _rel(got[0] + got[1], xla[0]) <= K3_BF16_RTOL
    for i, name in enumerate(NAMES[2:]):
        err = _rel(got[i + 2], xla[i + 1])
        assert err <= K3_BF16_RTOL, (name, "xla", err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,takes", [(36, None), (64, True), (1024, True),
                                     (2048, True), (2056, False)])
def test_k1_and_k3_take_what_the_jax_dispatch_sends_to_pallas(dtype, c,
                                                               takes):
    # c <= 2048 in both types, and c % 8 == 0 in bf16 (36 runs the kernel
    # in fp32 only); past that the plain version runs, as XLA does for JAX
    want = (dtype == torch.float32) if takes is None else takes
    assert K1._k1_takes(dtype, c) is want
    assert K1._k3_takes(dtype, c) is want


H = 32
LOSS_KW = dict(image_size=H, timesteps=1000, loss_type="l1",
               objective="pred_x0", beta_schedule="sigmoid")


def test_unet_at_widths_the_kernels_refuse_matches_jax_grad():
    # dim 36 with 4 GroupNorm groups: LinearAttention at c = 36 and 72,
    # which K1 and K3 do not take in bf16 (c % 8 != 0 for 36); on a CPU
    # tensor the whole net runs the plain versions, and its loss gradients
    # match jax.grad (fp32; the bound of test_torch_port_train.py)
    jm = JDiffusionUNet(dim=36, dim_mults=(1, 2), resnet_block_groups=4)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05
                   ).astype(np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, H, 1)),
                         jnp.zeros((1,)), jnp.zeros((1, 4))))
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-1, 1, (2, H, H, 1)).astype(np.float32)
    noise = rng.normal(size=(2, H, H, 1)).astype(np.float32)
    t = np.array([40, 730], np.int32)
    pc = rng.uniform(100, 600, (2, 4)).astype(np.float32)
    jd = JGaussianDiffusion(apply_fn=lambda p, x, tt, cc: jm.apply(p, x, tt,
                                                                   cc),
                            **LOSS_KW)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.p_losses(p, None, x0, t, pc, noise=noise)))(params)
    ref = jax_params.diffusion_unet_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_grads))

    net = DiffusionUNet(dim=36, dim_mults=(1, 2), resnet_block_groups=4)
    net.load_state_dict(jax_params.diffusion_unet_from_jax(params, net))
    net = net.to(memory_format=torch.channels_last)
    before = (K1.fused_linear_attention.launches,
              K1.fused_linear_attention_bwd.launches,
              K1.fused_linear_attention.plain_routes,
              K1.fused_linear_attention_bwd.plain_routes)
    loss = GaussianDiffusion(**LOSS_KW).p_losses(
        net, torch.from_numpy(x0), torch.from_numpy(t).long(),
        torch.from_numpy(pc), noise=torch.from_numpy(noise))
    loss.backward()
    # a CPU tensor is no route: the counters count card calls only
    assert (K1.fused_linear_attention.launches,
            K1.fused_linear_attention_bwd.launches,
            K1.fused_linear_attention.plain_routes,
            K1.fused_linear_attention_bwd.plain_routes) == before
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=1e-6)
    for name, prm in net.named_parameters():
        r = ref[name].numpy()
        atol = 2e-4 * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(prm.grad.numpy(), r, atol=atol,
                                   rtol=1e-3, err_msg=name)
