"""PTv3's patch attention (``ops/patch_attention.py``): the plain versions on
the CPU, and the kernels of ``csrc/patch_attention.cu`` on the card.

On the CPU: the plain backward, written from the output, the rows'
log-sum-exp and ``D = rowsum(dO o)`` as the kernels compute it, equals
autograd through an explicit softmax in f64 (ragged K included); the
autograd function counts one ``launch.patch_attention`` a call and no kernel
launch; blocks of
patches do not change a bit; the kernels' operand check refuses any head
dimension but 16 and any operand they cannot read.

On the card (``-m cuda``; this module imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_patch_attention.py

the kernels at the main path's shapes (K = 1024, H in {2, 32}, P in {1, 40})
and at ragged K (37, 1000): o, lse, dq, dk and dv no further from the plain
version in f64 than 4 times the f32 plain version plus 1e-6 of the abs-sum
(``chip_smoke.attention_abs_sums``; for lse, of |lse|), the gate of the conv
kernels: split-TF32 scores are further from f64 than f32 FMA dot products,
2-7x in dq, dk and dv at these shapes, so the abs-sum term carries part of
the gate there; two forwards and two backwards
from one state bit-equal (no float atomics), one ``launch.attn_fwd`` a
forward and two ``launch.attn_bwd`` a backward (its two kernels).
"""

import pytest
import torch

from lidal_tpu_torch.ops import patch_attention as pa
from lidal_tpu_torch.utils import profiling


def _inputs(p, h, kk, d=16, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(p, h, kk, d, generator=g, dtype=torch.float64) * s for s in (1.5, 1.5, 1.0, 1.0))
    return [x.to(dtype=dtype, device=device) for x in (q, k, v, do)]


def _explicit(q, k, v):
    s = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("kk", [1, 7, 37, 64])
def test_plain_backward_equals_autograd_in_f64(kk):
    q, k, v, do = _inputs(2, 3, kk, dtype=torch.float64)
    o, lse = pa.patch_attention_plain(q, k, v)
    s = (q @ k.transpose(-2, -1)) * 0.25
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0, atol=1e-12)
    got = pa.patch_attention_backward_plain(q, k, v, o, lse, do)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want_o = _explicit(*leaves)
    torch.testing.assert_close(o, want_o.detach(), rtol=0, atol=1e-12)
    want = torch.autograd.grad(want_o, leaves, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * max(1.0, float(b.abs().max())))


def test_autograd_function_counts_and_matches_explicit_softmax():
    q, k, v, do = _inputs(3, 2, 37)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = {n: profiling.counter(n) for n in ("launch.patch_attention", "launch.attn_fwd", "launch.attn_bwd")}
    o = pa.patch_attention(*leaves)
    got = torch.autograd.grad(o, leaves, do)
    after = {n: profiling.counter(n) - before[n] for n in before}
    assert after == {"launch.patch_attention": 1, "launch.attn_fwd": 0, "launch.attn_bwd": 0}  # no kernel on the CPU
    ref = [x.double().requires_grad_(True) for x in (q, k, v)]
    want_o = _explicit(*ref)
    want = torch.autograd.grad(want_o, ref, do.double())
    torch.testing.assert_close(o.detach().double(), want_o.detach(), rtol=0, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.double(), b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_plain_blocks_change_no_bit(monkeypatch):
    q, k, v, do = _inputs(5, 2, 16)
    whole = pa.patch_attention_plain(q, k, v)
    whole_b = pa.patch_attention_backward_plain(q, k, v, *whole, do)
    monkeypatch.setattr(pa, "PLAIN_SCORES", 2 * 16 * 16 * 2)  # two patches a block: 3 blocks
    assert len(pa._blocks(q)) == 3
    for a, b in zip(pa.patch_attention_plain(q, k, v) + pa.patch_attention_backward_plain(q, k, v, *whole, do),
                    whole + whole_b):
        assert torch.equal(a, b)


def test_kernel_operand_check():
    q, k, v, _ = _inputs(2, 2, 8)
    pa.check_kernel_operands(q, k, v)
    for d in (8, 32):
        with pytest.raises(ValueError, match="16"):
            pa.check_kernel_operands(*_inputs(2, 2, 8, d=d)[:3])
    bad = {"f64": k.double(), "shape": k[:, :, :4].contiguous(), "strided": k.transpose(1, 2).contiguous().transpose(1, 2),
           "3-d": k[0]}
    for name, x in bad.items():
        with pytest.raises(ValueError):
            pa.check_kernel_operands(q, x, v) if name != "3-d" else pa.check_kernel_operands(x, k, v)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(q.numel() + 1)
        pa.check_kernel_operands(flat[1:].view(q.shape), k, v)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pa.patch_attention_forward(*meta)


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("p,h,kk", [(1, 2, 1024), (40, 2, 1024), (1, 32, 1024), (40, 32, 1024), (3, 4, 37),
                                    (3, 4, 1000)])
def test_kernels_against_f64_reruns_and_counts(p, h, kk):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _inputs(p, h, kk, device="cuda", seed=p * 1000 + h * 10 + kk)
    before = {n: profiling.counter(n) for n in ("launch.attn_fwd", "launch.attn_bwd")}
    o, lse = pa.patch_attention_forward(q, k, v)
    grads = pa.patch_attention_backward(q, k, v, o, lse, do)
    assert {n: profiling.counter(n) - before[n] for n in before} == {"launch.attn_fwd": 1, "launch.attn_bwd": 2}
    o2, lse2 = pa.patch_attention_forward(q, k, v)
    grads2 = pa.patch_attention_backward(q, k, v, o, lse, do)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref_o, ref_lse = pa.patch_attention_plain(*(x.double() for x in (q, k, v)))
    ref_g = pa.patch_attention_backward_plain(*(x.double() for x in (q, k, v)), ref_o, ref_lse, do.double())
    f32_o, f32_lse = pa.patch_attention_plain(q, k, v)
    f32_g = pa.patch_attention_backward_plain(q, k, v, f32_o, f32_lse, do)
    from chip_smoke import attention_abs_sums

    a_o, a_dq, a_dk, a_dv = attention_abs_sums(q, k, v, do)
    for name, got, f32, ref, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + grads, (f32_o, f32_lse) + f32_g,
                                      (ref_o, ref_lse) + ref_g, (a_o, ref_lse.abs(), a_dq, a_dk, a_dv)):
        assert got.isfinite().all(), name
        e_k, e_p = (float((x.double() - ref).abs().max()) for x in (got, f32))
        assert e_k <= 4 * e_p + 1e-6 * float(b.max()), (name, e_k, e_p, float(b.max()))
