"""The launch tools on the card: the flash attention's custom ops against
the kernels' direct calls, bitwise, at smollm-135m's prefill and training
shapes; a fake CUDA trace of the dry run launching nothing. The CPU side
(``tests/test_torch_launch.py``) holds the tools against ``repro``; this
file imports no JAX."""
import pytest
import torch

from repro_torch.kernels import flash_attn as fa_mod
from repro_torch.kernels import ops
from repro_torch.launch import dryrun

pytestmark = pytest.mark.quick


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")


def _smollm_qkv(dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, S, H, K, hd = 4, 2048, 9, 3, 64
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device="cuda").to(dtype)
    do = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_custom_op_bitwise_todays_call_on_the_card(cuda, dtype):
    """At smollm's prefill (bf16, no LSE) and training (f32 from step 2, and
    bf16 at step 1) shapes, the custom ops give what today's direct calls
    of the kernels give, bitwise, one launch a forward."""
    q0, k0, v0, do = _smollm_qkv(dtype, 0)
    want_fwd = fa_mod.flash_attention_cuda(q0, k0, v0, True, None)
    o, lse = fa_mod.flash_attention_cuda(q0, k0, v0, True, None, with_lse=True)
    want_bwd = fa_mod.flash_attention_bwd_cuda(q0, k0, v0, o, lse, do, True, None)
    fa_mod.launches = 0
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q0, k0, v0), want_fwd)
    assert fa_mod.launches == 1
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out.detach(), o)
    out.backward(do)
    for got, want in zip((q.grad, k.grad, v.grad), want_bwd):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fake_cuda_trace_launches_nothing_on_the_card(cuda):
    launched = (fa_mod.launches, fa_mod.bwd_launches)
    for shape in ("prefill_32k", "train_4k"):
        row = dryrun.run_one("smollm-135m", shape)
        assert row["status"] == "ok" and row["traced_device"] == "fake cuda:0"
        assert sum(v for k, v in row["flash_calls"].items()) > 0
    assert (fa_mod.launches, fa_mod.bwd_launches) == launched
