"""The port's CUDA kernels against their plain PyTorch versions on the card
(``gpu`` marker; skipped where CUDA is absent). Run on a machine with an
H100: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Shapes are the baseline model's (H 10, d_head 50, HD 500, DI 1000, V 310)
at a shortened memory, plus one case at the full M 4146; the tolerances are
those of transformer_gan_torch.kernel_check."""

import pytest
import torch

from transformer_gan_torch import _native
from transformer_gan_torch import kernel_check as kc

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("variant", ["v2", "v1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,B,count,same_length", [
    (50, 1, 0, True), (128, 3, 200, True), (9, 2, 300, False),
    (128, 1, 300, False),
])
def test_attention_kernel_matches_plain(cuda, variant, dtype, q, B, count,
                                        same_length):
    res = kc.check_attention(variant, dtype, q, B, count, M=300,
                             same_length=same_length)
    assert res["ok"], res


@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_attention_kernel_reset_rows_full_memory(cuda, variant):
    reset = torch.tensor([0, 1, 0], device=cuda, dtype=torch.int32)
    res = kc.check_attention(variant, torch.float32, 128, 3, kc.MEM_LEN,
                             reset=reset)
    assert res["ok"], res


@pytest.mark.parametrize("B,count", [(1, 0), (3, 100), (8, 300)])
def test_generate_kernel_fp32_ids_identical(cuda, B, count):
    res = kc.check_generate("float32", B, count, M=300)
    assert res["ok"], res


def test_generate_kernel_bf16_first_logits(cuda):
    res = kc.check_generate("bfloat16", 2, 300, M=300)
    assert res["ok"], res


def test_wrappers_count_launches(cuda):
    _native.reset_launches()
    kc.check_attention("v2", torch.float32, 16, 1, 0, M=64)
    kc.check_generate("float32", 1, 0, chunks=(3,), M=64)
    assert _native.LAUNCHES["xl_attn_fwd_v2"] == 1
    assert _native.LAUNCHES["generate_chunk"] == 1
