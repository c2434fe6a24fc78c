"""Training's forward, loss and gradients against the JAX reference for
the vlm, ssm and hybrid architectures (llama-3.2-vision-90b, xlstm-125m,
zamba2-2.7b): the checks and tolerances of ``test_torch_train.py``, whose
helpers this file runs (the reference's compiles are the slow part, so
the ten architectures are split between the two files)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402
    OTHER_FILE, check_decode_matches_forward, check_loss_logits_and_grads,
    check_remat_bit_equal,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", OTHER_FILE)
def test_loss_logits_and_every_gradient_match_the_reference(arch):
    check_loss_logits_and_grads(arch)


@pytest.mark.parametrize("arch", OTHER_FILE)
def test_remat_on_and_off_bit_equal(arch):
    check_remat_bit_equal(arch)


@pytest.mark.parametrize("arch", OTHER_FILE)
def test_decode_teacher_forced_matches_forward(arch):
    check_decode_matches_forward(arch)
