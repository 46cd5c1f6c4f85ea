"""The filters' quantization on the card: ``prepare_conv_weights`` at full
width gives the CPU's uint8 filters byte for byte (a float32 division on
both, as the JAX package takes it, not a multiply by the reciprocal).  The
CPU tests hold the CPU's filters against the JAX package
(``tests/test_torch_inception.py``); this file imports no JAX, so it runs
on the card: ``PYTHONPATH=src python3 -m pytest -q
tests/test_torch_filter_quant.py``."""
import pytest
import torch

from repro_torch.models import inception

torch.set_num_threads(1)


@pytest.fixture
def gpu():
    """Skips (decided at run time, not at collection) without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it holds the card's float32 "
                    "division against the CPU's")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_quantizes_the_filters_as_the_cpu(gpu, seed):
    params = inception.init_params(torch.Generator().manual_seed(seed),
                                   inception.FULL, device="cpu")
    cpu = inception.prepare_conv_weights(params, inception.FULL)
    card = inception.prepare_conv_weights(
        {n: {k: v.to(gpu) for k, v in p.items()} for n, p in params.items()},
        inception.FULL)
    assert list(card) == list(cpu) and len(cpu) == 95
    for name, (wq, w_qp, bias) in cpu.items():
        wq_c, w_qp_c, bias_c = card[name]
        assert wq_c.device.type == "cuda" and wq_c.dtype == torch.uint8
        assert w_qp_c == w_qp, name
        assert torch.equal(wq_c.cpu(), wq), name
        assert torch.equal(bias_c.cpu(), bias), name
