"""The port's synthetic LM data pipeline against ``repro.data``: tokens
and labels byte-equal for several indices, hosts and seeds; the iterator's
checkpoint state; the device rule."""
import numpy as np
import pytest
import torch

from repro.data import DataIterator as RIter
from repro.data import SyntheticLMDataset as RData
from repro_torch.data import DataIterator, SyntheticLMDataset

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,index,host,num_hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (3, 2, 0, 2), (11, 1000, 3, 4),
])
@pytest.mark.parametrize("vocab,seq,batch", [(256, 64, 4), (50304, 129, 8),
                                              (64, 16, 4)])
def test_host_batch_byte_equal(seed, index, host, num_hosts, vocab, seq,
                               batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = RData(**kw).host_batch(index, host, num_hosts)
    got = SyntheticLMDataset(**kw).host_batch(index, host, num_hosts)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].tobytes() == want[k].tobytes()


def test_global_arrays_and_iterator_state():
    kw = dict(vocab_size=1000, seq_len=48, global_batch=4, seed=5)
    ref = RIter(RData(**kw))
    it = DataIterator(SyntheticLMDataset(**kw), device="cpu")
    for _ in range(3):
        got, want = next(it), next(ref)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    state = it.state_dict()
    assert state == ref.state_dict() == {"next_index": 3}
    resumed = DataIterator(SyntheticLMDataset(**kw), device="cpu")
    resumed.load_state_dict(state)
    a, b = next(resumed), next(it)
    assert torch.equal(a["tokens"], b["tokens"])
    assert resumed.next_index == it.next_index == 4


def test_uneven_host_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLMDataset(64, 16, 6).host_batch(0, 0, 4)


def test_global_arrays_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the device rule is about its absence")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SyntheticLMDataset(64, 16, 4).global_arrays(0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        next(DataIterator(SyntheticLMDataset(64, 16, 4)))
