"""The port's ``DataLoader`` against ``repro.data.DataLoader`` (``mesh=None``):
numpy-equal batches step for step for every batch kind (tokens and labels,
a VLM's patches and loss weights, an encoder-decoder's frames, images),
``state``/``restore`` with stale prefetches dropped, ``close``, and the
device it places on."""
import threading

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataLoader as RefLoader
from repro_torch.configs import get_config
from repro_torch.data.loader import DataLoader

ARCHS = ("llama3.2-1b", "pixtral-12b", "whisper-large-v3", "sobel-hd")


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch):
    seq = 24 if arch == "pixtral-12b" else 12
    ref = RefLoader(ref_get_config(arch, smoke=True), 3, seq, seed=4)
    port = DataLoader(get_config(arch, smoke=True), 3, seq, seed=4, device="cpu")
    try:
        for _ in range(4):
            want, got = next(ref), next(port)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert v.device.type == "cpu"
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
        assert port.state() == ref.state() == {"step": 4, "seed": 4}
    finally:
        ref.close()
        port.close()


def test_state_roundtrip_drops_stale_prefetches():
    """The reference's test_loader_state_roundtrip, and a restore to an
    earlier step and to another seed while the thread has prefetched
    ahead: the next batch is the restored step's, equal to the
    reference's."""
    cfg = get_config("llama3.2-1b", smoke=True)
    a = DataLoader(cfg, 2, 8, seed=3, device="cpu")
    it = iter(a)
    first = [next(it)["tokens"].clone() for _ in range(3)]
    st = a.state()
    later = next(it)["tokens"]
    a.restore(st)
    assert torch.equal(next(iter(a))["tokens"], later)
    a.restore({"step": 1, "seed": 3})
    assert torch.equal(next(a)["tokens"], first[1])
    a.restore({"step": 2, "seed": 9})
    ref = RefLoader(ref_get_config("llama3.2-1b", smoke=True), 2, 8, seed=9, start_step=2)
    np.testing.assert_array_equal(next(a)["tokens"].numpy(), np.asarray(next(ref)["tokens"]))
    ref.close()
    a.close()


def test_close_stops_the_prefetch_thread():
    a = DataLoader(get_config("llama3.2-1b", smoke=True), 2, 8, device="cpu", prefetch=3)
    next(a)
    thread = a._thread
    assert thread is not None and thread.is_alive()
    a.close()
    thread.join(timeout=5)
    assert not thread.is_alive() and a._thread is None
    assert not any(t is thread for t in threading.enumerate())


def test_places_on_the_cuda_device_by_default():
    cfg = get_config("llama3.2-1b", smoke=True)
    if torch.cuda.is_available():
        assert DataLoader(cfg, 2, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataLoader(cfg, 2, 8)
