"""The port's prefetcher (``data/prefetch.py``) against the JAX package's
behaviour (``tests/test_native.py``'s six prefetch cases): order kept, a
producer's exception relayed and the stream ended after it, depth 0 a
passthrough, the producer running ahead and doing its work on its own
thread; plus the port's own: a negative depth raises, ``close()`` stops
the thread, and on a card the batches cross from a side stream."""

import threading
import time

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
    BatchLoader,
    PrefetchIterator,
    prefetch,
)


def test_prefetch_preserves_order_and_values():
    from cs744_pytorch_distributed_tutorial_tpu.data import prefetch as jax_prefetch

    items = list(range(50))
    assert list(prefetch(iter(items), depth=4)) == items
    assert list(prefetch(iter(items), depth=4)) == list(jax_prefetch(iter(items), depth=4))


def test_prefetch_relays_producer_exception():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_depth_zero_is_passthrough_and_negative_raises():
    it = prefetch(iter([1, 2]), depth=0)
    assert not isinstance(it, PrefetchIterator)
    assert list(it) == [1, 2]
    with pytest.raises(ValueError, match="depth"):
        prefetch(iter([1]), depth=-1)


def test_prefetch_runs_ahead():
    """With depth 3 the producer stages items while the consumer sleeps."""
    produced = []

    def gen():
        for i in range(5):
            produced.append(i)
            yield i

    it = PrefetchIterator(gen(), depth=3)
    assert next(it) == 0
    deadline = time.time() + 2.0
    while len(produced) < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 4
    it.close()


def test_prefetch_terminates_after_relayed_exception():
    """A consumer that catches the relayed exception and reads on gets
    StopIteration, and keeps getting it."""

    def gen():
        yield 1
        raise RuntimeError("boom")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_produces_on_its_own_thread():
    """The loader's work (the generator's body: gather and copy) runs on
    the producer thread, not the consumer's."""
    threads = []

    def gen():
        for i in range(6):
            threads.append(threading.current_thread())
            yield torch.arange(4) * i

    out = list(prefetch(gen(), depth=2))
    assert [int(t[-1]) for t in out] == [3 * i for i in range(6)]
    assert len(threads) == 6
    assert all(t is not threading.current_thread() for t in threads)


def test_close_stops_the_producer():
    def forever():
        i = 0
        while True:
            yield i
            i += 1

    it = PrefetchIterator(forever(), depth=2)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_prefetched_loader_epoch_equals_plain():
    """A prefetched epoch of the loader yields the same batches."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(48, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=48).astype(np.int32)
    loader = BatchLoader(images, labels, 8, device=torch.device("cpu"), shuffle=True, seed=1)
    plain = list(loader.epoch(1))
    fetched = list(prefetch(loader.epoch(1), depth=2, device=torch.device("cpu")))
    for (x, y), (px, py) in zip(fetched, plain, strict=True):
        assert torch.equal(x, px) and torch.equal(y, py)


@pytest.mark.cuda
def test_prefetch_side_stream_on_card():
    """On a card: batches copied on the producer's side stream arrive
    equal to the host rows, ready on the consumer's stream, while the
    consumer's stream is busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, size=(4096, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=4096).astype(np.int32)
    loader = BatchLoader(images, labels, 256, device=dev, shuffle=True, seed=2)
    plain = BatchLoader(images, labels, 256, device=torch.device("cpu"), shuffle=True, seed=2)
    busy = torch.randn(4096, 4096, device=dev)
    for (x, y), (px, py) in zip(prefetch(loader.epoch(0), depth=2, device=dev),
                                plain.epoch(0), strict=True):
        busy = busy @ busy.T / 4096  # keep the consumer's stream busy
        assert torch.equal(x.cpu(), px) and torch.equal(y.cpu(), py)
    assert loader.native_batches == len(loader)
