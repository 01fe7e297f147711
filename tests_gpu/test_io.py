"""``PrefetchToDevice`` on the card (moved from tests/test_torch_io.py,
whose CPU tests hold the port's I/O to the JAX package's)."""

import numpy as np
import pytest
import torch

from hyperres_torch.io import pipeline as tpipeline

#: name -> (slabs, slab shape, seeded (else slab i is all i), cycles the
#: loader's stream is held before each copy and the consumer's before each
#: read, whether the consumer allocates a slab between batches). "hazards":
#: many small slabs, the loader held ~0.5 ms and the consumer ~2 ms a batch
#: (torch.cuda._sleep at ~2 GHz): its reads run far behind later copies
PREFETCH = {"large_slabs": (24, (1024, 1024), False, 0, 2_000_000, False),
            "hazards": (96, (256, 256, 8), True, 1_000_000, 4_000_000, True)}
PREFETCH_DEPTH = 3


def slabs_that_differ(dev, n, shape, seeded, copy_hold, read_hold, scratch):
    """The indices of the slabs that ``PrefetchToDevice`` (depth
    PREFETCH_DEPTH) delivered unequal to their host arrays, with the
    streams held back as ``PREFETCH`` says; each slab is dropped as soon
    as its read is queued."""
    rng = np.random.default_rng(7)
    host = [rng.standard_normal(shape, dtype=np.float32) if seeded
            else np.full(shape, i, np.float32) for i in range(n)]
    loader = None

    def hold_copies(item):
        # runs in the loader thread before the batch is pinned and its
        # copy queued on the side stream: that copy waits behind a sleep
        with torch.cuda.stream(loader._stream):
            torch.cuda._sleep(copy_hold)
        return item

    loader = tpipeline.PrefetchToDevice(
        iter(host), depth=PREFETCH_DEPTH, device=dev,
        transform=hold_copies if copy_hold else None)
    got = []
    for x in loader:
        torch.cuda._sleep(read_hold)
        got.append(x.clone())
        del x
        if scratch:   # a slab-sized tensor allocated and freed at once
            torch.full(shape, float("nan"), device=dev)
    torch.cuda.synchronize()
    assert len(got) == n
    return [i for i, (g, h) in enumerate(zip(got, host))
            if not np.array_equal(g.cpu().numpy(), h)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PREFETCH))
def test_prefetch_cuda_buffers_outlive_their_use(cuda, case):
    """On the card, with a consumer that keeps its stream busy before it
    reads each batch: every batch arrives bit-equal to its host array
    (the pinned buffer outlives its copy; the side-stream tensor is
    record_stream'd, so the allocator does not hand it to a later copy).
    In "hazards" the loader's copies are held back too, so copies are
    still queued when the next batch is pinned."""
    assert slabs_that_differ(cuda, *PREFETCH[case]) == []
